"""Analysis & figure layer (rebuild of reference plotters.py, SURVEY §2.7).

The port's own copy of ``ecog2txt_tpu/plotting``, with the same names.
matplotlib, h5py, sklearn, seaborn and pandas are imported only inside
the functions that need them, so the package imports without them.
"""

from .results import (  # noqa: F401
    DecodingResults,
    ResultsMatrix,
    save_decoding_results,
)
from .plotters import (  # noqa: F401
    ResultsPlotter,
    get_save_path,
    suffix_to_label,
)
from .figures import (  # noqa: F401
    plot_annotated_performances,
    plot_performance,
    plot_performances_vs_amount_of_training_data,
    pvalue_annotate,
)
from .embeddings import cluster_embeddings, scatter_desequenced_data  # noqa: F401
from .gridsearch import (  # noqa: F401
    GridSearchResults,
    all_grid_search_projections,
    ith_param_range,
    save_grid_search,
)
from .latex import (  # noqa: F401
    effect_of_tabularizer,
    latex_legend,
    latex_table,
    print_latex_anatomical_legend,
    save_tikz,
    tikz_errorbar_plot,
)
