"""Parallel training over ``torch.distributed``: one process a device.

The port's counterpart of ``ecog2txt_tpu/parallel``: data and tensor
(``mesh.py``), expert (``expert.py``), sequence (``sequence.py``) and
pipeline (``pipeline.py``; with sequence parallelism ``sp_pp.py``)
parallelism on a mesh of process groups, the multi-process bootstrap
(``multihost.py``, ``launch.py``), the collectives with their adjoints
(``comm.py``), and a one-step check of every mode (``dryrun.py``).
"""

from .expert import ep_spec, gather_params_ep, shard_params_ep  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    Placement,
    batch_sharding,
    gather_params_tp,
    make_dp_train_step,
    make_mesh,
    parallel_modes,
    replicate,
    shard_params_tp,
    tp_mask,
)
from .multihost import initialize_distributed, make_global  # noqa: F401
from .pipeline import (  # noqa: F401
    gather_stages,
    pipeline_conformer_encode,
    shard_stages,
    stack_block_params,
)
from .sequence import halo_steps, sequence_parallel_encode  # noqa: F401
from .sp_pp import sp_pp_conformer_encode  # noqa: F401
