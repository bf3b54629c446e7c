"""The port's analysis layer held to the JAX package.

At the TINY widths of ``tests/test_plotting.py``, on one port trainer and
a JAX trainer holding its weights (``convert``, f32, greedy): the
electrode contributions (weight norms at rtol 1e-6, occlusion WERs equal
position by position, saliency within the f32 tolerance normwise), the
numpy-only functions equal to JAX's on the same inputs, every figure
method of ``tests/test_plotting.py`` and ``tests/test_anatomy_figures.py``
on the port under Agg writing the file names JAX's writes, the anatomy
loaders, ``results_plotter`` and ``cluster_embedded_words``.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from scipy.io import savemat  # noqa: E402

from ecog2txt_tpu import plotting as jplot  # noqa: E402
from ecog2txt_tpu import train as jtrain  # noqa: E402
from ecog2txt_tpu.demo import make_demo_experiment as jmake_demo  # noqa: E402
from ecog2txt_tpu.plotting import anatomy as janat  # noqa: E402
from ecog2txt_tpu.plotting import embeddings as jemb  # noqa: E402
from ecog2txt_tpu.plotting import latex as jlatex  # noqa: E402
from ecog2txt_tpu.plotting import plotters as jplotters  # noqa: E402
from ecog2txt_tpu_torch import plotting as tplot  # noqa: E402
from ecog2txt_tpu_torch import train as ttrain  # noqa: E402
from ecog2txt_tpu_torch.convert import params_to_numpy  # noqa: E402
from ecog2txt_tpu_torch.demo import make_demo_experiment  # noqa: E402
from ecog2txt_tpu_torch.plotting import anatomy as tanat  # noqa: E402
from ecog2txt_tpu_torch.plotting import embeddings as temb  # noqa: E402
from ecog2txt_tpu_torch.plotting import latex as tlatex  # noqa: E402
from ecog2txt_tpu_torch.plotting import plotters as tplotters  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-4, atol=1e-5)
TINY = {
    "encoder_embedding": [16],
    "encoder_rnn": [24],
    "encoder_1_projection": [16],
    "decoder_embedding": [12],
    "decoder_rnn": [48],
    "decoder_projection": [],
}
SN = {"batch_size": 16, "max_dec_len": 10, "learning_rate": 3e-3, "temperature": 0.0}


@pytest.fixture(scope="module")
def elec_mat(tmp_path_factory):
    """The electrode file of ``tests/test_anatomy_figures.py``."""
    path = str(tmp_path_factory.mktemp("elec") / "TDT_elecs_all.mat")
    rng = np.random.default_rng(0)
    positions = rng.normal(size=(16, 3)) - [50, 0, 0]  # left hemisphere
    labels = np.array([["e%d" % i, "precentral" if i < 8 else "superiortemporal"]
                       for i in range(16)], dtype=object)
    savemat(path, {"elecmatrix": positions, "anatomy": labels})
    return path


@pytest.fixture(scope="module")
def pair(tmp_path_factory, elec_mat):
    """A port trainer trained 6 epochs (the LSTM kernels' plain versions)
    and a JAX trainer on a byte-identical demo experiment holding the
    port's weights; each experiment saves its figures in a folder of its
    own."""
    root = tmp_path_factory.mktemp("plot")

    def exp(make, name):
        return make(str(root / name), subject_ids=(1,), layer_sizes=TINY, grid_size=(4, 4),
                    electrode_path=elec_mat,
                    png_partial_path=str(root / name / "figs" / "{0}.png"))

    tr = ttrain.MultiSubjectTrainer(exp(make_demo_experiment, "t"), [1],
                                    SN_kwargs={**SN, "use_pallas_lstm": True},
                                    VERBOSE=False, device="cpu")
    tr.fit(num_epochs=6, assess=False)
    jtr = jtrain.MultiSubjectTrainer(exp(jmake_demo, "j"), [1],
                                     SN_kwargs={**SN, "use_pallas_lstm": False}, VERBOSE=False)
    as_jax = lambda tree: jax.tree.map(jnp.asarray, params_to_numpy(tree))  # noqa: E731
    jtr.state = jtr.state._replace(params=as_jax(tr.state.params), ema=as_jax(tr.state.ema))
    return tr, jtr


@pytest.fixture(scope="module")
def plotters(pair):
    tr, jtr = pair
    return (tplot.ResultsPlotter(tr.target_subject, tr, VERBOSE=False),
            jplot.ResultsPlotter(jtr.target_subject, jtr, VERBOSE=False))


# --------------------------------------------------------------------------
# electrode contributions
# --------------------------------------------------------------------------


def test_weight_norms_match_jax(plotters):
    got = plotters[0].elec_contribs("weight_norms")
    want = plotters[1].elec_contribs("weight_norms")
    assert got.shape == (16,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_occlusion_wers_match_jax(plotters):
    """The same WER at every mask position, in the same order of masks,
    and so the same occlusion contributions."""
    wers, masks = plotters[0]._occlusion_wers("validation", mask_extent=(2, 2), stride=1)
    jwers, jmasks = plotters[1]._occlusion_wers("validation", mask_extent=(2, 2), stride=1)
    as_tuples = lambda ms: [(m.start, m.extent, m.step, m.OCCLUDE) for m in ms]  # noqa: E731
    assert len(masks) == 9 and as_tuples(masks) == as_tuples(jmasks)
    np.testing.assert_array_equal(wers, jwers)
    assert len(set(wers.tolist())) > 1  # the masks do change the decodes
    got = plotters[0].elec_contribs("occlusion_tested", mask_extent=(2, 2), stride=2)
    want = plotters[1].elec_contribs("occlusion_tested", mask_extent=(2, 2), stride=2)
    assert got.shape == (16,)
    np.testing.assert_array_equal(got, want)


def test_saliency_map_matches_jax(plotters):
    got = plotters[0].elec_contribs("saliency_map")
    want = plotters[1].elec_contribs("saliency_map")
    assert got.shape == (16,) and (got >= 0).all() and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=F32["rtol"], atol=F32["rtol"] * np.abs(want).max())


def test_unknown_contrib_method(plotters):
    with pytest.raises(ValueError, match="unknown contrib_method"):
        plotters[0].elec_contribs("nope")


def test_geometry_and_anatomy_match_jax(plotters, pair):
    got, want = plotters
    np.testing.assert_array_equal(got.electrode_locs_2D(), want.electrode_locs_2D())
    assert got.anatomy_labels() == want.anatomy_labels()
    assert set(got.anatomy_labels()) == {"vSMC", "superior temporal"}
    np.testing.assert_array_equal(got.electrode_locs_3D(), want.electrode_locs_3D())
    tr, jtr = pair
    assert (tanat.anatomy_labels_from_manifest(tr.manifest)
            == janat.anatomy_labels_from_manifest(jtr.manifest))


# --------------------------------------------------------------------------
# numpy-only functions: equal to JAX's on the same inputs
# --------------------------------------------------------------------------

SUFFIXES = ["", "mocha1_400", "400_via_tl_with_401_402_x", "400_with_401_x",
            "400_mochastar_via_tl_with_401_x", "400_mochastar_x", "400_untargeted",
            "400_undecimated", "400_decimated", "400_lowdensity", "400_noise", "400_viterbi",
            "400_cross-attention", "x_cross-subject_a_b_c_d"]
STATS = {"p_value": 1.5e-3, "statistic": 42.0, "effect_size": 0.61}


def _grid_archive(tmp_path, shape, names, values, seed):
    wers = np.random.default_rng(seed).uniform(0, 1, shape)
    wers[(0,) * len(shape)] = np.nan  # nan-aware reductions
    return jplot.save_grid_search(str(tmp_path / f"grid_search_{seed}"), names, values, wers)


def _figure_images(figs):
    return [[(ax.get_title(), np.asarray(ax.images[0].get_array())) for ax in f.axes
             if ax.images] for f in figs]


def _case(name, tmp_path):
    """(port result, JAX result) of one numpy-only function."""
    rng = np.random.default_rng(3)
    if name == "anti_alias":
        x = rng.normal(size=(40, 5))
        return [tplotters.anti_alias(x, d) for d in (1, 4, 12)], \
            [jplotters.anti_alias(x, d) for d in (1, 4, 12)]
    if name == "gaussian_kde":
        grid, pts = np.linspace(-4, 4, 101), rng.normal(size=7)
        return [m._gaussian_kde(p, grid, bw) for m in (tplotters,)
                for p, bw in ((pts, 1.0), (pts, 0.5), (pts[:0], 1.0))], \
            [m._gaussian_kde(p, grid, bw) for m in (jplotters,)
             for p, bw in ((pts, 1.0), (pts, 0.5), (pts[:0], 1.0))]
    if name == "suffix_to_label":
        return [tplot.suffix_to_label(s, b) for s in SUFFIXES for b in (False, True)], \
            [jplot.suffix_to_label(s, b) for s in SUFFIXES for b in (False, True)]
    if name == "get_save_path":
        def plotter(d):
            manifest = SimpleNamespace(resolve=lambda key, *a: str(tmp_path / d / "f_{0}.png"))
            return SimpleNamespace(subject=SimpleNamespace(manifest=manifest))

        ps = [plotter("a/x"), plotter("a/y/z")]
        return tplot.get_save_path("png", ps), jplot.get_save_path("png", ps)
    if name == "ith_param_range":
        axes = [np.array([1.0, 2.0]), np.array([10.0, 20.0, 30.0]), np.array([5.0, 6.0])]
        grids = np.stack([m.ravel() for m in np.meshgrid(*axes, indexing="ij")], axis=1)
        return [tplot.ith_param_range(grids, i, (2, 3, 2)) for i in range(3)], \
            [jplot.ith_param_range(grids, i, (2, 3, 2)) for i in range(3)]
    if name == "grid_project":
        path = _grid_archive(tmp_path, (2, 3, 4), ["lr", "units", "dropout"],
                             [[1e-3, 1e-2], [64, 128, 256], [0.0, 0.1, 0.3, 0.5]], 0)

        def run(mod):
            gs = mod.GridSearchResults(path)
            return [gs.project(x, y, r) for x, y in (("lr", "units"), ("dropout", "lr"))
                    for r in ("min", "mean", "max")] + [
                gs.project("dropout", "units", conditions={"lr": 1e-2}), gs.best()]

        return run(tplot), run(jplot)
    if name == "all_grid_search_projections":
        path = _grid_archive(tmp_path, (2,) * 5, list("abcde"), [[0, 1]] * 5, 1)
        out = [_figure_images(mod.all_grid_search_projections(path, ["a", "b", "c"],
                                                              reduce=r))
               for mod in (tplot, jplot) for r in ("mean", "min")]
        plt.close("all")
        return out[:2], out[2:]
    if name == "latex":
        def run(mod):
            return [mod.latex_table([["a_b", 0.123456], ["c", np.float32(2.5)]], ["name", "wer"],
                                    caption="c", label="l"),
                    mod.latex_legend(["x", "y"], [(0.1, 0.2, 0.3), (1, 0, 0)]),
                    mod.tikz_errorbar_plot([1, 2], [0.5, 0.4], [0.01, 0.02]),
                    mod.tikz_errorbar_plot([1, 2], [0.5, 0.4]),
                    mod.print_latex_anatomical_legend(PRINT=False),
                    mod.print_latex_anatomical_legend(["precentral", "postcentral"],
                                                      ("precentral",), PRINT=False)]

        saved = [open(m.save_tikz("x", str(tmp_path / d / "{0}.tex"), "c")).read()
                 for m, d in ((tlatex, "t"), (jlatex, "j"))]
        return run(tlatex) + saved[:1], run(jlatex) + saved[1:]
    if name == "effect_of_tabularizer":
        summary = {
            1: {"expA": {"comparisons": {}}},
            2: {"expA": {"comparisons": {"wer": {"_untargeted": dict(STATS),
                                                 "_noise": {"p value": 2e-4,
                                                            "test statistic": 7.0,
                                                            "effect size": 0.3}}}}},
            3: {"expA": {"comparisons": {"wer": {"_untargeted": dict(STATS),
                                                 "_noise": dict(STATS)}}}},
        }
        return tplot.effect_of_tabularizer(summary, PRINT=False), \
            jplot.effect_of_tabularizer(summary, PRINT=False)
    if name == "cluster_embeddings":
        emb = rng.normal(size=(40, 16))
        words = [f"w{i}_" for i in range(40)]
        got = [temb.cluster_embeddings(emb, words, m, 4, seed=2, plot=False)[:2]
               for m in ("pca", "tsne")]
        want = [jemb.cluster_embeddings(emb, words, m, 4, seed=2, plot=False)[:2]
                for m in ("pca", "tsne")]
        return got, want
    if name == "scatter_desequenced_data":
        seqs = [rng.normal(size=(t, 8)) for t in (10, 15, 5)]
        got, want = (mod.scatter_desequenced_data(seqs, labels=[3, 1, 2])[:2]
                     for mod in (temb, jemb))
        plt.close("all")
        return got, want
    if name == "results_matrix":
        m = [[0.1, 0.2], [0.3, np.nan], [0.5, 0.7]]
        return [tplot.ResultsMatrix(m).mean_across_folds, tplot.ResultsMatrix(m).stderr_across_folds], \
            [jplot.ResultsMatrix(m).mean_across_folds, jplot.ResultsMatrix(m).stderr_across_folds]
    if name == "anatomy":
        positions = rng.normal(size=(12, 3)) + [40, 0, 0]
        labels = ["ctx-lh-precentral", "parstriangularis", "rostralmiddlefrontal", "elsewhere"]
        return [tanat.generic_pial_mesh(positions), [tanat.pool_label(x) for x in labels]], \
            [janat.generic_pial_mesh(positions), [janat.pool_label(x) for x in labels]]
    raise KeyError(name)


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("name", [
    "anti_alias", "gaussian_kde", "suffix_to_label", "get_save_path", "ith_param_range",
    "grid_project", "all_grid_search_projections", "latex", "effect_of_tabularizer",
    "cluster_embeddings", "scatter_desequenced_data", "results_matrix", "anatomy"])
def test_numpy_functions_equal_jax(name, tmp_path):
    got, want = _case(name, tmp_path)
    _assert_equal(got, want)


def test_electrode_files_load_alike(elec_mat, pair, tmp_path):
    """The electrode file and both cortical-mesh forms (a 1-indexed
    ``cortex`` struct, npz) load alike in both packages."""
    got, want = tanat.load_electrode_file(elec_mat), janat.load_electrode_file(elec_mat)
    _assert_equal(got, want)
    assert got["hemisphere"] == "lh" and got["labels"][0] == "vSMC"
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]) * 30 - [60, 0, 0]
    tris = np.asarray([[1, 2, 3], [1, 2, 4], [1, 3, 4], [2, 3, 4]])
    mat = str(tmp_path / "cortex.mat")
    savemat(mat, {"cortex": {"vert": verts, "tri": tris}})
    npz = str(tmp_path / "cortex.npz")
    np.savez(npz, vertices=verts, faces=tris - 1)
    tr, jtr = pair
    for path in (mat, npz):
        mesh = tanat.load_cortical_mesh(tr.manifest.updated({"cortical_mesh_file": path}))
        _assert_equal(mesh, janat.load_cortical_mesh(
            jtr.manifest.updated({"cortical_mesh_file": path})))
        assert mesh["faces"].min() == 0


# --------------------------------------------------------------------------
# figures: every figure method of the JAX tests, on the port, under Agg
# --------------------------------------------------------------------------


def _perf_results(mod, tmp_path):
    wer = np.array([[0.5, 0.3], [0.6, 0.2]])
    mod.save_decoding_results(str(tmp_path / "perf_vs_training_size_1_x"), wer, 1 - wer,
                              wer * 600, [[1], [1, 2]], [5])
    return mod.DecodingResults(str(tmp_path), 1, "x")


def _draw(name, plotter, trainer, mod, tmp_path):
    """Draw one figure; returns what the method returned."""
    if name == "elec_contribs_2D":
        return plotter.plot_elec_contribs_2D("weight_norms")
    if name.startswith("anatomy_"):
        return plotter.plot_contribs_by_anatomy("weight_norms", kind=name[len("anatomy_"):])
    if name == "ecog_sequence_lengths":
        return plotter.bar_plot_ecog_sequence_lengths(threshold=0.55)
    if name == "nums_examples":
        return (plotter.bar_plot_nums_examples(),
                plotter.bar_plot_nums_examples(num_sentences_dict={0: 10, 1: 10}))
    if name == "confusions":
        out = trainer.assess(["validation"])["validation"]
        dec_list = trainer.target_subject.data_manifests["decoder_targets"].feature_list
        return (plotter.plot_confusions(out["decoder_confusions"], dec_list) is not None,
                plotter.plot_confusions(np.zeros((120, 120))))
    if name == "occlusion_map":
        return plotter.plot_occlusion_map(mask_extent=(2, 2), stride=2)
    if name == "perf_vs_training":
        return plotter.plot_performance_vs_training_data(_perf_results(mod, tmp_path))
    if name == "elec_contribs_3D":
        return plotter.plot_elec_contribs_3D("weight_norms")
    if name == "elec_contribs_brain":
        fig = plotter.plot_elec_contribs_on_brain("weight_norms")
        return (fig.axes[0].name, len(fig.axes[0].collections) >= 2)
    if name == "elec_contribs_brain_mesh":
        # a configured cortical mesh (npz; the 1-indexed .mat form is held
        # to JAX in test_electrode_files_load_alike) in place of the
        # generic surface
        verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]) * 30 - [60, 0, 0]
        np.savez(tmp_path / "cortex.npz", vertices=verts,
                 faces=np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]))
        subject, saved = plotter.subject, plotter.subject.manifest
        subject.manifest = saved.updated({"cortical_mesh_file": str(tmp_path / "cortex.npz")})
        try:
            fig = plotter.plot_elec_contribs_on_brain("weight_norms")
        finally:
            subject.manifest = saved
        return (fig.axes[0].name, len(fig.axes[0].collections) >= 2)
    if name == "activity_animation":
        ds = trainer.packed_dataset("validation")
        trial = ds.encoder_inputs[0, 0, : int(ds.encoder_lengths[0, 0])]
        return plotter.plot_activity_animation(trial, stride=48)
    if name == "network_schematic":
        return plotter.plot_network_schematic("validation")
    if name == "sentence_repeats":
        counters = trainer.target_subject.count_targets(["training"])["training"]
        return plotter.plot_sentence_repeats(dict(zip(counters.unique_sentences,
                                                      counters.counts)), nominal=4)
    if name == "cross_plotter_curves":
        res = _perf_results(mod, tmp_path)
        return mod.plot_performances_vs_amount_of_training_data([res, res], labels=["a", "b"])
    if name == "annotated_performances":
        a = np.abs(np.random.default_rng(0).normal(0.1, 0.02, 30))
        fig, results = mod.plot_annotated_performances({"ours": a, "baseline": a + 0.1},
                                                       comparisons=[("ours", "baseline")])
        return results
    if name == "performance_grouped":
        values = np.random.default_rng(1).normal(0.3, 0.05, 40)
        return [mod.plot_performance(values, np.repeat(["a", "b"], 20), kind=k) is not None
                for k in ("box", "violin")]
    if name == "grid_projection":
        path = _grid_archive(tmp_path, (2, 2, 2), ["lr", "units", "dropout"],
                             [[1e-3, 1e-2], [64, 128], [0.1, 0.5]], 2)
        return mod.GridSearchResults(path).plot_projection("lr", "dropout") is not None
    raise KeyError(name)


FIGURES = ["elec_contribs_2D", "anatomy_bar", "anatomy_box", "anatomy_violin", "anatomy_kde",
           "ecog_sequence_lengths", "nums_examples", "confusions", "occlusion_map",
           "perf_vs_training", "elec_contribs_3D", "elec_contribs_brain",
           "elec_contribs_brain_mesh", "activity_animation",
           "network_schematic", "sentence_repeats", "cross_plotter_curves",
           "annotated_performances", "performance_grouped", "grid_projection"]


def _written(trainer) -> set:
    folder = os.path.dirname(trainer.manifest.resolve("png_partial_path"))
    return set(os.listdir(folder)) if os.path.isdir(folder) else set()


@pytest.mark.parametrize("name", FIGURES)
def test_figure_writes_the_jax_file_names(name, plotters, pair, tmp_path):
    """The figure draws on the port and saves the files JAX's saves (none
    for the cross-plotter figures and the animation); what it returns
    beside the figure (a WER, counts, p values) equals JAX's."""
    tr, jtr = pair
    out = {}
    for key, plotter, trainer, mod in (("port", plotters[0], tr, tplot),
                                       ("jax", plotters[1], jtr, jplot)):
        before = _written(trainer)
        (tmp_path / key).mkdir()
        out[key] = (_draw(name, plotter, trainer, mod, tmp_path / key),
                    _written(trainer) - before)
        plt.close("all")
    got, want = out["port"], out["jax"]
    assert got[1] == want[1]
    if name in ("elec_contribs_2D", "occlusion_map", "network_schematic"):
        assert got[1], "the figure saved no file"
    if isinstance(want[0], (float, dict, list, tuple, bool, str)):
        _assert_equal(got[0], want[0])
    else:
        assert got[0] is not None


# --------------------------------------------------------------------------
# the trainer's analysis hooks
# --------------------------------------------------------------------------


def test_cluster_embedded_words_matches_jax(pair):
    tr, jtr = pair
    proj, ids, fig = tr.cluster_embedded_words(num_clusters=4)
    jproj, jids, _ = jtr.cluster_embedded_words(num_clusters=4, plot=False)
    vocab = len(tr.target_subject.data_manifests["decoder_targets"].feature_list)
    assert proj.shape == (vocab, 2) and fig is not None
    np.testing.assert_array_equal(proj, jproj)
    np.testing.assert_array_equal(ids, jids)
    plt.close("all")


def test_trainer_results_plotter_property(pair):
    tr, _ = pair
    rp = tr.results_plotter
    assert isinstance(rp, tplot.ResultsPlotter)
    assert rp.subject is tr.target_subject and rp.trainer is tr
    assert tr.results_plotter is rp  # cached
    tr.results_plotter = "sentinel"
    assert tr.results_plotter == "sentinel"
    tr.results_plotter = None
    assert tr.results_plotter is not rp  # built anew
