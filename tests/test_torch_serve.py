"""The port's serving path held to the JAX package, and the port's rules.

The port's ``OnlinePredictor`` against the JAX ``OnlinePredictor`` on the
same weights (tokens and sequences identical, probabilities at rtol
1e-4 / atol 1e-5), the streaming session against the predictor, a
checkpoint round trip; then the rules: the package imports with JAX and
the JAX package blocked, entry points without ``device=`` raise where no
GPU is present, and ``chip_smoke.py`` fails without one.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ecog2txt_tpu import serve as jserve
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import convert
from ecog2txt_tpu_torch import serve as tserve
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=1e-5)
C, MAX = 5, 36
TARGETS = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 20)]
KW = dict(
    vocab_size=20, in_channels=C, conv_sizes=(6,), decimation_factor=3,
    rnn_sizes=(8, 8), dec_embedding_size=6, dec_rnn_sizes=(12,),
    max_dec_len=6,
)


@pytest.fixture(scope="module")
def setup():
    jcfg = js.Seq2SeqConfig(**KW)
    jparams = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    jpred = jserve.OnlinePredictor(jparams, jcfg, TARGETS, max_samples=MAX)
    return jpred, tree


def _port(tree, **overrides):
    cfg = ts.Seq2SeqConfig(**{**KW, "use_pallas_lstm": True, **overrides})
    params = convert.params_from_numpy(tree, device="cpu")
    return tserve.OnlinePredictor(params, cfg, TARGETS, max_samples=MAX, device="cpu")


def _utterances():
    rng = np.random.default_rng(0)
    return [
        rng.normal(size=(30, C - 1)).astype(np.float32),  # padded channels
        rng.normal(size=(3, 33, C)).astype(np.float32),  # batch
        rng.normal(size=(50, C)).astype(np.float32),  # clipped to MAX
    ]


def _assert_same(got, want):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], **F32)
    assert got["sequences"] == want["sequences"]


def test_predictor_matches_jax(setup):
    jpred, tree = setup
    port = _port(tree)
    for x in _utterances():
        got, want = port(x), jpred(x)
        assert got["tokens"].dtype == np.int32
        assert got["probabilities"].shape == got["tokens"].shape
        _assert_same(got, want)


def test_predictor_rejects_channel_overflow(setup):
    _, tree = setup
    with pytest.raises(ValueError, match="channels"):
        _port(tree)(np.zeros((20, C + 1), np.float32))


def test_streaming_session_equals_predictor(setup):
    _, tree = setup
    port = _port(tree)
    x = np.random.default_rng(1).normal(size=(34, C)).astype(np.float32)
    session = tserve.StreamingSession(port)
    assert session.decode()["sequences"] == [""]
    for chunk in np.split(x, [7, 12, 25]):
        session.push(chunk)
    assert session.num_samples == 34
    _assert_same(session.decode(), port(x))
    session.push(np.zeros((10, C), np.float32))  # capped at max_samples
    assert session.num_samples == MAX
    session.endpoint()
    assert session.num_samples == 0


def test_checkpoint_round_trip(setup, tmp_path):
    jpred, tree = setup
    back = convert.params_to_numpy(convert.params_from_numpy(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    path = convert.save_checkpoint(
        str(tmp_path / "ckpt.pt"), convert.params_from_numpy(tree, "cpu"),
        epoch=3,
    )
    assert convert.load_checkpoint(path, device="cpu")["epoch"] == 3
    cfg = ts.Seq2SeqConfig(**KW, use_pallas_lstm=True)
    restored = tserve.OnlinePredictor.from_checkpoint(
        path, cfg, TARGETS, max_samples=MAX, device="cpu"
    )
    x = _utterances()[1]
    _assert_same(restored(x), jpred(x))
    predict = tserve.construct_online_predictor(
        path, TARGETS, cfg, max_samples=MAX, device="cpu"
    )
    assert predict(x) == jpred(x)["sequences"]


def test_entry_points_raise_without_a_gpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tree = setup
    cfg = ts.Seq2SeqConfig(**KW)
    conformer = ts.Seq2SeqConfig(**{**KW, "encoder_type": "conformer"})
    params = convert.params_from_numpy(tree, device="cpu")
    path = convert.save_checkpoint(str(tmp_path / "c.pt"), params)
    calls = [
        lambda: convert.params_from_numpy(tree),
        lambda: ts.init_seq2seq(cfg),
        lambda: tserve.OnlinePredictor(params, cfg, TARGETS),
        lambda: tserve.OnlinePredictor.from_checkpoint(path, cfg, TARGETS),
        lambda: convert.load_checkpoint(path),
        lambda: tserve.StreamingConformerSession(params, conformer, TARGETS),
        lambda: tserve.StreamingSessionPool(params, conformer, TARGETS),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_imports_with_jax_blocked():
    """Every module of the package (found by walking it, so new modules
    are covered too) and chip_smoke.py import with JAX, optax, orbax and
    the JAX package blocked, and with tensorflow and pandas blocked too:
    the port imports those only inside the functions that read a TF1 file
    (``utils.tf1_import.read_tf1_checkpoint``) or build a table
    (``MultiSubjectTrainer.subject_to_table``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'orbax', 'ecog2txt_tpu', 'tensorflow', "
        "'pandas'):\n"
        "    sys.modules[m] = None\n"
        "import ecog2txt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "ecog2txt_tpu_torch.__path__, 'ecog2txt_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'train', 'pipeline', 'records', 'datagen', 'subjects', "
        "'demo', 'config', 'assess', 'tokenizers', 'geometry', 'audio', "
        "'serve', 'convert', 'ops.lstm_kernels', 'models.seq2seq', 'models.ctc', "
        "'models.beam', 'models.conformer', 'utils.introspect', 'utils.summaries', "
        "'utils.tf1_import', 'utils.profiling', 'utils.flops', 'run_demo', "
        "'parallel', 'parallel.comm', 'parallel.mesh', 'parallel.multihost', "
        "'parallel.expert', 'parallel.sequence', 'parallel.launch', 'parallel.pipeline', "
        "'parallel.sp_pp', 'parallel.dryrun', 'experiments', 'plotting', 'plotting.hkl', "
        "'plotting.results', 'plotting.gridsearch', 'plotting.anatomy', 'plotting.plotters', "
        "'plotting.latex', 'plotting.figures', 'plotting.embeddings', 'examples', "
        "'examples.run_mocha_scale', 'examples.stream_long_recording', 'examples.serve_pool', "
        "'examples.raw_voltage_demo', 'examples.moe_expert_parallel', "
        "'examples.migrate_from_reference'}\n"
        "assert need <= {n.split('.', 1)[1] for n in names}, names\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'ecog2txt_tpu', 'tensorflow', 'pandas') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_imports_without_the_host_only_libraries():
    """Every module of the package (walked) imports with matplotlib,
    h5py, sklearn, seaborn and pandas blocked, as on a machine that lacks
    them: the analysis layer imports them only inside the functions that
    draw, read a hickle file, cluster or tabulate."""
    blocked = ("matplotlib", "h5py", "sklearn", "seaborn", "pandas")
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {blocked!r}:\n"
        "    sys.modules[m] = None\n"
        "import ecog2txt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "ecog2txt_tpu_torch.__path__, 'ecog2txt_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'ecog2txt_tpu_torch.plotting.plotters' in names, names\n"
        "assert 'ecog2txt_tpu_torch.examples.migrate_from_reference' in names, names\n"
        "from ecog2txt_tpu_torch.plotting import DecodingResults, ResultsPlotter\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{blocked!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
