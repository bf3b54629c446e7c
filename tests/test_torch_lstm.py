"""The port's LSTM ops held to the JAX package at small shapes.

The recurrence kernel's plain PyTorch version (what the port runs on a
CPU tensor) against the Pallas kernel in interpret mode; the port's
``lstm_scan`` / ``bidirectional_lstm`` / ``reverse_padded`` against the
JAX functions.  Inputs come from a numpy seed; parameters are made by
the JAX ``init_lstm_params`` and carried across as numpy.
Tolerances: f32 rtol 1e-4 / atol 1e-5 (only the order of f32 sums
differs); bf16 rtol 5e-2 / atol 2e-2 (bf16 outputs may land one bf16
step apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.ops import lstm as jlstm
from ecog2txt_tpu.ops.pallas_lstm import _fwd_call
from ecog2txt_tpu_torch.convert import params_from_numpy
from ecog2txt_tpu_torch.ops import lstm as tlstm
from ecog2txt_tpu_torch.ops import lstm_kernels
from torch_threads import one_torch_thread  # noqa: F401

T, B, F, H = 12, 4, 6, 8
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
LENGTHS = np.array([T, 7, 3, 10], np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jlstm.init_lstm_params(jax.random.PRNGKey(0), F, H)
    tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(tree, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32
    )


def _bf16_exact(a):
    """f32 values that bf16 represents exactly (so both frameworks start
    from the same bf16 inputs)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("variant", ["serving", "ragged_mask_state"])
def test_recurrence_reference_matches_pallas(dtype, reverse_time, variant):
    rng = np.random.default_rng(7)
    xw = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    if dtype == "bfloat16":
        xw, wh = _bf16_exact(xw), _bf16_exact(wh)
    zeros = np.zeros((B, H), np.float32)
    if variant == "serving":
        lengths = np.full((B,), T, np.int32)
        h0 = c0 = zeros
        mask = np.ones((B, H), np.float32)
    else:
        lengths = LENGTHS
        mask = (rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32)
        # the reverse-time recurrence requires a zero initial state
        h0, c0 = (zeros, zeros) if reverse_time else (
            rng.normal(size=(B, H)).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32),
        )
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _fwd_call(
        jnp.asarray(xw, jdt), jnp.asarray(wh, jdt), jnp.asarray(lengths),
        jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(mask),
        True, reverse_time,
    )  # h_seq, c_seq, hT, cT
    tdt = getattr(torch, dtype)
    got = lstm_kernels.lstm_recurrence(
        torch.from_numpy(xw).to(tdt), torch.from_numpy(wh).to(tdt),
        torch.from_numpy(lengths), torch.from_numpy(h0),
        torch.from_numpy(c0), torch.from_numpy(mask),
        reverse_time=reverse_time, return_c_seq=True,
    )
    assert got[0].dtype == tdt and got[1].dtype == tdt
    assert got[2].dtype == torch.float32 and got[3].dtype == torch.float32
    tol = BF16 if dtype == "bfloat16" else F32
    for name, g, w in zip(("h_seq", "c_seq", "hT", "cT"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **tol)
    # past each length the outputs are exactly zero
    for b, n in enumerate(lengths):
        assert not _np(got[0])[n:, b].any()


def test_reference_skips_c_seq_by_default():
    xw = torch.zeros((T, B, 4 * H))
    out = lstm_kernels.lstm_recurrence(
        xw, torch.zeros((H, 4 * H)), torch.full((B,), T, dtype=torch.int32),
        torch.zeros((B, H)), torch.zeros((B, H)), torch.ones((B, H)),
    )
    assert out[1] is None and lstm_kernels.lstm_recurrence.launches == 0


@pytest.mark.parametrize(
    "bad",
    ["int_dtype", "wh_dtype", "wh_shape", "lengths_int64", "noncontiguous",
     "h0_shape"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(
        xw=torch.zeros((T, B, 4 * H)), wh=torch.zeros((H, 4 * H)),
        lengths=torch.full((B,), T, dtype=torch.int32),
        h0=torch.zeros((B, H)), c0=torch.zeros((B, H)),
        mask=torch.ones((B, H)),
    )
    if bad == "int_dtype":
        args["xw"] = args["xw"].int()
    elif bad == "wh_dtype":
        args["wh"] = args["wh"].bfloat16()
    elif bad == "wh_shape":
        args["wh"] = torch.zeros((H + 1, 4 * H))
    elif bad == "lengths_int64":
        args["lengths"] = args["lengths"].long()
    elif bad == "noncontiguous":
        args["xw"] = torch.zeros((B, T, 4 * H)).transpose(0, 1)
    else:
        args["h0"] = torch.zeros((B, H + 1))
    with pytest.raises((TypeError, ValueError)):
        lstm_kernels.lstm_recurrence(**args)


def _inputs():
    rng = np.random.default_rng(0)
    return rng.normal(size=(T, B, F)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_state_and_mask", [False, True])
def test_lstm_scan_parity(params, use_pallas, with_state_and_mask):
    jp, tp = params
    xs = _inputs()
    state = mask = None
    if with_state_and_mask:
        rng = np.random.default_rng(1)
        state = tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in "hc")
        mask = (rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32)
    out_j, (h_j, c_j) = jlstm.lstm_scan(
        jp, jnp.asarray(xs), jnp.asarray(LENGTHS),
        None if state is None else tuple(map(jnp.asarray, state)),
        None if mask is None else jnp.asarray(mask),
        use_pallas=use_pallas, pallas_interpret=True,
    )
    out_t, (h_t, c_t) = tlstm.lstm_scan(
        tp, torch.from_numpy(xs), torch.from_numpy(LENGTHS),
        None if state is None else tuple(map(torch.from_numpy, state)),
        None if mask is None else torch.from_numpy(mask),
        use_pallas=use_pallas,
    )
    for g, w in ((out_t, out_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize(
    "use_pallas,dtype",
    [(False, "float32"), (True, "float32"), (True, "bfloat16")],
)
def test_bidirectional_parity(params, use_pallas, dtype):
    jp, tp = params
    jp2 = jlstm.init_lstm_params(jax.random.PRNGKey(1), F, H)
    tp2 = params_from_numpy(jax.tree.map(np.asarray, jp2), device="cpu")
    xs = _inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out_j, (h_j, c_j) = jlstm.bidirectional_lstm(
        jp, jp2, jnp.asarray(xs), jnp.asarray(LENGTHS), None, jdt,
        use_pallas=use_pallas, pallas_interpret=True,
    )
    out_t, (h_t, c_t) = tlstm.bidirectional_lstm(
        tp, tp2, torch.from_numpy(xs), torch.from_numpy(LENGTHS), None,
        getattr(torch, dtype), use_pallas=use_pallas,
    )
    assert out_t.shape == (T, B, 2 * H)
    tol = BF16 if dtype == "bfloat16" else F32
    for g, w in ((out_t, out_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def test_lstm_step_parity(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, F)).astype(np.float32)
    h, c = (rng.normal(size=(B, H)).astype(np.float32) for _ in "hc")
    (hj, cj), _ = jlstm.lstm_step(jp, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x))
    (ht, ct), _ = tlstm.lstm_step(
        tp, (torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x)
    )
    np.testing.assert_allclose(_np(ht), _np(hj), **F32)
    np.testing.assert_allclose(_np(ct), _np(cj), **F32)


def test_reverse_padded_parity():
    xs = np.arange(T * B * 3, dtype=np.float32).reshape(T, B, 3)
    want = jlstm.reverse_padded(jnp.asarray(xs), jnp.asarray(LENGTHS))
    got = tlstm.reverse_padded(torch.from_numpy(xs), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # applying it twice restores the input
    back = tlstm.reverse_padded(got, torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(back.numpy(), xs)


def test_init_lstm_params_shapes_and_orthogonality():
    g = torch.Generator().manual_seed(0)
    p = tlstm.init_lstm_params(g, F, H, device="cpu")
    assert p["wx"].shape == (F, 4 * H) and p["wh"].shape == (H, 4 * H)
    assert not p["b"].any()
    for k in range(4):
        block = p["wh"][:, k * H:(k + 1) * H]
        np.testing.assert_allclose(
            (block.T @ block).numpy(), np.eye(H), atol=1e-5
        )

