"""The port's LSTM adjoint (K1b) and its autograd Function held to JAX.

The adjoint's plain PyTorch version (what the port runs on a CPU tensor)
against the Pallas adjoint ``_bwd_call`` in interpret mode, and the
gradients of the port's ``fused_lstm_recurrence`` (forward K1f, backward
K1b) and of its ``bidirectional_lstm`` against ``jax.grad`` of the JAX
functions in interpret mode.  Inputs come from a numpy seed.
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
from ecog2txt_tpu.ops.pallas_lstm import _bwd_call
from ecog2txt_tpu.ops.pallas_lstm import fused_lstm_recurrence as jfused
from ecog2txt_tpu_torch.convert import params_from_numpy
from ecog2txt_tpu_torch.ops import lstm as tlstm
from ecog2txt_tpu_torch.ops import lstm_kernels
from torch_threads import one_torch_thread  # noqa: F401

T, B, F, H = 7, 4, 6, 8
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
LENGTHS = np.array([T, 5, 3, 6], np.int32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bwd_inputs(rng, dtype, variant, reverse_time):
    seq = lambda: rng.normal(size=(T, B, H)).astype(np.float32)  # noqa: E731
    state = lambda: (rng.normal(size=(B, H)) * 0.5).astype(np.float32)  # noqa: E731
    xw = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    hprev, cprev, cseq, dhseq = seq(), seq(), seq(), seq()
    if dtype == "bfloat16":
        xw, wh, hprev, cprev, cseq, dhseq = map(
            _bf16_exact, (xw, wh, hprev, cprev, cseq, dhseq)
        )
    if variant == "full":
        lengths = np.full((B,), T, np.int32)
        mask = np.ones((B, H), np.float32)
        dhT = dcT = np.zeros((B, H), np.float32)
    else:
        lengths = LENGTHS
        mask = (rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32)
        dhT, dcT = state(), state()
    return dict(xw=xw, wh=wh, hprev=hprev, cprev=cprev, cseq=cseq,
                lengths=lengths, mask=mask, dhseq=dhseq, dhT=dhT, dcT=dcT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("variant", ["full", "ragged_mask_state"])
def test_bwd_reference_matches_pallas(dtype, reverse_time, variant):
    rng = np.random.default_rng(11)
    a = _bwd_inputs(rng, dtype, variant, reverse_time)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    stream = ("xw", "wh", "hprev", "cprev", "cseq", "dhseq")
    want = _bwd_call(
        *(jnp.asarray(a[k], jdt if k in stream else None) for k in
          ("xw", "wh", "hprev", "cprev", "cseq", "lengths", "mask",
           "dhseq", "dhT", "dcT")),
        True, reverse_time,
    )  # dgates, dh0, dc0
    got = lstm_kernels.lstm_recurrence_bwd(
        **{k: torch.from_numpy(v).to(tdt) if k in stream
           else torch.from_numpy(v) for k, v in a.items()},
        reverse_time=reverse_time,
    )
    assert got[0].dtype == tdt
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    assert lstm_kernels.lstm_recurrence_bwd.launches == 0
    tol = BF16 if dtype == "bfloat16" else F32
    for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **tol)
    # steps past each length give exactly zero dgates
    for b, n in enumerate(a["lengths"]):
        assert not _np(got[0])[n:, b].any()


@pytest.mark.parametrize(
    "bad", ["hprev_dtype", "dhseq_shape", "dhT_dtype", "noncontiguous"]
)
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = {k: torch.from_numpy(v) for k, v in
         _bwd_inputs(np.random.default_rng(0), "float32", "full", False).items()}
    if bad == "hprev_dtype":
        a["hprev"] = a["hprev"].bfloat16()
    elif bad == "dhseq_shape":
        a["dhseq"] = a["dhseq"][:-1]
    elif bad == "dhT_dtype":
        a["dhT"] = a["dhT"].double()
    else:
        a["cseq"] = a["cseq"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        lstm_kernels.lstm_recurrence_bwd(**a)


def _recurrence_case(reverse_time, seed=3):
    rng = np.random.default_rng(seed)
    xw = (rng.normal(size=(T, B, 4 * H)) * 0.7).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = (rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32)
    if reverse_time:  # the reverse-time recurrence takes a zero state
        h0 = c0 = np.zeros((B, H), np.float32)
    else:
        h0, c0 = ((rng.normal(size=(B, H)) * 0.3).astype(np.float32)
                  for _ in "hc")
    w_out = rng.normal(size=(H,)).astype(np.float32)
    return xw, wh, h0, c0, mask, w_out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse_time", [False, True])
def test_function_gradients_match_jax(dtype, reverse_time):
    """dL/d(xw, wh, h0, c0) through forward K1f + backward K1b, against
    jax.grad of the Pallas custom VJP (interpret mode).  The loss reads
    the output sequence and both final states."""
    xw, wh, h0, c0, mask, w_out = _recurrence_case(reverse_time)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        xw = _bf16_exact(xw)

    def jloss(xw, wh, h0, c0):
        out, hT, cT = jfused(
            xw.astype(jdt), wh, jnp.asarray(LENGTHS), h0, c0,
            jnp.asarray(mask), True, reverse_time,
        )
        return (jnp.sum(out.astype(jnp.float32) * w_out) + 2.0 * jnp.sum(hT)
                + 0.5 * jnp.sum(cT ** 2))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (xw, wh, h0, c0))
    )
    leaves = [torch.from_numpy(v).requires_grad_() for v in (xw, wh, h0, c0)]
    out, hT, cT = lstm_kernels.fused_lstm_recurrence(
        leaves[0].to(tdt), leaves[1], torch.from_numpy(LENGTHS), leaves[2],
        leaves[3], torch.from_numpy(mask), reverse_time=reverse_time,
    )
    assert out.dtype == tdt
    loss = ((out.float() * torch.from_numpy(w_out)).sum() + 2.0 * hT.sum()
            + 0.5 * (cT ** 2).sum())
    loss.backward()
    # the recurrent weight's gradient reaches the f32 parameter in f32
    assert leaves[1].grad.dtype == torch.float32
    tol = BF16 if dtype == "bfloat16" else F32
    for name, g, w in zip(("xw", "wh", "h0", "c0"), leaves, want):
        np.testing.assert_allclose(_np(g.grad), _np(w), err_msg=name, **tol)


def test_invalid_step_upstream_grad_dropped():
    """Gradient flowing into outputs past the valid prefix vanishes (the
    forward emits a constant 0 there)."""
    xw, wh, h0, c0, mask, _ = _recurrence_case(False)
    x = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(wh).requires_grad_()
    out, _, _ = lstm_kernels.fused_lstm_recurrence(
        x, w, torch.from_numpy(LENGTHS), torch.from_numpy(h0),
        torch.from_numpy(c0), torch.from_numpy(mask),
    )
    out[4:, 2].sum().backward()  # sequence 2 has length 3
    assert not x.grad.any() and not w.grad.any()

    def jloss(xw):
        out, _, _ = jfused(xw, jnp.asarray(wh), jnp.asarray(LENGTHS),
                           jnp.asarray(h0), jnp.asarray(c0),
                           jnp.asarray(mask), True)
        return jnp.sum(out[4:, 2])

    np.testing.assert_allclose(np.asarray(jax.grad(jloss)(jnp.asarray(xw))), 0.0)


def test_serving_does_not_save_c_seq(monkeypatch):
    """Without a gradient to compute, the recurrence asks K1f for no
    ``c_seq``; under autograd it asks for it as the residual."""
    asked = []
    real = lstm_kernels.lstm_recurrence

    def spy(*args, **kwargs):
        asked.append(kwargs.get("return_c_seq", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(lstm_kernels, "lstm_recurrence", spy)
    xw, wh, h0, c0, mask, _ = _recurrence_case(False)
    args = [torch.from_numpy(v) for v in (xw, wh)]
    rest = (torch.from_numpy(LENGTHS), torch.from_numpy(h0),
            torch.from_numpy(c0), torch.from_numpy(mask))
    with torch.inference_mode():
        lstm_kernels.fused_lstm_recurrence(*args, *rest)
    with torch.no_grad():
        lstm_kernels.fused_lstm_recurrence(args[0], args[1].requires_grad_(), *rest)
    assert asked == [False, False]
    out, _, _ = lstm_kernels.fused_lstm_recurrence(*args, *rest)
    assert asked == [False, False, True] and out.requires_grad


@pytest.mark.parametrize("dtype", ["float32"])
def test_bidirectional_gradients_with_masks(dtype):
    """Gradients of a biLSTM layer on the kernel path, with explicit
    recurrent dropout masks, against jax.grad of the JAX layer."""
    jf = jlstm.init_lstm_params(jax.random.PRNGKey(0), F, H)
    jb = jlstm.init_lstm_params(jax.random.PRNGKey(1), F, H)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(T, B, F)).astype(np.float32)
    masks = [(rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32)
             for _ in "fb"]
    w_out = rng.normal(size=(2 * H,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jloss(pf, pb, xs):
        out, (h, c) = jlstm.bidirectional_lstm(
            pf, pb, xs, jnp.asarray(LENGTHS), tuple(map(jnp.asarray, masks)),
            jdt, use_pallas=True, pallas_interpret=True,
        )
        return jnp.sum(out.astype(jnp.float32) * w_out) + jnp.sum(h) + jnp.sum(c)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jf, jb, jnp.asarray(xs))
    tf = params_from_numpy(jax.tree.map(np.asarray, jf), device="cpu")
    tb = params_from_numpy(jax.tree.map(np.asarray, jb), device="cpu")
    for p in (tf, tb):
        for v in p.values():
            v.requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    out, (h, c) = tlstm.bidirectional_lstm(
        tf, tb, x, torch.from_numpy(LENGTHS),
        tuple(map(torch.from_numpy, masks)), getattr(torch, dtype),
        use_pallas=True,
    )
    loss = (out.float() * torch.from_numpy(w_out)).sum() + h.sum() + c.sum()
    loss.backward()
    tol = BF16 if dtype == "bfloat16" else F32
    for name, p, jp in (("fwd", tf, want[0]), ("bwd", tb, want[1])):
        for k in ("wx", "wh", "b"):
            assert p[k].grad.dtype == torch.float32
            np.testing.assert_allclose(
                _np(p[k].grad), np.asarray(jp[k]), err_msg=f"{name} {k}", **tol
            )
    np.testing.assert_allclose(_np(x.grad), np.asarray(want[2]), **tol)
