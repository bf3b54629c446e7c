"""The port's banded-attention kernels held to the JAX package at small
sizes: the plain versions of K2f, K2b-dq, K2b-dkv and K3f against the
Pallas functions ``_fwd_call``, ``_bwd_calls`` and ``_fused_fwd_call``
(interpret mode, as ``tests/test_flash_attention.py`` runs them), and
``banded_flash_attention`` / ``fused_attention_layer`` values and
gradients against ``jax.grad`` of their JAX twins.  Inputs come from a
numpy seed.  Rows past a sequence's valid length, or at negative
positions, are garbage in both packages (finite uniform averages) and
are compared only for finiteness.  Tolerances: f32 rtol 1e-4 / atol
1e-5; bf16 rtol 5e-2 / atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.ops import pallas_attention as jpa
from ecog2txt_tpu_torch.ops import attention_kernels as ak
from torch_threads import one_torch_thread  # noqa: F401

TOL = {
    "float32": dict(rtol=1e-4, atol=1e-5),
    "bfloat16": dict(rtol=5e-2, atol=2e-2),
}
# (B, T, H, Dh, C, L, query_rows, offset, dtype): multi-block with a
# trailing pad and L=2 (K2b-dkv's next-block rows past T1), negative and
# positive chunk-aligned offsets, QB != 128, a head dim (48) that does
# not divide 256, and one (288) above 256, where the kernel's projections
# take two head columns a thread
CASES = [
    (2, 72, 2, 8, 8, 1, 16, 0, "float32"),
    (2, 100, 2, 16, 8, 2, 32, -16, "float32"),
    (2, 40, 2, 8, 8, 1, None, 16, "bfloat16"),
    (2, 40, 2, 48, 8, 1, 16, 0, "float32"),
    (2, 40, 1, 288, 8, 1, 16, 0, "float32"),
]


def _valid_rows(B, T1, T, offset, lengths):
    """(B, T1, 1) bool: rows inside the sequence and its valid length."""
    pos = np.arange(T1) + offset
    ok = (np.arange(T1)[None] < T) & (pos[None] >= 0) & (pos[None] < lengths[:, None])
    return ok[..., None]


def _close(got, want, tol, valid=None, what=""):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    if valid is not None:
        got, want = np.where(valid, got, 0), np.where(valid, want, 0)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _case_inputs(B, T, H, Dh, C, L, qr, offset, seed=0):
    rng = np.random.default_rng(seed)
    QB = jpa._pick_query_rows(C, L, qr)
    T1 = -(-T // QB) * QB
    D = H * Dh
    q, k, v, g = (rng.standard_normal((B, T1, D)).astype(np.float32) for _ in range(4))
    lengths = np.array([T + offset, T + offset - 13], np.int32)
    return QB, T1, D, q, k, v, g, lengths


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_kernels_match_pallas(case):
    """K2f, K2b-dq, K2b-dkv and K3f (with saved q/k/v/lse) against the
    Pallas kernels themselves."""
    B, T, H, Dh, C, L, qr, offset, dt = case
    QB, T1, D, q, k, v, g, lengths = _case_inputs(B, T, H, Dh, C, L, qr, offset)
    jd, td, tol = getattr(jnp, dt), getattr(torch, dt), TOL[dt]
    J = lambda a: jnp.asarray(a).astype(jd)  # noqa: E731
    Tt = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(td)  # noqa: E731
    off_j = jnp.full((1, 1), offset, jnp.int32)
    len_j = jnp.asarray(lengths).reshape(B, 1)
    lens = torch.from_numpy(lengths)
    valid = _valid_rows(B, T1, T, offset, lengths)
    args = (offset, lens, C, L, T, QB, H)

    static = (C, L, T, QB, H, True)
    out, lse = jax.jit(lambda *a: jpa._fwd_call(*a, *static))(J(q), J(k), J(v), off_j, len_j)
    t_out, t_lse = ak.banded_attention_fwd(Tt(q), Tt(k), Tt(v), *args)
    _close(t_out, out, tol, valid, "K2f out")
    _close(t_lse, lse, TOL["float32"], valid, "K2f lse")

    # the backward from the JAX forward's residuals; the upstream gradient
    # is zero on garbage rows, as the model's masked losses make it
    g = np.where(valid, g, 0).astype(np.float32)
    delta = np.asarray(J(g), np.float32) * np.asarray(out, np.float32)
    delta = delta.reshape(B, T1, H, Dh).sum(-1).astype(np.float32)
    dq, dk, dv = jax.jit(lambda *a: jpa._bwd_calls(*a, *static))(
        J(q), J(k), J(v), off_j, len_j, J(g), lse, jnp.asarray(delta)
    )
    t_lse_j = torch.from_numpy(np.array(lse))
    t_delta = torch.from_numpy(delta)
    bwd = (Tt(q), Tt(k), Tt(v), Tt(g), t_lse_j, t_delta, *args)
    _close(ak.banded_attention_dq(*bwd), dq, tol, None, "K2b dq")
    t_dk, t_dv = ak.banded_attention_dkv(*bwd)
    _close(t_dk, dk, tol, None, "K2b dk")
    _close(t_dv, dv, tol, None, "K2b dv")

    rng = np.random.default_rng(1)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    ln_g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    want = jax.jit(lambda *a: jpa._fused_fwd_call(*a, *static, True))(
        J(q), jpa._split_rot_weights(jnp.asarray(wqkv), H, jd),
        jnp.asarray(ln_g).reshape(1, -1), jnp.asarray(ln_b).reshape(1, -1),
        off_j, len_j,
    )
    got = ak.fused_attention_fwd(
        Tt(q), ak._split_rot_weights(torch.from_numpy(wqkv), H, td),
        torch.from_numpy(ln_g), torch.from_numpy(ln_b), *args, True,
    )
    for name, a, b in zip(("out", "q", "k", "v", "lse"), got, want):
        rows = valid if name in ("out", "lse") else None
        _close(a, b, TOL["float32"] if name == "lse" and dt == "float32" else tol,
               rows, f"K3f {name}")
    (unsaved,) = ak.fused_attention_fwd(
        Tt(q), ak._split_rot_weights(torch.from_numpy(wqkv), H, td),
        torch.from_numpy(ln_g), torch.from_numpy(ln_b), *args, False,
    )
    assert torch.equal(unsaved, got[0])


def test_band_mask_and_helpers_match_jax():
    """``_band_mask`` over one block pair, ``_pick_query_rows``, the rotary
    frequencies, ``_rot_half`` and ``_split_rot_weights``."""
    for C, L, qr in ((8, 1, None), (8, 2, None), (16, 1, None), (8, 2, 32), (3, 1, 6)):
        assert ak._pick_query_rows(C, L, qr) == jpa._pick_query_rows(C, L, qr)
    with pytest.raises(ValueError, match="query_rows"):
        ak._pick_query_rows(8, 2, 24)
    for base, nq, nk, off, length in ((32, 32, 48, -16, 40), (0, 48, 32, 16, 30)):
        want = jpa._band_mask(base, base - 16, nq, nk, 8, 2, 70, off, length)
        got = ak._band_mask(base, base - 16, nq, nk, 8, 2, 70, off, length)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ak._rope_freqs(3, 24), jpa._rope_freqs(3, 24))
    y = np.random.default_rng(0).standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        ak._rot_half(torch.from_numpy(y), 3).numpy(), np.asarray(jpa._rot_half(jnp.asarray(y), 3))
    )
    w = np.random.default_rng(1).standard_normal((24, 72)).astype(np.float32)
    for a, b in zip(ak._split_rot_weights(torch.from_numpy(w), 3, torch.float32),
                    jpa._split_rot_weights(jnp.asarray(w), 3, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _grad_inputs(dt, T=100, H=2, Dh=8, seed=2):
    rng = np.random.default_rng(seed)
    B = 2
    q, k, v = (rng.standard_normal((B, T, H, Dh)).astype(np.float32) for _ in range(3))
    lengths = np.array([T, T - 23], np.int32)
    valid = (np.arange(T)[None] < lengths[:, None])[..., None, None]
    cot = np.where(valid, rng.standard_normal((B, T, H, Dh)), 0).astype(np.float32)
    return q, k, v, lengths, valid, cot


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_banded_flash_attention_values_and_grads(dt):
    """Forward K2f and backward K2b (plain versions) through the autograd
    Function against ``jax.grad`` through the Pallas custom VJP."""
    q, k, v, lengths, valid, cot = _grad_inputs(dt)
    jd, td = getattr(jnp, dt), getattr(torch, dt)
    kw = dict(chunk_size=8, left_context=2, query_rows=32)

    def jloss(q, k, v):
        out = jpa.banded_flash_attention(q, k, v, 16, jnp.asarray(lengths) + 16,
                                         interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v))
    )
    leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = ak.banded_flash_attention(*leaves, 16, torch.from_numpy(lengths) + 16, **kw)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout, TOL[dt], valid, "out")
    for name, leaf, want in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == td
        _close(leaf.grad, want, TOL[dt], None, f"d{name}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_attention_layer_values_and_grads(dt):
    """K3f and its backward (K2b, un-rotary, projection and LayerNorm
    products) against ``jax.grad`` through ``fused_attention_layer``.
    The port takes the f32 ``wqkv`` and casts inside, so its gradient
    reaches the parameter in f32; JAX takes a pre-cast ``wqkv`` and rounds
    its gradient to the stream dtype: at bf16 the two differ by that
    rounding, inside the bf16 tolerance."""
    rng = np.random.default_rng(3)
    B, T, H, Dh = 2, 100, 2, 8
    D = H * Dh
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    ln_g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    lengths = np.array([T, T - 23], np.int32)
    valid = (np.arange(T)[None] < lengths[:, None])[..., None]
    cot = np.where(valid, rng.standard_normal((B, T, D)), 0).astype(np.float32)
    jd, td = getattr(jnp, dt), getattr(torch, dt)
    kw = dict(chunk_size=8, left_context=1, num_heads=H, query_rows=32)

    def jloss(w, g, b, x):
        out = jpa.fused_attention_layer(w.astype(jd), g, b, x, -16,
                                        jnp.asarray(lengths) - 16, interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jgrads = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)
    )(
        jnp.asarray(wqkv), jnp.asarray(ln_g), jnp.asarray(ln_b), jnp.asarray(x).astype(jd)
    )
    leaves = [torch.from_numpy(a).requires_grad_() for a in (wqkv, ln_g, ln_b)]
    tx = torch.from_numpy(x).to(td).requires_grad_()
    out = ak.fused_attention_layer(*leaves, tx, -16, torch.from_numpy(lengths) - 16, **kw)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    valid_rows = valid & (np.arange(T)[None, :, None] >= 16)  # positions >= 0
    _close(out.detach(), jout, TOL[dt], valid_rows, "out")
    for name, leaf, want in zip(("wqkv", "ln_g", "ln_b", "x"), (*leaves, tx), jgrads):
        # the parameters' gradients stay f32 whatever the stream dtype
        assert leaf.grad.dtype == (td if name == "x" else torch.float32), name
        _close(leaf.grad, want, TOL[dt], None, f"d{name}")


def test_serving_runs_the_forward_kernels_alone(monkeypatch):
    """With no gradient wanted the entry points call the forward kernels
    without the residuals (K3f with save=False) and nothing else."""
    calls = []
    fwd, fused = ak.banded_attention_fwd, ak.fused_attention_fwd
    monkeypatch.setattr(ak, "banded_attention_fwd",
                        lambda *a: calls.append("K2f") or fwd(*a))
    monkeypatch.setattr(ak, "fused_attention_fwd",
                        lambda *a, save: calls.append(f"K3f save={save}") or fused(*a, save=save))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 48)).astype(np.float32)).requires_grad_()
    g, b = torch.ones(16, requires_grad=True), torch.zeros(16, requires_grad=True)
    with torch.inference_mode():
        ak.fused_attention_layer(w, g, b, x, chunk_size=8, left_context=1, num_heads=2)
        q = x.reshape(1, 40, 2, 8)
        ak.banded_flash_attention(q, q, q, chunk_size=8, left_context=1)
    assert calls == ["K3f save=False", "K2f"]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros((1, 32, 16))
    lens = torch.full((1,), 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of QB"):
        ak.banded_attention_fwd(z, z, z, 0, lens, 8, 1, 32, 24, 2)
    with pytest.raises(ValueError, match="multiple of H"):
        ak.banded_attention_fwd(z, z, z, 0, lens, 8, 1, 32, 32, 3)
    w, ln = torch.zeros((16, 16)), torch.zeros(16)
    with pytest.raises(ValueError, match="head dim"):  # rotary needs an even one
        ak.fused_attention_fwd(z, (w,) * 5, ln, ln, 0, lens, 8, 1, 32, 32, 16, False)
    with pytest.raises(TypeError, match="stream dtype"):
        ak.banded_attention_fwd(z.half(), z.half(), z.half(), 0, lens, 8, 1, 32, 32, 2)
    with pytest.raises(ValueError, match="lengths"):
        ak.banded_attention_fwd(z, z, z, 0, lens.long(), 8, 1, 32, 32, 2)
    with pytest.raises(ValueError, match="contiguous"):
        zt = torch.zeros((1, 16, 32)).transpose(1, 2)
        ak.banded_attention_fwd(zt, z, z, 0, lens, 8, 1, 32, 32, 2)
