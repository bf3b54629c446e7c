"""The port's row LayerNorm (K5f, K5b) held to JAX.

The plain versions of K5f and K5b (what the port runs on a CPU tensor)
and the ``layer_norm`` autograd Function (forward K5f, backward K5b plus
one sum of its partials) against the Pallas ``pallas_layernorm.layer_norm``
(interpret mode off the TPU) and ``jax.grad`` of it, at the shapes of
``tests/test_pallas_layernorm.py`` (rows not a multiple of the Pallas
block among them); at D=64, which the Pallas kernel does not take,
against JAX's conformer ``_layernorm``.  Inputs come from a numpy seed.
Tolerances: f32 rtol 1e-4 / atol 1e-5; bf16 rtol 5e-2 / atol 2e-2.
``dg``/``db`` are sums over every row and are held at the same
tolerances elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.models.conformer import _layernorm as jax_layernorm
from ecog2txt_tpu.ops import pallas_layernorm as jln
from ecog2txt_tpu_torch.models import conformer as tconformer
from ecog2txt_tpu_torch.ops import layernorm_kernels as ln
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
TOL = {"float32": F32, "bfloat16": BF16}
# the shapes of tests/test_pallas_layernorm.py (2·40, 5·300 and 7·13 rows:
# none a multiple of the Pallas kernel's 1024-row block)
SHAPES = [(2, 40, 384), (5, 300, 384), (1, 1, 128), (7, 13, 128)]


def _inputs(shape, dtype, seed=0):
    """x (stream dtype, exact in bf16 when bf16), g, b (f32), dy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0 + 1.0).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
        dy = torch.from_numpy(dy).bfloat16().float().numpy()
    g = (rng.normal(size=shape[-1:]) * 0.2 + 1.0).astype(np.float32)
    b = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    return x, g, b, dy


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k5f_and_k5b_match_pallas(dtype, shape):
    """K5f's output and K5b's dx and summed dg/db partials against the
    Pallas forward and backward (``_ln_fwd`` / ``_ln_bwd``)."""
    x, g, b, dy = _inputs(shape, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    want_y, res = jln._ln_fwd(jx, jnp.asarray(g), jnp.asarray(b), 1e-6)
    want_dx, want_dg, want_db = jln._ln_bwd(1e-6, res, jdy)
    D = shape[-1]
    tx = torch.from_numpy(x).to(tdt).reshape(-1, D)
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)
    y = ln.layer_norm_fwd(tx, tg, tb)
    dx, dg, db = ln.layer_norm_bwd(tx, torch.from_numpy(dy).to(tdt).reshape(-1, D), tg)
    assert ln.layer_norm_fwd.launches == ln.layer_norm_bwd.launches == 0
    assert y.dtype == dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    assert dg.shape == db.shape == (1, D)  # the plain version is one block
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(want_y).reshape(-1, D), **tol)
    np.testing.assert_allclose(_np(dx), _np(want_dx).reshape(-1, D), **tol)
    np.testing.assert_allclose(_np(dg.sum(0)), _np(want_dg), **tol)
    np.testing.assert_allclose(_np(db.sum(0)), _np(want_db), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_function_matches_jax_grad(dtype):
    """``layer_norm`` values and dL/d(x, g, b) against ``jax.grad`` of the
    Pallas ``layer_norm`` (the shape of test_pallas_layernorm's gradient
    test); ``dx`` comes back in the stream dtype, ``dg``/``db`` in f32."""
    x, g, b, _ = _inputs((3, 200, 384), dtype, seed=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x, g, b):
        y = jln.layer_norm(x, g, b)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    (_, jy), want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
              torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()]
    y = ln.layer_norm(*leaves)
    assert y.dtype == tdt and y.shape == x.shape
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype])
    y.float().sin().sum().backward()
    assert leaves[0].grad.dtype == tdt
    assert leaves[1].grad.dtype == leaves[2].grad.dtype == torch.float32
    for name, t, w in zip(("x", "g", "b"), leaves, want):
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_at_d64_matches_the_jax_conformer(dtype):
    """D=64 (the demo conformer's width, which the Pallas kernel does not
    take): values and dL/d(x, g, b) against JAX's conformer
    ``_layernorm``."""
    x, g, b, _ = _inputs((4, 9, 64), dtype, seed=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x, g, b):
        y = jax_layernorm({"g": g, "b": b}, x)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    (_, jy), want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
              torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()]
    y = ln.layer_norm(*leaves)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype])
    y.float().sin().sum().backward()
    for name, t, w in zip(("x", "g", "b"), leaves, want):
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name, **TOL[dtype])


def test_conformer_layernorm_keeps_the_plain_math_on_the_cpu():
    """On a CPU tensor the conformer's ``_layernorm`` is the plain math of
    K5f (so every CPU conformer number stays as it was) and launches
    nothing; under no gradient ``layer_norm`` runs the forward alone."""
    x, g, b, _ = _inputs((2, 5, 64), "bfloat16", seed=5)
    tx = torch.from_numpy(x).bfloat16()
    p = {"g": torch.from_numpy(g), "b": torch.from_numpy(b)}
    got = tconformer._layernorm(p, tx)
    xf = tx.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    want = ((xf - mu) * torch.rsqrt(var + 1e-6) * p["g"] + p["b"]).to(tx.dtype)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(ln.layer_norm(tx, p["g"], p["b"]), want)
    assert ln.layer_norm_fwd.launches == ln.layer_norm_bwd.launches == 0


@pytest.mark.parametrize("bad", ["x_3d", "x_f16", "g_shape", "b_dtype", "dy_dtype",
                                 "noncontiguous"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, g, b, dy = (torch.from_numpy(a) for a in _inputs((6, 32), "float32"))
    if bad == "x_3d":
        x = x[None]
    elif bad == "x_f16":
        x = x.half()
    elif bad == "g_shape":
        g = g[:-1]
    elif bad == "b_dtype":
        b = b.double()
    elif bad == "dy_dtype":
        dy = dy.bfloat16()
    else:
        x = x.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        if bad == "dy_dtype":
            ln.layer_norm_bwd(x, dy, g)
        else:
            ln.layer_norm_fwd(x, g, b)
