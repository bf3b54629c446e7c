"""Row LayerNorm: the Hopper kernels (forward K5f, backward K5b), their
wrappers, their plain PyTorch versions and the autograd Function.

The port of ``ecog2txt_tpu/ops/pallas_layernorm.py``: ``layer_norm_fwd``
is ``_ln_fwd`` (K5f) and ``layer_norm_bwd`` is ``_ln_bwd`` (K5b).  Over
the last axis, with f32 statistics whatever the stream dtype, f32 affine
parameters and the result cast back to the stream dtype: the function of
``models/conformer._layernorm``.  The backward recomputes the statistics
from ``x`` and returns per-block f32 partials of ``dg``/``db`` that the
caller sums.

On a CUDA tensor each wrapper launches its kernel (``csrc/layer_norm.cu``)
or raises; on a CPU tensor it runs its plain version (``*_reference``).
``<wrapper>.launches`` counts kernel launches.  :func:`layer_norm` is the
differentiable entry point.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def layer_norm_fwd_reference(x, g, b, eps: float = 1e-6):
    """Plain version of K5f: ``S((x - mu) * rsqrt(var + eps) * g + b)``
    with f32 statistics over the last axis (S = the dtype of ``x``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * g + b
    return out.to(x.dtype)


def layer_norm_bwd_reference(x, dy, g, eps: float = 1e-6):
    """Plain version of K5b on ``(rows, D)`` tensors: ``(dx, dg_part,
    db_part)``, ``dx`` in the dtype of ``x``, the partials ``(1, D)`` f32
    (one block: every row)."""
    xf, dyf = x.float(), dy.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rs = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rs
    dyg = dyf * g
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = ((dyg - m1 - xhat * m2) * rs).to(x.dtype)
    return dx, (dyf * xhat).sum(dim=0, keepdim=True), dyf.sum(dim=0, keepdim=True)


def _check(name, x, g, others=()):
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (rows, D); got {tuple(x.shape)}")
    if x.dtype not in _STREAM_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16; got {x.dtype}")
    D = x.shape[1]
    for a in others:
        if a.shape != x.shape or a.dtype != x.dtype:
            raise ValueError(f"{name}: dy must be {tuple(x.shape)} {x.dtype}")
    for a in g:
        if tuple(a.shape) != (D,) or a.dtype != torch.float32:
            raise ValueError(f"{name}: g and b must be ({D},) float32")
    tensors = (x, *others, *g)
    if any(a.device != x.device for a in tensors):
        raise ValueError(f"{name}: inputs must share one device")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def _launch(fn_name, ptrs, rows, D, x, eps):
    fn = getattr(load_library("layer_norm"), fn_name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, rows, D, int(x.dtype == torch.bfloat16), eps, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed with CUDA error {err} "
            f"(rows={rows}, D={D}, {x.dtype})"
        )


def layer_norm_fwd(x, g, b, eps: float = 1e-6):
    """``y`` of the row LayerNorm over ``x`` (rows, D) — see
    :func:`layer_norm_fwd_reference`.  Launches K5f on a CUDA tensor (or
    raises), runs the plain version on a CPU tensor."""
    _check("layer_norm_fwd", x, (g, b))
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, g, b, eps)
    rows, D = x.shape
    y = torch.empty_like(x)
    _launch("layer_norm_fwd",
            [x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr()], rows, D, x, eps)
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def layer_norm_bwd(x, dy, g, eps: float = 1e-6):
    """``(dx, dg_part, db_part)`` of the row LayerNorm — see
    :func:`layer_norm_bwd_reference`; on the card the partials hold one
    row per block of K5b, ``(ceil(rows / rows_per_block), D)`` f32.
    Launches K5b on a CUDA tensor (or raises), runs the plain version on a
    CPU tensor."""
    _check("layer_norm_bwd", x, (g,), (dy,))
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, dy, g, eps)
    rows, D = x.shape
    per_block = load_library("layer_norm").layer_norm_bwd_rows_per_block
    per_block.argtypes = []
    per_block.restype = ctypes.c_int
    blocks = -(-rows // per_block())
    dx = torch.empty_like(x)
    dg = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    _launch("layer_norm_bwd",
            [x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), dg.data_ptr(),
             db.data_ptr()], rows, D, x, eps)
    layer_norm_bwd.launches += 1
    return dx, dg, db


layer_norm_bwd.launches = 0


class LayerNorm(torch.autograd.Function):
    """K5f forward, K5b backward plus one sum of its partials: the port of
    the custom VJP of ``pallas_layernorm.layer_norm``.  Saves ``x``, not
    the statistics (K5b recomputes them).  ``g`` and ``b`` enter as f32
    and their gradients come back f32; ``dx`` comes back in the dtype of
    ``x``."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        ctx.save_for_backward(x2, g)
        ctx.eps = eps
        ctx.shape = shape
        return layer_norm_fwd(x2, g.contiguous(), b.contiguous(), eps).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2, g = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        dx, dg, db = layer_norm_bwd(x2, dy2, g.contiguous(), ctx.eps)
        return dx.reshape(ctx.shape), dg.sum(dim=0), db.sum(dim=0), None


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    """LayerNorm over the last axis of ``x`` (any leading shape, float32
    or bfloat16) with f32 ``g``/``b`` ``(D,)``: the port's drop-in for
    ``models/conformer._layernorm``, differentiable in ``x``, ``g`` and
    ``b``.  With no gradient wanted it runs K5f alone and saves nothing."""
    wants_grad = torch.is_grad_enabled() and any(a.requires_grad for a in (x, g, b))
    if not wants_grad:
        shape = x.shape
        return layer_norm_fwd(
            x.reshape(-1, shape[-1]).contiguous(), g.contiguous(), b.contiguous(), eps
        ).reshape(shape)
    return LayerNorm.apply(x, g, b, eps)
