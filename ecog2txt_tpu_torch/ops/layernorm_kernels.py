"""Row LayerNorm: the Hopper kernels (forward K5f, backward K5b), their
wrappers, their plain PyTorch versions and the autograd Function.

The port of ``ecog2txt_tpu/ops/pallas_layernorm.py``: ``layer_norm_fwd``
is ``_ln_fwd`` (K5f) and ``layer_norm_bwd`` is ``_ln_bwd`` (K5b).  Over
the last axis, with f32 statistics whatever the stream dtype, f32 affine
parameters and the result cast back to the stream dtype: the function of
``models/conformer._layernorm``.  The backward recomputes the statistics
from ``x`` and returns ``dg``/``db`` as ``(1, D)`` f32 rows (on the card
K5b's second launch sums its per-block partials in a fixed order).

On a CUDA tensor each wrapper launches its kernel (``csrc/layer_norm.cu``;
K5b in one of two bodies, :func:`plan_k5b_body`) or raises; on a CPU
tensor it runs its plain version (``*_reference``).
``<wrapper>.launches`` counts the wrapper's calls that launch its kernel,
one a call: a K5b call is two CUDA launches (its body, then the sum of the
body's partials) and counts once.  :func:`layer_norm` is the
differentiable entry point.
"""

from __future__ import annotations

import ctypes
import functools

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


# The no-gradient forward of K5f as an operator of its own, so that
# ``torch.export`` records it as one node of the graph: running the node
# calls the wrapper, which launches and counts the kernel (or runs the plain
# version on the CPU).
@torch.library.custom_op(
    "ecog2txt_tpu_torch::layer_norm_fwd", mutates_args=(),
    schema="(Tensor x, Tensor g, Tensor b, float eps) -> Tensor",
)
def layer_norm_fwd_op(x, g, b, eps):
    """:func:`layer_norm_fwd` (K5f)."""
    return layer_norm_fwd(x, g, b, eps)


@layer_norm_fwd_op.register_fake
def _(x, g, b, eps):
    return torch.empty_like(x)


_MAX_CHUNKS = 4  # chunks of a row a lane holds in K5b's registers body


def plan_k5b_body(dtype: torch.dtype, D: int, vec: bool) -> str:
    """K5b's body, chosen up front from the row's width: ``"registers"``
    (``csrc/layer_norm.cu::layer_norm_bwd_rows_kernel``: a warp holds a row
    in registers, each lane up to four chunks of 16-byte vectors where
    ``vec``, else of single elements: bf16 rows up to 1024 wide, f32 up to
    512, and up to 128 without vectors), else ``"columns"``
    (``layer_norm_bwd_kernel``, any width).  ``vec``: x and dy are 16-byte
    aligned and a row is a whole number of 16-byte chunks."""
    per_chunk = 16 // (torch.finfo(dtype).bits // 8) if vec else 1
    fits = D % per_chunk == 0 and -(-D // per_chunk) <= 32 * _MAX_CHUNKS
    return "registers" if fits else "columns"


def _vec_rows(x, dy) -> bool:
    """Rows of ``x`` and ``dy`` load as 16-byte vectors: both 16-byte
    aligned and a row a whole number of 16 bytes."""
    return (x.shape[1] * x.element_size()) % 16 == 0 and all(
        a.data_ptr() % 16 == 0 for a in (x, dy))


def _c_fn(name, argtypes):
    fn = getattr(load_library("layer_norm"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


_K5B_WARPS = 8  # csrc/layer_norm.cu::kWarps, the rows a K5b block takes at once


@functools.cache
def _rows_wave(D: int, bf16: bool, vec: bool, device_index: int) -> int:
    """The blocks of one wave of the registers body on ``device_index``: the
    blocks the card keeps resident (``layer_norm_bwd_rows_wave``)."""
    fn = _c_fn("layer_norm_bwd_rows_wave", [ctypes.c_int] * 3)
    with torch.cuda.device(device_index):
        wave = int(fn(D, int(bf16), int(vec)))
    if wave <= 0:
        raise RuntimeError(f"layer_norm_bwd: no grid for D={D} ({wave})")
    return wave


def _rows_blocks(rows: int, D: int, bf16: bool, vec: bool, device_index: int) -> int:
    """The registers body's grid: one wave of resident blocks, at most one
    warp a row."""
    return min(-(-rows // _K5B_WARPS), _rows_wave(D, bf16, vec, device_index))


def layer_norm_bwd(x, dy, g, eps: float = 1e-6):
    """``(dx, dg_part, db_part)`` of the row LayerNorm — see
    :func:`layer_norm_bwd_reference`; the partials are ``(1, D)`` f32, the
    sums over every row.

    On a CUDA tensor this launches K5b (and raises if it cannot be built or
    launched): the registers body, which reads each row once, for the
    widths :func:`plan_k5b_body` gives it (every width of the conformer),
    else the columns body, each followed by K5b's second launch, which sums
    the body's per-block partials in a fixed order;
    ``layer_norm_bwd.launches_by_body`` counts each body.  On a CPU tensor
    it runs the plain version."""
    _check("layer_norm_bwd", x, (g,), (dy,))
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, dy, g, eps)
    vec = _vec_rows(x, dy)
    body = plan_k5b_body(x.dtype, x.shape[1], vec)
    out = _launch_k5b(body, x, dy, g, eps, vec)
    layer_norm_bwd.launches += 1
    layer_norm_bwd.launches_by_body[body] += 1
    return out


def _launch_k5b(body, x, dy, g, eps, vec, reduce=True):
    """One K5b launch of ``body``, then (with ``reduce``) the sum of its
    per-block partials, ``(dx, dg (1, D), db (1, D))``; without, ``(dx,
    dg_part, db_part)`` with one partial row per block.  Checked inputs, no
    count."""
    rows, D = x.shape
    bf16 = x.dtype == torch.bfloat16
    if body == "registers":
        blocks = _rows_blocks(rows, D, bf16, vec, x.device.index or 0) if rows else 0
    else:
        blocks = -(-rows // _c_fn("layer_norm_bwd_rows_per_block", [])())
    dx = torch.empty_like(x)
    dg = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    ptrs = [x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), dg.data_ptr(),
            db.data_ptr()]
    if body == "registers":
        fn = _c_fn("layer_norm_bwd_rows", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
        with torch.cuda.device(x.device):
            err = fn(*ptrs, rows, D, int(bf16), int(vec), blocks, eps,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"layer_norm_bwd_rows launch failed with CUDA error {err} "
                               f"(rows={rows}, D={D}, {x.dtype}, blocks={blocks})")
    else:
        _launch("layer_norm_bwd", ptrs, rows, D, x, eps)
    if not reduce:
        return dx, dg, db
    sums = torch.empty((2, 1, D), dtype=torch.float32, device=x.device)
    fn = _c_fn("layer_norm_bwd_sum", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 3)
    with torch.cuda.device(x.device):
        err = fn(dg.data_ptr(), db.data_ptr(), blocks, D, sums[0].data_ptr(),
                 sums[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd_sum launch failed with CUDA error {err} "
                           f"(blocks={blocks}, D={D})")
    return dx, sums[0], sums[1]


layer_norm_bwd.launches = 0
layer_norm_bwd.launches_by_body = {"registers": 0, "columns": 0}


class LayerNorm(torch.autograd.Function):
    """K5f forward, K5b backward (the sum of its partials included): the
    port of the custom VJP of ``pallas_layernorm.layer_norm``.  Saves ``x``, not
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
        return dx.reshape(ctx.shape), dg[0], db[0], None


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    """LayerNorm over the last axis of ``x`` (any leading shape, float32
    or bfloat16) with f32 ``g``/``b`` ``(D,)``: the port's drop-in for
    ``models/conformer._layernorm``, differentiable in ``x``, ``g`` and
    ``b``.  With no gradient wanted it runs K5f alone and saves nothing."""
    wants_grad = torch.is_grad_enabled() and any(a.requires_grad for a in (x, g, b))
    if not wants_grad:
        shape = x.shape
        return layer_norm_fwd_op(
            x.reshape(-1, shape[-1]).contiguous(), g.contiguous(), b.contiguous(), eps
        ).reshape(shape)
    return LayerNorm.apply(x, g, b, eps)
