"""Chunk-causal ("banded") attention: the Hopper kernels (K2f forward,
K2b-dq and K2b-dkv backward, K3f fused layer), their wrappers, their
plain PyTorch versions and the autograd Functions.

The port of ``ecog2txt_tpu/ops/pallas_attention.py``:

* ``banded_attention_fwd`` is ``_fwd_call`` (K2f): per (batch row, query
  block of QB rows) the scores against the block's own QB keys plus the
  ``L·C`` keys before it, masked with -1e30 (:func:`_band_mask`), a row
  softmax in f32, ``p`` rounded to the stream dtype before ``p·v``; it
  returns the output and the per-head log-sum-exp;
* ``banded_attention_dq`` and ``banded_attention_dkv`` are the two
  kernels of ``_bwd_calls`` (K2b): both recompute ``p`` from ``q·k`` and
  the saved LSE, with ``delta = rowsum(g·out)``; dq runs over query
  blocks, dk/dv over key blocks whose attending query rows are the
  block's own plus the first ``L·C`` rows of the next;
* ``fused_attention_fwd`` is ``_fused_fwd_call`` (K3f): LayerNorm (f32
  statistics, eps 1e-6), the q/k/v projections with rotary as two
  products per projection against ``W`` and the sign-permuted ``W@R``
  (:func:`_split_rot_weights`), then the banded attention of K2f;
  optionally it saves q, k, v and the LSE for the backward.

On a CUDA tensor each wrapper launches its kernel (``csrc/
banded_attention.cu``; for bf16 the tensor-core bodies ``csrc/
banded_attention_tc.cu`` of K2f and ``csrc/banded_attention_bwd_tc.cu``
of K2b; ``csrc/fused_attention.cu``, for bf16 its tensor-core body
``csrc/fused_attention_tc.cu``) or raises; on a CPU
tensor it runs its plain version (``*_reference``), which computes what
the kernel computes at the same rounding points.  ``<wrapper>.launches``
counts the wrapper's calls that launch its kernel, one a call: a call of
K3f's tensor-core body is two CUDA launches (the rows normalised, then the
fused kernel) and counts once.  Tensors are ``(B, T1, D)`` with ``D = H·Dh``
heads on the last axis and ``T1`` a multiple of QB; the LSE and delta
are ``(B, T1, H)`` f32.  :func:`banded_flash_attention` and
:func:`fused_attention_layer` are the differentiable entry points with
the JAX signatures.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ._build import device_smem_optin, load_library

_NEG = -1e30  # finite mask fill: -inf would make (-inf) - (-inf) = NaN
_INT32_MAX = int(np.iinfo(np.int32).max)
_LN_EPS = 1e-6
_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_THREADS = 256  # threads per block of the CUDA-core attention kernels (8 warps)
_FUSED_MAX_HEAD_DIM = 2 * _THREADS  # K3f's projections take 1 or 2 head columns a thread


def _pick_query_rows(C: int, L: int, query_rows: int | None) -> int:
    """Query-block rows: ~128, constrained so the chunk size divides it
    and ``L·C`` divides it (the window of the previous ``L·C`` rows, and
    the next block's first ``L·C`` rows, are whole row groups)."""
    if query_rows is not None:
        if query_rows % C or query_rows % (L * C):
            raise ValueError(
                f"query_rows={query_rows} must be a multiple of "
                f"chunk_size={C} and left_context·chunk_size={L * C}"
            )
        return query_rows
    k = -(-128 // C)  # chunks per block to reach ~128 rows
    k = -(-k // L) * L  # round up so L·C divides QB
    return k * C


def _band_mask(base_q, base_k, nq, nk, C, L, t_real, offset, length):
    """``(..., nq, nk)`` bool mask for query rows ``base_q + i`` against
    key rows ``base_k + j`` (LOCAL row indices into the unpadded
    sequence).  ``base_q``/``base_k`` are ints or integer tensors that
    broadcast against ``(nq, nk)`` (e.g. ``(NB, 1, 1)`` for every block
    at once); ``length`` is an int or a tensor broadcasting in front
    (e.g. ``(B, 1, 1, 1)``).

    The chunk-causal band on chunk ids of local rows (``offset`` is
    chunk-aligned, so local chunk arithmetic equals absolute), keys
    masked outside ``[0, t_real)`` locally, at negative absolute
    positions or at/past the absolute valid ``length``; query rows
    outside ``[0, t_real)`` see nothing."""
    device = base_q.device if torch.is_tensor(base_q) else None
    gq = base_q + torch.arange(nq, device=device)[:, None]
    gk = base_k + torch.arange(nk, device=device)[None, :]
    qc = torch.div(gq, C, rounding_mode="floor")
    kc = torch.div(gk, C, rounding_mode="floor")
    band = (kc <= qc) & (kc + L >= qc)
    ak = gk + offset
    valid_k = (gk >= 0) & (gk < t_real) & (ak >= 0)
    valid_q = (gq >= 0) & (gq < t_real)
    mask = band & valid_k & valid_q
    return mask & (ak < length)


def _rope_freqs(H: int, D: int) -> np.ndarray:
    """Per-lane rotary frequency, as ``models.conformer._rotary``: lane
    ``(h, j)`` uses ``10000^-((j mod half) / half)`` with ``half =
    Dh // 2`` (computed in f64, rounded to f32)."""
    Dh = D // H
    half = Dh // 2
    j = np.arange(D) % Dh
    return (1.0 / (10000.0 ** ((j % half) / half))).astype(np.float32)


def _rot_half(y: torch.Tensor, H: int) -> torch.Tensor:
    """``y @ R`` for the rotary sign permutation R: per head, lane
    ``j < half`` takes ``-y[j + half]`` and lane ``j >= half`` takes
    ``+y[j - half]``."""
    *lead, D = y.shape
    Dh = D // H
    half = Dh // 2
    yh = y.reshape(*lead, H, Dh)
    out = torch.cat([-yh[..., half:], yh[..., :half]], dim=-1)
    return out.reshape(*lead, D)


def _split_rot_weights(wqkv: torch.Tensor, H: int, cd: torch.dtype):
    """``(wq, wq@R, wk, wk@R, wv)`` in the stream dtype ``cd``, each
    ``(D, D)`` and contiguous.  Every ROW of ``W`` is a lane vector, so
    ``W@R`` permutes the output columns as :func:`_rot_half` permutes
    lanes."""
    D = wqkv.shape[0]
    wq, wk, wv = wqkv[:, :D], wqkv[:, D : 2 * D], wqkv[:, 2 * D :]
    return tuple(
        a.to(cd).contiguous()
        for a in (wq, _rot_half(wq, H), wk, _rot_half(wk, H), wv)
    )


def _scale(Dh: int) -> float:
    """``1/sqrt(Dh)`` rounded once to f32, as the Pallas kernels use it."""
    return float(np.float32(1.0 / np.sqrt(Dh)))


def _lengths_or_max(lengths, B: int, device) -> torch.Tensor:
    """``(B,)`` int32 valid lengths on ``device``; None is no limit."""
    if lengths is None:
        return torch.full((B,), _INT32_MAX, dtype=torch.int32, device=device)
    return lengths.to(device=device, dtype=torch.int32).reshape(B).contiguous()


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _k2f_tc_smem(QB: int, W: int, Dh: int) -> int:
    """Shared memory (bytes) of one block of K2f's tensor-core body: Q,
    and K and V of the window, in bf16, rows and head dim padded to 16 and
    rows strided by ``Dhp + 8``; the keys' chunk ids, the window's uniform
    average and a flag (``csrc/banded_attention_tc.cu``)."""
    Dhp, Wp = _r16(Dh), _r16(W)
    return 2 * (_r16(QB) + 2 * Wp) * (Dhp + 8) + 4 * Wp + 4 * Dhp + 16


def plan_k2f_body(dtype: torch.dtype, QB: int, W: int, Dh: int, smem_limit: int) -> str:
    """K2f's body, chosen up front: ``"tensor_core"`` for bf16 streams
    whose block fits ``smem_limit`` bytes of shared memory (every shape the
    conformer paths use), else ``"cuda_core"`` (f32 streams: the tensor
    cores have no f32 product)."""
    if dtype == torch.bfloat16 and _k2f_tc_smem(QB, W, Dh) <= smem_limit:
        return "tensor_core"
    return "cuda_core"


def _k2b_tc_smem(kernel: str, QB: int, W: int, Dh: int) -> int:
    """Shared memory (bytes) of one block of K2b's tensor-core bodies
    (``csrc/banded_attention_bwd_tc.cu``): K2b-dq stages Q and G of the
    block and K and V of its window, in bf16 at K2f's padded row stride,
    and the window keys' chunk ids; K2b-dkv stages K and V of the block and
    Q and G of its attending rows, with their chunk ids, lse and delta."""
    Dhp, QBp, Wp = _r16(Dh), _r16(QB), _r16(W)
    per_row = {"K2b-dq": 4, "K2b-dkv": 12}[kernel]
    return 2 * (2 * QBp + 2 * Wp) * (Dhp + 8) + per_row * Wp


def plan_k2b_body(dtype: torch.dtype, QB: int, W: int, Dh: int, smem_limit: int) -> str:
    """K2b-dq's and K2b-dkv's body, chosen up front: ``"tensor_core"`` for
    bf16 streams whose blocks fit ``smem_limit`` bytes of shared memory,
    else ``"cuda_core"`` (f32 streams: the tensor cores have no f32
    product, and TF32 would break the f32 tolerance)."""
    fits = all(_k2b_tc_smem(k, QB, W, Dh) <= smem_limit for k in ("K2b-dq", "K2b-dkv"))
    return "tensor_core" if dtype == torch.bfloat16 and fits else "cuda_core"


def _banded_blocks_fit(dtype: torch.dtype, QB: int, W: int, Dh: int, smem_limit: int) -> bool:
    """K2f, K2b-dq and K2b-dkv all fit ``smem_limit`` in the bodies that
    run them: the tensor-core bodies for bf16, the CUDA-core ones for f32."""
    if dtype == torch.bfloat16:
        return (_k2f_tc_smem(QB, W, Dh) <= smem_limit
                and plan_k2b_body(dtype, QB, W, Dh, smem_limit) == "tensor_core")
    return all(_cuda_core_smem(k, W, Dh) <= smem_limit for k in ("K2f", "K2b-dq", "K2b-dkv"))


def plan_banded_query_rows(dtype: torch.dtype, QB: int, C: int, L: int, Dh: int,
                           smem_limit: int) -> int:
    """The query block of ``banded_flash_attention`` on the card: the
    largest multiple of ``L·C`` up to ``QB`` at which K2f, K2b-dq and
    K2b-dkv all fit ``smem_limit`` bytes in the bodies that run them
    (bf16: the tensor-core bodies; f32: the CUDA-core bodies, which stage
    the window in f32, so a head dim above ~180 does not fit ~128 rows).
    The forward and the backward take the same block.  Raises
    ``ValueError`` where not even ``L·C`` rows fit."""
    step = L * C
    rows = QB
    while rows > step and not _banded_blocks_fit(dtype, rows, rows + step, Dh, smem_limit):
        rows -= step
    if not _banded_blocks_fit(dtype, rows, rows + step, Dh, smem_limit):
        raise ValueError(
            f"banded attention: no query block fits {smem_limit} bytes of shared memory "
            f"at head dim {Dh}, chunk {C}, left context {L} ({dtype}; not even "
            f"{step} rows)"
        )
    return rows


def _cuda_core_smem(kernel: str, W: int, Dh: int) -> int:
    """Shared memory (bytes) of one block of the CUDA-core bodies of
    ``csrc/banded_attention.cu`` (``fwd_smem``, ``dq_smem``,
    ``dkv_smem``): the window's two staged operands in f32 at row stride
    ``Dh + 1`` and per-warp rows."""
    warps = _THREADS // 32
    staged = 2 * W * (Dh + 1)
    per_warp = {"K2f": Dh + W, "K2b-dq": 2 * Dh + W, "K2b-dkv": 2 * Dh + 2 * W}[kernel]
    return 4 * (staged + (2 * W if kernel == "K2b-dkv" else 0) + warps * per_warp)


def _check_cuda_core_fits(kernel: str, QB: int, W: int, Dh: int, device) -> None:
    """Refuse, naming the shape, a CUDA-core block that does not fit the
    card's shared memory (no number computed, no fallback)."""
    need, limit = _cuda_core_smem(kernel, W, Dh), _smem_limit(device)
    if need > limit:
        raise ValueError(
            f"{kernel}: a block of {QB} query rows (window {W}) at head dim {Dh} needs "
            f"{need} bytes of shared memory in the CUDA-core body, {limit} available"
        )


def _fused_smem(QB: int, W: int, Dh: int, tile: int = 32) -> int:
    """Shared memory (bytes) of one K3f block (``csrc/fused_attention.cu::
    fused_smem``): q, k, v of the window in f32, LayerNorm statistics, the
    streamed LayerNorm tile (the rows a pass takes, at most 192, by
    ``tile`` + 4 columns) and weight tile (``tile`` × Dh), per-warp score
    rows."""
    pass_rows, warps = min(192, W), _THREADS // 32
    return 4 * ((QB + 2 * W) * (Dh + 1) + 2 * W + pass_rows * (tile + 4) + tile * Dh
                + warps * W)


_FUSED_TILES = (32, 16)  # K3f's streamed tile widths, the wider first


def _fused_tile(QB: int, W: int, Dh: int, smem_limit: int) -> int | None:
    """The widest streamed tile with which a K3f block of ``QB`` query rows
    (window ``W``) fits ``smem_limit`` bytes, or None."""
    return next((t for t in _FUSED_TILES if _fused_smem(QB, W, Dh, t) <= smem_limit), None)


def plan_fused_query_rows(QB: int, C: int, L: int, Dh: int, smem_limit: int) -> int:
    """The query block of K3f's CUDA-core body (f32 streams, and bf16 where
    the tensor-core body fits no block): the largest multiple of ``L·C`` up to
    ``QB`` whose block fits ``smem_limit`` bytes with 32-column streamed
    tiles, else with 16-column tiles (the window rows are staged for q, k
    and v: a head dim above ~110 does not fit ~128 rows; at chunk 16, left
    context 1 head dims 454-512 fit 16 rows only with 16-column tiles).
    The query block tiles the work only; each row sees the same keys
    whatever it is.  Raises ``ValueError`` where not even ``L·C`` rows fit,
    or the head dim is above what the kernel's projections take."""
    step = L * C
    if Dh > _FUSED_MAX_HEAD_DIM:
        raise ValueError(
            f"fused attention: head dim {Dh} is above the kernel's {_FUSED_MAX_HEAD_DIM} "
            "(use attention_impl='flash')"
        )
    for tile in _FUSED_TILES:
        rows = QB
        while rows > step and _fused_smem(rows, rows + step, Dh, tile) > smem_limit:
            rows -= step
        if _fused_smem(rows, rows + step, Dh, tile) <= smem_limit:
            return rows
    raise ValueError(
        f"fused attention: no query block fits {smem_limit} bytes of shared memory "
        f"at head dim {Dh}, chunk {C}, left context {L} (one block of {step} rows "
        f"needs {_fused_smem(step, 2 * step, Dh, _FUSED_TILES[-1])}; "
        "use attention_impl='flash')"
    )


def _fused_tc_smem(QB: int, W: int, Dh: int) -> int:
    """Shared memory (bytes) of one block of K3f's tensor-core body
    (``csrc/fused_attention_tc.cu::Layout``), all bf16 but the last three
    terms: the double-buffered tiles of the normalised rows (``XR`` rows,
    the window's and the query rows' padded to 16, by 64 + 8 columns) and
    64-row slices of Wq, Wk and Wv (64 + 8 columns); q (QB rows) and k and v
    (W rows) at row stride ``Dhp + 8``; the keys' chunk ids, the window's
    uniform average and a flag."""
    QBp, Wp, Dhp = _r16(QB), _r16(W), _r16(Dh)
    XR = _r16(W - QB + QBp)
    return 2 * (2 * XR * 72 + 6 * 64 * 72 + (QBp + 2 * Wp) * (Dhp + 8)) + 4 * (Wp + Dhp) + 16


def plan_k3f_body(dtype: torch.dtype, QB: int, W: int, Dh: int, smem_limit: int) -> str:
    """K3f's body, chosen up front: ``"tensor_core"`` for bf16 streams whose
    block fits ``smem_limit`` bytes of shared memory (head dims up to
    512), else ``"cuda_core"`` (f32 streams: the tensor cores have no f32
    product, and TF32 would break the f32 tolerance)."""
    if (dtype == torch.bfloat16 and Dh <= _FUSED_MAX_HEAD_DIM
            and _fused_tc_smem(QB, W, Dh) <= smem_limit):
        return "tensor_core"
    return "cuda_core"


# the query block K3f's tensor-core body takes where its default block's grid
# leaves SMs idle (a B=1 request: 6 blocks of 128 rows on 132 SMs)
_K3F_SMALL_GRID_ROWS = 32


def plan_fused_layer(dtype: torch.dtype, B: int, T: int, H: int, QB: int, C: int, L: int,
                     Dh: int, smem_limit: int, sms: int) -> tuple[int, str]:
    """K3f's query block and body on the card, ``(rows, body)``, before any
    launch.  bf16: the largest multiple of ``L·C`` up to ``QB`` whose
    tensor-core block fits ``smem_limit`` bytes; where that block's grid
    (``ceil(T / rows)·H·B`` blocks) has fewer blocks than the card's ``sms``,
    the multiple of ``L·C`` from ``_K3F_SMALL_GRID_ROWS`` rows, so that more
    blocks run.  Where not even ``L·C`` rows fit the tensor-core body, and
    for f32, the CUDA-core body at :func:`plan_fused_query_rows`'s block.
    The query block tiles the work only; each row sees the same keys
    whatever it is.  Raises ``ValueError`` where no block fits."""
    step = L * C
    if dtype == torch.bfloat16 and Dh <= _FUSED_MAX_HEAD_DIM:
        rows = QB
        while rows > step and _fused_tc_smem(rows, rows + step, Dh) > smem_limit:
            rows -= step
        if _fused_tc_smem(rows, rows + step, Dh) <= smem_limit:
            small = -(-_K3F_SMALL_GRID_ROWS // step) * step
            if small < rows and -(-T // rows) * H * B < sms:
                rows = small
            return rows, "tensor_core"
    return plan_fused_query_rows(QB, C, L, Dh, smem_limit), "cuda_core"


def _device_index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def _smem_limit(device) -> int:
    return device_smem_optin(_device_index(device))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(_device_index(device)).multi_processor_count


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _windows(a: torch.Tensor, size: int, step: int, front: int, back: int):
    """``(B, T1, X)`` → ``(B, NB, size, X)``: rows ``[n·step - front,
    n·step - front + size)`` of ``a`` zero-padded by ``front`` rows
    before and ``back`` rows after."""
    ap = F.pad(a, (0, 0, front, back))
    return ap.unfold(1, size, step).permute(0, 1, 3, 2)


def _block_masks(B, T1, QB, PREV, C, L, t_real, offset, lengths, dkv):
    """``(B, NB, 1, rows, cols)`` band masks of every block: query block
    against its key window (``dkv=False``), or query window against its
    key block (``dkv=True``)."""
    NB = T1 // QB
    W = QB + PREV
    base = (torch.arange(NB, device=lengths.device) * QB)[:, None, None]
    length = lengths.reshape(B, 1, 1, 1)
    if dkv:
        mask = _band_mask(base, base, W, QB, C, L, t_real, offset, length)
    else:
        mask = _band_mask(base, base - PREV, QB, W, C, L, t_real, offset, length)
    return mask[:, :, None]


def banded_attention_fwd_reference(
    q, k, v, offset, lengths, C, L, t_real, QB, H
):
    """Plain version of K2f: ``(out (B, T1, D) stream dtype, lse (B, T1,
    H) f32)``.  Scores ``f32(q·k) * scale`` with exact products of the
    stream-dtype operands, masked with -1e30; row softmax in f32; ``p``
    rounded to the stream dtype; ``p·v`` in f32, rounded."""
    B, T1, D = q.shape
    Dh = D // H
    PREV = L * C
    NB = T1 // QB
    W = QB + PREV
    qb = q.reshape(B, NB, QB, H, Dh).float()
    kw = _windows(k, W, QB, PREV, 0).reshape(B, NB, W, H, Dh).float()
    vw = _windows(v, W, QB, PREV, 0).reshape(B, NB, W, H, Dh).float()
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kw) * _scale(Dh)
    mask = _block_masks(B, T1, QB, PREV, C, L, t_real, offset, lengths, False)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom))[..., 0]  # (B, NB, H, QB)
    p = (e / denom).to(q.dtype).float()
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vw).to(q.dtype)
    return (
        out.reshape(B, T1, D),
        lse.permute(0, 1, 3, 2).reshape(B, T1, H).contiguous(),
    )


def banded_attention_dq_reference(
    q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H
):
    """Plain version of K2b-dq: ``dq (B, T1, D)`` in the stream dtype.
    ``p = exp(s - lse)`` where the band admits the key, else 0; ``ds =
    S(p·(g·vᵀ − delta))``; ``dq = S(f32(ds·k) * scale)``."""
    B, T1, D = q.shape
    Dh = D // H
    PREV = L * C
    NB = T1 // QB
    W = QB + PREV
    blocks = lambda a, n: a.reshape(B, NB, QB, n, -1).float()  # noqa: E731
    qb, gb = blocks(q, H), blocks(g, H)
    kw = _windows(k, W, QB, PREV, 0).reshape(B, NB, W, H, Dh).float()
    vw = _windows(v, W, QB, PREV, 0).reshape(B, NB, W, H, Dh).float()
    per_row = lambda a: a.reshape(B, NB, QB, H).permute(0, 1, 3, 2)[..., None]  # noqa: E731
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kw) * _scale(Dh)
    mask = _block_masks(B, T1, QB, PREV, C, L, t_real, offset, lengths, False)
    p = torch.where(mask, torch.exp(s - per_row(lse)), 0.0)
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", gb, vw)
    ds = (p * (dp - per_row(delta))).to(q.dtype).float()
    dq = torch.einsum("bnhqk,bnkhd->bnqhd", ds, kw) * _scale(Dh)
    return dq.to(q.dtype).reshape(B, T1, D)


def banded_attention_dkv_reference(
    q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H
):
    """Plain version of K2b-dkv: ``(dk, dv)`` each ``(B, T1, D)`` in the
    stream dtype.  Key block n is attended by query rows ``[n·QB, n·QB +
    QB + L·C)``; rows past ``T1`` are masked, never read.  ``dv =
    S(f32(S(p)ᵀ·g))``, ``dk = S(f32(dsᵀ·q) * scale)``."""
    B, T1, D = q.shape
    Dh = D // H
    PREV = L * C
    NB = T1 // QB
    Wq = QB + PREV
    qw = _windows(q, Wq, QB, 0, PREV).reshape(B, NB, Wq, H, Dh).float()
    gw = _windows(g, Wq, QB, 0, PREV).reshape(B, NB, Wq, H, Dh).float()
    lsew = _windows(lse, Wq, QB, 0, PREV).permute(0, 1, 3, 2)[..., None]
    deltaw = _windows(delta, Wq, QB, 0, PREV).permute(0, 1, 3, 2)[..., None]
    kb = k.reshape(B, NB, QB, H, Dh).float()
    vb = v.reshape(B, NB, QB, H, Dh).float()
    s = torch.einsum("bnihd,bnjhd->bnhij", qw, kb) * _scale(Dh)
    mask = _block_masks(B, T1, QB, PREV, C, L, t_real, offset, lengths, True)
    p = torch.where(mask, torch.exp(s - lsew), 0.0)
    p_c = p.to(q.dtype).float()
    dv = torch.einsum("bnhij,bnihd->bnjhd", p_c, gw)
    dp = torch.einsum("bnihd,bnjhd->bnhij", gw, vb)
    ds = (p * (dp - deltaw)).to(q.dtype).float()
    dk = torch.einsum("bnhij,bnihd->bnjhd", ds, qw) * _scale(Dh)
    return (
        dk.to(q.dtype).reshape(B, T1, D),
        dv.to(q.dtype).reshape(B, T1, D),
    )


def _layernorm_f32(x):
    """``(xhat, inv)``: f32 statistics of the rows of ``x``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + _LN_EPS)
    return (xf - mu) * inv, inv


@functools.lru_cache(maxsize=None)
def _rope_freq_tensor(H: int, D: int, device: torch.device) -> torch.Tensor:
    """:func:`_rope_freqs` as a ``(D,)`` f32 tensor on ``device``, made
    once per (H, D, device) (read-only)."""
    return torch.from_numpy(_rope_freqs(H, D)).to(device)


def _rope_tables(T1: int, offset: int, H: int, D: int, cd, device):
    """``(cos, sin)`` of the rotary angle ``(row + offset) · freq`` per
    (row, lane), the angle in f32, the tables rounded to ``cd``."""
    pos = (torch.arange(T1, device=device) + offset).float()
    freq = _rope_freq_tensor(H, D, torch.device(device))
    ang = pos[:, None] * freq[None, :]
    return torch.cos(ang).to(cd), torch.sin(ang).to(cd)


def fused_attention_fwd_reference(
    x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H, save
):
    """Plain version of K3f: ``(out,)`` or, with ``save``, ``(out, q, k,
    v, lse)``.  ``x`` is the PRE-LayerNorm input ``(B, T1, D)`` in the
    stream dtype S; ``xw = (wq, wq@R, wk, wk@R, wv)`` in S.  LayerNorm
    with f32 statistics → S; each projection ``S(f32(lnx·W))``; rotary
    ``q = S(q·cos) + S(qr·sin)`` in S; then :func:`
    banded_attention_fwd_reference`."""
    cd = x.dtype
    B, T1, D = x.shape
    xhat, _ = _layernorm_f32(x)
    lnx = (xhat * lng.float() + lnb.float()).to(cd)
    cs, sn = _rope_tables(T1, offset, H, D, cd, x.device)
    mm = lambda w: (lnx.float() @ w.float()).to(cd)  # noqa: E731
    wq, wqr, wk, wkr, wv = xw
    q = mm(wq) * cs + mm(wqr) * sn
    k = mm(wk) * cs + mm(wkr) * sn
    v = mm(wv)
    out, lse = banded_attention_fwd_reference(
        q, k, v, offset, lengths, C, L, t_real, QB, H
    )
    return (out, q, k, v, lse) if save else (out,)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check(name, tensors, H, QB, C, L, t_real, lengths):
    """Shapes, dtypes, devices and contiguity the kernels take."""
    ref = tensors[0]
    if ref.dim() != 3:
        raise ValueError(f"{name}: inputs must be (B, T1, D); got {tuple(ref.shape)}")
    B, T1, D = ref.shape
    if ref.dtype not in _STREAM_DTYPES:
        raise TypeError(f"{name}: stream dtype must be float32 or bfloat16; got {ref.dtype}")
    if D % H:
        raise ValueError(f"{name}: D={D} must be a multiple of H={H}")
    if QB % C or QB % (L * C) or T1 % QB or not 0 < t_real <= T1:
        raise ValueError(
            f"{name}: T1={T1} must be a multiple of QB={QB}, itself a multiple "
            f"of C={C} and L·C={L * C}, with 0 < t_real={t_real} <= T1"
        )
    for a in tensors:
        if tuple(a.shape) != (B, T1, D) or a.dtype != ref.dtype:
            raise ValueError(
                f"{name}: every sequence input must be ({B}, {T1}, {D}) "
                f"{ref.dtype}; got {tuple(a.shape)} {a.dtype}"
            )
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be ({B},) int32")
    for a in (*tensors, lengths):
        if a.device != ref.device or not a.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {ref.device}")


def _check_rows(name, B, T1, H, tensors):
    for a in tensors:
        if tuple(a.shape) != (B, T1, H) or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous ({B}, {T1}, {H}) f32")


def _call(lib_name, fn_name, n_ptrs, n_ints, ptrs, ints, floats, device, what):
    """One launch through the C interface: ``n_ptrs`` pointers, then
    ``n_ints`` ints, then the floats, then the stream; raises on a CUDA
    error code."""
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * len(floats) + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, *ints, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {err} ({what})")


def _ptr(a):
    return None if a is None else a.data_ptr()


def _launch_k2f(body, q, k, v, offset, lengths, C, L, t_real, QB, H):
    """One K2f launch of ``body`` ("tensor_core": bf16 only, or
    "cuda_core"); checked inputs, no count."""
    B, T1, D = q.shape
    Dh = D // H
    out = torch.empty_like(q)
    lse = torch.empty((B, T1, H), dtype=torch.float32, device=q.device)
    what = f"B={B} T1={T1} D={D} H={H} QB={QB} {q.dtype} {body} body"
    ptrs = [_ptr(a) for a in (q, k, v, lengths, out, lse)]
    if body == "tensor_core":
        _call("banded_attention_tc", "banded_attention_fwd_tc", 6, 9, ptrs,
              [B, T1, H, Dh, C, L, t_real, QB, offset], [_scale(Dh)], q.device, what)
    else:
        _call("banded_attention", "banded_attention_fwd", 6, 10, ptrs,
              [B, T1, H, Dh, C, L, t_real, QB, offset, int(q.dtype == torch.bfloat16)],
              [_scale(Dh)], q.device, what)
    return out, lse


def banded_attention_fwd(q, k, v, offset, lengths, C, L, t_real, QB, H):
    """``(out, lse)`` of the chunk-causal attention (K2f) — see
    :func:`banded_attention_fwd_reference` for the semantics.  ``offset``
    is a chunk-aligned int, ``lengths`` ``(B,)`` int32 absolute valid
    lengths (INT32_MAX for no limit).

    On a CUDA tensor this launches the Hopper kernel (and raises if it
    cannot be built or launched): the tensor-core body
    (``csrc/banded_attention_tc.cu``) for bf16, the CUDA-core body
    (``csrc/banded_attention.cu``) for f32, as :func:`plan_k2f_body`
    picks; ``banded_attention_fwd.launches_by_body`` counts each.  On a
    CPU tensor it runs the plain version."""
    offset = int(offset)
    _check("banded_attention_fwd", (q, k, v), H, QB, C, L, t_real, lengths)
    if q.device.type == "cpu":
        return banded_attention_fwd_reference(
            q, k, v, offset, lengths, C, L, t_real, QB, H
        )
    body = plan_k2f_body(q.dtype, QB, QB + L * C, q.shape[2] // H, _smem_limit(q.device))
    if body == "cuda_core":
        _check_cuda_core_fits("K2f", QB, QB + L * C, q.shape[2] // H, q.device)
    out, lse = _launch_k2f(body, q, k, v, offset, lengths, C, L, t_real, QB, H)
    banded_attention_fwd.launches += 1
    banded_attention_fwd.launches_by_body[body] += 1
    return out, lse


banded_attention_fwd.launches = 0
banded_attention_fwd.launches_by_body = {"tensor_core": 0, "cuda_core": 0}


# The no-gradient forwards of K2f and K3f as operators of their own, so
# that ``torch.export`` records each as one node of the graph: running the
# node calls the wrapper, which launches and counts the kernel (or runs the
# plain version on the CPU).
@torch.library.custom_op(
    "ecog2txt_tpu_torch::banded_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int offset, Tensor lengths, int C, int L, "
           "int t_real, int QB, int H) -> Tensor",
)
def banded_attention_fwd_op(q, k, v, offset, lengths, C, L, t_real, QB, H):
    """``out`` of :func:`banded_attention_fwd` (K2f)."""
    out, _ = banded_attention_fwd(q, k, v, offset, lengths, C, L, t_real, QB, H)
    return out


@banded_attention_fwd_op.register_fake
def _(q, k, v, offset, lengths, C, L, t_real, QB, H):
    return torch.empty_like(q)


def _launch_k2b(kernel, body, q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H):
    """One K2b-dq (``kernel="dq"``) or K2b-dkv (``"dkv"``) launch of
    ``body`` ("tensor_core": bf16 only, or "cuda_core"); checked inputs, no
    count.  Returns ``dq`` or ``(dk, dv)``."""
    B, T1, D = q.shape
    Dh = D // H
    outs = [torch.empty_like(q)] if kernel == "dq" else [torch.empty_like(k), torch.empty_like(v)]
    ptrs = [_ptr(a) for a in (q, k, v, g, lse, delta, lengths, *outs)]
    ints = [B, T1, H, Dh, C, L, t_real, QB, offset]
    what = f"B={B} T1={T1} D={D} H={H} QB={QB} {q.dtype} {body} body"
    if body == "tensor_core":
        _call("banded_attention_bwd_tc", f"banded_attention_{kernel}_tc", len(ptrs), 9, ptrs,
              ints, [_scale(Dh)], q.device, what)
    else:
        _call("banded_attention", f"banded_attention_{kernel}", len(ptrs), 10, ptrs,
              [*ints, int(q.dtype == torch.bfloat16)], [_scale(Dh)], q.device, what)
    return outs[0] if kernel == "dq" else tuple(outs)


def _k2b(kernel, wrapper, q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H):
    """The body of both K2b wrappers: checks, then the plain version on a
    CPU tensor, else one launch of the body :func:`plan_k2b_body` picks."""
    offset = int(offset)
    name = f"banded_attention_{kernel}"
    _check(name, (q, k, v, g), H, QB, C, L, t_real, lengths)
    B, T1, D = q.shape
    _check_rows(name, B, T1, H, (lse, delta))
    args = (q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H)
    if q.device.type == "cpu":
        plain = banded_attention_dq_reference if kernel == "dq" else banded_attention_dkv_reference
        return plain(*args)
    W, Dh = QB + L * C, D // H
    body = plan_k2b_body(q.dtype, QB, W, Dh, _smem_limit(q.device))
    if body == "cuda_core":
        _check_cuda_core_fits(f"K2b-{kernel}", QB, W, Dh, q.device)
    out = _launch_k2b(kernel, body, *args)
    wrapper.launches += 1
    wrapper.launches_by_body[body] += 1
    return out


def banded_attention_dq(q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H):
    """``dq`` of the chunk-causal attention (K2b-dq) — see
    :func:`banded_attention_dq_reference`.  On a CUDA tensor this launches
    the Hopper kernel (or raises): the tensor-core body
    (``csrc/banded_attention_bwd_tc.cu``) for bf16, the CUDA-core body
    (``csrc/banded_attention.cu``) for f32, as :func:`plan_k2b_body` picks;
    ``banded_attention_dq.launches_by_body`` counts each.  On a CPU tensor
    it runs the plain version."""
    return _k2b("dq", banded_attention_dq, q, k, v, g, lse, delta, offset, lengths, C, L,
                t_real, QB, H)


banded_attention_dq.launches = 0
banded_attention_dq.launches_by_body = {"tensor_core": 0, "cuda_core": 0}


def banded_attention_dkv(q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H):
    """``(dk, dv)`` of the chunk-causal attention (K2b-dkv) — see
    :func:`banded_attention_dkv_reference`.  Bodies, counts and the CPU
    path as :func:`banded_attention_dq`."""
    return _k2b("dkv", banded_attention_dkv, q, k, v, g, lse, delta, offset, lengths, C, L,
                t_real, QB, H)


banded_attention_dkv.launches = 0
banded_attention_dkv.launches_by_body = {"tensor_core": 0, "cuda_core": 0}


def _launch_k3f(body, x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H, save):
    """One K3f launch of ``body`` ("tensor_core": bf16 only, reading wq, wk
    and wv of ``xw`` alone, or "cuda_core"); checked inputs, no count."""
    B, T1, D = x.shape
    Dh = D // H
    freq = _rope_freq_tensor(H, D, x.device)
    out = torch.empty_like(x)
    if save:
        qs, ks, vs = (torch.empty_like(x) for _ in range(3))
        lse = torch.empty((B, T1, H), dtype=torch.float32, device=x.device)
    else:
        qs = ks = vs = lse = None
    ints = [B, T1, H, Dh, C, L, t_real, QB, offset]
    what = f"B={B} T1={T1} D={D} H={H} QB={QB} {x.dtype} save={save} {body} body"
    if body == "tensor_core":
        # the first launch's normalised rows and rotary table
        lnx = torch.empty_like(x)
        rot = torch.empty((T1 + L * C, D, 2), dtype=torch.bfloat16, device=x.device)
        _call("fused_attention_tc", "fused_attention_fwd_tc", 15, 10,
              [_ptr(a) for a in (x, xw[0], xw[2], xw[4], lng, lnb, freq, lengths, out, qs, ks,
                                 vs, lse, lnx, rot)],
              [*ints, int(save)], [_scale(Dh), _LN_EPS], x.device, what)
    else:
        limit = _smem_limit(x.device)
        tile = _fused_tile(QB, QB + L * C, Dh, limit)
        if Dh > _FUSED_MAX_HEAD_DIM or tile is None:
            raise ValueError(
                f"fused_attention_fwd: a query block of {QB} rows at head dim {Dh} does not "
                f"fit the CUDA-core body ({_fused_smem(QB, QB + L * C, Dh, _FUSED_TILES[-1])} "
                f"bytes of shared memory, {limit} available; head dims up to "
                f"{_FUSED_MAX_HEAD_DIM}); fused_attention_layer picks a query block that fits"
            )
        _call("fused_attention", "fused_attention_fwd", 15, 12,
              [_ptr(a) for a in (x, *xw, lng, lnb, freq, lengths, out, qs, ks, vs, lse)],
              [*ints, int(x.dtype == torch.bfloat16), int(save), tile],
              [_scale(Dh), _LN_EPS], x.device, f"{what} tile={tile}")
    return (out, qs, ks, vs, lse) if save else (out,)


def fused_attention_fwd(x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H, save):
    """``(out,)`` or, with ``save``, ``(out, q, k, v, lse)`` of the fused
    attention layer (K3f) — see :func:`fused_attention_fwd_reference`.
    ``xw = (wq, wq@R, wk, wk@R, wv)`` in the stream dtype (each ``(D,
    D)``, contiguous), ``lng``/``lnb`` ``(D,)`` f32.

    On a CUDA tensor this launches the Hopper kernel (and raises if it
    cannot be built or launched): the tensor-core body
    (``csrc/fused_attention_tc.cu``) for bf16, the CUDA-core body
    (``csrc/fused_attention.cu``) for f32, as :func:`plan_k3f_body` picks;
    ``fused_attention_fwd.launches_by_body`` counts each.  The tensor-core
    body reads wq, wk and wv alone and forms the rotary's ``W@R`` products
    from them (a signed column permutation, exact after rounding), so
    ``xw[1]`` and ``xw[3]`` must be what :func:`_split_rot_weights` makes
    of them, as on every path of the port.  On a CPU tensor it runs the
    plain version."""
    offset = int(offset)
    _check("fused_attention_fwd", (x,), H, QB, C, L, t_real, lengths)
    B, T1, D = x.shape
    for w in xw:
        if tuple(w.shape) != (D, D) or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(
                f"fused_attention_fwd: weights must be contiguous ({D}, {D}) {x.dtype}"
            )
    for a in (lng, lnb):
        if tuple(a.shape) != (D,) or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"fused_attention_fwd: ln_g / ln_b must be contiguous ({D},) f32")
    if any(a.device != x.device for a in (*xw, lng, lnb)):
        raise ValueError("fused_attention_fwd: inputs must share one device")
    Dh = D // H
    if Dh % 2:
        raise ValueError(f"fused_attention_fwd: head dim {Dh} must be even (rotary)")
    if x.device.type == "cpu":
        return fused_attention_fwd_reference(
            x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H, save
        )
    body = plan_k3f_body(x.dtype, QB, QB + L * C, Dh, _smem_limit(x.device))
    outs = _launch_k3f(body, x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H, save)
    fused_attention_fwd.launches += 1
    fused_attention_fwd.launches_by_body[body] += 1
    return outs


fused_attention_fwd.launches = 0
fused_attention_fwd.launches_by_body = {"tensor_core": 0, "cuda_core": 0}


@torch.library.custom_op(
    "ecog2txt_tpu_torch::fused_attention_fwd", mutates_args=(),
    schema="(Tensor x, Tensor[] xw, Tensor lng, Tensor lnb, int offset, Tensor lengths, "
           "int C, int L, int t_real, int QB, int H) -> Tensor",
)
def fused_attention_fwd_op(x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H):
    """``out`` of :func:`fused_attention_fwd` (K3f) without saving q, k,
    v or the LSE (see :func:`banded_attention_fwd_op`)."""
    (out,) = fused_attention_fwd(
        x, tuple(xw), lng, lnb, offset, lengths, C, L, t_real, QB, H, save=False
    )
    return out


@fused_attention_fwd_op.register_fake
def _(x, xw, lng, lnb, offset, lengths, C, L, t_real, QB, H):
    return torch.empty_like(x)


# --------------------------------------------------------------------------
# the differentiable entry points
# --------------------------------------------------------------------------


def _delta(g: torch.Tensor, out: torch.Tensor, H: int) -> torch.Tensor:
    """Per-row, per-head ``rowsum(g · out)`` in f32: ``(B, T1, H)``."""
    B, T1, D = out.shape
    return (g.float() * out.float()).reshape(B, T1, H, D // H).sum(dim=-1)


class BandedAttention(torch.autograd.Function):
    """K2f forward, K2b-dq and K2b-dkv backward: the port of the custom
    VJP ``_banded_attention_core``.  q, k, v are ``(B, T1, D)`` in one
    stream dtype; the other arguments get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, offset, C, L, t_real, QB, H):
        out, lse = banded_attention_fwd(q, k, v, offset, lengths, C, L, t_real, QB, H)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.static = (offset, C, L, t_real, QB, H)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        offset, C, L, t_real, QB, H = ctx.static
        g = g.to(q.dtype).contiguous()
        delta = _delta(g, out, H)
        args = (q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H)
        dq = banded_attention_dq(*args)
        dk, dv = banded_attention_dkv(*args)
        return dq, dk, dv, None, None, None, None, None, None, None


def banded_flash_attention(
    q: torch.Tensor,  # (B, T, H, Dh) post-rotary queries
    k: torch.Tensor,
    v: torch.Tensor,
    offset: int = 0,  # absolute position of step 0 (chunk-aligned)
    lengths: torch.Tensor | None = None,  # (B,) absolute valid-step counts
    *,
    chunk_size: int,
    left_context: int,
    query_rows: int | None = None,
) -> torch.Tensor:
    """Chunk-causal attention ``softmax(q·kᵀ/√d + band mask)·v`` per
    ~128-row query block.  Returns ``(B, T, H, Dh)``; differentiable in
    q, k and v (forward K2f, backward K2b).  The three are promoted to
    one dtype and padded to a multiple of the query block.  With no
    gradient wanted it runs K2f alone and saves nothing.

    On the card the default query block shrinks where a wide head's block
    would not fit shared memory (:func:`plan_banded_query_rows`; forward
    and backward take the same block).  The band does not depend on the
    block: every row sees the same keys whatever it is.  Only the padding
    rows with no valid key get the uniform average of their block's
    window, which does depend on it; those rows are compared for
    finiteness alone, and the backward gives them no gradient.  An
    explicit ``query_rows`` stays as given."""
    B, T, H, Dh = q.shape
    D = H * Dh
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    C, L = chunk_size, left_context
    QB = _pick_query_rows(C, L, query_rows)
    if q.is_cuda and query_rows is None:
        QB = plan_banded_query_rows(ct, QB, C, L, Dh, _smem_limit(q.device))
    T1 = -(-T // QB) * QB

    def flat(a):
        return F.pad(a.to(ct).reshape(B, T, D), (0, 0, 0, T1 - T)).contiguous()

    q3, k3, v3 = flat(q), flat(k), flat(v)
    lens = _lengths_or_max(lengths, B, q.device)
    args = (int(offset), C, L, T, QB, H)
    wants_grad = torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v))
    if wants_grad:
        out = BandedAttention.apply(q3, k3, v3, lens, *args)
    else:
        out = banded_attention_fwd_op(q3, k3, v3, int(offset), lens, C, L, T, QB, H)
    return out[:, :T].reshape(B, T, H, Dh)


class FusedAttentionLayer(torch.autograd.Function):
    """K3f forward (saving q, k, v and the LSE), K2b-dq and K2b-dkv then
    plain products backward: the port of the custom VJP
    ``_fused_layer_core``.  ``wqkv`` (D, 3D), ``ln_g`` and ``ln_b`` arrive
    in their parameter dtype (f32) and are cast to the stream dtype of
    ``x`` inside, so their gradients reach the parameters in f32."""

    @staticmethod
    def forward(ctx, wqkv, lng, lnb, x, lengths, offset, C, L, t_real, QB, H):
        xw = _split_rot_weights(wqkv, H, x.dtype)
        g32, b32 = lng.float().contiguous(), lnb.float().contiguous()
        out, q, k, v, lse = fused_attention_fwd(
            x, xw, g32, b32, offset, lengths, C, L, t_real, QB, H, save=True
        )
        ctx.save_for_backward(wqkv, lng, lnb, x, lengths, out, q, k, v, lse)
        ctx.static = (offset, C, L, t_real, QB, H)
        return out

    @staticmethod
    def backward(ctx, g):
        wqkv, lng, lnb, x, lengths, out, q, k, v, lse = ctx.saved_tensors
        offset, C, L, t_real, QB, H = ctx.static
        B, T1, D = x.shape
        cd = x.dtype
        g = g.to(cd).contiguous()
        delta = _delta(g, out, H)
        args = (q, k, v, g, lse, delta, offset, lengths, C, L, t_real, QB, H)
        dq = banded_attention_dq(*args)
        dk, dv = banded_attention_dkv(*args)
        # un-rotary: q = q_pre·cs + (q_pre@R)·sn, so
        # dq_pre = dq·cs + (dq·sn)@Rᵀ = dq·cs − rot_half(dq·sn)
        cs, sn = _rope_tables(T1, offset, H, D, cd, x.device)
        dq_pre = dq * cs - _rot_half(dq * sn, H)
        dk_pre = dk * cs - _rot_half(dk * sn, H)
        dqkv = torch.cat([dq_pre, dk_pre, dv], dim=-1).float()  # (B, T1, 3D)
        # projection backward against the recomputed LayerNorm output:
        # stream-dtype operands, f32 products and sums
        xhat, inv = _layernorm_f32(x)
        lnx = (xhat * lng.float() + lnb.float()).to(cd)
        dwqkv = lnx.reshape(-1, D).float().T @ dqkv.reshape(-1, 3 * D)
        dlnx = dqkv @ wqkv.to(cd).float().T  # (B, T1, D) f32
        # LayerNorm backward, statistics in f32
        dxhat = dlnx * lng.float()
        dg = (dlnx * xhat).sum(dim=(0, 1))
        db = dlnx.sum(dim=(0, 1))
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = ((dxhat - m1 - xhat * m2) * inv).to(cd)
        return (
            dwqkv.to(wqkv.dtype), dg.to(lng.dtype), db.to(lnb.dtype), dx,
            None, None, None, None, None, None, None,
        )


def fused_attention_layer(
    wqkv: torch.Tensor,  # (D, 3D) parameter dtype, cast inside
    ln_g: torch.Tensor,  # (D,)
    ln_b: torch.Tensor,  # (D,)
    x: torch.Tensor,  # (B, T, D) stream dtype, PRE-LayerNorm input
    offset: int = 0,
    lengths: torch.Tensor | None = None,
    *,
    chunk_size: int,
    left_context: int,
    num_heads: int,
    query_rows: int | None = None,
) -> torch.Tensor:
    """LN → qkv → rotary → banded attention, one kernel (K3f).  Returns
    the attention result before the output projection, ``(B, T, D)``;
    apply ``wo`` and the residual outside.  Differentiable in ``wqkv``,
    ``ln_g``, ``ln_b`` and ``x``.  With no gradient wanted it runs K3f
    without saving q, k, v or the LSE.  On the card the default query
    block and the body are planned by :func:`plan_fused_layer` (a smaller
    block where a wide head's would not fit, or where the grid would leave
    SMs idle)."""
    B, T, D = x.shape
    C, L, H = chunk_size, left_context, num_heads
    QB = _pick_query_rows(C, L, query_rows)
    if x.is_cuda and query_rows is None:
        QB, _ = plan_fused_layer(x.dtype, B, T, H, QB, C, L, D // H, _smem_limit(x.device),
                                 _sm_count(x.device))
    T1 = -(-T // QB) * QB
    x1 = F.pad(x, (0, 0, 0, T1 - T)).contiguous()
    lens = _lengths_or_max(lengths, B, x.device)
    wants_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (wqkv, ln_g, ln_b, x)
    )
    if wants_grad:
        out = FusedAttentionLayer.apply(
            wqkv, ln_g, ln_b, x1, lens, int(offset), C, L, T, QB, H
        )
    else:
        xw = _split_rot_weights(wqkv, H, x.dtype)
        out = fused_attention_fwd_op(
            x1, list(xw), ln_g.float().contiguous(), ln_b.float().contiguous(),
            int(offset), lens, C, L, T, QB, H,
        )
    return out[:, :T]
