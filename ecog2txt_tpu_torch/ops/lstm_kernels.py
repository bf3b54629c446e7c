"""LSTM recurrence: the Hopper kernels (forward K1f, adjoint K1b; both
biLSTM directions in one launch, K4f and K4b), their wrappers, their
plain PyTorch versions and the autograd Functions.

``lstm_recurrence`` is the port of ``ecog2txt_tpu/ops/pallas_lstm.py::
_fwd_call`` and ``lstm_recurrence_bwd`` of ``_bwd_call``.  On a CUDA
tensor each launches its kernel (``csrc/lstm_recurrence.cu``: at bf16
where a cluster holds ``wh`` the cluster body of
``csrc/lstm_fwd_cluster.cuh``, else the rows body, as
:func:`plan_fwd_body` picks; for the adjoint ``csrc/lstm_bwd_cluster.cu``
at bf16 where a cluster holds ``wh``, else ``csrc/lstm_recurrence_bwd.cu``,
as :func:`plan_bwd_body` picks; one launch for the whole sequence) or
raises; on a CPU tensor each runs its plain version
(:func:`lstm_recurrence_reference`, :func:`lstm_recurrence_bwd_reference`),
a step loop with the same rounding points.  ``<wrapper>.launches`` counts
kernel launches.  :func:`fused_lstm_recurrence` is the differentiable
recurrence (the JAX package's custom VJP of the same name): forward K1f,
backward K1b plus one GEMM for the recurrent weight's gradient.

``bilstm_grid_fwd`` is the port of ``_bi_grid_fwd_call`` and
``bilstm_grid_bwd`` of ``_bi_grid_bwd_call`` (``csrc/bilstm_grid.cu``:
one launch whose grid has a direction axis, so the forward and the
reverse-time chain of a layer run at once on separate SMs; K4f's and
K4b's bf16 bodies are K1f's and K1b's cluster bodies with that direction
axis, picked by :func:`plan_fwd_body` and :func:`plan_bwd_body` as for
K1f and K1b); :func:`fused_bilstm_grid` is the
differentiable layer recurrence, the JAX package's function of the same
name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import device_smem_optin, load_library

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_ROWS_PER_BLOCK = (1, 2, 4, 8)
_MAX_KERNEL_H = 1024  # the kernels' per-unit threading: one thread a hidden unit, 1024 a block


def _check_kernel_width(name: str, H: int) -> None:
    """Refuse, before any launch, a width the LSTM kernels do not take
    (the plain version on a CPU tensor takes any, as JAX does)."""
    if H > _MAX_KERNEL_H:
        raise ValueError(
            f"{name}: hidden width H={H} is above the CUDA kernels' limit "
            f"H <= {_MAX_KERNEL_H} (one thread a hidden unit)"
        )


def lstm_recurrence_reference(
    xw: torch.Tensor,  # (T, B, 4H) stream dtype
    wh: torch.Tensor,  # (H, 4H) stream dtype
    lengths: torch.Tensor,  # (B,) int32
    h0: torch.Tensor,  # (B, H) f32
    c0: torch.Tensor,  # (B, H) f32
    mask: torch.Tensor,  # (B, H) f32
    reverse_time: bool = False,
    return_c_seq: bool = False,
):
    """Plain PyTorch version of the kernel: ``(h_seq, c_seq, hT, cT)``.

    ``gates = f32(xw[t]) + S(h * mask) @ S(wh)`` with f32 products and
    accumulation (S = the stream dtype of ``xw``); cell packed
    (i, g, f, o) with +1 on the forget gate; for ``t >= length`` the
    carry freezes and ``h_seq[t]`` is 0.  ``h_seq``/``c_seq`` come back
    in the stream dtype, ``hT``/``cT`` in f32; ``c_seq`` is None unless
    ``return_c_seq``.  ``reverse_time`` runs t = T-1 down to 0.
    """
    T, B, G = xw.shape
    H = G // 4
    stream = xw.dtype
    whf = wh.float()
    h, c = h0.float(), c0.float()
    h_seq = torch.empty((T, B, H), dtype=stream, device=xw.device)
    c_seq = (
        torch.empty((T, B, H), dtype=stream, device=xw.device)
        if return_c_seq else None
    )
    lens = lengths.to(xw.device)
    steps = range(T - 1, -1, -1) if reverse_time else range(T)
    for t in steps:
        h_in = (h * mask).to(stream).float()
        gates = xw[t].float() + h_in @ whf
        i, g, f, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < lens)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        h_seq[t] = torch.where(valid, h, 0.0).to(stream)
        if c_seq is not None:
            c_seq[t] = c.to(stream)
    return h_seq, c_seq, h, c


def _check(xw, wh, lengths, h0, c0, mask, names=("h0", "c0", "mask")):
    if xw.dim() != 3 or xw.shape[-1] % 4:
        raise ValueError(f"xw must be (T, B, 4H); got {tuple(xw.shape)}")
    T, B, G = xw.shape
    H = G // 4
    if xw.dtype not in _STREAM_DTYPES:
        raise TypeError(f"xw must be float32 or bfloat16; got {xw.dtype}")
    if tuple(wh.shape) != (H, G) or wh.dtype != xw.dtype:
        raise ValueError(
            f"wh must be ({H}, {G}) {xw.dtype}; got {tuple(wh.shape)} "
            f"{wh.dtype}"
        )
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(
            f"lengths must be ({B},) int32; got {tuple(lengths.shape)} "
            f"{lengths.dtype}"
        )
    for name, a in zip(names, (h0, c0, mask)):
        if tuple(a.shape) != (B, H) or a.dtype != torch.float32:
            raise ValueError(
                f"{name} must be ({B}, {H}) float32; got {tuple(a.shape)} "
                f"{a.dtype}"
            )
    tensors = (xw, wh, lengths, h0, c0, mask)
    if any(a.device != xw.device for a in tensors):
        raise ValueError("lstm_recurrence inputs must share one device")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("lstm_recurrence inputs must be contiguous")


def _rows_for(B: int, H: int, sms: int, directions: int = 1, waves: int = 1) -> int:
    """Batch rows per block: the fewest that keep the grid (``directions``
    chains of ``ceil(B / rows)`` blocks) within ``waves`` waves of ``sms``
    SMs (more rows per block means fewer re-reads of ``wh``, but more work
    per thread on the serial chain).  K1f takes two waves: on the H100 its
    one-row blocks beat two-row blocks at B=256 (PERF.md, section 6)."""
    cap = 8 if H <= 512 else 2
    for rows in _ROWS_PER_BLOCK:
        if rows >= cap or directions * -(-B // rows) <= waves * sms:
            return rows
    return cap


def _device_limits(device: torch.device) -> tuple[int, int]:
    """``(SMs, per-block shared memory opt-in in bytes)`` of a CUDA device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, device_smem_optin(index)


def _launch(xw, wh, lengths, h0, c0, mask, reverse_time, return_c_seq, rows):
    """One launch of K1f's rows body (``rows`` batch rows a block)."""
    T, B, G = xw.shape
    H = G // 4
    lib = load_library("lstm_recurrence")
    fn = lib.lstm_recurrence_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    h_seq = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    c_seq = torch.empty_like(h_seq) if return_c_seq else None
    hT = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    cT = torch.empty_like(hT)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xw.data_ptr(), wh.data_ptr(), lengths.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), mask.data_ptr(),
            h_seq.data_ptr(), c_seq.data_ptr() if return_c_seq else None,
            hT.data_ptr(), cT.data_ptr(),
            T, B, H, int(xw.dtype == torch.bfloat16), int(reverse_time),
            rows, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lstm_recurrence_fwd launch failed with CUDA error {err} "
            f"(T={T}, B={B}, H={H}, rows={rows}, {xw.dtype})"
        )
    return h_seq, c_seq, hT, cT


def _launch_cluster(xw, wh, lengths, h0, c0, mask, reverse_time, return_c_seq, cs, rows):
    """One launch of K1f's cluster body (bf16; ``cs`` CTAs and ``rows``
    batch rows a cluster)."""
    T, B, G = xw.shape
    H = G // 4
    fn = load_library("lstm_recurrence").lstm_recurrence_fwd_cluster
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    h_seq = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    c_seq = torch.empty_like(h_seq) if return_c_seq else None
    hT = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    cT = torch.empty_like(hT)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xw.data_ptr(), wh.data_ptr(), lengths.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), mask.data_ptr(), h_seq.data_ptr(),
            c_seq.data_ptr() if return_c_seq else None, hT.data_ptr(), cT.data_ptr(),
            T, B, H, int(reverse_time), cs, rows, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lstm_recurrence_fwd_cluster launch failed with CUDA error {err} "
            f"(T={T}, B={B}, H={H}, cluster size {cs}, {rows} rows a cluster)"
        )
    return h_seq, c_seq, hT, cT


def lstm_recurrence(
    xw: torch.Tensor,
    wh: torch.Tensor,
    lengths: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    mask: torch.Tensor,
    reverse_time: bool = False,
    return_c_seq: bool = False,
):
    """``(h_seq, c_seq, hT, cT)`` of the LSTM recurrence over the
    precomputed input projection ``xw = xs @ wx + b`` — see
    :func:`lstm_recurrence_reference` for the semantics.

    On a CUDA tensor this launches the Hopper kernel (and raises if it
    cannot be built or launched): the cluster body
    (``csrc/lstm_fwd_cluster.cuh``) where :func:`plan_fwd_body` picks it,
    else the rows body (``csrc/lstm_common.cuh::fwd_rows``);
    ``lstm_recurrence.launches_by_body`` counts each.  On a CPU tensor it
    runs the reference.
    """
    args = (xw, wh, lengths, h0, c0, mask)
    _check(*args)
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(*args, reverse_time, return_c_seq)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_recurrence runs on cuda or cpu, not {xw.device}")
    B, H = h0.shape
    _check_kernel_width("lstm_recurrence", H)
    plan = _plan_fwd(xw.dtype, B, H, xw.device)
    if plan["body"] == "cluster":
        out = _launch_cluster(*args, reverse_time, return_c_seq, plan["cluster_size"],
                              plan["rows_per_cluster"])
    else:
        out = _launch(*args, reverse_time, return_c_seq, plan["rows_per_block"])
    lstm_recurrence.launches += 1
    lstm_recurrence.launches_by_body[plan["body"]] += 1
    return out


lstm_recurrence.launches = 0
lstm_recurrence.launches_by_body = {"cluster": 0, "rows": 0}


# The no-gradient forwards of K1f and K4f as operators of their own, so
# that ``torch.export`` records each as one node of the graph
# (``serve.export_predictor``): running the node calls the wrapper, which
# launches and counts the kernel (or runs the plain version on the CPU).
@torch.library.custom_op(
    "ecog2txt_tpu_torch::lstm_recurrence", mutates_args=(),
    schema="(Tensor xw, Tensor wh, Tensor lengths, Tensor h0, Tensor c0, Tensor mask, "
           "bool reverse_time) -> (Tensor, Tensor, Tensor)",
)
def lstm_recurrence_op(xw, wh, lengths, h0, c0, mask, reverse_time):
    """``(h_seq, hT, cT)`` of :func:`lstm_recurrence` (K1f), no ``c_seq``."""
    h_seq, _, hT, cT = lstm_recurrence(xw, wh, lengths, h0, c0, mask, reverse_time)
    return h_seq, hT, cT


@lstm_recurrence_op.register_fake
def _(xw, wh, lengths, h0, c0, mask, reverse_time):
    T, B, G = xw.shape
    f32 = dict(dtype=torch.float32)
    return xw.new_empty((T, B, G // 4)), h0.new_empty((B, G // 4), **f32), \
        h0.new_empty((B, G // 4), **f32)


# --------------------------------------------------------------------------
# adjoint (K1b)
# --------------------------------------------------------------------------


def lstm_recurrence_bwd_reference(
    xw: torch.Tensor,  # (T, B, 4H) stream dtype
    wh: torch.Tensor,  # (H, 4H) stream dtype
    hprev: torch.Tensor,  # (T, B, H) stream dtype: h before each step
    cprev: torch.Tensor,  # (T, B, H) stream dtype: c before each step
    cseq: torch.Tensor,  # (T, B, H) stream dtype: c after each step
    lengths: torch.Tensor,  # (B,) int32
    mask: torch.Tensor,  # (B, H) f32
    dhseq: torch.Tensor,  # (T, B, H) stream dtype: dL/dh_seq
    dhT: torch.Tensor,  # (B, H) f32: dL/dhT
    dcT: torch.Tensor,  # (B, H) f32: dL/dcT
    reverse_time: bool = False,
):
    """Plain PyTorch version of the adjoint kernel: ``(dgates, dh0, dc0)``.

    Walks the steps opposite to the recurrence (t = T-1 down to 0, or up
    when the recurrence ran ``reverse_time``), recomputes
    ``gates = f32(xw[t]) + S(hprev[t] * mask) @ S(wh)`` and carries
    ``(dh, dc)`` back; steps ``t >= length`` give ``dgates = 0`` and leave
    the carry unchanged.  ``dgates`` (= dL/dxw) comes back in the stream
    dtype S, rounded before it feeds ``dh = S(dgates) @ S(wh)^T * mask``;
    ``dh0``/``dc0`` in f32.
    """
    T, B, G = xw.shape
    H = G // 4
    stream = xw.dtype
    whf = wh.float()
    dh, dc = dhT.float(), dcT.float()
    dgates = torch.empty((T, B, G), dtype=stream, device=xw.device)
    lens = lengths.to(xw.device)
    steps = range(T) if reverse_time else range(T - 1, -1, -1)
    for t in steps:
        valid = (t < lens)[:, None]
        h_in = (hprev[t].float() * mask).to(stream).float()
        gates = xw[t].float() + h_in @ whf
        gi, gg, gf, go = gates.split(H, dim=-1)
        si, sf, so = torch.sigmoid(gi), torch.sigmoid(gf + 1.0), torch.sigmoid(go)
        tg, tc = torch.tanh(gg), torch.tanh(cseq[t].float())
        dh_t = dh + torch.where(valid, dhseq[t].float(), 0.0)
        do = dh_t * tc * so * (1.0 - so)
        dct = dh_t * so * (1.0 - tc * tc) + dc
        di = dct * tg * si * (1.0 - si)
        dg = dct * si * (1.0 - tg * tg)
        df = dct * cprev[t].float() * sf * (1.0 - sf)
        d = torch.where(valid, torch.cat([di, dg, df, do], dim=-1), 0.0)
        d = d.to(stream)
        dgates[t] = d
        dh = torch.where(valid, (d.float() @ whf.T) * mask, dh)
        dc = torch.where(valid, dct * sf, dc)
    return dgates, dh, dc


def _check_bwd(xw, wh, hprev, cprev, cseq, lengths, mask, dhseq, dhT, dcT):
    _check(xw, wh, lengths, dhT, dcT, mask, names=("dhT", "dcT", "mask"))
    T, B, G = xw.shape
    for name, a in (("hprev", hprev), ("cprev", cprev), ("cseq", cseq),
                    ("dhseq", dhseq)):
        if tuple(a.shape) != (T, B, G // 4) or a.dtype != xw.dtype:
            raise ValueError(
                f"{name} must be ({T}, {B}, {G // 4}) {xw.dtype}; got "
                f"{tuple(a.shape)} {a.dtype}"
            )
        if a.device != xw.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xw.device}")


def _launch_bwd(xw, wh, hprev, cprev, cseq, lengths, mask, dhseq, dhT, dcT,
                reverse_time, rows):
    T, B, G = xw.shape
    H = G // 4
    lib = load_library("lstm_recurrence_bwd")
    fn = lib.lstm_recurrence_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    whT = wh.t().contiguous()
    dgates = torch.empty_like(xw)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    dc0 = torch.empty_like(dh0)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xw.data_ptr(), wh.data_ptr(), whT.data_ptr(), hprev.data_ptr(),
            cprev.data_ptr(), cseq.data_ptr(), lengths.data_ptr(),
            mask.data_ptr(), dhseq.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(),
            T, B, H, int(xw.dtype == torch.bfloat16), int(reverse_time),
            rows, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lstm_recurrence_bwd launch failed with CUDA error {err} "
            f"(T={T}, B={B}, H={H}, rows={rows}, {xw.dtype})"
        )
    return dgates, dh0, dc0


_CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs a cluster of the bf16 K1b body (8: the portable maximum)
_CLUSTER_ROWS = 16  # batch rows a cluster owns: one tensor-core tile (M)
_CLUSTER_MAX_GATE_COLS = 256  # 4 * units a CTA: one gate n8-tile pair a warp, 16 warps


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _cluster_units(H: int, cs: int) -> int:
    """Hidden units a CTA owns: ``ceil(H / cs)`` rounded up to a multiple of
    4, so a 16-byte push of partials lands in one CTA (the last CTA of a
    cluster may own fewer)."""
    per_cta = -(-H // cs)
    return -(-per_cta // 4) * 4


def _cluster_smem(H: int, cs: int) -> int:
    """Shared memory (bytes) of one CTA of the cluster body at width ``H``
    and ``cs`` CTAs a cluster: the f32 partials pushed to it (cs × 16 ×
    Uc), the resident weight slice (Hp × 4Uc), the step's ``S(hprev·mask)``
    rows, the dgates slice and the step's seven inputs of its (row, unit)
    pairs (16 × 7 × Uc), rows padded as ``csrc/lstm_bwd_cluster.cu::Dims``."""
    R, Hp, Uc = _CLUSTER_ROWS, _r16(H), _cluster_units(H, cs)
    SW, SH = _r16(4 * Uc) + 8, Hp + 8
    return cs * R * Uc * 4 + Hp * SW * 2 + R * SH * 2 + R * SW * 2 + R * 7 * Uc * 2


def plan_bwd_body(dtype: torch.dtype, B: int, H: int, sms: int, smem_limit: int,
                  directions: int = 1) -> dict:
    """Which body of the LSTM adjoint runs, K1b's (``directions=1``) or
    K4b's (``directions=2``, both chains of a biLSTM layer in one launch),
    chosen up front from the dtype and the shape: ``{"body": "cluster",
    "cluster_size": cs, "rows_per_cluster": 16, "clusters": n, "smem":
    bytes}`` for bf16 where a cluster of ``cs`` in (1, 2, 4, 8) CTAs holds
    ``wh`` (the fewest CTAs whose slice of at most 256 gate columns fits
    ``smem_limit``; 8 at H=400, 1 at H=64; ``n = directions · ceil(B /
    16)`` clusters), else ``{"body": "rows", "rows_per_block": r}``, the
    CUDA-core body (f32: the tensor cores have no f32 product; H whose
    slice fits no cluster, ~H > 420).  ``sms`` and ``smem_limit`` are the
    card's SM count and per-block shared-memory opt-in, passed in so the
    plan runs without a card."""
    if dtype == torch.bfloat16:
        for cs in _CLUSTER_SIZES:
            smem = _cluster_smem(H, cs)
            if 4 * _cluster_units(H, cs) <= _CLUSTER_MAX_GATE_COLS and smem <= smem_limit:
                return {"body": "cluster", "cluster_size": cs,
                        "rows_per_cluster": _CLUSTER_ROWS,
                        "clusters": directions * -(-B // _CLUSTER_ROWS), "smem": smem}
    return {"body": "rows", "rows_per_block": _rows_for(B, H, sms, directions)}


# A wave of 32-row forward clusters against one of 16-row clusters on a
# full card, at H=400, T'=104 (PERF.md, section 6: ~0.88-0.93 ms against
# ~0.52-0.56 ms on an H100)
_WAVE_COST_32_ROWS = 1.7


def _fwd_cluster_smem(H: int, cs: int, rows: int = _CLUSTER_ROWS) -> int:
    """Shared memory (bytes) of one CTA of the forward cluster body at width
    ``H``, ``cs`` CTAs and ``rows`` (16 or 32) batch rows a cluster: the
    resident weight slice (Hp × 4Uc, rows padded as K1b's) and the
    cluster's ``S(h·mask)`` rows, double-buffered (2 × rows × Hp), as
    ``csrc/lstm_fwd_cluster.cuh::FwdDims``."""
    Hp, Uc = _r16(H), _cluster_units(H, cs)
    return Hp * (_r16(4 * Uc) + 8) * 2 + 2 * rows * (Hp + 8) * 2


def _fwd_cluster_sizes(H: int, smem_limit: int) -> list[int]:
    """The cluster sizes whose forward slice of ``wh`` (at most 256 gate
    columns a CTA) fits ``smem_limit`` bytes, ascending."""
    return [cs for cs in _CLUSTER_SIZES
            if 4 * _cluster_units(H, cs) <= _CLUSTER_MAX_GATE_COLS
            and _fwd_cluster_smem(H, cs) <= smem_limit]


def plan_fwd_body(dtype: torch.dtype, B: int, H: int, sms: int, smem_limit: int,
                  directions: int = 1, resident: dict | None = None) -> dict:
    """Which body of the LSTM forward runs, K1f's (``directions=1``) or
    K4f's (``directions=2``), chosen up front from the dtype and the shape:
    ``{"body": "cluster", "cluster_size": cs, "rows_per_cluster": r,
    "clusters": n, "smem": bytes}`` for bf16 where a cluster of ``cs`` in
    (1, 2, 4, 8) CTAs holds ``wh`` (a slice of at most 256 gate columns
    that fits ``smem_limit``), else ``{"body": "rows", "rows_per_block":
    r}``, the CUDA-core body (f32, and H whose slice fits no cluster, H >
    432).

    The cluster size: the most CTAs whose 16-row clusters all run at once
    (``n = directions · ceil(B / 16)`` within one wave), since a CTA with
    fewer units has fewer warps in the serial step's cell; the fewest CTAs
    that fit where no size runs in one wave (8 at H=400, B=256), or where
    B < 16 (the tile is mostly padding rows, which skip the cell, and a
    one-CTA cluster needs only a block barrier).  Rows a cluster: 32 (two
    tensor-core row tiles) where its clusters run in so many fewer waves
    than at 16 rows that the slower 32-row wave (``_WAVE_COST_32_ROWS``
    times a 16-row wave) still wins, else 16.  At B=256, H=400 K1f takes
    32 rows (1 wave against 2), K4f 16 (3 waves against 2 slower ones).
    ``resident`` maps a cluster size to how many such clusters the card
    keeps at once (the H100: 15 of 8), by default ``sms // cs``.  ``sms``
    and ``smem_limit`` are the card's SM count and per-block shared-memory
    opt-in, passed in so the plan runs without a card."""
    fits = _fwd_cluster_sizes(H, smem_limit)
    if dtype != torch.bfloat16 or not fits:
        return {"body": "rows",
                "rows_per_block": _rows_for(B, H, sms, directions, waves=2 if directions == 1 else 1)}

    def waves(cs, rows):
        at_once = max(1, (resident or {}).get(cs, sms // cs))
        return -(-directions * -(-B // rows) // at_once)

    one_wave = [cs for cs in fits if waves(cs, _CLUSTER_ROWS) == 1]
    cs = one_wave[-1] if B >= _CLUSTER_ROWS and one_wave else fits[0]
    rows = _CLUSTER_ROWS
    if (_fwd_cluster_smem(H, cs, 2 * rows) <= smem_limit
            and _WAVE_COST_32_ROWS * waves(cs, 2 * rows) < waves(cs, rows)):
        rows *= 2
    return {"body": "cluster", "cluster_size": cs, "rows_per_cluster": rows,
            "clusters": directions * -(-B // rows), "smem": _fwd_cluster_smem(H, cs, rows)}


@functools.cache
def _fwd_resident(index: int, H: int, cs: int) -> int:
    """How many clusters of ``cs`` CTAs of the forward cluster body at width
    ``H`` CUDA device ``index`` keeps resident at once."""
    fn = load_library("lstm_recurrence").lstm_recurrence_fwd_cluster_max_active
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    with torch.cuda.device(index):
        n = int(fn(H, cs))
    if n <= 0:
        raise RuntimeError(f"cannot read the resident clusters of {cs} CTAs at H={H} "
                           f"on CUDA device {index} (error {-n})")
    return n


def _plan_fwd(dtype: torch.dtype, B: int, H: int, device: torch.device,
              directions: int = 1) -> dict:
    """:func:`plan_fwd_body` on the card of ``device``, with its residency."""
    sms, smem_limit = _device_limits(device)
    resident = None
    if dtype == torch.bfloat16:
        index = device.index if device.index is not None else torch.cuda.current_device()
        resident = {cs: _fwd_resident(index, H, cs) for cs in _fwd_cluster_sizes(H, smem_limit)}
    return plan_fwd_body(dtype, B, H, sms, smem_limit, directions, resident)


def _launch_bwd_cluster(xw, wh, hprev, cprev, cseq, lengths, mask, dhseq,
                        dhT, dcT, reverse_time, cs):
    T, B, G = xw.shape
    H = G // 4
    fn = load_library("lstm_bwd_cluster").lstm_recurrence_bwd_cluster
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dgates = torch.empty_like(xw)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    dc0 = torch.empty_like(dh0)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xw.data_ptr(), wh.data_ptr(), hprev.data_ptr(), cprev.data_ptr(),
            cseq.data_ptr(), lengths.data_ptr(), mask.data_ptr(),
            dhseq.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            T, B, H, int(reverse_time), cs, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lstm_recurrence_bwd_cluster launch failed with CUDA error {err} "
            f"(T={T}, B={B}, H={H}, cluster size {cs})"
        )
    return dgates, dh0, dc0


def lstm_recurrence_bwd(
    xw: torch.Tensor,
    wh: torch.Tensor,
    hprev: torch.Tensor,
    cprev: torch.Tensor,
    cseq: torch.Tensor,
    lengths: torch.Tensor,
    mask: torch.Tensor,
    dhseq: torch.Tensor,
    dhT: torch.Tensor,
    dcT: torch.Tensor,
    reverse_time: bool = False,
):
    """``(dgates, dh0, dc0)``: the adjoint of :func:`lstm_recurrence` —
    see :func:`lstm_recurrence_bwd_reference` for the semantics.

    On a CUDA tensor this launches the Hopper kernel (and raises if it
    cannot be built or launched): the cluster body
    (``csrc/lstm_bwd_cluster.cu``) where :func:`plan_bwd_body` picks it,
    else the rows body (``csrc/lstm_recurrence_bwd.cu``);
    ``lstm_recurrence_bwd.launches_by_body`` counts each.  On a CPU tensor
    it runs the reference.
    """
    args = (xw, wh, hprev, cprev, cseq, lengths, mask, dhseq, dhT, dcT)
    _check_bwd(*args)
    if xw.device.type == "cpu":
        return lstm_recurrence_bwd_reference(*args, reverse_time)
    if xw.device.type != "cuda":
        raise ValueError(
            f"lstm_recurrence_bwd runs on cuda or cpu, not {xw.device}"
        )
    B, H = dhT.shape
    _check_kernel_width("lstm_recurrence_bwd", H)
    plan = plan_bwd_body(xw.dtype, B, H, *_device_limits(xw.device))
    if plan["body"] == "cluster":
        out = _launch_bwd_cluster(*args, reverse_time, plan["cluster_size"])
    else:
        out = _launch_bwd(*args, reverse_time, plan["rows_per_block"])
    lstm_recurrence_bwd.launches += 1
    lstm_recurrence_bwd.launches_by_body[plan["body"]] += 1
    return out


lstm_recurrence_bwd.launches = 0
lstm_recurrence_bwd.launches_by_body = {"cluster": 0, "rows": 0}


# --------------------------------------------------------------------------
# the differentiable recurrence
# --------------------------------------------------------------------------


def _shifted(seq: torch.Tensor, first: torch.Tensor, reverse_time: bool):
    """The predecessor of each step in recurrence order: ``seq`` shifted
    by one step, with ``first`` (the initial state) at the recurrence's
    first step (the tail for ``reverse_time``)."""
    first = first[None].to(seq.dtype)
    if reverse_time:
        return torch.cat([seq[1:], first], dim=0)
    return torch.cat([first, seq[:-1]], dim=0)


class LSTMRecurrence(torch.autograd.Function):
    """K1f forward, K1b backward: the port of the custom VJP of
    ``fused_lstm_recurrence`` (``ecog2txt_tpu/ops/pallas_lstm.py``).

    ``wh`` arrives in its parameter dtype (f32) and is cast to the stream
    dtype inside, so its gradient reaches the parameter in f32:
    ``dwh = S(hprev * mask)^T @ dgates`` with S-rounded operands and an
    f32 product.  ``lengths`` and ``mask`` get no gradient."""

    @staticmethod
    def forward(ctx, xw, wh, lengths, h0, c0, mask, reverse_time):
        whs = wh.to(xw.dtype).contiguous()
        h_seq, c_seq, hT, cT = lstm_recurrence(
            xw, whs, lengths, h0, c0, mask, reverse_time, return_c_seq=True
        )
        ctx.save_for_backward(xw, whs, lengths, h0, c0, mask, h_seq, c_seq)
        ctx.reverse_time = reverse_time
        ctx.wh_dtype = wh.dtype
        return h_seq, hT, cT

    @staticmethod
    def backward(ctx, dhseq, dhT, dcT):
        xw, whs, lengths, h0, c0, mask, h_seq, c_seq = ctx.saved_tensors
        rt = ctx.reverse_time
        stream = xw.dtype
        T, B, G = xw.shape
        H = G // 4
        zeros = lambda shape, dtype: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=xw.device
        )
        dhseq = (
            zeros((T, B, H), stream) if dhseq is None
            else dhseq.to(stream).contiguous()
        )
        dhT = zeros((B, H), torch.float32) if dhT is None else dhT.float().contiguous()
        dcT = zeros((B, H), torch.float32) if dcT is None else dcT.float().contiguous()
        hprev = _shifted(h_seq, h0, rt)
        cprev = _shifted(c_seq, c0, rt)
        dgates, dh0, dc0 = lstm_recurrence_bwd(
            xw, whs, hprev, cprev, c_seq, lengths, mask, dhseq, dhT, dcT, rt
        )
        dwh = None
        if ctx.needs_input_grad[1]:
            # one GEMM outside the serial loop: S-rounded operands, f32
            # products and accumulation, f32 result
            h_in = (hprev * mask.to(stream)).reshape(T * B, H)
            dwh = (h_in.float().T @ dgates.reshape(T * B, G).float()).to(
                ctx.wh_dtype
            )
        return dgates, dwh, None, dh0, dc0, None, None


def fused_lstm_recurrence(
    xw: torch.Tensor,  # (T, B, 4H) stream dtype
    wh: torch.Tensor,  # (H, 4H) parameter dtype
    lengths: torch.Tensor,  # (B,) int32
    h0: torch.Tensor,  # (B, H) f32
    c0: torch.Tensor,  # (B, H) f32
    mask: torch.Tensor,  # (B, H) f32
    reverse_time: bool = False,
):
    """``(h_seq, hT, cT)`` of the recurrence, differentiable in ``xw``,
    ``wh``, ``h0`` and ``c0``.  When no gradient is wanted (serving under
    ``torch.inference_mode``) it runs K1f alone without saving ``c_seq``.
    ``reverse_time`` requires a zero initial state, as in JAX."""
    wants_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (xw, wh, h0, c0)
    )
    if not wants_grad:
        return tuple(lstm_recurrence_op(
            xw, wh.to(xw.dtype).contiguous(), lengths, h0, c0, mask, reverse_time,
        ))
    return LSTMRecurrence.apply(xw, wh, lengths, h0, c0, mask, reverse_time)


# --------------------------------------------------------------------------
# both directions of a biLSTM layer in one launch (K4f, K4b)
# --------------------------------------------------------------------------


def bilstm_grid_fwd_reference(
    xwf: torch.Tensor,  # (T, B, 4H) stream dtype: forward chain's projection
    xwb: torch.Tensor,  # (T, B, 4H) stream dtype: reverse chain's projection
    whf: torch.Tensor,  # (H, 4H) stream dtype
    whb: torch.Tensor,  # (H, 4H) stream dtype
    lengths: torch.Tensor,  # (B,) int32
    maskf: torch.Tensor,  # (B, H) f32
    maskb: torch.Tensor,  # (B, H) f32
    return_c_seq: bool = True,
):
    """Plain version of K4f: ``(hf, hb, cf, cb, hT, cT)`` in the order of
    JAX's ``_bi_grid_fwd_call``.  The forward chain runs t = 0…T-1 and the
    reverse chain t = T-1…0 (K1f's ``reverse_time``), both from a zero
    state, each the step loop of :func:`lstm_recurrence_reference`;
    ``hT``/``cT`` are ``(2, B, H)`` f32, direction first; ``cf``/``cb``
    are None unless ``return_c_seq``."""
    zeros = torch.zeros(maskf.shape, dtype=torch.float32, device=xwf.device)
    hf, cf, hTf, cTf = lstm_recurrence_reference(
        xwf, whf, lengths, zeros, zeros, maskf, False, return_c_seq
    )
    hb, cb, hTb, cTb = lstm_recurrence_reference(
        xwb, whb, lengths, zeros, zeros, maskb, True, return_c_seq
    )
    return hf, hb, cf, cb, torch.stack([hTf, hTb]), torch.stack([cTf, cTb])


def _check_grid(xwf, xwb, whf, whb, lengths, maskf, maskb):
    for xw, wh, mask, d in ((xwf, whf, maskf, "f"), (xwb, whb, maskb, "b")):
        _check(xw, wh, lengths, mask, mask, mask, names=(f"mask{d}",) * 3)
    if xwb.shape != xwf.shape or xwb.dtype != xwf.dtype or xwb.device != xwf.device:
        raise ValueError("xwf and xwb must share one shape, dtype and device")


def _launch_grid(fn_name, tensors, T, B, H, dtype, device, *tile):
    """One launch of a ``csrc/bilstm_grid.cu`` entry on ``tensors``
    stacked direction-major; ``tile`` is the rows body's batch rows a
    block, K4b's cluster body's CTAs a cluster, or K4f's cluster body's
    CTAs and batch rows a cluster."""
    fn = getattr(load_library("bilstm_grid"), fn_name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * (4 + len(tile)) + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    ptrs = [None if a is None else a.data_ptr() for a in tensors]
    array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(array, T, B, H, int(dtype == torch.bfloat16), *tile, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed with CUDA error {err} "
            f"(T={T}, B={B}, H={H}, tile {tile}, {dtype})"
        )


def _launch_grid_fwd(xwf, xwb, whf, whb, lengths, maskf, maskb, return_c_seq, plan):
    """One K4f launch of the body ``plan`` names; the kernel takes each
    per-direction tensor stacked direction-major, so the inputs are
    stacked here (one copy each) and the outputs come back as views of
    stacked tensors."""
    T, B, G = xwf.shape
    H = G // 4
    seq = lambda: torch.empty((2, T, B, H), dtype=xwf.dtype, device=xwf.device)  # noqa: E731
    h_seq = seq()
    c_seq = seq() if return_c_seq else None
    hT = torch.empty((2, B, H), dtype=torch.float32, device=xwf.device)
    cT = torch.empty_like(hT)
    tensors = (torch.stack([xwf, xwb]), torch.stack([whf, whb]), lengths,
               torch.stack([maskf, maskb]), h_seq, c_seq, hT, cT)
    if plan["body"] == "cluster":
        _launch_grid("bilstm_grid_fwd_cluster", tensors, T, B, H, xwf.dtype, xwf.device,
                     plan["cluster_size"], plan["rows_per_cluster"])
    else:
        _launch_grid("bilstm_grid_fwd", tensors, T, B, H, xwf.dtype, xwf.device,
                     plan["rows_per_block"])
    cf, cb = (c_seq[0], c_seq[1]) if return_c_seq else (None, None)
    return h_seq[0], h_seq[1], cf, cb, hT, cT


def bilstm_grid_fwd(
    xwf: torch.Tensor,
    xwb: torch.Tensor,
    whf: torch.Tensor,
    whb: torch.Tensor,
    lengths: torch.Tensor,
    maskf: torch.Tensor,
    maskb: torch.Tensor,
    return_c_seq: bool = True,
):
    """``(hf, hb, cf, cb, hT, cT)``: both directions of one biLSTM layer
    in one launch — see :func:`bilstm_grid_fwd_reference`.

    On a CUDA tensor this launches the Hopper kernel K4f (and raises if it
    cannot be built or launched): K1f's cluster body with a direction axis
    (``csrc/lstm_fwd_cluster.cuh`` through ``csrc/bilstm_grid.cu``) where
    :func:`plan_fwd_body` picks it for two directions, else the rows body;
    ``bilstm_grid_fwd.launches_by_body`` counts each.  On a CPU tensor it
    runs the reference.
    """
    _check_grid(xwf, xwb, whf, whb, lengths, maskf, maskb)
    if xwf.device.type == "cpu":
        return bilstm_grid_fwd_reference(
            xwf, xwb, whf, whb, lengths, maskf, maskb, return_c_seq
        )
    if xwf.device.type != "cuda":
        raise ValueError(f"bilstm_grid_fwd runs on cuda or cpu, not {xwf.device}")
    B, H = maskf.shape
    _check_kernel_width("bilstm_grid_fwd", H)
    plan = _plan_fwd(xwf.dtype, B, H, xwf.device, directions=2)
    out = _launch_grid_fwd(xwf, xwb, whf, whb, lengths, maskf, maskb, return_c_seq, plan)
    bilstm_grid_fwd.launches += 1
    bilstm_grid_fwd.launches_by_body[plan["body"]] += 1
    return out


bilstm_grid_fwd.launches = 0
bilstm_grid_fwd.launches_by_body = {"cluster": 0, "rows": 0}


@torch.library.custom_op(
    "ecog2txt_tpu_torch::bilstm_grid_fwd", mutates_args=(),
    schema="(Tensor xwf, Tensor xwb, Tensor whf, Tensor whb, Tensor lengths, Tensor maskf, "
           "Tensor maskb) -> (Tensor, Tensor, Tensor)",
)
def bilstm_grid_fwd_op(xwf, xwb, whf, whb, lengths, maskf, maskb):
    """``(h_seq (T, B, 2H), hT (B, 2H), cT (B, 2H))`` of :func:`bilstm_grid_fwd`
    (K4f), the two directions side by side, no ``c_seq`` (see
    :func:`lstm_recurrence_op`; the kernel's outputs are views of one
    buffer, which an operator may not return)."""
    hf, hb, _, _, hT, cT = bilstm_grid_fwd(
        xwf, xwb, whf, whb, lengths, maskf, maskb, return_c_seq=False
    )
    return (
        torch.cat([hf, hb], dim=-1),
        torch.cat([hT[0], hT[1]], dim=-1),
        torch.cat([cT[0], cT[1]], dim=-1),
    )


@bilstm_grid_fwd_op.register_fake
def _(xwf, xwb, whf, whb, lengths, maskf, maskb):
    T, B, G = xwf.shape
    state = maskf.new_empty((B, G // 2), dtype=torch.float32)
    return xwf.new_empty((T, B, G // 2)), state, state.new_empty(state.shape)


def bilstm_grid_bwd_reference(
    xwf, xwb,  # (T, B, 4H) stream dtype
    whf, whb,  # (H, 4H) stream dtype
    hpf, hpb,  # (T, B, H) stream dtype: h before each step, in recurrence order
    cpf, cpb,  # (T, B, H) stream dtype: c before each step
    csf, csb,  # (T, B, H) stream dtype: c after each step
    lengths,  # (B,) int32
    maskf, maskb,  # (B, H) f32
    dhsf, dhsb,  # (T, B, H) stream dtype: dL/dh_seq per direction
    dhT, dcT,  # (2, B, H) f32
):
    """Plain version of K4b: ``(dgf, dgb, dh0, dc0)`` in the order of
    JAX's ``_bi_grid_bwd_call``: the forward chain's adjoint walks
    t = T-1…0 and the reverse chain's t = 0…T-1, each the step loop of
    :func:`lstm_recurrence_bwd_reference`; ``dh0``/``dc0`` are
    ``(2, B, H)`` f32, direction first."""
    dgf, dh0f, dc0f = lstm_recurrence_bwd_reference(
        xwf, whf, hpf, cpf, csf, lengths, maskf, dhsf, dhT[0], dcT[0], False
    )
    dgb, dh0b, dc0b = lstm_recurrence_bwd_reference(
        xwb, whb, hpb, cpb, csb, lengths, maskb, dhsb, dhT[1], dcT[1], True
    )
    return dgf, dgb, torch.stack([dh0f, dh0b]), torch.stack([dc0f, dc0b])


def bilstm_grid_bwd(xwf, xwb, whf, whb, hpf, hpb, cpf, cpb, csf, csb, lengths,
                    maskf, maskb, dhsf, dhsb, dhT, dcT):
    """``(dgf, dgb, dh0, dc0)``: both adjoint chains of one biLSTM layer
    in one launch — see :func:`bilstm_grid_bwd_reference`.

    On a CUDA tensor this launches the Hopper kernel K4b (and raises if it
    cannot be built or launched): K1b's cluster body with a direction axis
    (``csrc/lstm_bwd_cluster.cuh`` through ``csrc/bilstm_grid.cu``) where
    :func:`plan_bwd_body` picks it for two directions, else the rows body;
    ``bilstm_grid_bwd.launches_by_body`` counts each.  On a CPU tensor it
    runs the reference.
    """
    args = (xwf, xwb, whf, whb, hpf, hpb, cpf, cpb, csf, csb, lengths,
            maskf, maskb, dhsf, dhsb, dhT, dcT)
    _check_grid(xwf, xwb, whf, whb, lengths, maskf, maskb)
    T, B, G = xwf.shape
    H = G // 4
    for name, a in (("dhT", dhT), ("dcT", dcT)):
        if tuple(a.shape) != (2, B, H) or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (2, {B}, {H}) float32")
    _check_bwd(xwf, whf, hpf, cpf, csf, lengths, maskf, dhsf, dhT[0], dcT[0])
    _check_bwd(xwb, whb, hpb, cpb, csb, lengths, maskb, dhsb, dhT[1], dcT[1])
    if xwf.device.type == "cpu":
        return bilstm_grid_bwd_reference(*args)
    if xwf.device.type != "cuda":
        raise ValueError(f"bilstm_grid_bwd runs on cuda or cpu, not {xwf.device}")
    _check_kernel_width("bilstm_grid_bwd", H)
    plan = plan_bwd_body(xwf.dtype, B, H, *_device_limits(xwf.device), directions=2)
    # the kernel takes each per-direction tensor stacked direction-major
    stack = lambda a, b: torch.stack([a, b])  # noqa: E731
    wh = stack(whf, whb)
    dgates = torch.empty((2, T, B, G), dtype=xwf.dtype, device=xwf.device)
    dh0 = torch.empty((2, B, H), dtype=torch.float32, device=xwf.device)
    dc0 = torch.empty_like(dh0)
    seqs = (stack(hpf, hpb), stack(cpf, cpb), stack(csf, csb), lengths, stack(maskf, maskb),
            stack(dhsf, dhsb), dhT, dcT, dgates, dh0, dc0)
    if plan["body"] == "cluster":
        _launch_grid("bilstm_grid_bwd_cluster", (stack(xwf, xwb), wh, *seqs),
                     T, B, H, xwf.dtype, xwf.device, plan["cluster_size"])
    else:
        _launch_grid("bilstm_grid_bwd",
                     (stack(xwf, xwb), wh, wh.transpose(1, 2).contiguous(), *seqs),
                     T, B, H, xwf.dtype, xwf.device, plan["rows_per_block"])
    bilstm_grid_bwd.launches += 1
    bilstm_grid_bwd.launches_by_body[plan["body"]] += 1
    return dgates[0], dgates[1], dh0, dc0


bilstm_grid_bwd.launches = 0
bilstm_grid_bwd.launches_by_body = {"cluster": 0, "rows": 0}


class BiLSTMGrid(torch.autograd.Function):
    """K4f forward, K4b backward: the port of the custom VJP of
    ``fused_bilstm_grid`` (``ecog2txt_tpu/ops/pallas_lstm.py``).

    JAX's VJP runs the two adjoint chains as two ``_bwd_call`` launches
    (K1b); this one runs them as ONE K4b launch, the same function by
    another kernel: the difference is deliberate, it is the path on which
    K4b runs.  The recurrent weights' gradients are two f32 GEMMs outside
    the kernel, ``dwh = S(hprev * mask)^T @ dgates`` per direction.
    ``whf``/``whb`` arrive in their parameter dtype (f32) and are cast to
    the stream dtype inside, so their gradients reach the parameters in
    f32.  ``lengths`` and the masks get no gradient."""

    @staticmethod
    def forward(ctx, xwf, xwb, whf, whb, lengths, maskf, maskb):
        stream = xwf.dtype
        whfs, whbs = whf.to(stream).contiguous(), whb.to(stream).contiguous()
        hf, hb, cf, cb, hT, cT = bilstm_grid_fwd(
            xwf, xwb, whfs, whbs, lengths, maskf, maskb
        )
        ctx.save_for_backward(xwf, xwb, whfs, whbs, lengths, maskf, maskb, hf, hb, cf, cb)
        ctx.wh_dtypes = (whf.dtype, whb.dtype)
        return (
            torch.cat([hf, hb], dim=-1),
            torch.cat([hT[0], hT[1]], dim=-1),
            torch.cat([cT[0], cT[1]], dim=-1),
        )

    @staticmethod
    def backward(ctx, dhseq, dhT, dcT):
        xwf, xwb, whfs, whbs, lengths, maskf, maskb, hf, hb, cf, cb = ctx.saved_tensors
        stream = xwf.dtype
        T, B, G = xwf.shape
        H = G // 4
        dev = xwf.device
        if dhseq is None:
            dhseq = torch.zeros((T, B, 2 * H), dtype=stream, device=dev)
        dhseq = dhseq.to(stream)
        dhsf, dhsb = dhseq[..., :H].contiguous(), dhseq[..., H:].contiguous()

        def by_direction(g):  # (B, 2H) → (2, B, H) f32
            if g is None:
                return torch.zeros((2, B, H), dtype=torch.float32, device=dev)
            return torch.stack([g[:, :H], g[:, H:]]).float().contiguous()

        zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
        # the forward chain's predecessor is t-1; the reverse chain's t+1
        hpf, cpf = _shifted(hf, zeros, False), _shifted(cf, zeros, False)
        hpb, cpb = _shifted(hb, zeros, True), _shifted(cb, zeros, True)
        dgf, dgb, _, _ = bilstm_grid_bwd(
            xwf, xwb, whfs, whbs, hpf, hpb, cpf, cpb, cf, cb, lengths, maskf,
            maskb, dhsf, dhsb, by_direction(dhT), by_direction(dcT),
        )
        dwh = []
        for i, (hp, mask, dg) in enumerate(((hpf, maskf, dgf), (hpb, maskb, dgb))):
            if not ctx.needs_input_grad[2 + i]:
                dwh.append(None)
                continue
            # S-rounded operands, f32 products and accumulation, f32 result
            h_in = (hp * mask.to(stream)).reshape(T * B, H)
            dwh.append((h_in.float().T @ dg.reshape(T * B, G).float()).to(
                ctx.wh_dtypes[i]
            ))
        return dgf, dgb, dwh[0], dwh[1], None, None, None


def fused_bilstm_grid(
    xwf: torch.Tensor,  # (T, B, 4H) stream dtype
    xwb: torch.Tensor,  # (T, B, 4H) stream dtype
    whf: torch.Tensor,  # (H, 4H) parameter dtype
    whb: torch.Tensor,  # (H, 4H) parameter dtype
    lengths: torch.Tensor,  # (B,) int32
    maskf: torch.Tensor,  # (B, H) f32
    maskb: torch.Tensor,  # (B, H) f32
):
    """Both directions of a biLSTM layer in one launch from a zero state:
    ``(h_seq (T, B, 2H), hT (B, 2H), cT (B, 2H))`` as JAX's
    ``fused_bilstm_grid`` returns them, the reverse chain's outputs at
    their absolute positions.  Differentiable in ``xwf``, ``xwb``,
    ``whf`` and ``whb``; when no gradient is wanted it runs K4f alone
    without storing ``c_seq``."""
    wants_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (xwf, xwb, whf, whb)
    )
    if not wants_grad:
        stream = xwf.dtype
        return tuple(bilstm_grid_fwd_op(
            xwf, xwb, whf.to(stream).contiguous(), whb.to(stream).contiguous(),
            lengths, maskf, maskb,
        ))
    return BiLSTMGrid.apply(xwf, xwb, whf, whb, lengths, maskf, maskb)
