"""LSTM recurrence: the Hopper kernels (forward K1f, adjoint K1b), their
wrappers, their plain PyTorch versions and the autograd Function.

``lstm_recurrence`` is the port of ``ecog2txt_tpu/ops/pallas_lstm.py::
_fwd_call`` and ``lstm_recurrence_bwd`` of ``_bwd_call``.  On a CUDA
tensor each launches its kernel (``csrc/lstm_recurrence.cu``,
``csrc/lstm_recurrence_bwd.cu``; one launch for the whole sequence) or
raises; on a CPU tensor each runs its plain version
(:func:`lstm_recurrence_reference`, :func:`lstm_recurrence_bwd_reference`),
a step loop with the same rounding points.  ``<wrapper>.launches`` counts
kernel launches.  :func:`fused_lstm_recurrence` is the differentiable
recurrence (the JAX package's custom VJP of the same name): forward K1f,
backward K1b plus one GEMM for the recurrent weight's gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_ROWS_PER_BLOCK = (1, 2, 4, 8)


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


def _rows_per_block(B: int, H: int, device: torch.device) -> int:
    """Batch rows per block: the fewest that keep the grid within one
    wave of SMs (more rows per block means fewer re-reads of ``wh``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cap = 8 if H <= 512 else 2
    for rows in _ROWS_PER_BLOCK:
        if rows >= cap or -(-B // rows) <= sms:
            return rows
    return cap


def _launch(xw, wh, lengths, h0, c0, mask, reverse_time, return_c_seq, rows):
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
    lstm_recurrence.launches += 1
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
    cannot be built or launched); on a CPU tensor it runs the reference.
    """
    _check(xw, wh, lengths, h0, c0, mask)
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(
            xw, wh, lengths, h0, c0, mask, reverse_time, return_c_seq
        )
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_recurrence runs on cuda or cpu, not {xw.device}")
    B, H = h0.shape
    return _launch(
        xw, wh, lengths, h0, c0, mask, reverse_time, return_c_seq,
        _rows_per_block(B, H, xw.device),
    )


lstm_recurrence.launches = 0


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
    lstm_recurrence_bwd.launches += 1
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
    cannot be built or launched); on a CPU tensor it runs the reference.
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
    return _launch_bwd(
        *args, reverse_time, _rows_per_block(B, H, xw.device)
    )


lstm_recurrence_bwd.launches = 0


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
        h_seq, _, hT, cT = lstm_recurrence(
            xw, wh.to(xw.dtype).contiguous(), lengths, h0, c0, mask,
            reverse_time,
        )
        return h_seq, hT, cT
    return LSTMRecurrence.apply(xw, wh, lengths, h0, c0, mask, reverse_time)
