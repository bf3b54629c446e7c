"""LSTM recurrence forward: the Hopper kernel, its wrapper and its plain
PyTorch version.

``lstm_recurrence`` is the port of ``ecog2txt_tpu/ops/pallas_lstm.py::
fused_lstm_recurrence`` (forward).  On a CUDA tensor it launches
``csrc/lstm_recurrence.cu`` (one launch for the whole sequence) or
raises; on a CPU tensor it runs :func:`lstm_recurrence_reference`, a
step loop with the same rounding points.  ``lstm_recurrence.launches``
counts kernel launches.
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


def _check(xw, wh, lengths, h0, c0, mask):
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
    for name, a in (("h0", h0), ("c0", c0), ("mask", mask)):
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
