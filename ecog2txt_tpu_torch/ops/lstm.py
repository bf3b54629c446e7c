"""LSTM recurrences: step loops over fused-gate products, and the
gather-free bidirectional path through the Hopper recurrence kernel.

The twin of ``ecog2txt_tpu/ops/lstm.py`` with the same semantics:

* the four gates are packed (i, g, f, o) in one ``(in, 4H)`` weight,
  with +1 added to the forget gate in the cell;
* sequences are time-major ``(T, B, F)``; the input projection
  ``xs @ wx + b`` is ONE GEMM hoisted out of the recurrence;
* with ``lengths`` the carry freezes once ``t >= length`` (so the final
  state is the state at each sequence's last valid step) and outputs
  past the valid prefix are 0;
* recurrent dropout is a variational per-sequence mask on ``h``;
* products round their operands to ``compute_dtype`` and accumulate in
  f32 with an f32 result (``jnp.dot(..., preferred_element_type=f32)``).

The kernel paths go through :func:`~.lstm_kernels.fused_lstm_recurrence`
(forward kernel K1f, adjoint kernel K1b; ``use_pallas=True``, one
launch per direction) or, for both directions of a biLSTM layer at
once, :func:`~.lstm_kernels.fused_bilstm_grid` (K4f, K4b;
``use_pallas='bi_grid'``); the recurrent weights enter them in f32 and
are cast to the stream dtype inside, so their gradients stay f32.  The
step loops are differentiable as they stand.

``torch.nn.LSTM`` cannot stand in: its gates are (i, f, g, o), it has
no +1 forget bias and no per-step mask on ``h``.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from .lstm_kernels import fused_bilstm_grid, fused_lstm_recurrence

# the kernel paths of use_pallas (use_pallas_lstm in the model config)
USE_PALLAS_VALUES = (False, True, "bi_grid")


def check_use_pallas(use_pallas) -> None:
    """Raise ``ValueError`` unless ``use_pallas`` is False (step loops),
    True (K1f/K1b, one launch per direction) or ``'bi_grid'`` (K4f/K4b,
    both directions of a biLSTM layer in one launch)."""
    if not (use_pallas is True or use_pallas is False or use_pallas == "bi_grid"):
        raise ValueError(
            f"use_pallas={use_pallas!r}: expected one of {USE_PALLAS_VALUES}"
        )


def dot_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``compute_dtype``, exact
    products and f32 accumulation into an f32 result."""
    return torch.matmul(x.to(compute_dtype).float(), w.to(compute_dtype).float())


def init_lstm_params(
    generator: torch.Generator,
    input_dim: int,
    hidden_dim: int,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Fused kernel packing the 4 gate matrices (i, g, f, o) in columns:
    Glorot-uniform input block, block-orthogonal recurrent block, zero
    bias.  Drawn from the CPU ``generator``, then moved to ``device``."""
    dev = resolve_device(device)
    scale = (6.0 / (input_dim + 4 * hidden_dim)) ** 0.5
    wx = (
        torch.rand((input_dim, 4 * hidden_dim), generator=generator) * 2 - 1
    ) * scale
    whs = [
        torch.nn.init.orthogonal_(
            torch.empty(hidden_dim, hidden_dim), generator=generator
        )
        for _ in range(4)
    ]
    wh = torch.cat(whs, dim=1)
    b = torch.zeros(4 * hidden_dim)
    return {"wx": wx.to(dev), "wh": wh.to(dev), "b": b.to(dev)}


def _gates_to_hc(gates, c):
    i, g, f, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _recurrent_gates(params, h, h_dropout_mask, compute_dtype):
    h_in = h if h_dropout_mask is None else h * h_dropout_mask
    return dot_f32(h_in, params["wh"], compute_dtype)


def lstm_step(
    params: dict,
    carry: tuple[torch.Tensor, torch.Tensor],
    x: torch.Tensor,
    h_dropout_mask: torch.Tensor | None = None,
    compute_dtype=torch.float32,
):
    """Single step ``((h, c), h)`` (the decoder's sampling loop)."""
    h, c = carry
    gates = (
        dot_f32(x, params["wx"], compute_dtype)
        + _recurrent_gates(params, h, h_dropout_mask, compute_dtype)
        + params["b"]
    )
    h_new, c_new = _gates_to_hc(gates, c)
    return (h_new, c_new), h_new


def _stream_projection(params, xs, compute_dtype):
    """``xs @ wx + b`` in f32, then in the kernel's stream dtype (bf16
    under bf16 compute, rounded after the bias)."""
    xw = dot_f32(xs, params["wx"], compute_dtype) + params["b"]
    if compute_dtype == torch.bfloat16:
        xw = xw.to(torch.bfloat16)
    return xw


def lstm_scan(
    params: dict,
    xs: torch.Tensor,  # (T, B, F)
    lengths: torch.Tensor | None = None,  # (B,)
    initial_state: tuple[torch.Tensor, torch.Tensor] | None = None,
    h_dropout_mask: torch.Tensor | None = None,  # (B, H)
    compute_dtype=torch.float32,
    use_pallas: bool | str = False,
):
    """Unidirectional LSTM over time: ``(outputs (T, B, H), (h, c))``.

    ``use_pallas`` (True, or ``'bi_grid'``, which means the same for one
    direction) runs the recurrence as one kernel launch
    (:func:`~.lstm_kernels.fused_lstm_recurrence`); outputs then come
    back in the stream dtype.  Otherwise a step loop with f32 outputs.
    """
    check_use_pallas(use_pallas)
    T, B, _ = xs.shape
    H = params["wh"].shape[0]
    dev = xs.device
    if initial_state is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=dev)
        c0 = torch.zeros((B, H), dtype=torch.float32, device=dev)
    else:
        h0, c0 = initial_state

    if use_pallas:
        xw = _stream_projection(params, xs, compute_dtype)
        mask = (
            h_dropout_mask if h_dropout_mask is not None
            else torch.ones((B, H), dtype=torch.float32, device=dev)
        )
        lens = (
            lengths if lengths is not None
            else torch.full((B,), T, dtype=torch.int32, device=dev)
        )
        outputs, h_f, c_f = fused_lstm_recurrence(
            xw, params["wh"], lens.to(torch.int32).contiguous(),
            h0.float().contiguous(), c0.float().contiguous(),
            mask.float().contiguous(),
        )
        return outputs, (h_f, c_f)

    xw = dot_f32(xs, params["wx"], compute_dtype) + params["b"]  # (T, B, 4H)
    h, c = h0, c0
    outputs = []
    for t in range(T):
        gates = xw[t] + _recurrent_gates(params, h, h_dropout_mask, compute_dtype)
        h_new, c_new = _gates_to_hc(gates, c)
        if lengths is not None:
            valid = (t < lengths)[:, None]
            h_new = torch.where(valid, h_new, h)
            c_new = torch.where(valid, c_new, c)
            outputs.append(torch.where(valid, h_new, 0.0))
        else:
            outputs.append(h_new)
        h, c = h_new, c_new
    return torch.stack(outputs), (h, c)


def reverse_padded(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence's valid prefix in place, keeping padding at
    the tail (the reference's model-input reversal).  ``xs`` is
    time-major (T, B, ...)."""
    T = xs.shape[0]
    t = torch.arange(T, device=xs.device)[:, None]  # (T, 1)
    lens = lengths.to(device=xs.device, dtype=t.dtype)[None, :]
    # index of the element that lands at position t: length-1-t when
    # valid, t itself in the padding region
    src = torch.where(t < lens, lens - 1 - t, t)  # (T, B)
    idx = src.reshape(src.shape + (1,) * (xs.dim() - 2)).expand_as(xs)
    return torch.gather(xs, 0, idx)


def bidirectional_lstm(
    params_fwd: dict,
    params_bwd: dict,
    xs: torch.Tensor,  # (T, B, F)
    lengths: torch.Tensor,
    h_dropout_masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    compute_dtype=torch.float32,
    use_pallas: bool | str = False,
):
    """Forward scan + backward scan, outputs concatenated on features:
    ``(outputs (T, B, 2H), (h, c) each (B, 2H))``.

    ``use_pallas=True`` takes the gather-free path: the backward direction
    runs the kernel reversed in time (zero initial state), so outputs
    land at their absolute positions and no sequence is reversed; one
    K1f launch per direction.  ``use_pallas='bi_grid'`` projects both
    directions' inputs, then runs both chains in ONE launch
    (:func:`~.lstm_kernels.fused_bilstm_grid`: K4f, adjoint K4b).
    ``False`` runs the step loops over the valid-prefix-reversed input.
    """
    check_use_pallas(use_pallas)
    mask_f, mask_b = h_dropout_masks if h_dropout_masks else (None, None)
    if use_pallas:
        T, B, _ = xs.shape
        H = params_fwd["wh"].shape[0]
        dev = xs.device
        lens = (
            lengths if lengths is not None
            else torch.full((B,), T, dtype=torch.int32, device=dev)
        ).to(torch.int32).contiguous()
        zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
        ones = torch.ones((B, H), dtype=torch.float32, device=dev)

        def unit(mask):
            return (mask if mask is not None else ones).float().contiguous()

        if use_pallas == "bi_grid":
            out, h, c = fused_bilstm_grid(
                _stream_projection(params_fwd, xs, compute_dtype),
                _stream_projection(params_bwd, xs, compute_dtype),
                params_fwd["wh"], params_bwd["wh"], lens, unit(mask_f), unit(mask_b),
            )
            return out, (h, c)

        def run(p, mask, reverse_time):
            xw = _stream_projection(p, xs, compute_dtype)
            return fused_lstm_recurrence(
                xw, p["wh"], lens, zeros, zeros, unit(mask),
                reverse_time=reverse_time,
            )

        out_f, h_f, c_f = run(params_fwd, mask_f, False)
        out_b, h_b, c_b = run(params_bwd, mask_b, True)
        return torch.cat([out_f, out_b], dim=-1), (
            torch.cat([h_f, h_b], dim=-1),
            torch.cat([c_f, c_b], dim=-1),
        )
    out_f, (h_f, c_f) = lstm_scan(
        params_fwd, xs, lengths, None, mask_f, compute_dtype
    )
    xs_rev = reverse_padded(xs, lengths)
    out_b_rev, (h_b, c_b) = lstm_scan(
        params_bwd, xs_rev, lengths, None, mask_b, compute_dtype
    )
    out_b = reverse_padded(out_b_rev, lengths)
    return torch.cat([out_f, out_b], dim=-1), (
        torch.cat([h_f, h_b], dim=-1),
        torch.cat([c_f, c_b], dim=-1),
    )
