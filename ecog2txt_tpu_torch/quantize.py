"""Post-training int8 quantization for the conformer's serving paths.

The twin of ``ecog2txt_tpu/quantize.py``: a serving-time rewrite of a
trained conformer parameter tree (training stays bf16/f32), dispatched
by leaf type inside the model (``models.conformer._dot``).

* Weights: symmetric per-output-channel int8, ``scale[j] = max_i
  |w[i, j]| / 127``, stored once.
* Activations: symmetric per-token dynamic int8, each (..., D) row by its
  own abs-max at run time.
* The product accumulates in int32; the result is ``(acc * row_scale) *
  col_scale`` in f32, cast to the stream dtype.  LayerNorm, softmax, the
  attention core and the depthwise conv stay in the float path, as do
  the expert-stacked (E, ., .) weights of a MoE FFN.

On a CUDA tensor the product is ``torch._int_mm`` (int8 x int8 → int32 on
the tensor cores; a plain GEMM, which the JAX package also computes
outside any Pallas kernel), with the operands padded by zero rows and
columns to the shapes it takes: more than 16 rows, inner and outer
dimensions multiples of 8 (the conformer's ``in_proj`` has K = 100).
Zero padding leaves the int32 sums exact.  On a CPU tensor the product
runs in float64, which is exact here (``|sum| <= 127^2 * K < 2^53``), so
the sums equal the JAX package's ``dot_general(preferred_element_type=
int32)`` bit for bit.  There is no float product on a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class QuantizedWeight(NamedTuple):
    """Per-output-channel symmetric int8 weight: ``q`` (in, out) int8 and
    ``scale`` (out,) f32.  A NamedTuple, so ``convert.tree_map`` keeps it
    whole while it moves its tensors."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8 quantization of an (in, out)
    dense weight."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)  # (out,)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    # stored column-major, the layout the card's int8 GEMM reads
    return QuantizedWeight(q=_column_major(q), scale=scale)


def dequantize_weight(qw: QuantizedWeight) -> torch.Tensor:
    return qw.q.float() * qw.scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8: (q int8 like ``x``, scales
    (..., 1) f32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def _pad_to(n: int, multiple: int) -> int:
    return (-n) % multiple


def _column_major(b: torch.Tensor) -> torch.Tensor:
    return b if b.t().is_contiguous() else b.t().contiguous().t()


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) → int32 (M, N), exact.  On a CUDA tensor
    ``torch._int_mm`` with zero padding to 24 rows below 17 and to
    multiples of 8 in K and N (the second operand column-major, the layout
    its int8 GEMM takes); on a CPU tensor a float64 product."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    if not a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    pm = 24 - M if M <= 16 else 0
    pk, pn = _pad_to(K, 8), _pad_to(N, 8)
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), _column_major(b))
    int8_mm.launches += 1
    return out[:M, :N] if (pm or pn) else out


int8_mm.launches = 0


def int8_dot(x: torch.Tensor, qw: QuantizedWeight, cd=torch.float32) -> torch.Tensor:
    """``x @ w`` with dynamic per-token int8 activations against an int8
    weight; returns the stream dtype ``cd``.  ``x``: (..., in_dim)."""
    xq, xs = quantize_rows(x)
    lead = x.shape[:-1]
    acc = int8_mm(xq.reshape(-1, x.shape[-1]), qw.q)
    acc = acc.reshape(*lead, acc.shape[-1])
    return (acc.float() * xs * qw.scale).to(cd)


# the conformer-block dense weights that take int8 (models/conformer.py
# product sites); biases, LayerNorms and the depthwise taps stay float
_BLOCK_KEYS = {
    "ffn1": ("w1", "w2"),
    "ffn2": ("w1", "w2"),
    "attn": ("wqkv", "wo"),
    "conv": ("pw1", "pw2"),
}


def quantize_conformer_params(params: dict) -> dict:
    """Rewrite a conformer encoder tree (``params['encoder']['conformer']``
    of a seq2seq tree, or that subtree itself) so that ``in_proj`` and
    every 2-D block weight of ``_BLOCK_KEYS`` become
    :class:`QuantizedWeight` s; a MoE ffn2's expert-stacked 3-D weights
    stay float.  The float weights it replaces are dropped."""
    nested = "encoder" in params and isinstance(params["encoder"], dict) \
        and "conformer" in params["encoder"]
    conf = params["encoder"]["conformer"] if nested else params

    new_conf = dict(conf)
    new_conf["in_proj"] = dict(conf["in_proj"])
    new_conf["in_proj"]["w"] = quantize_weight(conf["in_proj"]["w"])
    blocks = []
    for block in conf["blocks"]:
        nb = dict(block)
        for mod, keys in _BLOCK_KEYS.items():
            nm = dict(block[mod])
            for k in keys:
                w = block[mod].get(k)
                if isinstance(w, torch.Tensor) and w.dim() == 2:
                    nm[k] = quantize_weight(w)
            nb[mod] = nm
        blocks.append(nb)
    new_conf["blocks"] = blocks
    if not nested:
        return new_conf
    out = dict(params)
    out["encoder"] = dict(params["encoder"])
    out["encoder"]["conformer"] = new_conf
    return out


def is_quantized(tree) -> bool:
    """Whether any subtree of ``tree`` is a :class:`QuantizedWeight`."""
    if isinstance(tree, QuantizedWeight):
        return True
    if isinstance(tree, dict):
        return any(is_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_quantized(v) for v in tree)
    return False
