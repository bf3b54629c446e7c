"""The least time of a kernel launch on one H100: a frozen copy.

The bound arithmetic of ``chip_smoke.py`` (``_bound``, ``_bwd_bound``,
``_attention_bounds``) as it stood when the benchmark was defined: the
larger of the launch's operations at the card's peak for its type and the
bytes it must move at the HBM rate, each input read once and each output
written once (attention: only the (query, key) pairs the band admits).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense, 700 W
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _ms(flops: float, nbytes: float, es: int) -> float:
    peak = PEAK_BF16_FLOPS if es == 2 else PEAK_F32_FLOPS
    return 1e3 * max(flops / peak, nbytes / PEAK_HBM_BYTES)


def k1f_ms(B: int, T: int, H: int, es: int = 2, c_seq: bool = False) -> float:
    """K1f, one direction over T steps: ``xw``, ``wh``, lengths, h0, c0 and
    the mask read; ``h_seq`` (and ``c_seq`` under training), hT, cT
    written."""
    flops = 2.0 * T * B * H * 4 * H
    nbytes = (T * B * 4 * H * es + H * 4 * H * es + 4 * B + 3 * B * H * 4
              + (2 if c_seq else 1) * T * B * H * es + 2 * B * H * 4)
    return _ms(flops, nbytes, es)


def k1b_ms(B: int, T: int, H: int, es: int = 2) -> float:
    """K1b: both products a step; xw, hprev, cprev, cseq, dhseq, wh,
    lengths, mask, dhT, dcT read; dgates, dh0, dc0 written."""
    flops = 4.0 * T * B * H * 4 * H
    nbytes = (2 * T * B * 4 * H * es + 4 * T * B * H * es + H * 4 * H * es + 4 * B
              + 5 * B * H * 4)
    return _ms(flops, nbytes, es)


def band_pairs(T: int, chunk: int, left: int) -> int:
    """The (query, key) pairs of one row and head that chunk-causal
    attention over ``T`` valid steps admits: a query sees its chunk and
    ``left`` chunks before it."""
    pairs = 0
    for t in range(T):
        c = t // chunk
        first = max(0, (c - left) * chunk)
        last = min(T, (c + 1) * chunk)
        pairs += last - first
    return pairs


def attention_ms(B: int, T: int, D: int, heads: int, pairs: int, es: int = 2) -> dict:
    """K2f, K2b-dq and K2b-dkv over a (B, T, D) sequence of ``heads``
    heads; ``pairs`` of one row and head (:func:`band_pairs`)."""
    Dh = D // heads
    seq, rows = B * T * D * es, B * T * heads * 4  # one (B, T, D) tensor; one lse
    total = B * pairs
    work = {
        "K2f": (4 * seq + rows + 4 * B, 4 * Dh * heads * total),
        "K2b-dq": (5 * seq + 2 * rows + 4 * B, 6 * Dh * heads * total),
        "K2b-dkv": (6 * seq + 2 * rows + 4 * B, 8 * Dh * heads * total),
    }
    return {name: _ms(ops, nbytes, es) for name, (nbytes, ops) in work.items()}
