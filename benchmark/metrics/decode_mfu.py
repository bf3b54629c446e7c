"""The whole assessment decode's share of the card's dense bf16 peak: one
forward pass a sentence at ``max_dec_len`` decoder steps
(``yardstick/flops.py``) × the window's sentences a second ÷ 989e12.  A
fraction."""

from benchmark.yardstick.flops import H100_BF16_PEAK_FLOPS, seq2seq_forward_flops


def read(ctx):
    if ctx.kind != "assess":
        return None
    flops = seq2seq_forward_flops(ctx.model, int(ctx.traffic["samples"]))
    return flops * ctx.sentences_per_s() / H100_BF16_PEAK_FLOPS
