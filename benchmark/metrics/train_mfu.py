"""The whole training step's share of the card's dense bf16 peak: model
FLOPs a sentence (``yardstick/flops.py``, three forward passes at the
traffic's samples and decoder tokens) × the window's sentences a second ÷
989e12.  A fraction."""

from benchmark.yardstick.flops import H100_BF16_PEAK_FLOPS, train_step_flops


def read(ctx):
    if ctx.kind != "train":
        return None
    flops = train_step_flops(ctx.model, int(ctx.traffic["samples"]),
                             int(ctx.traffic["decoder_tokens"]))
    return flops * ctx.sentences_per_s() / H100_BF16_PEAK_FLOPS
