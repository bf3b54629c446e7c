"""K1f and K1b in the training step: the sum of their launches' least
times (``yardstick/bounds.py`` at the step's shapes; K1f writes ``c_seq``
for the backward) over their device time, in percent."""

from benchmark.yardstick.bounds import k1b_ms, k1f_ms
from benchmark.yardstick.categories import category


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.model["encoder_type"] == "conformer":
        return None
    B, T, sizes = ctx.batch(), ctx.encoder_steps(), ctx.model["rnn_sizes"]
    per = {"K1f": sum(k1f_ms(B, T, H, c_seq=True) for H in sizes) / len(sizes),
           "K1b": sum(k1b_ms(B, T, H) for H in sizes) / len(sizes)}
    bound = sum(ms * ctx.trace.count(lambda n, k=k: category(n) == k) for k, ms in per.items())
    seconds = ctx.trace.seconds(lambda n: category(n) in per)
    return 100.0 * 1e-3 * bound / seconds if seconds > 0 else None
