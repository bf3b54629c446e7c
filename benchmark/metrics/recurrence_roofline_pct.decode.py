"""K1f in the assessment decode: the sum of its launches' least times
(``yardstick/bounds.py`` at the call's shapes) over its device time, in
percent."""

from benchmark.yardstick.bounds import k1f_ms
from benchmark.yardstick.categories import category


def read(ctx):
    if ctx.kind != "assess" or ctx.trace is None or ctx.model["encoder_type"] == "conformer":
        return None
    B, T, sizes = ctx.batch(), ctx.encoder_steps(), ctx.model["rnn_sizes"]
    per = sum(k1f_ms(B, T, H) for H in sizes) / len(sizes)
    is_k1f = lambda n: category(n) == "K1f"  # noqa: E731
    seconds = ctx.trace.seconds(is_k1f)
    return 100.0 * 1e-3 * per * ctx.trace.count(is_k1f) / seconds if seconds > 0 else None
