"""K2f in the assessment decode: the sum of its launches' least times
(``yardstick/bounds.py`` at the call's shapes) over its device time, in
percent."""

from benchmark.yardstick.bounds import attention_ms, band_pairs
from benchmark.yardstick.categories import category


def read(ctx):
    if ctx.kind != "assess" or ctx.trace is None or ctx.model["encoder_type"] != "conformer":
        return None
    conf, T = ctx.model["conformer"], ctx.encoder_steps()
    per = attention_ms(ctx.batch(), T, int(conf["model_dim"]), int(conf["num_heads"]),
                       band_pairs(T, int(conf["chunk_size"]), int(conf["left_context"])))["K2f"]
    is_k2f = lambda n: category(n) == "K2f"  # noqa: E731
    seconds = ctx.trace.seconds(is_k2f)
    return 100.0 * 1e-3 * per * ctx.trace.count(is_k2f) / seconds if seconds > 0 else None
