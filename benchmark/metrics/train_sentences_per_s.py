"""Training sentences per second (host clock): every sentence of the steps
completed in the window over the window's time up to the read-back that
ends its last segment."""


def read(ctx):
    return ctx.sentences_per_s() if ctx.kind == "train" else None
