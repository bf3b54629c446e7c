"""Assessment sentences per second (host clock): every sentence decoded in
the window, its tokens read back to the host, over the window's time."""


def read(ctx):
    return ctx.sentences_per_s() if ctx.kind == "assess" else None
