"""Set-up seconds (host clock): process start to the end of the warm-up:
imports, the corpus and the weights made on the card, the kernels loaded
(built first in a fresh checkout), the checked first steps, the warm-up."""


def read(ctx):
    return ctx.setup_s
