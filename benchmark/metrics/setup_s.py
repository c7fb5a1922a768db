"""setup_s (host clock): from the process's start to the window's start,
less the time the benchmark takes to make the inputs from the seed:
imports, the mapper's state and two batches through every kernel (which
builds them in a fresh checkout)."""


def read(ctx):
    return ctx.setup_s
