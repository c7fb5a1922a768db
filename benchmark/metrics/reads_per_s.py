"""reads_per_s (host clock): every record that run_dtw finished in the
window (mapped, unmapped, prefix-fail, too short) over the window's
seconds, from its first pass's start to the end of its last."""


def read(ctx):
    return ctx.reads_done / ctx.window_s if ctx.window_s > 0 and ctx.reads_done else None
