"""peak_mem_gb (host clock run): torch.cuda.max_memory_allocated() over
the window, reset at its start, in 1e9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
