"""parse_ms_per_read (program counter): Core.parse_time, the decode of each
batch's BLOW5 records (io/blow5.py, native/, pipeline._parse_single), per
record, from the traced run's profile=True passes (each batch drained
before the next, so the stage runs alone)."""


def read(ctx):
    s = ctx.stages
    return 1e3 * s["parse_s"] / s["reads"] if s and s["reads"] else None
