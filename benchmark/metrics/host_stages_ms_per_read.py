"""host_stages_ms_per_read (program counter): Core.event_time +
Core.normalise_time, the events (ops/events.py), the polyA scan
(ops/jnn.py) and the query window's z-score (pipeline._event_single,
_normalise_single), per record, from the profile=True passes."""


def read(ctx):
    s = ctx.stages
    return 1e3 * (s["event_s"] + s["normalise_s"]) / s["reads"] if s and s["reads"] else None
