"""device_idle_pct (device trace): the share of the traced window (the
overlapped schedule, as the end-to-end runs have it) in which no kernel,
copy or fill ran on the card: 100 (1 - busy / window)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t.get("window_s") else None
