"""sdtw_device_ms_per_read (program span): the device time of the sDTW
routes, Core.span_seconds("oneshot") + ("chunked"): CUDA events around
each batch's device work in Core.sdtw_candidates_submit (the one-shot
wavefront and its clip pass, or the carry chain and its folds), per
record, from the profile=True passes."""


def read(ctx):
    s = ctx.stages
    return 1e3 * s["sdtw_device_s"] / s["reads"] if s and s["reads"] and s["sdtw_device_s"] else None
