"""sdtw_roofline_pct (device trace): the least time of the DP cells that
the window's reads need, over the device time of every kernel launched
inside Core.sdtw_candidates_submit (the harness's `sdtw_submit` range:
the sDTW kernel, the candidate folds and the clip pass), in %.

The cells a read needs are its query length (qlen) times the
reference's columns, padding not counted. The operations of a cell,
fixed here for every engine, from the recurrence
c = |x - y| + min(up, left, diag) with a free start:
  d = x - y            1 float32 subtraction
  m = min(up, left)    1 minimum
  m = min(m, diag)     1 minimum
  c = |d| + m          1 addition (|d| an operand modifier of the add)
4 operations; a cell of row 0 is c = |d|, 2 operations (the subtraction
and one that applies |.|). So a read of qlen rows needs
columns x (4 (qlen - 1) + 2) operations, and the least time is that over
the card's float32 issue rate (roofline.py: SMs x 128 x max SM clock).
"""

OPS_PER_CELL = 4
OPS_ROW0 = 2


def read(ctx):
    t = ctx.trace
    k = t.get("range_kernel_s", {}).get("sdtw_submit") if t else None
    if not k or not ctx.issue_rate or not ctx.sdtw_qlens:
        return None
    ops = ctx.ref_columns * sum(OPS_PER_CELL * (q - 1) + OPS_ROW0 for q in ctx.sdtw_qlens)
    return 100.0 * (ops / ctx.issue_rate) / k
