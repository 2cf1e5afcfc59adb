"""device.idle_share.matvec: percent of the profiled window (a few queries
back to back) in which no operation ran on the card."""


def read(cx):
    p = getattr(cx, "profile", None)
    if p is None or not p.busy_s > 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
