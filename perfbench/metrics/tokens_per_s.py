"""tokens_per_s: output tokens of the requests each ``serve`` call of the
window finished, over the summed wall time of those calls, every call
whole and ending synchronised with the card (host clock)."""


def read(cx):
    wall = sum(c.wall for c in cx.window)
    return sum(c.tokens for c in cx.window) / wall if wall > 0 else None
