"""matvec_p95_ms: the 95th percentile, over every query of the window, of a
coded query's wall: x on the card to z and ok ready after a synchronise
(host clock; numpy's linear interpolation between order statistics). The
matvec driver's ``Window`` keeps every query's wall as a host float."""
import numpy as np


def read(cx):
    walls = cx.window.walls
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
