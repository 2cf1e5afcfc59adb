"""matvec_p95_ms: the 95th percentile, over every query of the window, of a
coded query's wall: x on the card to z and ok ready after a synchronise
(host clock; numpy's linear interpolation between order statistics)."""
import numpy as np


def read(cx):
    walls = [q[-1] for q in cx.window]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
