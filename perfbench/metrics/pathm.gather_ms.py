"""pathm.gather_ms: device ms a profiled query of the program's
``decode.gather`` span (``core/coding.decode_systematic``: the
survivors-first argsort, the (k, k) G_S gather and y_S)."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "decode.gather")
