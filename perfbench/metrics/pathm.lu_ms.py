"""pathm.lu_ms: device ms a profiled query of the program's ``decode.lu``
span (``core/coding.decode_systematic``, the sized reduced solve):
``lu_factor_ex`` of the s x s system M, s = e rounded up to 128, and the
row order from ``lu_unpack``. Empty, no LU, where e is 0 or fewer than k
rows survived."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "decode.lu")
