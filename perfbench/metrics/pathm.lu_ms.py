"""pathm.lu_ms: device ms a profiled query of the program's ``decode.lu``
span (``core/coding.decode_systematic``: ``lu_factor_ex`` of G_S and the
row permutation from ``lu_unpack``)."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "decode.lu")
