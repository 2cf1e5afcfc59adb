"""pathm.trisolve_ms: device ms a profiled query of the program's
``decode.trisolve`` span (``core/coding.decode_systematic``: both pairs of
triangular solves, the residual G_S z, the refinement and the final
select)."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "decode.trisolve")
