"""pathm.trisolve_ms: device ms a profiled query of the program's
``decode.trisolve`` span (``core/coding.decode_systematic``, the sized
reduced solve): on M's factors, both pairs of triangular solves, the
residual M z_E and the refinement, then z_E scattered into y on the
surviving systematic rows. Where e is 0 or fewer than k rows survived,
no solve: z is y, or zero."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "decode.trisolve")
