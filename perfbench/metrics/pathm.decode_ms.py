"""pathm.decode_ms: device ms a profiled query of the program's
``pathm.decode`` span (``core/coded_matvec.DecodePipeline.decode``:
``masked_decode``'s scatter into coded-row order and the survivors' mark,
then the erasure solve)."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "pathm.decode")
