"""pathm.gather_ms: device ms a profiled query of the program's
``decode.gather`` span (``core/coding.decode_systematic``, the sized
reduced solve of a systematic G = [I_k; P]): the scatter of the workers'
slots into coded-row order and the mark of the surviving rows; the one
read to the host of e, the count of erased systematic rows, and whether k
rows survived; and, where there is a solve, the system at s = e rounded
up to 128 rows (E and R by stable argsorts cut to s, y on the surviving
systematic rows, the s gathered rows of P and their GEMV, M = P[R, E]
with the identity past e, and b)."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "decode.gather")
