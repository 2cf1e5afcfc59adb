"""head.solve_ms.serve: device ms of the coded head's erasure solve
(``core/coding.decode_systematic``: the library LU and its triangular
solves, by kernel name) per coded round in the profiled dispatches."""
from perfbench import served

KERNELS = r"getrf|getf2|trsm|trsv|laswp|magma|cusolver|ipiv"


def read(cx):
    rounds = served.steps(cx)
    if not rounds or getattr(cx, "head_shape", None) is None or not cx.profile.busy_s > 0:
        return None
    return cx.profile.seconds(KERNELS) * 1e3 / rounds
