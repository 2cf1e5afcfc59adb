"""decode.solve_ms.matvec: device ms per query of everything in a profiled
query but B1's products: ``core/coded_matvec.masked_decode``'s sized
reduced solve (the scatter into coded-row order and the mark, the read of
e, and where e is over 0 the s x s system, s = e rounded up to 128, its
LU, the triangular solves and the refinement)."""

KERNELS = r"narrow_matvec_kernel|pipe_sgemm_kernel|split_sum_kernel"


def read(cx):
    p = getattr(cx, "profile", None)
    if p is None or not p.busy_s > 0:
        return None
    return p.seconds(exclude=KERNELS) * 1e3 / cx.profiled_queries
