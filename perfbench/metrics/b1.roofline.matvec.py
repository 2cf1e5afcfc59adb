"""b1.roofline.matvec: B1's narrow branch on Path M in the profiled queries,
as a share of its roofline: the packed (W, max_load, d) float32 A~ read
once, x read and the products written, over 3.35 TB/s, against B1's
device time."""
from perfbench import roofline

KERNELS = r"narrow_matvec_kernel|pipe_sgemm_kernel|split_sum_kernel"


def read(cx):
    p = getattr(cx, "profile", None)
    if p is None:
        return None
    flops, nbytes = roofline.packed_matvec_work(cx.plan.num_workers, cx.plan.max_load,
                                                int(cx.config["d"]))
    bound = cx.profiled_queries * roofline.bound_ms(nbytes, flops, "float32")[0]
    return roofline.share(bound, p.seconds(KERNELS) * 1e3)
