"""b1.roofline.serve: B1 (``kernels/coded_matvec``: the split-K GEMM and its
split sum) at the coded head in the profiled dispatches, as a share of its
roofline: per coded round, the (nb, kb) generator times the (kb, slots x
block_rows) logit blocks, float32, over B1's device time."""
from perfbench import roofline, served

KERNELS = r"pipe_sgemm_kernel|split_sum_kernel|narrow_matvec_kernel"


def read(cx):
    rounds = served.steps(cx)
    if not rounds or getattr(cx, "head_shape", None) is None:
        return None
    nb, kb, rows = cx.head_shape
    flops, nbytes = roofline.head_mix_work(nb, kb, int(cx.mix["slots"]), rows)
    bound = rounds * roofline.bound_ms(nbytes, flops, "float32")[0]
    return roofline.share(bound, cx.profile.seconds(KERNELS) * 1e3)
