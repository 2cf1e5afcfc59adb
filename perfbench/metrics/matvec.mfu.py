"""matvec.mfu: a query's least time over its time, in percent. The least
time is the workers' products alone: the packed A~ read once (bytes over
3.35 TB/s) against 2 x rows x d float32 FLOPs over 67 TFLOP/s. The
decode's least work depends on which workers missed the deadline and is
counted as zero, so whatever later implements the decode, this share
reads the same work and cannot pass 100%. A query's time is the profiled
window over its queries."""
from perfbench import roofline


def read(cx):
    p = getattr(cx, "profile", None)
    if p is None or not p.busy_s > 0:
        return None
    flops, nbytes = roofline.packed_matvec_work(cx.plan.num_workers, cx.plan.max_load,
                                                int(cx.config["d"]))
    least = roofline.bound_ms(nbytes, flops, "float32")[0] * 1e-3
    return 100.0 * least * cx.profiled_queries / p.window_s
