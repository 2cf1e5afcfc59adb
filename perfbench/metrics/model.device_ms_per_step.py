"""model.device_ms_per_step: device ms of every operation in the profiled
dispatches but B1, B2 and the erasure solve (the model's layers, the
prefill chunks' attention, the casts and copies, the unembedding) per
decode step."""
from perfbench import served

OTHERS = (r"pipe_sgemm_kernel|split_sum_kernel|narrow_matvec_kernel"
          r"|paged_decode_(split|combine)_kernel"
          r"|getrf|getf2|trsm|trsv|laswp|magma|cusolver|ipiv")


def read(cx):
    steps = served.steps(cx)
    if not steps or not cx.profile.busy_s > 0:
        return None
    return cx.profile.seconds(exclude=OTHERS) * 1e3 / steps
