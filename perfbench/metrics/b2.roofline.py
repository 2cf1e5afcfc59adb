"""b2.roofline: B2 (``kernels/paged_attention``, its split and combine
launches) in the profiled dispatches, as a share of its roofline: the
least time of the attends those dispatches needed (per layer and decode
step, every decoding slot's valid KV entries, positions 0 .. pos, read
once; q read and the output written once) over B2's device time."""
from perfbench import roofline, served

KERNELS = r"paged_decode_(split|combine)_kernel"


def read(cx):
    work = served.work(cx)
    if work is None:
        return None
    c = cx.config
    d, heads, kv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim", d // heads)
    bound = 0.0
    for disp in work:
        for t in range(disp.steps):
            entries = sum(p + t + 1 for p in disp.decode)
            flops, nbytes = roofline.paged_decode_work(entries, len(disp.decode), kv,
                                                       heads // kv, hd, 2)
            bound += c["num_hidden_layers"] * roofline.bound_ms(nbytes, flops, "bfloat16")[0]
    return roofline.share(bound, cx.profile.seconds(KERNELS) * 1e3)
