"""serve.mfu: model FLOPs of the tokens the profiled dispatches processed
(prompt tokens of the prefill chunks and decoded tokens: 2 x the layers'
parameters, attention over each token's context, and for a decoded token
the head's 2 V d; the coding's extra work not counted), over the window
times the card's bfloat16 peak, in percent."""
from perfbench import roofline, served


def read(cx):
    work = served.work(cx)
    if work is None or not cx.profile.busy_s > 0:
        return None
    c = cx.config
    flops = 0.0
    for disp in work:
        for start, take in disp.prefill:
            flops += sum(roofline.token_flops(c, start + i + 1, decoded=False)
                         for i in range(take))
        for p in disp.decode:
            flops += sum(roofline.token_flops(c, p + t + 1, decoded=True)
                         for t in range(disp.steps))
    return 100.0 * flops / (cx.profile.window_s * roofline.PEAK_FLOPS["bfloat16"])
