"""setup_s: seconds from the harness's start to the window's start, the
kernels' load or build, the weights, the program's set-up and the
warm-up of every program the cell's traffic uses (host clock)."""


def read(cx):
    return cx.setup_s
