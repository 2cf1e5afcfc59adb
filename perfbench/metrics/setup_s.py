"""setup_s: seconds from the end of the card check to the window's start
(host clock): the sum of the set-up phases marked after ``card``, i.e. the
harness's and the program's imports, the kernels' load or build, the
weights or inputs, the program's set-up and the warm-up of every program
the cell's traffic uses. ``import torch`` and the card check, which also
makes the card's CUDA context, come before it and are not counted, since
no change to the program can move them; standard error still gives them
as ``setup torch`` and ``setup card``, beside the phases counted after
them."""


def read(cx):
    names = list(cx.setup_phases)
    if "card" not in names:
        return None
    return sum(cx.setup_phases[p] for p in names[names.index("card") + 1:])
