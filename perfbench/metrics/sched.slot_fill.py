"""sched.slot_fill: tokens emitted to any stream over decode steps x slots
in the window's ``serve`` calls (the program's ``ServeReport`` counts), in
percent: how full the scheduler keeps the decode batch."""


def read(cx):
    steps = sum(c.decode_rounds for c in cx.window) * int(cx.mix["slots"])
    return 100.0 * sum(c.decoded for c in cx.window) / steps if steps else None
