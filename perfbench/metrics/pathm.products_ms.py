"""pathm.products_ms: device ms a profiled query of the program's
``pathm.products`` span (``core/coded_matvec.coded_matvec``: B1's launch
over the packed A~, and with a mesh its all-gather)."""
from perfbench import stages


def read(cx):
    return stages.device_ms(cx, "pathm.products")
