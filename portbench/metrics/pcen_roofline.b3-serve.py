"""pcen_roofline.b3-serve: percent, pcen_kernel's least time
(counts/k1.py bound_s: its bytes, operations and transcendentals at the
H100's peaks) over its measured time."""

from portbench import spans


def read(view):
    return spans.pcen_roofline(view, "serve")
