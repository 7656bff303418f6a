"""pcen_ms.b3-serve: device ms a request of K1's pcen_kernel alone, where
the trace holds every launch the program counted."""

from portbench import spans


def read(view):
    return spans.pcen_ms(view, "serve")
