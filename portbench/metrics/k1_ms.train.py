"""k1_ms.train: device ms a step of K1's kernels, by name, where the trace
holds every mel launch the program counted."""

from portbench import readers


def read(view):
    return readers.k1_ms(view, "train")
