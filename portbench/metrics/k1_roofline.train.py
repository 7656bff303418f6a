"""k1_roofline.train: K1's least time by counts/k1.py over its measured
time, percent."""

from portbench import readers


def read(view):
    return readers.k1_roofline(view, "train")
