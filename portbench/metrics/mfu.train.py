"""mfu.train: the training step's counted operations (the reference
badwinner2's forward and backward by FlopCounterMode, and K1's) over the
traced window, as a percent of the H100's bf16 dense peak."""

from portbench import readers


def read(view):
    return readers.mfu(view, "train")
