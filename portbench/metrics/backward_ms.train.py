"""backward_ms.train: device ms a step launched inside the program's
train.backward span (train/step.py: loss.backward(), the autograd
thread's launches included)."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "train", "train.backward")
