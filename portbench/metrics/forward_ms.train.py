"""forward_ms.train: device ms a step launched inside the program's
train.forward span (train/step.py: the model's forward, loss excluded)."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "train", "train.forward")
