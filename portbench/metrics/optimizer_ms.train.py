"""optimizer_ms.train: device ms a step launched inside PyTorch's
Optimizer.step#Adam.step range."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "train", readers.OPTIMIZER)
