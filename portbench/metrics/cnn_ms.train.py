"""cnn_ms.train: device ms a step of every operation that is not K1's, the
preprocess's or the optimizer's (forward, loss, backward, metrics)."""

from portbench import readers


def read(view):
    return readers.cnn_ms(view, "train")
