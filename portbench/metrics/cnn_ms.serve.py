"""cnn_ms.serve: device ms a request of every operation that is not K1's or
the preprocess's."""

from portbench import readers


def read(view):
    return readers.cnn_ms(view, "serve")
