"""depthwise_ms.b3-serve: device ms a request launched inside the
program's cnn.depthwise span (models/layers.py Conv with groups > 1)."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "serve", "cnn.depthwise")
