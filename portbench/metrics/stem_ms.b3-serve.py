"""stem_ms.b3-serve: device ms a request launched inside the program's
cnn.stem span (models/backbones.py folded_stem: the preprocessing folded
into the stem conv, and the stem BatchNorm)."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "serve", "cnn.stem")
