"""se_ms.b3-serve: device ms a request launched inside the program's cnn.se
span (models/backbones.py SqueezeExcite, its two 1x1 convs and SiLU
included)."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "serve", "cnn.se")
