"""conv_ms.b3-serve: device ms a request launched inside the program's
cnn.conv span (models/layers.py Conv with groups 1) and outside cnn.se, whose
1x1 convs se_ms.b3-serve counts."""

from portbench import spans


def read(view):
    return spans.span_less(view, "serve", "cnn.conv", "cnn.se")
