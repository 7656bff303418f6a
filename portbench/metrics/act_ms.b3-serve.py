"""act_ms.b3-serve: device ms a request launched inside the program's
cnn.act span (models/layers.py silu) and outside cnn.se, whose SiLU
se_ms.b3-serve counts."""

from portbench import spans


def read(view):
    return spans.span_less(view, "serve", "cnn.act", "cnn.se")
