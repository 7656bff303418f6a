"""conv_ms.train: device ms a step launched inside the program's cnn.conv
and cnn.conv.backward spans (models/layers.py Conv, forward and backward),
each operation counted once."""

SPANS = ("cnn.conv", "cnn.conv.backward")


def read(view):
    if view.kind != "train":
        return None
    ops = {id(o): o for name in SPANS for o in view.launched_in(name)}
    return view.ms_per_unit(ops.values()) if ops else None
