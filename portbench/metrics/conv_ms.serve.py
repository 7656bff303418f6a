"""conv_ms.serve: device ms a request launched inside the program's
cnn.conv span (models/layers.py Conv; an eval forward has no backward)."""

SPANS = ("cnn.conv", "cnn.conv.backward")


def read(view):
    if view.kind != "serve":
        return None
    ops = {id(o): o for name in SPANS for o in view.launched_in(name)}
    return view.ms_per_unit(ops.values()) if ops else None
