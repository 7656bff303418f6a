"""norm_ms.serve: device ms a request launched inside the program's
cnn.norm span (models/layers.py KerasBatchNorm in eval mode)."""

SPANS = ("cnn.norm", "cnn.norm.backward")


def read(view):
    if view.kind != "serve":
        return None
    ops = {id(o): o for name in SPANS for o in view.launched_in(name)}
    return view.ms_per_unit(ops.values()) if ops else None
