"""host_idle_ms.serve: ms a unit of the traced window in which the card
was idle while one of the program's top-level spans (train.step,
preprocess, normalize, infer) was open on the host; the rest of
idle_share.serve lies outside the program, in the benchmark's client."""

from portbench.trace import gaps, union_length

TOP = ("train.step", "preprocess", "normalize", "infer")


def read(view):
    spans = [(s.start, s.end) for s in view.spans if s.name in TOP]
    if view.kind != "serve" or not view.ops or not spans:
        return None
    start, end = view.window
    idle = gaps([(o.start, o.end) for o in view.ops], start, end)
    covered = sum(union_length((max(a, s), min(b, e)) for s, e in spans
                               if s < b and e > a) for a, b in idle)
    return covered * 1e-3 / view.units
