"""mfu.serve: a request's counted operations (the reference CNN's forward
by FlopCounterMode, and K1's) over the traced window, as a percent of
the H100's bf16 dense peak."""

from portbench import readers


def read(view):
    return readers.mfu(view, "serve")
