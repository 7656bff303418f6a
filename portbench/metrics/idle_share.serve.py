"""idle_share.serve: percent of the traced window with no operation on the
card."""

from portbench import readers


def read(view):
    return readers.idle_share(view, "serve")
