"""peak_mem_gb.train: the allocator's peak over the window, GB."""

from portbench import readers


def read(view):
    return readers.peak_mem_gb(view, "train")
