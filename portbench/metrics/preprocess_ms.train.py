"""preprocess_ms.train: device ms a step launched inside the benchmark's
preprocess marker (mixup, normalize_rows, K1)."""

from portbench import readers


def read(view):
    return readers.span_ms(view, "train", readers.PREPROCESS)
