"""The counts against counts worked by hand."""

from __future__ import annotations

import pytest

from portbench.counts import cnn, k1, peaks

GEOMETRY = {"sr": 48000, "clip_seconds": 3.0, "n_fft": 4096,
            "hop_length": 281, "n_mels": 160, "fmin": 100.0,
            "fmax": 11000.0, "break_freq": 1000.0}


def test_k1_geometry():
    assert k1.frames(GEOMETRY) == 513  # ceil(144000 / 281)
    bins, nnz = k1.bank_shape(GEOMETRY)
    assert bins == 939  # 11000 Hz / (48000 / 4096 Hz a bin) = 938.7
    # every bin from the first (100 Hz: bin 9) to the last lies in two
    # triangles, but those below the second edge or above the 160th
    assert nnz == 2 * (bins - 9) - 16
    assert k1.mel_ops_per_frame(GEOMETRY) == (
        4096 + 2.5 * 4096 * 12 + 3 * bins + 2 * nnz)


def test_k1_bounds():
    mel = k1.bound_s("mel_bf16_kernel", 128, GEOMETRY, {"mel_out_bytes": 4})
    assert mel == pytest.approx((128 * 144000 * 4 + 128 * 160 * 513 * 4)
                                / 3.35e12)  # bytes bound: 34.6 us
    exact = k1.bound_s("mel_power_kernel", 256, GEOMETRY,
                       {"mel_out_bytes": 2})
    assert exact == pytest.approx(
        256 * 513 * k1.mel_ops_per_frame(GEOMETRY) / 67e12)  # operations
    elems = 512 * 160 * 513
    pcen = k1.bound_s("pcen_kernel", 512, GEOMETRY, {"pcen_out_bytes": 2})
    assert pcen == pytest.approx(elems * 6 / 3.35e12)
    assert peaks.MUFU_S == pytest.approx(132 * 16 * 67e12 / (2 * 132 * 128))


def badwinner2_forward(frames: int, labels: int = 62) -> int:
    """2 x multiply-adds of each conv at input 160 x frames."""
    def conv(h, w, ci, co, kh, kw):
        ho, wo = h - kh + 1, w - kw + 1
        return ho, wo, 2 * ho * wo * ci * co * kh * kw

    total, h, w = 0, 160, frames
    for ci, co, kh, kw in ((1, 64, 3, 3), (64, 64, 3, 3)):
        h, w, f = conv(h, w, ci, co, kh, kw)
        total += f
    h, w = h // 3, w // 3
    for ci, co, kh, kw in ((64, 128, 3, 3), (128, 128, 3, 3),
                           (128, 128, 44, 3)):
        h, w, f = conv(h, w, ci, co, kh, kw)
        total += f
    h, w = h // 5, w // 3
    for ci, co, kh, kw in ((128, 1024, 1, 9), (1024, 1024, 1, 1),
                           (1024, labels, 1, 1)):
        h, w, f = conv(h, w, ci, co, kh, kw)
        total += f
    return total


def test_cnn_counts_match_the_hand_count():
    fwd = cnn._count("badwinner2", 62, 160, 120, 1, False)
    assert fwd == badwinner2_forward(120)
    # the backward: each conv's weight and input gradients, the first
    # conv's too, since MagTransform's trainable power lies before it
    assert cnn._count("badwinner2", 62, 160, 120, 1, True) == 3 * fwd


def test_cnn_counts_at_the_cells_shape():
    assert cnn._count("badwinner2", 62, 160, 513, 1, False) == \
        badwinner2_forward(513)
    b3 = cnn._count("efficientnetv2b3", 62, 160, 513, 3, False)
    assert 5.3e9 < b3 < 5.5e9
