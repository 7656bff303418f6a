"""K1's three-pass ``"bf16_3x"`` tier of the port on the CPU.

Each DFT product runs as hi(w) hi(x) + lo(w) hi(x) + hi(w) lo(x) over bf16
splits (hi = bf16(v), lo = bf16(v - hi)), every sum f32, power and mel in
f32.  Its plain version (``mel_power_bf16_3x``, what the wrapper computes
for a CPU tensor) is held against the JAX package's tier
(``FusedFeaturizer(precision="bf16_3x" | "bf16_3x_manual")`` in interpret
mode) and against its exact mel (``MatmulMelPlan``, "highest") at < 2e-5
global relative error, the tier's class (the TPU read 8.7e-6, bench.py:337);
on the CPU they read about 4e-6.  The CUDA kernel runs only on a card
(tests/test_torch_gpu.py); here a numpy emulation of its mma fragment walk,
driven by the same host-packed hi/lo tables, reproduces the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.ops.fftmel import MatmulMelPlan
from audio_training_tpu.ops.pallas.fused_featurizer import (
    FusedFeaturizer as JaxFusedFeaturizer,
)
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import build_mel_weights
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
from audio_training_tpu_torch.ops.pcen import pcen
from audio_training_tpu_torch.ops.stft import hann_window

from test_torch_train_featurizer import _mma, _tones

torch.set_num_threads(2)

TIER_REL = 2e-5
SHORT = 24000  # 0.5 s keeps the JAX interpret-mode kernel cheap


@pytest.fixture(scope="module")
def mel_w():
    return build_mel_weights(FeaturizerConfig())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("tier", ["bf16_3x", "bf16_3x_manual"])
def test_plain_tier_matches_jax_tier_interpret(mel_w, tier):
    raw = np.random.default_rng(1).standard_normal((2, SHORT)).astype(
        np.float32)
    want = JaxFusedFeaturizer(mel_w, 4096, 281, precision=tier)(
        jnp.asarray(raw), pcen=False, interpret=True)
    exact = MatmulMelPlan(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw))
    got = ffz.FusedFeaturizer(mel_w, 4096, 281, precision=tier,
                              device="cpu")(torch.from_numpy(raw), pcen=False)
    assert got.shape == (2, 160, -(-SHORT // 281))
    assert _rel(got, want) < TIER_REL
    assert _rel(got, exact) < TIER_REL


@pytest.mark.parametrize("kind", ["noise", "tones"])
def test_plain_tier_matches_jax_exact_mel_full_geometry(mel_w, kind):
    rng = np.random.default_rng(2)
    raw = (rng.standard_normal((2, 144000)).astype(np.float32)
           if kind == "noise" else _tones(2, 144000, 2))
    want = MatmulMelPlan(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw))
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision="bf16_3x",
                             device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False)
    assert got.shape == (2, 160, 513)
    assert _rel(got, want) < TIER_REL
    assert torch.equal(got, ffz.mel_power_bf16_3x(torch.from_numpy(raw),
                                                  fz.mel_weights, 281))


def test_split_tables_reconstruct_the_float64_operators():
    t = ffz.dft_tables_split()
    f64 = ffz._dft_tables_f64()
    for name in ("d1_re", "d1_im", "c2_re", "c2_im"):
        hi, lo = t["hi"][name], t["lo"][name]
        np.testing.assert_array_equal(hi, ffz.round_bf16(f64[name]))
        np.testing.assert_array_equal(hi, ffz.dft_tables_bf16()[name])
        np.testing.assert_array_equal(ffz.round_bf16(lo), lo)
        assert np.all(np.abs(lo) <= 2.0 ** -8 * np.abs(hi))
    # W4096^(n2 (k1 + 32 k2)) to about 16 bits from two bf16 values
    k1, n2, k2 = 5, 77, 9
    ang = 2 * np.pi * ((n2 * (k1 + 32 * k2)) % 4096) / 4096
    v = t["hi"]["c2_re"][k1, n2, k2] + np.float64(t["lo"]["c2_re"][k1, n2, k2])
    assert abs(v - np.cos(ang)) < 2.0 ** -17
    # the stage-1 split stays conjugate symmetric, exactly
    for part in ("hi", "lo"):
        re, im = t[part]["d1_re"], t[part]["d1_im"]
        np.testing.assert_array_equal(re[:, 1:], re[:, :0:-1])
        np.testing.assert_array_equal(im[:, 1:], -im[:, :0:-1])
    # the kernel's row halves: half 0 re k1' = 0..7, 16 and im 1..7, half 1
    # re and im of k1' = 8..15, each row once
    assert sorted(ffz.X3_ROWS) == list(range(32))


def test_manual_tier_is_the_same_function(mel_w):
    raw = torch.from_numpy(_tones(2, 30000, 5))
    a = ffz.FusedFeaturizer(mel_w, precision="bf16_3x", device="cpu")
    b = ffz.FusedFeaturizer(mel_w, precision="bf16_3x_manual", device="cpu")
    assert torch.equal(a(raw, pcen=False), b(raw, pcen=False))
    assert torch.equal(a.op2_frag, b.op2_frag)
    assert torch.equal(a.band_w, b.band_w)  # f32 weights, not rounded
    # on a card both names launch the one kernel and count there
    assert ffz._TENSOR_CORE["bf16_3x"] == ffz._TENSOR_CORE["bf16_3x_manual"]
    assert (ffz.mel_counter("bf16_3x") == ffz.mel_counter("bf16_3x_manual")
            == "fused_featurizer_mel_bf16x3")
    assert "fused_featurizer_mel_bf16x3" in ffz.launch_counts()


def test_bf16_3x_tier_wiring(mel_w):
    cfg = FeaturizerConfig()
    raw = torch.from_numpy(_tones(1, 30000, 4))
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision="bf16_3x",
                             device="cpu")
    want = ffz.mel_power_bf16_3x(raw, fz.mel_weights, 281)
    assert torch.equal(make_mel_fn(cfg, backend="fused", precision="bf16_3x",
                                   device="cpu")(raw), want)
    got = fz(raw, pcen=True, normalize=False)
    assert torch.equal(got, pcen(want, *fz.pcen_params, time_axis=2,
                                 normalize=False))
    assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                       want.to(torch.bfloat16))
    # with center=True both names frame as the centered exact tier does
    # (parity: tests/test_torch_folds.py)
    exact = ffz.FusedFeaturizer(mel_w, center=True, device="cpu")(
        raw, pcen=False)
    for tier in ("bf16_3x", "bf16_3x_manual"):
        centered = ffz.FusedFeaturizer(mel_w, precision=tier, center=True,
                                       device="cpu")(raw, pcen=False)
        assert torch.equal(centered, ffz.mel_power_bf16_3x(
            raw, fz.mel_weights, 281, center=True))
        assert _rel(centered, exact) < TIER_REL


# ---- a lane-level emulation of mel_bf16x3_kernel's mma fragment walk -----

_G, _T = np.arange(32) >> 2, np.arange(32) & 3
_A_REGS = [(0, 0), (8, 0), (0, 8), (8, 8)]  # (row, col) offsets of a0..a3
X3_ROW, X3_P_ROW = 264, 1028


def _split(v):
    """The kernel's split_bf16 of f32 values: (hi, lo) as f32."""
    v = np.asarray(v, np.float32)
    hi = ffz.round_bf16(v)
    return hi, ffz.round_bf16(v - hi)


def _x3_k1(h, e):
    if h == 0:
        return e if e < 8 else (16 if e == 8 else 16 + e)
    return 8 + e if e < 8 else 9 + e


def _emulate_x3_tile(x, hop, fz):
    """The kernel's first 16-frame tile of one clip, step by step, with
    shared memory that starts as NaN (a read of an unwritten plane shows)."""
    d1, op2 = ffz.dft_fragments_x3()
    window = hann_window(4096)
    planes = np.full((9, 16, X3_ROW), np.nan, np.float32)
    planes[[0, 8], :, 128:256] = 0.0  # step 0: im of k1' = 0 and 16
    power = np.full((16, X3_P_ROW), np.nan, np.float32)
    for h in range(2):
        split = 9 if h == 0 else 8
        for f in range(16):
            start = f * hop
            for j in range(16):
                bh, bl = {}, {}
                for ks in range(2):
                    for hh in range(2):
                        i0 = 128 * (16 * ks + 2 * _T + 8 * hh) + 8 * j + _G
                        v = [np.where(start + i < len(x),
                                      x[np.minimum(start + i, len(x) - 1)]
                                      * window[i], np.float32(0))
                             for i in (i0, i0 + 128)]
                        (h0, l0), (h1, l1) = _split(v[0]), _split(v[1])
                        bh[ks, hh] = ffz._pack_bf16(h0, h1)
                        bl[ks, hh] = ffz._pack_bf16(l0, l1)
                acc = np.zeros((32, 4))
                for ks in range(2):
                    a_hi, a_lo = d1[h, ks, 0].T, d1[h, ks, 1].T
                    _mma(acc, a_hi, bh[ks, 0], bh[ks, 1])
                    _mma(acc, a_lo, bh[ks, 0], bh[ks, 1])
                    _mma(acc, a_hi, bl[ks, 0], bl[ks, 1])
                for hr in range(2):
                    r = _G + 8 * hr
                    slot = np.where(r < split, r, r - 8)
                    col = np.where(r < split, 0, 128) + 8 * j + 2 * _T
                    planes[slot, f, col] = acc[:, 2 * hr]
                    planes[slot, f, col + 1] = acc[:, 2 * hr + 1]
        for e in range(16):
            k1 = _x3_k1(h, e)
            kp = min(k1, 32 - k1)
            rows = planes[8 if kp == 16 else kp - 8 * h]
            acc = np.zeros((8, 32, 4))
            for ks in range(16):
                kk = 16 * ks + 2 * _T
                ah, al = [], []
                for dr, dc in _A_REGS:
                    (h0, l0), (h1, l1) = (_split(rows[_G + dr, kk + dc + i])
                                          for i in (0, 1))
                    ah.append(ffz._pack_bf16(h0, h1))
                    al.append(ffz._pack_bf16(l0, l1))
                for j in range(8):
                    b = op2[k1, ks, j]
                    _mma(acc[j], ah, b[:, 0], b[:, 1])
                    _mma(acc[j], ah, b[:, 2], b[:, 3])
                    _mma(acc[j], al, b[:, 0], b[:, 1])
            for q in range(4):
                for c in range(4):
                    re = np.float32(acc[2 * q, :, c])
                    im = np.float32(acc[2 * q + 1, :, c])
                    k2 = 8 * q + 2 * _T + (c & 1)
                    power[_G + 8 * (c >> 1), k1 + 32 * k2] = re * re + im * im
    start, length = fz.band_start.numpy(), fz.band_len.numpy()
    off, w = fz.band_off.numpy(), fz.band_w.numpy().astype(np.float64)
    return np.stack([[w[off[m]:off[m] + length[m]]
                      @ power[f, start[m]:start[m] + length[m]]
                      for f in range(16)] for m in range(fz.n_mels)])


def test_x3_kernel_fragment_walk_emulation_matches_plain(mel_w):
    """One 16-frame tile of a tonal clip; the clip ends inside the tile, so
    its last frames read the tf pad_end zeros.  Emulation and plain version
    differ in summation order only (f64 sums of the fragments here, and
    the splits of planes that differ in their last bits): global relative
    error < 2e-6, a tenth of the tier's tolerance."""
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision="bf16_3x",
                             device="cpu")
    x = _tones(1, 4000, 3)[0]
    got = _emulate_x3_tile(x, 281, fz)[:, :-(-4000 // 281)]
    want = fz(torch.from_numpy(x[None]), pcen=False)[0].numpy()
    assert got.shape == want.shape == (160, 15)
    assert np.isfinite(got).all()
    assert _rel(got, want) < 2e-6
