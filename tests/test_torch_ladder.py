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

from test_torch_train_featurizer import SPAN_WORDS, _mma, _tones, _walk

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


@pytest.mark.parametrize("tier", ["bf16_3x", "bf16_3x_manual"])
def test_tier_takes_256_mels_as_jax(tier):
    """The tier takes any bank the geometry allows (the kernel keeps half
    0's partial mels in a global scratch, not in shared memory): at 256
    mels the CPU path matches the JAX tier in interpret mode."""
    w = build_mel_weights(FeaturizerConfig(n_mels=256))
    assert ffz.geometry_error(w, 4096) is None
    raw = np.random.default_rng(3).standard_normal((2, SHORT)).astype(
        np.float32)
    want = JaxFusedFeaturizer(w, 4096, 281, precision=tier)(
        jnp.asarray(raw), pcen=False, interpret=True)
    got = ffz.FusedFeaturizer(w, 4096, 281, precision=tier,
                              device="cpu")(torch.from_numpy(raw), pcen=False)
    assert got.shape == (2, 256, -(-SHORT // 281))
    assert _rel(got, want) < TIER_REL


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
    assert torch.equal(a.op2_ring, b.op2_ring)
    # the walks' weights: the bank's f32 values, not rounded to bf16
    assert torch.equal(a.slot_w, b.slot_w)
    w = a.slot_w[a.slot_w != 0].numpy()
    assert np.isin(w, mel_w).all() and (ffz.round_bf16(w) != w).any()
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
X3_ROW, X3_RE_ROW, X3_HP_ROW = 264, 136, 548


def _split(v):
    """The kernel's split_bf16 of f32 values: (hi, lo) as f32."""
    v = np.asarray(v, np.float32)
    hi = ffz.round_bf16(v)
    return hi, ffz.round_bf16(v - hi)


def _emulate_x3_tile(x, hop, fz, t_base=0, left_pad=0):
    """The kernel's block of frames t_base.. of one clip, step by step,
    with shared memory that starts as NaN (a read of an unwritten value
    shows): per half the staged span, stage 1 into the half's plane slots
    (half 0's slots 0 and 8 hold re rows alone), stage 2 on the ring's
    chunks (chunk ((2 h + r) 8 + ks) 2 + jh, warp w's part: the re rows of
    entry w + 8 r of the half, n-tiles 4 jh..; the im rows derived), the
    half-power tile and the half's walk;
    half 0's per-filter sums plus half 1's.  Returns the block's (n_mels,
    valid frames) mel."""
    d1, _ = ffz.dft_fragments_x3()
    chunks = fz.op2_ring.numpy().view(np.uint32).reshape(64, 8, 4, 32, 4)
    window = hann_window(4096)
    n_frames = 1 + len(x) // hop if left_pad else -(-len(x) // hop)
    n_valid = min(ffz.frames_per_block(hop), n_frames - t_base)
    mel = np.zeros((fz.n_mels, n_valid))
    for h in range(2):
        span = np.full(SPAN_WORDS, np.nan, np.float32)
        j = np.arange((n_valid - 1) * hop + 4096)
        s = t_base * hop - left_pad + j
        span[ffz.span_pos(j)] = np.where((s >= 0) & (s < len(x)),
                                         x[np.clip(s, 0, len(x) - 1)], 0)
        planes = np.full((9, 16, X3_ROW), np.nan, np.float32)
        split = 9 if h == 0 else 8
        for jt in range(16):
            for f in range(n_valid):
                bh, bl = {}, {}
                for ks in range(2):
                    for hh in range(2):
                        i0 = 128 * (16 * ks + 2 * _T + 8 * hh) + 8 * jt + _G
                        v = [span[ffz.span_pos(f * hop + i)] * window[i]
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
                    col = np.where(r < split, 0, 128) + 8 * jt + 2 * _T
                    planes[slot, f, col] = acc[:, 2 * hr]
                    planes[slot, f, col + 1] = acc[:, 2 * hr + 1]
        hpow = np.full((16, X3_HP_ROW), np.nan, np.float32)
        for rr in range(2):
            for w in range(8):
                e = w + 8 * rr
                k1 = ffz.X3_K1[h, e]
                kp = min(k1, 32 - k1)
                slot = 8 if kp == 16 else kp - 8 * h
                re_only = h == 0 and slot in (0, 8)
                rows = planes[slot]
                if re_only:  # the slot holds no im row
                    assert np.isnan(rows[:, 128:]).all()
                flip_re = np.uint32(0x80008000 if k1 <= 16 else 0)
                flip_im = flip_re ^ np.uint32(0x80008000)
                acc = np.zeros((8, 32, 4))
                for ks in range(8):
                    split = []
                    for kk in (16 * ks + 2 * _T, 128 + 16 * ks + 2 * _T):
                        ah, al = [], []
                        for dr, dc in _A_REGS:
                            (h0, l0), (h1, l1) = (
                                _split(rows[_G + dr, kk + dc + i]) for i in (0, 1))
                            ah.append(ffz._pack_bf16(h0, h1))
                            al.append(ffz._pack_bf16(l0, l1))
                        split.append((ah, al))
                        if re_only:
                            break
                    for jh in range(2):
                        bv = chunks[((2 * h + rr) * 8 + ks) * 2 + jh, w]
                        for jn in range(4):
                            d = acc[4 * jh + jn]
                            (ah, al), b = split[0], bv[jn]
                            _mma(d, ah, b[:, 0], b[:, 1])
                            _mma(d, ah, b[:, 2], b[:, 3])
                            _mma(d, al, b[:, 0], b[:, 1])
                        if re_only:  # the im rows are zeros
                            continue
                        for jn in range(4):  # im rows: pairs swapped, signed
                            d = acc[4 * jh + jn]
                            f = flip_im if jn & 1 else flip_re
                            (ah, al), b = split[1], bv[jn ^ 1] ^ f
                            _mma(d, ah, b[:, 0], b[:, 1])
                            _mma(d, ah, b[:, 2], b[:, 3])
                            _mma(d, al, b[:, 0], b[:, 1])
                for q in range(4):
                    for c in range(4):
                        re = np.float32(acc[2 * q, :, c])
                        im = np.float32(acc[2 * q + 1, :, c])
                        k2 = 8 * q + 2 * _T + (c & 1)
                        hpow[_G + 8 * (c >> 1), ffz.x3_power_pos(k2, e)] = (
                            re * re + im * im)
        tables = [t[h].numpy() for t in (fz.slot_w, fz.slot_pos,
                                         fz.piece_off, fz.mel_piece_off)]
        mel += np.stack([_walk(tables, hpow[f], fz.n_mels)
                         for f in range(n_valid)], axis=1)
    return mel


@pytest.mark.parametrize("samples,hop,left_pad,block", [
    (4000, 281, 0, 0),        # the clip ends inside the block: pad_end zeros
    (144000, 281, 2048, 20),  # centered framing, a block inside the clip
    (30000, 313, 0, 6),       # 14 frames a block; the last, 12-frame block
])
def test_x3_kernel_fragment_walk_emulation_matches_plain(mel_w, samples, hop,
                                                         left_pad, block):
    """One block of a tonal clip.  Emulation and plain version differ in
    summation order only (f64 sums of the fragments here, and the splits
    of planes that differ in their last bits): global relative error <
    2e-6, a tenth of the tier's tolerance."""
    fz = ffz.FusedFeaturizer(mel_w, 4096, hop, precision="bf16_3x",
                             center=bool(left_pad), device="cpu")
    x = _tones(1, samples, 3)[0]
    t_base = block * ffz.frames_per_block(hop)
    got = _emulate_x3_tile(x, hop, fz, t_base, left_pad)
    want = fz(torch.from_numpy(x[None]), pcen=False)[0].numpy()
    want = want[:, t_base:t_base + got.shape[1]]
    assert got.shape == want.shape and got.shape[1] >= 12
    assert np.isfinite(got).all()
    assert _rel(got, want) < 2e-6
