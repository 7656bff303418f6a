"""K1's "default" tier (the training featurizer) of the port on the CPU.

The tier rounds to bf16 at six points (windowed samples, stage-1 operator,
stage-1 planes, stage-2 operator, power, mel weights) and sums in f32.  Its
plain version (``mel_power_bf16``, what the wrapper computes for a CPU
tensor) is held against the JAX package's exact mel (``MatmulMelPlan``,
"highest") at < 1e-2 global relative error: the tier's own error class,
and above 1e-4 (it is not the exact tier).  The CUDA kernel runs only on a card
(tests/test_torch_gpu.py); here a numpy emulation of its mma fragment walk,
driven by the same host-packed operator tables, reproduces the plain
version, which checks the tables' fragment order and the kernel's indexing
as the emulation transcribes them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.ops.fftmel import MatmulMelPlan
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import build_mel_weights
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
from audio_training_tpu_torch.ops.pcen import pcen
from audio_training_tpu_torch.ops.stft import hann_window

torch.set_num_threads(2)

TIER_REL = 1e-2


@pytest.fixture(scope="module")
def mel_w():
    return build_mel_weights(FeaturizerConfig())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _tones(batch, samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 48000
    x = [sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(200, 9000, 3))
         + 0.05 * rng.standard_normal(samples) for _ in range(batch)]
    return np.stack(x).astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "tones"])
def test_plain_tier_matches_jax_exact_mel(mel_w, kind):
    rng = np.random.default_rng(1)
    raw = (rng.standard_normal((2, 144000)).astype(np.float32)
           if kind == "noise" else _tones(2, 144000, 1))
    want = MatmulMelPlan(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw))
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision="default",
                             device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False)
    assert got.shape == (2, 160, 513)
    rel = _rel(got, want)
    assert 1e-4 < rel < TIER_REL  # bf16 products: not the exact tier
    assert torch.equal(got, ffz.mel_power_bf16(torch.from_numpy(raw),
                                               fz.mel_weights, 281))


def test_tables_round_once_and_are_conjugate_symmetric():
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ffz.round_bf16(x), want)
    t = ffz.dft_tables_bf16()
    for v in t.values():
        np.testing.assert_array_equal(ffz.round_bf16(v), v)
    # W32^(n1 (32 - k1)) is the conjugate of W32^(n1 k1), exactly
    np.testing.assert_array_equal(t["d1_re"][:, 1:], t["d1_re"][:, :0:-1])
    np.testing.assert_array_equal(t["d1_im"][:, 1:], -t["d1_im"][:, :0:-1])
    assert not t["d1_im"][:, [0, 16]].any()
    # the stage-2 operator is W4096^(n2 (k1 + 32 k2)) rounded once
    k1, n2, k2 = 5, 77, 9
    ang = 2 * np.pi * ((n2 * (k1 + 32 * k2)) % 4096) / 4096
    assert t["c2_re"][k1, n2, k2] == ffz.round_bf16(np.cos(ang))
    assert t["c2_im"][k1, n2, k2] == ffz.round_bf16(-np.sin(ang))


# ---- a lane-level emulation of mel_bf16_kernel's mma fragment walk -------

_G, _T = np.arange(32) >> 2, np.arange(32) & 3
_A_REGS = [(0, 0), (8, 0), (0, 8), (8, 8)]  # (row, col) offsets of a0..a3


def _unpack(u):
    u = np.asarray(u, np.uint32)
    return ((u << np.uint32(16)).view(np.float32).astype(np.float64),
            (u & np.uint32(0xFFFF0000)).view(np.float32).astype(np.float64))


def _mma(acc, a_regs, b0, b1):
    """acc (32, 4) += A(16x16) B(16x8) in the PTX m16n8k16 layout."""
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for reg, (dr, dc) in zip(a_regs, _A_REGS):
        lo, hi = _unpack(reg)
        a[_G + dr, 2 * _T + dc], a[_G + dr, 2 * _T + dc + 1] = lo, hi
    for reg, dk in ((b0, 0), (b1, 8)):
        lo, hi = _unpack(reg)
        b[2 * _T + dk, _G], b[2 * _T + dk + 1, _G] = lo, hi
    d = a @ b
    acc += np.stack([d[_G, 2 * _T], d[_G, 2 * _T + 1], d[_G + 8, 2 * _T],
                     d[_G + 8, 2 * _T + 1]], -1)


def _pack(lo, hi):
    return ffz._pack_bf16(ffz.round_bf16(np.float32(lo)),
                          ffz.round_bf16(np.float32(hi)))


SPAN_WORDS = ffz.SPAN_CAP + 8 * (ffz.SPAN_CAP // 256)  # the staged span
P_ROW = 1064  # bf16 per frame of the kernel's power tile


def _walk(tables, row, n_mels):
    """The kernel's balanced walk of one frame's power row: each thread's
    slots in order (padding slots add 0 x row[0] to its last piece), the
    piece sums of threads that have slots, each filter's pieces in order."""
    slot_w, slot_pos, piece_off, mel_piece_off = (np.asarray(t)
                                                  for t in tables)
    seg = piece_off[:-1] + np.cumsum(slot_pos >> 16, axis=0)
    live = np.broadcast_to(piece_off[1:] > piece_off[:-1], seg.shape)
    sums = np.zeros(piece_off[-1])
    np.add.at(sums, seg[live], (slot_w.astype(np.float64)
                                * row[slot_pos & 0xFFFF])[live])
    return np.array([sums[mel_piece_off[m]:mel_piece_off[m + 1]].sum()
                     for m in range(n_mels)])


def _emulate_tile(x, hop, fz, t_base=0, left_pad=0):
    """The kernel's block of frames t_base.. of one clip, step by step,
    with shared memory that starts as NaN: the staged span, stage 1's
    fragments, stage 2 on the ring's chunks (chunk 8 r + ks, warp w's part:
    the re rows of k1 = w + 8 r, the im rows derived), the power tile and
    the balanced walk.  Returns the
    block's (n_mels, valid frames) mel."""
    d1, _ = ffz.dft_fragments()
    chunks = fz.op2_ring.numpy().view(np.uint32).reshape(32, 8, 8, 32, 2)
    window = hann_window(4096)
    n_frames = 1 + len(x) // hop if left_pad else -(-len(x) // hop)
    n_valid = min(ffz.frames_per_block(hop), n_frames - t_base)
    span = np.full(SPAN_WORDS, np.nan, np.float32)
    j = np.arange((n_valid - 1) * hop + 4096)
    s = t_base * hop - left_pad + j
    span[ffz.span_pos(j)] = np.where((s >= 0) & (s < len(x)),
                                     x[np.clip(s, 0, len(x) - 1)], 0)
    planes = np.full((17, 16, 264), np.nan)  # the shared-memory plane rows
    planes[[0, 16], :, 128:256] = 0.0  # step 0: im of k1' = 0 and 16
    for jt in range(16):
        for f in range(n_valid):
            b = {}
            for ks in range(2):
                for h in range(2):
                    i0 = 128 * (16 * ks + 2 * _T + 8 * h) + 8 * jt + _G
                    v = [span[ffz.span_pos(f * hop + i)] * window[i]
                         for i in (i0, i0 + 128)]
                    b[ks, h] = _pack(*v)
            for mt in range(2):
                acc = np.zeros((32, 4))
                for ks in range(2):
                    _mma(acc, d1[mt, ks].T, b[ks, 0], b[ks, 1])
                for hr in range(2):
                    p = 16 * mt + _G + 8 * hr
                    kp, half = np.where(p <= 16, p, p - 16), np.where(p <= 16, 0, 128)
                    col = half + 8 * jt + 2 * _T
                    planes[kp, f, col] = ffz.round_bf16(acc[:, 2 * hr])
                    planes[kp, f, col + 1] = ffz.round_bf16(acc[:, 2 * hr + 1])
    power = np.full((16, P_ROW), np.nan)
    for r in range(4):
        for w in range(8):
            k1 = w + 8 * r
            rows = planes[min(k1, 32 - k1)].astype(np.float32)
            flip_re = np.uint32(0x80008000 if k1 <= 16 else 0)
            flip_im = flip_re ^ np.uint32(0x80008000)
            acc = np.zeros((8, 32, 4))
            for ks in range(8):
                a = [[ffz._pack_bf16(rows[_G + dr, kk + dc],
                                     rows[_G + dr, kk + dc + 1])
                      for dr, dc in _A_REGS]
                     for kk in (16 * ks + 2 * _T, 128 + 16 * ks + 2 * _T)]
                bv = chunks[8 * r + ks, w]  # the re rows' fragments
                for jn in range(8):
                    _mma(acc[jn], a[0], bv[jn, :, 0], bv[jn, :, 1])
                for q in range(4):  # the im rows': pairs swapped, signed
                    _mma(acc[2 * q], a[1], bv[2 * q + 1, :, 0] ^ flip_re,
                         bv[2 * q + 1, :, 1] ^ flip_re)
                    _mma(acc[2 * q + 1], a[1], bv[2 * q, :, 0] ^ flip_im,
                         bv[2 * q, :, 1] ^ flip_im)
            for q in range(4):
                for c in range(4):
                    re = np.float32(acc[2 * q, :, c])
                    im = np.float32(acc[2 * q + 1, :, c])
                    k2 = 8 * q + 2 * _T + (c & 1)
                    power[_G + 8 * (c >> 1), ffz.tc_power_pos(k1 + 32 * k2)] = (
                        ffz.round_bf16(re * re + im * im))
    tables = [t.numpy() for t in (fz.slot_w, fz.slot_pos, fz.piece_off,
                                  fz.mel_piece_off)]
    return np.stack([_walk(tables, power[f], fz.n_mels)
                     for f in range(n_valid)], axis=1)


@pytest.mark.parametrize("samples,hop,left_pad,block", [
    (4000, 281, 0, 0),        # the clip ends inside the block: pad_end zeros
    (144000, 281, 2048, 20),  # centered framing, a block inside the clip
    (30000, 313, 0, 6),       # 14 frames a block; the last, 12-frame block
])
def test_kernel_fragment_walk_emulation_matches_plain(mel_w, samples, hop,
                                                       left_pad, block):
    """One block of a tonal clip.  Emulation and plain version differ in
    summation order only (f64 products of the fragments here): relative
    RMS < 1e-5 and no value off by more than one bf16 step of the max
    (2^-7), the tier's contract."""
    fz = ffz.FusedFeaturizer(mel_w, 4096, hop, precision="default",
                             center=bool(left_pad), device="cpu")
    x = _tones(1, samples, 3)[0]
    t_base = block * ffz.frames_per_block(hop)
    got = _emulate_tile(x, hop, fz, t_base, left_pad)
    want = fz(torch.from_numpy(x[None]), pcen=False)[0].numpy()
    want = want[:, t_base:t_base + got.shape[1]]
    assert got.shape == want.shape and got.shape[1] >= 12
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    assert _rel(got, want) < 2 ** -7


def test_default_tier_wiring(mel_w):
    cfg = FeaturizerConfig()
    raw = torch.from_numpy(_tones(1, 30000, 4))
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision="default",
                             device="cpu")
    want = ffz.mel_power_bf16(raw, fz.mel_weights, 281)
    # make_mel_fn passes the precision through; "auto" on the CPU keeps the
    # exact rfft path, as the JAX package's CPU path computes f32
    assert torch.equal(make_mel_fn(cfg, backend="fused", precision="default",
                                   device="cpu")(raw), want)
    exact = make_mel_fn(cfg, precision="default", device="cpu")(raw)
    assert torch.equal(exact, make_mel_fn(cfg, backend="rfft",
                                          device="cpu")(raw))
    assert _rel(want, exact) < TIER_REL
    # the PCEN epilogue runs on the tier's mel power
    got = fz(raw, pcen=True, normalize=False)
    assert torch.equal(got, pcen(want, *fz.pcen_params, time_axis=2,
                                 normalize=False))
    assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                       want.to(torch.bfloat16))
    # "default" with center=True frames as the centered exact tier does
    # (parity: tests/test_torch_folds.py); the three-pass tiers are a tier
    # of their own (tests/test_torch_ladder.py), not this one
    centered = ffz.FusedFeaturizer(mel_w, device="cpu", precision="default",
                                   center=True)(raw, pcen=False)
    assert torch.equal(centered, ffz.mel_power_bf16(raw, fz.mel_weights, 281,
                                                    center=True))
    assert _rel(centered, ffz.FusedFeaturizer(mel_w, device="cpu",
                                              center=True)(raw, pcen=False)
                ) < TIER_REL
    x3 = ffz.FusedFeaturizer(mel_w, 4096, 281, precision="bf16_3x",
                             device="cpu")(raw, pcen=False)
    assert not torch.equal(x3, want)
    assert _rel(x3, exact) < _rel(want, exact)
