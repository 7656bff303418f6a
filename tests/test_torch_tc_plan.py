"""The tensor-core tiers' host packing and shared-memory layouts, in numpy.

``mel_bf16_kernel`` ("default") and ``mel_bf16x3_kernel`` ("bf16_3x") run
only on a card (tests/test_torch_gpu.py).  What they read is packed here on
the host: the stage-2 operator's re rows in the ring's chunk order (each
block of a cluster copies its part of each chunk to all of them; the
kernels derive the im rows), the balanced mel
walks over the kernels' power tiles, and the indexing of the staged clip
span and of the power tiles.  These tests check, exactly, that the packing
reassembles ``stage2_operator`` and the framed samples, that the walks give
the banded mel, and that the layouts are injective, fit their shared
memory and keep each warp-wide store or load on distinct banks as the
kernel's source says.  The lane-level emulations of the kernels' walks
(tests/test_torch_train_featurizer.py, tests/test_torch_ladder.py) use the
same tables.
"""

import numpy as np
import pytest
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import build_mel_weights
from audio_training_tpu_torch.ops.mel import band_tables

_G, _T = np.arange(32) >> 2, np.arange(32) & 3
SPAN_WORDS = ffz.SPAN_CAP + 8 * (ffz.SPAN_CAP // 256)  # the kernels' span
P_ROW, X3_HP_ROW = 1064, 548  # the power tiles' rows (bf16 / f32 words)


def _unpack_b(frags: np.ndarray) -> np.ndarray:
    """(16 k-steps, N/8 n-tiles, 32 lanes, 2) uint32 B fragments of
    ``mma.sync.m16n8k16.col`` -> the (256, N) f32 matrix."""
    ks, nt = frags.shape[:2]
    b = np.full((16 * ks, 8 * nt), np.nan, np.float32)
    half = lambda u, hi: ((u >> 16 if hi else u & 0xFFFF).astype(np.uint32)
                          << 16).view(np.float32)
    for k in range(ks):
        for j in range(nt):
            r0, r1 = frags[k, j, :, 0], frags[k, j, :, 1]
            rows, col = 16 * k + 2 * _T, 8 * j + _G
            b[rows, col], b[rows + 1, col] = half(r0, 0), half(r0, 1)
            b[rows + 8, col], b[rows + 9, col] = half(r1, 0), half(r1, 1)
    return b


def _im_rows(re_rows: np.ndarray, k1: int) -> np.ndarray:
    """The im rows' B fragments (8 k-steps, 8 n-tiles, 32 lanes, regs) of
    k1's stage-2 operator from its re rows' as the kernels derive them: n-tile
    2q from 2q + 1 times -s, 2q + 1 from 2q times s (s = 1 for k1 <= 16,
    else -1), the sign flipped on each bf16 value's bit."""
    flip = np.uint32(0x80008000)
    sign_re = flip if k1 <= 16 else np.uint32(0)
    out = re_rows.reshape(8, 4, 2, *re_rows.shape[2:])[:, :, ::-1].copy()
    out[:, :, 0] ^= sign_re
    out[:, :, 1] ^= sign_re ^ flip
    return out.reshape(re_rows.shape)


def test_default_ring_reassembles_the_stage2_operator():
    """Chunk 8 r + ks, warp w's 2 KB: re-row k-step ks of k1 = w + 8 r;
    with the im rows derived from them (_im_rows), the 8 chunks of
    each k1 give exactly stage2_operator."""
    _, op2 = ffz.dft_fragments()
    ring = ffz.ring_chunks(op2)
    assert ring.nbytes == 32 * ffz.RING_CHUNK == 1 << 19
    chunks = ring.reshape(32, -1)
    assert chunks.shape[1] * 4 == ffz.RING_CHUNK
    tables = ffz.dft_tables_bf16()
    for k1 in range(32):
        r, w = divmod(k1, 8)
        re_rows = np.stack([chunks[8 * r + ks].reshape(8, 8, 32, 2)[w]
                            for ks in range(8)])
        frags = np.concatenate([re_rows, _im_rows(re_rows, k1)])
        np.testing.assert_array_equal(frags, op2[k1])
        np.testing.assert_array_equal(_unpack_b(frags),
                                      ffz.stage2_operator(tables, k1))


def test_x3_ring_reassembles_the_stage2_operator():
    """Chunk ((2 h + r) 8 + ks) 2 + jh, warp w's 2 KB: re-row k-step ks,
    n-tiles 4 jh.. of k1 = X3_K1[h, w + 8 r], each lane's hi fragment then
    its lo one; with the im rows derived, exactly stage2_operator's hi and
    lo parts; the halves' entries cover every k1 once."""
    _, op2 = ffz.dft_fragments_x3()
    ring = ffz.ring_chunks_x3(op2)
    assert ring.nbytes == 64 * ffz.RING_CHUNK == 1 << 20
    chunks = ring.reshape(64, 8, 4, 32, 4)
    assert sorted(ffz.X3_K1.ravel()) == list(range(32))
    split = ffz.dft_tables_split()
    for h in range(2):
        for e in range(16):
            k1 = ffz.X3_K1[h, e]
            r, w = divmod(e, 8)
            re_rows = np.stack([np.concatenate([
                chunks[((2 * h + r) * 8 + ks) * 2 + jh, w]
                for jh in range(2)]) for ks in range(8)])
            frags = np.concatenate([re_rows,
                                    _im_rows(re_rows, k1)])
            np.testing.assert_array_equal(frags, op2[k1])
            for part, regs in (("hi", slice(0, 2)), ("lo", slice(2, 4))):
                np.testing.assert_array_equal(
                    _unpack_b(frags[..., regs]),
                    ffz.stage2_operator(split[part], k1))


@pytest.mark.parametrize("tier", ["default", "bf16_3x"])
def test_cluster_parts_tile_every_chunk(tier):
    """Each block of a cluster copies bytes [q, q + 1) x RING_CHUNK /
    TC_CLUSTER of every chunk: the parts are whole 16-byte units (what a
    bulk copy takes) and their concatenation is the chunk."""
    op2 = ffz._TENSOR_CORE[tier].fragments()[1]
    flat = ffz._TENSOR_CORE[tier].ring(op2).view(np.uint8).reshape(
        -1, ffz.RING_CHUNK)
    part = ffz.RING_CHUNK // ffz.TC_CLUSTER
    assert part % 16 == 0 and ffz.RING_CHUNK % ffz.TC_CLUSTER == 0
    parts = [flat[:, q * part:(q + 1) * part] for q in range(ffz.TC_CLUSTER)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), flat)
    assert flat.shape[0] == (32 if tier == "default" else 64)


@pytest.mark.parametrize("samples,hop,left_pad", [
    (144000, 281, 0), (144000, 281, 2048), (28100, 281, 0), (30000, 313, 0),
    (20000, 160, 2048), (9000, 5000, 0)])
def test_staged_span_gives_the_framed_samples(samples, hop, left_pad):
    """Every block's staged span (span_pos, zeros outside the clip) read at
    f hop + i gives frame t_base + f's sample i as _framed frames the clip,
    for every valid frame of every block, within the span's words."""
    clip = np.random.default_rng(hop).standard_normal(samples).astype(
        np.float32)
    framed = ffz._framed(torch.from_numpy(clip[None]), hop,
                         center=bool(left_pad))[0].numpy()
    n_frames, fpb = framed.shape[0], ffz.frames_per_block(hop)
    for t_base in range(0, n_frames, fpb):
        n_valid = min(fpb, n_frames - t_base)
        s0, span = t_base * hop - left_pad, (n_valid - 1) * hop + 4096
        assert span <= ffz.SPAN_CAP
        words = np.full(SPAN_WORDS, np.nan, np.float32)
        j = np.arange(span)
        assert ffz.span_pos(j).max() < SPAN_WORDS
        assert len(np.unique(ffz.span_pos(j))) == span
        s = s0 + j
        words[ffz.span_pos(j)] = np.where((s >= 0) & (s < samples),
                                          clip[np.clip(s, 0, samples - 1)], 0)
        i = np.arange(4096)
        for f in range(n_valid):
            np.testing.assert_array_equal(
                words[ffz.span_pos(f * hop + i)], framed[t_base + f])


def _banks(words) -> int:
    """Most lanes of one access on one 4-byte bank (distinct words)."""
    words = np.unique(np.asarray(words))
    return np.bincount(words % 32, minlength=32).max()


def test_stage1_span_loads_hit_distinct_banks():
    """A warp's stage-1 loads (lanes g, t: samples o + 128 (16 ks + 2 t + 8
    h) + 8 j + g) hit 32 banks, and at most 2 lanes share a bank where the
    8 samples of a row straddle a 256-sample pad, over every frame offset
    of the production hop."""
    worst = 1
    for f in range(16):
        for j in range(16):
            for ks in range(2):
                for h in range(2):
                    i0 = f * 281 + 128 * (16 * ks + 2 * _T + 8 * h) + 8 * j + _G
                    worst = max(worst, _banks(ffz.span_pos(i0)),
                                _banks(ffz.span_pos(i0 + 128)))
    assert worst <= 2


def test_power_tiles_are_injective_and_conflict_free():
    """The "default" bf16 power tile (tc_power_pos) and a "bf16_3x" half's
    f32 power tile (x3_power_pos) hold each value once within a row, and
    each scatter store (warp k1 or entry e; lanes g, t: frame g + 8 (c >> 1),
    k2 = 8 q + 2 t + (c & 1)) hits 32 distinct banks."""
    bins = np.arange(1024)
    pos = ffz.tc_power_pos(bins)
    assert len(np.unique(pos)) == 1024 and pos.max() < P_ROW
    k2s, es = np.meshgrid(np.arange(32), np.arange(16), indexing="ij")
    pos3 = ffz.x3_power_pos(k2s, es)
    assert len(np.unique(pos3)) == 512 and pos3.max() < X3_HP_ROW
    for q in range(4):
        for c in range(4):
            f, k2 = _G + 8 * (c >> 1), 8 * q + 2 * _T + (c & 1)
            for k1 in range(32):  # bf16: two values a word
                words = (f * P_ROW + ffz.tc_power_pos(k1 + 32 * k2)) // 2
                assert _banks(words) == 1 and len(np.unique(words)) == 32
            for e in range(16):
                assert _banks(f * X3_HP_ROW + ffz.x3_power_pos(k2, e)) == 1


@pytest.mark.parametrize("bank", ["production", "n_mels=64", "n_mels=128",
                                  "random", "n_mels=256"])
def test_tensor_core_walks_give_the_banded_mel(bank):
    """The "default" walk over its power tile (bf16-rounded weights) and
    the two "bf16_3x" half walks over their half tiles, each walked as the
    kernel walks slots and each filter's pieces summed in order (half 0's
    sum, then half 1's added), give the banded mel of a power spectrum;
    the piece sums fit the kernels' tile of 128 + n_mels a frame."""
    if bank == "random":
        rng = np.random.default_rng(1)
        w = (rng.random((40, 1024)) * (rng.random((40, 1024)) < 0.05)
             ).astype(np.float32)
        w[[3, 17]] = 0.0  # empty filters
    else:
        n_mels = 160 if bank == "production" else int(bank.split("=")[1])
        w = build_mel_weights(FeaturizerConfig(n_mels=n_mels))
    w = w[:, :1024]  # the support the tensor-core kernels take
    start, length, offset, flat = band_tables(w)
    n_mels = w.shape[0]
    power = np.random.default_rng(2).gamma(2.0, 3.0, 1024)

    def walk(tables, row):
        slot_w, slot_pos, piece_off, mel_piece_off = tables
        assert slot_w.shape[0] % 4 == 0 and piece_off[-1] <= 128 + n_mels
        sums = np.full(piece_off[-1] + 1, np.nan)
        for t in range(128):
            seg, acc = piece_off[t], 0.0
            for j in range(slot_w.shape[0]):
                if slot_pos[j, t] >> 16:
                    sums[seg] = acc
                    seg, acc = seg + 1, 0.0
                acc += np.float64(slot_w[j, t]) * row[slot_pos[j, t] & 0xFFFF]
            if piece_off[t + 1] > piece_off[t]:
                assert seg == piece_off[t + 1] - 1
                sums[seg] = acc
        return np.array([sums[mel_piece_off[m]:mel_piece_off[m + 1]].sum()
                         for m in range(n_mels)])

    row = np.full(P_ROW, np.nan)
    row[ffz.tc_power_pos(np.arange(1024))] = power
    want = ffz.round_bf16(w).astype(np.float64) @ power
    got = walk(ffz.tc_walk(start, length, flat), row)
    assert np.abs(got - want).max() <= 1e-12 * want.max()

    x3 = ffz.x3_walk(start, length, flat)
    got = np.zeros(n_mels)
    for h in range(2):
        row = np.full(X3_HP_ROW, np.nan)
        k1 = ffz.X3_K1[h]
        row[ffz.x3_power_pos(np.arange(32)[:, None], np.arange(16))] = (
            power.reshape(32, 32)[:, k1])
        got = got + walk(tuple(t[h] for t in x3), row)
    want = w.astype(np.float64) @ power
    assert np.abs(got - want).max() <= 1e-12 * want.max()
