"""The exact tier's FFT plan (csrc/fused_featurizer.cu, mel_power_kernel) as
a float64 numpy model, on the CPU.

The kernel cannot run here, so its index arithmetic is held here: the
model stages a block's span of the clip as the kernel does (even and odd
samples apart, zeros outside the clip), reads each frame's samples through
the kernel's parity choice, runs the three passes of 2048 = 16 x 16 x 8 with
the kernel's radix-2 DIF sub-transforms (bit-reversed output), its digit
order per thread, its exchange index maps (``x1_index``, ``x2_index``,
``x3_index``) and its twiddle tables (``fft_plan_tables``), then the
untangle.  The power of bins 0..1023 must match ``numpy.fft.rfft`` of the
windowed frames to 1e-12 of the largest power, and the packed FFT
``numpy.fft.fft`` to 1e-12.  A further test checks that each exchange's
accesses give each half-warp 16 distinct 8-byte banks and that the maps
cover their buffers exactly once.
"""

import numpy as np
import pytest

from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.stft import hann_window

HALF = 2048
EV_WORDS = ffz.SPAN_CAP // 2 + 16
XBUF = 128 * ffz.X1_STRIDE
LT = np.arange(128)
C, G = LT & 15, LT >> 4  # passes 2-3: (c, g) of thread lt


def _brev(x, bits):
    return int(f"{x:0{bits}b}"[::-1], 2)


def _dif(v):
    """The kernel's in-register radix-2 DIF over axis 0 (natural order in,
    bit-reversed out): the half-span-h stage multiplies by W16^(8 j / h)."""
    v = v.copy()
    n, h = v.shape[0], v.shape[0] // 2
    while h >= 1:
        for s in range(0, n, 2 * h):
            for j in range(h):
                a, b = v[s + j].copy(), v[s + j + h].copy()
                v[s + j] = a + b
                v[s + j + h] = (a - b) * np.exp(-2j * np.pi * j * (8 // h) / 16)
        h //= 2
    return v


def _plan_fft(pe, po, window):
    """One frame through the plan: (Z in natural order, the packed input)."""
    tw1, tw2 = ffz.fft_plan_tables()
    nan = np.nan * (1 + 1j)
    X, Y = np.full(XBUF, nan), np.full(HALF, nan)
    # pass 1: thread b = lt, points z[128 a + b]
    n = 128 * np.arange(16)[:, None] + LT[None, :]
    z = pe[n] * window[2 * n] + 1j * (po[n] * window[2 * n + 1])
    v = _dif(z)
    for k in range(16):
        y = v[_brev(k, 4)] * (tw1[k, LT] if k else 1.0)
        X[ffz.x1_index(LT, k)] = y
    # pass 2: thread (c, g), the values Y[8 e + g][c]
    e = np.arange(16)[:, None]
    v = _dif(X[ffz.x1_index(8 * e + G[None, :], C[None, :])])
    for h in range(16):
        y = v[_brev(h, 4)] * (tw2[G, h] if h else 1.0)
        Y[ffz.x2_index(C, G, h)] = y
    # pass 3: thread (c, g), h = g and g + 8; natural order into X
    X[:] = nan
    for half in range(2):
        h = G + 8 * half
        u = _dif(Y[ffz.x2_index(C[None, :], np.arange(8)[:, None],
                                h[None, :])])
        for i in range(8):
            X[ffz.x3_index(C, h, i)] = u[_brev(i, 3)]
    packed = np.empty(HALF, complex)
    packed[n.ravel()] = z.ravel()
    return X[:HALF], packed


def _untangle(Z):
    """The kernel's untangle of bins 0..1023, its operations in float64."""
    k = np.arange(ffz.MAX_BINS)
    za, zc = Z[k], Z[(HALF - k) & (HALF - 1)]
    er, ei = 0.5 * (za.real + zc.real), 0.5 * (za.imag - zc.imag)
    o_r, o_i = 0.5 * (za.imag + zc.imag), 0.5 * (zc.real - za.real)
    w = np.exp(-2j * np.pi * k / 4096)
    xr = er + (w.real * o_r - w.imag * o_i)
    xi = ei + (w.real * o_i + w.imag * o_r)
    return xr * xr + xi * xi


@pytest.mark.parametrize("samples,hop,left_pad,block", [
    (144000, 281, 0, 0),      # production clip, tf framing, first tile
    (144000, 281, 0, 32),     # its last tile: one frame, past the clip
    (144000, 281, 2048, 0),   # centered framing: the span starts before 0
    (30000, 313, 0, 6),       # another hop: 14 frames a block, ragged end
    (30000, 313, 2048, 6),
])
def test_plan_model_matches_numpy_fft(samples, hop, left_pad, block):
    clip = np.random.default_rng(hop + block).standard_normal(samples)
    window = hann_window(4096).astype(np.float64)
    n_frames = (1 + samples // hop if left_pad else -(-samples // hop))
    fpb = ffz.frames_per_block(hop)
    t_base = block * fpb
    n_valid = min(fpb, n_frames - t_base)
    assert n_valid >= 1
    # the staged span: even samples in ev, odd in od, zeros outside the clip
    s0, span = t_base * hop - left_pad, (n_valid - 1) * hop + 4096
    assert span <= ffz.SPAN_CAP
    ev, od = np.full(EV_WORDS, np.nan), np.full(EV_WORDS, np.nan)
    for j in range(span):
        s = s0 + j
        (od if j & 1 else ev)[j >> 1] = clip[s] if 0 <= s < samples else 0.0
    padded = np.concatenate([np.zeros(left_pad), clip, np.zeros(8192)])
    for tt in range(n_valid):
        o = tt * hop
        pe, po = ((od[o >> 1:], ev[(o >> 1) + 1:]) if o & 1
                  else (ev[o >> 1:], od[o >> 1:]))
        Z, packed = _plan_fft(pe, po, window)
        frame = padded[(t_base + tt) * hop:(t_base + tt) * hop + 4096]
        np.testing.assert_array_equal(packed,
                                      (frame * window)[0::2]
                                      + 1j * (frame * window)[1::2])
        want_z = np.fft.fft(packed)
        assert np.abs(Z - want_z).max() <= 1e-12 * np.abs(want_z).max()
        want = np.abs(np.fft.rfft(frame * window)[:ffz.MAX_BINS]) ** 2
        got = _untangle(Z)
        assert np.abs(got - want).max() <= 1e-12 * want.max()


def test_exchanges_hit_distinct_banks_and_cover_their_buffers():
    """Every shared-memory access of the plan: within each half-warp (16
    neighbouring threads) the float2 addresses are distinct mod 16, so the
    8-byte accesses meet no bank conflict; each map writes its buffer's
    2048 values once."""
    accesses = []
    for k in range(16):
        accesses.append(ffz.x1_index(LT, k))                 # pass 1 write
        accesses.append(ffz.x1_index(8 * k + G, C))          # pass 2 read
        accesses.append(ffz.x2_index(C, G, k))               # pass 2 write
    for half in range(2):
        for q in range(8):
            accesses.append(ffz.x2_index(C, q, G + 8 * half))  # pass 3 read
            accesses.append(ffz.x3_index(C, G + 8 * half, q))  # pass 3 write
    for q in range(8):                                      # untangle reads
        k = LT + 128 * q
        accesses += [k, (HALF - k) & (HALF - 1)]
    for addr in accesses:
        for hw in np.asarray(addr).reshape(8, 16):
            assert len(set(hw % 16)) == 16
    b, c = np.meshgrid(np.arange(128), np.arange(16), indexing="ij")
    x1 = ffz.x1_index(b, c).ravel()
    assert len(set(x1)) == HALF and x1.max() < XBUF
    cc, g, h = np.meshgrid(np.arange(16), np.arange(8), np.arange(16),
                           indexing="ij")
    assert sorted(ffz.x2_index(cc, g, h).ravel()) == list(range(HALF))
    cc, h, i = np.meshgrid(np.arange(16), np.arange(16), np.arange(8),
                           indexing="ij")
    assert sorted(ffz.x3_index(cc, h, i).ravel()) == list(range(HALF))


def test_plan_constants():
    """The twiddle tables and the operation count the bound uses."""
    tw1, tw2 = ffz.fft_plan_tables()
    b, c = np.arange(128)[None, :], np.arange(16)[:, None]
    np.testing.assert_allclose(tw1, np.exp(-2j * np.pi * b * c / 2048),
                               rtol=0, atol=1e-15)
    g, h = np.arange(8)[:, None], np.arange(16)[None, :]
    np.testing.assert_allclose(tw2, np.exp(-2j * np.pi * g * h / 128),
                               rtol=0, atol=1e-15)
    assert (tw1[:, 0] == 1).all() and tw1[8, 64] == -1j  # exact
    assert ffz.EXACT_FFT_FLOPS == 82432
    for hop in (1, 160, 281, 313, 4096, 10000):
        fpb = ffz.frames_per_block(hop)
        assert 1 <= fpb <= 16 and (fpb - 1) * hop + 4096 <= ffz.SPAN_CAP
    assert ffz.frames_per_block(281) == 16


def _mel_pieces(start: np.ndarray, length: np.ndarray, offset: np.ndarray,
               threads: int = ffz.FFT_THREADS) -> tuple[np.ndarray, ...]:
    """The exact kernel's balanced mel walk as pieces, the reference that
    ``mel_slots`` is held to: the non-zeros of a bank's bands
    (:func:`ops.mel.band_tables`), flattened in mel order,
    cut into ``threads`` equal slices, each slice into pieces that lie in
    one filter's band.  Returns ``pieces`` (P, 3) int32 rows (flat start,
    count, first bin), ``piece_off`` (threads + 1,): thread t walks
    pieces ``piece_off[t]:piece_off[t + 1]``, and ``mel_piece_off`` (M +
    1,): filter m's mel is the sum of pieces ``mel_piece_off[m]:
    mel_piece_off[m + 1]`` in order (none for an empty filter)."""
    nnz = int(length.sum())
    ends = offset + length
    pieces, mel_of, piece_off = [], [], [0]
    for t in range(threads):
        i, hi = t * nnz // threads, (t + 1) * nnz // threads
        while i < hi:
            m = int(np.flatnonzero((offset <= i) & (i < ends))[0])
            end = min(hi, int(ends[m]))
            pieces.append((i, end - i, int(start[m]) + i - int(offset[m])))
            mel_of.append(m)
            i = end
        piece_off.append(len(pieces))
    mel_piece_off = np.searchsorted(np.asarray(mel_of, np.int64),
                                    np.arange(len(start) + 1))
    return (np.asarray(pieces, np.int32).reshape(-1, 3),
            np.asarray(piece_off, np.int32),
            mel_piece_off.astype(np.int32))



@pytest.mark.parametrize("bank", ["production", "n_mels=64", "n_mels=128",
                                  "random"])
def test_mel_pieces_balance_the_banded_walk(bank):
    """The exact kernel's balanced mel walk: each thread's slice of the
    flattened non-zeros (its pieces, each inside one filter's band), walked
    as its slots with the new-piece flags, and each filter's sum of its
    pieces in order give the banded mel of a power spectrum; slices differ
    by at most one non-zero, and the pieces fit the kernel's scratch of 128
    + n_mels sums."""
    from audio_training_tpu_torch.config import FeaturizerConfig
    from audio_training_tpu_torch.ops.features import build_mel_weights
    from audio_training_tpu_torch.ops.mel import band_tables

    if bank == "random":
        rng = np.random.default_rng(1)
        w = (rng.random((40, 1024)) * (rng.random((40, 1024)) < 0.05)
             ).astype(np.float32)
        w[[3, 17]] = 0.0  # empty filters
    else:
        n_mels = 160 if bank == "production" else int(bank.split("=")[1])
        w = build_mel_weights(FeaturizerConfig(n_mels=n_mels))
    start, length, offset, flat = band_tables(w)
    pieces, piece_off, mel_piece_off = _mel_pieces(start, length, offset)
    slot_w, slot_bin, piece_off2, mel_piece_off2 = ffz.mel_slots(
        start, length, flat)
    np.testing.assert_array_equal(piece_off, piece_off2)
    np.testing.assert_array_equal(mel_piece_off, mel_piece_off2)
    n_mels, nnz = w.shape[0], int(length.sum())
    assert len(pieces) <= ffz.FFT_THREADS + n_mels
    assert piece_off[0] == 0 and piece_off[-1] == len(pieces)
    counts = [pieces[piece_off[t]:piece_off[t + 1], 1].sum()
              for t in range(ffz.FFT_THREADS)]
    assert sum(counts) == nnz and max(counts) - min(counts) <= 1
    assert slot_w.shape[0] % 4 == 0 and slot_w.shape[0] < max(counts) + 4
    power = np.random.default_rng(2).gamma(2.0, 3.0, w.shape[1])
    sums = np.full(len(pieces) + 1, np.nan)
    for t in range(ffz.FFT_THREADS):  # step 5, as the kernel walks slots
        seg, acc = piece_off[t], 0.0
        for j in range(slot_w.shape[0]):
            if slot_bin[j, t] >> 16:
                sums[seg] = acc
                seg, acc = seg + 1, 0.0
            acc += slot_w[j, t] * power[slot_bin[j, t] & 0xffff]
        if piece_off[t + 1] > piece_off[t]:
            assert seg == piece_off[t + 1] - 1
            sums[seg] = acc
    mel = np.array([sums[mel_piece_off[m]:mel_piece_off[m + 1]].sum()
                    for m in range(n_mels)])  # step 6
    want = w.astype(np.float64) @ power
    assert np.abs(mel - want).max() <= 1e-12 * want.max()
    for m in range(n_mels):  # every piece lies in its filter's band
        for fs, n, b0 in pieces[mel_piece_off[m]:mel_piece_off[m + 1]]:
            assert offset[m] <= fs and fs + n <= offset[m] + length[m]
            assert b0 == start[m] + fs - offset[m]
