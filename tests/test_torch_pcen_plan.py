"""K1's PCEN epilogue (``pcen_kernel``) as the kernel computes it, in torch.

``csrc/fused_featurizer.cu::pcen_kernel`` runs only on a card
(tests/test_torch_gpu.py).  It reassociates the EMA of each (clip, mel) row
as a chunked scan: a warp walks its row in chunks of PCEN_LANES x PCEN_RUN
frames, lane l runs the EMA over its PCEN_RUN frames from a zero seed (and
the run's decay d^len as a product of d's), the lanes' affine maps are
composed by a shuffle scan, and each frame adds d^(k+1) times the EMA
before its run.  ``_kernel_pcen`` below follows that walk lane by lane in
f32, with the constants read from the ``.cu``, and is held to the port's
sequential ``ops.pcen.pcen`` and to JAX ``ops/pcen.py::pcen`` (its Toeplitz
EMA) at the kernel's limit, 1e-4 absolute on the image after PCEN's
global min-max to [-1, 1] (the un-normalized image reaches the hundreds at
an onset, where the formulas' f32 roundings alone exceed 1e-4), and its EMA
to 1e-5 of the sequential one's magnitude, at the frame counts
where the runs and chunks fall differently and at smooth 0, 0.04 and 1
(d = 1 and d = 0 exactly).  The chunks a warp stages are checked too:
every element loaded and stored once whatever the buffers' offsets, every
vector access on its boundary.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.ops.pcen import pcen as jax_pcen
from audio_training_tpu_torch.ops.pcen import (ema_scan, normalize_minmax_global,
                                               pcen)

torch.set_num_threads(2)

PCEN_ABS = 1e-4
EMA_REL = 1e-5
GAIN, BIAS, ROOT, EPS = 0.98, 2.0, 2.0, 1e-6
SOURCE = (Path(__file__).resolve().parents[1]
          / "audio_training_tpu_torch/csrc/fused_featurizer.cu")


def _constant(name: str) -> int:
    src = SOURCE.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


LANES, RUN, ROWS = (_constant(n) for n in ("PCEN_LANES", "PCEN_RUN",
                                           "PCEN_ROWS"))


def _kernel_pcen(x: torch.Tensor, gain, bias, root, smooth, eps):
    """pcen_kernel's arithmetic on (rows, T) f32, each row one warp: the
    un-normalized PCEN image and the EMA it used."""
    f = lambda v: torch.tensor(np.float32(v))
    gn = torch.minimum(f(gain), f(1.0))
    one_over_root = f(1.0) / torch.maximum(f(root), f(1.0))
    w = torch.clamp(f(smooth), 0.0, 1.0)
    d = f(1.0) - w
    bias_root = torch.exp(one_over_root * torch.log(f(bias)))
    rows, frames = x.shape
    lane = torch.arange(LANES)
    y = torch.empty_like(x)
    ema_out = torch.empty_like(x)
    carry = x[:, 0].clone()
    for c0 in range(0, frames, LANES * RUN):
        a = c0 + lane * RUN
        length = (frames - a).clamp(0, RUN)
        l = torch.zeros(rows, LANES)
        dn = torch.ones(rows, LANES)
        for k in range(RUN):
            on = k < length
            v = x[:, (a + k).clamp(max=frames - 1)]
            l = torch.where(on, w * v + d * l, l)
            dn = torch.where(on, dn * d, dn)
        off = 1
        while off < LANES:  # __shfl_up_sync: lanes < off keep their own
            dp = torch.cat([dn[:, :off], dn[:, :-off]], 1)
            lp = torch.cat([l[:, :off], l[:, :-off]], 1)
            up = lane >= off
            l = torch.where(up, dn * lp + l, l)
            dn = torch.where(up, dp * dn, dn)
            off *= 2
        de = torch.cat([dn[:, :1], dn[:, :-1]], 1)
        le = torch.cat([l[:, :1], l[:, :-1]], 1)
        m0 = torch.where(lane == 0, carry[:, None], de * carry[:, None] + le)
        carry = dn[:, -1] * carry + l[:, -1]
        lk = torch.zeros(rows, LANES)
        pk = d.expand(rows, LANES)
        for k in range(RUN):
            t = a + k
            on = t < frames
            v = x[:, t.clamp(max=frames - 1)]
            lk = w * v + d * lk
            m = lk + pk * m0
            pk = pk * d
            sp = torch.exp(gn * torch.log(eps + m))
            out = torch.exp(one_over_root * torch.log(v / sp + bias)) - bias_root
            y[:, t[on]] = out[:, on]
            ema_out[:, t[on]] = m[:, on]
    return y, ema_out


def _mel_like(rows: int, frames: int, seed: int) -> np.ndarray:
    """Mel power over five decades, with onsets: a log-normal floor and
    sparse loud frames."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(-4.0, 2.0, (rows, frames)))
    loud = rng.random((rows, frames)) < 0.05
    x[loud] *= 1e3
    return x.astype(np.float32)


def test_constants_give_conflict_free_lanes():
    """A warp's lanes read frame k of their runs at distinct banks (an odd
    run, at any phase of the slice), the warp is the scan's width, and a
    block is PCEN_ROWS whole warps."""
    assert LANES == 32 and RUN % 2 == 1 and 1 <= ROWS <= 32
    for q in range(4):
        for k in range(RUN):
            assert len({(q + RUN * l + k) % 32 for l in range(LANES)}) == LANES


@pytest.mark.parametrize("smooth", [0.0, 0.04, 1.0])
@pytest.mark.parametrize("frames", [1, 31, 32, 33, 513, 1000])
def test_chunked_scan_matches_sequential_and_jax(frames, smooth):
    x = _mel_like(5, frames, frames)
    xt = torch.from_numpy(x)
    got, got_ema = _kernel_pcen(xt, GAIN, BIAS, ROOT, smooth, EPS)
    got = normalize_minmax_global(got)
    want = pcen(xt, GAIN, BIAS, ROOT, smooth, EPS, time_axis=-1)
    want_ema = ema_scan(xt, smooth, xt[:, 0], axis=-1)
    jax_want = np.asarray(jax_pcen(jnp.asarray(x), GAIN, BIAS, ROOT, smooth,
                                   EPS, time_axis=-1))
    assert (got_ema - want_ema).abs().max() <= EMA_REL * want_ema.abs().max()
    assert (got - want).abs().max() < PCEN_ABS
    assert np.abs(got.numpy() - jax_want).max() < PCEN_ABS
    if smooth == 1.0:  # d = 0: the EMA is the frame itself
        assert torch.equal(got_ema, xt)
    if smooth == 0.0:  # d = 1: the EMA stays at frame 0
        assert torch.equal(got_ema, xt[:, :1].expand_as(xt))


@pytest.mark.parametrize("rows,frames", [(13, 1), (13, 31), (5, 33),
                                         (13, 513), (9, 1000), (3, 7300)])
def test_chunks_cover_every_element_once(rows, frames):
    """pcen_kernel's staging and write-back, warp by warp and chunk by
    chunk, with mel and out at each element offset from a 16-byte boundary:
    each element of the flat buffer loaded once into its slice and stored
    once, each float4 load on a 16-byte boundary in device memory and in
    the slice, each bf16 pair store on a 4-byte boundary, every slice index
    inside the slice."""
    src = SOURCE.read_text()
    assert "PCEN_CHUNK = PCEN_LANES * PCEN_RUN;" in src
    assert "PCEN_SLICE = PCEN_CHUNK + 4;" in src
    assert ("PCEN_UNITS = (PCEN_SLICE / 4 + PCEN_LANES - 1) / PCEN_LANES;"
            in src)
    chunk = LANES * RUN
    slice_len = chunk + 4
    units = (slice_len // 4 + LANES - 1) // LANES
    total = rows * frames
    for base in range(4):  # mel's and out's offset in elements
        loaded = np.zeros(total, np.int64)
        stored = {4: np.zeros(total, np.int64), 2: np.zeros(total, np.int64)}
        for row in range(rows):
            for c0 in range(0, frames, chunk):
                n = min(chunk, frames - c0)
                g0 = row * frames + c0  # the chunk's first element
                q = (base + g0) % 4
                u0, u1 = int(q > 0), (q + n) // 4
                hd = min(n, (4 - q) % 4)
                tl = max(hd, 4 * u1 - q)
                for lane in range(LANES):
                    for j in range(units):
                        u = u0 + lane + LANES * j
                        if u < u1:  # a float4: frames 4u - q .. 4u - q + 3
                            assert (base + g0 - q + 4 * u) % 4 == 0
                            assert 4 * u + 4 <= slice_len
                            loaded[g0 - q + 4 * u:g0 - q + 4 * u + 4] += 1
                    if lane < hd:
                        loaded[g0 + lane] += 1
                    if tl + lane < n:
                        assert q + tl + lane < slice_len
                        loaded[g0 + tl + lane] += 1
                stored[4][g0:g0 + n] += 1  # f32: a value a lane
                p_ = (base + g0) % 2  # bf16 pairs from out's 4-byte grid
                for i in range(p_, (p_ + n) // 2):
                    lo = 2 * i - p_
                    assert (base + g0 + lo) % 2 == 0 and lo + 2 <= n
                    stored[2][g0 + lo:g0 + lo + 2] += 1
                if p_:
                    stored[2][g0] += 1
                if (p_ + n) % 2:
                    stored[2][g0 + n - 1] += 1
        assert (loaded == 1).all()
        assert (stored[4] == 1).all() and (stored[2] == 1).all()
