"""The clip pool: tone-band clips over noise, made on the device from the
seed.

A copy of ``chip_smoke.py:551`` ``tone_band_batch``, moved from numpy on the
host to the device: clip ``i`` carries label ``l_i`` (uniform over the
labels) as a tone at that label's frequency (log-spaced, 200 Hz to 10 kHz)
of amplitude U(0.3, 1) and phase U(0, 6.3), over white noise of standard
deviation 0.3.  Labels are one-hot.  Every seed gives the same sizes; the
seed changes only the values.

A workload file sets the traffic: ``batch`` clips a step or request and a
pool of ``pool`` such batches, taken in turn (``slot``).
"""

from __future__ import annotations

import math

import torch

CHUNK = 128  # clips generated per call


def pool(n_clips: int, samples: int, sr: int, num_labels: int, seed: int,
         device) -> tuple[torch.Tensor, torch.Tensor]:
    """(clips (n, samples) float32, one-hot labels (n, num_labels))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(0, num_labels, (n_clips,), generator=gen,
                           device=device)
    amp = 0.3 + 0.7 * torch.rand(n_clips, generator=gen, device=device)
    phase = 6.3 * torch.rand(n_clips, generator=gen, device=device)
    freqs = 200.0 * 50.0 ** (torch.arange(num_labels, device=device,
                                          dtype=torch.float64)
                             / (num_labels - 1))
    t = torch.arange(samples, device=device, dtype=torch.float64) / sr
    clips = torch.empty((n_clips, samples), device=device)
    for lo in range(0, n_clips, CHUNK):
        hi = min(lo + CHUNK, n_clips)
        arg = 2.0 * math.pi * freqs[labels[lo:hi], None] * t + phase[lo:hi, None]
        clips[lo:hi] = (amp[lo:hi, None] * torch.sin(arg)
                        + 0.3 * torch.randn((hi - lo, samples), generator=gen,
                                            device=device, dtype=torch.float64))
    onehot = torch.nn.functional.one_hot(labels, num_labels).to(torch.float32)
    return clips, onehot


def slot(i: int, pool_batches: int) -> int:
    """The pool batch that step or request ``i`` reads."""
    return i % pool_batches
