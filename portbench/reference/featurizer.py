"""The plain featurizer, written from the definitions and not from the
program: per-clip min-max normalize (the reference's ``tfdataset.normalize``),
tf ``pad_end`` framing with a periodic Hann window, the DFT (a float64
real FFT), the power spectrum, the break-frequency mel bank (librosa's
triangles with Slaney's area norm on the mel scale
``2595 log10(1 + f / break_freq)``, the reference's ``custommel.py``), PCEN
(``tfpcen.py``: an EMA over time seeded with frame 0) and the global
min-max to [-1, 1].

Everything runs in float64 and in blocks of clips, on whatever device the
clips are on.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 32  # clips a block: the framed block is 32 x 513 x 4096 float64


def hann(n: int) -> np.ndarray:
    """The periodic Hann window."""
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def mel_bank(sr: float, n_mels: int, fmin: float, fmax: float, n_fft: int,
             break_freq: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float64 triangular filters on the mel scale
    with break frequency ``break_freq``, each scaled to the area
    ``2 / (upper edge - lower edge)`` (Slaney)."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / break_freq)

    def to_hz(m):
        return break_freq * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    edges = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    bins = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    bank = np.zeros((n_mels, bins.size))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rising = (bins - lo) / (mid - lo)
        falling = (hi - bins) / (hi - mid)
        bank[m] = np.maximum(0.0, np.minimum(rising, falling))
        bank[m] *= 2.0 / (hi - lo)
    return bank


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Each clip shifted to a minimum of 0, divided by its shifted maximum,
    1e-6 added, then mapped to [-1, 1]."""
    x = x - x.amin(dim=-1, keepdim=True)
    x = x / x.amax(dim=-1, keepdim=True) + 1e-6
    return (x - 0.5) * 2.0


def frame_count(samples: int, hop: int) -> int:
    """tf.signal.stft's frame count with ``pad_end``: ceil(samples / hop)."""
    return -(-samples // hop)


class MelReference:
    """Clips (B, samples) -> float64 mel power (B, n_mels, frames)."""

    def __init__(self, geometry: dict, device):
        g = geometry
        self.n_fft, self.hop = g["n_fft"], g["hop_length"]
        bank = mel_bank(g["sr"], g["n_mels"], g["fmin"], g["fmax"],
                        g["n_fft"], g["break_freq"])
        # the bins the bank reads: the rest of the spectrum is multiplied
        # by zero
        self.top = int(np.flatnonzero(bank.max(axis=0) > 0)[-1]) + 1
        self.bank = torch.as_tensor(bank[:, :self.top], device=device)
        self.window = torch.as_tensor(hann(self.n_fft), device=device)

    def __call__(self, clips: torch.Tensor) -> torch.Tensor:
        out = []
        for block in clips.split(BLOCK):
            x = block.to(torch.float64)
            frames = frame_count(x.shape[-1], self.hop)
            pad = (frames - 1) * self.hop + self.n_fft - x.shape[-1]
            x = torch.nn.functional.pad(x, (0, pad))
            framed = x.unfold(-1, self.n_fft, self.hop) * self.window
            spec = torch.fft.rfft(framed, dim=-1)[..., :self.top]
            power = spec.real ** 2 + spec.imag ** 2
            out.append(torch.einsum("mf,btf->bmt", self.bank, power))
        return torch.cat(out)


def pcen(mel: torch.Tensor, gain: float = 0.98, bias: float = 2.0,
         root: float = 2.0, smooth: float = 0.04,
         eps: float = 1e-6) -> torch.Tensor:
    """PCEN over the time axis (last) of (B, M, T):
    ``(x / (eps + m) ** gain + bias) ** (1 / root) - bias ** (1 / root)``,
    ``m_t = smooth x_t + (1 - smooth) m_{t-1}`` from ``m_{-1} = x_0``."""
    m = torch.empty_like(mel)
    state = mel[..., 0]
    for t in range(mel.shape[-1]):
        state = smooth * mel[..., t] + (1.0 - smooth) * state
        m[..., t] = state
    inv = 1.0 / root
    return (mel / (eps + m) ** gain + bias) ** inv - bias ** inv


def minmax_global(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor mapped to [-1, 1] by its minimum and maximum."""
    lo, hi = x.min(), x.max()
    return 2.0 * ((x - lo) / (hi - lo)) - 1.0


def image(clips: torch.Tensor, mel: MelReference, front: dict) -> torch.Tensor:
    """The model's input for a batch of clips, float32 NCHW (B, C, M, T):
    ``front["normalize_rows"]`` normalizes each clip first, ``front["pcen"]``
    applies PCEN and the batch's global min-max, ``front["channels"]``
    repeats the image.  The PCEN min-max spans the whole batch, as a
    request's does, so ``clips`` is one request."""
    x = clips
    if front.get("normalize_rows"):
        x = normalize_rows(x.to(torch.float64))
    img = mel(x)
    if front.get("pcen"):
        img = minmax_global(pcen(img))
    img = img.to(torch.float32)[:, None]
    return img.expand(-1, front.get("channels", 1), -1, -1)
