"""Audio decode, resample and write (host), a copy of
``audio_training_tpu/corpus/audioio.py``.

The reference decodes via librosa/audioread/ffmpeg subprocesses
(audiowriter.load_recording, audiowriter.py:350-357).  Neither librosa nor
ffmpeg is bundled here, so: WAV decodes natively (scipy.io.wavfile), other
containers (m4a/mp3/flac) go through ffmpeg when present and raise a clear
error otherwise.  Resampling is polyphase (scipy.signal.resample_poly).
"""

from __future__ import annotations

import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np

DEFAULT_SR = 48000


def ffmpeg_path() -> str | None:
    return shutil.which("ffmpeg")


def load_wav(path: str | Path) -> tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def load_via_ffmpeg(path: str | Path, sr: int | None = None) -> tuple[np.ndarray, int]:
    ff = ffmpeg_path()
    if ff is None:
        raise RuntimeError(
            f"cannot decode {path}: ffmpeg not available and file is not WAV"
        )
    out_sr = sr or DEFAULT_SR
    cmd = [ff, "-v", "error", "-i", str(path), "-f", "f32le", "-ac", "1",
           "-ar", str(out_sr), "-"]
    proc = subprocess.run(cmd, capture_output=True, check=True)
    return np.frombuffer(proc.stdout, np.float32).copy(), out_sr


def resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return data
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(data, frac.numerator, frac.denominator).astype(
        np.float32
    )


def load_recording(
    path: str | Path, target_sr: int | None = DEFAULT_SR
) -> tuple[np.ndarray, int]:
    """Decode any supported container to mono float32 at ``target_sr``
    (audiowriter.load_recording parity)."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        data, sr = load_wav(path)
    else:
        return load_via_ffmpeg(path, target_sr)
    if target_sr is not None and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


def probe_duration(path: str | Path) -> float | None:
    """ffprobe duration cross-check (audiowriter.get_ffmpeg_duration,
    audiowriter.py:333-347); None when ffprobe is unavailable."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        p = Path(path)
        if p.suffix.lower() == ".wav":
            try:
                data, sr = load_wav(p)
                return len(data) / sr
            except Exception:
                return None
        return None
    try:
        out = subprocess.run(
            [ffprobe, "-v", "error", "-show_entries", "format=duration",
             "-of", "default=noprint_wrappers=1:nokey=1", str(path)],
            capture_output=True, check=True,
        )
        return float(out.stdout.strip())
    except Exception:
        return None


def save_wav(path: str | Path, data: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), sr, np.asarray(data, np.float32))
