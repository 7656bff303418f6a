"""The port's sidecar enrichment (``corpus/enrich.py``), the detection
pieces it needs (``detect/signals.py``'s ``signal_noise`` keywords,
``get_tracks_from_signals(filter_short=False)`` and ``merge_again``) and the
four ``ops`` names the JAX package's ``ops.__all__`` adds (``mel_f``,
``mel_spec``, ``ema_scan``, ``ema_toeplitz``), each against the JAX
package's on the same inputs made from a numpy seed.

The cases are those of tests/test_aux.py:29-95 and :418-570.  Sidecars are
compared byte for byte; the one field that names the audio file's path is
compared with each package's directory replaced by the same token.  The
EMA forms hold JAX's to a relative 1e-6 of the largest magnitude, and the
gradient of ``ema_toeplitz`` through ``w`` to 1e-5 relative.
"""

import importlib
import json
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

PKGS = ("audio_training_tpu", "audio_training_tpu_torch")
SR = 8000
EMA_REL = 1e-6
EMA_GRAD_REL = 1e-5


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def tone_wav(path, freq=1000, dur=4.0, sr=SR, noise=0.02, seed=0):
    from audio_training_tpu_torch.corpus.audioio import save_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(dur * sr)) / sr
    x = np.sin(2 * np.pi * freq * t).astype(np.float32)
    x += noise * rng.standard_normal(len(x)).astype(np.float32)
    save_wav(path, x, sr)
    return x


def burst_wav(path, starts, dur=10.0, freq=1500, seed=1):
    """Chirp bursts of 1.2 s over a quiet floor (test_aux.py:458-473)."""
    from audio_training_tpu_torch.corpus.audioio import save_wav

    x = np.zeros(int(dur * SR), np.float32)
    t = np.arange(int(1.2 * SR)) / SR
    for start in starts:
        i = int(start * SR)
        x[i:i + len(t)] += np.sin(2 * np.pi * freq * t).astype(np.float32)
    x += 0.005 * np.random.default_rng(seed).standard_normal(len(x)).astype(
        np.float32)
    save_wav(path, x, SR)


def in_both(tmp_path, write):
    """``write(dir)`` into one directory a package; returns the dirs."""
    dirs = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        write(d)
        dirs.append(d)
    return dirs


def sidecars(d) -> dict[str, bytes]:
    """Each ``.txt`` under ``d``, its directory replaced by a token."""
    return {str(p.relative_to(d)): p.read_bytes().replace(
        str(d).encode(), b"<dir>") for p in sorted(d.rglob("*.txt"))}


def assert_same_sidecars(dirs):
    want, got = (sidecars(d) for d in dirs)
    assert got.keys() == want.keys() and got
    for name in got:
        assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# detect/signals: the keywords, filter_short and merge_again
# ---------------------------------------------------------------------------


def signal_view(s) -> tuple:
    return (s.start, s.end, s.freq_start, s.freq_end, s.mass)


@pytest.mark.parametrize("kw", [
    {}, {"hop_length": 200}, {"n_fft": 512},
    {"min_width": 2.0, "min_height": 3.0}, {"min_width": 40.0},
])
def test_signal_noise_keywords_match_jax(kw):
    """``hop_length`` feeds the STFT while the boxes' times stay in
    ``DETECT_HOP`` frames, ``n_fft`` is overridden to 2048, and the two
    minimum sizes filter the components (JAX detect/signals.py:147-212)."""
    rng = np.random.default_rng(3)
    x = 0.01 * rng.standard_normal(6 * SR).astype(np.float32)
    t = np.arange(int(0.8 * SR)) / SR
    for start, f in ((0.5, 1200), (2.5, 2500), (4.0, 600)):
        i = int(start * SR)
        x[i:i + len(t)] += np.sin(2 * np.pi * f * t).astype(np.float32)
    want, got = (mod(pkg, "detect.signals").signal_noise(x, SR, **kw)
                 for pkg in PKGS)
    assert [signal_view(s) for s in got[0]] == [
        signal_view(s) for s in want[0]]
    np.testing.assert_array_equal(got[1], want[1])
    if not kw:
        assert got[0]


@pytest.mark.parametrize("filter_short", [True, False])
def test_tracks_from_signals_filter_short_matches_jax(filter_short):
    """Sub-0.35 s signals survive only with ``filter_short=False``."""
    spans = [(0.2, 0.4, 900, 2400), (0.45, 0.6, 1000, 2600),
             (2.0, 2.2, 400, 3000), (4.0, 5.5, 1500, 4000),
             (9.0, 16.5, 800, 2000)]

    def run(pkg):
        sig = mod(pkg, "detect.signals")
        signals = [sig.Signal(*s, 1) for s in spans]
        return [signal_view(t) for t in sig.get_tracks_from_signals(
            signals, 17.0, filter_short=filter_short)]

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want and got


def test_short_signals_kept_only_without_filter():
    from audio_training_tpu_torch.detect.signals import (
        Signal,
        get_tracks_from_signals,
    )

    def n_tracks(filter_short):
        return len(get_tracks_from_signals(
            [Signal(2.0, 2.2, 400, 3000, 1)], 10.0,
            filter_short=filter_short))

    assert n_tracks(True) == 0 and n_tracks(False) == 1


MERGE_CASES = {
    "replace": [(0.0, 1.0, 1000, 2000), (0.2, 3.0, 1000, 2000)],
    "extend": [(0.0, 2.0, 1000, 2000), (1.8, 2.5, 1100, 1900)],
    "gap": [(0.0, 1.0, 1000, 2000), (5.0, 6.0, 1000, 2000)],
    "mixed": [(3.0, 4.0, 500, 900), (0.0, 2.0, 1000, 2000),
              (1.9, 2.4, 1200, 1800), (3.5, 3.6, 4000, 6000),
              (7.0, 9.0, 1000, 3000), (7.5, 12.0, 900, 3100)],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_again_matches_jax(case):
    """test_aux.py:419-438's rules (a newcomer covering the current track
    replaces it, a frequency overlap extends it, gap-separated tracks
    appear once) and a mixed, unsorted list."""
    def run(pkg):
        sig = mod(pkg, "detect.signals")
        tracks = [sig.Signal(*s, 1) for s in MERGE_CASES[case]]
        return [(tracks.index(t), signal_view(t))
                for t in sig.merge_again(tracks)]

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want
    if case == "replace":
        assert [i for i, _ in got] == [1]
    if case == "extend":
        assert got == [(0, (0.0, 2.5, 1000.0, 2000.0, 1))]
    if case == "gap":
        assert [i for i, _ in got] == [0, 1]


# ---------------------------------------------------------------------------
# ops: mel_f, mel_spec, ema_scan, ema_toeplitz and the dispatcher
# ---------------------------------------------------------------------------


def test_ops_exports_jax_names():
    jops, tops = (mod(pkg, "ops") for pkg in PKGS)
    assert tops.__all__ == jops.__all__ and len(tops.__all__) == 21
    assert all(callable(getattr(tops, n)) for n in tops.__all__)
    assert tops.mel_f is tops.mel_filterbank


def test_mel_spec_matches_jax():
    rng = np.random.default_rng(4)
    stft = (rng.standard_normal((257, 40))
            + 1j * rng.standard_normal((257, 40))).astype(np.complex64)
    args = (stft, 16000, 512, 160, 48, 50.0, 8000.0)
    for power in (1, 2):
        want, got = (mod(pkg, "ops.mel").mel_spec(*args, power=power)
                     for pkg in PKGS)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (48, 40)


def _ema_inputs(frames: int, seed: int = 7):
    x = np.random.default_rng(seed).gamma(2.0, 10.0, (2, 6, frames)).astype(
        np.float32)
    return x, x[..., 0].copy()


def _assert_rel(got, want, rel):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("form", ["ema_scan", "ema_toeplitz"])
@pytest.mark.parametrize("frames", [1, 513])
def test_ema_forms_match_jax(form, frames):
    import jax
    import jax.numpy as jnp

    x, init = _ema_inputs(frames)
    jax_form = jax.jit(getattr(mod(PKGS[0], "ops.pcen"), form))
    for smooth in (0.0, 0.04, 0.5, 1.0):
        want = jax_form(jnp.asarray(x), jnp.float32(smooth),
                        jnp.asarray(init))
        got = getattr(mod(PKGS[1], "ops.pcen"), form)(
            torch.from_numpy(x), smooth, torch.from_numpy(init), axis=2)
        assert got.dtype == torch.float32
        _assert_rel(got.numpy(), want, EMA_REL)


def test_ema_toeplitz_gradient_through_w_matches_jax():
    import jax
    import jax.numpy as jnp

    x, init = _ema_inputs(120, seed=9)
    g = np.random.default_rng(10).standard_normal(x.shape).astype(np.float32)
    jpcen, tpcen = (mod(pkg, "ops.pcen") for pkg in PKGS)

    def jloss(w):
        return jnp.sum(jpcen.ema_toeplitz(jnp.asarray(x), w,
                                          jnp.asarray(init)) * g)

    for w0 in (0.04, 0.3):
        want = float(jax.grad(jloss)(jnp.float32(w0)))
        w = torch.tensor(w0, requires_grad=True)
        (tpcen.ema_toeplitz(torch.from_numpy(x), w, torch.from_numpy(init))
         * torch.from_numpy(g)).sum().backward()
        assert abs(w.grad.item() - want) <= EMA_GRAD_REL * abs(want)


@pytest.mark.parametrize("frames,method", [(33, "auto"), (1025, "auto"),
                                           (33, "scan"), (33, "toeplitz")])
def test_ema_dispatch_matches_jax(frames, method):
    """``auto`` takes the Toeplitz form up to ``_TOEPLITZ_MAX_T`` frames and
    the recurrence beyond, as JAX ops/pcen.py:88-96 does."""
    import jax
    import jax.numpy as jnp

    x, init = _ema_inputs(frames)
    jpcen, tpcen = (mod(pkg, "ops.pcen") for pkg in PKGS)
    assert tpcen._TOEPLITZ_MAX_T == jpcen._TOEPLITZ_MAX_T
    want = jax.jit(jpcen.ema, static_argnames="method")(
        jnp.asarray(x), jnp.float32(0.04), jnp.asarray(init), method=method)
    got = tpcen.ema(torch.from_numpy(x), 0.04, torch.from_numpy(init),
                    method=method)
    _assert_rel(got.numpy(), want, EMA_REL)
    form = ("toeplitz" if method == "toeplitz"
            or (method == "auto" and frames <= 1024) else "scan")
    direct = getattr(tpcen, f"ema_{form}")(
        torch.from_numpy(x), 0.04, torch.from_numpy(init))
    assert torch.equal(got, direct)


def test_pcen_default_keeps_the_recurrence():
    """``pcen`` smooths with the sequential recurrence, the plain version of
    the CUDA PCEN kernel, not with the dispatcher's Toeplitz form."""
    from audio_training_tpu_torch.ops.pcen import ema_scan, pcen

    x = torch.from_numpy(np.random.default_rng(11).gamma(
        2.0, 50.0, (2, 40, 64)).astype(np.float32))
    m = ema_scan(x, 0.04, x[:, :, 0], axis=2)
    want = (x / (1e-6 + m) ** 0.98 + 2.0) ** 0.5 - 2.0 ** 0.5
    got = pcen(x, time_axis=2, normalize=False)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


# ---------------------------------------------------------------------------
# corpus/enrich
# ---------------------------------------------------------------------------


def test_band_rms_matches_jax():
    from audio_training_tpu_torch.detect.signals import _host_stft_mag

    x = np.random.default_rng(0).standard_normal(48000).astype(np.float32)
    mag = _host_stft_mag(x, 4096, 281)
    for lo, hi in ((None, None), (10, None), (None, 300), (42, 64)):
        want, got = (mod(pkg, "corpus.enrich").band_rms(mag, lo, hi)
                     for pkg in PKGS)
        np.testing.assert_array_equal(got, want)
    assert got.shape[0] == mag.shape[1]
    full = mod(PKGS[1], "corpus.enrich").band_rms(mag, None, None)
    assert 0.05 < full.mean() < 2.0


@pytest.mark.parametrize("tag", ["morepork", "ausbit1", "rain"])
def test_process_rms_matches_jax(tmp_path, tag):
    """The RMS arrays and band bins of each track, the species caps of
    morepork and bittern (otherdata.py:1262-1264), and the no-op second
    call."""
    meta = {"id": "r", "Tracks": [
        {"id": "t0", "start": 0.5, "end": 3.5,
         "tags": [{"what": tag, "automatic": False}]},
        {"id": "t1", "start": 3.9, "end": 4.0,
         "tags": [{"what": "noise", "automatic": False}]}]}

    def write(d):
        tone_wav(d / "r.wav", freq=900, dur=4.0)
        (d / "r.txt").write_text(json.dumps(meta))

    dirs = in_both(tmp_path, write)
    for pkg, d in zip(PKGS, dirs):
        enrich = mod(pkg, "corpus.enrich")
        assert enrich.process_rms(d / "r.txt", target_sr=SR)
        assert not enrich.process_rms(d / "r.txt", target_sr=SR)
    assert_same_sidecars(dirs)
    t = json.loads((dirs[1] / "r.txt").read_text())["Tracks"][0]
    assert len(t["bird_rms"]) > 10
    assert len(t["bird_rms_bin"]) == (1 if tag == "rain" else 2)


def test_add_signal_meta_matches_jax(tmp_path):
    def write(d):
        tone_wav(d / "s.wav", freq=2000, dur=5.0, noise=0.005)
        burst_wav(d / "b.wav", (1.0, 4.0, 7.0))
        for name in ("s", "b"):
            (d / f"{name}.txt").write_text(json.dumps({"id": name}))

    dirs = in_both(tmp_path, write)
    for pkg, d in zip(PKGS, dirs):
        enrich = mod(pkg, "corpus.enrich")
        for name in ("s", "b"):
            assert enrich.add_signal_meta(d / f"{name}.txt", target_sr=SR)
            assert not enrich.add_signal_meta(d / f"{name}.txt", target_sr=SR)
    assert_same_sidecars(dirs)
    s = json.loads((dirs[1] / "s.txt").read_text())["signal"][0]
    assert s[2] < 2000 < s[3]


def test_generate_tracks_matches_jax(tmp_path):
    def write(d):
        burst_wav(d / "g.wav", (1.0,), dur=6.0, seed=0)
        (d / "g.txt").write_text(json.dumps({"id": "g", "label": "kiwi"}))
        tone_wav(d / "h.wav", dur=3.0)
        (d / "h.txt").write_text(json.dumps({"id": "h", "Tracks": [
            {"id": "x", "start": 0, "end": 1}]}))

    dirs = in_both(tmp_path, write)
    for pkg, d in zip(PKGS, dirs):
        enrich = mod(pkg, "corpus.enrich")
        assert enrich.generate_tracks(d / "g.txt", target_sr=SR)
        assert not enrich.generate_tracks(d / "h.txt", target_sr=SR)
    assert_same_sidecars(dirs)
    meta = json.loads((dirs[1] / "g.txt").read_text())
    assert meta["Tracks"] and meta["Tracks"][0]["tags"][0]["what"] == "kiwi"


SEGMENT_CASES = [
    ([(1.0, 2.0), (2.5, 4.0)], 1.5, 4.5),
    ([(1.0, 5.0)], 1.5, 4.5),
    ([(1.0, 2.0), (2.5, 4.0)], 5.0, 8.0),
    ([(0.0, 0.5), (0.2, 6.0), (3.0, 3.5)], 0.0, 3.0),
]


@pytest.mark.parametrize("case", range(len(SEGMENT_CASES)))
def test_signal_length_for_segment_matches_jax(case):
    spans, s0, s1 = SEGMENT_CASES[case]

    def run(pkg):
        sig = mod(pkg, "detect.signals")
        tracks = [sig.Signal(a, b, 0, 100, 1) for a, b in spans]
        return mod(pkg, "corpus.enrich").signal_length_for_segment(
            tracks, s0, s1)

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want
    assert got == pytest.approx([1.5, 3.0, 0.0, 3.3][case])


def test_best_segment_from_tracks_matches_jax():
    spans = [(0.4, 1.0), (4.0, 5.2), (5.5, 6.7), (9.0, 9.3)]

    def run(pkg, end):
        sig = mod(pkg, "detect.signals")
        tracks = [sig.Signal(a, b, 0, 100, 1) for a, b in spans]
        return mod(pkg, "corpus.enrich").best_segment_from_tracks(
            tracks, end)

    for end in (2.0, 10.0, 12.5):
        assert run(PKGS[1], end) == run(PKGS[0], end)


def test_generate_best_track_matches_jax(tmp_path):
    def write(d):
        burst_wav(d / "b.wav", (4.0, 5.5))
        (d / "b.txt").write_text(json.dumps({"id": "b", "label": "weka"}))
        (d / "n.txt").write_text(json.dumps({"id": "n"}))

    dirs = in_both(tmp_path, write)
    for pkg, d in zip(PKGS, dirs):
        enrich = mod(pkg, "corpus.enrich")
        assert enrich.add_signal_meta(d / "b.txt", target_sr=SR)
        assert enrich.generate_best_track(d / "b.txt")
        assert not enrich.generate_best_track(d / "n.txt")
    assert_same_sidecars(dirs)
    bt = json.loads((dirs[1] / "b.txt").read_text())["best_track"]
    assert bt["tags"][0]["what"] == "weka" and bt["end"] == bt["start"] + 3
    assert bt["start"] < 7.0 and bt["end"] > 4.0 and bt["signal_length"] > 0


def test_analyze_rms_matches_jax(tmp_path):
    def write(d):
        tone_wav(d / "q.wav", freq=900, dur=5.0)
        (d / "q.txt").write_text(json.dumps({"id": "q", "Tracks": [
            {"id": "t0", "start": 0.0, "end": 5.0,
             "tags": [{"what": "morepork", "automatic": False}]},
            {"id": "t1", "start": 1.0, "end": 4.5,
             "tags": [{"what": "rain", "automatic": False}]},
            {"id": "t2", "start": 1.0, "end": 2.0, "tags": []}]}))

    dirs = in_both(tmp_path, write)
    reports = []
    for pkg, d in zip(PKGS, dirs):
        enrich = mod(pkg, "corpus.enrich")
        assert enrich.process_rms(d / "q.txt", target_sr=SR)
        reports.append(enrich.analyze_rms(d / "q.txt"))
        assert enrich.analyze_rms(d / "absent.txt") == []
    want, got = reports
    assert got == want and len(got) == 2
    assert got[0]["used"] == "bird_rms" and got[1]["used"] == "noise_rms"


def write_enrich_corpus(root, n=6):
    """Recordings of 6 s at 8 kHz with a species track each, bursts at
    species frequencies, and an empty-Tracks one for ``--gen-tracks``."""
    from audio_training_tpu_torch.corpus.audioio import save_wav

    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        x = 0.01 * rng.standard_normal(6 * SR)
        t = np.arange(6 * SR) / SR
        on = (t > 0.5 + 0.2 * i) & (t % 2 < 1.2)
        x += on * 0.5 * np.sin(2 * np.pi * (600 + 400 * (i % 3)) * t)
        save_wav(root / f"e{i}.wav", x.astype(np.float32), SR)
        tracks = [] if i == n - 1 else [
            {"id": f"e{i}t0", "start": 0.5, "end": 5.0,
             "tags": [{"what": ("kiwi", "morepork", "rain")[i % 3],
                       "automatic": False}]}]
        (root / f"e{i}.txt").write_text(json.dumps(
            {"id": f"e{i}", "label": "kiwi", "Tracks": tracks}))


@pytest.mark.parametrize("flags", [
    dict(rms=True, signal=True),
    dict(rms=False, signal=True, best_track=True),
    dict(rms=False, signal=False, gen_tracks=True),
])
def test_enrich_folder_matches_jax(tmp_path, flags):
    """JAX's ``enrich_folder`` in-process against the port's: the count
    and every sidecar byte for byte."""
    dirs = in_both(tmp_path, write_enrich_corpus)
    counts = [mod(pkg, "corpus.enrich").enrich_folder(d, workers=1, **flags)
              for pkg, d in zip(PKGS, dirs)]
    assert counts[1] == counts[0] > 0
    assert_same_sidecars(dirs)


def test_enrich_folder_workers_write_the_same_bytes(tmp_path):
    """The port's spawned workers write the sidecars that one process
    writes (and JAX's in-process run writes)."""
    src = tmp_path / "src"
    write_enrich_corpus(src)
    runs = {}
    for name, pkg, workers in (("jax", PKGS[0], 1), ("one", PKGS[1], 1),
                               ("two", PKGS[1], 2)):
        d = tmp_path / name
        shutil.copytree(src, d)
        n = mod(pkg, "corpus.enrich").enrich_folder(d, workers=workers)
        runs[name] = (n, sidecars(d))
    assert runs["two"] == runs["one"] == runs["jax"]
    assert runs["one"][0] == 2 * 6
