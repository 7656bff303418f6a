"""The port's pipeline checker (``utils/debug.py``, ``cli/debug.py``), its
offline mixup writer (``data/augmented.py``, ``cli/augment.py``) and the
default build end to end, each against the JAX package's.

The end-to-end case enriches one raw corpus with each package's
``enrich_folder`` (band RMS and signal spans), builds each enriched copy
with its own ``cli/build`` at the defaults (tracks tightened and filtered by
RMS) under the same fixed randomness as tests/test_torch_corpus.py, and
mixes each build's train split with its own ``create_augmented_set``.
Sidecars are byte-identical (each package's directory replaced by one
token), ``training-meta.json`` is byte-identical, and the shards, build
and mixed, decompress to equal bytes (GZIP stamps the time into each
header).  The cases follow tests/test_aux.py:311-337 and :402-416 and
tests/test_cli.py:215 and :258.
"""

import gzip
import importlib
import json
import shutil

import numpy as np
import pytest
import torch

from test_torch_corpus import BUILD_GEOMETRY, both

torch.set_num_threads(2)

PKGS = ("audio_training_tpu", "audio_training_tpu_torch")
SR = 8000
SPECIES = ("kiwi", "morepork", "tui")
DEBUG_GEOMETRY = ["--mels", "32", "--n-fft", "512", "--hop-length", "100"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def write_raw(root, n=12):
    """``n`` recordings of 7 s at 8 kHz: a species' bursts (1.2 s every
    2 s) under a 5 s track, every third with a rain track, and no RMS or
    signal metadata."""
    from audio_training_tpu_torch.corpus.audioio import save_wav

    root.mkdir(parents=True)
    t = np.arange(7 * SR) / SR
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        start = 0.5 + 0.1 * i
        on = (t >= start) & (t < start + 5.0) & ((t - start) % 2 < 1.2)
        x = 0.01 * rng.standard_normal(len(t))
        x += on * 0.5 * np.sin(2 * np.pi * (700 + 500 * (i % 3)) * t)
        save_wav(root / f"rec{i}.wav", x.astype(np.float32), SR)
        tracks = [{"id": f"t{i}_0", "start": start, "end": start + 5.0,
                   "tags": [{"what": SPECIES[i % 3], "automatic": False}],
                   "minFreq": 300.0, "maxFreq": 3000.0}]
        if i % 3 == 0:
            tracks.append({"id": f"t{i}_1", "start": 4.0, "end": 6.5,
                           "tags": [{"what": "rain", "automatic": False}]})
        (root / f"rec{i}.txt").write_text(json.dumps({
            "id": f"rec{i}", "duration": 7.0,
            "location": {"lat": -43.5 + i, "lng": 172.6}, "Tracks": tracks}))


def sidecars(d) -> dict[str, bytes]:
    return {p.name: p.read_bytes().replace(str(d).encode(), b"<dir>")
            for p in sorted(d.glob("*.txt"))}


def streams(d, pattern="**/*.tfrecord") -> dict[str, bytes]:
    return {str(p.relative_to(d)): gzip.decompress(p.read_bytes())
            for p in sorted(d.glob(pattern))}


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Each package's enriched copy of one raw corpus and its default
    build: ``{pkg: (raw dir, training-data dir)}``."""
    root = tmp_path_factory.mktemp("default_build")
    write_raw(root / "src")
    out = {}
    for pkg in PKGS:
        raw = root / pkg / "raw"
        shutil.copytree(root / "src", raw)
        n = mod(pkg, "corpus.enrich").enrich_folder(raw, rms=True,
                                                     signal=True)
        assert n == 24
        out[pkg] = raw

    def build(pkg):
        dst = root / pkg / "build"
        argv = [str(dst), "-d", str(out[pkg]), *BUILD_GEOMETRY,
                "--workers", "1"]
        assert mod(pkg, "cli.build").main(argv) == 0
        return dst / "training-data"

    data = both(build)
    return {pkg: (out[pkg], d) for pkg, d in zip(PKGS, data)}


def test_enriched_sidecars_match_jax(builds):
    (jraw, _), (traw, _) = builds.values()
    want, got = sidecars(jraw), sidecars(traw)
    assert got == want and len(got) == 12
    for body in got.values():
        meta = json.loads(body)
        assert "signal" in meta
        assert all({"upper_rms", "noise_rms", "bird_rms"} <= t.keys()
                   for t in meta["Tracks"])


def test_default_build_matches_jax(builds):
    """The default build (tightened, RMS-filtered) writes JAX's records
    and ``training-meta.json``, and every split holds samples."""
    (_, jdata), (_, tdata) = builds.values()
    meta = (tdata / "training-meta.json").read_bytes()
    assert meta == (jdata / "training-meta.json").read_bytes()
    got, want = streams(tdata), streams(jdata)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name] == want[name], name
    counts = json.loads(meta)["counts"]
    assert all(counts[s]["sample_counts"] for s in ("train", "validation"))


@pytest.mark.parametrize("seed,per_shard", [(0, 1000), (3, 4)])
def test_create_augmented_set_matches_jax(builds, tmp_path, seed, per_shard):
    """``mixed-*.tfrecord`` from each package's build decompress equal, and
    the port's RecordStream reads every record the writer counted."""
    def run(pkg):
        _, data = builds[pkg]
        shards = sorted((data / "train").glob("*.tfrecord"))
        out = tmp_path / pkg
        n = mod(pkg, "data.augmented").create_augmented_set(
            shards, out, records_per_shard=per_shard, seed=seed)
        return n, streams(out, "mixed-*.tfrecord")

    (jn, want), (tn, got) = (run(pkg) for pkg in PKGS)
    assert tn == jn > 0 and got == want
    assert len(got) == -(-tn // per_shard)
    from audio_training_tpu_torch.data import read_tfrecords

    assert sum(1 for shard in sorted((tmp_path / PKGS[1]).glob("*.tfrecord"))
               for _ in read_tfrecords(shard)) == tn


def test_create_augmented_set_small_inputs_match_jax(tmp_path):
    """tests/test_aux.py:311-332 on four 1000-sample records, plus an
    empty-waveform and a shorter record, which are skipped, and a single
    record, which writes nothing."""
    rng = np.random.default_rng(0)
    raws = [rng.standard_normal(1000).astype(np.float32) for _ in range(4)]
    raws += [np.zeros(0, np.float32), rng.standard_normal(7).astype(
        np.float32)]

    def run(pkg):
        data = mod(pkg, "data")
        recs = [data.encode_sample(data.SampleRecord(
            raw=raw, tags=[tag], rec_id=f"r{i}", track_ids=[i],
            signal_percent=0.1 * i))
            for i, (raw, tag) in enumerate(zip(raws, [
                "kiwi", "morepo2", "rain", "noise", "tui", "kea"]))]
        src = tmp_path / f"{pkg}.tfrecord"
        data.write_tfrecords(src, recs)
        one = tmp_path / f"{pkg}-one.tfrecord"
        data.write_tfrecords(one, recs[:1])
        aug = mod(pkg, "data.augmented")
        n = aug.create_augmented_set([src], tmp_path / pkg, seed=1)
        assert aug.create_augmented_set([one], tmp_path / f"{pkg}-1") == 0
        return n, streams(tmp_path / pkg, "*.tfrecord")

    (jn, want), (tn, got) = (run(pkg) for pkg in PKGS)
    assert tn == jn > 0 and got == want


def test_mix_records_matches_jax():
    def run(pkg):
        schema = mod(pkg, "data.schema")
        a = schema.SampleRecord(raw=np.ones(8, np.float32), tags=["b", "a"],
                                rec_id="x", track_ids=[2], min_freq=100.0,
                                max_freq=900.0, signal_percent=0.5)
        b = schema.SampleRecord(raw=np.full(8, 3, np.float32), tags=["c"],
                                text_tags=["t"], track_ids=[1, 2],
                                min_freq=50.0, max_freq=4000.0)
        m = mod(pkg, "data.augmented").mix_records(a, b, 0.25)
        return schema.encode_sample(m)

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want


def test_augment_cli_matches_jax(builds, tmp_path):
    def run(pkg):
        _, data = builds[pkg]
        main = mod(pkg, "cli.augment").main
        out = tmp_path / pkg
        rc = main([str(data), str(out), "--records-per-shard", "5",
                   "--min-weight", "0.3", "--max-weight", "0.6",
                   "--seed", "2"])
        missing = main([str(data), str(tmp_path / f"{pkg}-x"), "--split",
                        "nope"])
        return rc, missing, streams(out)

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want
    assert got[:2] == (0, 1) and got[2]


# ---------------------------------------------------------------------------
# utils/debug and cli/debug
# ---------------------------------------------------------------------------


def result_view(res) -> dict:
    return {k: getattr(res, k) for k in ("checked", "nan_count",
                                         "out_of_range", "constant",
                                         "label_counts")} | {"ok": res.ok}


def test_check_pipeline_matches_jax():
    good = np.zeros((2, 10), np.float32)
    good[:, 0] = 1.0
    bad = np.full((1, 10), np.nan, np.float32)
    wide = np.linspace(-3, 3, 30, dtype=np.float32).reshape(3, 10)
    flat = np.ones((1, 10), np.float32)
    y = np.eye(2, 3, dtype=np.float32)
    batches = [(good, y), (bad, y[:1]), (wide, np.eye(3, dtype=np.float32)),
               (flat, np.zeros((1, 3), np.float32))]

    def run(pkg, **kw):
        return result_view(mod(pkg, "utils.debug").check_pipeline(
            batches, ["a", "b", "c"], **kw))

    for kw in ({}, {"max_batches": 2}, {"value_range": (-5.0, 5.0)}):
        want, got = (run(pkg, **kw) for pkg in PKGS)
        assert got == want
    got = run(PKGS[1])
    assert got["checked"] == 7 and got["nan_count"] == 1
    assert got["constant"] == 1 and not got["ok"]
    assert got["label_counts"]["a"] == 3


def test_debug_labels_matches_jax():
    def run(pkg):
        labels = mod(pkg, "taxonomy.labels")
        ont = mod(pkg, "taxonomy.ontology").load_ontology()
        space = labels.build_label_space(
            ont, ["bird", "kiwi", "morepork", "rain", "tui", "nope"])
        return mod(pkg, "utils.debug").debug_labels(space)

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want and got


@pytest.mark.parametrize("argv", [
    ["--batches", "1", "--batch-size", "1"],
    ["--split", "validation", "--batches", "20", "--batch-size", "3"],
])
def test_debug_cli_matches_jax(builds, tmp_path, argv):
    """``cli/debug`` on the default build with ``--device cpu``: JAX's exit
    code and ``PipelineCheckResult``; ``--show`` renders the batches that
    the check left in the one-pass stream, as JAX's does (none after a
    pass over the whole split)."""
    def run(pkg):
        _, data = builds[pkg]
        debug = mod(pkg, "cli.debug")
        full = [str(data), *DEBUG_GEOMETRY, *argv]
        if pkg == PKGS[1]:
            full += ["--device", "cpu"]
        seen = []
        util = mod(pkg, "utils.debug")
        orig = util.check_pipeline

        def spy(*a, **k):  # the CLI imports it from here at each call
            res = orig(*a, **k)
            seen.append(result_view(res))
            return res

        util.check_pipeline = spy
        try:
            rc = debug.main(full + ["--show", str(tmp_path / pkg)])
        finally:
            util.check_pipeline = orig
        return rc, seen, sorted(p.name for p in (tmp_path / pkg).iterdir())

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want
    rc, (res,), images = got
    assert rc == 0 and res["checked"] > 0 and res["ok"]
    assert bool(images) == (argv[0] == "--batches")


def test_debug_pipeline_returns_the_result(builds):
    from audio_training_tpu_torch.cli import debug

    _, data = builds[PKGS[1]]
    args = debug.parse_args([str(data), *DEBUG_GEOMETRY, "--batches", "1",
                             "--batch-size", "2", "--device", "cpu"])
    res = debug.debug_pipeline(args)
    assert res.checked == 2 and res.ok and sum(res.label_counts.values())


def test_debug_cli_on_cuda_without_a_card_fails(builds):
    """``--device cuda`` (the default) does not carry on on the CPU."""
    from audio_training_tpu_torch.cli import debug

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py runs it")
    _, data = builds[PKGS[1]]
    with pytest.raises((AssertionError, RuntimeError)):
        debug.main([str(data), *DEBUG_GEOMETRY, "--batches", "1"])


def test_debug_parse_args_match_jax():
    argv = ["d", "--batches", "3", "--show", "s"]
    want, got = (vars(mod(pkg, "cli.debug").parse_args(argv)) for pkg in PKGS)
    assert got.pop("device") == "cuda"
    assert got == want
