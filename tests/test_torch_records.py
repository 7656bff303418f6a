"""The port's record format and host loaders against the JAX package's,
exactly.

* ``data/example.py``, ``data/tfrecord.py`` and ``data/schema.py``: the
  bytes either package writes are equal, and each package reads the
  other's, with the native codec and with the numpy CRC;
* ``RecordStream``, ``BatchLoader`` and ``build_training_stream`` yield
  bitwise the JAX package's samples, labels, mixup partners and lat/lng
  for the same seed, over a 3-shard corpus of short clips, with the
  decode-time filters (low samples, bird-only, band-passed variants) and
  the RAM cache on and off;
* ``ParallelLoader`` with 2 spawned workers yields the multiset of the
  single-process stream.
"""

import gzip
import itertools
import zlib

import numpy as np
import pytest
import torch

from audio_training_tpu.data import _native as j_native
from audio_training_tpu.data import example as jex
from audio_training_tpu.data import pipeline as jpipe
from audio_training_tpu.data import schema as jschema
from audio_training_tpu.data import tfrecord as jtf
from audio_training_tpu.taxonomy.labels import build_label_space as jbuild
from audio_training_tpu.taxonomy.ontology import load_ontology as jload
from audio_training_tpu_torch.data import _native
from audio_training_tpu_torch.data import example as ex
from audio_training_tpu_torch.data import pipeline as pipe
from audio_training_tpu_torch.data import schema
from audio_training_tpu_torch.data import tfrecord as tf
from audio_training_tpu_torch.data.parallel_loader import ParallelLoader
from audio_training_tpu_torch.taxonomy.labels import build_label_space
from audio_training_tpu_torch.taxonomy.ontology import load_ontology

torch.set_num_threads(2)

CLIP = 800
TAGS = [["kiwi"], ["morepo2"], ["tui1"], ["bird"], ["kiwi", "tui1"],
        ["rain"], ["morepo2", "bird"]]
SOURCE_LABELS = ["bird", "kiwi", "morepo2", "rain", "tui1"]


@pytest.fixture(params=["native", "numpy"])
def crc(request, monkeypatch):
    """Both packages' codecs with the native library, or with the numpy
    CRC and the Python framing (the library made unavailable)."""
    if request.param == "numpy":
        for mod in (_native, j_native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    else:
        assert _native.get_lib() is not None
        assert j_native.get_lib() is not None
    return request.param


def _features(m):
    return {
        "b": m.bytes_feature(b"\x00abc\xff"),
        "bl": m.bytes_list_feature([b"x", b"", "ü".encode()]),
        "f": m.float_feature(-1.25),
        "fl": m.float_list_feature(np.linspace(-3, 3, 37, dtype=np.float32)),
        "i": m.int64_feature(-7),
        "il": m.int64_list_feature([0, 1, 2**40, -(2**62), 300]),
    }


def test_example_bytes_match_jax_both_ways():
    data = ex.encode_example(_features(ex))
    assert data == jex.encode_example(_features(jex))
    for dec in (ex.decode_example, jex.decode_example):
        f = dec(data)
        assert f["bl"].bytes_list() == [b"x", b"", "ü".encode()]
        assert f["il"].int64_list() == [0, 1, 2**40, -(2**62), 300]
        assert f["i"].scalar_int() == -7 and f["f"].scalar_float() == -1.25
        np.testing.assert_array_equal(
            f["fl"].float_array(), np.linspace(-3, 3, 37, dtype=np.float32))


def _record(m, rng, full=True):
    """A SampleRecord of package ``m`` with every optional field set."""
    kw = dict(
        raw=rng.standard_normal(CLIP).astype(np.float32),
        tags=["kiwi", "bird"], text_tags=["North Island Brown Kiwi"],
        rec_id="r7", track_ids=["1", "22"], sr=8000, lat=-41.25, lng=174.5,
        min_freq=300.0, max_freq=3200.0, length=2.5, raw_length=2.75,
        start_s=1.5, signal_percent=0.25, low_sample=1,
    )
    if full:
        kw.update(
            spectogram=rng.standard_normal((5, 3)).astype(np.float32),
            short_features=rng.standard_normal((68, 60)).astype(np.float32),
            mid_features=rng.standard_normal((136, 3)).astype(np.float32),
            buttered=rng.standard_normal(CLIP).astype(np.float32),
            mixed_label="kiwi", embed_predictions="kiwi 0.9",
            embeddings=rng.standard_normal((2, 4)).astype(np.float32),
            logits=rng.standard_normal(6).astype(np.float32),
        )
    return m.SampleRecord(**kw)


def _decoded(s) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(s).items()}


@pytest.mark.parametrize("full", [True, False])
def test_schema_bytes_match_jax_both_ways(full):
    a = schema.encode_sample(_record(schema, np.random.default_rng(1), full))
    b = jschema.encode_sample(_record(jschema, np.random.default_rng(1), full))
    assert a == b
    want = dict(want_spectogram=True, want_embeddings=True,
                want_features=True, want_buttered=True)
    assert (_decoded(schema.decode_sample(b, **want))
            == _decoded(jschema.decode_sample(a, **want)))


def test_tfrecord_bytes_match_jax_both_ways(tmp_path, crc):
    rng = np.random.default_rng(2)
    records = [schema.encode_sample(_record(schema, rng, full=False))
               for _ in range(3)] + [b"", b"tiny"]
    assert _native.masked_crc(records[0]) == j_native.masked_crc(records[0])
    assert _native.crc32c(b"123456789") == 0xE3069283  # CRC-32C check value
    assert j_native.crc32c(b"123456789") == 0xE3069283
    ours, theirs = tmp_path / "port.tfrecord", tmp_path / "jax.tfrecord"
    for comp in (None, "GZIP"):
        assert tf.write_tfrecords(ours, records, compression=comp) == 5
        assert jtf.write_tfrecords(theirs, records, compression=comp) == 5
        raw_a, raw_b = ours.read_bytes(), theirs.read_bytes()
        if comp == "GZIP":  # the gzip header carries a write time
            raw_a, raw_b = gzip.decompress(raw_a), gzip.decompress(raw_b)
        assert raw_a == raw_b
        for read, path in ((tf.read_tfrecords, theirs),
                           (jtf.read_tfrecords, ours)):
            got = [bytes(r) for r in read(path, verify_crc=True)]
            assert got == records


def test_tfrecord_reader_rejects_and_skips_corruption(tmp_path):
    path = tmp_path / "bad.tfrecord"
    tf.write_tfrecords(path, [b"abcdefgh"] * 2, compression=None)
    data = bytearray(path.read_bytes())
    data[14] ^= 0xFF  # inside the first payload
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        list(tf.read_tfrecords(path, verify_crc=True))
    assert list(tf.read_tfrecords(path, verify_crc=True,
                                  skip_errors=True)) == []
    assert len(list(tf.read_tfrecords(path, verify_crc=False))) == 2


def _write_corpus(root, clean=False, shards=3, per_shard=12, seed=3):
    """Short clips over ``shards`` GZIP shards, written by the port: tags
    cycle through TAGS (bird-only and unlabelled clips among them, unless
    ``clean``), every third clip is a low sample, every second carries a
    band-passed variant, each has its own lat/lng."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    tags = TAGS[:3] + TAGS[4:5] if clean else TAGS
    paths, i = [], 0
    for s in range(shards):
        recs = []
        for _ in range(per_shard):
            raw = rng.standard_normal(CLIP + (i % 3 - 1) * 50)
            recs.append(schema.encode_sample(schema.SampleRecord(
                raw=raw.astype(np.float32), tags=tags[i % len(tags)],
                rec_id=f"r{i}", lat=float(rng.uniform(-47, -34)),
                lng=float(rng.uniform(166, 179)),
                low_sample=int(i % 3 == 0 and not clean),
                buttered=(rng.standard_normal(CLIP).astype(np.float32)
                          if i % 2 and not clean else None),
            )))
            i += 1
        paths.append(root / f"s{s}.tfrecord")
        tf.write_tfrecords(paths[-1], recs)
    return paths


def _spaces():
    return (build_label_space(load_ontology(), SOURCE_LABELS),
            jbuild(jload(), SOURCE_LABELS))


def _host(item) -> list[np.ndarray]:
    return [np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
            for a in item]


def _assert_items_equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for a, b in zip(got, want):
        a, b = _host(a), _host(b)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


STREAM_CASES = {
    "plain": {},
    "filters": dict(exclude_low_samples=True, drop_bird_only=True),
    "butter_always": dict(filter_freq=True),
    "butter_coin": dict(filter_freq=True, random_butter=0.5),
    "latlng": dict(with_latlng=True),
    "cache": dict(cache=True),
    "deterministic": dict(deterministic=True),
    "unlabelled": dict(keep_unlabeled=True, shuffle=False),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_record_stream_matches_jax(tmp_path, case):
    shards = _write_corpus(tmp_path)
    space, jspace = _spaces()
    kw = STREAM_CASES[case]
    ours = pipe.RecordStream(shards, space, CLIP, seed=11, **kw)
    theirs = jpipe.RecordStream(shards, jspace, CLIP, seed=11, **kw)
    n = 80  # more than two passes over the usable clips
    _assert_items_equal(list(itertools.islice(iter(ours), n)),
                        list(itertools.islice(iter(theirs), n)))
    assert ours.count() == theirs.count()


LOADER_CASES = {
    "plain": {},
    "filters": dict(exclude_low_samples=True, drop_bird_only=True),
    "butter_coin": dict(filter_freq=True, random_butter=0.5),
    "latlng": dict(with_latlng=True),
    "cache": dict(cache=True),
}


def _take(loader, n):
    it = iter(loader)
    try:
        return list(itertools.islice(it, n))
    finally:
        it.close()


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_build_training_stream_augment_matches_jax(tmp_path, case):
    """Train batches (raw, y, mixup partner raw2, y2[, latlng]) bitwise."""
    shards = _write_corpus(tmp_path / "train")
    space, jspace = _spaces()
    kw = dict(augment=True, shard_groups=[shards], seed=5, workers=0,
              **LOADER_CASES[case])
    ours = pipe.build_training_stream([], "train", space, CLIP, 4,
                                      device="cpu", **kw)
    theirs = jpipe.build_training_stream([], "train", jspace, CLIP, 4, **kw)
    got, want = _take(ours, 12), _take(theirs, 12)
    _assert_items_equal(got, want)
    assert len(got[0]) == (5 if case == "latlng" else 4)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in got[0])


@pytest.mark.parametrize("two_dirs", [False, True])
def test_eval_batch_loader_matches_jax(tmp_path, two_dirs):
    """One eval pass (cached, its trimmed tail batch included), over one
    directory or two interleaved ones."""
    dirs = [tmp_path / "a", tmp_path / "b"][: 1 + two_dirs]
    for i, d in enumerate(dirs):
        _write_corpus(d / "validation", shards=2, per_shard=7, seed=i)
    space, jspace = _spaces()
    ours = pipe.build_training_stream(dirs, "validation", space, CLIP, 5,
                                      seed=2, device="cpu")
    theirs = jpipe.build_training_stream(dirs, "validation", jspace, CLIP, 5,
                                         seed=2)
    got, want = list(ours), list(theirs)
    _assert_items_equal(got, want)
    assert got[-1][0].shape[0] < 5  # the partial tail batch


def _rows(pairs) -> list[tuple[bytes, bytes]]:
    return sorted((np.asarray(r).tobytes(), np.asarray(y).tobytes())
                  for r, y in pairs)


def test_parallel_loader_yields_the_single_process_multiset(tmp_path):
    shards = _write_corpus(tmp_path, clean=True, shards=4, per_shard=6)
    space, _ = _spaces()
    loader = ParallelLoader(shards, space, CLIP, batch_size=4, num_workers=2,
                            seed=1, loop=False, device="cpu")
    try:
        got = list(loader)
    finally:
        loader.close()
    assert all(not p.is_alive() for p in loader.procs)
    assert len(got) == 6  # 2 workers x 12 clips / 4
    single = pipe.RecordStream(shards, space, CLIP, loop=False)
    assert _rows(zip(torch.cat([b[0] for b in got]).numpy(),
                     torch.cat([b[1] for b in got]).numpy())) == _rows(single)


def test_gzip_shard_is_one_deflate_stream(tmp_path):
    """The writer's shards inflate with the reader's multi-member loop."""
    path = tmp_path / "s.tfrecord"
    tf.write_tfrecords(path, [b"a" * 100, b"b"])
    assert path.read_bytes()[:2] == b"\x1f\x8b"
    d = zlib.decompressobj(47)
    body = d.decompress(path.read_bytes()) + d.flush()
    assert not d.unused_data
    assert [bytes(r) for r in _native.split_records(body)] == [b"a" * 100,
                                                               b"b"]
