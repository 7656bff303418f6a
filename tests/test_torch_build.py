"""The kernel build's cache key: a library's file name hashes its source,
every header of ``csrc/`` and the nvcc flags, so that an edit to a shared
header rebuilds every library that includes it.  (The build itself needs
nvcc and runs only where the card is.)"""

import re

import torch

from audio_training_tpu_torch.ops.cuda import build

torch.set_num_threads(2)


def _csrc(tmp_path, monkeypatch):
    (tmp_path / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
    (tmp_path / "two.cu").write_text('#include "shared.cuh"\nint two;\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\n// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    return tmp_path


def test_library_path_follows_every_shared_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = {n: build.library_path(n) for n in ("one", "two")}
    assert before == {n: build.library_path(n) for n in ("one", "two")}
    assert before["one"].name.startswith("one-")
    assert before["one"].parent == build.BUILD_DIR
    (csrc / "shared.cuh").write_text("#pragma once\n// v2\n")
    after = {n: build.library_path(n) for n in ("one", "two")}
    assert all(after[n] != before[n] for n in after)
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert build.library_path("one") != after["one"]


def test_library_path_follows_its_source_alone(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    one, two = build.library_path("one"), build.library_path("two")
    (csrc / "one.cu").write_text('#include "shared.cuh"\nint one_v2;\n')
    assert build.library_path("one") != one
    assert build.library_path("two") == two


def test_the_repository_sources_share_one_header():
    """fused_featurizer.cu and probe_megakernel.cu take their mbarrier and
    bulk-copy helpers from csrc/hopper_ptx.cuh, which defines them once."""
    header = (build.CSRC_DIR / "hopper_ptx.cuh").read_text()
    for name in ("fused_featurizer", "probe_megakernel"):
        source = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "hopper_ptx.cuh"' in source
        for helper in ("smem_u32", "mbar_init", "mbar_expect_tx", "mbar_try",
                       "global_ns", "mbar_wait", "bulk_copy"):
            definition = re.compile(rf"__forceinline__ \w+ {helper}\(")
            assert definition.search(header), helper
            assert not definition.search(source), (name, helper)
