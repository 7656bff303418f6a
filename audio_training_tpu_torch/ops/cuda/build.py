"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
repository root: a shared library with a plain C interface, compiled for
Hopper (``sm_90a``) at first use.  The file name carries a hash of the
source, of every header in ``csrc/`` (``*.cuh``, which the sources include)
and of the flags, so an edited source or header rebuilds; ``.gitignore``
lists ``build/``.  ``nvcc -Xptxas -v`` output (registers, shared memory, spills)
is kept beside each library as ``<name>-<hash>.log``.

The model paths' libraries (:data:`PATH_LIBRARIES`) are built together:
the first :func:`load_library` of any of them builds every one not yet
built in one batch of nvcc processes, so a cold set-up waits for the
slowest build once, and a warm one builds nothing.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from audio_training_tpu_torch.utils.profiling import setup_span

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The libraries the training and inference paths load
PATH_LIBRARIES = ("batch_norm", "fused_featurizer", "melspec")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    text = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_libraries(names: list[str]) -> dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc
    processes at once; returns name -> library path."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        # build into a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


@setup_span("setup.load_library")
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; a library of
    :data:`PATH_LIBRARIES` is built in one batch with the others."""
    names = sorted({name, *PATH_LIBRARIES}) if name in PATH_LIBRARIES else [name]
    return ctypes.CDLL(str(build_libraries(names)[name]))


def build_log(name: str) -> str:
    """The nvcc/ptxas output of the library's build."""
    return library_path(name).with_suffix(".log").read_text()
