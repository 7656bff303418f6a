"""Where the exact tier's mel kernel spends its time, on a CUDA card.

    python3 -m audio_training_tpu_torch.ops.cuda.ablate

Builds variants of ``csrc/fused_featurizer.cu`` in which one part of
``mel_power_kernel`` is cut out or changed (the source text replaced), and
times each with CUDA events on the production batch (256 clips x 144,000
samples, 160 mels, bf16 out), twice in turns.  The variants compute wrong
mels: only ``base`` is checked against the built library, bitwise.  The
differences between the times bound each part's cost:

- ``no_mel``: no band walk (step 5);
- ``no_untangle_mel``: no untangle either (steps 4-5);
- ``no_tw_loads``: the inter-pass twiddles replaced by 1;
- ``carve_max``: the largest shared-memory carveout (28 KB of L1);
- ``win_l1``: the window read from L1 per frame, not held in registers;
- ``no_stage``: no staging of the clip span (step 0);
- ``stage_only``: no frames at all (steps 0 and 6).
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import build
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import (
    build_mel_weights,
    normalize_rows,
)

_STEP5 = ("for (int j0 = 0; j0 < n_slots; j0 += 4) {",
          "for (int j0 = 0; j0 < 0; j0 += 4) {")
VARIANTS = {
    "base": [],
    "no_mel": [_STEP5],
    "no_untangle_mel": [_STEP5, ("if (k < n_bins) {", "if (k < 0) {")],
    "no_tw_loads": [("__ldg(fft_tw + k * FFT_THREADS + lt)",
                     "make_float2(1.f, 0.f)"),
                    ("__ldg(fft_tw + HALF + g * 16 + h)",
                     "make_float2(1.f, 0.f)")],
    "carve_max": [("carveout < 100 ? carveout : 100", "100")],
    "win_l1": [("v[a] = make_float2(__fmul_rn(pe[n], win[a].x), "
                "__fmul_rn(po[n], win[a].y));",
                "const float2 wa = __ldg(reinterpret_cast<const float2*>"
                "(window) + n); v[a] = make_float2(__fmul_rn(pe[n], wa.x), "
                "__fmul_rn(po[n], wa.y));")],
    "no_stage": [("for (int j0 = tid; j0 < span; j0 += 4 * EX_THREADS) {",
                  "for (int j0 = tid; j0 < 0; j0 += 4 * EX_THREADS) {")],
    "stage_only": [("for (int tt = fg; tt < n_valid; tt += EX_GROUPS) {",
                    "for (int tt = fg; tt < 0; tt += EX_GROUPS) {")],
}


def build_variants(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every variant (all nvcc processes at once) and load it."""
    source = (build.CSRC_DIR / "fused_featurizer.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    argtypes = ffz._library().ff_mel_power.argtypes
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.ff_mel_power.argtypes = argtypes
        lib.ff_mel_power.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = FeaturizerConfig()
    fz = ffz.FusedFeaturizer(build_mel_weights(cfg), device=dev)
    raw = normalize_rows(torch.randn(
        256, cfg.samples_per_clip, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))
    want = fz(raw, pcen=False)
    real = ffz._library
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        libs = build_variants(Path(tmp))
        try:
            for rnd in range(2):
                for name, lib in libs.items():
                    ffz._library = lambda lib=lib: lib
                    ms = time_ms(lambda: fz(raw, pcen=False,
                                            out_dtype=torch.bfloat16))
                    note = ""
                    if name == "base":
                        note = (" bitwise the built kernel: "
                                f"{torch.equal(fz(raw, pcen=False), want)}")
                    print(f"round {rnd} {name:16s} {ms:.4f} ms{note}",
                          flush=True)
        finally:
            ffz._library = real
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
