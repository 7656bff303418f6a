"""Where K1's mel kernels, its PCEN epilogue and the probe's K4 spend their
time, on a CUDA card.

    python3 -m audio_training_tpu_torch.ops.cuda.ablate [--tier TIER ...]
    python3 -m audio_training_tpu_torch.ops.cuda.ablate --probe
    python3 -m audio_training_tpu_torch.ops.cuda.ablate --pcen

Builds variants of ``csrc/fused_featurizer.cu`` in which one part of a mel
kernel is cut out or changed (the source text replaced), and times each
with CUDA events, twice in turns, for each tier asked for (all three by
default):

- ``highest`` (``mel_power_kernel``): 256 clips x 144,000 samples, bf16 out;
- ``default`` (``mel_bf16_kernel``): 128 clips (a train step's batch), f32
  out;
- ``bf16_3x`` (``mel_bf16x3_kernel``): 512 clips (the MobileNetV2 chain's
  batch), f32 out.

The variants compute wrong mels: only ``base`` is checked against the built
library, bitwise.  The differences between the times bound each part's cost.
The exact kernel's variants:

- ``no_mel``: no band walk (step 5);
- ``no_untangle_mel``: no untangle either (steps 4-5);
- ``no_tw_loads``: the inter-pass twiddles replaced by 1;
- ``carve_max``: the largest shared-memory carveout (28 KB of L1);
- ``win_l1``: the window read from L1 per frame, not held in registers;
- ``no_stage``: no staging of the clip span (step 0);
- ``stage_only``: no frames at all (steps 0 and 6).

The tensor-core kernels' variants (each cuts the part in both kernels; a
tier times its own kernel):

- ``no_op2``: no stage-2 operator traffic: the ring's producer copies
  nothing and its consumers neither wait nor release, so the B fragments
  come from whatever the ring's slots hold;
- ``no_samples``: the stage-1 fragments built from the window alone (no
  reads of the staged span);
- ``no_span``: no staging of the clip span;
- ``no_scatter``: no power scatter into shared memory;
- ``no_mel``: no balanced walk;
- ``no_stage1``: no stage 1 (the span, stage 2, power and the walk);
- ``stage1_only``: the span and stage 1 alone (no operator traffic, stage 2,
  power or walk);
- ``cluster4``: clusters of 4 blocks, not 2 (the operator read from L2
  an eighth as often as by blocks alone, not a quarter);
- ``cluster_scope``: the ring's mbarrier waits and arrives with
  ``.acquire`` / ``.release`` at ``.cluster`` scope, not their default
  ``.cta`` semantics.

``--probe`` builds ``csrc/probe_megakernel.cu`` twice instead and times the
megakernel probe's K4 (``shift_probe_kernel``) in shift1 and roll at the
probe's shape (64 x 640, 2048 ops, grid 8): ``base`` takes the fourth
operand of each quad from the next lane by ``__shfl_down_sync``,
``shift_scalar`` all four operands by scalar loads.  Both compute the
probe's function, and both are checked bitwise against its plain version.

``--pcen`` times K1's PCEN epilogue (``pcen_kernel``, bf16 out) at B=256 and
B=512 on the "default" tier's mel, twice in turns: ``base`` built from this
checkout (checked bitwise against the built library) and three variants
of it.  Each prints its largest error against the built library after
PCEN's global min-max.  The variants:

- ``fast_math``: the pointwise part with ``__expf`` / ``__logf`` /
  ``__fdividef`` instead of the precise functions and the IEEE division;
- ``ema_only``: no pointwise part (each frame stores its EMA);
- ``copy_only``: no scan of the frames either (each chunk staged and
  stored back).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import build
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import (
    build_mel_weights,
    normalize_rows,
)

_STEP5 = ("for (int j0 = 0; j0 < n_slots; j0 += 4) {\n        float w[4];",
          "for (int j0 = 0; j0 < 0; j0 += 4) {\n        float w[4];")
_EXACT = {
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
# the tensor-core kernels (the operator ring)
_NO_RING = [
    ("for (int c = 0; c < n_chunks * passes; ++c) {",
     "for (int c = 0; c < 0; ++c) {"),
    ("    mbar_wait(full + c % RING_SLOTS, (c / RING_SLOTS) & 1);\n", ""),
    ("    if (lane < TC_CLUSTER) mbar_arrive_at(empty + c % RING_SLOTS, lane);\n",
     ""),
]
_NO_WALK = [("for (int j0 = 0; j0 < n_slots; j0 += 4) {  // n_slots: a multiple of 4",
             "for (int j0 = 0; j0 < 0; j0 += 4) {  // n_slots: a multiple of 4")]
_TC = {
    "base": [],
    "no_op2": _NO_RING,
    "no_samples": [("v[ks][h] = make_float2(__fmul_rn(p0[m], w[ks][h].x),\n"
                    "                             __fmul_rn(p1[m], w[ks][h].y));",
                    "v[ks][h] = w[ks][h];")],
    "no_span": [("for (int j0 = tid; j0 < len; j0 += 8 * TC_COMPUTE) {",
                 "for (int j0 = tid; j0 < 0; j0 += 8 * TC_COMPUTE) {")],
    "no_scatter": [  # each store made conditional on a value never met
        ("power[f * P_ROW + tc_power_pos(k1 + 32 * k2)] = ",
         "if (re == 12345.f) power[0] = "),
        ("hpow[f * X3_HP_ROW + x3_power_pos(k2, e)] =",
         "if (re == 12345.f) hpow[0] =")],
    "no_mel": _NO_WALK,
    "no_stage1": [("for (int f = 0; f < n_valid; ++f) {  // the block's frames",
                   "for (int f = 0; f < 0; ++f) {  // the block's frames")],
    "stage1_only": _NO_RING + _NO_WALK + [
        ("for (int r = 0; r < 4; ++r) {", "for (int r = 0; r < 0; ++r) {"),
        ("for (int rr = 0; rr < 2; ++rr) {",
         "for (int rr = 0; rr < 0; ++rr) {")],
    "cluster4": [("constexpr int TC_CLUSTER = 2;", "constexpr int TC_CLUSTER = 4;")],
    "cluster_scope": [  # the ring's waits and arrives at .cluster scope
        ("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;",
         "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"),
        ("mbarrier.arrive.shared::cluster.b64 _, [ra];",
         "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];")],
}
_SHIFT = {
    "base": [],
    "shift_scalar": [(
        "      if (live) w = lds4(xa + 16 * q);\n"
        "      float nb = __shfl_down_sync(0xffffffffu, w.x, 1);\n"
        "      if (live && alone) nb = lds1(xa + 4 * next);\n",
        "      float nb = 0.f;\n"
        "      if (live) {\n"
        "        w.y = lds1(xa + 16 * q + 4);\n"
        "        w.z = lds1(xa + 16 * q + 8);\n"
        "        w.w = lds1(xa + 16 * q + 12);\n"
        "        nb = lds1(xa + 4 * next);\n"
        "      }\n")],
}
_PCEN_POINTWISE = (
    "        const float smooth_pow = expf(gn * logf(eps + m));\n"
    "        x[a + k] =\n"
    "            expf(one_over_root * logf(v / smooth_pow + bias)) - bias_root;")
_PCEN = {
    "base": [],
    "fast_math": [(_PCEN_POINTWISE,
                   "        const float smooth_pow = __expf(gn * __logf(eps + m));\n"
                   "        x[a + k] = __expf(one_over_root * __logf(\n"
                   "            __fdividef(v, smooth_pow) + bias)) - bias_root;")],
    "ema_only": [(_PCEN_POINTWISE, "        x[a + k] = m;")],
    "copy_only": [("const int run = max(0, min(PCEN_RUN, len - a));",
                   "const int run = 0;")],
}


class Tier(NamedTuple):
    """A tier, the batch and output type it is timed at."""
    precision: str
    batch: int
    out_dtype: torch.dtype


TIERS = {
    "highest": Tier("highest", 256, torch.bfloat16),
    "default": Tier("default", 128, torch.float32),
    "bf16_3x": Tier("bf16_3x", 512, torch.float32),
}


def build_variants(out_dir: Path, variants: dict, name: str = "fused_featurizer",
                   real=None) -> dict[str, ctypes.CDLL]:
    """Compile every variant of ``csrc/<name>.cu`` (all nvcc processes at
    once) and load it, its entry points typed as ``real``'s (the built
    library's loader; default K1's)."""
    # the shared header inlined, so that a variant may replace its text too
    source = (build.CSRC_DIR / f"{name}.cu").read_text().replace(
        '#include "hopper_ptx.cuh"',
        (build.CSRC_DIR / "hopper_ptx.cuh").read_text().replace(
            "#pragma once\n", ""))
    procs = {}
    for variant, subs in variants.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {variant}: {old!r} not in source")
            text = text.replace(old, new)
        (out_dir / f"{variant}.cu").write_text(text)
        procs[variant] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{variant}.so"), str(out_dir / f"{variant}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    real = (real or ffz._library)()
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {variant}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{variant}.so"))
        for entry in ("ff_mel_power", "ff_mel_bf16", "ff_mel_bf16x3",
                      "ff_pcen", "probe_shift"):
            if hasattr(real, entry):
                fn, want = getattr(lib, entry), getattr(real, entry)
                fn.argtypes, fn.restype = want.argtypes, want.restype
        libs[variant] = lib
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


def ablate(tier: Tier, libs: dict[str, ctypes.CDLL], dev) -> None:
    cfg = FeaturizerConfig()
    fz = ffz.FusedFeaturizer(build_mel_weights(cfg), precision=tier.precision,
                             device=dev)
    raw = normalize_rows(torch.randn(
        tier.batch, cfg.samples_per_clip, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))
    want = fz(raw, pcen=False)
    real = ffz._library
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                ffz._library = lambda lib=lib: lib
                fz.tc_config = None  # the variant's own launch shape
                ms = time_ms(lambda: fz(raw, pcen=False,
                                        out_dtype=tier.out_dtype))
                note = ""
                if name == "base":
                    note = (" bitwise the built kernel: "
                            f"{torch.equal(fz(raw, pcen=False), want)}")
                print(f"{tier.precision} B={tier.batch} round {rnd} "
                      f"{name:16s} {ms:.4f} ms{note}", flush=True)
    finally:
        ffz._library = real


def ablate_shift(libs: dict[str, ctypes.CDLL], dev) -> None:
    """K4's shift1 and roll with each variant, twice in turns."""
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    x = pm.shift_input(64, 640, dev)
    real = pm._library
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                pm._library = lambda lib=lib: lib
                for mode in ("shift1", "roll"):
                    same = torch.equal(pm.shift_probe(0.25, x, 7, 8, mode),
                                       pm.shift_probe_plain(0.25, x, 7, 8,
                                                            mode))
                    ms = time_ms(lambda: pm.shift_probe(0.0, x, 2048, 8,
                                                        mode))
                    print(f"probe {mode} (64x640, 2048 ops, grid 8) round "
                          f"{rnd} {name:13s} {ms:.4f} ms; bitwise the plain "
                          f"version: {same}", flush=True)
    finally:
        pm._library = real


def ablate_pcen(libs: dict[str, ctypes.CDLL], dev) -> None:
    """K1's PCEN epilogue with each library, at B=256 and 512, twice in
    turns."""
    from audio_training_tpu_torch.ops.pcen import normalize_minmax_global

    cfg = FeaturizerConfig()
    fz = ffz.FusedFeaturizer(build_mel_weights(cfg), precision="default",
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    real = ffz._library
    for batch in (256, 512):
        mel = fz(normalize_rows(torch.randn(
            batch, cfg.samples_per_clip, device=dev, generator=gen)),
            pcen=False)
        want = ffz.pcen_rows(mel, fz.pcen_params)
        try:
            for rnd in range(2):
                for name, lib in libs.items():
                    ffz._library = lambda lib=lib: lib
                    got = ffz.pcen_rows(mel, fz.pcen_params)
                    err = (normalize_minmax_global(got)
                           - normalize_minmax_global(want)).abs().max()
                    ms = time_ms(lambda: ffz.pcen_rows(
                        mel, fz.pcen_params, torch.bfloat16))
                    print(f"pcen B={batch} round {rnd} {name:9s} {ms:.4f} ms; "
                          f"bitwise the built kernel: {torch.equal(got, want)}"
                          f", max abs err after the min-max {err.item():.3e}",
                          flush=True)
        finally:
            ffz._library = real
        del mel, want
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tier", action="append", choices=list(TIERS),
                        help="a tier to ablate (repeatable; default: all "
                        "unless --probe or --pcen)")
    parser.add_argument("--probe", action="store_true",
                        help="time K4's shift1 / roll operand variants")
    parser.add_argument("--pcen", action="store_true",
                        help="time K1's PCEN epilogue at B=256 and 512")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    alone = args.probe or args.pcen
    tiers = [TIERS[t] for t in (args.tier or ([] if alone else TIERS))]
    ffz._library()  # the built library, which also makes the build dir
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        if args.probe:
            from audio_training_tpu_torch.probes import probe_megakernel as pm

            out = Path(tmp) / "probe"
            out.mkdir()
            ablate_shift(build_variants(out, _SHIFT, "probe_megakernel",
                                        pm._library), dev)
        if args.pcen:
            out = Path(tmp) / "pcen"
            out.mkdir()
            ablate_pcen(build_variants(out, _PCEN), dev)
        built = {}  # the tensor-core tiers share their variants
        for tier in tiers:
            variants = _EXACT if tier.precision == "highest" else _TC
            if id(variants) not in built:
                out = Path(tmp) / tier.precision
                out.mkdir()
                built[id(variants)] = build_variants(out, variants)
            ablate(tier, built[id(variants)], dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
