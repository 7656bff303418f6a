"""The megakernel probe (port of ``docs/probes/probe_megakernel.py``).

Measures, on the card, (a) the bf16 dot rate of the conv2 formulations that
the TPU probe compared (``bench_dot``: kernel K3, ``dot_probe``) and (b) the
cost of lane shifts, rolls, a stride-3 max-pool compaction and block copies
(``bench_shift``: kernel K4, ``shift_probe``).  Both kernels live in
``csrc/probe_megakernel.cu``, whose header states what they compute, what
bounds them and what the measured rate means on this card.

``dot_probe`` and ``shift_probe`` launch the kernels on CUDA tensors and
compute their plain versions (``dot_probe_plain``, ``shift_probe_plain``)
on CPU tensors; each launch is counted per mode.  ``bench_dot`` and
``bench_shift`` time ``ITERS`` launches between CUDA events, with the salt
changed from launch to launch as the TPU probe does, and keep the minimum
of ``REPEATS`` such runs; they need a card.

    python -m audio_training_tpu_torch.probes.probe_megakernel

runs ``main``, the TPU probe's list of measurements (``pool3`` left out as
there: Mosaic could not lower it; ``bench_shift("pool3")`` runs here).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from audio_training_tpu_torch.ops.cuda.build import load_library
from audio_training_tpu_torch.utils import profiling

ITERS = 16
REPEATS = 3
SLOTS = 8
OUT_ROWS, OUT_COLS = 8, 128
DOT_MODES = ("store", "accum", "brot")
SHIFT_MODES = ("shift1", "roll", "pool3", "copyblk")
DOT_TILE = 64  # the dot kernel's output tile (64 x 64) and operand tiles

# the lanes each shift mode reads (x[:, 1:513], x[:, 2:509:3] up to lane
# 506, the 128 output lanes)
_SHIFT_MIN_LANES = {"shift1": 513, "roll": OUT_COLS, "pool3": 507,
                    "copyblk": OUT_COLS}

profiling.register_counters(
    "probe_megakernel", [*(f"probe_dot_{m}" for m in DOT_MODES),
                         *(f"probe_shift_{m}" for m in SHIFT_MODES)])


def launch_counts() -> dict[str, int]:
    return profiling.counts("probe_megakernel")


def reset_launch_counts() -> None:
    profiling.reset_counts("probe_megakernel")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("probe_megakernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_dot.argtypes = [f32, ptr, ptr, i32, i32, i32, i32, i32, ptr,
                              i32, ptr, ptr, ptr]
    lib.probe_dot.restype = i32
    lib.probe_shift.argtypes = [f32, ptr, *[i32] * 11, ptr, ptr]
    lib.probe_shift.restype = i32
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# K3: the dot-rate probe
# ---------------------------------------------------------------------------


def _dot_shapes(a: torch.Tensor, b: torch.Tensor, ndots: int, grid: int,
                mode: str) -> tuple[int, int, int]:
    if mode not in DOT_MODES:
        raise ValueError(f"unknown dot mode {mode!r}; the modes are {DOT_MODES}")
    want_b = 3 if mode == "brot" else 2
    if (a.ndim != 3 or a.shape[0] != 4 or b.ndim != want_b
            or (want_b == 3 and b.shape[0] != 4) or b.shape[-2] != a.shape[2]
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16):
        raise ValueError(
            f"mode {mode!r} takes a (4, m, k) and b "
            f"{'(4, k, n)' if want_b == 3 else '(k, n)'} bf16, got "
            f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    m, k, n = a.shape[1], a.shape[2], b.shape[-1]
    if m < OUT_ROWS or n < OUT_COLS:
        raise ValueError(f"the (8, 128) output block needs m >= 8 and n >= "
                         f"128, got m={m}, n={n}")
    if ndots < 1 or grid < 1:
        raise ValueError(f"ndots {ndots} and grid {grid} must be >= 1")
    return m, k, n


def dot_probe_plain(salt: float, a: torch.Tensor, b: torch.Tensor,
                    ndots: int, grid: int, mode: str) -> torch.Tensor:
    """The plain version of K3: the (8 grid, 128) f32 output.  One grid
    step's ndots products, each bf16 x bf16 in f32 (exact products, f32
    sums; TF32 must be off on a card), "accum" summed in the TPU kernel's
    order; the steps are identical, so the block is repeated."""
    _dot_shapes(a, b, ndots, grid, mode)
    af, bf = a.float(), b.float()
    idx = torch.arange(ndots, device=a.device) % 4
    prods = (torch.matmul(af[0], bf[idx]) if mode == "brot"
             else torch.matmul(af[idx], bf))  # (ndots, m, n)
    if mode == "accum":
        acc = torch.full(prods.shape[1:],
                         float(np.float32(salt) * np.float32(1e-30)),
                         device=a.device)
        for d in prods:
            acc = acc + d
    else:
        acc = prods[((ndots - 1) // SLOTS) * SLOTS]
    return acc[:OUT_ROWS, :OUT_COLS].repeat(grid, 1)


def pack_dot_a(a: torch.Tensor) -> torch.Tensor:
    """a (4, m, k) in the kernel's tile order: (4, m / 64) tiles of 64 rows
    x k, each the (k / 8, 8) grid of its 8 x 8 core matrices, k-outer, as
    the no-swizzle k-major wgmma descriptor of csrc/probe_megakernel.cu
    reads them.  Any dtype: the tests pack indices."""
    four, m, k = a.shape
    return a.reshape(four, m // DOT_TILE, 8, 8, k // 8, 8).permute(
        0, 1, 4, 2, 3, 5).contiguous()


def pack_dot_b(b: torch.Tensor) -> torch.Tensor:
    """b (k, n) or (4, k, n) transposed into the same order: ((4,) n / 64)
    tiles of 64 columns of b as rows x k."""
    x = b if b.ndim == 3 else b[None]
    q, k, n = x.shape
    return x.reshape(q, k // 8, 8, n // DOT_TILE, 8, 8).permute(
        0, 3, 1, 4, 5, 2).contiguous()


def dot_plan(m: int, n: int, ndots: int, grid: int,
             blocks: int) -> tuple[list[int], list[tuple[int, ...]]]:
    """The kernel's walk: the grid x tiles x ndots dot-tiles, in the order
    (j = i % 4, output tile, step g, i), cut into one run per block (at
    most ``blocks``), the runs equal to within one dot; a run is cut into
    units (g, j, tile, first dot i, dots) where (j, tile, g) changes.
    Returns (offsets, units): block b takes units offsets[b] ..
    offsets[b + 1]."""
    tiles = (m // DOT_TILE) * (n // DOT_TILE)
    total = grid * tiles * ndots
    blocks = min(blocks, total)
    ends = [(b + 1) * total // blocks for b in range(blocks)]
    offsets, units = [0], []
    pos = b = 0
    for j in range(min(4, ndots)):
        dots = (ndots - j + 3) // 4  # i = j, j + 4, ... < ndots
        for t in range(tiles):
            for g in range(grid):
                s = 0
                while s < dots:
                    take = min(dots - s, ends[b] - pos)
                    units.append((g, j, t, j + 4 * s, take))
                    s += take
                    pos += take
                    if pos == ends[b]:
                        offsets.append(len(units))
                        b += 1
    return offsets, units


@functools.lru_cache(maxsize=64)
def _plan_on(device: torch.device, m: int, n: int, ndots: int,
             grid: int) -> tuple[torch.Tensor, int]:
    """:func:`dot_plan` for one block an SM as the kernel reads it (the
    offsets, then five ints a unit), on the device; and the block count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    offsets, units = dot_plan(m, n, ndots, grid, sms)
    flat = np.array(offsets + [v for u in units for v in u], np.int32)
    return torch.from_numpy(flat).to(device), len(offsets) - 1


def dot_probe(salt: float, a: torch.Tensor, b: torch.Tensor, ndots: int,
              grid: int = 8, mode: str = "store") -> torch.Tensor:
    """K3: ``grid`` steps of ``ndots`` (m, k) x (k, n) bf16 products, as
    ``docs/probes/probe_megakernel.py::dot_kernel`` computes them; returns
    the (8 grid, 128) f32 output.  On CUDA the kernel (m, k, n multiples of
    64; a and b packed into its tile order on the way, which the launch's
    time includes), on the CPU :func:`dot_probe_plain`."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return dot_probe_plain(salt, a, b, ndots, grid, mode)
    return _dot_launch(salt, a, b, ndots, grid, mode)[0]


def _dot_launch(salt: float, a: torch.Tensor, b: torch.Tensor, ndots: int,
                grid: int, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel: (out, scratch), the scratch (grid, 8, m, n)
    holding each slot's last d_i, or in "accum" (grid, m, n) the sums
    outside the output block."""
    m, k, n = _dot_shapes(a, b, ndots, grid, mode)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"no kernel for a on {a.device}, b on {b.device}")
    if m % DOT_TILE or n % DOT_TILE or k % DOT_TILE:
        raise ValueError(f"the kernel takes m, k, n multiples of {DOT_TILE}, "
                         f"got {m}, {k}, {n}")
    dev = a.device
    plan, blocks = _plan_on(dev, m, n, ndots, grid)
    ap, bp = pack_dot_a(a), pack_dot_b(b)
    if mode == "accum":
        scratch = torch.zeros((grid, m, n), dtype=torch.float32, device=dev)
        out = torch.zeros((OUT_ROWS * grid, OUT_COLS), dtype=torch.float32,
                          device=dev)
    else:
        scratch = torch.empty((grid, SLOTS, m, n), dtype=torch.float32,
                              device=dev)
        out = torch.empty((OUT_ROWS * grid, OUT_COLS), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        _check(_library().probe_dot(
            float(np.float32(salt)), ap.data_ptr(), bp.data_ptr(), m, k, n,
            ndots, blocks, plan.data_ptr(), DOT_MODES.index(mode),
            scratch.data_ptr(), out.data_ptr(), _stream()),
            f"dot probe ({mode})")
    profiling.count("probe_megakernel", f"probe_dot_{mode}")
    return out, scratch


def wgmma_count(m: int, k: int, n: int, ndots: int, grid: int) -> int:
    """wgmma m64n64k16 instructions a launch issues: one per 64 x 64 output
    tile, 16-deep k step, dot and step."""
    return ndots * grid * (m // DOT_TILE) * (n // DOT_TILE) * (k // 16)


# ---------------------------------------------------------------------------
# K4: the lane-shift / pool / copy probe
# ---------------------------------------------------------------------------


def _shift_shapes(x: torch.Tensor, nops: int, grid: int,
                  mode: str) -> tuple[int, int]:
    if mode not in SHIFT_MODES:
        raise ValueError(
            f"unknown shift mode {mode!r}; the modes are {SHIFT_MODES}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (m, lanes) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, lanes = x.shape
    if m < OUT_ROWS or lanes < _SHIFT_MIN_LANES[mode]:
        raise ValueError(
            f"mode {mode!r} needs m >= {OUT_ROWS} and lanes >= "
            f"{_SHIFT_MIN_LANES[mode]}, got {tuple(x.shape)}")
    if nops < 1 or grid < 1:
        raise ValueError(f"nops {nops} and grid {grid} must be >= 1")
    return m, lanes


class ShiftPlan(NamedTuple):
    """K4's partition of one step's region: ``rows`` x ``quads`` items,
    each 4 adjacent output lanes of one row (``width`` lanes a row, the
    last quad partial where width % 4), item b x threads + t to thread t
    of block b; a block stages ``x_lanes`` lanes of each row its items
    touch (at most ``smem_rows``) and keeps 4 quads scratch lanes a row."""
    rows: int
    quads: int
    width: int
    x_lanes: int
    threads: int
    blocks: int
    smem_rows: int


# block sizes shift_plan tries, largest first
SHIFT_THREADS = (128, 64, 32)


@functools.lru_cache(maxsize=64)
def shift_plan(mode: str, m: int, lanes: int, grid: int,
               sms: int) -> ShiftPlan:
    """The kernel's partition: the largest block of SHIFT_THREADS that
    still gives the launch at least two blocks an SM (else 32 threads).
    shift1 reads x[:, :513] (staged 516), roll all lanes, pool3 the 3
    quads of each output quad (12 lanes an item), copyblk x[:192, :128]."""
    rows = min(m, 192) if mode == "copyblk" else m
    width = {"shift1": 512, "roll": lanes, "pool3": 169,
             "copyblk": OUT_COLS}[mode]
    quads = -(-width // 4)
    x_lanes = {"shift1": 4 * quads + 4, "roll": 4 * quads,
               "pool3": 12 * quads, "copyblk": OUT_COLS}[mode]
    items = rows * quads
    for threads in SHIFT_THREADS:
        if -(-items // threads) * grid >= 2 * sms:
            break
    blocks = -(-items // threads)
    smem_rows = max(min(rows - 1, ((b + 1) * threads - 1) // quads)
                    - b * threads // quads + 1 for b in range(blocks))
    return ShiftPlan(rows, quads, width, x_lanes, threads, blocks, smem_rows)


def shift_probe_plain(salt: float, x: torch.Tensor, nops: int, grid: int,
                      mode: str) -> torch.Tensor:
    """The plain version of K4: each of the ``nops`` iterations in f32 (the
    scratch of the last one read out); the steps are identical, so the
    (8, 128) block is repeated."""
    _shift_shapes(x, nops, grid, mode)
    scr = None
    for i in range(nops):
        y = x + torch.tensor(np.float32(i % 4) + np.float32(salt),
                             device=x.device)
        if mode == "shift1":
            scr = y[:, 1:513]
        elif mode == "roll":
            scr = torch.roll(y, -1, dims=1)
        elif mode == "pool3":
            scr = torch.maximum(torch.maximum(y[:, 0:507:3], y[:, 1:508:3]),
                                y[:, 2:509:3])
        else:
            scr = y[:192, :128] + 1.0
    return scr[:OUT_ROWS, :OUT_COLS].repeat(grid, 1)


def shift_probe(salt: float, x: torch.Tensor, nops: int, grid: int = 8,
                mode: str = "shift1") -> torch.Tensor:
    """K4: ``grid`` steps of ``nops`` iterations of ``mode`` on x, as
    ``docs/probes/probe_megakernel.py::shift_kernel`` computes them; returns
    the (8 grid, 128) f32 output.  On CUDA the kernel, on the CPU
    :func:`shift_probe_plain`."""
    m, lanes = _shift_shapes(x, nops, grid, mode)
    if x.device.type == "cpu":
        return shift_probe_plain(salt, x, nops, grid, mode)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"no kernel for a {x.device} / non-contiguous x")
    plan = shift_plan(mode, m, lanes, grid, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    out = torch.empty((OUT_ROWS * grid, OUT_COLS), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _check(_library().probe_shift(
            float(np.float32(salt)), x.data_ptr(), lanes, nops, grid,
            SHIFT_MODES.index(mode), plan.rows, plan.quads, plan.width,
            plan.x_lanes, plan.threads, plan.blocks, plan.smem_rows,
            out.data_ptr(), _stream()),
            f"shift probe ({mode})")
    profiling.count("probe_megakernel", f"probe_shift_{mode}")
    return out


# ---------------------------------------------------------------------------
# Timing (the card only)
# ---------------------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    return torch.device("cuda")


def timed(run) -> float:
    """Seconds of one call of ``run`` (ITERS launches), the minimum of
    REPEATS runs between CUDA events, after one warm-up run."""
    run()
    best = float("inf")
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def dot_inputs(m: int, k: int, n: int, mode: str, device) -> tuple:
    """``bench_dot``'s operands from numpy seed 0, bf16 on ``device``."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((4, m, k))).to(device,
                                                            torch.bfloat16)
    bshape = (4, k, n) if mode == "brot" else (k, n)
    b = torch.from_numpy(rng.standard_normal(bshape)).to(device,
                                                         torch.bfloat16)
    return a, b


def bench_dot(m: int, k: int, n: int, ndots: int, grid: int = 8,
              mode: str = "store") -> dict:
    """K3's bf16 dot rate at one shape: prints the TPU probe's line and
    returns ms per launch, TFLOP/s and ns per dot."""
    dev = _card()
    a, b = dot_inputs(m, k, n, mode, dev)

    def run():
        for i in range(ITERS):
            dot_probe(i * 1e-30, a, b, ndots, grid, mode)

    dt = timed(run)
    fl = 2.0 * m * k * n * ndots * grid * ITERS
    tf = fl / dt / 1e12
    per_dot_ns = dt / (ndots * grid * ITERS) * 1e9
    print(f"dot[{mode:5s}] M={m:4d} K={k:4d} N={n:4d}: {dt*1e3:8.2f} ms "
          f"total -> {tf:7.1f} TFLOP/s  ({per_dot_ns:7.1f} ns/dot)",
          flush=True)
    return {"mode": mode, "m": m, "k": k, "n": n, "ndots": ndots,
            "grid": grid, "ms": dt / ITERS * 1e3, "tflops": tf,
            "ns_per_dot": per_dot_ns}


def shift_input(m: int, lanes: int, device) -> torch.Tensor:
    """``bench_shift``'s x from numpy seed 1, f32 on ``device``."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.standard_normal((m, lanes))).to(
        device, torch.float32)


def bench_shift(mode: str, m: int = 64, lanes: int = 640, grid: int = 8,
                nops: int = 2048) -> dict:
    """K4's cost of one ``mode`` op: prints the TPU probe's line and returns
    ms per launch and ns per op (time / (grid nops): the steps run in
    parallel on the card)."""
    dev = _card()
    x = shift_input(m, lanes, dev)

    def run():
        for i in range(ITERS):
            shift_probe(i * 1e-30, x, nops, grid, mode)

    dt = timed(run)
    per = dt / (grid * nops * ITERS) * 1e9
    print(f"{mode:7s} ({m}x{lanes}): {dt*1e3:8.2f} ms total -> "
          f"{per:8.1f} ns/op", flush=True)
    return {"mode": mode, "m": m, "lanes": lanes, "nops": nops, "grid": grid,
            "ms": dt / ITERS * 1e3, "ns_per_op": per}


# the TPU probe's list (docs/probes/probe_megakernel.py:218-240)
MAIN_DOTS = [
    dict(m=64, k=640, n=512, ndots=512),    # W-in-lanes, pre-assembled K=640
    dict(m=128, k=640, n=512, ndots=256),   # M sensitivity
    dict(m=256, k=640, n=512, ndots=128),
    dict(m=512, k=512, n=512, ndots=128),   # square reference
    dict(m=512, k=640, n=128, ndots=256),   # im2col, N padded to 128
    dict(m=64, k=640, n=128, ndots=2048),   # batch-in-lanes, 1 w-position
    dict(m=64, k=640, n=256, ndots=1024),   # batch-in-lanes, 256-clip tile
    dict(m=128, k=768, n=128, ndots=1024),  # 2-position band-stacked, 75%
    dict(m=64, k=640, n=512, ndots=512, mode="accum"),  # RMW comparison
    dict(m=64, k=640, n=512, ndots=512, mode="brot"),
    dict(m=512, k=512, n=512, ndots=128, mode="brot"),
]
MAIN_SHIFTS = [dict(mode="shift1"), dict(mode="roll"),
               dict(mode="copyblk", m=256, lanes=128)]


def main() -> dict[str, list[dict]]:
    dev = _card()
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    print("--- bf16 wgmma dot rates (candidate conv2 formulations) ---")
    dots = [bench_dot(**kw) for kw in MAIN_DOTS[:9]]
    print("--- stationary-A / rotating-B (real conv2 operand pattern) ---")
    dots += [bench_dot(**kw) for kw in MAIN_DOTS[9:]]
    print("--- lane ops (assembly / pool building blocks) ---")
    # bench_shift("pool3") is left out as in the TPU probe, where Mosaic
    # could not lower the stride-3 lane compaction; it runs here
    shifts = [bench_shift(**kw) for kw in MAIN_SHIFTS]
    return {"dots": dots, "shifts": shifts}


if __name__ == "__main__":
    main()
