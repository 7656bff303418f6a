"""The megakernel probe of the port against the JAX probe's own kernels.

``docs/probes/probe_megakernel.py``'s ``dot_kernel`` (K3) and
``shift_kernel`` (K4) run here through ``pl.pallas_call(..., interpret=True)``
with ``bench_dot``'s / ``bench_shift``'s specs at small shapes (n >= 128:
the output block reads 128 lanes; ndots >= 9: the 8 slots wrap).  The port's
``dot_probe`` / ``shift_probe`` on CPU tensors compute their plain versions,
held to them: K3 within 1e-5 of max |out| (bf16 products are exact in f32,
sums are reordered; "accum" sums ndots products, 5e-5), K4 bitwise (it only
copies, takes maxima and adds the same f32 values).  The CUDA kernels run
only on a card (tests/test_torch_gpu.py).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audio_training_tpu_torch.probes import probe_megakernel as pm

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DOT_REL = {"store": 1e-5, "brot": 1e-5, "accum": 5e-5}
SALT = 0.25


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe module.  Importing it sets two compilation-cache
    options; they are restored so that the worker's other test files keep
    tests/conftest.py's settings."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    spec = importlib.util.spec_from_file_location(
        "probe_megakernel_jax", REPO / "docs" / "probes" / "probe_megakernel.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return module


def _jax_dot(probe, salt, a, b, ndots, grid, mode):
    """bench_dot's pallas_call (docs/probes/probe_megakernel.py:114-140) in
    interpret mode."""
    _, m, k = a.shape
    n = b.shape[-1]
    slots = 1 if mode == "accum" else 8
    call = pl.pallas_call(
        functools.partial(probe.dot_kernel, ndots=ndots, mode=mode),
        grid=(grid,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((4, m, k), lambda g: (0, 0, 0),
                         memory_space=pltpu.VMEM),
            (pl.BlockSpec((4, k, n), lambda g: (0, 0, 0),
                          memory_space=pltpu.VMEM)
             if mode == "brot" else
             pl.BlockSpec((k, n), lambda g: (0, 0),
                          memory_space=pltpu.VMEM)),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda g: (g, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((slots, m, n), jnp.float32)],
        out_shape=jax.ShapeDtypeStruct((8 * grid, 128), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray([salt], jnp.float32), a, b))


def _jax_shift(probe, salt, x, nops, grid, mode):
    """bench_shift's pallas_call (:185-201) in interpret mode."""
    m, lanes = x.shape
    call = pl.pallas_call(
        functools.partial(probe.shift_kernel, nops=nops, mode=mode),
        grid=(grid,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((m, lanes), lambda g: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda g: (g, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((m, lanes), jnp.float32)],
        out_shape=jax.ShapeDtypeStruct((8 * grid, 128), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray([salt], jnp.float32), x))


def _dot_inputs(m, k, n, mode, seed=0):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((4, m, k)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((4, k, n) if mode == "brot"
                                        else (k, n)), jnp.bfloat16)
    to_t = lambda v: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16)
    return a, b, to_t(a), to_t(b)


@pytest.mark.parametrize("mode", pm.DOT_MODES)
@pytest.mark.parametrize("ndots", [9, 17])
def test_dot_probe_matches_jax_dot_kernel_interpret(jax_probe, mode, ndots):
    m, k, n, grid = 16, 64, 128, 2
    a, b, a_t, b_t = _dot_inputs(m, k, n, mode)
    want = _jax_dot(jax_probe, SALT, a, b, ndots, grid, mode)
    got = pm.dot_probe(SALT, a_t, b_t, ndots, grid, mode)
    assert got.shape == want.shape == (8 * grid, 128)
    assert got.dtype == torch.float32
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < DOT_REL[mode], rel
    # the steps compute the same block
    np.testing.assert_array_equal(want[:8], want[8:])


def test_dot_probe_modes_differ_where_they_should(jax_probe):
    """"store" keeps the last dot with i % 8 == 0 (i = 16 of 17: a[0] . b),
    "accum" sums all 17."""
    a, b, a_t, b_t = _dot_inputs(16, 64, 128, "store")
    store = pm.dot_probe(SALT, a_t, b_t, 17, 1, "store")
    d0 = (a_t[0].float() @ b_t.float())[:8, :128]
    assert torch.allclose(store, d0, rtol=1e-5, atol=1e-4)
    accum = pm.dot_probe(SALT, a_t, b_t, 17, 1, "accum")
    ds = [(a_t[j].float() @ b_t.float())[:8, :128] for j in range(4)]
    total = 5 * ds[0] + 4 * (ds[1] + ds[2] + ds[3])
    assert torch.allclose(accum, total, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("mode,m,lanes", [
    ("shift1", 16, 640), ("roll", 16, 640), ("pool3", 16, 640),
    ("pool3", 16, 507), ("copyblk", 200, 128)])
def test_shift_probe_matches_jax_shift_kernel_interpret(jax_probe, mode, m,
                                                        lanes):
    x = np.random.default_rng(1).standard_normal((m, lanes)).astype(
        np.float32)
    nops, grid = 6, 2
    want = _jax_shift(jax_probe, SALT, jnp.asarray(x), nops, grid, mode)
    got = pm.shift_probe(SALT, torch.from_numpy(x), nops, grid, mode)
    assert got.shape == want.shape == (8 * grid, 128)
    np.testing.assert_array_equal(got.numpy(), want)


# (mode, m, lanes, grid): the probe's shapes, then rows and lanes that split
# unevenly over warps and blocks (a partial last quad at 130 lanes)
SHIFT_SHAPES = [("shift1", 64, 640, 8), ("roll", 64, 640, 8),
                ("pool3", 64, 640, 8), ("copyblk", 256, 128, 8),
                ("shift1", 8, 513, 1), ("shift1", 72, 513, 3),
                ("roll", 8, 513, 1), ("roll", 16, 130, 3), ("roll", 72, 130, 3),
                ("pool3", 8, 507, 1), ("pool3", 72, 513, 3),
                ("copyblk", 8, 130, 1), ("copyblk", 72, 130, 3)]


def _emulate_shift(x, c, mode, grid, plan):
    """One iteration of shift_probe_kernel (constant c) as its threads
    index it: the region each step stores, every element once, and the
    output block read back.  Asserts that each block stages at most
    smem_rows rows, that every read falls in a staged row and its staged
    lanes, and that a shuffled operand comes from the next lane's item."""
    m, lanes = x.shape
    rows, quads, width, x_lanes, threads = plan[:5]
    scr = np.full((grid, rows, width), np.nan, np.float32)
    out = np.full((8 * grid, 128), np.nan, np.float32)
    t = np.arange(threads)
    for g in range(grid):
        for b in range(plan.blocks):
            first = b * threads
            r0 = first // quads
            nrows = min(rows - 1, (first + threads - 1) // quads) - r0 + 1
            assert 1 <= nrows <= plan.smem_rows
            xs = np.zeros((nrows, x_lanes), np.float32)
            xs[:, :min(lanes, x_lanes)] = x[r0:r0 + nrows, :x_lanes]
            item = first + t
            live = item < rows * quads
            row, q = item // quads, item % quads
            lr = row - r0
            assert ((lr >= 0) & (lr < nrows))[live].all()
            n = np.minimum(4, width - 4 * q)
            lr = np.where(live, lr, 0)
            if mode in ("shift1", "roll"):
                wq = xs[lr[:, None], np.minimum(4 * q[:, None] + np.arange(4),
                                                x_lanes - 1)]
                nxt = 4 * q + n
                if mode == "roll":
                    nxt = np.where(nxt == lanes, 0, nxt)
                alone = (t % 32 == 31) | (q == quads - 1)
                assert (nxt[live] < min(lanes, x_lanes)).all()
                # the shuffle: lane + 1 holds the next quad of the row
                nb = np.append(wq[1:, 0], np.nan)
                assert ((item[1:] == item[:-1] + 1)
                        & (row[1:] == row[:-1]))[(~alone & live)[:-1]].all()
                nb = np.where(alone, xs[lr, np.minimum(nxt, x_lanes - 1)], nb)
                v = np.stack([np.where(n == 1, nb, wq[:, 1]),
                              np.where(n == 2, nb, wq[:, 2]),
                              np.where(n == 3, nb, wq[:, 3]), nb], 1) + c
            elif mode == "pool3":
                assert 12 * quads <= x_lanes
                src = np.minimum(12 * q[:, None] + np.arange(12), x_lanes - 1)
                y = (xs[lr[:, None], src] + c).reshape(-1, 4, 3)
                v = np.maximum(np.maximum(y[..., 0], y[..., 1]), y[..., 2])
            else:
                v = (xs[lr[:, None], 4 * q[:, None] + np.arange(4)] + c) + \
                    np.float32(1.0)
            for i in np.flatnonzero(live):
                dst = scr[g, row[i], 4 * q[i]:4 * q[i] + n[i]]
                assert np.isnan(dst).all()  # stored once an iteration
                dst[:] = v[i, :n[i]]
                if row[i] < 8 and q[i] < 32:
                    out[8 * g + row[i], 4 * q[i]:4 * q[i] + 4] = dst
    return scr, out


@pytest.mark.parametrize("mode,m,lanes,grid", SHIFT_SHAPES)
def test_shift_plan_covers_each_region_once(mode, m, lanes, grid):
    """K4's partition (shift_plan) through a model of the kernel's indexing:
    every (step, row, lane) of the mode's region is stored once an
    iteration with the plain version's value, bitwise, and the output
    block is the plain version's; the block size is one the kernel is
    built for, and the probe's own shapes put at least two blocks on each
    of 132 SMs."""
    plan = pm.shift_plan(mode, m, lanes, grid, 132)
    assert plan.threads <= _kernel_constant("SHIFT_MAX_THREADS")
    assert plan.threads in pm.SHIFT_THREADS and plan.x_lanes % 4 == 0
    if grid == 8:  # the probe's shapes
        assert plan.blocks * grid >= 2 * 132
    x = np.random.default_rng(1).standard_normal((m, lanes)).astype(
        np.float32)
    nops = 3
    c = np.float32(nops - 1) + np.float32(SALT)
    scr, out = _emulate_shift(x, c, mode, grid, plan)
    y = x + c
    want = {"shift1": lambda: y[:, 1:513],
            "roll": lambda: np.roll(y, -1, axis=1),
            "pool3": lambda: np.maximum(np.maximum(y[:, 0:507:3],
                                                   y[:, 1:508:3]),
                                        y[:, 2:509:3]),
            "copyblk": lambda: y[:192, :128] + np.float32(1.0)}[mode]()
    for g in range(grid):
        np.testing.assert_array_equal(scr[g], want)
    np.testing.assert_array_equal(
        out, pm.shift_probe(SALT, torch.from_numpy(x), nops, grid,
                            mode).numpy())


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    a, b, a_t, b_t = _dot_inputs(16, 64, 128, "store")
    with pytest.raises(ValueError, match="unknown dot mode"):
        pm.dot_probe(0.0, a_t, b_t, 9, 1, "rmw")
    with pytest.raises(ValueError, match="n >="):
        pm.dot_probe(0.0, a_t, b_t[:, :64].contiguous(), 9, 1, "store")
    with pytest.raises(ValueError, match=r"\(4, k, n\)"):
        pm.dot_probe(0.0, a_t, b_t, 9, 1, "brot")
    with pytest.raises(ValueError, match="bf16"):
        pm.dot_probe(0.0, a_t.float(), b_t, 9, 1, "store")
    with pytest.raises(ValueError, match="ndots"):
        pm.dot_probe(0.0, a_t, b_t, 0, 1, "store")
    x = torch.zeros(16, 500)
    with pytest.raises(ValueError, match="lanes >= 513"):
        pm.shift_probe(0.0, x, 4, 1, "shift1")
    with pytest.raises(ValueError, match="unknown shift mode"):
        pm.shift_probe(0.0, x, 4, 1, "gather")
    assert pm.shift_probe(0.0, x, 4, 1, "roll").shape == (8, 128)


def test_launch_counters_and_chunking():
    """Every mode has its launch counter (the CPU path counts nothing), and
    the dot kernel's walk gives every SM of the card one block whose run of
    dots is within one dot of the others'."""
    assert set(pm.launch_counts()) == (
        {f"probe_dot_{m}" for m in pm.DOT_MODES}
        | {f"probe_shift_{m}" for m in pm.SHIFT_MODES})
    pm.reset_launch_counts()
    a, b, a_t, b_t = _dot_inputs(16, 64, 128, "store")
    pm.dot_probe(0.0, a_t, b_t, 9, 1, "store")
    assert not any(pm.launch_counts().values())
    for kw in pm.MAIN_DOTS:
        offsets, units = pm.dot_plan(kw["m"], kw["n"], kw["ndots"], 8, 132)
        assert len(offsets) == 133 and offsets[-1] == len(units)
    # fewer dot-tiles than SMs: one a block
    offsets, units = pm.dot_plan(64, 128, 3, 1, 132)
    assert len(offsets) == 7 and all(u[4] == 1 for u in units)


@pytest.mark.parametrize("shape", pm.MAIN_DOTS,
                         ids=lambda kw: "{m}x{k}x{n}x{ndots}".format(**kw))
def test_dot_plan_covers_every_product_once(shape):
    """The walk holds every (step, dot, output tile) of a launch once, each
    unit a run of one (step, j, tile) in ascending i, and the blocks' runs
    are equal to within one dot, at the probe's eleven shapes on 132 SMs."""
    m, n, ndots, grid = shape["m"], shape["n"], shape["ndots"], 8
    tiles = (m // 64) * (n // 64)
    offsets, units = pm.dot_plan(m, n, ndots, grid, 132)
    seen = np.zeros((grid, ndots, tiles), np.int64)
    for g, j, t, i0, cnt in units:
        assert cnt >= 1 and i0 % 4 == j and i0 + 4 * (cnt - 1) < ndots
        seen[g, i0:i0 + 4 * cnt:4, t] += 1
    assert (seen == 1).all()
    per_block = [sum(u[4] for u in units[offsets[b]:offsets[b + 1]])
                 for b in range(len(offsets) - 1)]
    assert len(per_block) == 132 and min(per_block) >= 1
    assert max(per_block) - min(per_block) <= 1
    # a block reloads its operands only where (j, tile) changes: a few
    # fills a block
    fills = [len({(u[1], u[2]) for u in units[offsets[b]:offsets[b + 1]]})
             for b in range(len(offsets) - 1)]
    assert max(fills) <= -(-4 * tiles // 132) + 2


def _kernel_constant(name):
    """An integer constexpr of csrc/probe_megakernel.cu (``2 * DOT_LBO``
    style products of earlier ones too)."""
    src = (REPO / "audio_training_tpu_torch/csrc/probe_megakernel.cu"
           ).read_text()
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)
    return int(eval(expr, {}, {c: _kernel_constant(c)
                               for c in re.findall(r"[A-Z_]{3,}", expr)}))


def descriptor_offset(row, kk, k0=0):
    """The byte in a packed 64-row tile from which the kernel's wgmma reads
    element (row, kk), in the fill of k phase k0 .. (k0 a multiple of 64,
    copied to the start of shared memory): the instruction of k16 step (kk
    - k0) // 16 starts DOT_K16 bytes a step in; its no-swizzle k-major
    descriptor (PTX ISA, "Matrix Descriptor") puts core matrix (row // 8,
    kk % 16 // 8) DOT_SBO bytes a row group and DOT_LBO bytes a k group
    from that start, row % 8 at 16 bytes and kk % 8 at 2.  Returned as the
    byte in the whole packed tile: the phase's fill starts at byte
    k0 * 64 * 2 of it."""
    lbo, sbo = _kernel_constant("DOT_LBO"), _kernel_constant("DOT_SBO")
    k16 = _kernel_constant("DOT_K16")
    kr = kk - k0
    return (k0 * 64 * 2 + (kr // 16) * k16 + (kr % 16 // 8) * lbo
            + (row // 8) * sbo + (row % 8) * 16 + (kr % 8) * 2)


def _phases(k):
    """The kernel's k phases: (k0, width) runs of at most DOT_KC."""
    kc = min(k, _kernel_constant("DOT_KC"))
    return [(k0, min(kc, k - k0)) for k0 in range(0, k, kc)]


def test_dot_phases_fit_shared_memory():
    """A fill (A and B tiles of one phase, and the mbarrier) fits the
    card's 227 KB of shared memory a block, and its byte count the
    mbarrier's tx-count; k up to 896 is one phase, k-complete."""
    kc = _kernel_constant("DOT_KC")
    assert 2 * 64 * kc * 2 + 8 <= 232448 and 2 * 64 * kc * 2 < 2**20 - 1
    assert kc % 64 == 0
    assert _phases(896) == [(0, 896)] and _phases(640) == [(0, 640)]
    assert _phases(1024) == [(0, 896), (896, 128)]
    assert _phases(2048) == [(0, 896), (896, 896), (1792, 256)]


@pytest.mark.parametrize("mode", pm.DOT_MODES)
@pytest.mark.parametrize("k", [512, 640, 768, 1024])
def test_dot_packing_matches_the_descriptor(mode, k):
    """Every element of every packed tile sits where the kernel's wgmma
    descriptor reads it (``descriptor_offset``, the no-swizzle k-major
    layout, in the fill of its k phase): A tile (j, tm) row r, k index kk
    is a[j, 64 tm + r, kk]; B tile (j, tn) row c is b[(j,) kk, 64 tn + c]."""
    m, n = 128, 192
    a_idx = torch.arange(4 * m * k).reshape(4, m, k)
    b_idx = torch.arange((4 if mode == "brot" else 1) * k * n).reshape(
        (4, k, n) if mode == "brot" else (k, n))
    ap = pm.pack_dot_a(a_idx).reshape(-1).numpy()
    bp = pm.pack_dot_b(b_idx).reshape(-1).numpy()
    rows, kk = np.meshgrid(np.arange(64), np.arange(k), indexing="ij")
    off = np.zeros((64, k), np.int64)
    for k0, width in _phases(k):
        part = off[:, k0:k0 + width]
        part[:] = descriptor_offset(rows[:, k0:k0 + width],
                                    kk[:, k0:k0 + width], k0)
        # a phase's fill is one contiguous run of the tile: one bulk copy
        assert part.min() == k0 * 128 and part.max() == (k0 + width) * 128 - 2
    assert off.min() == 0 and np.unique(off).size == 64 * k
    assert (off % 2 == 0).all() and off.max() == 64 * k * 2 - 2
    tile = 64 * k
    for j in range(4):
        for tm in range(m // 64):
            got = ap[(j * (m // 64) + tm) * tile + off // 2]
            np.testing.assert_array_equal(
                got, a_idx[j, 64 * tm:64 * tm + 64].numpy())
        for tn in range(n // 64):
            if mode != "brot" and j:
                continue
            got = bp[(j * (n // 64) + tn) * tile + off // 2]
            b_j = b_idx[j] if mode == "brot" else b_idx
            np.testing.assert_array_equal(
                got, b_j[:, 64 * tn:64 * tn + 64].T.numpy())
    # a 64-row tile is one contiguous run: a bulk copy of 64 k bf16
    assert ap.size == 4 * m * k and bp.size == b_idx.numel()


def _emulate_dot_kernel(salt, a, b, ndots, grid, mode, blocks):
    """dot_probe_kernel's walk in numpy (f64 sums): each block's units in
    order, each of the two warpgroups' dots of a unit (s = wg, wg + 2,
    ...), the operands of each k phase read from its fill of the packed
    tiles through descriptor_offset and summed into one product, the
    "store"/"brot" slots and out rows, "accum"'s per-warpgroup sums and
    atomics."""
    m, k, n = a.shape[1], a.shape[2], b.shape[-1]
    ap = pm.pack_dot_a(a.float()).reshape(-1).numpy().astype(np.float64)
    bp = pm.pack_dot_b(b.float()).reshape(-1).numpy().astype(np.float64)
    gathers = []  # per phase: the tile's elements the phase's wgmmas read
    for k0, width in _phases(k):
        rows, kk = np.meshgrid(np.arange(64), np.arange(k0, k0 + width),
                               indexing="ij")
        gathers.append(descriptor_offset(rows, kk, k0) // 2)
    tiles_m, tiles_n = m // 64, n // 64
    offsets, units = pm.dot_plan(m, n, ndots, grid, blocks)
    i_out = (ndots - 1) // 8 * 8
    out = np.zeros((8 * grid, 128))
    scratch = np.zeros((grid, m, n))
    for blk in range(len(offsets) - 1):
        for g, j, t, i0, cnt in units[offsets[blk]:offsets[blk + 1]]:
            tm, tn = divmod(t, tiles_n)
            aj, bj = (0, j) if mode == "brot" else (j, 0)
            a_base = (aj * tiles_m + tm) * 64 * k
            b_base = (bj * tiles_n + tn) * 64 * k
            r0, c0 = 64 * tm, 64 * tn
            for wg in range(2):
                init = (np.float32(salt) * np.float32(1e-30)
                        if mode == "accum" and i0 == 0 and wg == 0 else 0.0)
                total = np.full((64, 64), float(init))
                for s in range(wg, cnt, 2):
                    d = sum(ap[a_base + gat] @ bp[b_base + gat].T
                            for gat in gathers)
                    if mode == "accum":
                        total += d
                    elif (4 * s + i0) == i_out and tm == 0 and c0 < 128:
                        out[8 * g:8 * g + 8, c0:c0 + 64] = d[:8]
                if mode == "accum" and wg < cnt:
                    scratch[g, r0:r0 + 64, c0:c0 + 64] += total
    if mode == "accum":
        out = scratch[:, :8, :128].reshape(8 * grid, 128)
    return out


@pytest.mark.parametrize("mode", pm.DOT_MODES)
@pytest.mark.parametrize("k", [64, 1024])
def test_dot_kernel_walk_emulation_matches_plain(mode, k):
    """The kernel's walk, emulated, gives dot_probe_plain's output: a
    shape with 2 x 3 tiles, ndots 13 (not a multiple of 4 or 8) and 7
    blocks, so units split runs of one (step, j, tile) and share fills; k
    1024 is walked in two phases."""
    m, n, ndots, grid = 128, 192, 13, 2
    _, _, a_t, b_t = _dot_inputs(m, k, n, mode, seed=3)
    want = pm.dot_probe_plain(0.5, a_t, b_t, ndots, grid, mode).numpy()
    got = _emulate_dot_kernel(0.5, a_t, b_t, ndots, grid, mode, 7)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < DOT_REL[mode], rel


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py times the probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.bench_dot(64, 64, 128, ndots=1, grid=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.main()
