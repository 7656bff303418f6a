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
    ("copyblk", 200, 128)])
def test_shift_probe_matches_jax_shift_kernel_interpret(jax_probe, mode, m,
                                                        lanes):
    x = np.random.default_rng(1).standard_normal((m, lanes)).astype(
        np.float32)
    nops, grid = 6, 2
    want = _jax_shift(jax_probe, SALT, jnp.asarray(x), nops, grid, mode)
    got = pm.shift_probe(SALT, torch.from_numpy(x), nops, grid, mode)
    assert got.shape == want.shape == (8 * grid, 128)
    np.testing.assert_array_equal(got.numpy(), want)


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
    the dot kernel's chunking gives the card about two blocks per SM
    without an empty chunk."""
    assert set(pm.launch_counts()) == (
        {f"probe_dot_{m}" for m in pm.DOT_MODES}
        | {f"probe_shift_{m}" for m in pm.SHIFT_MODES})
    pm.reset_launch_counts()
    a, b, a_t, b_t = _dot_inputs(16, 64, 128, "store")
    pm.dot_probe(0.0, a_t, b_t, 9, 1, "store")
    assert not any(pm.launch_counts().values())
    for kw in pm.MAIN_DOTS:
        m, n, ndots = kw["m"], kw["n"], kw["ndots"]
        chunks = pm.dot_chunks(m, n, ndots, 8, 132)
        per = -(-ndots // chunks)
        assert (chunks - 1) * per < ndots <= chunks * per
        blocks = (m // 64) * (n // 64) * 8 * chunks
        assert blocks >= 132 or chunks == ndots
    assert pm.dot_chunks(64, 128, 3, 1, 132) == 3  # at most one dot a chunk


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py times the probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.bench_dot(64, 64, 128, ndots=1, grid=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.main()
