"""Train-mode BatchNorm's kernels (``ops/cuda/batch_norm.py``) on the CPU:
what runs here without a card.

* The layout plan: the ``(outer, C, inner)`` view read from the strides of
  a channels-last conv output, an NCHW-contiguous tensor, badwinner2's
  per-mel-row view and a 2-D batch; the 16-byte vector width and the grid.
* The middle layout's index walks (the column carried into the row, no
  division an element), emulated: each element visited once, in its
  channel's reduce block and with its own row's coefficients in the apply.
* The refusals, before any launch: f64 and f16, a tensor that is not
  dense, parameters that are not f32, and a tensor off the card.
* The kernels' arithmetic (``csrc/batch_norm.cu``: the statistics, the
  running update, the affine, the two gradient sums and ``dx``'s formula
  with the variance clamp's gate) written as tensor ops, against autograd
  of the plain version in float64, to 1e-10 of each tensor's max; with the
  scale and bias and without, and where the clamp is active.
* Training on a CPU tensor keeps the plain version (the kernels' entry is
  never called), so the Flax parity tests of the layers hold it.

The kernels themselves run in tests/test_torch_gpu.py on a card.
"""

import pytest
import torch

from audio_training_tpu_torch.models import layers
from audio_training_tpu_torch.ops.cuda import batch_norm as bn

torch.set_num_threads(2)

SMS = 132  # an H100's SMs


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("name,x,feature_dim,want", [
    ("channels-last conv output", _cl((8, 64, 158, 511)), 1,
     (8 * 158 * 511, 64, 1)),
    ("channels-last head", _cl((8, 1024, 1, 46)), 1, (8 * 46, 1024, 1)),
    ("NCHW head, as badwinner2 runs it", torch.zeros(8, 1024, 1, 46), 1,
     (8, 1024, 46)),
    ("NCHW-contiguous", torch.zeros(8, 32, 40, 50), 1, (8, 32, 2000)),
    ("per-mel-row view", torch.zeros(8, 160, 513, 1).permute(0, 3, 1, 2), 2,
     (8, 160, 513)),
    ("per-mel-row, contiguous", torch.zeros(8, 1, 160, 513), 2,
     (8, 160, 513)),
    ("2-D batch", torch.zeros(16, 96), 1, (16, 96, 1)),
    ("last dim", torch.zeros(4, 5, 24), -1, (20, 24, 1)),
    ("one channel", torch.zeros(4, 1, 6, 7), 1, (168, 1, 1)),
])
def test_layout_reads_the_view_from_the_strides(name, x, feature_dim, want):
    assert bn.layout(x.shape, x.stride(), feature_dim % x.ndim) == want, name


def test_layout_ignores_the_strides_of_size_one_dims():
    x = torch.zeros(8, 160, 513, 1).permute(0, 3, 1, 2)
    odd = torch.as_strided(x, x.shape, (82080, 7, 513, 1))
    assert bn.layout(odd.shape, odd.stride(), 2) == (8, 160, 513)


@pytest.mark.parametrize("name,x", [
    ("a strided slice", torch.zeros(4, 8, 10, 12)[..., ::2]),
    ("a crop", torch.zeros(4, 8, 10, 12)[:, :, 1:]),
    ("an expanded batch", torch.zeros(1, 8, 5, 5).expand(4, 8, 5, 5)),
])
def test_layout_refuses_a_tensor_that_is_not_dense(name, x):
    with pytest.raises(ValueError, match="dense"):
        bn.layout(x.shape, x.stride(), 1)


@pytest.mark.parametrize("shape,channels_last,elem,aligned,want_vec", [
    ((8, 64, 10, 12), True, 2, True, 8),     # bf16, C % 8 == 0
    ((8, 64, 10, 12), True, 4, True, 4),     # f32, C % 4 == 0
    ((8, 64, 10, 12), True, 2, False, 1),    # off the 16-byte grid
    ((8, 20, 10, 12), True, 2, True, 1),     # bf16, C % 8 != 0
    ((8, 20, 10, 12), True, 4, True, 4),
    ((8, 64, 10, 12), False, 2, True, 1),    # middle layout: scalar
])
def test_plan_vector_width(shape, channels_last, elem, aligned, want_vec):
    x = torch.zeros(shape)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    assert bn.plan(x.shape, x.stride(), 1, elem, aligned, SMS).vec == want_vec


def test_plan_grid_at_the_training_cells_shapes():
    """At badwinner2's B=128 shapes: the rows layout takes the capped grid
    where there are enough rows, fewer blocks where a thread would walk
    under ROWS_PER_THREAD rows; the middle layout splits the batch so that
    C x splits blocks fill the card."""
    cap = bn.BLOCKS_PER_SM * SMS
    big = _cl((128, 64, 158, 511))
    p = bn.plan(big.shape, big.stride(), 1, 2, True, SMS)
    assert p == bn.Plan(128 * 158 * 511, 64, 1, 8, cap, cap, 1)
    head = _cl((128, 1024, 1, 46))
    p = bn.plan(head.shape, head.stride(), 1, 2, True, SMS)
    # 128 groups of 8 channels: 2 rows a block-step
    assert p.vec == 8 and p.partials == p.grid == -(-128 * 46 // (2 * 16))
    mel = torch.zeros(128, 1, 160, 513)
    p = bn.plan(mel.shape, mel.stride(), 2, 4, True, SMS)
    assert (p.outer, p.channels, p.inner, p.vec) == (128, 160, 513, 1)
    # 8 rows of 513 a chunk: 16 elements a thread
    assert p.partials == -(-cap // 160) and p.grid == cap and p.chunk == 8
    nchw_head = torch.zeros(128, 1024, 1, 46)  # as badwinner2 runs its head
    p = bn.plan(nchw_head.shape, nchw_head.stride(), 1, 2, True, SMS)
    assert (p.outer, p.channels, p.inner, p.chunk) == (128, 1024, 46,
                                                       bn.CHUNK_MAX)
    assert p.partials == 1 and p.grid == cap
    wide = _cl((2, 3000, 3, 3))  # wider than a block: chunks of 256 groups
    p = bn.plan(wide.shape, wide.stride(), 1, 2, True, SMS)
    assert p.vec == 8 and p.partials == -(-18 // 16)  # a row a block-step


def _reduce_mid_walk(outer, c, inner, splits):
    """csrc/batch_norm.cu's ``reduce_mid_kernel`` index walk, in Python:
    the elements each (channel, split) block's threads visit, in order."""
    threads, per = bn.THREADS, -(-outer // splits)
    d_row, d_i, row_step = threads // inner, threads % inner, c * inner
    walks = {}
    for ch in range(c):
        for sp in range(splits):
            o0, o1 = sp * per, min(sp * per + per, outer)
            n = max(o1 - o0, 0) * inner
            for t in range(threads):
                i = t % inner
                e = (o0 + t // inner) * row_step + ch * inner + i
                for _ in range(t, n, threads):
                    walks.setdefault((ch, sp), []).append(e)
                    i += d_i
                    e += d_row * row_step + d_i
                    if i >= inner:
                        i -= inner
                        e += row_step - inner
    return walks


def _apply_mid_walk(outer, c, inner, grid, chunk):
    """``apply_mid_kernel``'s walk: each element visited with the row whose
    coefficients it takes."""
    threads, rows = bn.THREADS, outer * c
    d_row, d_i = threads // inner, threads % inner
    seen = []
    for b in range(grid):
        for r0 in range(b * chunk, rows, grid * chunk):
            n = min(rows - r0, chunk) * inner
            for t in range(threads):
                row, i = t // inner, t % inner
                for j in range(t, n, threads):
                    seen.append((r0 * inner + j, r0 + row))
                    i += d_i
                    row += d_row
                    if i >= inner:
                        i -= inner
                        row += 1
    return seen


@pytest.mark.parametrize("outer,c,inner", [
    (5, 3, 513),  # rows longer than a block: a carry now and then
    (7, 4, 46),   # several rows a block-step, as badwinner2's head
    (3, 2, 256),  # a row a block-step exactly
    (6, 5, 1000),
])
def test_middle_layout_walks_each_element_once_with_its_channel(outer, c,
                                                               inner):
    """The middle layout's kernels carry the column into the row instead
    of dividing at each element: every element is visited once, in its
    channel's reduce block and with its own row's coefficients."""
    splits = 2
    walks = _reduce_mid_walk(outer, c, inner, splits)
    per = -(-outer // splits)
    want = {(ch, sp): [(o * c + ch) * inner + i
                       for o in range(sp * per, min(sp * per + per, outer))
                       for i in range(inner)]
            for ch in range(c) for sp in range(splits)}
    assert {k: sorted(v) for k, v in walks.items()} == want
    chunk = min(bn.CHUNK_MAX, -(-bn.THREADS * bn.ROWS_PER_THREAD // inner))
    seen = _apply_mid_walk(outer, c, inner, 3, chunk)
    assert sorted(e for e, _ in seen) == list(range(outer * c * inner))
    assert all(row == e // inner for e, row in seen)


def _module(c, feature_dim=1, scale=True, bias=True):
    return layers.KerasBatchNorm(c, feature_dim=feature_dim, use_scale=scale,
                                 use_bias=bias).train()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_refuses_other_dtypes_before_any_launch(dtype):
    m = _module(8)
    x = torch.zeros(2, 8, 3, 3, dtype=dtype)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bn.train_batch_norm(x, 1, m.weight, m.bias, m.running_mean,
                            m.running_var, m.eps, layers.BN_MOMENTUM)


def test_refuses_a_tensor_that_is_not_dense_before_any_launch():
    m = _module(8)
    x = torch.zeros(2, 8, 3, 6)[..., ::2]
    with pytest.raises(ValueError, match="dense"):
        bn.train_batch_norm(x, 1, m.weight, m.bias, m.running_mean,
                            m.running_var, m.eps, layers.BN_MOMENTUM)


def test_refuses_parameters_that_are_not_float32():
    m = _module(8)
    x = torch.zeros(2, 8, 3, 3)
    with pytest.raises(ValueError, match="float32 weight"):
        bn.train_batch_norm(x, 1, m.weight.double(), m.bias, m.running_mean,
                            m.running_var, m.eps, layers.BN_MOMENTUM)
    with pytest.raises(ValueError, match="running_var"):
        bn.train_batch_norm(x, 1, m.weight, m.bias, m.running_mean,
                            m.running_var[:4], m.eps, layers.BN_MOMENTUM)


def test_refuses_a_tensor_off_the_card():
    m = _module(8)
    x = torch.zeros(2, 8, 3, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="device cpu"):
        bn.train_batch_norm(x, 1, m.weight, m.bias, m.running_mean,
                            m.running_var, m.eps, layers.BN_MOMENTUM)


def test_training_on_the_cpu_keeps_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernels' entry called for a CPU tensor")

    monkeypatch.setattr(layers, "train_batch_norm", refuse)
    m = _module(8)
    x = torch.randn(4, 8, 5, 5, requires_grad=True)
    y = m(x)
    y.sum().backward()
    assert x.grad is not None and not torch.equal(
        m.running_mean, torch.zeros(8))


def kernel_formula(x, feature_dim, weight, bias, running_mean, running_var,
                   eps, momentum, dy):
    """``csrc/batch_norm.cu``'s arithmetic as tensor ops: the statistics
    and the running update (finalize_kernel), y (the forward apply), the
    gradient sums and parameter gradients (finalize_backward_kernel) and
    dx (the backward apply).  Returns y, dx, dweight, dbias and the new
    running statistics."""
    c = x.shape[feature_dim]
    shape = [1] * x.ndim
    shape[feature_dim] = c
    dims = [d for d in range(x.ndim) if d != feature_dim]
    n = x.numel() // c
    mean = x.sum(dims) / n
    d = (x * x).sum(dims) / n - mean * mean
    var = d.clamp_min(0.0)
    rstd = (var + eps).rsqrt()
    k = torch.where(d < 0, torch.zeros_like(rstd), rstd * rstd)
    new_mean = momentum * running_mean + (1 - momentum) * mean
    new_var = momentum * running_var + (1 - momentum) * var
    p = rstd if weight is None else rstd * weight
    xc = x - mean.view(shape)
    y = xc * p.view(shape)
    if bias is not None:
        y = y + bias.view(shape)
    sg = dy.sum(dims)
    sgx = (dy * xc).sum(dims)
    dweight = None if weight is None else sgx * rstd
    dbias = None if bias is None else sg
    dx = p.view(shape) * (dy - (sg / n).view(shape)
                          - xc * (k * sgx / n).view(shape))
    return y, dx, dweight, dbias, new_mean, new_var


def _max_rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name,shape,feature_dim,scale,bias", [
    ("conv BN", (4, 6, 5, 7), 1, True, True),
    ("per-mel-row BN, no scale or bias", (4, 1, 6, 9), 2, False, False),
    ("scale only", (3, 5, 4, 4), 1, True, False),
])
def test_kernel_formula_is_the_plain_versions_function(name, shape,
                                                       feature_dim, scale,
                                                       bias):
    g = torch.Generator().manual_seed(3)
    c = shape[feature_dim]
    m = _module(c, feature_dim, scale, bias).double()
    with torch.no_grad():
        if m.weight is not None:
            m.weight.uniform_(0.5, 1.5, generator=g)
        if m.bias is not None:
            m.bias.uniform_(-0.5, 0.5, generator=g)
        m.running_mean.uniform_(-1, 1, generator=g)
        m.running_var.uniform_(0.5, 2, generator=g)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 0.7)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    want_stats = (m.running_mean.clone(), m.running_var.clone())
    got = kernel_formula(x, feature_dim, m.weight, m.bias, *want_stats,
                         m.eps, layers.BN_MOMENTUM, dy)
    xr = x.clone().requires_grad_()
    y = m(xr)
    params = [t for t in (m.weight, m.bias) if t is not None]
    dx, *dparams = torch.autograd.grad(y, [xr, *params], dy)
    assert _max_rel(got[0], y) < 1e-10, name
    assert _max_rel(got[1], dx) < 1e-10, name
    for g_, want in zip([t for t in got[2:4] if t is not None], dparams):
        assert _max_rel(g_, want) < 1e-10, name
    assert _max_rel(got[4], m.running_mean) < 1e-12
    assert _max_rel(got[5], m.running_var) < 1e-12


def test_kernel_formula_where_the_variance_clamp_is_active():
    """A channel whose E[x^2] - mean^2 rounds below 0: var is clamped to 0
    and clamp_min passes no gradient to the variance, so dx has no variance
    term there (the kernels' k = 0); the other channel keeps k = rstd^2."""
    base = torch.tensor(0.1, dtype=torch.float64)
    found = None
    for step in range(1, 400):
        v = base + step * 1e-3
        vals = torch.stack([v, torch.nextafter(v, v + 1)]).repeat(8)
        n = vals.numel()
        mean = vals.sum() / n
        if float((vals * vals).sum() / n - mean * mean) < 0:
            found = vals
            break
    assert found is not None
    g = torch.Generator().manual_seed(5)
    x = torch.randn(16, 2, generator=g, dtype=torch.float64)
    x[:, 0] = found
    dy = torch.randn(16, 2, generator=g, dtype=torch.float64)
    m = _module(2).double()
    with torch.no_grad():
        m.weight.copy_(torch.tensor([1.3, 0.8]))
    got = kernel_formula(x, 1, m.weight, m.bias, m.running_mean.clone(),
                         m.running_var.clone(), m.eps, layers.BN_MOMENTUM, dy)
    xr = x.clone().requires_grad_()
    dx, = torch.autograd.grad(m(xr), [xr], dy)
    assert _max_rel(got[0], m.train_plain(x, m.weight, m.bias)) < 1e-10
    assert _max_rel(got[1], dx) < 1e-10
