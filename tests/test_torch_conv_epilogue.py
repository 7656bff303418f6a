"""The eval conv epilogue (``ops/cuda/conv_epilogue.py``,
``layers.conv_bn``) on the CPU: what runs here without a card.

* The kernel's plain version (f32 math on the bias-free conv output, f64
  for an f64 one) against the modules' composition ``bn(act(conv(x)))`` /
  ``act(bn(conv(x)))`` (+ the residual), in f64 (to 1e-12 of the output's
  max) and f32 (1e-5): both orders, no activation, SiLU and LeakyReLU,
  residual on and off, channels-last and NCHW inputs, odd channel counts.
* The launch plan (the 16-byte vector width, the grid) and the rows
  layout's flat walk under it, emulated: every group visited once, by a
  thread whose channels stay the same from step to step.
* The kernel's refusals before any launch, which are the whole rule of
  what it takes: ``conv_bn`` hands it every eval call on the card.
* ``conv_bn`` off the card, in training mode and with a gradient recorded:
  the modules' composition bitwise, counted ``plain`` and no launch; an
  eval ``BadWinner2`` and an eval ``EfficientNetV2("b3")`` forward count 7
  and 87 calls.

The kernel itself runs in tests/test_torch_gpu.py on a card.
"""

import pytest
import torch

from audio_training_tpu_torch.models import layers
from audio_training_tpu_torch.models.backbones import EfficientNetV2, MBConv
from audio_training_tpu_torch.models.badwinner2 import BadWinner2
from audio_training_tpu_torch.ops.cuda import conv_epilogue as ce
from audio_training_tpu_torch.utils import profiling

torch.set_num_threads(2)

SMS = 132  # an H100's SMs

# (activation, slope, activation first): badwinner2's LeakyReLU before
# the BatchNorm, the EfficientNets' SiLU after it, a projection's none
ACTS = [
    pytest.param(None, 0.0, False, id="none"),
    pytest.param("silu", 0.0, False, id="silu-after"),
    pytest.param("leaky_relu", 0.01, True, id="leaky-first"),
    pytest.param("silu", 0.0, True, id="silu-first"),
    pytest.param("leaky_relu", 0.3, False, id="leaky-after"),
]


def _modules(c_in, c, dtype, seed=0):
    """A 3x3 SAME conv with a bias and an eval BatchNorm of drawn running
    statistics, scale and offset, in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    conv = layers.Conv(c_in, c, (3, 3), padding="SAME", generator=g)
    bn = layers.KerasBatchNorm(c)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.1)
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
    return conv.to(dtype), bn.to(dtype).eval()


def _composition(conv, bn, x, act, slope, act_first, residual):
    fn = {None: lambda t: t, "silu": torch.nn.functional.silu,
          "leaky_relu": lambda t: torch.nn.functional.leaky_relu(t, slope)}
    fn = fn[act]
    y = bn(fn(conv(x))) if act_first else fn(bn(conv(x)))
    return y if residual is None else y + residual


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-5)])
@pytest.mark.parametrize("act,slope,act_first", ACTS)
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("c,channels_last", [(40, True), (136, False),
                                             (1392, True), (7, False)])
def test_plain_version_is_the_module_composition(
        dtype, limit, act, slope, act_first, with_residual, c,
        channels_last):
    conv, bn = _modules(5, c, dtype)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 6, 9, generator=g, dtype=dtype)
    residual = (torch.randn(2, c, 6, 9, generator=g, dtype=dtype)
                if with_residual else None)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    with torch.no_grad():
        want = _composition(conv, bn, x, act, slope, act_first, residual)
        y = conv(x, bias=False)
        got = ce.eval_epilogue_plain(
            y, conv.bias, bn.running_mean, bn.running_var, bn.weight,
            bn.bias, bn.eps, act, slope, act_first, residual)
    assert got.dtype == dtype
    assert _rel(got, want) < limit


def test_plain_version_without_scale_offset_or_bias():
    conv, bn = _modules(3, 16, torch.float64)
    bn.weight = bn.bias = None
    x = torch.randn(2, 3, 5, 5, dtype=torch.float64)
    with torch.no_grad():
        conv.bias.zero_()
        want = torch.nn.functional.silu(bn(conv(x)))
        got = ce.eval_epilogue_plain(conv(x, bias=False), None,
                                     bn.running_mean, bn.running_var, None,
                                     None, bn.eps, "silu")
    assert _rel(got, want) < 1e-12


def test_plain_version_rounds_once():
    """A bf16 input: the f32 result cast once, not a bf16 pass a step."""
    conv, bn = _modules(4, 24, torch.float32)
    y = torch.randn(3, 24, 5, 7).to(torch.bfloat16)
    args = (conv.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            bn.eps, "silu")
    with torch.no_grad():
        got = ce.eval_epilogue_plain(y, *args)
        want = ce.eval_epilogue_plain(y.float(), *args).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("name,x,aligned,want", [
    ("badwinner2 bns.0, B=256", _cl((256, 64, 158, 511)), True,
     ((256 * 158 * 511, 64, 1), 8, 8 * SMS, 1)),
    ("B3 expand, B=512: 20 groups, grid a multiple of 5",
     _cl((512, 160, 40, 129)), True, ((512 * 40 * 129, 160, 1), 8, 1055, 1)),
    ("B3 stage 6, C=1392: 174 groups, a multiple of 87",
     _cl((512, 1392, 5, 17)), True, ((512 * 5 * 17, 1392, 1), 8, 1044, 1)),
    ("B3 head, f32: 384 groups, a multiple of 3",
     _cl((2, 1536, 5, 17), torch.float32), True,
     ((2 * 5 * 17, 1536, 1), 4, 66, 1)),
    ("off the 16-byte grid", _cl((4, 40, 3, 3)), False,
     ((36, 40, 1), 1, 5, 1)),
    ("C=7: one channel a thread", _cl((4, 7, 3, 3)), True,
     ((36, 7, 1), 1, 7, 1)),
    ("C=4100: a grid of 1025, past the cap", _cl((1, 4100, 2, 3)), True,
     ((6, 4100, 1), 1, 1025, 1)),
    ("badwinner2 head NCHW", torch.zeros(256, 1024, 1, 46,
                                         dtype=torch.bfloat16), True,
     ((256, 1024, 46), 1, 8 * SMS, 64)),
    ("C=40 in the middle, 63 a row: chunks of 64 rows", torch.zeros(
        3, 40, 7, 9), True, ((3, 40, 63), 1, 2, 64)),
])
def test_plan(name, x, aligned, want):
    assert ce.plan(x.shape, x.stride(), x.element_size(), aligned,
                   SMS) == want, name


@pytest.mark.parametrize("shape,aligned", [
    ((3, 40, 5, 7), True), ((2, 136, 9, 11), True), ((1, 1392, 3, 3), True),
    ((5, 7, 6, 6), True), ((2, 40, 9, 9), False), ((1, 4100, 2, 3), True),
])
def test_rows_walk_keeps_each_threads_channels(shape, aligned):
    """``epilogue_rows_kernel``'s loop under the plan's grid: thread
    ``b * THREADS + t`` visits j from there in steps of the grid's
    threads, UNROLL at a time then one at a time; every group of the
    tensor is visited once, each with the channels of the thread's first
    (the step a multiple of the groups a row)."""
    x = _cl(shape)
    (outer, c, _), vec, grid, _ = ce.plan(x.shape, x.stride(), 2, aligned,
                                          SMS)
    groups, n_vec, unroll = c // vec, outer * c // vec, 4
    step = grid * ce.THREADS
    assert step % groups == 0
    seen = []
    for j0 in range(min(step, n_vec)):
        j = j0
        while j + (unroll - 1) * step < n_vec:
            seen += [(j + u * step, j0 % groups) for u in range(unroll)]
            j += unroll * step
        while j < n_vec:
            seen.append((j, j0 % groups))
            j += step
    assert sorted(j for j, _ in seen) == list(range(n_vec))
    assert all(g == j % groups for j, g in seen)


@pytest.mark.parametrize("dtype,match", [
    (torch.float64, "bfloat16 or float32"),
    (torch.float16, "bfloat16 or float32"),
    (torch.bfloat16, "device cpu"),
    (torch.float32, "device cpu"),
])
def test_kernel_refuses_before_any_launch(dtype, match):
    y = _cl((2, 8, 3, 3), dtype)
    p = torch.zeros(8)
    profiling.reset_counts("conv_epilogue")
    with pytest.raises(ValueError, match=match):
        ce.eval_epilogue(y, p, p, p, p, p, 1e-3, "silu")
    assert profiling.counts("conv_epilogue") == {"rows": 0, "mid": 0,
                                                 "plain": 0}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("act,slope,act_first,with_residual", [
    ("leaky_relu", 0.01, True, False),
    ("silu", 0.0, False, True),
    (None, 0.0, False, True),
])
def test_conv_bn_off_the_card_is_the_composition(train, grad, act, slope,
                                                 act_first, with_residual):
    """On a CPU tensor, in training mode or with a gradient recorded:
    the modules' calls, bitwise, counted ``plain``; the running statistics
    updated in training alike."""
    conv, bn = _modules(6, 24, torch.float32, seed=3)
    conv.dtype = torch.bfloat16
    bn.train(train)
    x = torch.randn(2, 6, 7, 9).to(torch.bfloat16)
    residual = (torch.randn(2, 24, 7, 9).to(torch.bfloat16)
                if with_residual else None)
    bn_want = layers.KerasBatchNorm(24)
    bn_want.load_state_dict(bn.state_dict())
    bn_want.train(train)
    with torch.set_grad_enabled(grad):
        fn = {None: lambda t: t, "silu": layers.silu,
              "leaky_relu": lambda t: layers.leaky_relu(t, slope)}[act]
        y = bn_want(fn(conv(x))) if act_first else fn(bn_want(conv(x)))
        want = y if residual is None else y + residual
        profiling.reset_counts("conv_epilogue")
        got = layers.conv_bn(conv, bn, x, act, slope, act_first, residual)
    assert profiling.counts("conv_epilogue") == {"rows": 0, "mid": 0,
                                                 "plain": 1}
    assert torch.equal(got, want)
    assert got.requires_grad == want.requires_grad
    assert torch.equal(bn.running_mean, bn_want.running_mean)
    assert torch.equal(bn.running_var, bn_want.running_var)


def test_mbconv_is_its_blocks_composition():
    """An eval MBConv off the card: the same output as its modules run by
    hand, residual included."""
    m = MBConv(16, 16, 3, 1, 4, fused=False).eval()
    x = torch.randn(2, 16, 6, 6)
    with torch.no_grad():
        y = layers.silu(m.expand_bn(m.expand(x)))
        y = m.se(layers.silu(m.depthwise_bn(m.depthwise(y))))
        want = m.project_bn(m.project(y)) + x
        got = m(x)
    assert m.residual and torch.equal(got, want)


@pytest.mark.parametrize("name,model,x,calls", [
    ("badwinner2", lambda: BadWinner2(62), torch.randn(1, 160, 110, 1), 7),
    ("EfficientNetV2-B3", lambda: EfficientNetV2(3, "b3"),
     torch.randn(1, 3, 32, 32), 87),
])
def test_eval_forward_counts_its_epilogues(name, model, x, calls):
    m = model().eval()
    profiling.reset_counts("conv_epilogue")
    with torch.no_grad():
        m(x)
    assert profiling.counts("conv_epilogue") == {"rows": 0, "mid": 0,
                                                 "plain": calls}
