"""The collectives of the port's data parallel, each counted for the audit
(:mod:`audio_training_tpu_torch.parallel.audit`).

JAX's SPMD computes three reductions inside the model over the global
batch; a per-rank PyTorch program would compute them over its rows:

* train-mode BatchNorm's moments: :func:`all_reduce_sum` carries a
  gradient (a SUM all-reduce whose backward is a SUM all-reduce), which
  ``torch.distributed.all_reduce`` does not, so every rank's input gradient
  holds the other ranks' share of the mean (on the card, the kernels of
  ``ops/cuda/batch_norm.py`` all-reduce the same sums forward and their
  two gradient sums backward through :func:`all_reduce_sum_`);
* the PCEN chain's min-max: :func:`global_extrema` sends the summed
  gradient of the global minimum and maximum only to the elements equal to
  them, split among ties counted over all ranks, as JAX's ``reduce_max``
  gradient splits it (``all_reduce`` with MAX would reduce the gradient
  with MAX and send it everywhere);
* the epoch metrics: :func:`sum_over_ranks`.

The gradient all-reduce is DistributedDataParallel's, through
:func:`counting_allreduce_hook`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from audio_training_tpu_torch.parallel.audit import record
from audio_training_tpu_torch.parallel.mesh import Mesh


def _all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
    record("all-reduce", t.numel())
    dist.all_reduce(t, op=op, group=mesh.group)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    record("collective-broadcast", t.numel())
    dist.broadcast(t, src=src, group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        out = t.clone()
        _all_reduce(mesh, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(ctx.mesh, grad)
        return grad, None


def all_reduce_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, in place and without a
    gradient: for a kernel whose own backward all-reduces what it needs
    (``ops/cuda/batch_norm.py``)."""
    _all_reduce(mesh, t)
    return t


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, with a gradient: the backward
    all-reduces the incoming gradient too, since every rank's loss depends
    on every rank's ``t``."""
    return _AllReduceSum.apply(t, mesh)


class _GlobalExtrema(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        # f64 inputs keep their width; f32 holds bf16 and f32 exactly
        wide = torch.float64 if x.dtype == torch.float64 else torch.float32
        ext = torch.stack([x.min(), -x.max()]).to(wide)
        _all_reduce(mesh, ext, dist.ReduceOp.MIN)
        lo, hi = ext[0].to(x.dtype), (-ext[1]).to(x.dtype)
        ctx.mesh, ctx.wide = mesh, wide
        ctx.save_for_backward(x, lo, hi)
        return lo, hi

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        x, lo, hi = ctx.saved_tensors
        at_lo, at_hi = x == lo, x == hi
        s = torch.stack([g_lo.to(ctx.wide), g_hi.to(ctx.wide),
                         at_lo.sum().to(ctx.wide), at_hi.sum().to(ctx.wide)])
        _all_reduce(ctx.mesh, s)
        grad = at_lo * (s[0] / s[2]) + at_hi * (s[1] / s[3])
        return grad.to(x.dtype), None


def global_extrema(mesh: Mesh, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(min, max)`` of ``x`` over every rank's elements, in one 2-element
    all-reduce; their gradients go to the elements that hold them."""
    return _GlobalExtrema.apply(x, mesh)


def sum_over_ranks(mesh: Mesh, tensors: list[torch.Tensor]
                   ) -> list[torch.Tensor]:
    """Each tensor summed over the ranks, in one f64 all-reduce (new
    tensors; the inputs are left as they were)."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    _all_reduce(mesh, flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every data index's rows of ``t`` (the same row count on each rank),
    concatenated in data order on every rank."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    record("all-gather", t.numel() * mesh.size)
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts[::mesh.shape[1]])


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    box = [obj]
    record("collective-broadcast", 1)
    dist.broadcast_object_list(box, src=src, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl"
                               else None)
    return box[0]


def counting_allreduce_hook(mesh: Mesh, bucket):
    """DistributedDataParallel's gradient all-reduce (the mean over the
    ranks of each bucket), with the bucket's elements counted."""
    t = bucket.buffer()
    record("all-reduce", t.numel())
    t.div_(mesh.size)
    fut = dist.all_reduce(t, group=mesh.group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])
