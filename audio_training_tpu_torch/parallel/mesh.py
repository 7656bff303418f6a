"""Device mesh and sharding helpers (port of
``audio_training_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a ``(data, model)`` mesh of devices: batches
shard over ``data``, parameters are replicated, and XLA inserts the
cross-device reductions.  The port runs one process a device (a rank),
joined by a ``torch.distributed`` process group; :class:`Mesh` records the
shape, this rank, its device and the group.

Entered as a context (``with mesh:``), a mesh of more than one rank makes
the reductions that JAX computes over the global batch global here too:
train-mode ``KerasBatchNorm``'s moments, the PCEN chain's min-max, the
mixup, SpecAugment and dropout draws and the epoch metrics (see
:mod:`audio_training_tpu_torch.parallel.collectives`).  Outside such a
context, and on a one-device mesh, nothing changes and no collective runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_ACTIVE: list["Mesh"] = []


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` mesh of ranks, as seen from one of them.  Ranks
    ``r`` with the same ``r // model`` share a data index and hold the same
    rows, as ``P("data")`` replicates over JAX's model axis."""

    shape: tuple[int, int]
    rank: int
    device: torch.device
    group: object = None  # the process group; None on one device
    backend: str | None = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def active_mesh() -> Mesh | None:
    """The innermost entered mesh of more than one rank, else None."""
    return _ACTIVE[-1] if _ACTIVE and _ACTIVE[-1].distributed else None


def mesh_error(num_data: int, num_model: int, have: int) -> str | None:
    """JAX's message when a ``num_data x num_model`` mesh does not fit
    ``have`` devices, else None."""
    n = num_data * num_model
    if n > have:
        return f"mesh {num_data}x{num_model} needs {n} devices, have {have}"
    return None


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(num_data: int | None = None, num_model: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh over this process group's ranks.

    ``devices`` lists one ``torch.device`` a rank (on several hosts, each
    host's list names every rank's card); it defaults to every visible
    card, or one CPU a rank where there is none.  The mesh must take
    exactly the group's ranks and fit the list, else JAX's ``ValueError``
    ("mesh AxB needs N devices, have M").  The backend is chosen, never
    fallen back to: NCCL when every rank has a card of its own, gloo for
    CPU ranks or where the list names one card twice (the one-card
    rehearsal); a group of that backend is made when the default group's
    differs.  A one-device mesh has no group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        cards = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(cards)] if cards
                   else [torch.device("cpu")] * world)
    devices = [_normalize(d) for d in devices]
    if num_data is None:
        num_data = len(devices) // num_model
    n = num_data * num_model
    error = mesh_error(num_data, num_model, len(devices))
    if error is None and n != world:
        error = (f"mesh {num_data}x{num_model} needs {n} devices, have "
                 f"{world} (the process group's ranks)")
    if error is not None:
        raise ValueError(error)
    device = devices[rank]
    if n == 1:
        return Mesh((num_data, num_model), rank, device)
    used = devices[:n]
    if all(d.type == "cuda" for d in used) and len(set(used)) == n:
        backend = "nccl"
    elif all(d.type == "cpu" for d in used) or all(d.type == "cuda"
                                                   for d in used):
        backend = "gloo"
    else:
        raise ValueError(f"mesh devices mix cards and CPUs: {used}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = (dist.group.WORLD if dist.get_backend() == backend
             else dist.new_group(backend=backend))
    return Mesh((num_data, num_model), rank, device, group, backend)


@dataclass(frozen=True)
class BatchSharding:
    """The leading axis split over the data axis: this rank's rows."""

    data_size: int
    data_index: int

    def rows(self, n: int) -> slice:
        if n % self.data_size:
            raise ValueError(
                f"a batch of {n} rows does not divide over the mesh's data "
                f"axis of {self.data_size}")
        local = n // self.data_size
        return slice(self.data_index * local, (self.data_index + 1) * local)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Leading axis split over the data axis."""
    return BatchSharding(mesh.data_size, mesh.data_index)


class Replicated:
    """Placement of a replicated value: called on a module (its parameters
    and buffers), a tensor or a list of either, it broadcasts them in place
    from rank 0 and returns what it was given."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, obj):
        if not self.mesh.distributed:
            return obj
        from audio_training_tpu_torch.parallel.collectives import broadcast_

        items = obj if isinstance(obj, (list, tuple)) else [obj]
        with torch.no_grad():
            for item in items:
                tensors = ([*item.parameters(), *item.buffers()]
                           if isinstance(item, torch.nn.Module) else [item])
                for t in tensors:
                    broadcast_(self.mesh, t)
        return obj


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of host arrays (numpy or tensors), placed on its
    device; a batch that the data axis does not divide raises."""
    s = batch_sharding(mesh)
    out = []
    for a in arrays:
        rows = s.rows(len(a))
        if isinstance(a, torch.Tensor):
            out.append(a[rows].to(mesh.device))
        else:
            out.append(torch.as_tensor(np.ascontiguousarray(
                np.asarray(a)[rows])).to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def local_rows(n_local: int) -> tuple[int, slice]:
    """``(global rows, this rank's slice of them)`` for a batch of
    ``n_local`` rows under the active mesh: a draw for the global batch
    taken at the slice gives this rank the single-device draw's rows."""
    mesh = active_mesh()
    if mesh is None:
        return n_local, slice(None)
    n = n_local * mesh.data_size
    return n, batch_sharding(mesh).rows(n)
