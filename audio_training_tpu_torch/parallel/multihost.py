"""Multi-process helpers (port of
``audio_training_tpu/parallel/multihost.py``).

JAX connects its hosts with ``jax.distributed.initialize`` and runs one
program over all their devices.  The port runs one process a device and
joins them in a ``torch.distributed`` process group:
:func:`initialize_distributed` reads JAX's environment names or PyTorch's
launcher variables, and :func:`run_ranks` starts the ranks on one host
itself (``cli/train --data-shards N`` without a launcher, the tests, the
chip smoke test).

Every rank reads the same seeded record stream and keeps its rows of each
global batch (``data/pipeline.BatchLoader(mesh=...)``), so the batches are
the single-device run's; :func:`process_shard` is JAX's helper for work
lists that partition instead.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from audio_training_tpu_torch.parallel.mesh import Mesh

# a hung rank fails the run after this long, not after PyTorch's 30 minutes
DEFAULT_TIMEOUT_S = 600.0
# how long the rendezvous waits for every rank to start: on a busy host a
# rank that imports torch may come up long after the others, which no
# collective's timeout should have to allow for
RENDEZVOUS_TIMEOUT_S = 600.0


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "gloo",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to the process group.

    The arguments fall back to JAX's names (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID), then to a PyTorch launcher's
    (MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK), the port's form of JAX's
    auto-detection.  Returns True when a group of more than one process is
    up, False for one process (a no-op, so every path can call this).  The
    group's ``backend`` carries the rendezvous; ``parallel.make_mesh``
    picks the data path's.  Process 0 serves the rendezvous at the
    coordinator address, which waits up to ``RENDEZVOUS_TIMEOUT_S`` (or
    ``timeout_s``, if longer) for every process; after it, a rank that
    waits ``timeout_s`` on a collective fails."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if num_processes in (None, 1):
        return False  # single process
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address and this "
            f"process's id")
    host, port = coordinator_address.removeprefix("tcp://").rsplit(":", 1)
    store = dist.TCPStore(
        host, int(port), num_processes, is_master=process_id == 0,
        timeout=datetime.timedelta(
            seconds=max(timeout_s, RENDEZVOUS_TIMEOUT_S)))
    dist.init_process_group(
        backend, store=store, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_rank() -> int:
    """This process's index on its host: a launcher's LOCAL_RANK, else the
    rank."""
    local = _env_int("LOCAL_RANK")
    if local is not None:
        return local
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on rank 0 and in a single process: the one that writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_shard(items: list, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """This process's slice of a deterministic work list (e.g. record shard
    files): ``items[i::P]``."""
    i = process_index if process_index is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    p = process_count if process_count is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return list(items)[i::p]


def global_batch_from_local(mesh: Mesh, *arrays):
    """Each rank's part of a global batch from its LOCAL rows: every rank
    passes its own ``global / data`` rows, which are placed on its device
    as they are, so that on each rank they equal
    :func:`parallel.mesh.shard_batch`'s rows of the global batch, without
    any process holding the whole of it."""
    out = tuple(torch.as_tensor(a).to(mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]


def free_port() -> int:
    """A free TCP port on this host's loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, nprocs, init, backend, timeout_s, fn, args, results):
    try:
        initialize_distributed(init, nprocs, rank, backend=backend,
                               timeout_s=timeout_s)
        # pickled here, by value: the queue's own pickler would share CPU
        # tensors through file descriptors that die with this process
        out = pickle.dumps(fn(rank, *args))
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args: tuple = (), backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Start ``nprocs`` ranks on this host (spawned processes), join them in
    a ``backend`` group at a free loopback port, and run ``fn(rank,
    *args)`` in each; returns their return values in rank order.

    ``fn`` must be importable (a module-level function) and return
    picklable host values (numpy arrays, CPU tensors).  A rank that raises
    or dies fails the call with its traceback or exit code; the call has
    no deadline of its own, since a training run may last for days, and a
    rank that hangs in a collective fails after the group's ``timeout_s``.
    Every process is stopped before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, nprocs, init, backend, timeout_s, fn, args,
                               results), daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    failures = []
    grace = None  # after a failure, the others' last moment to report
    try:
        while len(out) + len(failures) < nprocs:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead and not failures:
                    raise RuntimeError(
                        f"rank(s) {dead} died with exit codes "
                        f"{[procs[r].exitcode for r in dead]}")
                if grace is not None and time.monotonic() > grace:
                    break
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                failures.append(f"rank {rank} failed:\n{value}")
                # the others may wait on it: give them a short while
                grace = time.monotonic() + 15.0
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for p in procs:
            p.join(timeout=5 if failures else 30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(nprocs)]


# how long the other ranks wait for rank 0's run in on_rank_zero: longer
# than any run; a rank 0 that dies still ends the wait, as its connections
# close
_RANK_ZERO_WAIT = datetime.timedelta(days=30)


def on_rank_zero(fn):
    """``fn()`` on rank 0 alone, its result returned on every rank of the
    process group; just ``fn()`` without a group of more than one process.

    For the run kinds that train on one device whatever the mesh (the
    vector-input models, ``rf-features``), as JAX's ignore theirs.  The
    other ranks wait in a broadcast on a gloo group of their own whose
    timeout is long, since the default group's would cut a run that
    outlasts it.  ``fn``'s result must be picklable."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return fn()
    # made by every rank before rank 0 starts, so that no rank waits for
    # the group itself under the default group's timeout
    group = dist.new_group(backend="gloo", timeout=_RANK_ZERO_WAIT)
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group)
    dist.destroy_process_group(group)
    return box[0]
