"""Multiprocess host loader: parallel shard decode feeding the device (port
of ``audio_training_tpu/data/parallel_loader.py:26-142``).

The single-process ``RecordStream`` decodes ~sequentially; on multi-core
hosts gzip inflate + proto parsing become the training bottleneck.  This
loader mirrors the reference's process-level IO parallelism (8 writer
processes, audiowriter.py:602-632) on the read side: N workers each own a
disjoint slice of the shard list, decode and batch independently, and ship
ready (raw, labels) numpy batch pairs over a bounded queue; the parent only
copies them to the device (pinned, on a side stream: ``DeviceCopier``).

Under a data-parallel mesh every rank runs its own loader with the same
seeds and keeps its rows of each global batch; the batches are taken from
the workers in turn (worker 0's first, worker 1's first, ...) instead of
as they arrive, so every rank assembles the same sequence.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
from collections import deque
from pathlib import Path

import numpy as np
import torch

from audio_training_tpu_torch.taxonomy.labels import LabelSpace

log = logging.getLogger(__name__)


def _worker(
    shard_paths: list[str],
    space_dict: dict,
    samples_per_clip: int,
    batch_size: int,
    seed: int,
    loop: bool,
    out_queue: mp.Queue,
    worker: int = 0,
):
    """Decode and batch in a spawned process: host modules only, numpy out
    (the worker never touches ``torch.cuda``)."""
    from audio_training_tpu_torch.data.pipeline import RecordStream

    space = LabelSpace.from_dict(space_dict)
    stream = RecordStream(
        [Path(p) for p in shard_paths], space, samples_per_clip,
        seed=seed, loop=loop,
    )
    raw = np.empty((batch_size, samples_per_clip), np.float32)
    y = np.empty((batch_size, space.num_labels), np.float32)
    i = 0
    try:
        for r, lbl in stream:
            raw[i] = r
            y[i] = lbl
            i += 1
            if i == batch_size:
                out_queue.put((worker, (raw.copy(), y.copy())))
                i = 0
    finally:
        out_queue.put((worker, None))  # this worker is done


class ParallelLoader:
    """Iterate device batches produced by worker processes.

    When ``mix`` is true each yielded item is ``(raw, y, raw2, y2)`` — the
    second pair drawn from the same queue (independent worker shuffles),
    matching the reference's two-pipeline mixup zip.
    """

    def __init__(
        self,
        shards: list[Path],
        label_space: LabelSpace,
        samples_per_clip: int,
        batch_size: int,
        num_workers: int = 4,
        seed: int = 0,
        loop: bool = False,
        mix: bool = False,
        queue_depth: int = 4,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if not shards:
            raise ValueError("no shards")
        self.num_workers = max(1, min(num_workers, len(shards)))
        self.mix = mix
        self.device = device
        self.rows = None
        if mesh is not None and mesh.distributed:
            from audio_training_tpu_torch.parallel.mesh import batch_sharding

            self.rows = batch_sharding(mesh).rows(batch_size)
        # spawn, not fork: the parent has live threads (CUDA's, the
        # loaders') by the time the loader starts, and fork() from a
        # multithreaded process is a latent deadlock.  Workers re-import the
        # host modules and never touch a device; startup costs about 1 s of
        # each worker, paid once per loader.
        ctx = mp.get_context("spawn")
        self.queue: mp.Queue = ctx.Queue(maxsize=queue_depth * self.num_workers)
        space_dict = label_space.to_dict()
        self.procs = []
        for w in range(self.num_workers):
            my_shards = [str(s) for s in shards[w :: self.num_workers]]
            p = ctx.Process(
                target=_worker,
                args=(my_shards, space_dict, samples_per_clip, batch_size,
                      seed + w * 7919, loop, self.queue, w),
                daemon=True,
            )
            p.start()
            self.procs.append(p)

    def _next_pair(self, live: set, pending: dict, turn: list):
        """The next (raw, y) batch pair: as it arrives, or under a mesh the
        next worker's in turn (None once every worker is done)."""
        if self.rows is None:
            while live:
                w, item = self.queue.get()
                if item is None:
                    live.discard(w)
                    continue
                return item
            return None
        while live or any(pending.values()):
            w = turn[0]
            turn[0] = (w + 1) % self.num_workers
            while not pending[w] and w in live:
                v, item = self.queue.get()
                if item is None:
                    live.discard(v)
                else:
                    pending[v].append(item)
            if pending[w]:
                raw, y = pending[w].popleft()
                return raw[self.rows], y[self.rows]
        return None

    def __iter__(self):
        from audio_training_tpu_torch.data.pipeline import DeviceCopier

        copier = DeviceCopier(self.device)
        live = set(range(self.num_workers))
        pending = {w: deque() for w in range(self.num_workers)}
        turn = [0]
        try:
            while True:
                a = self._next_pair(live, pending, turn)
                if a is None:
                    return
                if not self.mix:
                    yield copier.ready(copier.put(a))
                    continue
                b = self._next_pair(live, pending, turn)
                if b is None:
                    return
                yield copier.ready(copier.put((*a, *b)))
        finally:
            self.close()

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=5)
