"""Multiprocess host loader: parallel shard decode feeding the device (port
of ``audio_training_tpu/data/parallel_loader.py:26-142``).

The single-process ``RecordStream`` decodes ~sequentially; on multi-core
hosts gzip inflate + proto parsing become the training bottleneck.  This
loader mirrors the reference's process-level IO parallelism (8 writer
processes, audiowriter.py:602-632) on the read side: N workers each own a
disjoint slice of the shard list, decode and batch independently, and ship
ready (raw, labels) numpy batch pairs over a bounded queue; the parent only
copies them to the device (pinned, on a side stream: ``DeviceCopier``).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
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
                out_queue.put((raw.copy(), y.copy()))
                i = 0
    finally:
        out_queue.put(None)  # this worker is done


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
    ):
        if not shards:
            raise ValueError("no shards")
        self.num_workers = max(1, min(num_workers, len(shards)))
        self.mix = mix
        self.device = device
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
                      seed + w * 7919, loop, self.queue),
                daemon=True,
            )
            p.start()
            self.procs.append(p)

    def _next_pair(self, live):
        while live[0] > 0:
            item = self.queue.get()
            if item is None:
                live[0] -= 1
                continue
            return item
        return None

    def __iter__(self):
        from audio_training_tpu_torch.data.pipeline import DeviceCopier

        copier = DeviceCopier(self.device)
        live = [self.num_workers]
        try:
            while True:
                a = self._next_pair(live)
                if a is None:
                    return
                if not self.mix:
                    yield copier.ready(copier.put(a))
                    continue
                b = self._next_pair(live)
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
