"""Host-sharded, prefetching data loader around any step -> batch source.

Port of ``repro/data/pipeline.py``. Each host makes only its shard, a
background thread keeps a small prefetch queue full, and
``state_dict``/``load_state_dict`` make the loader checkpointable (it is
just the step counter: the synthetic source is a pure function of the
step).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import torch


class ShardedLoader:
    def __init__(self, source, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        self._source = source
        self.shard = shard
        self.n_shards = n_shards
        self._step = start_step
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- synchronous API -----------------------------------------------------
    def next(self) -> Dict[str, torch.Tensor]:
        if self._q is not None:
            step, batch = self._q.get()
            self._step = step + 1
            return batch
        batch = self._source.batch_for_step(self._step, self.shard,
                                            self.n_shards)
        self._step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next()

    # -- background prefetch -------------------------------------------------
    def start(self) -> "ShardedLoader":
        self._q = q = queue.Queue(maxsize=self._prefetch)
        start = self._step

        def worker():
            # the worker keeps its own queue: stop() drops the loader's
            step = start
            while not self._stop.is_set():
                batch = self._source.batch_for_step(step, self.shard,
                                                    self.n_shards)
                q.put((step, batch))
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        self._q = None

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "shard": self.shard,
                "n_shards": self.n_shards}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        self._step = int(sd["step"])
