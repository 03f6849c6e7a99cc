"""Transport-independent multi-experiment pool core.

A :class:`PoolService` owns named experiment namespaces; each
:class:`Experiment` is a set of :class:`~repro_torch.core.async_pool.PoolServer`
shards behind a consistent-hash ring. Everything the in-process server
already guarantees — WAL journal + replay, named ``get_since`` cursors
with exact ``dropped`` accounting, the server-side acceptance registry —
is reused per shard; this layer only adds namespacing, routing, and
cross-shard merge semantics.

Sharding model
  * PUT routes by the *putter's* uuid, so one volunteer's stream lands
    on one shard (its journal ordering stays meaningful) and load
    spreads across shards without coordination.
  * ``get_since`` drains every shard under the same ``cursor_id`` and
    returns a per-shard cursor vector; exactly-once holds per shard, so
    it holds for the merge (entries are keyed by ``(shard, seq)``).
  * ``reset`` fans out to all shards, which therefore agree on the
    experiment counter; ``best`` is the max over shards.

Durability: with a ``spool_dir`` each shard journals to
``<spool>/<experiment>/shard<k>.jsonl`` and the namespace's config is
persisted next to them, so a service restarted with ``resume=True``
rehydrates every namespace — pools, seq counters, named cursors — from
the WALs (torn tails healed by the shard replay).

This object is thread-safe only to the extent PoolServer is (per-shard
locks); the HTTP frontend serializes verb execution on a small worker
pool, which also keeps cross-shard verbs (reset, stats) atomic enough
in practice. It is intentionally free of any asyncio dependency so
tests and in-process embeddings can drive it directly.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import re
import random
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import acceptance as acceptance_lib
from repro_torch.core.async_pool import PoolEntry, PoolServer, PoolUnavailable
from repro_torch.core.types import AcceptanceConfig

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")
_CONFIG_FILE = "experiment.json"


def check_name(name: str) -> str:
    """Experiment names become spool directory names — reject anything
    that could traverse or surprise the filesystem."""
    if not _NAME_RE.match(name or "") or ".." in name:
        raise ValueError(f"bad experiment name {name!r} "
                         f"(want [A-Za-z0-9][A-Za-z0-9_.-]{{0,63}})")
    return name


def _stable_hash(key: Union[str, int]) -> int:
    """Process-stable 64-bit hash (Python's ``hash`` is salted per
    process — useless for a ring two processes must agree on)."""
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class HashRing:
    """Consistent hashing over shard indices with virtual nodes.

    ``route(key)`` maps a key to a shard; adding a shard moves only
    ~1/(n+1) of the keyspace (tested), which is what will let a live
    service grow its shard set without re-homing every volunteer.
    """

    def __init__(self, n_shards: int, vnodes: int = 64):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.n_shards = n_shards
        self.vnodes = vnodes
        points: List[Tuple[int, int]] = []
        for shard in range(n_shards):
            for v in range(vnodes):
                points.append((_stable_hash(f"shard-{shard}#{v}"), shard))
        points.sort()
        self._hashes = [p for p, _ in points]
        self._shards = [s for _, s in points]

    def route(self, key: Union[str, int]) -> int:
        i = bisect.bisect(self._hashes, _stable_hash(key))
        return self._shards[i % len(self._shards)]


@dataclass(frozen=True)
class ExperimentConfig:
    """Per-namespace knobs, JSON-persisted to the spool on creation."""
    capacity: int = 1024        # per shard
    shards: int = 1
    seed: int = 0
    acceptance: str = "always"  # registered acceptance policy name
    epsilon: float = 0.0        # dedup rejection radius

    def acceptance_config(self) -> Optional[AcceptanceConfig]:
        if self.acceptance == "always":
            return None         # the paper's accept-every-PUT ring
        return AcceptanceConfig(policy=self.acceptance, epsilon=self.epsilon)

    @classmethod
    def from_json(cls, body: Dict[str, Any]) -> "ExperimentConfig":
        known = {f: body[f] for f in
                 ("capacity", "shards", "seed", "acceptance", "epsilon")
                 if f in body}
        cfg = cls(**known)
        if cfg.capacity < 1 or cfg.shards < 1:
            raise ValueError("capacity and shards must be >= 1")
        if cfg.acceptance != "always" \
                and cfg.acceptance not in acceptance_lib.HOST_MIRRORED:
            raise ValueError(
                f"acceptance policy {cfg.acceptance!r} has no host mirror; "
                f"server supports {sorted(acceptance_lib.HOST_MIRRORED)}")
        return cfg


class Experiment:
    """One namespace: sharded PoolServers + a consistent-hash ring."""

    def __init__(self, name: str, config: ExperimentConfig,
                 spool_dir: Optional[str] = None, resume: bool = False):
        self.name = check_name(name)
        self.config = config
        self.ring = HashRing(config.shards)
        # shard GET-randomness is seeded per (experiment seed, shard);
        # the experiment-level shard picker gets its own stream
        self._rng = random.Random(_stable_hash((config.seed, name)))
        journal = [None] * config.shards
        if spool_dir is not None:
            exp_dir = os.path.join(spool_dir, name)
            os.makedirs(exp_dir, exist_ok=True)
            with open(os.path.join(exp_dir, _CONFIG_FILE), "w") as fh:
                json.dump(asdict(config), fh)
            journal = [os.path.join(exp_dir, f"shard{k}.jsonl")
                       for k in range(config.shards)]
        self.shards = [
            PoolServer(capacity=config.capacity, journal_path=journal[k],
                       seed=config.seed * 8191 + k,
                       acceptance=config.acceptance_config(), resume=resume)
            for k in range(config.shards)]

    # -- verbs --------------------------------------------------------------
    def put_batch(self, items: Sequence[Tuple[np.ndarray, float, int]],
                  ) -> Dict[str, int]:
        """Batched PUT: each item routes by its uuid. Returns the
        experiment counter + accepted/rejected tallies (rejections are
        the server-side acceptance policy at work)."""
        by_shard: Dict[int, List[Tuple[np.ndarray, float, int]]] = {}
        for genome, fitness, uuid in items:
            by_shard.setdefault(self.ring.route(uuid), []).append(
                (genome, fitness, uuid))
        experiment = rejected = 0
        for shard, batch in sorted(by_shard.items()):
            s = self.shards[shard]
            before = s.stats()["rejected"]
            for genome, fitness, uuid in batch:
                experiment = s.put(genome, fitness, uuid=uuid)
            rejected += s.stats()["rejected"] - before
        return {"experiment": experiment, "accepted": len(items) - rejected,
                "rejected": rejected}

    def get_random(self, n: int = 1) -> List[PoolEntry]:
        """Up to ``n`` random entries. Shards are sampled independently;
        empty shards fall through round-robin so a cold shard never
        starves a warm experiment."""
        out: List[PoolEntry] = []
        for _ in range(max(0, n)):
            start = self._rng.randrange(self.config.shards)
            for off in range(self.config.shards):
                e = self.shards[(start + off) % self.config.shards] \
                    .get_random_entry()
                if e is not None:
                    out.append(e)
                    break
        return out

    def get_since(self, seqs: Sequence[int], limit: int = 64,
                  cursor_id: Optional[str] = None,
                  ) -> Tuple[List[Tuple[PoolEntry, int]], List[int], int]:
        """Merged exactly-once drain: each shard advances its own cursor
        (server-side under ``cursor_id``), the per-call ``limit`` splits
        across shards *before* any cursor moves — a post-merge truncation
        would silently drop entries the cursors already covered."""
        n = self.config.shards
        if len(seqs) != n:
            raise ValueError(f"cursor has {len(seqs)} entries for "
                             f"{n} shards")
        base, extra = divmod(max(int(limit), n), n)
        items: List[Tuple[PoolEntry, int]] = []
        cursors: List[int] = []
        dropped = 0
        for shard in range(n):
            lim = base + (1 if shard < extra else 0)
            entries, cursor, drop = self.shards[shard].get_since(
                seqs[shard], limit=lim, cursor_id=cursor_id)
            items.extend((e, shard) for e in entries)
            cursors.append(cursor)
            dropped += drop
        return items, cursors, dropped

    def get_best(self) -> Tuple[np.ndarray, float]:
        best: Optional[Tuple[np.ndarray, float]] = None
        for s in self.shards:
            try:
                g, f = s.get_best()
            except PoolUnavailable:
                continue
            if best is None or f > best[1]:
                best = (g, f)
        if best is None:
            raise PoolUnavailable("pool is empty")
        return best

    def reset(self) -> int:
        experiment = 0
        for s in self.shards:
            experiment = s.reset()
        return experiment

    def stats(self) -> Dict[str, Any]:
        per_shard = [s.stats() for s in self.shards]
        best = [st["best_fitness"] for st in per_shard
                if st["best_fitness"] is not None]
        return {
            "experiment_name": self.name,
            "shards": self.config.shards,
            "size": sum(st["size"] for st in per_shard),
            "capacity": sum(st["capacity"] for st in per_shard),
            "experiment": per_shard[0]["experiment"],
            "puts": sum(st["puts"] for st in per_shard),
            "rejected": sum(st["rejected"] for st in per_shard),
            "gets": sum(st["gets"] for st in per_shard),
            "best_fitness": max(best) if best else None,
            "per_shard": per_shard,
        }

    def close(self) -> None:
        for s in self.shards:
            s.close()


class PoolService:
    """Named experiment namespaces over one spool directory.

    ``ensure`` is the only mutation of the namespace map; the HTTP
    frontend calls it under an asyncio lock (experiment creation opens
    journal files — a real await point for every other request).
    """

    def __init__(self, spool_dir: Optional[str] = None, resume: bool = False,
                 default_config: ExperimentConfig = ExperimentConfig()):
        self.spool_dir = spool_dir
        self.default_config = default_config
        self._experiments: Dict[str, Experiment] = {}
        if resume and spool_dir and os.path.isdir(spool_dir):
            for name in sorted(os.listdir(spool_dir)):
                cfg_path = os.path.join(spool_dir, name, _CONFIG_FILE)
                if os.path.isfile(cfg_path):
                    with open(cfg_path) as fh:
                        cfg = ExperimentConfig.from_json(json.load(fh))
                    self._experiments[name] = Experiment(
                        name, cfg, spool_dir=spool_dir, resume=True)

    def ensure(self, name: str, config: Optional[ExperimentConfig] = None,
               ) -> Tuple[Experiment, bool]:
        """Get-or-create. A config on an *existing* namespace must match
        it (silently re-configuring a live experiment would strand its
        journals); ``None`` means 'whatever exists / the default'."""
        check_name(name)
        exp = self._experiments.get(name)
        if exp is not None:
            if config is not None and config != exp.config:
                raise ValueError(f"experiment {name!r} exists with a "
                                 f"different config")
            return exp, False
        exp = Experiment(name, config or self.default_config,
                         spool_dir=self.spool_dir)
        self._experiments[name] = exp
        return exp, True

    def experiments(self) -> List[str]:
        return sorted(self._experiments)

    def close(self) -> None:
        for exp in self._experiments.values():
            exp.close()
