"""Host-side pool server with the paper's REST semantics.

This is the faithful analogue of NodIO's Node.js/Express server: a CRUD
chromosome store with PUT(best)/GET(random), per-experiment reset, UUID
tracking and logging duties — implemented as a thread-safe in-process object
(optionally file-journaled) instead of HTTP. It intermediates *processes*
(volunteer islands running anywhere: other hosts, other pods, CPU workers),
while ``core.pool`` intermediates *devices*.

Failure semantics are first-class: ``kill()``/``revive()`` emulate server
loss; clients see :class:`PoolUnavailable` and are expected to continue
evolving standalone (the paper's fault-tolerance property — covered by
tests/test_torch_async_pool.py and repro_torch.launch.volunteer_sim).
"""
from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as obs_trace

from . import acceptance as acceptance_lib
from .types import AcceptanceConfig


class PoolUnavailable(ConnectionError):
    """Raised when the server is down — clients must tolerate this."""


@dataclass
class PoolEntry:
    genome: np.ndarray
    fitness: float
    uuid: int
    experiment: int
    # repro-lint: disable=RNG02 -- an entry's timestamp is observability metadata, outside every seeded stream
    timestamp: float = field(default_factory=time.time)
    payload: Any = None      # opaque side-data (PBT weights / ckpt path)
    seq: int = -1            # server-assigned monotone id (exactly-once GETs)


class PoolServer:
    """Thread-safe chromosome pool with REST-like verbs.

    Routes (paper §2):
      PUT /chromosome      -> put(genome, fitness, uuid)
      GET /random          -> get_random()
      GET /best            -> get_best()
      DELETE /experiment   -> reset() (solution found -> next experiment)
      GET /stats           -> stats()

    ``acceptance`` (an :class:`~repro_torch.core.types.AcceptanceConfig`) makes
    the server apply the same registered immigrant-acceptance policy as
    the device pools, via the numpy mirror in
    :func:`repro_torch.core.acceptance.host_accept` — None keeps the paper's
    accept-every-PUT ring. Rejections are counted in ``stats()['rejected']``
    and journaled as ``put_rejected``.
    """

    def __init__(self, capacity: int = 1024, journal_path: Optional[str] = None,
                 seed: int = 0,
                 acceptance: Optional[AcceptanceConfig] = None,
                 resume: bool = False):
        self._lock = threading.Lock()
        self._capacity = capacity
        # deque(maxlen): O(1) ring eviction on the PUT hot path (a plain
        # list's pop(0) made a full pool quadratic over a run)
        self._entries: "collections.deque[PoolEntry]" = collections.deque(
            maxlen=capacity)
        if acceptance is not None \
                and acceptance.policy not in acceptance_lib.HOST_MIRRORED:
            # fail at construction, not on the first PUT mid-run: a
            # device-only custom policy has no numpy mirror to apply here
            raise ValueError(
                f"acceptance policy {acceptance.policy!r} has no host "
                f"mirror; PoolServer supports {acceptance_lib.HOST_MIRRORED}")
        self._acceptance = acceptance    # None -> legacy accept-every-PUT
        self._rng = random.Random(seed)
        self._up = True
        self._experiment = 0
        self._n_puts = 0
        self._n_rejected = 0
        self._n_gets = 0
        self._seq = 0
        self._best: Optional[PoolEntry] = None
        self._cursors: Dict[str, int] = {}   # named get_since positions
        self._journal_path = journal_path
        self._journal = None
        if journal_path:
            if resume and os.path.exists(journal_path):
                self._replay(journal_path)
            self._journal = open(journal_path, "a")

    # -- failure injection --------------------------------------------------
    def kill(self) -> None:
        with self._lock:
            self._up = False

    def revive(self) -> None:
        with self._lock:
            self._up = True

    @property
    def up(self) -> bool:
        with self._lock:
            return self._up

    def _check_up(self) -> None:
        # repro-lint: disable=LCK01 -- every caller is a verb body that already holds self._lock
        if not self._up:
            raise PoolUnavailable("pool server is down")

    # -- REST verbs ----------------------------------------------------------
    # Liveness is checked exactly once, *inside* the lock, in every verb:
    # the old unlocked pre-check duplicated the locked one (a TOCTOU pair),
    # so a kill()/revive() racing a request could observe two different
    # answers on one call. One locked check = one consistent behaviour.
    def _put(self, entry: PoolEntry) -> int:
        """Shared PUT path: acceptance decision (default: legacy ring
        insert), best tracking, journal. Returns the current experiment
        number; a policy rejection leaves the pool untouched (counted in
        stats()['rejected'])."""
        with self._lock:
            self._check_up()
            # stamp the experiment under the lock: reading it in the
            # callers raced new_experiment() and could tag an entry with
            # an epoch the locked insert no longer belongs to
            entry.experiment = self._experiment
            self._n_puts += 1
            acc = self._acceptance
            if acc is None or acc.policy == "always":
                decision = acceptance_lib.APPEND   # deque maxlen = ring evict
            else:
                residents = list(self._entries)
                # genome matrix only for distance policies — elitist's
                # argmin(fitness) must not pay an O(capacity x L) copy
                genomes = (np.stack([e.genome for e in residents])
                           if residents
                           and acc.policy in ("crowding", "dedup")
                           else None)
                decision = acceptance_lib.host_accept(
                    genomes,
                    np.asarray([e.fitness for e in residents]),
                    entry.genome, entry.fitness, acc, self._capacity)
            if decision is None:
                self._n_rejected += 1
                self._log({"op": "put_rejected", "uuid": entry.uuid,
                           "fitness": entry.fitness, "exp": self._experiment})
                return self._experiment
            entry.seq = self._seq
            self._seq += 1
            if decision is acceptance_lib.APPEND:
                self._entries.append(entry)
            else:
                self._entries[decision] = entry
            if self._best is None or entry.fitness > self._best.fitness:
                self._best = entry
            # write-ahead record: genome + the *resolved* slot decision, so
            # replay reconstructs the pool exactly without re-running the
            # acceptance policy against state that eviction already changed
            self._log({"op": "put", "uuid": entry.uuid,
                       "fitness": entry.fitness, "exp": self._experiment,
                       "seq": entry.seq,
                       "slot": ("a" if decision is acceptance_lib.APPEND
                                else int(decision)),
                       "genome": entry.genome.tolist(),
                       "dtype": str(entry.genome.dtype)})
            return self._experiment

    def put(self, genome: Any, fitness: float, uuid: int = 0) -> int:
        """PUT a chromosome. Returns the current experiment number."""
        with obs_trace.span("pool.put"):
            return self._put(PoolEntry(np.asarray(genome), float(fitness),
                                       int(uuid), -1))

    def put_with_payload(self, genome: Any, fitness: float, uuid: int = 0,
                         payload: Any = None) -> int:
        """PUT with opaque side-data (PBT weight snapshots / ckpt paths)."""
        with obs_trace.span("pool.put"):
            return self._put(PoolEntry(np.asarray(genome), float(fitness),
                                       int(uuid), -1, payload=payload))

    def get_random_entry(self) -> Optional[PoolEntry]:
        """GET a random entry with metadata/payload (None when empty)."""
        with obs_trace.span("pool.get_random"), self._lock:
            self._check_up()
            self._n_gets += 1
            if not self._entries:
                return None
            e = self._rng.choice(self._entries)
            self._log({"op": "get", "fitness": e.fitness})
            return e

    def get_random(self) -> Tuple[np.ndarray, float]:
        """GET a uniformly random chromosome (paper's migration GET)."""
        with obs_trace.span("pool.get_random"), self._lock:
            self._check_up()
            self._n_gets += 1
            if not self._entries:
                raise PoolUnavailable("pool is empty")
            e = self._rng.choice(self._entries)
            self._log({"op": "get", "fitness": e.fitness})
            return e.genome.copy(), e.fitness

    def get_since(self, seq: int, limit: int = 64,
                  cursor_id: Optional[str] = None,
                  ) -> Tuple[List[PoolEntry], int, int]:
        """GET every resident entry with ``entry.seq > seq``, lowest seq
        first, capped at ``limit``. Returns ``(entries, cursor, dropped)``:
        ``cursor`` is the highest seq the consumer has now covered (pass it
        back next call) — the exactly-once drain used by the non-blocking
        async host bridge: advancing the cursor guarantees no entry is ever
        served twice to the same consumer, without the server tracking
        consumers.

        ``cursor_id`` names a *server-side* cursor: the effective start is
        ``max(seq, stored position)`` and the advanced cursor is stored
        (and journaled) under the name. A consumer that loses its own
        cursor — a bridge restarted after a crash — resumes with
        ``seq=-1`` and the same ``cursor_id`` and still never sees an
        entry twice, even across a server restart (replay restores the
        stored positions).

        ``dropped`` counts the seqs in ``(seq, cursor]`` that are no longer
        resident — retired before this consumer ever saw them, whether
        ring-evicted on overflow, replaced by an acceptance policy
        (including a mid-ring victim whose neighbours survive), or cleared
        by ``reset``. When puts outpace the drain the old contract
        silently degraded to at-most-once; now every hole is detected,
        counted exactly once (the cursor advances past a gap even when
        nothing is returned), and surfaced so the bridge can report it."""
        with obs_trace.span("pool.get_since"), self._lock:
            self._check_up()
            self._n_gets += 1
            if cursor_id is not None:
                seq = max(int(seq), self._cursors.get(cursor_id, -1))
            fresh = sorted((e for e in self._entries if e.seq > seq),
                           key=lambda e: e.seq)[:limit]
            if fresh:
                # every resident seq in (seq, cursor] is in fresh (the
                # limit cuts from the top), so the holes are countable
                cursor = fresh[-1].seq
                dropped = (cursor - seq) - len(fresh)
            else:
                # nothing resident beyond seq: every later-assigned seq
                # is gone — cover them all so the gap is charged once
                cursor = max(seq, self._seq - 1)
                dropped = cursor - seq
            if cursor_id is not None:
                self._cursors[cursor_id] = cursor
            if fresh or dropped:
                self._log({"op": "get_since", "n": len(fresh),
                           "cursor": cursor, "dropped": dropped,
                           "cursor_id": cursor_id})
            return fresh, cursor, dropped

    def get_best(self) -> Tuple[np.ndarray, float]:
        with obs_trace.span("pool.get_best"), self._lock:
            self._check_up()
            if self._best is None:
                raise PoolUnavailable("pool is empty")
            return self._best.genome.copy(), self._best.fitness

    def reset(self) -> int:
        """Solution found: clear the pool, bump the experiment counter."""
        with self._lock:
            self._check_up()
            self._entries.clear()
            self._best = None
            self._experiment += 1
            self._log({"op": "reset", "exp": self._experiment})
            return self._experiment

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "up": self._up,
                "size": len(self._entries),
                "capacity": self._capacity,
                "experiment": self._experiment,
                "puts": self._n_puts,
                "rejected": self._n_rejected,
                "gets": self._n_gets,
                "best_fitness": None if self._best is None else self._best.fitness,
            }

    # -- write-ahead log replay (server restart survives, §2 durability) ----
    def _replay(self, path: str) -> None:
        """Rehydrate pool contents, seq counter, named cursors, experiment
        number and acceptance stats from an existing journal — the journal
        is a write-ahead log: every mutation was recorded *with its resolved
        effect* (genome + slot for puts), so replay is exact without
        re-running acceptance policies against long-evicted state. A torn
        final line (writer killed mid-append) ends the replay cleanly —
        everything before it is intact — and is *truncated away* before the
        journal reopens for append: a torn tail carries no newline, so a
        record appended after it would fuse into one corrupt line and lose
        both on the next replay."""
        good_end = 0
        with open(path, "rb") as f:
            for raw in f:
                line = raw.strip()
                if line:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break    # torn tail from a kill mid-write
                    self._apply(rec)
                good_end += len(raw)
        if good_end < os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(good_end)
        if good_end > 0:
            # a record whose *newline* was lost to the kill is complete
            # (it replayed) but unterminated — re-terminate it so the
            # next append starts a fresh line
            with open(path, "r+b") as f:
                f.seek(good_end - 1)
                if f.read(1) != b"\n":
                    f.write(b"\n")

    def _apply(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            op = rec.get("op")
            if op == "put" and "genome" in rec:
                entry = PoolEntry(
                    np.asarray(rec["genome"], dtype=np.dtype(rec["dtype"])),
                    float(rec["fitness"]), int(rec["uuid"]), int(rec["exp"]),
                    timestamp=rec.get("t", 0.0))
                entry.seq = int(rec["seq"])
                self._n_puts += 1
                slot = rec.get("slot", "a")
                if slot == "a":
                    self._entries.append(entry)
                else:
                    self._entries[int(slot)] = entry
                if self._best is None or entry.fitness > self._best.fitness:
                    self._best = entry
                self._seq = max(self._seq, entry.seq + 1)
            elif op == "put":    # pre-WAL journal: count, can't reconstruct
                self._n_puts += 1
            elif op == "put_rejected":
                self._n_puts += 1
                self._n_rejected += 1
            elif op == "get":
                self._n_gets += 1
            elif op == "get_since":
                self._n_gets += 1
                cursor = int(rec.get("cursor", -1))
                cid = rec.get("cursor_id")
                if cid is not None:
                    self._cursors[cid] = max(self._cursors.get(cid, -1),
                                             cursor)
                self._seq = max(self._seq, cursor + 1)
            elif op == "reset":
                self._entries.clear()
                self._best = None
                self._experiment = int(rec.get("exp", self._experiment + 1))

    # -- logging duties (the server "performs logging duties", §2) ----------
    def _log(self, rec: Dict[str, Any]) -> None:
        # repro-lint: disable=LCK01 -- _log is only called from verb bodies that hold self._lock
        journal = self._journal
        if journal is not None:
            # repro-lint: disable=RNG02 -- journal timestamps are observability metadata, outside every seeded stream
            rec["t"] = time.time()
            journal.write(json.dumps(rec) + "\n")
            journal.flush()

    def close(self) -> None:
        with self._lock:
            journal, self._journal = self._journal, None
        if journal is not None:
            journal.close()


class PoolClient:
    """A volunteer client's view of the server: never raises on failure.

    ``put``/``get_random`` return success flags / None instead of raising —
    exactly the browser behaviour of a lost XHR: the island just keeps
    evolving and retries at the next migration point.
    """

    def __init__(self, server: PoolServer, uuid: int = 0):
        self._server = server
        self.uuid = uuid
        self.lost_puts = 0
        self.lost_gets = 0

    def put(self, genome: Any, fitness: float) -> bool:
        try:
            self._server.put(genome, fitness, uuid=self.uuid)
            return True
        except PoolUnavailable:
            self.lost_puts += 1
            return False

    def get_random(self) -> Optional[Tuple[np.ndarray, float]]:
        try:
            return self._server.get_random()
        except PoolUnavailable:
            self.lost_gets += 1
            return None

    def reset(self) -> bool:
        try:
            self._server.reset()
            return True
        except PoolUnavailable:
            return False
