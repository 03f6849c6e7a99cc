"""The JSON wire protocol — verb shapes per arXiv:2401.17234.

The follow-up paper's insight is that the *chromosome is the JSON*: a
volunteer (browser tab or pod bridge) exchanges plain JSON objects with
a REST pool endpoint, so any runtime with an HTTP stack can join an
experiment. This module is the single source of truth for those shapes;
``tests/data/server_wire_golden.json`` pins every verb's request and
response so protocol drift fails loudly.

Verbs (all bodies and responses are ``application/json``):

  ``PUT    /v1/experiment/{exp}/chromosomes``
      body ``{"items": [{"chromosome": [...], "dtype": "int8",
      "fitness": f, "uuid": u}, ...]}`` — the batched PUT. Response
      ``{"experiment": e, "accepted": a, "rejected": r}`` (rejections
      come from the experiment's server-side acceptance policy).
  ``GET    /v1/experiment/{exp}/chromosomes/random?n=K``
      batched random GET (the paper's migration GET). Response
      ``{"items": [{"chromosome", "dtype", "fitness"}, ...]}`` — fewer
      than K items (possibly zero) when the pool is cold.
  ``GET    /v1/experiment/{exp}/chromosomes/since?seq=S&limit=N&cursor_id=C``
      exactly-once drain. ``seq`` is ``-1`` or the comma-joined
      per-shard cursor vector returned by the previous call;
      ``cursor_id`` names a server-side cursor that survives restarts of
      either end. Response ``{"items": [{"chromosome", "dtype",
      "fitness", "uuid", "seq", "shard", "experiment"}, ...],
      "cursor": [..per shard..], "dropped": d}``.
  ``GET    /v1/experiment/{exp}/best``     response ``{"chromosome",
      "dtype", "fitness"}``; 404 ``{"error": ...}`` when empty.
  ``DELETE /v1/experiment/{exp}``          reset (solution found) —
      response ``{"experiment": e}`` with the bumped counter.
  ``GET    /v1/experiment/{exp}/stats``    merged + per-shard stats.
  ``POST   /v1/experiment/{exp}``          create/ensure a namespace,
      body ``{"capacity", "shards", "seed", "acceptance", "epsilon"}``
      (all optional) — response ``{"experiment_name", "created",
      "config"}``.
  ``GET    /v1/experiments``               ``{"experiments": [names]}``.
  ``GET    /healthz`` / ``GET /metricz``   liveness / frontend counters.

Errors are ``{"error": msg}`` with a 4xx/5xx status; a rate-limited or
backpressured request gets ``429`` with a ``Retry-After`` header and
``{"error": ..., "retry_after": seconds}``.

Clients identify themselves with an ``X-Client-Id`` header (fallback:
peer address) — the token-bucket rate limiter is keyed on it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

#: bump on any incompatible shape change; served in /healthz
WIRE_VERSION = 1

JSONDict = Dict[str, Any]


# ---------------------------------------------------------------------------
# genome (de)serialization
# ---------------------------------------------------------------------------
def encode_genome(genome: np.ndarray) -> JSONDict:
    """``{"chromosome": [...], "dtype": "int8"}`` — dtype rides along so
    a round trip is bit-for-bit (binary genomes are int8, float genomes
    float32/float64; JSON alone can't tell them apart)."""
    arr = np.asarray(genome)
    return {"chromosome": arr.tolist(), "dtype": str(arr.dtype)}


def decode_genome(obj: JSONDict) -> np.ndarray:
    chrom = obj["chromosome"]
    dtype = obj.get("dtype")
    if dtype is not None:
        return np.asarray(chrom, dtype=np.dtype(dtype))
    return np.asarray(chrom)


# ---------------------------------------------------------------------------
# per-verb item shapes
# ---------------------------------------------------------------------------
def put_item(genome: np.ndarray, fitness: float, uuid: int = 0) -> JSONDict:
    out = encode_genome(genome)
    out["fitness"] = float(fitness)
    out["uuid"] = int(uuid)
    return out


def put_request(items: List[JSONDict]) -> JSONDict:
    return {"items": list(items)}


def decode_put_request(body: JSONDict) -> List[Tuple[np.ndarray, float, int]]:
    """-> [(genome, fitness, uuid)] — raises ``KeyError``/``ValueError``
    on malformed items (the frontend maps those to 400)."""
    items = body["items"]
    if not isinstance(items, list):
        raise ValueError("'items' must be a list")
    out = []
    for it in items:
        out.append((decode_genome(it), float(it["fitness"]),
                    int(it.get("uuid", 0))))
    return out


def random_item(genome: np.ndarray, fitness: float) -> JSONDict:
    out = encode_genome(genome)
    out["fitness"] = float(fitness)
    return out


def since_item(entry, shard: int) -> JSONDict:
    """A drained entry: everything the exactly-once consumer needs —
    ``seq`` + ``shard`` key the entry globally, ``uuid`` lets a bridge
    filter its own echoes."""
    out = encode_genome(entry.genome)
    out["fitness"] = float(entry.fitness)
    out["uuid"] = int(entry.uuid)
    out["seq"] = int(entry.seq)
    out["shard"] = int(shard)
    out["experiment"] = int(entry.experiment)
    return out


# ---------------------------------------------------------------------------
# cursor vector codec (the `seq` query param / `cursor` response field)
# ---------------------------------------------------------------------------
def encode_cursor(cursor: Union[int, List[int]]) -> str:
    if isinstance(cursor, (list, tuple)):
        return ",".join(str(int(c)) for c in cursor)
    return str(int(cursor))


def decode_cursor(raw: Optional[str], n_shards: int) -> List[int]:
    """Normalize the wire ``seq`` to one int per shard. A scalar (the
    cold-start ``-1``, or a legacy single-shard cursor) broadcasts."""
    if raw is None or raw == "":
        return [-1] * n_shards
    parts = [int(p) for p in str(raw).split(",")]
    if len(parts) == 1:
        return parts * n_shards
    if len(parts) != n_shards:
        raise ValueError(f"cursor has {len(parts)} entries for "
                         f"{n_shards} shards")
    return parts


def error_body(msg: str, retry_after: Optional[float] = None) -> JSONDict:
    out: JSONDict = {"error": msg}
    if retry_after is not None:
        out["retry_after"] = round(float(retry_after), 3)
    return out
