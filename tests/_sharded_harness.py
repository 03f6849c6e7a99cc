"""The harness of the sharded tests: cases, both sides, comparison.

A case is a JSON-able dict (``name``, ``kind``, world size ``W`` and the
kind's arguments). The reference runs every case in one subprocess on four
fake CPU devices (``tests/_sharded_reference.py``), started first so it
runs while the port's worlds do; the port runs each world size's cases in
one spawned world of gloo ranks on the CPU, one thread each
(``tests/_torch_sharded_ranks.py``). Results are dicts of numpy arrays per
case, compared bit for bit (keys as int64 words).

Driver cases (``run_sharded``, ``run_fused_sharded``,
``run_fused_sharded_async``) take ``problem`` (``["onemax", L]`` or
``["trap", traps, l]``), ``cfg`` (EAConfig fields), ``mig`` (with
``acceptance`` as ``[policy, epsilon]``), ``acfg`` (AsyncConfig fields or
None), ``per`` (islands a shard), ``epochs``, ``seed``, ``w2``, ``stats``,
``obs``, ``astate``, ``down`` (epochs the server is down) and ``bridge``.
Migrate cases take ``topology``-bearing ``mig``, ``per``, ``epoch``,
``available`` (a bool, or a list of bools over every island), ``seed``,
``inputs`` and ``prefill``.
"""
import json
import os
import subprocess
import sys

import numpy as np

from repro_torch.core.sharded import spawn

import _torch_sharded_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds that bound a port world and the reference's subprocess
WORLD_TIMEOUT = 120.0
REFERENCE_TIMEOUT = 300.0

CFG = {"max_pop": 32, "min_pop": 16, "generations_per_epoch": 2,
       "mutation_rate": 0.05, "impl": "pallas_ref"}


def driver(name, kind, W, topology="pool", policy="always", **kw):
    case = {"name": name, "kind": kind, "W": W, "problem": ["onemax", 24],
            "cfg": CFG, "mig": {"topology": topology, "pool_capacity": 16,
                                "acceptance": [policy, 0.0]},
            "per": 2, "epochs": 3, "seed": 0}
    case.update(kw)
    return case


def start_reference(cases, tmp):
    spec, out = os.path.join(tmp, "cases.json"), os.path.join(tmp, "ref.npz")
    with open(spec, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_sharded_reference.py"),
         spec, out], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, out


def reference_results(handle):
    proc, out = handle
    try:
        _, err = proc.communicate(timeout=REFERENCE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    res = {}
    with np.load(out) as z:
        for key in z.files:
            name, field = key.split("::", 1)
            res.setdefault(name, {})[field] = z[key]
    return res


def port_world(cases, W):
    """Every rank's results of the world-``W`` cases."""
    return spawn(ranks.run_cases, W, "gloo", "cpu", timeout=WORLD_TIMEOUT,
                 args=(cases,), threads=1)


def run_both(cases, tmp):
    """``(port, ref)``: the port's per-rank results by world size, and the
    reference's results by case."""
    handle = start_reference(cases, tmp)
    try:
        port = {W: port_world(cases, W)
                for W in sorted({c["W"] for c in cases})}
    finally:
        ref = reference_results(handle)
    return port, ref


def assemble_migrate(per_rank, name):
    """The ranks' migrate results as the reference's shard_map gives them:
    pool replicas stacked, immigrants concatenated."""
    out = {}
    for k in per_rank[0][name]:
        parts = [r[name][k] for r in per_rank]
        out[k] = (np.stack(parts) if k.startswith("pools.")
                  else np.concatenate(parts))
    return out


def same_on_every_rank(per_rank, name):
    """A driver case's result, after checking every rank returned the same
    bits (the global state, and so every pool replica)."""
    first = per_rank[0][name]
    for r, res in enumerate(per_rank[1:], 1):
        assert res[name].keys() == first.keys()
        for k in first:
            assert bits(res[name][k]) == bits(first[k]), \
                f"{name}: rank {r}'s {k} differs from rank 0's"
    return first


def bits(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return a.dtype.str, a.shape, a.tobytes()


def assert_same(got, want, name, skip=()):
    """Every field of ``want`` bit for bit in ``got``."""
    missing = sorted(set(want) - set(got))
    assert not missing, f"{name}: the port lacks {missing}"
    for k in sorted(want):
        if k in skip:
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if bits(g) != bits(w):
            diff = np.argwhere(g != w) if g.shape == w.shape else None
            at = tuple(diff[0]) if diff is not None and len(diff) else None
            raise AssertionError(
                f"{name}: {k} differs (port {g.dtype}{g.shape}, reference "
                f"{w.dtype}{w.shape}; first at {at}: "
                f"{g[at] if at is not None else g!r} vs "
                f"{w[at] if at is not None else w!r})")
