"""The port's side of the sharded tests: what each rank of a spawned world
runs (torch only, so a spawned rank imports no jax).

:func:`run_cases` runs every case of its world size on this rank and
returns, per case, a dict of numpy arrays in the layout
``tests/_sharded_reference.py`` gives the reference's: a migrate case this
rank's pool replica and immigrants, a driver case the global state the
driver returned (every rank returns it, so the harness can hold the ranks'
copies, the pool replicas among them, to rank 0's).
"""
import os
import shutil

import numpy as np
import torch

from repro_torch import convert, rand
from repro_torch.core import (AcceptanceConfig, AsyncConfig, EAConfig,
                              HostBridge, MigrationConfig, PoolServer,
                              make_onemax, make_trap, migration)
from repro_torch.core import pool as pool_lib
from repro_torch.core.sharded import (run_fused_sharded,
                                      run_fused_sharded_async, run_sharded)
from repro_torch.core.types import GenomeSpec, PoolState


def problem(spec):
    return make_onemax(spec[1]) if spec[0] == "onemax" else make_trap(
        spec[1], spec[2])


def configs(c):
    cfg = EAConfig(**c["cfg"])
    m = dict(c["mig"])
    policy, eps = m.pop("acceptance", ("always", 0.0))
    mig = MigrationConfig(acceptance=AcceptanceConfig(policy=policy,
                                                      epsilon=eps), **m)
    acfg = (AsyncConfig(**c["acfg"]) if c.get("acfg") is not None
            else None)
    return cfg, mig, acfg


def flat(prefix, tree, out):
    for f, v in zip(tree._fields, tree):
        out[f"{prefix}.{f}"] = v.cpu().numpy()


def flat_obs(h, out):
    for k, v in h.items():
        if k != "totals":
            out[f"obs.{k}"] = np.asarray(v)


def migrate_inputs(c, dev):
    n = c["W"] * c["per"]
    length = c.get("L", 8)
    if c.get("inputs") == "negzero":
        g = (np.arange(n, dtype=np.float32)[:, None]
             * np.ones((n, length), np.float32))
        g[n - 1, 0] = -0.0
        g[n - 1, 1] = 0.0
        g[n - 1, 2] = -1.5
        gen = GenomeSpec("float", length)
    else:
        g = (np.arange(n, dtype=np.int8)[:, None]
             * np.ones((n, length), np.int8))
        gen = GenomeSpec("binary", length)
    f = np.arange(n, dtype=np.float32)
    if c.get("ties"):
        f[1::2] = f[0::2]
    return torch.from_numpy(g).to(dev), torch.from_numpy(f).to(dev), gen


def run_migrate(group, c):
    _, mig, _ = configs(dict(c, cfg={}))
    dev = group.device
    g, f, gen = migrate_inputs(c, dev)
    avail = c.get("available", True)
    per = c["per"]
    pool0 = pool_lib.pool_init(mig.pool_capacity, gen, device=dev)
    if c.get("prefill"):
        pool0 = pool_lib.pool_put_batch(pool0, g[:3] * 0 + 1, f[:3] + 0.5)
    av = (torch.tensor(avail, device=dev)[group.rank * per:
                                          (group.rank + 1) * per]
          if isinstance(avail, list) else avail)
    pool, ig, if_, dl, ac = migration.migrate(
        pool0, group.rows(g, per), group.rows(f, per),
        rand.key(c["seed"], device=dev), mig, axis=group,
        epoch=c.get("epoch", 0), available=av, with_ledger=True)
    out = {}
    flat("pools", pool, out)
    for k, v in (("imm_g", ig), ("imm_f", if_), ("delivered", dl),
                 ("accepted", ac)):
        out[k] = v.cpu().numpy()
    return out


def run_driver(group, c):
    cfg, mig, acfg = configs(c)
    prob = problem(c["problem"])
    kw = dict(islands_per_shard=c["per"], rng=c["seed"],
              w2=c.get("w2", False))
    out = {}
    if c["kind"] == "run_sharded":
        down = set(c.get("down", ()))
        bridge = server = None
        if c.get("bridge"):
            server = PoolServer(capacity=c["bridge"]["capacity"],
                                seed=c["bridge"]["seed"])
            for i, fit in enumerate(c["bridge"]["volunteers"]):
                server.put(np.full(prob.genome.length, i % 2, np.int8), fit,
                           uuid=100 + i)
            bridge = HostBridge(server, every=c["bridge"]["every"],
                                pull=c["bridge"]["pull"])
        isl, pool, ep = run_sharded(group, prob, cfg, mig,
                                    max_epochs=c["epochs"],
                                    server_up=lambda e: e not in down,
                                    host_bridge=bridge, **kw)
        res = [isl, pool, ep]
        if bridge is not None:
            st = server.stats()
            out["server"] = np.array([st[k] for k in (
                "size", "puts", "rejected", "gets", "experiment")], np.int64)
            out["server.best"] = np.float64(st["best_fitness"])
            out["bridge"] = np.array([bridge.pushed, bridge.pulled,
                                      bridge.lost], np.int64)
    elif c["kind"] == "run_fused_sharded":
        res = list(run_fused_sharded(
            group, prob, cfg, mig, max_epochs=c["epochs"],
            return_stats=c.get("stats", False),
            return_obs=c.get("obs", False), **kw))
    else:
        res = list(run_fused_sharded_async(
            group, prob, cfg, mig, acfg, max_ticks=c["epochs"],
            return_stats=c.get("stats", False),
            return_astate=c.get("astate", False),
            return_obs=c.get("obs", False), **kw))
    flat("islands", res.pop(0), out)
    flat("pool", res.pop(0), out)
    out["epochs"] = np.int64(int(res.pop(0)))
    if c.get("stats"):
        flat("stats", res.pop(0), out)
    if c.get("astate"):
        flat("astate", res.pop(0), out)
    if c.get("obs"):
        flat_obs(res.pop(0), out)
    return out


def _resume_run(group, c, per, **more):
    cfg, mig, acfg = configs(c)
    prob = problem(c["problem"])
    kw = dict(rng=c["seed"], return_stats=True, snapshot_every=c["every"],
              snapshot_dir=c["dir"], islands_per_shard=per)
    if acfg is None:
        return run_fused_sharded(group, prob, cfg, mig,
                                 max_epochs=c["epochs"], **kw, **more)
    return run_fused_sharded_async(group, prob, cfg, mig, acfg,
                                   max_ticks=c["epochs"], **kw, **more)


def snapshot(group, c):
    """The first half of a resume case: a run with snapshots into
    ``c["dir"]``, its newest snapshot dropped (rank 0) when ``drop``.
    Returns the uninterrupted run's flattened state."""
    if group.rank == 0:
        shutil.rmtree(c["dir"], ignore_errors=True)
    group.barrier()
    isl, pool, ep, stats = _resume_run(group, c, c["per"])
    if c.get("drop") and group.rank == 0:
        steps = sorted(s for s in os.listdir(c["dir"])
                       if s.startswith("step_"))
        shutil.rmtree(os.path.join(c["dir"], steps[-1]))
    group.barrier()
    out = {}
    flat("islands", isl, out)
    flat("pool", pool, out)
    out["epochs"] = np.int64(int(ep))
    flat("stats", stats, out)
    return out


def resume(group, c):
    """The second half: resume from ``c["dir"]`` at this world size."""
    isl, pool, ep, stats = _resume_run(group, c, c["per2"], resume=True)
    out = {}
    flat("islands", isl, out)
    flat("pool", pool, out)
    out["epochs"] = np.int64(int(ep))
    flat("stats", stats, out)
    return out


def compress_inputs(c):
    """The reference's inputs (``_sharded_reference.compress_inputs``,
    copied: this module imports no jax)."""
    rng = np.random.default_rng(c["seed"])
    W = c["W"]
    a = (rng.normal(size=(W, 64)) * 3).astype(np.float32)
    b = rng.normal(size=(W, 33)).astype(np.float32)
    t = np.tile(np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
                         np.float32), (W, 1)) * np.arange(
        1, W + 1, dtype=np.float32)[:, None]
    errs = {k: (rng.normal(size=v.shape) * 0.01).astype(np.float32)
            for k, v in (("a", a), ("b", b), ("t", t))}
    if c.get("zero_error"):
        errs = {k: np.zeros_like(v) for k, v in errs.items()}
    return {"a": a, "b": b, "t": t}, errs


def run_compress(group, c):
    """This rank's row of the inputs through ``compress_psum``."""
    from repro_torch.optim.compression import compress_psum
    grads, errs = compress_inputs(c)
    r, dev = group.rank, group.device
    g = {k: torch.from_numpy(v[r].copy()).to(dev) for k, v in grads.items()}
    g["b"] = g["b"].to(torch.bfloat16)
    e = {k: torch.from_numpy(v[r].copy()).to(dev) for k, v in errs.items()}
    out, err = compress_psum(g, e, group, method=c["method"])
    res = {}
    for k in sorted(out):
        res[f"out.{k}"] = out[k].float().cpu().numpy()
        res[f"err.{k}"] = err[k].cpu().numpy()
    return res


def run_cases(group, cases):
    """Every case of this world size, in order: name -> this rank's dict
    of arrays."""
    out = {}
    for c in cases:
        if c["W"] != group.world:
            continue
        if c["kind"] == "migrate":
            out[c["name"]] = run_migrate(group, c)
        elif c["kind"] == "snapshot":
            out[c["name"]] = snapshot(group, c)
        elif c["kind"] == "resume":
            out[c["name"]] = resume(group, c)
        elif c["kind"] == "compress":
            out[c["name"]] = run_compress(group, c)
        else:
            out[c["name"]] = run_driver(group, c)
    return out


def collectives(group):
    """The group's collectives on seeded per-rank inputs, for the unit
    tests: each result as numpy."""
    dev = group.device
    r, w = group.rank, group.world
    x = torch.arange(6, dtype=torch.int8, device=dev).reshape(2, 3) + 10 * r
    flag = torch.tensor(r == w - 1, device=dev)
    f = torch.tensor([0.1 * (r + 1), -0.0 if r == 0 else 0.0],
                     dtype=torch.float32, device=dev)
    ring = [(i, (i + 1) % w) for i in range(w)]
    out = {
        "gather": group.gather(x), "stack": group.gather_stack(x),
        "ring": group.permute(x, ring),
        "partial": group.permute(x, [(0, w - 1)]),
        "sum": group.all_reduce(torch.tensor([r, 1], dtype=torch.int32,
                                             device=dev)),
        "max": group.all_reduce(torch.tensor(float(r), device=dev), "max"),
        "any": group.any(flag), "none": group.any(~flag & flag),
        "ordered": group.sum_in_order(f),
        "bcast": group.broadcast(x, src=w - 1),
        "bool_gather": group.gather(flag.reshape(1)),
    }
    group.barrier()
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["calls"] = np.int64(group.calls)
    try:
        group.all_reduce(f)
    except ValueError as e:
        out["float_sum_refused"] = np.array(str(e))
    return out


def host_group(group):
    """``make_host_group`` inside a spawned rank returns that rank's
    group."""
    from repro_torch.launch.mesh import make_host_group
    g = make_host_group(device="cpu")
    return (g.rank, g.world, str(g.device), g.name)


def raise_on_rank_one(group):
    if group.rank == 1:
        raise ValueError("rank one refuses")
    return group.rank


def hang_on_rank_one(group):
    """Rank 1 never joins the collective: rank 0 must time out."""
    if group.rank == 1:
        import time
        time.sleep(3600)
    group.barrier()
    return group.rank


def migrate_every_topology(group, pool, best_g, best_f, words, epoch,
                           policy):
    """``migrate(axis=group)`` of each topology on numpy inputs (this
    rank's islands), as numpy: ``{topology: (pool, imm_g, imm_f,
    delivered, accepted)}``."""
    out = {}
    for topo in migration.available_topologies():
        mig = MigrationConfig(topology=topo,
                              acceptance=AcceptanceConfig(policy=policy))
        res = migration.migrate(
            PoolState(*(torch.from_numpy(np.array(a)) for a in pool)),
            torch.from_numpy(best_g), torch.from_numpy(best_f),
            torch.from_numpy(words.astype(np.int64)), mig, axis=group,
            epoch=epoch, with_ledger=True)
        out[topo] = convert.to_numpy(res)
    return out


# ---------------------------------------------------------------------------
# The drivers' graphs, emulated on the CPU
# (tests/test_torch_sharded_graphs.py)
# ---------------------------------------------------------------------------
def _rank_graphs():
    """The RankGraphs of the cached runners, in the cache's order."""
    from repro_torch.core import evolution, graphed
    out = []
    for _, runner in evolution._FUSED_CACHE.values():
        graph = getattr(runner, "graph", None)
        assert isinstance(graph, graphed.RankGraph), runner
        out.append(graph)
    return out


def _emulated(fn):
    """``fn()`` with CUDA graphs emulated (``_torch_capture``), from an
    empty runner cache; returns its result and the captures of every
    cached runner's graph."""
    import pytest

    from _torch_capture import emulate_graphs
    from repro_torch.core import evolution
    evolution.clear_fused_cache()
    try:
        with pytest.MonkeyPatch.context() as mp:
            emulate_graphs(mp)
            res = fn()
            captures = [g.captures for g in _rank_graphs()]
    finally:
        evolution.clear_fused_cache()
    return res, captures


def _two_runs(group, c):
    """One capture serves two runs of run_fused_sharded with one problem
    object: the first run's results are kept through the second, and
    the second equals its eager run."""
    cfg, mig, _ = configs(c)
    prob = problem(c["problem"])
    kw = dict(islands_per_shard=c["per"], max_epochs=c["epochs"], w2=True,
              return_stats=True, return_obs=True)

    def both():
        first = run_fused_sharded(group, prob, cfg, mig, rng=c["seed"],
                                  **kw)
        kept = convert.to_numpy(first[:4])
        second = run_fused_sharded(group, prob, cfg, mig,
                                   rng=c["seed"] + 1, **kw)
        same = all(np.array_equal(a, b) for a, b in zip(
            _leaves(convert.to_numpy(first[:4])), _leaves(kept)))
        return second, same

    (second, kept), captures = _emulated(both)
    eager = run_fused_sharded(group, prob, cfg, mig, rng=c["seed"] + 1,
                              **kw)
    out = {"got": _flat_fused(second), "want": _flat_fused(eager)}
    out["info"] = {"captures": captures, "first_kept": kept}
    return out


def _leaves(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


def _flat_fused(res):
    out = {}
    flat("islands", res[0], out)
    flat("pool", res[1], out)
    out["epochs"] = np.int64(int(res[2]))
    flat("stats", res[3], out)
    flat_obs(res[4], out)
    return out


def _two_groups(group, c):
    """Two groups of the same ranks never share a cached runner: each
    run captures its own, whose tail calls its own group."""
    from repro_torch.core import evolution
    from repro_torch.core.sharded import ShardGroup
    cfg, mig, _ = configs(c)
    prob = problem(c["problem"])
    other = ShardGroup.from_default(device=group.device)

    def run():
        res = []
        for g in (group, other):
            res.append(run_fused_sharded(
                g, prob, cfg, mig, islands_per_shard=c["per"],
                max_epochs=c["epochs"], rng=c["seed"], w2=True,
                return_stats=True, return_obs=True))
        keys = [k for k in evolution._FUSED_CACHE]
        groups = [k[1][-1] for k in keys]
        graphs = _rank_graphs()
        return res, (len(keys), groups[0] is group and groups[1] is other,
                     graphs[0] is not graphs[1],
                     other.calls > 0 and group.calls > 0)

    (res, facts), captures = _emulated(run)
    out = {"got": _flat_fused(res[1]), "want": _flat_fused(res[0])}
    out["info"] = {"captures": captures, "facts": facts}
    return out


def _resumed(group, c):
    """A graphed run with a snapshot every epoch, its newest snapshot
    dropped and resumed, against the graphed uninterrupted run."""
    def run():
        whole = snapshot(group, c)
        return whole, resume(group, dict(c, per2=c["per"]))
    (whole, back), captures = _emulated(run)
    return {"got": back, "want": whole,
            "info": {"captures": captures}}


def graph_cases(group, cases):
    """Every case run with CUDA graphs emulated and eagerly: name ->
    ``{"got": the graphed run's arrays, "want": the eager run's, "info":
    the captures and the case's facts}`` (a resume case: the resumed and
    the uninterrupted graphed runs; two groups: the second group's and
    the first's)."""
    special = {"two_runs": _two_runs, "two_groups": _two_groups,
               "resume": _resumed}
    out = {}
    for c in cases:
        if c["kind"] in special:
            out[c["name"]] = special[c["kind"]](group, c)
            continue
        got, captures = _emulated(lambda: run_driver(group, c))
        out[c["name"]] = {"got": got, "want": run_driver(group, c),
                          "info": {"captures": captures}}
    return out
