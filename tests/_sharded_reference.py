"""The reference's side of the sharded tests, run as a script:

    python tests/_sharded_reference.py CASES.json OUT.npz

Four fake CPU devices (``XLA_FLAGS`` is set before jax is imported); a
case of world size W runs on a mesh of the first W of them. Each case's
results are flattened to ``"{case}::{field}"`` arrays in OUT.npz (keys as
int64 words), in the layout ``tests/_torch_sharded_ranks.py`` gives the
port's. The cases are described in ``tests/_sharded_harness.py``.
"""
import contextlib
import io
import json
import os
import shutil
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)

from repro.compat import shard_map  # noqa: E402
from repro.core import (AcceptanceConfig, AsyncConfig, EAConfig,  # noqa: E402
                        HostBridge, MigrationConfig, PoolServer, make_onemax,
                        make_trap, migration)
from repro.core import pool as pool_lib  # noqa: E402
from repro.core.sharded import (run_fused_sharded,  # noqa: E402
                                run_fused_sharded_async, run_sharded)
from repro.core.types import GenomeSpec, PoolState  # noqa: E402
from repro.launch import evolve  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402

AX = "islands"


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


def arr(x):
    if hasattr(x, "dtype") and jax.dtypes.issubdtype(x.dtype,
                                                     jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x)).astype(np.int64)
    return np.asarray(x)


def flat(prefix, tree, out):
    for f, v in zip(tree._fields, tree):
        out[f"{prefix}.{f}"] = arr(v)


def flat_obs(h, out):
    for k, v in h.items():
        if k != "totals":
            out[f"obs.{k}"] = np.asarray(v)


def migrate_inputs(c):
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
    return jnp.asarray(g), jnp.asarray(f), gen


def run_migrate(c, mesh):
    _, mig, _ = configs(dict(c, cfg={}))
    g, f, gen = migrate_inputs(c)
    avail = c.get("available", True)
    vec = isinstance(avail, list)

    def body(pool, bg, bf, rng, av):
        pool, ig, if_, dl, ac = migration.migrate(
            pool, bg, bf, rng, mig, axis=AX, epoch=c.get("epoch", 0),
            available=av if vec else avail, with_ledger=True)
        return jax.tree.map(lambda x: x[None], pool), ig, if_, dl, ac

    stacked = PoolState(*[P(AX)] * len(PoolState._fields))
    fn = shard_map(body, mesh=mesh,
                   in_specs=(PoolState(*[P()] * 4), P(AX), P(AX), P(),
                             P(AX)),
                   out_specs=(stacked, P(AX), P(AX), P(AX), P(AX)),
                   check=False)
    pool0 = pool_lib.pool_init(mig.pool_capacity, gen)
    if c.get("prefill"):
        pool0 = pool_lib.pool_put_batch(pool0, g[:3] * 0 + 1, f[:3] + 0.5)
    av = jnp.asarray(avail if vec else [True] * g.shape[0])
    # jitted, as the drivers' steps are (an eager shard_map takes seconds)
    pools, ig, if_, dl, ac = jax.jit(fn)(pool0, g, f,
                                         jax.random.key(c["seed"]), av)
    out = {}
    flat("pools", pools, out)
    out["imm_g"], out["imm_f"] = arr(ig), arr(if_)
    out["delivered"], out["accepted"] = arr(dl), arr(ac)
    return out


def run_driver(c, mesh):
    cfg, mig, acfg = configs(c)
    prob = problem(c["problem"])
    kw = dict(islands_per_shard=c["per"], rng=jax.random.key(c["seed"]),
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
        isl, pool, ep = run_sharded(mesh, prob, cfg, mig,
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
            mesh, prob, cfg, mig, max_epochs=c["epochs"],
            return_stats=c.get("stats", False),
            return_obs=c.get("obs", False), **kw))
    else:
        res = list(run_fused_sharded_async(
            mesh, prob, cfg, mig, acfg, max_ticks=c["epochs"],
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


def run_resume(c, meshes):
    """A run of world W with snapshots, then a resume at world W2 from it
    (the newest snapshot dropped first when ``drop``)."""
    cfg, mig, acfg = configs(c)
    prob = problem(c["problem"])
    d = c["dir"]
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(rng=jax.random.key(c["seed"]), return_stats=True,
              snapshot_every=c["every"], snapshot_dir=d)
    if acfg is None:
        def run(mesh, per, **more):
            return run_fused_sharded(mesh, prob, cfg, mig,
                                     islands_per_shard=per,
                                     max_epochs=c["epochs"], **kw, **more)
    else:
        def run(mesh, per, **more):
            return run_fused_sharded_async(mesh, prob, cfg, mig, acfg,
                                           islands_per_shard=per,
                                           max_ticks=c["epochs"], **kw,
                                           **more)
    run(meshes[c["W"]], c["per"])
    if c.get("drop"):
        steps = sorted(s for s in os.listdir(d) if s.startswith("step_"))
        shutil.rmtree(os.path.join(d, steps[-1]))
    isl, pool, ep, stats = run(meshes[c["W2"]], c["per2"], resume=True)
    out = {}
    flat("islands", isl, out)
    flat("pool", pool, out)
    out["epochs"] = np.int64(int(ep))
    flat("stats", stats, out)
    shutil.rmtree(d, ignore_errors=True)
    return out


def run_ea(c, meshes):
    evolve.make_host_mesh = lambda: meshes[c["W"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evolve.main(c["argv"])
    return {"lines": np.array(buf.getvalue().splitlines())}


def main():
    cases = json.load(open(sys.argv[1]))
    meshes = {w: make_host_mesh(w) for w in (1, 2, 4)}
    out = {}
    for c in cases:
        kind = c["kind"]
        if kind == "migrate":
            res = run_migrate(c, meshes[c["W"]])
        elif kind == "resume":
            res = run_resume(c, meshes)
        elif kind == "ea":
            res = run_ea(c, meshes)
        else:
            res = run_driver(c, meshes[c["W"]])
        for k, v in res.items():
            out[f"{c['name']}::{k}"] = v
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
