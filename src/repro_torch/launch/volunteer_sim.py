"""Volunteer-fleet simulation: churn, server failure, stragglers: the
paper's fault tolerance made executable, with the device islands on the
card.

    python -m repro_torch.launch.volunteer_sim               # sync demo
    python -m repro_torch.launch.volunteer_sim --runtime async \\
        --min-rate 0.25 --max-rate 1.0 --staleness 3 --churn 0.4
    python -m repro_torch.launch.volunteer_sim --runtime async \\
        --server http://127.0.0.1:8040    # join `python -m repro_torch.server`

and on the CPU the same with ``PYTHONPATH=src`` and ``--device cpu``.

Sync timeline (epoch-lockstep migration):
  epoch  3: the pool server DIES          (islands keep evolving standalone)
  epoch  6: the server comes back          (migration resumes, state intact)
  epoch  8: 4 volunteers JOIN              (seeded from the pool)
  epoch 12: 6 volunteers LEAVE             (their best work stays in the pool)

Async runtime (``--runtime async``, :mod:`repro_torch.core.async_migration`):
no epoch barrier. ``--min-rate``/``--max-rate`` draw each island's clock
rate from U[min, max] (a phone against a desktop); an island fires, one
autonomous epoch and an exchange, whenever its clock crosses 1.
``--staleness N`` keeps a parked immigrant absorbable for N ticks.
``--churn F`` gives that fraction of the islands a seeded down-window (a
closed tab that later rejoins). ``--topology`` and ``--acceptance`` (with
``--acceptance-epsilon``) pick the registered topology and immigrant
policy; the host PoolServer mirrors the policy.

In both modes a host PoolServer runs beside the device islands with two
browser-style PoolClient volunteers, which evaluate on the host CPU with
the plain version (``device="cpu"``), as browser tabs do; a HostBridge
(sync) or the non-blocking AsyncHostBridge (async: the server's I/O on a
worker thread, exactly-once delivery through the server's seq cursor)
splices them into the device islands' experiment. The sync demo also
runs a StragglerMonitor over simulated heterogeneous hardware.
``--trace PATH`` writes the host spans as Chrome trace JSON; ``--obs-json
PATH`` (async) carries the counter ledger and writes its harvest, which
``python -m repro_torch.obs PATH_TRACE --obs PATH`` reads.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import rand
from .._device import resolve_device
from ..core import (AcceptanceConfig, AsyncConfig, AsyncHostBridge, EAConfig,
                    HostBridge, MigrationConfig, PoolClient, PoolServer,
                    available_acceptance_policies, make_trap)
from ..core import async_migration, evolution
from ..core import island as island_lib
from ..core import pool as pool_lib
from ..obs import counters as obs_lib
from ..obs import trace as obs_trace
from ..runtime import StragglerMonitor, grow_islands, shrink_islands


def make_volunteers(server, problem, n=2, clients=None):
    volunteers = (clients if clients is not None
                  else [PoolClient(server, uuid=100 + i) for i in range(n)])
    vol_rng = np.random.default_rng(7)

    def volunteer_round():
        """Each volunteer hill-climbs a genome a little and PUTs it (a
        browser tab doing one autonomous epoch), scored on the host CPU."""
        for v in volunteers:
            got = v.get_random()
            g = (got[0].copy() if got is not None
                 else vol_rng.integers(0, 2, problem.genome.length)
                 .astype(np.int8))
            flip = vol_rng.integers(0, g.size, 4)
            g[flip] = 1  # volunteers push toward the all-ones optimum
            f = float(problem.evaluate(problem.consts,
                                       torch.from_numpy(g[None]))[0])
            v.put(g, f)

    return volunteers, volunteer_round


def run_sync(device=None):
    dev = resolve_device(device)
    problem = make_trap(n_traps=20, l=4)
    cfg = EAConfig(max_pop=128, min_pop=64, generations_per_epoch=50,
                   mutation_rate=1.0 / 80)
    mig = MigrationConfig(pool_capacity=64)
    rng = rand.key(0, device=dev)

    k, rng = rand.split(rng, 2)
    islands = island_lib.init_islands(k, 8, problem, cfg, device=dev)
    pool = pool_lib.pool_init(mig.pool_capacity, problem.genome, device=dev)
    mon = StragglerMonitor(threshold=2.0)

    # host side: a PoolServer, two volunteer clients and the bridge that
    # lets them join the device islands' experiment
    server = PoolServer(capacity=256, seed=1)
    volunteers, volunteer_round = make_volunteers(server, problem)
    bridge = HostBridge(server, every=1, pull=2)

    for e in range(1, 16):
        up = not (3 <= e < 6)
        if up:
            server.revive()
        else:
            server.kill()
        k, rng = rand.split(rng, 2)
        t0 = time.perf_counter()
        islands, pool = evolution.epoch_step(islands, pool, k, problem, cfg,
                                             mig, False, up, epoch=e)
        # sync first, so the server holds the device best before the
        # volunteers GET (a GET of an empty server reads as a lost XHR)
        pool = bridge.sync(pool, e)
        if up:
            volunteer_round()
        mon.record(0, time.perf_counter() - t0)

        if e == 8:
            k, rng = rand.split(rng, 2)
            islands = grow_islands(islands, 4, problem, cfg, pool, k)
            note = "+4 volunteers joined (pool-seeded)"
        elif e == 12:
            islands = shrink_islands(islands, 6)
            note = "-6 volunteers left (pool keeps their work)"
        else:
            note = ""
        best = float(islands.best_fitness.max())
        print(f"epoch {e:2d} [{'server UP ' if up else 'server DOWN'}] "
              f"islands={islands.pop.shape[0]:2d} best={best:5.1f}/40 "
              f"pool={int(pool.count):2d} bridge={bridge.stats()} {note}")
        if best >= 40.0:
            print("solution found — experiment over")
            break
    print(f"volunteer lost XHRs: "
          f"{[(v.uuid, v.lost_puts + v.lost_gets) for v in volunteers]}")

    # straggler demo: a simulated heterogeneous fleet
    print("\nstraggler mitigation (simulated heterogeneous volunteers):")
    mon2 = StragglerMonitor(threshold=1.5)
    speeds = {0: 1.0, 1: 1.1, 2: 0.9, 3: 4.0}   # worker 3 is a phone
    for _ in range(8):
        for w, s in speeds.items():
            mon2.record(w, s)
    for w in speeds:
        print(f"  worker {w}: work_scale={mon2.work_scale(w):.2f} "
              f"{'<- straggler: fewer generations/epoch' if w in mon2.stragglers() else ''}")


def run_async(args, device=None):
    """Heterogeneous clocks, seeded churn and a non-blocking host bridge,
    every island at its own pace."""
    dev = resolve_device(device)
    problem = make_trap(n_traps=20, l=4)
    cfg = EAConfig(max_pop=128, min_pop=64, generations_per_epoch=50,
                   mutation_rate=1.0 / 80)
    acc = AcceptanceConfig(policy=args.acceptance,
                           epsilon=args.acceptance_epsilon)
    mig = MigrationConfig(pool_capacity=64, topology=args.topology,
                          acceptance=acc)
    acfg = AsyncConfig(min_rate=args.min_rate, max_rate=args.max_rate,
                       staleness=args.staleness, churn_fraction=args.churn,
                       seed=args.seed)
    n, ticks = 8, args.ticks
    rng = rand.key(args.seed, device=dev)
    k_init, rng = rand.split(rng, 2)
    islands = island_lib.init_islands(k_init, n, problem, cfg, device=dev)
    pool = pool_lib.pool_init(mig.pool_capacity, problem.genome, device=dev)
    astate = async_migration.init_async_state(
        rand.fold_in(k_init, 7), n, acfg, ticks, problem.genome)
    print("volunteer speeds:", np.round(astate.rate.cpu().numpy(), 2))
    down = [(int(s), int(e)) for s, e in
            zip(astate.down_start.cpu().numpy(),
                astate.down_end.cpu().numpy())
            if int(s) <= ticks]
    print(f"churn windows (down..rejoin): {down or 'none'}")

    # the server mirrors the device acceptance policy (numpy host_accept)
    if args.server:
        # networked: every participant speaks the JSON wire protocol to a
        # running `python -m repro_torch.server`, each volunteer on its own
        # keep-alive connection (its own browser tab)
        from ..server import RemotePoolServer
        ensure = RemotePoolServer(args.server, experiment=args.experiment,
                                  client_id="volunteer-sim")
        ensure.create(capacity=256, seed=1,
                      acceptance=acc.policy, epsilon=acc.epsilon)
        server = ensure
        clients = [PoolClient(
            RemotePoolServer(args.server, experiment=args.experiment,
                             client_id=f"volunteer-{i}"), uuid=100 + i)
            for i in range(2)]
        volunteers, volunteer_round = make_volunteers(
            server, problem, clients=clients)
        bridge = AsyncHostBridge(args.server, pull=4, acceptance=acc,
                                 experiment=args.experiment,
                                 cursor_id="volunteer-sim-bridge")
    else:
        server = PoolServer(capacity=256, seed=1,
                            acceptance=acc if acc.policy != "always" else None)
        volunteers, volunteer_round = make_volunteers(server, problem)
        bridge = AsyncHostBridge(server, pull=4, acceptance=acc)

    obs = obs_lib.init_obs(n, device=dev) if args.obs_json else None
    t = 0
    for t in range(1, ticks + 1):
        k, rng = rand.split(rng, 2)
        with obs_trace.span("driver.tick", tick=t):
            out = async_migration.async_step(
                islands, pool, astate, k, problem, cfg, mig, acfg, False,
                tick=t, obs=obs)
            if obs is not None:
                islands, pool, astate, obs = out
            else:
                islands, pool, astate = out
        pool = bridge.sync(pool, t)     # non-blocking: never waits on server
        volunteer_round()
        fires = astate.fires.cpu().numpy()
        up_now = ~((astate.down_start.cpu().numpy() <= t)
                   & (t < astate.down_end.cpu().numpy()))
        best = float(islands.best_fitness.max())
        print(f"tick {t:2d} best={best:5.1f}/40 pool={int(pool.count):2d} "
              f"alive={int(up_now.sum())}/{n} fires/island={fires.tolist()} "
              f"bridge={bridge.stats()}")
        if best >= 40.0:
            print("solution found — experiment over")
            break
    pool = bridge.flush(pool)
    bridge.close()
    print(f"total island-epochs fired: {int(astate.fires.sum())} "
          f"of {n * max(t, 1)} synchronous equivalents; "
          f"bridge={bridge.stats()}")
    if obs is not None:
        harvest = obs_lib.harvest(obs)
        tot = harvest["totals"]
        balanced = tot["delivered"] == tot["accepted"] + tot["rejected"]
        with open(args.obs_json, "w") as fh:
            json.dump(harvest, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"obs ledger: fired={tot['fired']} "
              f"delivered={tot['delivered']} accepted={tot['accepted']} "
              f"rejected={tot['rejected']} churn_down={tot['churn_down']} "
              f"balanced={'OK' if balanced else 'BROKEN'} "
              f"-> {args.obs_json}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runtime", choices=("sync", "async"), default="sync")
    ap.add_argument("--min-rate", type=float, default=0.25)
    ap.add_argument("--max-rate", type=float, default=1.0)
    ap.add_argument("--staleness", type=int, default=3)
    ap.add_argument("--churn", type=float, default=0.4)
    ap.add_argument("--topology", default="pool")
    ap.add_argument("--acceptance", default="always",
                    choices=available_acceptance_policies())
    ap.add_argument("--acceptance-epsilon", type=float, default=0.0)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--server", default=None, metavar="URL",
                    help="async mode only: join a networked "
                         "`python -m repro_torch.server` service at URL over "
                         "the JSON wire protocol instead of an in-process "
                         "pool")
    ap.add_argument("--experiment", default="volunteer-sim",
                    help="experiment namespace on the networked server")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record host spans (bridge/pool/driver) and write "
                         "a Chrome trace-event JSON here")
    ap.add_argument("--obs-json", default=None, metavar="PATH",
                    help="async mode only: carry the counter ledger through "
                         "every tick and write its harvest here")
    ap.add_argument("--device", default=None,
                    help="the device islands' device: cuda (the default) "
                         "or cpu")
    args = ap.parse_args(argv)
    if args.server and args.runtime != "async":
        ap.error("--server requires --runtime async")
    if args.obs_json and args.runtime != "async":
        ap.error("--obs-json requires --runtime async")
    tracer = obs_trace.enable() if args.trace else None
    try:
        if args.runtime == "async":
            run_async(args, args.device)
        else:
            run_sync(args.device)
    finally:
        if tracer is not None:
            tracer.export_chrome(args.trace)
            print(f"wrote Chrome trace ({len(tracer.events())} events) "
                  f"-> {args.trace}")
            obs_trace.disable()


if __name__ == "__main__":
    main()
