"""The harness of the mesh tests: the reference's subprocess, the port's
spawned worlds, and the comparisons.

The reference runs every case of a file in one subprocess on fake CPU
devices (``tests/_mesh_reference.py``), started first so it runs while
the port's worlds do; the port runs each world size's cases in one
spawned world of gloo ranks, one thread each
(``tests/_torch_mesh_ranks.py``). Cases are dicts with numpy payloads,
handed over by pickle.
"""
import concurrent.futures
import os
import pickle
import subprocess
import sys
import time

import numpy as np

from repro_torch.core.sharded import spawn

import _torch_mesh_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 180.0
REFERENCE_TIMEOUT = 400.0


def start_reference(cases, tmp, devices=4, tag="0"):
    spec = os.path.join(tmp, f"mesh_cases_{tag}.pkl")
    out = os.path.join(tmp, f"mesh_ref_{tag}.pkl")
    with open(spec, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_mesh_reference.py"),
         str(devices), spec, out], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
    with open(out, "rb") as f:
        return pickle.load(f)


def starting_points(handle):
    """The ``init`` cases' starting points, once the reference has written
    them (it goes on running)."""
    proc, out = handle
    deadline = time.monotonic() + REFERENCE_TIMEOUT
    while not os.path.exists(out + ".init"):
        if proc.poll() is not None or time.monotonic() > deadline:
            _, err = proc.communicate()
            raise AssertionError(f"the reference wrote no starting points:"
                                 f" {err[-4000:]}")
        time.sleep(0.1)
    with open(out + ".init", "rb") as f:
        return pickle.load(f)


def port_world(cases, W, tmp):
    """Every rank's results of the world-``W`` cases, in rank order. The
    cases go to the ranks in a file (a large argument of a spawned
    process is slow to hand over)."""
    path = os.path.join(tmp, f"port_cases_{W}.pkl")
    with open(path, "wb") as f:
        pickle.dump([c for c in cases if c.get("W") == W], f)
    return spawn(ranks.run_cases_file, W, "gloo", "cpu",
                 timeout=WORLD_TIMEOUT, args=(path,), threads=1)


def run_both(cases, tmp, devices=4, procs=1):
    """``(port, ref)``: the port's per-rank results by world size, and the
    reference's results by case name. A ``port_only`` case runs on the
    port alone (its starting point the ``init_from`` case's). The
    reference's cases are split
    over ``procs`` subprocesses; the port's worlds, one per world size and
    all at once, start once the ``init`` cases' starting points are
    written."""
    ref_cases = [c for c in cases if not c.get("port_only")]
    handles = [start_reference(ref_cases[i::procs], tmp, devices, str(i))
               for i in range(procs)]
    try:
        init = {}
        for h in handles:
            init.update(starting_points(h))
        port_cases = [dict(c, **init.get(c.get("init_from", c["name"]), {}))
                      for c in cases]
        worlds = sorted({c["W"] for c in port_cases if "W" in c})
        with concurrent.futures.ThreadPoolExecutor(len(worlds) or 1) as ex:
            runs = {W: ex.submit(port_world, port_cases, W, tmp)
                    for W in worlds}
            port = {W: f.result() for W, f in runs.items()}
    finally:
        ref = {}
        for h in handles:
            ref.update(reference_results(h))
    return port, ref


def path_key(path) -> str:
    return "/".join(str(p) for p in path)


def first_difference(got, want):
    """(index, got, want) of the largest difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    at = np.unravel_index(int(np.argmax(d)), d.shape) if d.size else ()
    return at, got[at] if d.size else got, want[at] if d.size else want


def assert_close(got, want, rtol, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        at, g, w = first_difference(got, want)
        raise AssertionError(f"{what}: at {at} port {g!r} reference {w!r} "
                             f"(rtol {rtol}, atol {atol})")
