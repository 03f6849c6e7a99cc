"""The train step on a (data, model) mesh: the port's 4 gloo ranks against
the reference's ``make_train_step`` jitted with its ``NamedSharding``s on
(2, 2) fake devices (``tests/test_dryrun_small.py``'s set-up, executed).

Both start from the reference's smoke ``Model.init(key(0))`` and its
AdamW state, and take 2 steps (constant lr 3e-3) on one seeded batch of
8 x 16 tokens. Archs: yi-9b (GQA heads over ``model``), olmoe-1b-7b
(expert parallelism), rwkv6-3b (the WKV heads over ``model``),
seamless-m4t-large-v2 (the encoder and the cross-attention) and
granite-34b (MQA, kv heads that do not split); beside them yi-9b under
``train_dp`` and granite-34b under FSDP (``fsdp_train`` forced on both
sides, in the test only).

Held: ce and gnorm of each step, and the parameters after the 2 steps
(the model-family tolerances, ROADMAP Queue C); each rank's blocks of the
parameters and of the first moment cover the slices of the reference's
addressable shard at the same mesh coordinate (by shape, and by value).
(The checkpoint written on one world and resumed on another:
``tests/test_torch_mesh_resume.py``.)
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

import _torch_mesh_harness as harness  # noqa: E402

B, T, LR, STEPS = 8, 16, 3e-3, 2
CASES = [("yi-9b", "train", False), ("olmoe-1b-7b", "train", False),
         ("rwkv6-3b", "train", False), ("seamless-m4t-large-v2", "train",
                                         False),
         ("granite-34b", "train", False), ("yi-9b", "train_dp", False),
         ("granite-34b", "train", True)]
# (ce rtol, gnorm rtol, parameter atol) after 2 steps (ROADMAP Queue C):
# AdamW's first steps move an element by about lr whatever its gradient's
# size, so a parameter whose gradient is near zero carries the sums'
# last-place differences up to lr's scale
TOL = {"rwkv6-3b": (1e-6, 2e-4, 1e-3)}
DEFAULT_TOL = (1e-6, 1e-6, 2e-4)


def name_of(arch, mode, fsdp):
    return f"{arch}-{mode}" + ("-fsdp" if fsdp else "")


def case(arch, mode, fsdp):
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.n_encoder_layers:
        batch["src_embed"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    return {"name": name_of(arch, mode, fsdp), "kind": "train", "W": 4,
            "arch": arch, "mesh": (2, 2), "mode": mode, "fsdp": fsdp,
            "init": True, "batch": batch, "lr": LR, "steps": STEPS}


@pytest.fixture(scope="module")
def results():
    cases = [case(*c) for c in CASES]
    with tempfile.TemporaryDirectory() as tmp:
        port, ref = harness.run_both(cases, tmp, devices=4, procs=2)
    return port[4], ref


def at_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("arch,mode,fsdp", CASES)
def test_train_step_matches_reference_on_2x2(results, arch, mode, fsdp):
    ranks, ref = results
    name = name_of(arch, mode, fsdp)
    want = ref[name]
    ce_tol, gnorm_tol, atol = TOL.get(arch, DEFAULT_TOL)
    model = build_model(get_config(arch, smoke=True), "meta")
    paths = model.param_paths()
    got = [r[name] for r in ranks]
    # every rank reports the same global metrics
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    for i, (g, w) in enumerate(zip(got[0]["metrics"], want["metrics"])):
        for k, tol in (("ce", ce_tol), ("grad_norm", gnorm_tol)):
            harness.assert_close(g[k], w[k], tol, 0.0, f"{name} step {i} {k}")
    # the parameters after the steps (rank 0's gathered copy)
    gathered = got[0]["global"]
    for key, leaf in harness_flat(want["params"]).items():
        harness.assert_close(at_path(gathered, key), leaf, 0.0, atol,
                             f"{name} {key}")
    # each rank's blocks are the reference's shards at its coordinate
    for kind, regions, local in (("param", "regions", "local"),
                                 ("moment", "opt_regions", "opt_local")):
        shards = want["param_shards" if kind == "param" else "opt_shards"]
        for r in got:
            for pname, (path, layer) in paths.items():
                key = harness.path_key(path)
                at = dict(shards[key])[r["coord"]]
                if layer is not None:
                    n_layers = np.asarray(at_path(want["params"],
                                                  path)).shape[0]
                    if at[0] != (0, n_layers):
                        # ZeRO-1 on the stacked layers dim: the port
                        # cuts the layer's own dims (shardings test)
                        assert kind == "moment", (name, pname, at)
                        continue
                    at = at[1:]
                assert tuple(r[regions][pname]) == tuple(at), \
                    (name, kind, pname, r["coord"], r[regions][pname], at)
                if kind == "param":
                    full = np.asarray(at_path(want["params"], path))
                    if layer is not None:
                        full = full[layer]
                    sl = tuple(slice(a, b) for a, b in at)
                    harness.assert_close(r[local][pname], full[sl], 0.0,
                                         atol, f"{name} {pname} {r['coord']}")


def harness_flat(tree, path=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(harness_flat(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(harness_flat(v, path + (i,)))
    else:
        out[path] = tree
    return out
