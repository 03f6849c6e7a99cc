"""Serving on a mesh under the ``serve`` rules: the port's prefill and 3
decode steps on gloo ranks, (1, 2) and (2, 2), against the reference's
single-device ``prefill`` and ``decode`` (jitted) of the same weights
(``Model.init(key(0))``) on the same prompt.

Cases (smoke configs): yi-9b (the kv heads over ``model``), granite-34b
(one kv head: the cache's slots over ``model``, each rank's partial
softmax merged in rank order), hymba-1.5b widened to 5 heads of 16 (the
heads do not divide ``model``, so the weights are stored cut inside a
head and gathered; windowed caches with meta tokens), and
seamless-m4t-large-v2 (the encoder and the cross caches over the kv
heads). Held: every rank's rows of the last-position logits of the
prefill and of each decode step (f32, ROADMAP Queue C).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402

import _torch_mesh_harness as harness  # noqa: E402

B, T, NEW = 4, 13, 3
ARCHS = [("yi-9b", None), ("granite-34b", None),
         ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5, "d_model": 80}),
         ("seamless-m4t-large-v2", None)]
MESHES = [(1, 2), (2, 2)]
RTOL, ATOL = 1e-5, 1e-5


def name_of(arch, mesh):
    return f"{arch}-{mesh[0]}x{mesh[1]}"


def case(arch, over, mesh):
    cfg = get_config(arch, smoke=True)
    if over:
        cfg = cfg.reduced(**over)
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T),
                                    dtype=np.int32)}
    if cfg.n_encoder_layers:
        batch["src_embed"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab_size, (B, NEW), dtype=np.int32)
    c = {"name": name_of(arch, mesh), "kind": "serve",
         "W": mesh[0] * mesh[1], "arch": arch, "over": over, "mesh": mesh,
         "init": True, "batch": batch, "next": nxt}
    if mesh != MESHES[0]:
        # the reference's single-device run is the first mesh's case
        c.update(port_only=True, init_from=name_of(arch, MESHES[0]))
    return c


@pytest.fixture(scope="module")
def results():
    cases = [case(a, o, m) for a, o in ARCHS for m in MESHES]
    with tempfile.TemporaryDirectory() as tmp:
        return harness.run_both(cases, tmp, devices=1, procs=2)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,over", ARCHS, ids=[a for a, _ in ARCHS])
def test_serve_matches_single_device_reference(results, arch, over, mesh):
    port, ref = results
    name = name_of(arch, mesh)
    want = ref[name_of(arch, MESHES[0])]["logits"]
    ranks = [r[name] for r in port[mesh[0] * mesh[1]]]
    rows = B // mesh[0]
    for r in ranks:
        d = r["coord"][0]
        assert len(r["logits"]) == NEW + 1
        for i, (g, w) in enumerate(zip(r["logits"], want)):
            harness.assert_close(g, w[d * rows:(d + 1) * rows], RTOL, ATOL,
                                 f"{name} rank {r['coord']} step {i}")
    # the ranks of one data shard agree bit for bit
    for a in ranks:
        for b in ranks:
            if a["coord"][0] == b["coord"][0]:
                for x, y in zip(a["logits"], b["logits"]):
                    assert np.array_equal(x, y)
