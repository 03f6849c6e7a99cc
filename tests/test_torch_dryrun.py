"""The port's dry run (``python -m repro_torch.launch.dryrun``) on a small
mesh: one process posing as rank 0 of a ``fake`` group of 8, a (2, 4)
mesh, the four archs of ``tests/test_dryrun_small.py`` (smoke configs) at
a train cell of 8 x 32 tokens, each run once on fake tensors.

Held: FLOPs above 0 and collective bytes above 0 (sharded training
communicates); the per-rank argument bytes equal the reference's, the sum
of ``NamedSharding.shard_shape`` bytes of its train state and batch for
the same cell (computed without compiling, 8 fake devices); and a smoke
prefill's temporary bytes grow linearly, not with S squared, from S 512
to 1024: the flash-attention kernel is a custom op whose fake
implementation allocates its output alone (the plain version would hold
a (B, H, S, S) score matrix). A train step of 4 microbatches traced at
2 and 3 and extrapolated reads the FLOPs and collective bytes of the
step traced whole (``--exact``). Beside them each shim of
``repro_torch.compat`` runs on this torch (a fake group of 4, an
``all_gather_single`` under ``FakeTensorMode``, a FLOP count).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import glob
import json
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_harness as harness  # noqa: E402

ARCHS = ["yi-9b", "olmoe-1b-7b", "rwkv6-3b", "seamless-m4t-large-v2"]
# each shim of repro_torch.compat on this torch, in a process of its own
# (the fake group is its default group)
COMPAT = """
import json
import torch
import torch.distributed as dist
from repro_torch import compat
dist.init_process_group("fake", store=compat.fake_store(), rank=1,
                        world_size=4)
counter, register = compat.flop_counter()
with compat.fake_tensor_mode():
    x = torch.empty(3, 5)
    out = torch.empty(12, 5)
    compat.all_gather_single(out, x)
    with counter(display=False) as c:
        torch.empty(8, 16) @ torch.empty(16, 4)
print(json.dumps({"gathered": list(out.shape), "flops": c.get_total_flops(),
                  "register": callable(register)}))
"""
B, S = 8, 32


def _dryrun(out, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(harness.REPO, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "2x4",
         "--smoke", "--out", out, *args], env=env, cwd=harness.REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _records(out):
    recs = {}
    for path in glob.glob(os.path.join(out, "*.json")):
        with open(path) as f:
            rec = json.load(f)
        recs[rec["arch"], rec["shape"]] = rec
    return recs


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        ref = harness.start_reference(
            [{"name": a, "kind": "shard_bytes", "arch": a, "mesh": (2, 4),
              "batch": B, "seq": S} for a in ARCHS], tmp, devices=8)
        runs = {"train": _dryrun(os.path.join(tmp, "train"), "--archs",
                                 ",".join(ARCHS), "--shapes", "train_4k",
                                 "--batch", str(B), "--seq", str(S),
                                 "--accum", "1")}
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.join(harness.REPO, "src"))
        shims = subprocess.Popen([sys.executable, "-c", COMPAT], env=env,
                                 cwd=harness.REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        # a train step of 4 microbatches: traced at 2 and 3 and
        # extrapolated, and traced whole (--exact)
        for tag in ("", "--exact"):
            runs["accum" + tag] = _dryrun(
                os.path.join(tmp, "accum" + tag), "--archs",
                "yi-9b,olmoe-1b-7b", "--shapes", "train_4k", "--batch",
                str(2 * B), "--seq", str(S), "--accum", "4",
                *([tag] if tag else []))
        for seq in (512, 1024):
            runs[seq] = _dryrun(os.path.join(tmp, str(seq)), "--archs",
                                "yi-9b", "--shapes", "prefill_32k",
                                "--batch", str(B), "--seq", str(seq))
        out = {}
        for key, proc in runs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (stdout + stderr)[-4000:]
            out[key] = _records(os.path.join(tmp, str(key)))
        out["ref"] = harness.reference_results(ref)
        stdout, stderr = shims.communicate(timeout=300)
        assert shims.returncode == 0, stderr[-4000:]
        out["compat"] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_train_cell_on_8_fake_ranks(results, arch):
    rec = results["train"][arch, "train_4k"]
    assert rec["supported"] and rec["mesh"] == "2x4"
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert 0 < rec["temp_bytes"] < 2 * 2 ** 30          # smoke stays tiny
    assert rec["argument_bytes"] == \
        results["ref"][arch]["argument_bytes"], arch


def test_compat_shims_run_on_this_torch(results):
    assert results["compat"] == {"gathered": [12, 5], "flops": 2 * 8 * 16 * 4,
                                 "register": True}


def test_prefill_temp_bytes_are_not_quadratic(results):
    short = results[512]["yi-9b", "prefill_32k"]
    long = results[1024]["yi-9b", "prefill_32k"]
    assert long["temp_bytes"] < 2.5 * short["temp_bytes"]
    # the attention's work is the flash kernel's formula: quadratic
    assert long["flops_per_device"] > 2.5 * short["flops_per_device"]


def test_f32_product_route_is_a_version_check():
    """``compat.MM_OUT_DTYPE`` is torch 2.8's ``mm(..., out_dtype=)``,
    decided by the version (no probe); the CPU always casts the operands
    to f32, and ``partition.f32_product`` there is that product, bit for
    bit."""
    from repro_torch import compat
    from repro_torch.launch import partition
    assert compat.MM_OUT_DTYPE == (compat.torch_version() >= (2, 8) and
                                   hasattr(torch.ops.aten.mm, "dtype"))
    assert compat.f32_product_route("cpu") == "f32 operands"
    want = "mm out_dtype" if compat.MM_OUT_DTYPE else "f32 operands"
    assert compat.f32_product_route("cuda") == want
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 64, generator=gen).bfloat16()
    w = torch.randn(64, 8, generator=gen).bfloat16()
    got = partition.f32_product(x, w)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 8)
    assert torch.equal(got, (x.float().reshape(6, 64) @ w.float()
                             ).reshape(2, 3, 8))


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_extrapolated_microbatches_equal_the_traced_step(results, arch):
    """4 microbatches a rank traced at 2 and 3 give the FLOPs and every
    collective's bytes of the step traced whole, exactly; the peak is the
    same but for the per-microbatch metric scalars."""
    got = results["accum"][arch, "train_4k"]
    want = results["accum--exact"][arch, "train_4k"]
    assert got["accum_traced"] == [2, 3] and want["accum_traced"] == [4]
    assert got["flops_per_device"] == want["flops_per_device"] > 0
    assert got["collective_bytes_per_device"] == \
        want["collective_bytes_per_device"]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert abs(got["temp_bytes"] - want["temp_bytes"]) <= 1024
