"""Time the port's fitness kernels at the paper shapes, for one or more
checkouts of the repository, in turns.

    python scripts/torch_kernel_turns.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists); each is timed in a fresh process, in the order given, so two
versions of a kernel are compared on one card in one call (parent,
change, change, parent). A process builds that checkout's kernels, then
times with that checkout's ``chip_smoke.event_ms`` (CUDA events around 50
back-to-back calls after a spin) the trap kernel at (2048, 40 x 4), the
binary generation kernel at paper-8's (8, 256, 160) with fused trap, the
float one at paper-f15-8's (8, 256, 1000) with fused F15, and F15 at the
island batch (2048, 1000, m 50) and at Fig. 4's (10000, 1000, m 50), and
prints one line of microseconds per call with the card's name. Needs a
card.
"""
import importlib
import os
import subprocess
import sys


def time_checkout(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    from repro_torch import _build, convert
    from repro_torch.core.problems import default_f15_consts, make_f15
    from repro_torch.kernels.ga.common import GenerationSpec
    from repro_torch.kernels.rastrigin import f15 as f15_k
    from repro_torch.kernels.trap import trap as trap_k
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)

    def us(fn):
        return chip_smoke.event_ms(fn, 50) * 1e3

    consts = {"a": 1.0, "b": 2.0, "z": 3.0, "l": 4}
    pop = (torch.rand(2048, 160, generator=g) < 0.5).to(torch.int8).to(dev)
    out = {"trap 2048x40": us(lambda: trap_k.trap_fitness(consts, pop,
                                                          n_traps=40))}
    size = torch.full((8,), 200, dtype=torch.int32).to(dev)
    seed = torch.randint(0, 2**32, (8, 2), generator=g,
                         dtype=torch.int64).to(dev)
    fit = torch.randn(8, 256, generator=g).to(dev)
    bpop = (torch.rand(8, 256, 160, generator=g) < 0.5).to(torch.int8).to(dev)
    spec = GenerationSpec(
        kind="binary", length=160, elite=2, selection="tournament",
        tournament_k=2, crossover="two_point", crossover_rate=0.9,
        mutation_rate=1 / 160, mutation_sigma=0.3,
        fused_eval=(("a", 1.0), ("b", 2.0), ("eval", "trap"), ("l", 4),
                    ("z", 3.0)))
    out["generation 8x256x160 trap"] = us(
        lambda: gen_k.generation_kernel(seed, size, bpop, fit, spec))
    prob = make_f15(device=dev)
    fpop = (torch.rand(8, 256, 1000, generator=g) * 10 - 5).to(dev)
    fspec = GenerationSpec(
        kind="float", length=1000, elite=2, selection="tournament",
        tournament_k=2, crossover="blend", crossover_rate=0.9,
        mutation_rate=1 / 1000, mutation_sigma=0.3, low=-5.0, high=5.0,
        fused_eval=tuple(sorted(prob.fused.items())))
    out["generation_float 8x256x1000 f15"] = us(
        lambda: gen_k.generation_kernel(seed, size, fpop, fit, fspec,
                                        prob.consts))
    c = convert.f15_consts_from_numpy(default_f15_consts(), dev)
    x = (torch.rand(2048, 1000, generator=g) * 10 - 5).to(dev)
    x4 = (torch.rand(10000, 1000, generator=g) * 10 - 5).to(dev)
    out["f15 2048x1000"] = us(lambda: f15_k.f15(c, x))
    out["f15 10000x1000"] = us(lambda: f15_k.f15(c, x4))
    return {"card": torch.cuda.get_device_name(0),
            **{k: round(v, 3) for k, v in out.items()}}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(time_checkout(os.path.abspath(argv[1])), flush=True)
        return 0
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-2000:])
            return proc.returncode
        print(f"{root}: {proc.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
