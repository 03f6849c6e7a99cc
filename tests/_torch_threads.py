"""One intra-op and one inter-op CPU thread for the port's tests.

``pytest -n 6`` runs six test processes at once; at torch's default of a
thread per core each, their threads fight over the cores. Every
``tests/test_torch_*.py`` imports this module first. The inter-op count can
be set only before any parallel work has run, so a second setting (this
module imported after such work) leaves it as it is. Subprocesses and
spawned ranks of the tests get the same setting through
``OMP_NUM_THREADS=1`` in their environment or ``spawn(threads=1)``.
"""
try:
    import torch
except ImportError:     # the pinned CI has no torch: the tests skip
    torch = None

if torch is not None:
    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:
        # parallel work has already run in this process; the count stays
        pass
