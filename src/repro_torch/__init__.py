"""PyTorch/CUDA port of the NodIO island model and of its model land.

A second package beside the JAX reference ``repro``: the same layout
(``core/``, ``kernels/ga/``, ``kernels/trap/``, ``kernels/rastrigin/``,
``kernels/rwkv6/``, ``models/``, ``configs/``, ``launch/``) and public
names, written as PyTorch, with the reference's Pallas kernels
rewritten by hand in CUDA C++ for Hopper (``kernels/*/csrc``, built at
first use by :mod:`repro_torch._build`). Each kernel has a plain PyTorch version beside
it, which its wrapper runs for CPU tensors.

Entry points (:func:`repro_torch.core.run_fused`,
:func:`repro_torch.core.island.init_islands`,
:class:`repro_torch.models.Model`, :func:`repro_torch.launch.serve.serve`)
run on the card unless the
caller passes ``device="cpu"``, and raise when there is no card. The port
imports neither JAX nor the reference package.
"""
from . import rand
from .core import EAConfig, MigrationConfig, make_f15, make_onemax
from .core import make_rastrigin, make_royal_road, make_sphere, make_trap
from .core import run_fused

__all__ = ["EAConfig", "MigrationConfig", "make_f15", "make_onemax",
           "make_rastrigin", "make_royal_road", "make_sphere", "make_trap",
           "rand", "run_fused"]
