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

The names below load their modules at first use (PEP 562), so the
stdlib-only parts (:mod:`repro_torch.obs.trace`, ``.metrics``, the
timeline tool, :mod:`repro_torch.server`'s wire and client) import
without torch.
"""
_EXPORTS = {
    "rand": ("repro_torch.rand", None),
    **{name: ("repro_torch.core", name) for name in (
        "EAConfig", "MigrationConfig", "make_f15", "make_onemax",
        "make_rastrigin", "make_royal_road", "make_sphere", "make_trap",
        "run_fused")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    import importlib
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    mod = importlib.import_module(module)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value   # cache for the next lookup
    return value


def __dir__():
    return __all__
