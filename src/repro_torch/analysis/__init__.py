"""repro-lint for the PyTorch port: the AST invariant analyzer of the
JAX package (``repro.analysis``), retargeted at the port's own idioms.

The same stdlib-``ast`` pass framework, rule IDs, pragma syntax, baseline
schema and CLI as the JAX package's analyzer. Each rule that names a JAX
idiom is retargeted at the idiom the port uses in its place; the module
of each pass says how. It imports neither ``torch`` nor the JAX package:
it is static, and keeps its own copy of everything it needs.

======  =====================================================================
rule    invariant
======  =====================================================================
RNG01   :mod:`repro_torch.rand` key discipline — one key, one sink
        (``rand.split``, a ``keyed_*`` sampler, any other callee;
        ``fold_in``/``key``/``key_data``/``.clone()`` derive). A key
        consumed by two sinks without an intervening re-bind, or bound
        outside a loop and consumed inside it, breaks replica determinism
        and the kernels' counter RNG.
RNG02   no wall-clock / global-RNG nondeterminism (``time.time``,
        ``random.*`` module state, unseeded ``np.random.*``, torch's
        global RNG: samplers without ``generator=``, ``torch.manual_seed``,
        an unseeded ``torch.Generator()``) in the seeded roots (core/,
        kernels/, benchmarks/, models/, data/, optim/).
LCK01   lock discipline — an attribute ever written under ``with
        self._lock`` must never be read or written outside it.
LCK02   the same for ``asyncio`` locks under ``async with``.
PAL01   kernel-wrapper purity — no prints, host I/O, ``np.*`` math,
        global/nonlocal mutation or host syncs (``.item()``/``.tolist()``/
        ``.cpu()``/``.numpy()``, ``int()``/``float()``/``bool()`` of a
        parameter) in a function that launches through
        ``_build.library()``, in the plain version its wrapper runs for a
        CPU tensor, or in anything they call.
JIT01   traced-code purity — the same side-effect markers in
        ``torch.library.custom_op`` bodies and fakes, ``autograd.Function``
        ``forward``/``backward``, and code run under
        ``torch.cuda.graph`` capture, ``make_graphed_callables`` or
        ``torch.compile``.
REG01   registry contracts — every kernel / topology / acceptance
        registration (decorator, ``register_kernel(...)(fn)`` or
        ``KERNELS.update({...})``) matches its protocol signature.
REG02   registry completeness — the (op x genome_kind x impl) kernel
        matrix and the acceptance host-mirror set have no silent holes.
REG03   acceptance dispatch — every pool insert site threads an
        acceptance policy (``acc=``/``acceptance=``).
DON01   consumed-state discipline — an argument that a callable updates
        in place (the train step's state, AdamW's state and parameters,
        the decode step's caches) is never read after the call without
        a re-bind.
OBS01   no wall-clock ``time.time()`` differenced into a duration.
LNT01   lint hygiene — a ``# repro-lint: disable=`` pragma must carry a
        ``-- reason`` justification (unsuppressible).
======  =====================================================================

Suppression: inline ``# repro-lint: disable=RULE  -- reason`` pragmas (on
the offending line or the line above), or a committed
``analysis_baseline_torch.json`` whose entries each carry a one-line
justification. :mod:`.snapshot` pins the fused drivers' loop carries to
``ExperimentState``. CLI: ``python -m repro_torch.analysis [--format
text|github] [--baseline PATH|none] [--root R] [--selfcheck] paths...``
— exits nonzero on any non-baselined finding.
"""
from .findings import Baseline, Finding, parse_pragmas
from .engine import ALL_PASSES, analyze_paths, collect_python_files
from .symbols import ModuleInfo, Project

__all__ = [
    "ALL_PASSES",
    "Baseline",
    "Finding",
    "ModuleInfo",
    "Project",
    "analyze_paths",
    "collect_python_files",
    "parse_pragmas",
]
