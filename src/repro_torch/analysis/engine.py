"""Run the passes over a file set and apply both suppression channels.

The engine owns file discovery, pass orchestration, pragma suppression
and baseline consumption; the CLI in ``__main__`` is a thin shell over
:func:`analyze_paths`. It is the JAX package's engine, over the port's
passes.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from .findings import Baseline, Finding, parse_pragmas
from .symbols import ModuleInfo, Project
from .passes import donation, locks, obs, purity, registry, rng

#: (name, runner) in report order.  Each runner takes a Project and
#: returns a list of Findings.
ALL_PASSES: List[Tuple[str, object]] = [
    ("rng", rng.run),
    ("locks", locks.run),
    ("purity", purity.run),
    ("registry", registry.run),
    ("donation", donation.run),
    ("obs", obs.run),
]

SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build",
             "dist", ".mypy_cache", ".pytest_cache"}


def collect_python_files(paths: List[str], root: Optional[str] = None,
                         ) -> List[Tuple[str, str]]:
    """Expand files/directories into ``(abs_path, repo_relative)`` pairs.

    ``root`` anchors the relative paths (defaults to the CWD) so findings
    and baseline entries are stable regardless of how the CLI was
    invoked.
    """
    root = os.path.abspath(root or os.getcwd())
    out: List[Tuple[str, str]] = []
    seen = set()

    def add(abs_path: str) -> None:
        abs_path = os.path.abspath(abs_path)
        if abs_path in seen or not abs_path.endswith(".py"):
            return
        seen.add(abs_path)
        rel = os.path.relpath(abs_path, root).replace(os.sep, "/")
        out.append((abs_path, rel))

    for p in paths:
        if os.path.isfile(p):
            add(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in SKIP_DIRS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                add(os.path.join(dirpath, fn))
    out.sort(key=lambda pair: pair[1])
    return out


def _snippet(module: ModuleInfo, line: int) -> str:
    if 1 <= line <= len(module.lines):
        return module.lines[line - 1].strip()
    return ""


def analyze_paths(paths: List[str], root: Optional[str] = None,
                  baseline: Optional[Baseline] = None,
                  ) -> Dict[str, List[Finding]]:
    """Run every pass and split the results by suppression outcome.

    Returns ``{"active": [...], "suppressed": [...], "errors": [...]}``;
    ``errors`` holds LNT00 parse failures and LNT01 reasonless pragmas
    (never suppressible).  ``baseline.unused()`` is valid afterwards.
    """
    files = collect_python_files(paths, root=root)
    errors: List[Finding] = []
    modules: List[ModuleInfo] = []
    for abs_path, rel in files:
        try:
            with open(abs_path, encoding="utf-8") as fh:
                source = fh.read()
            modules.append(ModuleInfo(abs_path, rel, source))
        except (SyntaxError, UnicodeDecodeError) as exc:
            lineno = getattr(exc, "lineno", 1) or 1
            errors.append(Finding(
                "LNT00", rel, lineno,
                f"file does not parse: {exc.__class__.__name__}: {exc}",
                suppressible=False))
    project = Project(modules)
    by_path = {m.relpath: m for m in modules}

    # pragma tables + LNT01 per module
    pragmas: Dict[str, Dict[int, set]] = {}
    for m in modules:
        sup, bad = parse_pragmas(m.lines, m.relpath)
        pragmas[m.relpath] = sup
        errors.extend(bad)

    raw: List[Finding] = []
    for _, runner in ALL_PASSES:
        raw.extend(runner(project))
    raw.sort(key=lambda f: (f.path, f.line, f.rule_id))

    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        if f.suppressible:
            rules = pragmas.get(f.path, {}).get(f.line, set())
            if f.rule_id in rules:
                suppressed.append(f)
                continue
            if baseline is not None:
                m = by_path.get(f.path)
                snip = _snippet(m, f.line) if m else ""
                if baseline.matches(f, snip):
                    suppressed.append(f)
                    continue
        active.append(f)
    return {"active": active, "suppressed": suppressed, "errors": errors}
