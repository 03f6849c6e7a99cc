"""Finding dataclass, inline pragmas, and the committed baseline.

A :class:`Finding` is one rule violation at one source line.  Two
suppression channels exist, both requiring a human-written reason:

* inline pragma — ``# repro-lint: disable=RULE1,RULE2  -- reason`` on the
  offending line, or on its own line immediately above it;
* baseline — a committed ``analysis_baseline_torch.json`` of
  ``{rule, path, line, snippet, justification}`` entries.  An entry
  matches a finding when rule + path agree and the *snippet* (the
  stripped source line) still matches the code at the finding — so the
  baseline survives unrelated line drift but goes stale (and is reported
  unused) when the code it excuses is gone.

The pragma syntax and the baseline schema are those of the JAX
package's analyzer, so one pragma serves both analyzers on a port file.
A pragma that this analyzer no longer needs (one that only the JAX
package's rules read) is not reported: nothing here counts pragmas that
suppressed nothing.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(.*?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source line."""

    rule_id: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str
    suppressible: bool = True

    def format(self, style: str = "text") -> str:
        if style == "github":
            return (f"::error file={self.path},line={self.line},"
                    f"title={self.rule_id}::{self.message}")
        return f"{self.path}:{self.line}: {self.rule_id} {self.message}"


def parse_pragmas(lines: Sequence[str], path: str,
                  ) -> Tuple[Dict[int, set], List[Finding]]:
    """Scan source lines for suppression pragmas.

    Returns ``(suppressions, findings)``: ``suppressions`` maps a 1-based
    line number to the set of rule ids disabled there (a pragma on its own
    line also covers the next line, so it can sit above the offending
    statement); ``findings`` carries an LNT01 for every pragma missing its
    ``-- reason`` justification.
    """
    sup: Dict[int, set] = {}
    bad: List[Finding] = []
    for i, raw in enumerate(lines, start=1):
        m = PRAGMA_RE.search(raw)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        if not reason:
            bad.append(Finding(
                "LNT01", path, i,
                "repro-lint pragma missing its '-- reason' justification",
                suppressible=False))
            continue
        sup.setdefault(i, set()).update(rules)
        if raw.split("#", 1)[0].strip() == "":
            # pragma-only line: also covers the statement below it
            sup.setdefault(i + 1, set()).update(rules)
    return sup, bad


class Baseline:
    """The committed suppression file.

    Every entry must carry a non-empty ``justification`` string; entries
    are one-shot (an entry suppresses at most one finding per run) so a
    *new* instance of an already-baselined bug class still fails the gate.
    """

    def __init__(self, entries: Optional[List[dict]] = None,
                 path: Optional[str] = None):
        self.path = path
        self.entries = entries or []
        self._used = [False] * len(self.entries)
        for e in self.entries:
            missing = {"rule", "path", "snippet"} - set(e)
            if missing:
                raise ValueError(
                    f"baseline entry {e!r} missing keys {sorted(missing)}")
            if not str(e.get("justification", "")).strip():
                raise ValueError(
                    f"baseline entry for {e['rule']} at {e['path']} has no "
                    f"justification — every suppression must say why")

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as fh:
            doc = json.load(fh)
        return cls(doc.get("entries", []), path=path)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({"version": 1, "entries": self.entries}, fh, indent=2)
            fh.write("\n")

    def matches(self, finding: Finding, snippet: str) -> bool:
        """Consume (at most once) an entry covering ``finding``.

        ``snippet`` is the stripped source text at the finding's line; an
        entry matches on (rule, path, snippet) — the recorded line number
        is advisory so pure line drift doesn't invalidate the baseline.
        """
        best = None
        for i, e in enumerate(self.entries):
            if self._used[i] or e["rule"] != finding.rule_id \
                    or e["path"] != finding.path:
                continue
            if e["snippet"].strip() != snippet.strip():
                continue
            if best is None or e.get("line") == finding.line:
                best = i
            if e.get("line") == finding.line:
                break
        if best is None:
            return False
        self._used[best] = True
        return True

    def unused(self) -> List[dict]:
        return [e for i, e in enumerate(self.entries) if not self._used[i]]
