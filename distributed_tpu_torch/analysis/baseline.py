"""Allowlist/baseline file: intentional violations, each with a reason.

``graft-lint-torch-baseline.toml`` holds ``[[allow]]`` tables::

    [[allow]]
    rule = "swallowed-exceptions"
    path = "distributed_tpu_torch/worker/memory.py"
    symbol = "_set_status"          # optional: enclosing function / op
    contains = "batched_stream"     # optional: substring of the message
    reason = "pause announce must never fail; stream may not exist yet"

``rule``, ``path`` and a non-empty ``reason`` are mandatory; ``symbol`` /
``line`` / ``contains`` narrow the match.  Entries that match nothing are
reported as stale so the baseline can only shrink, never rot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING

import tomllib

if TYPE_CHECKING:
    from distributed_tpu_torch.analysis.core import Finding


@dataclass
class AllowEntry:
    rule: str
    path: str
    reason: str
    symbol: str = ""
    line: int = 0
    contains: str = ""
    used: bool = False

    def matches(self, finding: "Finding") -> bool:
        if self.rule != finding.rule:
            return False
        if self.path != finding.path:
            # (rule, qualname) beats path: a baselined finding whose
            # enclosing symbol moved file intact stays suppressed,
            # instead of double-reporting as one stale + one new
            # finding.  Entries without a symbol still pin their path.
            if not (self.symbol and self.symbol == finding.symbol):
                return False
        elif self.symbol and self.symbol != finding.symbol:
            return False
        if self.line and self.line != finding.line:
            return False
        if self.contains and self.contains not in finding.message:
            return False
        return True


@dataclass
class Baseline:
    entries: list[AllowEntry] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        self = cls()
        if not path.is_file():
            return self
        try:
            data = tomllib.loads(path.read_text())
        except tomllib.TOMLDecodeError as e:
            self.errors.append(f"{path.name}: {e}")
            return self
        for i, raw in enumerate(data.get("allow") or []):
            rule = str(raw.get("rule", ""))
            rel = str(raw.get("path", ""))
            reason = str(raw.get("reason", "")).strip()
            if not (rule and rel):
                self.errors.append(
                    f"{path.name}: allow[{i}] needs 'rule' and 'path'"
                )
                continue
            if not reason:
                # an unjustified allowlist entry is itself a finding: the
                # whole point is that every suppression argues its case
                self.errors.append(
                    f"{path.name}: allow[{i}] ({rule} @ {rel}) has no reason"
                )
                continue
            self.entries.append(AllowEntry(
                rule=rule, path=rel, reason=reason,
                symbol=str(raw.get("symbol", "")),
                line=int(raw.get("line", 0)),
                contains=str(raw.get("contains", "")),
            ))
        return self

    def allows(self, finding: "Finding") -> bool:
        hit = False
        for entry in self.entries:
            if entry.matches(finding):
                entry.used = True
                hit = True  # keep scanning: mark ALL matching entries used
        return hit

    def unused(self) -> list[str]:
        return [
            f"{e.rule} @ {e.path}" + (f" [{e.symbol}]" if e.symbol else "")
            for e in self.entries
            if not e.used
        ]

    def prune(self, path: Path) -> list[str]:
        """Rewrite ``path`` in place dropping entries whose ``used``
        flag is still False after a full lint run.  Live entries keep
        their original text verbatim — comments, key order, reasons.
        Returns the dropped-entry descriptions; raises ``ValueError``
        when the baseline has load errors (pruning would silently eat
        the malformed blocks)."""
        if self.errors:
            raise ValueError(
                "refusing to prune a baseline with errors: "
                + "; ".join(self.errors)
            )
        if not path.is_file():
            return []
        preamble, blocks = split_allow_blocks(path.read_text())
        if len(blocks) != len(self.entries):  # pragma: no cover - guard
            raise ValueError(
                f"baseline drifted since load: {len(blocks)} [[allow]] "
                f"blocks on disk vs {len(self.entries)} loaded entries"
            )
        kept = [b for b, e in zip(blocks, self.entries) if e.used]
        dropped = self.unused()
        if not dropped:
            return []
        text = preamble + "".join(kept)
        # a fully-pruned file keeps its preamble (doc header) only
        path.write_text(text if text.endswith("\n") or not text else text + "\n")
        return dropped


def split_allow_blocks(text: str) -> tuple[str, list[str]]:
    """Split baseline TOML into (preamble, one block per ``[[allow]]``
    table).  A block owns the comment lines immediately above its
    ``[[allow]]`` header (no blank line in between), so pruning keeps a
    live entry's rationale comments with it.  tomllib preserves array
    order, so block i corresponds to ``data["allow"][i]``."""
    lines = text.splitlines(keepends=True)
    starts = [
        i for i, ln in enumerate(lines) if ln.strip() == "[[allow]]"
    ]
    if not starts:
        return text, []
    # pull directly-attached comments into their block
    owned: list[int] = []
    for s in starts:
        j = s
        while j > 0 and lines[j - 1].strip().startswith("#"):
            j -= 1
        owned.append(j)
    preamble = "".join(lines[: owned[0]])
    blocks = []
    for k, start in enumerate(owned):
        end = owned[k + 1] if k + 1 < len(owned) else len(lines)
        blocks.append("".join(lines[start:end]))
    return preamble, blocks
