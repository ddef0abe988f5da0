"""Lint engine: rule registry, file scoping, pragma/baseline filtering.

A rule is a class with a ``name``, a ``description``, a tuple of default
``scope`` globs, and a ``run(ctx)`` generator of :class:`Finding`.  Rules
register themselves via :func:`register`; the engine hands each rule a
:class:`LintContext` through which it pulls the parsed modules in its
(config-overridable) scope — per-file rules iterate ``ctx.modules(self)``,
whole-program rules (handler-parity) additionally reach across files via
``ctx.all_modules``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from fnmatch import fnmatch
from pathlib import Path
from typing import Callable, Iterable, Iterator

from distributed_tpu_torch.analysis.baseline import Baseline
from distributed_tpu_torch.analysis.config import LintConfig

#: ``# graft-lint: allow[rule-name] reason`` — suppresses findings of that
#: rule on the same line or the line directly below the pragma.  A pragma
#: with no reason text does NOT suppress (justifications are mandatory).
_PRAGMA = re.compile(r"#\s*graft-lint:\s*allow\[([a-z0-9-]+)\]\s*(.*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    #: stable anchor for baseline matching (enclosing function / op name);
    #: survives line-number churn where ``line`` does not
    symbol: str = ""

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{sym}: {self.message}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "symbol": self.symbol,
            "message": self.message,
        }


@dataclass
class ModuleInfo:
    """A parsed source file plus the bits rules keep re-deriving."""

    relpath: str
    path: Path
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    _imports: "object | None" = None

    def imports(self):
        """Cached ImportMap — rules share one per module, not one per rule."""
        if self._imports is None:
            from distributed_tpu_torch.analysis.astutils import ImportMap

            self._imports = ImportMap(self.tree)
        return self._imports

    def pragma_reasons(self, rule: str, line: int) -> str | None:
        """Reason text if an allow-pragma for ``rule`` covers ``line``."""
        for lno in (line, line - 1):
            if 1 <= lno <= len(self.lines):
                m = _PRAGMA.search(self.lines[lno - 1])
                if m and m.group(1) == rule and m.group(2).strip():
                    return m.group(2).strip()
        return None


class Rule:
    """Base class; subclasses set ``name``/``description``/``scope``."""

    name: str = ""
    description: str = ""
    #: default file globs (repo-relative, posix); graft-lint.toml overrides
    scope: tuple[str, ...] = ("distributed_tpu_torch/**",)

    def run(self, ctx: "LintContext") -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    rule = cls()
    assert rule.name and rule.name not in _REGISTRY, rule.name
    _REGISTRY[rule.name] = rule
    return cls


def all_rules() -> dict[str, Rule]:
    # rule modules self-register on import
    import distributed_tpu_torch.analysis.rules  # noqa: F401

    return dict(_REGISTRY)


def _match_scope(relpath: str, patterns: Iterable[str]) -> bool:
    for pat in patterns:
        if fnmatch(relpath, pat):
            return True
        # fnmatch's ``*`` already crosses ``/``; make ``dir/**`` also match
        # files directly inside ``dir`` the way globs usually read
        if pat.endswith("/**") and relpath.startswith(pat[:-2]):
            return True
    return False


class LintContext:
    """Parsed-module cache + scoping shared by every rule in one run."""

    def __init__(self, root: Path, config: LintConfig):
        self.root = root
        self.config = config
        self._modules: dict[str, ModuleInfo] = {}
        self.parse_errors: list[str] = []
        for path in sorted(root.glob("distributed_tpu_torch/**/*.py")):
            relpath = path.relative_to(root).as_posix()
            if _match_scope(relpath, config.exclude_files):
                continue
            try:
                source = path.read_text()
                tree = ast.parse(source, filename=str(path))
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                self.parse_errors.append(f"{relpath}: {e}")
                continue
            self._modules[relpath] = ModuleInfo(
                relpath=relpath, path=path, source=source, tree=tree,
                lines=source.splitlines(),
            )

    @property
    def all_modules(self) -> list[ModuleInfo]:
        return list(self._modules.values())

    def module(self, relpath: str) -> ModuleInfo | None:
        return self._modules.get(relpath)

    def modules(self, rule: Rule) -> list[ModuleInfo]:
        include, exclude = self.config.rule_scope(rule.name, rule.scope)
        return [
            mod
            for relpath, mod in self._modules.items()
            if _match_scope(relpath, include)
            and not _match_scope(relpath, exclude)
        ]


@dataclass
class LintResult:
    findings: list[Finding]
    suppressed: int = 0
    stale_baseline: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)

    @property
    def exit_code(self) -> int:
        return 1 if (self.findings or self.errors) else 0


def run_lint(
    root: Path,
    config: LintConfig | None = None,
    baseline: Baseline | None = None,
    rule_names: Iterable[str] | None = None,
    log: Callable[[str], None] | None = None,
) -> LintResult:
    """Run every enabled rule and filter pragma/baseline-allowed findings."""
    config = config if config is not None else LintConfig.load(root)
    baseline = baseline if baseline is not None else Baseline.load(
        root / config.baseline_file
    )
    ctx = LintContext(root, config)
    result = LintResult(findings=[])
    result.errors.extend(ctx.parse_errors)
    result.errors.extend(baseline.errors)

    rules = all_rules()
    selected = list(rule_names) if rule_names else sorted(rules)
    for name in selected:
        if name not in rules:
            result.errors.append(f"unknown rule {name!r}")
            continue
        if not config.rule_enabled(name):
            continue
        rule = rules[name]
        if log:
            log(f"rule {name}: {rule.description}")
        for finding in rule.run(ctx):
            mod = ctx.module(finding.path)
            if mod is not None and mod.pragma_reasons(name, finding.line):
                result.suppressed += 1
            elif baseline.allows(finding):
                result.suppressed += 1
            else:
                result.findings.append(finding)
    result.stale_baseline.extend(baseline.unused())
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result
