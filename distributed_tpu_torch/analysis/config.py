"""graft-lint-torch.toml loading: per-rule scoping and enable/disable.

Format (all keys optional — rules fall back to their built-in scope)::

    baseline = "graft-lint-torch-baseline.toml"
    exclude = ["distributed_tpu_torch/_version.py"]     # never parsed at all

    [rules.sans-io]
    enabled = true
    include = ["distributed_tpu_torch/scheduler/state.py"]   # replaces default scope
    exclude = ["distributed_tpu_torch/graph/debug.py"]        # carved out of scope
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import tomllib

CONFIG_FILE = "graft-lint-torch.toml"


@dataclass
class LintConfig:
    baseline_file: str = "graft-lint-torch-baseline.toml"
    exclude_files: tuple[str, ...] = ()
    rules: dict[str, dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def load(cls, root: Path) -> "LintConfig":
        path = root / CONFIG_FILE
        if not path.is_file():
            return cls()
        data = tomllib.loads(path.read_text())
        return cls(
            baseline_file=data.get("baseline", cls.baseline_file),
            exclude_files=tuple(data.get("exclude", ())),
            rules={
                str(name): dict(opts)
                for name, opts in (data.get("rules") or {}).items()
            },
        )

    def rule_enabled(self, name: str) -> bool:
        return bool(self.rules.get(name, {}).get("enabled", True))

    def rule_scope(
        self, name: str, default: tuple[str, ...]
    ) -> tuple[tuple[str, ...], tuple[str, ...]]:
        opts = self.rules.get(name, {})
        include = tuple(opts.get("include", default))
        exclude = tuple(opts.get("exclude", ()))
        return include, exclude
