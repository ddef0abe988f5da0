"""``python -m distributed_tpu_torch.analysis`` — run graft-lint.

Exit status: 0 clean, 1 findings (or broken baseline entries), 2 usage
error.  ``--format json`` emits a machine-readable report for CI.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from distributed_tpu_torch.analysis.baseline import Baseline
from distributed_tpu_torch.analysis.config import LintConfig
from distributed_tpu_torch.analysis.core import all_rules, run_lint


def default_root() -> Path:
    """Repo root = parent of the installed/checked-out package dir."""
    import distributed_tpu_torch

    return Path(distributed_tpu_torch.__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_tpu_torch.analysis",
        description="graft-lint: static invariant checks for the "
                    "distributed_tpu_torch codebase (the PyTorch + CUDA port)",
    )
    parser.add_argument("--root", type=Path, default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--format", choices=("human", "json"), default="human")
    parser.add_argument("--rule", action="append", dest="rules", default=None,
                        metavar="NAME", help="run only this rule (repeatable)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--dump-model", type=Path, default=None, metavar="DIR",
                        help="extract the task state machines and write "
                             "<name>.json/<name>.dot per machine to DIR "
                             "(the docs/state_machine/ artifacts)")
    parser.add_argument("--prune-baseline", action="store_true",
                        help="after a full lint run, rewrite the baseline "
                             "file in place dropping stale entries (live "
                             "entries keep their comments verbatim)")
    parser.add_argument("--verbose", "-v", action="store_true")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for name in sorted(rules):
            print(f"{name:24s} {rules[name].description}")
        return 0

    root = (args.root or default_root()).resolve()
    if not (root / "distributed_tpu_torch").is_dir():
        print(f"error: {root} does not contain a distributed_tpu_torch package",
              file=sys.stderr)
        return 2

    config = LintConfig.load(root)

    if args.dump_model is not None:
        if args.rules:
            parser.error(
                "--dump-model is a pure extraction mode and runs no rules; "
                "invoke the lint (with --rule, if wanted) separately"
            )
        from distributed_tpu_torch.analysis.core import LintContext
        from distributed_tpu_torch.analysis.model import (
            extract_machines,
            machine_to_dot,
            machine_to_json,
        )

        ctx = LintContext(root, config)
        machines = extract_machines(ctx.all_modules)
        args.dump_model.mkdir(parents=True, exist_ok=True)
        for machine in machines:
            (args.dump_model / f"{machine.name}.json").write_text(
                machine_to_json(machine)
            )
            (args.dump_model / f"{machine.name}.dot").write_text(
                machine_to_dot(machine)
            )
            print(f"# wrote {machine.name}.json/.dot "
                  f"({len(machine.transitions)} transitions, "
                  f"{len(machine.emissions)} emissions)", file=sys.stderr)
        return 0

    if args.prune_baseline and args.rules:
        # a filtered run marks every other rule's entries unused; pruning
        # on that evidence would drop live suppressions
        parser.error("--prune-baseline needs a full run; drop --rule")

    baseline = Baseline.load(root / config.baseline_file)
    result = run_lint(
        root, config=config, baseline=baseline, rule_names=args.rules,
        log=(lambda m: print(f"# {m}", file=sys.stderr)) if args.verbose else None,
    )

    pruned: list[str] = []
    if args.prune_baseline:
        try:
            pruned = baseline.prune(root / config.baseline_file)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if args.format == "json":
        print(json.dumps({
            "findings": [f.as_dict() for f in result.findings],
            "errors": result.errors,
            "suppressed": result.suppressed,
            "stale_baseline": result.stale_baseline,
            "pruned_baseline": pruned,
            "exit_code": result.exit_code,
        }, indent=2))
        return result.exit_code

    for err in result.errors:
        print(f"error: {err}")
    for finding in result.findings:
        print(finding.format())
    for stale in result.stale_baseline:
        if args.prune_baseline:
            print(f"pruned stale baseline entry: {stale}")
        else:
            print(f"warning: stale baseline entry (matched nothing): {stale}")
    n = len(result.findings)
    print(
        f"graft-lint: {n} finding{'s' if n != 1 else ''}, "
        f"{result.suppressed} suppressed by pragma/baseline"
        + (f", {len(result.errors)} errors" if result.errors else "")
    )
    return result.exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
