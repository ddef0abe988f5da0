"""config-keys: every config.get() key exists; every default is read.

The config tree is stringly typed: ``config.get("scheduler.work-stealng")``
raises KeyError at first use (best case) or silently takes a caller
default forever (worst case — the yaml knob the operator sets does
nothing).  Both directions are decidable from the AST:

1. every constant dot-path passed to ``config.get(...)`` anywhere in the
   package must resolve in the ``defaults`` literal of
   ``distributed_tpu_torch/config.py`` (subtree reads allowed: reading
   ``worker.connections`` covers its children);
2. every LEAF dot-path in ``defaults`` must be covered by some read,
   else it is dead configuration that documents a knob nothing honors.
   A read is a direct ``config.get`` (exact, ancestor-subtree, or
   descendant), an f-string key with a constant dotted tail
   (``config.get(f"{prefix}.preload")`` covers every ``*.preload``
   leaf), or — for keys routed through helpers like
   ``Security.opt(name, config_key)`` and
   ``blocked_handlers_config_key`` class attributes — any string
   constant in the package that spells the full dot-path.

The defaults tree is recovered from the AST (constant keys of nested
dict literals) — config.py is never imported.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

CONFIG_MODULE = "distributed_tpu_torch/config.py"


def _defaults_leaves(tree: ast.Module) -> tuple[set[str], int]:
    """(dot-paths of every leaf in the ``defaults`` literal, its line)."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        if not any(
            isinstance(t, ast.Name) and t.id == "defaults" for t in targets
        ):
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        leaves: set[str] = set()

        def walk_dict(d: ast.Dict, prefix: str) -> None:
            for k, v in zip(d.keys, d.values):
                key = astutils.const_str(k) if k is not None else None
                if key is None:
                    continue
                path = f"{prefix}.{key}" if prefix else key
                if isinstance(v, ast.Dict) and v.keys:
                    walk_dict(v, path)
                else:
                    leaves.add(path)

        walk_dict(node.value, "")
        return leaves, node.lineno
    return set(), 0


def _is_config_get(call: ast.Call, imports) -> bool:
    target = imports.resolve(call.func)
    if target is None:
        return False
    # `from distributed_tpu_torch import config; config.get(...)` resolves to
    # distributed_tpu_torch.config.get; a bare local `config.get` (e.g. the
    # config module itself) also counts
    return target.endswith("config.get") or target == "config.get"


@register
class ConfigKeysRule(Rule):
    name = "config-keys"
    description = (
        "config.get() keys must exist in the packaged defaults, and "
        "every default leaf must be read somewhere"
    )
    scope = ("distributed_tpu_torch/**",)

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        modules = ctx.modules(self)
        cfg_mod = next(
            (m for m in modules if m.relpath == CONFIG_MODULE), None
        )
        if cfg_mod is None:
            return
        leaves, defaults_line = _defaults_leaves(cfg_mod.tree)
        if not leaves:
            return
        subtrees = {p for leaf in leaves for p in _ancestors(leaf)}

        reads: set[str] = set()
        tail_reads: set[str] = set()  # ".preload" from f-string keys
        indirect: set[str] = set()  # full dot-paths spelled as constants
        key_like = leaves | subtrees
        for mod in modules:
            imports = mod.imports()
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and "." in node.value  # single words prove nothing
                    and node.value in key_like
                ):
                    indirect.add(node.value)
                elif isinstance(node, ast.JoinedStr) and node.values:
                    # f"comm.tls.{role}.{kind}": a constant dotted prefix
                    # that names a real subtree proves the subtree live
                    head = astutils.const_str(node.values[0])
                    if head and "." in head:
                        prefix = head.rstrip(".")
                        if prefix in subtrees:
                            indirect.add(prefix)
            for call in astutils.iter_calls(mod.tree):
                if not call.args or not _is_config_get(call, imports):
                    continue
                arg = call.args[0]
                if isinstance(arg, ast.JoinedStr) and arg.values:
                    tail = arg.values[-1]
                    t = astutils.const_str(tail)
                    if t and t.startswith("."):
                        tail_reads.add(t)
                    continue
                key = astutils.const_str(arg)
                if key is None:
                    continue  # computed key: not statically checkable
                reads.add(key)
                if key in leaves or key in subtrees:
                    continue
                yield Finding(
                    rule=self.name,
                    path=mod.relpath,
                    line=call.lineno,
                    col=call.col_offset,
                    symbol=astutils.enclosing_function_name(call),
                    message=(
                        f"config.get({key!r}): key not present in the "
                        "defaults tree (distributed_tpu_torch/config.py)"
                    ),
                )

        # dead defaults: leaves covered by no read (exact or subtree)
        covered = reads | indirect
        read_prefixes = {p for r in covered for p in (_ancestors(r) | {r})}
        for leaf in sorted(leaves):
            if leaf in covered:
                continue
            if any(p in covered for p in _ancestors(leaf)):
                continue  # an ancestor subtree read covers this leaf
            if leaf in read_prefixes:
                continue  # a descendant read proves the branch is live
            if any(leaf.endswith(t) for t in tail_reads):
                continue  # f-string prefixed read covers this tail
            yield Finding(
                rule=self.name,
                path=CONFIG_MODULE,
                line=defaults_line,
                col=0,
                symbol="defaults",
                message=(
                    f"default key {leaf!r} is read by no config.get() in "
                    "the package (dead configuration)"
                ),
            )


def _ancestors(path: str) -> set[str]:
    parts = path.split(".")
    return {".".join(parts[:i]) for i in range(1, len(parts))}
