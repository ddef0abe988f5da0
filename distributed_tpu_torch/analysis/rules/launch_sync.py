"""launch-sync: the host code that launches a hand kernel must not sync.

The kernels under ``ops/csrc`` only pay off while the card stays busy:
a kernel that is fast alone moves nothing end to end when host work sits
between its launches.  The worst such work is a device->host sync in the
function that launches the kernel: it drains the stream before (or right
after) every launch, so the host and the card take turns instead of
overlapping.

A *launcher* is every function whose own body calls
``_build.launch(...)`` (``ops/_build.py``), the one door to the kernels'
C entry points.  In a launcher this rule flags:

- ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()``;
- ``torch.cuda.synchronize()`` and ``<event>.synchronize()``;
- ``float()``, ``int()`` and ``bool()`` applied to an expression rooted at
  a parameter (a tensor argument turned into a host scalar).  As
  jit-purity leaves static arguments alone, this leaves alone the
  parameters annotated as a Python scalar (``int``, ``float``, ``bool``,
  optional or not), a cast of a tensor's metadata (``.shape``, ``.ndim``,
  ``.numel()``, ``.dim()``, ``.size()``, ``len()``) and of an ``is`` test:
  none of them reads the device.

A sync that is meant (a result the caller needs on the host, a count
that sizes the next launch) carries a
``# graft-lint: allow[launch-sync] <reason>`` pragma or a baseline entry.

This is the port's counterpart of the reference's ``jit-purity``.  That
rule's two other checks are left out on purpose: a module global captured
by a traced body (its value is baked at trace time) and a static argument
with an unhashable default (it retriggers compilation).  Eager PyTorch
traces nothing and keys nothing on static arguments, so neither hazard
exists here.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

_HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_CAST_BUILTINS = ("float", "int", "bool")
_LAUNCH = "_build.launch"
_SCALAR_TYPES = ("int", "float", "bool")
_METADATA_ATTRS = ("shape", "ndim")
_METADATA_CALLS = ("numel", "dim", "size", "len")


def _is_launch(call: ast.Call, imports: astutils.ImportMap) -> bool:
    target = imports.resolve(call.func) or ""
    return target == _LAUNCH or target.endswith("." + _LAUNCH)


def _is_scalar_annotation(ann: ast.AST | None) -> bool:
    """``int``, ``float``, ``bool``, or one of them ``| None``."""
    if isinstance(ann, ast.Name):
        return ann.id in _SCALAR_TYPES
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        sides = (ann.left, ann.right)
        return any(_is_scalar_annotation(x) for x in sides) and all(
            _is_scalar_annotation(x)
            or (isinstance(x, ast.Constant) and x.value is None)
            for x in sides
        )
    return False


def _tensor_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Parameters that may hold a tensor: all but the Python scalars."""
    a = fn.args
    params = [*a.posonlyargs, *a.args, *a.kwonlyargs]
    params += [p for p in (a.vararg, a.kwarg) if p is not None]
    return {p.arg for p in params if not _is_scalar_annotation(p.annotation)}


def _reads_device(expr: ast.AST) -> bool:
    """False for a cast that reads only host metadata: a tensor's shape,
    size or rank, or an ``is`` test."""
    if isinstance(expr, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
        return False
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _METADATA_ATTRS:
            return False
        if isinstance(node, ast.Call):
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else getattr(node.func, "id", None))
            if name in _METADATA_CALLS:
                return False
    return True


def _roots(expr: ast.AST) -> set[str]:
    """Base names an expression is built from (a.b[c] -> {a, c})."""
    return {
        n.id for n in ast.walk(expr)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


@register
class LaunchSyncRule(Rule):
    name = "launch-sync"
    description = (
        "functions that launch a hand kernel must not sync the device "
        "with the host"
    )
    scope = (
        "distributed_tpu_torch/ops/*.py",
        "distributed_tpu_torch/scheduler/torch_placement.py",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            imports = mod.imports()
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                # a nested def is a launcher, or not, on its own
                nodes = list(astutils.walk_scope(fn))
                if any(isinstance(n, ast.Call) and _is_launch(n, imports)
                       for n in nodes):
                    yield from self._check_body(mod, imports, fn, nodes)

    def _check_body(self, mod, imports, fn, nodes) -> Iterator[Finding]:
        params = _tensor_params(fn)
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            target = imports.resolve(node.func)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_SYNC_METHODS):
                yield self._finding(
                    mod, node, fn.name,
                    f".{node.func.attr}() copies to the host and waits for "
                    "the stream in a function that launches a kernel",
                )
            elif target == "torch.cuda.synchronize":
                yield self._finding(
                    mod, node, fn.name,
                    "torch.cuda.synchronize() drains the device in a "
                    "function that launches a kernel",
                )
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "synchronize"):
                yield self._finding(
                    mod, node, fn.name,
                    ".synchronize() blocks the host on the device in a "
                    "function that launches a kernel",
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in _CAST_BUILTINS
                and node.args
                and _roots(node.args[0]) & params
                and _reads_device(node.args[0])
            ):
                yield self._finding(
                    mod, node, fn.name,
                    f"{node.func.id}() on a value rooted at a parameter syncs "
                    "a tensor argument to the host in a function that "
                    "launches a kernel",
                )

    def _finding(self, mod, node: ast.AST, symbol: str, message: str) -> Finding:
        return Finding(
            rule=self.name, path=mod.relpath, line=node.lineno,
            col=node.col_offset, message=message, symbol=symbol,
        )
