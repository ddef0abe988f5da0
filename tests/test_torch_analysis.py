"""graft-lint for the port (``distributed_tpu_torch/analysis``) against the
reference's (``distributed_tpu/analysis``).

What each test compares:

- corpus parity: both linters over the reference package, once as it is
  and once renamed to ``distributed_tpu_torch`` (line by line, so line
  numbers hold), pragmas neutralised, empty baselines: the same findings
  ``(rule, path, line, col, symbol, message)`` with the package prefix
  mapped, for every rule the two share;
- fixture parity: every seeded-violation and clean fixture of
  ``tests/test_analysis.py`` (jit-purity's left out: the port has no
  such rule), through both linters: the same findings, suppressions,
  stale entries and errors;
- ``launch-sync``, the port's counterpart of jit-purity, on its own
  fixtures;
- the port's tree lints clean, and so does its determinism rule alone;
- the port's state machines equal the reference's, and the native
  engine's compiled arms lie inside the port's scheduler table;
- the CLI: ``--list-rules``, ``--dump-model``, ``--prune-baseline``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from distributed_tpu.analysis.baseline import Baseline as RefBaseline
from distributed_tpu.analysis.config import LintConfig as RefConfig
from distributed_tpu.analysis.core import LintContext as RefContext
from distributed_tpu.analysis.core import all_rules as ref_all_rules
from distributed_tpu.analysis.core import run_lint as ref_run_lint
from distributed_tpu.analysis.model import extract_machines as ref_extract
from distributed_tpu_torch.analysis.baseline import Baseline
from distributed_tpu_torch.analysis.cli import main as port_main
from distributed_tpu_torch.analysis.config import LintConfig
from distributed_tpu_torch.analysis.core import LintContext, all_rules, run_lint
from distributed_tpu_torch.analysis.model import extract_machines
from distributed_tpu_torch.analysis.rules.state_machine import _compiled_arms

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
torch.set_num_threads(2)

REPO_ROOT = Path(__file__).resolve().parent.parent
REF, PORT = "distributed_tpu", "distributed_tpu_torch"
_REF_NAME = re.compile(r"\bdistributed_tpu\b")
_PORT_NAME = re.compile(r"\bdistributed_tpu_torch\b")
_SHIFT = len(PORT) - len(REF)
#: (reference, port) names of the configuration and the baseline
FILES = {"config": ("graft-lint.toml", "graft-lint-torch.toml"),
         "baseline": ("graft-lint-baseline.toml", "graft-lint-torch-baseline.toml")}
#: the rules both linters have: all but the reference's jit-purity and the
#: port's launch-sync, which check different things (traced bodies, launchers)
SHARED = sorted(set(ref_all_rules()) - {"jit-purity"})


def to_port(text: str) -> str:
    """The reference's text with its package renamed; other names, and
    every line's place, stay."""
    text = _REF_NAME.sub(PORT, text)
    for ref_name, port_name in FILES.values():
        text = text.replace(f'"{ref_name}"', f'"{port_name}"')
    return text


def to_ref(text: str) -> str:
    text = _PORT_NAME.sub(REF, text)
    for ref_name, port_name in FILES.values():
        text = text.replace(port_name, ref_name)
    return text


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def make_pair(tmp_path: Path, files: dict[str, str], config: str | None = None,
              baseline: str | None = None) -> tuple[Path, Path]:
    """Two roots: the files as given, and the same files renamed to the
    port's package, each with its linter's configuration and baseline."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    for rel, src in files.items():
        src = textwrap.dedent(src)
        _write(ref / rel, src)
        _write(port / to_port(rel), to_port(src))
    for kind, text in (("config", config), ("baseline", baseline)):
        if text is not None:
            text = textwrap.dedent(text)
            _write(ref / FILES[kind][0], text)
            _write(port / FILES[kind][1], to_port(text))
    return ref, port


def _key(finding, root: Path | None = None):
    """A finding as a tuple; a port finding in the reference's names, its
    column moved back by the renames left of it on its line."""
    if root is None:
        return (finding.rule, finding.path, finding.line, finding.col,
                finding.symbol, finding.message)
    line = (root / finding.path).read_text().splitlines()[finding.line - 1]
    col = finding.col - _SHIFT * len(
        [m for m in _PORT_NAME.finditer(line) if m.start() < finding.col])
    return (finding.rule, to_ref(finding.path), finding.line, col,
            to_ref(finding.symbol), to_ref(finding.message))


def outcome(result, root: Path | None = None) -> dict:
    """What a run says: the findings, the suppressed count, the stale
    entries and the errors, the port's in the reference's names."""
    mapped = to_ref if root is not None else (lambda s: s)
    return {
        "findings": sorted(_key(f, root) for f in result.findings),
        "suppressed": result.suppressed,
        "stale": sorted(mapped(s) for s in result.stale_baseline),
        "errors": sorted(mapped(e) for e in result.errors),
        "exit_code": result.exit_code,
    }


def both(ref: Path, port: Path, rules=None) -> tuple[dict, dict]:
    return (outcome(ref_run_lint(ref, rule_names=rules)),
            outcome(run_lint(port, rule_names=rules), port))


def test_the_twin_has_the_references_rules_with_launch_sync_for_jit_purity():
    assert set(all_rules()) == set(SHARED) | {"launch-sync"}
    assert "jit-purity" not in all_rules()
    for rule in all_rules().values():
        assert rule.description and rule.scope
        assert all(p.startswith(PORT + "/") for p in rule.scope), rule.scope
    for name in SHARED:
        assert all_rules()[name].scope == tuple(
            to_port(p) for p in ref_all_rules()[name].scope)


# ------------------------------------------------------------ corpus parity


def _copy_corpus(src: Path, dst_root: Path, rename: bool) -> None:
    """The reference package's sources under ``dst_root``, pragmas
    neutralised, renamed to the port's package when ``rename``."""
    for path in sorted(src.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(src.parent).as_posix()
        text = path.read_text().replace("graft-lint:", "graft-lint-off:")
        _write(dst_root / (to_port(rel) if rename else rel),
               to_port(text) if rename else text)


def test_corpus_parity_on_the_reference_package(tmp_path):
    """Both linters over the whole reference package (the twin over its
    renamed copy) with every pragma neutralised and empty baselines: the
    same findings for every shared rule.  jit-purity and launch-sync are
    left out: they check different code (jitted bodies, kernel
    launchers)."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    _copy_corpus(REPO_ROOT / REF, ref, rename=False)
    _copy_corpus(REPO_ROOT / REF, port, rename=True)
    config = (REPO_ROOT / FILES["config"][0]).read_text()
    _write(ref / FILES["config"][0], config)
    _write(port / FILES["config"][1], to_port(config))
    _write(ref / FILES["baseline"][0], "")
    _write(port / FILES["baseline"][1], "")
    got_ref, got_port = both(ref, port, SHARED)
    assert got_ref["errors"] == [] and got_ref["suppressed"] == 0
    # the pragmas are off, so the reference's own suppressions show
    assert got_ref["findings"], "the neutralised pragmas should leave findings"
    assert got_port == got_ref


# ----------------------------------------------------------- fixture parity

#: the reference tests' shared fixtures, verbatim
CLEAN_MACHINE = """
    ALL_TASK_STATES = ("released", "waiting", "memory")

    class S:
        def __init__(self):
            self._transitions_table = {
                ("released", "waiting"): self._transition_released_waiting,
                ("waiting", "memory"): self._transition_waiting_memory,
                ("waiting", "released"): self._transition_waiting_released,
                ("memory", "released"): self._transition_memory_released,
            }

        def _transition_released_waiting(self, key, stimulus_id):
            return {}, {}, {}

        def _transition_waiting_memory(self, key, stimulus_id):
            return {}, {}, {}

        def _transition_waiting_released(self, key, stimulus_id):
            return {}, {}, {}

        def _transition_memory_released(self, key, stimulus_id):
            return {}, {}, {}

        def stimulus_done(self, ts, recommendations):
            if ts.state == "released":
                recommendations[ts.key] = "waiting"
            recommendations[ts.key] = "memory"
            recommendations[ts.key] = "released"
            return recommendations
"""

CONFIG_FIXTURE = """
    defaults = {
        "scheduler": {"bandwidth": 1, "dead-knob": 2},
        "worker": {"preload": [], "nested": {"a": 1, "b": 2}},
    }
"""

RELATION_SET_BUG = """
    class TaskState:
        def __init__(self, key):
            self.key = key
            self.dependents: set[TaskState] = set()
            self.waiters: set[TaskState] = set()

    class SchedulerState:
        def _transition_processing_memory(self, ts: TaskState, stimulus_id):
            recommendations = {}
            for dts in ts.dependents:
                if not dts.waiters:
                    recommendations[dts.key] = "released"
            return recommendations
"""

SATURATED_SET_BUG = """
    class SchedulerState:
        def __init__(self):
            self.saturated: set = set()

        def pick_steal_victim(self):
            for ws in self.saturated:
                if ws.nprocessing > 1:
                    return ws
            return None
"""

#: (name, rule, files) of every fixture of ``tests/test_analysis.py`` that
#: the default configuration and an empty baseline decide
FIXTURES = [
    ('sans_io_fires_on_seeded_violations', 'sans-io', {
        "distributed_tpu/scheduler/state.py": """
        import asyncio
        from distributed_tpu.comm.core import connect

        async def pull(self):
            await asyncio.sleep(0)

        def load(path):
            return open(path).read()
    """,
    }),
    ('sans_io_clean_engine_passes', 'sans-io', {
        "distributed_tpu/scheduler/state.py": """
        from collections import deque

        def transition(state, key):
            return {"released": "waiting"}.get(state)
    """,
    }),
    ('sans_io_ignores_out_of_scope_files', 'sans-io', {
        "distributed_tpu/scheduler/server.py": "import asyncio\n",
    }),
    ('monotonic_time_fires_including_aliases', 'monotonic-time', {
        "distributed_tpu/scheduler/ttl.py": """
        import time
        import time as _t
        from time import sleep

        def wait_for_worker(deadline):
            t0 = time.time()
            _t.sleep(0.1)
    """,
    }),
    ('monotonic_time_allows_sanctioned_clocks', 'monotonic-time', {
        "distributed_tpu/scheduler/ttl.py": """
        from time import monotonic, perf_counter

        from distributed_tpu.utils.misc import time, wall_clock

        def stamp():
            return time(), wall_clock(), monotonic(), perf_counter()
    """,
    }),
    ('blocking_in_async_fires', 'blocking-in-async', {
        "distributed_tpu/worker/srv.py": """
        import subprocess
        import time

        async def handler(self, path):
            time.sleep(1)
            subprocess.run(["ls"])
            with open(path) as f:
                f.read()
            self._lock.acquire()
    """,
    }),
    ('blocking_in_async_exempts_executor_targets_and_sync_defs', 'blocking-in-async', {
        "distributed_tpu/worker/srv.py": """
        import asyncio
        import time

        def plain(path):
            time.sleep(1)  # sync helper: not loop code
            return open(path).read()

        async def handler(loop, path):
            def _work():
                time.sleep(1)  # executor target
                with open(path) as f:
                    return f.read()

            await asyncio.sleep(0.1)
            return await loop.run_in_executor(None, _work)
    """,
    }),
    ('handler_parity_unknown_rpc_op', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Worker:
            def __init__(self):
                handlers = {"get_data": self.get_data}

            def get_data(self, keys=()):
                return keys

            async def fetch(self, addr):
                return await self.rpc(addr).get_dta(keys=[])
    """,
    }),
    ('handler_parity_keyword_mismatch', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Worker:
            def __init__(self):
                handlers = {"get_data": self.get_data}

            def get_data(self, comm, keys=()):
                return keys

            async def fetch(self, addr):
                return await self.rpc(addr).get_data(keys=[], who="me")
    """,
    }),
    ('handler_parity_accepts_update_registration_and_stream_msgs', 'handler-parity', {
        "distributed_tpu/shuffle/ext.py": """
        class Ext:
            def __init__(self, scheduler):
                scheduler.stream_handlers.update(
                    {"shuffle-ping": self.ping}
                )

            def ping(self, id=None, stimulus_id=None):
                return id

        class Worker:
            def tell(self):
                self.batched_stream.send(
                    {"op": "shuffle-ping", "id": 1, "stimulus_id": "s"}
                )
    """,
    }),
    ('handler_parity_stream_msg_keyword_not_accepted', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}

            def handle_done(self, key=None):
                return key

            def report(self):
                self.batched_stream.send(
                    {"op": "task-done", "key": "k", "nbytes": 3}
                )
    """,
    }),
    ('handler_parity_learns_manual_dispatch_arms', 'handler-parity', {
        "distributed_tpu/worker/boot.py": """
        def consume(q):
            msg = q.get()
            if msg.get("op") != "started":
                raise RuntimeError(msg)

        def produce(q, addr):
            q.put({"op": "started", "address": addr})
    """,
    }),
    ('swallowed_exceptions_fires', 'swallowed-exceptions', {
        "distributed_tpu/rpc/disp.py": """
        def dispatch(handler):
            try:
                handler()
            except Exception:
                pass
    """,
    }),
    ('swallowed_exceptions_allows_logged_or_narrow', 'swallowed-exceptions', {
        "distributed_tpu/rpc/disp.py": """
        import logging

        logger = logging.getLogger(__name__)

        def dispatch(handler):
            try:
                handler()
            except KeyError:
                pass  # narrow: deliberate
            except Exception:
                logger.exception("handler failed")
    """,
    }),
    ('mirror_parity_fires_on_rogue_mutations', 'mirror-parity', {
        "distributed_tpu/scheduler/rogue.py": """
        def sneak_occupancy(ws, delta):
            ws.occupancy += delta

        def sneak_status(ws):
            ws.status = "paused"

        def sneak_replica(ws, ts):
            ws.has_what[ts] = None
            ws.nbytes += 10

        def sneak_container(ws, ts):
            ws.processing.pop(ts, None)
            del ws.has_what[ts]
    """,
    }),
    ('mirror_parity_allows_helpers_scope_and_reads', 'mirror-parity', {
        "distributed_tpu/scheduler/state.py": """
        class WorkerState:
            def __init__(self):
                self.occupancy = 0.0
                self.status = "running"

            def clean(self):
                ws = WorkerState()
                ws.status = self.status
                return ws

        class SchedulerState:
            def _adjust_occupancy(self, ws, delta):
                ws.occupancy = max(0.0, ws.occupancy + delta)

            def add_replica(self, ts, ws):
                ws.nbytes += ts.nbytes
                ws.has_what[ts] = None

            def set_worker_status(self, ws, status):
                ws.status = status

        def reads_are_fine(ws):
            return ws.occupancy / max(ws.nthreads, 1), ws.processing.get(None)

        def other_objects_are_fine(ts, client):
            ts.nbytes = 5          # TaskState, not a worker
            client.status = "x"    # not a worker-state binding name
    """,
    }),
    ('mirror_parity_allows_helpers_scope_and_reads_1', 'mirror-parity', {
        "distributed_tpu/worker/state_machine.py": """
        def worker_side(ws):
            ws.occupancy = 1.0
    """,
    }),
    ('soa_hydration_fires_on_raw_slot_writes', 'soa-hydration', {
        "distributed_tpu/scheduler/rogue.py": """
        def sneak_state(ts):
            ts._state = "memory"

        def sneak_relation(ts, ws):
            ts._waiting_on.add(ts)
            ws._processing[ts] = 1.0
            ws._occupancy += 2.0

        def sneak_alias(ts):
            push = ts._waiters.add
            return push

        def sneak_log(s, row):
            s._transition_log.append(row)
    """,
    }),
    ('soa_hydration_allows_registered_helpers_and_reads', 'soa-hydration', {
        "distributed_tpu/scheduler/state.py": """
        class TaskState:
            def __init__(self):
                self._state = "released"
                self._waiting_on = set()

            @property
            def state(self):
                return self._state

            @state.setter
            def state(self, value):
                self._state = value

        class NativeEngine:
            def _apply_tape_inner(self, ts, s, row):
                ts._state = "memory"
                log = s._transition_log.append
                log(row)

            def sync(self, ts):
                ts._nbytes = 5

        def reads_are_fine(ts):
            return ts._state, len(ts._waiting_on)

        def other_underscores_are_fine(ts, obj):
            ts._nrow_cache = 1       # not an SoA-backed slot
            obj._state = "x"         # not a task/worker/state binding
    """,
    }),
    ('soa_hydration_allows_registered_helpers_and_reads_1', 'soa-hydration', {
        "distributed_tpu/worker/state_machine.py": """
        def worker_side(ws):
            ws._occupancy = 1.0
    """,
    }),
    ('wire_no_copy_fires_on_materialization', 'wire-no-copy', {
        "distributed_tpu/comm/rogue.py": """
        def write_frames(writer, frames):
            for f in frames:
                writer.write(bytes(f))

        def reassemble(parts):
            return b"".join(bytes(p) for p in parts)
    """,
    }),
    ('wire_no_copy_allows_sanctioned_idioms', 'wire-no-copy', {
        "distributed_tpu/protocol/clean.py": """
        import struct

        def scatter(writer, frames):
            for f in frames:
                writer.write(f)            # pass-through, no copy

        def gather(parts):
            out = bytearray(sum(len(p) for p in parts))
            pos = 0
            for p in parts:
                out[pos:pos + len(p)] = p  # one preallocated gather
                pos += len(p)
            return memoryview(out).toreadonly()

        def construction_not_conversion(n):
            return bytes(16), struct.pack("<Q", n), bytes()

        def outside_scope_is_fine():
            pass
    """,
    }),
    ('wire_no_copy_allows_sanctioned_idioms_1', 'wire-no-copy', {
        "distributed_tpu/scheduler/report.py": """
        def report(frames):
            return b"".join(bytes(f) for f in frames)
    """,
    }),
    ('state_machine_clean_fixture_passes', 'state-machine', {
        "distributed_tpu/scheduler/state.py": CLEAN_MACHINE,
    }),
    ('state_machine_flags_unresolvable_pair', 'state-machine', {
        "distributed_tpu/scheduler/state.py": CLEAN_MACHINE + """
        def bad(self, dts, recommendations):
            if dts.state == "released":
                recommendations[dts.key] = "memory"
    """,
    }),
    ('state_machine_accepts_released_fallback', 'state-machine', {
        "distributed_tpu/scheduler/state.py": CLEAN_MACHINE + """
        def ok(self, dts, recommendations):
            if dts.state == "waiting":
                recommendations[dts.key] = "memory"   # direct
            if dts.state == "memory":
                recommendations[dts.key] = "waiting"  # via released
    """,
    }),
    ('state_machine_flags_unknown_state', 'state-machine', {
        "distributed_tpu/scheduler/state.py": CLEAN_MACHINE + """
        def typo(self, ts, recommendations):
            recommendations[ts.key] = "wating"
    """,
    }),
    ('state_machine_flags_unreachable_edge_and_dead_handler', 'state-machine', {
        "distributed_tpu/scheduler/state.py": """
        class S:
            def __init__(self):
                self._transitions_table = {
                    ("released", "waiting"): self._transition_released_waiting,
                    ("waiting", "queued"): self._transition_waiting_queued,
                }

            def _transition_released_waiting(self, key):
                return {}

            def _transition_waiting_queued(self, key):
                return {}

            def _transition_memory_forgotten(self, key):
                return {}

            def stimulus(self, ts, recommendations):
                recommendations[ts.key] = "waiting"
    """,
    }),
    ('state_machine_flags_batch_oracle_drift', 'state-machine', {
        "distributed_tpu/scheduler/state.py": CLEAN_MACHINE + """
        def stimulus_task_done(self, key):
            return self._transition(key, "memory", "sid")

        def stimulus_tasks_done_batch(self, items):
            for key in items:
                self._transition(key, "released", "sid")

        def stimulus_orphan_batch(self, items):
            return items
    """,
    }),
    ('state_machine_emissions_cross_module', 'state-machine', {
        "distributed_tpu/scheduler/state.py": CLEAN_MACHINE,
        "distributed_tpu/scheduler/ext.py": """
        def release_all(self, state, keys):
            recs = {k: "wating" for k in keys}
            return state.transitions(recs, "sid")
    """,
    }),
    ('await_atomicity_fires_on_slot_reuse_steal_shape', 'await-atomicity', {
        "distributed_tpu/scheduler/stealing.py": """
        class WorkStealing:
            async def balance_device(self):
                state = self.scheduler.state
                victim = state.mirror.ws_of[self.vslot]
                plan = await self.run_device_kernel()
                self.batched_send(victim, {"op": "steal-request",
                                           "key": plan})
    """,
    }),
    ('await_atomicity_fires_on_readinto_buffer_shape', 'await-atomicity', {
        "distributed_tpu/comm/rogue.py": """
        async def readinto_exactly(reader, view):
            n = view.nbytes
            pos = 0
            buffer = reader._buffer
            while pos < n:
                if not buffer:
                    await reader._wait_for_data("readinto")
                take = min(len(buffer), n - pos)
                view[pos:pos + take] = buffer[:take]
                del buffer[:take]
                pos += take
    """,
    }),
    ('await_atomicity_revalidation_and_rebind_pass', 'await-atomicity', {
        "distributed_tpu/scheduler/server.py": """
        class Scheduler:
            async def guarded(self, key, addr):
                state = self.state
                ws = state.workers.get(addr)
                await self.flush()
                if state.workers.get(addr) is ws:
                    ws.processing.pop(key, None)

            async def reread(self, key):
                state = self.state
                ts = state.tasks.get(key)
                nbytes = await self.fetch(ts.key)
                ts = state.tasks.get(key)
                ts.nbytes = nbytes

            async def before_await_is_fine(self, key):
                ts = self.state.tasks.get(key)
                ts.nbytes = 1
                await self.flush()
    """,
    }),
    ('config_keys_missing_and_dead', 'config-keys', {
        "distributed_tpu/config.py": CONFIG_FIXTURE,
        "distributed_tpu/reader.py": """
        from distributed_tpu import config

        def f(prefix):
            config.get("scheduler.bandwidth")
            config.get("scheduler.typo-key")
            config.get("worker.nested")
            config.get(f"{prefix}.preload")
    """,
    }),
    ('config_keys_indirect_full_path_constant_counts_as_read', 'config-keys', {
        "distributed_tpu/config.py": CONFIG_FIXTURE,
        "distributed_tpu/reader.py": """
        from distributed_tpu import config

        KEY = "scheduler.dead-knob"

        def f():
            config.get("scheduler.bandwidth")
            config.get("worker.nested")
            config.get("worker.preload")
            return config.get(KEY)
    """,
    }),
    ('handler_parity_batch_without_scalar_and_orphan_keys', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}
                self.stream_batch_handlers["task-done"] = self.handle_done_batch
                self.stream_batch_handlers["task-gone"] = self.handle_gone_batch

            def handle_done(self, key=None, stimulus_id=None):
                self._trace_ingress("task-done", 1, stimulus_id)
                return key

            def handle_done_batch(self, msgs, worker=""):
                self._trace_ingress("task-done", len(msgs), "")
                out = []
                for m in msgs:
                    k = m.pop("key", None)
                    sid = m.pop("stimulus_id", "")
                    nb = m.pop("nbytes", 0)
                    out.append((k, sid, nb))
                return out

            def handle_gone_batch(self, msgs):
                return msgs
    """,
    }),
    ('handler_parity_batch_dropping_scalar_param_flagged', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}
                self.stream_batch_handlers["task-done"] = self.handle_done_batch

            def handle_done(self, key=None, nbytes=0, stimulus_id=None):
                self._trace_ingress("task-done", 1, stimulus_id)
                return key

            def handle_done_batch(self, msgs, worker=""):
                self._trace_ingress("task-done", len(msgs), "")
                return [m.pop("key", None) for m in msgs]
    """,
    }),
    ('handler_parity_batch_residual_carry_through_passes', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}
                self.stream_batch_handlers["task-done"] = self.handle_done_batch

            def handle_done(self, key=None, nbytes=0, stimulus_id=None,
                            **kw):
                self._trace_ingress("task-done", 1, stimulus_id)
                return key

            def handle_done_batch(self, msgs, worker=""):
                self._trace_ingress("task-done", len(msgs), "")
                out = []
                for m in msgs:
                    key = m.pop("key", None)
                    sid = m.pop("stimulus_id", "")
                    out.append((key, sid, m))
                return out
    """,
    }),
    ('handler_parity_batch_wholesale_forward_passes', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}
                self.stream_batch_handlers["task-done"] = self.handle_done_batch
                stream_handlers["task-gone"] = self.handle_gone
                self.stream_batch_handlers["task-gone"] = self.handle_gone_batch

            def handle_done(self, key=None, nbytes=0, stimulus_id=None):
                self._trace_ingress("task-done", 1, stimulus_id)
                return key

            def handle_done_batch(self, msgs, worker=""):
                return [self.handle_done(**m) for m in msgs]

            def handle_gone(self, key=None, reason=None):
                self.trace.emit("ingress", "task-gone", "")
                return key

            def handle_gone_batch(self, msgs, worker=""):
                self.trace.emit("ingress", "task-gone", "", n=len(msgs))
                return [sorted(m.items()) for m in msgs]
    """,
    }),
    ('handler_parity_trace_parity_must_fire', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}
                self.stream_batch_handlers["task-done"] = self.handle_done_batch

            def handle_done(self, key=None, stimulus_id=None):
                return key

            def handle_done_batch(self, msgs, worker=""):
                out = []
                for m in msgs:
                    out.append((m.pop("key", None), m.pop("stimulus_id", ""), m))
                return out
    """,
    }),
    ('handler_parity_trace_parity_accepts_direct_emit_and_helper', 'handler-parity', {
        "distributed_tpu/worker/srv.py": """
        class Server:
            def __init__(self):
                stream_handlers = {"task-done": self.handle_done}
                self.stream_batch_handlers["task-done"] = self.handle_done_batch
                stream_handlers["task-gone"] = self.handle_gone
                self.stream_batch_handlers["task-gone"] = self.handle_gone_batch

            def handle_done(self, key=None, stimulus_id=None):
                self.trace.emit("ingress", "task-done", stimulus_id)
                return key

            def handle_done_batch(self, msgs, worker=""):
                self._trace_ingress("task-done", len(msgs), "")
                return [(m.pop("key", None), m.pop("stimulus_id", ""), m)
                        for m in msgs]

            def handle_gone(self, key=None, stimulus_id=None):
                self.trace.emit("engine", "not-ingress", stimulus_id)
                return key

            def handle_gone_batch(self, msgs, worker=""):
                self._trace_ingress("task-gone", len(msgs), "")
                return [(m.pop("key", None), m.pop("stimulus_id", ""), m)
                        for m in msgs]
    """,
    }),
    ('await_atomicity_bare_annotation_is_not_a_bind', 'await-atomicity', {
        "distributed_tpu/scheduler/server.py": """
        class Scheduler:
            async def annotated(self, key):
                ts = self.state.tasks.get(key)
                await self.flush()
                ts: object
                ts.nbytes = 1
    """,
    }),
    ('determinism_fires_on_relation_set_bug', 'determinism', {
        "distributed_tpu/scheduler/state.py": RELATION_SET_BUG,
    }),
    ('determinism_clean_with_ordered_relations', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        from distributed_tpu.utils.collections import OrderedSet

        class TaskState:
            def __init__(self, key):
                self.key = key
                self.dependents: OrderedSet[TaskState] = OrderedSet()
                self.waiters: OrderedSet[TaskState] = OrderedSet()

        class SchedulerState:
            def _transition_processing_memory(self, ts: TaskState, stimulus_id):
                recommendations = {}
                for dts in ts.dependents:
                    if not dts.waiters:
                        recommendations[dts.key] = "released"
                return recommendations
    """,
    }),
    ('determinism_fires_on_saturated_set_bug', 'determinism', {
        "distributed_tpu/ops/stealing.py": SATURATED_SET_BUG,
    }),
    ('determinism_clean_with_keyed_sorted', 'determinism', {
        "distributed_tpu/ops/stealing.py": """
        class SchedulerState:
            def __init__(self):
                self.saturated: set = set()

            def pick_steal_victim(self):
                for ws in sorted(self.saturated, key=lambda w: w.address):
                    if ws.nprocessing > 1:
                        return ws
                return None
    """,
    }),
    ('determinism_fires_on_unstable_min_key', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class SchedulerState:
            def __init__(self):
                self.idle: set = set()

            def decide_worker(self):
                return min(self.idle, key=lambda ws: ws.occupancy)
    """,
    }),
    ('determinism_clean_with_address_tiebreak', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class SchedulerState:
            def __init__(self):
                self.idle: set = set()

            def decide_worker(self):
                return min(self.idle, key=lambda ws: (ws.occupancy, ws.address))
    """,
    }),
    ('determinism_fires_on_id_keyed_sort_and_set_pop', 'determinism', {
        "distributed_tpu/scheduler/amm.py": """
        class Plan:
            def __init__(self):
                self.pending: set = set()

            def order_policies(self, policies):
                return sorted(policies, key=id)

            def take(self):
                return self.pending.pop()
    """,
    }),
    ('determinism_next_iter_requires_singleton_guard', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class S:
            def __init__(self):
                self.workers: set = set()

            def only_unsafe(self):
                return next(iter(self.workers))

            def only_safe(self):
                if len(self.workers) == 1:
                    return next(iter(self.workers))
                return None
    """,
    }),
    ('tape_safe_plugin_reading_occupancy_fires', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class StealTap:
            tape_safe = True

            def transition(self, key, start, finish, stimulus_id=None, ws=None):
                if ws is not None and ws.occupancy > 1.0:
                    self.hot.append(key)
    """,
    }),
    ('tape_safe_plugin_cross_row_scan_fires', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class CensusTap:
            tape_safe = True

            def transition(self, key, start, finish, stimulus_id=None):
                self._rescan()

            def _rescan(self):
                self.n = len([ts for ts in self.state.tasks.values()])
    """,
    }),
    ('tape_safe_plugin_args_only_is_clean', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class CountTap:
            tape_safe = True

            def transition(self, key, start, finish, stimulus_id=None):
                self.counts[finish] = self.counts.get(finish, 0) + 1
    """,
    }),
    ('non_tape_safe_plugin_may_read_occupancy', 'determinism', {
        "distributed_tpu/scheduler/state.py": """
        class LooseTap:
            tape_safe = False

            def transition(self, key, start, finish, stimulus_id=None, ws=None):
                if ws is not None and ws.occupancy > 1.0:
                    self.hot.append(key)
    """,
    }),
]


#: the fixtures whose suppressions, baselines or configuration are part of
#: the case: (name, rules, files, graft-lint configuration, baseline)
_DISPATCH = """
    def dispatch(handler):
        try:
            handler()
        except Exception:
            pass
"""
SUPPRESSION_CASES = [
    ("wire_no_copy_pragma_suppresses", ["wire-no-copy"], {
        "distributed_tpu/comm/err.py": """
        def error_repr(frames):
            # graft-lint: allow[wire-no-copy] error-path repr only
            return repr(bytes(frames[0]))
    """}, None, None),
    ("inline_pragma_suppresses_with_reason", ["swallowed-exceptions"], {
        "distributed_tpu/rpc/disp.py": """
        def dispatch(handler):
            try:
                handler()
            # graft-lint: allow[swallowed-exceptions] probe path, outcome irrelevant
            except Exception:
                pass
    """}, None, None),
    ("inline_pragma_without_reason_does_not_suppress", ["swallowed-exceptions"], {
        "distributed_tpu/rpc/disp.py": """
        def dispatch(handler):
            try:
                handler()
            # graft-lint: allow[swallowed-exceptions]
            except Exception:
                pass
    """}, None, None),
    ("baseline_entry_suppresses", ["swallowed-exceptions"],
     {"distributed_tpu/rpc/disp.py": _DISPATCH}, None, """
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/disp.py"
        symbol = "dispatch"
        reason = "probe path, outcome irrelevant"
    """),
    ("baseline_entry_requires_reason", ["swallowed-exceptions"],
     {"distributed_tpu/rpc/disp.py": _DISPATCH}, None, """
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/disp.py"
    """),
    ("baseline_stale_entries_are_reported", SHARED,
     {"distributed_tpu/rpc/disp.py": "x = 1\n"}, None, """
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/gone.py"
        reason = "was real once"
    """),
    ("config_scoping_default", ["sans-io"],
     {"distributed_tpu/graph/order.py": "import asyncio\n"}, None, None),
    ("config_scoping_exclude", ["sans-io"],
     {"distributed_tpu/graph/order.py": "import asyncio\n"}, """
        [rules.sans-io]
        exclude = ["distributed_tpu/graph/order.py"]
    """, None),
    ("config_scoping_disable", ["sans-io"],
     {"distributed_tpu/graph/order.py": "import asyncio\n"}, """
        [rules.sans-io]
        enabled = false
    """, None),
    ("await_atomicity_pragma_suppresses", ["await-atomicity"], {
        "distributed_tpu/scheduler/ext.py": """
        async def push(self, key):
            ts = self.state.tasks.get(key)
            await self.flush()
            # graft-lint: allow[await-atomicity] key is unforgettable here: pinned by the caller
            ts.nbytes = 1
    """}, None, None),
    ("determinism_pragma_suppresses_with_reason", ["determinism"], {
        "distributed_tpu/ops/stealing.py": """
        class SchedulerState:
            def __init__(self):
                self.saturated: set = set()

            def pick_steal_victim(self):
                # graft-lint: allow[determinism] victim choice audited order-free
                for ws in self.saturated:
                    if ws.nprocessing > 1:
                        return ws
                return None
    """}, None, None),
    ("baseline_moved_symbol_matches", ["swallowed-exceptions"],
     {"distributed_tpu/rpc/new_home.py": _DISPATCH}, None, """
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/old_home.py"
        symbol = "dispatch"
        reason = "probe path, outcome irrelevant"
    """),
    ("baseline_without_symbol_stays_on_its_path", ["swallowed-exceptions"],
     {"distributed_tpu/rpc/new_home.py": _DISPATCH}, None, """
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/old_home.py"
        reason = "probe path, outcome irrelevant"
    """),
]
CASES = [(name, [rule], files, None, None) for name, rule, files in FIXTURES] + SUPPRESSION_CASES


@pytest.mark.parametrize("name,rules,files,config,baseline", CASES, ids=[c[0] for c in CASES])
def test_fixture_parity(tmp_path, name, rules, files, config, baseline):
    """One fixture of the reference's own tests through both linters."""
    ref, port = make_pair(tmp_path, files, config, baseline)
    got_ref, got_port = both(ref, port, rules)
    assert got_port == got_ref


def test_prune_baseline_round_trip_equals_the_references(tmp_path):
    text = """\
        # graft-lint baseline — every entry argues its case.

        # probe dispatch: outcome is irrelevant by design, see rpc docs
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/disp.py"
        symbol = "dispatch"
        reason = "probe path, outcome irrelevant"

        # this one rotted: the file is long gone
        [[allow]]
        rule = "swallowed-exceptions"
        path = "distributed_tpu/rpc/gone.py"
        reason = "was real once"
    """
    ref, port = make_pair(tmp_path, {"distributed_tpu/rpc/disp.py": _DISPATCH}, baseline=text)
    pruned = []
    for root, lint, load, name in ((ref, ref_run_lint, RefBaseline.load, FILES["baseline"][0]),
                                   (port, run_lint, Baseline.load, FILES["baseline"][1])):
        baseline = load(root / name)
        assert not lint(root, baseline=baseline).findings
        pruned.append(([to_ref(d) for d in baseline.prune(root / name)],
                       to_ref((root / name).read_text())))
    assert pruned[1] == pruned[0]
    assert pruned[0][0] == ["swallowed-exceptions @ distributed_tpu/rpc/gone.py"]
    assert "gone.py" not in pruned[0][1] and "# probe dispatch" in pruned[0][1]


# -------------------------------------------------------------- launch-sync

_LAUNCHER = """
    import torch

    from distributed_tpu_torch.ops import _build


    def kernel_cuda(x, out, n: int, scale: float, causal: bool, tl=None):
        a = x.item()
        b = x.tolist()
        c = out.cpu()
        d = out.numpy()
        torch.cuda.synchronize()
        done = torch.cuda.Event()
        done.synchronize()
        e = float(x.sum())
        f = int(x[0])
        g = bool(out.any())
        return _build.launch(x.device, None, a, b, c, d, e, f, g)
"""


def _launch_sync(tmp_path, src: str, rel: str = "distributed_tpu_torch/ops/kern.py"):
    _write(tmp_path / rel, textwrap.dedent(src))
    return run_lint(tmp_path, rule_names=["launch-sync"])


def test_launch_sync_fires_on_each_sync_in_a_launcher(tmp_path):
    result = _launch_sync(tmp_path, _LAUNCHER)
    msgs = [f.message.split(" ")[0] for f in result.findings]
    assert sorted(msgs) == sorted([".item()", ".tolist()", ".cpu()", ".numpy()",
                                   "torch.cuda.synchronize()", ".synchronize()",
                                   "float()", "int()", "bool()"])
    assert {f.symbol for f in result.findings} == {"kernel_cuda"}
    assert result.exit_code == 1


def test_launch_sync_passes_a_clean_launcher(tmp_path):
    """Python scalars (annotated ``int``, ``float``, ``bool``), a tensor's
    shape and size, and an ``is`` test are host values: no sync."""
    src = """
        from distributed_tpu_torch.ops import _build


        def kernel_cuda(x, out, n: int, scale: float, causal: bool, k: int | None = None,
                        tl=None):
            rows, width = int(x.shape[0]), int(out.numel())
            flags = (int(bool(causal)), int(tl is not None), int(n), int(k or 0))
            return _build.launch(x.device, None, rows, width, float(scale), *flags,
                                 len(out), int(x.dim()))
    """
    assert not _launch_sync(tmp_path, src).findings


def test_launch_sync_ignores_a_function_that_launches_nothing(tmp_path):
    src = """
        import torch


        def plain(x, event):
            event.synchronize()
            torch.cuda.synchronize()
            return x.item(), x.cpu().numpy(), float(x), x.tolist()


        def outer(x):
            from distributed_tpu_torch.ops import _build

            def launcher(y):
                return _build.launch(y.device, None)

            return x.item(), launcher
    """
    assert not _launch_sync(tmp_path, src).findings


def test_launch_sync_keeps_to_its_scope(tmp_path):
    result = _launch_sync(tmp_path, _LAUNCHER, "distributed_tpu_torch/scheduler/server.py")
    assert not result.findings
    placement = _launch_sync(tmp_path, _LAUNCHER,
                             "distributed_tpu_torch/scheduler/torch_placement.py")
    assert len(placement.findings) == 9


@pytest.mark.parametrize("reason", ["the caller needs the count on the host", ""])
def test_launch_sync_pragma_needs_a_reason(tmp_path, reason):
    src = f"""
        from distributed_tpu_torch.ops import _build


        def kernel_cuda(x):
            # graft-lint: allow[launch-sync] {reason}
            n = x.item()
            return _build.launch(x.device, None, n)
    """
    result = _launch_sync(tmp_path, src)
    assert (len(result.findings), result.suppressed) == ((0, 1) if reason else (1, 0))


# ---------------------------------------------------------- the port's tree


def test_cli_json_clean_on_the_ports_tree():
    """The port's lint gate, run as CI runs it: the tree lints clean, with
    no stale baseline entry (so ``--prune-baseline`` would leave the
    baseline unchanged)."""
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tpu_torch.analysis", "--format", "json",
         "--root", str(REPO_ROOT)],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["findings"] == [] and report["errors"] == []
    assert report["stale_baseline"] == [] and report["suppressed"] > 0


def test_determinism_clean_on_the_ports_tree():
    result = run_lint(REPO_ROOT, rule_names=["determinism"])
    assert result.findings == [] and result.errors == []


# ------------------------------------------------------------ model parity


def _machines(ctx, pkg: str, extract) -> dict:
    mods = [ctx.module(f"{pkg}/scheduler/state.py"), ctx.module(f"{pkg}/worker/state_machine.py")]
    return {m.name: (m.states, sorted((t.start, t.finish, t.handler) for t in m.transitions))
            for m in extract(mods)}


def test_the_ports_state_machines_are_the_references():
    """Names, states, and the ``(start, finish)`` edges with their handlers
    of both machines; and pass 4's check that every arm the native engine
    compiles is an edge of the port's scheduler table."""
    ctx = LintContext(REPO_ROOT, LintConfig.load(REPO_ROOT))
    port = _machines(ctx, PORT, extract_machines)
    ref = _machines(RefContext(REPO_ROOT, RefConfig.load(REPO_ROOT)), REF, ref_extract)
    assert set(port) == {"scheduler", "worker"}
    assert port == ref
    _, arms = _compiled_arms(ctx.module(f"{PORT}/scheduler/native_engine.py").tree)
    table = {(start, finish) for start, finish, _ in port["scheduler"][1]}
    assert arms and set(arms) <= table


# ---------------------------------------------------------------------- CLI


def test_cli_list_rules(capsys):
    assert port_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    names = {line.split()[0] for line in out.splitlines() if line.strip()}
    assert names == set(SHARED) | {"launch-sync"}


def test_cli_dump_model_writes_the_references_machines(tmp_path):
    """The dumped model of the port's tree has the reference's checked-in
    machines (``docs/state_machine``): the same states and edges."""
    assert port_main(["--dump-model", str(tmp_path), "--root", str(REPO_ROOT)]) == 0
    for name in ("scheduler", "worker"):
        got = json.loads((tmp_path / f"{name}.json").read_text())
        want = json.loads((REPO_ROOT / "docs" / "state_machine" / f"{name}.json").read_text())
        assert got["module"] == to_port(want["module"])
        assert got["states"] == want["states"]
        edges = [sorted((t["start"], t["finish"], t["handler"]) for t in doc["transitions"])
                 for doc in (got, want)]
        assert edges[0] == edges[1]
        assert '"released" -> "waiting"' in (tmp_path / f"{name}.dot").read_text()


@pytest.mark.parametrize("args", [
    ["--prune-baseline", "--rule", "determinism"],
    ["--dump-model", "unused", "--rule", "state-machine"],
], ids=["prune-baseline-partial-run", "dump-model-with-rule"])
def test_cli_refuses_a_partial_run(args, tmp_path):
    with pytest.raises(SystemExit) as exc:
        port_main([*args, "--root", str(REPO_ROOT)])
    assert exc.value.code == 2
    assert not (REPO_ROOT / "unused").exists()


def test_cli_refuses_a_root_without_the_port(tmp_path, capsys):
    assert port_main(["--root", str(tmp_path)]) == 2
    assert "distributed_tpu_torch" in capsys.readouterr().err
