"""User-facing plugin hook surface (reference diagnostics/plugin.py).

- ``SchedulerPlugin`` (reference :32): transition / add_worker /
  remove_worker / add_client / remove_client / update_graph / log_event
  hooks, registered live via ``Client.register_plugin``
- ``WorkerPlugin`` (reference :212): setup / teardown / transition
- ``NannyPlugin`` (reference :302): setup / teardown around the worker
  subprocess

Built-ins mirror the reference's: ``Environ`` (:852), ``UploadFile``
(:738), ``UploadDirectory`` (:863), ``ForwardOutput`` (:992),
``ForwardLoggingPlugin`` (:771), ``PipInstall`` (:637), and the
``KillWorker`` chaos plugin (chaos.py:14).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import sys
from typing import Any

logger = logging.getLogger("distributed_tpu_torch.plugins")


class SchedulerPlugin:
    """Extend the scheduler (reference diagnostics/plugin.py:32)."""

    name: str | None = None

    async def start(self, scheduler: Any) -> None: ...
    async def close(self) -> None: ...
    def update_graph(self, scheduler: Any, **kwargs: Any) -> None: ...
    def transition(self, key: str, start: str, finish: str,
                   *args: Any, **kwargs: Any) -> None: ...
    def add_worker(self, scheduler: Any, worker: str) -> None: ...
    def remove_worker(self, scheduler: Any, worker: str) -> None: ...
    def add_client(self, scheduler: Any, client: str) -> None: ...
    def remove_client(self, scheduler: Any, client: str) -> None: ...
    def log_event(self, topic: str, msg: Any) -> None: ...


class WorkerPlugin:
    """Extend every worker (reference diagnostics/plugin.py:212)."""

    name: str | None = None

    def setup(self, worker: Any) -> None: ...
    def teardown(self, worker: Any) -> None: ...
    def transition(self, key: str, start: str, finish: str,
                   **kwargs: Any) -> None: ...


class NannyPlugin:
    """Extend every nanny (reference diagnostics/plugin.py:302)."""

    name: str | None = None
    restart = False

    def setup(self, nanny: Any) -> None: ...
    def teardown(self, nanny: Any) -> None: ...


# ------------------------------------------------------------- built-ins


class Environ(WorkerPlugin):
    """Set environment variables on every worker (reference plugin.py:852)."""

    name = "environ"

    def __init__(self, environ: dict | None = None):
        self.environ = {k: str(v) for k, v in (environ or {}).items()}

    def setup(self, worker: Any) -> None:
        os.environ.update(self.environ)


class UploadFile(WorkerPlugin):
    """Ship a local file to every worker (reference plugin.py:738)."""

    name = "upload-file"

    def __init__(self, filepath: str, load: bool = True):
        self.filename = os.path.basename(filepath)
        self.load = load
        with open(filepath, "rb") as f:
            self.data = f.read()

    def setup(self, worker: Any) -> None:
        path = os.path.join(os.getcwd(), self.filename)
        with open(path, "wb") as f:
            f.write(self.data)
        if self.load and self.filename.endswith((".py", ".zip", ".egg")):
            directory = os.path.dirname(path) or os.getcwd()
            if directory not in sys.path:
                sys.path.insert(0, directory)
            if self.filename.endswith(".py"):
                import importlib

                modname = self.filename[:-3]
                if modname in sys.modules:
                    importlib.reload(sys.modules[modname])
                else:
                    importlib.import_module(modname)


class UploadDirectory(NannyPlugin):
    """Ship a whole local directory tree to every worker (reference
    plugin.py:863).  The directory is zipped client-side at construction
    (``__pycache__`` and ``.git`` pruned), unpacked under the node's
    working directory, and optionally put on ``sys.path`` so uploaded
    packages import.

    A NannyPlugin like the reference's, with ``restart=True`` (also like
    the reference): the nanny cycles its worker subprocess after setup,
    so the NEW worker process starts with the files on disk and imports
    them fresh — extracting in the nanny alone would never reach an
    already-running child interpreter.  On nanny-less clusters register
    with ``nanny=False``: ``setup`` only needs an object with a
    ``local_directory``, so the same instance works as a worker plugin
    (``Client.register_plugin(UploadDirectory(p), nanny=False)``).
    """

    name = "upload-directory"
    restart = True

    def __init__(self, path: str, update_path: bool = True,
                 restart: bool = True,
                 skip_words: tuple = ("__pycache__", ".git", ".github",
                                      ".pytest_cache", "tests.egg-info")):
        import io
        import zipfile

        path = os.path.abspath(path)
        self.dirname = os.path.basename(path.rstrip(os.sep))
        self.update_path = update_path
        self.restart = restart
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for root, dirs, files in os.walk(path):
                dirs[:] = [d for d in dirs if d not in skip_words]
                for fn in files:
                    full = os.path.join(root, fn)
                    rel = os.path.join(
                        self.dirname, os.path.relpath(full, path)
                    )
                    z.write(full, rel)
        self.data = buf.getvalue()

    def setup(self, nanny: Any = None, worker: Any = None) -> None:
        # dual-role: nannies call setup(nanny=...), workers (nanny=False
        # registration) call setup(worker=...)
        import io
        import zipfile

        node = nanny if nanny is not None else worker
        base = getattr(node, "local_directory", None) or os.getcwd()
        os.makedirs(base, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(self.data)) as z:
            z.extractall(base)
        if self.update_path and base not in sys.path:
            sys.path.insert(0, base)


class ForwardOutput(WorkerPlugin):
    """Forward the worker's stdout/stderr to clients (reference
    plugin.py:992 ``ForwardOutput``).

    Wraps ``sys.stdout``/``sys.stderr`` with a tee that both writes
    through locally and ships complete lines to the scheduler event log
    under the ``"print"`` topic; ``Client.subscribe_topic("print", ...)``
    (or the default event stream) surfaces task ``print()`` output at
    the client, which is how users debug remote tasks.

    NOTE: streams are process-global.  With an in-process LocalCluster
    every worker shares one interpreter, so register this on a single
    worker (the reference has the same constraint and warns about
    duplicated output); nanny/process workers each own their streams.
    """

    name = "forward-output"

    def __init__(self, topic: str = "print"):
        self.topic = topic
        self._saved: tuple | None = None

    def setup(self, worker: Any) -> None:
        plugin = self
        # task print() runs on executor threads; BatchedSend.send wakes
        # an asyncio.Event, which is only safe from the loop thread —
        # hop every line through call_soon_threadsafe
        loop = asyncio.get_event_loop()
        import threading

        class _Tee:
            def __init__(self, inner: Any, stream: str) -> None:
                self._inner = inner
                self._stream = stream
                self._buf = ""
                # concurrent print() from several executor threads: the
                # read-split-assign on _buf is not atomic under the GIL
                self._lock = threading.Lock()

            def _send(self, line: str) -> None:
                try:
                    worker.batched_stream.send({
                        "op": "log-event",
                        "topic": plugin.topic,
                        "msg": {"stream": self._stream, "text": line,
                                "worker": worker.address},
                    })
                except Exception:
                    pass

            def write(self, data: str) -> int:
                n = self._inner.write(data)
                lines = []
                with self._lock:
                    self._buf += data
                    while "\n" in self._buf:
                        line, self._buf = self._buf.split("\n", 1)
                        lines.append(line)
                for line in lines:
                    try:
                        loop.call_soon_threadsafe(self._send, line)
                    except RuntimeError:
                        pass  # loop closed mid-shutdown
                return n

            def flush(self) -> None:
                self._inner.flush()
                # an explicit flush is the user saying "ship it now":
                # forward any unterminated partial line (print(end=''),
                # progress bars) instead of holding it forever
                with self._lock:
                    pending, self._buf = self._buf, ""
                if pending:
                    try:
                        loop.call_soon_threadsafe(self._send, pending)
                    except RuntimeError:
                        pass

            def __getattr__(self, name: str) -> Any:
                return getattr(self._inner, name)

        self._saved = (sys.stdout, sys.stderr)
        self._tees = (_Tee(sys.stdout, "stdout"), _Tee(sys.stderr, "stderr"))
        sys.stdout, sys.stderr = self._tees  # type: ignore[assignment]

    def teardown(self, worker: Any) -> None:
        if self._saved is not None:
            for tee in self._tees:
                tee.flush()  # ship any unterminated partial line
            # only unwind if OUR tee is still installed: with several
            # in-process workers each wrapping in turn, blindly restoring
            # the saved streams would clobber a later plugin's tee (or
            # resurrect an earlier one)
            if sys.stdout is self._tees[0]:
                sys.stdout = self._saved[0]
            if sys.stderr is self._tees[1]:
                sys.stderr = self._saved[1]
            self._saved = None


class ForwardLoggingPlugin(WorkerPlugin):
    """Forward worker log records to the scheduler event log
    (reference plugin.py:771)."""

    name = "forward-logging"

    def __init__(self, logger_name: str = "", level: int = logging.WARNING):
        self.logger_name = logger_name
        self.level = level
        self._handler: logging.Handler | None = None

    def setup(self, worker: Any) -> None:
        plugin = self

        class _Handler(logging.Handler):
            def emit(self, record: logging.LogRecord) -> None:
                try:
                    worker.batched_stream.send(
                        {
                            "op": "log-event",
                            "topic": "forwarded-log",
                            "msg": {
                                "name": record.name,
                                "level": record.levelname,
                                "message": record.getMessage(),
                            },
                        }
                    )
                except Exception:
                    pass

        self._handler = _Handler(level=self.level)
        logging.getLogger(self.logger_name).addHandler(self._handler)

    def teardown(self, worker: Any) -> None:
        if self._handler is not None:
            logging.getLogger(self.logger_name).removeHandler(self._handler)


async def _run_install(argv: list[str], what: str) -> None:
    """Shared soft-failing installer body for PipInstall/CondaInstall:
    the reference keeps a worker whose environment update failed alive
    and serving (plugin.py:637,548) — so a nonzero exit OR a missing
    installer binary logs and returns."""
    import subprocess

    try:
        proc = await asyncio.get_running_loop().run_in_executor(
            None,
            lambda: subprocess.run(argv, capture_output=True),
        )
    except OSError as e:  # installer binary absent
        logger.error("%s install failed: %r", what, e)
        return
    if proc.returncode != 0:
        logger.error(
            "%s install failed: %s", what, proc.stderr.decode()[-1000:]
        )


class PipInstall(WorkerPlugin):
    """pip-install packages on every worker (reference plugin.py:637)."""

    name = "pip-install"

    def __init__(self, packages: list[str], pip_options: list[str] | None = None,
                 restart_workers: bool = False):
        if restart_workers:
            raise NotImplementedError(
                "restart_workers is not supported yet; restart via the "
                "nanny (scheduler.retire_workers + Nanny.restart) instead"
            )
        self.packages = list(packages)
        self.pip_options = list(pip_options or [])

    async def setup(self, worker: Any) -> None:
        await _run_install(
            [sys.executable, "-m", "pip", "install", *self.pip_options,
             *self.packages],
            "pip",
        )


class CondaInstall(WorkerPlugin):
    """conda-install packages on every worker (reference plugin.py:548).

    Same shape as PipInstall; uses ``conda install --yes`` (or mamba
    when ``use_mamba``).  Fails soft with a logged error, like the
    reference: a worker whose environment update failed keeps serving.
    """

    name = "conda-install"

    def __init__(self, packages: list[str],
                 conda_options: list[str] | None = None,
                 use_mamba: bool = False):
        self.packages = list(packages)
        self.conda_options = list(conda_options or [])
        self.use_mamba = use_mamba

    async def setup(self, worker: Any) -> None:
        exe = "mamba" if self.use_mamba else "conda"
        await _run_install(
            [exe, "install", "--yes", *self.conda_options, *self.packages],
            exe,
        )


class KillWorker(WorkerPlugin):
    """Chaos: kill the worker on an exponential clock (reference chaos.py:14).

    mode 'sys.exit' raises SystemExit in the worker process, 'graceful'
    closes it cleanly, 'segfault' dies hard.
    """

    name = "kill-worker"

    def __init__(self, delay: float = 1.0, mode: str = "sys.exit"):
        assert mode in ("sys.exit", "graceful", "segfault")
        self.delay = delay
        self.mode = mode

    def setup(self, worker: Any) -> None:
        delay = random.expovariate(1 / self.delay)
        worker._ongoing_background_tasks.call_later(delay, self._kill, worker)

    async def _kill(self, worker: Any) -> None:
        logger.warning("KillWorker firing (%s) on %s", self.mode, worker.address)
        if self.mode == "graceful":
            await worker.close()
        elif self.mode == "sys.exit":
            os._exit(1)
        else:  # segfault
            import ctypes

            ctypes.string_at(0)
