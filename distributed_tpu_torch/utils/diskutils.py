"""WorkSpace: managed scratch directories with stale-dir purge
(reference diskutils.py:36,112).

Each worker claims a ``WorkDir`` inside a shared ``WorkSpace`` root; a
lock file marks it owned by a live process.  On startup the workspace
purges directories whose owning pid is gone — crash leftovers don't
accumulate on shared disks.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

logger = logging.getLogger("distributed_tpu_torch.diskutils")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class WorkDir:
    """One owned scratch directory (reference diskutils.py:112)."""

    def __init__(self, workspace: "WorkSpace", name: str):
        self.workspace = workspace
        self.path = os.path.join(workspace.base_dir, name)
        os.makedirs(self.path, exist_ok=True)
        self._lock_path = self.path + ".lock"
        with open(self._lock_path, "w") as f:
            f.write(str(os.getpid()))

    def release(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)
        try:
            os.unlink(self._lock_path)
        except OSError:
            pass


class WorkSpace:
    """Root for worker scratch dirs (reference diskutils.py:36)."""

    def __init__(self, base_dir: str | None = None):
        self.base_dir = base_dir or os.path.join(
            tempfile.gettempdir(), "dtpu-workspace"
        )
        os.makedirs(self.base_dir, exist_ok=True)
        self._purge_stale()

    def _purge_stale(self) -> None:
        try:
            entries = os.listdir(self.base_dir)
        except OSError:
            return
        for entry in entries:
            if not entry.endswith(".lock"):
                continue
            lock_path = os.path.join(self.base_dir, entry)
            try:
                with open(lock_path) as f:
                    pid = int(f.read().strip() or 0)
            except (OSError, ValueError):
                continue
            if pid and not _pid_alive(pid):
                dirname = lock_path[: -len(".lock")]
                logger.info("purging stale workspace dir %s (pid %d gone)",
                            dirname, pid)
                shutil.rmtree(dirname, ignore_errors=True)
                try:
                    os.unlink(lock_path)
                except OSError:
                    pass

    def new_work_dir(self, prefix: str = "worker") -> WorkDir:
        name = f"{prefix}-{os.getpid()}-{len(os.listdir(self.base_dir))}"
        return WorkDir(self, name)
