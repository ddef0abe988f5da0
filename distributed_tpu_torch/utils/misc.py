"""General utilities.

Covers the reference's ``distributed/utils.py`` surface that the rest of the
framework needs: monotonic ``time()`` (metrics.py), ``Deadline``, ``sync``
(thread<->loop bridge), ``log_errors``, ``offload`` (dedicated serialization
thread, utils.py), key stringification, ip/port helpers, and
``recursive_to_dict`` debug dumps.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import inspect
import logging
import os
import socket
import threading
import traceback
from collections.abc import Callable, Iterable
from time import monotonic as time  # noqa: F401  (monotonic clock, like metrics.time)
from time import time as wall_clock  # noqa: F401
from typing import Any, TypeVar

logger = logging.getLogger("distributed_tpu_torch")

T = TypeVar("T")

no_default = "__no_default__"


class Deadline:
    """Utility to measure time to a deadline (reference utils.py Deadline)."""

    def __init__(self, expires_at: float | None):
        self.started_at = time()
        self.expires_at = expires_at

    @classmethod
    def after(cls, duration: float | None) -> Deadline:
        return cls(None if duration is None else time() + duration)

    @property
    def expired(self) -> bool:
        return self.expires_at is not None and time() >= self.expires_at

    @property
    def remaining(self) -> float | None:
        if self.expires_at is None:
            return None
        return max(0.0, self.expires_at - time())

    @property
    def elapsed(self) -> float:
        return time() - self.started_at


def log_errors(func: Callable[..., T]) -> Callable[..., T]:
    """Log-and-reraise decorator for handler coroutines/functions."""

    if inspect.iscoroutinefunction(func):

        @functools.wraps(func)
        async def wrapper(*args, **kwargs):
            try:
                return await func(*args, **kwargs)
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception:
                logger.exception("Error in %s", getattr(func, "__name__", func))
                raise

        return wrapper  # type: ignore

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception:
            logger.exception("Error in %s", getattr(func, "__name__", func))
            raise

    return wrapper  # type: ignore


# -- offload: run CPU-heavy (de)serialization off the event loop -------------

_offload_executor = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="DTPU-Offload"
)


async def offload(fn: Callable[..., T], *args: Any, **kwargs: Any) -> T:
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        _offload_executor, functools.partial(fn, *args, **kwargs)
    )


# -- sync: call a coroutine on a loop running in another thread --------------

def sync(loop: asyncio.AbstractEventLoop, coro_fn, *args, timeout=None, **kwargs):
    """Run ``coro_fn(*args, **kwargs)`` on ``loop`` from a foreign thread."""
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        raise RuntimeError("sync() called from the event loop thread")
    coro = coro_fn(*args, **kwargs)
    if timeout is not None:
        coro = asyncio.wait_for(coro, timeout)
    fut = asyncio.run_coroutine_threadsafe(coro, loop)
    return fut.result()


class LoopRunner:
    """Own an asyncio loop on a daemon thread (for the sync Client shell)."""

    def __init__(self) -> None:
        self.loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._lock = threading.Lock()

    def start(self) -> asyncio.AbstractEventLoop:
        with self._lock:
            if self.loop is not None and self._thread and self._thread.is_alive():
                return self.loop

            self._started.clear()

            def run() -> None:
                loop = asyncio.new_event_loop()
                self.loop = loop
                asyncio.set_event_loop(loop)
                self._started.set()
                loop.run_forever()
                loop.close()

            self._thread = threading.Thread(
                target=run, name="DTPU-LoopRunner", daemon=True
            )
            self._thread.start()
            self._started.wait()
            assert self.loop is not None
            return self.loop

    def run_sync(self, coro_fn, *args, timeout=None, **kwargs):
        loop = self.start()
        coro = coro_fn(*args, **kwargs)
        if timeout is not None:
            coro = asyncio.wait_for(coro, timeout)
        return asyncio.run_coroutine_threadsafe(coro, loop).result()

    def stop(self) -> None:
        if self.loop is not None and self._thread and self._thread.is_alive():
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
        self.loop = None
        self._thread = None


# -- misc --------------------------------------------------------------------

def key_split(key: str) -> str:
    """'x-123-abc' -> 'x'; "('x', 0, 1)" -> 'x'.  Reference: dask.utils.key_split.

    Cached: prefixes are recomputed for the same key at several points
    of a task's life (scheduler group, worker metrics, spans) and the
    string scan is pure."""
    try:
        return _key_split_cache[key]
    except KeyError:
        pass
    except TypeError:  # unhashable (lists in composite keys): compute raw
        return _key_split_uncached(key)
    out = _key_split_uncached(key)
    if len(_key_split_cache) >= 65536:
        _key_split_cache.clear()
    _key_split_cache[key] = out
    return out


_key_split_cache: dict = {}


def _key_split_uncached(key: str) -> str:
    if isinstance(key, bytes):
        key = key.decode()
    if isinstance(key, tuple):
        key = key[0]
    try:
        if key.startswith("('") or key.startswith('("'):
            return key.split(",", 1)[0].strip("('\")")
        words = str(key).split("-")
        # drop trailing uuid/hash/number chunks
        result = [words[0]]
        for w in words[1:]:
            if w.isalpha() and not (len(w) in (8, 16, 32, 40, 64) and _ishex(w)):
                result.append(w)
            else:
                break
        return "-".join(result)
    except Exception:
        return str(key)


def _ishex(s: str) -> bool:
    return all(c in "0123456789abcdef" for c in s)


class RateLimiterFilter:
    """Logging filter dropping repeats of matching records within a
    window (reference utils.py RateLimiterFilter).  Attach to loggers
    that can storm — per-comm connection failures during a netsplit
    would otherwise emit thousands of identical lines."""

    def __init__(self, pattern: str, rate: float = 10.0):
        import re

        self._pattern = re.compile(pattern)
        self.rate = rate  # seconds between emissions
        self._last = 0.0

    def filter(self, record) -> bool:
        if not self._pattern.search(record.getMessage()):
            return True
        now = time()
        if now - self._last >= self.rate:
            self._last = now
            return True
        return False


def funcname(func: Any) -> str:
    while hasattr(func, "func"):
        func = func.func
    return getattr(func, "__name__", str(func))


def truncate_exception(e: BaseException, n: int = 10_000) -> BaseException:
    if len(str(e)) > n:
        try:
            return type(e)("Long error message", str(e)[:n])
        except Exception:
            return Exception("Long error message", str(e)[:n])
    return e


def format_exception(e: BaseException) -> str:
    return "".join(traceback.format_exception(type(e), e, e.__traceback__))


def get_ip() -> str:
    """Best-effort non-loopback IP of this host."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.settimeout(0)
            sock.connect(("8.8.8.8", 80))
            return sock.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def open_port(host: str = "") -> int:
    """Find and return an open port (racy, but fine for tests/local)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def recursive_to_dict(obj: Any, *, exclude: Iterable[str] = (), members: bool = False) -> Any:
    """Debug dump: recursively convert objects to JSON-friendly structures."""
    if isinstance(obj, (int, float, str, bool, type(None))):
        return obj
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [recursive_to_dict(o, exclude=exclude) for o in obj]
    if isinstance(obj, dict):
        return {str(k): recursive_to_dict(v, exclude=exclude) for k, v in obj.items()}
    if hasattr(obj, "_to_dict"):
        return obj._to_dict(exclude=exclude)
    if members or hasattr(obj, "__dict__"):
        try:
            return {
                k: recursive_to_dict(v, exclude=exclude)
                for k, v in vars(obj).items()
                if k not in exclude and not k.startswith("_")
            }
        except TypeError:
            pass
    return repr(obj)


class TimeWindow:
    """Exponentially-smoothed scalar (bandwidth estimates etc.)."""

    def __init__(self, initial: float, alpha: float = 0.3):
        self.value = initial
        self.alpha = alpha

    def update(self, sample: float) -> float:
        self.value = self.alpha * sample + (1 - self.alpha) * self.value
        return self.value


def import_term(name: str) -> Any:
    """'package.module.ClassName' -> the object."""
    import importlib

    if "." not in name:
        return importlib.import_module(name)
    module_name, attr = name.rsplit(".", 1)
    try:
        module = importlib.import_module(module_name)
        return getattr(module, attr)
    except (ImportError, AttributeError):
        return importlib.import_module(name)


def iscoroutinefunction(f: Any) -> bool:
    while isinstance(f, functools.partial):
        f = f.func
    return inspect.iscoroutinefunction(f)


def ensure_bytes(b: Any) -> bytes:
    if isinstance(b, bytes):
        return b
    if isinstance(b, (bytearray, memoryview)):
        return bytes(b)
    raise TypeError(f"cannot convert {type(b)} to bytes")


def nbytes_of(frame: Any) -> int:
    if isinstance(frame, memoryview):
        return frame.nbytes
    return len(frame)


_name_counters: dict[str, int] = {}
_name_lock = threading.Lock()


def seq_name(prefix: str) -> str:
    """Process-unique sequential names: 'Worker-0', 'Worker-1', ..."""
    with _name_lock:
        n = _name_counters.get(prefix, 0)
        _name_counters[prefix] = n + 1
    return f"{prefix}-{n}"


def pid() -> int:
    return os.getpid()
