"""Client-side progress reporting (reference diagnostics/progressbar.py).

``progress(futures)`` renders a live text bar until the given futures
settle.  Where the reference streams per-group counts from a scheduler
plugin over a dedicated comm, the client here already tracks every
future's terminal state on its report stream (client.py _handle_report),
so progress is derived locally: zero extra scheduler load, exact counts.

    futs = client.map(fn, range(100))
    await progress(futs)            # async contexts
    progress_sync(client, futs)     # blocking scripts
"""

from __future__ import annotations

import asyncio
import sys
from typing import Any

from distributed_tpu_torch.utils.misc import time

_BAR_WIDTH = 30


def _counts(client: Any, futures: list) -> tuple[int, int, int]:
    """(done, erred, total) from the client's local future states."""
    done = erred = 0
    for f in futures:
        st = client.futures.get(f.key)
        if st is None:  # released/forgotten counts as settled
            done += 1
        elif st.status == "finished":
            done += 1
        elif st.status in ("error", "cancelled", "lost"):
            erred += 1
    return done, erred, len(futures)


def _render(done: int, erred: int, total: int, elapsed: float,
            file: Any) -> None:
    settled = done + erred
    frac = settled / max(total, 1)
    filled = int(frac * _BAR_WIDTH)
    bar = "#" * filled + "-" * (_BAR_WIDTH - filled)
    err = f" {erred} erred" if erred else ""
    file.write(
        f"\r[{bar}] {settled}/{total}{err} | {elapsed:4.1f}s"
    )
    file.flush()


async def progress(
    futures: Any,
    *,
    client: Any | None = None,
    interval: float = 0.1,
    file: Any = None,
    timeout: float | None = None,
) -> None:
    """Render a live progress bar until every future settles
    (reference progressbar.py TextProgressBar.run).

    ``client`` defaults to the futures' owning client; ``file`` to
    stderr.  Raises ``asyncio.TimeoutError`` if ``timeout`` elapses.
    """
    from distributed_tpu_torch.client.client import _collect_futures

    flat: list = []
    _collect_futures(futures, flat)
    if not flat:
        return
    c = client or flat[0].client
    out = file or sys.stderr
    start = time()
    deadline = start + timeout if timeout else None
    while True:
        done, erred, total = _counts(c, flat)
        _render(done, erred, total, time() - start, out)
        if done + erred >= total:
            out.write("\n")
            out.flush()
            return
        if deadline and time() > deadline:
            out.write("\n")
            raise asyncio.TimeoutError(
                f"progress: {total - done - erred} futures still pending"
            )
        await asyncio.sleep(interval)


def progress_sync(client: Any, futures: Any, **kwargs: Any) -> None:
    """Blocking facade over :func:`progress` for sync scripts, driven on
    the client's loop thread (reference progressbar.py progress())."""
    client.sync(progress, futures, client=client, **kwargs)
