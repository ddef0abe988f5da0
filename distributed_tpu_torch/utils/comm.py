"""Bulk data-movement helpers (reference utils_comm.py).

``gather_from_workers`` pulls keys from many workers with per-source
failover; ``scatter_to_workers`` pushes data round-robin; ``retry_operation``
wraps flaky comm calls with configured backoff.
"""

from __future__ import annotations

import asyncio
import logging
import random
from collections import defaultdict
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.exceptions import CommClosedError

logger = logging.getLogger("distributed_tpu_torch.utils.comm")


from distributed_tpu_torch.protocol.serialize import unwrap as _unwrap

# busy-holder retry: exponential backoff from BASE capped at MAX, for at
# most ROUNDS_MAX all-busy rounds.  Module constants so tests can shrink
# the waits.
BUSY_BACKOFF_BASE = 0.05
BUSY_BACKOFF_MAX = 5.0
BUSY_ROUNDS_MAX = 12


async def gather_from_workers(
    who_has: dict[str, list[str]],
    rpc: Callable,
) -> tuple[dict[str, Any], set[str], set[str], list[str]]:
    """Fetch ``{key: [workers]}`` from the cluster (reference utils_comm.py:56).

    Returns ``(data, missing_keys, busy_keys, failed_workers)``.  Tries
    alternative holders for a key when a worker is unreachable or no
    longer has it.  ``busy_keys`` are held by live-but-saturated workers
    after the round budget ran out: the data EXISTS — callers refresh
    ``who_has`` and retry at their level (Scheduler.gather does) instead
    of surfacing a data-loss error for it.
    """
    data: dict[str, Any] = {}
    missing: set[str] = set()
    busy: set[str] = set()
    failed_workers: set[str] = set()
    busy_rounds = 0
    remaining: dict[str, list[str]] = {
        k: list(ws) for k, ws in who_has.items() if ws
    }
    missing.update(k for k, ws in who_has.items() if not ws)

    busy_workers: set[str] = set()
    while remaining:
        # group this round's fetches by worker; a holder that answered
        # busy last round is picked only when no other holder exists
        by_worker: dict[str, list[str]] = defaultdict(list)
        for key, holders in list(remaining.items()):
            holders = [w for w in holders if w not in failed_workers]
            if not holders:
                missing.add(key)
                del remaining[key]
                continue
            fresh = [w for w in holders if w not in busy_workers]
            by_worker[random.choice(fresh or holders)].append(key)
        if not by_worker:
            break

        async def fetch(worker: str, keys: list[str]):
            try:
                resp = await rpc(worker).get_data(keys=keys, who=None)
            except (OSError, CommClosedError, asyncio.TimeoutError):
                return worker, None
            return worker, resp

        results = await asyncio.gather(
            *(fetch(w, ks) for w, ks in by_worker.items())
        )
        any_busy = False
        progressed = False
        busy_workers = set()
        for worker, resp in results:
            keys = by_worker[worker]
            if resp is None:
                failed_workers.add(worker)
                for k in keys:
                    remaining[k] = [w for w in remaining.get(k, []) if w != worker]
                continue
            if resp.get("status") == "busy":
                # over its outgoing-serve limit: the holder still has
                # the data — keep it and retry next round
                any_busy = True
                busy_workers.add(worker)
                continue
            got = resp.get("data", {})
            for k in keys:
                if k in got:
                    data[k] = _unwrap(got[k])
                    remaining.pop(k, None)
                    progressed = True
                else:
                    # holder no longer has it; drop this holder and retry
                    remaining[k] = [w for w in remaining.get(k, []) if w != worker]
                    if not remaining[k]:
                        missing.add(k)
                        remaining.pop(k, None)
        if any_busy and not progressed:
            busy_rounds += 1
            if busy_rounds > BUSY_ROUNDS_MAX:
                # ~30s of capped exponential backoff exhausted.  The
                # holders are alive but saturated (or dying and lying):
                # hand the keys back as BUSY — distinct from missing,
                # because the data exists — so the caller can refresh
                # who_has and retry at its level.  Retrying here forever
                # (the reference's behavior) wedges this coroutine when
                # a closing worker keeps answering busy (ADVICE.md #1 /
                # chaos soak).
                busy.update(remaining)
                break
            await asyncio.sleep(
                min(BUSY_BACKOFF_BASE * 2**busy_rounds, BUSY_BACKOFF_MAX)
            )
        else:
            busy_rounds = 0
    return data, missing, busy, sorted(failed_workers)


async def scatter_to_workers(
    workers: list[str],
    data: dict[str, Any],
    rpc: Callable,
) -> dict[str, list[str]]:
    """Round-robin ``data`` onto ``workers``; returns ``{key: [worker]}``.

    Values arriving from a deserialize=False server (the scheduler) are
    already opaque frames: wrap_opaque forwards them verbatim rather
    than pickling the wrapper object a second time."""
    from distributed_tpu_torch.protocol.serialize import OPAQUE_TYPES, Serialize

    assert workers
    placements: dict[str, dict[str, Any]] = defaultdict(dict)
    for i, (key, value) in enumerate(data.items()):
        if not isinstance(value, OPAQUE_TYPES):
            value = Serialize(value)  # raw: family dispatch (numpy zero-copy)
        placements[workers[i % len(workers)]][key] = value

    async def push(worker: str, chunk: dict):
        await rpc(worker).update_data(data=chunk, report=False)
        return worker, list(chunk)

    results = await asyncio.gather(*(push(w, c) for w, c in placements.items()))
    who_has: dict[str, list[str]] = {}
    for worker, keys in results:
        for k in keys:
            who_has.setdefault(k, []).append(worker)
    return who_has


async def retry_operation(coro_factory: Callable, *args: Any, **kwargs: Any) -> Any:
    """Retry a flaky comm operation per the ``comm.retry`` config
    (reference utils_comm.py:380)."""
    count = config.get("comm.retry.count", 0)
    delay_min = config.parse_timedelta(config.get("comm.retry.delay.min", "1s"))
    delay_max = config.parse_timedelta(config.get("comm.retry.delay.max", "20s"))
    for attempt in range(count + 1):
        try:
            return await coro_factory(*args, **kwargs)
        except (OSError, CommClosedError, asyncio.TimeoutError):
            if attempt == count:
                raise
            delay = min(delay_min * (2**attempt), delay_max)
            delay *= 1 + random.random() * 0.2
            logger.info("retrying after comm failure (attempt %d)", attempt + 1)
            await asyncio.sleep(delay)
