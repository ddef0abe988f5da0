"""Discrete-event heap: the simulator's only scheduler of work.

A plain ``heapq`` of ``(time, seq, fn)`` triples.  ``seq`` is a
monotone insertion counter, so events at the same instant pop in
insertion (FIFO) order — ties never fall through to comparing
callables, and two same-seed runs pop the identical sequence.
"""

from __future__ import annotations

import heapq
from typing import Callable


class EventHeap:
    __slots__ = ("_heap", "_seq", "popped")

    def __init__(self):
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.popped = 0  # events executed over the heap's lifetime

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` to run at virtual time ``t``."""
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (t, seq, fn))

    def pop(self) -> tuple[float, Callable[[], None]]:
        t, _seq, fn = heapq.heappop(self._heap)
        self.popped += 1
        return t, fn

    def peek_time(self) -> float:
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
