"""Specialized collections.

Equivalents of the reference's ``distributed/collections.py``: ``HeapSet``
(priority heap with set semantics backing the scheduler queue and worker
ready-heaps, collections.py:34), ``LRU``, and ``sum_mappings``.
"""

from __future__ import annotations

import heapq
import weakref
from collections import OrderedDict
from collections.abc import Callable, Iterator, Mapping
from typing import Any, Generic, TypeVar

T = TypeVar("T")


class HeapSet(Generic[T]):
    """A set whose elements pop in priority order.

    ``key(el)`` must return a totally-ordered priority; lower pops first.
    Membership, add and discard are O(1)/O(log n); stale heap entries are
    lazily skipped on pop/peek (same design as the reference's HeapSet).

    Contract: an element's priority is snapshotted at ``add`` time.  If
    it must change while the element is in the set, ``remove`` then
    ``add`` it — each element's LATEST add is the only live heap entry
    (a per-element token invalidates older ones), so re-adds reorder
    correctly in both directions.
    """

    def __init__(self, *, key: Callable[[T], Any]):
        self.key = key
        self._data: set[T] = set()
        self._heap: list[tuple[Any, int, Any]] = []
        self._inc = 0
        self._token: dict[T, int] = {}  # element -> inc of its live entry

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, el: object) -> bool:
        return el in self._data

    def __bool__(self) -> bool:
        return bool(self._data)

    def __repr__(self) -> str:
        return f"<HeapSet: {len(self)} items>"

    def add(self, el: T) -> None:
        if el in self._data:
            return
        self._inc += 1
        self._data.add(el)
        self._token[el] = self._inc
        try:
            ref: Any = weakref.ref(el)
        except TypeError:
            ref = lambda el=el: el  # noqa: E731
        heapq.heappush(self._heap, (self.key(el), self._inc, ref))

    def discard(self, el: T) -> None:
        self._data.discard(el)
        self._token.pop(el, None)
        if not self._data:
            self._heap.clear()
        elif len(self._heap) > 2 * len(self._data) + 64:
            self._prune()

    def _live(self, inc: int, ref: Any) -> "T | None":
        """Resolve a heap entry to its element iff it is the element's
        LATEST add (stale entries from remove+add must lose, or an old
        smaller priority would shadow a deprioritization)."""
        el = ref()
        if el is not None and self._token.get(el) == inc:
            return el
        return None

    def _prune(self) -> None:
        """Drop stale heap entries so churn doesn't pin discarded elements."""
        live = [
            entry for entry in self._heap
            if self._live(entry[1], entry[2]) is not None
        ]
        heapq.heapify(live)
        self._heap = live

    def remove(self, el: T) -> None:
        if el not in self._data:
            raise KeyError(el)
        self.discard(el)

    def peek(self) -> T:
        if not self._data:
            raise KeyError("peek into empty set")
        while True:
            el = self._live(self._heap[0][1], self._heap[0][2])
            if el is not None:
                return el
            heapq.heappop(self._heap)

    def pop(self) -> T:
        if not self._data:
            raise KeyError("pop from an empty set")
        while True:
            _, inc, ref = heapq.heappop(self._heap)
            el = self._live(inc, ref)
            if el is not None:
                self._data.discard(el)
                self._token.pop(el, None)
                return el

    def popright(self) -> T:
        """Pop the *largest* priority element (linear scan; used rarely)."""
        if not self._data:
            raise KeyError("pop from an empty set")
        el = max(self._data, key=self.key)
        self.discard(el)
        return el

    def peekn(self, n: int) -> Iterator[T]:
        """Iterate over the n smallest elements without removing them.

        Non-destructive: the caller may add/discard freely while iterating.

        Reuses the priorities already stored in the heap — a key-function
        scan of the whole set here (heapq.nsmallest over _data) showed up
        as the scheduler's single hottest line, because this runs with
        n = open slots on EVERY task completion while the queue is long.
        """
        if n <= 0 or not self._data:
            return iter(())
        if n == 1:
            return iter((self.peek(),))
        # lazy frontier walk over the heap ARRAY (children of index i are
        # at 2i+1 / 2i+2): visits O(n + stale) entries with a tiny aux
        # heap instead of copying the whole O(Q) heap per call — this
        # runs on EVERY task completion while the queue is long
        h = self._heap
        out: list[T] = []
        frontier: list[tuple[Any, int, int, Any]] = []  # (prio, inc, idx, ref)
        if h:
            prio, inc, ref = h[0]
            frontier.append((prio, inc, 0, ref))
        while frontier and len(out) < n:
            _, inc, i, ref = heapq.heappop(frontier)
            el = self._live(inc, ref)
            if el is not None:
                out.append(el)
            for c in (2 * i + 1, 2 * i + 2):
                if c < len(h):
                    prio, cinc, cref = h[c]
                    heapq.heappush(frontier, (prio, cinc, c, cref))
        return iter(out)

    def sorted(self) -> list[T]:
        return sorted(self._data, key=self.key)

    def __iter__(self) -> Iterator[T]:
        return iter(self._data)

    def clear(self) -> None:
        self._data.clear()
        self._heap.clear()
        self._token.clear()


class OrderedSet(dict):
    """A set with deterministic, insertion-ordered iteration.

    The scheduler's task relation fields (``dependencies`` /
    ``dependents`` / ``waiters`` / ``waiting_on`` / ``who_has``) use
    this instead of ``set``: the transition engine's recommendation
    order — and therefore steal/placement tie-breaks, message emission
    order and the simulator's event order — derive from iterating these
    collections, and built-in ``set`` iteration order depends on
    ``PYTHONHASHSEED``.  Insertion order makes the whole control plane
    deterministic ACROSS processes (the sim's same-seed contract was
    previously per-process only) and is what lets the native engine
    (``scheduler/native_engine.py``) mirror the exact order in plain
    C++ vectors.

    Implemented as a ``dict`` subclass mapping every element to None so
    membership, iteration, and len run at C speed on the engine hot
    path (a wrapper object cost ~1µs/op there).  Semantics match dict
    keys: re-adding a present element keeps its position; discard
    preserves the order of the rest; removing then re-adding appends at
    the end.  NOTE ``pop`` is dict.pop (by element), not set.pop.
    """

    __slots__ = ()

    def __init__(self, items: "Iterator[T] | None" = None):
        super().__init__()
        if items is not None:
            for el in items:
                dict.__setitem__(self, el, None)

    def add(self, el: T) -> None:
        dict.__setitem__(self, el, None)

    def discard(self, el: T) -> None:
        dict.pop(self, el, None)

    def remove(self, el: T) -> None:
        dict.__delitem__(self, el)

    def update(self, items: "Iterator[T]") -> None:  # type: ignore[override]
        for el in items:
            dict.__setitem__(self, el, None)

    def copy(self) -> "OrderedSet[T]":  # type: ignore[override]
        return OrderedSet(self)

    def difference(self, *others: Any) -> "OrderedSet[T]":
        out = OrderedSet(self)
        for other in others:
            for el in other:
                dict.pop(out, el, None)
        return out

    def intersection(self, *others: Any) -> "OrderedSet[T]":
        return OrderedSet(
            el for el in self if all(el in other for other in others)
        )

    def union(self, *others: Any) -> "OrderedSet[T]":
        out = OrderedSet(self)
        for other in others:
            out.update(other)
        return out

    def isdisjoint(self, other: Any) -> bool:
        return all(el not in self for el in other)

    # binary ops interoperate with plain sets in either position; the
    # ordered operand keeps its order where one is involved (__rand__
    # returns an OrderedSet too), except __rsub__/__ror__ where the
    # plain-set left operand's type wins
    def __and__(self, other: Any) -> "OrderedSet[T]":
        return OrderedSet(el for el in self if el in other)

    __rand__ = __and__

    def __or__(self, other: Any) -> "OrderedSet[T]":  # type: ignore[override]
        return self.union(other)

    def __sub__(self, other: Any) -> "OrderedSet[T]":
        return self.difference(other)

    def __ior__(self, other: Any) -> "OrderedSet[T]":
        # inherited dict.__ior__ expects key/value pairs and raises on
        # a plain set — in-place union must mean set semantics here
        self.update(other)
        return self

    def __le__(self, other: Any) -> bool:
        return all(el in other for el in self)

    def __lt__(self, other: Any) -> bool:
        return len(self) < len(other) and self.__le__(other)

    def __ge__(self, other: Any) -> bool:
        return all(el in self for el in other)

    def __gt__(self, other: Any) -> bool:
        return len(self) > len(other) and self.__ge__(other)

    issubset = __le__
    issuperset = __ge__

    def __rsub__(self, other: Any) -> set:
        return {el for el in other if el not in self}

    def __ror__(self, other: Any) -> set:  # type: ignore[override]
        out = set(other)
        out.update(self)
        return out

    def __eq__(self, other: object) -> bool:
        if isinstance(other, OrderedSet):
            return dict.__eq__(self, other)
        if isinstance(other, (set, frozenset)):
            return self.keys() == other
        return NotImplemented

    def __ne__(self, other: object) -> bool:
        # dict.__ne__ vs a plain set returns NotImplemented and falls
        # back to identity, so `ordered != plain` would be True even
        # when `ordered == plain` — delegate explicitly
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        return f"OrderedSet({list(self)!r})"


class LRU(OrderedDict):
    """Dict with a maximum size, evicting the least recently *set* item."""

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.move_to_end(key)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if len(self) > self.maxsize:
            self.popitem(last=False)


def sum_mappings(maps: Iterator[Mapping[Any, float]]) -> dict[Any, float]:
    out: dict[Any, float] = {}
    for m in maps:
        if isinstance(m, Mapping):
            m = m.items()  # type: ignore
        for k, v in m:  # type: ignore
            out[k] = out.get(k, 0) + v
    return out
