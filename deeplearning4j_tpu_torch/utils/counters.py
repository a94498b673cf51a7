"""Counter / CounterMap / Index — the vendored Berkeley-NLP util surface.

Capability match of ``berkeley/Counter.java`` (598 LoC), ``CounterMap.java``
(390), ``Index``/``Pair``/``Triple``: float-valued counters with
normalize/argmax/pruning, nested counters, and a bidirectional index.
Python's stdlib covers much of this; these classes keep the API the
reference's NLP code shapes itself around.

Port of ``deeplearning4j_tpu/utils/counters.py``: host code, copied.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Generic, Hashable, Iterable, Iterator, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class Counter(Generic[K]):
    def __init__(self, items: Iterable[K] | None = None):
        self._m: dict[K, float] = defaultdict(float)
        if items:
            for it in items:
                self.increment(it)

    def increment(self, key: K, by: float = 1.0) -> None:
        self._m[key] += by

    def set_count(self, key: K, value: float) -> None:
        self._m[key] = value

    def get_count(self, key: K) -> float:
        return self._m.get(key, 0.0)

    def remove(self, key: K) -> None:
        self._m.pop(key, None)

    def total_count(self) -> float:
        return sum(self._m.values())

    def normalize(self) -> None:
        total = self.total_count()
        if total:
            for k in self._m:
                self._m[k] /= total

    def argmax(self) -> K | None:
        return max(self._m, key=self._m.get) if self._m else None

    def max_count(self) -> float:
        return max(self._m.values()) if self._m else 0.0

    def keep_top_n(self, n: int) -> None:
        top = sorted(self._m.items(), key=lambda kv: -kv[1])[:n]
        self._m = defaultdict(float, top)

    def prune_below(self, threshold: float) -> None:
        self._m = defaultdict(
            float, {k: v for k, v in self._m.items() if v >= threshold})

    def sorted_keys(self) -> list[K]:
        return sorted(self._m, key=lambda k: -self._m[k])

    def __contains__(self, key: K) -> bool:
        return key in self._m

    def __len__(self) -> int:
        return len(self._m)

    def __iter__(self) -> Iterator[K]:
        return iter(self._m)

    def items(self):
        return self._m.items()


class CounterMap(Generic[K, V]):
    def __init__(self):
        self._m: dict[K, Counter[V]] = {}

    def increment(self, key: K, sub: V, by: float = 1.0) -> None:
        self._m.setdefault(key, Counter()).increment(sub, by)

    def get_count(self, key: K, sub: V) -> float:
        c = self._m.get(key)
        return c.get_count(sub) if c else 0.0

    def get_counter(self, key: K) -> Counter[V]:
        return self._m.setdefault(key, Counter())

    def total_count(self) -> float:
        return sum(c.total_count() for c in self._m.values())

    def normalize(self) -> None:
        for c in self._m.values():
            c.normalize()

    def keys(self):
        return self._m.keys()

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, key: K) -> bool:
        return key in self._m


class Index(Generic[K]):
    """Bidirectional object<->int index (``util/Index.java``)."""

    def __init__(self, items: Iterable[K] | None = None):
        self._to_int: dict[K, int] = {}
        self._to_obj: list[K] = []
        if items:
            for it in items:
                self.add(it)

    def add(self, item: K) -> int:
        if item not in self._to_int:
            self._to_int[item] = len(self._to_obj)
            self._to_obj.append(item)
        return self._to_int[item]

    def index_of(self, item: K) -> int:
        return self._to_int.get(item, -1)

    def get(self, i: int) -> K:
        return self._to_obj[i]

    def __len__(self) -> int:
        return len(self._to_obj)

    def __contains__(self, item: K) -> bool:
        return item in self._to_int

    def __iter__(self) -> Iterator[K]:
        return iter(self._to_obj)
