"""StatsRegistry — one snapshot/reset/assert API over the port's counters:
the port's copy of ``repro/obs/stats.py``.

``fl_driver.RUNNER_STATS`` (runner builds) and ``serve.engine.SERVE_STATS``
(scorer builds) are both ``{"misses": 0, "hits": 0}`` with the same
discipline — tests and ``chip_smoke.py`` snapshot them, run something, and
assert the delta (one build a key).  This module keeps them behind ONE
registry without breaking a call site: a :class:`Counters` namespace is a
``MutableMapping``, so ``RUNNER_STATS["misses"] += 1``,
``dict(RUNNER_STATS)`` and ``RUNNER_STATS["misses"] - m0`` all behave
exactly like the plain dicts they replace.

What the registry adds on top:

* ``STATS.snapshot()`` — every namespace at once (one dict, JSON-safe);
* ``STATS.reset()`` — restore declared defaults (per namespace or all);
* ``STATS.delta(ns)`` / ``STATS.expect(ns, **deltas)`` — context managers
  for the snapshot/run/assert idiom the benches repeat by hand.

Everything here is host-side Python; nothing touches a device tensor.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, MutableMapping


class Counters(MutableMapping):
    """A named counter namespace: dict-compatible (the legacy call sites
    index, iterate and copy it) with declared defaults for reset."""

    __slots__ = ("name", "_data", "_defaults")

    def __init__(self, name: str, **defaults: int):
        self.name = name
        self._defaults = dict(defaults)
        self._data: Dict[str, int] = dict(defaults)

    def __getitem__(self, key: str) -> int:
        return self._data[key]

    def __setitem__(self, key: str, value: int) -> None:
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"Counters({self.name!r}, {self._data})"

    def reset(self) -> None:
        """Restore the declared defaults (unknown keys are dropped)."""
        self._data = dict(self._defaults)


class StatsRegistry:
    """The process-wide registry of counter namespaces."""

    def __init__(self):
        self._namespaces: Dict[str, Counters] = {}

    def counters(self, namespace: str, **defaults: int) -> Counters:
        """The namespace's :class:`Counters`, created with ``defaults`` on
        first use.  Repeat calls return the SAME object (module-level
        aliases like ``RUNNER_STATS`` stay views of registry state), and
        later defaults are merged without clobbering live counts."""
        ns = self._namespaces.get(namespace)
        if ns is None:
            ns = Counters(namespace, **defaults)
            self._namespaces[namespace] = ns
        else:
            for k, v in defaults.items():
                ns._defaults.setdefault(k, v)
                ns._data.setdefault(k, v)
        return ns

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Every namespace's current counts (plain nested dicts)."""
        return {name: dict(ns) for name, ns in self._namespaces.items()}

    def reset(self, namespace: str | None = None) -> None:
        if namespace is not None:
            self._namespaces[namespace].reset()
            return
        for ns in self._namespaces.values():
            ns.reset()

    @contextmanager
    def delta(self, namespace: str):
        """``with STATS.delta("runner") as d: ...`` — ``d`` fills with the
        per-key change over the block at exit (keys that did not move are
        reported as 0)."""
        ns = self.counters(namespace)
        before = dict(ns)
        out: Dict[str, int] = {}
        yield out
        for k, v in ns.items():
            out[k] = v - before.get(k, 0)

    @contextmanager
    def expect(self, namespace: str, **expected: int):
        """Assert exact per-key deltas over the block — the one-build idiom
        (``misses=1``) as one line."""
        with self.delta(namespace) as d:
            yield
        for k, want in expected.items():
            got = d.get(k, 0)
            assert got == want, (
                f"stats[{namespace}].{k}: expected delta {want}, got {got} "
                f"(full delta {d})")


# The process-wide registry.  Subsystems register their namespaces at
# import time (fl_driver: "runner"; serve.engine: "serve").
STATS = StatsRegistry()
