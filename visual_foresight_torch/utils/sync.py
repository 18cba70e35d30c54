"""Shared trajectory counters for multi-process data collection.

Capability parity with reference ``visual_mpc/utils/sync.py:4-26``: N sim
workers pull globally unique trajectory indices from one shared counter.
Implemented as a single primitive parameterized by where its shared state
lives — plain ``multiprocessing`` (fork-inherited) or a ``Manager`` proxy
(picklable, so it can ride a manager queue into ``Pool`` workers).
"""

import multiprocessing


class SyncCounter:
    """Monotone shared counter; every accessor is lock-serialized."""

    def __init__(self, base_value=0, backend=None):
        """:param backend: object providing ``Lock()``/``Value()`` — defaults
        to the ``multiprocessing`` module itself; pass a ``Manager`` for a
        proxy-backed counter."""
        src = backend if backend is not None else multiprocessing
        self._lock = src.Lock()
        self._value = src.Value('i', base_value)

    def next_index(self):
        """Claim and return the next unique index (post-increments)."""
        with self._lock:
            claimed = self._value.value
            self._value.value = claimed + 1
        return claimed

    # reference-shaped accessors (``sim/simulator.py`` reads these)
    @property
    def ret_increment(self):
        return self.next_index()

    @property
    def value(self):
        with self._lock:
            return self._value.value


def ManagedSyncCounter(manager, base_value=0):
    """Manager-backed counter (factory kept for the reference-shaped API)."""
    return SyncCounter(base_value, backend=manager)
