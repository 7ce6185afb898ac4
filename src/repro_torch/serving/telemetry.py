"""Serving telemetry: the typed metrics registry (PyTorch port of
``repro.serving.telemetry``, registry part).

``MetricsRegistry`` holds the counters, gauges and histograms every
serving subsystem registers into (``kv_pool``, ``core.scheduler.
plan_wave``); the engine's ``stats()`` is a view over it.  Metric names
are the JAX package's, so reports read the same from either package.
Histograms use FIXED bucket bounds, so their shape is deterministic per
config, never data-dependent.  The span ``Tracer`` comes with a later
slice.

Clock policy: ``default_clock`` (``time.perf_counter``, bound below
without calling it) is the one monotonic clock the serving stack times
against; serving and launch code route timing through it.
"""
from __future__ import annotations

from typing import Callable, Optional

import time as _time

#: The ONE monotonic clock the serving stack times against.  Injectable
#: at the Tracer level so traced runs can be replay-deterministic.
default_clock: Callable[[], float] = _time.perf_counter


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically increasing integer metric."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        self.value += n

    def read(self):
        return self.value


class Gauge:
    """Point-in-time value: either set directly or sampled through a
    callback at collect time (the registry stays authoritative without
    forcing every producer to push on change)."""

    __slots__ = ("name", "fn", "_value")

    def __init__(self, name: str, fn: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self._value = 0

    def set(self, value) -> None:
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is callback-sampled")
        self._value = value

    def read(self):
        return self.fn() if self.fn is not None else self._value


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are inclusive upper bounds
    (an implicit +inf bucket catches the tail).  Bounds are frozen at
    registration so the exported shape is deterministic per config —
    never a function of the observed data."""

    __slots__ = ("name", "buckets", "counts", "total", "count")

    def __init__(self, name: str, buckets):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name}: buckets must be strictly increasing, "
                f"got {buckets!r}")
        self.name = name
        self.buckets = bounds
        self.counts = [0] * (len(bounds) + 1)     # +1 = overflow bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value) -> None:
        v = float(value)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += v
        self.count += 1

    def read(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.total, "count": self.count}


class MetricsRegistry:
    """Name -> instrument map with get-or-create semantics.

    Re-registering an existing name returns the existing instrument if
    the type matches (so subsystems can register idempotently) and
    raises on a type clash — two subsystems silently sharing a name
    with different semantics is exactly the ad-hoc-dict bug class this
    registry replaces.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str, fn: Optional[Callable] = None) -> Gauge:
        g = self._get(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None:
            g.fn = fn   # latest binding wins (re-attached frontends)
        return g

    def histogram(self, name: str, buckets) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, buckets))

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        """Read one metric's current value (KeyError when absent)."""
        return self._metrics[name].read()

    def collect(self) -> dict:
        """Deterministic snapshot: ``{name: value}`` sorted by name.
        Counters/gauges read as scalars, histograms as
        ``{buckets, counts, sum, count}`` dicts."""
        return {name: self._metrics[name].read()
                for name in sorted(self._metrics)}
