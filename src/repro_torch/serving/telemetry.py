"""Serving telemetry: the typed metrics registry, the span tracer and
its Chrome-trace tools (PyTorch port of ``repro.serving.telemetry``; the
module is pure Python, so the port keeps its own copy).

* ``MetricsRegistry`` holds the counters, gauges and histograms every
  serving subsystem registers into (``kv_pool``, ``prefix_cache``,
  ``core.scheduler.plan_wave``, the async frontend); the engine's
  ``stats()`` is a view over it.  Metric names are the JAX package's, so
  reports read the same from either package.  Histograms use FIXED
  bucket bounds, so their shape is deterministic per config, never
  data-dependent.
* ``Tracer`` records engine-phase spans (admit / plan / draft / dispatch
  / sync / retire / publish, and an admission's prefill_dispatch /
  prefill_sync) on an engine track, one track per slot for the resident
  request, and per-request lifecycle events whose stamps give an exact
  TTFT decomposition (``queue_wait + prefill + first_wave == ttft``:
  the three segments share their boundary stamps).  ``sync`` and
  ``prefill_sync`` time the engine's device synchronisation, so a
  step's host time and device time show apart.
* ``Tracer.dump_chrome_trace`` writes Perfetto / chrome://tracing JSON;
  ``validate_chrome_trace`` and ``summarize_trace`` read a dump back.

Events, tracks and the process name are the JAX tracer's, and under the
same clock the two record the same events.  One difference: without an
injected clock the port's tracer reads ``default_clock`` on a grid of
2**-20 s (``grid_clock``, ~0.95 us), where every microsecond stamp, and
every difference and sum of stamps of a tracer younger than six days, is
exact in float64, so the TTFT decomposition sums exactly on a real
clock too, not only under a fake one.

Clock policy: ``default_clock`` (``time.perf_counter``, bound below
without calling it) is the one monotonic clock the serving stack times
against; serving and launch code route timing through it or through a
``Tracer``'s clock (``ServeConfig.trace_clock``, which a test may set to
a deterministic fake).
"""
from __future__ import annotations

import json
from contextlib import contextmanager
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


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

#: Track (tid) layout of a serving trace.  One process (pid 0): tid 0
#: carries the engine's per-wave phase spans, tid 1 the frontend /
#: queue-side instants, and tid SLOT_TID0 + slot the per-slot request
#: residencies.
ENGINE_TID = 0
FRONTEND_TID = 1
SLOT_TID0 = 10

_PID = 0

#: ``grid_clock``'s resolution: 2**20 ticks a second
_GRID = float(2 ** 20)


def grid_clock() -> float:
    """``default_clock`` rounded to a multiple of 2**-20 s.  A stamp of
    the tracer is then ``k * 15625 * 2**-14`` us for an integer ``k``
    (1e6 = 2**6 * 15625), exact while ``k * 15625 < 2**53`` (the
    tracer's first 6.4 days), and so are the differences and sums the
    request summaries take of such stamps."""
    return round(default_clock() * _GRID) / _GRID


class Tracer:
    """Span + lifecycle-event recorder against an injectable clock.

    All timestamps are microseconds relative to construction (Chrome
    trace convention).  Phase spans (``span``) nest via a per-track
    stack and are emitted as complete ``"X"`` events; open-ended
    residencies (``begin``/``end``) emit ``"B"``/``"E"`` pairs;
    ``instant`` marks a point.  Per-request lifecycle events
    (``req_event``) are additionally kept in arrival order per uid so
    ``request_summaries()`` can compute the TTFT decomposition and ITL
    series without re-parsing the Chrome events.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else grid_clock
        self._t0 = self.clock()
        self.events: list[dict] = []
        self._stacks: dict[int, list] = {}        # tid -> open X spans
        self._open_be: dict[int, list] = {}       # tid -> open B names
        self._tracks: dict[int, str] = {ENGINE_TID: "engine",
                                        FRONTEND_TID: "frontend"}
        # uid -> [(event_name, t_us, args)] in arrival order
        self.requests: dict[int, list] = {}

    # -- time ----------------------------------------------------------
    def now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    # -- track naming --------------------------------------------------
    def name_track(self, tid: int, name: str) -> None:
        self._tracks[tid] = name

    # -- spans ---------------------------------------------------------
    @contextmanager
    def span(self, name: str, tid: int = ENGINE_TID, **args):
        """Nested phase span (complete ``"X"`` event on exit)."""
        t0 = self.now_us()
        stack = self._stacks.setdefault(tid, [])
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()
            self.events.append({
                "ph": "X", "name": name, "cat": "phase", "pid": _PID,
                "tid": tid, "ts": t0, "dur": self.now_us() - t0,
                **({"args": args} if args else {})})

    def begin(self, name: str, tid: int, **args) -> None:
        """Open-ended span (slot residency) — closed by ``end(tid)``."""
        self._open_be.setdefault(tid, []).append(name)
        self.events.append({"ph": "B", "name": name, "cat": "slot",
                            "pid": _PID, "tid": tid, "ts": self.now_us(),
                            **({"args": args} if args else {})})

    def end(self, tid: int) -> None:
        open_ = self._open_be.get(tid)
        if not open_:
            return                       # idempotent: nothing resident
        open_.pop()
        self.events.append({"ph": "E", "pid": _PID, "tid": tid,
                            "ts": self.now_us()})

    def instant(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        self.events.append({"ph": "i", "s": "t", "name": name,
                            "cat": "mark", "pid": _PID, "tid": tid,
                            "ts": self.now_us(),
                            **({"args": args} if args else {})})

    def counter(self, name: str, tid: int = FRONTEND_TID, **series) -> None:
        """Chrome counter-track sample (``ph="C"``): queue depths etc."""
        self.events.append({"ph": "C", "name": name, "pid": _PID,
                            "tid": tid, "ts": self.now_us(),
                            "args": dict(series)})

    # -- per-request lifecycle -----------------------------------------
    def req_event(self, uid: int, name: str, tid: Optional[int] = None,
                  **args) -> None:
        """Record one lifecycle event for request ``uid`` and mirror it
        as an instant on ``tid`` (slot track when resident, frontend
        track otherwise)."""
        t = self.now_us()
        self.requests.setdefault(uid, []).append((name, t, args))
        self.instant(f"{name} u{uid}",
                     tid=FRONTEND_TID if tid is None else tid,
                     uid=uid, **args)

    def request_summaries(self) -> list[dict]:
        """Exact TTFT decomposition per request, from the lifecycle
        stamps:

        * ``queue_wait_us``  = submit -> admitted
        * ``prefill_us``     = admitted -> prompt_done (bucketed
          prefill, or the catch-up waves under chunked admission)
        * ``first_wave_us``  = prompt_done -> first_token

        The three segments share their boundary stamps, so they sum to
        ``ttft_us`` EXACTLY; ``e2e_us`` = submit -> finish/cancel.
        ``itl_us`` is the series of gaps between token-bearing waves,
        and ``spec_rounds`` the per-round ``(proposed, accepted)``
        pairs — per request, so a chance-level draft is visible on the
        request where it burns, not as one aggregate.
        """
        out = []
        for uid in sorted(self.requests):
            stamps: dict[str, float] = {}
            token_ts: list[float] = []
            spec_rounds: list[tuple] = []
            for name, t, args in self.requests[uid]:
                if name not in stamps:
                    stamps[name] = t     # first occurrence wins
                if name == "tokens":
                    token_ts.extend([t] * int(args.get("n", 1)))
                elif name == "spec_round":
                    spec_rounds.append((int(args.get("proposed", 0)),
                                        int(args.get("accepted", 0))))
                elif name in ("finish", "cancel"):
                    stamps["_end"] = t   # last terminal event wins
            s = stamps.get("submit")
            a = stamps.get("admitted")
            p = stamps.get("prompt_done", a)
            f = stamps.get("first_token")
            row = {"uid": uid,
                   "queue_wait_us": None if None in (s, a) else a - s,
                   "prefill_us": None if None in (a, p) else p - a,
                   "first_wave_us": None if None in (p, f) else f - p,
                   "ttft_us": None if None in (s, f) else f - s,
                   "e2e_us": (None if s is None or "_end" not in stamps
                              else stamps["_end"] - s),
                   "n_tokens": len(token_ts),
                   "itl_us": [token_ts[i] - token_ts[i - 1]
                              for i in range(1, len(token_ts))],
                   "spec_rounds": spec_rounds}
            out.append(row)
        return out

    # -- export --------------------------------------------------------
    def chrome_events(self) -> list[dict]:
        """The full Chrome-trace event list: thread-name metadata, all
        recorded events (open ``B`` residencies auto-closed at the
        current stamp), and one ``request_summary`` instant per request
        carrying its TTFT decomposition in ``args``."""
        now = self.now_us()
        # the JAX tracer's process name: dumps of both packages read alike
        events = [{"ph": "M", "name": "process_name", "pid": _PID,
                   "tid": 0, "ts": 0,
                   "args": {"name": "repro.serving"}}]
        for tid in sorted(self._tracks):
            events.append({"ph": "M", "name": "thread_name", "pid": _PID,
                           "tid": tid, "ts": 0,
                           "args": {"name": self._tracks[tid]}})
        events.extend(self.events)
        for tid, open_ in self._open_be.items():
            for _ in open_:
                events.append({"ph": "E", "pid": _PID, "tid": tid,
                               "ts": now})
        for row in self.request_summaries():
            events.append({"ph": "i", "s": "t", "name": "request_summary",
                           "cat": "summary", "pid": _PID,
                           "tid": FRONTEND_TID, "ts": now,
                           "args": row})
        return events

    def dump_chrome_trace(self, path: str) -> dict:
        """Write Perfetto-loadable Chrome-trace JSON to ``path``.
        Returns ``{"events": N, "requests": M}``."""
        events = self.chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)
            f.write("\n")
        return {"events": len(events), "requests": len(self.requests)}


# ---------------------------------------------------------------------------
# trace-file analysis
# ---------------------------------------------------------------------------

def validate_chrome_trace(events: list) -> list[str]:
    """Structural findings for a Chrome-trace event list (empty = ok):
    every event must carry ``ph``/``ts``/``pid``/``tid``, ``X`` events
    a non-negative ``dur``, and ``B``/``E`` pairs must balance per
    track — the properties Perfetto needs to lay the tracks out."""
    problems = []
    depth: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        for k in ("ph", "ts", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i} missing {k!r}: {ev}")
        ph = ev.get("ph")
        if ph == "X" and ev.get("dur", -1) < 0:
            problems.append(f"event {i}: X without non-negative dur")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                problems.append(f"event {i}: E without matching B on "
                                f"track {key}")
    for key, d in sorted(depth.items()):
        if d > 0:
            problems.append(f"track {key}: {d} unclosed B span(s)")
    return problems


def summarize_trace(trace: dict) -> dict:
    """Aggregate a loaded Chrome-trace dict (``dump_chrome_trace``
    output): top phases by total time, per-request TTFT decomposition
    rows (from the ``request_summary`` instants) and speculative
    acceptance by round ordinal."""
    events = trace.get("traceEvents", trace if isinstance(trace, list)
                       else [])
    phases: dict[str, list] = {}
    summaries = []
    for ev in events:
        if ev.get("ph") == "X":
            agg = phases.setdefault(ev.get("name", "?"), [0.0, 0])
            agg[0] += float(ev.get("dur", 0.0))
            agg[1] += 1
        elif ev.get("name") == "request_summary":
            summaries.append(ev.get("args", {}))
    by_round: dict[int, list] = {}
    for row in summaries:
        for j, (prop, acc) in enumerate(row.get("spec_rounds", ())):
            agg = by_round.setdefault(j, [0, 0])
            agg[0] += prop
            agg[1] += acc
    return {
        "problems": validate_chrome_trace(events),
        "phases": sorted(
            ({"name": n, "total_us": t, "calls": c,
              "mean_us": t / max(c, 1)} for n, (t, c) in phases.items()),
            key=lambda r: -r["total_us"]),
        "requests": summaries,
        "accept_by_round": {j: {"proposed": p, "accepted": a,
                                "rate": a / max(p, 1)}
                            for j, (p, a) in sorted(by_round.items())},
    }
