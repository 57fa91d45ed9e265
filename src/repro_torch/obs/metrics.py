"""Process-wide metrics registry (a copy of ``repro.obs.metrics``).

One ``Registry`` instance per process (``get_registry``) unifies the
serving stats that historically lived on scattered objects —
``Scheduler.summary()``, ``Engine.stats()``, the ``PageAllocator``
occupancy/eviction/CoW counters — behind a single export surface:

  - ``Counter``    monotonically increasing float (events)
  - ``Gauge``      last-write-wins float (occupancy, rates)
  - ``Histogram``  fixed bucket boundaries, cumulative counts + sum
                   (latency / rate distributions)

Every instrument supports an optional flat ``labels`` dict (e.g.
``{"site": "blocks/attn/wq"}``); each distinct label set is an
independent series.  ``snapshot()`` returns a plain-JSON-serializable
dict (never NaN/Inf — those serialize as invalid JSON), and
``to_prometheus()`` renders the standard text exposition format.

Host-side and dependency-free by design: only the standard library, so
publishing metrics never issues a device operation.
"""

from __future__ import annotations

import json
import math
import threading

# Default latency buckets (seconds): 1ms .. 60s, roughly log-spaced.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# Default rate buckets (dimensionless fractions in [0, 1]): tuned for
# the quant-health saturation/underflow rates, where "a few ppm" and
# "a few percent" are the interesting regimes.
RATE_BUCKETS = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 0.01, 0.05, 0.1, 0.25,
                0.5, 1.0)
# Default drift-ratio buckets: 1.0 is the refresh threshold (live amax
# at the edge of the calibrated representable range).
DRIFT_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.25, 1.5, 2.0, 4.0,
                 8.0)


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _finite(v: float) -> float | None:
    """None for NaN/Inf — the JSON-safety choke point."""
    v = float(v)
    return v if math.isfinite(v) else None


class _Metric:
    """Base: one named metric with per-label-set series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def _series_for(self, labels: dict | None):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new_series()
        return s

    def labelsets(self):
        return list(self._series)


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, value: float = 1.0, labels: dict | None = None):
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        self._series_for(labels)[0] += value

    def set_total(self, value: float, labels: dict | None = None):
        """Adopt an externally-kept running total (how the engine's
        pre-registry int fields publish without double counting)."""
        s = self._series_for(labels)
        s[0] = max(s[0], float(value))

    def value(self, labels: dict | None = None) -> float:
        return self._series_for(labels)[0]

    def _snap(self, series):
        return _finite(series[0])


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, value: float, labels: dict | None = None):
        self._series_for(labels)[0] = float(value)

    def value(self, labels: dict | None = None) -> float:
        return self._series_for(labels)[0]

    def _snap(self, series):
        return _finite(series[0])


class Histogram(_Metric):
    """Fixed-boundary histogram: counts per bucket (cumulative in the
    Prometheus export, per-bucket in ``snapshot``), plus sum/count."""

    kind = "histogram"

    def __init__(self, name: str, buckets, help: str = ""):
        super().__init__(name, help)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(
                f"histogram {name}: buckets must be strictly increasing")
        self.buckets = b

    def _new_series(self):
        # [counts per bucket..., overflow, sum, count]
        return [0.0] * (len(self.buckets) + 1) + [0.0, 0.0]

    def observe(self, value: float, labels: dict | None = None):
        v = float(value)
        if math.isnan(v):
            return
        s = self._series_for(labels)
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                s[i] += 1
                break
        else:
            s[len(self.buckets)] += 1
        s[-2] += v
        s[-1] += 1

    def _snap(self, series):
        nb = len(self.buckets)
        return {
            "buckets": list(self.buckets),
            "counts": [int(c) for c in series[:nb + 1]],
            "sum": _finite(series[-2]),
            "count": int(series[-1]),
        }


class Registry:
    """Name -> metric map with get-or-create constructors.

    Re-declaring a name returns the existing instrument (so modules can
    declare at use sites without coordinating), but a kind mismatch is
    a hard error — two subsystems fighting over one name is a bug.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, requested {cls.kind}")
                return m
            m = self._metrics[name] = cls(name, help=help, **kw)
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_S,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self):
        """Drop every metric (tests / between benchmark phases)."""
        with self._lock:
            self._metrics.clear()

    # -- export --------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain dict of every series — JSON-safe by construction
        (non-finite values become null)."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = {_label_str(k) or "": m._snap(s)
                      for k, s in sorted(m._series.items())}
            out[name] = {"kind": m.kind, "help": m.help,
                         "series": series}
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent,
                          allow_nan=False)

    def to_prometheus(self) -> str:
        """Standard Prometheus text exposition format."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, s in sorted(m._series.items()):
                if isinstance(m, Histogram):
                    cum = 0.0
                    for edge, c in zip(m.buckets, s):
                        cum += c
                        le = (f"{edge:g}" if math.isfinite(edge)
                              else "+Inf")
                        lk = key + (("le", le),)
                        lines.append(
                            f"{name}_bucket{_label_str(lk)} {cum:g}")
                    cum += s[len(m.buckets)]
                    lk = key + (("le", "+Inf"),)
                    lines.append(f"{name}_bucket{_label_str(lk)} {cum:g}")
                    lines.append(f"{name}_sum{_label_str(key)} {s[-2]:g}")
                    lines.append(
                        f"{name}_count{_label_str(key)} {s[-1]:g}")
                else:
                    lines.append(f"{name}{_label_str(key)} {s[0]:g}")
        return "\n".join(lines) + "\n"


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return _REGISTRY
