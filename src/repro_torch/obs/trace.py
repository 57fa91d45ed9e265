"""Engine step tracing: Chrome-trace-event JSON spans (a copy of
``repro.obs.trace``).

``span("decode", rows=4)`` wraps a host-side phase in a complete
("ph": "X") Chrome trace event; the written file loads in Perfetto or
chrome://tracing.  The engine wires spans around its step phases
(retire, swap-in, chunk, decode or verify) and the training CLI around
its data and step calls: always around host code that launches device
work, never inside it, so tracing never adds a device operation.

Gates and cost:

  - off (the default): ``span()`` returns a shared no-op context
    manager, one attribute read and no allocation a call;
  - ``REPRO_TRACE=path``: spans record into a ring buffer (65536 events
    by default, ``REPRO_TRACE_BUFFER`` overrides), so a long serving
    run keeps the last N events instead of growing without bound, and
    the buffer is written to ``path`` at process exit (or by
    ``get_tracer().save()`` / the CLIs' ``--trace-out``).

Durations are the wall time of the wrapped block.  CUDA work is
asynchronous, so a span around a launch measures the launch unless the
caller synchronises; the serving engine reads every step's tokens back
to the host (sampling), which makes its spans end to end, and the
training CLI synchronises inside its step span when tracing is on.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

from repro_torch.core.runtime_flags import trace_path

DEFAULT_BUFFER_EVENTS = 65536


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Tracer:
    """Ring-buffered Chrome-trace-event recorder."""

    def __init__(self, capacity: int = DEFAULT_BUFFER_EVENTS):
        self.enabled = False
        self.path: str | None = None
        self._events: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- control -------------------------------------------------------
    def enable(self, path: str | None = None,
               capacity: int | None = None):
        """Turn tracing on; ``path`` is where ``save()`` (and the
        atexit flush) writes."""
        if capacity is not None and capacity != self._events.maxlen:
            self._events = deque(self._events,
                                 maxlen=max(1, int(capacity)))
        self.enabled = True
        if path is not None:
            self.path = path
        return self

    def disable(self):
        self.enabled = False
        return self

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        return len(self._events)

    # -- recording -----------------------------------------------------
    def span(self, name: str, **args):
        """Context manager recording one complete ("X") event around
        the block.  No-op (shared null CM) when disabled."""
        if not self.enabled:
            return _NULL
        return self._span(name, args)

    @contextmanager
    def _span(self, name, args):
        t0 = time.perf_counter_ns()
        try:
            yield None
        finally:
            t1 = time.perf_counter_ns()
            ev = {"name": name, "ph": "X", "ts": t0 // 1000,
                  "dur": max(0, (t1 - t0) // 1000), "pid": self._pid,
                  "tid": threading.get_ident() & 0xFFFFFFFF}
            if args:
                ev["args"] = args
            with self._lock:
                self._events.append(ev)

    def instant(self, name: str, **args):
        """One instant ("i") event: markers like preemptions."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": time.perf_counter_ns() // 1000, "pid": self._pid,
              "tid": threading.get_ident() & 0xFFFFFFFF}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- export --------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path: str | None = None) -> str | None:
        """Write the buffered events as a Chrome-trace JSON array.
        Returns the path written, or None when there is nowhere to
        write."""
        path = path or self.path
        if path is None:
            return None
        with open(path, "w") as f:
            json.dump(self.events(), f)
        return path


_TRACER: Tracer | None = None
_ATEXIT_REGISTERED = False


def _buffer_capacity() -> int:
    env = os.environ.get("REPRO_TRACE_BUFFER", "").strip()
    try:
        return int(env) if env else DEFAULT_BUFFER_EVENTS
    except ValueError:
        return DEFAULT_BUFFER_EVENTS


def get_tracer() -> Tracer:
    """The process-wide tracer.  The first call reads ``REPRO_TRACE``
    (``runtime_flags.trace_path``): a non-empty value enables tracing
    with that output path and registers an atexit flush."""
    global _TRACER, _ATEXIT_REGISTERED
    if _TRACER is None:
        _TRACER = Tracer(capacity=_buffer_capacity())
        path = trace_path()
        if path:
            _TRACER.enable(path=path)
            if not _ATEXIT_REGISTERED:
                atexit.register(_flush_at_exit)
                _ATEXIT_REGISTERED = True
    return _TRACER


def _flush_at_exit():
    if _TRACER is not None and _TRACER.enabled and _TRACER.path:
        _TRACER.save()


def trace_enabled() -> bool:
    return get_tracer().enabled


def span(name: str, **args):
    """Module-level convenience: ``with span("decode", rows=4): ...``"""
    return get_tracer().span(name, **args)


def instant(name: str, **args):
    get_tracer().instant(name, **args)
