"""Observability (counterpart of ``repro.obs``).

Three independent pillars, all free when off:

  - ``obs.metrics``      process-wide metrics registry (counters,
                         gauges, histograms) and Prometheus-text / JSON
                         exporters: the one export surface of the
                         serving stats (``Scheduler.summary``,
                         ``Engine.stats``, the page allocator's
                         counters);
  - ``obs.trace``        span API writing Chrome-trace-event JSON
                         (Perfetto), ring-buffered, gated by
                         ``REPRO_TRACE=path``;
  - ``obs.quant_health`` fp8 quantization-health telemetry
                         (saturation, underflow and activation-scale
                         drift per GEMM site), gated by
                         ``REPRO_QUANT_HEALTH=1``.

The contract: with both gates off a serving step issues exactly the
device operations of a build without them (tests/test_torch_obs.py
records them with a ``TorchDispatchMode``).
"""

from .metrics import Registry, get_registry
from .trace import get_tracer, span, trace_enabled

__all__ = ["Registry", "get_registry", "get_tracer", "span",
           "trace_enabled"]
