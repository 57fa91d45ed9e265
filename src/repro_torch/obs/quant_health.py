"""fp8 quantization-health telemetry (counterpart of
``repro.obs.quant_health``).

Delayed activation scales remove the per-step amax reductions of
serving, and with them the only signal that would say when quantization
goes wrong.  Under ``REPRO_QUANT_HEALTH=1`` every delayed-activation
GEMM site reports, per sampled engine step and per site tag:

  - **saturation rate**   the fraction of elements whose scaled
                          magnitude exceeds the fp8 max (they clip at
                          ±448 for e4m3);
  - **underflow rate**    the fraction of *nonzero* inputs that
                          quantize to exactly 0;
  - **drift ratio**       the max over quantization groups of
                          ``live_amax_g / (scale_g · FP8_MAX)``: the live
                          activation range against the edge of the
                          calibrated range.  The calibration margin
                          (1.25) puts a healthy site near 0.8; above 1.0
                          values clip, ``refresh_recommended`` turns on
                          and ``Engine.refresh_act_scales()`` is the fix.

How it is wired, and why off is free:

  - when a step is built with ``quant_health=True`` (and only then),
    each site's ``ActScale`` is wrapped in a ``TaggedScale`` carrying its
    site tag (``tag_act_scales``);
  - ``qlinear`` records the site's statistics (element-wise compares and
    small reductions over the activation; nothing feeds an fp8 cast)
    into the module collector ``QH``, then runs the plain delayed
    forward on the inner ``ActScale``;
  - ``transformer.forward`` drains the collector after each layer and
    stacks each site's statistics over the layers, so they come out
    ``(layers,)`` as the ``ActScale``s go in (the LM head's stay
    scalars);
  - the step returns that tree as a third output, and the engine feeds
    it to a host-side ``HealthAggregator`` that publishes registry
    histograms.

With the flag off none of this exists: ``qlinear`` sees a plain
``ActScale``, ``QH`` is not capturing, and the steps return their two
outputs, issuing exactly the device operations they issue without this
module (tests/test_torch_obs.py).

As in the reference, the sites of a MoE's experts run one expert at a
time (the reference's ``jax.vmap``) and record nothing
(``QH.unrecorded``); the dense, attention, shared-expert and head sites
are all covered.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.actscale import ActScale, effective_group_scales
from repro_torch.core.formats import TINY, fp8_max
from repro_torch.core.quant import quant_excursions

from .metrics import DRIFT_BUCKETS, RATE_BUCKETS, get_registry

DRIFT_THRESHOLD = 1.0      # live amax past the calibrated range x margin


class TaggedScale:
    """An ``ActScale`` bundled with its site tag: what the serving steps
    attach instead of the bare ``ActScale`` when quant-health is on.
    ``core.actscale.split_act`` splits it per layer and per expert with
    the tag kept."""

    __slots__ = ("tag", "scale")

    def __init__(self, tag: str, scale: ActScale):
        self.tag = tag
        self.scale = scale

    def __repr__(self):
        return f"TaggedScale({self.tag!r})"


def tag_act_scales(act: dict | None) -> dict | None:
    """{tag: ActScale} -> {tag: TaggedScale} (at build, flag on)."""
    if act is None:
        return None
    return {tag: TaggedScale(tag, a) for tag, a in act.items()}


def site_stats(x: torch.Tensor, a: ActScale, cfg) -> dict[str, torch.Tensor]:
    """Quantization-health statistics of one GEMM site's activation
    ``x`` (inner dim last) against its calibrated ``ActScale``: f32
    scalars (counts and maxima) on x's device.  ``drift`` divides by the
    fp8 max as XLA compiles the reference's division by that constant,
    a product with its f32 reciprocal."""
    fmax = float(fp8_max(cfg.fwd_format))
    k = x.shape[-1]
    x2d = x.to(torch.float32).abs().reshape(-1, k)
    sg, g = effective_group_scales(a, cfg, k)
    pad = (-k) % g
    if pad:
        x2d = F.pad(x2d, (0, pad))
    xg = x2d.reshape(x2d.shape[0], -1, g)
    sat, under, nonzero = quant_excursions(xg, sg[None, :, None],
                                           cfg.fwd_format)
    # each group's live amax first, then the few per-group ratios
    ag = xg.amax(dim=(0, 2))
    inv = float(np.float32(1.0) / np.float32(fmax))
    return {
        "n": torch.tensor(float(x2d.shape[0] * k), dtype=torch.float32,
                          device=x.device),
        "sat": sat,
        "underflow": under,
        "nonzero": nonzero,
        "amax": ag.max(),
        "drift": (ag / torch.clamp_min(sg, TINY)).max() * inv,
    }


class _Capture:
    """Result box of one ``QH.capture()`` window."""

    def __init__(self):
        self.tree: dict[str, dict] = {}


class _Collector:
    """The module-level tap sink: ``qlinear`` records a site's
    statistics here while a capture window is open, ``forward`` drains
    it after each layer and stacks the layers (``stash_layers``), and the
    health step takes the merged tree.  Outside a window every tap is a
    no-op."""

    def __init__(self):
        self.tracing = False
        self._sink: dict[str, dict] = {}
        self._stacked: dict[str, dict] = {}

    def record(self, tag: str, x: torch.Tensor, a: ActScale, cfg) -> None:
        if not self.tracing:
            return
        self._sink[tag] = site_stats(x, a, cfg)

    def drain_layer(self) -> dict | None:
        """This layer's recorded statistics (None when no window is
        open or nothing was recorded), leaving the sink empty."""
        if not self.tracing or not self._sink:
            return None
        out, self._sink = self._sink, {}
        return out

    def stash_layers(self, per_layer: list) -> None:
        """One segment's drained layers -> each site's statistics
        stacked to (layers,), as the reference's layer scan stacks its
        ``ys``; every layer must record the same sites."""
        per_layer = [d for d in per_layer if d is not None]
        if not per_layer:
            return
        tags = per_layer[0].keys()
        if any(d.keys() != tags for d in per_layer):
            raise RuntimeError("quant-health: layers of one segment "
                               "recorded different sites")
        self._stacked.update({
            tag: {k: torch.stack([d[tag][k] for d in per_layer])
                  for k in per_layer[0][tag]}
            for tag in tags})

    @contextlib.contextmanager
    def unrecorded(self):
        """No site records inside: the MoE's experts, run one at a time
        where the reference runs them under ``jax.vmap``."""
        prev, self.tracing = self.tracing, False
        try:
            yield
        finally:
            self.tracing = prev

    @contextlib.contextmanager
    def capture(self):
        """Open a collection window around a forward.  Yields a
        ``_Capture`` whose ``tree`` is, after the window closes, the
        flat ``{site tag: {stat: tensor}}``: a layer's sites with a
        leading (layers,) dim, top-level sites (the LM head) scalars."""
        prev = (self.tracing, self._sink, self._stacked)
        self.tracing, self._sink, self._stacked = True, {}, {}
        cap = _Capture()
        try:
            yield cap
        finally:
            cap.tree = dict(self._stacked)
            cap.tree.update(self._sink)       # top-level (unstacked)
            self.tracing, self._sink, self._stacked = prev


QH = _Collector()


def _to_host(tree: dict) -> dict:
    return {tag: {k: np.asarray(v.detach().cpu().numpy()
                                if torch.is_tensor(v) else v)
                  for k, v in st.items()}
            for tag, st in tree.items()}


class HealthAggregator:
    """Consumes the per-step health trees the engine takes off the
    device and publishes them: per-site saturation-rate, underflow-rate
    and drift-ratio histograms in the metrics registry, and the
    ``refresh_recommended`` flag once any site's drift exceeds the
    threshold."""

    def __init__(self, registry=None,
                 drift_threshold: float = DRIFT_THRESHOLD):
        self.reg = registry or get_registry()
        self.drift_threshold = float(drift_threshold)
        self.sites: dict[str, dict] = {}
        self.steps = 0
        self.refresh_recommended = False
        self._h_sat = self.reg.histogram(
            "quant_health_saturation_rate", buckets=RATE_BUCKETS,
            help="per-site fraction of activations clipping at fp8 max")
        self._h_under = self.reg.histogram(
            "quant_health_underflow_rate", buckets=RATE_BUCKETS,
            help="per-site fraction of nonzero activations quantizing "
                 "to 0")
        self._h_drift = self.reg.histogram(
            "quant_health_drift_ratio", buckets=DRIFT_BUCKETS,
            help="per-site live-amax / calibrated-range ratio "
                 "(>1 = clipping)")
        self._g_flag = self.reg.gauge(
            "quant_health_refresh_recommended",
            help="1 once any site's drift ratio exceeded the "
                 "threshold — call Engine.refresh_act_scales()")
        self._g_flag.set(0.0)

    def ingest(self, tree: dict[str, dict[str, Any]]) -> None:
        """One step's ``{site tag: stats}`` tree (tensors or numpy).
        Counts are summed over the stacked layer dim and drift is
        maxed: one bad layer trips the flag."""
        if not tree:
            return
        tree = _to_host(tree)
        self.steps += 1
        for tag, st in tree.items():
            n = float(np.sum(st["n"]))
            sat = float(np.sum(st["sat"]))
            nonzero = float(np.sum(st["nonzero"]))
            under = float(np.sum(st["underflow"]))
            amax = float(np.max(st["amax"]))
            drift = float(np.max(st["drift"]))
            sat_rate = sat / max(n, 1.0)
            under_rate = under / max(nonzero, 1.0)
            lab = {"site": tag}
            self._h_sat.observe(sat_rate, labels=lab)
            self._h_under.observe(under_rate, labels=lab)
            self._h_drift.observe(drift, labels=lab)
            s = self.sites.setdefault(tag, {
                "n": 0.0, "sat": 0.0, "nonzero": 0.0, "underflow": 0.0,
                "amax": 0.0, "drift_max": 0.0, "steps": 0})
            s["n"] += n
            s["sat"] += sat
            s["nonzero"] += nonzero
            s["underflow"] += under
            s["amax"] = max(s["amax"], amax)
            s["drift_max"] = max(s["drift_max"], drift)
            s["steps"] += 1
            if drift > self.drift_threshold:
                self.refresh_recommended = True
                self._g_flag.set(1.0)

    def report(self) -> dict:
        """Per-site summary rates (for ``Engine.stats()`` and tests)."""
        out = {}
        for tag, s in self.sites.items():
            out[tag] = {
                "saturation_rate": s["sat"] / max(s["n"], 1.0),
                "underflow_rate": s["underflow"] / max(s["nonzero"],
                                                       1.0),
                "drift_max": s["drift_max"],
                "amax": s["amax"],
                "steps": s["steps"],
            }
        return out
