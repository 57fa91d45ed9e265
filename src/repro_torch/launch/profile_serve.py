"""Where a serving run's time goes on the card.

Builds a full-width engine that ``chip_smoke.py`` serves with (phi3-mini
on floating pages; ``--arch phi3.5-moe-42b-a6.6b``, the MoE, the same
way with its depth cut to ``MOE_SERVE_LAYERS``; or with ``--arch
h2o-danube-3-4b`` the windowed model on identity rows with the
whole-prompt prefill, its prompts at or past the 4096-token window so
that every decode step reads a full ring),
serves one untraced warm-up trace, then serves a second trace under
``torch.profiler`` with every model step inside a ``decode_step``,
``prefill_chunk``, ``prefill`` (whole-prompt) or, under
``REPRO_SPEC_DECODE=1``, ``verify_step`` span.  From the profiler's Chrome trace it reports,
per kind of step: the host span of the step function, the card's busy
time for the work launched in it (the union of its kernels' and copies'
intervals), the launches, the card time by kernel, the port kernels'
launches and the PyTorch ops issued (the ten most frequent, and
``WATCHED_OPS``); and for the whole traced run the card's idle share.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --trace build/serve_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch h2o-danube-3-4b --trace build/ring_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch phi3.5-moe-42b-a6.6b --trace build/moe_serve_trace.json

The profiler adds host time to every launch, so the traced steps are
slower than the warm-up's; both mean decode (and verify) steps are
printed.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import make_requests, random_params
from repro_torch.serving import Engine, Request

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the MoE's depth (of 32): the engine builds from the seeded f32 tree,
# and all 32 layers would be ~84 GB even in bf16.  Must equal
# chip_smoke.py's MOE_SERVE_LAYERS, whose serving phase this profiles.
MOE_SERVE_LAYERS = 4
SPANS = ("decode_step", "prefill_chunk", "prefill", "verify_step")
# the port's own kernels (csrc/*.cu), by the name the trace gives them
# (decode attention is one launch: its cluster holds the split over the
# slots and the combine)
PORT_KERNELS = ("mx_gemm_kernel", "mx_gemm_tiled_kernel",
                "mx_dw_gemm_kernel", "group_gemm_kernel", "mx_quant_kernel",
                "global_amax_kernel", "decode_attn_kernel", "moe_gmm_kernel",
                "moe_dw_gemm_kernel", "dw_requant_kernel")
# PyTorch ops counted per step beside the most frequent ones: the plain
# torch of a level-1 scale (abs, amax) that global_amax_kernel replaces
WATCHED_OPS = ("aten::abs", "aten::amax")


def _short(name: str) -> str:
    return name.removeprefix("void ")[:80]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def summarize(trace: dict, kinds=SPANS) -> dict:
    """Per-kind step statistics (one kind per span name in ``kinds``)
    and the run's idle share from a Chrome trace exported by
    ``torch.profiler``."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                   if e.get("cat") == "user_annotation"
                   and e["name"] in kinds)
    starts = [s[0] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    gpu = [e for e in ev if e.get("cat") in GPU_CATS]
    per_span = collections.defaultdict(list)
    for g in gpu:
        ts = launch_ts.get(g.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        if i >= 0 and ts <= spans[i][1]:
            per_span[i].append(g)
    ops_in = collections.defaultdict(collections.Counter)
    for e in ev:
        if e.get("cat") == "cpu_op":
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= spans[i][1]:
                ops_in[i][e["name"]] += 1
    out = {}
    for kind in kinds:
        idx = [i for i, s in enumerate(spans) if s[2] == kind]
        if not idx:
            continue
        by_kernel = collections.Counter()
        for i in idx:
            for g in per_span[i]:
                by_kernel[_short(g["name"])] += g["dur"]
        port = sum(v for k, v in by_kernel.items()
                   if k.startswith(PORT_KERNELS))
        ops = sum((ops_in[i] for i in idx), collections.Counter())
        n = len(idx)
        out[kind] = {
            "steps": n,
            "host_span_ms": sum(spans[i][1] - spans[i][0]
                                for i in idx) / n / 1e3,
            "card_busy_ms": sum(_union_us((g["ts"], g["ts"] + g["dur"])
                                          for g in per_span[i])
                                for i in idx) / n / 1e3,
            "launches": sum(len(per_span[i]) for i in idx) / n,
            "card_ms_port_kernels": port / n / 1e3,
            "card_ms_other_kernels": (sum(by_kernel.values()) - port)
            / n / 1e3,
            "card_ms_by_kernel": {k: v / n / 1e3 for k, v in
                                  by_kernel.most_common(12)},
            "card_ms_by_port_kernel": {
                k: v / n / 1e3 for k, v in by_kernel.most_common()
                if k.startswith(PORT_KERNELS)},
            "launches_by_port_kernel": {
                k: c / n for k, c in collections.Counter(
                    _short(g["name"]) for i in idx for g in per_span[i]
                    if _short(g["name"]).startswith(PORT_KERNELS)).items()},
            "ops_per_step": {k: ops[k] / n for k in dict.fromkeys(
                [k for k, _ in ops.most_common(10)] + list(WATCHED_OPS))},
        }
    t0 = spans[0][0] if spans else 0.0
    t1 = max([spans[-1][1]] + [g["ts"] + g["dur"] for g in gpu
                               if g["ts"] >= t0]) if spans else 0.0
    busy = _union_us((max(g["ts"], t0), g["ts"] + g["dur"]) for g in gpu
                     if g["ts"] + g["dur"] > t0)
    out["run"] = {"wall_ms": (t1 - t0) / 1e3, "card_busy_ms": busy / 1e3,
                  "card_idle_share": 1.0 - busy / (t1 - t0) if t1 > t0
                  else None}
    return out


def _ring_requests(cfg, n: int, max_new: int, seed: int) -> list[Request]:
    """``n`` prompts of 4096-4200 tokens: at or past the window."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(k),
                                               dtype=np.int32),
                    max_new=max_new)
            for i, k in enumerate(rng.integers(4096, 4201, size=n))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=("phi3-mini-3.8b", "phi3.5-moe-42b-a6.6b",
                             "h2o-danube-3-4b"))
    ap.add_argument("--trace", default="serve_trace.json",
                    help="where to write the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")

    cfg = get_config(args.arch)
    if cfg.family == "moe":
        cfg = cfg.replace(n_layers=MOE_SERVE_LAYERS)
    params = random_params(cfg, 0, "cuda")
    if args.arch != "h2o-danube-3-4b":
        # chip_smoke.py's engine: 4 slots, 64-token slots of 16-token
        # pages, 8 requests of 16 new tokens (prompts here of 24-48)
        eng = Engine(cfg, params, 4, max_len=64, page_size=16,
                     device="cuda")
        warm = make_requests(cfg, 8, 48, 16, seed=0)
        reqs = make_requests(cfg, 8, 48, 16, seed=1)
    else:
        # chip_smoke.py's windowed engine: 4 slots over 4096-slot rings
        eng = Engine(cfg, params, 4, max_len=4352, device="cuda")
        warm = _ring_requests(cfg, 4, 4, seed=0)
        reqs = _ring_requests(cfg, 4, 12, seed=1)
    del params
    step, prefill, verify = eng.decode, eng.prefill, eng.verify

    def spanned(params, caches, toks):
        name = SPANS[0] if toks.shape[1] == 1 else SPANS[1]
        with torch.profiler.record_function(name):
            return step(params, caches, toks)

    def spanned_prefill(*a):
        with torch.profiler.record_function(SPANS[2]):
            return prefill(*a)

    def spanned_verify(*a):
        with torch.profiler.record_function(SPANS[3]):
            return verify(*a)

    eng.decode, eng.prefill = spanned, spanned_prefill
    if eng.spec:
        eng.verify = spanned_verify

    def step_totals():
        return {"decode": (eng.decode_seconds, eng.decode_steps),
                "verify": (eng.verify_seconds, eng.sched.verify_steps)}

    def mean_ms(before, after):
        return {kind: 1e3 * (after[kind][0] - before[kind][0])
                / (after[kind][1] - before[kind][1])
                for kind in after if after[kind][1] > before[kind][1]}

    t_start = step_totals()
    eng.run(warm)
    t_warm = step_totals()
    for r in reqs:
        r.rid += len(warm)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        report = summarize(json.load(f))
    untraced = mean_ms(t_start, t_warm)
    traced = mean_ms(t_warm, step_totals())
    for kind in untraced:
        report[f"mean_{kind}_step_ms"] = {"untraced": untraced[kind],
                                          "traced": traced.get(kind)}
        # kernel durations do not depend on the host, so the traced card
        # time over the untraced step reads the untraced step's idle share
        if f"{kind}_step" in report and untraced[kind] > 0:
            report[f"{kind}_card_idle_share_untraced"] = (
                1.0 - report[f"{kind}_step"]["card_busy_ms"]
                / untraced[kind])
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
