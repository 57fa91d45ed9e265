"""Where a serving run's time goes on the card.

Builds the full-width engine that ``chip_smoke.py`` serves with, serves
one untraced warm-up trace, then serves a second trace under
``torch.profiler`` with every model step inside a ``decode_step`` or
``prefill_chunk`` span.  From the profiler's Chrome trace it reports,
per kind of step: the host span of the step function, the card's busy
time for the work launched in it (the union of its kernels' and copies'
intervals), the launches, and the card time by kernel; and for the
whole traced run the card's idle share.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --trace build/serve_trace.json

The profiler adds host time to every launch, so the traced steps are
slower than the warm-up's; both mean decode steps are printed.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json

import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import make_requests, random_params
from repro_torch.serving import Engine

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("decode_step", "prefill_chunk")
# the port's own kernels (csrc/*.cu), by the name the trace gives them
PORT_KERNELS = ("mx_gemm_kernel", "fused_quant_gemm_kernel",
                "fused_quant_gemm_tiled_kernel", "mx_dw_gemm_kernel",
                "group_gemm_kernel", "mx_quant_kernel",
                "decode_attn_paged_kernel", "moe_gmm_kernel",
                "moe_dw_gemm_kernel")


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="serve_trace.json",
                    help="where to write the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")

    # chip_smoke.py's engine: full width, 4 slots, 64-token slots of
    # 16-token pages, 8 requests of 16 new tokens (prompts here of 24-48
    # tokens)
    cfg = get_config("phi3-mini-3.8b")
    eng = Engine(cfg, random_params(cfg, 0, "cuda"), 4, max_len=64,
                 page_size=16, device="cuda")
    step = eng.decode

    def spanned(params, caches, toks):
        name = SPANS[0] if toks.shape[1] == 1 else SPANS[1]
        with torch.profiler.record_function(name):
            return step(params, caches, toks)

    eng.decode = spanned
    warm = make_requests(cfg, 8, 48, 16, seed=0)
    eng.run(warm)
    warm_step = eng.decode_seconds / eng.decode_steps
    eng.decode_seconds, eng.decode_steps = 0.0, 0
    reqs = make_requests(cfg, 8, 48, 16, seed=1)
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
    untraced = 1e3 * warm_step
    report["mean_decode_step_ms"] = {
        "untraced": untraced,
        "traced": 1e3 * eng.decode_seconds / eng.decode_steps}
    # kernel durations do not depend on the host, so the traced card
    # time over the untraced step reads the untraced step's idle share
    if "decode_step" in report and untraced > 0:
        report["decode_card_idle_share_untraced"] = (
            1.0 - report["decode_step"]["card_busy_ms"] / untraced)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
