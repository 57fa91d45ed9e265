"""Where a serving run's time goes on the card.

Builds a full-width engine that ``chip_smoke.py`` serves with (phi3-mini
on floating pages; ``--arch phi3.5-moe-42b-a6.6b``, the MoE, the same
way with its depth cut to ``MOE_SERVE_LAYERS``; ``--arch
deepseek-v2-lite-16b`` cut to the same depth, its leading dense layer
and the MoE layers after it, on identity rows with the whole-prompt
prefill, as the engine serves MLA's latent cache; or with ``--arch
h2o-danube-3-4b`` the windowed model on identity rows with the
whole-prompt prefill, its prompts at or past the 4096-token window so
that every decode step reads a full ring; ``--arch stablelm-12b`` or
``minitron-8b`` at ``FAMILY_SERVE_LAYERS`` on floating pages,
``--arch recurrentgemma-2b`` or ``rwkv6-3b`` at full depth on identity
rows with the exact-length whole-prompt prefill; or ``--arch
musicgen-medium`` at full depth and ``phi-3-vision-4.2b`` at
``FAMILY_SERVE_LAYERS`` through the legacy ``Server``, which serves
their token prompts through the embedding table where the engine
refuses embeddings-input models),
serves one untraced warm-up trace, then serves a second trace under
``torch.profiler`` with every model step inside a ``decode_step``,
``prefill_chunk``, ``prefill`` (whole-prompt) or, under
``REPRO_SPEC_DECODE=1``, ``verify_step`` span, and rwkv6's WKV (the
chunked scan and the one-token update, plain torch) inside a ``wkv``
span of its own.  From the profiler's Chrome trace it reports,
per kind of step: the host span of the step function, the card's busy
time for the work launched in it (the union of its kernels' and copies'
intervals), the launches, the card time by kernel, the port kernels'
launches and the PyTorch ops issued (the ten most frequent, and
``WATCHED_OPS``); and for the whole traced run the card's idle share.
A launch belongs to the innermost span it was issued in, so a decode
step's numbers leave out its ``wkv`` span's (reported on their own).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --trace build/serve_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch h2o-danube-3-4b --trace build/ring_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch phi3.5-moe-42b-a6.6b --trace build/moe_serve_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch deepseek-v2-lite-16b --trace build/mla_serve_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch rwkv6-3b --trace build/rwkv_serve_trace.json

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
# the MoE models' depth (phi3.5-moe's of 32, deepseek's of 27: its
# leading dense layer and 3 MoE layers): the engine builds from the
# seeded f32 tree, and all 32 of phi3.5-moe's layers would be ~84 GB
# even in bf16.  Must equal chip_smoke.py's MOE_SERVE_LAYERS and
# MLA_SERVE_LAYERS, whose serving phases this profiles.
MOE_SERVE_LAYERS = 4
# stablelm-12b's and minitron-8b's serving depth (of 40 and 32): must
# equal chip_smoke.py's FAMILY_SERVE_LAYERS
FAMILY_SERVE_LAYERS = {"stablelm-12b": 8, "minitron-8b": 8,
                       "phi-3-vision-4.2b": 8}
SPANS = ("decode_step", "prefill_chunk", "prefill", "verify_step", "wkv")
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

    # spans nest (a decode step holds its wkv spans): each span's
    # enclosing one, so that a launch after an inner span has ended
    # goes to the span around it
    parent, open_ = [], []
    for i, (s0, s1, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] < s0:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)

    def innermost(ts) -> int:
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ts > spans[i][1]:
            i = parent[i]
        return i

    per_span = collections.defaultdict(list)
    for g in gpu:
        ts = launch_ts.get(g.get("args", {}).get("correlation"))
        i = innermost(ts) if ts is not None else -1
        if i >= 0:
            per_span[i].append(g)
    ops_in = collections.defaultdict(collections.Counter)
    for e in ev:
        if e.get("cat") == "cpu_op":
            i = innermost(e["ts"])
            if i >= 0:
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


def span_wkv() -> None:
    """Run rwkv6's WKV (``_wkv_chunked`` and ``_wkv_step``) inside a
    ``wkv`` span from now on."""
    from repro_torch.models import rwkv6

    def spanned(fn):
        def wkv(*a):
            with torch.profiler.record_function("wkv"):
                return fn(*a)
        return wkv

    rwkv6._wkv_chunked = spanned(rwkv6._wkv_chunked)
    rwkv6._wkv_step = spanned(rwkv6._wkv_step)


def _profile_server(cfg, params, trace_path: str) -> dict:
    """The legacy Server's run of chip_smoke.py's embeddings models (4
    slots, ``max_len`` 64, 8 requests of 16 new tokens): one untraced
    warm-up trace, then a second under the profiler."""
    import time

    from repro_torch.launch.serve import Server

    srv = Server(cfg, params, batch_slots=4, max_len=64, device="cuda")
    step, prefill, times = srv.decode, srv.prefill, []

    def spanned(*a):
        with torch.profiler.record_function(SPANS[0]):
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

    def spanned_prefill(*a):
        with torch.profiler.record_function(SPANS[2]):
            return prefill(*a)

    srv.decode, srv.prefill = spanned, spanned_prefill
    srv.run(make_requests(cfg, 8, 48, 16, seed=0))
    untraced = 1e3 * sum(times) / len(times)
    del times[:]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        srv.run(make_requests(cfg, 8, 48, 16, seed=1))
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        report = summarize(json.load(f))
    report["mean_decode_step_ms"] = {
        "untraced": untraced, "traced": 1e3 * sum(times) / len(times)}
    if "decode_step" in report:
        report["decode_card_idle_share_untraced"] = (
            1.0 - report["decode_step"]["card_busy_ms"] / untraced)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=("phi3-mini-3.8b", "phi3.5-moe-42b-a6.6b",
                             "deepseek-v2-lite-16b", "h2o-danube-3-4b",
                             "stablelm-12b", "minitron-8b",
                             "recurrentgemma-2b", "rwkv6-3b",
                             "musicgen-medium", "phi-3-vision-4.2b"))
    ap.add_argument("--trace", default="serve_trace.json",
                    help="where to write the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")

    cfg = get_config(args.arch)
    if cfg.family in ("moe", "mla_moe"):
        # the leading dense layers stay (the cut keeps the first layers)
        cfg = cfg.replace(n_layers=max(MOE_SERVE_LAYERS,
                                       cfg.first_dense + 1))
    elif args.arch in FAMILY_SERVE_LAYERS:
        cfg = cfg.replace(n_layers=FAMILY_SERVE_LAYERS[args.arch])
    params = random_params(cfg, 0, "cuda")
    if cfg.family == "ssm":
        span_wkv()
    if cfg.input_mode == "embeddings":
        report = _profile_server(cfg, params, args.trace)
        print(json.dumps(report, indent=1))
        return report
    if cfg.family == "hybrid":
        # chip_smoke.py's recurrentgemma engine: identity rows over its
        # 2048-slot rings, the whole-prompt prefill at the exact length
        eng = Engine(cfg, params, 4, max_len=2176, device="cuda")
        warm = make_requests(cfg, 8, 48, 16, seed=0)
        reqs = make_requests(cfg, 8, 48, 16, seed=1)
    elif cfg.family == "ssm":
        # chip_smoke.py's rwkv6 engine: identity rows of 64 tokens, the
        # whole-prompt prefill at the exact length
        eng = Engine(cfg, params, 4, max_len=64, device="cuda")
        warm = make_requests(cfg, 8, 48, 16, seed=0)
        reqs = make_requests(cfg, 8, 48, 16, seed=1)
    elif args.arch != "h2o-danube-3-4b":
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
