"""Batched serving on the PyTorch/CUDA port (the twin of
serve_batched.py): the paged continuous-batching engine over a request
queue with mixed prompt lengths, with the fp8-at-rest serving defaults:
build-time pre-quantized weights, the fp8 KV cache, the decode-attention
kernel, and per-slot depths with floating-page block tables.  Prompts
are chunk-prefilled through the decode-mode step, interleaved with the
resident rows' decode steps.  A second wave shares a system prompt: its
page-aligned prefix is stored once and served copy-on-write, and only
each request's unshared suffix chunk-prefills.

  PYTHONPATH=src python examples/serve_batched_torch.py            # on the card
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu \
      --metrics-out build/metrics.json --trace-out build/trace.json

``--metrics-out`` writes the metrics registry's snapshot as JSON at the
end, ``--trace-out`` the engine's step spans as Chrome-trace JSON.  The
weights come from a torch generator, so the generated tokens are
not the reference example's; the prefix-cache counts are.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.runtime_flags import serve_prequant
from repro_torch.models.attention import resolve_kv_cache_dtype
from repro_torch.launch.serve import random_params
from repro_torch.serving import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON at "
                         "the end")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the engine's step spans and write the "
                         "Chrome-trace JSON at the end")
    args = ap.parse_args(argv)
    tracer = None
    if args.trace_out:
        from repro_torch.obs.trace import get_tracer

        tracer = get_tracer().enable(path=args.trace_out)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    params = random_params(cfg, 0, dev)
    rng = np.random.default_rng(0)

    # mixed prompt lengths: slots at different depths share one decode
    # batch through the per-slot depths
    requests = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab,
                                    size=int(rng.integers(8, 28)),
                                    dtype=np.int32),
                max_new=12)
        for i in range(10)
    ]
    print(f"{len(requests)} requests (prompt lengths "
          f"{[r.prompt_len for r in requests]}), 4 decode slots "
          f"(paged continuous batching) on {dev}")
    engine = Engine(cfg, params, num_slots=4, max_len=64, device=dev)
    prequant = engine.scales is not None and serve_prequant()
    print(f"weights: "
          f"{'pre-quantized fp8' if prequant else 'quantized in the step (REPRO_SERVE_PREQUANT=0)'}"
          f" | kv cache: {resolve_kv_cache_dtype(cfg)}"
          f" | page pool: {engine.kv.allocator.num_pages} pages x "
          f"{engine.kv.allocator.page_size} tokens")
    done = engine.run(requests)
    assert all(r.done for r in done) and len(done) == len(requests)
    for r in done[:3]:
        print(f"request {r.rid}: prompt[:6]={r.prompt[:6].tolist()} "
              f"-> generated {r.out}")
    s = engine.stats()
    print(f"mean TTFT {1e3 * s['mean_ttft_s']:.1f} ms | "
          f"mean TPOT {1e3 * s['mean_tpot_s']:.1f} ms")

    # -- shared-system-prompt wave: the prefix-cache path --------------
    system_prompt = rng.integers(0, cfg.vocab, size=32, dtype=np.int32)
    wave = [
        Request(rid=100 + i,
                prompt=np.concatenate(
                    [system_prompt,
                     rng.integers(0, cfg.vocab,
                                  size=int(rng.integers(2, 8)),
                                  dtype=np.int32)]),
                max_new=8)
        for i in range(6)
    ]
    print(f"\nshared-prefix wave: {len(wave)} requests repeating a "
          f"{len(system_prompt)}-token system prompt")
    skipped_before = s["prefill_tokens_skipped"]
    done = engine.run(wave)
    assert all(r.done for r in done) and len(done) == len(wave)
    s = engine.stats()
    hits = [r for r in wave if r.prefix_pages > 0]
    # the first wave request chunk-prefills the system prompt; every
    # later one maps its pages copy-on-write and chunks only its own
    # few-token suffix
    assert len(hits) == len(wave) - 1, \
        [(r.rid, r.prefix_pages) for r in wave]
    assert (s["prefill_tokens_skipped"] - skipped_before
            == (len(wave) - 1) * len(system_prompt))
    print(f"prefix hits {len(hits)}/{len(wave)} | prefill tokens "
          f"skipped {s['prefill_tokens_skipped']} | pages shared "
          f"{s['pages_shared']} | CoW copies {s['cow_copies']} | "
          f"peak pool pages {s['peak_pool_pages']}")

    if tracer is not None:
        print(f"trace: {tracer.save()} ({len(tracer)} events)")
    if args.metrics_out:
        from repro_torch.obs.metrics import get_registry

        with open(args.metrics_out, "w") as f:
            f.write(get_registry().to_json(indent=2))
        print(f"metrics: {args.metrics_out}")
    return s


if __name__ == "__main__":
    main()
