"""Serving CLI: drives the port's paged continuous-batching engine, or
the legacy contiguous-ring ``Server`` (``--legacy`` or
``REPRO_SERVE_PAGED=0``), on random weights made from a seed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --requests 8 --max-new 16              # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \\
      --smoke --device cpu --legacy
  REPRO_SPEC_DECODE=1 PYTHONPATH=src python -m repro_torch.launch.serve \\
      --smoke --device cpu             # speculative verify steps
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi3.5-moe-42b-a6.6b --layers 4   # the MoE at full width
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --smoke --device cpu   # MLA, identity rows
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --layers 4   # dense0 + 3 MoE layers
  REPRO_SERVE_PREQUANT=0 REPRO_SERVE_DELAYED_ACT=0 \\
  REPRO_DECODE_ATTN=einsum PYTHONPATH=src \\
      python -m repro_torch.launch.serve --smoke --device cpu   # switches
  REPRO_QUANT_HEALTH=1 REPRO_KV_CACHE=bf16 PYTHONPATH=src \\
      python -m repro_torch.launch.serve --smoke --device cpu \\
      --metrics-out build/metrics.json --trace-out build/trace.json

``--metrics-out`` writes the metrics registry's snapshot as JSON at the
end, ``--trace-out`` records the engine's step spans and writes the
Chrome-trace JSON (as ``REPRO_TRACE=PATH`` does).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.runtime_flags import paged_placement, serve_paged
from repro_torch.models.layers import init_tree
from repro_torch.models.transformer import init_caches, model_defs
from repro_torch.serving import Engine, Request, greedy_sample
from repro_torch.serving.engine import (
    calibrate_serving,
    prepare_weights,
    resolve_device,
    to_device,
)
from repro_torch.serving.paged_cache import write_row
from repro_torch.serving.scheduler import RequestState, hit_stop
from repro_torch.train.steps import make_decode_step, make_prefill_step


class Server:
    """Legacy continuous batching (counterpart of
    ``repro.launch.serve.Server``): a FIXED batch of B decode slots over
    one slot-shaped contiguous KV cache, FIFO refill, no page
    accounting, no scheduler and no retirement of finished rows from the
    decode batch (the paged ``Engine`` adds all three).  The cache is
    allocated once with per-slot depths, so a refilled request keeps
    every other slot's depth, ring position and validity mask."""

    def __init__(self, cfg, params, batch_slots: int, max_len: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        with torch.inference_mode():
            params = to_device(params, self.device)
            self.params, self.scales = prepare_weights(cfg, params)
            self.act_scales = calibrate_serving(cfg, self.params,
                                                self.scales)
        self._build_steps()
        self.caches = init_caches(cfg, batch_slots, max_len, per_slot=True,
                                  device=self.device)
        self.slots: list[Request | None] = [None] * batch_slots

    def _build_steps(self):
        self.prefill = make_prefill_step(self.cfg, self.max_len,
                                         scales=self.scales,
                                         act_scales=self.act_scales)
        # the engine's row order for its B rows (core.row_order), so
        # that a request gives the engine's stream
        self.decode = make_decode_step(self.cfg, scales=self.scales,
                                       act_scales=self.act_scales,
                                       rows=self.B)

    def refresh_act_scales(self, tokens=None, margin=None):
        """Calibrate the delayed activation scales again and rebuild the
        steps (``Engine.refresh_act_scales``)."""
        if self.act_scales is None:
            return None
        from repro_torch.core.actscale import calibrate_act_scales

        kw = {} if margin is None else {"margin": margin}
        self.act_scales = calibrate_act_scales(
            self.cfg, self.params, self.scales, tokens=tokens, **kw)
        self._build_steps()
        return self.act_scales

    def _prefill_request(self, req: Request, slot: int):
        req.state = RequestState.RUNNING
        toks = torch.from_numpy(np.asarray(req.prompt, np.int32)[None])
        logits, one = self.prefill(self.params, toks.to(self.device))
        self._on_token(req, int(greedy_sample(logits)[0]))
        # this request's one-row cache into slot `slot`, stamping ITS
        # prompt length; slots at other depths are untouched
        write_row(self.caches, one, slot, len(req.prompt))

    def _on_token(self, req: Request, token: int):
        req.out.append(token)
        if hit_stop(req, token):
            req.state = RequestState.FINISHED

    @torch.inference_mode()
    def step(self, queue: list[Request]):
        for i in range(self.B):
            if self.slots[i] is None or self.slots[i].done:
                if queue:
                    req = queue.pop(0)
                    self._prefill_request(req, i)
                    self.slots[i] = req
        # finished slots still ride along at fixed B
        active = [i for i in range(self.B)
                  if self.slots[i] is not None and not self.slots[i].done]
        if not active:
            return
        last = np.zeros((self.B, 1), np.int32)
        for i in active:
            last[i, 0] = self.slots[i].out[-1]
        logits, self.caches = self.decode(
            self.params, self.caches, torch.from_numpy(last).to(self.device))
        nxt = greedy_sample(logits).cpu().numpy()
        for i in active:
            self._on_token(self.slots[i], int(nxt[i]))

    def run(self, requests: list[Request], log=print):
        queue = list(requests)
        t0 = time.time()
        steps = 0
        while queue or any(s is not None and not s.done
                           for s in self.slots):
            self.step(queue)
            steps += 1
            if steps > 10_000:
                raise RuntimeError("serving loop did not converge")
        dt = time.time() - t0
        toks = sum(len(r.out) for r in requests)
        if log is not None:
            log(f"served {len(requests)} requests, {toks} tokens in "
                f"{dt:.2f}s ({toks / max(dt, 1e-9):,.1f} tok/s, {steps} "
                "engine steps)")
        return requests


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int) -> list[Request]:
    """Mixed prompt lengths in [prompt_len // 2, prompt_len]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(4, prompt_len // 2), prompt_len + 1, size=n)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=int(k),
                                        dtype=np.int32),
                    max_new=max_new)
            for i, k in enumerate(lens)]


def random_params(cfg, seed: int, device) -> dict:
    """The model's parameters from ``seed`` with a torch Generator on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_tree(model_defs(cfg), gen, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth, the leading dense layers of "
                         "deepseek first (the engine builds from the "
                         "seeded f32 tree: phi3.5-moe's 32 layers would be "
                         "~84 GB even in bf16)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool budget (default: fully backed slots; "
                         "a smaller pool preempts requests to the host)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legacy", action="store_true",
                    help="the legacy contiguous-ring Server (same as "
                         "REPRO_SERVE_PAGED=0)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON at "
                         "the end")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the engine's step spans and write the "
                         "Chrome-trace JSON at the end (same as "
                         "REPRO_TRACE=PATH)")
    args = ap.parse_args(argv)
    tracer = None
    if args.trace_out:
        from repro_torch.obs.trace import get_tracer

        tracer = get_tracer().enable(path=args.trace_out)
    out = _serve(args)
    if tracer is not None:
        print(f"trace: {tracer.save()} ({len(tracer)} events)")
    if args.metrics_out:
        from repro_torch.obs.metrics import get_registry

        with open(args.metrics_out, "w") as f:
            f.write(get_registry().to_json(indent=2))
        print(f"metrics: {args.metrics_out}")
    return out


def _serve(args):
    """The engine (or the legacy Server) of ``args``, after serving its
    requests."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    device = torch.device(args.device)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.max_new, args.seed)
    params = random_params(cfg, args.seed, device)
    max_len = args.prompt_len + args.max_new
    if args.legacy or not serve_paged():
        server = Server(cfg, params, args.slots, max_len=max_len,
                        device=device)
        print(f"path: legacy contiguous-ring Server on {device}")
        server.run(reqs)
        return server
    if paged_placement() == "float":
        # floating pages need a whole number of pages a slot
        max_len = -(-max_len // args.page_size) * args.page_size
    engine = Engine(cfg, params, args.slots, max_len=max_len,
                    page_size=args.page_size, num_pages=args.num_pages,
                    device=device)
    print(f"path: paged continuous-batching engine on {device} "
          f"({'float' if engine.float_pages else 'identity'} placement, "
          f"{'chunked' if engine.chunked else 'whole-prompt'} prefill"
          f"{', speculative verify' if engine.spec else ''})")
    engine.run(reqs)
    st = engine.stats()          # publishes the engine_* and sched_* rows
    qh = st.get("quant_health")
    if qh is not None:
        print(f"quant health: {len(qh['sites'])} sites, "
              f"refresh_recommended={qh['refresh_recommended']}")
    if engine.spec:
        rate = st["spec_accept_rate"]
        print(f"speculative verify: {st['spec_verify_steps']} verify steps, "
              f"{st['decode_steps']} plain decode steps, accept rate "
              f"{'n/a' if rate is None else f'{rate:.3f}'}")
    return engine


if __name__ == "__main__":
    main()
