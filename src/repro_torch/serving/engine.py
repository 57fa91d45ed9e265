"""Continuous-batching serving engine over the paged KV cache
(counterpart of ``repro.serving.engine``).

Scheduler v2 (the default; chunked prefill): one engine ``step()`` is

  1. retire finished requests (release their pages, shrink them out of
     the decode batch);
  2. swap preempted requests back in, first in first out, while their
     pages fit;
  3. up to ``Scheduler.chunk_budget()`` chunked-prefill steps: the
     staging request's next ``chunk_tokens`` prompt tokens run as one
     (1, chunk) decode-mode step, written at the request's own depth
     (into its own pages, or into a detached one-row cache under
     identity placement); the final chunk's last real logit is the
     first output token, and the request joins the decode batch;
  4. retire again (an attached request may finish at once), then one
     batched (B, 1) decode over the resident rows, every row at its
     own depth; or, with speculative decode (``spec_decode=True`` or
     ``REPRO_SPEC_DECODE=1``), one (B, k) verify step: up to k - 1
     draft tokens per row from the draft source (``NgramDraft`` unless
     another is given), all k positions through one forward over the
     cache, and per row the longest draft prefix that matches the
     model's own argmax committed, plus the model's next token.  Greedy
     output is token for token that of plain decode.

A prefix-cache hit (floating pages and chunked prefill; on unless
``prefix_cache=False`` or ``REPRO_PREFIX_CACHE=0``) maps the prompt's
page-aligned shared prefix onto the donor's physical pages, refcounted
and copy-on-write, and chunk-prefills only the unshared suffix (a full
hit still runs the last prompt token, whose logit is the first output).

The v1 path (``REPRO_CHUNKED_PREFILL=0``, and what an arch chunks
cannot serve takes without being asked: a windowed ring, MLA's latent
cache, the recurrent states of the hybrid and of rwkv6) prefills each
admitted prompt whole, right-padded to a 16-token bucket (the recurrent
families' at their exact length), in one (1, S) step, and admits on
worst-case reservations; the row it is written into takes the prompt's
caches and recurrent states.  Placement: floating pages by default,
identity rows (``REPRO_PAGED_PLACEMENT=identity``, a windowed ring,
whose cache is C = window < max_len slots, MLA's latent cache, the
hybrid and rwkv6).  The embeddings-input models (musicgen,
phi-3-vision) are refused, as the reference's engine refuses them: the
legacy ``Server`` serves them from token prompts.

Weights are pre-quantized to fp8 at build and the activation scales are
calibrated at build (one forward over a fixed prompt), as in the
reference; ``REPRO_SERVE_PREQUANT=0`` quantizes the weights in every
step against their build-time scales instead, and
``REPRO_SERVE_DELAYED_ACT=0`` measures every activation in the step
(``prepare_weights``, ``calibrate_serving``).  Dense, MoE and MLA models
serve alike: a MoE block's decode, verify and chunk steps take the
masked dense-experts combine, every expert on every token, each through
its own weight and activation scales, in every recipe.  On the card a
decode or verify step computes each row in an order that its batch does
not change (``core.row_order``, up to ``step_rows``).  With chunked prefill on floating pages
admission is usage-based (``REPRO_PREEMPTION``, on by default): a
request reserves its prompt plus one page, and growth past it extends
page by page.  When growth finds the pool dry the engine preempts the
victim ``Scheduler.pick_victim`` names: its live pages are copied to the
host bit for bit and freed, and it waits in a deque until retirement
frees enough pages to swap it back in at its recorded depth.
``REPRO_PREEMPTION=0`` admits on worst-case reservations instead.
Speculative decode needs the chunked path, an unwrapped cache
(``spec_verify_supported``) and delayed activation scales (or bf16);
elsewhere (a windowed ring, the v1 prefill,
``REPRO_SERVE_DELAYED_ACT=0``) the flag is inert, as in the reference.
``REPRO_KV_CACHE=bf16|fp8`` sets the pool's (or the rows') dtype for
every config (``models.attention.resolve_kv_cache_dtype``).

Observability (``repro_torch.obs``), as in the reference: ``step()``'s
phases are trace spans (``REPRO_TRACE``), ``stats()`` publishes the
engine's, the allocator's and the scheduler's numbers into the metrics
registry, and with ``REPRO_QUANT_HEALTH=1`` (and delayed activation
scales) the engine keeps a health-instrumented variant of each step and
runs it on the first call of every (step, token shape) and then every
``REPRO_QUANT_HEALTH_EVERY`` + 1-th call; its per-site statistics go to
a ``HealthAggregator`` (``stats()["quant_health"]``), whose
``refresh_recommended`` points at ``refresh_act_scales``.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU;
there it runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.actscale import calibrate_act_scales
from repro_torch.core.runtime_flags import (
    chunked_prefill,
    paged_placement,
    quant_health,
    quant_health_every,
    serve_delayed_act,
    serve_preemption,
    serve_prefix_cache,
    serve_prequant,
    spec_decode as spec_decode_flag,
)
from repro_torch.models.transformer import (
    cache_idx,
    chunk_prefill_supported,
    init_caches,
    paged_decode_supported,
    spec_verify_supported,
)
from repro_torch.train.steps import (
    make_decode_step,
    make_prefill_step,
    make_verify_step,
    prequantize_params,
    serve_weight_scales,
)

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import instant, span

from .paged_cache import (
    PAGE_SIZE,
    FloatingPageCache,
    PagedKVCache,
    PageExhausted,
    SlotCapacityExceeded,
    page_keys,
)
from .scheduler import Request, RequestState, Scheduler, SLOTargets
from .spec import DraftSource, NgramDraft

PROMPT_BUCKET = 16
CHUNK_TOKENS = 32


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU.
    Asking for CUDA on a machine without it raises; nothing falls back
    to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    return dev


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def prepare_weights(cfg, params):
    """Build-time weight preparation shared by the engine, the legacy
    Server and the serving profiler (the reference's): fp8 payloads and
    per-(layer[, expert]) scales by default (the raw tree and None in
    bf16 mode); under ``REPRO_SERVE_PREQUANT=0`` the raw tree and its
    build-time scales (``serve_weight_scales``), which every step then
    casts the weights against.  Returns (tree, scales)."""
    if not serve_prequant():
        return params, serve_weight_scales(cfg, params)
    prequant = prequantize_params(cfg, params)
    if prequant is None:
        return params, None
    return prequant.qweights, prequant.scales


def calibrate_serving(cfg, params, scales):
    """Build-time delayed activation scales shared by the engine, the
    legacy Server and the serving profiler (the reference's): one
    forward over the calibration prompt (``core.actscale``), or None
    under ``REPRO_SERVE_DELAYED_ACT=0``, where every quantized site
    measures its activation in the step (``dispatch.
    fused_quant_matmul``)."""
    if not serve_delayed_act():
        return None
    return calibrate_act_scales(cfg, params, scales)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B,) argmax of the last position (first
    index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1)


@dataclasses.dataclass
class PrefixPlan:
    """Admission-time prefix-cache decision for one request.

    ``keys``        chained page hashes of every full prompt page
    ``pages``       physical pages hit (the longest registered prefix
                    run, at most the prompt's full pages); empty: cold
    ``suffix_from`` first prompt position that chunk-prefills:
                    ``min(n_shared·T, prompt_len - 1)`` (a full hit
                    still runs the last prompt token through a chunk,
                    whose logit is the first output)
    ``cow_slack``   1 when the suffix's first write lands inside a
                    shared page (a full page-aligned hit), else 0: kept
                    in reserve so that the copy-on-write can allocate"""
    keys: list
    pages: list
    suffix_from: int
    cow_slack: int


@dataclasses.dataclass
class _Staging:
    """The one request currently chunk-prefilling: its pages are
    admitted but it has no decode-batch row until the last chunk."""
    req: Request
    pos: int                  # next prompt position to chunk-prefill
    keys: list | None         # page hashes to publish at attach (float)
    row_cache: dict | None    # detached one-row caches (identity only)


class Engine:
    """Paged-KV continuous-batching engine (see module docstring)."""

    def __init__(self, cfg, params, num_slots: int, max_len: int, *,
                 page_size: int = PAGE_SIZE,
                 num_pages: int | None = None,
                 chunk_tokens: int = CHUNK_TOKENS,
                 eos_id: int | None = None,
                 prefix_cache: bool | None = None,
                 slo: SLOTargets | None = None,
                 spec_decode: bool | None = None,
                 draft: DraftSource | None = None,
                 spec_k: int = 4,
                 device="cuda"):
        self.device = resolve_device(device)
        if cfg.input_mode != "tokens":
            raise ValueError(f"serving engine drives token models; "
                             f"{cfg.name} has input_mode="
                             f"{cfg.input_mode!r}")
        self.cfg = cfg
        self.max_len = max_len
        self.num_slots = num_slots
        # a recurrent state (RG-LRU, rwkv6's WKV and shift states)
        # integrates every prefill token, so a padded prompt would corrupt
        # it (attention caches mask the padding): those families prefill
        # at their exact length
        self.prompt_bucket = (1 if cfg.family in ("ssm", "hybrid")
                              else PROMPT_BUCKET)
        self.eos_id = eos_id
        with torch.inference_mode():
            params = to_device(params, self.device)
            self.params, self.scales = prepare_weights(cfg, params)
            self.act_scales = calibrate_serving(cfg, self.params,
                                                self.scales)
        self.float_pages = (paged_placement() == "float"
                            and paged_decode_supported(cfg, max_len,
                                                       page_size))
        self.chunked = (chunked_prefill()
                        and chunk_prefill_supported(cfg, max_len))
        # preemption = usage-based admission + swap to host; both live
        # on the floating pool's block tables
        self.preemption = (serve_preemption() and self.chunked
                           and self.float_pages)
        if self.float_pages:
            self.kv = FloatingPageCache(cfg, max_len, num_slots,
                                        page_size=page_size,
                                        num_pages=num_pages,
                                        usage_mode=self.preemption,
                                        device=self.device)
        else:
            self.kv = PagedKVCache(cfg, max_len, num_slots,
                                   page_size=page_size,
                                   num_pages=num_pages, device=self.device)
        # prefix hits chunk-prefill the unshared suffix: no chunked
        # prefill or no floating pages, no prefix cache
        self.prefix_cache = (self.float_pages and self.chunked
                             and (serve_prefix_cache()
                                  if prefix_cache is None
                                  else bool(prefix_cache)))
        self.chunk_tokens = max(1, min(chunk_tokens, self.kv.slot_tokens))
        # speculative decode (the constructor's argument wins over the
        # flag) rides on the chunked path: per-slot depths and an
        # unwrapped cache.  It also needs batch-independent activation
        # scales (delayed, or the bf16 pipeline): a just-in-time amax
        # over a (B, k) window would differ from the (B, 1) steps it
        # replaces: under REPRO_SERVE_DELAYED_ACT=0 the flag is inert.
        self.spec = ((spec_decode if spec_decode is not None
                      else spec_decode_flag())
                     and self.chunked
                     and spec_verify_supported(cfg, max_len)
                     and (self.act_scales is not None
                          or cfg.quant.mode == "bf16"))
        self.draft: DraftSource = draft if draft is not None \
            else NgramDraft()
        self.spec_k = max(1, int(spec_k))
        # the most rows a decode or verify step takes (a verify step
        # runs at most spec_k positions a slot: Scheduler.draft_len): up
        # to that many, the card computes each row in an order that its
        # batch does not change (core.row_order), so a request's stream
        # does not depend on the requests beside it
        self.step_rows = num_slots * (self.spec_k if self.spec else 1)
        self.qh = None
        self._build_steps()
        self._staging: _Staging | None = None
        self._preempted: deque[tuple[Request, dict]] = deque()
        self.prefill_calls = 0
        self.prefill_tokens_skipped = 0
        self.prefix_hits = 0
        self.pages_shared = 0
        self.preemptions = 0
        self.swap_ins = 0
        self.prefill_seconds = 0.0
        self.chunk_prefill_steps = 0
        self.chunked_requests = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.verify_seconds = 0.0
        self.sched = Scheduler(slo=slo)
        self.requests: dict[int, Request] = {}

    def _build_steps(self):
        """The serving steps over the current activation scales.
        Quant-health is resolved here, at build: it needs the delayed
        activation scales (the statistics measure drift against them),
        and with it on the engine keeps both variants of each step and
        runs the instrumented one on the calls ``_health_due`` picks."""
        self.health = quant_health() and self.act_scales is not None
        self.health_every = quant_health_every() if self.health else 0
        # per (step kind, token shape): the first call of each samples
        self._health_countdown: dict = {}
        if self.health and self.qh is None:
            from repro_torch.obs.quant_health import HealthAggregator

            self.qh = HealthAggregator()
        elif not self.health:
            self.qh = None
        kw = dict(scales=self.scales, act_scales=self.act_scales)
        self.prefill = make_prefill_step(self.cfg, self.max_len, **kw)
        self.decode = make_decode_step(self.cfg, rows=self.step_rows, **kw)
        self.verify = (make_verify_step(self.cfg, rows=self.step_rows,
                                        **kw) if self.spec else None)
        if self.health:
            self.prefill_h = make_prefill_step(self.cfg, self.max_len,
                                               quant_health=True, **kw)
            self.decode_h = make_decode_step(self.cfg, rows=self.step_rows,
                                             quant_health=True, **kw)
            self.verify_h = (make_verify_step(self.cfg, rows=self.step_rows,
                                              quant_health=True, **kw)
                             if self.spec else None)

    # -- quant-health step-call shims ----------------------------------
    # Health off: the plain steps.  Health on: the calls _health_due
    # picks run the instrumented variant, whose third output goes to the
    # aggregator.
    def _health_due(self, kind: str, shape) -> bool:
        if not self.health:
            return False
        key = (kind, tuple(shape))
        cd = self._health_countdown.get(key)
        if cd is None or cd <= 0:
            self._health_countdown[key] = self.health_every
            return True
        self._health_countdown[key] = cd - 1
        return False

    def _run_prefill(self, params, toks, last):
        if self._health_due("prefill", toks.shape):
            logits, caches, tree = self.prefill_h(params, toks, last)
            self.qh.ingest(tree)
            return logits, caches
        return self.prefill(params, toks, last)

    def _run_decode(self, params, caches, toks):
        if self._health_due("decode", toks.shape):
            logits, caches, tree = self.decode_h(params, caches, toks)
            self.qh.ingest(tree)
            return logits, caches
        return self.decode(params, caches, toks)

    def _run_verify(self, params, caches, toks):
        if self._health_due("verify", toks.shape):
            logits, caches, tree = self.verify_h(params, caches, toks)
            self.qh.ingest(tree)
            return logits, caches
        return self.verify(params, caches, toks)

    def refresh_act_scales(self, tokens=None, margin=None):
        """Calibrate the delayed activation scales again (on ``tokens``
        when given, with ``margin`` when given) and rebuild the steps;
        None, and nothing done, without delayed scales."""
        if self.act_scales is None:
            return None
        kw = {} if margin is None else {"margin": margin}
        self.act_scales = calibrate_act_scales(
            self.cfg, self.params, self.scales, tokens=tokens, **kw)
        self._build_steps()
        return self.act_scales

    # -- admission -----------------------------------------------------
    def _total_tokens(self, req: Request) -> int:
        # worst-case resident K/V: prompt + every decode-step write
        return req.prompt_len + req.max_new - 1

    def _admit_tokens(self, req: Request) -> int:
        """Usage-based admission under preemption: the prompt plus one
        page of headroom (growth past it extends page by page); the
        worst case otherwise."""
        total = self._total_tokens(req)
        if self.preemption:
            return min(total, req.prompt_len + self.kv.page_size)
        return total

    def submit(self, requests: list[Request]) -> None:
        for req in requests:
            if req.eos_id is None:
                req.eos_id = self.eos_id
            total = self._total_tokens(req)
            if not self.kv.ring and total > self.kv.slot_tokens:
                raise SlotCapacityExceeded(
                    f"request {req.rid}: prompt {req.prompt_len} + "
                    f"max_new {req.max_new} needs {total} cache "
                    f"positions > slot capacity {self.kv.slot_tokens}")
            al = self.kv.allocator
            need = al.pages_needed(self.kv._resident(total))
            if need > al.num_pages:
                raise PageExhausted(
                    f"request {req.rid}: worst-case reservation of "
                    f"{need} pages exceeds the whole pool "
                    f"({al.num_pages} pages)")
            self.requests[req.rid] = req
        self.sched.submit(requests)

    def _prefix_plan(self, req: Request) -> PrefixPlan | None:
        """Look the request's page-aligned prompt prefix up in the hash
        map (None when the prefix cache is off)."""
        if not self.prefix_cache:
            return None
        t = self.kv.page_size
        keys = page_keys(req.prompt, t)
        pages = self.kv.allocator.lookup(keys)
        if not pages:
            return PrefixPlan(keys=keys, pages=[], suffix_from=0,
                              cow_slack=0)
        return PrefixPlan(keys=keys, pages=pages,
                          suffix_from=min(len(pages) * t,
                                          req.prompt_len - 1),
                          cow_slack=int(len(pages) * t >= req.prompt_len))

    # -- the engine step -----------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        # the spans wrap host-side phases (obs.trace): REPRO_TRACE adds
        # no device operation
        with span("engine.step", rows=len(self.kv.rows)):
            if not self.chunked:
                with span("retire_refill"):
                    self._retire_and_refill()
                    self._admit_new_rows()
                with span("decode", rows=len(self.kv.rows)):
                    self._decode_once()
                return
            with span("retire"):
                self._retire()
            with span("swap_in", preempted=len(self._preempted)):
                self._swap_in_preempted()
            with span("chunk_phase"):
                self._chunk_phase()
            with span("retire"):
                self._retire()  # an attached request may finish at once
            if self.spec:
                with span("verify", rows=len(self.kv.rows)):
                    self._verify_once()
            else:
                with span("decode", rows=len(self.kv.rows)):
                    self._decode_once()

    def _retire(self):
        row = 0
        while row < len(self.kv.rows):
            if self.requests[self.kv.rows[row]].done:
                self.kv.release(row)
                self.kv.shrink(row)   # swapped-in last row re-checked
            else:
                row += 1

    # -- preemption ----------------------------------------------------
    def _swap_in_preempted(self):
        """Resume preempted requests first in first out while their
        pages fit.  One slot stays free for the staging request, whose
        attach must never find the batch full."""
        while self._preempted:
            limit = self.num_slots - (self._staging is not None)
            if len(self.kv.rows) >= limit:
                return
            req, bundle = self._preempted[0]
            admit = (min(self._total_tokens(req),
                         bundle["depth"] + self.kv.page_size)
                     if self.preemption else self._total_tokens(req))
            try:
                self.kv.swap_in(bundle, admit)
            except PageExhausted:
                return            # stays parked; retirement frees pages
            self._preempted.popleft()
            req.state = RequestState.RUNNING
            self.swap_ins += 1

    def _preempt_one(self) -> bool:
        """Swap the victim the scheduler names out to the host; False
        when the decode batch has nobody left to preempt."""
        cands = [self.requests[rid] for rid in self.kv.rows
                 if rid is not None]
        victim = self.sched.pick_victim(cands)
        if victim is None:
            return False
        bundle = self.kv.swap_out(self.kv.rows.index(victim.rid))
        victim.state = RequestState.PREEMPTED
        self._preempted.append((victim, bundle))
        self.preemptions += 1
        instant("preempt", rid=victim.rid, depth=bundle["depth"])
        return True

    def _grow_or_preempt(self, grow) -> None:
        """Run a page-growing cache operation, preempting one victim per
        ``PageExhausted`` until it fits.  This ends: every preemption
        frees pages, and a lone resident request always fits (submit
        rejects a request larger than the whole pool)."""
        while True:
            try:
                grow()
                return
            except PageExhausted:
                if not (self.preemption and self._preempt_one()):
                    raise

    # -- chunked prefill -----------------------------------------------
    def _begin_staging(self) -> bool:
        """Pop the queue head into the staging slot when it fits under
        the actual free-page accounting (usage-based under preemption).
        Preempted requests drain first: they hold finished work, and no
        new request is admitted while any is parked, so their return is
        never starved."""
        if self._preempted:
            return False
        head = self.sched.peek()
        if head is None or len(self.kv.rows) >= self.num_slots:
            return False
        plan = self._prefix_plan(head)
        admit = self._admit_tokens(head)
        if plan is not None and plan.pages:
            ok = self.kv.can_admit(admit, shared=plan.pages,
                                   cow_slack=plan.cow_slack)
            if not ok and self.kv.can_admit(admit):
                # the hit needs more headroom than a cold admit (page
                # revival and the CoW slack, e.g. on a minimal pool):
                # serve it cold rather than hold the queue head forever
                plan = PrefixPlan(keys=plan.keys, pages=[],
                                  suffix_from=0, cow_slack=0)
                ok = True
        else:
            ok = self.kv.can_admit(admit)
        if not ok:
            return False          # stays queued (backpressure)
        req = self.sched.pop()
        pos, keys, row_cache = 0, None, None
        if self.float_pages:
            shared = plan.pages if plan is not None else []
            self.kv.stage_admit(req.rid, admit, shared=shared,
                                cow_slack=plan.cow_slack
                                if plan is not None else 0)
            keys = plan.keys if plan is not None else None
            if shared:
                pos = plan.suffix_from
                self.prefix_hits += 1
                self.prefill_tokens_skipped += pos
                self.pages_shared += len(shared)
                req.prefix_pages = len(shared)
                req.prefill_skipped = pos
        else:
            self.kv.stage_admit(req.rid, admit)
            row_cache = init_caches(self.cfg, 1, self.max_len,
                                    per_slot=True, device=self.device)
        self._staging = _Staging(req=req, pos=pos, keys=keys,
                                 row_cache=row_cache)
        self.chunked_requests += 1
        return True

    def _chunk_step(self) -> None:
        """One (1, chunk_tokens) prefill chunk of the staging request;
        the final chunk emits the first output token and attaches the
        request to the decode batch."""
        st = self._staging
        req, plen = st.req, st.req.prompt_len
        chunk = self.chunk_tokens
        n_real = min(chunk, plen - st.pos)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n_real] = req.prompt[st.pos:st.pos + n_real]
        toks = torch.from_numpy(toks).to(self.device)
        if self.float_pages:
            self._grow_or_preempt(
                lambda: self.kv.stage_ensure(req.rid, st.pos,
                                             st.pos + n_real))
            self.kv.stage_stamp(req.rid, st.pos)
            logits, self.kv.caches = self._run_decode(
                self.params, self.kv.caches, toks)
        else:
            # identity placement: the chunk runs on a detached one-row
            # cache; only the depth stamp moves between chunks
            for c in st.row_cache.values():
                cache_idx(c).fill_(st.pos)
            logits, _ = self._run_decode(self.params, st.row_cache, toks)
        self.chunk_prefill_steps += 1
        st.pos += n_real
        if st.pos < plen:
            return
        first = int(torch.argmax(logits[0, n_real - 1]))
        if self.float_pages:
            self.kv.stage_attach(req.rid, plen)
            if st.keys:
                self.kv.register_prompt(req.rid, st.keys)
        else:
            self.kv.stage_attach(req.rid, st.row_cache, plen)
        self._staging = None
        self.sched.on_token(req, first)

    def _chunk_phase(self):
        budget = self.sched.chunk_budget()
        while budget > 0:
            if self._staging is None and not self._begin_staging():
                return
            self._chunk_step()
            budget -= 1

    # -- v1: whole-prompt prefill admission -----------------------------
    def _bucket_len(self, n: int) -> int:
        c = self.kv.slot_tokens
        if n >= c:
            return n          # the ring's keep-last-C prefill, exact
        return min(c, -(-n // self.prompt_bucket) * self.prompt_bucket)

    def _prefill_request(self, req: Request) -> dict:
        """The (1, bucket) prefill of one prompt; returns the one-row
        caches and emits the request's first token (TTFT)."""
        n = req.prompt_len
        toks = np.zeros((1, self._bucket_len(n)), np.int32)
        toks[0, :n] = req.prompt
        t0 = time.perf_counter()
        logits, one = self._run_prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            min(n, toks.shape[1]) - 1)
        first = int(greedy_sample(logits)[0])
        self.prefill_seconds += time.perf_counter() - t0
        self.prefill_calls += 1
        self.sched.on_token(req, first)
        return one

    def _admissible_head(self) -> Request | None:
        """The head request when it fits under the pool's actual
        free-page accounting, else None."""
        head = self.sched.peek()
        if head is None or not self.kv.can_admit(self._total_tokens(head)):
            return None
        return head

    def _admit(self, req: Request, row: int | None = None) -> None:
        """Admit one popped request: whole-prompt prefill, then place its
        row (a new row, or ``row`` in place)."""
        one = self._prefill_request(req)
        total = self._total_tokens(req)
        if row is None:
            self.kv.append(req.rid, one, req.prompt_len, total)
        else:
            self.kv.refill(row, req.rid, one, req.prompt_len, total)

    def _retire_and_refill(self):
        row = 0
        while row < len(self.kv.rows):
            owner = self.kv.rows[row]
            if owner is not None and not self.requests[owner].done:
                row += 1
                continue
            if owner is not None:
                self.kv.release(row)
            head = self._admissible_head()
            if head is not None:
                # a refill may itself be done at once (max_new == 1 or
                # EOS): the loop re-checks this row
                self._admit(self.sched.pop(), row=row)
            else:
                self.kv.shrink(row)
                # the swapped-in last row is re-checked at this index

    def _admit_new_rows(self):
        while len(self.kv.rows) < self.num_slots:
            head = self._admissible_head()
            if head is None:
                break
            self._admit(self.sched.pop())
            if head.done:                         # instant finish
                self._retire_and_refill()

    # -- decode --------------------------------------------------------
    def _decode_once(self):
        if self.float_pages:
            # restamp idx / block tables; growth past a usage
            # reservation may find the pool dry (preempt and retry)
            self._grow_or_preempt(
                lambda: self.kv.prepare_decode() if self.kv.rows else None)
        rows = self.kv.rows
        if not rows:
            return
        feed = np.zeros((len(rows), 1), np.int32)
        for i, rid in enumerate(rows):
            feed[i, 0] = self.requests[rid].out[-1]
        t0 = time.perf_counter()
        logits, self.kv.caches = self._run_decode(
            self.params, self.kv.caches,
            torch.from_numpy(feed).to(self.device))
        self.kv.advance()
        nxt = greedy_sample(logits).cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        for i, rid in enumerate(list(rows)):
            self.sched.on_token(self.requests[rid], int(nxt[i]))

    # -- speculative verify --------------------------------------------
    def _verify_once(self):
        """One verify step over the resident rows: propose up to k - 1
        drafts per row, run all k positions ([last output, drafts...])
        through one (B, k) forward, and commit per row the longest
        draft prefix that matches the model's own argmax plus the
        model's next token.  k is cut so that no row can overrun its
        ``max_new`` budget or its slot, and the step falls back to
        ``_decode_once`` when that or an empty proposal round leaves
        nothing to try."""
        rows = self.kv.rows
        if not rows:
            return
        reqs = [self.requests[rid] for rid in rows]
        k = self.sched.draft_len(self.spec_k)
        for i, r in enumerate(reqs):
            # a k-step commits up to k tokens and writes k positions
            k = min(k, r.max_new - len(r.out),
                    self.kv.slot_tokens - self.kv.lengths[i])
        props = ([list(self.draft.propose(r, k - 1))[:k - 1]
                  for r in reqs] if k > 1 else [])
        if k > 1:
            k = min(k, 1 + max(len(p) for p in props))
        if k <= 1:
            self._decode_once()
            return
        feed = np.zeros((len(rows), k), np.int32)
        n_prop = []
        for i, r in enumerate(reqs):
            feed[i, 0] = r.out[-1]
            p = props[i][:k - 1]
            n_prop.append(len(p))
            # an unproposed slot stays 0: it commits only on an argmax
            # equal to 0, which is then plain decode's token anyway
            feed[i, 1:1 + len(p)] = p
        if self.float_pages:
            # make the whole k-token write window private, then restamp
            self._grow_or_preempt(
                lambda: self.kv.prepare_decode(write_tokens=k))
        t0 = time.perf_counter()
        logits, self.kv.caches = self._run_verify(
            self.params, self.kv.caches, torch.from_numpy(feed).to(
                self.device))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()     # (B, k)
        self.verify_seconds += time.perf_counter() - t0
        advs, accepted = [], 0
        for i, rid in enumerate(list(rows)):
            req = self.requests[rid]
            drafts_in, done, j = 0, False, 0
            # logits[i, j] is the model's prediction after feed[i, :j+1],
            # the j-th sequential step's: accept while the drafts match
            while j < k - 1 and int(feed[i, j + 1]) == int(nxt[i, j]):
                done = self.sched.on_token(req, int(feed[i, j + 1]))
                drafts_in += 1
                j += 1
                if done:
                    break         # EOS or budget inside the window
            if not done:
                # the model's own token at the first mismatch (or past
                # the window): a verify step always commits one
                self.sched.on_token(req, int(nxt[i, j]))
            # the depth advances by the committed tokens whose K/V this
            # step wrote: out[-1] and the accepted drafts (the new
            # token's K/V is written by the next step, as in decode)
            advs.append(drafts_in + (0 if done else 1))
            accepted += min(drafts_in, n_prop[i])
        self.kv.commit(advs)
        # the denominator is the whole (k-1)·B window, so unfilled slots
        # count as misses and the EMA shortens k
        self.sched.on_verify((k - 1) * len(rows), accepted)

    # -- the serving loop ----------------------------------------------
    def _idle(self) -> bool:
        return not (self.sched.queue or self.kv.rows
                    or self._staging is not None or self._preempted)

    def run(self, requests: list[Request] | None = None, log=print):
        """Drain the queue; returns the requests that finished during
        this call.  Requests with an ``arrival_time`` are submitted at
        that offset from the call's start, the rest up front."""
        requests = requests or []
        pending = deque(sorted(
            (r for r in requests if r.arrival_time is not None),
            key=lambda r: r.arrival_time))
        now_batch = [r for r in requests if r.arrival_time is None]
        if now_batch:
            self.submit(now_batch)
        done_before = {rid for rid, r in self.requests.items() if r.done}
        toks_before = sum(len(r.out) for r in self.requests.values())
        t0 = time.monotonic()
        steps = 0
        while pending or not self._idle():
            now = time.monotonic() - t0
            while pending and pending[0].arrival_time <= now:
                self.submit([pending.popleft()])
            if self._idle():
                time.sleep(min(pending[0].arrival_time - now, 0.05))
                continue
            self.step()
            steps += 1
            if steps > 100_000:
                raise RuntimeError("serving loop did not converge")
        dt = time.monotonic() - t0
        done = [r for rid, r in self.requests.items()
                if r.done and rid not in done_before]
        toks = sum(len(r.out) for r in self.requests.values()) \
            - toks_before
        if log is not None:
            ttfts = [r.ttft for r in done if r.ttft is not None]
            tpots = [r.tpot for r in done if r.tpot is not None]
            mean = lambda v: float(np.mean(v)) if v else float("nan")
            log(f"served {len(done)} requests, {toks} tokens in "
                f"{dt:.2f}s ({toks / max(dt, 1e-9):,.1f} tok/s, "
                f"{steps} engine steps, mean TTFT "
                f"{1e3 * mean(ttfts):.1f} ms, mean TPOT "
                f"{1e3 * mean(tpots):.1f} ms)")
        return done

    def stats(self) -> dict:
        s = self.sched.summary()
        al = self.kv.allocator
        s.update({
            "prefill_calls": self.prefill_calls,
            "mean_prefill_s": (self.prefill_seconds / self.prefill_calls
                               if self.prefill_calls else None),
            "chunk_prefill_steps": self.chunk_prefill_steps,
            "chunked_requests": self.chunked_requests,
            "decode_steps": self.decode_steps,
            "mean_decode_step_s": (self.decode_seconds / self.decode_steps
                                   if self.decode_steps else None),
            "mean_verify_step_s": (self.verify_seconds
                                   / self.sched.verify_steps
                                   if self.sched.verify_steps else None),
            "preemptions": self.preemptions,
            "swap_ins": self.swap_ins,
            "prefix_hits": self.prefix_hits,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "pages_shared": self.pages_shared,
            "cow_copies": getattr(self.kv, "cow_copies", 0),
            "page_evictions": al.evictions,
            "peak_pool_pages": al.peak_used,
        })
        if self.qh is not None:
            s["quant_health"] = {
                "refresh_recommended": self.qh.refresh_recommended,
                "sites": self.qh.report(),
            }
        self._publish_metrics(s, al)
        return s

    def _publish_metrics(self, s: dict, al) -> None:
        """Mirror the engine's and the allocator's numbers into the
        process-wide metrics registry (``obs.metrics``; the reference's
        names): ``set_total`` adopts the running counters without
        counting twice, so ``stats()`` may be called any number of
        times."""
        reg = get_registry()
        for name in ("prefill_calls", "chunk_prefill_steps",
                     "chunked_requests", "preemptions", "swap_ins",
                     "prefix_hits", "prefill_tokens_skipped",
                     "pages_shared", "cow_copies", "page_evictions"):
            reg.counter(f"engine_{name}_total").set_total(float(s[name]))
        reg.gauge("pages_total").set(float(al.num_pages))
        reg.gauge("pages_in_use").set(float(al.num_pages - al.free_pages))
        reg.gauge("pages_cached").set(float(al.cached_pages))
        reg.gauge("pages_peak_used").set(float(al.peak_used))
        reg.gauge("engine_resident_rows").set(float(len(self.kv.rows)))

    def prune_finished(self) -> int:
        """Drop finished requests from the engine's history (a
        long-lived engine keeps every request for ``stats()``); returns
        how many were dropped, whose numbers leave ``stats()`` with
        them."""
        done = [rid for rid, r in self.requests.items() if r.done]
        for rid in done:
            del self.requests[rid]
        self.sched.all = [r for r in self.sched.all if not r.done]
        return len(done)
