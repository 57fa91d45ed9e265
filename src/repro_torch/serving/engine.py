"""Continuous-batching serving engine over the paged KV cache
(counterpart of ``repro.serving.engine``).

Scheduler v2 (the default; chunked prefill): one engine ``step()`` is

  1. retire finished requests (release their pages, shrink them out of
     the decode batch);
  2. up to ``Scheduler.chunk_budget()`` chunked-prefill steps: the
     staging request's next ``chunk_tokens`` prompt tokens run as one
     (1, chunk) decode-mode step, written at the request's own depth
     (into its own pages, or into a detached one-row cache under
     identity placement); the final chunk's last real logit is the
     first output token, and the request joins the decode batch;
  3. one batched (B, 1) decode over the resident rows, every row at its
     own depth; or, with speculative decode (``spec_decode=True`` or
     ``REPRO_SPEC_DECODE=1``), one (B, k) verify step: up to k - 1
     draft tokens per row from the draft source (``NgramDraft`` unless
     another is given), all k positions through one forward over the
     cache, and per row the longest draft prefix that matches the
     model's own argmax committed, plus the model's next token.  Greedy
     output is token for token that of plain decode.

The v1 path (``REPRO_CHUNKED_PREFILL=0``, and what an arch chunks
cannot serve takes without being asked: a windowed ring) prefills each
admitted prompt whole, right-padded to a 16-token bucket, in one (1, S)
step, and admits on worst-case reservations.  Placement: floating pages
by default, identity rows (``REPRO_PAGED_PLACEMENT=identity``, and a
windowed ring, whose cache is C = window < max_len slots).

Weights are pre-quantized to fp8 at build and the activation scales are
calibrated at build (one forward over a fixed prompt), as in the
reference; ``REPRO_SERVE_PREQUANT=0`` quantizes the weights in every
step against their build-time scales instead, and
``REPRO_SERVE_DELAYED_ACT=0`` measures every activation in the step
(``prepare_weights``, ``calibrate_serving``).  Dense and MoE models
serve alike: a MoE block's decode, verify and chunk steps take the
masked dense-experts combine, every expert on every token, each through
its own weight and activation scales.  With chunked prefill on floating
pages admission is usage-based (a request reserves its prompt plus one
page); when growth finds the pool dry the reference preempts to host,
which the port does not have yet: size the pool fully backed (the
default) and it never happens.  Not yet ported, each raising
``NotImplementedError`` when reached: preemption swap-to-host and
prefix-cache hits with copy-on-write (ROADMAP queue 1 item 8),
quant-health telemetry (queue 1 item 12).  Speculative decode needs the
chunked path, an unwrapped cache (``spec_verify_supported``) and delayed
activation scales (or bf16); elsewhere (a windowed ring, the v1
prefill, ``REPRO_SERVE_DELAYED_ACT=0``) the flag is inert, as in the
reference.

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
    check_serving_env,
    chunked_prefill,
    paged_placement,
    serve_delayed_act,
    serve_prequant,
    spec_decode as spec_decode_flag,
)
from repro_torch.models.transformer import (
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

from .paged_cache import (
    PAGE_SIZE,
    FloatingPageCache,
    PagedKVCache,
    PageExhausted,
    SlotCapacityExceeded,
)
from .scheduler import Request, Scheduler, SLOTargets
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
class _Staging:
    """The one request currently chunk-prefilling: its pages are
    admitted but it has no decode-batch row until the last chunk."""
    req: Request
    pos: int                  # next prompt position to chunk-prefill
    row_cache: dict | None    # detached one-row caches (identity only)


class Engine:
    """Paged-KV continuous-batching engine (see module docstring)."""

    def __init__(self, cfg, params, num_slots: int, max_len: int, *,
                 page_size: int = PAGE_SIZE,
                 num_pages: int | None = None,
                 chunk_tokens: int = CHUNK_TOKENS,
                 eos_id: int | None = None,
                 prefix_cache: bool = False,
                 slo: SLOTargets | None = None,
                 spec_decode: bool | None = None,
                 draft: DraftSource | None = None,
                 spec_k: int = 4,
                 device="cuda"):
        check_serving_env()
        self.device = resolve_device(device)
        if cfg.input_mode != "tokens":
            raise ValueError(f"serving engine drives token models; "
                             f"{cfg.name} has input_mode="
                             f"{cfg.input_mode!r}")
        if prefix_cache:
            raise NotImplementedError(
                "prefix-cache hits with copy-on-write: ROADMAP queue 1 "
                "item 8")
        self.cfg = cfg
        self.max_len = max_len
        self.num_slots = num_slots
        self.eos_id = eos_id
        with torch.inference_mode():
            params = to_device(params, self.device)
            self.params, self.scales = prepare_weights(cfg, params)
            self.act_scales = calibrate_serving(cfg, self.params,
                                                self.scales)
        self.prefill = make_prefill_step(cfg, max_len, scales=self.scales,
                                         act_scales=self.act_scales)
        self.decode = make_decode_step(cfg, scales=self.scales,
                                       act_scales=self.act_scales)
        self.float_pages = (paged_placement() == "float"
                            and paged_decode_supported(cfg, max_len,
                                                       page_size))
        self.chunked = (chunked_prefill()
                        and chunk_prefill_supported(cfg, max_len))
        # usage-based admission needs preemption, which lives on the
        # floating pool's block tables (REPRO_PREEMPTION=0 is refused);
        # identity placement and the v1 prefill admit on reservations
        self.preemption = self.chunked and self.float_pages
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
        self.verify = (make_verify_step(cfg, scales=self.scales,
                                        act_scales=self.act_scales)
                       if self.spec else None)
        self._staging: _Staging | None = None
        self.prefill_calls = 0
        self.prefill_seconds = 0.0
        self.chunk_prefill_steps = 0
        self.chunked_requests = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.verify_seconds = 0.0
        self.sched = Scheduler(slo=slo)
        self.requests: dict[int, Request] = {}

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

    # -- the engine step -----------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        if not self.chunked:
            self._retire_and_refill()
            self._admit_new_rows()
            self._decode_once()
            return
        self._retire()
        self._chunk_phase()
        self._retire()          # an attached request may finish at once
        if self.spec:
            self._verify_once()
        else:
            self._decode_once()

    def _retire(self):
        row = 0
        while row < len(self.kv.rows):
            if self.requests[self.kv.rows[row]].done:
                self.kv.release(row)
                self.kv.shrink(row)   # swapped-in last row re-checked
            else:
                row += 1

    # -- preemption (swap-to-host raises until it is ported) -----------
    def _preempt_one(self) -> bool:
        cands = [self.requests[rid] for rid in self.kv.rows
                 if rid is not None]
        victim = self.sched.pick_victim(cands)
        if victim is None:
            return False
        self.kv.swap_out(self.kv.rows.index(victim.rid))
        return True

    def _grow_or_preempt(self, grow) -> None:
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
        the actual free-page accounting."""
        head = self.sched.peek()
        if head is None or len(self.kv.rows) >= self.num_slots:
            return False
        admit = self._admit_tokens(head)
        if not self.kv.can_admit(admit):
            return False          # stays queued (backpressure)
        req = self.sched.pop()
        self.kv.stage_admit(req.rid, admit)
        row_cache = None if self.float_pages else init_caches(
            self.cfg, 1, self.max_len, per_slot=True, device=self.device)
        self._staging = _Staging(req=req, pos=0, row_cache=row_cache)
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
            logits, self.kv.caches = self.decode(self.params,
                                                 self.kv.caches, toks)
        else:
            # identity placement: the chunk runs on a detached one-row
            # cache; only the depth stamp moves between chunks
            for c in st.row_cache.values():
                c.idx.fill_(st.pos)
            logits, _ = self.decode(self.params, st.row_cache, toks)
        self.chunk_prefill_steps += 1
        st.pos += n_real
        if st.pos < plen:
            return
        first = int(torch.argmax(logits[0, n_real - 1]))
        if self.float_pages:
            self.kv.stage_attach(req.rid, plen)
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
        return min(c, -(-n // PROMPT_BUCKET) * PROMPT_BUCKET)

    def _prefill_request(self, req: Request) -> dict:
        """The (1, bucket) prefill of one prompt; returns the one-row
        caches and emits the request's first token (TTFT)."""
        n = req.prompt_len
        toks = np.zeros((1, self._bucket_len(n)), np.int32)
        toks[0, :n] = req.prompt
        t0 = time.perf_counter()
        logits, one = self.prefill(self.params,
                                   torch.from_numpy(toks).to(self.device),
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
        logits, self.kv.caches = self.decode(
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
        logits, self.kv.caches = self.verify(
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
                    or self._staging is not None)

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
            "page_evictions": al.evictions,
            "peak_pool_pages": al.peak_used,
        })
        return s
