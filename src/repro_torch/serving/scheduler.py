"""Request admission + slot lifecycle for the paged serving engine
(a copy of ``repro.serving.scheduler``, less what the port does not run
yet: the metrics-registry mirror of ``repro.obs`` waits for
observability, ROADMAP queue 1 item 12; the prefix-cache hit counts for
prefix-hit copy-on-write, item 8).

Host-side and model-free by design: the scheduler owns the FIFO
queue, request state transitions (QUEUED -> RUNNING [-> PREEMPTED ->
RUNNING] -> FINISHED), stop conditions (EOS token / ``max_new``
budget), per-request latency metrics (TTFT = submit -> first token,
TPOT = mean inter-token gap after the first) and the SLO policy knobs
built on them: the per-step chunked-prefill budget and preemption
victim choice are decided here, against ``SLOTargets``, from the
latencies the scheduler already measures.  The engine asks *whether*
the head of the queue fits (``PageAllocator.can_admit`` —
page-exhaustion backpressure keeps it queued, head-of-line FIFO: a
large stuck request is not overtaken), *how many* prompt chunks to
interleave this step (``chunk_budget``) and *whom* to swap out when
the pool runs dry (``pick_victim``), and tells the scheduler *what
happened* (``on_token``, ``on_verify``); with speculative decode it
also sets the draft length of the next verify step from an accept-rate
EMA (``draft_len``).  Everything tensor-shaped lives in
``engine``/``paged_cache``.  That split keeps refill order, retirement,
backpressure and the SLO policies unit-testable without building a
model.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request.  ``out`` accumulates generated token
    ids (the first is produced by prefill); timestamps feed the
    TTFT/TPOT metrics.  ``arrival_time`` (seconds after the trace
    epoch) makes ``Engine.run`` model an open-loop arrival process:
    the request is submitted — and its TTFT clock started — only once
    that offset has elapsed, instead of submit-all-at-once."""

    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    eos_id: int | None = None
    arrival_time: float | None = None
    out: list = dataclasses.field(default_factory=list)
    state: RequestState = RequestState.QUEUED
    t_submit: float | None = None
    t_first: float | None = None
    t_last: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def ttft(self) -> float | None:
        """Time to first token (s): submit -> first generated token."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> float | None:
        """Mean time per output token (s) after the first."""
        if self.t_first is None or self.t_last is None or len(self.out) < 2:
            return None
        return (self.t_last - self.t_first) / (len(self.out) - 1)


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Latency service-level objectives the v2 policies steer against
    (docs/continuous-batching.md).  Defaults are loose smoke-scale
    values; benchmarks/launchers set real ones."""

    ttft_s: float = 1.0          # target time-to-first-token
    tpot_s: float = 0.1          # target per-output-token gap


def hit_stop(req: Request, token: int) -> bool:
    """THE stop rule (one source of truth — the paged scheduler and
    the legacy Server both consult it): EOS token, or the ``max_new``
    budget spent by the token just appended to ``req.out``."""
    return ((req.eos_id is not None and int(token) == req.eos_id)
            or len(req.out) >= req.max_new)


class Scheduler:
    """FIFO admission + retirement bookkeeping + SLO policy (see
    module docstring).  ``clock`` is injectable for deterministic unit
    tests."""

    def __init__(self, clock=time.monotonic, slo: SLOTargets | None = None):
        self.clock = clock
        self.slo = slo or SLOTargets()
        self.queue: deque[Request] = deque()
        self.all: list[Request] = []
        # speculative-decode accept-rate EMA: starts optimistic, so the
        # first verify steps try the full draft length, then follows the
        # trace
        self.accept_rate: float = 1.0
        self.verify_steps: int = 0
        self.drafted: int = 0
        self.accepted: int = 0

    def submit(self, requests) -> None:
        now = self.clock()
        for req in requests:
            assert req.max_new >= 1, "a request must generate >= 1 token"
            req.state = RequestState.QUEUED
            req.t_submit = now
            self.queue.append(req)
            self.all.append(req)

    def peek(self) -> Request | None:
        """Head of the FIFO queue (next admission candidate), or None."""
        return self.queue[0] if self.queue else None

    def pop(self) -> Request:
        """Commit the head to a slot (engine prefills it next)."""
        req = self.queue.popleft()
        req.state = RequestState.RUNNING
        return req

    def on_token(self, req: Request, token: int) -> bool:
        """Record one generated token; flips the request to FINISHED on
        EOS or when the ``max_new`` budget is spent.  Returns done."""
        now = self.clock()
        req.out.append(int(token))
        if req.t_first is None:
            req.t_first = now
        req.t_last = now
        if hit_stop(req, token):
            req.state = RequestState.FINISHED
        return req.done

    def on_verify(self, proposed: int, accepted: int) -> None:
        """Record one speculative verify step: ``proposed`` draft tokens
        were put to the model across the batch and ``accepted`` of them
        matched its own argmax.  Updates the accept-rate EMA (0.8 · prev
        + 0.2 · this step: slow enough to ride out one bad window, fast
        enough to follow a change in the trace)."""
        self.verify_steps += 1
        self.drafted += int(proposed)
        self.accepted += int(accepted)
        if proposed > 0:
            self.accept_rate = (0.8 * self.accept_rate
                                + 0.2 * accepted / proposed)

    def draft_len(self, k_max: int) -> int:
        """The next verify step's length: ``k_max`` scaled by the
        accept-rate EMA, at least 2 (a step of 1 proposes nothing, and
        the EMA could then never recover).  The engine may still cut it
        to 1 for a budget or capacity, which bypasses this policy."""
        if k_max <= 2:
            return max(1, k_max)
        return max(2, min(k_max, round(k_max * self.accept_rate)))

    # -- SLO policy ----------------------------------------------------
    def chunk_budget(self) -> int:
        """How many chunked-prefill steps the engine may interleave
        before the next decode step.  Deterministic and model-free:
        shrink to 1 when any running request's observed TPOT already
        exceeds its target (prefill chunks stall decode); boost when
        the queue head's wait approaches the TTFT target (its first
        token needs the whole prompt prefilled).  TTFT pressure wins
        ties — under heavy traffic the queue is where SLOs die."""
        budget = 2
        running = [r for r in self.all
                   if r.state is RequestState.RUNNING]
        tpots = [r.tpot for r in running if r.tpot is not None]
        if tpots and max(tpots) > self.slo.tpot_s:
            budget = 1
        head = self.queue[0] if self.queue else None
        if head is not None and head.t_submit is not None:
            if self.clock() - head.t_submit > 0.5 * self.slo.ttft_s:
                budget = max(budget, 4)
        return budget

    def pick_victim(self, candidates) -> Request | None:
        """Preemption victim among decode-resident requests: the one
        with the most TPOT headroom (its SLO tolerates a swap stall
        best); ties break LIFO (latest submit — the least sunk decode
        work is parked).  Deterministic given the candidates."""
        if not candidates:
            return None

        def key(r: Request):
            tpot = r.tpot
            headroom = (self.slo.tpot_s - tpot if tpot is not None
                        else self.slo.tpot_s)
            return (headroom, r.t_submit or 0.0)

        return max(candidates, key=key)

    # -- metrics -------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate serving metrics over every finished request.
        p50/p99 percentiles ride alongside the means — heavy-traffic
        scheduling is judged on tails, not averages.

        Undefined aggregates (no finished requests, no drafted tokens)
        are ``None``, never NaN: the dict must stay valid JSON."""
        done = [r for r in self.all if r.done]
        toks = sum(len(r.out) for r in done)
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None]
        span = (max((r.t_last for r in done), default=0.0)
                - min((r.t_submit for r in done), default=0.0))

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else None

        s = {
            "requests": len(done),
            "tokens": toks,
            "tok_per_s": toks / span if span > 0 else None,
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "mean_tpot_s": float(np.mean(tpots)) if tpots else None,
            "p50_ttft_s": pct(ttfts, 50),
            "p99_ttft_s": pct(ttfts, 99),
            "p50_tpot_s": pct(tpots, 50),
            "p99_tpot_s": pct(tpots, 99),
            "spec_verify_steps": self.verify_steps,
            "spec_drafted": self.drafted,
            "spec_accepted": self.accepted,
            "spec_accept_rate": (self.accepted / self.drafted
                                 if self.drafted else None),
        }
        return s
