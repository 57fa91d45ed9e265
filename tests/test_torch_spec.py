"""Speculative verify in the port, against the reference, on the CPU.

Layers, innermost out (the reference's own contract is
tests/test_spec_decode.py):

- kernel: the verify (q_len > 1) form of decode attention.  The port's
  5-D plain versions, contiguous and paged, fp8 and bf16, against the
  reference's ``backend="ref"`` dispatch and its Pallas kernels in
  interpret mode, at the reference test's fixture (b 2, kvh 2, g 4, c 48,
  dh 32, S 3).  Tolerances as the 4-D comparisons of
  tests/test_torch_ring.py (contiguous: bitwise, one einsum order) and
  tests/test_torch_kernels.py (paged: 1e-5 absolute).  Each draft row is
  bitwise the 4-D plain call at that draft's own limit;
- step: ``make_verify_step``'s k logit rows are bitwise the k
  sequential ``make_decode_step`` calls, on the smoke phi3 with
  prequantized weights and calibrated scales, at B = 2;
- engine: greedy speculative streams equal the port's plain streams for
  every draft source, k, cache dtype and placement, through an EOS
  inside a draft window and mixed-depth batches (the streams against the
  reference's speculative engine: tests/test_torch_serving.py's
  reference child);
- units: the spec gate, the accept-rate EMA, the draft sources.

(The verify-form kernel against its plain version, on a card:
tests/test_torch_cuda.py.)
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.decode_attn import (decode_attn_paged_pallas,
                                       decode_attn_pallas)

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import row_order
from repro_torch.core.actscale import calibrate_act_scales
from repro_torch.core.formats import BF16_CONFIG
from repro_torch.kernels import decode_attn, dispatch
from repro_torch.launch.serve import Server, random_params
from repro_torch.models.attention import _quant_kv
from repro_torch.models.transformer import spec_verify_supported
from repro_torch.serving import (
    DraftSource,
    Engine,
    ModelDraft,
    NgramDraft,
    Request,
    Scheduler,
)
from repro_torch.serving.engine import CHUNK_TOKENS
from repro_torch.train import steps as tsteps
from repro_torch.train.steps import (
    make_decode_step,
    make_prefill_step,
    make_verify_step,
    prequantize_params,
)

_ML = {torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
       torch.bfloat16: ml_dtypes.bfloat16}


def _jax(t):
    """A torch tensor (or None) as a JAX array with the same bits."""
    if t is None:
        return None
    if t.dtype in _ML:
        return jnp.asarray(bridge.bits(t).view(_ML[t.dtype]))
    return jnp.asarray(t.numpy())


# --- kernel: the verify form of decode attention --------------------------

S = 3


def _fixture(kv_dtype, b=2, kvh=2, g=4, c=48, dh=32, seed=0):
    """The reference test's fixture: bf16 queries of S drafts, a cache
    of c slots, post-write depths 17 and 41."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((b, kvh, S, g, dh)),
                     dtype=torch.float32).bfloat16().float()
    kf = torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                      dtype=torch.float32)
    vf = torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                      dtype=torch.float32)
    if kv_dtype == "fp8":
        (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
    else:
        k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
    return q, k, v, ks, vs, torch.tensor([17, 41], dtype=torch.int32)


def _pages(x, t):
    """(B, KV, C, ...) -> a (B·C/t, KV, t, ...) pool, slot b's pages in
    order."""
    if x is None:
        return None
    b, kvh, c = x.shape[:3]
    raw = x.view(torch.uint8) if x.element_size() == 1 else x
    p = raw.reshape(b, kvh, c // t, t, *x.shape[3:]).movedim(2, 1)
    p = p.reshape(b * (c // t), kvh, t, *x.shape[3:]).contiguous()
    return p.view(x.dtype) if x.element_size() == 1 else p


def _same_bits(got: torch.Tensor, want) -> None:
    g = bridge.bits(got)
    np.testing.assert_array_equal(g, np.asarray(want).view(g.dtype))


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_verify_attention_plain_matches_reference(kv_dtype):
    """Contiguous: the 5-D dispatch bitwise equals the reference's ref
    dispatch and ``decode_attn_pallas(q_len=S, interpret=True)`` (one C
    block, the reference's einsum order); each draft row bitwise the 4-D
    plain call at n_valid - (S-1-j)."""
    q, k, v, ks, vs, nv = _fixture(kv_dtype)
    out = dispatch.decode_attention(q, k, v, ks, vs, nv)
    assert out.shape == q.shape
    jq, jk, jv, jks, jvs = map(_jax, (q, k, v, ks, vs))
    jnv = jnp.asarray(nv.numpy())
    _same_bits(out, jdispatch.decode_attention(jq, jk, jv, jks, jvs, jnv,
                                               backend="ref"))
    b, kvh, _, g, dh = q.shape
    qp = jnp.pad(jq, ((0, 0), (0, 0), (0, 0), (0, 8 - g), (0, 0)))
    pallas = decode_attn_pallas(
        qp.reshape(b, kvh, S * 8, dh), jk, jv, jks, jvs, jnv,
        sm_scale=dh ** -0.5, interpret=True, q_len=S)
    _same_bits(out, pallas.reshape(b, kvh, S, 8, dh)[:, :, :, :g])
    for j in range(S):
        solo = dispatch.decode_attention(q[:, :, j], k, v, ks, vs,
                                         nv - (S - 1 - j))
        assert torch.equal(out[:, :, j], solo), (kv_dtype, j)


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_verify_attention_paged_plain_matches_reference(kv_dtype):
    """Paged (pages of 16 in a permuted pool): within 1e-5 of the
    reference's paged ref and ``decode_attn_paged_pallas(q_len=S,
    interpret=True)``; each draft row bitwise the 4-D paged plain call
    at its limit, and the pages give the contiguous route's bits."""
    q, k, v, ks, vs, nv = _fixture(kv_dtype, c=64, seed=5)
    t = 16
    b, kvh, _, g, dh = q.shape
    perm = torch.tensor(np.random.default_rng(9).permutation(
        b * 64 // t), dtype=torch.int64)
    inv = torch.argsort(perm)
    pool = [None if x is None else
            (_pages(x, t).view(torch.uint8)[perm].view(x.dtype)
             if x.element_size() == 1 else _pages(x, t)[perm])
            for x in (k, v, ks, vs)]
    bt = inv.reshape(b, 64 // t).to(torch.int32)
    out = dispatch.decode_attention_paged(q, *pool, nv, bt)
    assert torch.equal(out, dispatch.decode_attention(q, k, v, ks, vs,
                                                      nv))
    jq = _jax(q)
    jp = list(map(_jax, pool))
    jnv, jbt = jnp.asarray(nv.numpy()), jnp.asarray(bt.numpy())
    ref = jdispatch.decode_attention_paged(jq, *jp, jnv, jbt, backend="ref")
    qp = jnp.pad(jq, ((0, 0), (0, 0), (0, 0), (0, 8 - g), (0, 0)))
    pallas = decode_attn_paged_pallas(
        qp.reshape(b, kvh, S * 8, dh), *jp, jnv, jbt, sm_scale=dh ** -0.5,
        interpret=True, q_len=S).reshape(b, kvh, S, 8, dh)[:, :, :, :g]
    for want in (ref, pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    for j in range(S):
        solo = dispatch.decode_attention_paged(q[:, :, j], *pool,
                                               nv - (S - 1 - j), bt)
        assert torch.equal(out[:, :, j], solo), (kv_dtype, j)


def test_verify_attention_refuses_a_wrapped_or_short_depth():
    """q_len > 1 needs every n_valid in [q_len, C]: an unwrapped cache
    holding the drafts' own writes."""
    q, k, v, ks, vs, _ = _fixture("fp8")
    b, kvh, _, g, dh = q.shape
    rows = q.reshape(b, kvh, S * g, dh)
    for bad in ([2, 41], [17, 49]):
        with pytest.raises(ValueError, match="unwrapped"):
            decode_attn.decode_attn(rows, k, v, ks, vs,
                                    torch.tensor(bad, dtype=torch.int32),
                                    sm_scale=0.1, q_len=S)
    with pytest.raises(ValueError, match="q_len"):
        decode_attn.decode_attn(rows, k, v, ks, vs,
                                torch.tensor([17, 41], dtype=torch.int32),
                                sm_scale=0.1, q_len=5)


# --- step: one (B, k) verify == k sequential decode steps ------------------

ARCH = "phi3-mini-3.8b"


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_verify_step_bitwise_vs_sequential_decode(kv_dtype):
    """The reference's contract: prequantized weights and calibrated
    (delayed) activation scales make the verify step a re-bracketing of
    the sequential steps, so its k logit rows are bitwise theirs."""
    cfg = get_config(ARCH, smoke=True).replace(kv_cache_dtype=kv_dtype)
    with torch.inference_mode():
        pq = prequantize_params(cfg, random_params(cfg, 0, "cpu"))
        act = calibrate_act_scales(cfg, pq.qweights, pq.scales)
    pre = make_prefill_step(cfg, 16, scales=pq.scales, act_scales=act)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)), dtype=torch.int32)
    dec = make_decode_step(cfg, scales=pq.scales, act_scales=act)
    _, caches = pre(pq.qweights, toks)
    cur, seq = toks[:, :1], []
    for _ in range(4):
        lo, caches = dec(pq.qweights, caches, cur)
        seq.append(lo[:, 0])
        cur = lo[:, -1].argmax(-1)[:, None].to(torch.int32)
    _, caches = pre(pq.qweights, toks)            # a fresh prefill
    feed = torch.cat([toks[:, :1]] + [s.argmax(-1)[:, None].to(torch.int32)
                                      for s in seq[:3]], dim=1)
    ver = make_verify_step(cfg, scales=pq.scales, act_scales=act)
    vlo, caches = ver(pq.qweights, caches, feed)
    assert vlo.shape == (2, 4, cfg.vocab)
    assert int(next(iter(caches.values())).idx) == 16
    for j in range(4):
        assert torch.equal(vlo[:, j], seq[j]), (kv_dtype, j)


# --- engine: speculative streams == plain streams --------------------------

MAX_LEN = 64
MIXED_LENS = [5, 9, 17]          # straddle chunk and page boundaries


def _cfg(kv_dtype="fp8", quant=BF16_CONFIG):
    cfg = get_config(ARCH, smoke=True).replace(kv_cache_dtype=kv_dtype)
    return cfg if quant is None else cfg.replace(quant=quant)


def _requests(cfg, lens, max_new=10, eos=None):
    rng = np.random.default_rng(0)
    reqs = []
    for i, spec in enumerate(lens):
        n, mn = spec if isinstance(spec, tuple) else (spec, max_new)
        reqs.append(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=n, dtype=np.int32), max_new=mn, eos_id=eos))
    return reqs


def _serve(cfg, lens, *, spec, max_new=10, eos=None, **kw):
    eng = Engine(cfg, random_params(cfg, 0, "cpu"), num_slots=3,
                 max_len=MAX_LEN, spec_decode=spec, device="cpu", **kw)
    reqs = _requests(cfg, lens, max_new=max_new, eos=eos)
    eng.run(reqs, log=None)
    assert eng.spec == bool(spec)
    return {r.rid: list(r.out) for r in reqs}, eng


class Oracle:
    """Proposes the continuation recorded from a plain run: every draft
    is accepted."""

    def __init__(self, truth):
        self.truth = truth

    def propose(self, req, k):
        t = self.truth[req.rid]
        return t[len(req.out):len(req.out) + k]


class Adversarial:
    """Always-wrong proposals: every draft is rejected, and each verify
    step commits the model's own token."""

    def __init__(self, truth):
        self.truth = truth

    def propose(self, req, k):
        t = self.truth[req.rid]
        nxt = t[len(req.out):len(req.out) + k]
        return [(x + 1) % 500 for x in nxt] or [0]


class HalfOracle:
    """Right for the first ``good`` drafts of every window, wrong after:
    a rejection inside every verify step."""

    def __init__(self, truth, good=1):
        self.truth = truth
        self.good = good

    def propose(self, req, k):
        t = self.truth[req.rid]
        nxt = list(t[len(req.out):len(req.out) + k])
        for j in range(self.good, len(nxt)):
            nxt[j] = (nxt[j] + 1) % 500
        return nxt


_TRUTHS = {}


def _truth(cfg, lens, max_new=10, eos=None):
    """The plain streams of ``lens`` (served once per config, requests
    and placement in this process: the engine is deterministic)."""
    key = (cfg, repr(lens), max_new, eos,
           os.environ.get("REPRO_PAGED_PLACEMENT"))
    if key not in _TRUTHS:
        out, eng = _serve(cfg, lens, spec=False, max_new=max_new, eos=eos)
        assert eng.sched.verify_steps == 0
        _TRUTHS[key] = out
    return {rid: list(t) for rid, t in _TRUTHS[key].items()}


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_streams_equal_plain_for_every_draft_source(kv_dtype, k):
    """Oracle, adversarial, half-right and n-gram drafts all give the
    plain stream token for token; k = 1 falls back to plain decode."""
    cfg = _cfg(kv_dtype)
    truth = _truth(cfg, MIXED_LENS)
    for draft in (Oracle(truth), Adversarial(truth), HalfOracle(truth),
                  NgramDraft()):
        got, eng = _serve(cfg, MIXED_LENS, spec=True, draft=draft,
                          spec_k=k)
        assert got == truth, (kv_dtype, k, type(draft).__name__)
        st = eng.stats()
        if k == 1:
            assert st["spec_verify_steps"] == 0
        elif isinstance(draft, Oracle):
            assert st["spec_verify_steps"] > 0
            assert st["spec_accept_rate"] == pytest.approx(1.0)
            assert st["decode_steps"] + st["spec_verify_steps"] < \
                sum(len(t) for t in truth.values())
        elif isinstance(draft, Adversarial):
            assert st["spec_accepted"] == 0


@pytest.mark.parametrize("placement", ["float", "identity"])
def test_spec_streams_equal_plain_under_both_placements(placement,
                                                        monkeypatch):
    """moss with its calibrated scales (the serving default): rejections
    truncate the host depths (floating pages) or restamp the rows'
    device idx (identity rows)."""
    monkeypatch.setenv("REPRO_PAGED_PLACEMENT", placement)
    cfg = _cfg("fp8", quant=None)
    truth = _truth(cfg, MIXED_LENS)
    for draft in (Oracle(truth), HalfOracle(truth)):
        got, eng = _serve(cfg, MIXED_LENS, spec=True, draft=draft,
                          spec_k=4)
        assert eng.float_pages == (placement == "float")
        assert got == truth, (placement, type(draft).__name__)
        assert eng.stats()["spec_verify_steps"] > 0
        assert not eng.kv.rows
        assert eng.kv.allocator.free_pages == eng.kv.allocator.num_pages


def test_eos_inside_draft_window():
    """An EOS accepted as a draft mid-window stops the request at the
    plain stream's length: later drafts of the window do not commit."""
    cfg = _cfg("fp8")
    free = _truth(cfg, [5], max_new=10)
    eos = free[0][4]
    truth = _truth(cfg, [5], max_new=10, eos=eos)
    assert len(truth[0]) == 5
    got, eng = _serve(cfg, [5], spec=True, max_new=10, eos=eos,
                      draft=Oracle(free), spec_k=4)
    assert got == truth
    assert eng.stats()["spec_verify_steps"] > 0


def test_mixed_depth_batches_and_budgets():
    """Rows at different depths and budgets share one verify step; k is
    cut to the tightest budget, so no row overruns its max_new."""
    cfg = _cfg("fp8")
    lens = [(5, 3), (9, 10), (17, 7)]
    truth = _truth(cfg, lens)
    got, _ = _serve(cfg, lens, spec=True, draft=Oracle(truth), spec_k=4)
    assert got == truth
    for rid, (_, mn) in enumerate(lens):
        assert len(got[rid]) == mn


# --- units: the gate, the accept-rate EMA, the draft sources ---------------


def test_spec_gate_requires_chunked_v2(monkeypatch):
    """The verify step rides on the chunked path: with the whole-prompt
    prefill the flag is inert, and ``REPRO_SPEC_DECODE`` stands in for
    the constructor's argument.  A windowed ring has no verify."""
    cfg = _cfg("fp8")
    assert spec_verify_supported(cfg, MAX_LEN)
    h2o = get_config("h2o-danube-3-4b", smoke=True).replace(window=16)
    assert not spec_verify_supported(h2o, MAX_LEN)
    params = random_params(cfg, 0, "cpu")
    build = lambda **kw: Engine(cfg, params, num_slots=2, max_len=MAX_LEN,
                                device="cpu", **kw)
    monkeypatch.setenv("REPRO_CHUNKED_PREFILL", "0")
    assert not build(spec_decode=True).spec
    monkeypatch.delenv("REPRO_CHUNKED_PREFILL")
    monkeypatch.setenv("REPRO_SPEC_DECODE", "1")
    assert build().spec
    assert not build(spec_decode=False).spec
    monkeypatch.setenv("REPRO_SPEC_DECODE", "0")
    assert not build().spec
    mcfg = _cfg("fp8", quant=None)             # moss: calibrated scales
    eng = Engine(mcfg, random_params(mcfg, 0, "cpu"), num_slots=2,
                 max_len=MAX_LEN, spec_decode=True, device="cpu")
    assert eng.spec and eng.act_scales is not None


@pytest.mark.parametrize("server", ["engine", "spec", "legacy"])
def test_serving_steps_run_under_their_most_rows(monkeypatch, server):
    """Every decode, chunk and verify step of the engine runs under
    ``row_order.rows(step_rows)``: ``num_slots`` rows, times ``spec_k``
    with speculative verify (``draft_len`` never exceeds ``spec_k``
    positions a slot), and no step is wider than that but the prefill
    chunks; the legacy Server's decode steps under its B rows, so that
    its streams are the engine's on the card.  Calibration and the
    whole-prompt prefill run outside it."""
    seen = []
    forward = tsteps.forward

    def record(*args, **kw):
        seen.append((kw.get("mode"), args[3].numel(),
                     row_order._ROWS.get()))
        return forward(*args, **kw)

    monkeypatch.setattr(tsteps, "forward", record)
    cfg = _cfg("fp8")
    if server == "legacy":
        srv = Server(cfg, random_params(cfg, 0, "cpu"), batch_slots=3,
                     max_len=MAX_LEN, device="cpu")
        srv.run(_requests(cfg, MIXED_LENS), log=None)
        limit, modes = 3, {"decode"}
    else:
        spec = server == "spec"
        _, eng = _serve(cfg, MIXED_LENS, spec=spec, spec_k=4)
        assert eng.step_rows == 3 * (4 if spec else 1)
        limit = eng.step_rows
        modes = {"decode", "verify"} if spec else {"decode"}
    assert {m for m, _, _ in seen if m in ("decode", "verify")} == modes
    for mode, n, got in seen:
        if mode not in ("decode", "verify"):
            assert got == 0, (mode, n, got)
            continue
        assert got == limit, (mode, n, got)
        assert n <= limit or (mode, n) == ("decode", CHUNK_TOKENS)
    assert row_order._ROWS.get() == 0


def test_row_order_off_the_card_is_plain_torch():
    """On the CPU the helpers are the plain torch calls inside a serving
    step's limit too (bitwise), so no CPU result moves; the fixed order
    itself (``sum_last``) is the row's sum to f32 rounding, and a row's
    sum is the same alone and among others."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((5, 96)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((96, 7)), dtype=torch.float32)
    ys = torch.tensor(rng.standard_normal((4, 5, 8)), dtype=torch.float32)
    c = torch.tensor(rng.random((5, 4)), dtype=torch.float32)
    with row_order.rows(64):
        assert torch.equal(row_order.mean(x), x.mean(dim=-1, keepdim=True))
        assert torch.equal(row_order.matmul(x, w), x @ w)
        assert torch.equal(row_order.expert_sum(ys, c),
                           torch.einsum("etd,te->td", ys, c))
    for d in (96, 3072, 6400, 7):
        x = torch.tensor(rng.standard_normal((5, d)), dtype=torch.float32)
        got = row_order.sum_last(x)
        np.testing.assert_allclose(got.numpy(),
                                   x.double().sum(-1).numpy(), rtol=1e-5,
                                   atol=1e-5 * d ** 0.5)
        assert torch.equal(row_order.sum_last(x[2:3]), got[2:3])


def test_accept_rate_ema_steers_draft_len():
    """The EMA starts optimistic, decays toward the observed accept
    rate, and ``draft_len`` scales the maximum by it, floored at 2."""
    s = Scheduler()
    assert s.draft_len(4) == 4
    for _ in range(20):
        s.on_verify(proposed=6, accepted=0)
    assert s.accept_rate < 0.05
    assert s.draft_len(8) == 2
    assert s.draft_len(2) == 2
    assert s.draft_len(1) == 1
    for _ in range(30):
        s.on_verify(proposed=6, accepted=6)
    assert s.accept_rate > 0.95
    assert s.draft_len(8) == 8
    st = s.summary()
    assert st["spec_verify_steps"] == 50
    assert st["spec_drafted"] == 300 and st["spec_accepted"] == 180
    assert st["spec_accept_rate"] == pytest.approx(0.6)
    assert Scheduler().summary()["spec_accept_rate"] is None


def test_ngram_draft_prompt_lookup():
    """The longest n-gram wins, then the most recent earlier
    occurrence; nothing when nothing matches."""
    d = NgramDraft(max_ngram=3)
    req = Request(rid=0, prompt=np.asarray([7, 8, 9, 1, 2, 3, 4, 5],
                                           np.int32), max_new=8)
    req.out = [1, 2, 3]
    assert d.propose(req, 4) == [4, 5, 1, 2]
    req.out = [99]
    assert d.propose(req, 4) == []
    req2 = Request(rid=1, prompt=np.asarray([1, 2, 5, 1, 2, 6, 1, 2],
                                            np.int32), max_new=8)
    assert d.propose(req2, 1) == [6]


def test_model_draft_hook():
    calls = []

    def propose_fn(ctx, k):
        calls.append((tuple(ctx), k))
        return [41, 42, 43][:k]

    d = ModelDraft(propose_fn)
    assert isinstance(d, DraftSource)
    req = Request(rid=0, prompt=np.asarray([1, 2], np.int32), max_new=4)
    req.out = [3]
    assert d.propose(req, 2) == [41, 42]
    assert calls == [((1, 2, 3), 2)]
