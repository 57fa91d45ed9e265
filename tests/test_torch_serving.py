"""The port's serving layer: the host-side allocator and scheduler
(units ported from the reference's own cases) and the paged engine end
to end against the reference's.

End to end, a ``repro_torch`` ``Engine(device="cpu")`` and a ``repro``
``Engine`` serve the same requests on the same weights (the reference's
smoke phi3-mini, carried across by ``repro_torch.bridge``), mixed prompt
lengths, a page-aligned ``max_len``, no prefix cache.  Each builds and
calibrates itself.  The greedy streams must be equal, except where the
reference's top two logits lie within 1e-3 * max|logit| (a tie): there
the comparison of that request stops, as tests/test_chunked_prefill.py
does.

The reference runs in a child process compiled with
``REFERENCE_XLA_FLAGS`` (tests/test_torch_train.py): XLA's excess
precision off and its algebraic simplifier's pass off.  With excess
precision on (XLA's default), the compiled steps may skip bf16
roundings the code asks for, which on this smoke model moves the
reference's logits by up to ~10% of their range against its own
op-by-op evaluation; with the simplifier on, its rewrites of the
quantizers' arithmetic flip fp8 roundings wherever an activation scale
is measured in the step (``REPRO_SERVE_DELAYED_ACT=0`` moved the
reference's chunk logits by ~17% of their range).  Compiled with both
off, the reference's steps give its op-by-op logits and the port's bit
for bit.  The port implements the code as written.  The flags are set
for the child only, where engines of one config and one set of switches
share their compiled steps (``_share_steps``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import Server
from repro_torch.serving import (
    Engine,
    PageAllocator,
    PageExhausted,
    Request,
    Scheduler,
    SLOTargets,
    SlotCapacityExceeded,
    page_keys,
)

from test_torch_spec import Adversarial, HalfOracle, Oracle
from test_torch_train import REFERENCE_XLA_FLAGS

ARCH = "phi3-mini-3.8b"
MOE = "phi3.5-moe-42b-a6.6b"
LENS = [5, 16, 23, 9, 31]          # under, at and across 16-token chunks
MAX_NEW, SLOTS, MAX_LEN, CHUNK, SEED = 8, 3, 48, 16, 0
# the windowed arch at window 16 (a 16-slot ring under max_len 48): 12
# and 14 cross the window mid-decode, 20 is past it from the start
H2O, H2O_WINDOW, H2O_LENS = "h2o-danube-3-4b", 16, [5, 12, 20, 9, 14]
# the other serving paths, each against the reference's (the floating
# page, chunked path is ``test_engine_streams_match_reference``'s run)
RUNS = {
    "identity-chunked": dict(env={"REPRO_PAGED_PLACEMENT": "identity"}),
    "identity-v1": dict(env={"REPRO_PAGED_PLACEMENT": "identity",
                             "REPRO_CHUNKED_PREFILL": "0"}),
    "float-v1": dict(env={"REPRO_CHUNKED_PREFILL": "0"}),
    "server": dict(server=True),
    "h2o-fp8": dict(arch=H2O, window=H2O_WINDOW, kv="fp8", lens=H2O_LENS),
    "h2o-bf16": dict(arch=H2O, window=H2O_WINDOW, kv="bf16",
                     lens=H2O_LENS),
    "bf16-chunked": dict(kv="bf16"),
    # the reference's three serving switches: weights quantized in the
    # step against their build-time scales; just-in-time activation
    # scales (whose amax spans the decode batch, so the chunk budget is
    # pinned: no latency target can move a request between batches);
    # the decode kernels' plain einsum versions
    "prequant-off": dict(env={"REPRO_SERVE_PREQUANT": "0"}),
    "jit-act": dict(env={"REPRO_SERVE_DELAYED_ACT": "0"}, pinned=True),
    "einsum": dict(env={"REPRO_DECODE_ATTN": "einsum"}),
    # MoE serving (the dense combine, per-(layer, expert) scales)
    "moe-float": dict(arch=MOE),
    "moe-identity": dict(arch=MOE, env={"REPRO_PAGED_PLACEMENT":
                                        "identity"}),
}
# the reference switches the child resets between runs
SWITCHES = ("REPRO_PAGED_PLACEMENT", "REPRO_CHUNKED_PREFILL",
            "REPRO_SERVE_PREQUANT", "REPRO_SERVE_DELAYED_ACT",
            "REPRO_DECODE_ATTN")
# a chunk budget that reads no clock: latency targets no run can miss
PINNED = dict(ttft_s=1e9, tpot_s=1e9)
# speculative decode (``Engine(spec_decode=True)``) on both placements and
# both cache dtypes, each with a draft source made from the streams of the
# plain run named by ``truth`` (each package's drafts from its own run)
IDENTITY = {"REPRO_PAGED_PLACEMENT": "identity"}
SPEC_RUNS = {
    "spec-float-fp8": dict(truth="default", draft="half", k=4),
    "spec-identity-fp8": dict(truth="identity-chunked", draft="oracle",
                              k=4, env=IDENTITY),
    "spec-float-bf16": dict(truth="bf16-chunked", draft="adversarial", k=3,
                            kv="bf16"),
    "spec-identity-bf16": dict(truth="bf16-chunked", draft="half2", k=4,
                               kv="bf16", env=IDENTITY),
    "spec-moe": dict(arch=MOE, truth="moe-float", draft="oracle", k=4),
}
DRAFTS = {"oracle": Oracle, "adversarial": Adversarial, "half": HalfOracle,
          "half2": lambda truth: HalfOracle(truth, good=2)}


def _prompts(lens=LENS):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _run_cfg(get, run):
    """The run's config from ``get`` (either package's get_config)."""
    cfg = get(run.get("arch", ARCH), smoke=True)
    over = {k: run[key] for k, key in (("window", "window"),
                                       ("kv_cache_dtype", "kv"))
            if key in run}
    return cfg.replace(**over) if over else cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's streams and logit gaps for the default run and
    every run of ``RUNS``, and the streams of every run of ``SPEC_RUNS``
    (one child process)."""
    d = tmp_path_factory.mktemp("jax_engine")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " +
                        REFERENCE_XLA_FLAGS).strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parent.parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, __file__, str(d / "out.json")],
                   env=env, check=True, timeout=900)
    return json.loads((d / "out.json").read_text())


def _params(arch=ARCH):
    from repro.models.layers import init_tree
    from repro.models.transformer import model_defs
    from repro.configs.registry import get_config as jax_get_config

    params = init_tree(model_defs(jax_get_config(arch, smoke=True)),
                       jax.random.PRNGKey(SEED))
    return bridge.tree_to_torch(jax.tree.map(np.asarray, params),
                                device="cpu")


def _port_engine(**kw):
    return Engine(get_config(ARCH, smoke=True), _params(),
                  num_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK,
                  device="cpu", **kw)


def _assert_streams(reqs, want, solo=None):
    """Equal greedy streams, except past a reference tie (top two logits
    within 1e-3 * max|logit|), where that request's comparison stops;
    at most one request may stop early.  With ``solo`` (the reference
    serving each request alone) a request may instead equal its solo
    stream: the reference's own batch composition then moved it."""
    exact = 0
    for i, (r, stream, gaps) in enumerate(zip(reqs, want["streams"],
                                              want["gaps"])):
        if r.out == stream or (solo is not None
                               and r.out == solo["streams"][i]):
            exact += 1
            continue
        t = next(i for i, (a, b) in enumerate(zip(r.out, stream)) if a != b)
        gap, big = gaps[t]
        assert gap <= 1e-3 * big, (r.rid, t, r.out, stream, gap, big)
    assert exact >= len(reqs) - 1, exact


def test_engine_streams_match_reference(reference):
    eng = _port_engine()
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    eng.run(reqs, log=None)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    assert eng.kv.allocator.free_pages == eng.kv.allocator.num_pages
    _assert_streams(reqs, reference["default"])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_serving_paths_match_reference(reference, monkeypatch, name):
    """Identity placement (chunked and whole-prompt), the whole-prompt
    prefill on floating pages, the legacy Server, the windowed arch on
    its ring (identity and whole-prompt without being asked), in fp8
    and bf16 caches; the reference's three serving switches
    (``REPRO_SERVE_PREQUANT=0``, ``REPRO_SERVE_DELAYED_ACT=0`` against
    the reference's own just-in-time streams, ``REPRO_DECODE_ATTN=
    einsum``); and the phi3.5-moe smoke model on floating pages and
    identity rows.

    On the ring the reference's streams can depend on the batch they
    were served in: in its fp8 run the request of 9 prompt tokens
    leaves its solo stream at the fifth token (a top-two gap of 1.5%
    of max|logit|, no tie), because a last-bit difference in a batched
    f32 sum flips an fp8 rounding of the cache.  So a windowed request
    may equal the reference's stream either in the mixed batch or
    served alone; the port's own mixed and solo streams are held equal
    in tests/test_torch_ring.py."""
    run = RUNS[name]
    for k, v in run.get("env", {}).items():
        monkeypatch.setenv(k, v)
    cfg = _run_cfg(get_config, run)
    params = _params(cfg.name)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts(run.get("lens", LENS)))]
    if run.get("server"):
        Server(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
               device="cpu").run(list(reqs), log=None)
    else:
        slo = SLOTargets(**PINNED) if run.get("pinned") else None
        eng = Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                     chunk_tokens=CHUNK, device="cpu", slo=slo)
        env = run.get("env", {})
        assert eng.float_pages == (
            env.get("REPRO_PAGED_PLACEMENT") != "identity"
            and "window" not in run)
        assert eng.chunked == (env.get("REPRO_CHUNKED_PREFILL") != "0"
                               and "window" not in run)
        eng.run(reqs, log=None)
        assert not eng.kv.rows
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    _assert_streams(reqs, reference[name], reference.get(name + "-solo"))


@pytest.mark.parametrize("name", sorted(SPEC_RUNS))
def test_spec_paths_match_reference(reference, monkeypatch, name):
    """Speculative verify on floating pages and identity rows, fp8 and
    bf16 caches, and on the MoE smoke model: the port's speculative
    streams equal its own plain
    streams token for token, and the reference's speculative streams
    (which equal the reference's plain ones) up to a reference tie.
    (How many verify steps a run takes depends on the wall clock: the
    chunk budget reads the requests' latencies.)"""
    run = SPEC_RUNS[name]
    for k, v in run.get("env", {}).items():
        monkeypatch.setenv(k, v)
    cfg = _run_cfg(get_config, run)
    params = _params(cfg.name)

    def serve(**kw):
        eng = Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                     chunk_tokens=CHUNK, device="cpu", **kw)
        reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(_prompts())]
        eng.run(reqs, log=None)
        assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
        assert not eng.kv.rows
        return reqs, eng

    plain, _ = serve()
    truth = {r.rid: r.out for r in plain}
    reqs, eng = serve(spec_decode=True, spec_k=run["k"],
                      draft=DRAFTS[run["draft"]](truth))
    assert eng.spec and eng.stats()["spec_verify_steps"] > 0
    assert [r.out for r in reqs] == [r.out for r in plain]
    want, base = reference[name], reference[run["truth"]]
    assert want["streams"] == base["streams"] and want["verify_steps"] > 0
    _assert_streams(reqs, {"streams": want["streams"],
                           "gaps": base["gaps"]})


def test_engine_is_deterministic_and_retires():
    outs = []
    for _ in range(2):
        eng = _port_engine()
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(_prompts()[:3])]
        eng.run(reqs, log=None)
        assert not eng.kv.rows and eng._staging is None
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_engine_refuses_what_waits_and_oversize():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine(prefix_cache=True)
    eng = _port_engine()
    with pytest.raises(SlotCapacityExceeded):
        eng.submit([Request(rid=0, prompt=np.zeros(44, np.int32),
                            max_new=8)])


def test_engine_refuses_unported_reference_switch(monkeypatch):
    monkeypatch.setenv("REPRO_QUANT_HEALTH", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine()
    monkeypatch.setenv("REPRO_QUANT_HEALTH", "0")
    monkeypatch.setenv("REPRO_PAGED_PLACEMENT", "floating")
    with pytest.raises(ValueError, match="REPRO_PAGED_PLACEMENT"):
        _port_engine()


@pytest.mark.parametrize("arch", [ARCH, MOE])
@pytest.mark.parametrize("act", ["delayed", "jit"])
def test_prequant_off_logits_equal_prequant_on(arch, act):
    """The reference's prequant-parity contract, on the port: the bf16
    tree quantized in every step against the build-time scales
    (``REPRO_SERVE_PREQUANT=0``) gives the prefill's and three decode
    steps' logits bitwise those of the build-time fp8 payloads, with
    calibrated activation scales (which calibrate bitwise alike from
    either tree) and just in time; on phi3-mini and on the MoE (its
    expert stacks scaled per (layer, expert))."""
    from repro_torch.core.actscale import calibrate_act_scales
    from repro_torch.train.steps import (make_decode_step,
                                         make_prefill_step,
                                         prequantize_params,
                                         serve_weight_scales)

    cfg = get_config(arch, smoke=True)
    params = _params(arch)
    pq = prequantize_params(cfg, params)
    scales = serve_weight_scales(cfg, params)
    trees = {"off": (params, scales), "on": (pq.qweights, pq.scales)}
    acts = {k: (calibrate_act_scales(cfg, *t) if act == "delayed" else None)
            for k, t in trees.items()}
    if act == "delayed":
        for tag, a in acts["on"].items():
            assert torch.equal(a.s, acts["off"][tag].s), tag
            assert torch.equal(a.sub, acts["off"][tag].sub), tag
    toks = torch.from_numpy(np.stack(_prompts([8, 8])))
    out = {}
    for k, (tree, sc) in trees.items():
        pre = make_prefill_step(cfg, 16, scales=sc, act_scales=acts[k])
        dec = make_decode_step(cfg, scales=sc, act_scales=acts[k])
        logits, caches = pre(tree, toks)
        out[k] = [logits]
        for i in range(3):
            logits, caches = dec(tree, caches, toks[:, i:i + 1])
            out[k].append(logits)
    for i, (a, b) in enumerate(zip(out["off"], out["on"])):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))


def test_serving_switches_read_like_the_reference(monkeypatch):
    """``REPRO_SERVE_PREQUANT``, ``REPRO_SERVE_DELAYED_ACT`` and
    ``REPRO_DECODE_ATTN`` with the reference's names, defaults and
    errors; the engine builds from the bf16 tree and its build-time
    scales under the first, without activation scales (and without
    speculative verify) under the second."""
    from repro_torch.core import runtime_flags as rf

    assert rf.serve_prequant() and rf.serve_delayed_act()
    assert rf.decode_attn_path() == "kernel"
    monkeypatch.setenv("REPRO_DECODE_ATTN", "fused")
    with pytest.raises(ValueError, match="REPRO_DECODE_ATTN"):
        rf.decode_attn_path()
    monkeypatch.setenv("REPRO_DECODE_ATTN", "einsum")
    assert rf.decode_attn_path() == "einsum"
    monkeypatch.setenv("REPRO_SERVE_PREQUANT", "0")
    monkeypatch.setenv("REPRO_SERVE_DELAYED_ACT", "0")
    assert not rf.serve_prequant() and not rf.serve_delayed_act()
    eng = _port_engine(spec_decode=True)
    assert eng.act_scales is None and not eng.spec
    wq = eng.params["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.float32 and eng.scales["blocks"]["attn"][
        "wq"].shape == (2,)


def test_engine_refuses_kv_cache_env_override(monkeypatch):
    # the pool dtype is the config's alone; the reference's override
    # must not be silently ignored
    monkeypatch.setenv("REPRO_KV_CACHE", "bf16")
    with pytest.raises(NotImplementedError, match="kv_cache_dtype"):
        _port_engine()


# --- scheduler units (model-free), from the reference's own cases -------


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def _clock():
    state = {"t": 0.0}
    return state, lambda: state["t"]


def test_scheduler_fifo_refill_order():
    sched = Scheduler(clock=_fake_clock())
    reqs = [Request(rid=i, prompt=np.zeros(4, np.int32), max_new=3)
            for i in range(4)]
    sched.submit(reqs)
    assert sched.peek() is reqs[0]
    assert [sched.pop().rid for _ in range(4)] == [0, 1, 2, 3]
    assert sched.peek() is None


def test_scheduler_retirement_and_metrics():
    sched = Scheduler(clock=_fake_clock())
    req = Request(rid=0, prompt=np.zeros(4, np.int32), max_new=3,
                  eos_id=7)
    sched.submit([req])
    sched.pop()
    assert not sched.on_token(req, 5)
    assert sched.on_token(req, 7)
    assert req.done and req.out == [5, 7]
    assert req.ttft == 1.0 and req.tpot == 1.0
    req2 = Request(rid=1, prompt=np.zeros(4, np.int32), max_new=2)
    sched.submit([req2])
    sched.pop()
    sched.on_token(req2, 1)
    assert sched.on_token(req2, 2) and req2.done
    s = sched.summary()
    assert s["requests"] == 2 and s["tokens"] == 4


def test_chunk_budget_reacts_to_slo_pressure():
    state, now = _clock()
    sched = Scheduler(clock=now, slo=SLOTargets(ttft_s=1.0, tpot_s=0.1))
    assert sched.chunk_budget() == 2
    slow = Request(rid=0, prompt=np.zeros(4, np.int32), max_new=10)
    sched.submit([slow])
    sched.pop()
    sched.on_token(slow, 1)
    state["t"] = 0.3
    sched.on_token(slow, 2)
    assert sched.chunk_budget() == 1
    waiting = Request(rid=1, prompt=np.zeros(4, np.int32), max_new=1)
    sched.submit([waiting])
    state["t"] += 0.6
    assert sched.chunk_budget() == 4


def test_pick_victim_prefers_tpot_headroom():
    state, now = _clock()
    sched = Scheduler(clock=now, slo=SLOTargets(tpot_s=0.1))
    a, b = (Request(rid=i, prompt=np.zeros(4, np.int32), max_new=10)
            for i in range(2))
    sched.submit([a])
    state["t"] = 0.01
    sched.submit([b])
    for r, gap in ((a, 0.09), (b, 0.01)):
        sched.pop()
        sched.on_token(r, 1)
        state["t"] += gap
        sched.on_token(r, 2)
    assert sched.pick_victim([a, b]) is b
    assert sched.pick_victim([]) is None


def test_summary_reports_latency_percentiles():
    state, now = _clock()
    sched = Scheduler(clock=now)
    reqs = [Request(rid=i, prompt=np.zeros(2, np.int32), max_new=2)
            for i in range(3)]
    sched.submit(reqs)
    for i, r in enumerate(reqs):
        sched.pop()
        state["t"] = float(i + 1)
        sched.on_token(r, 1)
        state["t"] += 0.1 * (i + 1)
        sched.on_token(r, 2)
    s = sched.summary()
    assert s["p50_ttft_s"] == pytest.approx(2.0)
    assert s["p99_ttft_s"] == pytest.approx(2.98)
    assert s["p50_tpot_s"] == pytest.approx(0.2)
    assert s["p99_tpot_s"] == pytest.approx(0.298)


# --- page allocator units, from the reference's own cases ---------------


def test_page_allocator_accounting():
    al = PageAllocator(num_pages=8, page_size=4, slot_tokens=32)
    bt = al.admit(owner=1, prompt_tokens=5, total_tokens=13)
    assert len(bt.pages) == 2 and bt.reserved == 4
    assert al.committed_pages == 4 and al.free_pages == 6
    al.grow(1, 9)
    assert len(al.table(1).pages) == 3
    al.grow(1, 9)
    assert len(al.table(1).pages) == 3
    assert al.can_admit(16) and not al.can_admit(17)
    assert al.release(1) == 3
    assert al.free_pages == 8 and al.committed_pages == 0


def test_page_exhaustion_raises_before_corruption():
    al = PageAllocator(num_pages=4, page_size=4, slot_tokens=32)
    al.admit(owner=1, prompt_tokens=8, total_tokens=12)
    assert not al.can_admit(8)
    with pytest.raises(PageExhausted):
        al.admit(owner=2, prompt_tokens=8, total_tokens=8)
    with pytest.raises(SlotCapacityExceeded):
        al.grow(1, 33)
    al.release(1)
    al.admit(owner=2, prompt_tokens=8, total_tokens=8)


def test_usage_mode_extends_then_raises_for_preemption():
    al = PageAllocator(num_pages=3, page_size=4, slot_tokens=32,
                       usage_mode=True)
    al.admit(owner=1, prompt_tokens=4, total_tokens=4)
    al.admit(owner=2, prompt_tokens=4, total_tokens=4)
    al.grow(1, 8)                       # extends past its reservation
    with pytest.raises(PageExhausted):
        al.grow(2, 8)                   # pool dry: the preempt trigger


def test_page_keys_chain_over_the_whole_prefix():
    t = 16
    toks = np.arange(40, dtype=np.int32)
    keys = page_keys(toks, t)
    assert len(keys) == 2
    assert page_keys(np.concatenate([toks[:32], toks[:5]]), t) == keys
    t0 = toks.copy()
    t0[3] += 1
    k0 = page_keys(t0, t)
    assert k0[0] != keys[0] and k0[1] != keys[1]
    t1 = toks.copy()
    t1[20] += 1
    k1 = page_keys(t1, t)
    assert k1[0] == keys[0] and k1[1] != keys[1]
    assert page_keys(toks[:15], t) == []


def test_allocator_refcounted_sharing_and_release():
    al = PageAllocator(num_pages=8, page_size=4, slot_tokens=32)
    donor = al.admit(owner=1, prompt_tokens=8, total_tokens=8)
    for page, key in zip(donor.pages, ["a", "b"]):
        assert al.register_hash(page, key)
    assert al.lookup(["a", "b"]) == donor.pages
    assert al.lookup(["a", "zzz"]) == donor.pages[:1]
    bt = al.admit(owner=2, prompt_tokens=0, total_tokens=12,
                  shared=donor.pages)
    assert bt.pages == donor.pages and bt.shared0 == 2
    assert all(al.refcount(p) == 2 for p in donor.pages)
    assert al.free_pages == 6
    al.release(1)
    assert all(al.refcount(p) == 1 for p in donor.pages)
    al.release(2)
    assert al.cached_pages == 2 and al.free_pages == 8
    assert al.lookup(["a", "b"]) == donor.pages


def test_allocator_double_free_and_reservation_leak_guards():
    al = PageAllocator(num_pages=4, page_size=4)
    bt = al.admit(owner=1, prompt_tokens=4, total_tokens=4)
    with pytest.raises(AssertionError, match="overrun"):
        al._alloc_private(bt)
    al2 = PageAllocator(num_pages=4, page_size=4)
    page = al2.admit(owner=1, prompt_tokens=4, total_tokens=4).pages[0]
    al2._unref(page)
    with pytest.raises(AssertionError, match="double-free"):
        al2._unref(page)


def test_allocator_ensure_writable_state_machine():
    al = PageAllocator(num_pages=8, page_size=4, slot_tokens=32)
    bt = al.admit(owner=1, prompt_tokens=4, total_tokens=16)
    assert al.ensure_writable(1, 0)[0] == "ok"
    al.register_hash(bt.pages[0], "x")
    kind, old, new = al.ensure_writable(1, 0)
    assert kind == "cow" and old != new and bt.pages[0] == new
    assert al.cached_pages == 1
    kind, page, _ = al.ensure_writable(1, 1)
    assert kind == "fresh" and bt.pages[1] == page
    shared = al.lookup(["x"])
    bt2 = al.admit(owner=2, prompt_tokens=0, total_tokens=8,
                   shared=shared)
    al.admit(owner=3, prompt_tokens=0, total_tokens=8, shared=shared)
    kind, old, new = al.ensure_writable(2, 0)
    assert kind == "cow" and bt2.pages[0] == new
    assert al.refcount(old) == 1


def test_allocator_lru_eviction_and_revival():
    al = PageAllocator(num_pages=4, page_size=4)
    bt = al.admit(owner=1, prompt_tokens=16, total_tokens=16)
    keys = ["k0", "k1", "k2", "k3"]
    for page, key in zip(bt.pages, keys):
        al.register_hash(page, key)
    al.release(1)
    assert al.cached_pages == 4 and al.free_pages == 4
    al.admit(owner=2, prompt_tokens=8, total_tokens=8)
    assert al.cached_pages == 2
    assert al.lookup(keys) == []
    al.release(2)
    al3 = PageAllocator(num_pages=4, page_size=4)
    donor = al3.admit(owner=1, prompt_tokens=8, total_tokens=8)
    for page, key in zip(donor.pages, ["a", "b"]):
        al3.register_hash(page, key)
    al3.release(1)
    hit = al3.lookup(["a", "b"])
    assert hit == donor.pages
    assert al3.can_admit(8, shared=hit)
    assert not al3.can_admit(16, shared=hit, cow_slack=1)
    bt3 = al3.admit(owner=2, prompt_tokens=0, total_tokens=12, shared=hit)
    assert al3.cached_pages == 0 and bt3.shared0 == 2


# --- the reference engine, run as a child process ------------------------


def _reference_spec_serve(cfg, params, run, prompts, truth):
    """Serve ``prompts`` through the reference's Engine with speculative
    decode and ``run``'s draft source over ``truth`` (its plain
    streams); returns the streams and the verify counts."""
    from repro.serving import Engine as JEngine, Request as JRequest

    reqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    eng = JEngine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                  chunk_tokens=CHUNK, prefix_cache=False, spec_decode=True,
                  draft=DRAFTS[run["draft"]](dict(enumerate(truth))),
                  spec_k=run["k"])
    assert eng.spec
    eng.run(reqs, log=None)
    return {"streams": [r.out for r in reqs],
            "verify_steps": eng.stats()["spec_verify_steps"]}


def _reference_serve(cfg, params, run, prompts, slots=SLOTS):
    """Serve ``prompts`` through the reference's Engine (or its legacy
    Server); returns the streams and, per generated token, the gap
    between the top two logits it was sampled from and the largest
    |logit|."""
    from repro.launch.serve import Server as JServer
    from repro.serving import Engine as JEngine, Request as JRequest

    from repro.serving.scheduler import SLOTargets as JSLOTargets

    reqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    gaps = {r.rid: [] for r in reqs}
    last = {}

    def capture(fn, row_of):
        def step(*a):
            out = fn(*a)
            last["logits"] = np.asarray(out[0], np.float32)
            last["row_of"] = row_of()
            return out
        return step

    def record(on_token):
        def rec(req, token):
            row = last["row_of"](req, last["logits"])
            top = np.sort(row)
            assert int(np.argmax(row)) == int(token)
            gaps[req.rid].append([float(top[-1] - top[-2]),
                                  float(np.abs(row).max())])
            return on_token(req, token)
        return rec

    first = lambda req, lg: lg[0, -1]
    if run.get("server"):
        srv = JServer(cfg, params, batch_slots=slots, max_len=MAX_LEN)
        slots = lambda: (lambda req, lg: lg[srv.slots.index(req), 0])
        srv.prefill = capture(srv.prefill, lambda: first)
        srv.decode = capture(srv.decode, slots)
        srv._on_token = record(srv._on_token)
        srv.run(list(reqs), log=lambda *a: None)
    else:
        slo = JSLOTargets(**PINNED) if run.get("pinned") else None
        eng = JEngine(cfg, params, num_slots=slots, max_len=MAX_LEN,
                      chunk_tokens=CHUNK, prefix_cache=False, slo=slo)

        def decode_rows():
            rows = list(eng.kv.rows)

            def row_of(req, lg):
                if lg.shape[1] == 1:             # batched decode step
                    return lg[rows.index(req.rid), 0]
                # the last chunk of a prompt
                return lg[0, (req.prompt_len - 1) % lg.shape[1]]
            return row_of

        eng._run_decode = capture(eng._run_decode, decode_rows)
        eng._run_prefill = capture(eng._run_prefill, lambda: first)
        eng.sched.on_token = record(eng.sched.on_token)
        eng.run(reqs, log=None)
    return {"streams": [r.out for r in reqs],
            "gaps": [gaps[r.rid] for r in reqs]}


# the switches a reference step reads while it is traced
TRACED_SWITCHES = ("REPRO_SERVE_PREQUANT", "REPRO_SERVE_DELAYED_ACT",
                   "REPRO_DECODE_ATTN")


def _share_steps():
    """In the child: the reference's engines and Server build their
    steps through one cache, keyed by the config, the builder's
    positional arguments and the switches read at trace time, so that
    engines of one config share one jitted function per step and
    compile each input shape once, not once per engine.  Every run's
    weights come from ``SEED``, so their build-time scales, which the
    steps close over, are equal within a key."""
    import repro.launch.serve as jserve
    import repro.serving.engine as jengine

    built = {}

    def shared(name, make):
        def build(cfg, *args, **kw):
            key = (name, cfg, args, tuple(os.environ.get(k)
                                          for k in TRACED_SWITCHES))
            if key not in built:
                built[key] = make(cfg, *args, **kw)
            return built[key]
        return build

    for mod in (jengine, jserve):
        for name in ("make_prefill_step", "make_decode_step",
                     "make_verify_step"):
            if hasattr(mod, name):
                setattr(mod, name, shared(name, getattr(mod, name)))


def _reference_child(out: str) -> None:
    """The child process: every run's reference streams, into ``out``."""
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.layers import init_tree
    from repro.models.transformer import model_defs

    _share_steps()
    res = {}
    for name, run in [("default", {})] + sorted(RUNS.items()):
        for k in SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(run.get("env", {}))
        cfg = _run_cfg(jax_get_config, run)
        params = init_tree(model_defs(jax_get_config(cfg.name, smoke=True)),
                           jax.random.PRNGKey(SEED))
        prompts = _prompts(run.get("lens", LENS))
        res[name] = _reference_serve(cfg, params, run, prompts)
        if "window" in run:           # one slot: each request alone
            res[name + "-solo"] = _reference_serve(cfg, params, run,
                                                   prompts, slots=1)
    for name, run in sorted(SPEC_RUNS.items()):
        for k in SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(run.get("env", {}))
        cfg = _run_cfg(jax_get_config, run)
        params = init_tree(model_defs(jax_get_config(cfg.name, smoke=True)),
                           jax.random.PRNGKey(SEED))
        res[name] = _reference_spec_serve(cfg, params, run, _prompts(),
                                          res[run["truth"]]["streams"])
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _reference_child(sys.argv[1])


# --- the serving profiler's trace summary -------------------------------


def test_profile_summary_attributes_card_time_to_steps():
    from repro_torch.launch.profile_serve import summarize

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    long1, long2 = ("void other<" + "a" * 90 + t for t in ("1>", "2>"))
    trace = {"traceEvents": [
        x("user_annotation", "decode_step", 0.0, 100.0),
        x("user_annotation", "prefill_chunk", 200.0, 200.0),
        x("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, 1),
        x("cuda_runtime", "cudaLaunchKernel", 6.0, 1.0, 2),
        x("cuda_runtime", "cudaLaunchKernel", 210.0, 1.0, 3),
        x("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, 4),
        x("cuda_runtime", "cudaLaunchKernel", 220.0, 1.0, 5),
        x("cuda_runtime", "cudaLaunchKernel", 230.0, 1.0, 6),
        x("kernel", "mx_gemm_kernel(args)", 10.0, 30.0, 1),
        x("kernel", "void other<b>", 30.0, 30.0, 2),   # overlaps: union 50
        x("kernel", long1, 250.0, 60.0, 3),
        x("kernel", "mx_gemm_kernel(args)", 310.0, 40.0, 5),
        x("kernel", long2, 360.0, 20.0, 6),
        x("gpu_memcpy", "Memcpy HtoD", 160.0, 10.0, 4),  # between steps
    ]}
    s = summarize(trace)
    d, p, run = s["decode_step"], s["prefill_chunk"], s["run"]
    assert (d["steps"], d["launches"], p["launches"]) == (1, 2, 3)
    assert d["host_span_ms"] == pytest.approx(0.1)
    assert d["card_busy_ms"] == pytest.approx(0.05)
    assert d["card_ms_port_kernels"] == pytest.approx(0.03)
    assert d["card_ms_other_kernels"] == pytest.approx(0.03)
    # names are cut to 80 characters; kernels that share the cut name
    # are summed, not overwritten
    assert p["card_ms_by_kernel"] == pytest.approx(
        {"mx_gemm_kernel(args)": 0.04, long1[5:85]: 0.08})
    assert p["card_busy_ms"] == pytest.approx(0.12)
    assert run["wall_ms"] == pytest.approx(0.4)
    assert run["card_busy_ms"] == pytest.approx(0.18)
    assert run["card_idle_share"] == pytest.approx(0.55)


def test_profile_summary_counts_port_launches_and_watched_ops():
    """Per step: each port kernel's launches, and the PyTorch ops issued
    inside the span (the most frequent, and the watched abs and amax of
    a plain level-1 scale, 0 when absent)."""
    from repro_torch.launch.profile_serve import summarize

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = {"traceEvents": [
        x("user_annotation", "train_step", 0.0, 100.0),
        x("user_annotation", "train_step", 200.0, 100.0),
        x("cpu_op", "aten::mul", 1.0, 1.0),
        x("cpu_op", "aten::abs", 2.0, 1.0),
        x("cpu_op", "aten::mul", 201.0, 1.0),
        x("cpu_op", "aten::abs", 150.0, 1.0),          # between steps
        x("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, 1),
        x("cuda_runtime", "cudaLaunchKernel", 6.0, 1.0, 2),
        x("cuda_runtime", "cudaLaunchKernel", 205.0, 1.0, 3),
        x("kernel", "void global_amax_kernel<true>(args)", 10.0, 5.0, 1),
        x("kernel", "void mx_quant_kernel<8, false>(args)", 20.0, 9.0, 2),
        x("kernel", "void global_amax_kernel<true>(args)", 210.0, 5.0, 3),
    ]}
    s = summarize(trace, ("train_step",))["train_step"]
    assert s["launches_by_port_kernel"] == {
        "global_amax_kernel<true>(args)": 1.0,
        "mx_quant_kernel<8, false>(args)": 0.5}
    assert s["ops_per_step"] == {"aten::mul": 1.0, "aten::abs": 0.5,
                                 "aten::amax": 0.0}
    assert s["card_ms_port_kernels"] == pytest.approx(0.0095)
