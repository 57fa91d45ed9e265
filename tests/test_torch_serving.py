"""The port's serving layer: the host-side allocator and scheduler
(units ported from the reference's own cases) and the paged engine end
to end against the reference's.

End to end, a ``repro_torch`` ``Engine(device="cpu")`` and a ``repro``
``Engine`` serve the same requests on the same weights (the reference's
smoke phi3-mini, carried across by ``repro_torch.bridge``), mixed prompt
lengths, a page-aligned ``max_len``, each engine with its defaults (the
prefix cache on).  Each builds and calibrates itself.  The greedy
streams must be equal, except where the reference's top two logits lie
within 1e-3 * max|logit| (a tie): there the comparison of that request
stops, as tests/test_chunked_prefill.py does.  The runs that preempt,
share a prefix or serve a baseline recipe also hold the engines'
counters equal: both schedulers then read a clock that ticks once a
call, and latency targets no run can miss, so that every admission and
victim is decided alike.

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
import sys

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
from test_torch_train import (
    _run_dir,
    child_output,
    reference_env,
    start_reference_child,
)

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
    # the prefix cache at its default: a donor, then a wave with a
    # partial hit (a 32-token shared prefix, its own 9-token suffix) and
    # a full hit (the donor's prompt again: one copy-on-write)
    "prefix": dict(waves="prefix", max_len=64, ticks=True),
    # a 6-page pool where the worst cases need 4 pages a request:
    # usage admission packs 3 and preempts to the host
    # (tests/test_chunked_prefill.py's case); reservation admission
    # (REPRO_PREEMPTION=0) serves them one or two at a time
    "preempt": dict(lens=[12] * 4, max_new=40, max_len=64, num_pages=6,
                    ticks=True),
    "reservation": dict(lens=[12] * 4, max_new=40, max_len=64, num_pages=6,
                        ticks=True, env={"REPRO_PREEMPTION": "0"}),
    # the paper's baselines (COAT per-128-group, TE per-tensor), served
    # with their calibrated activation scales
    "per_group": dict(quant="per_group", ticks=True),
    "per_tensor": dict(quant="per_tensor", ticks=True),
    # quant-health telemetry: the instrumented steps on the first call of
    # each step shape and every third call after it
    "health": dict(env={"REPRO_QUANT_HEALTH": "1",
                        "REPRO_QUANT_HEALTH_EVERY": "2"}, ticks=True),
    # REPRO_KV_CACHE: the config's fp8 cache overridden to bf16, on the
    # default path and on the preempt run's pool (its scales None)
    "kv-env-bf16": dict(env={"REPRO_KV_CACHE": "bf16"}),
    "preempt-kv-bf16": dict(lens=[12] * 4, max_new=40, max_len=64,
                            num_pages=6, ticks=True,
                            env={"REPRO_KV_CACHE": "bf16"}),
}
# the reference switches the child resets between runs
SWITCHES = ("REPRO_PAGED_PLACEMENT", "REPRO_CHUNKED_PREFILL",
            "REPRO_SERVE_PREQUANT", "REPRO_SERVE_DELAYED_ACT",
            "REPRO_DECODE_ATTN", "REPRO_PREEMPTION", "REPRO_PREFIX_CACHE",
            "REPRO_KV_CACHE", "REPRO_QUANT_HEALTH",
            "REPRO_QUANT_HEALTH_EVERY")
# the engine counters a ``ticks`` run holds equal to the reference's
COUNTERS = ("preemptions", "swap_ins", "prefix_hits",
            "prefill_tokens_skipped", "pages_shared", "cow_copies",
            "peak_pool_pages")
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


def _waves(run):
    """The run's prompts, as the waves it serves one ``run()`` call
    each: one wave of ``lens``, or the prefix run's donor and then its
    wave of a partial and a full hit."""
    if run.get("waves") == "prefix":
        rng = np.random.default_rng(3)
        prefix = rng.integers(0, 512, 32).astype(np.int32)
        tail = rng.integers(0, 512, 9).astype(np.int32)
        return [[prefix], [np.concatenate([prefix, tail]), prefix.copy()]]
    return [_prompts(run.get("lens", LENS))]


def _engine_kw(run):
    return {"max_len": run.get("max_len", MAX_LEN),
            "num_pages": run.get("num_pages")}


def _ticks():
    """A clock that advances one second a call."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def _serve_waves(eng, run, make_request):
    """Serve the run's waves through ``eng`` (either package's engine,
    ``make_request`` its Request); returns every request in rid order."""
    if run.get("ticks"):
        eng.sched.clock = _ticks()
    reqs, rid = [], 0
    for wave in _waves(run):
        batch = []
        for p in wave:
            batch.append(make_request(rid=rid, prompt=p,
                                      max_new=run.get("max_new", MAX_NEW)))
            rid += 1
        eng.run(batch, log=None)
        reqs += batch
    return reqs


def _run_cfg(get, run):
    """The run's config from ``get`` (either package's get_config)."""
    cfg = get(run.get("arch", ARCH), smoke=True)
    over = {k: run[key] for k, key in (("window", "window"),
                                       ("kv_cache_dtype", "kv"))
            if key in run}
    if "quant" in run:
        over["quant"] = type(cfg.quant)(mode=run["quant"],
                                        weight_scaling="jit")
    return cfg.replace(**over) if over else cfg


CHILD_OUT = "serving_reference.json"
start_reference_child(CHILD_OUT, __file__, reference_env())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's streams and logit gaps for the default run and
    every run of ``RUNS``, and the streams of every run of ``SPEC_RUNS``
    (one child process; under pytest-xdist started at collection,
    ``start_reference_child``)."""
    base = _run_dir() or tmp_path_factory.mktemp("jax_engine")
    out = child_output(base, CHILD_OUT, __file__, reference_env())
    return json.loads(out.read_text())


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


@pytest.mark.parametrize("mode", ["per_group", "per_tensor"])
def test_baseline_prequant_is_bitwise_the_reference(mode):
    """``prequantize_params`` in the per_group and per_tensor recipes
    (``jit`` weight scaling: each layer slice against its own amax):
    payloads and scales bit for bit the reference's, on the smoke
    phi3-mini weights."""
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.layers import init_tree
    from repro.models.transformer import model_defs
    from repro.train import steps as jsteps
    from repro_torch.train.steps import prequantize_params

    run = {"quant": mode}
    jcfg = _run_cfg(jax_get_config, run)
    jparams = init_tree(model_defs(jcfg), jax.random.PRNGKey(SEED))
    jp = jsteps.prequantize_params(jcfg, jparams)
    tp = prequantize_params(_run_cfg(get_config, run), _params())
    jq = dict(jax.tree_util.tree_flatten_with_path(jp.qweights)[0])
    js = dict(jax.tree_util.tree_flatten_with_path(jp.scales)[0])

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    n = 0
    for path, q in walk(tp.qweights):
        key = tuple(jax.tree_util.DictKey(k) for k in path)
        s = dict(walk(tp.scales))[path]
        want_q, want_s = np.asarray(jq[key]), np.asarray(js[key])
        if q.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            n += 1
            assert np.array_equal(bridge.bits(q),
                                  want_q.view(np.uint8)), path
        assert np.array_equal(bridge.bits(s.to(torch.float32)).reshape(-1),
                              want_s.astype(np.float32).view(np.int32)
                              .reshape(-1)), path
    assert n >= 7, n


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


def test_engine_refuses_what_waits_and_oversize(monkeypatch):
    """``Engine()`` takes the prefix cache from ``REPRO_PREFIX_CACHE``
    (on by default, as the reference's), and refuses a request larger
    than its slot."""
    eng = _port_engine()
    assert eng.prefix_cache and eng.preemption
    with pytest.raises(SlotCapacityExceeded):
        eng.submit([Request(rid=0, prompt=np.zeros(44, np.int32),
                            max_new=8)])
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "0")
    assert not _port_engine().prefix_cache
    assert _port_engine(prefix_cache=True).prefix_cache
    monkeypatch.setenv("REPRO_PAGED_PLACEMENT", "identity")
    assert not _port_engine(prefix_cache=True).prefix_cache


def test_moe_serving_refuses_the_baselines(monkeypatch):
    """The MoE serves in per_group and per_tensor now (its dense combine
    one expert at a time, each (layer, expert) site calibrated on its
    own; the streams against the reference's are
    tests/test_torch_moe.py's ``test_moe_baselines_serve_as_the_reference``):
    the engine builds in both; what the baselines' serving still
    refuses is what every recipe refuses, a MoE over more than one rank
    (expert parallelism)."""
    params = _params(MOE)
    for quant in ("per_group", "per_tensor"):
        cfg = _run_cfg(get_config, {"arch": MOE, "quant": quant})
        eng = Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                     device="cpu")
        assert eng.act_scales["blocks/moe/w_down"].s.shape[:2] == (
            cfg.n_layers, cfg.n_experts)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN, device="cpu")


@pytest.mark.parametrize("name,values", [
    ("REPRO_QUANT_HEALTH", ["", "1", "0", "yes", " 1 "]),
    ("REPRO_QUANT_HEALTH_EVERY", ["", "4", "0", "-3", "x", "2.5"]),
    ("REPRO_TRACE", ["", "  ", "t.json"]),
    ("REPRO_KV_CACHE", ["", "bf16", "fp8", "int8", " bf16"]),
])
def test_obs_and_cache_switches_read_like_the_reference(monkeypatch, name,
                                                        values):
    """``REPRO_QUANT_HEALTH``, ``REPRO_QUANT_HEALTH_EVERY``,
    ``REPRO_TRACE`` and ``REPRO_KV_CACHE`` with the reference's names,
    defaults and errors: each value read by both packages' flag
    functions gives the same result or the same exception."""
    from repro.core import runtime_flags as jrf
    from repro_torch.core import runtime_flags as rf

    fn = {"REPRO_QUANT_HEALTH": "quant_health",
          "REPRO_QUANT_HEALTH_EVERY": "quant_health_every",
          "REPRO_TRACE": "trace_path",
          "REPRO_KV_CACHE": "kv_cache_override"}[name]

    def read(mod):
        try:
            return getattr(mod, fn)()
        except ValueError as e:
            return ("ValueError", str(e))

    for value in values:
        if value:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)
        assert read(rf) == read(jrf), (name, value)
    assert jrf.KV_CACHE_DTYPES == rf.KV_CACHE_DTYPES


def test_engine_takes_the_obs_and_cache_switches(monkeypatch):
    """The engine builds under every served value: quant-health on
    (with delayed activation scales; inert without them, as in the
    reference), a bf16 pool under ``REPRO_KV_CACHE=bf16`` (scales
    None), an fp8 pool under ``fp8`` on a bf16 config; another cache
    value and the ``REPRO_PAGED_PLACEMENT`` typo raise ``ValueError``."""
    monkeypatch.setenv("REPRO_QUANT_HEALTH", "1")
    eng = _port_engine()
    assert eng.health and eng.health_every == 16 and eng.qh is not None
    monkeypatch.setenv("REPRO_SERVE_DELAYED_ACT", "0")
    eng = _port_engine()
    assert not eng.health and eng.qh is None
    monkeypatch.delenv("REPRO_SERVE_DELAYED_ACT")
    monkeypatch.setenv("REPRO_KV_CACHE", "bf16")
    pool = _port_engine().kv.caches["blocks"]
    assert pool.k.dtype == torch.bfloat16 and pool.k_scale is None
    monkeypatch.setenv("REPRO_KV_CACHE", "fp8")
    eng = Engine(get_config(ARCH, smoke=True).replace(kv_cache_dtype="bf16"),
                 _params(), num_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    pool = eng.kv.caches["blocks"]
    assert pool.k.dtype == torch.float8_e4m3fn and pool.k_scale is not None
    monkeypatch.setenv("REPRO_KV_CACHE", "int8")
    with pytest.raises(ValueError, match="REPRO_KV_CACHE"):
        _port_engine()
    monkeypatch.delenv("REPRO_KV_CACHE")
    monkeypatch.setenv("REPRO_PAGED_PLACEMENT", "floating")
    with pytest.raises(ValueError, match="REPRO_PAGED_PLACEMENT"):
        _port_engine()


@pytest.mark.parametrize("run", [ARCH, MOE, "per_group", "per_tensor"])
@pytest.mark.parametrize("act", ["delayed", "jit"])
def test_prequant_off_logits_equal_prequant_on(run, act):
    """The reference's prequant-parity contract, on the port: the bf16
    tree quantized in every step against the build-time scales
    (``REPRO_SERVE_PREQUANT=0``) gives the prefill's and three decode
    steps' logits bitwise those of the build-time fp8 payloads, with
    calibrated activation scales (which calibrate bitwise alike from
    either tree) and just in time; on phi3-mini and on the MoE (its
    expert stacks scaled per (layer, expert)), and on phi3-mini in the
    baseline recipes (``jit`` weight scaling: each weight quantized in
    the step against its own amax, bitwise what ``prequantize_params``
    builds)."""
    from repro_torch.core.actscale import calibrate_act_scales
    from repro_torch.train.steps import (make_decode_step,
                                         make_prefill_step,
                                         prequantize_params,
                                         serve_weight_scales)

    baseline = run in ("per_group", "per_tensor")
    cfg = _run_cfg(get_config, {"quant": run} if baseline else {"arch": run})
    params = _params(ARCH if baseline else run)
    pq = prequantize_params(cfg, params)
    scales = serve_weight_scales(cfg, params)
    trees = {"off": (params, scales), "on": (pq.qweights, pq.scales)}
    acts = {k: (calibrate_act_scales(cfg, *t) if act == "delayed" else None)
            for k, t in trees.items()}
    if act == "delayed":
        for tag, a in acts["on"].items():
            b = acts["off"][tag]
            assert torch.equal(a.s, b.s), tag
            assert (a.sub is None) == (b.sub is None), tag
            assert a.sub is None or torch.equal(a.sub, b.sub), tag
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
    want = reference[name]
    if run.get("server"):
        reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(_prompts(run.get("lens", LENS)))]
        Server(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
               device="cpu").run(list(reqs), log=None)
    else:
        slo = SLOTargets(**PINNED) if (run.get("pinned")
                                       or run.get("ticks")) else None
        if run.get("ticks"):
            registry, tracer = _port_obs(monkeypatch)
        eng = Engine(cfg, params, num_slots=SLOTS, chunk_tokens=CHUNK,
                     device="cpu", slo=slo, **_engine_kw(run))
        env = run.get("env", {})
        assert eng.float_pages == (
            env.get("REPRO_PAGED_PLACEMENT") != "identity"
            and "window" not in run)
        assert eng.chunked == (env.get("REPRO_CHUNKED_PREFILL") != "0"
                               and "window" not in run)
        assert eng.prefix_cache == (eng.float_pages and eng.chunked)
        assert eng.preemption == (eng.float_pages and eng.chunked and
                                  env.get("REPRO_PREEMPTION") != "0")
        reqs = _serve_waves(eng, run, Request)
        assert not eng.kv.rows and not eng._preempted
        al = eng.kv.allocator
        assert al.free_pages == al.num_pages
        if run.get("ticks"):
            st = eng.stats()
            assert {k: st[k] for k in COUNTERS} == want["counters"]
            _assert_obs(registry, tracer, st, eng, want)
        if "quant" in run:
            # the calibrated activation scales, bit for bit
            assert sorted(eng.act_scales) == sorted(want["act_scales"])
            for tag, (s_bits, sub) in want["act_scales"].items():
                a = eng.act_scales[tag]
                assert a.sub is None and sub is None, tag
                assert bridge.bits(a.s).reshape(-1).tolist() == s_bits, tag
    assert all(r.done and len(r.out) == run.get("max_new", MAX_NEW)
               for r in reqs)
    _assert_streams(reqs, want, reference.get(name + "-solo"))


def test_run_counters_show_their_paths(reference):
    """The reference's counters on the runs that hold them: the prefix
    run hits twice (a partial hit skips 32 prompt tokens, the full hit
    31 and copies one page on write), the preempt run swaps out and back
    in, and reservation admission never preempts."""
    c = {name: reference[name]["counters"] for name in RUNS
         if RUNS[name].get("ticks")}
    assert (c["prefix"]["prefix_hits"], c["prefix"]["prefill_tokens_skipped"],
            c["prefix"]["pages_shared"], c["prefix"]["cow_copies"]) \
        == (2, 63, 4, 1)
    assert c["preempt"]["preemptions"] > 0
    assert c["preempt"]["swap_ins"] == c["preempt"]["preemptions"]
    assert c["reservation"]["preemptions"] == 0
    for name in ("per_group", "per_tensor"):
        assert c[name]["preemptions"] == c[name]["cow_copies"] == 0


def _port_obs(monkeypatch):
    """A fresh metrics registry and an enabled tracer in place of the
    port's process-wide ones, for this test only."""
    from repro_torch.obs import metrics, trace

    monkeypatch.setattr(metrics, "_REGISTRY", metrics.Registry())
    monkeypatch.setattr(trace, "_TRACER", trace.Tracer().enable())
    return metrics.get_registry(), trace.get_tracer()


def _obs_record(snapshot: dict, events: list) -> dict:
    """A run's registry snapshot (histograms by observation count) and
    its trace events (name, phase and args; no times), through JSON as
    the child writes them."""
    metrics = {name: {"kind": m["kind"], "help": m["help"], "series": {
        k: v["count"] if m["kind"] == "histogram" else v
        for k, v in m["series"].items()}} for name, m in snapshot.items()}
    trace = [[e["name"], e["ph"], e.get("args")] for e in events]
    return json.loads(json.dumps({"metrics": metrics, "trace": trace}))


def _assert_obs(registry, tracer, st, eng, want):
    """The engine's spans and published series equal the reference
    engine's on the same run; with quant-health on, its report too:
    per-site sampled steps equal, the rates exactly, drift_max and amax
    within 1e-6 relative."""
    got = _obs_record(registry.snapshot(), tracer.events())
    assert got["trace"] == want["obs"]["trace"]
    assert got["metrics"] == want["obs"]["metrics"]
    assert any(t[0] == "engine.step" for t in got["trace"])
    assert {"engine_prefix_hits_total", "sched_tokens_generated_total",
            "pages_total"} <= set(got["metrics"])
    if "quant_health" not in want:
        assert "quant_health" not in st
        return
    qh, wq = st["quant_health"], want["quant_health"]
    assert eng.qh.steps == want["health_steps"] > 0
    assert qh["refresh_recommended"] == wq["refresh_recommended"]
    assert sorted(qh["sites"]) == sorted(wq["sites"])
    for tag, w in wq["sites"].items():
        g = qh["sites"][tag]
        assert g["steps"] == w["steps"] > 0, tag
        assert g["saturation_rate"] == w["saturation_rate"], tag
        assert g["underflow_rate"] == w["underflow_rate"], tag
        for k in ("drift_max", "amax"):
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (tag, k, g[k], w[k])


def test_kv_cache_override_serves_the_bf16_config(reference):
    """``REPRO_KV_CACHE=bf16`` is the config's ``kv_cache_dtype="bf16"``
    (the reference's streams under the two are equal), and the
    preempting bf16 pool swaps as the fp8 one does."""
    assert (reference["kv-env-bf16"]["streams"]
            == reference["bf16-chunked"]["streams"])
    c = reference["preempt-kv-bf16"]["counters"]
    assert c["preemptions"] > 0 and c["swap_ins"] == c["preemptions"]


HEALTH_CASES = {"phi3-decode": (ARCH, "decode"),
                "phi3-verify": (ARCH, "verify"),
                "moe-decode": (MOE, "decode")}
HEALTH_PROMPT_LEN, HEALTH_VERIFY_K = 8, 3


def _health_feed(kind):
    """The health steps' prompts (2, 8) and fed tokens (2, 1) or (2, 3)."""
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, 512, (2, HEALTH_PROMPT_LEN)).astype(np.int32)
    feed = rng.integers(0, 512, (2, HEALTH_VERIFY_K)).astype(np.int32)
    return prompts, feed[:, :1] if kind == "decode" else feed


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_steps_match_reference(reference, case):
    """A decode (or verify) step built with ``quant_health=True`` on the
    smoke phi3-mini (and a phi3.5-moe decode step), after a whole-prompt
    prefill, with pre-quantized weights and calibrated activation
    scales: its tree has the reference's sites (none of the MoE's
    experts) and shapes ((layers,) a layer's site, scalar the head's),
    the counts equal, amax and drift within 1e-6 relative; its logits
    bitwise those of the health-off step on the same caches."""
    from repro_torch.serving.engine import calibrate_serving, prepare_weights
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_verify_step)

    arch, kind = HEALTH_CASES[case]
    cfg = get_config(arch, smoke=True)
    w, sc = prepare_weights(cfg, _params(arch))
    act = calibrate_serving(cfg, w, sc)
    prompts, feed = (torch.from_numpy(t) for t in _health_feed(kind))
    make = make_decode_step if kind == "decode" else make_verify_step
    pre = make_prefill_step(cfg, MAX_LEN, scales=sc, act_scales=act)
    out = {}
    for health in (False, True):
        _, caches = pre(w, prompts)
        step = make(cfg, scales=sc, act_scales=act, quant_health=health)
        out[health] = step(w, caches, feed)
    assert len(out[False]) == 2 and len(out[True]) == 3
    assert torch.equal(out[True][0], out[False][0])
    tree, want = out[True][2], reference["health_steps"][case]
    assert sorted(tree) == sorted(want)
    assert not any("/moe/" in tag for tag in tree)
    for tag, stats in want.items():
        for k, v in stats.items():
            v = np.asarray(v, np.float32)
            g = tree[tag][k].numpy()
            assert g.shape == v.shape, (tag, k)
            if k in ("n", "sat", "underflow", "nonzero"):
                assert np.array_equal(g, v), (tag, k, g, v)
            else:
                assert np.all(np.abs(g - v) <= 1e-6 * np.abs(v)), (tag, k)
    assert tree["blocks/attn/wq"]["n"].shape == (cfg.n_layers,)


def test_refresh_act_scales_match_reference(reference):
    """``Engine.refresh_act_scales(tokens=...)`` and the legacy
    ``Server``'s (with a margin) calibrate again on the given tokens:
    the act scales bit for bit the reference's on the same tokens; the
    steps are rebuilt over them.  ``prune_finished`` drops the finished
    requests and returns their count."""
    cfg = get_config(ARCH, smoke=True)
    toks = _refresh_tokens()
    eng = _port_engine()
    old = eng.decode
    got = {"engine": eng.refresh_act_scales(tokens=toks)}
    assert eng.decode is not old
    srv = Server(cfg, _params(), batch_slots=SLOTS, max_len=MAX_LEN,
                 device="cpu")
    got["server"] = srv.refresh_act_scales(tokens=toks, margin=1.5)
    for who, want in reference["refresh"].items():
        assert sorted(got[who]) == sorted(want), who
        for tag, (s_bits, sub) in want.items():
            a = got[who][tag]
            assert bridge.bits(a.s).reshape(-1).tolist() == s_bits, (who, tag)
            assert a.sub.reshape(-1).tolist() == sub, (who, tag)
    reqs = [Request(rid=i, prompt=p, max_new=3)
            for i, p in enumerate(_prompts()[:3])]
    eng.run(reqs, log=None)
    later = Request(rid=9, prompt=_prompts()[3], max_new=3)
    eng.submit([later])
    assert eng.stats()["requests"] == 3
    assert eng.prune_finished() == 3
    assert sorted(eng.requests) == [9] and eng.stats()["requests"] == 0
    eng.run([], log=None)
    assert later.done and eng.prune_finished() == 1 and not eng.requests


def _refresh_tokens():
    return np.random.default_rng(5).integers(0, 512, (1, 24)).astype(
        np.int32)


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


# --- prefix sharing and swap, port only (the reference's own cases) -----


def _engine_at(slots, max_len, **kw):
    return Engine(get_config(ARCH, smoke=True), _params(), num_slots=slots,
                  max_len=max_len, chunk_tokens=8, device="cpu", **kw)


def _prompt(seed, n=32):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def _swap_round_trip():
    """swap_out then swap_in restores the victim's pages bit for bit:
    payloads and scales of every pool tensor, every layer."""
    from repro_torch.models.attention import _bytes
    from repro_torch.serving.paged_cache import _leaves

    eng = _engine_at(2, 64)
    assert eng.preemption
    req = Request(rid=0, prompt=_prompt(0, 21), max_new=8)
    eng.submit([req])
    for _ in range(4):                       # attach and a few decodes
        eng.step()
    assert not req.done

    def snap(pages):
        return [_bytes(buf)[:, pages].clone()
                for pool in eng.kv.caches.values() for buf in _leaves(pool)]

    before = snap(list(eng.kv.allocator.table(0).pages))
    bundle = eng.kv.swap_out(eng.kv.rows.index(0))
    assert 0 not in eng.kv.rows and bundle["n_pages"] == len(before[0][0])
    assert eng.kv.allocator.free_pages == eng.kv.allocator.num_pages
    eng.kv.swap_in(bundle, req.prompt_len + req.max_new - 1)
    after = snap(list(eng.kv.allocator.table(0).pages))
    assert len(before) == 4                  # k, v and their fp8 scales
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def _donor_unperturbed():
    """The donor's stream is the same whether or not a sharer mapped (and
    then left) its prefix pages."""
    prefix, suffix = _prompt(2), _prompt(3, 5)
    solo = Request(rid=0, prompt=prefix, max_new=6)
    _engine_at(1, 48).run([solo], log=None)
    donor = Request(rid=0, prompt=prefix, max_new=6)
    sharer = Request(rid=1, prompt=np.concatenate([prefix, suffix]),
                     max_new=6)
    eng = _engine_at(2, 48)
    eng.run([donor, sharer], log=None)
    assert eng.prefix_hits == 1 and sharer.prefix_pages == 2
    assert donor.out == solo.out


def _map_survives_retirement():
    """A retired donor's hashed pages park evictable and revive on the
    next hit: the second serve of the prompt chunks only its last
    token."""
    eng = _engine_at(1, 48, num_pages=6)
    eng.run([Request(rid=0, prompt=_prompt(4), max_new=3)], log=None)
    al = eng.kv.allocator
    assert al.free_pages == al.num_pages and al.cached_pages == 2
    second = Request(rid=1, prompt=_prompt(4), max_new=3)
    eng.run([second], log=None)
    assert second.prefill_skipped == 31 and second.prefix_pages == 2
    assert eng.prefix_hits == 1 and eng.kv.cow_copies == 1
    assert second.done and len(second.out) == 3


def _full_hit_minimal_pool():
    """On a pool of one slot's pages a full hit (page revival and the CoW
    slack) needs more headroom than a cold admit: it is served cold."""
    eng = _engine_at(1, 48)                  # a 3-page pool
    first = Request(rid=0, prompt=_prompt(7), max_new=3)
    eng.run([first], log=None)
    second = Request(rid=1, prompt=_prompt(7), max_new=3)
    eng.run([second], log=None)
    assert eng.prefix_hits == 0 and eng.pages_shared == 0
    assert second.prefill_skipped == 0 and second.out == first.out


def _cache_off_never_shares():
    reqs = [Request(rid=i, prompt=_prompt(5), max_new=3) for i in range(2)]
    eng = _engine_at(2, 48, prefix_cache=False)
    eng.run(reqs, log=None)
    assert not eng.prefix_cache
    assert eng.prefix_hits == eng.pages_shared == eng.kv.cow_copies == 0
    al = eng.kv.allocator
    assert al.free_pages == al.num_pages and al.cached_pages == 0
    assert reqs[0].out == reqs[1].out


ENGINE_CASES = {"swap-round-trip": _swap_round_trip,
                "donor-unperturbed": _donor_unperturbed,
                "map-survives-retirement": _map_survives_retirement,
                "full-hit-minimal-pool-cold": _full_hit_minimal_pool,
                "cache-off-never-shares": _cache_off_never_shares}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_prefix_and_swap_engine_cases(case):
    """The reference's engine-level prefix-cache and swap cases
    (tests/test_prefix_caching.py, tests/test_chunked_prefill.py), on
    the port's smoke phi3-mini (fp8 cache)."""
    ENGINE_CASES[case]()


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
                  chunk_tokens=CHUNK, spec_decode=True,
                  draft=DRAFTS[run["draft"]](dict(enumerate(truth))),
                  spec_k=run["k"])
    assert eng.spec
    eng.run(reqs, log=None)
    return {"streams": [r.out for r in reqs],
            "verify_steps": eng.stats()["spec_verify_steps"]}


def _reference_serve(cfg, params, run, prompts, slots=SLOTS):
    """Serve ``prompts`` (or the run's waves) through the reference's
    Engine (or its legacy Server); returns the streams and, per
    generated token, the gap between the top two logits it was sampled
    from and the largest |logit|; for a ``ticks`` run also the engine's
    counters, and for a baseline recipe its calibrated activation
    scales (as f32 bit patterns)."""
    from repro.launch.serve import Server as JServer
    from repro.serving import Engine as JEngine, Request as JRequest

    from repro.serving.scheduler import SLOTargets as JSLOTargets

    reqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    gaps = {}
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
            gaps.setdefault(req.rid, []).append(
                [float(top[-1] - top[-2]), float(np.abs(row).max())])
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
        slo = JSLOTargets(**PINNED) if (run.get("pinned")
                                        or run.get("ticks")) else None
        if run.get("ticks"):
            from repro.obs.metrics import get_registry as jregistry
            from repro.obs.trace import get_tracer as jtracer

            jregistry().reset()
            jtracer().enable().clear()
        eng = JEngine(cfg, params, num_slots=slots, chunk_tokens=CHUNK,
                      slo=slo, **_engine_kw(run))

        def decode_rows():
            rows = list(eng.kv.rows)
            # read before the chunk step advances it
            pos = eng._staging.pos if eng._staging is not None else 0

            def row_of(req, lg):
                if lg.shape[1] == 1:             # batched decode step
                    return lg[rows.index(req.rid), 0]
                # the last chunk of a prompt (a prefix hit's starts
                # at its suffix)
                return lg[0, req.prompt_len - 1 - pos]
            return row_of

        eng._run_decode = capture(eng._run_decode, decode_rows)
        eng._run_prefill = capture(eng._run_prefill, lambda: first)
        eng.sched.on_token = record(eng.sched.on_token)
        reqs = _serve_waves(eng, run, JRequest)
        out = {}
        if run.get("ticks"):
            st = eng.stats()
            out["counters"] = {k: st[k] for k in COUNTERS}
            out["obs"] = _obs_record(jregistry().snapshot(),
                                     jtracer().events())
            jtracer().disable().clear()
            if "quant_health" in st:
                out["quant_health"] = st["quant_health"]
                out["health_steps"] = eng.qh.steps
        if "quant" in run:
            out["act_scales"] = {
                tag: [np.asarray(a.s, np.float32).view(np.int32)
                      .reshape(-1).tolist(),
                      None if a.sub is None else np.asarray(a.sub).tolist()]
                for tag, a in eng.act_scales.items()}
        return {"streams": [r.out for r in reqs],
                "gaps": [gaps[r.rid] for r in reqs], **out}
    return {"streams": [r.out for r in reqs],
            "gaps": [gaps[r.rid] for r in reqs]}


# the switches a reference step reads while it is traced
TRACED_SWITCHES = ("REPRO_SERVE_PREQUANT", "REPRO_SERVE_DELAYED_ACT",
                   "REPRO_DECODE_ATTN", "REPRO_KV_CACHE")


def _share_steps():
    """In the child: the reference's engines and Server build their
    steps through one cache, keyed by the config, the builder's
    positional arguments and the switches read at trace time, so that
    engines of one config share one jitted function per step and
    compile each input shape once, not once per engine.  Every run's
    weights come from ``SEED``, so their build-time scales, which the
    steps close over, are equal within a key (the quant-health variant
    of a step is a key of its own)."""
    import repro.launch.serve as jserve
    import repro.serving.engine as jengine

    if getattr(jengine, "_steps_shared", False):
        return                    # already shared in this process
    jengine._steps_shared = True
    built = {}

    def shared(name, make):
        def build(cfg, *args, **kw):
            key = (name, cfg, args, kw.get("quant_health", False),
                   tuple(os.environ.get(k) for k in TRACED_SWITCHES))
            if key not in built:
                built[key] = make(cfg, *args, **kw)
            return built[key]
        return build

    for mod in (jengine, jserve):
        for name in ("make_prefill_step", "make_decode_step",
                     "make_verify_step"):
            if hasattr(mod, name):
                setattr(mod, name, shared(name, getattr(mod, name)))


def _reference_health_steps() -> dict:
    """``test_health_steps_match_reference``'s cases on the reference:
    each step's health tree (lists of f32 values)."""
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_get_config
    from repro.models.layers import init_tree
    from repro.models.transformer import model_defs
    from repro.serving.engine import calibrate_serving, prepare_weights
    from repro.train import steps as jsteps

    out = {}
    for case, (arch, kind) in sorted(HEALTH_CASES.items()):
        cfg = jax_get_config(arch, smoke=True)
        params = init_tree(model_defs(cfg), jax.random.PRNGKey(SEED))
        w, sc, _ = prepare_weights(cfg, params)
        act = calibrate_serving(cfg, w, sc)
        prompts, feed = _health_feed(kind)
        pre = jax.jit(jsteps.make_prefill_step(cfg, MAX_LEN, scales=sc,
                                               act_scales=act))
        make = (jsteps.make_decode_step if kind == "decode"
                else jsteps.make_verify_step)
        step = jax.jit(make(cfg, scales=sc, act_scales=act,
                            quant_health=True))
        _, caches = pre(w, {"tokens": jnp.asarray(prompts)})
        _, _, tree = step(w, caches, jnp.asarray(feed))
        out[case] = {tag: {k: np.asarray(v, np.float32).tolist()
                           for k, v in st.items()}
                     for tag, st in tree.items()}
    return out


def _reference_refresh() -> dict:
    """The reference Engine's ``refresh_act_scales(tokens=...)`` and its
    Server's (margin 1.5) on ``_refresh_tokens()``: f32 bit patterns of
    each site's ``s`` and its ``sub`` exponents."""
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_get_config
    from repro.launch.serve import Server as JServer
    from repro.models.layers import init_tree
    from repro.models.transformer import model_defs
    from repro.serving import Engine as JEngine

    cfg = jax_get_config(ARCH, smoke=True)
    params = init_tree(model_defs(cfg), jax.random.PRNGKey(SEED))
    toks = jnp.asarray(_refresh_tokens())
    acts = {"engine": JEngine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                              chunk_tokens=CHUNK).refresh_act_scales(
                                  tokens=toks),
            "server": JServer(cfg, params, batch_slots=SLOTS,
                              max_len=MAX_LEN).refresh_act_scales(
                                  tokens=toks, margin=1.5)}
    return {who: {tag: [np.asarray(a.s, np.float32).view(np.int32)
                        .reshape(-1).tolist(),
                        np.asarray(a.sub).reshape(-1).tolist()]
                  for tag, a in act.items()}
            for who, act in acts.items()}


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
    for k in SWITCHES:
        os.environ.pop(k, None)
    res["health_steps"] = _reference_health_steps()
    res["refresh"] = _reference_refresh()
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
