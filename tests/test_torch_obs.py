"""The port's observability (``repro_torch.obs``) against the
reference's (``repro.obs``), in this process: the metrics registry and
the tracer (the standard library only, in both packages), the
quant-health arithmetic (``quant_excursions``, ``effective_group_scales``,
``site_stats`` against the reference jitted, ``HealthAggregator``), and
the port's own contracts: quant-health off and tracing add no device
operation (a ``TorchDispatchMode`` log of the aten ops), the engine
samples the calls its countdown predicts, a ``TaggedScale`` keeps its
tag through the per-layer and per-expert splits, the CLIs write their
metrics and spans, and ``REPRO_KV_CACHE=bf16`` pools (scales None) swap,
share and serve through the legacy ``Server``.

The engine-level comparisons with the reference (the health report, the
span sequence and the published series, the health steps' trees,
``refresh_act_scales``) take their reference values from
tests/test_torch_serving.py's child process.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.obs import metrics as jmetrics
from repro.obs import quant_health as jqh
from repro.obs import trace as jtrace
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import quant_health as tqh
from repro_torch.obs import trace as ttrace

import test_torch_train  # noqa: F401  (one PyTorch thread, as the run)

ARCH = "phi3-mini-3.8b"


# --- the metrics registry and the tracer ---------------------------------


def _drive_registry(mod):
    """The same sequence of operations on a fresh ``mod.Registry``."""
    reg = mod.Registry()
    c = reg.counter("engine_prefill_calls_total", help="prefills")
    c.inc()
    c.inc(2.5, labels={"site": "blocks/attn/wq"})
    c.set_total(7.0)
    c.set_total(3.0)                         # a lower total is ignored
    reg.counter("engine_prefill_calls_total").inc(0.5)
    g = reg.gauge("pages_in_use")
    g.set(12)
    g.set(float("nan"), labels={"pool": "b"})
    g.set(float("inf"), labels={"pool": "c"})
    h = reg.histogram("sched_ttft_seconds", help="ttft")
    for v in (0.0005, 0.003, 0.2, 7.0, 100.0, float("nan")):
        h.observe(v)
    r = reg.histogram("quant_health_saturation_rate",
                      buckets=mod.RATE_BUCKETS)
    for v in (0.0, 2e-6, 0.3, 1.0):
        r.observe(v, labels={"site": "blocks/ffn/w_down"})
    d = reg.histogram("quant_health_drift_ratio", buckets=mod.DRIFT_BUCKETS)
    d.observe(0.8, labels={"site": "embed/head"})
    d.observe(3.0, labels={"site": "embed/head", "layer": 1})
    errors = []
    for bad in (lambda: reg.counter("pages_in_use"),
                lambda: c.inc(-1.0),
                lambda: reg.histogram("bad", buckets=(1.0, 0.5)),
                lambda: reg.histogram("bad2", buckets=(1.0, 1.0))):
        try:
            bad()
            errors.append(None)
        except (TypeError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    return reg, errors


def test_registry_exports_match_reference():
    """The same operations on the reference's and the port's Registry:
    identical ``snapshot()``, ``to_json()``, ``to_prometheus()`` (NaN
    and inf as null, cumulative buckets, labels sorted) and errors."""
    assert tmetrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S
    assert tmetrics.RATE_BUCKETS == jmetrics.RATE_BUCKETS
    assert tmetrics.DRIFT_BUCKETS == jmetrics.DRIFT_BUCKETS
    (jr, jerr), (tr, terr) = _drive_registry(jmetrics), _drive_registry(
        tmetrics)
    assert terr == jerr and all(e is not None for e in terr)
    assert tr.snapshot() == jr.snapshot()
    assert tr.to_json(indent=2) == jr.to_json(indent=2)
    assert tr.to_prometheus() == jr.to_prometheus()
    assert json.loads(tr.to_json())["pages_in_use"]["series"][
        '{pool="b"}'] is None
    tr.reset()
    assert tr.snapshot() == {} and tr.to_prometheus() == "\n"
    assert isinstance(tmetrics.get_registry(), tmetrics.Registry)


def _drive_tracer(mod, capacity):
    tr = mod.Tracer(capacity=capacity)
    with tr.span("off"):
        pass
    tr.instant("off")
    assert len(tr) == 0 and tr.span("x") is tr.span("y")   # the null CM
    tr.enable()
    for i in range(4):
        with tr.span("engine.step", rows=i):
            with tr.span("decode"):
                pass
    tr.instant("preempt", rid=3, depth=17)
    tr.enable(capacity=capacity + 2)        # keeps the buffered events
    with tr.span("retire"):
        pass
    return tr


@pytest.mark.parametrize("capacity", [3, 64])
def test_tracer_events_and_ring_buffer_match_reference(capacity, tmp_path):
    """The same spans and instants on both Tracers: the same events
    (name, phase, args, scope; the ring buffer keeps the last
    ``capacity``, and keeps them through a resize to ``capacity + 2``), the same
    keys, and ``save()`` writes them as a JSON array."""
    jt, tt = _drive_tracer(jtrace, capacity), _drive_tracer(ttrace, capacity)

    def shape(events):
        return [(sorted(e), e["name"], e["ph"], e.get("args"), e.get("s"))
                for e in events]

    assert shape(tt.events()) == shape(jt.events())
    assert len(tt) == len(jt) == min(capacity, 9) + 1
    for e in tt.events():
        assert e["dur"] >= 0 if e["ph"] == "X" else e["s"] == "t"
    path = tt.save(str(tmp_path / "t.json"))
    assert shape(json.loads(open(path).read())) == shape(jt.events())
    assert ttrace.Tracer().save() is None
    tt.disable()
    with tt.span("after"):
        pass
    assert tt.events()[-1]["name"] == "retire"
    tt.clear()
    assert len(tt) == 0


@pytest.mark.parametrize("env", [{}, {"REPRO_TRACE": "t.json"},
                                 {"REPRO_TRACE": "t.json",
                                  "REPRO_TRACE_BUFFER": "5"},
                                 {"REPRO_TRACE_BUFFER": "x"}])
def test_get_tracer_reads_the_environment(monkeypatch, env):
    """The first ``get_tracer()`` reads ``REPRO_TRACE`` (on, with that
    path) and ``REPRO_TRACE_BUFFER`` (the ring's size; not an integer:
    the default), as the reference's."""
    for k in ("REPRO_TRACE", "REPRO_TRACE_BUFFER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for mod in (jtrace, ttrace):
        monkeypatch.setattr(mod, "_TRACER", None)
        monkeypatch.setattr(mod, "_ATEXIT_REGISTERED", True)  # no atexit
        tr = mod.get_tracer()
        assert mod.get_tracer() is tr and mod.trace_enabled() == tr.enabled
        got.append((tr.enabled, tr.path, tr._events.maxlen))
    assert got[0] == got[1]
    assert got[1][0] == ("REPRO_TRACE" in env)


# --- the quant-health arithmetic ----------------------------------------


def _excursion_case(case):
    """(|x|, per-group scale) of a few quantization groups: ordinary,
    zero and negative scales, a saturating group, exact ties at the
    underflow threshold."""
    rng = np.random.default_rng(sum(map(ord, case)))
    x = np.abs(rng.standard_normal((6, 5, 32)).astype(np.float32)) * 3
    x[0, 0, :5] = 0
    s = rng.uniform(0.001, 0.02, (1, 5, 1)).astype(np.float32)
    if case in ("zero-negative", "all"):
        s[0, 1, 0], s[0, 2, 0] = 0.0, -0.01
    if case in ("saturating", "all"):
        x[:, 3] *= 1e4
    if case in ("ties", "all"):
        x[1, 4, :4] = s[0, 4, 0] * np.float32(2.0 ** -10)    # e4m3 tie
        x[2, 4, :4] = s[0, 4, 0] * np.float32(2.0 ** -17)    # e5m2 tie
        x[3, 4, :4] = s[0, 4, 0] * np.float32(2.0 ** -9)
    return x, s


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("case", ["plain", "zero-negative", "saturating",
                                  "ties", "all"])
def test_quant_excursions_match_reference(fmt, case):
    from repro.core.quant import quant_excursions as jqe
    from repro_torch.core.quant import quant_excursions as tqe

    x, s = _excursion_case(case)
    want = [np.float32(v) for v in jax.jit(
        lambda a, b: jqe(a, b, fmt))(jnp.asarray(x), jnp.asarray(s))]
    got = [v.numpy() for v in tqe(torch.from_numpy(x), torch.from_numpy(s),
                                  fmt)]
    assert all(g.dtype == np.float32 and g.shape == () for g in got)
    assert got == want, (got, want)
    if case == "saturating":
        assert want[0] > 0


def _act_scale(mode, k, rng, jmod, tmod):
    """The same ActScale in both packages for a site of inner dim k."""
    if mode == "moss":
        s = np.float32(rng.uniform(0.01, 0.1))
        sub = rng.integers(-8, 1, -(-k // 32)).astype(np.int8)
        return (jmod(jnp.asarray(s), jnp.asarray(sub)),
                tmod(torch.tensor(s), torch.from_numpy(sub)))
    if mode == "per_group":
        s = rng.uniform(0.001, 0.05, -(-k // 128)).astype(np.float32)
        if len(s) > 1:
            s[-1] = 0.0                        # a zero group scale
        return jmod(jnp.asarray(s)), tmod(torch.from_numpy(s))
    s = np.float32(rng.uniform(0.005, 0.05))
    return jmod(jnp.asarray(s)), tmod(torch.tensor(s))


@pytest.mark.parametrize("mode", ["moss", "per_group", "per_tensor"])
@pytest.mark.parametrize("k", [96, 100, 256, 300])
def test_site_stats_match_reference(mode, k):
    """``site_stats`` (and ``effective_group_scales`` under it) on seeded
    bf16 activations, K a multiple of the group or not, a saturating
    column and zeros: the counts equal and ``amax`` and ``drift`` bit for
    bit the reference's jitted (the ActScale an argument: XLA turns the
    division by the fp8 max into a product with its f32 reciprocal)."""
    from repro.core.actscale import ActScale as JA
    from repro.core.actscale import effective_group_scales as jegs
    from repro.core.formats import QuantConfig as JQ
    from repro_torch.core.actscale import ActScale as TA
    from repro_torch.core.actscale import effective_group_scales as tegs
    from repro_torch.core.formats import QuantConfig as TQ

    rng = np.random.default_rng(k + len(mode))
    x = (rng.standard_normal((7, k)) * rng.uniform(0.1, 30, k)).astype(
        np.float32)
    x[0, :9] = 0
    x[:, 5] *= 300                               # saturates its group
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ja, ta = _act_scale(mode, k, rng, JA, TA)
    jc, tc = JQ(mode=mode), TQ(mode=mode)
    jsg, jg = jegs(ja, jc, k)
    tsg, tg = tegs(ta, tc, k)
    assert tg == jg and np.array_equal(tsg.numpy(), np.asarray(jsg))
    want = jax.jit(lambda v, a: jqh.site_stats(v, a, jc))(xb, ja)
    got = tqh.site_stats(xt, ta, tc)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        v, g = np.asarray(v, np.float32), got[key].numpy()
        assert g.dtype == np.float32 and g.shape == v.shape == ()
        assert g.view(np.int32) == v.view(np.int32), (key, g, v)
    assert got["sat"] > 0 and got["n"] == 7 * k


def _health_tree(rng, layers=True):
    """A step's tree of two stacked sites and the head, numpy."""
    def site(shape):
        n = np.full(shape, 4096, np.float32)
        return {"n": n, "sat": rng.integers(0, 3, shape).astype(np.float32),
                "underflow": rng.integers(0, 40, shape).astype(np.float32),
                "nonzero": n - rng.integers(0, 9, shape).astype(np.float32),
                "amax": rng.uniform(1, 30, shape).astype(np.float32),
                "drift": rng.uniform(0.3, 1.2, shape).astype(np.float32)}
    tree = {"embed/head": site(())}
    if layers:
        tree.update({"blocks/attn/wq": site((3,)),
                     "blocks/ffn/w_down": site((3,))})
    return tree


def test_health_aggregator_matches_reference():
    """The same trees through both packages' aggregators (the port's fed
    tensors, the reference's numpy): equal ``report()``, flag and
    registry snapshot; an empty tree counts no step."""
    rng = np.random.default_rng(4)
    trees = [_health_tree(rng), _health_tree(rng, layers=False),
             _health_tree(rng)]
    jr, tr = jmetrics.Registry(), tmetrics.Registry()
    ja = jqh.HealthAggregator(registry=jr)
    ta = tqh.HealthAggregator(registry=tr)
    assert tr.snapshot() == jr.snapshot()
    for t in trees + [{}]:
        ja.ingest(t)
        ta.ingest({tag: {k: torch.from_numpy(np.asarray(v))
                         for k, v in st.items()}
                   for tag, st in t.items()})
        assert ta.report() == ja.report()
        assert ta.refresh_recommended == ja.refresh_recommended
    assert ta.steps == ja.steps == 3 and ta.refresh_recommended
    assert tr.snapshot() == jr.snapshot()
    assert tqh.DRIFT_THRESHOLD == jqh.DRIFT_THRESHOLD == 1.0


def test_tagged_scale_keeps_its_tag_through_the_splits():
    """``split_act``: a TaggedScale over (L, E) scales splits per layer
    (``transformer._layers``) and then per expert (``moe._experts``)
    into TaggedScales of the same tag on the slices; an ActScale splits
    as before; a tag string and None repeat."""
    from repro_torch.core.actscale import ActScale, split_act
    from repro_torch.core.linear import QT
    from repro_torch.models.moe import _experts
    from repro_torch.models.transformer import _layers

    s = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    sub = torch.arange(24, dtype=torch.int8).reshape(2, 3, 4)
    tagged = tqh.tag_act_scales({"blocks/moe/w_up": ActScale(s, sub)})
    w = torch.zeros(2, 3, 8, 16)
    per_layer = _layers({"w_up": QT(w, None, tagged["blocks/moe/w_up"])}, 2)
    for l, p in enumerate(per_layer):
        a = p["w_up"].a
        assert isinstance(a, tqh.TaggedScale) and a.tag == "blocks/moe/w_up"
        assert torch.equal(a.scale.s, s[l]) and torch.equal(a.scale.sub,
                                                             sub[l])
        for e, qt in enumerate(_experts(p["w_up"])):
            assert qt.a.tag == "blocks/moe/w_up"
            assert torch.equal(qt.a.scale.s, s[l, e])
            assert torch.equal(qt.a.scale.sub, sub[l, e])
    assert split_act("blocks/attn/wq", 2) == ["blocks/attn/wq"] * 2
    assert split_act(None, 3) == [None] * 3
    with pytest.raises(TypeError):
        split_act(1.0, 2)


def test_expert_sites_record_nothing_in_a_capture():
    """Inside a capture window the MoE's experts (one at a time, the
    reference's ``jax.vmap``) record nothing; other sites do."""
    QH = tqh.QH
    with QH.capture() as cap:
        QH.record("a", torch.ones(2, 32), _moss_scale(), _moss_cfg())
        with QH.unrecorded():
            QH.record("b", torch.ones(2, 32), _moss_scale(), _moss_cfg())
        assert QH.tracing
    assert sorted(cap.tree) == ["a"] and not QH.tracing
    QH.record("c", torch.ones(2, 32), _moss_scale(), _moss_cfg())
    assert QH.drain_layer() is None


def _moss_scale():
    from repro_torch.core.actscale import ActScale

    return ActScale(torch.tensor(0.01), torch.zeros(1, dtype=torch.int8))


def _moss_cfg():
    from repro_torch.core.formats import QuantConfig

    return QuantConfig(mode="moss")


# --- the engine: off is free, the countdown, the CLIs --------------------


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched inside the mode, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _smoke_engine(**kw):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import random_params
    from repro_torch.serving import Engine

    cfg = get_config(ARCH, smoke=True)
    return Engine(cfg, random_params(cfg, 0, "cpu"), num_slots=2,
                  max_len=48, chunk_tokens=16, device="cpu", **kw)


def _decode_ops(eng, run):
    """The aten ops of one (2, 1) decode step through ``run`` (the
    engine's step or a shim) on caches a prefill of two prompts made."""
    from repro_torch.models.transformer import init_caches
    from repro_torch.serving.paged_cache import write_row

    rng = np.random.default_rng(2)
    caches = init_caches(eng.cfg, 2, eng.max_len, per_slot=True,
                         device="cpu")
    for i, n in enumerate((7, 12)):
        prompt = torch.from_numpy(rng.integers(0, 512, (1, n)).astype(
            np.int32))
        _, one = eng.prefill(eng.params, prompt)
        write_row(caches, one, i, n)
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    with _OpLog() as log:
        logits, _ = run(eng.params, caches, toks)
    return log.ops, logits


def test_health_off_and_tracing_add_no_device_op(monkeypatch):
    """The aten ops of a decode step of a health-off engine are the same
    before and after an engine with quant-health on built and ran its
    instrumented step, and are the ops of that engine's unsampled
    calls; a sampled call adds ops.  A whole serving run issues the same
    ops with a tracer enabled as without."""
    monkeypatch.setattr(tmetrics, "_REGISTRY", tmetrics.Registry())
    off = _smoke_engine()
    before, want = _decode_ops(off, off.decode)
    monkeypatch.setenv("REPRO_QUANT_HEALTH", "1")
    monkeypatch.setenv("REPRO_QUANT_HEALTH_EVERY", "1")
    on = _smoke_engine()
    sampled, got = _decode_ops(on, on._run_decode)    # the first call
    assert on.qh.steps == 1 and torch.equal(got, want)
    unsampled, got = _decode_ops(on, on._run_decode)
    assert on.qh.steps == 1 and torch.equal(got, want)
    assert unsampled == before
    assert len(sampled) > len(before)
    monkeypatch.delenv("REPRO_QUANT_HEALTH")
    after, _ = _decode_ops(off, off.decode)
    assert after == before

    from repro_torch.serving import Request

    def run_ops(tracer):
        monkeypatch.setattr(ttrace, "_TRACER", tracer)
        eng = _smoke_engine()
        eng.sched.clock = _ticks()
        reqs = [Request(rid=i, prompt=np.arange(5 + 7 * i, dtype=np.int32),
                        max_new=4) for i in range(3)]
        with _OpLog() as log:
            eng.run(reqs, log=None)
        return log.ops, [r.out for r in reqs]

    plain = run_ops(ttrace.Tracer())
    tracer = ttrace.Tracer().enable()
    traced = run_ops(tracer)
    assert traced == plain
    assert sum(e["name"] == "engine.step" for e in tracer.events()) > 0


def _ticks():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


@pytest.mark.parametrize("every", [1, 3])
def test_engine_samples_the_calls_its_countdown_predicts(monkeypatch,
                                                         every):
    """With ``REPRO_QUANT_HEALTH_EVERY=N`` the first call of each
    (step, token shape) runs the instrumented step, then every N+1-th
    call of that shape; every sampled tree reaches the aggregator, and
    the streams are those of the health-off engine."""
    from repro_torch.serving import Request

    monkeypatch.setattr(tmetrics, "_REGISTRY", tmetrics.Registry())

    def serve():
        eng = _smoke_engine()
        eng.sched.clock = _ticks()
        calls = []
        if eng.health:
            for kind in ("decode",):
                plain, inst = (getattr(eng, kind),
                               getattr(eng, kind + "_h"))

                def wrap(fn, sampled):
                    def step(params, caches, toks):
                        calls.append((tuple(toks.shape), sampled))
                        return fn(params, caches, toks)
                    return step

                setattr(eng, kind, wrap(plain, False))
                setattr(eng, kind + "_h", wrap(inst, True))
        reqs = [Request(rid=i, prompt=np.arange(3 + 9 * i, dtype=np.int32),
                        max_new=6) for i in range(4)]
        eng.run(reqs, log=None)
        return eng, calls, [r.out for r in reqs]

    _, _, want = serve()
    monkeypatch.setenv("REPRO_QUANT_HEALTH", "1")
    monkeypatch.setenv("REPRO_QUANT_HEALTH_EVERY", str(every))
    eng, calls, got = serve()
    assert got == want and eng.health_every == every
    seen = {}
    for shape, sampled in calls:
        i = seen.get(shape, 0)
        assert sampled == (i % (every + 1) == 0), (shape, i, calls)
        seen[shape] = i + 1
    assert eng.qh.steps == sum(s for _, s in calls) > 1
    st = eng.stats()["quant_health"]
    assert set(st["sites"]) >= {"blocks/attn/wq", "blocks/ffn/w_down"}


def test_serve_cli_writes_metrics_and_trace(monkeypatch, tmp_path, capsys):
    """``--metrics-out`` and ``--trace-out`` on the CPU smoke engine with
    quant-health on: both files parse, the trace has one ``engine.step``
    span a step with its phases, the metrics the ``engine_*``,
    ``sched_*``, ``pages_*`` and ``quant_health_*`` series, and the CLI
    prints its quant-health line."""
    from repro_torch.launch import serve

    monkeypatch.setattr(tmetrics, "_REGISTRY", tmetrics.Registry())
    monkeypatch.setattr(ttrace, "_TRACER", ttrace.Tracer())
    monkeypatch.setenv("REPRO_QUANT_HEALTH", "1")
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    steps = []
    real_step = serve.Engine.step

    def step(self):
        steps.append(1)
        return real_step(self)

    monkeypatch.setattr(serve.Engine, "step", step)
    eng = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                      "--max-new", "4", "--metrics-out", str(m),
                      "--trace-out", str(t)])
    out = capsys.readouterr().out
    events = json.loads(t.read_text())
    names = [e["name"] for e in events]
    assert names.count("engine.step") == len(steps) > 0
    assert {"retire", "swap_in", "chunk_phase", "decode"} <= set(names)
    snap = json.loads(m.read_text())
    for name in ("engine_chunk_prefill_steps_total",
                 "sched_tokens_generated_total", "sched_ttft_seconds",
                 "pages_total", "quant_health_drift_ratio",
                 "quant_health_refresh_recommended"):
        assert name in snap, name
    assert snap["sched_tokens_generated_total"]["series"][""] == 16
    assert f"quant health: {len(eng.qh.report())} sites" in out
    assert "trace: " in out and "metrics: " in out


def test_train_cli_spans_its_data_and_steps(monkeypatch):
    """The training CLI's ``train.data`` and ``train.step`` spans, one
    each a step with the step's index; none with tracing off."""
    from repro_torch.launch.train import train

    tracer = ttrace.Tracer()
    monkeypatch.setattr(ttrace, "_TRACER", tracer)
    train("olmo-7b", steps=1, batch=2, seq=16, device="cpu",
          log=lambda *a: None)
    assert tracer.events() == []
    tracer.enable()
    train("olmo-7b", steps=2, batch=2, seq=16, device="cpu",
          log=lambda *a: None)
    assert [(e["name"], e["args"]) for e in tracer.events()] == [
        ("train.data", {"step": 0}), ("train.step", {"step": 0}),
        ("train.data", {"step": 1}), ("train.step", {"step": 1})]


def test_serve_batched_twin_writes_metrics_and_trace(monkeypatch, tmp_path,
                                                     capsys):
    import importlib.util
    from pathlib import Path

    monkeypatch.setattr(tmetrics, "_REGISTRY", tmetrics.Registry())
    monkeypatch.setattr(ttrace, "_TRACER", ttrace.Tracer())
    path = Path(__file__).resolve().parent.parent / "examples" / \
        "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    s = mod.main(["--device", "cpu", "--metrics-out", str(m),
                  "--trace-out", str(t)])
    snap = json.loads(m.read_text())
    assert snap["engine_prefix_hits_total"]["series"][""] == \
        s["prefix_hits"] == 5
    assert sum(e["name"] == "engine.step"
               for e in json.loads(t.read_text())) > 0
    assert "kv cache: fp8" in capsys.readouterr().out


# --- REPRO_KV_CACHE=bf16: pools and rows whose scales are None ------------


def test_bf16_override_pools_swap_share_and_serve(monkeypatch):
    """Under ``REPRO_KV_CACHE=bf16`` the smoke phi3-mini's pool is bf16
    (scales None): a swap round trip restores the victim's pages bit for
    bit, a full prefix hit copies a page on write and gives the cold
    stream, a preempting pool gives the fully backed pool's streams,
    and the legacy Server's contiguous rows are bf16; the engine's and
    the Server's streams equal those of the config's own
    ``kv_cache_dtype="bf16"``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import Server, random_params
    from repro_torch.models.attention import _bytes, resolve_kv_cache_dtype
    from repro_torch.serving import Engine, Request
    from repro_torch.serving.paged_cache import _leaves

    monkeypatch.setattr(tmetrics, "_REGISTRY", tmetrics.Registry())
    monkeypatch.setenv("REPRO_KV_CACHE", "bf16")
    cfg = get_config(ARCH, smoke=True)
    assert cfg.kv_cache_dtype == "fp8" and resolve_kv_cache_dtype(cfg) == \
        "bf16"
    params = random_params(cfg, 0, "cpu")

    def engine(c=cfg, **kw):
        return Engine(c, params, num_slots=2, max_len=64, chunk_tokens=8,
                      device="cpu", **kw)

    # swap round trip
    eng = engine()
    pool = eng.kv.caches["blocks"]
    assert pool.k.dtype == torch.bfloat16 and pool.k_scale is None
    req = Request(rid=0, prompt=np.arange(21, dtype=np.int32), max_new=8)
    eng.submit([req])
    for _ in range(4):
        eng.step()
    pages = list(eng.kv.allocator.table(0).pages)
    snap = lambda ps: [_bytes(b)[:, ps].clone()
                       for p in eng.kv.caches.values() for b in _leaves(p)]
    before = snap(pages)
    assert len(before) == 2                       # k and v, no scales
    bundle = eng.kv.swap_out(eng.kv.rows.index(0))
    eng.kv.swap_in(bundle, req.prompt_len + req.max_new - 1)
    after = snap(list(eng.kv.allocator.table(0).pages))
    assert all(torch.equal(a, b) for a, b in zip(before, after))

    # a full prefix hit: copy-on-write, the cold stream
    prompt = (np.arange(32, dtype=np.int32) * 7) % 500
    first, second = (Request(rid=i, prompt=prompt, max_new=4)
                     for i in range(2))
    eng = engine()
    eng.run([first], log=None)
    eng.run([second], log=None)
    assert eng.prefix_hits == 1 and eng.kv.cow_copies == 1
    assert second.out == first.out

    # a preempting pool, the fully backed pool, the config's bf16, Server
    def wave(**kw):
        e = engine(**kw)
        reqs = [Request(rid=i, prompt=np.arange(12, dtype=np.int32) + i,
                        max_new=40) for i in range(4)]
        e.sched.clock = _ticks()
        e.run(reqs, log=None)
        return e, [r.out for r in reqs]

    small, got = wave(num_pages=6)
    full, want = wave()
    assert small.preemptions > 0 and small.swap_ins == small.preemptions
    assert got == want
    monkeypatch.delenv("REPRO_KV_CACHE")
    _, own = wave(c=cfg.replace(kv_cache_dtype="bf16"))
    assert own == want
    def server(c):
        srv = Server(c, params, batch_slots=2, max_len=64, device="cpu")
        reqs = [Request(rid=i, prompt=np.arange(12, dtype=np.int32) + i,
                        max_new=40) for i in range(4)]
        srv.run(reqs, log=None)
        return srv, [r.out for r in reqs]

    srv_own = server(cfg.replace(kv_cache_dtype="bf16"))[1]
    monkeypatch.setenv("REPRO_KV_CACHE", "bf16")
    srv, srv_env = server(cfg)
    assert srv.caches["blocks"].k.dtype == torch.bfloat16
    assert srv.caches["blocks"].k_scale is None
    assert srv_env == srv_own
