"""Six more families of the port against the reference, on the CPU:
stablelm-12b (LayerNorm, qk-norm, 25% partial rotary, d_head 32 in its
smoke config), minitron-8b (squared ReLU, a non-gated FFN, 50% partial
rotary), recurrentgemma-2b (the hybrid: griffin units of two RG-LRU
blocks and one local-attention block, GeGLU, a tied embedding with a
sqrt(d) scale, a logit softcap of 30; 6 layers in its smoke config),
rwkv6-3b (attention-free: the time mix's chunked WKV and the
squared-ReLU channel mix), musicgen-medium (embeddings input,
sinusoidal positions, LayerNorm, a GELU MLP) and phi-3-vision-4.2b
(embeddings input, the phi3-mini backbone), each on its
``SMOKE_CONFIG`` with the reference's weights from ``PRNGKey(0)``.  The
embeddings models' inputs are made from a numpy seed and carried to
both packages (``_model_input``, ``_stub``).

The reference's side comes from the shared child of
tests/test_torch_train.py (``archs_parts``, compiled with its
``REFERENCE_XLA_FLAGS``; the serving runs through the reference's own
Engine and legacy Server under the child's ``ENGINE_LOCK``), the unit
tests' values too (tests/test_torch_rwkv.py's among them).

Limits, with their reasons (the values measured on a CPU are in each
test):

- pre-quantized payloads, scales (the transposed tied head
  ``embed/head_t`` among them) and calibrated activation scales:
  bitwise;
- the whole forward: within 1e-2 * max|logit| (one bf16 rounding of a
  LayerNorm output, where the reference's rsqrt lands a bit off the
  correctly rounded value once in ~10^6 outputs, is carried through the
  layers after it; rwkv6's WKV sums in another order);
- train steps: tests/test_torch_train.py's limits (``check_train_steps``);
- serving: equal greedy streams, except past a reference tie
  (tests/test_torch_serving.py's rule); both packages' engines refuse
  the embeddings models;
- the units (qk-norm, the tanh GELU, the sqrt(d) embedding scale, the
  softcap, the causal conv, the RG-LRU scan): bitwise, as the port
  follows the reference's CPU arithmetic (``core.xla_cpu_numerics``:
  XLA's tanh and exp, and its FMA contraction of the GELU's inner
  polynomial and of the scan's products and sums), except the scan
  against its own one-token updates, within 1e-6 relative (another
  order of the same f32 products), and the RG-LRU block's f32 states,
  within 1e-6 relative (XLA's ``log1p`` is not reproduced).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtr
from repro.models.layers import init_tree as jinit_tree
from repro.models.layers import quant_mask_tree as jquant_mask_tree
from repro.models.layers import wrap_qt_nojit as jwrap_qt_nojit
from repro.train import steps as jsteps

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config
from repro_torch.core.formats import QuantConfig
from repro_torch.launch.serve import Server
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import quant_mask_tree, wrap_qt_nojit
from repro_torch.serving import Engine, Request
from repro_torch.train import steps as tsteps

from test_torch_recipes import _same
from test_torch_serving import (
    CHUNK,
    MAX_LEN,
    MAX_NEW,
    SLOTS,
    _assert_streams,
    _prompts,
)
from test_torch_train import (
    _leaf_items,
    check_train_steps,
    shared_reference,
)

ARCHS = ("stablelm-12b", "minitron-8b", "recurrentgemma-2b", "rwkv6-3b",
         "musicgen-medium", "phi-3-vision-4.2b")
HYBRID = "recurrentgemma-2b"
RWKV = "rwkv6-3b"
TOKENS = np.random.default_rng(2).integers(0, 512, (2, 40)).astype(np.int32)
# each family through the engine (floating pages and chunked prefill for
# stablelm and minitron; identity rows and the exact-length whole-prompt
# prefill for the hybrid and rwkv6; the embeddings models are refused)
# and the legacy Server
SERVE_RUNS = ("engine", "server")


def _x(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return np.asarray(x, np.float32)


def _embeddings(cfg) -> bool:
    return cfg.input_mode == "embeddings"


def _model_input(cfg) -> np.ndarray:
    """The forward tests' input: TOKENS, or for an embeddings model f32
    embeddings (2, 40, d) from a numpy seed, which both packages take in
    bf16."""
    return _x((*TOKENS.shape, cfg.d_model), 8) if _embeddings(cfg) else TOKENS


def _stub(cfg, tokens) -> np.ndarray:
    """The training frontend stub's embeddings of ``tokens``, made with
    numpy (a (vocab, d) table from seed 1234, times 0.02), so that both
    packages train on the same ones."""
    return _x((cfg.vocab, cfg.d_model), 1234, 0.02)[tokens]


def _serve_prompts(cfg) -> list:
    """tests/test_torch_serving.py's prompts, within the vocabulary
    (musicgen's is 128)."""
    return [p % cfg.vocab for p in _prompts()]


# --- the reference, in the shared child of tests/test_torch_train.py ---------

def _arch_reference(arch) -> dict:
    from repro.core.actscale import calibrate_act_scales as jcalibrate

    from test_torch_serving import _reference_serve, _share_steps
    from test_torch_train import ENGINE_LOCK

    jcfg = jax_get_config(arch, smoke=True)
    params = jinit_tree(jtr.model_defs(jcfg), jax.random.PRNGKey(0))
    out = {"params": jax.tree.map(np.asarray, params), "forward": {}}
    for mode in ("moss", "bf16"):
        cfg = jcfg.replace(quant=type(jcfg.quant)(mode=mode))
        mask = jquant_mask_tree(jtr.model_defs(cfg))
        key = "embeds" if _embeddings(cfg) else "tokens"
        fwd = jax.jit(lambda p, t, cfg=cfg, mask=mask, key=key: jtr.forward(
            cfg, cfg.quant, jwrap_qt_nojit(p, mask), {key: t},
            mode="train")[0])
        out["forward"][mode] = np.asarray(fwd(params, _model_input(cfg)),
                                          np.float32)
    pq = jsteps.prequantize_params(jcfg, params)
    act = jcalibrate(jcfg, pq.qweights, pq.scales)
    out["build"] = {"qweights": jax.tree.map(np.asarray, pq.qweights),
                    "scales": jax.tree.map(np.asarray, pq.scales),
                    "act": {t: (np.asarray(a.s), np.asarray(a.sub))
                            for t, a in act.items()}}
    out["train"] = _reference_train_step(arch)
    out["serve"] = {}
    with ENGINE_LOCK.shared():
        _share_steps()
        for name in SERVE_RUNS:
            if name == "engine" and _embeddings(jcfg):
                continue                 # the engine refuses these models
            run = {"server": True} if name == "server" else {}
            out["serve"][name] = _reference_serve(jcfg, params, run,
                                                  _serve_prompts(jcfg))
    return out


def _reference_train_step(arch) -> dict:
    """Per mode (moss, bf16): the reference's ``init_train_state`` (seed
    0) as the port's state turned to numpy, the first batch, and the
    reference's step from that state on it (its state and metrics), as
    numpy (in the child).  The port's step from the same state runs in
    the test (``_train_runs`` runs both in the child; here the child
    stays with what needs the reference's compiler flags)."""
    from test_torch_train import TRAIN_HP, _jax_state, recipe

    from repro.core.formats import QuantConfig as JQuantConfig
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticLM as JSyntheticLM

    jcfg0 = jax_get_config(arch, smoke=True)
    data = JSyntheticLM(JDataConfig(vocab=jcfg0.vocab, seq_len=64,
                                    global_batch=2, seed=0))
    batch = jax.tree.map(np.asarray, data.batch_for_step(0))
    if _embeddings(jcfg0):
        batch["embeds"] = _stub(jcfg0, batch["tokens"])
    out = {}
    for mode in ("moss", "bf16"):
        jcfg = jcfg0.replace(quant=JQuantConfig(**recipe(mode),
                                                rescale_interval=2))
        hp = jsteps.TrainHParams(**TRAIN_HP)
        init = jax.tree.map(np.asarray, jax.jit(
            jsteps.init_train_state, static_argnums=(0, 1))(
                jcfg, hp, jax.random.PRNGKey(0)))
        before = bridge.train_state_to_numpy(
            bridge.train_state_to_torch(init, device="cpu"))
        rs, rm = jax.jit(jsteps.make_train_step(jcfg, hp))(
            _jax_state(before), batch)
        out[mode] = (before, batch, jax.tree.map(np.asarray, rs),
                     {k: float(v) for k, v in rm.items()})
    return out


def archs_parts() -> dict:
    """The reference's side of this module's tests and of
    tests/test_torch_rwkv.py's, part by part (the shared child of
    tests/test_torch_train.py runs each in a thread of its own): the
    unit tests' values, and per family the smoke parameters, the
    forward in moss and bf16, the pre-quantized tree and its
    calibration, one train step in moss and in bf16, and the engine's
    (for the token models) and the Server's streams (under the child's
    ``ENGINE_LOCK``)."""
    from test_torch_rwkv import rwkv_units_reference

    return {"units": _units_reference, "rwkv_units": rwkv_units_reference,
            **{arch: functools.partial(_arch_reference, arch)
               for arch in ARCHS}}


def archs_reference() -> dict:
    """``archs_parts``' results, one after another."""
    return {k: fn() for k, fn in archs_parts().items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``archs_reference``'s results, from the child process that
    tests/test_torch_train.py and the other port modules share."""
    return shared_reference(tmp_path_factory)["archs"]


def _params(reference, arch):
    return bridge.tree_to_torch(reference[arch]["params"], device="cpu")


# --- the configs -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_defs_match_reference(arch):
    """Each config (full and smoke) has the reference's fields, and the
    model's parameter tree the reference's leaves, shapes and
    quantization mask (griffin units, ``tail_rec`` where n_layers % 3,
    q/k norms, non-gated FFNs, no ``head`` for a tied embedding)."""
    assert arch in registry.ARCHS
    for smoke in (False, True):
        j, t = jax_get_config(arch, smoke=smoke), get_config(arch,
                                                              smoke=smoke)
        for f in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
                  "head_dim", "attn_type", "window", "rope_pct", "qk_norm",
                  "logit_softcap", "act", "norm", "tie_embeddings",
                  "embed_scale", "lru_width", "conv_width", "family",
                  "rwkv_head_dim", "ddlerp_rank", "decay_rank", "input_mode",
                  "pos_embedding", "rope_theta", "norm_eps", "attn_chunk",
                  "remat", "kv_cache_dtype"):
            assert getattr(j, f) == getattr(t, f), (arch, smoke, f)
    for n_layers in (None, 5):
        jcfg, tcfg = jax_get_config(arch, True), get_config(arch, True)
        if n_layers is not None:
            if arch != HYBRID:
                continue
            jcfg, tcfg = (c.replace(n_layers=n_layers) for c in (jcfg, tcfg))
        jdefs = dict(_leaf_items(jax.tree.map(
            lambda d: (tuple(d.shape), d.quantized), jtr.model_defs(jcfg),
            is_leaf=jlayers.is_pdef)))
        tdefs = ttr.model_defs(tcfg)
        tleaves = {}

        def walk(tree, path=()):
            if tlayers.is_pdef(tree):
                tleaves["/".join(path)] = (tuple(tree.shape), tree.quantized)
            else:
                for k, v in tree.items():
                    walk(v, path + (k,))
        walk(tdefs)
        assert tleaves == jdefs
    assert [s.name for s in ttr.build_segments(
        get_config(HYBRID).replace(n_layers=5))] == ["griffin", "tail_rec"]


def test_port_has_every_reference_arch():
    """The port's registry resolves every ``--arch`` id of the
    reference's, each to a config of the same name, and knows no other."""
    from repro.configs.registry import ARCHS as JARCHS

    assert sorted(registry.ARCHS) == sorted(JARCHS)
    for arch in JARCHS:
        for smoke in (False, True):
            assert get_config(arch, smoke).name == jax_get_config(
                arch, smoke).name


# --- the units ---------------------------------------------------------------
#
# Each unit's inputs come from a seed; the reference's side is computed
# in the shared child (``_units_reference``), jitted with its
# REFERENCE_XLA_FLAGS (in a process with XLA's default flags its
# algebraic simplifier turns the qk-norm's division by 160 into a
# multiplication by an inexact reciprocal).

QK = dict(shape=(2, 7, 4, 160), pos0=3)


def _qk_problem():
    x = _x(QK["shape"], 0, 3.0)
    scale = _x((QK["shape"][-1],), 1) + 1.0
    return x, scale, np.arange(QK["shape"][1], dtype=np.int32) + QK["pos0"]


def _act_problem():
    return (_x((4096,), 3, 4.0), _x((3, 5000), 4, 40.0), _x((3, 5000), 5),
            {"embedding": _x((16, 2560), 6)})


def _rglru_problem(cfg, b=2, s=9, seed=7):
    p = jax.tree.map(np.asarray, jlayers.init_tree(
        jrglru.rglru_defs(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("b_a", "b_i", "conv_b"):
        p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.1
    p["lambda_p"] = (1.0 + 0.5 * rng.standard_normal(
        p["lambda_p"].shape)).astype(np.float32)
    return (p, _x((b, s, cfg.d_model), seed + 1),
            _x((b, cfg.conv_width - 1, cfg.lru_width), 9),
            _x((b, 1, cfg.d_model), 11))


def _scan_problem(s):
    rng = np.random.default_rng(s)
    return (rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32),
            rng.standard_normal((2, s, 24)).astype(np.float32),
            rng.standard_normal((2, 24)).astype(np.float32))


SCAN_LENGTHS = (9, 300)


def _units_reference() -> dict:
    """The reference's side of the unit tests, as numpy (in the child)."""
    out = {}
    cfg = jax_get_config("stablelm-12b")
    x, scale, pos = _qk_problem()

    @jax.jit
    def qk(x, scale):
        q = jattn._qk_norm(x.astype(jnp.bfloat16), scale, cfg.norm_eps)
        q = q.astype(jnp.bfloat16)
        return q, jlayers.apply_rope(q, jnp.asarray(pos), cfg.rope_theta,
                                     cfg.rope_pct)

    out["qk"] = [np.asarray(a) for a in qk(x, scale)]
    hcfg = jax_get_config(HYBRID)
    c = hcfg.logit_softcap
    a, logits, g, emb = _act_problem()
    out["gelu"] = np.asarray(jax.jit(jax.nn.gelu)(a))
    out["softcap"] = np.asarray(jax.jit(
        lambda z: jnp.tanh(z / c) * c)(logits))
    out["softcap_grad"] = np.asarray(jax.jit(jax.grad(
        lambda z: jnp.sum(jnp.tanh(z / c) * c * g)))(logits))
    out["embed"] = np.asarray(jax.jit(lambda e: jlayers.embed_tokens(
        hcfg, e, jnp.arange(16, dtype=jnp.int32)[None]))(emb))
    scfg = jax_get_config(HYBRID, smoke=True)
    p, xr, prev, xd = _rglru_problem(scfg)
    out["conv"] = [np.asarray(v) for v in jax.jit(
        lambda p, u, prev: jrglru._causal_conv(
            p, u.astype(jnp.bfloat16), prev.astype(jnp.bfloat16)))(
                p, xr, prev)]
    out["scan"] = {s: [np.asarray(v) for v in jax.jit(jrglru._lru_scan)(
        *_scan_problem(s))] for s in SCAN_LENGTHS}
    out["block"] = {}
    for mode in ("moss", "bf16"):
        jcfg = scfg.replace(quant=type(scfg.quant)(mode=mode))
        jmask = jquant_mask_tree(jrglru.rglru_defs(jcfg))

        @jax.jit
        def block(p, x, xd, jcfg=jcfg, jmask=jmask):
            pq = jwrap_qt_nojit(p, jmask)
            y, st = jrglru.rglru_block(jcfg, pq, x.astype(jnp.bfloat16),
                                       jcfg.quant, None, "prefill")
            yd, st2 = jrglru.rglru_block(jcfg, pq, xd.astype(jnp.bfloat16),
                                         jcfg.quant, st, "decode")
            return y, st.h, st.conv, yd, st2.h, st2.conv

        out["block"][mode] = [np.asarray(v) for v in block(p, xr, xd)]
    return out


def test_hybrid_admission_resets_the_slot_state():
    """A request admitted into a slot that a finished request held
    starts from its own prefill's RG-LRU state, not the leftover one:
    the second of two requests served one after the other in one slot
    gives the stream it gives alone (the port alone)."""
    cfg = get_config(HYBRID, smoke=True)
    params = tlayers.init_tree(ttr.model_defs(cfg),
                               torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts()[:2]

    def serve(ps):
        reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in
                enumerate(ps)]
        Engine(cfg, params, num_slots=1, max_len=MAX_LEN,
               device="cpu").run(reqs, log=None)
        return [r.out for r in reqs]

    assert serve(prompts)[1] == serve(prompts[1:])[0]


def test_qk_norm_and_partial_rotary_match_reference(reference):
    """``_qk_norm`` over stablelm's full-width head (Dh 160, where 40 dims
    rotate at rope_pct 0.25) then RoPE, bitwise the reference's (an f32
    RMS in XLA's order, rsqrt rounded once, a true division by 160)."""
    cfg = get_config("stablelm-12b")
    x, scale, pos = _qk_problem()
    want_n, want_r = reference["units"]["qk"]
    got_n = tattn._qk_norm(torch.tensor(x).bfloat16(), torch.tensor(scale),
                           cfg.norm_eps).bfloat16()
    got_r = tlayers.apply_rope(got_n, torch.tensor(pos), cfg.rope_theta,
                               cfg.rope_pct)
    _same(want_n, got_n)
    _same(want_r, got_r)
    # 40 of 160 dims rotate: the rest pass through
    assert torch.equal(got_r[..., 40:], got_n[..., 40:])
    assert not torch.equal(got_r[..., :40], got_n[..., :40])


def test_activations_embedding_scale_and_softcap_match_reference(reference):
    """``jax.nn.gelu`` (the tanh form: 3.5% of its bf16 outputs differ
    from PyTorch's CPU tanh form's), the tied head's softcap (tanh in
    f32, c 30) and the sqrt(d) embedding scale rounded to bf16 before it
    multiplies (sqrt(2560) is 50.5 in bf16): bitwise; the softcap's
    derivative (JAX's rule for tanh) within 1e-6."""
    ref = reference["units"]
    a, logits, g, emb = _act_problem()
    _same(ref["gelu"], tlayers.gelu(torch.tensor(a)))
    cfg = get_config(HYBRID)
    c = cfg.logit_softcap
    lt = torch.tensor(logits, requires_grad=True)
    got = tlayers.tanh(tlayers.div_c(lt, c)) * c
    _same(ref["softcap"], got.detach())
    (got * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), ref["softcap_grad"],
                               rtol=1e-6, atol=1e-7)
    _same(ref["embed"], tlayers.embed_tokens(
        cfg, {"embedding": torch.tensor(emb["embedding"])},
        torch.arange(16)[None]))
    assert float(torch.tensor(np.sqrt(2560.0), dtype=torch.bfloat16)) == 50.5


def test_causal_conv_matches_reference(reference):
    """The width-4 depthwise causal conv over 9 positions with a history
    of 3 (the decode state): output and new history bitwise."""
    cfg = get_config(HYBRID, smoke=True)
    p, x, prev, _ = _rglru_problem(cfg)
    got = trglru._causal_conv({k: torch.tensor(v) for k, v in p.items()},
                              torch.tensor(x).bfloat16(),
                              torch.tensor(prev).bfloat16())
    for w, g in zip(reference["units"]["conv"], got):
        _same(w, g)


@pytest.mark.parametrize("s", SCAN_LENGTHS)
def test_lru_scan_matches_reference_and_stepwise(reference, s):
    """``_lru_scan`` over 9 positions and over 300 (two chunks of 256,
    the carry between them): bitwise the reference's (the same tree of
    combines as ``jax.lax.associative_scan``), and within 1e-6 of s
    one-token updates from the same start (the decode path)."""
    a, b, h0 = _scan_problem(s)
    wh, wl = reference["units"]["scan"][s]
    gh, gl = trglru._lru_scan(torch.tensor(a), torch.tensor(b),
                              torch.tensor(h0))
    np.testing.assert_array_equal(gh.numpy(), wh)
    np.testing.assert_array_equal(gl.numpy(), wl)
    h = torch.tensor(h0)
    steps = []
    for t in range(s):
        h = torch.tensor(a[:, t]) * h + torch.tensor(b[:, t])
        steps.append(h)
    np.testing.assert_allclose(gh.numpy(), torch.stack(steps, 1).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_rglru_block_prefill_then_decode_matches_reference(reference, mode):
    """The RG-LRU block (its five quantized projections, the gates, the
    conv and the scan) over a 9-token prompt, then one decode token from
    the state it left, against the reference's: the bf16 outputs and
    conv states bitwise, the f32 recurrent states within 1e-6 relative
    (the port takes ``log1p`` from PyTorch, which differs from XLA's in
    the last bit of ~15% of Lambda's softplus values; measured: 2 of 256
    and 7 of 256 elements one ulp apart)."""
    cfg = get_config(HYBRID, smoke=True).replace(
        quant=QuantConfig(mode=mode))
    p, x, _, xd = _rglru_problem(cfg)
    pt = wrap_qt_nojit({k: torch.tensor(v) for k, v in p.items()},
                       quant_mask_tree(trglru.rglru_defs(cfg)))
    with torch.no_grad():
        y, st = trglru.rglru_block(cfg, pt, torch.tensor(x).bfloat16(),
                                   cfg.quant, None, "prefill")
        yd, st2 = trglru.rglru_block(cfg, pt, torch.tensor(xd).bfloat16(),
                                     cfg.quant, st, "decode")
    want = reference["units"]["block"][mode]
    for w, g in zip(want, (y, st.h, st.conv, yd, st2.h, st2.conv)):
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
        else:
            _same(w, g)
    assert int(st2.idx) == 10


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["moss", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(reference, arch, mode):
    """The smoke model's forward (2 x 40 tokens, or the embeddings
    models' 2 x 40 embeddings) on the reference's weights, just-in-time
    weight scales: within 1e-2 * max|logit| (measured: bitwise, except
    minitron in bf16, 4.2e-3: its second layer's LayerNorm rounds 1 of
    10,240 bf16 outputs the other way, on an input equal in both
    packages, and musicgen in bf16, 2.6e-3; rwkv6 bitwise in both modes,
    the WKV's f32 sums in another order hidden by its bf16 outputs)."""
    cfg = get_config(arch, smoke=True).replace(quant=QuantConfig(mode=mode))
    qp = wrap_qt_nojit(_params(reference, arch),
                       quant_mask_tree(ttr.model_defs(cfg)))
    with torch.no_grad():
        got = ttr.forward(cfg, cfg.quant, qp,
                          torch.from_numpy(_model_input(cfg)),
                          mode="train")[0].numpy()
    want = reference[arch]["forward"][mode]
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= 1e-2, err


@pytest.mark.parametrize("arch", ARCHS)
def test_prequant_and_calibration_match_reference(reference, arch):
    """``prequantize_params`` (moss: every payload and per-layer scale;
    recurrentgemma's transposed tied head ``embed/head_t`` quantized
    against its own amax) and ``calibrate_act_scales`` on that tree
    (the RG-LRU's five sites per layer of each griffin unit and the
    tied head among them): bitwise the reference's."""
    from repro_torch.core.actscale import calibrate_act_scales

    ref = reference[arch]["build"]
    cfg = get_config(arch, smoke=True)
    pq = tsteps.prequantize_params(cfg, _params(reference, arch))
    got = dict(_leaf_items(pq.qweights))
    want = dict(_leaf_items(ref["qweights"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _same(w, got[name])
    for name, w in _leaf_items(ref["scales"]):
        np.testing.assert_array_equal(
            dict(_leaf_items(pq.scales))[name].numpy(), w, err_msg=name)
    if cfg.tie_embeddings:
        assert got["embed/head_t"].shape == (cfg.d_model, cfg.vocab)
        assert got["embed/head_t"].is_contiguous()
    act = calibrate_act_scales(cfg, pq.qweights, pq.scales)
    assert sorted(act) == sorted(ref["act"])
    for tag, (s, sub) in ref["act"].items():
        np.testing.assert_array_equal(act[tag].s.numpy(), s, err_msg=tag)
        np.testing.assert_array_equal(act[tag].sub.numpy(), sub,
                                      err_msg=tag)
    if arch == HYBRID:
        assert "embed/head_t" in act
        assert act["griffin/rec1/rec/w_a"].s.shape == (cfg.n_layers // 3,)


@pytest.mark.parametrize("mode", ["moss", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(reference, arch, mode):
    """One train step of the smoke model, batch 2 x 64, from the
    reference's ``init_train_state`` on the reference's batch, against
    the reference's step from the same state: tests/test_torch_train.py's
    limits.  Measured on a CPU (step-0 gradients rel L2 / update rel L2):
    stablelm moss 3.4e-6 / 4.7e-4, bf16 2.6e-3 / 1.4e-2; minitron moss
    3.1e-7 / 1.3e-4, bf16 2.1e-3 / 4.4e-3; recurrentgemma moss, bf16
    3.4e-7 / 6.3e-3 (the tied head's gradient flows into the embedding
    through the transpose); rwkv6 moss 2.9e-6 / 7.4e-6, bf16 7.4e-3 /
    1.1e-2; musicgen moss 3.4e-7 / 4.3e-5, bf16 3.6e-3 / 4.5e-3;
    phi-3-vision moss 2.6e-6 / 7.5e-6, bf16 1.7e-3 / 1.5e-3.  The
    embeddings models take the same numpy stub embeddings in both
    packages (their embedding's gradient is zero in both)."""
    from test_torch_train import TRAIN_HP, recipe

    before, batch, rs, rm = reference[arch]["train"][mode]
    cfg = get_config(arch, smoke=True).replace(
        quant=QuantConfig(**recipe(mode), rescale_interval=2))
    state = bridge.train_state_to_torch(before, device="cpu")
    if cfg.input_mode == "embeddings":
        assert batch["embeds"].shape == (*batch["tokens"].shape, cfg.d_model)
    ps, pm = tsteps.make_train_step(cfg, tsteps.TrainHParams(**TRAIN_HP))(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    check_train_steps([(before, rs, rm, bridge.train_state_to_numpy(ps),
                        {k: float(v) for k, v in pm.items()})])


@pytest.mark.parametrize("name", SERVE_RUNS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_streams_match_reference(reference, arch, name):
    """The smoke model served with each package's defaults (pre-quantized
    weights, delayed activation scales, the fp8 cache): stablelm and
    minitron through the engine on floating pages with chunked prefill,
    recurrentgemma on identity rows with the whole-prompt prefill at the
    exact prompt length (its recurrent state would integrate padding),
    each RG-LRU state written into its slot at admission; and the
    legacy Server.  Greedy streams equal to the reference's.  rwkv6 takes
    the hybrid's path (its time-mix and channel-mix states written into
    the slot at admission); both packages' engines refuse musicgen and
    phi-3-vision (embeddings input), whose Servers take token prompts
    through the embedding table."""
    cfg = get_config(arch, smoke=True)
    params = _params(reference, arch)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_serve_prompts(cfg))]
    if name == "engine" and _embeddings(cfg):
        from repro.serving import Engine as JEngine

        with pytest.raises(ValueError, match="input_mode"):
            Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                   device="cpu")
        with pytest.raises(ValueError, match="input_mode"):
            JEngine(jax_get_config(arch, smoke=True),
                    reference[arch]["params"], num_slots=SLOTS,
                    max_len=MAX_LEN)
        return
    if name == "server":
        Server(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
               device="cpu").run(list(reqs), log=None)
    else:
        eng = Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                     chunk_tokens=CHUNK, device="cpu")
        recurrent = cfg.family in ("hybrid", "ssm")
        assert eng.float_pages == eng.chunked == (not recurrent)
        assert eng.prompt_bucket == (1 if recurrent else 16)
        eng.run(reqs, log=None)
        assert not eng.kv.rows
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    _assert_streams(reqs, reference[arch]["serve"][name])


