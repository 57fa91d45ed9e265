"""The MLA slice against the reference, on the CPU: deepseek-v2-lite-16b's
smoke config (3 layers: the dense ``dense0`` layer, then 2 MoE
``blocks`` of 8 experts top-2 and 1 shared expert; d 128, 4 heads,
kv_lora 64, q_nope 32, q_rope 16, v_head 32, dense_ff 256).

The reference's side comes from the shared child of
tests/test_torch_train.py (``mla_reference``, compiled with its
``REFERENCE_XLA_FLAGS``; the serving runs through the reference's own
Engine and legacy Server, as tests/test_torch_serving.py serves them).
Inputs are made from a seed with numpy, or are the reference's own
weights and batches carried across by ``repro_torch.bridge``.

Limits, with their reasons (the values measured on a CPU are in each
test):

- quantized payloads, scales and calibrated activation scales: bitwise;
- ``mla_attention`` in train, prefill and decode modes: its bf16
  output within 1e-2 * max|ref| (one bf16 rounding of an output that
  f32 sums taken in another order can move; the absorbed decode's
  softmax runs over every cache slot) and the cache's bf16 latents
  bitwise;
- the whole forward: within 1e-3 * max|logit|;
- train steps: tests/test_torch_train.py's limits (``check_train_steps``);
- serving: equal greedy streams, except past a reference tie (top two
  logits within 1e-3 * max|logit|), tests/test_torch_serving.py's rule.

The reference's serving runs with ``REPRO_SERVE_PREQUANT=0``: with
pre-quantized weights its absorbed decode multiplies by the fp8
payloads of ``w_uk`` and ``w_uv`` without their scales
(``repro/models/mla.py:108`` and ``:121``), which moves its decode
streams off its own in-graph ones at the first decode token.  The port
serves pre-quantized weights as the in-graph path computes
(``train.steps.prequantize_params`` carries the bf16 values the
absorbed decode multiplies by), so its default streams are held against
the reference's ``REPRO_SERVE_PREQUANT=0`` streams.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import mla as jmla
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
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import quant_mask_tree, wrap_qt_nojit
from repro_torch.serving import Engine, Request
from repro_torch.train import steps as tsteps

from test_torch_recipes import _same
from test_torch_serving import (
    MAX_LEN,
    MAX_NEW,
    SLOTS,
    CHUNK,
    _assert_streams,
    _prompts,
)
from test_torch_train import (
    _leaf_items,
    _train_runs,
    check_train_steps,
    shared_reference,
)

ARCH = "deepseek-v2-lite-16b"
# the module's inputs: a (2, 20) train / prefill window into a 48-slot
# cache; decode rows at mixed depths in a 32-slot cache, the last one
# past it (33 writes slot 1 and every slot is live), and one shared depth
SEQ, PREFILL_T, DECODE_T = 20, 48, 32
DECODE_IDX, DECODE_SCALAR = [5, 17, 33], 12
TOKENS = np.random.default_rng(2).integers(0, 512, (2, 40)).astype(np.int32)
# the serving runs: the engine (identity rows, whole-prompt prefill) in
# moss with pre-quantized weights, delayed activation scales and the
# reference under REPRO_SERVE_PREQUANT=0; the same in bf16; the legacy
# Server
SERVE_RUNS = {"moss": {}, "bf16": {"mode": "bf16"},
              "server": {"server": True}}


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    return np.asarray(x, np.float32)


def _decode_cache(cfg, b=3):
    """A latent cache's ``c_kv`` and ``k_rope`` of random values (numpy
    f32, rounded to bf16 by the caller)."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((b, DECODE_T, cfg.kv_lora)).astype(
                np.float32),
            rng.standard_normal((b, DECODE_T, cfg.q_rope)).astype(
                np.float32))


# --- the reference, in the shared child of tests/test_torch_train.py ---------

def _module_reference(jcfg, params):
    """``mla_attention`` of dense0's layer 0 (moss, just-in-time scales)
    in train, prefill and decode modes, as numpy."""
    lay = jax.tree.map(lambda a: a[0], params["dense0"]["attn"])
    p = jwrap_qt_nojit(lay, jquant_mask_tree(jmla.mla_defs(jcfg)))
    q = jcfg.quant
    x = jnp.asarray(_x((2, SEQ, jcfg.d_model), 3)).astype(jnp.bfloat16)
    pos = jnp.arange(SEQ, dtype=jnp.int32)
    out = {}

    @jax.jit
    def train(p, x):
        return jmla.mla_attention(jcfg, p, x, pos, q, None, "train")[0]

    @jax.jit
    def prefill(p, x):
        y, c = jmla.mla_attention(jcfg, p, x, pos, q,
                                  jmla.init_mla_cache(jcfg, 2, PREFILL_T),
                                  "prefill")
        return y, c.c_kv, c.k_rope, c.idx

    out["train"] = np.asarray(train(p, x), np.float32)
    out["prefill"] = [np.asarray(a) for a in prefill(p, x)]
    c_kv, k_rope = _decode_cache(jcfg)
    xd = jnp.asarray(_x((3, 1, jcfg.d_model), 4)).astype(jnp.bfloat16)
    for name, idx in (("per_slot", jnp.asarray(DECODE_IDX, jnp.int32)),
                      ("scalar", jnp.int32(DECODE_SCALAR))):
        positions = (idx[:, None] if idx.ndim else idx[None])
        cache = jmla.MLACache(jnp.asarray(c_kv).astype(jnp.bfloat16),
                              jnp.asarray(k_rope).astype(jnp.bfloat16), idx)

        @jax.jit
        def decode(p, x, cache, positions=positions):
            y, c = jmla.mla_attention(jcfg, p, x, positions, q, cache,
                                      "decode")
            return y, c.c_kv, c.k_rope, c.idx

        out[name] = [np.asarray(a) for a in decode(p, xd, cache)]
    return out


def _serve_reference(jcfg, params) -> dict:
    """The reference's streams and logit gaps for ``SERVE_RUNS``, the
    quantized runs under ``REPRO_SERVE_PREQUANT=0`` (holding the child's
    ``ENGINE_LOCK`` alone while the variable is set; the child's engines
    share their compiled steps: tests/test_torch_serving.py's
    ``_share_steps``)."""
    from test_torch_serving import _reference_serve, _share_steps
    from test_torch_train import ENGINE_LOCK

    out = {}
    with ENGINE_LOCK.exclusive():
        _share_steps()
        for name, run in SERVE_RUNS.items():
            cfg = jcfg
            if "mode" in run:
                cfg = cfg.replace(quant=type(cfg.quant)(mode=run["mode"]))
            os.environ["REPRO_SERVE_PREQUANT"] = "0"
            try:
                out[name] = _reference_serve(cfg, params, run, _prompts())
            finally:
                os.environ.pop("REPRO_SERVE_PREQUANT")
    return out


def mla_reference() -> dict:
    """The reference's side of this module's tests (in the shared child
    of tests/test_torch_train.py): the smoke parameters from
    ``PRNGKey(0)``, the module's modes, the whole forward in moss and
    bf16, the pre-quantized tree and its calibration, two train steps
    in moss and bf16, and the serving streams."""
    from repro.core.actscale import calibrate_act_scales as jcalibrate

    jcfg = jax_get_config(ARCH, smoke=True)
    params = jinit_tree(jtr.model_defs(jcfg), jax.random.PRNGKey(0))
    out = {"params": jax.tree.map(np.asarray, params),
           "module": _module_reference(jcfg, params), "forward": {}}
    for mode in ("moss", "bf16"):
        cfg = jcfg.replace(quant=type(jcfg.quant)(mode=mode))
        mask = jquant_mask_tree(jtr.model_defs(cfg))
        fwd = jax.jit(lambda p, t, cfg=cfg, mask=mask: jtr.forward(
            cfg, cfg.quant, jwrap_qt_nojit(p, mask), {"tokens": t},
            mode="train")[0])
        out["forward"][mode] = np.asarray(fwd(params, TOKENS), np.float32)
    pq = jsteps.prequantize_params(jcfg, params)
    # calibrated on the raw weights against their build-time scales, as
    # the engines below calibrate under REPRO_SERVE_PREQUANT=0 (so they
    # reuse its compiled ops); on the pre-quantized tree the reference
    # calibrates the same scales bit for bit (the payloads are those
    # its in-graph quantizer makes)
    act = jcalibrate(jcfg, params, jsteps.serve_weight_scales(jcfg, params))
    out["build"] = {"qweights": jax.tree.map(np.asarray, pq.qweights),
                    "scales": jax.tree.map(np.asarray, pq.scales),
                    "act": {t: (np.asarray(a.s), np.asarray(a.sub))
                            for t, a in act.items()}}
    out["train"] = _train_runs(ARCH, ("moss", "bf16"), steps=2)
    out["serve"] = _serve_reference(jcfg, params)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``mla_reference``'s results, from the child process that
    tests/test_torch_train.py, test_torch_recipes.py, test_torch_ring.py
    and test_torch_moe.py share."""
    return shared_reference(tmp_path_factory)["mla"]


@pytest.fixture(scope="module")
def params(reference):
    return bridge.tree_to_torch(reference["params"], device="cpu")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all() and got.shape == want.shape
    err, big = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * big, (err, big)
    return err / big


# --- the config, the tree, the bridge ------------------------------------------

def test_mla_config_and_defs_match_reference():
    """Every field of the port's config equals the reference's (full and
    smoke); every parameter definition (shape, logical axes, init,
    quantized) equals the reference's, ``dense0`` and ``blocks`` alike;
    one scale state per layer slice of the 3-D ``wq``, ``w_uk``,
    ``w_uv`` and ``wo``, per (layer, expert) of the expert stacks."""
    for smoke in (False, True):
        t, j = get_config(ARCH, smoke), jax_get_config(ARCH, smoke)
        for f in t.__dataclass_fields__:
            if f != "quant":
                assert getattr(t, f) == getattr(j, f), f
    jd = jtr.model_defs(jax_get_config(ARCH, smoke=True))
    td = ttr.model_defs(get_config(ARCH, smoke=True))
    jflat = jax.tree_util.tree_flatten_with_path(
        jd, is_leaf=lambda d: hasattr(d, "quantized"))[0]
    assert len(jflat) == len(list(_leaf_items(td)))
    for path, d in jflat:
        node = td
        for p in path:
            node = node[p.key]
        assert (tuple(node.shape), node.logical, node.init,
                node.quantized) == (tuple(d.shape), d.logical, d.init,
                                    d.quantized), path
    sd = tsteps._scale_dims(td)
    for seg in ("dense0", "blocks"):
        for name in ("wq", "w_uk", "w_uv", "wo", "w_dkv", "w_kr"):
            assert sd[seg]["attn"][name] == 1, (seg, name)
    assert sd["blocks"]["moe"]["w_up"] == 2
    assert sd["blocks"]["shared"]["w_up"] == sd["dense0"]["ffn"]["w_up"] == 1
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.n_experts, cfg.top_k, cfg.n_shared,
            cfg.first_dense, cfg.dense_ff, cfg.kv_lora) == \
        (2048, 64, 6, 2, 1, 10_944, 512)


def test_mla_is_ported_and_takes_the_v1_serving_path():
    """The registry serves the arch; MLA's latent cache takes neither
    floating pages nor chunked prefill nor verify steps (the
    reference's gates); the segments do not depend on the input mode
    (embeddings replace the embedding's rows before them), and the
    refusal of a family the port does not know names no MLA field."""
    assert ARCH in registry.ARCHS
    cfg = get_config(ARCH, smoke=True)
    assert [s.name for s in ttr.build_segments(cfg)] == ["dense0", "blocks"]
    assert not ttr.paged_decode_supported(cfg, 48, 16)
    assert not ttr.chunk_prefill_supported(cfg, 48)
    assert not ttr.spec_verify_supported(cfg, 48)
    assert [s.name for s in ttr.build_segments(
        cfg.replace(input_mode="embeddings"))] == ["dense0", "blocks"]
    with pytest.raises(ValueError) as e:
        ttr.build_segments(cfg.replace(family="unknown"))
    assert "n_shared" not in str(e.value) and \
        "first_dense" not in str(e.value)


def test_bridge_carries_every_leaf(reference, params):
    """The reference's parameter tree and its train state cross the
    bridge leaf for leaf, bit for bit: ``dense0`` and ``blocks``, the
    AdamW moments and the scale states."""
    want = dict(_leaf_items(reference["params"]))
    got = dict(_leaf_items(params))
    defs = dict(_leaf_items(ttr.model_defs(get_config(ARCH, smoke=True))))
    assert sorted(got) == sorted(want) == sorted(defs)
    assert any(k.startswith("dense0/") for k in got)
    for name, w in want.items():
        _same(w, got[name])
    before = reference["train"]["moss"][0][0]
    st = bridge.train_state_to_torch(before, device="cpu")
    for tree, ref in ((st.params, before.params),
                      (st.scale_s0, before.scale_s0)):
        ref = dict(_leaf_items(ref))
        got = dict(_leaf_items(tree))
        assert sorted(got) == sorted(ref) == sorted(defs)
        for name, w in ref.items():
            _same(w, got[name])
    ref_opt = dict(_leaf_items(before.opt))
    opt = dict(_leaf_items(st.opt))
    assert sorted(opt) == sorted(ref_opt) == sorted(defs)
    for name, o in ref_opt.items():
        _same(o.mu, opt[name].mu)
        _same(o.nu, opt[name].nu)
    assert dict(_leaf_items(st.scale_t)) == \
        {k: int(v) for k, v in _leaf_items(before.scale_t)}


# --- mla_attention -----------------------------------------------------------

def _layer0(params):
    cfg = get_config(ARCH, smoke=True)
    lay = {k: v[0] for k, v in params["dense0"]["attn"].items()}
    return cfg, wrap_qt_nojit(lay, quant_mask_tree(tmla.mla_defs(cfg)))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_attention_train_and_prefill_match_reference(reference, params,
                                                         mode):
    """dense0's layer 0 in moss with just-in-time scales on a (2, 20)
    input: K and V materialised from the latent through ``w_uk`` and
    ``w_uv`` (K 64, ``dense_general``), the chunked causal attention
    with Dh 48 against Dv 32; the prefill's cache of 48 slots holds the
    20 latents and RoPE keys bitwise, idx 20.  Measured on a CPU: the
    outputs equal."""
    cfg, p = _layer0(params)
    ref = reference["module"][mode]
    x = _bf16(_x((2, SEQ, cfg.d_model), 3))
    pos = torch.arange(SEQ, dtype=torch.int32)
    cache = None
    if mode == "prefill":
        cache = tmla.init_mla_cache(cfg, 2, PREFILL_T, "cpu")
    with torch.no_grad():
        y, c = tmla.mla_attention(cfg, p, x, pos, cfg.quant, cache, mode)
    if mode == "train":
        assert c is None
        print(_close(y.float(), ref, 1e-2))
        return
    print(_close(y.float(), ref[0], 1e-2))
    _same(ref[1], c.c_kv)
    _same(ref[2], c.k_rope)
    assert int(c.idx) == int(ref[3]) == SEQ
    assert c.c_kv.shape == (2, PREFILL_T, cfg.kv_lora)


@pytest.mark.parametrize("name", ["per_slot", "scalar"])
def test_mla_absorbed_decode_matches_reference(reference, params, name):
    """The absorbed decode of one token for 3 rows against a 32-slot
    latent cache of random bf16 values: per-slot depths 5, 17 and 33
    (the last writes slot 33 % 32 = 1 and sees all 32 slots), or one
    shared depth 12.  The written latents bitwise, the depths advanced
    by one, the output within one bf16 rounding of a value that f32
    sums in another order can move (1e-2 * max|ref|).  Measured on a
    CPU: the outputs equal."""
    cfg, p = _layer0(params)
    ref = reference["module"][name]
    c_kv, k_rope = _decode_cache(cfg)
    idx = (torch.tensor(DECODE_IDX, dtype=torch.int32) if name == "per_slot"
           else torch.tensor(DECODE_SCALAR, dtype=torch.int32))
    cache = tmla.MLACache(_bf16(c_kv), _bf16(k_rope), idx)
    pos = idx[:, None] if idx.dim() else idx[None]
    x = _bf16(_x((3, 1, cfg.d_model), 4))
    with torch.no_grad():
        y, c = tmla.mla_attention(cfg, p, x, pos, cfg.quant, cache,
                                  "decode")
    print(_close(y.float(), ref[0], 1e-2))
    assert c.c_kv is cache.c_kv                    # written in place
    _same(ref[1], c.c_kv)
    _same(ref[2], c.k_rope)
    np.testing.assert_array_equal(c.idx.numpy(), ref[3])


def test_mla_prequantized_decode_is_the_in_graph_decode(params):
    """The reference's fault, held off in the port: with pre-quantized
    weights the absorbed decode multiplies by the bf16 copies of
    ``w_uk`` and ``w_uv`` that ``prequantize_params`` adds, so a decode
    step on the pre-quantized tree equals, bit for bit, the step that
    quantizes the raw weights against the same build-time scales
    (``REPRO_SERVE_PREQUANT=0``).  An fp8 payload without its copy is
    refused, not multiplied unscaled."""
    cfg = get_config(ARCH, smoke=True)
    pq = tsteps.prequantize_params(cfg, params)
    scales = tsteps.serve_weight_scales(cfg, params)
    att = pq.qweights["blocks"]["attn"]
    for src, dst in tmla.ABSORBED.items():
        assert att[dst].dtype == torch.bfloat16
        assert torch.equal(att[dst], params["blocks"]["attn"][src].to(
            torch.bfloat16))
        assert att[src].dtype == torch.float8_e4m3fn
    toks = torch.from_numpy(TOKENS[:, :13])
    outs = []
    for tree, sc in ((pq.qweights, pq.scales), (params, scales)):
        pre = tsteps.make_prefill_step(cfg, 32, scales=sc)
        dec = tsteps.make_decode_step(cfg, scales=sc)
        logits, caches = pre(tree, toks)
        steps = [logits]
        for _ in range(3):
            feed = torch.argmax(steps[-1][:, -1], dim=-1)[:, None]
            logits, caches = dec(tree, caches, feed.to(torch.int32))
            steps.append(logits)
        outs.append(steps)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    bare = {k: v for k, v in att.items() if k not in tmla.ABSORBED.values()}
    bad = {**pq.qweights, "blocks": {**pq.qweights["blocks"], "attn": bare}}
    bad_scales = {**pq.scales, "blocks": {**pq.scales["blocks"], "attn": {
        k: v for k, v in pq.scales["blocks"]["attn"].items()
        if k not in tmla.ABSORBED.values()}}}
    caches = tsteps.make_prefill_step(cfg, 32, scales=bad_scales)(bad,
                                                                  toks)[1]
    with pytest.raises(ValueError, match="w_uk"):
        tsteps.make_decode_step(cfg, scales=bad_scales)(
            bad, caches, toks[:, :1])


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_mla_forward_matches_reference(reference, params, mode):
    """The whole smoke forward (train mode, just-in-time scales) on a
    (2, 40) batch: dense0 (MLA + the dense FFN of 256), two MoE blocks
    (MLA, 8 routed experts top-2 on the dense combine, the shared
    expert of 96 after them), within 1e-3 * max|logit|.  Measured on a
    CPU: equal, in moss and in bf16."""
    cfg = get_config(ARCH, smoke=True).replace(quant=QuantConfig(mode=mode))
    with torch.no_grad():
        got, _, aux = ttr.forward(
            cfg, cfg.quant,
            wrap_qt_nojit(params, quant_mask_tree(ttr.model_defs(cfg))),
            torch.from_numpy(TOKENS), mode="train")
    print(_close(got, reference["forward"][mode], 1e-3))
    assert float(aux) > 0


def test_mla_prequant_and_calibration_match_reference(reference, params):
    """``prequantize_params`` (every payload and per-layer or per-(layer,
    expert) scale bitwise the reference's, plus the absorbed decode's
    bf16 copies) and ``calibrate_act_scales`` on it: the same site tags
    as the reference's (``dense0/attn/wq`` through ``dense_general``,
    ``w_dkv``, ``w_kr``, ``w_uk`` and ``w_uv`` in the calibration's
    train-mode forward, ``dense0/ffn/*``, ``blocks/shared/*``, every
    expert under its (layer, expert) index; ``wo`` is never recorded,
    as the reference drops its tag) and every ``ActScale`` bitwise."""
    from repro_torch.core.actscale import calibrate_act_scales

    ref = reference["build"]
    cfg = get_config(ARCH, smoke=True)
    tp = tsteps.prequantize_params(cfg, params)
    rq, rs = dict(_leaf_items(ref["qweights"])), dict(_leaf_items(
        ref["scales"]))
    tq, ts = dict(_leaf_items(tp.qweights)), dict(_leaf_items(tp.scales))
    copies = {f"{seg}/attn/{dst}" for seg in ("dense0", "blocks")
              for dst in tmla.ABSORBED.values()}
    assert sorted(tq) == sorted(ts) == sorted(set(rq) | copies)
    for name, want in rq.items():
        _same(want, tq[name])
        np.testing.assert_array_equal(ts[name].numpy(), rs[name])
    act = calibrate_act_scales(cfg, tp.qweights, tp.scales)
    assert sorted(act) == sorted(ref["act"])
    assert {"dense0/attn/wq", "dense0/attn/w_uk", "blocks/attn/w_uv",
            "dense0/ffn/w_down", "blocks/shared/w_up",
            "blocks/moe/w_up"} <= set(act)
    assert not any(t.endswith("/wo") for t in act)
    for tag, (s, sub) in ref["act"].items():
        np.testing.assert_array_equal(act[tag].s.numpy(), s, err_msg=tag)
        np.testing.assert_array_equal(act[tag].sub.numpy(), sub,
                                      err_msg=tag)
    assert act["blocks/moe/w_up"].s.shape == (2, cfg.n_experts)


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_mla_train_steps_match_reference(reference, mode):
    """Two steps of the smoke model (batch 2 x 64: the routed experts on
    the dense combine), lr 1e-3, a scale refresh every 2 steps, from the
    reference's ``init_train_state`` on its batches, each held against
    the reference's step from the same state with
    tests/test_torch_train.py's limits (step-0 gradients rel L2 <=
    2e-2, loss rel <= 1e-2, ``scale_t`` equal, updates rel L2 <= 5e-2
    over the settled elements, at most 5% unsettled) and the aux loss
    within 1e-5 relative.  Measured on a CPU (moss / bf16): step-0
    gradients 1.83e-2 (``dense0/attn/w_dkv``: the MoE combine's and the
    router's f32 sums, in MKL's order, flip e5m2 roundings that the MLA
    backward carries down) / 5.1e-3, loss 1.5e-7 / 1.5e-7, updates
    3.4e-2 / 2.4e-2, unsettled 3.1% / 1.6%; the same with 1 and 3 torch
    threads.  The backward sums the heads' RoPE-key gradients and the
    dense combine's token gradients as XLA does (``layers.broadcast``);
    with ``expand`` the moss gradients were 13% apart."""
    runs = reference["train"][mode]
    assert len(runs) == 2
    print(mode, check_train_steps(runs))
    for i, (_, _, rm, _, pm) in enumerate(runs):
        assert abs(pm["aux"] - rm["aux"]) <= 1e-5 * abs(rm["aux"]), i


# --- serving -----------------------------------------------------------------

def _serve(cfg, params, run):
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    if run.get("server"):
        Server(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
               device="cpu").run(list(reqs), log=None)
    else:
        eng = Engine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                     chunk_tokens=CHUNK, spec_decode=True, device="cpu")
        # the v1 path, as the reference serves MLA: identity rows,
        # whole-prompt prefill, reservation admission, no prefix cache,
        # no verify steps (asked for, inert)
        assert not (eng.float_pages or eng.chunked or eng.prefix_cache
                    or eng.preemption or eng.spec)
        eng.run(reqs, log=None)
        assert not eng.kv.rows
        assert eng.kv.allocator.free_pages == eng.kv.allocator.num_pages
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    return reqs


@pytest.mark.parametrize("name", sorted(SERVE_RUNS))
def test_mla_serving_streams_match_reference(reference, params, name):
    """The engine in moss (pre-quantized weights, delayed activation
    scales) and in bf16, and the legacy Server in moss, serve 5 prompts
    of 5-31 tokens, 8 new tokens each, 3 slots of 48 on the latent
    cache; the streams equal the reference's (its quantized runs under
    ``REPRO_SERVE_PREQUANT=0``, see the module docstring).  Measured on
    a CPU: every stream equal."""
    run = SERVE_RUNS[name]
    cfg = get_config(ARCH, smoke=True)
    if "mode" in run:
        cfg = cfg.replace(quant=QuantConfig(mode=run["mode"]))
    _assert_streams(_serve(cfg, params, run), reference["serve"][name])


def test_mla_prequant_off_serves_the_same_streams(params, monkeypatch):
    """The port's engine under ``REPRO_SERVE_PREQUANT=0`` (weights
    quantized in every step against the build-time scales) serves the
    streams of its default, pre-quantized build, token for token."""
    cfg = get_config(ARCH, smoke=True)
    want = [r.out for r in _serve(cfg, params, {})]
    monkeypatch.setenv("REPRO_SERVE_PREQUANT", "0")
    assert [r.out for r in _serve(cfg, params, {})] == want
