"""The contiguous-cache serving slice against the reference, on the CPU:
the contiguous decode attention's plain version, its dispatch, the ring
writes of the cache, the sliding-window model (h2o-danube-3-4b's smoke
config) and the whole-prompt prefill step, and the engine's identity
placement and the legacy Server held to the reference's own contracts.
(The kernel against its plain version, on a card:
tests/test_torch_cuda.py; the serving paths' streams against the
reference's engine: tests/test_torch_serving.py.)

Tolerances:
- decode attention: the plain version is bitwise equal to
  ``repro.kernels.ref.decode_attn_ref`` and to ``decode_attn_pallas``
  with one C block (one einsum order).  Against the Pallas kernel's
  multi-block path (``bc`` < C) it agrees within
  2^-8 · sum_t w_t |v_t| + 1e-6 · max|ref|: that path rounds the
  unnormalized weights to bf16 before the V product, the einsum the
  normalized ones, and two bf16 roundings of one weight differ by at
  most 2^-8 of it;
- cache writes: payloads, scales and idx bitwise (the same K/V in);
- model: the reference's side comes from the shared child process of
  tests/test_torch_train.py (compiled with its ``REFERENCE_XLA_FLAGS``,
  which give what the reference computes op by op).  Logits within
  1e-3 · max|logit| (bf16 roundings after f32 sums taken in the BLAS
  library's order); the prefill's fp8 cache payloads and scales
  bitwise, bf16 payloads within one bf16 step (a K projection's f32 sum
  may round the other way: one of 8192 elements did, op by op);
- streams: equal, token for token.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attn_pallas
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.layers import init_tree
from repro.models.layers import quant_mask_tree as jax_quant_mask_tree
from repro.models.layers import wrap_qt_nojit as jax_wrap_qt_nojit
from repro.train import steps as jsteps

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.formats import BF16_CONFIG
from repro_torch.kernels import decode_attn, dispatch
from repro_torch.launch.serve import Server
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import quant_mask_tree, wrap_qt_nojit
from repro_torch.serving import Engine, Request
from repro_torch.train import steps as tsteps

from test_torch_train import reference  # noqa: F401  (a fixture)

H2O, PHI3 = "h2o-danube-3-4b", "phi3-mini-3.8b"
_ML = {torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
       torch.bfloat16: ml_dtypes.bfloat16}


def _jax(t):
    """A torch tensor (or None) as a JAX array with the same bits."""
    if t is None:
        return None
    if t.dtype in _ML:
        return jnp.asarray(bridge.bits(t).view(_ML[t.dtype]))
    return jnp.asarray(t.numpy())


def _same_bits(got: torch.Tensor, want) -> None:
    g = bridge.bits(got)
    np.testing.assert_array_equal(g, np.asarray(want).view(g.dtype))


# --- contiguous decode attention -----------------------------------------

B, KV, C = 3, 2, 48


def _cache(seed, g, dh, kv_dtype):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((B, KV, g, dh)),
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((B, KV, C, dh)),
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((B, KV, C, dh)),
                     dtype=torch.float32)
    if kv_dtype == "fp8":
        (k, ks), (v, vs) = tattn._quant_kv(k), tattn._quant_kv(v)
    else:
        k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
    return q, k, v, ks, vs


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
@pytest.mark.parametrize("g,dh", [(4, 120), (10, 256)])
def test_decode_attn_plain_matches_reference_and_pallas(kv_dtype, g, dh):
    """h2o-danube3's group and head width (G 4, Dh 120) and
    recurrentgemma's (G 10, Dh 256); n_valid per slot: partial, one
    token, and past C (a wrapped ring), then one scalar past C."""
    q, k, v, ks, vs = _cache(g + dh, g, dh, kv_dtype)
    sm = dh ** -0.5
    nv = np.array([37, 1, 60], np.int32)
    got = decode_attn.decode_attn_ref(q, k, v, ks, vs, torch.tensor(nv),
                                      sm_scale=sm)
    jq, jk, jv, jks, jvs = map(_jax, (q, k, v, ks, vs))
    _same_bits(got, jref.decode_attn_ref(jq, jk, jv, jks, jvs,
                                         jnp.asarray(nv), sm_scale=sm))
    gp = -(-g // 8) * 8
    qp = jnp.pad(jq, ((0, 0), (0, 0), (0, gp - g), (0, 0)))
    one = decode_attn_pallas(qp, jk, jv, jks, jvs, jnp.asarray(nv),
                             sm_scale=sm, interpret=True)[:, :, :g]
    _same_bits(got, one)
    split = np.asarray(decode_attn_pallas(
        qp, jk, jv, jks, jvs, jnp.asarray(nv), sm_scale=sm, bc=16,
        interpret=True)[:, :, :g])
    wv = decode_attn.decode_attn_ref(q, k, v.to(torch.bfloat16).abs(),
                                     ks, vs, torch.tensor(nv),
                                     sm_scale=sm).numpy()
    tol = 2.0 ** -8 * wv + 1e-6 * np.abs(split).max()
    assert (np.abs(got.numpy() - split) <= tol).all()
    # a scalar n_valid past C: every row's ring is full
    got = dispatch.decode_attention(q, k, v, ks, vs, torch.tensor(100))
    _same_bits(got, jdispatch.decode_attention(
        jq, jk, jv, jks, jvs, jnp.int32(100), backend="ref"))


def _paged(seed):
    """A scrambled block table of 16-slot pages over C, and the function
    that cuts a (B, KV, C, ...) cache into its page pool."""
    t, n_p = 16, C // 16
    bt = torch.tensor(np.random.default_rng(seed).permutation(B * n_p)
                      .reshape(B, n_p), dtype=torch.int32)

    def pages(x):
        pool = torch.zeros((B * n_p, KV, t) + x.shape[3:], dtype=x.dtype)
        raw = pool.view(torch.uint8) if x.element_size() == 1 else pool
        src = x.view(torch.uint8) if x.element_size() == 1 else x
        for b in range(B):
            for j in range(n_p):
                raw[bt[b, j]] = src[b, :, j * t:(j + 1) * t]
        return pool

    return bt, pages


def test_decode_attention_routes_agree_and_refuse():
    """The contiguous route and the paged route over the same bytes (the
    cache cut into scrambled pages) give the same bits, in the 4-D
    (decode) and the 5-D (verify) form; a wrong n_valid length is
    refused."""
    q, k, v, ks, vs = _cache(7, 4, 120, "fp8")
    bt, pages = _paged(8)
    nv = torch.tensor([37, 1, 48], dtype=torch.int32)
    got = dispatch.decode_attention(q, k, v, ks, vs, nv)
    paged = dispatch.decode_attention_paged(q, pages(k), pages(v),
                                            pages(ks), pages(vs), nv, bt)
    np.testing.assert_array_equal(got.numpy(), paged.numpy())
    # two drafts a row; every depth holds both drafts' writes
    q5 = torch.stack([q, q.flip(-1)], dim=2)
    nv5 = torch.tensor([37, 2, 48], dtype=torch.int32)
    got5 = dispatch.decode_attention(q5, k, v, ks, vs, nv5)
    paged5 = dispatch.decode_attention_paged(q5, pages(k), pages(v),
                                             pages(ks), pages(vs), nv5, bt)
    assert got5.shape == q5.shape
    np.testing.assert_array_equal(got5.numpy(), paged5.numpy())
    with pytest.raises(ValueError, match="n_valid"):
        dispatch.decode_attention(q, k, v, ks, vs, nv[:2])



@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_einsum_path_is_the_kernel_route_on_the_cpu(kv_dtype):
    """``dispatch.decode_attention_plain``, the ``REPRO_DECODE_ATTN=
    einsum`` path, gives on CPU tensors the bits of the kernel wrappers'
    route (which runs the same plain versions there): contiguous and
    paged, in the 4-D (decode) and the 5-D (verify) form."""
    q, k, v, ks, vs = _cache(9, 4, 120, kv_dtype)
    bt, pages = _paged(10)
    pool = [None if x is None else pages(x) for x in (k, v, ks, vs)]
    q5 = torch.stack([q, q.flip(-1)], dim=2)
    for qq, nv in ((q, [37, 1, 48]), (q5, [37, 2, 48])):
        nv = torch.tensor(nv, dtype=torch.int32)
        np.testing.assert_array_equal(
            dispatch.decode_attention_plain(qq, k, v, ks, vs, nv).numpy(),
            dispatch.decode_attention(qq, k, v, ks, vs, nv).numpy())
        np.testing.assert_array_equal(
            dispatch.decode_attention_plain(qq, *pool, nv, bt).numpy(),
            dispatch.decode_attention_paged(qq, *pool, nv, bt).numpy())

# --- the contiguous cache's writes ---------------------------------------

# (arch, window, max_len, idx, S): the ring's keep-last-C prefill and a
# short prefill (scalar idx), the per-slot ring decode write (one row
# wraps), and the per-slot chunk append whose tail past C is dropped
WRITES = {
    "ring-prefill": (H2O, 16, 48, 0, 21),
    "short-prefill": (H2O, 16, 48, 0, 9),
    "ring-decode": (H2O, 16, 48, [3, 16, 37], 1),
    "chunk-drop": (PHI3, None, 48, [0, 10, 40], 16),
}


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
@pytest.mark.parametrize("case", sorted(WRITES))
def test_cache_write_matches_reference(case, kv_dtype):
    arch, window, max_len, idx, s = WRITES[case]
    over = dict(kv_cache_dtype=kv_dtype)
    if window:
        over["window"] = window
    tcfg = get_config(arch, smoke=True).replace(**over)
    jcfg = jax_get_config(arch, smoke=True).replace(**over)
    rng = np.random.default_rng(len(case))
    cache = tattn.init_cache(tcfg, B, max_len, "cpu")
    c = cache.k.shape[2]
    assert c == (min(window, max_len) if window else max_len)
    old = torch.tensor(rng.standard_normal(
        (2, B, tcfg.n_kv, c, tcfg.head_dim)), dtype=torch.float32)
    if kv_dtype == "fp8":
        (k0, ks0), (v0, vs0) = tattn._quant_kv(old[0]), \
            tattn._quant_kv(old[1])
    else:
        k0, v0, ks0, vs0 = old[0].bfloat16(), old[1].bfloat16(), None, None
    idx = torch.tensor(idx, dtype=torch.int32)
    cache = tattn.KVCache(k0.clone(), v0.clone(),
                          None if ks0 is None else ks0.clone(),
                          None if vs0 is None else vs0.clone(), idx)
    jcache = jattn.KVCache(*map(_jax, (k0, v0, ks0, vs0)),
                           idx=jnp.asarray(idx.numpy()))
    new = torch.tensor(rng.standard_normal(
        (2, B, s, tcfg.n_kv, tcfg.head_dim)), dtype=torch.bfloat16)
    got = tattn._cache_write(tcfg, cache, new[0], new[1])
    want = jattn._cache_write(jcfg, jcache, _jax(new[0]), _jax(new[1]))
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(got, name) is not None:
            _same_bits(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert got.k is cache.k                    # written in place


# --- the sliding-window model and the whole-prompt prefill ---------------


TOKENS = np.random.default_rng(2).integers(0, 512, (1, 100)).astype(
    np.int32)


def h2o_reference() -> dict:
    """The reference's side of the h2o model tests, computed in the
    shared child of tests/test_torch_train.py: its smoke parameters,
    the train-mode forward of ``TOKENS`` (100 tokens under a 64-token
    window; attn_chunk 32, so the window cuts through a KV chunk), and
    per cache dtype the prefill step of ``TOKENS`` into a 64-slot ring
    (positions 36-99 kept, p in slot p % 64) with pre-quantized weights
    and just-in-time activation scales, its logits at position 96."""
    cfg = jax_get_config(H2O, smoke=True)
    params = init_tree(jtr.model_defs(cfg), jax.random.PRNGKey(0))
    mask = jax_quant_mask_tree(jtr.model_defs(cfg))
    fwd = jax.jit(lambda p, t: jtr.forward(
        cfg, cfg.quant, jax_wrap_qt_nojit(p, mask), {"tokens": t},
        mode="train")[0])
    out = {"params": jax.tree.map(np.asarray, params),
           "forward": np.asarray(fwd(params, TOKENS), np.float32)}
    for kv in ("fp8", "bf16"):
        c = cfg.replace(kv_cache_dtype=kv)
        jp = jsteps.prequantize_params(c, params)
        logits, caches = jax.jit(jsteps.make_prefill_step(
            c, 128, scales=jp.scales))(jp.qweights, {"tokens": TOKENS},
                                       jnp.int32(96))
        blk = caches["blocks"]
        out[kv] = {"logits": np.asarray(logits, np.float32),
                   "idx": np.asarray(blk.idx)}
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(blk, name) is not None:
                out[kv][name] = np.asarray(getattr(blk, name))
    return out


@pytest.fixture(scope="module")
def h2o(reference):
    """(port cfg, port params from the reference's, the reference's
    results)."""
    ref = reference["h2o"]
    return (get_config(H2O, smoke=True),
            bridge.tree_to_torch(ref["params"], device="cpu"), ref)


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    return {path: tuple(tree.shape)}


def test_h2o_config_and_params_cross_the_bridge(h2o):
    """Every field the port's config has equals the reference's, for the
    full and the smoke config, and the reference's parameters cross the
    bridge into the port's tree as they are (no new parameter kind)."""
    tcfg, tparams, ref = h2o
    for smoke in (False, True):
        t, j = get_config(H2O, smoke), jax_get_config(H2O, smoke)
        for f in t.__dataclass_fields__:
            if f != "quant":
                assert getattr(t, f) == getattr(j, f), f
    want = _shapes(ref["params"])
    got = _shapes(tparams)
    defs = {p: tuple(d.shape) for p, d in
            _shapes_defs(ttr.model_defs(tcfg)).items()}
    assert got == want == defs


def _shapes_defs(defs, path=()):
    out = {}
    for k, v in defs.items():
        if isinstance(v, dict):
            out.update(_shapes_defs(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _close(got, want, rel=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all() and got.shape == want.shape
    tol = rel * float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def test_h2o_train_forward_matches_reference(h2o):
    """``h2o_reference``'s forward: jit-scaled moss GEMMs, the window
    mask through the chunked attention."""
    tcfg, tparams, ref = h2o
    with torch.no_grad():
        got, _, _ = ttr.forward(
            tcfg, tcfg.quant,
            wrap_qt_nojit(tparams, quant_mask_tree(ttr.model_defs(tcfg))),
            torch.from_numpy(TOKENS), mode="train")
    _close(got, ref["forward"])


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_h2o_prefill_step_matches_reference(h2o, kv_dtype):
    """``h2o_reference``'s prefill step.  (The calibrated activation
    scales are the engine's, held in tests/test_torch_serving.py.)"""
    tcfg, tparams, ref = h2o
    tcfg = tcfg.replace(kv_cache_dtype=kv_dtype)
    ref = ref[kv_dtype]
    tp = tsteps.prequantize_params(tcfg, tparams)
    tl, tc = tsteps.make_prefill_step(tcfg, 128, scales=tp.scales)(
        tp.qweights, torch.from_numpy(TOKENS), 96)
    _close(tl, ref["logits"])
    got = tc["blocks"]
    assert int(got.idx) == 100 and got.k.shape[3] == 64
    np.testing.assert_array_equal(ref["idx"], 100)
    if kv_dtype == "fp8":
        for name in ("k", "v", "k_scale", "v_scale"):
            _same_bits(getattr(got, name), ref[name])
    else:
        for name in ("k", "v"):
            g = getattr(got, name).float().numpy()
            w = ref[name].astype(np.float32)
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all()


def test_decode_past_the_window_matches_a_fresh_forward():
    """The analogue of the reference's
    tests/test_serving.py::test_swa_ring_cache_window_equivalence: with
    a 32-slot ring, decoding past the window matches the train-mode
    forward of the whole sequence (within 0.1 · max|logit|, the
    reference's own limit: bf16 K/V through the cache against the
    forward's)."""
    cfg = get_config(H2O, smoke=True).replace(
        quant=BF16_CONFIG, window=32, kv_cache_dtype="bf16")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import init_tree as tinit

    params = tinit(ttr.model_defs(cfg), gen, "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                          (1, 64)),
                        dtype=torch.int32)
    with torch.no_grad():
        full, _, _ = ttr.forward(
            cfg, cfg.quant,
            wrap_qt_nojit(params, quant_mask_tree(ttr.model_defs(cfg))),
            toks, mode="train")
    scale = float(full.abs().max())
    _, caches = tsteps.make_prefill_step(cfg, 64)(params, toks[:, :48])
    dec = tsteps.make_decode_step(cfg)
    for i in range(8):
        lo, caches = dec(params, caches, toks[:, 48 + i:49 + i])
        err = float((lo[:, 0] - full[:, 48 + i]).abs().max()) / scale
        assert err < 0.1, (i, err)


# --- the engine's identity placement and the legacy Server ---------------


def _params(arch):
    params = init_tree(jtr.model_defs(jax_get_config(arch, smoke=True)),
                       jax.random.PRNGKey(0))
    return bridge.tree_to_torch(jax.tree.map(np.asarray, params),
                                device="cpu")


def _requests(lens, max_new, seed=2):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                    max_new=max_new) for i, n in enumerate(lens)]


def _serve(monkeypatch, cfg, params, lens, slots, max_len, max_new=4,
           **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reqs = _requests(lens, max_new)
    eng = Engine(cfg, params, num_slots=slots, max_len=max_len,
                 chunk_tokens=8, device="cpu")
    eng.run(reqs, log=None)
    assert all(r.done for r in reqs) and not eng.kv.rows
    return eng, [r.out for r in reqs]


@pytest.mark.parametrize("chunked", ["1", "0"])
def test_identity_streams_equal_float_streams(monkeypatch, chunked):
    """phi3 smoke in its serving default (moss, fp8 cache): identity
    rows and floating pages hold the same bytes and run one attention
    order, so the streams are equal, chunked and whole-prompt."""
    cfg, params = get_config(PHI3, smoke=True), _params(PHI3)
    lens = [7, 19, 3, 12]
    outs = {}
    for placement in ("float", "identity"):
        eng, outs[placement] = _serve(
            monkeypatch, cfg, params, lens, 2, 32,
            REPRO_PAGED_PLACEMENT=placement, REPRO_CHUNKED_PREFILL=chunked)
        assert eng.float_pages == (placement == "float")
        assert eng.chunked == (chunked == "1")
    assert outs["identity"] == outs["float"]


@pytest.mark.parametrize("placement", ["float", "identity"])
def test_chunked_prefill_equals_whole_prompt_in_bf16(monkeypatch,
                                                      placement):
    """The reference's tests/test_chunked_prefill.py::
    test_chunked_placements_agree on the port: in bf16 (weights and
    cache) the chunked and the whole-prompt prefill give equal
    streams."""
    cfg = get_config(PHI3, smoke=True).replace(quant=BF16_CONFIG,
                                               kv_cache_dtype="bf16")
    params = _params(PHI3)
    outs = [_serve(monkeypatch, cfg, params, [7, 19], 2, 32,
                   REPRO_PAGED_PLACEMENT=placement,
                   REPRO_CHUNKED_PREFILL=chunked)[1]
            for chunked in ("1", "0")]
    assert outs[0] == outs[1]


def test_windowed_mixed_depth_equals_solo(monkeypatch):
    """h2o smoke at window 16 (identity rows, whole-prompt prefill, the
    ring): depths cross the window mid-decode and one prompt starts past
    it; every request's stream equals its solo stream."""
    cfg = get_config(H2O, smoke=True).replace(window=16)
    params = _params(H2O)
    lens = [5, 12, 20, 9, 14]
    eng, mixed = _serve(monkeypatch, cfg, params, lens, 3, 48, max_new=8)
    assert not eng.float_pages and not eng.chunked and eng.kv.ring
    assert eng.kv.slot_tokens == 16
    _, solo = _serve(monkeypatch, cfg, params, lens, 1, 48, max_new=8)
    assert mixed == solo


def test_legacy_server_mixed_depth_equals_solo():
    """The reference's tests/test_paged_serving.py::
    test_legacy_server_mixed_depth_correct on the port: a refill shorter
    than the incumbents keeps their depths."""
    cfg = get_config(PHI3, smoke=True).replace(quant=BF16_CONFIG,
                                               kv_cache_dtype="bf16")
    params = _params(PHI3)
    reqs = _requests([17, 11, 6, 14], 5)
    Server(cfg, params, batch_slots=2, max_len=32, device="cpu").run(
        list(reqs), log=None)
    assert all(r.done and len(r.out) == 5 for r in reqs)
    for r in reqs:
        solo = Request(rid=100 + r.rid, prompt=r.prompt, max_new=5)
        Server(cfg, params, batch_slots=1, max_len=32, device="cpu").run(
            [solo], log=None)
        assert r.out == solo.out, (r.rid, r.out, solo.out)
