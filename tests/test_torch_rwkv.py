"""rwkv6's pieces in the port against the reference, on the CPU: the
chunked WKV recurrence (``_wkv_chunked``, chunks of 16, zero padding of
a partial chunk, the state carried across chunks), its one-token update
(``_wkv_step``), the per-head group norm, the data-dependent token shift
(``ddlerp``), the sinusoidal positions of musicgen, the whole rwkv6
block over a prompt and then one decode token, and the engine's streams
at mixed depths against each request served alone.

The reference's side comes from the shared child of
tests/test_torch_train.py (``rwkv_units_reference``, one part of
tests/test_torch_archs.py's ``archs_parts``), jitted with its
``REFERENCE_XLA_FLAGS``.  Limits, with the values measured on a CPU:

- the WKV against the reference: within 1e-5 * max|ref| (f32 sums in
  another order: the port's einsums against XLA's dots; measured up to
  3.7e-7);
- the WKV chunked against its own one-token updates: the reference's
  own test's limit, rtol = atol = 2e-4 (tests/test_training.py;
  measured up to 4.4e-7 of max|y|);
- the group norm: within 1e-6 * max|ref| (the port's rsqrt is the
  correctly rounded one, XLA's is off by an ulp in ~14% of inputs;
  measured 8.7e-8); means and variances in XLA's order;
- ``ddlerp``'s mixes and ``sinusoidal_embedding``: bitwise;
- the block (bf16 outputs and shift states): bitwise where measured so,
  else as stated in the test; the f32 WKV state within 1e-5 * max|ref|;
- the engine at mixed depths: streams equal to the solo streams (the
  port alone, bf16, the twin of tests/test_paged_serving.py's
  ``test_mixed_depth_parity_recurrent_arch``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtr

from repro_torch.configs.registry import get_config
from repro_torch.core.formats import QuantConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import init_tree, quant_mask_tree, wrap_qt_nojit
from repro_torch.serving import Engine, Request

from test_torch_recipes import _same
from test_torch_train import shared_reference

RWKV = "rwkv6-3b"
WKV_LENGTHS = (16, 37)          # a whole chunk; two and a padded third
BLOCK_PROMPT = 9


def _x(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return np.asarray(x, np.float32)


def _wkv_problem(t, seed=0):
    """r, k, v, lw (2, t, 2, 64), u (2, 64) and a non-zero S0."""
    rng = np.random.default_rng(seed + t)
    b, h, dh = 2, 2, 64
    r, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, t, h, dh)) * 0.5 - 1.0)
    lw = np.clip(lw, -5.0, -1e-4).astype(np.float32)
    u = (rng.standard_normal((h, dh)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dh, dh)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


def _block_problem(cfg, seed=5):
    """One rwkv6 block's smoke parameters (the reference's initializers
    from ``PRNGKey(seed)``), a prompt (2, BLOCK_PROMPT, d) and one
    decode token (2, 1, d)."""
    p = jax.tree.map(np.asarray, jlayers.init_tree(
        jtr._rwkv_unit(cfg), jax.random.PRNGKey(seed)))
    return (p, _x((2, BLOCK_PROMPT, cfg.d_model), seed + 1),
            _x((2, 1, cfg.d_model), seed + 2))


SIN_D, SIN_POS = 1536, np.array([[3], [17], [40]], np.int32)


def rwkv_units_reference() -> dict:
    """The reference's side of this module's tests, as numpy (in the
    shared child)."""
    from repro.core.linear import qlinear as jqlinear
    from repro.models.layers import quant_mask_tree as jmask
    from repro.models.layers import wrap_qt_nojit as jwrap

    out = {"wkv": {t: [np.asarray(a) for a in jax.jit(jrwkv._wkv_chunked)(
        *_wkv_problem(t))] for t in WKV_LENGTHS}}
    y = _x((2, 7, 2, 64), 3, 3.0) + 1.0
    out["group_norm"] = np.asarray(jax.jit(jrwkv._group_norm)(
        y, _x((128,), 4), _x((128,), 5)))
    out["sin"] = [np.asarray(jax.jit(lambda: jlayers.sinusoidal_embedding(
        jnp.arange(40, dtype=jnp.int32), SIN_D))()),
        np.asarray(jax.jit(lambda p: jlayers.sinusoidal_embedding(
            p, SIN_D))(SIN_POS))]
    cfg = jax_get_config(RWKV, smoke=True)
    out["ddlerp"], out["block"] = {}, {}
    for mode in ("moss", "bf16"):
        jcfg = cfg.replace(quant=type(cfg.quant)(mode=mode))
        p, x, xd = _block_problem(jcfg)
        unit = jwrap(p, jmask(jtr._rwkv_unit(jcfg)))

        @jax.jit
        def mix(p_tm, x, x_prev, jcfg=jcfg):
            # the reference's ddlerp, rwkv6.py's time_mix up to its
            # projections (it has no function of its own there)
            b, s, _ = x.shape
            xx = (jrwkv._token_shift(x, x_prev) - x).astype(jnp.float32)
            xxx = x.astype(jnp.float32) + xx * jrwkv._raw(p_tm["mu_base"])
            lora = jnp.tanh(jqlinear(xxx.astype(x.dtype), p_tm["ddlerp_w1"],
                                     jcfg.quant).astype(jnp.float32))
            lora = lora.reshape(b, s, len(jrwkv._MIX), jcfg.ddlerp_rank)
            offs = jnp.einsum("bsmr,mrd->bsmd", lora, jrwkv._raw(
                p_tm["ddlerp_w2"]).astype(jnp.float32))
            return [(x.astype(jnp.float32)
                     + xx * (jrwkv._raw(p_tm["mu"])[i] + offs[:, :, i]))
                    .astype(x.dtype) for i in range(len(jrwkv._MIX))]

        xb = jnp.asarray(x, jnp.bfloat16)
        prev = jnp.asarray(xd[:, 0], jnp.bfloat16)
        out["ddlerp"][mode] = [np.asarray(a) for a in mix(unit["tm"], xb,
                                                           prev)]

        @jax.jit
        def block(unit, x, xd, jcfg=jcfg):
            pos = jnp.arange(x.shape[1], dtype=jnp.int32)
            y, st, _ = jtr._rwkv_apply(jcfg, jcfg.quant, unit, x, pos, None,
                                       "prefill")
            yd, st2, _ = jtr._rwkv_apply(jcfg, jcfg.quant, unit, xd,
                                         pos[:1], st, "decode")
            return y, st.x_tm, st.x_cm, st.S, yd, st2.x_tm, st2.x_cm, st2.S

        out["block"][mode] = [np.asarray(a) for a in block(
            unit, xb, jnp.asarray(xd, jnp.bfloat16))]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return shared_reference(tmp_path_factory)["archs"]["rwkv_units"]


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)
    return err


# --- the port alone (ahead of the tests that wait for the child) -----------

@pytest.mark.parametrize("t", WKV_LENGTHS)
def test_wkv_chunked_matches_its_own_steps(t):
    """``_wkv_chunked`` from a non-zero state against t one-token
    updates (``_wkv_step``, the decode path) from the same state: the
    outputs and the last state within the reference's own limit
    (rtol = atol = 2e-4)."""
    args = [torch.tensor(a) for a in _wkv_problem(t)]
    r, k, v, lw, u, s0 = args
    y, s_last = trwkv._wkv_chunked(*args)
    s, ys = s0, []
    for i in range(t):
        yi, s = trwkv._wkv_step(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                                lw[:, i:i + 1], u, s)
        ys.append(yi)
    np.testing.assert_allclose(y.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s_last.numpy(), s.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_engine_mixed_depths_equal_solo_runs():
    """rwkv6's smoke model in bf16 on the port's engine: identity rows,
    the exact-length prefill (``prompt_bucket`` 1: padding would enter
    the recurrence), three requests of 6, 9 and 11 tokens on 2 slots, so
    that a request is admitted beside one at another depth; each stream
    equals the request served alone."""
    cfg = get_config(RWKV, smoke=True).replace(quant=QuantConfig(mode="bf16"))
    params = init_tree(ttr.model_defs(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (6, 9, 11)]

    def serve(ps, slots):
        eng = Engine(cfg, params, num_slots=slots, max_len=32, device="cpu")
        assert eng.prompt_bucket == 1 and not eng.float_pages
        reqs = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(ps)]
        eng.run(reqs, log=None)
        return [r.out for r in reqs]

    mixed = serve(prompts, 2)
    assert mixed == [serve([p], 1)[0] for p in prompts]


# --- against the reference ---------------------------------------------------

@pytest.mark.parametrize("t", WKV_LENGTHS)
def test_wkv_chunked_matches_reference(reference, t):
    """The chunked WKV over 16 positions and over 37 (two chunks and a
    third padded with zeros), from a non-zero S0: y and the last state
    within 1e-5 * max|ref| (measured: 3.7e-7 and 9.3e-10 at 16, 2.4e-7
    and 4.8e-8 at 37)."""
    y, s = trwkv._wkv_chunked(*(torch.tensor(a) for a in _wkv_problem(t)))
    wy, ws = reference["wkv"][t]
    _close(y, wy, 1e-5)
    _close(s, ws, 1e-5)


def test_group_norm_and_sinusoidal_positions_match_reference(reference):
    """rwkv's per-head group norm (eps 64e-5) within 1e-6 * max|ref|
    (measured 8.7e-8: XLA's rsqrt), and musicgen's sinusoidal positions
    at full width (d 1536) for the training positions 0..39 and for three
    decode slots at other depths: bitwise."""
    y = _x((2, 7, 2, 64), 3, 3.0) + 1.0
    got = trwkv._group_norm(torch.tensor(y), torch.tensor(_x((128,), 4)),
                            torch.tensor(_x((128,), 5)))
    _close(got, reference["group_norm"], 1e-6)
    train, dec = reference["sin"]
    _same(train, tlayers.sinusoidal_embedding(torch.arange(40), SIN_D))
    _same(dec, tlayers.sinusoidal_embedding(torch.tensor(SIN_POS), SIN_D))


def _unit(cfg, p):
    return wrap_qt_nojit({k: {kk: torch.tensor(vv) for kk, vv in v.items()}
                          for k, v in p.items()},
                         quant_mask_tree(ttr._rwkv_unit(cfg)))


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_ddlerp_matches_reference(reference, mode):
    """The data-dependent token shift over a 9-token prompt after a
    non-zero previous token: the five bf16 mixes (r, k, v, w, g) bitwise
    the reference's (XLA's tanh, the FMA of ``x + xx * m``)."""
    cfg = get_config(RWKV, smoke=True).replace(quant=QuantConfig(mode=mode))
    p, x, xd = _block_problem(cfg)
    unit = _unit(cfg, p)
    with torch.no_grad():
        _, mixed = trwkv.ddlerp(cfg, unit["tm"], torch.tensor(x).bfloat16(),
                                torch.tensor(xd[:, 0]).bfloat16(), cfg.quant)
    for want, name in zip(reference["ddlerp"][mode], trwkv._MIX):
        _same(want, mixed[name])


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_block_prefill_then_decode_matches_reference(reference, mode):
    """rwkv6's block (LayerNorms, the time mix, the channel mix) over a
    9-token prompt from a zero state, then one decode token from the
    state it left: the bf16 outputs and shift states bitwise, the f32
    WKV states within 1e-5 * max|ref|."""
    cfg = get_config(RWKV, smoke=True).replace(quant=QuantConfig(mode=mode))
    p, x, xd = _block_problem(cfg)
    unit = _unit(cfg, p)
    pos = torch.arange(BLOCK_PROMPT, dtype=torch.int32)
    with torch.no_grad():
        y, st, _ = ttr._rwkv_apply(cfg, cfg.quant, unit,
                                   torch.tensor(x).bfloat16(), pos, None,
                                   "prefill")
        yd, st2, _ = ttr._rwkv_apply(cfg, cfg.quant, unit,
                                     torch.tensor(xd).bfloat16(), pos[:1],
                                     st, "decode")
    got = (y, st.x_tm, st.x_cm, st.S, yd, st2.x_tm, st2.x_cm, st2.S)
    for w, g in zip(reference["block"][mode], got):
        if g.dtype == torch.float32:
            _close(g, w, 1e-5)
        else:
            _same(w, g)
    assert int(st2.idx) == BLOCK_PROMPT + 1
