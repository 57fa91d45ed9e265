"""The port's model against the reference on the same weights.

The reference's smoke-size phi3-mini parameters (2 layers, d 128) cross
into the port through ``repro_torch.bridge``; both packages pre-quantize
them and run on the CPU.

- Calibration: the port's delayed activation scales against the
  reference's.  The level-1 scale agrees within rel 1e-2 and the E8M0
  exponents agree in >= 99% of groups, never more than one step apart:
  the calibration forward's activations differ by bf16 rounding flips
  (f32 sums taken in another order), which can move an amax across a
  power of two.
- Serving steps: one chunked-prefill step and three decode steps on a
  fully backed floating page pool, with the reference's calibrated
  scales carried across so both quantize against the same grid.
  Logits agree within 2e-2 * max|logit|: bf16 rounding after f32 sums
  taken in another order, and the rare fp8 rounding flip it causes.

The reference's steps run op by op (``jax.disable_jit()``).  Compiled,
XLA may keep an intermediate in f32 where the code rounds it to bf16
(``xla_allow_excess_precision`` is on by default), which on this smoke
model moves the reference's own logits by up to ~10% of their range
against its op-by-op evaluation.  The port implements the code as
written: every bf16 cast rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.actscale import calibrate_act_scales as jax_calibrate
from repro.models import transformer as jtr
from repro.models.layers import init_tree
from repro.train import steps as jsteps

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.actscale import calibrate_act_scales
from repro_torch.models import transformer as ttr
from repro_torch.train import steps as tsteps

ARCH = "phi3-mini-3.8b"
MAX_LEN, PAGE, CHUNK = 64, 16, 16


@pytest.fixture(scope="module")
def both():
    """(jax cfg, jax serving trees, port cfg, port serving trees)."""
    jcfg = jax_get_config(ARCH, smoke=True)
    params = init_tree(jtr.model_defs(jcfg), jax.random.PRNGKey(0))
    jp = jsteps.prequantize_params(jcfg, params)
    jact = jax_calibrate(jcfg, jp.qweights, jp.scales)
    tcfg = get_config(ARCH, smoke=True)
    tp = tsteps.prequantize_params(
        tcfg, bridge.tree_to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"))
    return jcfg, jp, jact, tcfg, tp


def test_calibrated_act_scales_match(both):
    jcfg, jp, jact, tcfg, tp = both
    tact = calibrate_act_scales(tcfg, tp.qweights, tp.scales)
    assert sorted(tact) == sorted(jact)
    n = same = 0
    for tag, ja in jact.items():
        ta = tact[tag]
        np.testing.assert_allclose(ta.s.numpy(), np.asarray(ja.s),
                                   rtol=1e-2)
        je = np.asarray(ja.sub).astype(np.int32)
        te = ta.sub.numpy().astype(np.int32)
        assert te.shape == je.shape
        assert np.abs(te - je).max() <= 1, tag
        n += je.size
        same += int((te == je).sum())
    assert same >= 0.99 * n, (same, n)


def _jax_stamp(caches, depth, pages, pps, n_pages):
    bt = np.full((1, pps), n_pages, np.int32)
    bt[0, :len(pages)] = pages

    def stamp(node):
        n_l = node.idx.shape[0]
        return node._replace(
            idx=jnp.full((n_l, 1), depth, jnp.int32),
            block_table=jnp.asarray(np.broadcast_to(bt, (n_l, 1, pps))))

    return {k: jtr.map_cache_nodes(v, stamp) for k, v in caches.items()}


def _torch_stamp(caches, depth, pages, pps, n_pages):
    bt = np.full((1, pps), n_pages, np.int32)
    bt[0, :len(pages)] = pages
    return {k: v._replace(idx=torch.tensor([depth], dtype=torch.int32),
                          block_table=torch.from_numpy(bt))
            for k, v in caches.items()}


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_chunk_prefill_and_decode_logits_match(both, kv_dtype):
    jcfg, jp, jact, tcfg, tp = both
    jcfg = jcfg.replace(kv_cache_dtype=kv_dtype)
    tcfg = tcfg.replace(kv_cache_dtype=kv_dtype)
    tact = bridge.act_scales_to_torch(
        {k: (np.asarray(a.s), np.asarray(a.sub)) for k, a in jact.items()},
        device="cpu")
    jstep = jsteps.make_decode_step(jcfg, scales=jp.scales,
                                    act_scales=jact)
    tstep = tsteps.make_decode_step(tcfg, scales=tp.scales,
                                    act_scales=tact)
    n_pages = MAX_LEN // PAGE
    pps = MAX_LEN // PAGE
    pages = [2, 0, 3, 1]                       # a scrambled table
    jc = jtr.init_paged_pools(jcfg, MAX_LEN, n_pages, PAGE)
    tc = ttr.init_paged_pools(tcfg, MAX_LEN, n_pages, PAGE, "cpu")

    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, 13)
    toks = np.zeros((1, CHUNK), np.int32)
    toks[0, :len(prompt)] = prompt
    depth = 0
    feed = toks
    for step in range(4):
        jc = _jax_stamp(jc, depth, pages, pps, n_pages)
        tc = _torch_stamp(tc, depth, pages, pps, n_pages)
        with jax.disable_jit():
            jl, jc = jstep(jp.qweights, jc, jnp.asarray(feed))
        tl, tc = tstep(tp.qweights, tc, torch.from_numpy(feed))
        jl = np.asarray(jl, np.float32)
        tl = tl.numpy()
        live = slice(0, len(prompt)) if step == 0 else slice(0, 1)
        jl, tl = jl[:, live], tl[:, live]
        assert np.isfinite(tl).all() and tl.shape == jl.shape
        tol = 2e-2 * float(np.abs(jl).max())
        assert np.abs(tl - jl).max() <= tol, (step, np.abs(tl - jl).max())
        depth += len(prompt) if step == 0 else 1
        nxt = int(np.argmax(jl[0, -1]))
        feed = np.array([[nxt]], np.int32)
