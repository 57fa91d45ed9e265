"""The port's quantizers against the reference's, bitwise.

Same numpy inputs through ``repro`` (JAX, CPU) and ``repro_torch``
(CPU): fp8 payloads, int8 E8M0 exponents and f32 scales must agree bit
for bit.  Inputs carry what stresses a quantizer: the quickstart
activation (gaussian body, sparse x301 outliers), all-zero groups and
tiny-magnitude groups (the zero-denominator guard)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import formats as jf
from repro.core import quant as jq
from repro.models import attention as jattn
from repro.models.layers import init_tree
from repro.models.transformer import model_defs as jax_model_defs
from repro.train import steps as jsteps

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import formats as tf
from repro_torch.core import quant as tq
from repro_torch.models import attention as tattn
from repro_torch.train import steps as tsteps


def _bits(x) -> np.ndarray:
    """Raw bits of a JAX or numpy array."""
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    b = bridge.bits(t)
    return b.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[b.itemsize])


def _same(j, t):
    np.testing.assert_array_equal(_bits(j), _tbits(t))


def _inputs(name: str, shape=(64, 256)) -> np.ndarray:
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    if name == "quickstart":
        # the quickstart tensor: gaussian body + sparse strong outliers
        x = x * (1 + 300.0 * (rng.random(shape) < 0.002))
    elif name == "zero_groups":
        x[:, 32:96] = 0.0
        x[5] = 0.0
    elif name == "tiny_groups":
        x[:, :32] *= 1e-38          # subnormal-range groups
        x[:, 64:96] *= 1e-20
        x[..., 1, 200 % shape[-1]:232 % shape[-1] or None] = 1e-45
    elif name == "all_tiny":
        x = x * 1e-30
    return x.astype(np.float32)


CASES = ["quickstart", "zero_groups", "tiny_groups", "all_tiny"]


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_cast_fp8(fmt):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096) * 100,
                        rng.standard_normal(1024) * 1e5,
                        rng.standard_normal(1024) * 1e-6,
                        [0.0, -0.0, 448.0, 464.0, -1e9, 57344.0, 6e4]]
                       ).astype(np.float32)
    _same(jf.cast_fp8(jnp.asarray(x), fmt), tf.cast_fp8(torch.tensor(x), fmt))


def test_e8m0_encode_decode_full_range():
    e = np.arange(-127, 128, dtype=np.int8)
    _same(jf.e8m0_decode(jnp.asarray(e)), tf.e8m0_decode(torch.tensor(e)))
    # exact powers of two, their neighbours, random ratios, zero
    r = np.concatenate([
        2.0 ** np.arange(-149, 1, dtype=np.float64),
        np.nextafter(2.0 ** np.arange(-126, 1, dtype=np.float32),
                     np.float32(1)),
        np.nextafter(2.0 ** np.arange(-126, 1, dtype=np.float32),
                     np.float32(0)),
        np.random.default_rng(1).random(20000), [0.0]]).astype(np.float32)
    _same(jf.e8m0_encode(jnp.asarray(r)), tf.e8m0_encode(torch.tensor(r)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quant_mx(case, fmt):
    x = _inputs(case)
    j = jq.quant_mx(jnp.asarray(x), 32, fmt)
    t = tq.quant_mx(torch.tensor(x), 32, fmt)
    _same(j.q, t.q)
    _same(j.sexp, t.sexp)
    _same(j.s, t.s)
    # and against a supplied level-1 scale
    s = np.float32(np.abs(x).max() / 448.0 * 1.7 + 1e-30)
    j = jq.quant_mx(jnp.asarray(x), 32, fmt, global_scale=jnp.float32(s))
    t = tq.quant_mx(torch.tensor(x), 32, fmt, global_scale=torch.tensor(s))
    _same(j.q, t.q)
    _same(j.sexp, t.sexp)


@pytest.mark.parametrize("case", CASES)
def test_quant_mx_delayed(case):
    x = _inputs(case)
    ref = jq.quant_mx(jnp.asarray(_inputs("quickstart")), 32, "e4m3")
    s = np.asarray(ref.s)
    sub = np.asarray(ref.sexp).max(axis=0)            # (K/32,) int8
    j = jq.quant_mx_delayed(jnp.asarray(x), jnp.asarray(s),
                            jnp.asarray(sub), 32, "e4m3")
    t = tq.quant_mx_delayed(torch.tensor(x), torch.tensor(s),
                            torch.tensor(sub), 32, "e4m3")
    _same(j.q, t.q)
    _same(j.sexp, t.sexp)


@pytest.mark.parametrize("case", CASES)
def test_quant_per_tensor(case):
    x = _inputs(case)
    j = jq.quant_per_tensor(jnp.asarray(x), "e4m3")
    t = tq.quant_per_tensor(torch.tensor(x), "e4m3")
    _same(j.q, t.q)
    _same(j.s, t.s)


@pytest.mark.parametrize("n_stacked", [0, 1, 2])
def test_prequant_weight(n_stacked):
    w = _inputs("quickstart", (4, 8, 32, 48))
    j = jq.prequant_weight(jnp.asarray(w), n_stacked)
    t = tq.prequant_weight(torch.tensor(w), n_stacked)
    _same(j[0], t[0])
    _same(j[1], t[1])


def test_quant_kv():
    x = _inputs("tiny_groups", (2, 4, 16, 32))
    x[1, 2, 3] = 0.0                     # a zero head vector
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    q_j, s_j = jattn._quant_kv(jx)
    q_t, s_t = tattn._quant_kv(bridge.to_torch(np.asarray(jx), device="cpu"))
    _same(q_j, q_t)
    _same(s_j, s_t)


def test_prequantize_params_whole_smoke_tree():
    jcfg = jax_get_config("phi3-mini-3.8b", smoke=True)
    params = init_tree(jax_model_defs(jcfg), jax.random.PRNGKey(0))
    jp = jsteps.prequantize_params(jcfg, params)
    tp = tsteps.prequantize_params(
        get_config("phi3-mini-3.8b", smoke=True),
        bridge.tree_to_torch(jax.tree.map(np.asarray, params),
                             device="cpu"))
    jq_leaves = jax.tree_util.tree_flatten_with_path(jp.qweights)[0]
    js_leaves = jax.tree_util.tree_flatten_with_path(jp.scales)[0]
    # 7 per-layer linears + the LM head are fp8; the rest stay raw
    assert sum(np.asarray(v).dtype.itemsize == 1 for _, v in jq_leaves) == 8
    for tree_t, leaves in ((tp.qweights, jq_leaves), (tp.scales, js_leaves)):
        for path, leaf in leaves:
            t = tree_t
            for p in path:
                t = t[p.key]
            assert t.dtype == bridge.to_torch(np.asarray(leaf),
                                             device="cpu").dtype, path
            _same(leaf, t)
