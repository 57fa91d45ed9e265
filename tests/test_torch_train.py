"""The port's training slice against the reference, on the CPU.

Inputs are made from a seed with numpy (or are the reference's own
weights and batches, carried across by ``repro_torch.bridge``) and go
through both packages.  The reference's side of the kernel, ``qmm``,
optimizer and train-step comparisons is computed once, in one child
process that compiles it with ``REFERENCE_XLA_FLAGS`` under
``REPRO_KERNELS=ref`` (compiled, it gives what it computes op by op,
at a fraction of the time).  Tolerances, with the values measured on a
CPU beside them:

- ``mx_dw_gemm``'s plain version against the reference dispatch's
  ``ref`` branch: the requant payload is bitwise and dW within
  1e-5 * max|ref| (measured 0); against the Pallas kernel in interpret
  mode, rel L2 < 1e-5 (measured ~2e-8).  Every product is exact in
  f32; only the order of the sums differs.
- ``qmm`` (the autograd Function) against ``jax.vjp`` of the reference
  ``qmm``: the saved residuals (q, sexp, s of x; q, s of w) are
  bitwise, y and dx within 1e-5 * max|ref|, dW within rel L2 1e-5.
- Automatic scaling, AdamW, the schedule: equal ``steps_since`` and
  f32-rounding agreement (rtol 1e-6) of s0, mu, nu and the parameters
  over 6 steps with refreshes every 2 steps and the learning rate
  changing every step.  The two cosines differ by an ulp at some steps.
- LayerNorm and ``ce_loss``: rel 1e-6.
- The olmo-7b smoke train step (2 layers, d 128), batch 2 x 64, three
  steps in moss and bf16 from the reference's ``init_train_state`` on
  the reference's batches, each held against the reference's step from
  the same state: see ``test_train_steps_match_reference``; the same
  for llama2-7b's smoke config (RMSNorm), with the same limits.

The child also computes the reference's side of
``tests/test_torch_recipes.py`` (``qmm`` and the train steps in the
per_group and per_tensor recipes), of tests/test_torch_ring.py's
model tests (``h2o_reference``: the sliding-window forward and prefill
step) and of tests/test_torch_moe.py (``moe_reference``: qmm_grouped,
the MoE block and its VJP, the MoE train steps); the modules share its
results (``reference``, ``shared_reference``).
"""

import fcntl
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import autoscale as jauto
from repro.core.formats import QuantConfig as JQuantConfig
from repro.core.linear import _qmm_fwd as jqmm_fwd
from repro.core.linear import qmm as jqmm
from repro.core.quant import MxQ as JMxQ
from repro.core.quant import quant_mx as jquant_mx
from repro.core.quant import quant_per_tensor as jquant_per_tensor
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import dispatch as jdispatch
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import steps as jsteps

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import autoscale as tauto
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, qlinear, qmm
from repro_torch.core.quant import quant_mx, quant_per_tensor
from repro_torch.core.tree import tree_map
from repro_torch.kernels import dispatch, mx_bwd
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule
from repro_torch.train import steps as tsteps

ARCH = "olmo-7b"
# the paper's other dense arch (RMSNorm where olmo-7b has LayerNorm)
LLAMA2 = "llama2-7b"
# the baseline recipes train with just-in-time weight scales
# (``repro.launch.train.quant_from_name``)
BASELINES = ("per_group", "per_tensor")
MODES = ("moss", "bf16") + BASELINES


def recipe(mode: str) -> dict:
    """QuantConfig fields of ``mode`` as the training CLIs set them."""
    return {"mode": mode,
            "weight_scaling": "jit" if mode in BASELINES else "auto"}


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _close_max(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol, \
        (float(np.abs(got - want).max()), tol)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaf_items(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x *= 1 + 100.0 * (rng.random((m, k)) < 0.002)
    x[0, :32] = 0.0                         # an all-zero group
    return x


# --- the reference, compiled in a child process ---------------------------

# the reference compiled as it computes op by op: XLA's algebraic
# simplifier rewrites the quantizers' arithmetic and flips fp8 roundings
# (the moss smoke gradient norm moves by ~1%), and excess precision
# keeps bf16 intermediates in f32
REFERENCE_XLA_FLAGS = ("--xla_allow_excess_precision=false "
                       "--xla_disable_hlo_passes=algsimp")


def _reference_child(out: str) -> None:
    """What the reference computes for this module's tests and for
    tests/test_torch_recipes.py, test_torch_ring.py and
    test_torch_moe.py, compiled with ``REFERENCE_XLA_FLAGS`` under
    ``REPRO_KERNELS=ref``, pickled."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_moe import moe_reference
    from test_torch_ring import h2o_reference

    # the MoE references (the longest part) in a second thread: XLA
    # compiles and runs with the GIL released, and no builder touches
    # global state, so the two halves overlap and give the same results
    with ThreadPoolExecutor(max_workers=1) as pool:
        moe = pool.submit(moe_reference)
        ref = {"dw": {case: _dw_reference(*case) for case in DW_CASES},
               "h2o": h2o_reference(),
               "optimizer": _optimizer_reference(),
               "train": _train_runs(),
               "llama2": _train_runs(LLAMA2, ("moss", "bf16")),
               "qmm": {(mode, i): _qmm_reference(mode, *shape)
                       for mode in MODES
                       for i, shape in enumerate(QMM_SHAPES)}}
        ref["moe"] = moe.result()
    with open(out, "wb") as f:
        pickle.dump(ref, f)


def shared_reference(tmp_path_factory) -> dict:
    """``_reference_child``'s results, from one child process per test
    run (the XLA flags take effect only before the backend starts).
    Under pytest-xdist the workers share it through the run's common
    temporary directory: the first to take the lock runs the child."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "torch_reference.pkl"
    with open(base / "torch_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            env = dict(os.environ)
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                                + REFERENCE_XLA_FLAGS).strip()
            env["JAX_PLATFORMS"] = "cpu"
            env["REPRO_KERNELS"] = "ref"
            env.pop("REPRO_MOE_EXPERTS", None)
            src = str(Path(__file__).resolve().parent.parent / "src")
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            part = out.with_suffix(".part")
            subprocess.run([sys.executable, __file__, str(part)], env=env,
                           check=True, timeout=900)
            os.replace(part, out)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``shared_reference``, once per module."""
    return shared_reference(tmp_path_factory)


# --- mx_dw_gemm ------------------------------------------------------------

DW_CASES = [(128, 256, None), (128, 512, None), (256, 256, None),
            (256, 512, None), (128, 224, 200)]    # (m, k, out_rows)


def _dw_problem(m, k, out_rows):
    x = _x(m, k, m + k)
    if out_rows is not None:
        x[:, out_rows:] = 0.0               # the forward's K padding
    g = (np.random.default_rng(k).standard_normal((m, 192)) * 0.1
         ).astype(np.float32)
    return x, g


def _dw_reference(m, k, out_rows):
    """The reference's x payload, the requant payload of its ``ref``
    branch (``quant_mx`` of the dequantized residual's transpose at
    global scale 1), and dW from its ``ref`` branch and from its Pallas
    kernel in interpret mode, as numpy (in the child)."""
    @jax.jit
    def run(x, g):
        jxq, jgq = jquant_mx(x), jquant_per_tensor(g, "e5m2")
        one = jnp.float32(1.0)
        jx_unit = JMxQ(jxq.q, jxq.sexp, one).dequant(jnp.float32)
        jxt = jquant_mx(jx_unit.T, 32, "e4m3", global_scale=one)
        return (jxq.q, jxt.q, jxt.sexp,
                jdispatch.mx_matmul_dw(jxq, jgq, out_rows=out_rows,
                                       backend="ref"),
                jdispatch.mx_matmul_dw(jxq, jgq, out_rows=out_rows,
                                       backend="interpret"))

    return [np.asarray(a) for a in run(*_dw_problem(m, k, out_rows))]


@pytest.mark.parametrize("m,k,out_rows", DW_CASES)
def test_mx_dw_gemm_plain_matches_reference(reference, m, k, out_rows):
    x, g = _dw_problem(m, k, out_rows)
    jq, jtq, jtsexp, want, pallas = reference["dw"][m, k, out_rows]
    xq, gq = quant_mx(torch.tensor(x)), quant_per_tensor(torch.tensor(g),
                                                         "e5m2")
    np.testing.assert_array_equal(bridge.bits(xq.q), jq.view(np.uint8))
    xt = mx_bwd.requant_m(xq.q, xq.sexp, "e4m3")
    np.testing.assert_array_equal(bridge.bits(xt.q), jtq.view(np.uint8))
    np.testing.assert_array_equal(xt.sexp.numpy(), jtsexp)
    got = dispatch.mx_matmul_dw(xq, gq, out_rows=out_rows)
    assert got.shape == (out_rows or k, g.shape[1])
    _close_max(got, want)
    assert _rel_l2(got, pallas) < 1e-5


def test_mx_dw_gemm_refuses_what_it_cannot_take():
    xq = quant_mx(torch.tensor(_x(64, 64, 0)))
    g = quant_per_tensor(torch.ones(64, 8), "e5m2").q
    with pytest.raises(ValueError):
        mx_bwd.mx_dw_gemm(xq.q[:40], xq.sexp[:40], g[:40])   # M % 32
    with pytest.raises(TypeError):
        mx_bwd.mx_dw_gemm(xq.q.float(), xq.sexp, g)


# --- qmm: forward and backward --------------------------------------------

# ragged M and N; ragged K; lead dims (the tests/test_dispatch.py matrix)
QMM_SHAPES = [((96, 384), 160), ((96, 200), 72), ((2, 48, 200), 40)]


def _qmm_problem(xshape, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xshape).astype(np.float32)
    x *= 1 + 100.0 * (rng.random(xshape) < 0.002)
    w = (rng.standard_normal((xshape[-1], n)) * 0.05).astype(np.float32)
    g = rng.standard_normal((*xshape[:-1], n)).astype(np.float32)
    s = np.float32(np.abs(w).max() / np.float32(448.0))
    return x, w, g, s


def _qmm_reference(mode, xshape, n):
    """The reference's y, dx, dW and, in a quantized recipe, the fp8
    residuals its forward saves (x: q, sexp, s in moss, q, s in the
    baselines; w: q, s), as numpy (in the child)."""
    x, w, g, s = _qmm_problem(xshape, n)
    jcfg, s = JQuantConfig(**recipe(mode)), jnp.float32(s)

    @jax.jit
    def run(x, w, g):
        y, vjp = jax.vjp(lambda a, b: jqmm(jcfg, a, b, s), x, w)
        if mode == "bf16":
            return (y, *vjp(g))
        xq, wq, _ = jqmm_fwd(jcfg, x, w, s)[1]
        return (y, *vjp(g), *xq, wq.q, wq.s)

    return [np.asarray(a) for a in run(x, w, g)]


@pytest.mark.parametrize("xshape,n", QMM_SHAPES)
@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_qmm_vjp_matches_reference(reference, mode, xshape, n):
    x, w, g, s = _qmm_problem(xshape, n)
    y_ref, dx_ref, dw_ref, *res = reference["qmm"][
        mode, QMM_SHAPES.index((xshape, n))]
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = qmm(QuantConfig(mode=mode), tx, tw, torch.tensor(s))
    saved = y.grad_fn.saved_tensors
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.tensor(g))
    assert y.dtype == tx.dtype and dx.shape == tx.shape
    _close_max(y, y_ref)
    _close_max(dx, dx_ref)
    assert _rel_l2(dw, dw_ref) < 1e-5

    if mode == "bf16":
        assert [t.dtype for t in saved] == [torch.bfloat16] * 2
        return
    # only the fp8 residuals are saved, bitwise the reference's
    q, sexp, sx, wq, sw = saved
    assert q.dtype == torch.float8_e4m3fn and wq.dtype == torch.float8_e4m3fn
    assert sexp.dtype == torch.int8 and sx.numel() == sw.numel() == 1
    for got, want in zip(saved, res):
        np.testing.assert_array_equal(
            bridge.bits(got).reshape(-1),
            np.asarray(want).reshape(-1).view(bridge.bits(got).dtype))


def test_qmm_refuses_baseline_recipes():
    """Training takes the baseline recipes (tests/test_torch_recipes.py);
    their delayed-scale serving forward and its calibration do not."""
    from repro_torch.core.actscale import REC, ActScale

    x = torch.ones(4, 32)
    act = ActScale(s=torch.tensor(1.0), sub=None)
    for mode in BASELINES:
        cfg = QuantConfig(**recipe(mode))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            qlinear(x, QT(torch.ones(32, 8), torch.tensor(1.0), act), cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            REC.record("site", x, cfg)


# --- automatic scaling, AdamW, the schedule -------------------------------

def _assert_f32_close(got, want):
    """Within f32 rounding: 1e-6 relative, or 1e-6 of the tensor's
    largest magnitude for elements near 0 (an update that cancels a
    weight leaves its last bits to the order of the operations)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("weight_scaling", ["auto", "jit", "delayed"])
def test_autoscale_states_match_reference(weight_scaling):
    """The per-tensor ScaleState API, mapped over a small tree, against
    the reference's tree helpers: 6 steps, refresh every 2 (every step
    for jit and delayed scaling), a different lr at every step."""
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal((32,)).astype(np.float32)}}
    jcfg = JQuantConfig(weight_scaling=weight_scaling, rescale_interval=2)
    tcfg = QuantConfig(weight_scaling=weight_scaling, rescale_interval=2)
    js = jauto.tree_init_scale_states(jax.tree.map(jnp.asarray, tree), jcfg)
    ts = tree_map(lambda w: tauto.init_scale_state(w, tcfg),
                  bridge.tree_to_torch(tree, device="cpu"))
    for step, lr in enumerate([1e-3, 3e-3, 2e-4, 5e-3, 1e-3, 7e-4]):
        jp = jauto.tree_predicted_scales(js, jnp.float32(lr), jcfg)
        tp = tree_map(lambda st: tauto.predicted_scale(
            st, torch.tensor(lr), tcfg), ts)
        _assert_f32_close(tp["a"], jp["a"])
        _assert_f32_close(tp["b"]["c"], jp["b"]["c"])
        tree = jax.tree.map(lambda w: w + np.float32(lr) * np.sign(w), tree)
        js = jauto.tree_update_scale_states(
            js, jax.tree.map(jnp.asarray, tree), jcfg)
        ts = tree_map(lambda st, w: tauto.update_scale_state(st, w, tcfg),
                      ts, bridge.tree_to_torch(tree, device="cpu"))
        for jst, tst in ((js["a"], ts["a"]), (js["b"]["c"], ts["b"]["c"])):
            assert int(jst.steps_since) == tst.steps_since, step
            _assert_f32_close(tst.s0, jst.s0)


def _small_defs(PDef):
    """A tree with a stacked leaf (one scale per layer slice) and a flat
    one, in either package's ``PDef``."""
    return {"blocks": {"w": PDef((2, 24, 16), ("layers", "fsdp", None),
                                 quantized=True),
                       "ln": PDef((2, 16), ("layers", None))},
            "head": PDef((16, 40), ("fsdp", "vocab"), quantized=True)}


SCHEDULE = dict(peak_lr=1e-3, warmup_steps=2, total_steps=6)


def _optimizer_reference():
    """The reference's optimizer half over ``_small_defs``: per step the
    gradients it was given (from numpy), the lr, the predicted scales,
    the clipped norm, the parameters, the moments and the scale states
    after the step, as numpy (in the child)."""
    qj = JQuantConfig(rescale_interval=2)
    defs = _small_defs(jlayers.PDef)
    params = jlayers.init_tree(defs, jax.random.PRNGKey(1))
    init = jax.tree.map(np.asarray, params)
    s0, t = jsteps.init_scales(defs, params, qj)
    opt = jadamw.init_opt_state(params)

    @jax.jit
    def step(params, opt, s0, t, grads, i):
        lr = jschedule.cosine_with_warmup(i, **SCHEDULE)
        pred = jsteps.predicted_scales(s0, t, lr, qj)
        g, norm = jadamw.clip_by_global_norm(grads, 1.0)
        params, opt = jadamw.adamw_update(jadamw.AdamWConfig(), params, g,
                                          opt, i, lr)
        s0, t = jsteps.advance_scales(defs, s0, t, params, qj)
        return lr, pred, norm, params, opt, s0, t

    rng = np.random.default_rng(3)
    records = []
    for i in range(6):
        grads = jax.tree.map(lambda w: (rng.standard_normal(w.shape) * 0.3
                                        ).astype(np.float32), init)
        out = step(params, opt, s0, t, grads, jnp.int32(i))
        params, opt, s0, t = out[3:]
        records.append((grads, *jax.tree.map(np.asarray, out)))
    return init, records


def test_scales_adamw_and_schedule_trajectories_match(reference):
    """The train step's optimizer half over a small tree with a stacked
    leaf: the cosine schedule (warmup 2 of 6, so the lr changes every
    step), predicted scales, the global-norm clip, AdamW and the scale
    advance with a refresh every 2 steps; the same gradients (from
    numpy) go to both."""
    init, records = reference["optimizer"]
    qt = QuantConfig(rescale_interval=2)
    defs = _small_defs(tlayers.PDef)
    params = bridge.tree_to_torch(init, device="cpu")
    s0, t = tsteps.init_scales(defs, params, qt), tree_map(lambda _: 0,
                                                            params)
    opt = tadamw.init_opt_state(params)
    for step, (grads, jlr, jpred, jnorm, jparams, jopt, js0, jt) in \
            enumerate(records):
        lr = tschedule.cosine_with_warmup(step, **SCHEDULE)
        np.testing.assert_allclose(lr.numpy(), jlr, rtol=1e-6)
        _assert_trees_close(tsteps.predicted_scales(s0, t, lr, qt), jpred)
        g, norm = tadamw.clip_by_global_norm(
            bridge.tree_to_torch(grads, device="cpu"), 1.0)
        _assert_f32_close(norm, jnorm)
        params, opt = tadamw.adamw_update(tadamw.AdamWConfig(), params, g,
                                          opt, step, lr)
        s0, t = tsteps.advance_scales(defs, s0, t, params, qt)
        assert dict(_leaf_items(t)) == \
            {k: int(v) for k, v in _leaf_items(jt)}, step
        _assert_trees_close(s0, js0)
        _assert_trees_close(params, jparams)
        jopt = dict(_leaf_items(jopt))
        for name, got in _leaf_items(opt):
            _assert_f32_close(got.mu, jopt[name].mu)
            _assert_f32_close(got.nu, jopt[name].nu)


def _assert_trees_close(got, want):
    want = dict(_leaf_items(want))
    for name, leaf in _leaf_items(got):
        _assert_f32_close(leaf, want[name])


# --- LayerNorm, ce_loss ------------------------------------------------------

def test_layernorm_and_ce_loss_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tlayers.layernorm(torch.tensor(x).to(dt), torch.tensor(scale),
                                torch.tensor(bias))
        want = jlayers.layernorm(jnp.asarray(x).astype(jdt),
                                 jnp.asarray(scale), jnp.asarray(bias))
        np.testing.assert_allclose(_np(got.float()),
                                   np.asarray(want, np.float32), rtol=1e-6,
                                   atol=1e-6 if dt == torch.float32 else 0)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7))
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        got = ttr.ce_loss(None, torch.tensor(logits), torch.tensor(labels),
                          None if m is None else torch.tensor(m))
        want = jtr.ce_loss(None, jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the gradient through ce_loss (the max is held out of it)
    tl = torch.tensor(logits, requires_grad=True)
    ttr.ce_loss(None, tl, torch.tensor(labels)).backward()
    jg = jax.grad(lambda a: jtr.ce_loss(None, a, jnp.asarray(labels)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(_np(tl.grad), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)


def test_olmo_config_and_norm_defs_match_reference():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
              "head_dim", "norm", "act", "rope_theta", "remat"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    jsm, tsm = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    for f in ("n_layers", "d_model", "d_ff", "vocab", "head_dim",
              "attn_chunk", "remat"):
        assert getattr(jsm, f) == getattr(tsm, f), f
    jd = jtr.model_defs(jsm)
    td = ttr.model_defs(tsm)
    jflat = jax.tree_util.tree_flatten_with_path(
        jd, is_leaf=jlayers.is_pdef)[0]
    for path, d in jflat:
        node = td
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(d.shape), path
        assert (node.init, node.quantized) == (d.init, d.quantized), path


# --- the train step ----------------------------------------------------------

TRAIN_HP = dict(peak_lr=1e-3, warmup_steps=0, total_steps=3)
def _jax_state(ps):
    """A port state with numpy leaves as the reference's TrainState."""
    return jsteps.TrainState(
        params=tree_map(jnp.asarray, ps.params),
        opt=tree_map(lambda o: jadamw.OptState(jnp.asarray(o.mu),
                                               jnp.asarray(o.nu)), ps.opt),
        scale_s0=tree_map(jnp.asarray, ps.scale_s0),
        scale_t=tree_map(jnp.int32, ps.scale_t),
        comm_residual=None, step=jnp.int32(ps.step))


def _train_runs(arch=ARCH, modes=MODES):
    """Per mode, from the reference's ``init_train_state``: three port
    steps of ``arch``'s smoke config on the reference's batches, and
    before each the reference's step from the same state on the same
    batch, as ``[(state before, ref state after, ref metrics, port state
    after, port metrics)]`` with numpy leaves (in the child)."""
    jcfg0 = jax_get_config(arch, smoke=True)
    data = JSyntheticLM(JDataConfig(vocab=jcfg0.vocab, seq_len=64,
                                    global_batch=2, seed=0))
    batches = [jax.tree.map(np.asarray, data.batch_for_step(i))
               for i in range(3)]
    out = {}
    for mode in modes:
        jcfg = jcfg0.replace(quant=JQuantConfig(**recipe(mode),
                                                rescale_interval=2))
        hp = jsteps.TrainHParams(**TRAIN_HP)
        init = jax.tree.map(np.asarray, jax.jit(
            jsteps.init_train_state, static_argnums=(0, 1))(
                jcfg, hp, jax.random.PRNGKey(0)))
        jstep = jax.jit(jsteps.make_train_step(jcfg, hp))
        tcfg = get_config(arch, smoke=True).replace(
            quant=QuantConfig(**recipe(mode), rescale_interval=2))
        tstep = tsteps.make_train_step(tcfg, tsteps.TrainHParams(**TRAIN_HP))
        tst = bridge.train_state_to_torch(init, device="cpu")
        runs = []
        for b in batches:
            before = bridge.train_state_to_numpy(tst)
            rs, rm = jstep(_jax_state(before), b)
            tst, pm = tstep(tst, {k: torch.from_numpy(np.array(v))
                                  for k, v in b.items()})
            runs.append((before, jax.tree.map(np.asarray, rs),
                         {k: float(v) for k, v in rm.items()},
                         bridge.train_state_to_numpy(tst),
                         {k: float(v) for k, v in pm.items()}))
        out[mode] = runs
    return out


def _step_grads(before, after, gnorm):
    """The step's gradient, read back from AdamW's first moment:
    ``mu' = b1 · mu + (1 - b1) · clip(g)``, the clip factor being
    ``min(1, 1 / |g|)``."""
    factor = min(1.0, 1.0 / max(gnorm, 1e-9))
    mu0, mu1 = dict(_leaf_items(before.opt)), dict(_leaf_items(after.opt))
    return {p: (np.asarray(mu1[p][0], np.float64)
                - 0.9 * np.asarray(mu0[p][0], np.float64)) / 0.1 / factor
            for p in mu0}


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_train_steps_match_reference(reference, mode):
    """olmo-7b smoke (2 layers, d 128, LayerNorm), batch 2 x 64, lr 1e-3
    on a cosine without warmup, a scale refresh every 2 steps.  The port
    takes three steps from the reference's ``init_train_state`` (through
    the bridge) on the reference's batches; each of its steps is held
    against the reference's step from the same state on the same batch.
    Left to run on its own, the reference does not follow itself: in
    bf16, moving the state by the 0.04% of step-0 update signs that the
    two packages' rounding flips decide moves the reference's own
    step-1 gradient by 25-35%, while the reference started from the
    port's state gives the port's step-1 gradient to 8e-4.  Compiled
    with ``REFERENCE_XLA_FLAGS``, the reference gives its op-by-op
    (``jax.disable_jit()``) moss grad norms bit for bit at steps 0 and
    1; at step 2 the two differ by 5e-4 (53.692 / 53.665, the port
    53.667), as f32 sums in another order flip fp8 roundings.  Limits,
    with the values measured on a CPU (moss / bf16; the same with 1 and
    3 torch threads and with XLA's Eigen threads off):

    - step-0 gradients (read back from AdamW's first moment), rel L2
      per leaf <= 2e-2 (measured at most 8.5e-5 / 3.9e-3);
    - the loss at each step, rel <= 1e-2 (measured at most 1.4e-7 /
      1.0e-5);
    - ``scale_t`` equal at each step;
    - each step's update ``p_after - p_before``, rel L2 per leaf <= 5e-2
      (measured at most 2.4e-2 / 5.9e-3) over the elements whose
      gradient sign is settled, ``|g_ref| >= |g_port - g_ref|``.
      AdamW's first steps are sign-like, so an element whose gradient
      lies within the two packages' difference of zero moves by 2·lr
      the other way.  At most 5% of a leaf may be unsettled (measured
      at most 1.6% / 0.39%)."""
    print(mode, check_train_steps(reference["train"][mode]))


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_llama2_train_steps_match_reference(reference, mode):
    """llama2-7b smoke (2 layers, d 128, RMSNorm, vocab 512), as
    ``test_train_steps_match_reference``: three port steps from the
    reference's ``init_train_state`` on its batches, each held against
    the reference's step from the same state, with the same limits
    (``check_train_steps``, unchanged)."""
    cfg = get_config(LLAMA2)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
            cfg.norm) == (32, 4096, 32, 11008, 32000, "rmsnorm")
    print(mode, check_train_steps(reference["llama2"][mode]))


def check_train_steps(runs, grad_limit: float = 2e-2) -> dict:
    """``test_train_steps_match_reference``'s limits over one mode's
    runs (``grad_limit``: the step-0 gradients' rel L2; a caller that
    sets another states why); returns the worst value of each measure."""
    worst = {"grad": 0.0, "loss": 0.0, "update": 0.0, "unsettled": 0.0}
    for i, (before, rs, rm, ps, pm) in enumerate(runs):
        gr = _step_grads(before, rs, rm["grad_norm"])
        gp = _step_grads(before, ps, pm["grad_norm"])
        rel = abs(pm["loss"] - rm["loss"]) / abs(rm["loss"])
        worst["loss"] = max(worst["loss"], rel)
        assert np.isfinite(pm["loss"]) and rel <= 1e-2, (i, pm, rm)
        assert dict(_leaf_items(jax.tree.map(int, rs.scale_t))) == \
            dict(_leaf_items(ps.scale_t)), i
        assert ps.step == int(rs.step) == i + 1
        p0 = dict(_leaf_items(before.params))
        pr, pp = dict(_leaf_items(rs.params)), dict(_leaf_items(ps.params))
        for name, w0 in p0.items():
            if i == 0:
                rel = _rel_l2(gp[name], gr[name])
                worst["grad"] = max(worst["grad"], rel)
                assert rel <= grad_limit, (name, rel)
            settled = np.abs(gr[name]) >= np.abs(gp[name] - gr[name])
            unsettled = 1.0 - float(settled.mean())
            worst["unsettled"] = max(worst["unsettled"], unsettled)
            assert unsettled <= 5e-2, (i, name, unsettled)
            rel = _rel_l2((pp[name] - w0)[settled], (pr[name] - w0)[settled])
            worst["update"] = max(worst["update"], rel)
            assert rel <= 5e-2, (i, name, rel)
    return worst


def test_eval_step_and_microbatches():
    """The port alone: the eval step (just-in-time weight scales) gives
    the train step's step-0 loss bit for bit, since at t = 0 the
    predicted scale is the measured one; two microbatches of one
    sequence give the loss of one batch of two (bf16, within f32
    rounding of the mean) and its gradient norm (within the bf16
    rounding flips that another GEMM shape's sum order causes, 1e-3)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=512, seq_len=64, global_batch=2))
    batch = data.batch_for_step(0)
    cfg = get_config(ARCH, smoke=True)
    hp = tsteps.TrainHParams(**TRAIN_HP)
    state = tsteps.init_train_state(cfg, hp, seed=0, device="cpu")
    _, met = tsteps.make_train_step(cfg, hp)(state, batch)
    loss = tsteps.make_eval_step(cfg)(state.params, batch)
    assert float(loss) == float(met["loss"])
    cfg = cfg.replace(quant=QuantConfig(mode="bf16"))
    one = tsteps.make_train_step(cfg, hp)(state, batch)[1]
    two = tsteps.make_train_step(cfg, hp._replace(microbatches=2))(
        state, batch)[1]
    assert abs(two["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    assert abs(two["grad_norm"] - one["grad_norm"]) <= \
        1e-3 * one["grad_norm"]


if __name__ == "__main__":
    _reference_child(sys.argv[1])
