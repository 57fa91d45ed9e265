"""The port's MoE training slice against the reference, on the CPU.

phi3.5-moe-42b-a6.6b's smoke config (2 layers, d 128, d_ff 160, 8
experts top-2), the grouped-expert kernels' plain versions, the two
dispatch entries, ``qmm_grouped``, the MoE block and the train step.
Inputs are made from a seed with numpy, or are the reference's own
weights and batches carried across by ``repro_torch.bridge``.  The
Pallas kernels run in interpret mode in this process; the reference's
``qmm_grouped``, MoE block and train steps come from the child process
of tests/test_torch_train.py, which compiles them with its
``REFERENCE_XLA_FLAGS`` under ``REPRO_KERNELS=ref`` (``moe_reference``).

Tolerances, with their reasons (the values measured on a CPU are in
each test):

- payloads (fp8 q, int8 sexp, f32 scales): bitwise;
- GEMM accumulations: within 1e-5 * max|ref|.  Every product of a bf16
  operand and an fp8 value is exact in f32; only the order of the f32
  sums differs;
- ``qmm_grouped``: the saved residuals bitwise, y and dx within
  1e-5 * max|ref|, dW within rel L2 1e-5 (as ``qmm``);
- the MoE block: equal top-k expert ids and group sizes; y and aux
  within the bf16 rounding flips that f32 sums in another order cause
  (see ``test_moe_block_matches_reference``);
- train steps: the limits of ``test_train_steps_match_reference``, and
  the per-(layer, expert) scale states across a refresh.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import quant as jq
from repro.core.formats import QuantConfig as JQuantConfig
from repro.core.linear import QT as JQT
from repro.core.linear import _qmm_grouped_fwd as jqmm_grouped_fwd
from repro.core.linear import qmm_grouped as jqmm_grouped
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import moe_dw_gemm_pallas, moe_gmm_pallas
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.train import steps as jsteps

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, qlinear_grouped, qmm_grouped
from repro_torch.core.quant import pad_axis, quant_mx, quant_per_tensor
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels import dispatch, moe_gmm
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import quant_mask_tree, wrap_qt
from repro_torch.models import transformer as ttr
from repro_torch.train import steps as tsteps

from test_torch_recipes import _jax, _same
from test_torch_train import (
    TRAIN_HP,
    _close_max,
    _jax_state,
    _leaf_items,
    _rel_l2,
    check_train_steps,
    recipe,
    shared_reference,
)

ARCH = "phi3.5-moe-42b-a6.6b"


def _smoke(dense: bool, jax_side: bool = False, **quant):
    """The MoE smoke config with the recipe ``quant`` and
    ``moe_decode_dense=dense`` (False: 128 tokens take the grouped
    route, True: the dense combine)."""
    get, qc = ((jax_get_config, JQuantConfig) if jax_side
               else (get_config, QuantConfig))
    return get(ARCH, smoke=True).replace(
        quant=qc(**quant), moe_decode_dense=dense)


# --- the reference, compiled in a child process ---------------------------

# (E, C, K, N) and the ragged sizes: an empty expert, a full one, C not a
# multiple of 32, K not a multiple of 32 (the micro-group padding)
GROUPED = (4, 48, 200, 72)
SIZES = np.array([48, 0, 17, 30], np.int32)


def _grouped_problem(seed=0):
    e, c, k, n = GROUPED
    rng = np.random.default_rng(seed)
    live = (np.arange(c)[None, :] < SIZES[:, None]).reshape(-1, 1)
    x = rng.standard_normal((e * c, k)).astype(np.float32)
    x *= (1 + 100.0 * (rng.random((e * c, k)) < 0.002)) * live
    w = (rng.standard_normal((e, k, n)) * 0.05).astype(np.float32)
    w[2] *= 3.0                             # experts at different scales
    g = (rng.standard_normal((e * c, n)) * live).astype(np.float32)
    s = (np.abs(w).max(axis=(1, 2)) / np.float32(448.0)).astype(np.float32)
    return x, w, g, s


def _qmm_grouped_reference(mode):
    x, w, g, s = _grouped_problem()
    jcfg = JQuantConfig(mode=mode)
    c = GROUPED[1]

    @jax.jit
    def run(x, w, g):
        y, vjp = jax.vjp(lambda a, b: jqmm_grouped(
            jcfg, c, a, b, jnp.asarray(s), jnp.asarray(SIZES)), x, w)
        if mode == "bf16":
            return (y, *vjp(g))
        xq, wq, sizes, _ = jqmm_grouped_fwd(jcfg, c, x, w, jnp.asarray(s),
                                            jnp.asarray(SIZES))[1]
        return (y, *vjp(g), *xq, wq.q, wq.s)

    return [np.asarray(a) for a in run(x, w, g)]


def _block_params(seed=1):
    """The smoke config's layer-0 MoE params (numpy, from the
    reference's initializers) and their per-expert measured scales."""
    jcfg = _smoke(True, jax_side=True)
    defs = jmoe.moe_defs(jcfg)
    p = jax.tree.map(np.asarray, jlayers.init_tree(
        defs, jax.random.PRNGKey(seed)))
    scales = {n: (np.abs(p[n]).max(axis=(1, 2)) / np.float32(448.0)
                  ).astype(np.float32) for n in ("w_up", "w_gate", "w_down")}
    x = np.random.default_rng(seed).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    return p, scales, x


def _block_reference(dense, mode):
    """The reference's MoE block (y, aux) and its top-k ids and group
    sizes, as numpy (in the child)."""
    jcfg = _smoke(dense, jax_side=True, **recipe(mode))
    p, scales, x = _block_params()
    c = jmoe._capacity(jcfg, x.shape[0] * x.shape[1])

    @jax.jit
    def run(p, x):
        pq = {n: (JQT(p[n], scales[n]) if n in scales else p[n]) for n in p}
        xb = x.astype(jnp.bfloat16)
        y, aux = jmoe.moe_block(jcfg, pq, xb, jcfg.quant)
        _, probs = jmoe.router_probs(jcfg, pq, xb.reshape(-1, x.shape[-1]))
        _, ids = jax.lax.top_k(probs, jcfg.top_k)
        counts = jnp.bincount(ids.reshape(-1), length=jcfg.n_experts)
        return y, aux, ids, jnp.minimum(counts, c)

    return [np.asarray(a) for a in run(p, x)]


def _block_wrap(p, scales, mode, qt):
    """The block params as the train step wraps them: predicted scales
    for moss, none for the just-in-time recipes and bf16."""
    auto = mode == "moss"
    return {n: (qt(p[n], scales[n] if auto else None) if n in scales
                else p[n]) for n in p}


def _block_grad_out(x):
    return np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)


def _block_vjp_reference(mode):
    """y, aux and the VJP (d params, d x) of the reference's MoE block on
    the grouped route (the loop route in the baselines), as numpy (in
    the child)."""
    jcfg = _smoke(False, jax_side=True, **recipe(mode))
    p, scales, x = _block_params()

    def f(p, x):
        y, aux = jmoe.moe_block(jcfg, _block_wrap(p, scales, mode, JQT),
                                x.astype(jnp.bfloat16), jcfg.quant)
        return y.astype(jnp.float32), aux

    @jax.jit
    def run(p, x, gy):
        (y, aux), vjp = jax.vjp(f, p, x)
        dp, dx = vjp((gy, jnp.float32(1.0)))
        return y, aux, dp, dx

    return jax.tree.map(np.asarray, run(p, x, _block_grad_out(x)))


_EXPERT_PATH = threading.local()


def _expert_path_per_thread() -> None:
    """In the child: the reference's MoE blocks read the expert path
    (``REPRO_MOE_EXPERTS``) from the calling thread's
    ``_EXPERT_PATH.value`` when it is set, so that one thread's vmapped
    step leaves the other threads' grouped ones alone."""
    import repro.models.moe as jm

    env = jm.moe_expert_path
    jm.moe_expert_path = (
        lambda: getattr(_EXPERT_PATH, "value", None) or env())


def _vmapped_reference_steps() -> dict:
    """Per mode (moss, bf16): the reference's ``init_train_state`` as the
    port's state turned to numpy, the first batch, and the reference's
    step from that state on the routed path with its experts one at a
    time (``REPRO_MOE_EXPERTS=vmapped``), state and metrics, as numpy
    (in the child, after ``_expert_path_per_thread``; the port's
    vmapped step from the same state runs in the test)."""
    jcfg0 = _smoke(False, jax_side=True)
    data = JSyntheticLM(JDataConfig(vocab=jcfg0.vocab, seq_len=64,
                                    global_batch=2, seed=0))
    batch = jax.tree.map(np.asarray, data.batch_for_step(0))
    out = {}
    _EXPERT_PATH.value = "vmapped"
    try:
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
    finally:
        _EXPERT_PATH.value = None
    return out


_VMAPPED_RUNS = {}


def _vmapped_runs(reference, mode, monkeypatch) -> list:
    """``check_train_steps``' one-step run of the vmapped step: the
    child's reference step and the port's from the same state under
    ``REPRO_MOE_EXPERTS=vmapped`` (computed once a mode)."""
    if mode not in _VMAPPED_RUNS:
        before, batch, rs, rm = reference["vmapped"][mode]
        monkeypatch.setenv("REPRO_MOE_EXPERTS", "vmapped")
        tcfg = _smoke(False, **recipe(mode), rescale_interval=2)
        ps, pm = tsteps.make_train_step(
            tcfg, tsteps.TrainHParams(**TRAIN_HP))(
                bridge.train_state_to_torch(before, device="cpu"),
                {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        monkeypatch.delenv("REPRO_MOE_EXPERTS")
        _VMAPPED_RUNS[mode] = [(before, rs, rm,
                                bridge.train_state_to_numpy(ps),
                                {k: float(v) for k, v in pm.items()})]
    return _VMAPPED_RUNS[mode]


def _moe_train_runs(modes=("moss", "bf16"), steps=3, dense=False):
    """As tests/test_torch_train.py's ``_train_runs`` for the MoE smoke
    config on the grouped route (``moe_decode_dense=False``): per mode,
    ``[(state before, ref state after, ref metrics, port state after,
    port metrics)]`` (in the child)."""
    jcfg0 = _smoke(dense, jax_side=True)
    data = JSyntheticLM(JDataConfig(vocab=jcfg0.vocab, seq_len=64,
                                    global_batch=2, seed=0))
    batches = [jax.tree.map(np.asarray, data.batch_for_step(i))
               for i in range(steps)]
    out = {}
    for mode in modes:
        jcfg = jcfg0.replace(quant=JQuantConfig(**recipe(mode),
                                                rescale_interval=2))
        hp = jsteps.TrainHParams(**TRAIN_HP)
        init = jax.tree.map(np.asarray, jax.jit(
            jsteps.init_train_state, static_argnums=(0, 1))(
                jcfg, hp, jax.random.PRNGKey(0)))
        jstep = jax.jit(jsteps.make_train_step(jcfg, hp))
        tcfg = _smoke(dense, **recipe(mode), rescale_interval=2)
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


# the serving modes' block inputs: 3 decode rows (B 3, S 1) and 2 verify
# rows of 4 drafts (B 2, S 4)
SERVE_SHAPES = {"decode": (3, 1), "verify": (2, 4)}


def _serve_act_scales(cfg, seed=7):
    """Per-expert delayed activation scales (numpy) for the block's three
    expert sites, different for every expert: ``s`` (E,) and ``sub``
    (E, K/32) E8M0 exponents in [-3, 0]."""
    rng = np.random.default_rng(seed)
    e = cfg.n_experts
    out = {}
    for n, k in (("w_up", cfg.d_model), ("w_gate", cfg.d_model),
                 ("w_down", cfg.d_ff)):
        out[n] = (rng.uniform(0.004, 0.02, e).astype(np.float32),
                  rng.integers(-3, 1, (e, -(-k // 32))).astype(np.int8))
    return out


def _serve_block_input(mode, seed=11):
    b, s = SERVE_SHAPES[mode]
    d = _smoke(True).d_model
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _serve_block_reference(mode, act):
    """The reference's MoE block in a serving mode (the dense combine)
    with per-expert weight scales and, for ``act="delayed"``, per-expert
    calibrated activation scales (``ActScale`` stacked over the experts,
    sliced by its ``jax.vmap``), as numpy (in the child)."""
    from repro.core.actscale import ActScale as JActScale

    jcfg = _smoke(True, jax_side=True)
    p, scales, _ = _block_params()
    acts = _serve_act_scales(jcfg) if act == "delayed" else {}

    @jax.jit
    def run(p, x):
        pq = {n: (JQT(p[n], scales[n],
                      JActScale(*map(jnp.asarray, acts[n]))
                      if n in acts else None)
                  if n in scales else p[n]) for n in p}
        y, aux = jmoe.moe_block(jcfg, pq, x.astype(jnp.bfloat16),
                                jcfg.quant, mode)
        return y, aux

    return [np.asarray(a) for a in run(p, _serve_block_input(mode))]


def _serving_build_reference():
    """The reference's build-time serving state of the phi3.5-moe smoke
    model (weights from ``PRNGKey(0)``): ``prequantize_params``'
    payloads and per-(layer, expert) scales, and ``calibrate_act_scales``
    on them, as numpy (in the child)."""
    from repro.core.actscale import calibrate_act_scales as jcalibrate

    jcfg = jax_get_config(ARCH, smoke=True)
    params = jlayers.init_tree(jtr.model_defs(jcfg), jax.random.PRNGKey(0))
    pq = jsteps.prequantize_params(jcfg, params)
    act = jcalibrate(jcfg, pq.qweights, pq.scales)
    return {"params": jax.tree.map(np.asarray, params),
            "qweights": jax.tree.map(np.asarray, pq.qweights),
            "scales": jax.tree.map(np.asarray, pq.scales),
            "act": {t: (np.asarray(a.s), np.asarray(a.sub))
                    for t, a in act.items()}}


# the baselines served: phi3.5-moe's smoke model in per_group and
# per_tensor (just-in-time weight scales, calibrated activation scales,
# the dense combine one expert at a time) through the engine and the
# legacy Server, as tests/test_torch_serving.py serves its baseline runs
BASELINE_SERVE = {f"{quant}-{kind}": dict(arch=ARCH, quant=quant, **over)
                  for quant in ("per_group", "per_tensor")
                  for kind, over in (("engine", {"ticks": True}),
                                     ("server", {"server": True}))}


def _baselines_serve_reference() -> dict:
    """The reference's streams, counters and calibrated activation
    scales for ``BASELINE_SERVE`` and its pre-quantized expert stacks in
    both recipes (weights from ``PRNGKey(0)``), as numpy (in the child,
    the engines under its ``ENGINE_LOCK``)."""
    from repro.models.layers import init_tree

    from test_torch_serving import (
        SEED,
        _prompts,
        _reference_serve,
        _run_cfg,
        _share_steps,
    )
    from test_torch_train import ENGINE_LOCK

    out = {"build": {}}
    for name, run in BASELINE_SERVE.items():
        cfg = _run_cfg(jax_get_config, run)
        params = init_tree(jtr.model_defs(cfg), jax.random.PRNGKey(SEED))
        if run["quant"] not in out["build"]:
            pq = jsteps.prequantize_params(cfg, params)
            out["build"][run["quant"]] = {
                "qweights": jax.tree.map(np.asarray, pq.qweights),
                "scales": jax.tree.map(np.asarray, pq.scales)}
        with ENGINE_LOCK.shared():
            _share_steps()
            out[name] = _reference_serve(cfg, params, run, _prompts())
    return out


def moe_reference() -> dict:
    """The reference's side of this module's tests, computed in the
    shared child of tests/test_torch_train.py (compiled with its
    ``REFERENCE_XLA_FLAGS`` under ``REPRO_KERNELS=ref``)."""
    return {"qmm_grouped": {m: _qmm_grouped_reference(m)
                            for m in ("moss", "bf16")},
            "block": {(dense, mode): _block_reference(dense, mode)
                      for dense in (False, True)
                      for mode in ("moss", "bf16")},
            "block_vjp": {m: _block_vjp_reference(m)
                          for m in ("moss", "bf16", "per_group",
                                    "per_tensor")},
            "serve_block": {(mode, act): _serve_block_reference(mode, act)
                            for mode in SERVE_SHAPES
                            for act in ("jit", "delayed")},
            "serving_build": _serving_build_reference(),
            "train": _moe_train_runs(),
            "vmapped": _vmapped_reference_steps(),
            "per_group": _moe_train_runs(("per_group",), steps=1),
            "baselines": _baselines_serve_reference()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``moe_reference``'s results, from the one child process that
    tests/test_torch_train.py, test_torch_recipes.py and
    test_torch_ring.py share (one per test run, through a file and a
    lock under pytest-xdist)."""
    return shared_reference(tmp_path_factory)["moe"]


# --- the config --------------------------------------------------------------

def test_moe_config_and_defs_match_reference():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
              "head_dim", "norm", "act", "rope_theta", "remat", "n_experts",
              "top_k", "capacity_factor", "moe_decode_dense", "n_shared",
              "first_dense"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    jd = jtr.model_defs(jax_get_config(ARCH, smoke=True))
    td = ttr.model_defs(get_config(ARCH, smoke=True))
    for path, d in jax.tree_util.tree_flatten_with_path(
            jd, is_leaf=jlayers.is_pdef)[0]:
        node = td
        for p in path:
            node = node[p.key]
        assert (tuple(node.shape), node.logical, node.init,
                node.quantized) == (tuple(d.shape), d.logical, d.init,
                                    d.quantized), path
    # one scale state per (layer, expert) slice of the expert stacks
    sd = tsteps._scale_dims(td)
    assert sd["blocks"]["moe"]["w_up"] == 2
    assert sd["blocks"]["moe"]["router"] == 1


# --- the kernels' plain versions against the Pallas kernels -----------------

KERNEL_CASES = [("e4m3", "bf16"), ("e4m3", "f32"), ("e5m2", "f32")]


def _kernel_problem(fmt, kind, k=128, n=96):
    """The grouped buffer (E·C, K) with C = 48 (not a multiple of 32),
    zero past each expert's size, and its e4m3 weight stack; e5m2 on an
    f32 gradient-like buffer against the transposed stack (dx)."""
    e, c = GROUPED[:2]
    rng = np.random.default_rng(k + n)
    live = (np.arange(c)[None, :] < SIZES[:, None]).reshape(-1, 1)
    x = rng.standard_normal((e * c, k)).astype(np.float32)
    x *= (1 + 100.0 * (rng.random((e * c, k)) < 0.002)) * live
    x[0, :32] = 0.0                         # an all-zero group
    tx = torch.tensor(x * (1e-3 if fmt == "e5m2" else 1.0))
    if kind == "bf16":
        tx = tx.bfloat16()
    w = (rng.standard_normal((e, k, n)) * 0.05).astype(np.float32)
    qw = torch.stack([quant_per_tensor(torch.tensor(wi)).q for wi in w])
    if fmt == "e5m2":                       # dx: the stack (E, N, K)^T
        w = (rng.standard_normal((e, n, k)) * 0.05).astype(np.float32)
        qw = torch.stack([quant_per_tensor(torch.tensor(wi)).q
                          for wi in w]).transpose(1, 2).contiguous()
    return tx, qw


@pytest.mark.parametrize("fmt,kind", KERNEL_CASES)
def test_moe_gmm_plain_matches_pallas(fmt, kind):
    """Payloads (q, sexp) bitwise against the Pallas kernel in interpret
    mode and the reference dispatch's ``ref`` branch (``quant_mx`` with
    the global scale); the accumulation within 1e-5 * max|ref| of both
    (measured 0 against ``ref.moe_gmm_ref``, 6.0e-8 of max|ref| against
    the kernel's blocked sums)."""
    e, c = GROUPED[:2]
    tx, qw = _kernel_problem(fmt, kind)
    sizes = torch.tensor(SIZES)
    s = dispatch.global_scale(tx, fmt)
    acc, q, sexp = moe_gmm.moe_gmm(tx, s, qw, sizes, c, fmt)
    jx, jqw = _jax(tx), _jax(qw)
    pacc, pq, pse = moe_gmm_pallas(jx, _jax(s), jqw, jnp.asarray(SIZES),
                                   capacity=c, fmt=fmt, bm=16, bk=64,
                                   interpret=True)
    _same(pq, q)
    _same(pse, sexp)
    jxq = jq.quant_mx(jx, 32, fmt, global_scale=_jax(s))
    _same(jxq.q, q)
    _same(jxq.sexp, sexp)
    _close_max(acc, pacc)
    _close_max(acc, jref.moe_gmm_ref(jxq.q, jxq.sexp, jqw, c))
    # the rows past each expert's size: q 0, exponent -127, output 0
    dead = ~(np.arange(c)[None, :] < SIZES[:, None]).reshape(-1)
    assert (bridge.bits(q)[dead] == 0).all()
    assert (sexp.numpy()[dead] == -127).all()
    assert (acc.numpy()[dead] == 0).all()


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_moe_dw_gemm_plain_matches_pallas(fmt):
    """The grouped dW on the forward's residual (Cp = 64: C = 48 padded
    per expert to 32) against the e5m2 per-tensor gradient: the requant
    payload bitwise against ``quant_mx`` of each expert's dequantized
    residual (the reference oracle's steps), dW within 1e-5 * max|ref|
    of ``ref.moe_dw_ref`` and of the Pallas kernel in interpret mode
    (measured 2.5e-8 of max|ref| against both)."""
    e, cp, k, n = 4, 64, 128, 96
    rng = np.random.default_rng(7)
    sizes = np.array([64, 0, 17, 40], np.int32)
    live = (np.arange(cp)[None, :] < sizes[:, None]).reshape(-1, 1)
    x = rng.standard_normal((e * cp, k)).astype(np.float32) * live
    x[:, 64:96] *= 1e-3                     # a column band 1000x smaller
    g = (rng.standard_normal((e * cp, n)) * live).astype(np.float32)
    xq = quant_mx(torch.tensor(x), 32, fmt)
    gq = quant_per_tensor(torch.tensor(g), "e5m2")
    acc, qt, et = moe_gmm.moe_dw_gemm(xq.q, xq.sexp, gq.q,
                                      torch.tensor(sizes), cp, fmt,
                                      payload=True)
    assert acc.shape == (e, k, n) and qt.shape == (e, k, cp)
    jqx, jse, jqg = _jax(xq.q), _jax(xq.sexp), _jax(gq.q)
    one = jnp.float32(1.0)
    for i in range(e):
        rows = slice(i * cp, (i + 1) * cp)
        unit = jq.MxQ(jqx[rows], jse[rows], one).dequant(jnp.float32)
        jt = jq.quant_mx(unit.T, 32, fmt, global_scale=one)
        _same(jt.q, qt[i])
        _same(jt.sexp, et[i])
    _close_max(acc, jref.moe_dw_ref(jqx, jse, jqg, cp, fmt))
    pallas = moe_dw_gemm_pallas(jqx, jse, jqg, jnp.asarray(sizes),
                                capacity=cp, fmt=fmt, bm=32, bn=96, bko=64,
                                interpret=True)
    _close_max(acc, pallas)
    assert (acc[1].numpy() == 0).all()      # the empty expert


def test_moe_kernels_refuse_what_they_cannot_take():
    e, c = GROUPED[:2]
    tx, qw = _kernel_problem("e4m3", "f32")
    s, sizes = dispatch.global_scale(tx), torch.tensor(SIZES)
    with pytest.raises(ValueError):
        moe_gmm.moe_gmm(tx[:-8], s, qw, sizes, c)            # E·C rows
    with pytest.raises(ValueError):
        moe_gmm.moe_gmm(tx, s, qw, sizes.long(), c)          # int32 sizes
    with pytest.raises(TypeError):
        moe_gmm.moe_gmm(tx, s, qw.float(), sizes, c)
    xq = quant_mx(tx)
    g = quant_per_tensor(torch.ones(e * c, 8), "e5m2").q
    with pytest.raises(ValueError):                          # C % 32
        moe_gmm.moe_dw_gemm(xq.q, xq.sexp, g, sizes, c)


# --- dispatch ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_moe_dispatch_matches_reference(monkeypatch, backend):
    """``dispatch.moe_grouped_matmul`` (e4m3 forward, e5m2 dx on the
    transposed stack) and ``moe_grouped_matmul_dw`` (C = 48 padded per
    expert to 64, ``out_rows``) against the reference's, which takes
    its ``ref`` branch or its Pallas kernels in interpret mode
    (``REPRO_KERNELS``): the residual bitwise, y and dW within
    1e-5 * max|ref|."""
    monkeypatch.setenv("REPRO_KERNELS", backend)
    e, c, k, n = GROUPED
    x, w, g, s = _grouped_problem(3)
    xp = np.pad(x, ((0, 0), (0, 224 - k)))   # K padded to the micro-group
    qw = torch.stack([quant_per_tensor(torch.tensor(wi), scale=torch.tensor(
        si)).q for wi, si in zip(w, s)])
    qwp = pad_axis(qw, 1, 32)
    sizes, ts = torch.tensor(SIZES), torch.tensor(s)
    y, xq = dispatch.moe_grouped_matmul(torch.tensor(xp), sizes, qwp, ts,
                                        capacity=c, out_dtype=torch.float32)
    jy, jxq = jdispatch.moe_grouped_matmul(
        jnp.asarray(xp), jnp.asarray(SIZES), _jax(qwp), jnp.asarray(s),
        capacity=c, out_dtype=jnp.float32)
    for a, b in zip(jxq, xq):
        _same(a, b)
    _close_max(y, jy)
    # dx: the e5m2 gradient against the transposed payloads, N padded
    # to the micro-group as qmm_grouped's backward pads it
    gp = np.pad(g, ((0, 0), (0, 96 - n))) * np.float32(1e-2)
    qwt = pad_axis(qw.transpose(1, 2).contiguous(), 1, 32)
    dx, _ = dispatch.moe_grouped_matmul(torch.tensor(gp), sizes, qwt, ts,
                                        capacity=c, fmt="e5m2",
                                        out_dtype=torch.float32)
    jdx, _ = jdispatch.moe_grouped_matmul(
        jnp.asarray(gp), jnp.asarray(SIZES), _jax(qwt), jnp.asarray(s),
        capacity=c, fmt="e5m2", out_dtype=jnp.float32)
    _close_max(dx, jdx)
    gq = quant_per_tensor(torch.tensor(g), "e5m2")
    dw = dispatch.moe_grouped_matmul_dw(xq, gq, sizes, capacity=c,
                                        out_rows=k)
    jdw = jdispatch.moe_grouped_matmul_dw(
        jxq, jq.PerTensorQ(_jax(gq.q), _jax(gq.s)), jnp.asarray(SIZES),
        capacity=c, out_rows=k)
    assert dw.shape == (e, k, n)
    _close_max(dw, jdw)


# --- qmm_grouped -------------------------------------------------------------

def test_qlinear_grouped_jit_scales_and_refusals():
    """Without predicted scales each expert is measured (as the
    reference's jit fallback); the baselines do not take the grouped
    GEMM."""
    x, w, _, s = _grouped_problem()
    c = GROUPED[1]
    tx, tw, sizes = torch.tensor(x), torch.tensor(w), torch.tensor(SIZES)
    cfg = QuantConfig(mode="moss")
    got = qlinear_grouped(tx, QT(tw, None), sizes, c, cfg)
    want = qmm_grouped(cfg, c, tx, tw, torch.tensor(s), sizes)
    np.testing.assert_array_equal(got.numpy(), want.detach().numpy())
    with pytest.raises(NotImplementedError):
        qmm_grouped(QuantConfig(mode="per_group", weight_scaling="jit"), c,
                    tx, tw, torch.tensor(s), sizes)


def test_moe_routes_agree_in_bf16():
    """In bf16 the grouped route computes the dense combine's dots on
    the routed rows: the two routes agree to the f32 combine's order
    (within one bf16 rounding)."""
    p, scales, x = _block_params()
    pt = {n: (QT(torch.tensor(v)) if n in scales else torch.tensor(v))
          for n, v in p.items()}
    xb = torch.tensor(x).bfloat16()
    ys = [tmoe.moe_block(_smoke(dense, mode="bf16"), pt, xb,
                         QuantConfig(mode="bf16"))[0].float()
          for dense in (False, True)]
    _close_max(ys[0], ys[1], rel=1e-2)


def test_grouped_forward_takes_a_prequantized_stack():
    """A served MoE prompt past the dense combine's limit takes the
    grouped route with the build-time fp8 stack: ``qlinear_grouped``
    passes the payloads through with their per-expert scales and gives
    bitwise what it gives on the f32 stack quantized against the same
    scales."""
    from repro_torch.core.quant import prequant_weight

    x, w, _, s = _grouped_problem()
    e, c, k, n = GROUPED
    q, sw = prequant_weight(torch.tensor(w), 1, scale=torch.tensor(s))
    cfg = QuantConfig(mode="moss")
    with torch.inference_mode():
        ys = [qlinear_grouped(torch.tensor(x), QT(wt, sw),
                              torch.tensor(SIZES), c, cfg)
              for wt in (q, torch.tensor(w))]
    assert torch.equal(ys[0], ys[1])


def test_moe_delayed_experts_take_their_own_scales():
    """``_experts`` hands expert i its own weight scale and its own row
    of the stacked ``ActScale``; a calibration tag and None pass as
    they are."""
    from repro_torch.core.actscale import ActScale

    e, k, n = 3, 64, 8
    w = torch.randn(e, k, n)
    a = ActScale(torch.tensor([1.0, 2.0, 3.0]),
                 torch.tensor([[0, -1], [-2, -3], [-1, 0]], dtype=torch.int8))
    qts = tmoe._experts(QT(w, torch.tensor([4.0, 5.0, 6.0]), a))
    for i, qt in enumerate(qts):
        assert torch.equal(qt.w, w[i]) and float(qt.s) == 4.0 + i
        assert float(qt.a.s) == 1.0 + i
        assert torch.equal(qt.a.sub, a.sub[i])
    assert [q.a for q in tmoe._experts(QT(w, None, "tag"))] == ["tag"] * e
    assert [q.a for q in tmoe._experts(QT(w))] == [None] * e


def test_moe_mesh_and_vmapped_experts_raise(monkeypatch):
    """What stays refused of MoE: expert parallelism over a mesh (a
    process group of more than one rank), in training and serving
    alike; and ``REPRO_MOE_EXPERTS`` other than the reference's two
    paths (``grouped``, ``vmapped``, both taken now) in the training
    CLI, with the reference's ``ValueError``."""
    from repro_torch.launch import train as ttrain

    cfg = _smoke(True)
    p, scales, x = _block_params()
    pt = {n: (QT(torch.tensor(v)) if n in scales else torch.tensor(v))
          for n, v in p.items()}
    xb = torch.tensor(x[:, :1]).bfloat16()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    for mode in ("train", "decode", "verify"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmoe.moe_block(cfg, pt, xb, cfg.quant, mode)
    monkeypatch.undo()
    assert ttr.paged_decode_supported(cfg, 64, 16)
    monkeypatch.setenv("REPRO_MOE_EXPERTS", "vmapped")
    assert tmoe.moe_expert_path() == "vmapped"
    monkeypatch.setenv("REPRO_MOE_EXPERTS", "dense")
    with pytest.raises(ValueError, match="REPRO_MOE_EXPERTS"):
        ttrain.train(ARCH, steps=1, device="cpu")


def test_moe_step_launches_per_site(monkeypatch):
    """A moss step of the one-layer model with remat launches per step
    9 grouped GEMMs (up/gate/down forward, the remat recompute and dx)
    and 3 grouped dW, as chip_smoke.py counts them on the card."""
    calls = {"moe_gmm": 0, "moe_dw_gemm": 0}

    def spy(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(dispatch, "moe_gmm", spy("moe_gmm",
                                                 dispatch.moe_gmm))
    monkeypatch.setattr(dispatch, "moe_dw_gemm", spy("moe_dw_gemm",
                                                     dispatch.moe_dw_gemm))
    cfg = _smoke(False, rescale_interval=2).replace(n_layers=1, remat=True)
    hp = tsteps.TrainHParams(**TRAIN_HP)
    state = tsteps.init_train_state(cfg, hp, seed=0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64)),
             "labels": torch.randint(0, cfg.vocab, (2, 64))}
    _, met = tsteps.make_train_step(cfg, hp)(state, batch)
    assert np.isfinite(float(met["loss"])) and float(met["aux"]) > 0
    assert calls == {"moe_gmm": 9, "moe_dw_gemm": 3}
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))


def test_moe_remat_recomputes_the_same_routing():
    """Under remat the layer is recomputed in the backward: the
    recompute routes the same tokens, so loss, aux and every gradient
    equal those of the step without remat, bit for bit (moss, grouped
    route)."""
    cfg = _smoke(False, rescale_interval=2)
    hp = tsteps.TrainHParams(**TRAIN_HP)
    state = tsteps.init_train_state(cfg, hp, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen)
             for k in ("tokens", "labels")}
    scales = tsteps.predicted_scales(state.scale_s0, state.scale_t,
                                     torch.tensor(1e-3), cfg.quant)
    mask = quant_mask_tree(ttr.model_defs(cfg))
    outs = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        flat = [w.detach().requires_grad_(True)
                for w in tree_leaves(state.params)]
        qp = wrap_qt(tree_unflatten(state.params, flat), scales, mask)
        logits, _, aux = ttr.forward(c, c.quant, qp, batch["tokens"])
        loss = ttr.ce_loss(c, logits, batch["labels"]) + 0.01 * aux
        grads = torch.autograd.grad(loss, flat)
        outs.append((float(loss.detach()), float(aux.detach()), grads))
    (l0, a0, g0), (l1, a1, g1) = outs
    assert (l0, a0) == (l1, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_qmm_grouped_vjp_matches_reference(reference, mode):
    """y, dx and dW against ``jax.vjp`` of the reference's
    ``qmm_grouped`` (E 4, C 48, K 200: padded to 224, N 72; an empty
    and a full expert); in moss the saved tensors are only the fp8
    residual of the buffer (q, sexp, s), the quantized stack (q, s per
    expert) and the sizes, bitwise the reference's."""
    x, w, g, s = _grouped_problem()
    y_ref, dx_ref, dw_ref, *res = reference["qmm_grouped"][mode]
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = qmm_grouped(QuantConfig(mode=mode), GROUPED[1], tx, tw,
                    torch.tensor(s), torch.tensor(SIZES))
    saved = y.grad_fn.saved_tensors
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.tensor(g))
    assert y.dtype == tx.dtype and dx.shape == tx.shape
    assert dw.shape == tw.shape
    _close_max(y, y_ref)
    _close_max(dx, dx_ref)
    assert _rel_l2(dw, dw_ref) < 1e-5
    if mode == "bf16":
        assert [t.dtype for t in saved] == [torch.bfloat16] * 2
        return
    assert [t.dtype for t in saved] == [
        torch.float8_e4m3fn, torch.int8, torch.float32,
        torch.float8_e4m3fn, torch.float32, torch.int32]
    for got, want in zip(saved, res):
        np.testing.assert_array_equal(
            bridge.bits(got).reshape(-1),
            np.asarray(want).reshape(-1).view(bridge.bits(got).dtype))
    np.testing.assert_array_equal(saved[-1].numpy(), SIZES)


# --- the MoE block -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["moss", "bf16"])
@pytest.mark.parametrize("dense", [False, True])
def test_moe_block_matches_reference(reference, dense, mode):
    """The smoke config's MoE block on 2 x 64 tokens (bf16), on the
    grouped route (``moe_decode_dense=False``: C 48, dispatch, the
    grouped kernels' plain versions, the f32 combine) and on the dense
    combine.  The top-2 ids and the group sizes equal the reference's;
    aux within 1e-6 relative (f32 means in another order); y within one
    bf16 step of its largest element, 2^-8 * max|y_ref|, and rel L2
    1e-4 (measured at most 1.2e-3 and 4.3e-5, bf16 on the dense
    combine): the f32 router, GEMM and combine sums in another order
    flip bf16 roundings of single elements."""
    y_ref, aux_ref, ids_ref, sizes_ref = reference["block"][dense, mode]
    cfg = _smoke(dense, **recipe(mode))
    p, scales, x = _block_params()
    pt = {n: (QT(torch.tensor(v), torch.tensor(scales[n])) if n in scales
              else torch.tensor(v)) for n, v in p.items()}
    xb = torch.tensor(x).bfloat16()
    y, aux = tmoe.moe_block(cfg, pt, xb, cfg.quant)
    probs, _, ids = tmoe.route(cfg, pt, xb.reshape(-1, x.shape[-1]))
    _, _, sizes = tmoe.dispatch_plan(ids, cfg.n_experts,
                                     tmoe._capacity(cfg, 128))
    np.testing.assert_array_equal(ids.numpy(), ids_ref)
    np.testing.assert_array_equal(sizes.numpy(), sizes_ref)
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    yr = y_ref.astype(np.float32)
    _close_max(y.float(), yr, rel=2.0 ** -8)
    assert _rel_l2(y.float(), yr) < 1e-4


@pytest.mark.parametrize("mode", ["moss", "bf16", "per_group",
                                  "per_tensor"])
def test_moe_block_vjp_matches_reference(reference, mode):
    """The MoE block's forward and backward on the grouped route
    (moe_decode_dense=False, 128 tokens, C 48; the baselines take the
    loop route), from the same weights, input and output gradient as
    the reference: y, dx and every parameter gradient within rel L2
    1e-3, aux within 1e-6 relative.  Measured on a CPU: moss dx and
    w_down 0, the rest <= 2.6e-6; bf16 dx 3.2e-4 (the bf16 einsums'
    roundings), weights <= 7.6e-5; per_group dx 2.6e-5, router 1.3e-5;
    per_tensor dx 1.3e-5, the expert weights 0."""
    y_ref, aux_ref, dp_ref, dx_ref = reference["block_vjp"][mode]
    cfg = _smoke(False, **recipe(mode))
    p, scales, x = _block_params()
    tp = {n: torch.tensor(v, requires_grad=True) for n, v in p.items()}
    ts = {n: torch.tensor(v) for n, v in scales.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_block(cfg, _block_wrap(tp, ts, mode, QT),
                            tx.bfloat16(), cfg.quant)
    gy = torch.tensor(_block_grad_out(x))
    grads = torch.autograd.grad((y.float() * gy).sum() + aux,
                                [tx, *tp.values()])
    np.testing.assert_allclose(float(aux.detach()), float(aux_ref),
                               rtol=1e-6)
    worst = {"y": _rel_l2(y.float(), y_ref), "dx": _rel_l2(grads[0], dx_ref)}
    for name, g in zip(tp, grads[1:]):
        worst[name] = _rel_l2(g, dp_ref[name])
    print(mode, worst)
    assert max(worst.values()) <= 1e-3, worst


@pytest.mark.parametrize("mode", sorted(SERVE_SHAPES))
@pytest.mark.parametrize("act", ["jit", "delayed"])
def test_moe_block_serving_modes_match_reference(reference, mode, act):
    """The MoE block in the serving modes (decode: 3 rows of 1 token;
    verify: 2 rows of 4 drafts) takes the masked dense combine, as the
    reference's does, every expert with its own weight scale and, with
    ``act="delayed"``, its own slice of the site's stacked ``ActScale``
    (``s`` (E,), ``sub`` (E, K/32)); ``jit`` measures each expert's
    input in the step.  aux within 1e-6 relative; y within one bf16
    step of its largest element and rel L2 1e-4, as the training
    block's dense combine (``test_moe_block_matches_reference``): the
    f32 router, GEMM and combine sums in another order flip bf16
    roundings of single elements."""
    from repro_torch.core.actscale import ActScale

    y_ref, aux_ref = reference["serve_block"][mode, act]
    cfg = _smoke(True)
    p, scales, _ = _block_params()
    acts = _serve_act_scales(cfg) if act == "delayed" else {}
    pt = {n: (QT(torch.tensor(v), torch.tensor(scales[n]),
                 ActScale(*map(torch.tensor, acts[n])) if n in acts
                 else None)
              if n in scales else torch.tensor(v)) for n, v in p.items()}
    xb = torch.tensor(_serve_block_input(mode)).bfloat16()
    with torch.inference_mode():
        y, aux = tmoe.moe_block(cfg, pt, xb, cfg.quant, mode)
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    yr = y_ref.astype(np.float32)
    _close_max(y.float(), yr, rel=2.0 ** -8)
    assert _rel_l2(y.float(), yr) < 1e-4


def test_moe_prequantized_weights_match_reference(reference):
    """``prequantize_params`` on the phi3.5-moe smoke weights: every
    payload and every per-(layer, expert) scale bitwise the
    reference's (``_scale_dims`` gives the expert stacks (L, E)
    scales)."""
    ref = reference["serving_build"]
    tp = tsteps.prequantize_params(
        get_config(ARCH, smoke=True),
        bridge.tree_to_torch(ref["params"], device="cpu"))
    rq, rs = dict(_leaf_items(ref["qweights"])), dict(_leaf_items(
        ref["scales"]))
    tq, ts = dict(_leaf_items(tp.qweights)), dict(_leaf_items(tp.scales))
    assert sorted(tq) == sorted(rq) and sorted(ts) == sorted(rs)
    for name, want in rq.items():
        _same(want, tq[name])
    for name, want in rs.items():
        np.testing.assert_array_equal(ts[name].numpy(), want)
    assert ts["blocks/moe/w_up"].shape == (2, 8)


def test_moe_calibration_matches_reference(reference):
    """``calibrate_act_scales`` on the prequantized phi3.5-moe smoke
    model: every site's ``ActScale`` bitwise the reference's, the
    expert sites per (layer, expert): ``s`` (L, E) and ``sub`` (L, E,
    K/32).  (The reference's calibration runs in the shared child with
    its ``REFERENCE_XLA_FLAGS``, where it computes what the code says;
    every expert sees every calibration token on the dense combine.)"""
    from repro_torch.core.actscale import calibrate_act_scales

    ref = reference["serving_build"]
    cfg = get_config(ARCH, smoke=True)
    tp = tsteps.prequantize_params(
        cfg, bridge.tree_to_torch(ref["params"], device="cpu"))
    act = calibrate_act_scales(cfg, tp.qweights, tp.scales)
    assert sorted(act) == sorted(ref["act"])
    for tag, (s, sub) in ref["act"].items():
        np.testing.assert_array_equal(act[tag].s.numpy(), s, err_msg=tag)
        np.testing.assert_array_equal(act[tag].sub.numpy(), sub,
                                      err_msg=tag)
    assert act["blocks/moe/w_down"].sub.shape == (2, cfg.n_experts,
                                                  cfg.d_ff // 32)


# --- the train step ----------------------------------------------------------

def _scale_leaves(tree):
    return {k: np.asarray(v) for k, v in _leaf_items(tree)
            if "/moe/w_" in k}


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_moe_train_steps_match_reference(reference, mode):
    """The MoE smoke model (2 layers, 8 experts top-2) on the grouped
    route (``moe_decode_dense=False``: 128 tokens, C 48), batch 2 x 64,
    lr 1e-3, a scale refresh every 2 steps, aux_coef 0.01: the port
    takes three steps from the reference's ``init_train_state`` on the
    reference's batches, each held against the reference's step from
    the same state with tests/test_torch_train.py's limits (step-0
    gradients rel L2 <= 2e-2, loss rel <= 1e-2, ``scale_t`` equal,
    updates rel L2 <= 5e-2 over the settled elements, at most 5%
    unsettled), the aux loss within 1e-5 relative, and the per-(layer,
    expert) scale states: ``scale_s0`` of each expert stack is (L, E),
    kept between refreshes (bitwise the state before) and after the
    refresh at step 2 the measured ``max|W| / 448`` of each (layer,
    expert) slice of the port's own weights, bitwise, and within 1e-2
    relative of the reference's (whose weights differ by the update
    noise the step limits allow).  Measured on a CPU (moss / bf16):
    step-0 gradients 4.4e-4 / 3.5e-3, loss 3.2e-6 / 5.4e-6, updates
    2.8e-2 / 3.7e-3, unsettled 2.3% / 0.78%, aux 2.1e-7 / 2.2e-6,
    ``scale_s0`` after the refresh 1.2e-7 from the reference's."""
    runs = reference["train"][mode]
    print(mode, check_train_steps(runs))
    for i, (before, rs, rm, ps, pm) in enumerate(runs):
        assert abs(pm["aux"] - rm["aux"]) <= 1e-5 * abs(rm["aux"]), i
        got, want = _scale_leaves(ps.scale_s0), _scale_leaves(rs.scale_s0)
        prev = _scale_leaves(before.scale_s0)
        params = dict(_leaf_items(ps.params))
        for name, s0 in got.items():
            assert s0.shape == (2, 8), name
            if mode == "bf16" or i != 1:
                np.testing.assert_array_equal(s0, prev[name])
                continue
            w = np.abs(params[name])
            np.testing.assert_array_equal(
                s0, (w.max(axis=(2, 3)).astype(np.float32)
                     / np.float32(448.0)))
            np.testing.assert_allclose(s0, want[name], rtol=1e-2)


def test_moe_per_group_loop_step_matches_reference(reference):
    """One per_group step (just-in-time weight scales; the experts one
    by one through ``qlinear``, the reference's vmapped experts) from
    the reference's state, with the limits of the train-step test but
    for the step-0 gradients, held to rel L2 5e-2 where the dense
    recipes are held to 2e-2.  Measured on a CPU: loss rel 3.6e-5,
    updates 1.3e-2, unsettled 0.9%, step-0 gradients 3.2e-2 (the attention
    ``wv``; the MoE weights 1.7e-2).  Why: routing is identical and the
    block's VJP matches to 3e-5 from the same inputs
    (``test_moe_block_vjp_matches_reference``), but the router's f32
    product sums in MKL's order, not XLA's; the last-bit differences of
    the routing weights move 5 bf16 roundings of layer 0's MoE output,
    and per_group's E5M2 gradient quantization (per 128 elements)
    carries such differences into the attention gradients.  With the
    router's forward taken from XLA the head's step-0 gradient agrees to
    5e-8 (from 3e-3) and ``wv`` to 1.8e-2; the rest is the same
    sum-order effect in the block's backward.  The olmo model (no
    router) meets 2e-2 in per_group (tests/test_torch_recipes.py)."""
    print(check_train_steps(reference["per_group"]["per_group"],
                            grad_limit=5e-2))


# --- REPRO_MOE_EXPERTS=vmapped ---------------------------------------------


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_moe_vmapped_step_matches_reference(reference, mode, monkeypatch):
    """``REPRO_MOE_EXPERTS=vmapped``: one train step of the MoE smoke
    model on the routed path (128 tokens, C 48) with its experts one at
    a time in both packages, from the reference's ``init_train_state``,
    held against the reference's vmapped step with
    tests/test_torch_train.py's limits; in moss the step-0 gradients'
    limit is ``test_moe_per_group_loop_step_matches_reference``'s 5e-2,
    for the same reason (the experts one by one: f32 sums in MKL's order
    whose last bits the E5M2 gradient quantization amplifies; the same
    step on the grouped kernels agrees to 2e-7).  Measured on a CPU:
    step-0 gradients rel L2 2.02e-2 in moss (``blocks/moe/w_up``; loss
    rel 6e-7), 3.5e-3 in bf16."""
    check_train_steps(_vmapped_runs(reference, mode, monkeypatch),
                      grad_limit=5e-2 if mode == "moss" else 2e-2)


@pytest.mark.parametrize("mode", ["moss", "bf16"])
def test_moe_vmapped_step_is_the_grouped_step(reference, mode,
                                              monkeypatch):
    """The vmapped step against the grouped step from the same state on
    the same batch, in each package.  In bf16 the reference's two steps
    are bitwise (the same dots over the same rows), and so are the
    port's.  In moss neither package's are (the grouped quantizer takes
    one level-1 scale over every expert's rows, each expert its own one
    by one: the step-0 gradients move by 1.1-3.1 rel L2, the loss by
    1.3e-3), so the port's move from grouped to vmapped is held against
    the reference's: the loss's within 1e-2 of it, each gradient's
    within 5e-2 rel L2 (measured 5e-4 and 2.2e-2)."""
    from test_torch_train import _step_grads

    grouped = reference["train"][mode][0]
    vmapped = _vmapped_runs(reference, mode, monkeypatch)[0]
    before = grouped[0]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        _leaf_items(before.params), _leaf_items(vmapped[0].params)))

    def same(x, y):
        return all(np.array_equal(a, b) for (_, a), (_, b) in zip(
            _leaf_items(x.params), _leaf_items(y.params)))

    if mode == "bf16":
        assert same(grouped[1], vmapped[1])
        assert same(grouped[3], vmapped[3])
        assert grouped[4]["loss"] == vmapped[4]["loss"]
        return
    assert not same(grouped[1], vmapped[1])
    ref_dl = vmapped[2]["loss"] - grouped[2]["loss"]
    port_dl = vmapped[4]["loss"] - grouped[4]["loss"]
    assert abs(port_dl - ref_dl) <= 1e-2 * abs(ref_dl), (port_dl, ref_dl)
    grads = [_step_grads(before, st, met["grad_norm"]) for st, met in (
        (grouped[1], grouped[2]), (vmapped[1], vmapped[2]),
        (grouped[3], grouped[4]), (vmapped[3], vmapped[4]))]
    for name in grads[0]:
        rel = _rel_l2(grads[3][name] - grads[2][name],
                      grads[1][name] - grads[0][name])
        assert rel <= 5e-2, (name, rel)


# --- the baselines served ----------------------------------------------------


@pytest.mark.parametrize("mode", ["per_group", "per_tensor"])
def test_moe_baselines_prequantized_stacks_match_reference(reference, mode):
    """``prequantize_params`` of the phi3.5-moe smoke model in per_group
    and per_tensor (each (layer, expert) slice against its own amax):
    every payload and scale bitwise the reference's."""
    from test_torch_serving import _params, _run_cfg

    ref = reference["baselines"]["build"][mode]
    cfg = _run_cfg(get_config, BASELINE_SERVE[f"{mode}-engine"])
    pq = tsteps.prequantize_params(cfg, _params(ARCH))
    got = dict(_leaf_items(pq.qweights))
    for name, want in _leaf_items(ref["qweights"]):
        _same(want, got[name])
    got = dict(_leaf_items(pq.scales))
    for name, want in _leaf_items(ref["scales"]):
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    assert got["blocks/moe/w_up"].shape == (2, cfg.n_experts)


@pytest.mark.parametrize("name", sorted(BASELINE_SERVE))
def test_moe_baselines_serve_as_the_reference(reference, name):
    """phi3.5-moe's smoke model served in per_group and per_tensor
    through the engine (floating pages, chunked prefill; both
    schedulers on a clock that ticks once a call, so that admissions
    are decided alike) and the legacy Server: the greedy streams equal
    the reference's (tests/test_torch_serving.py's rule: a request may
    stop early at a reference tie), the engine's counters equal, and
    every calibrated activation scale, per (layer, expert) at the
    expert sites, bit for bit."""
    from repro_torch.launch.serve import Server
    from repro_torch.serving import Engine, Request, SLOTargets

    from test_torch_serving import (
        CHUNK,
        COUNTERS,
        MAX_LEN,
        MAX_NEW,
        PINNED,
        SLOTS,
        _assert_streams,
        _params,
        _prompts,
        _run_cfg,
        _serve_waves,
    )

    run = BASELINE_SERVE[name]
    want = reference["baselines"][name]
    cfg = _run_cfg(get_config, run)
    params = _params(ARCH)
    if run.get("server"):
        reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(_prompts())]
        srv = Server(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                     device="cpu")
        srv.run(list(reqs), log=None)
        act = srv.act_scales
    else:
        eng = Engine(cfg, params, num_slots=SLOTS, chunk_tokens=CHUNK,
                     max_len=MAX_LEN, device="cpu",
                     slo=SLOTargets(**PINNED))
        assert eng.float_pages and eng.chunked
        reqs = _serve_waves(eng, run, Request)
        st = eng.stats()
        assert {k: st[k] for k in COUNTERS} == want["counters"]
        act = eng.act_scales
        assert sorted(act) == sorted(want["act_scales"])
        for tag, (s_bits, sub) in want["act_scales"].items():
            assert act[tag].sub is None and sub is None, tag
            assert bridge.bits(act[tag].s).reshape(-1).tolist() == s_bits, tag
        # per (layer, expert): per_group's scales also per 128-wide group
        assert act["blocks/moe/w_up"].s.shape[:2] == (cfg.n_layers,
                                                      cfg.n_experts)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    _assert_streams(reqs, want)
