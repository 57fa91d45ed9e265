"""The paper's baseline recipes in the port, against the reference, on
the CPU: ``per_group`` (COAT, per-128-group scales along K) and
``per_tensor`` (Transformer Engine), the standalone two-level quantizer
and the quantizer/GEMM ablation entry points (``kernels.ops``).

Inputs are made from a seed with numpy and go through both packages;
the reference's ``qmm`` and train steps come from the one child process
of tests/test_torch_train.py (its ``reference`` fixture).  Tolerances,
with their reasons:

- quantized payloads (fp8 q, int8 sexp, f32 scales): bitwise;
- GEMM accumulations: within 1e-5 * max|ref|.  Every product of fp8
  values is exact in f32, so only the order of the f32 sums differs,
  and for the per-group GEMM the place of ``· s_w``: the reference's
  ``ref`` path multiplies each group's partial by ``s_x · s_w`` before
  summing, the kernel path (the port's on both devices, the Pallas
  kernel's) sums ``partial · s_x`` and applies ``s_w`` after;
- ``qmm``: the saved residuals bitwise, y and dx within 1e-5 * max|ref|,
  dW within rel L2 1e-5, as for moss in tests/test_torch_train.py;
- train steps: the limits of ``test_train_steps_match_reference``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core import formats as jformats
from repro.core.formats import QuantConfig as JQuantConfig
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.group_gemm import group_gemm_pallas
from repro.kernels.mx_quant import mx_quant_pallas
from repro.launch.train import quant_from_name as jquant_from_name

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import formats as tformats
from repro_torch.core import quant as tq
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import qmm
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import dispatch, group_gemm, mx_quant, ops
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import quant_mask_tree
from repro_torch.models.transformer import model_defs
from repro_torch.train import steps as tsteps

from test_torch_train import (  # noqa: F401  (reference: a fixture)
    ARCH,
    BASELINES,
    QMM_SHAPES,
    TRAIN_HP,
    _close_max,
    _leaf_items,
    _qmm_problem,
    _rel_l2,
    check_train_steps,
    recipe,
    reference,
)

_ML = {torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
       torch.float8_e5m2: ml_dtypes.float8_e5m2,
       torch.bfloat16: ml_dtypes.bfloat16}


def _jax(t: torch.Tensor):
    """A torch tensor as a JAX array with the same bits."""
    if t.dtype in _ML:
        return jnp.asarray(bridge.bits(t).view(_ML[t.dtype]))
    return jnp.asarray(t.numpy())


def _same(j, t: torch.Tensor):
    a = np.asarray(j)
    a = a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])
    b = bridge.bits(t)
    np.testing.assert_array_equal(a, b.view(a.dtype))


def _inputs(case: str, shape=(64, 512)) -> np.ndarray:
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "outlier":
        x *= 1 + 300.0 * (rng.random(shape) < 0.002)
        x[3, 100] = 1e4
    elif case == "zero_group":
        x[:, 128:256] = 0.0
        x[7] = 0.0
    elif case == "tiny_groups":
        x[:, :128] *= 1e-39         # subnormal: the reference flushes
        x[:, 256:384] *= 1e-33      # below TINY: amax clamps
        x[1, 400:420] = -1e-45
    return x


# --- the quantizers -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("case", ["outlier", "zero_group", "tiny_groups"])
def test_quant_per_group_matches_reference(case, fmt, dtype):
    x = _inputs(case)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    j, t = jq.quant_per_group(jx, 128, fmt), tq.quant_per_group(tx, 128, fmt)
    _same(j.q, t.q)
    _same(j.s, t.s)
    _same(j.dequant(jnp.bfloat16), t.dequant(torch.bfloat16))
    # against supplied scales (the delayed form)
    s = np.asarray(j.s) * np.float32(1.5)
    _same(jq.quant_per_group(jx, 128, fmt, scale=jnp.asarray(s)).q,
          tq.quant_per_group(tx, 128, fmt, scale=torch.tensor(s)).q)


MX_QUANT_CASES = [  # (m, k, fmt, input, Pallas blocks)
    (128, 512, "e4m3", "random", (128, 256)),
    (256, 1024, "e5m2", "random", (128, 256)),
    (128, 512, "e4m3", "outlier", (256, 512)),
    (128, 512, "e4m3", "bf16", (256, 512)),
    (128, 512, "e5m2", "bf16", (256, 512)),
]


@pytest.mark.parametrize("m,k,fmt,kind,blocks", MX_QUANT_CASES)
def test_mx_quant_plain_matches_pallas(m, k, fmt, kind, blocks):
    """The cases of tests/test_kernels.py's TestMxQuantKernel: the
    Pallas kernel takes ``exp2(e) · s`` as its denominator where
    ``quant_mx`` decodes the E8M0 exponent; the payloads agree."""
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(
        np.float32)
    if kind == "outlier":
        x[3, 100] = 1e4
    tx = torch.tensor(x)
    if kind == "bf16":
        tx = tx.bfloat16()
    s = dispatch.global_scale(tx, fmt)
    q, sexp = mx_quant.mx_quant(tx, s, fmt)              # CPU: plain
    bm, bk = blocks
    jqp, jep = mx_quant_pallas(_jax(tx), _jax(s), fmt=fmt, bm=bm, bk=bk,
                               interpret=True)
    _same(jqp, q)
    _same(jep, sexp)
    _same(jref.global_scale_ref(_jax(tx), fmt), s)


def _scale_input(case: str, shape) -> np.ndarray:
    rng = np.random.default_rng(shape[0] * shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "all_zero":
        x[:] = 0.0
    elif case == "all_subnormal":
        x = np.where(x < 0, -1e-40, 3e-39).astype(np.float32)
    elif case == "inf":
        x.flat[x.size // 2] = -np.inf
    elif case == "nan":
        x.flat[x.size - 1] = np.nan
    return x


@pytest.mark.parametrize("shape", [(1, 32), (5, 96), (33, 4096)])
@pytest.mark.parametrize("case", ["random", "all_zero", "all_subnormal",
                                  "inf", "nan"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_global_scale_matches_reference(dtype, fmt, case, shape):
    """The level-1 scale max(amax|x|, TINY) / FP8_MAX on the CPU (the
    plain version of the global_amax kernel) bit for bit the
    reference's: a NaN propagates, an inf gives an inf scale, zeros and
    subnormals give TINY / FP8_MAX."""
    tx = torch.tensor(_scale_input(case, shape))
    if dtype == "bf16":
        tx = tx.bfloat16()
    s = dispatch.global_scale(tx, fmt)
    want = jref.global_scale_ref(_jax(tx), fmt)
    assert s.shape == () and s.dtype == torch.float32
    if case == "nan":
        assert bool(torch.isnan(s)) and bool(jnp.isnan(want))
        return
    _same(want, s)
    if case in ("all_zero", "all_subnormal"):
        assert float(s) == float(np.float32(tformats.TINY)
                                 / np.float32(tformats.fp8_max(fmt)))
    if case == "inf":
        assert float(s) == np.inf


@pytest.mark.parametrize("call,args,error", [
    ("global_amax", (torch.zeros(4, 32, dtype=torch.int32),), TypeError),
    ("global_amax", (torch.zeros(0, 32),), ValueError),
    ("global_amax", (torch.zeros(4, 32), "e3m4"), ValueError),
    ("global_amax", (torch.zeros(4, 32, device="meta"),), ValueError),
    ("global_scale", (torch.zeros(4, 32, dtype=torch.float16),), TypeError),
    ("mx_quant", (torch.zeros(4, 32, dtype=torch.int32), torch.ones(())),
     TypeError),
    ("mx_quant", (torch.zeros(4, 48), torch.ones(())), ValueError),
    ("mx_quant", (torch.zeros(2, 4, 32), torch.ones(())), ValueError),
    ("mx_quant", (torch.zeros(4, 32), torch.ones(2)), ValueError),
    ("mx_quant", (torch.zeros(4, 32), torch.ones(()), "e3m4"), ValueError),
    ("mx_quant", (torch.zeros(4, 32, device="meta"), torch.ones(())),
     ValueError),
])
def test_quantizer_wrappers_reject_bad_arguments(call, args, error):
    """The quantizer's wrappers refuse what neither kernel takes, on any
    device, before they reach a kernel or a plain version."""
    fn = dispatch.global_scale if call == "global_scale" else \
        getattr(mx_quant, call)
    with pytest.raises(error):
        fn(*args)


@pytest.mark.parametrize("bk", [128, 256])
def test_group_gemm_plain_matches_pallas(bk):
    m, k, n = 128, 512, 256
    rng = np.random.default_rng(bk)
    xq = tq.quant_per_group(torch.tensor(_inputs("outlier", (m, k))), 128)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    qw = tq.quant_per_tensor(w).q
    got = group_gemm.group_gemm(xq.q, xq.s, qw)          # CPU: plain
    pallas = group_gemm_pallas(_jax(xq.q), _jax(xq.s), _jax(qw), bk=bk,
                               interpret=True)
    _close_max(got, pallas)
    _close_max(got, jref.group_gemm_ref(_jax(xq.q), _jax(xq.s), _jax(qw)))


def test_gemm_formulas_match_reference():
    """``core.quant``'s per-group GEMM (per-tensor and per-group weight
    scales) and per-tensor GEMM against the reference's, f32 out."""
    x, w = _operands(48, 384, 72)
    xg = tq.quant_per_group(torch.tensor(x), 128)
    jxg = jq.PerGroupQ(q=_jax(xg.q), s=_jax(xg.s))
    wt = tq.quant_per_tensor(torch.tensor(w))
    jwt = jq.PerTensorQ(q=_jax(wt.q), s=_jax(wt.s))
    wg = tq.quant_per_group(torch.tensor(w.T.copy()), 128)
    wg = tq.PerGroupQ(q=wg.q.T.contiguous(), s=wg.s.T.contiguous())
    jwg = jq.PerGroupQ(q=_jax(wg.q), s=_jax(wg.s))
    for tw, jw in ((wt, jwt), (wg, jwg)):
        _close_max(tq.group_gemm(xg, tw, torch.float32),
                   jq.group_gemm(jxg, jw, jnp.float32))
    xt = tq.quant_per_tensor(torch.tensor(x))
    _close_max(tq.pt_gemm(xt, wt, torch.float32),
               jq.pt_gemm(jq.PerTensorQ(q=_jax(xt.q), s=_jax(xt.s)), jwt,
                          jnp.float32))


def test_kernel_wrappers_refuse_what_they_cannot_take():
    x = torch.ones(4, 64)
    with pytest.raises(ValueError):
        mx_quant.mx_quant(torch.ones(4, 40), torch.tensor(1.0))  # K % 32
    with pytest.raises(TypeError):
        mx_quant.mx_quant(x.to(torch.float16), torch.tensor(1.0))
    qx = tq.quant_per_group(torch.ones(4, 256), 128)
    qw = tq.quant_per_tensor(torch.ones(256, 8)).q
    with pytest.raises(ValueError):
        group_gemm.group_gemm(qx.q, qx.s[:, :1], qw)       # sx shape
    with pytest.raises(TypeError):
        group_gemm.group_gemm(qx.q.float(), qx.s, qw)


# --- dispatch, ops --------------------------------------------------------

RAGGED = [(96, 384, 160), (5, 256, 72), (130, 128, 33)]   # (m, k, n)


def _operands(m, k, n):
    rng = np.random.default_rng(m * n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x *= 1 + 100.0 * (rng.random((m, k)) < 0.002)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_dispatch_matches_reference_on_ragged_shapes(m, k, n):
    """``mx_quantize`` bitwise against the reference dispatch's Pallas
    path (M padded to 8 there) and its ``ref`` path; ``group_matmul``
    and ``pt_matmul`` (f32 out) against both reference paths."""
    x, w = _operands(m, k, n)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    got = dispatch.mx_quantize(tx, "e5m2")
    for backend in ("interpret", "ref"):
        want = jdispatch.mx_quantize(jx, "e5m2", backend=backend)
        _same(want.q, got.q)
        _same(want.sexp, got.sexp)
        _same(want.s, got.s)

    xg = tq.quant_per_group(tx, 128)
    wq = tq.quant_per_tensor(torch.tensor(w))
    jxg = jq.PerGroupQ(q=_jax(xg.q), s=_jax(xg.s))
    jwq = jq.PerTensorQ(q=_jax(wq.q), s=_jax(wq.s))
    y = dispatch.group_matmul(xg, wq, out_dtype=torch.float32)
    assert y.shape == (m, n)
    for backend in ("interpret", "ref"):
        _close_max(y, jdispatch.group_matmul(jxg, jwq, jnp.float32,
                                             backend=backend))

    xt = tq.quant_per_tensor(tx)
    y = dispatch.pt_matmul(xt, wq, out_dtype=torch.float32)
    jxt = jq.PerTensorQ(q=_jax(xt.q), s=_jax(xt.s))
    _close_max(y, jdispatch.pt_matmul(jxt, jwq, jnp.float32))


def test_ops_match_reference(monkeypatch):
    """The four ablation entry points against the reference's, which
    take its Pallas kernels in interpret mode."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    m, k, n = 96, 384, 160
    x, w = _operands(m, k, n)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    q, sexp, s = ops.mx_quantize(tx)
    jqq, jse, js = jops.mx_quantize(jx)
    for a, b in ((jqq, q), (jse, sexp), (js, s)):
        _same(a, b)
    wq = tq.quant_per_tensor(torch.tensor(w))
    _close_max(ops.mx_matmul(q, sexp, wq.q, s, wq.s, torch.float32),
               jops.mx_matmul(jqq, jse, _jax(wq.q), js, _jax(wq.s),
                              jnp.float32))
    xg = tq.quant_per_group(tx, 128)
    _close_max(ops.coat_matmul(xg.q, xg.s, wq.q, wq.s, torch.float32),
               jops.coat_matmul(_jax(xg.q), _jax(xg.s), _jax(wq.q),
                                _jax(wq.s), jnp.float32))
    # ragged K (200): the zero pad to a micro-group multiple
    x3 = _operands(2 * 48, 200, 40)[0].reshape(2, 48, 200)
    w3 = _operands(7, 200, 40)[1]
    y = ops.moss_linear(torch.tensor(x3), torch.tensor(w3), torch.float32)
    assert y.shape == (2, 48, 40)
    _close_max(y, jops.moss_linear(jnp.asarray(x3), jnp.asarray(w3),
                                   jnp.float32))


def test_snr_functions_match_reference():
    """Paper Eq. 4 and the uniform-noise SNRs of Eqs. 5-7 (Table 7):
    the same quantizations, then means and logs in another order,
    rel 1e-5."""
    x = _inputs("outlier", (32, 256))
    jx, tx = jnp.asarray(x), torch.tensor(x)
    pairs = [(jq.model_snr_per_tensor(jx), tq.model_snr_per_tensor(tx)),
             (jq.model_snr_per_group(jx), tq.model_snr_per_group(tx)),
             (jq.model_snr_moss(jx), tq.model_snr_moss(tx)),
             (jq.snr_db(jx, jx * 1.01), tq.snr_db(tx, tx * 1.01))]
    for mode in ("bf16", "per_tensor", "per_group", "moss"):
        pairs.append((jq.scheme_snr(jx, JQuantConfig(mode=mode)),
                      tq.scheme_snr(tx, QuantConfig(mode=mode))))
    for j, t in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


# --- qmm in the baselines ---------------------------------------------------

def test_per_group_step_launches_group_gemm_at_every_site(monkeypatch):
    """One per_group smoke step with remat on (as at full width) reaches
    ``group_gemm`` once per linear site in the forward, once more per
    layer site in the remat recompute, and once each for dx and dW: the
    count chip_smoke.py holds the full-width step to on the card."""
    cfg = get_config(ARCH, smoke=True).replace(
        quant=QuantConfig(**recipe("per_group")), remat=True)
    defs = model_defs(cfg)
    sites = layer_sites = 0
    for (name, q), (_, d) in zip(_leaf_items(quant_mask_tree(defs)),
                                 _leaf_items(defs)):
        if q:
            stacked = d.logical[0] == "layers"
            sites += d.shape[0] if stacked else 1
            layer_sites += d.shape[0] if stacked else 0
    calls = []
    kernel = dispatch.group_gemm
    monkeypatch.setattr(dispatch, "group_gemm",
                        lambda *a: calls.append(1) or kernel(*a))
    hp = tsteps.TrainHParams(**TRAIN_HP)
    state = tsteps.init_train_state(cfg, hp, seed=0, device="cpu")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=2)).batch_for_step(0)
    _, met = tsteps.make_train_step(cfg, hp)(state, batch)
    assert np.isfinite(float(met["loss"]))
    assert layer_sites == 7 * cfg.n_layers
    assert len(calls) == 3 * sites + layer_sites


def test_train_cli_runs_the_baselines():
    """``--quant`` takes all four recipes, mapped as the reference's CLI
    maps them (and the baselines' named configs equal the reference's);
    ``python -m repro_torch.launch.train --quant per_group
    --smoke --device cpu --steps 2`` trains (per_tensor's steps are held
    to the reference above)."""
    for name in ttrain.QUANTS:
        got, want = ttrain.quant_from_name(name), jquant_from_name(name)
        assert got.__dict__ == want.__dict__, name
    for name in ("PER_TENSOR_CONFIG", "PER_GROUP_CONFIG"):
        assert getattr(tformats, name).__dict__ == \
            getattr(jformats, name).__dict__
    state, hist = ttrain.main(["--arch", ARCH, "--quant", "per_group",
                               "--smoke", "--device", "cpu", "--steps", "2"])
    assert [step for step, _ in hist] == [2]
    assert all(np.isfinite(loss) for _, loss in hist)
    assert all(t.device.type == "cpu" for t in tree_leaves(state.params))


@pytest.mark.parametrize("xshape,n", QMM_SHAPES)
@pytest.mark.parametrize("mode", BASELINES)
def test_qmm_vjp_matches_reference(reference, mode, xshape, n):
    """y, dx and dW against ``jax.vjp`` of the reference ``qmm`` on the
    tests/test_dispatch.py ragged-K matrix; the fp8 residuals the
    forward saves (x: q, s; w: q, s) bitwise the reference's."""
    x, w, g, s = _qmm_problem(xshape, n)
    y_ref, dx_ref, dw_ref, *res = reference["qmm"][
        mode, QMM_SHAPES.index((xshape, n))]
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = qmm(QuantConfig(**recipe(mode)), tx, tw, torch.tensor(s))
    saved = y.grad_fn.saved_tensors
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.tensor(g))
    assert y.dtype == tx.dtype and dx.shape == tx.shape
    _close_max(y, y_ref)
    _close_max(dx, dx_ref)
    assert _rel_l2(dw, dw_ref) < 1e-5
    assert [t.dtype for t in saved] == [torch.float8_e4m3fn, torch.float32] * 2
    for got, want in zip(saved, res):
        np.testing.assert_array_equal(
            bridge.bits(got).reshape(-1),
            np.asarray(want).reshape(-1).view(bridge.bits(got).dtype))


# --- training --------------------------------------------------------------

def _measured_s0(params, defs) -> dict:
    """``max(amax, TINY) / FP8_MAX`` per stacked slice, in numpy f32."""
    sdims = dict(_leaf_items(tsteps._scale_dims(defs)))
    out = {}
    for name, w in _leaf_items(params):
        w = np.abs(np.asarray(w, np.float32))
        axes = tuple(range(sdims[name], w.ndim))
        amax = w.max(axis=axes) if axes else w
        out[name] = np.maximum(amax, np.float32(1e-30)) / np.float32(448.0)
    return out


@pytest.mark.parametrize("mode", BASELINES)
def test_train_steps_match_reference(reference, mode):
    """olmo-7b smoke in the baseline recipe (just-in-time weight
    scales): three port steps from the reference's
    ``init_train_state``, each held against the reference's step from
    the same state on the same batch, with the limits of
    tests/test_torch_train.py's test of the same name.  The scale
    states follow the reference's jit trajectory: ``scale_t`` stays 0
    (a refresh every step), and ``scale_s0`` after each step is the
    measured scale of the step's new parameters, bitwise (and within
    1e-2 relative of the reference's, whose parameters differ by the
    update noise the step limits allow).  Measured on a CPU (per_group
    / per_tensor): loss rel at most 1.1e-5 / 1.4e-7, step-0 gradients
    6.5e-4 / 1.4e-6, updates 2.2e-2 / 1.3e-2, unsettled 2.0% / 0.39%,
    ``scale_s0`` against the reference's 1.8e-4 / 7.4e-5."""
    runs = reference["train"][mode]
    worst = check_train_steps(runs)
    defs = model_defs(get_config(ARCH, smoke=True))
    worst["s0"] = 0.0
    for before, rs, _, ps, _ in runs:
        assert all(int(t) == 0 for _, t in _leaf_items(ps.scale_t))
        want = _measured_s0(ps.params, defs)
        ref_s0 = dict(_leaf_items(rs.scale_s0))
        for name, s0 in _leaf_items(ps.scale_s0):
            np.testing.assert_array_equal(s0, want[name])
            rel = float(np.max(np.abs(s0 / ref_s0[name] - 1.0)))
            worst["s0"] = max(worst["s0"], rel)
            assert rel <= 1e-2, (name, rel)
    print(mode, worst)


