"""The port's three kernels: each plain PyTorch version against the
reference's Pallas kernel in interpret mode and against its jnp oracle,
on the CPU.  (Each Hopper kernel against its plain version, on a card:
tests/test_torch_cuda.py.)

Tolerances: quantized payloads (q, sexp) are bitwise.  GEMM
accumulations agree within 1e-5 * max|ref|: every product of a bf16
and an fp8 value is exact in f32, so only the order of the f32 sums
differs.  Decode attention agrees within 1e-5 absolute: f32 sums and
the softmax's exp in another order/implementation."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.quant import PerTensorQ as JPerTensorQ
from repro.core.quant import quant_mx as jquant_mx
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attn_paged_pallas

from repro_torch import bridge
from repro_torch.core.quant import PerTensorQ, quant_mx, quant_per_tensor
from repro_torch.kernels import (dispatch, moe_gmm, mx_bwd, mx_fused, mx_gemm,
                                 mx_quant)

GEMM_SHAPES = [(5, 96, 200), (16, 256, 72), (1, 32, 33)]
# M > 32 (the wgmma tile on a card): ragged M and N, K % 64 == 32
LARGE_M_SHAPES = [(130, 96, 200), (256, 64, 136)]
# grouped experts (E, C, K, N): C not a multiple of the 128-row tile,
# ragged N, K % 64 == 32
MOE_SHAPES = [(2, 130, 96, 72), (3, 48, 64, 200)]
# dW (M tokens, K, N): M % 64 == 32, K not a multiple of 128, ragged N
DW_SHAPES = [(96, 352, 72), (64, 96, 200)]


def _x(m, k, seed, outliers=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if outliers:
        x *= 1 + 300.0 * (rng.random((m, k)) < 0.01)
    x[0, :32] = 0.0                         # an all-zero group
    if k >= 96:
        x[-1, 64:96] *= 1e-30               # a tiny-magnitude group
    return x


def _w(k, n, seed, fmt):
    rng = np.random.default_rng(seed + 1)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return quant_per_tensor(torch.tensor(w), fmt)


def _np(t):
    return np.asarray(t, np.float32)


def _close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol, \
        (float(np.abs(got - want).max()), tol)


_ML = {torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
       torch.float8_e5m2: ml_dtypes.float8_e5m2,
       torch.bfloat16: ml_dtypes.bfloat16}


def _jax(t: torch.Tensor):
    """A torch tensor as a JAX array with the same bits."""
    if t.dtype in _ML:
        return jnp.asarray(bridge.bits(t).view(_ML[t.dtype]))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES + LARGE_M_SHAPES)
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_mx_gemm_plain_matches_pallas_and_ref(m, k, n, fmt):
    xq = quant_mx(torch.tensor(_x(m, k, m + n)), 32, fmt)
    wq = _w(k, n, m, "e4m3")
    got = mx_gemm.mx_gemm(xq.q, xq.sexp, wq.q)          # CPU: plain
    qx, se, qw = _jax(xq.q), jnp.asarray(xq.sexp.numpy()), _jax(wq.q)
    ref = jref.mx_gemm_ref(qx, se, qw)
    one = jnp.float32(1.0)
    from repro.core.quant import MxQ as JMxQ
    pallas = jdispatch.mx_matmul(JMxQ(qx, se, one), JPerTensorQ(qw, one),
                                 out_dtype=jnp.float32, backend="interpret")
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, ref)
    _close(got, pallas)


def test_mx_gemm_tile_choice():
    """Up to 32 rows (decode and verify steps, prefill chunks, the
    calibration forward) the weight-streaming tile, above it the 128 x
    128 tile; ``fused_quant_gemm`` has no threshold of its own: its GEMM
    is ``mx_gemm``'s tile for M, behind the ``mx_quant`` kernel."""
    assert [mx_gemm.tile_for(m) for m in (1, 4, 16, 32, 33, 2048, 4160)] \
        == ["small"] * 4 + ["tiled"] * 3
    assert mx_gemm.SMALL_M == 32
    assert not hasattr(mx_fused, "SMALL_M")


# (K, N, split): phi3-mini-3.8b's q/k/v/o and gate/up, down and head;
# h2o-danube-3-4b's q/o, k/v, gate/up, down and head; a K that gives
# each CTA fewer than two stages past one split; a test shape
SPLITS = [(3072, 3072, 4), (3072, 8192, 1), (8192, 3072, 4),
          (3072, 32064, 1), (3840, 3840, 2), (3840, 960, 8),
          (3840, 10240, 1), (10240, 3840, 2), (3840, 32000, 1),
          (1056, 200, 4), (256, 72, 1)]


@pytest.mark.parametrize("k,n,split", SPLITS)
def test_small_tile_split_depends_on_k_and_n_only(k, n, split):
    """The M <= 32 tile's K split over a cluster: what ``small_split``
    picks from K and N (it takes no M, so a row's bits do not depend on
    the batch), a power of two up to 8 that leaves each CTA two 128-deep
    stages or more, and enough 64-column strips x split to cover most
    of the H100's 132 SMs where N alone does not."""
    got = mx_gemm.small_split(k, n)
    assert got == split
    stages = -(-k // mx_gemm.STAGE_K)
    strips = -(-n // mx_gemm.STRIP)
    assert got in (1, 2, 4, 8)
    assert got == 1 or stages >= 2 * got
    assert (strips * got >= 120 or got == mx_gemm.MAX_SPLIT
            or stages < 4 * got)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES + [(32, 256, 72)]
                         + LARGE_M_SHAPES)
@pytest.mark.parametrize("fmt,dtype", [("e4m3", torch.bfloat16),
                                       ("e5m2", torch.float32)])
def test_fused_quant_gemm_plain_is_quantizer_then_gemm(m, k, n, fmt, dtype):
    """The decomposition of the card's path at every M:
    ``fused_quant_gemm_plain`` equals ``mx_quant_plain`` followed by
    ``mx_gemm_plain`` bit for bit (payloads and sums), the forward (e4m3
    on bf16) and dx (e5m2 on f32) alike, at M <= 32 (the calibration
    forward) and above."""
    x = torch.tensor(_x(m, k, m + k)).to(dtype)
    qw = _w(k, n, n, "e4m3").q
    s = dispatch.global_scale(x, fmt)
    acc, q, sexp = mx_fused.fused_quant_gemm(x, s, qw, fmt)     # CPU: plain
    q2, sexp2 = mx_quant.mx_quant(x, s, fmt)
    acc2 = mx_gemm.mx_gemm(q2, sexp2, qw)
    np.testing.assert_array_equal(bridge.bits(q), bridge.bits(q2))
    np.testing.assert_array_equal(sexp.numpy(), sexp2.numpy())
    np.testing.assert_array_equal(bridge.bits(acc), bridge.bits(acc2))


@pytest.mark.parametrize("e,c,k,n", MOE_SHAPES)
@pytest.mark.parametrize("fmt,dtype", [("e4m3", torch.bfloat16),
                                       ("e5m2", torch.float32)])
def test_moe_gmm_plain_is_quantizer_then_gemm_per_expert(e, c, k, n, fmt,
                                                         dtype):
    """The decomposition of the grouped kernel's route: ``moe_gmm_plain``
    equals ``mx_quant_plain`` over the whole (E·C, K) buffer followed by
    ``mx_gemm_plain`` on each expert's slot against its weight, bit for
    bit (payloads and sums; at these widths the CPU's batched and single
    f32 products add in the same order), with zero rows past each
    expert's size as the dispatch leaves them."""
    x = torch.tensor(_x(e * c, k, e * c + k)).to(dtype)
    for i, size in enumerate((c // 2, 0, c)[:e]):
        x[i * c + size:(i + 1) * c] = 0
    qw = torch.stack([_w(k, n, n + i, "e4m3").q for i in range(e)])
    s = dispatch.global_scale(x, fmt)
    acc, q, sexp = moe_gmm.moe_gmm(x, s, qw, torch.full((e,), c,
                                                        dtype=torch.int32),
                                   c, fmt)                      # CPU: plain
    q2, sexp2 = mx_quant.mx_quant(x, s, fmt)
    acc2 = torch.cat([mx_gemm.mx_gemm(q2[i * c:(i + 1) * c],
                                      sexp2[i * c:(i + 1) * c], qw[i])
                      for i in range(e)])
    np.testing.assert_array_equal(bridge.bits(q), bridge.bits(q2))
    np.testing.assert_array_equal(sexp.numpy(), sexp2.numpy())
    np.testing.assert_array_equal(bridge.bits(acc), bridge.bits(acc2))


@pytest.mark.parametrize("m,k,n", DW_SHAPES)
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_dw_gemm_plain_is_requant_then_gemm(m, k, n, fmt):
    """The decomposition of both dW routes: ``mx_dw_gemm_plain`` equals
    the requant pass (``dw_requant``: q' (K, M), e' (K, M/32)) followed
    by ``mx_gemm_plain`` of (q', e') against the gradient, bit for bit;
    ``moe_dw_gemm_plain`` gives the same per slot, and a slot of zero
    rows (an empty expert) zero groups (q' 0, e' -127) and a zero dW."""
    xq = quant_mx(torch.tensor(_x(m, k, m + k)), 32, fmt)
    gq = quant_per_tensor(torch.tensor(_x(m, n, n, outliers=False)),
                          "e5m2").q
    acc, qt, et = mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq, fmt,
                                    payload=True)               # CPU: plain
    qt2, et2 = mx_bwd.dw_requant(xq.q, xq.sexp, fmt)
    acc2 = mx_gemm.mx_gemm(qt2, et2, gq)
    assert qt.shape == (k, m) and et.shape == (k, m // 32)
    np.testing.assert_array_equal(bridge.bits(qt), bridge.bits(qt2))
    np.testing.assert_array_equal(et.numpy(), et2.numpy())
    np.testing.assert_array_equal(bridge.bits(acc), bridge.bits(acc2))

    zero = torch.zeros_like(xq.q)
    acc_e, qt_e, et_e = moe_gmm.moe_dw_gemm(
        torch.cat([xq.q, zero]),
        torch.cat([xq.sexp, torch.full_like(xq.sexp, -127)]),
        torch.cat([gq, torch.zeros_like(gq)]),
        torch.tensor([m, 0], dtype=torch.int32), m, fmt, payload=True)
    np.testing.assert_array_equal(bridge.bits(qt_e[0]), bridge.bits(qt))
    np.testing.assert_array_equal(et_e[0].numpy(), et.numpy())
    np.testing.assert_array_equal(bridge.bits(acc_e[0]), bridge.bits(acc))
    assert not bool(qt_e[1].view(torch.uint8).any())
    assert bool((et_e[1] == -127).all()) and not bool(acc_e[1].any())


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fused_quant_gemm_plain_matches_pallas_and_ref(m, k, n, fmt):
    x = _x(m, k, 3 * m + n)
    wq = _w(k, n, m, fmt)
    y, xq = dispatch.fused_quant_matmul(
        torch.tensor(x), PerTensorQ(wq.q, torch.tensor(1.0)), fmt,
        out_dtype=torch.float32)
    qw = _jax(wq.q)
    one = jnp.float32(1.0)
    yp, xqp = jdispatch.fused_quant_matmul(
        jnp.asarray(x), JPerTensorQ(qw, one), fmt, out_dtype=jnp.float32,
        backend="interpret")
    jq = jquant_mx(jnp.asarray(x), 32, fmt)
    for ref_q, ref_e in ((xqp.q, xqp.sexp), (jq.q, jq.sexp)):
        np.testing.assert_array_equal(bridge.bits(xq.q),
                                      np.asarray(ref_q).view(np.uint8))
        np.testing.assert_array_equal(xq.sexp.numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(bridge.bits(xq.s).view(np.uint32),
                                  np.asarray(xqp.s).view(np.uint32))
    _close(y, yp)
    _close(y, jref.mx_gemm_ref(jq.q, jq.sexp, qw) * xqp.s)


@pytest.mark.parametrize("m,k,n", [(96, 256, 96), (130, 64, 160)])
def test_fused_quant_gemm_training_m_plain_matches_pallas(m, k, n):
    """M > 32 (mx_quant then the wgmma tile on a card): the forward in e4m3
    on bf16 activations and dx in e5m2 on an f32 gradient against the
    transposed e4m3 weights, through dispatch.  Payloads bitwise against
    the reference's ``ref`` branch (its Pallas kernel differs from it on
    one element of the tiny-magnitude bf16 group, where the flushes
    bite), the GEMM against both."""
    for fmt, x, wq in (
            ("e4m3", torch.tensor(_x(m, k, m)).bfloat16(), _w(k, n, m,
                                                               "e4m3")),
            ("e5m2", torch.tensor(_x(m, n, n)) * 1e-3,
             PerTensorQ(_w(k, n, n, "e4m3").q.T.contiguous(),
                        torch.tensor(0.01)))):
        y, xq = dispatch.fused_quant_matmul(x, wq, fmt,
                                            out_dtype=torch.float32)
        jx = _jax(x) if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())
        jwq = JPerTensorQ(_jax(wq.q), jnp.asarray(wq.s.numpy()))
        yr, xqr = jdispatch.fused_quant_matmul(
            jx, jwq, fmt, out_dtype=jnp.float32, backend="ref")
        yp, _ = jdispatch.fused_quant_matmul(
            jx, jwq, fmt, out_dtype=jnp.float32, backend="interpret")
        np.testing.assert_array_equal(bridge.bits(xq.q),
                                      np.asarray(xqr.q).view(np.uint8))
        np.testing.assert_array_equal(xq.sexp.numpy(), np.asarray(xqr.sexp))
        _close(y, yr)
        _close(y, yp)


# --- paged decode attention ----------------------------------------------

B, KV, G, DH, T, NP, POOL = 3, 2, 4, 32, 16, 4, 16


def _paged(seed, kv_dtype):
    """Queries, a scrambled pool (rows off the table hold garbage) and a
    block table; n_valid mixes a partial last page, a single token and
    a full slot."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, DH)).astype(np.float32)
    k = rng.standard_normal((POOL, KV, T, DH)).astype(np.float32)
    v = rng.standard_normal((POOL, KV, T, DH)).astype(np.float32)
    bt = rng.permutation(POOL)[:B * NP].reshape(B, NP).astype(np.int32)
    nv = np.array([37, 1, NP * T], np.int32)
    tk, tv = torch.tensor(k), torch.tensor(v)
    if kv_dtype == "fp8":
        from repro_torch.models.attention import _quant_kv

        (tk, ks), (tv, vs) = _quant_kv(tk), _quant_kv(tv)
    else:
        tk, tv, ks, vs = tk.bfloat16(), tv.bfloat16(), None, None
    return q, tk, tv, ks, vs, nv, bt


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_paged_plain_matches_pallas_and_ref(kv_dtype):
    q, k, v, ks, vs, nv, bt = _paged(11, kv_dtype)
    sm = DH ** -0.5
    got = dispatch.decode_attention_paged(
        torch.tensor(q), k, v, ks, vs, torch.tensor(nv), torch.tensor(bt),
        sm_scale=sm)
    jk, jv = _jax(k), _jax(v)
    jks = None if ks is None else jnp.asarray(ks.numpy())
    jvs = None if vs is None else jnp.asarray(vs.numpy())
    ref = jref.decode_attn_paged_ref(jnp.asarray(q), jk, jv, jks, jvs,
                                     jnp.asarray(nv), jnp.asarray(bt),
                                     sm_scale=sm)
    qp = jnp.pad(jnp.asarray(q), ((0, 0), (0, 0), (0, 8 - G), (0, 0)))
    pallas = decode_attn_paged_pallas(
        qp, jk, jv, jks, jvs, jnp.asarray(nv), jnp.asarray(bt),
        sm_scale=sm, interpret=True)[:, :, :G]
    assert got.shape == (B, KV, G, DH)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=0, atol=1e-5)


def test_decode_attn_never_reads_past_the_frontier():
    """Poisoning every slot at or past n_valid (NaN payloads, NaN
    scales) must not change the plain version's output."""
    q, k, v, ks, vs, nv, bt = _paged(5, "fp8")
    sm = DH ** -0.5
    args = (torch.tensor(q), k, v, ks, vs, torch.tensor(nv),
            torch.tensor(bt))
    clean = dispatch.decode_attention_paged(*args, sm_scale=sm)
    k2, v2, ks2, vs2 = k.clone(), v.clone(), ks.clone(), vs.clone()
    for b in range(B):
        for t in range(int(nv[b]), NP * T):
            p, o = bt[b, t // T], t % T
            ks2[p, :, o] = float("nan")
            vs2[p, :, o] = 1e30
    poisoned = dispatch.decode_attention_paged(
        torch.tensor(q), k2, v2, ks2, vs2, torch.tensor(nv),
        torch.tensor(bt), sm_scale=sm)
    np.testing.assert_array_equal(_np(clean), _np(poisoned))
