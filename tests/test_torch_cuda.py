"""Each Hopper kernel of the port against its plain PyTorch version, on
an NVIDIA GPU.  Every test here carries the ``cuda`` marker and skips
without a card (the kernels have no CPU mode); the module imports no
JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: payloads bitwise, GEMM
accumulations within 1e-5 * max|plain| (f32 sum order only), attention
within 1e-5 absolute."""

import numpy as np
import pytest
import torch

from repro_torch.core.formats import fp8_dtype
from repro_torch.core.quant import (PerTensorQ, quant_mx, quant_per_group,
                                    quant_per_tensor)
from repro_torch.kernels import (decode_attn, dispatch, group_gemm, moe_gmm,
                                 mx_bwd, mx_fused, mx_gemm, mx_quant)
from repro_torch.models.attention import _quant_kv

pytestmark = pytest.mark.cuda

GEMM_SHAPES = [(5, 96, 200), (16, 256, 72), (1, 32, 33), (4, 3072, 3072),
               (32, 3072, 8192)]
# M > 32 takes mx_quant then mx_gemm's wgmma tile: ragged M, N and a
# single-group K
LARGE_M_SHAPES = [(33, 96, 200), (130, 256, 72), (256, 32, 129),
                  (512, 4096, 256)]
# M <= 32 takes mx_gemm's weight-streaming tile (M, K, N): M 1-32; K
# split over a cluster (1056 and 8192: 4, 10240 x 3840: 2, 3840 x 960:
# 8); ragged N by TMA (208) and by byte loads (33, 200, 72); K % 64 == 32
# (96, 1056)
SMALL_SHAPES = [(1, 32, 33), (4, 96, 200), (8, 256, 72), (16, 1056, 208),
                (20, 1056, 200), (32, 96, 64), (4, 8192, 3072),
                (16, 10240, 3840), (32, 3840, 960), (1, 3840, 960),
                (20, 3072, 8192)]
# M > 32 takes mx_gemm's wgmma tile: ragged M and N (N odd: byte loads),
# K % 64 == 32, one K group, full 128 x 128 tiles
TILED_SHAPES = [(33, 96, 200), (130, 96, 200), (256, 64, 136),
                (200, 160, 129), (65, 32, 40), (512, 4096, 256)]
# dW (M tokens, K, N): the tile's rows are K, its contraction M.  K not
# a multiple of 128 (ragged tile rows), M % 64 == 32 (a half step), N
# not a multiple of 16 (byte loads), and olmo-7b's 2048 tokens at a cut N
DW_SHAPES = [(128, 256, 192), (256, 96, 200), (64, 4096, 130),
             (96, 352, 144), (224, 4128, 33), (2048, 4096, 1024)]
# (m, k, n): ragged M and N, one group, and olmo-7b's per_group forward
# (M 2048, K 4096) and dW (K 11008 rows, 2048 tokens) at a cut N
GROUP_SHAPES = [(5, 256, 72), (130, 384, 200), (64, 128, 33),
                (2048, 4096, 1024), (11008, 2048, 256)]
QUANT_SHAPES = [(1, 32), (5, 96), (33, 4096), (2048, 11008)]
# grouped experts (E, C, K, N): C not a multiple of the 128-row tile
# (the ragged last block of each slot), ragged N, one K group
MOE_SHAPES = [(4, 200, 256, 200), (3, 48, 96, 72), (2, 130, 4096, 256),
              (16, 136, 32, 129)]
# grouped dW (E, Cp, K, N): Cp a multiple of 32; _moe_sizes gives
# contractions (m_end) that are multiples of 32 but not of 64 (17 -> 32,
# 96, 160, 224), K not a multiple of 128, N not a multiple of 16
MOE_DW_SHAPES = [(4, 224, 256, 200), (2, 32, 96, 72), (3, 1344, 128, 130),
                 (5, 96, 352, 144), (3, 160, 128, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x *= 1 + 300.0 * (rng.random((m, k)) < 0.01)
    x[0, :32] = 0.0                         # an all-zero group
    if k >= 96:
        x[-1, 64:96] *= 1e-30               # a tiny-magnitude group
    return torch.tensor(x)


def _close(got, want, rel=1e-5):
    got, want = got.cpu(), want.cpu()
    tol = rel * max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_gemm_kernels_match_plain(cuda, fmt):
    for m, k, n in GEMM_SHAPES:
        x = _x(m, k, m + n).to(cuda)
        w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                         dtype=torch.float32) * 0.05
        qw = quant_per_tensor(w, fmt).q.to(cuda)
        s = dispatch.global_scale(x, fmt)
        acc, q, se = mx_fused.fused_quant_gemm(x, s, qw, fmt)
        acc_p, q_p, se_p = mx_fused.fused_quant_gemm_plain(x, s, qw, fmt)
        assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
        assert torch.equal(se, se_p)
        _close(acc, acc_p)
        xq = quant_mx(x, 32, fmt)
        _close(mx_gemm.mx_gemm(xq.q, xq.sexp, qw),
               mx_gemm.mx_gemm_plain(xq.q, xq.sexp, qw))


@pytest.mark.parametrize("x_fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("w_fmt", ["e4m3", "e5m2"])
def test_mx_gemm_tiled_matches_plain(cuda, x_fmt, w_fmt):
    """The wgmma tile (M > 32) against the plain version in all four
    operand formats, ragged shapes included; two calls agree bit for
    bit (no split-K, no atomics)."""
    for m, k, n in TILED_SHAPES:
        xq = quant_mx(_x(m, k, m + n).to(cuda), 32, x_fmt)
        w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                         dtype=torch.float32) * 0.05
        qw = quant_per_tensor(w, w_fmt).q.to(cuda)
        before = mx_gemm.counter_tiled.count
        got = mx_gemm.mx_gemm(xq.q, xq.sexp, qw)
        again = mx_gemm.mx_gemm(xq.q, xq.sexp, qw)
        assert mx_gemm.counter_tiled.count == before + 2
        assert torch.isfinite(got).all()
        _close(got, mx_gemm.mx_gemm_plain(xq.q, xq.sexp, qw))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_mx_gemm_tiled_operands_are_bitwise(cuda):
    """Against an identity weight every output is one operand value:
    bf16(q * 2^e) bit for bit, at exponents down to -127 (bf16
    subnormals) and up to 100, in both payload formats."""
    m, k = 96, 128
    rng = np.random.default_rng(7)
    one = torch.eye(k).to(torch.float8_e4m3fn).to(cuda)
    for fmt in ("e4m3", "e5m2"):
        xq = quant_mx(torch.tensor(rng.standard_normal((m, k)),
                                   dtype=torch.float32), 32, fmt)
        sexp = torch.tensor(rng.integers(-127, 101, (m, k // 32)),
                            dtype=torch.int8)
        sexp[:8] = -127
        q, sexp = xq.q.to(cuda), sexp.to(cuda)
        got = mx_gemm.mx_gemm(q, sexp, one)
        want = mx_gemm.mx_gemm_plain(q, sexp, one)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_mx_gemm_tile_switches_above_32_rows(cuda):
    """M = 32 takes the weight-streaming tile, M = 33 the 128 x 128 tile;
    both agree with the plain version on the same rows."""
    k, n = 256, 200
    xq = quant_mx(_x(33, k, 5).to(cuda), 32, "e4m3")
    qw = quant_per_tensor(torch.tensor(np.random.default_rng(5)
                                       .standard_normal((k, n)),
                                       dtype=torch.float32)).q.to(cuda)
    for m, small, tiled in ((32, 1, 0), (33, 0, 1)):
        counts = mx_gemm.counter.count, mx_gemm.counter_tiled.count
        q, se = xq.q[:m].contiguous(), xq.sexp[:m].contiguous()
        got = mx_gemm.mx_gemm(q, se, qw)
        assert (mx_gemm.counter.count - counts[0],
                mx_gemm.counter_tiled.count - counts[1]) == (small, tiled)
        _close(got, mx_gemm.mx_gemm_plain(q, se, qw))


def _small_operands(cuda, m, k, n, x_fmt, w_fmt, seed):
    xq = quant_mx(_x(m, k, seed).to(cuda), 32, x_fmt)
    w = torch.tensor(np.random.default_rng(n + seed).standard_normal((k, n)),
                     dtype=torch.float32) * 0.05
    return xq.q, xq.sexp, quant_per_tensor(w, w_fmt).q.to(cuda)


@pytest.mark.parametrize("x_fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("w_fmt", ["e4m3", "e5m2"])
def test_mx_gemm_small_matches_plain(cuda, x_fmt, w_fmt):
    """The weight-streaming tile (M <= 32) against the plain version in
    all four operand formats: M 1-32, the K splits over a cluster,
    ragged N by TMA and by byte loads, K % 64 == 32; two calls agree bit
    for bit (the split's sums are added in rank order, no atomics)."""
    for m, k, n in SMALL_SHAPES:
        q, se, qw = _small_operands(cuda, m, k, n, x_fmt, w_fmt, m + n)
        before = mx_gemm.counter.count
        got = mx_gemm.mx_gemm(q, se, qw)
        again = mx_gemm.mx_gemm(q, se, qw)
        assert mx_gemm.counter.count == before + 2
        assert torch.isfinite(got).all()
        _close(got, mx_gemm.mx_gemm_plain(q, se, qw))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("k,n", [(3072, 3072), (3072, 8192), (1056, 200),
                                 (3840, 960)])
def test_mx_gemm_small_rows_do_not_depend_on_the_batch(cuda, k, n):
    """A row gives the same bits in a decode (M 4), verify (M 16) or
    chunk (M 32) step, at any position: the rows of an M 4 call equal
    the same rows placed at other positions of M 16 and M 32 calls, bit
    for bit, with and without a K split and with byte loads (N 200).
    The serving stream checks (identity vs floating pages, speculative
    vs plain) rely on it."""
    q, se, qw = _small_operands(cuda, 32, k, n, "e4m3", "e4m3", k + n)
    four = mx_gemm.mx_gemm(q[:4].contiguous(), se[:4].contiguous(), qw)
    for m, at in ((16, 9), (16, 12), (32, 27), (32, 0)):
        rows = (torch.arange(m, device=cuda) + 4) % 32
        rows[at:at + 4] = torch.arange(4, device=cuda)
        got = mx_gemm.mx_gemm(q[rows].contiguous(), se[rows].contiguous(),
                              qw)
        assert torch.equal(got[at:at + 4].view(torch.int32),
                           four.view(torch.int32)), (m, at)


def test_mx_gemm_small_operands_are_bitwise(cuda):
    """Against an identity weight every output of the M <= 32 tile is one
    operand value: bf16(q * 2^e) bit for bit, at exponents down to -127
    (bf16 subnormals) and up to 100, in both payload formats, with one
    CTA per strip (K 128) and with K split over four (K 1024)."""
    rng = np.random.default_rng(11)
    for k in (128, 1024):
        one = torch.eye(k).to(torch.float8_e4m3fn).to(cuda)
        for fmt in ("e4m3", "e5m2"):
            xq = quant_mx(torch.tensor(rng.standard_normal((20, k)),
                                       dtype=torch.float32), 32, fmt)
            sexp = torch.tensor(rng.integers(-127, 101, (20, k // 32)),
                                dtype=torch.int8)
            sexp[:3] = -127
            q, sexp = xq.q.to(cuda), sexp.to(cuda)
            got = mx_gemm.mx_gemm(q, sexp, one)
            want = mx_gemm.mx_gemm_plain(q, sexp, one)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("m,k,n", [(32, 3072, 8192), (5, 96, 200)])
def test_fused_quant_gemm_small_is_one_quantizer_and_one_tile(cuda, m, k, n):
    """fused_quant_gemm at M <= 32 is one mx_quant launch and one launch
    of the weight-streaming tile (by TMA, and by byte loads at N 200):
    payloads bitwise the plain version's, sums within 1e-5 * max|plain|."""
    x = _x(m, k, m + k).to(cuda)
    w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                     dtype=torch.float32) * 0.05
    qw = quant_per_tensor(w, "e4m3").q.to(cuda)
    for fmt in ("e4m3", "e5m2"):
        s = dispatch.global_scale(x, fmt)
        counters = (mx_quant.counter, mx_gemm.counter, mx_gemm.counter_tiled,
                    mx_fused.counter, mx_fused.counter_tiled)
        before = [c.count for c in counters]
        acc, q, se = mx_fused.fused_quant_gemm(x, s, qw, fmt)
        assert [c.count - b for c, b in zip(counters, before)] \
            == [1, 1, 0, 1, 0]
        acc_p, q_p, se_p = mx_fused.fused_quant_gemm_plain(x, s, qw, fmt)
        assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
        assert torch.equal(se, se_p)
        _close(acc, acc_p)


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_matches_plain(cuda, kv_dtype):
    b, kvh, g, dh, t, n_p, pool = 3, 2, 4, 96, 16, 4, 16
    rng = np.random.default_rng(3)
    q = torch.zeros((b, kvh, 8, dh))
    q[:, :, :g] = torch.tensor(rng.standard_normal((b, kvh, g, dh)),
                               dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((pool, kvh, t, dh)),
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((pool, kvh, t, dh)),
                     dtype=torch.float32)
    if kv_dtype == "fp8":
        (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
    else:
        k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
    bt = torch.tensor(rng.permutation(pool)[:b * n_p].reshape(b, n_p),
                      dtype=torch.int32)
    nv = torch.tensor([37, 1, n_p * t], dtype=torch.int32)
    args = [None if a is None else a.to(cuda)
            for a in (q, k, v, ks, vs, nv, bt)]
    got = decode_attn.decode_attn_paged(*args, sm_scale=dh ** -0.5)
    want = decode_attn.decode_attn_paged_plain(*args, sm_scale=dh ** -0.5)
    assert float((got - want).abs().max()) <= 1e-5


# contiguous decode attention (B, KV, G, Dh, C, n_valid): h2o-danube-3-4b's
# decode at full width (rows 0-1 wrapped past C, 2-3 partial), a ragged
# small case, and recurrentgemma's local attention (G 10, Dh 256)
RING_SHAPES = [(4, 8, 4, 120, 4096, [4100, 4200, 300, 97]),
               (3, 2, 1, 96, 40, [41, 1, 17]),
               (2, 1, 10, 256, 2048, [2048, 3000])]


def _decode_attn_f64(q, k, v, ks, vs, nv, sm):
    """decode_attn_ref's function in float64 (bf16 q and K, the weights
    rounded to bf16 as there)."""
    c = k.shape[2]
    f = lambda t: t.float().to(torch.bfloat16).double()
    s = torch.einsum("bkgd,bktd->bkgt", f(q), f(k)) * sm
    if ks is not None:
        s = s * ks.double()[:, :, None, :]
    live = torch.arange(c, device=q.device)[None] < \
        torch.clamp_max(nv.long(), c)[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = p / p.sum(dim=-1, keepdim=True)
    if vs is not None:
        w = w * vs.double()[:, :, None, :]
    return torch.einsum("bkgt,bktd->bkgd", w.to(torch.bfloat16).double(),
                        f(v))


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_contiguous_matches_plain(cuda, kv_dtype):
    """Within 1e-5 absolute plus twice the plain version's own round-off
    against a float64 evaluation: over thousands of slots the f32 sums
    taken in another order flip the bf16 rounding of some weights, so
    the two f32 versions drift apart with the context length."""
    rng = np.random.default_rng(5)
    for b, kvh, g, dh, c, nv in RING_SHAPES:
        q = torch.tensor(rng.standard_normal((b, kvh, g, dh)),
                         dtype=torch.float32)
        k = torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                         dtype=torch.float32)
        v = torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                         dtype=torch.float32)
        if kv_dtype == "fp8":
            (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
        else:
            k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
        nv = torch.tensor(nv, dtype=torch.int32)
        args = [None if a is None else a.to(cuda)
                for a in (q, k, v, ks, vs, nv)]
        got = decode_attn.decode_attn(*args, sm_scale=dh ** -0.5)
        want = decode_attn.decode_attn_ref(*args, sm_scale=dh ** -0.5)
        exact = _decode_attn_f64(*args, dh ** -0.5)
        own = float((want.double() - exact).abs().max())
        err = float((got - want).abs().max())
        assert err <= 1e-5 + 2 * own, (b, g, dh, c, err, own)


def test_decode_attn_layouts_give_the_same_bits(cuda):
    """The paged and the contiguous kernel over the same bytes (the cache
    cut into pages in order) at Dh 256: one operation order."""
    b, kvh, g, dh, t, n_p = 2, 2, 10, 256, 16, 8
    rng = np.random.default_rng(6)
    q = torch.tensor(rng.standard_normal((b, kvh, g, dh)),
                     dtype=torch.float32, device=cuda)
    k, ks = _quant_kv(torch.tensor(
        rng.standard_normal((b, kvh, n_p * t, dh)), dtype=torch.float32,
        device=cuda))
    v, vs = _quant_kv(torch.tensor(
        rng.standard_normal((b, kvh, n_p * t, dh)), dtype=torch.float32,
        device=cuda))

    def pages(x):
        x = x.reshape(b, kvh, n_p, t, *x.shape[3:]).movedim(2, 1)
        return x.reshape(b * n_p, kvh, t, *x.shape[4:]).contiguous()

    bt = torch.arange(b * n_p, dtype=torch.int32, device=cuda).reshape(
        b, n_p)
    nv = torch.tensor([100, 128], dtype=torch.int32, device=cuda)
    got = decode_attn.decode_attn(q, k, v, ks, vs, nv, sm_scale=0.0625)
    paged = decode_attn.decode_attn_paged(
        q, pages(k.view(torch.uint8)).view(k.dtype),
        pages(v.view(torch.uint8)).view(v.dtype), pages(ks), pages(vs),
        nv, bt, sm_scale=0.0625)
    assert torch.equal(got, paged)


def test_decode_attention_contiguous_dispatch_passes_true_group_rows(
        cuda, monkeypatch):
    """G = 4 (h2o-danube-3-4b): the kernel gets the 4 rows, no padded
    copy, and agrees with the padded plain path; a scalar n_valid is
    broadcast."""
    b, kvh, g, dh, c = 2, 3, 4, 120, 64
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.standard_normal((b, kvh, g, dh)),
                     dtype=torch.float32)
    k, ks = _quant_kv(torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                                   dtype=torch.float32))
    v, vs = _quant_kv(torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                                   dtype=torch.float32))
    nv = torch.tensor(70, dtype=torch.int32)
    cpu = (q, k, v, ks, vs, nv)
    seen = []
    kernel = dispatch.decode_attn

    def spy(qq, *a, **kw):
        seen.append(tuple(qq.shape))
        return kernel(qq, *a, **kw)

    want = dispatch.decode_attention(*cpu)
    monkeypatch.setattr(dispatch, "decode_attn", spy)
    got = dispatch.decode_attention(*[a.to(cuda) for a in cpu])
    assert seen == [(b, kvh, g, dh)]
    assert float((got.cpu() - want).abs().max()) <= 1e-5


# the verify form (B, KV, S, G, Dh, T, NP, n_valid): phi3-mini's (G 1: one
# block of 4 live rows a (b, kv head)), h2o-danube-3-4b's group (G 4: 16
# rows, two blocks) and a group of 10 at Dh 256 (rows across blocks)
VERIFY_SHAPES = [(4, 32, 4, 1, 96, 16, 4, [17, 64, 33, 5]),
                 (3, 2, 4, 4, 120, 16, 4, [40, 4, 64]),
                 (2, 2, 3, 10, 256, 16, 8, [100, 128])]


def _verify_case(shape, kv_dtype, seed, device):
    """q (B, KV, S, G, Dh), a contiguous cache of NP·T slots, the same
    bytes as a scrambled page pool with its block table, and n_valid."""
    b, kvh, s, g, dh, t, n_p, nv = shape
    rng = np.random.default_rng(seed)
    c = n_p * t
    q = torch.tensor(rng.standard_normal((b, kvh, s, g, dh)),
                     dtype=torch.float32)
    kf = torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                      dtype=torch.float32)
    vf = torch.tensor(rng.standard_normal((b, kvh, c, dh)),
                      dtype=torch.float32)
    if kv_dtype == "fp8":
        (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
    else:
        k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
    perm = torch.tensor(rng.permutation(b * n_p), dtype=torch.int64)

    def pool(x):
        if x is None:
            return None
        raw = x.view(torch.uint8) if x.element_size() == 1 else x
        p = raw.reshape(b, kvh, n_p, t, *x.shape[3:]).movedim(2, 1)
        p = p.reshape(b * n_p, kvh, t, *x.shape[3:])[perm].contiguous()
        return p.view(x.dtype) if x.element_size() == 1 else p

    bt = torch.argsort(perm).reshape(b, n_p).to(torch.int32)
    cont = [None if x is None else x.to(device) for x in (k, v, ks, vs)]
    paged = [None if x is None else pool(x).to(device)
             for x in (k, v, ks, vs)]
    return (q.to(device), cont, paged, bt.to(device),
            torch.tensor(nv, dtype=torch.int32, device=device))


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_verify_matches_plain_and_single_query(cuda, kv_dtype):
    """The q_len > 1 form in both layouts: within 1e-5 of the 5-D plain
    version, the two layouts bitwise equal, and each draft row bitwise
    the q_len = 1 kernel at that draft's limit (n_valid - (S-1-j))."""
    for i, shape in enumerate(VERIFY_SHAPES):
        q, cont, paged, bt, nv = _verify_case(shape, kv_dtype, 10 + i, cuda)
        b, kvh, s, g, dh = q.shape
        sm = dh ** -0.5
        rows = q.reshape(b, kvh, s * g, dh)
        got = decode_attn.decode_attn(rows, *cont, nv, sm_scale=sm,
                                      q_len=s)
        got_p = decode_attn.decode_attn_paged(rows, *paged, nv, bt,
                                              sm_scale=sm, q_len=s)
        want = decode_attn.decode_attn_ref(q, *cont, nv, sm_scale=sm)
        assert torch.equal(got, got_p), shape
        err = float((got.reshape(q.shape) - want).abs().max())
        assert err <= 1e-5, (shape, kv_dtype, err)
        for j in range(s):
            nv_j = nv - (s - 1 - j)
            solo = decode_attn.decode_attn(q[:, :, j].contiguous(), *cont,
                                           nv_j, sm_scale=sm)
            solo_p = decode_attn.decode_attn_paged(
                q[:, :, j].contiguous(), *paged, nv_j, bt, sm_scale=sm)
            assert torch.equal(got.reshape(q.shape)[:, :, j], solo)
            assert torch.equal(got_p.reshape(q.shape)[:, :, j], solo_p)


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_verify_ignores_nan_past_the_limits(cuda, kv_dtype):
    """NaN payloads and scales in every slot at or past n_valid (the
    trash page, stale bytes) leave both layouts' verify outputs finite
    and bitwise unchanged; NaN in the later drafts' slots, past draft
    0's own limit (rejected drafts' bytes), leaves draft 0's rows so."""
    q, cont, paged, bt, nv = _verify_case(VERIFY_SHAPES[1], kv_dtype, 3,
                                          cuda)
    b, kvh, s, g, dh = q.shape
    rows = q.reshape(b, kvh, s * g, dh)
    t = paged[0].shape[2]

    def run():
        return (decode_attn.decode_attn(rows, *cont, nv, sm_scale=0.1,
                                        q_len=s),
                decode_attn.decode_attn_paged(rows, *paged, nv, bt,
                                              sm_scale=0.1, q_len=s))

    def fill(lo_of):
        """NaN into the slots from lo_of(n_valid[b]) on, in both layouts
        (0x7F is e4m3fn's NaN)."""
        for bi in range(b):
            lo = lo_of(int(nv[bi]))
            for slot in range(lo, bt.shape[1] * t):
                page, off = int(bt[bi, slot // t]), slot % t
                for x, where in [(x, (bi, slice(None), slot)) for x in cont
                                 if x is not None] + \
                        [(x, (page, slice(None), off)) for x in paged
                         if x is not None]:
                    raw = x.view(torch.uint8) if x.element_size() == 1 \
                        else x
                    raw[where] = 0x7F if raw.dtype == torch.uint8 \
                        else float("nan")

    clean, clean_p = run()
    fill(lambda n: n)
    got, got_p = run()
    assert bool(torch.isfinite(got).all() and torch.isfinite(got_p).all())
    assert torch.equal(got, clean) and torch.equal(got_p, clean_p)
    fill(lambda n: n - (s - 1))
    got, got_p = run()
    first = slice(0, g)                       # draft 0's rows
    for out, ref in ((got, clean), (got_p, clean_p)):
        assert bool(torch.isfinite(out[:, :, first]).all())
        assert torch.equal(out[:, :, first], ref[:, :, first])


def _kv_cache(rng, shape, kv_dtype, device):
    """k, v, k_scale, v_scale of a (B, KV, C, Dh) cache (scales None in
    bf16), from the standard normal."""
    k = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    if kv_dtype == "fp8":
        (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
    else:
        k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
    return [None if x is None else x.to(device) for x in (k, v, ks, vs)]


def _raw(x):
    return x.view(torch.uint8) if x.element_size() == 1 else x


def _first_slots(cache, c):
    """The first c slots of each (B, KV, C, ...) tensor, contiguous."""
    return [None if x is None else
            _raw(x)[:, :, :c].contiguous().view(x.dtype) for x in cache]


def _paged(cache, t, rng):
    """The (B, KV, C, ...) tensors cut into pages of t slots, scrambled
    into one pool, and the block table (B, C / t)."""
    b, kvh, c = cache[0].shape[:3]
    n_p = c // t
    perm = torch.tensor(rng.permutation(b * n_p), dtype=torch.int64)

    def pool(x):
        if x is None:
            return None
        p = _raw(x).reshape(b, kvh, n_p, t, *x.shape[3:]).movedim(2, 1)
        p = p.reshape(b * n_p, kvh, t, *x.shape[3:])[perm.to(x.device)]
        return p.contiguous().view(x.dtype)

    bt = torch.argsort(perm).reshape(b, n_p).to(torch.int32)
    return [pool(x) for x in cache], bt.to(cache[0].device)


def _attn_limit(got, want, q, cache, nv, sm, q_len):
    """(max |kernel - plain|, 1e-5 plus twice the plain version's own
    error against float64), each draft of the verify form against the
    float64 function at its own limit."""
    b, kvh, rows, dh = q.shape
    g = rows // q_len
    own = 0.0
    for j in range(q_len):
        exact = _decode_attn_f64(q[:, :, j * g:(j + 1) * g], *cache,
                                 nv - (q_len - 1 - j), sm)
        own = max(own, float((want[:, :, j * g:(j + 1) * g].double()
                              - exact).abs().max()))
    return float((got - want).abs().max()), 1e-5 + 2 * own


def _plain(q, cache, nv, sm, q_len):
    """decode_attn_ref on the (B, KV, R, Dh) rows of a q_len-draft step."""
    if q_len == 1:
        return decode_attn.decode_attn_ref(q, *cache, nv, sm_scale=sm)
    b, kvh, rows, dh = q.shape
    q5 = q.reshape(b, kvh, q_len, rows // q_len, dh)
    return decode_attn.decode_attn_ref(q5, *cache, nv, sm_scale=sm
                                       ).reshape(q.shape)


@pytest.mark.parametrize("q_len", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_capacity_does_not_change_the_bits(cuda, kv_dtype,
                                                       q_len):
    """The same live bytes and limits in caches of another capacity give
    the same bits: contiguous C 4096, 4160 and 12800 (at 16 rows the last
    keeps its scores in the scratch buffer, the others in shared memory;
    NaN bytes past slot 4096), and pages of 16, NP 4 against NP 8."""
    rng = np.random.default_rng(21)
    b, kvh, g, dh = 3, 2, 4, 120
    sm = dh ** -0.5
    q = torch.tensor(rng.standard_normal((b, kvh, q_len * g, dh)),
                     dtype=torch.float32, device=cuda)
    big = _kv_cache(rng, (b, kvh, 12800, dh), kv_dtype, cuda)
    for x in big:
        if x is not None:
            _raw(x)[:, :, 4096:] = 0x7F if x.element_size() == 1 \
                else float("nan")
    assert decode_attn._scratch(q, q_len * g, 12800) is not None or \
        q_len == 1
    assert decode_attn._scratch(q, q_len * g, 4160) is None
    nv = torch.tensor([4096, 4000, 2049], dtype=torch.int32, device=cuda)
    outs = [decode_attn.decode_attn(q, *_first_slots(big, c), nv,
                                    sm_scale=sm, q_len=q_len)
            for c in (4096, 4160, 12800)]
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    small = _kv_cache(rng, (b, kvh, 128, dh), kv_dtype, cuda)
    nv = torch.tensor([64, 40, 33], dtype=torch.int32, device=cuda)
    outs = []
    for c in (64, 128):
        cache = _first_slots(small, c)
        pages, bt = _paged(cache, 16, rng)
        outs.append(decode_attn.decode_attn(q, *cache, nv, sm_scale=sm,
                                            q_len=q_len))
        outs.append(decode_attn.decode_attn_paged(q, *pages, nv, bt,
                                                  sm_scale=sm, q_len=q_len))
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def _one_rounding(q, cache, nv, sm, q_len):
    """The most one bf16 weight rounding the other way can move an
    output: 2^-8 of the largest weight (float64, the V scale folded in)
    times the largest |v| of its slot."""
    k, v, ks, vs = cache
    b, kvh, rows, dh = q.shape
    g, c = rows // q_len, k.shape[2]
    f = lambda t: t.float().to(torch.bfloat16).double()
    q5 = q.reshape(b, kvh, q_len, g, dh)
    s = torch.einsum("bksgd,bktd->bksgt", f(q5), f(k)) * sm
    if ks is not None:
        s = s * ks.double()[:, :, None, None, :]
    back = torch.arange(q_len - 1, -1, -1, device=q.device)
    lim = torch.clamp_max(nv.long()[:, None] - back[None], c)
    live = torch.arange(c, device=q.device)[None, None] < lim[:, :, None]
    s = s.masked_fill(~live[:, None, :, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    if vs is not None:
        w = w * vs.double()[:, :, None, None, :]
    vmax = f(v).abs().amax(dim=-1)[:, :, None, None, :]
    return float((w * vmax).max()) * 2.0 ** -8


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_split_boundaries_match_plain(cuda, kv_dtype):
    """n_valid on a chunk boundary (CHUNK, and CLUSTER · CHUNK where the
    chunks come back to the first CTA), one past it, one before it, one
    slot and a wrapped ring; then verify blocks whose rows' limits
    straddle those boundaries.  With q = 0 every live slot weighs the
    same and both versions round the same weights, so the kernel is
    within 1e-6 of the plain version (a slot missed or counted twice
    moves an output by ~1e-3); with random q within the attention limit
    plus one bf16 weight rounding (``_one_rounding``: two f32
    evaluations may round a weight near a bf16 tie apart).  Both layouts
    bitwise equal; each draft bitwise the q_len = 1 launch at its
    limit."""
    ch, cl = decode_attn.CHUNK, decode_attn.CLUSTER
    rng = np.random.default_rng(22)
    b, kvh, g, dh, c = 7, 2, 4, 96, 640
    sm = dh ** -0.5
    cache = _kv_cache(rng, (b, kvh, c, dh), kv_dtype, cuda)
    pages, bt = _paged(cache, 16, rng)
    q = torch.tensor(rng.standard_normal((b, kvh, 4 * g, dh)),
                     dtype=torch.float32, device=cuda)
    nv1 = torch.tensor([ch * cl, ch * cl + 1, ch * cl - 1, 1, c + 100, ch,
                        ch + 1], dtype=torch.int32, device=cuda)
    # q_len 4: limits n-3 .. n straddle the boundary at 32, 256 and 512
    nv4 = torch.tensor([ch + 2, ch * cl + 1, ch * cl + 3, 2 * ch * cl + 2,
                        4, c, c - ch + 1], dtype=torch.int32, device=cuda)
    for q_len, nv in ((1, nv1), (4, nv4)):
        rows = q[:, :, :q_len * g].contiguous()
        for qq in (torch.zeros_like(rows), rows):
            got = decode_attn.decode_attn(qq, *cache, nv, sm_scale=sm,
                                          q_len=q_len)
            got_p = decode_attn.decode_attn_paged(qq, *pages, nv, bt,
                                                  sm_scale=sm, q_len=q_len)
            want = _plain(qq, cache, nv, sm, q_len)
            assert torch.equal(got, got_p)
            if not bool(qq.any()):
                err = float((got - want).abs().max())
                assert err <= 1e-6, (kv_dtype, q_len, err)
                continue
            err, lim = _attn_limit(got, want, qq, cache, nv, sm, q_len)
            lim += _one_rounding(qq, cache, nv, sm, q_len)
            assert err <= lim, (kv_dtype, q_len, err, lim)
            for j in range(q_len if q_len > 1 else 0):
                solo = decode_attn.decode_attn(
                    qq[:, :, j * g:(j + 1) * g].contiguous(), *cache,
                    nv - (q_len - 1 - j), sm_scale=sm)
                assert torch.equal(got[:, :, j * g:(j + 1) * g], solo), j


@pytest.mark.parametrize("q_len", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_rows_do_not_depend_on_the_batch(cuda, kv_dtype, q_len):
    """Each batch row of a launch at phi3-mini's widths (B 4 x KV 32,
    rows at other depths) is bitwise its own B = 1 launch, and the two
    layouts give the same bits: a row's sums never depend on the rest of
    the batch."""
    rng = np.random.default_rng(25)
    b, kvh, dh, c = 4, 32, 96, 320
    sm = dh ** -0.5
    cache = _kv_cache(rng, (b, kvh, c, dh), kv_dtype, cuda)
    pages, bt = _paged(cache, 16, rng)
    q = torch.tensor(rng.standard_normal((b, kvh, q_len, dh)),
                     dtype=torch.float32, device=cuda)
    nv = torch.tensor([300, 4, 257, 33], dtype=torch.int32, device=cuda)
    got = decode_attn.decode_attn(q, *cache, nv, sm_scale=sm, q_len=q_len)
    got_p = decode_attn.decode_attn_paged(q, *pages, nv, bt, sm_scale=sm,
                                          q_len=q_len)
    assert torch.equal(got, got_p)
    for i in range(b):
        one = [None if x is None else _raw(x)[i:i + 1].contiguous().view(
            x.dtype) for x in cache]
        solo = decode_attn.decode_attn(q[i:i + 1].contiguous(), *one,
                                       nv[i:i + 1].contiguous(),
                                       sm_scale=sm, q_len=q_len)
        assert torch.equal(got[i:i + 1], solo), i


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_scores_past_shared_memory_match_plain(cuda, kv_dtype):
    """A verify step of 16 rows (S 4 x G 4, h2o-danube-3-4b's widths) on
    a cache of 12800 slots, past the scores a CTA keeps in shared memory
    (the scratch buffer), within the attention limit of the plain
    version, and at q_len 1 (4 rows: in shared memory)."""
    rng = np.random.default_rng(23)
    b, kvh, g, dh, c = 3, 2, 4, 120, 12800
    sm = dh ** -0.5
    cache = _kv_cache(rng, (b, kvh, c, dh), kv_dtype, cuda)
    q = torch.tensor(rng.standard_normal((b, kvh, 4 * g, dh)),
                     dtype=torch.float32, device=cuda)
    assert decode_attn._scratch(q, 4 * g, c) is not None
    nv = torch.tensor([c, 12345, 6000], dtype=torch.int32, device=cuda)
    for q_len in (4, 1):
        rows = q if q_len == 4 else q[:, :, :g].contiguous()
        got = decode_attn.decode_attn(rows, *cache, nv, sm_scale=sm,
                                      q_len=q_len)
        want = _plain(rows, cache, nv, sm, q_len)
        err, lim = _attn_limit(got, want, rows, cache, nv, sm, q_len)
        assert bool(torch.isfinite(got).all())
        assert err <= lim, (kv_dtype, q_len, err, lim)


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_decode_attn_paged_long_context_matches_plain(cuda, kv_dtype):
    """Row 3's q_len = 1 form at phi3-mini's long context (B 4, KV 32,
    G 1, Dh 96, 256 pages of 16 a slot) within the attention limit of
    the plain version."""
    rng = np.random.default_rng(24)
    b, kvh, dh, t, n_p = 4, 32, 96, 16, 256
    sm = dh ** -0.5
    cache = _kv_cache(rng, (b, kvh, n_p * t, dh), kv_dtype, cuda)
    pages, bt = _paged(cache, t, rng)
    q = torch.tensor(rng.standard_normal((b, kvh, 1, dh)),
                     dtype=torch.float32, device=cuda)
    nv = torch.tensor([3000, 4096, 3517, 3999], dtype=torch.int32,
                      device=cuda)
    got = decode_attn.decode_attn_paged(q, *pages, nv, bt, sm_scale=sm)
    want = decode_attn.decode_attn_paged_plain(q, *pages, nv, bt,
                                               sm_scale=sm)
    err, lim = _attn_limit(got, want, q, cache, nv, sm, 1)
    assert bool(torch.isfinite(got).all())
    assert err <= lim, (kv_dtype, err, lim)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fused_large_m_tile_matches_plain(cuda, fmt):
    for m, k, n in LARGE_M_SHAPES:
        x = _x(m, k, m + n).to(cuda)
        w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                         dtype=torch.float32) * 0.05
        qw = quant_per_tensor(w, "e4m3").q.to(cuda)
        for xin in (x, x.bfloat16()):
            s = dispatch.global_scale(xin, fmt)
            counts = mx_quant.counter.count, mx_gemm.counter_tiled.count
            acc, q, se = mx_fused.fused_quant_gemm(xin, s, qw, fmt)
            # two launches: the quantizer, then the wgmma tile
            assert (mx_quant.counter.count - counts[0],
                    mx_gemm.counter_tiled.count - counts[1]) == (1, 1)
            acc_p, q_p, se_p = mx_fused.fused_quant_gemm_plain(xin, s, qw,
                                                               fmt)
            assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
            assert torch.equal(se, se_p)
            _close(acc, acc_p)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_dw_gemm_matches_plain(cuda, fmt):
    for m, k, n in DW_SHAPES:
        xq = quant_mx(_x(m, k, m + k).to(cuda), 32, fmt)
        g = torch.tensor(np.random.default_rng(n).standard_normal((m, n)),
                         dtype=torch.float32, device=cuda)
        gq = quant_per_tensor(g, "e5m2")
        acc, qt, et = mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq.q, fmt,
                                        payload=True)
        acc_p, qt_p, et_p = mx_bwd.mx_dw_gemm_plain(xq.q, xq.sexp, gq.q,
                                                    fmt, payload=True)
        assert torch.equal(qt.view(torch.uint8), qt_p.view(torch.uint8))
        assert torch.equal(et, et_p)
        _close(acc, acc_p)
        _close(mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq.q, fmt), acc_p)


def _boundary_residual(m, k, fmt, seed):
    """A residual (q, sexp) whose 32-token groups along M, per column,
    have their amax at fp8 mantissa 1.75 (FP8_MAX's, so the requant
    ratio amax / FP8_MAX is exactly a power of two, where log2(r) - 1e-6
    lies within an ulp of an integer) and at the mantissas on each side
    of it (1.625 and 1.875 in e4m3, 1.5 and 2 in e5m2), over exponents
    from 2^-126 to 2^7; the group's other tokens lie below.  A few groups sit
    at the 2^-149 floor and one column is all zero."""
    rng = np.random.default_rng(seed)
    kg = k // 32
    sexp = rng.integers(-120, 1, (m // 32, kg))            # per token group
    tops = [1.625, 1.75, 1.875] if fmt == "e4m3" else [1.5, 1.75, 2.0]
    top = rng.choice(tops, (m // 32, k))
    scale = np.ldexp(1.0, rng.integers(-6, 8, (m // 32, k)))
    x = rng.uniform(-1.45, 1.45, (m // 32, 32, k)) * scale[:, None, :]
    at = rng.integers(0, 32, (m // 32, k))
    sign = rng.choice([-1.0, 1.0], (m // 32, k))
    np.put_along_axis(x, at[:, None, :], (sign * top * scale)[:, None, :],
                      axis=1)
    x[:, :, 5] = 0.0                                       # a zero column
    q = torch.tensor(x.reshape(m, k), dtype=torch.float32).to(fp8_dtype(fmt))
    se = np.repeat(sexp, 32, axis=0)
    se[:32, :2] = -127                                     # the floor
    return q, torch.tensor(se, dtype=torch.int8)


@pytest.mark.parametrize("x_fmt", ["e4m3", "e5m2"])
def test_dw_requant_exponent_boundaries_match_plain(cuda, x_fmt):
    """The requant pass alone (``mx_bwd.dw_requant``) against
    ``requant_m``, bitwise, at group maxima on each side of a power of
    two (``test_fused_exponent_boundaries_match_plain``'s hazard: a
    contracted multiply-add would move the ceil) and at the 2^-149
    floor, in both requant formats, with ragged column blocks (K 4128)
    and two column blocks of 128."""
    for m, k in ((256, 4128), (96, 256)):
        q, se = _boundary_residual(m, k, x_fmt, m + k)
        q, se = q.to(cuda), se.to(cuda)
        for fmt in ("e4m3", "e5m2"):
            before = mx_bwd.counter_requant.count
            qt, et = mx_bwd.dw_requant(q, se, fmt)
            assert mx_bwd.counter_requant.count == before + 1
            want = mx_bwd.requant_m(q, se, fmt)
            assert qt.shape == (k, m) and et.shape == (k, m // 32)
            assert torch.equal(et, want.sexp)
            assert torch.equal(qt.view(torch.uint8),
                               want.q.view(torch.uint8))
            assert int(want.sexp.min()) == -127
            assert int(want.sexp.max()) - int(want.sexp.min()) > 100


def test_dw_gemms_launch_the_requant_then_the_tile_and_repeat(cuda):
    """One ``mx_dw_gemm`` call is one ``dw_requant`` launch and one
    tile launch (counted on ``mx_dw_gemm``, never on ``mx_gemm``'s own
    counters); one ``moe_dw_gemm`` call one ``dw_requant`` launch and
    one grouped tile.  Two calls of each return the same bits."""
    m, k, n = 224, 352, 200
    xq = quant_mx(_x(m, k, 11).to(cuda), 32, "e4m3")
    g = torch.tensor(np.random.default_rng(12).standard_normal((m, n)),
                     dtype=torch.float32, device=cuda)
    gq = quant_per_tensor(g, "e5m2").q
    counters = (mx_bwd.counter_requant, mx_bwd.counter, moe_gmm.counter_dw,
                mx_gemm.counter, mx_gemm.counter_tiled, mx_quant.counter)
    before = [c.count for c in counters]
    acc, qt, et = mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq, payload=True)
    assert [c.count - b for c, b in zip(counters, before)] == \
        [1, 1, 0, 0, 0, 0]
    again, qt2, et2 = mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq, payload=True)
    assert torch.equal(acc.view(torch.int32), again.view(torch.int32))
    assert torch.equal(qt.view(torch.uint8), qt2.view(torch.uint8))
    assert torch.equal(et, et2)

    e, cp = 3, 96
    sizes = torch.tensor([96, 33, 0], dtype=torch.int32)
    live = _live(sizes, cp)
    xq = quant_mx((_x(e * cp, k, 13) * live).to(cuda), 32, "e4m3")
    g = torch.tensor(np.random.default_rng(14).standard_normal(
        (e * cp, n)), dtype=torch.float32) * live
    gq = quant_per_tensor(g.to(cuda), "e5m2").q
    sizes = sizes.to(cuda)
    before = [c.count for c in counters]
    acc, qt, et = moe_gmm.moe_dw_gemm(xq.q, xq.sexp, gq, sizes, cp,
                                      payload=True)
    assert [c.count - b for c, b in zip(counters, before)] == \
        [1, 0, 1, 0, 0, 0]
    again, qt2, et2 = moe_gmm.moe_dw_gemm(xq.q, xq.sexp, gq, sizes, cp,
                                          payload=True)
    assert torch.equal(acc.view(torch.int32), again.view(torch.int32))
    assert torch.equal(qt.view(torch.uint8), qt2.view(torch.uint8))
    assert torch.equal(et, et2)
    assert bool((acc[2] == 0).all())
    _close(acc, moe_gmm.moe_dw_gemm_plain(xq.q, xq.sexp, gq, cp))


def test_decode_attn_dispatch_passes_true_group_rows(cuda, monkeypatch):
    """G = 1 (phi3-mini): the kernel gets a 1-row q, no padded copy, and
    agrees with the padded plain path."""
    b, kvh, dh, t, n_p, pool = 2, 3, 96, 16, 2, 6
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((b, kvh, 1, dh)),
                     dtype=torch.float32)
    k, ks = _quant_kv(torch.tensor(rng.standard_normal((pool, kvh, t, dh)),
                                   dtype=torch.float32))
    v, vs = _quant_kv(torch.tensor(rng.standard_normal((pool, kvh, t, dh)),
                                   dtype=torch.float32))
    bt = torch.tensor([[0, 3], [5, 1]], dtype=torch.int32)
    nv = torch.tensor([20, 7], dtype=torch.int32)
    cpu = (q, k, v, ks, vs, nv, bt)
    seen = []
    kernel = dispatch.decode_attn_paged

    def spy(qq, *a, **kw):
        seen.append(tuple(qq.shape))
        return kernel(qq, *a, **kw)

    want = dispatch.decode_attention_paged(*cpu, sm_scale=dh ** -0.5)
    monkeypatch.setattr(dispatch, "decode_attn_paged", spy)
    got = dispatch.decode_attention_paged(*[a.to(cuda) for a in cpu],
                                          sm_scale=dh ** -0.5)
    assert seen == [(b, kvh, 1, dh)]
    assert got.shape == (b, kvh, 1, dh)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("m", [32, 256])
def test_fused_exponent_boundaries_match_plain(cuda, m):
    """Group maxima within a few ulps above powers of two, where
    ``log2(r) - 1e-6`` lies next to an integer and a contracted
    multiply-add would move the ceil: both tiles (M <= 32 and M > 32)
    must still pick the plain version's exponents."""
    k = 4096
    rng = np.random.default_rng(m)
    x = rng.uniform(-0.5, 0.5, (m, k // 32, 32)).astype(np.float32)
    i = np.arange(m * k // 32).reshape(m, k // 32)
    amax = np.ldexp(1.0 + (i // 20 % 40) * 5e-8, -(i % 20))
    x *= amax[..., None]
    x[..., 0] = amax
    x = torch.tensor(x.reshape(m, k), device=cuda)
    qw = quant_per_tensor(torch.ones(k, 64) * 0.01).q.to(cuda)
    s = torch.tensor(1.0 / 448.0, device=cuda)
    for fmt in ("e4m3", "e5m2"):
        _, q, se = mx_fused.fused_quant_gemm(x, s, qw, fmt)
        _, q_p, se_p = mx_fused.fused_quant_gemm_plain(x, s, qw, fmt)
        assert torch.equal(se, se_p)
        assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_group_gemm_matches_plain(cuda, fmt):
    """The forward and dW operand formats (e4m3 x against e4m3 weights,
    e4m3 residual against the e5m2 gradient) and dx's (e5m2 gradient
    against e4m3 weights)."""
    for m, k, n in GROUP_SHAPES:
        xq = quant_per_group(_x(m, k, m + n).to(cuda), 128, fmt)
        w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                         dtype=torch.float32, device=cuda) * 0.05
        for wfmt in ("e4m3", "e5m2"):
            if fmt == wfmt == "e5m2":
                continue
            qw = quant_per_tensor(w, wfmt).q
            got = group_gemm.group_gemm(xq.q, xq.s, qw)
            want = group_gemm.group_gemm_plain(xq.q, xq.s, qw)
            assert got.shape == (m, n)
            _close(got, want)


def _fp8_payload(shape, fmt, rng):
    """Random finite fp8 bytes of ``fmt``, subnormals and zeros of both
    signs among them (every byte but e4m3fn's NaN and e5m2's Inf and
    NaN codes)."""
    b = rng.integers(0, 256, shape).astype(np.uint8)
    if fmt == "e4m3":
        b[(b & 0x7F) == 0x7F] ^= 0x01
    else:
        b[(b & 0x7C) == 0x7C] &= 0xFB
    return torch.tensor(b).view(fp8_dtype(fmt))


def test_group_gemm_operands_are_bitwise(cuda):
    """Against an identity weight (K = N) every output is one payload
    value times its row's group scale, rounded once: q * sx bit for
    bit, with subnormal payloads in both formats and scales over ~190
    octaves (f32 subnormal products among them), in each operand
    pairing the recipe multiplies; M ragged."""
    m, k = 130, 384
    rng = np.random.default_rng(11)
    sx = np.ldexp(rng.uniform(1.0, 2.0, (m, k // 128)),
                  rng.integers(-130, 60, (m, k // 128))).astype(np.float32)
    sx = torch.tensor(sx, device=cuda)
    for x_fmt, w_fmt in (("e4m3", "e4m3"), ("e5m2", "e4m3"),
                         ("e4m3", "e5m2")):
        q = _fp8_payload((m, k), x_fmt, rng).to(cuda)
        one = torch.eye(k).to(fp8_dtype(w_fmt)).to(cuda)
        got = group_gemm.group_gemm(q, sx, one)
        want = group_gemm.group_gemm_plain(q, sx, one)
        # (+ 0: a -0 payload sums to +0)
        exact = q.float() * sx.repeat_interleave(128, dim=1) + 0.0
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), exact.view(torch.int32))


def test_moe_gmm_operands_are_bitwise(cuda):
    """Against identity expert weights (K = N) every output is one
    operand value bf16(q * 2^e) of the quantized buffer, bit for bit
    against the plain version, with groups over many octaves (exponents
    down to -127: bf16 subnormal operands); the sizes 0, 1, 127, 128,
    129 and C = 200 in one buffer, rows past each size zero in and
    out."""
    sizes = torch.tensor([0, 1, 127, 128, 129, 200], dtype=torch.int32)
    e, c, k = len(sizes), 200, 128
    rng = np.random.default_rng(12)
    x = rng.standard_normal((e * c, k // 32, 32)) * np.ldexp(
        1.0, rng.integers(-100, 20, (e * c, k // 32, 1)))
    x[::7, 1] = np.ldexp(rng.standard_normal((32,)), -110)
    x = torch.tensor(x.reshape(e * c, k), dtype=torch.float32)
    x = (x * _live(sizes, c)).to(cuda)
    one = torch.eye(k).expand(e, k, k).contiguous().to(torch.float8_e4m3fn)
    one = one.to(cuda)
    for fmt in ("e4m3", "e5m2"):
        s = dispatch.global_scale(x, fmt)
        acc, q, se = moe_gmm.moe_gmm(x, s, one, sizes.to(cuda), c, fmt)
        acc_p, q_p, se_p = moe_gmm.moe_gmm_plain(x, s, one, c, fmt)
        assert int(se_p.min()) == -127
        assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
        assert torch.equal(se, se_p)
        assert torch.equal(acc.view(torch.int32), acc_p.view(torch.int32))
        assert bool((acc.cpu()[~_live(sizes, c)[:, 0]] == 0).all())


def test_moe_gmm_is_one_quantizer_and_one_tile_and_repeats(cuda):
    """One call launches the mx_quant kernel once and the grouped tile
    once (never mx_gemm's own tiles); two calls give the same bits."""
    e, c, k, n = 3, 136, 256, 200
    sizes = torch.tensor([136, 5, 0], dtype=torch.int32, device=cuda)
    x = (_x(e * c, k, 3) * _live(sizes, c)).to(cuda)
    w = torch.tensor(np.random.default_rng(4).standard_normal((e, k, n)),
                     dtype=torch.float32) * 0.05
    qw = torch.stack([quant_per_tensor(wi).q for wi in w]).to(cuda)
    s = dispatch.global_scale(x)
    counters = (mx_quant.counter, moe_gmm.counter, mx_gemm.counter,
                mx_gemm.counter_tiled)
    before = [c_.count for c_ in counters]
    acc, q, se = moe_gmm.moe_gmm(x, s, qw, sizes, c)
    assert [c_.count - b for c_, b in zip(counters, before)] == [1, 1, 0, 0]
    again, q2, se2 = moe_gmm.moe_gmm(x, s, qw, sizes, c)
    assert torch.equal(acc.view(torch.int32), again.view(torch.int32))
    assert torch.equal(q.view(torch.uint8), q2.view(torch.uint8))
    assert torch.equal(se, se2)
    _close(acc, moe_gmm.moe_gmm_plain(x, s, qw, c)[0])


@pytest.mark.parametrize("k", [128, 10240])
def test_group_gemm_one_group_and_long_chain(cuda, k):
    """K 128 (one group: a single promotion) and K 10240 (80 groups: the
    long promotion chain, where a sum kept in the tensor core would
    drift) against the plain version; two calls give the same bits."""
    m, n = 256, 384
    xq = quant_per_group(_x(m, k, k).to(cuda), 128, "e4m3")
    w = torch.tensor(np.random.default_rng(k).standard_normal((k, n)),
                     dtype=torch.float32, device=cuda) / k ** 0.5
    qw = quant_per_tensor(w).q
    before = group_gemm.counter.count
    got = group_gemm.group_gemm(xq.q, xq.s, qw)
    again = group_gemm.group_gemm(xq.q, xq.s, qw)
    assert group_gemm.counter.count == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _close(got, group_gemm.group_gemm_plain(xq.q, xq.s, qw))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_mx_quant_matches_plain(cuda, fmt):
    for m, k in QUANT_SHAPES:
        x = _x(m, k, m + k).to(cuda)
        for xin in (x, x.bfloat16()):
            s = dispatch.global_scale(xin, fmt)
            q, se = mx_quant.mx_quant(xin, s, fmt)
            q_p, se_p = mx_quant.mx_quant_plain(xin, s, fmt)
            assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
            assert torch.equal(se, se_p)


def test_mx_quant_exponent_boundaries_match_plain(cuda):
    """Group maxima within a few ulps above powers of two (as in
    ``test_fused_exponent_boundaries_match_plain``): the shared exponent
    routine must pick the plain version's exponents."""
    m, k = 256, 4096
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.5, 0.5, (m, k // 32, 32)).astype(np.float32)
    i = np.arange(m * k // 32).reshape(m, k // 32)
    amax = np.ldexp(1.0 + (i // 20 % 40) * 5e-8, -(i % 20))
    x *= amax[..., None]
    x[..., 0] = amax
    x = torch.tensor(x.reshape(m, k), device=cuda)
    s = torch.tensor(1.0 / 448.0, device=cuda)
    for fmt in ("e4m3", "e5m2"):
        q, se = mx_quant.mx_quant(x, s, fmt)
        q_p, se_p = mx_quant.mx_quant_plain(x, s, fmt)
        assert torch.equal(se, se_p)
        assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))


def _same_scale(got, want):
    """Two level-1 scales bit for bit, a NaN equal to any NaN (the card
    returns its canonical NaN from a division)."""
    if bool(torch.isnan(want)):
        return bool(torch.isnan(got))
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def _scale_case(case, dev):
    x = _x(64, 4096, 5)
    if case == "all_zero":
        x[:] = 0.0
    elif case == "all_subnormal":
        x = torch.where(x < 0, -1e-40, 3e-39)
    elif case == "inf":
        x[63, 4095] = float("inf")
    elif case == "nan":
        x[0, 1] = float("nan")
    elif case == "nan_and_inf":
        x[5, 7] = -float("inf")
        x[60, 70] = float("nan")
    elif case == "ragged":
        x = x.reshape(-1)[:4099].reshape(1, 4099)
    return x.to(dev)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_global_amax_matches_plain(cuda, fmt):
    """The level-1 scale kernel bit for bit its plain version on the
    quantizer's shapes, f32 and bf16, each a single launch."""
    for m, k in QUANT_SHAPES:
        x = _x(m, k, m + k).to(cuda)
        for xin in (x, x.bfloat16()):
            before = mx_quant.counter_amax.count
            got = mx_quant.global_amax(xin, fmt)
            assert mx_quant.counter_amax.count == before + 1
            assert got.shape == () and got.device == xin.device
            assert _same_scale(got, mx_quant.global_scale_plain(xin, fmt))


@pytest.mark.parametrize("case", ["all_zero", "all_subnormal", "inf", "nan",
                                  "nan_and_inf", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_amax_edge_cases_match_plain(cuda, case, dtype):
    """NaN propagates (as torch.amax), inf gives an inf scale, zeros and
    subnormals give TINY / FP8_MAX, a size that is no multiple of a
    16-byte vector takes the scalar tail; an unaligned view too."""
    x = _scale_case(case, cuda).to(dtype)
    for fmt in ("e4m3", "e5m2"):
        assert _same_scale(mx_quant.global_amax(x, fmt),
                           mx_quant.global_scale_plain(x, fmt))
    view = x.reshape(-1)[1:]
    assert view.data_ptr() % 16
    assert _same_scale(mx_quant.global_amax(view),
                       mx_quant.global_scale_plain(view))


def test_global_amax_many_blocks_and_calls_in_a_row(cuda):
    """The head's dx input (2048, 50304) f32 needs more blocks than one
    wave; calls in a row, a larger maximum and then a smaller one, each
    find the block counter back at 0 and give the plain version's bits."""
    big = torch.randn(2048, 50304, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(0))
    big[2047, 50303] = 123.0
    small = _x(33, 4096, 1).to(cuda)
    for x in (big, big, small, big.bfloat16(), small.bfloat16(), small):
        assert _same_scale(mx_quant.global_amax(x, "e5m2"),
                           mx_quant.global_scale_plain(x, "e5m2"))


@pytest.mark.parametrize("k", [3072, 8192])
@pytest.mark.parametrize("m", [1, 4, 32])
def test_mx_quant_small_m_matches_plain(cuda, m, k):
    """The serving rows (decode M 1 and 4, the calibration's M 32): the
    group pass bit for bit the plain version in both formats."""
    x = _x(m, k, m * k).to(cuda)
    for xin in (x, x.bfloat16()):
        for fmt in ("e4m3", "e5m2"):
            s = dispatch.global_scale(xin, fmt)
            q, se = mx_quant.mx_quant(xin, s, fmt)
            q_p, se_p = mx_quant.mx_quant_plain(xin, s, fmt)
            assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
            assert torch.equal(se, se_p)


@pytest.mark.parametrize("m", [5, 256])
def test_fused_call_is_one_scale_one_quantizer_one_tile(cuda, m):
    """dispatch.fused_quant_matmul is one global_amax launch, one
    mx_quant launch and one launch of the tile for M, and nothing of
    plain torch's amax: its scale equals the plain version's."""
    k, n = 256, 200
    x = _x(m, k, m).to(cuda).bfloat16()
    w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                     dtype=torch.float32) * 0.05
    wq = quant_per_tensor(w, "e4m3")
    wq = PerTensorQ(q=wq.q.to(cuda), s=wq.s.to(cuda))
    counters = (mx_quant.counter_amax, mx_quant.counter, mx_gemm.counter,
                mx_gemm.counter_tiled)
    before = [c.count for c in counters]
    _, xq = dispatch.fused_quant_matmul(x, wq)
    tile = [1, 0] if m <= 32 else [0, 1]
    assert [c.count - b for c, b in zip(counters, before)] == [1, 1] + tile
    assert _same_scale(xq.s, mx_quant.global_scale_plain(x))


# pt_matmul on the card against the CPU's plain upcast product: both
# multiply the exact fp8 values and add in f32, so only the order of the
# f32 sum differs, in every pairing of the two formats.
PT_SHAPES = [(5, 200, 72), (96, 384, 160), (2048, 4096, 1024)]


def test_pt_matmul_matches_cpu(cuda):
    for m, k, n in PT_SHAPES:
        x = _x(m, k, m + k)
        w = torch.tensor(np.random.default_rng(n).standard_normal((k, n)),
                         dtype=torch.float32) * 0.05
        for xf, wf in (("e4m3", "e4m3"), ("e5m2", "e4m3"), ("e4m3", "e5m2"),
                       ("e5m2", "e5m2")):
            xq, wq = quant_per_tensor(x, xf), quant_per_tensor(w, wf)
            want = dispatch.pt_matmul(xq, wq, out_dtype=torch.float32)
            got = dispatch.pt_matmul(
                PerTensorQ(xq.q.to(cuda), xq.s.to(cuda)),
                PerTensorQ(wq.q.to(cuda), wq.s.to(cuda)),
                out_dtype=torch.float32)
            assert got.shape == (m, n)
            _close(got, want)


# A serving step's fixed row order (core.row_order) on the card: at a
# verify step's 16 rows (4 slots x spec_k 4) each helper's row 0 is
# bitwise the same row computed alone; pt_matmul's too.
def test_row_order_rows_do_not_depend_on_their_batch(cuda):
    from repro_torch.core import row_order

    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(cuda)

    x, w = t(16, 3072), t(3072, 16)
    ys, c = t(16, 16, 256), t(16, 16).abs()
    xq, wq = quant_per_tensor(x, "e4m3"), quant_per_tensor(t(3072, 640),
                                                           "e4m3")
    with row_order.rows(16):
        cases = [(row_order.mean(x), row_order.mean(x[:1])),
                 (row_order.matmul(x, w), row_order.matmul(x[:1], w)),
                 (row_order.expert_sum(ys, c),
                  row_order.expert_sum(ys[:, :1], c[:1])),
                 (dispatch.pt_matmul(xq, wq, out_dtype=torch.float32),
                  dispatch.pt_matmul(PerTensorQ(xq.q[:1], xq.s), wq,
                                     out_dtype=torch.float32))]
    for batch, alone in cases:
        assert torch.equal(batch[:1], alone)
    _close(row_order.mean(x), x.mean(dim=-1, keepdim=True))


def _moe_sizes(e, c):
    """Ragged sizes with a full and an empty expert, one ending inside a
    128-row block and one past a block boundary."""
    base = [c, 0, min(c, 17), max(c - 1, 0), min(c, 129)]
    return torch.tensor((base * e)[:e], dtype=torch.int32)


def _live(sizes, c):
    return (torch.arange(c)[None, :] < sizes[:, None].cpu()).reshape(-1, 1)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_moe_gmm_matches_plain(cuda, fmt):
    """The grouped fused quantize + GEMM against its plain version: every
    row's payload bitwise (the rows past each expert's size too: q 0,
    exponent -127), the accumulation within 1e-5 * max|plain| and 0
    past the sizes; also with every expert empty."""
    for e, c, k, n in MOE_SHAPES:
        sizes = _moe_sizes(e, c)
        for sz in (sizes, torch.zeros_like(sizes)):
            x = _x(e * c, k, c + n)
            x[0, 32:64] *= 1e-30            # a tiny group in a live row
            x = (x * _live(sz, c)).to(cuda)
            w = torch.tensor(np.random.default_rng(n).standard_normal(
                (e, k, n)), dtype=torch.float32) * 0.05
            qw = torch.stack([quant_per_tensor(wi).q for wi in w]).to(cuda)
            for xin in (x, x.bfloat16()):
                s = dispatch.global_scale(xin, fmt)
                acc, q, se = moe_gmm.moe_gmm(xin, s, qw, sz.to(cuda), c,
                                             fmt)
                acc_p, q_p, se_p = moe_gmm.moe_gmm_plain(xin, s, qw, c, fmt)
                assert torch.equal(q.view(torch.uint8),
                                   q_p.view(torch.uint8))
                assert torch.equal(se, se_p)
                _close(acc, acc_p)
                dead = ~_live(sz, c)[:, 0]
                assert bool((acc.cpu()[dead] == 0).all())


def test_moe_gmm_exponent_boundaries_match_plain(cuda):
    """Group maxima within a few ulps above powers of two (as in
    ``test_fused_exponent_boundaries_match_plain``), a group whose scale
    is the global amax's (ratio 1, exponent 0) and tiny groups at the
    2^-149 floor (exponent clipped to -127): the grouped kernel picks
    the plain version's exponents and payloads."""
    e, c, k = 2, 136, 4096
    rng = np.random.default_rng(9)
    x = rng.uniform(-0.5, 0.5, (e * c, k // 32, 32)).astype(np.float32)
    i = np.arange(e * c * k // 32).reshape(e * c, k // 32)
    amax = np.ldexp(1.0 + (i // 20 % 40) * 5e-8, -(i % 20))
    x *= amax[..., None]
    x[..., 0] = amax
    x[3, 5] = np.float32(1.4e-45)            # the smallest subnormal
    x[4, 7] = np.ldexp(np.float32(1.0), -140)
    x = torch.tensor(x.reshape(e * c, k), device=cuda)
    qw = quant_per_tensor(torch.ones(e, k, 64) * 0.01).q.to(cuda)
    sizes = torch.full((e,), c, dtype=torch.int32, device=cuda)
    for fmt in ("e4m3", "e5m2"):
        s = dispatch.global_scale(x, fmt)
        _, q, se = moe_gmm.moe_gmm(x, s, qw, sizes, c, fmt)
        _, q_p, se_p = moe_gmm.moe_gmm_plain(x, s, qw, c, fmt)
        assert torch.equal(se, se_p)
        assert torch.equal(q.view(torch.uint8), q_p.view(torch.uint8))
        assert int(se_p.min()) == -127 and int(se_p.max()) == 0


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_moe_dw_gemm_matches_plain(cuda, fmt):
    """The grouped dW against its plain version: the requant payload
    bitwise (the groups past each expert's size: q 0, exponent -127),
    the accumulation within 1e-5 * max|plain|, an empty expert's dW
    0."""
    for e, cp, k, n in MOE_DW_SHAPES:
        sizes = _moe_sizes(e, cp)
        live = _live(sizes, cp)
        xq = quant_mx((_x(e * cp, k, cp + k) * live).to(cuda), 32, fmt)
        g = torch.tensor(np.random.default_rng(n).standard_normal(
            (e * cp, n)), dtype=torch.float32) * live
        gq = quant_per_tensor(g.to(cuda), "e5m2")
        acc, qt, et = moe_gmm.moe_dw_gemm(xq.q, xq.sexp, gq.q,
                                          sizes.to(cuda), cp, fmt,
                                          payload=True)
        acc_p, qt_p, et_p = moe_gmm.moe_dw_gemm_plain(
            xq.q, xq.sexp, gq.q, cp, fmt, payload=True)
        assert torch.equal(qt.view(torch.uint8), qt_p.view(torch.uint8))
        assert torch.equal(et, et_p)
        _close(acc, acc_p)
        if e > 1:
            assert bool((acc[1] == 0).all())
