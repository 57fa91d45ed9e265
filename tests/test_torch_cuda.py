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

from repro_torch.core.quant import quant_mx, quant_per_tensor
from repro_torch.kernels import decode_attn, dispatch, mx_fused, mx_gemm
from repro_torch.models.attention import _quant_kv

pytestmark = pytest.mark.cuda

GEMM_SHAPES = [(5, 96, 200), (16, 256, 72), (1, 32, 33), (4, 3072, 3072),
               (32, 3072, 8192)]


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
