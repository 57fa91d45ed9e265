"""Quickstart on the PyTorch/CUDA port: MOSS two-level FP8 quantization
and automatic scaling in five minutes (the twin of quickstart.py).

  PYTHONPATH=src python examples/quickstart_torch.py            # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card the GEMM of section 2 and the linear layer of section 3 run
the hand-written Hopper kernels (the two-level quantizer, then the MX
GEMM); on the CPU their plain PyTorch versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core.autoscale import (init_scale_state, predicted_scale,
                                        update_scale_state)
from repro_torch.core.formats import MOSS_CONFIG
from repro_torch.core.linear import QT, qlinear
from repro_torch.core.quant import quant_mx, scheme_snr
from repro_torch.kernels import ops


def main(argv=None, m: int = 512, k: int = 2048, n: int = 512):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    gen = torch.Generator().manual_seed(0)
    # an LLM-like activation: gaussian body + sparse strong outliers
    x = torch.randn((m, k), generator=gen)
    x = x * (1 + 300.0 * (torch.rand((m, k), generator=gen) < 0.002))
    x = x.to(dev)

    # --- 1. two-level microscaling (paper Eqs. 2-3) -------------------
    q = quant_mx(x)                       # E4M3 values
    bits = 8 + 8 / (q.q.shape[-1] // q.sexp.shape[-1])
    print(f"payload:   {q.q.dtype}, {tuple(q.q.shape)}")
    print(f"level-2:   int8 E8M0 exponents, {tuple(q.sexp.shape)} "
          f"({bits:.2f} bits/value)")
    print(f"level-1:   one f32 global scale = {float(q.s):.5f}")
    print(f"SNR:       {float(scheme_snr(x, MOSS_CONFIG)):.1f} dB")

    # --- 2. the MOSS GEMM through the kernel path ----------------------
    w = (torch.randn((k, n), generator=gen) * 0.02).to(dev)
    y = ops.moss_linear(x, w)
    exact = x @ w
    rel = float(torch.linalg.norm(y.float() - exact)
                / torch.linalg.norm(exact))
    print(f"GEMM:      rel. error vs exact = {rel:.4f}")

    # --- 3. automatic weight scaling (paper Eq. 10) -------------------
    st = init_scale_state(w, MOSS_CONFIG)
    lr = torch.tensor(3e-4, dtype=torch.float32, device=dev)
    print(f"s_0 = {float(st.s0):.6f} (one max-reduction at init)")
    for step in range(3):
        s_t = predicted_scale(st, lr, MOSS_CONFIG)
        y = qlinear(x.to(torch.bfloat16), QT(w, s_t), MOSS_CONFIG)
        st = update_scale_state(st, w, MOSS_CONFIG)
        print(f"step {step}: predicted scale {float(s_t):.6f} "
              f"(no max-reduction), y finite="
              f"{bool(torch.isfinite(y).all())}")
    return rel


if __name__ == "__main__":
    main()
