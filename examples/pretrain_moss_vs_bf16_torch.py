"""Paper Fig. 5 at accessible scale on the PyTorch/CUDA port (the twin
of pretrain_moss_vs_bf16.py): pretrain a ~100M-parameter OLMo-style
model for a few hundred steps under BF16 and under MOSS FP8 from the
same seed and batches, and compare the loss curves.

  PYTHONPATH=src python examples/pretrain_moss_vs_bf16_torch.py \\
      [--steps 300] [--d-model 512] [--layers 8] [--device cuda]

With the defaults this builds a ~100M-parameter model (d=512, 8 layers,
vocab 50304).  On the card every linear layer of the moss run goes
through the hand-written Hopper kernels (the fused quantize + GEMM
forward and dx, the requantizing dW); ``--device cpu`` runs their plain
versions (slow: use a few steps and a small ``--d-model``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.train import quant_from_name
from repro_torch.train.steps import (TrainHParams, init_train_state,
                                     make_train_step)


def run(cfg, steps, batch, seq, label, device, every):
    hp = TrainHParams(peak_lr=6e-4, warmup_steps=max(steps // 10, 5),
                      total_steps=steps)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0))
    state = init_train_state(cfg, hp, seed=0, device=device)
    step = make_train_step(cfg, hp)
    losses = []
    for t in range(steps):
        state, m = step(state, data.batch_for_step(t))
        losses.append(float(m["loss"]))
        if (t + 1) % every == 0:
            print(f"  [{label}] step {t+1:4d}  loss {losses[-1]:.4f}")
    return np.asarray(losses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--every", type=int, default=None,
                    help="print the loss every N steps (default: steps/10)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    base = get_config("olmo-7b").replace(
        n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv=args.d_model // 64, d_head=64,
        d_ff=args.d_model * 3, remat=False, attn_chunk=128)
    n_params = (base.vocab * base.d_model * 2
                + base.n_layers * (4 * base.d_model ** 2
                                   + 3 * base.d_model * base.d_ff))
    print(f"model: {n_params/1e6:.0f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}, on {device}")

    every = args.every or max(args.steps // 10, 1)
    curves = {}
    for quant in ["bf16", "moss"]:
        print(f"--- {quant} ---")
        cfg = base.replace(quant=quant_from_name(quant))
        curves[quant] = run(cfg, args.steps, args.batch, args.seq, quant,
                            device, every)

    tail = max(args.steps // 10, 5)
    b, m = curves["bf16"][-tail:].mean(), curves["moss"][-tail:].mean()
    print(f"\nfinal loss: bf16 {b:.4f} vs MOSS {m:.4f} "
          f"(gap {abs(m-b)/b*100:.2f}% — paper Fig 5: curves align)")
    return curves


if __name__ == "__main__":
    main()
