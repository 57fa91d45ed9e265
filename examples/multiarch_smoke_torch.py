"""One MOSS FP8 train step (or ``--steps``) on every architecture's smoke
config with the PyTorch/CUDA port (the twin of multiarch_smoke.py;
``--arch`` selects one, the default sweeps all twelve).

  PYTHONPATH=src python examples/multiarch_smoke_torch.py [--arch rwkv6-3b]
  PYTHONPATH=src python examples/multiarch_smoke_torch.py --device cpu \\
      --arch musicgen-medium --steps 1

The embeddings-input models (musicgen-medium, phi-3-vision-4.2b) train on
the frontend stub's embeddings of the synthetic tokens
(``repro_torch.launch.train.stub_embeds``).  On the card every linear
layer goes through the hand-written Hopper kernels; ``--device cpu``
runs their plain versions.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.train import stub_embeds
from repro_torch.train.steps import (TrainHParams, init_train_state,
                                     make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    device = torch.device(args.device)

    out = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=4))
        state = init_train_state(cfg, hp, seed=0, device=device)
        step = make_train_step(cfg, hp)
        t0 = time.time()
        losses = []
        for t in range(args.steps):
            batch = data.batch_for_step(t)
            if cfg.input_mode == "embeddings":
                batch["embeds"] = stub_embeds(cfg,
                                              batch["tokens"].to(device))
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        print(f"{arch:26s} [{cfg.family:7s}] losses="
              f"{['%.3f' % l for l in losses]}  ({time.time() - t0:.1f}s)")
        out[arch] = losses
    return out


if __name__ == "__main__":
    main()
