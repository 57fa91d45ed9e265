"""Training CLI: training steps of the port in any of the four recipes
(moss, bf16, per_tensor, per_group) on synthetic tokens, weights from a
seed.  Counterpart of ``repro.launch.train``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-7b \\
      --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-7b \\
      --smoke --steps 3                      # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-7b \\
      --full --layers 4 --batch 1 --seq 2048 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch phi3.5-moe-42b-a6.6b --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch phi3.5-moe-42b-a6.6b --full --layers 1 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-v2-lite-16b --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-v2-lite-16b --full --layers 3 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch musicgen-medium --smoke --device cpu --steps 3  # embeddings

The embeddings-input models (musicgen-medium, phi-3-vision-4.2b) train on
the frontend stub's embeddings of the synthetic tokens (``stub_embeds``).

``REPRO_TRACE=PATH`` records each step's ``train.data`` and
``train.step`` spans (``repro_torch.obs.trace``) and writes them to PATH
at exit; with tracing on, the step span waits for the step's work on the
card before it ends.

Checkpoints and meshes are ROADMAP queue 1 item 13: ``--ckpt-dir`` and
``--mesh`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.formats import QuantConfig
from repro_torch.core.runtime_flags import moe_expert_path
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.obs.trace import span, trace_enabled
from repro_torch.train.steps import (
    TrainHParams,
    init_train_state,
    make_train_step,
)


QUANTS = ("moss", "bf16", "per_tensor", "per_group")


def quant_from_name(name: str, interval: int = 500) -> QuantConfig:
    """The recipe of ``name``: automatic weight scaling for moss,
    just-in-time for the baselines (``repro.launch.train``)."""
    if name not in QUANTS:
        raise ValueError(f"quant {name!r}: expected one of {QUANTS}")
    if name == "bf16":
        return QuantConfig(mode="bf16")
    scaling = "auto" if name == "moss" else "jit"
    return QuantConfig(mode=name, weight_scaling=scaling,
                       rescale_interval=interval)


def stub_embeds(cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The modality frontend's stub (precomputed frame or patch
    embeddings): a fixed random (vocab, d) table times 0.02, looked up by
    the tokens, in bf16.  The reference draws its table with
    ``jax.random.normal(PRNGKey(1234))``, which the port cannot
    reproduce without JAX: here a torch Generator seeded 1234 on the
    tokens' device draws it, so the two packages' stub embeddings differ
    (the parity tests carry embeddings across through numpy)."""
    gen = torch.Generator(device=tokens.device).manual_seed(1234)
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                        device=tokens.device) * 0.02
    return table[tokens.long()].to(torch.bfloat16)


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 128, quant: str = "moss",
          lr: float = 3e-4, warmup: int = 20, seed: int = 0,
          log_every: int = 10, microbatches: int = 1, interval: int = 500,
          layers: int | None = None, device="cuda", ckpt_dir=None,
          mesh=None, log=print):
    """Runs ``steps`` train steps; returns (state, history) with one
    ``(step, loss)`` per logged step."""
    if ckpt_dir is not None or mesh is not None:
        raise NotImplementedError(
            "checkpoints and meshes: ROADMAP queue 1 item 13")
    moe_expert_path()             # refuses an unknown REPRO_MOE_EXPERTS
    device = torch.device(device)
    cfg = get_config(arch, smoke=smoke).replace(
        quant=quant_from_name(quant, interval))
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    hp = TrainHParams(peak_lr=lr, warmup_steps=warmup, total_steps=steps,
                      microbatches=microbatches)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    state = init_train_state(cfg, hp, seed, device=device)
    step_fn = make_train_step(cfg, hp)
    history = []
    t0 = time.monotonic()
    tokens_done = 0
    for step in range(steps):
        with span("train.data", step=step):
            b = data.batch_for_step(step)
            if cfg.input_mode == "embeddings":
                b["embeds"] = stub_embeds(cfg, b["tokens"].to(device))
        with span("train.step", step=step):
            state, metrics = step_fn(state, b)
            # a span is host wall time: with tracing on it ends once the
            # step's work (the loss) is done on the card
            if trace_enabled() and device.type == "cuda":
                torch.cuda.synchronize(device)
        tokens_done += batch * seq
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])     # waits for the step
            tps = tokens_done / (time.monotonic() - t0)
            log(f"step {step + 1:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"aux {float(metrics['aux']):.4f} "
                f"tok/s {tps:,.0f}")
            history.append((step + 1, loss))
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--quant", default="moss", choices=QUANTS)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    print(f"path: training on {args.device}")
    return train(args.arch, smoke=args.smoke, steps=args.steps,
                 batch=args.batch, seq=args.seq, quant=args.quant,
                 lr=args.lr, microbatches=args.microbatches,
                 seed=args.seed, layers=args.layers, device=args.device,
                 ckpt_dir=args.ckpt_dir, mesh=args.mesh)


if __name__ == "__main__":
    main()
