"""Where a training step's time goes on the card.

Builds one of chip_smoke.py's training configurations at full width --
olmo-7b (depth cut to 4 layers, batch 1 x 2048) or, with ``--arch
phi3.5-moe-42b-a6.6b``, the MoE model (depth cut to 1 layer, batch
2 x 4096: the grouped-expert kernels) -- in moss or ``--quant``, takes
one untraced warm-up step and two timed untraced steps, then two steps
under ``torch.profiler``, each inside a ``train_step`` span.  From the
Chrome trace it reports per step the host span, the card's busy time
(the union of its kernels' and copies' intervals), the launches, the
card time by kernel and by port kernel (``moe_gmm_kernel``,
``moe_dw_gemm_kernel``, ...), and for the traced run the card's idle
share; the untraced step's idle share is the traced card time over the
untraced step (kernel durations do not depend on the host).

  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --trace build/train_trace.json [--quant bf16|per_group|per_tensor]
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch phi3.5-moe-42b-a6.6b --trace build/moe_trace.json
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.profile_serve import summarize
from repro_torch.launch.train import QUANTS, quant_from_name
from repro_torch.train.steps import (
    TrainHParams,
    init_train_state,
    make_train_step,
)

SPAN = "train_step"
# chip_smoke.py's training cells: (layers, batch, seq)
CELLS = {"olmo-7b": (4, 1, 2048),               # TRAIN_LAYERS, TRAIN_M
         "phi3.5-moe-42b-a6.6b": (1, 2, 4096)}  # MOE_LAYERS, MOE_BATCH/SEQ


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="train_trace.json",
                    help="where to write the Chrome trace")
    ap.add_argument("--quant", default="moss", choices=QUANTS)
    ap.add_argument("--arch", default="olmo-7b", choices=sorted(CELLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card: no CUDA device")

    layers, batch, seq = CELLS[args.arch]
    cfg = get_config(args.arch).replace(n_layers=layers,
                                        quant=quant_from_name(args.quant))
    hp = TrainHParams(peak_lr=3e-4, warmup_steps=0, total_steps=5)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    state = init_train_state(cfg, hp, seed=0, device="cuda")
    step = make_train_step(cfg, hp)
    state, _ = step(state, data.batch_for_step(0))        # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in (1, 2):
        state, met = step(state, data.batch_for_step(i))
    torch.cuda.synchronize()
    untraced = (time.monotonic() - t0) / 2
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in (3, 4):
            with torch.profiler.record_function(SPAN):
                state, met = step(state, data.batch_for_step(i))
                float(met["loss"])
        torch.cuda.synchronize()
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        report = summarize(json.load(f), (SPAN,))
    report["card"] = torch.cuda.get_device_name(0)
    report["cell"] = {"arch": args.arch, "quant": args.quant,
                      "layers": layers, "batch": batch, "seq": seq}
    report["untraced_step_ms"] = 1e3 * untraced
    report["tok_per_s_untraced"] = batch * seq / untraced
    if SPAN in report and untraced > 0:
        report["card_idle_share_untraced"] = (
            1.0 - report[SPAN]["card_busy_ms"] / (1e3 * untraced))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
