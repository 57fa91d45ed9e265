"""Where a training step's time goes on the card.

Builds one of chip_smoke.py's training configurations at full width --
olmo-7b (depth cut to 4 layers, batch 1 x 2048), with ``--arch
phi3.5-moe-42b-a6.6b`` the MoE model (depth cut to 1 layer, batch
2 x 4096: the grouped-expert kernels) or with ``--arch
deepseek-v2-lite-16b`` the MLA MoE model (its dense layer and 2 MoE
layers, batch 2 x 4096), or stablelm-12b, minitron-8b,
recurrentgemma-2b, rwkv6-3b, musicgen-medium or phi-3-vision-4.2b at
chip_smoke.py's depths (2, 1, 5, 4, 8 and 4 layers, batch 1 x 4096; the
embeddings models on the training CLI's frontend stub) -- in moss or
``--quant``, takes
one untraced warm-up step and two timed untraced steps, then two steps
under ``torch.profiler``, each inside a ``train_step`` span.  From the
Chrome trace it reports per step the host span, the card's busy time
(the union of its kernels' and copies' intervals), the launches, the
card time by kernel and by port kernel (``moe_gmm_kernel``,
``moe_dw_gemm_kernel``, ...), and for the traced run the card's idle
share; the untraced step's idle share is the traced card time over the
untraced step (kernel durations do not depend on the host).  rwkv6's
forward WKV (the chunked scan, in the forward and the remat recompute)
runs in a ``wkv`` span of its own, reported beside the step (its
backward runs in autograd's engine, outside any span: in the step's).

  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --trace build/train_trace.json [--quant bf16|per_group|per_tensor]
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch phi3.5-moe-42b-a6.6b --trace build/moe_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch deepseek-v2-lite-16b --trace build/mla_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch rwkv6-3b --trace build/rwkv_trace.json
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.profile_serve import span_wkv, summarize
from repro_torch.launch.train import QUANTS, quant_from_name, stub_embeds
from repro_torch.train.steps import (
    TrainHParams,
    init_train_state,
    make_train_step,
)

SPAN = "train_step"
# chip_smoke.py's training cells: (layers, batch, seq)
CELLS = {"olmo-7b": (4, 1, 2048),               # TRAIN_LAYERS, TRAIN_M
         "phi3.5-moe-42b-a6.6b": (1, 2, 4096),  # MOE_LAYERS, MOE_BATCH/SEQ
         "deepseek-v2-lite-16b": (3, 2, 4096),  # MLA_TRAIN_LAYERS, MLA_*
         # FAMILY_TRAIN_LAYERS, FAMILY_TRAIN_M
         "stablelm-12b": (2, 1, 4096),
         "minitron-8b": (1, 1, 4096),
         "recurrentgemma-2b": (5, 1, 4096),
         "rwkv6-3b": (4, 1, 4096),
         "musicgen-medium": (8, 1, 4096),
         "phi-3-vision-4.2b": (4, 1, 4096)}


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
    if cfg.family == "ssm":
        span_wkv()

    def batch_for_step(i):
        b = data.batch_for_step(i)
        if cfg.input_mode == "embeddings":
            b["embeds"] = stub_embeds(cfg, b["tokens"].cuda())
        return b

    state, _ = step(state, batch_for_step(0))             # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in (1, 2):
        state, met = step(state, batch_for_step(i))
    torch.cuda.synchronize()
    untraced = (time.monotonic() - t0) / 2
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in (3, 4):
            with torch.profiler.record_function(SPAN):
                state, met = step(state, batch_for_step(i))
                float(met["loss"])
        torch.cuda.synchronize()
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        report = summarize(json.load(f), (SPAN, "wkv"))
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
