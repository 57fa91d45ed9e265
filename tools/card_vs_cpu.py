"""How far the card's serving steps lie from the CPU's at full width:
phi3-mini-3.8b at full width, depth cut to chip_smoke.py's
``BASELINE_CHECK_LAYERS``, built as the engine builds it (pre-quantized
weights, calibrated activation scales) on each device from the same
seeded weights, then chip_smoke.py's ``_steps``: one chunked-prefill
step of 13 prompt tokens and three decode steps, the card fed the CPU's
greedy tokens.

For each recipe (moss, per_group, per_tensor) it prints, per step,
max|card - CPU| / max|logit| (a) with each device's own calibrated
scales and (b) with the card given the CPU's scales, and how many
calibrated scale entries differ between the devices.  The card's norms
and RoPE run PyTorch's own arithmetic, the CPU's follow XLA's
(``core/xla_cpu_numerics.py``): where a bf16 flip moves a site's
amax, a per_group group scale moves, and every fp8 rounding of that
group with it.  Then, for the run with the CPU's scales, where the two
devices part: per step, each quantized site whose output differs from
an input that is equal on both devices (an f32 sum in another order,
rounded to bf16), and the first site whose input differs (such a
difference carried on, through an fp8 rounding it moved).  Needs a
card.

    python3 tools/card_vs_cpu.py
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SITES = ("q", "k", "v", "o", "up", "gate", "down")    # a layer's, in order


def _site(i, layers):
    return "head" if i == 7 * layers else f"{SITES[i % 7]}{i // 7}"


def _parting(label, cpu_calls, card_calls, layers):
    """Print, per step, where the card's quantized sites part from the
    CPU's (each call's input and output, in call order)."""
    n = 7 * layers + 1
    assert len(cpu_calls) == len(card_calls) == 4 * n
    for step in range(4):
        own, carried = [], None
        for i in range(n):
            (xc, yc), (xg, yg) = (cpu_calls[step * n + i],
                                  card_calls[step * n + i])
            nx, ny = int((xc != xg).sum()), int((yc != yg).sum())
            if nx == 0 and ny:
                own.append(f"{_site(i, layers)} ({ny} of {yc.numel()})")
            if nx and carried is None:
                carried = (f"{_site(i, layers)} ({nx} of {xc.numel()}, max "
                           f"{float((xc - xg).abs().max()):.3g} at |x| "
                           f"{float(xc.abs().max()):.3g}; output {ny})")
        print(f"{label} step {step}: outputs differ from equal inputs at "
              f"{', '.join(own) or 'no site'}; first input that differs: "
              f"{carried or 'none'}")


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.core import linear
    from repro_torch.core.formats import (MOSS_CONFIG, PER_GROUP_CONFIG,
                                          PER_TENSOR_CONFIG)

    if not torch.cuda.is_available():
        print("tools/card_vs_cpu.py: needs a card", file=sys.stderr)
        return 1
    layers = cs.BASELINE_CHECK_LAYERS
    calls = []
    served = linear._qmm_delayed

    def recorded(cfg, x, wt, a):
        y = served(cfg, x, wt, a)
        calls.append((x.float().cpu(), y.float().cpu()))
        return y

    linear._qmm_delayed = recorded
    base = get_config(cs.ARCH).replace(n_layers=layers)
    for label, qcfg in (("moss", MOSS_CONFIG), ("per_group", PER_GROUP_CONFIG),
                        ("per_tensor", PER_TENSOR_CONFIG)):
        cfg = base.replace(quant=qcfg)
        calls.clear()
        params, prompt, built_cpu, cpu = cs._card_and_cpu(torch, np, cfg)
        cpu_calls = list(calls)
        qw, sc, act = cs._build(torch, cfg, params, "cuda")
        own = cs._steps(torch, np, cfg, "cuda", (qw, sc, act), prompt,
                        feed_from=cpu)
        calls.clear()
        shared = cs._steps(torch, np, cfg, "cuda",
                           (qw, sc, cs._moved(built_cpu[2], "cuda")),
                           prompt, feed_from=cpu)
        card_calls = list(calls)
        for i, (a, b, c) in enumerate(zip(cpu, own, shared)):
            big = float(np.abs(a).max())
            print(f"{label} {layers} layers step {i}: max|logit| "
                  f"{big:.4g}, card vs CPU / max|logit|: own scales "
                  f"{float(np.abs(a - b).max()) / big:.4g}, the CPU's "
                  f"scales {float(np.abs(a - c).max()) / big:.4g}")
        diff = n = 0
        rel = 0.0
        sub_diff = sub_n = 0
        for tag, a in built_cpu[2].items():
            b = act[tag]
            sa, sb = a.s.float(), b.s.float().cpu()
            diff += int((sa != sb).sum())
            n += sa.numel()
            rel = max(rel, float(((sa - sb).abs() / sa.abs()).max()))
            if a.sub is not None:
                sub_diff += int((a.sub != b.sub.cpu()).sum())
                sub_n += a.sub.numel()
        print(f"{label}: calibrated scales differ in {diff} of {n} entries "
              f"(max rel {rel:.3g})"
              + (f", E8M0 exponents in {sub_diff} of {sub_n}"
                 if sub_n else ""))
        _parting(f"{label}, the CPU's scales,", cpu_calls, card_calls,
                 layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
