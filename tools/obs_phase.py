"""chip_smoke.py's phase ``engine obs`` alone, on one card (~2 min).

Builds the kernels, serves the hatch phase's default run (full-width
phi3-mini at HATCH_LAYERS layers, phase 4's 8 requests), then runs
``phase_engine_obs`` against it: the quant-health taps and their
launches, a refresh of stale activation scales, REPRO_KV_CACHE=bf16
pools, the serving CLI's metrics and trace, and a traced training step.
Exits 1 when a gate fails, as chip_smoke.py does.

    python3 tools/obs_phase.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        return cs.fail("tools/obs_phase.py needs an NVIDIA GPU")
    print(cs.phase_card(torch))
    t0 = time.monotonic()
    cs.phase_build()
    print(f"build {time.monotonic() - t0:.1f} s")
    reqs, *_ = cs._serve_once(torch, np, seed=0, layers=cs.HATCH_LAYERS)
    hatch = [list(r.out) for r in reqs]
    t0 = time.monotonic()
    try:
        cs.phase_engine_obs(torch, np, hatch)
    except AssertionError as e:
        return cs.fail(str(e))
    print(f"phase engine obs: {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
