"""Compare the decode-attention kernel of this checkout with another
checkout's on one NVIDIA GPU: the q_len = 1 outputs bit for bit, and
their times, at chip_smoke.py's decode shapes (h2o-danube-3-4b's and
recurrentgemma-2b's rings; phi3-mini's pages and identity rows at 64
and ~4096 slots), fp8 and bf16 caches, on the same inputs from one seed.

    python3 tools/ab_decode_attn.py OTHER/src     # from this checkout

Each checkout runs in its own process (both packages are named
``repro_torch``; PYTHONPATH picks the one), in the order this, other,
other, this.  Times are chip_smoke.py's ``Timer`` in batches.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (layout, B, KV, G, Dh, page size or C, pages a slot, n_valid)
SHAPES = {
    "ring h2o": ("ring", 4, 8, 4, 120, 4096, 1, [4100, 4200, 300, 97]),
    "ring recurrentgemma": ("ring", 4, 1, 10, 256, 2048, 1,
                            [2048, 2500, 1000, 1]),
    "paged phi3": ("paged", 4, 32, 1, 96, 16, 4, [17, 64, 33, 5]),
    "paged phi3-long": ("paged", 4, 32, 1, 96, 16, 256,
                        [3000, 4096, 3517, 3999]),
    "identity phi3": ("ring", 4, 32, 1, 96, 64, 1, [17, 64, 33, 5]),
    "identity phi3-long": ("ring", 4, 32, 1, 96, 4160, 1,
                           [3000, 4096, 3517, 3999]),
}


def measure(dst: str) -> None:
    """Every shape on this process's ``repro_torch``: the outputs to
    ``dst``, the times to ``dst`` + ``.json``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer
    from repro_torch.kernels import decode_attn
    from repro_torch.models.attention import _quant_kv

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    outs, times = {}, {}
    for name, (layout, b, kvh, g, dh, t, n_p, nv) in SHAPES.items():
        paged = layout == "paged"
        rows = b * n_p + 1 if paged else b
        q, kf, vf = randn(b, kvh, g, dh), randn(rows, kvh, t, dh), \
            randn(rows, kvh, t, dh)
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        tail = ()
        if paged:
            tail = (torch.randperm(rows - 1, device="cuda", generator=gen)
                    [:b * n_p].reshape(b, n_p).to(torch.int32),)
        fn = decode_attn.decode_attn_paged if paged else \
            decode_attn.decode_attn
        for dtype in ("fp8", "bf16"):
            if dtype == "fp8":
                (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
            else:
                k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            call = lambda: fn(q, k, v, ks, vs, nv, *tail,
                              sm_scale=dh ** -0.5)
            outs[f"{name} {dtype}"] = call().cpu()
            times[f"{name} {dtype}"] = timer.ms(call, batched=True)
    torch.save(outs, dst)
    Path(dst + ".json").write_text(json.dumps(times))


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--measure":
        measure(argv[2])
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    trees = {"this": str(ROOT / "src"), "other": str(Path(argv[1]).resolve())}
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for i, tag in enumerate(("this", "other", "other", "this")):
            dst = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--measure", dst],
                           env=dict(os.environ, PYTHONPATH=trees[tag]),
                           check=True, timeout=600)
            runs.append(dst)
            times = json.loads(Path(dst + ".json").read_text())
            print(f"{tag} ({trees[tag]}): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in times.items()))
        this, other = torch.load(runs[0]), torch.load(runs[1])
    for key, want in other.items():
        diff = (this[key] - want).abs()
        print(f"{key}: " + ("bitwise" if torch.equal(this[key], want) else
                            f"{int((diff > 0).sum())} of {diff.numel()} "
                            f"outputs differ, max {float(diff.max()):.3g}"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
