"""Compare the decode-attention kernel of this checkout with another
checkout's on one NVIDIA GPU, at chip_smoke.py's decode shapes: the
q_len = 1 form at h2o-danube-3-4b's and recurrentgemma-2b's rings and at
phi3-mini's pages and identity rows (64 and ~4096 slots), and the verify
form (q_len 4) at phi3-mini's pages and identity rows (64 and ~4096
slots) and h2o-danube-3-4b's widths; fp8 and bf16 caches, the same
inputs from one seed.

    python3 tools/ab_decode_attn.py OTHER/src     # from this checkout

Each checkout runs in its own process (both packages are named
``repro_torch``; PYTHONPATH picks the one), in the order this, other,
other, this.  Times are chip_smoke.py's ``Timer`` in batches: the
wrapper at q_len 1, the kernel's launch alone (``launch``,
``launch_paged``) for the verify form, as chip_smoke.py times them.
Outputs of two designs need not agree bit for bit: each shape prints max
|this - other| beside chip_smoke.py's ``attn_limit`` (1e-5 plus twice
the plain version's own error against float64, from this checkout's
first run), and the script exits 1 if any difference passes it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (layout, B, KV, q_len, G, Dh, page size or C, pages a slot, n_valid)
SHAPES = {
    "ring h2o": ("ring", 4, 8, 1, 4, 120, 4096, 1, [4100, 4200, 300, 97]),
    "ring recurrentgemma": ("ring", 4, 1, 1, 10, 256, 2048, 1,
                            [2048, 2500, 1000, 1]),
    "paged phi3": ("paged", 4, 32, 1, 1, 96, 16, 4, [17, 64, 33, 5]),
    "paged phi3-long": ("paged", 4, 32, 1, 1, 96, 16, 256,
                        [3000, 4096, 3517, 3999]),
    "identity phi3": ("ring", 4, 32, 1, 1, 96, 64, 1, [17, 64, 33, 5]),
    "identity phi3-long": ("ring", 4, 32, 1, 1, 96, 4160, 1,
                           [3000, 4096, 3517, 3999]),
    "verify paged phi3": ("paged", 4, 32, 4, 1, 96, 16, 4,
                          [17, 64, 33, 5]),
    "verify paged phi3-long": ("paged", 4, 32, 4, 1, 96, 16, 256,
                               [3000, 4096, 3517, 3999]),
    "verify identity phi3": ("ring", 4, 32, 4, 1, 96, 64, 1,
                             [17, 64, 33, 5]),
    "verify identity phi3-long": ("ring", 4, 32, 4, 1, 96, 4160, 1,
                                  [3000, 4096, 3517, 3999]),
    "verify h2o": ("ring", 4, 8, 4, 4, 120, 4096, 1, [4096, 4000, 300, 97]),
}


def measure(dst: str) -> None:
    """Every shape on this process's ``repro_torch``: the outputs and
    the attention limits to ``dst``, the times to ``dst`` + ``.json``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer, attn_limit, decode_attn_f64
    from repro_torch.kernels import decode_attn
    from repro_torch.models.attention import _quant_kv

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    outs, lims, times = {}, {}, {}
    for name, (layout, b, kvh, s, g, dh, t, n_p, nv) in SHAPES.items():
        paged = layout == "paged"
        rows = b * n_p + 1 if paged else b
        q, kf, vf = randn(b, kvh, s * g, dh), randn(rows, kvh, t, dh), \
            randn(rows, kvh, t, dh)
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        tail = ()
        if paged:
            tail = (torch.randperm(rows - 1, device="cuda", generator=gen)
                    [:b * n_p].reshape(b, n_p).to(torch.int32),)
        fn, launch, plain = (
            (decode_attn.decode_attn_paged, decode_attn.launch_paged,
             decode_attn.decode_attn_paged_plain) if paged else
            (decode_attn.decode_attn, decode_attn.launch,
             decode_attn.decode_attn_ref))
        q5 = q.reshape(b, kvh, s, g, dh) if s > 1 else q
        for dtype in ("fp8", "bf16"):
            if dtype == "fp8":
                (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
            else:
                k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            args = (k, v, ks, vs, nv) + tail
            key = f"{name} {dtype}"
            got = fn(q, *args, sm_scale=dh ** -0.5, q_len=s)
            outs[key] = got.cpu()
            want = plain(q5, *args, sm_scale=dh ** -0.5).reshape(got.shape)
            cont = [None if x is None else
                    (decode_attn.gather_pages(x, tail[0]) if paged else x)
                    for x in (k, v, ks, vs)]
            exact = decode_attn_f64(torch, q5, *cont, nv, dh ** -0.5)
            lims[key] = attn_limit(torch, got, want,
                                   exact.reshape(got.shape))[2]
            call = (lambda: fn(q, *args, sm_scale=dh ** -0.5)) if s == 1 \
                else (lambda: launch(q, *args, sm_scale=dh ** -0.5,
                                     q_len=s))
            times[key] = timer.ms(call, batched=True)
            del got, want, cont, exact
        del q, kf, vf
        torch.cuda.empty_cache()
    torch.save({"outs": outs, "lims": lims}, dst)
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
        runs, times = [], {"this": [], "other": []}
        for i, tag in enumerate(("this", "other", "other", "this")):
            dst = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--measure", dst],
                           env=dict(os.environ, PYTHONPATH=trees[tag]),
                           check=True, timeout=900)
            runs.append(dst)
            times[tag].append(json.loads(Path(dst + ".json").read_text()))
        this, other = torch.load(runs[0]), torch.load(runs[1])
    print(f"this: {trees['this']}, other: {trees['other']}")
    bad = 0
    for key, want in other["outs"].items():
        got, lim = this["outs"][key], this["lims"][key]
        t = [r[key] for r in times["this"]]
        o = [r[key] for r in times["other"]]
        err = float((got - want).abs().max())
        same = "bitwise" if torch.equal(got, want) else \
            f"max |this - other| {err:.3g} (limit {lim:.3g})"
        bad += err > lim
        print(f"{key}: this {t[0]:.4f} / {t[1]:.4f} ms, other {o[0]:.4f} / "
              f"{o[1]:.4f} ms, other / this {sum(o) / sum(t):.2f}x; {same}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
