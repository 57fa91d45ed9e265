"""Compare the port's two-level quantizer of this checkout with another
checkout's on one NVIDIA GPU: the level-1 scale
(``dispatch.global_scale``) at olmo-7b's training inputs (the forward's
bf16 activations, the f32 gradients of the down projection and of the
head), at M 32 (the calibration forward) and over phi3.5-moe's routed
buffer (E 16 x C 1336 rows); ``mx_quant`` (the group pass, given the
scale) at the training shapes, at M 1, 4 and 32 and over the MoE
buffer; the two as the linear layers call them
(``dispatch.mx_quantize``); ``fused_quant_gemm`` at M 32 (the
calibration forward, given the scale) over phi3-mini-3.8b's shapes; and
``dispatch.fused_quant_matmul`` at olmo-7b's up projection (the call a
training step makes: scale, quantizer, tile and epilogue).

    python3 tools/ab_mx_quant.py OTHER/src        # from this checkout

It also takes the host's time to issue one ``dispatch.global_scale``
call (" host"), what the host-bound steps pay per linear layer, and at
the training shapes a floor under each pass: a device copy
(``Tensor.copy_``) that moves the pass's bytes, half read and half
written (" copy floor"), timed the same way.  chip_smoke.py's ``Timer``
empties the L2 with a memset, whose dirty lines the timed call writes
back as it evicts them, so neither pass nor copy reaches the bytes over
the memory rate.

Each checkout runs in its own process (both packages are named
``repro_torch``; PYTHONPATH picks the one), in the order this, other,
other, this, so that the speed-up is read on one card.  Kernel times
are chip_smoke.py's ``Timer`` (cold L2, median of 20).  The outputs of
the first two runs are compared: the scales, payloads and exponents bit
for bit, the fused sums within 1e-5 * max|other|; ``bitwise`` where
they are equal.  Exits 1 if an output differs beyond that.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MOE_ROWS = 16 * 1336            # phi3.5-moe's E x C at 2 x 4096 tokens
# the level-1 scale (what, M, K, x dtype, fmt)
SCALE = [("fwd", 2048, 4096, "bfloat16", "e4m3"),
         ("dx down", 2048, 11008, "float32", "e5m2"),
         ("dx head", 2048, 50304, "float32", "e5m2"),
         ("calibration", 32, 3072, "bfloat16", "e4m3"),
         ("moe buffer", MOE_ROWS, 4096, "bfloat16", "e4m3")]
# mx_quant given the scale (what, M, K, x dtype, fmt)
QUANT = [("fwd", 2048, 4096, "bfloat16", "e4m3"),
         ("dx down", 2048, 11008, "float32", "e5m2"),
         ("decode", 1, 3072, "bfloat16", "e4m3"),
         ("decode", 4, 3072, "bfloat16", "e4m3"),
         ("calibration", 32, 3072, "bfloat16", "e4m3"),
         ("calibration", 32, 8192, "bfloat16", "e4m3"),
         ("moe buffer", MOE_ROWS, 4096, "bfloat16", "e4m3")]
# dispatch.mx_quantize: the scale, then the group pass
CALLED = QUANT[:2]
# fused_quant_gemm at M 32 given the scale (M, K, N), e4m3 on bf16
FUSED_SMALL = [(32, 3072, 8192), (32, 3072, 3072), (32, 8192, 3072)]
# dispatch.fused_quant_matmul (M, K, N), e4m3 on bf16: olmo-7b's up
MATMUL = [(2048, 4096, 11008)]


def _host_ms(torch, fn, n: int = 50) -> float:
    """The host's time to issue one call, in ms: the median over 5
    rounds of n calls issued back to back, each round started on an
    idle card."""
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        rounds.append((time.perf_counter() - t0) / n * 1e3)
    torch.cuda.synchronize()
    return statistics.median(rounds)


def measure(dst: str, keep: bool) -> None:
    """Every case on this process's ``repro_torch``: the times to
    ``dst`` + ``.json`` and, with ``keep``, the outputs to ``dst``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer, _activations
    from repro_torch.core.quant import quant_per_tensor
    from repro_torch.kernels import dispatch, mx_fused, mx_quant

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    big = ("fwd", "dx down")

    def copy_floor(nbytes: int) -> float:
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        return timer.ms(lambda: dst.copy_(src), batched=True)
    outs, times = {}, {}

    def inputs(m, k, dt):
        x = _activations(torch, gen, m, k).to(getattr(torch, dt))
        return x * 1e-3 if dt == "float32" else x

    for what, m, k, dt, fmt in SCALE:
        x = inputs(m, k, dt)
        name = f"global_scale {what} {dt} {fmt} M={m} K={k}"
        outs[name] = dispatch.global_scale(x, fmt).view(torch.int32).cpu()
        times[name] = timer.ms(lambda: dispatch.global_scale(x, fmt),
                               batched=True)
        if what in big:
            times[name + " copy floor"] = copy_floor(x.numel()
                                                     * x.element_size())
        if what == "fwd":
            times[name + " host"] = _host_ms(
                torch, lambda: dispatch.global_scale(x, fmt))
        del x
    for what, m, k, dt, fmt in QUANT:
        x = inputs(m, k, dt)
        s = dispatch.global_scale(x, fmt)
        name = f"mx_quant {what} {dt} {fmt} M={m} K={k}"
        q, se = mx_quant.mx_quant(x, s, fmt)
        outs[name + " q"] = q.view(torch.uint8).cpu()
        outs[name + " sexp"] = se.cpu()
        times[name] = timer.ms(lambda: mx_quant.mx_quant(x, s, fmt),
                               batched=True)
        if what in big:
            times[name + " copy floor"] = copy_floor(
                x.numel() * (x.element_size() + 1) + x.numel() // 32)
        del x, q, se
    for what, m, k, dt, fmt in CALLED:
        x = inputs(m, k, dt)
        name = f"mx_quantize (scale + group pass) {what} {dt} {fmt} M={m} " \
               f"K={k}"
        xq = dispatch.mx_quantize(x, fmt)
        outs[name + " q"] = xq.q.view(torch.uint8).cpu()
        times[name] = timer.ms(lambda: dispatch.mx_quantize(x, fmt),
                               batched=True)
        del x, xq
    for m, k, n in FUSED_SMALL:
        x = _activations(torch, gen, m, k)
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w).q
        s = dispatch.global_scale(x)
        name = f"fused_quant_gemm calibration e4m3 M={m} K={k} N={n}"
        acc, q, _ = mx_fused.fused_quant_gemm(x, s, qw)
        outs[name] = acc.cpu()
        outs[name + " q"] = q.view(torch.uint8).cpu()
        times[name] = timer.ms(lambda: mx_fused.fused_quant_gemm(x, s, qw))
        del x, w, qw, acc, q
    for m, k, n in MATMUL:
        x = _activations(torch, gen, m, k)
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        wq = quant_per_tensor(w)
        name = f"fused_quant_matmul fwd e4m3 M={m} K={k} N={n}"
        y, _ = dispatch.fused_quant_matmul(x, wq, out_dtype=torch.float32)
        outs[name] = y.cpu()
        times[name] = timer.ms(lambda: dispatch.fused_quant_matmul(x, wq))
        del x, w, wq, y
    del timer
    torch.cuda.empty_cache()
    if keep:
        torch.save(outs, dst)
    Path(dst + ".json").write_text(json.dumps(times))


def main(argv: list[str]) -> int:
    if len(argv) == 4 and argv[1] == "--measure":
        measure(argv[2], argv[3] == "keep")
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    trees = {"this": str(ROOT / "src"), "other": str(Path(argv[1]).resolve())}
    with tempfile.TemporaryDirectory() as tmp:
        runs, times = [], {"this": [], "other": []}
        for i, tag in enumerate(("this", "other", "other", "this")):
            dst = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--measure", dst,
                            "keep" if i < 2 else "times"],
                           env=dict(os.environ, PYTHONPATH=trees[tag]),
                           check=True, timeout=900)
            runs.append(dst)
            t = json.loads(Path(dst + ".json").read_text())
            times[tag].append(t)
            print(f"{tag} ({trees[tag]}): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in t.items()))
        this, other = torch.load(runs[0]), torch.load(runs[1])
    for key in times["this"][0]:
        a = [t[key] for t in times["this"]]
        b = [t[key] for t in times["other"]]
        print(f"{key}: this {statistics.mean(a):.4f} ms ({a[0]:.4f} / "
              f"{a[1]:.4f}), other {statistics.mean(b):.4f} ms ({b[0]:.4f} "
              f"/ {b[1]:.4f}), speed-up "
              f"{statistics.mean(b) / statistics.mean(a):.2f}x")
    bad = []
    for key, want in other.items():
        got = this[key]
        if torch.equal(got, want):
            print(f"{key}: bitwise")
            continue
        if got.dtype != torch.float32:
            print(f"{key}: {int((got != want).sum())} of {got.numel()} "
                  f"differ")
            bad.append(key)
            continue
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"{key}: max err {err:.3g} (max|other| {scale:.3g}, "
              f"{'within' if err <= 1e-5 * scale else 'OUTSIDE'} "
              f"1e-5 * max|other|)")
        if err > 1e-5 * scale:
            bad.append(key)
    if bad:
        print(f"outputs that differ beyond the limit: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
