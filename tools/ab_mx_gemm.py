"""Compare the port's fp8 GEMMs of this checkout with another checkout's
on one NVIDIA GPU: ``mx_gemm`` at M <= 32 (decode M 4, verify M 16 and
prefill-chunk M 32 rows over phi3-mini-3.8b's and h2o-danube-3-4b's
decode shapes) and ``fused_quant_gemm`` at M 32 (the calibration
forward), ``mx_gemm`` at M > 32 (the paper's Table 6 shapes and
h2o-danube-3-4b's 4160-token prefill), ``fused_quant_gemm`` at olmo-7b's
training M 2048 (the forward, e4m3 on bf16 activations, and dx, e5m2 on
an f32 gradient against the transposed weights), ``group_gemm`` at
chip_smoke.py's per_group forward, dx and dW shapes (olmo-7b's up
projection, M 2048 tokens) and at Table 6's, ``moe_gmm`` at
phi3.5-moe's up forward and its dx (E 16, C 1336, K 4096, N 6400; the
expert sizes drawn from one seed, ~16k routed rows), ``mx_dw_gemm`` at
olmo-7b's three dW shapes with 2048 tokens (the up and down projections
and the head: K 4096 / N 11008, K 11008 / N 4096, K 4096 / N 50304),
``moe_dw_gemm`` at phi3.5-moe's up dW (E 16, Cp 1344, K 4096, N 6400,
the sizes as for ``moe_gmm``), and
chip_smoke.py's training steps: olmo-7b (4 of 32 layers, 1 x 2048
tokens) in moss and per_group, and phi3.5-moe (1 of 32 layers, 2 x 4096
tokens) in moss, on the same inputs from one seed.

    python3 tools/ab_mx_gemm.py OTHER/src        # from this checkout
    python3 tools/ab_mx_gemm.py OTHER/src --small    # the M <= 32 cases

At M <= 32 it also takes the host's time to issue one ``mx_gemm`` call
(" host"): the decode step is host-bound.

Each checkout runs in its own process (both packages are named
``repro_torch``; PYTHONPATH picks the one), in the order this, other,
other, this, so that the speed-up is read on one card.  Kernel times
are chip_smoke.py's ``Timer`` (cold L2, median of 20); a step time is
the median of steps 1-3 of 4 (host clock around a synchronised step).
The outputs of the first two runs are compared: the fused and grouped
payloads (q, sexp) and the dW requant payloads (q', e') bit for bit,
the sums within 1e-5 * max|other| (the two may sum in different
orders); ``bitwise`` where they are equal.
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
# mx_gemm at M <= 32 (M, N, K): phi3-mini-3.8b's q/k/v/o, gate/up, down
# and head, then h2o-danube-3-4b's q/o, k/v, gate/up, head and down, at
# the decode, verify and prefill-chunk rows
SMALL_MNK = [(m, n, k) for m in (4, 16, 32) for k, n in (
    (3072, 3072), (3072, 8192), (8192, 3072), (3072, 32064), (3840, 3840),
    (3840, 960), (3840, 10240), (3840, 32000), (10240, 3840))]
# fused_quant_gemm at M 32 (what, fmt, M, K, N): the calibration forward
SMALL_FUSED = [("calibration", "e4m3", 32, 3072, 8192),
               ("calibration", "e4m3", 32, 8192, 3072)]
# mx_gemm (M, N, K): Table 6, then h2o-danube-3-4b's prefill qkv and down
GEMM_MNK = [(2048, 7168, 4096), (4096, 2048, 7168), (4096, 4096, 8192),
            (4160, 5760, 3840), (4160, 3840, 10240)]
# fused_quant_gemm (what, fmt, M, K, N): olmo-7b's up forward and its dx
FUSED = [("fwd", "e4m3", 2048, 4096, 11008), ("dx", "e5m2", 2048, 11008,
                                               4096)]
# group_gemm (what, x fmt, w fmt, M, K, N): olmo-7b's up projection in
# per_group (forward, dx, dW), then Table 6's (M, N, K)
GROUP = [("fwd", "e4m3", "e4m3", 2048, 4096, 11008),
         ("dx", "e5m2", "e4m3", 2048, 11008, 4096),
         ("dW", "e4m3", "e5m2", 4096, 2048, 11008)] + [
    ("table6", "e4m3", "e4m3", m, k, n) for m, n, k in GEMM_MNK[:3]]
# moe_gmm (what, fmt, E, C, K, N): phi3.5-moe's up forward and its dx
MOE = [("fwd", "e4m3", 16, 1336, 4096, 6400),
       ("dx", "e5m2", 16, 1336, 6400, 4096)]
# mx_dw_gemm (M tokens, K, N): olmo-7b's up, down and head dW
DW = [(2048, 4096, 11008), (2048, 11008, 4096), (2048, 4096, 50304)]
# moe_dw_gemm (E, C, K, N): phi3.5-moe's up dW (Cp = C rounded up to 32)
MOE_DW = [(16, 1336, 4096, 6400)]


def _train_step_ms(torch, arch: str, mode: str) -> float:
    """A step of chip_smoke.py's training phases (olmo-7b, or phi3.5-moe
    with ``arch`` "moe"), in ms."""
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import quant_from_name
    from repro_torch.train.steps import (TrainHParams, init_train_state,
                                         make_train_step)

    hp = TrainHParams(peak_lr=3e-4, warmup_steps=0, total_steps=4)
    if arch == "moe":
        cfg = cs._moe_cfg(get_config, quant_from_name, mode, smoke=False)
        seq, batch = cs.MOE_SEQ, cs.MOE_BATCH
    else:
        cfg = cs._train_cfg(get_config, quant_from_name, mode, smoke=False)
        seq, batch = cs.TRAIN_M, 1
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0))
    state = init_train_state(cfg, hp, seed=0, device="cuda")
    step = make_train_step(cfg, hp)
    times = []
    for i in range(4):
        batch = data.batch_for_step(i)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, met = step(state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    del state, step
    torch.cuda.empty_cache()
    return statistics.median(times[1:])


def _host_ms(torch, fn, n: int = 50) -> float:
    """The host's time to issue one call (the wrapper's checks, its
    allocation and its launch), in ms: the median over 5 rounds of n
    calls issued back to back, each round started on an idle card; what
    a host-bound decode step pays per linear layer."""
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        rounds.append((time.perf_counter() - t0) / n * 1e3)
    torch.cuda.synchronize()
    return statistics.median(rounds)


def measure(dst: str, keep: bool, small_only: bool = False) -> None:
    """Every case (with ``small_only``, the M <= 32 ones) on this
    process's ``repro_torch``: the times to ``dst`` + ``.json`` and, with
    ``keep``, the outputs to ``dst``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer, _activations
    from repro_torch.core.quant import (quant_mx, quant_per_group,
                                        quant_per_tensor)
    from repro_torch.kernels import (dispatch, group_gemm, moe_gmm, mx_bwd,
                                     mx_fused, mx_gemm)

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    outs, times = {}, {}
    for m, n, k in SMALL_MNK:
        xq = quant_mx(_activations(torch, gen, m, k))
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w).q
        name = f"mx_gemm M={m} N={n} K={k}"
        outs[name] = mx_gemm.mx_gemm(xq.q, xq.sexp, qw).cpu()
        times[name] = timer.ms(lambda: mx_gemm.mx_gemm(xq.q, xq.sexp, qw))
        times[name + " host"] = _host_ms(
            torch, lambda: mx_gemm.mx_gemm(xq.q, xq.sexp, qw))
        del xq, w, qw
    for what, fmt, m, k, n in SMALL_FUSED + ([] if small_only else FUSED):
        x = _activations(torch, gen, m, k)
        if what == "dx":
            x = x.float() * 1e-3
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w).q
        s = dispatch.global_scale(x, fmt)
        name = f"fused_quant_gemm {what} {fmt} M={m} K={k} N={n}"
        acc, q, se = mx_fused.fused_quant_gemm(x, s, qw, fmt)
        outs[name] = acc.cpu()
        outs[name + " q"] = q.view(torch.uint8).cpu()
        outs[name + " sexp"] = se.cpu()
        times[name] = timer.ms(lambda: mx_fused.fused_quant_gemm(x, s, qw,
                                                                 fmt))
        del x, w, qw, acc, q, se
    if small_only:
        if keep:
            torch.save(outs, dst)
        Path(dst + ".json").write_text(json.dumps(times))
        return
    for m, n, k in GEMM_MNK:
        xq = quant_mx(_activations(torch, gen, m, k))
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w).q
        name = f"mx_gemm M={m} N={n} K={k}"
        outs[name] = mx_gemm.mx_gemm(xq.q, xq.sexp, qw).cpu()
        times[name] = timer.ms(lambda: mx_gemm.mx_gemm(xq.q, xq.sexp, qw))
        del xq, w, qw
    for what, x_fmt, w_fmt, m, k, n in GROUP:
        x = _activations(torch, gen, m, k)
        if what == "dx":
            x = x.float() * 1e-3
        xq = quant_per_group(x, 128, x_fmt)
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w, w_fmt).q
        name = f"group_gemm {what} {x_fmt} x {w_fmt} M={m} K={k} N={n}"
        outs[name] = group_gemm.group_gemm(xq.q, xq.s, qw).cpu()
        times[name] = timer.ms(lambda: group_gemm.group_gemm(xq.q, xq.s,
                                                             qw))
        del x, xq, w, qw
    for what, fmt, e, c, k, n in MOE:
        sizes = np.random.default_rng(e * c).integers(c // 2, c + 1, e)
        sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        live = (torch.arange(c, device="cuda")[None, :]
                < sizes[:, None]).reshape(-1, 1)
        x = _activations(torch, gen, e * c, k) * live
        if what == "dx":
            x = x.float() * 1e-3
        w = torch.randn(e, k, n, device="cuda", generator=gen) / k ** 0.5
        qw = torch.stack([quant_per_tensor(wi).q for wi in w])
        del w
        s = dispatch.global_scale(x, fmt)
        name = (f"moe_gmm {what} {fmt} E={e} C={c} K={k} N={n} "
                f"({int(sizes.sum())} routed rows)")
        acc, q, se = moe_gmm.moe_gmm(x, s, qw, sizes, c, fmt)
        outs[name] = acc.cpu()
        outs[name + " q"] = q.view(torch.uint8).cpu()
        outs[name + " sexp"] = se.cpu()
        times[name] = timer.ms(lambda: moe_gmm.moe_gmm(x, s, qw, sizes, c,
                                                       fmt))
        del x, qw, acc, q, se
    for m, k, n in DW:
        xq = quant_mx(_activations(torch, gen, m, k))
        gq = quant_per_tensor(torch.randn(m, n, device="cuda",
                                          generator=gen) * 1e-3, "e5m2").q
        name = f"mx_dw_gemm M={m} K={k} N={n}"
        acc, qt, et = mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq, payload=True)
        outs[name] = acc.cpu()
        outs[name + " q'"] = qt.view(torch.uint8).cpu()
        outs[name + " e'"] = et.cpu()
        del acc, qt, et
        times[name] = timer.ms(lambda: mx_bwd.mx_dw_gemm(xq.q, xq.sexp, gq))
        del xq, gq
    for e, c, k, n in MOE_DW:
        cp = c + (-c) % 32
        sizes = np.random.default_rng(e * c).integers(c // 2, c + 1, e)
        sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        live = (torch.arange(cp, device="cuda")[None, :]
                < sizes[:, None]).reshape(-1, 1)
        xq = quant_mx(_activations(torch, gen, e * cp, k) * live)
        gq = quant_per_tensor(torch.randn(e * cp, n, device="cuda",
                                          generator=gen) * 1e-3 * live,
                              "e5m2").q
        name = (f"moe_dw_gemm E={e} Cp={cp} K={k} N={n} "
                f"({int(sizes.sum())} routed rows)")
        acc, qt, et = moe_gmm.moe_dw_gemm(xq.q, xq.sexp, gq, sizes, cp,
                                          payload=True)
        outs[name] = acc.cpu()
        outs[name + " q'"] = qt.view(torch.uint8).cpu()
        outs[name + " e'"] = et.cpu()
        del acc, qt, et
        times[name] = timer.ms(lambda: moe_gmm.moe_dw_gemm(
            xq.q, xq.sexp, gq, sizes, cp))
        del xq, gq
    del timer
    torch.cuda.empty_cache()
    for label, arch, mode in (
            ("moss step (olmo-7b, 4 layers, 1 x 2048)", "olmo", "moss"),
            ("per_group step (olmo-7b, 4 layers, 1 x 2048)", "olmo",
             "per_group"),
            ("moss step (phi3.5-moe, 1 layer, 2 x 4096)", "moe", "moss")):
        times[label] = _train_step_ms(torch, arch, mode)
    if keep:
        torch.save(outs, dst)
    Path(dst + ".json").write_text(json.dumps(times))


def main(argv: list[str]) -> int:
    if len(argv) in (4, 5) and argv[1] == "--measure":
        measure(argv[2], argv[3] == "keep", argv[4:] == ["--small"])
        return 0
    small = argv[2:] == ["--small"]
    if len(argv) != 2 and not small:
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
                            "keep" if i < 2 else "times"]
                           + (["--small"] if small else []),
                           env=dict(os.environ, PYTHONPATH=trees[tag]),
                           check=True, timeout=900)
            runs.append(dst)
            t = json.loads(Path(dst + ".json").read_text())
            times[tag].append(t)
            print(f"{tag} ({trees[tag]}): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in t.items()))
        this, other = torch.load(runs[0]), torch.load(runs[1])
    for key in times["this"][0]:
        a = statistics.mean(t[key] for t in times["this"])
        b = statistics.mean(t[key] for t in times["other"])
        print(f"{key}: this {a:.4f} ms, other {b:.4f} ms, speed-up "
              f"{b / a:.2f}x")
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
