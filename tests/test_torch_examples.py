"""The port's twins of the reference's user examples, run on the CPU at
a tiny size: ``examples/quickstart_torch.py`` (two-level quantization,
the MOSS GEMM through ``kernels.ops.moss_linear``, automatic scaling)
``examples/pretrain_moss_vs_bf16_torch.py`` (paper Fig. 5: bf16 and
moss loss curves from one seed) and ``examples/serve_batched_torch.py``
(the paged engine, then a wave sharing a system prompt through the
prefix cache) and ``examples/multiarch_smoke_torch.py`` (one moss step
on an arch's smoke config).  Each must run to its end with finite numbers; the GEMM's
error against the exact product is the reference example's (~0.037 on
its input), held within 0.05, and the serving wave's prefix-cache
counts are the reference example's."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_runs_on_the_cpu(capsys):
    rel = _load("quickstart_torch").main(["--device", "cpu"], m=64, k=256,
                                          n=64)
    out = capsys.readouterr().out
    assert math.isfinite(rel) and rel < 0.05, rel
    assert out.count("y finite=True") == 3, out
    assert "import jax" not in (EXAMPLES / "quickstart_torch.py").read_text()


def test_pretrain_twin_prints_two_finite_curves(capsys):
    curves = _load("pretrain_moss_vs_bf16_torch").main(
        ["--device", "cpu", "--steps", "3", "--d-model", "64",
         "--layers", "1", "--batch", "2", "--seq", "32", "--every", "1"])
    out = capsys.readouterr().out
    assert sorted(curves) == ["bf16", "moss"]
    for c in curves.values():
        assert c.shape == (3,) and np.isfinite(c).all(), c
    assert out.count("[moss] step") == 3 and "final loss: bf16" in out


def test_serve_batched_twin_shares_the_system_prompt(capsys):
    s = _load("serve_batched_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert s["prefix_hits"] == 5 and s["prefill_tokens_skipped"] == 5 * 32
    assert s["requests"] == 16 and s["preemptions"] == 0
    assert "prefix hits 5/6" in out
    assert "import jax" not in (EXAMPLES / "serve_batched_torch.py"
                                ).read_text()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "musicgen-medium"])
def test_multiarch_twin_trains_a_step(capsys, arch):
    """``examples/multiarch_smoke_torch.py --arch <id> --steps 1`` on the
    CPU: rwkv6 (attention-free) and musicgen (embeddings input through
    the frontend stub) each take a finite moss step."""
    losses = _load("multiarch_smoke_torch").main(
        ["--device", "cpu", "--arch", arch, "--steps", "1"])
    assert list(losses) == [arch] and len(losses[arch]) == 1
    assert math.isfinite(losses[arch][0]), losses
    assert f"{arch}" in capsys.readouterr().out
    assert "import jax" not in (EXAMPLES / "multiarch_smoke_torch.py"
                                ).read_text()
