"""The port's twins of the reference's user examples, run on the CPU at
a tiny size: ``examples/quickstart_torch.py`` (two-level quantization,
the MOSS GEMM through ``kernels.ops.moss_linear``, automatic scaling)
and ``examples/pretrain_moss_vs_bf16_torch.py`` (paper Fig. 5: bf16 and
moss loss curves from one seed).  Each must run to its end with finite
numbers; the GEMM's error against the exact product is the reference
example's (~0.037 on its input), held within 0.05."""

import importlib.util
import math
from pathlib import Path

import numpy as np

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
