"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's example twins (``examples/*_torch.py``) import neither JAX nor
anything of ``repro``, and the port's entry points do
not fall back to the CPU when no card is there."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_CHILD = r"""
import pkgutil, sys, importlib
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.",
                                                                 "jaxlib.",
                                                                 "repro.")))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""


def test_import_pulls_in_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)(?:[.\s,]|$)",
                     re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob(
        "*_torch.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_or_reference(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), (path, _IMPORT.findall(text))
    assert "import jax" not in text and "from jax" not in text


def test_engine_defaults_to_the_card_and_never_falls_back(monkeypatch):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import random_params
    from repro_torch.serving import Engine

    cfg = get_config("phi3-mini-3.8b", smoke=True)
    params = random_params(cfg, 0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, num_slots=1, max_len=32)


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor on a device that is neither the CPU nor CUDA is refused,
    never computed on the CPU behind the caller's back."""
    from repro_torch.kernels import mx_gemm

    qx = torch.zeros((2, 32), dtype=torch.float8_e4m3fn, device="meta")
    se = torch.zeros((2, 1), dtype=torch.int8, device="meta")
    qw = torch.zeros((32, 4), dtype=torch.float8_e4m3fn, device="meta")
    with pytest.raises(ValueError, match="devices"):
        mx_gemm.mx_gemm(qx, se, qw)
    out = mx_gemm.mx_gemm(torch.zeros((2, 32)).to(torch.float8_e4m3fn),
                          torch.zeros((2, 1), dtype=torch.int8),
                          torch.ones((32, 4)).to(torch.float8_e4m3fn))
    np.testing.assert_array_equal(out.numpy(), np.zeros((2, 4)))


def test_bridge_and_init_default_to_the_card():
    """The weight bridge and the initializers put tensors on the card
    unless the caller names another device, like the entry points:
    without a card they raise, and never land on the CPU unasked."""
    import inspect

    from repro_torch import bridge
    from repro_torch.models import layers

    for fn in (bridge.to_torch, bridge.tree_to_torch,
               bridge.act_scales_to_torch, bridge.train_state_to_torch,
               layers.init_param, layers.init_tree):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__name__
    x = np.ones(3, np.float32)
    if torch.cuda.is_available():
        assert bridge.to_torch(x).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            bridge.to_torch(x)
    assert bridge.to_torch(x, device="cpu").device.type == "cpu"
