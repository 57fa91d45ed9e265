"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled for ``sm_90a`` with ``nvcc`` (one
process per source, all started together), linked into one shared
library and loaded with ``ctypes``.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, the
hash covering the sources and the flags, so an edited source builds
anew.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.

No ``--use_fast_math`` and no ``-ftz=true``: see ``csrc/common.cuh``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_LONG = ctypes.c_longlong

# C entry points and their argument types (every one returns the
# cudaGetLastError() code of its launch)
SIGNATURES = {
    "mx_gemm_launch": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
                       _INT, _INT, _INT, _VOID],
    "mx_gemm_tiled_launch": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                             _INT, _INT, _INT, _VOID],
    "dw_requant_launch": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT,
                          _INT, _INT, _INT, _FLOAT, _FLOAT, _VOID],
    "mx_dw_gemm_launch": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                          _INT, _INT, _INT, _VOID],
    "mx_quant_launch": [_VOID, _VOID, _VOID, _VOID, _LONG, _INT, _INT,
                        _FLOAT, _FLOAT, _VOID],
    "global_amax_launch": [_VOID, _LONG, _INT, _VOID, _INT, _VOID, _FLOAT,
                           _VOID],
    "group_gemm_launch": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                          _INT, _INT, _INT, _VOID],
    "moe_gmm_launch": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                       _INT, _INT, _INT, _INT, _VOID],
    "moe_dw_gemm_launch": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT,
                           _INT, _INT, _INT, _INT, _INT, _VOID],
    "decode_attn_paged_launch": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                                 _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
                                 _INT, _INT, _INT, _FLOAT, _INT, _VOID],
    "decode_attn_launch": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                           _VOID, _INT, _INT, _INT, _INT, _INT, _INT, _FLOAT,
                           _INT, _VOID],
}

_LIB: ctypes.CDLL | None = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                 str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for o in objs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


class LaunchCounter:
    """Counts the launches of one kernel.  A wrapper adds one where it
    launches its kernel on the card and nowhere else; the plain
    version, which a CPU tensor takes, does not count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def hit(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0
