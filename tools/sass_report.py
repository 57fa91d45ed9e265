"""What the compiler made of a kernel source: per entry function its
registers, spills and shared memory (``nvcc -Xptxas -v``) and its count
of tensor-core instructions (``HGMMA``, ``HMMA``) in the SASS
(``cuobjdump -sass``), compiled with the flags of the port's build
(``repro_torch.kernels._build.NVCC_FLAGS``).  Needs the CUDA toolkit.

    python3 tools/sass_report.py src/repro_torch/csrc/mx_gemm.cu
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = Path(argv[1]).resolve()
    nvcc = _build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "k.o"
        ptxas = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-c", str(src), "-o", str(obj)],
            capture_output=True, text=True, check=True).stderr
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
            capture_output=True, text=True, check=True).stdout
    entry = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("spill" in line or "Used" in line):
            print(f"{entry}: {line.split(':', 1)[-1].strip()}")
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = Counter()
        elif fn:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if op and op.group(1) in ("HGMMA", "HMMA"):
                counts[fn][op.group(1)] += 1
    for fn, c in counts.items():
        print(f"{fn}: SASS {dict(c) or 'no tensor-core instructions'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
