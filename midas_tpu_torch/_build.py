"""Where the port's native code is compiled to.

Both native pieces — the FASTQ reader (io/_native/midas_io.cpp, built
with g++) and the CUDA kernels (csrc/*.cu, built with nvcc) — compile
from the sources in the checkout on first use, into `build/` at the
root of the checkout (listed in .gitignore). Nothing is written outside
the checkout.
"""

from __future__ import annotations

import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.path.join(os.path.dirname(PACKAGE_DIR), "build")
    os.makedirs(d, exist_ok=True)
    return d
