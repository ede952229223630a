"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/aki_torch/lib<name>-<hash>.so``
at the root of the checkout; the hash covers the source, every shared
header ``csrc/*.cuh`` and the flags, so an edited kernel or header is never
served from a stale library. Importing this module builds nothing and
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aki_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its library is already built, and
    return the seconds that took (0 when cached). ``nvcc``'s register and
    spill report goes to ``build/aki_torch/<name>.log``."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(names) -> dict[str, float]:
    """:func:`build` of every name at once, one ``nvcc`` each, all started
    together; returns the seconds each took."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
