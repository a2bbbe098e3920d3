"""Compile ``csrc/*.cu`` with nvcc for Hopper and bind it with ctypes.

Each source is a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries land in the
repository's ``build/kernels/`` (git-ignored), named by a hash of the
source and of the shared headers (``csrc/*.cuh``), and are built on first
use: a checkout needs nothing prebuilt.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # included sources
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Tuple[Path, Optional[subprocess.Popen], Path]:
    out = library_path(name)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc each,
    all started together.  Returns each compiler's output (register and
    shared-memory use from ``-Xptxas -v``); raises if any build fails."""
    started = [(n, *_start(n)) for n in names]
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, out, proc, tmp in started:
        if proc is None:
            logs[name] = f"{out.name}: already built"
            continue
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, Tuple[list, object]]
            ) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use),
    with ``argtypes``/``restype`` set from ``signatures``."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
