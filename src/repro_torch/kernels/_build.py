"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source file is compiled on its own by ``nvcc`` into a shared library
with a plain C interface for Hopper (``sm_90a``) and loaded with
``ctypes``. Libraries land in ``<repo>/build/repro_torch/`` under a name
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. A missing ``nvcc``, a
compile error or a load error raises: no caller falls back to the plain
PyTorch version.

:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for all of them; :func:`load` builds one library if needed and
returns the loaded handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels of repro_torch cannot be built"
    )


def _library_path(name: str) -> Path:
    """``BUILD_DIR/lib<name>-<hash of source + flags>.so``."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, in parallel.

    Returns ``{name: library path}``. Raises ``RuntimeError`` with the
    compiler's output if any ``nvcc`` fails.
    """
    paths = {name: _library_path(name) for name in names}
    missing = {n: p for n, p in paths.items() if not p.is_file()}
    if not missing:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in missing.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, missing[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            _loaded[name] = lib
        return lib
