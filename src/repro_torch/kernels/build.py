"""nvcc build of the port's CUDA kernels into ctypes-loadable libraries.

No reference counterpart: the JAX package's Pallas kernels compile
inside ``jax.jit``.  Each ``csrc/*.cu`` source has a plain C interface
and is compiled on first use, with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` (Hopper; ``sm_90a`` for ``wgmma`` and
``setmaxnreg``), into ``build/kernels/`` at the root of the checkout,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  ``build_all`` starts
one ``nvcc`` per missing library, all at once.  Nothing here runs at
import: this module is imported on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"nm_spmm": "nm_spmm.cu", "fused_update": "fused_update.cu",
           "grad_compress": "grad_compress.cu", "nm_compact": "nm_compact.cu",
           "nm_spmm_shared": "nm_spmm_shared.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc_path() -> str:
    """The toolkit's nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    parts = [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=None) -> dict:
    """Compile each named kernel library (default: all) that is not built
    yet, one ``nvcc`` process per source, all started together.

    Returns ``{name: {"seconds": wall time, "log": nvcc's output}}`` for
    the libraries it built.  Raises if any compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)   # atomic: a concurrent loader sees all or nothing
        done[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
