"""Build the port's CUDA kernels and load them with ctypes.

Every kernel lives in one source, ``aphrodite_tpu_torch/csrc/<name>.cu``,
with a plain C interface. ``nvcc`` compiles each source for sm_90a into
its own shared library under ``build/kernels/`` at the repository root
(listed in .gitignore), named by a hash of the source and of the headers
beside it (``csrc/*.cuh``) so an edited kernel is never served from a
stale build. Nothing is built when a module is
imported: the first launch builds what it needs, and ``build`` builds
several sources at once, one ``nvcc`` process each, all started together.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("paged_decode_attention", "ragged_paged_attention",
                  "int4p_matmul", "int4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin); the port's "
            "CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    sha = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{sha.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every listed source whose library is missing, in parallel.

    Returns the seconds each compile took (0.0 for a library already
    built). Raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds: Dict[str, float] = {}
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.monotonic())
    failures = []
    for name, (proc, tmp, target, t0) in running.items():
        output, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
