"""Build the port's CUDA kernels and load them with ctypes.

Every kernel lives in one source, ``aphrodite_tpu_torch/csrc/<name>.cu``,
with a plain C interface. ``nvcc`` compiles each source for sm_90a into
its own shared library under ``build/kernels/`` at the repository root
(listed in .gitignore), named by a hash of the source and of the headers
beside it (``csrc/*.cuh``) so an edited kernel is never served from a
stale build. Nothing is built when a module is
imported: the first launch builds what it needs, and ``build`` builds
several sources at once, one ``nvcc`` process each, all started together.

    python -m aphrodite_tpu_torch.ops.cuda_build NAME [NAME ...]

compiles the named sources once more with ``-Xptxas -v`` and prints what
ptxas reports for each kernel instantiation: registers, shared memory,
spills.
"""

import argparse
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
KERNEL_SOURCES = ("paged_decode_attention", "paged_decode_attention_rel",
                  "ragged_paged_attention",
                  "ragged_paged_attention_alibi",
                  "ragged_paged_attention_blocksparse", "int4p_matmul",
                  "int4_matmul", "int4p_matmul_w4a8", "gather_probe")
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
        # nvcc's output goes to a file, so that each compile's own time is
        # taken when it ends (a pipe read in turn would time them all by
        # the slowest before them).
        log = open(tmp.with_suffix(".log"), "w+")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, log, tmp, target, time.monotonic())
    failures = []
    while running:
        for name, (proc, log, tmp, target, t0) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds[name] = time.monotonic() - t0
            del running[name]
            log.seek(0)
            output = log.read()
            log.close()
            os.unlink(log.name)
            if proc.returncode != 0:
                failures.append(
                    f"{name}.cu (exit {proc.returncode}):\n{output}")
                continue
            os.replace(tmp, target)
        time.sleep(0.05)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def ptxas_report(name: str) -> str:
    """What ptxas says (-v) for every kernel of ``csrc/<name>.cu``, one
    line per kernel: its mangled name, then registers, shared memory and
    spills; and its warnings (wgmma serialization among them). The library
    built here is thrown away."""
    target = BUILD_DIR / f"{name}.ptxas.{os.getpid()}.tmp"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(target),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    target.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    lines, kernel = [], None
    for line in proc.stdout.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif kernel and ("Used" in line or "spill" in line):
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        elif "warning" in line or "Performance Loss" in line:
            lines.append(line.strip())
    return "\n".join(lines)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Print ptxas -v for sources of csrc/ (registers, shared "
                    "memory, spills of each kernel).")
    parser.add_argument("names", nargs="+", metavar="NAME")
    for name in parser.parse_args().names:
        print(f"== {name}.cu", flush=True)
        print(ptxas_report(name), flush=True)


if __name__ == "__main__":
    main()
