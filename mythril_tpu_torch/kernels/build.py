"""Build the port's CUDA kernels and load them with ctypes.

Every `*.cu` source of this directory is compiled by nvcc, all at once in
parallel, into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused. Nothing is built at import
time: the first wrapper call on a CUDA tensor builds what is missing. A
failed build raises with the compiler's output; there is no fallback."""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "build")
SOURCES = ("keccak", "evm_step", "arena_alloc", "sym_step", "frontier_summary",
           "pack_rows", "gather_rows", "arena_delta", "merge_pass", "sat_step")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for candidate in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                      "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str, extra_flags: List[str]) -> str:
    sha = hashlib.sha256(" ".join(NVCC_FLAGS + extra_flags).encode())
    paths = [os.path.join(KERNEL_DIR, f"{name}.cu")]
    paths += sorted(glob.glob(os.path.join(KERNEL_DIR, "*.cuh")))
    for path in paths:
        with open(path, "rb") as handle:
            sha.update(handle.read())
    return sha.hexdigest()[:16]


def library_path(name: str, extra_flags: Optional[List[str]] = None) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name, extra_flags or [])}.so")


def build_all(extra_flags: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {name: library path} and, when
    `extra_flags` asks for it (e.g. ["-Xptxas", "-v"]), prints the
    compiler's report."""
    extra_flags = list(extra_flags or [])
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name, extra_flags) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
               os.path.join(KERNEL_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{output}")
            continue
        if output.strip() and extra_flags:
            print(f"--- {name}.cu\n{output}", flush=True)
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all missing ones first."""
    if name not in _LIBS:
        path = library_path(name)
        if not os.path.exists(path):
            build_all()
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]
