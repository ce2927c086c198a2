"""Build the port's CUDA kernels and load them with ctypes.

Every `*.cu` source of this directory is compiled by nvcc, all at once in
parallel, into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused. Nothing is built at import
time: the first wrapper call on a CUDA tensor builds what is missing. A
failed build raises with the compiler's output; there is no fallback.

A build holds an exclusive `fcntl` lock on `build/build.lock` and looks
again for each library once it has the lock, so processes that start
together on a cold checkout (the serve daemon's workers) run nvcc once per
source.

The libraries are the port's counterpart of the JAX package's executable
cache (mythril_tpu/parallel/exec_cache.py, which persists a compiled
solver runner per clause-shape bucket). The port has one compile, this
build, once for every shape; the hash in a library's name is the entry
key's program fingerprint, and there is no second copy and no
serialization step. The JAX metrics read here as:

* ``cache.exec.hits`` — a library this process loaded from disk, built by
  an earlier process;
* ``cache.exec.misses`` — a library nvcc had to build for this process;
* ``cache.exec.deserialize_ms`` — the time to load one (``ctypes.CDLL``).

The JAX switch MYTHRIL_TPU_EXEC_CACHE=0 has no counterpart: a library on
disk is never rebuilt, so there is nothing for it to turn off; nor has
MYTHRIL_TPU_EXEC_CACHE_DIR: the libraries live beside their sources."""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "build")
SOURCES = ("keccak", "evm_step", "arena_alloc", "sym_step", "frontier_summary",
           "pack_rows", "gather_rows", "arena_delta", "merge_pass", "sat_step",
           "steal_pass")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}

#: the libraries nvcc built for this process (their loads are no hits)
_BUILT: set = set()


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
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        built = _build_missing(paths, extra_flags)
    if built and not extra_flags:
        from ..observe import metrics

        _BUILT.update(built)
        metrics.inc("cache.exec.misses", len(built))
    return paths


def _build_missing(paths: Dict[str, str], extra_flags: List[str]) -> List[str]:
    """Run nvcc for every library of `paths` not on disk (under the build
    lock); returns the names it built."""
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
    return list(procs)


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Compile one source to a cubin with `-Xptxas -v` and return, per
    function (mangled name), its registers, stack frame and spill bytes as
    ptxas reports them."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}.{os.getpid()}.cubin")
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([nvcc_path(), *flags, "-cubin", "-Xptxas", "-v",
                           "-o", out, os.path.join(KERNEL_DIR, f"{name}.cu")],
                          capture_output=True, text=True, check=False)
    if os.path.exists(out):
        os.remove(out)
    if proc.returncode != 0:
        raise RuntimeError(f"ptxas report of {name}.cu failed:\n{proc.stderr}")
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in (proc.stdout + proc.stderr).splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?",
                          line)
        if found:
            current = report.setdefault(found.group(1), {})
            continue
        if current is None:
            continue
        for key, pattern in (("stack_frame", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
            value = re.search(pattern, line)
            if value:
                current[key] = int(value.group(1))
    return report


def stats() -> Dict[str, int]:
    """The libraries this process found built and had built (the serve
    worker's ready event, the warm set's status)."""
    from ..observe import metrics

    return {"hits": int(metrics.value("cache.exec.hits")),
            "misses": int(metrics.value("cache.exec.misses"))}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all missing ones first."""
    if name not in _LIBS:
        from ..observe import metrics

        path = library_path(name)
        if not os.path.exists(path):
            build_all()
        started = time.perf_counter()
        _LIBS[name] = ctypes.CDLL(path)
        metrics.observe("cache.exec.deserialize_ms",
                        (time.perf_counter() - started) * 1000.0)
        if name not in _BUILT:
            metrics.inc("cache.exec.hits")
    return _LIBS[name]
