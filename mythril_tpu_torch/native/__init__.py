"""Build the port's copy of the native CDCL core (`cdcl.cpp`) for ctypes.

    g++ -O2 -fPIC -shared -std=c++17 -o build/libmythril_cdcl-<hash>.so cdcl.cpp

The library's name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is built
at import time: the first solve builds what is missing. Several processes
may reach that first build together (test workers), so it runs under an
`fcntl` lock and lands in a temporary file that is renamed into place. A
failed build raises with the compiler's output; nothing falls back to the
pure-Python DPLL in its place."""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
SOURCE = os.path.join(NATIVE_DIR, "cdcl.cpp")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]


class NativeBuildError(RuntimeError):
    """The compiler did not build the CDCL library; the message holds its
    output."""


def _digest(source: str) -> str:
    sha = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as handle:
        sha.update(handle.read())
    return sha.hexdigest()[:16]


def library_path(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    return os.path.join(build_dir, f"libmythril_cdcl-{_digest(source)}.so")


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """The path of the built library, compiling it first if it is missing."""
    path = library_path(source, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it while we waited
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        command = ["g++", *CXX_FLAGS, "-o", tmp, source]
        try:
            proc = subprocess.run(command, capture_output=True, text=True,
                                  timeout=600, check=False)
        except (OSError, subprocess.SubprocessError) as error:
            raise NativeBuildError(f"{' '.join(command)}: {error}") from error
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise NativeBuildError(
                f"{' '.join(command)} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path
