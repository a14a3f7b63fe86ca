"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on first
use into `build/veloslam_tpu_torch/<name>-<hash>.so` at the repository
root, named by a hash of its source and the compiler flags, so an edited
source rebuilds and an unchanged one loads the cached library.  Without
nvcc, or when the build fails, this raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "veloslam_tpu_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


class KernelBuildError(RuntimeError):
    """A compiler (nvcc for the kernels, g++ for the packet pump) is
    missing or refused a source."""


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise KernelBuildError(
        f"nvcc not found (searched PATH and {DEFAULT_NVCC.parent}): the "
        "port's CUDA kernels are compiled on first use and need the CUDA "
        "toolkit")


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>.cu` lives (hash of source + flags)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its build exists; returns the .so.
    The compiler's output (register and shared-memory use per kernel)
    is kept beside it as `<so>.log`."""
    out = library_path(name)
    if out.is_file():
        return out
    return compile_shared([find_nvcc(), *NVCC_FLAGS,
                           str(CSRC_DIR / f"{name}.cu")], out)


def compile_shared(cmd: list, out: Path) -> Path:
    """Run the compiler command `cmd` with `-o` a temporary file beside
    `out`, then move it to `out` (atomic: concurrent builds agree);
    the compiler's output is kept as `<out>.log`.  Raises
    KernelBuildError when the compiler fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"{Path(cmd[0]).name} failed on {Path(cmd[-1]).name} (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
