"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel source exports a plain-C launcher (``extern "C"``), so it
compiles in seconds without PyTorch's headers.  The shared library is
built at first use for Hopper (``sm_90a``) into ``repro_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads at once.  The
compiler's output is kept beside the library (``.log``), so a cached
load reports it too.  A failed build raises with the compiler's output;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# --fmad=false: no multiply-add contraction, so a kernel rounds like the
# plain PyTorch version it is held against; -Xptxas -v reports each
# kernel's registers, shared memory and spills into the build log
FLAGS = ("-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v")
# for a kernel held to a tolerance rather than bit for bit: multiply-adds
# contract into FMAs, at twice the rate of a multiply and an add
FMA_FLAGS = tuple(f for f in FLAGS if f != "--fmad=false")

# kernel name → nvcc's output of the build this process loaded
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``,
    else the toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return path


def load(name: str, source: str, flags: tuple = FLAGS) -> ctypes.CDLL:
    """Build ``source`` with nvcc ``flags`` (once per content and flags),
    load the library and record nvcc's output in :data:`BUILD_LOG`."""
    with open(source, "rb") as f:
        text = f.read()
    key = hashlib.sha256(text + " ".join(ARCH + flags).encode()
                         ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    if not (os.path.exists(out) and os.path.exists(f"{out}.log")):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *ARCH, *flags, "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source} "
                               f"(exit {res.returncode}):\n{res.stderr}")
        with open(f"{tmp}.log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(f"{tmp}.log", f"{out}.log")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    with open(f"{out}.log") as f:
        BUILD_LOG[name] = f.read()
    return ctypes.CDLL(out)
