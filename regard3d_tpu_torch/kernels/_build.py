"""Build the CUDA sources of ``regard3d_tpu_torch/csrc`` with nvcc at first use.

Each ``.cu`` file becomes a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go
to :func:`runtime.kernel_build_dir` under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and concurrent builders
never read a half-written file (write to a temporary name, then rename).
``compile_library`` does the same for any compiler (``native.py``'s g++).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

from regard3d_tpu_torch import runtime

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(src: str, flags) -> str:
    """Where the library of source file ``src`` built with ``flags`` goes:
    its name hashes both."""
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(runtime.kernel_build_dir(),
                        f"lib{stem}_{h.hexdigest()[:12]}.so")


def compile_library(compiler: str, flags, src: str) -> str:
    """Compile ``src`` with ``compiler`` and ``flags`` into a shared library
    unless it exists; returns its path. Raises with the compiler's output
    if the build fails."""
    out = library_path(src, flags)
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    r = subprocess.run([compiler, *flags, "-o", tmp, src],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed on {src}:\n"
                           f"{r.stdout}")
    os.replace(tmp, out)
    return out


def _lib_path(source: str) -> str:
    return library_path(os.path.join(CSRC, source), NVCC_FLAGS)


def build(source: str) -> str:
    """Compile ``csrc/<source>`` with nvcc unless its library exists;
    returns the library's path."""
    out = _lib_path(source)
    if os.path.exists(out):         # built: no toolkit needed to load it
        return out
    return compile_library(nvcc_path(), NVCC_FLAGS,
                           os.path.join(CSRC, source))


def hmma_counts(lib_path: str) -> Dict[str, int]:
    """Tensor-core instructions (HMMA) per instance of the bf16 matcher
    kernel in a built library, keyed by its template arguments
    (``"<mode>,<D or 0>"``), from the SASS that ``cuobjdump`` prints."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300, check=True)
    out = {}
    for part in r.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "l2_top2_mma_kernel" in name:
            args = name.split("l2_top2_mma_kernelI", 1)[1].split("EEE", 1)[0]
            mode, dc = (a.lstrip("Li") for a in args.split("E"))
            out[f"{mode},{dc}"] = part.count("HMMA")
    return out


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = _LIBS[source] = ctypes.CDLL(build(source))
    return lib
