"""Build the CUDA sources of ``regard3d_tpu_torch/csrc`` with nvcc at first use.

Each ``.cu`` file becomes a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go
to :func:`runtime.kernel_build_dir` under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and concurrent builders
never read a half-written file (write to a temporary name, then rename).
``compile_library`` does the same for any compiler (``native.py``'s g++)
and keeps the compiler's output beside the library (``<library>.log``):
for nvcc that is ptxas's report of each kernel's registers, spills and
shared memory (``-Xptxas -v``), which :func:`ptxas_usage` reads.
:func:`sass_opcodes` and :func:`hmma_counts` read the built SASS.

It is also the one way a binding calls a kernel. :func:`load_library`
sets each C entry's signature from ``SIGNATURES``. A binding's ``prepare``
checks its tensors with :func:`check` (shapes, dtypes, contiguity, then
one card), allocates outputs and workspace and returns a :class:`Call`;
:func:`launch` makes the C call, raises on a ``cudaError`` and counts the
launch in ``LAUNCHES``. ``Call.c_call`` is the C call alone, which the
tools time.
"""

from __future__ import annotations

import ctypes
import hashlib
import collections
import importlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Any, Dict, NamedTuple, Optional

import torch

from regard3d_tpu_torch import runtime

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# the extern "C" entries of each source, (restype, argtypes) by name, set on
# every library built from a source of that file name when it is loaded; a
# string names a ctypes.Structure of a binding, passed by pointer
SIGNATURES = {
    "match_top2.cu": {
        "r3d_l2_top2": (_I, [_I] * 2 + [_P] * 4 + [_I] * 5 + [_P] * 4),
        "r3d_l2_top2_pair_workspace": (_L, [_I] * 4),
        "r3d_l2_top2_pair": (_I, [_I] * 2 + [_P] * 3 + [_I] * 4
                             + [_P] * 5),
        "r3d_l2_top2_clusters": (_I, [_I] * 3 + [ctypes.POINTER(_I)]),
    },
    "essential5.cu": {
        "r3d_e_sweep_workspace": (_L, [_I] * 3),
        "r3d_e_sweep": (_I, [_I] * 2 + [_P] * 5 + [_I] * 3 + [_P] * 6),
        "r3d_e_solve": (_I, [_I] * 2 + [_P] * 2 + [_I] + [_P] * 5),
    },
    "schur_pcg.cu": {
        "r3d_schur_pcg_workspace": (_L, [_I, "schur_pcg._Args"]),
        "r3d_schur_pcg": (_I, [_I, _I, "schur_pcg._Args", _P]),
    },
    "ba_linearize.cu": {
        f"r3d_ba_{entry}{part}": sig
        for entry in ("linearize", "cost")
        for part, sig in (("_workspace", (_L, [_I, "ba_linearize._Args"])),
                          ("", (_I, [_I, _I, "ba_linearize._Args", _P])))
    },
}

# C calls of the kernels by entry and dtype: plain integers that callers
# read before and after to show a run went through a kernel. A call counts
# once, however many kernels it launches.
LAUNCHES: Dict[str, int] = dict.fromkeys(
    [f"l2_top2{w}_{t}" for w in ("_block", "") for t in ("f32", "bf16")]
    + [f"l2_top2_block_{m}_bf16" for m in ("mm_only", "min_only")]
    + [f"{k}_{t}" for k in ("e_sweep", "e_solve", "schur_pcg",
                            "ba_linearize", "ba_cost")
       for t in ("f32", "f64")], 0)


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


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_bytes(src: str) -> bytes:
    """The bytes of ``src`` and of each header beside it that it includes
    (``#include "name"``), recursively."""
    with open(src, "rb") as f:
        text = f.read()
    for name in _INCLUDE.findall(text):
        header = os.path.join(os.path.dirname(src), name.decode())
        if os.path.exists(header):
            text += _source_bytes(header)
    return text


def library_path(src: str, flags) -> str:
    """Where the library of source file ``src`` built with ``flags`` goes:
    its name hashes both, and the headers the source includes."""
    h = hashlib.sha1(_source_bytes(src) + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(runtime.kernel_build_dir(),
                        f"lib{stem}_{h.hexdigest()[:12]}.so")


def compile_library(compiler: str, flags, src: str) -> str:
    """Compile ``src`` with ``compiler`` and ``flags`` into a shared library
    unless it exists; returns its path. The compiler's output goes to
    ``<library>.log``. Raises with that output if the build fails."""
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
    with open(tmp + ".log", "w") as f:
        f.write(r.stdout)
    os.replace(tmp + ".log", out + ".log")
    os.replace(tmp, out)
    return out


def build_log(lib_path: str) -> str:
    """The compiler's output when ``lib_path`` was built ("" if none was
    kept)."""
    try:
        with open(lib_path + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


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


def short_name(mangled: str) -> str:
    """``l2_top2_wgmma_kernel<0,144,4>`` for the mangled name of a kernel
    (template arguments integers, or one of float / double:
    ``e_sweep_kernel<float>``); the mangled name if it names no
    ``*_kernel``. Of the length-prefixed names that end in ``_kernel`` the
    last one is the kernel's (a hash's digits can spell a longer one)."""
    best = None
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):     # a length ends the digits
            n = int(mangled[i:m.end()])
            name = mangled[m.end():m.end() + n]
            if (len(name) == n and name.endswith("_kernel")
                    and not name[0].isdigit()):
                best = (m.end(), name)
    if best is None:
        return mangled
    end, name = best
    rest = mangled[end + len(name):]
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    args = re.findall(r"Li(-?\d+)E", args[1]) if args else []
    if not args and re.match(r"I[fd]E", rest):     # one float type argument
        args = ["float" if rest[1] == "f" else "double"]
    return name + (f"<{','.join(args)}>" if args else "")


def _sass(lib_path: str) -> str:
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300, check=True)
    return r.stdout


_SASS_OP = re.compile(r"^\s*(?:/\*[0-9a-f]+\*/)?\s*(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)[.\s;]")


def sass_opcodes(lib_path: str) -> Dict[str, Dict[str, int]]:
    """Instruction counts per kernel in a built library, keyed by
    :func:`short_name`, each a dict of base opcode (``FFMA``, ``HGMMA``,
    ``LDS``...) to its count in the SASS ``cuobjdump`` prints."""
    out = {}
    for part in _sass(lib_path).split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        ops = collections.Counter(
            m.group(1) for m in map(_SASS_OP.match, body.splitlines()) if m)
        out[short_name(name.strip())] = dict(ops)
    return out


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, spills and memory per kernel from ptxas's ``-v`` report
    (:func:`build_log`), keyed by :func:`short_name`: ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes), ``stack`` (bytes),
    ``smem`` (static shared bytes)."""
    out: Dict[str, Dict[str, int]] = {}
    cur: Optional[Dict[str, int]] = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(short_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def hmma_counts(lib_path: str) -> Dict[str, int]:
    """Tensor-core instructions (``HMMA`` of ``mma.sync``, ``HGMMA`` of
    ``wgmma``) per instance of the bf16 matcher kernel in a built library
    (``l2_top2_mma_kernel`` or ``l2_top2_wgmma_kernel``), keyed by its
    template arguments (``"<mode>,<D or 0>"``), from the SASS that
    ``cuobjdump`` prints."""
    out = {}
    for part in _sass(lib_path).split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        m = re.search(r"l2_top2_(?:wg)?mma_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            out[f"{m.group(1)},{m.group(2)}"] = (part.count("HMMA")
                                                 + part.count("HGMMA"))
    return out


def _argtype(a):
    if isinstance(a, str):
        module, name = a.split(".")
        return ctypes.POINTER(getattr(importlib.import_module(
            f"regard3d_tpu_torch.kernels.{module}"), name))
    return a


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, or of the CUDA source file
    at the path ``source``, built first if needed, with the signatures of
    ``SIGNATURES`` set on its entries."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(compile_library(nvcc_path(), NVCC_FLAGS, source)
                          if os.sep in source else build(source))
        for name, (res, args) in SIGNATURES[os.path.basename(source)].items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, [_argtype(a) for a in args]
        _LIBS[source] = lib
    return lib


def _dtype_names(dtypes) -> str:
    return " or ".join(str(d).replace("torch.", "") for d in dtypes)


def check(**want) -> torch.device:
    """Hold each tensor to what a C entry takes: ``name=(tensor, shape,
    dtype)``, ``shape`` a tuple of sizes (a string names a size that must
    be the same wherever it appears) or None, ``dtype`` one dtype or a
    tuple of those allowed. Each tensor in turn: its shape, its dtype,
    contiguous; then all of them on one card, the first one's, which is
    returned. Raises ValueError naming the first argument that is wrong
    and why."""
    sizes: Dict[str, int] = {}
    for name, (t, shape, dtype) in want.items():
        if shape is not None:
            full = tuple(sizes.setdefault(d, n) if isinstance(d, str) else d
                         for d, n in zip(shape, t.shape))
            if len(shape) != t.dim() or full != tuple(t.shape):
                wanted = ", ".join(str(sizes.get(d, d)) for d in shape)
                raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                                 f"({wanted})")
        dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.dtype not in dtypes:
            raise ValueError(f"{name} is {_dtype_names((t.dtype,))}, want "
                             f"{_dtype_names(dtypes)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    first, (t0, _, _) = next(iter(want.items()))
    dev = t0.device
    for name, (t, _, _) in want.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {first}'s "
                             f"card, got {t.device}")
    return dev


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current stream, a C call's last argument."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


class Call(NamedTuple):
    """One prepared C call: ``entry(*args)``, the stream its last argument;
    ``keep`` the tensors it reads or writes that must outlive it (the
    arguments hold only their addresses); ``out`` what it returns to the
    caller; ``key`` its count in ``LAUNCHES``."""
    entry: Any
    args: tuple
    keep: tuple
    out: Any
    key: str

    def c_call(self) -> int:
        """The C call alone (for timing): its cudaError_t, unchecked."""
        return self.entry(*self.args)


def call_entry(entry, *args) -> None:
    """``entry(*args)`` of a C entry that returns a cudaError_t; raises
    RuntimeError naming the entry and the error unless it is 0."""
    err = entry(*args)
    if err != 0:
        raise RuntimeError(f"{entry.__name__} failed (cudaError {err})")


def launch(call: Call):
    """Make ``call``'s C call, count it in ``LAUNCHES`` and return its
    outputs; raises RuntimeError if the launch fails (nothing counted)."""
    call_entry(call.entry, *call.args)
    LAUNCHES[call.key] += 1
    return call.out
