"""The port's build report: what ptxas and the SASS say of each kernel.

``kernels/_build`` keeps nvcc's output beside each library and reads
ptxas's ``-v`` report (registers, spills, shared memory per kernel) and
the SASS that ``cuobjdump`` prints; ``tools/kernel_report`` groups the
instruction mix. ``chip_smoke.py`` phase (a) prints both on the card and
fails if the f32 kernel spills; these tests hold the parsers to text in
the tools' formats. No compiler or card is needed.
"""

import os
import stat
import subprocess

import pytest
import torch

from regard3d_tpu_torch.kernels import _build
from regard3d_tpu_torch.tools import kernel_report

NS = "_ZN46_GLOBAL__N__2f944eac_13_match_top2_cu_3c5d19aa"
WGMMA = (NS + "20l2_top2_wgmma_kernelILi0ELi144ELi4EEEv14CUtensorMap_stS1_"
         "S1_S1_PK13__nv_bfloat16PKfPKiiiiiPfPiS9_S9_i")
F32 = NS + "18l2_top2_f32_kernelE14CUtensorMap_stS1_PKfS3_PKiiiiiPfPiS6_S6_"
MERGE = NS + "19merge_splits_kernelEPKfixPfPiS2_"


@pytest.mark.parametrize("mangled,want", [
    (WGMMA, "l2_top2_wgmma_kernel<0,144,4>"),
    (NS + "18l2_top2_mma_kernelILi2ELi0EEEvPK13__nv_bfloat16S3_PKfPKiiiiiPf"
     "PiS8_S8_i", "l2_top2_mma_kernel<2,0>"),
    (F32, "l2_top2_f32_kernel"),
    (MERGE, "merge_splits_kernel"),
    # a hash that ends in digits, glued to the name's length
    ("_ZN46_GLOBAL__N__2f944eac_13_match_top2_cu_3c5d1918l2_top2_mma_"
     "kernelILi1ELi144EEEv", "l2_top2_mma_kernel<1,144>"),
    # a hash whose digits spell a length reaching the kernel's name
    ("_ZN38_GLOBAL__N__a2b7e140_8_f32v1_cu_3c5d19aa18l2_top2_f32_kernelEv",
     "l2_top2_f32_kernel"),
    ("_Z3foov", "_Z3foov"),
    # the E sweep's instances: one floating-point type argument
    ("_ZN2e514e_sweep_kernelIfEEvPKT_S3_PKbS3_PKxiiS3_PKfNS_4WorkIS1_EE",
     "e_sweep_kernel<float>"),
    ("_ZN2e515e_select_kernelIdEEvNS_4WorkIT_EEiPS2_Pb",
     "e_select_kernel<double>"),
], ids=["wgmma", "mma", "f32", "merge", "glued_digits", "hash_digits",
        "no_kernel", "float_arg", "double_arg"])
def test_short_name(mangled, want):
    assert _build.short_name(mangled) == want


PTXAS_LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{WGMMA}' for 'sm_90a'
ptxas info    : Function properties for {WGMMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compile time = 120.937 ms
ptxas info    : Compiling entry function '{F32}' for 'sm_90a'
ptxas info    : Function properties for {F32}
    16 bytes stack frame, 112 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '{MERGE}' for 'sm_90a'
ptxas info    : Function properties for {MERGE}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 33792 bytes smem
"""


def test_ptxas_usage_per_kernel():
    got = _build.ptxas_usage(PTXAS_LOG)
    assert got == {
        "l2_top2_wgmma_kernel<0,144,4>": dict(
            stack=0, spill_stores=0, spill_loads=0, registers=168, smem=0),
        "l2_top2_f32_kernel": dict(
            stack=16, spill_stores=112, spill_loads=48, registers=168,
            smem=0),
        "merge_splits_kernel": dict(
            stack=0, spill_stores=0, spill_loads=0, registers=32,
            smem=33792),
    }
    assert _build.ptxas_usage("") == {}


SASS = f"""\
Fatbin elf code:
================
arch = sm_90a

\t\tFunction : {WGMMA}
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;         /* 0x00000a00ff017b82 */
                                                                  /* 0x000fe40000000800 */
        /*0010*/                   WARPGROUP.ARRIVE ;              /* 0x0000000000007990 */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0030*/              @!P0 SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R3+URZ], R4 ;
        /*0040*/               @P1 FMNMX R5, R5, R6, PT ;
        /*0050*/                   FMNMX R7, R7, R8, !PT ;
        /*0060*/                   EXIT ;
\t\tFunction : {MERGE}
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0010*/              @!UP0 BRA 0x70 ;
"""


def test_sass_opcodes_per_kernel(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 0, SASS, ""))
    got = _build.sass_opcodes("lib.so")
    assert got == {
        "l2_top2_wgmma_kernel<0,144,4>": {
            "LDC": 1, "WARPGROUP": 1, "HGMMA": 1, "SYNCS": 1, "FMNMX": 2,
            "EXIT": 1},
        "merge_splits_kernel": {"LDG": 1, "BRA": 1},
    }
    mix = kernel_report.mix(got["l2_top2_wgmma_kernel<0,144,4>"])
    assert set(mix) == set(kernel_report.MIX) | {"other"}
    assert (mix["HGMMA"], mix["FMNMX"], mix["SYNCS"], mix["other"]) == \
        (1, 2, 1, 2)


def test_compile_library_keeps_the_compiler_output(tmp_path, monkeypatch):
    """The compiler's output (ptxas's report, for nvcc) lands in
    ``<library>.log`` beside the library; a library built before has its
    log read back, and one with none reads as empty."""
    monkeypatch.setenv("R3D_TORCH_BUILD_DIR", str(tmp_path / "kb"))
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\n"
                  "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; "
                  "shift; done\n"
                  "echo built > \"$out\"\n"
                  "echo 'ptxas info    : Used 40 registers'\n")
    cc.chmod(cc.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    lib = _build.compile_library(str(cc), ["-O3"], str(src))
    assert os.path.dirname(lib) == str(tmp_path / "kb")
    assert open(lib).read() == "built\n"
    assert "Used 40 registers" in _build.build_log(lib)
    assert _build.compile_library(str(cc), ["-O3"], str(src)) == lib
    assert _build.build_log(str(tmp_path / "none.so")) == ""
    assert "-Xptxas" in _build.NVCC_FLAGS and "-v" in _build.NVCC_FLAGS


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and the headers beside it that
    the source includes (recursively), so an edited header is built
    again; a system header and a missing one are not read."""
    monkeypatch.setenv("R3D_TORCH_BUILD_DIR", str(tmp_path / "kb"))
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cstdint>\n#include "a.cuh"\n'
                   '#include "missing.cuh"\n')
    first = _build.library_path(str(src), ["-O3"])
    assert _build.library_path(str(src), ["-O3"]) == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path(str(src), ["-O3"])
    assert second != first and os.path.basename(second).startswith("libk_")
    assert _build.library_path(str(src), ["-O2"]) != second


def test_timing_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        kernel_report.time_cases(["lib.so"])


def test_ops_per_call_cuts_a_trace_at_its_markers():
    """The device operations of one call from a trace of several calls,
    each opened by the marker kernel: the list most calls gave (the first
    call's trace missed its prologue), each time the median over those
    calls; events before the first marker are not a call's."""
    m = kernel_report.MARKER
    events = [(0, 5_000, "early"),
              (10_000, 11_000, m), (12_000, 14_000, "main"),
              (20_000, 21_000, m), (22_000, 23_000, "prep"),
              (23_000, 26_000, "main"),
              (30_000, 31_000, m), (32_000, 33_000, "prep"),
              (33_000, 35_000, "main"),
              (40_000, 41_000, m), (42_000, 44_000, "prep"),
              (44_000, 48_000, "main")]
    got = kernel_report.ops_per_call(reversed(events))
    assert got == [("prep", 1.0), ("main", 3.0)]
    assert kernel_report.ops_per_call([(0, 1, "main")]) == []
