"""The port's matcher profile (``regard3d_tpu_torch.tools.profile_matcher``)
against the reference's ``tools/profile_matcher.py``, on the CPU, and the
SASS count that shows its ``mm_only`` times the whole product.

On the CPU the tool times the kernels' plain versions on the host clock, so
these tests check its inputs, its variants and its output, never a time.
The reference tool runs here in interpret mode at a small size.
"""

import json
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu_torch.kernels import _build
from regard3d_tpu_torch.kernels import match as tm
from regard3d_tpu_torch.tools import profile_matcher as tpm
from tests.test_torch_match import profile_tool

# several pytest workers share the host: a small intra-op pool per worker
# keeps torch from oversubscribing the cores
torch.set_num_threads(min(2, torch.get_num_threads()))

SMALL = ["--n", "256", "--d", "144", "--pairs", "4", "--b", "3"]


def reference_json(capsys, argv):
    ref = profile_tool()
    with mock.patch.object(sys, "argv", ["profile_matcher.py", *argv]):
        ref.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_prints_the_reference_keys(capsys):
    """``main([..., "--device", "cpu"])`` prints one JSON line with the
    reference tool's keys, the CPU named as the backend."""
    want = reference_json(capsys, ["--n", "256", "--d", "128", "--pairs",
                                   "2", "--b", "2"])
    out = tpm.main([*SMALL, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out.keys() == want.keys()
    assert (out["n"], out["d"], out["pairs"]) == (256, 144, 4)
    assert (out["tile_m"], out["tile_n"]) == (tm.TILE_M, tm.TILE_N)
    assert out["backend"] == "cpu"
    assert np.isclose(out["flop_per_pair_g"], 2 * 256 * 256 * 144 / 1e9)
    for v in tpm.VARIANTS:
        assert out[f"{v}_pairs_per_s"] > 0 and out[f"{v}_tflops"] > 0


def test_inputs_are_the_reference_tools(rng):
    """Same seed, same draws: unit-norm uniform rows and the same pairs."""
    desc, mask, prs = tpm.make_inputs(64, 32, 5, 3, "cpu")
    r = np.random.default_rng(0)
    x = jnp.asarray(r.random((3, 64, 32), np.float32))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    np.testing.assert_allclose(desc.numpy(), np.asarray(x), rtol=1e-6)
    np.testing.assert_array_equal(prs.numpy(),
                                  r.integers(0, 3, (5, 2)).astype(np.int32))
    assert mask.all() and mask.shape == (3, 64)


def test_variants_compute_the_kernels_functions(rng):
    """The three timed calls are K1 at bf16 and the two K3 modes."""
    desc, mask, prs = tpm.make_inputs(256, 144, 3, 3, "cpu")
    full = tpm._variant("full", desc, mask, prs)()
    want = tm.l2_top2_block_plain(desc, mask, prs, bf16=True)[0]
    np.testing.assert_array_equal(full.numpy(), want.numpy())
    for mode in tm.ABLATIONS:
        got = tpm._variant(mode, desc, mask, prs)()
        np.testing.assert_array_equal(
            got.numpy(), tm.l2_top2_block_ablated_plain(
                desc, mask, prs, mode).numpy())


def test_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpm.main(SMALL)


def _fake_sass(counts, wgmma=False):
    """``cuobjdump -sass`` text with the given tensor-core instructions per
    bf16 kernel instance (mangled as nvcc names them): HMMA in
    ``l2_top2_mma_kernel<mode, D>`` (mma.sync), or with ``wgmma`` HGMMA in
    ``l2_top2_wgmma_kernel<mode, D, stages>``; beside them the f32 and merge
    kernels, which hold none."""
    ns = "_ZN43_GLOBAL__N__aff430fc_10_match_top2_cu_f720101b"
    text = "Fatbin elf code:\narch = sm_90a\n"
    for (mode, dc), n in counts.items():
        if wgmma:
            text += (f"\t\tFunction : {ns}20l2_top2_wgmma_kernelILi{mode}"
                     f"ELi{dc}ELi{4 if dc else 2}EEEv14CUtensorMap_stS1_S1_"
                     f"S1_PK13__nv_bfloat16PKfPKiiiiiPfPiS9_S9_i\n"
                     + "  WARPGROUP.ARRIVE ;\n"
                     + "  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
                     * n)
        else:
            text += (f"\t\tFunction : {ns}18l2_top2_mma_kernelILi{mode}ELi"
                     f"{dc}EEEvPK13__nv_bfloat16S3_PKfPKiiiiiPfPiS8_S8_i\n"
                     + "  LDSM.16.M88.4 R4, [R2] ;\n"
                     + "  HMMA.16816.F32.BF16 R8, R4, R6, R8 ;\n" * n)
    return text + (f"\t\tFunction : {ns}19merge_splits_kernelEPKfixPfPiS2_\n"
                   "  FMNMX R1, R2, R3, PT ;\n"
                   f"\t\tFunction : {ns}18l2_top2_f32_kernelEPKfS1_S1_PKiiiiiPf"
                   "PiS4_S4_\n  FFMA R1, R2, R3, R1 ;\n")


@pytest.mark.parametrize("counts,wgmma", [
    ({(m, dc): 144 if dc else 48 for m in (0, 1, 2) for dc in (0, 144)},
     False),
    ({(0, 144): 144, (1, 144): 36, (2, 144): 144, (0, 0): 48, (1, 0): 12,
      (2, 0): 48}, False),
    ({(m, dc): 36 if dc else 28 for m in (0, 1, 2) for dc in (0, 144)},
     True),
    ({(0, 144): 36, (1, 144): 9, (2, 144): 36, (0, 0): 28, (1, 0): 0,
      (2, 0): 28}, True),
], ids=["all_live", "dead_mm_only", "wgmma_all_live", "wgmma_dead_mm_only"])
def test_hmma_counts_per_kernel_instance(monkeypatch, counts, wgmma):
    """``_build.hmma_counts`` (the check of ``chip_smoke.py`` phase (a))
    reads cuobjdump's SASS next to nvcc and counts the tensor-core
    instructions (HMMA of mma.sync, HGMMA of wgmma) per instance of the
    bf16 kernel, keyed ``"<mode>,<D or 0>"``; other kernels are left out."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, _fake_sass(counts, wgmma),
                                           "")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    got = _build.hmma_counts("lib.so")
    assert calls == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    assert got == {f"{m},{dc}": n for (m, dc), n in counts.items()}
