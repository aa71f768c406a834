"""regard3d_tpu_torch — the PyTorch/CUDA port of regard3d_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference ``regard3d_tpu``: it imports
``torch`` (never ``jax``, ``flax`` or ``regard3d_tpu``) and keeps the
reference's module names, public signatures and array layouts so each
module's counterpart is easy to find.

Ported so far: the compute-matches stage (features -> putative matching ->
AC-RANSAC F/E/H -> on-disk match files). Its one device kernel, the fused
L2-distance + running top-2 matcher, is hand-written CUDA C++ for sm_90a
(``csrc/match_top2.cu``), built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__all__ = ["runtime"]
