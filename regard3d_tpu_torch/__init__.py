"""regard3d_tpu_torch — the PyTorch/CUDA port of regard3d_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference ``regard3d_tpu``: it imports
``torch`` (never ``jax``, ``flax`` or ``regard3d_tpu``) and keeps the
reference's module names, public signatures and array layouts so each
module's counterpart is easy to find.

Ported so far, the main path from photos to a posed scene: the
compute-matches stage (features -> putative matching -> AC-RANSAC F/E/H ->
on-disk match files) and the triangulation stage (tracks -> incremental SfM
with P3P resection -> Schur-complement LM bundle adjustment -> scene.npz,
sfm_data.json, PLYs, report). Three hand-written CUDA C++ sources for
sm_90a, built with nvcc at first use, hold the kernels on that path: the
fused L2-distance + running top-2 matcher (``csrc/match_top2.cu``: the
block call K1 and the single-pair call K2), the E filter's hypothesis
sweep (``csrc/essential5.cu``) and the bundle adjustment's damped Schur
PCG solve (``csrc/schur_pcg.cu``); the rest is PyTorch ops. Every kernel
is called one way, through ``kernels/_build.py``: each C entry's
signature is declared there once, a binding's ``prepare`` checks its
tensors and allocates its outputs, and ``_build.launch`` makes the C
call, raises on a ``cudaError`` and counts it in ``_build.LAUNCHES``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__all__ = ["runtime"]
