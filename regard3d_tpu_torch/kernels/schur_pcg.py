"""The bundle adjustment's damped Schur PCG solve as one CUDA kernel.

``schur_pcg`` is ``ba/lm.py:_solve_schur`` (the damped block inverses, the
right-hand side, up to ``cg_iterations`` Jacobi-preconditioned CG steps
with implicit Schur products and the points' back-substitution) in one C
call of ``csrc/schur_pcg.cu`` on the card: one cooperative launch, where
the plain version enqueues ~2,790 operations a trial. It takes the
linearization's blocks and the layout's segment tables as they are and
returns ``(dc (V, 6), dp (L, 3), di (K, 9))``.

``ba/lm.py`` decides which solve runs; this module only launches the
kernel. It has no plain version of its own: the plain solve is
``lm._solve_schur``, the kernel's yardstick in the card tests. There is no
fallback: a call launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from regard3d_tpu_torch.core.segments import SegmentTable
from regard3d_tpu_torch.kernels import _build

_SOURCE = "schur_pcg.cu"
_DTYPE = {torch.float32: (0, "f32"), torch.float64: (1, "f64")}

_P = ctypes.c_void_p
_I = ctypes.c_longlong


class _Args(ctypes.Structure):
    """``spcg::Args`` of ``csrc/schur_pcg.cu``: 8-byte fields only."""
    _fields_ = ([(n, _P) for n in ("A", "B", "Ji", "w", "U", "Vl", "Ui",
                                   "gc", "gp", "gi", "view_id", "intr_id",
                                   "point_id", "fixed", "intr_free")]
                + [("idx", _P * 3), ("mask", _P * 3), ("lengths", _P * 3),
                   ("cap", _I * 3)]
                + [(n, _I) for n in ("V", "L", "K", "O", "iterations")]
                + [("lam", ctypes.c_double), ("tol2", ctypes.c_double)]
                + [(n, _P) for n in ("dc", "dp", "di", "steps", "work")])


def table_fields(name, table: SegmentTable, n: int, O: int, want, tensors):
    """A ``SegmentTable`` of ``n`` segments over ``O`` rows as the C entries
    of the BA kernels take it: its tensors added to ``want`` and ``tensors``
    for ``_build.check``, and its (idx, mask, lengths, cap) returned for
    :func:`put_tables`. Raises ValueError on a table of another segment
    count or of neither form."""
    if table.n != n:
        raise ValueError(f"table {name} has {table.n} segments, want {n}")
    if table.rows is not None:
        cap = int(table.rows.shape[1]) if table.rows.dim() == 2 else 0
        want[f"{name}.rows"] = ((n, cap), torch.int64)
        want[f"{name}.mask"] = ((n, cap), torch.float32)
        tensors[f"{name}.rows"], tensors[f"{name}.mask"] = (table.rows,
                                                            table.mask)
        if cap == 0:
            raise ValueError(f"table {name}: padded rows need a width")
        return table.rows, table.mask, None, cap
    if table.order is None or table.lengths is None:
        raise ValueError(f"table {name} holds neither rows nor order")
    want[f"{name}.order"] = ((O,), torch.int64)
    want[f"{name}.lengths"] = ((n,), torch.int64)
    tensors[f"{name}.order"] = table.order
    tensors[f"{name}.lengths"] = table.lengths
    return table.order, None, table.lengths, 0


def put_tables(a: ctypes.Structure, tables) -> None:
    """The (idx, mask, lengths, cap) of the three tables (cam, pt, intr,
    from :func:`table_fields`) into the C arguments ``a``."""
    ptr = lambda t: None if t is None else t.data_ptr()
    for i, (idx, mask, lengths, cap) in enumerate(tables):
        a.idx[i], a.mask[i], a.lengths[i] = ptr(idx), ptr(mask), ptr(lengths)
        a.cap[i] = cap


def prepare(A, B, Ji, w, U, Vl, Ui, gc, gp, gi, view_id, intr_id,
            point_id, fixed_pose_mask, intr_dof_mask, cam: SegmentTable,
            pt: SegmentTable, intr: SegmentTable, lam: float,
            cg_iterations: int, cg_tol: float,
            steps: Optional[torch.Tensor] = None) -> _build.Call:
    """The C call of ``schur_pcg`` (same arguments), prepared: the
    ``spcg::Args`` structure, the workspace and the outputs (dc, dp, di).
    Raises ValueError on what the kernel cannot take."""
    O, V, L, K = A.shape[0], U.shape[0], Vl.shape[0], Ui.shape[0]
    dtype = A.dtype
    want = {"A": ((O, 2, 6), tuple(_DTYPE)), "B": ((O, 2, 3), dtype),
            "Ji": ((O, 2, 9), dtype), "w": ((O,), dtype),
            "U": ((V, 6, 6), dtype), "Vl": ((L, 3, 3), dtype),
            "Ui": ((K, 9, 9), dtype), "gc": ((V, 6), dtype),
            "gp": ((L, 3), dtype), "gi": ((K, 9), dtype),
            "view_id": ((O,), torch.int64), "intr_id": ((O,), torch.int64),
            "point_id": ((O,), torch.int64),
            "fixed_pose_mask": ((V,), torch.bool),
            "intr_dof_mask": ((K, 9), torch.bool)}
    tensors = dict(A=A, B=B, Ji=Ji, w=w, U=U, Vl=Vl, Ui=Ui, gc=gc, gp=gp,
                   gi=gi, view_id=view_id, intr_id=intr_id,
                   point_id=point_id, fixed_pose_mask=fixed_pose_mask,
                   intr_dof_mask=intr_dof_mask)
    if steps is not None:
        want["steps"] = ((), torch.int64)
        tensors["steps"] = steps
    tables = [table_fields(name, t, n, O, want, tensors)
              for name, t, n in (("cam", cam, V), ("pt", pt, L),
                                 ("intr", intr, K))]
    if cg_iterations < 0:
        raise ValueError(f"cg_iterations {cg_iterations} < 0")
    dev = _build.check(**{name: (tensors[name], shape, dt)
                          for name, (shape, dt) in want.items()})

    dc = torch.empty((V, 6), dtype=dtype, device=dev)
    dp = torch.empty((L, 3), dtype=dtype, device=dev)
    di = torch.empty((K, 9), dtype=dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(**{k: ptr(tensors[k]) for k in (
        "A", "B", "Ji", "w", "U", "Vl", "Ui", "gc", "gp", "gi", "view_id",
        "intr_id", "point_id")})
    a.fixed = fixed_pose_mask.data_ptr()
    a.intr_free = intr_dof_mask.data_ptr()
    put_tables(a, tables)
    a.V, a.L, a.K, a.O, a.iterations = V, L, K, O, int(cg_iterations)
    a.lam, a.tol2 = float(lam), float(cg_tol) ** 2
    a.dc, a.dp, a.di, a.steps = dc.data_ptr(), dp.data_ptr(), \
        di.data_ptr(), ptr(steps)
    code, tag = _DTYPE[dtype]
    lib = _build.load_library(_SOURCE)
    work = torch.empty((lib.r3d_schur_pcg_workspace(code, ctypes.byref(a)),),
                       dtype=torch.uint8, device=dev)
    a.work = work.data_ptr()
    return _build.Call(lib.r3d_schur_pcg,
                       (code, dev.index, ctypes.byref(a), _build.stream(dev)),
                       (a, work, *tensors.values()), (dc, dp, di),
                       f"schur_pcg_{tag}")


def schur_pcg(*args, **kwargs):
    """One damped Schur PCG solve in one C call. A (O, 2, 6), B (O, 2, 3),
    Ji (O, 2, 9), w (O,), U (V, 6, 6), Vl (L, 3, 3), Ui (K, 9, 9), gc (V,
    6), gp (L, 3), gi (K, 9): float32 or float64, one dtype; view_id,
    intr_id, point_id (O,) int64; fixed_pose_mask (V,) and intr_dof_mask
    (K, 9) bool; cam, pt, intr: the three ``SegmentTable``s of
    ``lm.BALayout``, padded or sorted; lam, cg_iterations, cg_tol; every
    tensor contiguous, on one card. ``steps``: an int64 scalar on that
    card that the CG steps run are added to, or None. Returns (dc (V, 6),
    dp (L, 3), di (K, 9)). Raises ValueError on any other input,
    RuntimeError if the launch fails."""
    return _build.launch(prepare(*args, **kwargs))
