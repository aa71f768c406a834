"""The bundle adjustment's linearisation and cost read as CUDA kernels.

``linearize`` is ``ba/lm.py:_normal_blocks`` without shards (each
observation row's residual, its 2x18 Jacobian split into A, B and Ji, the
masking, the IRLS weights, and the block sums U, Vl, Ui, gc, gp, gi over the
layout's segment tables) in one C call of ``csrc/ba_linearize.cu``: one
cooperative launch, where the plain version's vmap-ped jvp enqueues ~600
operations a trial. ``cost`` is ``lm.compute_cost`` in one C call: the
residuals at a state, their Huber costs and the masked, weighted sum, to
one scalar on the card. Both evaluate only each row's own camera model.

``ba/lm.py`` decides which path runs; this module only launches the
kernels. Their plain versions are ``lm._normal_blocks`` and
``lm.compute_cost``, the yardsticks of the card tests. There is no
fallback: a call launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from regard3d_tpu_torch.core.segments import SegmentTable
from regard3d_tpu_torch.kernels import _build
from regard3d_tpu_torch.kernels.schur_pcg import put_tables, table_fields

_SOURCE = "ba_linearize.cu"
_DTYPE = {torch.float32: (0, "f32"), torch.float64: (1, "f64")}

_P = ctypes.c_void_p
_I = ctypes.c_longlong

_OUTPUTS = ("r", "A", "B", "Ji", "w", "U", "Vl", "Ui", "gc", "gp", "gi")


class _Args(ctypes.Structure):
    """``bal::Args`` of ``csrc/ba_linearize.cu``: 8-byte fields only."""
    _fields_ = ([(n, _P) for n in ("R", "C", "intr", "X", "xy", "weight",
                                   "view_id", "intr_id", "point_id",
                                   "model")]
                + [("idx", _P * 3), ("mask", _P * 3), ("lengths", _P * 3),
                   ("cap", _I * 3)]
                + [(n, _I) for n in ("V", "L", "K", "O")]
                + [("huber", ctypes.c_double)]
                + [(n, _P) for n in _OUTPUTS + ("cost", "work")])


def _inputs(R, C, intr, X, view_id, intr_id, point_id, model, xy, weight):
    """The state and observation tensors as ``_build.check`` takes them, by
    name, and (V, L, K, O)."""
    V, L, K, O = R.shape[0], X.shape[0], intr.shape[0], view_id.shape[0]
    dtype = R.dtype
    want = {"R": (R, (V, 3, 3), tuple(_DTYPE)), "C": (C, (V, 3), dtype),
            "intr": (intr, (K, 9), dtype), "X": (X, (L, 3), dtype),
            "view_id": (view_id, (O,), torch.int64),
            "intr_id": (intr_id, (O,), torch.int64),
            "point_id": (point_id, (O,), torch.int64),
            "model": (model, (O,), torch.int64),
            "xy": (xy, (O, 2), dtype), "weight": (weight, (O,), dtype)}
    return want, (V, L, K, O)


def _call(entry: str, want, sizes, tables, huber_delta_px: float, out: dict,
          result):
    """The prepared C call of ``entry`` (``r3d_ba_linearize`` or
    ``r3d_ba_cost``) on the checked tensors ``want``, writing ``out``."""
    dev = _build.check(**want)
    a = _Args(**{k: t.data_ptr() for k, (t, _, _) in want.items()
                 if k in dict(_Args._fields_)})
    if tables is not None:
        put_tables(a, tables)
    a.V, a.L, a.K, a.O = sizes
    a.huber = float(huber_delta_px)
    for k, t in out.items():
        setattr(a, k, t.data_ptr())
    code, tag = _DTYPE[want["R"][0].dtype]
    lib = _build.load_library(_SOURCE)
    size = getattr(lib, f"{entry}_workspace")(code, ctypes.byref(a))
    work = torch.empty((size,), dtype=torch.uint8, device=dev)
    a.work = work.data_ptr()
    return _build.Call(getattr(lib, entry),
                       (code, dev.index, ctypes.byref(a), _build.stream(dev)),
                       (a, work, *(t for t, _, _ in want.values()),
                        *out.values()), result, entry[4:] + "_" + tag)


def prepare_linearize(R, C, intr, X, view_id, intr_id, point_id, model, xy,
                      weight, cam: SegmentTable, pt: SegmentTable,
                      intr_table: SegmentTable,
                      huber_delta_px: float) -> _build.Call:
    """The C call of ``linearize`` (same arguments), prepared: the
    ``bal::Args`` structure, the workspace and the outputs. Raises
    ValueError on what the kernel cannot take."""
    want, (V, L, K, O) = _inputs(R, C, intr, X, view_id, intr_id, point_id,
                                 model, xy, weight)
    tensors, shapes = {}, {}
    tables = [table_fields(name, t, n, O, shapes, tensors)
              for name, t, n in (("cam", cam, V), ("pt", pt, L),
                                 ("intr", intr_table, K))]
    want.update({k: (tensors[k], *shapes[k]) for k in shapes})
    shape = {"r": (O, 2), "A": (O, 2, 6), "B": (O, 2, 3), "Ji": (O, 2, 9),
             "w": (O,), "U": (V, 6, 6), "Vl": (L, 3, 3), "Ui": (K, 9, 9),
             "gc": (V, 6), "gp": (L, 3), "gi": (K, 9)}
    out = {k: torch.empty(shape[k], dtype=R.dtype, device=R.device)
           for k in _OUTPUTS}
    return _call("r3d_ba_linearize", want, (V, L, K, O), tables,
                 huber_delta_px, out, tuple(out.values()))


def prepare_cost(R, C, intr, X, view_id, intr_id, point_id, model, xy,
                 weight, huber_delta_px: float) -> _build.Call:
    """The C call of ``cost`` (same arguments), prepared. Raises ValueError
    on what the kernel cannot take."""
    want, sizes = _inputs(R, C, intr, X, view_id, intr_id, point_id, model,
                          xy, weight)
    cost_t = torch.empty((), dtype=R.dtype, device=R.device)
    return _call("r3d_ba_cost", want, sizes, None, huber_delta_px,
                 {"cost": cost_t}, cost_t)


def linearize(*args, **kwargs):
    """One linearisation of a bundle adjustment in one C call. R (V, 3, 3),
    C (V, 3), intr (K, 9), X (L, 3): the state, float32 or float64, one
    dtype; view_id, intr_id, point_id, model (O,) int64; xy (O, 2), weight
    (O,) of the state's dtype; cam, pt, intr_table: the three
    ``SegmentTable``s of ``lm.BALayout``, padded or sorted;
    huber_delta_px (0: squared loss). Every tensor contiguous, on one card.
    Returns (r (O, 2), A (O, 2, 6), B (O, 2, 3), Ji (O, 2, 9), w (O,),
    U (V, 6, 6), Vl (L, 3, 3), Ui (K, 9, 9), gc (V, 6), gp (L, 3),
    gi (K, 9)), each contiguous. Raises ValueError on any other input,
    RuntimeError if the launch fails."""
    return _build.launch(prepare_linearize(*args, **kwargs))


def cost(*args, **kwargs):
    """One cost read of a bundle adjustment in one C call: the arguments of
    :func:`linearize` but the tables. Returns the cost, a 0-dim tensor of
    the state's dtype on the card. Raises ValueError on any other input,
    RuntimeError if the launch fails."""
    return _build.launch(prepare_cost(*args, **kwargs))
