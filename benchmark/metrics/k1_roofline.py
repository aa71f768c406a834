"""Matching kernel K1 (``l2_top2_f32_kernel``): its share of the FP32
roofline, in percent, over the profiled step's K1 launches.

Useful work is what the inputs need: for every real pair (i, j) of the
step, 2 * n_i * n_j * 144 FLOP, with n the images' real keypoint counts;
the pad pairs that fill a launch of 64 and the padded rows count nothing.
K1 is compute-bound (the bytes read, 144 floats a row, take microseconds
at 3.35 TB/s), so the bound is the FLOP over 67 TFLOP/s, the published
FP32 peak of an H100 SXM outside the tensor cores (at 700 W)."""

from benchmark import peaks

KERNEL = "l2_top2_f32_kernel"
DIM = 144


def useful_flop(pairs, counts) -> float:
    return float(sum(2.0 * counts[i] * counts[j] * DIM for i, j in pairs))


def read(run):
    prof = run["profiled"]
    if prof is None or prof["result"] is None:
        return None
    t = sum(e - s for s, e, name in prof["ops"] if KERNEL in name) * 1e-9
    if t <= 0:
        return None
    flop = useful_flop(run["work"]["pairs"], prof["result"]["keypoints"])
    return 100.0 * flop / (t * peaks.FP32_FLOPS)
