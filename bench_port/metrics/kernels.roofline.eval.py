"""Percent of their roofline that the port's kernels reach in the
profiled slice of an SMPL eval batch: the sum of each launch's least time
(the larger of its operations over 67 TFLOP/s and its bytes over 3.35
TB/s, `flops.py`) over the sum of their device times.  K1 runs in the
encode, K2 and K4 in the two firings, K3 in the metrics; K2's operations
count the pairs its flagged segments hold on these inputs, and its
prologue kernels count in its time."""

from bench_port import flops

PROLOGUE = ("segment_list_kernel", "frame_order_kernel")


def read(rec):
    kernels = rec.get("kernels")
    if not kernels:
        return None
    cfg, tr = rec["cfg"], rec["traffic"]
    V, P = cfg["body"]["num_verts"], tr["points"]
    rows, frames = rec["rows"], rec["frames"]
    future = rows * cfg["future_len"]
    least = spent = 0.0
    k1 = sweeps = 0
    for name, seconds in kernels:
        if name == "ball_group_kernel":
            ns = (16, 32)[k1 % 2]
            least += flops.least_s(*flops.k1(tr["clips"], P, 1024, 4, ns))
            k1 += 1
        elif name == "signed_sweep_kernel":
            pairs = rec["k2_pairs"]
            n = flops.nn_sweep(future, P, V, True,
                               pairs[sweeps] if sweeps < len(pairs) else None)
            least += flops.least_s(*n)
            sweeps += 1
        elif name == "nearest_kernel":
            least += flops.least_s(*flops.nn_sweep(
                rows * frames, len(cfg["markers"]), P, False))
        elif name not in PROLOGUE:
            continue
        spent += seconds
    if not spent:
        return None
    return 100.0 * least / spent
