"""K1, K2, K3, K4 and K6 of the PyTorch/CUDA port timed at
`chip_smoke.py`'s main-path data on one NVIDIA GPU, by the `chip_smoke.py`
and `interdiff_torch` of the checkout it is run from.

    python3 scripts/torch_kernel_times.py TAG     # from a checkout's root

Two checkouts (say the parent commit unpacked with `git archive` and the
working tree) are compared in one call on one card by running it from each
root in turn (parent, change, change, parent); the script may be this
checkout's, run with the other checkout as the working directory.  Prints
one JSON line: the tag, the card's name and power limit, K1's ms per
encode (both radius scales), K2's, K3's and K4's ms a call, K6's ms per
encode (both scales, the encoder's chains on seeded weights) and the
unfused route's it replaces (K1 + `SharedMLP` + ``amax``); CUDA events,
median of 30 after warm-up.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the checkout to time
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from interdiff_torch.config import build_smpl_body
    from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH
    from interdiff_torch.ops import group, nn, pointcloud, sa

    torch.backends.cuda.matmul.allow_tf32 = False
    data, new_xyz, d2t = cs._stage1_inputs(group, pointcloud)
    k1 = sum(cs.cuda_ms(lambda: group.group_cuda(d2t, data, new_xyz, r, S))
             for r, S in cs.SCALES)
    k6 = unfused = 0.0
    with torch.no_grad():
        for i, ((r, S), channels) in enumerate(zip(cs.SCALES,
                                                   cs.STAGE1_MLPS)):
            mlp = cs._seeded_shared_mlp(data.shape[-1], channels,
                                        cs.SEED + 8 + i)
            params = sa.folded_affine(mlp)
            k6 += cs.cuda_ms(lambda: sa.sa_cuda(d2t, data, new_xyz, params,
                                                r, S))
            unfused += cs.cuda_ms(lambda: mlp(group.group_cuda(
                d2t, data, new_xyz, r, S)).amax(dim=2))
    body = build_smpl_body(seed=cs.SEED, num_verts=cs.VERTS)
    rng = np.random.default_rng(cs.SEED + 4)
    verts, normals, cloud = cs._nn_geometry(
        rng, cs.CLIPS * cs.FOLD * cs.FRAMES, cs.POINTS, body)
    F = cs.CLIPS * cs.FOLD * cs.FUTURE
    a, b, n = cloud[:F], verts[:F], normals[:F]
    markers = verts[:, torch.from_numpy(MARKERSET_SSM67_SMPLH.astype(
        np.int64)).to(cs.DEV)].contiguous()
    cs.emit({"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
             "package": os.path.dirname(os.path.dirname(nn.__file__)),
             "gpu": cs.gpu_name_and_power(), "k1_ms_per_encode": k1,
             "k2_ms": cs.cuda_ms(
                 lambda: nn.signed_nearest_pruned_cuda(a, b, n, 0.25)),
             "k3_ms": cs.cuda_ms(lambda: nn.signed_nearest_cuda(a, b, n)),
             "k4_ms": cs.cuda_ms(
                 lambda: nn.nearest_neighbor_cuda(markers, cloud)),
             "k6_ms_per_encode": k6, "unfused_ms_per_encode": unfused})
    return 0


if __name__ == "__main__":
    sys.exit(main())
