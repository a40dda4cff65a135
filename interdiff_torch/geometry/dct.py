"""Orthonormal DCT-II matrices of the interaction-correction networks
(`interdiff_tpu/geometry/dct.py`): built in float64 with numpy, the
transpose as the exact inverse, cast at the end."""

from __future__ import annotations

import numpy as np


def dct_matrices(n: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """``(dct_m, idct_m)`` of shape [n, n] with
    ``dct_m[k, i] = w_k * cos(pi * (i + 1/2) * k / n)``, ``w_0 = sqrt(1/n)``
    and ``w_k = sqrt(2/n)`` otherwise (the reference's ``get_dct_matrix``,
    `correction_smpl.py:55-67`).  The matrix is orthonormal, so the inverse
    is its transpose."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    w = np.full((n, 1), np.sqrt(2.0 / n))
    w[0, 0] = np.sqrt(1.0 / n)
    dct_m = w * np.cos(np.pi * (i + 0.5) * k / n)
    idct_m = dct_m.T.copy()
    return dct_m.astype(dtype), idct_m.astype(dtype)
