"""Host-side (numpy, float64) rotation helpers of the data pipeline
(`interdiff_tpu/geometry/rotations_np.py`, copied: the port imports nothing
of the JAX package).

The reference canonicalization uses `scipy.spatial.transform.Rotation`
(`interdiff/data/dataset_smpl.py:119-160`); these are the two operations it
needs, in plain numpy, so that the pipeline needs no scipy.  Held equal to
the JAX package's copy in tests/test_torch_data_skeleton.py.
"""

from __future__ import annotations

import numpy as np


def rotvec_to_matrix_np(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle [3] -> rotation matrix [3,3] (float64)."""
    rotvec = np.asarray(rotvec, dtype=np.float64)
    theta = np.linalg.norm(rotvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rotvec / theta
    K = np.array([[0.0, -k[2], k[1]],
                  [k[2], 0.0, -k[0]],
                  [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def matrix_to_rotvec_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix [3,3] -> axis-angle [3] (float64), scipy conventions
    (angle in [0, pi])."""
    R = np.asarray(R, dtype=np.float64)
    # quaternion extraction (stable for all traces)
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2.0
        q = np.zeros(4)  # w, x, y, z
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    quat = np.array([w, x, y, z])
    quat /= np.linalg.norm(quat)
    if quat[0] < 0:
        quat = -quat
    angle = 2.0 * np.arctan2(np.linalg.norm(quat[1:]), quat[0])
    if angle < 1e-12:
        return np.zeros(3)
    axis = quat[1:] / np.linalg.norm(quat[1:])
    return axis * angle


def rotvec_compose_np(R_left: np.ndarray, rotvec: np.ndarray) -> np.ndarray:
    """axis-angle of (R_left @ R(rotvec)) — the canonical-frame re-expression
    `Rotation.from_matrix(rotation) * Rotation.from_rotvec(v)`."""
    return matrix_to_rotvec_np(
        np.asarray(R_left, dtype=np.float64) @ rotvec_to_matrix_np(rotvec)
    ).astype(np.float32)
