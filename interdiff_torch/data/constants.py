"""Body-model constants of the SMPL track (data tables, not code): the port's
copy of what the correction path needs from `interdiff_tpu/data/constants.py`.

Values are the published SSM marker set and body-part groupings used by
BEHAVE/InterDiff (`interdiff/data/utils.py:232-261`), so that contact labels
and the hand bias of the correction network
(`model/correction_smpl.py:128-130`) behave identically.
"""

from __future__ import annotations

import numpy as np

# SSM-67 marker set: SMPL-H vertex indices (`data/utils.py:232-239`).
MARKERSET_SSM67_SMPLH = np.array([
    3470, 3171, 3327, 857, 1812, 628, 182, 3116, 3040, 239,
    1666, 1725, 0, 2174, 1568, 1368, 3387, 2112, 1053, 1058,
    3336, 3346, 1323, 2108, 3122, 3314, 1252, 1082, 1861, 1454,
    850, 2224, 3233, 1769, 6728, 4343, 5273, 4116, 3694, 6399,
    6540, 6488, 3749, 5135, 5194, 3512, 5635, 5210, 4360, 4841,
    6786, 5573, 4538, 4544, 6736, 6747, 4804, 5568, 6544, 6682,
    5322, 4927, 5686, 4598, 6633, 3506, 3508], dtype=np.int32)

# Marker-index groupings by body part (`data/utils.py:249-261`).
MARKER2BODYPART = {
    "head_ids": [12, 45, 9, 42, 6, 38],
    "mid_body_ids": [56, 35, 58, 24, 22, 0, 4, 36, 26, 1, 65, 33, 41, 8, 66,
                     35, 3, 4, 39],
    "left_hand_ids": [10, 11, 14, 31, 13, 17, 23, 28, 27],
    "right_hand_ids": [60, 43, 44, 47, 62, 46, 51, 57],
    "left_foot_ids": [29, 30, 18, 19, 7, 2, 15],
    "right_foot_ids": [61, 52, 53, 40, 34, 49, 40],
    "left_toe_ids": [32, 25, 20, 21, 16],
    "right_toe_ids": [54, 55, 59, 64, 50, 55],
    "left_finger_ids": [72, 73, 74, 75, 76],
    "right_finger_ids": [67, 68, 69, 70, 71],
}

# Hand markers get a +0.5 contact-selection bias (`correction_smpl.py:128-130`).
HAND_MARKER_IDS = np.array(
    MARKER2BODYPART["left_hand_ids"] + MARKER2BODYPART["right_hand_ids"],
    dtype=np.int32)


def hand_bias_vector(num_markers: int = 67) -> np.ndarray:
    """0.5 on hand-marker slots, 0 elsewhere: the selection bias added to
    the contact counts before the marker choice."""
    bias = np.zeros((num_markers,), dtype=np.float32)
    bias[HAND_MARKER_IDS[HAND_MARKER_IDS < num_markers]] = 0.5
    return bias
