"""Body-model and object constants (data tables, not code): the port's copy
of what the correction path, the contact-label preprocessing and the
renderers need from `interdiff_tpu/data/constants.py`.

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


# Simplified object-template meshes per BEHAVE category
# (`data/utils.py:18-40`): category name -> relative path of the
# decimated-scan mesh used for point sampling.
SIMPLIFIED_MESH = {
    "backpack": "backpack/backpack_f1000.ply",
    "basketball": "basketball/basketball_f1000.ply",
    "boxlarge": "boxlarge/boxlarge_f1000.ply",
    "boxtiny": "boxtiny/boxtiny_f1000.ply",
    "boxlong": "boxlong/boxlong_f1000.ply",
    "boxsmall": "boxsmall/boxsmall_f1000.ply",
    "boxmedium": "boxmedium/boxmedium_f1000.ply",
    "chairblack": "chairblack/chairblack_f2500.ply",
    "chairwood": "chairwood/chairwood_f2500.ply",
    "monitor": "monitor/monitor_closed_f1000.ply",
    "keyboard": "keyboard/keyboard_f1000.ply",
    "plasticcontainer": "plasticcontainer/plasticcontainer_f1000.ply",
    "stool": "stool/stool_f1000.ply",
    "tablesquare": "tablesquare/tablesquare_f2000.ply",
    "toolbox": "toolbox/toolbox_f1000.ply",
    "suitcase": "suitcase/suitcase_f1000.ply",
    "tablesmall": "tablesmall/tablesmall_f1000.ply",
    "yogamat": "yogamat/yogamat_f1000.ply",
    "yogaball": "yogaball/yogaball_f1000.ply",
    "trashbin": "trashbin/trashbin_f1000.ply",
}

# Skeleton-track (HO-GCN) bone list for rendering (`render/viz_helper.py:11-15`).
SKELETON_BONES = [
    (0, 1), (1, 2), (2, 3), (3, 4),
    (2, 5), (5, 6), (6, 7), (7, 8),
    (2, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15),
    (0, 16), (16, 17), (17, 18),
]

# Object keypoint edge maps per category (`render/viz_helper.py:17-28`).
OBJ_CONNECTS = {
    "chair4": [(1, 2), (1, 4), (2, 4), (1, 0), (0, 2), (0, 5), (5, 7), (0, 10),
               (2, 11), (4, 9), (1, 8), (2, 3), (5, 3), (4, 6), (0, 6), (0, 7),
               (2, 7), (3, 7)],
    "box2": [(2, 11), (2, 5), (9, 11), (1, 0), (1, 7), (8, 10), (3, 4), (4, 9),
             (3, 8), (7, 8), (1, 11), (3, 5), (6, 2), (3, 6), (2, 0), (4, 10),
             (6, 8), (1, 2), (7, 10), (7, 0), (4, 5), (5, 11), (0, 6), (6, 7),
             (1, 9), (9, 10), (5, 9), (7, 9)],
    "board": [(3, 6), (6, 5), (3, 9), (5, 9), (5, 1), (1, 4), (2, 4), (1, 7),
              (0, 7), (0, 11), (11, 10), (8, 10), (2, 8), (2, 9)],
    "chair2": [(4, 9), (2, 11), (1, 8), (0, 10), (0, 1), (1, 4), (2, 4),
               (2, 3), (3, 5), (0, 2), (0, 5), (7, 3), (7, 5), (7, 0), (7, 2),
               (0, 6), (6, 1), (6, 2), (6, 4)],
    "box3": [(4, 5), (5, 9), (5, 11), (2, 5), (2, 6), (2, 0), (2, 11), (9, 4),
             (9, 11), (9, 1), (9, 10), (1, 0), (1, 7), (0, 6), (3, 4), (3, 5),
             (3, 10), (3, 8), (8, 6), (8, 7), (8, 10), (3, 6), (0, 7), (1, 11),
             (4, 10), (10, 7)],
    "table": [(0, 2), (2, 3), (3, 4), (4, 0), (0, 1), (2, 1), (1, 10), (3, 5),
              (2, 5), (5, 8), (4, 6), (3, 6), (6, 7), (0, 11), (4, 11),
              (11, 9)],
    "chair": [(4, 9), (2, 11), (1, 8), (0, 10), (0, 1), (1, 4), (2, 4), (2, 3),
              (3, 5), (0, 2), (0, 5), (7, 3), (7, 5), (7, 0), (7, 2), (0, 6),
              (6, 1), (6, 2), (6, 4)],
    "box": [(4, 5), (5, 9), (5, 11), (2, 5), (2, 6), (2, 0), (2, 11), (9, 4),
            (9, 11), (9, 1), (9, 10), (1, 0), (1, 7), (0, 6), (3, 4), (3, 5),
            (3, 10), (3, 8), (8, 6), (8, 7), (8, 10), (3, 6), (0, 7), (1, 11),
            (4, 10), (10, 7)],
    "tripod": [(3, 5), (4, 6), (0, 1), (7, 10), (7, 11), (9, 7), (1, 8),
               (4, 8), (5, 8), (8, 2), (8, 7), (7, 10)],
}

# Full-resolution object templates (`data/utils.py:42-62`).
FULL_MESH = {k: f"{k}/{k}.obj" for k in SIMPLIFIED_MESH}


# SMPL-H landmark vertices of the extra joints (`data/utils.py:150-162`).
SMPLH_VERTEX_INDEX = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
    "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
    "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
}


def vertex_joint_selector_ids(*, use_hands: bool = True,
                              use_feet_keypoints: bool = True) -> np.ndarray:
    """Extra-joint vertex ids in the reference's VertexJointSelector order
    (`data/utils.py:164-215`): feet keypoints first, then the left and
    right fingertips."""
    ids: list = []
    if use_feet_keypoints:
        ids += [SMPLH_VERTEX_INDEX[k] for k in
                ("LBigToe", "LSmallToe", "LHeel",
                 "RBigToe", "RSmallToe", "RHeel")]
    if use_hands:
        ids += [SMPLH_VERTEX_INDEX[h + t] for h in ("l", "r")
                for t in ("thumb", "index", "middle", "ring", "pinky")]
    return np.asarray(ids, dtype=np.int32)


def select_extra_joints(vertices, joints, *, use_hands: bool = True,
                        use_feet_keypoints: bool = True):
    """VertexJointSelector.forward (`data/utils.py:209-215`): the landmark
    vertices appended to the joint set, [B, V, 3], [B, J, 3] -> [B, J+E, 3];
    numpy arrays or torch tensors."""
    ids = vertex_joint_selector_ids(
        use_hands=use_hands, use_feet_keypoints=use_feet_keypoints)
    if isinstance(joints, np.ndarray):
        return np.concatenate([joints, vertices[:, ids]], axis=1)
    import torch

    extra = vertices[:, torch.as_tensor(ids, dtype=torch.int64,
                                        device=vertices.device)]
    return torch.cat([joints, extra], dim=1)
