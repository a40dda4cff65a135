"""Skeleton-track gif rendering, the port's copy of
`interdiff_tpu/viz/skeleton_viz.py`: a matplotlib 3D animation of the
21-joint skeleton and the 12 object keypoints, contract from
`interdiff/render/viz_helper.py:29-201`.

Host code; matplotlib is imported when a gif is drawn, so nothing else of
the package needs it (`require_matplotlib` lets an entry point refuse its
render flag before any work where it is not installed).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from interdiff_torch.data.constants import OBJ_CONNECTS, SKELETON_BONES


def require_matplotlib() -> None:
    """Raise an ImportError naming matplotlib where it is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("the skeleton renderer needs matplotlib, which is "
                          "not installed") from e


def _obj_edges(obj_name: Optional[str]) -> Sequence:
    if obj_name is None:
        return ()
    for key, edges in OBJ_CONNECTS.items():
        if obj_name.startswith(key):
            return edges
    return ()


def visualize_skeleton(skeleton: np.ndarray, obj_points: np.ndarray,
                       save_path: str = "./test.gif", *,
                       obj_name: Optional[str] = None,
                       pred: Optional[np.ndarray] = None,
                       obj_pred: Optional[np.ndarray] = None,
                       past_len: int = 10, fps: int = 10) -> str:
    """Render a clip to a gif. skeleton [T,21,3], obj_points [T,12,3];
    optional prediction overlays (`viz_helper.py:77-201`).  Returns path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    T = skeleton.shape[0]
    edges = _obj_edges(obj_name)

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    allpts = np.concatenate([skeleton.reshape(-1, 3),
                             obj_points.reshape(-1, 3)], axis=0)
    lo, hi = allpts.min(0), allpts.max(0)
    center, radius = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-3

    def draw(t):
        ax.cla()
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[1] - radius, center[1] + radius)
        ax.set_zlim(center[2] - radius, center[2] + radius)
        color = "grey" if t < past_len else "tab:blue"
        for a, b in SKELETON_BONES:
            seg = skeleton[t, [a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color)
        ax.scatter(*obj_points[t].T, color="tab:orange", s=8)
        for a, b in edges:
            seg = obj_points[t, [a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="tab:orange",
                    linewidth=0.8)
        if pred is not None and t >= past_len:
            for a, b in SKELETON_BONES:
                seg = pred[t, [a, b]]
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="tab:red",
                        alpha=0.7)
        if obj_pred is not None and t >= past_len:
            ax.scatter(*obj_pred[t].T, color="tab:red", s=8, alpha=0.7)
        ax.set_title(f"frame {t} ({'past' if t < past_len else 'future'})")

    anim = FuncAnimation(fig, draw, frames=T)
    anim.save(save_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return save_path
