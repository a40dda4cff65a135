"""HumanML3D's motion features back to joint positions (`recover_from_ric`
of HumanML3D's `motion_process.py`, with `quaternion.py`'s ``qrot`` and
``qinv``, as MDM's `generate.py` and `eval_humanml.py` call it).

A frame of ``data`` [..., frames, 263] for 22 joints holds, first, the
root's rotational velocity about y, its x/z velocity in its own heading and
its height, then the other 21 joints' positions relative to the root in
the root's heading (``data[..., 4:67]``).  The root's heading ``r`` is the
sum of the earlier frames' rotational velocities, its quaternion
``(cos r, 0, sin r, 0)``; the root's position is the running sum of the
earlier frames' velocities turned by the inverse quaternion, its y the
height, and the joints are turned likewise and moved by the root's x/z.
The arithmetic is the source's, product for product.
"""

from __future__ import annotations

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """The inverse of unit quaternions q [..., 4] (w, x, y, z)."""
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v [..., 3] rotated by the unit quaternion q [..., 4]."""
    u = q[..., 1:]
    uv = torch.cross(u, v, dim=-1)
    uuv = torch.cross(u, uv, dim=-1)
    return v + 2 * (q[..., :1] * uv + uuv)


def recover_root_rot_pos(data: torch.Tensor):
    """(the root's quaternion [..., frames, 4], its position [..., frames,
    3])."""
    rot_vel = data[..., 0]
    ang = torch.cumsum(torch.cat([torch.zeros_like(rot_vel[..., :1]),
                                  rot_vel[..., :-1]], -1), -1)
    zero = torch.zeros_like(ang)
    quat = torch.stack([torch.cos(ang), zero, torch.sin(ang), zero], -1)
    vel = torch.zeros(data.shape[:-1] + (3,), dtype=data.dtype,
                      device=data.device)
    vel[..., 1:, 0] = data[..., :-1, 1]
    vel[..., 1:, 2] = data[..., :-1, 2]
    pos = torch.cumsum(qrot(qinv(quat), vel), -2)
    pos[..., 1] = data[..., 3]
    return quat, pos


def recover_from_ric(data: torch.Tensor, joints_num: int = 22
                     ) -> torch.Tensor:
    """data [..., frames, 263] -> joints [..., frames, joints_num, 3], the
    root first."""
    quat, root = recover_root_rot_pos(data)
    local = data[..., 4:(joints_num - 1) * 3 + 4]
    local = local.reshape(local.shape[:-1] + (joints_num - 1, 3))
    joints = qrot(qinv(quat)[..., None, :].expand(local.shape[:-1] + (4,)),
                  local)
    joints = joints + torch.stack(
        [root[..., 0], torch.zeros_like(root[..., 0]), root[..., 2]],
        -1)[..., None, :]
    return torch.cat([root[..., None, :], joints], -2)
