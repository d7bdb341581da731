"""Jacobians, M v and Cartesian force accumulation, world-major.

Counterpart of ``mujoco_warp_tpu/ops/support.py`` ``jac`` (:16),
``mul_m`` (:39) and ``xfrc_accumulate`` (:46).
"""

from __future__ import annotations

import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math, smooth
from mujoco_warp_tpu_torch.ops.util import fmask, ix


def jac(m: types.Model, d: types.Data, point: torch.Tensor, bodyid: int):
  """Point Jacobian of a world point (W, 3) on ``bodyid``: (jacp, jacr),
  each (W, 3, nv)."""
  mask = fmask(m.tree.body_dof_mask[bodyid], d.qpos)  # (nv,)
  offset = point - d.subtree_com[:, int(m.body_rootid[bodyid])]
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  jacp = (lin + math.cross(ang, offset[:, None, :])) * mask[:, None]
  jacr = ang * mask[:, None]
  return jacp.transpose(1, 2), jacr.transpose(1, 2)


def mul_m(m: types.Model, d: types.Data, vec: torch.Tensor) -> torch.Tensor:
  """M vec (``support.py:39``)."""
  return smooth.mul_m(m, d, vec)


def xfrc_accumulate(m: types.Model, d: types.Data) -> torch.Tensor:
  """Generalized force of the Cartesian applied forces (W, nv).  Rows of
  ``xfrc_applied`` are (force, torque) in the world frame at the body
  CoM."""
  force = d.xfrc_applied[..., :3]
  torque = d.xfrc_applied[..., 3:]
  offset = d.xipos - d.subtree_com[:, ix(m.body_rootid, d.qpos.device)]
  cfrc = torch.cat([torque + math.cross(offset, force), force], dim=-1)
  ds = fmask(m.tree.dof_subtree_mask, d.qpos)
  return torch.sum((ds @ cfrc) * d.cdof, dim=-1)
