"""Constraint islands: connected components of constraint-coupled trees.

Counterpart of ``mujoco_warp_tpu/ops/island.py`` ``island`` (:24) for
batched Data.  A row touches a tree when |J| . T > 0 (T the static dof ->
tree indicator); two trees are coupled when a row touches both (B^T B >
0); components come from ``ntree - 1`` rounds of min-label propagation.
Islands are ranked by their smallest member tree, as MuJoCo numbers them;
an unconstrained tree gets -1.  Every step is a batched torch op over
(W, nefc, ntree): the JAX package computes it with jnp, not Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops.util import fmask, ix


def island(m: types.Model, d: types.Data) -> types.Data:
  """Label every world's trees, dofs and constraint rows with island ids."""
  ntree, nv, nefc = m.ntree, m.nv, m.nefc
  if ntree == 0 or nefc == 0 or nv == 0:
    return d
  J = d.efc_J
  dev = J.device
  ind = np.zeros((nv, ntree), np.float32)
  ind[np.arange(nv), m.dof_treeid] = 1.0
  ind = fmask(ind, J)

  B = torch.matmul(J.abs(), ind) > 0.0  # (W, nefc, ntree)
  Bf = B.to(J.dtype)
  A = torch.matmul(Bf.transpose(1, 2), Bf) > 0.0  # (W, ntree, ntree)
  constrained = B.any(dim=1)  # (W, ntree)

  tree_ids = torch.arange(ntree, dtype=torch.int32, device=dev)
  none = torch.full_like(A, ntree, dtype=torch.int32)
  labels = torch.where(constrained, tree_ids, ntree).to(torch.int32)
  for _ in range(max(ntree - 1, 1)):
    nbr = torch.where(A, labels[:, None, :], none)
    labels = torch.minimum(labels, nbr.amin(dim=2))

  is_rep = constrained & (labels == tree_ids)
  rank = torch.cumsum(is_rep.to(torch.int32), dim=1) - 1
  lbl = labels.clamp(0, ntree - 1).long()
  tree_island = torch.where(constrained, torch.gather(rank, 1, lbl),
                            -1).to(torch.int32)
  dof_island = tree_island[:, ix(m.dof_treeid, dev)]
  row_tree = torch.argmax(B.to(torch.int32), dim=2)  # first touched tree
  efc_island = torch.where(B.any(dim=2),
                           torch.gather(tree_island, 1, row_tree),
                           -1).to(torch.int32)
  nisland = is_rep.to(torch.int32).sum(dim=1, dtype=torch.int32)
  return d.replace(nisland=nisland, tree_island=tree_island,
                   dof_island=dof_island, efc_island=efc_island)
