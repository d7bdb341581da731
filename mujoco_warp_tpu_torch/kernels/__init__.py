"""Hand-written CUDA kernels of the port and their wrappers.

On a CPU tensor each wrapper runs the plain PyTorch version, in float32
or float64; on a CUDA tensor it launches the kernel (``csrc/*.cu``),
which takes float32 only, or raises (a float64 CUDA tensor raises a
TypeError: nothing converts it or hands it to the plain version).  ``k1`` and
``k4`` serve the fused step on lanes-last tensors; ``mass_chain`` and
``solver`` the general step, each on lanes-last tensors with a
world-major entry that transposes with ``lanes`` and ``world``;
``linalg``'s kernels read world-major tensors (its Cholesky solves also
``world()`` views of lanes-last ones) in place.  Each wrapper counts its
kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types


def check(t: torch.Tensor, shape, name: str, device, dtype=torch.float32):
  """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
  on ``device``."""
  if not isinstance(t, torch.Tensor):
    raise TypeError(f'{name}: expected a tensor, got {type(t).__name__}')
  if t.device != device:
    raise ValueError(f'{name}: on {t.device}, expected {device}')
  if t.dtype != dtype:
    if t.device.type == 'cuda' and t.is_floating_point():
      raise TypeError(f'{name}: {t.dtype} on {t.device}: the CUDA kernels '
                      f'take {dtype} (the float64 path runs on the CPU)')
    raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
  if not t.is_contiguous():
    raise ValueError(f'{name}: not contiguous')


def host_dtype(t: torch.Tensor) -> torch.dtype:
  """The dtype a wrapper takes for ``t``: the plain versions run float32
  or float64 on the CPU, the kernels float32 on the card."""
  if t.device.type == 'cpu' and t.dtype == torch.float64:
    return torch.float64
  return torch.float32


def lanes(x: torch.Tensor, rows: int = None) -> torch.Tensor:
  """World-major (W, ...) -> lanes-last (..., W), contiguous; with
  ``rows``, flattened to (rows, W)."""
  out = x.permute(*range(1, x.dim()), 0).contiguous()
  return out if rows is None else out.reshape(rows, x.shape[0])


def world(x: torch.Tensor, *shape) -> torch.Tensor:
  """Lanes-last (rows, W) -> world-major (W, *shape)."""
  return x.T.reshape((x.shape[-1],) + shape)


def ptr(t) -> ctypes.c_void_p:
  return ctypes.c_void_p(0 if t is None else t.data_ptr())


def tree_levels(m) -> dict:
  """The bodies but the world's, level by level (``topo``), and each
  level's first index in it (``level_adr``, nlevel + 1 entries)."""
  levels = [[int(b) for b in lvl] for lvl in m.tree.body_levels]
  return dict(topo=[b for lvl in levels for b in lvl],
              level_adr=np.cumsum([0] + [len(lvl) for lvl in levels]))


def bit_rows(mask) -> np.ndarray:
  """A boolean (n, m) table as n rows of ceil(m / 32) 32-bit words, bit j
  of row i in word j // 32 (int32 for ``device_tables``)."""
  mask = np.asarray(mask, bool)
  n, m = mask.shape
  padded = np.zeros((n, 32 * ((m + 31) // 32)), bool)
  padded[:, :m] = mask
  words = np.packbits(padded.reshape(n, -1, 32), axis=-1,
                      bitorder='little').view('<u4')[..., 0]
  return words.astype(np.uint32).view(np.int32)


def chain_bits(m) -> dict:
  """The mass chain's bit tables (``csrc/mass_chain.cuh``
  ``MassChainTables``): the ancestor relation, either direction of it,
  and the dofs feeding each cdof_dot."""
  anc = m.tree.ancestor_mask
  return dict(anc_bits=bit_rows(anc), rel_bits=bit_rows(anc | anc.T),
              cdofdot_bits=bit_rows(m.tree.cdofdot_mask))


def device_tables(arrays: dict, device) -> dict:
  """numpy tables -> device tensors (int32 or float32), never empty."""
  out = {}
  for k, v in arrays.items():
    v = np.asarray(v)
    dt = torch.int32 if v.dtype.kind in 'iub' else torch.float32
    v = v.reshape(-1) if v.size else np.zeros(1, v.dtype)
    out[k] = torch.as_tensor(v, device=device).to(dt).contiguous()
  return out


class TableCache:
  """Device tables per (Model, device), built once, keyed on
  ``types.model_token``: every field of the Model but its batched ones,
  which ``build`` must not read.  A Model whose batched fields a sort
  permuted shares the tables of the Model it came from; any other change
  rebuilds them."""

  def __init__(self, build):
    self._build = build
    self._cache = {}

  def get(self, m, device):
    key = (types.model_token(m), str(device))
    hit = self._cache.get(key)
    if hit is None:
      hit = self._cache[key] = self._build(m, device)
    return hit
