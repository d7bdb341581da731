"""Static tables of the world-major stages as device tensors, made once
per device: a host array used in a step would otherwise be copied to the
device, and wait for it, on every call."""

from __future__ import annotations

import numpy as np
import torch

_IDX = {}


def ix(arr, device) -> torch.Tensor:
  """A static numpy index array as an int64 tensor on ``device``, made
  once: indexing with a host array would copy it to the device on every
  call."""
  a = np.asarray(arr, np.int64)
  key = (str(device), a.shape, a.tobytes())
  t = _IDX.get(key)
  if t is None:
    t = torch.as_tensor(a, device=device)
    _IDX[key] = t
  return t


def bmask(arr, device) -> torch.Tensor:
  """A static numpy mask as a bool tensor on ``device``, made once."""
  a = np.asarray(arr, bool)
  key = ('b', str(device), a.shape, a.tobytes())
  t = _IDX.get(key)
  if t is None:
    t = torch.as_tensor(a, device=device)
    _IDX[key] = t
  return t


def fmask(arr, like: torch.Tensor) -> torch.Tensor:
  """A static numpy mask or table as a tensor of ``like``'s dtype and
  device, made once."""
  a = np.asarray(arr)
  key = ('f', str(like.device), like.dtype, a.shape, a.dtype.str, a.tobytes())
  t = _IDX.get(key)
  if t is None:
    t = torch.as_tensor(a.astype(np.float64), device=like.device).to(like.dtype)
    _IDX[key] = t
  return t


# host reads of a device value by the general step, by what asked: the
# torch solver's loop tests ('solver'), the lazy island labeler's
# candidate test ('island'), the sleep pack's fit test ('pack') and the
# height-field ray walk's trip count ('ray')
host_reads = {'solver': 0, 'island': 0, 'pack': 0, 'ray': 0}


def host_item(x: torch.Tensor, what: str):
  """``x.item()`` of a device scalar, counted in ``host_reads[what]``: the
  host waits for the device there."""
  host_reads[what] += 1
  return x.item()
