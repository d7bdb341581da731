"""The delay histories of actuator ctrl and sensor readings, world-major.

Counterpart of ``mujoco_warp_tpu/ops/history.py``: ``_read_channel``
(:31; zero-order hold, linear and cubic interpolation), ``_insert_channel``
(:87), ``insert_ctrl_history`` (:103), ``read_ctrl_delayed`` (:117),
``apply_sensor_delay`` (:134, with the sampling of ``sensor_interval``)
and ``init_history`` (:172).  ``Data.history`` (W, nhistory) holds each
channel as MuJoCo C lays it out, ``[unused, cursor, times[n],
values[n dim]]``: a circular buffer of n samples whose cursor (a float)
points at the newest.  A channel's offset, n and dim are static, so each
channel is one gather over every world; the time search is a masked
first-match over the n samples, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types

_EPS = 1e-6


def _channel(hist, off: int, n: int, dim: int):
  """(cursor (W,) int64, times (W, n), values (W, n, dim)) of the channel
  at ``off``."""
  cursor = hist[:, off + 1].long()
  times = hist[:, off + 2:off + 2 + n]
  values = hist[:, off + 2 + n:off + 2 + n + n * dim].reshape(-1, n, dim)
  return cursor, times, values


def _read_channel(hist, off: int, n: int, dim: int, t, interp: int):
  """Each world's reading (W, dim) of the channel at time t (W,): the
  samples put oldest to newest, the first not older than t found, and
  the two around it interpolated (``history.py:31``)."""
  cursor, times, values = _channel(hist, off, n, dim)
  phys = (cursor[:, None] + 1 + torch.arange(n, device=hist.device)) % n
  t_s = torch.gather(times, 1, phys)  # oldest .. newest
  v_s = torch.gather(values, 1, phys[..., None].expand(-1, -1, dim))
  ge = t_s >= t[:, None]
  i = torch.where(ge.any(1), torch.argmax(ge.to(torch.int8), 1),
                  torch.full_like(cursor, n))
  ic = torch.clamp(i, 1, n - 1)
  at_t = lambda k: torch.gather(t_s, 1, k[:, None])[:, 0]
  at_v = lambda k: torch.gather(v_s, 1, k[:, None, None].expand(
      -1, 1, dim))[:, 0]
  t_lo, t_hi = at_t(ic - 1), at_t(ic)
  v_lo, v_hi = at_v(ic - 1), at_v(ic)
  dt = torch.clamp(t_hi - t_lo, min=_EPS)
  alpha = ((t - t_lo) / dt)[:, None]
  if interp == 0:  # zero-order hold
    v = v_lo
  elif interp == 1:  # linear
    v = v_lo + alpha * (v_hi - v_lo)
  else:  # cubic Hermite, Catmull-Rom slopes, zero at the ends
    a2 = alpha * alpha
    a3 = a2 * alpha
    h00 = 2 * a3 - 3 * a2 + 1
    h10 = a3 - 2 * a2 + alpha
    h01 = -2 * a3 + 3 * a2
    h11 = a3 - a2
    im2 = torch.clamp(ic - 2, 0, n - 1)
    ip1 = torch.clamp(ic + 1, 0, n - 1)
    m_lo = torch.where((ic > 1)[:, None], (v_hi - at_v(im2)) / torch.clamp(
        t_hi - at_t(im2), min=_EPS)[:, None], 0.0)
    m_hi = torch.where((ic < n - 1)[:, None], (at_v(ip1) - v_lo) /
                       torch.clamp(at_t(ip1) - t_lo, min=_EPS)[:, None], 0.0)
    dtc = dt[:, None]
    v = h00 * v_lo + h10 * dtc * m_lo + h01 * v_hi + h11 * dtc * m_hi
  col = lambda c: c[:, None]
  v = torch.where(col(torch.abs(t - t_hi) < _EPS), v_hi, v)
  v = torch.where(col(t <= t_s[:, 0] + _EPS), v_s[:, 0], v)
  return torch.where(col(t >= t_s[:, n - 1] - _EPS), v_s[:, n - 1], v)


def _insert_channel(hist, off: int, n: int, dim: int, t, value, where=None):
  """``hist`` with (W, dim) ``value`` put at time t (W,) into the
  channel: over the newest sample where t matches its time, else into
  the next slot, the cursor advanced (``history.py:87``); only in the
  worlds of ``where`` (W,) bool, when given.  Returns a new tensor."""
  cursor, times, _ = _channel(hist, off, n, dim)
  newest = torch.gather(times, 1, cursor[:, None])[:, 0]
  cur = torch.where(torch.abs(t - newest) >= _EPS, (cursor + 1) % n, cursor)
  out = hist.clone()
  rows = torch.arange(hist.shape[0], device=hist.device)
  out[:, off + 1] = cur.to(hist.dtype)
  out[rows, off + 2 + cur] = t.to(hist.dtype)
  cols = off + 2 + n + cur[:, None] * dim + torch.arange(
      dim, device=hist.device)
  out[rows[:, None], cols] = value.to(hist.dtype)
  return out if where is None else torch.where(where[:, None], out, hist)


def _delay(x) -> float:
  return float(np.asarray(x, np.float64).reshape(-1)[0])


def insert_ctrl_history(m: types.Model, d: types.Data) -> types.Data:
  """Each actuator's ctrl put into its channel at d.time
  (``history.py:103``)."""
  if m.nhistory == 0 or not m.nu:
    return d
  hist = d.history
  for u in range(m.nu):
    n = int(m.actuator_history[u, 0])
    if n:
      hist = _insert_channel(hist, int(m.actuator_historyadr[u]), n, 1,
                             d.time, d.ctrl[:, u:u + 1])
  return d.replace(history=hist)


def read_ctrl_delayed(m: types.Model, d: types.Data) -> torch.Tensor:
  """ctrl (W, nu), each actuator with a delay read from its channel at
  d.time - delay (``history.py:117``)."""
  if m.nhistory == 0 or not m.nu:
    return d.ctrl
  ctrl = d.ctrl
  for u in range(m.nu):
    n = int(m.actuator_history[u, 0])
    delay = _delay(m.actuator_delay[u])
    if n == 0 or delay == 0.0:
      continue
    t = d.time - torch.tensor(delay, dtype=d.time.dtype, device=d.time.device)
    v = _read_channel(d.history, int(m.actuator_historyadr[u]), n, 1, t,
                      int(m.actuator_history[u, 1]))
    ctrl = ctrl.clone() if ctrl is d.ctrl else ctrl
    ctrl[:, u] = v[:, 0]
  return ctrl


def apply_sensor_delay(m: types.Model, d: types.Data) -> types.Data:
  """Each sensor with a history: its reading replaced by its channel's at
  d.time - delay, then the fresh reading put into the channel, on the
  interval's grid (within half a timestep) where the sensor has one
  (``history.py:134``)."""
  if m.nhistory == 0 or not m.nsensor:
    return d
  sd, hist = d.sensordata.clone(), d.history
  dev, fdt = d.time.device, d.time.dtype
  h = float(types.host(m.opt.timestep))
  for s in range(m.nsensor):
    n = int(m.sensor_history[s, 0])
    if n == 0:
      continue
    off = int(m.sensor_historyadr[s])
    adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    interval = _delay(m.sensor_interval[s])
    fresh = sd[:, adr:adr + dim].clone()
    t = d.time - torch.tensor(_delay(m.sensor_delay[s]), dtype=fdt,
                              device=dev)
    sd[:, adr:adr + dim] = _read_channel(hist, off, n, dim, t,
                                         int(m.sensor_history[s, 1]))
    on_grid = None
    if interval > 0:
      hh = torch.tensor(h, dtype=fdt, device=dev)
      phase = torch.fmod(d.time + 0.5 * hh, torch.tensor(
          interval, dtype=fdt, device=dev))
      on_grid = phase < hh
    hist = _insert_channel(hist, off, n, dim, d.time, fresh, on_grid)
  return d.replace(sensordata=sd, history=hist)


def init_history(m: types.Model, d: types.Data) -> types.Data:
  """Every channel filled with the current ctrl or sensor reading at
  times far in the past, its cursor at its last sample
  (``history.py:172``): the stamps -1e9 + k are rounded to float32, as
  the JAX function rounds them."""
  if m.nhistory == 0:
    return d
  hist = d.history.clone()

  def prefill(off, n, dim, value):
    times = (-1e9 + np.arange(n)).astype(np.float32)
    hist[:, off + 2:off + 2 + n] = torch.as_tensor(
        times, device=hist.device).to(hist.dtype)
    hist[:, off + 2 + n:off + 2 + n + n * dim] = value.to(hist.dtype).repeat(
        1, n)
    hist[:, off + 1] = float(n - 1)

  for u in range(m.nu):
    n = int(m.actuator_history[u, 0])
    if n:
      prefill(int(m.actuator_historyadr[u]), n, 1, d.ctrl[:, u:u + 1])
  for s in range(m.nsensor):
    n = int(m.sensor_history[s, 0])
    if n:
      adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
      prefill(int(m.sensor_historyadr[s]), n, dim,
              d.sensordata[:, adr:adr + dim])
  return d.replace(history=hist)
