"""Why the JAX jnp Newton stalls on elliptic cones (ROADMAP queue 3): its
``_update_constraint`` (``mujoco_warp_tpu/ops/solver.py:146-178``) pads
each elliptic contact's rows to the largest condim with row address 0
and scatters the cone forces and states back with ``.at[ell_adr].set``;
where condims differ (spheres_elliptic: 3, 4 and 6) the padded entries
write row 0's old value over its cone force, so the force and state of
row 0, an elliptic normal row, stay pyramidal.  The Newton then descends
a cost whose gradient disagrees with its forces.

On the port's float32 system of ``parity.spheres_state`` (seed 0, 128
worlds): the JAX solve as it stands runs 15 worlds to its 100-iteration
cap and agrees with the port's Newton count in 22.7% of worlds; with the
padded entries sent out of range and dropped (a copy of the JAX
function, made here, not in the JAX package), no world caps and the
counts agree in every world.  The port's elliptic update scatters only
its real rows."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import solver as jsolver
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from mujoco_warp_tpu_torch.ops import solver as osolver
from tests.test_torch_classic_step import fast_compile
from tests.torch_threads import few_threads  # noqa: F401

W = 128
_FIELDS = ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qM', 'qLD',
           'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart', 'qpos')


@functools.lru_cache(maxsize=None)
def system():
  """(JAX Model, JAX Data and port Data holding the port's float32
  system, the port's Newton counts) on spheres_elliptic."""
  mjm = tio.load_spheres(types.ConeType.ELLIPTIC)
  m, mj = tio.put_model(mjm, device='cpu'), jio.put_model(mjm)
  qpos, qvel, ctrl = parity.spheres_state(m, W, 0)
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel),
                                                ctrl=t(ctrl))
  d = forward.mid(m, kmass.mass_chain(m, forward.pre(m, d)))
  d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                       d.qfrc_smooth))
  dj = jio.make_data(mj, nworld=W)
  f = lambda x: jnp.asarray(x.numpy())
  dj = dj.replace(contact=dj.contact.replace(friction=f(d.contact.friction)),
                  **{k: f(getattr(d, k)) for k in _FIELDS})
  return mj, dj, osolver.solve(m, d).solver_niter.numpy()


def _dropping(monkeypatch):
  """The JAX solver with its padded elliptic entries sent out of range
  and dropped by the scatter."""
  st0 = jsolver._static_tables

  def static_tables(m):
    st = st0(m)
    return st._replace(ell_adr=np.where(st.ell_mask, st.ell_adr, m.nefc))

  src = inspect.getsource(jsolver._update_constraint)
  for k in ('force', 'state'):
    old = f'{k}[st.ell_adr]))'
    assert src.count(old) == 1, old
    src = src.replace(old, f"{k}[st.ell_adr]), mode='drop')")
  ns = dict(vars(jsolver))
  exec(compile(src, jsolver.__file__, 'exec'), ns)
  monkeypatch.setattr(jsolver, '_static_tables', static_tables)
  monkeypatch.setattr(jsolver, '_update_constraint',
                      ns['_update_constraint'])


@pytest.mark.parametrize('dropped', [False, True])
def test_jax_elliptic_stall_is_the_padded_scatter(dropped, monkeypatch):
  mj, dj, port = system()
  if dropped:
    _dropping(monkeypatch)
  want = np.asarray(fast_compile(jax.vmap(lambda x: jsolver.solve(mj, x)),
                                 dj)(dj).solver_niter)
  capped = int((want >= mj.opt.iterations).sum())
  share = float((want == port).mean())
  if dropped:
    assert capped == 0 and share == 1.0, (capped, share)
  else:
    assert capped >= 10 and share < 0.5, (capped, share)
