"""Gravity compensation, actuator gravity compensation, site-anchored
equality and the joint-in-parent transmission against the JAX package
and MuJoCo C, on mocap_arm at 8 worlds of ``test_torch_arm.seeded_c``
(every link compensated, the shoulder pitch through its actuator and its
actuatorfrcrange; the mocap target's site welded to the end-effector
site; a tool's site connected to the end-effector site; a joint-in-parent
actuator on the ball wrist).

One forward of the port (``forward._forward``: the step's stages up to
the solve) against the JAX ``fwd_position``, ``fwd_velocity`` and
``fwd_actuation`` under ``vmap`` at atol 1e-6 + rtol 1e-4 (efc_aref at
the world's scale, as ``test_torch_classic_step.check_stage`` holds it),
and against ``mj_forward`` world by world within 5e-4 (the weld's and
the connect's efc_J, efc_pos and efc_aref by C's equality rows).
"""

import functools

import jax
import mujoco
import numpy as np
import pytest

from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_arm import C_ATOL, W, both, case, seeded_c
from tests.test_torch_classic_step import fast_compile, world_scale
from tests.torch_threads import few_threads  # noqa: F401

ATOL, RTOL = 1e-6, 1e-4


@functools.lru_cache(maxsize=None)
def forwards():
  """(port Data, JAX Data, [MjData]) after one forward of each side."""
  _, mj, m = case()
  mjds = seeded_c(5)
  dj, d = both(mjds)
  fwd = fast_compile(jax.vmap(lambda x: jfwd.fwd_actuation(
      mj, jfwd.fwd_velocity(mj, jfwd.fwd_position(mj, x)))), dj)
  return forward._forward(m, d), fwd(dj), mjds


def _vs(got, dj, mjds, name, c_name=None):
  """``name`` against JAX and, per world, against C's ``c_name``."""
  assert_close(getattr(got, name).numpy(), np.asarray(getattr(dj, name)),
               name, ATOL, RTOL)
  want = np.stack([getattr(x, c_name or name) for x in mjds])
  np.testing.assert_allclose(getattr(got, name).numpy(),
                             want.reshape(getattr(got, name).shape),
                             atol=C_ATOL, err_msg=name)


def test_gravcomp_matches_jax_and_c():
  """qfrc_gravcomp of every link, and qfrc_passive, which leaves out the
  shoulder pitch's (its actuator takes it)."""
  d, dj, mjds = forwards()
  _, _, m = case()
  _vs(d, dj, mjds, 'qfrc_gravcomp')
  _vs(d, dj, mjds, 'qfrc_passive')
  pitch = int(m.jnt_dofadr[np.nonzero(m.jnt_actgravcomp)[0][0]])
  assert float(d.qfrc_gravcomp[:, pitch].abs().min()) > 0.1
  assert float(d.qfrc_passive[:, pitch].abs().max()) < \
      float(d.qfrc_gravcomp[:, pitch].abs().min())


def test_actuator_gravcomp_through_the_clamp():
  """qfrc_actuator: the pitch's compensation added before its
  actuatorfrcrange clamp, which binds in some worlds and not others."""
  d, dj, mjds = forwards()
  _, _, m = case()
  _vs(d, dj, mjds, 'qfrc_actuator')
  j = int(np.nonzero(m.jnt_actgravcomp)[0][0])
  dof, hi = int(m.jnt_dofadr[j]), float(types.host(m.jnt_actfrcrange)[j, 1])
  held = d.qfrc_actuator[:, dof].abs() >= hi - 1e-5
  assert 0 < int(held.sum()) < W


@pytest.mark.parametrize('kind', ['weld', 'connect'])
def test_site_equality_rows_match_jax_and_c(kind):
  """The site weld's six rows (its torque rows from the two sites'
  frames, not eq_data's relative pose) and the site connect's three:
  efc_J, efc_pos and efc_aref."""
  d, dj, mjds = forwards()
  _, _, m = case()
  lay = m.efc
  adr = lay.weld_adr if kind == 'weld' else lay.connect_adr
  eq = int((lay.weld_id if kind == 'weld' else lay.connect_id)[0])
  n = 6 if kind == 'weld' else 3
  rows = int(adr[0]) + np.arange(n)
  assert int(m.eq_objtype[eq]) == types.ObjType.SITE
  for k in ('efc_J', 'efc_pos'):
    assert_close(getattr(d, k)[:, rows].numpy(),
                 np.asarray(getattr(dj, k))[:, rows], k, ATOL, RTOL)
  world_scale(d.efc_aref[:, rows].numpy(), np.asarray(dj.efc_aref)[:, rows],
              'efc_aref')
  for w, mjd in enumerate(mjds):
    cr = np.nonzero((mjd.efc_type == mujoco.mjtConstraint.mjCNSTR_EQUALITY)
                    & (mjd.efc_id == eq))[0]
    assert len(cr) == n
    J = mjd.efc_J.reshape(mjd.nefc, -1)[cr]
    for name, got, want in (('efc_J', d.efc_J[w, rows], J),
                            ('efc_pos', d.efc_pos[w, rows], mjd.efc_pos[cr]),
                            ('efc_aref', d.efc_aref[w, rows],
                             mjd.efc_aref[cr])):
      scale = 1.0 if name != 'efc_aref' else max(1.0, np.abs(want).max())
      np.testing.assert_allclose(got.numpy(), want, atol=C_ATOL * scale,
                                 err_msg=f'{kind} {name} world {w}')
  assert float(d.efc_pos[:, rows].abs().max()) > 1e-3


def test_jointinparent_transmission_matches_jax_and_c():
  """actuator_moment and actuator_length of every actuator, the ball
  wrist's joint-in-parent one among them (its gear turned by each
  world's wrist quaternion)."""
  d, dj, mjds = forwards()
  mjm, _, m = case()
  _vs(d, dj, mjds, 'actuator_length')
  assert_close(d.actuator_moment.numpy(), np.asarray(dj.actuator_moment),
               'actuator_moment', ATOL, RTOL)
  for w, mjd in enumerate(mjds):
    moment = np.zeros((mjm.nu, mjm.nv))
    mujoco.mju_sparse2dense(moment, mjd.actuator_moment, mjd.moment_rownnz,
                            mjd.moment_rowadr, mjd.moment_colind)
    np.testing.assert_allclose(d.actuator_moment[w].numpy(), moment,
                               atol=C_ATOL, err_msg=f'world {w}')
  u = int(np.nonzero(m.actuator_trntype == types.TrnType.JOINTINPARENT)[0][0])
  gear = types.host(m.actuator_gear)[u, :3]
  dadr = int(m.jnt_dofadr[int(m.actuator_trnid[u, 0])])
  arm = d.actuator_moment[:, u, dadr:dadr + 3].numpy()
  assert np.abs(arm - gear).max() > 0.05
