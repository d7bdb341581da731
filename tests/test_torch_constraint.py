"""The general step's constraint rows against the JAX ``make_constraint``
on the constraints scene: connect, weld (torquescale, relpose) and joint
(polycoef) equality rows, dof friction-loss rows and joint limits.

Both sides start from the same seeded state at 16 worlds; the JAX side
runs ``fwd_position`` (whose com_vel feeds the Jacobian-dot terms), the
port its position stages and plain mass chain.  Bars: every row field
within 1e-4 of its largest magnitude (float32 Jacobians and reference
accelerations summed in another order), the active mask equal.
"""

import jax
import numpy as np
import pytest

from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import constraint, forward
from tests.test_torch_smooth import states
from tests.torch_threads import few_threads  # noqa: F401

RTOL = 1e-4


@pytest.mark.parametrize('seed', [0, 1])
def test_make_constraint_matches_jax(seed):
  mj, m, dj, d = states(16, seed)
  dj = jax.jit(jax.vmap(lambda x: jfwd.fwd_position(mj, x)))(dj)
  d = constraint.make_constraint(m, kmass.mass_chain(m, forward.pre(m, d)))
  CT = types.ConstraintType
  kinds = set(int(t) for t in m.efc.efc_type)
  assert kinds == {int(CT.EQUALITY), int(CT.FRICTION_DOF),
                   int(CT.LIMIT_JOINT)}
  assert len(m.efc.connect_id) == len(m.efc.weld_id) == \
      len(m.efc.joint_id) == 1
  np.testing.assert_array_equal(d.efc_active.numpy(),
                                np.asarray(dj.efc_active))
  for name in ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'efc_pos',
               'efc_margin'):
    want = np.asarray(getattr(dj, name))
    np.testing.assert_allclose(
        getattr(d, name).numpy(), want, rtol=0.0,
        atol=RTOL * max(1.0, float(np.abs(want).max())), err_msg=name)
