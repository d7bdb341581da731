"""Distinct values per world of the fields ``io.batch_model`` takes since
the placement, solver, option, camera, light, tendon, actuation and
height-field fields became batchable, held against the JAX batched step
(``jio.batch_model`` + ``jfwd.step``, compiled once per scene group with
XLA's backend optimisations off): the port's batched Model from the same
numpy draws, one step from the same state, qacc and qpos at parity's bars
(``QACC_*``, ``QPOS_*``, each world at its own scale), and where a group
reads them the sensors (``parity.check_sensors``).

- constraints: the body, joint, geom and site placement, the joint, dof
  and equality solver parameters, the joint ranges, margins,
  stiffnesses and spring poses, impratio and both solver tolerances,
  then ``io.set_const`` on both sides (``test_torch_batch_model
  ._against_jax``: its outputs too);
- tendon_mix: the eleven tendon fields;
- sensors_general: the cameras' intrinsics, the sites' sizes and the
  magnetic field, read by its sensors;
- camlight: the camera and light placement (their frames);

and in ``test_torch_batch_fields_step.py`` (a file of its own, to share
the compile time across workers):

- fluid_ellipsoid: wind, density and viscosity;
- mocap_arm: gravity compensation and the joints' actuator force ranges;
- actuator_mix: activation ranges and muscle length ranges.
"""

import jax
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_batch_model import _against_jax, _jax_step, _np, \
    close_world
from tests.torch_threads import few_threads  # noqa: F401

W = 3


def _mjm(name):
  if name == 'quadruped_escape':
    pytest.importorskip('dm_control')
    return tio.load_dmc('quadruped_escape')
  xml = {'constraints': tio.CONSTRAINTS_XML,
         'tendon_mix': tio.TENDON_XML['tendon_mix'],
         'mocap_arm': tio.ARM_XML['mocap_arm'],
         'actuator_mix': tio.ACT_XML['actuator_mix']}.get(
             name, f'{tio._ASSETS}/{name}.xml')
  return mujoco.MjModel.from_xml_path(xml)


def _draw(m, names, seed):
  """{field: (W, ...)}: each named field of ``m`` with world 0 at its
  value and the others scaled by U(0.8, 1.2) entry by entry (unit
  quaternions and axes rotated a little instead)."""
  rng = np.random.default_rng(seed)
  out = {}
  for n in names:
    x = types.host(types.get_model_field(m, n))
    v = np.repeat(x[None], W, 0)
    if n.endswith('quat') or n.endswith('axis') or n in ('light_dir',
                                                         'light_dir0'):
      v[1:] += rng.uniform(-0.05, 0.05, v[1:].shape)
      v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    else:
      v[1:] *= rng.uniform(0.8, 1.2, v[1:].shape)
    out[n] = v
  return out


def _check(name, mjm, m, mb, fields, d, sensors=False):
  """The port's step of ``mb`` from ``d`` against the JAX batched step
  of the same draws at parity's bars."""
  got = forward.step(mb, d)
  mjb = jio.batch_model(jio.put_model(mjm), W, fields)
  dj = jio.make_data(mjb, nworld=W).replace(
      **{k: jax.numpy.asarray(_np(getattr(d, k)))
         for k in ('qpos', 'qvel', 'ctrl', 'act', 'mocap_pos', 'mocap_quat')
         if getattr(d, k) is not None and getattr(d, k).numel()})
  if m.ntendon:
    # the JAX tendon friction rows read the previous step's ten_velocity
    # (ROADMAP queue 3): give them this step's
    ten_J = forward.pre(mb, d).ten_J
    dj = dj.replace(ten_velocity=jax.numpy.asarray(_np(torch.einsum(
        'wtv,wv->wt', ten_J, d.qvel))))
  dj = _jax_step(mjb, dj)
  close_world(got.qacc, dj.qacc, f'{name}: qacc against JAX')
  close_world(got.qpos, dj.qpos, f'{name}: qpos against JAX', True)
  if sensors and m.nsensordata:
    parity.check_sensors(m, got.sensordata, torch.as_tensor(
        _np(dj.sensordata)), got.solver_niter, torch.as_tensor(
            _np(dj.solver_niter)), None, 'contact', m.opt.iterations)
  return got, dj


def _state(m, seed=3):
  qpos, qvel, ctrl = parity.general_state(m, W, seed)
  return tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(0.5 * qvel),
      ctrl=torch.as_tensor(ctrl))


# the placement, joint, dof and equality fields of constraints.xml
_CONSTRAINTS = ('body_pos', 'body_quat', 'body_iquat', 'jnt_pos',
                'jnt_axis', 'geom_pos', 'geom_quat', 'site_pos',
                'site_quat', 'jnt_solref', 'jnt_solimp', 'jnt_range',
                'jnt_margin', 'jnt_stiffness', 'qpos_spring', 'dof_solref',
                'dof_solimp', 'eq_solref', 'eq_solimp')


def test_constraints_placement_and_solver_fields():
  """The placement and solver fields, impratio and tolerances per world,
  then set_const on both sides (its outputs held too)."""
  mjm = _mjm('constraints')
  m = tio.put_model(mjm, device='cpu')
  fields = _draw(m, _CONSTRAINTS, 1)
  # springs that act: stiffness drawn about 1 on every joint
  fields['jnt_stiffness'] = np.random.default_rng(2).uniform(
      0.5, 1.5, (W, m.njnt))
  fields['opt.impratio'] = np.asarray([1.0, 2.5, 4.0])
  fields['opt.tolerance'] = np.asarray([1e-6, 1e-5, 1e-4])
  fields['opt.ls_tolerance'] = np.asarray([0.01, 0.005, 0.05])
  mb = tio.set_const(tio.batch_model(m, W, fields))
  assert {'body_invweight0', 'eq_data'} <= set(mb.batch_fields)
  qpos, qvel, ctrl = parity.general_state(m, W, 5)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  got = forward.step(mb, d)
  _against_jax(mjm, mb, W, fields, qpos, qvel, ctrl, got)


@pytest.mark.parametrize('name,names,sensors', [
    ('tendon_mix', ('tendon_solref_lim', 'tendon_solimp_lim',
                    'tendon_solref_fri', 'tendon_solimp_fri', 'tendon_range',
                    'tendon_actfrcrange', 'tendon_margin', 'tendon_stiffness',
                    'tendon_damping', 'tendon_armature',
                    'tendon_frictionloss'), True),
    ('sensors_general', ('cam_fovy', 'cam_intrinsic', 'cam_sensorsize',
                         'site_size', 'opt.magnetic', 'site_pos'), True),
    ('camlight', ('cam_pos', 'cam_quat', 'cam_poscom0', 'cam_pos0',
                  'light_pos', 'light_dir', 'light_poscom0', 'light_pos0',
                  'light_dir0'), False),
])
def test_scene_group(name, names, sensors):
  mjm = _mjm(name)
  m = tio.put_model(mjm, device='cpu')
  fields = _draw(m, names, 7)
  if name == 'tendon_mix':  # a spring and a damper on every tendon
    fields['tendon_stiffness'] = np.random.default_rng(8).uniform(
        1.0, 5.0, (W, m.ntendon))
  if name == 'fluid_ellipsoid':  # a wind that differs in direction
    fields['opt.wind'] = np.asarray([[0.0, 0.0, 0.0], [1.0, -0.5, 0.2],
                                     [-2.0, 0.3, 0.0]])
  mb = tio.batch_model(m, W, fields)
  got, dj = _check(name, mjm, m, mb, fields, _state(m), sensors)
  if name == 'camlight':
    for k in ('cam_xpos', 'cam_xmat', 'light_xpos', 'light_xdir'):
      np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(dj, k)),
                                 rtol=1e-4, atol=1e-5, err_msg=k)
