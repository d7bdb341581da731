"""K1's and the mass chain's shared-memory fit on the CPU:
``kernels/k1.py`` and ``kernels/mass_chain.py``'s mirrors of the
kernels' per-world layouts (``world_floats``, held against
``csrc/k1.cu`` and ``csrc/mass_chain.cu``'s own counts by
``tests/test_torch_cuda.py`` on the card), the fused gate's size reason
for a model whose K1 world does not fit in one block (which
``benchmarks`` then steps on the general path), the general step's size
reason for a mass-chain world past one block, and the committed scenes,
which fit."""

import mujoco
import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, fused, io, types
from mujoco_warp_tpu_torch.kernels import k1 as kk1
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

# a free sphere over a plane carrying 4900 small geoms that collide with
# nothing: inside every other bound of the fused gate (ncand 1), its K1
# world holds 12 floats of frames per geom
_MANY_GEOMS = ''.join(
    ['<mujoco><option timestep="0.004"/><worldbody>'
     '<geom type="plane" size="3 3 .1"/><body pos="0 0 0.3"><freejoint/>'
     '<geom type="sphere" size="0.05"/>'] +
    [f'<geom type="sphere" size="0.01" pos="{0.001 * i} 0 0" contype="0" '
     'conaffinity="0"/>' for i in range(4900)] +
    ['</body></worldbody></mujoco>'])

# a hinged sphere and 760 welded bodies: 78 floats of the mass chain per
# body
_MANY_BODIES = ''.join(
    ['<mujoco><worldbody><body><joint type="hinge" axis="0 0 1"/>'
     '<geom type="sphere" size="0.05"/></body>'] +
    [f'<body pos="{0.01 * i} 0 0"><inertial pos="0 0 0" mass="0.1" '
     'diaginertia="1e-4 1e-4 1e-4"/></body>' for i in range(760)] +
    ['</worldbody></mujoco>'])

_SNAPSHOTS = {
    'humanoid': io.SNAPSHOT, 'eq_joint': io.EQ_JOINT_SNAPSHOT,
    'implicitfast': io.IMPLICITFAST_SNAPSHOT,
    'constraints': io.CONSTRAINTS_SNAPSHOT,
    'clutter_arm_nosleep': io.CLUTTER_SNAPSHOT, 'spheres': io.SPHERES_SNAPSHOT,
    'spheres_elliptic': io.SPHERES_ELLIPTIC_SNAPSHOT}


def test_k1_world_floats_of_the_humanoid_by_hand():
  """The humanoid (nq 28, nv 27, 17 bodies, 22 joints, 20 geoms, 177
  candidates): the frames' region (the geom frames, then the contacts in
  the floats of the body and joint frames), 2541 floats, is larger than
  the mass chain's with its factor (27 x 27 at row stride 27), 2496; two
  blocks of 8 worlds fit in an SM."""
  m = io.load_model_npz(device='cpu')
  assert (m.nq, m.nv, m.nbody, m.njnt, m.ngeom, m.ncand) == \
      (28, 27, 17, 22, 20, 177)
  base = (28 + 27 +      # qpos, qvel
          3 * 17 +       # subtree_com
          36 * 17 +      # cinert
          6 * 27 + 27)   # cdof, bias
  body = (3 * 17 + 4 * 17 + 3 * 17 + 9 * 17 +  # xpos, xquat, xipos, ximat
          3 * 22 + 3 * 22)                    # xanchor, xaxis
  contacts = 177 + 3 * 177 + 9 * 177          # dist, pos, frame
  frames = 3 * 20 + 9 * 20 + max(body, contacts)  # geom xpos, xmat
  chain = (27 * 27 +             # qM
           36 * 17 + 6 * 27 +    # crb, f
           6 * 17 + 6 * 27 +     # cvel, cdof_dot
           27 * 27)              # the factor
  assert (base, body, contacts, frames, chain) == (907, 455, 2301, 2541,
                                                    2496)
  for factor in (True, False):
    assert kk1.world_floats(28, 27, 17, 22, 20, 177, factor) == 3449
  assert kk1.world_bytes(m) == 4 * 3449 and kk1.fits(m)
  assert 2 * (8 * 4 * 3449 + 1024) <= 233472  # two blocks of 8 in an SM
  # collision off: no geom frames or contacts, the chain's region is larger
  assert kk1.world_floats(28, 27, 17, 22, 0, 0, True) == \
      (base + chain) | 1


@pytest.mark.parametrize('scene,nv,nbody,small,floats', [
    ('constraints', 13, 7, True, 975),
    ('spheres', 36, 7, True, 2599),
    ('clutter_arm_nosleep', 75, 16, False, 2749)])
def test_mass_chain_world_floats_by_hand(scene, nv, nbody, small, floats):
  """cinert, cdof, qvel, crb, f, cvel, cdof_dot and bias (78 floats per
  body, 20 per dof), and for the small tree qM, then its factor in the
  same floats, at row stride nv | 1; an odd count."""
  m = io.load_model_npz(_SNAPSHOTS[scene], device='cpu')
  assert (m.nv, m.nbody, not kmass.big_tree(m)) == (nv, nbody, small)
  n = 36 * nbody + 6 * nv + nv + 36 * nbody + 6 * nv + 6 * nbody + \
      6 * nv + nv
  if small:
    n += nv * (nv | 1)
  assert n | 1 == floats == kmass.world_floats(nbody, nv, small)
  assert kmass.world_bytes(m) == 4 * floats and kmass.fits(m)


def test_gate_refuses_a_k1_world_past_one_block():
  """A model inside every other bound of the fused gate whose K1 world
  does not fit in one block's shared memory is refused by its size, and
  benchmarks steps it on the general path."""
  m = io.put_model(mujoco.MjModel.from_xml_string(_MANY_GEOMS), device='cpu')
  assert m.nv <= fused.MAX_NV and m.nbody <= fused.MAX_NBODY
  assert m.ncand <= fused.MAX_NCAND and m.ngeom == 4902
  nbytes = kk1.world_bytes(m)
  assert nbytes == 4 * kk1.world_floats(m.nq, m.nv, m.nbody, m.njnt,
                                        m.ngeom, m.ncand, True)
  assert nbytes > ksolver.SMEM_BLOCK and not kk1.fits(m)
  why = fused.reason(m)
  assert why.startswith('size (K1 world'), why
  assert str(nbytes) in why and not fused.supported(m)
  assert forward.unsupported(m) is None
  d = next(benchmarks.rollout(m, 2, device='cpu'))
  assert isinstance(d, types.Data) and bool(torch.isfinite(d.qpos).all())


def test_general_step_refuses_a_mass_chain_world_past_one_block(
    monkeypatch):
  """A model whose mass-chain world does not fit in one block's shared
  memory is refused by the general step for its size (and, outside the
  fused gate too, by ``io.put_model``)."""
  mjm = mujoco.MjModel.from_xml_string(_MANY_BODIES)
  with pytest.raises(NotImplementedError, match='mass-chain world'):
    io.put_model(mjm, device='cpu')
  monkeypatch.setattr(io, 'check_supported', lambda m: None)
  m = io.put_model(mjm, device='cpu')
  assert (m.nv, m.nbody) == (1, 762) and kmass.big_tree(m)
  nbytes = kmass.world_bytes(m)
  assert nbytes == 4 * kmass.world_floats(762, 1, False)
  assert nbytes > ksolver.SMEM_BLOCK and not kmass.fits(m)
  why = forward.unsupported(m)
  assert why.startswith('size (mass-chain world'), why
  assert str(nbytes) in why


@pytest.mark.parametrize('scene', list(_SNAPSHOTS))
def test_committed_scenes_fit(scene):
  """Every committed scene's mass-chain world fits in a block, and K1's
  too for the gated scenes, which stay inside the fused gate; the others
  stay on the general step."""
  m = io.load_model_npz(_SNAPSHOTS[scene], device='cpu')
  assert kmass.fits(m)
  if scene in ('humanoid', 'eq_joint', 'implicitfast'):
    assert kk1.fits(m) and fused.reason(m) is None
  else:
    assert fused.reason(m) is not None and forward.unsupported(m) is None
