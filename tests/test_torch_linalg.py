"""The plain versions of the general step's Cholesky-solve kernels
against the JAX Pallas kernels in interpret mode, at 128 worlds and nv 13
(the constraints scene's mass matrices at the parity state).

``chol_solve_batched`` (x = (L L^T)^-1 b) and ``damped_solve_batched``
((M + h diag(damping))^-1 M qacc) call the JAX functions directly.  Each
takes its operands in the layouts the kernels read in place: world-
major, a ``world()`` view of lanes-last, and every other world of a
world-major tensor twice as wide whose other worlds are NaN (``layout``);
the JAX reference is computed once for all.  On the CPU the wrappers hand
the plain version views of the operands' storage at the strides the
kernel takes, so each layout is its own read.  Bar: atol 1e-5 + rtol
1e-4 of each world's largest |x| (the same lane Cholesky and
substitutions, summed in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu.pallas import linalg as plinalg
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.fused import k4_ref
from mujoco_warp_tpu_torch.kernels import lanes, world
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_smooth import states
from tests.torch_threads import few_threads  # noqa: F401


@functools.lru_cache(maxsize=None)
def mass_matrices():
  mj, m, dj, d = states(128, 2)
  d = kmass.mass_chain(m, forward.pre(m, d))
  rng = np.random.default_rng(3)
  b = rng.standard_normal((128, m.nv)).astype(np.float32)
  return mj, m, d, b


LAYOUTS = ['world', 'lanes', 'strided']


def layout(x, kind):
  """World-major (W, ...) x, contiguous ('world'), as a ``world()`` view
  of its lanes-last copy ('lanes'), or as every other world of a tensor
  twice as wide whose other worlds are NaN ('strided'), which a read at
  the wrong world stride turns into NaN."""
  if kind == 'world':
    return x.contiguous()
  if kind == 'strided':
    wide = torch.full((2 * x.shape[0],) + tuple(x.shape[1:]), float('nan'),
                      dtype=x.dtype)
    wide[::2] = x
    return wide[::2]
  return world(lanes(x, int(np.prod(x.shape[1:]))), *x.shape[1:])


@functools.lru_cache(maxsize=None)
def pallas_chol_solve():
  mj, m, d, b = mass_matrices()
  return plinalg.chol_solve_batched(mj, jnp.asarray(d.qLD.numpy()),
                                    jnp.asarray(b), interpret=True)


@functools.lru_cache(maxsize=None)
def pallas_damped_solve():
  mj, m, d, b = mass_matrices()
  return plinalg.damped_solve_batched(
      mj, jnp.asarray(d.qM.numpy()), mj.dof_damping, mj.opt.timestep,
      jnp.asarray(b), interpret=True)


def check(got, want, name):
  parity.check_world_scale(got.T, np.asarray(want).T, name,
                           parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.parametrize('kind', LAYOUTS)
def test_chol_solve_matches_pallas_interpret(kind):
  _, m, d, b = mass_matrices()
  n = klinalg.launches['chol_solve']
  got = klinalg.chol_solve_batched(m, layout(d.qLD, kind),
                                   layout(torch.as_tensor(b), kind))
  assert klinalg.launches['chol_solve'] == n
  check(got, pallas_chol_solve(), 'chol_solve')


@pytest.mark.parametrize('kind', LAYOUTS)
def test_damped_solve_matches_pallas_interpret(kind):
  _, m, d, b = mass_matrices()
  assert k4_ref.damped(m)
  got = klinalg.damped_solve_batched(m, layout(d.qM, kind),
                                     layout(torch.as_tensor(b), kind))
  check(got, pallas_damped_solve(), 'damped_solve')


@pytest.mark.parametrize('kind', ['world', 'lanes'])
@pytest.mark.parametrize('name', ['chol_solve', 'damped_solve'])
def test_cholesky_solves_cpu_read_in_place(name, kind, monkeypatch):
  """On the CPU the plain version gets views of the operands' own storage
  at the kernel's strides, not copies."""
  _, m, d, b = mass_matrices()
  mat = layout(d.qLD if name == 'chol_solve' else d.qM, kind)
  vec = layout(torch.as_tensor(b), kind)
  seen = []
  plain = getattr(klinalg, f'{name}_plain')

  def spy(x, y, *rest):
    seen.append((x.untyped_storage().data_ptr(), x.stride(),
                 y.untyped_storage().data_ptr(), y.stride()))
    return plain(x, y, *rest)

  monkeypatch.setattr(klinalg, f'{name}_plain', spy)
  getattr(klinalg, f'{name}_batched')(m, mat, vec)
  W, n = vec.shape
  # (element stride, world stride) of each read
  st = {'world': ((1, n * n), (1, n)), 'lanes': ((W, 1), (W, 1))}[kind]
  assert seen == [(mat.untyped_storage().data_ptr(), st[0],
                   vec.untyped_storage().data_ptr(), st[1])]


def test_damped_solve_checks_n_on_cpu():
  """n other than the model's nv raises before the plain version runs."""
  _, m, d, b = mass_matrices()
  n = m.nv - 1
  with pytest.raises(ValueError, match='model nv'):
    klinalg.damped_solve_batched(m, d.qM[:, :n, :n].contiguous(),
                                 torch.as_tensor(b[:, :n]))
