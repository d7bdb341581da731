"""RK4 with sleep on the general step: each stage forward runs the wake
pass first, as the JAX ``_forward`` does (``forward.py:607-610``).

clutter.xml (12 free bodies, sleep on; its committed snapshot under
``opt.integrator = RK4``, equal to ``put_model`` of the XML so set) at 8
worlds of the committed settled state, each sleeping tree woken with
probability 0.5 (``parity.woken_state``), three steps against the JAX
``forward.step`` from the same state: ``tree_asleep`` equal at every
step, qpos within atol 2e-4 + rtol 1e-3 and qvel within 5e-3 + 5e-3 (the
sleep tests' bars), no overflow.

Where the port departs from the JAX step: a stage forward's qacc is
zeroed on the sleeping dofs, as the step zeroes the t0 forward's.  The
JAX stages keep it, so that its RK4 moves a tree that sleeps through the
step by its stages' accelerations (~2e-5 a step here), while its own skip
step leaves the same tree where it was.  The test asserts that on both
sides: the port's sleeping trees stay within 1e-7 of their start, the
JAX step's move by more than 1e-6.

The skip step under RK4 (``forward._step_sleep_skip``, which ``step``
takes at 256 worlds and more, here called at 8): with one world pushed
awake its four stage forwards run on the pack of W // 4 slots, and the
result equals the full step's (``tree_asleep`` equal, qpos within 1e-6,
time within 1e-5), as ``test_torch_sleep_step.py`` holds the Euler
skip step.
"""

import functools

import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_classic_step import fast_compile
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

W = 8
RK4 = int(types.IntegratorType.RK4)


@functools.lru_cache(maxsize=None)
def models():
  mjm = mujoco.MjModel.from_xml_path(tio.CLUTTER_SLEEP_XML)
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
  nc = tio.CLUTTER_SLEEP_NCONMAX
  m = tio.load_model_npz(tio.CLUTTER_SLEEP_SNAPSHOT, device='cpu')
  m = m.replace(opt=m.opt.replace(integrator=RK4))
  assert_models_equal(m, tio.put_model(mjm, nconmax=nc, device='cpu'))
  return jio.put_model(mjm, nconmax=nc), m


def test_rk4_with_sleep_matches_jax():
  mj, m = models()
  assert forward.unsupported(m) is None
  st = {k: v[:W] for k, v in tio.load_state(tio.CLUTTER_SETTLED).items()}
  st = parity.woken_state(m, st, np.random.default_rng(0))
  a0 = st['tree_asleep']
  assert 0 < int((a0 < 0).sum()) < a0.size
  dj = jio.make_data(mj, nworld=W).replace(
      **{k: jnp.asarray(v) for k, v in st.items()})
  d = tio.make_data(m, W, device='cpu').replace(
      **{k: torch.as_tensor(v) for k, v in st.items()})
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  # the trees that sleep through all three steps
  slept = torch.as_tensor(a0 >= 0)
  q0 = d.qpos.clone()
  for k in range(3):
    dj, d = step(dj), forward.step(m, d)
    slept &= d.tree_asleep >= 0
    np.testing.assert_array_equal(d.tree_asleep.numpy(),
                                  np.asarray(dj.tree_asleep),
                                  err_msg=f'tree_asleep, step {k}')
    assert_close(d.qpos.numpy(), np.asarray(dj.qpos), f'qpos {k}', 2e-4,
                 1e-3)
    assert_close(d.qvel.numpy(), np.asarray(dj.qvel), f'qvel {k}', 5e-3,
                 5e-3)
  assert int(d.overflow.max()) == 0
  # trees woken near ready fell asleep
  assert int(((a0 < 0) & (d.tree_asleep.numpy() >= 0)).sum()) > 0
  body_tree = np.asarray(m.body_treeid)
  qadr = np.asarray(m.jnt_qposadr)
  cols = np.stack([qadr + i for i in range(7)], 1)  # each tree's free joint
  trees = body_tree[np.asarray(m.jnt_bodyid)]
  moved_port = (d.qpos - q0).abs()[:, cols].amax(-1)  # (W, ntree joints)
  moved_jax = np.abs(np.asarray(dj.qpos) - q0.numpy())[:, cols].max(-1)
  asleep = slept[:, trees].numpy()
  assert asleep.sum() > 10
  assert float(moved_port.numpy()[asleep].max()) < 1e-7
  assert float(moved_jax[asleep].max()) > 1e-6


def test_rk4_skip_step_equals_the_full_step():
  _, m = models()
  mp, d0 = parity.pushed_clutter(W, 1, device='cpu')
  mp = mp.replace(opt=mp.opt.replace(integrator=RK4))
  n0 = forward.packed_steps
  a = forward._step_sleep_skip(mp, d0)
  assert forward.packed_steps == n0 + 1
  b = forward._step_batched(mp, d0)
  np.testing.assert_array_equal(a.tree_asleep.numpy(), b.tree_asleep.numpy())
  assert float((a.qpos - b.qpos).abs().max()) < 1e-6
  assert float((a.time - b.time).abs().max()) < 1e-5
  assert float((a.qpos - d0.qpos).abs().max()) > 1e-6
