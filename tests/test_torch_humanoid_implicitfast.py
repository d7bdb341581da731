"""The ``humanoid_implicitfast`` scene (the benchmark humanoid with
``opt.integrator=implicitfast``): the port's fused step (K1, glue and
K4's implicitfast factor, plain versions on the CPU) against the JAX
package's step on the same state, 32 worlds of the humanoid with its root
lowered 0.28 m into the floor (contacts live), one step, at the bars of
``tests/test_fused.py`` (qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol
5e-3).

The JAX side is its general ``forward.step`` (the jnp stages and
``derivative.implicit``), which ``tests/test_fused.py`` holds the JAX
fused step to at these bars.  The JAX fused step in interpret mode
(``step_lane(..., interpret=True)``) takes 37 s for one step on a CPU
(it interprets whole 128-world tiles; at 64 worlds its padded lanes come
back NaN), beyond what one test of this suite may take.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import benchmarks as jbench
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, fused, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.fused import k4_ref
from tests.oracle import assert_close
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

W = 32


def test_humanoid_implicitfast_step_matches_jax():
  mjm = jbench.load_humanoid_benchmark()
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST
  mj = jio.put_model(mjm, nconmax=tio.BENCH_NCONMAX)
  m, w = benchmarks.load_scene('humanoid_implicitfast', device='cpu')
  # the scene is the committed humanoid with the integrator set
  assert_models_equal(m, tio.put_model(mjm, tio.BENCH_NCONMAX,
                                       device='cpu'))
  assert w == 8192 and fused.supported(m) and k4_ref.damped(m)
  rng = np.random.default_rng(3)
  qpos = (types.host(m.qpos0, np.float32)[None] +
          0.01 * rng.standard_normal((W, m.nq))).astype(np.float32)
  qpos[:, 2] -= 0.28
  qvel = (0.2 * rng.standard_normal((W, m.nv))).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((W, m.nu))).astype(np.float32)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  # XLA's backend optimisations off: the compile is most of the time
  want = jax.jit(lambda x: jfwd.step(mj, x)).lower(dj).compile(
      {'xla_backend_optimization_level': 0})(dj)
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel),
                                                ctrl=t(ctrl))
  st = fused.step_lane(m, fused.to_lane(m, d))
  assert_close(st.qpos.T.numpy(), np.asarray(want.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(st.qvel.T.numpy(), np.asarray(want.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  assert int(st.overflow.max()) == 0
  assert float(st.solver_niter.float().mean()) > 1.0
