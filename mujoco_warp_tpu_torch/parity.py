"""Seeded states and the tolerances that hold the port's kernels to a
reference.

One set of bars for every comparison of the port: its CUDA kernels
against their plain PyTorch versions (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and its plain versions against the JAX
package (``tests/test_torch_k4.py``).  Each check raises AssertionError
with the output's name and by how much it missed.

- K1: every output within ``K1_TOL`` of max(1, max |reference|).  Both
  sides compute the same float32 kinematics, summed in another order;
  closest points of near-parallel capsules amplify rounding.
- K4: qacc, warmstart and the velocity step / h within ``QACC_ATOL`` plus
  ``QACC_RTOL`` of the world's largest |reference| (the Newton stop is a
  norm test, so agreement is relative to the world's scale); qpos within
  ``QPOS_ATOL`` + ``QPOS_RTOL`` |reference| elementwise.
- Newton counts: equal in ``NITER_SHARE[state]`` of worlds, and never
  more than ``NITER_MAX_DIFF`` apart.  At rest (free fall, no contact)
  they agree almost everywhere.  In contact the bracketed linesearch
  accepts or rejects the exact minimizer on the sign of a slope that is
  zero up to rounding, so a world may take one iteration more on one
  side (also in float64), and from there a different path: of 1024
  contact worlds (16 seeds of 64) the JAX solve and the plain port
  differed by one iteration in 63 and by two in 2, in both directions
  about equally.  The qacc of every world still meets the bar above.
- The general step's kernels (``constraints`` scene): the mass chain
  within ``K1_TOL`` of max(1, max |reference|) per output, as K1's mass
  chain; the two Cholesky solves within ``SOLVE_ATOL`` + ``SOLVE_RTOL`` of
  the world's largest |reference| (one factor and two substitutions,
  summed in another order); the Newton solve's qacc, efc_force and
  qfrc_constraint at the K4 bars above.  Its Newton counts have their own
  bar, 'constraints': most worlds of that scene stop after one Newton
  step, on a stop test (improvement, gradient or model improvement below
  the tolerance) that lands within rounding of the tolerance in a few
  percent of worlds, so one more iteration on one side.  Over 8 seeds of
  128 worlds on a CPU, the JAX package's own two solvers
  (its jnp Newton and its Pallas kernel in interpret mode) agreed in
  96.1-99.2% of worlds and the plain port and the Pallas kernel in
  92.2-99.2%, never more than one iteration apart, with qacc within the
  bars above.
- The large-tree kernels (``clutter_arm_nosleep``, seeded by
  ``clutter_state``): the large-tree mass chain's qM, cvel, cdof_dot and
  bias within ``K1_TOL`` of max(1, max |reference|), as the small form
  (the same float32 sums, no factor); ``chol_batched``'s L, and
  ``chol_solve`` and ``damped_solve`` at n 75, within ``SOLVE_ATOL`` +
  ``SOLVE_RTOL`` of the world's largest |reference| (the same right-
  looking updates and substitutions; the factor is a 75-step chain of
  rank-1 updates, so its rounding grows with n, and the world scale keeps
  the bar relative to the matrix).  The torch Newton against the JAX
  package's jnp Newton (``tests/test_torch_clutter_solver.py``): qacc,
  efc_force and qfrc_constraint at the K4 bars and Newton counts at the
  'contact' bar, for the linesearch reason above (the JAX side factors H
  with LAPACK on a CPU, the port with the lane Cholesky).
- The spheres scenes (``spheres`` pyramidal, ``spheres_elliptic``; seeded
  by ``spheres_state``, with live contacts in all three elliptic zones):
  the Newton solve at the K4 bars above, and Newton counts at the
  'elliptic' bar in both cones.  Over 8 seeds of 128 worlds on a CPU,
  against the JAX package's Pallas kernel in interpret mode: the plain
  port agreed in 98.4-100% of worlds in both cones, and the JAX package's
  jnp Newton (``ops/solver.solve`` under vmap) in 97.7-100% with
  pyramidal cones; with elliptic cones the jnp Newton agreed in only
  21.9-30.5% (it hit its 100-iteration cap in 15 of the 128 worlds of
  seed 0 and its qacc missed the bars), so it gives no bar there.  Never
  more than two iterations apart (port against Pallas), qacc within the
  bars above; 'elliptic' is set at the 'constraints' share, below every
  measured one.  Row forces are compared at these bars only in the worlds
  whose Newton counts agree (``FORCE_WHERE_NITER_AGREES``): a world that
  stops one iteration apart ends on another iterate, whose qacc meets its
  bar, while each contact row's force, D (aref - J qacc), carries that
  qacc difference times the row's |J| (about 1.4 for a pyramid row at
  mu 1), of the order of the force bar itself: on an H100, at the last
  state of chip_smoke's spheres rollout, the one world of 8192 whose
  counts differed missed the force bar by 0.0013 of its 0.0101, with its
  qacc within its own bar.
  qacc and qfrc_constraint (J^T f) are held in every world.
- Sensors (``check_sensors``, the dm_control scenes seeded by
  ``dmc_state``): the position and velocity stages read the state before
  the solve, so each element within ``SENSOR_ATOL`` + ``SENSOR_RTOL``
  |reference|; the acceleration stage reads the Newton's output (qacc,
  efc_force), so as qacc: each sensor type within ``QACC_ATOL`` +
  ``QACC_RTOL`` of the world's largest |reference| of that type, and only
  in the worlds whose Newton counts agree, with the counts at the
  'contact' bar (two correct solvers differ by one iteration in a few
  percent of contact worlds, as above).  Where the torch Newton solves a
  contact-rich system (humanoid_CMU: nefc 248 x nv 62), moving each qvel
  by 1e-7 of itself moves the acceleration sensors by up to 0.009 on the
  CPU at 256 worlds of ``dmc_state``, of the order of that bar (on an
  H100 the card's step missed it by 0.0002 in 1 of 256 worlds); there the
  card-against-CPU step adds ``step_slack``, twice that change per
  element, to the acceleration bar.
- The solve on the dm_control general states (the 'dmc' bar, on the last
  state of a general rollout of humanoid_dmc or hopper): qacc and
  qfrc_constraint at the K4 bars in every world, Newton counts at the
  'contact' share, and each row's efc_force within the K4 bar plus what
  the two sides' own qacc difference moves it by, D_r |J_r (qacc_got -
  qacc_want)| (``FORCE_THROUGH_QACC``): a pyramidal, limit, friction or
  equality row's force is a function of J_r qacc of slope 0 or D_r, so
  this slack is the most that qacc's difference, itself held at its bar,
  can move it.  Where float32 rounding moves the linesearch, two correct
  solves part by a qacc difference within its bar that a stiff row
  multiplies by its D: on an H100, at the last state of chip_smoke's
  hopper general rollout (8192 worlds), one world whose Newton counts
  agreed (one iteration) missed the plain force bar by 0.0003 of its
  0.0050 on a row of D 28.8, with its qacc and qfrc_constraint within
  their bars.
- The transmission scene's solve (the 'adhesion' bar,
  ``SOLVE_BAR_OF``): the 'dmc' bar, with qfrc_constraint = J^T efc_force
  at the K4 bar plus |J|^T of the rows' slack D_r |J_r dqacc|
  (``QFRC_THROUGH_QACC``).  Its box, pressed into the floor by adhesion,
  sits on stiff contact rows, where a stop at the model's tolerance
  leaves a qacc difference within its bar that the rows multiply past
  qfrc_constraint's: on a CPU, at the state after 7 steps of its
  rollout at 1024 worlds in float64, the plain Newton at the model's
  tolerance against the same Newton run to its optimum (tolerance 1e-14)
  had qacc within its bar in every world and qfrc_constraint past the
  plain bar in 4 worlds, by up to 9.48 bars; the slack is 0 in most
  worlds and up to 45.9 bars on one dof, and a fault of twice the plain
  bar on any one dof fails in 99.1-100% of worlds
  (``tests/test_torch_parity_qfrc.py``).  On an H100 (700 W), at the
  last state of chip_smoke's transmission rollout, the kernel against its
  plain version passed the plain qfrc bar in 12 worlds of 8192, by up to
  0.0459; there the kernel's qfrc_constraint lay 0.80-6.40 bars from
  the float64 optimum, the plain version's 0.0002-7.12 and the float64
  Newton's at the model's tolerance 0-6.22 (in the world at 6.40 the
  kernel stopped one trip before the others, as two float32 stops may).
  It is a bar for this scene's comparison; the 'dmc' bar of every other
  scene is as it was.
- A loose world (``TOL_FLOOR``): a world that stops at its own
  opt.tolerance above the float32 floor, as the worlds of a batched
  tolerance do (``quadruped_dr`` draws it log-uniform on [1e-6, 1e-4]).
  Under a bar of ``FORCE_THROUGH_QACC``, ``check_solve`` given the
  ``system`` reads each world's tolerance from its Model and holds a
  loose world's qfrc_constraint as 'adhesion' does, at the K4 bar plus
  |J|^T of the rows' slack; every other world keeps the plain bar.  The
  Newton stops where its improvement or gradient falls below the
  tolerance, so two float32 stops at 1e-4 part by a qacc gap within its
  bar that stiff rows multiply past qfrc_constraint's: on an H100 (700
  W), at quadruped_dr's state after 25 steps, one world of 8192 passed
  the plain qfrc bar by 0.0762, the kernel's, the plain version's and
  the float64 plain solve's qfrc_constraint at its tolerance lying 5.82,
  6.10 and 6.10 K4 bars from the float64 optimum.  On a CPU, quadruped_dr
  in float64 after 7 steps at 64 worlds, the plain Newton in float32 at
  each world's tolerance against the float64 optimum: a fault of twice
  the plain bar on one dof still fails in every world, and the slack
  widens a loose world's bar alone (``tests/test_torch_parity_loose.py``).
  The qacc bar holds stops up to 1e-4 (quadruped_dr; stack_2's and the
  spheres' elliptic forms); further out, a valid stop lies further from
  the optimum (the largest distance 0.62, 1.69 and 6.46 qacc bars for
  tolerances in [1e-6, 1e-5), [1e-5, 1e-4) and [1e-4, 1e-3): about the
  root of the tolerance, as an improvement test on a quadratic cost
  gives), and two valid stops part past the qacc bar at equal Newton
  counts (``tests/measure_loose_stops.py``, 1000 worlds).
- The CG solver (the 'cg' bar, ``spheres_cg``: the torch solver's CG
  against the JAX package's ``ops/solver.solve`` under ``vmap`` with
  ``opt.solver=cg``, on the state of ``spheres_state`` through the JAX
  package's stages before the solve, measured by
  ``tests/measure_cg_bar.py``; and the card's CG against the CPU's):
  qacc at the K4 bars in every world, efc_force as for 'dmc'
  (``FORCE_THROUGH_QACC``), and qfrc_constraint = J^T efc_force at the
  K4 bar plus |J|^T of those rows' slack (``QFRC_THROUGH_QACC``).
  CG takes 42.5-44.3 trips per world on that state, and two float32 runs
  part early: over 8 seeds of 128 worlds on a CPU (seeds 0-7), the trip
  counts agreed in 14.1-25.8% of worlds and lay up to 11-16 apart, with
  qacc within its bar in every world and efc_force within the K4 bar
  plus D_r |J_r dqacc| (past the plain bar by up to 0.0157 in two
  seeds).  The largest difference grows with the worlds compared: on an
  H100, the CG solve through the kernels against the CPU's plain
  versions at 1000 worlds (seed 5) had two worlds 21 apart, and missed
  the plain qfrc_constraint bar in one world by 0.0015 (qacc and
  efc_force within theirs: the forces a float32 CG ends on carry its
  qacc difference, and J^T sums them); over 8 seeds of 1024 worlds on a
  CPU (JAX against the port) the counts agreed in 17.5-23.3% of worlds
  and lay up to 14-26 apart, 2.1% of worlds more than 10 apart, and
  qfrc_constraint passed the plain bar by up to 0.0125 in two seeds and
  stayed within it plus |J|^T of the rows' slack in all.  The mean trip
  count is what agrees: over those 8 seeds of 128 worlds the two means
  lay 0.07-0.80 apart (43.0-44.3 trips each), at 1024 worlds (seeds
  0-2) 0.11-0.17.  A CG that lost its conjugacy parts from a sound one by
  far more (``tests/test_torch_cg.py`` plants the faults, seed 0): with
  beta forced to 0 the port took 100.00 trips on the mean (every world
  at the cap) against JAX's 43.62 and its qacc missed the bar by 44.9,
  with beta's sign flipped 97.07 and 11.5.  The bar: 0.10 of worlds
  equal, none more than 40 apart (``NITER_MAX_DIFF_OF``: a runaway guard
  under the 100-trip cap), the mean counts within 3 trips
  (``NITER_MEAN_DIFF_OF``, near 4 times the largest sound reading),
  qacc, efc_force and qfrc_constraint as above.  It is a bar for a new
  comparison; no other bar changed for it.
- The torch elliptic Newton in float64 (the 'elliptic64' count bar,
  ``tests/test_torch_elliptic.py``: stack_4 at 32 worlds of
  ``task_state``, both sides float64): qacc within 5.6e-9 of the world's
  scale in every world over seeds 0-3, and the cone terms (zones, forces,
  cone Hessian, linesearch segments) equal to JAX's to 1e-12, yet the
  Newton counts agreed in only 0.8125-1.0 of worlds (13 of 16 at seed 0
  with 16 worlds; 1.0, 0.875, 0.9375, 0.8125 at seeds 0-3 with 32), up to
  two apart.  The stop tests are not where they part: in every world
  whose counts differ, no stop quantity (improvement, gradient, model
  improvement over opt.tolerance, 1e-8 unfloored) lies within 1e6 of the
  tolerance before the last trip, nor above 1.1e-6 of it at the last.
  The linesearch is: it accepts the exact minimizer only if its slope,
  zero up to rounding, keeps the bracket's sign, and where the bracket
  has closed on one point it otherwise stops far short (world 6 of seed
  3: search directions equal to 2.4e-16, alpha 1.6203 on one side and
  1.3986 at a slope of -9.8e5 on the other), and the Newton takes
  another trip.  The JAX package parts from itself the same way: its
  ``solve`` against the same functions run one trip at a time agreed in
  0.9375-1.0 of worlds; and the port with LAPACK's factor in place of
  the lane Cholesky agreed with JAX in 0.78-0.97, no closer
  (``tests/measure_elliptic_counts.py``,
  ``tests/test_torch_elliptic_counts.py``).  The
  bar: 0.80 of worlds equal, below every measured share, and never more
  than ``NITER_MAX_DIFF`` apart.
- CG with elliptic cones in float32 (finger_cg) runs some worlds
  to ``opt.iterations`` (200) without meeting the tolerance, its qacc
  within 1e-5 of the float64 optimum: on a CPU 1 of 32 worlds of
  ``touching`` (seed 3) for the port and another 1 of 32 for the JAX
  float32 CG on the same system; on an H100 (700 W) 223 of 8192 worlds
  per step of the rollout.  Two sides seldom cap the same world, so under
  the 'cg' bar such worlds (``NITER_CAPPED_SHARE_OF``: at most 5%) are
  held by qacc and the forces and left out of the count bar.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types

K1_NAMES = ('qM', 'qLD', 'bias', 'cdof', 'dist', 'pos', 'frame',
            'subtree_com')
K1_TOL = 1e-4
QACC_ATOL, QACC_RTOL = 1e-4, 1e-3
QPOS_ATOL, QPOS_RTOL = 1e-5, 1e-5
NITER_SHARE = {'rest': 0.99, 'contact': 0.85, 'constraints': 0.90,
               'elliptic': 0.90, 'dmc': 0.85, 'adhesion': 0.85, 'cg': 0.10,
               'elliptic64': 0.80}
NITER_MAX_DIFF = 2
# bars whose counts may lie further apart than NITER_MAX_DIFF
NITER_MAX_DIFF_OF = {'cg': 40}
# bars that also hold the mean count over the worlds within this many
NITER_MEAN_DIFF_OF = {'cg': 3.0}
# bars under which a float32 solve may run a world to opt.iterations on one
# side: at most this share of worlds, held by their outputs and left out
# of the count bar (``check_niter``'s ``cap``)
NITER_CAPPED_SHARE_OF = {'cg': 0.05}
# Newton-count bars whose efc_force is compared only where counts agree
FORCE_WHERE_NITER_AGREES = ('elliptic',)
# Newton-count bars whose efc_force bar carries each row's D |J dqacc|
FORCE_THROUGH_QACC = ('dmc', 'adhesion', 'cg')
# bars whose qfrc_constraint bar carries |J|^T of the rows' D |J dqacc|
# (qfrc_constraint is J^T efc_force, so it moves with the forces)
QFRC_THROUGH_QACC = ('adhesion', 'cg')
# a world whose solve has no live row (every row's D is 0) and whose qacc
# lies past the world-scale bar is held by each side's own gradient, |M
# qacc - qfrc_smooth - J^T efc_force| / (meaninertia nv) in float64,
# within GRADIENT_BAR tolerances (``check_solve`` with ``system``): the
# Newton's own stop quantity.  Without rows the solve is M qacc =
# qfrc_smooth, which float32 resolves at the qacc bar only where M is well
# conditioned (swimmer15: cond(M) ~1.8e5; two float32 solves of one
# system, inputs moved by 1e-7 of themselves, part past the qacc bar in
# ~12% of worlds, while each one's gradient stays under 1 tolerance and a
# fault of one qacc bar on one dof reads >= 362;
# ``tests/test_torch_parity_gradient.py``).  The qacc bar comes first: a
# float32 qacc within it can read a few tolerances of gradient where M
# and qfrc_smooth are large beside meaninertia (reacher on an H100: 4.25)
GRADIENT_BAR = 2.0
# the solve's bar of a general scene where it is not 'dmc' (elliptic cones
# take 'elliptic', ``solve_bar``)
SOLVE_BAR_OF = {'transmission': 'adhesion'}
# the solver tolerance every unbatched float32 scene stops at
# (``io.put_model`` floors opt.tolerance there); a world whose own
# opt.tolerance lies above it is a loose world (``check_solve`` with
# ``system``)
TOL_FLOOR = 1e-6
# root drop of each seeded state; 0.28 m puts the feet in the floor
DROP = {'rest': 0.0, 'contact': 0.28}
MASS_NAMES = ('qM', 'qLD', 'cvel', 'cdof_dot', 'bias')
SOLVE_ATOL, SOLVE_RTOL = 1e-5, 1e-4
# dm_control scenes: the qpos row of the root's height, and how far
# ``dmc_state`` lowers it for the contact state (the feet in the floor:
# the hopper's two TOUCH sites and the humanoid's FORCE sites live;
# humanoid_CMU, which lies on its back at qpos0, 0.1 m into the floor:
# ~5 of its 48 slots live)
DMC_ROOT = {'walker': 0, 'cheetah': 1, 'hopper': 1, 'humanoid_dmc': 2,
            'humanoid_CMU': 2, 'quadruped': 2, 'dog': 2,
            'quadruped_escape': 2}
DMC_DROP = {'walker': 0.05, 'cheetah': 0.2, 'hopper': 0.1,
            'humanoid_dmc': 0.3, 'humanoid_CMU': 0.1, 'quadruped': 0.15,
            'dog': 0.01, 'quadruped_escape': 0.15}
SENSOR_ATOL, SENSOR_RTOL = 1e-4, 1e-4
# K4's scenes (``k4_case``): the snapshot's name in ``io`` (or in
# ``io.DMC_SNAPSHOTS``), and the qpos row that the 'contact' state lowers
# into the floor with its drop (the humanoid's root height; eq_joint's
# slide of the box; implicitfast's free sphere's height; the dm_control
# roots)
K4_SCENES = {'humanoid': ('SNAPSHOT', 2, DROP['contact']),
             'eq_joint': ('EQ_JOINT_SNAPSHOT', 2, 0.28),
             'implicitfast': ('IMPLICITFAST_SNAPSHOT', 4, 0.15),
             **{k: (k, DMC_ROOT[k], DMC_DROP[k])
                for k in ('hopper', 'humanoid_dmc')}}


def lane_state(m, W: int, seed: int, drop: float = 0.0, drop_row: int = 2):
  """Lanes-last float32 numpy (qpos, qvel, ctrl, warmstart), drawn in
  that order from ``default_rng(seed)``: qpos0 + 0.01 N with qpos row
  ``drop_row`` (the humanoid root's height) lowered by ``drop``, qvel
  0.2 N, ctrl 0.3 N, warmstart 0.1 N."""
  rng = np.random.default_rng(seed)
  qpos0 = types.host(m.qpos0, np.float32)
  qpos = (qpos0[:, None] + 0.01 * rng.standard_normal((m.nq, W))).astype(
      np.float32)
  qpos[drop_row] -= drop
  qvel = (0.2 * rng.standard_normal((m.nv, W))).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((m.nu, W))).astype(np.float32)
  ws = (0.1 * rng.standard_normal((m.nv, W))).astype(np.float32)
  return qpos, qvel, ctrl, ws


def k1_case(scene: str, state: str, W: int, seed: int, device):
  """A model and its lanes-last state tensors for a scene of
  ``K4_SCENES``, or with '_no_rows' appended, its collision off, at
  ``lane_state`` ('rest', or 'contact' with the scene's body lowered) on
  ``device``: K1's input.  Returns (model, qpos, qvel, ctrl,
  warmstart)."""
  from mujoco_warp_tpu_torch import io
  name, row, drop = K4_SCENES[scene.replace('_no_rows', '')]
  path = io.DMC_SNAPSHOTS[name] if name in io.DMC_SNAPSHOTS else \
      getattr(io, name)
  m = io.load_model_npz(path, device=device)
  if scene.endswith('_no_rows'):
    m = m.replace(opt=m.opt.replace(run_collision_detection=False))
  return (m,) + tuple(
      torch.as_tensor(x, device=device) for x in
      lane_state(m, W, seed, drop if state == 'contact' else 0.0, row))


def k4_case(scene: str, state: str, W: int, seed: int, device):
  """K4's arguments for a scene of ``K4_SCENES``, or for
  'implicitfast_no_rows' (implicitfast with collision off: K4 builds no
  rows and takes qacc from K1's qLD), at ``lane_state`` ('rest', or
  'contact' with the scene's body lowered), fed the plain K1 and glue on
  ``device``.  Returns (model, args of ``k4``)."""
  from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref
  m, qpos, qvel, ctrl, ws = k1_case(scene, state, W, seed, device)
  need_qLD = not k4_ref.has_rows(m)
  qM, qLD, bias, cdof, dist, cpos, cframe, stcom = k1_ref.k1(
      m, qpos, qvel, need_qLD=need_qLD)
  con = None
  if m.ncand and m.opt.run_collision_detection:
    make = glue.compact if m.con_compact else glue.identity_con
    con, _ = make(m, dist, cpos, cframe, stcom)
  qfs = glue.middle(m, bias, qpos, qvel, ctrl)
  return m, (m, qM, qLD if need_qLD else None, qfs, ws, qvel, qpos, cdof,
             con)


def dmc_state(m, scene: str, W: int, seed: int):
  """World-major float32 numpy (qpos, qvel, ctrl) of a dm_control scene:
  ``lane_state``'s with the root lowered by ``DMC_DROP[scene]`` (the
  state that ``k1_case`` / ``k4_case`` give the scene's 'contact'
  case), transposed."""
  qpos, qvel, ctrl, _ = lane_state(m, W, seed, DMC_DROP[scene],
                                   DMC_ROOT[scene])
  return (np.ascontiguousarray(qpos.T), np.ascontiguousarray(qvel.T),
          np.ascontiguousarray(ctrl.T))


def sensor_stages(m) -> dict:
  """'pos', 'vel', 'acc' -> {sensor type: sensordata columns}."""
  from mujoco_warp_tpu_torch.ops import sensor
  out = {}
  for stage, kinds in (('pos', sensor.POS_TYPES), ('vel', sensor.VEL_TYPES),
                       ('acc', sensor.ACC_TYPES)):
    out[stage] = {}
    for t in kinds:
      ids = np.nonzero(m.sensor_type == t)[0]
      if len(ids):
        out[stage][types.SensorType(t).name] = np.concatenate(
            [int(m.sensor_adr[i]) + np.arange(int(m.sensor_dim[i]))
             for i in ids])
  return out


def check_sensors(m, got, want, niter_got, niter_want, slack=None,
                  bar: str = 'contact', cap=None) -> dict:
  """sensordata (W, nsensordata) of one step against another on the same
  state, with the Newton (or CG) counts of that step at the ``bar`` of
  ``check_niter``; ``slack`` (W, nsensordata), where given, widens the
  acceleration sensors' bar (``step_slack``); ``cap`` as for
  ``check_niter``.  Returns the max abs error per stage and the share of
  worlds whose counts agree."""
  got, want = _t(got), _t(want)
  got = got.to(want.device)
  share, _ = check_niter(niter_got, niter_want, bar, cap)
  agree = _t(niter_got, want).reshape(-1) == _t(niter_want, want).reshape(-1)
  errs = {}
  for stage, cols in sensor_stages(m).items():
    errs[stage] = 0.0
    for name, c in cols.items():
      c = torch.as_tensor(c, device=want.device)
      a, b = got[:, c], want[:, c]
      if stage == 'acc':
        a, b = a[agree], b[agree]
        sl = None if slack is None else _t(slack, want)[:, c][agree].T
        errs[stage] = max(errs[stage], check_world_scale(
            a.T, b.T, f'sensor {name}', slack=sl))
        continue
      err = (a - b).abs()
      excess = float((err - (SENSOR_ATOL + SENSOR_RTOL * b.abs())).max())
      assert excess <= 0.0, f'sensor {name}: exceeds tolerance by {excess}'
      errs[stage] = max(errs[stage], float(err.max()))
  return {'max_abs_err': errs, 'niter_share': share}


def step_slack(m, d, seed: int = 0):
  """Twice the change of the general step's sensordata when each qvel of
  d moves by 1e-7 of itself (N draws of ``seed``): the step's own float32
  sensitivity, which a contact-rich torch Newton step (humanoid_CMU,
  nefc 248 x nv 62) carries into its acceleration sensors at the size of
  ``check_sensors``' bar.  A slack for that bar where two sides of one
  step may differ by rounding (card against CPU)."""
  from mujoco_warp_tpu_torch.ops import forward
  rng = np.random.default_rng(seed)
  scale = 1.0 + 1e-7 * rng.standard_normal(tuple(d.qvel.shape))
  moved = d.replace(qvel=d.qvel * torch.as_tensor(
      scale.astype(np.float32), device=d.qvel.device))
  return 2.0 * (forward.step(m, moved).sensordata -
                forward.step(m, d).sensordata).abs()


def touching(m, seed: int, nworld: int):
  """World-major float32 numpy (qpos, qvel, ctrl) of ``nworld`` worlds in
  contact: of 2048 poses qpos0 + N (finger's tip meets its spinner in ~5%
  of them), the first ``nworld`` with a live contact slot, then qvel 0.2 N
  and ctrl 0.3 N.  The poses' contacts come from the port's collision on
  the CPU."""
  from mujoco_warp_tpu_torch import io
  from mujoco_warp_tpu_torch.ops import collision_driver, forward
  rng = np.random.default_rng(seed)
  qpos = (types.host(m.qpos0, np.float32)[None] +
          rng.standard_normal((2048, m.nq))).astype(np.float32)
  if m.qpos0.device.type != 'cpu':
    raise ValueError('touching takes a CPU model')
  d = io.make_data(m, 2048, device='cpu').replace(qpos=torch.as_tensor(qpos))
  dist, _, _ = collision_driver._narrowphase_candidates(m, forward.pre(m, d))
  live = (dist < m.cand_includemargin).any(1).numpy()
  assert live.sum() >= nworld, live.sum()
  qvel = (0.2 * rng.standard_normal((nworld, m.nv))).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((nworld, m.nu))).astype(np.float32)
  return qpos[live][:nworld], qvel, ctrl


def general_state(m, W: int, seed: int):
  """World-major float32 numpy (qpos, qvel, ctrl) of the general step's
  seeded state, drawn in that order from ``default_rng(seed)``: qpos0 +
  0.1 N with every free and ball quaternion renormalised, qvel 0.2 N, ctrl
  0.3 N."""
  rng = np.random.default_rng(seed)
  qpos0 = types.host(m.qpos0, np.float32)
  qpos = (qpos0[None] + 0.1 * rng.standard_normal((W, m.nq))).astype(
      np.float32)
  for j in range(m.njnt):
    jt, a = int(m.jnt_type[j]), int(m.jnt_qposadr[j])
    if jt in (types.JointType.FREE, types.JointType.BALL):
      q = slice(a + 3, a + 7) if jt == types.JointType.FREE else \
          slice(a, a + 4)
      qpos[:, q] /= np.linalg.norm(qpos[:, q], axis=1, keepdims=True)
  qvel = (0.2 * rng.standard_normal((W, m.nv))).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((W, m.nu))).astype(np.float32)
  return qpos, qvel, ctrl


# clutter_arm's free bodies packed into touching rows on the floor: (x
# spacing, y, z) per geom type, so that sphere-sphere, box-box and
# capsule-capsule neighbours overlap by 5-10 mm, the sphere and capsule
# rows touch the box row, every body touches the floor, and the last
# capsule stands against the last sphere
_PACK = {int(types.GeomType.SPHERE): (0.19, -0.17, 0.095),
         int(types.GeomType.BOX): (0.155, 0.0, 0.075),
         int(types.GeomType.CAPSULE): (0.11, 0.13, 0.135)}
_LAST_CAPSULE = (0.72, -0.17, 0.135)


def clutter_state(m, W: int, seed: int):
  """World-major float32 numpy (qpos, qvel, ctrl) of the contact-rich
  clutter_arm state, drawn in that order from ``default_rng(seed)``: the
  free bodies packed by ``_PACK`` plus 2 mm N in position and 0.01 N in
  their quaternions (renormalised), the arm's hinges at qpos0 + 0.1 N;
  qvel 0.1 N (free bodies) and 0.2 N (hinges); ctrl 0.3 N."""
  rng = np.random.default_rng(seed)
  qpos = np.broadcast_to(types.host(m.qpos0, np.float32),
                         (W, m.nq)).copy()
  noise = rng.standard_normal((W, m.nq)).astype(np.float32)
  qvel_n = rng.standard_normal((W, m.nv)).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((W, m.nu))).astype(np.float32)
  qvel = np.zeros((W, m.nv), np.float32)
  seen = {}
  for j in range(m.njnt):
    a, da = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if int(m.jnt_type[j]) != types.JointType.FREE:
      qpos[:, a] += 0.1 * noise[:, a]
      qvel[:, da] = 0.2 * qvel_n[:, da]
      continue
    body = int(m.jnt_bodyid[j])
    gt = int(m.geom_type[np.nonzero(m.geom_bodyid == body)[0][0]])
    c = seen.get(gt, 0)
    seen[gt] = c + 1
    dx, y, z = _PACK[gt]
    pos = _LAST_CAPSULE if (gt == types.GeomType.CAPSULE and c == 3) else \
        (dx * c, y, z)
    qpos[:, a:a + 3] = np.asarray(pos, np.float32) + 0.002 * noise[:, a:a + 3]
    q = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32) + \
        0.01 * noise[:, a + 3:a + 7]
    qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel[:, da:da + 6] = 0.1 * qvel_n[:, da:da + 6]
  return qpos, qvel, ctrl


# how far spheres_state lowers each body of the spheres scenes into the
# floor: 3 mm, three times its 1 mm noise, so that every body starts in
# contact
SPHERES_DEPTH = 0.003


def woken_state(m, st: dict, rng) -> dict:
  """A saved sleep state ``st`` (``io.load_state``) with each sleeping
  tree woken with probability 0.5, drawn from ``rng``: its counter set to
  K_AWAKE, -3, -2 or -1 (near ready) and its dofs' qvel to 0-1.5 times
  ``opt.sleep_tolerance`` over their ``dof_length``, so that trees count
  down, fall asleep, or reset."""
  asleep = st['tree_asleep'].copy()
  wake = (rng.random(asleep.shape) < 0.5) & (asleep >= 0)
  asleep[wake] = rng.choice([types.K_AWAKE, -3, -2, -1], size=wake.sum())
  tol = float(types.host(m.opt.sleep_tolerance))
  length = types.host(m.dof_length, np.float32)
  qvel = st['qvel'].copy()
  woken = wake[:, m.dof_treeid]
  qvel[woken] = (rng.uniform(0.0, 1.5, woken.sum()) * tol /
                 np.broadcast_to(length, qvel.shape)[woken])
  return {**st, 'tree_asleep': asleep, 'qvel': qvel.astype(np.float32)}


def pushed_clutter(nworld: int, nwake: int, device=None, seed: int = 0):
  """The skip step's start: the committed settled ``clutter.xml`` state
  (``io.CLUTTER_SETTLED``, every tree asleep) repeated to ``nworld``
  worlds, ``nwake`` of them, drawn from ``default_rng(seed)``, pushed by
  a ``qfrc_applied`` of 2 on each dof of their first tree.  Returns
  (model, Data)."""
  from mujoco_warp_tpu_torch import benchmarks, io
  m = io.load_model_npz(io.CLUTTER_SLEEP_SNAPSHOT, device=device)
  d = benchmarks.build(m, nworld, device=device,
                       init_state=io.load_state(io.CLUTTER_SETTLED))
  qf = torch.zeros_like(d.qfrc_applied)
  ids = np.random.default_rng(seed).choice(nworld, nwake, replace=False)
  qf[torch.as_tensor(ids, device=qf.device), :6] = 2.0
  return m, d.replace(qfrc_applied=qf)


def spheres_state(m, W: int, seed: int):
  """World-major float32 numpy (qpos, qvel, ctrl) of the seeded contact
  state of the spheres scenes, drawn in that order from
  ``default_rng(seed)``: every free body at its qpos0 x and y, lying on
  the floor (capsules on their side, boxes upright) ``SPHERES_DEPTH`` +
  1 mm N below contact, its quaternion perturbed by 0.02 N and renormalised;
  qvel 0.3 N on the linear and 2 N on the angular dofs, so that contacts
  slide, stick and lift off (all three elliptic zones); ctrl 0.3 N."""
  rng = np.random.default_rng(seed)
  noise = rng.standard_normal((W, m.nq)).astype(np.float32)
  qvel_n = rng.standard_normal((W, m.nv)).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((W, m.nu))).astype(np.float32)
  qpos = np.broadcast_to(types.host(m.qpos0, np.float32), (W, m.nq)).copy()
  qvel = np.zeros((W, m.nv), np.float32)
  size = types.host(m.geom_size, np.float32)
  side = np.asarray([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0],
                    np.float32)  # the capsule's axis along x
  for j in range(m.njnt):
    a, da = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if int(m.jnt_type[j]) != types.JointType.FREE:
      continue
    g = int(np.nonzero(m.geom_bodyid == int(m.jnt_bodyid[j]))[0][0])
    gt = int(m.geom_type[g])
    half = size[g, 2] if gt == types.GeomType.BOX else size[g, 0]
    quat = side if gt == types.GeomType.CAPSULE else \
        np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    qpos[:, a + 2] = half - SPHERES_DEPTH + 0.001 * noise[:, a + 2]
    q = quat + 0.02 * noise[:, a + 3:a + 7]
    qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel[:, da:da + 3] = 0.3 * qvel_n[:, da:da + 3]
    qvel[:, da + 3:da + 6] = 2.0 * qvel_n[:, da + 3:da + 6]
  return qpos, qvel, ctrl


# the elliptic-cone slice's dm_control tasks (``task_state``): how deep
# each object sinks into the floor, plus 1 mm N
TASK_DEPTH = 0.003


def task_state(m, W: int, seed: int):
  """World-major float32 numpy (qpos, qvel, ctrl) of the seeded contact
  state of manipulator and stacker, drawn in that order from
  ``default_rng(seed)``: the arm's joints at qpos0 + 0.3 N; each planar
  object (a body of the world with a z slide) at its qpos0 x + 0.02 N,
  turned by 0.1 N about its hinge, and lowered until its lowest geom lies
  ``TASK_DEPTH`` + 1 mm N below the floor (the highest plane facing up);
  qvel 0.2 N
  on the arm, and on each object 0.3 N along x and z and 2 N about its
  hinge, so that its contacts slide, stick and lift off (all three
  elliptic zones); ctrl 0.3 N.  The heights come from the port's
  kinematics on the CPU."""
  from mujoco_warp_tpu_torch import io
  from mujoco_warp_tpu_torch.ops import collision_convex, smooth
  rng = np.random.default_rng(seed)
  noise = rng.standard_normal((W, m.nq)).astype(np.float32)
  qvel_n = rng.standard_normal((W, m.nv)).astype(np.float32)
  depth = rng.standard_normal((W, m.nbody)).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((W, m.nu))).astype(np.float32)
  qpos0 = types.host(m.qpos0, np.float32)
  axis = types.host(m.jnt_axis, np.float32)
  qpos = np.broadcast_to(qpos0, (W, m.nq)).copy()
  qvel = (0.2 * qvel_n).astype(np.float32)
  zs = {}  # object body -> its z slide's qpos row
  for j in range(m.njnt):
    b, a = int(m.jnt_bodyid[j]), int(m.jnt_qposadr[j])
    obj = int(m.body_parentid[b]) == 0 and any(
        int(m.jnt_type[k]) == types.JointType.SLIDE and axis[k, 2] > 0.99
        for k in np.nonzero(m.jnt_bodyid == b)[0])
    jt, da = int(m.jnt_type[j]), int(m.jnt_dofadr[j])
    if not obj:
      qpos[:, a] += 0.3 * noise[:, a]
    elif jt == types.JointType.HINGE:
      qpos[:, a] += 0.1 * noise[:, a]
      qvel[:, da] = 2.0 * qvel_n[:, da]
    else:
      qvel[:, da] = 0.3 * qvel_n[:, da]
      if axis[j, 2] > 0.99:
        zs[b] = a
      else:
        qpos[:, a] += 0.02 * noise[:, a]
  d = io.make_data(m, W, device='cpu')
  d = smooth.kinematics(m, d.replace(qpos=torch.as_tensor(qpos).to(
      d.qpos.dtype)))
  gt = np.asarray(m.geom_type)
  up = (torch.as_tensor(gt == types.GeomType.PLANE) &
        (d.geom_xmat[0, :, 2, 2] > 0.99))  # planes facing up
  floor = float(d.geom_xpos[0, up, 2].max())
  sub = m.tree.subtree_mask
  size = m.geom_size.to(d.qpos.dtype)
  for b, a in zs.items():
    low = None
    for g in np.nonzero(sub[b, np.asarray(m.geom_bodyid)])[0]:
      R = d.geom_xmat[:, g]
      p = collision_convex._support_local(
          int(gt[g]), size[g], -R[:, 2, :])  # -z in the geom's frame
      z = d.geom_xpos[:, g, 2] + torch.einsum('wk,wk->w', R[:, 2, :], p)
      low = z if low is None else torch.minimum(low, z)
    qpos[:, a] += (floor - TASK_DEPTH + 0.001 * depth[:, b] -
                   low.numpy()).astype(np.float32)
  return qpos, qvel, ctrl


def solve_args(m, d):
  """The standalone solve's arguments (``kernels.solver.solve_tiles``: m,
  J, D, aref, fl, M, qfrc_smooth, warmstart, and the elliptic row scales
  or None) at world-major state d (qpos, qvel, ctrl, qacc_warmstart) of a
  small-tree model, through the position stages, the plain mass chain,
  collision, rows and forces.  Returns (args, the world-major Data)."""
  from mujoco_warp_tpu_torch.fused import solver_ref
  from mujoco_warp_tpu_torch.kernels import lanes, world
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.ops import forward
  d = forward.pre(m, d)
  nv, nb = m.nv, m.nbody
  qM, qLD, cvel, cdd, bias = kmass.mass_chain_plain(
      m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  d = forward.mid(m, d.replace(
      qM=world(qM, nv, nv), qLD=world(qLD, nv, nv), cvel=world(cvel, nb, 6),
      cdof_dot=world(cdd, nv, 6), qfrc_bias=bias.T))
  s = solver_ref.ell_scales(m, d.contact.friction) \
      if solver_ref.ell_groups(m) else None
  return (m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
          lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
          lanes(d.qacc_warmstart), s), d


def _t(x, like=None):
  x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
  return x if like is None else x.to(like.device)


def check_k1(got, want) -> tuple[float, float]:
  """K1 outputs (in ``K1_NAMES`` order, None where not computed).
  Returns (max abs error, worst error relative to max(1, max |want|))."""
  for name, a, b in zip(K1_NAMES, got, want):
    assert (a is None) == (b is None), f'K1 {name}: computed on one side'
  kept = [(f'K1 {n}', a, b) for n, a, b in zip(K1_NAMES, got, want)
          if b is not None]
  names, got, want = zip(*kept)
  return check_rel(got, want, names)


def check_rel(got, want, names, tol=K1_TOL) -> tuple[float, float]:
  """Each output within ``tol`` of max(1, max |want|).  Returns (max abs
  error, worst relative error)."""
  worst_abs = worst_rel = 0.0
  for name, a, b in zip(names, got, want):
    b = _t(b)
    e = float((_t(a, b) - b).abs().max())
    rel = e / max(1.0, float(b.abs().max()))
    assert rel <= tol, f'{name}: err {e} (relative {rel}) > {tol}'
    worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
  return worst_abs, worst_rel


def check_world_scale(got, want, name: str, atol: float = QACC_ATOL,
                      rtol: float = QACC_RTOL, slack=None) -> float:
  """``got`` (rows, W) within ``atol`` + ``rtol`` of each world's largest
  |want|, plus ``slack`` (rows, W) where given.  Returns the max abs
  error."""
  want = _t(want)
  err = (_t(got, want) - want).abs()
  scale = want.abs().amax(dim=0, keepdim=True)
  bar = atol + rtol * scale
  if slack is not None:
    bar = bar + _t(slack, want)
  over = (err - bar).amax(dim=0)
  excess = float(over.max())
  assert excess <= 0.0, (f'{name}: exceeds tolerance by {excess} (world '
                         f'{int(over.argmax())})')
  return float(err.max())


def check_niter(got, want, state: str, cap=None) -> tuple[float, int]:
  """Newton counts of one K4 or solve against another; with ``cap``
  (opt.iterations), under the bars of ``NITER_CAPPED_SHARE_OF`` the
  worlds that ran to it on either side are left out, at most that share
  of them.  Returns (share of equal worlds, largest difference)."""
  want = _t(want).reshape(-1).long()
  got = _t(got, want).reshape(-1).long()
  if cap is not None and state in NITER_CAPPED_SHARE_OF:
    capped = (got >= cap) | (want >= cap)
    share_c = float(capped.double().mean())
    assert share_c <= NITER_CAPPED_SHARE_OF[state], (
        f'niter at the cap {cap} in {share_c:.4f} of worlds > '
        f'{NITER_CAPPED_SHARE_OF[state]}')
    got, want = got[~capped], want[~capped]
  share = float((got == want).double().mean())
  diff = int((got - want).abs().max())
  most = NITER_MAX_DIFF_OF.get(state, NITER_MAX_DIFF)
  assert share >= NITER_SHARE[state], (
      f'niter equal in {share:.4f} of worlds < {NITER_SHARE[state]}')
  assert diff <= most, f'niter differs by {diff} > {most} in some world'
  if state in NITER_MEAN_DIFF_OF:
    dmean = abs(float(got.double().mean() - want.double().mean()))
    assert dmean <= NITER_MEAN_DIFF_OF[state], (
        f'niter means differ by {dmean:.3f} > {NITER_MEAN_DIFF_OF[state]}')
  return share, diff


def check_k4(got, want, qvel, h: float, state: str) -> dict:
  """K4 outputs (qpos, qvel, warmstart, qacc, niter) given the same
  inputs; ``qvel`` is the input velocity and ``h`` the timestep.  Returns
  the errors seen."""
  want = [_t(x) for x in want]
  got = [_t(x, y) for x, y in zip(got, want)]
  qvel = _t(qvel, want[1])
  qacc_err = check_world_scale(got[3], want[3], 'qacc')
  check_world_scale(got[2], want[2], 'warmstart')
  check_world_scale((got[1] - qvel) / h, (want[1] - qvel) / h,
                    'qvel step / h')
  excess = float(((got[0] - want[0]).abs() -
                  (QPOS_ATOL + QPOS_RTOL * want[0].abs())).max())
  assert excess <= 0.0, f'qpos: exceeds tolerance by {excess}'
  share, diff = check_niter(got[4], want[4], state)
  return {'qacc_max_abs_err': qacc_err, 'niter_share': share,
          'niter_max_diff': diff, 'niter_mean': float(want[4].float().mean())}


def solve_gradient(system, qacc, force) -> torch.Tensor:
  """(W,) each world's Newton gradient |M qacc - qfrc_smooth - J^T
  force| / (meaninertia nv), over the Model's tolerance (each world's
  where it is batched), in float64, of a
  solve's outputs qacc (nv, W) and efc_force (nefc, W) on its inputs
  ``system`` (``solve_tiles``'s arguments: m, J, D, aref, fl, M,
  qfrc_smooth, ...)."""
  m, J, _, _, _, M, qfs = system[:7]
  f64 = lambda x: _t(x, qfs).double()
  g = (torch.einsum('ijw,jw->iw', f64(M), f64(qacc)) - f64(qfs) -
       torch.einsum('rvw,rw->vw', f64(J), f64(force)))
  scale = float(types.host(m.stat.meaninertia)) * m.nv * torch.as_tensor(
      types.host(types.world_field(m, 'opt.tolerance')), device=g.device)
  return g.norm(dim=0) / scale


def check_solve(got, want, state: str = 'constraints', rows=None,
                cap=None, system=None) -> dict:
  """Standalone Newton solve outputs (qacc, efc_force, qfrc_constraint,
  niter), lanes-last, on the same inputs; Newton counts at the ``state``
  bar, for the bars of ``FORCE_WHERE_NITER_AGREES`` efc_force only in
  the worlds whose counts agree, and for those of ``FORCE_THROUGH_QACC``
  each row's efc_force with the slack D_r |J_r dqacc| of the inputs
  ``rows`` = (J (nefc, nv, W), D (nefc, W)), for those of
  ``QFRC_THROUGH_QACC`` also qfrc_constraint with |J|^T of that slack;
  given the inputs ``system`` (``solve_tiles``'s arguments), qacc past
  the world-scale bar in a world without a live row by each side's
  gradient (``solve_gradient``, within ``GRADIENT_BAR``), and under a bar
  of ``FORCE_THROUGH_QACC`` qfrc_constraint with |J|^T of the rows' slack
  in the loose worlds (opt.tolerance above ``TOL_FLOOR``); ``cap`` as
  for ``check_niter``.  Returns the errors seen, with how far efc_force
  and qfrc_constraint lie past the K4 bar without the slack (<= 0:
  within it), the worlds where qfrc_constraint does, how many worlds the
  gradient held and how many were loose."""
  g0, w0 = _t(got[0], want[0]), _t(want[0])
  qacc_err = float((g0 - w0).abs().max())
  loose = torch.zeros(w0.shape[1], dtype=torch.bool, device=w0.device)
  if system is not None:
    loose = (types.world_field(system[0], 'opt.tolerance').to(w0.device) >
             TOL_FLOOR).expand(w0.shape[1])
  # the worlds past the qacc bar that have no live row
  by_grad = torch.zeros(w0.shape[1], dtype=torch.bool, device=w0.device)
  if system is not None:
    past = (g0 - w0).abs().amax(0) > QACC_ATOL + QACC_RTOL * w0.abs().amax(0)
    by_grad = past & ~(_t(system[2], w0) != 0).any(0)
    if bool(by_grad.any()):
      for side, out in (('got', got), ('want', want)):
        gn = solve_gradient(system, out[0], out[1]).to(w0.device)
        over = torch.where(by_grad, gn - GRADIENT_BAR, 0.0)
        excess = float(over.max())
        assert excess <= 0.0, (
            f'qacc ({side}): past its bar and its gradient exceeds '
            f'{GRADIENT_BAR} tolerances by {excess} (world '
            f'{int(over.argmax())}, no live row)')
  if not bool(by_grad.all()):
    check_world_scale(g0[:, ~by_grad], w0[:, ~by_grad], 'qacc')
  f_got, f_want = _t(got[1]), _t(want[1])
  slack = None
  if state in FORCE_WHERE_NITER_AGREES:
    agree = (_t(got[3], f_want).reshape(-1) ==
             _t(want[3], f_want).reshape(-1))
    f_got, f_want = f_got[:, agree], f_want[:, agree]
  if state in FORCE_THROUGH_QACC:
    J, D = (_t(x, f_want) for x in rows)
    dq = _t(got[0], f_want) - _t(want[0], f_want)
    slack = D * torch.einsum('rvw,vw->rw', J, dq).abs()
  force_err = check_world_scale(f_got, f_want, 'efc_force', slack=slack)
  # how far past the bar without the slack (<= 0: within it)
  past = float(((f_got - f_want).abs() - (
      QACC_ATOL + QACC_RTOL * f_want.abs().amax(0, keepdim=True))).max())
  q_slack = None
  if state in QFRC_THROUGH_QACC or (slack is not None and
                                    bool(loose.any())):
    q_slack = torch.einsum('rvw,rw->vw', J.abs(), slack)
    if state not in QFRC_THROUGH_QACC:
      q_slack = q_slack * loose.to(q_slack)
  check_world_scale(got[2], want[2], 'qfrc_constraint', slack=q_slack)
  q_got, q_want = _t(got[2]), _t(want[2])
  q_past = ((q_got - q_want).abs() - (QACC_ATOL + QACC_RTOL * q_want.abs(
  ).amax(0, keepdim=True))).amax(0)
  share, diff = check_niter(got[3], want[3], state, cap)
  return {'qacc_max_abs_err': qacc_err, 'force_max_abs_err': force_err,
          'force_worlds': int(f_want.shape[1]), 'force_past_bar': past,
          'qfrc_past_bar': float(q_past.max()),
          'qfrc_worlds_past_bar': torch.nonzero(q_past > 0).reshape(-1),
          'niter_share': share, 'niter_max_diff': diff,
          'niter_mean': float(_t(want[3]).float().mean()),
          'gradient_worlds': int(by_grad.sum()),
          'loose_worlds': int(loose.sum())}
