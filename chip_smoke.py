"""Smoke run of the PyTorch + CUDA port on one CUDA device.

  python3 chip_smoke.py

Phases, one line each or more, any failure exits non-zero:
 1. device: needs CUDA; prints the card's name and power limit.
 2. build: compiles kernels/csrc with nvcc for sm_90a, one nvcc per source;
    prints ptxas's registers per kernel, and for K1 and K4 (on the
    humanoid), the mass chain (on the constraints, spheres and clutter
    sizes), the solve kernel (on each scene's sizes) and chol_batched (at
    n 75) the registers per thread, worlds per block and shared bytes per
    block they launch with.
 3. kernels against their plain PyTorch versions on the card at 1024
    worlds: K1 and K4 on the snapshot humanoid for a seeded state at rest
    (qpos0 + 0.01 N, qvel 0.2 N) and the same state lowered into the floor
    (contacts active), K1 with and without the factor; K1 and K4 also on
    the small gated scenes eq_joint (JOINT equality rows) and implicitfast
    (the implicitfast integrator), each at rest and with a body lowered
    into the floor, K1 with and without the factor and with collision off,
    and K4 on implicitfast with collision off (no rows: qacc from K1's
    qLD); the mass chain, the
    two Cholesky solves and the Newton solve on the snapshot constraints
    scene for its seeded state (qpos0 + 0.1 N, quaternions renormalised,
    qvel 0.2 N), each kernel fed the plain version's upstream outputs; the
    two Cholesky solves in both layouts they read in place (world-major,
    and a world() view of lanes-last).
 4. the fused main path: mujoco_warp_tpu_torch.benchmarks.run on the
    humanoid at 8192 worlds with world sorting every 4 steps and OU ctrl
    noise; the K1 and K4 launch counts must equal the steps run (the
    general kernels' stay 0), no world may overflow and every world must
    stay finite.  Then K1 and K4 against their plain versions again at
    8192 worlds, on the rollout's last state, and timed per launch; K4's
    profiled time at a 1 s pad and at kerneltime.PAD_S, in turns.
 5. the general main path: benchmarks.run on the constraints scene at
    8192 worlds; each of the four general kernels must launch once per
    step (K1's and K4's counts stay 0), no world may overflow and every
    world must stay finite.  Then the four kernels against their plain
    versions at 8192 worlds on the rollout's last state, each timed per
    launch beside its plain version, the one PyTorch call that computes
    the same function where there is one, and the world-major <->
    lanes-last transposes of its wrapper (none for the Cholesky solves).
 6. the large-tree contact path: benchmarks.run on the snapshot
    clutter_arm_nosleep (nv 75, 183 contact slots, nefc 732) at 4096
    worlds, CL_NSTEP steps after 10 warmup.  Exact launch counts: the mass
    chain and damped_solve once per step; chol_batched and chol_solve
    twice per step (qLD and the Newton's first gradient; qacc_smooth and
    the first gradient) plus once per Newton trip the solver counted; the
    solve kernel, K1 and K4 never.  No world may overflow, every world
    must stay finite, and the mean live contacts per world must be at
    least 20 at the end.  Then the four kernels of the path against their
    plain versions on the rollout's last state and timed, beside the one
    PyTorch call of the same function where there is one.
 7. contacts through the solve kernel, pyramidal: benchmarks.run on the
    snapshot spheres (nv 36, 33 contact slots of condim 3, 4 and 6, nefc
    192) at 8192 worlds, 150 steps after 10 warmup.  Exact launch counts:
    the mass chain, chol_solve and the solve kernel once per step;
    damped_solve, chol_batched, K1 and K4 never, and no trip of the torch
    Newton.  No world may overflow, every world must stay finite, and the
    mean live contacts per world must be at least SPHERES_MIN_CONTACTS at
    the end.  Then the solve kernel against its plain version on the
    rollout's last state, timed beside its plain version, its bound and
    its wrapper's transposes (no one PyTorch call computes a Newton
    solve); on spheres also chol_solve at n 36 (qacc_smooth), against its
    plain version in both layouts and timed beside torch.cholesky_solve,
    and the small-tree mass chain at nv 36 (mass_chain_n36), against its
    plain version and timed beside it.
 8. elliptic cones: the same on the snapshot spheres_elliptic (nefc 129)
    at 4096 worlds, through the solve kernel's elliptic form.
 9. dm_control on the fused step: benchmarks.run on the snapshot walker,
    cheetah, hopper and humanoid_dmc (its contacts compacted into
    {1: 16, 3: 32} slots) at 8192 worlds, DMC_NSTEP steps after 10
    warmup; the K1 and K4 counts must equal the steps run (the general
    kernels' stay 0), no world may overflow, every world stays finite.
    K1 and K4 against their plain versions on each rollout's last state
    (k1_walker, k4_walker and k1_cheetah, k4_cheetah timed there), and
    at 1024 worlds of the seeded contact state (parity.k1_case: the root
    lowered by parity.DMC_DROP) on hopper (k1_hopper, k4_hopper) and
    humanoid_dmc (k1_dmc, k4_dmc), timed there.
10. sensors on the general step: benchmarks.run(general=True), the public
    ops.forward.step, on humanoid_dmc at 8192 worlds, DMC_GEN_NSTEP steps
    after 10 warmup, and on hopper, HOP_GEN_NSTEP steps.  Exact counts:
    the mass chain, chol_solve, the solve kernel and damped_solve once
    per step; chol_batched, K1 and K4 never, and no trip of the torch
    Newton.  No overflow; qpos and every float of sensordata finite;
    prints the mean live contacts and the mean of each sensor type.  On
    each scene's last state, the four kernels against their plain
    versions at the rollout's width (as phase 3b; mass_chain_dmc,
    chol_solve_dmc, solve_dmc, damped_solve_dmc and the _hopper four),
    each timed; then one step of NSENSOR_CMP worlds of that state on the
    card and on the CPU through the plain versions, sensordata held by
    parity.check_sensors.
11. sleep, islands, CG and implicitfast: (a) benchmarks.run on the
    snapshot clutter_arm (sleep on) at 4096 worlds from its settled state
    (assets/clutter_arm_settled.npz), CA_NSTEP steps; exact counts as
    phase 6; prints the share of trees asleep at the start and the end,
    the mean nisland, the steps on which the island labeler ran, the
    packed steps and the host reads per step; its four kernels held
    against their plain versions on the last state and timed (*_ca).
    That start runs only the wake checks and the rows masked where trees
    sleep, so (a') runs clutter_arm again at 4096 worlds from the settled
    state woken at random (parity.woken_state: counters near ready),
    CA_WOKEN_NSTEP steps, exact counts; the island labeler must run and
    trees must fall asleep.  (b) the step that packs the awake worlds:
    the settled clutter.xml state at SKIP_NWORLD worlds, SKIP_NWAKE
    pushed awake, SKIP_NSTEP steps of forward.step, each packed, held
    against _step_batched (tree_asleep equal, qpos within 1e-6); the
    same at SKIP_WIDE (4096 worlds); each path warmed up by a step and
    timed in the order pack, full, full, pack; one step against the
    CPU's plain step.  (c) benchmarks.run on spheres_cg at 8192 worlds,
    CG_NSTEP steps after SLOW_WARMUP: the mass chain once per step, chol_solve twice plus
    once per CG trip, nothing else; prints the trips and capped worlds;
    chol_solve and the mass chain at n 36 held and timed (*_cg).  (d)
    humanoid_implicitfast on the fused step at 8192 worlds, IF_NSTEP
    steps: K1 and K4 once per step, held on the last state and timed
    (*_implicitfast).
12. tendons on the general step: benchmarks.run at 8192 worlds, TEN_NSTEP
    steps after 10 warmup, on ball_in_cup and point_mass (dm_control),
    sensors2 (mujoco_warp_tpu/models/sensors2.xml), tendon_wrap and
    tendon_mix (the port's assets).  Exact counts per step: the mass
    chain and chol_solve once; the solve kernel once where there are rows
    (ball_in_cup, point_mass, tendon_mix); damped_solve once where there
    is dof damping; on tendon_mix (tendon armature) the mass chain in its
    large-tree form and chol_batched once; K1, K4 and the torch Newton
    never.  No overflow; qpos, ten_length and sensordata finite; prints
    the share of worlds with an active tendon limit row (ball_in_cup
    fails without one: its string goes taut) and the wrapped share of
    each group of wrap geoms (tendon_wrap, tendon_mix).  On each scene's
    last state, its kernels against their plain versions at the
    rollout's width, timed (*_bic, *_pm, *_s2, *_twrap, *_tmix); one step
    of NSENSOR_CMP worlds on the card and on the CPU: ten_J within
    TEN_J_ATOL + TEN_J_RTOL, qpos at parity's bar, sensordata by
    parity.check_sensors.
13. cylinders, ellipsoids, RK4, the implicit integrators and inverse
    dynamics on the general step: benchmarks.run at 8192 worlds,
    CLS_NSTEP steps after 10 warmup (humanoid_CMU CMU_NSTEP after
    SLOW_WARMUP), on
    dm_control's pendulum, reacher, finger (elliptic cones through the
    solve kernel's elliptic form), cartpole and acrobot (RK4: four
    forwards per step) and humanoid_CMU (nv 62: the large-tree mass
    chain, chol_batched, the torch Newton; ellipsoids; 1157 candidates
    in 48 slots; from parity.dmc_state, lying on the floor, its
    contacts live), and constraints_implicitfast and cheetah_implicit.
    Exact counts per step (``classic_expect``): per forward the mass
    chain and chol_solve, chol_batched after the large-tree chain, the
    solve kernel or the torch Newton's chol_batched and chol_solve at its
    start and per trip; damped_solve under damped Euler; one chol_batched
    and one chol_solve on M - h qDeriv under IMPLICITFAST.  No overflow;
    qpos and sensordata finite.  On each scene's last state its kernels
    against their plain versions (the torch Newton's first H factored
    and solved; M - h qDeriv under IMPLICITFAST), timed (*_pend, *_reach,
    *_fin, *_rk4, *_acro, *_cmu, *_ifast, *_impl); one step of
    NSENSOR_CMP worlds on the card and on the CPU (qpos, sensordata).
    Then ops/inverse at 8192 worlds on constraints at the forward's
    converged qacc, plain and under INVDISCRETE: the mass chain once (and
    chol_solve once under INVDISCRETE), qfrc_inverse against the CPU's,
    and the round trip to qfrc_applied + qfrc_actuator.
14. elliptic cones in the torch Newton and CG, the public Data API, the
    contact override and float64: benchmarks.run at 8192 worlds from each
    scene's seeded contact state (benchmarks.start_state), TASK_NSTEP
    steps and warmup, on manipulator_insert_peg and stack_2 (the solve
    kernel's elliptic form at nefc 920 and 725; its registers, worlds and
    shared bytes per block printed), stack_4 (the torch elliptic Newton:
    chol_batched and chol_solve at its start and once per trip) and
    finger_cg (CG: chol_solve at its start and once per trip), as phase
    13 runs its scenes (exact counts, kernels held and timed: *_peg,
    *_st2, *_st4, *_fcg; one step of NSENSOR_CMP worlds against the CPU,
    CG's counts at parity's 'cg' bar with capped worlds left out).  Then
    io.put_data of host records named as MjData's fields (the card has no
    mujoco) at 8192 worlds, a step with exact counts, io.get_data_into
    against the CPU's; io.reset_data with a mask; io.override_model with
    the contact override, its tables equal to the CPU's and one step
    against the CPU's; a float64 Model on the card must raise.
15. domain randomization: humanoid_dmc_dr (benchmarks.randomize's
    per-world friction, masses and inertias, damping, armature, actuator
    gains and gravity, io.batch_model, then io.set_const at 8192 worlds:
    the mass chain, chol_batched and one chol_solve per dof, exact counts;
    its outputs on DR_NSC worlds within SC_RTOL of the world's scale of
    the CPU's plain set_const, SC_MINV_RTOL for those through M^-1, whose
    float32 rounding kappa(M) amplifies; M^-1 of chol_batched and
    chol_solve within SC_RTOL of their plain versions on the same qM; both
    timed on its own operands, *_sc); benchmarks.run at 8192 worlds, DR_NSTEP steps
    and WARMUP, sorted with their parameters (exact counts, steps/s, ms
    and host reads per step, kernels per step, overflow 0, every world
    finite; the sorted Model's worlds are the Data's); the general
    kernels held and timed on the last state with each world's tables
    (*_dr: the mass chain, chol_solve, the solve kernel, damped_solve);
    the mass chain and damped_solve with every world carrying the
    unbatched values equal to the unbatched kernels to the bit; and
    DR_KEEP_NSTEP steps sorted (every world moved) against unsorted,
    the order undone, within parity's qpos bar (beside the error of the
    same sort with the parameters left in their slots, for scale).
16. actuation (activation dynamics, muscles, DC motors, the site,
    slider-crank and body transmissions): dm_control's quadruped (nv 22,
    12 FILTER actuators on tendons and joints, the solve kernel at nefc
    300) and dog (nv 79, 38 FILTER actuators, 6273 candidates in 144
    slots, the large-tree mass chain and the torch Newton at nefc 793) at
    8192 worlds from parity.dmc_state tiled, ACT_NSTEP steps and warmup,
    as phase 13 runs its scenes (exact counts, kernels held and timed:
    *_qd, *_dog; one step of ACT_NCMP worlds against the CPU, act
    included), with steps/s, overflow and converged worlds, live contacts
    per world (which must be above 0), act's range and the rollout's peak
    device memory; then the test scenes dcmotor, transmission and
    actuator_mix (io.ACT_SNAPSHOTS) at ACT_TEST_NWORLD worlds for
    ACT_TEST_NSTEP steps the same way (*_dcm, *_trn, *_amix);
    transmission's solve at parity's 'adhesion' bar, with the worlds
    where the kernel's qfrc_constraint lies past the plain bar (or the
    nearest) held beside the float64 optimum (qfrc_witness), and their
    stop quantities traced trip by trip on the kernel and its plain
    version (trip_trace).
17. fluid forces, rays and height fields: dm_control's swimmer6 (nefc
    697 through the solve kernel), swimmer15 (1037 candidates in 48
    slots, contacts off), fish (the inertia-box fluid model, constraints
    off) and quadruped escape (its seeded 201 x 201 terrain, 19
    height-field pairs, 20 rangefinders, the solve kernel at nefc 488) at
    8192 worlds, FLU_NSTEP steps and warmup each (escape from
    parity.dmc_state tiled, the others qpos0 plus noise), then the test
    scenes sensors, contact_sensor, fluid_ellipsoid and geomdist at 8192
    worlds for FLU_TEST_NSTEP steps, each as phase 13 runs its scenes
    (exact counts, kernels held and timed: *_sw6, *_sw15, *_fish,
    *_esc, *_sens, *_csens, *_fell, *_gdist; one step against the CPU by
    sensordata), with each scene's mean per sensor type, the rangefinders'
    hit share, and on escape the ray walk's trips per step and the host
    and wall ms of one rangefinder pass and of the height-field collider.
18. mocap bodies, delay histories, gravity compensation, site-anchored
    equality, the joint-in-parent transmission and RK4 with sleep:
    mocap_arm (nv 21, the small-tree mass chain, IMPLICITFAST's
    chol_batched and chol_solve on M - h qDeriv, the solve kernel at
    nefc 119 on its weld, connect, limit and contact rows) at 8192
    worlds, ARM_NSTEP steps and warmup with the mocap target fixed, as
    phase 13 runs its scenes (exact counts, kernels held and timed:
    *_arm; one step of NSENSOR_CMP worlds against the CPU); then
    ARM_DRIVE_NSTEP steps of the public ops.forward.step, each world's
    mocap target moved along a seeded path and its ctrl drawn from a
    seed before every step: exact counts, every world's mocap body at
    its target (xpos), and every delayed actuator whose delay is a whole
    number of steps reading the ctrl put in that many steps before;
    clutter_arm_rk4 (clutter_arm under RK4, sleep on) at 4096 worlds
    from the settled state woken at random (parity.woken_state),
    RK4S_NSTEP steps and warmup (every forward kernel four times a step,
    the torch Newton's chol_batched and chol_solve once per trip: exact
    counts; *_rk4s; one step against the CPU, the skip step on both);
    each scene's steps/s and its idle share from a torch.profiler trace
    of IDLE_NSTEP steps of its last state.
19. every per-world field of the JAX batched step: quadruped_dr (link
    lengths, hip orientations, joint ranges, springs and solref, tendon
    damping, equality solref, impratio and solver tolerances drawn per
    world) at 8192 worlds: set_const on the card with exact counts
    against the CPU's on DR_NSC worlds; QDR_NSTEP steps and warmup from
    parity.dmc_state, phase 16's quadruped depth (exact counts, overflow
    0, finite, steps/s, idle share; live contacts at least
    QDR_MIN_CONTACT_SHARE of that quadruped's, printed beside its Newton
    mean and trunk height); its kernels held and timed on the last state
    (*_qdr; the solve at parity's 'dmc' bar, its loose worlds'
    qfrc_constraint with the rows' slack, and qfrc_witness), the solve
    kernel's profiler reading window by window (QDR_WINDOWS: launches
    seen, their spread, other kernels in the trace) beside CUDA events;
    the solve
    kernel with W copies of the unbatched tolerances against the
    unbatched launch to the bit, QDR_OWN worlds against launches with
    their own tolerances in every world to the bit, world 0's tolerances
    in every world as a planted fault that must move some world, and its
    time per call with per-world against shared tolerances; one step of
    QDR_NCMP worlds against the CPU; sorted against unsorted; and the
    elliptic form on stack_2 at QDR_ELL_NWORLD worlds with per-world
    impratio and tolerances, QDR_ELL_NSTEP steps from its start state.
 Phase 3 also holds those four kernels (the mass chain in its large-tree
 form, whose qM is world-major, chol_batched on qM and on the Newton H,
 chol_solve and damped_solve at n 75 in both layouts) against their plain
 versions at 1024 worlds of
 the seeded contact-rich clutter state (parity.clutter_state), and the
 solve kernel in both its contact forms against its plain version at
 1024 worlds of the seeded spheres state of each cone
 (parity.spheres_state, with live contacts in all three elliptic zones,
 whose counts it prints).
A kernel's time is its own device time per launch, read with
torch.profiler from up to WINDOWS traces of 20 launches each until they
hold 20 ('ms_source' "profiler", with 'launches_seen' the launches the
traces held); where they held fewer than MIN_SEEN, the wall time of one
wrapper call (CUDA events over 20 calls) stands in ('ms_source'
"events").  'call' beside it is that wall
time, which the host's work bounds for the short kernels.
The tolerances are those of mujoco_warp_tpu_torch.parity.  The last three
lines are the kernel JSON (every kernel with its launches on its main
path, error, times and its bound on this card; for K1, K4, the mass
chain, the solve kernel and chol_batched also the registers, worlds per
block and shared bytes per block they launch with), the nvidia-smi line
(name and power limit) and the device JSON.  '[phase N] at T s' lines
give the seconds since the start at each phase.
"""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# every rollout runs its scene at the width benchmarks.SCENES registers
NSTEP = 300
GEN_NSTEP = 100
# clutter's bodies land within ~60 steps, 25 live contacts per world from
# then on
CL_NSTEP = 75
# the spheres scenes' bodies fall onto the floor within ~140 steps
SP_NSTEP = 150
SPHERES_MIN_CONTACTS = 10.0
# the dm_control scenes: fused rollouts, the general step with sensors on
# humanoid_dmc and hopper, and the worlds of the card-against-CPU step
DMC_NSTEP = 200
# (the general steps with sensors run a fraction of their first depth
# since phases 14 and 19 came, to keep the whole run near its length)
DMC_GEN_NSTEP = 40
HOP_GEN_NSTEP = 25
NSENSOR_CMP = 256
# phase 11: clutter_arm with sleep (from its settled state); the skip
# step's worlds and steps; spheres_cg's steps after its warmup (2.3-2.6 s
# per step on an H100 80GB HBM3 at 700 W); humanoid_implicitfast.
# clutter_arm, the skip step and spheres_cg run a few steps each, to keep
# the whole run near its length
CA_NSTEP = 20
# clutter_arm again from a woken start (trees near ready fall asleep)
CA_WOKEN_NSTEP = 10
SKIP_NWORLD, SKIP_NWAKE, SKIP_NSTEP = 256, 20, 10
# the skip step at clutter_arm's registered width: worlds, woken, steps
SKIP_WIDE = (4096, 200, 5)
CG_NSTEP = 2
# warmup steps of spheres_cg and humanoid_CMU (a few seconds a step: the
# first steps' builds fall in these, and the timed loop starts after)
SLOW_WARMUP = 2
IF_NSTEP = 200
# phase 12: the tendon scenes, steps after the warmup
TEN_NSTEP = 100
TEN_SFX = {'ball_in_cup': '_bic', 'point_mass': '_pm', 'sensors2': '_s2',
           'tendon_wrap': '_twrap', 'tendon_mix': '_tmix'}
# the kernels each tendon scene's step launches, each once per step: the
# mass chain and chol_solve always; the solve kernel where there are rows;
# damped_solve where there is dof damping; chol_batched after the
# large-tree mass chain where a tendon has armature (tendon_mix)
TEN_KERNELS = {
    'ball_in_cup': ('mass_chain', 'chol_solve', 'solve', 'damped_solve'),
    'point_mass': ('mass_chain', 'chol_solve', 'solve', 'damped_solve'),
    'sensors2': ('mass_chain', 'chol_solve'),
    'tendon_wrap': ('mass_chain', 'chol_solve', 'damped_solve'),
    'tendon_mix': ('mass_chain', 'chol_batched', 'chol_solve', 'solve',
                   'damped_solve')}
# ten_J of one card step against the CPU's: atol + rtol of each entry
TEN_J_ATOL, TEN_J_RTOL = 1e-4, 1e-4
# phase 13: dm_control's classic tasks and the integrator scenes on the
# general step, steps after the warmup (humanoid_CMU, ~1.3 s per step on
# an H100 80GB HBM3 at 700 W, fewer), and the key suffix of each scene's
# kernels; humanoid_CMU starts from parity.dmc_state (lying on the floor,
# its contacts live), where qpos0 holds it a metre up through these steps
CLS_NSTEP = 10
CMU_NSTEP = 2
CLS_SFX = {'pendulum': '_pend', 'reacher': '_reach', 'finger': '_fin',
           'cartpole': '_rk4', 'acrobot': '_acro', 'humanoid_CMU': '_cmu',
           'constraints_implicitfast': '_ifast',
           'cheetah_implicit': '_impl'}
# phase 14: the elliptic-cone tasks on the general step, steps after the
# warmup, each from its seeded contact state tiled to the width
# (benchmarks.start_state: io.TASK_STARTS, made by io.make_task_start),
# and the key suffix of each scene's kernels
# (steps, warmup steps): stack_4 takes ~3.3 s per step and finger_cg ~18
# s (its float32 CG runs some worlds to the 200-trip cap every step) on an
# H100 80GB HBM3 at 700 W
TASK_NSTEP = {'manipulator_insert_peg': (10, 5), 'stack_2': (10, 5),
              'stack_4': (1, 1), 'finger_cg': (1, 1)}
TASK_SFX = {'manipulator_insert_peg': '_peg', 'stack_2': '_st2',
            'stack_4': '_st4', 'finger_cg': '_fcg'}
# phase 15: domain randomization (humanoid_dmc_dr), steps after the
# warmup; the steps a sorted and an unsorted run take side by side; the
# worlds set_const's card run is held against the CPU's at; its bar
DR_NSTEP = 30
DR_KEEP_NSTEP = 8
DR_NSC = 256
SC_RTOL = 1e-5
# set_const's outputs through M^-1 (the invweights, actuator_acc0), card
# against CPU: the float32 rounding of qM alone moves the exact inverse by
# up to 1.10e-5 of the world's scale on these draws (kappa(M) up to 5.0e3),
# and the CPU's float32 set_const lies up to 1.46e-5 from float64; two
# float32 runs part by up to the sum
SC_MINV_RTOL = 4e-5
SC_MINV = ('dof_invweight0', 'body_invweight0', 'tendon_invweight0',
           'actuator_acc0')
# phase 16: actuation on the general step.  dm_control's quadruped and dog
# from their seeded contact states (parity.dmc_state: the root lowered by
# parity.DMC_DROP, 64 worlds tiled to the width), (steps, warmup) each;
# then the test scenes dcmotor, transmission and actuator_mix
# (io.ACT_SNAPSHOTS, qpos0 + noise) at ACT_TEST_NWORLD worlds for
# ACT_TEST_NSTEP steps after 2 of warmup; the key suffix of each scene's
# kernels; the worlds of each scene's one step against the CPU
ACT_NSTEP = {'quadruped': (20, 5), 'dog': (1, 1)}
ACT_TEST_NWORLD, ACT_TEST_NSTEP = 8192, 5
ACT_SFX = {'quadruped': '_qd', 'dog': '_dog', 'dcmotor': '_dcm',
           'transmission': '_trn', 'actuator_mix': '_amix'}
ACT_NCMP = {'quadruped': 1024, 'dog': 16}
# the worlds of transmission whose stop quantities trip_trace follows
# beside those qfrc_witness picks (the three the last chip run named)
TRACE_WORLDS = (4450, 7873, 6811)
# phase 17: fluid forces, rays and height fields on the general step.
# dm_control's swimmer6, swimmer15, fish and quadruped escape at their
# width, (steps, warmup) each, escape from parity.dmc_state (64 worlds
# tiled), the others from qpos0 plus noise; the test scenes sensors,
# contact_sensor, fluid_ellipsoid and geomdist at their width for
# FLU_TEST_NSTEP steps after 2 of warmup; the key suffix of each scene's
# kernels (each scene's one step against the CPU takes NSENSOR_CMP worlds)
FLU_NSTEP = {'swimmer6': (10, 3), 'swimmer15': (10, 3), 'fish': (5, 2),
             'quadruped_escape': (5, 2)}
FLU_TEST_NSTEP = 3
FLU_SFX = {'swimmer6': '_sw6', 'swimmer15': '_sw15', 'fish': '_fish',
           'quadruped_escape': '_esc', 'sensors': '_sens',
           'contact_sensor': '_csens', 'fluid_ellipsoid': '_fell',
           'geomdist': '_gdist'}
# phase 18: mocap_arm (steps, warmup) of the rollout, then steps of the
# mocap-driven public step; clutter_arm_rk4 (steps, warmup) from its
# settled state woken at random; steps traced for each scene's idle share
ARM_NSTEP = (20, 3)
ARM_DRIVE_NSTEP = 10
RK4S_NSTEP = (3, 1)
IDLE_NSTEP = {'mocap_arm': 3, 'clutter_arm_rk4': 1, 'quadruped_dr': 3}
ARM_SFX = {'mocap_arm': '_arm', 'clutter_arm_rk4': '_rk4s'}
# phase 19: quadruped_dr (steps, warmup) from the quadruped's seeded
# contact state; steps of the sorted-against-unsorted check; the worlds of
# its one step against the CPU; its key suffix; the elliptic form's check
# on stack_2 with per-world impratio and tolerances: worlds, key suffix
QDR_NSTEP = ACT_NSTEP['quadruped']
# quadruped_dr's live contacts per world at the end, at least this share
# of phase 16's quadruped's: the drawn worlds keep their feet on the floor
QDR_MIN_CONTACT_SHARE = 0.5
# profiler windows of NTIME calls read one by one for the per-world solve
QDR_WINDOWS = 2
QDR_KEEP_NSTEP = 4
QDR_NCMP = 256
QDR_SFX = '_qdr'
QDR_ELL_NWORLD, QDR_ELL_NSTEP = 2048, 5
# worlds of the per-world solve each held against its own shared launch
QDR_OWN = 5
# worlds of qfrc_witness where no world lies past the bar
QFRC_WITNESS = 4
WARMUP = 10
NCMP = 1024
# profiler timing: launches per trace, traces per kernel at most, the
# least launches the traces must hold (each trace idles
# ``kerneltime.PAD_S`` on each side of its calls)
NTIME, WINDOWS, MIN_SEEN = 20, 4, 10
# H100 SXM peaks: HBM bytes/s, float32 flop/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
F32 = 4


def fail(msg):
  print(f'FAIL: {msg}', flush=True)
  sys.exit(1)


def say(msg):
  print(msg, flush=True)


def time_ms(fn, reps):
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel):
  """(ms, source, seen): the kernel's own device time per launch; ``fn``
  launches ``kernel`` once per call and ``torch.profiler`` records each
  launch's duration on the card (``kerneltime.profiled_ms``).  (A wall-
  clock time over the calls would measure the wrapper's host work for
  kernels shorter than it.)  The trace drops launches, more of them the
  longer the process has run (7 of 20 late in a run, for a 0.05 ms and
  a 14 ms kernel alike), so up to WINDOWS traces of NTIME calls each are
  read until they hold NTIME launches in all.  When they hold fewer than
  MIN_SEEN, the time per call from CUDA events stands in (source
  'events')."""
  from mujoco_warp_tpu_torch.kerneltime import profiled_ms
  total, seen = 0.0, 0
  for w in range(WINDOWS):
    mean, n = profiled_ms(torch, fn, NTIME, kernel)
    total, seen = total + (mean or 0.0) * n, seen + n
    if seen >= NTIME:
      break
  if seen < NTIME * (w + 1):
    say(f'[timing] profiler saw {seen} of {NTIME * (w + 1)} launches of '
        f'{kernel}' + ('; timed with CUDA events instead'
                       if seen < MIN_SEEN else ''))
  if seen < MIN_SEEN:
    return time_ms(fn, NTIME), 'events', seen
  return total / seen, 'profiler', seen


def profile_windows(fn, kernel, windows):
  """``windows`` profiler windows of NTIME calls of ``fn``, each followed
  by CUDA events over NTIME calls: per window the launches of ``kernel``
  the trace held, their least, median and largest ms and the first
  three in the order they ran, the kernels of other names the trace
  held, and the events' ms per call."""
  from mujoco_warp_tpu_torch.kerneltime import profiled_launches
  out = []
  for _ in range(windows):
    ms, others = profiled_launches(torch, fn, NTIME, kernel)
    srt = sorted(ms)
    out.append({'seen': len(ms),
                'min': round(srt[0], 4) if ms else None,
                'median': round(srt[len(srt) // 2], 4) if ms else None,
                'max': round(srt[-1], 4) if ms else None,
                'first': [round(x, 4) for x in ms[:3]], 'others': others,
                'events_ms': round(time_ms(fn, NTIME), 4)})
  return out


def bound(nbytes, flops):
  """The least time (ms) the card could take: the larger of the bytes over
  the memory rate and the flops over the float32 rate, and which one."""
  tb, tf = nbytes / PEAK_BYTES, flops / PEAK_F32
  return 1e3 * max(tb, tf), 'bytes' if tb >= tf else 'operations'


def chol_solve_bytes(n, w, shared_b=False):
  """Bytes w worlds' x = (L L^T)^-1 b must move: each world's lower
  triangle of L (all of L the solve reads) and x, and b per world or, at
  world stride 0 (``shared_b``), once."""
  return F32 * (w * (n * (n + 1) // 2 + n) + (1 if shared_b else w) * n)


def chol_batched_bytes(n, w):
  """Bytes w worlds' L L^T = A must move: each world's lower triangle of A
  (all of A the factor reads) and the n^2 of L it writes."""
  return F32 * w * (n * (n + 1) // 2 + n * n)


def chol_flops(n):
  """Flops of one n x n Cholesky factor (n^3 / 3 multiply-adds)."""
  return sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))


def mass_chain_flops(m, factor):
  """Flops of one world's mass chain: crb, qM, [factor], com_vel,
  cdof_dot and RNE, counted from the model's tree."""
  nb, nv = m.nbody, m.nv
  anc = m.tree.ancestor_mask
  pairs = int(np.sum(anc | anc.T))
  rne = sum(12 * int(m.body_dofnum[b]) + 2 * 72 + 3 * 15 + 12
            for b in range(1, nb))
  return (36 * (nb - 1) + 72 * nv + 12 * pairs + nv +
          (chol_flops(nv) if factor else 0) + 12 * nv +
          12 * int(m.tree.cdofdot_mask.sum()) + 30 * nv + rne +
          6 * (nb - 1) + 12 * nv)


def newton_flops(nrow, nv, niter):
  """A lower estimate of one world's Newton solve: one H build and factor,
  then per iteration J v, J^T f, M v, the two substitutions and the
  linesearch's row terms."""
  return (nrow * nv * nv + chol_flops(nv) +
          niter * (4 * nrow * nv + 8 * nv * nv + 60 * nrow))


def newton_ell_flops(nrow, nv, niter):
  """``newton_flops`` plus the H build and factor of every iteration, as
  the elliptic form rebuilds H each time."""
  return newton_flops(nrow, nv, niter) + niter * (nrow * nv * nv +
                                                  chol_flops(nv))


def main():
  T0 = time.perf_counter()
  # ---- 1. device
  if not torch.cuda.is_available():
    print('FAIL: no CUDA device', flush=True)
    sys.exit(2)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ''
  if smi.returncode != 0 or not card.rstrip().endswith('W'):
    fail(f'nvidia-smi gave no name and power limit (rc {smi.returncode}): '
         f'{smi.stdout.strip()} {smi.stderr.strip()}')
  kind = torch.cuda.get_device_name(0)
  say(f'[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} '
      f'cuda {torch.version.cuda}')

  from mujoco_warp_tpu_torch import benchmarks, devprofile, io, \
      kerneltime, parity, types
  from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref, solver_ref
  from mujoco_warp_tpu_torch.kernels import build, lanes, world
  from mujoco_warp_tpu_torch.kernels import k1 as kk1
  from mujoco_warp_tpu_torch.kernels import k4 as kk4
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  from mujoco_warp_tpu_torch.ops import collision_driver as ocollision_driver
  from mujoco_warp_tpu_torch.ops import derivative as oderiv
  from mujoco_warp_tpu_torch.ops import forward
  from mujoco_warp_tpu_torch.ops import history as ohistory
  from mujoco_warp_tpu_torch.ops import inverse as oinverse
  from mujoco_warp_tpu_torch.ops import ray as oray
  from mujoco_warp_tpu_torch.ops import sensor as osensor
  from mujoco_warp_tpu_torch.ops import smooth as osmooth
  from mujoco_warp_tpu_torch.ops import solver as osolver
  from mujoco_warp_tpu_torch.ops import util as outil

  # ---- 2. build
  say(f'[phase 2] at {time.perf_counter() - T0:.1f} s')
  t0 = time.perf_counter()
  build.load()
  say(f'[build] {build.BuildInfo.path} in {time.perf_counter() - t0:.1f} s '
      f'(nvcc {build.BuildInfo.seconds:.1f} s)')
  for line in build.BuildInfo.log.splitlines():
    if 'registers' in line or 'spill' in line or 'error' in line:
      say(f'[build] ptxas: {line.strip()}')

  dev = torch.device('cuda')

  def scene(name):
    """The scene's snapshot model and its registered width."""
    path, nworld = benchmarks.SCENES[name]
    return io.load_model_npz(path), nworld

  m, w_h = scene('humanoid')
  mc, w_c = scene('constraints')
  mcl, w_cl = scene('clutter_arm_nosleep')
  msp, w_sp = scene('spheres')
  mse, w_se = scene('spheres_elliptic')
  # the one-warp-per-world kernels' launch shapes at the scenes' sizes
  shapes = {'k4': kk4.kernel_info(m), 'k1': kk1.kernel_info(m)}
  say(f'[kernels] k4 on humanoid (nrow {kk4.nrow(m)}, nv {m.nv}): '
      + json.dumps(shapes['k4']))
  say(f'[kernels] k1 on humanoid (nv {m.nv}, nbody {m.nbody}, ncand '
      f'{m.ncand}, no factor): ' + json.dumps(shapes['k1']))
  for key, label, model in (('mass_chain', 'constraints', mc),
                            ('mass_chain_n36', 'spheres', msp),
                            ('mass_chain_big', 'clutter_arm_nosleep', mcl)):
    shapes[key] = kmass.kernel_info(model)
    say(f'[kernels] mass chain on {label} (nv {model.nv}, nbody '
        f'{model.nbody}): ' + json.dumps(shapes[key]))
  for key, label, model in (('solve', 'constraints', mc),
                            ('solve_spheres', 'spheres', msp),
                            ('solve_elliptic', 'spheres_elliptic', mse)):
    shapes[key] = ksolver.kernel_info(model)
    say(f'[kernels] solve on {label} (nefc {model.nefc}, nv {model.nv}): '
        + json.dumps(shapes[key]))
  shapes['chol_batched'] = klinalg.chol_batched_info(mcl.nv)
  say(f'[kernels] chol_batched at n {mcl.nv}: '
      + json.dumps(shapes['chol_batched']))
  err = {k: 0.0 for k in build.KERNELS + (
      'mass_chain_big', 'mass_chain_n36', 'chol_solve_n36', 'chol_solve_n75',
      'damped_solve_n75', 'solve_spheres', 'solve_elliptic') + tuple(
          k + sfx for sfx in ('_walker', '_cheetah', '_hopper', '_dmc')
          for k in ('k1', 'k4')) + tuple(
          k + sfx for sfx in ('_hopper', '_dmc')
          for k in ('mass_chain', 'chol_solve', 'solve', 'damped_solve')) +
      tuple(k + '_ca' for k in ('mass_chain_big', 'chol_batched',
                                'chol_solve_n75', 'damped_solve_n75')) +
      ('chol_solve_n36_cg', 'mass_chain_n36_cg', 'k1_implicitfast',
       'k4_implicitfast') + tuple(
          k + sfx for sfx in (*TEN_SFX.values(), *CLS_SFX.values(),
                              *TASK_SFX.values(), '_dr',
                              *ACT_SFX.values(), *FLU_SFX.values(),
                              *ARM_SFX.values(), QDR_SFX)
          for k in ('mass_chain', 'chol_batched', 'chol_solve', 'solve',
                    'damped_solve')) + ('chol_batched_sc', 'chol_solve_sc')}

  def counters():
    return {'k1': kk1.launches, 'k4': kk4.launches,
            'mass_chain': kmass.launches, 'solve': ksolver.launches,
            **klinalg.launches}

  def zero_counters():
    kk1.launches = kk4.launches = kmass.launches = ksolver.launches = 0
    osolver.trips = forward.island_runs = forward.packed_steps = 0
    for k in outil.host_reads:
      outil.host_reads[k] = 0
    for k in klinalg.launches:
      klinalg.launches[k] = 0

  SB = (parity.SOLVE_ATOL, parity.SOLVE_RTOL)

  def layouts(x):
    """World-major x in the two layouts the Cholesky solves read in
    place: contiguous, and a world() view of its lanes-last copy."""
    shape = tuple(x.shape[1:])
    return {'world-major': x.contiguous(),
            'lanes-last': world(lanes(x, int(np.prod(shape))), *shape)}

  def yardsticks(acs, ads=None, dmp=None):
    """The plain version and the one PyTorch call of the same function
    (``torch.cholesky_solve``, ``torch.linalg.solve``) for chol_solve_batched
    arguments ``acs`` and damped_solve_batched arguments ``ads`` (``dmp``:
    h damping, (n,) or lanes-last (n, 1 or W) per world), their inputs
    made ahead so that each call times only its own work: a dict of name
    -> call."""
    n = acs[2].shape[1]
    pcs = (lanes(acs[1], n * n), lanes(acs[2]))
    L_w, b_w = acs[1].contiguous(), acs[2].contiguous()[:, :, None]
    out = {'chol_solve_plain': lambda: klinalg.chol_solve_plain(*pcs),
           'chol_solve_library': lambda: torch.cholesky_solve(b_w, L_w)}
    if ads is not None:
      pds = (lanes(ads[1], n * n), lanes(ads[2]), dmp)
      M_w = ads[1].contiguous()
      A_w = M_w + torch.diag_embed(dmp.reshape(n, -1).T)
      rhs_w = torch.einsum('wij,wj->wi', M_w, ads[2])
      out['damped_solve_plain'] = lambda: klinalg.damped_solve_plain(*pds)
      out['damped_solve_library'] = lambda: torch.linalg.solve(A_w, rhs_w)
    return out

  def check_layouts(fn, model, mat, vec, want, name):
    """fn (chol_solve_batched or damped_solve_batched) on (mat, vec) in
    both layouts against the plain version's lanes-last ``want``.
    Returns the max abs error."""
    return max(parity.check_world_scale(
        fn(model, layouts(mat)[k], layouts(vec)[k]).T, want,
        f'{name} ({k})', *SB) for k in ('world-major', 'lanes-last'))

  # ---- 3a. the fused kernels against their plain versions
  say(f'[phase 3a] at {time.perf_counter() - T0:.1f} s')
  def compare(label, qpos, qvel, ctrl, ws, state, need_qLD, model=m,
              suffix=''):
    """K1 and K4 against their plain versions on one lanes-last state of
    ``model``; K4 gets the plain K1's outputs on both sides; the errors go
    to err['k1' + suffix] and err['k4' + suffix].  Returns those outputs,
    K4's args and the plain K4's mean Newton count."""
    got1 = kk1.k1(model, qpos, qvel, need_qLD=need_qLD)
    want1 = k1_ref.k1(model, qpos, qvel, need_qLD=need_qLD)
    try:
      e1, rel1 = parity.check_k1(got1, want1)
    except AssertionError as e:
      fail(f'{label}: {e}')
    qM, qLD, bias, cdof, dist, cpos, cframe, stcom = want1
    make = glue.compact if model.con_compact else glue.identity_con
    con, _ = make(model, dist, cpos, cframe, stcom)
    qfs = glue.middle(model, bias, qpos, qvel, ctrl)
    args = (model, qM, qLD if not k4_ref.has_rows(model) else None, qfs, ws,
            qvel, qpos, cdof, con)
    got4, want4 = kk4.k4(*args), k4_ref.k4(*args)
    try:
      r4 = parity.check_k4(got4, want4, qvel,
                           float(k4_ref.scalars(model)[3]), state)
    except AssertionError as e:
      fail(f'{label} K4: {e}')
    err['k1' + suffix] = max(err['k1' + suffix], e1)
    err['k4' + suffix] = max(err['k4' + suffix], r4['qacc_max_abs_err'])
    act = int((con['dist'] < con['im']).sum())
    say(f'[compare] {label}: K1 max abs err {e1:.3e}, worst relative '
        f'{rel1:.2e} (tol {parity.K1_TOL}); K4 qacc max abs err '
        f'{r4["qacc_max_abs_err"]:.3e} within atol {parity.QACC_ATOL} + '
        f'rtol {parity.QACC_RTOL} of world scale; niter equal in '
        f'{r4["niter_share"]:.4f} of worlds (bar '
        f'{parity.NITER_SHARE[state]}), max diff {r4["niter_max_diff"]} '
        f'(bar {parity.NITER_MAX_DIFF}); niter mean {r4["niter_mean"]:.3f}; '
        f'active contacts {act}')
    return want1, args, float(want4[4].float().mean())

  for state, drop in parity.DROP.items():
    qpos, qvel, ctrl, ws = [torch.as_tensor(x, device=dev) for x in
                            parity.lane_state(m, NCMP, 7, drop)]
    compare(f'{state} W={NCMP}', qpos, qvel, ctrl, ws, state, True)

  # K1's other forms: without the factor, the small gated scenes, collision
  # off
  for scene, state in (('humanoid', 'rest'), ('humanoid', 'contact'),
                       ('eq_joint', 'rest'), ('eq_joint', 'contact'),
                       ('implicitfast', 'rest'), ('implicitfast', 'contact'),
                       ('implicitfast_no_rows', 'rest')):
    mk, qpos, qvel, _, _ = parity.k1_case(scene, state, NCMP, 7, dev)
    for need in ((False,) if scene == 'humanoid' else (True, False)):
      try:
        e1, rel1 = parity.check_k1(kk1.k1(mk, qpos, qvel, need_qLD=need),
                                   k1_ref.k1(mk, qpos, qvel, need_qLD=need))
      except AssertionError as e:
        fail(f'{scene} {state} W={NCMP} K1 (need_qLD {need}): {e}')
      err['k1'] = max(err['k1'], e1)
      say(f'[compare] {scene} {state} W={NCMP}: K1 (need_qLD {need}, '
          f'collision {kk1.run_col(mk)}) max abs err {e1:.3e}, worst '
          f'relative {rel1:.2e} (tol {parity.K1_TOL})')

  # K4's other forms: JOINT equality rows, implicitfast, no rows
  for scene, state in (('eq_joint', 'rest'), ('eq_joint', 'contact'),
                       ('implicitfast', 'rest'), ('implicitfast', 'contact'),
                       ('implicitfast_no_rows', 'rest')):
    ms, a4s = parity.k4_case(scene, state, NCMP, 7, dev)
    try:
      r4 = parity.check_k4(kk4.k4(*a4s), k4_ref.k4(*a4s), a4s[5],
                           float(k4_ref.scalars(ms)[3]), state)
    except AssertionError as e:
      fail(f'{scene} {state} W={NCMP} K4: {e}')
    err['k4'] = max(err['k4'], r4['qacc_max_abs_err'])
    act = 0 if a4s[8] is None else int(
        (a4s[8]['dist'] < a4s[8]['im']).sum())
    say(f'[compare] {scene} {state} W={NCMP}: K4 (nrow '
        f'{kk4.nrow(ms) if k4_ref.has_rows(ms) else 0}, nv {ms.nv}) qacc '
        f'max abs err {r4["qacc_max_abs_err"]:.3e}; niter equal in '
        f'{r4["niter_share"]:.4f} of worlds (bar '
        f'{parity.NITER_SHARE[state]}), max diff {r4["niter_max_diff"]}; '
        f'niter mean {r4["niter_mean"]:.3f}; active contacts {act}')

  # ---- 3b. the general step's kernels against their plain versions
  say(f'[phase 3b] at {time.perf_counter() - T0:.1f} s')
  nv, nb = mc.nv, mc.nbody

  def general_compare(label, d, model=mc, suffix='', state='constraints'):
    """The four kernels against their plain versions on world-major state
    d (qpos, qvel, ctrl, qacc_warmstart) of small-tree ``model``; each
    kernel gets the plain version's upstream outputs; the errors go to
    err[kernel + suffix].  Returns each kernel's arguments and the plain
    solve's mean Newton count."""
    nv, nb = model.nv, model.nbody
    d = forward.pre(model, d)
    args = {'mass_chain': (model, lanes(d.cinert, 36 * nb),
                           lanes(d.cdof, 6 * nv), lanes(d.qvel))}
    got, want = (kmass.mass_chain_lanes(*args['mass_chain']),
                 kmass.mass_chain_plain(*args['mass_chain']))
    try:
      e_mc, rel_mc = parity.check_rel(got, want, parity.MASS_NAMES)
      qM, qLD, cvel, cdd, bias = want
      d = forward.mid(model, d.replace(
          qM=world(qM, nv, nv), qLD=world(qLD, nv, nv),
          cvel=world(cvel, nb, 6), cdof_dot=world(cdd, nv, 6),
          qfrc_bias=bias.T))
      # the main path's layouts: qLD a world() view, qfrc_smooth as the
      # forces leave it
      args['chol_solve'] = (model, d.qLD, d.qfrc_smooth)
      want = klinalg.chol_solve_plain(qLD, lanes(d.qfrc_smooth))
      e_cs = check_layouts(klinalg.chol_solve_batched, *args['chol_solve'],
                           want, 'qacc_smooth')
      d = d.replace(qacc_smooth=want.T)
      args['solve'] = (model, lanes(d.efc_J), lanes(d.efc_D),
                       lanes(d.efc_aref), lanes(d.efc_frictionloss),
                       lanes(d.qM), lanes(d.qfrc_smooth),
                       lanes(d.qacc_warmstart))
      got, want = (ksolver.solve_tiles(*args['solve']),
                   solver_ref.solve_tiles(*args['solve']))
      rs = parity.check_solve(got, want, state, args['solve'][1:3])
      args['damped_solve'] = (model, d.qM, want[0].T)
      dmp = klinalg.world_damping(model).to(dev)
      e_ds = check_layouts(klinalg.damped_solve_batched,
                           *args['damped_solve'],
                           klinalg.damped_solve_plain(qM, want[0], dmp),
                           'qacc (damped)')
    except AssertionError as e:
      fail(f'{label}: {e}')
    for k, e in (('mass_chain', e_mc), ('chol_solve', e_cs),
                 ('solve', rs['qacc_max_abs_err']), ('damped_solve', e_ds)):
      err[k + suffix] = max(err[k + suffix], e)
    say(f'[compare] {label}: mass chain max abs err {e_mc:.3e}, worst '
        f'relative {rel_mc:.2e} (tol {parity.K1_TOL}); chol_solve max abs '
        f'err {e_cs:.3e}, damped_solve {e_ds:.3e} (both layouts; atol '
        f'{parity.SOLVE_ATOL} + rtol {parity.SOLVE_RTOL} of world scale); '
        f'solve qacc max abs '
        f'err {rs["qacc_max_abs_err"]:.3e}, efc_force '
        f'{rs["force_max_abs_err"]:.3e} (atol {parity.QACC_ATOL} + rtol '
        f'{parity.QACC_RTOL} of world scale'
        + (f'; + each row\'s D |J dqacc|: past the bar without it by '
           f'{rs["force_past_bar"]:.3e}'
           if state in parity.FORCE_THROUGH_QACC else '')
        + f'); niter equal in '
        f'{rs["niter_share"]:.4f} of worlds (bar '
        f'{parity.NITER_SHARE[state]}), max diff '
        f'{rs["niter_max_diff"]} (bar {parity.NITER_MAX_DIFF}); niter mean '
        f'{rs["niter_mean"]:.3f}; active rows '
        f'{int(d.efc_active.sum())} of {model.nefc * d.qpos.shape[0]}')
    return args, rs['niter_mean']

  qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                      parity.general_state(mc, NCMP, 7)]
  d0 = io.make_data(mc, NCMP).replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl,
      qacc_warmstart=0.1 * torch.as_tensor(
          np.random.default_rng(8).standard_normal((NCMP, nv)),
          dtype=torch.float32, device=dev))
  general_compare(f'constraints W={NCMP}', d0)

  # ---- 3c. the large-tree kernels against their plain versions
  say(f'[phase 3c] at {time.perf_counter() - T0:.1f} s')
  nvl, nbl = mcl.nv, mcl.nbody

  def clutter_compare(label, d, mcl=mcl, sfx=''):
    """The big-tree mass chain, chol_batched (on qM and on the Newton H),
    chol_solve and damped_solve at n 75 against their plain versions on
    world-major clutter state d (qpos, qvel, ctrl, qacc_warmstart; with
    sleep on, also its sleep state) of ``mcl``; each kernel gets the plain
    version's upstream outputs; the errors go to err[kernel + sfx].
    Returns each kernel's arguments."""
    d = forward.pre(mcl, d)
    am = (mcl, lanes(d.cinert, 36 * nbl), lanes(d.cdof, 6 * nvl),
          lanes(d.qvel))
    got, want = kmass.mass_chain_lanes(*am), kmass.mass_chain_plain(*am)
    try:
      if got[1] is not None or want[1] is not None:
        fail(f'{label}: the large-tree mass chain computed a factor')
      keep = (0, 2, 3, 4)
      e_mc, rel_mc = parity.check_rel([got[i] for i in keep],
                                      [want[i] for i in keep],
                                      ('qM', 'cvel', 'cdof_dot', 'bias'))
      # the large tree's qM is world-major
      qM_w, _, cvel, cdd, bias = want
      acb = (mcl, qM_w, kmass.BIG_JITTER)
      L = klinalg.chol_batched_plain(qM_w, kmass.BIG_JITTER)
      e_cb = parity.check_world_scale(
          lanes(klinalg.chol_batched(*acb), nvl * nvl), lanes(L, nvl * nvl),
          'qLD', *SB)
      d = forward.mid(mcl, d.replace(
          qM=qM_w, qLD=L, cvel=world(cvel, nbl, 6),
          cdof_dot=world(cdd, nvl, 6), qfrc_bias=bias.T))
      # the main path's layouts: L world-major from chol_batched
      acs = (mcl, L, d.qfrc_smooth)
      x = klinalg.chol_solve_plain(lanes(L, nvl * nvl), lanes(d.qfrc_smooth))
      e_cs = check_layouts(klinalg.chol_solve_batched, *acs, x,
                           'qacc_smooth')
      # the Newton's first H, at the warmstart
      J = d.efc_J
      jaref = torch.matmul(J, d.qacc_warmstart[..., None])[..., 0] - \
          d.efc_aref
      Dq = d.efc_D * (jaref < 0).float()  # masked rows: D = 0
      H = (qM_w + torch.matmul(J.transpose(1, 2) * Dq[:, None, :], J)
           ).contiguous()
      e_h = parity.check_world_scale(
          lanes(klinalg.chol_batched(mcl, H, 1e-15), nvl * nvl),
          lanes(klinalg.chol_batched_plain(H, 1e-15), nvl * nvl),
          'Newton H factor', *SB)
      d = osolver.solve(mcl, d.replace(qacc_smooth=x.T))
      # the main path's layouts: qM world-major as the mass chain writes
      # it, qacc world-major
      ads = (mcl, qM_w, d.qacc)
      dmp = klinalg.world_damping(mcl).to(dev)
      e_ds = check_layouts(
          klinalg.damped_solve_batched, *ads,
          klinalg.damped_solve_plain(lanes(qM_w, nvl * nvl), lanes(d.qacc),
                                     dmp), 'qacc (damped)')
    except AssertionError as e:
      fail(f'{label}: {e}')
    for k, e in (('mass_chain_big', e_mc), ('chol_batched', max(e_cb, e_h)),
                 ('chol_solve_n75', e_cs), ('damped_solve_n75', e_ds)):
      err[k + sfx] = max(err[k + sfx], e)
    live = int((d.contact.dist < d.contact.includemargin).sum())
    say(f'[compare] {label}: large-tree mass chain max abs err {e_mc:.3e}, '
        f'worst relative {rel_mc:.2e} (tol {parity.K1_TOL}); chol_batched '
        f'qLD {e_cb:.3e}, Newton H {e_h:.3e}; chol_solve {e_cs:.3e}, '
        f'damped_solve {e_ds:.3e} (both layouts; atol {parity.SOLVE_ATOL} '
        f'+ rtol {parity.SOLVE_RTOL} of world scale); live contacts {live} in '
        f'{d.qpos.shape[0]} worlds, Newton niter mean '
        f'{float(d.solver_niter.float().mean()):.3f}')
    return {'mass_chain_big': am, 'chol_batched': acb, 'chol_solve_n75': acs,
            'damped_solve_n75': ads}

  qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                      parity.clutter_state(mcl, NCMP, 7)]
  clutter_compare(f'clutter W={NCMP}', io.make_data(mcl, NCMP).replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl))

  # ---- 3d. the solve kernel on contact rows, pyramidal and elliptic
  say(f'[phase 3d] at {time.perf_counter() - T0:.1f} s')
  def spheres_compare(label, model, key, d, every_zone=False):
    """The solve kernel against its plain version on world-major state d
    of a spheres scene, fed the plain upstream outputs; prints the zone
    counts of the elliptic contacts at the plain solution (with
    ``every_zone``, each must be non-zero).  Returns the solve's
    arguments, the world-major Data and the plain mean Newton count."""
    args, dw = parity.solve_args(model, d)
    got, want = ksolver.solve_tiles(*args), solver_ref.solve_tiles(*args)
    zones = {} if args[8] is None else solver_ref.ell_zone_counts(
        *args[:4], want[0], args[8])
    try:
      rs = parity.check_solve(got, want, 'elliptic')
      if zones and every_zone:
        assert min(zones.values()) > 0, f'a zone without contacts: {zones}'
    except AssertionError as e:
      fail(f'{label}: {e}')
    err[key] = max(err[key], rs['qacc_max_abs_err'])
    live = int((dw.contact.dist < dw.contact.includemargin).sum())
    say(f'[compare] {label}: solve qacc max abs err '
        f'{rs["qacc_max_abs_err"]:.3e}, efc_force '
        f'{rs["force_max_abs_err"]:.3e} (in the {rs["force_worlds"]} worlds '
        f'whose Newton counts agree; atol {parity.QACC_ATOL} + rtol '
        f'{parity.QACC_RTOL} of world scale); niter equal in '
        f'{rs["niter_share"]:.4f} of worlds (bar '
        f'{parity.NITER_SHARE["elliptic"]}), max diff {rs["niter_max_diff"]} '
        f'(bar {parity.NITER_MAX_DIFF}); niter mean {rs["niter_mean"]:.3f}; '
        f'live contacts {live} in {d.qpos.shape[0]} worlds'
        + (f'; elliptic zones at the solution {zones}' if zones else ''))
    return args, dw, rs['niter_mean']

  for key, model in (('solve_spheres', msp), ('solve_elliptic', mse)):
    qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                        parity.spheres_state(model, NCMP, 7)]
    spheres_compare(f'{key} W={NCMP}', model, key, io.make_data(
        model, NCMP).replace(
            qpos=qpos, qvel=qvel, ctrl=ctrl,
            qacc_warmstart=0.1 * torch.as_tensor(
                np.random.default_rng(8).standard_normal((NCMP, model.nv)),
                dtype=torch.float32, device=dev)), every_zone=True)

  # ---- 4. the fused main path
  say(f'[phase 4] at {time.perf_counter() - T0:.1f} s')
  def main_path(model, nstep, expect, nworld, general=False,
                init_state=None, warmup=WARMUP):
    """benchmarks.run from zeroed counters (``general``: the general step
    for a model inside the fused gate; ``init_state``: the worlds start
    there), ``warmup`` steps before the timed ``nstep``;
    ``expect(steps, trips)`` gives each kernel's launch count that must be
    seen (0 when absent)."""
    zero_counters()
    res = benchmarks.run(model, nworld=nworld, nstep=nstep,
                         warmup_steps=warmup, general=general,
                         init_state=init_state)
    launches = counters()
    steps = nstep + warmup
    want = {k: 0 for k in launches}
    want.update(expect(steps, osolver.trips))
    if launches != want:
      fail(f'launch counts {launches} != {want}')
    if res['overflow_worlds'] != 0:
      fail(f"overflow in {res['overflow_worlds']} worlds")
    if res['converged_worlds'] != nworld:
      fail(f"{res['converged_worlds']} of {nworld} worlds finite")
    st = res.pop('state')
    res.pop('model'), res.pop('world_ids')
    say(f"[main path] {nworld} worlds x {nstep} steps (+{warmup} warmup): "
        f"{res['steps_per_sec']:.1f} steps/s, first step "
        f"{res['jit_duration']:.3f} s, solver_niter_mean "
        f"{res['solver_niter_mean']:.4f}, solver_cap_worlds "
        f"{res['solver_cap_worlds']}, overflow_worlds 0, "
        f"{res['converged_worlds']}/{nworld} finite, launches {launches}, "
        f"Newton trips {osolver.trips}")
    say('[main path] metrics ' + json.dumps(res))
    return res, st, launches

  res, st, launches = main_path(m, NSTEP,
                                lambda n, _: {'k1': n, 'k4': n}, w_h)
  k1_out, a4, niter4 = compare(f'rollout W={w_h}', st.qpos, st.qvel,
                               st.ctrl, st.warmstart, 'contact', False)
  _, _, bias, _, dist, cpos, cframe, stcom = k1_out
  glue_ms = time_ms(lambda: (glue.compact(m, dist, cpos, cframe, stcom),
                             glue.middle(m, bias, st.qpos, st.qvel, st.ctrl)),
                    20)
  calls = {'k1': lambda: kk1.k1(m, st.qpos, st.qvel, need_qLD=False),
           'k4': lambda: kk4.k4(*a4)}
  ms, ms_src = {}, {}

  def time_kernel(key, fn, kern):
    """Fills ms[key] and ms_src[key] = (source, launches seen)."""
    ms[key], source, seen = kernel_ms(fn, kern)
    ms_src[key] = (source, seen)

  def general_timing(args, niter, suffix=''):
    """Times the four general kernels on ``general_compare``'s ``args``
    (their own device time, the wrapper call, the plain version and the
    one PyTorch call where there is one) and computes their bounds, under
    the keys kernel + suffix; ``niter`` is the solve's mean Newton
    count."""
    am, acs, asv, ads = (args['mass_chain'], args['chol_solve'],
                         args['solve'], args['damped_solve'])
    model = am[0]
    nv, nb, nefc, W = model.nv, model.nbody, model.nefc, am[3].shape[-1]
    dmp = klinalg.world_damping(model).to(dev)
    ys = yardsticks(acs, ads, dmp)
    live_rows = float((asv[2] > 0).sum()) / W
    for k, fn, plain, plain_reps, lib, bnd in (
        ('mass_chain', lambda: kmass.mass_chain_lanes(*am),
         lambda: kmass.mass_chain_plain(*am), 3, None, bound(
             W * F32 * (36 * nb + 7 * nv + 2 * nv * nv + 6 * nb + 7 * nv),
             W * mass_chain_flops(model, True))),
        ('chol_solve', lambda: klinalg.chol_solve_batched(*acs),
         ys['chol_solve_plain'], 3, ys['chol_solve_library'],
         bound(chol_solve_bytes(nv, W), W * 2 * nv * nv)),
        # no one PyTorch call computes a Newton solve; its work is that of
        # this state's live rows
        ('solve', lambda: ksolver.solve_tiles(*asv),
         lambda: solver_ref.solve_tiles(*asv), 1, None, bound(
             W * F32 * (nefc * nv + 3 * nefc + nv * nv + 2 * nv + 2 * nv +
                        nefc + 1), W * newton_flops(live_rows, nv, niter))),
        ('damped_solve', lambda: klinalg.damped_solve_batched(*ads),
         ys['damped_solve_plain'], 3, ys['damped_solve_library'],
         bound(W * F32 * (nv * nv + 2 * nv) + F32 * nv,
               W * (chol_flops(nv) + 4 * nv * nv + nv)))):
      key = k + suffix
      time_kernel(key, fn, f'{k}_kernel')
      call_ms[key] = time_ms(fn, 20)
      plain_ms[key] = time_ms(plain, plain_reps)
      # one PyTorch call of the same function, timed here only
      library_ms[key] = None if lib is None else time_ms(lib, 20)
      bounds[key] = bnd
      say(f"[timing] {key} W={W} per launch: cuda {ms[key]:.4f} ms (call "
          f"{call_ms[key]:.4f}), plain {plain_ms[key]:.3f} ms, library "
          f"{'none' if lib is None else f'{library_ms[key]:.4f} ms'}, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}"
          + (f'; {live_rows:.2f} live rows per world' if k == 'solve'
             else '') + ')')

  for k, fn in calls.items():
    time_kernel(k, fn, f'{k}_kernel')
  # K4's profiled ms at a 1 s pad and at kerneltime.PAD_S, in turns
  say(f'[timing] k4 profiled ms at a 1 s pad and at PAD_S '
      f'{kerneltime.PAD_S} s, [pad, ms]: '
      + json.dumps(kerneltime.pad_check(torch, calls['k4'], NTIME,
                                        'k4_kernel')))
  call_ms = {k: time_ms(fn, 20) for k, fn in calls.items()}
  plain_ms = {
      'k1': time_ms(lambda: k1_ref.k1(m, st.qpos, st.qvel, need_qLD=False),
                    3),
      'k4': time_ms(lambda: k4_ref.k4(*a4), 3),
  }
  library_ms = {'k1': None, 'k4': None}
  ncon_rows = kk4.con_rows(m) + len(k4_ref.eq_joint_tables(m))
  nrow4 = ncon_rows + len(k4_ref.limit_tables(m))
  W = w_h
  bounds = {
      'k1': bound(W * F32 * (m.nq + m.nv + m.nv * m.nv + m.nv + 6 * m.nv +
                             13 * m.ncand + 3 * m.nbody),
                  W * (mass_chain_flops(m, False) + 400 * m.nbody +
                       100 * m.ncand)),
      'k4': bound(W * F32 * (m.nv * m.nv + 3 * m.nv + m.nq + 6 * m.nv +
                             m.ncon * (33 + 2 * m.nv) + m.nq + 3 * m.nv + 1),
                  W * (40 * m.ncon * m.nv +
                       newton_flops(nrow4, m.nv, niter4))),
  }
  kernel_launches = {'k1': launches['k1'], 'k4': launches['k4']}
  say(f"[timing] W={w_h} per launch: K1 cuda {ms['k1']:.3f} ms (call "
      f"{call_ms['k1']:.3f}), plain {plain_ms['k1']:.3f} ms, bound "
      f"{bounds['k1'][0]:.4f} ms ({bounds['k1'][1]}); K4 cuda "
      f"{ms['k4']:.3f} ms (call {call_ms['k4']:.3f}), plain "
      f"{plain_ms['k4']:.3f} ms, bound {bounds['k4'][0]:.4f} ms "
      f"({bounds['k4'][1]}); glue (compaction + smooth forces) "
      f"{glue_ms:.3f} ms; step {1e3 * w_h / res['steps_per_sec']:.3f} ms")

  # ---- 5. the general main path
  say(f'[phase 5] at {time.perf_counter() - T0:.1f} s')
  res, st, launches = main_path(
      mc, GEN_NSTEP, lambda n, _: {k: n for k in (
          'mass_chain', 'solve', 'chol_solve', 'damped_solve')}, w_c)
  for k in ('mass_chain', 'solve', 'chol_solve', 'damped_solve'):
    kernel_launches[k] = launches[k]
  d = types.Data(qpos=st.qpos, qvel=st.qvel, ctrl=st.ctrl,
                 qacc_warmstart=st.qacc_warmstart, eq_active=st.eq_active,
                 qfrc_applied=st.qfrc_applied, xfrc_applied=st.xfrc_applied)
  args, niter3 = general_compare(f'constraints rollout W={w_c}', d)
  general_timing(args, niter3)
  am, asv = args['mass_chain'], args['solve']
  # the wrappers' world-major <-> lanes-last transposes, alone
  dw = forward.mid(mc, kmass.mass_chain(mc, forward.pre(mc, d)))
  out_mc = kmass.mass_chain_lanes(*am)
  transpose_ms = {
      'mass_chain': time_ms(lambda: (
          lanes(dw.cinert, 36 * nb), lanes(dw.cdof, 6 * nv), lanes(dw.qvel),
          world(out_mc[0], nv, nv), world(out_mc[1], nv, nv),
          world(out_mc[2], nb, 6), world(out_mc[3], nv, 6),
          out_mc[4].T.contiguous()), 20),
      # the Cholesky solves read their operands in place
      'chol_solve': 0.0,
      'solve': time_ms(lambda: [lanes(x) for x in (
          dw.efc_J, dw.efc_D, dw.efc_aref, dw.efc_frictionloss, dw.qM,
          dw.qfrc_smooth, dw.qacc_warmstart)] + [
              x.T.contiguous() for x in asv[6:8]], 20),
      'damped_solve': 0.0,
  }
  say('[timing] wrapper transposes per call: ' + ', '.join(
      f'{k} {t:.4f} ms' for k, t in transpose_ms.items()))
  say(f"[timing] general step {1e3 * w_c / res['steps_per_sec']:.3f} ms")

  # ---- 6. the large-tree contact path
  say(f'[phase 6] at {time.perf_counter() - T0:.1f} s')
  res, st, launches = main_path(
      mcl, CL_NSTEP, lambda n, trips: {
          'mass_chain': n, 'damped_solve': n, 'chol_batched': 2 * n + trips,
          'chol_solve': 2 * n + trips}, w_cl)
  ncon = float(st.ncon_active.float().mean())
  if not ncon >= 20.0:
    fail(f'mean live contacts per world {ncon:.2f} < 20 at the end')
  say(f'[main path] clutter: mean live contacts per world {ncon:.2f}, '
      f'Newton trips per step {osolver.trips / (CL_NSTEP + WARMUP):.3f}')
  for k, name in (('mass_chain', 'mass_chain_big'),
                  ('chol_batched', 'chol_batched'),
                  ('chol_solve', 'chol_solve_n75'),
                  ('damped_solve', 'damped_solve_n75')):
    kernel_launches[name] = launches[k]
  d = types.carried(st)

  def clutter_timing(label, d, model, W, sfx=''):
    """``clutter_compare`` on the last state d of ``model``'s rollout at W
    worlds, then its four kernels timed beside their plain versions and
    the one PyTorch call of the same function, with their bounds, under
    the keys kernel + sfx."""
    args = clutter_compare(label, d, model, sfx)
    am, acb, acs, ads = (args['mass_chain_big'], args['chol_batched'],
                         args['chol_solve_n75'], args['damped_solve_n75'])
    dmp = klinalg.world_damping(model).to(dev)
    calls = {
        'mass_chain_big': ('mass_chain_kernel',
                           lambda: kmass.mass_chain_lanes(*am)),
        'chol_batched': ('chol_batched_kernel',
                         lambda: klinalg.chol_batched(*acb)),
        'chol_solve_n75': ('chol_solve_kernel',
                           lambda: klinalg.chol_solve_batched(*acs)),
        'damped_solve_n75': ('damped_solve_kernel',
                             lambda: klinalg.damped_solve_batched(*ads)),
    }
    for k, (kern, fn) in calls.items():
      time_kernel(k + sfx, fn, kern)
      call_ms[k + sfx] = time_ms(fn, 20)
    ys = yardsticks(acs, ads, dmp)
    plain_ms.update({k + sfx: v for k, v in {
        'mass_chain_big': time_ms(lambda: kmass.mass_chain_plain(*am), 3),
        'chol_batched': time_ms(lambda: klinalg.chol_batched_plain(
            acb[1], acb[2]), 3),
        'chol_solve_n75': time_ms(ys['chol_solve_plain'], 3),
        'damped_solve_n75': time_ms(ys['damped_solve_plain'], 3),
    }.items()})
    # one PyTorch call of the same function, timed here only
    eye = torch.eye(nvl, device=dev)
    A_j = (acb[1] + acb[2] * eye).contiguous()
    library_ms.update({k + sfx: v for k, v in {
        'mass_chain_big': None,
        'chol_batched': time_ms(lambda: torch.linalg.cholesky(A_j), 20),
        'chol_solve_n75': time_ms(ys['chol_solve_library'], 20),
        'damped_solve_n75': time_ms(ys['damped_solve_library'], 20),
    }.items()})
    dw = forward.pre(model, d)
    out_mc = kmass.mass_chain_lanes(*am)
    transpose_ms.update({k + sfx: v for k, v in {
        # qM leaves the kernel world-major
        'mass_chain_big': time_ms(lambda: (
            lanes(dw.cinert, 36 * nbl), lanes(dw.cdof, 6 * nvl),
            lanes(dw.qvel), world(out_mc[2], nbl, 6),
            world(out_mc[3], nvl, 6), out_mc[4].T.contiguous()), 20),
        # these kernels read (and chol_batched writes) in place
        'chol_batched': 0.0, 'chol_solve_n75': 0.0, 'damped_solve_n75': 0.0,
    }.items()})
    bounds.update({k + sfx: v for k, v in {
        'mass_chain_big': bound(
            W * F32 * (36 * nbl + 7 * nvl + nvl * nvl + 6 * nbl + 7 * nvl),
            W * mass_chain_flops(model, False)),
        'chol_batched': bound(chol_batched_bytes(nvl, W),
                              W * chol_flops(nvl)),
        'chol_solve_n75': bound(chol_solve_bytes(nvl, W),
                                W * 2 * nvl * nvl),
        'damped_solve_n75': bound(
            W * F32 * (nvl * nvl + 2 * nvl) + F32 * nvl,
            W * (chol_flops(nvl) + 4 * nvl * nvl + nvl)),
    }.items()})
    for k in (k + sfx for k in calls):
      lib = library_ms[k]
      say(f"[timing] {k} W={W} per launch: cuda {ms[k]:.4f} ms (call "
          f"{call_ms[k]:.4f}), plain {plain_ms[k]:.3f} ms, library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
          f"{bounds[k][0]:.4f} ms ({bounds[k][1]}), wrapper transposes "
          f"{transpose_ms[k]:.4f} ms")

  clutter_timing(f'clutter rollout W={w_cl}', d, mcl, w_cl)
  say(f"[timing] clutter step {1e3 * w_cl / res['steps_per_sec']:.3f} "
      'ms')

  # ---- 7-8. contacts through the solve kernel, pyramidal and elliptic
  say(f'[phase 7-8] at {time.perf_counter() - T0:.1f} s')
  def small_tree_kernels(key, model, dw, launches, nworld, sfx=''):
    """chol_solve at n 36 (qacc_smooth, in the main path's layouts) and the
    small-tree mass chain (with its factor) against their plain versions
    on the spheres scene ``model``'s last rollout state dw, and timed,
    under 'chol_solve_n36' + sfx and 'mass_chain_n36' + sfx."""
    k36, nvs = 'chol_solve_n36' + sfx, model.nv
    kernel_launches[k36] = launches['chol_solve']
    acs = (model, dw.qLD, dw.qfrc_smooth)
    ys = yardsticks(acs)
    try:
      err[k36] = check_layouts(klinalg.chol_solve_batched, *acs,
                               ys['chol_solve_plain'](), 'qacc_smooth n 36')
    except AssertionError as e:
      fail(f'{key} rollout W={nworld}: {e}')
    time_kernel(k36, lambda: klinalg.chol_solve_batched(*acs),
                'chol_solve_kernel')
    call_ms[k36] = time_ms(lambda: klinalg.chol_solve_batched(*acs), 20)
    plain_ms[k36] = time_ms(ys['chol_solve_plain'], 3)
    library_ms[k36] = time_ms(ys['chol_solve_library'], 20)
    transpose_ms[k36] = 0.0  # the kernel reads its operands in place
    bounds[k36] = bound(chol_solve_bytes(nvs, nworld),
                        nworld * 2 * nvs * nvs)
    say(f"[timing] {k36} W={nworld} per launch: cuda {ms[k36]:.4f} ms "
        f"(call {call_ms[k36]:.4f}), plain {plain_ms[k36]:.3f} ms, library "
        f"{library_ms[k36]:.4f} ms, bound {bounds[k36][0]:.4f} ms "
        f"({bounds[k36][1]}), max abs err {err[k36]:.3e} (both layouts), "
        f"wrapper transposes 0.0000 ms")
    # the small-tree mass chain at nv 36 (with its factor) on the same
    # last state
    k36, nbs = 'mass_chain_n36' + sfx, model.nbody
    kernel_launches[k36] = launches['mass_chain']
    am = (model, lanes(dw.cinert, 36 * nbs), lanes(dw.cdof, 6 * nvs),
          lanes(dw.qvel))
    try:
      err[k36], rel = parity.check_rel(kmass.mass_chain_lanes(*am),
                                       kmass.mass_chain_plain(*am),
                                       parity.MASS_NAMES)
    except AssertionError as e:
      fail(f'{key} rollout W={nworld} mass chain: {e}')
    time_kernel(k36, lambda: kmass.mass_chain_lanes(*am), 'mass_chain_kernel')
    call_ms[k36] = time_ms(lambda: kmass.mass_chain_lanes(*am), 20)
    plain_ms[k36] = time_ms(lambda: kmass.mass_chain_plain(*am), 3)
    library_ms[k36] = None  # no one PyTorch call computes the chain
    bounds[k36] = bound(
        nworld * F32 * (36 * nbs + 7 * nvs + 2 * nvs * nvs + 6 * nbs +
                        7 * nvs), nworld * mass_chain_flops(model, True))
    say(f"[timing] {k36} W={nworld} per launch: cuda {ms[k36]:.4f} ms "
        f"(call {call_ms[k36]:.4f}), plain {plain_ms[k36]:.3f} ms, library "
        f"none, bound {bounds[k36][0]:.4f} ms ({bounds[k36][1]}), max abs "
        f"err {err[k36]:.3e}, worst relative {rel:.2e} (tol "
        f"{parity.K1_TOL})")

  for key, model, nworld, kern in (
      ('solve_spheres', msp, w_sp, 'solve_kernel'),
      ('solve_elliptic', mse, w_se, 'solve_ell_kernel')):
    res, st, launches = main_path(
        model, SP_NSTEP, lambda n, _: {'mass_chain': n, 'chol_solve': n,
                                       'solve': n}, nworld=nworld)
    if osolver.trips:
      fail(f'{key}: {osolver.trips} trips of the torch Newton')
    ncon = float(st.ncon_active.float().mean())
    if not ncon >= SPHERES_MIN_CONTACTS:
      fail(f'{key}: mean live contacts per world {ncon:.2f} < '
           f'{SPHERES_MIN_CONTACTS} at the end')
    say(f'[main path] {key}: mean live contacts per world {ncon:.2f}')
    kernel_launches[key] = launches['solve']
    d = types.carried(st)
    asv, dw, niter = spheres_compare(f'{key} rollout W={nworld}', model, key,
                                     d)
    time_kernel(key, lambda: ksolver.solve_tiles(*asv), kern)
    call_ms[key] = time_ms(lambda: ksolver.solve_tiles(*asv), 20)
    plain_ms[key] = time_ms(lambda: solver_ref.solve_tiles(*asv), 1)
    library_ms[key] = None  # no one PyTorch call computes a Newton solve
    out = ksolver.solve_tiles(*asv)
    transpose_ms[key] = time_ms(lambda: [lanes(x) for x in (
        dw.efc_J, dw.efc_D, dw.efc_aref, dw.efc_frictionloss, dw.qM,
        dw.qfrc_smooth, dw.qacc_warmstart)] + (
            [solver_ref.ell_scales(model, dw.contact.friction)]
            if asv[8] is not None else []) + [
                x.T.contiguous() for x in out[:3]], 20)
    nefc, nvs = model.nefc, model.nv
    live_rows = float((asv[2] > 0).sum()) / nworld
    flops = newton_ell_flops if asv[8] is not None else newton_flops
    bounds[key] = bound(
        nworld * F32 * (nefc * nvs + 3 * nefc + nvs * nvs + 2 * nvs +
                        (nefc if asv[8] is not None else 0) + 2 * nvs +
                        nefc + 1),
        nworld * flops(live_rows, nvs, niter))
    say(f"[timing] {key} W={nworld} per launch: cuda {ms[key]:.4f} ms "
        f"(call {call_ms[key]:.4f}), plain {plain_ms[key]:.3f} ms, library "
        f"none, bound {bounds[key][0]:.4f} ms ({bounds[key][1]}; "
        f"{live_rows:.2f} live rows per world, niter mean {niter:.3f}), "
        f"wrapper transposes {transpose_ms[key]:.4f} ms; step "
        f"{1e3 * nworld / res['steps_per_sec']:.3f} ms")
    if key == 'solve_spheres':
      small_tree_kernels(key, model, dw, launches, nworld)

  # ---- 9. dm_control on the fused step
  say(f'[phase 9] at {time.perf_counter() - T0:.1f} s')
  # ---- 9. dm_control on the fused step
  say(f'[phase 9] at {time.perf_counter() - T0:.1f} s')
  dmc = {name: io.load_model_npz(benchmarks.SCENES[name][0])
         for name in io.DMC_NCONMAX}
  suffix = {'walker': '_walker', 'cheetah': '_cheetah', 'hopper': '_hopper',
            'humanoid_dmc': '_dmc'}

  def fused_timing(sfx, model, a1, need, a4, niter):
    """Times K1 (on a1 = model, qpos, qvel) and K4 (on a4) per launch
    beside their plain versions and computes their bounds, under the keys
    'k1' + sfx and 'k4' + sfx; ``niter`` is the plain K4's mean Newton
    count."""
    k1k, k4k = 'k1' + sfx, 'k4' + sfx
    W = a1[1].shape[-1]
    shapes[k1k], shapes[k4k] = kk1.kernel_info(model), kk4.kernel_info(model)
    time_kernel(k1k, lambda: kk1.k1(*a1, need_qLD=need), 'k1_kernel')
    time_kernel(k4k, lambda: kk4.k4(*a4), 'k4_kernel')
    plain_ms[k1k] = time_ms(lambda: k1_ref.k1(*a1, need_qLD=need), 3)
    plain_ms[k4k] = time_ms(lambda: k4_ref.k4(*a4), 3)
    library_ms[k1k] = library_ms[k4k] = None
    nv_, nq_, nb_, nc_ = model.nv, model.nq, model.nbody, model.ncand
    nrow_ = kk4.con_rows(model) + len(k4_ref.eq_joint_tables(model)) + \
        len(k4_ref.limit_tables(model))
    bounds[k1k] = bound(
        W * F32 * (nq_ + nv_ + nv_ * nv_ + nv_ + 6 * nv_ + 13 * nc_ +
                   3 * nb_),
        W * (mass_chain_flops(model, need) + 400 * nb_ + 100 * nc_))
    bounds[k4k] = bound(
        W * F32 * (nv_ * nv_ + 3 * nv_ + nq_ + 6 * nv_ +
                   model.ncon * (33 + 2 * nv_) + nq_ + 3 * nv_ + 1),
        W * (40 * model.ncon * nv_ + newton_flops(nrow_, nv_, niter)))
    for k in (k1k, k4k):
      say(f"[timing] {k} W={W} per launch: cuda {ms[k]:.4f} ms, plain "
          f"{plain_ms[k]:.3f} ms, bound {bounds[k][0]:.4f} ms "
          f"({bounds[k][1]}); " + json.dumps(shapes[k]))

  for name, model in dmc.items():
    res, st, launches = main_path(
        model, DMC_NSTEP, lambda n, _: {'k1': n, 'k4': n}, w_h)
    say(f'[main path] {name} (fused; nv {model.nv}, ncand {model.ncand}, '
        f'{model.ncon} slots, nrow {kk4.nrow(model)}): step '
        f"{1e3 * w_h / res['steps_per_sec']:.3f} ms")
    sfx = suffix[name]
    kernel_launches['k1' + sfx] = launches['k1']
    kernel_launches['k4' + sfx] = launches['k4']
    # K1 and K4 on the rollout's last state, at the main path's width
    need = not k4_ref.has_rows(model)
    _, a4, niter = compare(f'{name} rollout W={w_h}', st.qpos, st.qvel,
                           st.ctrl, st.warmstart, 'contact', need, model,
                           sfx)
    if name in ('walker', 'cheetah'):
      fused_timing(sfx, model, (model, st.qpos, st.qvel), need, a4, niter)

  # hopper (the smallest tree) and humanoid_dmc (48 slots) also at the
  # seeded contact state, each timed there
  for name in ('hopper', 'humanoid_dmc'):
    model, qpos, qvel, ctrl, ws = parity.k1_case(name, 'contact', NCMP, 7,
                                                 dev)
    need = not k4_ref.has_rows(model)
    _, a4, niter = compare(f'{name} contact W={NCMP}', qpos, qvel, ctrl, ws,
                           'contact', need, model, suffix[name])
    fused_timing(suffix[name], model, (model, qpos, qvel), need, a4, niter)

  # ---- 10. sensors on the general step
  say(f'[phase 10] at {time.perf_counter() - T0:.1f} s')
  general4 = ('mass_chain', 'chol_solve', 'solve', 'damped_solve')
  for name, nstep in (('humanoid_dmc', DMC_GEN_NSTEP),
                      ('hopper', HOP_GEN_NSTEP)):
    # the general step on a dm_control scene: exact counts, sensordata
    # finite; prints the live contacts and each sensor type's mean
    model, sfx = dmc[name], suffix[name]
    res, st, launches = main_path(
        model, nstep, lambda n, _: {k: n for k in general4}, w_h,
        general=True)
    if osolver.trips:
      fail(f'{name}: {osolver.trips} trips of the torch Newton')
    sd = st.sensordata
    if sd is None or tuple(sd.shape) != (w_h, model.nsensordata) or \
        not bool(torch.isfinite(sd).all()):
      fail(f'{name}: sensordata missing, misshapen or not finite')
    means = {t: round(float(sd[:, torch.as_tensor(c, device=dev)].mean()),
                      6)
             for cols in parity.sensor_stages(model).values()
             for t, c in cols.items()}
    say(f'[main path] {name} (general): mean live contacts per world '
        f'{float(st.ncon_active.float().mean()):.3f}; sensordata '
        f'{model.nsensordata} floats finite in {w_h} worlds; mean by type '
        + json.dumps(means) + f"; step {1e3 * w_h / res['steps_per_sec']:.3f}"
        ' ms')
    # the four kernels on the last state, at the main path's width
    d = types.carried(st)
    args, niter = general_compare(f'{name} rollout W={w_h}', d, model, sfx,
                                  'dmc')
    for k in general4:
      kernel_launches[k + sfx] = launches[k]
    general_timing(args, niter, sfx)
    shapes['mass_chain' + sfx] = kmass.kernel_info(model)
    shapes['solve' + sfx] = ksolver.kernel_info(model)
    # one step of the last state on the card and on the CPU (plain
    # versions)
    mcpu = io.load_model_npz(benchmarks.SCENES[name][0], device='cpu')
    sub = {k: getattr(st, k)[:NSENSOR_CMP] for k in types.CARRY}
    on_card = forward.step(model, types.Data(**sub))
    on_cpu = forward.step(mcpu, types.Data(**{k: v.cpu() for k, v in
                                              sub.items()}))
    try:
      rsen = parity.check_sensors(mcpu, on_card.sensordata.cpu(),
                                  on_cpu.sensordata,
                                  on_card.solver_niter.cpu(),
                                  on_cpu.solver_niter)
    except AssertionError as e:
      fail(f'{name} sensordata, card against CPU: {e}')
    say(f'[compare] {name} one step W={NSENSOR_CMP}, card against the '
        f'CPU\'s plain versions: sensordata max abs err by stage '
        + json.dumps(rsen['max_abs_err']) + f' (pos and vel within atol '
        f'{parity.SENSOR_ATOL} + rtol {parity.SENSOR_RTOL}; acc within atol '
        f'{parity.QACC_ATOL} + rtol {parity.QACC_RTOL} of world scale where '
        f'Newton counts agree); niter equal in {rsen["niter_share"]:.4f}')

  # ---- 11. sleep and islands, the skip step, CG, implicitfast
  say(f'[phase 11] at {time.perf_counter() - T0:.1f} s')
  t11 = time.perf_counter()
  # (a) clutter_arm with sleep, from its settled state: the torch Newton
  # over rows masked where trees sleep
  mca, w_ca = benchmarks.load_scene('clutter_arm')
  init = benchmarks.start_state('clutter_arm')
  res, st, launches = main_path(
      mca, CA_NSTEP, lambda n, trips: {
          'mass_chain': n, 'damped_solve': n, 'chol_batched': 2 * n + trips,
          'chol_solve': 2 * n + trips}, w_ca, init_state=init)
  steps = CA_NSTEP + WARMUP
  reads = {k: round(v / steps, 3) for k, v in outil.host_reads.items()}
  may = torch.as_tensor(np.asarray(mca.tree_sleep_policy) != 1, device=dev)
  say(f"[main path] clutter_arm (sleep): trees asleep "
      f"{float((init['tree_asleep'] >= 0).mean()):.4f} at the start (of "
      f"those that may sleep {float((init['tree_asleep'][:, 1:] >= 0).mean()):.4f}), "
      f"{float((st.tree_asleep >= 0).float().mean()):.4f} at the end (of "
      f"those that may {float((st.tree_asleep[:, may] >= 0).float().mean()):.4f}); "
      f"mean nisland {float(st.nisland.float().mean()):.3f}; the island "
      f"labeler ran on {forward.island_runs} of {steps} steps; packed steps "
      f"{forward.packed_steps}; host reads per step {json.dumps(reads)}; "
      f"Newton trips per step {osolver.trips / steps:.3f}; mean live "
      f"contacts per world {float(st.ncon_active.float().mean()):.2f}; step "
      f"{1e3 * w_ca / res['steps_per_sec']:.3f} ms")
  for k, name in (('mass_chain', 'mass_chain_big'),
                  ('chol_batched', 'chol_batched'),
                  ('chol_solve', 'chol_solve_n75'),
                  ('damped_solve', 'damped_solve_n75')):
    kernel_launches[name + '_ca'] = launches[k]
  d = types.carried(st)
  clutter_timing(f'clutter_arm rollout W={w_ca}', d, mca, w_ca, '_ca')
  for k in ('mass_chain_big', 'chol_batched'):
    shapes[k + '_ca'] = shapes[k]

  # (a') clutter_arm at its width from a woken start: the settled start
  # above runs only the wake checks and rows masked where trees sleep;
  # here trees near ready fall asleep and the island labeler runs
  def tile(st, W):
    return {k: np.concatenate([v] * -(-W // len(v)))[:W]
            for k, v in st.items()}

  woke = parity.woken_state(mca, tile(init, w_ca), np.random.default_rng(4))
  res, st, launches = main_path(
      mca, CA_WOKEN_NSTEP, lambda n, trips: {
          'mass_chain': n, 'damped_solve': n, 'chol_batched': 2 * n + trips,
          'chol_solve': 2 * n + trips}, w_ca, init_state=woke)
  steps = CA_WOKEN_NSTEP + WARMUP
  a0, a1 = woke['tree_asleep'], st.tree_asleep.cpu().numpy()
  fell = int(((a0 < 0) & (a1 >= 0)).sum())
  if forward.island_runs == 0 or fell == 0:
    fail(f'clutter_arm from the woken start: the island labeler ran on '
         f'{forward.island_runs} steps, {fell} trees fell asleep')
  reads = {k: round(v / steps, 3) for k, v in outil.host_reads.items()}
  say(f"[main path] clutter_arm (sleep) from a woken start: "
      f"{int((a0 < 0).sum())} trees awake at the start of {a0.size}, "
      f"{int((a1 < 0).sum())} at the end; {fell} trees fell asleep; mean "
      f"nisland {float(st.nisland.float().mean()):.3f}; the island labeler "
      f"ran on {forward.island_runs} of {steps} steps; packed steps "
      f"{forward.packed_steps}; host reads per step {json.dumps(reads)}; "
      f"Newton trips per step {osolver.trips / steps:.3f}; step "
      f"{1e3 * w_ca / res['steps_per_sec']:.3f} ms")

  # (b) the step that packs the awake worlds: the settled clutter.xml
  # state, some worlds pushed awake; against the full step, each path
  # warmed up by one step, then timed in the order pack, full, full, pack
  def skip_against_full(W, nwake, nstep):
    """nstep steps of the skip step and of the full step from
    parity.pushed_clutter(W, nwake), held against each other and timed;
    returns (model, start state)."""
    mcs, d0 = parity.pushed_clutter(W, nwake)
    forward.step(mcs, d0), forward._step_batched(mcs, d0)

    def run(fn):
      d = d0
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for _ in range(nstep):
        d = fn(mcs, d)
      torch.cuda.synchronize()
      return d, 1e3 * (time.perf_counter() - t0) / nstep

    n0 = forward.packed_steps
    da, ta1 = run(forward.step)
    packed = forward.packed_steps - n0
    db, tb1 = run(forward._step_batched)
    _, tb2 = run(forward._step_batched)
    _, ta2 = run(forward.step)
    if packed != nstep:
      fail(f'the skip step at {W} worlds packed {packed} of {nstep} steps')
    dq = float((da.qpos - db.qpos).abs().max())
    dt_ = float((da.time - db.time).abs().max())
    if not torch.equal(da.tree_asleep, db.tree_asleep) or dq >= 1e-6 or \
        dt_ >= 1e-5:
      fail(f'skip step at {W} worlds against the full step: tree_asleep '
           f'equal {torch.equal(da.tree_asleep, db.tree_asleep)}, qpos {dq}, '
           f'time {dt_}')
    say(f'[main path] skip step: {W} worlds of the settled clutter state, '
        f'{nwake} pushed awake: packed {packed} of {nstep} steps into '
        f'{W // 4} slots, {int(torch.any(da.tree_asleep < 0, dim=1).sum())} '
        f'worlds awake at the end; against the full step tree_asleep equal, '
        f'qpos max abs err {dq:.3e} (bar 1e-6), time {dt_:.3e} (bar 1e-5); '
        f'ms per step after a warm-up step, run in the order pack, full, '
        f'full, pack: packed {ta1:.3f} / {ta2:.3f}, full {tb1:.3f} / '
        f'{tb2:.3f}')
    return mcs, d0

  mcs, d0 = skip_against_full(SKIP_NWORLD, SKIP_NWAKE, SKIP_NSTEP)
  skip_against_full(*SKIP_WIDE)
  # one card step against the CPU's plain step, from the woken state
  mch = io.load_model_npz(io.CLUTTER_SLEEP_SNAPSHOT, device='cpu')
  on_card = forward.step(mcs, d0)
  on_cpu = forward.step(mch, types.map_worlds(d0, lambda x: x.cpu(),
                                              SKIP_NWORLD))
  off = (on_card.tree_asleep.cpu() != on_cpu.tree_asleep)
  e_q = float((on_card.qpos.cpu() - on_cpu.qpos).abs().max())
  try:
    if bool(off.any()):
      raise AssertionError(f'tree_asleep differs in {int(off.sum())} trees')
    parity.check_world_scale(on_card.qpos.cpu().T, on_cpu.qpos.T, 'qpos',
                             parity.QPOS_ATOL, parity.QPOS_RTOL)
  except AssertionError as e:
    fail(f'skip step, card against the CPU: {e}')
  say(f'[compare] skip step at {SKIP_NWORLD} worlds, one card step against '
      f'the CPU plain step: tree_asleep equal, qpos max abs err {e_q:.3e} '
      f'(atol {parity.QPOS_ATOL} + rtol {parity.QPOS_RTOL} of world scale)')

  # (c) spheres_cg: the CG solver
  mcg, w_cg = benchmarks.load_scene('spheres_cg')
  ncg = CG_NSTEP
  res, st, launches = main_path(
      mcg, ncg, lambda n, trips: {'mass_chain': n,
                                  'chol_solve': 2 * n + trips}, w_cg,
      warmup=SLOW_WARMUP)
  steps = ncg + SLOW_WARMUP
  reads = {k: round(v / steps, 3) for k, v in outil.host_reads.items()}
  say(f"[main path] spheres_cg: {ncg} steps (+{SLOW_WARMUP} warmup) in "
      f"{res['run_time']:.1f} s; CG trips per world-step "
      f"{res['solver_niter_mean']:.3f} (last step), worlds at the cap "
      f"{res['solver_cap_worlds']}, trips per step "
      f"{osolver.trips / steps:.3f}; host reads per step {json.dumps(reads)}"
      f"; mean live contacts per world "
      f"{float(st.ncon_active.float().mean()):.2f}; step "
      f"{1e3 * w_cg / res['steps_per_sec']:.3f} ms")
  d = types.carried(st)
  dw = forward.mid(mcg, kmass.mass_chain(mcg, forward.pre(mcg, d)))
  small_tree_kernels('spheres_cg', mcg, dw, launches, w_cg, '_cg')
  shapes['mass_chain_n36_cg'] = shapes['mass_chain_n36']

  # (d) humanoid_implicitfast, fused: K4's implicitfast form at 8192
  mif, w_if = benchmarks.load_scene('humanoid_implicitfast')
  res, st, launches = main_path(mif, IF_NSTEP,
                                lambda n, _: {'k1': n, 'k4': n}, w_if)
  kernel_launches['k1_implicitfast'] = launches['k1']
  kernel_launches['k4_implicitfast'] = launches['k4']
  need = not k4_ref.has_rows(mif)
  _, a4, niter = compare(f'humanoid_implicitfast rollout W={w_if}', st.qpos,
                         st.qvel, st.ctrl, st.warmstart, 'contact', need,
                         mif, '_implicitfast')
  fused_timing('_implicitfast', mif, (mif, st.qpos, st.qvel), need, a4,
               niter)
  say(f"[main path] humanoid_implicitfast: step "
      f"{1e3 * w_if / res['steps_per_sec']:.3f} ms; phase 11 took "
      f"{time.perf_counter() - t11:.1f} s")

  # ---- 12. tendons on the general step
  say(f'[phase 12] at {time.perf_counter() - T0:.1f} s')
  t12 = time.perf_counter()

  def step_compare(label, d, model, kerns, sfx, bar='dmc'):
    """The kernels ``kerns`` of ``model``'s general step against their
    plain versions on world-major state d (carried fields), each fed the
    plain version's upstream outputs, in the main path's layouts, the
    solve at parity's ``bar`` ('elliptic' with elliptic cones; qacc past
    it in a world without a live row by each side's gradient, and
    qfrc_constraint with the rows' slack in a loose world); errors to
    err[kernel + sfx], or printed only where ``sfx`` is None.  Where the torch Newton runs, chol_batched also
    on its first H and chol_solve on its first gradient; under
    IMPLICITFAST chol_batched on M - h qDeriv and chol_solve on its
    system.  Returns each kernel's arguments and the plain solve's mean
    Newton count (0 without rows or without the solve kernel)."""
    nv, nb = model.nv, model.nbody
    held_by_gradient = loose = 0
    d = forward.pre(model, d)
    am = (model, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv),
          lanes(d.qvel))
    got, want = kmass.mass_chain_lanes(*am), kmass.mass_chain_plain(*am)
    args, errs, niter = {'mass_chain': am}, {}, 0.0
    try:
      keep = [i for i in range(5) if want[i] is not None]
      if [i for i in range(5) if got[i] is not None] != keep:
        fail(f'{label}: the mass chain kernel and its plain version '
             'return different outputs')
      errs['mass_chain'], rel = parity.check_rel(
          [got[i] for i in keep], [want[i] for i in keep],
          [parity.MASS_NAMES[i] for i in keep])
      qM, qLD, cvel, cdd, bias = want
      if qLD is None:  # the large-tree form: armature, then chol_batched
        qM = osmooth.tendon_armature(model, d.replace(qM=qM)).qM
        args['chol_batched'] = (model, qM, kmass.BIG_JITTER)
        L = klinalg.chol_batched_plain(qM, kmass.BIG_JITTER)
        errs['chol_batched'] = parity.check_world_scale(
            lanes(klinalg.chol_batched(*args['chol_batched']), nv * nv),
            lanes(L, nv * nv), 'qLD', *SB)
      else:
        qM, L = world(qM, nv, nv), world(qLD, nv, nv)
      d = osmooth.tendon_bias(model, d.replace(
          qM=qM, qLD=L, cvel=world(cvel, nb, 6), cdof_dot=world(cdd, nv, 6),
          qfrc_bias=bias.T))
      d = forward.mid(model, d)
      args['chol_solve'] = (model, d.qLD, d.qfrc_smooth)
      x = klinalg.chol_solve_plain(lanes(d.qLD, nv * nv),
                                   lanes(d.qfrc_smooth))
      errs['chol_solve'] = check_layouts(klinalg.chol_solve_batched,
                                         *args['chol_solve'], x,
                                         'qacc_smooth')
      qacc = x
      if 'solve' in kerns:
        d = d.replace(qacc_smooth=x.T)
        # elliptic cones: the solve kernel's elliptic form, with the
        # contacts' row scales
        ell = bool(solver_ref.ell_groups(model))
        args['solve'] = (model, lanes(d.efc_J), lanes(d.efc_D),
                         lanes(d.efc_aref), lanes(d.efc_frictionloss),
                         lanes(d.qM), lanes(d.qfrc_smooth),
                         lanes(d.qacc_warmstart),
                         solver_ref.ell_scales(model, d.contact.friction)
                         if ell else None)
        gs, ws = (ksolver.solve_tiles(*args['solve']),
                  solver_ref.solve_tiles(*args['solve']))
        bar = 'elliptic' if ell else bar
        rs = parity.check_solve(gs, ws, bar, args['solve'][1:3],
                                system=args['solve'])
        errs['solve'], niter, qacc = (rs['qacc_max_abs_err'],
                                      rs['niter_mean'], ws[0])
        held_by_gradient, loose = rs['gradient_worlds'], rs['loose_worlds']
      if 'damped_solve' in kerns:
        args['damped_solve'] = (model, d.qM, qacc.T)
        dmp = klinalg.world_damping(model)  # per world where batched
        errs['damped_solve'] = check_layouts(
            klinalg.damped_solve_batched, *args['damped_solve'],
            klinalg.damped_solve_plain(lanes(d.qM, nv * nv), qacc, dmp),
            'qacc (damped)')
      extra = []
      if forward.large_system(model) and model.nefc and \
          model.opt.solver == types.SolverType.NEWTON:
        # the torch Newton's first H at the warmstart (with elliptic cones
        # its cone curvature), and its gradient
        H = osolver.first_hessian(model, d.replace(qacc_smooth=x.T))
        # timed where no large-tree factor is (stack_4's n 20)
        args.setdefault('chol_batched', (model, H, osolver._MINVAL))
        extra.append(('Newton H', H, osolver._MINVAL, d.qfrc_smooth))
      if model.opt.integrator == types.IntegratorType.IMPLICITFAST:
        A = (d.qM - model.opt.timestep *
             oderiv.deriv_smooth_vel(model, d)).contiguous()
        args['chol_batched'] = (model, A, 0.0)
        extra.append(('M - h qDeriv', A, 0.0, d.qfrc_smooth))
      for what, A, jit, b in extra:
        L = klinalg.chol_batched_plain(A, jit)
        e1 = parity.check_world_scale(
            lanes(klinalg.chol_batched(model, A, jit), nv * nv),
            lanes(L, nv * nv), f'L of {what}', *SB)
        e2 = check_layouts(klinalg.chol_solve_batched, model, L, b,
                           klinalg.chol_solve_plain(lanes(L, nv * nv),
                                                    lanes(b)),
                           f'solve with {what}')
        errs['chol_batched'] = max(errs.get('chol_batched', 0.0), e1)
        errs['chol_solve'] = max(errs['chol_solve'], e2)
    except AssertionError as e:
      fail(f'{label}: {e}')
    for k, e in errs.items():
      if sfx is not None:
        err[k + sfx] = max(err[k + sfx], e)
    say(f'[compare] {label}: ' + ', '.join(
        f'{k} max abs err {e:.3e}' for k, e in errs.items())
        + f'; mass chain worst relative {rel:.2e} (tol {parity.K1_TOL}); '
        f'chol_batched, chol_solve and damped_solve within atol '
        f'{parity.SOLVE_ATOL} + rtol {parity.SOLVE_RTOL} of world scale '
        f'(the solves in both layouts); the solve at parity\'s \'{bar}\' '
        f'bar, qacc past it in {held_by_gradient} worlds without a live '
        f'row held by each side\'s gradient (within '
        f'{parity.GRADIENT_BAR} tolerances), {loose} loose worlds '
        f'(tolerance above {parity.TOL_FLOOR}: under the bars of '
        f'{parity.FORCE_THROUGH_QACC} their qfrc_constraint carries the '
        f'rows\' slack); plain Newton niter mean {niter:.3f}')
    return args, niter

  def tendon_timing(args, niter, sfx):
    """Times each kernel in ``args`` (``step_compare``'s) per launch
    beside its plain version and the one PyTorch call of the same
    function where there is one, with its bound, under kernel + sfx."""
    model = args['mass_chain'][0]
    nv, nb, nefc = model.nv, model.nbody, model.nefc
    W = args['mass_chain'][3].shape[-1]
    factor = kmass.factor_in_kernel(model)
    am = args['mass_chain']
    # the armature and gravity read: one row, or one per world
    tables = sum(x.numel() for x in kmass.world_params(model, W))
    rows = {'mass_chain': (
        'mass_chain_kernel', lambda: kmass.mass_chain_lanes(*am),
        lambda: kmass.mass_chain_plain(*am), None, bound(
            W * F32 * (36 * nb + 7 * nv + (2 if factor else 1) * nv * nv +
                       6 * nb + 7 * nv) + F32 * tables,
            W * mass_chain_flops(model, factor)))}
    if 'chol_batched' in args:
      acb = args['chol_batched']
      A_j = (acb[1] + acb[2] * torch.eye(nv, device=dev)).contiguous()
      rows['chol_batched'] = (
          'chol_batched_kernel', lambda: klinalg.chol_batched(*acb),
          lambda: klinalg.chol_batched_plain(acb[1], acb[2]),
          lambda: torch.linalg.cholesky(A_j),
          bound(chol_batched_bytes(nv, W), W * chol_flops(nv)))
    dmp = klinalg.world_damping(model)
    ys = yardsticks(args['chol_solve'], args.get('damped_solve'), dmp)
    acs = args['chol_solve']
    rows['chol_solve'] = (
        'chol_solve_kernel', lambda: klinalg.chol_solve_batched(*acs),
        ys['chol_solve_plain'], ys['chol_solve_library'],
        bound(chol_solve_bytes(nv, W), W * 2 * nv * nv))
    live_rows = 0.0
    if 'solve' in args:
      asv = args['solve']
      live_rows = float((asv[2] > 0).sum()) / W
      # no one PyTorch call computes a Newton solve; its work is that of
      # this state's live rows
      flops = newton_flops if asv[-1] is None else newton_ell_flops
      rows['solve'] = (
          'solve_ell_kernel' if asv[-1] is not None else 'solve_kernel',
          lambda: ksolver.solve_tiles(*asv),
          lambda: solver_ref.solve_tiles(*asv), None, bound(
              W * F32 * (nefc * nv + 3 * nefc + nv * nv + 2 * nv + 2 * nv +
                         nefc + 1), W * flops(live_rows, nv, niter)))
    if 'damped_solve' in args:
      ads = args['damped_solve']
      rows['damped_solve'] = (
          'damped_solve_kernel', lambda: klinalg.damped_solve_batched(*ads),
          ys['damped_solve_plain'], ys['damped_solve_library'],
          bound(W * F32 * (nv * nv + 2 * nv) + F32 * dmp.numel(),
                W * (chol_flops(nv) + 4 * nv * nv + nv)))
    for k, (kern, fn, plain, lib, bnd) in rows.items():
      key = k + sfx
      time_kernel(key, fn, kern)
      call_ms[key] = time_ms(fn, 20)
      plain_ms[key] = time_ms(plain, 1 if k == 'solve' else 3)
      # one PyTorch call of the same function, timed here only
      library_ms[key] = None if lib is None else time_ms(lib, 20)
      bounds[key] = bnd
      say(f"[timing] {key} W={W} per launch: cuda {ms[key]:.4f} ms (call "
          f"{call_ms[key]:.4f}), plain {plain_ms[key]:.3f} ms, library "
          f"{'none' if lib is None else f'{library_ms[key]:.4f} ms'}, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}"
          + (f'; {live_rows:.2f} live rows per world, niter mean '
             f'{niter:.3f}' if k == 'solve' else '') + ')')
    shapes['mass_chain' + sfx] = kmass.kernel_info(model)
    if 'solve' in args:
      shapes['solve' + sfx] = ksolver.kernel_info(model)
    if 'chol_batched' in args:
      shapes['chol_batched' + sfx] = klinalg.chol_batched_info(nv)

  for name, sfx in TEN_SFX.items():
    mt, w_t = benchmarks.load_scene(name)
    kerns = TEN_KERNELS[name]
    res, st, launches = main_path(
        mt, TEN_NSTEP, lambda n, _: {k: n for k in kerns}, w_t)
    if osolver.trips:
      fail(f'{name}: {osolver.trips} trips of the torch Newton')
    if not bool(torch.isfinite(st.ten_length).all()):
      fail(f'{name}: ten_length not finite')
    if mt.nsensordata and not bool(torch.isfinite(st.sensordata).all()):
      fail(f'{name}: sensordata not finite')
    extra = ''
    if len(mt.efc.lim_ten_id):
      lim = st.efc_active[:, torch.as_tensor(mt.efc.lim_ten_adr,
                                             device=dev).long()]
      share = float(lim.any(1).float().mean())
      extra += f'; worlds with an active tendon limit row {share:.4f}'
      if name == 'ball_in_cup' and share == 0.0:
        fail('ball_in_cup: no world\'s string limit is active')
    wraps = osmooth.tendon_wraps(mt, st)
    if wraps:
      extra += '; wrapped share of the segments over ' + ', '.join(
          f"{'spheres' if sph else 'cylinders'} (sidesite {side}) "
          f'{float(w.float().mean()):.4f}' for (sph, side), w in
          wraps.items())
    if mt.nsensordata:
      means = {t: round(float(st.sensordata[:, torch.as_tensor(
          c, device=dev)].mean()), 6)
               for cols in parity.sensor_stages(mt).values()
               for t, c in cols.items()}
      extra += '; sensordata mean by type ' + json.dumps(means)
    say(f"[main path] {name} (nv {mt.nv}, ntendon {mt.ntendon}, nefc "
        f"{mt.nefc}): step {1e3 * w_t / res['steps_per_sec']:.3f} ms; "
        f"qpos, ten_length and sensordata finite{extra}")
    for k in kerns:
      kernel_launches[k + sfx] = launches[k]
    args, niter = step_compare(f'{name} rollout W={w_t}',
                               types.carried(st), mt, kerns, sfx)
    tendon_timing(args, niter, sfx)
    # one step of the last state on the card and on the CPU (plain
    # versions)
    mcpu = io.load_model_npz(benchmarks.SCENES[name][0], device='cpu')
    sub = {k: getattr(st, k)[:NSENSOR_CMP] for k in types.CARRY}
    on_card = forward.step(mt, types.Data(**sub))
    on_cpu = forward.step(mcpu, types.Data(**{k: v.cpu() for k, v in
                                              sub.items()}))
    try:
      tj, tjc = on_card.ten_J.cpu(), on_cpu.ten_J
      e_tj = float((tj - tjc).abs().max())
      excess = float(((tj - tjc).abs() - (TEN_J_ATOL + TEN_J_RTOL *
                                          tjc.abs())).max())
      if excess > 0.0:
        raise AssertionError(f'ten_J exceeds its bar by {excess}')
      parity.check_world_scale(on_card.qpos.cpu().T, on_cpu.qpos.T, 'qpos',
                               parity.QPOS_ATOL, parity.QPOS_RTOL)
      rsen = None
      if mt.nsensordata:
        rsen = parity.check_sensors(mcpu, on_card.sensordata.cpu(),
                                    on_cpu.sensordata,
                                    on_card.solver_niter.cpu(),
                                    on_cpu.solver_niter)
    except AssertionError as e:
      fail(f'{name}, one step card against CPU: {e}')
    say(f'[compare] {name} one step W={NSENSOR_CMP}, card against the '
        f'CPU\'s plain versions: ten_J max abs err {e_tj:.3e} (atol '
        f'{TEN_J_ATOL} + rtol {TEN_J_RTOL}), qpos within atol '
        f'{parity.QPOS_ATOL} + rtol {parity.QPOS_RTOL} of world scale'
        + ('' if rsen is None else '; sensordata max abs err by stage '
           + json.dumps(rsen['max_abs_err']) + f' (pos and vel within atol '
           f'{parity.SENSOR_ATOL} + rtol {parity.SENSOR_RTOL}; acc within '
           f'atol {parity.QACC_ATOL} + rtol {parity.QACC_RTOL} of world '
           f'scale where Newton counts agree)'))
  say(f'[main path] phase 12 took {time.perf_counter() - t12:.1f} s')

  # ---- 13. cylinders, ellipsoids, RK4, the implicit integrators and
  # inverse dynamics on the general step
  say(f'[phase 13] at {time.perf_counter() - T0:.1f} s')
  t13 = time.perf_counter()
  IT = types.IntegratorType

  def classic_expect(model):
    """Each kernel's launches per step of ``model``'s general step (the
    main path's exact counts): per forward (four under RK4) the mass
    chain, chol_solve for qacc_smooth, chol_batched after the large-tree
    chain, and the solve kernel, or the torch Newton's chol_batched and
    chol_solve once at its start and once per trip; damped_solve under
    damped Euler; under IMPLICITFAST one chol_batched and one chol_solve
    on M - h qDeriv; under CG chol_solve at its start and once per trip,
    and no chol_batched of its own; as a function (steps, Newton or CG
    trips) -> counts."""
    nfwd = 4 if model.opt.integrator == IT.RK4 else 1
    rows = model.nefc and not (model.opt.disableflags &
                               types.DisableBit.CONSTRAINT)
    kernel_solve = forward.solve_kernel_runs(model)
    big = not kmass.factor_in_kernel(model)
    implicitfast = model.opt.integrator == IT.IMPLICITFAST
    damped = model.opt.integrator == IT.EULER and k4_ref.damped(model)
    cg = model.opt.solver == types.SolverType.CG

    def expect(n, trips):
      c = {'mass_chain': nfwd * n, 'chol_solve': nfwd * n,
           'chol_batched': nfwd * n if big else 0}
      if rows and kernel_solve:
        c['solve'] = nfwd * n
      elif rows:
        # CG: M^-1 grad by chol_solve on qLD, no factor of its own
        c['chol_batched'] += 0 if cg else nfwd * n + trips
        c['chol_solve'] += nfwd * n + trips
      if damped:
        c['damped_solve'] = n
      if implicitfast:
        c['chol_batched'] += n
        c['chol_solve'] += n
      return {k: v for k, v in c.items() if v}
    return expect

  def scene_model(name, device=None):
    """(model, width) of a scene of ``benchmarks.SCENES``, or of one of
    phase 16's test scenes (``io.ACT_SNAPSHOTS``) at ACT_TEST_NWORLD."""
    if name in benchmarks.SCENES:
      return benchmarks.load_scene(name, device=device)
    return (io.load_model_npz(io.ACT_SNAPSHOTS[name], device=device),
            ACT_TEST_NWORLD)

  def qfrc_witness(name, a):
    """For a scene whose solve bar carries qfrc_constraint's slack
    (parity.SOLVE_BAR_OF, or loose worlds): on the worlds of the system ``a`` (the solve
    kernel's arguments) where the kernel's qfrc_constraint lies past the
    K4 bar without it, or else the QFRC_WITNESS nearest, the plain solve
    in float64 run to its optimum (tolerance 1e-14), and each world's
    qfrc_constraint distance to it, in K4 bars, for the kernel, the plain
    version and the float64 plain solve at the model's tolerance."""
    gs, ws = ksolver.solve_tiles(*a), solver_ref.solve_tiles(*a)
    q_bar = parity.QACC_ATOL + parity.QACC_RTOL * ws[2].abs().amax(0)
    q_past = ((gs[2] - ws[2]).abs().amax(0) - q_bar)
    ids = torch.nonzero(q_past > 0).reshape(-1)
    if not len(ids):
      ids = torch.argsort(q_past, descending=True)[:QFRC_WITNESS]
    m64 = io.load_model_npz(benchmarks.SCENES[name][0] if name in
                            benchmarks.SCENES else io.ACT_SNAPSHOTS[name],
                            dtype=torch.float64)
    # the worlds' own tolerances where they are batched
    tols = {k: types.get_model_field(a[0], k)[ids].cpu().numpy()
            for k in ('opt.tolerance', 'opt.ls_tolerance')
            if k in a[0].batch_fields}
    if tols:
      m64 = io.batch_model(m64, len(ids), tols)
    sub = [None if x is None else x[..., ids].double() for x in a[1:]]
    f64 = solver_ref.solve_tiles(m64, *sub)
    opt = solver_ref.solve_tiles(m64.replace(opt=m64.opt.replace(
        tolerance=torch.tensor(1e-14, dtype=torch.float64, device=dev),
        iterations=200), batch_fields=tuple(
            n for n in m64.batch_fields if n != 'opt.tolerance')), *sub)
    bar = parity.QACC_ATOL + parity.QACC_RTOL * opt[2].abs().amax(0)
    far = lambda q: [float(f'{float(x):.4g}') for x in (
        (q.double() - opt[2]).abs().amax(0) / bar)]
    say(f'[compare] {name}: qfrc_constraint of the solve kernel against '
        f'its plain version, past the K4 bar without the qacc slack by '
        f'{float(q_past.max()):.4e} at most; worlds '
        f'{ids.tolist()} ' + ('(past it)' if float(q_past.max()) > 0 else
                              '(nearest it)') + ': distance to the float64 '
        f'optimum in K4 bars, kernel {far(gs[2][:, ids])}, plain '
        f'{far(ws[2][:, ids])}, float64 at the model\'s tolerance '
        f'{far(f64[2])}; Newton counts kernel '
        f'{gs[3][0, ids].tolist()}, plain {ws[3][0, ids].tolist()}, '
        f'float64 {f64[3][0].tolist()}, optimum {opt[3][0].tolist()}')
    return ids.tolist()

  def trip_trace(name, a, ids):
    """The stop quantities of the solve, trip by trip, on the worlds
    ``ids`` of the system ``a`` (the solve kernel's arguments).  The
    kernel's iterates come from the kernel cut at 1, 2, ... trips
    (opt.iterations); from each iterate k - 1 the plain version takes one
    trip and gives the stop quantities of trip k (improvement, gradient
    norm, model improvement, in tolerances: a stop where one is below 1)
    and the distance of its iterate to the kernel's iterate k in qacc
    bars; the plain version's own trips are traced along its own path.
    Where the kernel stops at trip k and the plain test, one trip from the
    kernel's own iterate k - 1, stops too, the two part by their path
    (the iterates of earlier trips), not by the order in which the stop
    test sums; where the plain test would go on, the kernel's own
    evaluation stops it.  For each world, the kernel's own least stop
    quantity at its last trip: the tolerance t at which the kernel, from
    its iterate k - 1, stops after one trip and below which it goes on,
    by bisection in log t with ls_tolerance / t (so that the linesearch's
    gtol, tol ls_tol, and with it the trip stay as they were); beside it
    the plain version's three quantities from that iterate in float32
    and in float64.  Then the same stop read inside each side's own run:
    the kernel's least quantity at trip k of its run from the warmstart
    (the same bisection, the run cut at k + 1 trips), and the plain
    version's trip k along its own path beside one plain trip from its
    own iterate k - 1.  Where a reading inside a run parts from the one
    from that run's iterate k - 1, the state that the run carries from
    trip to trip (Ma and Jaref, each updated by the step, as the plain
    version and pallas/solver.py update them) moves the stop."""
    m_ = a[0]
    sub = [None if x is None else x[..., torch.as_tensor(
        ids, device=dev)].contiguous() for x in a[1:]]
    tol = float(types.host(m_.opt.tolerance))
    cut = lambda k: m_.replace(opt=m_.opt.replace(iterations=k))

    def rec(into):
      return lambda niter, alpha, impr, gnorm, model, done: into.append(
          (torch.cat([impr, gnorm, model]) / tol).cpu())
    own = []
    pn = solver_ref.solve_tiles(m_, *sub, trace=rec(own))[3][0].tolist()
    kn = ksolver.solve_tiles(m_, *sub)[3][0].tolist()
    q_prev, at_kernel, dist, iterates = sub[6], [], [], [sub[6]]
    for k in range(1, max(kn) + 1):
      qk = ksolver.solve_tiles(cut(k), *sub)[0]
      iterates.append(qk)
      one = []
      qo = solver_ref.solve_tiles(cut(1), *sub[:6], q_prev, *sub[7:],
                                  trace=rec(one))[0]
      at_kernel.append(one[0] if one else None)
      bar = parity.QACC_ATOL + parity.QACC_RTOL * qk.abs().amax(0)
      dist.append(((qo - qk).abs().amax(0) / bar).cpu())
      q_prev = qk
    # one plain trip from the plain version's own iterate k - 1 (its run
    # cut at k - 1 trips), to set beside its trip k inside its own run
    fresh_p = []
    for k in range(1, max(kn) + 1):
      qp = sub[6] if k == 1 else solver_ref.solve_tiles(cut(k - 1), *sub)[0]
      one = []
      solver_ref.solve_tiles(cut(1), *sub[:6], qp, *sub[7:], trace=rec(one))
      fresh_p.append(one[0] if one else None)
    f = lambda x: float(f'{float(x):.4g}')
    ls = float(types.host(m_.opt.ls_tolerance))
    m64 = io.model_from_numpy(io.model_to_numpy(m_), device=dev,
                              dtype=torch.float64)

    def kernel_least(i, q0, k=1, hi=1e4):
      """The kernel's least stop quantity at trip k of a run from q0
      (world i), in tolerances: the tolerance t at which the run, cut at
      k + 1 trips, stops at trip k and below which it goes on, by
      bisection (24 halvings of the log bracket; a string where it lies
      below the bracket).  From an iterate with k 1 it reads one trip
      from there; from the warmstart with the kernel's own count k it
      reads the stop inside the kernel's own run, which carries its
      state (Ma, Jaref, the factor) from trip to trip."""
      one = [None if x is None else x[..., i:i + 1].contiguous()
             for x in sub]
      one[6] = q0[:, i:i + 1].contiguous()

      def trips_at(t):
        mt = m_.replace(opt=m_.opt.replace(
            tolerance=torch.tensor(t * tol, device=dev),
            ls_tolerance=torch.tensor(ls / t, device=dev),
            iterations=k + 1))
        return int(ksolver.solve_tiles(mt, *one)[3][0, 0])
      lo = 1e-12
      while hi > lo and trips_at(hi) < k:  # an earlier test passes
        hi *= 0.5
      if trips_at(hi) != k:
        return None
      if trips_at(lo) != k + 1:
        return f'< {lo:g}'

      for _ in range(24):
        mid = (lo * hi) ** 0.5
        lo, hi = (lo, mid) if trips_at(mid) == k else (mid, hi)
      return hi

    def f64_trip(i, q0):
      """The plain version's stop quantities of one trip from q0 (world
      i) in float64, in tolerances."""
      one = [None if x is None else x[..., i:i + 1].double() for x in sub]
      one[6] = q0[:, i:i + 1].double()
      got = []
      solver_ref.solve_tiles(m64.replace(opt=m64.opt.replace(
          iterations=1)), *one, trace=lambda n, a, *q: got.append(
              [float(x) / tol for x in q[:3]]))
      return [f(x) for x in got[0]] if got else None

    verdicts = []
    for i, w in enumerate(ids):
      k_end = kn[i]
      trips_k = [[f(x) for x in at_kernel[k][:, i]] + [f(dist[k][i])]
                 if at_kernel[k] is not None else None
                 for k in range(k_end)]
      trips_p = [[f(x) for x in own[k][:, i]] for k in range(pn[i])]
      last = trips_k[-1] if trips_k else None
      stops = last is not None and min(last[:3]) < 1.0
      verdict = ('path' if stops or k_end >= int(m_.opt.iterations) else
                 'its own evaluation')
      verdicts.append(verdict)
      least = kernel_least(i, iterates[k_end - 1])
      own_least = kernel_least(i, sub[6], k_end, 1.0) \
          if k_end < int(m_.opt.iterations) else None
      exact = f64_trip(i, iterates[k_end - 1])
      fp = fresh_p[k_end - 1]
      plain_fresh = None if fp is None else [f(x) for x in fp[:, i]]
      plain_own = trips_p[k_end - 1] if k_end <= pn[i] else None
      fmt = lambda x: x if x is None or isinstance(x, str) else f(x)
      say(f'[trace] {name} world {w}: kernel {k_end} trips, plain '
          f'{pn[i]}; one plain trip from each kernel iterate '
          f'(improvement, gradient, model improvement in tolerances; its '
          f'iterate to the kernel\'s in qacc bars) {trips_k}; the plain '
          f'version\'s own trips {trips_p}; the kernel\'s stop at trip '
          f'{k_end}: {verdict}; there the kernel\'s least stop quantity '
          f'{fmt(least)} one trip from its iterate {k_end - 1} and '
          f'{fmt(own_least)} inside its own run, the plain version\'s '
          f'{last[:3] if last else None} from the kernel\'s iterate, '
          f'{plain_fresh} from its own iterate {k_end - 1} and '
          f'{plain_own} inside its own run, float64 {exact}')
    say(f'[trace] {name}: worlds {list(ids)}, verdicts {verdicts} (a '
        '"path" stop: the plain test stops on the kernel\'s own iterate '
        'too; "its own evaluation": the plain test goes on there)')

  def general_scene(name, sfx, nstep, init=None, warmup=WARMUP,
                    ncmp=NSENSOR_CMP):
    """One scene of phases 13, 14, 16 and 17: ``main_path`` at its width
    (``scene_model``) from ``init`` (or qpos0 plus noise), exact counts
    from ``classic_expect``, its kernels held and timed on the last state
    (``step_compare``, ``tendon_timing``), and one step of ``ncmp``
    worlds on the card against the CPU's plain step (qpos, act and
    sensordata).  Prints the rollout's peak device memory.  Returns the
    last state and the rollout's metrics."""
    t_scene = time.perf_counter()
    mt, w_t = scene_model(name)
    expect = classic_expect(mt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trips0, walks0 = oray.trips, oray.walks
    res, st, launches = main_path(mt, nstep, expect, w_t, init_state=init,
                                  warmup=warmup)
    # the height-field ray walks of the rollout alone
    res['ray_trips'] = oray.trips - trips0
    res['ray_walks'] = oray.walks - walks0
    res['max_memory_allocated_gb'] = torch.cuda.max_memory_allocated() / 1e9
    kerns = tuple(expect(1, 1))
    if mt.nsensordata and not bool(torch.isfinite(st.sensordata).all()):
      fail(f'{name}: sensordata not finite')
    steps = nstep + warmup
    ncon = 0.0 if st.ncon_active is None else float(
        st.ncon_active.float().mean())
    say(f"[main path] {name} (nv {mt.nv}, ncon {mt.ncon}, nefc {mt.nefc}, "
        f"integrator {IT(mt.opt.integrator).name}, solver "
        f"{types.SolverType(mt.opt.solver).name}, cone "
        f"{types.ConeType(mt.opt.cone).name}): step "
        f"{1e3 * w_t / res['steps_per_sec']:.3f} ms; mean live contacts "
        f"per world {ncon:.3f}; torch Newton or CG trips per step "
        f"{osolver.trips / steps:.3f}; host reads per step "
        f"{outil.host_reads['solver'] / steps:.3f}; qpos and sensordata "
        f"finite; peak device memory {res['max_memory_allocated_gb']:.3f} "
        'GB' + (f'; act in [{float(st.act.min()):.4f}, '
                f'{float(st.act.max()):.4f}]' if mt.na else ''))
    for k in kerns:
      kernel_launches[k + sfx] = launches[k]
    t_hold = time.perf_counter()
    args, niter = step_compare(f'{name} rollout W={w_t}', types.carried(st),
                               mt, kerns, sfx,
                               parity.SOLVE_BAR_OF.get(name, 'dmc'))
    tendon_timing(args, niter, sfx)
    if parity.SOLVE_BAR_OF.get(name) in parity.QFRC_THROUGH_QACC and \
        'solve' in args:
      wit = qfrc_witness(name, args['solve'])
      W_s = args['solve'][1].shape[-1]
      trip_trace(name, args['solve'], sorted(set(wit) | {
          w for w in TRACE_WORLDS if w < W_s}))
    t_hold = time.perf_counter() - t_hold
    t_cmp = time.perf_counter()
    # one step of NSENSOR_CMP worlds of the last state on the card and on
    # the CPU (plain versions)
    mcpu, _ = scene_model(name, device='cpu')
    sub = {k: getattr(st, k)[:ncmp] for k in types.CARRY}
    on_card = forward.step(mt, types.Data(**sub))
    on_cpu = forward.step(mcpu, types.Data(**{k: v.cpu() for k, v in
                                              sub.items()}))
    try:
      parity.check_world_scale(on_card.qpos.cpu().T, on_cpu.qpos.T, 'qpos',
                               parity.QPOS_ATOL, parity.QPOS_RTOL)
      if mt.na:
        parity.check_world_scale(on_card.act.cpu().T, on_cpu.act.T, 'act',
                                 parity.QPOS_ATOL, parity.QPOS_RTOL)
      rsen = None
      if mt.nsensordata:
        slack = parity.step_slack(mcpu, types.Data(**{
            k: v.cpu() for k, v in sub.items()})) \
            if forward.large_system(mt) else None
        rsen = parity.check_sensors(
            mcpu, on_card.sensordata.cpu(), on_cpu.sensordata,
            on_card.solver_niter.cpu(), on_cpu.solver_niter, slack,
            'cg' if mt.opt.solver == types.SolverType.CG else 'contact',
            mt.opt.iterations)
    except AssertionError as e:
      fail(f'{name}, one step card against CPU: {e}')
    say(f'[compare] {name} one step W={ncmp}, card against the '
        f'CPU\'s plain versions: qpos{" and act" if mt.na else ""} within '
        f'atol {parity.QPOS_ATOL} + rtol {parity.QPOS_RTOL} of world scale'
        + ('' if rsen is None else '; sensordata max abs err by stage '
           + json.dumps(rsen['max_abs_err'])))
    t_cmp = time.perf_counter() - t_cmp
    say(f'[main path] {name} took {time.perf_counter() - t_scene:.1f} s: '
        f'the rollout (build and first step included) '
        f'{time.perf_counter() - t_scene - t_cmp - t_hold:.1f} s, the '
        f'kernels held and timed {t_hold:.1f} s, the step against the CPU '
        f'{t_cmp:.1f} s')
    return st, res

  for name, sfx in CLS_SFX.items():
    init = None
    if name in parity.DMC_DROP:
      mh, w_t = benchmarks.load_scene(name, device='cpu')
      qpos, qvel, _ = parity.dmc_state(mh, name, w_t, 0)
      init = {'qpos': qpos, 'qvel': qvel}
    general_scene(name, sfx, CMU_NSTEP if init else CLS_NSTEP, init,
                  SLOW_WARMUP if init else WARMUP)

  # inverse dynamics at the constraints scene's width: the forward's
  # converged qacc at a seeded state, then the inverse on the card and on
  # the CPU, plain and under INVDISCRETE, and the round trip
  mi, w_i = benchmarks.load_scene('constraints')
  mih = io.load_model_npz(benchmarks.SCENES['constraints'][0], device='cpu')
  qpos, qvel, ctrl = parity.general_state(mih, w_i, 8)
  applied = (0.5 * np.random.default_rng(8).standard_normal(
      (w_i, mi.nv))).astype(np.float32)
  dh = io.make_data(mih, w_i, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl), qfrc_applied=torch.as_tensor(applied))
  dc = types.carried(dh, lambda x: x.to(dev))
  fwd = forward._forward(mi, dc)
  # the round trip holds where the forward's Newton converged
  conv = (fwd.solver_niter < mi.opt.iterations).cpu()
  dc, dh = dc.replace(qacc=fwd.qacc), dh.replace(qacc=fwd.qacc.cpu())
  for discrete in (False, True):
    flags = mi.opt.enableflags | (int(types.EnableBit.INVDISCRETE)
                                  if discrete else 0)
    mc_ = mi.replace(opt=mi.opt.replace(enableflags=flags))
    mh_ = mih.replace(opt=mih.opt.replace(enableflags=flags))
    zero_counters()
    t0 = time.perf_counter()
    inv = oinverse.inverse(mc_, dc)
    torch.cuda.synchronize()
    t_inv = time.perf_counter() - t0
    got = counters()
    want = {k: 0 for k in got}
    want.update({'mass_chain': 1, 'chol_solve': 1 if discrete else 0})
    if got != want:
      fail(f'inverse launch counts {got} != {want}')
    ref = oinverse.inverse(mh_, dh)
    # qfrc_inverse is a difference of its terms (M qacc, the bias, the
    # stiff rows' forces), each held at its own bar: the bar is relative
    # to the largest term of the world
    terms = torch.stack([x.abs().amax(1) for x in (
        torch.einsum('wij,wj->wi', ref.qM, dh.qacc), ref.qfrc_bias,
        ref.qfrc_constraint)]).amax(0)
    err_w = (inv.qfrc_inverse.cpu() - ref.qfrc_inverse).abs().amax(1)
    e_inv = float(err_w.max())
    excess = float((err_w - (SB[0] + SB[1] * terms)).max())
    if excess > 0.0:
      fail(f'inverse on the card against the CPU exceeds atol {SB[0]} + '
           f'rtol {SB[1]} of the largest term by {excess} (world '
           f'{int((err_w - SB[1] * terms).argmax())})')
    trip = ''
    if not discrete:
      want_f = (fwd.qfrc_actuator + fwd.qfrc_applied).cpu()
      scale = torch.stack([x.abs().amax(1) for x in (
          torch.einsum('wij,wj->wi', fwd.qM, fwd.qacc), fwd.qfrc_bias,
          fwd.qfrc_constraint)]).amax(0).cpu()
      excess = float(((inv.qfrc_inverse.cpu() - want_f).abs().amax(1) -
                      (1e-4 + 1e-4 * scale))[conv].max())
      if excess > 0.0:
        fail(f'inverse round trip exceeds 1e-4 + 1e-4 of world scale by '
             f'{excess}')
      trip = ('; round trip qfrc_inverse = qfrc_applied + qfrc_actuator '
              f'within 1e-4 + 1e-4 of world scale in the {int(conv.sum())} '
              f'of {w_i} worlds whose forward converged')
    say(f'[main path] inverse on constraints W={w_i}'
        f"{' (INVDISCRETE)' if discrete else ''}: {1e3 * t_inv:.3f} ms, "
        f'launches {got}; against the CPU max abs err {e_inv:.3e} (atol '
        f'{SB[0]} + rtol {SB[1]} of the world\'s largest term){trip}')
  say(f'[main path] phase 13 took {time.perf_counter() - t13:.1f} s')

  # ---- 14. elliptic cones in the torch Newton and CG, the public Data
  # API, the contact override and the float64 refusal on the card
  say(f'[phase 14] at {time.perf_counter() - T0:.1f} s')
  t14 = time.perf_counter()
  for name, sfx in TASK_SFX.items():
    mh, _ = benchmarks.load_scene(name, device='cpu')
    nstep, warmup = TASK_NSTEP[name]
    _, res = general_scene(name, sfx, nstep, benchmarks.start_state(name),
                           warmup)
    if forward.solve_kernel_runs(mh):
      say(f'[kernel] solve_ell_kernel on {name} (nefc {mh.nefc}, nv '
          f'{mh.nv}): {json.dumps(ksolver.kernel_info(mh))}')
    say(f"[main path] {name}: solver_cap_worlds {res['solver_cap_worlds']}"
        f", overflow_worlds {res['overflow_worlds']}")

  # the public Data API on the card, which has no mujoco: host records
  # with MjData's field names, from manipulator insert_peg's snapshot
  t_api = time.perf_counter()
  name = 'manipulator_insert_peg'
  mt, w_t = benchmarks.load_scene(name)
  mh, _ = benchmarks.load_scene(name, device='cpu')
  sizes = SimpleNamespace(**{k: getattr(mh, k) for k in (
      'nq', 'nv', 'nu', 'na', 'nbody', 'ngeom', 'nsite', 'ntendon',
      'nsensordata', 'ntree', 'nmocap', 'nhistory')})
  qpos, qvel, ctrl = parity.task_state(mh, 1, 14)
  rng = np.random.default_rng(14)
  rec = SimpleNamespace(
      time=0.5, qpos=qpos[0].astype(np.float64),
      qvel=qvel[0].astype(np.float64), act=np.zeros(mh.na),
      ctrl=ctrl[0].astype(np.float64),
      qfrc_applied=0.1 * rng.standard_normal(mh.nv),
      xfrc_applied=np.zeros((mh.nbody, 6)),
      mocap_pos=np.zeros((mh.nmocap, 3)), mocap_quat=np.zeros(
          (mh.nmocap, 4)), eq_active=np.asarray(mh.eq_active0, bool),
      qacc_warmstart=np.zeros(mh.nv), qacc=np.zeros(mh.nv),
      tree_asleep=np.full(mh.ntree, types.K_AWAKE, np.int32))

  def out_record():
    """A host record of every field get_data_into writes, as MjData
    shapes it."""
    n = {'qpos': sizes.nq, 'act': sizes.na, 'ctrl': sizes.nu,
         'sensordata': sizes.nsensordata, 'ten_length': sizes.ntendon,
         'ten_velocity': sizes.ntendon, 'tree_asleep': sizes.ntree}
    n['act_dot'] = sizes.na
    for k in ('qvel', 'qacc', 'qacc_warmstart', 'qfrc_bias', 'qfrc_passive',
              'qfrc_actuator', 'qfrc_constraint'):
      n[k] = sizes.nv
    for k in ('actuator_force', 'actuator_length', 'actuator_velocity'):
      n[k] = sizes.nu
    for obj, cnt in (('x', sizes.nbody), ('geom_x', sizes.ngeom),
                     ('site_x', sizes.nsite)):
      n[obj + 'pos'], n[obj + 'mat'] = (cnt, 3), (cnt, 9)
    n.update(xquat=(sizes.nbody, 4), xipos=(sizes.nbody, 3),
             ximat=(sizes.nbody, 9), subtree_com=(sizes.nbody, 3),
             mocap_pos=(sizes.nmocap, 3), mocap_quat=(sizes.nmocap, 4),
             history=sizes.nhistory)
    return SimpleNamespace(time=0.0, **{k: np.zeros(v) for k, v in
                                               n.items()})

  zero_counters()
  d_card = io.put_data(sizes, rec, mt, nworld=w_t)
  qvel0 = rec.qvel.copy()
  rec.qvel[:] = 123.0  # put_data copied: the Data must not see this
  if not bool((d_card.qvel[:, 0] != 123.0).all()):
    fail('put_data aliased the host record')
  rec.qvel[:] = qvel0
  d_card = forward.step(mt, d_card)
  got = counters()
  want = {k: 0 for k in got}
  want.update(classic_expect(mt)(1, osolver.trips))
  if got != want:
    fail(f'put_data -> step launch counts {got} != {want}')
  d_cpu = forward.step(mh, io.put_data(sizes, rec, mh, nworld=4))
  out_card, out_cpu = out_record(), out_record()
  io.get_data_into(out_card, sizes, d_card, world=w_t - 1)
  io.get_data_into(out_cpu, sizes, d_cpu, world=3)
  worst = 0.0
  for k, _ in io.GET_FIELDS:
    a, b = getattr(out_card, k), getattr(out_cpu, k)
    if not b.size:
      continue
    e = float(np.abs(a - b).max())
    bar = (parity.QPOS_ATOL + parity.QPOS_RTOL * float(np.abs(b).max())
           if k == 'qpos' else parity.QACC_ATOL + parity.QACC_RTOL *
           float(np.abs(b).max()))
    if e > bar:
      fail(f'get_data_into {k}: card against CPU {e} > {bar}')
    worst = max(worst, e / max(1.0, float(np.abs(b).max())))
  if out_card.time != out_cpu.time or not np.array_equal(
      out_card.tree_asleep, rec.tree_asleep):
    fail('get_data_into: time or tree_asleep differ')
  # reset_data with a mask of every third world
  mask = torch.zeros(w_t, dtype=torch.bool, device=dev)
  mask[::3] = True
  r = io.reset_data(mt, d_card, mask)
  fresh = io.make_data(mt, w_t)
  for k in ('qpos', 'qvel', 'time', 'qacc_warmstart', 'tree_island',
            'efc_island', 'xpos'):
    x = getattr(r, k)
    want_m = getattr(fresh, k)
    want_m = torch.zeros_like(x) if want_m is None else want_m
    if not (torch.equal(x[mask], want_m[mask]) and
            torch.equal(x[~mask], getattr(d_card, k)[~mask])):
      fail(f'reset_data: {k} of the masked or the other worlds wrong')
  # the contact slots of the reset worlds as make_data leaves them in JAX
  # (dist 1e10: every row masked until collision fills the slot)
  if not (bool((r.contact.dist[mask] == 1e10).all()) and torch.equal(
      r.contact.dist[~mask], d_card.contact.dist[~mask])):
    fail('reset_data: contact slots of the masked or the other worlds '
         'wrong')
  # override_model on the card: the contact override's tables against the
  # CPU's, and one step with them
  ovs = ['opt.enableflags=1', 'opt.o_margin=0.002', 'opt.o_solref=0.02',
         'opt.o_solimp=0.9', 'opt.o_friction=0.8']
  mo, moh = io.override_model(mt, ovs), io.override_model(mh, ovs)
  for k in ('cand_friction', 'cand_solref', 'cand_solimp',
            'cand_includemargin'):
    if not torch.equal(getattr(mo, k).cpu(), getattr(moh, k)):
      fail(f'override_model on the card: {k} differs from the CPU\'s')
  sub = {k: getattr(d_card, k)[:NSENSOR_CMP] for k in types.CARRY}
  on_card = forward.step(mo, types.Data(**sub))
  on_cpu = forward.step(moh, types.Data(**{k: v.cpu()
                                           for k, v in sub.items()}))
  try:
    parity.check_world_scale(on_card.qpos.cpu().T, on_cpu.qpos.T,
                             'qpos (override)', parity.QPOS_ATOL,
                             parity.QPOS_RTOL)
  except AssertionError as e:
    fail(f'override step card against CPU: {e}')
  say(f'[main path] Data API on {name} W={w_t}: put_data -> step -> '
      f'get_data_into against the CPU\'s, worst error {worst:.3e} of the '
      f'field\'s scale; reset_data of {int(mask.sum())} worlds; '
      f'override_model (contact override) tables equal to the CPU\'s, its '
      f'step within parity\'s qpos bar; {time.perf_counter() - t_api:.1f} s')
  # a float64 Model on the card raises in its first kernel
  m64 = io.load_model_npz(benchmarks.SCENES[name][0], device=dev,
                          dtype=torch.float64)
  try:
    forward.step(m64, io.make_data(m64, 64))
    fail('a float64 Model ran on the card')
  except TypeError as e:
    say(f'[main path] float64 Model on the card raises: {e}')
  say(f'[main path] phase 14 took {time.perf_counter() - t14:.1f} s')

  # ---- 15. domain randomization: humanoid_dmc_dr on the general step,
  # each world with its own physical parameters (io.batch_model,
  # io.set_const), kernels 4 and 7 reading per-world tables
  say(f'[phase 15] at {time.perf_counter() - T0:.1f} s')
  t15 = time.perf_counter()
  name, sfx = 'humanoid_dmc_dr', '_dr'
  # the draws and set_const at the scene's width: M^-1 by the mass chain,
  # chol_batched and one chol_solve per dof on the card
  zero_counters()
  t0 = time.perf_counter()
  mt, w_t = benchmarks.load_scene(name)
  torch.cuda.synchronize()
  t_setup = time.perf_counter() - t0
  got = counters()
  want = {k: 0 for k in got}
  want.update(mass_chain=1, chol_batched=1, chol_solve=mt.nv)
  if got != want:
    fail(f'{name}: set_const launch counts {got} != {want}')
  kernel_launches['chol_batched_sc'] = got['chol_batched']
  kernel_launches['chol_solve_sc'] = got['chol_solve']
  # set_const's outputs against its plain version on the CPU, on the
  # first DR_NSC worlds' drawn inputs (worlds are independent)
  mh0 = io.load_model_npz(benchmarks.SCENES[name][0], device='cpu')
  drawn = {k: types.get_model_field(mt, k)[:DR_NSC].cpu()
           for k in mt.batch_fields if k not in io.SET_CONST_FIELDS
           and not k.startswith('cand_')}
  mh = io.set_const(io.batch_model(mh0, DR_NSC, drawn))

  def world_rel(a, b):
    """Each world's largest |a - b| over its largest |b|, the worst."""
    scale = b.abs().reshape(b.shape[0], -1).amax(1).clamp(min=1e-30)
    return float(((a - b).abs().reshape(a.shape[0], -1).amax(1) /
                  scale).max())

  worst_sc = {}
  for k in io.SET_CONST_FIELDS:
    b = types.world_field(mh, k)
    if not b.numel():
      continue
    worst_sc[k] = world_rel(types.world_field(mt, k)[:DR_NSC].cpu(), b)
    bar = SC_MINV_RTOL if k in SC_MINV else SC_RTOL
    if worst_sc[k] > bar:
      fail(f'{name}: set_const {k} on the card against the CPU: '
           f'{worst_sc[k]} relative > {bar}')
  # planted faults: set_const on the card with world 0's armature, or its
  # masses and inertias, in every world (a per-world table read at world
  # stride 0) must read above the bar through M^-1, or the check is blind
  planted = {}
  mc = io.load_model_npz(benchmarks.SCENES[name][0], device=dev)
  for fault, keys in (('armature', ('dof_armature',)),
                      ('masses', ('body_mass', 'body_inertia'))):
    bad = {k: (v[:1].expand(v.shape) if k in keys else v).numpy()
           for k, v in drawn.items()}
    mf = io.set_const(io.batch_model(mc, DR_NSC, bad))
    planted[fault] = max(
        world_rel(types.world_field(mf, k).expand(
            types.world_field(mh, k).shape).cpu(), types.world_field(mh, k))
        for k in SC_MINV if types.world_field(mh, k).numel())
    if planted[fault] <= SC_MINV_RTOL:
      fail(f'{name}: set_const with world 0\'s {fault} in every world reads '
           f'{planted[fault]} through M^-1, within the bar {SC_MINV_RTOL}')
  say(f'[main path] {name}: set_const with world 0\'s armature or masses in '
      f'every world, the worst world of its M^-1 outputs against the CPU '
      f'(bar {SC_MINV_RTOL}): '
      + json.dumps({k: float(f'{v:.3e}') for k, v in planted.items()}))
  # M^-1 of set_const's two Cholesky kernels against their plain versions
  # on the same qM; then both timed at the scene's width
  qM_sc = kmass.mass_chain(mt, forward.pre(
      mt, io.make_data(mt, w_t))).qM.contiguous()
  L_sc = klinalg.chol_batched(mt, qM_sc)
  eye = torch.eye(mt.nv, device=dev)
  Minv = torch.stack([klinalg.chol_solve_batched(
      mt, L_sc, eye[j].expand(w_t, mt.nv)) for j in range(mt.nv)], -1)
  Lh = klinalg.chol_batched_plain(qM_sc[:DR_NSC].cpu())
  Minv_h = torch.stack([klinalg.chol_solve_plain(
      lanes(Lh, mt.nv * mt.nv), lanes(eye[j].cpu().expand(
          DR_NSC, mt.nv))).T for j in range(mt.nv)], -1)
  worst_sc['M^-1 (kernels 5-6)'] = world_rel(Minv[:DR_NSC].cpu(), Minv_h)
  if worst_sc['M^-1 (kernels 5-6)'] > SC_RTOL:
    fail(f"{name}: set_const's M^-1 by the kernels against the plain "
         f"versions: {worst_sc['M^-1 (kernels 5-6)']} relative > {SC_RTOL}")
  e0 = torch.zeros((w_t, mt.nv), device=dev)
  e0[:, 0] = 1.0
  e_sc = torch.eye(mt.nv, device=dev)[0].expand(w_t, mt.nv)
  err['chol_batched_sc'] = parity.check_world_scale(
      lanes(L_sc[:DR_NSC], mt.nv * mt.nv).cpu(), lanes(Lh, mt.nv * mt.nv),
      'set_const L', *SB)
  err['chol_solve_sc'] = parity.check_world_scale(
      klinalg.chol_solve_batched(mt, L_sc, e_sc).T.cpu(),
      klinalg.chol_solve_plain(lanes(L_sc, mt.nv * mt.nv).cpu(),
                               lanes(e0).cpu()), 'set_const M^-1 e_0', *SB)
  nv = mt.nv
  for key, kern, fn, plain, lib, bnd in (
      ('chol_batched_sc', 'chol_batched_kernel',
       lambda: klinalg.chol_batched(mt, qM_sc),
       lambda: klinalg.chol_batched_plain(qM_sc),
       lambda: torch.linalg.cholesky(qM_sc),
       bound(chol_batched_bytes(nv, w_t), w_t * chol_flops(nv))),
      ('chol_solve_sc', 'chol_solve_kernel',
       lambda: klinalg.chol_solve_batched(mt, L_sc, e_sc),
       lambda: klinalg.chol_solve_plain(lanes(L_sc, nv * nv), lanes(e0)),
       lambda: torch.cholesky_solve(e0[:, :, None], L_sc),
       bound(chol_solve_bytes(nv, w_t, shared_b=True), w_t * 2 * nv * nv))):
    time_kernel(key, fn, kern)
    call_ms[key] = time_ms(fn, 20)
    plain_ms[key] = time_ms(plain, 3)
    library_ms[key] = time_ms(lib, 20)
    bounds[key] = bnd
    say(f"[timing] {key} W={w_t} per launch: cuda {ms[key]:.4f} ms (call "
        f"{call_ms[key]:.4f}), plain {plain_ms[key]:.3f} ms, library "
        f"{library_ms[key]:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
  shapes['chol_batched_sc'] = klinalg.chol_batched_info(nv)
  say(f'[main path] {name} setup W={w_t}: the draws, batch_model and '
      f'set_const {t_setup:.2f} s, launches {got}; set_const against the '
      f'CPU\'s plain versions on {DR_NSC} worlds, the worst of each '
      f'field\'s world scale (bar {SC_RTOL}, through M^-1 {SC_MINV_RTOL}): '
      + json.dumps({k: float(f'{v:.3e}') for k, v in worst_sc.items()}))

  # the rollout: OU ctrl noise, worlds sorted every 4 steps with their
  # parameters
  expect = classic_expect(mt)
  zero_counters()
  res = benchmarks.run(mt, nworld=w_t, nstep=DR_NSTEP, warmup_steps=WARMUP)
  launches = counters()
  steps = DR_NSTEP + WARMUP
  want = {k: 0 for k in launches}
  want.update(expect(steps, osolver.trips))
  if launches != want:
    fail(f'{name}: launch counts {launches} != {want}')
  if res['overflow_worlds'] != 0:
    fail(f"{name}: overflow in {res['overflow_worlds']} worlds")
  st = res.pop('state')
  if res['converged_worlds'] != w_t or not bool(
      torch.isfinite(st.qvel).all()) or not bool(
          torch.isfinite(st.sensordata).all()):
    fail(f"{name}: {res['converged_worlds']} of {w_t} worlds finite")
  reads = sum(outil.host_reads.values()) / steps
  say(f"[main path] {name} W={w_t} x {DR_NSTEP} steps (+{WARMUP} warmup) "
      f"on {card}: {res['steps_per_sec']:.1f} steps/s, "
      f"{1e3 * w_t / res['steps_per_sec']:.3f} ms per step, host reads per "
      f"step {reads:.3f}, kernels per step "
      f"{sum(launches.values()) / steps:.3f} ({launches}), "
      f"solver_niter_mean {res['solver_niter_mean']:.4f}, overflow_worlds "
      f"0, {w_t}/{w_t} finite")
  for k in expect(1, 1):
    kernel_launches[k + sfx] = launches[k]
  mperm = res['model']
  if not torch.equal(types.world_field(mperm, 'dof_damping'),
                     types.world_field(mt, 'dof_damping')[
                         res['world_ids']]):
    fail(f'{name}: the sorted Model\'s worlds are not the Data\'s')
  # kernels 4 and 7 (and chol_solve, the solve) against their plain
  # versions on the last state, each world with its own tables, and timed
  args, niter = step_compare(f'{name} rollout W={w_t}', types.carried(st),
                             mperm, tuple(expect(1, 1)), sfx)
  tendon_timing(args, niter, sfx)
  # stride 0 against stride W: a batch whose every world carries the
  # unbatched values gives the unbatched kernels' output to the bit
  m0 = io.load_model_npz(benchmarks.SCENES[name][0])
  same = io.batch_model(m0, w_t, {
      k: types.host(types.get_model_field(m0, k), np.float32)[None]
      for k in ('dof_armature', 'opt.gravity', 'dof_damping')})
  am = args['mass_chain'][1:]
  for a, b in zip(kmass.mass_chain_lanes(same, *am),
                  kmass.mass_chain_lanes(m0, *am)):
    if (a is None) != (b is None) or (a is not None and
                                      not torch.equal(a, b)):
      fail(f'{name}: mass chain at stride {nv} differs from stride 0')
  ads = args['damped_solve'][1:]
  if not torch.equal(klinalg.damped_solve_batched(same, *ads),
                     klinalg.damped_solve_batched(m0, *ads)):
    fail(f'{name}: damped_solve at stride {nv} differs from stride 0')
  # worlds keep their parameters: the rollout's sort against no sort,
  # DR_KEEP_NSTEP steps from the last state at its ctrl, the order undone
  d0 = types.carried(st)
  runs = {}
  for sort in (True, False):
    mw, d, ids = mperm, d0, torch.arange(w_t, device=dev)
    for i in range(DR_KEEP_NSTEP):
      if sort and i % 4 == 0:
        perm = torch.argsort(d.solver_niter, stable=True)
        if i == 0:  # a permutation every world feels
          perm = torch.flip(perm, (0,))
        d = types.map_worlds(d, lambda x: x[perm], w_t)
        mw = types.map_model_worlds(mw, lambda x: x[perm])
        ids = ids[perm]
      d = forward.step(mw, d)
    runs[sort] = d.qpos[torch.argsort(ids)]
  try:
    e_keep = parity.check_world_scale(runs[True].cpu().T, runs[False].cpu().T,
                                      'qpos (sorted against unsorted)',
                                      parity.QPOS_ATOL, parity.QPOS_RTOL)
  except AssertionError as e:
    fail(f'{name}: {e}')
  # the same sort with the parameters left in their slots, for scale
  d, mw = d0, mperm
  perm = torch.flip(torch.argsort(d.solver_niter, stable=True), (0,))
  d = types.map_worlds(d, lambda x: x[perm], w_t)
  for _ in range(DR_KEEP_NSTEP):
    d = forward.step(mw, d)
  e_swap = float((d.qpos[torch.argsort(perm)] - runs[False]).abs().max())
  say(f'[compare] {name}: {DR_KEEP_NSTEP} steps sorted (the worlds reversed, '
      f'then by Newton count) against unsorted, order undone: qpos max abs '
      f'err {e_keep:.3e} (bar atol {parity.QPOS_ATOL} + rtol '
      f'{parity.QPOS_RTOL}); with the parameters left in their slots '
      f'{e_swap:.3e}; mass chain and damped_solve at stride {nv} equal to '
      f'stride 0 to the bit')
  say(f'[main path] phase 15 took {time.perf_counter() - t15:.1f} s')

  # ---- 16. actuation: activation dynamics, muscles, DC motors and the
  # site, slider-crank and body transmissions on the general step
  say(f'[phase 16] at {time.perf_counter() - T0:.1f} s')
  t16 = time.perf_counter()
  # scene: live contacts per world, Newton mean and trunk height at the end
  act_end = {}
  for name, (nstep, warmup) in ACT_NSTEP.items():
    mh, w_t = scene_model(name, device='cpu')
    qpos, qvel, _ = parity.dmc_state(mh, name, 64, 0)
    st, res = general_scene(name, ACT_SFX[name], nstep,
                            {'qpos': qpos, 'qvel': qvel}, warmup,
                            ACT_NCMP[name])
    ncon = float(st.ncon_active.float().mean())
    if ncon <= 0.0:
      fail(f'{name}: no live contact in the last state')
    act_end[name] = (ncon, res['solver_niter_mean'],
                     float(st.qpos[:, parity.DMC_ROOT[name]].mean()))
    say(f"[main path] {name} W={w_t}: {res['steps_per_sec']:.1f} steps/s, "
        f"overflow_worlds {res['overflow_worlds']}, converged_worlds "
        f"{res['converged_worlds']}, solver_cap_worlds "
        f"{res['solver_cap_worlds']}, live contacts per world {ncon:.3f}, "
        f"peak device memory {res['max_memory_allocated_gb']:.3f} GB")
    if forward.solve_kernel_runs(mh):
      say(f'[kernel] solve_kernel on {name} (nefc {mh.nefc}, nv {mh.nv}): '
          f'{json.dumps(ksolver.kernel_info(mh))}')
    say(f'[kernel] mass chain on {name} (nv {mh.nv}, nbody {mh.nbody}): '
        f'{json.dumps(kmass.kernel_info(mh))}')
  for name in ('dcmotor', 'transmission', 'actuator_mix'):
    st, res = general_scene(name, ACT_SFX[name], ACT_TEST_NSTEP, warmup=2)
    say(f"[main path] {name} W={ACT_TEST_NWORLD}: act_dot in "
        f"[{float(st.act_dot.min()):.4f}, {float(st.act_dot.max()):.4f}], "
        f"actuator_force in [{float(st.actuator_force.min()):.4f}, "
        f"{float(st.actuator_force.max()):.4f}]" if st.act_dot.numel() else
        f"[main path] {name} W={ACT_TEST_NWORLD}: actuator_force in "
        f"[{float(st.actuator_force.min()):.4f}, "
        f"{float(st.actuator_force.max()):.4f}]")
  say(f'[main path] phase 16 took {time.perf_counter() - t16:.1f} s')

  # ---- 17. fluid forces, rays and height fields on the general step
  say(f'[phase 17] at {time.perf_counter() - T0:.1f} s')
  t17 = time.perf_counter()

  def sensor_summary(name, model, st):
    """Each sensor type's mean over the last state's worlds and
    elements, and the rangefinders' hit share."""
    sd = st.sensordata
    if not model.nsensordata:
      return
    means = {}
    for t in sorted(set(int(x) for x in model.sensor_type)):
      ids = np.nonzero(np.asarray(model.sensor_type) == t)[0]
      cols = np.concatenate([int(model.sensor_adr[i]) + np.arange(
          int(model.sensor_dim[i])) for i in ids])
      means[types.SensorType(t).name] = float(
          f'{float(sd[:, torch.as_tensor(cols, device=dev)].mean()):.5g}')
    rf = np.nonzero(np.asarray(model.sensor_type) ==
                    types.SensorType.RANGEFINDER)[0]
    hit = ''
    if len(rf):
      cols = torch.as_tensor(np.asarray(model.sensor_adr)[rf], device=dev)
      hit = (f'; rangefinder hit share '
             f'{float((sd[:, cols] >= 0).float().mean()):.4f}')
    say(f'[main path] {name}: sensordata mean per type {json.dumps(means)}'
        + hit)

  for name, (nstep, warmup) in FLU_NSTEP.items():
    mh, w_t = scene_model(name, device='cpu')
    init = None
    if name in parity.DMC_DROP:
      qpos, qvel, _ = parity.dmc_state(mh, name, 64, 0)
      init = {'qpos': qpos, 'qvel': qvel}
    st, res = general_scene(name, FLU_SFX[name], nstep, init, warmup)
    steps = nstep + warmup
    say(f"[main path] {name} W={w_t}: {res['steps_per_sec']:.1f} steps/s, "
        f"overflow_worlds {res['overflow_worlds']}, converged_worlds "
        f"{res['converged_worlds']}, solver_cap_worlds "
        f"{res['solver_cap_worlds']}, solver "
        + ('the solve kernel' if forward.solve_kernel_runs(mh) else
           'the torch Newton' if mh.nefc and forward.large_system(mh) else
           'none (no rows)') +
        f" (nefc {mh.nefc} x nv {mh.nv} = {mh.nefc * mh.nv}), mean "
        f"|qfrc_fluid| {float(st.qfrc_fluid.abs().mean()):.5g}")
    sensor_summary(name, mh, st)
    if forward.solve_kernel_runs(mh):
      say(f'[kernel] solve_kernel on {name} (nefc {mh.nefc}, nv {mh.nv}): '
          f'{json.dumps(ksolver.kernel_info(mh))}')
    say(f'[kernel] mass chain on {name} (nv {mh.nv}, nbody {mh.nbody}): '
        f'{json.dumps(kmass.kernel_info(mh))}')
    if name == 'quadruped_escape':
      mt, _ = scene_model(name)
      ncon = float(st.ncon_active.float().mean())
      if ncon <= 0.0:
        fail(f'{name}: no live contact in the last state')
      # one rangefinder pass and the height-field collider on the last
      # state: host ms (the enqueue) and wall ms (to the device's end)
      d_last = forward.pre(mt, types.Data(**{k: getattr(st, k)
                                             for k in types.CARRY}))
      rf = np.nonzero(np.asarray(mt.sensor_type) ==
                      types.SensorType.RANGEFINDER)[0]
      objid = np.asarray(mt.sensor_objid)[rf]
      hf = [g for g in mt.pair_groups if g[0] == types.GeomType.HFIELD]

      def collide_hfield():
        for t1, t2, idx, _ in hf:
          ocollision_driver.collider(t1, t2)(
              mt, d_last, mt.pair_geom1[idx], mt.pair_geom2[idx])
      stage_ms = {}
      for what, fn in (('rangefinder pass', lambda: osensor._rangefinder(
          mt, d_last, objid)), ('height-field collider', collide_hfield)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        stage_ms[what] = (1e3 * t_host, 1e3 * (time.perf_counter() - t0))
      say(f'[main path] {name}: live contacts per world {ncon:.3f}; ray '
          f"walk trips per step {res['ray_trips'] / steps:.2f} over "
          f"{res['ray_walks'] / steps:.2f} walks per step (the most any "
          f'ray crosses; at most {201 + 201 - 3}); host / wall ms '
          + ', '.join(f'{k} {h:.3f} / {w:.3f}' for k, (h, w) in
                      stage_ms.items()))
  for name in ('sensors', 'contact_sensor', 'fluid_ellipsoid', 'geomdist'):
    st, res = general_scene(name, FLU_SFX[name], FLU_TEST_NSTEP, warmup=2)
    mh, w_t = scene_model(name, device='cpu')
    say(f"[main path] {name} W={w_t}: {res['steps_per_sec']:.1f} steps/s, "
        f"overflow_worlds {res['overflow_worlds']}, mean |qfrc_fluid| "
        f"{float(st.qfrc_fluid.abs().mean()):.5g}")
    sensor_summary(name, mh, st)
  say(f'[main path] phase 17 took {time.perf_counter() - t17:.1f} s')

  # ---- 18. mocap bodies, delay histories, gravity compensation, site
  # equality, the joint-in-parent transmission and RK4 with sleep
  say(f'[phase 18] at {time.perf_counter() - T0:.1f} s')
  t18 = time.perf_counter()

  def idle_share(name, model, st):
    """The device's idle share over IDLE_NSTEP[name] steps of the public
    step from ``st`` (a torch.profiler trace, ``devprofile._traced``),
    one step run first; the profiler slows the host, so it is an upper
    bound."""
    box = [forward.step(model, types.carried(st))]

    def one():
      box[0] = forward.step(model, box[0])
    s18 = devprofile._traced(one, IDLE_NSTEP[name], f'{name}_chip_smoke')
    say(f"[main path] {name}: idle share {s18['idle_share']:.4f} over "
        f"{IDLE_NSTEP[name]} traced steps ({s18['window_ms']:.1f} ms, "
        f"{s18['kernels_per_step']:.0f} kernels per step); host ms per "
        'step by stage ' + json.dumps({k: round(v, 3) for k, v in s18[
            'stage_host_ms_per_step'].items()}))
    return s18['idle_share']

  ma, w_a = scene_model('mocap_arm')
  nstep, warmup = ARM_NSTEP
  st, res = general_scene('mocap_arm', ARM_SFX['mocap_arm'], nstep,
                          warmup=warmup)
  say(f"[main path] mocap_arm W={w_a}: {res['steps_per_sec']:.1f} steps/s, "
      f"overflow_worlds {res['overflow_worlds']}, converged_worlds "
      f"{res['converged_worlds']}, live contacts per world "
      f"{float(st.ncon_active.float().mean()):.3f}, peak device memory "
      f"{res['max_memory_allocated_gb']:.3f} GB")
  say(f'[kernel] solve_kernel on mocap_arm (nefc {ma.nefc}, nv {ma.nv}): '
      f'{json.dumps(ksolver.kernel_info(ma))}')
  say(f'[kernel] mass chain on mocap_arm (nv {ma.nv}, nbody {ma.nbody}): '
      f'{json.dumps(kmass.kernel_info(ma))}')
  idle_share('mocap_arm', ma, st)
  # the teleoperation pattern: each world's target moved along a seeded
  # path and its ctrl drawn before every step of the public step
  rng = np.random.default_rng(18)
  d = types.carried(st)
  body = int(np.nonzero(np.asarray(ma.body_mocapid) >= 0)[0][0])
  h = float(types.host(ma.opt.timestep))
  whole = [u for u in range(ma.nu) if int(ma.actuator_history[u, 0]) and
           abs(round(float(ma.actuator_delay[u]) / h) * h -
               float(ma.actuator_delay[u])) < 1e-9 and
           float(ma.actuator_delay[u]) > 0]
  lag = {u: int(round(float(ma.actuator_delay[u]) / h)) for u in whole}
  put_in, xerr, derr, t_drive = [], 0.0, 0.0, 0.0
  zero_counters()
  for k in range(ARM_DRIVE_NSTEP):
    step_ = torch.as_tensor(0.01 * rng.standard_normal((w_a, ma.nmocap, 3)),
                            dtype=torch.float32, device=dev)
    ctrl = torch.as_tensor(rng.uniform(-1.0, 1.0, (w_a, ma.nu)),
                           dtype=torch.float32, device=dev)
    d = d.replace(mocap_pos=d.mocap_pos + step_, ctrl=ctrl)
    # the delayed ctrl the step reads: the ctrl put in lag steps before
    got = ohistory.read_ctrl_delayed(ma, d)
    for u in whole:
      if k >= lag[u]:
        derr = max(derr, float((got[:, u] - put_in[k - lag[u]][:, u])
                               .abs().max()))
    put_in.append(ctrl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = forward.step(ma, d)
    torch.cuda.synchronize()
    t_drive += time.perf_counter() - t0
    xerr = max(xerr, float((d.xpos[:, body] - d.mocap_pos[:, 0]).abs()
                           .max()))
  got = counters()
  want = {k: 0 for k in got}
  want.update(classic_expect(ma)(ARM_DRIVE_NSTEP, osolver.trips))
  if got != want:
    fail(f'mocap_arm driven steps: launch counts {got} != {want}')
  # a linear read whose float32 time lands a rounding past its sample
  # takes the next one's weight ~ 1e-8 / h (the time matching of
  # ``ops/history.py``)
  if xerr > 1e-6 or derr > 1e-5:
    fail(f'mocap_arm driven steps: mocap body off its target by {xerr}, '
         f'delayed ctrl off the ctrl put in by {derr}')
  if not (bool(torch.isfinite(d.qpos).all()) and
          bool(torch.isfinite(d.sensordata).all())) or \
      int(d.overflow.max()) != 0:
    fail('mocap_arm driven steps: not finite or overflowed')
  say(f'[main path] mocap_arm W={w_a}, {ARM_DRIVE_NSTEP} steps of '
      f'forward.step with each world\'s target moved along a seeded path: '
      f'{1e3 * t_drive / ARM_DRIVE_NSTEP:.3f} ms per step, launches {got}; '
      f'the mocap body at its target within {xerr:.2e}; the delayed ctrl '
      f'of actuators {whole} (delays of {[lag[u] for u in whole]} steps) '
      f'within {derr:.2e} of the ctrl put in that many steps before')

  mr, w_r = scene_model('clutter_arm_rk4')
  init = benchmarks.start_state('clutter_arm_rk4')
  woke = parity.woken_state(mr, {k: np.concatenate(
      [v] * -(-w_r // len(v)))[:w_r] for k, v in init.items()},
      np.random.default_rng(18))
  nstep, warmup = RK4S_NSTEP
  packed0 = forward.packed_steps
  st, res = general_scene('clutter_arm_rk4', ARM_SFX['clutter_arm_rk4'],
                          nstep, woke, warmup)
  a0, a1 = woke['tree_asleep'], st.tree_asleep.cpu().numpy()
  say(f"[main path] clutter_arm_rk4 W={w_r}: {res['steps_per_sec']:.1f} "
      f"steps/s, overflow_worlds {res['overflow_worlds']}, converged_worlds "
      f"{res['converged_worlds']}, trees awake {int((a0 < 0).sum())} of "
      f'{a0.size} at the start, {int((a1 < 0).sum())} at the end, '
      f'{int(((a0 < 0) & (a1 >= 0)).sum())} fell asleep; packed steps '
      f'{forward.packed_steps - packed0}')
  idle_share('clutter_arm_rk4', mr, st)
  say(f'[main path] phase 18 took {time.perf_counter() - t18:.1f} s')

  # ---- 19. every per-world field of the JAX batched step: quadruped_dr
  # (morphology, joint, tendon, equality and solver parameters, each
  # world stopping on its own tolerances in the solve kernel)
  say(f'[phase 19] at {time.perf_counter() - T0:.1f} s')
  t19 = time.perf_counter()
  name, sfx = 'quadruped_dr', QDR_SFX
  zero_counters()
  t0 = time.perf_counter()
  mt, w_t = benchmarks.load_scene(name)
  torch.cuda.synchronize()
  t_setup = time.perf_counter() - t0
  got = counters()
  want = {k: 0 for k in got}
  want.update(mass_chain=1, chol_batched=1, chol_solve=mt.nv)
  if got != want:
    fail(f'{name}: set_const launch counts {got} != {want}')
  if not {'opt.tolerance', 'opt.ls_tolerance', 'opt.impratio', 'body_pos',
          'body_quat', 'jnt_range', 'eq_solref'} <= set(mt.batch_fields):
    fail(f'{name}: batched fields {mt.batch_fields}')
  # set_const on the card against its plain version on the CPU, on the
  # first DR_NSC worlds' drawn inputs
  mh0 = io.load_model_npz(benchmarks.SCENES[name][0], device='cpu')
  drawn = {k: types.get_model_field(mt, k)[:DR_NSC].cpu()
           for k in mt.batch_fields if k not in io.SET_CONST_FIELDS}
  mh = io.set_const(io.batch_model(mh0, DR_NSC, drawn))
  worst_sc = {}
  for k in io.SET_CONST_FIELDS:
    b = types.world_field(mh, k)
    if not b.numel():
      continue
    worst_sc[k] = world_rel(types.world_field(mt, k)[:DR_NSC].cpu(), b)
    bar = SC_MINV_RTOL if k in SC_MINV else SC_RTOL
    if worst_sc[k] > bar:
      fail(f'{name}: set_const {k} on the card against the CPU: '
           f'{worst_sc[k]} relative > {bar}')
  say(f'[main path] {name} setup W={w_t}: the draws, batch_model and '
      f'set_const {t_setup:.2f} s, launches {got}; set_const against the '
      f'CPU\'s plain versions on {DR_NSC} worlds, the worst of each '
      f'field\'s world scale (bar {SC_RTOL}, through M^-1 {SC_MINV_RTOL}): '
      + json.dumps({k: float(f'{v:.3e}') for k, v in worst_sc.items()}))

  # the rollout from the quadruped's seeded contact state: OU ctrl noise,
  # worlds sorted every 4 steps with their parameters
  qpos, qvel, _ = parity.dmc_state(mh0, 'quadruped', 64, 0)
  expect = classic_expect(mt)
  nstep, warmup = QDR_NSTEP
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  zero_counters()
  res = benchmarks.run(mt, nworld=w_t, nstep=nstep, warmup_steps=warmup,
                       init_state={'qpos': qpos, 'qvel': qvel})
  launches = counters()
  steps = nstep + warmup
  want = {k: 0 for k in launches}
  want.update(expect(steps, osolver.trips))
  if launches != want:
    fail(f'{name}: launch counts {launches} != {want}')
  if res['overflow_worlds'] != 0:
    fail(f"{name}: overflow in {res['overflow_worlds']} worlds")
  st = res.pop('state')
  if res['converged_worlds'] != w_t or not bool(
      torch.isfinite(st.qpos).all()) or not bool(
          torch.isfinite(st.qvel).all()):
    fail(f"{name}: {res['converged_worlds']} of {w_t} worlds finite")
  for k in expect(1, 1):
    kernel_launches[k + sfx] = launches[k]
  mperm, ids = res.pop('model'), res.pop('world_ids')
  for k in ('opt.tolerance', 'body_pos', 'jnt_range'):
    if not torch.equal(types.get_model_field(mperm, k),
                       types.get_model_field(mt, k)[ids]):
      fail(f'{name}: the sorted Model\'s {k} is not the Data\'s worlds\'')
  ncon = float(st.ncon_active.float().mean())
  q_ncon, q_niter, q_z = act_end['quadruped']
  z = float(st.qpos[:, parity.DMC_ROOT['quadruped']].mean())
  say(f"[main path] {name} W={w_t} x {nstep} steps (+{warmup} warmup) on "
      f"{card}: {res['steps_per_sec']:.1f} steps/s, "
      f"{1e3 * w_t / res['steps_per_sec']:.3f} ms per step, kernels per "
      f"step {sum(launches.values()) / steps:.3f} ({launches}), "
      f"solver_niter_mean {res['solver_niter_mean']:.4f}, live contacts "
      f"per world {ncon:.3f}, trunk height {z:.4f} m (phase 16's "
      f"quadruped at the same depth: {q_niter:.4f}, {q_ncon:.3f}, "
      f"{q_z:.4f} m), overflow_worlds 0, {w_t}/{w_t} finite, peak "
      f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
  if ncon < QDR_MIN_CONTACT_SHARE * q_ncon:
    fail(f'{name}: {ncon:.3f} live contacts per world, below '
         f'{QDR_MIN_CONTACT_SHARE} of the quadruped\'s {q_ncon:.3f}')
  idle_share(name, mperm, st)
  # the kernels against their plain versions on the last state, each
  # world with its own tolerances, and timed
  args, niter = step_compare(f'{name} rollout W={w_t}', types.carried(st),
                             mperm, tuple(expect(1, 1)), sfx,
                             parity.SOLVE_BAR_OF.get(name, 'dmc'))
  tendon_timing(args, niter, sfx)
  asv = args['solve']
  qfrc_witness(name, asv)
  # the profiler's reading of the per-world solve kernel window by
  # window, each beside CUDA events over as many calls
  windows = profile_windows(lambda: ksolver.solve_tiles(*asv),
                            'solve_kernel', QDR_WINDOWS)
  say(f'[timing] solve{sfx}: {QDR_WINDOWS} profiler windows of {NTIME} '
      f'calls, each then CUDA events over {NTIME} calls: '
      + json.dumps(windows))

  def with_tols(tol, ls_tol):
    """mperm with the tolerances ``tol`` and ``ls_tol``: (W,) batched,
    or 0-d shared."""
    mm = types.set_model_fields(mperm, {'opt.tolerance': tol,
                                        'opt.ls_tolerance': ls_tol})
    keep = [n for n in mperm.batch_fields
            if n not in ('opt.tolerance', 'opt.ls_tolerance')]
    return mm.replace(batch_fields=tuple(sorted(
        keep + (['opt.tolerance', 'opt.ls_tolerance'] if tol.dim() else
                []))))

  # stride 0 against stride 1: W copies of the unbatched scalars give the
  # unbatched launch to the bit
  m0 = io.load_model_npz(benchmarks.SCENES[name][0])
  tol0, ls0 = m0.opt.tolerance, m0.opt.ls_tolerance
  shared = ksolver.solve_tiles(with_tols(tol0, ls0), *asv[1:])
  copies = ksolver.solve_tiles(with_tols(tol0.expand(w_t).contiguous(),
                                         ls0.expand(w_t).contiguous()),
                               *asv[1:])
  if not all(torch.equal(a, b) for a, b in zip(shared, copies)):
    fail(f'{name}: the solve kernel at tolerance stride 1 (W copies) '
         'differs from stride 0')
  # a planted fault: world 0's tolerances in every world must move the
  # Newton count, or qacc past parity's bar, in some world
  good = ksolver.solve_tiles(*asv)
  tol_w = types.get_model_field(mperm, 'opt.tolerance')
  ls_w = types.get_model_field(mperm, 'opt.ls_tolerance')
  # each of QDR_OWN worlds equals, to the bit, a launch where every world
  # shares its tolerances
  own = [w * (w_t - 1) // (QDR_OWN - 1) for w in range(QDR_OWN)]
  for w in own:
    one = ksolver.solve_tiles(with_tols(tol_w[w].clone(), ls_w[w].clone()),
                              *asv[1:])
    if not all(torch.equal(a[:, w], b[:, w]) for a, b in zip(one, good)):
      fail(f'{name}: world {w} of the per-world launch differs from a '
           'launch with its tolerances in every world')
  bad = ksolver.solve_tiles(with_tols(tol_w[:1].expand(w_t).contiguous(),
                                      ls_w[:1].expand(w_t).contiguous()),
                            *asv[1:])
  scale = good[0].abs().amax(0)

  def moved(out):
    """Worlds whose Newton count, or qacc past parity's bar, ``out``
    moves from the per-world launch, and those whose qacc it moves at
    all."""
    far = (out[0] - good[0]).abs().amax(0) > parity.QACC_ATOL + \
        parity.QACC_RTOL * scale
    return (int(((good[3][0] != out[3][0]) | far).sum()),
            int((out[0] != good[0]).any(0).sum()))

  n_moved, n_bits = moved(bad)
  if n_moved == 0:
    fail(f'{name}: world 0\'s tolerances in every world move no world')
  # for scale: the loosest world's tolerances in every world
  loose = int(torch.argmax(tol_w))
  n_loose = moved(ksolver.solve_tiles(with_tols(
      tol_w[loose:loose + 1].expand(w_t).contiguous(),
      ls_w[loose:loose + 1].expand(w_t).contiguous()), *asv[1:]))
  # the kernel's time with per-world tolerances beside the shared one on
  # the same system, in turns
  t_pw, t_sh = [], []
  mshared = with_tols(tol0, ls0)
  for _ in range(2):
    t_pw.append(time_ms(lambda: ksolver.solve_tiles(*asv), 10))
    t_sh.append(time_ms(lambda: ksolver.solve_tiles(mshared, *asv[1:]), 10))
  say(f'[compare] {name}: the solve kernel with W copies of the unbatched '
      f'tolerances equals the unbatched launch to the bit, and worlds {own} '
      f'each a launch with its tolerances in every world; world 0\'s '
      f'tolerances in every world move {n_moved} of {w_t} worlds (Newton '
      f'count or qacc past parity\'s bar; qacc at all in {n_bits}), the '
      f'loosest world\'s {n_loose[0]} ({n_loose[1]}); mean niter per-world '
      f'{float(good[3].float().mean()):.4f}, world 0\'s '
      f'{float(bad[3].float().mean()):.4f}; drawn tolerance in '
      f'[{float(tol_w.min()):.3e}, {float(tol_w.max()):.3e}], '
      f'ls_tolerance in [{float(ls_w.min()):.4f}, {float(ls_w.max()):.4f}]')
  say(f'[timing] solve kernel on {name}\'s last state, wall ms per call '
      f'(CUDA events, 10 calls, in turns): per-world tolerances '
      f'{[round(x, 4) for x in t_pw]}, the unbatched scalars '
      f'{[round(x, 4) for x in t_sh]}; its profiler time per launch '
      f'{ms["solve" + sfx]:.4f} ms beside quadruped\'s '
      f'{ms.get("solve_qd", float("nan")):.4f} ms (phase 16, this call)')
  # one step of QDR_NCMP worlds on the card against the CPU's plain step,
  # the CPU Model from the sorted worlds' draws and its own set_const
  sub = {k: getattr(st, k)[:QDR_NCMP] for k in types.CARRY}
  msub = types.map_model_worlds(mperm, lambda x: x[:QDR_NCMP])
  mcpu = io.set_const(io.batch_model(mh0, QDR_NCMP, {
      k: types.get_model_field(msub, k).cpu() for k in msub.batch_fields
      if k not in io.SET_CONST_FIELDS}))
  on_card = forward.step(msub, types.Data(**sub))
  on_cpu = forward.step(mcpu, types.Data(**{k: v.cpu()
                                            for k, v in sub.items()}))
  try:
    e_cpu = parity.check_world_scale(on_card.qpos.cpu().T, on_cpu.qpos.T,
                                     'qpos', parity.QPOS_ATOL,
                                     parity.QPOS_RTOL)
  except AssertionError as e:
    fail(f'{name}: one step on the card against the CPU: {e}')
  # worlds keep their parameters: sorted against unsorted, the order
  # undone
  d0 = types.carried(st)
  runs = {}
  for sort in (True, False):
    mw, d, idw = mperm, d0, torch.arange(w_t, device=dev)
    for i in range(QDR_KEEP_NSTEP):
      if sort and i % 2 == 0:
        perm = torch.argsort(d.solver_niter, stable=True)
        if i == 0:  # a permutation every world feels
          perm = torch.flip(perm, (0,))
        d = types.map_worlds(d, lambda x: x[perm], w_t)
        mw = types.map_model_worlds(mw, lambda x: x[perm])
        idw = idw[perm]
      d = forward.step(mw, d)
    runs[sort] = d.qpos[torch.argsort(idw)]
  try:
    e_keep = parity.check_world_scale(runs[True].cpu().T, runs[False].cpu().T,
                                      'qpos (sorted against unsorted)',
                                      parity.QPOS_ATOL, parity.QPOS_RTOL)
  except AssertionError as e:
    fail(f'{name}: {e}')
  say(f'[compare] {name}: one step of {QDR_NCMP} worlds against the CPU, '
      f'qpos max abs err {e_cpu:.3e}; {QDR_KEEP_NSTEP} steps sorted (the '
      f'worlds reversed, then by Newton count) against unsorted, order '
      f'undone: qpos max abs err {e_keep:.3e} (bar atol '
      f'{parity.QPOS_ATOL} + rtol {parity.QPOS_RTOL})')
  # the elliptic form on stack_2 at QDR_ELL_NWORLD worlds, QDR_ELL_NSTEP
  # steps from its seeded contact state, each world with its own impratio
  # and tolerances (at the start state itself, warmstarted from zero, the
  # two sides' Newton counts agree at the bar's edge even unbatched)
  ms2_0, _ = benchmarks.load_scene('stack_2')
  rng = np.random.default_rng(19)
  W2 = QDR_ELL_NWORLD
  ms2 = io.batch_model(ms2_0, W2, {
      'opt.impratio': rng.uniform(1.0, 4.0, (W2,)),
      'opt.tolerance': 10.0 ** rng.uniform(-6.0, -4.0, (W2,)),
      'opt.ls_tolerance': rng.uniform(0.005, 0.05, (W2,))})
  d2 = benchmarks.build(ms2, W2, init_state=benchmarks.start_state('stack_2'))
  # at the start state itself, for scale: the share of equal Newton
  # counts, unbatched and per world (printed, not held)
  starts = {}
  for label, mm in (('unbatched', ms2_0), ('per-world', ms2)):
    a0 = parity.solve_args(mm, benchmarks.build(
        mm, W2, init_state=benchmarks.start_state('stack_2')))[0]
    g0, p0 = ksolver.solve_tiles(*a0), solver_ref.solve_tiles(*a0)
    starts[label] = (round(float((g0[3] == p0[3]).float().mean()), 4),
                     int((g0[3] - p0[3]).abs().max()))
  for _ in range(QDR_ELL_NSTEP):
    d2 = forward.step(ms2, d2)
  args2, niter2 = step_compare(f'stack_2 per-world impratio and tolerances '
                               f'W={W2}', types.carried(d2), ms2,
                               ('mass_chain', 'chol_solve', 'solve'),
                               None)
  if args2['solve'][-1] is None:
    fail('stack_2: the elliptic form did not run')
  say(f'[compare] stack_2 W={W2}, {QDR_ELL_NSTEP} steps from its start '
      f'state, each world with its own impratio, tolerance and '
      f'ls_tolerance: the elliptic solve kernel against its plain version at '
      f'parity\'s \'elliptic\' bar, plain niter mean {niter2:.3f}; at '
      f'the start state, (share of equal Newton counts, largest gap): '
      f'{starts}')
  say(f'[main path] phase 19 took {time.perf_counter() - t19:.1f} s')

  say(f'[phase end] at {time.perf_counter() - T0:.1f} s')
  src = 'mujoco_warp_tpu_torch/kernels/csrc/'
  replaces = {
      'k1': ('k1.cu', 'mujoco_warp_tpu/pallas/fused.py:986'),
      'k4': ('k4.cu', 'mujoco_warp_tpu/pallas/fused.py:1247'),
      'mass_chain': ('mass_chain.cu', 'mujoco_warp_tpu/pallas/smooth.py:211'),
      'mass_chain_big': ('mass_chain.cu',
                         'mujoco_warp_tpu/pallas/smooth.py:211'),
      'mass_chain_n36': ('mass_chain.cu',
                         'mujoco_warp_tpu/pallas/smooth.py:211'),
      'solve': ('solve.cu', 'mujoco_warp_tpu/pallas/solver.py:1041'),
      'chol_batched': ('linalg.cu', 'mujoco_warp_tpu/pallas/linalg.py:65'),
      'chol_solve': ('linalg.cu', 'mujoco_warp_tpu/pallas/linalg.py:109'),
      'chol_solve_n36': ('linalg.cu', 'mujoco_warp_tpu/pallas/linalg.py:109'),
      'chol_solve_n75': ('linalg.cu', 'mujoco_warp_tpu/pallas/linalg.py:109'),
      'damped_solve': ('linalg.cu', 'mujoco_warp_tpu/pallas/linalg.py:145'),
      'damped_solve_n75': ('linalg.cu',
                           'mujoco_warp_tpu/pallas/linalg.py:145'),
      'solve_spheres': ('solve.cu', 'mujoco_warp_tpu/pallas/solver.py:1041'),
      'solve_elliptic': ('solve.cu',
                         'mujoco_warp_tpu/pallas/solver.py:1041'),
  }
  for sfx in ('_walker', '_cheetah', '_hopper', '_dmc'):
    replaces['k1' + sfx], replaces['k4' + sfx] = replaces['k1'], replaces['k4']
  for sfx in ('_hopper', '_dmc'):
    for k in ('mass_chain', 'chol_solve', 'solve', 'damped_solve'):
      replaces[k + sfx] = replaces[k]
  for k in ('mass_chain_big', 'chol_batched', 'chol_solve_n75',
            'damped_solve_n75'):
    replaces[k + '_ca'] = replaces[k]
  for k in ('chol_solve_n36', 'mass_chain_n36'):
    replaces[k + '_cg'] = replaces[k]
  for k in ('k1', 'k4'):
    replaces[k + '_implicitfast'] = replaces[k]
  for sfx in (*TEN_SFX.values(), *CLS_SFX.values(), *TASK_SFX.values(),
              '_dr', '_sc', *ACT_SFX.values(), *FLU_SFX.values(),
              *ARM_SFX.values(), QDR_SFX):
    for k in ('mass_chain', 'chol_batched', 'chol_solve', 'solve',
              'damped_solve'):
      if k + sfx in kernel_launches:
        replaces[k + sfx] = replaces[k]
  print(json.dumps({'kernels': [
      {'name': k, 'route': 'cuda', 'source': src + f, 'replaces': r,
       'launches': kernel_launches[k], 'max_abs_err': err[k], 'ms': ms[k],
       'ms_source': ms_src[k][0], 'launches_seen': ms_src[k][1],
       'plain_ms': plain_ms[k], 'bound_ms': bounds[k][0],
       'bound_by': bounds[k][1], 'library_ms': library_ms[k],
       **shapes.get(k, {})}
      for k, (f, r) in replaces.items()]}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
