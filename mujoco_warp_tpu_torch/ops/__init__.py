"""The general stage-split step and its stages, world-major.

Counterparts of ``mujoco_warp_tpu/ops/``: every function takes the
port's Model and a world-major ``types.Data`` (a leading ``nworld`` axis
on every field, as the JAX functions see under ``vmap``) and returns the
updated Data.
"""
