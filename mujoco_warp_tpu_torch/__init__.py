"""PyTorch + CUDA port of mujoco_warp_tpu for one NVIDIA H100.

Two paths, picked by ``benchmarks.run`` as the JAX harness picks them:
the fused lanes-last step (K1 -> glue -> K4 of
``mujoco_warp_tpu/pallas/fused.py``) for models inside ``fused.supported``,
and the general stage-split step (``ops/forward.py``) for the others that
``ops/forward.unsupported`` accepts.  Every Pallas kernel of the JAX
package has a hand-written CUDA counterpart (``kernels/csrc``) beside its
plain PyTorch version, which runs for CPU tensors.  It imports ``torch``
and never ``jax``.  Entry points: ``io.put_model`` / ``io.load_model_npz``,
``io.make_data``, ``fused.step_lane``, ``ops.forward.step``,
``benchmarks.run`` and ``python -m mujoco_warp_tpu_torch.bench``.
"""
