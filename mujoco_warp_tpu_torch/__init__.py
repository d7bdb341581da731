"""PyTorch + CUDA port of mujoco_warp_tpu for one NVIDIA H100.

This package holds the first slice of the port: the fused lanes-last
humanoid step (K1 -> glue -> K4 of ``mujoco_warp_tpu/pallas/fused.py``),
with K1 and K4 as hand-written CUDA kernels (``kernels/csrc``) and their
plain PyTorch versions for CPU tensors.  It imports ``torch`` and never
``jax``.  Entry points: ``io.put_model`` / ``io.load_model_npz``,
``io.make_data``, ``fused.step_lane``, ``benchmarks.run`` and
``python -m mujoco_warp_tpu_torch.bench``.
"""
