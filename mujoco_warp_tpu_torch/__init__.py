"""PyTorch + CUDA port of mujoco_warp_tpu for one NVIDIA H100.

Two paths, picked by ``benchmarks.run`` as the JAX harness picks them:
the fused lanes-last step (K1 -> glue -> K4 of
``mujoco_warp_tpu/pallas/fused.py``) for models inside ``fused.supported``,
and the general stage-split step (``ops/forward.py``) for the others that
``ops/forward.unsupported`` accepts.  Every Pallas kernel of the JAX
package has a hand-written CUDA counterpart (``kernels/csrc``) beside its
plain PyTorch version, which runs for CPU tensors.  It imports ``torch``
and never ``jax``.  Entry points: ``io.put_model`` / ``io.load_model_npz``
(float32, or float64 with ``dtype=torch.float64``), ``io.make_data``, the
public Data API ``io.put_data`` (an ``MjData`` state into batched Data),
``io.get_data_into`` (one world back into an ``MjData``),
``io.reset_data`` (all worlds, or a mask of them) and
``io.override_model`` (``opt.*`` overrides, the contact override's
``o_*`` among them), ``fused.step_lane``, ``ops.forward.step``,
``benchmarks.run`` and ``python -m mujoco_warp_tpu_torch.bench``.  A
float64 Model runs the general step on the CPU, through the plain
versions of the kernels; the fused step and the CUDA kernels take
float32 only.
"""
