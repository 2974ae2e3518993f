"""medical_tri_modal_pilot_tpu_torch — the PyTorch/CUDA port of
``medical_tri_modal_pilot_tpu`` for NVIDIA Hopper (H100).

Module paths mirror the JAX package, so each counterpart is found by name.
The port imports torch, never jax and nothing of the JAX package: it keeps
its own copies of the numpy-only host modules (``config``, ``constants``,
``train.metrics``). Hand-written kernels live in ``kernels/`` (Triton) and
``csrc/`` (CUDA C++), each beside a plain PyTorch version of the same
function; ``ops`` picks one by device.

The port covers the eval and train steps of ``tri_mbt_vsltcls`` on
vslt+txt inputs and on vslt+img+txt inputs with the frozen Swin-T trunk
(eval with one or up to three images per sample), the optimizers, LR
schedules and checkpoints.
"""
