"""upgpt_torch — the PyTorch/CUDA port of upgpt_tpu for one NVIDIA H100.

Module names mirror `upgpt_tpu`. Public functions keep the JAX package's
layouts (NHWC images, (B, T, C) tokens, (B, H, T, D) attention inputs) so
each function can be held against its JAX counterpart. The two Pallas
kernels on the sampling path are hand-written CUDA under `csrc/`, built with
nvcc at first use (`ops/_build.py`); on CPU tensors every kernel wrapper runs
its plain PyTorch version instead.

This package imports torch and numpy, never jax, flax or upgpt_tpu.
"""

__version__ = "0.1.0"

from upgpt_torch.diffusion.schedule import (  # noqa: F401
    DDIMSchedule,
    DiffusionSchedule,
    make_beta_schedule,
    make_ddim_schedule,
)
