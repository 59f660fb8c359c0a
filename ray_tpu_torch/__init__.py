"""PyTorch/CUDA port of ray_tpu's model stack, for the NVIDIA H100.

The JAX package `ray_tpu` is the reference; this package imports nothing
of it and never imports `jax`. What runs today: GPT-2 inference —
scoring (`models.gpt2.gpt2_forward` / `gpt2_loss`) through two
hand-written Hopper kernels (`csrc/flash_fwd.cu`, `csrc/ce_fwd.cu`,
bound in `kernels.py`), and greedy continuous-batching serving
(`models.engine.ContinuousBatchingEngine`) — and GPT-2 training
(`train.step.TrainStep` + `train.optim.adamw`), whose backward runs
four more kernels (`csrc/flash_bwd.cu`, `csrc/ce_bwd.cu`).

Entry points take `device=` and default to "cuda": they raise when CUDA
is unavailable and the caller did not ask for the CPU. On a CPU tensor
each kernel's wrapper runs its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
