"""micromix_tpu_torch: the PyTorch and CUDA port of ``micromix_tpu``.

Serves a quantized dense Llama or a Mixtral, weights in the ScaledW8 or
the split-plane layout (prefill + paged int4-KV decode, the JAX engine's
request surface), and calibrates a dense Llama (stats, allocation,
smoothing, perplexity), on one NVIDIA H100, holding the JAX package's
numerics; ``parallel/`` serves over tensor- or expert-parallel ranks,
one process a rank over ``torch.distributed``.  Module names follow the JAX package (``mx``, ``ops``,
``kernels``, ``models``, ``serve``, ``calib``, ``eval``).  Every TPU kernel of this path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` on first use; on CPU tensors each
wrapper runs its plain PyTorch version instead.

This package imports neither ``jax`` nor ``micromix_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
