"""risc0_tpu_torch: the rv32im segment prover on PyTorch and CUDA.

A port of ``risc0_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  Its
module paths mirror the reference's, e.g. ``hal/torch_hal.py`` for
``hal/jnp_hal.py``; every Pallas kernel of the reference is a CUDA kernel
here (``csrc/``, bound in ``hal/cuda/``) with a plain torch version beside
it.  Field words are int32 tensors holding canonical Montgomery words.
This package never imports jax.
"""
