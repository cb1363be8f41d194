"""PyTorch/CUDA port of the DICE diffusion-MoE serving stack.

Mirrors the module layout of the JAX package ``repro`` so every module
here has a counterpart of the same path.  Plain tensor code is PyTorch;
the three functions the JAX package wrote as Pallas TPU kernels on the
serving path (``expert_ffn``, ``flash_attention``, ``residual_int8``) are
hand-written CUDA kernels for Hopper under ``csrc/``, built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no card present they raise.
"""
