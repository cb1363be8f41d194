"""PyTorch/CUDA port of the DICE diffusion-MoE serving stack.

Mirrors the module layout of the JAX package ``repro`` so every module
here has a counterpart of the same path.  Plain tensor code is PyTorch;
the four functions the JAX package wrote as Pallas TPU kernels
(``expert_ffn``, ``flash_attention`` and ``residual_int8`` on the DiT-MoE
serving path, ``rwkv6_scan`` on the RWKV-6 LM's) are hand-written CUDA
kernels for Hopper under ``csrc/``, built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no card present they raise.
"""
