"""PyTorch/CUDA port of ssl_audio_tpu for NVIDIA Hopper (H100).

The JAX package `ssl_audio_tpu` stays the reference; this package imports
torch and never jax, and nothing of `ssl_audio_tpu`.  Subpackages mirror the
JAX ones: `ops` (log-mel frontend, fused conv block, the CUDA kernel
builder), `models` (AudioNTT2022), `hear` (the HEAR 2021 serving API) and
`utils` (weight conversion).  Kernel sources live in `csrc/` and are built
with nvcc on first use (`ops/_build.py`).

Entry points run on "cuda" unless the caller passes device="cpu"; with no
card and no explicit CPU request they raise.
"""
