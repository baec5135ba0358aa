"""PyTorch/CUDA port of ssl_audio_tpu for NVIDIA Hopper (H100).

The JAX package `ssl_audio_tpu` stays the reference; this package imports
torch and never jax, and nothing of `ssl_audio_tpu`.  Subpackages mirror the
JAX ones: `ops` (log-mel frontend, fused conv block forward and backward,
the nvcc build of the kernels), `models` (AudioNTT2022, heads), `objectives`,
`augment`, `train` (optimizers, state, step, loop), `data` (datasets, the
C++ batch readers, the loader), `hear` (the HEAR 2021 serving API and the
results aggregation), `eval`, `tools` and `utils`; `main` is the pretraining
entry point, `main_bt_byol` the BYOL-style one, `linear` the probe of a
checkpoint and `tools.reproduce` the whole chain.  Kernel sources live in
`csrc/` and are built with nvcc on first use (`ops/_build.py`), beside the
C++ readers' sources, built with g++ (`data/native_loader.py`).

Entry points run on "cuda" unless the caller passes device="cpu"; with no
card and no explicit CPU request they raise.
"""
