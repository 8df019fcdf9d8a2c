"""PyTorch/CUDA port of vings_mono_tpu for NVIDIA Hopper (H100).

Module paths and names follow the JAX package, so each module here has a
counterpart of the same name there. The rasterizer's tile kernels are
hand-written CUDA (`csrc/`); every other op is plain PyTorch. Entry points
run on `cuda` unless the caller asks for `device="cpu"`.
"""
