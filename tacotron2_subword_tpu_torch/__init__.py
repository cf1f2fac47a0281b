"""PyTorch/CUDA port of tacotron2_subword_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports none of it.
"""
