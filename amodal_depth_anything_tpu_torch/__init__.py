"""PyTorch/CUDA port of amodal_depth_anything_tpu for NVIDIA Hopper.

The JAX package stays the reference. This package imports torch and
nothing of JAX or of the JAX package; module names mirror the JAX
package's. Entry points run on "cuda" unless the caller passes
device="cpu".
"""
