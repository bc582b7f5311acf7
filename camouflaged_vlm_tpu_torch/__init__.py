"""camouflaged_vlm_tpu_torch — the PyTorch/CUDA port of camouflaged_vlm_tpu.

The OVCOS cascade (prompt-tuned SAM ViT-H + MaPLe Alpha-CLIP ViT-L/14@336)
for one NVIDIA H100: plain PyTorch around hand-written CUDA kernels for
Hopper (`csrc/`), which replace the JAX package's Pallas kernels. The JAX
package `camouflaged_vlm_tpu` stays the reference the port is tested
against; this package imports torch and never jax.
"""

__version__ = "0.1.0"
