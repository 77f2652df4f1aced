"""diffute_tpu_torch: the PyTorch / CUDA port of diffute_tpu for NVIDIA Hopper.

Module paths and names mirror ``diffute_tpu`` (the JAX reference, which
stays beside it); this package imports torch, numpy and Pillow, never jax.

- ``diffute_tpu_torch.config``     dataclass configs with torch dtypes
- ``diffute_tpu_torch.ops``        attention dispatch, the CUDA flash-attention
                                   forward and backward (``csrc/flash_fwd.cu``,
                                   ``csrc/flash_bwd.cu``) behind one autograd
                                   function, their plain versions, nearest resize
- ``diffute_tpu_torch.models``     AutoencoderKL, UNet2DCondition (9ch), TrOCR
                                   ViT encoder, with diffusers / HF names
- ``diffute_tpu_torch.diffusion``  noise schedule tables, training targets, the
                                   DDIM, DDPM and DPM-Solver++ steps
- ``diffute_tpu_torch.text``       glyph raster and TrOCR preprocessing
- ``diffute_tpu_torch.pipeline``   crop/mask policies and the edit pipeline
- ``diffute_tpu_torch.io``         host image ops, the synthetic dataset, the
                                   prefetching loader
- ``diffute_tpu_torch.train``      stage-2 UNet trainer, optimizer, ``run_unet``
- ``diffute_tpu_torch.compat``     JAX param tree -> state_dict bridge
"""

__version__ = "0.1.0"
