"""The port's device rule: entry points run on the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for (the
    default everywhere) and none is available, instead of running on the
    CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); the port runs on the GPU by default, pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return device


def configure_cuda_numerics(device: torch.device, unet_config) -> None:
    """On a CUDA device: refuse a flash-routed UNet that is not bf16 (the
    kernels take bf16 only) and turn TF32 off, so that fp32 convolutions
    and matmuls run in full fp32 (cuDNN's default is TF32) and an fp32 model
    computes what the JAX one does.  The bf16 paths do not depend on it."""
    if device.type != "cuda":
        return
    if unet_config.use_flash_attention and unet_config.dtype != torch.bfloat16:
        raise ValueError("the CUDA flash kernels take bf16; set "
                         "UNetConfig(dtype=torch.bfloat16) (--mixed_precision "
                         "bf16) or turn use_flash_attention off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
