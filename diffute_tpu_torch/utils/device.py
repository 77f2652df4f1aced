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


def configure_cuda_numerics(device: torch.device, *flash_configs) -> None:
    """On a CUDA device: refuse a flash-routed model (each of
    ``flash_configs``, a ``UNetConfig`` or ``VAEConfig`` that is run) whose
    dtype no flash kernel takes (the kernels take bf16 and fp32), and turn
    TF32 off, so that fp32 convolutions and matmuls run in full fp32
    (cuDNN's default is TF32) and an fp32 model computes what the JAX one
    does; the fp32 flash kernels are accurate to fp32 too (3xTF32 products,
    csrc/flash_fp32.cu).  The bf16 paths do not depend on it."""
    if device.type != "cuda":
        return
    from diffute_tpu_torch.ops.flash_attention import KERNEL_DTYPES

    for cfg in flash_configs:
        if cfg.use_flash_attention and cfg.dtype not in KERNEL_DTYPES:
            name = type(cfg).__name__
            raise ValueError(f"the CUDA flash kernels take bf16 or fp32; "
                             f"{name}.dtype is {cfg.dtype}: set another "
                             f"dtype or turn use_flash_attention off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
