"""Typed configuration tree of the PyTorch port.

Counterpart of ``diffute_tpu/config.py``: the same frozen dataclasses, field
names and defaults (SD2-inpainting UNet/VAE, TrOCR-large encoder, SD2 noise
schedule), with torch dtypes.  ``TrainConfig`` leaves out the JAX package's
TPU-relay fields (``donate_state``, ``steps_per_call``) and its mesh fields
(``dp_size``, ``shard_optimizer_states``): the port trains on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture (SD2 VAE defaults)."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # Route the mid-block's single-head attention (head_dim 512 at SD2
    # width, 4096 to 16384 tokens; 256 at small_config, 4096 tokens) through
    # the CUDA flash kernels (bf16: csrc/flash_wide.cu at 512,
    # csrc/flash_d256_sm90.cu and flash_d256_bwd_sm90.cu at 256; fp32:
    # csrc/flash_fp32_d512_sm90.cu and flash_fp32_d512_bwd_sm90.cu at 512,
    # csrc/flash_fp32_d256_sm90.cu and flash_fp32_d256_bwd_sm90.cu at 256).
    use_flash_attention: bool = False

    @property
    def scale_factor(self) -> int:
        """Spatial downsampling factor, 2**(n_blocks-1) = 8."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel architecture (SD2-inpainting defaults).
    ``num_attention_heads`` per resolution; head size is 64 everywhere."""

    sample_size: int = 64
    in_channels: int = 9
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    use_linear_projection: bool = True
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    dtype: torch.dtype = torch.float32
    # Route self-attention with >= 1024 keys through the CUDA flash kernels
    # (csrc/flash_fwd.cu, csrc/flash_bwd.cu on bf16, csrc/flash_fp32.cu and
    # csrc/flash_fp32_d64_bwd_sm90.cu on fp32).
    use_flash_attention: bool = False
    # GroupNorm+SiLU as one kernel (csrc/groupnorm.cu) in conv_norm_out and,
    # without use_fused_conv, in the resnets.
    use_fused_groupnorm: bool = False
    # Serve the transformers' linear weights int8 with per-feature scales
    # (csrc/quant.cu); a float state_dict is quantised at load.
    use_int8_weights: bool = False
    # Every resnet half as one GroupNorm+SiLU+conv3x3 kernel
    # (csrc/conv_fused.cu on bf16, csrc/conv_fused_fp32.cu on fp32): the
    # normalised tensor never reaches device memory.
    use_fused_conv: bool = False
    # Recompute each resnet and transformer block in the backward instead of
    # keeping its activations (gradient checkpointing).
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class TrOCRConfig:
    """ViT-large encoder of microsoft/trocr-large-printed -> (B, 577, 1024)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    dtype: torch.dtype = torch.float32
    # as in the JAX package: the flag reaches the attention gate, which sends
    # the ViT's 577 (197) keys to dense attention (FLASH_MIN_KV is 1024)
    use_flash_attention: bool = False

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1  # 577


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Noise schedule (SD2-inpainting ``scheduler/`` values)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # {linear, scaled_linear, squaredcos_cap_v2}
    prediction_type: str = "epsilon"  # {epsilon, v_prediction}
    clip_sample: bool = False
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    variance_type: str = "fixed_small"


@dataclasses.dataclass(frozen=True)
class GlyphConfig:
    """Glyph rendering constants (reference draw_text)."""

    font_size: int = 40
    canvas_height: int = 60
    text_pos: Tuple[int, int] = (40, 10)
    empty_text_len: int = 3
    font_path: Optional[str] = None  # None -> search FALLBACK_FONTS


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """Inference pipeline configuration: sampler ``ddim`` | ``ddpm`` |
    ``dpmpp``; ``guidance_scale > 1`` turns classifier-free guidance on;
    ``encoder_reuse_interval = k`` runs the UNet's encoder every k-th step."""

    resolution: int = 512
    num_inference_steps: int = 50
    sampler: str = "ddim"
    guidance_scale: float = 1.0
    masked_latent_blend: bool = False
    encoder_reuse_interval: int = 1
    seed: int = 0
    train_crop_scale: int = 256
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer + LR schedule (reference AdamW: betas (0.9, 0.999), weight
    decay 1e-2, eps 1e-8, lr 1e-4; diffusers' ``get_scheduler`` family)."""

    name: str = "adamw"  # {adamw}; adafactor and adamw8bit are not ported yet
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_scheduler: str = "constant"  # {constant, constant_with_warmup, linear, cosine, cosine_with_restarts, polynomial}
    lr_warmup_steps: int = 500
    lr_num_cycles: int = 1  # hard restarts of cosine_with_restarts
    scale_lr: bool = False
    low_memory_adam: bool = False  # first moment stored in bf16


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (stage 2, the UNet; one card)."""

    train_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    num_train_epochs: int = 100
    max_train_steps: Optional[int] = None
    mixed_precision: str = "no"  # {no, bf16}
    gradient_checkpointing: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    checkpointing_steps: int = 1000
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None  # path or "latest"
    seed: int = 0
    output_dir: str = "diffute-output"
    logging_dir: str = "logs"
    report_to: str = "tensorboard"
    noise_offset: float = 0.0
    prediction_type: Optional[str] = None  # override scheduler's, like the flag
    ocr_score_threshold: float = 0.8
    dataloader_num_workers: int = 0
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


@dataclasses.dataclass(frozen=True)
class DiffUTEConfig:
    """Top-level bundle used by the pipeline and the trainer."""

    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    trocr: TrOCRConfig = dataclasses.field(default_factory=TrOCRConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    glyph: GlyphConfig = dataclasses.field(default_factory=GlyphConfig)
    edit: EditConfig = dataclasses.field(default_factory=EditConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def small_config() -> DiffUTEConfig:
    """The reduced-width SD2 topology of ``diffute_tpu.config.small_config``
    (256^2 pixels, 4x VAE, 64^2 latents)."""
    return DiffUTEConfig(
        vae=VAEConfig(block_out_channels=(64, 128, 256),
                      layers_per_block=2, norm_num_groups=32,
                      sample_size=256, latent_channels=4),
        unet=UNetConfig(sample_size=64, block_out_channels=(128, 256, 512),
                        layers_per_block=2,
                        down_block_has_attn=(True, True, False),
                        up_block_has_attn=(False, True, True),
                        num_attention_heads=(2, 4, 8),
                        cross_attention_dim=256, norm_num_groups=32),
        trocr=TrOCRConfig(hidden_size=256, num_hidden_layers=4,
                          num_attention_heads=4, intermediate_size=1024,
                          image_size=224, patch_size=16),
        edit=EditConfig(resolution=256, train_crop_scale=256),
        train=TrainConfig(train_batch_size=16),
    )


def tiny_test_config() -> DiffUTEConfig:
    """A miniature config for CPU unit tests (all dims shrunk, same topology)."""
    return DiffUTEConfig(
        vae=VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                      norm_num_groups=4, sample_size=32, latent_channels=4),
        unet=UNetConfig(sample_size=8, block_out_channels=(16, 32),
                        layers_per_block=1, down_block_has_attn=(True, False),
                        up_block_has_attn=(False, True),
                        num_attention_heads=(2, 4), cross_attention_dim=16,
                        norm_num_groups=4),
        trocr=TrOCRConfig(hidden_size=16, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=32,
                          image_size=32, patch_size=16),
        edit=EditConfig(resolution=32, num_inference_steps=5),
        train=TrainConfig(train_batch_size=2),
    )


def card_serving_config(config: DiffUTEConfig) -> DiffUTEConfig:
    """``config`` as the serving entry points run it on a card: the three
    models in bf16 and the UNet's self-attention through the flash kernel."""
    bf16 = torch.bfloat16
    return dataclasses.replace(
        config,
        vae=dataclasses.replace(config.vae, dtype=bf16),
        unet=dataclasses.replace(config.unet, dtype=bf16,
                                 use_flash_attention=True),
        trocr=dataclasses.replace(config.trocr, dtype=bf16))
