from diffute_tpu_torch.train.ocr_train import OCRTrainer
from diffute_tpu_torch.train.optim import AdamW, build_lr_schedule, build_optimizer
from diffute_tpu_torch.train.state import Trainer, TrainState
from diffute_tpu_torch.train.unet_train import TrainDraws, UNetTrainer
from diffute_tpu_torch.train.vae_train import VAETrainer

__all__ = ["AdamW", "OCRTrainer", "TrainDraws", "TrainState", "Trainer",
           "UNetTrainer", "VAETrainer", "build_lr_schedule", "build_optimizer"]
