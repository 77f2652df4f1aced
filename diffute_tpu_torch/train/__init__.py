from diffute_tpu_torch.train.optim import AdamW, build_lr_schedule, build_optimizer
from diffute_tpu_torch.train.state import TrainState
from diffute_tpu_torch.train.unet_train import TrainDraws, UNetTrainer

__all__ = ["AdamW", "TrainDraws", "TrainState", "UNetTrainer",
           "build_lr_schedule", "build_optimizer"]
