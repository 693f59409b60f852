from paddle_tpu_torch.trainer.trainer import Trainer

__all__ = ["Trainer"]
