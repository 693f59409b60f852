from paddle_tpu_torch.utils.registry import Registry
from paddle_tpu_torch.utils.logging import logger

__all__ = ["Registry", "logger"]
