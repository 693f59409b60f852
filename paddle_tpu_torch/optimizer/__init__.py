from paddle_tpu_torch.optimizer.schedules import learning_rate_at
from paddle_tpu_torch.optimizer.updater import Updater, UpdaterState

__all__ = ["Updater", "UpdaterState", "learning_rate_at"]
