"""``paddle.trainer.PyDataProvider2`` for providers loaded by the port: the
``@provider`` contract and the slot types of ``paddle_tpu_torch.data``."""
from paddle_tpu_torch.data.provider import *  # noqa: F401,F403
from paddle_tpu_torch.data.provider import __all__  # noqa: F401
