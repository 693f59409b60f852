"""User-facing config DSL — `from paddle_tpu_torch.trainer_config_helpers import *`.

API-compatible with the reference package
(/root/reference/python/paddle/trainer_config_helpers/__init__.py).
"""

from paddle_tpu_torch.trainer_config_helpers.activations import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.attrs import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.poolings import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.layers import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.networks import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.optimizers import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.evaluators import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.data_sources import *  # noqa: F401,F403
from paddle_tpu_torch.config.config_parser import get_config_arg  # noqa: F401
from os.path import join as join_path  # noqa: F401  (reference utils.py export)
