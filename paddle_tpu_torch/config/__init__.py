from paddle_tpu_torch.config.builder import ConfigContext, current_context
from paddle_tpu_torch.config.config_parser import (
    parse_config,
    parse_config_and_serialize,
    parse_config_at,
)

__all__ = ["ConfigContext", "current_context", "parse_config", "parse_config_and_serialize", "parse_config_at"]
