"""Layer library of the port. Importing this package registers every
layer type of the JAX package's library."""

from paddle_tpu_torch.layers.base import LayerContext, forward_layer, layer_registry, register_layer
import paddle_tpu_torch.layers.core  # noqa: F401
import paddle_tpu_torch.layers.sequence  # noqa: F401
import paddle_tpu_torch.layers.recurrent  # noqa: F401
import paddle_tpu_torch.layers.misc  # noqa: F401
import paddle_tpu_torch.layers.cost  # noqa: F401
import paddle_tpu_torch.layers.vision  # noqa: F401
import paddle_tpu_torch.layers.structured  # noqa: F401
import paddle_tpu_torch.layers.attention  # noqa: F401

__all__ = ["LayerContext", "layer_registry", "register_layer", "forward_layer"]
