"""Layer library of the port. Importing this package registers every
layer type of the ported slices (the seqToseq serve and train graphs, the
LSTM text classifier, ResNet and the long-context LM)."""

from paddle_tpu_torch.layers.base import LayerContext, forward_layer, layer_registry, register_layer
import paddle_tpu_torch.layers.core  # noqa: F401
import paddle_tpu_torch.layers.sequence  # noqa: F401
import paddle_tpu_torch.layers.recurrent  # noqa: F401
import paddle_tpu_torch.layers.misc  # noqa: F401
import paddle_tpu_torch.layers.cost  # noqa: F401
import paddle_tpu_torch.layers.vision  # noqa: F401
import paddle_tpu_torch.layers.attention  # noqa: F401

__all__ = ["LayerContext", "layer_registry", "register_layer", "forward_layer"]
