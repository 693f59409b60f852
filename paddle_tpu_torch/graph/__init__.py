from paddle_tpu_torch.graph.argument import Argument, make_seq
from paddle_tpu_torch.graph.network import Network
from paddle_tpu_torch.graph.machine import GradientMachine
import paddle_tpu_torch.layers  # noqa: F401  (registers the layer types)

__all__ = ["Argument", "make_seq", "Network", "GradientMachine"]
