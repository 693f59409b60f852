"""Activation objects for the DSL.

API-compatible with /root/reference/python/paddle/trainer_config_helpers/
activations.py — each maps to a registered activation name in
paddle_tpu_torch.ops.activations.
"""

__all__ = [
    "BaseActivation",
    "TanhActivation",
    "SigmoidActivation",
    "SoftmaxActivation",
    "SequenceSoftmaxActivation",
    "IdentityActivation",
    "LinearActivation",
    "ReluActivation",
    "BReluActivation",
    "SoftReluActivation",
    "STanhActivation",
    "AbsActivation",
    "SquareActivation",
    "ExpActivation",
]


class BaseActivation:
    name = ""

    def __init__(self):
        pass

    def __repr__(self):
        return f"{type(self).__name__}()"


def _make(cls_name: str, act_name: str):
    cls = type(cls_name, (BaseActivation,), {"name": act_name})
    return cls


TanhActivation = _make("TanhActivation", "tanh")
SigmoidActivation = _make("SigmoidActivation", "sigmoid")
SoftmaxActivation = _make("SoftmaxActivation", "softmax")
SequenceSoftmaxActivation = _make("SequenceSoftmaxActivation", "sequence_softmax")
IdentityActivation = _make("IdentityActivation", "")
LinearActivation = IdentityActivation
ReluActivation = _make("ReluActivation", "relu")
BReluActivation = _make("BReluActivation", "brelu")
SoftReluActivation = _make("SoftReluActivation", "softrelu")
STanhActivation = _make("STanhActivation", "stanh")
AbsActivation = _make("AbsActivation", "abs")
SquareActivation = _make("SquareActivation", "square")
ExpActivation = _make("ExpActivation", "exponential")
