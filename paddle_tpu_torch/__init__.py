"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same ``trainer_config_helpers`` configs build the same models, with
the same parameter names and shapes, and run on one NVIDIA H100 through
kernels written by hand for Hopper (``csrc/``). The JAX package beside
this one is the reference the port is held against; nothing here
imports it.

This slice runs the seqToseq NMT continuous-batching greedy server:

- ``paddle_tpu_torch.flagship`` — ``nmt_gen_config`` builds the model;
- ``paddle_tpu_torch.graph`` — ``GradientMachine(model_config, device)``;
- ``paddle_tpu_torch.serving.frontend.build_engine`` — the engine over
  :class:`~paddle_tpu_torch.serving.torch_backend.TorchDecodeBackend`;
- ``paddle_tpu_torch.ops.fused_gru`` / ``fused_attention_gru`` — the
  encoder GRU and the fused decode step, each a CUDA kernel beside its
  plain PyTorch version.

Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`paddle_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
