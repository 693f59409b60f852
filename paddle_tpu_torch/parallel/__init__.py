"""Attention over a whole sequence on one device (``full_attention``).

Ring and all-to-all attention, meshes and the SPMD train step come with the
distribution slice."""

from paddle_tpu_torch.parallel.sequence_parallel import full_attention

__all__ = ["full_attention"]
