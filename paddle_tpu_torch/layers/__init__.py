"""Layers of the reference's ``layers`` package that are not ops of
``paddle_tpu_torch.ops``: ``contrib.fused_attention``."""

from . import contrib  # noqa: F401
