"""XMem video object segmentation in PyTorch: inference and training.

Counterpart of ``d3fields_tpu/models/xmem/``: ``blocks`` (the network's
modules), ``network`` (the ``XMem`` module with the reference's parameter
names), ``memory`` (the three-tier memory), ``core`` (the per-frame
stepper over all views), ``data`` (video layouts and annotation masks, and
the training clips) and ``trainer`` (the losses, the rollout and AdamW).
"""
