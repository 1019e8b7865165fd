"""XMem video object segmentation (inference) in PyTorch.

Counterpart of ``d3fields_tpu/models/xmem/``: ``blocks`` (the network's
modules), ``network`` (the ``XMem`` module with the reference's parameter
names), ``memory`` (the three-tier memory) and ``core`` (the per-frame
stepper over all views).
"""
