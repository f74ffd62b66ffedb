"""Optimizer of the training path (counterpart of ``repro.optim``):
AdamW on plain dicts of tensors."""
