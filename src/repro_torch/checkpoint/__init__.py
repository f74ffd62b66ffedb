"""Checkpoints (counterpart of ``repro.checkpoint``): the reference's
npz + manifest layout with atomic commit, and the async writer."""
