"""Training (counterpart of ``repro.train``): the vocab-chunked loss, the
train step with gradient accumulation, and the trainer loop."""
