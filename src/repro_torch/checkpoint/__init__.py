"""Checkpoints of the training state
(:mod:`repro_torch.checkpoint.checkpoint`)."""
