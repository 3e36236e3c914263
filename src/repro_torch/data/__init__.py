"""The synthetic training data pipeline
(:mod:`repro_torch.data.pipeline`)."""
