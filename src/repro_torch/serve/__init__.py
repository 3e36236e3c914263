"""Serving: concurrent query serving over shared plans
(:mod:`repro_torch.serve.query`)."""
