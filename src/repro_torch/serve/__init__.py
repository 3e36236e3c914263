"""Serving: concurrent query serving over shared plans
(:mod:`repro_torch.serve.query`) and batched LM generation
(:mod:`repro_torch.serve.engine`)."""
