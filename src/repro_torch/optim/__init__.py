"""Optimizers: AdamW (:mod:`repro_torch.optim.adamw`) and int8 gradient
compression for the data-parallel all-reduce
(:mod:`repro_torch.optim.compress`)."""
