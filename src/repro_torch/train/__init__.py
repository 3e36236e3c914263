"""The LM training loop (:mod:`repro_torch.train.loop`)."""
