"""Test support: fault injection (:mod:`repro_torch.testing.faults`).

Nothing in here is imported by the production modules; the faults are
opt-in context managers for the tests and for ``chip_smoke.py``."""
