"""The language models: configs in :mod:`repro_torch.configs`, layers
here, serving in :mod:`repro_torch.serve.engine`.  The ``dense``,
``moe``, ``ssm`` (rwkv6) and ``hybrid`` (zamba2) families are ported; the
others raise :func:`not_ported`."""
from __future__ import annotations

# family -> (reference model, ROADMAP item that ports it)
NOT_PORTED = {"encdec": ("whisper", 17), "vlm": ("paligemma", 18)}


def not_ported(family: str) -> NotImplementedError:
    model, item = NOT_PORTED[family]
    return NotImplementedError(
        f"the {family} family ({model}) is not ported yet: ROADMAP item "
        f"{item}")
