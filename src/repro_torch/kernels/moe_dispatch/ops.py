"""Entry point of the MoE dispatch row gather (the JAX package's
``kernels/moe_dispatch/ops.py`` ``row_gather_op``, same signature less
``interpret``: the device of ``src`` picks the kernel or, on the CPU, its
plain version)."""
from __future__ import annotations

from repro_torch.kernels.moe_dispatch.kernel import (  # noqa: F401
    row_gather as row_gather_op)
