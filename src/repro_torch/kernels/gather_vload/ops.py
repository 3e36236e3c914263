"""Entry point of the standalone gather replacement (the JAX package's
``kernels/gather_vload/ops.py`` ``gather_vload_op``, same signature less
``interpret``: the device of ``x_view`` picks the kernel or, on the CPU,
its plain version)."""
from __future__ import annotations

from repro_torch.kernels.gather_vload.kernel import (  # noqa: F401
    gather_vload as gather_vload_op)
