"""Entry point of the standalone segmented reduction (the JAX package's
``kernels/segment_reduce/ops.py`` ``segment_reduce_op``, same signature
less ``interpret``: the device of ``x`` picks the kernel or, on the CPU,
its plain version)."""
from __future__ import annotations

from repro_torch.kernels.segment_reduce.kernel import (  # noqa: F401
    segment_reduce as segment_reduce_op)
