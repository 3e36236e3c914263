"""Observability: spans, the metrics registry, the logger hierarchy and
static per-launch cost attribution (``profile``: ``app.report()``).

A leaf package (standard library only; ``profile`` reaches the planner's
feature table lazily), so every layer can import it."""
from repro_torch.obs.profile import RunReport, build_report  # noqa: F401
