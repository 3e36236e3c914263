"""Observability: spans, the metrics registry and the logger hierarchy.

A leaf package (standard library only), so every layer can import it."""
