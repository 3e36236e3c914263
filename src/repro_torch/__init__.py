"""PyTorch and CUDA port of the Intelligent-Unroll engine.

Mirrors the layout of the JAX package ``repro`` (``repro_torch/core/ir.py``
sits where ``repro/core/ir.py`` does) and imports neither JAX nor anything
of ``repro``.  Entry points take ``device=`` and default to ``"cuda"``.
"""
