"""repro_torch.tune — input-adaptive variant selection (autotuning).

A port of the JAX package's ``repro.tune``.  The paper's thesis is that
irregular patterns are unknown until runtime, so the right code variant
must be decided *per input*.  This package is that decision layer: a
declarative candidate space with platform/seed validity rules
(:mod:`~repro_torch.tune.space`), an analytical pre-pruner over
feature-table statistics (:mod:`~repro_torch.tune.cost`), an on-device
measurement harness (:mod:`~repro_torch.tune.search`), and a persistent,
content-addressed tuning cache (:mod:`~repro_torch.tune.cache`) so a warm
process picks the tuned configuration without re-measuring.

Applications opt in with ``backend="auto"`` (or ``tune=True``) on
``SpMV.from_coo`` / ``SpMM.from_coo`` / ``PageRank.from_edges`` and the
``core.graphs`` apps.
"""
from repro_torch.tune.cache import (load_entry, store_entry,  # noqa: F401
                                    tuning_key)
from repro_torch.tune.cost import (PlanFeatures, plan_features,  # noqa: F401
                                   predict_us, rank_candidates)
from repro_torch.tune.search import (KernelCandidateError,  # noqa: F401
                                     Measurement, TuningResult, autotune,
                                     measurement_count)
from repro_torch.tune.space import (Candidate, candidate_space,  # noqa: F401
                                    space_signature)
