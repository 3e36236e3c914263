"""Candidate variant space for the input-adaptive autotuner.

A port of the JAX package's ``tune/space.py``.  The paper's core
observation is that the right code variant is "unknown until runtime due
to input dependence": the engine exposes several execution strategies
(fused vs per-class launch lists, the single segment-reduce form, the
hand-written CUDA kernels, both write-backs, and the CostModel knobs that
reshape the plan itself), and the measured winner flips across matrices.
A :class:`Candidate` is one fully specified configuration; the *validity
rules* keep the tuner from measuring a configuration that cannot run (or
cannot run honestly) on the platform:

* the backends are ``torch``, ``segsum`` and ``cuda`` (the reference's
  ``jax``, ``segsum`` and ``pallas``); the platforms are ``"cpu"`` and
  ``"cuda"``, resolved from the device the app runs on
  (:func:`platform_of`), never from whether a card is present;
* ``cuda`` is skipped off the card unless ``allow_interpret`` asks for it
  (there the kernel wrappers run their plain torch versions, whose
  timings say nothing of the kernels);
* ``segsum`` requires a reduce ``scatter_reduce_`` implements, and
  ignores ``fused``/``stage_b``/``coalesce`` (stage A+B collapse into one
  segment reduce), so those axes are canonicalized away;
* the per-launch kernel axes (``kernel_rows`` — stage-A block rows per
  step, which the kernels honour as ``rows_per_step``; ``kernel_prefetch``
  — the reference's metadata DMA depth) exist only for ``cuda``
  candidates, and ``kernel_prefetch`` never on the ``"cuda"`` platform:
  the kernels have no metadata prefetch, so it would time one kernel
  twice (the reference rules the same for ``"gpu"``);
* the row-shard axis (DESIGN.md §10) is capped at the device count: a
  candidate of ``shards > 1`` is valid only where that many devices of the
  platform are visible, or where the caller simulates the mesh and says
  how many devices it has (``devices=``); ``cuda`` candidates are never
  sharded (``ir.partition_plan`` refuses their subtrees).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.plan import CostModel
from repro_torch.core.seed import CodeSeed
from repro_torch.launch import mesh as lmesh

# reduces with a scatter_reduce_ form (engine's segsum backend)
SEGMENT_REDUCES = frozenset({"add", "mul", "max", "min"})

_BACKENDS = ("torch", "segsum", "cuda")
_STAGE_BS = ("gather", "dense")
PLATFORMS = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the variant space — everything needed to build an
    executor: the plan shape (``lane_width``, ``max_windows_replace`` are
    CostModel inputs, so they select which *plan* is built) and the
    execution strategy on top of it."""

    backend: str = "torch"             # "torch" | "segsum" | "cuda"
    fused: bool = True
    stage_b: str = "gather"            # "gather" | "dense"
    lane_width: int = 128
    max_windows_replace: int | None = None
    coalesce: bool = False             # ir.coalesce_gathers lowering pass
    shards: int = 1                    # row shards over a device mesh (§10)
    # per-launch kernel params (None = emitter default of 1).  Upper
    # bounds, not exact values: results are bitwise-stable across every
    # setting, so the axes are pure performance knobs.
    kernel_rows: int | None = None     # stage-A block rows per step
    kernel_prefetch: int | None = None  # reference knob; never on "cuda"

    @property
    def plan_key(self) -> tuple:
        """Candidates with equal plan keys share one BlockPlan (and the
        reorder work that goes with it).  ``shards`` is deliberately NOT
        part of the key: every shard count partitions the same parent
        plan (``ir.partition_plan`` slices, it never re-analyzes)."""
        return (self.lane_width, self.max_windows_replace)

    def cost_model(self) -> CostModel:
        return CostModel(lane_width=self.lane_width,
                         max_windows_replace=self.max_windows_replace)

    @property
    def label(self) -> str:
        mode = "fused" if self.fused else "per_class"
        cut = ("" if self.max_windows_replace is None
               else f"/w{self.max_windows_replace}")
        co = "/co" if self.coalesce else ""
        sh = f"/s{self.shards}" if self.shards > 1 else ""
        kr = "" if self.kernel_rows is None else f"/kr{self.kernel_rows}"
        kp = ("" if self.kernel_prefetch is None
              else f"/kp{self.kernel_prefetch}")
        return (f"{self.backend}/{mode}/{self.stage_b}"
                f"/n{self.lane_width}{cut}{co}{sh}{kr}{kp}")

    @property
    def kernel_params(self) -> dict | None:
        """The ``kernel_params`` mapping :func:`engine.make_executor`
        consumes, or None when every knob is at its emitter default."""
        kp: dict = {}
        if self.kernel_rows is not None:
            kp["rows_per_step"] = self.kernel_rows
        if self.kernel_prefetch is not None:
            kp["meta_prefetch"] = self.kernel_prefetch
        return kp or None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def platform_of(device) -> str:
    """The tuning platform of a device: ``"cuda"`` for a CUDA device,
    ``"cpu"`` for anything else."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def canonicalize(c: Candidate) -> Candidate:
    """Collapse don't-care axes so the space holds no duplicate configs:
    segsum has a single form (``fused``/``stage_b``/``coalesce`` fixed to
    their defaults); the kernel-param axes steer the cuda emitter alone,
    so they are fixed to None everywhere else."""
    if c.backend == "segsum":
        c = dataclasses.replace(c, fused=True, stage_b="gather")
    if c.backend not in ("torch", "cuda") and c.coalesce:
        c = dataclasses.replace(c, coalesce=False)
    if c.backend != "cuda" and (c.kernel_rows is not None
                                or c.kernel_prefetch is not None):
        c = dataclasses.replace(c, kernel_rows=None, kernel_prefetch=None)
    return c


def is_valid(c: Candidate, seed: CodeSeed, platform: str,
             allow_interpret: bool = False,
             devices: int | None = None) -> bool:
    """The platform/seed validity rules (module docstring).  ``devices``
    caps the shard axis (default: the visible device count of
    ``platform``) so the tuner never measures a mesh it cannot build."""
    if c.backend not in _BACKENDS or c.stage_b not in _STAGE_BS:
        return False
    if c.lane_width < 2:
        return False
    if c.backend == "cuda" and platform != "cuda" and not allow_interpret:
        return False
    if c.backend == "segsum" and seed.reduce not in SEGMENT_REDUCES:
        return False
    if c.shards < 1:
        return False
    if c.shards > 1:
        if c.backend == "cuda":
            # partition_plan refuses cuda subtrees (the kernels are
            # single-device)
            return False
        if devices is None:
            devices = len(lmesh.visible_devices(platform))
        if c.shards > devices:
            return False
    for knob in (c.kernel_rows, c.kernel_prefetch):
        if knob is not None and not (1 <= knob <= 64):
            return False
    if c.kernel_prefetch is not None and platform == "cuda":
        return False
    return True


# default per-launch kernel-param axes swept for cuda candidates (None =
# emitter default): one non-default point per knob, as the reference
_KERNEL_ROWS_AXIS = (None, 8)
_KERNEL_PREFETCH_AXIS = (None, 4)


def candidate_space(seed: CodeSeed, *, platform: str | None = None,
                    backends: tuple = _BACKENDS,
                    lane_widths: tuple = (128,),
                    window_cutoffs: tuple = (None,),
                    shard_counts: tuple = (1,),
                    allow_interpret: bool = False,
                    kernel_rows_axis: tuple = _KERNEL_ROWS_AXIS,
                    kernel_prefetch_axis: tuple = _KERNEL_PREFETCH_AXIS,
                    devices: int | None = None,
                    ) -> list["Candidate"]:
    """Enumerate the valid, canonical candidate list for ``seed`` on
    ``platform`` (default ``"cuda"``, the entry points' default device) —
    the declarative product space filtered by :func:`is_valid` and
    deduplicated through :func:`canonicalize`, in the reference's order.

    The default axes give 9 candidates on ``"cpu"`` (8 torch forms: fused
    x stage_b x coalesce, + segsum); ``"cuda"`` adds the 16 cuda forms
    (fused x stage_b x coalesce x ``kernel_rows``).  Widening
    ``lane_widths`` / ``window_cutoffs`` multiplies the *plan* axis, which
    the search harness shares per :attr:`Candidate.plan_key`.
    ``shard_counts`` adds the row-shard axis, capped at ``devices``
    (default: the visible device count of ``platform``; a simulated mesh
    passes its own)."""
    platform = platform or "cuda"
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; expected one of "
                         f"{PLATFORMS}")
    if devices is None and any(k > 1 for k in shard_counts):
        devices = len(lmesh.visible_devices(platform))
    out: list[Candidate] = []
    seen: set[Candidate] = set()
    for n in lane_widths:
        for cut in window_cutoffs:
            for k in shard_counts:
                for backend in backends:
                    kr_axis = (kernel_rows_axis if backend == "cuda"
                               else (None,))
                    kp_axis = (kernel_prefetch_axis if backend == "cuda"
                               else (None,))
                    for fused in (True, False):
                        for stage_b in _STAGE_BS:
                            for coalesce in (False, True):
                                for kr in kr_axis:
                                    for kp in kp_axis:
                                        c = Candidate(
                                            backend=backend, fused=fused,
                                            stage_b=stage_b, lane_width=n,
                                            max_windows_replace=cut,
                                            coalesce=coalesce, shards=k,
                                            kernel_rows=kr,
                                            kernel_prefetch=kp)
                                        if not is_valid(c, seed, platform,
                                                        allow_interpret,
                                                        devices):
                                            continue
                                        c = canonicalize(c)
                                        if c in seen:
                                            continue
                                        seen.add(c)
                                        out.append(c)
    return out


def space_signature(candidates: list[Candidate]) -> str:
    """Stable textual identity of a candidate list — part of the tuning
    cache key, so a changed space (new backend, new knob) re-tunes instead
    of replaying a choice made over a different menu."""
    return ";".join(sorted(c.label for c in candidates))
