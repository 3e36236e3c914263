"""``chip_smoke.py``'s ``[lm]`` cells reckoned on the CPU, before the card
sees them.

* ``REFERENCE_PARAMS``, the parameter counts the chip script holds its
  models to (it imports no JAX), equal to the JAX package's
  ``abstract_init`` count of the same config, and to the port's on the
  ``meta`` device;
* the sliding-window and kimi-k2 cells (gemma3-27b whole, h2o-danube-3-4b
  whole, kimi-k2 at 1 layer, bf16) and their float32 decode == forward
  checks fit on one 80 GB card with ``HELD`` bytes to spare for what the
  earlier phases hold: the weights from the meta init, the cache from
  ``lm.init_cache`` on ``meta``, and the largest transient of one layer
  of the prefill (or of the check's forward) worked out from the shapes
  (:func:`transient_bytes`);
* kimi's check would not fit with its 384 experts, which is why the cell
  cuts them.

All of it is shapes: no element is allocated or drawn, and the test runs
in seconds.
"""
import math
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import lm as rlm
from repro.models import params as rpr

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models import params as pr

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402

CARD_BYTES = 80e9
# held by the phases before [lm] (the sparse matrices, plans and the
# standalone kernels' operands: 4,191,916,032 B on the H100), with room
# for the allocator's blocks
HELD = 12e9
NEW_CELLS = ("gemma3-27b", "h2o-danube-3-4b", "kimi-k2-1t-a32b")


def _module(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "p")


def _cell(arch):
    return next(spec for spec in C.LM_CELLS if spec["arch"] == arch)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _numel(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))


@pytest.mark.parametrize("key", sorted(C.REFERENCE_PARAMS))
def test_reference_params_equal_the_references_count(key):
    """Each count of ``chip_smoke.REFERENCE_PARAMS`` ("name" whole,
    "name@layers" cut in depth) is the reference's ``abstract_init``
    count of that config, and the port's model on ``meta`` has it too."""
    arch, _, layers = key.partition("@")
    mod = _module(arch)
    rcfg, cfg = rget_config(mod), get_config(mod)
    if layers:
        rcfg = rcfg.replace(num_layers=int(layers))
        cfg = cfg.replace(num_layers=int(layers))
    shapes, _ = rpr.abstract_init(rlm.init_model, rcfg)
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert want == C.REFERENCE_PARAMS[key]
    assert _numel(pr.abstract_init(cfg)[0]) == want
    assert C.Smoke.reference_params(cfg) == want


def transient_bytes(cfg, b: int, s: int, t: int, logits_rows: int) -> int:
    """The largest transient of one layer of a forward over ``s`` new
    positions against ``t`` keys (prefill: ``t == s``), in ``cfg``'s
    compute dtype, reckoned from the shapes of ``models/attention.py``
    ``_sdpa`` (the float32 scores and their softmax live at once, the
    additive float32 mask beside them), ``mlp.py`` (gate, up and their
    product) and ``moe.py`` (the dispatch buffer, the experts' hidden
    rows, the combined rows), plus the float32 logits of
    ``logits_rows`` positions."""
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    h, kh, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.d_model
    qkv = b * s * (h + 2 * kh) * hd * item + b * t * 2 * kh * hd * item
    attention = qkv + 8 * b * h * s * t + 4 * b * s * t
    if cfg.family == "moe":
        tokens, e, k = b * s, cfg.num_experts, cfg.top_k
        tg = tokens // max(1, tokens // cfg.moe_group_size)
        c = max(1, math.ceil(tg * k / e * cfg.capacity_factor))
        ffn = (e * c * (2 * d + 3 * cfg.moe_d_ff) + tokens * k * d) * item
    else:
        ffn = b * s * 3 * cfg.d_ff * item
    return max(attention, ffn) + logits_rows * cfg.vocab_size * 4


def _cell_bytes(cfg, b, s, steps):
    """weights, cache and the prefill's transient of a served cell."""
    weights = _nbytes(pr.abstract_init(cfg)[0])
    max_len = lm.prefix_slots(cfg) + s + steps + 4
    cache = _nbytes(lm.init_cache(cfg, b, max_len, device="meta"))
    return weights, cache, transient_bytes(cfg, b, s, s, b)


def _check_config(arch, cut, experts=None):
    """The float32 config of a cell's decode == forward check, as
    ``Smoke.lm_decode_check`` cuts it."""
    spec = _cell(arch)
    cfg = get_config(_module(arch))
    cfg = cfg.replace(num_layers=cut.get("layers",
                                         spec["layers"] or cfg.num_layers),
                      num_experts=experts or cut.get("num_experts",
                                                     cfg.num_experts))
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    return cfg.replace(param_dtype=torch.float32,
                       compute_dtype=torch.float32)


def _check_bytes(cfg, cut):
    b, n = C.LM_CHECK["batch"], C.LM_CHECK["decoded"]
    s = cut.get("prompt", C.LM_CHECK["prompt"]) + n
    weights = _nbytes(pr.abstract_init(cfg)[0])
    # the forward over every position, its logits kept beside the
    # prefill's and the decode's
    return weights + transient_bytes(cfg, b, s, s, 2 * b * s)


@pytest.mark.parametrize("arch", NEW_CELLS)
def test_new_lm_cells_fit_on_one_card(arch):
    """The bf16 cell whole (weights, cache and the prefill's largest
    transient) and its float32 check fit in ``CARD_BYTES`` less ``HELD``;
    the prompt is past the window, so the rings wrap."""
    spec = _cell(arch)
    cfg = get_config(_module(arch))
    if spec["layers"]:
        cfg = cfg.replace(num_layers=spec["layers"])
    b, s, steps = spec["batch"], spec["prompt"], spec["steps"]
    weights, cache, transient = _cell_bytes(cfg, b, s, steps)
    assert weights == 2 * C.Smoke.reference_params(cfg) + (
        cfg.d_model * cfg.num_experts * 2 * cfg.num_layers)  # f32 router
    assert weights + cache + transient < CARD_BYTES - HELD, \
        (weights, cache, transient)
    cut = spec["check"]
    check = _check_config(arch, cut)
    if cut.get("float64"):      # the same weights in float64 after it
        check = check.replace(param_dtype=torch.float64,
                              compute_dtype=torch.float64)
    assert _check_bytes(check, cut) < CARD_BYTES - HELD
    if cfg.window:
        assert s > cfg.window
        assert cut["prompt"] > cfg.window
        kinds = lm.layer_kinds(cfg.replace(num_layers=cut["layers"]))
        assert 0 in kinds and 1 in kinds or cfg.attn_kind == "swa"


def test_kimi_check_needs_its_expert_cut():
    """kimi-k2's one layer in float32 with all 384 experts is 77.5 GB of
    weights: with the check's transient it passes what the card has beside
    the earlier phases, so the check cuts the experts (top-8 and every
    width kept)."""
    cut = _cell("kimi-k2-1t-a32b")["check"]
    whole = _check_config("kimi-k2-1t-a32b", cut, experts=384)
    assert _nbytes(pr.abstract_init(whole)[0]) == 77514493952
    assert _check_bytes(whole, cut) > CARD_BYTES - HELD
    assert _check_config("kimi-k2-1t-a32b", cut).top_k == 8
