"""The dry run in the port (``repro_torch.launch.dryrun``,
``launch/step_analysis.py``, ``params.abstract_init``, ``lm.cache_axes``)
against the JAX package's ``launch/dryrun.py`` and ``hlo_analysis.py``.

* flops: ``analyze_step`` over a ``reduced()`` step traced on ``meta``
  tensors equals the reference's ``analyze_hlo`` over the compiled HLO of
  the same step (tokens (2, 64)) to ``rel=1e-6``, for every forward where
  the two agree and for granite's and qwen3-moe's loss + backward.  For
  zamba2 and rwkv6's backward the port's count equals an analytic count
  of the products the port runs (ROADMAP §3 records why the reference's
  differs; the difference is pinned too);
* per-device bytes: a device's parameter and moment bytes (float32 and
  ``opt_8bit``) at the published widths on the 256- and 512-chip meshes
  equal the reference's ``Shd.spec`` over ``jax.eval_shape`` on an
  ``AbstractMesh`` (exact);
* ``abstract_init`` shapes, dtypes and axes, ``cache_axes`` and
  ``should_skip`` equal the reference's;
* the reckoned collective bytes equal those ``DataParallel`` counts in a
  step on simulated CPU meshes (exact), float32 and 8-bit moments; on
  ``(1, 2)`` and ``(2, 2)`` meshes, where one data replica's program is
  traced over its model pieces, for every family's train step (float32
  and 8-bit), prefill and decode step, the model axis's too
  (``DataParallel`` / ``ModelPieces``' counters);
* over the pieces, piece 0's traced flops equal an analytic count of its
  products (granite and zamba2 at ``(1, 2)``); records on a model axis of
  1 are what they were before the pieces were traced (pinned numbers);
* the CLI writes a cell's JSON in a subprocess that never imports JAX,
  and a cell that raises records ``status: "error"``.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch import sharding as rsh
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import lm as rlm
from repro.models import params as rpr
from repro.optim import adamw as radamw

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.data.pipeline import batch_struct, synth_batch
from repro_torch.launch import dryrun as dr
from repro_torch.launch import sharding as sh
from repro_torch.launch import step_analysis as sa
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import (ShardMesh, make_shard_mesh,
                                     make_simulated_mesh, production_mesh)
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
AGREE_FORWARD = ["granite_3_2b", "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b",
                 "gemma3_27b", "rwkv6_3b", "gemma_7b", "h2o_danube_3_4b",
                 "whisper_small", "paligemma_3b"]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ flops
def _port_flops(arch, backward: bool) -> int:
    cfg = get_config(arch).reduced()

    def build():
        model = lm.init_model(cfg, device="cpu")
        batch = {k: torch.zeros(shape, dtype=dt)
                 for k, (shape, dt) in batch_struct(cfg, B, S).items()}
        if not backward:
            def step():
                with torch.no_grad():
                    return lm.forward(model, cfg, batch)
        else:
            model.requires_grad_(True)

            def step():
                loss, _ = lm.loss_fn(model, cfg, batch)
                loss.backward()
        return step, list(model.parameters()) + list(batch.values())
    return sa.analyze_step(build)["flops"]


def _ref_flops(arch, backward: bool) -> float:
    rcfg = rget_config(arch).reduced()
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(0),
                                   rcfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    batch["loss_mask"] = np.ones((B, S), np.float32)
    for k, v in synth_batch(get_config(arch).reduced(), B, S, 0).items():
        batch.setdefault(k, v)
    if backward:
        fn = jax.grad(lambda p, b: rlm.loss_fn(p, rcfg, b)[0])
    else:
        fn = (lambda p, b: rlm.forward(p, rcfg, b)[0])
    hlo = jax.jit(fn).lower(vals, batch).compile().as_text()
    return analyze_hlo(hlo)["flops"]


@pytest.mark.parametrize("arch", AGREE_FORWARD)
def test_forward_flops_match_the_reference_analysis(arch):
    assert _port_flops(arch, False) == pytest.approx(
        _ref_flops(arch, False), rel=1e-6)


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_loss_and_backward_flops_match_the_reference_analysis(arch):
    assert _port_flops(arch, True) == pytest.approx(
        _ref_flops(arch, True), rel=1e-6)


def _mm(*dims) -> int:
    """2 x the product of a product's dimensions (batch, m, k, n)."""
    return 2 * math.prod(dims)


def _rwkv6_products(cfg):
    """(forward flops, products autograd skips) of the port's rwkv6."""
    t, d, h, hk = B * S, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    q = 32
    while S % q:
        q -= 1
    chunk = (_mm(B * q * q * h, hk)             # scores: a dot over k
             + _mm(B * h, q, q, hk)              # intra-chunk values
             + 2 * _mm(B * h, q, hk, hk))        # off-chunk, state update
    layer = (5 * _mm(t, d, d)                    # r k v g, output
             + 2 * _mm(t, d, 64)                 # the decay's LoRA
             + 2 * _mm(t, d, cfg.d_ff)           # channel mix
             + (S // q) * chunk)
    # chunk 0's state is a constant zero (no gradient of the off-chunk
    # product for it) and the last chunk's new state is unused
    skipped = 3 * _mm(B * h, q, hk, hk)
    return (cfg.num_layers * layer + _mm(t, d, cfg.vocab_size),
            cfg.num_layers * skipped)


def _zamba2_products(cfg):
    """(forward flops, products autograd skips, shared block's forward)
    of the port's zamba2."""
    t, d, q = B * S, cfg.d_model, cfg.ssm_chunk
    di, n, heads, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    chunk = (_mm(B, q, n, q)                     # C B^T
             + _mm(B * heads, q, q, p)           # diagonal block
             + 2 * _mm(B, q, n, heads * p))      # off-chunk, state update
    layer = (_mm(t, d, 2 * di + 2 * n + heads)   # in_proj
             + _mm(t, di, d)                     # out_proj
             + (S // q) * chunk)
    hd, kh, h = cfg.head_dim, cfg.num_kv_heads, cfg.num_heads
    shared = (_mm(t, d, h * hd) + 2 * _mm(t, d, kh * hd)
              + 2 * _mm(B * h, S, hd, S) + _mm(t, h * hd, d)
              + 2 * _mm(t, d, cfg.d_ff) + _mm(t, cfg.d_ff, d))
    applied = cfg.num_layers // cfg.shared_attn_every
    fwd = cfg.num_layers * layer + applied * shared + \
        _mm(t, d, cfg.vocab_size)
    # as rwkv6: chunk 0's constant state, the last chunk's unused state
    skipped = cfg.num_layers * 3 * _mm(B, q, n, heads * p)
    return fwd, skipped, shared


def test_rwkv6_flops_equal_an_analytic_count_of_its_products():
    """The port counts the products it runs: the forward, and the
    backward's two products a forward product (one an operand that needs
    no gradient, none a result the loss does not use).  The reference's
    analysis charges the 786,432 flop of the skipped boundary products
    too: its transposed scan body runs them on every chunk."""
    cfg = get_config("rwkv6_3b").reduced()
    fwd, skipped = _rwkv6_products(cfg)
    assert _port_flops("rwkv6_3b", False) == fwd
    assert _port_flops("rwkv6_3b", True) == 3 * fwd - skipped
    assert _ref_flops("rwkv6_3b", True) - (3 * fwd - skipped) == skipped


def test_zamba2_flops_equal_an_analytic_count_of_its_products():
    """zamba2 at ``reduced()`` (6 layers, the shared block after the
    sixth): the port counts the shared block once; the reference's
    analysis charges the ``lax.cond`` holding it on all 6 iterations of
    its layer scan, 5 more times in the forward than it runs."""
    cfg = get_config("zamba2_1p2b").reduced()
    fwd, skipped, shared = _zamba2_products(cfg)
    assert _port_flops("zamba2_1p2b", False) == fwd
    assert _port_flops("zamba2_1p2b", True) == 3 * fwd - skipped
    assert _ref_flops("zamba2_1p2b", False) - fwd == 5 * shared


# -------------------------------------------------------- per-device bytes
def _per_device(spec, mesh_shape, shape) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            n //= mesh_shape[a]
    return n


def _ref_leaves(tree, axes):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], axes[k])
    else:
        yield tree, tuple(axes)


_REF_BYTES = {}


def _reference_bytes(arch, shape, names):
    key = (arch, shape)
    if key in _REF_BYTES:
        return _REF_BYTES[key]
    mesh = jax.sharding.AbstractMesh(shape, names)
    mshape = dict(zip(names, shape))
    shd = rsh.Shd(mesh, rsh.default_rules(mesh))
    sds, axes = rpr.abstract_init(rlm.init_model, rget_config(arch))
    params = m32 = 0
    for leaf, ax in _ref_leaves(sds, axes):
        n = _per_device(shd.spec(ax, leaf.shape), mshape, leaf.shape)
        params += n * leaf.dtype.itemsize
        m32 += 2 * 4 * n
    q8 = 0
    opt = jax.eval_shape(lambda p: radamw.init(
        p, radamw.AdamWConfig(quantize_moments=True)), sds)
    for part in ("m", "v"):
        for leaf in jax.tree.leaves(opt[part]):
            names_ = ("embed",) + (None,) * (leaf.ndim - 1)
            q8 += _per_device(shd.spec(names_, leaf.shape), mshape,
                              leaf.shape) * leaf.dtype.itemsize
    _REF_BYTES[key] = (params, m32, q8)
    return _REF_BYTES[key]


@pytest.mark.parametrize("shape,names", MESHES, ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_state_bytes_match_the_reference(arch, shape, names):
    mesh = production_mesh(multi_pod=len(shape) == 3)
    assert (mesh.axis_names, mesh.sizes) == (names, shape)
    params, m32, q8 = _reference_bytes(arch, shape, names)
    cfg = get_config(arch)
    for opt, moments in ((None, m32), ({"quantize_moments": True}, q8)):
        got = dr.reckon(cfg, "train", SHAPES["train_4k"], mesh,
                        sh.default_rules(mesh), opt, trace=False)
        assert got["arguments"]["params"] == params
        assert got["arguments"]["opt"] == moments + 4      # + the step
        assert got["memory"]["argument_bytes"] == sum(
            got["arguments"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_init_matches_the_reference(arch):
    values, axes = pr.abstract_init(get_config(arch))
    assert all(t.device.type == "meta" for t in pr.leaves_like(
        pr.stack_tree(values), pr.stack_tree(values))
        for t in (t if isinstance(t, list) else [t]))
    sds, raxes = rpr.abstract_init(rlm.init_model, rget_config(arch))
    want = [(tuple(leaf.shape), np.dtype(leaf.dtype).name, ax)
            for leaf, ax in _ref_leaves(sds, raxes)]
    got = [(shape, str(dt).replace("torch.", ""), ax)
           for shape, _, dt, ax in sa.stacked_leaves(values, axes)]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_the_reference(arch):
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    want = rlm.cache_axes(jax.eval_shape(lambda: rlm.init_cache(rcfg, 2, 16)))
    cache = lm.init_cache(cfg, 2, 16, device="meta")
    assert lm.cache_axes(cache) == want
    assert lm.CACHE_AXES == rlm.CACHE_AXES


def test_should_skip_and_variants_match_the_reference():
    flags = os.environ.get("XLA_FLAGS")
    try:   # the reference's module sets XLA_FLAGS when imported
        from repro.launch import dryrun as rdr
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    for arch in ARCHS:
        for shape in SHAPES:
            assert dr.should_skip(arch, shape) == rdr.should_skip(arch, shape)
    assert dr.VARIANTS == rdr.VARIANTS


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("k,q_block,batch,microbatches", [
    (2, None, 4, 1), (4, None, 4, 2), (4, None, 6, 1), (2, 48, 4, 1),
    (4, 32, 4, 2), (4, 48, 4, 1), (4, 32, 6, 1)])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_reckoned_collectives_equal_the_counted_ones(arch, k, q_block, batch,
                                                     microbatches):
    cfg = get_config(arch).reduced()
    model = lm.init_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    mesh = make_shard_mesh(k, device="cpu", simulate=True)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    dp = loop.DataParallel(model, shd)
    oc = adamw.AdamWConfig(quantize_moments=q_block is not None,
                           q_block=q_block or 256)
    state = adamw.init(dp.tree(), oc, shd=shd)
    step = loop.make_train_step(cfg, oc, shd=shd, microbatches=microbatches)
    data = {key: torch.as_tensor(x)
            for key, x in synth_batch(cfg, batch, 12, 0).items()}
    dp.reset_collectives()
    step(dp, state, data)
    want = sa.reckon_collectives(
        shd, sa.stacked_leaves(model.tree(), model.axes), "train",
        q_block=q_block, split=(batch // microbatches) % k == 0,
        microbatches=microbatches)
    assert dp.collectives == {c: want[c] for c in sa.COLLECTIVES}
    assert want["total_bytes"] == sum(v["bytes"] for v in
                                      dp.collectives.values())
    if q_block is not None and (k, q_block) != (4, 48):
        assert want["all-to-all"]["bytes"] > 0
    rec = dr.reckon(cfg, "train", {"seq_len": 12, "global_batch": batch},
                    mesh, sh.default_rules(mesh),
                    {"quantize_moments": True, "q_block": q_block}
                    if q_block else None, trace=False)
    if microbatches == 1:
        assert rec["collectives"] == want


def _with(coll: dict, more: dict) -> dict:
    out = {k: dict(v) for k, v in coll.items() if isinstance(v, dict)}
    for kind, v in more.items():
        out[kind]["count"] += v["count"]
        out[kind]["bytes"] += v["bytes"]
    return out


FAMILY_ARCHS = ["granite_3_2b", "qwen3_moe_235b_a22b", "rwkv6_3b",
                "zamba2_1p2b", "whisper_small", "paligemma_3b"]
PIECE_KINDS = [("train", None), ("train", 32), ("prefill", None),
               ("decode", None)]


@pytest.mark.parametrize("kind,q_block", PIECE_KINDS,
                         ids=["train", "train_8bit", "prefill", "decode"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reckoned_collectives_over_model_pieces_equal_the_counted_ones(
        arch, mesh, kind, q_block):
    """``reckon`` traces one data replica's program over its model pieces:
    its collectives equal the data axes' (``reckon_collectives``) plus
    the model axis's that ``DataParallel`` counts in a train step (8-bit:
    the run's assembly too), or ``ModelPieces`` in ``engine.prefill`` /
    ``lm.decode_step`` at the last slot of a full cache, exactly.  zamba2
    at 2 layers, the shared block after the second (its program at a
    third of the trace's cost)."""
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = cfg.replace(num_layers=2, shared_attn_every=2)
    m = make_simulated_mesh(*mesh, device="cpu")
    shd = sh.Shd(m, sh.default_rules(m))
    opt = {"quantize_moments": True, "q_block": q_block} if q_block else None
    rec = dr.reckon(cfg, kind, {"seq_len": 12, "global_batch": 4}, m,
                    shd.rules, opt)
    model = lm.init_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    leaves = sa.stacked_leaves(model.tree(), model.axes)
    data = {k: torch.as_tensor(x) for k, x in
            synth_batch(cfg, 4, 12, 0).items()}
    if kind == "train":
        dp = loop.DataParallel(model, shd)
        oc = adamw.AdamWConfig(**(opt or {}))
        state = adamw.init(dp.tree(), oc, shd=shd)
        dp.reset_collectives()
        loop.make_train_step(cfg, oc, shd=shd)(dp, state, data)
        counted = dp.collectives
    else:
        mp = tp.ModelPieces(model, shd)
        with torch.no_grad():
            if kind == "prefill":
                engine.prefill(mp, cfg, {k: v for k, v in data.items()
                                         if k not in ("labels", "loss_mask")},
                               max_len=12 + lm.prefix_slots(cfg))
            else:
                cache = lm.init_cache_pieces(mp, 4, 12)
                mp.reset_collectives()
                lm.decode_step(mp, cfg, cache, torch.zeros(
                    (4, 1), dtype=torch.int32), 11,
                    prefix_len=lm.prefix_slots(cfg))
        counted = _with(sa.reckon_collectives(shd, leaves, kind),
                        mp.collectives)
    assert {k: v for k, v in rec["collectives"].items()
            if k != "total_bytes"} == counted
    assert rec["collectives"]["total_bytes"] == sum(
        v["bytes"] for v in counted.values())
    assert any(v["count"] for v in rec["traced"]["model_collectives"]
               .values())
    # one fake device a traced piece (every replica where qwen3-moe's one
    # dispatch group spans both), and host scalars and shapes beside them
    devices, k = rec["traced"]["devices"], rec["traced"]["replicas"]
    assert k == (2 if (arch, mesh) == ("qwen3_moe_235b_a22b", (2, 2))
                 else 1)
    pieces = [d for d in devices if ":" in d]
    assert sorted(pieces) == [f"cpu:{j}" for j in range(k * mesh[1])]
    assert all(devices[d]["flops"] == 0 for d in devices if ":" not in d)
    assert rec["cost"]["flops"] == devices["cpu:0"]["flops"]
    assert rec["traced"]["mesh_flops"] == mesh[0] // k * sum(
        d["flops"] for d in devices.values())


def _piece_products(cfg, B: int, S: int):
    """Piece 0's forward flops at (1, 2) of granite (q heads, mlp and
    vocab cut in two, the one kv head whole in every piece) or zamba2
    (``in_proj`` columns, heads, ``out_proj`` rows, the shared block's
    heads, kv heads and mlp, and the vocabulary cut in two; every piece
    reads all of ``B`` and ``C``), and the products autograd skips."""
    t, d, h, hd = B * S, cfg.d_model, cfg.num_heads // 2, cfg.head_dim
    kv = cfg.num_kv_heads // 2 if cfg.num_kv_heads % 2 == 0 else \
        cfg.num_kv_heads
    attn = (_mm(t, d, h * hd) + 2 * _mm(t, d, kv * hd)
            + 2 * _mm(B * h, S, hd, S) + _mm(t, h * hd, d)
            + 2 * _mm(t, d, cfg.d_ff // 2) + _mm(t, cfg.d_ff // 2, d))
    logits = _mm(t, d, cfg.vocab_size // 2)
    if cfg.family == "dense":
        return cfg.num_layers * attn + logits, 0
    q, n, heads, p = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_heads // 2, \
        cfg.ssm_head_dim
    width = 2 * cfg.d_inner + 2 * n + cfg.ssm_heads
    chunk = (_mm(B, q, n, q) + _mm(B * heads, q, q, p)
             + 2 * _mm(B, q, n, heads * p))
    layer = (_mm(t, d, width // 2) + _mm(t, cfg.d_inner // 2, d)
             + (S // q) * chunk)
    applied = cfg.num_layers // cfg.shared_attn_every
    return (cfg.num_layers * layer + applied * attn + logits,
            cfg.num_layers * 3 * _mm(B, q, n, heads * p))


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_1p2b"])
def test_piece_flops_equal_an_analytic_count_of_their_products(arch):
    """A train step at (1, 2), tokens (2, 16) (two SSD chunks of 8):
    device 0's flops are piece 0's products, forward and backward (twice
    each forward product but the skipped boundaries of the SSD's chunk
    scan); the two pieces' sum is the mesh's."""
    cfg = get_config(arch).reduced()
    mesh = make_simulated_mesh(1, 2, device="cpu")
    rec = dr.reckon(cfg, "train", {"seq_len": 16, "global_batch": 2}, mesh,
                    sh.default_rules(mesh))
    fwd, skipped = _piece_products(cfg, 2, 16)
    assert rec["cost"]["flops"] == 3 * fwd - skipped
    assert rec["traced"]["mesh_flops"] == rec["traced"]["flops"]


@pytest.mark.parametrize("arch,layers,mesh,kind", [
    ("granite_3_2b", 12, (2, 2), "train"),
    ("qwen3_moe_235b_a22b", 10, (2, 2), "decode"),
    ("zamba2_1p2b", 20, (1, 2), "decode")])
def test_a_deep_model_traced_at_two_depths_equals_its_whole_trace(
        arch, layers, mesh, kind, monkeypatch):
    """Past ``TRACE_LAYERS`` a model is traced at two cut depths, a
    period of its layers apart (granite and qwen3-moe 2 and 3 layers,
    zamba2, whose shared block follows every 6th, 8 and 14), and
    extrapolated: device 0's flops, bytes accessed and peak of
    temporaries (the record's), every device's flops and bytes accessed,
    the collectives and the mesh's flops equal the whole trace's."""
    cfg = get_config(arch).reduced().replace(num_layers=layers)
    m = make_simulated_mesh(*mesh, device="cpu")
    shape = {"seq_len": 16, "global_batch": 4}
    cut = dr.reckon(cfg, kind, shape, m, sh.default_rules(m))
    assert cut["traced"]["depths"] == ([8, 14] if arch == "zamba2_1p2b"
                                       else [2, 3])
    monkeypatch.setattr(dr, "TRACE_LAYERS", layers)
    whole = dr.reckon(cfg, kind, shape, m, sh.default_rules(m))
    assert "depths" not in whole["traced"]
    for key in ("cost", "memory", "collectives"):
        assert cut[key] == whole[key], key
    for key in ("mesh_flops", "model_collectives"):
        assert cut["traced"][key] == whole["traced"][key], key
    for dev, d in whole["traced"]["devices"].items():
        for key in ("flops", "memory_bytes"):
            assert cut["traced"]["devices"][dev][key] == d[key], (dev, key)


# a model axis of 1: (argument, output, temp bytes; flops, bytes
# accessed; the trace's flops, bytes accessed and peak, its divisor; the
# collective bytes), as the single-device trace reckoned them before the
# pieces were traced (reduced(), tokens (4, 12))
MODEL_AXIS_1 = [
    ("granite_3_2b", "train", 2, None,
     (520228, 519960, 467604, 12828672, 13601124, 25657344, 27202248,
      935208, 2, 517376)),
    ("granite_3_2b", "train", 2, {"quantize_moments": True, "q_block": 32},
     (270732, 270464, 501396, 12828672, 18284852, 25657344, 36569704,
      1002792, 2, 690048)),
    ("qwen3_moe_235b_a22b", "prefill", 1, None,
     (1004992, 16384, 234492, 8388608, 3855664, 8388608, 3855664, 234492,
      1, 0)),
    ("rwkv6_3b", "decode", 2, None,
     (252428, 20480, 39936, 434176, 609256, 868352, 1218512, 79872, 2,
      396800)),
    ("zamba2_1p2b", "train", 4, None,
     (736084, 735960, 1249434, 17662464, 26467474, 70649856, 105869896,
      4997736, 4, 1125952)),
]


@pytest.mark.parametrize("arch,kind,k,opt,want", MODEL_AXIS_1,
                         ids=[f"{a}-{kd}-{k}" for a, kd, k, _, _ in
                              MODEL_AXIS_1])
def test_records_on_a_model_axis_of_1_are_unchanged(arch, kind, k, opt,
                                                    want):
    cfg = get_config(arch).reduced()
    mesh = make_shard_mesh(k, device="cpu", simulate=True) if k > 1 else \
        ShardMesh(devices=(torch.device("cpu"),), data=1)
    rec = dr.reckon(cfg, kind, {"seq_len": 12, "global_batch": 4}, mesh,
                    sh.default_rules(mesh), opt)
    m, t = rec["memory"], rec["traced"]
    assert (m["argument_bytes"], m["output_bytes"], m["temp_bytes"],
            rec["cost"]["flops"], rec["cost"]["bytes_accessed"],
            t["flops"], t["memory_bytes"], t["peak_bytes"], t["divisor"],
            rec["collectives"]["total_bytes"]) == want
    assert set(t) == {"flops", "memory_bytes", "peak_bytes", "trace_s",
                      "divisor"}


def test_reckoned_argument_bytes_equal_what_a_device_holds():
    """The data-parallel state on a simulated 2-shard mesh: a device's
    pieces of the parameters, moments (float32 and 8-bit), step and batch
    are the reckoned ``arguments`` exactly."""
    cfg = get_config("granite_3_2b").reduced()
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    dp = loop.DataParallel(lm.init_model(cfg, device="cpu"), shd)
    batch = {key: sh.batch_sharding(shd, {key: torch.as_tensor(x)})[key]
             .split(torch.as_tensor(x)) for key, x in
             synth_batch(cfg, 4, 12, 0).items()}
    for opt in (None, {"quantize_moments": True, "q_block": 32}):
        state = adamw.init(dp.tree(), adamw.AdamWConfig(**(opt or {})),
                           shd=shd)
        rec = dr.reckon(cfg, "train", {"seq_len": 12, "global_batch": 4},
                        mesh, sh.default_rules(mesh), opt, trace=False)
        held = dr.held_bytes(dp.tree(), state, batch)
        assert held == rec["arguments"]


# -------------------------------------------------------------- the CLI
def test_the_cli_writes_a_cell_without_jax(tmp_path):
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"dryrun.main(['--arch', 'qwen3-moe-235b-a22b', '--shape', "
            f"'train_4k', '--mesh', 'multipod', '--variant', 'opt_8bit', "
            f"'--reduced', '--out', {str(tmp_path)!r}])\n"
            "assert 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=300)
    path = tmp_path / ("qwen3-moe-235b-a22b__train_4k__multipod__opt_8bit"
                       "__reduced.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["devices"] == 512
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert set(rec["analysis"]) == {"flops", "memory_bytes", "collectives"}
    for key in ("compile_s", "generated_code_bytes", "hlo_ops"):
        assert key not in rec
    assert rec["collectives"]["all-to-all"]["bytes"] > 0
    assert rec["collectives"]["total_bytes"] == sum(
        v["bytes"] for v in rec["collectives"].values() if isinstance(v, dict))
    assert (rec["seq_len"], rec["global_batch"], rec["kind"]) == \
        (4096, 256, "train")
    # one data replica's 16 pieces traced; a device is piece 0
    assert len(rec["traced"]["devices"]) == 16
    assert rec["cost"]["flops"] == rec["traced"]["devices"]["cpu:0"]["flops"]
    assert rec["traced"]["mesh_flops"] == rec["traced"]["flops"] * 32


def test_cells_record_skips_and_errors(tmp_path, monkeypatch):
    rec = dr.run_cell("granite-3-2b", "long_500k", "pod", str(tmp_path))
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]

    def boom(*a, **k):
        raise RuntimeError("no such cell")
    monkeypatch.setattr(dr, "reckon", boom)
    rec = dr.run_cell("granite-3-2b", "decode_32k", "pod", str(tmp_path),
                      reduced=True)
    assert rec["status"] == "error" and "no such cell" in rec["error"]
    assert json.loads((tmp_path / "granite-3-2b__decode_32k__pod__reduced"
                       ".json").read_text()) == rec
