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
  step on simulated CPU meshes (exact), float32 and 8-bit moments;
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
from repro_torch.launch.mesh import make_shard_mesh, production_mesh
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.optim import adamw
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
    assert rec["cost"]["flops"] == rec["traced"]["flops"] // 512


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
