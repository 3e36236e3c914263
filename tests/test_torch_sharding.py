"""The LM's logical-axis sharding rules (``repro_torch.launch.sharding``)
and the vocab-sharded decode embedding (``models/layers.py``
``embed_lookup_psum``) against the JAX package.

* ``Shd.spec`` equals the reference's ``Shd(...).spec`` for every leaf of
  every architecture's parameter axes tree (published shapes, from the
  reference's ``abstract_init``, and the port's own ``reduced()`` trees),
  under ``default_rules`` and ``replicated_rules``, on the mesh shapes
  (16, 16), (2, 16, 16), (2, 1), (4, 1) and (1, 4) (the reference's
  ``AbstractMesh``, which needs no devices; on the port's side a stand-in
  with the same ``shape`` and ``axis_names``), divisibility fallbacks
  included; ``batch_sharding`` likewise on batches that divide and
  batches that do not.
* ``Placement.split`` / ``join`` on simulated CPU meshes, and each
  device's block against ``NamedSharding.devices_indices_map`` of the
  reference on a 4-device CPU mesh (a subprocess that sets
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before importing
  jax).
* ``embed_lookup_psum``: ``torch.equal`` to the reference's
  ``embed_lookup`` at model 1, 2 and 4 and through its fallbacks; in the
  subprocess, the reference's own ``embed_lookup_psum`` on its 4-device
  mesh at (1, 4) and (2, 2); a psum decode's tokens and logits equal to
  the gather decode's.  ``torch.equal``, not a byte comparison: a zeroed
  piece turns a ``-0.0`` row entry into ``+0.0``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch import sharding as rsh
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import params as rpr

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import ShardMesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.serve import engine

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 1), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model"))]
RULES = ["default_rules", "replicated_rules"]
ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class AxesMesh:
    """The port's side of an ``AbstractMesh``: what ``Shd`` reads."""
    shape: dict
    axis_names: tuple


def _meshes(shape, names):
    ref = jax.sharding.AbstractMesh(shape, names)
    return ref, AxesMesh(dict(zip(names, shape)), names)


def _leaves(axes, shapes, prefix=""):
    if isinstance(axes, dict):
        for k in sorted(axes):
            yield from _leaves(axes[k], shapes[k], f"{prefix}/{k}")
    else:
        yield prefix, tuple(axes), tuple(shapes.shape)


@pytest.fixture(scope="module")
def published_axes():
    return {arch: rpr.abstract_init(rlm.init_model, rget_config(arch))[::-1]
            for arch in ARCHS}


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
def test_spec_equals_reference_on_published_shapes(mesh, rules,
                                                   published_axes):
    rmesh, pmesh = _meshes(*mesh)
    rshd = rsh.Shd(rmesh, getattr(rsh, rules)(rmesh))
    shd = sh.Shd(pmesh, getattr(sh, rules)(pmesh))
    assert shd.rules == rshd.rules
    fallbacks = 0
    for arch, (axes, shapes) in published_axes.items():
        for path, names, shape in _leaves(axes, shapes):
            want = tuple(rshd.spec(names, shape))
            assert shd.spec(names, shape) == want, (arch, path, want)
            assert shd.spec(names) == tuple(rshd.spec(names)), (arch, path)
            fallbacks += want != tuple(rshd.spec(names))
    if rules == "default_rules" and mesh[0][-1] == 16:
        assert fallbacks > 0        # e.g. kv_heads 8 on a model axis of 16


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
def test_spec_and_placements_on_the_ports_reduced_trees(mesh):
    """The port's own axes trees (``init_model(...).axes``, stacked
    layout) equal the reference's, and ``params_shardings`` over them
    gives the reference's specs leaf for leaf."""
    rmesh, pmesh = _meshes(*mesh)
    rshd = rsh.Shd(rmesh, rsh.default_rules(rmesh))
    shd = sh.Shd(pmesh, sh.default_rules(pmesh))
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = lm.init_model(cfg, device="cpu")
        rshapes, raxes = rpr.abstract_init(rlm.init_model,
                                           rget_config(arch).reduced())
        assert model.axes == jax.tree.map(
            tuple, raxes, is_leaf=lambda x: isinstance(x, tuple))
        got = sh.params_shardings(shd, model.axes, pr.stack_tree(
            model.tree()))
        want = rsh.params_shardings(rshd, raxes, rshapes)
        flat_got = {p: t.spec for p, t in _flat(got)}
        flat_want = {p: tuple(s.spec) for p, s in _flat(want)}
        assert flat_got == flat_want, arch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
@pytest.mark.parametrize("batch", [1, 3, 4, 8, 32, 64])
def test_batch_sharding_equals_reference(mesh, rules, batch):
    rmesh, pmesh = _meshes(*mesh)
    rshd = rsh.Shd(rmesh, getattr(rsh, rules)(rmesh))
    shd = sh.Shd(pmesh, getattr(sh, rules)(pmesh))
    tree = {"tokens": np.zeros((batch, 5), np.int32),
            "loss_mask": np.zeros((batch, 5), np.float32),
            "enc_frames": np.zeros((batch, 3, 2), np.float32)}
    want = rsh.batch_sharding(rshd, tree)
    got = sh.batch_sharding(shd, tree)
    for k in tree:
        assert got[k].spec == tuple(want[k].spec), k


def test_constrain_keeps_the_rank_check_and_the_values():
    _, pmesh = _meshes((2, 1), ("data", "model"))
    shd = sh.Shd(pmesh, sh.default_rules(pmesh))
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.constrain(x, ("batch", None)) is x
    with pytest.raises(ValueError, match="rank mismatch"):
        shd.constrain(x, ("batch",))


# ------------------------------------------------------------- placements
def _mesh(data, model):
    return ShardMesh(devices=(torch.device("cpu"),) * (data * model),
                     data=data, model=model, simulated=True)


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (4, 1), (1, 4),
                                        (2, 2)])
@pytest.mark.parametrize("names", [("vocab", "embed"), ("embed", "mlp"),
                                   ("norm",), ("batch", None, None),
                                   ("kv_heads", "embed", "head_dim")])
def test_split_and_join_round_trip(data, model, names):
    mesh = _mesh(data, model)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    shape = (8, 12, 3)[:len(names)]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    pl = shd.named(names, shape)
    parts = pl.split(x)
    assert len(parts.pieces) == data * model
    for n, piece in enumerate(parts.pieces):
        assert torch.equal(piece, x[pl.block(n, shape)])
        assert piece.data_ptr() >= x.data_ptr()       # views on one device
    assert torch.equal(parts.join(), x)
    copies = pl.split(x, copy=True)
    assert all(p.is_contiguous() for p in copies.pieces)
    assert len({p.data_ptr() for p in copies.pieces}) == data * model
    out = torch.zeros_like(x)
    copies.join(out=out)
    assert torch.equal(out, x)
    y = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    copies.load(y)
    assert torch.equal(copies.join(), y)
    # one copy of every block among the owners
    blocks = {pl.block(n, shape) for n in range(data * model)}
    assert {pl.block(n, shape) for n in pl.owners()} == blocks
    assert len(pl.owners()) == len(blocks)


def test_take_rows_views_and_gathers():
    parts = [torch.arange(6).reshape(3, 2), torch.arange(6, 14).reshape(4, 2)]
    whole = torch.cat(parts)
    one = sh.take_rows(parts, [0, 3], 1, 3, "cpu")
    assert torch.equal(one, whole[1:3]) and one.data_ptr() == \
        parts[0][1].data_ptr()
    assert torch.equal(sh.take_rows(parts, [0, 3], 2, 6, "cpu"), whole[2:6])
    assert torch.equal(sh.take_rows(parts, [0, 3], 0, 7, "cpu"), whole)


def test_a_dimension_that_does_not_divide_raises_on_split():
    mesh = _mesh(2, 1)
    pl = sh.Placement(mesh, ("data",))
    with pytest.raises(ValueError, match="does not divide"):
        pl.split(torch.zeros(3))


# --------------------------------------------------------- psum lookup
def _table_and_ids(v=256, d=16, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    table[3, 2] = -0.0
    ids = rng.integers(0, v, size=(3, 5)).astype(np.int32)
    ids[0, 0] = 3                       # a row holding a -0.0
    return table, ids


@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (1, 4), (2, 2),
                                        (4, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_lookup_psum_equals_the_reference_lookup(data, model, dtype,
                                                       monkeypatch):
    table, ids = _table_and_ids()
    want = np.asarray(rlayers.embed_lookup(jax.numpy.asarray(table),
                                           jax.numpy.asarray(ids),
                                           jax.numpy.float32))
    mesh = _mesh(data, model)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    t = torch.tensor(table).to(dtype)
    seen, gather = [], L.row_gather

    def spy(src, row_ids, d_tile=512):
        seen.append((tuple(src.shape), row_ids.dtype, int(row_ids.max())))
        return gather(src, row_ids, d_tile)
    monkeypatch.setattr(L, "row_gather", spy)
    got = L.embed_lookup_psum(t, torch.tensor(ids), torch.float32, shd)
    assert torch.equal(got, torch.tensor(want).to(dtype).float())
    assert torch.equal(got, L.embed_lookup(t, torch.tensor(ids),
                                           torch.float32))
    v_loc = table.shape[0] // model
    assert len(seen) == data * model and all(
        s == (v_loc, table.shape[1] // data) and dt == torch.int32 and
        hi < v_loc for s, dt, hi in seen)
    # split once: a second lookup reuses the pieces
    placed = shd.place(t, ("vocab", "embed"))
    L.embed_lookup_psum(t, torch.tensor(ids), torch.float32, shd)
    assert shd.place(t, ("vocab", "embed")) is placed
    if data == 1:       # whole rows: the pieces are views of the table
        assert [p.data_ptr() for p in placed.pieces] == [
            t[j * v_loc].data_ptr() for j in range(model)]


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_embed_lookup_psum_follows_the_table_after_a_write(data, model):
    """The placed pieces follow the table: written in place, or given new
    storage, it is split again.  At (2, 2) the pieces are copies (column
    blocks of the table), as on separate cards, where stale pieces would
    keep the old rows."""
    table, ids = _table_and_ids()
    mesh = _mesh(data, model)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    t, ids = torch.tensor(table), torch.tensor(ids)
    L.embed_lookup_psum(t, ids, torch.float32, shd)
    base = t.untyped_storage().data_ptr()
    pieces = shd.place(t, ("vocab", "embed")).pieces
    assert any(p.untyped_storage().data_ptr() != base
               for p in pieces) == (data > 1)
    with torch.no_grad():
        t.mul_(2).add_(1)
    assert torch.equal(L.embed_lookup_psum(t, ids, torch.float32, shd),
                       L.embed_lookup(t, ids, torch.float32))
    t.data = torch.tensor(table) * 3
    assert torch.equal(L.embed_lookup_psum(t, ids, torch.float32, shd),
                       L.embed_lookup(t, ids, torch.float32))


@pytest.mark.parametrize("case", ["vocab_does_not_divide", "vocab_rule"])
def test_embed_lookup_psum_falls_back_to_the_gather(case, monkeypatch):
    table, ids = _table_and_ids(v=255 if case == "vocab_does_not_divide"
                                else 256)
    mesh = _mesh(1, 2)
    rules = sh.default_rules(mesh)
    if case == "vocab_rule":
        rules = sh.replicated_rules(mesh)
    monkeypatch.setattr(L, "row_gather", lambda *a, **k: pytest.fail(
        "the fallback must not gather pieces"))
    got = L.embed_lookup_psum(torch.tensor(table), torch.tensor(ids),
                              torch.float32, sh.Shd(mesh, rules))
    want = rlayers.embed_lookup(jax.numpy.asarray(table),
                                jax.numpy.asarray(ids), jax.numpy.float32)
    assert torch.equal(got, torch.tensor(np.asarray(want)))


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "granite_3_2b",
                                  "gemma_7b"])
def test_psum_decode_equals_the_gather_decode(arch):
    cfg = get_config(arch).reduced()
    model = lm.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    mesh = _mesh(1, 4)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    want, wcache = engine.generate(model, cfg, {"tokens": toks}, 5, 16)
    pcfg = cfg.replace(decode_embed="psum")
    got, gcache = engine.generate(model, pcfg, {"tokens": toks}, 5, 16,
                                  shd=shd)
    assert torch.equal(got, want)
    for k in wcache:
        assert torch.equal(gcache[k], wcache[k]), k
    lw, _ = lm.decode_step(model, cfg, wcache, got[:, -1:], 6 + 4)
    lg, _ = lm.decode_step(model, pcfg, gcache, got[:, -1:], 6 + 4,
                           shd=shd)
    assert torch.equal(lg, lw)
    placed = shd.place(model.embed, ("vocab", "embed"))
    assert [p.data_ptr() for p in placed.pieces] == [
        model.embed[j * cfg.vocab_size // 4].data_ptr() for j in range(4)]


# ------------------------------------------------- the reference's mesh
_SUBPROCESS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.launch import sharding as rsh
    from repro.models import layers as rlayers
    table = np.load(sys.argv[1]); ids = np.load(sys.argv[2])
    out = {}
    for data, model in ((1, 4), (2, 2), (4, 1)):
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(data, model),
                    ("data", "model"))
        shd = rsh.Shd(mesh, rsh.default_rules(mesh))
        tab = jax.device_put(jnp.asarray(table),
                             shd.named(("vocab", "embed"), table.shape))
        got = jax.jit(lambda t, i: rlayers.embed_lookup_psum(
            t, i, jnp.float32, shd))(tab, jnp.asarray(ids))
        np.save(sys.argv[3] + f"_{data}x{model}.npy", np.asarray(got))
        blocks = {}
        for names in (("vocab", "embed"), ("embed", "mlp"), ("norm",),
                      ("batch", None, None)):
            shape = (8, 12, 4)[:len(names)]
            idx = shd.named(names, shape).devices_indices_map(shape)
            blocks["/".join(map(str, names))] = [
                [[s.start or 0, s.stop if s.stop is not None else n]
                 for s, n in zip(idx[dev], shape)]
                for dev in mesh.devices.reshape(-1)]
        out[f"{data}x{model}"] = blocks
    print(json.dumps(out))
""")


def test_reference_psum_lookup_on_a_4_device_mesh(tmp_path):
    """The reference's own ``embed_lookup_psum`` (shard_map + psum over the
    model axis) on a 4-device CPU mesh, and its per-device blocks, against
    the port's on simulated meshes of the same shapes."""
    table, ids = _table_and_ids()
    np.save(tmp_path / "t.npy", table)
    np.save(tmp_path / "i.npy", ids)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, str(tmp_path / "t.npy"),
         str(tmp_path / "i.npy"), str(tmp_path / "out")],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    blocks = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, by_names in blocks.items():
        data, model = map(int, key.split("x"))
        mesh = _mesh(data, model)
        shd = sh.Shd(mesh, sh.default_rules(mesh))
        want = np.load(tmp_path / f"out_{key}.npy")
        got = L.embed_lookup_psum(torch.tensor(table), torch.tensor(ids),
                                  torch.float32, shd)
        assert torch.equal(got, torch.tensor(want)), key
        for names, ref_blocks in by_names.items():
            names_t = tuple(None if n == "None" else n
                            for n in names.split("/"))
            shape = (8, 12, 4)[:len(names_t)]
            pl = shd.named(names_t, shape)
            for n, ref in enumerate(ref_blocks):
                assert [[s.start, s.stop] for s in pl.block(n, shape)] == \
                    ref, (key, names, n)
