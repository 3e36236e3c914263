"""Data-parallel LM training in the port (``repro_torch.train.loop``
``DataParallel`` / ``Trainer(mesh=..., rules=...)``, ``optim/adamw.py``
over ``Sharded`` pieces, ``DataIterator(shd=...)``, elastic checkpoints)
against the JAX package.

GSPMD preserves semantics, so the reference's *single-device* jitted step
is the oracle for the port's sharded one.  On simulated CPU meshes of 2
and 4 shards (``make_shard_mesh(k, device="cpu", simulate=True)``, the
default rules: parameters and moments FSDP-sharded over ``data``), at
``reduced()`` configs, from the reference's ``materialize_init`` weights
(seed 1) and its ``synth_batch`` data:

* 5 steps against the reference's jitted ``make_train_step`` at the rules
  of ``test_torch_train.py::test_train_steps_match_reference``: each
  step's loss and gradient norm at ``rtol=1e-4, atol=1e-5 x scale``
  (whisper's steps start from the reference's state, its moments held
  too); granite, qwen3-moe (one dispatch group spanning the replicas, and
  at ``moe_group_size`` 16 three groups, two of them cut by the replica
  boundary: groups, capacity and the aux loss global), rwkv6 and whisper,
  ``microbatches`` 1 and 2 (at 4 shards a microbatch of 2 rows does not
  divide and is replicated), and a batch of 6 rows that 4 shards do not
  divide (replicated: each replica computes it whole, no gradient summed
  k times);
* a mesh of one device takes the single-device step, and the
  data-parallel step over one shard is ``mesh=None``'s bitwise (losses,
  metrics, parameters, moments);
* elastic restart: a checkpoint written at k shards resumes on one device
  and the reverse, against the straight run at the dense rule; a 1-shard
  checkpoint byte for byte ``mesh=None``'s;
* a model axis above 1 raises, citing ROADMAP item 21; ``DataIterator``
  pieces are the global batch's rows.
"""
import dataclasses
import functools
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import synth_batch as rsynth_batch
from repro.models import lm as rlm
from repro.models import params as rpr
from repro.optim import adamw as radamw
from repro.train import loop as rloop

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataIterator, synth_batch
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.train import loop

RTOL, ATOL = 1e-4, 1e-5
S = 12
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=5)


def _close(got, want, err_msg="", atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=atol * scale, err_msg=err_msg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rcfg(arch, group_size):
    rcfg = rget_config(arch).reduced()
    return rcfg.replace(moe_group_size=group_size) if group_size else rcfg


@dataclasses.dataclass
class Reference:
    vals: dict          # the initial weights, numpy
    axes: dict          # their logical axes (stacked layout)
    batches: list       # the numpy batch of each step
    metrics: list       # the reference's metrics of each step
    before: list        # (weights, m, v) before each step, numpy


@functools.lru_cache(maxsize=None)
def _reference(arch, microbatches, batch, group_size=None) -> Reference:
    """The reference's jitted single-device steps (cached: every shard
    count is held to the same run)."""
    rcfg = _rcfg(arch, group_size)
    vals, axes = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                      rcfg)
    roc = radamw.AdamWConfig(**OCFG)
    rstep = jax.jit(rloop.make_train_step(rcfg, roc,
                                          microbatches=microbatches))
    rstate = radamw.init(vals, roc)
    out = Reference(jax.tree.map(np.asarray, vals), jax.tree.map(
        tuple, axes, is_leaf=lambda x: isinstance(x, tuple)), [], [], [])
    for i in range(5):
        b = rsynth_batch(rcfg, batch, S, step=i)
        out.before.append(jax.tree.map(np.asarray, (vals, rstate["m"],
                                                    rstate["v"])))
        vals, rstate, want = rstep(vals, rstate, b)
        out.batches.append(b)
        out.metrics.append({k: float(v) for k, v in want.items()})
    return out


def _dp(cfg, ref, k):
    model = convert.lm_params_from_numpy(cfg, ref.vals, device="cpu",
                                         axes=ref.axes)
    shd = _dp_shd(k)
    return loop.DataParallel(model, shd), shd


def _dp_shd(k):
    mesh = make_shard_mesh(k, device="cpu", simulate=True)
    return sh.Shd(mesh, sh.default_rules(mesh))


def _load_moments(state, m, v):
    for key, src in (("m", m), ("v", v)):
        for dst, x in zip(pr.leaves_like(state[key], state[key]),
                          pr.leaves_like(state[key], src)):
            convert.assign(dst, torch.tensor(np.asarray(x)))


def _steps_match_reference(arch, k, microbatches, batch=4,
                           group_size=None):
    ref = _reference(arch, microbatches, batch, group_size)
    cfg = get_config(arch).reduced()
    if group_size:
        cfg = cfg.replace(moe_group_size=group_size)
    dp, shd = _dp(cfg, ref, k)
    oc = adamw.AdamWConfig(**OCFG)
    step = loop.make_train_step(cfg, oc, shd=shd, microbatches=microbatches)
    state = adamw.init(dp.tree(), oc)
    resync = cfg.family == "encdec"
    for i in range(5):
        if resync:        # this step starts where the reference's does
            vals, m, v = ref.before[i]
            convert.load_stacked(dp, pr.tree_map(torch.tensor, vals))
            _load_moments(state, m, v)
        state, got = step(dp, state, {key: torch.as_tensor(x) for key, x
                                      in ref.batches[i].items()})
        want = ref.metrics[i]
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], f"step {i} {key}")
        if resync and i < 4:
            _, m, v = ref.before[i + 1]
            for name, w in (("m", m), ("v", v)):
                g = _flat(pr.stacked_map(lambda x: x.join(), state[name]))
                for path, x in _flat(w).items():
                    _close(g[path], x, f"step {i} {name}{path}")
        assert all(p.grad is None for mdl in dp.models
                   for p in mdl.parameters())
    assert int(state["step"]) == 5
    return dp, state


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b",
                                  "rwkv6_3b", "whisper_small"])
def test_data_parallel_steps_match_reference(arch, microbatches, k):
    dp, state = _steps_match_reference(arch, k, microbatches)
    # FSDP: the d_model dimension of each large leaf is cut over the shards
    embed = dp.params["embed"]
    assert [tuple(p.shape) for p in embed.pieces] == \
        [(embed.shape[0], embed.shape[1] // k)] * k
    m = state["m"]["embed"]
    assert m.placement.spec == embed.placement.spec and \
        m.pieces[0].dtype == torch.float32


@pytest.mark.parametrize("k", [2, 4])
def test_moe_groups_cut_by_the_replica_boundary_match_reference(k):
    """``moe_group_size`` 16 over 4 x 12 tokens: three groups of 16, each
    cut by a boundary between replicas' rows at 2 or 4 shards."""
    _steps_match_reference("qwen3_moe_235b_a22b", k, 1, group_size=16)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_a_batch_the_shards_do_not_divide_matches_reference(arch,
                                                            microbatches):
    """6 rows over 4 shards (microbatches of 3): replicated, as
    ``batch_sharding`` falls back."""
    _steps_match_reference(arch, 4, microbatches, batch=6)


# ----------------------------------------------------------- the Trainer
def _tc(tmp_path, name, **kw):
    base = dict(steps=3, batch=4, seq=S, ckpt_every=1000,
                ckpt_dir=str(tmp_path / name), log_every=1000,
                async_ckpt=False,
                opt=adamw.AdamWConfig(**OCFG))
    return loop.TrainConfig(**{**base, **kw})


def _mesh(k):
    mesh = make_shard_mesh(k, device="cpu", simulate=True)
    return dict(mesh=mesh, rules=sh.default_rules(mesh))


def _moments(out):
    return {k: (v.join() if isinstance(v, sh.Sharded) else v) for k, v in
            _flat({n: out["opt"][n] for n in ("m", "v")}).items()}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b",
                                  "rwkv6_3b", "whisper_small"])
def test_one_shard_is_bitwise_the_single_device_trainer(arch, microbatches,
                                                        tmp_path):
    """A mesh of one device trains on the single-device step (no pieces,
    no replica), bitwise ``mesh=None``; the data-parallel step driven
    over one shard is that step bitwise too (losses, metrics, parameters,
    moments)."""
    cfg = get_config(arch).reduced()
    a = loop.Trainer(cfg, _tc(tmp_path, "a", microbatches=microbatches),
                     device="cpu").run()
    b = loop.Trainer(cfg, _tc(tmp_path, "b", microbatches=microbatches),
                     **_mesh(1)).run()
    assert a["data_parallel"] is None and b["data_parallel"] is None
    timing = ("step_time", "straggler")
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert {k: v for k, v in ma.items() if k not in timing} == \
            {k: v for k, v in mb.items() if k not in timing}
    _bitwise(a, b)

    def init():
        return loop.lm.init_model(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    model, dp = init(), loop.DataParallel(init(), _dp_shd(1))
    oc = adamw.AdamWConfig(**OCFG)
    plain = loop.make_train_step(cfg, oc, microbatches=microbatches)
    sharded = loop.make_train_step(cfg, oc, shd=dp.shd,
                                   microbatches=microbatches)
    sa, sb = adamw.init(model.tree(), oc), adamw.init(dp.tree(), oc)
    for i in range(3):
        batch = {k: torch.as_tensor(x)
                 for k, x in synth_batch(cfg, 4, S, i, 0).items()}
        sa, ma = plain(model, sa, batch)
        sb, mb = sharded(dp, sb, batch)
        assert {k: float(v) for k, v in ma.items()} == \
            {k: float(v) for k, v in mb.items()}, i
    dp.gather(replicas=1)
    _bitwise({"params": model, "opt": sa}, {"params": dp.models[0],
                                            "opt": sb})


def _bitwise(a, b):
    for (na, pa), (nb, pb) in zip(a["params"].named_parameters(),
                                  b["params"].named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    ma, mb = _moments(a), _moments(b)
    assert sorted(ma) == sorted(mb)
    for path in ma:
        assert torch.equal(ma[path], mb[path]), path


@pytest.mark.parametrize("first,then", [(2, None), (None, 2), (4, 2)],
                         ids=["2_shards_to_1", "1_to_2_shards",
                              "4_shards_to_2"])
def test_elastic_restart_across_meshes(first, then, tmp_path):
    """3 steps on one mesh with a checkpoint, a fresh Trainer on another
    resumed to 6, against 6 straight on the second: every step's loss and
    grad norm at the dense rule, the resumed steps the right ones."""
    cfg = get_config("granite_3_2b").reduced()

    def mesh(k):
        return {"device": "cpu"} if k is None else _mesh(k)
    loop.Trainer(cfg, _tc(tmp_path, "r", steps=3, ckpt_every=3),
                 **mesh(first)).run()
    assert ck.latest_step(str(tmp_path / "r")) == 3
    resumed = loop.Trainer(cfg, _tc(tmp_path, "r", steps=6),
                           **mesh(then)).run()
    straight = loop.Trainer(cfg, _tc(tmp_path, "s", steps=6),
                            **mesh(then)).run()
    assert [m["step"] for m in resumed["metrics"]] == [3, 4, 5]
    for got, want in zip(resumed["metrics"], straight["metrics"][3:]):
        for key in ("loss", "grad_norm", "lr"):
            _close(got[key], want[key], f"step {want['step']} {key}")
    for (name, p), q in zip(resumed["params"].named_parameters(),
                            straight["params"].parameters()):
        assert p.shape == q.shape and p.dtype == q.dtype, name


def test_a_one_shard_checkpoint_is_the_single_device_file(tmp_path):
    cfg = get_config("qwen3_moe_235b_a22b").reduced()
    loop.Trainer(cfg, _tc(tmp_path, "a", ckpt_every=3), device="cpu").run()
    loop.Trainer(cfg, _tc(tmp_path, "b", ckpt_every=3), **_mesh(1)).run()
    loop.Trainer(cfg, _tc(tmp_path, "c", ckpt_every=3), **_mesh(2)).run()
    a, b, c = (ck.read_payload(str(tmp_path / n), 3) for n in "abc")
    assert a == b
    assert sorted(a) == sorted(c)
    for path, rec in a.items():
        assert (rec["shape"], rec["dtype"]) == (c[path]["shape"],
                                                c[path]["dtype"]), path


# ------------------------------------------------------------ the pieces
def test_data_iterator_splits_the_global_batch(tmp_path):
    cfg = get_config("whisper_small").reduced()
    for k, batch in ((2, 4), (4, 4), (4, 6)):
        mesh = make_shard_mesh(k, device="cpu", simulate=True)
        shd = sh.Shd(mesh, sh.default_rules(mesh))
        it = DataIterator(cfg, batch, S, seed=3, start_step=2, shd=shd)
        try:
            got = next(it)
        finally:
            it.close()
        want = synth_batch(cfg, batch, S, 2, 3)
        assert sorted(got) == sorted(want)
        for key, x in got.items():
            assert isinstance(x, sh.Sharded) and x.shape == want[key].shape
            assert np.array_equal(x.join().numpy(), want[key])
            per = batch // k if batch % k == 0 else batch
            assert [p.shape[0] for p in x.pieces] == [per] * k, key


def test_the_gradient_norm_counts_a_replicated_leaf_once():
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    g = torch.arange(8.0).reshape(2, 4)
    grads = {"w": sh.Placement(mesh, (None, "data")).split(g),
             "n": sh.Placement(mesh, (None, None)).split(g)}
    _close(adamw.global_norm(grads), float(torch.sqrt(2 * (g ** 2).sum())))


def test_data_parallel_refuses_8_bit_moments():
    """8-bit moments of ``Sharded`` parameters need the rules that place
    their blocks (``shd=``), and their update the parameters and
    gradients in that block placement."""
    cfg = get_config("granite_3_2b").reduced()
    model = loop.lm.init_model(cfg, device="cpu")
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    dp = loop.DataParallel(model, sh.Shd(mesh, sh.default_rules(mesh)))
    oc = adamw.AdamWConfig(quantize_moments=True)
    with pytest.raises(ValueError, match="8-bit"):
        adamw.init(dp.tree(), oc)
    state = adamw.init(dp.tree(), oc, shd=dp.shd)
    grads = pr.tree_map(lambda x: sh.Sharded(x.placement, [
        torch.zeros_like(p, dtype=torch.float32) for p in x.pieces],
        x.shape), dp.tree())
    with pytest.raises(ValueError, match="8-bit"):
        adamw.update(dp.tree(), grads, state, oc)


def test_model_axis_above_one_and_missing_devices_raise(tmp_path):
    cfg = get_config("granite_3_2b").reduced()
    tp = ShardMesh(devices=(torch.device("cpu"),) * 4, data=2, model=2,
                   simulated=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        loop.Trainer(cfg, _tc(tmp_path, "t"), mesh=tp)
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        loop.DataParallel(loop.lm.init_model(cfg, device="cpu"),
                          sh.Shd(tp, sh.default_rules(tp)))
    if not torch.cuda.is_available():
        card = ShardMesh(devices=(torch.device("cuda", 0),) * 2, data=2,
                         simulated=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.Trainer(cfg, _tc(tmp_path, "t"), mesh=card)
    model = convert.lm_params_from_numpy(
        cfg, convert.lm_params_to_numpy(loop.lm.init_model(cfg,
                                                           device="cpu")),
        device="cpu")
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    with pytest.raises(ValueError, match="logical axes"):
        loop.DataParallel(model, sh.Shd(mesh, sh.default_rules(mesh)))


# ------------------------------------------------------- 8-bit moments
Q8 = dict(OCFG, clip_norm=1e9, quantize_moments=True)


def _per_layer_tree(stacked):
    """A stacked-structure tree of whole tensors in the port's per-layer
    structure (views of each layer)."""
    out = {}
    for key, v in stacked.items():
        if key in ("layers", "enc_layers"):
            n = pr.stacked_shape(pr.leaves_like(v, v)[0])[0]
            out[key] = [pr.stacked_map(lambda x, i=i: x[i], v)
                        for i in range(n)]
        else:
            out[key] = v
    return out


def _whole_grads(flat, like):
    """The flat block gradients of ``reduce_scatter(q_block=)`` as whole
    stacked tensors shaped as ``like``'s leaves."""
    def one(g, leaf):
        shape = pr.stacked_shape(leaf)
        return g.join().reshape(-1)[:int(np.prod(shape))].reshape(shape)
    return pr.stacked_map(one, flat, like)


@pytest.mark.parametrize("k,q_block,microbatches", [
    (2, 48, 1), (2, 48, 2), (4, 32, 1), (4, 48, 1)])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_8_bit_moments_under_a_mesh_match_the_reference_update(
        arch, k, q_block, microbatches, monkeypatch):
    """2 data-parallel steps with 8-bit moments (blocks of 48 span the
    layers of a stacked leaf; at 4 shards 32 divides every leaf's blocks
    over the shards and 48 does not, so they are replicated): each step's
    update, given the gradients the reduce-scatter made, against the
    reference's single-device 8-bit ``adamw.update`` from the same
    parameters and moments at ``test_torch_optim.py``'s 8-bit rule
    (unclipped; ``q`` equal, ``s`` and the parameters at the dense rule),
    and bitwise the port's single-device 8-bit update on the same
    gradients."""
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    vals, axes = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                      rcfg)
    vals = jax.tree.map(np.asarray, vals)
    axes = jax.tree.map(tuple, axes, is_leaf=lambda x: isinstance(x, tuple))
    dp, shd = _dp(cfg, Reference(vals, axes, [], [], []), k)
    oc = adamw.AdamWConfig(**Q8, q_block=q_block)
    roc = radamw.AdamWConfig(**Q8, q_block=q_block)
    state = adamw.init(dp.tree(), oc, shd=shd)
    assert all(x.placement == sh.blocks_placement(shd, x.shape[0], q_block)
               for x in pr.leaves_like(state["m"], state["m"]))
    step = loop.make_train_step(cfg, oc, shd=shd, microbatches=microbatches)
    seen = {}
    update = adamw.update

    def spy(params, grads, st, c):
        seen["grads"] = _whole_grads(grads, pr.stack_tree(dp.tree()))
        return update(params, grads, st, c)
    monkeypatch.setattr(adamw, "update", spy)

    def host(tree):
        return pr.stacked_map(lambda x: x.join(device="cpu").numpy(), tree)
    for i in range(2):
        before = (host_np(dp), host(state["m"]),
                  host(state["v"]), int(state["step"]))
        batch = {key: torch.as_tensor(x) for key, x in
                 rsynth_batch(rcfg, 4, S, step=i).items()}
        state, _ = step(dp, state, batch)
        grads = pr.stacked_map(lambda g: g.numpy(), seen["grads"])
        rstate = {"step": jax.numpy.int32(before[3]), "m": before[1],
                  "v": before[2]}
        want_p, want_st, _ = radamw.update(before[0], grads, rstate, roc)
        got_p = host_np(dp)
        for path, want in _flat(jax.tree.map(np.asarray, want_p)).items():
            _close(_flat(got_p)[path], want, f"step {i} {path}")
        for key in ("m", "v"):
            got = _flat(host(state[key]))
            for path, want in _flat(jax.tree.map(np.asarray,
                                                 want_st[key])).items():
                if path.endswith("/q"):
                    np.testing.assert_array_equal(got[path], want,
                                                  f"step {i} {key}{path}")
                else:
                    _close(got[path], want, f"step {i} {key}{path}")

        # the port's single-device 8-bit update on the same gradients
        one = convert.lm_params_from_numpy(cfg, before[0], device="cpu")
        st1 = {"step": torch.tensor(before[3], dtype=torch.int32),
               "m": pr.tree_map(torch.tensor, before[1]),
               "v": pr.tree_map(torch.tensor, before[2])}
        st1, _ = update(one.tree(), _per_layer_tree(seen["grads"]), st1, oc)
        for path, want in _flat(host_np(one)).items():
            assert np.array_equal(_flat(got_p)[path], want), path
        for key in ("m", "v"):
            got = _flat(host(state[key]))
            for path, want in _flat(pr.tree_map(torch.Tensor.numpy,
                                                st1[key])).items():
                assert np.array_equal(got[path], want), (key, path)


def host_np(model):
    return pr.stacked_map(lambda x: x.numpy(), convert.host_stacked(
        pr.stack_tree(model.tree())))


def test_8_bit_elastic_restart_keeps_q_and_s_bitwise(tmp_path):
    """8-bit moments written at 2 shards restore on one device, and those
    written on one device restore at 4 shards, ``q`` and ``s`` bitwise the
    file's; from that file 4 shards and one device train on alike (each
    step's loss and grad norm at the dense rule)."""
    cfg = get_config("granite_3_2b").reduced()
    opt = adamw.AdamWConfig(**OCFG, quantize_moments=True, q_block=32)

    def run(k, steps, name="r", **kw):
        mesh = {"device": "cpu"} if k is None else _mesh(k)
        return loop.Trainer(cfg, _tc(tmp_path, name, steps=steps, opt=opt,
                                     **kw), **mesh).run()

    def moments(flat):
        return {p: v for p, v in flat.items()
                if p.startswith("/opt/m") or p.startswith("/opt/v")}
    run(2, 3, ckpt_every=3)
    for k, step in ((None, 3), (4, 5)):
        if step == 5:
            run(None, 5, ckpt_every=5)
        out = run(k, step)
        assert out["metrics"] == []
        got = moments(ck._flatten(loop.train_state(out["params"],
                                                   out["opt"])))
        want = moments({p: ck._tensor(rec) for p, rec in ck.read_payload(
            str(tmp_path / "r"), step).items()})
        assert sorted(got) == sorted(want) and \
            any(p.endswith("/q") for p in want)
        for path, x in want.items():
            assert torch.equal(got[path], x), (k, path)
    sharded = run(4, 7, ckpt_every=100)
    ckpts = tmp_path / "r"
    for d in ckpts.iterdir():       # both resume from step 5's file
        if d.name.startswith("step_") and d.name != "step_00000005":
            shutil.rmtree(d)
    one = run(None, 7, ckpt_every=100)
    assert [m["step"] for m in sharded["metrics"]] == [5, 6]
    for got, want in zip(sharded["metrics"], one["metrics"]):
        for key in ("loss", "grad_norm", "lr"):
            _close(got[key], want[key], f"step {want['step']} {key}")


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 4), (3, 5, 2),
                                   (1, 7, 1), (4, 1, 3)])
def test_flat_boxes_cover_exactly_the_range(shape):
    a, s, c = shape
    n = a * s * c
    ids = np.arange(n).reshape(shape)
    for lo in range(n + 1):
        for hi in range(lo, n + 1):
            boxes = loop.flat_boxes(lo, hi, a, s, c)
            assert len(boxes) <= 5
            got = np.sort(np.concatenate(
                [ids[a0:a1, s0:s1, c0:c1].ravel()
                 for a0, a1, s0, s1, c0, c1 in boxes] + [np.zeros(0, int)]))
            assert np.array_equal(got, np.arange(lo, hi)), (lo, hi)
