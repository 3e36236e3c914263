"""LM training in the port (``models/lm.py`` ``loss_fn`` and ``remat``,
``repro_torch.train.loop``, ``repro_torch.launch.train``) against the JAX
package.

The reference's ``materialize_init`` weights cross into the port through
``repro_torch.convert.lm_params_from_numpy`` and come back, stacked, through
``lm_params_to_numpy``; batches are the reference's ``synth_batch`` (with
whisper's encoder frames and paligemma's patch embeddings).  At
``reduced()`` configs (float32, 2 layers, d 64; zamba2 6; whisper 2
encoder layers over 16 frames, paligemma 8 patch tokens) for every arch:

* ``loss_fn``'s loss and metrics, and every gradient leaf against
  ``jax.grad`` of the reference's ``loss_fn`` (for MoE the routing of
  every layer asserted equal first): ``allclose(rtol=1e-4, atol=1e-5 *
  scale)``, ``scale`` the largest magnitude of the reference's array (at
  least 1), as in ``test_torch_lm.py``: both sum float32 products in other
  orders;
* 5 steps of ``make_train_step`` against the reference's jitted
  ``step_fn`` at ``microbatches`` 1 and 2: each step's loss and gradient
  norm at that tolerance (AdamW's first steps move each weight by about
  the learning rate whatever its gradient's size, so a last-bit
  difference in a near-zero gradient can change a weight by ``2 lr``; the
  losses stay within the tolerance);
* ``remat`` ``"none"``, ``"full"`` and ``"dots"``: bitwise-equal
  gradients;
* the Trainer's straggler count, a 2-shard mesh and the refusal of a
  model axis (its checkpoint/restart tests are in
  ``test_torch_checkpoint.py``, data parallel in ``test_torch_dp.py``);
* the launcher in process with ``--device cpu`` (whisper and paligemma
  too), and the ``NotImplementedError``s naming their ROADMAP items.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import synth_batch as rsynth_batch
from repro.models import blocks as rblocks
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import params as rpr
from repro.optim import adamw as radamw
from repro.train import loop as rloop

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synth_batch
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
from repro_torch.launch.sharding import default_rules
from repro_torch.models import lm, moe
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.train import loop

LM_ARCHS = ["granite_3_2b", "gemma_7b", "gemma3_27b", "h2o_danube_3_4b",
            "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b", "rwkv6_3b",
            "zamba2_1p2b", "whisper_small", "paligemma_3b"]
RTOL, ATOL = 1e-4, 1e-5
# zamba2's whole-model gradients (see test_gradients_match_reference)
HYBRID_GRAD_ATOL = 1e-4
B, S = 2, 12


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


@dataclasses.dataclass
class Case:
    rcfg: object
    cfg: object
    vals: dict
    batch: dict


@pytest.fixture(scope="module", params=LM_ARCHS)
def case(request):
    rcfg = rget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                   rcfg)
    return Case(rcfg, cfg, jax.tree.map(np.asarray, vals),
                rsynth_batch(rcfg, B, S, step=3, seed=1))


def _model(case):
    return convert.lm_params_from_numpy(case.cfg, case.vals, device="cpu")


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port_grads(model, cfg, batch):
    model.requires_grad_(True)
    loss, metrics = lm.loss_fn(model, cfg, _tbatch(batch))
    loss.backward()
    grads = convert.host_stacked(pr.stack_tree(pr.tree_map(
        lambda p: p.grad, model.tree())))
    return loss, metrics, grads


# ------------------------------------------------------------------ loss
def test_loss_fn_matches_reference(case):
    want, wmetrics = rlm.loss_fn(case.vals, case.rcfg,
                                 jax.tree.map(jnp.asarray, case.batch))
    got, metrics = lm.loss_fn(_model(case), case.cfg, _tbatch(case.batch))
    _close(got.detach(), want)
    assert sorted(metrics) == sorted(wmetrics)
    for k in wmetrics:
        _close(metrics[k], wmetrics[k], k)
        assert not metrics[k].requires_grad


def test_loss_mask_and_its_absence():
    cfg = get_config("granite_3_2b").reduced()
    model = lm.init_model(cfg, device="cpu")
    batch = _tbatch(synth_batch(cfg, B, S, 0))
    full, _ = lm.loss_fn(model, cfg, batch)
    nomask, _ = lm.loss_fn(model, cfg, {k: v for k, v in batch.items()
                                        if k != "loss_mask"})
    assert torch.equal(full, nomask)
    half = dict(batch, loss_mask=batch["loss_mask"].clone())
    half["loss_mask"][:, S // 2:] = 0
    rcfg = rget_config("granite_3_2b").reduced()
    vals = convert.lm_params_to_numpy(model)
    want, _ = rlm.loss_fn(vals, rcfg, {k: jnp.asarray(v.numpy())
                                       for k, v in half.items()})
    got, _ = lm.loss_fn(model, cfg, half)
    _close(got, want)


# ------------------------------------------------------------- gradients
def _port_moe_inputs(model, cfg, tokens, monkeypatch):
    seen = []
    orig = moe.moe_replicas

    def spy(ps, xs, cfg, group_size=None):
        seen.extend(x.detach().clone() for x in xs)      # one replica
        return orig(ps, xs, cfg, group_size)
    monkeypatch.setattr(moe, "moe_replicas", spy)
    with torch.no_grad():
        lm.forward(model, cfg, {"tokens": torch.as_tensor(tokens)})
    monkeypatch.setattr(moe, "moe_replicas", orig)
    return seen


def _reference_moe_inputs(vals, rcfg, tokens, monkeypatch):
    """The reference's layers run one by one outside ``lax.scan``, so the
    MoE layers' inputs are concrete arrays."""
    seen = []
    orig = rmoe.moe

    def spy(p, x, cfg, shd=None, group_size=None):
        seen.append(np.asarray(x))
        return orig(p, x, cfg, shd=shd, group_size=group_size)
    monkeypatch.setattr(rmoe, "moe", spy)
    b, s = tokens.shape
    x = rlm._embed_tokens(vals, rcfg, jnp.asarray(tokens))
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    for i, kind in enumerate(rlm.layer_kinds(rcfg)):
        p_i = jax.tree.map(lambda a: a[i], vals["layers"])
        x, _ = rblocks.dense_layer(p_i, x, cfg=rcfg, kind_flag=int(kind),
                                   positions=positions, shd=None)
    monkeypatch.setattr(rmoe, "moe", orig)
    return seen


def test_gradients_match_reference(case, monkeypatch):
    """Every gradient leaf against ``jax.grad``.  For zamba2 (6 Mamba2
    layers and the shared block, random weights: the residual stream grows
    from 1 to ~33) float32 rounding is amplified through the backward: the
    reference's own jitted and eager gradients differ by more than the
    dense rule's ``ATOL`` (``test_torch_recurrent.py::
    test_hybrid_gradient_rounding_exceeds_the_dense_rule``).  So the
    hybrid family is held here at ``atol=HYBRID_GRAD_ATOL * scale``, and
    layer by layer, where no amplification enters, at ``ATOL``
    (``test_torch_recurrent.py::test_layer_gradients_match_reference``)."""
    model = _model(case)
    if case.cfg.family == "moe":   # the routing first: equal top-k choices
        tokens = case.batch["tokens"]
        got_x = _port_moe_inputs(model, case.cfg, tokens, monkeypatch)
        want_x = _reference_moe_inputs(case.vals, case.rcfg, tokens,
                                       monkeypatch)
        assert len(got_x) == len(want_x) == case.cfg.num_layers
        for i, (gx, wx) in enumerate(zip(got_x, want_x)):
            router = case.vals["layers"]["moe"]["router"][i]
            _, widx = jax.lax.top_k(jax.nn.softmax(
                jnp.einsum("bsd,de->bse", wx, router), -1), case.cfg.top_k)
            gidx = torch.topk(torch.softmax(torch.einsum(
                "bsd,de->bse", gx, torch.tensor(router)), -1),
                case.cfg.top_k, dim=-1).indices
            np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx),
                                          f"layer {i} routing")
    want = jax.jit(jax.grad(lambda p: rlm.loss_fn(p, case.rcfg, jax.tree.map(
        jnp.asarray, case.batch))[0]))(jax.tree.map(jnp.asarray, case.vals))
    _, _, got = _port_grads(model, case.cfg, case.batch)
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    atol = HYBRID_GRAD_ATOL if case.cfg.family == "hybrid" else ATOL
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        _close(got[path], want[path], path, atol=atol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_modes_give_bitwise_equal_gradients(arch):
    cfg0 = get_config(arch).reduced()
    batch = synth_batch(cfg0, B, S, 0)
    got = {}
    for remat in ("none", "full", "dots"):
        cfg = cfg0.replace(remat=remat)
        model = lm.init_model(cfg, generator=torch.Generator().manual_seed(2),
                              device="cpu")
        loss, _, grads = _port_grads(model, cfg, batch)
        got[remat] = (loss.detach(), _flat(grads))
    for remat in ("full", "dots"):
        assert torch.equal(got[remat][0], got["none"][0])
        for path, g in got["none"][1].items():
            assert torch.equal(got[remat][1][path], g), (remat, path)


def test_remat_checkpoints_only_under_autograd(monkeypatch):
    calls = []
    monkeypatch.setattr(lm.ckpt, "checkpoint",
                        lambda fn, *a, **kw: calls.append(kw) or fn(
                            *a, **{k: v for k, v in kw.items()
                                   if k not in ("use_reentrant",
                                                "context_fn")}))
    cfg = get_config("granite_3_2b").reduced().replace(remat="dots")
    model = lm.init_model(cfg, device="cpu")
    batch = _tbatch(synth_batch(cfg, B, S, 0))
    with torch.no_grad():
        lm.loss_fn(model, cfg, batch)
    assert calls == []
    model.requires_grad_(True)
    lm.loss_fn(model, cfg, batch)
    assert len(calls) == cfg.num_layers and "context_fn" in calls[0]
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(model, cfg.replace(remat="most"), batch)


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_2b", "gemma3_27b",
                                  "qwen3_moe_235b_a22b", "rwkv6_3b",
                                  "zamba2_1p2b", "whisper_small",
                                  "paligemma_3b"])
def test_train_steps_match_reference(arch, microbatches):
    """Five AdamW steps against the reference's jitted ones.  zamba2's
    steps each start from the reference's parameters and moments: its
    rounding (see test_gradients_match_reference) is amplified by AdamW's
    near-sign updates, so free-running runs part within a step or two. The
    reference's own eager and jitted steps differ by 1.2e-3 of the grad
    norm at step 1, and the port's lies between them (seed 1, 4 x 12
    tokens).  Its loss is held at the dense rule, its grad norm and both
    moments at ``HYBRID_GRAD_ATOL``.  whisper's steps start from the
    reference's state too, all held at the dense rule: free-running (seed
    1, 4 x 12 tokens), the reference's own eager and jitted grad norms
    (~370, from its random tied embedding's large logits) part by up to
    1.02e-4 of it (step 1), the rule's whole ``rtol``, and the port's
    part from the jitted ones by 7.4e-5 to 1.9e-4 over steps 1-4."""
    rcfg = rget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                   rcfg)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    roc = radamw.AdamWConfig(**ocfg)
    rstep = jax.jit(rloop.make_train_step(rcfg, roc,
                                          microbatches=microbatches))
    model = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals),
                                         device="cpu")
    oc = adamw.AdamWConfig(**ocfg)
    step = loop.make_train_step(cfg, oc, microbatches=microbatches)
    rstate, state = radamw.init(vals, roc), adamw.init(model.tree(), oc)
    resync = cfg.family in ("hybrid", "encdec")
    atol = HYBRID_GRAD_ATOL if cfg.family == "hybrid" else ATOL
    for i in range(5):
        batch = rsynth_batch(rcfg, 4, S, step=i)
        if resync:          # this step starts where the reference's does
            convert.load_stacked(model, pr.tree_map(
                lambda a: torch.tensor(np.asarray(a)), vals))
            for k in ("m", "v"):
                for dst, src in zip(
                        pr.leaves_like(state[k], state[k]),
                        pr.leaves_like(state[k], rstate[k])):
                    dst.copy_(torch.tensor(np.asarray(src)))
        vals, rstate, want = rstep(vals, rstate, batch)
        state, got = step(model, state, _tbatch(batch))
        assert sorted(got) == sorted(want)
        _close(got["loss"], want["loss"], f"step {i} loss")
        _close(got["grad_norm"], want["grad_norm"], f"step {i} grad norm",
               atol=atol)
        if resync:
            for k in ("m", "v"):
                g, w = _flat(state[k]), _flat(rstate[k])
                assert sorted(g) == sorted(w)
                for path in w:
                    _close(g[path], w[path], f"step {i} {k}{path}",
                           atol=atol)
        assert all(p.grad is None for p in model.parameters())
    assert int(state["step"]) == 5


# ----------------------------------------------------------- the Trainer
def _tc(tmp_path, **kw):
    base = dict(steps=10, batch=2, seq=16, ckpt_every=1000,
                ckpt_dir=str(tmp_path), log_every=1000, async_ckpt=False)
    return loop.TrainConfig(**{**base, **kw})


def test_stragglers_are_counted(tmp_path, monkeypatch):
    cfg = get_config("granite_3_2b").reduced().replace(num_layers=1)
    ticks = iter(np.cumsum([0, 1, 0, 1, 0, 1, 0, 10, 0, 1]).tolist())

    class Clock:
        @staticmethod
        def perf_counter():
            return next(ticks)
    monkeypatch.setattr(loop, "time", Clock)
    out = loop.Trainer(cfg, _tc(tmp_path, steps=5), device="cpu").run()
    assert out["stragglers"] == 1
    assert [m.get("straggler", False) for m in out["metrics"]] == \
        [False, False, False, True, False]


def test_trainer_trains_on_a_mesh_and_refuses_a_model_axis(tmp_path):
    """A 2-shard simulated mesh with rules trains (data parallel, the
    parameters FSDP-sharded; ``test_torch_dp.py`` holds it to the
    reference); a mesh whose model axis is above 1 raises, citing ROADMAP
    item 21 (tensor-parallel compute)."""
    cfg = get_config("granite_3_2b").reduced()
    two = make_shard_mesh(2, device="cpu", simulate=True)
    out = loop.Trainer(cfg, _tc(tmp_path, steps=3), mesh=two,
                       rules=default_rules(two)).run()
    assert len(out["metrics"]) == 3 and all(
        np.isfinite(m["loss"]) for m in out["metrics"])
    embed = out["data_parallel"].params["embed"]
    assert [tuple(p.shape) for p in embed.pieces] == \
        [(cfg.vocab_size, cfg.d_model // 2)] * 2
    tp = ShardMesh(devices=(torch.device("cpu"),) * 2, data=1, model=2,
                   simulated=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        loop.Trainer(cfg, _tc(tmp_path), mesh=tp)
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        loop.Trainer(cfg, _tc(tmp_path), mesh=tp, rules=default_rules(tp))
    one = ShardMesh(devices=(torch.device("cpu"),), data=1)
    assert loop.Trainer(cfg, _tc(tmp_path), mesh=one).device.type == "cpu"


# ------------------------------------------------------------ the launcher
def test_train_launcher_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "qwen3-moe-235b-a22b", "--preset", "tiny",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[train] step=0 loss=" in text and "[train] done: 3 steps" in text
    assert len(out["metrics"]) == 3 and out["params"].cfg.num_experts == 8
    assert ck.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_train_launcher_trains_the_modality_families(arch, tmp_path,
                                                     capsys):
    """The launcher's ``tiny`` preset keeps the published ``enc_len`` /
    ``num_prefix``, as the reference's does (seq 16 here: the encoder's
    1,500 frames set the step's cost)."""
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--preset", "tiny", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[train] done: 3 steps" in text
    cfg = out["params"].cfg
    assert (cfg.enc_len, cfg.num_prefix) == (
        get_config(arch).enc_len, get_config(arch).num_prefix)
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert ck.latest_step(str(tmp_path)) == 3


def test_train_launcher_production_mesh_raises():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="ROADMAP item 20"):
        train.main(["--production-mesh", "--device", "cpu"])
