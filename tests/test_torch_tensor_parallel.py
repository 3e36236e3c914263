"""Compute over the mesh's model axis in the port (tensor, expert and vocab
parallel pieces: ``repro_torch.launch.tensor_parallel``, ``DataParallel`` /
``Trainer`` over a ``(data, model)`` mesh, ``engine.generate`` over
``ModelPieces``) against the JAX package.

GSPMD computes the reference's global program on any mesh, so the
reference's *single-device* run is the oracle for the port's pieces.  On
simulated CPU meshes (``make_simulated_mesh(data, model, device="cpu")``,
``default_rules``) of ``(1, 2)``, ``(1, 4)`` and ``(2, 2)``, and on one
device (``None``), from the reference's ``materialize_init`` weights (seed
1) and its ``synth_batch`` data, at ``test_torch_dp.py``'s rule
(``rtol=1e-4, atol=1e-5 x scale``; the gradients on
``test_torch_train.py``'s gradient batch of 2 rows: on 4 rows the port's
*one-device* granite ``wk`` gradient already lies 1.1 of the rule from
the reference's on one element of 2,048):

* the forward logits (over ``ModelPieces``), the loss and its metrics, and
  every gradient joined from the reduce-scattered pieces, for granite
  ``reduced()`` (1 kv head: the kv heads whole in every piece while the q
  heads are cut), granite at ``vocab_size=257`` (the vocabulary whole)
  and at 6 q heads on 3 kv heads (a piece's q heads span kv groups
  unevenly; at (1, 4) every head is whole),
  gemma-7b ``reduced()`` (tied, GeGLU, ``embed_scale``), gemma3-27b at 7
  layers (``local_global``, kinds ``1 1 1 1 1 0 1``), h2o-danube-3-4b
  (``swa``), qwen3-moe ``reduced()`` and kimi-k2 at 16 experts, top-8,
  capacity factor 16;
* 5 train steps of granite and qwen3-moe on ``(1, 2)``, ``(1, 4)`` and
  ``(2, 2)`` against the reference's jitted step: each step's loss and
  metrics, and after step 1 every float32 moment, and every weight as
  AdamW's step on those moments; the ``Trainer`` over a mesh against the
  ``Trainer`` on one device, alike;
* greedy ``generate`` in float32: tokens equal to the reference's, and
  teacher-forced on them the prefill's and each decode step's logits
  against the reference's, past the window for gemma3 and danube;
* the all-reduces, all-gathers and reduce-scatters a step counts equal to
  an analytic count of one device's program (``remat="full"`` re-runs
  each layer's forward, and its sums, in the backward), with float32 and
  with 8-bit moments (the flat run's data-axis sum and its assembly from
  the model pieces);
* elastic restarts from ``(2, 2)`` onto ``(1, 1)``, ``(1, 2)`` and
  ``(2, 1)``;
* ``copy_flat_range`` into a piece cut in two dimensions.

8-bit moments over model pieces are held to the reference in
``test_torch_tensor_parallel_q8.py``.

The ssm, hybrid, encdec and vlm families over the model axis are held in
``test_torch_tensor_parallel_families.py``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import synth_batch as rsynth_batch
from repro.models import lm as rlm
from repro.models import params as rpr
from repro.optim import adamw as radamw
from repro.serve import engine as rengine
from repro.train import loop as rloop

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synth_batch
from repro_torch.launch import sharding as sh
from repro_torch.launch import step_analysis as sa
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import make_simulated_mesh
from repro_torch.models import lm, moe
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import loop

RTOL, ATOL = 1e-4, 1e-5            # test_torch_dp.py's dense rule
B, S = 4, 12          # the train steps' batch (test_torch_dp.py's)
GRAD_B = 2            # test_torch_train.py's gradient batch (step 3, seed 1)
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=5)
CASES = {
    "granite": ("granite_3_2b", {}),
    "granite_vocab_257": ("granite_3_2b", {"vocab_size": 257}),
    # 6 q heads on 3 kv heads: at (1, 2) a piece's 3 q heads read kv heads
    # 0, 0, 1 and 1, 2, 2 (no group size); at (1, 4) the heads stay whole
    "granite_6_heads_3_kv": ("granite_3_2b", {"num_heads": 6,
                                              "num_kv_heads": 3}),
    "gemma_7b": ("gemma_7b", {}),
    "gemma3_7_layers": ("gemma3_27b", {"num_layers": 7}),
    "danube": ("h2o_danube_3_4b", {}),
    "qwen3_moe": ("qwen3_moe_235b_a22b", {}),
    "kimi_top_8": ("kimi_k2_1t_a32b", {"num_experts": 16, "top_k": 8,
                                       "capacity_factor": 16.0}),
}
MESHES = [None, (1, 2), (1, 4), (2, 2)]


def _close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)


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
class Reference:
    rcfg: object
    cfg: object
    vals: dict          # the weights, numpy
    axes: dict          # their logical axes (stacked layout)
    batch: dict         # numpy
    logits: np.ndarray
    metrics: dict
    grads: dict         # flat path -> numpy


@functools.lru_cache(maxsize=None)
def _reference(name) -> Reference:
    arch, over = CASES[name]
    rcfg = rget_config(arch).reduced().replace(**over)
    cfg = get_config(arch).reduced().replace(**over)
    vals, axes = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                      rcfg)
    batch = rsynth_batch(rcfg, GRAD_B, S, step=3, seed=1)
    jb = jax.tree.map(jnp.asarray, batch)

    def run(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: rlm.loss_fn(q, rcfg, jb), has_aux=True)(p)
        return rlm.forward(p, rcfg, {"tokens": jb["tokens"]})[0], loss, \
            metrics, grads
    logits, loss, metrics, grads = jax.jit(run)(vals)
    return Reference(
        rcfg, cfg, jax.tree.map(np.asarray, vals),
        jax.tree.map(tuple, axes, is_leaf=lambda x: isinstance(x, tuple)),
        batch, np.asarray(logits),
        dict({k: float(v) for k, v in metrics.items()}, loss=float(loss)),
        {p: np.asarray(v) for p, v in _flat(grads).items()})


def _model(ref):
    return convert.lm_params_from_numpy(ref.cfg, ref.vals, device="cpu",
                                        axes=ref.axes)


def _shd(mesh):
    m = make_simulated_mesh(*mesh, device="cpu")
    return sh.Shd(m, sh.default_rules(m))


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _mesh_id(mesh):
    return "one_device" if mesh is None else f"{mesh[0]}x{mesh[1]}"


# ------------------------------------------------- forward, loss, grads
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_match_reference(name, mesh):
    ref = _reference(name)
    model = _model(ref)
    p = model if mesh is None else tp.ModelPieces(model, _shd(mesh))
    with torch.no_grad():
        got, _ = lm.forward(p, ref.cfg, {"tokens": torch.as_tensor(
            ref.batch["tokens"])})
    assert tuple(got.shape) == ref.logits.shape
    _close(got, ref.logits, f"{name} {mesh} logits")
    if mesh is not None:       # the vocab blocks were gathered once
        n = 1 if ref.cfg.vocab_size % mesh[1] == 0 else 0
        assert p.collectives["all-gather"]["count"] == n + (
            ref.cfg.num_layers if ref.cfg.family == "moe" else 0)


def _step_grads(ref, mesh, monkeypatch):
    """One train step of the port over ``mesh`` -> (metrics, the
    gradients handed to AdamW, joined, flat, and the DataParallel)."""
    dp = loop.DataParallel(_model(ref), _shd(mesh))
    oc = adamw.AdamWConfig(**OCFG)
    seen = {}
    update = adamw.update

    def spy(params, grads, st, c):
        seen["grads"] = convert.host_stacked(pr.stack_tree(grads))
        return update(params, grads, st, c)
    monkeypatch.setattr(adamw, "update", spy)
    step = loop.make_train_step(ref.cfg, oc, shd=dp.shd)
    _, metrics = step(dp, adamw.init(dp.tree(), oc), _tbatch(ref.batch))
    return metrics, _flat(seen["grads"]), dp


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_reference(name, mesh, monkeypatch):
    ref = _reference(name)
    if mesh is None:
        model = _model(ref)
        model.requires_grad_(True)
        loss, metrics = lm.loss_fn(model, ref.cfg, _tbatch(ref.batch))
        loss.backward()
        metrics = dict(metrics, loss=loss.detach())
        got = _flat(convert.host_stacked(pr.stack_tree(pr.tree_map(
            lambda p: p.grad, model.tree()))))
    else:
        metrics, got, dp = _step_grads(ref, mesh, monkeypatch)
        assert all(p.grad is None for m in dp.models for p in m.parameters())
    for key, want in ref.metrics.items():
        _close(metrics[key], want, f"{name} {mesh} {key}")
    assert sorted(got) == sorted(ref.grads)
    for path, want in ref.grads.items():
        assert tuple(got[path].shape) == want.shape, path
        _close(got[path], want, f"{name} {mesh} grad {path}")


def test_pieces_hold_their_blocks_of_the_rules():
    """granite at (1, 2): q heads, mlp and vocab cut in two, the one kv
    head whole in both pieces; qwen3-moe at (2, 2): 4 of 8 experts and
    their router columns a piece, d_model cut over data."""
    ref = _reference("granite")
    dp = loop.DataParallel(_model(ref), _shd((1, 2)))
    layer = [m["layers"][0] for m in dp.models]
    assert [tuple(x["attn"]["wq"].shape) for x in layer] == [(64, 2, 16)] * 2
    assert [tuple(x["attn"]["wk"].shape) for x in layer] == [(64, 1, 16)] * 2
    assert [tuple(x["mlp"]["w_down"].shape) for x in layer] == [(64, 64)] * 2
    assert [tuple(m.embed.shape) for m in dp.models] == [(128, 64)] * 2
    ref = _reference("qwen3_moe")
    dp = loop.DataParallel(_model(ref), _shd((2, 2)))
    moe = dp.params["layers"][0]["moe"]
    assert [tuple(p.shape) for p in moe["w_up"].pieces] == [(4, 32, 64)] * 4
    assert [tuple(p.shape) for p in moe["router"].pieces] == [(32, 4)] * 4
    assert [tuple(m["layers"][0]["moe"]["router"].shape)
            for m in dp.models] == [(64, 4)] * 4
    assert all(p.numel() == 0 for p in dp.whole_model.parameters())
    whole = dp.whole()
    for path, x in _flat(convert.host_stacked(pr.stack_tree(
            whole.tree()))).items():
        np.testing.assert_array_equal(x.numpy(), _flat(ref.vals)[path])


# ------------------------------------------------------------ train steps
@functools.lru_cache(maxsize=None)
def _reference_steps(name):
    ref = _reference(name)
    roc = radamw.AdamWConfig(**OCFG)
    rstep = jax.jit(rloop.make_train_step(ref.rcfg, roc))
    vals = jax.tree.map(jnp.asarray, ref.vals)
    rstate = radamw.init(vals, roc)
    out = []
    for i in range(5):
        b = rsynth_batch(ref.rcfg, B, S, step=i)
        vals, rstate, want = rstep(vals, rstate, b)
        out.append((b, {k: float(v) for k, v in want.items()},
                    {k: _flat(jax.tree.map(np.asarray, rstate[k]))
                     for k in ("m", "v")}))
    return out


def _adamw_step_of_own_moments(w0, w1, m, v, oc, what):
    """A weight after AdamW's first step against that step taken (in
    float64) from its initial value on its run's own moments: at random
    init a near-zero gradient's rounding flips the sign of ``lr g / (|g| +
    eps)``, so the weights of two runs part by ``2 lr`` there whatever
    their moments' agreement (``ROADMAP.md`` §3)."""
    w0, m, v = (np.asarray(x, np.float64) for x in (w0, m, v))
    lr = float(adamw.schedule(oc, 1))
    c1, c2 = 1 - oc.b1, 1 - oc.b2
    want = w0 - lr * ((m / c1) / (np.sqrt(v / c2) + oc.eps) +
                      oc.weight_decay * w0)
    _close(w1, want, what)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)], ids=_mesh_id)
@pytest.mark.parametrize("name", ["granite", "qwen3_moe"])
def test_train_steps_match_reference(name, mesh):
    """5 steps: each step's loss and metrics against the reference's;
    after step 1 every float32 moment (joined from pieces cut in two
    dimensions at (2, 2)) against the reference's, and every weight as
    AdamW's step on those moments."""
    ref = _reference(name)
    dp = loop.DataParallel(_model(ref), _shd(mesh))
    oc = adamw.AdamWConfig(**OCFG)
    step = loop.make_train_step(ref.cfg, oc, shd=dp.shd)
    state = adamw.init(dp.tree(), oc)
    for i, (batch, want, moments) in enumerate(_reference_steps(name)):
        state, got = step(dp, state, _tbatch(batch))
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], f"step {i} {key}")
        if i:
            continue
        mine = {key: _flat(pr.stacked_map(lambda x: x.join(), state[key]))
                for key in ("m", "v")}
        for key in ("m", "v"):
            for path, x in moments[key].items():
                assert mine[key][path].dtype == torch.float32
                _close(mine[key][path], x, f"step {i} {key}{path}")
        weights = _flat(convert.host_stacked(pr.stack_tree(dp.tree())))
        for path, w0 in _flat(ref.vals).items():
            _adamw_step_of_own_moments(w0, weights[path], mine["m"][path],
                                       mine["v"][path], oc,
                                       f"step {i} weight {path}")
    assert int(state["step"]) == 5


def _tc(tmp_path, name, **kw):
    base = dict(steps=3, batch=B, seq=S, ckpt_every=1000,
                ckpt_dir=str(tmp_path / name), log_every=1000,
                async_ckpt=False, opt=adamw.AdamWConfig(**OCFG))
    return loop.TrainConfig(**{**base, **kw})


def _mesh_kw(mesh):
    if mesh is None or mesh == (1, 1):
        return {"device": "cpu"}
    m = make_simulated_mesh(*mesh, device="cpu")
    return {"mesh": m, "rules": sh.default_rules(m)}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_mesh_id)
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_trainer_on_a_mesh_matches_one_device(arch, mesh, tmp_path):
    """``Trainer(cfg, tc, mesh=, rules=default_rules(mesh)).run()`` against
    the Trainer on one device from the same seed: 3 steps' loss, grad
    norm and lr at the dense rule; after 1 step the moments at the dense
    rule and each weight (gathered whole into the returned model) as
    AdamW's step on its own moments."""
    cfg = get_config(arch).reduced()
    one = loop.Trainer(cfg, _tc(tmp_path, "one"), device="cpu").run()
    out = loop.Trainer(cfg, _tc(tmp_path, "tp"), **_mesh_kw(mesh)).run()
    assert out["data_parallel"].groups is not None
    assert [m["step"] for m in out["metrics"]] == [0, 1, 2]
    for a, b in zip(out["metrics"], one["metrics"]):
        for key in ("loss", "grad_norm", "lr"):
            _close(a[key], b[key], f"step {b['step']} {key}")
    one = loop.Trainer(cfg, _tc(tmp_path, "one1", steps=1),
                       device="cpu").run()
    out = loop.Trainer(cfg, _tc(tmp_path, "tp1", steps=1),
                       **_mesh_kw(mesh)).run()
    w0 = _flat(convert.host_stacked(pr.stack_tree(lm.init_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)
    ).tree())))
    w1 = _flat(convert.host_stacked(pr.stack_tree(out["params"].tree())))
    mine = {key: _flat(pr.stacked_map(lambda x: x.join(), out["opt"][key]))
            for key in ("m", "v")}
    for key in ("m", "v"):
        for path, x in _flat(one["opt"][key]).items():
            _close(mine[key][path], x, f"{key}{path}")
    for path, w in w0.items():
        _adamw_step_of_own_moments(w, w1[path], mine["m"][path],
                                   mine["v"][path], _tc(tmp_path, "x").opt,
                                   path)


@pytest.mark.parametrize("then", [(1, 1), (1, 2), (2, 1)], ids=_mesh_id)
def test_elastic_restart_from_a_2_x_2_mesh(then, tmp_path):
    """3 steps on (2, 2) with a checkpoint; a fresh Trainer on ``then``
    resumed to 6, against 6 straight there: every resumed step's loss,
    grad norm and lr at the dense rule."""
    cfg = get_config("qwen3_moe_235b_a22b").reduced()
    loop.Trainer(cfg, _tc(tmp_path, "r", ckpt_every=3),
                 **_mesh_kw((2, 2))).run()
    assert ck.latest_step(str(tmp_path / "r")) == 3
    resumed = loop.Trainer(cfg, _tc(tmp_path, "r", steps=6),
                           **_mesh_kw(then)).run()
    straight = loop.Trainer(cfg, _tc(tmp_path, "s", steps=6),
                            **_mesh_kw(then)).run()
    assert [m["step"] for m in resumed["metrics"]] == [3, 4, 5]
    for got, want in zip(resumed["metrics"], straight["metrics"][3:]):
        for key in ("loss", "grad_norm", "lr"):
            _close(got[key], want[key], f"step {want['step']} {key}")
    for (name, p), q in zip(resumed["params"].named_parameters(),
                            straight["params"].parameters()):
        assert p.shape == q.shape and p.dtype == q.dtype, name


# --------------------------------------------------------------- generate
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_mesh_id)
@pytest.mark.parametrize("name", ["granite", "gemma_7b", "gemma3_7_layers",
                                  "danube", "qwen3_moe", "kimi_top_8"])
def test_generate_over_pieces_matches_reference(name, mesh):
    """Greedy tokens equal to the reference's ``generate``; teacher-forced
    on them, the prefill's and each decode step's logits against the
    reference's ``prefill`` / ``decode_step`` (the prompt of 4 plus 12
    steps passes the window of 8)."""
    ref = _reference(name)
    prompt, steps, max_len, tokens, logits = _reference_decode(name)
    mp = tp.ModelPieces(_model(ref), _shd(mesh))
    got, cache = engine.generate(mp, ref.cfg,
                                 {"tokens": torch.as_tensor(prompt)},
                                 steps=steps, max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), tokens)
    assert all(isinstance(x, sh.Sharded) for x in cache.values())
    full = np.concatenate([prompt, tokens], axis=1)
    with torch.no_grad():
        cache, last = engine.prefill(mp, ref.cfg,
                                     {"tokens": torch.as_tensor(prompt)},
                                     max_len)
        _close(last, logits[0], f"{name} prefill")
        for i, want in enumerate(logits[1:]):
            pos = prompt.shape[1] + i
            got, cache = lm.decode_step(
                mp, ref.cfg, cache, torch.as_tensor(full[:, pos:pos + 1]),
                pos)
            _close(got, want, f"{name} decode {pos}")
    if ref.cfg.window:
        assert cache["k_local"].shape[2] == ref.cfg.window
        assert cache["k_local"].pieces[0].shape[2] == ref.cfg.window


@functools.lru_cache(maxsize=None)
def _reference_decode(name):
    """The reference's greedy tokens from a 4-token prompt, and teacher-
    forced on them its prefill's and decode steps' logits."""
    ref = _reference(name)
    prompt, steps = ref.batch["tokens"][:, :4], 12
    max_len = 4 + steps + 2
    tokens, _ = rengine.generate(ref.vals, ref.rcfg,
                                 {"tokens": jnp.asarray(prompt)}, steps=steps,
                                 max_len=max_len)
    tokens = np.asarray(tokens)
    full = np.concatenate([prompt, tokens], axis=1)
    cache, last = jax.jit(lambda v, t: rengine.prefill(
        v, ref.rcfg, {"tokens": t}, max_len))(ref.vals, jnp.asarray(prompt))
    step = jax.jit(lambda v, c, t, pos: rlm.decode_step(v, ref.rcfg, c, t,
                                                        pos))
    logits = [np.asarray(last)]
    for pos in range(4, 4 + steps - 1):
        out, cache = step(ref.vals, cache, jnp.asarray(full[:, pos:pos + 1]),
                          pos)
        logits.append(np.asarray(out))
    return prompt, steps, max_len, tokens, logits


# ------------------------------------------------------------ collectives
def _model_axis_counts(cfg, mesh, remat: str, batch: int,
                       whole_leaves: bool = True) -> dict:
    """The sums over the model pieces of one train step of ``cfg`` on a
    ``(data, model)`` mesh in one device's program (data replica 0's
    group), reckoned from the program: (count, bytes) by kind.
    ``whole_leaves``: with the float32 moments' all-reduce of the
    gradients of leaves whole in every piece."""
    d, m = mesh
    out = {"all-reduce": [0, 0], "all-gather": [0, 0]}

    def add(kind, n, shape, item):
        out[kind][0] += n
        out[kind][1] += n * math.prod(shape) * item

    b = batch // d
    act = (b, S, cfg.d_model)
    twice = 2 if remat == "full" else 1     # the layer forward, recomputed
    vocab = cfg.vocab_size % m == 0
    heads = cfg.num_heads % m == 0
    if vocab:
        add("all-reduce", 1, act, 4)             # lookup
        add("all-reduce", 1, act, 4)             # logits' copy-in
        add("all-reduce", 3, (b, S), 4)          # max, sum, label logit
    for _ in range(cfg.num_layers):
        if heads:
            add("all-reduce", twice + 1, act, 4)
        if cfg.family == "moe":
            e_cut = cfg.num_experts % m == 0
            if e_cut:    # the rows' and gates' copy-in, the logits
                add("all-reduce", 1, (b * S, cfg.d_model), 4)
                add("all-reduce", 1, (b * S, cfg.top_k), 4)
                add("all-gather", twice, (b * S, cfg.num_experts), 4)
        elif cfg.d_ff % m == 0:
            add("all-reduce", twice + 1, act, 4)
    if cfg.family == "moe" and cfg.num_experts % m == 0:
        t = batch * S          # the shares of the groups replica 0 holds
        g = moe._group_count(t, cfg.moe_group_size)
        mine = min(g, -(-(t // d) // (t // g)))
        add("all-reduce", twice * mine * cfg.num_layers, (t // g,
                                                          cfg.d_model), 4)
    if whole_leaves and heads and cfg.num_kv_heads % m:
        add("all-reduce", 2 * cfg.num_layers,    # kv heads whole in every
            (cfg.d_model, cfg.num_kv_heads, cfg.head_dim), 4)   # piece
    return out


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)], ids=_mesh_id)
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_counted_collectives_equal_an_analytic_count(arch, mesh, remat):
    """One step's counted collectives = the data axis's (the dry run's
    ``reckon_collectives``) + the model axis's sums (:func:`_model_axis_
    counts`), count and bytes."""
    cfg = get_config(arch).reduced().replace(remat=remat)
    shd = _shd(mesh)
    model = lm.init_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    leaves = sa.stacked_leaves(model.tree(), model.axes)
    dp = loop.DataParallel(model, shd)
    oc = adamw.AdamWConfig()
    step = loop.make_train_step(cfg, oc, shd=shd)
    state = adamw.init(dp.tree(), oc)
    data = {k: torch.as_tensor(x) for k, x in
            synth_batch(cfg, B, S, 0).items()}
    dp.reset_collectives()
    step(dp, state, data)
    want = sa.reckon_collectives(shd, leaves, "train", split=True)
    for kind, (n, nbytes) in _model_axis_counts(cfg, mesh, remat,
                                                B).items():
        want[kind]["count"] += n
        want[kind]["bytes"] += nbytes
    assert dp.collectives == {c: want[c] for c in sa.COLLECTIVES}


def _assembly_counts(cfg, shd, leaves, q_block: int) -> dict:
    """The model axis's collectives of the 8-bit update on device 0: per
    stacked leaf cut over ``model``, its float32 gradient run and its
    parameter run gathered from the pieces; per leaf whole in every piece
    that several pieces compute with (the kv heads where the q heads are
    cut and they are not), its gradient run summed."""
    out = {"all-reduce": [0, 0], "all-gather": [0, 0]}
    heads = cfg.num_heads % shd.mesh.shape["model"] == 0
    for shape, _, dtype, axes in leaves:
        n_el = math.prod(shape)
        nb = -(-n_el // q_block)
        acc = sa.piece_numel(sh.blocks_placement(shd, nb, q_block),
                             (nb, q_block))
        item = torch.empty((), dtype=dtype).element_size()
        sums = []
        if "model" in shd.spec(axes, shape):
            sums = [("all-gather", acc * 4),
                    ("all-gather", min(acc, n_el) * item)]
        elif heads and "kv_heads" in axes:
            sums = [("all-reduce", acc * 4)]
        for kind, nbytes in sums:
            out[kind][0] += 1
            out[kind][1] += nbytes
    return out


@pytest.mark.parametrize("q_block", [32, 48])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_mesh_id)
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_counted_8_bit_collectives_equal_an_analytic_count(arch, mesh,
                                                           q_block):
    """One 8-bit step's counted collectives = the data axis's flat
    reduce-scatter and all-to-all (``reckon_collectives``) + the model
    axis's sums of the program + the assembly of each device's run."""
    cfg = get_config(arch).reduced().replace(remat="full")
    shd = _shd(mesh)
    model = lm.init_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    leaves = sa.stacked_leaves(model.tree(), model.axes)
    dp = loop.DataParallel(model, shd)
    oc = adamw.AdamWConfig(quantize_moments=True, q_block=q_block)
    step = loop.make_train_step(cfg, oc, shd=shd)
    state = adamw.init(dp.tree(), oc, shd=shd)
    data = {k: torch.as_tensor(x) for k, x in
            synth_batch(cfg, B, S, 0).items()}
    dp.reset_collectives()
    step(dp, state, data)
    want = sa.reckon_collectives(shd, leaves, "train", q_block=q_block,
                                 split=True)
    for counts in (_model_axis_counts(cfg, mesh, "full", B,
                                      whole_leaves=False),
                   _assembly_counts(cfg, shd, leaves, q_block)):
        for kind, (n, nbytes) in counts.items():
            want[kind]["count"] += n
            want[kind]["bytes"] += nbytes
    assert dp.collectives == {c: want[c] for c in sa.COLLECTIVES}


def test_copy_flat_range_fills_a_piece_cut_in_two_dimensions():
    """Every flat range of a (4, 6, 5) tensor copied into each piece of a
    (2, 3) cut of its first two dimensions (as ``data`` on ``embed`` and
    ``model`` on heads cut a parameter) writes exactly the range's
    elements of that block, from the whole tensor and from a flat run of
    it alike."""
    src = torch.arange(120, dtype=torch.float32).reshape(4, 6, 5)
    flat = src.reshape(-1)
    for a in range(2):
        for b in range(3):
            block = (slice(2 * a, 2 * a + 2), slice(2 * b, 2 * b + 2),
                     slice(0, 5))
            ids = src[block]
            for lo, hi in ((0, 120), (7, 61), (33, 34), (50, 119),
                           (60, 60)):
                want = torch.where((ids >= lo) & (ids < hi), ids, -1.0)
                for run in (None, (lo, flat[lo:hi].clone())):
                    got = torch.full((2, 2, 5), -1.0)
                    if run is None:
                        loop.copy_flat_range(got, src, block, lo, hi)
                    else:
                        loop.copy_flat_range(got, run[1], block, lo, hi,
                                             src.shape, run[0])
                    assert torch.equal(got, want), (a, b, lo, hi)


def test_replicated_rules_give_the_single_device_program(monkeypatch):
    """With ``replicated_rules`` nothing is cut over ``model``: the lead
    piece computes everything, no sum over the pieces runs, and the step
    is the reference's at the dense rule."""
    ref = _reference("qwen3_moe")
    mesh = make_simulated_mesh(1, 2, device="cpu")
    shd = sh.Shd(mesh, sh.replicated_rules(mesh))
    dp = loop.DataParallel(_model(ref), shd)
    assert all(tuple(a.shape) == tuple(b.shape) for a, b in zip(
        dp.models[0].parameters(), dp.models[1].parameters()))
    oc = adamw.AdamWConfig(**OCFG)
    _, metrics = loop.make_train_step(ref.cfg, oc, shd=shd)(
        dp, adamw.init(dp.tree(), oc), _tbatch(ref.batch))
    _close(metrics["loss"], ref.metrics["loss"])
    assert all(v["count"] == 0 for v in dp.collectives.values())
