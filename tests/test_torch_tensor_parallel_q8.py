"""8-bit AdamW moments on a ``(data, model)`` mesh whose model axis is
above 1, for every model family, against the JAX package.

The reference keeps one layout on any mesh: ``q`` (int8) and ``s``
(float32) are blocks of the flat stacked leaf, their dim 0 cut over
``data`` and replicated over ``model``.  So a device's run of blocks
spans pieces that the rules cut over ``model``: ``DataParallel`` sums
its run of the gradient over ``data``, assembles it from its data
replica's model pieces, updates that run identically on every model
replica and copies the new values into the pieces cut in two dimensions.

On simulated CPU meshes ``(1, 2)`` and ``(2, 2)`` (``default_rules``),
for granite, qwen3-moe, rwkv6, zamba2, whisper and paligemma at
``reduced()`` from the reference's ``materialize_init`` weights (seed 1),
with ``q_block`` 32 and at ``(2, 2)`` also 48 (blocks a leaf's run does
not hold whole, and leaves whose blocks the data axis does not divide):

* two steps, each step's update, given the gradients the step assembled,
  against the reference's single-device 8-bit ``adamw.update`` from the
  same parameters and moments at ``test_torch_optim.py``'s 8-bit rule
  (unclipped; ``q`` equal, ``s`` and the parameters at the dense rule),
  and bitwise the port's single-device 8-bit update on the same
  gradients; every model replica's ``q`` and ``s`` bitwise equal; the
  assembled gradients bitwise the float32-moment step's joined gradients
  (which ``test_torch_tensor_parallel*.py`` hold to the reference);
* ``q`` / ``s`` written at ``(2, 2)`` restore bitwise at ``(1, 1)``,
  ``(2, 1)`` and ``(1, 2)``, and those written there restore bitwise at
  ``(2, 2)``;
* the train launcher (``--simulated-mesh DATA MODEL --opt-8bit``) trains
  a step of every family's ``tiny`` preset with 8-bit moments over model
  pieces (whisper's 1,500 frames set its cost).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import lm as rlm
from repro.models import params as rpr
from repro.optim import adamw as radamw

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synth_batch
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_simulated_mesh
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.train import loop

RTOL, ATOL = 1e-4, 1e-5            # test_torch_dp.py's dense rule
B, S = 4, 12
Q8 = dict(lr=3e-3, warmup_steps=2, total_steps=5, clip_norm=1e9,
          quantize_moments=True)
ARCHS = ["granite_3_2b", "qwen3_moe_235b_a22b", "rwkv6_3b", "zamba2_1p2b",
         "whisper_small", "paligemma_3b"]
CASES = [((1, 2), 32), ((2, 2), 32), ((2, 2), 48)]
UPDATE = adamw.update


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _shd(mesh):
    m = make_simulated_mesh(*mesh, device="cpu")
    return sh.Shd(m, sh.default_rules(m))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    rcfg = rget_config(arch).reduced()
    vals, axes = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                      rcfg)
    return (jax.tree.map(np.asarray, vals),
            jax.tree.map(tuple, axes,
                         is_leaf=lambda x: isinstance(x, tuple)))


def _dp(arch, mesh):
    cfg = get_config(arch).reduced()
    vals, axes = _weights(arch)
    model = convert.lm_params_from_numpy(cfg, vals, device="cpu", axes=axes)
    return cfg, loop.DataParallel(model, _shd(mesh))


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


def _host_params(dp):
    return pr.stacked_map(lambda x: x.numpy(), convert.host_stacked(
        pr.stack_tree(dp.tree())))


def _host(tree):
    return pr.stacked_map(lambda x: x.join(device="cpu").numpy(), tree)


def _batch(cfg, step):
    return {k: torch.as_tensor(v) for k, v in
            synth_batch(cfg, B, S, step).items()}


def _float32_grads(arch, mesh, before, batch):
    """The float32-moment step's gradients (joined, stacked) from the
    parameters ``before`` on ``batch``."""
    cfg, dp = _dp(arch, mesh)
    convert.load_stacked(dp, pr.stacked_map(torch.as_tensor, before))
    oc = adamw.AdamWConfig(**dict(Q8, quantize_moments=False))
    seen, outer = {}, adamw.update

    def spy(params, grads, st, c):
        seen["g"] = convert.host_stacked(pr.stack_tree(grads))
        return UPDATE(params, grads, st, c)
    adamw.update = spy
    try:
        loop.make_train_step(cfg, oc, shd=dp.shd)(
            dp, adamw.init(dp.tree(), oc), batch)
    finally:
        adamw.update = outer
    return seen["g"]


@pytest.mark.parametrize("mesh,q_block", CASES,
                         ids=[f"{d}x{m}_q{q}" for (d, m), q in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_8_bit_moments_over_model_pieces_match_the_reference_update(
        arch, mesh, q_block, monkeypatch):
    cfg, dp = _dp(arch, mesh)
    shd = dp.shd
    oc = adamw.AdamWConfig(**Q8, q_block=q_block)
    roc = radamw.AdamWConfig(**Q8, q_block=q_block)
    state = adamw.init(dp.tree(), oc, shd=shd)
    assert all(x.placement == sh.blocks_placement(shd, x.shape[0], q_block)
               for x in pr.leaves_like(state["m"], state["m"]))
    step = loop.make_train_step(cfg, oc, shd=shd)
    seen, update = {}, UPDATE

    def spy(params, grads, st, c):
        seen["grads"] = _whole_grads(grads, pr.stack_tree(dp.tree()))
        return update(params, grads, st, c)
    monkeypatch.setattr(adamw, "update", spy)
    m = mesh[1]
    for i in range(2):
        before = (_host_params(dp), _host(state["m"]), _host(state["v"]),
                  int(state["step"]))
        batch = _batch(cfg, i)
        state, _ = step(dp, state, batch)
        got_p = _flat(_host_params(dp))
        grads = pr.stacked_map(lambda g: g.numpy(), seen["grads"])
        # the gradients the step assembled: the float32 step's, bitwise
        want_g = _flat(_float32_grads(arch, mesh, before[0], batch))
        for path, g in _flat(grads).items():
            assert np.array_equal(g, want_g[path].numpy()), (i, path)
        # the reference's single-device 8-bit update on them
        rstate = {"step": jax.numpy.int32(before[3]), "m": before[1],
                  "v": before[2]}
        want_p, want_st, _ = radamw.update(before[0], grads, rstate, roc)
        for path, want in _flat(jax.tree.map(np.asarray, want_p)).items():
            _close(got_p[path], want, f"step {i} {path}")
        for key in ("m", "v"):
            got = _flat(_host(state[key]))
            for path, want in _flat(jax.tree.map(np.asarray,
                                                 want_st[key])).items():
                if path.endswith("/q"):
                    np.testing.assert_array_equal(got[path], want,
                                                  f"step {i} {key}{path}")
                else:
                    _close(got[path], want, f"step {i} {key}{path}")
        # the port's single-device 8-bit update on them, bitwise
        one = convert.lm_params_from_numpy(cfg, before[0], device="cpu")
        st1 = {"step": torch.tensor(before[3], dtype=torch.int32),
               "m": pr.tree_map(torch.tensor, before[1]),
               "v": pr.tree_map(torch.tensor, before[2])}
        st1, _ = update(one.tree(), _per_layer_tree(seen["grads"]), st1, oc)
        for path, want in _flat(pr.stacked_map(
                lambda x: x.numpy(), convert.host_stacked(pr.stack_tree(
                    one.tree())))).items():
            assert np.array_equal(got_p[path], want), path
        for key in ("m", "v"):
            got = _flat(_host(state[key]))
            for path, want in _flat(pr.tree_map(torch.Tensor.numpy,
                                                st1[key])).items():
                assert np.array_equal(got[path], want), (key, path)
            # every model replica holds the same run of blocks
            for x in pr.leaves_like(state[key], state[key]):
                for n, piece in enumerate(x.pieces):
                    assert torch.equal(piece, x.pieces[n - n % m]), n


def _tc(tmp_path, name, **kw):
    return loop.TrainConfig(**{**dict(
        steps=3, batch=B, seq=S, ckpt_every=1000,
        ckpt_dir=str(tmp_path / name), log_every=1000, async_ckpt=False,
        opt=adamw.AdamWConfig(**dict(Q8, clip_norm=1.0), q_block=32)),
        **kw})


def _run(cfg, tmp_path, name, mesh, steps, **kw):
    if mesh == (1, 1):
        where = {"device": "cpu"}
    else:
        m = make_simulated_mesh(*mesh, device="cpu")
        where = {"mesh": m, "rules": sh.default_rules(m)}
    return loop.Trainer(cfg, _tc(tmp_path, name, steps=steps, **kw),
                        **where).run()


def _moments(flat):
    return {p: v for p, v in flat.items()
            if p.startswith("/opt/m") or p.startswith("/opt/v")}


@pytest.mark.parametrize("other", [(1, 1), (2, 1), (1, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_8_bit_elastic_restart_between_a_2_x_2_mesh_and(other, tmp_path):
    """``q`` and ``s`` written by the Trainer at (2, 2) restore on
    ``other`` bitwise the file's, and those written on ``other`` restore
    at (2, 2) bitwise; from the (2, 2) file both meshes train a step on
    alike (loss and grad norm at the dense rule)."""
    cfg = get_config("granite_3_2b").reduced()
    for first, then, name in (((2, 2), other, "a"), (other, (2, 2), "b")):
        _run(cfg, tmp_path, name, first, 3, ckpt_every=3)
        out = _run(cfg, tmp_path, name, then, 3)
        assert out["metrics"] == []
        got = _moments(ck._flatten(loop.train_state(out["params"],
                                                    out["opt"])))
        want = _moments({p: ck._tensor(rec) for p, rec in ck.read_payload(
            str(tmp_path / name), 3).items()})
        assert sorted(got) == sorted(want) and \
            any(p.endswith("/q") for p in want)
        for path, x in want.items():
            assert torch.equal(got[path], x), (first, then, path)
    a = _run(cfg, tmp_path, "a", (2, 2), 4, ckpt_every=100)
    b = _run(cfg, tmp_path, "a", other, 4, ckpt_every=100)
    assert [x["step"] for x in a["metrics"]] == [3]
    assert [x["step"] for x in b["metrics"]] == [3]
    for key in ("loss", "grad_norm", "lr"):
        _close(a["metrics"][0][key], b["metrics"][0][key], key)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b",
                                  "rwkv6-3b", "zamba2-1.2b", "whisper-small",
                                  "paligemma-3b"])
def test_the_train_launcher_trains_8_bit_moments_over_model_pieces(
        arch, mesh, tmp_path, capsys):
    out = launcher.main([
        "--arch", arch, "--preset", "tiny", "--steps", "1", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
        "--device", "cpu", "--simulated-mesh", *map(str, mesh),
        "--opt-8bit"])
    assert "[train] done: 1 steps" in capsys.readouterr().out
    dp = out["data_parallel"]
    assert dp is not None and len(dp.groups) == mesh[0]
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    for x in pr.leaves_like(out["opt"]["m"], out["opt"]["m"]):
        assert x.placement == sh.blocks_placement(dp.shd, x.shape[0], 256)
        assert len(x.pieces) == mesh[0] * mesh[1]
    assert ck.latest_step(str(tmp_path)) == 1
