"""AdamW, gradient compression and the MoE layer's gradients in the port
(``repro_torch.optim``, ``models/moe.py`` ``RowGather``) against the JAX
package.

* ``adamw.update`` from identical numpy parameters, gradients and state
  (the reference's, one step in): parameters and float32 moments at
  ``allclose(rtol=1e-4, atol=1e-5 * scale)``, ``scale`` the largest
  magnitude of the reference's array (at least 1), as in
  ``test_torch_lm.py``; 8-bit moments: ``q`` equal (both round half to
  even), ``s`` at that tolerance.  The clip's scale comes from a global
  norm summed in another order (per layer here, per stacked leaf there),
  so a clipped gradient can differ in its last bit and move a moment
  across a rounding boundary of ``q``: the 8-bit cases run unclipped
  (scale exactly 1), the float32 cases clipped.  Blocks of 48 over
  64-wide leaves span the layer boundary of the stacked leaf, and a small
  ``CHUNK`` cuts the update across layers.
* mirrors of ``tests/test_substrate.py``'s optimizer and compression
  tests, and ``make_compressed_allreduce`` on a simulated 2-replica mesh
  against a numpy transcription of the reference's body.
* the MoE layer's gradients through ``RowGather`` against ``jax.grad`` of
  the reference's ``moe`` (routing asserted equal first) and against
  torch indexing's autograd on the same routing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import params as rpr
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.models import moe
from repro_torch.models import params as pr
from repro_torch.optim import adamw, compress

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_tree(tree):
    """A numpy tree of the reference's structure as tensors."""
    return pr.tree_map(lambda a: torch.tensor(np.asarray(a)), dict(tree))


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("quantize,q_block,chunk", [
    (False, 256, adamw.CHUNK), (False, 256, 100), (True, 256, adamw.CHUNK),
    (True, 48, 96)])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_adamw_update_matches_reference(arch, quantize, q_block, chunk,
                                        monkeypatch):
    monkeypatch.setattr(adamw, "CHUNK", chunk)
    rcfg = rget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                clip_norm=1e9 if quantize else 0.5,
                quantize_moments=quantize, q_block=q_block)
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                   rcfg)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), vals) for _ in range(2)]
    roc = radamw.AdamWConfig(**ocfg)
    vals1, st1, _ = radamw.update(vals, grads[0], radamw.init(vals, roc),
                                  roc)          # the state both start from
    want_p, want_st, want_m = radamw.update(vals1, grads[1], st1, roc)

    model = convert.lm_params_from_numpy(cfg, _np_tree(vals1), device="cpu")
    g = convert.lm_params_from_numpy(cfg, grads[1], device="cpu").tree()
    state = _port_tree(_np_tree(st1))
    new_st, metrics = adamw.update(model.tree(), g, state,
                                   adamw.AdamWConfig(**ocfg))
    assert int(new_st["step"]) == int(want_st["step"]) == 2
    _close(metrics["grad_norm"], want_m["grad_norm"])
    _close(metrics["lr"], want_m["lr"])
    got_p = convert.lm_params_to_numpy(model)
    for path, want in rpr_flat(_np_tree(want_p)).items():
        _close(rpr_flat(got_p)[path], want, path)
    for key in ("m", "v"):
        got = rpr_flat(pr.tree_map(torch.Tensor.numpy, new_st[key]))
        for path, want in rpr_flat(_np_tree(want_st[key])).items():
            if path.endswith("/q"):
                np.testing.assert_array_equal(got[path], want, path)
            else:
                _close(got[path], want, f"{key}{path}")


def rpr_flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in rpr_flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_adamw_schedule_and_init_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        _close(adamw.schedule(adamw.AdamWConfig(**cfg), step),
               radamw.schedule(radamw.AdamWConfig(**cfg), jnp.int32(step)))
    p = {"w": np.arange(600, dtype=np.float32).reshape(20, 30)}
    for quantize in (False, True):
        want = radamw.init(p, radamw.AdamWConfig(quantize_moments=quantize))
        got = adamw.init({"w": torch.tensor(p["w"])},
                         adamw.AdamWConfig(quantize_moments=quantize))
        for path, w in rpr_flat(_np_tree(want)).items():
            g = rpr_flat(pr.tree_map(torch.Tensor.numpy, got))[path]
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), path


def test_adamw_matches_reference_step():
    """``tests/test_substrate.py``'s hand-computed first step."""
    cfg = adamw.AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=0.0, clip_norm=1e9,
                            warmup_steps=0, total_steps=10, min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    st = adamw.init(p, cfg)
    want = p["w"].numpy().copy()
    adamw.update(p, g, st, cfg)
    m = 0.1 * g["w"].numpy()
    v = 0.001 * g["w"].numpy() ** 2
    want = want - 1e-2 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-5)


def test_adamw_quantized_moments_track_full():
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=50, clip_norm=1e9,
              weight_decay=0.0)
    cfg_f = adamw.AdamWConfig(**kw)
    cfg_q = adamw.AdamWConfig(**kw, quantize_moments=True, q_block=64)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(512).astype(np.float32)
    pf, pq = {"w": torch.tensor(w0)}, {"w": torch.tensor(w0)}
    sf, sq = adamw.init(pf, cfg_f), adamw.init(pq, cfg_q)
    for _ in range(10):
        g = {"w": torch.tensor(rng.standard_normal(512).astype(np.float32)
                               * 0.1)}
        sf, _ = adamw.update(pf, g, sf, cfg_f)
        sq, _ = adamw.update(pq, g, sq, cfg_q)
    rel = float(torch.linalg.norm(pf["w"] - pq["w"]) /
                torch.linalg.norm(pf["w"]))
    assert rel < 0.05, rel
    assert sq["m"]["w"]["q"].dtype == torch.int8


def test_adamw_updates_bf16_params_in_place_with_float32_moments():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    w = torch.linspace(-1, 1, 300).to(torch.bfloat16)
    p = {"w": w}
    st = adamw.init(p, cfg)
    before = w.clone()
    st, _ = adamw.update(p, {"w": torch.ones_like(w)}, st, cfg)
    assert p["w"] is w and w.dtype == torch.bfloat16
    assert not torch.equal(w, before)
    assert st["m"]["w"].dtype == torch.float32 and int(st["step"]) == 1


# ----------------------------------------------------------- compression
def test_grad_compression_error_feedback_converges():
    """``tests/test_substrate.py``'s test on the port's ``_q8`` /
    ``_dq8``; ``q`` and the scales equal to the reference's."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1024).astype(np.float32)
    err = np.zeros_like(g)
    acc_true, acc_sent = np.zeros_like(g), np.zeros_like(g)
    for _ in range(50):
        gi = g + rng.standard_normal(1024).astype(np.float32) * 0.01
        x = gi + err
        q, s, shape = compress._q8(torch.tensor(x))
        rq, rs, rshape = rcompress._q8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        assert shape == tuple(rshape)
        sent = compress._dq8(q, s, x.shape, x.size).numpy()
        err = x - sent
        acc_true += gi
        acc_sent += sent
    rel = np.linalg.norm(acc_true - acc_sent) / np.linalg.norm(acc_true)
    assert rel < 0.01, rel


def _reference_body(gs, es, block=256):
    """The reference's ``compressed_psum_mean`` body in numpy, for
    per-replica gradients ``gs`` and residuals ``es`` of one leaf."""
    qs, ss, errs = [], [], []
    for g, e in zip(gs, es):
        x = g.astype(np.float32) + e
        flat = np.pad(x.reshape(-1), (0, (-x.size) % block))
        blocks = flat.reshape(-1, block)
        s = (np.abs(blocks).max(axis=1, keepdims=True) / np.float32(127.0)
             + np.float32(1e-12)).astype(np.float32)
        q = np.clip(np.round(blocks / s), -127, 127).astype(np.int8)
        sent = (q.astype(np.float32) * s).reshape(-1)[:x.size].reshape(
            x.shape)
        errs.append(x - sent)
        qs.append(q)
        ss.append(s)
    n = np.float32(len(gs))
    summed = np.sum([q.astype(np.int32) for q in qs], axis=0)
    s_sum = ss[0]
    for s in ss[1:]:
        s_sum = s_sum + s
    mean = summed.astype(np.float32) * (s_sum / n) / n
    return mean.reshape(-1)[:gs[0].size].reshape(gs[0].shape), errs


def test_compressed_allreduce_on_a_simulated_mesh():
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((2, 5, 70)).astype(np.float32),
             "b": {"c": rng.standard_normal((2, 300)).astype(np.float32)}}
    err = jax.tree.map(lambda g: rng.standard_normal(g.shape).astype(
        np.float32) * 1e-3, grads)
    fn = compress.make_compressed_allreduce(mesh)
    mean, new_err = fn(_port_tree(grads), _port_tree(err))
    for path, g in rpr_flat(grads).items():
        e = rpr_flat(err)[path]
        want_mean, want_err = _reference_body(list(g), list(e))
        got_mean, got_err = rpr_flat(mean)[path], rpr_flat(new_err)[path]
        assert got_mean.shape == g.shape
        for r in range(2):
            np.testing.assert_allclose(got_mean[r].numpy(), want_mean,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got_err[r].numpy(), want_err[r],
                                       rtol=1e-6, atol=1e-7)


def test_compressed_psum_mean_checks_replica_count():
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    with pytest.raises(ValueError, match="for 2 replicas"):
        compress.compressed_psum_mean([{"a": torch.ones(3)}],
                                      [{"a": torch.zeros(3)}], mesh)


# ---------------------------------------------------- MoE layer gradients
def _moe_inputs(arch, capacity_factor, group_size=12):
    rcfg = rget_config(arch).reduced().replace(
        capacity_factor=capacity_factor, moe_group_size=group_size)
    cfg = get_config(arch).reduced().replace(
        capacity_factor=capacity_factor, moe_group_size=group_size)
    p, _ = rpr.materialize_init(rmoe.init_moe, jax.random.PRNGKey(2), rcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 18, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 18, 64)).astype(np.float32)
    return rcfg, cfg, _np_tree(p), x, cot


def _port_moe_grads(cfg, p, x, cot):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe(tp, tx, cfg)
    ((y * torch.tensor(cot)).sum() + aux["moe_aux_loss"]).backward()
    return {"x": tx.grad, **{k: v.grad for k, v in tp.items()}}


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"])
def test_moe_gradients_match_reference(arch, capacity_factor):
    rcfg, cfg, p, x, cot = _moe_inputs(arch, capacity_factor)
    xf = x.reshape(3, 12, 64)
    _, reidx = jax.lax.top_k(jax.nn.softmax(
        jnp.einsum("gtd,de->gte", xf, p["router"]), -1), rcfg.top_k)
    probs = torch.softmax(torch.einsum("gtd,de->gte", torch.tensor(xf),
                                       torch.tensor(p["router"])), -1)
    np.testing.assert_array_equal(
        torch.topk(probs, cfg.top_k, dim=-1).indices.numpy(),
        np.asarray(reidx))

    def rloss(p, x):
        y, aux = rmoe.moe(p, x, rcfg)
        return jnp.sum(y * cot) + aux["moe_aux_loss"]
    want_p, want_x = jax.grad(rloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = _port_moe_grads(cfg, p, x, cot)
    _close(got["x"], want_x, "x")
    for k in p:
        _close(got[k], want_p[k], k)


def _indexing_gather(src, ids, back_ids, fan):
    """``RowGather``'s forward as a plain indexed read, differentiated by
    torch's autograd (an index backward, which accumulates)."""
    return moe._with_zero_row(src)[ids.long()]


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"])
def test_row_gather_backward_matches_indexing_autograd(arch, capacity_factor,
                                                       monkeypatch):
    """Same routing, same forward: the inverse-map gathers give the
    gradients torch's indexing autograd gives.  With top-2 each token row
    sums two terms, so the orders agree and the gradients are bitwise."""
    _, cfg, p, x, cot = _moe_inputs(arch, capacity_factor)
    assert cfg.top_k == 2
    got = _port_moe_grads(cfg, p, x, cot)
    monkeypatch.setattr(moe.RowGather, "apply", _indexing_gather)
    want = _port_moe_grads(cfg, p, x, cot)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_row_gather_backward_sums_choices_in_order():
    """top-8 of 16 experts: each token's gradient is the sum of its 8
    slots' rows in choice order, and the dropped entries read the zero
    row."""
    rng = np.random.default_rng(4)
    tg, k, e, c, d = 10, 8, 16, 3, 5
    eidx = np.argsort(rng.standard_normal((tg, e)), axis=1)[:, :k]
    slot, tok, order, valid = moe._dispatch_indices(
        torch.tensor(eidx, dtype=torch.int32), k, e, c)
    assert not bool(valid.all())
    xg = torch.tensor(rng.standard_normal((tg, d)).astype(np.float32),
                      requires_grad=True)
    disp = moe._dispatch(xg, slot, tok, order, e, c)
    gbuf = torch.tensor(rng.standard_normal((e * c, d)).astype(np.float32))
    disp.backward(gbuf)
    entry = moe._entry_slots(slot, order).numpy().reshape(tg, k)
    padded = np.concatenate([gbuf.numpy(), np.zeros((1, d), np.float32)])
    want = padded[entry[:, 0]]
    for j in range(1, k):
        want = want + padded[entry[:, j]]
    assert xg.grad.numpy().tobytes() == want.tobytes()
