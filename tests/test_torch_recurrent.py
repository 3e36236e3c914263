"""The recurrent LM families in the port (``models/rwkv6.py``,
``models/mamba2.py``, their blocks and their ``lm`` / ``serve.engine``
branches) against the JAX package, layer by layer and at the edges the
whole-model tests of ``test_torch_lm.py`` and ``test_torch_train.py`` do
not reach.

Inputs are made with numpy from a seed; weights are the reference's
``materialize_init`` values.  Everything is float32 and compared with
``allclose(rtol=1e-4, atol=1e-5 * scale)``, ``scale`` the largest
magnitude of the reference's array (at least 1), as in
``test_torch_lm.py``: both sum float32 products in other orders.

* ``rwkv6_time_mix`` over several chunks, at a prime length (chunk 1), with
  a carried state and token-shift carry, and the ``s == 1`` recurrence;
  ``rwkv_channel_mix`` with and without its carry;
* ``_causal_conv`` with and without a tail; ``mamba2_block`` chunked and
  as the decode recurrence;
* ``init_model`` and ``init_cache`` leaf for leaf (shapes, dtypes, logical
  axes) against the reference's, for whisper (its encoder stack and cross
  k/v cache) and paligemma too;
* rwkv6 whole over several chunks (forward, gradients, decode == forward);
* zamba2 at 8 layers (not a multiple of ``shared_attn_every``): the port's
  decode equals the reference's *forward*; the reference's own decode
  skips the 2 trailing layers and does not;
* Mamba2 at a chunk where the reference's SSD overflows to NaN: the port
  is finite and equals the decode recurrence run token by token;
* one rwkv6 layer, one Mamba2 layer and the shared block: output, input
  gradient and every parameter gradient against ``jax.vjp``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import blocks as rblocks
from repro.models import lm as rlm
from repro.models import mamba2 as rm2
from repro.models import params as rpr
from repro.models import rwkv6 as rr6
from repro.serve import engine as rengine

from repro_torch.configs import get_config
from repro_torch.convert import host_stacked, lm_params_from_numpy
from repro_torch.models import blocks, lm, mamba2, rwkv6
from repro_torch.models import params as pr
from repro_torch.serve import engine

RTOL, ATOL = 1e-4, 1e-5
SERVE_TOL = dict(rtol=2e-2, atol=2e-3)     # tests/test_serve.py
# the archs whose parameter and cache trees are held leaf for leaf
ARCHS = ["rwkv6_3b", "zamba2_1p2b", "whisper_small", "paligemma_3b"]


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


@functools.lru_cache(maxsize=None)
def _layer0(arch, key):
    """The reference's first-layer parameters of ``arch`` (reduced), as
    numpy, under ``key`` (``time_mix``, ``channel_mix`` or ``mamba``)."""
    rcfg = rget_config(arch).reduced()
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(4),
                                   rcfg)
    return jax.tree.map(lambda a: np.asarray(a[0]), vals["layers"][key])


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -------------------------------------------------------------------- rwkv6
@pytest.mark.parametrize("s,carried", [
    (70, False),     # 5 chunks of 14
    (37, False),     # prime: the chunk rule cuts 32 down to 1
    (40, True),      # 2 chunks of 20 after a carried state and x_last
    (1, True),       # the single-token recurrence
    (1, False),
])
def test_rwkv6_time_mix_matches_reference(s, carried):
    rcfg = rget_config("rwkv6_3b").reduced()
    cfg = get_config("rwkv6_3b").reduced()
    jp, tp = _both(_layer0("rwkv6_3b", "time_mix"))
    x = _x((2, s, cfg.d_model), s)
    h, k = cfg.rwkv_heads, cfg.rwkv_head_dim
    state = x_last = None
    if carried:
        state = _x((2, h, k, k), 1) * 0.3
        x_last = _x((2, cfg.d_model), 2)
    want, (wstate, wlast) = rr6.rwkv6_time_mix(
        jp, jnp.asarray(x), rcfg,
        state=None if state is None else jnp.asarray(state),
        x_last=None if x_last is None else jnp.asarray(x_last))
    got, (gstate, glast) = rwkv6.rwkv6_time_mix(
        tp, torch.as_tensor(x), cfg,
        state=None if state is None else torch.as_tensor(state),
        x_last=None if x_last is None else torch.as_tensor(x_last))
    _close(got, want, "out")
    _close(gstate, wstate, "state")
    assert gstate.dtype == torch.float32 and gstate.shape == (2, h, k, k)
    np.testing.assert_array_equal(glast.numpy(), np.asarray(wlast))


@pytest.mark.parametrize("s", [1, 9])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_channel_mix_matches_reference(s, carried):
    rcfg = rget_config("rwkv6_3b").reduced()
    cfg = get_config("rwkv6_3b").reduced()
    jp, tp = _both(_layer0("rwkv6_3b", "channel_mix"))
    x = _x((2, s, cfg.d_model), 5)
    x_last = _x((2, cfg.d_model), 6) if carried else None
    want, wlast = rr6.rwkv_channel_mix(
        jp, jnp.asarray(x), rcfg,
        x_last=None if x_last is None else jnp.asarray(x_last))
    got, glast = rwkv6.rwkv_channel_mix(
        tp, torch.as_tensor(x), cfg,
        x_last=None if x_last is None else torch.as_tensor(x_last))
    _close(got, want)
    np.testing.assert_array_equal(glast.numpy(), np.asarray(wlast))


# ------------------------------------------------------------------- mamba2
@pytest.mark.parametrize("s", [1, 2, 9])
@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_reference(s, tail):
    c = 24
    x, w, b = _x((2, s, c), 7), _x((mamba2.D_CONV, c), 8), _x((c,), 9)
    st = _x((2, mamba2.D_CONV - 1, c), 10) if tail else None
    want, wst = rm2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    got, gst = mamba2._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                                   torch.as_tensor(b),
                                   None if st is None else torch.as_tensor(st))
    _close(got, want)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("s", [12, 17, 64])   # 2 chunks of 6, 17 of 1, 8 of 8
def test_mamba2_block_chunked_matches_reference(s):
    rcfg = rget_config("zamba2_1p2b").reduced()
    cfg = get_config("zamba2_1p2b").reduced()
    jp, tp = _both(_layer0("zamba2_1p2b", "mamba"))
    x = _x((2, s, cfg.d_model), s)
    want, wstate, wconv = rm2.mamba2_block(jp, jnp.asarray(x), rcfg)
    got, gstate, gconv = mamba2.mamba2_block(tp, torch.as_tensor(x), cfg)
    _close(got, want, "out")
    _close(gstate, wstate, "state")
    assert gstate.dtype == torch.float32
    _close(gconv, wconv, "conv tail")


def test_mamba2_block_decode_matches_reference():
    rcfg = rget_config("zamba2_1p2b").reduced()
    cfg = get_config("zamba2_1p2b").reduced()
    jp, tp = _both(_layer0("zamba2_1p2b", "mamba"))
    h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * n
    x = _x((2, 1, cfg.d_model), 11)
    state = _x((2, h, hp, n), 12)
    conv = _x((2, mamba2.D_CONV - 1, conv_ch), 13)
    want = rm2.mamba2_block(jp, jnp.asarray(x), rcfg,
                            state=jnp.asarray(state),
                            conv_state=jnp.asarray(conv))
    got = mamba2.mamba2_block(tp, torch.as_tensor(x), cfg,
                              state=torch.as_tensor(state),
                              conv_state=torch.as_tensor(conv))
    for g, w, what in zip(got, want, ("out", "state", "conv")):
        _close(g, w, what)


def test_mamba2_long_chunk_is_finite_where_the_reference_overflows():
    """At the published ``ssm_chunk = 256`` the reference's within-chunk
    ``exp(cum[t] - cum[s])`` overflows float32 for ``s > t`` (the exponent
    is a sum of ~256 ``dt``), and ``inf * 0`` makes its output NaN; the
    port exponentiates only ``s <= t``.  Its chunked form equals the
    decode recurrence run token by token, the port's and the
    reference's."""
    rcfg = rget_config("zamba2_1p2b").reduced().replace(ssm_chunk=256)
    cfg = get_config("zamba2_1p2b").reduced().replace(ssm_chunk=256)
    jp, tp = _both(_layer0("zamba2_1p2b", "mamba"))
    s = 256
    x = _x((1, s, cfg.d_model), 14)
    rout, _, _ = rm2.mamba2_block(jp, jnp.asarray(x), rcfg)
    assert not bool(jnp.isfinite(rout).all())        # the reference's NaN
    got, gstate, _ = mamba2.mamba2_block(tp, torch.as_tensor(x), cfg)
    assert bool(torch.isfinite(got).all())
    h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * n
    st, cv = torch.zeros((1, h, hp, n)), torch.zeros((1, 3, conv_ch))
    rst, rcv = jnp.zeros((1, h, hp, n)), jnp.zeros((1, 3, conv_ch))
    rstep = jax.jit(lambda xt, st, cv: rm2.mamba2_block(
        jp, xt, rcfg, state=st, conv_state=cv))
    ys, rys = [], []
    for t in range(s):
        xt = x[:, t:t + 1]
        y, st, cv = mamba2.mamba2_block(tp, torch.as_tensor(xt), cfg,
                                        state=st, conv_state=cv)
        ry, rst, rcv = rstep(jnp.asarray(xt), rst, rcv)
        ys.append(y)
        rys.append(np.asarray(ry))
    rys = np.concatenate(rys, axis=1)
    _close(torch.cat(ys, dim=1), rys, "the two recurrences")
    _close(got, rys, "chunked vs the reference's recurrence")
    _close(gstate, rst, "final state")


# ------------------------------------------------------- init and caches
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _axes(tree):
    if isinstance(tree, dict):
        return {k: _axes(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_leaves_are_the_references(arch, dtype):
    rcfg = rget_config(arch).reduced().replace(
        param_dtype=getattr(jnp, dtype))
    cfg = get_config(arch).reduced().replace(
        param_dtype=getattr(torch, dtype))
    want, waxes = rpr.abstract_init(rlm.init_model, rcfg)
    model = lm.init_model(cfg, device="cpu")
    got = host_stacked(pr.stack_tree(model.tree()))
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].dtype == getattr(torch, jnp.dtype(w.dtype).name), \
            path
    assert _axes(model.axes) == _axes(waxes)
    if arch == "zamba2_1p2b":   # one shared block, not stacked
        assert "shared" in model.axes and \
            model.shared.attn.wq.shape == (cfg.d_model, cfg.num_heads,
                                           cfg.head_dim)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_leaves_are_the_references(arch, reduced):
    rcfg, cfg = rget_config(arch), get_config(arch)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    want = jax.eval_shape(functools.partial(rlm.init_cache, rcfg, 1, 16))
    got = lm.init_cache(cfg, 1, 16, device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == getattr(torch, jnp.dtype(w.dtype).name), k
        assert not got[k].any(), k


# ------------------------------------------------------- whole models
def _model(arch, rcfg, cfg, seed=1):
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(seed),
                                   rcfg)
    return vals, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals),
                                      device="cpu")


def test_rwkv6_over_several_chunks_matches_reference():
    """rwkv6 whole at 64 tokens (2 WKV chunks of 32): forward, loss and
    every gradient leaf against ``jax.grad``; decode == forward."""
    rcfg = rget_config("rwkv6_3b").reduced()
    cfg = get_config("rwkv6_3b").reduced()
    vals, model = _model("rwkv6_3b", rcfg, cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = rlm.forward(vals, rcfg, {"tokens": jnp.asarray(batch[
        "tokens"])})
    got, _ = lm.forward(model, cfg, {"tokens": torch.as_tensor(batch[
        "tokens"])})
    _close(got, want)
    jb = jax.tree.map(jnp.asarray, batch)
    wloss, wgrads = jax.value_and_grad(
        lambda p: rlm.loss_fn(p, rcfg, jb)[0])(vals)
    model.requires_grad_(True)
    loss, _ = lm.loss_fn(model, cfg, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    loss.backward()
    _close(loss.detach(), wloss)
    ggrads = _flat(host_stacked(pr.stack_tree(pr.tree_map(
        lambda p: p.grad, model.tree()))))
    wgrads = _flat(wgrads)
    assert sorted(ggrads) == sorted(wgrads)
    for path, w in wgrads.items():
        _close(ggrads[path], w, path)
    model.requires_grad_(False)
    toks_t = torch.as_tensor(batch["tokens"])
    cache, last = engine.prefill(model, cfg, {"tokens": toks_t[:, :40]}, 70)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, 39].detach().numpy(),
                               **SERVE_TOL)
    for i in range(40, 44):
        step, cache = lm.decode_step(model, cfg, cache, toks_t[:, i:i + 1],
                                     i)
        np.testing.assert_allclose(step[:, 0].numpy(),
                                   got[:, i].detach().numpy(), **SERVE_TOL)


def test_zamba2_decode_runs_every_layer():
    """zamba2 at 8 layers (``shared_attn_every`` 6): the shared block runs
    after layer 5, and layers 6 and 7 follow it.  The port's prefill +
    decode equals the reference's *forward*, decoded tokens included.

    The reference's own decode runs only ``nseg * k`` = 6 layers
    (``src/repro/models/lm.py:401-419``), so it agrees with its forward at
    the prefill's last position (max logit difference <= 1.8e-4) and not
    at a decoded token (15.6-20.2 here, prompt 8, 4 decoded tokens); at
    6 and 12 layers it agrees (<= 4.6e-4).  Asserted below, so the record
    in ROADMAP.md stays true."""
    rcfg = rget_config("zamba2_1p2b").reduced().replace(num_layers=8)
    cfg = get_config("zamba2_1p2b").reduced().replace(num_layers=8)
    vals, model = _model("zamba2_1p2b", rcfg, cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = rlm.forward(vals, rcfg, {"tokens": jnp.asarray(toks)})
    want = np.asarray(want)
    cache, last = engine.prefill(model, cfg,
                                 {"tokens": torch.as_tensor(toks[:, :8])},
                                 16)
    assert cache["shared_k"].shape[0] == 1
    np.testing.assert_allclose(last[:, 0].numpy(), want[:, 7], **SERVE_TOL)
    rcache, _ = rengine.prefill(vals, rcfg,
                                {"tokens": jnp.asarray(toks[:, :8])},
                                max_len=16)
    ref_err = 0.0
    for i in range(8, 12):
        got, cache = lm.decode_step(model, cfg, cache,
                                    torch.as_tensor(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, i],
                                   **SERVE_TOL, err_msg=f"position {i}")
        rgot, rcache = rlm.decode_step(vals, rcfg, rcache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i))
        ref_err = max(ref_err, float(np.abs(np.asarray(rgot)[:, 0]
                                            - want[:, i]).max()))
    assert ref_err > 1.0, ref_err      # the reference skips layers 6 and 7


# ------------------------------------------------------ layer gradients
def _layer_pair(which):
    """(reference layer fn, port layer fn, config, reference params) of
    one layer of the reduced model; each fn maps (params, x) -> the
    layer's output."""
    arch = "rwkv6_3b" if which == "rwkv" else "zamba2_1p2b"
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(5),
                                   rcfg)
    vals = jax.tree.map(np.asarray, vals)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    if which == "shared":
        return (lambda p, x: rblocks.shared_attn_block(
                    p, x, cfg=rcfg, positions=jnp.asarray(pos), shd=None),
                lambda p, x: blocks.shared_attn_block(
                    p, x, cfg=cfg, positions=torch.as_tensor(pos)),
                cfg, vals["shared"])
    p0 = jax.tree.map(lambda a: a[0], vals["layers"])
    if which == "rwkv":
        return (lambda p, x: rblocks.rwkv_layer(p, x, cfg=rcfg, shd=None)[0],
                lambda p, x: blocks.rwkv_layer(p, x, cfg=cfg)[0], cfg, p0)
    return (lambda p, x: rblocks.mamba_layer(p, x, cfg=rcfg, shd=None)[0],
            lambda p, x: blocks.mamba_layer(p, x, cfg=cfg)[0], cfg, p0)


@pytest.mark.parametrize("which", ["rwkv", "mamba", "shared"])
def test_layer_gradients_match_reference(which):
    """One layer's vector-Jacobian product against ``jax.vjp`` of the
    reference's layer, from the same input and cotangent: the output, the
    input's gradient and every parameter's gradient.  Layer by layer, the
    float32 rounding of the two packages stays a few ulps; across a whole
    random-weight zamba2 it is amplified (``test_torch_train.py``)."""
    rfn, fn, cfg, p = _layer_pair(which)
    x = _x((2, 12, cfg.d_model), 15)
    cot = _x((2, 12, cfg.d_model), 16)
    want, vjp = jax.vjp(rfn, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    wp, wx = vjp(jnp.asarray(cot))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    got = fn(tp, tx)
    got.backward(torch.as_tensor(cot))
    _close(got.detach(), want, "out")
    _close(tx.grad, wx, "input gradient")
    gp, wp = _flat(jax.tree.map(lambda t: t.grad, tp)), _flat(wp)
    assert sorted(gp) == sorted(wp)
    for path, w in wp.items():
        _close(gp[path], w, path)


# ------------------------------------------------ training and launchers
def test_unreached_shared_block_trains_as_the_reference():
    """zamba2 at 2 layers, shallower than ``shared_attn_every`` (6): the
    shared block exists but never runs, so its gradient is zero (autograd
    leaves it ``None``; ``jax.grad`` gives zeros).  One train step: loss,
    gradient norm and the shared block after the update (moved by weight
    decay alone) as the reference's.  The other weights are not compared
    after an update: AdamW's first step moves a weight by about ``lr``
    whatever its gradient's size (``test_torch_train.py``)."""
    from repro.optim import adamw as radamw
    from repro.train import loop as rloop
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro.data.pipeline import synth_batch as rsynth_batch
    rcfg = rget_config("zamba2_1p2b").reduced().replace(num_layers=2)
    cfg = get_config("zamba2_1p2b").reduced().replace(num_layers=2)
    vals, model = _model("zamba2_1p2b", rcfg, cfg)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=5)
    batch = rsynth_batch(rcfg, 2, 12, step=0)
    roc = radamw.AdamWConfig(**ocfg)
    rvals, _, want = jax.jit(rloop.make_train_step(rcfg, roc))(
        vals, radamw.init(vals, roc), batch)
    oc = adamw.AdamWConfig(**ocfg)
    _, got = loop.make_train_step(cfg, oc)(
        model, adamw.init(model.tree(), oc),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        _close(got[k], want[k], k)
    gp = _flat(host_stacked(pr.stack_tree(model.tree())))
    wp = _flat(jax.tree.map(np.asarray, rvals))
    assert sorted(gp) == sorted(wp) and "/shared/attn/wq" in gp
    for path, w in wp.items():
        if path.startswith("/shared/"):
            _close(gp[path], w, path)
            assert not np.array_equal(w, _flat(vals)[path]), path


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_launchers_on_cpu(arch, tmp_path, capsys):
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.launch import serve, train
    toks = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "6",
                       "--steps", "3", "--device", "cpu"])
    out = train.main(["--arch", arch, "--preset", "tiny", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert toks.shape == (2, 3) and f"[serve] arch={arch}" in text
    assert "[train] done: 3 steps" in text and len(out["metrics"]) == 3
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert ck.latest_step(str(tmp_path)) == 3


def test_hybrid_gradient_rounding_exceeds_the_dense_rule():
    """Why ``test_torch_train.py`` holds zamba2's whole-model gradients at
    ``HYBRID_GRAD_ATOL``: through 6 Mamba2 layers and the shared block
    (random weights; the residual stream grows from 1 to ~33) float32
    rounding is amplified, so the reference's own gradients, jitted and
    eager, differ by more than the dense rule's ``1e-5 x scale``; the
    port's are within ``HYBRID_GRAD_ATOL`` of the jitted ones."""
    from repro.data.pipeline import synth_batch as rsynth_batch
    from test_torch_train import HYBRID_GRAD_ATOL
    rcfg = rget_config("zamba2_1p2b").reduced()
    cfg = get_config("zamba2_1p2b").reduced()
    vals, model = _model("zamba2_1p2b", rcfg, cfg)
    batch = rsynth_batch(rcfg, 2, 12, step=3, seed=1)
    jb = jax.tree.map(jnp.asarray, batch)
    grad = jax.grad(lambda p: rlm.loss_fn(p, rcfg, jb)[0])
    jitted = _flat(jax.jit(grad)(jax.tree.map(jnp.asarray, vals)))
    with jax.disable_jit():
        eager = _flat(grad(jax.tree.map(jnp.asarray, vals)))
    model.requires_grad_(True)
    loss, _ = lm.loss_fn(model, cfg, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    loss.backward()
    port = _flat(host_stacked(pr.stack_tree(pr.tree_map(
        lambda p: p.grad, model.tree()))))

    def worst(got):
        return max(float(np.abs(np.asarray(got[k], np.float64)
                                - np.asarray(w, np.float64)).max())
                   / max(1.0, float(np.abs(w).max()))
                   for k, w in jitted.items())
    spread, port_err = worst(eager), worst(port)
    assert ATOL < spread < HYBRID_GRAD_ATOL, (spread, port_err)
    assert port_err < HYBRID_GRAD_ATOL, (spread, port_err)
