"""LM serving in the port (``repro_torch.configs``, ``models``,
``serve.engine``, ``launch.serve``) against the JAX package.

The reference's ``materialize_init`` weights cross into the port through
``repro_torch.convert.lm_params_from_numpy``; tokens, whisper's encoder
frames and paligemma's patch embeddings are made with numpy.  At
``reduced()`` configs (float32, 2 layers, d 64; zamba2 6 layers, so its
shared block runs once; whisper 2 encoder layers over 16 frames,
paligemma 8 patch tokens) for every arch:

* ``forward`` logits, teacher-forced ``prefill`` + ``decode_step`` (the
  reference's tokens fed, so a near-tie in argmax cannot cascade) and the
  ring cache past the window: ``allclose(rtol=1e-4, atol=1e-5 * scale)``
  to the reference, ``scale`` the largest magnitude of the reference's
  array (at least 1).  Both sum float32 products, in other orders, so a
  logit carries an absolute error of about 1e-6 of the logits' scale
  (about 50 here, from the tied unit-scale embedding) whatever its own
  size: a plain ``atol=1e-5`` fails on the few logits near 0 (4e-5 seen);
* ``generate`` at temperature 0: the same tokens;
* decode against the port's own forward: the reference's
  ``tests/test_serve.py`` rule, ``rtol=2e-2, atol=2e-3``;
* the MoE dispatch: ``_dispatch_indices`` exactly, the dispatch buffer
  through ``row_gather`` bitwise that of the reference's scatter, ``moe``
  within the float32 tolerance once the routing is asserted equal, and
  ``dispatch_pattern_stats`` equal;
* the encdec and vlm layers one by one: ``cross_attention``, the encoder
  and decoder layers (full sequence and decode), and a vlm layer with a
  prefix, which a causal mask on the same inputs fails.

On the CPU the row gather runs its plain version; on the card the same
layer runs the CUDA kernel (``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import attention as rattention
from repro.models import blocks as rblocks
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import params as rpr
from repro.serve import engine as rengine

from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention, blocks, layers, lm, moe
from repro_torch.models import params as pr
from repro_torch.serve import engine

LM_ARCHS = ["granite_3_2b", "gemma_7b", "gemma3_27b", "h2o_danube_3_4b",
            "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b", "rwkv6_3b",
            "zamba2_1p2b", "whisper_small", "paligemma_3b"]
MOE_ARCHS = ["qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"]
RTOL, ATOL = 1e-4, 1e-5
SERVE_TOL = dict(rtol=2e-2, atol=2e-3)     # tests/test_serve.py
B, S_PROMPT, S_TOTAL = 2, 8, 12


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, err_msg=""):
    """``got`` (a tensor) against the reference's ``want`` (see the module
    docstring)."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def modality_inputs(cfg, b: int, seed: int = 7) -> dict:
    """The stubbed frontends' inputs, standard normal float32: vlm's
    ``prefix_embeds`` (b, num_prefix, D), encdec's ``enc_frames`` (b,
    enc_len, D); none for the text-only families."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_frames"] = rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


@dataclasses.dataclass
class Case:
    rcfg: object
    cfg: object
    vals: dict
    model: torch.nn.Module
    tokens: np.ndarray
    extras: dict            # modality_inputs, numpy

    @property
    def prefix_len(self) -> int:
        """The slots of vlm's patch prefix in front of the tokens."""
        return lm.prefix_slots(self.cfg)

    def jbatch(self, tokens) -> dict:
        return {"tokens": jnp.asarray(tokens),
                **{k: jnp.asarray(v) for k, v in self.extras.items()}}

    def tbatch(self, tokens) -> dict:
        return {"tokens": torch.as_tensor(tokens),
                **{k: torch.as_tensor(v) for k, v in self.extras.items()}}


@pytest.fixture(scope="module", params=LM_ARCHS)
def case(request):
    rcfg = rget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(1),
                                   rcfg)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals),
                                 device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S_TOTAL)).astype(np.int32)
    return Case(rcfg, cfg, vals, model, tokens, modality_inputs(cfg, B))


def _rdecode(rcfg, prefix_len: int = 0):
    return jax.jit(functools.partial(rlm.decode_step, cfg=rcfg,
                                     prefix_len=prefix_len))


# ------------------------------------------------------------------ configs
def _same_field(got, want):
    if isinstance(got, torch.dtype):
        return got == getattr(torch, jnp.dtype(want).name)
    return got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for reduce in (False, True):
        got, want = get_config(arch), rget_config(arch)
        if reduce:
            got, want = got.reduced(), want.reduced()
        for f in dataclasses.fields(want):
            assert _same_field(getattr(got, f.name), getattr(want, f.name)), \
                (arch, reduce, f.name)
        assert got.sub_quadratic == want.sub_quadratic
        assert got.q_per_kv == want.q_per_kv


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("fn", ["rmsnorm", "layernorm", "apply_rope",
                                "softcap", "gelu"])
def test_layer_functions_match_reference(fn):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    pos = np.tile(np.arange(5, dtype=np.int32) * 7, (2, 1))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    got, want = {
        "rmsnorm": lambda: (layers.rmsnorm(tp, tx, 1e-6),
                            rlayers.rmsnorm(jp, jx, 1e-6)),
        "layernorm": lambda: (layers.layernorm(tp, tx, 1e-6),
                              rlayers.layernorm(jp, jx, 1e-6)),
        "apply_rope": lambda: (
            layers.apply_rope(tx, torch.as_tensor(pos), 10000.0),
            rlayers.apply_rope(jx, jnp.asarray(pos), 10000.0)),
        "softcap": lambda: (layers.softcap(tx, 2.5),
                            rlayers.softcap(jx, 2.5)),
        "gelu": lambda: (layers.gelu(tx), rlayers.gelu(jx)),
    }[fn]()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- whole model
def test_forward_matches_reference(case):
    want, raux = rlm.forward(case.vals, case.rcfg, case.jbatch(case.tokens))
    got, aux = lm.forward(case.model, case.cfg, case.tbatch(case.tokens))
    assert got.shape == (B, S_TOTAL, case.cfg.vocab_size)
    _close(got, want)
    for k in raux:
        _close(aux[k], raux[k])


def test_teacher_forced_decode_matches_reference(case):
    rcfg, cfg, toks, pl = case.rcfg, case.cfg, case.tokens, case.prefix_len
    max_len = pl + S_TOTAL + 4
    rcache, rlast = jax.jit(functools.partial(
        rengine.prefill, cfg=rcfg, max_len=max_len))(
        case.vals, batch=case.jbatch(toks[:, :S_PROMPT]))
    cache, last = engine.prefill(case.model, cfg,
                                 case.tbatch(toks[:, :S_PROMPT]), max_len)
    _close(last, rlast)
    assert set(cache) == set(rcache)
    for key in cache:
        assert cache[key].shape == rcache[key].shape, key
        _close(cache[key], rcache[key])
    rstep = _rdecode(rcfg, pl)
    for i in range(S_PROMPT, S_TOTAL):
        want, rcache = rstep(case.vals, cache=rcache,
                             tokens=jnp.asarray(toks[:, i:i + 1]),
                             cur_pos=jnp.int32(pl + i))
        got, cache = lm.decode_step(case.model, cfg, cache,
                                    torch.as_tensor(toks[:, i:i + 1]),
                                    pl + i, pl)
        _close(got, want, f"decode position {i}")


def test_decode_matches_forward(case):
    """The reference's own rule (``tests/test_serve.py``) on the port;
    dropless for MoE, where capacity couples tokens across positions."""
    cfg = case.cfg
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    toks, pl = torch.as_tensor(case.tokens), case.prefix_len
    full, _ = lm.forward(case.model, cfg, case.tbatch(toks))
    cache, last = engine.prefill(case.model, cfg,
                                 case.tbatch(toks[:, :S_PROMPT]),
                                 pl + S_TOTAL + 4)
    np.testing.assert_allclose(last[:, -1].numpy(),
                               full[:, S_PROMPT - 1].numpy(), **SERVE_TOL)
    for i in range(S_PROMPT, S_TOTAL):
        step, cache = lm.decode_step(case.model, cfg, cache,
                                     toks[:, i:i + 1], pl + i, pl)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(),
                                   **SERVE_TOL, err_msg=f"step {i}")


def test_generate_greedy_matches_reference(case):
    steps = 6
    max_len = case.prefix_len + S_TOTAL + steps + 4
    want, _ = rengine.generate(case.vals, case.rcfg,
                               case.jbatch(case.tokens), steps=steps,
                               max_len=max_len)
    got, cache = engine.generate(case.model, case.cfg,
                                 case.tbatch(case.tokens), steps=steps,
                                 max_len=max_len)
    assert got.dtype == torch.int32 and got.shape == (B, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["h2o_danube_3_4b", "gemma3_27b"])
def test_ring_cache_matches_reference(arch):
    """Decode well past the window (``tests/test_ring_cache.py``): the ring
    stacks stay window-sized and every step matches the reference's, and
    the port's own forward."""
    rcfg = rget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg.window and cfg.window <= 8
    vals, _ = rpr.materialize_init(rlm.init_model, jax.random.PRNGKey(3),
                                   rcfg)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals),
                                 device="cpu")
    s_prompt = 4
    s_total = s_prompt + 2 * cfg.window + 5
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, s_total)).astype(np.int32)
    full, _ = lm.forward(model, cfg, {"tokens": torch.as_tensor(toks)})
    rcache, _ = rengine.prefill(vals, rcfg,
                                {"tokens": jnp.asarray(toks[:, :s_prompt])},
                                max_len=s_total + 2)
    cache, _ = engine.prefill(model, cfg,
                              {"tokens": torch.as_tensor(toks[:, :s_prompt])},
                              s_total + 2)
    assert cache["k_local"].shape[2] == cfg.window
    rstep = _rdecode(rcfg)
    for i in range(s_prompt, s_total):
        tok = toks[:, i:i + 1]
        want, rcache = rstep(vals, cache=rcache, tokens=jnp.asarray(tok),
                             cur_pos=jnp.int32(i))
        got, cache = lm.decode_step(model, cfg, cache, torch.as_tensor(tok),
                                    i)
        _close(got, want, f"{arch} position {i}")
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   **SERVE_TOL)


# -------------------------------------------------------------- MoE layer
def _eidx_cases():
    rng = np.random.default_rng(5)
    skew = rng.choice(8, size=(24, 2), p=[.5, .2, .1, .05, .05, .05, .03,
                                          .02])
    return {"uniform": rng.integers(0, 8, (24, 2)), "skewed": skew,
            "one_expert": np.zeros((16, 2), np.int64),
            "top8_of_128": np.argsort(rng.standard_normal((64, 128)),
                                      axis=1)[:, :8]}


@pytest.mark.parametrize("name", sorted(_eidx_cases()))
@pytest.mark.parametrize("c", [1, 3, 8])
def test_dispatch_indices_exact(name, c):
    eidx = _eidx_cases()[name].astype(np.int32)
    e = 128 if name == "top8_of_128" else 8
    k = eidx.shape[1]
    want = rmoe._dispatch_indices(jnp.asarray(eidx), k, e, c)
    got = moe._dispatch_indices(torch.as_tensor(eidx), k, e, c)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(_eidx_cases()))
@pytest.mark.parametrize("c", [1, 3, 8])
def test_dispatch_buffer_bitwise_reference_scatter(name, c):
    """The port's row-gather dispatch builds the reference's drop-mode
    scatter buffer bit for bit."""
    eidx = _eidx_cases()[name].astype(np.int32)
    e = 128 if name == "top8_of_128" else 8
    tg, k = eidx.shape
    xg = np.random.default_rng(6).standard_normal((tg, 16)).astype(
        np.float32)
    slot, tok, _, _ = rmoe._dispatch_indices(jnp.asarray(eidx), k, e, c)
    want = jnp.zeros((e * c + 1, 16), jnp.float32).at[slot].set(
        jnp.asarray(xg)[tok], mode="drop")[:e * c]
    pslot, ptok, porder, _ = moe._dispatch_indices(torch.as_tensor(eidx), k,
                                                   e, c)
    got = moe._dispatch(torch.as_tensor(xg), pslot, ptok, porder, e, c)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_reference(arch, capacity_factor):
    rcfg = rget_config(arch).reduced().replace(
        capacity_factor=capacity_factor, moe_group_size=12)
    cfg = get_config(arch).reduced().replace(
        capacity_factor=capacity_factor, moe_group_size=12)
    p, _ = rpr.materialize_init(rmoe.init_moe, jax.random.PRNGKey(2), rcfg)
    x = np.random.default_rng(2).standard_normal((2, 18, 64)).astype(
        np.float32)
    # the routing first: equal top-k choices
    xf = x.reshape(3, 12, 64)
    rprobs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xf, p["router"]), -1)
    _, reidx = jax.lax.top_k(rprobs, rcfg.top_k)
    probs = torch.softmax(torch.einsum(
        "gtd,de->gte", torch.as_tensor(xf), torch.tensor(
            np.asarray(p["router"]))), -1)
    np.testing.assert_array_equal(
        torch.topk(probs, cfg.top_k, dim=-1).indices.numpy(),
        np.asarray(reidx))
    want, raux = rmoe.moe(p, jnp.asarray(x), rcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    got, aux = moe.moe(tp, torch.as_tensor(x), cfg)
    _close(got, want)
    for k in raux:
        _close(aux[k], raux[k])


def test_moe_on_other_devices_raises_through_row_gather():
    """Off the CPU the layer launches the kernel or raises; it never
    computes with the plain gather."""
    cfg = get_config("qwen3_moe_235b_a22b").reduced()
    gen = torch.Generator("cpu").manual_seed(0)
    p = {k: v.value.to("meta") for k, v in moe.init_moe(gen, cfg).items()}
    with pytest.raises(ValueError, match="no row_gather kernel"):
        moe.moe(p, torch.ones((1, 4, cfg.d_model), device="meta"), cfg)


@pytest.mark.parametrize("lane_width", [8, 128])
def test_dispatch_pattern_stats_equal(lane_width):
    for eidx in _eidx_cases().values():
        want = rmoe.dispatch_pattern_stats(eidx, lane_width)
        got = moe.dispatch_pattern_stats(eidx, lane_width)
        assert got == want


# ------------------------------------------------- encdec and vlm layers
def _layer_params(init, rcfg, seed):
    """A reference layer's random parameters, as jax arrays and as the
    port's tensors."""
    vals, _ = rpr.materialize_init(init, jax.random.PRNGKey(seed), rcfg)
    return vals, pr.tree_map(lambda a: torch.tensor(np.asarray(a)),
                             jax.tree.map(np.asarray, vals))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(b, s):
    return np.tile(np.arange(s, dtype=np.int32), (b, 1))


def test_cross_attention_matches_reference():
    """Queries of 5 tokens against 11 encoder frames: no RoPE, no mask."""
    rcfg = rget_config("whisper_small").reduced()
    cfg = get_config("whisper_small").reduced()
    jp, tp = _layer_params(rattention.init_attention, rcfg, 11)
    x, enc = _normal((B, 5, cfg.d_model), 12), _normal((B, 11, cfg.d_model),
                                                       13)
    want = rattention.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc),
                                      cfg=rcfg)
    got = attention.cross_attention(tp, torch.as_tensor(x),
                                    torch.as_tensor(enc), cfg=cfg)
    assert got.shape == (B, 5, cfg.d_model)
    _close(got, want)
    # every frame is attended: a frame changed moves every query's output
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    moved = attention.cross_attention(tp, torch.as_tensor(x),
                                      torch.as_tensor(enc2), cfg=cfg)
    assert bool((moved - got).abs().amax(dim=-1).gt(0).all())


def test_encoder_layer_matches_reference():
    rcfg = rget_config("whisper_small").reduced()
    cfg = get_config("whisper_small").reduced()
    jp, tp = _layer_params(rblocks.init_encoder_layer, rcfg, 14)
    x, pos = _normal((B, cfg.enc_len, cfg.d_model), 15), _positions(
        B, cfg.enc_len)
    want = rblocks.encoder_layer(jp, jnp.asarray(x), cfg=rcfg,
                                 positions=jnp.asarray(pos), shd=None)
    got = blocks.encoder_layer(tp, torch.as_tensor(x), cfg=cfg,
                               positions=torch.as_tensor(pos))
    _close(got, want)


@pytest.mark.parametrize("mode", ["forward", "return_kv", "decode"])
def test_decoder_layer_matches_reference(mode):
    """The decoder layer over 6 tokens and 16 encoder frames; ``decode``:
    one token at position 4 against a cache holding 4 earlier tokens
    and the encoder's cross k/v."""
    rcfg = rget_config("whisper_small").reduced()
    cfg = get_config("whisper_small").reduced()
    jp, tp = _layer_params(rblocks.init_decoder_layer, rcfg, 16)
    enc = _normal((B, cfg.enc_len, cfg.d_model), 17)
    if mode == "decode":
        kh, hd, t = cfg.num_kv_heads, cfg.head_dim, 8
        kv = {k: _normal((B, t, kh, hd), 18 + i) for i, k in enumerate(
            ("k", "v"))}
        for a in kv.values():
            a[:, 4:] = 0.0
        ekv = {k: _normal((B, cfg.enc_len, kh, hd), 20 + i)
               for i, k in enumerate(("k", "v"))}
        x = _normal((B, 1, cfg.d_model), 22)
        want, wcache = rblocks.decoder_layer_decode(
            jp, jnp.asarray(x), {k: jnp.asarray(a) for k, a in kv.items()},
            {k: jnp.asarray(a) for k, a in ekv.items()}, cfg=rcfg,
            cur_pos=4, shd=None)
        tcache = {k: torch.tensor(a) for k, a in kv.items()}
        got, cache = blocks.decoder_layer_decode(
            tp, torch.as_tensor(x), tcache,
            {k: torch.tensor(a) for k, a in ekv.items()}, cfg=cfg,
            cur_pos=4)
        _close(got, want)
        for k in kv:
            _close(cache[k], wcache[k], k)
        return
    x, pos = _normal((B, 6, cfg.d_model), 23), _positions(B, 6)
    rk = mode == "return_kv"
    want = rblocks.decoder_layer(jp, jnp.asarray(x), jnp.asarray(enc),
                                 cfg=rcfg, positions=jnp.asarray(pos),
                                 shd=None, return_kv=rk)
    got = blocks.decoder_layer(tp, torch.as_tensor(x), torch.as_tensor(enc),
                               cfg=cfg, positions=torch.as_tensor(pos),
                               return_kv=rk)
    if rk:
        (want, wkv), (got, gkv) = want, got
        assert len(gkv) == len(wkv) == 4
        for g, w in zip(gkv, wkv):
            assert tuple(g.shape) == w.shape
            _close(g, w)
    _close(got, want)


@pytest.mark.parametrize("mode", ["forward", "decode"])
def test_vlm_layer_with_a_prefix_matches_reference(mode):
    """paligemma's layer under the prefix-LM mask: over 4 prefix and 6
    token positions, and decoding at position 2 of a 6-slot prefix (the
    slots after it still seen).  The same layer run causal (the dense
    family's mask) on the same inputs fails the rule."""
    rcfg = rget_config("paligemma_3b").reduced()
    cfg = get_config("paligemma_3b").reduced()
    causal = cfg.replace(family="dense")
    jp, tp = _layer_params(rblocks.init_dense_layer, rcfg, 24)
    if mode == "forward":
        prefix, s = 4, 10
        x, pos = _normal((B, s, cfg.d_model), 25), _positions(B, s)
        want, _ = rblocks.dense_layer(jp, jnp.asarray(x), cfg=rcfg,
                                      kind_flag=0, positions=jnp.asarray(pos),
                                      shd=None, prefix_len=prefix)

        def run(c):
            return blocks.dense_layer(tp, torch.as_tensor(x), cfg=c,
                                      kind_flag=0,
                                      positions=torch.as_tensor(pos),
                                      prefix_len=prefix)[0]
    else:
        prefix, cur, t = 6, 2, 8
        kh, hd = cfg.num_kv_heads, cfg.head_dim
        kv = {k: _normal((B, t, kh, hd), 26 + i)
              for i, k in enumerate(("k", "v"))}
        x = _normal((B, 1, cfg.d_model), 28)
        want, _ = rblocks.dense_layer_decode(
            jp, jnp.asarray(x), {k: jnp.asarray(a) for k, a in kv.items()},
            cfg=rcfg, kind_flag=0, cur_pos=cur, shd=None, prefix_len=prefix)

        def run(c):
            cache = {k: torch.tensor(a) for k, a in kv.items()}
            return blocks.dense_layer_decode(
                tp, torch.as_tensor(x), cache, cfg=c, kind_flag=0,
                cur_pos=cur, prefix_len=prefix)[0]
    _close(run(cfg), want)
    with pytest.raises(AssertionError):
        _close(run(causal), want)


# -------------------------------------------------------- port-only checks
def test_unknown_family_raises():
    cfg = get_config("granite_3_2b").reduced().replace(family="retnet")
    with pytest.raises(ValueError, match="unknown model family"):
        lm.init_model(cfg, device="cpu")


def test_init_model_is_seeded_and_sampling_uses_the_generator():
    cfg = get_config("qwen3_moe_235b_a22b").reduced()

    def run(seed):
        gen = torch.Generator("cpu").manual_seed(seed)
        model = lm.init_model(cfg, generator=gen, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen,
                             dtype=torch.int32)
        out, _ = engine.generate(model, cfg, {"tokens": toks}, steps=4,
                                 max_len=12, temperature=0.8, generator=gen)
        return model, out

    (m1, t1), (m2, t2), (_, t3) = run(0), run(0), run(1)
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(),
                                                 m2.parameters()))
    assert len(m1.layers) == cfg.num_layers
    assert m1.layers[0].moe.w_gate.shape == (cfg.num_experts, cfg.d_model,
                                             cfg.moe_d_ff)


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "qwen3-moe-235b-a22b", "--batch", "2",
                       "--prompt-len", "6", "--steps", "3", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 3) and "[serve] arch=qwen3-moe-235b-a22b" in out
    assert "6 tokens in" in out


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_serve_launcher_draws_the_modality_inputs(arch, capsys):
    """whisper's frames and paligemma's patches come from the launcher's
    generator; paligemma's cache holds its prefix too."""
    from repro_torch.launch import serve
    toks = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "6",
                       "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 3) and f"[serve] arch={arch}" in out
    assert toks.dtype == torch.int32
