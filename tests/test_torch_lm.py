"""LM serving in the port (``repro_torch.configs``, ``models``,
``serve.engine``, ``launch.serve``) against the JAX package.

The reference's ``materialize_init`` weights cross into the port through
``repro_torch.convert.lm_params_from_numpy``; tokens are made with numpy.
At ``reduced()`` configs (float32, 2 layers, d 64) for every ``dense`` and
``moe`` arch:

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
  ``dispatch_pattern_stats`` equal.

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
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import params as rpr
from repro.serve import engine as rengine

from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers, lm, moe
from repro_torch.serve import engine

LM_ARCHS = ["granite_3_2b", "gemma_7b", "gemma3_27b", "h2o_danube_3_4b",
            "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"]
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


@dataclasses.dataclass
class Case:
    rcfg: object
    cfg: object
    vals: dict
    model: torch.nn.Module
    tokens: np.ndarray


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
    return Case(rcfg, cfg, vals, model, tokens)


def _rdecode(rcfg):
    return jax.jit(functools.partial(rlm.decode_step, cfg=rcfg))


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
    want, raux = rlm.forward(case.vals, case.rcfg,
                             {"tokens": jnp.asarray(case.tokens)})
    got, aux = lm.forward(case.model, case.cfg,
                          {"tokens": torch.as_tensor(case.tokens)})
    _close(got, want)
    for k in raux:
        _close(aux[k], raux[k])


def test_teacher_forced_decode_matches_reference(case):
    rcfg, cfg, toks = case.rcfg, case.cfg, case.tokens
    rcache, rlast = jax.jit(functools.partial(
        rengine.prefill, cfg=rcfg, max_len=S_TOTAL + 4))(
        case.vals, batch={"tokens": jnp.asarray(toks[:, :S_PROMPT])})
    cache, last = engine.prefill(
        case.model, cfg, {"tokens": torch.as_tensor(toks[:, :S_PROMPT])},
        S_TOTAL + 4)
    _close(last, rlast)
    assert set(cache) == set(rcache)
    for key in cache:
        _close(cache[key], rcache[key])
    rstep = _rdecode(rcfg)
    for i in range(S_PROMPT, S_TOTAL):
        want, rcache = rstep(case.vals, cache=rcache,
                             tokens=jnp.asarray(toks[:, i:i + 1]),
                             cur_pos=jnp.int32(i))
        got, cache = lm.decode_step(case.model, cfg, cache,
                                    torch.as_tensor(toks[:, i:i + 1]), i)
        _close(got, want, f"decode position {i}")


def test_decode_matches_forward(case):
    """The reference's own rule (``tests/test_serve.py``) on the port;
    dropless for MoE, where capacity couples tokens across positions."""
    cfg = case.cfg
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    toks = torch.as_tensor(case.tokens)
    full, _ = lm.forward(case.model, cfg, {"tokens": toks})
    cache, last = engine.prefill(case.model, cfg,
                                 {"tokens": toks[:, :S_PROMPT]}, S_TOTAL + 4)
    np.testing.assert_allclose(last[:, -1].numpy(),
                               full[:, S_PROMPT - 1].numpy(), **SERVE_TOL)
    for i in range(S_PROMPT, S_TOTAL):
        step, cache = lm.decode_step(case.model, cfg, cache,
                                     toks[:, i:i + 1], i)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(),
                                   **SERVE_TOL, err_msg=f"step {i}")


def test_generate_greedy_matches_reference(case):
    steps = 6
    want, _ = rengine.generate(
        case.vals, case.rcfg, {"tokens": jnp.asarray(case.tokens)},
        steps=steps, max_len=S_TOTAL + steps + 4)
    got, cache = engine.generate(
        case.model, case.cfg, {"tokens": torch.as_tensor(case.tokens)},
        steps=steps, max_len=S_TOTAL + steps + 4)
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


# -------------------------------------------------------- port-only checks
@pytest.mark.parametrize("arch", ["whisper_small", "rwkv6_3b",
                                  "zamba2_1p2b", "paligemma_3b"])
def test_other_families_raise_with_their_item(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP item 1[5-8]"):
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
