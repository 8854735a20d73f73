"""The port's mixture of experts against the JAX package's: the routing
(`top_k_dispatch`, `load_balancing_loss`), `MoEMLP` and its gradients,
the aux loss as flax's `intermediates` hold it, the expert weights'
initial scale, a MoE `Llama`'s logits, the engine's greedy tokens
(bucketed, chunked, paged with a prefix hit, speculative) and train
steps, on the same inputs (seeded numpy) and the same weights (carried
across with `params_from_jax`).  f32 compute on both sides; JAX stays on
the CPU."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.models import llama as jl
from skypilot_tpu.models import moe as jm
from skypilot_tpu.parallel.mesh import MeshPlan, build_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.inference import engine as torch_engine
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models import moe as tm
from skypilot_tpu_torch.models.convert import (moe_params_from_jax,
                                               params_from_jax)
from skypilot_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

# tiny with 4 experts, top-2 at the default capacity factor 1.25.
MOE = dict(n_experts=4)
CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32,
                            **MOE)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32,
                            **MOE)
F32_ATOL = 1e-4            # as tests/test_torch_llama.py
MOE_TOL = 2e-4             # as tests/test_moe_pipeline.py:69
ENGINE_KW = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3)
PS = 8                     # page size of the paged engines
WAIT_S = 60                # every wait on Request.tokens()


def _rng(seed):
    return np.random.default_rng(seed)


def _probs(b, s, e, seed, skew=0.0):
    """Softmax of seeded normal logits; `skew` favours expert 0."""
    logits = _rng(seed).standard_normal((b, s, e)).astype(np.float32)
    logits[..., 0] += skew
    return np.array(jax.nn.softmax(logits, axis=-1))


def _tokens(shape, seed=1):
    return _rng(seed).integers(0, CFG_T.vocab_size, shape).astype(np.int32)


def _prompt(n, seed):
    return _rng(seed).integers(1, CFG_T.vocab_size, n).tolist()


# ----- routing ---------------------------------------------------------------
def _tied_probs():
    """Rows with exact ties: all four equal, two pairs, and a tie for
    second place; argmax must take the first maximum on both sides."""
    rows = [[0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1],
            [0.1, 0.4, 0.1, 0.4], [0.5, 0.2, 0.2, 0.1],
            [0.1, 0.2, 0.2, 0.5], [0.25, 0.25, 0.25, 0.25]]
    return np.asarray([rows, rows[::-1]], np.float32)        # [2, 6, 4]


DISPATCH_CASES = {
    # name: (probs, top_k, capacity factor)
    'ties': (_tied_probs(), 2, 1.25),
    'drops': (_probs(2, 16, 4, 3, skew=2.0), 2, 1.25),
    'decode_s1': (_probs(4, 1, 8, 4), 2, 1.25),
    'verify_s5': (_probs(3, 5, 8, 5), 2, 1.25),
    'top1_skewed': (np.tile(np.asarray([[[0.9, 0.1]]], np.float32),
                            (2, 4, 1)), 1, 0.5),
}


@pytest.mark.parametrize('case', sorted(DISPATCH_CASES))
def test_top_k_dispatch_matches_jax(case):
    probs, top_k, factor = DISPATCH_CASES[case]
    b, s, e = probs.shape
    capacity = tm.capacity_of(s, e, top_k, factor)
    assert capacity == max(1, int(factor * s * top_k / e))
    disp_j, comb_j = jm.top_k_dispatch(jnp.asarray(probs), top_k, capacity)
    disp_t, comb_t = tm.top_k_dispatch(torch.from_numpy(probs), top_k,
                                       capacity)
    np.testing.assert_array_equal(disp_t.numpy(), np.asarray(disp_j))
    np.testing.assert_allclose(comb_t.numpy(), np.asarray(comb_j), atol=1e-6,
                               rtol=0)
    kept, chosen = float(disp_t.sum()), b * s * top_k
    if case == 'drops':
        assert kept < chosen      # expert 0 is most tokens' first choice
    if case == 'verify_s5':
        # k+1 = 5 tokens, top-2 of 8 experts: one slot per expert, so two
        # tokens picking the same expert collide (the reference's
        # behaviour, reproduced).
        assert capacity == 1 and kept < chosen


def test_load_balancing_loss_matches_jax():
    probs = _probs(2, 16, 4, 7)
    cap = tm.capacity_of(16, 4, 2, 1.25)
    disp_j, _ = jm.top_k_dispatch(jnp.asarray(probs), 2, cap)
    want = float(jm.load_balancing_loss(jnp.asarray(probs), disp_j))
    disp_t, _ = tm.top_k_dispatch(torch.from_numpy(probs), 2, cap)
    got = float(tm.load_balancing_loss(torch.from_numpy(probs), disp_t))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ----- the layer -------------------------------------------------------------
def _layers(factor, dim=16, ffn=32, e=4, seed=1):
    layer_j = jm.MoEMLP(dim=dim, ffn_dim=ffn, n_experts=e, top_k=2,
                        capacity_factor=factor, dtype=jnp.float32)
    x = _rng(seed).standard_normal((2, 6, dim)).astype(np.float32)
    params = meta.unbox(layer_j.init(jax.random.PRNGKey(seed),
                                     jnp.asarray(x))['params'])
    layer_t = tm.MoEMLP(dim, ffn, e, top_k=2, capacity_factor=factor,
                        dtype=torch.float32)
    layer_t.load_state_dict(moe_params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True, assign=True)
    return layer_j, params, layer_t, x


@pytest.mark.parametrize('factor', [1.25, 8.0])
def test_moe_mlp_matches_flax(factor):
    layer_j, params, layer_t, x = _layers(factor)
    want = np.asarray(layer_j.apply({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        got = layer_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=MOE_TOL, rtol=MOE_TOL)


@pytest.mark.parametrize('factor', [1.25, 8.0])
def test_moe_mlp_grads_match_jax(factor):
    """d(sum(out * r) + aux) by the router, the experts and the input:
    the router's gradient arrives through each gate and its normaliser
    and through the aux loss."""
    layer_j, params, layer_t, x = _layers(factor)
    r = _rng(9).standard_normal(x.shape).astype(np.float32)

    def loss_j(p, xx):
        out, inter = layer_j.apply({'params': p}, xx,
                                   mutable=['intermediates'])
        (aux,) = inter['intermediates']['moe_aux_loss']
        return jnp.sum(out * r) + aux

    g_p, g_x = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))
    want = moe_params_from_jax(jax.tree.map(np.asarray, g_p))
    layer_t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer_t(xt, return_aux=True)
    (out * torch.from_numpy(r)).sum().add(aux).backward()
    for name, p in layer_t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)
    assert float(layer_t.router.weight.grad.abs().max()) > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-4,
                               rtol=0)


# ----- the model -------------------------------------------------------------
@pytest.fixture(scope='module')
def ref():
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    return model_j, params_j, params_t, tl.Llama(CFG_T, params_t)


def test_convert_carries_the_experts(ref):
    _, params_j, params_t, _ = ref
    moe_j = params_j['layer_1']['moe_mlp']
    assert tuple(params_t['layers.1.moe_mlp.router.weight'].shape) == (
        4, CFG_T.dim)
    np.testing.assert_array_equal(
        params_t['layers.1.moe_mlp.router.weight'].numpy(),
        np.asarray(moe_j['router']['kernel']).T)
    for name in ('w_gate', 'w_up', 'w_down'):
        np.testing.assert_array_equal(
            params_t[f'layers.1.moe_mlp.{name}'].numpy(),
            np.asarray(moe_j[name]))
    assert not any('.mlp.' in k for k in params_t)
    assert len(params_t) == 3 + 10 * CFG_T.n_layers


def test_moe_llama_logits_match_flax(ref):
    model_j, params_j, _, model_t = ref
    toks = _tokens((2, 32))
    want = np.asarray(jax.jit(model_j.apply)({'params': params_j}, toks))
    with torch.no_grad():
        got = model_t(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_aux_losses_equal_flax_intermediates(ref):
    """`return_aux=True` gives what flax sows into `intermediates` when
    the caller makes that collection mutable, layer by layer, in the
    training forward (remat on) and the serving prefill."""
    model_j, params_j, params_t, _ = ref
    toks = _tokens((2, 16), seed=3)
    _, inter = model_j.apply({'params': params_j}, toks,
                             mutable=['intermediates'])
    want = [float(inter['intermediates'][f'layer_{i}']['moe_mlp']
                  ['moe_aux_loss'][0]) for i in range(CFG_T.n_layers)]
    remat = tl.Llama(dataclasses.replace(CFG_T, remat=True),
                     params_t).requires_grad_(True)
    logits, aux = remat(torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose([float(a) for a in aux], want, atol=1e-6,
                               rtol=0)
    assert aux[0].requires_grad and logits.shape == (2, 16, 256)
    with torch.no_grad():
        _, _, aux_d = remat(torch.from_numpy(toks), decode=True,
                            return_aux=True)
        dense = tl.Llama(tl.LLAMA_CONFIGS['tiny'], tl.init_params(
            tl.LLAMA_CONFIGS['tiny'], 'cpu'))
        assert dense(torch.from_numpy(toks), return_aux=True)[1] == []
    np.testing.assert_allclose([float(a) for a in aux_d], want, atol=1e-6,
                               rtol=0)


def test_init_params_expert_std_follows_flax_fan_in():
    """Flax's lecun_normal over [E, D, F] counts the expert axis into the
    fan-in (d*e; f*e for w_down): init_params' draws have that std (the
    truncated normal's std equals the target once corrected), as do
    flax's own."""
    cfg = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], n_experts=8,
                              n_layers=1)
    params = tl.init_params(cfg, 'cpu', torch.Generator().manual_seed(3))
    flax_p = meta.unbox(jl.Llama(dataclasses.replace(
        jl.LLAMA_CONFIGS['tiny'], n_experts=8, n_layers=1)).init(
            jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))['params'])
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    for name, fan_in in (('w_gate', d * e), ('w_up', d * e),
                         ('w_down', f * e)):
        want = fan_in ** -0.5
        got = float(params[f'layers.0.moe_mlp.{name}'].std())
        flax_std = float(np.asarray(flax_p['layer_0']['moe_mlp'][name]).std())
        # 65,536 draws: the sample std's relative error is ~0.3%.
        assert abs(got / want - 1) < 0.02, (name, got, want)
        assert abs(flax_std / want - 1) < 0.02, (name, flax_std, want)
    router = float(params['layers.0.moe_mlp.router.weight'].std())
    assert abs(router * d ** 0.5 - 1) < 0.25     # 512 draws


# ----- the engine ------------------------------------------------------------
@pytest.fixture(scope='module')
def jax_streams(ref):
    """Greedy streams of one shared JAX engine per config, one prompt at
    a time (so admission order cannot differ)."""
    model_j, params_j, _, _ = ref
    engines = {}

    def streams(prompts, n_new, **overrides):
        key = tuple(sorted(overrides.items()))
        if key not in engines:
            engines[key] = jax_engine.DecodeEngine(
                model_j, params_j,
                jax_engine.EngineConfig(**dict(ENGINE_KW, **overrides)))
        eng = engines[key]
        outs = []
        for p in prompts:
            req = eng.submit(list(p), n_new)
            while req.finished_at is None:
                eng.step()
            outs.append(req.tokens())
        return outs

    return streams


def _drained(req):
    """The request's tokens, read with a timeout (`Request.tokens()`
    blocks until the engine finishes the request)."""
    box = []
    reader = threading.Thread(target=lambda: box.append(req.tokens()),
                              daemon=True)
    reader.start()
    reader.join(WAIT_S)
    assert not reader.is_alive(), 'Request.tokens() did not return'
    return box[0]


def _serve_each(engine, prompts, n_new, limit=3000):
    outs = []
    for p in prompts:
        req = engine.submit(list(p), n_new)
        for _ in range(limit):
            engine.step()
            if req.finished_at is not None:
                break
        assert req.finished_at is not None, 'request did not finish'
        outs.append(_drained(req))
    return outs


def _engine(model, **overrides):
    return torch_engine.DecodeEngine(
        model, torch_engine.EngineConfig(**dict(ENGINE_KW, **overrides)),
        device='cpu')


ENGINE_CASES = {
    # name: (prompts, engine overrides)
    'bucketed': ([_prompt(5, 10), _prompt(13, 11)], {}),
    'chunked': ([_prompt(40, 12)], {}),
    'paged_prefix_hit': ([_prompt(16, 13) + _prompt(4, 14),
                          _prompt(16, 13) + _prompt(3, 15)],
                         dict(kv_page_size=PS)),
    'speculative_k4': ([_prompt(7, 16), _prompt(40, 17)],
                       dict(kv_page_size=PS, speculation=4)),
}


@pytest.mark.parametrize('case', sorted(ENGINE_CASES))
def test_engine_greedy_tokens_match_jax(ref, jax_streams, case):
    """A MoE model goes through the same prefill (S = the bucket), chunk,
    decode (S = 1), paged and verify (S = k+1) paths as a dense one, with
    the capacity of each call's own S: the port's tokens are the JAX
    engine's."""
    _, _, _, model = ref
    prompts, kw = ENGINE_CASES[case]
    engine = _engine(model, **kw)
    got = _serve_each(engine, prompts, 10)
    assert got == jax_streams(prompts, 10, **kw)
    if case == 'paged_prefix_hit':
        assert engine._radix.match(prompts[0], 2)[0] == 2


def test_engine_update_params_takes_the_moe_state_dict(ref):
    """An engine over a MoE model accepts a MoE state dict and serves
    from it: tokens equal to a fresh engine over the new weights."""
    _, _, _, model = ref
    new = tl.init_params(CFG_T, 'cpu', torch.Generator().manual_seed(11))
    engine = _engine(tl.Llama(CFG_T, dict(model.state_dict())))
    prompt = _prompt(6, 20)
    before = _serve_each(engine, [prompt], 6)
    engine.update_params(new)
    after = _serve_each(engine, [prompt], 6)
    fresh = _serve_each(_engine(tl.Llama(CFG_T, {
        k: v.clone() for k, v in new.items()})), [prompt], 6)
    assert after == fresh and after != before
    with pytest.raises(ValueError, match='lacks'):
        engine.update_params({k: v for k, v in new.items()
                              if 'w_down' not in k})


# ----- training --------------------------------------------------------------
# As tests/test_torch_train.py: f32 summation order only; Adam near eps
# amplifies it in a handful of elements.  At lr 1e-2 one lm_head element
# whose gradient is 2.3e-8 (near eps, 1e-8) drifted 1.06e-4 in the first
# non-zero update, so the steps run at lr 1e-3 (as tests/test_torch_rl.py
# does), which keeps an Adam step 10x the bounds below.
TRAIN_PARAM_ATOL, TRAIN_LOSS_RTOL = 1e-5, 1e-5
TRAIN_PARAM_ATOL_ALL, TRAIN_PARAM_OUTLIER_SHARE = 1e-4, 1e-3


@pytest.mark.parametrize('n_steps', [1, 5])
def test_train_steps_match_jax_trainer(n_steps):
    """Cross-entropy only (the aux loss is not added, as in the JAX
    trainer), AdamW with the clip and schedule: the port's MoE steps
    against the JAX trainer's on the same weights and tokens."""
    tcfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50)
    mesh = build_mesh(MeshPlan(1, 8, 1))
    tokens = _tokens((8, 32), seed=5)
    state, shardings = jt.make_train_state(
        jl.Llama(CFG_J, mesh), mesh, jax.random.PRNGKey(0),
        jnp.asarray(tokens), jt.TrainConfig(**tcfg))
    step_j = jt.make_sharded_train_step(mesh, shardings)
    init = jax.tree.map(np.asarray, meta.unbox(state.params))
    model = tl.Llama(CFG_T, params_from_jax(init))
    state_t = tt.make_train_state(model, tt.TrainConfig(**tcfg))
    step_t = tt.make_train_step(tt.TrainConfig(**tcfg))
    for i in range(n_steps):
        state, m_j = step_j(state, jnp.asarray(tokens))
        state_t, m_t = step_t(state_t, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m_t['loss']), float(m_j['loss']),
                                   rtol=TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(float(m_t['grad_norm']),
                                   float(m_j['grad_norm']), rtol=1e-4)
        assert int(m_t['step']) == int(m_j['step']) == i + 1
    want = params_from_jax(jax.tree.map(np.asarray,
                                        meta.unbox(state.params)))
    got = model.state_dict()
    assert set(got) == set(want)
    for name in want:
        diff = np.abs(got[name].numpy() - want[name].numpy())
        assert diff.max() <= TRAIN_PARAM_ATOL_ALL, (name, diff.max())
        assert ((diff > TRAIN_PARAM_ATOL).mean() <=
                TRAIN_PARAM_OUTLIER_SHARE), name
