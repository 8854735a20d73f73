"""The port's mixture of experts under a mesh (skypilot_tpu_torch) against
the JAX package's: expert-parallel training (the experts over 'expert',
the dispatched slots exchanged by all_to_all) at expert=4, expert x
data, expert x fsdp and expert x tensor, step by step against the JAX
`make_sharded_train_step` on the same mesh shape; each rank's E / expert
experts; the loss falling over 6 steps (mirror of
tests/test_moe_pipeline.py::test_moe_llama_trains_expert_parallel); an
expert-parallel checkpoint restored on another plan; and a MoE model
served at tensor=2 (greedy tokens equal to the JAX sharded engine's).

The port's ranks are spawned gloo processes on the CPU (one module pool
of 2 and one of 4, one intra-op thread each, under the rank-pool lock
of tests/torch_rank_lock.py), given the GLOBAL batch on every rank; the
JAX references run in this process on as many of the 8 virtual CPU
devices of tests/conftest.py.  f32 compute on both sides.

This module imports no JAX at its top: the ranks import it by name to
find their functions.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch_rank_lock

from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import shard_params
from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh
from skypilot_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

MOE = dict(n_experts=4, moe_capacity_factor=4.0)
CFG = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32,
                          **MOE)
# As tests/test_torch_sharded_train.py (lr 1e-3 for parity, 1e-2 for the
# loss-decrease mirror, as the JAX test's), and its tolerances.
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50)
TCFG_FAST = dict(TCFG, learning_rate=1e-2)
BATCH, SEQ, STEPS = 8, 32, 3
TRAIN_LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
TRAIN_PARAM_ATOL_ALL = 1e-4
POOL_TIMEOUT_S = 120.0
SERVE_KW = dict(n_slots=2, prefill_buckets=(8,), steps_per_call=2)
PROMPT, N_NEW = [5, 17, 3], 4

PLANS = {
    'expert4': dict(expert=4),
    'expert2_data2': dict(expert=2, data=2),
    'expert2_fsdp2': dict(expert=2, fsdp=2),
    'expert2_tensor2': dict(expert=2, tensor=2),
}


def tokens_of(seed=5, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (batch, seq)).astype(np.int32)


def world_of(plan_kw):
    return MeshPlan(**plan_kw).num_devices


# ----- in the ranks ----------------------------------------------------------
def rank_model(full, plan_kw):
    mesh = build_mesh(MeshPlan(**plan_kw), devices=['cpu'] * world_of(
        plan_kw), backend='gloo')
    return tl.Llama(CFG, shard_params(full, mesh), mesh), mesh


def gathered_params(state):
    """Every parameter whole, on every rank (collective), copied: a
    parameter whole on every rank (fsdp=1) gathers to its own storage,
    which the next step updates in place."""
    return {name: state.layout.global_view(p, name).full_tensor()
            .numpy().copy() for name, p in state.model.named_parameters()}


def rank_steps(full, plan_kw, tokens, n_steps, tcfg=TCFG, ckpt_dir=None):
    """`n_steps` sharded steps; every rank returns its metrics and its
    local expert shape, rank 0 the gathered parameters too."""
    model, mesh = rank_model(full, plan_kw)
    state = tt.make_train_state(model, tt.TrainConfig(**tcfg), mesh)
    step = tt.make_sharded_train_step(mesh, tt.TrainConfig(**tcfg))
    losses, norms = [], []
    for _ in range(n_steps):
        state, m = step(state, torch.from_numpy(tokens))
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    w_gate = dict(state.model.named_parameters())['layers.0.moe_mlp.w_gate']
    out = {'losses': losses, 'norms': norms,
           'expert_shape': tuple(w_gate.shape),
           'moment_shape': tuple(state.optimizer.state[w_gate][
               'exp_avg'].shape)}
    params = gathered_params(state)
    if ckpt_dir is not None:
        from skypilot_tpu_torch.train.checkpoint import CheckpointManager
        CheckpointManager(ckpt_dir).save(int(state.step), state)
    if mesh.rank == 0:
        out['params'] = params
    return out


def rank_restore(full, plan_kw, ckpt_dir):
    """A Trainer at `plan_kw` resumed from `ckpt_dir`: the step, its whole
    params and the loss of one step more."""
    model, mesh = rank_model(full, plan_kw)
    trainer = tt.Trainer(model, tt.TrainConfig(**TCFG),
                         checkpoint_dir=ckpt_dir, mesh=mesh)
    resumed = trainer.restore_if_available()
    params = gathered_params(trainer.state)
    trainer.state, m = trainer.train_step(trainer.state,
                                          torch.from_numpy(tokens_of()))
    return {'resumed': resumed, 'loss': float(m['loss']),
            'params': params if mesh.rank == 0 else None}


def rank_serve(full, tensor, paged):
    """A MoE engine over `tensor` gloo ranks: rank 0 serves PROMPT, the
    others follow; every rank returns the tokens and its KV heads."""
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    mesh = build_serve_mesh(tensor, CFG.n_heads, CFG.n_kv_heads,
                            devices=['cpu'] * tensor, backend='gloo')
    model = tl.Llama(CFG, shard_params(full, mesh), mesh)
    kw = dict(SERVE_KW, kv_page_size=8) if paged else SERVE_KW
    engine = DecodeEngine(model, EngineConfig(mesh=mesh, **kw))
    heads = model.layers[0].attn.n_kv_heads
    experts = tuple(model.layers[0].moe_mlp.w_down.shape)
    # The gauges' byte count: the whole weights', as one device holds
    # them.
    whole_bytes = engine._global_param_bytes()  # pylint: disable=protected-access
    if not engine.leader:
        return ([r.tokens() for r in engine.follow(record=True)], heads,
                experts, whole_bytes)
    try:
        req = engine.submit(PROMPT, N_NEW)
        for _ in range(3000):
            if req.finished_at is not None:
                break
            engine.step()
        return [req.tokens()], heads, experts, whole_bytes
    finally:
        engine.close()


def rank_load_slices(ckpt_dir, tensor):
    """This rank's MoE slices as load_serving_params reads them from a
    one-device checkpoint under a tensor=`tensor` serve mesh."""
    from skypilot_tpu_torch.inference.weights import load_serving_params
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    mesh = build_serve_mesh(tensor, CFG.n_heads, CFG.n_kv_heads,
                            devices=['cpu'] * tensor, backend='gloo')
    loaded = load_serving_params(ckpt_dir, device='cpu', mesh=mesh)
    tl.Llama(CFG, loaded, mesh)       # the model takes them as they are
    return mesh.rank, {n: t.numpy() for n, t in loaded.items()}


# ----- the JAX side ----------------------------------------------------------
def cfg_j():
    import jax.numpy as jnp
    from skypilot_tpu.models import llama as jl
    return dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32,
                               **MOE)


def jax_run(plan_kw, tokens, n_steps):
    """(initial whole state dict, losses, norms, final whole state dict)
    of the JAX sharded step on the same mesh shape."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta
    from skypilot_tpu.models import llama as jl
    from skypilot_tpu.parallel.mesh import MeshPlan as JPlan
    from skypilot_tpu.parallel.mesh import build_mesh as jbuild
    from skypilot_tpu.train import trainer as jt
    from skypilot_tpu_torch.models.convert import params_from_jax
    mesh = jbuild(JPlan(**plan_kw), jax.devices()[:world_of(plan_kw)])
    state, shardings = jt.make_train_state(
        jl.Llama(cfg_j(), mesh), mesh, jax.random.PRNGKey(0),
        jnp.asarray(tokens), jt.TrainConfig(**TCFG))
    step = jt.make_sharded_train_step(mesh, shardings)

    def whole(st):
        return params_from_jax(jax.tree.map(np.asarray,
                                            meta.unbox(st.params)))

    init = whole(state)
    losses, norms = [], []
    for _ in range(n_steps):
        state, m = step(state, jnp.asarray(tokens))
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    return init, losses, norms, whole(state)


@pytest.fixture(scope='module')
def pools():
    """Rank pools of 2 and 4 at niceness +10, computing under the
    rank-pool lock (one file's ranks at a time)."""
    made = {n: torch_rank_lock.LockedPool(__name__, n, POOL_TIMEOUT_S)
            for n in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


@pytest.fixture(scope='module')
def jax_ref():
    cache = {}

    def get(plan):
        if plan not in cache:
            cache[plan] = jax_run(PLANS[plan], tokens_of(), STEPS)
        return cache[plan]
    return get


def run_ranks(pools, plan_kw, fn, *args):
    return pools[world_of(plan_kw)].run(fn, *args, timeout_s=POOL_TIMEOUT_S)


# ----- tests -----------------------------------------------------------------
@pytest.mark.parametrize('plan', sorted(PLANS))
def test_moe_sharded_steps_match_jax(pools, jax_ref, plan):
    """Each step's loss and grad norm within the sharded-training
    tolerances of the JAX step on the same mesh shape, every rank the
    same, the trained parameters within TRAIN_PARAM_ATOL_ALL; each rank
    holds E / expert experts (and F / tensor of each), as does its AdamW
    moment."""
    init, losses, norms, final = jax_ref(plan)
    plan_kw = PLANS[plan]
    out = run_ranks(pools, plan_kw, rank_steps, init, plan_kw, tokens_of(),
                    STEPS)
    for o in out:
        assert (o['losses'], o['norms']) == (out[0]['losses'],
                                             out[0]['norms'])
        want = (CFG.n_experts // plan_kw['expert'], CFG.dim,
                CFG.ffn_dim // plan_kw.get('tensor', 1))
        assert o['expert_shape'] == o['moment_shape'] == want
    np.testing.assert_allclose(out[0]['losses'], losses,
                               rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(out[0]['norms'], norms, rtol=GRAD_NORM_RTOL)
    for name, want in final.items():
        np.testing.assert_allclose(out[0]['params'][name], want, rtol=0,
                                   atol=TRAIN_PARAM_ATOL_ALL, err_msg=name)


def test_moe_llama_trains_expert_parallel(pools, jax_ref):
    """Mirror of test_moe_llama_trains_expert_parallel: 6 steps at
    expert=2 x data=2, lr 1e-2, the loss falls."""
    init = jax_ref('expert2_data2')[0]
    plan_kw = PLANS['expert2_data2']
    losses = run_ranks(pools, plan_kw, rank_steps, init, plan_kw,
                       tokens_of(), 6, TCFG_FAST)[0]['losses']
    assert losses[-1] < losses[0], losses


def test_expert_parallel_checkpoint_reshards(pools, jax_ref, tmp_path):
    """A step saved at expert=4 restores bit-exactly at expert=2 x
    tensor=2 and on one device; both restored trainers take the same next
    step."""
    init = jax_ref('expert4')[0]
    ckpt = str(tmp_path / 'ckpt')
    saved = run_ranks(pools, PLANS['expert4'], rank_steps, init,
                      PLANS['expert4'], tokens_of(), 1, TCFG, ckpt)[0]
    restored = run_ranks(pools, PLANS['expert2_tensor2'], rank_restore,
                         init, PLANS['expert2_tensor2'], ckpt)
    assert [r['resumed'] for r in restored] == [1] * 4
    for name, want in saved['params'].items():
        np.testing.assert_array_equal(restored[0]['params'][name], want)
    model = tl.Llama(CFG, {k: v.clone() for k, v in init.items()})
    trainer = tt.Trainer(model, tt.TrainConfig(**TCFG), checkpoint_dir=ckpt,
                         device='cpu')
    assert trainer.restore_if_available() == 1
    for name, p in trainer.state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved['params'][name])
    trainer.state, m = trainer.train_step(trainer.state,
                                          torch.from_numpy(tokens_of()))
    np.testing.assert_allclose(float(m['loss']), restored[0]['loss'],
                               rtol=TRAIN_LOSS_RTOL)


@pytest.mark.parametrize('paged', [False, True])
def test_moe_tensor2_serving_matches_jax(pools, paged):
    """tiny with 4 experts at tensor=2: greedy tokens for [5, 17, 3]
    equal the JAX sharded engine's, on every rank; each rank holds its
    kv heads and F / 2 of every expert."""
    import jax
    from flax.core import meta
    from skypilot_tpu.inference import engine as je
    from skypilot_tpu.models import llama as jl
    from skypilot_tpu.parallel.mesh import build_serve_mesh as jax_mesh
    from skypilot_tpu_torch.models.convert import params_from_jax
    mesh = jax_mesh(2, n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                    devices=jax.devices()[:2])
    model = jl.Llama(cfg_j(), mesh)
    params_j = meta.unbox(jl.init_params(model, jax.random.PRNGKey(0))[
        'params'])
    kw = dict(SERVE_KW, kv_page_size=8) if paged else SERVE_KW
    engine = je.DecodeEngine(model, params_j, je.EngineConfig(mesh=mesh,
                                                              **kw))
    req = engine.submit(PROMPT, N_NEW)
    while req.finished_at is None:
        engine.step()
    want = req.tokens()
    full = params_from_jax(jax.tree.map(np.asarray, params_j))
    out = pools[2].run(rank_serve, full, 2, paged, timeout_s=POOL_TIMEOUT_S)
    whole = sum(t.numel() * t.element_size() for t in full.values())
    for toks, heads, experts, whole_bytes in out:
        assert toks == [want], (toks, want)
        assert heads == CFG.n_kv_heads // 2
        assert experts == (CFG.n_experts, CFG.ffn_dim // 2, CFG.dim)
        assert whole_bytes == whole


def test_moe_serving_loader_reads_its_slices(pools, jax_ref, tmp_path):
    """load_serving_params under a tensor=2 serve mesh gives each rank
    its half of every expert's F (w_gate/w_up columns, w_down rows) and
    the router whole, from a one-device checkpoint."""
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    init = jax_ref('expert4')[0]
    ckpt = str(tmp_path / 'ckpt')
    CheckpointManager(ckpt).save(0, _ParamsOnly(init))
    half = CFG.ffn_dim // 2
    for rank, got in pools[2].run(rank_load_slices, ckpt, 2,
                                  timeout_s=POOL_TIMEOUT_S):
        f = slice(rank * half, (rank + 1) * half)
        for i in range(CFG.n_layers):
            p = f'layers.{i}.moe_mlp.'
            np.testing.assert_array_equal(got[p + 'w_gate'],
                                          init[p + 'w_gate'][:, :, f])
            np.testing.assert_array_equal(got[p + 'w_up'],
                                          init[p + 'w_up'][:, :, f])
            np.testing.assert_array_equal(got[p + 'w_down'],
                                          init[p + 'w_down'][:, f])
            np.testing.assert_array_equal(got[p + 'router.weight'],
                                          init[p + 'router.weight'])


class _ParamsOnly:
    """A params-only state (what a serving checkpoint may hold)."""

    def __init__(self, params):
        self.params = params

    def state_dict(self):
        return dict(self.params)
