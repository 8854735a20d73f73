"""Sharded training of the port (skypilot_tpu_torch) against the JAX
sharded step: FSDP2 over the mesh's fsdp axis, data, tensor, dcn, ring
(context-parallel) and pipeline (replicated) plans, checkpoints saved under a mesh and
restored on another plan or on one device, the serving loader on such a
step, and the ring model's logits (mirrors tests/test_models_train.py's
sharded tests and tests/test_multislice.py's dcn step).

The port's ranks are spawned gloo processes on the CPU (module-scoped
`RankPool`s of 2 and 4, one intra-op thread each), given the GLOBAL batch
on every rank; the JAX references run in this process on the 8 virtual
CPU devices of tests/conftest.py.  A sharded step's result does not
depend on the mesh, so a JAX plan over 8 devices is held against the
port at 2 or 4 ranks on the same weights (one Flax tree, converted) and
the same tokens.  f32 compute on both sides.

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

CFG = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
# lr 1e-3 for the parity cases: at 1e-2 Adam near its eps drifts one
# embedding element past the parameter bound (as tests/test_torch_moe.py's
# train steps note); the loss-decrease mirror keeps the JAX test's 1e-2.
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50)
TCFG_FAST = dict(TCFG, learning_rate=1e-2)
BATCH, SEQ, STEPS = 8, 32, 3
POOL_TIMEOUT_S = 120.0
# As tests/test_torch_train.py: f32 on both sides, sums in another order
# (FSDP's reduce-scatter, the clip's norm over shards, the tensor-parallel
# partial sums); parameters as there: almost all within 1e-5, a share of
# 1e-3 (rarely used embedding rows, Adam near eps) within 1e-4.
TRAIN_LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
TRAIN_PARAM_ATOL, TRAIN_PARAM_ATOL_ALL = 1e-5, 1e-4
TRAIN_PARAM_OUTLIER_SHARE = 1e-3
# AdamW moments after two steps, port against optax: the gradients they
# average differ in summation order only (~1e-6 relative), and the
# second moment squares them.
MOMENT_RTOL = 1e-4

# Port plans (2 or 4 ranks) -> the JAX plan (8 devices) they are held
# against; every JAX plan gives the same step.
PLANS = {
    'fsdp4': (dict(fsdp=4), dict(fsdp=8)),
    'data2_fsdp2': (dict(data=2, fsdp=2), dict(data=2, fsdp=2, tensor=2)),
    'fsdp2_tensor2': (dict(fsdp=2, tensor=2),
                      dict(data=2, fsdp=2, tensor=2)),
    'data4': (dict(data=4), dict(data=8)),
    'dcn2_tensor2': (dict(dcn=2, tensor=2), dict(dcn=2, fsdp=2, tensor=2)),
    'ring_fsdp4': (dict(fsdp=4), dict(fsdp=8)),
    'ring_data2_fsdp2': (dict(data=2, fsdp=2), dict(fsdp=8)),
    # No rule names 'pipeline': params and rows replicate over it (HSDP).
    'pipeline2_fsdp2': (dict(pipeline=2, fsdp=2), dict(pipeline=2, fsdp=4)),
}


def tokens_of(seed=5, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (batch, seq)).astype(np.int32)


def world_of(plan_kw):
    return MeshPlan(**plan_kw).num_devices


# ----- in the ranks ----------------------------------------------------------
def rank_mesh(plan_kw):
    n = world_of(plan_kw)
    return build_mesh(MeshPlan(**plan_kw), devices=['cpu'] * n,
                      backend='gloo')


def rank_model(full, plan_kw, ring=False):
    mesh = rank_mesh(plan_kw)
    cfg = dataclasses.replace(CFG, attention_impl='ring') if ring else CFG
    return tl.Llama(cfg, shard_params(full, mesh), mesh), mesh


def gathered_params(state):
    """Every parameter whole, on every rank (collective)."""
    return {name: state.layout.global_view(p, name).full_tensor().numpy()
            for name, p in state.model.named_parameters()}


def rank_steps(full, plan_kw, tokens, n_steps, ring=False, ckpt_dir=None,
               tcfg=TCFG):
    """`n_steps` sharded steps on `tokens`; rank 0 returns the losses,
    grad norms and the gathered parameters (every rank checks its
    metrics equal rank 0's by returning them)."""
    model, mesh = rank_model(full, plan_kw, ring)
    state = tt.make_train_state(model, tt.TrainConfig(**tcfg), mesh)
    step = tt.make_sharded_train_step(mesh, tt.TrainConfig(**tcfg))
    losses, norms = [], []
    for _ in range(n_steps):
        state, m = step(state, torch.from_numpy(tokens))
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    out = {'losses': losses, 'norms': norms, 'step': int(state.step)}
    params = gathered_params(state)
    if ckpt_dir is not None:
        from skypilot_tpu_torch.train.checkpoint import CheckpointManager
        CheckpointManager(ckpt_dir).save(int(state.step), state)
    if mesh.rank == 0:
        out['params'] = params
    return out


def rank_local_shapes(full, plan_kw):
    """This rank's local shape of a gate_proj kernel and of its AdamW
    moment after one step."""
    model, mesh = rank_model(full, plan_kw)
    state = tt.make_train_state(model, tt.TrainConfig(**TCFG), mesh)
    step = tt.make_sharded_train_step(mesh, tt.TrainConfig(**TCFG))
    step(state, torch.from_numpy(tokens_of()))
    p = dict(state.model.named_parameters())['layers.0.mlp.gate_proj.weight']
    return (tuple(p.to_local().shape),
            tuple(state.optimizer.state[p]['exp_avg'].to_local().shape),
            tuple(p.shape))


def rank_restore(full, plan_kw, ckpt_dir):
    """A Trainer at `plan_kw` resumed from `ckpt_dir` (its whole params
    and the restored step), then one step more (its loss)."""
    model, mesh = rank_model(full, plan_kw)
    trainer = tt.Trainer(model, tt.TrainConfig(**TCFG),
                         checkpoint_dir=ckpt_dir, mesh=mesh)
    resumed = trainer.restore_if_available()
    params = gathered_params(trainer.state)
    trainer.state, m = trainer.train_step(trainer.state,
                                          torch.from_numpy(tokens_of()))
    return {'resumed': resumed, 'loss': float(m['loss']),
            'params': params if mesh.rank == 0 else None}


def rank_restore_one_device(full, plan_kw, ckpt_dir):
    """A Trainer at `plan_kw` (built from `full`, other weights than the
    saved ones) resumed from a one-device `state.pt` in `ckpt_dir`: the
    restored step, every parameter and AdamW moment whole (copied: a
    replicated gather is the rank's own storage), the AdamW step counts
    and the learning rate; then one step more (its loss and grad norm)."""
    model, mesh = rank_model(full, plan_kw)
    trainer = tt.Trainer(model, tt.TrainConfig(**TCFG),
                         checkpoint_dir=ckpt_dir, mesh=mesh)
    resumed = trainer.restore_if_available()
    state = trainer.state
    whole = {}
    for name, p in state.model.named_parameters():
        adam = state.optimizer.state[p]
        for key, t in (('param', p), ('exp_avg', adam['exp_avg']),
                       ('exp_avg_sq', adam['exp_avg_sq'])):
            whole[f'{key}:{name}'] = state.layout.global_view(
                t, name).full_tensor().clone().numpy()
    counts = {float(state.optimizer.state[p]['step'])
              for p in state.model.parameters()}
    lrs = [group['lr'] for group in state.optimizer.param_groups]
    step = int(state.step)
    trainer.state, m = trainer.train_step(state,
                                          torch.from_numpy(tokens_of()))
    return {'resumed': resumed, 'step': step, 'counts': counts,
            'lrs': lrs, 'loss': float(m['loss']),
            'norm': float(m['grad_norm']),
            'whole': whole if mesh.rank == 0 else None}


def rank_load_slices(ckpt_dir, tensor):
    """This rank's slices of a DCP step at a tensor-parallel serve mesh:
    the blocks `read_params` reads (with the bytes their storage holds)
    and what `load_serving_params` gives."""
    from skypilot_tpu_torch.inference.weights import load_serving_params
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    mesh = build_serve_mesh(tensor, CFG.n_heads, CFG.n_kv_heads,
                            devices=['cpu'] * tensor, backend='gloo')

    def box(name, shape):
        return sharding.local_box(
            shape, sharding.param_spec(name, shape, mesh.shape), mesh)

    mgr = CheckpointManager(ckpt_dir)
    blocks = mgr.read_params(mgr.latest_step(), box)
    loaded = load_serving_params(ckpt_dir, device='cpu', mesh=mesh)
    return {'boxes': {n: box(n, tuple(s)) for n, s in
                      tl.param_shapes(CFG).items()},
            'blocks': {n: t.numpy() for n, t in blocks.items()},
            'bytes': {n: t.untyped_storage().nbytes()
                      for n, t in blocks.items()},
            'loaded': {n: t.numpy() for n, t in loaded.items()}}


def rank_trainer_run(full, plan_kw):
    """Trainer.run over a mesh: its host label and step count."""
    model, mesh = rank_model(full, plan_kw)
    trainer = tt.Trainer(model, tt.TrainConfig(**TCFG), mesh=mesh)
    toks = torch.from_numpy(tokens_of())
    out = trainer.run(iter([toks] * 3), 3, log_every=3)
    return {'host': trainer.host, 'step': out['step'], 'loss': out['loss'],
            'device': str(trainer.device)}


def rank_ring_logits(full, plan_kw, tokens):
    """This rank's chunk of the ring model's logits, gathered whole on
    rank 0 (rows over data, chunks over fsdp)."""
    from skypilot_tpu_torch.parallel import sharding
    model, mesh = rank_model(full, plan_kw, ring=True)
    with torch.no_grad():
        local = model(sharding.context_slice(torch.from_numpy(tokens), mesh))
    return {'rows': sharding._index(('dcn', 'data'), mesh),
            'chunk': mesh.coordinate('fsdp'), 'logits': local.numpy()}


def rank_refusals(full):
    errors = []

    def state(plan_kw):
        model, mesh = rank_model(full, plan_kw)
        return tt.make_train_state(model, None, mesh)

    cases = (
        lambda: tt.make_train_state(tl.Llama(CFG, full), None,
                                    rank_mesh(dict(fsdp=2))),
        lambda: tt.make_sharded_train_step(rank_mesh(dict(data=2)))(
            state(dict(fsdp=2)), torch.from_numpy(tokens_of())))
    for case in cases:
        try:
            case()
        except ValueError as e:
            errors.append(str(e))
    return errors


# ----- the JAX side ----------------------------------------------------------
def cfg_j(**kw):
    import jax.numpy as jnp
    from skypilot_tpu.models import llama as jl
    return dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32,
                               **kw)


def jax_run(plan_kw, tokens, n_steps, ring=False):
    """(initial whole state dict, losses, norms, final whole state dict)
    of the JAX sharded step on 8 devices."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta
    from skypilot_tpu.models import llama as jl
    from skypilot_tpu.parallel.mesh import MeshPlan as JPlan
    from skypilot_tpu.parallel.mesh import build_mesh as jbuild
    from skypilot_tpu.train import trainer as jt
    from skypilot_tpu_torch.models.convert import params_from_jax
    mesh = jbuild(JPlan(**plan_kw))
    cfg = cfg_j(attention_impl='ring') if ring else cfg_j()
    state, shardings = jt.make_train_state(
        jl.Llama(cfg, mesh), mesh, jax.random.PRNGKey(0),
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
    """Rank pools of 2 and 4, their processes at a lower CPU priority
    (niceness +10): under xdist they share the machine with tests that
    poll on wall-clock deadlines.  They compute under the rank-pool lock
    (`tests/torch_rank_lock.py`): one file's ranks at a time."""
    made = {n: torch_rank_lock.LockedPool(__name__, n, POOL_TIMEOUT_S)
            for n in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


@pytest.fixture(scope='module')
def jax_ref():
    """The JAX step of each JAX plan (and of ring), computed once."""
    cache = {}

    def get(plan_kw, ring=False):
        key = (tuple(sorted(plan_kw.items())), ring)
        if key not in cache:
            cache[key] = jax_run(plan_kw, tokens_of(), STEPS, ring)
        return cache[key]
    return get


def run_ranks(pools, plan_kw, fn, *args):
    out = pools[world_of(plan_kw)].run(fn, *args, timeout_s=POOL_TIMEOUT_S)
    return out


def assert_params_close(got, want):
    assert set(got) == set(want)
    for name in want:
        diff = np.abs(np.asarray(got[name]) - np.asarray(want[name]))
        assert diff.max() <= TRAIN_PARAM_ATOL_ALL, (name, diff.max())
        assert ((diff > TRAIN_PARAM_ATOL).mean() <=
                TRAIN_PARAM_OUTLIER_SHARE), name


# ----- tests -----------------------------------------------------------------
@pytest.mark.parametrize('plan', sorted(PLANS))
def test_sharded_steps_match_jax(pools, jax_ref, plan):
    """Losses and grad norms per step within TRAIN_LOSS_RTOL /
    GRAD_NORM_RTOL of the JAX sharded step, every rank the same, and the
    trained parameters within TRAIN_PARAM_ATOL_ALL."""
    port_kw, jax_kw = PLANS[plan]
    ring = plan.startswith('ring')
    init, losses, norms, final = jax_ref(jax_kw, ring)
    out = run_ranks(pools, port_kw, rank_steps, init, port_kw, tokens_of(),
                    STEPS, ring)
    for o in out:
        assert (o['losses'], o['norms']) == (out[0]['losses'],
                                             out[0]['norms'])
    np.testing.assert_allclose(out[0]['losses'], losses,
                               rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(out[0]['norms'], norms, rtol=GRAD_NORM_RTOL)
    assert out[0]['step'] == STEPS
    assert_params_close(out[0]['params'], final)


@pytest.mark.parametrize('plan', ['fsdp4', 'data2_fsdp2', 'data4'])
def test_sharded_training_loss_decreases(pools, jax_ref, plan):
    """Mirror of test_sharded_training_loss_decreases: 8 steps on one
    batch."""
    port_kw, jax_kw = PLANS[plan]
    init = jax_ref(jax_kw)[0]
    losses = run_ranks(pools, port_kw, rank_steps, init, port_kw,
                       tokens_of(), 8, False, None, TCFG_FAST)[0]['losses']
    assert losses[-1] < losses[0], losses


def test_fsdp_params_actually_sharded(pools, jax_ref):
    """Each rank holds 1/fsdp of a kernel whose rows split (gate_proj
    [128, 64] at fsdp=4: 32 rows) and of its AdamW moment."""
    init = jax_ref(PLANS['fsdp4'][1])[0]
    for local, moment, whole in run_ranks(pools, dict(fsdp=4),
                                          rank_local_shapes, init,
                                          dict(fsdp=4)):
        assert whole == (CFG.ffn_dim, CFG.dim)
        assert local == moment == (CFG.ffn_dim // 4, CFG.dim)


def test_fsdp_and_tensor_slices_compose(pools, jax_ref):
    """fsdp=2 x tensor=2: a rank holds half of its tensor slice."""
    init = jax_ref(PLANS['fsdp4'][1])[0]
    plan = dict(fsdp=2, tensor=2)
    for local, _, whole in run_ranks(pools, plan, rank_local_shapes, init,
                                     plan):
        assert whole == (CFG.ffn_dim // 2, CFG.dim)
        assert local == (CFG.ffn_dim // 4, CFG.dim)


def test_checkpoint_roundtrip_and_reshard(pools, jax_ref, tmp_path):
    """A step saved at fsdp=2 x tensor=2 restores bit-exactly at fsdp=2
    (another plan) and on one device; the restored trainers take the same
    next step."""
    init = jax_ref(PLANS['fsdp4'][1])[0]
    ckpt = str(tmp_path / 'ckpt')
    saved = run_ranks(pools, dict(fsdp=2, tensor=2), rank_steps, init,
                      dict(fsdp=2, tensor=2), tokens_of(), 1, False, ckpt)[0]
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    assert CheckpointManager(ckpt).all_steps() == [1]
    assert CheckpointManager(ckpt).is_sharded(1)
    restored = run_ranks(pools, dict(fsdp=2), rank_restore, init,
                         dict(fsdp=2), ckpt)
    assert [r['resumed'] for r in restored] == [1, 1]
    for name, want in saved['params'].items():
        np.testing.assert_array_equal(restored[0]['params'][name], want)
    # One device: the single-device trainer resumes from the same step.
    model = tl.Llama(CFG, {k: v.clone() for k, v in init.items()})
    trainer = tt.Trainer(model, tt.TrainConfig(**TCFG), checkpoint_dir=ckpt,
                         device='cpu')
    assert trainer.restore_if_available() == 1
    for name, p in trainer.state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved['params'][name])
    assert int(trainer.state.step) == 1
    trainer.state, m = trainer.train_step(trainer.state,
                                          torch.from_numpy(tokens_of()))
    np.testing.assert_allclose(float(m['loss']), restored[0]['loss'],
                               rtol=TRAIN_LOSS_RTOL)


def _init(seed):
    return tl.init_params(CFG, 'cpu', torch.Generator().manual_seed(seed))


def _saved_whole(ckpt, step):
    """Every parameter and AdamW moment of a one-device `state.pt`, by
    the names `rank_restore_one_device` gives them."""
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    state = torch.load(CheckpointManager(ckpt).state_path(step),
                       weights_only=True)
    names = [name for name, _ in tl.Llama(CFG, _init(0)).named_parameters()]
    whole = {}
    for i, name in enumerate(names):
        whole[f'param:{name}'] = state['params'][name].numpy()
        for key in ('exp_avg', 'exp_avg_sq'):
            whole[f'{key}:{name}'] = state['optimizer']['state'][i][
                key].numpy()
    return whole


@pytest.mark.parametrize('plan', [dict(fsdp=2), dict(tensor=2)])
def test_one_device_checkpoint_restores_onto_mesh(pools, tmp_path, plan):
    """A `tiny` Trainer state saved on one device after 2 steps (a
    `state.pt`) resumes through Trainer(..., mesh=): every parameter and
    AdamW moment whole is the saved tensor bit for bit, the step, the
    AdamW counts and the learning rate are the saved ones, and the next
    step is step 3 on one device (TRAIN_LOSS_RTOL / GRAD_NORM_RTOL: f32,
    sums over shards in another order)."""
    ckpt = str(tmp_path / 'ckpt')
    trainer = tt.Trainer(tl.Llama(CFG, _init(0)), tt.TrainConfig(**TCFG),
                         checkpoint_dir=ckpt, device='cpu')
    toks = torch.from_numpy(tokens_of())
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state, toks)
    trainer.save_checkpoint()
    lr = trainer.state.optimizer.param_groups[0]['lr']
    trainer.state, m = trainer.train_step(trainer.state, toks)
    saved = _saved_whole(ckpt, 2)
    out = run_ranks(pools, plan, rank_restore_one_device, _init(1), plan,
                    ckpt)
    for o in out:
        assert (o['resumed'], o['step'], o['counts'], o['lrs']) == (
            2, 2, {2.0}, [lr]), o
        assert (o['loss'], o['norm']) == (out[0]['loss'], out[0]['norm'])
    got = out[0]['whole']
    assert set(got) == set(saved)
    for key, want in saved.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    np.testing.assert_allclose(out[0]['loss'], float(m['loss']),
                               rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(out[0]['norm'], float(m['grad_norm']),
                               rtol=GRAD_NORM_RTOL)


def test_untrained_one_device_checkpoint_restores_onto_mesh(pools,
                                                           tmp_path):
    """A one-device `state.pt` saved before the first step (no AdamW
    state yet) restores at fsdp=2: the saved weights, zero moments, step
    and AdamW counts 0; the next step is the one-device first step."""
    ckpt = str(tmp_path / 'ckpt')
    trainer = tt.Trainer(tl.Llama(CFG, _init(0)), tt.TrainConfig(**TCFG),
                         checkpoint_dir=ckpt, device='cpu')
    trainer.save_checkpoint()
    trainer.state, m = trainer.train_step(trainer.state,
                                          torch.from_numpy(tokens_of()))
    out = run_ranks(pools, dict(fsdp=2), rank_restore_one_device, _init(1),
                    dict(fsdp=2), ckpt)
    assert (out[0]['resumed'], out[0]['step'], out[0]['counts']) == (
        0, 0, {0.0})
    for name, want in _init(0).items():
        np.testing.assert_array_equal(out[0]['whole'][f'param:{name}'],
                                      want.numpy())
        for key in ('exp_avg', 'exp_avg_sq'):
            assert not out[0]['whole'][f'{key}:{name}'].any(), (key, name)
    np.testing.assert_allclose(out[0]['loss'], float(m['loss']),
                               rtol=TRAIN_LOSS_RTOL)


def test_one_device_restore_onto_mesh_matches_jax(pools, tmp_path):
    """The JAX CheckpointManager (orbax) restores a one-device state onto
    a 2-device CPU mesh; the port's manager does the same with its own
    one-device state (same initial weights and tokens, 2 steps each, f32).
    Both restored trees, params and AdamW moments (optax mu/nu) through
    the Flax -> torch conversion, agree: params as the parity tests'
    (TRAIN_PARAM_ATOL_ALL), moments within MOMENT_RTOL of each tensor's
    largest entry."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta
    from skypilot_tpu.models import llama as jl
    from skypilot_tpu.parallel.mesh import MeshPlan as JPlan
    from skypilot_tpu.parallel.mesh import build_mesh as jbuild
    from skypilot_tpu.train import trainer as jt
    from skypilot_tpu.train.checkpoint import CheckpointManager as JManager
    from skypilot_tpu_torch.models.convert import params_from_jax

    tokens = tokens_of()
    cfg = tt.TrainConfig(**TCFG)

    def jax_state(n_devices, seed):
        mesh = jbuild(JPlan(fsdp=n_devices), jax.devices()[:n_devices])
        return jt.make_train_state(jl.Llama(cfg_j(), mesh), mesh,
                                   jax.random.PRNGKey(seed),
                                   jnp.asarray(tokens),
                                   jt.TrainConfig(**TCFG)), mesh

    (state, shardings), mesh = jax_state(1, 0)
    init = params_from_jax(jax.tree.map(np.asarray,
                                        meta.unbox(state.params)))
    step = jt.make_sharded_train_step(mesh, shardings)
    for _ in range(2):
        state, _ = step(state, jnp.asarray(tokens))
    mgr = JManager(str(tmp_path / 'jax'))
    mgr.save(2, state, wait=True)
    (target, _), _ = jax_state(2, 1)
    restored = mgr.restore(2, target)
    mgr.close()
    kernel = restored.params['layer_0']['mlp']['gate_proj']['kernel']
    assert len(kernel.sharding.device_set) == 2

    def adam(opt_state):
        found = [s for s in jax.tree.leaves(
            opt_state, is_leaf=lambda x: hasattr(x, 'mu')) if hasattr(s, 'mu')]
        return found[0]

    want = {}
    for key, tree in (('param', restored.params),
                      ('exp_avg', adam(restored.opt_state).mu),
                      ('exp_avg_sq', adam(restored.opt_state).nu)):
        for name, t in params_from_jax(jax.tree.map(
                np.asarray, meta.unbox(tree))).items():
            want[f'{key}:{name}'] = t.numpy()
    assert int(adam(restored.opt_state).count) == 2

    ckpt = str(tmp_path / 'port')
    trainer = tt.Trainer(tl.Llama(CFG, init), cfg, checkpoint_dir=ckpt,
                         device='cpu')
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state,
                                              torch.from_numpy(tokens))
    trainer.save_checkpoint()
    out = run_ranks(pools, dict(fsdp=2), rank_restore_one_device,
                    _init(1), dict(fsdp=2), ckpt)
    got = out[0]['whole']
    assert set(got) == set(want) and out[0]['counts'] == {2.0}
    for key in want:
        if key.startswith('param:'):
            continue
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=MOMENT_RTOL * scale, err_msg=key)
    assert_params_close({k: v for k, v in got.items()
                         if k.startswith('param:')},
                        {k: v for k, v in want.items()
                         if k.startswith('param:')})


def test_serving_loader_reads_sharded_step(pools, jax_ref, tmp_path):
    """load_serving_params reads a step trained under a mesh: the whole
    params, as the trained (gathered) ones, and a model serves them."""
    from skypilot_tpu_torch.inference.weights import load_serving_params
    init = jax_ref(PLANS['fsdp4'][1])[0]
    ckpt = str(tmp_path / 'ckpt')
    saved = run_ranks(pools, dict(fsdp=4), rank_steps, init, dict(fsdp=4),
                      tokens_of(), 1, False, ckpt)[0]
    params = load_serving_params(ckpt, device='cpu')
    assert set(params) == set(saved['params'])
    for name, want in saved['params'].items():
        np.testing.assert_array_equal(params[name].numpy(), want)
    with torch.no_grad():
        logits = tl.Llama(CFG, params)(torch.from_numpy(tokens_of()[:1]))
    assert torch.isfinite(logits).all()


def test_serving_loader_reads_only_its_slice(pools, jax_ref, tmp_path):
    """Under a tensor=2 serve mesh each rank reads only its slice of a DCP
    step: blocks of the slice's size (the host never holds the whole
    tensor), equal to the slice of the trained params, and
    load_serving_params gives the same."""
    init = jax_ref(PLANS['fsdp4'][1])[0]
    ckpt = str(tmp_path / 'ckpt')
    saved = run_ranks(pools, dict(fsdp=2), rank_steps, init, dict(fsdp=2),
                      tokens_of(), 1, False, ckpt)[0]['params']
    halves = 0
    for r in run_ranks(pools, dict(tensor=2), rank_load_slices, ckpt, 2):
        assert set(r['blocks']) == set(saved)
        for name, want in saved.items():
            offsets, sizes = r['boxes'][name]
            want = want[tuple(slice(o, o + n)
                              for o, n in zip(offsets, sizes))]
            got = r['blocks'][name]
            np.testing.assert_array_equal(got, want)
            assert r['bytes'][name] == got.nbytes, name
            np.testing.assert_array_equal(r['loaded'][name], want)
            halves += got.size * 2 == saved[name].size
    # q/k/v/o, gate/up/down of every layer, the embedding and the lm_head
    # are halved on each rank.
    assert halves == 2 * (7 * CFG.n_layers + 2)


def test_trainer_over_mesh(pools, jax_ref):
    """Trainer(model, ..., mesh=) runs on every rank: host label
    host{rank}, the mesh's device, equal metrics on every rank."""
    init = jax_ref(PLANS['fsdp4'][1])[0]
    plan = dict(data=2, fsdp=2)
    out = run_ranks(pools, plan, rank_trainer_run, init, plan)
    assert [o['host'] for o in out] == ['host0', 'host1', 'host2', 'host3']
    assert all(o['step'] == 3 and o['loss'] == out[0]['loss'] and
               o['device'] == 'cpu' for o in out)


@pytest.mark.parametrize('plan', [dict(fsdp=2), dict(data=2, fsdp=2)])
def test_ring_logits_match_xla(pools, plan):
    """Same weights, ring-attention impl == xla impl (mirror of
    test_ring_attention_model_variant, in f32: the chunks' logits put
    back together equal the JAX model's xla logits)."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta
    from skypilot_tpu.models import llama as jl
    from skypilot_tpu_torch.models.convert import params_from_jax
    model_x = jl.Llama(cfg_j())
    variables = jl.init_params(model_x, jax.random.PRNGKey(0), batch=4,
                               seq=64)
    tokens = tokens_of(seed=1, batch=4, seq=64)
    want = np.asarray(model_x.apply(variables, jnp.asarray(tokens)))
    full = params_from_jax(jax.tree.map(np.asarray,
                                        meta.unbox(variables['params'])))
    got = np.zeros_like(want)
    for o in run_ranks(pools, plan, rank_ring_logits, full, plan, tokens):
        (row, n_rows), chunk = o['rows'], o['chunk']
        b, s = o['logits'].shape[:2]
        got[row * b:(row + 1) * b, chunk * s:(chunk + 1) * s] = o['logits']
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_step_refusals(pools, jax_ref):
    """Refused on every rank: a model built without the mesh, and a step
    over another mesh than the state's.  (A pipeline axis is no longer
    refused: the 'pipeline2_fsdp2' plan trains over one.)"""
    init = jax_ref(PLANS['fsdp4'][1])[0]
    for errors in run_ranks(pools, dict(fsdp=2), rank_refusals, init):
        assert len(errors) == 2, errors
        assert 'same mesh' in errors[0]
        assert 'not sharded over this mesh' in errors[1]
