"""The port's training step against the JAX package's: the loss, the
schedule and the clip+AdamW update against optax, five train steps of
`tiny` against the JAX trainer on the same weights and tokens, remat
policies, the JAX model/trainer tests mirrored, checkpoints, and the
copied goodput/flops code pinned to its original source.  Inputs come
from seeded numpy generators and go to both frameworks as numpy; JAX
stays on the CPU."""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from skypilot_tpu.models import llama as jl
from skypilot_tpu.parallel.mesh import MeshPlan, build_mesh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.obs import goodput as tgoodput
from skypilot_tpu_torch.train import flops as tflops
from skypilot_tpu_torch.train import trainer as tt

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = tl.LLAMA_CONFIGS['tiny']


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _tiny_model(seed=0, **kw):
    cfg = dataclasses.replace(CFG, **kw)
    gen = torch.Generator().manual_seed(seed)
    return tl.Llama(cfg, tl.init_params(cfg, 'cpu', gen))


# ----- loss, schedule, optimizer against optax --------------------------------


def test_lm_loss_shift():
    logits = torch.zeros((1, 4, 8))
    tokens = torch.tensor([[1, 2, 3, 4]])
    np.testing.assert_allclose(float(tt.lm_loss(logits, tokens)), np.log(8),
                               rtol=1e-5)


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    tokens = _tokens((2, 16), 64)
    want = float(jt.lm_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(tt.lm_loss(torch.from_numpy(logits),
                           torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


SCHEDULE_RTOL = 5e-6


@pytest.mark.parametrize('cfg', [
    jt.TrainConfig(), jt.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                     total_steps=50),
    jt.TrainConfig(warmup_steps=7, total_steps=20)])
def test_schedule_matches_optax(cfg):
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps, decay_steps=cfg.total_steps,
        end_value=cfg.learning_rate * 0.1)
    tcfg = tt.TrainConfig(**dataclasses.asdict(cfg))
    counts = list(range(0, cfg.total_steps + 5)) + [cfg.total_steps * 3]
    want = [float(sched(c)) for c in counts]
    got = [tt.learning_rate(tcfg, c) for c in counts]
    assert got[0] == 0.0
    # optax evaluates the schedule in float32, the port in float64: a
    # few float32 ulps apart.
    np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=1e-12)
    # The optimizer's per-update learning rate follows the same curve.
    p = torch.nn.Parameter(torch.zeros(3))
    opt, schedule = tt.make_optimizer([p], tcfg)
    seen = []
    for _ in range(cfg.warmup_steps + 3):
        seen.append(opt.param_groups[0]['lr'])
        opt.step()
        schedule.step()
    np.testing.assert_allclose(seen, want[:len(seen)], rtol=SCHEDULE_RTOL,
                               atol=1e-12)


def test_train_config_matches_jax():
    assert (dataclasses.asdict(tt.TrainConfig()) ==
            dataclasses.asdict(jt.TrainConfig()))


@pytest.mark.parametrize('grad_scale', [0.01, 10.0])  # below / above clip
def test_clip_adamw_updates_match_optax(grad_scale):
    """Three updates on a small tree (count 0 has learning rate 0):
    global-norm clip then AdamW with decay on every leaf."""
    cfg = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(3)
    params = {'w': rng.standard_normal((3, 4)).astype(np.float32),
              'b': rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * grad_scale).astype(
        np.float32) for k, v in params.items()} for _ in range(3)]
    tx = jt.make_optimizer(jt.TrainConfig(**dataclasses.asdict(cfg)))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    order = sorted(tparams)
    opt, schedule = tt.make_optimizer([tparams[k] for k in order], cfg)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k in order:
            tparams[k].grad = torch.from_numpy(g[k].copy())
        norm = tt.clip_by_global_norm_([tparams[k].grad for k in order],
                                       cfg.grad_clip)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        opt.step()
        schedule.step()
        for k in order:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0)


# ----- the train step against the JAX trainer ---------------------------------

# f32 compute on both sides, same weights and tokens: the difference is
# summation order, ~1e-7 relative in the gradients.  Adam divides each
# gradient by its own running rms, so a relative gradient error e moves a
# parameter by ~lr*e: five steps at lr 1e-2 keep almost every parameter
# within 1e-5.  Where a gradient is near Adam's eps (1e-8), g/(|g| + eps)
# amplifies the summation-order noise, so a handful of elements (rarely
# used embedding rows) may drift further, bounded by 1e-2 of one step's
# lr.
TRAIN_PARAM_ATOL, TRAIN_LOSS_RTOL = 1e-5, 1e-5
TRAIN_PARAM_ATOL_ALL, TRAIN_PARAM_OUTLIER_SHARE = 1e-4, 1e-3


def test_five_train_steps_match_jax_trainer():
    cfg_j = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
    cfg_t = dataclasses.replace(CFG, dtype=torch.float32)
    tcfg = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50)
    mesh = build_mesh(MeshPlan(1, 8, 1))
    tokens = _tokens((8, 32), CFG.vocab_size, seed=5)
    state, shardings = jt.make_train_state(
        jl.Llama(cfg_j, mesh), mesh, jax.random.PRNGKey(0),
        jnp.asarray(tokens), jt.TrainConfig(**tcfg))
    step_j = jt.make_sharded_train_step(mesh, shardings)
    init = jax.tree.map(np.asarray, meta.unbox(state.params))
    model = tl.Llama(cfg_t, params_from_jax(init))
    state_t = tt.make_train_state(model, tt.TrainConfig(**tcfg))
    step_t = tt.make_train_step(tt.TrainConfig(**tcfg))
    toks_t = torch.from_numpy(tokens)
    for i in range(5):
        state, m_j = step_j(state, jnp.asarray(tokens))
        state_t, m_t = step_t(state_t, toks_t)
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


# The gates the card's `tiny_training` phase holds between the flash path
# and attention_impl='xla' at bf16 compute: the two round to bf16 at other
# places (the xla path under autograd rounds dP to bf16 before the
# softmax backward's cancellation), ~1e-2 per tensor and ~9e-3 over the
# whole gradient for `tiny` here; a wrong backward is off by ~1.
XLA_LOSS_RTOL, XLA_GRAD_RTOL, XLA_GRAD_GLOBAL_RTOL = 1e-2, 0.1, 1e-2


def test_tiny_bf16_flash_step_matches_xla():
    """One Trainer step of `tiny` (head_dim 16) at bf16 compute through
    the flash op, whose backward on the CPU is the small kernels' plain
    versions, against the same step under attention_impl='xla' on the
    same weights and tokens (B=4, S=64: the JAX bench's `tiny` defaults):
    the loss, the grad norm and every gradient (no clip, so p.grad is the
    raw gradient)."""
    tokens = torch.from_numpy(_tokens((4, 64), CFG.vocab_size))
    tcfg = tt.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                          total_steps=50, grad_clip=float('inf'))
    out = {}
    for impl in ('flash', 'xla'):
        model = _tiny_model(attention_impl=impl)
        assert model.cfg.dtype == torch.bfloat16 and model.cfg.head_dim == 16
        trainer = tt.Trainer(model, tcfg, device='cpu')
        trainer.state, m = trainer.train_step(trainer.state, tokens)
        out[impl] = (float(m['loss']), float(m['grad_norm']),
                     {n: p.grad for n, p in model.named_parameters()})
    (loss_f, norm_f, grads_f), (loss_x, norm_x, grads_x) = (out['flash'],
                                                            out['xla'])
    np.testing.assert_allclose(loss_f, loss_x, rtol=XLA_LOSS_RTOL)
    np.testing.assert_allclose(norm_f, norm_x, rtol=XLA_GRAD_GLOBAL_RTOL)
    diff = {n: float((grads_f[n] - g).norm()) for n, g in grads_x.items()}
    for name, g in grads_x.items():
        assert diff[name] <= XLA_GRAD_RTOL * float(g.norm()), name
    whole = float(torch.stack([g.norm() for g in grads_x.values()]).norm())
    assert float(torch.tensor(list(diff.values())).norm()) <= (
        XLA_GRAD_GLOBAL_RTOL * whole)


def test_training_loss_decreases():
    """Single-device mirror of test_sharded_training_loss_decreases."""
    model = _tiny_model()
    cfg = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=50)
    state = tt.make_train_state(model, cfg)
    step = tt.make_train_step(cfg)
    tokens = torch.from_numpy(_tokens((8, 32), CFG.vocab_size))
    losses = []
    for _ in range(8):
        state, metrics = step(state, tokens)  # overfit one batch
        losses.append(float(metrics['loss']))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize('policy', ['none', 'dots'])
def test_remat_policies_give_same_grads(policy):
    """Per-block checkpointing recomputes the forward in the backward; the
    gradients are those of the plain forward."""
    tokens = torch.from_numpy(_tokens((2, 32), CFG.vocab_size))
    grads = []
    for remat in (False, True):
        model = _tiny_model(remat=remat, remat_policy=policy,
                            dtype=torch.float32).requires_grad_(True)
        tt.lm_loss(model(tokens), tokens).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=0)


def test_remat_dots_saves_projection_products():
    from torch.utils.checkpoint import CheckpointPolicy
    assert (tl._save_dots(None, torch.ops.aten.mm.default)
            == CheckpointPolicy.MUST_SAVE)
    assert (tl._save_dots(None, torch.ops.aten.bmm.default)
            == CheckpointPolicy.PREFER_RECOMPUTE)
    with pytest.raises(ValueError, match='remat_policy'):
        _tiny_model(remat_policy='everything')


# ----- mirrors of tests/test_models_train.py ----------------------------------


def test_llama_forward_shapes():
    model = _tiny_model()
    logits = model(torch.zeros((2, 32), dtype=torch.long))
    assert logits.shape == (2, 32, CFG.vocab_size)
    assert logits.dtype == torch.float32


def test_llama_num_params_matches():
    model = _tiny_model()
    assert sum(p.numel() for p in model.parameters()) == CFG.num_params()


def test_llama_causality():
    """Future tokens must not affect past logits (through the flash op
    and its gradient path)."""
    model = _tiny_model(dtype=torch.float32).requires_grad_(True)
    t1 = torch.arange(10, 26)[None]           # distinct tokens
    t2 = t1.clone()
    t2[0, -1] = 100
    l1, l2 = model(t1), model(t2)
    np.testing.assert_allclose(l1[0, :-1].detach(), l2[0, :-1].detach(),
                               atol=1e-5)
    assert not np.allclose(l1[0, -1].detach(), l2[0, -1].detach(),
                           atol=1e-5)
    # The gradient of position 3's logits reaches the embeddings of
    # positions 0..3 and of no later token (untied: the embedding is
    # read only at the input).
    l1[0, 3].sum().backward()
    touched = (model.embed.weight.grad.abs().sum(-1) > 0).nonzero()[:, 0]
    assert touched.tolist() == t1[0, :4].tolist()


def test_trainer_checkpoint_roundtrip(tmp_path):
    tokens = torch.from_numpy(_tokens((8, 32), CFG.vocab_size))
    cfg = tt.TrainConfig(warmup_steps=1, total_steps=10)
    trainer = tt.Trainer(_tiny_model(), cfg,
                         checkpoint_dir=str(tmp_path / 'ckpt'),
                         device='cpu')
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state, tokens)
    trainer.save_checkpoint()
    trainer._ckpt_mgr.close()

    trainer2 = tt.Trainer(_tiny_model(seed=1), cfg,
                          checkpoint_dir=str(tmp_path / 'ckpt'),
                          device='cpu')
    assert trainer2.restore_if_available() == 2
    assert int(trainer2.state.step) == 2
    for name, p in trainer.model.state_dict().items():
        torch.testing.assert_close(trainer2.model.state_dict()[name], p,
                                   atol=0, rtol=0)
    s1 = trainer.state.optimizer.state_dict()
    s2 = trainer2.state.optimizer.state_dict()
    assert s1['param_groups'] == s2['param_groups']
    for i, st in s1['state'].items():
        for key, val in st.items():
            torch.testing.assert_close(s2['state'][i][key], val, atol=0,
                                       rtol=0)
    # Both continue identically from there.
    _, m1 = trainer.train_step(trainer.state, tokens)
    _, m2 = trainer2.train_step(trainer2.state, tokens)
    assert float(m1['loss']) == float(m2['loss'])


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    trainer = tt.Trainer(_tiny_model(), device='cpu')
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    assert mgr.latest_step() is None
    for step in (1, 2, 5, 7):
        mgr.save(step, trainer.state)
    assert mgr.all_steps() == [2, 5, 7] and mgr.latest_step() == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'step_2', 'step_5', 'step_7']


def test_trainer_run_exports_gauges_and_counts_tokens():
    from skypilot_tpu_torch.server import metrics as metrics_lib
    tokens = torch.from_numpy(_tokens((4, 16), CFG.vocab_size))
    trainer = tt.Trainer(_tiny_model(), tt.TrainConfig(warmup_steps=1,
                                                       total_steps=20),
                         device='cpu')
    logged = []
    out = trainer.run(iter([tokens] * 6), num_steps=6, log_every=3,
                      log_fn=logged.append)
    assert [m['step'] for m in logged] == [3, 6] and out['step'] == 6
    assert np.isfinite(out['loss']) and out['tokens_per_s'] > 0
    totals = trainer.phases.close()
    assert totals[tgoodput.INIT_COMPILE] > 0
    assert totals[tgoodput.PRODUCTIVE] > 0
    text = metrics_lib.render()
    assert 'skytpu_train_mfu_percent' in text
    assert 'skytpu_train_tokens_per_second' in text


def test_trainer_needs_cuda_unless_cpu(monkeypatch):
    model = _tiny_model()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tt.Trainer(model)
    trainer = tt.Trainer(model, device='cpu')
    assert trainer.device.type == 'cpu'
    with pytest.raises(ValueError, match='parameters are on'):
        tt.Trainer(model, device='meta')


# ----- copied code pinned to the original -------------------------------------


def _segments(path):
    src = path.read_text()
    tree = ast.parse(src)
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                out[ast.unparse(target)] = ast.get_source_segment(src, node)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
            out[node.name + ':src'] = ast.get_source_segment(src, node)
    return src, out


GOODPUT_CONSTANTS = ['PRODUCTIVE', 'INIT_COMPILE', 'CHECKPOINT_SAVE',
                     'CHECKPOINT_RESTORE', 'INPUT_STALL',
                     'PREEMPTION_DOWNTIME', 'RECOVERY_RELAUNCH',
                     'BADPUT_CATEGORIES', 'CATEGORIES',
                     'CONTROLLER_CATEGORIES', 'PHASE_SPAN', 'DOWNTIME_SPAN',
                     'TRAIN_RID', 'JOB_ENV']


def test_goodput_copy_matches_original():
    osrc, orig = _segments(REPO / 'skypilot_tpu' / 'obs' / 'goodput.py')
    csrc, copy = _segments(REPO / 'skypilot_tpu_torch' / 'obs' /
                           'goodput.py')
    for name in GOODPUT_CONSTANTS:
        assert copy[name] == orig[name], name
    methods = {}
    for src, tree in ((osrc, orig), (csrc, copy)):
        cls = tree['PhaseRecorder']
        methods[src is csrc] = {
            n.name: ast.get_source_segment(src, n) for n in cls.body
            if isinstance(n, ast.FunctionDef)}
        assert ast.get_docstring(cls) == ast.get_docstring(
            orig['PhaseRecorder'])
    orig_m, copy_m = methods[False], methods[True]
    assert set(orig_m) == set(copy_m)
    for name in orig_m:
        assert copy_m[name] == orig_m[name], name
    for name in ('GoodputLedger', 'jobs_dsn', 'step_time_skew',
                 'evaluate_stragglers', 'train_obs_tick'):
        assert copy[name + ':src'] == orig[name + ':src'], name


def test_goodput_from_env_gives_the_durable_ledger(monkeypatch, tmp_path):
    """Without SKYTPU_GOODPUT_JOB the recorder records locally; with it
    (a managed job) it writes through to the durable ledger in the jobs
    store, as the JAX recorder does."""
    from skypilot_tpu_torch import state as tstate
    monkeypatch.delenv(tgoodput.JOB_ENV, raising=False)
    rec = tgoodput.PhaseRecorder.from_env()
    assert rec.ledger is None and rec.rid == tgoodput.TRAIN_RID
    monkeypatch.delenv('SKYTPU_DB_URL', raising=False)
    monkeypatch.setenv('SKYTPU_JOBS_DB', str(tmp_path / 'jobs.db'))
    monkeypatch.setenv(tgoodput.JOB_ENV, 'job-7')
    tstate.reset_connections_for_tests()
    try:
        rec = tgoodput.PhaseRecorder.from_env()
        assert rec.job == 'job-7' and rec.rid == 'job-job-7'
        assert rec.ledger.dsn == str(tmp_path / 'jobs.db')
        rec.begin(tgoodput.INIT_COMPILE, now=10.0)
        rec.begin(tgoodput.PRODUCTIVE, now=12.5)
        totals = rec.close(now=20.0)
        assert rec.ledger.totals('job-7') == totals == {
            tgoodput.INIT_COMPILE: 2.5, tgoodput.PRODUCTIVE: 7.5}
    finally:
        tstate.reset_connections_for_tests()


def test_flops_copy_matches_original():
    _, orig = _segments(REPO / 'skypilot_tpu' / 'train' / 'flops.py')
    _, copy = _segments(REPO / 'skypilot_tpu_torch' / 'train' / 'flops.py')
    for name in ('train_flops_per_token', 'estimate_mfu',
                 'train_hbm_bytes_per_token', 'train_arith_intensity'):
        assert copy[name + ':src'] == orig[name + ':src'], name
    assert tflops.PEAK_BF16_TFLOPS == {'h100': 989.0, 'cpu': 1.0}
    assert tflops.chip_kind(torch.device('cpu')) == 'cpu'
    # bench-1b: 6.39 GFLOP per trained token at seq 4096.
    cfg = tl.LLAMA_CONFIGS['bench-1b']
    np.testing.assert_allclose(
        tflops.train_flops_per_token(cfg.num_params(), cfg.n_layers,
                                     cfg.dim, 4096) / 1e9, 6.39, rtol=1e-3)
