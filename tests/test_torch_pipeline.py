"""The port's GPipe pipeline (skypilot_tpu_torch/parallel/pipeline.py)
against the JAX package's `pipeline_apply` and the sequential fold, on
the same numpy inputs (mirrors tests/test_moe_pipeline.py's pipeline
tests): outputs at n_microbatches 4 and 8 (rtol/atol 1e-5), gradients of
a loss on the replicated output w.r.t. the params and x (rtol 1e-4,
atol 1e-5: the last stage gets one copy of its gradient, not one per
stage, and every rank gets x's whole gradient), a bad microbatch
count refused, at pipeline=4 and at pipeline=2 x fsdp=2.

The port's ranks are spawned gloo processes on the CPU (one module pool
of 4, one intra-op thread each, under the rank-pool lock of
tests/torch_rank_lock.py), every rank given the same x; the JAX side
runs in this process on 4 of the 8 virtual CPU devices of
tests/conftest.py.  This module imports no JAX at its top: the ranks
import it by name to find their functions.
"""
import os

import numpy as np
import pytest
import torch
import torch_rank_lock

from skypilot_tpu_torch.parallel import group as group_lib
from skypilot_tpu_torch.parallel import pipeline as pipeline_lib
from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh

torch.set_num_threads(1)

POOL_TIMEOUT_S = 120.0
OUT_TOL = 1e-5                     # tests/test_moe_pipeline.py:134
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # tests/test_moe_pipeline.py:175
PLANS = {'pipeline4': dict(pipeline=4),
         'pipeline2_fsdp2': dict(pipeline=2, fsdp=2)}


def stage_params(n_stages, d, seed=0):
    """Per-stage {'w' [d, d], 'b' [d]}, numpy f32."""
    rng = np.random.default_rng(seed)
    return [{'w': (rng.standard_normal((d, d)) / np.sqrt(d)).astype(
        np.float32), 'b': (rng.standard_normal(d) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def inputs(b, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(
        np.float32)


def mlp_stage(params, x):
    """tests/test_moe_pipeline.py's `_mlp_stage`, in torch."""
    return torch.tanh(x @ params['w'] + params['b'])


def sequential(per_stage, x):
    """The sequential fold and the gradients of sum(out**2) w.r.t. each
    stage's params and x, in torch."""
    params = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
              for p in per_stage]
    x_t = torch.tensor(x, requires_grad=True)
    h = x_t
    for p in params:
        h = mlp_stage(p, h)
    (h ** 2).sum().backward()
    return h.detach().numpy(), [{k: t.grad.numpy() for k, t in p.items()}
                                for p in params], x_t.grad.numpy()


# ----- in the ranks ----------------------------------------------------------
def rank_pipeline(per_stage, x, plan_kw, n_micro, local):
    """pipeline_apply over this rank's mesh: the output and the gradients
    of sum(out**2) w.r.t. the stacked params (whole, or this rank's
    slice through stage_param_sharding when `local`) and x."""
    mesh = build_mesh(MeshPlan(**plan_kw), devices=['cpu'] * MeshPlan(
        **plan_kw).num_devices, backend='gloo')
    stacked = pipeline_lib.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per_stage])
    stacked = {k: v.requires_grad_() for k, v in stacked.items()}
    params = (pipeline_lib.stage_param_sharding(mesh, stacked) if local
              else stacked)
    x_t = torch.tensor(x, requires_grad=True)
    out = pipeline_lib.pipeline_apply(mlp_stage, params, x_t, mesh=mesh,
                                      n_microbatches=n_micro)
    (out ** 2).sum().backward()
    return {'stage': mesh.coordinate('pipeline'),
            'fsdp': mesh.coordinate('fsdp'),
            'local_shapes': {k: tuple(v.shape) for k, v in params.items()},
            'out': out.detach().numpy(),
            'grads': {k: v.grad.numpy() for k, v in stacked.items()},
            'x_grad': x_t.grad.numpy()}


def rank_bad_microbatching(plan_kw):
    mesh = build_mesh(MeshPlan(**plan_kw), devices=['cpu'] * MeshPlan(
        **plan_kw).num_devices, backend='gloo')
    stacked = pipeline_lib.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()}
         for p in stage_params(mesh.shape['pipeline'], 4)])
    try:
        pipeline_lib.pipeline_apply(mlp_stage, stacked, torch.zeros(6, 4),
                                    mesh=mesh, n_microbatches=4)
    except ValueError as e:
        return str(e)
    return None


# ----- the JAX side ----------------------------------------------------------
def jax_pipeline(per_stage, x, plan_kw, n_micro):
    """The JAX pipeline_apply's output and the gradients of sum(out**2)
    w.r.t. the stacked params and x, on the same mesh shape."""
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.parallel import pipeline as jp
    from skypilot_tpu.parallel.mesh import MeshPlan as JPlan
    from skypilot_tpu.parallel.mesh import build_mesh as jbuild
    plan = JPlan(**plan_kw)
    mesh = jbuild(plan, jax.devices()[:plan.num_devices])
    stacked = jp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per_stage])

    def stage(params, h):
        return jnp.tanh(h @ params['w'] + params['b'])

    def loss(params, x):
        out = jp.pipeline_apply(stage, params, x, mesh=mesh,
                                n_microbatches=n_micro)
        return (out ** 2).sum(), out

    (grads, x_grad), out = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        stacked, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}, \
        np.asarray(x_grad)


@pytest.fixture(scope='module')
def pool():
    """A 4-rank pool at niceness +10, under the rank-pool lock."""
    with torch_rank_lock.hold(__name__):
        made = group_lib.RankPool(4, 'gloo', timeout_s=POOL_TIMEOUT_S,
                                  threads=1)
        made.run(os.nice, 10, timeout_s=POOL_TIMEOUT_S)
        yield made
        made.close()


def run_pipeline(pool, plan, d, b, n_micro, local=False):
    plan_kw = PLANS[plan]
    per_stage = stage_params(plan_kw['pipeline'], d)
    x = inputs(b, d)
    out = pool.run(rank_pipeline, per_stage, x, plan_kw, n_micro, local,
                   timeout_s=POOL_TIMEOUT_S)
    return per_stage, x, out


def stage_grads(out, n_stages):
    """The stacked gradients put together from the ranks of fsdp
    coordinate 0 (each rank's gradient is its own stage's)."""
    got = {}
    for r in out:
        if r['fsdp']:
            continue
        for k, g in r['grads'].items():
            got.setdefault(k, np.zeros_like(g))
            got[k][r['stage']] = g[r['stage']]
            others = np.delete(g, r['stage'], axis=0)
            assert not others.any(), (k, r['stage'])
    assert sum(1 for r in out if not r['fsdp']) == n_stages
    return got


# ----- tests -----------------------------------------------------------------
@pytest.mark.parametrize('n_micro', [4, 8])
def test_pipeline_matches_sequential(pool, n_micro):
    """pipeline=4 at d=16 over 8 rows: every rank's output equals the
    sequential fold and the JAX pipeline_apply's (1e-5)."""
    per_stage, x, out = run_pipeline(pool, 'pipeline4', 16, 8, n_micro)
    want, _, _ = sequential(per_stage, x)
    jax_out, _, _ = jax_pipeline(per_stage, x, PLANS['pipeline4'], n_micro)
    np.testing.assert_allclose(jax_out, want, rtol=OUT_TOL, atol=OUT_TOL)
    for r in out:
        np.testing.assert_allclose(r['out'], want, rtol=OUT_TOL,
                                   atol=OUT_TOL)


@pytest.mark.parametrize('plan', sorted(PLANS))
def test_pipeline_differentiable(pool, plan):
    """Gradients of sum(out**2) w.r.t. the stacked params equal the JAX
    pipeline's and the sequential fold's (rtol 1e-4, atol 1e-5), each
    rank's on its own stage only; every rank holds x's whole gradient,
    as JAX's transpose sums it over 'pipeline'; the output matches
    too."""
    n_stages = PLANS[plan]['pipeline']
    per_stage, x, out = run_pipeline(pool, plan, 8, 4, 4)
    want_out, seq_grads, seq_x_grad = sequential(per_stage, x)
    jax_out, jax_grads, jax_x_grad = jax_pipeline(per_stage, x, PLANS[plan],
                                                  4)
    np.testing.assert_allclose(jax_x_grad, seq_x_grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for r in out:
        np.testing.assert_allclose(r['x_grad'], jax_x_grad, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    got = stage_grads(out, n_stages)
    for k in ('w', 'b'):
        np.testing.assert_allclose(got[k], jax_grads[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(
            got[k], np.stack([g[k] for g in seq_grads]), rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=k)
    np.testing.assert_allclose(jax_out, want_out, rtol=OUT_TOL, atol=OUT_TOL)
    for r in out:
        np.testing.assert_allclose(r['out'], want_out, rtol=OUT_TOL,
                                   atol=OUT_TOL)


def test_pipeline_takes_this_ranks_stage_slice(pool):
    """stage_param_sharding gives each rank its [1, ...] stage; the
    pipeline over those slices gives the same output and gradients."""
    per_stage, x, out = run_pipeline(pool, 'pipeline2_fsdp2', 8, 4, 4,
                                     local=True)
    want_out, seq_grads, _ = sequential(per_stage, x)
    for r in out:
        assert r['local_shapes'] == {'w': (1, 8, 8), 'b': (1, 8)}
        np.testing.assert_allclose(r['out'], want_out, rtol=OUT_TOL,
                                   atol=OUT_TOL)
    got = stage_grads(out, 2)
    for k in ('w', 'b'):
        np.testing.assert_allclose(
            got[k], np.stack([g[k] for g in seq_grads]), rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=k)


def test_pipeline_rejects_bad_microbatching(pool):
    """A batch of 6 over 4 microbatches: ValueError on every rank."""
    errors = pool.run(rank_bad_microbatching, PLANS['pipeline4'],
                      timeout_s=POOL_TIMEOUT_S)
    assert all(e and 'microbatches' in e for e in errors), errors


def test_stack_stage_params():
    """A list of per-stage dicts -> one dict with a leading stage dim."""
    per_stage = stage_params(3, 4)
    stacked = pipeline_lib.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per_stage])
    assert {k: tuple(v.shape) for k, v in stacked.items()} == {
        'w': (3, 4, 4), 'b': (3, 4)}
    for i, p in enumerate(per_stage):
        np.testing.assert_array_equal(stacked['w'][i].numpy(), p['w'])
