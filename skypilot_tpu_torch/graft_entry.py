"""Driver entry points of the port: the flagship forward, and a multi-rank
dry run of every parallel path (twin of the repo's `__graft_entry__.py`).

    python -m skypilot_tpu_torch.graft_entry     # entry() on the GPU, then
                                                 # dryrun_multichip(8)

- `entry()` returns (fn, example_args): the `llama-250m` forward and
  its (params, tokens [1, 512]), on the GPU unless asked for the CPU.
- `dryrun_multichip(n)` runs, in a child python, every path of the JAX
  dry run on n CPU ranks joined over gloo (the reference's contract is a
  virtual CPU mesh of n devices; here each device is a spawned process,
  and the child hides the GPUs so no rank touches one):
  the dcn x fsdp x tensor train step through `Trainer(..., mesh=)`;
  ring attention over fsdp (each rank's block held against
  `ring_attention_reference`); the MoE train step at expert=4
  (`make_sharded_train_step`); tensor=2 serving (a 2-rank engine, each
  rank's KV cache holding n_kv_heads // 2 heads); the GPipe pipeline
  against the sequential fold (1e-5).  It raises if the child fails.
Neither function imports JAX.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINE_TOL = 1e-5            # __graft_entry__.py:203-204
POOL_TIMEOUT_S = 300.0


def entry(device=None):
    """(fn, example_args): the forward of the flagship model, llama-250m
    from seed 0, and its (params, tokens) on `device` (default: the
    GPU)."""
    import torch
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                                 init_params)
    device = resolve_device(device)
    cfg = LLAMA_CONFIGS['llama-250m']
    params = init_params(cfg, device)
    model = Llama(cfg, params)
    tokens = torch.zeros((1, 512), dtype=torch.int64, device=device)

    def fn(params, tokens):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (tokens,))

    return fn, (params, tokens)


def dryrun_multichip(n_devices: int) -> None:
    """Every parallel path on `n_devices` CPU gloo ranks, in a child
    python (see the module docstring); its output is passed through."""
    env = dict(os.environ)
    env['CUDA_VISIBLE_DEVICES'] = ''
    env['PYTHONPATH'] = _REPO_DIR + os.pathsep + env.get('PYTHONPATH', '')
    code = ('from skypilot_tpu_torch.graft_entry import _dryrun_body; '
            f'_dryrun_body({int(n_devices)})')
    proc = subprocess.run([sys.executable, '-c', code], env=env,
                          cwd=_REPO_DIR, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f'dryrun_multichip child failed (rc={proc.returncode})')


# ----- in the ranks (module-level: the pool pickles them by name) ------------
def _tiny():
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    return LLAMA_CONFIGS['tiny']


def _mesh(plan):
    from skypilot_tpu_torch.parallel.mesh import build_mesh
    return build_mesh(plan, devices=['cpu'] * plan.num_devices,
                      backend='gloo')


def _rank_train(plan):
    """One Trainer step of `tiny` over `plan` (dcn x fsdp x tensor)."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = _tiny()
    mesh = _mesh(plan)
    model = Llama(cfg, init_params(cfg, mesh=mesh), mesh)
    batch = max(2, plan.dcn * plan.data * plan.fsdp)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 64),
                           generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainConfig(warmup_steps=1, total_steps=2),
                      mesh=mesh)
    _, metrics = trainer.train_step(trainer.state, tokens)
    return float(metrics['loss'])


def _rank_ring(plan):
    """Ring attention over `plan`'s fsdp axis on this rank's block (rows
    over dcn x data, heads over tensor, the sequence over fsdp), and its
    largest difference from ring_attention_reference."""
    import torch
    from skypilot_tpu_torch.parallel import ring_attention as ring_lib
    from skypilot_tpu_torch.parallel import sharding
    mesh = _mesh(plan)
    row, n_rows = sharding._index(sharding.CONTEXT_ROW_AXES, mesh)  # pylint: disable=protected-access
    b, h, s, d = 2 * n_rows, 4, 16 * plan.fsdp, 64
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((b, h, s, d), generator=gen) for _ in range(3))
    heads, s_local = h // plan.tensor, s // plan.fsdp
    hi = mesh.coordinate('tensor') * heads
    si = mesh.coordinate('fsdp') * s_local

    def block(x):
        return x[2 * row:2 * row + 2, hi:hi + heads,
                 si:si + s_local].contiguous()

    out = ring_lib.ring_attention(block(q), block(k), block(v), mesh,
                                  causal=True)
    want = ring_lib.ring_attention_reference(q, k, v, plan.fsdp)
    return tuple(out.shape), float((out - block(want)).abs().max())


def _rank_moe(plan):
    """One expert-parallel step of `tiny` with 4 experts over `plan`."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.train.trainer import (TrainConfig,
                                                  make_sharded_train_step,
                                                  make_train_state)
    cfg = dataclasses.replace(_tiny(), n_experts=4, moe_capacity_factor=4.0)
    mesh = _mesh(plan)
    model = Llama(cfg, init_params(cfg, mesh=mesh), mesh)
    n = plan.num_devices
    tokens = torch.randint(0, cfg.vocab_size, (n if n > 8 else 8, 32),
                           generator=torch.Generator().manual_seed(2))
    tcfg = TrainConfig(warmup_steps=1, total_steps=2)
    state = make_train_state(model, tcfg, mesh)
    _, metrics = make_sharded_train_step(mesh, tcfg)(state, tokens)
    experts = tuple(model.layers[0].moe_mlp.w_gate.shape)
    return float(metrics['loss']), experts


def _rank_serve():
    """tensor=2 serving of `tiny` (from seed 0): rank 0 serves [5, 17, 3]
    for 4 tokens, rank 1 follows; both report the kv heads of their
    cache."""
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    cfg = _tiny()
    mesh = build_serve_mesh(2, n_heads=cfg.n_heads,
                            n_kv_heads=cfg.n_kv_heads,
                            devices=['cpu', 'cpu'], backend='gloo')
    model = Llama(cfg, init_params(cfg, mesh=mesh), mesh)
    engine = DecodeEngine(model, EngineConfig(
        n_slots=2, prefill_buckets=(8,), steps_per_call=2, mesh=mesh))
    heads = engine._cache[0][0].shape[1]  # pylint: disable=protected-access
    if not engine.leader:
        engine.follow()
        return None, heads
    try:
        req = engine.submit([5, 17, 3], 4)
        while req.finished_at is None:
            engine.step()
        return req.tokens(), heads
    finally:
        engine.close()


def _stage(params, h):
    import torch
    return torch.tanh(h @ params['w'])


def _rank_pipeline(plan, per_stage, xs, n_micro):
    """pipeline_apply over `plan`'s pipeline axis; the largest difference
    from the sequential fold."""
    import torch
    from skypilot_tpu_torch.parallel import pipeline as pipeline_lib
    mesh = _mesh(plan)
    stacked = pipeline_lib.stack_stage_params(per_stage)
    got = pipeline_lib.pipeline_apply(_stage, stacked, xs, mesh=mesh,
                                      n_microbatches=n_micro)
    want = xs
    for p in per_stage:
        want = _stage(p, want)
    torch.testing.assert_close(got, want, rtol=PIPELINE_TOL,
                               atol=PIPELINE_TOL)
    return float((got - want).abs().max())


def _dryrun_body(n_devices: int) -> None:
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    from skypilot_tpu_torch.parallel import group as group_lib
    from skypilot_tpu_torch.parallel.mesh import plan_mesh
    assert not torch.cuda.is_available(), 'the dry run runs on CPU ranks'
    cfg = LLAMA_CONFIGS['tiny']
    # dcn x data x fsdp x tensor, as the JAX dry run plans it.
    if n_devices % 8 == 0:
        plan = plan_mesh(n_devices, dcn=2, fsdp=2, tensor=2)
    elif n_devices % 4 == 0:
        plan = plan_mesh(n_devices, dcn=2, tensor=2)
    else:
        plan = plan_mesh(n_devices)
    pool = group_lib.RankPool(n_devices, 'gloo', timeout_s=POOL_TIMEOUT_S,
                              threads=1)
    try:
        losses = pool.run(_rank_train, plan, timeout_s=POOL_TIMEOUT_S)
        loss = losses[0]
        assert loss > 0 and all(x == loss for x in losses), losses

        # Context parallelism: the sequence over the fsdp axis.
        ring = pool.run(_rank_ring, plan, timeout_s=POOL_TIMEOUT_S)
        ring_err = max(err for _, err in ring)
        assert ring_err < 1e-4, ring

        # Expert parallelism: the MoE step at expert=4 (EP x DP).
        moe_loss, moe_experts = float('nan'), None
        if n_devices % 4 == 0:
            moe_plan = plan_mesh(n_devices, expert=4, fsdp=1,
                                 data=n_devices // 4)
            moe = pool.run(_rank_moe, moe_plan, timeout_s=POOL_TIMEOUT_S)
            moe_loss, moe_experts = moe[0]
            assert moe_loss > 0 and all(m == moe[0] for m in moe), moe

        # Pipeline parallelism: GPipe against the sequential fold.
        pp = 4 if n_devices % 4 == 0 else n_devices
        pp_plan = plan_mesh(n_devices, pipeline=pp)
        dd = 16
        gen = torch.Generator().manual_seed(3)
        per_stage = [{'w': torch.randn((dd, dd), generator=gen) / dd ** 0.5}
                     for _ in range(pp)]
        xs = torch.randn((8, dd), generator=gen)
        pp_err = max(pool.run(_rank_pipeline, pp_plan, per_stage, xs, 4,
                              timeout_s=POOL_TIMEOUT_S))
    finally:
        pool.close()

    # Tensor-parallel serving on a pool of its own (a serve mesh is the
    # whole group).
    serve_tok, serve_n = float('nan'), 0
    if n_devices % 2 == 0:
        with group_lib.RankPool(2, 'gloo', timeout_s=POOL_TIMEOUT_S,
                                threads=1) as serve_pool:
            served = serve_pool.run(_rank_serve, timeout_s=POOL_TIMEOUT_S)
        toks = served[0][0]
        serve_n, serve_tok = len(toks), toks[0]
        assert serve_n == 4, toks
        assert all(0 <= t < cfg.vocab_size for t in toks), toks
        # The KV cache really is sharded: each rank holds half the heads.
        assert all(heads == cfg.n_kv_heads // 2 for _, heads in served), \
            served

    print(f'dryrun_multichip ok: mesh={plan}, loss={loss:.3f}, '
          f'ring_attention out={ring[0][0]} (max |d| vs reference '
          f'{ring_err:.2e}), moe_loss={moe_loss:.3f} (experts a rank '
          f'{moe_experts}), serve tensor=2 decode tok0={serve_tok} '
          f'n_out={serve_n}, pipeline stages={pp} ok (max |d| vs the '
          f'sequential fold {pp_err:.2e})')


def main() -> int:
    fn, fn_args = entry()
    print('entry logits:', tuple(fn(*fn_args).shape))
    dryrun_multichip(8)
    return 0


if __name__ == '__main__':
    sys.exit(main())
