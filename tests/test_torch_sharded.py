"""Tensor-parallel serving of the port (skypilot_tpu_torch), against its
single-device engine and the JAX sharded engine (mirrors
tests/test_serve_sharded.py, and the tensor=2 cases of test_serve_paged,
test_serve_spec, test_serve_disagg and test_perf).

The port's mesh is one process per rank: gloo ranks on the CPU, spawned
once per module (`parallel.group.RankPool`, one pool each of 2 and 4
ranks, and two 2-rank pools for the tests that kill a follower) and
given one function per test; tensor 1 is the single-device
engine, as in the JAX tests.  Rank 0 drives its engine and
the others `follow()` it; every rank returns the tokens of every request
it ran, which must equal rank 0's.  The JAX references run in this
process on the 8-device CPU mesh of tests/conftest.py.  f32 compute on
both sides (the o/down partial sums are added in another order than one
device's matmul), the MHA `tiny` variant (n_kv_heads 4) so tensor=4
divides the kv heads; the stock GQA `tiny` (4 q over 2 kv heads) gets its
own tensor=2 case and the tensor=4 refusal.

This module imports no JAX at its top: the ranks import it (by name, the
spawn start method) to find their functions.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch_rank_lock

from skypilot_tpu_torch.inference import kv_transfer
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import shard_params
from skypilot_tpu_torch.parallel import group as group_lib
from skypilot_tpu_torch.parallel.mesh import (MeshPlan, build_mesh,
                                              build_serve_mesh, plan_mesh,
                                              plan_serve_mesh,
                                              validate_tensor_parallel)

torch.set_num_threads(1)

CFG_GQA = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
CFG = dataclasses.replace(CFG_GQA, n_kv_heads=4)      # MHA: tensor=4 legal
KW = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3)
PS = 8
P1, P2 = [5, 17, 3, 42, 9], [7, 8, 9, 10, 11, 12]
# Engine paths: dense and paged each take a chunked prompt (30 > 16).
PATHS = {'dense': {}, 'paged': {'kv_page_size': PS},
         'int8': {'kv_page_size': PS, 'kv_dtype': 'int8'},
         'spec4': {'kv_page_size': PS, 'speculation': 4}}
POOL_TIMEOUT_S = 120.0


def prompt_of(n, seed=0):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, n).tolist()


def cfg_j(cfg):
    """The JAX config of a port config (f32 compute)."""
    import jax.numpy as jnp
    from skypilot_tpu.models import llama as jl
    return dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32,
                               n_kv_heads=cfg.n_kv_heads)


# ----- in the ranks ----------------------------------------------------------
def _engine(full, tensor, cfg=CFG, **kw):
    """This rank's engine: a mesh of `tensor` gloo ranks on the CPU, the
    model's slices of the whole state dict `full`."""
    mesh = build_serve_mesh(tensor, cfg.n_heads, cfg.n_kv_heads,
                            devices=['cpu'] * tensor, backend='gloo')
    model = tl.Llama(cfg, shard_params(full, mesh), mesh)
    return DecodeEngine(model, EngineConfig(mesh=mesh, **dict(KW, **kw)))


def _follow(engine):
    """A follower's part: its requests' tokens (rank 0's, if right)."""
    return [r.tokens() for r in engine.follow(record=True)]


def _run(engine, reqs, step='step'):
    """Step until every request finished; returns their streams."""
    fn = getattr(engine, step)
    for _ in range(3000):
        if all(r.finished_at is not None for r in reqs):
            break
        fn()
    else:
        raise AssertionError('requests did not finish')
    if step == 'step_pipelined':
        engine.drain()
    return [r.tokens() for r in reqs]


def _staggered(engine, step='step'):
    """P1 for 8 tokens; after two steps P2 for 6 (mid-flight admission)."""
    r1 = engine.submit(P1, 8)
    for _ in range(2):
        getattr(engine, step)()
    r2 = engine.submit(P2, 6)
    return _run(engine, [r1, r2], step)


def rank_staggered(full, tensor, cfg=CFG):
    engine = _engine(full, tensor, cfg)
    if not engine.leader:
        return _follow(engine)
    try:
        return _staggered(engine)
    finally:
        engine.close()


def rank_paths(full, tensor, path, prompts, n_new):
    """Every prompt at once on one engine of `path` (PATHS), stepped
    synchronously after prewarm()."""
    engine = _engine(full, tensor, **PATHS[path])
    if not engine.leader:
        return _follow(engine)
    try:
        engine.prewarm()
        return _run(engine, [engine.submit(p, n_new) for p in prompts])
    finally:
        engine.close()


def rank_refusals(full):
    """A 4-way mesh over the GQA model's 2 kv heads: refused by the
    planner and by the model, on every rank."""
    errors = []
    try:
        build_serve_mesh(4, CFG_GQA.n_heads, CFG_GQA.n_kv_heads,
                         devices=['cpu'] * 4, backend='gloo')
    except ValueError as e:
        errors.append(str(e))
    mesh = build_mesh(MeshPlan(tensor=4), ['cpu'] * 4, 'gloo')
    try:
        tl.Llama(CFG_GQA, full, mesh)
    except ValueError as e:
        errors.append(str(e))
    return errors


def rank_slot_reuse(full, tensor):
    engine = _engine(full, tensor, n_slots=1, prefill_buckets=(8,))
    if not engine.leader:
        return _follow(engine)
    try:
        return (_run(engine, [engine.submit([4] * 8, 5)]) +
                _run(engine, [engine.submit([9, 1, 9], 5)]))
    finally:
        engine.close()


PIPE_PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [4, 4, 4, 4, 4], [11, 12]]
PIPE_LENS = [10, 6, 5, 7]


def rank_pipelined(full, tensor):
    """A backlog through 2 slots on the pipelined loop, twice."""
    out = []
    for _ in range(2):
        engine = _engine(full, tensor)
        if not engine.leader:
            out += _follow(engine)
            continue
        try:
            out += _run(engine, [engine.submit(p, n) for p, n in
                                 zip(PIPE_PROMPTS, PIPE_LENS)],
                        'step_pipelined')
        finally:
            engine.close()
    return out


def rank_zero_builds(full, tensor):
    """prewarm(), then traffic under the strict sentinel: no call object
    is built again (a build would raise in the building call)."""
    from skypilot_tpu_torch.perf import compile_telemetry
    compile_telemetry.reset_for_tests()
    os.environ[compile_telemetry.STRICT_ENV] = '1'
    engine = _engine(full, tensor)
    try:
        if not engine.leader:
            return {'tokens': _follow(engine),
                    'builds': compile_telemetry.summary()}
        engine.prewarm()
        engine.arm_recompile_sentinel()
        builds = compile_telemetry.summary()
        call = engine._decode_call
        toks = _run(engine, [engine.submit([9, 1, 9], 5),
                             engine.submit([2, 4, 6, 8], 4)],
                    'step_pipelined')
        toks += _run(engine, [engine.submit([1, 2, 3], 2)])
        assert engine._decode_call is call
        engine.close()
        return {'tokens': toks, 'builds': builds,
                'after': compile_telemetry.summary()}
    finally:
        del os.environ[compile_telemetry.STRICT_ENV]
        compile_telemetry.disarm()


def rank_update_params(full, tensor, scaled):
    """Serve, swap in `scaled` (whole, on rank 0) with no loop thread,
    serve again; every rank reports its q_proj slice's shape and whether
    it holds its slice of `scaled`."""
    engine = _engine(full, tensor)
    q = engine.model.layers[0].attn.q_proj.weight
    if not engine.leader:
        toks = _follow(engine)
    else:
        toks = _run(engine, [engine.submit([5, 17, 3], 4)])
        call = engine._decode_call
        engine.update_params(scaled)
        toks += _run(engine, [engine.submit([5, 17, 3], 4)])
        assert engine._decode_call is call
        engine.close()
    mine = shard_params(scaled, engine._mesh)
    return {'tokens': toks, 'q_rows': q.shape[0], 'q_ptr': q.data_ptr(),
            'installed': all(torch.equal(t, mine[n]) for n, t in
                             engine.model.state_dict().items())}


def rank_rollout(full, tensor):
    from skypilot_tpu_torch.train import rl
    engine = _engine(full, tensor, n_slots=2, prefill_buckets=(8,),
                     temperature=0.7, seed=1)
    if not engine.leader:
        return {'tokens': _follow(engine)}
    try:
        tokens, adv, plens, tlens = rl.rollout(
            engine, [[1, 2, 3], [7, 8, 9]], 4, lambda p, s: float(len(s)))
        engine.drain()
        sampled = [tokens[i, plens[i]:tlens[i]].tolist() for i in range(2)]
        return {'tokens': sampled, 'shape': tokens.shape, 'adv': adv.shape,
                'new': (tlens - plens).max()}
    finally:
        engine.close()


def rank_load_checkpoint(path, tensor):
    """Each rank restores its slices of a checkpoint and serves them."""
    from skypilot_tpu_torch.inference.weights import load_serving_params
    mesh = build_serve_mesh(tensor, CFG.n_heads, CFG.n_kv_heads,
                            devices=['cpu'] * tensor, backend='gloo')
    params = load_serving_params(path, device='cpu', mesh=mesh)
    engine = DecodeEngine(tl.Llama(CFG, params, mesh),
                          EngineConfig(mesh=mesh, **dict(
                              KW, n_slots=1, prefill_buckets=(8,))))
    shapes = {n: tuple(t.shape) for n, t in params.items()}
    if not engine.leader:
        return {'tokens': _follow(engine), 'shapes': shapes}
    try:
        return {'tokens': _run(engine, [engine.submit([5, 17, 3], 4)]),
                'shapes': shapes}
    finally:
        engine.close()


def rank_handoff(full, tensor, prompt, n_new, jax_payload):
    """Prefill on engine A (exported, serialized), adopt A's payload on
    engine B and a JAX engine's payload on engine C, one engine after the
    other on the same ranks."""
    out, payload = [], None
    for role in ('prefill', 'adopt', 'adopt_jax'):
        engine = _engine(full, tensor, kv_page_size=PS)
        if not engine.leader:
            out += _follow(engine)
            continue
        try:
            if role == 'prefill':
                req = engine.submit_prefill(prompt, n_new)
                out += _run(engine, [req])
                ex = engine.export_result(req)
                payload = kv_transfer.serialize(kv_transfer.KVHandoff(
                    prompt_ids=prompt, first_token=ex['first_token'],
                    max_new_tokens=n_new, page_size=PS,
                    leaves=ex['leaves']))
            else:
                h = kv_transfer.deserialize(
                    payload if role == 'adopt' else jax_payload)
                out += _run(engine, [engine.submit_adopt(
                    h.prompt_ids, h.first_token, h.leaves,
                    h.max_new_tokens, page_size=h.page_size)])
        finally:
            engine.close()
    return {'tokens': out, 'payload': payload}


def rank_gauges(full, tensor):
    """Rank 0's gauges over a sharded engine: one `.cpu()` per active
    step, no build after arming, MFU and bytes/token gauges set."""
    from skypilot_tpu_torch.perf import compile_telemetry
    from skypilot_tpu_torch.server import metrics as metrics_lib
    engine = _engine(full, tensor, cfg=CFG_GQA, prefill_buckets=(8,))
    cm = dataclasses.asdict(engine.perf_cost_model)
    if not engine.leader:
        return {'tokens': _follow(engine), 'cost_model': cm}
    toks = _run(engine, [engine.submit([1, 2, 3], 2)])
    toks += _run(engine, [engine.submit([4, 5, 6, 7], 1)])
    engine.arm_recompile_sentinel()
    before = compile_telemetry.summary()
    real_cpu, calls = torch.Tensor.cpu, []

    def cpu(t, *args, **kwargs):
        calls.append(1)
        return real_cpu(t, *args, **kwargs)

    engine.perf_window_s = 1e9
    engine.perf_reset_window()
    req = engine.submit([1, 2, 3, 4], 6)
    active = 0
    torch.Tensor.cpu = cpu
    try:
        while req.finished_at is None:
            if engine.step() > 0:
                active += 1
    finally:
        torch.Tensor.cpu = real_cpu
    engine.perf_window_s = 0.0
    engine.step()
    toks.append(req.tokens())
    gauges = {line.split(' ')[0]: float(line.rsplit(' ', 1)[1])
              for line in metrics_lib.render().splitlines()
              if line.startswith(('skytpu_engine_mfu ',
                                  'skytpu_engine_hbm_bytes_per_token '))}
    engine.close()
    compile_telemetry.disarm()
    return {'tokens': toks, 'cost_model': cm, 'fetches': len(calls),
            'active': active, 'gauges': gauges,
            'builds': (before, compile_telemetry.summary())}


def _die_at(engine, n_calls):
    """Make a follower's process exit (as a killed rank does) when it
    starts its `n_calls`-th step of either kind."""
    calls = []

    def dying(step):
        def run():
            calls.append(1)
            if len(calls) == n_calls:
                os._exit(0)
            return step()
        return run

    engine._step = dying(engine._step)
    engine._step_pipelined = dying(engine._step_pipelined)


def _drained_within(req, timeout_s):
    """Req's tokens if its stream closes within `timeout_s`, else None."""
    toks, done = [], threading.Event()

    def drain():
        toks.extend(req.tokens())
        done.set()

    threading.Thread(target=drain, daemon=True).start()
    return toks if done.wait(timeout_s) else None


def rank_follower_dies(full, tensor, loop, result_path):
    """Rank 1 exits mid-request.  With the loop thread (`loop`), rank 0
    serves a long request; without it, rank 0 steps by hand and then
    submits a request whose announcement fails.  Rank 0 writes what its
    callers saw to `result_path` (the pool reports rank 1's exit)."""
    import json
    engine = _engine(full, tensor)
    if not engine.leader:
        _die_at(engine, 3)
        engine.follow()
        return None
    seen = {}
    if loop:
        engine.start()
        seen['first'] = _drained_within(engine.submit(P1, 40), 20.0)
        try:
            engine.submit(P2, 4)
            seen['refused'] = None
        except RuntimeError as e:
            seen['refused'] = str(e)
        engine.stop()
    else:
        req, failed = engine.submit(P1, 40), []
        for _ in range(4):
            try:
                engine.step()
            except Exception:  # pylint: disable=broad-except
                failed.append(1)
                break
        late = engine.submit(P2, 4)
        try:
            engine.step()
        except Exception:  # pylint: disable=broad-except
            failed.append(2)
        seen['failed'] = failed
        seen['late'] = _drained_within(late, 20.0)
    seen['error'] = repr(engine.error)
    with open(result_path, 'w') as f:
        json.dump(seen, f)
    return seen


# ----- in this process ---------------------------------------------------------
def same_on_every_rank(out):
    """Every rank's tokens (a rank function's result, or its 'tokens')
    equal rank 0's; returns rank 0's result."""
    toks = [o['tokens'] if isinstance(o, dict) else o for o in out]
    assert all(t == toks[0] for t in toks[1:]), toks
    return out[0]


@pytest.fixture(scope='module')
def pools():
    """Pools of 2 and 4 gloo ranks, and two 2-rank pools whose rank 1
    dies in its test (a short collective timeout), started together
    (each rank imports torch and this module once), under the rank-pool
    lock (`tests/torch_rank_lock.py`): one file's ranks compute at a
    time."""
    made = {t: torch_rank_lock.LockedPool(__name__, t, POOL_TIMEOUT_S,
                                          nice=0) for t in (2, 4)}
    made.update({('dying', loop): torch_rank_lock.LockedPool(
        __name__, 2, 10.0, nice=0) for loop in (True, False)})
    yield made
    for pool in made.values():
        pool.close()


@pytest.fixture(scope='module')
def ref():
    """(JAX params of CFG, the port's whole state dict of them)."""
    import jax
    from skypilot_tpu_torch.models.convert import params_from_jax
    from test_torch_paged import jax_params
    _, params_j = jax_params(cfg_j(CFG))
    return params_j, params_from_jax(jax.tree.map(np.asarray, params_j))


def run_ranks(pools, tensor, fn, *args):
    return pools[tensor].run(fn, *args, timeout_s=POOL_TIMEOUT_S)


def single_engine(full, cfg=CFG, **kw):
    return DecodeEngine(tl.Llama(cfg, full), EngineConfig(**dict(KW, **kw)),
                        device='cpu')


def naive_greedy(cfg, full, prompt, n_new):
    """Full forward over the growing sequence each step, one device."""
    model, ids = tl.Llama(cfg, full), list(prompt)
    for _ in range(n_new):
        with torch.no_grad():
            logits = model(torch.tensor([ids]))
        ids.append(int(logits[0, -1].argmax()))
    return ids[len(prompt):]


def jax_engine(params_j, tensor, cfg=CFG, **kw):
    from skypilot_tpu.inference import engine as je
    from skypilot_tpu.models import llama as jl
    from skypilot_tpu.parallel.mesh import build_serve_mesh as jax_mesh
    mesh = None
    if tensor > 1:
        mesh = jax_mesh(tensor, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads)
    return je.DecodeEngine(jl.Llama(cfg_j(cfg), mesh), params_j,
                           je.EngineConfig(mesh=mesh, **dict(KW, **kw)))


# ----- mesh planning ---------------------------------------------------------
def test_plan_serve_mesh_defaults():
    p = plan_serve_mesh(8)
    assert p.tensor == 8 and p.fsdp == 1 and p.num_devices == 8
    p2 = plan_serve_mesh(8, tensor=2)
    assert p2.tensor == 2 and p2.data == 4 and p2.num_devices == 8
    with pytest.raises(ValueError, match='tensor'):
        plan_serve_mesh(8, tensor=16)
    with pytest.raises(ValueError, match='tensor'):
        plan_serve_mesh(8, tensor=3)


def test_plan_serve_mesh_gqa_divisibility():
    with pytest.raises(ValueError, match='GQA'):
        plan_serve_mesh(8, tensor=4, n_heads=4, n_kv_heads=2)
    with pytest.raises(ValueError, match='n_heads'):
        validate_tensor_parallel(8, n_heads=4, n_kv_heads=8)
    validate_tensor_parallel(2, n_heads=4, n_kv_heads=2)  # divides: fine


def test_plan_serve_mesh_ignores_num_slices(monkeypatch):
    monkeypatch.setenv('SKYTPU_NUM_SLICES', '3')
    with pytest.raises(ValueError):
        plan_mesh(8)
    p = plan_serve_mesh(8, tensor=2)
    assert p.dcn == 1 and p.tensor == 2


def test_build_serve_mesh_needs_the_cards():
    """No fallback: without enough CUDA devices the default mesh is
    refused (this machine has none), and NCCL never puts two ranks on one
    card."""
    with pytest.raises(ValueError, match='needs 2 devices'):
        build_serve_mesh(2, n_heads=4, n_kv_heads=4)
    with pytest.raises(ValueError, match="backend='gloo'"):
        build_mesh(plan_serve_mesh(2, tensor=2), ['cuda:0', 'cuda:0'],
                   'nccl')
    with pytest.raises(RuntimeError, match='not initialized'):
        build_serve_mesh(2, devices=['cpu', 'cpu'])


def test_engine_rejects_bad_gqa_mesh(pools):
    full = tl.init_params(CFG_GQA, 'cpu')
    for errors in run_ranks(pools, 4, rank_refusals, full):
        assert len(errors) == 2 and all('GQA' in e for e in errors), errors


# ----- engine parity ---------------------------------------------------------
def test_sharded_engine_matches_single_device(pools, ref):
    """Greedy tokens at tensor 1 (one device), 2 and 4 (staggered
    admission) are the full-forward reference's, on every rank, and the
    JAX engine's at tensor 1, 2 and 4."""
    params_j, full = ref
    want = [naive_greedy(CFG, full, P1, 8), naive_greedy(CFG, full, P2, 6)]
    assert _staggered(single_engine(full)) == want
    for tensor in (2, 4):
        got = same_on_every_rank(run_ranks(pools, tensor, rank_staggered,
                                           full, tensor))
        assert got == want, tensor
    for tensor in (1, 2, 4):
        assert _staggered(jax_engine(params_j, tensor)) == want, tensor


@pytest.mark.parametrize('tensor', [2, 4])
@pytest.mark.parametrize('path', list(PATHS))
def test_paths_match_single_device_and_jax(pools, ref, path, tensor):
    """Dense, paged, int8 pages and speculation k=4, each with a chunked
    prompt: the tensor-parallel engine's tokens are the port's
    single-device engine's and the JAX sharded engine's."""
    params_j, full = ref
    prompts = [prompt_of(5, 1), prompt_of(30, 2)]
    got = same_on_every_rank(run_ranks(pools, tensor, rank_paths, full,
                                       tensor, path, prompts, 6))
    one = single_engine(full, **PATHS[path])
    assert got == _run(one, [one.submit(p, 6) for p in prompts])
    jax_e = jax_engine(params_j, tensor, **PATHS[path])
    assert got == _run(jax_e, [jax_e.submit(p, 6) for p in prompts])


def test_chunked_matches_fused_tensor2(pools, ref):
    """Prompts of 20 and 120 tokens (2 and 8 chunks of 16) at tensor=2:
    every rank's tokens equal the fused single-dispatch path's on one
    device (an engine whose bucket holds the whole prompt) and the JAX
    fused engine's (tests/test_serve_chunked.py's tensor-2 parity)."""
    params_j, full = ref
    prompts = [prompt_of(20, seed=31), prompt_of(120, seed=32)]
    got = same_on_every_rank(run_ranks(pools, 2, rank_paths, full, 2,
                                       'dense', prompts, 6))
    fused = single_engine(full, prefill_buckets=(8, 16, 128))
    want = [_run(fused, [fused.submit(p, 6)])[0] for p in prompts]
    assert got == want
    ref_engine = jax_engine(params_j, 1, prefill_buckets=(8, 16, 128))
    reqs = [ref_engine.submit(p, 6) for p in prompts]
    assert _run(ref_engine, reqs) == want


def test_sharded_engine_gqa(pools):
    """2 kv heads over tensor=2 (one kv head and two q heads per rank)."""
    full = tl.init_params(CFG_GQA, 'cpu')
    got = same_on_every_rank(run_ranks(pools, 2, rank_staggered, full, 2,
                                       CFG_GQA))
    assert got == [naive_greedy(CFG_GQA, full, P1, 8),
                   naive_greedy(CFG_GQA, full, P2, 6)]


def test_sharded_engine_slot_reuse_no_kv_leak(pools, ref):
    _, full = ref
    got = same_on_every_rank(run_ranks(pools, 2, rank_slot_reuse, full, 2))
    assert got[1] == naive_greedy(CFG, full, [9, 1, 9], 5)


def test_sharded_engine_pipelined_loop(pools, ref):
    """The pipelined loop (what start() runs) over a backlog: every
    request gets exactly its budget and two runs agree."""
    _, full = ref
    got = same_on_every_rank(run_ranks(pools, 2, rank_pipelined, full, 2))
    n = len(PIPE_PROMPTS)
    assert [len(t) for t in got[:n]] == PIPE_LENS
    assert got[:n] == got[n:]


@pytest.mark.parametrize('loop', [True, False], ids=['loop', 'manual'])
def test_sharded_engine_follower_death_ends_requests(pools, ref, tmp_path,
                                                    loop):
    """A follower killed mid-request: rank 0's requests end within a
    bounded time instead of waiting forever, whether they were in a slot
    (the loop's crash handler) or just taken from the inbox by a failed
    announcement; the dead engine refuses new requests."""
    import json
    _, full = ref
    result = tmp_path / 'rank0.json'
    with pytest.raises(RuntimeError, match='rank 1'):
        pools['dying', loop].run(rank_follower_dies, full, 2, loop,
                                 str(result), timeout_s=POOL_TIMEOUT_S)
    seen = json.loads(result.read_text())
    if loop:
        assert seen['error'] != 'None'
        assert seen['first'] is not None, 'the in-flight request hung'
        assert len(seen['first']) < 40
        assert 'dead' in seen['refused']
    else:
        assert seen['failed'] == [1, 2]
        assert seen['late'] == [], 'the unannounced request hung'


def test_sharded_engine_zero_recompiles(pools, ref):
    """After prewarm() the traffic builds no call object on any rank
    (the strict sentinel would raise in the building call)."""
    _, full = ref
    out = run_ranks(pools, 2, rank_zero_builds, full, 2)
    same_on_every_rank(out)
    lead = out[0]
    assert lead['builds'] == lead['after']
    assert lead['builds']['decode'][0] == 1
    assert out[1]['builds']['decode'][0] == 1


def test_sharded_update_params_preserves_shardings(pools, ref):
    """update_params with the whole tree (rank 0): every rank installs its
    slice into the parameters it serves (same storage, no rebuilt call)
    and serves the new weights."""
    _, full = ref
    scaled = {n: t * 1.01 for n, t in full.items()}
    out = run_ranks(pools, 2, rank_update_params, full, 2, scaled)
    got = same_on_every_rank(out)['tokens']
    assert got == [naive_greedy(CFG, full, [5, 17, 3], 4),
                   naive_greedy(CFG, scaled, [5, 17, 3], 4)]
    for o in out:
        assert o['installed']
        assert o['q_rows'] == CFG.n_heads // 2 * CFG.head_dim


def test_sharded_engine_rl_rollout(pools, ref):
    """train/rl.py's rollout runs on rank 0 of a tensor-parallel engine,
    unmodified, sampling at temperature 0.7: every rank draws the same
    tokens."""
    _, full = ref
    lead = same_on_every_rank(run_ranks(pools, 2, rank_rollout, full, 2))
    assert lead['shape'][0] == 2 and lead['adv'] == (2,)
    assert lead['new'] <= 4
    assert all(0 <= t < CFG.vocab_size for s in lead['tokens'] for t in s)


def test_load_serving_params_sharded(pools, ref, tmp_path):
    """Shard-on-load: each rank reads its slices of the checkpoint (the
    whole tree never on one device) and serves single-device tokens."""
    from skypilot_tpu_torch.inference.weights import serving_shardings
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    _, full = ref

    class Params:       # what CheckpointManager.save takes: a state_dict()
        state_dict = staticmethod(lambda: full)

    CheckpointManager(str(tmp_path / 'ckpt')).save(0, Params)
    out = run_ranks(pools, 2, rank_load_checkpoint, str(tmp_path / 'ckpt'),
                    2)
    lead = same_on_every_rank(out)
    assert lead['tokens'] == [naive_greedy(CFG, full, [5, 17, 3], 4)]
    q = 'layers.0.attn.q_proj.weight'
    assert lead['shapes'][q] == (CFG.n_heads // 2 * CFG.head_dim, CFG.dim)
    assert lead['shapes']['layers.0.attn_norm.scale'] == (CFG.dim,)

    class Mesh2:
        shape = dict(dcn=1, pipeline=1, data=1, fsdp=1, expert=1, tensor=2)

    specs = serving_shardings(CFG, Mesh2)
    assert specs[q] == ('tensor', 'fsdp')
    assert specs['layers.0.attn.o_proj.weight'] == ('fsdp', 'tensor')
    assert specs['final_norm.scale'] == ('fsdp',)


def test_service_spec_tensor_parallel_roundtrip(monkeypatch):
    """A serve spec's tensor_parallel reaches the JAX replica env var,
    which the port's server reads as its --tensor default."""
    from skypilot_tpu.serve import replica_managers
    from skypilot_tpu.serve.service_spec import ServiceSpec
    from skypilot_tpu_torch.inference import server
    spec = ServiceSpec.from_yaml_config({'readiness_probe': '/health',
                                         'replicas': 2,
                                         'tensor_parallel': 4})
    assert spec.tensor_parallel == 4
    monkeypatch.setenv(replica_managers.ENV_REPLICA_TENSOR,
                       str(spec.tensor_parallel))
    assert server.parse_args(['--model', 'tiny']).tensor == 4


# ----- paged, speculation, handoff at tensor=2 -------------------------------
def test_paged_matches_unpaged_tensor2(pools, ref):
    _, full = ref
    prompts = [prompt_of(5, 3), prompt_of(30, 4)]
    base = single_engine(full)
    want = _run(base, [base.submit(p, 6) for p in prompts])
    got = same_on_every_rank(run_ranks(pools, 2, rank_paths, full, 2,
                                       'paged', prompts, 6))
    assert got == want


def test_spec_parity_tensor2(pools, ref):
    _, full = ref
    prompt = prompt_of(13, 5)
    base = single_engine(full, kv_page_size=PS)
    want = _run(base, [base.submit(prompt, 12)])
    got = same_on_every_rank(run_ranks(pools, 2, rank_paths, full, 2,
                                       'spec4', [prompt], 12))
    assert got == want


def _handoff_parity(pools, ref, tensor, plen):
    from skypilot_tpu.inference import kv_transfer as jax_transfer
    params_j, full = ref
    prompt = prompt_of(plen, 6)
    mono = single_engine(full, kv_page_size=PS)
    want = _run(mono, [mono.submit(prompt, 10)])[0]
    jax_e = jax_engine(params_j, 1, kv_page_size=PS)
    req = jax_e.submit_prefill(prompt, 10)
    _run(jax_e, [req])
    ex = jax_e.export_result(req)
    jax_payload = jax_transfer.serialize(jax_transfer.KVHandoff(
        prompt_ids=prompt, first_token=ex['first_token'], max_new_tokens=10,
        page_size=PS, leaves=ex['leaves']))
    out = run_ranks(pools, tensor, rank_handoff, full, tensor, prompt, 10,
                    jax_payload)
    first, from_port, from_jax = same_on_every_rank(out)['tokens']
    assert first == [want[0]]
    assert from_port == want and from_jax == want
    h = jax_transfer.deserialize(out[0]['payload'])
    req = jax_e.submit_adopt(h.prompt_ids, h.first_token, h.leaves,
                             h.max_new_tokens, page_size=h.page_size)
    assert _run(jax_e, [req])[0] == want


@pytest.mark.parametrize('plen', [13, 40])
def test_handoff_parity_tensor2(pools, ref, plen):
    """tensor=2 engines export every rank's kv heads into the usual
    payload and adopt one back: prefill -> bytes -> decode on tensor=2 is
    the monolithic stream, and payloads cross with the JAX engine (JAX
    prefill -> port tensor=2 decode, port tensor=2 prefill -> JAX
    decode)."""
    _handoff_parity(pools, ref, 2, plen)


def test_handoff_parity_tensor4(pools, ref):
    """The same at tensor=4 (one kv head per rank), chunked prompt."""
    _handoff_parity(pools, ref, 4, 40)


# ----- perf gauges -------------------------------------------------------------
def test_sharded_engine_perf_gauges_zero_syncs(pools):
    """tensor=2: the cost model is the JAX sharded engine's field for
    field (whole weights, n_chips 2), gauges appear, one `.cpu()` per
    active step on rank 0, no build after warmup."""
    import jax
    from skypilot_tpu.perf import cost_model as jax_cost_model
    from skypilot_tpu_torch.models.convert import params_from_jax
    from skypilot_tpu_torch.perf import cost_model as cost_model_lib
    from test_torch_paged import jax_params
    _, params_j = jax_params(cfg_j(CFG_GQA))
    full = params_from_jax(jax.tree.map(np.asarray, params_j))
    out = run_ranks(pools, 2, rank_gauges, full, 2)
    lead = same_on_every_rank(out)
    want = jax_engine(params_j, 2, cfg=CFG_GQA,
                      prefill_buckets=(8,)).perf_cost_model
    assert isinstance(want, jax_cost_model.EngineCostModel)
    assert want.n_chips == 2
    for o in out:
        got = cost_model_lib.EngineCostModel(**o['cost_model'])
        assert dataclasses.replace(got, chip='') == dataclasses.replace(
            cost_model_lib.EngineCostModel(**dataclasses.asdict(want)),
            chip='')
    assert lead['fetches'] == lead['active'] > 0
    assert lead['builds'][0] == lead['builds'][1]
    assert lead['gauges']['skytpu_engine_mfu'] > 0
    assert lead['gauges']['skytpu_engine_hbm_bytes_per_token'] > 0


# ----- the server's --tensor ---------------------------------------------------
def test_server_tensor_needs_the_cards():
    """No fallback: `--tensor 2` on CUDA needs two cards; this machine
    has none, so the server exits before it spawns a rank."""
    from skypilot_tpu_torch.inference import server
    with pytest.raises(SystemExit, match='needs 2 CUDA devices'):
        server.main(['--model', 'tiny', '--tensor', '2'])
    with pytest.raises(SystemExit, match='GQA'):
        server.main(['--model', 'tiny', '--tensor', '4', '--device', 'cpu'])


def _http_json(url, body=None, timeout=30):
    import json
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_server_tensor2_http_round_trip():
    """`server.main(['--device', 'cpu', '--tensor', '2', ...])` spawns its
    follower, serves a completion over HTTP, and on SIGTERM closes the
    follower and exits 0, leaving no process behind."""
    port = group_lib.free_port()
    code = ('from skypilot_tpu_torch.inference import server; '
            f"server.main(['--device', 'cpu', '--tensor', '2', '--model', "
            f"'tiny', '--max-seq-len', '64', '--n-slots', '2', '--port', "
            f"'{port}'])")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path
                                                      if p))
    proc = subprocess.Popen([sys.executable, '-c', code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = []
    reader = threading.Thread(target=lambda: log.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, b''.join(log).decode()[-3000:]
            try:
                status, body = _http_json(f'http://127.0.0.1:{port}/health',
                                          timeout=2)
                break
            except OSError:
                assert time.time() < deadline, 'server did not come up'
                time.sleep(0.5)
        assert status == 200 and body['status'] == 'ok'
        status, body = _http_json(
            f'http://127.0.0.1:{port}/v1/completions',
            {'prompt_ids': [5, 17, 3, 42], 'max_tokens': 6}, timeout=60)
        assert status == 200 and len(body['ids']) == 6
        assert all(0 <= i < 256 for i in body['ids'])
        children = _children(proc.pid)
        assert children, 'no follower process'
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, b''.join(log).decode()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    deadline = time.time() + 30
    while any(os.path.exists(f'/proc/{pid}') for pid in children):
        assert time.time() < deadline, f'ranks left running: {children}'
        time.sleep(0.2)


def _children(pid):
    with open(f'/proc/{pid}/task/{pid}/children') as f:
        return [int(c) for c in f.read().split()]
