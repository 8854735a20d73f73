"""Ring attention of the port (skypilot_tpu_torch/parallel/ring_attention.py)
against the JAX package's `ring_attention` and `mha_reference` (mirrors
the ring tests of tests/test_ops.py): the output exact, causal and full,
GQA with a tensor axis, and the gradients in q, k and v; the per-hop
kernel calls and the causal skip; the plain version (`ring_attention_
reference`, the JAX einsum loop) against JAX's ring.

The port's ranks are spawned gloo processes on the CPU (module-scoped
`RankPool`s of 2 and 4, one intra-op thread each): each takes its chunk
of the same global q, k, v (made from a seed with numpy), and on CPU
tensors the kernels' wrappers run their plain versions.  JAX runs in this
process on the 8 virtual CPU devices of tests/conftest.py.  f32
throughout.

This module imports no JAX at its top: the ranks import it by name.
"""
import os

import numpy as np
import pytest
import torch
import torch_rank_lock

from skypilot_tpu_torch.parallel import group as group_lib
from skypilot_tpu_torch.parallel import ring_attention as ring
from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh

torch.set_num_threads(1)

POOL_TIMEOUT_S = 120.0
# tests/test_ops.py's bounds: the output 1e-5, the gradient 1e-4.
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


def qkv(b=2, h=4, s=256, d=64, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


# ----- in the ranks ----------------------------------------------------------
def _mesh(fsdp, tensor):
    return build_mesh(MeshPlan(fsdp=fsdp, tensor=tensor),
                      devices=['cpu'] * (fsdp * tensor), backend='gloo')


def _local(x, mesh):
    """This rank's block of a global [B, H, S, D]: heads over tensor, the
    sequence over fsdp."""
    t, f = mesh.shape['tensor'], mesh.shape['fsdp']
    h, s = x.shape[1] // t, x.shape[2] // f
    i, j = mesh.coordinate('tensor'), mesh.coordinate('fsdp')
    return torch.from_numpy(
        np.ascontiguousarray(x[:, i * h:(i + 1) * h, j * s:(j + 1) * s]))


def rank_ring(q, k, v, g, fsdp, tensor, causal):
    """This rank's output block (and with `g`, its dq, dk, dv blocks),
    with its place: (tensor index, fsdp index)."""
    mesh = _mesh(fsdp, tensor)
    lq, lk, lv = (_local(x, mesh).requires_grad_(g is not None)
                  for x in (q, k, v))
    out = ring.ring_attention(lq, lk, lv, mesh, causal=causal)
    res = {'at': (mesh.coordinate('tensor'), mesh.coordinate('fsdp')),
           'out': out.detach().numpy()}
    if g is not None:
        dq, dk, dv = torch.autograd.grad(out, (lq, lk, lv), _local(g, mesh))
        res.update(dq=dq.numpy(), dk=dk.numpy(), dv=dv.numpy())
    return res


def rank_hop_calls(q, k, v, causal):
    """Which kernel wrappers one forward + backward calls on this rank,
    with their causal flags, in order."""
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    calls = []
    saved = {}
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        fn = getattr(fa, name)
        saved[name] = fn

        def counted(*args, _fn=fn, _name=name, causal=True, **kwargs):
            calls.append((_name, causal))
            return _fn(*args, causal=causal, **kwargs)
        setattr(fa, name, counted)
    try:
        mesh = _mesh(4, 1)
        lq, lk, lv = (_local(x, mesh).requires_grad_() for x in (q, k, v))
        ring.ring_attention(lq, lk, lv, mesh, causal=causal).sum().backward()
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)
    return mesh.coordinate('fsdp'), calls


def rank_transport():
    """The ring's transport choice on a gloo group: through host memory for
    CUDA tensors (gloo cannot move them point to point), direct for the
    CPU's."""
    mesh = _mesh(2, 1)
    group = mesh.group('fsdp')
    return (ring._Ring(group, torch.device('cuda')).via_host,
            ring._Ring(group, torch.device('cpu')).via_host)


def rank_refusals():
    mesh = _mesh(2, 1)
    errors = []
    x = torch.zeros((1, 2, 48, 64))
    for q, block in ((x.transpose(2, 3).contiguous().transpose(2, 3), 512),
                     (x, 32)):
        try:
            ring.ring_attention(q, x, x, mesh, block_size=block)
        except ValueError as e:
            errors.append(str(e))
    return errors


# ----- the JAX side and the fixtures -----------------------------------------
def jax_ring(q, k, v, fsdp, tensor, causal, g=None):
    """JAX's ring output (and its vjp with cotangent g) on 8 devices."""
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.parallel.mesh import build_mesh as jbuild
    from skypilot_tpu.parallel.mesh import plan_mesh
    from skypilot_tpu.parallel.ring_attention import ring_attention
    mesh = jbuild(plan_mesh(8, data=8 // (fsdp * tensor), fsdp=fsdp,
                            tensor=tensor))
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out, vjp = jax.vjp(
        lambda *a: ring_attention(*a, mesh=mesh, causal=causal), *args)
    grads = None if g is None else tuple(map(np.asarray,
                                             vjp(jnp.asarray(g))))
    return np.asarray(out), grads


def mha(q, k, v, causal, g=None):
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.ops.attention import mha_reference
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out, vjp = jax.vjp(lambda *a: mha_reference(*a, causal=causal), *args)
    grads = None if g is None else tuple(map(np.asarray,
                                             vjp(jnp.asarray(g))))
    return np.asarray(out), grads


@pytest.fixture(scope='module')
def pools():
    """Rank pools of 2 and 4, their processes at a lower CPU priority
    (niceness +10): under xdist they share the machine with tests that
    poll on wall-clock deadlines.  They live under the rank-pool lock
    (`tests/torch_rank_lock.py`): one file spawns ranks at a time."""
    with torch_rank_lock.hold(__name__):
        made = {n: group_lib.RankPool(n, 'gloo', timeout_s=POOL_TIMEOUT_S,
                                      threads=1) for n in (2, 4)}
        for pool in made.values():
            pool.run(os.nice, 10, timeout_s=POOL_TIMEOUT_S)
        yield made
        for pool in made.values():
            pool.close()


def assemble(results, key, shape, tensor, fsdp):
    """The global [B, H, S, D] from the ranks' blocks."""
    out = np.zeros(shape, np.float32)
    h, s = shape[1] // tensor, shape[2] // fsdp
    for r in results:
        i, j = r['at']
        out[:, i * h:(i + 1) * h, j * s:(j + 1) * s] = r[key]
    return out


def run_ring(pools, q, k, v, fsdp, tensor, causal, g=None):
    return pools[fsdp * tensor].run(rank_ring, q, k, v, g, fsdp, tensor,
                                    causal, timeout_s=POOL_TIMEOUT_S)


# ----- tests -----------------------------------------------------------------
@pytest.mark.parametrize('causal', [True, False])
def test_ring_attention_exact(pools, causal):
    """fsdp=4 (the JAX test's fsdp=8 on its side): within 1e-5 of JAX's
    ring and of mha_reference."""
    q, k, v = qkv(s=512)
    want, _ = jax_ring(q, k, v, 8, 1, causal)
    ref, _ = mha(q, k, v, causal)
    got = assemble(run_ring(pools, q, k, v, 4, 1, causal), 'out', q.shape,
                   1, 4)
    assert np.abs(got - want).max() < OUT_ATOL
    assert np.abs(got - ref).max() < OUT_ATOL


def test_ring_attention_gqa_with_tensor_axis(pools):
    """GQA (4 query heads over 2 kv heads), fsdp=2 x tensor=2 against
    JAX's fsdp=4 x tensor=2."""
    q, k, v = qkv(h=4, hkv=2, s=256)
    want, _ = jax_ring(q, k, v, 4, 2, True)
    ref, _ = mha(q, k, v, True)
    got = assemble(run_ring(pools, q, k, v, 2, 2, True), 'out', q.shape,
                   2, 2)
    assert np.abs(got - want).max() < OUT_ATOL
    assert np.abs(got - ref).max() < OUT_ATOL


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('fsdp', [2, 4])
def test_ring_attention_grad(pools, causal, fsdp):
    """dq, dk and dv (GQA) within 1e-4 of JAX's ring gradient and of
    mha_reference's, for a random cotangent."""
    q, k, v = qkv(h=4, hkv=2, s=256)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    _, want = jax_ring(q, k, v, fsdp, 1, causal, g)
    _, ref = mha(q, k, v, causal, g)
    res = run_ring(pools, q, k, v, fsdp, 1, causal, g)
    for i, (key, shape) in enumerate((('dq', q.shape), ('dk', k.shape),
                                      ('dv', v.shape))):
        got = assemble(res, key, shape, 1, fsdp)
        assert np.abs(got - want[i]).max() < GRAD_ATOL, key
        assert np.abs(got - ref[i]).max() < GRAD_ATOL, key


@pytest.mark.parametrize('causal', [True, False])
def test_ring_reference_matches_jax(causal):
    """The plain version (one process, the JAX einsum loop) against JAX's
    ring, 4 chunks, GQA."""
    q, k, v = qkv(h=4, hkv=2, s=256)
    want, _ = jax_ring(q, k, v, 8, 1, causal)
    got = ring.ring_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                        n_chunks=4, causal=causal)
    assert np.abs(got.numpy() - want).max() < OUT_ATOL


@pytest.mark.parametrize('causal', [True, False])
def test_ring_hops_call_the_kernels(pools, causal):
    """Rank r of 4: under causal attention r + 1 hops (the diagonal one
    causal, the earlier chunks full, the later ones skipped), each one
    forward, one dq and one dk/dv call; without, 4 full hops."""
    q, k, v = qkv(b=1, h=2, s=128)
    for idx, calls in pools[4].run(rank_hop_calls, q, k, v, causal,
                                   timeout_s=POOL_TIMEOUT_S):
        hops = idx + 1 if causal else 4
        flags = ([True] + [False] * idx) if causal else [False] * 4
        for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                     'flash_attention_bwd_dkv'):
            assert [c for n, c in calls if n == name] == flags, (idx, name)
        assert len(calls) == 3 * hops


def test_ring_transport_by_backend(pools):
    """A gloo group stages CUDA tensors through host buffers (decided from
    the backend, before any hop) and sends CPU tensors directly."""
    assert pools[2].run(rank_transport, timeout_s=POOL_TIMEOUT_S) == [
        (True, False)] * 2


def test_ring_refusals(pools):
    """Non-contiguous inputs and a chunk that does not divide the block are
    refused on every rank."""
    for errors in pools[2].run(rank_refusals, timeout_s=POOL_TIMEOUT_S):
        assert len(errors) == 2
        assert 'contiguous' in errors[0] and 'block' in errors[1]
