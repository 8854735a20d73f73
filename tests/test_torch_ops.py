"""Port attention ops against the JAX package's: `mha_reference`, and the
flash kernels' plain versions (what CPU tensors take, forward and
backward) against the Pallas kernels in interpret mode, and the autograd
op against autograd through `mha_reference`.  Inputs come from a seeded numpy generator and
go to both frameworks as numpy; JAX stays on the CPU.  Also, without a
GPU: the kernel library's name covers every source and header, and each
C entry point's parameters match its ctypes signature."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jax_attn
from skypilot_tpu.ops.pallas import flash_attention as jax_fa
from skypilot_tpu_torch.ops import attention as torch_attn
from skypilot_tpu_torch.ops.cuda import flash_attention as torch_fa

torch.set_num_threads(1)


def _qkv(b=2, h=4, s=256, d=64, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, h, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# f32 on both sides: only summation order differs.
MHA_ATOL = 1e-5


@pytest.mark.parametrize('causal,hkv', [(True, None), (False, None),
                                        (True, 2)])
def test_mha_reference_matches_jax(causal, hkv):
    q, k, v = _qkv(s=64, hkv=hkv)
    want = np.asarray(jax_attn.mha_reference(q, k, v, causal=causal))
    got = torch_attn.mha_reference(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=MHA_ATOL, rtol=0)


def test_mha_reference_positions_fully_masked_row():
    """Cache-style masking from absolute positions; row 0 of batch 1 sees
    no key (its position precedes every kv position) and must be 0."""
    q, k, v = _qkv(b=2, h=4, s=8, d=16, hkv=2)
    q = q[:, :, :3]
    seg = np.array([[5, 6, 7], [1, 9, 10]], np.int32)
    kv = np.tile(np.arange(2, 10, dtype=np.int32), (2, 1))
    want = np.asarray(jax_attn.mha_reference(
        q, k, v, causal=True, segment_positions=seg, kv_positions=kv))
    got = torch_attn.mha_reference(
        *_t(q, k, v), causal=True,
        segment_positions=torch.from_numpy(seg),
        kv_positions=torch.from_numpy(kv)).numpy()
    assert np.all(got[1, :, 0] == 0.0)
    np.testing.assert_allclose(got, want, atol=MHA_ATOL, rtol=0)


# The interpret-mode Pallas kernel's own tolerance against the reference
# (tests/test_ops.py): blocked online softmax vs one-shot f32.
FLASH_ATOL = 5e-3


@pytest.mark.parametrize('causal,hkv', [(True, None), (False, None),
                                        (True, 2)])
def test_flash_fwd_plain_matches_pallas_interpret(causal, hkv):
    q, k, v = _qkv(b=2, h=4, s=256, d=64, hkv=hkv)
    want_out, want_lse = jax_fa.flash_attention_fwd(
        q, k, v, causal=causal, block_size=128, interpret=True,
        return_residuals=True)
    before = torch_fa.flash_attention_fwd.launches
    got_out, got_lse = torch_fa.flash_attention_fwd(
        *_t(q, k, v), causal=causal, block_size=128, return_residuals=True)
    assert torch_fa.flash_attention_fwd.launches == before  # CPU: no kernel
    assert got_out.dtype == torch.float32 and got_lse.shape == (2, 4, 256)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=FLASH_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=FLASH_ATOL, rtol=0)
    # The public op returns the same output.
    np.testing.assert_allclose(
        torch_attn.flash_attention(*_t(q, k, v), causal=causal,
                                   block_size=128).numpy(),
        got_out.numpy(), atol=0, rtol=0)


# The `tiny` configs' head_dim 16 (and 32) go to the small-head-dim
# kernel on the card; its plain version on the CPU is the same function.
@pytest.mark.parametrize('s,d,causal', [(8, 16, True), (16, 16, True),
                                        (16, 16, False), (128, 16, True),
                                        (128, 32, False), (16, 32, True)])
def test_flash_fwd_small_head_dims_plain_match_pallas_interpret(s, d,
                                                                causal):
    q, k, v = _qkv(b=2, h=4, s=s, d=d, hkv=2, seed=5)
    want_out, want_lse = jax_fa.flash_attention_fwd(
        q, k, v, causal=causal, interpret=True, return_residuals=True)
    before = (torch_fa.flash_attention_fwd.launches,
              torch_fa.flash_attention_fwd_small.launches)
    for fn in (torch_fa.flash_attention_fwd,
               torch_fa.flash_attention_fwd_small):
        got_out, got_lse = fn(*_t(q, k, v), causal=causal,
                              return_residuals=True)
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                                   atol=FLASH_ATOL, rtol=0)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   atol=FLASH_ATOL, rtol=0)
    assert (torch_fa.flash_attention_fwd.launches,
            torch_fa.flash_attention_fwd_small.launches) == before


def test_forward_dispatches_small_head_dims_to_their_kernel(monkeypatch):
    """On a CUDA tensor the forward takes head_dim 16 and 32 to the
    small kernel's C entry (counted on `flash_attention_fwd_small`), 64
    and 128 to the wgmma kernel's, and refuses any other head_dim naming
    the supported set; the backward's dq and dk/dv route the same way to
    their small kernels' entries (counted on `flash_attention_bwd_dq_small`
    and `_dkv_small`) and refuse the same head dims.  (The launches
    themselves are stubbed: the checks and the routing are host code.)"""
    calls = []
    monkeypatch.setattr(torch_fa, '_device_type', lambda *ts: 'cuda')
    for launch in ('_launch_fwd', '_launch_dq', '_launch_dkv'):
        monkeypatch.setattr(
            torch_fa, launch,
            lambda entry, wrapper, *args: calls.append((entry, wrapper)))
    for d, entry, wrapper in (
            (16, 'skytpu_flash_attention_fwd_small',
             torch_fa.flash_attention_fwd_small),
            (32, 'skytpu_flash_attention_fwd_small',
             torch_fa.flash_attention_fwd_small),
            (64, 'skytpu_flash_attention_fwd', torch_fa.flash_attention_fwd),
            (128, 'skytpu_flash_attention_fwd',
             torch_fa.flash_attention_fwd)):
        q, k, v = (t.to(torch.bfloat16)
                   for t in _t(*_qkv(b=2, h=4, s=16, d=d, hkv=2)))
        torch_fa.flash_attention_fwd(q, k, v)
        assert calls.pop() == (entry, wrapper), d
    for d in (48, 8, 256):
        q, k, v = (t.to(torch.bfloat16)
                   for t in _t(*_qkv(b=2, h=4, s=16, d=d, hkv=2)))
        with pytest.raises(ValueError, match='head_dim 16, 32, 64, 128'):
            torch_fa.flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match='head_dim 16, 32'):
            torch_fa.flash_attention_fwd_small(q, k, v)
    assert not calls
    lse = torch.zeros(2, 4, 16)
    for d, suffix, (dq_wrapper, dkv_wrapper) in (
            (16, '_small', (torch_fa.flash_attention_bwd_dq_small,
                            torch_fa.flash_attention_bwd_dkv_small)),
            (32, '_small', (torch_fa.flash_attention_bwd_dq_small,
                            torch_fa.flash_attention_bwd_dkv_small)),
            (64, '', (torch_fa.flash_attention_bwd_dq,
                      torch_fa.flash_attention_bwd_dkv)),
            (128, '', (torch_fa.flash_attention_bwd_dq,
                       torch_fa.flash_attention_bwd_dkv))):
        q, k, v = (t.to(torch.bfloat16)
                   for t in _t(*_qkv(b=2, h=4, s=16, d=d, hkv=2)))
        torch_fa.flash_attention_bwd_dq(q, k, v, q, lse, lse)
        torch_fa.flash_attention_bwd_dkv(q, k, v, q, lse, lse)
        assert calls == [
            (f'skytpu_flash_attention_bwd_dq{suffix}', dq_wrapper),
            (f'skytpu_flash_attention_bwd_dkv{suffix}', dkv_wrapper)], d
        calls.clear()
    for d in (48, 8, 256):
        q, k, v = (t.to(torch.bfloat16)
                   for t in _t(*_qkv(b=2, h=4, s=16, d=d, hkv=2)))
        for fn in (torch_fa.flash_attention_bwd_dq,
                   torch_fa.flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match='head_dim 16, 32, 64, 128'):
                fn(q, k, v, q, lse, lse)
        for fn in (torch_fa.flash_attention_bwd_dq_small,
                   torch_fa.flash_attention_bwd_dkv_small):
            with pytest.raises(ValueError, match='head_dim 16, 32'):
                fn(q, k, v, q, lse, lse)
    assert not calls
    for kernel in ('fwd', 'bwd_dq', 'bwd_dkv'):
        assert torch_fa._SIGNATURES[f'skytpu_flash_attention_{kernel}_small'] \
            == torch_fa._SIGNATURES[f'skytpu_flash_attention_{kernel}']
        assert (torch_fa.CSRC_DIR / f'flash_attention_{kernel}_small.cu') in (
            torch_fa.sources())


def test_flash_fwd_block_contract_and_devices():
    q, k, v = _qkv(b=1, h=2, s=600, d=64)
    with pytest.raises(ValueError, match='must divide block size'):
        jax_fa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), interpret=True)
    with pytest.raises(ValueError, match='must divide block size'):
        torch_fa.flash_attention_fwd(*_t(q, k, v))
    # S < block: the block shrinks to S, as in the Pallas wrapper.
    q, k, v = _qkv(b=1, h=2, s=48, d=64)
    out = torch_fa.flash_attention_fwd(*_t(q, k, v))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_attn.mha_reference(q, k, v)),
        atol=FLASH_ATOL, rtol=0)
    # Neither CPU nor CUDA: refused, never computed on the side.
    with pytest.raises(ValueError, match='CPU or CUDA'):
        torch_fa.flash_attention_fwd(*[t.to('meta') for t in _t(q, k, v)])


@pytest.mark.parametrize('causal,hkv', [(True, None), (False, None),
                                        (True, 2)])
def test_flash_bwd_plain_matches_pallas_interpret(causal, hkv):
    """The JAX backward's own shapes and tolerance (tests/test_ops.py):
    (1, 2, 256, 64) causal and not, GQA (1, 4 -> 2, 256, 64)."""
    h = 4 if hkv else 2
    q, k, v = _qkv(b=1, h=h, s=256, d=64, hkv=hkv, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    out, lse = jax_fa.flash_attention_fwd(q, k, v, causal=causal,
                                          block_size=128, interpret=True,
                                          return_residuals=True)
    want = jax_fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                      block_size=128, interpret=True)
    before = (torch_fa.flash_attention_bwd_dq.launches,
              torch_fa.flash_attention_bwd_dkv.launches)
    got = torch_fa.flash_attention_bwd(
        *_t(q, k, v, np.asarray(out), np.asarray(lse), g), causal=causal,
        block_size=128)
    assert (torch_fa.flash_attention_bwd_dq.launches,
            torch_fa.flash_attention_bwd_dkv.launches) == before
    for name, x, ref in zip(('dq', 'dk', 'dv'), got, want):
        assert x.shape == ref.shape and x.dtype == torch.float32, name
        np.testing.assert_allclose(x.numpy(), np.asarray(ref),
                                   atol=FLASH_ATOL, rtol=0, err_msg=name)


# The `tiny` configs train at head_dim 16: the backward's small kernels'
# plain versions (what CPU tensors take, through both the public wrappers
# and the small ones) against the Pallas backward in interpret mode, GQA
# 4 -> 2.  Each S with both head dims, each head dim causal and not.
@pytest.mark.parametrize('s,d,causal', [
    (8, 16, True), (8, 32, False), (16, 16, False), (16, 32, True),
    (64, 16, True), (64, 32, False), (128, 16, False), (128, 32, True)])
def test_flash_bwd_small_head_dims_plain_match_pallas_interpret(s, d,
                                                                causal):
    q, k, v = _qkv(b=2, h=4, s=s, d=d, hkv=2, seed=6)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    # Both backwards take the same residuals (the forward's parity is
    # test_flash_fwd_small_head_dims_plain_match_pallas_interpret's).
    out, lse = (x.numpy() for x in torch_fa.flash_attention_fwd_reference(
        *_t(q, k, v), causal=causal, return_residuals=True))
    want = jax_fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                      interpret=True)
    args = _t(q, k, v, g, lse)
    names = ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
             'flash_attention_bwd_dq_small', 'flash_attention_bwd_dkv_small')
    before = [getattr(torch_fa, name).launches for name in names]
    got = torch_fa.flash_attention_bwd(*_t(q, k, v, out, lse, g),
                                       causal=causal)
    delta = torch_fa._delta(torch.from_numpy(out), args[3])
    small = (torch_fa.flash_attention_bwd_dq_small(*args, delta, causal),
             *torch_fa.flash_attention_bwd_dkv_small(*args, delta, causal))
    assert [getattr(torch_fa, name).launches for name in names] == before
    for name, x, y, ref in zip(('dq', 'dk', 'dv'), got, small, want):
        assert x.shape == ref.shape and x.dtype == torch.float32, name
        np.testing.assert_allclose(x.numpy(), np.asarray(ref),
                                   atol=FLASH_ATOL, rtol=0, err_msg=name)
        torch.testing.assert_close(y, x, atol=0, rtol=0, msg=name)


def test_flash_bwd_contract():
    q, k, v = _t(*_qkv(b=1, h=2, s=600, d=64))
    lse = torch.zeros(1, 2, 600)
    with pytest.raises(ValueError, match='must divide block size'):
        torch_fa.flash_attention_bwd(q, k, v, q, lse, q)
    q, k, v = _t(*_qkv(b=1, h=2, s=64, d=64))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        torch_fa.flash_attention_bwd(
            *[t.to('meta') for t in (q, k, v, q, lse, q)])


# Autograd through the op vs autograd through mha_reference, both f32:
# summation order only (-1e30 vs -inf masking changes nothing visible).
GRAD_ATOL = 1e-4


@pytest.mark.parametrize('causal,hkv,s', [(True, None, 64), (False, None, 64),
                                          (True, 2, 96)])
def test_flash_attention_autograd_matches_mha_reference(causal, hkv, s):
    q, k, v = _qkv(b=2, h=4, s=s, d=32, hkv=hkv, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape).astype(np.float32))
    results = []
    for fn in (torch_attn.flash_attention, torch_attn.mha_reference):
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        out = fn(*leaves, causal=causal)
        results.append((out.detach(), *torch.autograd.grad(out, leaves, g)))
    for name, got, want in zip(('out', 'dq', 'dk', 'dv'), *results):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0,
                                   msg=name)
    # Without an input that needs a gradient, nothing is saved or built.
    with torch.no_grad():
        assert torch_attn.flash_attention(*_t(q, k, v)).grad_fn is None


def test_library_name_covers_headers(tmp_path):
    """The kernel library's name digests every source and shared header:
    an edited header (or source) gives a new name, so a stale build is
    never loaded; nvcc still compiles only the sources."""
    src = tmp_path / 'kernel.cu'
    header = tmp_path / 'common.cuh'
    src.write_text('#include "common.cuh"\n')
    header.write_text('// v1\n')
    first = torch_fa.library_name(tmp_path)
    assert first == torch_fa.library_name(tmp_path)
    header.write_text('// v2\n')
    second = torch_fa.library_name(tmp_path)
    assert second != first
    src.write_text('#include "common.cuh"\n// edited\n')
    assert torch_fa.library_name(tmp_path) not in (first, second)
    assert (torch_fa.CSRC_DIR / 'sm90_common.cuh').exists()
    assert torch_fa.sources() and all(p.suffix == '.cu'
                                      for p in torch_fa.sources())


_C_KINDS = {ctypes.c_void_p: 'pointer', ctypes.c_int: 'int',
            ctypes.c_float: 'float'}


def _c_kind(param: str) -> str:
    if '*' in param:
        return 'pointer'
    return {'int': 'int', 'float': 'float'}[param.split()[-2]]


def test_c_entry_points_match_ctypes_signatures():
    """Every `extern "C" int skytpu_...(` in csrc/ has the parameter count
    and pointer/int/float kinds its ctypes argtypes declare: a mistyped
    pointer would be cut to 32 bits without a word."""
    declared = {}
    for src in torch_fa.sources():
        for name, params in re.findall(
                r'extern "C" int (skytpu_\w+)\(([^)]*)\)', src.read_text()):
            assert name not in declared, name
            declared[name] = [_c_kind(p) for p in params.split(',')]
    assert set(declared) == set(torch_fa._SIGNATURES)
    for name, argtypes in torch_fa._SIGNATURES.items():
        assert declared[name] == [_C_KINDS[a] for a in argtypes], name


def test_jax_stays_on_cpu():
    assert jax.default_backend() == 'cpu'
