"""Port attention ops against the JAX package's: `mha_reference`, and the
flash kernels' plain versions (what CPU tensors take, forward and
backward) against the Pallas kernels in interpret mode, and the autograd
op against autograd through `mha_reference`.  Inputs come from a seeded numpy generator and
go to both frameworks as numpy; JAX stays on the CPU."""
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


def test_jax_stays_on_cpu():
    assert jax.default_backend() == 'cpu'
