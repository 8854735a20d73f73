"""Port attention ops against the JAX package's: `mha_reference` and the
flash forward's plain version (what CPU tensors take) against the Pallas
kernel in interpret mode.  Inputs come from a seeded numpy generator and
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


def test_flash_attention_refuses_grad():
    q, k, v = _t(*_qkv(b=1, h=2, s=32, d=64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        torch_attn.flash_attention(q, k, v)
    with torch.no_grad():
        assert torch_attn.flash_attention(q, k, v).shape == q.shape


def test_jax_stays_on_cpu():
    assert jax.default_backend() == 'cpu'
