"""GPU-only checks of the PyTorch port: the hand-written flash-forward
kernel against its plain version, and the engine's kernel path against
attention_impl='xla', on the card.  Marked `gpu`; each test asks the
`cuda` fixture, which skips when there is no CUDA device.  No JAX here,
so the file runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""
import dataclasses

import pytest
import torch

from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models.llama import LlamaConfig, Llama, init_params
from skypilot_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.gpu

# bf16 kernel vs f32 plain version on the same inputs: P and the output
# are rounded to bf16 in the kernel; one bf16 ulp is 2^-7 of a value.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', torch.cuda.current_device())


@pytest.mark.parametrize('b,hq,hkv,s,d,causal,dtype', [
    (2, 32, 32, 256, 128, True, torch.bfloat16),
    (1, 8, 8, 32, 128, True, torch.bfloat16),
    (2, 12, 4, 128, 128, True, torch.bfloat16),
    (2, 32, 8, 96, 64, True, torch.float16),
    (1, 4, 4, 512, 64, False, torch.bfloat16),
])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, s, d, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_residuals=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal,
                                                    return_residuals=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_ATOL,
                               rtol=OUT_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


def test_flash_kernel_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((1, 2, 64, 80), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 64, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match='bf16/fp16'):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16,
                    device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention_fwd(q, q, q)


def test_engine_on_gpu_goes_through_kernel(cuda):
    """A narrow llama2-shaped model (MHA, head_dim 128, bf16) served on
    the card: every prefill group launches the kernel once per layer, and
    prefill logits through the kernel match attention_impl='xla' on the
    same weights within bf16 noise (relative to the logits' scale)."""
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=2, ffn_dim=688, rope_theta=10000.0,
                      max_seq_len=128, dtype=torch.bfloat16)
    params = init_params(cfg, cuda,
                         torch.Generator(device=cuda).manual_seed(0))
    model = Llama(cfg, params)
    engine = DecodeEngine(model, EngineConfig(
        n_slots=4, prefill_buckets=(16, 32), steps_per_call=4), device=cuda)
    before = fa.flash_attention_fwd.launches
    reqs = [engine.submit(p, 8)
            for p in ([1, 5, 9, 200, 7], list(range(40, 70)), [3] * 12)]
    for _ in range(100):
        engine.step()
        if all(r.finished_at is not None for r in reqs):
            break
    assert [len(r.tokens()) for r in reqs] == [8, 8, 8]
    assert (fa.flash_attention_fwd.launches - before ==
            cfg.n_layers * engine.prefill_groups)
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        got, _ = model(toks, decode=True)
        want, _ = xla(toks, decode=True)
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()
