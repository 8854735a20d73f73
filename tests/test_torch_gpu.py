"""GPU-only checks of the PyTorch port: the hand-written flash-attention
kernels (forward, dq, dk/dv) against their plain versions, the autograd
op against autograd through `mha_reference`, the engine's kernel path
against attention_impl='xla', and a narrow model trained through the
kernels, on the card.  Marked `gpu`; each test asks the
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


# Backward kernels vs their plain versions (same bf16 rounding of P and
# dS, f32 sums in another order, outputs rounded to bf16): judged on the
# norm of the difference relative to the reference's norm; one bf16 ulp
# is 2^-8 relative, a wrong kernel is off by ~1.
BWD_NORM_RTOL = 1e-2


def _norm_rel(x, ref):
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize('b,hq,hkv,s,d,causal,dtype', [
    (1, 4, 2, 256, 128, True, torch.bfloat16),
    (2, 4, 4, 128, 64, True, torch.bfloat16),
    (1, 4, 2, 192, 128, False, torch.bfloat16),
    (2, 4, 2, 96, 64, True, torch.float16),
    (1, 2, 2, 32, 128, True, torch.bfloat16),
])
def test_flash_bwd_kernels_match_plain(cuda, b, hq, hkv, s, d, causal,
                                       dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, g = (torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_residuals=True)
    delta = (g.float() * out.float()).sum(-1)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                 causal)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, g, lse, delta, causal)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _norm_rel(got, ref) <= BWD_NORM_RTOL


def test_flash_attention_grads_match_mha_reference(cuda):
    """The autograd op (forward kernel, then both backward kernels) in
    bf16 against autograd through `mha_reference` on the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((2, 8, 256, 128), generator=gen, device=cuda)
    k, v = (torch.randn((2, 4, 256, 128), generator=gen, device=cuda)
            for _ in range(2))
    g = torch.randn((2, 8, 256, 128), generator=gen, device=cuda)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    from skypilot_tpu_torch.ops import attention as attn
    got = torch.autograd.grad(attn.flash_attention(*leaves),
                              leaves, g.to(torch.bfloat16))
    want = torch.autograd.grad(attn.mha_reference(*leaves), leaves,
                               g.to(torch.bfloat16))
    for x, ref in zip(got, want):
        assert _norm_rel(x, ref) <= 2 * BWD_NORM_RTOL


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


def test_narrow_model_trains_through_kernels(cuda):
    """A narrow bench-1b-shaped model (GQA, head_dim 128, tied, remat
    'none') takes 3 train steps on the card: every layer launches the
    forward kernel twice (forward and remat recompute) and each backward
    kernel once per step, and the loss is finite and falls."""
    from skypilot_tpu_torch.train import trainer as tt
    cfg = LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_dim=1024, max_seq_len=256,
                      tie_embeddings=True, dtype=torch.bfloat16)
    model = Llama(cfg, init_params(
        cfg, cuda, torch.Generator(device=cuda).manual_seed(0)))
    trainer = tt.Trainer(model, tt.TrainConfig(learning_rate=1e-2,
                                               warmup_steps=1,
                                               total_steps=50))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    losses = []
    for _ in range(3):
        trainer.state, metrics = trainer.train_step(trainer.state, tokens)
        losses.append(float(metrics['loss']))
    assert [c.launches - b for c, b in zip(counters, before)] == [
        3 * 2 * cfg.n_layers, 3 * cfg.n_layers, 3 * cfg.n_layers]
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
