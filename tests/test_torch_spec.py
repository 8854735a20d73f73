"""Speculative decoding + int8 KV pages of the port's engine, against the
JAX engine (mirrors tests/test_serve_spec.py).

Parity contract: greedy speculation is lossless, so the port's spec-on
engine (k = 1 and 4) emits the JAX engine's stream exactly, through
chunked prompts, int8 pages, prefix-cache hits and multi-turn replays
(f32 `tiny`, weights converted from the Flax tree).  `quantize_kv` is
bit-identical to the JAX function on the same f32 input, its error is at
most half a step, and re-quantizing its output is exact.  One `.cpu()`
per step holds with speculation on (the acceptance counts ride the same
fetch as the tokens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.inference import kv_quant as jax_quant
from skypilot_tpu_torch.inference import engine as torch_engine
from skypilot_tpu_torch.inference import kv_quant
from skypilot_tpu_torch.server import metrics as metrics_lib

from test_torch_paged import (CountingFetch, ENGINE_KW, counter,
                              jax_params, prompt_of, run, torch_model)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def ref():
    """(JAX model, params, port model, JAX stream fn over one shared JAX
    engine per config)."""
    model_j, params_j = jax_params()
    engines = {}

    def jax_streams(prompts, n_new, **overrides):
        key = tuple(sorted(overrides.items()))
        if key not in engines:
            engines[key] = jax_engine.DecodeEngine(
                model_j, params_j,
                jax_engine.EngineConfig(**dict(ENGINE_KW, **overrides)))
        eng = engines[key]
        outs = []
        for p in prompts:       # one at a time: a multi-turn transcript
            req = eng.submit(list(p), n_new)
            while req.finished_at is None:
                eng.step()
            outs.append(req.tokens())
        return outs

    return model_j, params_j, torch_model(params_j), jax_streams


@pytest.fixture(autouse=True)
def _reset_metrics():
    metrics_lib.reset_for_tests()
    yield
    metrics_lib.reset_for_tests()


def make_engine(model, **overrides):
    return torch_engine.DecodeEngine(
        model, torch_engine.EngineConfig(**dict(ENGINE_KW, **overrides)),
        device='cpu')


def serve_each(engine, prompts, n_new):
    return [run(engine, [engine.submit(p, n_new)])[0] for p in prompts]


# ----- the n-gram proposer ----------------------------------------------------
def test_ngram_continuation_equals_jax():
    """The proposer is a verbatim copy: same drafts as the JAX function
    on seeded random histories (no repeats to find, then short
    alphabets that repeat often) and on cyclic ones."""
    rng = np.random.default_rng(0)
    hists = [rng.integers(0, vocab, n).tolist()
             for vocab in (256, 8, 3) for n in (0, 1, 2, 5, 17, 60, 700)]
    hists += [[1, 2, 3] * 4, [5, 9, 34, 34, 34], [4] * 9,
              [9, 8, 7, 1, 2, 3, 4, 5, 6, 9, 8, 7]]
    for hist in hists:
        for k in (1, 3, 4):
            assert (torch_engine._ngram_continuation(hist, k).tolist() ==
                    jax_engine._ngram_continuation(hist, k).tolist()), hist
    assert torch_engine._ngram_continuation([1, 2, 3] * 4, 5).tolist() == [
        1, 2, 3, 1, 2]


# ----- greedy parity with JAX ---------------------------------------------------
@pytest.mark.parametrize('k', [1, 4])
@pytest.mark.parametrize('plen', [7, 16, 40])
def test_spec_parity_with_jax(ref, plen, k):
    """Partial-page, page-aligned and CHUNKED prompts: the port's spec-on
    engine emits the JAX spec-on engine's stream, which is the spec-off
    stream."""
    _, _, model, jax_streams = ref
    prompt = prompt_of(plen, 40 + plen)
    spec = make_engine(model, speculation=k)
    got = serve_each(spec, [prompt], 12)
    assert got == jax_streams([prompt], 12, speculation=k)
    assert got == jax_streams([prompt], 12)


@pytest.mark.parametrize('k', [0, 3])
def test_spec_parity_int8_with_jax(ref, k):
    """int8 pages with and without speculation: token-identical to the
    JAX int8 engine (both quantize the same rows the same way)."""
    _, _, model, jax_streams = ref
    prompts = [prompt_of(13, 50), prompt_of(40, 51)]
    engine = make_engine(model, kv_dtype='int8', speculation=k)
    assert serve_each(engine, prompts, 12) == jax_streams(
        prompts, 12, kv_dtype='int8', speculation=k)
    assert counter('skytpu_engine_kv_quant_pages_total') > 0


def test_spec_parity_prefix_hit_and_multiturn(ref):
    """Speculation composes with the radix cache: a prefix-hit admission,
    then a multi-turn replay over the generated pages, all
    token-identical to the JAX spec-on transcript."""
    _, _, model, jax_streams = ref
    shared, tail = prompt_of(16, 60), prompt_of(4, 61)
    hit_tail, turn = prompt_of(3, 62), prompt_of(2, 63)
    engine = make_engine(model, kv_pages=40, speculation=4)
    first = serve_each(engine, [shared + tail], 8)[0]
    hit = serve_each(engine, [shared + hit_tail], 8)[0]
    replay = serve_each(engine, [shared + tail + first + turn], 8)[0]
    want = jax_streams([shared + tail, shared + hit_tail,
                        shared + tail + first + turn], 8, kv_pages=40,
                       speculation=4)
    assert [first, hit, replay] == want
    assert counter('skytpu_engine_prefix_cache_hits_total') == 2


# ----- acceptance accounting --------------------------------------------------
def test_spec_acceptance_repetitive_exceeds_random(ref):
    """Cycling greedy output (weights scaled toward zero flatten the
    logits' context dependence) accepts a large share of drafts; the
    stock random weights accept fewer.  Read from the counters the
    /metrics gauge is derived from."""
    _, params_j, model, _ = ref
    cyclic = torch_model(jax.tree.map(lambda x: x * 0.1, params_j))

    def acceptance(m):
        metrics_lib.reset_for_tests()
        engine = make_engine(m, speculation=4)
        serve_each(engine, [prompt_of(12, 70), prompt_of(12, 71)], 48)
        proposed = counter('skytpu_engine_spec_proposed_tokens_total')
        accepted = counter('skytpu_engine_spec_accepted_tokens_total')
        assert proposed > 0 and 0 <= accepted <= proposed
        assert 'skytpu_engine_spec_acceptance' in metrics_lib.render()
        return accepted / proposed

    rep, rand = acceptance(cyclic), acceptance(model)
    assert rep > 0.3, f'cycling traffic accepted only {rep:.3f}'
    assert rand < rep, (rand, rep)


def test_spec_off_engine_exports_no_spec_counters(ref):
    _, _, model, _ = ref
    engine = make_engine(model)
    serve_each(engine, [prompt_of(9, 72)], 6)
    assert counter('skytpu_engine_spec_proposed_tokens_total') == 0


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_verify_call_keeps_its_buffers(ref, kv_dtype):
    """The verify call object (the card's CUDA graph, its body on the
    CPU) reads and writes fixed buffers: `_last_d`, `_lens_d`, its draft
    buffer and output rows, the pool and the page table keep their
    storage across steps, each call hands out a clone of its rows, and
    prewarm() builds the one call the engine uses (nothing after), with
    the JAX engine's tokens."""
    _, _, model, jax_streams = ref
    engine = make_engine(model, speculation=4, kv_dtype=kv_dtype)
    engine.prewarm()
    call = engine._verify_call
    assert engine._decode_call is None and call.graph is None
    assert tuple(call.out.shape) == (4 + 3, ENGINE_KW['n_slots'])
    pool = [t for layer in engine._cache for leaf in layer
            for t in ((leaf.data, leaf.scale) if kv_dtype == 'int8'
                      else (leaf,))]
    fixed = [engine._last_d, engine._lens_d, engine._pt_device, call.out,
             call.drafts] + pool
    ptrs = [t.data_ptr() for t in fixed]
    builds = counter('skytpu_engine_xla_compile_total')
    outs = []

    def spy(eng, drafts):
        out = call(eng, drafts)
        assert out.data_ptr() != call.out.data_ptr()
        outs.append(out)
        return out

    engine._verify_call = spy
    prompts = [prompt_of(7, 75), prompt_of(30, 76)]
    got = run(engine, [engine.submit(p, 10) for p in prompts])
    assert len(outs) >= 3
    assert [t.data_ptr() for t in fixed] == ptrs
    assert counter('skytpu_engine_xla_compile_total') == builds
    assert got == jax_streams(prompts, 10, kv_dtype=kv_dtype,
                              speculation=4)


def test_spec_one_fetch_per_step(ref, monkeypatch):
    """Drafts ship host->device inside the dispatch and the acceptance
    counts ride the token fetch: one `.cpu()` per active step, no
    `.item()` / `.tolist()`."""
    _, _, model, _ = ref
    engine = make_engine(model, speculation=4, kv_dtype='int8')
    counting = CountingFetch(monkeypatch)
    active = 0
    req = engine.submit(prompt_of(9, 73), 8)
    while req.finished_at is None:
        active += engine.step() > 0
    assert req.tokens()
    assert counting.cpu == active and counting.hidden == 0


# ----- int8 quantization ------------------------------------------------------
@pytest.mark.parametrize('shape,scale', [((4, 2, 8, 16), 3.0),
                                         ((3, 8, 5, 64), 0.02),
                                         ((2, 4, 8, 128), 40.0)])
def test_quantize_kv_bit_identical_to_jax(shape, scale):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = (rng.normal(0, scale, shape)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row (scale floor)
    x[-1, -1, -1, :3] = [scale, -scale, scale / 2]   # ties near .5 steps
    q, s = kv_quant.quantize_kv(torch.from_numpy(x))
    qj, sj = jax_quant.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    dq = kv_quant.dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(
        dq.numpy(), np.asarray(jax_quant.dequantize_kv(qj, sj,
                                                       jnp.float32)))


def test_quantize_kv_error_bounded_and_idempotent():
    """Per-element error <= half a quantization step of its row, and
    re-quantizing the dequantized values is exact."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 3, (4, 2, 8, 16)).astype(np.float32))
    q, s = kv_quant.quantize_kv(x)
    dq = kv_quant.dequantize_kv(q, s, torch.float32)
    assert torch.all((x - dq).abs() <= s[..., None] * 0.5 + 1e-6)
    q2, s2 = kv_quant.quantize_kv(dq)
    assert torch.equal(q, q2)
    assert torch.allclose(s, s2, rtol=1e-6)


def test_int8_pool_pages_within_half_step(ref):
    """Right after prefill, one slot's int8 pages dequantize to the f32
    engine's pages within half a quantization step, and the int8 pool
    holds (1 + 4/head_dim)/4 of the f32 pool's bytes."""
    _, _, model, _ = ref
    prompt = prompt_of(13, 74)           # one bucket-16 prefill
    pools = {}
    for dtype in ('bf16', 'int8'):          # 'bf16': the model's dtype
        engine = make_engine(model, kv_dtype=dtype)
        engine.submit(prompt, 2)
        engine._admit_free()                # the prefill + paged insert
        pools[dtype] = (engine, torch.tensor(engine._slots[0].pages))
    (dense, rows_d), (quant, rows_q) = pools['bf16'], pools['int8']
    for (kd, vd), (kq, vq) in zip(dense._cache, quant._cache):
        for d, qp in ((kd, kq), (vd, vq)):
            want = d[rows_d]                             # [P, H, ps, D]
            got = kv_quant.dequantize_kv(qp.data[rows_q], qp.scale[rows_q],
                                         torch.float32)
            assert want.abs().sum() > 0
            assert torch.all((got - want).abs() <=
                             qp.scale[rows_q][..., None] * 0.5 + 1e-6)

    def nbytes(engine):
        return sum(t.numel() * t.element_size()
                   for t in engine._wire_leaves())

    assert nbytes(quant) / nbytes(dense) == pytest.approx(
        (1 + 4 / model.cfg.head_dim) / 4)


# ----- config validation ------------------------------------------------------
@pytest.mark.parametrize('kw', [
    dict(kv_page_size=None, kv_dtype='int8'),
    dict(kv_dtype='fp8'),
    dict(kv_page_size=None, speculation=2),
    dict(speculation=-1),
    dict(speculation=2, temperature=0.7),
], ids=['int8_unpaged', 'fp8', 'spec_unpaged', 'negative', 'sampled'])
def test_spec_config_validation_gives_jax_messages(ref, kw):
    model_j, params_j, model, _ = ref
    cfg = dict(ENGINE_KW, **kw)
    with pytest.raises(ValueError) as want:
        jax_engine.DecodeEngine(model_j, params_j,
                                jax_engine.EngineConfig(**cfg))
    with pytest.raises(ValueError) as got:
        torch_engine.DecodeEngine(model, torch_engine.EngineConfig(**cfg),
                                  device='cpu')
    assert str(got.value) == str(want.value)
