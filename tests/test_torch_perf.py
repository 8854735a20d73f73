"""The port's perf plane (skypilot_tpu_torch/perf/), against the JAX
package's (mirrors tests/test_perf.py apart from its sharded-engine and
regression-gate cases):

- the cost model's hand arithmetic, and the port engine's
  `EngineCostModel` equal field for field (the device kind aside) to the
  JAX engine's for the same `tiny` config and converted weights: dense,
  paged bf16, paged int8 and tied embeddings;
- live MFU / bytes-per-token gauges within 5% of the cost model with
  one `.cpu()` per active step and no build after the sentinel is armed;
- build telemetry and the recompile sentinel: counted builds of the
  decode / verify call objects and of the kernel library, strict (raises
  inside the building call, before it builds) and record-only;
- `ProfileStore` retention, owned-tmpdir cleanup, busy -> CaptureBusy;
- `/debug/profile` and its artifact route through the port's
  `build_app` (200, 400, 404, 409, the artifact fetched, cleanup at
  shutdown), and the JAX package's LoadBalancer federating it.
"""
import dataclasses
import gzip
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.perf import cost_model as jax_cost_model
from skypilot_tpu_torch.inference import engine as torch_engine
from skypilot_tpu_torch.inference import server as torch_server
from skypilot_tpu_torch.ops.cuda import flash_attention as fa
from skypilot_tpu_torch.perf import compile_telemetry
from skypilot_tpu_torch.perf import cost_model as cost_model_lib
from skypilot_tpu_torch.perf import profiler as profiler_lib
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

from test_perf import _free_port, _get_json, _run_app_on_thread
from test_torch_paged import (CFG_J, CFG_T, CountingFetch, ENGINE_KW,
                              counter, jax_params, prompt_of, run,
                              torch_model)

torch.set_num_threads(1)
REQ_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _reset():
    metrics_lib.reset_for_tests()
    tracing.reset_for_tests()
    compile_telemetry.reset_for_tests()
    yield
    metrics_lib.reset_for_tests()
    tracing.reset_for_tests()
    compile_telemetry.reset_for_tests()


@pytest.fixture(scope='module')
def ref():
    """(JAX model, params, port model) on the f32 `tiny` config."""
    model_j, params_j = jax_params()
    return model_j, params_j, torch_model(params_j)


def _gauge(name):
    for line in metrics_lib.render().splitlines():
        if line.split(' ')[0] == name:
            return float(line.rsplit(' ', 1)[1])
    return None


def _tokens(req):
    """Request.tokens() in a thread, bounded: it blocks until the engine
    finishes the request."""
    out = []
    th = threading.Thread(target=lambda: out.append(req.tokens()),
                          daemon=True)
    th.start()
    th.join(REQ_TIMEOUT_S)
    assert not th.is_alive(), 'request did not finish'
    return out[0]


def make_engine(model, **kw):
    return torch_engine.DecodeEngine(model, torch_engine.EngineConfig(**kw),
                                     device='cpu')


# ----- cost model (pure arithmetic) -------------------------------------------
def test_cost_model_hand_arithmetic():
    cm = cost_model_lib.EngineCostModel(
        n_params=100, n_layers=2, dim=8, n_kv_heads=2, head_dim=4,
        param_bytes=400, kv_dtype_bytes=2, n_chips=1, chip='h100')
    assert cm.decode_flops_per_token(10) == 2 * 100 + 2 * 2 * 10 * 8
    # K+V, per layer, per kv head, per head_dim element, 2 bytes each.
    assert cm.kv_bytes_per_pos() == 2 * 2 * 2 * 4 * 2
    # weights amortized over the batch + kv history read + 1-pos write.
    assert cm.decode_hbm_bytes_per_token(10, n_active=4) == \
        400 / 4 + cm.kv_bytes_per_pos() * 10 + cm.kv_bytes_per_pos()
    assert cm.arith_intensity(10, 4) == pytest.approx(
        cm.decode_flops_per_token(10) /
        cm.decode_hbm_bytes_per_token(10, 4))
    # Roofline: min of compute-bound and bandwidth-bound token rates at
    # the H100's 989 TFLOP/s and 3.35 TB/s.
    assert cm.roofline_decode_tokens_per_s(10, 4) == pytest.approx(min(
        989e12 / cm.decode_flops_per_token(10),
        3350e9 / cm.decode_hbm_bytes_per_token(10, 4)))
    assert cm.mfu(1e9, 10) == pytest.approx(
        100 * 1e9 * cm.decode_flops_per_token(10) / 989e12)
    assert cm.prefill_seconds(16) == pytest.approx(max(
        16 * (2 * 100 + 2 * 2 * 8 * 8) / 989e12,
        (400 + cm.kv_bytes_per_pos() * 16) / 3350e9))
    assert set(cost_model_lib.HBM_GBPS) == {'h100', 'cpu'}


def test_cost_model_kv_dtype_width_halves_kv_bytes():
    wide = cost_model_lib.EngineCostModel(
        n_params=100, n_layers=2, dim=8, n_kv_heads=2, head_dim=4,
        param_bytes=400, kv_dtype_bytes=2)
    narrow = dataclasses.replace(wide, kv_dtype_bytes=1)
    assert narrow.kv_bytes_per_pos() == wide.kv_bytes_per_pos() / 2


def test_cost_model_counts_a_tied_tensor_once():
    """A tensor listed twice (a tied embedding under two state-dict names,
    or the same tensor passed again) is one tensor in memory; distinct
    tensors, views of other parts of a storage included, all count."""
    cfg = dataclasses.replace(CFG_T, tie_embeddings=True)
    w = torch.zeros((cfg.vocab_size, cfg.dim))
    other = torch.zeros((cfg.dim,))
    tied = {'embed.weight': w, 'lm_head.weight': w, 'norm': other}
    cm = cost_model_lib.EngineCostModel.from_engine_state(
        cfg, list(tied.values()) + [w.view(w.shape)], [], kv_dtype='bf16')
    assert cm.param_bytes == (w.numel() + other.numel()) * 4
    halves = cost_model_lib.EngineCostModel.from_engine_state(
        cfg, [w[:10], w[10:]], [], kv_dtype='bf16')
    assert halves.param_bytes == w.numel() * 4


@pytest.mark.parametrize('overrides', [
    {}, dict(ENGINE_KW), dict(ENGINE_KW, kv_dtype='int8'), 'tied'],
    ids=['dense', 'paged_bf16', 'paged_int8', 'tied'])
def test_cost_model_equals_jax_engines(ref, overrides):
    """Field for field (the device kind aside) the JAX engine's
    perf_cost_model for the same config and converted weights: the
    weight bytes, the declared KV width (never the first leaf's: an int8
    pool's scales are f32), the scale overhead."""
    model_j, params_j, model = ref
    if overrides == 'tied':
        cfg_j = dataclasses.replace(CFG_J, tie_embeddings=True)
        model_j, params_j = jax_params(cfg_j)
        model = torch_model(params_j,
                            dataclasses.replace(CFG_T, tie_embeddings=True))
        overrides = {}
    kw = dict(dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3),
              **overrides)
    want = jax_engine.DecodeEngine(
        model_j, params_j, jax_engine.EngineConfig(**kw)).perf_cost_model
    got = make_engine(model, **kw).perf_cost_model
    assert isinstance(want, jax_cost_model.EngineCostModel)
    assert dataclasses.replace(got, chip='') == dataclasses.replace(
        cost_model_lib.EngineCostModel(**dataclasses.asdict(want)),
        chip='')
    assert got.chip == 'cpu'
    if kw.get('kv_dtype') == 'int8':
        assert got.kv_scale_bytes_per_pos == 2 * CFG_T.n_layers * \
            CFG_T.n_kv_heads * 4


# ----- live attribution: zero added syncs, zero builds ------------------------
def test_live_gauges_agree_with_cost_model_zero_syncs(ref, monkeypatch):
    """/metrics-exported MFU and bytes/token agree with the cost model
    evaluated at the measured rate within 5%, and the attribution adds no
    device sync (one `.cpu()` per active step, no `.item()`/`.tolist()`)
    and no build while the sentinel is armed."""
    _, _, model = ref
    engine = make_engine(model, n_slots=2, steps_per_call=4,
                         prefill_buckets=(8,))
    prompt_len, new_tokens = 8, 8
    prompts = [prompt_of(prompt_len, 80 + i) for i in range(6)]
    run(engine, [engine.submit([1, 2, 3], 2)])   # builds the decode call
    engine.arm_recompile_sentinel()
    builds_before = counter('skytpu_engine_xla_compile_total')

    counting = CountingFetch(monkeypatch)
    engine.perf_window_s = 1e9
    t0 = time.perf_counter()
    engine.perf_reset_window()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    active_steps = 0
    while any(r.finished_at is None for r in reqs):
        if engine.step() > 0:
            active_steps += 1
    wall = time.perf_counter() - t0
    engine.perf_window_s = 0.0
    engine.step()
    assert counting.cpu == active_steps and counting.hidden == 0
    assert counter('skytpu_engine_xla_compile_total') == builds_before
    assert not tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)

    rate = sum(r.emitted for r in reqs) / wall
    cm = engine.perf_cost_model
    mean_ctx = prompt_len + new_tokens / 2.0
    mfu_live = _gauge('skytpu_engine_mfu')
    bytes_live = _gauge('skytpu_engine_hbm_bytes_per_token')
    intensity_live = _gauge('skytpu_engine_arith_intensity')
    assert mfu_live and bytes_live and intensity_live
    assert mfu_live == pytest.approx(cm.mfu(rate, mean_ctx), rel=0.05)
    assert bytes_live == pytest.approx(
        cm.decode_hbm_bytes_per_token(mean_ctx, n_active=2), rel=0.05)
    assert intensity_live == pytest.approx(
        cm.arith_intensity(mean_ctx, 2), rel=0.05)
    snap = engine.perf_snapshot()
    assert snap['mfu'] == mfu_live and snap['mean_occupancy'] == 2.0
    assert snap['mean_context'] == pytest.approx(mean_ctx + 0.5)
    # An idle window zeroes the utilization, keeps the modeled bytes.
    engine.step()
    assert _gauge('skytpu_engine_mfu') == 0.0
    assert _gauge('skytpu_engine_hbm_bytes_per_token') == bytes_live


# ----- build telemetry + recompile sentinel -----------------------------------
@pytest.mark.parametrize('spec', [0, 4], ids=['decode', 'verify'])
def test_call_builds_are_counted_and_prewarm_does_not_arm_on_cpu(ref, spec):
    _, _, model = ref
    engine = make_engine(model, **dict(ENGINE_KW, speculation=spec))
    engine.prewarm()
    kind = 'verify' if spec else 'decode'
    builds, seconds = compile_telemetry.summary()[kind]
    assert builds == 1 and seconds > 0
    assert counter('skytpu_engine_xla_compile_total') == 1
    assert counter('skytpu_engine_xla_compile_seconds_count') == 1
    # Built, not captured, on the CPU: nothing armed.
    assert not compile_telemetry.armed()
    req = engine.submit(prompt_of(9, 90), 6)
    run(engine, [req])
    assert counter('skytpu_engine_xla_compile_total') == 1


def test_strict_sentinel_raises_inside_the_building_call(ref, monkeypatch):
    """Armed + SKYTPU_STRICT_RECOMPILE=1: a call object built after
    warmup raises INSIDE its construction, before it builds anything,
    and leaves a perf.recompile event with its shape string under the
    sentinel's request id; the engine keeps no half-built call."""
    _, _, model = ref
    engine = make_engine(model, **dict(ENGINE_KW, speculation=3))
    compile_telemetry.install()          # nothing to register: a no-op
    engine.arm_recompile_sentinel()
    monkeypatch.setenv(compile_telemetry.STRICT_ENV, '1')
    req = engine.submit(prompt_of(9, 91), 4)
    with pytest.raises(RuntimeError, match='post-warmup verify build'):
        engine.step()
    assert engine._verify_call is None
    assert counter('skytpu_engine_xla_compile_total') == 0
    events = tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
    assert [e['name'] for e in events] == ['perf.recompile']
    assert 'verify out=[6, 2] k=3 paged=True kv=bf16' in \
        events[0]['attrs']['shapes']
    del req


def test_sentinel_record_only_and_prewarm_is_warmup(ref, monkeypatch):
    """Record-only: a late build is counted and recorded, not refused.
    A build inside prewarm() is warmup even with the sentinel armed (one
    engine's prewarm does not trip what another armed)."""
    _, _, model = ref
    monkeypatch.delenv(compile_telemetry.STRICT_ENV, raising=False)
    compile_telemetry.arm()
    make_engine(model, n_slots=2, prefill_buckets=(8,)).prewarm()
    assert not tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
    late = make_engine(model, n_slots=2, prefill_buckets=(8,))
    run(late, [late.submit([1, 2, 3], 3)])     # builds its call lazily
    events = tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
    assert [e['name'] for e in events] == ['perf.recompile']
    assert events[0]['attrs']['kind'] == 'decode'
    assert 'out=[9, 2]' in events[0]['attrs']['shapes']
    assert compile_telemetry.summary()['decode'][0] == 2
    compile_telemetry.disarm()
    assert not compile_telemetry.armed()


def test_kernel_library_build_is_a_counted_build(tmp_path, monkeypatch):
    """The nvcc build of the kernel library is the other build site:
    counted when it runs, refused before nvcc under the strict sentinel,
    and not counted when the library is only loaded."""
    class _Lib:
        def __getattr__(self, name):
            return type('Fn', (), {})()

    monkeypatch.setattr(fa, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(fa.ctypes, 'CDLL', lambda path: _Lib())
    built = []

    def fake_nvcc(self, srcs, tmp, out):
        built.append(out)
        out.write_bytes(b'')
        return 'ptxas info'

    monkeypatch.setattr(fa._Library, '_compile_and_link', fake_nvcc)
    compile_telemetry.arm()
    monkeypatch.setenv(compile_telemetry.STRICT_ENV, '1')
    with pytest.raises(RuntimeError, match='post-warmup kernel_build'):
        fa._Library().get()
    assert not built
    monkeypatch.delenv(compile_telemetry.STRICT_ENV)
    assert fa._Library().get() is not None
    assert len(built) == 1
    assert compile_telemetry.summary()['kernel_build'][0] == 1
    events = tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
    assert [e['attrs']['kind'] for e in events] == ['kernel_build'] * 2
    fa._Library().get()                  # on disk now: loaded, not built
    assert compile_telemetry.summary()['kernel_build'][0] == 1


# ----- profiler capture + retention -------------------------------------------
def _trace_events(store, rel):
    with gzip.open(store.artifact_path(rel)) as f:
        return json.load(f)['traceEvents']


def test_profile_store_capture_retention_prune(tmp_path):
    store = profiler_lib.ProfileStore(root=str(tmp_path / 'prof'),
                                      retain=2)
    summaries = [store.capture(10.0) for _ in range(3)]
    assert all(s['artifact'].endswith('/perfetto_trace.json.gz')
               for s in summaries), summaries
    assert store.captures() == ['capture-000002', 'capture-000003']
    assert summaries[-1]['retained'] == store.captures()
    art = store.artifact_path(summaries[-1]['artifact'])
    assert art.is_file() and art.stat().st_size == \
        summaries[-1]['size_bytes'] > 0
    assert isinstance(_trace_events(store, summaries[-1]['artifact']), list)
    assert counter('skytpu_profile_captures_total') == 3
    with pytest.raises(ValueError, match='escapes'):
        store.artifact_path('../outside')
    with pytest.raises(FileNotFoundError):
        store.artifact_path('capture-000001/nope.gz')
    # User-supplied root: cleanup removes our captures, keeps the dir.
    store.cleanup()
    assert store.captures() == []
    assert store.root.is_dir()


def test_profile_store_owned_tmpdir_removed_on_cleanup(monkeypatch):
    monkeypatch.delenv(profiler_lib.DIR_ENV, raising=False)
    store = profiler_lib.ProfileStore()
    store.capture(5.0)
    root = store.root
    assert root.is_dir()
    store.cleanup()
    assert not root.exists()


def test_profile_capture_busy_and_span(tmp_path):
    """The profiler is process-global: while TRACE_LOCK is held (another
    capture, or a CUDA graph capture) a capture is refused; a capture
    records its perf.profile_capture span under the request id."""
    store = profiler_lib.ProfileStore(root=str(tmp_path), retain=1)
    with profiler_lib.TRACE_LOCK:
        with pytest.raises(profiler_lib.CaptureBusy):
            store.capture(5.0)
    with pytest.raises(ValueError, match='positive'):
        store.capture(0)
    summary = store.capture(5.0, request_id='rid-1')
    spans = tracing.events_for('rid-1')
    assert [e['name'] for e in spans] == ['perf.profile_capture']
    assert spans[0]['attrs']['artifact'] == summary['artifact']


def test_capture_records_the_engine_loop_threads_operators(ref, tmp_path):
    """The window runs on its own thread while the engine's loop thread
    computes: the trace holds the loop thread's operators (the model's
    embedding lookup runs nowhere else)."""
    _, _, model = ref
    store = profiler_lib.ProfileStore(root=str(tmp_path))
    engine = make_engine(model, n_slots=2, prefill_buckets=(8,))
    engine.start()
    summary = {}
    try:
        th = threading.Thread(
            target=lambda: summary.update(store.capture(400.0)))
        th.start()
        time.sleep(0.05)
        reqs = [engine.submit(prompt_of(6, 93 + i), 6) for i in range(2)]
        assert [len(_tokens(r)) for r in reqs] == [6, 6]
        th.join(REQ_TIMEOUT_S)
        assert not th.is_alive()
    finally:
        engine.stop()
    names = {e.get('name') for e in _trace_events(store,
                                                   summary['artifact'])}
    assert 'aten::embedding' in names


# ----- server routes + LB federation ------------------------------------------
def test_debug_profile_routes_and_shutdown_cleanup(ref, monkeypatch):
    monkeypatch.delenv(profiler_lib.DIR_ENV, raising=False)
    _, _, model = ref
    engine = make_engine(model, n_slots=2, prefill_buckets=(8,))
    app = torch_server.build_app(engine, role='decode')
    store = app['skytpu_profile_store']
    port, stop = _run_app_on_thread(app)
    base = f'http://127.0.0.1:{port}'
    try:
        status, doc = _get_json(base + '/debug/profile?duration_ms=20')
        assert status == 200 and doc['role'] == 'decode'
        assert doc['artifact'] and doc['size_bytes'] > 0
        assert doc['name'] in doc['retained']
        with urllib.request.urlopen(
                f'{base}/debug/profile/artifact/{doc["artifact"]}',
                timeout=10) as resp:
            assert resp.status == 200
            body = resp.read()
        assert len(body) == doc['size_bytes']
        assert 'traceEvents' in json.loads(gzip.decompress(body))
        for query in ('banana', '0', '-5', 'nan'):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get_json(f'{base}/debug/profile?duration_ms={query}')
            assert err.value.code == 400, query
        for tail in ('..%2Fescape', 'capture-000001/missing.json.gz'):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get_json(f'{base}/debug/profile/artifact/{tail}')
            assert err.value.code == 404, tail
        with profiler_lib.TRACE_LOCK:     # a capture already holds it
            with pytest.raises(urllib.error.HTTPError) as err:
                _get_json(base + '/debug/profile?duration_ms=20')
        assert err.value.code == 409
        root = store.root
        assert root.is_dir()
    finally:
        stop()
    assert not root.exists()


def test_jax_lb_federates_the_ports_debug_profile(ref):
    """The JAX package's (JAX-free) LoadBalancer in front of the port's
    app: its federated /debug/profile reaches the port replica."""
    from skypilot_tpu.serve.load_balancer import LoadBalancer
    from skypilot_tpu.serve.load_balancing_policies import RoundRobinPolicy
    _, _, model = ref
    engine = make_engine(model, n_slots=2, prefill_buckets=(8,))
    engine.start()
    port, stop_replica = _run_app_on_thread(torch_server.build_app(engine))
    replica_url = f'http://127.0.0.1:{port}'
    lb = LoadBalancer(
        'perf-svc', _free_port(), RoundRobinPolicy(),
        ready_urls_fn=lambda: [replica_url],
        ready_replicas_fn=lambda: [(3, replica_url)])
    lb.start()
    try:
        req = engine.submit(prompt_of(6, 92), 4)
        status, doc = _get_json(
            lb.endpoint + '/debug/profile?duration_ms=20')
        assert status == 200
        assert doc['service'] == 'perf-svc'
        caps = doc['captures']
        assert len(caps) == 1 and caps[0]['replica'] == '3'
        assert caps[0]['ok'] and caps[0]['artifact']
        assert len(_tokens(req)) == 4
    finally:
        lb.stop()
        stop_replica()
        engine.stop()
