"""Continuous-batching decode engine, single-device (PyTorch).

Twin of `skypilot_tpu/inference/engine.py` (mesh=None): the same host
machinery over the same device contract.

- A fixed pool of decode *slots*; every decode call runs the whole
  [n_slots] batch for `steps_per_call` steps.  On a CUDA device the call
  is ONE captured CUDA graph (`_DecodeCall`, the counterpart of the JAX
  engine's compiled `lax.scan`), captured at `prewarm()` or at the
  first decode call and replayed from then on; a capture that fails
  raises.  The graph reads and writes fixed buffers (`_last_d`,
  `_lens_d`, the cache or page pool, the device page table, its output
  rows) at the addresses it captured, so none of them is ever rebound:
  results are copied back into them.  On the CPU the same call object
  runs its body directly over the same buffers.
- ONE device->host sync per step: last tokens and lengths live on the
  device, prefill+insert samples each prompt's first token on the device,
  and the decode call returns a fresh [T+1, n_slots] tensor whose row 0 is
  each slot's previously sampled token, so a freshly admitted request's
  first token rides the same `.cpu()` as the decode tokens.
- Prompts are padded to a prefill bucket and admitted in batched groups
  (one prefill + insert per bucket, rows padded to a power of two by
  replicating row 0).  The prefill attends over the prompt through the
  flash-forward kernel (`attention_impl='flash'`).
- Prompts longer than the largest bucket stream through a per-request
  scratch cache in bucket-sized chunks, one chunk per loop iteration
  between decode calls; the final chunk samples the first token and
  copies the scratch into the request's slot.
- The cache, `last` and `lens` are updated in place: the engine owns
  them, as the JAX engine donates their buffers.  Every decode call
  returns a clone of the call's output rows, so the pipelined loop reads
  call k-1's rows after call k has overwritten the buffer.

Slot safety relies on the model cache's invariant (models/llama.py
_decode_attend): attention masks k_pos > q_pos, and inserts overwrite a
slot's whole cache, so a reused slot never leaks its previous request's
KV.

Paged KV + prefix caching (`kv_page_size`): the cache becomes a page
POOL, per layer (k, v) of [n_pages, H, page_size, D], with host-side
per-slot page tables (inference/paging.py owns the allocator and the
radix trie).  Admission charges ceil((prompt+max_new)/page) pages;
requests sharing a page-aligned token prefix reference the cached pages
(gathered into the chunked-prefill scratch, only the suffix prefills);
retire donates prompt+generated pages, so multi-turn replays hit.
Prefill keeps the dense programs (the flash kernel included) and only
the insert tail scatters rows into the pages; decode scatters and
gathers through the table inside the model (models/llama.py
_paged_attend).  Tables upload through pinned copies, only when dirty,
so paging adds no sync.  `kv_dtype='int8'` stores pages quantized
(inference/kv_quant.py); `speculation=k` drafts k tokens per slot from
its own history (`_ngram_continuation`) and verifies them in one S=k+1
call, greedy and lossless.

Disaggregated prefill/decode (`submit_prefill` / `export_result` /
`submit_adopt`, paged engines only): a prefill-role request runs the
ordinary admission with a one-token budget and, at retire, its pages are
gathered off the pool into new tensors (queued on the stream before the
pages are released; the caller's thread copies them to the host).  A
decode-role engine scatters a handoff's pages into its own pool and the
slot continues from the transferred first token.  Leaves travel in the
JAX cache tree's order (`_leaf_order`), so a payload crosses between the
two packages.

Weight swaps (`update_params`, the RL rollout/update alternation): the
new state dict is copied onto the device at once (never aliased: an
optimizer goes on updating the caller's tensors in place), and the loop
copies it INTO the served parameters at its next dispatch boundary, on
its own stream, so calls already queued finish on the old values and
the captured graph, which reads the parameters at their addresses, sees
the new ones from the next call on.  The staged copy is dropped after
the next sync, bounding the double buffer to one loop iteration.

Speculative verify (`speculation=k`): one S = k+1 call over every slot,
held as a call object over fixed buffers like the decode call
(`_VerifyCall`: a device draft buffer filled by a pinned copy before
each call, the page table, the pool, `_last_d`, `_lens_d` and its output
rows), captured as one CUDA graph at `prewarm()` on the card.

Perf plane (`perf/`): `_process_rows` accumulates, per emitted token, its
context length and its call's batch size; the loop folds them through
the static cost model (`perf_cost_model`) into the live MFU, bytes/token
and intensity gauges every `perf_window_s` (host arithmetic only: no
added sync).  Every call object's build counts as a compile
(`perf/compile_telemetry.py`); `prewarm()` on the card arms the
recompile sentinel once the kernels are built and every call the engine
uses is captured.

Tensor parallelism (`EngineConfig(mesh=...)`, a `parallel.mesh.RankMesh`
from `build_serve_mesh`; the model built over the same mesh): one engine
per rank, each holding its slices of the weights and the KV cache (the
dense cache [n_slots, n_kv_heads/t, L, D], the page pool, the int8 scales
and the chunk scratch over kv heads; page tables and every host-synced
tensor whole on every rank).  The ranks must issue the same device calls
in the same order, so only rank 0 takes requests (`submit*`,
`update_params`, the HTTP server): they wait in an inbox, and at the top
of each `step()` / `step_pipelined()` / `prewarm()` rank 0 broadcasts one
fixed-shape int64 control header over the mesh's gloo control group (the
action; how many requests it admits, their prompt ids and budgets; a
staged weight swap), then the ids and any handed-off pages; a swap's
weights follow over the device group, one whole tensor at a time.  The other ranks run `follow()`: they apply the same changes and
run the same action, so their schedulers take the same decisions (none is
taken from the wall clock).  Every rank samples from the same whole
logits with the same seeded generator, so every rank emits the same
tokens.  A weight swap travels whole and each rank keeps its slice; an
export gathers every rank's kv heads into the usual full-head payload,
and an adopt scatters one back, so handoffs cross between tensor degrees
and between the two packages.  Under an NCCL group the decode and verify
calls are CUDA graphs as on one device; under gloo they run eagerly
(gloo syncs the host in every collective, which a graph cannot capture).
`close()` ends the followers.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.device import DeviceLike, device_of, resolve_device
from skypilot_tpu_torch.inference import kv_quant
from skypilot_tpu_torch.inference.paging import TRASH_PAGE, PagePool, RadixCache
from skypilot_tpu_torch.ops.cuda import flash_attention as cuda_fa
from skypilot_tpu_torch.parallel import group as group_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.perf import compile_telemetry
from skypilot_tpu_torch.perf import cost_model as cost_model_lib
from skypilot_tpu_torch.perf import profiler as profiler_lib
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing
from skypilot_tpu_torch.train import flops as flops_lib

logger = sky_logging.init_logger(__name__)

# Rank 0's control header under a mesh: [action, requests, prompt ids,
# swap], the action one of these.
_ACT_APPLY, _ACT_STEP, _ACT_PIPELINED, _ACT_PREWARM, _ACT_STOP = range(5)
# Per announced request: (route, prompt_len, max_new_tokens, first_token,
# n_kv_pages), the route one of these.
_ROUTE_SERVE, _ROUTE_PREFILL, _ROUTE_ADOPT = range(3)
_META = 5


class _Discard:
    """The token queue of a request a follower runs for no one."""

    @staticmethod
    def put(_tok) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    # Prompt lengths are padded up to one of these.  Longest bucket bounds
    # the prompts that prefill in one dispatch; longer ones are chunked.
    prefill_buckets: tuple = (32, 64, 128, 256, 512)
    # Decode steps per call: larger values amortize the host round trip,
    # smaller values tighten the admission/streaming granularity.
    steps_per_call: int = 8
    eos_id: Optional[int] = None       # None: never stop on a token
    temperature: float = 0.0           # 0 => greedy
    seed: int = 0
    # Admission cap for prompts.  None: anything up to max_seq_len - 1.
    max_prompt_len: Optional[int] = None
    # Tensor parallelism: this rank's `parallel.mesh.RankMesh` (from
    # build_serve_mesh; the model must be built over it).  None = one
    # device.  Under a gloo group the decode and verify calls run eagerly:
    # gloo syncs the host in every collective, so no CUDA graph.
    mesh: Optional[Any] = None
    tensor_axis: str = 'tensor'
    # Paged KV cache: page size in tokens (must divide every prefill
    # bucket and max_seq_len).  None = the contiguous layout.
    kv_page_size: Optional[int] = None
    # Page-pool size.  None = full backing (n_slots * max_seq_len /
    # page_size, + 1 trash page).  Must fit one max-length request.
    kv_pages: Optional[int] = None
    # Radix prefix cache over the page pool (kv_page_size set).
    prefix_cache: bool = True
    # 'bf16' keeps the model dtype; 'int8' quantizes pages at scatter
    # time (kv_quant.QuantPages).  Requires kv_page_size.
    kv_dtype: str = 'bf16'
    # Self-speculative decoding: draft length k per slot, 0 = off.
    # Requires kv_page_size and temperature == 0.0.
    speculation: int = 0


@dataclasses.dataclass
class Request:
    prompt_ids: List[int]
    max_new_tokens: int
    out: 'queue.Queue[Optional[int]]' = dataclasses.field(
        default_factory=queue.Queue)
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    emitted: int = 0
    # Distributed-tracing id (from the HTTP layer's X-Skytpu-Request-Id);
    # None = untraced.
    request_id: Optional[str] = None
    # perf_counter stamp of the END of this request's last prefill
    # dispatch: the engine.dispatch span starts here.
    prefill_end_at: Optional[float] = None
    # Set when a stuck-pool spill demoted this request to a full prefill
    # (see _spill_stuck_hits): re-matching would re-pin the same pages.
    no_prefix: bool = False
    # Disaggregated serving (paged engines only).  export=True marks a
    # prefill-role request (submit_prefill): one-token budget, and at
    # retire its pages + first token are staged in `kv_export`.  `adopt`
    # carries a decode-role request's incoming (first_token, leaves).
    export: bool = False
    kv_export: Optional[dict] = None
    adopt: Optional[tuple] = None

    def tokens(self) -> List[int]:
        """Drain: block until the request finishes, return all tokens."""
        toks = []
        while True:
            t = self.out.get()
            if t is None:
                return toks
            toks.append(t)


def _fail_requests(reqs) -> None:
    """End requests that will get no more tokens (their streams close)."""
    for req in reqs:
        req.finished_at = time.perf_counter()
        req.out.put(None)


class _Slot:
    __slots__ = ('request', 'length', 'first_pending', 'done', 'pages',
                 'n_shared', 'toks')

    def __init__(self, request: Request, length: int,
                 pages: Optional[List[int]] = None,
                 n_shared: int = 0) -> None:
        self.request = request
        self.length = length              # prompt len + emitted (host view)
        # True until the prefill-sampled first token has been emitted (it
        # arrives as row 0 of the next decode call's output).
        self.first_pending = True
        # Finished (retired); lets a pipelined in-flight call's snapshot
        # tell a handed-off slot's remaining rows from retire-lag garbage.
        self.done = False
        # Paged engine: the KV pages backing this slot, in logical order;
        # the first n_shared are prefix-cache pages it never writes.
        self.pages = pages
        self.n_shared = n_shared
        # Emitted tokens (paged): retire donates prompt+generated pages,
        # and an export needs the sampled first token.
        self.toks: List[int] = []


class _ChunkedPrefill:
    """Host state of one long prompt mid-chunked-prefill: the scratch
    cache accumulating its K/V and how far into the prompt it is.  A
    prefix-cache hit starts at offset == the matched length with a
    scratch gathered from the shared pages."""
    __slots__ = ('request', 'scratch', 'offset', 'last_chunk_end',
                 'shared_pages')

    def __init__(self, request: Request, scratch, offset: int = 0,
                 shared_pages: Optional[List[int]] = None) -> None:
        self.request = request
        self.scratch = scratch
        self.offset = offset     # prompt tokens already in the scratch
        # End stamp of the previous chunk dispatch, so the per-chunk spans
        # tile the whole chunked-prefill phase.
        self.last_chunk_end: Optional[float] = None
        # Prefix-cache pages this request references (ref'd by the
        # match); the head of its slot's page table at insert time.
        self.shared_pages = shared_pages or []


def _ngram_continuation(hist: List[int], k: int, max_ngram: int = 3,
                        window: int = 512) -> np.ndarray:
    """Self-speculative n-gram draft: the k tokens that followed the
    most recent earlier occurrence of ``hist``'s tail n-gram (longest
    n first, n = max_ngram..1), zero-padded when the match runs out.

    Pure host arithmetic over the slot's own token history — no second
    model, no device work.  On repetitive traffic (code, templated
    text, multi-turn replays) the continuation after a repeated n-gram
    is usually the same continuation, which is exactly what verify
    accepts; on incompressible traffic drafts self-reject to m=1 and
    the engine degrades to plain (correct) decode.  Only the last
    ``window`` tokens are scanned: a bounded O(window * max_ngram)
    per slot per step, never proportional to the full context.
    """
    out = np.zeros((k,), np.int32)
    ln = len(hist)
    if ln < 2:
        return out
    lo = max(0, ln - window)
    for n in range(min(max_ngram, ln - 1), 0, -1):
        tail = hist[ln - n:]
        # Most recent earlier occurrence: scan ends before the tail
        # itself (i + n < ln) so the draft continues PAST the match.
        for i in range(ln - n - 1, lo - 1, -1):
            if hist[i:i + n] == tail:
                # When the match overlaps the tail (a cycling stream —
                # the case speculation wins hardest on), the observed
                # continuation is shorter than k; extend it cyclically
                # instead of zero-padding, so a period-p loop drafts
                # the whole next k tokens, not just p of them.
                span = ln - (i + n)
                for j in range(k):
                    out[j] = hist[i + n + (j if j < span else j % span)]
                return out
    return out


def _leaf_order(n_layers: int) -> List[int]:
    """Layer indices in the JAX cache tree's leaf order: its dict keys
    `layer_{i}` flatten sorted as strings (layer_0, layer_1, layer_10,
    ...), so a handoff's leaves line up across the two packages."""
    return sorted(range(n_layers), key=lambda i: f'layer_{i}')


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype ('bfloat16', 'float32', 'int8'):
    the names the JAX engine's messages and the wire format use."""
    return str(dtype).replace('torch.', '')


class _GraphCall:
    """One device call of the engine as ONE object over fixed buffers:
    the engine's `_last_d` and `_lens_d`, its cache or page pool, its
    device page table, and the call's own output rows (and inputs).
    With `use_graph` (CUDA) the body is captured once as a CUDA graph and
    each call replays it; otherwise each call runs the body.  A call
    returns a clone of the output rows: the next call writes the same
    buffer while the pipelined loop still has to read this call's rows.
    Building it is the port's "compile" (`compile_telemetry.compiling`),
    and a capture holds the profiler's TRACE_LOCK, so no profiler window
    traces a graph mid-capture.  It keeps no reference to its engine (the
    engine holds it; a cycle would keep a dead engine's cache and model
    alive until the garbage collector ran)."""
    kind = ''

    def __init__(self, engine: 'DecodeEngine', use_graph: bool,
                 rows: int) -> None:
        kv = (engine.cfg.kv_dtype if engine._paged
              else _dtype_name(engine.model.cfg.dtype))
        shapes = (f'{self.kind} out=[{rows}, {engine.cfg.n_slots}] '
                  f'k={engine._spec_k} paged={engine._paged} kv={kv} '
                  f'graph={use_graph}')
        with compile_telemetry.compiling(self.kind, shapes):
            self.out = torch.zeros((rows, engine.cfg.n_slots),
                                   dtype=torch.long, device=engine.device)
            self._buffers(engine)
            self.graph = None
            if use_graph:
                with profiler_lib.TRACE_LOCK:
                    self.graph = self._capture(engine)

    def _buffers(self, engine: 'DecodeEngine') -> None:
        """Allocate the call's fixed input buffers (none by default)."""

    def _body(self, engine: 'DecodeEngine', warmup: bool = False) -> None:
        raise NotImplementedError

    def _capture(self, eng: 'DecodeEngine'):
        dev = eng.device
        # Warm up on a side stream (lazy kernel loading, library handles)
        # with one call, then restore what it advanced: the slots' last
        # tokens and lengths and the sampler's generator.  Its K/V writes
        # land at positions >= each slot's length, which the next real
        # call overwrites before any query reads them.
        saved = (eng._last_d.clone(), eng._lens_d.clone(),
                 eng._gen.get_state())
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(eng, warmup=True)
        torch.cuda.current_stream(dev).wait_stream(side)
        eng._last_d.copy_(saved[0])
        eng._lens_d.copy_(saved[1])
        eng._gen.set_state(saved[2])
        graph = torch.cuda.CUDAGraph()
        # Temperature sampling draws from the engine's own generator:
        # registered, each replay draws fresh numbers and advances it.
        graph.register_generator_state(eng._gen)
        # thread_local: the server's executor threads may touch the
        # device (export copies) while the loop thread captures.
        with torch.cuda.graph(graph, capture_error_mode='thread_local'):
            self._body(eng)
        return graph

    def __call__(self, engine: 'DecodeEngine') -> torch.Tensor:
        """One call on `engine`, the engine it was built for."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body(engine)
        return self.out.clone()


class _DecodeCall(_GraphCall):
    """The decode call: `steps_per_call` steps over every slot, output
    rows [T+1, n_slots] (the counterpart of the JAX engine's compiled
    `lax.scan`)."""
    kind = 'decode'

    def __init__(self, engine: 'DecodeEngine', use_graph: bool) -> None:
        super().__init__(engine, use_graph, engine.cfg.steps_per_call + 1)

    def _body(self, engine, warmup=False):
        engine._decode(self.out, n_steps=1 if warmup else None)


class _VerifyCall(_GraphCall):
    """The speculative verify call: every slot's k drafts scored in one
    S = k+1 step, output rows [k+3, n_slots].  Its drafts [n_slots, k]
    live in a fixed device buffer, filled by a pinned non-blocking copy
    before each call (the graph reads them at their address)."""
    kind = 'verify'

    def __init__(self, engine: 'DecodeEngine', use_graph: bool) -> None:
        super().__init__(engine, use_graph, engine._spec_k + 3)

    def _buffers(self, engine):
        self.drafts = torch.zeros((engine.cfg.n_slots, engine._spec_k),
                                  dtype=torch.long, device=engine.device)

    def _body(self, engine, warmup=False):
        engine._verify(self.out, self.drafts)

    def __call__(self, engine: 'DecodeEngine',
                 drafts: np.ndarray) -> torch.Tensor:
        """One verify of `drafts` [n_slots, k] (host) on `engine`."""
        engine._h2d_into(self.drafts, drafts)
        return super().__call__(engine)


class DecodeEngine:
    """Slot-based continuous batching over a `models.llama.Llama`.

    `model.cfg.max_seq_len` bounds prompt+generation; the per-layer KV
    cache is [n_slots, n_kv_heads, max_seq_len, head_dim] (or the page
    pool under `kv_page_size`).  The model's parameters must live on
    `device` (default: the GPU; raises without one).

    `_eager_decode` (private) runs the decode (and verify) call's body
    without the CUDA graph on the card: only for comparing the two.
    """

    def __init__(self, model, config: EngineConfig = EngineConfig(),
                 device: DeviceLike = None, _eager_decode: bool = False):
        if device is None and config.mesh is not None:
            device = config.mesh.device
        self.device = resolve_device(device)
        params_on = device_of(model)
        if params_on is not None and params_on != self.device:
            raise ValueError(f'model parameters are on {params_on}, the '
                             f'engine runs on {self.device}')
        self.model = model
        if config.n_slots <= 0:
            raise ValueError(
                f'EngineConfig.n_slots must be a positive slot count, '
                f'got {config.n_slots}')
        # Buckets beyond the cache length can never be inserted; drop them
        # so submit() rejects oversized prompts up front.
        max_len = model.cfg.max_seq_len
        buckets = tuple(b for b in config.prefill_buckets if b <= max_len)
        if not buckets:
            buckets = (max_len,)
        config = dataclasses.replace(config, prefill_buckets=buckets)
        self._validate_paging(config, max_len)
        self.cfg = config
        self._mesh = config.mesh
        # Tensor-parallel state: the degree, this rank's kv heads, rank
        # 0's control channel and its inbox of requests not yet announced.
        self._tp = 1
        self._n_kv = model.cfg.n_kv_heads
        self._control: Optional[group_lib.Control] = None
        self._inbox: List[Request] = []
        self._group_closed = False
        if self._mesh is not None:
            self._setup_mesh()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        self._prefill_q: 'queue.Queue[Request]' = queue.Queue()
        # Orders submit()'s error-check-then-enqueue against the crash
        # path's set-error-then-drain.
        self._submit_lock = threading.Lock()
        self._slots: List[Optional[_Slot]] = [None] * config.n_slots
        # In-flight decode call (pipelined loop): (device out, snapshot of
        # the slots it covers).  Processed one iteration later.
        self._inflight = None
        # Long prompts (beyond the largest bucket) queue here and go
        # through chunked prefill, one at a time.
        self._long_q: 'queue.Queue[Request]' = queue.Queue()
        self._chunked: Optional[_ChunkedPrefill] = None
        # Paged KV cache: host allocator + per-slot page tables + the
        # radix prefix cache, all loop-thread state; only the table is
        # shipped to the device (pinned copy, refreshed when dirty).
        self._paged = config.kv_page_size is not None
        self._kv_quant = self._paged and config.kv_dtype == 'int8'
        self._spec_k = config.speculation if self._paged else 0
        self._page_size = config.kv_page_size
        self._pages_per_slot = (max_len // config.kv_page_size
                                if self._paged else 0)
        self._pool_alloc: Optional[PagePool] = None
        self._radix: Optional[RadixCache] = None
        self._page_tables = None        # host np [n_slots, pages_per_slot]
        self._pt_device = None          # its device copy, one fixed tensor
        self._pt_dirty = True
        # Short prompts pulled off _prefill_q, awaiting page reservation
        # (head-of-line on allocation failure); prefix hits divert to
        # _hit_q and ride the chunk machinery.
        self._ready_q: 'collections.deque' = collections.deque()
        self._hit_q: 'collections.deque' = collections.deque()
        # Incoming KV handoffs (decode role): submitted into _adopt_q,
        # admitted head-of-line from _adopt_ready as slots + pages free.
        self._adopt_q: 'queue.Queue[Request]' = queue.Queue()
        self._adopt_ready: 'collections.deque' = collections.deque()
        if self._paged:
            n_pages = (config.kv_pages if config.kv_pages is not None
                       else config.n_slots * self._pages_per_slot + 1)
            self._pool_alloc = PagePool(n_pages, config.kv_page_size)
            if config.prefix_cache:
                self._radix = RadixCache(self._pool_alloc)
            self._page_tables = np.full(
                (config.n_slots, self._pages_per_slot), TRASH_PAGE,
                np.int64)
        # Prompt tokens accepted but not yet prefilled.  Writers hold
        # _submit_lock; the loop's gauge read is a bare int read.
        self._queued_tokens = 0
        # Batched prefill dispatches so far (one per admission group).
        self.prefill_groups = 0
        # The decode call, or under speculation the verify call (built at
        # prewarm() or the first dispatch), and the private switch that
        # keeps them eager on the card.
        self._decode_call: Optional[_DecodeCall] = None
        self._verify_call: Optional[_VerifyCall] = None
        self._eager_decode = _eager_decode
        # Double-buffered weight swap: update_params stages a copy here;
        # the loop installs it at its next dispatch boundary and drops
        # the staged copy once the install's copies have run.
        self._params_lock = threading.Lock()
        self._staged_params: Optional[tuple] = None
        self._retiring_params: List[Any] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_gauges: Optional[tuple] = None
        # Device-cost attribution (perf/): the loop thread folds these
        # host-side accumulators into the live MFU / bytes-per-token
        # gauges: token count, token-weighted context length and
        # token-weighted batch occupancy, all written by _process_rows.
        self._perf_tokens = 0
        self._perf_ctx_sum = 0
        self._perf_occ_sum = 0
        self._perf_window: Optional[tuple] = None
        self._perf_last: Optional[dict] = None
        # Minimum attribution window; benchmarks/tests shrink or grow
        # it to bracket exactly their measured region.
        self.perf_window_s = float(
            os.environ.get('SKYTPU_PERF_WINDOW_S', '0.5'))
        self.error: Optional[BaseException] = None
        self._init_cache()
        # The static cost model, built once the cache or pool exists.
        # from_engine_state reads only tensor METADATA (the pool's
        # declared dtype is how int8 pages land as a bytes/token drop),
        # never values: no device sync.
        self._cost_model = cost_model_lib.EngineCostModel.from_engine_state(
            model.cfg, model.parameters(),
            [t for layer in self._cache for t in layer],
            n_chips=self._mesh.size if self._mesh is not None else 1,
            chip=flops_lib.chip_kind(self.device),
            kv_dtype=config.kv_dtype if self._paged else None,
            param_bytes=self._global_param_bytes())

    @property
    def healthy(self) -> bool:
        return self.error is None

    @property
    def leader(self) -> bool:
        """True on the rank that takes requests: rank 0 of a mesh, or the
        one device's engine."""
        return self._mesh is None or self._mesh.rank == 0

    # ----- tensor parallelism ------------------------------------------------
    def _setup_mesh(self) -> None:
        """Check the mesh against the model (validated degree, the model
        built over this mesh) and set up the rank's view: its kv heads and
        the control channel."""
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        mesh, mcfg = self._mesh, self.model.cfg
        if getattr(self.model, 'mesh', None) is not mesh:
            raise ValueError(
                'EngineConfig.mesh: build the model over the same mesh '
                '(Llama(cfg, params, mesh), params this rank\'s slices)')
        if self.cfg.tensor_axis != 'tensor':
            raise ValueError(f'tensor_axis {self.cfg.tensor_axis!r}: the '
                             f"port's models shard over 'tensor'")
        self._tp = int(mesh.shape['tensor'])
        mesh_lib.validate_tensor_parallel(self._tp, n_heads=mcfg.n_heads,
                                          n_kv_heads=mcfg.n_kv_heads)
        self._n_kv = mcfg.n_kv_heads // self._tp
        self._control = group_lib.Control(mesh)
        if mesh.backend == 'gloo' and self.device.type == 'cuda':
            logger.info('tensor-parallel engine over gloo: the decode and '
                        'verify calls run eagerly (gloo syncs the host in '
                        'every collective, which a CUDA graph cannot '
                        'capture)')

    def _global_param_bytes(self) -> Optional[int]:
        """Under a mesh, the bytes of the WHOLE weights (each rank's slice
        times the number of slices), as the JAX cost model reads its
        global arrays; None on one device."""
        if self._mesh is None:
            return None
        from skypilot_tpu_torch.models.llama import param_shapes
        shapes = param_shapes(self.model.cfg)
        return sum(
            t.numel() * t.element_size() * sharding.shard_factor(
                sharding.param_spec(name, shapes[name], self._mesh.shape),
                self._mesh.shape)
            for name, t in self.model.named_parameters())

    def _check_leader(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f'{what}: rank {self._mesh.rank} of a tensor-parallel '
                f'engine follows rank 0 (call follow()); only rank 0 takes '
                f'requests and runs the loop')

    def _lead(self, action: int) -> None:
        """Rank 0 of a mesh, at a dispatch boundary: announce `action` and
        what changed since the last announcement (the inbox's requests, a
        staged weight swap), then apply it here as every follower does.
        A no-op on one device."""
        if self._mesh is None:
            return
        self._check_leader('step')
        if self._group_closed:
            raise RuntimeError('the followers of this engine have stopped '
                               '(close())')
        with self._submit_lock:
            reqs, self._inbox = self._inbox, []
        with self._params_lock:
            swap, self._staged_params = self._staged_params, None
        meta = np.zeros((len(reqs), _META), np.int64)
        for j, req in enumerate(reqs):
            route = (_ROUTE_ADOPT if req.adopt is not None else
                     _ROUTE_PREFILL if req.export else _ROUTE_SERVE)
            first = req.adopt[0] if req.adopt is not None else 0
            n_kv = (req.adopt[1][0].shape[0] if req.adopt is not None
                    else 0)
            meta[j] = (route, len(req.prompt_ids), req.max_new_tokens,
                       first, n_kv)
        ids = [i for req in reqs for i in req.prompt_ids]
        ctl = self._control
        try:
            ctl.send_header([action, len(reqs), len(ids), swap is not None])
            if reqs:
                ctl.send_ints(np.concatenate(
                    [meta.ravel(), np.asarray(ids, np.int64)]))
            for req in reqs:
                if req.adopt is not None:
                    for leaf in req.adopt[1]:
                        ctl.send_tensor(leaf)
        except BaseException:
            # A follower is gone (or the group timed out): these requests
            # left the inbox and reached no queue, so end them here.
            _fail_requests(reqs)
            raise
        self._apply(reqs, swap)

    def follow(self, record: bool = False) -> List[Request]:
        """A follower rank's loop: take rank 0's announcements, apply
        them and run the same action, until rank 0 closes.  With `record`
        it returns the requests it ran (their tokens are rank 0's), else
        their tokens go nowhere."""
        if self._mesh is None or self.leader:
            raise RuntimeError('follow() runs on ranks 1.. of a '
                               'tensor-parallel engine')
        ctl, seen = self._control, []
        while True:
            action, n_req, n_ids, swap = (int(v) for v in
                                          ctl.recv_header()[:4])
            reqs = []
            if n_req:
                flat = ctl.recv_ints(n_req * _META + n_ids)
                meta = flat[:n_req * _META].reshape(n_req, _META)
                ids, off = flat[n_req * _META:], 0
                for route, plen, max_new, first, n_kv in meta.tolist():
                    req = Request(ids[off:off + plen].tolist(), max_new)
                    off += plen
                    req.export = route == _ROUTE_PREFILL
                    if route == _ROUTE_ADOPT:
                        req.adopt = (first, [
                            ctl.recv_tensor((n_kv,) + shape, dtype)
                            for shape, dtype in self._wire_page_shapes()])
                    if not record:
                        req.out = _Discard()
                    reqs.append(req)
            with self._submit_lock:
                self._queued_tokens += sum(len(r.prompt_ids) for r in reqs
                                           if r.adopt is None)
            self._apply(reqs, bool(swap))
            if record:
                seen += reqs
            if action == _ACT_STOP:
                return seen
            if action == _ACT_STEP:
                self._step()
            elif action == _ACT_PIPELINED:
                self._step_pipelined()
            elif action == _ACT_PREWARM:
                self._prewarm()

    def _apply(self, reqs: List[Request], swap) -> None:
        """Every rank: queue the announced requests (in announcement
        order) and install an announced swap (rank 0 passes its staged
        weights, the followers True)."""
        for req in reqs:
            self._route(req)
        if swap:
            self._install_broadcast(swap if self.leader else None)

    def _install_broadcast(self, staged) -> None:
        """Install a weight swap on every rank: rank 0 broadcasts each
        whole tensor of its staged copy over the mesh's device group, one
        tensor at a time, and each rank copies its slice into the served
        parameter.  The staged tree stays in rank 0's host memory, so a
        card holds one whole tensor at a time, never the whole tree."""
        from skypilot_tpu_torch.models.llama import param_shapes
        shapes = param_shapes(self.model.cfg)
        group = self.model.tp.group
        with torch.no_grad():
            for name, param in self.model.state_dict(
                    keep_vars=True).items():
                if self.leader:
                    full = staged[0][name].to(self.device)
                else:
                    full = torch.empty(shapes[name], dtype=param.dtype,
                                       device=self.device)
                dist.broadcast(full, src=0, group=group)
                spec = sharding.param_spec(name, shapes[name],
                                           self._mesh.shape)
                param.copy_(sharding.local_slice(full, spec, self._mesh))

    def _wire_page_shapes(self) -> List[tuple]:
        """(per-page shape, dtype) of each wire leaf as a handoff carries
        it: every kv head (this rank's times the degree)."""
        out = []
        for leaf in self._wire_leaves():
            shape = list(leaf.shape[1:])
            shape[0] *= self._tp
            out.append((tuple(shape), leaf.dtype))
        return out

    def close(self) -> None:
        """`stop()`, and under a mesh end the followers' `follow()` (rank
        0; the engine takes no more steps after)."""
        self.stop()
        if self._mesh is None or not self.leader or self._group_closed:
            return
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError('the engine loop did not stop')
        try:
            self._lead(_ACT_STOP)
        finally:
            self._group_closed = True

    @property
    def perf_cost_model(self) -> cost_model_lib.EngineCostModel:
        """The static per-dispatch cost model behind the live gauges."""
        return self._cost_model

    def perf_snapshot(self) -> Optional[dict]:
        """Last perf-gauge sample the loop thread computed (mfu,
        hbm_bytes_per_token, arith_intensity, tokens_per_s,
        mean_context, mean_occupancy): None until the first non-idle
        attribution window closes."""
        return dict(self._perf_last) if self._perf_last else None

    def perf_reset_window(self) -> None:
        """Restart the attribution window so the next sample covers
        only what follows (benchmarks bracket their measured region
        with this).  The start is stamped HERE, not lazily at the next
        loop sample: step()'s sample point sits after _admit_free, so a
        lazy stamp would exclude the first admission's prefill dispatch
        from the window while any wall-clock bracket around the region
        includes it, a systematic rate skew on short regions."""
        self._perf_window = (time.perf_counter(), self._perf_tokens,
                             self._perf_ctx_sum, self._perf_occ_sum)

    def arm_recompile_sentinel(self) -> None:
        """Declare warmup complete: every build of a call object or the
        kernel library from here on records a perf.recompile
        flight-recorder event, and SKYTPU_STRICT_RECOMPILE=1 escalates
        it to a hard failure in the building call.  prewarm() arms on
        the card, where it captures every call; on the CPU (nothing
        captured) callers opt in here once their calls are built."""
        compile_telemetry.arm()

    @staticmethod
    def _validate_paging(config: EngineConfig, max_len: int) -> None:
        """Reject paging geometry that cannot work, naming the
        offending values: kv_page_size must divide every prefill bucket
        and max_seq_len, and the pool must fit at least one max-length
        request plus the trash page.  kv_dtype and speculation are
        validated here too: both are properties of the paged
        substrate.  (The JAX engine's messages, word for word.)"""
        ps = config.kv_page_size
        if config.kv_dtype not in ('bf16', 'int8'):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got "
                f"{config.kv_dtype!r}")
        if config.kv_dtype == 'int8' and ps is None:
            raise ValueError(
                'kv_dtype=int8 quantizes the PAGED pool at scatter '
                'time; set kv_page_size (the contiguous cache keeps '
                'the model dtype)')
        if config.speculation < 0:
            raise ValueError(
                f'speculation must be a non-negative draft length, '
                f'got {config.speculation}')
        if config.speculation > 0:
            if ps is None:
                raise ValueError(
                    'speculation requires kv_page_size: rejected draft '
                    'rows must land in slot-owned/trash pages, not the '
                    'contiguous cache')
            if config.temperature != 0.0:
                raise ValueError(
                    f'speculation is greedy-only (accept = exact argmax '
                    f'match, lossless at temperature 0.0); got '
                    f'temperature={config.temperature}')
        if ps is None:
            return
        if ps <= 0:
            raise ValueError(
                f'kv_page_size must be a positive token count, got {ps}')
        offending = [b for b in config.prefill_buckets if b % ps != 0]
        if max_len % ps != 0:
            offending.append(max_len)
        if offending:
            raise ValueError(
                f'kv_page_size={ps} must divide every prefill bucket '
                f'and max_seq_len; offending values: '
                f'{sorted(set(offending))} (buckets='
                f'{config.prefill_buckets}, max_seq_len={max_len})')
        if config.kv_pages is not None:
            need = max_len // ps + 1
            if config.kv_pages < need:
                raise ValueError(
                    f'kv_pages={config.kv_pages} cannot hold one '
                    f'max-length request: need >= {need} '
                    f'(max_seq_len {max_len} / kv_page_size {ps} '
                    f'+ 1 trash page)')

    # ----- device state ------------------------------------------------------
    def _make_cache(self, n: Optional[int] = None):
        """Zeroed per-layer (k, v) cache for `n` rows (default: the
        engine's slots; n=1: the chunked-prefill scratch)."""
        mcfg = self.model.cfg
        n = self.cfg.n_slots if n is None else n
        shape = (n, self._n_kv, mcfg.max_seq_len, mcfg.head_dim)
        return [(torch.zeros(shape, dtype=mcfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=mcfg.dtype, device=self.device))
                for _ in range(mcfg.n_layers)]

    def _pool_shape(self) -> tuple:
        """One pool leaf: [n_pages, H_kv, page_size, D] (this rank's kv
        heads under a mesh)."""
        mcfg = self.model.cfg
        return (self._pool_alloc.n_pages, self._n_kv, self._page_size,
                mcfg.head_dim)

    def _pool_leaf(self):
        """A zeroed pool leaf: a tensor in the model dtype, or a
        QuantPages of (int8 data, f32 scales) under kv_dtype=int8."""
        shape = self._pool_shape()
        if self._kv_quant:
            return kv_quant.QuantPages(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.zeros(shape[:3], dtype=torch.float32,
                            device=self.device))
        return torch.zeros(shape, dtype=self.model.cfg.dtype,
                           device=self.device)

    def _init_cache(self):
        n = self.cfg.n_slots
        if self._paged:
            # The PAGE POOL: n_pages x page bytes, sized by kv_pages, not
            # by n_slots x max_seq_len.  Page 0 is the trash page.
            self._cache = [(self._pool_leaf(), self._pool_leaf())
                           for _ in range(self.model.cfg.n_layers)]
        else:
            self._cache = self._make_cache()
        if self._paged:
            self._pt_device = torch.full(self._page_tables.shape, TRASH_PAGE,
                                         dtype=torch.long, device=self.device)
        self._last_d = torch.zeros((n,), dtype=torch.long, device=self.device)
        self._lens_d = torch.zeros((n,), dtype=torch.long, device=self.device)

    def _wire_leaves(self) -> List[torch.Tensor]:
        """The pool's tensors in the JAX cache tree's leaf order: layers
        by `_leaf_order`, k then v, and under int8 data then scale."""
        leaves = []
        for i in _leaf_order(len(self._cache)):
            for leaf in self._cache[i]:
                if isinstance(leaf, kv_quant.QuantPages):
                    leaves += [leaf.data, leaf.scale]
                else:
                    leaves.append(leaf)
        return leaves

    def _h2d(self, arr) -> torch.Tensor:
        """Host array or CPU tensor -> device without a sync (pinned,
        non-blocking), so admissions queue behind an in-flight decode
        call.  pin_memory() copies, so the caller may reuse `arr` at
        once."""
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _h2d_into(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """`_h2d` into an existing device tensor (one the decode graph
        reads at its address)."""
        t = torch.from_numpy(arr)
        if self.device.type == 'cuda':
            dst.copy_(t.pin_memory(), non_blocking=True)
        else:
            dst.copy_(t)

    # ----- device compute ----------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [..., V] f32 -> token ids [...] (greedy at temperature
        0, else a categorical draw from the engine's generator)."""
        temp = self.cfg.temperature
        if temp > 0.0:
            probs = torch.softmax(logits / temp, dim=-1)
            # torch.multinomial's one-sample draw, argmax(p / q) with q ~
            # Exp(1) (the same numbers from the same generator state),
            # without its validity checks, which read values back to the
            # host and so cannot be captured in the decode graph.
            q = torch.empty_like(probs).exponential_(1.0, generator=self._gen)
            return torch.argmax(probs / q, dim=-1)
        return torch.argmax(logits, dim=-1)

    def _to_pages(self, small: torch.Tensor) -> torch.Tensor:
        """Dense rows [N, H, L, D] -> page stacks [N, P, H, ps, D], the
        trailing dims of a pool scatter at a page-table row."""
        n, h, _, d = small.shape
        pages = small.transpose(1, 2).reshape(n, self._pages_per_slot,
                                              self._page_size, h, d)
        return pages.transpose(2, 3)

    @staticmethod
    def _scatter_pages(leaf, pages: torch.Tensor, rows: torch.Tensor):
        """pool_leaf[rows] = pages (quantized on the way in under int8).
        Trash entries of `rows` take duplicate-index garbage."""
        if isinstance(leaf, kv_quant.QuantPages):
            qd, s = kv_quant.quantize_kv(pages)
            leaf.data[rows] = qd
            leaf.scale[rows] = s
        else:
            leaf[rows] = pages

    @torch.no_grad()
    def _prefill_insert(self, big_cache, last_toks, lens, tokens,
                        lengths, slots, valid, pt_rows=None):
        """Fused BATCHED prefill + slot insert: N prompts of one bucket,
        nothing synced.  tokens [N, P], lengths/slots/valid [N].  Padding
        rows replicate row 0 (`valid`=0).  Paged (`pt_rows` [N, pages per
        slot]): the same prefill, then each row's full-length dense cache
        scatters into the pool at its page-table row; entries past a
        row's reservation point at the trash page."""
        n, p = tokens.shape
        positions = torch.arange(p, device=self.device)[None, :].expand(n, p)
        logits, small = self.model(tokens, positions, decode=True,
                                   logits_at=lengths - 1)
        last = logits[:, 0]                                       # [N, V]
        firsts = self._sample(last)                               # [N]
        # Padding rows replicate row 0, so their duplicate scatter writes
        # must carry row 0's VALUE too: which duplicate-index write wins
        # is unspecified.
        firsts = torch.where(valid.bool(), firsts, firsts[0])
        for (big_k, big_v), (k, v) in zip(big_cache, small):
            if pt_rows is None:
                # The prefill cache is already full-length [N, H, L, D].
                big_k[slots] = k
                big_v[slots] = v
            else:
                self._scatter_pages(big_k, self._to_pages(k), pt_rows)
                self._scatter_pages(big_v, self._to_pages(v), pt_rows)
        last_toks[slots] = firsts
        lens[slots] = lengths
        return big_cache, last_toks, lens

    @torch.no_grad()
    def _decode(self, out: torch.Tensor, n_steps: Optional[int] = None):
        """The decode call's body (`_DecodeCall`): `n_steps` (default
        `steps_per_call`) tokens for every slot, all in place over the
        engine's fixed buffers.  out[0] = the incoming last tokens,
        out[t] = step t's tokens; the cache (paged: the pool, through the
        call-constant `_pt_device`) takes each step's K/V, and `_last_d`
        and `_lens_d` are advanced by copying back into them."""
        max_len = self.model.cfg.max_seq_len
        page_table = self._pt_device if self._paged else None
        last, lens = self._last_d, self._lens_d
        out[0].copy_(last)
        for t in range(n_steps or self.cfg.steps_per_call):
            # Clamp writes for slots running past the cap: confined to
            # slots being retired (their cache is re-inserted).
            positions = torch.clamp(lens, max=max_len - 1)[:, None]
            logits, _ = self.model(last[:, None], positions, decode=True,
                                   cache=self._cache, page_table=page_table)
            last = self._sample(logits[:, 0, :])
            out[t + 1].copy_(last)
            lens = lens + 1
        self._last_d.copy_(last)
        self._lens_d.copy_(lens)

    @torch.no_grad()
    def _verify(self, out: torch.Tensor, drafts: torch.Tensor) -> None:
        """The verify call's body (`_VerifyCall`), speculative VERIFY:
        score every slot's k host-drafted tokens (`drafts` [n_slots, k])
        in one S = k+1 call and accept the longest greedy-matching
        prefix.  g[:, j] is the greedy continuation after the draft
        prefix up to j; draft d_j is accepted iff d_j == g[:, j-1], and
        acceptance stops at the first mismatch, so m in [1, k+1] tokens
        commit per slot (m = 1 is plain decode).  Rejected rows leave
        K/V garbage strictly at positions >= the new length, written
        over before the next gather reads them.  All in place over the
        engine's fixed buffers: the pool through the call-constant
        `_pt_device`, and `_last_d` / `_lens_d` advanced by copies.

        Output rows: [0] = incoming last tokens, [1..k+1] = greedy
        continuations, [k+2] = m."""
        max_len = self.model.cfg.max_seq_len
        kk = drafts.shape[1]
        last, lens = self._last_d, self._lens_d
        toks = torch.cat([last[:, None], drafts], dim=1)         # [B, k+1]
        positions = torch.clamp(
            lens[:, None] + torch.arange(kk + 1, device=self.device),
            max=max_len - 1)
        logits, _ = self.model(toks, positions, decode=True,
                               cache=self._cache, page_table=self._pt_device)
        g = torch.argmax(logits, dim=-1)                          # [B, k+1]
        match = torch.cumprod((drafts == g[:, :kk]).long(), dim=1)
        m = 1 + match.sum(dim=1)                                  # [B]
        out[0].copy_(last)
        out[1:kk + 2].copy_(g.t())
        out[kk + 2].copy_(m)
        self._last_d.copy_(torch.gather(g, 1, (m - 1)[:, None])[:, 0])
        self._lens_d.add_(m)

    @torch.no_grad()
    def _gather_prefix(self, pool, pt_row):
        """Prefix-cache hit: the matched pages gathered into a DENSE
        scratch cache [1, H, max_len, D] (dequantized under int8), so the
        rest of the prompt rides the chunked-prefill path from offset =
        matched length.  Unmatched entries are trash pages: garbage above
        every query position the suffix uses."""
        dtype = self.model.cfg.dtype

        def gather(leaf):
            if isinstance(leaf, kv_quant.QuantPages):
                g = kv_quant.dequantize_kv(leaf.data[pt_row],
                                           leaf.scale[pt_row], dtype)
            else:
                g = leaf[pt_row]                          # [P, H, ps, D]
            g = g.transpose(0, 1)                         # [H, P, ps, D]
            return g.reshape(1, g.shape[0], -1, g.shape[3])

        return [(gather(k), gather(v)) for k, v in pool]

    @torch.no_grad()
    def _prefill_chunk(self, scratch, tokens, offset: int):
        """One INTERMEDIATE chunk of a long prompt: tokens [1, C] (all
        valid) land in the scratch cache at offset..offset+C and attend
        over everything before them."""
        c = tokens.shape[1]
        positions = torch.arange(offset, offset + c,
                                 device=self.device)[None, :]
        # Its logits go unused: computed at one position only.
        self.model(tokens, positions, decode=True, cache=scratch,
                   logits_at=torch.full((1,), c - 1, device=self.device))
        return scratch

    @torch.no_grad()
    def _chunk_insert(self, big_cache, last_toks, lens, scratch, tokens,
                      length: int, offset: int, total_len: int,
                      slot: int, pt_row=None):
        """FINAL chunk + slot insert: run the bucket-padded last chunk
        (`length` valid rows) against the scratch, sample the prompt's
        first token from its last valid row, and copy the scratch into
        `slot` (paged: scatter it into the pool at `pt_row`; shared
        prefix pages receive value-identical write-backs).  Padding rows
        write garbage at positions >= total_len (masked until the decode
        writes overwrite them) or past the cache end (dropped)."""
        c = tokens.shape[1]
        positions = torch.arange(offset, offset + c,
                                 device=self.device)[None, :]
        logits, scratch = self.model(
            tokens, positions, decode=True, cache=scratch,
            logits_at=torch.full((1,), length - 1, device=self.device))
        first = self._sample(logits[:, 0])                        # [1]
        for (big_k, big_v), (k, v) in zip(big_cache, scratch):
            if pt_row is None:
                big_k[slot].copy_(k[0])
                big_v[slot].copy_(v[0])
            else:
                self._scatter_pages(big_k, self._to_pages(k)[0], pt_row)
                self._scatter_pages(big_v, self._to_pages(v)[0], pt_row)
        last_toks[slot] = first[0]
        lens[slot] = total_len
        return big_cache, last_toks, lens

    @torch.no_grad()
    def _export_pages(self, pt_row) -> List[torch.Tensor]:
        """Disaggregation export: one slot's pages gathered OFF the pool
        as new tensors [P, H, ps, D] (scales [P, H, ps]) in wire leaf
        order.  The pool is only read.  Under a mesh every rank's kv
        heads are gathered (on every rank): the payload has them all."""
        leaves = [leaf[pt_row] for leaf in self._wire_leaves()]
        if self._mesh is not None:
            group = self.model.tp.group
            leaves = [sharding.gather_dim(leaf, 1, group) for leaf in leaves]
        return leaves

    @torch.no_grad()
    def _adopt_insert(self, data: List[torch.Tensor], scatter_row,
                      slot: int, first: int, length: int) -> None:
        """Disaggregation adopt: scatter a handoff's page stacks (wire
        leaf order, padded to pages_per_slot rows) into the pool at the
        request's fresh pages (padding rows target the trash page), and
        seed the slot's last token and length."""
        for pool_leaf, data_leaf in zip(self._wire_leaves(), data):
            pool_leaf[scatter_row] = data_leaf
        self._last_d[slot] = first
        self._lens_d[slot] = length

    # ----- public API --------------------------------------------------------
    @property
    def max_prompt_len(self) -> int:
        """Longest admissible prompt: max_seq_len - 1 (one generated token
        must fit the cache), optionally capped by the max_prompt_len
        knob."""
        limit = self.model.cfg.max_seq_len - 1
        if self.cfg.max_prompt_len is not None:
            limit = min(limit, self.cfg.max_prompt_len)
        return limit

    @property
    def queued_prefill_tokens(self) -> int:
        """Prompt tokens accepted but not yet prefilled (the
        skytpu_engine_queued_prefill_tokens gauge); no device sync."""
        return max(0, self._queued_tokens)

    def _check_prompt(self, prompt_ids: List[int]) -> None:
        limit = self.max_prompt_len
        if len(prompt_ids) > limit:
            raise ValueError(
                f'prompt len {len(prompt_ids)} exceeds max_prompt_len '
                f'{limit} (model max_seq_len '
                f'{self.model.cfg.max_seq_len})')

    def submit(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               request_id: Optional[str] = None) -> Request:
        self._check_leader('submit')
        self._check_prompt(prompt_ids)
        cache_len = self.model.cfg.max_seq_len
        if len(prompt_ids) + max_new_tokens > cache_len:
            max_new_tokens = cache_len - len(prompt_ids)
        req = Request(list(prompt_ids), max_new_tokens,
                      request_id=request_id)
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        """Publish one validated request to the loop thread.  Every flag
        the loop reads (export, adopt, no_prefix) is set BEFORE this.
        Under a mesh it waits in the inbox until rank 0 announces it."""
        with self._submit_lock:
            if self.error is not None:
                raise RuntimeError(
                    f'decode engine is dead: {self.error!r}')
            if self._mesh is not None:
                self._inbox.append(req)
            else:
                self._route(req)
            if req.adopt is None:
                self._queued_tokens += len(req.prompt_ids)
        metrics_lib.inc_counter('skytpu_engine_requests_total')

    def _route(self, req: Request) -> None:
        """Queue a request for the loop: handoffs to adopt, prompts
        beyond the largest bucket to the chunked path, the rest to
        prefill."""
        if req.adopt is not None:
            self._adopt_q.put(req)
        elif len(req.prompt_ids) > self.cfg.prefill_buckets[-1]:
            self._long_q.put(req)
        else:
            self._prefill_q.put(req)

    def generate(self, prompt_ids: List[int],
                 max_new_tokens: int = 64) -> List[int]:
        """Synchronous helper: submit and wait."""
        return self.submit(prompt_ids, max_new_tokens).tokens()

    # ----- disaggregated prefill/decode --------------------------------------
    def submit_prefill(self, prompt_ids: List[int],
                       max_new_tokens: int = 64,
                       request_id: Optional[str] = None) -> Request:
        """PREFILL-role admission: the ordinary prefill machinery (fused
        bucket, chunked, prefix hits), the first token sampled, and the
        request's pages HELD for export instead of decoding.  It
        finishes after one emitted token; `export_result` then yields
        the pages + token.  Admission charges ceil((prompt+1)/page)
        pages.  `max_new_tokens` is the downstream decode budget and
        only travels in the payload."""
        self._check_leader('submit_prefill')
        if not self._paged:
            raise RuntimeError(
                'disaggregated prefill requires the paged KV cache '
                '(kv_page_size): pages are the transfer unit')
        self._check_prompt(prompt_ids)
        del max_new_tokens     # the decode replica's budget, not this one's
        req = Request(list(prompt_ids), 1, request_id=request_id)
        req.export = True
        self._enqueue(req)
        return req

    def export_result(self, req: Request) -> dict:
        """The finished prefill-role request's transferable state:
        {'first_token', 'prompt_len', 'n_kv_pages', 'leaves'} with
        leaves as CPU tensors [n_kv_pages, H, page_size, D] (scales
        [n_kv_pages, H, page_size]) in wire leaf order.  Call only after
        `req.tokens()` returned; the device->host copy happens HERE, on
        the caller's thread, never the engine loop's."""
        if req.kv_export is None:
            raise RuntimeError(
                'no export staged for this request (not submitted via '
                'submit_prefill, not finished, or the engine died '
                'mid-request)')
        staged = req.kv_export
        n_kv = staged['n_kv_pages']
        if staged['leaves'] is None:
            raise RuntimeError('export already consumed for this '
                               'request')
        leaves = [leaf[:n_kv].cpu() for leaf in staged['leaves']]
        # Drop the device-side gather now that the host copy exists: it
        # holds a full slot's worth of KV memory per leaf.
        staged['leaves'] = None
        return {'first_token': staged['first_token'],
                'prompt_len': staged['prompt_len'],
                'n_kv_pages': n_kv,
                'leaves': leaves}

    def submit_adopt(self, prompt_ids: List[int], first_token: int,
                     kv_leaves: List[Any],
                     max_new_tokens: int = 64,
                     request_id: Optional[str] = None,
                     page_size: Optional[int] = None) -> Request:
        """DECODE-role admission of a KV handoff: the prompt's pages were
        prefilled elsewhere; adopt them into this engine's pool and
        continue decoding from the already-sampled first token (emitted
        through the ordinary row-0 mechanics).  `kv_leaves` are CPU
        tensors (or numpy arrays) [n_kv_pages, H, page_size, D] in wire
        leaf order, every kv head (under a mesh too)."""
        self._check_leader('submit_adopt')
        if not self._paged:
            raise RuntimeError(
                'adopting a KV handoff requires the paged KV cache '
                '(kv_page_size): pages are the transfer unit')
        if page_size is not None and page_size != self._page_size:
            raise ValueError(
                f'kv handoff page size {page_size} != this engine\'s '
                f'{self._page_size} — prefill and decode pools must '
                f'agree on kv_page_size')
        if not kv_leaves:
            raise ValueError('kv handoff carries no cache leaves')
        kv_leaves = [leaf if isinstance(leaf, torch.Tensor)
                     else torch.from_numpy(np.array(leaf))
                     for leaf in kv_leaves]
        n_kv = kv_leaves[0].shape[0]
        expect = -(-len(prompt_ids) // self._page_size)
        if n_kv != expect:
            raise ValueError(
                f'kv handoff page count {n_kv} does not cover the '
                f'{len(prompt_ids)}-token prompt (expected {expect} '
                f'pages of {self._page_size})')
        if n_kv > self._pages_per_slot:
            raise ValueError(
                f'kv handoff of {n_kv} pages exceeds this engine\'s '
                f'{self._pages_per_slot} pages per slot '
                f'(max_seq_len {self.model.cfg.max_seq_len})')
        # The payload must match this engine's pool exactly: leaf count,
        # per-page shape and dtype.  Rejected HERE it is a 422 to the
        # pusher; reaching the loop thread it would kill the engine.
        pool_leaves = self._wire_page_shapes()
        if len(kv_leaves) != len(pool_leaves):
            raise ValueError(
                f'kv handoff carries {len(kv_leaves)} cache leaves; '
                f'this engine\'s cache tree has {len(pool_leaves)} '
                f'(model mismatch between prefill and decode pools)')
        for i, (leaf, (want_shape, want_dtype)) in enumerate(
                zip(kv_leaves, pool_leaves)):
            if tuple(leaf.shape[1:]) != want_shape or \
                    leaf.shape[0] != n_kv:
                raise ValueError(
                    f'kv handoff leaf {i} has page shape '
                    f'{tuple(leaf.shape)}; this engine expects '
                    f'[{n_kv}, {", ".join(map(str, want_shape))}] '
                    f'(model mismatch between prefill and decode '
                    f'pools)')
            if leaf.dtype != want_dtype:
                raise ValueError(
                    f'kv handoff leaf {i} dtype {_dtype_name(leaf.dtype)} '
                    f'!= this engine\'s {_dtype_name(want_dtype)}')
        cache_len = self.model.cfg.max_seq_len
        if len(prompt_ids) + max_new_tokens > cache_len:
            max_new_tokens = cache_len - len(prompt_ids)
        if max_new_tokens < 1:
            raise ValueError(
                f'prompt of {len(prompt_ids)} tokens leaves no room '
                f'to decode (max_seq_len {cache_len})')
        req = Request(list(prompt_ids), max_new_tokens,
                      request_id=request_id)
        req.adopt = (int(first_token), kv_leaves)
        self._enqueue(req)
        return req

    def drain(self) -> None:
        """Run the pipelined loop until FULLY idle: queues empty, no
        active or chunk-prefilling request, nothing in flight."""
        while (self._inflight is not None or
               not self._prefill_q.empty() or
               not self._long_q.empty() or
               not self._adopt_q.empty() or
               self._ready_q or self._hit_q or self._adopt_ready or
               self._chunked is not None or
               any(s is not None for s in self._slots)):
            self.step_pipelined()

    # ----- weights lifecycle -------------------------------------------------
    def _stage(self, params: Mapping[str, torch.Tensor]) -> tuple:
        """A copy of `params` on the engine's device in the served dtypes,
        after checking that it names exactly the model's tensors at their
        shapes.  Always a copy, never an alias: an RL learner's optimizer
        goes on updating the caller's tensors in place.  The copies queue
        on the caller's stream; returns (tensors, an event after them on
        the card, else None).  Under a mesh the WHOLE tree is staged in
        host memory: it travels to every rank, one tensor at a time, at the
        install (`_install_broadcast`)."""
        served = self.model.state_dict(keep_vars=True)
        missing = sorted(set(served) - set(params))
        extra = sorted(set(params) - set(served))
        if missing or extra:
            raise ValueError(f'update_params: the new state dict lacks '
                             f'{missing} and has unknown {extra}')
        shapes = {name: tuple(t.shape) for name, t in served.items()}
        target = self.device
        if self._mesh is not None:
            from skypilot_tpu_torch.models.llama import param_shapes
            shapes, target = param_shapes(self.model.cfg), 'cpu'
        bad = [f'{name} {tuple(params[name].shape)} (served '
               f'{shapes[name]})' for name in served
               if tuple(params[name].shape) != shapes[name]]
        if bad:
            raise ValueError(f'update_params: wrong shapes: {bad}')
        with torch.no_grad():
            staged = {name: params[name].detach().to(
                device=target, dtype=t.dtype, copy=True)
                for name, t in served.items()}
        if self._mesh is not None:
            return staged, None
        ready = None
        if self.device.type == 'cuda':
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return staged, ready

    def update_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Swap the served weights WITHOUT draining (rolling weight
        refresh, the RL rollout/update alternation): double-buffered
        in-flight swap.  `params` is a state dict as `Llama(cfg, params)`
        takes it, on any device; a missing key, an extra key or a wrong
        shape is refused.  It is STAGED (copied onto the device) here,
        overlapping with live serving, and INSTALLED by the loop at its
        next dispatch boundary: copied into the served parameters' own
        storage (which the captured decode call reads), so every
        dispatch sees exactly one set of weights.  Calls already in
        flight finish on the old values (they are queued ahead of the
        copies); the first dispatch after the install, mid-request
        included, samples from the new weights.

        Called with no loop thread running (manual step()/RL
        alternation), the caller IS the dispatcher, so the install
        happens before this returns.

        Under a mesh (rank 0 only) `params` is the whole tree; rank 0's
        next announcement carries it to every rank, which keeps its
        slices."""
        self._check_leader('update_params')
        staged = self._stage(params)
        with self._params_lock:
            # Re-staged before install: the never-served copy's only
            # reference drops here and it frees at once.
            self._staged_params = staged
        if self._thread is None or not self._thread.is_alive():
            if self._mesh is not None:
                self._lead(_ACT_APPLY)
            else:
                self._install_staged()

    def _install_staged(self) -> None:
        """Dispatch-boundary half of update_params: copy the staged
        tensors into the served parameters on the engine's stream (after
        the staging copies, which may have queued on another stream);
        the staged copy joins the retiring list until the next sync.
        Under a mesh swaps install through rank 0's announcements
        (`_install_broadcast`), never here."""
        if self._mesh is not None:
            return
        with self._params_lock:
            staged, self._staged_params = self._staged_params, None
        if staged is None:
            return
        tensors, ready = staged
        stream = None
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
        with torch.no_grad():
            for name, param in self.model.state_dict(keep_vars=True).items():
                param.copy_(tensors[name])
        if stream is not None:
            # Freed early (nothing in flight), the memory is reused only
            # once this stream has run the copies.
            for t in tensors.values():
                t.record_stream(stream)
        self._retiring_params.append(tensors)
        if self._inflight is None:
            self._release_retiring()

    def _release_retiring(self) -> None:
        """Drop the engine's references to installed staged copies.
        Called right after the step's sync (which waits for the install's
        copies, queued before it) or, with nothing in flight, at the
        install itself: the double buffer lasts at most one loop
        iteration."""
        if self._retiring_params:
            self._retiring_params = []

    def prewarm(self) -> None:
        """Build the flash-forward kernel and the engine's call (the
        decode call, or under speculation the verify call; on the card:
        capture its CUDA graph) before taking traffic.  On the card it
        then arms the recompile sentinel: every call the engine will use
        is built, so a later build is a mid-traffic stall.  On the CPU
        nothing is captured and it does not arm, as the JAX engine's
        lazy-compile path does not (arm_recompile_sentinel()).  Under a
        mesh rank 0 has every rank prewarm."""
        self._lead(_ACT_PREWARM)
        self._prewarm()

    def _prewarm(self) -> None:
        with compile_telemetry.warmup():
            if self.device.type == 'cuda':
                cuda_fa.build()
            if self._spec_k:
                if self._verify_call is None:
                    self._verify_call = self._new_verify_call()
            elif self._decode_call is None:
                self._decode_call = self._new_decode_call()
        if self.device.type == 'cuda':
            compile_telemetry.arm()

    def _use_graph(self) -> bool:
        gloo = self._mesh is not None and self._mesh.backend == 'gloo'
        return (self.device.type == 'cuda' and not self._eager_decode and
                not gloo)

    def _new_decode_call(self) -> _DecodeCall:
        return _DecodeCall(self, use_graph=self._use_graph())

    def _new_verify_call(self) -> _VerifyCall:
        return _VerifyCall(self, use_graph=self._use_graph())

    def start(self):
        self._check_leader('start')
        self._thread = threading.Thread(target=self._loop,
                                        name='decode-engine', daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # ----- engine loop -------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f'prompt len {n} exceeds buckets')

    # ----- paged-KV host bookkeeping -----------------------------------------
    def _pages_needed(self, req: Request) -> int:
        """Pages this request is charged at admission: its WHOLE
        lifetime (prompt + full token budget), so mid-flight growth can
        never fail."""
        return -(-(len(req.prompt_ids) + req.max_new_tokens)
                 // self._page_size)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate n pages, LRU-evicting prefix-cache pages if the free
        list runs short.  None (and no partial allocation) when even
        eviction cannot cover it: the caller retries once slots
        retire."""
        pages = self._pool_alloc.alloc(n)
        if pages is None and self._radix is not None:
            freed = self._radix.evict(n - self._pool_alloc.free_pages)
            if freed:
                metrics_lib.inc_counter(
                    'skytpu_engine_prefix_cache_evicted_pages_total',
                    float(freed))
            pages = self._pool_alloc.alloc(n)
        return pages

    def _try_prefix_match(self, req: Request):
        """Match one request against the radix cache at its COMMIT point
        (admission / chunk pick), so a burst's later members hit pages its
        first member published.  A hit refs the matched pages for the
        request and counts the hit metrics; the match stops one token
        short of the prompt so a suffix is always left to prefill.
        Misses are counted by the caller when the request admits."""
        max_pages = (len(req.prompt_ids) - 1) // self._page_size
        n, pages = self._radix.match(req.prompt_ids, max_pages)
        if n:
            metrics_lib.inc_counter(
                'skytpu_engine_prefix_cache_hits_total')
            metrics_lib.inc_counter(
                'skytpu_engine_prefix_cache_tokens_total',
                float(n * self._page_size))
        return n, pages

    def _route_queued(self) -> None:
        """Drain submitted short prompts into the loop's ready queue
        (prefix classification happens at admission time)."""
        while True:
            try:
                req = self._prefill_q.get_nowait()
            except queue.Empty:
                return
            self._ready_q.append(req)

    def _pt(self) -> torch.Tensor:
        """Device copy of the page tables: one tensor for the engine's
        life (the decode graph reads it at its address), refreshed in
        place only when host bookkeeping changed.  The upload reads a
        snapshot, never the live host table the loop goes on mutating
        while the copy is in flight."""
        if self._pt_dirty:
            self._h2d_into(self._pt_device, self._page_tables.copy())
            self._pt_dirty = False
        return self._pt_device

    def _pt_row(self, pages: List[int]) -> np.ndarray:
        row = np.full((self._pages_per_slot,), TRASH_PAGE, np.int64)
        row[:len(pages)] = pages
        return row

    def _dispatch_decode(self):
        """Dispatch one decode (or, under speculation, verify) call;
        returns its output tensor, not yet synced."""
        if self._paged:
            self._pt()
        if self._spec_k:
            if self._verify_call is None:
                self._verify_call = self._new_verify_call()
            return self._verify_call(self, self._propose_drafts())
        if self._decode_call is None:
            self._decode_call = self._new_decode_call()
        return self._decode_call(self)

    def _propose_drafts(self) -> np.ndarray:
        """Host-side n-gram drafts [n_slots, k] for the next verify call:
        each active slot's draft continues the most recent earlier
        occurrence of its own tail n-gram.  Empty slots draft zeros
        against all-trash page tables; their counts are never read."""
        drafts = np.zeros((self.cfg.n_slots, self._spec_k), np.int64)
        for i, slot in enumerate(self._slots):
            if slot is None or slot.request is None:
                continue
            hist = slot.request.prompt_ids + slot.toks
            drafts[i] = _ngram_continuation(hist, self._spec_k)
        return drafts

    def _admit_group(self, bucket: int, group) -> None:
        """Dispatch ONE batched prefill+insert for all (slot, request,
        pages) triples of a bucket (pages None on the unpaged engine);
        does NOT sync: each first token is emitted from row 0 of the
        next decode call's output.  The group is padded to a power-of-two
        row count by replicating row 0."""
        n = len(group)
        padded_n = 1 << (n - 1).bit_length()
        tokens = np.zeros((padded_n, bucket), np.int64)
        lengths = np.zeros((padded_n,), np.int64)
        slots = np.zeros((padded_n,), np.int64)
        valid = np.zeros((padded_n,), np.int64)
        pt_rows = (np.full((padded_n, self._pages_per_slot), TRASH_PAGE,
                           np.int64) if self._paged else None)
        for j, (slot_id, req, pages) in enumerate(group):
            plen = len(req.prompt_ids)
            tokens[j, :plen] = req.prompt_ids
            lengths[j] = plen
            slots[j] = slot_id
            valid[j] = 1
            if pages is not None:
                pt_rows[j, :len(pages)] = pages
        tokens[n:] = tokens[0]
        lengths[n:] = lengths[0]
        slots[n:] = slots[0]
        if pt_rows is not None:
            pt_rows[n:] = pt_rows[0]
        t0 = time.perf_counter()
        self._cache, self._last_d, self._lens_d = self._prefill_insert(
            self._cache, self._last_d, self._lens_d, self._h2d(tokens),
            self._h2d(lengths), self._h2d(slots), self._h2d(valid),
            None if pt_rows is None else self._h2d(pt_rows))
        t1 = time.perf_counter()
        self.prefill_groups += 1
        for j, (slot_id, req, pages) in enumerate(group):
            self._slots[slot_id] = _Slot(req, len(req.prompt_ids),
                                         pages=pages)
            if self._paged:
                self._page_tables[slot_id] = pt_rows[j]
                self._pt_dirty = True
                if self._radix is not None:
                    # Publish the prompt's full pages at once: concurrent
                    # requests sharing the prefix hit from here on (the
                    # writes they gather are queued ahead of them).
                    n_full = len(req.prompt_ids) // self._page_size
                    if n_full:
                        self._radix.insert(
                            req.prompt_ids[:n_full * self._page_size],
                            pages[:n_full])
            if req.request_id is not None:
                # Host-side stamps only (the dispatch is async).
                # Spill-demoted requests recorded queue_wait on their
                # original hit path: never twice.
                if not req.no_prefix:
                    tracing.record_span(req.request_id,
                                        'engine.queue_wait',
                                        req.submitted_at, t0)
                tracing.record_span(req.request_id, 'engine.prefill',
                                    t0, t1, bucket=bucket, slot=slot_id,
                                    group=len(group))
                req.prefill_end_at = t1
        n_tokens = sum(len(r.prompt_ids) for _, r, _pg in group)
        with self._submit_lock:
            self._queued_tokens -= n_tokens
        metrics_lib.inc_counter('skytpu_engine_prefill_tokens_total',
                                float(n_tokens))
        if self._kv_quant:
            # Real (non-trash) pages quantized at this insert's scatter.
            metrics_lib.inc_counter(
                'skytpu_engine_kv_quant_pages_total',
                float(sum(len(pg) for _, _r, pg in group)))

    def _emit(self, req: Request, tok: int) -> None:
        req.emitted += 1
        req.out.put(tok)

    def _finished(self, slot: _Slot, tok: int) -> bool:
        return (tok == self.cfg.eos_id or
                slot.request.emitted >= slot.request.max_new_tokens)

    def _retire(self, slot_id: int, slot: Optional[_Slot] = None) -> None:
        slot = slot if slot is not None else self._slots[slot_id]
        slot.done = True
        req = slot.request
        req.finished_at = time.perf_counter()
        # Mean inter-token latency over the request's decode phase.
        if req.first_token_at is not None and req.emitted > 1:
            metrics_lib.observe_hist(
                metrics_lib.ENGINE_TPOT_FAMILY,
                (req.finished_at - req.first_token_at) /
                (req.emitted - 1))
        if req.request_id is not None:
            tracing.record_instant(
                req.request_id, 'engine.stream_end', req.finished_at,
                emitted=req.emitted,
                decode_s=(round(req.finished_at - req.first_token_at, 6)
                          if req.first_token_at is not None else None))
        if req.export and slot.pages is not None:
            # Stage the handoff BEFORE the terminating None (a caller
            # whose tokens() returned may read export_result at once),
            # and BEFORE this retire's page release: any later scatter
            # into the freed pages is queued behind the gather.
            self._dispatch_export(slot)
        req.out.put(None)
        if slot.pages is not None:
            self._release_slot_pages(slot)
            # Point the slot's table at trash so later decode calls cannot
            # scribble into pages a new owner holds, unless a handoff
            # successor already owns the row.
            if self._slots[slot_id] is slot:
                self._page_tables[slot_id] = TRASH_PAGE
                self._pt_dirty = True
        # Under handoff a successor may already occupy the index: only
        # clear the mapping when it still points at the finished slot.
        if self._slots[slot_id] is slot:
            self._slots[slot_id] = None

    def _release_slot_pages(self, slot: _Slot) -> None:
        """Retire-time page bookkeeping: donate the pages covering the
        finished sequence (prompt + generated tokens whose KV was written:
        every emitted token but the last fed a later step) to the radix
        cache, then drop this slot's references."""
        req = slot.request
        if self._radix is not None:
            usable = len(req.prompt_ids) + req.emitted - 1
            n_full = min(usable // self._page_size, len(slot.pages))
            if n_full > 0:
                seq = req.prompt_ids + slot.toks
                self._radix.insert(seq[:n_full * self._page_size],
                                   slot.pages[:n_full])
        self._pool_alloc.release(slot.pages)
        slot.pages = None

    def _dispatch_export(self, slot: _Slot) -> None:
        """Stage a prefill-role request's pages for transfer: ONE gather
        off the pool into new tensors, queued on the stream ahead of this
        retire's page release.  Only device tensors land on the Request;
        the HTTP layer copies them to the host on ITS thread."""
        req = slot.request
        t0 = time.perf_counter()
        leaves = self._export_pages(self._h2d(self._pt_row(slot.pages)))
        t1 = time.perf_counter()
        n_kv = -(-len(req.prompt_ids) // self._page_size)
        req.kv_export = {
            'leaves': leaves,
            'first_token': int(slot.toks[0]) if slot.toks else 0,
            'prompt_len': len(req.prompt_ids),
            'n_kv_pages': n_kv,
        }
        metrics_lib.inc_counter('skytpu_engine_kv_exports_total')
        if req.request_id is not None:
            tracing.record_span(req.request_id, 'engine.kv_export',
                                t0, t1, pages=n_kv)

    def _step_adopt(self) -> None:
        """Admit pending KV-handoff adoptions (decode role) into free
        slots: allocate the request's full-lifetime pages, scatter the
        transferred page stacks into them in one call, and seed the
        slot's last token and length.  Head-of-line on slot or page
        shortage."""
        if not self._paged:
            return
        while True:
            try:
                self._adopt_ready.append(self._adopt_q.get_nowait())
            except queue.Empty:
                break
        while self._adopt_ready:
            slot_id = next((i for i in range(self.cfg.n_slots)
                            if self._slots[i] is None), None)
            if slot_id is None:
                return
            req = self._adopt_ready[0]
            pages = self._alloc_pages(self._pages_needed(req))
            if pages is None:
                return
            self._adopt_ready.popleft()
            first_token, kv_leaves = req.adopt
            n_kv = kv_leaves[0].shape[0]
            if self._mesh is not None:
                # The payload holds every kv head: keep this rank's.
                r = self.model.tp.rank
                kv_leaves = [leaf.narrow(1, r * self._n_kv, self._n_kv)
                             for leaf in kv_leaves]
            t0 = time.perf_counter()
            # Full-height page stacks (pages_per_slot rows), as the JAX
            # engine keeps one compiled shape; rows past the transfer are
            # zeros and land in the trash page.
            padded = []
            for leaf in kv_leaves:
                buf = torch.zeros(
                    (self._pages_per_slot,) + tuple(leaf.shape[1:]),
                    dtype=leaf.dtype)
                buf[:n_kv] = leaf
                padded.append(self._h2d(buf))
            scatter_row = np.full((self._pages_per_slot,), TRASH_PAGE,
                                  np.int64)
            scatter_row[:n_kv] = pages[:n_kv]
            self._adopt_insert(padded, self._h2d(scatter_row), slot_id,
                               first_token, len(req.prompt_ids))
            t1 = time.perf_counter()
            self._slots[slot_id] = _Slot(req, len(req.prompt_ids),
                                         pages=pages)
            self._page_tables[slot_id] = self._pt_row(pages)
            self._pt_dirty = True
            if self._radix is not None:
                # Adopted prompt pages join the radix cache like locally
                # prefilled ones (full pages only).
                n_full = len(req.prompt_ids) // self._page_size
                if n_full:
                    self._radix.insert(
                        req.prompt_ids[:n_full * self._page_size],
                        pages[:n_full])
            metrics_lib.inc_counter('skytpu_engine_kv_adopts_total')
            if self._kv_quant:
                metrics_lib.inc_counter(
                    'skytpu_engine_kv_quant_pages_total', float(n_kv))
            if req.request_id is not None:
                tracing.record_span(req.request_id, 'engine.queue_wait',
                                    req.submitted_at, t0)
                tracing.record_span(req.request_id, 'engine.kv_adopt',
                                    t0, t1, slot=slot_id, pages=n_kv)
            req.prefill_end_at = t1

    def _admit_free(self, handoff: Optional[List[int]] = None) -> None:
        """Admit queued requests into free slots (grouped per bucket, one
        prefill dispatch per group).  ``handoff`` lists slot indices whose
        occupant is guaranteed to finish during the IN-FLIGHT decode call:
        their successors' prefill queues behind that call on the device."""
        free = [i for i in range(self.cfg.n_slots)
                if self._slots[i] is None]
        free += [i for i in (handoff or []) if self._slots[i] is not None]
        if free and self._final_insert_pending():
            # Reserve one slot for the active long prompt's final
            # chunk-insert, or sustained short traffic starves it.
            free.pop(0)
        by_bucket: Dict[int, list] = {}
        if self._paged:
            # Prefix-cache routing first, then admission charges PAGES:
            # a request admits only when its whole lifetime fits the pool
            # (evicting cached pages as needed).  Head-of-line on
            # allocation failure: retiring slots free pages in order.
            self._route_queued()
            while free and self._ready_q:
                req = self._ready_q[0]
                if self._radix is not None and not req.no_prefix:
                    n, pages = self._try_prefix_match(req)
                    if n:
                        # Hit: the suffix prefills through the chunk
                        # machinery against the gathered prefix.
                        self._ready_q.popleft()
                        self._hit_q.append((req, n, pages))
                        continue
                pages = self._alloc_pages(self._pages_needed(req))
                if pages is None:
                    break
                self._ready_q.popleft()
                if self._radix is not None and not req.no_prefix:
                    # A spill-demoted request already counted its hit.
                    metrics_lib.inc_counter(
                        'skytpu_engine_prefix_cache_misses_total')
                by_bucket.setdefault(
                    self._bucket(len(req.prompt_ids)), []).append(
                        (free.pop(0), req, pages))
        else:
            while free and not self._prefill_q.empty():
                try:
                    req = self._prefill_q.get_nowait()
                except queue.Empty:
                    break
                by_bucket.setdefault(
                    self._bucket(len(req.prompt_ids)), []).append(
                        (free.pop(0), req, None))
        for bucket, group in by_bucket.items():
            self._admit_group(bucket, group)

    def _final_insert_pending(self) -> bool:
        """True when the active chunked prefill has reached its final
        chunk and is waiting on a free slot to insert into (a pending
        prefix-cache hit counts: its suffix needs a slot just as soon)."""
        cp = self._chunked
        if cp is None:
            return bool(self._hit_q)
        return (len(cp.request.prompt_ids) - cp.offset
                <= self.cfg.prefill_buckets[-1])

    def _start_chunked(self) -> bool:
        """Activate the next request for the chunk machinery: a pending
        prefix-cache hit first (its matched pages gather into a seeded
        scratch and the prefill starts PAST the match), else the next
        long prompt (itself prefix-matched when the cache is on)."""
        matched, pages = 0, []
        if self._hit_q:
            req, matched, pages = self._hit_q.popleft()
        else:
            try:
                req = self._long_q.get_nowait()
            except queue.Empty:
                return False
            if self._radix is not None and not req.no_prefix:
                matched, pages = self._try_prefix_match(req)
                if not matched:
                    metrics_lib.inc_counter(
                        'skytpu_engine_prefix_cache_misses_total')
        if not matched:
            self._chunked = _ChunkedPrefill(req, self._make_cache(1))
            return True
        t0 = time.perf_counter()
        scratch = self._gather_prefix(self._cache,
                                      self._h2d(self._pt_row(pages)))
        t1 = time.perf_counter()
        offset = matched * self._page_size
        cp = _ChunkedPrefill(req, scratch, offset=offset,
                             shared_pages=pages)
        cp.last_chunk_end = t1
        self._chunked = cp
        rid = req.request_id
        if rid is not None:
            tracing.record_span(rid, 'engine.queue_wait',
                                req.submitted_at, t0)
            tracing.record_span(rid, 'engine.prefix_hit', t0, t1,
                                cached_tokens=offset, pages=matched)
        with self._submit_lock:
            self._queued_tokens -= offset
        return True

    def _spill_stuck_hits(self) -> None:
        """Release every pinned prefix match (the active seeded prefill
        and all waiting hits) and requeue the requests for FULL prefill.
        Only reachable when a final insert cannot allocate with zero live
        slots (a pool sized near its floor): progress wins over reuse."""
        cp = self._chunked
        if cp is not None and cp.shared_pages:
            self._pool_alloc.release(cp.shared_pages)
            # Restart from token zero with a fresh scratch next pick.
            self._chunked = None
            cp.request.no_prefix = True
            self._long_q.put(cp.request)
            with self._submit_lock:
                self._queued_tokens += cp.offset
        while self._hit_q:
            req, _n, pages = self._hit_q.popleft()
            self._pool_alloc.release(pages)
            req.no_prefix = True
            self._ready_q.appendleft(req)

    def _step_chunked(self) -> bool:
        """Dispatch at most ONE chunk of the active long-prompt (or
        prefix-hit) prefill, right after the decode dispatch, so decode is
        delayed by at most one chunk.  Intermediate chunks are
        largest-bucket-wide; the final chunk pads to the smallest fitting
        bucket, samples the first token and inserts the scratch into a
        free slot (waiting for one if none is free).  Returns True if a
        dispatch was made."""
        if self._chunked is None and not self._start_chunked():
            return False
        cp = self._chunked
        prompt = cp.request.prompt_ids
        rem = len(prompt) - cp.offset
        chunk = self.cfg.prefill_buckets[-1]
        rid = cp.request.request_id
        if rem > chunk:
            t0 = time.perf_counter()
            buf = np.zeros((1, chunk), np.int64)
            buf[0] = prompt[cp.offset:cp.offset + chunk]
            cp.scratch = self._prefill_chunk(cp.scratch, self._h2d(buf),
                                             cp.offset)
            t1 = time.perf_counter()
            if rid is not None:
                if cp.offset == 0 and not cp.request.no_prefix:
                    tracing.record_span(rid, 'engine.queue_wait',
                                        cp.request.submitted_at, t0)
                tracing.record_span(
                    rid, 'engine.prefill_chunk',
                    cp.last_chunk_end if cp.last_chunk_end is not None
                    else t0,
                    t1, offset=cp.offset, width=chunk, final=False)
            cp.last_chunk_end = t1
            cp.offset += chunk
            done = chunk
        else:
            slot_id = next((i for i in range(self.cfg.n_slots)
                            if self._slots[i] is None), None)
            if slot_id is None:
                return False             # all slots busy: retry later
            pages_all, n_shared, row = None, 0, None
            if self._paged:
                n_shared = len(cp.shared_pages)
                owned = self._alloc_pages(
                    self._pages_needed(cp.request) - n_shared)
                if owned is None:
                    if (self._inflight is None and
                            all(s is None for s in self._slots)):
                        # Nothing live can ever free a page: the pool is
                        # pinned by waiting prefix matches.  Drop them and
                        # fall back to full prefills.
                        self._spill_stuck_hits()
                    return False         # pool short: retry next iter
                pages_all = cp.shared_pages + owned
                row = self._pt_row(pages_all)
            bucket = self._bucket(rem)
            t0 = time.perf_counter()
            buf = np.zeros((1, bucket), np.int64)
            buf[0, :rem] = prompt[cp.offset:]
            self._cache, self._last_d, self._lens_d = self._chunk_insert(
                self._cache, self._last_d, self._lens_d, cp.scratch,
                self._h2d(buf), rem, cp.offset, len(prompt), slot_id,
                None if row is None else self._h2d(row))
            t1 = time.perf_counter()
            if rid is not None:
                tracing.record_span(
                    rid, 'engine.prefill_chunk',
                    cp.last_chunk_end if cp.last_chunk_end is not None
                    else t0,
                    t1, offset=cp.offset, width=bucket, final=True,
                    slot=slot_id)
                cp.request.prefill_end_at = t1
            self._slots[slot_id] = _Slot(cp.request, len(prompt),
                                         pages=pages_all,
                                         n_shared=n_shared)
            if self._paged:
                self._page_tables[slot_id] = row
                self._pt_dirty = True
                if self._radix is not None:
                    n_full = len(prompt) // self._page_size
                    if n_full:
                        self._radix.insert(
                            prompt[:n_full * self._page_size],
                            pages_all[:n_full])
            self._chunked = None
            done = rem
            if self._kv_quant:
                metrics_lib.inc_counter(
                    'skytpu_engine_kv_quant_pages_total',
                    float(len(pages_all)))
        with self._submit_lock:
            self._queued_tokens -= done
        metrics_lib.inc_counter('skytpu_engine_prefill_chunks_total')
        metrics_lib.inc_counter('skytpu_engine_prefill_tokens_total',
                                float(done))
        return True

    def _sample_perf(self) -> None:
        """Loop-thread device-cost gauges (perf/cost_model.py): pure
        host arithmetic over _process_rows' emit accumulators; no device
        state is touched, so attribution adds ZERO syncs (test-enforced).
        Windowed at perf_window_s so the idle 1 kHz loop does not
        recompute rates every millisecond."""
        cm = self._cost_model
        now = time.perf_counter()
        if self._perf_window is None:
            self._perf_window = (now, self._perf_tokens,
                                 self._perf_ctx_sum, self._perf_occ_sum)
            return
        t0, tok0, ctx0, occ0 = self._perf_window
        if now - t0 < self.perf_window_s:
            return
        d_tok = self._perf_tokens - tok0
        self._perf_window = (now, self._perf_tokens, self._perf_ctx_sum,
                             self._perf_occ_sum)
        if d_tok <= 0:
            # Idle window: utilization is genuinely zero; the modeled
            # bytes/intensity gauges keep their last value (they
            # describe the workload shape, not the rate).
            if self._perf_last is not None and self._perf_last['mfu']:
                self._perf_last = dict(self._perf_last, mfu=0.0)
                metrics_lib.set_gauge('skytpu_engine_mfu', 0.0)
            return
        rate = d_tok / (now - t0)
        # Token-weighted means over the window: each emitted token
        # contributed its slot's context length and its call's batch
        # size.
        mean_ctx = (self._perf_ctx_sum - ctx0) / d_tok
        mean_occ = max(1.0, (self._perf_occ_sum - occ0) / d_tok)
        mfu = cm.mfu(rate, mean_ctx)
        hbm_bytes = cm.decode_hbm_bytes_per_token(mean_ctx, mean_occ)
        intensity = cm.arith_intensity(mean_ctx, mean_occ)
        self._perf_last = {
            'mfu': mfu, 'hbm_bytes_per_token': hbm_bytes,
            'arith_intensity': intensity, 'tokens_per_s': rate,
            'mean_context': mean_ctx, 'mean_occupancy': mean_occ,
        }
        metrics_lib.set_gauge('skytpu_engine_mfu', mfu)
        metrics_lib.set_gauge('skytpu_engine_hbm_bytes_per_token',
                              hbm_bytes)
        metrics_lib.set_gauge('skytpu_engine_arith_intensity', intensity)

    def _sample_gauges(self, n_active: int) -> None:
        """Loop-thread occupancy/queue gauges; skipped when unchanged so
        the idle 1 kHz loop does not hammer the registry lock."""
        self._sample_perf()
        sample = (n_active,
                  self._prefill_q.qsize() + self._long_q.qsize() +
                  len(self._ready_q) + len(self._hit_q) +
                  self._adopt_q.qsize() + len(self._adopt_ready),
                  self._queued_tokens,
                  self._pool_alloc.free_pages if self._paged else -1,
                  self._radix.fingerprint
                  if self._radix is not None else None)
        if sample == self._last_gauges:
            return
        self._last_gauges = sample
        if self._paged:
            metrics_lib.set_gauge('skytpu_engine_kv_free_pages',
                                  float(sample[3]))
        if sample[4] is not None:
            metrics_lib.set_gauge('skytpu_engine_prefix_fingerprint',
                                  float(sample[4]))
        metrics_lib.set_gauge('skytpu_engine_active_slots', float(n_active))
        metrics_lib.set_gauge('skytpu_engine_batch_occupancy_ratio',
                              n_active / self.cfg.n_slots)
        metrics_lib.set_gauge('skytpu_engine_queue_depth', float(sample[1]))
        metrics_lib.set_gauge(metrics_lib.QUEUED_PREFILL_TOKENS_FAMILY,
                              float(max(sample[2], 0)))

    def step(self) -> int:
        """One SYNCHRONOUS engine iteration (admit + decode + process).
        Returns #active slots.  The serving loop uses step_pipelined
        (or this, under speculation)."""
        self._lead(_ACT_STEP)
        return self._step()

    def _step(self) -> int:
        self._install_staged()
        self._step_chunked()
        self._step_adopt()
        self._admit_free()
        active = [i for i in range(self.cfg.n_slots)
                  if self._slots[i] is not None]
        self._sample_gauges(len(active))
        if not active:
            self._release_retiring()
            return 0
        t0 = time.perf_counter()
        out = self._dispatch_decode()
        out = out.cpu().numpy()          # [T+1, B]: the ONE sync per step
        t1 = time.perf_counter()
        snapshot = {i: self._slots[i] for i in active}
        if self._spec_k:
            # The last row is the per-slot acceptance count m: rows 1..m
            # are committed tokens, rows past m rejected drafts.
            self._process_rows(out[:-1], snapshot, counts=out[-1],
                               verify_span=(t0, t1))
        else:
            self._process_rows(out, snapshot)
        self._release_retiring()
        return len(active)

    def step_pipelined(self) -> int:
        """One PIPELINED iteration: dispatch decode call k, THEN sync and
        process call k-1's output while k runs on the device, then admit
        into any slots k-1 freed (their prefills queue behind k).  A slot
        that finishes inside call k decodes garbage through call k+1
        (discarded by _process_rows' snapshot identity check).  A long
        prompt's chunked prefill dispatches at most one chunk per
        iteration, right behind the decode call.

        Staged weight swaps install at the TOP of the iteration, the
        dispatch boundary: the call dispatched below and everything after
        it run the new weights, and the staged copy is dropped right
        after the in-flight sync.

        Returns #slots active in the dispatched call plus any chunk
        dispatched (0 = fully idle and nothing in flight)."""
        if self._spec_k:
            # Speculation replaces pipelining: drafting call k before call
            # k-1's tokens land would draft from stale history.
            return self.step()
        self._lead(_ACT_PIPELINED)
        return self._step_pipelined()

    def _step_pipelined(self) -> int:
        self._install_staged()
        active = [i for i in range(self.cfg.n_slots)
                  if self._slots[i] is not None]
        self._sample_gauges(len(active))
        dispatched = None
        if active:
            out_d = self._dispatch_decode()
            dispatched = (out_d, {i: self._slots[i] for i in active})
        chunked = self._step_chunked()   # queues behind the decode call
        if self._inflight is not None:
            out_prev, snapshot = self._inflight
            self._inflight = None
            # The ONE fetch per step, one call late: syncs call k-1 while
            # call k runs.
            self._process_rows(out_prev.cpu().numpy(), snapshot)
        self._release_retiring()
        self._inflight = dispatched
        # Slots whose occupant will PROVABLY finish inside the call just
        # dispatched hand off to a successor with zero garbage calls.
        handoff = []
        if dispatched is not None:
            steps = self.cfg.steps_per_call
            for i, slot in dispatched[1].items():
                if self._slots[i] is not slot or slot.done:
                    continue
                rows_to_come = steps + (1 if slot.first_pending else 0)
                remaining = (slot.request.max_new_tokens -
                             slot.request.emitted)
                if remaining <= rows_to_come:
                    handoff.append(i)
        self._step_adopt()
        self._admit_free(handoff)
        return len(active) + (1 if chunked else 0)

    def _process_rows(self, out: np.ndarray, snapshot: Dict[int, _Slot],
                      counts: Optional[np.ndarray] = None,
                      verify_span: Optional[tuple] = None) -> None:
        """Emit one decode call's tokens to the slots captured at its
        DISPATCH time.  A slot whose occupant changed since (retired, or
        retired-and-readmitted under pipelining) is skipped by object
        identity: its rows are the bounded garbage of the one-call retire
        lag, never another request's tokens.

        ``counts`` (verify calls): the per-slot acceptance count m, so
        only rows 1..m are committed for slot i.  ``verify_span`` is the
        (dispatch, fetch) bracket of the engine.verify span."""
        now = time.perf_counter()
        emitted = 0
        spec_proposed = spec_accepted = 0
        for i, slot in snapshot.items():
            if slot.done:
                continue                 # retired earlier: rows are garbage
            limit = out.shape[0]
            if counts is not None:
                m = int(counts[i])
                limit = min(m + 1, out.shape[0])
                spec_proposed += self._spec_k
                spec_accepted += m - 1
                rid = slot.request.request_id
                if rid is not None and verify_span is not None:
                    tracing.record_span(
                        rid, 'engine.verify', verify_span[0],
                        verify_span[1], slot=i,
                        proposed=self._spec_k, accepted=m - 1)
            start = 0
            if slot.first_pending:
                slot.first_pending = False
                slot.request.first_token_at = now
                metrics_lib.observe_hist(
                    metrics_lib.ENGINE_TTFT_FAMILY,
                    now - slot.request.submitted_at)
                rid = slot.request.request_id
                if rid is not None:
                    tracing.record_span(
                        rid, 'engine.dispatch',
                        slot.request.prefill_end_at
                        if slot.request.prefill_end_at is not None
                        else slot.request.submitted_at,
                        now, slot=i)
                    tracing.record_instant(
                        rid, 'engine.first_token', now, slot=i,
                        batch=len(snapshot),
                        ttft_s=round(now - slot.request.submitted_at, 6))
            else:
                start = 1                # row 0 was emitted last step
            for t in range(start, limit):
                tok = int(out[t, i])
                slot.length += 1
                # Device-cost attribution: this token's context length
                # and call batch size (token-weighted accumulators
                # _sample_perf folds into the live gauges).
                self._perf_tokens += 1
                self._perf_ctx_sum += slot.length
                self._perf_occ_sum += len(snapshot)
                if slot.pages is not None:
                    # Retire donates prompt+generated pages (it needs the
                    # generated ids), and an export its first token.
                    slot.toks.append(tok)
                self._emit(slot.request, tok)
                emitted += 1
                if self._finished(slot, tok):
                    self._retire(i, slot)
                    break                # rest of this call's tokens: waste
        if emitted:
            metrics_lib.inc_counter('skytpu_engine_decode_tokens_total',
                                    float(emitted))
        if spec_proposed:
            metrics_lib.inc_counter(
                'skytpu_engine_spec_proposed_tokens_total',
                float(spec_proposed))
            metrics_lib.inc_counter(
                'skytpu_engine_spec_accepted_tokens_total',
                float(spec_accepted))
            metrics_lib.set_gauge('skytpu_engine_spec_acceptance',
                                  spec_accepted / spec_proposed)

    def _loop(self):
        while not self._stop.is_set():
            try:
                n = self.step_pipelined()
            except BaseException as e:  # pylint: disable=broad-except
                # A dead loop thread must not strand callers: fail every
                # in-flight and queued request and flip unhealthy (the
                # HTTP server's /health reports it).
                logger.exception('decode engine loop crashed')
                with self._submit_lock:
                    self.error = e
                    # Fail the in-flight snapshot FIRST: a handed-off
                    # slot's old occupant lives only there.
                    if self._inflight is not None:
                        for slot in self._inflight[1].values():
                            if not slot.done:
                                slot.done = True
                                slot.request.finished_at = \
                                    time.perf_counter()
                                slot.request.out.put(None)
                        self._inflight = None
                    for i, slot in enumerate(self._slots):
                        if slot is not None and not slot.done:
                            slot.done = True
                            slot.request.finished_at = time.perf_counter()
                            slot.request.out.put(None)
                        self._slots[i] = None
                    if self._chunked is not None:
                        cp, self._chunked = self._chunked, None
                        cp.request.finished_at = time.perf_counter()
                        cp.request.out.put(None)
                    for req in list(self._ready_q) + \
                            [h[0] for h in self._hit_q] + \
                            list(self._adopt_ready):
                        req.finished_at = time.perf_counter()
                        req.out.put(None)
                    self._ready_q.clear()
                    self._hit_q.clear()
                    self._adopt_ready.clear()
                    for pending in (self._prefill_q, self._long_q,
                                    self._adopt_q):
                        while True:
                            try:
                                req = pending.get_nowait()
                            except queue.Empty:
                                break
                            req.finished_at = time.perf_counter()
                            req.out.put(None)
                    # Under a mesh: submitted, not yet announced.
                    _fail_requests(self._inbox)
                    self._inbox = []
                    self._queued_tokens = 0
                return
            if n == 0:
                time.sleep(0.001)
