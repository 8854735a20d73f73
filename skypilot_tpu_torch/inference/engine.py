"""Continuous-batching decode engine, dense single-device path (PyTorch).

Twin of `skypilot_tpu/inference/engine.py` (mesh=None, unpaged): the same
host machinery over the same device contract.

- A fixed pool of decode *slots*; every decode call runs the whole
  [n_slots] batch for `steps_per_call` steps (a Python loop of eager
  steps on the device; CUDA graphs are later work).
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
  them, as the JAX engine donates their buffers.  Every decode call's
  output is a new tensor, so the pipelined loop reads call k-1's rows
  while call k runs.

Slot safety relies on the model cache's invariant (models/llama.py
_decode_attend): attention masks k_pos > q_pos, and inserts overwrite a
slot's whole cache, so a reused slot never leaks its previous request's
KV.

Not in this slice: paged KV / prefix caching, speculation, disaggregated
prefill/decode, tensor parallelism, `update_params` and the perf gauges.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.device import DeviceLike, device_of, resolve_device
from skypilot_tpu_torch.ops.cuda import flash_attention as cuda_fa
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

logger = sky_logging.init_logger(__name__)


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
    # Fields of later slices of the port; setting them raises.
    mesh: Optional[Any] = None
    kv_page_size: Optional[int] = None
    kv_pages: Optional[int] = None
    kv_dtype: str = 'bf16'
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

    def tokens(self) -> List[int]:
        """Drain: block until the request finishes, return all tokens."""
        toks = []
        while True:
            t = self.out.get()
            if t is None:
                return toks
            toks.append(t)


class _Slot:
    __slots__ = ('request', 'length', 'first_pending', 'done')

    def __init__(self, request: Request, length: int) -> None:
        self.request = request
        self.length = length              # prompt len + emitted (host view)
        # True until the prefill-sampled first token has been emitted (it
        # arrives as row 0 of the next decode call's output).
        self.first_pending = True
        # Finished (retired); lets a pipelined in-flight call's snapshot
        # tell a handed-off slot's remaining rows from retire-lag garbage.
        self.done = False


class _ChunkedPrefill:
    """Host state of one long prompt mid-chunked-prefill: the scratch
    cache accumulating its K/V and how far into the prompt it is."""
    __slots__ = ('request', 'scratch', 'offset', 'last_chunk_end')

    def __init__(self, request: Request, scratch) -> None:
        self.request = request
        self.scratch = scratch
        self.offset = 0          # prompt tokens already in the scratch
        # End stamp of the previous chunk dispatch, so the per-chunk spans
        # tile the whole chunked-prefill phase.
        self.last_chunk_end: Optional[float] = None


class DecodeEngine:
    """Slot-based continuous batching over a `models.llama.Llama`.

    `model.cfg.max_seq_len` bounds prompt+generation; the per-layer KV
    cache is [n_slots, n_kv_heads, max_seq_len, head_dim].  The model's
    parameters must live on `device` (default: the GPU; raises without
    one).
    """

    def __init__(self, model, config: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
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
        self._validate_config(config)
        # Buckets beyond the cache length can never be inserted; drop them
        # so submit() rejects oversized prompts up front.
        max_len = model.cfg.max_seq_len
        buckets = tuple(b for b in config.prefill_buckets if b <= max_len)
        if not buckets:
            buckets = (max_len,)
        config = dataclasses.replace(config, prefill_buckets=buckets)
        self.cfg = config
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
        # Prompt tokens accepted but not yet prefilled.  Writers hold
        # _submit_lock; the loop's gauge read is a bare int read.
        self._queued_tokens = 0
        # Batched prefill dispatches so far (one per admission group).
        self.prefill_groups = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_gauges: Optional[tuple] = None
        self.error: Optional[BaseException] = None
        self._init_cache()

    @property
    def healthy(self) -> bool:
        return self.error is None

    @staticmethod
    def _validate_config(config: EngineConfig) -> None:
        """Refuse the options whose machinery comes with later slices of
        the port, naming the slice."""
        if config.kv_dtype not in ('bf16', 'int8'):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {config.kv_dtype!r}")
        if config.mesh is not None:
            raise ValueError('EngineConfig.mesh: tensor-parallel serving '
                             'comes with the tensor-parallel serving slice')
        if config.kv_page_size is not None or config.kv_pages is not None:
            raise ValueError('EngineConfig.kv_page_size/kv_pages: the paged '
                             'KV cache comes with the paged-KV slice')
        if config.kv_dtype == 'int8':
            raise ValueError("EngineConfig.kv_dtype='int8': the int8 page "
                             'pool comes with the paged-KV slice')
        if config.speculation < 0:
            raise ValueError(f'speculation must be a non-negative draft '
                             f'length, got {config.speculation}')
        if config.speculation > 0:
            raise ValueError('EngineConfig.speculation: speculative decoding '
                             'comes with the paged-KV slice')

    # ----- device state ------------------------------------------------------
    def _make_cache(self, n: Optional[int] = None):
        """Zeroed per-layer (k, v) cache for `n` rows (default: the
        engine's slots; n=1: the chunked-prefill scratch)."""
        mcfg = self.model.cfg
        n = self.cfg.n_slots if n is None else n
        shape = (n, mcfg.n_kv_heads, mcfg.max_seq_len, mcfg.head_dim)
        return [(torch.zeros(shape, dtype=mcfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=mcfg.dtype, device=self.device))
                for _ in range(mcfg.n_layers)]

    def _init_cache(self):
        n = self.cfg.n_slots
        self._cache = self._make_cache()
        self._last_d = torch.zeros((n,), dtype=torch.long, device=self.device)
        self._lens_d = torch.zeros((n,), dtype=torch.long, device=self.device)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device without a sync (pinned, non-blocking), so
        admissions queue behind an in-flight decode call."""
        t = torch.from_numpy(arr)
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ----- device compute ----------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [..., V] f32 -> token ids [...] (greedy at temperature
        0, else a categorical draw from the engine's generator)."""
        temp = self.cfg.temperature
        if temp > 0.0:
            probs = torch.softmax(logits / temp, dim=-1)
            flat = probs.reshape(-1, probs.shape[-1])
            draw = torch.multinomial(flat, 1, generator=self._gen)
            return draw.reshape(probs.shape[:-1])
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def _prefill_insert(self, big_cache, last_toks, lens, tokens,
                           lengths, slots, valid):
        """Fused BATCHED prefill + slot insert: N prompts of one bucket,
        nothing synced.  tokens [N, P], lengths/slots/valid [N].  Padding
        rows replicate row 0 (`valid`=0)."""
        n, p = tokens.shape
        positions = torch.arange(p, device=self.device)[None, :].expand(n, p)
        logits, small = self.model(tokens, positions, decode=True)
        idx = (lengths - 1)[:, None, None].expand(n, 1, logits.shape[-1])
        last = torch.gather(logits, 1, idx)[:, 0]                 # [N, V]
        firsts = self._sample(last)                               # [N]
        # Padding rows replicate row 0, so their duplicate scatter writes
        # must carry row 0's VALUE too: which duplicate-index write wins
        # is unspecified.
        firsts = torch.where(valid.bool(), firsts, firsts[0])
        for (big_k, big_v), (k, v) in zip(big_cache, small):
            # The prefill cache is already full-length [N, H, max_len, D].
            big_k[slots] = k
            big_v[slots] = v
        last_toks[slots] = firsts
        lens[slots] = lengths
        return big_cache, last_toks, lens

    @torch.no_grad()
    def _decode(self, cache, last_tokens, lengths):
        """`steps_per_call` tokens for every slot.  Returns out [T+1,
        n_slots] (row 0 = the incoming last tokens), the cache (updated in
        place), and the new last tokens and lengths."""
        max_len = self.model.cfg.max_seq_len
        rows = [last_tokens.clone()]
        last, lens = last_tokens, lengths
        for _ in range(self.cfg.steps_per_call):
            # Clamp writes for slots running past the cap: confined to
            # slots being retired (their cache is re-inserted).
            positions = torch.clamp(lens, max=max_len - 1)[:, None]
            logits, _ = self.model(last[:, None], positions, decode=True,
                                   cache=cache)
            last = self._sample(logits[:, 0, :])
            rows.append(last)
            lens = lens + 1
        return torch.stack(rows), cache, last, lens

    @torch.no_grad()
    def _prefill_chunk(self, scratch, tokens, offset: int):
        """One INTERMEDIATE chunk of a long prompt: tokens [1, C] (all
        valid) land in the scratch cache at offset..offset+C and attend
        over everything before them."""
        c = tokens.shape[1]
        positions = torch.arange(offset, offset + c,
                                 device=self.device)[None, :]
        self.model(tokens, positions, decode=True, cache=scratch)
        return scratch

    @torch.no_grad()
    def _chunk_insert(self, big_cache, last_toks, lens, scratch, tokens,
                         length: int, offset: int, total_len: int,
                         slot: int):
        """FINAL chunk + slot insert: run the bucket-padded last chunk
        (`length` valid rows) against the scratch, sample the prompt's
        first token from its last valid row, and copy the scratch into
        `slot`.  Padding rows write garbage at positions >= total_len
        (masked until the decode writes overwrite them) or past the cache
        end (dropped)."""
        c = tokens.shape[1]
        positions = torch.arange(offset, offset + c,
                                 device=self.device)[None, :]
        logits, scratch = self.model(tokens, positions, decode=True,
                                     cache=scratch)
        first = self._sample(logits[:, length - 1])               # [1]
        for (big_k, big_v), (k, v) in zip(big_cache, scratch):
            big_k[slot].copy_(k[0])
            big_v[slot].copy_(v[0])
        last_toks[slot] = first[0]
        lens[slot] = total_len
        return big_cache, last_toks, lens

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

    def submit(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               request_id: Optional[str] = None) -> Request:
        limit = self.max_prompt_len
        if len(prompt_ids) > limit:
            raise ValueError(
                f'prompt len {len(prompt_ids)} exceeds max_prompt_len '
                f'{limit} (model max_seq_len '
                f'{self.model.cfg.max_seq_len})')
        cache_len = self.model.cfg.max_seq_len
        if len(prompt_ids) + max_new_tokens > cache_len:
            max_new_tokens = cache_len - len(prompt_ids)
        req = Request(list(prompt_ids), max_new_tokens,
                      request_id=request_id)
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        with self._submit_lock:
            if self.error is not None:
                raise RuntimeError(
                    f'decode engine is dead: {self.error!r}')
            # Prompts beyond the largest bucket take the chunked path.
            if len(req.prompt_ids) > self.cfg.prefill_buckets[-1]:
                self._long_q.put(req)
            else:
                self._prefill_q.put(req)
            self._queued_tokens += len(req.prompt_ids)
        metrics_lib.inc_counter('skytpu_engine_requests_total')

    def generate(self, prompt_ids: List[int],
                 max_new_tokens: int = 64) -> List[int]:
        """Synchronous helper: submit and wait."""
        return self.submit(prompt_ids, max_new_tokens).tokens()

    def prewarm(self) -> None:
        """Build the flash-forward kernel before taking traffic (there are
        no shapes to compile ahead: PyTorch runs eagerly)."""
        if self.device.type == 'cuda':
            cuda_fa.build()

    def start(self):
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

    def _admit_group(self, bucket: int, group) -> None:
        """Dispatch ONE batched prefill+insert for all (slot, request)
        pairs of a bucket; does NOT sync: each first token is emitted from
        row 0 of the next decode call's output.  The group is padded to a
        power-of-two row count by replicating row 0."""
        n = len(group)
        padded_n = 1 << (n - 1).bit_length()
        tokens = np.zeros((padded_n, bucket), np.int64)
        lengths = np.zeros((padded_n,), np.int64)
        slots = np.zeros((padded_n,), np.int64)
        valid = np.zeros((padded_n,), np.int64)
        for j, (slot_id, req) in enumerate(group):
            plen = len(req.prompt_ids)
            tokens[j, :plen] = req.prompt_ids
            lengths[j] = plen
            slots[j] = slot_id
            valid[j] = 1
        tokens[n:] = tokens[0]
        lengths[n:] = lengths[0]
        slots[n:] = slots[0]
        t0 = time.perf_counter()
        self._cache, self._last_d, self._lens_d = self._prefill_insert(
            self._cache, self._last_d, self._lens_d, self._h2d(tokens),
            self._h2d(lengths), self._h2d(slots), self._h2d(valid))
        t1 = time.perf_counter()
        self.prefill_groups += 1
        for slot_id, req in group:
            self._slots[slot_id] = _Slot(req, len(req.prompt_ids))
            if req.request_id is not None:
                # Host-side stamps only (the dispatch is async).
                tracing.record_span(req.request_id, 'engine.queue_wait',
                                    req.submitted_at, t0)
                tracing.record_span(req.request_id, 'engine.prefill',
                                    t0, t1, bucket=bucket, slot=slot_id,
                                    group=len(group))
                req.prefill_end_at = t1
        n_tokens = sum(len(r.prompt_ids) for _, r in group)
        with self._submit_lock:
            self._queued_tokens -= n_tokens
        metrics_lib.inc_counter('skytpu_engine_prefill_tokens_total',
                                float(n_tokens))

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
        req.out.put(None)
        # Under handoff a successor may already occupy the index: only
        # clear the mapping when it still points at the finished slot.
        if self._slots[slot_id] is slot:
            self._slots[slot_id] = None

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
        while free and not self._prefill_q.empty():
            try:
                req = self._prefill_q.get_nowait()
            except queue.Empty:
                break
            by_bucket.setdefault(self._bucket(len(req.prompt_ids)),
                                 []).append((free.pop(0), req))
        for bucket, group in by_bucket.items():
            self._admit_group(bucket, group)

    def _final_insert_pending(self) -> bool:
        """True when the active chunked prefill has reached its final
        chunk and is waiting on a free slot to insert into."""
        cp = self._chunked
        if cp is None:
            return False
        return (len(cp.request.prompt_ids) - cp.offset
                <= self.cfg.prefill_buckets[-1])

    def _step_chunked(self) -> bool:
        """Dispatch at most ONE chunk of the active long-prompt prefill
        (right after the decode dispatch, so decode is delayed by at most
        one chunk).  Intermediate chunks are largest-bucket-wide; the
        final chunk pads to the smallest fitting bucket, samples the first
        token and inserts the scratch into a free slot (waiting for one if
        none is free).  Returns True if a dispatch was made."""
        if self._chunked is None:
            try:
                req = self._long_q.get_nowait()
            except queue.Empty:
                return False
            self._chunked = _ChunkedPrefill(req, self._make_cache(1))
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
                if cp.offset == 0:
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
            bucket = self._bucket(rem)
            t0 = time.perf_counter()
            buf = np.zeros((1, bucket), np.int64)
            buf[0, :rem] = prompt[cp.offset:]
            self._cache, self._last_d, self._lens_d = self._chunk_insert(
                self._cache, self._last_d, self._lens_d, cp.scratch,
                self._h2d(buf), rem, cp.offset, len(prompt), slot_id)
            t1 = time.perf_counter()
            if rid is not None:
                tracing.record_span(
                    rid, 'engine.prefill_chunk',
                    cp.last_chunk_end if cp.last_chunk_end is not None
                    else t0,
                    t1, offset=cp.offset, width=bucket, final=True,
                    slot=slot_id)
                cp.request.prefill_end_at = t1
            self._slots[slot_id] = _Slot(cp.request, len(prompt))
            self._chunked = None
            done = rem
        with self._submit_lock:
            self._queued_tokens -= done
        metrics_lib.inc_counter('skytpu_engine_prefill_chunks_total')
        metrics_lib.inc_counter('skytpu_engine_prefill_tokens_total',
                                float(done))
        return True

    def _sample_gauges(self, n_active: int) -> None:
        """Loop-thread occupancy/queue gauges; skipped when unchanged so
        the idle 1 kHz loop does not hammer the registry lock."""
        sample = (n_active,
                  self._prefill_q.qsize() + self._long_q.qsize(),
                  self._queued_tokens)
        if sample == self._last_gauges:
            return
        self._last_gauges = sample
        metrics_lib.set_gauge('skytpu_engine_active_slots', float(n_active))
        metrics_lib.set_gauge('skytpu_engine_batch_occupancy_ratio',
                              n_active / self.cfg.n_slots)
        metrics_lib.set_gauge('skytpu_engine_queue_depth', float(sample[1]))
        metrics_lib.set_gauge(metrics_lib.QUEUED_PREFILL_TOKENS_FAMILY,
                              float(max(sample[2], 0)))

    def _dispatch_decode(self):
        out, self._cache, self._last_d, self._lens_d = self._decode(
            self._cache, self._last_d, self._lens_d)
        return out

    def step(self) -> int:
        """One SYNCHRONOUS engine iteration (admit + decode + process).
        Returns #active slots.  The serving loop uses step_pipelined."""
        self._step_chunked()
        self._admit_free()
        active = [i for i in range(self.cfg.n_slots)
                  if self._slots[i] is not None]
        self._sample_gauges(len(active))
        if not active:
            return 0
        out = self._dispatch_decode()
        out = out.cpu().numpy()          # [T+1, B]: the ONE sync per step
        snapshot = {i: self._slots[i] for i in active}
        self._process_rows(out, snapshot)
        return len(active)

    def step_pipelined(self) -> int:
        """One PIPELINED iteration: dispatch decode call k, THEN sync and
        process call k-1's output while k runs on the device, then admit
        into any slots k-1 freed (their prefills queue behind k).  A slot
        that finishes inside call k decodes garbage through call k+1
        (discarded by _process_rows' snapshot identity check).  A long
        prompt's chunked prefill dispatches at most one chunk per
        iteration, right behind the decode call.

        Returns #slots active in the dispatched call plus any chunk
        dispatched (0 = fully idle and nothing in flight)."""
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
        self._admit_free(handoff)
        return len(active) + (1 if chunked else 0)

    def _process_rows(self, out: np.ndarray,
                      snapshot: Dict[int, _Slot]) -> None:
        """Emit one decode call's tokens to the slots captured at its
        DISPATCH time.  A slot whose occupant changed since (retired, or
        retired-and-readmitted under pipelining) is skipped by object
        identity: its rows are the bounded garbage of the one-call retire
        lag, never another request's tokens."""
        now = time.perf_counter()
        emitted = 0
        for i, slot in snapshot.items():
            if slot.done:
                continue                 # retired earlier: rows are garbage
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
            for t in range(start, out.shape[0]):
                tok = int(out[t, i])
                slot.length += 1
                self._emit(slot.request, tok)
                emitted += 1
                if self._finished(slot, tok):
                    self._retire(i, slot)
                    break                # rest of this call's tokens: waste
        if emitted:
            metrics_lib.inc_counter('skytpu_engine_decode_tokens_total',
                                    float(emitted))

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
                    for pending in (self._prefill_q, self._long_q):
                        while True:
                            try:
                                req = pending.get_nowait()
                            except queue.Empty:
                                break
                            req.finished_at = time.perf_counter()
                            req.out.put(None)
                    self._queued_tokens = 0
                return
            if n == 0:
                time.sleep(0.001)
