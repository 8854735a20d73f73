#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line), each
followed by its seconds:

1. Device: the card's name, name + power limit from nvidia-smi, and its
   memory as torch.cuda.mem_get_info reads it once this process holds a
   one-rank NCCL group (checked against validate.py in phase 15).
2. Build: nvcc compiles every kernel source in skypilot_tpu_torch/csrc/
   for sm_90a (one process per source, in parallel) and links them into
   one library under build/skypilot_tpu_torch/; ptxas reports registers,
   shared memory and spills, and any spill store (or a setmaxnreg that
   ptxas ignored) fails the run.
3. Kernels: each kernel against its plain PyTorch version on the card:
   the forward at the serving path's shapes (MoE tensor=2 rank and the
   graft entry's too), then the forward, dq and
   dk/dv at the training path's (bench-1b, llama-250m, llama2-7b, a
   non-causal, a ragged fp16 case, S=32 and S=320, the RL loop's S=36
   and S=8 at head_dim 64, the MoE training step's and one rank's of the
   sharded training phase's fsdp=2, tensor=2 and NCCL runs, one
   pipeline microbatch's); then CUDA-event
   times of each kernel (and its TFLOP/s), its plain version and the
   library call (SDPA; beside its backward also the port's dq + dk/dv
   sum), next to the roofline bound, at the llama2-7b prefill
   shape (forward, also with the L2 flushed before each call) and the
   bench-1b training shape (forward, dq, dk/dv), and one profiled launch
   of each (registers per thread and shared memory as launched); the
   same times at the MoE prefill shape (forward) and the MoE training
   shape (forward, dq, dk/dv; GQA group 4).  Then the small-head-dim
   forward (head_dim 16 and 32: csrc/flash_attention_fwd_small.cu) at
   the perf gate probe's shapes (SMALL_SHAPES: S = 8, 16, 128, causal
   and not, bf16 and fp16, and head_dim 32 at one shape) against its
   plain version (out within SMALL_ATOL beyond one output ulp, lse
   within SMALL_ATOL), timed with its plain version and SDPA at S=16.
3b. Small backward: the head_dim 16/32 dq and dk/dv
   (csrc/flash_attention_bwd_{dq,dkv}_small.cu) against their plain
   versions at the small forward's tile-edge grid (SMALL_BWD_SHAPES: S =
   1-129 on both sides of the 64-row tiles, head_dim 16 and 32, bf16 and
   fp16, causal and not, GQA 4 -> 2 and 4 -> 4, and (1, 8, 2, 1024,
   16)): norm-rel <= BWD_NORM_RTOL (an output that is 0 in exact
   arithmetic within SMALL_BWD_ZERO_ATOL), each call launching its small
   kernel exactly once; then the three small kernels, their plain
   versions and SDPA timed at `tiny`'s training shape (TINY_TRAIN_SHAPE)
   beside the bounds, one profiled launch each.
3b'. Head dims (HEAD_DIM_*): every head_dim up to 256 on a CUDA tensor.
   (a) the forward (out, lse), dq and dk/dv at head_dims 8, 24, 48, 72,
   80, 96, 100, 112, 160, 200 and 256 (S = 1, 17, 63, 64, 65, 129, 1000;
   GQA groups 1, 4, 8; causal and not; bf16, fp16 too at 96 and 256)
   against their plain versions under the kernel phase's gates, each
   call launching the kernel of its head_dim's width exactly once (the
   wide mma.sync kernels at 80/96, csrc/flash_attention_*_wide.cu; the
   three at 256 on the wgmma kernels
   csrc/flash_attention_{fwd,bwd_dq,bwd_dkv}_256.cu; the other head_dims
   zero-padded to the next width, counted on the public wrapper's
   padded_launches), head_dim 257 refused; then, at Gemma-2B's training
   and serving shapes (where dk/dv at 256 splits its grid), two calls of
   dq and dk/dv at 256 bit for bit; (b) the wide kernels and those at
   256, their plain versions and SDPA timed beside the bounds at Phi-2's,
   Phi-3-mini's, Gemma-2B's and Gemma-7B's attention shapes at B=2 x 4096
   and B=8 x 256 (with the forward against SDPA's forward and dq + dk/dv
   against SDPA's backward at Gemma's),
   at Gemma-2B's dk/dv at 256's main kernel and its partials' reduce
   apart (torch.profiler), and at Phi-3-mini's the padded route 96 ->
   128 (the wgmma kernels on zero-padded inputs); one profiled launch
   each; (c) Llama blocks at Phi-3-mini's and Gemma-2B's widths, 2
   layers, random weights from SEED: the dense engine (graph decode)
   serves 4 prompts of 219 ids, 16 greedy tokens, with exact launches
   per kernel and route and prefill logits within LOGITS_RTOL of
   attention_impl='xla'; Trainer.run takes 3 steps at 2 x 2048 with
   exact launches, then the gradient check of phase 8.
3b''. f32 (F32_*): the three kernels on f32 inputs, the mma.sync family in
   3xTF32 (csrc/flash_attention_*_f32.cu, *_f32_wide.cu) at every width.
   (a) `probe check f32`'s 377 cases (the JAX tests' Pallas shapes, every
   native f32 width at S one short of and one past its tiles, GQA 1, 4
   and 8, causal and not, head_dims 8-200 through the padded route)
   against the plain versions in full f32 (TF32 matmuls off): out and
   lse within 5e-5 + 5e-5*|ref|, dq, dk, dv norm-rel 5e-5, each call
   launching its f32 kernel once; f64 and head_dim 257 refused; (b) the
   three timed at the f32 serving (8, 32, 32, 256, 128), tensor_serving
   (c)'s per-rank (8, 16, 16, 256, 128) and training (2, 16, 8, 4096,
   128) shapes beside their plain versions, each held to them there
   under (a)'s gates, SDPA in f32 (the kernel it ran named) and the f32
   bounds (4-byte elements, TF32's 495 TFLOP/s); one profiled launch
   each.
3c. Sync audit (SYNC_AUDIT): first which synchronizing forms
   torch.cuda.set_sync_debug_mode('warn') reports on this torch (.item(),
   .cpu(), .tolist(), torch.cuda.synchronize(), .nonzero(), a pinned
   non_blocking copy and others; printed, caught and missed); then
   `tiny` (max_seq_len 128, 2 slots, buckets 8 and 16) under it: the
   dense engine with the graph decode through step_pipelined over the
   perf-gate probe's traffic (6 requests of 8 ids, 8 new tokens), the
   int8-paged engine with n-gram speculation k = 4 (the verify graph),
   and Trainer.run at 4 x 128 for 10 steps, log_every=5.  Each
   synchronizing call is attributed to its step and to the innermost
   line of the port in the warning's stack.  Gates: exactly one sync per
   active engine step, at the engine's annotated fetch, none on an idle
   step; none on the trainer's non-log steps; every line seen is a site
   the static analyzer (`python -m skypilot_tpu_torch.analysis`,
   hot-loop-sync) reports, suppressed with a reason.  Prints
   `sync_audit {...}` (counts per step and per line, the probe).
3d. Launch (LAUNCH): the port's launch path with a temporary HOME:
   execution.launch of a local cluster asking for H100:1 (the port's
   head agent, which imports neither torch nor JAX), job A serving
   llama3-1b whole (bf16 from seed 0, the engine built from the
   server's flags) on 4 prompts of the serving cell's lengths, each
   alone, 16 greedy tokens: SUCCEEDED, flash forward launches > 0, the
   gang's SKYTPU_NODE_RANK=0, _NUM_NODES=1, _NUM_TPU_CHIPS=1; job B,
   exec_ of `python -m skypilot_tpu_torch.inference.server` with the
   same flags: two of the prompts over HTTP one at a time give job A's
   ids and usage, then core.cancel (CANCELLED, its port closed);
   core.down (record gone, agent exited, free card memory back within
   1 GB); the same engine in this process gives job A's tokens.
   Prints the phase's seconds and its split.
3d'. API server (API_SERVER): with a temporary HOME, `python -m
   skypilot_tpu_torch.server.app` on a free port as a process of its own
   (a marker in its environment); over REST through the port's SDK,
   sdk.launch of job A's task onto a local cluster asking for H100:1
   (the request runs in the server's request worker, which runs the
   port's execution.launch), sdk.get, sdk.queue until SUCCEEDED, job A's
   JSON line read through the logs route: its tokens equal the launch
   phase's, its flash launches the launch phase's (48 forward: 3 chunk
   groups x 16 layers; no backward); `skytpu-torch status` (the CLI, a
   subprocess) lists the cluster UP; sdk.down removes it, the card's
   memory comes back; SIGTERM to the server closes its port and leaves
   no process with the marker.  Prints each step's seconds.
3e. Managed job (MANAGED_JOB): with a temporary HOME, jobs.launch of a
   task on a local cluster asking for H100:1 that trains bench-1b at
   full width, 2 of its 14 layers, batch 2 x 4096, 20 steps with a
   checkpoint every 5 (Trainer with checkpoint_dir, restore_if_available,
   its goodput phases under the managed job's id).  After the checkpoint
   of step 10 the first attempt's data blocks; the phase kills the
   cluster's processes (agent and job, as a lost VM would) and marks the
   node preempted (inject_preemption).  Gates: statuses RUNNING ->
   RECOVERING -> RUNNING -> SUCCEEDED, one recovery; the recovered
   attempt restored step 10, its losses at steps 11-20 within
   MANAGED_LOSS_RTOL of an uninterrupted 20-step run in this process,
   its launches exact (10 steps of 2 layers); the goodput ledger holds
   productive, checkpoint_save, checkpoint_restore, preemption_downtime
   and recovery_relaunch for the job, the downtime ending where the
   relaunch starts; `jobs top`'s frame shows the recovery; the cluster
   gone and the card's memory back.
3f. Serve (SERVE_SERVICE): with a temporary HOME, serve.up of one local
   replica asking for H100:1, the replica the port's HTTP app over
   LAUNCH's engine (serve_replica), behind the port's load balancer;
   LAUNCH's HTTP prompts through the LB one at a time: ids and usage
   equal to job A's, the LB's trace of each request holds lb.admission
   and lb.route; the replica's launches read from its log
   (serve.tail_replica_logs), n_layers per prompt within the largest
   bucket; serve.down: SHUTDOWN, the replica's cluster gone, the LB's
   port closed, the card's memory back once the replica's process (which
   serve.down leaves, as core.down leaves jobs) is killed.
3g. SSH node pool (SSH_POOL): with a temporary HOME, job A on a host of
   an SSH node pool, inside a Docker runtime, its weights read from a
   MOUNTed bucket.  The card machine has no network and no ssh, rsync
   or docker, so the phase puts PATH shims for those three CLIs in its
   own directory (printed): `ssh` runs the remote command here in the
   remote HOME without the caller's PYTHONPATH and makes `-N -L` a real
   TCP forward, `rsync` copies locally, `docker` logs its argv and runs
   `exec` here.  The pool (SKYTPU_SSH_NODE_POOLS_FILE) holds one host,
   a loopback address whose `port` is a TCP listener the phase holds
   (the provisioner's liveness probe), with the current user and the key
   authentication.get_or_generate_keys made.  llama3-1b's seed-0 bf16
   params are saved into gs://smoke-weights/llama3-1b of a fake-GCS root
   (SKYTPU_FAKE_GCS_ROOT) through CheckpointManager; execution.launch of
   job A's task with `infra: ssh/smoke-pool`, H100:1, `image_id:
   docker:...`, a storage mount of the bucket and `--checkpoint` at the
   mount.  Gates: the optimizer's placement and the pool's allocation;
   the remote bootstrap's agent running from ~/skytpu_runtime; the
   docker shim's pull, `run -d --gpus all` and each rank's exec carrying
   the rank env; the job SUCCEEDED with the launch phase's tokens and
   launches, its kernels built into the runtime copy's own build/ (the
   build's seconds printed); core.down releasing the host, the agent
   (which down leaves on a BYO host) stopped, the listener closed and
   the card's memory back.
3h. Bucket relay (BUCKET_RELAY): with a temporary HOME, llama3-1b's
   seed-0 bf16 params saved into gs://smoke-relay/llama3-1b of a
   fake-GCS root, relayed to s3://smoke-relay/llama3-1b of a fake-S3
   root by data/transfer.py (down into a staging directory, up from it;
   seconds and GB/s printed): every file's sha256 equal on both sides,
   the staging directory gone; job A on a local cluster asking for
   H100:1 with the S3 bucket MOUNTed as its weights (`--checkpoint` at
   the mount): its tokens and launches the launch phase's; core.down,
   the agent exited, the card's memory back.
4. Serving: llama2-7b at full width, 8 of its 32 layers (SERVE; bf16
   random weights from a seed) behind the port's HTTP app on a local port, 8 prompts of 219
   tokens plus one of 300 (chunked prefill), 32 new tokens each; every
   response checked; kernel launch counts read around this run; prefill
   logits through the kernel held against attention_impl='xla'.  The
   engine's decode call is a CUDA graph (captured at prewarm).  The perf
   plane: the burst is served twice, first under a PROFILE_MS
   /debug/profile capture (200, its artifact fetched through the
   artifact route, its trace holding the flash forward kernel and the
   decode graph's kernels; a second capture sent meanwhile gets 409;
   the burst's rate under the capture printed), then alone, the
   measured run: the live gauges read from /metrics (skytpu_engine_mfu,
   _hbm_bytes_per_token, _arith_intensity) within PERF_GAUGE_RTOL of the
   cost model at its measured rate and mean context, with
   perf_snapshot() and the decode roofline printed; then the strict
   recompile sentinel tripped by a decode call built after prewarm.
   From here through the MoE serving phase SKYTPU_STRICT_RECOMPILE=1:
   every engine is prewarmed, and its traffic must build nothing (no
   counted build, no perf.recompile event).
5. Paged serving, over the same prompts and the first 8 of the serving
   weights' 8 layers (PAGED): the dense
   and the 64-token-paged engine on the engine API, each with its decode
   call as a CUDA graph and eager (identical tokens all four ways; out-
   tok/s, TTFT p50 and one profiled decode call each, its decode-only
   rate as a share of the cost model's roofline; one flash launch per
   layer and prefill group, counted around the paged graph run),
   a prefix-hit burst (8 requests sharing a 3-page prefix; the hit
   counters exact), int8 pages (within half a quantization step plus one
   bf16 ulp of the bf16 pages; pool bytes, whose int8/bf16 ratio the cost
   model's bytes per position must equal), speculation with k = 4 on bf16
   and int8 pages, the verify call as a CUDA graph and eager (identical
   tokens and acceptance counters; CUDA-event ms per verify call, capture
   seconds, out-tok/s), and the KV handoff prefill -> bytes -> decode
   (identical to a monolithic paged run); every hit, int8 and
   speculative token within LOGITS_RTOL of the argmax of a teacher-forced
   forward through the kernel.
6. Checkpoint: the serving weights saved through the port's
   CheckpointManager into a bucket of a fake-GCS root
   (SKYTPU_FAKE_GCS_ROOT), restored by the server's build_model with
   --checkpoint and --param-dtype bfloat16 from the local path and from
   gs:// (fetched to a temp directory, which must be gone afterwards),
   both bit-equal to the in-memory weights; the local restore served
   over HTTP (tokens equal to the in-memory model's), the gs:// restore
   on the engine API (tokens equal to the local one's); then a
   sentinel lm_head installed with update_params mid-request under the
   graph (every later token a sentinel, none before).
6b. Tensor-parallel serving (TENSOR), over the serving weights and
   prompts: (a) two gloo ranks on cuda:0 print which of all_reduce,
   broadcast and all_gather_into_tensor gloo runs on bf16, f32 and int8
   CUDA tensors (those the phase's model runs must work); (b) the
   serving phase's llama2-7b over tensor=2, both ranks on the one
   card, each holding its slices from the same seed: the first-step
   logits of the 8 prompts bit-identical to one device computing the
   same arithmetic (o/down as bf16 half products added in bf16) and
   within LOGITS_RTOL of the plain
   one-device model (relative to its max |logit|; one device's
   flash-vs-xla distance printed beside it), then
   the dense and the 64-token-paged engine
   (eager: gloo syncs the host) on the serving cell's traffic, every
   rank's tokens equal to rank 0's, greedy agreement with the one-device
   engine printed, one flash launch per layer and prefill group on rank
   0; (c) the model (4 layers) in f32 through the f32 kernels: tokens
   identical to the one-device engine (also through them), one f32
   forward per layer and prefill group on rank 0, one device's prefill
   logits within F32_LOGITS_RTOL of attention_impl='xla'; (d) tensor=1 over
   a one-rank NCCL group in this process: the decode call a CUDA graph with its
   collectives, tokens identical to the mesh-free engine; (e) the flash
   forward at one rank's prefill shape (TP_SHAPE) against its plain
   version, timed beside its bound.  Each rank's peak memory printed.
7. MoE serving (MOE_SERVE, examples/train_moe_expert_parallel.yaml:20):
   llama3-1b with 8 experts at full width, 8 of its 16 layers (3.568B
   params, bf16 from a seed) on the engine API with the serving phase's
   traffic, dense with the decode call as a graph and eagerly, and paged
   (64-token pages) as a graph: tokens identical all three ways, exactly
   8 flash launches per prefill group, every id in the vocabulary; out-
   tok/s, TTFT p50, prewarm seconds and one profiled decode call each;
   the share of (token, expert) choices the prefill group drops at
   capacity; the prefill logits through the kernel held against
   attention_impl='xla' on the tokens whose routing agrees in every
   layer (the share that flips is printed, not gated).
8. Training: bench-1b at full width and depth (f32 params, bf16 compute,
   remat 'none') through Trainer.run at batch 4, seq 4096, as a managed
   job's trainer (SKYTPU_GOODPUT_JOB set, SKYTPU_JOBS_DB a sqlite file of
   a temp directory, SKYTPU_DB_URL unset): 2 untimed and 8 timed steps,
   then the durable goodput ledger's totals equal to the recorder's
   within LEDGER_ATOL_S, productive seconds > 0 and its interval rows
   tiling the run; launch counts read around the timed steps (2 forward,
   1 dq and 1 dk/dv launch per layer per step), step time, tokens/s, MFU
   and peak memory; then one step's loss and gradients at batch 1
   through the kernels against the same step with the backward kernels'
   plain versions (same forward) and against attention_impl='xla', on
   the same weights, and one step traced with torch.profiler.  Then
   the MoE model (MOE_TRAIN) at full width, 4 of its 16 layers, remat
   'none', batch 2 x 2048, 2 untimed and 4 timed steps, the same launch
   counts and numbers (MFU counts all experts, 6N, as the JAX package
   does), and its gradients against the plain backward; against xla
   reported only (its rounding may flip a routing choice).
8a. f32 training (F32_TRAIN, bench.py:58-115): bench-1b at full width,
   2 of its 14 layers, f32 params and compute, 3 Trainer.run steps at
   2 x 4096, first with attention_impl='xla' (then freed), then through
   the f32 kernels on the same weights and batch: exactly 2 f32 forwards
   (remat), 1 dq and 1 dk/dv per layer and step, nothing else; each
   step's loss within F32_LOSS_RTOL of xla's; one step's gradients
   within F32_GRAD_RTOL of the plain backward on every tensor (and each
   attention backward on its own inputs), within F32_XLA_GRAD_RTOL of
   xla's.
8b. Tiny training (TINY_TRAIN, bench.py:64-67): `tiny` (head_dim 16)
   through Trainer.run at B=4 x S=64 and S=128, 2 untimed and 5 timed
   steps each: the small forward, dq and dk/dv launched exactly n_layers
   times a step and no wgmma kernel, finite losses, step time; the
   gradient check of phase 8 (against the plain backward and, gated,
   against attention_impl='xla') and one profiled step.
9. RL (RL, examples/train_rl_reinforce.yaml): llama-250m at full width
   and depth, 3 iterations of rollout (the engine's graph, temperature
   1) -> REINFORCE step (forward, dq, dk/dv kernels) -> update_params,
   exact launches per iteration, finite losses, the engine's params
   bit-equal to the learner's, one step's gradients against the plain
   backward; then the three kernels timed at the REINFORCE shape.
10. Zoo (ZOO): bert-tiny (B=32, S=512) and resnet50 (B=64, 224 x 224 x 3
   NHWC), a train-mode forward and a backward each, timed; finite
   gradients, ResNet's running averages updated, bf16 logits within
   ZOO_LOGITS_RTOL of the same weights in f32.
   After the MoE serving phase the build telemetry's counts and seconds
   (kernel build, decode and verify captures) are printed and the
   sentinel disarmed.
11. Sharded training (SHARDED, examples/train_llama_fsdp.yaml's
   llama3-1b at full width, 8 of its 16 layers, f32 params, bf16
   compute): (a) two
   gloo ranks on cuda:0 print which of reduce_scatter_tensor,
   all_gather_into_tensor and all_reduce gloo runs on bf16 and f32 CUDA
   tensors (FSDP2 and the tensor-parallel pair need all six; the ring
   over a gloo mesh stages its hops through pinned host buffers, decided
   from the backend: gloo moves no CUDA tensor point to point); then
   through
   Trainer(..., mesh=) on the same global batch, 1 + 2 steps each, both
   ranks on the card: (b) fsdp=2 at 8 x 2048, (c) tensor=2 at 4 x 2048,
   (d) attention_impl='ring' at fsdp=2 on 1 x 16384 (8192 tokens a
   rank): each step's loss within SHARDED_LOSS_RTOL and its grad norm
   within SHARDED_NORM_RTOL of the one-device trainer's 3 steps on the
   same weights and batch (step 3 the first after a real update; each
   reference run first and freed), every rank's
   metrics equal rank 0's, exact flash forward / dq / dk/dv launches per
   rank (2 forwards per layer under remat; per hop the ring does not
   skip), peak GB and seconds per step per rank; (e) the ring op at one
   hop's shape (RING_HOP_SHAPE, and `tiny`'s RING_SMALL_HOP_SHAPE at
   head_dim 16 on the small kernels) against ring_attention_reference
   (output norm-rel <= BWD_NORM_RTOL, dq/dk/dv <= GRAD_PLAIN_RTOL),
   with the per-rank launches; (h) a one-device `tiny` state.pt (2
   steps) restored through Trainer(..., mesh=) at fsdp=2: every
   parameter and AdamW moment shard bit-equal to its rows of the saved
   tensor, the next step within SHARDED's gates of the one-device step
   3; (g) (b)'s step saved (DCP) and restored
   on one device, every parameter bit-equal to the gathered shards; (f)
   the FSDP2 step and the one-hop ring over a one-rank NCCL group
   against the unsharded trainer (2 layers, 2 steps): equal within f32
   rounding; then the three kernels timed at the ring hop's shape.
12. Pipeline (PIPELINE): pipeline_apply over pipeline=2, both gloo
   ranks on cuda:0, each stage 7 of bench-1b's 14 decoder blocks at full
   width, 4 x 4096 bf16 activations in 4 microbatches, forward and
   backward (a seeded cotangent): the output, x's gradient and every
   stage's gradients against the sequential fold on one device (norm-relative
   PIPELINE_RTOL per tensor), exact launches per rank.
13. Expert parallelism (EXPERT): (a) whether gloo runs all_to_all_single
   on CUDA tensors (it must: the expert exchange hands them over as they
   are); MOE_TRAIN's model at 2 layers, expert=2, fsdp=1, two gloo ranks on
   cuda:0 through Trainer(..., mesh=), 1 + 2 steps at 4 x 2048, each
   step's loss and grad norm against the one-device trainer's (SHARDED's
   gates), 4 experts a rank, exact launches.
14. MoE serving over tensor=2 (MOE_TENSOR): MOE_SERVE's model at 2 of 16
   layers, two gloo ranks on cuda:0: bf16 first-step logits
   bit-identical to one device computing the same arithmetic, within
   LOGITS_RTOL of the plain model, one flash launch a layer on rank 0; f32
   greedy tokens of MOE_SERVE's traffic through the f32 kernels identical
   to one device, dense and paged, one f32 forward per layer and prefill
   group on rank 0, one device's prefill logits within F32_LOGITS_RTOL of
   attention_impl='xla'.
15. Graft entry: the port's `graft_entry.entry()` (llama-250m, [1,
   512]) on the card, its logits against attention_impl='xla' on its
   example arguments and on seeded tokens; validate.py's h100 entry
   against the card's memory (mem_get_info read at the start of the run
   with a one-rank NCCL group) and one placement printed.
16. Perf gate: the run of `python -m skypilot_tpu_torch.perf.gate`
   (perf/gate.py) on the card: the `tiny` serve probe (head_dim 16,
   dense and int8-paged engines) against the newest committed
   BENCH_*.json: report ok, every ratio check a cross-host skip, the
   three live gauges within 5% of the cost model, the roofline rows
   printed; the probe's prefills launch the small-head-dim forward
   (counted, every counter zeroed just before) and no wgmma kernel.
16b. Fleet (FLEET), host work only, last (the goodput sim resets the
   port's metrics registry): `python -X importtime -m
   skypilot_tpu_torch.fleetsim --json` in a subprocess (the canonical
   fleet, a fresh sqlite file): its result without `profile` and
   `wall_s` equal to FLEET_REFERENCE (the JAX package's, field by field
   and by digest, history included), neither torch nor JAX imported,
   the profile's top three rows and wall_s printed as host times; the
   goodput sim's planted straggler in this process (GOODPUT_REFERENCE:
   the ledger tiles the sim wall within 1e-6%, host2 named, goodput_low
   and straggler firing); the port's fuse proxy built into
   build/skypilot_tpu_torch/fuse_proxy/ and a mount's fd relayed through
   shim -> server -> a fake fusermount over SCM_RIGHTS.
17. Result: the kernels JSON line (per kernel also TFLOP/s, ptxas
   registers and spill-store bytes, shared memory per launch; launches
   by path: serving, paged, checkpoint, tensor_serving (rank 0 of (b)
   and (d)), moe_serving, training, moe_training, rl, sharded_training
   (rank 0 of (b)-(d) and (f)), pipeline, expert_parallel,
   moe_tensor_serving (rank 0 each), graft_entry, tiny_training,
   perf_gate, sync_audit, launch (job A's process), api_server (job A's
   process under the API server), managed_job (the recovered attempt's
   process), serve (the replica's process), ssh_pool and bucket_relay
   (job A's process; the new paths, ssh_pool and bucket_relay, must have
   launched the flash forward); the three small-head-dim
   kernels' rows
   launched on tiny_training and sync_audit, the forward's also on
   perf_gate; the three wide kernels' rows launched on head_dims, with
   their times at every timed shape, the padded route's, ptxas registers
   per head_dim; the three f32 kernels' rows launched on f32_training,
   the forward's also on tensor_serving and moe_tensor_serving (rank 0's
   (c)), with their times at both f32 shapes, ptxas registers per width
   and the worst numbers of (3b'')), the run's seconds beside PR 20's
   807.5, the nvidia-smi
   line, then {"ok": true, "device": {...}} as the last line.

Needs one CUDA device; exits non-zero without one and imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Published H100 SXM peaks (dense): the roofline bound's denominators.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_S = 3.35e12
# bf16 kernel vs its f32 plain version on the same bf16 inputs: the
# kernel rounds P to bf16 before P.V (as the TPU kernel does) and the
# output to bf16; one bf16 ulp is 2^-7 (0.8%) of a value, so
# |out - ref| <= OUT_ATOL + OUT_RTOL * |ref|.  The lse is f32 on both
# sides; only the order of f32 sums differs.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3
# Serving prefill logits, kernel vs attention_impl='xla' on the same
# weights: 32 bf16 layers amplify the attention outputs' last-bit
# differences, so the gate is relative to the logits' scale.
LOGITS_RTOL = 5e-2
# Backward kernels vs their plain versions on the same bf16 inputs: both
# round P and dS to the input type before their products, as the TPU
# kernels do; they differ in the order of f32 sums, in the SFU's 2^x
# against exp, in where a value lands next to a bf16 rounding boundary,
# and in the output's bf16 rounding (2^-8 relative).  Judged on ||kernel - plain|| / ||plain|| per
# output; a wrong kernel is off by ~1.
BWD_NORM_RTOL = 1e-2
# The forward's and the gradients' gates above, as against_plain takes them.
HALF_GATES = {'out': (OUT_ATOL, OUT_RTOL), 'lse': (LSE_ATOL, 0.0),
              'norm': BWD_NORM_RTOL}
# Training gradients at batch 1 through the backward kernels vs the same
# step whose attention backward is the kernels' plain versions on the
# same CUDA tensors (same forward kernel, same bf16 rounding of P and
# dS, f32 dP on both sides): they differ only in the order of f32 sums
# and in 1-ulp roundings, carried through 14 layers.  Per-tensor
# norm-relative error; a kernel fault of a few percent in any tensor
# fails it.
GRAD_PLAIN_RTOL = 1e-2
# The same step through attention_impl='xla' (mha_reference under
# autograd): bf16 compute rounded at other places (it rounds dP to bf16
# before the softmax backward's cancellation), so it is a coarser
# witness: per tensor, over all tensors together (the norm of the
# difference of the whole gradient over the whole gradient's norm), and
# the loss.
GRAD_NORM_RTOL = 0.1
GRAD_GLOBAL_RTOL = 1e-2
LOSS_RTOL = 1e-2
TRAIN = dict(model='bench-1b', ledger='chip-smoke-bench-1b', batch=4,
             seq=4096, warm_steps=2,
             timed_steps=8, grad_batch=1, warmup_steps=5, total_steps=1000)
# (b, hq, hkv, s, d) of the MoE paths' attention (MOE_SERVE, MOE_TRAIN):
# the serving prefill (8 prompts in the 256 bucket) and the training step.
MOE_PREFILL_SHAPE = (8, 32, 8, 256, 64)
MOE_TRAIN_SHAPE = (2, 32, 8, 2048, 64)
# One pipeline microbatch through a bench-1b block (PIPELINE), the MoE
# model's prefill on one rank of tensor=2 (MOE_TENSOR: 16 of 32 query
# heads over 4 of 8 kv heads), and llama-250m's forward of the graft
# entry at its example shape.
PIPE_MICRO_SHAPE = (1, 16, 8, 4096, 128)
MOE_TP_PREFILL_SHAPE = (8, 16, 4, 256, 64)
ENTRY_SHAPE = (1, 16, 8, 512, 64)
# (b, hq, hkv, s, d, causal, dtype) of the backward check: bench-1b's
# training shape first (it is also the timed one), llama-250m, llama2-7b
# (MHA), a non-causal and a ragged fp16 case, S shorter than one tile
# and past a multiple of the 128-row tiles, the RL loop's shapes (its
# REINFORCE step over 4 + 32 tokens, its rollout's prefill bucket), the
# MoE training step's (GQA group 4) and one rank's in the sharded
# training phase (SHARDED): (b) fsdp=2 (4 of 8 rows), (c) tensor=2 (half
# the heads of 4 rows) and (f) (2 x 1024, one rank).  The ring's hop
# shape is held by (e) through the ring op itself.
BWD_SHAPES = [(4, 16, 8, 4096, 128, True, 'bfloat16'),
              (8, 16, 8, 2048, 64, True, 'bfloat16'),
              (2, 32, 32, 512, 128, True, 'bfloat16'),
              (2, 16, 8, 1024, 128, False, 'bfloat16'),
              (2, 8, 2, 96, 64, True, 'float16'),
              (1, 4, 2, 32, 128, True, 'bfloat16'),
              (1, 4, 2, 320, 128, True, 'bfloat16'),
              (8, 16, 8, 36, 64, True, 'bfloat16'),
              (8, 16, 8, 8, 64, True, 'bfloat16'),
              (*MOE_TRAIN_SHAPE, True, 'bfloat16'),
              (4, 32, 8, 2048, 64, True, 'bfloat16'),
              (4, 16, 4, 2048, 64, True, 'bfloat16'),
              (2, 32, 8, 1024, 64, True, 'bfloat16'),
              (*PIPE_MICRO_SHAPE, True, 'bfloat16')]
# llama2-7b at full width with its depth cut 32 -> 8 layers (the
# serving, paged, checkpoint and tensor_serving phases share the model;
# their time is about proportional to depth: 16 layers before the
# head_dims phase came, 8 since, to keep the run's script near 1000 s of
# its 1200 s limit).
SERVE = dict(model='llama2-7b', n_layers=8, max_seq_len=448, n_slots=8,
             steps_per_call=32, prefill_buckets=(256,), prompt_len=219,
             n_prompts=8, long_prompt_len=300, max_tokens=32)
# The paged serving phase, over the serving phase's prompts and the
# first n_layers of its weights' 8 layers (model and max_seq_len are
# SERVE's; the depth cut keeps the smoke near half its time limit as
# phases are added): 64-token pages divide the bucket
# and max_seq_len, so full backing is 8 * 448/64 + 1 = 57 pages.  The
# hit burst shares a 192-token (3-page) prefix; the handoff takes 4
# prompts; the profiled decode call runs with 64-token budgets so the
# second call is all decode.
PAGED = dict(model='llama2-7b', n_layers=8, max_seq_len=448, n_slots=8,
             steps_per_call=32, prefill_buckets=(256,), kv_page_size=64,
             prefix_len=192, tail_len=27, max_tokens=32, spec_k=4,
             handoff_prompts=4)
# The RL loop of examples/train_rl_reinforce.yaml: llama-250m at full
# width and depth (f32 params, as the recipe's), 8 copies of one prompt,
# 32 sampled tokens at temperature 1 on the engine (its decode call a
# CUDA graph), Adam at 1e-5 with kl_coef 0.02 on the learner's own copy
# of the params, update_params after every step; 3 iterations.
RL = dict(model='llama-250m', prompt=(1, 2, 3, 4), n_prompts=8, max_new=32,
          n_slots=8, steps_per_call=16, prefill_buckets=(8,),
          temperature=1.0, seed=0, lr=1e-5, kl_coef=0.02, iterations=3)
# (b, hq, hkv, s, d) of the REINFORCE step's attention (timed).
RL_SHAPE = (8, 16, 8, 36, 64)
# The MoE configuration of examples/train_moe_expert_parallel.yaml:20,
# llama3-1b with 8 experts (top-2, capacity factor 1.25): 32 query heads
# over 8 kv heads of 64 (a GQA group of 4), at full width with its depth
# cut 16 -> 8 layers (3.568B params, 7.14 GB in bf16; 6.873B whole: the
# cut makes room for the managed_job and serve phases) with SERVE's
# engine and traffic, dense (graph and eager) and 64-token-paged
# (graph).
MOE_SERVE = dict(model='llama3-1b', n_experts=8, n_layers=8,
                 max_seq_len=448, n_slots=8, steps_per_call=32,
                 prefill_buckets=(256,), kv_page_size=64, prompt_len=219,
                 n_prompts=8, long_prompt_len=300, max_tokens=32)
# Trained at full width with n_layers cut 16 -> 4: the whole model's f32
# AdamW state would be 110 GB; 4 layers are 1.915B params, ~30.6 GB.
# The config's own remat (policy 'none'), f32 params, bf16 compute; batch
# 2 x 2048, one card's share of the recipe's 16 x 2048.
MOE_TRAIN = dict(model='llama3-1b', n_experts=8, n_layers=4, batch=2,
                 seq=2048, warm_steps=2, timed_steps=4, grad_batch=1,
                 warmup_steps=5, total_steps=1000)
# The zoo's models on the card: bert-tiny at B=32, S=512 and resnet50 at
# B=64 on 224 x 224 x 3 NHWC, each a train-mode forward and a backward.
ZOO = dict(encoder='bert-tiny', enc_batch=32, enc_seq=512,
           resnet='resnet50', res_batch=64, res_hw=224, warm_steps=2,
           timed_steps=5)
# The zoo's bf16-compute logits against the same weights in f32 compute,
# relative to the f32 logits' max |logit|.
ZOO_LOGITS_RTOL = 5e-2
# The live perf gauges (skytpu_engine_mfu, _hbm_bytes_per_token,
# _arith_intensity) against the cost model evaluated at the serving
# burst's rate and mean context measured here: the engine's window and
# this script's wall clock bracket the same burst up to a few ms of the
# loop's stop, and the engine weights every token's context as this
# script does.
PERF_GAUGE_RTOL = 5e-2
# Tensor-parallel serving on the one card: the serving cell's model and
# traffic over tensor=2 with both ranks on cuda:0 over gloo (eager calls:
# a correctness run, its rate is gloo's host staging), dense and 64-token
# paged; then cut to 4 layers in f32; then tensor=1 over NCCL.  Its model
# is the serving phase's (SERVE's depth).
TENSOR = dict(model='llama2-7b', tensor=2, max_seq_len=448, n_slots=8,
              steps_per_call=32, prefill_buckets=(256,), kv_page_size=64,
              max_tokens=32, f32_layers=4)
# (b, hq, hkv, s, d) of one rank's prefill attention at tensor=2: 8
# prompts in the 256 bucket over 16 of llama2-7b's 32 heads.
TP_SHAPE = (8, 16, 16, 256, 128)
# Sharded training of examples/train_llama_fsdp.yaml's model: llama3-1b
# at full width (dim 2048, 32 query heads over 8 kv heads of 64, tied
# embeddings, vocab 128256), its depth cut 16 -> 8 layers (0.750B params;
# 1.236B whole through PR 10: the cut makes room for the pipeline and
# expert phases, as the serving phases' cut did), f32 params,
# bf16 compute, the config's remat, two gloo ranks on cuda:0 (NCCL will
# not put two ranks on one card), each through Trainer(..., mesh=) on the
# same global batch, 1 + 2 steps: (b) fsdp=2 at the recipe's batch of
# 8 x 2048 (4 rows a rank); (c) tensor=2 at 4 x 2048 (cut from 8: the
# whole-vocab f32 logits, gathered on each rank, with their
# cross-entropy copies and gradients, ~35 GB a rank at 8 rows, and the
# two ranks share the card's 80 GB); (d) attention_impl='ring' at
# fsdp=2 on one row of 16384 tokens, 8192 a rank, the per-device share
# of examples/ring_attention_long_context.yaml (131072 over 16; its
# batch 2 cut to 1 so the one-device reference fits).  (f) runs the
# model cut to 2 layers at 2 x 1024 over a one-rank NCCL group.
SHARDED = dict(model='llama3-1b', n_layers=8, ranks=2, device='cuda:0',
               batch=8, seq=2048, tensor_batch=4, ring_batch=1,
               ring_seq=16384, steps=3, warmup_steps=5, total_steps=1000,
               nccl_layers=2, nccl_batch=2, nccl_seq=1024)
# (b, hq, hkv, s, d) of one ring hop at (d): a rank's 8192-token chunk;
# and of one hop of `tiny` (head_dim 16) at TINY_TRAIN's batch of 4 x 128
# over fsdp=2, which (e) also runs.
RING_HOP_SHAPE = (1, 32, 8, 8192, 64)
RING_SMALL_HOP_SHAPE = (4, 4, 2, 64, 16)
# Steps 1 and 3 of a sharded plan against the one-device trainer's on
# the same weights and batch: the loss (f32, summed over shards in
# another order; the bf16 attention and o/down products round alike
# only on one device) and the pre-clip grad norm (bf16 gradients summed
# over shards and ranks in another order).  Step 1's update is 0 (the
# warmup starts at 0), so step 3's loss and norm are the first to read
# a real update: the sharded clip and AdamW over the shards.
SHARDED_LOSS_RTOL = 2e-3
SHARDED_NORM_RTOL = 1e-2
# (f) world 1 over NCCL against the unsharded trainer, two steps on the
# same weights: the same kernels on the same values, the loss weighted
# by exactly 1, only the clip's norm summed in another order (f32).
NCCL_LOSS_RTOL, NCCL_NORM_RTOL, NCCL_PARAM_ATOL = 1e-6, 1e-5, 1e-6
# GPipe over pipeline=2, both gloo ranks on cuda:0: bench-1b's decoder
# blocks at full width (dim 2048, 16/8 heads of 128, ffn 8192; 62.9M
# params a block), 7 of its 14 blocks a stage (1.76 GB of f32 a stage),
# the config's remat; the embedding and head stay outside the pipeline
# (a stage keeps the shape).  A global batch of 4 x 4096 bf16
# activations from SEED (what the embedding hands the first block) in 4
# microbatches: a hop carries one [1, 4096, 2048] bf16 activation (16.8
# MB), through pinned host buffers on a gloo group.
PIPELINE = dict(model='bench-1b', stages=2, batch=4, seq=4096, n_micro=4,
                device='cuda:0')
# The pipeline's output and every stage's parameter gradients against
# the sequential fold on one device (same weights, input and cotangent),
# norm-relative per tensor: both compute in bf16 with f32 accumulation,
# but the fold runs a block over the whole batch (16384 rows) and the
# pipeline over one microbatch (4096): bf16 products round at other
# places, and a weight's gradient is 4 bf16 microbatch products added in
# f32 instead of one.  The difference stays at bf16 rounding, as
# SHARDED_NORM_RTOL's does; a dropped or doubled microbatch, a gradient
# counted n_stages times or a hop in the wrong direction is far past it.
PIPELINE_RTOL = 1e-2
# Expert parallelism, the EP x DP mesh of
# examples/train_moe_expert_parallel.yaml:19 (fsdp=1) with its expert=8
# cut to the one card's two ranks (4 experts a rank): MOE_TRAIN's model
# (llama3-1b x 8 experts at full width, remat 'none') at 2 of its 16
# layers (4 before the head_dims phase came: the ranks' gloo staging
# scales with the params), two gloo ranks on cuda:0 through
# Trainer(..., mesh=), 1 + 2 steps at the global batch 4 x 2048 (2 rows
# a rank), each against the one-device trainer's 3 steps on the same
# weights and batch (run first and freed) with SHARDED's gates.  The
# phase prints the parameters a device and a rank hold.
EXPERT = dict(model='llama3-1b', n_experts=8, n_layers=2, expert=2, batch=4,
              seq=2048, steps=3, warmup_steps=5, total_steps=1000,
              device='cuda:0')
# MoE serving over tensor=2, both gloo ranks on cuda:0: MOE_SERVE's model
# cut to 2 of 16 layers (4 before the head_dims phase came: its eager
# gloo decode scales with depth) with MOE_SERVE's traffic.  (b)
# bf16 params and compute, the flash prefill: first-step logits
# bit-identical to one device computing the same arithmetic (o and each
# expert's w_down as two bf16 half products added in bf16) and within
# LOGITS_RTOL of the plain one-device model; (c) f32 params and compute
# through the f32 kernels: greedy tokens identical to the one-device
# engine, dense and 64-token paged, one device's prefill logits within
# F32_LOGITS_RTOL of attention_impl='xla'.
MOE_TENSOR = dict(model='llama3-1b', n_experts=8, n_layers=2, tensor=2,
                  device='cuda:0')
# The graft entry's forward (llama-250m, [1, 512]) against
# attention_impl='xla' on the same params: LOGITS_RTOL of max |logit|.
# The card's memory as validate.py's 'h100' entry states it: the total
# within VALIDATE_HBM_RTOL and the usable share measured at the start of
# this run (after the CUDA context and a one-rank NCCL group) at least
# the table's less VALIDATE_FRACTION_ATOL.
VALIDATE_HBM_RTOL = 1e-2
VALIDATE_FRACTION_ATOL = 1e-2
# tensor=2 first-step logits (bf16) must be bit-identical to one device
# computing the same arithmetic (each o/down product as two bf16 half
# products added in bf16; every other op is the same kernel on the same
# values).  Against the plain one-device model the o/down sums round
# otherwise (two bf16 partials added, not one f32 accumulator rounded
# once), a flip in a few of layer 0's outputs that 32 random layers carry
# to the noise floor of two correct bf16 computations (one device's
# flash vs xla, printed beside it): that comparison takes LOGITS_RTOL.
# The /debug/profile window opened over the serving burst (ms), and the
# verify calls timed per speculative engine.
PROFILE_MS = 500
VERIFY_TIMED_CALLS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


# Device cycles of the spin kernel queued ahead of a timed run (~10 ms):
# the host enqueues every timed call behind it, so the events time the
# calls back to back on the device and not the host's launch overhead,
# which exceeds a short kernel's own time.
SPIN_CYCLES = 20_000_000


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_l2_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of `fn` with the 50 MB L2 flushed before each
    call (a 64 MB write between calls; events around each call only)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# Kernel symbols as ptxas and the profiler name them, by wrapper.
# The small, the wide and the f32 wrappers launch one mma.sync template
# each (at head_dim 16/32 and 80/96 in bf16/fp16; at every width in f32).
KERNEL_SYMBOLS = {'flash_attention_fwd': 'fa_fwd_kernel',
                  'flash_attention_fwd_small': 'fa_fwd_mma_kernel',
                  'flash_attention_fwd_wide': 'fa_fwd_mma_kernel',
                  'flash_attention_bwd_dq': 'fa_bwd_dq_kernel',
                  'flash_attention_bwd_dq_small': 'fa_bwd_dq_mma_kernel',
                  'flash_attention_bwd_dq_wide': 'fa_bwd_dq_mma_kernel',
                  'flash_attention_bwd_dkv': 'fa_bwd_dkv_kernel',
                  'flash_attention_bwd_dkv_small': 'fa_bwd_dkv_mma_kernel',
                  'flash_attention_bwd_dkv_wide': 'fa_bwd_dkv_mma_kernel',
                  'flash_attention_fwd_f32': 'fa_fwd_mma_kernel',
                  'flash_attention_bwd_dq_f32': 'fa_bwd_dq_mma_kernel',
                  'flash_attention_bwd_dkv_f32': 'fa_bwd_dkv_mma_kernel',
                  'flash_attention_fwd_256': 'fa_fwd_256_kernel',
                  'flash_attention_bwd_dq_256': 'fa_bwd_dq_256_kernel',
                  'flash_attention_bwd_dkv_256': 'fa_bwd_dkv_256_kernel'}


def ptxas_report(build_log: str) -> dict:
    """{(symbol, 'bf16' | 'fp16' | 'f32', head_dim): {'registers', 'stack',
    'spill_stores', 'spill_loads'}} from nvcc's -Xptxas -v output.  The
    kernels of one width (fa_*_256_kernel, and dk/dv's partials' reduce,
    fa_bwd_dkv_256_reduce) are templated on the type alone: their head_dim
    is 256."""
    report, cur = {}, None
    for line in build_log.splitlines():
        m = (re.search(r"Compiling entry function '\S*?(fa_\w+?_kernel)I"
                       r"(\w+?)Li(\d+)E", line) or
             re.search(r"Compiling entry function '\S*?(fa_\w+?_256_"
                       r"(?:kernel|reduce))I(\w+?)EEv", line))
        if m:
            dtype = ('bf16' if 'bfloat16' in m.group(2) else
                     'f32' if m.group(2) == 'f' else 'fp16')
            cur = (m.group(1), dtype,
                   int(m.group(3)) if m.lastindex == 3 else 256)
            report[cur] = {}
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and cur:
            report[cur].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m and cur:
            report[cur]['registers'] = int(m.group(1))
    return report


def launch_attrs(calls: dict, attempts: int = 3, repeats: int = 3) -> dict:
    """{symbol: the profiler's record of its launch} for each {symbol:
    fn} of `calls`, all under one profiler: registers per thread,
    shared memory (static + dynamic), grid, block.  Each fn runs
    `repeats` times under it; a trace that lacks some of the kernels
    (on the H100 the profiler has returned traces without one, or
    without any) is taken again for those, up to `attempts` in all; {}
    where no trace had the kernel."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    attrs = {symbol: {} for symbol in calls}
    for _ in range(attempts):
        missing = [symbol for symbol in calls if not attrs[symbol]]
        if not missing:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for symbol in missing:
                for _ in range(repeats):
                    calls[symbol]()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'trace.json')
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        for evt in trace.get('traceEvents', []):
            for symbol in missing:
                if evt.get('cat') == 'kernel' and \
                        symbol in evt.get('name', ''):
                    args = evt.get('args', {})
                    attrs[symbol] = {key: args.get(key) for key in (
                        'registers per thread', 'shared memory', 'grid',
                        'block', 'blocks per SM', 'warps per SM')}
    return attrs


def attention_bound(b, hq, hkv, s, d, causal, itemsize=2,
                    peak=PEAK_BF16_FLOPS):
    """Least time for the forward: q, k, v read once and out written
    once over HBM bandwidth, vs the QK^T and PV flops this input needs
    (causal: s(s+1)/2 query-key pairs) over the tensor-core peak of the
    inputs' type (bf16's; PEAK_TF32_FLOPS for f32)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * hq * pairs * d
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize
    t_flops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES_S
    return (max(t_flops, t_bytes) * 1e3,
            'operations' if t_flops > t_bytes else 'bytes', flops, nbytes)


def bwd_bound(kind, b, hq, hkv, s, d, causal, itemsize=2,
              peak=PEAK_BF16_FLOPS):
    """Least time for one backward kernel: its inputs (q, dO [B,Hq,S,D],
    k, v [B,Hkv,S,D], lse and delta [B,Hq,S] f32) read once and its
    outputs (dq [B,Hq,S,D], or dk and dv [B,Hkv,S,D]) written once over
    HBM bandwidth, vs the products over the (q, k) pairs this input needs
    (causal: s(s+1)/2) over the tensor-core peak of the inputs' type
    (`peak`): dq recomputes Q K^T and dO V^T and forms dS K (6 D flops per
    pair), dk/dv also forms P^T dO and dS^T Q (8 D)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (6 if kind == 'dq' else 8) * b * hq * pairs * d
    in_bytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize
    in_bytes += 2 * b * hq * s * 4
    out_bytes = (b * hq * s * d if kind == 'dq' else 2 * b * hkv * s * d)
    nbytes = in_bytes + out_bytes * itemsize
    t_flops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES_S
    return (max(t_flops, t_bytes) * 1e3,
            'operations' if t_flops > t_bytes else 'bytes', flops, nbytes)


def _norm_rel(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def bwd_kernel_phase(device):
    """The forward, then dq and dk/dv, against their plain versions at
    every BWD_SHAPES entry; then times at bench-1b's training shape (the
    first entry) of
    the forward, dq and dk/dv kernels, their plain versions, SDPA and
    the bounds.  Returns (dq entry, dkv entry, forward's timing there)."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    errs = {'dq': 0.0, 'dkv': 0.0, 'fwd': 0.0}
    timed = None
    for shape in BWD_SHAPES:
        b, hq, hkv, s, d, causal, dtype_name = shape
        dtype = getattr(torch, dtype_name)
        q, g = (torch.randn((b, hq, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        torch.cuda.synchronize()
        # The forward at the training shapes first: its out and lse are
        # the backward's inputs on both sides, so a wrong forward would
        # pass the backward's check unseen.
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        diff = (out.float() - ref.float()).abs()
        fwd_err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        fwd_ok = bool((diff <= OUT_ATOL + OUT_RTOL * ref.float().abs()).all()
                      and torch.isfinite(out).all())
        del ref, ref_lse, diff
        log(f'  flash_fwd b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {dtype_name}: out max_abs_err={fwd_err:.3e} '
            f'lse max_abs_err={lse_err:.3e}')
        if not (fwd_ok and lse_err <= LSE_ATOL):
            raise SystemExit(f'flash_attention_fwd disagrees with its plain '
                             f'version at {shape}: out {fwd_err} lse '
                             f'{lse_err}')
        errs['fwd'] = max(errs['fwd'], fwd_err)
        delta = (g.float() * out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                     causal)
        rels = {'dq': _norm_rel(dq, ref_dq)}
        abs_errs = {'dq': (dq.float() - ref_dq.float()).abs().max().item()}
        finite = bool(torch.isfinite(dq).all())
        del ref_dq
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, causal)
        rels['dk'], rels['dv'] = _norm_rel(dk, ref_dk), _norm_rel(dv, ref_dv)
        abs_errs['dkv'] = max(
            (dk.float() - ref_dk.float()).abs().max().item(),
            (dv.float() - ref_dv.float()).abs().max().item())
        finite = finite and bool(torch.isfinite(dk).all() and
                                 torch.isfinite(dv).all())
        del ref_dk, ref_dv
        log(f'  flash_bwd b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {dtype_name}: norm-rel dq {rels["dq"]:.3e} '
            f'dk {rels["dk"]:.3e} dv {rels["dv"]:.3e}; max_abs_err dq '
            f'{abs_errs["dq"]:.3e} dk/dv {abs_errs["dkv"]:.3e}')
        if not finite or max(rels.values()) > BWD_NORM_RTOL:
            raise SystemExit(f'flash backward kernels disagree with their '
                             f'plain versions at {shape}: {rels}')
        for key in abs_errs:
            errs[key] = max(errs[key], abs_errs[key])
        if timed is None:
            timed = (q, k, v, g, out, lse, delta, shape)
        else:
            del q, k, v, g, out, lse, delta
        del dq, dk, dv
        torch.cuda.empty_cache()

    q, k, v, g, out, lse, delta, shape = timed
    b, hq, hkv, s, d, causal, _ = shape
    ms = {
        'dq': cuda_time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, g, lse, delta, causal)),
        'dkv': cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, g, lse, delta, causal)),
        'fwd': cuda_time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, return_residuals=True)),
    }
    plain_ms = {
        'dq': cuda_time_ms(lambda: fa.flash_attention_bwd_dq_reference(
            q, k, v, g, lse, delta, causal), iters=3, warmup=1),
        'dkv': cuda_time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, causal), iters=3, warmup=1),
        'fwd': cuda_time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True), iters=3,
            warmup=1),
    }
    torch.cuda.empty_cache()
    # The library yardstick: SDPA's forward, and its backward (one call
    # computes dq, dk and dv), with grouped-query heads.
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)
    lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, g, retain_graph=True))
    with torch.no_grad():
        lib_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    del sdpa_out, leaves
    entries = {}
    calls = {KERNEL_SYMBOLS['flash_attention_fwd']:
             lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                            return_residuals=True)}
    for kind, name, line, source, call in (
            ('dq', 'flash_attention_bwd_dq', 196, 'flash_attention_bwd_dq.cu',
             lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                               causal)),
            ('dkv', 'flash_attention_bwd_dkv', 225,
             'flash_attention_bwd_dkv.cu',
             lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                causal))):
        bound_ms, bound_by, flops, nbytes = bwd_bound(kind, b, hq, hkv, s,
                                                      d, causal)
        tflops = flops / ms[kind] / 1e9
        log(f'  timing {name} b={b} hq={hq} hkv={hkv} s={s} d={d} causal '
            f'bf16: kernel {ms[kind]:.4f} ms ({tflops:.1f} TFLOP/s), plain '
            f'{plain_ms[kind]:.4f} ms, sdpa backward (dq+dk+dv) '
            f'{lib_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: '
            f'{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), '
            f'{bound_ms / ms[kind]:.1%} of bound')
        entries[kind] = {
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{source}',
            'replaces': f'skypilot_tpu/ops/pallas/flash_attention.py:{line}',
            'max_abs_err': errs[kind], 'ms': ms[kind],
            'plain_ms': plain_ms[kind], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': lib_bwd_ms,
            'tflops': tflops, 'shape': list(shape)}
        calls[KERNEL_SYMBOLS[name]] = call
    # The like-for-like yardstick of SDPA's one backward call: the port's
    # two backward kernels together.
    entries['dq']['port_bwd_ms'] = ms['dq'] + ms['dkv']
    log(f'  timing the port\'s backward (dq + dk/dv kernels) '
        f'{ms["dq"] + ms["dkv"]:.4f} ms vs sdpa backward {lib_bwd_ms:.4f} ms')
    bound_ms, bound_by, flops, nbytes = attention_bound(b, hq, hkv, s, d,
                                                        causal)
    fwd_train = {'ms': ms['fwd'], 'plain_ms': plain_ms['fwd'],
                 'bound_ms': bound_ms, 'bound_by': bound_by,
                 'library_ms': lib_fwd_ms, 'tflops': flops / ms['fwd'] / 1e9,
                 'shape': list(shape), 'max_abs_err': errs['fwd']}
    log(f'  timing flash_attention_fwd (with lse) at the same shape: kernel '
        f'{ms["fwd"]:.4f} ms ({fwd_train["tflops"]:.1f} TFLOP/s), plain '
        f'{plain_ms["fwd"]:.4f} ms, sdpa '
        f'{lib_fwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: '
        f'{flops / 1e9:.1f} GFLOP), {bound_ms / ms["fwd"]:.1%} of bound')
    # One profiled launch of each kernel at this shape (all three are the
    # bf16, head_dim 128 instantiations the main paths run).
    attrs = launch_attrs(calls)
    for entry, symbol in ((entries['dq'], 'fa_bwd_dq_kernel'),
                          (entries['dkv'], 'fa_bwd_dkv_kernel'),
                          (fwd_train, 'fa_fwd_kernel')):
        entry['launch'] = attrs[symbol]
        log(f'  launch of {symbol}: {attrs[symbol]}')
    del q, k, v, g, out, lse, delta, timed
    torch.cuda.empty_cache()
    return entries['dq'], entries['dkv'], fwd_train


def kernel_phase(device):
    """Every flash-forward shape of the check against the plain version;
    returns the kernels-line numbers except the launch count."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = [(b, 32, 32, s, 128, True, torch.bfloat16)   # llama2-7b prefill
              for b in (1, 8) for s in (32, 64, 128, 256, 512)]
    shapes += [(4, 12, 4, 256, 128, True, torch.bfloat16),  # bench-600m
               (4, 32, 8, 256, 64, True, torch.bfloat16),   # llama3-1b
               (*MOE_PREFILL_SHAPE, True, torch.bfloat16),  # MoE prefill
               (*MOE_TP_PREFILL_SHAPE, True, torch.bfloat16),  # its rank
               (*ENTRY_SHAPE, True, torch.bfloat16),        # graft entry
               (2, 32, 32, 256, 128, False, torch.bfloat16),  # non-causal
               (2, 8, 2, 96, 64, True, torch.float16)]      # ragged, fp16
    max_err = 0.0
    for b, hq, hkv, s, d, causal, dtype in shapes:
        q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = bool((diff <= OUT_ATOL + OUT_RTOL * ref.float().abs()).all())
        log(f'  flash_fwd b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {str(dtype)[6:]}: out max_abs_err={err:.3e} '
            f'lse max_abs_err={lse_err:.3e}')
        if not (ok and lse_err <= LSE_ATOL and torch.isfinite(out).all()):
            raise SystemExit(
                f'flash_attention_fwd disagrees with its plain version at '
                f'{(b, hq, hkv, s, d, causal)}: out {err} lse {lse_err}')
        max_err = max(max_err, err)

    # Times at the llama2-7b prefill shape of the serving phase.
    b, h, s, d = 8, 32, SERVE['prefill_buckets'][0], 128
    q, k, v = (torch.randn((b, h, s, d), generator=gen,
                           device=device).to(torch.bfloat16)
               for _ in range(3))
    def call():
        return fa.flash_attention_fwd(q, k, v)

    ms = cuda_time_ms(call)
    # q, k, v and out are 16.8 MB each (67.1 MB together): part of them
    # stays in the 50 MB L2 between back-to-back calls; the flushed time
    # reads them all from device memory.
    cold_ms = cold_l2_ms(call)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v))
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by, flops, nbytes = attention_bound(b, h, h, s, d, True)
    log(f'  timing b={b} h={h} s={s} d={d} causal bf16: kernel {ms:.4f} ms '
        f'(L2 warm), {cold_ms:.4f} ms (L2 flushed before each call), plain '
        f'{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, '
        f'{nbytes / 1e6:.2f} MB): {bound_ms / ms:.1%} of bound warm, '
        f'{bound_ms / cold_ms:.1%} cold')
    return {
        'name': 'flash_attention_fwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_attention_fwd.cu',
        'replaces': 'skypilot_tpu/ops/pallas/flash_attention.py:37',
        'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': library_ms, 'tflops': flops / ms / 1e9,
        'ms_l2_flushed': cold_ms,
        'shape': [b, h, h, s, d, True, 'bfloat16'],
    }


# The small-head-dim forward (head_dim 16 and 32, the `tiny` configs')
# against its plain version: the JAX reference's own max-abs bound
# (tests/test_ops.py) on the lse (f32 on both sides) and on the output
# beyond the output's own rounding: kernel and plain version both round
# the output to the input type, and where the two f32 values straddle a
# rounding boundary they land one ulp apart (2^-7 of the value in bf16,
# 1.56e-2 at |out| in [2, 4)), so |out - ref| <= SMALL_ATOL + ulp(ref).
SMALL_ATOL = 5e-3
# The perf gate's probe shapes (B=2, 4 query heads over 2 kv heads of
# 16, its prefill buckets 8 and 16, and S=128, its max_seq_len), causal
# and not, bf16 and fp16; head_dim 32 at one shape.  Timed at S=16.
SMALL_SHAPES = [(2, 4, 2, s, 16, causal, dtype)
                for s in (8, 16, 128) for causal in (True, False)
                for dtype in ('bfloat16', 'float16')]
SMALL_SHAPES.append((2, 4, 2, 128, 32, True, 'bfloat16'))
SMALL_TIMED_SHAPE = (2, 4, 2, 16, 16)


# The small-head-dim dq and dk/dv against their plain versions
# (BWD_NORM_RTOL per output) at the small forward's tile-edge grid: S on
# both sides of the 64-row tiles, head_dim 16 and 32, bf16 and fp16,
# causal and not, GQA 4 -> 2 and 4 -> 4, and a long GQA-4 case.
SMALL_BWD_SHAPES = [(2, 4, hkv, s, d, causal, dtype)
                    for hkv in (2, 4)
                    for s in (1, 5, 8, 16, 17, 63, 64, 65, 127, 128, 129)
                    for d in (16, 32) for causal in (True, False)
                    for dtype in ('bfloat16', 'float16')]
SMALL_BWD_SHAPES.append((1, 8, 2, 1024, 16, True, 'bfloat16'))
# At S = 1 every row attends to one key, so dS = P (dP - delta) = 0 and dq
# and dk are 0 in exact arithmetic: both sides hold f32 cancellation
# noise (up to ~9e-7 on an H100) and their ratio says nothing.  Where the
# plain version's largest entry is below SMALL_BWD_ZERO_ATOL, the kernel's
# must be too (a wrong kernel's garbage is ~0.1 and up).
SMALL_BWD_ZERO_ATOL = 1e-5
# (b, hq, hkv, s, d) of `tiny`'s training step (TINY_TRAIN at S = 64): the
# three small kernels are timed there.
TINY_TRAIN_SHAPE = (4, 4, 2, 64, 16)


def small_bwd_kernel_phase(device):
    """The small-head-dim dq and dk/dv against their plain versions at
    SMALL_BWD_SHAPES (on the small forward's out and lse), each call
    launching its small kernel exactly once and no other; then the three
    small kernels timed at TINY_TRAIN_SHAPE beside their plain versions,
    SDPA and the bounds.  Returns ({'dq': entry, 'dkv': entry} for the
    kernels line, launches aside, the times at TINY_TRAIN_SHAPE)."""
    import torch
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    errs = {'dq': 0.0, 'dkv': 0.0}
    worst = 0.0
    t0 = time.perf_counter()
    for shape in SMALL_BWD_SHAPES:
        b, hq, hkv, s, d, causal, dtype_name = shape
        dtype = getattr(torch, dtype_name)
        q, g = (torch.randn((b, hq, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        zero_launches()
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        launched = {**read_launches(), **read_small_launches()}
        if launched != {**dict.fromkeys(KERNEL_NAMES + SMALL_KERNELS, 0),
                        'flash_attention_bwd_dq_small': 1,
                        'flash_attention_bwd_dkv_small': 1}:
            raise SystemExit(f'the backward at {shape} launched {launched}')
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                    causal),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                      delta, causal))
        line = []
        for name, x, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), refs):
            err = (x.float() - ref.float()).abs().max().item()
            zero = ref.float().abs().max().item() <= SMALL_BWD_ZERO_ATOL
            rel = _norm_rel(x, ref) if not zero else 0.0
            ok = (bool(torch.isfinite(x).all()) and
                  (err <= SMALL_BWD_ZERO_ATOL if zero
                   else rel <= BWD_NORM_RTOL))
            if not ok:
                raise SystemExit(f'the small {name} kernel disagrees with '
                                 f'its plain version at {shape}: norm-rel '
                                 f'{rel}, max_abs_err {err}')
            key = 'dq' if name == 'dq' else 'dkv'
            errs[key] = max(errs[key], err)
            worst = max(worst, rel)
            line.append(f'{name} {"zero " if zero else ""}{rel:.2e}/'
                        f'{err:.2e}')
        log(f'  flash_bwd_small {shape[:5]} causal={causal} {dtype_name}: '
            f'norm-rel/max_abs_err {" ".join(line)}')
    log(f'  {len(SMALL_BWD_SHAPES)} shapes: worst norm-rel {worst:.3e} '
        f'(gate {BWD_NORM_RTOL}; a plain output below '
        f'{SMALL_BWD_ZERO_ATOL} is zero: the kernel\'s must be too), '
        f'launches exact; {time.perf_counter() - t0:.1f} s')

    times = kernel_times(device, TINY_TRAIN_SHAPE, 'tiny training')
    # One profiled launch of each small kernel there (registers, shared
    # memory as launched).
    b, hq, hkv, s, d = TINY_TRAIN_SHAPE
    q, g = (torch.randn((b, hq, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    bwd_args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1))
    attrs = launch_attrs({
        KERNEL_SYMBOLS[SMALL_KERNEL]: lambda: fa.flash_attention_fwd(
            q, k, v, return_residuals=True),
        KERNEL_SYMBOLS['flash_attention_bwd_dq_small']:
            lambda: fa.flash_attention_bwd_dq(*bwd_args),
        KERNEL_SYMBOLS['flash_attention_bwd_dkv_small']:
            lambda: fa.flash_attention_bwd_dkv(*bwd_args)})
    entries = {}
    for kind, line, source in (('dq', 196, 'flash_attention_bwd_dq_small.cu'),
                               ('dkv', 225,
                                'flash_attention_bwd_dkv_small.cu')):
        name = f'flash_attention_bwd_{kind}_small'
        entries[kind] = {
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{source}',
            'replaces': f'skypilot_tpu/ops/pallas/flash_attention.py:{line}',
            'max_abs_err': errs[kind],
            **{key: times[kind][key] for key in (
                'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'tflops', 'shape')},
            'launch': attrs[KERNEL_SYMBOLS[name]]}
    times['fwd']['launch'] = attrs[KERNEL_SYMBOLS[SMALL_KERNEL]]
    for symbol, attr in attrs.items():
        log(f'  launch of {symbol}: {attr}')
    return entries, times['fwd']


def small_kernel_phase(device):
    """The small-head-dim forward against its plain version at
    SMALL_SHAPES, then its time, its plain version's and SDPA's at the
    probe's S=16 shape beside the bound; returns the kernels-line entry
    (launches aside)."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    max_err = 0.0
    for b, hq, hkv, s, d, causal, dtype_name in SMALL_SHAPES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        before = fa.flash_attention_fwd_small.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        torch.cuda.synchronize()
        if fa.flash_attention_fwd_small.launches != before + 1:
            raise SystemExit('flash_attention_fwd did not hand head_dim '
                             f'{d} to the small kernel')
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        ref = ref.float()
        diff = (out.float() - ref).abs()
        ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(torch.finfo(dtype).tiny))))
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        beyond = (diff - ulp).max().item()
        log(f'  flash_fwd_small b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {dtype_name}: out max_abs_err={err:.3e} '
            f'(beyond one output ulp {max(beyond, 0.0):.3e}) lse '
            f'max_abs_err={lse_err:.3e}')
        if not (beyond <= SMALL_ATOL and lse_err <= SMALL_ATOL and
                bool(torch.isfinite(out).all())):
            raise SystemExit(
                f'flash_attention_fwd_small disagrees with its plain '
                f'version at {(b, hq, hkv, s, d, causal, dtype_name)}: out '
                f'{err} ({beyond} beyond one ulp) lse {lse_err}')
        max_err = max(max_err, err, lse_err)

    b, hq, hkv, s, d = SMALL_TIMED_SHAPE
    q = torch.randn((b, hq, s, d), generator=gen,
                    device=device).to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))

    def call():
        return fa.flash_attention_fwd(q, k, v)

    ms = cuda_time_ms(call, iters=200)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_fwd_reference(
        q, k, v), iters=200)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=200)
    bound_ms, bound_by, flops, nbytes = attention_bound(b, hq, hkv, s, d,
                                                        True)
    launch = launch_attrs({KERNEL_SYMBOLS['flash_attention_fwd_small']:
                           call})[KERNEL_SYMBOLS['flash_attention_fwd_small']]
    log(f'  timing b={b} hq={hq} hkv={hkv} s={s} d={d} causal bf16 (the '
        f'perf gate probe\'s prefill): kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound '
        f'{bound_ms:.6f} ms ({bound_by}: {flops} FLOP, {nbytes} B): '
        f'{bound_ms / ms:.2%} of bound; launch {launch}')
    return {
        'name': 'flash_attention_fwd_small', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_attention_fwd_small.cu',
        'replaces': 'skypilot_tpu/ops/pallas/flash_attention.py:37',
        'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': library_ms, 'tflops': flops / ms / 1e9,
        'launch': launch, 'shape': [b, hq, hkv, s, d, True, 'bfloat16'],
    }


# ----- head_dims: every head_dim up to 256 ------------------------------------

# Each kernel width's wrapper suffix, the same for the forward, dq and
# dk/dv (the kernel width of a head_dim is the smallest width a kernel
# takes that is at least the head_dim): the checker's own table of the
# routes ops/cuda/flash_attention.py must take.  At 256 all three run the
# wgmma kernels of that width.
WIDTH_SUFFIX = {16: '_small', 32: '_small', 64: '', 80: '_wide',
                96: '_wide', 128: '', 256: '_256'}
HEAD_DIM_KERNELS = ('fwd', 'bwd_dq', 'bwd_dkv')
# Every native width of the mma.sync kernels and of the wgmma kernels at
# 256, and every padded route: 8 -> 16, 24 -> 32, 48 -> 64, 72 -> 80, 100
# and 112 -> 128, 160 and 200 -> 256.  Cases (b, hq, hkv, s, causal): one
# row, S on both sides of the 32-row (dq's at D = 256) and 64-row tiles and
# of 128, and S = 1000; GQA groups 1, 4 and 8 (Gemma-2B's 8 query heads
# over 1 kv head); causal and not; bf16, and fp16 too at 96 and 256; and
# the head_dims path's own shapes (added after HEAD_DIM_E2E).  Held to
# PERF.md section 2's gates.
HEAD_DIM_SWEEP = (8, 24, 48, 72, 80, 96, 100, 112, 160, 200, 256)
HEAD_DIM_CASES = [
    (b, hq, hkv, s, d, causal, dtype)
    for d in HEAD_DIM_SWEEP
    for b, hq, hkv, s, causal in ((2, 4, 4, 1, True), (2, 8, 2, 17, False),
                                  (1, 8, 1, 63, True), (2, 4, 4, 64, False),
                                  (1, 8, 2, 65, True), (1, 8, 1, 129, False),
                                  (1, 8, 2, 1000, True))
    for dtype in (('bfloat16', 'float16') if d in (96, 256)
                  else ('bfloat16',))]
# (hq, hkv, d) of public models' attention, timed at the training shape
# (b, s) = (2, 4096) and at the serving bucket's (8, 256), causal bf16;
# at Phi-3-mini's also through the padded route 96 -> 128 (the wgmma
# kernels on zero-padded inputs), for a redesign to start from.
HEAD_DIM_FAMILIES = {'phi-2': (32, 32, 80), 'phi-3-mini': (32, 32, 96),
                     'gemma-2b': (8, 1, 256), 'gemma-7b': (16, 16, 256)}
HEAD_DIM_TIMED = {'training': (2, 4096), 'serving': (8, 256)}
# The families whose forward, dq and dk/dv run the wgmma kernels at 256
# (the others the wide mma.sync ones).
HEAD_DIM_256_FAMILIES = ('gemma-2b', 'gemma-7b')
# Llama blocks (RMSNorm, RoPE, SwiGLU, untied or tied embeddings) at the
# attention widths of two public model families, from their config.json:
# Phi-3-mini (3072 = 32 heads x 96, 32 kv heads, ffn 8192, vocab 32064,
# untied) and Gemma-2B (2048 = 8 heads x 256 over 1 kv head, ffn 16384,
# vocab 256000, tied, norm eps 1e-6).  Depth cut to 2 of their 32 and 18
# layers; they are not those models (Phi-3's fused qkv, Gemma's GeGLU and
# embedding scale are not reproduced).  Random weights from SEED; bf16
# params to serve, f32 params and bf16 compute to train.
HEAD_DIM_MODELS = {
    'phi-3-mini': dict(vocab_size=32064, dim=3072, n_heads=32, n_kv_heads=32,
                       ffn_dim=8192, rope_theta=10000.0, norm_eps=1e-5),
    'gemma-2b': dict(vocab_size=256000, dim=2048, n_heads=8, n_kv_heads=1,
                     ffn_dim=16384, rope_theta=10000.0, norm_eps=1e-6,
                     tie_embeddings=True),
}
# Serving: 4 prompts of 219 ids in the 256 bucket, 16 greedy tokens on the
# dense engine (its decode call a CUDA graph); training: 3 Trainer steps
# at 2 x 2048, then grad_check at batch 1.
HEAD_DIM_E2E = dict(n_layers=2, max_seq_len=448, n_slots=4,
                    steps_per_call=16, prefill_buckets=(256,), n_prompts=4,
                    prompt_len=219, max_new=16, train_batch=2,
                    train_seq=2048, train_steps=3, grad_batch=1,
                    warmup_steps=5, total_steps=1000)
# The shapes that path gives the kernels, held to the plain versions with
# the cases above: each model's prefill group (n_prompts rows of the
# bucket) and training batch, causal bf16.
HEAD_DIM_CASES += [
    (b, cfg['n_heads'], cfg['n_kv_heads'], s, cfg['dim'] // cfg['n_heads'],
     True, 'bfloat16')
    for cfg in HEAD_DIM_MODELS.values()
    for b, s in ((HEAD_DIM_E2E['n_prompts'],
                  HEAD_DIM_E2E['prefill_buckets'][-1]),
                 (HEAD_DIM_E2E['train_batch'], HEAD_DIM_E2E['train_seq']))]


def route_launches(d, calls=1, kernels=HEAD_DIM_KERNELS):
    """The launch and padded counts `calls` calls of each of `kernels` at
    head_dim d must leave (read_route_launches' keys)."""
    width = min(w for w in WIDTH_SUFFIX if w >= d)
    want = dict.fromkeys(ROUTED + PADDED, 0)
    for kernel in kernels:
        want[f'flash_attention_{kernel}{WIDTH_SUFFIX[width]}'] += calls
        if width != d:
            want[f'flash_attention_{kernel}.padded'] += calls
    return want


def head_dims_kernel_checks(device):
    """(a) The forward (out, lse), dq and dk/dv at HEAD_DIM_CASES against
    their plain versions, each call launching the kernel of its head_dim's
    width once (and the padded count once where the head_dim is no
    width); head_dim 257 refused.  Returns {wrapper: max |kernel - plain|}
    over the native widths of the `_wide` and `_256` routes, and
    {head_dim: worst numbers}."""
    import torch
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    errs = {f'flash_attention_{kernel}{suffix}': 0.0
            for kernel in HEAD_DIM_KERNELS for suffix in ('_wide', '_256')}
    worst = {}
    for shape in HEAD_DIM_CASES:
        b, hq, hkv, s, d, causal, dtype_name = shape
        dtype = getattr(torch, dtype_name)
        q, g = (torch.randn((b, hq, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        zero_launches()
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          block_size=s, return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        launched = read_route_launches()
        if launched != route_launches(d):
            raise SystemExit(f'head_dim {d} at {shape} launched {launched}, '
                             f'expected {route_launches(d)}')
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        diff = (out.float() - ref.float()).abs()
        nums = {'out': diff.max().item(),
                'lse': (lse - ref_lse).abs().max().item()}
        if not (out.shape == q.shape and bool(torch.isfinite(out).all()) and
                bool((diff <= OUT_ATOL + OUT_RTOL * ref.float().abs()).all())
                and nums['lse'] <= LSE_ATOL):
            raise SystemExit(f'the forward at head_dim {d} disagrees with '
                             f'its plain version at {shape}: {nums}')
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                    causal),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                      delta, causal))
        for name, x, want in zip(('dq', 'dk', 'dv'), (dq, dk, dv), refs):
            err = (x.float() - want.float()).abs().max().item()
            zero = want.float().abs().max().item() <= SMALL_BWD_ZERO_ATOL
            rel = 0.0 if zero else _norm_rel(x, want)
            if not (x.shape == want.shape and bool(torch.isfinite(x).all())
                    and (err <= SMALL_BWD_ZERO_ATOL if zero
                         else rel <= BWD_NORM_RTOL)):
                raise SystemExit(f'the {name} kernel at head_dim {d} '
                                 f'disagrees with its plain version at '
                                 f'{shape}: norm-rel {rel}, max_abs_err '
                                 f'{err}')
            nums[name] = rel
            kernel = 'bwd_dq' if name == 'dq' else 'bwd_dkv'
            key = f'flash_attention_{kernel}{WIDTH_SUFFIX.get(d)}'
            if key in errs:
                errs[key] = max(errs[key], err)
        key = f'flash_attention_fwd{WIDTH_SUFFIX.get(d)}'
        if key in errs:
            errs[key] = max(errs[key], nums['out'], nums['lse'])
        row = worst.setdefault(d, dict.fromkeys(nums, 0.0))
        for key, x in nums.items():
            row[key] = max(row[key], x)
    for d, row in worst.items():
        width = min(w for w in WIDTH_SUFFIX if w >= d)
        route = (('wgmma' if WIDTH_SUFFIX[width] in ('', '_256') else
                  WIDTH_SUFFIX[width].lstrip('_')) + f' kernels at {width}'
                 + (' (zero-padded)' if width != d else ''))
        log(f'  head_dim {d:3d} -> {route}: '
            f'{sum(c[4] == d for c in HEAD_DIM_CASES)} cases, worst out '
            f'max_abs_err {row["out"]:.3e} lse {row["lse"]:.3e}, norm-rel dq '
            f'{row["dq"]:.3e} dk {row["dk"]:.3e} dv {row["dv"]:.3e}; '
            f'launches exact')
    q = torch.zeros((1, 2, 16, 257), dtype=torch.bfloat16, device=device)
    try:
        fa.flash_attention_fwd(q, q, q)
    except ValueError as e:
        log(f'  head_dim 257 refused: {e}')
    else:
        raise SystemExit('head_dim 257 was not refused')
    return errs, worst


def bwd_256_repeats(device):
    """At Gemma-2B's attention (HEAD_DIM_FAMILIES) at HEAD_DIM_TIMED's
    training and serving shapes, where dk/dv at 256 splits its grid
    (plan_dkv_256_split > 1): two calls each of dq and dk/dv, each call
    launching the `_256` kernel once, give the same bits.  Returns
    {shape label: split}."""
    import torch
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    hq, hkv, d = HEAD_DIM_FAMILIES['gemma-2b']
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    splits = {}
    for label, (b, s) in HEAD_DIM_TIMED.items():
        q, g = (torch.randn((b, hq, s, d), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        split = fa.plan_dkv_256_split(b, hq, hkv, s, True,
                                      fa._sm_count(q.device))
        zero_launches()
        first, second = (
            (fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),
             *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta))
            for _ in range(2))
        torch.cuda.synchronize()
        launched = read_route_launches()
        want = route_launches(d, 2, ('bwd_dq', 'bwd_dkv'))
        same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
        log(f'  gemma-2b {label} b={b} s={s}: dk/dv split {split}; two calls '
            f'of dq, dk, dv at 256 bit-identical {same}; launches '
            f'{ {n: c for n, c in launched.items() if c} }')
        if split < 2 or launched != want or not all(same):
            raise SystemExit(f'dq/dk/dv at 256 at gemma-2b {label}: split '
                             f'{split}, bit-identical {same}, launched '
                             f'{launched}, expected {want}')
        splits[label] = split
        del q, k, v, g, out, lse, delta, first, second
        torch.cuda.empty_cache()
    return splits


def padded_route_calls(q, k, v, g, lse, delta, width):
    """The forward, dq and dk/dv through the kernels of `width` on q, k, v
    (and dO) zero-padded to it with the real head_dim's scale, sliced back
    (what the wrappers do for a head_dim no kernel takes), as callables."""
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    d = q.shape[-1]

    def fwd():
        qp, kp, vp = fa._pad_head_dim(width, q, k, v)
        out, lse_ = fa._launch_fwd(*fa._route('fwd', width, q.dtype), qp,
                                   kp, vp, True, True, d**-0.5)
        return out[..., :d].contiguous(), lse_

    def dq():
        qp, kp, vp, gp = fa._pad_head_dim(width, q, k, v, g)
        return fa._launch_dq(*fa._route('bwd_dq', width, q.dtype), qp, kp,
                             vp, gp, lse, delta, True,
                             d**-0.5)[..., :d].contiguous()

    def dkv():
        qp, kp, vp, gp = fa._pad_head_dim(width, q, k, v, g)
        dk, dv = fa._launch_dkv(*fa._route('bwd_dkv', width, q.dtype), qp,
                                kp, vp, gp, lse, delta, True, d**-0.5)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()

    return {'fwd': fwd, 'dq': dq, 'dkv': dkv}


def head_dims_times(device):
    """(b) The wide kernels and those at 256, their plain versions and
    SDPA at HEAD_DIM_FAMILIES' shapes beside the bounds (at Gemma's, the
    forward against SDPA's forward and dq + dk/dv against SDPA's
    backward); at Gemma-2B's the dk/dv kernel at 256
    and its partials' reduce apart (torch.profiler); at Phi-3-mini's also
    the padded route 96 -> 128 (checked against the native kernels'
    results); one profiled launch of each wide kernel at Phi-3-mini's
    training shape and of each kernel at 256 at Gemma-7B's.  Returns
    ({(family, shape label): {kind: numbers}}, {shape label: {kind:
    padded-route ms}}, {symbol: launch attributes})."""
    import torch
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.ops.cuda import probe

    times, padded = {}, {}
    for family, (hq, hkv, d) in HEAD_DIM_FAMILIES.items():
        for label, (b, s) in HEAD_DIM_TIMED.items():
            times[(family, label)] = kernel_times(
                device, (b, hq, hkv, s, d), f'{family} {label}',
                plain_iters=3 if label == 'training' else 20)
            if family not in HEAD_DIM_256_FAMILIES:
                continue
            row = times[(family, label)]
            row['fwd_over_sdpa'] = row['fwd']['ms'] / row['fwd']['library_ms']
            log(f'  {family} {label}: the forward at 256 '
                f'{row["fwd"]["ms"]:.4f} ms, bound '
                f'{row["fwd"]["bound_ms"]:.4f} ms ({row["fwd"]["bound_by"]}; '
                f'x{row["fwd"]["ms"] / row["fwd"]["bound_ms"]:.2f}), SDPA\'s '
                f'forward {row["fwd"]["library_ms"]:.4f} ms (x'
                f'{row["fwd_over_sdpa"]:.2f})')
            pair = row['dq']['ms'] + row['dkv']['ms']
            row['dkv']['split'] = fa.plan_dkv_256_split(
                b, hq, hkv, s, True, fa._sm_count(device))
            row['pair_ms'] = pair
            row['pair_over_sdpa'] = pair / row['dq']['library_ms']
            if row['dkv']['split'] > 1:
                gen = torch.Generator(device=device).manual_seed(SEED + 10)
                q, g = (torch.randn((b, hq, s, d), generator=gen,
                                    device=device).to(torch.bfloat16)
                        for _ in range(2))
                k, v = (torch.randn((b, hkv, s, d), generator=gen,
                                    device=device).to(torch.bfloat16)
                        for _ in range(2))
                out, lse = fa.flash_attention_fwd(q, k, v,
                                                  return_residuals=True)
                delta = (g.float() * out.float()).sum(-1)
                row['dkv']['parts_ms'] = probe.device_ms_by_kernel(
                    lambda: fa.flash_attention_bwd_dkv_256(q, k, v, g, lse,
                                                           delta),
                    ('fa_bwd_dkv_256_kernel', 'fa_bwd_dkv_256_reduce'))
                row['dkv']['partial_bytes'] = (row['dkv']['split'] * b *
                                               hkv * s * d * 8)
                del q, k, v, g, out, lse, delta
                torch.cuda.empty_cache()
            log(f'  {family} {label}: dq + dk/dv at 256 {pair:.4f} ms against '
                f'SDPA\'s backward {row["dq"]["library_ms"]:.4f} ms (x'
                f'{row["pair_over_sdpa"]:.2f}); dq x'
                f'{row["dq"]["ms"] / row["dq"]["bound_ms"]:.2f}, dk/dv x'
                f'{row["dkv"]["ms"] / row["dkv"]["bound_ms"]:.2f} their '
                f'bounds; dk/dv split {row["dkv"]["split"]}' + (
                    f', main kernel / partials\' reduce (torch.profiler) '
                    f'{row["dkv"]["parts_ms"]} ms per call, partials '
                    f'{row["dkv"]["partial_bytes"] / 1e6:.1f} MB'
                    if 'parts_ms' in row['dkv'] else ''))
    hq, hkv, d = HEAD_DIM_FAMILIES['phi-3-mini']
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    for label, (b, s) in HEAD_DIM_TIMED.items():
        q, g = (torch.randn((b, hq, s, d), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        calls = padded_route_calls(q, k, v, g, lse, delta, 128)
        native = {'fwd': (out,),
                  'dq': (fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),),
                  'dkv': fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta)}
        got = {kind: call() for kind, call in calls.items()}
        got['fwd'] = got['fwd'][:1]
        got['dq'] = (got['dq'],)
        rels = {kind: max(_norm_rel(x, y) for x, y in zip(got[kind],
                                                          native[kind]))
                for kind in calls}
        if max(rels.values()) > BWD_NORM_RTOL:
            raise SystemExit(f'the padded route 96 -> 128 disagrees with the '
                             f'native kernels at {label}: {rels}')
        padded[label] = {kind: cuda_time_ms(call)
                         for kind, call in calls.items()}
        native_ms = {kind: times[('phi-3-mini', label)][kind]['ms']
                     for kind in calls}
        log(f'  the padded route 96 -> 128 (wgmma on zero-padded inputs, '
            f'padding and slicing included) at phi-3-mini {label} b={b} '
            f's={s}: ' + ', '.join(
                f'{kind} {padded[label][kind]:.4f} ms (native wide '
                f'{native_ms[kind]:.4f} ms, norm-rel to it {rels[kind]:.1e})'
                for kind in calls))
        del q, k, v, g, out, lse, delta, calls, native, got
        torch.cuda.empty_cache()
    b, s = HEAD_DIM_TIMED['training']
    q, g = (torch.randn((b, hq, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    bwd_args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1))
    attrs = launch_attrs({
        'fa_fwd_mma_kernel': lambda: fa.flash_attention_fwd(
            q, k, v, return_residuals=True),
        'fa_bwd_dq_mma_kernel': lambda: fa.flash_attention_bwd_dq(*bwd_args),
        'fa_bwd_dkv_mma_kernel':
            lambda: fa.flash_attention_bwd_dkv(*bwd_args)})
    for symbol, attr in attrs.items():
        log(f'  launch of {symbol} at head_dim {d}: {attr}')
    del q, k, v, g, out, lse, bwd_args
    torch.cuda.empty_cache()
    hq, hkv, d = HEAD_DIM_FAMILIES['gemma-7b']
    q, g = (torch.randn((b, hq, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    bwd_args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1))
    at_256 = launch_attrs({
        'fa_fwd_256_kernel': lambda: fa.flash_attention_fwd(
            q, k, v, return_residuals=True),
        'fa_bwd_dq_256_kernel': lambda: fa.flash_attention_bwd_dq(*bwd_args),
        'fa_bwd_dkv_256_kernel':
            lambda: fa.flash_attention_bwd_dkv(*bwd_args)})
    for symbol, attr in at_256.items():
        log(f'  launch of {symbol} at gemma-7b training: {attr}')
    attrs.update(at_256)
    del q, k, v, g, out, lse, bwd_args
    torch.cuda.empty_cache()
    return times, padded, attrs


def head_dims_models(device, card, smi):
    """(c) HEAD_DIM_MODELS through the entry points: the dense engine
    serves HEAD_DIM_E2E's prompts (counts zeroed just before, read just
    after: exactly n_layers flash forwards per prefill group, on the
    kernel of the model's head_dim, nothing else), its prefill logits
    within LOGITS_RTOL of attention_impl='xla'; Trainer.run takes 3 steps
    (exactly 2 forwards per layer under remat and one dq and dk/dv per
    layer and step), finite losses, then grad_check (the plain backward
    and xla).  Returns the summed launch counts."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LlamaConfig, Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    spec = HEAD_DIM_E2E
    total = dict.fromkeys(ROUTED + PADDED, 0)
    for family, widths in HEAD_DIM_MODELS.items():
        t0 = time.perf_counter()
        cfg = LlamaConfig(**widths, n_layers=spec['n_layers'],
                          max_seq_len=spec['max_seq_len'],
                          param_dtype=torch.bfloat16)
        params = init_params(cfg, device,
                             torch.Generator(device=device).manual_seed(SEED))
        model = Llama(cfg, params)
        engine = DecodeEngine(model, EngineConfig(
            n_slots=spec['n_slots'], steps_per_call=spec['steps_per_call'],
            prefill_buckets=spec['prefill_buckets']), device=device)
        engine.prewarm()
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size,
                                spec['prompt_len']).tolist()
                   for _ in range(spec['n_prompts'])]
        zero_launches()
        groups = engine.prefill_groups
        streams, wall, ttfts, _ = _drive(engine, prompts, spec['max_new'])
        counts = read_route_launches()
        groups = engine.prefill_groups - groups
        want = route_launches(cfg.head_dim, cfg.n_layers * groups, ('fwd',))
        if counts != want or groups < 1:
            raise SystemExit(f'{family} serving launched {counts} over '
                             f'{groups} prefill groups, expected {want}')
        if any(len(t) != spec['max_new'] or
               not all(0 <= i < cfg.vocab_size for i in t) for t in streams):
            raise SystemExit(f'{family} served {streams}')
        for name, n in counts.items():
            total[name] += n
        xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
        bucket = spec['prefill_buckets'][0]
        toks = torch.zeros((2, bucket), dtype=torch.long, device=device)
        for j in range(2):
            toks[j, :spec['prompt_len']] = torch.tensor(prompts[j])
        with torch.no_grad():
            got = model(toks, decode=True)[0][:, :spec['prompt_len']]
            want_logits = xla(toks, decode=True)[0][:, :spec['prompt_len']]
        err = (got - want_logits).abs().max().item()
        scale = want_logits.abs().max().item()
        log(f'  {family} widths ({cfg.n_layers} layers, dim {cfg.dim}, heads '
            f'{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, ffn '
            f'{cfg.ffn_dim}, vocab {cfg.vocab_size}; '
            f'{cfg.num_params() / 1e9:.3f}B params bf16) on {card}: '
            f'{len(prompts)} x {spec["prompt_len"]} ids, {spec["max_new"]} '
            f'greedy tokens each, graph decode: wall {wall:.3f} s, TTFT p50 '
            f'{_p50(ttfts) * 1e3:.1f} ms; launches {counts} over {groups} '
            f'prefill groups; prefill logits flash vs xla max_abs_err '
            f'{err:.4f} of max |logit| {scale:.3f} (rel {err / scale:.2e}, '
            f'gate {LOGITS_RTOL}); init + prewarm + serve '
            f'{time.perf_counter() - t0:.1f} s')
        if not (torch.isfinite(got).all() and err <= LOGITS_RTOL * scale):
            raise SystemExit(f'{family} prefill logits through the kernel '
                             f'disagree with attention_impl=xla')
        del engine, model, xla, params, got, want_logits
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        cfg = dataclasses.replace(cfg, max_seq_len=spec['train_seq'],
                                  param_dtype=torch.float32)
        model = Llama(cfg, init_params(
            cfg, device, torch.Generator(device=device).manual_seed(SEED)))
        trainer = Trainer(model, TrainConfig(
            warmup_steps=spec['warmup_steps'],
            total_steps=spec['total_steps']), device=device)
        tokens = torch.randint(
            0, cfg.vocab_size, (spec['train_batch'], spec['train_seq']),
            device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + 2))
        steps = spec['train_steps']
        losses = []
        train_step = trainer.train_step

        def recording_step(state, tokens_, train_step=train_step,
                           losses=losses):
            state, metrics = train_step(state, tokens_)
            losses.append(metrics['loss'])
            return state, metrics

        trainer.train_step = recording_step
        zero_launches()
        t1 = time.perf_counter()
        trainer.run(iter([tokens] * steps), steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = read_route_launches()
        trainer.train_step = train_step
        losses = [float(x) for x in losses]
        fwd_per_layer = 2 if cfg.remat else 1
        want = route_launches(cfg.head_dim, cfg.n_layers * steps,
                              ('bwd_dq', 'bwd_dkv'))
        want = {name: n + (route_launches(cfg.head_dim, fwd_per_layer *
                                          cfg.n_layers * steps,
                                          ('fwd',))[name])
                for name, n in want.items()}
        log(f'  {family} widths trained: {cfg.num_params() / 1e9:.3f}B params '
            f'f32, compute {cfg.dtype}, remat {cfg.remat}; {steps} steps at '
            f'{spec["train_batch"]} x {spec["train_seq"]} on {smi}: '
            f'{wall / steps * 1e3:.1f} ms a step; losses '
            f'{[round(x, 4) for x in losses]}; launches {counts}')
        if counts != want:
            raise SystemExit(f'{family} training launched {counts}, '
                             f'expected {want}')
        if not all(map(math.isfinite, losses)):
            raise SystemExit(f'{family}: non-finite loss {losses}')
        for name, n in counts.items():
            total[name] += n
        grad_check(trainer.model, cfg, tokens[:spec['grad_batch']])
        log(f'  {family} widths: train + gradient check '
            f'{time.perf_counter() - t0:.1f} s')
        del trainer, model, tokens
        gc.collect()
        torch.cuda.empty_cache()
    return total


def head_dims_phase(device, card, smi, ptxas):
    """(a) with the bit-identity check at 256, (b), (c) above; returns
    (the kernels-line entries of the three wide kernels and of the three
    at 256, launches aside; the launch counts of (c))."""
    t0 = time.perf_counter()
    errs, worst = head_dims_kernel_checks(device)
    splits = bwd_256_repeats(device)
    t1 = time.perf_counter()
    times, padded, attrs = head_dims_times(device)
    t2 = time.perf_counter()
    counts = head_dims_models(device, card, smi)
    log(f'  head_dims split: (a) checks {t1 - t0:.1f} s, (b) times '
        f'{t2 - t1:.1f} s, (c) models {time.perf_counter() - t2:.1f} s')
    entries = {}
    for kind, kernel, line in (('fwd', 'fwd', 37), ('dq', 'bwd_dq', 196),
                               ('dkv', 'bwd_dkv', 225)):
        name = f'flash_attention_{kernel}_wide'
        symbol = KERNEL_SYMBOLS[name]
        widths = tuple(w for w, sfx in WIDTH_SUFFIX.items()
                       if sfx == '_wide')
        at = {f'{family} {label}': times[(family, label)][kind]
              for family, label in times
              if HEAD_DIM_FAMILIES[family][2] in widths}
        report = {d: ptxas.get((symbol, 'bf16', d), {}) for d in widths}
        entries[kind] = {
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/flash_attention_{kernel}'
                      f'_wide.cu',
            'replaces': f'skypilot_tpu/ops/pallas/flash_attention.py:{line}',
            'max_abs_err': errs[name],
            # The kernels-line numbers at Phi-3-mini's training shape; every
            # timed shape of its widths under at_shapes.
            **{key: times[('phi-3-mini', 'training')][kind][key] for key in (
                'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'tflops', 'shape')},
            'at_shapes': at,
            'padded_route_96_to_128_ms': {label: padded[label][kind]
                                          for label in padded},
            'registers': max((r.get('registers') or 0)
                             for r in report.values()) or None,
            'registers_by_head_dim': {d: r.get('registers')
                                      for d, r in report.items()},
            'spill_bytes': max((r.get('spill_stores') or 0)
                               for r in report.values())
                           if any(report.values()) else None,
            'smem_bytes': attrs[symbol].get('shared memory'),
            'launch': attrs[symbol],
            'head_dims_checked': {d: worst[d] for d in worst}}
    # The three at 256 (wgmma): the kernels-line numbers at Gemma-7B's
    # training shape, every Gemma shape under at_shapes (the forward beside
    # SDPA's forward, dq and dk/dv as a pair beside SDPA's backward);
    # dk/dv's split at each, its main kernel and partials' reduce apart at
    # Gemma-2B's.
    for kind, kernel, line in (('fwd', 'fwd', 37), ('dq', 'bwd_dq', 196),
                               ('dkv', 'bwd_dkv', 225)):
        name = f'flash_attention_{kernel}_256'
        symbol = KERNEL_SYMBOLS[name]
        report = ptxas.get((symbol, 'bf16', 256), {})
        reduce = ptxas.get(('fa_bwd_dkv_256_reduce', 'bf16', 256), {})
        keys = (('fwd_over_sdpa',) if kind == 'fwd' else
                ('pair_ms', 'pair_over_sdpa'))
        at = {f'{family} {label}': {
            **times[(family, label)][kind],
            **{key: times[(family, label)][key] for key in keys}}
            for family, label in times if family in HEAD_DIM_256_FAMILIES}
        entries[f'{kind}_256'] = {
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/flash_attention_{kernel}'
                      f'_256.cu',
            'replaces': f'skypilot_tpu/ops/pallas/flash_attention.py:{line}',
            'max_abs_err': errs[name],
            **{key: times[('gemma-7b', 'training')][kind][key] for key in (
                'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'tflops', 'shape')},
            'at_shapes': at,
            'registers': report.get('registers'),
            'spill_bytes': report.get('spill_stores'),
            **({'reduce_registers': reduce.get('registers'),
                'reduce_spill_bytes': reduce.get('spill_stores'),
                'bit_identical_at_split': splits} if kind == 'dkv' else {}),
            'smem_bytes': attrs[symbol].get('shared memory'),
            'launch': attrs[symbol],
            'head_dims_checked': {d: worst[d] for d in (160, 200, 256)
                                  if d in worst}}
    return entries, counts


# ----- f32: the three kernels in 3xTF32 ---------------------------------------

# The f32 kernels (csrc/flash_attention_*_f32.cu, 3xTF32 mma.sync at every
# width) timed at the f32 serving shape (llama2-7b's prefill bucket on one
# device: 8 x 256, 32 heads of 128), at one rank's share of it in
# tensor_serving (c) (TP_SHAPE: 16 of the 32 heads) and at the f32
# training shape (F32_TRAIN's: bench-1b at 2 x 4096, 16 query heads over 8
# kv heads of 128), causal, beside their plain versions in full f32 (TF32
# matmuls off), SDPA in f32 and the f32 bounds (4-byte elements over
# 3.35 TB/s, the flops over TF32's 495 TFLOP/s).  At each shape every
# kernel's outputs are held to its plain version's under the probe's f32
# gates (F32_OUT_TOL, F32_NORM_RTOL).
F32_TIMED = {'serving': (8, 32, 32, 256, 128),
             'tensor_serving': TP_SHAPE,
             'training': (2, 16, 8, 4096, 128)}
# f32 training: bench-1b (bench.py:58-115) at full width, 2 of its 14
# layers, f32 params and compute, its remat, 3 steps at 2 x 4096 through
# Trainer.run; attention_impl 'xla' on the same weights and batch first.
F32_TRAIN = dict(model='bench-1b', n_layers=2, batch=2, seq=4096, steps=3,
                 grad_batch=1, warmup_steps=5, total_steps=1000)
# Its gates: each step's loss within F32_LOSS_RTOL (relative) of 'xla';
# one step's gradients within F32_GRAD_RTOL (norm-relative, every tensor)
# of the same step through the backward kernels' plain versions, each
# attention backward within it on its own inputs; against 'xla' the worst
# tensor and the whole gradient within F32_XLA_GRAD_RTOL.  All f32 on
# both sides: 3xTF32's rounding (near 2^-21) against f32's, a
# thousandth of the bf16 gates'.
F32_LOSS_RTOL = 1e-4
F32_GRAD_RTOL = 1e-4
F32_XLA_GRAD_RTOL = 1e-3
# f32 prefill logits through the f32 kernels against attention_impl='xla'
# on the same params (tensor_serving (c), moe_tensor_serving (c)): max
# |difference| over max |logit|, f32 class (the bf16 paths' LOGITS_RTOL
# is 500 times wider).
F32_LOGITS_RTOL = 1e-4


def f32_kernel_phase(device, ptxas):
    """(a) `python -m skypilot_tpu_torch.ops.cuda.probe check f32`'s cases
    (probe.F32_CHECK_SHAPES: the JAX tests' Pallas shapes, every native
    f32 width at its tile edges, the padded head_dims) under the f32
    gates, each call launching its f32 kernel once, f64 and head_dim 257
    refused; (b) the three f32 kernels timed at F32_TIMED and held to
    their plain versions there under the same gates; (c) one profiled
    launch of each at the training shape.  Returns the three f32
    kernels' kernels-line entries, launches aside."""
    import torch
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.ops.cuda import probe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    worst = probe.check_f32(quiet=True)
    t1 = time.perf_counter()
    times = {label: kernel_times(device, shape, f'f32 {label}',
                                 plain_iters=3 if label == 'training' else 20,
                                 dtype_name='float32')
             for label, shape in F32_TIMED.items()}
    b, hq, hkv, s, d = F32_TIMED['training']
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    q, g = (torch.randn((b, hq, s, d), generator=gen, device=device)
            for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=device)
            for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    bwd_args = (q, k, v, g, lse, (g * out).sum(-1))
    attrs = launch_attrs({
        'fa_fwd_mma_kernel': lambda: fa.flash_attention_fwd(
            q, k, v, return_residuals=True),
        'fa_bwd_dq_mma_kernel': lambda: fa.flash_attention_bwd_dq(*bwd_args),
        'fa_bwd_dkv_mma_kernel':
            lambda: fa.flash_attention_bwd_dkv(*bwd_args)})
    for symbol, attr in attrs.items():
        log(f'  launch of {symbol} in f32 at head_dim {d}: {attr}')
    del q, k, v, g, out, lse, bwd_args
    torch.cuda.empty_cache()
    log(f'  f32 split: (a) checks {t1 - t0:.1f} s, (b) and (c) times '
        f'{time.perf_counter() - t1:.1f} s')
    entries = {}
    for kind, kernel, line, abs_key in (('fwd', 'fwd', 37, None),
                                        ('dq', 'bwd_dq', 196, 'dq_abs'),
                                        ('dkv', 'bwd_dkv', 225, 'dkv_abs')):
        name = f'flash_attention_{kernel}_f32'
        symbol = KERNEL_SYMBOLS[name]
        report = {w: ptxas.get((symbol, 'f32', w), {})
                  for w in fa.KERNEL_WIDTHS}
        entries[kind] = {
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/flash_attention_{kernel}'
                      f'_f32.cu',
            'replaces': f'skypilot_tpu/ops/pallas/flash_attention.py:{line}',
            'max_abs_err': (max(worst['out_abs'], worst['lse_abs'])
                            if abs_key is None else worst[abs_key]),
            # The kernels-line numbers at the f32 training shape; the
            # serving shape's under at_shapes.
            **{key: times['training'][kind][key] for key in (
                'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'library_kernel', 'tflops', 'shape')},
            'at_shapes': {f'f32 {label}': times[label][kind]
                          for label in times},
            'registers': max((r.get('registers') or 0)
                             for r in report.values()) or None,
            'registers_by_head_dim': {w: r.get('registers')
                                      for w, r in report.items()},
            'spill_bytes': max((r.get('spill_stores') or 0)
                               for r in report.values())
                           if any(report.values()) else None,
            'smem_bytes': attrs[symbol].get('shared memory'),
            'launch': attrs[symbol],
            'f32_check': {key: worst[key] for key in (
                'out_abs', 'lse_abs', 'dq', 'dk', 'dv', 'zero_abs')}}
    return entries


def f32_training_phase(device, card, smi):
    """F32_TRAIN: bench-1b at full width and 2 layers in f32 through
    Trainer.run, first with attention_impl='xla' (its losses kept, the
    trainer freed), then through the kernels on the same weights and batch
    with every counter zeroed just before and read just after: exactly
    the f32 forward (2 a layer under remat), dq and dk/dv (1 a layer) per
    step and nothing else; each step's loss within F32_LOSS_RTOL of xla's;
    then grad_check at the f32 gates.  Returns the launch counts."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    spec = F32_TRAIN
    cfg = dataclasses.replace(LLAMA_CONFIGS[spec['model']],
                              n_layers=spec['n_layers'],
                              max_seq_len=spec['seq'], dtype=torch.float32,
                              param_dtype=torch.float32)
    steps = spec['steps']
    tokens = torch.randint(
        0, cfg.vocab_size, (spec['batch'], spec['seq']), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 2))

    def run(c, before_run=None):
        model = Llama(c, init_params(
            c, device, torch.Generator(device=device).manual_seed(SEED)))
        trainer = Trainer(model, TrainConfig(
            warmup_steps=spec['warmup_steps'],
            total_steps=spec['total_steps']), device=device)
        losses = []
        train_step = trainer.train_step

        def recording_step(state, tokens_):
            state, metrics = train_step(state, tokens_)
            losses.append(metrics['loss'])
            return state, metrics

        trainer.train_step = recording_step
        if before_run:
            before_run()
        t0 = time.perf_counter()
        trainer.run(iter([tokens] * steps), steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer.train_step = train_step
        return trainer, [float(x) for x in losses], wall

    trainer, losses_x, wall_x = run(dataclasses.replace(
        cfg, attention_impl='xla'))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, losses, wall = run(cfg, zero_launches)
    counts = read_route_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_per_layer = 2 if cfg.remat else 1
    want = dict(dict.fromkeys(ROUTED + PADDED, 0),
                flash_attention_fwd_f32=fwd_per_layer * cfg.n_layers * steps,
                flash_attention_bwd_dq_f32=cfg.n_layers * steps,
                flash_attention_bwd_dkv_f32=cfg.n_layers * steps)
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, losses_x)]
    log(f'  {spec["model"]} in f32 ({cfg.n_layers} of 14 layers, '
        f'{cfg.num_params() / 1e9:.3f}B params, remat {cfg.remat}), '
        f'{steps} steps at {spec["batch"]} x {spec["seq"]} on {smi}: '
        f'kernels {wall / steps * 1e3:.1f} ms a step, xla '
        f'{wall_x / steps * 1e3:.1f} ms; peak {peak_gb:.2f} GB; losses '
        f'{losses} against xla {losses_x}: rel {[f"{r:.2e}" for r in rels]} '
        f'(gate {F32_LOSS_RTOL}); launches '
        f'{ {n: c for n, c in counts.items() if c} }')
    if counts != want:
        raise SystemExit(f'f32 training launched {counts}, expected {want}')
    if not (len(losses) == len(losses_x) == steps and
            all(map(math.isfinite, losses)) and
            max(rels) <= F32_LOSS_RTOL):
        raise SystemExit(f'f32 training losses {losses} disagree with '
                         f'attention_impl=xla {losses_x}')
    grad_check(trainer.model, cfg, tokens[:spec['grad_batch']],
               plain_rtol=F32_GRAD_RTOL, call_rtol=F32_GRAD_RTOL,
               xla_rtols=(F32_LOSS_RTOL, F32_XLA_GRAD_RTOL,
                          F32_XLA_GRAD_RTOL))
    del trainer, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


async def _post_all(port, bodies):
    import aiohttp
    url = f'http://127.0.0.1:{port}/v1/completions'
    timeout = aiohttp.ClientTimeout(total=900)
    async with aiohttp.ClientSession(timeout=timeout) as session:

        async def one(body):
            async with session.post(url, json=body) as resp:
                return resp.status, await resp.json()

        return await asyncio.gather(*(one(b) for b in bodies))


def _forget_app_handlers() -> None:
    """aiohttp caches each app's middleware-wrapped handlers in a
    module-level LRU (keyed by handler and app), which keeps a closed
    app's engine, with its model and KV cache, alive; clear it once an
    app is done (where this aiohttp has that cache)."""
    from aiohttp import web_app
    cached = getattr(web_app, '_cached_build_middleware', None)
    if cached is not None:
        cached.cache_clear()


async def _get(session, url):
    async with session.get(url) as resp:
        if resp.content_type == 'application/json':
            return resp.status, await resp.json()
        return resp.status, await resp.text()


async def _serve_measured(engine, warm, burst):
    """Start the port's HTTP app on a local port (the engine's loop
    already running) and POST the warm batch.  Then the burst twice:
    first under a PROFILE_MS /debug/profile capture opened just before
    it, with a second capture sent while the first is open; then alone,
    bracketed by perf_reset_window() under a window longer than the run.
    After its last reply the loop is stopped and the window closed (one
    _sample_perf), then /metrics and the capture's artifact are read
    over HTTP.  Returns (warm replies, the profiled burst's (wall s,
    replies), the measured burst's (wall s, replies), the second
    capture's status, the first's reply and client-side wall s, its
    artifact bytes, the /metrics text)."""
    import aiohttp
    from aiohttp import web
    from skypilot_tpu_torch.inference.server import build_app

    runner = web.AppRunner(build_app(engine))
    await runner.setup()
    port = _free_port()
    site = web.TCPSite(runner, '127.0.0.1', port)
    await site.start()
    base = f'http://127.0.0.1:{port}'
    timeout = aiohttp.ClientTimeout(total=900)
    try:
        warm_replies = await _post_all(port, warm)
        async with aiohttp.ClientSession(timeout=timeout) as session:
            t_prof = time.perf_counter()
            first = asyncio.ensure_future(_get(
                session, f'{base}/debug/profile?duration_ms={PROFILE_MS}'))
            await asyncio.sleep(0.1)
            second_status, _ = await _get(
                session, f'{base}/debug/profile?duration_ms=10')
            t0 = time.perf_counter()
            profiled = await _post_all(port, burst)
            profiled_wall = time.perf_counter() - t0
            status, doc = await first
            prof_wall = time.perf_counter() - t_prof
            if status != 200:
                raise SystemExit(f'/debug/profile failed: {status} {doc}')
            engine.perf_window_s = 1e9
            t0 = time.perf_counter()
            engine.perf_reset_window()
            replies = await _post_all(port, burst)
            wall = time.perf_counter() - t0
            engine.stop()
            engine.perf_window_s = 0.0
            engine._sample_perf()
            _, metrics_text = await _get(session, f'{base}/metrics')
        # The artifact's bytes as stored (a .json.gz may be served with
        # Content-Encoding: gzip, which the client would undo).
        async with aiohttp.ClientSession(timeout=timeout,
                                         auto_decompress=False) as raw:
            async with raw.get(f'{base}/debug/profile/artifact/'
                               f'{doc["artifact"]}') as resp:
                if resp.status != 200:
                    raise SystemExit(f'artifact route: {resp.status}')
                artifact = await resp.read()
        return (warm_replies, (profiled_wall, profiled), (wall, replies),
                second_status, doc, prof_wall, artifact, metrics_text)
    finally:
        engine.stop()
        await runner.cleanup()
        _forget_app_handlers()


async def _serve_queued(engine, bodies):
    """Start the port's HTTP app on a local port, POST every body
    concurrently, and start the engine's loop only once all of them are
    queued, so admission is what `_drive` gives (one group per bucket,
    chunked prompts after); returns (wall s from the loop's start,
    replies in body order)."""
    from aiohttp import web
    from skypilot_tpu_torch.inference.server import build_app

    runner = web.AppRunner(build_app(engine))
    await runner.setup()
    port = _free_port()
    site = web.TCPSite(runner, '127.0.0.1', port)
    await site.start()
    try:
        posted = asyncio.ensure_future(_post_all(port, bodies))
        while (engine._prefill_q.qsize() + engine._long_q.qsize() <
               len(bodies)):
            if posted.done():
                break            # a reply before the loop ran: an error
            await asyncio.sleep(0.005)
        t0 = time.perf_counter()
        engine.start()
        replies = await posted
        return time.perf_counter() - t0, replies
    finally:
        engine.stop()
        await runner.cleanup()
        _forget_app_handlers()


KERNEL_NAMES = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                'flash_attention_bwd_dkv')


# The small-head-dim kernels' wrappers (head_dim 16 and 32): counted
# apart from KERNEL_NAMES, whose counts the phases with no model of
# head_dim 16 or 32 check exactly.
SMALL_KERNEL = 'flash_attention_fwd_small'
SMALL_KERNELS = (SMALL_KERNEL, 'flash_attention_bwd_dq_small',
                 'flash_attention_bwd_dkv_small')


# The wide-head-dim kernels' wrappers (head_dim 80 and 96), the wrappers
# of the three at 256 (wgmma), and the public wrappers' counts of calls
# that took the zero-padded route (a head_dim no kernel takes, padded to
# the next width).
WIDE_KERNELS = ('flash_attention_fwd_wide', 'flash_attention_bwd_dq_wide',
                'flash_attention_bwd_dkv_wide')
KERNELS_256 = ('flash_attention_fwd_256', 'flash_attention_bwd_dq_256',
               'flash_attention_bwd_dkv_256')
PADDED = tuple(f'{name}.padded' for name in KERNEL_NAMES)
# The f32 kernels' wrappers (3xTF32 mma.sync at every width): every f32
# call on a CUDA tensor launches one of these.
F32_KERNELS = ('flash_attention_fwd_f32', 'flash_attention_bwd_dq_f32',
               'flash_attention_bwd_dkv_f32')
ROUTED = (KERNEL_NAMES + SMALL_KERNELS + WIDE_KERNELS + KERNELS_256 +
          F32_KERNELS)


def zero_launches() -> None:
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    for name in ROUTED:
        getattr(fa, name).launches = 0
    for name in KERNEL_NAMES:
        getattr(fa, name).padded_launches = 0


def read_route_launches() -> dict:
    """Every flash wrapper's launches and every padded-route count."""
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    counts = {name: getattr(fa, name).launches for name in ROUTED}
    counts.update({f'{name}.padded': getattr(fa, name).padded_launches
                   for name in KERNEL_NAMES})
    return counts


def read_launches() -> dict:
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    return {name: getattr(fa, name).launches for name in KERNEL_NAMES}


def read_small_launches() -> dict:
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    return {name: getattr(fa, name).launches for name in SMALL_KERNELS}


def serving_phase(device, card):
    """llama2-7b through the HTTP app; returns the kernels' launch counts
    of this run (the counters are zeroed just before it) and what the
    paged phase reuses: the weights, the model and the prompts."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params

    cfg = dataclasses.replace(LLAMA_CONFIGS[SERVE['model']],
                              n_layers=SERVE['n_layers'],
                              max_seq_len=SERVE['max_seq_len'],
                              param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(SEED))
    model = Llama(cfg, params)
    torch.cuda.synchronize()
    log(f'  {SERVE["model"]}: {cfg.num_params() / 1e9:.3f}B params bf16, '
        f'{cfg.n_layers} layers, dim {cfg.dim}, init '
        f'{time.perf_counter() - t0:.1f} s')
    engine = DecodeEngine(
        model, EngineConfig(n_slots=SERVE['n_slots'],
                            steps_per_call=SERVE['steps_per_call'],
                            prefill_buckets=SERVE['prefill_buckets']),
        device=device)
    engine.prewarm()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE['prompt_len']).tolist()
               for _ in range(SERVE['n_prompts'])]
    long_prompt = rng.integers(0, cfg.vocab_size,
                               SERVE['long_prompt_len']).tolist()
    n_new = SERVE['max_tokens']
    warm = [{'prompt_ids': prompts[0][:40], 'max_tokens': 4}]
    burst = [{'prompt_ids': p, 'max_tokens': n_new}
             for p in prompts + [long_prompt]]

    torch.cuda.reset_peak_memory_stats()
    builds = builds_now()
    zero_launches()
    groups_before = engine.prefill_groups
    engine.start()
    try:
        (warm_replies, (prof_burst_wall, prof_replies), (wall, replies),
         busy_status, prof, prof_wall, artifact, metrics_text) = \
            asyncio.run(_serve_measured(engine, warm, burst))
    finally:
        engine.stop()
    counts = read_launches()
    check_no_builds(builds, 'the HTTP serving engine')
    launches = counts['flash_attention_fwd']
    groups = engine.prefill_groups - groups_before
    if not engine.healthy:
        raise SystemExit(f'engine crashed: {engine.error!r}')
    for status, body in warm_replies + prof_replies + replies:
        if status != 200:
            raise SystemExit(f'request failed: {status} {body}')
    for (status, body), req in zip(prof_replies + replies, burst + burst):
        if len(body['ids']) != n_new:
            raise SystemExit(f'{len(body["ids"])} ids for a request of '
                             f'{n_new}: {body}')
        if not all(0 <= i < cfg.vocab_size for i in body['ids']):
            raise SystemExit(f'token id out of range: {body["ids"]}')
    if groups < 1 or launches < cfg.n_layers * groups:
        raise SystemExit(f'flash kernel launched {launches} times over '
                         f'{groups} prefill groups of {cfg.n_layers} layers')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttfts = sorted(body['usage']['ttft_ms'] for _, body in replies)
    out_toks = sum(len(body['ids']) for _, body in replies)
    log(f'  served {len(replies)} requests ({SERVE["n_prompts"]} x '
        f'{SERVE["prompt_len"]} + 1 x {SERVE["long_prompt_len"]} tokens, '
        f'{n_new} new each) on {card}: wall {wall:.3f} s, '
        f'{out_toks / wall:.1f} out-tok/s, TTFT ms p50 '
        f'{ttfts[len(ttfts) // 2]:.1f} max {ttfts[-1]:.1f}, peak memory '
        f'{peak_gb:.2f} GB; flash launches {launches} over {groups} '
        f'prefill groups of both bursts')
    prof_ttfts = sorted(body['usage']['ttft_ms'] for _, body in prof_replies)
    log(f'  the same burst under the {PROFILE_MS} ms /debug/profile window '
        f'(served before it): wall {prof_burst_wall:.3f} s, '
        f'{out_toks / prof_burst_wall:.1f} out-tok/s, TTFT ms p50 '
        f'{prof_ttfts[len(prof_ttfts) // 2]:.1f} max {prof_ttfts[-1]:.1f}')
    check_gauges(engine, cfg, burst, replies, wall, metrics_text, card)
    check_profile(prof, busy_status, prof_wall, artifact, card)
    trip_sentinel(engine)

    # Kernel vs plain attention on the serving path itself: prefill
    # logits of two prompts through attention_impl 'flash' and 'xla'
    # (same weights).  Not part of the counted run.
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    bucket = SERVE['prefill_buckets'][0]
    toks = torch.zeros((2, bucket), dtype=torch.long, device=device)
    for j in range(2):
        toks[j, :SERVE['prompt_len']] = torch.tensor(prompts[j])
    with torch.no_grad():
        got, _ = model(toks, decode=True)
        want, _ = xla(toks, decode=True)
    got = got[:, :SERVE['prompt_len']]
    want = want[:, :SERVE['prompt_len']]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f'  prefill logits flash vs xla: max_abs_err {err:.4f} of max '
        f'|logit| {scale:.3f} (rel {err / scale:.2e}), argmax agreement '
        f'{agree:.4f}')
    if not (torch.isfinite(got).all() and err <= LOGITS_RTOL * scale):
        raise SystemExit('prefill logits through the kernel disagree with '
                         'attention_impl=xla')
    profile_step(engine, prompts, card)
    ctx = {'cfg': cfg, 'params': params, 'model': model, 'prompts': prompts,
           'long_prompt': long_prompt,
           'http_ids': [body['ids'] for _, body in replies]}
    return counts, ctx


def builds_now():
    """(builds counted by the port's compile telemetry, perf.recompile
    events recorded) so far: the kernel library's nvcc build and every
    decode / verify call object (on the card: its CUDA graph capture)."""
    from skypilot_tpu_torch.perf import compile_telemetry
    from skypilot_tpu_torch.server import tracing
    return (_counter('skytpu_engine_xla_compile_total'),
            len(tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)))


def check_no_builds(before, what):
    """Fail if anything was built, or a post-warmup build recorded, since
    `before` (builds_now()): every engine here is prewarmed, so its
    traffic must build nothing (SKYTPU_STRICT_RECOMPILE=1 would also
    have raised inside the engine loop)."""
    after = builds_now()
    if after != before:
        raise SystemExit(f'{what}: builds/sentinel events went from '
                         f'{before} to {after} after prewarm()')


def trip_sentinel(engine):
    """The strict sentinel trips: a decode call built on the prewarmed,
    armed engine raises the post-warmup error before any capture, and
    records perf.recompile under the sentinel's request id."""
    from skypilot_tpu_torch.perf import compile_telemetry
    from skypilot_tpu_torch.server import tracing
    events = len(tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID))
    try:
        engine._new_decode_call()
    except RuntimeError as e:
        if 'post-warmup decode build' not in str(e):
            raise
        got = tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
        if len(got) != events + 1 or got[-1]['name'] != 'perf.recompile':
            raise SystemExit(f'no perf.recompile event recorded: {got}')
        log(f'  sentinel (SKYTPU_STRICT_RECOMPILE='
            f'{os.environ.get(compile_telemetry.STRICT_ENV)}, armed '
            f'{compile_telemetry.armed()}): a decode call built after '
            f'prewarm raised "{str(e)[:70]}..."; event '
            f'{got[-1]["attrs"]}')
        return
    raise SystemExit('a decode call built after prewarm() did not trip the '
                     'strict recompile sentinel')


def _gauges(text):
    """The three perf gauges of a /metrics exposition text."""
    names = ('skytpu_engine_mfu', 'skytpu_engine_hbm_bytes_per_token',
             'skytpu_engine_arith_intensity')
    out = {}
    for line in text.splitlines():
        name = line.split(' ')[0]
        if name in names:
            out[name] = float(line.rsplit(' ', 1)[1])
    if set(out) != set(names):
        raise SystemExit(f'/metrics lacks perf gauges: {sorted(out)}')
    return out


def check_gauges(engine, cfg, burst, replies, wall, metrics_text, card):
    """The live gauges read from /metrics against the cost model at the
    burst's rate (its tokens over this script's wall clock) and mean
    context (each emitted token's context: its prompt plus the tokens up
    to it, as the engine weights it), within PERF_GAUGE_RTOL; the byte
    terms at the engine's token-weighted occupancy.  Prints the snapshot
    and the decode roofline at full occupancy."""
    cm = engine.perf_cost_model
    snap = engine.perf_snapshot()
    gauges = _gauges(metrics_text)
    n_toks = sum(len(body['ids']) for _, body in replies)
    ctx_sum = sum(len(req['prompt_ids']) * len(body['ids']) +
                  len(body['ids']) * (len(body['ids']) + 1) / 2
                  for req, (_, body) in zip(burst, replies))
    rate, mean_ctx = n_toks / wall, ctx_sum / n_toks
    occ = snap['mean_occupancy']
    want = {'skytpu_engine_mfu': cm.mfu(rate, mean_ctx),
            'skytpu_engine_hbm_bytes_per_token':
                cm.decode_hbm_bytes_per_token(mean_ctx, occ),
            'skytpu_engine_arith_intensity': cm.arith_intensity(mean_ctx,
                                                                occ)}
    n_slots = engine.cfg.n_slots
    roof = cm.roofline_decode_tokens_per_s(mean_ctx, n_slots)
    log(f'  perf gauges on {card}: cost model {cm}; perf_snapshot '
        f'{snap}; burst {n_toks} tokens in {wall:.4f} s = {rate:.2f} '
        f'tok/s at mean context {mean_ctx:.2f}')
    for name, value in gauges.items():
        log(f'    {name}: /metrics {value:.6g}, cost model at the measured '
            f'rate {want[name]:.6g} (rel {value / want[name] - 1:+.4f}, gate '
            f'{PERF_GAUGE_RTOL})')
    log(f'    decode roofline at occupancy {n_slots}, context '
        f'{mean_ctx:.1f}: {roof:.1f} tok/s (compute bound '
        f'{PEAK_BF16_FLOPS / cm.decode_flops_per_token(mean_ctx):.0f}); '
        f'bytes/token {cm.decode_hbm_bytes_per_token(mean_ctx, n_slots):.6g}'
        f', intensity {cm.arith_intensity(mean_ctx, n_slots):.4f} FLOP/B; '
        f'kv_bytes_per_pos {cm.kv_bytes_per_pos():.0f}; burst rate '
        f'{rate / roof:.2%} of it')
    if not 1.0 <= occ <= n_slots:
        raise SystemExit(f'mean occupancy {occ} outside [1, {n_slots}]')
    for name, value in gauges.items():
        if abs(value / want[name] - 1) > PERF_GAUGE_RTOL:
            raise SystemExit(f'{name} {value} is off the cost model\'s '
                             f'{want[name]} by more than {PERF_GAUGE_RTOL}')


def check_profile(doc, busy_status, wall, artifact, card):
    """The /debug/profile capture over the serving burst: 200 with a
    summary, 409 for the capture sent while it was open, the artifact
    fetched whole through the artifact route, and its gunzipped chrome
    trace holding the flash forward kernel (by symbol) and kernels of
    the decode graph: a graph replay is one launch, so its kernels share
    one correlation id, where every eager launch has its own (the
    cudaGraphLaunch call itself may precede the window or miss the
    trace, so it is counted, not required)."""
    import collections
    import gzip
    if busy_status != 409:
        raise SystemExit(f'a capture sent while one was open got '
                         f'{busy_status}, not 409')
    if len(artifact) != doc['size_bytes']:
        raise SystemExit(f'artifact of {len(artifact)} bytes, summary says '
                         f'{doc["size_bytes"]}')
    raw = gzip.decompress(artifact)
    events = json.loads(raw)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    flash = [e for e in kernels
             if KERNEL_SYMBOLS['flash_attention_fwd'] in e['name']]
    graph_launches = [e for e in events
                      if e.get('name', '').startswith('cudaGraphLaunch')]
    per_launch = collections.Counter(e['args']['correlation']
                                     for e in kernels)
    in_graph = sum(n for n in per_launch.values() if n > 1)
    largest = max(per_launch.values(), default=0)
    cats = sorted({e.get('cat', '') for e in events})
    log(f'  /debug/profile on {card}: {PROFILE_MS} ms window, summary '
        f'{ {k: v for k, v in doc.items() if k != "retained"} }, client '
        f'wall {wall * 1e3:.1f} ms; artifact {len(artifact)} bytes gzipped '
        f'({len(raw)} raw), {len(events)} events, {len(kernels)} kernels, '
        f'{len(flash)} flash forward launches, {in_graph} kernels of graph '
        f'replays (the largest replay {largest}; cudaGraphLaunch calls in '
        f'the trace {len(graph_launches)}); categories {cats}; a second '
        f'capture meanwhile: {busy_status}')
    if not flash or largest < 2:
        log(f'    a kernel event: {kernels[:1]}; graph-named events: '
            f'{sorted({e.get("name") for e in events if "raph" in e.get("name", "")})}')
        raise SystemExit('the profile artifact lacks the flash forward '
                         'kernel or the decode graph\'s kernels')


def _drive(engine, prompts, max_new, step='step_pipelined'):
    """Submit every prompt, then step until all finished (drained),
    checking that nothing was built meanwhile; returns (streams, wall s,
    TTFTs s, requests)."""
    import torch
    builds = builds_now()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new) for p in prompts]
    fn = getattr(engine, step)
    while not all(r.finished_at is not None for r in reqs):
        fn()
    if step == 'step_pipelined':
        engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not engine.healthy:
        raise SystemExit(f'paged engine crashed: {engine.error!r}')
    check_no_builds(builds, 'an engine API run')
    return ([r.tokens() for r in reqs], wall,
            [r.first_token_at - r.submitted_at for r in reqs], reqs)


def _p50(xs):
    return sorted(xs)[len(xs) // 2]


def _counter(name):
    from skypilot_tpu_torch.server import metrics as metrics_lib
    total = 0.0
    for line in metrics_lib.render().splitlines():
        if line.split('{')[0].split(' ')[0] == name:
            total += float(line.rsplit(' ', 1)[1])
    return total


def teacher_forced(model, prompts, streams, what):
    """Each emitted token against one non-decode forward (flash kernel)
    over prompt + tokens[:-1]: its logit must be within LOGITS_RTOL of
    the position's max |logit| below the max logit.  A wrong page,
    position or acceptance count gives tokens far from the argmax; a
    bf16 argmax flip passes.  Returns (worst slack, exact-argmax count,
    token count)."""
    import torch
    worst, exact, total = 0.0, 0, 0
    device = next(model.parameters()).device
    for prompt, toks in zip(prompts, streams):
        seq = torch.tensor([list(prompt) + toks[:-1]], device=device)
        with torch.no_grad():
            logits = model(seq)[0, len(prompt) - 1:]        # [n, V]
        ids = torch.tensor(toks, device=device)[:, None]
        got = logits.gather(1, ids)[:, 0]
        top = logits.max(-1).values
        slack = (top - got) / logits.abs().max(-1).values
        if not torch.isfinite(logits).all():
            raise SystemExit(f'{what}: non-finite teacher-forced logits')
        worst = max(worst, slack.max().item())
        exact += int((got == top).sum().item())
        total += len(toks)
    log(f'    teacher-forced {what}: {exact}/{total} tokens are the exact '
        f'argmax, worst (max - logit)/max|logit| {worst:.4f} (gate '
        f'{LOGITS_RTOL})')
    if worst > LOGITS_RTOL:
        raise SystemExit(f'{what}: an emitted token is {worst:.4f} of the '
                         f'logits\' scale below the argmax')
    return worst, exact, total


def _share_equal(a, b):
    same = sum(x == y for sa, sb in zip(a, b) for x, y in zip(sa, sb))
    return same / sum(len(sa) for sa in a)


def paged_phase(device, card, ctx):
    """The paged serving path over the serving phase's weights: (1) the
    dense and the bf16-paged engine, each with the decode call as a CUDA
    graph and eager, on the same prompts (identical tokens all four
    ways; one decode call of each profiled; the flash launches counted
    around the paged graph run), (2) a prefix-hit burst, (3) int8 pages,
    (4) n-gram speculation, (5) the KV handoff prefill -> bytes ->
    decode; the hit, int8 and speculative streams held by the teacher-
    forced gate.  Returns the kernels' launch counts of the paged run."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference import kv_quant, kv_transfer
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig

    from skypilot_tpu_torch.models.llama import Llama

    if (PAGED['model'], PAGED['max_seq_len']) != (SERVE['model'],
                                                  ctx['cfg'].max_seq_len):
        raise SystemExit('PAGED must name the serving phase\'s model')
    # The phase's depth cut: the first PAGED['n_layers'] of the serving
    # weights' layers (the same tensors, not copies), at full width.
    cfg = dataclasses.replace(ctx['cfg'], n_layers=PAGED['n_layers'])
    model = Llama(cfg, {
        name: t for name, t in ctx['params'].items()
        if not name.startswith('layers.') or
        int(name.split('.')[1]) < cfg.n_layers})
    prompts = ctx['prompts'] + [ctx['long_prompt']]
    n_new = PAGED['max_tokens']
    base = dict(n_slots=PAGED['n_slots'],
                steps_per_call=PAGED['steps_per_call'],
                prefill_buckets=PAGED['prefill_buckets'])
    paged_kw = dict(base, kv_page_size=PAGED['kv_page_size'])

    def engine(eager=False, **kw):
        """A prewarmed engine over the phase's model: its one call built
        (on the card, captured) and the recompile sentinel armed."""
        e = DecodeEngine(model, EngineConfig(**kw), device=device,
                         _eager_decode=eager)
        e.prewarm()
        return e

    # (1) The dense and the bf16-paged engine, each with its decode call
    # replayed as a CUDA graph and run eagerly, on the same prompts.  One
    # decode call of each is profiled first, over prompts of the same
    # shape that share no prefix with them (no prefix hits later).  The
    # flash launches are counted around the paged graph run.
    rng = np.random.default_rng(SEED + 7)
    profile_prompts = [rng.integers(0, cfg.vocab_size, len(p)).tolist()
                       for p in ctx['prompts']]
    runs = {}
    for name, kw in (('dense', base), ('paged', paged_kw)):
        for eager in (False, True):
            t0 = time.perf_counter()
            e = engine(eager=eager, **kw)
            prewarm_s = time.perf_counter() - t0
            if (e._decode_call.graph is None) != eager:
                raise SystemExit(f'{name} engine: decode graph '
                                 f'{e._decode_call.graph} with eager={eager}')
            builds = builds_now()
            prof = profile_decode_call(e, profile_prompts)
            check_no_builds(builds, f'{name} profiled decode call')
            # The profiled call decodes steps_per_call tokens for each
            # slot at contexts just past the first call's: prompt + one
            # call + half the second.
            steps = PAGED['steps_per_call']
            ctx_p = len(profile_prompts[0]) + steps + (steps + 1) / 2
            prof['decode_tok_s'] = (len(profile_prompts) * steps /
                                    prof['wall_ms'] * 1e3)
            prof['roofline_tok_s'] = \
                e.perf_cost_model.roofline_decode_tokens_per_s(
                    ctx_p, len(profile_prompts))
            prof['roofline_ctx'] = ctx_p
            groups_before = e.prefill_groups
            if name == 'paged' and not eager:
                zero_launches()
            toks_, wall_, ttft_, _ = _drive(e, prompts, n_new)
            if name == 'paged' and not eager:
                counts = read_launches()
            runs[name, eager] = dict(
                toks=toks_, wall=wall_, ttft=ttft_,
                groups=e.prefill_groups - groups_before,
                prewarm_s=prewarm_s, **prof)
            if name == 'paged' and not eager:
                paged = e            # (3) reads its radix cache and pool
            else:
                del e
            torch.cuda.empty_cache()
    toks = sum(map(len, runs['dense', False]['toks']))
    for (name, eager), r in runs.items():
        how = 'eager' if eager else 'graph'
        log(f'  (1) {name} {how}: {len(prompts)} prompts ({len(prompts) - 1} '
            f'x {len(prompts[0])} + 1 x {len(prompts[-1])}), {n_new} new '
            f'each, on {card}: {toks / r["wall"]:.1f} out-tok/s (wall '
            f'{r["wall"]:.3f} s), TTFT p50 {_p50(r["ttft"]) * 1e3:.1f} ms, '
            f'prefill groups {r["groups"]}, build + prewarm '
            f'{r["prewarm_s"]:.2f} s; one profiled decode call of '
            f'{PAGED["steps_per_call"]} steps over {len(ctx["prompts"])} '
            f'slots: wall {r["wall_ms"]:.1f} ms, device busy '
            f'{r["busy_ms"]:.1f} ms ({r["busy_share"]:.1%}), {r["kernels"]} '
            f'kernels; by kind (ms) {r["by_kind"]}; decode-only '
            f'{r["decode_tok_s"]:.1f} tok/s = '
            f'{r["decode_tok_s"] / r["roofline_tok_s"]:.2%} of the cost '
            f'model\'s roofline {r["roofline_tok_s"]:.1f} tok/s (occupancy '
            f'{len(ctx["prompts"])}, context {r["roofline_ctx"]:.1f})')
        for dev_ms, count, kname in r['top']:
            log(f'      {dev_ms:9.3f} ms  x{count:<6d} {kname[:160]}')
    want = runs['dense', False]['toks']
    got = runs['paged', False]['toks']
    groups, groups_d = runs['paged', False]['groups'], runs['dense', False][
        'groups']
    log(f'  (1) {cfg.n_layers} of the serving weights\' '
        f'{ctx["cfg"].n_layers} layers; flash launches of the paged graph '
        f'run {counts}')
    for name in ('dense', 'paged'):
        graph_toks, eager_toks = (runs[name, eager]['toks']
                                  for eager in (False, True))
        if graph_toks != eager_toks:
            raise SystemExit(f'{name} graph decode differs from eager: '
                             f'{_share_equal(graph_toks, eager_toks):.4f} '
                             f'equal')
    if got != want:
        raise SystemExit(f'paged tokens differ from the dense engine\'s: '
                         f'{_share_equal(got, want):.4f} equal')
    if groups != groups_d or counts['flash_attention_fwd'] != \
            cfg.n_layers * groups:
        raise SystemExit(f'flash launched {counts} over {groups} prefill '
                         f'groups of {cfg.n_layers} layers')
    paged._pool_alloc.check_conserved()
    ctx['graph_runs'] = {f'{name}_{"eager" if eager else "graph"}': {
        'out_tok_s': toks / r['wall'], 'ttft_p50_ms': _p50(r['ttft']) * 1e3,
        'decode_call_wall_ms': r['wall_ms'], 'decode_call_busy_ms':
        r['busy_ms'], 'busy_share': r['busy_share'],
        'decode_roofline_share': r['decode_tok_s'] / r['roofline_tok_s']}
        for (name, eager), r in runs.items()}
    ttft_p = runs['paged', False]['ttft']

    # (2) Prefix cache: a warm request publishes the 3-page prefix, then
    # a burst of 8 shares it, each with its own tail.
    rng = np.random.default_rng(SEED + 5)
    prefix = rng.integers(0, cfg.vocab_size, PAGED['prefix_len']).tolist()
    tails = [rng.integers(0, cfg.vocab_size, PAGED['tail_len']).tolist()
             for _ in range(PAGED['n_slots'] + 1)]
    hit_engine = engine(**paged_kw)
    _drive(hit_engine, [prefix + tails[0]], n_new)
    before = {k: _counter(f'skytpu_engine_prefix_cache_{k}_total')
              for k in ('hits', 'tokens', 'misses')}
    burst = [prefix + t for t in tails[1:]]
    hit_toks, wall_h, ttft_h, _ = _drive(hit_engine, burst, n_new)
    delta = {k: _counter(f'skytpu_engine_prefix_cache_{k}_total') - v
             for k, v in before.items()}
    hit_engine._pool_alloc.check_conserved()
    log(f'  (2) prefix hits: burst of {len(burst)} x ({PAGED["prefix_len"]} '
        f'shared + {PAGED["tail_len"]}) after one warm request: '
        f'{sum(map(len, hit_toks)) / wall_h:.1f} out-tok/s (wall '
        f'{wall_h:.3f} s), TTFT p50 {_p50(ttft_h) * 1e3:.1f} ms (step 1: '
        f'{_p50(ttft_p) * 1e3:.1f} ms); counters {delta}; free pages '
        f'{hit_engine._pool_alloc.free_pages} of '
        f'{hit_engine._pool_alloc.n_pages}')
    if (delta['hits'] != len(burst) or delta['misses'] != 0 or
            delta['tokens'] != len(burst) * PAGED['prefix_len']):
        raise SystemExit(f'prefix-cache counters moved by {delta}')
    teacher_forced(model, burst, hit_toks, 'prefix-hit streams')
    del hit_engine
    torch.cuda.empty_cache()

    # (3) int8 pages on the step-1 prompts; then the first prompt's three
    # full prompt pages (held by both radix caches) against bf16.
    quant = engine(**paged_kw, kv_dtype='int8')
    q_toks, wall_q, ttft_q, _ = _drive(quant, prompts, n_new)
    n_pages = len(prompts[0]) // PAGED['kv_page_size']
    matched = [e._radix.match(prompts[0], n_pages) for e in (paged, quant)]
    if [n for n, _ in matched] != [n_pages, n_pages]:
        raise SystemExit(f'radix caches hold {matched} of prompt 0')
    rows_b, rows_q = (torch.tensor(pg, device=device) for _, pg in matched)
    worst_q = 0.0
    for (kb, vb), (kq, vq) in zip(paged._cache, quant._cache):
        for ref, qp in ((kb, kq), (vb, vq)):
            want_kv = ref[rows_b].float()
            step = qp.scale[rows_q][..., None]
            deq = kv_quant.dequantize_kv(qp.data[rows_q], qp.scale[rows_q],
                                         torch.float32)
            bound = 0.5 * step + want_kv.abs() * 2.0 ** -7
            worst_q = max(worst_q, ((deq - want_kv).abs() /
                                    bound.clamp_min(1e-30)).max().item())
    for e, (_, pg) in zip((paged, quant), matched):
        e._pool_alloc.release(pg)
    bytes_q = sum(t.numel() * t.element_size() for t in quant._wire_leaves())
    bytes_b = sum(t.numel() * t.element_size() for t in paged._wire_leaves())
    log(f'  (3) int8 pages: pool {bytes_q / 1e9:.4f} GB vs bf16 '
        f'{bytes_b / 1e9:.4f} GB (ratio {bytes_q / bytes_b:.5f}, expected '
        f'{(1 + 4 / cfg.head_dim) / 2:.5f}); prompt-0 pages dequantized vs '
        f'bf16: worst |d| / (half a step + 1 bf16 ulp) {worst_q:.4f}; '
        f'{toks / wall_q:.1f} out-tok/s (wall {wall_q:.3f} s), TTFT p50 '
        f'{_p50(ttft_q) * 1e3:.1f} ms; tokens equal to step 1\'s '
        f'{_share_equal(q_toks, got):.4f}')
    if worst_q > 1.0:
        raise SystemExit('int8 pages off the bf16 pages by more than half a '
                         'quantization step plus one bf16 ulp')
    if abs(bytes_q / bytes_b - (1 + 4 / cfg.head_dim) / 2) > 1e-9:
        raise SystemExit('int8 pool size off its expected ratio')
    kv_q, kv_b = (e.perf_cost_model.kv_bytes_per_pos() for e in (quant, paged))
    log(f'  (3) cost model kv_bytes_per_pos int8 {kv_q:.0f} / bf16 '
        f'{kv_b:.0f} = {kv_q / kv_b:.6f}; pool bytes ratio '
        f'{bytes_q / bytes_b:.6f}')
    if abs(kv_q / kv_b - bytes_q / bytes_b) > 1e-12:
        raise SystemExit('the cost model\'s int8/bf16 bytes per position '
                         'differ from the pools\' byte ratio')
    quant._pool_alloc.check_conserved()
    teacher_forced(model, prompts, q_toks, 'int8 streams')
    del quant, paged
    torch.cuda.empty_cache()

    # (4) Speculation, k drafts per verify call: the verify as one CUDA
    # graph (captured at prewarm) and eager, on the bf16 and int8 pools.
    from skypilot_tpu_torch.perf import compile_telemetry
    spec_runs = {}
    for kv in ('bf16', 'int8'):
        for eager in (False, True):
            captured = compile_telemetry.summary().get('verify', (0, 0.0))
            t0 = time.perf_counter()
            spec = engine(eager=eager, speculation=PAGED['spec_k'],
                          kv_dtype=kv, **paged_kw)
            prewarm_s = time.perf_counter() - t0
            capture_s = (compile_telemetry.summary()['verify'][1] -
                         captured[1])
            if spec._decode_call is not None or \
                    (spec._verify_call.graph is None) != eager:
                raise SystemExit(f'speculative engine ({kv}, eager={eager}): '
                                 f'verify graph {spec._verify_call.graph}')
            before = [_counter(f'skytpu_engine_spec_{k}_tokens_total')
                      for k in ('proposed', 'accepted')]
            s_toks, wall_s, ttft_s, _ = _drive(spec, prompts, n_new,
                                               step='step')
            counts_s = [_counter(f'skytpu_engine_spec_{k}_tokens_total') - b
                        for k, b in zip(('proposed', 'accepted'), before)]
            spec_runs[kv, eager] = dict(
                toks=s_toks, wall=wall_s, ttft=ttft_s, counts=counts_s,
                prewarm_s=prewarm_s, capture_s=capture_s,
                verify_ms=verify_call_ms(spec))
            del spec
            torch.cuda.empty_cache()
    paged_tok_s = toks / runs['paged', False]['wall']
    for (kv, eager), r in spec_runs.items():
        proposed, accepted = r['counts']
        log(f'  (4) speculation k={PAGED["spec_k"]}, {kv} pages, verify '
            f'{"eager" if eager else "graph"}: proposed {proposed:.0f}, '
            f'accepted {accepted:.0f} (acceptance '
            f'{accepted / max(proposed, 1):.4f}); {toks / r["wall"]:.1f} '
            f'out-tok/s (wall {r["wall"]:.3f} s; the paged graph engine '
            f'without speculation {paged_tok_s:.1f}), TTFT p50 '
            f'{_p50(r["ttft"]) * 1e3:.1f} ms; one verify call '
            f'{r["verify_ms"]:.3f} ms (CUDA events over '
            f'{VERIFY_TIMED_CALLS}); build + prewarm {r["prewarm_s"]:.2f} s '
            f'of which the verify call {r["capture_s"]:.3f} s; tokens equal '
            f'to step 1\'s {_share_equal(r["toks"], got):.4f}')
    for kv in ('bf16', 'int8'):
        graph_r, eager_r = spec_runs[kv, False], spec_runs[kv, True]
        proposed, accepted = graph_r['counts']
        if proposed <= 0 or not 0 <= accepted <= proposed:
            raise SystemExit(f'speculation counters ({kv}): {proposed} '
                             f'{accepted}')
        if graph_r['toks'] != eager_r['toks'] or \
                graph_r['counts'] != eager_r['counts']:
            raise SystemExit(
                f'{kv} graph verify differs from eager: tokens '
                f'{_share_equal(graph_r["toks"], eager_r["toks"]):.4f} '
                f'equal, counters {graph_r["counts"]} vs {eager_r["counts"]}')
        teacher_forced(model, prompts, graph_r['toks'],
                       f'speculative streams ({kv} pages)')
    ctx['spec_runs'] = {f'{kv}_{"eager" if eager else "graph"}': {
        'out_tok_s': toks / r['wall'], 'verify_ms': r['verify_ms'],
        'capture_s': r['capture_s']} for (kv, eager), r in spec_runs.items()}

    # (5) Handoff: prefill role -> payload bytes -> decode role, against a
    # monolithic paged run of the same prompts submitted together.
    hand = prompts[:PAGED['handoff_prompts']]
    mono_toks, _, _, _ = _drive(engine(**paged_kw), hand, n_new)
    torch.cuda.empty_cache()
    pre, dec = engine(**paged_kw), engine(**paged_kw)
    builds = builds_now()
    reqs = [pre.submit_prefill(p, n_new) for p in hand]
    while not all(r.finished_at is not None for r in reqs):
        pre.step_pipelined()
    pre.drain()
    firsts = [r.tokens() for r in reqs]
    t0 = time.perf_counter()
    exported = [pre.export_result(r) for r in reqs]
    export_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    payloads = [kv_transfer.serialize(kv_transfer.KVHandoff(
        prompt_ids=p, first_token=e['first_token'], max_new_tokens=n_new,
        page_size=PAGED['kv_page_size'], leaves=e['leaves']))
        for p, e in zip(hand, exported)]
    ser_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    handoffs = [kv_transfer.deserialize(b) for b in payloads]
    de_ms = (time.perf_counter() - t0) * 1e3
    adopted = [dec.submit_adopt(h.prompt_ids, h.first_token, h.leaves,
                                h.max_new_tokens, page_size=h.page_size)
               for h in handoffs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec._step_adopt()
    torch.cuda.synchronize()
    adopt_ms = (time.perf_counter() - t0) * 1e3
    while not all(r.finished_at is not None for r in adopted):
        dec.step_pipelined()
    dec.drain()
    h_toks = [r.tokens() for r in adopted]
    check_no_builds(builds, 'the handoff engines')
    mb = sum(map(len, payloads)) / len(payloads) / 1e6
    log(f'  (5) handoff of {len(hand)} prompts: payload {mb:.3f} MB each; '
        f'export_result (device -> host) {export_ms:.3f} ms, serialize '
        f'{ser_ms:.3f} ms, deserialize {de_ms:.3f} ms, adopt (host -> '
        f'device + scatter, synced) {adopt_ms:.3f} ms, all {len(hand)}')
    if [f[0] for f in firsts] != [m[0] for m in mono_toks] or \
            h_toks != mono_toks:
        raise SystemExit(f'handoff streams differ from the monolithic '
                         f'paged run: {_share_equal(h_toks, mono_toks):.4f}')
    del pre, dec, exported, payloads, handoffs
    torch.cuda.empty_cache()
    return counts


def verify_call_ms(engine):
    """CUDA-event time of one verify call (the drafts' pinned copy, the
    graph's replay or the eager body, the rows' clone) on the idle
    engine, over VERIFY_TIMED_CALLS calls after two: the same shapes as
    under traffic (every slot, S = k+1, the whole page table)."""
    import numpy as np
    import torch
    drafts = np.zeros((engine.cfg.n_slots, engine._spec_k), np.int64)
    call = engine._verify_call
    engine._pt()              # every slot retired: an all-trash table
    for _ in range(2):
        call(engine, drafts)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(VERIFY_TIMED_CALLS):
        call(engine, drafts)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / VERIFY_TIMED_CALLS


def profile_decode_call(engine, prompts):
    """Where the time goes in one decode call: the second step() of
    len(prompts) requests with budgets of two calls (so that step is
    all decode: one call of steps_per_call steps), traced with
    torch.profiler.  Returns its wall and device busy time, the busy
    share, the kernel count, device time by kind (gather/scatter, GEMM,
    copy) and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reqs = [engine.submit(p, 2 * engine.cfg.steps_per_call)
            for p in prompts]
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not all(r.finished_at is not None for r in reqs):
        raise SystemExit('the profiled decode call did not finish its '
                         'requests')
    for r in reqs:
        r.tokens()
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    kinds = {'gather/scatter': ('index', 'gather', 'scatter'),
             'gemm': ('gemm', 'nvjet', 'cutlass', 'sm90'),
             'copy': ('copy', 'Copy')}
    by_kind = {k: round(sum(r[0] for r in rows
                            if any(t in r[2] for t in names)), 3)
               for k, names in kinds.items()}
    return {'wall_ms': wall_ms, 'busy_ms': busy_ms,
            'busy_share': busy_ms / wall_ms,
            'kernels': sum(r[1] for r in rows), 'by_kind': by_kind,
            'top': rows[:8]}


def kernel_rows(prof):
    """(device ms, launches, name) of every kernel in a torch.profiler
    trace, largest first.  Kernel rows only: an aten op's row repeats
    its kernels' time, and a GPU user annotation (the optimizer's
    `Optimizer.step#AdamW.step`) spans kernels already counted."""
    from torch.autograd import DeviceType
    return sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and not getattr(evt, 'is_user_annotation', False)),
                  reverse=True)


def profile_step(engine, prompts, card):
    """Where the time goes: one synchronous engine step that admits the 8
    prompts as one prefill group and runs one decode call of
    steps_per_call steps, traced with torch.profiler (device time by
    kernel, device busy share of the step's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reqs = [engine.submit(p, SERVE['steps_per_call']) for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not all(r.finished_at is not None for r in reqs):
        raise SystemExit('profiled step did not finish its requests')
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows
                   if KERNEL_SYMBOLS['flash_attention_fwd'] in r[2])
    log(f'  profile on {card}: 1 prefill group of {len(prompts)} x '
        f'{SERVE["prompt_len"]} + 1 decode call of '
        f'{SERVE["steps_per_call"]} steps: wall {wall_ms:.1f} ms, device '
        f'busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), flash kernel '
        f'{flash_ms:.3f} ms')
    for dev_ms, count, name in rows[:10]:
        log(f'    {dev_ms:9.3f} ms  x{count:<6d} {name[:90]}')


def checkpoint_phase(device, card, ctx):
    """Serving a trained checkpoint, and a weight swap under the graph:
    the serving phase's llama2-7b weights saved through the port's
    CheckpointManager (under build/, removed after), restored by the
    server's `build_model` with --checkpoint and --param-dtype bfloat16,
    served through the HTTP app (the engine's decode call a CUDA graph):
    its greedy tokens on the serving prompts must equal the in-memory
    model's (the dense graph engine of the paged phase).  Then, on that
    engine, a sentinel lm_head installed mid-request with
    update_params.  Returns the kernels' launch counts of the served
    run."""
    import shutil
    import torch
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager

    cfg, model = ctx['cfg'], ctx['model']
    # The checkpoint is written straight into a bucket of a fake-GCS root
    # (SKYTPU_FAKE_GCS_ROOT), so the same bytes load from the local path
    # and from gs://, and the gs:// load pays only the fetch's copy.
    gcs_root = os.path.join(REPO, 'build', 'chip_smoke_gcs')
    bucket, prefix = 'chip-smoke-ckpt', SERVE['model']
    directory = os.path.join(gcs_root, bucket, prefix)
    url = f'gs://{bucket}/{prefix}'
    shutil.rmtree(gcs_root, ignore_errors=True)
    saved_root = os.environ.get('SKYTPU_FAKE_GCS_ROOT')
    os.environ['SKYTPU_FAKE_GCS_ROOT'] = gcs_root
    fetched_before = _fetched_checkpoints()
    try:
        t0 = time.perf_counter()
        CheckpointManager(directory).save(0, model)
        save_s = time.perf_counter() - t0
        size_gb = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(directory) for f in fs) / 1e9
        # The server finds its model by --model: SERVE's depth cut is
        # registered under a name of its own.
        name = f'{SERVE["model"]}-{cfg.n_layers}-layers'
        LLAMA_CONFIGS[name] = dataclasses.replace(
            LLAMA_CONFIGS[SERVE['model']], n_layers=cfg.n_layers)
        restored, load_s = {}, {}
        for how, path in (('local', directory), ('gs', url)):
            args = server.parse_args([
                '--model', name, '--max-seq-len',
                str(SERVE['max_seq_len']), '--checkpoint', path,
                '--param-dtype', 'bfloat16', '--device', str(device)])
            t0 = time.perf_counter()
            restored[how] = server.build_model(args)
            torch.cuda.synchronize()
            load_s[how] = time.perf_counter() - t0
    finally:
        shutil.rmtree(gcs_root, ignore_errors=True)
        if saved_root is None:
            os.environ.pop('SKYTPU_FAKE_GCS_ROOT', None)
        else:
            os.environ['SKYTPU_FAKE_GCS_ROOT'] = saved_root
    left = _fetched_checkpoints() - fetched_before
    same = {how: all(torch.equal(t, m.state_dict()[name])
                     for name, t in model.state_dict().items())
            for how, m in restored.items()}
    log(f'  saved {size_gb:.3f} GB in {save_s:.2f} s; build_model '
        f'(--checkpoint, --param-dtype bfloat16) restored it from the '
        f'local path in {load_s["local"]:.2f} s and from {url} (fetched '
        f'to a temp directory) in {load_s["gs"]:.2f} s; params bit-equal '
        f'to the in-memory model: {same}; fetched directories left: '
        f'{sorted(left)}')
    if not all(same.values()) or any(
            m.cfg.param_dtype != torch.bfloat16 for m in restored.values()):
        raise SystemExit('the restored checkpoint differs from the weights '
                         'it was saved from')
    if left:
        raise SystemExit(f'the gs:// fetch left {sorted(left)} behind')
    gs_model = restored.pop('gs')
    restored = restored.pop('local')
    engine = DecodeEngine(restored, EngineConfig(
        n_slots=SERVE['n_slots'], steps_per_call=SERVE['steps_per_call'],
        prefill_buckets=SERVE['prefill_buckets']), device=device)
    engine.prewarm()
    builds = builds_now()
    prompts = ctx['prompts'] + [ctx['long_prompt']]
    bodies = [{'prompt_ids': p, 'max_tokens': SERVE['max_tokens']}
              for p in prompts]
    zero_launches()
    wall, replies = asyncio.run(_serve_queued(engine, bodies))
    counts = read_launches()
    if not engine.healthy:
        raise SystemExit(f'engine crashed: {engine.error!r}')
    if any(status != 200 for status, _ in replies):
        raise SystemExit(f'checkpoint serving failed: {replies}')
    if counts['flash_attention_fwd'] != cfg.n_layers * engine.prefill_groups:
        raise SystemExit(f'flash launched {counts} over '
                         f'{engine.prefill_groups} prefill groups of '
                         f'{cfg.n_layers} layers')
    ids = [body['ids'] for _, body in replies]
    ttfts = sorted(body['usage']['ttft_ms'] for _, body in replies)
    log(f'  served the checkpoint over HTTP on {card}: '
        f'{sum(map(len, ids)) / wall:.1f} out-tok/s (wall {wall:.3f} s), '
        f'TTFT p50 {ttfts[len(ttfts) // 2]:.1f} ms; flash launches '
        f'{counts}; tokens equal to the in-memory model\'s '
        f'{_share_equal(ids, ctx["http_ids"]):.4f}')
    if ids != ctx['http_ids']:
        raise SystemExit('the checkpoint serves other tokens than the '
                         'in-memory model')

    # Swap under the graph: budgets of three calls; after the first
    # call, a sentinel lm_head (zeros but +-5 rows at two ids, so only
    # they can be the argmax) is installed.
    sentinels = (100, 200)
    n_new = 3 * SERVE['steps_per_call']
    reqs = [engine.submit(p, n_new) for p in ctx['prompts']]
    engine.step()
    before = [r.emitted for r in reqs]
    head = torch.zeros_like(restored.lm_head.weight)
    head[sentinels[0]] = 5.0
    head[sentinels[1]] = -5.0
    t0 = time.perf_counter()
    engine.update_params({**restored.state_dict(), 'lm_head.weight': head})
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    while not all(r.finished_at is not None for r in reqs):
        engine.step()
    streams = [r.tokens() for r in reqs]
    check_no_builds(builds, 'the checkpoint engine')
    after_ok = all(set(t[n:]) <= set(sentinels)
                   for t, n in zip(streams, before))
    before_ok = all(not set(t[:n]) <= set(sentinels)
                    for t, n in zip(streams, before))
    log(f'  swap under the graph: {len(reqs)} requests of {n_new} tokens, '
        f'{before[0]} emitted each before the install; update_params of '
        f'the whole state dict ({cfg.num_params() / 1e9:.2f}B params) '
        f'{swap_ms:.1f} ms (staged + installed, synced); every later token '
        f'a sentinel: {after_ok}; none before: {before_ok}')
    if not (after_ok and before_ok and all(len(t) == n_new
                                           for t in streams)):
        raise SystemExit('the swap under the graph did not take effect at '
                         'the dispatch boundary')
    del engine, restored
    # The gs:// restore served once on the engine API: the same tokens as
    # the local path's over HTTP.
    gs_engine = DecodeEngine(gs_model, EngineConfig(
        n_slots=SERVE['n_slots'], steps_per_call=SERVE['steps_per_call'],
        prefill_buckets=SERVE['prefill_buckets']), device=device)
    gs_engine.prewarm()
    gs_ids = _drive(gs_engine, prompts, SERVE['max_tokens'])[0]
    log(f'  served the gs:// restore on the engine API: tokens equal to '
        f'the local path\'s {_share_equal(gs_ids, ids):.4f}')
    if gs_ids != ids:
        raise SystemExit('the gs:// checkpoint serves other tokens than '
                         'the local path')
    del gs_engine, gs_model
    torch.cuda.empty_cache()
    return counts


def _fetched_checkpoints() -> set:
    """The gs:// fetch's temp directories (inference/weights.py) that
    exist now."""
    import tempfile
    root = tempfile.gettempdir()
    return {n for n in os.listdir(root) if n.startswith('skytpu-ckpt-')}


# ----- tensor-parallel serving ------------------------------------------------
def tp_probe(_):
    """In each rank of a gloo pool on cuda:0: which collectives gloo runs
    on CUDA tensors, per dtype; {'dtype op': result or the error}."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    rank, out = dist.get_rank(), {}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for op in ('all_reduce', 'broadcast', 'all_gather_into_tensor'):
            x = torch.full((4,), rank + 1, dtype=dtype, device='cuda')
            try:
                if op == 'all_reduce':
                    dist.all_reduce(x)
                    got, want = x.tolist(), [3] * 4
                elif op == 'broadcast':
                    dist.broadcast(x, 0)
                    got, want = x.tolist(), [1] * 4
                else:
                    y = x.new_empty((8,))
                    dist.all_gather_into_tensor(y, x)
                    got, want = y.tolist(), [1] * 4 + [2] * 4
                out[f'{str(dtype)[6:]} {op}'] = ('ok' if got == want
                                                 else f'wrong: {got}')
            except Exception as e:  # pylint: disable=broad-except
                out[f'{str(dtype)[6:]} {op}'] = f'fails: {e!r}'[:160]
    return out


def _tp_traffic(engine, prompts, n_new):
    """Rank 0: prewarm (every rank), then every prompt at once on the
    pipelined loop, drained; (streams, wall s).  Other ranks follow;
    (their streams, None)."""
    import torch
    if not engine.leader:
        return [r.tokens() for r in engine.follow(record=True)], None
    try:
        engine.prewarm()
        t0 = time.perf_counter()
        reqs = [engine.submit(p, n_new) for p in prompts]
        while not all(r.finished_at is not None for r in reqs):
            engine.step_pipelined()
        engine.drain()
        torch.cuda.synchronize()
        return [r.tokens() for r in reqs], time.perf_counter() - t0
    finally:
        engine.close()


def tp_rank(prompts, logits_tokens, logits_at):
    """One rank of TENSOR's gloo pair on cuda:0: (b) llama2-7b bf16 from
    SEED, this rank's slices: the first-step logits of `logits_tokens`
    at `logits_at`, then the dense and the paged engine over `prompts`
    (prewarmed; flash launches counted around them on rank 0); (c) the
    4-layer f32 model's dense tokens through the f32 kernels (launches
    counted around the run).  Returns what the caller checks."""
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh

    t = TENSOR['tensor']
    cfg = dataclasses.replace(LLAMA_CONFIGS[TENSOR['model']],
                              n_layers=SERVE['n_layers'],
                              max_seq_len=TENSOR['max_seq_len'],
                              param_dtype=torch.bfloat16)
    mesh = build_serve_mesh(t, cfg.n_heads, cfg.n_kv_heads,
                            devices=['cuda:0'] * t, backend='gloo')
    out = {'rank': mesh.rank}

    def build(c):
        gen = torch.Generator(device=mesh.device).manual_seed(SEED)
        return Llama(c, init_params(c, mesh.device, gen, mesh=mesh), mesh)

    def engine(model, **kw):
        return DecodeEngine(model, EngineConfig(
            n_slots=TENSOR['n_slots'], steps_per_call=TENSOR['steps_per_call'],
            prefill_buckets=TENSOR['prefill_buckets'], mesh=mesh, **kw))

    t0 = time.perf_counter()
    model = build(cfg)
    torch.cuda.synchronize()
    out['init_s'] = time.perf_counter() - t0
    with torch.no_grad():
        logits = model(torch.tensor(logits_tokens, device=mesh.device),
                       logits_at=torch.tensor(logits_at, device=mesh.device))
    out['logits'] = logits[:, 0].cpu()
    zero_launches()
    groups = 0
    for name, kw in (('dense', {}), ('paged', {'kv_page_size':
                                               TENSOR['kv_page_size']})):
        e = engine(model, **kw)
        out[name], out[name + '_wall'] = _tp_traffic(e, prompts,
                                                     TENSOR['max_tokens'])
        groups += e.prefill_groups
        del e
    out['launches'], out['groups'] = read_launches(), groups
    del model
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, n_layers=TENSOR['f32_layers'],
                               dtype=torch.float32, param_dtype=torch.float32)
    e = engine(build(cfg4))
    zero_launches()
    out['f32'], _ = _tp_traffic(e, prompts, TENSOR['max_tokens'])
    out['f32_launches'] = read_route_launches()
    out['f32_groups'] = e.prefill_groups
    del e
    out['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _halves_product(dense, t):
    """A forward for one device's row-parallel projection `dense` with
    tensor=t's arithmetic: the product of each of the t slices of the
    input dim in the compute dtype, the slices added in that dtype in
    rank order."""
    import torch.nn.functional as F

    def forward(x):
        x, w = x.to(dense.dtype), dense.weight.to(dense.dtype)
        k = w.shape[1] // t
        acc = None
        for r in range(t):
            part = F.linear(x[..., r * k:(r + 1) * k].contiguous(),
                            w[:, r * k:(r + 1) * k].contiguous())
            acc = part if acc is None else acc + part
        return acc
    return forward


def tensor_serving_phase(device, card, ctx):
    """Tensor-parallel serving (TENSOR) on the one card: (a) which
    collectives gloo runs on CUDA tensors (a failing one the model needs
    fails the phase); (b) llama2-7b at full width over tensor=2, both
    ranks on cuda:0 over gloo, dense and paged on the engine API with the
    serving cell's traffic: first-step logits bit-identical to one
    device computing the same arithmetic and within LOGITS_RTOL of the
    plain one-device model, greedy agreement with the one-device engine
    printed; (c) the model cut to 4 layers in f32 through the f32 kernels:
    tokens identical to the one-device engine (also through them), rank
    0's launches exactly one f32 forward per layer and prefill group, and
    one device's prefill logits within F32_LOGITS_RTOL of
    attention_impl='xla' on the same params; (d) tensor=1 over a one-rank
    NCCL group in
    this process, over the serving weights: the decode call captured as a
    CUDA graph with its collectives, tokens identical to the mesh-free
    engine; (e) the flash forward at the per-rank prefill shape against
    its plain version, timed beside its bound.  Returns (rank 0's launch
    counts over (b), (c) and (d), the (e) numbers)."""
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.parallel import group as group_lib
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh

    cfg, model = ctx['cfg'], ctx['model']
    if (TENSOR['model'], TENSOR['max_seq_len']) != (SERVE['model'],
                                                    cfg.max_seq_len):
        raise SystemExit('TENSOR must name the serving phase\'s model')
    t = TENSOR['tensor']
    prompts = ctx['prompts'] + [ctx['long_prompt']]
    n_new = TENSOR['max_tokens']
    bucket = TENSOR['prefill_buckets'][0]
    logits_tokens = [p + [0] * (bucket - len(p)) for p in ctx['prompts']]
    logits_at = [len(p) - 1 for p in ctx['prompts']]
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'),
                ctx['params'])

    def first_logits(m):
        with torch.no_grad():
            return m(torch.tensor(logits_tokens, device=device),
                     logits_at=torch.tensor(logits_at,
                                            device=device))[:, 0].cpu()

    want_logits, floor_logits = first_logits(model), first_logits(xla)
    del xla
    rows = [m for layer in model.layers
            for m in (layer.attn.o_proj, layer.mlp.down_proj)]
    for dense in rows:
        dense.forward = _halves_product(dense, t)
    try:
        same_math_logits = first_logits(model)
    finally:
        for dense in rows:
            del dense.forward
    # (c)'s one-device reference: the same 4-layer f32 draw from SEED,
    # through the f32 kernels; its prefill logits against 'xla' on the
    # same params.
    cfg4 = dataclasses.replace(cfg, n_layers=TENSOR['f32_layers'],
                               dtype=torch.float32, param_dtype=torch.float32)
    params4 = init_params(cfg4, device,
                          torch.Generator(device=device).manual_seed(SEED))
    model4 = Llama(cfg4, params4)
    f32_logits = first_logits(model4)
    f32_xla_logits = first_logits(Llama(
        dataclasses.replace(cfg4, attention_impl='xla'), params4))
    one = DecodeEngine(model4, EngineConfig(
        n_slots=TENSOR['n_slots'], steps_per_call=TENSOR['steps_per_call'],
        prefill_buckets=TENSOR['prefill_buckets']), device=device)
    one.prewarm()
    want_f32, _, _, _ = _drive(one, prompts, n_new)
    del one, model4, params4
    gc.collect()
    torch.cuda.empty_cache()

    # (a)-(c): two ranks on cuda:0 over gloo.  The kernel library is
    # built already (the ranks only load it).
    t0 = time.perf_counter()
    with group_lib.RankPool(t, 'gloo', timeout_s=120) as pool:
        probe = pool.run(tp_probe, None, timeout_s=300)[0]
        spawn_s = time.perf_counter() - t0
        log(f'  (a) gloo over CUDA tensors, {t} ranks on cuda:0 (pool up '
            f'and probed in {spawn_s:.1f} s):')
        for key, result in probe.items():
            log(f'    {key}: {result}')
        needed = ('bfloat16 all_reduce', 'float32 all_reduce',
                  'float32 all_gather_into_tensor')
        if any(probe[key] != 'ok' for key in needed):
            raise SystemExit(f'gloo refuses a collective the sharded model '
                             f'needs on CUDA tensors: {probe}')
        ranks = pool.run(tp_rank, prompts, logits_tokens, logits_at,
                         timeout_s=900)
    lead = ranks[0]
    for r in ranks:
        log(f'    rank {r["rank"]}: init {r["init_s"]:.1f} s, peak memory '
            f'{r["peak_gb"]:.2f} GB')
        for key in ('dense', 'paged', 'f32'):
            if r[key] != lead[key]:
                raise SystemExit(f'rank {r["rank"]} emitted other {key} '
                                 f'tokens than rank 0')
    got_logits = lead['logits']
    scale = want_logits.abs().max().item()

    def rel(a, b):
        return (a - b).abs().max().item() / scale

    err, err_same, floor = (rel(got_logits, want_logits),
                            rel(got_logits, same_math_logits),
                            rel(floor_logits, want_logits))
    agree = (got_logits.argmax(-1) == want_logits.argmax(-1)).float().mean()
    out_toks = sum(map(len, lead['dense']))
    log(f'  (b) {TENSOR["model"]} bf16 tensor={t} over gloo on one card: '
        f'first-step logits (max |logit| {scale:.3f}) against one device '
        f'computing the same arithmetic: rel {err_same:.2e} (gate 0, '
        f'bit-identical); against the one-device model: rel {err:.2e} '
        f'(gate {LOGITS_RTOL}; one device\'s flash vs xla on the same '
        f'prompts: {floor:.2e}), argmax agreement {agree.item():.4f}; '
        f'greedy tokens equal to the one-device engine\'s: dense '
        f'{_share_equal(lead["dense"], ctx["http_ids"]):.4f}, paged '
        f'{_share_equal(lead["paged"], ctx["http_ids"]):.4f}, dense = '
        f'paged {_share_equal(lead["dense"], lead["paged"]):.4f} (not '
        f'gated); out-tok/s dense {out_toks / lead["dense_wall"]:.1f}, '
        f'paged {out_toks / lead["paged_wall"]:.1f} (eager calls, gloo '
        f'staging every collective through the host: not a tensor-'
        f'parallel rate); rank 0 flash launches {lead["launches"]} over '
        f'{lead["groups"]} prefill groups')
    if not (torch.isfinite(got_logits).all() and
            torch.equal(got_logits, same_math_logits) and
            err <= LOGITS_RTOL):
        raise SystemExit('tensor=2 first-step logits disagree with the '
                         'one-device model')
    if lead['launches']['flash_attention_fwd'] != cfg.n_layers * \
            lead['groups']:
        raise SystemExit(f'rank 0 launched flash {lead["launches"]} over '
                         f'{lead["groups"]} prefill groups')
    f32_scale = f32_xla_logits.abs().max().item()
    f32_err = (f32_logits - f32_xla_logits).abs().max().item() / f32_scale
    f32_want = dict(dict.fromkeys(ROUTED + PADDED, 0),
                    flash_attention_fwd_f32=TENSOR['f32_layers'] *
                    lead['f32_groups'])
    log(f'  (c) {TENSOR["f32_layers"]} of {cfg.n_layers} layers in f32 '
        f'through the f32 kernels, tensor={t}: tokens equal to the '
        f'one-device engine\'s {_share_equal(lead["f32"], want_f32):.4f}; '
        f'rank 0 launches '
        f'{ {n: c for n, c in lead["f32_launches"].items() if c} } over '
        f'{lead["f32_groups"]} prefill groups; one device\'s prefill '
        f'logits against attention_impl=xla: rel {f32_err:.2e} of max '
        f'|logit| {f32_scale:.3f} (gate {F32_LOGITS_RTOL})')
    if lead['f32'] != want_f32:
        raise SystemExit('f32 tensor=2 tokens differ from one device')
    if lead['f32_launches'] != f32_want or lead['f32_groups'] < 1:
        raise SystemExit(f'f32 tensor=2 rank 0 launched '
                         f'{lead["f32_launches"]}, expected {f32_want}')
    if not (torch.isfinite(f32_logits).all() and f32_err <= F32_LOGITS_RTOL):
        raise SystemExit('f32 prefill logits through the kernel disagree '
                         'with attention_impl=xla')

    # (d) tensor=1 over a real NCCL group: this process is its one rank,
    # and the serving weights are its (whole) slices.
    group_lib.join(0, 1, group_lib.free_port(), 'nccl', timeout_s=300)
    try:
        mesh = build_serve_mesh(1, cfg.n_heads, cfg.n_kv_heads)
        tp1 = DecodeEngine(Llama(cfg, ctx['params'], mesh), EngineConfig(
            n_slots=TENSOR['n_slots'], steps_per_call=TENSOR['steps_per_call'],
            prefill_buckets=TENSOR['prefill_buckets'], mesh=mesh))
        t0 = time.perf_counter()
        tp1.prewarm()
        prewarm_s = time.perf_counter() - t0
        if tp1._decode_call.graph is None:
            raise SystemExit('tensor=1 over NCCL did not capture its graph')
        zero_launches()
        toks1, wall1, ttft1, _ = _drive(tp1, prompts, n_new)
        counts1 = read_launches()
        groups1 = tp1.prefill_groups
        tp1.close()
        del tp1
    finally:
        group_lib.leave()
    log(f'  (d) tensor=1 over NCCL, decode call a CUDA graph with its '
        f'collectives (prewarm {prewarm_s:.1f} s): tokens equal to the '
        f'mesh-free engine\'s {_share_equal(toks1, ctx["http_ids"]):.4f}; '
        f'{out_toks / wall1:.1f} out-tok/s, TTFT p50 '
        f'{_p50(ttft1) * 1e3:.1f} ms; flash launches {counts1} over '
        f'{groups1} prefill groups')
    if toks1 != ctx['http_ids']:
        raise SystemExit('tensor=1 over NCCL emits other tokens than the '
                         'mesh-free engine')
    if counts1['flash_attention_fwd'] != cfg.n_layers * groups1:
        raise SystemExit(f'flash launched {counts1} over {groups1} groups')

    # (e) the forward at one rank's prefill shape.
    b, hq, hkv, s, d = TP_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    q = torch.randn((b, hq, s, d), generator=gen,
                    device=device).to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    got, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                    return_residuals=True)
    diff = (got.float() - ref.float()).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    log(f'  (e) flash_fwd at the tensor={t} per-rank prefill shape '
        f'{TP_SHAPE}: out max_abs_err {diff.max().item():.3e}, lse '
        f'{lse_err:.3e}')
    if not (bool((diff <= OUT_ATOL + OUT_RTOL * ref.float().abs()).all())
            and lse_err <= LSE_ATOL):
        raise SystemExit('flash forward disagrees with its plain version at '
                         'the per-rank shape')
    times = kernel_times(device, TP_SHAPE, f'tensor={t} per-rank prefill',
                         ('fwd',))['fwd']
    times['max_abs_err'] = diff.max().item()
    del q, k, v, got, ref
    torch.cuda.empty_cache()
    counts = {name: lead['launches'][name] + counts1[name]
              for name in KERNEL_NAMES}
    counts.update({name: lead['f32_launches'][name] for name in F32_KERNELS})
    return counts, times


def training_phase(device, card, smi, spec=TRAIN):
    """A model through Trainer.run (`spec`: TRAIN, bench-1b, or
    MOE_TRAIN): 2 untimed steps, then the timed steps with every launch
    counter zeroed just before and read just after; then the gradient
    check and one profiled step.  Returns the launch counts of the timed
    run."""
    import torch
    import tempfile
    from unittest import mock
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.obs import goodput as goodput_lib
    from skypilot_tpu_torch.train import flops as flops_lib
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(LLAMA_CONFIGS[spec['model']], **{
        k: spec[k] for k in ('n_experts', 'n_layers') if k in spec})
    batch, seq, steps = spec['batch'], spec['seq'], spec['timed_steps']
    t0 = time.perf_counter()
    model = Llama(cfg, init_params(
        cfg, device, torch.Generator(device=device).manual_seed(SEED)))
    # A managed job's trainer (spec['ledger']): SKYTPU_GOODPUT_JOB makes
    # its phase recorder write through to the durable goodput ledger, in
    # a sqlite jobs store of its own (SKYTPU_DB_URL unset).
    ledger_env = ({goodput_lib.JOB_ENV: spec['ledger'],
                   'SKYTPU_JOBS_DB': os.path.join(
                       tempfile.mkdtemp(prefix='chip-smoke-jobs-'),
                       'managed_jobs.db')} if spec.get('ledger') else {})
    with mock.patch.dict(os.environ, ledger_env):
        if ledger_env:
            os.environ.pop('SKYTPU_DB_URL', None)
        trainer = Trainer(model, TrainConfig(
            warmup_steps=spec['warmup_steps'],
            total_steps=spec['total_steps']), device=device)
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, seq), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 2))
    torch.cuda.synchronize()
    log(f'  {spec["model"]}: {cfg.num_params() / 1e9:.3f}B params f32, '
        f'{cfg.n_layers} layers, dim {cfg.dim}, heads {cfg.n_heads}/'
        f'{cfg.n_kv_heads} x {cfg.head_dim}, experts {cfg.n_experts}, '
        f'compute {cfg.dtype}, remat {cfg.remat}/{cfg.remat_policy!r}; '
        f'init {time.perf_counter() - t0:.1f} s')

    # Per-step metrics stay on the device; they are read after the run.
    step_metrics = []
    train_step = trainer.train_step

    def recording_step(state, tokens_):
        state, metrics = train_step(state, tokens_)
        step_metrics.append(metrics)
        return state, metrics

    trainer.train_step = recording_step
    t0 = time.perf_counter()
    trainer.run(iter([tokens] * spec['warm_steps']), spec['warm_steps'],
                log_every=spec['warm_steps'])
    torch.cuda.synchronize()
    log(f'  {spec["warm_steps"]} untimed steps: '
        f'{time.perf_counter() - t0:.2f} s')

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = trainer.run(iter([tokens] * steps), steps, log_every=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m['loss']) for m in step_metrics]
    norms = [float(m['grad_norm']) for m in step_metrics]
    step_ms = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    flops_per_token = flops_lib.train_flops_per_token(
        cfg.num_params(), cfg.n_layers, cfg.dim, seq)
    mfu = flops_lib.estimate_mfu(tokens_per_s, cfg.num_params(),
                                 cfg.n_layers, cfg.dim, seq, kind='h100')
    log(f'  trained {steps} timed steps of {batch} x {seq} tokens on '
        f'{smi}: step {step_ms:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU '
        f'{mfu:.2f}% of 989 TFLOP/s ({flops_per_token / 1e9:.3f} GFLOP/'
        f'token), peak memory {peak_gb:.2f} GB; trainer tokens/s '
        f'{out["tokens_per_s"]:.0f}')
    log(f'  loss per step ({spec["warm_steps"]} untimed, then timed) '
        f'{[round(x, 4) for x in losses]}; grad norm '
        f'{[round(x, 3) for x in norms]}; launches {counts}')
    want = {'flash_attention_fwd': 2 * cfg.n_layers * steps,
            'flash_attention_bwd_dq': cfg.n_layers * steps,
            'flash_attention_bwd_dkv': cfg.n_layers * steps}
    if counts != want:
        raise SystemExit(f'training launches {counts}, expected {want} '
                         f'(per step: forward 2 per layer under remat, '
                         f'dq and dk/dv 1 per layer)')
    if not all(map(math.isfinite, losses + norms)):
        raise SystemExit(f'non-finite training loss or grad norm: {losses} '
                         f'{norms}')
    if ledger_env:
        check_ledger(trainer, spec['ledger'])
    # The xla path is a gate for a dense model; for MoE it is reported
    # only: its rounding can flip a near-tied routing choice.
    grad_check(trainer.model, cfg, tokens[:spec['grad_batch']],
               gate_xla=cfg.n_experts == 0)
    trainer.train_step = train_step
    profile_train_step(trainer, tokens, card)
    del trainer, model
    torch.cuda.empty_cache()
    return counts


# `tiny` (head_dim 16: 4 query heads over 2 kv heads, 2 layers, dim 64)
# at its full config, f32 params and bf16 compute, no remat: the JAX
# bench's own `tiny` training defaults (bench.py:64-67: B = 4, S = 64),
# then S = 128 (its max_seq_len), 2 untimed and 5 timed steps each
# through Trainer.run.  The forward runs the small forward kernel, the
# backward the small dq and dk/dv.
TINY_TRAIN = dict(model='tiny', batch=4, seqs=(64, 128), warm_steps=2,
                  timed_steps=5, grad_batch=1, warmup_steps=5,
                  total_steps=1000)


def tiny_training_phase(device, card, smi):
    """`tiny` through Trainer.run on the card at each of TINY_TRAIN's
    sequence lengths: the timed steps with every launch counter zeroed
    just before and read just after (the three small kernels exactly
    n_layers times a step, no wgmma kernel), finite losses, step time;
    then grad_check (against the plain backward and against
    attention_impl='xla') and one profiled step.  Returns the launch
    counts of the timed runs, all kernels."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    spec = TINY_TRAIN
    cfg = LLAMA_CONFIGS[spec['model']]
    batch, steps = spec['batch'], spec['timed_steps']
    total = dict.fromkeys(KERNEL_NAMES + SMALL_KERNELS, 0)
    for seq in spec['seqs']:
        t0 = time.perf_counter()
        model = Llama(cfg, init_params(
            cfg, device, torch.Generator(device=device).manual_seed(SEED)))
        trainer = Trainer(model, TrainConfig(
            warmup_steps=spec['warmup_steps'],
            total_steps=spec['total_steps']), device=device)
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, seq), device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + 2))
        step_metrics = []
        train_step = trainer.train_step

        def recording_step(state, tokens_, train_step=train_step,
                           step_metrics=step_metrics):
            state, metrics = train_step(state, tokens_)
            step_metrics.append(metrics)
            return state, metrics

        trainer.train_step = recording_step
        trainer.run(iter([tokens] * spec['warm_steps']), spec['warm_steps'],
                    log_every=spec['warm_steps'])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        zero_launches()
        t0 = time.perf_counter()
        out = trainer.run(iter([tokens] * steps), steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**read_launches(), **read_small_launches()}
        losses = [float(m['loss']) for m in step_metrics]
        norms = [float(m['grad_norm']) for m in step_metrics]
        log(f'  tiny: {cfg.num_params() / 1e6:.3f}M params f32, '
            f'{cfg.n_layers} layers, dim {cfg.dim}, heads {cfg.n_heads}/'
            f'{cfg.n_kv_heads} x {cfg.head_dim}, compute {cfg.dtype}, remat '
            f'{cfg.remat}; {batch} x {seq} tokens on {smi}: init + '
            f'{spec["warm_steps"]} untimed steps {warm_s:.2f} s; {steps} '
            f'timed steps: step {wall / steps * 1e3:.2f} ms, '
            f'{batch * seq * steps / wall:.0f} tokens/s (trainer '
            f'{out["tokens_per_s"]:.0f}); loss per step '
            f'{[round(x, 4) for x in losses]}; grad norm '
            f'{[round(x, 3) for x in norms]}; launches {counts}')
        want = {**dict.fromkeys(KERNEL_NAMES + SMALL_KERNELS, 0),
                **dict.fromkeys(SMALL_KERNELS, cfg.n_layers * steps)}
        if counts != want:
            raise SystemExit(f'tiny training launches {counts}, expected '
                             f'{want} (per step and layer: 1 small '
                             f'forward, dq and dk/dv; no remat)')
        if not all(map(math.isfinite, losses + norms)):
            raise SystemExit(f'non-finite tiny loss or grad norm: {losses} '
                             f'{norms}')
        for name, n in counts.items():
            total[name] += n
        grad_check(trainer.model, cfg, tokens[:spec['grad_batch']])
        trainer.train_step = train_step
        if seq == spec['seqs'][-1]:
            profile_train_step(trainer, tokens, card)
        del trainer, model
        torch.cuda.empty_cache()
    return total


# Ledger totals vs the recorder's, and the gap between one interval row's
# end and the next one's start: the same f64 stamps summed in the same
# order on both sides, so only float rounding may differ.
LEDGER_ATOL_S = 1e-6


def check_ledger(trainer, job):
    """The durable goodput ledger of a managed job's trainer after its
    runs: the recorder closed, the ledger's totals(job) equal to the
    recorder's within LEDGER_ATOL_S per category, productive seconds
    > 0, and the interval rows tiling the job's wall-clock (each row
    starting where the one before ended, their durations summing to the
    totals)."""
    from skypilot_tpu_torch.obs import goodput as goodput_lib
    totals = trainer.phases.close()
    ledger = trainer.phases.ledger
    rows = ledger.totals(job)
    ivs = ledger.intervals(job)
    gaps = [b['t0'] - a['t1'] for a, b in zip(ivs, ivs[1:])]
    worst = max(abs(rows.get(c, 0.0) - totals.get(c, 0.0))
                for c in set(rows) | set(totals))
    spanned = sum(iv['t1'] - iv['t0'] for iv in ivs)
    log(f'  goodput ledger ({goodput_lib.JOB_ENV}={job}, {ledger.dsn}): '
        f'totals {({c: round(v, 6) for c, v in rows.items()})}; largest '
        f'difference from the recorder {worst:.3e} s; {len(ivs)} interval '
        f'rows spanning {spanned:.6f} s of {sum(totals.values()):.6f} s '
        f'classified, largest gap {max(map(abs, gaps), default=0.0):.3e} '
        f's; goodput {ledger.goodput_pct(job):.2f}%')
    if (set(rows) != set(totals) or worst > LEDGER_ATOL_S or
            rows.get(goodput_lib.PRODUCTIVE, 0.0) <= 0 or not ivs or
            any(abs(g) > LEDGER_ATOL_S for g in gaps) or
            abs(spanned - sum(totals.values())) > LEDGER_ATOL_S):
        raise SystemExit(f'the goodput ledger disagrees with the trainer\'s '
                         f'recorder: {rows} vs {totals}, gaps {gaps}')


def _grad_diff(grads, ref):
    """(per-tensor norm-relative errors, worst three, whole-gradient
    norm-relative error) of one gradient dict against another."""
    import torch
    rels = {n: _norm_rel(grads[n], ref[n]) for n in ref}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    total = (torch.stack([(grads[n] - ref[n]).float().norm()
                          for n in rels]).norm() /
             torch.stack([ref[n].float().norm() for n in rels]).norm())
    return rels, worst, total.item()


def loss_and_grads(model, loss_of):
    """(loss, {name: gradient}) of `loss_of(model)` by autograd."""
    import torch
    names, params = zip(*model.named_parameters())
    loss = loss_of(model)
    grads = torch.autograd.grad(loss, params)
    return loss.item(), dict(zip(names, grads))


def kernel_vs_plain_grads(model, loss_of):
    """One step's loss and per-tensor gradients of `loss_of(model)`
    through the kernels, and the same step with the attention backward
    through the kernels' plain versions on the same CUDA tensors (same
    forward kernel).  Returns (loss, grads, plain loss, plain grads,
    per call [dq, dk, dv] norm-rel of the kernels vs the plain versions
    on each attention backward's own inputs, first layer first)."""
    import torch
    from unittest import mock
    from skypilot_tpu_torch.ops import attention as attn_lib
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    per_call = []

    class PlainBackward(torch.autograd.Function):
        """The forward kernel, then `flash_attention_bwd_reference`; the
        backward kernels also run on the same inputs, for comparison
        only (their results are not returned)."""

        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                              return_residuals=True)
            ctx.causal = causal
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            args = (q, k, v, out, lse, g.contiguous(), ctx.causal)
            plain = fa.flash_attention_bwd_reference(*args)
            per_call.append([_norm_rel(x, ref) for x, ref in
                             zip(fa.flash_attention_bwd(*args), plain)])
            return (*plain, None)

    loss_f, grads_f = loss_and_grads(model, loss_of)
    with mock.patch.object(attn_lib, 'flash_attention',
                           lambda q, k, v, causal=True, block_size=512:
                           PlainBackward.apply(q, k, v, causal)):
        loss_p, grads_p = loss_and_grads(model, loss_of)
    return loss_f, grads_f, loss_p, grads_p, per_call[::-1]


def grad_check(model, cfg, tokens, gate_xla=True, plain_rtol=GRAD_PLAIN_RTOL,
               call_rtol=BWD_NORM_RTOL,
               xla_rtols=(LOSS_RTOL, GRAD_NORM_RTOL, GRAD_GLOBAL_RTOL)):
    """One step's loss and per-tensor gradients through the kernels vs
    (a) the same model with the attention backward through the kernels'
    plain versions on the same CUDA tensors (the same forward, so the
    same routing): every tensor within `plain_rtol`, each attention
    backward within `call_rtol` on its own inputs; and (b)
    attention_impl='xla', on the same (trained) weights: the loss, the
    worst tensor and the whole gradient within `xla_rtols`, gated only
    with `gate_xla`."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama
    from skypilot_tpu_torch.train.trainer import lm_loss

    def loss_of(m):
        return lm_loss(m(tokens), tokens)

    loss_f, grads_f, loss_p, grads_p, per_call = kernel_vs_plain_grads(
        model, loss_of)
    if len(per_call) != cfg.n_layers:
        raise SystemExit(f'the plain-backward path ran {len(per_call)} '
                         f'attention backwards for {cfg.n_layers} layers')
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'),
                model.state_dict()).requires_grad_(True)
    loss_x, grads_x = loss_and_grads(xla, loss_of)
    del xla
    rels_p, worst_p, total_p = _grad_diff(grads_f, grads_p)
    _, worst_x, total_x = _grad_diff(grads_f, grads_x)
    _, worst_px, total_px = _grad_diff(grads_p, grads_x)
    per_layer = [max(r for n, r in rels_p.items()
                     if n.startswith(f'layers.{i}.'))
                 for i in range(cfg.n_layers)]
    log(f'  gradients at batch {tokens.shape[0]}, kernels vs plain '
        f'backward: loss {loss_f:.6f} vs {loss_p:.6f}; global norm-rel '
        f'{total_p:.3e}; worst tensors '
        f'{[(n, round(r, 6)) for n, r in worst_p]}')
    log(f'    worst tensor per layer (0..{cfg.n_layers - 1}) '
        f'{[float(f"{r:.2e}") for r in per_layer]}')
    log(f'    one attention backward on each layer\'s own inputs, kernels '
        f'vs plain, max of dq/dk/dv per layer '
        f'{[float(f"{max(r):.2e}") for r in per_call]}')
    log(f'  kernels vs xla: loss {loss_f:.6f} vs {loss_x:.6f}; global '
        f'norm-rel {total_x:.3e}; worst tensors '
        f'{[(n, round(r, 5)) for n, r in worst_x]}')
    log(f'  plain backward vs xla: global norm-rel {total_px:.3e}; worst '
        f'tensors {[(n, round(r, 5)) for n, r in worst_px]}')
    if not (math.isfinite(loss_f) and worst_p[0][1] <= plain_rtol and
            max(map(max, per_call)) <= call_rtol):
        raise SystemExit('training gradients through the backward kernels '
                         'disagree with their plain versions')
    loss_rtol, tensor_rtol, global_rtol = xla_rtols
    if gate_xla and (abs(loss_f - loss_x) > loss_rtol * abs(loss_x) or
                     worst_x[0][1] > tensor_rtol or
                     total_x > global_rtol):
        raise SystemExit('training gradients through the kernels disagree '
                         'with attention_impl=xla')
    del grads_f, grads_p, grads_x
    torch.cuda.empty_cache()


def profile_train_step(trainer, tokens, card):
    """Where the time goes in training: one step traced with
    torch.profiler (device time by kernel, device busy share of the
    step's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.train_step(trainer.state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    flash = {name: sum(r[0] for r in rows if name in r[2])
             for name in KERNEL_SYMBOLS.values()}
    gemm_ms = sum(r[0] for r in rows
                  if any(t in r[2].lower() for t in ('gemm', 'nvjet',
                                                     'cutlass', 'sm90')))
    log(f'  profile on {card}: 1 train step of {tuple(tokens.shape)}: wall '
        f'{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms '
        f'({busy_ms / wall_ms:.1%}); flash kernels '
        f'{ {k: round(v, 3) for k, v in flash.items()} } ms '
        f'({sum(flash.values()) / max(busy_ms, 1e-9):.1%} of device time); '
        f'GEMM-named '
        f'kernels {gemm_ms:.1f} ms; loss {float(metrics["loss"]):.4f}')
    for dev_ms, count, name in rows[:12]:
        log(f'    {dev_ms:9.3f} ms  x{count:<6d} {name[:90]}')


def top_kernel(fn):
    """The name of the kernel that took most of one call of `fn`'s device
    time under torch.profiler (None where the trace holds no kernel): a
    record of which backend a library call chose, not a gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    return rows[0][2] if rows else None


def kernel_times(device, shape, label, kinds=('fwd', 'dq', 'dkv'),
                 plain_iters=20, dtype_name='bfloat16'):
    """CUDA-event times of the forward, dq and dk/dv kernels (`kinds`)
    at `shape` (b, hq, hkv, s, d; causal, in `dtype_name`), of their
    plain versions (the mean of `plain_iters` calls) and of SDPA
    (forward; backward: one call for dq, dk and dv), beside the bounds
    (f32: its bytes, and TF32's peak).  Each kernel's outputs are held to
    its plain version's on the same inputs: in bf16/fp16 under PERF.md
    section 2's gates (HALF_GATES), in f32 (TF32 matmuls off) under the
    probe's f32 gates; a miss raises (against_plain).  In
    f32 also the kernel that took most of one SDPA forward's and
    backward's device time (the backend PyTorch chose).  Returns {kind:
    numbers}."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.ops.cuda import probe

    b, hq, hkv, s, d = shape
    dtype = getattr(torch, dtype_name)
    peak = PEAK_TF32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    gates = ({'out': (probe.F32_OUT_TOL,) * 2, 'lse': (probe.F32_OUT_TOL,) * 2,
              'norm': probe.F32_NORM_RTOL} if dtype == torch.float32
             else HALF_GATES)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    q, g = (torch.randn((b, hq, s, d), generator=gen,
                        device=device).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    delta = (g.float() * out.float()).sum(-1)
    calls = {
        'fwd': (lambda: fa.flash_attention_fwd(q, k, v,
                                               return_residuals=True),
                lambda: fa.flash_attention_fwd_reference(
                    q, k, v, return_residuals=True)),
        'dq': (lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),
               lambda: fa.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                           delta)),
        'dkv': (lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta),
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, g, lse, delta)),
    }
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

    lib_bwd_ms = cuda_time_ms(sdpa_bwd)
    backend = ({'fwd': top_kernel(sdpa_fwd), 'bwd': top_kernel(sdpa_bwd)}
               if dtype == torch.float32 else None)
    del sdpa_out, leaves
    lib_fwd_ms = cuda_time_ms(sdpa_fwd)
    times = {}
    for kind in kinds:
        kernel, plain = calls[kind]
        if kind == 'fwd':
            bound_ms, bound_by, flops, nbytes = attention_bound(
                b, hq, hkv, s, d, True, dtype.itemsize, peak)
        else:
            bound_ms, bound_by, flops, nbytes = bwd_bound(
                kind, b, hq, hkv, s, d, True, dtype.itemsize, peak)
        times[kind] = {'ms': cuda_time_ms(kernel),
                       'plain_ms': cuda_time_ms(
                           plain, iters=plain_iters,
                           warmup=min(3, plain_iters)),
                       'bound_ms': bound_ms, 'bound_by': bound_by,
                       'library_ms': lib_fwd_ms if kind == 'fwd'
                       else lib_bwd_ms,
                       'shape': [b, hq, hkv, s, d, True, dtype_name]}
        t = times[kind]
        t['tflops'] = flops / t['ms'] / 1e9
        if backend:
            t['library_kernel'] = backend['fwd' if kind == 'fwd' else 'bwd']
        t['check'] = against_plain(kind, kernel(), plain(), shape, gates)
        log(f'  timing {kind} at the {label} shape b={b} hq={hq} '
            f'hkv={hkv} s={s} d={d} causal {dtype_name}: kernel '
            f'{t["ms"]:.4f} ms ({t["tflops"]:.1f} TFLOP/s), plain '
            f'{t["plain_ms"]:.4f} ms, sdpa '
            f'{"forward" if kind == "fwd" else "backward (dq+dk+dv)"} '
            f'{t["library_ms"]:.4f} ms'
            + (f' ({t["library_kernel"]})' if backend else '') +
            f', bound {bound_ms:.6f} ms ({bound_by}: {flops / 1e6:.1f} '
            f'MFLOP, {nbytes / 1e6:.3f} MB), {bound_ms / t["ms"]:.1%} of '
            f'bound; against plain {t["check"]}')
    del q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    return times


def against_plain(kind, got, want, shape, gates):
    """The kernel's outputs of `kind` ('fwd': (out, lse); 'dq': dq; 'dkv':
    (dk, dv)) against its plain version's under `gates`: {'out': (atol,
    rtol), 'lse': (atol, rtol)}, each |d| <= atol + rtol * |ref|, and
    'norm': the gradients' norm-rel; raises on a miss, a non-finite value
    or another dtype.  Returns the numbers."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    names = {'fwd': ('out', 'lse'), 'dq': ('dq',), 'dkv': ('dk', 'dv')}[kind]
    nums, ok = {}, True
    for name, x, r in zip(names, got, want):
        ok &= bool(torch.isfinite(x).all()) and x.dtype == r.dtype
        if kind == 'fwd':
            atol, rtol = gates[name]
            diff = (x.float() - r.float()).abs()
            nums[f'{name}_abs'] = diff.max().item()
            ok &= bool((diff <= atol + rtol * r.float().abs()).all())
        else:
            nums[name] = _norm_rel(x, r)
            ok &= nums[name] <= gates['norm']
    if not ok:
        raise SystemExit(f'the {x.dtype} {kind} kernel disagrees with its '
                         f'plain version at {shape}: {nums} (gates {gates})')
    return nums


def rl_phase(device, card):
    """The RL loop (RL): rollout on the engine -> one REINFORCE step on
    the learner -> update_params, RL['iterations'] times, with exact
    flash launches per iteration (the rollout's one prefill group; the
    step's forward, dq and dk/dv per layer), finite losses, and the
    engine's params bit-equal to the learner's after the last swap; then
    one step's gradients through the kernels against the same step
    through the backward kernels' plain versions.  Returns the kernels'
    launch counts of the loop."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.train import rl

    cfg = LLAMA_CONFIGS[RL['model']]
    t0 = time.perf_counter()
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(SEED))
    learner = Llama(cfg, {k: v.clone() for k, v in params.items()})
    engine = DecodeEngine(Llama(cfg, params), EngineConfig(
        n_slots=RL['n_slots'], steps_per_call=RL['steps_per_call'],
        prefill_buckets=RL['prefill_buckets'],
        temperature=RL['temperature'], seed=RL['seed']), device=device)
    engine.prewarm()
    torch.cuda.synchronize()
    if engine._decode_call.graph is None:
        raise SystemExit('the RL engine decodes without its graph')
    step = rl.make_reinforce_step(
        learner, torch.optim.Adam(learner.parameters(), lr=RL['lr']),
        kl_coef=RL['kl_coef'])
    log(f'  {RL["model"]}: {cfg.num_params() / 1e9:.3f}B params f32, '
        f'{cfg.n_layers} layers, dim {cfg.dim}, heads {cfg.n_heads}/'
        f'{cfg.n_kv_heads} x {cfg.head_dim}; engine and learner built and '
        f'the decode graph captured in {time.perf_counter() - t0:.2f} s')

    def reward(prompt, sampled):
        # The recipe's reward, the share of distinct sampled ids, is 1.0
        # on every row of a random model's 32 samples from 32000 ids: it
        # whitens to zero advantages and a zero gradient.  The share of
        # even ids differs from row to row.
        return sum(t % 2 == 0 for t in sampled) / max(len(sampled), 1)

    prompts = [list(RL['prompt'])] * RL['n_prompts']
    n = cfg.n_layers
    want_rollout = {'flash_attention_fwd': n, 'flash_attention_bwd_dq': 0,
                    'flash_attention_bwd_dkv': 0}
    want_step = dict.fromkeys(KERNEL_NAMES, n)
    losses, rows = [], []
    zero_launches()
    for it in range(RL['iterations']):
        c0, t0 = read_launches(), time.perf_counter()
        batch = rl.rollout(engine, prompts, RL['max_new'], reward)
        torch.cuda.synchronize()
        c1, t1 = read_launches(), time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        c2, t2 = read_launches(), time.perf_counter()
        engine.update_params(learner.state_dict())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        got_rollout = {k: c1[k] - c0[k] for k in KERNEL_NAMES}
        got_step = {k: c2[k] - c1[k] for k in KERNEL_NAMES}
        toks, _, plens, tlens = batch
        raw = np.mean([reward(p, list(t[pl:tl])) for p, t, pl, tl
                       in zip(prompts, toks, plens, tlens)])
        losses.append(loss.item())
        rows.append((t1 - t0, t2 - t1, t3 - t2))
        log(f'  iteration {it}: tokens {tuple(toks.shape)}, loss '
            f'{losses[-1]:+.6f}, mean reward {raw:.4f}; rollout '
            f'{(t1 - t0) * 1e3:.1f} ms, REINFORCE step {(t2 - t1) * 1e3:.1f} '
            f'ms, update_params {(t3 - t2) * 1e3:.1f} ms (each synced) on '
            f'{card}; launches rollout {got_rollout}, step {got_step}')
        if got_rollout != want_rollout or got_step != want_step:
            raise SystemExit(f'RL launches: rollout {got_rollout} (want '
                             f'{want_rollout}), step {got_step} (want '
                             f'{want_step})')
    counts = read_launches()
    served = engine.model.state_dict()
    same = all(torch.equal(served[k], t)
               for k, t in learner.state_dict().items())
    log(f'  {RL["iterations"]} iterations: losses {losses}; engine params '
        f'bit-equal to the learner\'s after the last swap: {same}')
    if not all(map(math.isfinite, losses)) or not same:
        raise SystemExit('RL: a non-finite loss, or the engine serves other '
                         'params than the learner\'s')

    # The last iteration's step (its tokens and advantages): gradients
    # through the kernels against the same step through the backward
    # kernels' plain versions, and the plain backward against
    # attention_impl='xla' (two bf16 formulations without the kernels'
    # backward: the comparison's noise floor).
    toks, adv, plens, tlens = (torch.as_tensor(x, device=device)
                               for x in batch)
    toks = toks.long()

    def loss_of(m):
        return rl.reinforce_loss(m(toks), toks, adv, plens, tlens)

    loss_f, grads_f, loss_p, grads_p, per_call = kernel_vs_plain_grads(
        learner, loss_of)
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'),
                learner.state_dict()).requires_grad_(True)
    _, grads_x = loss_and_grads(xla, loss_of)
    rels, worst_p, total_p = _grad_diff(grads_f, grads_p)
    _, worst_x, total_x = _grad_diff(grads_p, grads_x)
    per_layer = [max(r for k, r in rels.items()
                     if k.startswith(f'layers.{i}.')) for i in range(n)]
    log(f'  REINFORCE gradients at {tuple(toks.shape)}, kernels vs plain '
        f'backward: loss {loss_f:.6f} vs {loss_p:.6f}; global norm-rel '
        f'{total_p:.3e}; worst tensors '
        f'{[(k, round(r, 6)) for k, r in worst_p]}; plain backward vs '
        f'xla: global {total_x:.3e}, worst '
        f'{[(k, round(r, 6)) for k, r in worst_x]}')
    log(f'    worst tensor per layer (0..{n - 1}) '
        f'{[float(f"{r:.2e}") for r in per_layer]}; one attention '
        f'backward per layer on its own inputs, max of dq/dk/dv '
        f'{[float(f"{max(r):.2e}") for r in per_call]}')
    # Per-tensor GRAD_PLAIN_RTOL does not hold here: over 16 bf16 layers
    # and 288 tokens the two backward paths' rounding drifts apart by
    # ~1e-3 per layer the gradient travels back (1.5e-2 at layer 0 while
    # every attention backward on its own inputs agrees within 1e-4, and
    # plain vs xla differ by more; PERF.md, Findings).  Gated: each
    # call within BWD_NORM_RTOL, every tensor within GRAD_NORM_RTOL, and
    # the whole gradient no further from the plain backward's than that
    # is from xla's.
    if (len(per_call) != n or not math.isfinite(loss_f) or
            max(map(max, per_call)) > BWD_NORM_RTOL or
            worst_p[0][1] > GRAD_NORM_RTOL or total_p > total_x):
        raise SystemExit('REINFORCE gradients through the backward kernels '
                         'disagree with their plain versions')
    del grads_f, grads_p, grads_x
    iteration = [sum(r) for r in rows]
    log(f'  RL iteration time (ms) {[round(x * 1e3, 1) for x in iteration]}'
        f': rollout {[round(r[0] * 1e3, 1) for r in rows]}, step '
        f'{[round(r[1] * 1e3, 1) for r in rows]}, swap '
        f'{[round(r[2] * 1e3, 1) for r in rows]}')
    del engine, learner, xla
    torch.cuda.empty_cache()
    return counts


def moe_routing(model, tokens):
    """Per layer, which experts each token chose and which of those kept
    a slot, in one serving prefill of `tokens` (model(tokens,
    decode=True), as the engine's prefill runs it): hooks on every
    MoEMLP redo its routing on the input it was given.  Returns (logits,
    [(chosen, kept) [B, S, E] bool per layer])."""
    import torch
    from skypilot_tpu_torch.models import moe

    routes = []

    def hook(module, args, _out):
        probs = torch.softmax(module.router(args[0]), dim=-1)
        s, k = probs.shape[1], module.top_k
        kept, _ = moe.top_k_dispatch(probs, k, moe.capacity_of(
            s, module.n_experts, k, module.capacity_factor))
        # With 2*S slots per expert nothing drops: the choices alone.
        chosen, _ = moe.top_k_dispatch(probs, k, 2 * s)
        routes.append((chosen.sum(-1) > 0, kept.sum(-1) > 0))

    handles = [layer.moe_mlp.register_forward_hook(hook)
               for layer in model.layers]
    try:
        with torch.no_grad():
            logits, _ = model(tokens, decode=True)
    finally:
        for h in handles:
            h.remove()
    return logits, routes


def moe_serving_phase(device, card):
    """llama3-1b with 8 experts at full width, MOE_SERVE's depth (bf16
    weights from a seed) on the engine API, SERVE's traffic: dense with
    the decode call as a CUDA graph and eagerly, and 64-token-paged as a
    graph; tokens identical all three ways, the flash launches of each
    run exactly n_layers per prefill group, every token in the
    vocabulary; the prefill group's drop share at capacity; and the
    prefill logits through the kernel held against attention_impl='xla'
    on the tokens whose routing agrees in every layer.  Returns the
    kernels' launch counts of the three runs."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params

    spec = MOE_SERVE
    cfg = dataclasses.replace(LLAMA_CONFIGS[spec['model']],
                              n_experts=spec['n_experts'],
                              n_layers=spec['n_layers'],
                              max_seq_len=spec['max_seq_len'],
                              param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(SEED))
    model = Llama(cfg, params)
    torch.cuda.synchronize()
    log(f'  {spec["model"]} x {cfg.n_experts} experts: '
        f'{cfg.num_params() / 1e9:.3f}B params bf16, {cfg.n_layers} layers, '
        f'dim {cfg.dim}, heads {cfg.n_heads}/{cfg.n_kv_heads} x '
        f'{cfg.head_dim}, top-{cfg.moe_top_k}, capacity factor '
        f'{cfg.moe_capacity_factor}; init {time.perf_counter() - t0:.1f} s')
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, spec['prompt_len']).tolist()
               for _ in range(spec['n_prompts'])]
    prompts.append(rng.integers(0, cfg.vocab_size,
                                spec['long_prompt_len']).tolist())
    profile_prompts = [rng.integers(0, cfg.vocab_size,
                                    spec['prompt_len']).tolist()
                       for _ in range(spec['n_prompts'])]
    n_new = spec['max_tokens']
    base = dict(n_slots=spec['n_slots'],
                steps_per_call=spec['steps_per_call'],
                prefill_buckets=spec['prefill_buckets'])
    runs, counts = {}, dict.fromkeys(KERNEL_NAMES, 0)
    for name, eager, kw in (('dense_graph', False, base),
                            ('dense_eager', True, base),
                            ('paged_graph', False,
                             dict(base, kv_page_size=spec['kv_page_size']))):
        e = DecodeEngine(model, EngineConfig(**kw), device=device,
                         _eager_decode=eager)
        t0 = time.perf_counter()
        e.prewarm()
        prewarm_s = time.perf_counter() - t0
        if (e._decode_call.graph is None) != eager:
            raise SystemExit(f'MoE {name}: decode graph '
                             f'{e._decode_call.graph} with eager={eager}')
        builds = builds_now()
        prof = profile_decode_call(e, profile_prompts)
        groups_before = e.prefill_groups
        zero_launches()
        toks, wall, ttft, _ = _drive(e, prompts, n_new)
        got = read_launches()
        check_no_builds(builds, f'MoE {name}')
        groups = e.prefill_groups - groups_before
        want = cfg.n_layers * groups
        if groups < 1 or got['flash_attention_fwd'] != want:
            raise SystemExit(f'MoE {name}: flash launched {got} over '
                             f'{groups} prefill groups of {cfg.n_layers} '
                             f'layers')
        if e._paged:
            e._pool_alloc.check_conserved()
        for key in KERNEL_NAMES:
            counts[key] += got[key]
        runs[name] = dict(toks=toks, wall=wall, ttft=ttft, groups=groups,
                          prewarm_s=prewarm_s, **prof)
        del e
        torch.cuda.empty_cache()
    out_toks = sum(map(len, runs['dense_graph']['toks']))
    for name, r in runs.items():
        log(f'  {name}: {len(prompts)} prompts ({len(prompts) - 1} x '
            f'{len(prompts[0])} + 1 x {len(prompts[-1])}), {n_new} new each, '
            f'on {card}: {out_toks / r["wall"]:.1f} out-tok/s (wall '
            f'{r["wall"]:.3f} s), TTFT p50 {_p50(r["ttft"]) * 1e3:.1f} ms, '
            f'prefill groups {r["groups"]}, prewarm {r["prewarm_s"]:.2f} s; '
            f'one profiled decode call of {spec["steps_per_call"]} steps '
            f'over {len(profile_prompts)} slots: wall {r["wall_ms"]:.1f} ms, '
            f'device busy {r["busy_ms"]:.1f} ms ({r["busy_share"]:.1%}), '
            f'{r["kernels"]} kernels; by kind (ms) {r["by_kind"]}')
        for dev_ms, count, kname in r['top']:
            log(f'      {dev_ms:9.3f} ms  x{count:<6d} {kname[:160]}')
    want_toks = runs['dense_graph']['toks']
    for name, r in runs.items():
        if r['toks'] != want_toks:
            raise SystemExit(f'MoE {name} tokens differ from dense_graph\'s: '
                             f'{_share_equal(r["toks"], want_toks):.4f} '
                             f'equal')
    if not all(len(t) == n_new and all(0 <= i < cfg.vocab_size for i in t)
               for t in want_toks):
        raise SystemExit('MoE: a stream is short or holds an id outside '
                         'the vocabulary')

    # The prefill group as the engine runs it (8 prompts, zero-padded to
    # the bucket): the share of (token, expert) choices dropped at
    # capacity; then the same prefill through attention_impl='xla'.
    bucket, plen = spec['prefill_buckets'][0], spec['prompt_len']
    toks = torch.zeros((spec['n_prompts'], bucket), dtype=torch.long,
                       device=device)
    toks[:, :plen] = torch.tensor(prompts[:spec['n_prompts']])
    got, routes = moe_routing(model, toks)
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    want, routes_x = moe_routing(xla, toks)
    del xla
    chosen = sum(c[:, :plen].sum().item() for c, _ in routes)
    kept = sum(k[:, :plen].sum().item() for _, k in routes)
    chosen_all = sum(c.sum().item() for c, _ in routes)
    kept_all = sum(k.sum().item() for _, k in routes)
    # A token is held to the gate if the two paths chose and kept the
    # same experts for it in every layer.
    same = torch.ones(toks.shape, dtype=torch.bool, device=device)
    for (c, k), (cx, kx) in zip(routes, routes_x):
        same &= ((c == cx) & (k == kx)).all(-1)
    held = same[:, :plen]
    got, want = got[:, :plen][held], want[:, :plen][held]
    n_held = int(held.sum().item())
    flip_share = 1 - n_held / held.numel()
    rows_flipped = int((~held).any(-1).sum().item())
    err = (got - want).abs().max().item() if n_held else float('nan')
    scale = want.abs().max().item() if n_held else float('nan')
    drop_share = 1 - kept / chosen
    capacity = moe.capacity_of(bucket, cfg.n_experts, cfg.moe_top_k,
                               cfg.moe_capacity_factor)
    log(f'  prefill group ({spec["n_prompts"]} x {plen} in the {bucket} '
        f'bucket, capacity {capacity} per expert and row): dropped at '
        f'capacity {drop_share:.4%} of the '
        f'prompt tokens\' (token, expert) choices ({chosen - kept:.0f} of '
        f'{chosen:.0f}), {1 - kept_all / chosen_all:.4%} with the padding')
    log(f'  prefill logits flash vs xla: routing differs for {flip_share:.4%} '
        f'of the prompt tokens ({held.numel() - n_held} of {held.numel()}; '
        f'{rows_flipped} of {held.shape[0]} prompts hold one); on the other '
        f'{n_held}: max_abs_err {err:.4f} of max |logit| {scale:.3f} (rel '
        f'{err / scale:.2e}, gate {LOGITS_RTOL})')
    if not (n_held and torch.isfinite(got).all() and
            err <= LOGITS_RTOL * scale):
        raise SystemExit('MoE prefill logits through the kernel disagree with '
                         'attention_impl=xla on the tokens routed alike')
    del model, params, got, want, routes, routes_x
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def zoo_phase(device, card):
    """bert-tiny and resnet50 (ZOO) on the card: each a train-mode
    forward and a backward (ResNet's running averages updated), timed
    over ZOO['timed_steps'] after ZOO['warm_steps']; gates: finite
    gradients, every running average moved, and the bf16-compute logits
    within ZOO_LOGITS_RTOL of the max |logit| of the same weights and
    running averages in f32 compute.  ResNet is held there at
    train=False: in train mode each BatchNorm renormalizes by its batch's
    statistics, and at random initialization that amplifies bf16's
    rounding with depth in the JAX model as much (its train-mode gap is
    printed, not gated)."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.models import encoder, resnet

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    enc_cfg = encoder.ENCODER_CONFIGS[ZOO['encoder']]
    res_cfg = resnet.RESNET_CONFIGS[ZOO['resnet']]
    cases = {
        ZOO['encoder']: (
            enc_cfg, lambda cfg, p: encoder.EncoderClassifier(cfg, p),
            encoder.init_params(enc_cfg, device, gen),
            torch.randint(0, enc_cfg.vocab_size,
                          (ZOO['enc_batch'], ZOO['enc_seq']), device=device,
                          generator=gen), {}),
        ZOO['resnet']: (
            res_cfg, lambda cfg, p: resnet.ResNet(cfg, p),
            resnet.init_params(res_cfg, device, gen),
            torch.randn((ZOO['res_batch'], ZOO['res_hw'], ZOO['res_hw'], 3),
                        device=device, generator=gen), {'train': True}),
    }
    for name, (cfg, build, state, x, kw) in cases.items():
        labels = torch.randint(0, cfg.num_classes, (x.shape[0],),
                               device=device, generator=gen)
        model = build(cfg, state).requires_grad_(True)
        before = {k: v.clone() for k, v in model.state_dict().items()
                  if k.endswith(('.mean', '.var'))}

        def step():
            model.zero_grad(set_to_none=True)
            logits = model(x, **kw)
            F.cross_entropy(logits, labels).backward()
            return logits

        for _ in range(ZOO['warm_steps']):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(ZOO['timed_steps']):
            logits = step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / ZOO['timed_steps'] * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in model.parameters())
        moved = [k for k, v in before.items()
                 if not torch.equal(v, model.state_dict()[k])]
        # The same weights and running averages in f32 compute.
        f32 = build(dataclasses.replace(cfg, dtype=torch.float32),
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()})
        held = {'train': False} if kw else {}
        with torch.no_grad():
            got, want = model(x, **held), f32(x, **held)
            train_gap = None
            if kw:
                want_t = f32(x, **kw)
                train_gap = ((logits.detach() - want_t).abs().max() /
                             want_t.abs().max()).item()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        n_params = sum(p.numel() for p in model.parameters())
        log(f'  {name}: {n_params / 1e6:.2f}M params, input '
            f'{tuple(x.shape)}; train-mode forward + backward {step_ms:.2f} '
            f'ms per step on {card} (peak {peak_gb:.2f} GB); gradients '
            f'finite {finite}; running averages moved {len(moved)} of '
            f'{len(before)}; bf16 vs f32 logits {held or "(no modes)"} '
            f'max_abs_err {err:.4f} of max |logit| {scale:.4f} (gate '
            f'{ZOO_LOGITS_RTOL}); train-mode gap (not gated) {train_gap}')
        if not (finite and err <= ZOO_LOGITS_RTOL * scale and
                len(moved) == len(before)):
            raise SystemExit(f'zoo {name}: non-finite gradients, bf16 logits '
                             f'off the f32 ones, or running averages not '
                             f'updated')
        del model, f32, state, logits, got, want
        torch.cuda.empty_cache()


# ----- sharded training -------------------------------------------------------
def sharded_probe(_):
    """In each rank of a gloo pool on cuda:0: which collectives FSDP2 and
    the tensor-parallel pair need gloo runs on CUDA tensors, per dtype;
    and the ring's transport on this mesh (from the backend)."""
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel import ring_attention as ring_lib
    torch.cuda.set_device(0)
    rank, out = dist.get_rank(), {}
    for dtype in (torch.bfloat16, torch.float32):
        for op in ('reduce_scatter_tensor', 'all_gather_into_tensor',
                   'all_reduce'):
            x = torch.full((4,), rank + 1, dtype=dtype, device='cuda')
            try:
                if op == 'all_reduce':
                    dist.all_reduce(x)
                    got, want = x.tolist(), [3] * 4
                elif op == 'all_gather_into_tensor':
                    y = x.new_empty((8,))
                    dist.all_gather_into_tensor(y, x)
                    got, want = y.tolist(), [1] * 4 + [2] * 4
                else:
                    y = x.new_empty((2,))
                    dist.reduce_scatter_tensor(y, x)
                    got, want = y.tolist(), [3] * 2
                out[f'{str(dtype)[6:]} {op}'] = ('ok' if got == want
                                                 else f'wrong: {got}')
            except Exception as e:  # pylint: disable=broad-except
                out[f'{str(dtype)[6:]} {op}'] = f'fails: {e!r}'[:160]
    out['ring via host'] = ring_lib._Ring(  # pylint: disable=protected-access
        dist.group.WORLD, torch.device('cuda')).via_host
    return out


def p2p_probe_rank(rank, port, dtype_name, queue):
    """One rank of a throwaway gloo pair on cuda:0: an all_to_all_single
    (the expert exchange) on CUDA tensors with the other rank, straight
    from the card (gloo may abort the process on it, which is why the
    pair is its own)."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    # Rank r sends [10r+1, 10r+1] to rank 0 and [10r+2, 10r+2] to rank 1,
    # and receives rank 0's chunk r, then rank 1's.
    x = torch.tensor([10 * rank + 1, 10 * rank + 1, 10 * rank + 2,
                      10 * rank + 2], dtype=getattr(torch, dtype_name),
                     device='cuda')
    y = torch.zeros_like(x)
    try:
        dist.all_to_all_single(y, x)
        want = [1 + rank, 1 + rank, 11 + rank, 11 + rank]
        torch.cuda.synchronize()
        result = 'ok' if y.tolist() == want else f'wrong: {y.tolist()}'
    except Exception as e:  # pylint: disable=broad-except
        result = f'fails: {e!r}'[:160]
    queue.put((rank, result))
    dist.destroy_process_group()


def p2p_probe(timeout_s=60.0):
    """{'dtype all_to_all_single': result} of gloo's all_to_all_single
    (p2p_probe_rank) on CUDA tensors, one throwaway pair of processes per
    dtype (run together); a process that dies reports its exit code.
    Every process is stopped before this returns."""
    import multiprocessing
    import queue as queue_lib
    from skypilot_tpu_torch.parallel import group as group_lib
    ctx = multiprocessing.get_context('spawn')
    pairs = {}
    for name in ('bfloat16', 'float32'):
        q, port = ctx.Queue(), group_lib.free_port()
        pairs[name] = (q, [ctx.Process(target=p2p_probe_rank,
                                       args=(r, port, name, q),
                                       daemon=True)
                           for r in range(2)])
        for proc in pairs[name][1]:
            proc.start()
    deadline = time.monotonic() + timeout_s
    out = {}
    for name, (q, procs) in pairs.items():
        got = {}
        while len(got) < 2 and time.monotonic() < deadline:
            try:
                rank, result = q.get(timeout=1.0)
                got[rank] = result
            except queue_lib.Empty:
                if not any(p.is_alive() for p in procs):
                    break
        group_lib.stop_processes(procs, 5.0)
        codes = [p.exitcode for p in procs]
        if len(got) == 2 and got[0] == got[1]:
            out[f'{name} all_to_all_single'] = got[0]
        elif not got and all(c is not None and c < 0 for c in codes):
            out[f'{name} all_to_all_single'] = (
                f'fails: both ranks killed by signals {[-c for c in codes]}')
        else:
            out[f'{name} all_to_all_single'] = (
                f'fails: {got or "no result"}; rank exit codes {codes}')
    return out


def sharded_case(kind):
    """(plan, global batch rows, seq, config) of (b) 'fsdp', (c) 'tensor',
    (d) 'ring'."""
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    from skypilot_tpu_torch.parallel.mesh import MeshPlan
    cfg = dataclasses.replace(LLAMA_CONFIGS[SHARDED['model']],
                              n_layers=SHARDED['n_layers'])
    n = SHARDED['ranks']
    if kind == 'fsdp':
        return MeshPlan(fsdp=n), SHARDED['batch'], SHARDED['seq'], cfg
    if kind == 'tensor':
        return (MeshPlan(tensor=n), SHARDED['tensor_batch'], SHARDED['seq'],
                cfg)
    cfg = dataclasses.replace(cfg, attention_impl='ring',
                              max_seq_len=SHARDED['ring_seq'])
    return (MeshPlan(fsdp=n), SHARDED['ring_batch'], SHARDED['ring_seq'],
            cfg)


def sharded_tokens(kind, device, vocab):
    """The global batch of `kind`, the same draw in every process."""
    import torch
    _, batch, seq, _ = sharded_case(kind)
    gen = torch.Generator(device=device).manual_seed(
        SEED + (3 if kind == 'ring' else 2))
    rows = SHARDED['batch'] if kind != 'ring' else batch
    return torch.randint(0, vocab, (rows, seq), device=device,
                         generator=gen)[:batch]


def sharded_rank(kind, ckpt_dir=None):
    """One rank of SHARDED's gloo pair on cuda:0 training `kind` through
    Trainer(..., mesh=): its slices of the SEED draw, step 1 alone, then
    the 2 timed steps with the kernels' counts zeroed just before and read
    just after; with `ckpt_dir` the trained state is saved there (DCP)
    and each rank writes its FSDP shards beside it (`shards_<i>.pt`,
    rows i of 2 along dim 0: (b) is fsdp=2 at tensor=1).  DTensor's own
    gather (`full_tensor`) is not used: over gloo on CUDA tensors its
    functional all-gather faulted the rank process (H100, torch
    2.11.0+cu128)."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.parallel.mesh import build_mesh
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    plan, _, _, cfg = sharded_case(kind)
    t0 = time.perf_counter()
    mesh = build_mesh(plan, devices=[SHARDED['device']] * SHARDED['ranks'],
                      backend='gloo')
    device = mesh.device
    model = Llama(cfg, init_params(
        cfg, mesh=mesh,
        generator=torch.Generator(device=device).manual_seed(SEED)), mesh)
    trainer = Trainer(model, TrainConfig(
        warmup_steps=SHARDED['warmup_steps'],
        total_steps=SHARDED['total_steps']), checkpoint_dir=ckpt_dir,
        mesh=mesh)
    tokens = sharded_tokens(kind, device, cfg.vocab_size)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_metrics = []
    train_step = trainer.train_step

    def recording_step(state, tokens_):
        state, metrics = train_step(state, tokens_)
        step_metrics.append(metrics)
        return state, metrics

    trainer.train_step = recording_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.run(iter([tokens]), 1, log_every=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    timed = SHARDED['steps'] - 1
    zero_launches()
    t0 = time.perf_counter()
    trainer.run(iter([tokens] * timed), timed, log_every=timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    out = {'rank': mesh.rank, 'coord': mesh.coordinate('fsdp'),
           'init_s': init_s, 'first_s': first_s, 'step_s': wall / timed,
           'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
           'losses': [float(m['loss']) for m in step_metrics],
           'norms': [float(m['grad_norm']) for m in step_metrics],
           'counts': counts, 'rows': tuple(tokens.shape)}
    if ckpt_dir is not None:
        t0 = time.perf_counter()
        trainer.save_checkpoint()
        out['save_s'] = time.perf_counter() - t0
        from torch.distributed.tensor import Replicate, Shard
        shards = {}
        for name, p in trainer.state.model.named_parameters():
            if tuple(p.placements) != (Replicate(), Shard(0)):
                raise SystemExit(f'{name} is placed {p.placements}')
            shards[name] = p.detach().to_local().cpu()
        torch.save(shards, os.path.join(
            ckpt_dir, f'shards_{mesh.coordinate("fsdp")}.pt'))
        del shards
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ring_op_rank(shape=RING_HOP_SHAPE):
    """One rank of the fsdp=2 gloo pair: the ring op at one hop's `shape`
    on its chunk of a seeded global q, k, v (bf16), forward and backward
    with a seeded cotangent; returns its blocks and the launches of the
    one call (a comparison, not a main path)."""
    import torch
    from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from skypilot_tpu_torch.parallel.ring_attention import ring_attention
    mesh = build_mesh(MeshPlan(fsdp=SHARDED['ranks']),
                      devices=[SHARDED['device']] * SHARDED['ranks'],
                      backend='gloo')
    q, k, v, g = ring_inputs(mesh.device, shape)
    s = shape[3]
    sl = slice(mesh.coordinate('fsdp') * s, (mesh.coordinate('fsdp') + 1) * s)
    lq, lk, lv = (x[:, :, sl].contiguous().requires_grad_()
                  for x in (q, k, v))
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ring_attention(lq, lk, lv, mesh, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (lq, lk, lv),
                                     g[:, :, sl].contiguous())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    res = {'coord': mesh.coordinate('fsdp'),
           'counts': {**read_launches(), **read_small_launches()},
           'wall_ms': wall_ms,
           **{key: t.detach().cpu() for key, t in
              (('out', out), ('dq', dq), ('dk', dk), ('dv', dv))}}
    del q, k, v, g, out, dq, dk, dv
    torch.cuda.empty_cache()
    return res


def check_ring_op(device, shape, blocks, seconds):
    """(e)'s gates on the ranks' `blocks` of the ring op at one hop's
    `shape`: output (BWD_NORM_RTOL) and dq/dk/dv (GRAD_PLAIN_RTOL) against
    ring_attention_reference, one launch of each kernel per hop (the
    small kernels at head_dim 16 or 32, the wgmma ones otherwise).
    Returns the norm-relative errors."""
    import torch
    q, k, v, g = ring_inputs(device, shape)
    ref = ring_reference_grads(q, k, v, g)
    del q, k, v, g
    s = shape[3]
    rels = {}
    for i, key in enumerate(('out', 'dq', 'dk', 'dv')):
        got = torch.zeros_like(ref[i])
        for blk in blocks:
            c = blk['coord']
            got[:, :, c * s:(c + 1) * s] = blk[key].to(device)
        rels[key] = _norm_rel(got, ref[i])
    del ref, got
    torch.cuda.empty_cache()
    launched = SMALL_KERNELS if shape[4] in (16, 32) else KERNEL_NAMES
    for blk in blocks:
        want = {**dict.fromkeys(KERNEL_NAMES + SMALL_KERNELS, 0),
                **dict.fromkeys(launched, blk['coord'] + 1)}
        if blk['counts'] != want:
            raise SystemExit(f'the ring op launched {blk["counts"]} on chunk '
                             f'{blk["coord"]}, expected {want}')
    log(f'  (e) ring op at {shape} per hop (causal, bf16) vs '
        f'ring_attention_reference: norm-rel out {rels["out"]:.2e} (gate '
        f'{BWD_NORM_RTOL}), dq {rels["dq"]:.2e}, dk {rels["dk"]:.2e}, dv '
        f'{rels["dv"]:.2e} (gate {GRAD_PLAIN_RTOL} each); launches per rank '
        f'{[b["counts"] for b in blocks]}; forward + backward wall '
        f'{[round(b["wall_ms"], 1) for b in blocks]} ms (host-staged hops); '
        f'both shapes on the ranks {seconds:.1f} s')
    if not (rels['out'] <= BWD_NORM_RTOL and
            max(rels[k] for k in ('dq', 'dk', 'dv')) <= GRAD_PLAIN_RTOL):
        raise SystemExit(f'the ring op disagrees with '
                         f'ring_attention_reference at {shape}')
    return rels


def tiny_cfg_and_tokens(device):
    """(h)'s model and global batch: `tiny` at TINY_TRAIN's first shape,
    the same draw in every process."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    cfg = LLAMA_CONFIGS[TINY_TRAIN['model']]
    tokens = torch.randint(
        0, cfg.vocab_size, (TINY_TRAIN['batch'], TINY_TRAIN['seqs'][0]),
        device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 7))
    return cfg, tokens


def tiny_one_device_save(device, ckpt_dir):
    """(h) on one device: a `tiny` Trainer's 2 steps, saved (a
    `state.pt`), then its step 3; returns step 3's (loss, grad norm)."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg, tokens = tiny_cfg_and_tokens(device)
    trainer = Trainer(Llama(cfg, init_params(
        cfg, device, torch.Generator(device=device).manual_seed(SEED))),
        TrainConfig(warmup_steps=SHARDED['warmup_steps'],
                    total_steps=SHARDED['total_steps']),
        checkpoint_dir=ckpt_dir, device=device)
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state, tokens)
    trainer.save_checkpoint()
    trainer.state, m = trainer.train_step(trainer.state, tokens)
    return float(m['loss']), float(m['grad_norm'])


def tiny_restore_rank(ckpt_dir):
    """One rank of (h): a `tiny` Trainer at fsdp=2 on cuda:0 (other
    weights than the saved ones) resumed from the one-device `state.pt`
    in `ckpt_dir`; whether each parameter's and AdamW moment's shard is
    bit-equal to its rows of the saved tensor (FSDP2 splits dim 0 as
    torch.chunk does), the restored step; then one step (loss, grad
    norm)."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    n = SHARDED['ranks']
    mesh = build_mesh(MeshPlan(fsdp=n), devices=[SHARDED['device']] * n,
                      backend='gloo')
    cfg, tokens = tiny_cfg_and_tokens(mesh.device)
    model = Llama(cfg, init_params(
        cfg, mesh=mesh, generator=torch.Generator(
            device=mesh.device).manual_seed(SEED + 8)), mesh)
    trainer = Trainer(model, TrainConfig(
        warmup_steps=SHARDED['warmup_steps'],
        total_steps=SHARDED['total_steps']), checkpoint_dir=ckpt_dir,
        mesh=mesh)
    resumed = trainer.restore_if_available()
    state = trainer.state
    mgr = CheckpointManager(ckpt_dir)
    saved = torch.load(mgr.state_path(resumed), mmap=True,
                       weights_only=True, map_location='cpu')
    coord = mesh.coordinate('fsdp')
    unequal = []
    with torch.no_grad():
        for i, (name, p) in enumerate(state.model.named_parameters()):
            adam = state.optimizer.state[p]
            for key, t, whole in (
                    ('param', p, saved['params'][name]),
                    ('exp_avg', adam['exp_avg'],
                     saved['optimizer']['state'][i]['exp_avg']),
                    ('exp_avg_sq', adam['exp_avg_sq'],
                     saved['optimizer']['state'][i]['exp_avg_sq'])):
                if not torch.equal(t.to_local().cpu(),
                                   whole.chunk(n)[coord]):
                    unequal.append(f'{key}:{name}')
    step = int(state.step)
    trainer.state, m = trainer.train_step(state, tokens)
    out = {'rank': mesh.rank, 'resumed': resumed, 'step': step,
           'unequal': unequal, 'n': 3 * len(saved['params']),
           'loss': float(m['loss']), 'norm': float(m['grad_norm'])}
    del trainer, model, state, saved
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_tiny_restore(want, ranks, seconds):
    """(h)'s gates: every rank resumed step 2 with every shard bit-equal
    to the saved tensors' rows, and its next step within SHARDED's gates
    of the one-device step 3 (`want`: loss, grad norm)."""
    for r in ranks:
        loss_rel = abs(r['loss'] - want[0]) / abs(want[0])
        norm_rel = abs(r['norm'] - want[1]) / abs(want[1])
        log(f'  (h) rank {r["rank"]}: a one-device tiny state.pt (step '
            f'{r["resumed"]}) restored at fsdp=2: {r["n"] - len(r["unequal"])}'
            f' of {r["n"]} parameter and moment shards bit-equal to the '
            f'saved rows; next step loss {r["loss"]:.6f} vs one device '
            f'{want[0]:.6f} (rel {loss_rel:.2e}, gate {SHARDED_LOSS_RTOL}), '
            f'grad norm {r["norm"]:.6f} vs {want[1]:.6f} (rel '
            f'{norm_rel:.2e}, gate {SHARDED_NORM_RTOL}); save, restore and '
            f'step {seconds:.1f} s')
        if (r['resumed'], r['step']) != (2, 2) or r['unequal'] or \
                loss_rel > SHARDED_LOSS_RTOL or norm_rel > SHARDED_NORM_RTOL:
            raise SystemExit(f'the one-device tiny step restored at fsdp=2 '
                             f'differs: {r}')


def ring_inputs(device, shape):
    """The whole sequence's q, k, v and cotangent at one hop's `shape`
    (bf16), the same draw in every process."""
    import torch
    b, hq, hkv, s, d = shape
    n = SHARDED['ranks']
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    def draw(h):
        return torch.randn((b, h, s * n, d), generator=gen,
                           device=device).to(torch.bfloat16)
    return draw(hq), draw(hkv), draw(hkv), draw(hq)


def ring_reference_grads(q, k, v, g):
    """ring_attention_reference's output and its gradients on the card,
    one kv head (with its query heads) at a time: each block's f32 logits
    of all heads at once would not fit."""
    import torch
    from skypilot_tpu_torch.parallel.ring_attention import (
        ring_attention_reference)
    group = q.shape[1] // k.shape[1]
    outs, dqs, dks, dvs = [], [], [], []
    for h in range(k.shape[1]):
        qs = slice(h * group, (h + 1) * group)
        lq = q[:, qs].detach().requires_grad_()
        lk, lv = (x[:, h:h + 1].detach().requires_grad_() for x in (k, v))
        out = ring_attention_reference(lq, lk, lv, SHARDED['ranks'])
        dq, dk, dv = torch.autograd.grad(out, (lq, lk, lv), g[:, qs])
        outs.append(out.detach())
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
        del out
        torch.cuda.empty_cache()
    return (torch.cat(outs, 1), torch.cat(dqs, 1), torch.cat(dks, 1),
            torch.cat(dvs, 1))


def reference_steps(cfg, params, tokens, spec=SHARDED):
    """The one-device trainer's (loss, pre-clip grad norm) of each of
    `spec`'s steps (SHARDED, EXPERT) on `tokens`, from `params` (the
    train step of Trainer.run, on one device)."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama
    from skypilot_tpu_torch.train import trainer as tt
    tcfg = tt.TrainConfig(warmup_steps=spec['warmup_steps'],
                          total_steps=spec['total_steps'])
    state = tt.make_train_state(Llama(cfg, params), tcfg)
    step = tt.make_train_step(tcfg)
    out = []
    for _ in range(spec['steps']):
        state, metrics = step(state, tokens)
        out.append((float(metrics['loss']), float(metrics['grad_norm'])))
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def nccl_world1(device):
    """(f) The FSDP2 step and the one-hop ring over a one-rank NCCL group
    in this process against the unsharded trainer's, two steps each on
    the same weights; returns the launches of the sharded runs (rank 0's
    main path) and the numbers."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.parallel import group as group_lib
    from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from skypilot_tpu_torch.train import trainer as tt

    cfg = dataclasses.replace(LLAMA_CONFIGS[SHARDED['model']],
                              n_layers=SHARDED['nccl_layers'])
    tcfg = tt.TrainConfig(warmup_steps=SHARDED['warmup_steps'],
                          total_steps=SHARDED['total_steps'])
    tokens = torch.randint(
        0, cfg.vocab_size, (SHARDED['nccl_batch'], SHARDED['nccl_seq']),
        device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 4))

    def params():
        return init_params(cfg, device,
                           torch.Generator(device=device).manual_seed(SEED))

    one = tt.make_train_state(Llama(cfg, params()), tcfg)
    step = tt.make_train_step(tcfg)
    want = [step(one, tokens)[1] for _ in range(2)]
    want = [(float(m['loss']), float(m['grad_norm'])) for m in want]
    want_params = {n: p.detach().clone()
                   for n, p in one.model.named_parameters()}
    del one
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    results = {}
    group_lib.join(0, 1, group_lib.free_port(), 'nccl', timeout_s=300)
    try:
        mesh = build_mesh(MeshPlan(), devices=[device], backend='nccl')
        for impl in ('flash', 'ring'):
            cfg_i = dataclasses.replace(cfg, attention_impl=impl)
            state = tt.make_train_state(Llama(cfg_i, params(), mesh), tcfg,
                                        mesh)
            sharded_step = tt.make_sharded_train_step(mesh, tcfg)
            zero_launches()
            got = [sharded_step(state, tokens)[1] for _ in range(2)]
            torch.cuda.synchronize()
            for name, n in read_launches().items():
                counts[name] += n
            got = [(float(m['loss']), float(m['grad_norm'])) for m in got]
            diff = max((state.layout.global_view(p, n).full_tensor() -
                        want_params[n]).abs().max().item()
                       for n, p in state.model.named_parameters())
            results[impl] = {'metrics': got, 'param_diff': diff}
            del state
    finally:
        group_lib.leave()
    del want_params
    torch.cuda.empty_cache()
    return counts, want, results


def sharded_training_phase(device, card, smi):
    """Sharded training (SHARDED) on the one card: (a) which collectives
    gloo runs on CUDA tensors (those FSDP2 and the tensor-parallel pair
    need must work); (b) fsdp=2,
    (c) tensor=2, (d) ring at fsdp=2, each two gloo ranks on cuda:0
    through Trainer(..., mesh=): each step against the one-device
    trainer's (run first, freed before the ranks start), every rank's metrics equal
    rank 0's, exact launches per rank; (e) the ring op at one hop's shape
    (head_dim 64, and `tiny`'s 16) against ring_attention_reference; (h)
    a one-device `tiny` state.pt restored at fsdp=2; (g) (b)'s saved
    step restored on one device, bit-equal to the gathered shards; (f)
    world 1 over NCCL.
    Returns (rank 0's launches over (b)-(d) and (f), the kernel times at
    the ring hop's shape)."""
    import torch
    from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                                 init_params)
    from skypilot_tpu_torch.parallel import group as group_lib
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train import trainer as tt

    n = SHARDED['ranks']
    cfg = LLAMA_CONFIGS[SHARDED['model']]
    per_rank = [(SHARDED['batch'] // n, cfg.n_heads, cfg.n_kv_heads),
                (SHARDED['tensor_batch'], cfg.n_heads // n,
                 cfg.n_kv_heads // n)]
    shapes = [(*x, SHARDED['seq'], cfg.head_dim, True, 'bfloat16')
              for x in per_rank] + [
                  (SHARDED['nccl_batch'], cfg.n_heads, cfg.n_kv_heads,
                   SHARDED['nccl_seq'], cfg.head_dim, True, 'bfloat16')]
    if any(shape not in BWD_SHAPES for shape in shapes):
        raise SystemExit(f'the kernel phase does not check every rank '
                         f'shape of this phase: {shapes}')
    # The ranks start importing while this process runs the references.
    pool = group_lib.RankPool(n, 'gloo', timeout_s=600)
    try:
        refs = {}
        t0 = time.perf_counter()
        for kind in ('fsdp', 'tensor', 'ring'):
            _, _, _, cfg = sharded_case(kind)
            if kind == 'ring':
                cfg = dataclasses.replace(cfg, attention_impl='flash')
            params = init_params(
                cfg, device, torch.Generator(device=device).manual_seed(SEED))
            refs[kind] = reference_steps(
                cfg, params, sharded_tokens(kind, device, cfg.vocab_size))
            del params
            torch.cuda.empty_cache()
        _, _, _, cfg = sharded_case('fsdp')
        log(f'  {SHARDED["model"]}: {cfg.num_params() / 1e9:.3f}B params '
            f'f32, {cfg.n_layers} layers, dim {cfg.dim}, heads '
            f'{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, tied '
            f'{cfg.tie_embeddings}, vocab {cfg.vocab_size}, remat '
            f'{cfg.remat}/{cfg.remat_policy!r}; one-device references (loss, '
            f'grad norm) of steps 1-{SHARDED["steps"]} {refs} in '
            f'{time.perf_counter() - t0:.1f} s')

        t0 = time.perf_counter()
        probe = pool.run(sharded_probe, None, timeout_s=300)[0]
        log(f'  (a) gloo over CUDA tensors, {n} ranks on cuda:0 (pool up and '
            f'probed in {time.perf_counter() - t0:.1f} s):')
        for key, result in probe.items():
            log(f'    {key}: {result}')
        needed = [f'{d} {op}' for d in ('bfloat16', 'float32')
                  for op in ('reduce_scatter_tensor', 'all_gather_into_tensor',
                             'all_reduce')]
        if any(probe[key] != 'ok' for key in needed):
            raise SystemExit(f'gloo refuses a collective FSDP2 or the '
                             f'tensor-parallel pair needs: {probe}')
        if probe['ring via host'] is not True:
            raise SystemExit('the ring does not stage CUDA tensors through '
                             'host buffers on a gloo mesh')
        log('    the ring\'s K/V and dK/dV over this gloo mesh go through '
            'pinned host buffers (decided from the backend)')

        ckpt_dir = os.path.join(REPO, 'build', 'sharded_ckpt')
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        runs, by_path = {}, dict.fromkeys(KERNEL_NAMES, 0)
        for label, kind in (('(b) fsdp=2', 'fsdp'), ('(c) tensor=2', 'tensor'),
                            ('(d) ring, fsdp=2', 'ring')):
            t0 = time.perf_counter()
            ranks = pool.run(sharded_rank, kind,
                             ckpt_dir if kind == 'fsdp' else None,
                             timeout_s=600)
            runs[kind] = ranks
            plan, batch, seq, cfg = sharded_case(kind)
            lead = ranks[0]
            rels = [(abs(lead['losses'][i] - want[0]) / abs(want[0]),
                     abs(lead['norms'][i] - want[1]) / abs(want[1]))
                    for i, want in enumerate(refs[kind])]
            steps = SHARDED['steps'] - 1
            log(f'  {label}: {batch} x {seq} tokens on {card} ({smi}), '
                f'{time.perf_counter() - t0:.1f} s: ' + '; '.join(
                    f'step {i + 1} loss {lead["losses"][i]:.6f} vs one '
                    f'device {want[0]:.6f} (rel {rels[i][0]:.2e}, gate '
                    f'{SHARDED_LOSS_RTOL}), grad norm {lead["norms"][i]:.6f} '
                    f'vs {want[1]:.6f} (rel {rels[i][1]:.2e}, gate '
                    f'{SHARDED_NORM_RTOL})'
                    for i, want in enumerate(refs[kind])))
            for r in ranks:
                log(f'    rank {r["rank"]}: init {r["init_s"]:.1f} s, step 1 '
                    f'{r["first_s"]:.2f} s, {r["step_s"]:.2f} s per timed '
                    f'step (two ranks on one card over gloo: a correctness '
                    f'run, not a parallel rate), peak {r["peak_gb"]:.2f} GB, '
                    f'launches {r["counts"]}' +
                    (f', save {r["save_s"]:.1f} s' if 'save_s' in r else ''))
                hops = r['coord'] + 1 if kind == 'ring' else 1
                want = {'flash_attention_fwd': 2 * cfg.n_layers * hops * steps,
                        'flash_attention_bwd_dq': cfg.n_layers * hops * steps,
                        'flash_attention_bwd_dkv':
                            cfg.n_layers * hops * steps}
                if r['counts'] != want:
                    raise SystemExit(f'{label} rank {r["rank"]} launched '
                                     f'{r["counts"]}, expected {want} (per '
                                     f'layer and hop: 2 forwards under '
                                     f'remat, 1 dq, 1 dk/dv)')
                if (r['losses'], r['norms']) != (lead['losses'],
                                                 lead['norms']):
                    raise SystemExit(f'{label}: rank {r["rank"]} reads other '
                                     f'metrics than rank 0')
            if not (all(map(math.isfinite, lead['losses'] + lead['norms']))
                    and all(loss_rel <= SHARDED_LOSS_RTOL and
                            norm_rel <= SHARDED_NORM_RTOL
                            for loss_rel, norm_rel in rels)):
                raise SystemExit(f'{label}: a step disagrees with the '
                                 f'one-device trainer: {rels}')
            for name in KERNEL_NAMES:
                by_path[name] += lead['counts'][name]

        # (e) the ring op at one hop's shape against the plain version,
        # at llama3-1b's head_dim 64 and at `tiny`'s 16.
        t0 = time.perf_counter()
        blocks = {shape: pool.run(ring_op_rank, shape, timeout_s=300)
                  for shape in (RING_HOP_SHAPE, RING_SMALL_HOP_SHAPE)}
        ring_s = time.perf_counter() - t0
        # (h) a one-device `tiny` state.pt restored at fsdp=2.
        t0 = time.perf_counter()
        restore_dir = os.path.join(REPO, 'build', 'tiny_ckpt')
        if os.path.exists(restore_dir):
            shutil.rmtree(restore_dir)
        want = tiny_one_device_save(device, restore_dir)
        restored = pool.run(tiny_restore_rank, restore_dir, timeout_s=300)
        restore_s = time.perf_counter() - t0
    finally:
        pool.close()
    rels = {}
    for shape, ranks in blocks.items():
        rels[shape] = check_ring_op(device, shape, ranks, ring_s)
    check_tiny_restore(want, restored, restore_s)
    shutil.rmtree(restore_dir)
    rels = rels[RING_HOP_SHAPE]

    # (g) the step (b) saved, restored on one device.
    t0 = time.perf_counter()
    _, _, _, cfg = sharded_case('fsdp')
    mgr = ckpt_lib.CheckpointManager(ckpt_dir)
    saved_step = mgr.latest_step()
    state = tt.make_train_state(Llama(cfg, init_params(
        cfg, device, torch.Generator(device=device).manual_seed(SEED + 9))),
        tt.TrainConfig(warmup_steps=SHARDED['warmup_steps'],
                       total_steps=SHARDED['total_steps']))
    mgr.restore(saved_step, state)
    shards = [torch.load(os.path.join(ckpt_dir, f'shards_{i}.pt'),
                         mmap=True, weights_only=True) for i in range(n)]
    gathered = {name: torch.cat([sh[name] for sh in shards])
                for name in shards[0]}
    del shards
    unequal = [name for name, p in state.model.named_parameters()
               if not torch.equal(p.detach().cpu(), gathered[name])]
    log(f'  (g) step {saved_step} of (b) (DCP, {mgr.is_sharded(saved_step)}) '
        f'restored on one device in {time.perf_counter() - t0:.1f} s: '
        f'{len(gathered) - len(unequal)} of {len(gathered)} parameters '
        f'bit-equal to the gathered shards; step {int(state.step)}')
    if unequal or saved_step != SHARDED['steps'] or \
            int(state.step) != saved_step:
        raise SystemExit(f'the restored step differs from the gathered '
                         f'shards: {unequal[:5]}')
    del state, gathered
    shutil.rmtree(ckpt_dir)
    gc.collect()
    torch.cuda.empty_cache()

    # (f) world 1 over NCCL.
    t0 = time.perf_counter()
    counts, want, results = nccl_world1(device)
    for impl, r in results.items():
        loss_rel = max(abs(a[0] - b[0]) / abs(b[0])
                       for a, b in zip(r['metrics'], want))
        norm_rel = max(abs(a[1] - b[1]) / abs(b[1])
                       for a, b in zip(r['metrics'], want))
        log(f'  (f) {impl} over a one-rank NCCL group vs the unsharded '
            f'trainer, 2 steps of {SHARDED["nccl_batch"]} x '
            f'{SHARDED["nccl_seq"]} at {SHARDED["nccl_layers"]} layers: '
            f'loss rel {loss_rel:.2e} (gate {NCCL_LOSS_RTOL}), grad norm rel '
            f'{norm_rel:.2e} (gate {NCCL_NORM_RTOL}), params max |diff| '
            f'{r["param_diff"]:.2e} (gate {NCCL_PARAM_ATOL}): equal within '
            f'f32 rounding: '
            f'{loss_rel <= NCCL_LOSS_RTOL and norm_rel <= NCCL_NORM_RTOL and r["param_diff"] <= NCCL_PARAM_ATOL}')
        if not (loss_rel <= NCCL_LOSS_RTOL and norm_rel <= NCCL_NORM_RTOL
                and r['param_diff'] <= NCCL_PARAM_ATOL):
            raise SystemExit(f'(f) {impl} at world 1 differs from the '
                             f'unsharded step beyond f32 rounding')
    log(f'    launches {counts}; {time.perf_counter() - t0:.1f} s')
    for name in KERNEL_NAMES:
        by_path[name] += counts[name]
    return by_path, kernel_times(device, RING_HOP_SHAPE, 'ring hop'), rels


# ----- pipeline, expert parallelism, MoE under tensor=2, the graft entry ----
def pipeline_stage(cfg, n_blocks):
    """The stage function (params, x [B, S, D]) -> x of a pipeline stage:
    `n_blocks` decoder blocks of `cfg` (meta parameters; each call
    supplies the stage's `layers.<j>.*` through
    `torch.func.functional_call`), each block under the config's remat as
    in the model (the recompute calls the block with the same
    parameters)."""
    import torch
    from torch.utils import checkpoint as checkpoint_lib
    from skypilot_tpu_torch.models.llama import _REMAT_CONTEXTS, Block
    blocks = [Block(cfg) for _ in range(n_blocks)]

    def fn(params, x):
        positions = torch.arange(x.shape[1], device=x.device)[
            None, :].expand(x.shape[:2])
        for j, block in enumerate(blocks):
            prefix = f'layers.{j}.'
            own = {k[len(prefix):]: v for k, v in params.items()
                   if k.startswith(prefix)}

            def apply(h, block=block, own=own):
                return torch.func.functional_call(block, own,
                                                  (h, positions))[0]
            if cfg.remat:
                x = checkpoint_lib.checkpoint(
                    apply, x, use_reentrant=False,
                    context_fn=_REMAT_CONTEXTS[cfg.remat_policy])
            else:
                x = apply(x)
        return x
    return fn


def pipeline_weights(cfg, device, stage):
    """Stage `stage`'s block weights from the SEED draw of the whole
    model, named as `pipeline_stage`'s module names them."""
    import torch
    from skypilot_tpu_torch.models.llama import init_params
    per = cfg.n_layers // PIPELINE['stages']
    full = init_params(cfg, device,
                       torch.Generator(device=device).manual_seed(SEED))
    out = {}
    for name, t in full.items():
        m = re.fullmatch(r'layers\.(\d+)\.(.*)', name)
        if m and int(m.group(1)) // per == stage:
            out[f'layers.{int(m.group(1)) % per}.{m.group(2)}'] = t
    del full
    return out


def pipeline_inputs(device, cfg):
    """The global batch's activations and the output's cotangent (bf16,
    SEED), the same draw in every process."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    shape = (PIPELINE['batch'], PIPELINE['seq'], cfg.dim)
    return tuple(torch.randn(shape, generator=gen, device=device).to(
        cfg.dtype) for _ in range(2))


def pipeline_rank(out_dir):
    """One rank of PIPELINE's gloo pair on cuda:0: pipeline_apply of its
    stage over the global batch, forward and backward with the launch
    counts zeroed just before and read just after; the output (rank 0),
    x's gradient (the last stage, which holds it only through the sum
    over the group) and its stage's gradients go to `out_dir`."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from skypilot_tpu_torch.parallel.pipeline import pipeline_apply
    n = PIPELINE['stages']
    mesh = build_mesh(MeshPlan(pipeline=n), devices=[PIPELINE['device']] * n,
                      backend='gloo')
    cfg = LLAMA_CONFIGS[PIPELINE['model']]
    stage = mesh.coordinate('pipeline')
    params = {k: t.unsqueeze(0).requires_grad_() for k, t in
              pipeline_weights(cfg, mesh.device, stage).items()}
    x, g = pipeline_inputs(mesh.device, cfg)
    x.requires_grad_()
    fn = pipeline_stage(cfg, cfg.n_layers // n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = pipeline_apply(fn, params, x, mesh=mesh,
                         n_microbatches=PIPELINE['n_micro'])
    torch.autograd.backward(out, g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    torch.save({k: t.grad[0].cpu() for k, t in params.items()},
               os.path.join(out_dir, f'pipeline_grads_{stage}.pt'))
    if mesh.rank == 0:
        torch.save(out.detach().cpu(), os.path.join(out_dir,
                                                    'pipeline_out.pt'))
    if stage == n - 1:
        torch.save(x.grad.cpu(), os.path.join(out_dir, 'pipeline_dx.pt'))
    return {'rank': mesh.rank, 'stage': stage, 'counts': counts,
            'wall_s': wall,
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9}


def pipeline_phase(device, card, smi):
    """GPipe (PIPELINE) over pipeline=2, both gloo ranks on the card:
    the output, x's gradient (the last stage's, summed over the group)
    and every stage's gradients against the sequential fold of
    the same blocks on one device (run first), norm-relative within
    PIPELINE_RTOL per tensor; exact launches per rank (every rank runs
    every one of the n_micro + n_stages - 1 steps, each block twice
    forward under remat).  Returns rank 0's launches."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    from skypilot_tpu_torch.parallel import group as group_lib

    n = PIPELINE['stages']
    cfg = LLAMA_CONFIGS[PIPELINE['model']]
    per = cfg.n_layers // n
    out_dir = os.path.join(REPO, 'build', 'pipeline')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    pool = group_lib.RankPool(n, 'gloo', timeout_s=600)
    try:
        # The sequential fold on one device: stage 0's blocks, then
        # stage 1's, over the whole batch.
        t0 = time.perf_counter()
        fn = pipeline_stage(cfg, per)
        x, g = pipeline_inputs(device, cfg)
        x.requires_grad_()
        stages = []
        h = x
        for i in range(n):
            params = {k: t.requires_grad_() for k, t in
                      pipeline_weights(cfg, device, i).items()}
            stages.append(params)
            h = fn(params, h)
        torch.autograd.backward(h, g)
        want_out, want_dx = h.detach(), x.grad
        want = [{k: t.grad for k, t in p.items()} for p in stages]
        del stages, h, x, g
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        log(f'  {PIPELINE["model"]} blocks: {per} of {cfg.n_layers} a stage '
            f'({sum(p.numel() for p in want[0].values()) / 1e6:.1f}M params '
            f'a stage, f32), dim {cfg.dim}, heads {cfg.n_heads}/'
            f'{cfg.n_kv_heads} x {cfg.head_dim}, ffn {cfg.ffn_dim}, remat '
            f'{cfg.remat}/{cfg.remat_policy!r}; the sequential fold on one '
            f'device, forward + backward over {PIPELINE["batch"]} x '
            f'{PIPELINE["seq"]}: {ref_s:.1f} s')
        t0 = time.perf_counter()
        ranks = pool.run(pipeline_rank, out_dir, timeout_s=600)
        wall = time.perf_counter() - t0
    finally:
        pool.close()
    steps = PIPELINE['n_micro'] + n - 1
    expect = {'flash_attention_fwd': 2 * per * steps,
              'flash_attention_bwd_dq': per * steps,
              'flash_attention_bwd_dkv': per * steps}
    for r in ranks:
        log(f'    rank {r["rank"]} (stage {r["stage"]}): forward + backward '
            f'{r["wall_s"]:.2f} s over {steps} steps ({PIPELINE["n_micro"]} '
            f'microbatches; two ranks on one card over gloo, every hop '
            f'through the host: a correctness run, not a pipeline rate), '
            f'peak {r["peak_gb"]:.2f} GB, launches {r["counts"]}')
        if r['counts'] != expect:
            raise SystemExit(f'pipeline rank {r["rank"]} launched '
                             f'{r["counts"]}, expected {expect}')
    rels = {'out': _norm_rel(torch.load(os.path.join(
        out_dir, 'pipeline_out.pt')).to(device), want_out),
            'x': _norm_rel(torch.load(os.path.join(
                out_dir, 'pipeline_dx.pt')).to(device), want_dx)}
    for i in range(n):
        got = torch.load(os.path.join(out_dir, f'pipeline_grads_{i}.pt'),
                         mmap=True, weights_only=True)
        for k, ref in want[i].items():
            rels[f'stage {i} {k}'] = _norm_rel(got[k].to(device), ref)
        del got
    del want, want_out, want_dx
    shutil.rmtree(out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(rels, key=rels.get)
    log(f'  pipeline=2 on {card} ({smi}), {wall:.1f} s: output norm-rel '
        f'{rels["out"]:.2e}, x gradient {rels["x"]:.2e}, {len(rels) - 2} '
        f'stage gradients norm-rel '
        f'max {rels[worst]:.2e} ({worst}), median '
        f'{sorted(rels.values())[len(rels) // 2]:.2e} (gate {PIPELINE_RTOL} '
        f'each) against the sequential fold')
    if not all(math.isfinite(v) and v <= PIPELINE_RTOL
               for v in rels.values()):
        raise SystemExit(f'the pipeline disagrees with the sequential fold: '
                         f'{worst} {rels[worst]}')
    return ranks[0]['counts'], kernel_times(device, PIPE_MICRO_SHAPE,
                                            'pipeline microbatch')


def expert_case():
    """(config, global tokens) of EXPERT, the same draw in every
    process."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    cfg = dataclasses.replace(LLAMA_CONFIGS[EXPERT['model']],
                              n_experts=EXPERT['n_experts'],
                              n_layers=EXPERT['n_layers'])
    device = torch.device(EXPERT['device'])
    tokens = torch.randint(
        0, cfg.vocab_size, (EXPERT['batch'], EXPERT['seq']), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 31))
    return cfg, tokens


def expert_rank():
    """One rank of EXPERT's gloo pair on cuda:0 through Trainer(...,
    mesh=) at expert=2: its experts of the SEED draw, step 1 alone, then
    the timed steps with the launch counts zeroed just before and read
    just after."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    n = EXPERT['expert']
    mesh = build_mesh(MeshPlan(expert=n), devices=[EXPERT['device']] * n,
                      backend='gloo')
    cfg, tokens = expert_case()
    t0 = time.perf_counter()
    model = Llama(cfg, init_params(
        cfg, mesh=mesh,
        generator=torch.Generator(device=mesh.device).manual_seed(SEED)),
        mesh)
    trainer = Trainer(model, TrainConfig(warmup_steps=EXPERT['warmup_steps'],
                                         total_steps=EXPERT['total_steps']),
                      mesh=mesh)
    experts = tuple(model.layers[0].moe_mlp.w_gate.shape)
    local_params = sum(p.numel() for p in model.parameters()) / 1e9
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_metrics = []
    train_step = trainer.train_step

    def recording_step(state, tokens_):
        state, metrics = train_step(state, tokens_)
        step_metrics.append(metrics)
        return state, metrics

    trainer.train_step = recording_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.run(iter([tokens]), 1, log_every=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    timed = EXPERT['steps'] - 1
    zero_launches()
    t0 = time.perf_counter()
    trainer.run(iter([tokens] * timed), timed, log_every=timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    out = {'rank': mesh.rank, 'experts': experts, 'init_s': init_s,
           'first_s': first_s, 'step_s': wall / timed,
           'local_params_b': local_params,
           'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
           'losses': [float(m['loss']) for m in step_metrics],
           'norms': [float(m['grad_norm']) for m in step_metrics],
           'counts': counts}
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def expert_parallel_phase(device, card, smi):
    """Expert parallelism (EXPERT) on the one card: (a) whether gloo runs
    all_to_all_single on CUDA tensors (a throwaway pair per dtype); then
    two gloo ranks on cuda:0 at expert=2 through Trainer(..., mesh=),
    each step against the one-device trainer's, every rank's metrics
    equal rank 0's, exact launches, E / 2 experts a rank.  Returns rank
    0's launches."""
    import torch
    from skypilot_tpu_torch.models.llama import init_params
    from skypilot_tpu_torch.parallel import group as group_lib

    n = EXPERT['expert']
    # The ranks start importing while the throwaway pairs probe gloo.
    pool = group_lib.RankPool(n, 'gloo', timeout_s=600)
    try:
        t0 = time.perf_counter()
        probe = p2p_probe()
        log(f'  (a) gloo all_to_all_single straight on CUDA tensors, 2 '
            f'throwaway ranks on cuda:0 ({time.perf_counter() - t0:.1f} s): '
            + '; '.join(f'{k}: {v}' for k, v in probe.items()))
        needed = [f'{d} all_to_all_single' for d in ('bfloat16', 'float32')]
        if any(probe[key] != 'ok' for key in needed):
            raise SystemExit(f'gloo refuses all_to_all_single on CUDA '
                             f'tensors, which the expert exchange hands it: '
                             f'{probe}')
        log('    the expert exchange hands gloo the CUDA tensors as they '
            'are')
        cfg, tokens = expert_case()
        t0 = time.perf_counter()
        params = init_params(cfg, device,
                             torch.Generator(device=device).manual_seed(SEED))
        refs = reference_steps(cfg, params, tokens, EXPERT)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f'  {EXPERT["model"]} x {cfg.n_experts} experts, {cfg.n_layers} '
            f'layers: {cfg.num_params() / 1e9:.3f}B params f32, remat '
            f'{cfg.remat}/{cfg.remat_policy!r}; one-device trainer (loss, '
            f'grad norm) of steps 1-{EXPERT["steps"]} at {EXPERT["batch"]} x '
            f'{EXPERT["seq"]}: {refs} in {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        ranks = pool.run(expert_rank, timeout_s=900)
        wall = time.perf_counter() - t0
    finally:
        pool.close()
    lead = ranks[0]
    rels = [(abs(lead['losses'][i] - want[0]) / abs(want[0]),
             abs(lead['norms'][i] - want[1]) / abs(want[1]))
            for i, want in enumerate(refs)]
    log(f'  expert={n}, fsdp=1 on {card} ({smi}), {wall:.1f} s: ' + '; '.join(
        f'step {i + 1} loss {lead["losses"][i]:.6f} vs one device '
        f'{want[0]:.6f} (rel {rels[i][0]:.2e}, gate {SHARDED_LOSS_RTOL}), '
        f'grad norm {lead["norms"][i]:.6f} vs {want[1]:.6f} (rel '
        f'{rels[i][1]:.2e}, gate {SHARDED_NORM_RTOL})'
        for i, want in enumerate(refs)))
    per_step = EXPERT['steps'] - 1
    expect = {'flash_attention_fwd': 2 * cfg.n_layers * per_step,
              'flash_attention_bwd_dq': cfg.n_layers * per_step,
              'flash_attention_bwd_dkv': cfg.n_layers * per_step}
    for r in ranks:
        log(f'    rank {r["rank"]}: experts {r["experts"]} of layer 0\'s '
            f'w_gate, {r["local_params_b"]:.3f}B params held, init '
            f'{r["init_s"]:.1f} s, step 1 {r["first_s"]:.2f} s, '
            f'{r["step_s"]:.2f} s per timed step (two ranks on one card '
            f'over gloo: a correctness run, not an expert-parallel rate), '
            f'peak {r["peak_gb"]:.2f} GB, launches {r["counts"]}')
        if r['counts'] != expect:
            raise SystemExit(f'expert rank {r["rank"]} launched '
                             f'{r["counts"]}, expected {expect}')
        if (r['losses'], r['norms']) != (lead['losses'], lead['norms']):
            raise SystemExit(f'expert rank {r["rank"]} reads other metrics '
                             f'than rank 0')
        if r['experts'] != (cfg.n_experts // n, cfg.dim, cfg.ffn_dim):
            raise SystemExit(f'rank {r["rank"]} holds experts '
                             f'{r["experts"]}')
    if not (all(map(math.isfinite, lead['losses'] + lead['norms'])) and
            all(a <= SHARDED_LOSS_RTOL and b <= SHARDED_NORM_RTOL
                for a, b in rels)):
        raise SystemExit(f'expert parallelism disagrees with the one-device '
                         f'trainer: {rels}')
    return lead['counts']


def moe_tensor_case():
    """(bf16 config, f32 config, prompts, padded prompts, last
    positions) of MOE_TENSOR, MOE_SERVE's traffic."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    spec = MOE_SERVE
    cfg = dataclasses.replace(LLAMA_CONFIGS[MOE_TENSOR['model']],
                              n_experts=MOE_TENSOR['n_experts'],
                              n_layers=MOE_TENSOR['n_layers'],
                              max_seq_len=spec['max_seq_len'],
                              param_dtype=torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, spec['prompt_len']).tolist()
               for _ in range(spec['n_prompts'])]
    prompts.append(rng.integers(0, cfg.vocab_size,
                                spec['long_prompt_len']).tolist())
    bucket = spec['prefill_buckets'][0]
    padded = [p + [0] * (bucket - len(p)) for p in prompts[:-1]]
    return cfg, cfg32, prompts, padded, [len(p) - 1 for p in prompts[:-1]]


def _moe_engine(model, mesh=None, device=None, **kw):
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    spec = MOE_SERVE
    return DecodeEngine(model, EngineConfig(
        n_slots=spec['n_slots'], steps_per_call=spec['steps_per_call'],
        prefill_buckets=spec['prefill_buckets'], mesh=mesh, **kw),
        device=device)


def moe_tp_rank():
    """One rank of MOE_TENSOR's gloo pair on cuda:0: (b) the bf16 model's
    first-step logits of the padded prompts (its slices of the SEED draw;
    launches zeroed just before, read just after); (c) the f32 model's
    dense and paged tokens of every prompt through the f32 kernels (the
    launches and prefill groups counted around both runs)."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    cfg, cfg32, prompts, padded, last = moe_tensor_case()
    t = MOE_TENSOR['tensor']
    mesh = build_serve_mesh(t, cfg.n_heads, cfg.n_kv_heads,
                            devices=[MOE_TENSOR['device']] * t,
                            backend='gloo')

    def build(c):
        gen = torch.Generator(device=mesh.device).manual_seed(SEED)
        return Llama(c, init_params(c, mesh.device, gen, mesh=mesh), mesh)

    model = build(cfg)
    out = {'rank': mesh.rank,
           'experts': tuple(model.layers[0].moe_mlp.w_down.shape)}
    zero_launches()
    with torch.no_grad():
        logits = model(torch.tensor(padded, device=mesh.device),
                       logits_at=torch.tensor(last, device=mesh.device))
    torch.cuda.synchronize()
    out['launches'] = read_launches()
    out['logits'] = logits[:, 0].cpu()
    del model, logits
    torch.cuda.empty_cache()
    model = build(cfg32)
    zero_launches()
    out['f32_groups'] = 0
    for name, kw in (('dense', {}),
                     ('paged', {'kv_page_size': MOE_SERVE['kv_page_size']})):
        e = _moe_engine(model, mesh, **kw)
        out[name], out[name + '_wall'] = _tp_traffic(
            e, prompts, MOE_SERVE['max_tokens'])
        out['f32_groups'] += e.prefill_groups
        del e
    out['f32_launches'] = read_route_launches()
    out['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _moe_halves_forward(module, t):
    """A forward for one device's MoEMLP with tensor=t's arithmetic: each
    expert's F in t slices, each slice's w_down product in the compute
    dtype, the slices added in that dtype in rank order."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.models import moe

    def forward(x, return_aux=False):
        del return_aux
        capacity = moe.capacity_of(x.shape[1], module.n_experts,
                                   module.top_k, module.capacity_factor)
        probs = torch.softmax(module.router(x), dim=-1)
        dispatch, combine = moe.top_k_dispatch(probs, module.top_k, capacity)
        dt = module.dtype
        expert_in = torch.einsum('bsec,bsd->ebcd', dispatch.to(dt), x.to(dt))
        k = module.w_gate.shape[2] // t
        acc = None
        for r in range(t):
            sl = slice(r * k, (r + 1) * k)
            h = (F.silu(torch.einsum('ebcd,edf->ebcf', expert_in,
                                     module.w_gate[..., sl].to(dt))) *
                 torch.einsum('ebcd,edf->ebcf', expert_in,
                              module.w_up[..., sl].to(dt)))
            part = torch.einsum('ebcf,efd->ebcd', h,
                                module.w_down[:, sl].to(dt))
            acc = part if acc is None else acc + part
        return torch.einsum('ebcd,bsec->bsd', acc,
                            combine.to(dt)).to(x.dtype)
    return forward


def moe_tensor_serving_phase(device, card):
    """MoE serving over tensor=2 (MOE_TENSOR), both gloo ranks on the
    card: (b) bf16 first-step logits bit-identical to one device
    computing the same arithmetic and within LOGITS_RTOL of the plain
    one-device model, n_layers flash launches on rank 0; (c) f32 greedy
    tokens of MOE_SERVE's traffic through the f32 kernels identical to
    the one-device engine's (also through them), dense and paged, on
    every rank, rank 0's launches exactly one f32 forward per layer and
    prefill group, and one device's f32 prefill logits within F32_LOGITS_RTOL
    of attention_impl='xla' on the same params.  Returns rank 0's
    launches."""
    import torch
    from skypilot_tpu_torch.models.llama import Llama, init_params
    from skypilot_tpu_torch.parallel import group as group_lib

    t = MOE_TENSOR['tensor']
    cfg, cfg32, prompts, padded, last = moe_tensor_case()
    pool = group_lib.RankPool(t, 'gloo', timeout_s=600)
    try:
        t0 = time.perf_counter()
        model = Llama(cfg, init_params(
            cfg, device, torch.Generator(device=device).manual_seed(SEED)))

        def first_logits():
            with torch.no_grad():
                return model(torch.tensor(padded, device=device),
                             logits_at=torch.tensor(last, device=device)
                             )[:, 0].cpu()

        want_logits = first_logits()
        patched = [m for layer in model.layers for m in (layer.attn.o_proj,
                                                         layer.moe_mlp)]
        for layer in model.layers:
            layer.attn.o_proj.forward = _halves_product(layer.attn.o_proj, t)
            layer.moe_mlp.forward = _moe_halves_forward(layer.moe_mlp, t)
        try:
            same_math_logits = first_logits()
        finally:
            for m in patched:
                del m.forward
        del model
        torch.cuda.empty_cache()
        params32 = init_params(
            cfg32, device, torch.Generator(device=device).manual_seed(SEED))
        model = Llama(cfg32, params32)
        f32_logits = first_logits()
        model = Llama(dataclasses.replace(cfg32, attention_impl='xla'),
                      params32)
        f32_xla_logits = first_logits()
        one = _moe_engine(Llama(cfg32, params32), device=device)
        one.prewarm()
        want_toks, _, _, _ = _drive(one, prompts, MOE_SERVE['max_tokens'])
        del one, model, params32
        gc.collect()
        torch.cuda.empty_cache()
        log(f'  {MOE_TENSOR["model"]} x {cfg.n_experts} experts at '
            f'{cfg.n_layers} of 16 layers ({cfg.num_params() / 1e9:.3f}B '
            f'params): one-device references in '
            f'{time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        ranks = pool.run(moe_tp_rank, timeout_s=900)
        wall = time.perf_counter() - t0
    finally:
        pool.close()
    lead = ranks[0]
    for r in ranks:
        log(f'    rank {r["rank"]}: experts {r["experts"]} of layer 0\'s '
            f'w_down, peak {r["peak_gb"]:.2f} GB')
        if r['experts'] != (cfg.n_experts, cfg.ffn_dim // t, cfg.dim):
            raise SystemExit(f'rank {r["rank"]} holds {r["experts"]}')
        for key in ('dense', 'paged'):
            if r[key] != lead[key]:
                raise SystemExit(f'rank {r["rank"]} emitted other {key} '
                                 f'tokens than rank 0')
    got = lead['logits']
    scale = want_logits.abs().max().item()
    err = (got - want_logits).abs().max().item() / scale
    err_same = (got - same_math_logits).abs().max().item() / scale
    out_toks = sum(map(len, lead['dense']))
    log(f'  (b) bf16 tensor={t} over gloo on {card}: first-step logits (max '
        f'|logit| {scale:.3f}) against one device computing the same '
        f'arithmetic: rel {err_same:.2e} (gate 0, bit-identical); against '
        f'the one-device model: rel {err:.2e} (gate {LOGITS_RTOL}); rank 0 '
        f'flash launches {lead["launches"]}')
    log(f'  (c) f32 tensor={t}: greedy tokens equal to the one-device '
        f'engine\'s: dense {_share_equal(lead["dense"], want_toks):.4f}, '
        f'paged {_share_equal(lead["paged"], want_toks):.4f}; out-tok/s '
        f'dense {out_toks / lead["dense_wall"]:.1f}, paged '
        f'{out_toks / lead["paged_wall"]:.1f} (eager, gloo staging: not a '
        f'tensor-parallel rate); {wall:.1f} s')
    if not (torch.isfinite(got).all() and torch.equal(got, same_math_logits)
            and err <= LOGITS_RTOL):
        raise SystemExit('MoE tensor=2 first-step logits disagree with one '
                         'device')
    if lead['launches'] != dict(dict.fromkeys(KERNEL_NAMES, 0),
                                flash_attention_fwd=cfg.n_layers):
        raise SystemExit(f'rank 0 launched {lead["launches"]}, expected '
                         f'{cfg.n_layers} flash forwards')
    if lead['dense'] != want_toks or lead['paged'] != want_toks:
        raise SystemExit('MoE f32 tensor=2 tokens differ from one device')
    f32_scale = f32_xla_logits.abs().max().item()
    f32_err = (f32_logits - f32_xla_logits).abs().max().item() / f32_scale
    f32_want = dict(dict.fromkeys(ROUTED + PADDED, 0),
                    flash_attention_fwd_f32=cfg.n_layers * lead['f32_groups'])
    log(f'  (c) f32 through the f32 kernels: rank 0 launches '
        f'{ {n: c for n, c in lead["f32_launches"].items() if c} } over '
        f'{lead["f32_groups"]} prefill groups; one device\'s prefill logits '
        f'against attention_impl=xla: rel {f32_err:.2e} of max |logit| '
        f'{f32_scale:.3f} (gate {F32_LOGITS_RTOL})')
    if lead['f32_launches'] != f32_want or lead['f32_groups'] < 1:
        raise SystemExit(f'MoE f32 tensor=2 rank 0 launched '
                         f'{lead["f32_launches"]}, expected {f32_want}')
    if not (torch.isfinite(f32_logits).all() and f32_err <= F32_LOGITS_RTOL):
        raise SystemExit('MoE f32 prefill logits through the kernel '
                         'disagree with attention_impl=xla')
    launches = dict(lead['launches'], **{
        name: lead['f32_launches'][name] for name in F32_KERNELS})
    return launches, kernel_times(
        device, MOE_TP_PREFILL_SHAPE, f'MoE tensor={t} per-rank prefill',
        ('fwd',))['fwd']


def perf_gate_phase(device, card):
    """The port's perf gate on the card (`python -m
    skypilot_tpu_torch.perf.gate`'s run): the fresh `tiny` serve probe
    on this card against the newest committed BENCH_*.json, every launch
    counter zeroed just before and read just after.  The report must be
    ok, with every ratio check a cross-host skip (the committed rounds
    are TPU runs of another model), the live MFU and bytes-per-token
    gauges (bf16 and int8 pages) within 5% of the cost model and one
    roofline row per prefill bucket; the probe's prefills (head_dim 16)
    must launch the small-head-dim forward and no wgmma kernel.  Returns
    (the wgmma kernels' launch counts, the small kernel's)."""
    import functools
    import torch
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.perf import gate
    from skypilot_tpu_torch.train import flops as flops_lib

    baseline, _ = gate.latest_bench(REPO)
    zero_launches()
    t0 = time.perf_counter()
    report = gate.run(baseline_path=baseline,
                      probe_fn=functools.partial(gate.probe_serve, device))
    torch.cuda.synchronize()
    counts, small = read_launches(), fa.flash_attention_fwd_small.launches
    for line in gate.render_report(report).splitlines():
        log(f'  {line}')
    log(f'  gate on {card} in {time.perf_counter() - t0:.1f} s: ok '
        f'{report["ok"]}; small-head-dim forward launches {small}, wgmma '
        f'kernels {counts}')
    by_name = {c['name']: c for c in report['checks']}
    ratio = [c for c in report['checks']
             if c['name'].startswith('tolerance:')]
    gauges = ('gauge-vs-bench-mfu', 'gauge-vs-bench-hbm-bytes-per-token',
              'gauge-vs-bench-hbm-bytes-per-token-int8')
    rows = [c for c in report['checks']
            if c['name'].startswith('roofline:bucket=')]
    if not (report['ok'] and ratio and
            all(c['status'] == 'skip' for c in ratio) and
            all(by_name[g]['status'] == 'ok' for g in gauges) and
            len(rows) == 2 and
            report['probe']['chip'] == flops_lib.chip_kind(device)):
        raise SystemExit(f'the perf gate failed on the card: '
                         f'{json.dumps(report["checks"])}')
    if small <= 0 or any(counts.values()):
        raise SystemExit(f'the gate\'s probe launched the small-head-dim '
                         f'forward {small} times and {counts}')
    return counts, small


# The launch path (LAUNCH): a cluster of the local cloud asking for one
# H100, launched through the port's execution.launch; job A serves the
# serving cell's prompt lengths on the engine API, job B is the port's
# HTTP server on the same cluster, both from the server's own flags:
# llama3-1b (examples/serve_llama.yaml:169) at full width and depth, bf16
# weights from seed 0.  Each request is served alone (one at a time) in
# every run, so job A, job B and the smoke's own engine see the same
# prefill and decode shapes and must give identical greedy tokens.
LAUNCH = dict(cluster='smoke-launch', accelerators='H100:1',
              flags=['--model', 'llama3-1b', '--param-dtype', 'bfloat16',
                     '--max-seq-len', '448', '--n-slots', '4', '--seed',
                     str(SEED)],
              prompt_lens=(219, 219, 219, 300), http_prompts=(0, 3),
              max_new=16, job_timeout_s=300, ready_timeout_s=300,
              release_timeout_s=60, mem_atol_bytes=1 << 30)
# Job A's run: the engine from the server's flags, the launch counters
# zeroed after prewarm(), each prompt served alone (a dead engine loop
# fails the job rather than leave it waiting); one JSON line out.
LAUNCH_JOB_A = """python - <<'PY'
import json
import os
import time

import torch

from skypilot_tpu_torch.device import device_of
from skypilot_tpu_torch.inference import server
from skypilot_tpu_torch.inference.engine import DecodeEngine
from skypilot_tpu_torch.ops.cuda import flash_attention as fa
from skypilot_tpu_torch.perf import compile_telemetry

names = ('flash_attention_fwd', 'flash_attention_bwd_dq',
         'flash_attention_bwd_dkv')
args = server.parse_args(json.loads(os.environ['ENGINE_FLAGS']))
model = server.build_model(args)
engine = DecodeEngine(model, server.engine_config(args),
                      device=device_of(model))
engine.prewarm()
for name in names:
    getattr(fa, name).launches = 0


def serve(prompt):
    req = engine.submit(prompt, int(os.environ['MAX_NEW']))
    while req.finished_at is None:
        if not engine.healthy:
            raise SystemExit(f'engine failed: {engine.error!r}')
        time.sleep(0.01)
    return req.tokens()


engine.start()
try:
    tokens = [serve(p) for p in json.loads(os.environ['PROMPTS'])]
finally:
    engine.stop()
print(json.dumps({
    'tokens': tokens,
    'launches': {name: getattr(fa, name).launches for name in names},
    'kernel_build': compile_telemetry.summary().get('kernel_build'),
    'build_dir': str(fa.BUILD_DIR),
    'device': torch.cuda.get_device_name(),
    'env': {k: v for k, v in sorted(os.environ.items())
            if k.startswith('SKYTPU_')}}))
PY"""


def launch_reference_tokens(flags, prompts, max_new):
    """Job A's serving code in this process: the same engine from the
    same flags, each prompt alone."""
    from skypilot_tpu_torch.device import device_of
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.inference.engine import DecodeEngine

    args = server.parse_args(flags)
    model = server.build_model(args)
    engine = DecodeEngine(model, server.engine_config(args),
                          device=device_of(model))
    engine.prewarm()
    engine.start()
    tokens = []
    try:
        for prompt in prompts:
            req = engine.submit(prompt, max_new)
            while req.finished_at is None:
                if not engine.healthy:
                    raise SystemExit(f'engine failed: {engine.error!r}')
                time.sleep(0.01)
            tokens.append(req.tokens())
    finally:
        engine.close()
    return tokens


def _pid_alive(pid) -> bool:
    """False once the process has exited (a zombie counts as exited)."""
    try:
        with open(f'/proc/{pid}/stat', encoding='utf-8') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except OSError:
        return False


def _cmdline(pid) -> str:
    """A process's command line, '' once it has gone."""
    try:
        with open(f'/proc/{pid}/cmdline', 'rb') as f:
            return f.read().replace(b'\0', b' ').decode(errors='replace')
    except OSError:
        return ''


def _pids_with_env(marker: str) -> list:
    """Every other process whose environment (as it was at its exec)
    holds `marker`."""
    pids = []
    for entry in os.listdir('/proc'):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f'/proc/{entry}/environ', 'rb') as f:
                if marker.encode() in f.read():
                    pids.append(int(entry))
        except OSError:
            continue
    return pids


def _kill_processes_with_env(marker: str) -> int:
    """SIGKILL every other process whose environment holds `marker`;
    returns how many.  The agent and its jobs inherit the phase's
    temporary HOME, so this stops whatever a failed check left running
    (`down` stops the agent, not its jobs)."""
    killed = 0
    for pid in _pids_with_env(marker):
        try:
            os.kill(pid, 9)
            killed += 1
        except OSError:
            continue
    return killed


def _job_record(core, cluster, job_id):
    return next(j for j in core.queue(cluster) if j['job_id'] == job_id)


def _wait_job_status(core, cluster, job_id, timeout_s, until):
    from skypilot_tpu_torch.agent.job_queue import JobStatus
    deadline = time.monotonic() + timeout_s
    while True:
        rec = _job_record(core, cluster, job_id)
        if until(JobStatus(rec['status'])):
            return rec
        if time.monotonic() > deadline:
            raise SystemExit(f'job {job_id} still {rec["status"]} after '
                             f'{timeout_s} s')
        time.sleep(0.5)


def _job_log(core, cluster, job_id) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        core.tail_logs(cluster, job_id, follow=False)
    return out.getvalue()


def _http_json(url, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


class PhaseHome:
    """A temporary HOME for a phase that launches clusters (their state
    DBs, the agents' homes and the jobs' logs live under it), with the
    port's config cache reset and `env` set on top; close() kills every
    process that inherited it, restores the environment and removes the
    directory."""

    def __init__(self, prefix: str, **env: str) -> None:
        import tempfile
        from skypilot_tpu_torch import sky_config
        self._state = tempfile.TemporaryDirectory(prefix=prefix)
        self.root = self._state.name
        home = os.path.join(self.root, 'home')
        os.makedirs(home)
        env = dict(
            env, HOME=home,
            SKYTPU_GLOBAL_CONFIG=os.path.join(home, '.skytpu', 'config.yaml'),
            SKYTPU_AGENT_PID_FILE=os.path.join(self.root, 'agent-pids.txt'))
        self._saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        sky_config.reset_cache_for_tests()

    def kill_processes(self) -> int:
        """SIGKILL every process the phase started (they inherited its
        HOME); returns how many."""
        return _kill_processes_with_env(self.root)

    def close(self) -> None:
        from skypilot_tpu_torch import sky_config
        stray = self.kill_processes()
        if stray:
            log(f'  killed {stray} process(es) left by the phase')
        for key, value in self._saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        sky_config.reset_cache_for_tests()
        self._state.cleanup()


def _wait_port_closed(port, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while True:
        with socket.socket() as sock:
            if sock.connect_ex(('127.0.0.1', port)) != 0:
                return
        if time.monotonic() > deadline:
            raise SystemExit(f'port {port} still open {what}')
        time.sleep(0.2)


def _wait_free_memory(free_before, timeout_s, atol):
    """Seconds until the card's free memory is back within `atol` bytes
    of `free_before` (a job's process releases it as it exits, which may
    be a little after its port closed and its cluster went); (seconds,
    free bytes)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout_s
    while True:
        free_after = torch.cuda.mem_get_info()[0]
        if free_after >= free_before - atol:
            return time.perf_counter() - t0, free_after
        if time.monotonic() > deadline:
            raise SystemExit(f'card memory free {free_after} bytes '
                             f'{timeout_s} s after the phase\'s clusters '
                             f'went, {free_before} before the phase')
        time.sleep(0.2)


# A managed job on a local cluster asking for H100:1, through the port's
# jobs controller: bench-1b (bench.py:58-115) at full width (dim 2048, 16
# query and 8 kv heads of 128, ffn 8192, vocab 32768) with its depth cut
# 14 -> 2 layers (a save is then ~193M params x 12 bytes, 2.3 GB, against
# ~11 GB whole), f32 params, bf16 compute, batch 2 x 4096 made from SEED
# and the step index, 20 steps through Trainer.run with a checkpoint every
# 5.  The first attempt's data blocks at step 10, after the checkpoint of
# step 10; the phase then kills the cluster's processes (its agent and the
# job, as a lost VM would) and marks its node preempted.  The recovered
# attempt restores step 10 and trains to step 20.
MANAGED_JOB = dict(model='bench-1b', n_layers=2, batch=2, seq=4096, steps=20,
                   checkpoint_every=5, preempt_at=10, warmup_steps=5,
                   total_steps=1000, accelerators='H100:1', poll_s=0.5,
                   block_s=600, timeout_s=600, release_timeout_s=60,
                   mem_atol_bytes=1 << 30)
# The recovered attempt's losses at steps 11-20 against an uninterrupted
# 20-step run in this process, relative: the same kernels on the same
# state and batches, so only a restore that lost or changed state moves
# them.
MANAGED_LOSS_RTOL = 1e-3
# The job's `run`: one attempt (managed_job_attempt) in a new process;
# the agent puts the checkout on the job's PYTHONPATH.
MANAGED_JOB_RUN = ('python -c "import chip_smoke; '
                   'chip_smoke.managed_job_attempt()"')


def managed_trainer(spec, device, checkpoint_dir=None):
    """The managed job's model (`spec`'s, its depth cut) from SEED and its
    Trainer; (trainer, cfg)."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(LLAMA_CONFIGS[spec['model']],
                              n_layers=spec['n_layers'])
    model = Llama(cfg, init_params(
        cfg, device, torch.Generator(device=device).manual_seed(SEED)))
    trainer = Trainer(model, TrainConfig(warmup_steps=spec['warmup_steps'],
                                         total_steps=spec['total_steps']),
                      checkpoint_dir=checkpoint_dir, device=device)
    return trainer, cfg


def managed_steps(trainer, cfg, spec, device, start, block_at=None):
    """Steps `start` .. spec['steps'] - 1 through Trainer.run (a checkpoint
    every spec['checkpoint_every'] when the trainer has a directory),
    each step's batch made from SEED and its index; at step `block_at`
    the data waits (up to spec['block_s'], then the attempt fails) for
    the preemption that kills it.  Returns each step's loss."""
    import torch
    losses = []
    train_step = trainer.train_step

    def recording_step(state, tokens):
        state, metrics = train_step(state, tokens)
        losses.append(metrics['loss'])
        return state, metrics

    def batches():
        for step in range(start, spec['steps']):
            if step == block_at:
                print(f'blocking at step {step}', flush=True)
                time.sleep(spec['block_s'])
                raise SystemExit(f'not preempted at step {step} within '
                                 f'{spec["block_s"]} s')
            yield torch.randint(
                0, cfg.vocab_size, (spec['batch'], spec['seq']),
                device=device, generator=torch.Generator(
                    device=device).manual_seed(SEED + 1000 + step))

    n = spec['steps'] - start
    trainer.train_step = recording_step
    try:
        trainer.run(batches(), n, checkpoint_every=spec['checkpoint_every'],
                    log_every=n)
    finally:
        trainer.train_step = train_step
    return [float(x) for x in losses]


def managed_job_attempt() -> None:
    """One attempt of the managed job (MANAGED_JOB_RUN), its spec in
    MANAGED_JOB_SPEC: the trainer restores the newest checkpoint if
    there is one, the launch counters are zeroed, and the remaining steps
    run (a first attempt blocks at spec['preempt_at']); one JSON line
    out: the step restored, each step's loss, the launches."""
    import torch
    from skypilot_tpu_torch.obs import goodput as goodput_lib

    spec = json.loads(os.environ['MANAGED_JOB_SPEC'])
    # The controller keys the job's downtime by its managed job id, and the
    # job's cluster is named jobs-<id>-<name>: the trainer's phases go to
    # the same key of the same ledger.
    os.environ[goodput_lib.JOB_ENV] = re.match(
        r'jobs-(\d+)-', os.environ['SKYTPU_CLUSTER_NAME']).group(1)
    device = torch.device(spec['device'])
    if device.type == 'cpu':
        torch.set_num_threads(1)
    trainer, cfg = managed_trainer(spec, device, spec['ckpt_dir'])
    restored = trainer.restore_if_available()
    zero_launches()
    losses = managed_steps(trainer, cfg, spec, device, restored,
                           None if restored else spec['preempt_at'])
    print(json.dumps({'managed_job': {
        'restored': restored, 'losses': losses,
        'launches': read_launches(),
        'device': (torch.cuda.get_device_name() if device.type == 'cuda'
                   else 'cpu')}}), flush=True)


class StatusWatch:
    """Every status a managed job passes through, in order (polled from
    the jobs DB every 20 ms on a thread of its own, and read once more
    when the watch stops, so a status reached between the thread's last
    poll and stop() is not lost)."""

    def __init__(self, job_id) -> None:
        import threading
        self.seen = []
        self._job_id = job_id
        self._stop = threading.Event()

        def poll():
            while not self._stop.is_set():
                if self._record():
                    return
                time.sleep(0.02)

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()

    def _record(self) -> bool:
        """Appends the job's status if it changed; True once terminal."""
        from skypilot_tpu_torch.jobs import state as jobs_state
        rec = jobs_state.get(self._job_id)
        if rec is None:
            return False
        if not self.seen or self.seen[-1] != rec['status']:
            self.seen.append(rec['status'])
        return rec['status'].is_terminal()

    def stop(self) -> list:
        self._stop.set()
        self._thread.join()
        self._record()
        return [s.value for s in self.seen]


def managed_job_phase(device, card, smi):
    """MANAGED_JOB through the port's managed jobs on the card: launch,
    a preemption after the checkpoint of step preempt_at, recovery and
    success; the recovered attempt's restored step, losses and launches,
    the goodput ledger's rows for the job, `jobs top`'s frame, the
    cluster gone and the card's memory back.  Returns the recovered
    attempt's launch counts."""
    import torch
    from skypilot_tpu_torch import global_user_state, jobs
    from skypilot_tpu_torch.jobs import controller as jobs_controller
    from skypilot_tpu_torch.jobs import state as jobs_state
    from skypilot_tpu_torch.obs import goodput as goodput_lib
    from skypilot_tpu_torch.obs import jobs_top
    from skypilot_tpu_torch.provision.local import instance as local_instance
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.task import Task

    spec = dict(MANAGED_JOB)
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    home = PhaseHome('skytpu-managed-',
                     SKYTPU_JOBS_POLL_INTERVAL=str(spec['poll_s']))
    t_phase = time.perf_counter()
    try:
        spec.update(device=str(device),
                    ckpt_dir=os.path.join(home.root, 'ckpt'))
        task = Task('smoke-train', run=MANAGED_JOB_RUN,
                    envs={'MANAGED_JOB_SPEC': json.dumps(spec)})
        task.set_resources(Resources.from_yaml_config(
            {'infra': 'local', 'accelerators': spec['accelerators']}))
        t0 = time.perf_counter()
        job_id = jobs.launch(task)
        watch = StatusWatch(job_id)
        blocked = os.path.join(spec['ckpt_dir'], f'step_{spec["preempt_at"]}')
        deadline = time.monotonic() + spec['timeout_s']
        while not os.path.isdir(blocked):
            rec = jobs_state.get(job_id)
            if rec['status'].is_terminal() or time.monotonic() > deadline:
                raise SystemExit(f'managed job {job_id} {rec["status"]} '
                                 f'without {blocked}: {watch.stop()}')
            time.sleep(0.1)
        first_s = time.perf_counter() - t0
        cluster = jobs_state.get(job_id)['cluster_name']
        # The node is lost: its agent and the job die with it (the local
        # provisioner's terminate kills no process), then the cloud
        # reports the node preempted.
        killed = home.kill_processes()
        t0 = time.perf_counter()
        local_instance.inject_preemption(cluster)
        final = jobs_controller.wait_job(job_id, spec['timeout_s'])
        recover_s = time.perf_counter() - t0
        statuses = watch.stop()
        rec = jobs_state.get(job_id)
        buf = io.StringIO()
        jobs.tail_logs(job_id, follow=False, out=buf)
        text = buf.getvalue()
        if final.value != 'SUCCEEDED' or rec['recovery_count'] != 1:
            raise SystemExit(f'managed job {job_id} ended {final.value}, '
                             f'recoveries {rec["recovery_count"]}, statuses '
                             f'{statuses}:\n{text[-4000:]}')
        want_seen = ['RUNNING', 'RECOVERING', 'RUNNING', 'SUCCEEDED']
        if statuses[-4:] != want_seen:
            raise SystemExit(f'managed job statuses {statuses}, want them '
                             f'to end {want_seen}')
        lines = [json.loads(line)['managed_job'] for line in
                 text.splitlines() if line.startswith('{"managed_job"')]
        if len(lines) != 1:
            raise SystemExit(f'the recovered attempt printed {len(lines)} '
                             f'result lines:\n{text[-4000:]}')
        out = lines[0]
        log(f'  job {job_id} on {cluster}: first attempt to the checkpoint '
            f'of step {spec["preempt_at"]} {first_s:.2f} s; killed '
            f'{killed} process(es) of the cluster, node marked preempted; '
            f'to SUCCEEDED {recover_s:.2f} s; statuses {statuses}, '
            f'recoveries {rec["recovery_count"]}; the recovered attempt on '
            f'{out["device"]} restored step {out["restored"]}, launches '
            f'{out["launches"]}')
        if out['restored'] != spec['preempt_at']:
            raise SystemExit(f'the recovered attempt restored step '
                             f'{out["restored"]}, not {spec["preempt_at"]}')
        if out['device'] != card:
            raise SystemExit(f'the job ran on {out["device"]}, not {card}')
        if global_user_state.get_cluster(cluster) is not None:
            raise SystemExit(f'cluster {cluster} survived SUCCEEDED')
        # The ledger the controller (this process) and the trainer (the
        # job's) share: ~/.skytpu/managed_jobs.db under the phase's HOME.
        ledger = goodput_lib.GoodputLedger()
        totals = ledger.totals(str(job_id))
        need = (goodput_lib.PRODUCTIVE, goodput_lib.CHECKPOINT_SAVE,
                goodput_lib.CHECKPOINT_RESTORE,
                goodput_lib.PREEMPTION_DOWNTIME,
                goodput_lib.RECOVERY_RELAUNCH)
        down = ledger.intervals(str(job_id), goodput_lib.PREEMPTION_DOWNTIME)
        relaunch = ledger.intervals(str(job_id),
                                    goodput_lib.RECOVERY_RELAUNCH)
        log(f'  goodput ledger of job {job_id} ({ledger.dsn}): '
            f'{ {c: round(v, 3) for c, v in sorted(totals.items())} }; '
            f'downtime {down}, relaunch {relaunch}')
        if not all(totals.get(c, 0.0) > 0 for c in need) or \
                len(down) != 1 or len(relaunch) != 1 or \
                abs(down[0]['t1'] - relaunch[0]['t0']) > 1e-6:
            raise SystemExit(f'the ledger misses the recovery: {totals}, '
                             f'{down}, {relaunch}')
        frame = jobs_top.render(jobs_top.snapshot(str(job_id),
                                                  job_rec=rec))
        log('  jobs top: ' + frame.replace('\n', '\n    '))
        if 'recoveries 1' not in frame.splitlines()[0]:
            raise SystemExit(f'jobs top shows no recovery:\n{frame}')
        release_s, free_after = _wait_free_memory(
            free_before, spec['release_timeout_s'], spec['mem_atol_bytes'])
        log(f'  free card memory {free_before} bytes before, {free_after} '
            f'{release_s:.2f} s after SUCCEEDED')
        phase_s = time.perf_counter() - t_phase
    finally:
        jobs_controller.stop_all_controllers()
        home.close()

    t0 = time.perf_counter()
    trainer, cfg = managed_trainer(spec, device)
    want = managed_steps(trainer, cfg, spec, device, 0)[spec['preempt_at']:]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    got = out['losses']
    worst = max((abs(a - b) / abs(b) for a, b in zip(got, want)),
                default=math.inf)
    log(f'  an uninterrupted {spec["steps"]}-step run in this process '
        f'({time.perf_counter() - t0:.2f} s): losses at steps '
        f'{spec["preempt_at"] + 1}-{spec["steps"]} {want}; the recovered '
        f'attempt\'s {got}; largest relative difference {worst:.3e}')
    if len(got) != len(want) or not worst <= MANAGED_LOSS_RTOL:
        raise SystemExit(f'the recovered attempt\'s losses {got} differ from '
                         f'the uninterrupted run\'s {want}')
    steps = spec['steps'] - spec['preempt_at']
    forwards = 2 if cfg.remat else 1
    expect = {'flash_attention_fwd': forwards * cfg.n_layers * steps,
              'flash_attention_bwd_dq': cfg.n_layers * steps,
              'flash_attention_bwd_dkv': cfg.n_layers * steps}
    if device.type == 'cuda' and out['launches'] != expect:
        raise SystemExit(f'the recovered attempt launched {out["launches"]}, '
                         f'expected {expect} ({steps} steps of '
                         f'{cfg.n_layers} layers)')
    log(f'  launch to SUCCEEDED {phase_s:.2f} s on {smi}')
    return out['launches']


# SkyServe on the card: one local replica asking for H100:1 behind the
# port's load balancer, the replica the port's HTTP app over LAUNCH's
# engine (llama3-1b whole, bf16 from SEED), LAUNCH's HTTP prompts sent
# through the LB one at a time.
SERVE_SERVICE = dict(name='smoke-serve', accelerators='H100:1', tick_s=0.5,
                     ready_timeout_s=300, shutdown_timeout_s=120,
                     release_timeout_s=60, mem_atol_bytes=1 << 30)
SERVE_REPLICA_RUN = ('python -c "import chip_smoke; '
                     'chip_smoke.serve_replica()"')


def serve_replica() -> None:
    """The serve phase's replica (SERVE_REPLICA_RUN): the engine from
    ENGINE_FLAGS exactly as `python -m skypilot_tpu_torch.inference.server`
    builds it, its launch counters zeroed after prewarm(), the server's
    app on the port the replica manager gives; the counters printed (one
    JSON line) whenever they change."""
    import threading

    from aiohttp import web
    from skypilot_tpu_torch.device import device_of
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.inference.engine import DecodeEngine

    args = server.parse_args(json.loads(os.environ['ENGINE_FLAGS']) + [
        '--port', os.environ['SKYTPU_SERVE_REPLICA_PORT']])
    model = server.build_model(args)
    engine = DecodeEngine(model, server.engine_config(args),
                          device=device_of(model))
    engine.prewarm()
    zero_launches()
    engine.start()

    def report():
        last = None
        while True:
            now = read_launches()
            if now != last:
                print(json.dumps({'replica_launches': now}), flush=True)
                last = now
            time.sleep(0.2)

    threading.Thread(target=report, daemon=True).start()
    try:
        web.run_app(server.build_app(engine), port=args.port, print=None)
    finally:
        engine.close()


def serve_phase(device, card, smi, launch_ctx):
    """SERVE_SERVICE through the port's SkyServe on the card: serve.up,
    the replica READY, LAUNCH's HTTP prompts through the load balancer
    (ids and usage equal to job A's, the LB's trace of each request), the
    replica's launches from its log, serve.down (the replica's cluster
    gone, the LB's port closed) and the card's memory back.  Returns the
    replica's launch counts over the requests."""
    import urllib.error

    import torch
    from skypilot_tpu_torch import global_user_state, serve
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.serve import controller as serve_controller
    from skypilot_tpu_torch.serve import serve_state
    from skypilot_tpu_torch.server import tracing
    from skypilot_tpu_torch.task import Task

    spec = SERVE_SERVICE
    name, max_new = spec['name'], LAUNCH['max_new']
    prompts, tokens = launch_ctx['prompts'], launch_ctx['tokens']
    args = server.parse_args(LAUNCH['flags'])
    cfg = server.model_config(args)
    # Prompts beyond the largest bucket the engine keeps (those within
    # max_seq_len) are chunked through the decode path, not the kernel.
    largest = max((b for b in server.engine_config(args).prefill_buckets
                   if b <= cfg.max_seq_len), default=cfg.max_seq_len)
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    home = PhaseHome('skytpu-serve-',
                     SKYTPU_SERVE_TICK_INTERVAL=str(spec['tick_s']))
    t_phase = time.perf_counter()
    try:
        task = Task(name, run=SERVE_REPLICA_RUN,
                    envs={'ENGINE_FLAGS': json.dumps(LAUNCH['flags'])},
                    service={'readiness_probe': {
                        'path': '/health',
                        'initial_delay_seconds': spec['ready_timeout_s']},
                             'replicas': 1})
        task.set_resources(Resources.from_yaml_config(
            {'infra': 'local', 'accelerators': spec['accelerators']}))
        t0 = time.perf_counter()
        endpoint = serve.up(task)['endpoint']
        deadline = time.monotonic() + spec['ready_timeout_s']
        while True:
            replicas = serve_state.get_replicas(name, include_terminal=True)
            if any(r['status'].value == 'READY' for r in replicas):
                break
            if any(r['status'].is_terminal() for r in replicas) or \
                    time.monotonic() > deadline:
                states = [(r['replica_id'], r['status'].value)
                          for r in replicas]
                raise SystemExit(f'no READY replica: {states}')
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        replica = replicas[0]
        served = []
        for i in LAUNCH['http_prompts']:
            rid = f'smoke-serve-{i}'
            req = urllib.request.Request(
                endpoint + '/v1/completions',
                data=json.dumps({'prompt_ids': prompts[i],
                                 'max_tokens': max_new}).encode(),
                headers={'Content-Type': 'application/json',
                         tracing.TRACE_HEADER: rid})
            with urllib.request.urlopen(req, timeout=120) as resp:
                status, body = resp.status, json.loads(resp.read())
            usage = body.get('usage', {})
            if (status, body.get('ids')) != (200, tokens[i]) or (
                    usage.get('prompt_tokens'),
                    usage.get('completion_tokens')) != (len(prompts[i]),
                                                        max_new):
                raise SystemExit(f'prompt {i} through the LB: {status} '
                                 f'{body}, want job A\'s {tokens[i]}')
            _, trace = _http_json(endpoint + f'/debug/requests/{rid}')
            names = [e['name'] for e in trace['events']]
            if not {'lb.admission', 'lb.route'} <= set(names):
                raise SystemExit(f'the LB\'s trace of {rid}: {names}')
            served.append(i)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.tail_replica_logs(name, replica['replica_id'])
        reports = [json.loads(line)['replica_launches']
                   for line in buf.getvalue().splitlines()
                   if line.startswith('{"replica_launches"')]
        counts = reports[-1] if reports else {}
        expect = dict.fromkeys(KERNEL_NAMES, 0)
        expect['flash_attention_fwd'] = cfg.n_layers * sum(
            len(prompts[i]) <= largest for i in served)
        log(f'  service {name} up {ready_s:.2f} s to a READY replica '
            f'({replica["cluster_name"]}, {replica["url"]}); prompts '
            f'{served} through {endpoint} one at a time: ids equal to job '
            f'A\'s, usage right, the LB\'s trace holds lb.admission and '
            f'lb.route; the replica\'s launches {counts} (expected '
            f'{expect}: {cfg.n_layers} layers a prompt within the {largest} '
            f'bucket)')
        if device.type == 'cuda' and counts != expect:
            raise SystemExit(f'the replica launched {counts}, expected '
                             f'{expect}:\n{buf.getvalue()[-4000:]}')
        t0 = time.perf_counter()
        serve.down(name)
        serve_controller.wait_service_status(
            name, (serve_state.ServiceStatus.SHUTDOWN,),
            spec['shutdown_timeout_s'])
        down_s = time.perf_counter() - t0
        if global_user_state.get_cluster(replica['cluster_name']) is not None:
            raise SystemExit(f'replica cluster {replica["cluster_name"]} '
                             f'survived serve.down')
        port = int(endpoint.rsplit(':', 1)[1])
        _wait_port_closed(port, 30, 'after serve.down')
        # serve.down stops the replica's agent, not its job (as core.down
        # does): the replica's server is still running.
        left = home.kill_processes()
        release_s, free_after = _wait_free_memory(
            free_before, spec['release_timeout_s'], spec['mem_atol_bytes'])
        log(f'  serve.down to SHUTDOWN {down_s:.2f} s: replica cluster '
            f'gone, LB port {port} closed; {left} process(es) of the '
            f'replica left running, killed; free card memory '
            f'{free_before} bytes before, {free_after} {release_s:.2f} s '
            f'after')
        log(f'  serve.up to down {time.perf_counter() - t_phase:.2f} s on '
            f'{smi}')
    finally:
        serve_controller.stop_all_controllers()
        home.close()
    return counts


def launch_phase(device, card, smi):
    """LAUNCH through the port's launch path on the card; returns job
    A's kernel launch counts (its process zeroes them after prewarm) and
    its prompts and tokens."""
    import urllib.error

    import numpy as np
    import torch
    from skypilot_tpu_torch import core, execution, global_user_state
    from skypilot_tpu_torch.agent.job_queue import JobStatus
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.task import Task

    cluster, max_new = LAUNCH['cluster'], LAUNCH['max_new']
    vocab = server.model_config(
        server.parse_args(LAUNCH['flags'])).vocab_size
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in LAUNCH['prompt_lens']]
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    home = PhaseHome('skytpu-launch-')
    t_phase = time.perf_counter()
    try:
        task = Task('smoke-job-a', run=LAUNCH_JOB_A, envs={
            'ENGINE_FLAGS': json.dumps(LAUNCH['flags']),
            'PROMPTS': json.dumps(prompts), 'MAX_NEW': str(max_new)})
        task.set_resources(Resources.from_yaml_config(
            {'infra': 'local', 'accelerators': LAUNCH['accelerators']}))
        t0 = time.perf_counter()
        job_a, handle = execution.launch(task, cluster, detach_run=True,
                                         quiet_optimizer=True)
        launch_s = time.perf_counter() - t0
        agent_pid = handle.extras['agent_pid']
        log(f'  launch (optimize, provision, agent bootstrap, submit) '
            f'{launch_s:.2f} s: {handle.launched_resources()}, agent pid '
            f'{agent_pid}')
        rec = _wait_job_status(core, cluster, job_a, LAUNCH['job_timeout_s'],
                               JobStatus.is_terminal)
        text = _job_log(core, cluster, job_a)
        if JobStatus(rec['status']) is not JobStatus.SUCCEEDED:
            raise SystemExit(f'job A ended {rec["status"]}:\n{text[-4000:]}')
        job_a_s = rec['ended_at'] - rec['started_at']
        lines = [line for line in text.splitlines()
                 if line.startswith('{"tokens"')]
        if len(lines) != 1:
            raise SystemExit(f'job A printed {len(lines)} result lines:\n'
                             f'{text[-4000:]}')
        out = json.loads(lines[0])
        env = out['env']
        log(f'  job A {rec["status"]} in {job_a_s:.2f} s on '
            f'{out["device"]}: launches {out["launches"]}, SKYTPU_* '
            f'{ {k: v for k, v in env.items() if k != "SKYTPU_NODE_IPS"} }')
        want_env = {'SKYTPU_NODE_RANK': '0', 'SKYTPU_NUM_NODES': '1',
                    'SKYTPU_NUM_TPU_CHIPS': '1'}
        if {k: env.get(k) for k in want_env} != want_env:
            raise SystemExit(f'job A saw {env}, want {want_env}')
        if out['device'] != card:
            raise SystemExit(f'job A ran on {out["device"]}, not {card}')
        if out['launches']['flash_attention_fwd'] <= 0:
            raise SystemExit(f'job A launched no flash forward: '
                             f'{out["launches"]}')
        tokens = out['tokens']
        if [len(t) for t in tokens] != [max_new] * len(prompts) or not all(
                0 <= i < vocab for t in tokens for i in t):
            raise SystemExit(f'job A tokens malformed: {tokens}')

        port = _free_port()
        server_task = Task('smoke-job-b', envs={'SERVE_PORT': str(port)},
                           run=('python -m skypilot_tpu_torch.inference.'
                                'server ' + ' '.join(LAUNCH['flags']) +
                                ' --port $SERVE_PORT'))
        t0 = time.perf_counter()
        job_b, _ = execution.exec_(server_task, cluster, detach_run=True)
        base = f'http://127.0.0.1:{port}'
        deadline = time.monotonic() + LAUNCH['ready_timeout_s']
        while True:
            try:
                if _http_json(base + '/health', timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            rec = _job_record(core, cluster, job_b)
            if JobStatus(rec['status']).is_terminal():
                raise SystemExit(
                    f'job B ended {rec["status"]} before /health:\n'
                    f'{_job_log(core, cluster, job_b)[-4000:]}')
            if time.monotonic() > deadline:
                raise SystemExit(f'job B not healthy after '
                                 f'{LAUNCH["ready_timeout_s"]} s')
            time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        for i in LAUNCH['http_prompts']:
            status, body = _http_json(base + '/v1/completions', {
                'prompt_ids': prompts[i], 'max_tokens': max_new})
            usage = body.get('usage', {})
            if (status, body.get('ids')) != (200, tokens[i]) or (
                    usage.get('prompt_tokens'),
                    usage.get('completion_tokens')) != (len(prompts[i]),
                                                        max_new):
                raise SystemExit(f'job B prompt {i}: {status} {body}, want '
                                 f'job A\'s {tokens[i]}')
        log(f'  job B (HTTP server) ready in {ready_s:.2f} s on :{port}; '
            f'prompts {list(LAUNCH["http_prompts"])} one at a time: ids '
            f'equal to job A\'s, usage {len(prompts[0])}/{max_new}')
        if not core.cancel(cluster, job_b):
            raise SystemExit('cancel of job B refused')
        rec = _wait_job_status(core, cluster, job_b, 60,
                               JobStatus.is_terminal)
        if JobStatus(rec['status']) is not JobStatus.CANCELLED:
            raise SystemExit(f'job B ended {rec["status"]}, not CANCELLED')
        _wait_port_closed(port, 30, 'after cancel')
        t0 = time.perf_counter()
        core.down(cluster)
        down_s = time.perf_counter() - t0
        if global_user_state.get_cluster(cluster) is not None:
            raise SystemExit('cluster record survived down')
        deadline = time.monotonic() + 30
        while _pid_alive(agent_pid):
            if time.monotonic() > deadline:
                raise SystemExit(f'agent {agent_pid} alive after down')
            time.sleep(0.2)
        release_s, free_after = _wait_free_memory(
            free_before, LAUNCH['release_timeout_s'], LAUNCH['mem_atol_bytes'])
        log(f'  job B CANCELLED, port closed; down {down_s:.2f} s: record '
            f'gone, agent exited; free card memory {free_before} bytes '
            f'before, {free_after} {release_s:.2f} s after down')
        phase_s = time.perf_counter() - t_phase
    finally:
        if global_user_state.get_cluster(cluster) is not None:
            # A failed check leaves no job running: cancel SIGTERMs each
            # job's process group before down stops the agent.
            for job in core.queue(cluster):
                if not JobStatus(job['status']).is_terminal():
                    core.cancel(cluster, job['job_id'])
            core.down(cluster)
        home.close()

    t0 = time.perf_counter()
    want = launch_reference_tokens(LAUNCH['flags'], prompts, max_new)
    gc.collect()
    torch.cuda.empty_cache()
    if want != tokens:
        raise SystemExit(f'job A tokens {tokens} differ from this '
                         f'process\'s engine: {want}')
    log(f'  this process\'s engine on the same flags and prompts '
        f'({time.perf_counter() - t0:.2f} s): tokens identical to job A\'s')
    log(f'  launch to down {phase_s:.2f} s (launch {launch_s:.2f}, job A '
        f'{job_a_s:.2f}, job B to ready {ready_s:.2f}, down {down_s:.2f}) '
        f'on {smi}')
    return ({name: out['launches'].get(name, 0) for name in KERNEL_NAMES},
            {'prompts': prompts, 'tokens': tokens})


# The launch phase's job A again, launched over REST: the port's API
# server as its own process, the client the port's SDK and CLI.  Job A
# makes 3 chunk groups x 16 layers of flash forward launches (the 300-id
# prompt beyond the largest bucket) and no backward.
API_SERVER = dict(cluster='smoke-api', fwd_launches=48, start_timeout_s=120,
                  request_timeout_s=300, stop_timeout_s=60,
                  marker='SKYTPU_SMOKE_API_SERVER')


def api_server_phase(device, card, smi, launch_ctx, launch_counts):
    """LAUNCH's job A through the port's API server: the server started as
    a process, the job launched, polled, read and brought down over REST
    by the port's SDK, the cluster listed by the port's CLI; returns job
    A's launch counts in this run."""
    import torch
    from skypilot_tpu_torch.agent.job_queue import JobStatus
    from skypilot_tpu_torch.client import sdk
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.task import Task

    spec = API_SERVER
    cluster, prompts = spec['cluster'], launch_ctx['prompts']
    del device
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    marker = f'{spec["marker"]}={os.getpid()}'
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    home = PhaseHome('skytpu-api-', SKYTPU_API_SERVER=url,
                     **dict([marker.split('=', 1)]))
    proc = None
    t_phase = time.perf_counter()
    try:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'skypilot_tpu_torch.server.app',
             '--port', str(port)], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))
        t0 = time.perf_counter()
        deadline = time.monotonic() + spec['start_timeout_s']
        while sdk.api_info(timeout=2.0) is None:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise SystemExit(f'API server on :{port} not healthy '
                                 f'(exit {proc.poll()})')
            time.sleep(0.2)
        start_s = time.perf_counter() - t0
        task = Task('smoke-job-a', run=LAUNCH_JOB_A, envs={
            'ENGINE_FLAGS': json.dumps(LAUNCH['flags']),
            'PROMPTS': json.dumps(prompts),
            'MAX_NEW': str(LAUNCH['max_new'])})
        task.set_resources(Resources.from_yaml_config(
            {'infra': 'local', 'accelerators': LAUNCH['accelerators']}))
        t0 = time.perf_counter()
        request_id = sdk.launch(task, cluster)
        result = sdk.get(request_id, timeout_s=spec['request_timeout_s'])
        launch_s = time.perf_counter() - t0
        job_id = result['job_id']
        deadline = time.monotonic() + LAUNCH['job_timeout_s']
        while True:
            rec = next(j for j in sdk.queue(cluster)
                       if j['job_id'] == job_id)
            if JobStatus(rec['status']).is_terminal():
                break
            if time.monotonic() > deadline:
                raise SystemExit(f'job {job_id} still {rec["status"]} '
                                 f'after {LAUNCH["job_timeout_s"]} s')
            time.sleep(0.5)
        text = io.StringIO()
        sdk.tail_logs(cluster, job_id, follow=False, out=text)
        text = text.getvalue()
        if rec['status'] != 'SUCCEEDED':
            raise SystemExit(f'job A over REST ended {rec["status"]}:\n'
                             f'{text[-4000:]}')
        job_s = rec['ended_at'] - rec['started_at']
        lines = [line for line in text.splitlines()
                 if line.startswith('{"tokens"')]
        if len(lines) != 1:
            raise SystemExit(f'job A over REST printed {len(lines)} result '
                             f'lines:\n{text[-4000:]}')
        out = json.loads(lines[0])
        counts = {name: out['launches'].get(name, 0)
                  for name in KERNEL_NAMES}
        log(f'  server healthy in {start_s:.2f} s; launch request -> job '
            f'{job_id} {launch_s:.2f} s; job A SUCCEEDED in {job_s:.2f} s on '
            f'{out["device"]}: launches {counts}')
        if out['device'] != card:
            raise SystemExit(f'job A ran on {out["device"]}, not {card}')
        if out['tokens'] != launch_ctx['tokens']:
            raise SystemExit(f'job A over REST gave {out["tokens"]}, the '
                             f'launch phase {launch_ctx["tokens"]}')
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want['flash_attention_fwd'] = spec['fwd_launches']
        if counts != want or counts != launch_counts:
            raise SystemExit(f'job A over REST launched {counts}, want '
                             f'{want} (the launch phase: {launch_counts})')
        cli = subprocess.run(
            [sys.executable, '-m', 'skypilot_tpu_torch.client.cli',
             'status'], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=120)
        row = [line for line in cli.stdout.splitlines()
               if line.split()[:1] == [cluster]]
        if cli.returncode != 0 or len(row) != 1 or 'UP' not in row[0]:
            raise SystemExit(f'skytpu-torch status (rc {cli.returncode}):\n'
                             f'{cli.stdout}{cli.stderr}')
        log(f'  skytpu-torch status: {" ".join(row[0].split())}')
        t0 = time.perf_counter()
        sdk.get(sdk.down(cluster), timeout_s=spec['request_timeout_s'])
        down_s = time.perf_counter() - t0
        if any(c['name'] == cluster for c in sdk.status()):
            raise SystemExit(f'{cluster} listed after sdk.down')
        release_s, free_after = _wait_free_memory(
            free_before, LAUNCH['release_timeout_s'], LAUNCH['mem_atol_bytes'])
        proc.terminate()
        proc.wait(timeout=spec['stop_timeout_s'])
        _wait_port_closed(port, 30, 'after the server\'s SIGTERM')
        # The cluster's agent got its SIGTERM from `down` and may still be
        # closing its connections: every marked process must be gone
        # within the deadline.
        deadline = time.monotonic() + spec['stop_timeout_s']
        while True:
            left = _pids_with_env(marker)
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        if left:
            raise SystemExit(
                f'processes with {spec["marker"]} left '
                f'{spec["stop_timeout_s"]} s after the server stopped: '
                f'{[(pid, _cmdline(pid)) for pid in left]}')
        phase_s = time.perf_counter() - t_phase
        log(f'  sdk.down {down_s:.2f} s: {cluster} gone; free card memory '
            f'{free_before} bytes before, {free_after} {release_s:.2f} s '
            f'after; server stopped (exit {proc.returncode}), port closed, '
            f'no marked process left')
        log(f'  api_server {phase_s:.2f} s (server start {start_s:.2f}, '
            f'launch request -> job id {launch_s:.2f}, job {job_s:.2f}, down '
            f'{down_s:.2f}) on {smi}')
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        stray = _kill_processes_with_env(marker)
        if stray:
            log(f'  killed {stray} process(es) with {spec["marker"]}')
        home.close()
    return counts


# LAUNCH's job A on an SSH node pool (SSH_POOL): one loopback host of a
# pool, inside a Docker runtime, reading its weights from a MOUNTed
# bucket.  The host is 127.0.0.2, not 127.0.0.1: the agent client and the
# gang take their local shortcuts for 127.0.0.1 (a direct connection, a
# local process), and the phase is there to drive the SSH path: the
# tunnel to the agent and each rank's command through the SSH runner.
SSH_POOL = dict(pool='smoke-pool', host='127.0.0.2', cluster='smoke-ssh',
                accelerators='H100:1', image='skytpu-torch-smoke:latest',
                bucket='smoke-weights', fwd_launches=48, job_timeout_s=600,
                release_timeout_s=60, mem_atol_bytes=1 << 30)
# Stand-ins for the remote host's CLIs, written into the phase's own
# directory: the card machine has no network and no ssh, rsync or docker.
SSH_SHIM = r'''#!/usr/bin/env python3
"""Loopback stand-in for the OpenSSH client: consumes the client's
options, logs its argv, runs the remote command here in $HOME without
the caller's PYTHONPATH (a remote login does not carry it), and makes
`-N -L local:host:remote` a real TCP forward."""
import json
import os
import socket
import sys
import threading

args, forward, rest = sys.argv[1:], None, []
with open(os.environ['SMOKE_SSH_LOG'], 'a') as log:
    log.write(json.dumps(args) + '\n')
i = 0
while i < len(args):
    if args[i] in ('-o', '-p', '-i'):
        i += 2
    elif args[i] == '-L':
        forward, i = args[i + 1], i + 2
    elif args[i] in ('-T', '-tt', '-N'):
        i += 1
    else:
        rest.append(args[i])
        i += 1
if forward is None:
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    os.chdir(os.environ['HOME'])
    os.execvpe('bash', ['bash', '-c', ' '.join(rest[1:])], env)
local, host, remote = forward.split(':')


def pipe(src, dst):
    try:
        while True:
            data = src.recv(1 << 16)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    for sock in (src, dst):
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


srv = socket.socket()
srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
srv.bind(('127.0.0.1', int(local)))
srv.listen(64)
while True:
    conn, _ = srv.accept()
    try:
        upstream = socket.create_connection((host, int(remote)))
    except OSError:
        conn.close()
        continue
    for a, b in ((conn, upstream), (upstream, conn)):
        threading.Thread(target=pipe, args=(a, b), daemon=True).start()
'''
RSYNC_SHIM = r'''#!/usr/bin/env python3
"""Local stand-in for rsync: `-a` and `-e` are accepted, `--delete` and
`--exclude` honoured, and `user@host:path` is a path here."""
import fnmatch
import os
import shutil
import sys

args, delete, excludes, paths = sys.argv[1:], False, [], []
i = 0
while i < len(args):
    if args[i] in ('-e', '--exclude'):
        if args[i] == '--exclude':
            excludes.append(args[i + 1])
        i += 2
        continue
    if args[i] == '--delete':
        delete = True
    elif not args[i].startswith('-'):
        path = args[i]
        if ':' in path.split('/', 1)[0]:
            path = path.split(':', 1)[1]
        paths.append(os.path.expanduser(path))
    i += 1
src, dst = paths


def excluded(rel):
    return any(fnmatch.fnmatch(rel, p) or fnmatch.fnmatch(
        os.path.basename(rel), p) for p in excludes)


def mirror(src, dst, rel=''):
    if os.path.isdir(src):
        os.makedirs(dst, exist_ok=True)
        names = [n for n in os.listdir(src)
                 if not excluded(os.path.join(rel, n))]
        if delete:
            for name in set(os.listdir(dst)) - set(names):
                target = os.path.join(dst, name)
                if os.path.isdir(target) and not os.path.islink(target):
                    shutil.rmtree(target)
                else:
                    os.remove(target)
        for name in names:
            mirror(os.path.join(src, name), os.path.join(dst, name),
                   os.path.join(rel, name))
    else:
        shutil.copy2(src, dst)


if src.endswith('/') or not os.path.isdir(src):
    mirror(src.rstrip('/') or src, dst)
else:
    mirror(src, os.path.join(dst, os.path.basename(src.rstrip('/'))))
'''
DOCKER_SHIM = r'''#!/usr/bin/env python3
"""Stand-in for the docker CLI: logs its argv; `exec` runs the command
here; no container exists, so `inspect` fails."""
import json
import os
import sys

args = sys.argv[1:]
with open(os.environ['SMOKE_DOCKER_LOG'], 'a') as log:
    log.write(json.dumps(args) + '\n')
if args[:1] == ['inspect']:
    sys.exit(1)
if args[:1] == ['exec']:
    os.execvp(args[2], args[2:])
'''
# The gang's per-rank env the job prints.
RANK_ENV_KEYS = ('SKYTPU_NODE_RANK', 'SKYTPU_NUM_NODES',
                 'SKYTPU_NUM_TPU_CHIPS', 'SKYTPU_COORDINATOR_ADDR')


def _write_shims(directory) -> dict:
    """The ssh, rsync and docker shims in `directory`; their paths."""
    os.makedirs(directory)
    paths = {}
    for name, text in (('ssh', SSH_SHIM), ('rsync', RSYNC_SHIM),
                       ('docker', DOCKER_SHIM)):
        path = os.path.join(directory, name)
        with open(path, 'w', encoding='utf-8') as f:
            f.write(text)
        os.chmod(path, 0o755)
        paths[name] = path
    return paths


def _port_agents_under(root) -> list:
    """The port's agents running with an environment under `root` (the
    command lines the remote bootstrap's pkill matches)."""
    from skypilot_tpu_torch.backends import tpu_vm_backend
    return [pid for pid in _pids_with_env(root)
            if re.search(tpu_vm_backend.AGENT_PKILL_PATTERN, _cmdline(pid))]


class _Listener:
    """A TCP listener on every address standing in for the pool host's
    sshd (the provisioner probes the pool's `port` for liveness)."""

    def __init__(self) -> None:
        import threading
        self.sock = socket.socket()
        self.sock.bind(('0.0.0.0', 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]

        def accept():
            while True:
                try:
                    conn, _ = self.sock.accept()
                    conn.close()
                except OSError:
                    return

        self._thread = threading.Thread(target=accept, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.sock.close()
        self._thread.join(timeout=10)


def ssh_pool_phase(device, card, smi, launch_ctx, launch_counts):
    """LAUNCH's job A on a host of an SSH node pool (SSH_POOL), inside a
    Docker runtime, its weights read from a MOUNTed bucket; returns the
    job's launch counts."""
    import getpass

    import torch
    from skypilot_tpu_torch import authentication, core, execution
    from skypilot_tpu_torch import global_user_state, ssh_node_pools
    from skypilot_tpu_torch.agent.job_queue import JobStatus
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.task import Task
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager

    spec = SSH_POOL
    cluster, host = spec['cluster'], spec['host']
    del device
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    import tempfile
    model_name = server.parse_args(LAUNCH['flags']).model
    root = tempfile.mkdtemp(prefix='skytpu-ssh-')
    listener = _Listener()
    home = None
    t_phase = time.perf_counter()
    try:
        shims = _write_shims(os.path.join(root, 'bin'))
        logs = {n: os.path.join(root, f'{n}.log') for n in ('ssh', 'docker')}
        gcs_root = os.path.join(root, 'gcs')
        home = PhaseHome(
            'skytpu-ssh-home-', SKYTPU_ENABLED_CLOUDS='ssh',
            SKYTPU_SSH_NODE_POOLS_FILE=os.path.join(root, 'pools.yaml'),
            SKYTPU_FAKE_GCS_ROOT=gcs_root, SMOKE_SSH_LOG=logs['ssh'],
            SMOKE_DOCKER_LOG=logs['docker'],
            PATH=os.path.dirname(shims['ssh']) + os.pathsep +
            os.environ['PATH'])
        log(f'  shims for the remote host\'s CLIs (no network, ssh, rsync '
            f'or docker on this machine): {sorted(shims.values())}')
        key, _ = authentication.get_or_generate_keys()
        with open(os.environ['SKYTPU_SSH_NODE_POOLS_FILE'], 'w',
                  encoding='utf-8') as f:
            json.dump({spec['pool']: {
                'hosts': [host], 'user': getpass.getuser(),
                'identity_file': key, 'port': listener.port}}, f)
        # The weights: job A's model from its flags, saved into the bucket.
        t0 = time.perf_counter()
        model = server.build_model(server.parse_args(LAUNCH['flags']))
        directory = os.path.join(gcs_root, spec['bucket'], model_name)
        CheckpointManager(directory).save(0, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t0
        size_gb = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(directory) for f in fs) / 1e9
        mount = os.path.join(root, 'mnt', 'weights')
        url = f'gs://{spec["bucket"]}/{model_name}'
        log(f'  key {key}; pool {spec["pool"]}: {host}, user '
            f'{getpass.getuser()}, liveness port {listener.port}; saved '
            f'{size_gb:.3f} GB of bf16 params into {url} in {save_s:.2f} s')

        flags = LAUNCH['flags'] + ['--checkpoint', mount]
        task = Task('smoke-job-a-ssh', run=(
            'export PYTHONPATH="$HOME/skytpu_runtime" && ' + LAUNCH_JOB_A),
            envs={'ENGINE_FLAGS': json.dumps(flags),
                  'PROMPTS': json.dumps(launch_ctx['prompts']),
                  'MAX_NEW': str(LAUNCH['max_new'])},
            storage_mounts={mount: {'source': url, 'mode': 'MOUNT'}})
        task.set_resources(Resources.from_yaml_config({
            'infra': f'ssh/{spec["pool"]}',
            'accelerators': spec['accelerators'],
            'image_id': f'docker:{spec["image"]}'}))
        t0 = time.perf_counter()
        job_id, handle = execution.launch(task, cluster, detach_run=True,
                                          quiet_optimizer=True)
        launch_s = time.perf_counter() - t0
        res = handle.launched_resources()
        allocated = ssh_node_pools.allocation(spec['pool'], cluster)
        agents = _port_agents_under(root)
        runtime = os.path.realpath(os.path.join(os.environ['HOME'],
                                                'skytpu_runtime'))
        cwds = [os.readlink(f'/proc/{pid}/cwd') for pid in agents]
        log(f'  launch (optimize, allocate, bootstrap over ssh, mount, '
            f'submit) {launch_s:.2f} s: {res} on {handle.head_ip}, '
            f'allocation {allocated}, key {handle.ssh_key_path}; agents '
            f'{agents} in {cwds}')
        if (res.cloud, res.region) != ('ssh', spec['pool']):
            raise SystemExit(f'placed on {res.cloud}/{res.region}, not '
                             f'ssh/{spec["pool"]}')
        if allocated != [host] or handle.ssh_key_path != key:
            raise SystemExit(f'pool allocation {allocated}, key '
                             f'{handle.ssh_key_path}')
        if len(agents) != 1 or cwds != [runtime] or not os.path.isdir(
                os.path.join(runtime, 'skypilot_tpu_torch')):
            raise SystemExit(f'want one port agent running from {runtime}: '
                             f'{agents} in {cwds}')
        rec = _wait_job_status(core, cluster, job_id, spec['job_timeout_s'],
                               JobStatus.is_terminal)
        text = _job_log(core, cluster, job_id)
        if JobStatus(rec['status']) is not JobStatus.SUCCEEDED:
            raise SystemExit(f'job A on the pool ended {rec["status"]}:\n'
                             f'{text[-4000:]}')
        job_s = rec['ended_at'] - rec['started_at']
        lines = [line for line in text.splitlines()
                 if line.startswith('{"tokens"')]
        if len(lines) != 1:
            raise SystemExit(f'job A on the pool printed {len(lines)} '
                             f'result lines:\n{text[-4000:]}')
        out = json.loads(lines[0])
        counts = {name: out['launches'].get(name, 0)
                  for name in KERNEL_NAMES}
        builds, build_s = out['kernel_build'] or (0, 0.0)
        want_build_dir = os.path.join(runtime, 'build', 'skypilot_tpu_torch')
        log(f'  job A SUCCEEDED in {job_s:.2f} s on {out["device"]}: '
            f'launches {counts}; {builds} kernel build(s) in {build_s:.2f} s '
            f'into {out["build_dir"]}; rank env '
            f'{ {k: out["env"].get(k) for k in RANK_ENV_KEYS} }')
        docker, ssh_argv = ([json.loads(line) for line in open(
            logs[name], encoding='utf-8')] for name in ('docker', 'ssh'))
        execs = [argv for argv in docker if argv[0] == 'exec']
        rank_env = ('export SKYTPU_NODE_RANK=0', 'export SKYTPU_NUM_NODES=1',
                    'export SKYTPU_NUM_TPU_CHIPS=1')
        tunnels = [argv for argv in ssh_argv if '-L' in argv]
        log(f'  docker shim: {[argv[:2] for argv in docker]}; ssh shim: '
            f'{len(ssh_argv)} calls to '
            f'{sorted({a for argv in ssh_argv for a in argv if "@" in a})}, '
            f'{len(tunnels)} of them tunnels to the agent')
        if not (['pull', spec['image']] in docker and any(
                argv[:4] == ['run', '-d', '--gpus', 'all'] for argv in docker)
                and execs and all(e in argv[-1] for argv in execs
                                  for e in rank_env)):
            raise SystemExit(f'docker shim saw {docker}')
        if not tunnels or not all(argv[argv.index('-i') + 1] == key
                                  for argv in ssh_argv):
            raise SystemExit(f'ssh shim saw no tunnel, or another key: '
                             f'{ssh_argv}')
        want_env = {'SKYTPU_NODE_RANK': '0', 'SKYTPU_NUM_NODES': '1',
                    'SKYTPU_NUM_TPU_CHIPS': '1'}
        if {k: out['env'].get(k) for k in want_env} != want_env:
            raise SystemExit(f'job A saw {out["env"]}, want {want_env}')
        if out['device'] != card:
            raise SystemExit(f'job A ran on {out["device"]}, not {card}')
        if out['tokens'] != launch_ctx['tokens']:
            raise SystemExit(f'job A on the pool gave {out["tokens"]}, the '
                             f'launch phase {launch_ctx["tokens"]}')
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want['flash_attention_fwd'] = spec['fwd_launches']
        if counts != want or counts != launch_counts:
            raise SystemExit(f'job A on the pool launched {counts}, want '
                             f'{want} (the launch phase: {launch_counts})')
        if out['build_dir'] != want_build_dir or builds < 1:
            raise SystemExit(f'job A built {builds} time(s) into '
                             f'{out["build_dir"]}, want a fresh build into '
                             f'{want_build_dir}')
        t0 = time.perf_counter()
        core.down(cluster)
        down_s = time.perf_counter() - t0
        left = ssh_node_pools.allocation(spec['pool'], cluster)
        if global_user_state.get_cluster(cluster) is not None or left:
            raise SystemExit(f'after down: record '
                             f'{global_user_state.get_cluster(cluster)}, '
                             f'allocation {left}')
        # down releases a BYO host and leaves its agent running (the JAX
        # backend's teardown signals only a local cluster's agent).
        for pid in agents:
            os.kill(pid, 15)
        deadline = time.monotonic() + 30
        while any(_pid_alive(pid) for pid in agents):
            if time.monotonic() > deadline:
                raise SystemExit(f'agent {agents} alive 30 s after SIGTERM')
            time.sleep(0.2)
        listener.close()
        _wait_port_closed(listener.port, 30, 'after the listener closed')
        release_s, free_after = _wait_free_memory(
            free_before, spec['release_timeout_s'], spec['mem_atol_bytes'])
        phase_s = time.perf_counter() - t_phase
        log(f'  down {down_s:.2f} s: record gone, no allocation left; agent '
            f'stopped; listener closed; free card memory {free_before} '
            f'bytes before, {free_after} {release_s:.2f} s after')
        log(f'  ssh_pool {phase_s:.2f} s (weights saved {save_s:.2f}, launch '
            f'{launch_s:.2f}, job {job_s:.2f} of which kernel build '
            f'{build_s:.2f}, down {down_s:.2f}) on {smi}')
    finally:
        listener.close()
        if home is not None:
            if global_user_state.get_cluster(cluster) is not None:
                core.down(cluster)
            home.close()
        shutil.rmtree(root, ignore_errors=True)
    return counts


# The launch phase's job A once more, its weights relayed across clouds:
# llama3-1b's seed-0 bf16 params saved into a bucket of a fake-GCS root,
# copied to a fake-S3 root by data/transfer.py's cross-scheme relay (down
# into a staging directory, up from it), then served by job A on a local
# H100:1 cluster from the S3 bucket MOUNTed as its weights.
BUCKET_RELAY = dict(cluster='smoke-relay', accelerators='H100:1',
                    bucket='smoke-relay', mount='/mnt/weights',
                    fwd_launches=48, job_timeout_s=300, release_timeout_s=60,
                    mem_atol_bytes=1 << 30)


def _tree_digests(directory) -> dict:
    """{path under `directory`: sha256} of every file below it."""
    import hashlib
    out = {}
    for base, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(base, name)
            digest = hashlib.sha256()
            with open(path, 'rb') as f:
                for block in iter(lambda: f.read(1 << 24), b''):
                    digest.update(block)
            out[os.path.relpath(path, directory)] = digest.hexdigest()
    return out


def bucket_relay_phase(device, card, smi, launch_ctx, launch_counts):
    """BUCKET_RELAY: job A's weights relayed gs:// -> s3:// and served from
    the S3 mount; returns the job's launch counts."""
    import tempfile

    import torch
    from skypilot_tpu_torch import core, execution, global_user_state
    from skypilot_tpu_torch.agent.job_queue import JobStatus
    from skypilot_tpu_torch.data import transfer
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.task import Task
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager

    spec = BUCKET_RELAY
    cluster = spec['cluster']
    del device
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    model_name = server.parse_args(LAUNCH['flags']).model
    root = tempfile.mkdtemp(prefix='skytpu-relay-')
    gcs_root, s3_root, staging_parent = (
        os.path.join(root, name) for name in ('gcs', 's3', 'tmp'))
    os.makedirs(staging_parent)
    home = PhaseHome('skytpu-relay-home-', SKYTPU_FAKE_GCS_ROOT=gcs_root,
                     SKYTPU_FAKE_S3_ROOT=s3_root)
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        model = server.build_model(server.parse_args(LAUNCH['flags']))
        src = os.path.join(gcs_root, spec['bucket'], model_name)
        CheckpointManager(src).save(0, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(src) for f in fs)
        want = _tree_digests(src)
        src_url = f'gs://{spec["bucket"]}/{model_name}'
        dst_url = f's3://{spec["bucket"]}/{model_name}'
        # The relay's staging directory is a mkdtemp: under a directory of
        # the phase's own, so that what it leaves behind shows.
        saved_tempdir, tempfile.tempdir = tempfile.tempdir, staging_parent
        try:
            t0 = time.perf_counter()
            transfer.transfer(src_url, dst_url)
            relay_s = time.perf_counter() - t0
        finally:
            tempfile.tempdir = saved_tempdir
        left = os.listdir(staging_parent)
        got = _tree_digests(os.path.join(s3_root, spec['bucket'],
                                         model_name))
        log(f'  saved {size / 1e9:.3f} GB of bf16 params ({len(want)} '
            f'files) into {src_url} in {save_s:.2f} s; relayed to {dst_url} '
            f'through a staging directory in {relay_s:.2f} s '
            f'({size / 1e9 / relay_s:.3f} GB/s of weights, host disk of '
            f'the card\'s machine, warm page cache)')
        if got != want:
            raise SystemExit(f'relayed tree differs: '
                             f'{sorted(set(got.items()) ^ set(want.items()))}')
        if left:
            raise SystemExit(f'the relay left {left} in its temp directory')

        # On the local cloud a MOUNT lands under the cluster's agent home,
        # which the job reads from $SKYTPU_AGENT_HOME.
        weights = '@WEIGHTS@'
        task = Task('smoke-job-a-relay', run=(
            f'export ENGINE_FLAGS="${{ENGINE_FLAGS/{weights}/'
            f'$SKYTPU_AGENT_HOME{spec["mount"]}}}" && ' + LAUNCH_JOB_A),
            envs={'ENGINE_FLAGS': json.dumps(
                LAUNCH['flags'] + ['--checkpoint', weights]),
                  'PROMPTS': json.dumps(launch_ctx['prompts']),
                  'MAX_NEW': str(LAUNCH['max_new'])},
            storage_mounts={spec['mount']: {'source': dst_url,
                                            'mode': 'MOUNT'}})
        task.set_resources(Resources.from_yaml_config(
            {'infra': 'local', 'accelerators': spec['accelerators']}))
        t0 = time.perf_counter()
        job_id, handle = execution.launch(task, cluster, detach_run=True,
                                          quiet_optimizer=True)
        launch_s = time.perf_counter() - t0
        agent_pid = handle.extras['agent_pid']
        rec = _wait_job_status(core, cluster, job_id, spec['job_timeout_s'],
                               JobStatus.is_terminal)
        text = _job_log(core, cluster, job_id)
        if JobStatus(rec['status']) is not JobStatus.SUCCEEDED:
            raise SystemExit(f'job A from the S3 mount ended '
                             f'{rec["status"]}:\n{text[-4000:]}')
        job_s = rec['ended_at'] - rec['started_at']
        lines = [line for line in text.splitlines()
                 if line.startswith('{"tokens"')]
        if len(lines) != 1:
            raise SystemExit(f'job A from the S3 mount printed {len(lines)} '
                             f'result lines:\n{text[-4000:]}')
        out = json.loads(lines[0])
        counts = {name: out['launches'].get(name, 0)
                  for name in KERNEL_NAMES}
        log(f'  launch (optimize, provision, mount, submit) {launch_s:.2f} '
            f's; job A SUCCEEDED in {job_s:.2f} s on {out["device"]}: '
            f'launches {counts}')
        if out['device'] != card or 'RANDOM-INIT' in text:
            raise SystemExit(f'job A ran on {out["device"]}, not {card}, or '
                             f'without the mounted weights:\n{text[-4000:]}')
        if out['tokens'] != launch_ctx['tokens']:
            raise SystemExit(f'job A from the S3 mount gave {out["tokens"]}, '
                             f'the launch phase {launch_ctx["tokens"]}')
        want_counts = dict.fromkeys(KERNEL_NAMES, 0)
        want_counts['flash_attention_fwd'] = spec['fwd_launches']
        if counts != want_counts or counts != launch_counts:
            raise SystemExit(f'job A from the S3 mount launched {counts}, '
                             f'want {want_counts} (the launch phase: '
                             f'{launch_counts})')
        t0 = time.perf_counter()
        core.down(cluster)
        down_s = time.perf_counter() - t0
        if global_user_state.get_cluster(cluster) is not None:
            raise SystemExit('cluster record survived down')
        deadline = time.monotonic() + 30
        while _pid_alive(agent_pid):
            if time.monotonic() > deadline:
                raise SystemExit(f'agent {agent_pid} alive after down')
            time.sleep(0.2)
        release_s, free_after = _wait_free_memory(
            free_before, spec['release_timeout_s'], spec['mem_atol_bytes'])
        phase_s = time.perf_counter() - t_phase
        log(f'  down {down_s:.2f} s: record gone, agent exited; free card '
            f'memory {free_before} bytes before, {free_after} '
            f'{release_s:.2f} s after')
        log(f'  bucket_relay {phase_s:.2f} s (weights saved {save_s:.2f}, '
            f'relay {relay_s:.2f}, launch {launch_s:.2f}, job {job_s:.2f}, '
            f'down {down_s:.2f}) on {smi}')
    finally:
        if global_user_state.get_cluster(cluster) is not None:
            for job in core.queue(cluster):
                if not JobStatus(job['status']).is_terminal():
                    core.cancel(cluster, job['job_id'])
            core.down(cluster)
        home.close()
        shutil.rmtree(root, ignore_errors=True)
    return counts


# The canonical fleet (`fleetsim.sim.fleet_config()`: seed 20260807 and
# serve/slo_sim.py's FLEET_* constants) as the JAX package computes it;
# tests/test_torch_fleetsim.py holds every value here against a JAX run.
# These are outputs of the simulation (virtual replicas costed by
# slo_sim.FLEET_COSTS), not rates of any device.  `digest` is
# fleet_digest() of the whole result, its per-second history included.
FLEET_REFERENCE = dict(
    headline=('sustains 2803 req/s at SLO with 1798 virtual replicas '
              'across 2 pools; recovers from a 50% preemption storm in '
              '8.0 s'),
    admitted=365562, shed=0, no_ready=0, retried=0, peak_replicas=1798,
    lease_frozen_s=5.0, prefix_hit_rate=0.3581,
    alerts=[('tpot_slo_burn', 'decode', 18.0, 45.0),
            ('tpot_slo_burn', 'decode', 75.0, 92.0),
            ('dark_scrape', '', 81.0, 84.0)],
    digest='cc61d3a353cc0af71b2821f0655dddddaf0ece016e8747cb9b5bdeb8240082b4')
# The goodput sim's planted straggler (GoodputScenario(slow_host=2)), as
# the JAX package computes it (sim clock: exact).
GOODPUT_REFERENCE = dict(slow_host='host2', skew=5.0,
                         alerts=['goodput_low', 'straggler'])
FLEET = dict(timeout_s=300, goodput_slow_host=2)
FLEET_FIELDS = ('headline', 'admitted', 'shed', 'no_ready', 'retried',
                'peak_replicas', 'lease_frozen_s', 'prefix_hit_rate')


def fleet_digest(result: dict) -> str:
    """sha256 of a FleetResult's to_dict(with_history=True) without the
    host-timed `profile` and `wall_s`."""
    import hashlib
    body = {k: v for k, v in result.items() if k not in ('profile', 'wall_s')}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def check_fleet(result: dict) -> None:
    """Raise unless `result` (to_dict(with_history=True)) is the JAX
    package's canonical fleet, field by field and by digest."""
    alerts = [(a['rule'], a['pool'], a['fired_at_s'], a['cleared_at_s'])
              for a in result['alerts']]
    diff = {k: (result[k], FLEET_REFERENCE[k]) for k in FLEET_FIELDS
            if result[k] != FLEET_REFERENCE[k]}
    if alerts != FLEET_REFERENCE['alerts']:
        diff['alerts'] = (alerts, FLEET_REFERENCE['alerts'])
    if fleet_digest(result) != FLEET_REFERENCE['digest']:
        diff['digest'] = (fleet_digest(result), FLEET_REFERENCE['digest'])
    if diff:
        raise SystemExit(f'canonical fleet differs from the JAX package\'s '
                         f'(got, want): {diff}')


def check_goodput(res: dict) -> None:
    """Raise unless the planted-straggler goodput sim tiles exactly and
    names GOODPUT_REFERENCE's host and alerts."""
    skew = res['skew'] or {}
    got = dict(slow_host=skew.get('slow_host'), skew=skew.get('skew'),
               alerts=sorted(res['active_alerts']))
    if res['ledger_vs_wall_pct'] >= 1e-6 or got != GOODPUT_REFERENCE:
        raise SystemExit(f'goodput sim: ledger vs wall '
                         f'{res["ledger_vs_wall_pct"]}%, {got}, want < 1e-6% '
                         f'and {GOODPUT_REFERENCE}')


def imported_top_level(importtime_stderr: str) -> set:
    """Top-level packages a `python -X importtime` run imported."""
    return {line.rsplit('|', 1)[1].strip().split('.')[0]
            for line in importtime_stderr.splitlines()
            if line.startswith('import time:') and '|' in line}


# A stand-in for fusermount: logs its argv, hands an fd of the payload
# file back over _FUSE_COMMFD as the real one hands /dev/fuse, exits 0.
FAKE_FUSERMOUNT = r'''#!/usr/bin/env python3
import array, os, socket, sys
with open(os.environ['FAKE_LOG'], 'w') as f:
    f.write('\n'.join(sys.argv[1:]))
fd = os.open(os.environ['FAKE_PAYLOAD_FILE'], os.O_RDWR)
sock = socket.socket(fileno=int(os.environ['_FUSE_COMMFD']))
sock.sendmsg([b'\0'], [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                        array.array('i', [fd]))])
sock.close()
'''


def fuse_relay_check(root) -> dict:
    """The port's fuse proxy built from addons/fuse_proxy into its build
    tree (data/fuse_proxy.py), its server run over FAKE_FUSERMOUNT, and
    the shim's mount: argv relayed to fusermount, the fd it opened relayed
    back through both hops over SCM_RIGHTS.  Returns the build's seconds
    and the binaries' directory."""
    import array
    from skypilot_tpu_torch.data import fuse_proxy

    payload = b'fd-through-the-fuse-proxy'
    fake = os.path.join(root, 'fake-fusermount')
    with open(fake, 'w', encoding='utf-8') as f:
        f.write(FAKE_FUSERMOUNT)
    os.chmod(fake, 0o755)
    with open(os.path.join(root, 'payload.bin'), 'wb') as f:
        f.write(payload)
    env = {'FAKE_LOG': os.path.join(root, 'argv.log'),
           'FAKE_PAYLOAD_FILE': os.path.join(root, 'payload.bin')}
    t0 = time.perf_counter()
    bin_dir = fuse_proxy.build(force=True)
    build_s = time.perf_counter() - t0
    sock_path = os.path.join(root, 'fp.sock')
    # The server forks the fake with its own environment.
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    server = fuse_proxy.FuseProxyServer(sock_path, fusermount_bin=fake)
    ours, theirs = socket.socketpair()
    try:
        server.start()
        proc = subprocess.run(
            [fuse_proxy.shim_binary(), '-o', 'rw', '/mnt/bucket'],
            env=dict(os.environ, FUSE_PROXY_SOCKET=sock_path,
                     _FUSE_COMMFD=str(theirs.fileno())),
            pass_fds=(theirs.fileno(),), capture_output=True, timeout=30)
        theirs.close()
        if proc.returncode != 0:
            raise SystemExit(f'fuse shim exited {proc.returncode}: '
                             f'{proc.stderr[-2000:]!r}')
        ours.settimeout(10)
        _, ancdata, _, _ = ours.recvmsg(
            1, socket.CMSG_SPACE(array.array('i').itemsize))
        if not ancdata:
            raise SystemExit('no fd arrived over _FUSE_COMMFD')
        fds = array.array('i')
        fds.frombytes(ancdata[0][2])
        data = os.read(fds[0], 64)
        os.close(fds[0])
    finally:
        theirs.close()
        ours.close()
        server.stop()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    with open(env['FAKE_LOG'], encoding='utf-8') as f:
        argv = f.read().splitlines()
    if data != payload or argv != ['-o', 'rw', '/mnt/bucket']:
        raise SystemExit(f'fuse proxy relayed {data!r} with argv {argv}')
    return {'build_s': build_s, 'bin_dir': bin_dir}


def fleet_phase(smi):
    """The canonical fleet through `python -m skypilot_tpu_torch.fleetsim
    --json` in a subprocess, the goodput sim in this process, and the
    fuse proxy's fd relay; host work only (no card)."""
    import tempfile
    from skypilot_tpu_torch.fleetsim import goodput_run

    with tempfile.TemporaryDirectory(prefix='skytpu-fleet-') as root:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-X', 'importtime', '-m',
             'skypilot_tpu_torch.fleetsim', '--json', '--db',
             os.path.join(root, 'fleet.db')],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=FLEET['timeout_s'])
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f'fleetsim CLI exited {proc.returncode}:\n'
                             f'{proc.stderr[-4000:]}')
        result = json.loads(proc.stdout)
        bad = imported_top_level(proc.stderr) & {
            'torch', 'jax', 'jaxlib', 'flax', 'skypilot_tpu'}
        if bad:
            raise SystemExit(f'the fleetsim CLI imported {sorted(bad)}')
        log(f'  canonical fleet (simulation outputs: virtual replicas '
            f'costed by slo_sim.FLEET_COSTS): {result["headline"]}; '
            f'admitted {result["admitted"]}, shed {result["shed"]}, '
            f'lease frozen {result["lease_frozen_s"]} s, alerts '
            f'{[(a["rule"], a["fired_at_s"]) for a in result["alerts"]]}')
        check_fleet(result)
        log(f'  equal to the JAX package\'s result (digest '
            f'{FLEET_REFERENCE["digest"][:16]}, history included); neither '
            f'torch nor JAX imported. Host times of the card\'s machine: '
            f'CLI {cli_s:.2f} s, wall_s {result["wall_s"]}, profile top 3 '
            f'{result["profile"][:3]}')

        t0 = time.perf_counter()
        res = goodput_run.run_goodput_sim(
            goodput_run.GoodputScenario(slow_host=FLEET['goodput_slow_host']),
            ledger_dsn=os.path.join(root, 'ledger.db'),
            store_dsn=os.path.join(root, 'store.db'))
        goodput_s = time.perf_counter() - t0
        check_goodput(res)
        log(f'  goodput sim (sim clock): goodput {res["goodput_pct"]:.2f}%, '
            f'ledger vs wall {res["ledger_vs_wall_pct"]}%, skew '
            f'{res["skew"]}, alerts {res["active_alerts"]}; '
            f'{goodput_s:.2f} s of host time')

        fuse = fuse_relay_check(root)
        log(f'  fuse proxy built into {fuse["bin_dir"]} in '
            f'{fuse["build_s"]:.2f} s (host); argv and the mount fd relayed '
            f'through shim -> server -> fake fusermount; {smi}')


def hbm_probe():
    """(free, total) bytes of the card as torch.cuda.mem_get_info reads
    them once this process holds its CUDA context, the caching allocator
    and a one-rank NCCL group (left before returning)."""
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel import group as group_lib
    group_lib.join(0, 1, group_lib.free_port(), 'nccl', timeout_s=120)
    try:
        x = torch.ones(1024, device='cuda')
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return torch.cuda.mem_get_info()
    finally:
        group_lib.leave()


def graft_entry_phase(device, card, smi, hbm):
    """The graft entry's twin on the card: entry()'s llama-250m forward on
    its example arguments and on SEED tokens of that shape, each against
    attention_impl='xla' on the same params (LOGITS_RTOL of max |logit|),
    launches zeroed just before and read just after; then validate.py's
    'h100' entry against the memory measured at the start of this run
    (`hbm`), and one placement printed.  Returns the launches."""
    import torch
    from skypilot_tpu_torch import graft_entry
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama
    from skypilot_tpu_torch.parallel import validate

    t0 = time.perf_counter()
    fn, (params, tokens) = graft_entry.entry()
    cfg = LLAMA_CONFIGS['llama-250m']
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    seeded = torch.randint(0, cfg.vocab_size, tuple(tokens.shape),
                           device=device, generator=torch.Generator(
                               device=device).manual_seed(SEED + 41))
    zero_launches()
    got = [fn(params, tokens), fn(params, seeded)]
    torch.cuda.synchronize()
    counts = read_launches()
    rels = []
    with torch.no_grad():
        for logits, toks in zip(got, (tokens, seeded)):
            ref = xla(toks)
            rels.append(((logits - ref).abs().max() /
                         ref.abs().max()).item())
    log(f'  entry(): {cfg.num_params() / 1e9:.3f}B params, tokens '
        f'{tuple(tokens.shape)}, logits {tuple(got[0].shape)} on {card}: '
        f'against attention_impl=\'xla\' rel {rels[0]:.2e} (example '
        f'arguments), {rels[1]:.2e} (SEED tokens) (gate {LOGITS_RTOL}); '
        f'launches {counts}; {time.perf_counter() - t0:.1f} s')
    if not (all(torch.isfinite(x).all() for x in got) and
            max(rels) <= LOGITS_RTOL):
        raise SystemExit('entry() logits disagree with the plain attention '
                         'path')
    if counts != dict(dict.fromkeys(KERNEL_NAMES, 0),
                      flash_attention_fwd=2 * cfg.n_layers):
        raise SystemExit(f'entry() launched {counts}')
    del fn, params, xla, got
    torch.cuda.empty_cache()

    free, total = hbm
    spec = validate.DEVICES['h100']
    fraction = free / total
    log(f'  validate: {card} ({smi}) reports {total} bytes, {free} free '
        f'({fraction:.4f}) once the CUDA context and a one-rank NCCL group '
        f'exist; the table\'s h100 entry: {spec.hbm_bytes} bytes, usable '
        f'{spec.usable_fraction}')
    report = validate.validate_placement('H100:8', model_name='llama3-8b')
    log('    ' + report.summary().replace('\n', '\n    '))
    if not (abs(total - spec.hbm_bytes) <= VALIDATE_HBM_RTOL *
            spec.hbm_bytes and
            fraction >= spec.usable_fraction - VALIDATE_FRACTION_ATOL):
        raise SystemExit(f'validate.py\'s h100 entry {spec} does not match '
                         f'the card: total {total}, usable {fraction:.4f}')
    return counts, kernel_times(device, ENTRY_SHAPE, 'graft entry',
                                ('fwd',))['fwd']


# The sync audit (torch.cuda.set_sync_debug_mode('warn')): `tiny` served
# by the dense engine with the graph decode through step_pipelined (the
# perf-gate probe's traffic) and by the int8-paged engine with n-gram
# speculation (the verify call), and trained through Trainer.run.
SYNC_AUDIT = dict(model='tiny', max_seq_len=128, n_slots=2, steps_per_call=4,
                  prefill_buckets=(8, 16), n_requests=6, prompt_len=8,
                  new_tokens=8, kv_page_size=8, speculation=4,
                  train_batch=4, train_seq=128, train_steps=10, log_every=5)
SYNC_WARNING = 'called a synchronizing CUDA operation'


def _sync_site(stack) -> str:
    """Where a synchronizing call came from: the innermost frame in the
    port's package as 'path:line' relative to it (the static analyzer's
    paths), else the innermost frame outside torch and warnings."""
    pkg = os.path.join(REPO, 'skypilot_tpu_torch') + os.sep
    for frame in reversed(stack):
        if frame.filename.startswith(pkg):
            return f'{os.path.relpath(frame.filename, pkg)}:{frame.lineno}'
    for frame in reversed(stack):
        name = frame.filename.replace(os.sep, '/')
        if '/torch/' not in name and not name.endswith('/warnings.py'):
            return f'{os.path.basename(name)}:{frame.lineno}'
    return 'unknown'


class SyncRecorder:
    """Every synchronizing CUDA call under set_sync_debug_mode('warn'),
    as (step, site): `step` is whatever the caller set last, the site
    the innermost frame of the port in the warning's stack.  Other
    warnings pass through."""

    def __init__(self):
        self.step = None
        self.events = []

    def __enter__(self):
        import torch
        import warnings
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter('always')
        self._show = warnings.showwarning
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode('warn')
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode('default')
        self._catch.__exit__(*exc)

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        import traceback
        if SYNC_WARNING not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        self.events.append((self.step, _sync_site(traceback.extract_stack())))

    def take(self):
        """The events so far, and forget them."""
        out, self.events = self.events, []
        return out


def sync_probe(device) -> dict:
    """Which synchronizing forms set_sync_debug_mode('warn') reports on
    this torch: {form: warnings for one call}."""
    import torch
    x = torch.arange(1, 1025, device=device, dtype=torch.float32)
    pinned = torch.empty(x.shape, dtype=x.dtype).pin_memory()
    host = torch.ones(1024)
    event = torch.cuda.Event()
    event.record()
    forms = {
        '.item()': lambda: x.sum().item(),
        '.cpu()': lambda: x.cpu(),
        '.tolist()': lambda: x[:4].tolist(),
        'float(tensor)': lambda: float(x[0]),
        'torch.cuda.synchronize()': torch.cuda.synchronize,
        'Stream.synchronize()': lambda: torch.cuda.current_stream().synchronize(),
        'Event.synchronize()': event.synchronize,
        '.nonzero()': lambda: x.nonzero(),
        'torch.unique': lambda: torch.unique(x),
        'torch.masked_select': lambda: torch.masked_select(x, x > 512),
        'mask index x[x > 512]': lambda: x[x > 512],
        'if t.any():': lambda: bool((x > 512).any()),
        'pinned non_blocking D2H copy': lambda: pinned.copy_(x, non_blocking=True),
        'pinned non_blocking H2D copy': lambda: x.copy_(pinned, non_blocking=True),
        'pageable blocking H2D copy': lambda: host.to(device),
        'torch.tensor(list, device=cuda)': lambda: torch.tensor([1, 2], device=device),
    }
    caught = {}
    with SyncRecorder() as rec:
        for form, fn in forms.items():
            torch.cuda.synchronize()
            rec.take()
            fn()
            caught[form] = len(rec.take())
    torch.cuda.synchronize()
    return caught


def _audit_engine(rec, engine, prompts, new_tokens):
    """Serve `prompts` through step_pipelined (speculation: step), one
    recorded step at a time until idle.  Returns [(active, sites)] per
    step: active when the step fetches a call's output (pipelined: a call
    was in flight at its start; speculation: it dispatched)."""
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    steps = []
    while (not all(r.finished_at is not None for r in reqs) or
           engine._inflight is not None):
        rec.step = len(steps)
        inflight = engine._inflight is not None
        n = engine.step_pipelined()
        active = n > 0 if engine._spec_k else inflight
        steps.append((active, [site for _, site in rec.take()]))
    if len(steps) > 200 or not all(len(r.tokens()) == new_tokens
                                   for r in reqs):
        raise SystemExit(f'sync audit: the engine served {len(steps)} steps, '
                         f'tokens {[len(r.tokens()) for r in reqs]}')
    return steps


def sync_audit_phase(device, card):
    """set_sync_debug_mode('warn') on the port's hot loops (SYNC_AUDIT):
    first which synchronizing forms it reports on this torch; then each
    synchronizing call of `tiny`'s dense graph engine (step_pipelined),
    its int8-paged engine with n-gram speculation (the verify call) and
    Trainer.run, by step and by source line.  Gates: exactly one sync per
    active engine step, at the engine's annotated contract line; none on
    an idle step; none on the trainer's non-log steps; every line seen at
    runtime is a site the static analyzer reports (hot-loop-sync),
    suppressed with a reason.  Returns the launch counts of the audited
    runs."""
    import collections
    import numpy as np
    import torch
    from skypilot_tpu_torch import analysis
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    spec = SYNC_AUDIT
    t_phase = time.perf_counter()
    caught = sync_probe(device)
    log(f'  probe on {card}, torch {torch.__version__}: reported '
        f'{sorted(f for f, n in caught.items() if n)}; not reported '
        f'{sorted(f for f, n in caught.items() if not n)}')
    for form in ('.item()', '.cpu()', '.tolist()'):
        if not caught[form]:
            raise SystemExit(f'set_sync_debug_mode does not report {form}: '
                             f'the audit cannot see the hot loops\' fetches')

    report = analysis.run_check(None, rules=['hot-loop-sync'])
    if report.unsuppressed:
        raise SystemExit('the static gate has findings: ' + '; '.join(
            f.format() for f in report.unsuppressed))
    static = {f'{f.path}:{f.line}': f for f in report.findings}

    def contract(fn):
        sites = [site for site, f in static.items() if f.suppressed and
                 f.message.split(' in ', 1)[-1].startswith(
                     f'skypilot_tpu_torch.inference.engine.DecodeEngine.'
                     f'{fn} ')]
        if len(sites) != 1:
            raise SystemExit(f'expected one annotated fetch in {fn}, the '
                             f'static gate reports {sites}')
        return sites[0]

    cfg = dataclasses.replace(LLAMA_CONFIGS[spec['model']],
                              max_seq_len=spec['max_seq_len'])
    model = Llama(cfg, init_params(
        cfg, device, torch.Generator(device=device).manual_seed(SEED)))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, spec['prompt_len']).tolist()
               for _ in range(spec['n_requests'])]
    base = dict(n_slots=spec['n_slots'], steps_per_call=spec['steps_per_call'],
                prefill_buckets=spec['prefill_buckets'])
    engines = {
        'dense_graph': (dict(base), contract('_step_pipelined')),
        'paged_int8_spec': (dict(base, kv_page_size=spec['kv_page_size'],
                                 kv_dtype='int8',
                                 speculation=spec['speculation']),
                            contract('_step')),
    }
    out = {'probe': caught, 'engines': {}, 'lines': collections.Counter()}
    zero_launches()
    with SyncRecorder() as rec:
        for name, (kw, fetch) in engines.items():
            engine = DecodeEngine(model, EngineConfig(**kw), device=device)
            engine.prewarm()
            if engine._decode_call is None and engine._verify_call is None:
                raise SystemExit(f'{name}: prewarm built no call')
            if (engine._decode_call or engine._verify_call).graph is None:
                raise SystemExit(f'{name}: the call is not a CUDA graph')
            # Warm every admission shape the audit hits (as the probe).
            warm = [engine.submit(p, 1) for p in prompts[:spec['n_slots']]]
            while any(w.finished_at is None for w in warm) or \
                    engine._inflight is not None:
                engine.step_pipelined()
            torch.cuda.synchronize()
            rec.take()
            steps = _audit_engine(rec, engine, prompts, spec['new_tokens'])
            for _, sites in steps:
                out['lines'].update(sites)
            bad = [(i, active, sites) for i, (active, sites) in
                   enumerate(steps)
                   if sites != ([fetch] if active else [])]
            n_active = sum(active for active, _ in steps)
            out['engines'][name] = {
                'steps': len(steps), 'active_steps': n_active,
                'syncs_per_step': [len(sites) for _, sites in steps],
                'contract_line': fetch}
            log(f'  {name}: {len(steps)} steps, {n_active} active; syncs per '
                f'step {[len(sites) for _, sites in steps]} (contract line '
                f'{fetch})')
            if bad or not n_active:
                raise SystemExit(f'sync audit {name}: steps off the contract '
                                 f'(one sync at {fetch} per active step, none '
                                 f'when idle): {bad}')
            del engine
        del model
        torch.cuda.empty_cache()

        # Trainer.run: the data iterator marks the step each batch starts.
        model = Llama(cfg, init_params(
            cfg, device, torch.Generator(device=device).manual_seed(SEED)))
        trainer = Trainer(model, TrainConfig(warmup_steps=5, total_steps=1000),
                          device=device)
        tokens = torch.randint(
            0, cfg.vocab_size, (spec['train_batch'], spec['train_seq']),
            device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + 2))
        torch.cuda.synchronize()
        rec.take()

        def batches():
            for i in range(spec['train_steps']):
                rec.step = i
                yield tokens

        logged = []
        result = trainer.run(batches(), spec['train_steps'],
                             log_every=spec['log_every'],
                             log_fn=logged.append)
        events = rec.take()
    torch.cuda.synchronize()
    counts = {**read_launches(), **read_small_launches()}
    by_step = collections.defaultdict(list)
    for step, site in events:
        by_step[step].append(site)
    out['lines'].update(site for _, site in events)
    log_steps = [i for i in range(spec['train_steps'])
                 if (i + 1) % spec['log_every'] == 0]
    out['trainer'] = {
        'steps': spec['train_steps'], 'log_steps': log_steps,
        'syncs_per_step': [len(by_step.get(i, ()))
                           for i in range(spec['train_steps'])],
        'losses': [m['loss'] for m in logged] + [result['loss']]}
    log(f'  trainer: {spec["train_steps"]} steps of {spec["train_batch"]} x '
        f'{spec["train_seq"]}, log steps {log_steps}; syncs per step '
        f'{out["trainer"]["syncs_per_step"]} (the last step also holds the '
        f'end-of-run fetch); losses {out["trainer"]["losses"]}')
    stray = {i: sites for i, sites in by_step.items() if i not in log_steps}
    if stray or not all(map(math.isfinite, out['trainer']['losses'])):
        raise SystemExit(f'sync audit: the trainer synced on non-log steps '
                         f'{stray} (or a loss is not finite)')
    unknown = {site: n for site, n in out['lines'].items()
               if site not in static or not static[site].reason}
    if unknown:
        raise SystemExit(f'sync audit: synchronizing lines the static '
                         f'analyzer does not report as annotated '
                         f'(a finding against hot-loop-sync): {unknown}')
    out['lines'] = {site: [n, static[site].reason]
                    for site, n in sorted(out['lines'].items())}
    out['seconds'] = time.perf_counter() - t_phase
    out['launches'] = counts
    log('sync_audit ' + json.dumps(out))
    if not counts[SMALL_KERNEL] or not counts['flash_attention_bwd_dq_small']:
        raise SystemExit(f'sync audit launched {counts}')
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    t_start = time.perf_counter()
    device = resolve_device('cuda')
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f'[device] {card} | {smi} | torch {torch.__version__} cuda '
        f'{torch.version.cuda}')
    # The card's memory as a training process sees it (validate.py's
    # table is checked against it in the graft_entry phase).
    hbm = hbm_probe()
    log(f'[device] torch.cuda.mem_get_info with a CUDA context and a '
        f'one-rank NCCL group: {hbm[0]} free of {hbm[1]} bytes')

    t0 = time.perf_counter()
    build_log = fa.build()
    log(f'[build] {", ".join(p.name for p in fa.sources())} in '
        f'{time.perf_counter() - t0:.1f} s -> {fa.BUILD_DIR}')
    for line in build_log.splitlines():
        if line.startswith('==') or 'error' in line.lower() or any(
                t in line for t in ('registers', 'spill', 'Compiling',
                                    'arning', 'Performance')):
            log(f'  {line.strip()}')
    ptxas = ptxas_report(build_log)
    spills = {key: r['spill_stores'] for key, r in ptxas.items()
              if r.get('spill_stores')}
    if spills or 'setmaxnreg ignored' in build_log:
        raise SystemExit(f'ptxas spilled ({spills}) or ignored setmaxnreg')

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f'[{label}] done in {time.perf_counter() - t0:.1f} s')
        return out

    log(f'[kernels] forward vs plain version (out |d| <= {OUT_ATOL} + '
        f'{OUT_RTOL}*|ref|, lse |d| <= {LSE_ATOL})')
    fwd = phase('kernels', kernel_phase, device)
    log(f'[kernels] the small-head-dim forward vs plain version (out |d| '
        f'<= {SMALL_ATOL} + one output ulp, lse |d| <= {SMALL_ATOL})')
    small = phase('kernels', small_kernel_phase, device)
    log(f'[small_bwd_kernel] the small-head-dim dq and dk/dv vs plain '
        f'versions (||d|| / ||ref|| <= {BWD_NORM_RTOL}) at '
        f'{len(SMALL_BWD_SHAPES)} tile-edge shapes; the three small kernels '
        f'timed at tiny\'s training shape {TINY_TRAIN_SHAPE}')
    small_bwd, small['at_tiny_training_shape'] = phase(
        'small_bwd_kernel', small_bwd_kernel_phase, device)
    log(f'[kernels] at the training shapes: forward as above, dq and dk/dv '
        f'vs plain versions (||d|| / ||ref|| <= {BWD_NORM_RTOL})')
    dq, dkv, fwd['at_training_shape'] = phase('kernels', bwd_kernel_phase,
                                              device)
    fwd['max_abs_err'] = max(fwd['max_abs_err'],
                             fwd['at_training_shape']['max_abs_err'])
    log('[kernels] at the MoE shapes: prefill (forward), training '
        '(forward, dq, dk/dv)')
    at_moe_prefill = phase('kernels', kernel_times, device,
                           MOE_PREFILL_SHAPE, 'MoE prefill', ('fwd',))
    at_moe_train = phase('kernels', kernel_times, device, MOE_TRAIN_SHAPE,
                         'MoE training')
    by_path = {}
    log(f'[head_dims] every head_dim up to 256: {len(HEAD_DIM_CASES)} cases '
        f'at head_dims {HEAD_DIM_SWEEP} vs the plain versions (forward out '
        f'|d| <= {OUT_ATOL} + {OUT_RTOL}*|ref|, lse {LSE_ATOL}; dq, dk/dv '
        f'norm-rel {BWD_NORM_RTOL}); the wide kernels timed at '
        f'{HEAD_DIM_FAMILIES} x {HEAD_DIM_TIMED}; {list(HEAD_DIM_MODELS)} '
        f'widths served and trained ({HEAD_DIM_E2E})')
    wide, by_path['head_dims'] = phase('head_dims', head_dims_phase, device,
                                       card, smi, ptxas)
    log(f'[f32] the three kernels in f32 (3xTF32 mma.sync) vs their plain '
        f'versions in full f32 (out, lse |d| <= 5e-5 + 5e-5*|ref|; dq, '
        f'dk/dv norm-rel 5e-5); timed at {F32_TIMED}')
    f32k = phase('f32', f32_kernel_phase, device, ptxas)
    log(f'[sync_audit] {SYNC_AUDIT}')
    by_path['sync_audit'] = phase('sync_audit', sync_audit_phase, device,
                                  card)
    log(f'[launch] {LAUNCH}')
    by_path['launch'], launch_ctx = phase('launch', launch_phase, device,
                                          card, smi)
    log(f'[api_server] {API_SERVER}')
    by_path['api_server'] = phase('api_server', api_server_phase, device,
                                  card, smi, launch_ctx, by_path['launch'])
    log(f'[managed_job] {MANAGED_JOB}')
    by_path['managed_job'] = phase('managed_job', managed_job_phase, device,
                                   card, smi)
    log(f'[serve] {SERVE_SERVICE}')
    by_path['serve'] = phase('serve', serve_phase, device, card, smi,
                             launch_ctx)
    # After serve: every earlier phase's clusters and agents are gone, and
    # the remote bootstrap's pkill stops any port agent on this host.
    log(f'[ssh_pool] {SSH_POOL}')
    by_path['ssh_pool'] = phase('ssh_pool', ssh_pool_phase, device, card,
                                smi, launch_ctx, by_path['launch'])
    # After ssh_pool, whose remote bootstrap's pkill stops every port agent
    # on this host.
    log(f'[bucket_relay] {BUCKET_RELAY}')
    by_path['bucket_relay'] = phase('bucket_relay', bucket_relay_phase,
                                    device, card, smi, launch_ctx,
                                    by_path['launch'])

    from skypilot_tpu_torch.perf import compile_telemetry
    log(f'[build] compile telemetry {compile_telemetry.summary()} '
        f'(kind: (builds, s))')
    # Every serving phase below runs under the strict recompile sentinel:
    # each engine's prewarm() captures its call and arms it, so a build
    # under traffic raises inside the engine loop (and fails the phase).
    os.environ[compile_telemetry.STRICT_ENV] = '1'
    log(f'[serving] {SERVE}')
    by_path['serving'], serve_ctx = phase('serving', serving_phase, device,
                                          card)
    log(f'[paged] {PAGED}')
    by_path['paged'] = phase('paged', paged_phase, device, card, serve_ctx)
    log('[checkpoint] the serving weights through CheckpointManager, '
        'served with --checkpoint --param-dtype bfloat16; a swap under the '
        'graph')
    by_path['checkpoint'] = phase('checkpoint', checkpoint_phase, device,
                                  card, serve_ctx)
    log(f'[tensor_serving] {TENSOR}')
    by_path['tensor_serving'], fwd['at_tensor_rank_shape'] = phase(
        'tensor_serving', tensor_serving_phase, device, card, serve_ctx)
    fwd['max_abs_err'] = max(fwd['max_abs_err'],
                             fwd['at_tensor_rank_shape']['max_abs_err'])
    del serve_ctx
    # Collect what the serving phases left in reference cycles before the
    # next phases read their peak memory.
    gc.collect()
    torch.cuda.empty_cache()
    log(f'[moe_serving] {MOE_SERVE}')
    by_path['moe_serving'] = phase('moe_serving', moe_serving_phase, device,
                                   card)
    log(f'[sentinel] every serving engine built nothing after prewarm() '
        f'under {compile_telemetry.STRICT_ENV}=1; builds so far (kind: '
        f'(builds, s)) {compile_telemetry.summary()}')
    del os.environ[compile_telemetry.STRICT_ENV]
    compile_telemetry.disarm()
    log(f'[training] {TRAIN}')
    by_path['training'] = phase('training', training_phase, device, card,
                                smi)
    log(f'[moe_training] {MOE_TRAIN}')
    by_path['moe_training'] = phase('moe_training', training_phase, device,
                                    card, smi, MOE_TRAIN)
    log(f'[tiny_training] {TINY_TRAIN}')
    by_path['tiny_training'] = phase('tiny_training', tiny_training_phase,
                                     device, card, smi)
    log(f'[f32_training] {F32_TRAIN}')
    by_path['f32_training'] = phase('f32_training', f32_training_phase,
                                    device, card, smi)
    log(f'[rl] {RL}')
    by_path['rl'] = phase('rl', rl_phase, device, card)
    at_rl_shape = kernel_times(device, RL_SHAPE, 'REINFORCE')
    log(f'[zoo] {ZOO}')
    phase('zoo', zoo_phase, device, card)
    log(f'[sharded_training] {SHARDED}')
    by_path['sharded_training'], at_ring_hop, ring_rels = phase(
        'sharded_training', sharded_training_phase, device, card, smi)
    log(f'[pipeline] {PIPELINE}')
    by_path['pipeline'], at_pipeline = phase('pipeline', pipeline_phase,
                                             device, card, smi)
    log(f'[expert_parallel] {EXPERT}')
    by_path['expert_parallel'] = phase('expert_parallel',
                                       expert_parallel_phase, device, card,
                                       smi)
    log(f'[moe_tensor_serving] {MOE_TENSOR}')
    by_path['moe_tensor_serving'], fwd['at_moe_tensor_rank_shape'] = phase(
        'moe_tensor_serving', moe_tensor_serving_phase, device, card)
    log('[graft_entry] entry() on the card; validate.py\'s h100 entry')
    by_path['graft_entry'], fwd['at_entry_shape'] = phase(
        'graft_entry', graft_entry_phase, device, card, smi, hbm)
    log('[perf_gate] python -m skypilot_tpu_torch.perf.gate\'s run on the '
        'card: tiny (head_dim 16) against the newest BENCH_*.json')
    by_path['perf_gate'], small_launches = phase('perf_gate',
                                                 perf_gate_phase, device,
                                                 card)
    # Last: the goodput sim resets the port's metrics registry.
    log(f'[fleet] {FLEET}')
    phase('fleet', fleet_phase, smi)
    # The newest paths and the kernels they run (the jobs on the SSH pool
    # and from the relayed bucket serve: the flash forward, no backward).
    new_paths = {'ssh_pool': ('flash_attention_fwd',),
                 'bucket_relay': ('flash_attention_fwd',),
                 'head_dims': WIDE_KERNELS + KERNELS_256,
                 'f32_training': F32_KERNELS,
                 'tensor_serving': ('flash_attention_fwd_f32',),
                 'moe_tensor_serving': ('flash_attention_fwd_f32',)}
    for path, names in new_paths.items():
        for name in names:
            if not by_path[path][name]:
                raise SystemExit(f'{name} not launched on the new path '
                                 f'{path}: {by_path[path]}')

    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'tflops',
            'registers', 'smem_bytes', 'spill_bytes')
    rows = []
    for entry, kind in ((fwd, 'fwd'), (dq, 'dq'), (dkv, 'dkv')):
        entry['at_rl_shape'] = at_rl_shape[kind]
        # Times at one ring hop's shape; the ring op's norm-relative
        # errors against ring_attention_reference ((e), out and dq/dk/dv).
        entry['at_ring_hop_shape'] = {
            **at_ring_hop[kind], 'ring_op_norm_rel': ring_rels}
        entry['at_moe_training_shape'] = at_moe_train[kind]
        entry['at_pipeline_shape'] = at_pipeline[kind]
        if kind == 'fwd':
            entry['at_moe_prefill_shape'] = at_moe_prefill[kind]
        # ptxas of the timed instantiation (bf16, head_dim 128); shared
        # memory as the profiler saw the timed launch.  None where the
        # library was reused from an earlier build (no ptxas output).
        report = ptxas.get((KERNEL_SYMBOLS[entry['name']], 'bf16', 128), {})
        entry['registers'] = report.get('registers')
        entry['spill_bytes'] = report.get('spill_stores')
        # The profiled launch at the training shape ({} where no trace
        # held it: then no shared-memory figure).
        launch = entry.get('launch') or entry.get(
            'at_training_shape', {}).get('launch') or {}
        entry['smem_bytes'] = launch.get('shared memory')
        counts = {path: c.get(entry['name'], 0)
                  for path, c in by_path.items()}
        if not any(counts.values()):
            raise SystemExit(f'{entry["name"]} was never launched on the '
                             f'main paths: {counts}')
        entry['launches'] = sum(counts.values())
        entry['launches_by_path'] = counts
        rows.append({**{key: entry[key] for key in keys},
                     **{key: entry[key] for key in entry if key not in keys}})
    # The small-head-dim kernels: launched on tiny_training's path (all
    # three) and the perf gate's (the forward); ptxas of the bf16,
    # head_dim 16 instantiation `tiny` runs.
    by_path['perf_gate'][SMALL_KERNEL] = small_launches
    for entry in (small, small_bwd['dq'], small_bwd['dkv']):
        report = ptxas.get((KERNEL_SYMBOLS[entry['name']], 'bf16', 16), {})
        counts = {path: c.get(entry['name'], 0)
                  for path, c in by_path.items()
                  if c.get(entry['name'], 0)}
        if not counts:
            raise SystemExit(f'{entry["name"]} was never launched on the '
                             f'main paths')
        entry.update(registers=report.get('registers'),
                     spill_bytes=report.get('spill_stores'),
                     smem_bytes=entry['launch'].get('shared memory'),
                     launches=sum(counts.values()),
                     launches_by_path=counts)
        rows.append({**{key: entry[key] for key in keys},
                     **{key: entry[key] for key in entry if key not in keys}})
    # The wide kernels (head_dim 80, 96) and the three at 256: launched on
    # the head_dims path's serving and training runs; the f32 kernels on
    # f32_training's and (the forward) on the f32 serving runs of
    # tensor_serving and moe_tensor_serving.
    for entry in (wide['fwd'], wide['dq'], wide['dkv'], wide['fwd_256'],
                  wide['dq_256'], wide['dkv_256'], f32k['fwd'], f32k['dq'],
                  f32k['dkv']):
        counts = {path: c.get(entry['name'], 0)
                  for path, c in by_path.items()
                  if c.get(entry['name'], 0)}
        if not counts:
            raise SystemExit(f'{entry["name"]} was never launched on the '
                             f'main paths')
        entry.update(launches=sum(counts.values()), launches_by_path=counts)
        rows.append({**{key: entry[key] for key in keys},
                     **{key: entry[key] for key in entry if key not in keys}})
    kernels = {'kernels': rows}
    log(f'[done] {time.perf_counter() - t_start:.1f} s (PR 20\'s smoke: '
        f'807.5 s)')
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
