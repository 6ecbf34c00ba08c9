"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX or gofr_tpu.
Three short modes print no ok line: ``--flash`` (build, the flash checks,
flash times at B=1 T=S 16 / 80 / 256 / 1024 / 16384 and B=4 T=S=256),
``--decode`` (build, the decode-read checks, the four decode reads' times
at B=8 over ~200-token contexts, B=8 x 8192 and B=1 x 8192) and
``--prefill`` (build, the main path's admission wave at [1, 256] and
[4, 256], eager and as its graph's replay: host wall, card busy time and
host launches), ``--sc`` (build, the main path's sampling-controls
phase at CUT_DEPTH layers, then the sort-skip and scoring phases, 7 and 8
below) and ``--weights`` (build, then phase 9 alone), ``--spec`` (build,
then phase 10 alone), ``--openai`` (build, then phase 7b on an engine
booted for it, OPENAI_ENV) and ``--obs`` (build, the main path's serve
phase with phase 4b and its cost measurements, then its decode profile
with the utilization ledger beside it). ``--faults`` (build, then phase
11), ``--qos`` (build, then phase 12), ``--elastic`` (build, then phase
13), ``--train`` (build, then phase 14), ``--models`` (build, then phase
15), ``--parallel`` (build, then phase 16; ``--parallel e``: its phase (e)
alone), ``--sharded-train`` (build, then phase 17), ``--loadgen``
(build, then phase 18), ``--fleet`` (build, then phase 19) and
``--surfaces`` (build, then phase 20) end with the ok line.

Phases, one or more lines each, any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), TF32 off,
   the kernels' three sources built from gofr_tpu_torch/ops/csrc with one
   nvcc each, in parallel; ptxas's registers and spill bytes per kernel
   (the decode reads per element type and instantiation), and the int ->
   float conversions in the decode reads' SASS (cuobjdump; an int8 read
   must convert its elements without I2F);
2. each kernel against its plain PyTorch version on the card, in bf16, at
   the stated tolerance (flash: H=32, Hkv=8, dh=128 at T=S 128 / 1000 /
   16384, causal and not, T=S=80 causal (two kv tiles), non-causal T=200
   over S=333 at dh 128 and 64, causal dh=64, and the served B=4 T=S=256
   window read and written in the model's [B, T, H, dh] layout; paged and
   paged-int8: B=8, ragged
   lengths around the page size, zero table tails, page sizes 16 and 128,
   and zeros at length 0; decode and decode-int8: B=8 over a dense S=1024
   cache at lengths 0, S, one past S and ragged ones between; the split
   reads, bf16 and int8, where the split matters: B=1 at 8192 and B=8
   ragged up to 8192 with lengths at the split's unit boundaries and one
   past them, page sizes 16 and 128, dense S=1000 and S=1001, the same bits
   from two calls in a row, zeros at length 0 and S+1 read as S);
3. the model on the card: Llama-3-8B at full width and depth, random
   weights from seed 0; one paged decode step and one dense decode step
   (decode kernel) must match a full recompute of the same context with
   plain attention, and one dense int8 and one paged int8 step must match a
   plain step over the same int8 cache, dequantized; the prefix cache's
   tail prefill over two cached pages (bf16 and int8) must match a plain
   prefill of the whole prompt (int8: of the tail over the prefix's int8 K/V
   dequantized);
4. serving, four configurations of the port's app (gofr_tpu_torch/serve.py)
   on the same weights: paged bf16 (the main path), paged int8
   (KV_DTYPE=int8), dense (PAGED=false DECODE_ATTN=kernel) and dense int8
   (the same with KV_DTYPE=int8), each with ATTN_IMPL=flash and the prefix
   cache at its default (on for the paged engine), the dispatch layer
   at its defaults (pipeline_depth 4, ENGINE_ASYNC_D2H on) and WARMUP=wide:
   every program serving can reach, decode blocks, admission waves and
   prefix-hit tail waves, captured as a CUDA graph at boot, logged per
   kind with the capture seconds and the graph pool's bytes). Each answers
   concurrent streaming and non-streaming POST /generate; every request
   returns its max_tokens, a repeated greedy prompt repeats its tokens (on
   the paged engine both repeats hit its first page and prefill only the
   tail), and the kernels' launch counters (kept on the card by the
   kernels, ops/launch_counts.py; zeroed just before each configuration)
   grew by n_layers per full prefill wave (flash) and per decode step (that
   configuration's decode kernel, and no other); every decode block, every
   admission wave and every tail-only wave was one graph replay and no
   graph was captured after boot (logged: replays per kind, the peak
   in-flight depth); then the main path with WARMUP=true (the reference's
   narrower set) takes one burst of 8 requests that admits a K=8 wave,
   whose graph is captured on the loop thread (logged: that stall beside
   the burst's TTFT); then
   two prefix phases, paged-prefix and paged-int8-prefix (PREFIX_CACHE=true,
   buckets 16..512), at CUT_DEPTH layers and full width: a 384-token system
   prompt seeded by one request, then 8 concurrent requests on it with
   distinct tails, each hitting its 3 pages and prefilling only its tail
   (no flash), a hit prompt served twice alike, and, logged, the tokens'
   agreement with and the TTFT of the same prompts on an engine without
   the cache;
4b. the observability planes (``obs_phase``), on the main path's engine
   after its counted run: GET /debug/engine, /debug/steps,
   /debug/requests, one /debug/requests/{id} and /debug/journey/{id},
   /debug/trace, /debug/timeline?steps=64, /debug/hostprof, /stats and
   /metrics each answer 200; the flight recorder holds every request of
   the run with the tokens its client counted; the step ledger's prefill
   and decode tokens since the run began equal the tokens delivered; the
   timeline is Perfetto JSON with an llm-engine track and device slices;
   the host profiler saw the loop; /stats says serving; the peaks are the
   card's row of the utilization table (the placeholder on a card the
   table does not hold); no MFU, MBU or duty cycle above 1.05 (logged: the
   segments' shares of the step wall, the 60 s utilization window). Under
   ``--obs`` only, then the planes' cost (``obs_cost``): the served loop's
   decode step at B=8 and a lone request's TTFT with the recorder and the
   host profiler on and off on the same engine (windows on, off, off,
   on), and the two ledgers' own host cost per step (``ledger_cost``);
4c. crash-only serving (``drill_phase``), on the same engine after 4b:
   7 greedy streams x 48 tokens (prompts of seeds no other phase uses,
   admitted in one round, the prefix cache emptied first) unfaulted, then
   again with the fault plane attached and engine.decode armed, on the
   loop thread, to raise at the first dispatch after every stream has
   delivered half its tokens: one reset, every stream replayed at prompt +
   delivered and complete with its replay ledger equal to what it got, no
   graph captured (the restore is in place), flash (the replay's
   re-prefill) and the paged read (the resumed blocks) launched; the
   streams equal the unfaulted run's token for token, or leave them at a
   bf16 tie: the unfaulted run's top-2 logit margin at the first differing
   token, from the scoring pass, under TIE_MARGIN; then a decode graph's
   draws after manual_seed of its registered generator (the reset's
   re-seed) must repeat per seed and change with it; at most 45 s;
4d. the QoS plane (``qos_phase``), on the same engine after 4c: QoS enabled
   on its App, the ladder moved only by force_level; 7 greedy batch
   streams x 64 tokens of tenant acme (prompts of one full page and a
   tail) and an interactive stream in the reserved slot, undisturbed, then
   again with preempt_batch pinned at mid-stream and 0 at the sync after:
   every batch row preempted at the first loop step at preempt_batch,
   queued again while the blocks that decoded its old row were in flight,
   re-admitted by a tail-only wave on its cached page, its stream equal to
   the undisturbed run or leaving it at a bf16 tie (TIE_MARGIN), nothing
   repeated or dropped, no graph captured, flash n_layers per full wave
   and the paged read n_layers per decode step; at shed_standard a
   standard /generate gets 503 with Retry-After and an interactive one
   200; at park_batch a batch submit waits until 0; /debug/qos and the
   app_tpu_qos_* series equal the counts; /debug/capacity bills acme; at
   most 25 s;
4e. migration (``migrate_phase``), on the same engine after 4d: 7 greedy
   streams x 48 tokens undisturbed, then again with one
   ``request_migration`` round at 16 delivered tokens whose sink takes
   every export, each landed back on the same engine through
   ``submit_handoff(blobs=...)`` (the reference's local resume): every row
   exported once with its pages, landed with no prefill and no fallback, no
   graph captured, flash n_layers a full wave and the paged read n_layers a
   decode step on both sides of the round, each stream equal to the
   undisturbed run or leaving it at a tie of at most QOS_TIE_STEPS bf16
   steps (margin logged); logged: the kv_handoff segment's share of the
   loop wall; at most 30 s;
5. timings: each kernel beside its bound, its plain version and, where one
   PyTorch call computes the same function (flash, dense bf16 decode), the
   library's scaled_dot_product_attention, at the shapes serving gave it
   (flash also in the model's layout and at 1024 and 16384; the decode
   reads also at B=8 x 8192 and B=1 x 8192), by CUDA events and, for flash,
   the decode reads and SDPA, the kernels alone (torch.profiler); the
   admission wave at each served window and the tail prefill at each tail
   wave the prefix phases gave it (beside a full-window wave of as many
   prompts), each eager and as its graph's replay: host wall, card busy
   time, host launches; TTFT / decode tok/s of the served requests, each
   with the card's name and power limit;
6. profile: the pipelined loop of each serving configuration's engine at
   B=8 in steady state (the pipeline full of graph-replayed blocks) —
   host wall time per step against the card's busy time over the same
   window (torch.profiler; beside it the wall of a window untraced, with
   the engine's metrics hook and dispatch spans as served and without
   them), the idle share, the host's launches per step and block, the
   kernels executed per step (no more than before the split reads), the
   decode read's time per step and the kernels that take it; then, on the
   same engine, the utilization ledger's decode MFU, MBU and duty cycle
   over the profiled window beside the profiler's busy share (none above
   1.05; the ledger accounts the window's blocks); then, on the
   same engine, one block replayed from its graph against the same block
   run eagerly from copies of the same state: equal greedy tokens, the KV
   left within MODEL_TOL (max_abs_diff logged), n_layers decode reads per
   step in each; the same at temperature 0.7 logged; then admission waves
   replayed from their graphs against the same waves run eagerly
   (graphcheck.prefill_graph_vs_eager): full at [1, 256] and [4, 256] and,
   paged, tail-only at [4, 256], each at temperature 0 and 0.7, with equal
   first tokens, bit-equal state and n_layers flash launches per full wave
   in both;
7. sampling controls (``serve <config> sc``, after the serve phases): the
   four configurations again with SAMPLING_CONTROLS=true and WARMUP=wide
   (two decode graphs per shape, with and without the per-row filters,
   -sc names), at CUT_DEPTH layers and full width, 7 streams and 1
   non-streaming request of 32 tokens admitted as one wave with rows
   greedy, top_k=1, top_p=1e-6, top_k=40, top_p=0.9 and both at
   temperature 0.8: counted as the serve phases are; the greedy, top_k=1
   and tiny top_p rows take the teacher-forced oracle's argmax at that
   depth wherever its top two are more than 2 * MODEL_TOL apart (a closer
   pair is a tie of the served bf16 logits, where top_k=1 keeps every tied
   token as the reference does), and score within MODEL_TOL as top-1
   (engine.score); every token of a filtered row lies in its filtered set
   by the teacher-forced logits;
7b. the OpenAI server (``openai_phase``, gofr_tpu_torch/serve_openai.py),
   on the main path's sampling-controls engine of phase 7 (CUT_DEPTH
   layers, its oracle at that depth) before its shutdown (its WARMUP=wide
   boot reused, the score windows added by
   warmup_scoring), with its metrics server (METRICS_PORT) and the memory
   trace exporter: the 7 chat prompts as 7 concurrent POST /generate
   streams, then as 7 concurrent streaming chat completions (32 tokens,
   temperature 0), then a logprobs=5 completion, an n=4 completion at
   temperature 0.8 and top_p 0.9, a 2-input /v1/embeddings call and GET
   /v1/models at once, then a chat completion with a stop string; every
   greedy request within MODEL_TOL of the teacher-forced oracle, the
   logprobs and embeddings against the oracle, flash and the paged read
   launched, every dispatch a graph replay with no capture after boot, the
   engine's app_tpu_* series on GET /metrics equal to what its requests
   did, a series of app_http_response per route, and an inbound
   traceparent's trace id back in X-Trace-Id with its tpu.generate span
   the child of the route's server span (streamed and not); logged: the
   client TTFT p50 and tok/s of the /generate and the chat streams, the
   server histograms' TTFT and TPOT p50 (Histogram.percentile), the
   phase's seconds;
8. at the end: the sort-skip (the main path's decode step at B=8 on the
   plain engine, on a sampling-controls engine with all rows greedy, which
   must run no sort and stay within 3% of the plain step's card time, and
   with one top_k row live, which shows the filters' cost), ``check sc
   graph`` on that engine (both decode variants and a -sc wave with filter
   rows, graph against eager, at temperature 0 and 0.8), and the scoring
   passes (``score``: WARMUP_SCORE's boot, score and embed at buckets
   16..512 against a full-sequence oracle within MODEL_TOL, per (S, W) the
   wall and card time and the flash launches, then 8 sequences scored and
   embedded from a second thread while 7 greedy streams decode, which must
   come out as without it, with no capture after boot).

9. checkpoints, int8 weights and the tokenizers (``w8_phase``): a
   Llama-3-8B-width checkpoint of CKPT_DEPTH layers written with
   export_llama_safetensors and
   loaded in bf16 and with weight_dtype="int8", each bit-equal to the
   exported tree (or quantize_weights of it) in its leaves and its
   logits, with its seconds, GB/s and peak card memory; llama_init_quantized
   bit-equal to quantize_weights(llama_init); phase 3's model checks on
   the int8 tree (within MODEL_TOL_W8); the main path served on the int8
   tree's first CUT_DEPTH layers (``--weights``: at full depth; ``serve
   paged-w8``, counted as phase 4's, with the capacity plan
   made from the card's memory logged), a greedy stream against the plain
   oracle on the same tree, and a byte-level tokenizer.json written from
   README.md served through VOCAB_PATH's loader on the same engine (the
   native BPE core active and equal to the Python loop, tokens/s of both);
   phase 6's profile and graph check on the int8 tree (a ``matrix
   products`` line, as for every configuration); _q_matmul's times per
   product at the decode shape beside its bound, ``_int_mm`` alone and the
   bf16 product.

10. speculative verify and chunked prefill (``spec_phase``,
   ``chunk_phase``), at the end, at CUT_DEPTH layers (``--spec``: at full
   depth): the main path with SPECULATIVE_TOKENS=4 and
   WARMUP=true (verify graphs per table width), 7 greedy streams x 48
   tokens and 1 non-streaming request, every other prompt a repeated
   passage, then the same traffic with speculation off on the same engine:
   verifies, drafted and accepted tokens per eligible row, cooloffs and
   zero-draft rounds, the flash and paged-read launches, TTFT and tok/s;
   every stream against the teacher-forced oracle within MODEL_TOL, no
   capture after boot, pages released; a hand-driven B=8 spec engine's
   verify graph against eager (graphcheck.verify_graph_vs_eager), a
   verify's wall and card time against a decode step's, its parts by
   events (page gather, plain einsum, lm_head as one product and per
   position); the dense spec engine at 4 layers against its oracle; then
   CHUNK_PREFILL_TOKENS=256 with MAX_SEQ_LEN=2048 and buckets 16..1024: a
   900-token prompt arriving while 6 streams decode, its TTFT and the
   streams' largest gap between tokens, chunked and not (the same engine),
   the long stream against the oracle, the middle and final chunk graphs
   against eager (graphcheck.chunk_graph_vs_eager), and the int8-KV paged
   engine's chunks (the q8-final program) once.

11. crash-only serving and the incident plane (``--faults``,
   ``faults_phase``): the main path's engine booted with FAULT_INJECTION,
   BREAKER_COOLDOWN_S=1 and a temporary INCIDENT_DIR / PROFILE_DIR: a reset
   storm armed over POST /debug/faults (3 raises, 2 requests in flight)
   opens the breaker (503 with Retry-After on /generate, the engine's
   health DOWN), the half-open probe closes it, the requests complete
   through their replays and a new one gets 201; a request alone across two
   resets is quarantined; the breaker_open incident bundle holds the step
   ring, the /debug/engine payload, the slowest requests, the recorder's
   events and the config fingerprint, written under INCIDENT_DIR;
   /debug/capacity conserves against /debug/steps; the planes' cost
   (``planes_cost``): the served decode step and a lone TTFT with the SLO
   burn engine, the meter and the finisher on against all three off
   (windows on, off, off, on), before any profile in the process; last, a
   2 s POST /debug/profile capture (the route enabled on this phase's App:
   the servers serve none; its window from the moment it records)
   while 2 streams x 17 tokens are admitted and decode holds flash and
   paged-read kernel events (graph replays), and beside this script's own
   torch.profiler a capture is refused in last_error; no graph captured
   after boot.

12. the QoS plane (``--qos``, ``qos_mode_phase``): the main path's engine
   booted with qos_env (QOS=true, a 1 ms TTFT target, 5 s burn windows,
   0.3 s / 0.5 s ladder holds, QOS_BATCH_PAGE_FRACTION=0.1,
   QOS_DEADLINE_STANDARD_S=0.5): the ladder climbs on the real burn engine
   to shed_standard (503 + Retry-After for standard, interactive served,
   /stats asking for a replica) and walks back to ok once the target is
   relaxed; the preemption figures (an interactive request's TTFT with the
   7 batch rows decoding and with them preempted, the batch streams'
   largest gap between tokens, the re-admission waves' card time, the qos
   segment's share of the loop steps), streams equal or at a tie; batch
   parked at its page share; a queued standard request expiring with 503;
   the OpenAI server's classes and tenants over headers in /debug/qos and
   /debug/capacity; then the dense engine (PAGED=false DECODE_ATTN=kernel)
   at CUT_DEPTH layers preempting and re-admitting its batch rows (full
   waves), counted and held as phase 4d. Every figure with the card's name
   and power limit.

13. the KV tier, the disaggregated pair, migration over HTTP and the warm
   boot (``--elastic``, ``elastic_phase``), at full width and depth,
   WARMUP=wide, no graph captured after any boot: 13a (``tier_phase``) a
   paged engine with N_PAGES=12 and a host tier seeds a 384-token system
   prompt, serves a probe on its 3 resident pages (the unspilled run),
   runs other prompts until they are spilled, then serves the probe again:
   3 pages restored by one copy under kv_restore, a tail-only wave, the
   stream equal to the unspilled run token for token; spilled, restored and
   hit counts; the restore's card ms by events beside the tail prefill over
   the same pages and the full prefill it saves; int8 KV first, then bf16
   over a shared in-process cold store (a host tier of 4 pages, so the
   spills go on to it); 13d (``warm_boot_phase``) an App with
   ELASTIC_WARM_BOOT=true and the bf16 tier's App as its peer: /stats
   warming then serving with warm_boot_s, the system pages pre-warmed from
   the shared store, the first request on them a tier hit with the peer's
   tokens; 13b (``pair_phase``) DISAGG_MODE=both over one params tree:
   7 streams + 1 non-streaming request through /generate, every request
   handed off, 0 fallbacks, no prefill on the decode pool, flash n_layers a
   wave on the prefill pool and the paged read n_layers a step on the
   decode pool, streams against a colocated App's (or at a tie), client
   TTFT p50 and tok/s beside it, the pair's card memory; 13c the colocated
   App drained over POST /debug/drain into the pair's App: every session
   shipped, the relay's first-token gap, streams across the hop equal or at
   a tie; a refused peer degrades to local_resume with the stream complete.

14. training (``--train``, ``train_phase``): the gradient check at
   [1, 2048] and [2, 2048] (H=32, Hkv=8, dh=128, bf16): the port's
   ``FlashAttention`` (the kernel forward, the oracle's VJP backward)
   against torch.autograd.grad through attention_reference (GRAD_RTOL, the
   bit-equal share logged), its forward against the plain version, the
   backward's recompute ms a layer; Llama-3-8B at full width and
   TRAIN_DEPTH of 32 layers (random weights, seed 0), B=2, T=2048,
   ATTN_IMPL=flash, remat on, the reference's AdamW, TRAIN_STEPS steps on
   one batch: per step loss, grad norm, wall and card ms, tokens/s, MFU,
   peak memory and the flash launches counted on the card, which must be 2
   per layer (the forward and remat's recompute), the loss falling; the
   update's ms; flash's own times at [2, 2048] beside its bound, its plain
   version and SDPA; a 2-layer step with the kernel against the same step
   with the oracle (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL); a checkpoint
   resume (2 layers, saved at step 3 of 6, restored into fresh tensors,
   bit-equal on restore, the final params within RESUME_ATOL of the
   uninterrupted run under deterministic algorithms); the MoE at
   Llama-3-8B widths (2 layers, 8 experts, top-2, B=1, T=1024), its loss
   falling, aux finite, 4 flash launches a step. Every figure with the
   depth and the card's name and power limit.

15. the batcher servers (``--models``, ``models_phase``):
   ``serve_mnist`` and ``serve_bert`` (BERT_PRESET=base, 768 wide, 12
   layers) booted on the card with their reference warm-ups, then every
   (batch, sequence) program they can reach captured; 64 concurrent
   /predict bodies and 64 /embed texts of mixed lengths, each answer
   against the same example's unbatched forward on the card (MNIST_TOL;
   BERT_TOL and BERT_COS), embeddings of unit norm, a text alone and
   padded into the largest bucket alike, batches larger than 1 formed, no
   capture after the warm-up; client p50 / p99 and the batches by program.

The default run ends with phases 14 and 15 in short
(``short_train_models_phase``): the gradient check at [1, 1024], 2 steps
of a 2-layer full-width Llama with the launch check, and 8 /predict and 8
/embed on the debug presets; the kernels JSON's flash launches count
training's too (``train_launches``).

16. parallelism (``--parallel``, ``parallel_mode``; ROADMAP A14a): the
   process joins a one-rank NCCL job through the JAX_* keys and builds the
   five-axis mesh; (a) the paged engine on that tp=1 mesh and the engine
   without a mesh, Llama-3-8B whole (PAR_DEPTH), WARMUP=wide at boot, one
   greedy burst of 8 x 48 tokens: no capture after boot, flash and the
   paged read launched, 64 all-reduces and 1 all-gather per decode step
   (inside the graphs), the streams equal token for token, and the decode
   step's card busy ms at B=8 (with its NCCL kernels) on both; (d)
   sp_llama_forward at sp=1, ring and Ulysses, against
   llama_forward_nocache at 4 layers [1, 256] and 32 layers [1, 1024]
   (SP_TOL), Ulysses launching flash once a layer; (c) flash and the four
   reads at the heads one rank holds (RANK_HEADS: Llama-3-8B and
   Llama-3-70B at tp = 2, 4, 8; Ulysses' G = 1), each against its plain
   version, launched, timed beside its plain version and its bound; (b)
   two processes on the card, each with its own engine (4 layers), rank 0
   the HTTP ingress and rank 1 replaying its waves over a TCPStore, 6
   staggered streams with one client leaving mid-stream: rank 1's streams
   equal rank 0's token for token, the cancelled one cut at the same
   token; (e) with n > 1 cards visible, run first: TP=n serving through
   serve.py (TP_SHARDS), 8 concurrent streams held to the teacher-forced
   oracle, with the client's TTFT and tok/s per stream, then the App's
   shutdown, bounded (``shutdown_bounded``, ROADMAP C8), every follower
   joined with exit code 0.
17. sharded training (``--sharded-train``, ``sharded_train_mode``; ROADMAP
   A14b): with n >= 2 cards, one process a card joined into an NCCL job
   through the JAX_* keys, every rank drawing the weights from seed 0 and
   running ``make_train_step(..., mesh=)`` on its blocks: A, dense
   Llama-3-8B whole over dp = n/2 x tp = 2 (B=n, T=2048, remat on); B, the
   MoE at Llama-3-8B widths, 8 experts top-2, over ep = n (ST_MOE_DEPTH
   layers, B=2, T=1024); C, GPipe over pp = n (32 layers, 4 microbatches,
   B=8, T=1024, remat off) with its bubble beside (pp-1)/(n_micro+pp-1);
   D, ring over sp = n (TRAIN_DEPTH layers, B=1, T=8192). A, B and C
   are held at TRAIN_DEPTH layers to rank 0's single-card step (loss
   ST_LOSS_RTOL, grad_norm ST_GNORM_RTOL), D's first loss to the single
   card's flash forward; flash is held to its plain version at A, B and
   C's per-rank shapes on every rank; per step: loss, wall and card
   ms, tokens/s a card, MFU against n x 989e12, peak memory and flash
   launches on every rank, the NCCL kernels of a step on rank 0
   (torch.profiler); the loss must fall; then every rank leaves the job
   (stamped) and exits 0 within ST_LEAVE_S. With one card: the
   world-of-one check below alone.

18. the open-loop load client, the datasources, pub/sub and the QoS batch
   lane (``--loadgen``, ``loadgen_phase``; ROADMAP A18b parts 1-3): the
   main path's engine at full depth with WARMUP=wide, QOS=true,
   PUBSUB_BACKEND=inproc, a sqlite DB_PATH and KV_ENABLED
   (``loadgen_env``); /.well-known/health lists sql, kv and pubsub UP and
   a handler's SQL and KV round trip answers; a closed burst of LG_BURST
   arrivals measures the throughput; a seeded Poisson trace
   (``loadgen.synthesize``: 3 zipf tenants, all three classes, session
   reuse) at LG_RATE_SHARE of it through ``OpenLoopRunner`` against POST
   /generate, every row ok with its full token count, the worst dispatch
   lag within LG_LAG_SHARE of the mean gap, flash and paged-read launches
   in the window, the scorecard's per-class TTFT p50 / p95, TPOT p50 and
   goodput; the replica's GET /debug/trace replayed and compared (no check
   but slo_met may regress); LG_JOBS greedy jobs through the batch lane
   beside interactive streams (results in order, each before its commit,
   none delivered twice, each held to the teacher-forced plain oracle
   within MODEL_TOL), lane.stats(), app_tpu_qos_lane_depth and one crontab
   tick of the drain kick; then the knee (``loadgen.run_knee``) from 0.3x
   to LG_KNEE_UP x the throughput, polling /debug/capacity, which must
   report ``agrees``. The default run runs it short after phase 10, at
   CUT_DEPTH layers with WARMUP=true: 4 s of arrivals and 4 jobs, no
   replay and no knee; its flash and paged-read launches join the kernels
   JSON as ``loadgen_launches``.

19. the fleet router tier (``--fleet``, ``fleet_phase``; ROADMAP A18b part
   4): two replicas of the main path in this process (``serve.build_app``
   over one params tree, full depth, WARMUP=wide, QoS, the prefix cache,
   HBM_BUDGET_BYTES of FL_BUDGET each, ``fleet_env``) behind the port's
   router (``serve_router.build_app``, ``router_env``): FL_SESSIONS
   sessions, each a 384-token system prompt of its own and FL_TURNS
   greedy turns, concurrent: every turn of a session on one replica (read
   from its journey's hops), both replicas used, the landing replicas'
   prefix-cache hits up, every stream what its replica delivered and
   within MODEL_TOL of the teacher-forced oracle, and, sent again straight
   to its replica, the same stream or one leaving it at a bf16 tie
   (``check_ties``); /debug/fleet's affinity hit rate and in-flight; a
   closed burst's throughput through the router and the seeded open loop
   at LG_RATE_SHARE of it (every row ok and full, the scorecard per
   class), the router's GET /debug/trace (classes and tenants kept)
   replayed and compared (no check but slo_met may regress); the knee
   through the router polling /debug/fleet/capacity (``agrees``,
   replicas_needed an integer >= 1, quiet and at the peak rho); one
   request's journey (router and replica hops), stitched timeline (>= 2
   pids, the replica's flow events inside the router's route-to-finish
   window) and /debug/fleet/slo (both replicas); the fail-over
   (``fl_failover``): FL_FAIL_STREAMS streams, then r1's listener closed, a
   turn pinned to r1 by affinity retried unstarted on r0 and complete, and
   r1 shut down with DRAIN_TIMEOUT=0 as a crash: none sent twice, each
   client's tokens what its replica delivered, each stream broken on r1 a
   prefix ending in a stream_break hop, /.well-known/health DEGRADED and
   r1 ejected in /debug/fleet; r1 booted again on its port (WARMUP=true),
   probed back in and taking a request; then the autoscaler
   (``fl_autoscale``): a router over r0 alone with ELASTIC on,
   ELASTIC_LAUNCHER=subprocess, ELASTIC_LAUNCH_CMD="python -m
   gofr_tpu_torch.serve", min 1, max 2: demand launches exactly one
   replica, a process of its own on the card (its memory in
   mem_get_info), routable once its /stats says serving; FL_LONG_STREAMS
   streams then start, at least one on it; calm drains it with its live
   sessions migrated to r0, every stream complete and within MODEL_TOL of
   the oracle; the child exits and its card memory is freed. The default
   run runs it short (``fleet_short``) inside phase 18's short phase: the
   router over that server and one more CUT_DEPTH replica, 2 sessions of 2
   turns, a turn pinned to the second replica retried unstarted on the
   first after its listener closed, and that request's journey; its flash
   and paged-read launches join the kernels JSON as ``fleet_launches``.

20. the serving surfaces and the device client (``--surfaces``,
   ``surfaces_phase``): the main path's server (full depth, WARMUP=wide,
   the prefix cache off, SAMPLING_CONTROLS on) with gRPC on a free port,
   TPU_ENABLED, FAULT_INJECTION, REMOTE_LOG_URL on a local stub and an
   API key (``enable_api_key_auth``); its device client built first and
   probed on a thread all through the boot's captures (every probe UP);
   /generate without the key 401, /.well-known/health without one (tpu UP
   with the card's memory); SF_SEQUENTIAL prompts alone over SSE and then
   gRPC ``llm.Generator/Generate``, the texts equal; 8 concurrent gRPC
   streams (131-251-token prompts, 32 tokens) held to the oracle within
   MODEL_TOL, the same 8 over SSE, each transport's client TTFT, TPOT and
   tok/s; top_k=1 at temperature 1 against greedy (a difference only at
   a bf16 tie); an empty prompt INVALID_ARGUMENT; a stream cancelled
   after 4 messages, its slot and pages back; the flash and paged-read
   launches above 0 and no capture after boot; a device.health_probe
   wedge through /debug/faults DEGRADED within the probe's timeout, then
   UP; the App's level following the stub to DEBUG and back within one
   interval; bert-embed (BERT-base) Embed over gRPC equal to /embed; two
   ``python -m gofr_tpu_torch.serve_mnist`` ranks joined over gloo on the
   card, each answering /predict, both exiting 0 on SIGINT. Without grpc
   on the machine, a line says so and the gRPC checks are skipped. The
   default run runs it short at CUT_DEPTH layers (WARMUP=true): two
   prompts over SSE and gRPC, the 401, the empty prompt, the cancel, the
   probe wedge; its launches join the kernels JSON as
   ``surfaces_launches``, those of its gRPC runs as ``grpc_launches``.

The default run ends, after them, with phase 16 in short
(``parallel_short``): (a) at CUT_DEPTH layers (4 streams x 16 tokens, no
step profile) and (d) at [1, 128]; and phase 17 in short
(``sharded_short``): a one-rank NCCL job at CUT_DEPTH layers where flash
is held to its plain version at the phase's shape, the sharded step equals
the unsharded one bit for bit over 2 steps (its flash
launches join the kernels JSON as ``sharded_launches``) and the pipelined
forward at pp=1 gives the plain forward's logits.

The last three lines are the nvidia-smi line, the kernels JSON and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import json
import math
import re
import socket
import sys
import threading
import time

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, the same sheet
H100_HBM_BYTES_S = 3.35e12
# a kernel agrees with its plain version when every output element is within
# RTOL * |want| + ATOL_RMS * rms(want): both are bf16 roundings of f32
# results, which may sit one bf16 ulp (at most 2**-7 = 7.8e-3 of the value)
# apart, and the floor for outputs near 0 scales with the case's own outputs
# (|o| ~ 0.01 at S=16384, ~1 on early causal rows). Flash takes that floor
# per query row: both sides round p to bf16 before p . v (as the Pallas
# kernels do) from scores summed in different orders, so now and then one p
# rounds to the other side of a bf16 midpoint, which moves an early causal
# row's outputs (a few keys, one of them heavy) by up to ~2**-8 of that row's
# own scale, more than the case-wide floor of a long window
# (0.01 * rms = 3.7e-4 at 16384)
RTOL = 1e-2
ATOL_RMS = 1e-2
MODEL_TOL = 0.25             # bf16 logits after 32 layers, see check_model
# the same on int8 weights: every product re-quantizes its activations to
# 1/127 of each row's absmax, so a bf16 difference between two attention
# paths can move a code by one and the logits further (0.319 on the paged
# decode step's check on an NVIDIA H100 80GB HBM3 at 700 W)
MODEL_TOL_W8 = 0.5
DENSE_S = 1024               # the dense cache of phase 2's checks
# the servers' config: their logs at WARN and above (an INFO line per
# request would bury the phases' lines)
QUIET = {"LOG_LEVEL": "WARN"}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def have_module(name: str) -> bool:
    """Whether `name` can be imported here (found, not imported)."""
    import importlib.util

    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def grpc_env() -> dict:
    """GRPC_PORT=0 where grpc imports: a server that registers a gRPC
    service (the llm-server, bert-embed) binds a free port, never the
    default 9000, which two servers of one phase would share. Nothing where
    it does not import: a set GRPC_PORT without grpc fails the start."""
    return {"GRPC_PORT": "0"} if have_module("grpc") else {}


# -- phase 1: the build ---------------------------------------------------------
# a decode read's instantiation in a mangled kernel name: element type, dh,
# G, addressing
SPLIT_NAME = re.compile(r"(Kv(?:Bf16|Int8))ELi(\d+)ELi(\d+)ENS_\d+(Paged|Dense)")


def build_report(name: str, _build) -> None:
    """Log source `name`'s ptxas report (registers and spill bytes per
    kernel; the decode reads per element type and instantiation) and, from
    cuobjdump's SASS, the int -> float conversions in each decode read
    (I2F / I2FP), apart from the reciprocal seeds (I2F.*.RP) of integer
    division; fails when an int8 read converts its elements that way."""
    import subprocess
    from pathlib import Path

    lib = _build.target(name)
    text = lib.with_suffix(".log").read_text()
    regs, spills, groups = [], 0, {}
    for entry in text.split("Compiling entry function")[1:]:
        r = re.search(r"Used (\d+) registers", entry)
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       entry)
        n = int(r.group(1)) if r else 0
        regs.append(n)
        spills += int(sp.group(1)) + int(sp.group(2)) if sp else 0
        m = SPLIT_NAME.search(entry.split("'")[1] if "'" in entry else "")
        if m:
            groups.setdefault(m.group(1), []).append(
                f"{m.group(4)[0]}{m.group(2)}g{m.group(3)}:{n}")
    log(f"build {name}: {len(regs)} kernels, registers "
        f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")
    for kind, items in sorted(groups.items()):
        log(f"build {name} {kind} registers (P/D dh gG:regs): "
            f"{' '.join(sorted(items))}")
    if not groups:
        return
    exe = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(exe), "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    conv = {}
    for func in sass.split("Function : ")[1:]:
        m = SPLIT_NAME.search(func.split(None, 1)[0])
        if not m:
            continue
        ops = re.findall(r"\b(I2FP?(?:\.[A-Z0-9_.]+)?)\s", func)
        seeds = sum(op.endswith(".RP") or ".RP." in op for op in ops)
        total = conv.setdefault(m.group(1), [0, 0, 0])
        total[0] += 1
        total[1] += len(ops) - seeds
        total[2] += seeds
    for kind, (n, other, seeds) in sorted(conv.items()):
        log(f"sass {name} {kind}: {n} kernels, int->float conversions "
            f"{other} (besides {seeds} I2F.RP seeds of integer division)")
    require(conv.get("KvInt8", [0, 0])[0] > 0,
            f"{name}: no int8 decode read in the SASS")
    require(conv["KvInt8"][1] == 0,
            f"{name}: the int8 decode read converts with I2F")


# -- phase 2: kernels against their plain versions ---------------------------
def agreement(got, want, per_row=False):
    """(max_abs_err, rms(want), worst, where) with worst the largest
    |got - want| / (ATOL_RMS * rms + RTOL * |want|) over the elements, at
    index `where`; rms is over the whole case, or with per_row over each
    output row (the last dim). The kernel agrees where worst <= 1 and every
    output is finite."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    sq = w.square()
    rms = (sq.mean(-1, keepdim=True) if per_row else sq.mean()).sqrt()
    limit = (ATOL_RMS * rms + RTOL * w.abs()).clamp_min(1e-30)
    ratio = err / limit
    at = int(ratio.argmax())
    where = tuple(int(i) for i in torch.unravel_index(torch.tensor(at),
                                                      ratio.shape))
    worst = float(ratio.flatten()[at])
    if not bool(torch.isfinite(g).all()):
        worst = math.inf
    return float(err.max()), float(sq.mean().sqrt()), worst, where


def check_agreement(what: str, got, want, per_row=False) -> float:
    err, rms, worst, where = agreement(got, want, per_row)
    ok = worst <= 1.0
    floor = "rms of its row" if per_row else "rms"
    log(f"check {what}: max_abs_err={err:.3e} rms(want)={rms:.3e} "
        f"worst err/tol={worst:.3f} at {list(where)} (got "
        f"{float(got[where]):.6f} want {float(want[where]):.6f}) (tol "
        f"{RTOL}*|want| + {ATOL_RMS}*{floor}) {'ok' if ok else 'FAIL'}")
    if per_row:
        log(f"check {what}: with the case-wide rms floor instead, worst "
            f"err/tol={agreement(got, want)[2]:.3f}")
    require(ok, f"kernel disagrees with its plain version: {what}")
    return err


def _randn(shape, gen, dev):
    import torch

    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(torch.bfloat16)


def flash_inputs(B, H, Hkv, T, S, dh, dev, seed=0):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, H, T, dh), gen, dev), _randn((B, Hkv, S, dh), gen, dev),
            _randn((B, Hkv, S, dh), gen, dev))


def paged_inputs(lengths, H, Hkv, dh, ps, dev, seed=0):
    """q, pools, a table of distinct random live pages with zero tails
    (width pow2(widest + 1), as the engine builds it), lengths."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    need = [max(1, -(-n // ps)) for n in lengths]
    NP = 1 << max(0, max(need)).bit_length()
    P = sum(need) + 1
    perm = torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32) + 1
    table = torch.zeros((B, NP), dtype=torch.int32, device=dev)
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[off:off + n]
        off += n
    return (_randn((B, H, dh), gen, dev), _randn((P, Hkv, dh, ps), gen, dev),
            _randn((P, Hkv, dh, ps), gen, dev), table,
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def dense_inputs(lengths, H, Hkv, dh, S, dev, seed=0):
    """q, a dense [B, Hkv, dh, S] k and v cache, lengths."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    return (_randn((B, H, dh), gen, dev), _randn((B, Hkv, dh, S), gen, dev),
            _randn((B, Hkv, dh, S), gen, dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def check_flash(dev) -> None:
    """The flash kernel against its plain version: H=32, Hkv=8 at the
    listed (T, S, dh, causal), then the served [4, 256] window in the
    model's [B, T, H, dh] layout through flash_attention (strided reads and
    writes, no copies)."""
    import torch

    from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                    flash_attention,
                                                    flash_attention_cuda,
                                                    flash_attention_plain)

    for T, S, dh, causal in [(128, 128, 128, True), (128, 128, 128, False),
                             (80, 80, 128, True), (200, 333, 128, False),
                             (1000, 1000, 128, True), (1000, 1000, 128, False),
                             (16384, 16384, 128, True),
                             (16384, 16384, 128, False),
                             (256, 256, 64, True), (200, 333, 64, False)]:
        q, k, v = flash_inputs(1, 32, 8, T, S, dh, dev, seed=T + dh)
        got = flash_attention_cuda(q, k, v, causal)
        want = flash_attention_plain(q, k, v, causal, KERNEL_BLOCK_KV)
        what = f"T=S={T}" if T == S else f"T={T} S={S}"
        check_agreement(f"flash {what} dh={dh} causal={causal}", got, want,
                        per_row=True)
        del q, k, v, got, want
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in flash_inputs(4, 32, 8, 256, 256, 128, dev, seed=4))
    got = flash_attention(q, k, v, True)
    require(got.shape == q.shape and got.is_contiguous(),
            "flash_attention: output is not a contiguous [B, T, H, dh]")
    want = flash_attention_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                                 True, KERNEL_BLOCK_KV).transpose(1, 2)
    check_agreement("flash B=4 T=S=256 causal, [B, T, H, dh] views in and "
                    "out", got, want, per_row=True)
    torch.cuda.empty_cache()


def check_split(dev) -> None:
    """The split reads (decode_split.cuh), bf16 and int8, where the split
    matters: many blocks per row (B=1 at 8192; B=8 ragged up to 8192 with
    lengths at a unit boundary and one past it, at the end of the first
    round of units and one past it, short rows whose later blocks start past
    their length), page sizes 16 and 128, dense S=8192, S=1000 and S=1001
    (rows not 16-byte aligned) with lengths 0, S and S + 1; each call is made
    twice and must give the same bits (the block that combines a row resets
    its counter), and a row of length 0 gives zeros. bf16 is held against
    the gather reference (paged) or the plain version (dense), int8 against
    the plain versions with scales."""
    import torch

    from gofr_tpu_torch.ops.decode_attention import (SPLIT_TILE,
                                                     SPLIT_TILE_Q8,
                                                     decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     plan_split, quantize_kv)
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda,
                                                    paged_attention_reference)

    H, Hkv, dh = 32, 8, 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def twice(what, fn):
        first = fn()
        require(torch.equal(first, fn()),
                f"{what}: two calls in a row differ (counters not reset?)")
        return first

    for quantized in (False, True):
        kind, tile = (("-int8", SPLIT_TILE_Q8) if quantized else
                      ("", SPLIT_TILE))
        for ps in (16, 128):
            NP = 1 << (-(-8192 // ps)).bit_length()   # as paged_inputs builds it
            for B in (1, 8):
                nsplit, unit = plan_split(B, Hkv, NP * ps, ps, sms, tile)
                lengths = ([8192] if B == 1 else
                           [unit, unit + 1, nsplit * unit, nsplit * unit + 1,
                            8192, 1, 100, 700])
                q, kp, vp, table, lens = paged_inputs(lengths, H, Hkv, dh, ps,
                                                      dev, seed=ps + B)
                if quantized:
                    (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)

                    def read(n):
                        return paged_attention_q8_cuda(q, k8, v8, ks, vs,
                                                       table, n)
                    want = paged_attention_plain(q, k8, v8, table, lens, ks,
                                                 vs)
                else:
                    def read(n):
                        return paged_attention_cuda(q, kp, vp, table, n)
                    want = paged_attention_reference(q, kp, vp, table, lens)
                what = (f"paged{kind} split ps={ps} B={B} nsplit={nsplit} "
                        f"unit={unit} lengths={lengths}")
                check_agreement(what, twice(what, lambda: read(lens)), want)
                zero = lens.clone()
                zero[-1] = 0
                require(bool((read(zero)[-1] == 0).all()),
                        f"{what}: length 0 is not zeros")
                del q, kp, vp, table, lens, want
        for S, B in ((8192, 1), (8192, 8), (1000, 8), (1001, 8)):
            nsplit, unit = plan_split(B, Hkv, S, None, sms, tile)
            lengths = ([S] if B == 1 else
                       [unit, unit + 1, nsplit * unit, nsplit * unit + 1, S,
                        S + 1, 0, 1])
            q, k, v, lens = dense_inputs(lengths, H, Hkv, dh, S, dev,
                                         seed=S + B)
            if quantized:
                (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)

                def read(n):
                    return decode_attention_q8_cuda(q, k8, v8, ks, vs, n)
                want = decode_attention_plain(q, k8, v8, lens, ks, vs)
            else:
                def read(n):
                    return decode_attention_cuda(q, k, v, n)
                want = decode_attention_plain(q, k, v, lens)
            what = (f"decode{kind} split S={S} B={B} nsplit={nsplit} "
                    f"unit={unit} lengths={lengths}")
            got = twice(what, lambda: read(lens))
            check_agreement(what, got, want)
            if B > 1:
                require(bool((got[6] == 0).all()),
                        f"{what}: length 0 is not zeros")
                clamped = lens.clone()
                clamped[5] = S
                require(torch.equal(read(clamped)[5], got[5]),
                        f"{what}: length S+1 does not read as S")
            del q, k, v, lens, got, want
    torch.cuda.empty_cache()


def check_kernels(dev) -> None:
    check_flash(dev)
    check_decode(dev)


def check_decode(dev) -> None:
    from gofr_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     quantize_kv)
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda,
                                                    paged_attention_reference)

    for ps in (16, 128):
        lengths = [1, ps - 1, ps, ps + 1, 2 * ps + 3, 5 * ps, 700, 1000]
        q, kp, vp, table, lens = paged_inputs(lengths, 32, 8, 128, ps, dev,
                                              seed=ps)
        got = paged_attention_cuda(q, kp, vp, table, lens)
        want = paged_attention_reference(q, kp, vp, table, lens)
        check_agreement(f"paged ps={ps} lengths={lengths}", got, want)
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
        check_agreement(f"paged-int8 ps={ps} lengths={lengths}",
                        paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens),
                        paged_attention_plain(q, k8, v8, table, lens, ks, vs))
        lens[3] = 0
        zero = paged_attention_cuda(q, kp, vp, table, lens)[3]
        require(bool((zero == 0).all()), "paged kernel: length 0 is not zeros")
        zero = paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)[3]
        require(bool((zero == 0).all()),
                "paged-int8 kernel: length 0 is not zeros")
    log("check paged and paged-int8 length=0 row: zeros ok")
    S = DENSE_S
    lengths = [0, 1, 127, 128, 129, 700, S, S + 1]
    q, k, v, lens = dense_inputs(lengths, 32, 8, 128, S, dev, seed=11)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    fp = decode_attention_cuda(q, k, v, lens)
    q8 = decode_attention_q8_cuda(q, k8, v8, ks, vs, lens)
    check_agreement(f"decode S={S} lengths={lengths}", fp,
                    decode_attention_plain(q, k, v, lens))
    check_agreement(f"decode-int8 S={S} lengths={lengths}", q8,
                    decode_attention_plain(q, k8, v8, lens, ks, vs))
    require(bool((fp[0] == 0).all()) and bool((q8[0] == 0).all()),
            "decode kernels: length 0 is not zeros")
    lens[-1] = S
    require(bool((decode_attention_cuda(q, k, v, lens)[-1] == fp[-1]).all())
            and bool((decode_attention_q8_cuda(q, k8, v8, ks, vs, lens)[-1]
                      == q8[-1]).all()),
            "decode kernels: a length past S does not read as S")
    log("check decode and decode-int8 length=0 row: zeros; length S+1 reads "
        "as S: ok")
    check_split(dev)


# -- phase 3: the model on the card ------------------------------------------
def check_model(params, cfg, dev, tol: float = MODEL_TOL) -> None:
    """Prefill a prompt (flash) and take ONE decode step through each
    decode path from its KV: paged and dense (decode kernel) against a full
    recompute of prompt + token through plain masked attention; dense int8
    and paged int8 against a plain step (plain masked read) over the same
    int8 cache, dequantized to bf16. The tolerance is on the max abs logit
    difference: bf16 activations through 32 layers on two different
    attention paths (logits are O(1) here); `tol` is MODEL_TOL_W8 on an
    int8 tree."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import (llama_decode_step_paged,
                                             llama_decode_step_paged_q8,
                                             llama_decode_step_unrolled,
                                             llama_decode_step_unrolled_q8,
                                             llama_prefill_last)
    from gofr_tpu_torch.ops.decode_attention import quantize_kv
    from gofr_tpu_torch.ops.paged_attention import (paged_write_prefill_scales,
                                                    paged_write_prefill_stacked)

    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n, ps, S = 100, 128, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)

    def prefill(tokens, c):
        T = tokens.shape[1]
        tk = torch.zeros((L, 1, Hkv, dh, T), dtype=torch.bfloat16, device=dev)
        tv = torch.zeros_like(tk)
        pos = torch.arange(T, device=dev)[None]
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        logits, tk, tv = llama_prefill_last(params, c, tokens, pos, lens, tk, tv)
        return logits, tk, tv, lens

    def dense(tmp, dtype):
        """Per-layer [1, ..., S] buffers holding `tmp`'s n tokens."""
        out = []
        for l in range(L):
            buf = torch.zeros((*tmp.shape[1:-1], S), dtype=dtype, device=dev)
            buf[..., :n] = tmp[l]
            out.append(buf)
        return out

    def check(what, got, want) -> None:
        torch.cuda.synchronize()
        require(tuple(got.shape) == (1, cfg.vocab_size), f"{what}: shape")
        require(bool(torch.isfinite(got).all()), f"{what}: not finite")
        diff = float((got - want).abs().max())
        log(f"check model: {what}: max_abs_diff={diff:.3e} (max |logit| "
            f"{float(want.abs().max()):.3f}) tol={tol} "
            f"{'ok' if diff <= tol else 'FAIL'}")
        require(diff <= tol, f"{what}: disagrees")

    flash = dataclasses.replace(cfg, attn_impl="flash")
    plain = dataclasses.replace(cfg, attn_impl="xla", decode_attn="xla")
    kernel = dataclasses.replace(cfg, decode_attn="kernel")
    logits0, tk, tv, lens = prefill(prompt, flash)
    nxt = int(torch.argmax(logits0[0]))
    tok = torch.tensor([nxt], device=dev)
    pos = torch.tensor([n], device=dev)
    full = torch.cat([prompt, torch.tensor([[nxt]], device=dev)], dim=1)
    want, _, _, _ = prefill(full, plain)

    pool_k = torch.zeros((L, 3, Hkv, dh, ps), dtype=torch.bfloat16, device=dev)
    pool_v = torch.zeros_like(pool_k)
    ptable = torch.tensor([[1]], dtype=torch.int32, device=dev)
    paged_write_prefill_stacked(pool_k, pool_v, tk, tv, ptable, lens)
    table = torch.tensor([[1, 0]], dtype=torch.int32, device=dev)
    step, _, _ = llama_decode_step_paged(params, cfg, tok, pos, pool_k,
                                         pool_v, table)
    check("paged decode step vs plain recompute", step, want)
    step, _, _ = llama_decode_step_unrolled(
        params, kernel, tok, pos, dense(tk, torch.bfloat16),
        dense(tv, torch.bfloat16))
    check("dense decode step (decode kernel) vs plain recompute", step, want)

    # int8: the same prefill KV quantized per token and head
    (k8, ks), (v8, vs) = quantize_kv(tk), quantize_kv(tv)
    deq_k = (k8.float() * ks[:, :, :, None, :]).to(torch.bfloat16)
    deq_v = (v8.float() * vs[:, :, :, None, :]).to(torch.bfloat16)
    want_q8, _, _ = llama_decode_step_unrolled(
        params, plain, tok, pos, dense(deq_k, torch.bfloat16),
        dense(deq_v, torch.bfloat16))
    step = llama_decode_step_unrolled_q8(
        params, kernel, tok, pos, dense(k8, torch.int8), dense(v8, torch.int8),
        dense(ks, torch.float32), dense(vs, torch.float32))[0]
    check("dense int8 decode step vs plain step over the dequantized cache",
          step, want_q8)
    pool_k = torch.zeros((L, 3, Hkv, dh, ps), dtype=torch.int8, device=dev)
    pool_v = torch.zeros_like(pool_k)
    pool_ks = torch.zeros((L, 3, Hkv, ps), dtype=torch.float32, device=dev)
    pool_vs = torch.zeros_like(pool_ks)
    paged_write_prefill_stacked(pool_k, pool_v, k8, v8, ptable, lens)
    paged_write_prefill_scales(pool_ks, ks, ptable, lens)
    paged_write_prefill_scales(pool_vs, vs, ptable, lens)
    step = llama_decode_step_paged_q8(params, cfg, tok, pos, pool_k, pool_v,
                                      pool_ks, pool_vs, table)[0]
    check("paged int8 decode step vs plain step over the dequantized cache",
          step, want_q8)
    del pool_k, pool_v, pool_ks, pool_vs
    check_prefix(params, cfg, dev, check)


def check_prefix(params, cfg, dev, check) -> None:
    """The prefix cache's tail prefill at full width and depth: a 300-token
    prompt prefilled with flash into pages 1-3 of a pool (two full pages and
    a tail), then the 44-token tail prefilled again over them with
    prefix_lens=256 (bucket 64, a 4-wide table as the engine builds it).
    bf16: its last logits against llama_prefill_last over the whole prompt
    on the plain path. int8: the same pages quantized, the tail through
    llama_prefill_paged_prefix_q8, against a plain prefill of the tail over
    a dense bf16 cache holding the prefix's int8 K/V dequantized."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import (llama_prefill_last,
                                             llama_prefill_paged_prefix,
                                             llama_prefill_paged_prefix_q8)
    from gofr_tpu_torch.ops.decode_attention import quantize_kv
    from gofr_tpu_torch.ops.paged_attention import (paged_write_prefill_scales,
                                                    paged_write_prefill_stacked)

    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n, ps, prefix, bucket = 300, 128, 256, 64
    tail = n - prefix
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)

    def prefill(c, tokens, positions, lengths, S):
        tk = torch.zeros((L, 1, Hkv, dh, S), dtype=torch.bfloat16, device=dev)
        tv = torch.zeros_like(tk)
        return llama_prefill_last(params, c, tokens, positions, lengths, tk,
                                  tv)

    flash = dataclasses.replace(cfg, attn_impl="flash")
    plain = dataclasses.replace(cfg, attn_impl="xla", decode_attn="xla")
    arange = torch.arange(n, device=dev)[None]
    _, tk, tv = prefill(flash, prompt, arange, lens, n)
    want, _, _ = prefill(plain, prompt, arange, lens, n)
    ptable = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)
    table = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device=dev)
    window = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    window[0, :tail] = prompt[0, prefix:]
    args = (window, torch.tensor([prefix], dtype=torch.int32, device=dev),
            lens)
    last = torch.tensor([tail - 1], device=dev)
    pool_k = torch.zeros((L, 4, Hkv, dh, ps), dtype=torch.bfloat16, device=dev)
    pool_v = torch.zeros_like(pool_k)
    paged_write_prefill_stacked(pool_k, pool_v, tk, tv, ptable, lens)
    got = llama_prefill_paged_prefix(params, cfg, *args, pool_k, pool_v,
                                     table, last)[0]
    check("prefix tail prefill (256 cached + 44) vs plain prefill of the "
          "whole prompt", got, want)
    del pool_k, pool_v

    (k8, ks), (v8, vs) = quantize_kv(tk), quantize_kv(tv)
    pool_k = torch.zeros((L, 4, Hkv, dh, ps), dtype=torch.int8, device=dev)
    pool_v = torch.zeros_like(pool_k)
    pool_ks = torch.zeros((L, 4, Hkv, ps), dtype=torch.float32, device=dev)
    pool_vs = torch.zeros_like(pool_ks)
    paged_write_prefill_stacked(pool_k, pool_v, k8, v8, ptable, lens)
    paged_write_prefill_scales(pool_ks, ks, ptable, lens)
    paged_write_prefill_scales(pool_vs, vs, ptable, lens)
    got = llama_prefill_paged_prefix_q8(params, cfg, *args, pool_k, pool_v,
                                        pool_ks, pool_vs, table, last)[0]
    # the plain side: a dense cache holding the prefix dequantized; the
    # tail writes its own K/V into it at positions [256, 300)
    dk = torch.zeros((L, 1, Hkv, dh, n), dtype=torch.bfloat16, device=dev)
    dv = torch.zeros_like(dk)
    dk[..., :prefix] = (k8.float() * ks[:, :, :, None, :])[..., :prefix]
    dv[..., :prefix] = (v8.float() * vs[:, :, :, None, :])[..., :prefix]
    want_q8, _, _ = llama_prefill_last(
        params, plain, prompt[:, prefix:], arange[:, prefix:],
        torch.tensor([tail], dtype=torch.int32, device=dev), dk, dv)
    check("prefix tail prefill int8 (256 cached + 44) vs plain prefill of "
          "the tail over the dequantized prefix", got, want_q8)


# -- phase 4: serving ----------------------------------------------------------
PROMPT_WORDS = ("the quick brown fox jumps over a lazy dog while seven "
                "tired engineers measure kernels on a hot card").split()


def make_prompt(n_chars: int, seed: int) -> str:
    import random

    rnd = random.Random(seed)
    out = ""
    while len(out) < n_chars:
        out += rnd.choice(PROMPT_WORDS) + " "
    return out[:n_chars]


def stream_request(port, prompt, max_tokens, out, key, extra=None,
                   headers=None):
    """POST /generate (SSE), with `extra` body fields and `headers`;
    records the token events' arrival times."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/generate", body=json.dumps(
        {"prompt": prompt, "max_tokens": max_tokens, "stream": True,
         **(extra or {})}),
        headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    times, text, done = [], [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if not line.startswith(b"data: "):
            continue
        event = json.loads(line[6:])
        if event.get("done"):
            done = event
            resp.read()   # the closing chunk, so the close is clean
            break
        times.append(time.monotonic() - t0)
        text.append(event["text"])
    conn.close()
    out[key] = {"status": resp.status, "times": times, "text": "".join(text),
                "done": done}


def plain_request(port, prompt, max_tokens, out, key, extra=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/generate", body=json.dumps(
        {"prompt": prompt, "max_tokens": max_tokens, "stream": False,
         **(extra or {})}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    out[key] = {"status": resp.status, "seconds": time.monotonic() - t0,
                "data": body.get("data")}


# serving configuration -> (env beside the common keys, its decode kernel)
SERVE_CONFIGS = {
    "paged": ({}, "paged_attention"),
    "paged-int8": ({"KV_DTYPE": "int8"}, "paged_attention_q8"),
    "dense": ({"PAGED": "false", "DECODE_ATTN": "kernel"}, "decode_attention"),
    "dense-int8": ({"PAGED": "false", "DECODE_ATTN": "kernel",
                    "KV_DTYPE": "int8"}, "decode_attention_q8"),
}
# the main path on int8 weights, served and profiled as the four
W8_CONFIGS = {"paged-w8": ({"WEIGHT_DTYPE": "int8"}, "paged_attention")}
ALL_CONFIGS = {**SERVE_CONFIGS, **W8_CONFIGS}


def serve_phase(params, cfg, dev, card: str, config: str,
                preset: str = "llama3-8b", after=None,
                obs: bool = False, obs_costs: bool = False,
                drill: bool = False) -> dict:
    """Drive the port's /generate in one serving configuration; returns
    what the timing phase needs. after(app, engine), when given, runs on
    the served engine after the counted run, before the shutdown. obs: run
    phase 4b's checks (obs_phase) after the counted run; obs_costs: then
    its cost measurements (obs_cost, ledger_cost; --obs); drill: then
    phase 4c, the mid-stream reset drill (drill_phase), phase 4d, the
    QoS plane's preemption on the same engine (qos_phase), and phase 4e, a
    migration round landed back on it (migrate_phase)."""
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine

    extra, decode_kernel = ALL_CONFIGS[config]
    env = {**QUIET, "MODEL_PRESET": preset, "ATTN_IMPL": "flash",
           "HTTP_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
           "PAGE_SIZE": "128", "PREFILL_BUCKETS": "16,32,64,128,256",
           "REQUEST_TIMEOUT": "600", "WARMUP": "wide", **extra}
    engine = build_engine(env, device=dev, params=params)
    boot = boot_line(engine, config, card)
    app = build_app(env, engine=engine)
    app.start()
    try:
        # warm the path once (allocator caches, cuBLAS handles), uncounted
        warm = {}
        stream_request(app.http_port, make_prompt(40, 99), 4, warm, "w")
        require(warm["w"]["status"] == 200, f"{config}: warm-up failed")
        wait_idle(engine)
        first_id = max((r["id"] for r in engine.recorder.snapshot()["recent"]),
                       default=0) if engine.recorder is not None else 0
        last = engine.steps.records(1)
        seq_before = last[-1].seq if engine.steps.steps_total else 0

        zero_counts(engine)
        n_tok, n_plain = 32, 16
        lengths = [150, 180, 200, 220, 240, 130, 160]
        prompts = [make_prompt(n, i) for i, n in enumerate(lengths)]
        plain_prompt = make_prompt(250, 7)
        out: dict = {}
        threads = [threading.Thread(target=stream_request,
                                    args=(app.http_port, p, n_tok, out, i))
                   for i, p in enumerate(prompts)]
        threads.append(threading.Thread(
            target=plain_request,
            args=(app.http_port, plain_prompt, n_plain, out, "plain")))
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        require(all(not t.is_alive() for t in threads),
                f"{config}: requests hung")
        # a repeated greedy prompt, alone each time, repeats its tokens;
        # on the paged engine (the prefix cache on, as by default) both
        # repeats hit the prompt's first page and prefill only its tail
        rep: dict = {}
        for key in ("r1", "r2"):
            stream_request(app.http_port, prompts[0], 24, rep, key)
        launches = launch_counts.counts()
        prefills, steps = engine.prefill_dispatches, engine.decode_steps
        dispatch = dispatch_counts(engine, boot)
        shapes, tail_shapes = (dict(engine.prefill_shapes),
                               dict(engine.prefix_shapes))
        cache_len = getattr(engine, "_cache_len", None)
        paged = getattr(engine, "prefix", None) is not None
        if obs:
            t_obs = time.monotonic()
            enc = engine.tokenizer.encode
            counted = [(len(enc(p)), out[i]["done"]["tokens"])
                       for i, p in enumerate(prompts)]
            counted.append((len(enc(plain_prompt)),
                            out["plain"]["data"]["tokens"]))
            counted += [(len(enc(prompts[0])), rep[k]["done"]["tokens"])
                        for k in ("r1", "r2")]
            obs_phase(app, engine, card, counted, first_id, seq_before)
            if obs_costs:
                obs_cost(engine, card)
                ledger_cost(card)
            log(f"obs: phase 4b {time.monotonic() - t_obs:.1f}s")
        if drill:
            drill_phase(engine, card, boot)
            qos_phase(app, engine, card, boot)
            migrate_phase(engine, card, boot)
        if after is not None:
            after(app, engine)
    finally:
        app.shutdown()

    for i in range(len(prompts)):
        r = out[i]
        require(r["status"] == 200 and r["done"] is not None,
                f"{config}: stream {i} failed: {r['status']}")
        require(r["done"]["tokens"] == n_tok and len(r["times"]) == n_tok,
                f"{config}: stream {i} returned {r['done']['tokens']} of "
                f"{n_tok} tokens")
    p = out["plain"]
    require(p["status"] == 201 and p["data"]["tokens"] == n_plain,
            f"{config}: non-streaming request failed: {p}")
    require(rep["r1"]["done"]["tokens"] == 24
            and rep["r1"]["text"] == rep["r2"]["text"],
            f"{config}: repeated greedy prompt gave different tokens")
    log(f"serve {config}: {len(prompts)} streams x {n_tok} tokens + 1 "
        f"non-streaming x {n_plain} in {wall:.2f}s; repeat of a greedy "
        f"prompt identical: ok")
    L = cfg.n_layers
    log(f"serve {config}: launches " + " ".join(
        f"{k}={v}" for k, v in launches.items())
        + f" (prefills={prefills}, decode steps={steps}, n_layers={L}; "
        f"{decode_kernel} launches outside graph replays "
        f"{launches[decode_kernel] - L * steps})")
    check_dispatch(config, dispatch, card)
    log(f"serve {config}: prefill windows [K, bucket] x count: "
        f"{wave_list(shapes)}; tail-only prefix-hit waves: "
        f"{wave_list(tail_shapes) or 'none'}")
    require(prefills > 0 and launches["flash_attention"] == L * prefills,
            f"{config}: flash launches do not match n_layers per full "
            f"prefill wave")
    require(not paged or sum(tail_shapes.values()) == 2,
            f"{config}: the repeated prompt did not hit the prefix cache")
    require(steps > 0 and launches[decode_kernel] == L * steps,
            f"{config}: {decode_kernel} launches do not match n_layers per "
            f"decode step")
    others = {k: v for k, v in launches.items()
              if k not in ("flash_attention", decode_kernel) and v}
    require(not others, f"{config}: other decode kernels launched: {others}")
    ttft = sorted(out[i]["times"][0] * 1e3 for i in range(len(prompts)))
    tps = sorted((n_tok - 1) / (out[i]["times"][-1] - out[i]["times"][0])
                 for i in range(len(prompts)))
    log(f"serve {config}: ttft_ms p50={ttft[len(ttft) // 2]:.1f} "
        f"max={ttft[-1]:.1f} (client-side, {len(ttft)} concurrent streams) "
        f"[{card}]")
    log(f"serve {config}: decode tok/s per stream p50={tps[len(tps) // 2]:.1f}"
        f" min={tps[0]:.1f}; {len(prompts)} streams [{card}]")
    solo = rep["r2"]["times"]
    log(f"serve {config}: single stream ttft_ms={solo[0] * 1e3:.1f} decode "
        f"tok/s={(len(solo) - 1) / (solo[-1] - solo[0]):.1f} [{card}]")
    return {"launches": launches, "prefill_shapes": shapes,
            "prompt_lens": [len(engine.tokenizer.encode(p)) for p in prompts],
            "max_tokens": n_tok, "cache_len": cache_len}


def zero_counts(engine) -> None:
    """Every kernel's launch count, the engine's dispatch counts and its
    programs' calls to 0, just before a configuration's counted run."""
    from gofr_tpu_torch.ops import launch_counts

    launch_counts.zero()
    engine.prefill_dispatches = engine.decode_steps = 0
    engine.prefix_dispatches = engine.decode_blocks = 0
    engine.max_inflight = 0
    for name in SPEC_CHUNK_COUNTS:
        setattr(engine, name, 0)
    engine.prefill_shapes.clear()
    engine.prefix_shapes.clear()
    engine.executor.calls = 0
    for program in engine.executor._cache.values():
        program.calls = 0


# the engines' speculation and chunked-prefill counters (phase 10)
SPEC_CHUNK_COUNTS = ("verify_dispatches", "spec_drafted", "spec_accepted",
                     "spec_eligible", "spec_cooloffs", "spec_zero_draft",
                     "chunk_dispatches", "chunk_jobs", "chunk_swaps",
                     "chunk_swap_bytes")
PROGRAM_KINDS = ("prefill", "prefix", "decode", "verify", "chunk", "score")


def program_kind(name: str) -> str:
    """A program's kind by its name: a prefix hit's tail-only wave, a full
    admission wave, a speculative verify, a chunk of a chunked admission,
    a logprobs or embedding window (tpu/score.py), or a decode block."""
    if name.startswith(("score-", "embed-")):
        return "score"
    for kind, tag in (("prefix", "-prefix-"), ("prefill", "-prefill-"),
                      ("verify", "-verify-"), ("chunk", "-chunk")):
        if tag in name:
            return kind
    return "decode"


def boot_line(engine, config: str, card: str) -> int:
    """Log what WARMUP captured at boot, per kind (graphs and their capture
    seconds), and the graph pool's bytes; returns how many graphs."""
    ex = engine.executor
    kinds = {k: [0, 0.0] for k in PROGRAM_KINDS}
    for name, program in ex._cache.items():
        kinds[program_kind(name)][0] += 1
        kinds[program_kind(name)][1] += program.capture_seconds
    log(f"serve {config}: warm-up at boot {engine.warmup_seconds:.2f}s: "
        f"{ex.captures} graphs captured in {ex.capture_seconds:.2f}s ("
        + ", ".join(f"{k} {n} in {t:.2f}s" for k, (n, t) in kinds.items()
                    if n or k in ("prefill", "prefix", "decode"))
        + f"); graph pool {engine.graph_pool_bytes} bytes reserved "
        f"({engine.graph_pool_bytes / 2**30:.3f} GiB) [{card}]")
    return ex.captures


def dispatch_counts(engine, boot: int) -> dict:
    """The dispatch layer's counts of a counted run (since zero_counts)."""
    ex = engine.executor
    calls = dict.fromkeys(PROGRAM_KINDS, 0)
    for name, n in ex.cache_info().items():
        calls[program_kind(name)] += n
    return {"captured": ex.captured, "blocks": engine.decode_blocks,
            "waves": engine.prefill_dispatches,
            "tails": engine.prefix_dispatches,
            "verifies": engine.verify_dispatches,
            "chunks": engine.chunk_dispatches, "calls": calls,
            "captures": ex.captures - boot, "peak": engine.max_inflight,
            "depth": engine.pipeline_depth}


def check_dispatch(config, d, card):
    """Every decode block, every full admission wave and every tail-only
    wave was one call of a captured program (a CUDA graph replay), and no
    graph was captured after boot (WARMUP=wide captured every one serving
    reaches)."""
    blocks, calls = d["blocks"], d["calls"]
    log(f"serve {config}: dispatch: {blocks} decode blocks, {d['waves']} "
        f"full waves, {d['tails']} tail-only waves; graph replays "
        f"{calls['decode']} / {calls['prefill']} / {calls['prefix']}; graphs "
        f"captured after boot {d['captures']}; peak in flight {d['peak']} of "
        f"pipeline_depth {d['depth']} [{card}]")
    require(d["captured"] and (blocks > 0 or d["verifies"] > 0)
            and calls["decode"] == blocks,
            f"{config}: a decode block ran outside a graph replay")
    require(calls["prefill"] == d["waves"] and calls["prefix"] == d["tails"],
            f"{config}: an admission wave ran outside a graph replay")
    if d["verifies"] or d["chunks"]:
        log(f"serve {config}: dispatch: {d['verifies']} verifies, "
            f"{d['chunks']} chunks; graph replays {calls['verify']} / "
            f"{calls['chunk']} [{card}]")
    require(calls["verify"] == d["verifies"]
            and calls["chunk"] == d["chunks"],
            f"{config}: a verify or a chunk ran outside a graph replay")
    require(d["captures"] == 0, f"{config}: a graph was captured mid-serving")


def wave_list(shapes) -> str:
    return ", ".join(f"[{k}, {b}] x {n}"
                     for (k, b), n in sorted(shapes.items()))


# -- the observability planes (phase 4b) --------------------------------------
UTIL_CAP = 1.05      # no card runs above its peak: a share past this is a bug


def get_json(port, path) -> dict:
    """GET `path`: 200 required; the {data} envelope unwrapped."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    require(resp.status == 200, f"GET {path} answered {resp.status}")
    body = json.loads(raw)
    return body.get("data", body) if isinstance(body, dict) else body


def wait_idle(engine, timeout_s: float = 60.0) -> None:
    """Until nothing is queued, active or in flight, and the loop has closed
    the step that synced last."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if (not engine._inflight and not engine.queue_depth()
                and not any(s.active for s in engine.slots)):
            break
        time.sleep(0.01)
    time.sleep(0.2)


def check_shares(what: str, stats: dict, card: str) -> None:
    """Fail on any MFU, MBU or duty cycle above UTIL_CAP."""
    shares = {f"mfu.{k}": v for k, v in stats["mfu"].items()}
    shares.update({f"mbu.{k}": v for k, v in stats["mbu"].items()})
    shares["duty_cycle"] = stats["duty_cycle"]
    bad = {k: v for k, v in shares.items() if v > UTIL_CAP}
    require(not bad, f"{what}: a utilization share above {UTIL_CAP}: {bad} "
            f"(peaks {stats['peak_flops']:.4g} FLOP/s, "
            f"{stats['peak_hbm_bw']:.4g} B/s, {stats['peak_source']}) "
            f"[{card}]")


def obs_phase(app, engine, card: str, counted: list, first_id: int,
              seq_before: int) -> None:
    """Phase 4b, on the main path's engine after its counted run: every
    debug route answers 200; the recorder holds every request of the run,
    each with `generated` equal to what its client counted (`counted`:
    (prompt tokens, tokens) per request); the step ledger's prefill and
    decode tokens since the run began equal the tokens delivered; the
    timeline is Perfetto JSON with an llm-engine track and device slices;
    the host profiler saw the loop; /stats says serving; the peaks are the
    card's row of the table (or the placeholder for a card the table does
    not hold); no utilization share above UTIL_CAP."""
    from gofr_tpu_torch.tpu.utilization import PEAK_TABLE

    wait_idle(engine)
    port = app.http_port
    t0 = time.monotonic()
    snap = get_json(port, "/debug/engine")
    steps = get_json(port, "/debug/steps?recent=8")
    reqs = get_json(port, "/debug/requests")
    recent = [r for r in reqs["recent"] if r["id"] > first_id]
    require(recent, "obs: the recorder holds no request of the run")
    rid = recent[0]["id"]
    detail = get_json(port, f"/debug/requests/{rid}")
    journey = get_json(port, f"/debug/journey/{rid}")
    trace = get_json(port, "/debug/trace")
    timeline = get_json(port, "/debug/timeline?steps=64")
    hostprof = get_json(port, "/debug/hostprof")
    stats = get_json(port, "/stats")
    metrics = scrape(app.metrics_port)
    routes_s = time.monotonic() - t0
    got = sorted((r["prompt_tokens"], r["generated"]) for r in recent)
    require(got == sorted(counted),
            f"obs: the recorder's (prompt, generated) {got} != the "
            f"clients' {sorted(counted)}")
    require(all(r.get("outcome") in ("length", "stop") for r in recent),
            "obs: a request of the run did not finish cleanly")
    require([e["event"] for e in detail["events"]][:3]
            == ["enqueued", "admitted", "first_token"]
            and detail["events"][-1]["event"] == "finished",
            f"obs: request {rid}'s events {detail['events']}")
    require([h["hop"] for h in journey["hops"]][:3]
            == ["queue", "prefill", "decode"], f"obs: journey {journey}")
    require(len(trace["events"]) >= len(counted), "obs: /debug/trace short")
    recs = [r for r in engine.steps.records(recent=engine.steps.capacity)
            if r.seq > seq_before]
    require(recs and recs[0].seq == seq_before + 1,
            "obs: the step ledger's ring lost steps of the run")
    by_phase = {}
    for r in recs:
        by_phase[r.phase] = by_phase.get(r.phase, 0) + r.tokens
    delivered = sum(n for _, n in counted)
    ledger_tokens = by_phase.get("prefill", 0) + by_phase.get("decode", 0)
    require(ledger_tokens == delivered,
            f"obs: the step ledger's prefill + decode tokens "
            f"{ledger_tokens} != {delivered} delivered ({by_phase})")
    events = timeline["traceEvents"]
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    device = [e for e in events if e.get("cat") == "device"]
    require("llm-engine" in names and device,
            f"obs: the timeline has no llm-engine track or device slices "
            f"({sorted(names)}, {len(device)} device events)")
    json.loads(json.dumps(timeline))     # plain JSON, as Perfetto loads it
    loop = hostprof["threads"]["loop"]["samples"]
    require(loop > 0, f"obs: the host profiler saw no loop sample "
            f"{hostprof['threads']}")
    require(stats["fleet"]["lifecycle"] == "serving",
            f"obs: /stats lifecycle {stats['fleet']}")
    util = snap["utilization"]
    kind = torch_device_name()
    in_table = any(needle in kind.lower() for needle, _ in PEAK_TABLE)
    require(util["peak_source"] == ("table" if in_table else "default"),
            f"obs: peak_source {util['peak_source']} for {kind!r}")
    check_shares("obs /debug/engine", util, card)
    # the gauge is round(stall, 1) at each scrape, and an idle loop stamps
    # its step once per ~50 ms park: a scrape late in a park, or on a late
    # wake, reads 0.1 at rest, so scrape until it reads 0.0
    deadline = time.monotonic() + 5
    while (metrics.get("app_tpu_engine_stall_seconds", -1.0) != 0.0
           and time.monotonic() < deadline):
        time.sleep(0.05)
        metrics = scrape(app.metrics_port)
    require(metrics.get("app_tpu_engine_stall_seconds", -1.0) == 0.0,
            "obs: app_tpu_engine_stall_seconds is not 0 at rest")
    seg = {}
    for r in recs:
        for k, v in r.segments.items():
            seg[k] = seg.get(k, 0.0) + v
    wall = sum(r.wall_s for r in recs)
    log(f"obs: 11 routes 200 in {routes_s:.3f}s; recorder {len(recent)} "
        f"requests = the clients' (prompt, tokens); step ledger "
        f"{len(recs)} steps, tokens {by_phase} = {delivered} delivered; "
        f"segments share of step wall "
        + " ".join(f"{k}={v / wall:.4f}" for k, v in
                   sorted(seg.items(), key=lambda kv: -kv[1]))
        + f"; timeline {len(events)} events ({len(device)} device); "
        f"hostprof loop samples {loop}, overhead share "
        f"{hostprof['overhead']['share']} at {hostprof['hz']} Hz [{card}]")
    log(f"obs: /debug/engine utilization over {util['window_s']}s: "
        f"mfu {json.dumps(util['mfu'])} mbu {json.dumps(util['mbu'])} "
        f"duty_cycle={util['duty_cycle']} host_overhead_s="
        f"{util['host_overhead_s']} peak_source={util['peak_source']} "
        f"({util['peak_flops']:.4g} FLOP/s, {util['peak_hbm_bw']:.4g} B/s) "
        f"[{card}]")


def torch_device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def _decode_wall(engine, seed: int, tokens: int = 300,
                 settle_s: float = 0.2, span_s: float = 1.5) -> float:
    """Milliseconds per decode step of the served loop at B=8: 8 greedy
    requests submitted at once; once every row decodes, the decode syncs
    of the next `span_s` (one block each, from the utilization ledger,
    which is on in every state), sync to sync over the steps between;
    then the rest let run out."""
    from gofr_tpu_torch.models.tokenizer import DebugTokenizer

    tok = engine.tokenizer or DebugTokenizer(engine.cfg.vocab_size)
    reqs = [engine.submit(tok.encode(make_prompt(200, seed + i)),
                          max_new_tokens=tokens) for i in range(8)]
    deadline = time.monotonic() + 60
    while (any(r.first_token_at is None for r in reqs)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    time.sleep(settle_s)
    t0 = time.monotonic()
    time.sleep(span_s)
    t1 = time.monotonic()
    for r in reqs:
        r.result(timeout_s=120)
    wait_idle(engine)
    util = engine.util
    with util._lock:
        syncs = sorted(e[0] for e in util._entries
                       if e[1] == "decode" and t0 <= e[0] <= t1)
    require(len(syncs) >= 3, f"obs cost: {len(syncs)} decode syncs in the "
            f"window")
    return (syncs[-1] - syncs[0]) * 1e3 / (
        (len(syncs) - 1) * engine.decode_block_size)


def _lone_ttft(engine, seed: int, n: int = 3) -> float:
    """The median TTFT, ms, of `n` lone 200-token requests on the idle
    engine (submit to first token, as the engine stamps them)."""
    from gofr_tpu_torch.models.tokenizer import DebugTokenizer

    tok = engine.tokenizer or DebugTokenizer(engine.cfg.vocab_size)
    out = []
    for i in range(n):
        r = engine.submit(tok.encode(make_prompt(200, seed + i)),
                          max_new_tokens=2)
        r.result(timeout_s=60)
        out.append((r.first_token_at - r.enqueued_at) * 1e3)
        wait_idle(engine)
    return sorted(out)[len(out) // 2]


def cost_windows(engine, toggle, seed: int) -> str:
    """A plane's cost on the served main-path engine: the decode step's
    wall at B=8 and a lone request's TTFT with the plane on (toggle(True),
    as served) and off (toggle(False)) on the same engine, in windows
    taken on, off, off, on, the plane left on. Prompts of seeds from
    `seed` on, new in every window: a page shared with an earlier prompt
    would hit the prefix cache (a shorter prefill here, or a tail-only
    wave in a later phase's burst). Returns the log line's figures."""
    step = {True: [], False: []}
    ttft = {True: [], False: []}
    try:
        for k, on in enumerate((True, False, False, True)):
            toggle(on)
            step[on].append(_decode_wall(engine, seed + 10 * k))
            ttft[on].append(_lone_ttft(engine, seed + 100 + 10 * k))
    finally:
        toggle(True)
    on, off = sum(step[True]) / 2, sum(step[False]) / 2
    t_on, t_off = sum(ttft[True]) / 2, sum(ttft[False]) / 2
    require(all(math.isfinite(x) for x in (on, off, t_on, t_off)),
            "cost: a non-finite time")
    return (f"decode step at B=8 (served loop) {on:.4f} ms on, {off:.4f} "
            f"ms off, added {on - off:+.4f} ms ({(on - off) / off:+.4f}); "
            f"windows {[round(x, 4) for x in step[True]]} / "
            f"{[round(x, 4) for x in step[False]]}; lone-request TTFT (200 "
            f"tokens, median of 3) {t_on:.2f} ms on, {t_off:.2f} ms off, "
            f"added {t_on - t_off:+.2f} ms; windows "
            f"{[round(x, 2) for x in ttft[True]]} / "
            f"{[round(x, 2) for x in ttft[False]]}")


def obs_cost(engine, card: str) -> None:
    """The planes' cost (cost_windows): as served (the flight recorder on,
    the host profiler sampling) against both off (recorder None, sampler
    stopped; the two ledgers are always on, as in the reference)."""
    recorder, prof = engine.recorder, engine.hostprof
    require(recorder is not None and prof is not None and prof.running,
            "obs cost: the recorder or the host profiler is not on")

    def toggle(on: bool) -> None:
        engine.recorder = recorder if on else None
        if on and not prof.running:
            prof.start()
        elif not on:
            prof.stop()

    figures = cost_windows(engine, toggle, 1000)
    log(f"obs cost (recorder + hostprof at {prof.hz} Hz): {figures} "
        f"[{card}]")


def ledger_cost(card: str, n: int = 20000) -> None:
    """The two ledgers' own host cost per step: a decode step's ledger
    calls (the step's segments, a dispatch and a sync noted, the
    utilization record and host note, the step closed with its histogram
    samples into a metrics manager as served), n times on this host, no
    device work. The utilization records are stamped one served decode
    block apart (BLOCK_S), so its 60 s window holds what serving holds."""
    from gofr_tpu_torch.metrics import Manager
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.tpu.device import register_metrics
    from gofr_tpu_torch.tpu.stepledger import StepLedger
    from gofr_tpu_torch.tpu.utilization import UtilizationLedger

    m = Manager()
    register_metrics(m)
    steps = StepLedger(metrics=m)
    util = UtilizationLedger(LlamaConfig.llama3_8b(), metrics=m,
                             platform="gpu", device_kind=torch_device_name())
    block_s = 0.165          # a 16-step block at ~10.3 ms per step
    t = 1000.0
    for _ in range(400):     # fill the window as serving does
        t += block_s
        util.record_decode(8, 16, 3000, t - block_s, t, 0.001)
    t0 = time.perf_counter()
    for i in range(n):
        steps.step_start()
        with steps.seg("admission"):
            pass
        steps.note_dispatch("decode")
        with steps.seg("host_prep"):
            pass
        with steps.seg("dispatch"):
            pass
        with steps.seg("emit"):
            with steps.seg("device_sync"):
                pass
            with steps.seg("demux"):
                pass
        t += block_s
        util.record_decode(8, 16, 3000, t - block_s, t, 0.001)
        util.note_host(0.002, now=t)
        steps.note_sync("decode", tokens=128, slowest_request_id=i)
        steps.step_end(active_slots=8, inflight=3)
    per = (time.perf_counter() - t0) / n * 1e6
    window = util.window_stats(now=t)["dispatches"]
    log(f"obs cost: the two ledgers' calls of one decode step, host only "
        f"({n} steps, a utilization window of {window} dispatches, metrics "
        f"recorded): {per:.2f} us per step (the card's host CPU) [{card}]")


def ledger_window(util, t0: float, t1: float, skip: int) -> dict:
    """The utilization ledger's decode MFU, MBU and duty cycle over [t0, t1]
    by its own convention. MFU and MBU: the decode dispatches synced from
    t0 on less the first `skip` (those dispatched before the window), over
    the window's span. Duty cycle: the union of every accounted busy
    interval, clipped to the window (the watermark keeps them disjoint); a
    dispatch's interval runs from the later of its dispatch stamp and the
    previous sync to its own sync, so a sync the host makes late moves
    busy time between dispatches, never out of the union."""
    with util._lock:
        synced = sorted(e for e in util._entries
                        if e[1] == "decode" and e[0] >= t0)
    entries = synced[skip:]
    peak_flops, peak_bw, source = util.peaks()
    span = t1 - t0
    busy = sum(max(0.0, min(s, t1) - max(s - b, t0))
               for s, _, _, _, b, _, _ in synced)
    return {"dispatches": len(entries),
            # (sync, busy start) of each synced from t0 on, ms from t0
            "intervals": [(round((s - t0) * 1e3, 3),
                           round((s - b - t0) * 1e3, 3))
                          for s, _, _, _, b, _, _ in synced],
            "mfu": sum(e[2] for e in entries) / (peak_flops * span),
            "mbu": sum(e[3] for e in entries) / (peak_bw * span),
            "duty_cycle": busy / span, "peak_source": source}


# prefix-cache configuration -> (env beside the common keys, its decode
# kernel): the paged engine with PREFIX_CACHE=true, bf16 and int8 pools
PREFIX_CONFIGS = {
    "paged-prefix": ({}, "paged_attention"),
    "paged-int8-prefix": ({"KV_DTYPE": "int8"}, "paged_attention_q8"),
}
SYSTEM_CHARS = 383          # + BOS: a 384-token system prompt, 3 full pages
TAIL_CHARS = [16, 120, 40, 64, 90, 24, 100, 56]


def prefix_phase(params, cfg, dev, card: str, config: str,
                 preset: str = "llama3-8b") -> dict:
    """Serve shared-system-prompt traffic with the prefix cache on, at the
    depth of `params` (CUT_DEPTH layers in the full run): one request alone
    seeds the cache with a 384-token system prompt (3 full
    pages), then 7 concurrent streams and 1 non-streaming request, each the
    system prompt and a distinct 16-120 token tail, must each hit the 3
    pages and prefill only their tails (tail buckets <= 128; flash only in
    the full waves); the same hit prompt served twice alone gives the same
    tokens. Logged: agreement with the same prompts on an engine without
    the cache, TTFT beside that engine's and the cold seed's, the cache's
    stats."""
    import torch

    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine

    extra, decode_kernel = PREFIX_CONFIGS[config]
    system = make_prompt(SYSTEM_CHARS, 50)
    prompts = [system + make_prompt(n, 60 + i)
               for i, n in enumerate(TAIL_CHARS)]
    n_tok, n_plain = 32, 16
    runs = {}
    for cache in ("true", "false"):
        env = {**QUIET, "MODEL_PRESET": preset, "ATTN_IMPL": "flash",
               "HTTP_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
               "PAGE_SIZE": "128", "PREFILL_BUCKETS": "16,32,64,128,256,512",
               "REQUEST_TIMEOUT": "600", "PREFIX_CACHE": cache,
               "WARMUP": "wide", **extra}
        engine = build_engine(env, device=dev, params=params)
        boot = boot_line(engine, f"{config} PREFIX_CACHE={cache}", card)
        app = build_app(env, engine=engine)
        app.start()
        try:
            warm: dict = {}
            stream_request(app.http_port, make_prompt(40, 99), 4, warm, "w")
            require(warm["w"]["status"] == 200, f"{config}: warm-up failed")
            zero_counts(engine)
            out: dict = {}
            stream_request(app.http_port, system + make_prompt(30, 59),
                           n_tok, out, "seed")
            before = engine.prefix.stats() if engine.prefix else None
            threads = [threading.Thread(target=stream_request,
                                        args=(app.http_port, p, n_tok, out,
                                              i))
                       for i, p in enumerate(prompts[:-1])]
            threads.append(threading.Thread(
                target=plain_request,
                args=(app.http_port, prompts[-1], n_plain, out, "plain")))
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            wall = time.monotonic() - t0
            require(all(not t.is_alive() for t in threads),
                    f"{config}: requests hung")
            run = {"out": out, "wall": wall,
                   "launches": launch_counts.counts(),
                   "full": engine.prefill_dispatches,
                   "steps": engine.decode_steps,
                   "dispatch": dispatch_counts(engine, boot),
                   "shapes": dict(engine.prefill_shapes),
                   "tail_shapes": dict(engine.prefix_shapes)}
            if engine.prefix is not None:
                run["stats"] = engine.prefix.stats()
                run["hits"] = run["stats"]["hit_pages"] - before["hit_pages"]
                rep: dict = {}
                for key in ("r1", "r2"):
                    stream_request(app.http_port, prompts[1], 24, rep, key)
                run["rep"] = rep
        finally:
            app.shutdown()
        runs[cache] = run
        torch.cuda.empty_cache()

    hit, cold = runs["true"], runs["false"]
    out = hit["out"]
    for cache, run in runs.items():
        for key in ["seed", *range(len(prompts) - 1)]:
            r = run["out"][key]
            require(r["status"] == 200 and r["done"] is not None
                    and r["done"]["tokens"] == n_tok
                    and len(r["times"]) == n_tok,
                    f"{config} PREFIX_CACHE={cache}: stream {key} failed or "
                    f"came back short: {r['status']} {r['done']}")
        p = run["out"]["plain"]
        require(p["status"] == 201 and p["data"]["tokens"] == n_plain,
                f"{config} PREFIX_CACHE={cache}: non-streaming request "
                f"failed: {p}")
    L = cfg.n_layers
    log(f"serve {config}: seed + {len(prompts) - 1} streams x {n_tok} tokens "
        f"+ 1 non-streaming x {n_plain}, all on a {SYSTEM_CHARS + 1}-token "
        f"system prompt, in {hit['wall']:.2f}s")
    log(f"serve {config}: launches " + " ".join(
        f"{k}={v}" for k, v in hit["launches"].items())
        + f" (full prefill waves={hit['full']}, decode steps={hit['steps']}, "
        f"n_layers={L}; {decode_kernel} launches outside graph replays "
        f"{hit['launches'][decode_kernel] - L * hit['steps']})")
    log(f"serve {config}: full prefill waves [K, bucket] x count: "
        f"{wave_list(hit['shapes'])}; tail-only waves: "
        f"{wave_list(hit['tail_shapes'])}")
    log(f"serve {config}: prefix cache {json.dumps(hit['stats'])}; hit pages "
        f"in the concurrent run {hit['hits']} (3 per request)")
    require(hit["hits"] == 3 * len(prompts),
            f"{config}: {hit['hits']} hit pages, not {3 * len(prompts)}")
    require(sum(hit["tail_shapes"].values()) > 0
            and sum(k * n for (k, _), n in hit["tail_shapes"].items())
            == len(prompts)
            and all(b <= 128 for _, b in hit["tail_shapes"]),
            f"{config}: the hits did not all admit tail-only at buckets "
            f"<= 128: {hit['tail_shapes']}")
    launches = hit["launches"]
    require(hit["full"] > 0
            and launches["flash_attention"] == L * hit["full"],
            f"{config}: flash launches do not match n_layers per full wave")
    for cache, run in runs.items():
        check_dispatch(f"{config} PREFIX_CACHE={cache}", run["dispatch"],
                       card)
    require(hit["steps"] > 0 and launches[decode_kernel] == L * hit["steps"],
            f"{config}: {decode_kernel} launches do not match n_layers per "
            f"decode step")
    others = {k: v for k, v in launches.items()
              if k not in ("flash_attention", decode_kernel) and v}
    require(not others, f"{config}: other kernels launched: {others}")
    rep = hit["rep"]
    require(rep["r1"]["done"]["tokens"] == 24
            and rep["r1"]["text"] == rep["r2"]["text"],
            f"{config}: a hit prompt served twice gave different tokens")
    log(f"serve {config}: the same hit prompt served twice alone: identical")
    same = total = first = 0
    for i in range(len(prompts) - 1):
        a, b = out[i]["text"], cold["out"][i]["text"]
        total += max(len(a), len(b))
        same += sum(x == y for x, y in zip(a, b))
        first += a[:1] == b[:1]
    log(f"serve {config}: greedy tokens of the hit streams equal to the same "
        f"prompts on an engine without the prefix cache: {same}/{total} = "
        f"{same / total:.3f}, first tokens {first}/{len(prompts) - 1} "
        f"(logged, not required); that engine's waves: "
        f"{wave_list(cold['shapes'])}")
    ttft = sorted(out[i]["times"][0] * 1e3 for i in range(len(prompts) - 1))
    ttft_cold = sorted(cold["out"][i]["times"][0] * 1e3
                       for i in range(len(prompts) - 1))
    log(f"serve {config}: ttft_ms of the {len(ttft)} concurrent hit streams "
        f"p50={ttft[len(ttft) // 2]:.1f} max={ttft[-1]:.1f}; the same prompts "
        f"without the prefix cache p50={ttft_cold[len(ttft) // 2]:.1f} "
        f"max={ttft_cold[-1]:.1f}; the cold seed alone "
        f"{out['seed']['times'][0] * 1e3:.1f} [{card}]")
    return {"tail_shapes": hit["tail_shapes"], "launches": launches}


def time_wave(eng, K: int, bucket: int, tail: bool, iters: int,
              prefix_pages: int = 2) -> dict:
    """One admission wave of K rows at `bucket` (graphcheck.wave: full, or
    tail-only over `prefix_pages` cached pages) dispatched on the engine's
    stream eagerly and as its program's replay, each with the upload of its
    inputs: host wall time per dispatch (mean of `iters` after a warm one,
    each from an idle card to a synchronize), then one more under
    torch.profiler (asked again while its trace holds no kernel, up to
    PROFILE_TRIES times) for the card's busy time (the sum of its kernels and
    copies), the kernels it ran and the host's launches (HOST_LAUNCH).
    Returns {"eager": ..., "graph": ...}, each (wall_ms, busy_ms, kernels,
    host launches, top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.tpu.graphcheck import wave

    def measure(fn):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(iters):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
            kernels = [e for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels:
                break
        busy = sum(e.self_device_time_total for e in kernels)
        host = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and HOST_LAUNCH.match(e.key))
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        return (sum(walls) / len(walls), busy / 1e3 if busy > 0 else math.nan,
                sum(e.count for e in kernels), host,
                "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms x{e.count}" for e in top))

    with torch.no_grad(), eng._stream_ctx():
        program, arrays, eager_fn = wave(eng, K, bucket, tail, prefix_pages)
        runs = {"eager": lambda: (eng._upload(program.inputs, arrays),
                                  eager_fn(*program.inputs)),
                "graph": lambda: eng._call(program, arrays)}
        out = {kind: measure(fn) for kind, fn in runs.items()}
    for kind, r in out.items():
        require(math.isfinite(r[1]),
                f"the profiler saw no kernels in the {kind} wave")
    return out


def wave_line(r) -> str:
    return (f"wall_ms={r[0]:.3f} card_busy_ms={r[1]:.3f} kernels={r[2]} "
            f"host_launches={r[3]}")


def timing_engine(params, cfg, dev, buckets, quantized=False):
    """A paged engine of the main path (flash prefill, 8 slots, the
    serving phases' sizes) for the wave timings; nothing is served."""
    import dataclasses

    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    c = dataclasses.replace(cfg, attn_impl="flash",
                            kv_dtype="int8" if quantized else None)
    return PagedLLMEngine(params, c, device=dev, n_slots=8,
                          max_seq_len=1024, prefill_buckets=buckets,
                          page_size=128, prefix_cache=True)


def time_tail_prefill(params, cfg, dev, card, shapes, quantized) -> None:
    """The tail prefill at each [K, bucket] wave shape serving gave it,
    over 3 cached pages (a 4-wide table, as a 384-token prefix plus a tail
    <= 128 has), against the full-window prefill of as many prompts at
    [K, 512] (flash, timed once a K), each eager and as its program's
    replay (time_wave)."""
    import torch

    eng = timing_engine(params, cfg, dev, (16, 32, 64, 128, 256, 512),
                        quantized)
    kind = " int8" if quantized else ""
    fulls = {}  # the full-window wave of each K, timed once
    for K, bucket in sorted(shapes):
        tail = time_wave(eng, K, bucket, True, 5, prefix_pages=3)
        if K not in fulls:
            fulls[K] = time_wave(eng, K, 512, False, 5)
        full = fulls[K]
        log(f"time tail prefill{kind} [{K}, {bucket}] over 384 cached "
            f"tokens: eager {wave_line(tail['eager'])}; replay "
            f"{wave_line(tail['graph'])}; full-window prefill [{K}, 512] "
            f"(flash): eager {wave_line(full['eager'])}; replay "
            f"{wave_line(full['graph'])}; card time ratio tail / full "
            f"{tail['graph'][1] / full['graph'][1]:.3f} [{card}]")
        log(f"time tail prefill{kind} [{K}, {bucket}] top kernels: "
            f"{tail['eager'][4]}")
        log(f"time full prefill [{K}, 512] top kernels: {full['eager'][4]}")
    del eng
    torch.cuda.empty_cache()


# -- phase 5: timings ----------------------------------------------------------
def time_ms(fn, iters: int, flush) -> float:
    """Mean device time of fn over `iters` launches, CUDA events around each,
    the 50 MB L2 flushed before each (a forward pass finds them cold)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# times torch.profiler is asked again when its trace holds no kernel: now
# and then CUPTI hands back an empty trace for a window that ran kernels
PROFILE_TRIES = 3


def kernel_device_ms(fn, iters: int, name: str) -> float:
    """Device time per call of the kernels whose name holds `name`, from
    torch.profiler over `iters` back-to-back calls (L2 warm): the kernel's
    own time, without the host time that time_ms also sees when the host
    launches slower than the card runs. Where PROFILE_TRIES traces in a row
    hold no such kernel, CUDA events around the `iters` back-to-back calls
    instead (the whole call, L2 warm), and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.key)
        if us > 0:
            return us / 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    log(f"the profiler saw no '{name}' kernel in {PROFILE_TRIES} traces: "
        "its device time is CUDA events around back-to-back calls")
    return start.elapsed_time(end) / iters


def flash_bound(B, H, Hkv, T, S, dh, causal):
    pairs = T * (T + 1) // 2 if causal else T * S
    flops = 4.0 * B * H * pairs * dh
    nbytes = 2.0 * (2 * B * H * T * dh + 2 * B * Hkv * S * dh)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def read_bound(lengths, H, Hkv, dh, quantized, index_bytes):
    """The decode reads' bound: K and V of each row's live tokens read once
    (bf16, or int8 plus the two f32 scales of each token and head; the
    ragged tail of a last page is not needed), q read and o written once in
    bf16, plus `index_bytes` (lengths, live table entries). The operations,
    ~4 * H * dh per live token, at the peak rate of the K/V type."""
    per_token = Hkv * (dh * 2 + 2 * 4) if quantized else Hkv * dh * 2 * 2
    nbytes = (sum(lengths) * per_token + 2 * 2 * len(lengths) * H * dh
              + index_bytes)
    ops = 4.0 * H * dh * sum(lengths)
    t_ops = ops / (H100_INT8_OPS if quantized else H100_BF16_FLOPS)
    t_bytes = nbytes / H100_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_bound(lengths, H, Hkv, dh, ps, quantized=False):
    """read_bound, indexing through the live pages' table entries."""
    pages = sum(-(-n // ps) for n in lengths)
    return read_bound(lengths, H, Hkv, dh, quantized,
                      4 * pages + 4 * len(lengths))


def time_flash(dev, B, T, causal, iters, flush):
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                    flash_attention_cuda,
                                                    flash_attention_plain)

    H, Hkv, dh = 32, 8, 128
    q, k, v = flash_inputs(B, H, Hkv, T, T, dh, dev, seed=3)
    err = check_agreement(
        f"flash B={B} T=S={T} causal={causal}",
        flash_attention_cuda(q, k, v, causal),
        flash_attention_plain(q, k, v, causal, KERNEL_BLOCK_KV), per_row=True)
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal), iters, flush)
    # the same values in the model's [B, T, H, dh] memory, as serving hands
    # them over (transposed views in, a [B, T, H, dh] output)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    out = torch.empty_like(qs)
    strided_ms = time_ms(lambda: flash_attention_cuda(qs, ks, vs, causal,
                                                      out=out), iters, flush)
    device_ms = kernel_device_ms(
        lambda: flash_attention_cuda(qs, ks, vs, causal, out=out), iters,
        "flash_fwd_kernel")
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal,
                                                     KERNEL_BLOCK_KV),
                       max(1, iters // 2), flush)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), iters, flush)
    bound_ms, by = flash_bound(B, H, Hkv, T, T, dh, causal)
    del q, k, v, qs, ks, vs, out
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "strided_ms": strided_ms, "device_ms": device_ms}


def log_flash_time(B, T, r, card) -> None:
    log(f"time flash B={B} T=S={T} causal: ms={r['ms']:.4f} (model layout "
        f"{r['strided_ms']:.4f}; kernel alone on the card, profiler, L2 warm "
        f"{r['device_ms']:.4f}) bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']}, share {r['bound_ms'] / r['ms']:.3f}) plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} [{card}]")


def time_prefill(params, cfg, dev, shapes, iters, card) -> None:
    """The main path's full admission wave (flash) at each [K, T] of
    `shapes`, eager and as its program's replay (time_wave): host wall,
    card busy time and host launches per wave."""
    import torch

    eng = timing_engine(params, cfg, dev,
                        tuple(sorted({T for _, T in shapes})))
    for K, T in sorted(shapes):
        r = time_wave(eng, K, T, False, iters)
        log(f"time prefill [{K}, {T}] ({cfg.n_layers} layers, flash), over "
            f"{iters}: eager {wave_line(r['eager'])}; replay "
            f"{wave_line(r['graph'])}; replay wall / card busy "
            f"{r['graph'][0] / r['graph'][1]:.3f} [{card}]")
    del eng
    torch.cuda.empty_cache()


# what the profiler's name of each decode read's kernel holds: both launch
# decode_split_kernel, told apart by its element type
READ_KERNEL = {False: "KvBf16", True: "KvInt8"}



def time_paged(dev, lengths, ps, iters, flush, quantized=False):
    from gofr_tpu_torch.ops.decode_attention import quantize_kv
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda)

    H, Hkv, dh = 32, 8, 128
    q, kp, vp, table, lens = paged_inputs(lengths, H, Hkv, dh, ps, dev, seed=5)
    if quantized:
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)

        def kernel():
            return paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)

        def plain():
            return paged_attention_plain(q, k8, v8, table, lens, ks, vs)
    else:
        def kernel():
            return paged_attention_cuda(q, kp, vp, table, lens)

        def plain():
            return paged_attention_plain(q, kp, vp, table, lens)
    err = check_agreement(f"paged{'-int8' if quantized else ''} "
                          f"B={len(lengths)} ps={ps} {brief(lengths)}",
                          kernel(), plain())
    ms = time_ms(kernel, iters, flush)
    device_ms = kernel_device_ms(kernel, iters, READ_KERNEL[quantized])
    plain_ms = time_ms(plain, max(1, iters // 5), flush)
    bound_ms, by = paged_bound(lengths, H, Hkv, dh, ps, quantized)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": by,
            "max_abs_err": err}


def time_decode(dev, lengths, S, iters, flush, quantized=False):
    """The dense read at B=len(lengths) over an S-long cache. Its library
    yardstick (bf16 only): scaled_dot_product_attention with a length mask
    and enable_gqa, on the same K/V copied beforehand into the [B, Hkv, S,
    dh] layout it takes, by events and as the sum of every kernel the call
    launches. No PyTorch call reads int8 K/V with scales."""
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     quantize_kv)

    H, Hkv, dh = 32, 8, 128
    q, k, v, lens = dense_inputs(lengths, H, Hkv, dh, S, dev, seed=6)
    lib_ms = lib_device_ms = None
    if quantized:
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)

        def kernel():
            return decode_attention_q8_cuda(q, k8, v8, ks, vs, lens)

        def plain():
            return decode_attention_plain(q, k8, v8, lens, ks, vs)
    else:
        def kernel():
            return decode_attention_cuda(q, k, v, lens)

        def plain():
            return decode_attention_plain(q, k, v, lens)

        k_sd = k.transpose(-1, -2).contiguous()          # [B, Hkv, S, dh]
        v_sd = v.transpose(-1, -2).contiguous()
        q_sd = q[:, :, None]                             # [B, H, 1, dh]
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q_sd, k_sd, v_sd,
                                                  attn_mask=mask,
                                                  enable_gqa=True)
        lib_ms = time_ms(library, iters, flush)
        lib_device_ms = kernel_device_ms(library, iters, "")
    err = check_agreement(f"decode{'-int8' if quantized else ''} "
                          f"B={len(lengths)} S={S} {brief(lengths)}",
                          kernel(), plain())
    ms = time_ms(kernel, iters, flush)
    device_ms = kernel_device_ms(kernel, iters, READ_KERNEL[quantized])
    plain_ms = time_ms(plain, max(1, iters // 5), flush)
    bound_ms, by = read_bound(lengths, H, Hkv, dh, quantized, 4 * len(lengths))
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_device_ms": lib_device_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}


def brief(lengths) -> str:
    return (f"lengths={lengths}" if len(set(lengths)) > 1 or len(lengths) < 3
            else f"lengths={len(lengths)}x{lengths[0]}")


def log_read_time(name, shape, r, card) -> None:
    lib = ""
    if r["library_ms"] is not None:
        lib = (f" library_ms={r['library_ms']:.4f} (alone "
               f"{r['library_device_ms']:.4f})")
    log(f"time {name} {shape}: ms={r['ms']:.4f} (kernel alone on the card, "
        f"profiler, L2 warm {r['device_ms']:.4f}) bound_ms="
        f"{r['bound_ms']:.4f} ({r['bound_by']}; share {r['bound_ms'] / r['ms']:.3f}"
        f" of the event time, {r['bound_ms'] / r['device_ms']:.3f} of the "
        f"kernel alone) plain_ms={r['plain_ms']:.4f}{lib} [{card}]")


def time_reads(dev, ctx, S, flush, card) -> dict:
    """The four decode reads at B=8 over the served contexts `ctx` (paged
    ps=128, dense S), logged and returned for the kernels line, then at
    B=8 x 8192 and B=1 x 8192 (paged ps=128, dense S=8192), logged."""
    import torch

    served = {
        "paged_attention": (time_paged(dev, ctx, 128, 50, flush),
                            f"B=8 ps=128 lengths={ctx}"),
        "paged_attention_q8": (time_paged(dev, ctx, 128, 50, flush, True),
                               f"B=8 ps=128 lengths={ctx}"),
        "decode_attention": (time_decode(dev, ctx, S, 50, flush),
                             f"B=8 S={S} lengths={ctx}"),
        "decode_attention_q8": (time_decode(dev, ctx, S, 50, flush, True),
                                f"B=8 S={S} lengths={ctx}"),
    }
    for name, (r, shape) in served.items():
        log_read_time(name, shape, r, card)
    for B in (8, 1):
        long = [8192] * B
        for quantized in (False, True):
            suffix = "_q8" if quantized else ""
            log_read_time(f"paged_attention{suffix}", f"B={B} ps=128 x 8192",
                          time_paged(dev, long, 128, 20, flush, quantized),
                          card)
            log_read_time(f"decode_attention{suffix}", f"B={B} S=8192 x 8192",
                          time_decode(dev, long, 8192, 20, flush, quantized),
                          card)
            torch.cuda.empty_cache()
    return served


# -- phase 6: where a decode step's time goes ---------------------------------
# kernel launches per decode step with one read kernel per layer before the
# reads were split over blocks (this profile phase, NVIDIA H100 80GB HBM3,
# 700 W): the split reads combine in the same launch and add none; on int8
# weights (paged-w8) as first measured (5451.3). The
# check is on kernels the card executed; under CUDA graphs the host
# launches one graph per block
LAUNCHES_PER_STEP = {"paged": 2621, "paged-int8": 3453, "dense": 2555,
                     "dense-int8": 3071, "paged-w8": 5451}
# the matrix products' kernels by name (cuBLAS / cuBLASLt on an H100)
GEMM_KERNEL = re.compile(r"gemm|xmma|nvjet|cutlass", re.IGNORECASE)
# the host's runtime calls that put work on the card, by the profiler's name
HOST_LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch|"
                         r"cudaMemcpyAsync)")


def decode_engine(params, cfg, dev, config: str):
    """A serving configuration's engine at B=8 (contexts ~200 tokens, 600
    new tokens each, flash prefill as served), its 8 greedy requests
    admitted and driven, this thread playing the engine loop (the loop
    thread is not started), until the pipeline is full of decode blocks.
    The paged engine captures each graph at its first use, before the
    windows (the run reaches one table width); the dense one captures
    warmup()'s set, which first grows the cache to max_seq_len, so no
    growth drops the graphs mid-window."""
    import dataclasses

    from gofr_tpu_torch.metrics import Manager
    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.tpu.device import register_metrics
    from gofr_tpu_torch.tpu.engine import LLMEngine
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine
    from gofr_tpu_torch.tracing import Tracer

    extra, _ = ALL_CONFIGS[config]
    cfg = dataclasses.replace(cfg, attn_impl="flash",
                              decode_attn=extra.get("DECODE_ATTN", "xla"),
                              kv_dtype=extra.get("KV_DTYPE"))
    # recording as build_engine has it: the metrics hook at every sync and
    # a span per dispatch (the default exporter drops them)
    metrics = Manager()
    register_metrics(metrics)
    kw = dict(device=dev, n_slots=8, max_seq_len=1024, prefill_buckets=(256,),
              metrics=metrics, tracer=Tracer())
    if extra.get("PAGED") == "false":
        eng = LLMEngine(params, cfg, **kw)
        eng.warmup()
    else:
        eng = PagedLLMEngine(params, cfg, page_size=128, **kw)
    tok = DebugTokenizer(cfg.vocab_size)
    for i in range(8):
        eng.submit(tok.encode(make_prompt(200, 100 + i)), max_new_tokens=600)
    # the first step admits the wave, dispatches the first blocks and syncs
    # the prefill; the next ones sync a block each
    for _ in range(eng.pipeline_depth + 1):
        eng._step()
    # each step fills the pipeline, then syncs its oldest dispatch
    require(all(kind == "decode" for kind, *_ in eng._inflight)
            and len(eng._inflight) == eng.pipeline_depth - 1,
            f"{config}: the pipeline is not full of decode blocks")
    return eng


def _window(eng, n_steps: int, stamps=None) -> float:
    """n_steps loop steps (each dispatches a block and syncs the oldest),
    the card idle at the start and waited for at the end; returns the wall
    ms (and appends the window's monotonic start and end to `stamps`)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_steps):
        eng._step()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    if stamps is not None:
        stamps += [t0, t1]
    return (t1 - t0) * 1e3


def profile_decode(eng, card: str, config: str) -> None:
    """The pipelined loop in steady state (decode_engine's): a window of 4
    loop steps under torch.profiler, with the card idle at its start and
    waited for at its end, so the host's wall time and the card's busy time
    (its kernels and copies) cover the same window and the same steps, the
    64 the window dispatched. The profiler drops a few records under graph
    replays (up to 4.4% of a window's decode reads on an H100), so busy time
    and kernel counts are those it kept, the share it kept of the window's
    decode reads is logged beside them, and a window with less than 0.9 of
    them fails. Before it, 10 steps without the profiler, whose wall shows
    what tracing costs, with the engine's metrics hook and dispatch spans
    as served (decode_engine), and 10 without them, whose wall beside it
    shows what they cost (5-step windows: on, off, off, on). Logs wall and busy per step, the
    idle share (1 - busy / wall, same window), the kernels and copies the
    card executed per step (less the generator's state fills that the
    host launches before each replay, which the eager loop did not run)
    and the host's launches per step and block, the top kernels. Fails if
    busy exceeds wall, if a graph is captured in the windows, or above
    LAUNCHES_PER_STEP kernels per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    block, L = eng.decode_block_size, eng.cfg.n_layers
    captures = eng.executor.captures
    ctx = [s.length for s in eng.slots if s.active]
    # 10 steps untraced as served (the metrics hook and the dispatch spans
    # on) and 10 without them, in 5-step windows taken on, off, off, on so
    # that a drift between windows cancels
    hook, tracer = eng._obs.metrics, eng.tracer
    untraced_ms = bare_ms = 0.0
    for served in (True, False, False, True):
        eng._obs.metrics, eng.tracer = ((hook, tracer) if served
                                        else (None, None))
        ms = _window(eng, 5)
        if served:
            untraced_ms += ms
        else:
            bare_ms += ms
    eng._obs.metrics, eng.tracer = hook, tracer
    untraced_steps = 10 * block
    extra, _ = ALL_CONFIGS[config]
    ran = eng.decode_steps
    torch.cuda.synchronize()
    before = len(eng._inflight)
    stamps: list = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = _window(eng, 4, stamps)
    # the blocks the window dispatched and left in flight ran in it (the
    # card was drained): their syncs, now, close the ledger's account
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
    # every step dispatched in the window ran in it: the card was drained
    ran = eng.decode_steps - ran
    ctx += [s.length for s in eng.slots if s.active]
    require(eng.executor.captures == captures,
            f"{config}: a graph was captured inside the profile windows")
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    read = [e for e in kernels
            if READ_KERNEL[extra.get("KV_DTYPE") == "int8"] in e.key]
    kept = sum(e.count for e in read) / (L * ran)
    require(kept >= 0.9, f"{config}: the profiler kept {kept:.4f} of the "
            f"window's decode reads")
    host = {e.key: e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and HOST_LAUNCH.match(e.key)}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the kernels the host launched itself are the registered generator's
    # state fills before each replay, which the eager loop did not run;
    # the copies are counted, as they were there
    fills = sum(n for k, n in host.items() if "LaunchKernel" in k)
    per_step = (sum(e.count for e in kernels) - fills) / ran
    host_per_step = sum(host.values()) / ran
    log(f"profile decode {config} B=8 contexts {min(ctx)}-{max(ctx)}, "
        f"pipelined (depth {eng.pipeline_depth}, graphs): one window of "
        f"{wall_ms:.3f} ms under torch.profiler, the card idle at its start "
        f"and drained at its end, {ran} steps run on the card (the profiler "
        f"kept {kept:.4f} of their decode reads): wall_ms_per_step="
        f"{wall_ms / ran:.4f} device_busy_ms_per_step={busy_ms / ran:.4f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f}; 10 steps untraced, in "
        f"5-step windows: wall_ms_per_step={untraced_ms / untraced_steps:.4f}"
        f" as served, {bare_ms / untraced_steps:.4f} without the metrics "
        f"hook and the dispatch spans (windows on, off, off, on); host "
        f"launches per step={host_per_step:.3f} per block="
        f"{host_per_step * block:.2f} ({json.dumps(host)} over {ran} "
        f"steps); kernels and copies executed per step, the "
        f"generator fills aside={per_step:.3f} (rounded, at most "
        f"{LAUNCHES_PER_STEP[config]}) [{card}]")
    require(busy_ms <= wall_ms,
            f"{config}: the card's busy time {busy_ms:.3f} ms exceeds the "
            f"window's wall {wall_ms:.3f} ms")
    require(round(per_step) <= LAUNCHES_PER_STEP[config],
            f"{config}: {per_step:.3f} kernels per decode step, more than "
            f"{LAUNCHES_PER_STEP[config]}")
    lw = ledger_window(eng.util, stamps[0], stamps[1], before)
    log(f"profile decode {config}: utilization ledger over the window: "
        f"decode mfu={lw['mfu']:.5f} mbu={lw['mbu']:.5f} duty_cycle="
        f"{lw['duty_cycle']:.5f} ({lw['dispatches']} blocks, peaks "
        f"{lw['peak_source']}) beside the profiler's busy share "
        f"{busy_ms / wall_ms:.5f}; (sync, busy start) ms from the window's "
        f"start of the blocks synced from it on {lw['intervals']}, its end "
        f"{wall_ms:.3f} [{card}]")
    require(lw["dispatches"] * block == ran,
            f"{config}: the ledger accounted {lw['dispatches']} blocks of "
            f"the window's {ran // block}")
    require(max(lw["mfu"], lw["mbu"], lw["duty_cycle"]) <= UTIL_CAP,
            f"{config}: a utilization share above {UTIL_CAP}: {lw}")
    log(f"profile decode {config}: decode read: ms_per_step="
        f"{sum(e.self_device_time_total for e in read) / 1e3 / ran:.4f} "
        f"calls_per_step={sum(e.count for e in read) / ran:.0f}")
    gemm = [e for e in kernels if GEMM_KERNEL.search(e.key)]
    gemm_ms = sum(e.self_device_time_total for e in gemm) / 1e3
    log(f"profile decode {config}: matrix products: ms_per_step="
        f"{gemm_ms / ran:.4f} share_of_busy={gemm_ms / busy_ms:.4f} "
        f"kernels_per_step={sum(e.count for e in gemm) / ran:.1f}; the "
        f"rest (norms, rope, activations, quantization, sampling, copies): "
        f"ms_per_step={(busy_ms - gemm_ms) / ran:.4f} kernels_per_step="
        f"{per_step - sum(e.count for e in gemm) / ran:.1f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile decode {config} kernel: {e.key[:90]} ms_per_step="
            f"{e.self_device_time_total / 1e3 / ran:.4f} calls_per_step="
            f"{e.count / ran:.0f}")


def check_graph(eng, card: str, config: str) -> None:
    """The graph against the eager block at the served shape: equal greedy
    tokens, the caches or pools (and scales) left within MODEL_TOL, one
    decode read per layer and step in each. Then the same with every row
    sampled at temperature 0.7, logged: whether a replay draws the eager
    run's numbers."""
    from gofr_tpu_torch.tpu.graphcheck import graph_vs_eager

    g = graph_vs_eager(eng, eng.decode_block_size)
    L, block = eng.cfg.n_layers, eng.decode_block_size
    same = bool((g["graph"].cpu() == g["eager"].cpu()).all())
    log(f"check graph {config}: one {block}-step block replayed vs run "
        f"eagerly from the same state at B=8: greedy tokens "
        f"{'equal' if same else 'DIFFER'}; state max_abs_diff="
        f"{g['state_diff']:.3e} (tol {MODEL_TOL}); decode read launches "
        f"{g['graph_launches']} / {g['eager_launches']} (n_layers x block "
        f"= {L * block}) {'ok' if same else 'FAIL'} [{card}]")
    require(same, f"{config}: the graph's greedy tokens differ from eager")
    require(g["state_diff"] <= MODEL_TOL,
            f"{config}: the graph's KV differs from eager")
    require(g["graph_launches"] == g["eager_launches"] == L * block,
            f"{config}: decode read launches are not n_layers per step")
    s = graph_vs_eager(eng, block, temperature=0.7)
    agree = float((s["graph"].cpu() == s["eager"].cpu()).float().mean())
    log(f"check graph {config}: sampled at temperature 0.7, the replay's "
        f"tokens equal the eager run's at {agree:.3f} of positions (logged)")


def check_prefill_graph(eng, card: str, config: str) -> None:
    """Admission waves replayed from their graphs against the same waves
    run eagerly from the same state (graphcheck.prefill_graph_vs_eager): a
    full wave at [1, 256] and [4, 256] and, on the paged engine, a tail-only
    wave at [4, 256] over 2 cached pages, each at temperature 0 and 0.7:
    the first tokens equal, the loop state and the caches or pools (with
    their scales) bit-equal, and flash counted on the card n_layers times
    per full wave (none in a tail wave) under replay as when eager."""
    import torch

    from gofr_tpu_torch.tpu.graphcheck import prefill_graph_vs_eager
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    L = eng.cfg.n_layers
    waves = [(1, False), (4, False)]
    if isinstance(eng, PagedLLMEngine):
        waves.append((4, True))
    for K, tail in waves:
        for temperature in (0.0, 0.7):
            g = prefill_graph_vs_eager(eng, K, 256, tail, temperature)
            same = bool(torch.equal(g["graph"].cpu(), g["eager"].cpu()))
            flash = 0 if tail else L
            ok = (same and g["state_diff"] == 0.0
                  and g["graph_launches"] == g["eager_launches"] == flash)
            kind = "tail-only" if tail else "full"
            log(f"check prefill graph {config}: {kind} wave [{K}, 256] at "
                f"temperature {temperature} replayed vs "
                f"run eagerly from the same state: first tokens "
                f"{'equal' if same else 'DIFFER'}; state max_abs_diff="
                f"{g['state_diff']:.3e} (largest |K/V| "
                f"{g['state_max']:.3e}; the garbage page 0, left out: "
                f"{g['garbage_diff']:.3e}); flash launches "
                f"{g['graph_launches']} / {g['eager_launches']} (want "
                f"{flash}) {'ok' if ok else 'FAIL'} [{card}]")
            require(ok, f"{config}: the [{K}, 256] {kind} wave's graph "
                    f"differs from eager")


def warmup_true_phase(params, cfg, dev, card: str,
                      preset: str = "llama3-8b") -> None:
    """The reference's narrower warm set on the main path (paged, WARMUP=
    true: the admission at K=1 per bucket): one burst of 8 requests at
    bucket 256, all queued before the loop thread runs again (the switch
    interval held long across the submits), admits one K=8 wave, whose
    graph is captured on the loop thread. Logs that capture's seconds,
    the stall every request of the burst waits out, beside the burst's
    TTFT."""
    from gofr_tpu_torch.serve import build_engine

    env = {**QUIET, "MODEL_PRESET": preset, "ATTN_IMPL": "flash",
           "HTTP_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
           "PAGE_SIZE": "128", "PREFILL_BUCKETS": "16,32,64,128,256",
           "WARMUP": "true"}
    engine = build_engine(env, device=dev, params=params)
    try:
        boot_line(engine, "paged WARMUP=true", card)
        booted = set(engine.executor.cache_info())
        prompts = [engine.tokenizer.encode(make_prompt(200 + 5 * i, 200 + i))
                   for i in range(8)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(5.0)
        try:
            t0 = time.monotonic()
            reqs = [engine.submit(p, max_new_tokens=8) for p in prompts]
        finally:
            sys.setswitchinterval(interval)
        ttft = []
        for r in reqs:
            next(r.stream(timeout_s=600))
            ttft.append((time.monotonic() - t0) * 1e3)
        for r in reqs:
            r.result(timeout_s=600)
        shapes = dict(engine.prefill_shapes)
        new = {name: p.capture_seconds
               for name, p in engine.executor._cache.items()
               if name not in booted}
    finally:
        engine.stop()
    log(f"serve paged WARMUP=true: a burst of 8 at bucket 256 admitted as "
        f"{wave_list(shapes)}; graphs captured on the loop thread: "
        + ", ".join(f"{n} in {t:.3f}s" for n, t in new.items())
        + f"; burst ttft_ms p50={sorted(ttft)[4]:.1f} max={max(ttft):.1f} "
        f"[{card}]")
    require(any(K >= 4 for K, _ in shapes)
            and any(n.endswith(("x4", "x8")) for n in new),
            f"the burst did not admit a K >= 4 wave captured after boot: "
            f"{shapes}, {sorted(new)}")


# -- sampling controls, the sort-skip and the scoring passes (PR 10) ----------
# the sampling-controls burst: per row (temperature, top_p, top_k) and
# whether its tokens must equal the greedy ones (one survivor per step);
# rows 0-6 stream, row 7 is the non-streaming request
SC_ROWS = [(0.0, 0.0, 0, True), (1.0, 0.0, 1, True), (0.8, 1e-6, 0, True),
           (0.8, 0.0, 40, False), (0.8, 0.9, 0, False),
           (0.8, 0.9, 40, False), (0.0, 0.0, 0, True), (0.8, 0.0, 1, True)]
# + BOS, + 32 new tokens: every row fits the largest serving bucket (256),
# so the burst admits as one [8, 256] wave and every row can be scored
SC_CHARS = [150, 180, 200, 220, 130, 160, 170, 190]
SC_TOKENS = 32


def gate_admission(engine, n: int) -> None:
    """Hold the engine's admission until n requests are queued, then admit
    them in one round (so into one wave per bucket, whatever order the
    clients' requests arrive in) and stop holding."""
    admit = engine._admit

    def gated():
        if engine.queue_depth() >= n:
            engine._admit = admit
            admit()
    engine._admit = gated


def sc_burst(port, engine) -> dict:
    """The SC_CHARS prompts, 7 streams and 1 non-streaming request of
    SC_TOKENS tokens with SC_ROWS's sampling controls, admitted together
    as one wave with their rows in a fixed order (priority = row). Returns
    {row: its client record}."""
    out: dict = {}
    threads = []
    for row, (n, (temp, top_p, top_k, _)) in enumerate(zip(SC_CHARS,
                                                           SC_ROWS)):
        extra = {"priority": row, "temperature": temp, "top_p": top_p,
                 "top_k": top_k}
        target = stream_request if row < 7 else plain_request
        threads.append(threading.Thread(
            target=target, args=(port, make_prompt(n, 300 + row), SC_TOKENS,
                                 out, row, extra)))
    gate_admission(engine, len(threads))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    require(all(not t.is_alive() for t in threads), "sc burst: hung")
    return out


def burst_text(r) -> str:
    return r["text"] if "text" in r else (r["data"] or {}).get("text", "")


def oracle_logits(params, cfg, dev, ids):
    """The teacher-forced logits of `ids`, one llama_forward over the whole
    sequence (flash, T = S) from an empty cache: [len(ids), V] float32 on
    the card."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import init_kv_cache, llama_forward

    c = dataclasses.replace(cfg, attn_impl="flash")
    with torch.no_grad():
        k, v = init_kv_cache(c, 1, len(ids), device=dev)
        toks = torch.tensor([ids], dtype=torch.long, device=dev)
        pos = torch.arange(len(ids), device=dev)[None]
        return llama_forward(params, c, toks, pos, k, v)[0][0]


def in_filter(logits, tokens, temperature, top_p, top_k, boost=0.0) -> int:
    """How many of `tokens` (one per row of the [C, V] teacher-forced
    `logits`) lie in the set their row's filters allow at `temperature`:
    top_k keeps the k largest, then top_p the smallest prefix of the top_k
    renormalized distribution whose mass reaches top_p, i.e. a token whose
    tokens ahead hold less than top_p. boost: added to each token's own
    logit first (a tolerance for logits computed another way)."""
    import numpy as np

    n = 0
    for row, t in zip(logits, tokens):
        s = row.astype(np.float64) / temperature
        lt = s[t] + boost / temperature
        sd = np.sort(s)[::-1]
        ahead = int(np.sum(sd > lt))
        ok = not top_k or ahead < top_k
        if ok and top_p:
            kept = sd[:top_k] if top_k else sd
            p = np.exp(kept - kept[0])
            p /= p.sum()
            ok = float(p[:min(ahead, len(kept))].sum()) < top_p
        n += ok
    return n


def cut_tree(params, depth: int):
    """The first `depth` layers of a params tree, at full width (views)."""
    return {**params, "layers": {k: v[:depth]
                                 for k, v in params["layers"].items()}}


# the depth the sampling-controls and prefix phases serve at: their checks
# hold a stream against the teacher-forced oracle at its own depth, and a
# WARMUP=wide boot's captures scale with the layers
CUT_DEPTH = 4


def serve_sc_phase(params, cfg, dev, card: str, config: str,
                   preset: str = "llama3-8b", after=None) -> dict:
    """One serving configuration with SAMPLING_CONTROLS=true and
    WARMUP=wide, served at the depth of `params` (CUT_DEPTH layers in the
    full run; `cfg` of that depth): the boot (two decode graphs per shape,
    -sc names), then the SC_ROWS burst through POST /generate in one wave
    (7 streams, 1 non-streaming), counted as the serve phases count: flash
    n_layers per full wave, the decode kernel n_layers per step, every
    dispatch a graph replay, no capture after boot. The greedy, top_k=1
    and tiny top_p rows must take the teacher-forced oracle's argmax
    (oracle_logits at the same depth, over the row's own tokens) wherever
    its top two logits are more than 2 * MODEL_TOL apart; every token of
    the filtered rows must lie in its set by the oracle's logits
    (strictly, logged, and within MODEL_TOL of the logits, required); and
    engine.score(top=20) must rank each greedy row's token first within
    MODEL_TOL. after(app, engine), when given, runs on the served engine
    after those checks, before the shutdown (the OpenAI phase)."""
    import numpy as np
    import torch

    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine

    extra, decode_kernel = SERVE_CONFIGS[config]
    env = {**QUIET, "MODEL_PRESET": preset, "ATTN_IMPL": "flash",
           "HTTP_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
           "PAGE_SIZE": "128", "PREFILL_BUCKETS": "16,32,64,128,256",
           "REQUEST_TIMEOUT": "600", "WARMUP": "wide",
           "SAMPLING_CONTROLS": "true", "METRICS_PORT": "0",
           "TRACE_EXPORTER": "memory", **extra}
    engine = build_engine(env, device=dev, params=params)
    name = f"{config} sc"
    boot = boot_line(engine, name, card)
    names = set(engine.executor.cache_info())
    nosort = [n for n in names if n.endswith("-sc-nosort")]
    require(all(n.endswith(("-sc", "-sc-nosort")) for n in names)
            and nosort and all(n[:-len("-nosort")] in names for n in nosort),
            f"{name}: the programs are not the -sc set: {sorted(names)}")
    app = build_app(env, engine=engine)
    app.start()
    try:
        warm: dict = {}
        stream_request(app.http_port, make_prompt(40, 99), 4, warm, "w",
                       {"temperature": 0.8, "top_k": 40})
        require(warm["w"]["status"] == 200, f"{name}: warm-up failed")
        zero_counts(engine)
        t0 = time.monotonic()
        out = sc_burst(app.http_port, engine)
        wall = time.monotonic() - t0
        launches = launch_counts.counts()
        prefills, steps = engine.prefill_dispatches, engine.decode_steps
        dispatch = dispatch_counts(engine, boot)
        shapes = dict(engine.prefill_shapes)
        calls = engine.executor.cache_info()
        tok = engine.tokenizer
        rows = []
        for row, (n, (temp, top_p, top_k, one)) in enumerate(zip(SC_CHARS,
                                                                 SC_ROWS)):
            r = out[row]
            require(r["status"] in (200, 201), f"{name}: row {row} failed: "
                    f"{r['status']}")
            ids = tok.encode(burst_text(r), bos=False)
            rows.append((tok.encode(make_prompt(n, 300 + row)), ids))
        # the teacher-forced checks, after the counted run (the score
        # window programs are captured at their first use here)
        scored = [engine.score(p, c, top=20) for p, c in rows]
        if after is not None:
            after(app, engine)
    finally:
        app.shutdown()
    filt = sum(v for k, v in calls.items()
               if k.endswith("-sc") and "decode" in k)
    nosort = sum(v for k, v in calls.items() if k.endswith("-nosort"))
    log(f"serve {name}: 7 streams + 1 non-streaming x {SC_TOKENS} tokens, "
        f"rows (temperature, top_p, top_k) {[r[:3] for r in SC_ROWS]}, in "
        f"{wall:.2f}s; waves {wave_list(shapes)}; decode block replays with "
        f"the filters / without: {filt} / {nosort}")
    L = cfg.n_layers
    check_dispatch(name, dispatch, card)
    require(prefills > 0 and launches["flash_attention"] == L * prefills,
            f"{name}: flash launches do not match n_layers per full wave")
    require(steps > 0 and launches[decode_kernel] == L * steps,
            f"{name}: {decode_kernel} launches do not match n_layers per "
            f"decode step")
    same = [row for row, r in enumerate(SC_ROWS) if r[3]]
    for row in same:
        # the oracle at this depth, teacher-forced on the row's own tokens:
        # a greedy, top_k=1 or tiny top_p row must take its argmax wherever
        # the top two are further apart than the served bf16 logits can
        # move (a closer pair is a tie, where top_k=1 keeps both)
        prompt, got = rows[row]
        P = len(prompt)
        top2 = oracle_logits(params, cfg, dev, prompt + got)[
            P - 1:P - 1 + len(got)].float().topk(2, dim=-1)
        margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        argmax = top2.indices[:, 0].cpu().numpy()
        clear = margin > 2 * MODEL_TOL
        wrong = [j for j in range(len(got))
                 if clear[j] and argmax[j] != got[j]]
        log(f"serve {name}: row {row} {SC_ROWS[row][:3]}: {len(got)} "
            f"tokens, the oracle's argmax at {int(clear.sum())} positions "
            f"whose top two are more than {2 * MODEL_TOL} apart: "
            f"{'every one' if not wrong else f'missed at {wrong}'}; "
            f"smallest top-2 margin {float(margin.min()):.4f} "
            f"{'ok' if not wrong else 'FAIL'}")
        require(not wrong, f"{name}: row {row} left the oracle's argmax at "
                f"a step without a tie: {wrong}")
    first = total = 0
    worst = 0.0
    for row in same:
        chosen, ids, lps = scored[row]
        comp = np.asarray(rows[row][1])
        first += int((ids[:, 0] == comp).sum())
        total += len(comp)
        worst = max(worst, float((lps[:, 0] - chosen).max()))
    log(f"serve {name}: engine.score(top=20) over the greedy rows: "
        f"their token scored top-1 at {first} of {total} positions; the "
        f"largest gap between a token's scored logprob and the top one "
        f"{worst:.4f} (tol {MODEL_TOL}) "
        f"{'ok' if worst <= MODEL_TOL else 'FAIL'}")
    require(worst <= MODEL_TOL, f"{name}: a greedy row's token is not "
            f"the scored top-1 within {MODEL_TOL}")
    for row, (temp, top_p, top_k, one) in enumerate(SC_ROWS):
        if one:
            continue
        prompt, comp = rows[row]
        require(len(comp) >= 1, f"{name}: row {row} returned nothing")
        logits = oracle_logits(params, cfg, dev, prompt + comp)
        P = len(prompt)
        lg = logits[P - 1:P - 1 + len(comp)].float().cpu().numpy()
        strict = in_filter(lg, comp, temp, top_p, top_k)
        loose = in_filter(lg, comp, temp, top_p, top_k, 2 * MODEL_TOL)
        log(f"serve {name}: row {row} (T={temp}, top_p={top_p}, "
            f"top_k={top_k}): {strict}/{len(comp)} tokens inside the "
            f"filtered set by the teacher-forced logits, {loose}/{len(comp)}"
            f" within {2 * MODEL_TOL} of them "
            f"{'ok' if loose == len(comp) else 'FAIL'}")
        require(loose == len(comp), f"{name}: row {row} drew a token "
                f"outside its filtered set")
        del logits
    torch.cuda.empty_cache()
    return {"launches": launches}


def sort_skip_engine(params, cfg, dev, controls: bool):
    """The main path's engine (paged, flash prefill, 8 slots, bucket 256)
    with or without sampling controls, nothing captured ahead (each program
    at its first use), 8 greedy ~200-token requests of 600 new tokens
    admitted and driven, this thread playing the loop, until the pipeline
    is full of decode blocks."""
    import dataclasses

    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    c = dataclasses.replace(cfg, attn_impl="flash")
    eng = PagedLLMEngine(params, c, device=dev, n_slots=8, max_seq_len=1024,
                         prefill_buckets=(256,), page_size=128,
                         sampling_controls=controls)
    tok = DebugTokenizer(cfg.vocab_size)
    reqs = [eng.submit(tok.encode(make_prompt(200, 100 + i)),
                       max_new_tokens=600) for i in range(8)]
    for _ in range(eng.pipeline_depth + 1):
        eng._step()
    require(all(kind == "decode" for kind, *_ in eng._inflight),
            "sort skip: the pipeline is not full of decode blocks")
    return eng, reqs


def step_profile(eng, n_steps: int = 4) -> dict:
    """n_steps loop steps under torch.profiler, the card idle at the start
    and drained at the end (_window): per decode step, the card's busy
    time, the kernels it ran, and the sort kernels and their time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ran = eng.decode_steps
    captures = eng.executor.captures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _window(eng, n_steps)
    ran = eng.decode_steps - ran
    require(eng.executor.captures == captures,
            "sort skip: a graph was captured inside the window")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    sort = [e for e in kernels if "sort" in e.key.lower()]
    return {"busy": sum(e.self_device_time_total for e in kernels) / 1e3 / ran,
            "kernels": sum(e.count for e in kernels) / ran,
            "sorts": sum(e.count for e in sort) / ran,
            "sort_ms": sum(e.self_device_time_total for e in sort) / 1e3 / ran,
            "steps": ran,
            "row_filter": (eng._row_filter_now() if eng.sampling_controls
                           else None)}


# profiled windows of the plain and the all-greedy -sc step: their busy
# times are compared at the median window's, since one trace in a run on
# an H100 came back 9% short of its window's kernel time
SORT_SKIP_WINDOWS = 3


def median_window(eng, kind: str, card: str) -> dict:
    """SORT_SKIP_WINDOWS step_profile windows in a row, each logged; the
    one of median busy time."""
    runs = sorted((step_profile(eng) for _ in range(SORT_SKIP_WINDOWS)),
                  key=lambda r: r["busy"])
    log(f"sort skip: {kind} windows' card_busy_ms_per_step "
        f"{[round(r['busy'], 4) for r in runs]}, kernels_per_step "
        f"{[round(r['kernels'], 2) for r in runs]} [{card}]")
    return runs[len(runs) // 2]


def sort_skip_phase(params, cfg, dev, card: str) -> None:
    """The decode step at B=8 in the pipelined loop on the main path: the
    plain engine, a sampling-controls engine with every row greedy (its
    -nosort blocks), and the same engine once one row is replaced by a
    top_k=40 row at temperature 0.8 (its filter blocks). Logs card busy
    time, kernels and sort kernels per step (the plain and the all-greedy
    step at their median of SORT_SKIP_WINDOWS windows). Requires no sort
    in the all-greedy -sc step and its busy time within 3% of the plain
    step's, and sort kernels in the filter step. Then check_sc_graph on
    that engine."""
    import torch

    from gofr_tpu_torch.models.tokenizer import DebugTokenizer

    got = {}
    for controls in (False, True):
        eng, reqs = sort_skip_engine(params, cfg, dev, controls)
        kind = "plain" if not controls else "sc greedy"
        got[kind] = median_window(eng, kind, card)
        if controls:
            reqs[0].cancel()
            tok = DebugTokenizer(cfg.vocab_size)
            eng.submit(tok.encode(make_prompt(200, 100)), max_new_tokens=600,
                       temperature=0.8, top_k=40)
            for _ in range(eng.pipeline_depth + 2):
                eng._step()
            require(len(eng._filter_rows) == 1
                    and all(kind == "decode" for kind, *_ in eng._inflight),
                    "sort skip: the filter row is not live in a full "
                    "pipeline")
            got["sc one filter row"] = step_profile(eng)
            check_sc_graph(eng, card)
        del eng, reqs
        torch.cuda.empty_cache()
    for kind, r in got.items():
        log(f"sort skip: decode step B=8 paged, {kind}: card_busy_ms_per_step"
            f"={r['busy']:.4f} kernels_per_step={r['kernels']:.2f} "
            f"sort_kernels_per_step={r['sorts']:.2f} sort_ms_per_step="
            f"{r['sort_ms']:.4f} (per-row filters "
            f"{ {None: 'none', True: 'on', False: 'off'}[r['row_filter']]}; "
            f"{r['steps']} steps) [{card}]")
    plain, greedy, filt = (got["plain"], got["sc greedy"],
                           got["sc one filter row"])
    require(plain["busy"] > 0, "sort skip: the profiler saw no kernels")
    log(f"sort skip: the filter row's cost per step "
        f"{filt['busy'] - greedy['busy']:.4f} ms of card time (sort kernels alone {filt['sort_ms']:.4f}); the "
        f"all-greedy -sc step against the plain step "
        f"{greedy['busy'] / plain['busy']:.4f}x [{card}]")
    require(greedy["sorts"] == 0 and not greedy["row_filter"],
            "sort skip: the all-greedy -sc step ran a sort")
    require(abs(greedy["busy"] / plain["busy"] - 1) <= 0.03,
            "sort skip: the all-greedy -sc step is not within 3% of the "
            "plain step")
    require(filt["sorts"] > 0 and filt["row_filter"],
            "sort skip: the filter step ran no sort")


def check_sc_graph(eng, card: str) -> None:
    """On a sampling-controls engine in full flight: both decode variants
    (CONTROLS rows live, and all rows without controls), replayed against
    the same block run eagerly, and a [4, 256] admission wave with CONTROLS
    rows, each at temperature 0 and 0.8: equal tokens bit for bit, the
    state within MODEL_TOL (decode; logged) and bit-equal (wave), the
    variant asked for."""
    import torch

    from gofr_tpu_torch.tpu.graphcheck import (graph_vs_eager,
                                               prefill_graph_vs_eager)

    block, L = eng.decode_block_size, eng.cfg.n_layers
    for filters in (True, False):
        for temperature in (0.0, 0.8):
            g = graph_vs_eager(eng, block, temperature, filters)
            same = bool(torch.equal(g["graph"].cpu(), g["eager"].cpu()))
            ok = (same and g["state_diff"] <= MODEL_TOL
                  and g["row_filter"] == filters
                  and g["graph_launches"] == g["eager_launches"] == L * block)
            kind = "with" if filters else "without"
            log(f"check sc graph: decode block {kind} the per-row filters at "
                f"temperature {temperature}: tokens "
                f"{'equal' if same else 'DIFFER'}; state max_abs_diff="
                f"{g['state_diff']:.3e}; decode reads {g['graph_launches']} / "
                f"{g['eager_launches']} {'ok' if ok else 'FAIL'} [{card}]")
            require(ok, "the -sc decode graph differs from eager")
    for temperature in (0.0, 0.8):
        g = prefill_graph_vs_eager(eng, 4, 256, False, temperature,
                                   filters=True)
        same = bool(torch.equal(g["graph"].cpu(), g["eager"].cpu()))
        ok = (same and g["state_diff"] == 0.0
              and g["graph_launches"] == g["eager_launches"] == L)
        log(f"check sc graph: -sc wave [4, 256] with filter rows at "
            f"temperature {temperature}: first tokens "
            f"{'equal' if same else 'DIFFER'}; state max_abs_diff="
            f"{g['state_diff']:.3e} (page 0 aside: {g['garbage_diff']:.3e}); "
            f"flash {g['graph_launches']} / {g['eager_launches']} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        require(ok, "the -sc wave's graph differs from eager")


SCORE_BUCKETS = (16, 32, 64, 128, 256, 512)


def score_phase(params, cfg, dev, card: str,
                preset: str = "llama3-8b") -> None:
    """The scoring passes on the main path's engine (paged, flash, buckets
    16..512, no prefix cache) booted with WARMUP=wide and WARMUP_SCORE=true:
    the score
    family's boot; per bucket S a sequence of S tokens (half prompt, half
    completion) scored (top=20) and embedded against the teacher-forced
    oracle (oracle_logits; its final-norm hidden state): chosen and top
    logprobs within MODEL_TOL, top ids equal where the oracle's neighbours
    are more than 2 * MODEL_TOL apart, the embedding's cosine >= 0.999;
    wall per pass (mean of 5), card busy per pass (torch.profiler), flash
    launches per pass (counted on the card: n_layers at S <= 128, where the
    window is the bucket, else 0). Then 7 greedy streams decode while a
    second thread scores and embeds 8 sequences: the streams equal those of
    the same requests without it, nothing fails, no capture after boot."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.models.llama import init_kv_cache, llama_forward_hidden
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_engine

    # without the prefix cache the second run of the same prompts admits as
    # the first did (a prefix hit's tail prefill computes otherwise)
    env = {**QUIET, "MODEL_PRESET": preset, "ATTN_IMPL": "flash",
           "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
           "PREFILL_BUCKETS": ",".join(map(str, SCORE_BUCKETS)),
           "PREFIX_CACHE": "false", "WARMUP": "wide", "WARMUP_SCORE": "true"}
    engine = build_engine(env, device=dev, params=params)
    try:
        ex = engine.executor
        boot = ex.captures
        fam = {n: p for n, p in ex._cache.items()
               if n.startswith(("score-", "embed-"))}
        log(f"score: boot with WARMUP=wide in {engine.warmup_seconds:.2f}s, "
            f"then WARMUP_SCORE in {engine.score_warmup_seconds:.2f}s: "
            f"{len(fam)} window graphs ({', '.join(sorted(fam))}) captured in "
            f"{sum(p.capture_seconds for p in fam.values()):.2f}s, "
            f"{engine.score_pool_bytes} bytes of card memory "
            f"({engine.score_pool_bytes / 2**30:.3f} GiB; serving graphs "
            f"{engine.graph_pool_bytes / 2**30:.3f} GiB) [{card}]")
        require(set(fam) == {f"{f}-{S}x{math.gcd(S, 128)}"
                             for f in ("score", "embed")
                             for S in SCORE_BUCKETS},
                f"score: the warmed family is {sorted(fam)}")
        rng = np.random.default_rng(0)
        L = cfg.n_layers
        for S in SCORE_BUCKETS:
            W = math.gcd(S, 128)
            seq = rng.integers(259, cfg.vocab_size, S).tolist()
            P = S // 2
            prompt, comp = seq[:P], seq[P:]
            launch_counts.zero()
            chosen, ids, lps = engine.score(prompt, comp, top=20)
            flash = launch_counts.counts()["flash_attention"]
            emb = engine.embed(seq)
            lg = oracle_logits(params, cfg, dev, seq)
            lsm = torch.log_softmax(lg[P - 1:S - 1].float(), dim=-1)
            o_lps, o_ids = torch.topk(lsm, 20, dim=-1)
            o_chosen = torch.gather(lsm, 1, torch.tensor(
                comp, device=dev)[:, None])[:, 0].cpu().numpy()
            o_lps, o_ids = o_lps.cpu().numpy(), o_ids.cpu().numpy()
            c = dataclasses.replace(cfg, attn_impl="flash")
            with torch.no_grad():
                k, v = init_kv_cache(c, 1, S, device=dev)
                hid = llama_forward_hidden(
                    params, c, torch.tensor([seq], device=dev),
                    torch.arange(S, device=dev)[None], k, v)[0][0, -1]
            o_emb = hid.float().cpu().numpy()
            o_emb /= np.linalg.norm(o_emb)
            del lg, lsm, k, v, hid
            d_chosen = float(np.abs(chosen - o_chosen).max())
            d_lps = float(np.abs(lps - o_lps).max())
            gaps = np.abs(np.diff(o_lps, axis=1)) > 2 * MODEL_TOL
            clear = np.ones(o_ids.shape, dtype=bool)
            clear[:, :-1] &= gaps
            clear[:, 1:] &= gaps
            ids_ok = bool((ids[clear] == o_ids[clear]).all())
            cos = float(np.dot(emb, o_emb))
            bit = bool((chosen == o_chosen).all() and (lps == o_lps).all())

            def timed(fn):
                fn()
                t0 = time.monotonic()
                for _ in range(5):
                    fn()
                wall = (time.monotonic() - t0) / 5 * 1e3
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                busy = sum(e.self_device_time_total
                           for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
                return wall, busy / 1e3

            s_wall, s_busy = timed(lambda: engine.score(prompt, comp, top=20))
            e_wall, e_busy = timed(lambda: engine.embed(seq))
            windows = -(-(S - 1) // W)
            ok = (d_chosen <= MODEL_TOL and d_lps <= MODEL_TOL and ids_ok
                  and cos >= 0.999 and flash == (L if S <= 128 else 0))
            log(f"score S={S} W={W} ({windows} windows scored, "
                f"{-(-S // W)} embedded): chosen logprobs max_abs_diff="
                f"{d_chosen:.3e}, top-20 logprobs {d_lps:.3e} (tol "
                f"{MODEL_TOL}; bit-equal to the oracle: {bit}), top ids "
                f"{'equal' if ids_ok else 'DIFFER'} where clear; embedding "
                f"cosine {cos:.6f}; flash launches per score pass {flash} "
                f"(want {L if S <= 128 else 0}); score pass wall_ms="
                f"{s_wall:.3f} card_busy_ms={s_busy:.3f}; embed pass "
                f"wall_ms={e_wall:.3f} card_busy_ms={e_busy:.3f} "
                f"{'ok' if ok else 'FAIL'} [{card}]")
            require(ok, f"score S={S}: disagrees with the oracle")
        require(ex.captures == boot, "score: a window graph was captured "
                "after boot")

        tok = engine.tokenizer
        prompts = [tok.encode(make_prompt(n, 400 + i))
                   for i, n in enumerate(SC_CHARS[:7])]
        seqs = [rng.integers(259, cfg.vocab_size, n).tolist()
                for n in (12, 30, 60, 100, 200, 300, 450, 510)]

        def streams(passes: bool):
            gate_admission(engine, len(prompts))
            reqs = [engine.submit(p, max_new_tokens=SC_TOKENS, priority=i)
                    for i, p in enumerate(prompts)]
            errors, done = [], []

            def scorer():
                try:
                    for s in seqs:
                        engine.score(s[:len(s) // 2], s[len(s) // 2:], top=5)
                        engine.embed(s)
                        done.append(len(s))
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(exc)

            thread = threading.Thread(target=scorer)
            t0 = time.monotonic()
            if passes:
                thread.start()
            out = [r.result(timeout_s=600) for r in reqs]
            wall = time.monotonic() - t0
            if passes:
                thread.join(timeout=600)
                require(not thread.is_alive() and not errors
                        and len(done) == len(seqs),
                        f"score while serving: the passes failed: {errors}")
            return out, wall

        quiet, q_wall = streams(False)
        busy, b_wall = streams(True)
        same = sum(a == b for a, b in zip(quiet, busy))
        log(f"score while serving: 7 greedy streams x {SC_TOKENS} tokens "
            f"alone in {q_wall:.2f}s, and while a second thread scores and "
            f"embeds {len(seqs)} sequences (12-510 tokens) in {b_wall:.2f}s: "
            f"streams equal {same}/{len(quiet)}; graphs captured after boot "
            f"{ex.captures - boot} [{card}]")
        require(same == len(quiet), "score while serving: the streams "
                "changed")
        require(ex.captures == boot, "score while serving: a capture after "
                "boot")
    finally:
        engine.stop()
    torch.cuda.empty_cache()


# -- the OpenAI server (serve_openai.py) ------------------------------------
# the 7 streams' user turns: with the chat template ("user: ...\nassistant:")
# and the BOS, 150-240 tokens, the serve phases' prompt lengths
OPENAI_CHARS = [132, 162, 182, 202, 222, 112, 142]
OPENAI_TOKENS = 32
OPENAI_ENV = {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
              "HTTP_PORT": "0", "METRICS_PORT": "0", "MAX_BATCH": "8",
              "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
              "PREFILL_BUCKETS": "16,32,64,128,256", "REQUEST_TIMEOUT": "600",
              "WARMUP": "wide", "WARMUP_SCORE": "true",
              "SAMPLING_CONTROLS": "true", "TRACE_EXPORTER": "memory"}
TRACEPARENT = "00-{}-b7ad6b7169203331-01"


def openai_call(port, path, body, out, key, headers=None) -> None:
    """One OpenAI request; SSE bodies (stream=true) are read event by event
    with each content chunk's arrival time."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST" if body is not None else "GET", path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    rec = {"status": resp.status, "trace": resp.getheader("X-Trace-Id")}
    if body is not None and body.get("stream"):
        times, text, finish = [], [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            if line.strip() == b"data: [DONE]":
                resp.read()
                break
            choice = json.loads(line[6:])["choices"][0]
            piece = (choice["delta"].get("content", "")
                     if "delta" in choice else choice["text"])
            if piece:
                times.append(time.monotonic() - t0)
                text.append(piece)
            finish = choice["finish_reason"] or finish
        rec.update(times=times, text="".join(text), finish=finish)
    else:
        rec["data"] = json.loads(resp.read())
        rec["seconds"] = time.monotonic() - t0
    conn.close()
    out[key] = rec


def series_of(text: str) -> dict:
    """Prometheus exposition text as {name{labels}: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def scrape(port) -> dict:
    """The metrics server's series: {name{labels}: value}."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    require(resp.status == 200, f"GET /metrics answered {resp.status}")
    return series_of(text)


def hist_between(before: dict, after: dict, name: str, buckets):
    """A metrics.Histogram of the observations `name` gained between two
    scrapes (its cumulative bucket counts differenced)."""
    from gofr_tpu_torch.metrics import Histogram, format_bucket_bound

    cum = [after.get(f'{name}_bucket{{le="{format_bucket_bound(b)}"}}', 0.0)
           - before.get(f'{name}_bucket{{le="{format_bucket_bound(b)}"}}',
                        0.0) for b in buckets]
    cum.append(after.get(f'{name}_bucket{{le="+Inf"}}', 0.0)
               - before.get(f'{name}_bucket{{le="+Inf"}}', 0.0))
    counts = [int(c - p) for c, p in zip(cum, [0.0] + cum[:-1])]
    h = Histogram(name, name, buckets)
    if sum(counts):
        h.series[()] = {"counts": counts, "count": sum(counts),
                        "sum": after.get(f"{name}_sum", 0.0)
                        - before.get(f"{name}_sum", 0.0)}
    return h


def client_line(what, recs, card) -> dict:
    """Client TTFT (first content chunk) and decode tok/s per stream."""
    ttft = sorted(r["times"][0] * 1e3 for r in recs)
    tps = sorted((len(r["times"]) - 1) / (r["times"][-1] - r["times"][0])
                 for r in recs)
    n = len(recs)
    log(f"{what}: {n} concurrent streams x {OPENAI_TOKENS} tokens: ttft_ms "
        f"p50={ttft[n // 2]:.1f} max={ttft[-1]:.1f}; decode tok/s per stream "
        f"p50={tps[n // 2]:.1f} min={tps[0]:.1f} (client-side) [{card}]")
    return {"ttft_p50": ttft[n // 2], "tps_p50": tps[n // 2]}


def openai_phase(params, cfg, dev, card: str, gen_app, engine) -> None:
    """The OpenAI server (gofr_tpu_torch/serve_openai.py) on a started
    paged engine with sampling controls, WARMUP=wide and the scoring family
    captured (warmup_scoring: a no-op after WARMUP_SCORE=true), its
    container's metrics and its tracer's memory exporter; gen_app is the
    same engine's /generate app. Boot: the score windows warmup_scoring
    adds. Then (a) 7 chat prompts, rendered, as 7 concurrent streams
    through POST /generate at temperature 0, then (b) 7 others of the same
    lengths (no prefix-cache hit on (a)'s) as 7 concurrent streaming chat
    completions (one with a traceparent), then
    (c) at once: a non-streaming completion with logprobs=5 (with a
    traceparent), an n=4 completion at temperature 0.8 and top_p 0.9, a
    /v1/embeddings call with 2 inputs and GET /v1/models; then (d) a chat
    completion with a stop string from stream 0's text, then (e) 7 more
    /generate streams like (a), so that the two surfaces are timed in
    turns. Gates, on (b)-(d):
    every greedy request within MODEL_TOL of the teacher-forced oracle;
    the logprobs and the embeddings against the oracle as score_phase
    holds them; flash and the paged read launched; every decode block and
    wave a graph replay, no capture after the boot; on /metrics,
    app_tpu_requests_total grew by the engine requests, the
    app_tpu_ttft_seconds count by those that emitted a token,
    app_tpu_tokens_generated_total by the tokens delivered (before the
    stop-string truncation), app_http_response has a series per route; a
    traceparent comes back as X-Trace-Id, and its tpu.generate span is the
    child of the route's server span, streamed and not. Logs the client
    TTFT p50 and tok/s of (a), (b) and (e), the server histograms' TTFT and
    TPOT p50 over (b) (Histogram.percentile), and the phase's seconds."""
    import dataclasses

    import numpy as np
    import torch

    from gofr_tpu_torch import serve_openai
    from gofr_tpu_torch.models.llama import init_kv_cache, llama_forward_hidden
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.tpu.device import TPOT_BUCKETS, TTFT_BUCKETS

    t_phase = time.monotonic()
    ex = engine.executor
    t0 = time.monotonic()
    added = ex.captures
    engine.warmup_scoring()
    boot = ex.captures
    log(f"openai: warmup_scoring on the running engine: {boot - added} "
        f"window graphs captured in {time.monotonic() - t0:.2f}s [{card}]")
    app = serve_openai.build_app(OPENAI_ENV, engine=engine)
    app.start()
    tok = engine.tokenizer
    exporter = engine.tracer.exporter
    rec = record_tokens(engine)
    try:
        contents = [make_prompt(n, 600 + i)
                    for i, n in enumerate(OPENAI_CHARS)]
        rendered = [serve_openai._render_chat([{"role": "user",
                                                "content": c}])
                    for c in contents]
        lens = [len(tok.encode(r)) for r in rendered]
        require(max(lens) <= engine.admission_limit,
                f"openai: a prompt of {max(lens)} tokens")

        def burst(targets) -> float:
            threads = [threading.Thread(target=f, args=a) for f, a in targets]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            require(all(not t.is_alive() for t in threads),
                    "openai: requests hung")
            return time.monotonic() - t0

        # (a) /generate, the same engine and prompt lengths (other words:
        # the prefix cache must not serve (b) what (a) left in it)
        gen: dict = {}
        wall_a = burst([(stream_request, (
            gen_app.http_port, serve_openai._render_chat(
                [{"role": "user", "content": make_prompt(n, 620 + i)}]),
            OPENAI_TOKENS, gen, i)) for i, n in enumerate(OPENAI_CHARS)])
        require(all(gen[i]["status"] == 200 for i in range(7)),
                "openai: a /generate stream failed")
        before_b = scrape(app.metrics_port)
        rec.clear()
        zero_counts(engine)
        # (b) the chat streams
        trace_b = "%032x" % 0xb
        chats: dict = {}
        wall_b = burst([(openai_call, (
            app.http_port, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": c}],
             "max_tokens": OPENAI_TOKENS, "temperature": 0, "stream": True},
            chats, i, {"traceparent": TRACEPARENT.format(trace_b)}
            if i == 0 else None)) for i, c in enumerate(contents)])
        after_b = scrape(app.metrics_port)
        # (c) logprobs, n=4, embeddings, models
        trace_c = "%032x" % 0xc
        lp_prompt, n_prompt = make_prompt(200, 610), make_prompt(180, 611)
        emb_inputs = [make_prompt(100, 612), make_prompt(200, 613)]
        other: dict = {}
        wall_c = burst([
            (openai_call, (app.http_port, "/v1/completions",
                           {"prompt": lp_prompt, "max_tokens": OPENAI_TOKENS,
                            "temperature": 0, "logprobs": 5}, other, "lp",
                           {"traceparent": TRACEPARENT.format(trace_c)})),
            (openai_call, (app.http_port, "/v1/completions",
                           {"prompt": n_prompt, "max_tokens": OPENAI_TOKENS,
                            "temperature": 0.8, "top_p": 0.9, "n": 4},
                           other, "n")),
            (openai_call, (app.http_port, "/v1/embeddings",
                           {"input": emb_inputs}, other, "emb")),
            (openai_call, (app.http_port, "/v1/models", None, other,
                           "models"))])
        # (d) a stop string from stream 0's text
        stop = chats[0]["text"][4:6]
        t0 = time.monotonic()
        openai_call(app.http_port, "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": contents[0]}],
                     "max_tokens": OPENAI_TOKENS, "temperature": 0,
                     "stop": stop}, other, "stop")
        wall_d = time.monotonic() - t0
        after = scrape(app.metrics_port)
        launches = launch_counts.counts()
        dispatch = dispatch_counts(engine, boot)
        delivered = list(rec.values())
        # (e) /generate again, after the chat streams: (a) and (b) in turn
        gen2: dict = {}
        burst([(stream_request, (
            gen_app.http_port, serve_openai._render_chat(
                [{"role": "user", "content": make_prompt(n, 630 + i)}]),
            OPENAI_TOKENS, gen2, i)) for i, n in enumerate(OPENAI_CHARS)])
        require(all(gen2[i]["status"] == 200 for i in range(7)),
                "openai: a /generate stream of (e) failed")
        # the engine ends a request's tpu.generate span at its finish,
        # which its client may see first
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and sum(
                1 for sp in exporter.spans if sp.name == "tpu.generate"
                and sp.trace_id in (trace_b, trace_c)) < 2:
            time.sleep(0.01)
        spans = [sp for sp in exporter.spans
                 if sp.trace_id in (trace_b, trace_c)]
        emb_vecs = [np.asarray(e["embedding"], dtype=np.float32)
                    for e in other["emb"]["data"]["data"]]
    finally:
        del engine._emit_block
        app.shutdown()
    name = "openai"
    # the responses
    for i in range(7):
        require(chats[i]["status"] == 200 and chats[i]["finish"] in (
            "length", "stop"), f"{name}: chat stream {i} failed: {chats[i]}")
    for key in ("lp", "n", "emb", "stop"):
        require(other[key]["status"] == 201, f"{name}: {key} answered "
                f"{other[key]['status']}: {other[key].get('data')}")
    require(other["models"]["status"] == 200, f"{name}: /v1/models failed")
    n_choices = other["n"]["data"]["choices"]
    require(len(n_choices) == 4, f"{name}: n=4 returned {len(n_choices)}")
    # what the engine delivered in (b)-(d), request by request
    # (record_tokens): the 7 streams, the logprobs completion, the 4
    # choices, the stop request
    by_prompt: dict = {}
    for prompt, ids in delivered:
        by_prompt.setdefault(tuple(prompt), []).append(ids)
    require(len(delivered) == 13, f"{name}: {len(delivered)} engine "
            f"requests, want 13")
    lp_ids = tok.encode(lp_prompt)
    lp_comp = by_prompt[tuple(lp_ids)][0]
    stop_full = by_prompt[tuple(tok.encode(rendered[0]))]
    require(len(stop_full) == 2, f"{name}: stream 0's prompt ran "
            f"{len(stop_full)} times, want 2")
    stop_ids = stop_full[1]
    full = tok.decode(stop_ids)
    cut = full.find(stop)
    got_stop = other["stop"]["data"]["choices"][0]
    want_text = full[:cut] if cut >= 0 else full
    require(got_stop["message"]["content"] == want_text
            and got_stop["finish_reason"] == ("stop" if cut >= 0
                                              else "length"),
            f"{name}: the stop-string response does not match its tokens")
    log(f"{name}: stop string {stop!r} (stream 0's text [4:6]) "
        f"{'found' if cut >= 0 else 'NOT found'} in the stop request's "
        f"{len(stop_ids)} tokens: text cut to {len(want_text)} of "
        f"{len(full)} characters, finish_reason "
        f"{got_stop['finish_reason']}: ok")
    # greedy requests against the oracle: the streams, logprobs, stop
    greedy = [ids for prompt, ids in delivered
              if tuple(prompt) != tuple(tok.encode(n_prompt))]
    require(len(greedy) == 9, f"{name}: {len(greedy)} greedy requests")
    gaps, exact = [], []
    for prompt, ids in delivered:
        if tuple(prompt) == tuple(tok.encode(n_prompt)):
            continue
        g, e = oracle_gap(params, cfg, dev, list(prompt), ids)
        gaps.append(g)
        exact.append(e)
    log(f"{name}: {len(gaps)} greedy requests against the teacher-forced "
        f"plain oracle: exact argmax at {min(exact):.3f}-{max(exact):.3f} "
        f"of positions, largest gap to the oracle's top logit "
        f"{max(gaps):.3e} (tol {MODEL_TOL}) [{card}]")
    require(max(gaps) <= MODEL_TOL, f"{name}: a stream leaves the oracle's")
    # logprobs against the oracle (score_phase's rule)
    lp = other["lp"]["data"]["choices"][0]["logprobs"]
    P, C = len(lp_ids), len(lp_comp)
    require(len(lp["token_logprobs"]) == C and lp["tokens"] == [
        tok.decode_token(t) for t in lp_comp], f"{name}: logprobs cover "
        f"{len(lp['token_logprobs'])} of {C} tokens")
    lg = oracle_logits(params, cfg, dev, lp_ids + lp_comp)
    lsm = torch.log_softmax(lg[P - 1:P - 1 + C].float(), dim=-1)
    o_lps = torch.topk(lsm, 5, dim=-1).values.cpu().numpy()
    o_chosen = torch.gather(lsm, 1, torch.tensor(
        lp_comp, device=dev)[:, None])[:, 0].cpu().numpy()
    del lg, lsm
    d_chosen = float(np.abs(np.asarray(lp["token_logprobs"])
                            - o_chosen).max())
    d_top = max(float(np.abs(np.sort(list(row.values()))[::-1]
                             - o_lps[j, :len(row)]).max())
                for j, row in enumerate(lp["top_logprobs"]))
    log(f"{name}: logprobs=5 over {C} tokens against the oracle: chosen "
        f"max_abs_diff={d_chosen:.3e}, top-5 {d_top:.3e} (tol {MODEL_TOL}) "
        f"{'ok' if max(d_chosen, d_top) <= MODEL_TOL else 'FAIL'}")
    require(max(d_chosen, d_top) <= MODEL_TOL,
            f"{name}: logprobs disagree with the oracle")
    # the embeddings against the oracle
    c = dataclasses.replace(cfg, attn_impl="flash")
    cos = []
    for text, got in zip(emb_inputs, emb_vecs):
        ids = tok.encode(text)
        with torch.no_grad():
            k, v = init_kv_cache(c, 1, len(ids), device=dev)
            hid = llama_forward_hidden(
                params, c, torch.tensor([ids], device=dev),
                torch.arange(len(ids), device=dev)[None], k, v)[0][0, -1]
        o = hid.float().cpu().numpy()
        cos.append(float(np.dot(got, o / np.linalg.norm(o))))
        del k, v, hid
    log(f"{name}: /v1/embeddings, 2 inputs: cosine to the oracle "
        f"{min(cos):.6f}-{max(cos):.6f} (want >= 0.999) "
        f"{'ok' if min(cos) >= 0.999 else 'FAIL'}")
    require(min(cos) >= 0.999, f"{name}: an embedding disagrees")
    # the dispatch layer and the kernels
    check_dispatch(name, dispatch, card)
    log(f"{name}: launches " + " ".join(f"{k}={v}" for k, v in
                                         launches.items()))
    require(launches["flash_attention"] > 0
            and launches["paged_attention"] > 0,
            f"{name}: flash or the paged read did not launch")
    # /metrics
    d = {k: after.get(k, 0.0) - before_b.get(k, 0.0)
         for k in ("app_tpu_requests_total", "app_tpu_ttft_seconds_count",
                   "app_tpu_tokens_generated_total")}
    emitted = sum(1 for _, ids in delivered if ids)
    tokens = sum(len(ids) for _, ids in delivered)
    routes = {re.search(r'path="([^"]*)"', k).group(1)
              for k in after if k.startswith("app_http_response_count")}
    want_routes = {"/v1/chat/completions", "/v1/completions",
                   "/v1/embeddings", "/v1/models", "/generate"}
    log(f"{name}: /metrics over (b)-(d): app_tpu_requests_total "
        f"+{d['app_tpu_requests_total']:.0f} (engine requests "
        f"{len(delivered)}), app_tpu_ttft_seconds count "
        f"+{d['app_tpu_ttft_seconds_count']:.0f} (requests that emitted "
        f"{emitted}), app_tpu_tokens_generated_total "
        f"+{d['app_tpu_tokens_generated_total']:.0f} (tokens delivered "
        f"{tokens}); app_http_response routes {sorted(routes)}")
    require(d["app_tpu_requests_total"] == len(delivered)
            and d["app_tpu_ttft_seconds_count"] == emitted
            and d["app_tpu_tokens_generated_total"] == tokens,
            f"{name}: the engine's metrics disagree with its requests")
    require(want_routes <= routes, f"{name}: app_http_response lacks "
            f"{sorted(want_routes - routes)}")
    # the traces
    for trace, route, key in ((trace_b, "/v1/chat/completions", None),
                              (trace_c, "/v1/completions", "lp")):
        back = chats[0]["trace"] if key is None else other[key]["trace"]
        server = [sp for sp in spans if sp.trace_id == trace
                  and sp.name == f"POST {route}"]
        gen_spans = [sp for sp in spans if sp.trace_id == trace
                     and sp.name == "tpu.generate"]
        ok = (back == trace and len(server) == 1 and len(gen_spans) == 1
              and server[0].parent_id == "b7ad6b7169203331"
              and gen_spans[0].parent_id == server[0].span_id)
        log(f"{name}: traceparent on POST {route}: X-Trace-Id "
            f"{'equal' if back == trace else back}; spans of the trace "
            f"{sorted(sp.name for sp in spans if sp.trace_id == trace)}, "
            f"tpu.generate the child of the server span: "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name}: the trace of POST {route} is wrong")
    # the numbers
    a = client_line(f"{name}: (a) POST /generate", [
        {"times": gen[i]["times"]} for i in range(7)], card)
    b = client_line(f"{name}: (b) POST /v1/chat/completions stream",
                    [chats[i] for i in range(7)], card)
    client_line(f"{name}: (e) POST /generate again", [
        {"times": gen2[i]["times"]} for i in range(7)], card)
    ttft_h = hist_between(before_b, after_b, "app_tpu_ttft_seconds",
                          TTFT_BUCKETS)
    tpot_h = hist_between(before_b, after_b, "app_tpu_tpot_seconds",
                          TPOT_BUCKETS)
    log(f"{name}: server histograms over (b): app_tpu_ttft_seconds p50="
        f"{ttft_h.percentile(0.5) * 1e3:.1f} ms (bucket midpoint, "
        f"{ttft_h.series[()]['count']} samples; client p50 "
        f"{b['ttft_p50']:.1f}), app_tpu_tpot_seconds p50="
        f"{tpot_h.percentile(0.5) * 1e3:.2f} ms ("
        f"{tpot_h.series[()]['count']} samples; client 1000/tok/s "
        f"{1e3 / b['tps_p50']:.2f}) [{card}]")
    log(f"{name}: (a) {wall_a:.2f}s, (b) {wall_b:.2f}s, (c) {wall_c:.2f}s, "
        f"(d) {wall_d:.2f}s; the phase {time.monotonic() - t_phase:.1f}s "
        f"[{card}]")
    torch.cuda.empty_cache()


# -- checkpoints, int8 weights and the tokenizers ---------------------------
# the checkpoint's depth, at Llama-3-8B's full width: a full-depth one
# (16 GB) takes ~35 s on an H100 host to write and load twice, which the
# default run's time budget no longer holds
CKPT_DEPTH = 4
SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>")


def write_tokenizer_json(path: str, text: str, n_merges: int = 300) -> int:
    """A byte-level BPE tokenizer.json (HF's layout): the 256 byte pieces
    (ids 0-255), `n_merges` merges counted from `text` (each the most
    frequent adjacent pair within the port's pre-tokenizer pieces, ties to
    the first seen), then the two specials. Returns its vocab size."""
    import collections

    from gofr_tpu_torch.models.tokenizer import _compile_split, bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    words = collections.Counter(
        tuple(b2u[b] for b in piece.encode("utf-8"))
        for piece in _compile_split().findall(text))
    merges = []
    while len(merges) < n_merges:
        pairs = collections.Counter()
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
        merged = collections.Counter()
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    added = [{"id": len(vocab) + i, "content": c, "special": True}
             for i, c in enumerate(SPECIALS)]
    with open(path, "w", encoding="utf-8") as fp:
        json.dump({"model": {"type": "BPE", "vocab": vocab,
                             "merges": merges}, "added_tokens": added}, fp)
    return len(vocab) + len(added)


def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, prefix + k + ".")
        else:
            yield prefix + k, v


def trees_equal(got, want) -> list:
    """The leaves of two params trees that differ in name, dtype, shape or
    any bit; [] when they are equal."""
    import torch

    g, w = dict(_flat_tree(got)), dict(_flat_tree(want))
    bad = sorted(set(g) ^ set(w))
    for name in set(g) & set(w):
        a, b = g[name], w[name]
        if (a.dtype != b.dtype or a.shape != b.shape
                or not torch.equal(a, b)):
            bad.append(name)
    return bad


def weights_phase(params, cfg, dev, card: str):
    """A Llama-3-8B-width checkpoint of CKPT_DEPTH layers written with
    export_llama_safetensors, loaded in bf16 (the tree bit-equal to the
    exported one, and so are the logits of a 16-token prompt) and with
    weight_dtype="int8"
    (bit-equal to quantize_weights of the same tree, and its logits), each
    load's seconds, GB/s and peak card memory beside the tree's bytes;
    then llama_init_quantized at full size, bit-equal to
    quantize_weights(llama_init(seed 0)). Returns that int8 tree."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from gofr_tpu_torch.models.llama import (llama_forward_nocache,
                                             llama_init_quantized,
                                             params_nbytes, quantize_weights)
    from gofr_tpu_torch.models.weights import (export_llama_safetensors,
                                               load_llama_safetensors)

    full_bytes = params_nbytes(params)
    t0 = time.monotonic()
    q_full = quantize_weights({**params, "layers": dict(params["layers"])})
    torch.cuda.synchronize()
    log(f"weights: quantize_weights of the bf16 tree "
        f"{time.monotonic() - t0:.2f}s: {params_nbytes(q_full) / 1e9:.3f} GB "
        f"int8 against {full_bytes / 1e9:.3f} GB bf16 [{card}]")
    tmp = tempfile.mkdtemp(prefix="gofr-ckpt-")
    try:
        free = shutil.disk_usage(tmp).free
        depth = CKPT_DEPTH
        c = dataclasses.replace(cfg, n_layers=depth, attn_impl="xla",
                                decode_attn="xla")

        def cut(tree):
            return {**tree, "layers": {k: v[:depth]
                                       for k, v in tree["layers"].items()}}

        tree, q_tree = cut(params), cut(q_full)
        nbytes = params_nbytes(tree)
        path = os.path.join(tmp, "model.safetensors")
        t0 = time.monotonic()
        export_llama_safetensors(tree, path)
        took = time.monotonic() - t0
        log(f"weights: checkpoint at Llama-3-8B width, {depth} of "
            f"{cfg.n_layers} layers ({nbytes / 1e9:.3f} GB; "
            f"{free / 1e9:.1f} GB free in the temp dir), written in "
            f"{took:.2f}s ({nbytes / took / 1e9:.2f} GB/s)")
        gen = torch.Generator(device=dev).manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                             device=dev)
        for dtype, want in ((None, tree), ("int8", q_tree)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.monotonic()
            loaded = load_llama_safetensors(c, path, weight_dtype=dtype,
                                            device=dev)
            torch.cuda.synchronize()
            took = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            size = params_nbytes(loaded)
            bad = trees_equal(loaded, want)
            same = bool(torch.equal(llama_forward_nocache(loaded, c, toks),
                                    llama_forward_nocache(want, c, toks)))
            what = dtype or "bf16"
            log(f"weights: load {what}: {took:.2f}s ({nbytes / took / 1e9:.2f}"
                f" GB/s of checkpoint), tree {size / 1e9:.3f} GB, peak card "
                f"memory {peak / 1e9:.3f} GB (tree + {(peak - size) / 1e9:.3f}"
                f" GB in flight); tree bit-equal to "
                f"{'the exported one' if dtype is None else 'quantize_weights'}"
                f": {'yes' if not bad else bad[:4]}; logits of a 16-token "
                f"prompt bit-equal: {same} [{card}]")
            require(not bad and same, f"the {what} load disagrees: {bad[:4]}")
            del loaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    q8 = llama_init_quantized(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    took = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    bad = trees_equal(q8, q_full)
    log(f"weights: llama_init_quantized(llama3_8b, seed 0) {took:.2f}s: "
        f"params_nbytes {params_nbytes(q8)} ({params_nbytes(q8) / 1e9:.3f} "
        f"GB, bf16 {full_bytes / 1e9:.3f} GB), peak card memory "
        f"{peak / 1e9:.3f} GB; bit-equal to quantize_weights(llama_init): "
        f"{'yes' if not bad else bad[:4]} [{card}]")
    require(not bad, f"llama_init_quantized disagrees: {bad[:4]}")
    del q_full
    torch.cuda.empty_cache()
    return q8


def greedy_vs_oracle(engine, params, cfg, dev, card: str,
                     n_new: int = 24) -> None:
    """A greedy stream of the served engine against the plain-PyTorch
    oracle on the same weights: the whole sequence teacher-forced through
    llama_forward_nocache (no cache, f32 attention); every token must be
    the oracle's argmax or within MODEL_TOL_W8 of its top logit (ties),
    and the share of exact argmaxes is logged."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_forward_nocache

    prompt = engine.tokenizer.encode(make_prompt(200, 77))
    got = engine.generate(prompt, max_new_tokens=n_new)
    plain = dataclasses.replace(cfg, attn_impl="xla", decode_attn="xla",
                                kv_dtype=None)
    seq = torch.tensor([prompt + got[:-1]], device=dev)
    with torch.no_grad():
        logits = llama_forward_nocache(params, plain, seq)[0, len(prompt) - 1:]
    top = logits.max(dim=-1).values
    chosen = logits[torch.arange(len(got), device=dev),
                    torch.tensor(got, device=dev)]
    gap = float((top - chosen).max())
    exact = float((logits.argmax(dim=-1).cpu()
                   == torch.tensor(got)).float().mean())
    log(f"check int8 weights: a greedy stream of {len(got)} tokens after a "
        f"{len(prompt)}-token prompt against the plain oracle on the same "
        f"int8 tree (teacher-forced): exact argmax at {exact:.3f} of "
        f"positions, largest gap to the oracle's top logit {gap:.3e} (tol "
        f"{MODEL_TOL_W8}) {'ok' if gap <= MODEL_TOL_W8 else 'FAIL'} "
        f"[{card}]")
    require(len(got) == n_new and gap <= MODEL_TOL_W8,
            "the int8 engine's greedy stream leaves the oracle's")


def tokenizer_check(app, engine, card: str, vocab_path: str) -> None:
    """VOCAB_PATH's loader (serve.load_tokenizer) on the script's
    tokenizer.json: the byte-level tokenizer with the native BPE core
    built and active, equal to the Python merge loop on a long prompt
    (README.md), encode tokens/s of both; then /generate served with it
    on the running int8-weight engine (a second app over the same engine):
    a stream and a non-streaming request of their full length."""
    import os

    from gofr_tpu_torch.serve import build_app, load_tokenizer

    tok = load_tokenizer(vocab_path)
    require(type(tok).__name__ == "ByteLevelBPETokenizer"
            and tok._native is not None,
            "VOCAB_PATH did not load the byte-level tokenizer with the "
            "native core")
    require(tok.vocab_size <= engine.cfg.vocab_size,
            "the tokenizer outgrows the model's vocabulary")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "README.md"), encoding="utf-8") as fp:
        text = fp.read()
    t0 = time.monotonic()
    fast = tok._encode_text(text)
    t_native = time.monotonic() - t0
    t0 = time.monotonic()
    slow = tok._encode_text(text, native=False)
    t_python = time.monotonic() - t0
    log(f"tokenizer: {tok.vocab_size} ids, native core active; README.md "
        f"({len(text)} chars) -> {len(fast)} tokens, native "
        f"{len(fast) / t_native:.0f} tok/s, Python loop "
        f"{len(slow) / t_python:.0f} tok/s ({t_python / t_native:.1f}x), "
        f"ids equal: {fast == slow}")
    require(fast == slow, "the native core and the Python loop disagree")
    saved = engine.tokenizer
    engine.tokenizer = tok
    app2 = build_app({**QUIET, "HTTP_PORT": "0", "VOCAB_PATH": vocab_path},
                     engine=engine)
    app2.start()
    out: dict = {}
    prompt = text[:240]
    try:
        # min_tokens: the stream's length does not hang on whether the
        # random model samples the tokenizer's EOS
        stream_request(app2.http_port, prompt, 16, out, "s",
                       {"min_tokens": 16})
        plain_request(app2.http_port, prompt, 8, out, "p", {"min_tokens": 8})
    finally:
        # the HTTP server only: the engine belongs to the serve phase
        app2._http_server.shutdown()
        engine.tokenizer = saved
    require(out["s"]["status"] == 200 and out["s"]["done"]["tokens"] == 16
            and out["p"]["status"] == 201 and out["p"]["data"]["tokens"] == 8,
            f"/generate with the BPE tokenizer failed: {out}")
    log(f"tokenizer: /generate on the int8-weight engine with VOCAB_PATH's "
        f"tokenizer: a {len(tok.encode(prompt))}-token prompt, a stream of "
        f"16 and a request of 8 tokens served [{card}]")


def time_q_matmul(params, q8, cfg, dev, flush, card: str) -> None:
    """_q_matmul at the decode shape (8 rows, padded to 32 for _int_mm) for
    each product of a layer and the head, by CUDA events with the L2
    flushed (the wrapper's host time included) and on the card alone
    (replayed from a CUDA graph, every kernel of the call, as the decode
    graphs run it, each call on the next layer's weight so that none is
    in L2), beside its byte
    bound (the int8 weight, its scales, x and out read or written once at
    3.35 TB/s), _int_mm alone and the bf16 product it replaces; then the
    sums over a decode step (32 layers and the head)."""
    import torch

    from gofr_tpu_torch.models.llama import _int_matmul, _q_matmul

    def alone(fn, iters=20):
        """Device ms per call: fn(0), ..., fn(iters - 1) captured in one
        CUDA graph (after one eager call on a side stream), its replay
        timed by CUDA events, the mean of 3 replays (torch.profiler lost
        some of these calls' records on an H100)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(i)
        graph.replay()
        total = 0.0
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        del graph
        return total / 3 / iters

    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")
    step = dict.fromkeys(("bound", "q", "q_alone", "int_mm", "bf16"), 0.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for name in names:
        top = name == "lm_head"
        # one [1, ...] stack for the head, which is read whole each call
        w8s = q8[name][None] if top else q8["layers"][name]
        ss = q8[name + "_s"][None] if top else q8["layers"][name + "_s"]
        wbs = params[name][None] if top else params["layers"][name]
        L = w8s.shape[0]
        w8, s = w8s[0], ss[0]
        K, N = w8.shape
        x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
        x8 = torch.randint(-127, 128, (32, K), generator=gen, device=dev,
                           dtype=torch.int8)
        bound = (K * N + 4 * N + 2 * 8 * K + 2 * 8 * N) / H100_HBM_BYTES_S * 1e3
        r = {"bound": bound,
             "q": time_ms(lambda: _q_matmul(x, w8, s), 20, flush),
             "q_alone": alone(lambda i: _q_matmul(x, w8s[i % L],
                                                  ss[i % L])),
             "int_mm": alone(lambda i: _int_matmul(x8, w8s[i % L])),
             "bf16": alone(lambda i: x @ wbs[i % L])}
        times = 1 if top else cfg.n_layers
        for k in step:
            step[k] += times * r[k]
        log(f"time _q_matmul {name} [8, {K}] x [{K}, {N}] int8: ev "
            f"{r['q']:.4f} ms, alone {r['q_alone']:.4f} ms (share "
            f"{bound / r['q_alone']:.3f}); _int_mm alone at 32 rows "
            f"{r['int_mm']:.4f} ms; bound {bound:.4f} ms (bytes); the bf16 "
            f"product alone {r['bf16']:.4f} ms [{card}]")
    log(f"time _q_matmul per decode step (x{cfg.n_layers} layers + head): "
        f"alone {step['q_alone']:.4f} ms ({step['int_mm']:.4f} of it "
        f"_int_mm), bound {step['bound']:.4f} ms, the bf16 products alone "
        f"{step['bf16']:.4f} ms [{card}]")


def w8_phase(params, cfg, dev, card: str, flush, depth: int) -> None:
    """The weights phases: the checkpoint round trip, int8 weights served on
    the main path at `depth` layers, full width (WARMUP=wide, as the four
    serve phases; counted, with VOCAB_PATH's tokenizer served after the
    counted run and a greedy stream against the plain oracle at that
    depth), check_model on the int8 tree, the pipelined decode profile and
    graph-vs-eager on it at full depth, and _q_matmul's times at the decode
    shape."""
    import dataclasses
    import os
    import tempfile

    import torch

    q8 = weights_phase(params, cfg, dev, card)
    check_model(q8, cfg, dev, MODEL_TOL_W8)
    vocab_dir = tempfile.mkdtemp(prefix="gofr-vocab-")
    vocab_path = os.path.join(vocab_dir, "tokenizer.json")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "README.md"), encoding="utf-8") as fp:
        n = write_tokenizer_json(vocab_path, fp.read())
    log(f"tokenizer: wrote a byte-level tokenizer.json of {n} ids (256 "
        f"bytes, merges counted from README.md, 2 specials)")

    def after(app, engine):
        # HBM_BUDGET_BYTES unset: the plan is made from the card's memory
        require(engine.plan is not None and engine.plan.fits,
                "no capacity plan on the card")
        log(f"capacity: {engine.plan.summary()} [{card}]")
        greedy_vs_oracle(engine, cut, cut_cfg, dev, card)
        tokenizer_check(app, engine, card, vocab_path)

    # the default run serves the burst at CUT_DEPTH, as the sc and prefix
    # phases (a WARMUP=wide boot's captures scale with the layers);
    # --weights serves it at full depth
    cut, cut_cfg = ((q8, cfg) if depth == cfg.n_layers else
                    (cut_tree(q8, depth),
                     dataclasses.replace(cfg, n_layers=depth)))
    serve_phase(cut, cut_cfg, dev, card, "paged-w8", after=after)
    torch.cuda.empty_cache()
    eng = decode_engine(q8, cfg, dev, "paged-w8")
    profile_decode(eng, card, "paged-w8")
    check_graph(eng, card, "paged-w8")
    del eng
    torch.cuda.empty_cache()
    time_q_matmul(params, q8, cfg, dev, flush, card)
    os.remove(vocab_path)
    os.rmdir(vocab_dir)


# -- speculative verify and chunked prefill (phase 10) -----------------------
SPEC_TOKENS = 48
SPEC_CHARS = [150, 180, 200, 220, 240, 130, 160]
SPEC_PLAIN_CHARS = 250
SPEC_ENV = {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
            "HTTP_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
            "PAGE_SIZE": "128", "PREFILL_BUCKETS": "16,32,64,128,256",
            "REQUEST_TIMEOUT": "600", "WARMUP": "wide",
            "SPECULATIVE_TOKENS": "4"}


def rag_prompt(n_chars: int, seed: int) -> str:
    """A passage and then the passage again, as a RAG prompt quotes its
    retrieved text: the second copy gives bigram drafts to look up."""
    half = make_prompt(n_chars // 2, seed)
    return (half + " " + half)[:n_chars]


def spec_prompts():
    """7 stream prompts (every other one a repeated passage) and the
    non-streaming one."""
    prompts = [(rag_prompt if i % 2 == 0 else make_prompt)(n, 500 + i)
               for i, n in enumerate(SPEC_CHARS)]
    return prompts, rag_prompt(SPEC_PLAIN_CHARS, 507)


def serve_traffic(port, prompts, plain_prompt, n_tok) -> tuple:
    """The streams and the non-streaming request of `prompts` at once;
    returns (client records, wall seconds)."""
    out: dict = {}
    threads = [threading.Thread(target=stream_request,
                                args=(port, p, n_tok, out, i))
               for i, p in enumerate(prompts)]
    threads.append(threading.Thread(target=plain_request, args=(
        port, plain_prompt, n_tok, out, "plain")))
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    require(all(not t.is_alive() for t in threads), "requests hung")
    return out, time.monotonic() - t0


def oracle_gap(params, cfg, dev, prompt_ids, got) -> tuple:
    """A greedy stream against the teacher-forced plain oracle
    (llama_forward_nocache, f32 attention, on the same weights): (the
    largest gap between the oracle's top logit and the chosen token's,
    the share of positions where the chosen token is the oracle's
    argmax)."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_forward_nocache

    plain = dataclasses.replace(cfg, attn_impl="xla", decode_attn="xla",
                                kv_dtype=None)
    seq = torch.tensor([prompt_ids + got[:-1]], device=dev)
    with torch.no_grad():
        logits = llama_forward_nocache(params, plain, seq)[
            0, len(prompt_ids) - 1:]
    chosen = torch.tensor(got, device=dev)
    top = logits.max(dim=-1).values
    gap = float((top - logits[torch.arange(len(got), device=dev),
                              chosen]).max())
    exact = float((logits.argmax(dim=-1) == chosen).float().mean())
    return gap, exact


def record_tokens(engine) -> dict:
    """From now on keep the ids the engine delivers to each request:
    {request id: (prompt ids, delivered ids)} (the served text drops the
    special ids)."""
    rec: dict = {}
    emit = engine._emit_block

    def kept(request, tokens):
        rec.setdefault(request.id, (request.prompt_tokens, []))[1].extend(
            tokens)
        emit(request, tokens)
    engine._emit_block = kept
    return rec


def check_streams(what, params, cfg, dev, rec, n_tok, card) -> None:
    """Every request recorded (record_tokens) got n_tok ids, and each
    passes the teacher-forced oracle check within MODEL_TOL (bf16
    near-ties: the verify window reads through the plain einsum, decode
    through the CUDA read)."""
    gaps, exact = [], []
    for prompt, ids in rec.values():
        require(len(ids) == n_tok, f"{what}: a request got {len(ids)} of "
                f"{n_tok} tokens")
        g, e = oracle_gap(params, cfg, dev, list(prompt), ids)
        gaps.append(g)
        exact.append(e)
    log(f"{what}: {len(rec)} greedy requests x {n_tok} tokens against the "
        f"teacher-forced plain oracle: exact argmax at "
        f"{min(exact):.3f}-{max(exact):.3f} of positions, largest gap to the "
        f"oracle's top logit {max(gaps):.3e} (tol {MODEL_TOL}) [{card}]")
    require(max(gaps) <= MODEL_TOL, f"{what}: a stream leaves the oracle's")


def traffic_line(what, out, n, wall, card) -> dict:
    ttft = sorted(out[i]["times"][0] * 1e3 for i in range(n))
    tps = sorted((len(out[i]["times"]) - 1)
                 / (out[i]["times"][-1] - out[i]["times"][0])
                 for i in range(n))
    log(f"{what}: {n} streams + 1 non-streaming in {wall:.2f}s: ttft_ms "
        f"p50={ttft[n // 2]:.1f} max={ttft[-1]:.1f}; decode tok/s per stream "
        f"p50={tps[n // 2]:.1f} min={tps[0]:.1f} max={tps[-1]:.1f} [{card}]")
    return {"ttft_p50": ttft[n // 2], "tps_p50": tps[n // 2]}


def drop_prefix(engine) -> None:
    """Empty the prefix cache's idle pages back into the pool (the engine's
    loop stopped), so a second run of the same prompts misses as the
    first did."""
    if getattr(engine, "prefix", None) is not None:
        engine.allocator.release(engine.prefix.drop_all_idle())


def spec_phase(params, cfg, dev, card: str) -> None:
    """The main path (paged, prefix cache on) with SPECULATIVE_TOKENS=4 and
    WARMUP=wide (the 8 requests admit as one K=8 wave, which WARMUP=true
    would capture on the loop) through POST /generate: 7 greedy streams x SPEC_TOKENS and
    1 non-streaming request, every other prompt a repeated passage; then
    the same traffic on the same engine with speculation off
    (speculative_tokens 0, the loop restarted, the prefix cache emptied).
    Logs per run the verifies, drafted / accepted tokens per eligible row,
    cooloffs and zero-draft rounds, the flash and paged-read launches
    counted on the card, TTFT and tok/s. Gates: no capture after boot,
    every dispatch a graph replay, flash n_layers per full wave and the
    paged read n_layers per decode step (verifies read by the plain
    einsum), every stream against the oracle, pages all released."""
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine

    engine = build_engine(SPEC_ENV, device=dev, params=params)
    boot = boot_line(engine, "paged spec", card)
    prompts, plain_prompt = spec_prompts()
    L = cfg.n_layers
    res = {}
    for label, d in (("spec", 4), ("spec off", 0)):
        engine.speculative_tokens = d
        drop_prefix(engine)
        engine.start()
        app = build_app(SPEC_ENV, engine=engine)
        app.start()
        try:
            warm: dict = {}
            stream_request(app.http_port, make_prompt(40, 99), 4, warm, "w")
            require(warm["w"]["status"] == 200, "spec: warm-up failed")
            zero_counts(engine)
            rec = record_tokens(engine)
            out, wall = serve_traffic(app.http_port, prompts, plain_prompt,
                                      SPEC_TOKENS)
            del engine._emit_block
            launches = launch_counts.counts()
            dispatch = dispatch_counts(engine, boot)
            counts = {k: getattr(engine, k) for k in SPEC_CHUNK_COUNTS}
            steps, prefills = engine.decode_steps, engine.prefill_dispatches
        finally:
            app.shutdown()
        what = f"serve paged {label}"
        p = out["plain"]
        require(p["status"] == 201 and p["data"]["tokens"] == SPEC_TOKENS,
                f"{what}: non-streaming request failed: {p}")
        res[label] = traffic_line(what, out, len(prompts), wall, card)
        check_dispatch(f"paged {label}", dispatch, card)
        elig = max(1, counts["spec_eligible"])
        log(f"{what}: {counts['verify_dispatches']} verifies, "
            f"{engine.decode_blocks} decode blocks ({steps} steps); per "
            f"eligible row and verify: drafted "
            f"{counts['spec_drafted'] / elig:.3f}, accepted "
            f"{counts['spec_accepted'] / elig:.3f} ({counts['spec_eligible']}"
            f" eligible rows over the verifies); cooloffs "
            f"{counts['spec_cooloffs']}, zero-draft rounds "
            f"{counts['spec_zero_draft']}; launches on the card: flash "
            f"{launches['flash_attention']} ({prefills} full waves), "
            f"paged_attention {launches['paged_attention']} [{card}]")
        require(launches["flash_attention"] == L * prefills,
                f"{what}: flash launches are not n_layers per full wave")
        require(launches["paged_attention"] == L * steps,
                f"{what}: paged reads are not n_layers per decode step")
        require(d == 0 or counts["verify_dispatches"]
                + counts["spec_zero_draft"] > 0,
                f"{what}: speculation never ran")
        check_streams(what, params, cfg, dev, rec, SPEC_TOKENS, card)
    drop_prefix(engine)
    require(engine.allocator.used_pages == 0,
            f"spec: {engine.allocator.used_pages} pages still used")
    log(f"serve paged spec vs off, the same traffic and engine: ttft_ms p50 "
        f"{res['spec']['ttft_p50']:.1f} / {res['spec off']['ttft_p50']:.1f}; "
        f"decode tok/s per stream p50 {res['spec']['tps_p50']:.1f} / "
        f"{res['spec off']['tps_p50']:.1f}; pages all released [{card}]")
    del engine
    import torch
    torch.cuda.empty_cache()
    verify_profile(params, cfg, dev, card)
    dense_spec_reduced(params, cfg, dev, card)


def time_events(fn, iters: int) -> float:
    """ms per call of fn by CUDA events, after one warm call."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# a verify's kernels by kind, the first pattern that matches a name: the
# f32 products of the plain einsum, the model-dtype products (the layers and
# the head), softmax, the page gather (advanced indexing), copies and casts
VERIFY_SPLIT = (
    ("f32 products", re.compile(r"sgemm|simt|gemm.*f32_f32|fp32|tf32",
                                re.IGNORECASE)),
    ("bf16 products", GEMM_KERNEL),
    ("softmax", re.compile(r"softmax", re.IGNORECASE)),
    ("gather", re.compile(r"index", re.IGNORECASE)),
    ("copies and casts", re.compile(r"copy", re.IGNORECASE)),
)


def verify_profile(params, cfg, dev, card: str) -> None:
    """A paged spec engine at B=8 driven by hand past its prefills
    (contexts ~200 tokens): drafts every row accepts in full
    (graphcheck.greedy_drafts, so the check does not wait on random
    weights to repeat themselves); the verify graph against eager
    (graphcheck.verify_graph_vs_eager: outputs bit-equal, the pools outside
    page 0 bit-equal); then that verify dispatched as the loop dispatches it
    (upload and replay, then its sync), from the same state each time:
    host wall and card time (CUDA events) per verify against a 16-step
    decode block's per step, its matrix-product kernels (torch.profiler);
    the verify's parts timed by events at its shape (the page gather, the
    plain einsum read, the head); and the window's lm_head as one product
    against one per position."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.models.llama import (_gather_rows, _head,
                                             _masked_read, _verify_head)
    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.tpu.graphcheck import (greedy_drafts, state_tensors,
                                               verify_graph_vs_eager)
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    c = dataclasses.replace(cfg, attn_impl="flash")
    eng = PagedLLMEngine(params, c, page_size=128, device=dev, n_slots=8,
                         max_seq_len=1024, prefill_buckets=(256,),
                         speculative_tokens=4)
    tok = DebugTokenizer(cfg.vocab_size)
    for i in range(8):
        eng.submit(tok.encode(rag_prompt(200, 600 + i)), max_new_tokens=600)
    for _ in range(3):
        eng._step()
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
    drafts, lens = greedy_drafts(eng)
    g = verify_graph_vs_eager(eng, drafts, lens)
    same = bool(torch.equal(g["graph"].cpu(), g["eager"].cpu()))
    ok = same and g["state_diff"] == 0.0 and g["accepted"] == 4 * g["rows"]
    log(f"check verify graph paged: one verify (B=8, d=4, {g['rows']} rows "
        f"drafting their greedy continuation, {g['accepted']} drafts "
        f"accepted) replayed vs run eagerly from the same state: tokens and "
        f"emit counts {'equal' if same else 'DIFFER'}; pools max_abs_diff="
        f"{g['state_diff']:.3e} (largest |K/V| {g['state_max']:.3e}; the "
        f"garbage page 0, left out: {g['garbage_diff']:.3e}) "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    require(ok, "the verify graph differs from eager")
    ctx = [s.length for s in eng.slots if s.active]
    table = eng._build_table()
    state = state_tensors(eng)
    saved = [t.clone() for t in state]
    rng = eng.generator.get_state()

    def restore():
        for t, s in zip(state, saved):
            t.copy_(s)
        eng.generator.set_state(rng)

    def dispatch_times(program, arrays, n):
        """(host wall ms, card ms) per dispatch of `program`, uploaded and
        replayed from the same state, then synced, n times."""
        wall = card_ms = 0.0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
        with torch.no_grad(), eng._stream_ctx():
            for _ in range(n + 1):
                restore()
                torch.cuda.synchronize()
                t0 = time.monotonic()
                start.record()
                eng._call(program, arrays)
                end.record()
                torch.cuda.synchronize()
                if _:
                    wall += (time.monotonic() - t0) * 1e3
                    card_ms += start.elapsed_time(end)
            restore()
        return wall / n, card_ms / n

    vprog = eng._verify_program(table.shape[1], True)
    vwall, vcard = dispatch_times(vprog, (table, drafts, lens), 10)
    block = eng.decode_block_size
    dprog = eng._decode_program_paged(table.shape[1], block, True)
    dwall, dcard = dispatch_times(dprog, (table,), 5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.no_grad(), eng._stream_ctx():
            for _ in range(3):
                eng._call(vprog, (table, drafts, lens))
                torch.cuda.synchronize()
                restore()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy" not in e.key]      # the restores between runs
    split: dict = {}
    for e in kernels:
        kind = next((k for k, pat in VERIFY_SPLIT if pat.search(e.key)),
                    "other")
        split[kind] = split.get(kind, 0.0) + e.self_device_time_total / 3e3
    gemm = split.get("bf16 products", 0.0) + split.get("f32 products", 0.0)
    log("profile verify paged: card time per verify by kernel kind "
        "(torch.profiler over 3 replays): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(split.items(),
                                                 key=lambda kv: -kv[1]))
        + f" [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile verify paged kernel: {e.key[:90]} ms_per_verify="
            f"{e.self_device_time_total / 3e3:.4f} calls_per_verify="
            f"{e.count / 3:.0f}")
    log(f"profile verify paged B=8 d=4 contexts {min(ctx)}-{max(ctx)}, "
        f"table width {table.shape[1]}: one verify dispatched and synced as "
        f"the loop does (upload, one graph replay, sync), from the same "
        f"state 10 times: wall_ms={vwall:.4f} card_ms (events)={vcard:.4f} "
        f"idle_share={1 - vcard / vwall:.4f}; matrix-product kernels "
        f"{gemm:.4f} ms (torch.profiler); a {block}-step decode block the "
        f"same way: wall_ms_per_step={dwall / block:.4f} card_ms_per_step="
        f"{dcard / block:.4f}; a verify's card time is "
        f"{vcard / (dcard / block):.3f} decode steps' and emits up to 5 "
        f"tokens a row [{card}]")
    # the parts, by events at the verify's shape (the engine's table)
    tt = torch.from_numpy(table).to(dev).long()
    B, W, L = 8, 5, cfg.n_layers
    H, dh = cfg.n_heads, cfg.head_dim
    pos = eng._positions[:, None] + torch.arange(W, device=dev)
    q = torch.randn(B, W, H, dh, device=dev, dtype=torch.bfloat16)
    rows = _gather_rows(eng.k_cache[0], tt)
    with torch.no_grad():
        gather = time_events(lambda: [_gather_rows(eng.k_cache[l], tt)
                                      for l in range(L) for _ in (0, 1)], 5)
        read = time_events(lambda: [_masked_read(q, rows, rows, pos, c)
                                    for _ in range(L)], 5)
        x = torch.randn(B, W, cfg.dim, device=dev, dtype=torch.bfloat16)
        one = time_events(lambda: _verify_head(x, params), 20)
        per = time_events(lambda: [_head(x[:, i], params).argmax(-1)
                                   for i in range(W)], 20)
    log(f"profile verify paged: parts by CUDA events at its shape, eager, "
        f"per verify: page gather (K and V, {L} layers, table "
        f"{tuple(table.shape)}) {gather:.4f} ms; plain einsum read (f32, "
        f"{L} layers) {read:.4f} ms; lm_head of the [{B}, {W}] window as one "
        f"product {one:.4f} ms, one product per position {per:.4f} ms "
        f"(kept: one product); the rest of the replayed verify (layer "
        f"products, norms, rope, sampling) {vcard - gather - read - one:.4f} "
        f"ms [{card}]")
    del eng


def dense_spec_reduced(params, cfg, dev, card: str, n_layers: int = 4
                       ) -> None:
    """The dense spec engine once, at reduced depth (the first n_layers of
    the same weights): 4 greedy prompts (2 repeated passages) of 32 tokens
    through engine.generate, each against the oracle at that depth."""
    import dataclasses

    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.tpu.engine import LLMEngine

    c = dataclasses.replace(cfg, n_layers=n_layers, attn_impl="flash",
                            decode_attn="kernel")
    p = cut_tree(params, n_layers)
    eng = LLMEngine(p, c, device=dev, n_slots=4, max_seq_len=512,
                    prefill_buckets=(256,), speculative_tokens=4)
    eng.warmup()
    eng.start()
    tok = DebugTokenizer(cfg.vocab_size)
    try:
        prompts = [tok.encode((rag_prompt if i % 2 == 0 else make_prompt)(
            200, 700 + i)) for i in range(4)]
        reqs = [eng.submit(q, max_new_tokens=32) for q in prompts]
        got = [r.result(timeout_s=600) for r in reqs]
    finally:
        eng.stop()
    gaps = [oracle_gap(p, c, dev, q, g)[0] for q, g in zip(prompts, got)]
    log(f"serve dense spec (reduced depth: {n_layers} of {cfg.n_layers} "
        f"layers): 4 greedy requests x 32 tokens, {eng.verify_dispatches} "
        f"verifies, accepted {eng.spec_accepted} of {eng.spec_drafted} "
        f"drafted; largest gap to the oracle's top logit {max(gaps):.3e} "
        f"(tol {MODEL_TOL}) [{card}]")
    require(all(len(g) == 32 for g in got) and max(gaps) <= MODEL_TOL,
            "dense spec at reduced depth failed")


CHUNK_ENV = {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
             "HTTP_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "2048",
             "PAGE_SIZE": "128",
             "PREFILL_BUCKETS": "16,32,64,128,256,512,1024",
             "REQUEST_TIMEOUT": "600", "WARMUP": "true",
             "CHUNK_PREFILL_TOKENS": "256"}
LONG_CHARS = 899                # + BOS: a 900-token prompt, bucket 1024


def live_stream(port, prompt, max_tokens, rec) -> None:
    """stream_request whose token times land in rec["times"] as they
    arrive (seconds on the monotonic clock)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate", body=json.dumps(
        {"prompt": prompt, "max_tokens": max_tokens, "stream": True}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    rec["status"] = resp.status
    text = []
    while True:
        line = resp.readline()
        if not line:
            break
        if not line.startswith(b"data: "):
            continue
        event = json.loads(line[6:])
        if event.get("done"):
            rec["done"] = event
            resp.read()
            break
        rec["times"].append(time.monotonic())
        text.append(event["text"])
    conn.close()
    rec["text"] = "".join(text)


def long_admission(port) -> dict:
    """6 streams of 96 tokens decoding (sent one after another), then the
    900-token prompt (16 tokens) sent once each stream has 4 tokens; returns the long request's
    TTFT and the active streams' largest gap between tokens while it was
    admitted (token arrivals after it was sent, up to its first token)."""
    recs = [{"times": []} for _ in range(7)]
    prompts = [make_prompt(n, 800 + i) for i, n in enumerate(SPEC_CHARS[:6])]
    threads = [threading.Thread(target=live_stream,
                                args=(port, p, 96, recs[i]))
               for i, p in enumerate(prompts)]
    deadline = time.monotonic() + 300
    for t, r in zip(threads, recs):
        # one at a time, each after the previous one's first token: K=1
        # waves, which WARMUP=true captured
        t.start()
        while not r["times"] and time.monotonic() < deadline:
            time.sleep(0.002)
    while (any(len(r["times"]) < 4 for r in recs[:6])
           and time.monotonic() < deadline):
        time.sleep(0.002)
    sent = time.monotonic()
    long_prompt = make_prompt(LONG_CHARS, 899)
    threads.append(threading.Thread(target=live_stream, args=(
        port, long_prompt, 16, recs[6])))
    threads[-1].start()
    for t in threads:
        t.join(timeout=600)
    require(all(not t.is_alive() for t in threads), "chunk: requests hung")
    first = recs[6]["times"][0]
    gap = 0.0
    for r in recs[:6]:
        ts = r["times"]
        for a, b in zip(ts, ts[1:]):
            if b > sent and a < first:
                gap = max(gap, b - max(a, sent))
    return {"ttft_ms": (first - sent) * 1e3, "gap_ms": gap * 1e3,
            "recs": recs, "long_prompt": long_prompt}


def chunk_phase(params, cfg, dev, card: str) -> None:
    """The main path (paged, prefix cache on) with CHUNK_PREFILL_TOKENS=256,
    MAX_SEQ_LEN=2048, buckets 16..1024 and WARMUP=true: 6 streams decode
    when a 900-token prompt (bucket 1024: 4 chunks) arrives; logged its
    TTFT and the streams' largest gap between tokens during its admission,
    then the same with chunking off (the loop restarted, the fused [1,
    1024] and [1, 512] waves captured before it, the prefix cache emptied).
    Gates: the long stream against the oracle, no capture after boot,
    every dispatch a graph replay, the chunk graphs (a middle and the final
    chunk) equal eager. Then the int8-KV paged engine's chunks (the
    q8-final program) once: its final chunk's graph against eager and the
    long prompt served."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    engine = build_engine(CHUNK_ENV, device=dev, params=params)
    boot = boot_line(engine, "paged chunk", card)
    L = cfg.n_layers
    res = {}
    chunk_size = engine.chunk_prefill_tokens
    long_bucket = engine.prefill_buckets[-1]
    for label, chunk in (("chunked", chunk_size), ("chunking off", 0)):
        if not chunk:
            engine.chunk_prefill_tokens = 0
            with torch.no_grad(), engine._stream_ctx():
                for bucket in engine.prefill_buckets:
                    if bucket > chunk_size:
                        engine._prefill_program(bucket, 1)
            boot = engine.executor.captures
        drop_prefix(engine)
        engine.start()
        app = build_app(CHUNK_ENV, engine=engine)
        app.start()
        try:
            warm: dict = {}
            stream_request(app.http_port, make_prompt(40, 99), 4, warm, "w")
            zero_counts(engine)
            rec = record_tokens(engine)
            r = long_admission(app.http_port)
            del engine._emit_block
            launches = launch_counts.counts()
            dispatch = dispatch_counts(engine, boot)
            counts = {k: getattr(engine, k) for k in SPEC_CHUNK_COUNTS}
            steps, prefills = engine.decode_steps, engine.prefill_dispatches
        finally:
            app.shutdown()
        what = f"serve paged {label}"
        res[label] = r
        check_dispatch(f"paged {label}", dispatch, card)
        long_rec = r["recs"][6]
        require(long_rec["status"] == 200
                and long_rec["done"]["tokens"] == 16,
                f"{what}: the long request failed")
        log(f"{what}: a {LONG_CHARS + 1}-token prompt sent while 6 streams "
            f"decode: its ttft_ms={r['ttft_ms']:.1f}; the streams' largest "
            f"gap between tokens during its admission {r['gap_ms']:.1f} ms; "
            f"{counts['chunk_jobs']} chunk jobs, {counts['chunk_dispatches']} "
            f"chunks, {counts['chunk_swaps']} swaps of carried state "
            f"({counts['chunk_swap_bytes']} bytes); launches on the card: "
            f"flash {launches['flash_attention']} ({prefills} full waves), "
            f"paged_attention {launches['paged_attention']} ({steps} decode "
            f"steps) [{card}]")
        require(launches["flash_attention"] == L * prefills
                and launches["paged_attention"] == L * steps,
                f"{what}: launches are not n_layers per wave / step")
        require(not chunk or counts["chunk_dispatches"]
                == long_bucket // chunk_size,
                f"{what}: the long prompt did not run in chunks")
        prompt, ids = max(rec.values(), key=lambda v: len(v[0]))
        gap, exact = oracle_gap(params, cfg, dev, list(prompt), ids)
        log(f"{what}: the long stream ({len(prompt)} prompt tokens) against "
            f"the teacher-forced oracle: exact argmax at {exact:.3f} of "
            f"positions, largest gap {gap:.3e} (tol {MODEL_TOL}) [{card}]")
        require(len(ids) == 16 and gap <= MODEL_TOL,
                f"{what}: the long stream leaves the oracle's")
    log(f"serve paged chunk vs off: long-prompt ttft_ms "
        f"{res['chunked']['ttft_ms']:.1f} / "
        f"{res['chunking off']['ttft_ms']:.1f}; the streams' largest gap "
        f"during its admission {res['chunked']['gap_ms']:.1f} / "
        f"{res['chunking off']['gap_ms']:.1f} ms [{card}]")
    engine.chunk_prefill_tokens = chunk_size
    for final in (False, True):
        check_chunk_graph(engine, "paged", final, card)
    del engine
    torch.cuda.empty_cache()
    q8 = PagedLLMEngine(params, dataclasses.replace(
        cfg, attn_impl="flash", kv_dtype="int8"),
        page_size=int(CHUNK_ENV["PAGE_SIZE"]), device=dev, n_slots=8,
        max_seq_len=int(CHUNK_ENV["MAX_SEQ_LEN"]),
        prefill_buckets=(chunk_size, long_bucket),
        chunk_prefill_tokens=chunk_size)
    check_chunk_graph(q8, "paged-int8", True, card)
    prompt = DebugTokenizer(cfg.vocab_size).encode(
        make_prompt(LONG_CHARS, 899))
    q8.start()
    try:
        got = q8.generate(prompt, max_new_tokens=8)
    finally:
        q8.stop()
    gap, exact = oracle_gap(params, cfg, dev, prompt, got)
    names = [n for n, c in q8.executor.cache_info().items() if c]
    log(f"serve paged-int8 chunk: the {len(prompt)}-token prompt in "
        f"{q8.chunk_dispatches} chunks ({', '.join(sorted(names))}), 8 "
        f"tokens; against the bf16 oracle (logged): exact argmax at "
        f"{exact:.3f}, largest gap {gap:.3e} [{card}]")
    require(len(got) == 8
            and q8.chunk_dispatches == long_bucket // chunk_size
            and any("-chunk-q8-final-" in n for n in names),
            "paged-int8 chunk: the q8-final program did not serve")


def check_chunk_graph(eng, config: str, final: bool, card: str) -> None:
    import torch

    from gofr_tpu_torch.tpu.graphcheck import chunk_graph_vs_eager

    bucket = eng.prefill_buckets[-1]
    g = chunk_graph_vs_eager(eng, 1, bucket, final)
    same = bool(torch.equal(g["graph"].cpu(), g["eager"].cpu()))
    ok = same and g["state_diff"] == 0.0
    kind = "final" if final else "middle"
    log(f"check chunk graph {config}: the {kind} chunk of a [1, {bucket}] "
        f"admission (chunk {eng.chunk_prefill_tokens}) replayed vs run eagerly from the same "
        f"state: {'first tokens' if final else 'carried logits'} "
        f"{'equal' if same else 'DIFFER'}; state and carried temps "
        f"max_abs_diff={g['state_diff']:.3e} (largest |K/V| "
        f"{g['state_max']:.3e}; the garbage page 0, left out: "
        f"{g['garbage_diff']:.3e}) {'ok' if ok else 'FAIL'} [{card}]")
    require(ok, f"{config}: the {kind} chunk's graph differs from eager")


# -- crash-only serving (phases 4c and 11) ------------------------------------
DRILL_CHARS = (100, 120, 140, 160, 180, 110, 130)
DRILL_SEED = 2000        # prompt seeds no other phase uses
DRILL_TOKENS = 48
DRILL_LIMIT_S = 45.0
# a stream that leaves the unfaulted run's tokens after its replay must do
# so at a tie of the bf16 logits: the unfaulted run's top-2 logit margin at
# the first differing position, from the scoring pass, under this
TIE_MARGIN = 1e-2


def drill_streams(engine, ids, n_tok, fault=False) -> tuple:
    """The drill's greedy streams, admitted in one round (gate_admission,
    so both runs have the same waves); returns (requests, token lists).
    fault: at the sync after which every stream has delivered half its
    tokens (and none has finished), arm engine.decode to raise at its next
    dispatch, on the loop thread, so the reset lands mid-stream whatever
    the waves' schedule."""
    reqs: list = []
    sync = engine._sync_oldest
    if fault:
        def armed_sync():
            sync()
            if (reqs and not engine.faults.snapshot()["rules"]
                    and min(len(r.emitted) for r in reqs) >= n_tok // 2
                    and all(r.finished_at is None for r in reqs)):
                engine.faults.arm([{"site": "engine.decode", "nth": 1}])
        engine._sync_oldest = armed_sync
    try:
        gate_admission(engine, len(ids))
        reqs.extend(engine.submit(x, max_new_tokens=n_tok) for x in ids)
        out = [r.result(timeout_s=300) for r in reqs]
        wait_idle(engine)
    finally:
        engine._sync_oldest = sync
    return reqs, out


def drill_phase(engine, card: str, boot: int) -> None:
    """Phase 4c on the main path's served engine: the drill's 7 greedy
    streams run unfaulted, then again with engine.decode armed to raise
    once mid-stream, at the first decode dispatch after every stream has
    delivered half its tokens (the prefix cache emptied before each run,
    so both admit full waves). The faulted run must reset once and replay,
    every stream reach its count, and no graph be captured. Its counts,
    zeroed just before it and read at the reset and after the run, must be
    exact on both sides of the reset: flash n_layers per full admission
    wave and no tail-only wave, the paged read n_layers per decode step;
    after the reset at least one full wave (the replay's re-prefill) and
    one decode step (its resumed blocks). A stream whose tokens leave the
    unfaulted run's must do so at a bf16 tie (TIE_MARGIN). Then
    check_reseed."""
    from gofr_tpu_torch.tpu.faults import FaultPlane

    t0 = time.monotonic()
    tok = engine.tokenizer
    ids = [tok.encode(make_prompt(n, DRILL_SEED + i))
           for i, n in enumerate(DRILL_CHARS)]
    with engine._state_lock:
        drop_prefix(engine)
    _, ref = drill_streams(engine, ids, DRILL_TOKENS)
    with engine._state_lock:
        drop_prefix(engine)
    counts0 = (engine.resets_total, engine.replays_total,
               engine.replayed_tokens_total)
    captures0 = engine.executor.captures
    # the counts at the reset (the loop thread, after the restore: the
    # dispatches in flight at the fault have run and are counted)
    at_reset: list = []
    reset = engine._reset_device_state

    def counted_reset(exc):
        reset(exc)
        at_reset.append(drill_counts(engine))

    zero_counts(engine)
    engine.faults = FaultPlane()     # attached disarmed, armed mid-stream
    engine._reset_device_state = counted_reset
    t1 = time.monotonic()
    try:
        reqs, got = drill_streams(engine, ids, DRILL_TOKENS, fault=True)
    finally:
        engine.faults = None
        del engine._reset_device_state
    wall = time.monotonic() - t1
    total = drill_counts(engine)
    resets = engine.resets_total - counts0[0]
    replays = engine.replays_total - counts0[1]
    replayed = engine.replayed_tokens_total - counts0[2]
    captured = engine.executor.captures - captures0
    L = engine.cfg.n_layers
    require(len(at_reset) == 1, f"drill: {len(at_reset)} resets counted")
    before = at_reset[0]
    after = {k: total[k] - before[k] for k in total}
    log(f"drill: engine.decode raised mid-stream: resets "
        f"{resets}, replays {replays}, replayed tokens {replayed}, graphs "
        f"captured {captured} (after boot {engine.executor.captures - boot})"
        f"; the faulted run up to the reset {before}, after it {after} "
        f"(n_layers={L}); 7 streams x {DRILL_TOKENS} tokens in {wall:.2f}s "
        f"[{card}]")
    require(resets == 1 and replays >= 1 and replayed > 0,
            "drill: the mid-stream fault was not reset and replayed")
    require(captured == 0 and engine.executor.captures == boot,
            "drill: a graph was captured by the reset or the replay")
    for what, c in (("up to the reset", before), ("after the reset", after)):
        require(c["flash_attention"] == L * c["waves"]
                and c["paged_attention"] == L * c["steps"]
                and c["tail_waves"] == 0,
                f"drill: {what}, launches {c} are not n_layers per full "
                f"admission wave and per decode step")
    require(after["waves"] > 0 and after["steps"] > 0,
            "drill: the replay did not re-prefill through flash and resume "
            "through the paged read")
    for i, toks in enumerate(got):
        require(len(toks) == DRILL_TOKENS,
                f"drill: stream {i} delivered {len(toks)} tokens of "
                f"{DRILL_TOKENS}")
    at = {}
    if engine.recorder is not None:
        for i, r in enumerate(reqs):
            rec = engine.recorder.lookup(r.id) or {}
            for e in rec.get("events", []):
                if e["event"] == "replayed":
                    at[i] = e.get("replayed_tokens")
    matched = sum(g == w for g, w in zip(got, ref))
    log(f"drill: {matched} of {len(ref)} streams equal the unfaulted run "
        f"token for token; replayed at delivered tokens {at}")
    for i, (g, w) in enumerate(zip(got, ref)):
        if g == w:
            continue
        p = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        _, top_ids, top_lps = engine.score(ids[i], w[:p + 1], top=2)
        margin = float(top_lps[p][0] - top_lps[p][1])
        log(f"drill: stream {i} first differs at token {p} (replayed at "
            f"{at.get(i)}): unfaulted top-2 {top_ids[p].tolist()} margin "
            f"{margin:.6f} (a tie below {TIE_MARGIN})")
        require(margin < TIE_MARGIN,
                f"drill: stream {i} differs at token {p} beyond a bf16 "
                f"tie (margin {margin:.6f})")
    check_reseed(engine, card)
    took = time.monotonic() - t0
    log(f"drill: phase 4c {took:.1f}s")
    require(took < DRILL_LIMIT_S, f"drill: {took:.1f}s over "
            f"{DRILL_LIMIT_S}s")


def drill_counts(engine) -> dict:
    """The drill's launch counts (synced) and the dispatches they answer
    to: full admission waves, tail-only waves, decode steps."""
    from gofr_tpu_torch.ops import launch_counts

    launches = launch_counts.counts()
    return {"flash_attention": launches["flash_attention"],
            "paged_attention": launches["paged_attention"],
            "waves": engine.prefill_dispatches,
            "tail_waves": engine.prefix_dispatches,
            "steps": engine.decode_steps}


def check_reseed(engine, card: str) -> None:
    """The in-place restore re-seeds the generator the decode graphs
    registered: with the engine idle (its admission held by the state
    lock), one decode block graph replayed at temperature 1 from the same
    state after manual_seed(s) twice must draw the same tokens, and after
    manual_seed(s + 1) other ones. Each row reads and writes two free pages
    of its own (a row's draws must not read another's writes); the pages,
    the loop state and the generator are restored after."""
    import numpy as np
    import torch

    with engine._state_lock, torch.no_grad(), engine._stream_ctx():
        require(not engine._inflight and not any(s.active
                                                 for s in engine.slots),
                "reseed: the engine is not idle")
        program = engine._decode_program_paged(2, engine.decode_block_size,
                                               engine._row_filter_now())
        pages = engine.allocator.alloc(2 * engine.n_slots)
        require(pages is not None, "reseed: no free pages")
        table = np.asarray(pages, dtype=np.int32).reshape(engine.n_slots, 2)
        saved = [t.clone() for t in (engine._tokens, engine._positions,
                                     engine._temps)]
        rng = engine.generator.get_state()
        draws = []
        try:
            for seed in (1234, 1234, 1235):
                engine._tokens.fill_(7)
                engine._positions.fill_(3)
                engine._temps.fill_(1.0)
                engine.generator.manual_seed(seed)
                draws.append(engine._call(program, (table,)).cpu())
        finally:
            for t, v in zip((engine._tokens, engine._positions,
                             engine._temps), saved):
                t.copy_(v)
            engine.generator.set_state(rng)
            torch.cuda.synchronize()
            engine.allocator.release(pages)
    same = torch.equal(draws[0], draws[1])
    other = not torch.equal(draws[0], draws[2])
    log(f"reseed: a decode graph's draws after manual_seed of its "
        f"registered generator: same seed equal {same}, next seed "
        f"different {other} [{card}]")
    require(same and other, "reseed: the graph did not draw from the "
            "re-seeded generator")


# -- the QoS plane (phases 4d and 12) -------------------------------------------
QOS_CHARS = (130, 150, 170, 190, 140, 160, 180)  # + BOS: past one 128-token page
QOS_INTER_CHARS = 120
QOS_SEED = 5000          # prompt seeds no other phase uses
QOS_TOKENS = 64
QOS_LIMIT_S = 25.0
# a resume recomputes the delivered tokens' K/V by the tail prefill (paged)
# or a full wave (dense), where the undisturbed run wrote them one decode
# step at a time: another attention path, whose logits check_model holds
# within MODEL_TOL of a plain recompute (0.094 on an NVIDIA H100 80GB HBM3
# at 700 W: three bf16 steps at the logits' magnitude, 4-8). A preempted
# stream may leave the undisturbed one only where the latter's top two
# logits, from the scoring pass, are at most this many bf16 steps apart
QOS_TIE_STEPS = 4


def bf16_step(x: float) -> float:
    """The gap between adjacent bfloat16 values at |x| (8 bits of
    precision)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def qos_prompts(tok, seed: int) -> tuple:
    """The 7 batch prompts (each one full page and a tail: a paged resume
    is a tail-only prefix hit) and the interactive one."""
    ids = [tok.encode(make_prompt(n, seed + i))
           for i, n in enumerate(QOS_CHARS)]
    return ids, tok.encode(make_prompt(QOS_INTER_CHARS, seed + 50))


def pin_ladder(ctl) -> None:
    """Let the ladder move only by force_level: a burn probe that reads
    calm, and holds no phase reaches (no unclassified request of another
    phase is ever shed)."""
    ctl._burn_probe = lambda: {}
    ctl.escalate_hold_s = ctl.recover_hold_s = 3600.0


def qos_streams(engine, ctl, ids, inter_ids, n_tok, inter_at: int,
                pin_at=None, release: str = "preempted") -> dict:
    """7 greedy batch streams of tenant acme (admitted in one round,
    gate_admission) and one interactive stream, submitted on the loop
    thread at the sync after which every batch stream has delivered
    `inter_at` tokens; it takes the slot the reservation keeps. pin_at:
    at the sync after which every batch stream has delivered that many,
    the ladder is pinned at preempt_batch (before the interactive submit
    when both fall on one sync), and back at 0 at the sync after the
    preemption (release="preempted") or after the interactive's first
    token ("first_token"). Records each stream's token arrival times, the
    rows each loop step at preempt_batch preempted, the loop steps of the
    run, the graphs it captured, and the card time of each re-admission
    wave (CUDA events on the engine's stream around its dispatch, upload
    included)."""
    import torch

    reqs: list = []
    state: dict = {"inter": None, "pinned": None, "released": None}
    acts: list = []
    waves: list = []
    p0, c0 = engine.preemptions_total, engine.executor.captures
    sync, actuate, prefill = (engine._sync_oldest, engine._qos_actuate,
                              engine._prefill)

    def armed_sync():
        sync()
        if len(reqs) < len(ids):
            return
        low = min(len(r.emitted) for r in reqs)
        if (pin_at is not None and state["pinned"] is None
                and low >= pin_at):
            ctl.force_level(2)
            state["pinned"] = engine.steps.steps_total
        if state["inter"] is None and low >= inter_at:
            state["inter"] = engine.submit(
                inter_ids, max_new_tokens=n_tok, qos_class="interactive",
                tenant="acme")
        if state["pinned"] is not None and state["released"] is None:
            inter = state["inter"]
            if (engine.preemptions_total - p0 >= len(reqs)
                    if release == "preempted"
                    else inter is not None
                    and inter.first_token_at is not None):
                ctl.force_level(0)
                state["released"] = engine.steps.steps_total

    def counted_actuate():
        before = engine.preemptions_total
        actuate()
        if ctl.level >= 2:
            acts.append(engine.preemptions_total - before)

    def timed_prefill(bucket, slots_idx, batch):
        if not any(r.preemptions for r in batch):
            return prefill(bucket, slots_idx, batch)
        tail = engine._tail_only(batch)
        if engine._stream is None:   # a dry run on the CPU: no card time
            prefill(bucket, slots_idx, batch)
            waves.append((len(batch), bucket, tail, None, None))
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(engine._stream)
        prefill(bucket, slots_idx, batch)
        end.record(engine._stream)
        waves.append((len(batch), bucket, tail, start, end))

    times: dict = {}
    tokens: dict = {}

    def consume(key, req):
        t, toks = [], []
        for token in req.stream(timeout_s=300):
            t.append(time.monotonic())
            toks.append(token)
        times[key], tokens[key] = t, toks

    engine._sync_oldest = armed_sync
    engine._qos_actuate = counted_actuate
    engine._prefill = timed_prefill
    seq0 = engine.steps.steps_total
    threads = []
    try:
        gate_admission(engine, len(ids))
        for i, x in enumerate(ids):
            reqs.append(engine.submit(x, max_new_tokens=n_tok,
                                      qos_class="batch", tenant="acme"))
            threads.append(threading.Thread(target=consume,
                                            args=(i, reqs[-1])))
            threads[-1].start()
        for th in threads:
            th.join(timeout=600)
        require(len(tokens) == len(ids), "qos: a batch stream hung")
        out = [tokens[i] for i in range(len(ids))]
        require(state["inter"] is not None,
                "qos: the interactive request was never submitted")
        inter_out = state["inter"].result(timeout_s=300)
        wait_idle(engine)
    finally:
        for name in ("_sync_oldest", "_qos_actuate", "_prefill"):
            engine.__dict__.pop(name, None)
    if engine._stream is not None:
        torch.cuda.synchronize()
    return {"reqs": reqs, "out": out, "inter": state["inter"],
            "inter_out": inter_out, "times": times, "acts": acts,
            "state": state, "steps": (seq0, engine.steps.steps_total),
            "captured": engine.executor.captures - c0,
            "waves": [(k, b, tail, s.elapsed_time(e) if s else math.nan)
                      for k, b, tail, s, e in waves]}


def check_ties(engine, what: str, ids, got, ref) -> int:
    """Each stream of `got` equal to its `ref` token for token, or leaving it
    where the ref's top-2 logit margin at the first differing token, from
    the scoring pass, is at most QOS_TIE_STEPS bf16 steps at the top
    logit's magnitude (read from the teacher-forced oracle); returns how
    many were equal."""
    matched = 0
    for i, (g, w) in enumerate(zip(got, ref)):
        if g == w:
            matched += 1
            continue
        p = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        _, top_ids, top_lps = engine.score(ids[i], w[:p + 1], top=2)
        margin = float(top_lps[p][0] - top_lps[p][1])
        top = float(oracle_logits(engine.params, engine.cfg, engine.device,
                                  list(ids[i]) + w[:p])[-1].float().max())
        bound = QOS_TIE_STEPS * bf16_step(top)
        log(f"{what}: stream {i} first differs at token {p}: the "
            f"undisturbed run's top-2 {top_ids[p].tolist()} margin "
            f"{margin:.6f} = {margin / bf16_step(top):.1f} bf16 steps at "
            f"its top logit {top:.3f} (at most {QOS_TIE_STEPS}: {bound})")
        require(margin <= bound, f"{what}: stream {i} differs at token {p} "
                f"beyond {QOS_TIE_STEPS} bf16 steps (margin {margin:.6f})")
    return matched


def check_preempted(what: str, run: dict, n_tok: int) -> None:
    """Every batch row preempted once, at the first loop step at
    preempt_batch, and re-admitted: each stream delivered n_tok tokens,
    its replay ledger equal to them (nothing repeated or dropped), no
    replay taken; no graph captured by the run."""
    n = len(run["reqs"])
    require(run["captured"] == 0, f"{what}: the run captured "
            f"{run['captured']} graphs (a preemption or a resume)")
    require(run["acts"][:1] == [n] and sum(run["acts"]) == n,
            f"{what}: the loop steps at preempt_batch preempted "
            f"{run['acts']}, not all {n} rows at the first")
    for i, (r, toks) in enumerate(zip(run["reqs"], run["out"])):
        require(r.preemptions == 1 and r.replays == 0
                and r.admitted_at is not None,
                f"{what}: stream {i} preemptions {r.preemptions}, replays "
                f"{r.replays}")
        require(len(toks) == n_tok and r.emitted == toks,
                f"{what}: stream {i} delivered {len(toks)} tokens of "
                f"{n_tok}, or a token twice")


def qos_phase(app, engine, card: str, boot: int) -> None:
    """Phase 4d on the main path's served engine, after 4c: the QoS plane
    enabled on its App, the ladder moved only by force_level (pin_ladder).
    qos_streams' traffic (7 batch streams x 64 tokens, tenant acme, and an
    interactive one in the reserved slot) run with the ladder at 0, then
    again pinned at preempt_batch at mid-stream and back at 0 at the sync
    after the preemption (the prefix cache emptied before each run, so
    both admit full waves): every batch row preempted at the first loop
    step, queued again and re-admitted (a tail-only wave on its prompt's
    cached page), each stream equal to the unpreempted run or leaving it
    at a bf16 tie, nothing repeated or dropped; no graph captured; flash
    n_layers per full wave and the paged read n_layers per decode step
    over the run. Then at shed_standard a standard /generate gets 503 with
    Retry-After and an interactive one 200; at park_batch a batch submit
    waits until the ladder is back at 0; /debug/qos and the app_tpu_qos_*
    series equal the counts; /debug/capacity bills acme."""
    t0 = time.monotonic()
    tok = engine.tokenizer
    ids, inter_ids = qos_prompts(tok, QOS_SEED)
    ctl = app.enable_qos(engine)
    pin_ladder(ctl)
    L = engine.cfg.n_layers
    with engine._state_lock:
        drop_prefix(engine)
    ref = qos_streams(engine, ctl, ids, inter_ids, QOS_TOKENS,
                      inter_at=QOS_TOKENS // 4)
    with engine._state_lock:
        drop_prefix(engine)
    zero_counts(engine)
    t1 = time.monotonic()
    run = qos_streams(engine, ctl, ids, inter_ids, QOS_TOKENS,
                      inter_at=QOS_TOKENS // 4, pin_at=QOS_TOKENS // 2)
    wall = time.monotonic() - t1
    c = drill_counts(engine)
    log(f"qos: 7 batch streams x {QOS_TOKENS} (tenant acme) and 1 "
        f"interactive, preempt_batch pinned at {QOS_TOKENS // 2} delivered "
        f"tokens: rows preempted per loop step at preempt_batch "
        f"{run['acts']}, preemptions_total {engine.preemptions_total}; the "
        f"run's counts {c} (n_layers={L}); re-admission waves [K, bucket, "
        f"tail-only] {[w[:3] for w in run['waves']]}; graphs captured by "
        f"the run {run['captured']} (after boot "
        f"{engine.executor.captures - boot}, scoring passes included); in "
        f"{wall:.2f}s [{card}]")
    check_preempted("qos", run, QOS_TOKENS)
    require(c["flash_attention"] == L * c["waves"]
            and c["paged_attention"] == L * c["steps"] and c["waves"] > 0,
            f"qos: launches {c} are not n_layers per full wave and per "
            f"decode step")
    require(c["tail_waves"] > 0 and all(w[2] for w in run["waves"]),
            "qos: a resume was not a tail-only prefix hit")
    matched = check_ties(engine, "qos", ids, run["out"], ref["out"])
    same_inter = check_ties(engine, "qos interactive", [inter_ids],
                            [run["inter_out"]], [ref["inter_out"]])
    log(f"qos: {matched} of {len(ids)} batch streams equal the unpreempted "
        f"run token for token (the interactive one: {bool(same_inter)})")
    # the door at shed_standard, over HTTP
    ctl.force_level(4)
    status, headers, body = post_json(
        app.http_port, "/generate",
        {"prompt": "shed me", "max_tokens": 4, "stream": False},
        {"X-QoS-Class": "standard", "X-Tenant": "acme"})
    inter: dict = {}
    stream_request(app.http_port, make_prompt(60, QOS_SEED + 60), 4, inter,
                   "i", {"class": "interactive", "tenant": "acme"})
    ctl.force_level(0)
    retry = headers.get("Retry-After")
    log(f"qos: at shed_standard a standard /generate answered {status} "
        f"Retry-After {retry}, an interactive one {inter['i']['status']} "
        f"with {inter['i']['done'] and inter['i']['done']['tokens']} tokens")
    require(status == 503 and retry is not None,
            "qos: shed_standard did not shed a standard request with 503")
    require(inter["i"]["status"] == 200 and inter["i"]["done"]["tokens"] == 4,
            "qos: shed_standard refused an interactive request")
    # park_batch: a batch submit waits until the ladder is back at 0
    ctl.force_level(1)
    parked = engine.submit(ids[0], max_new_tokens=8, qos_class="batch",
                           tenant="acme")
    time.sleep(0.3)
    waited = parked.admitted_at is None
    ctl.force_level(0)
    t_released = time.monotonic()
    got = parked.result(timeout_s=60)
    log(f"qos: at park_batch a batch submit waited 0.3 s unadmitted "
        f"{waited}; at 0 it admitted and delivered {len(got)} tokens "
        f"{time.monotonic() - t_released:.3f}s later")
    require(waited and len(got) == 8, "qos: park_batch did not park batch")
    wait_idle(engine)
    snap = get_json(app.http_port, "/debug/qos")
    n = len(ids)
    want = {"batch": {"submitted": 2 * n + 1, "admitted": n + 2 * n + 1,
                      "preempted": n, "finished": 2 * n + 1, "errors": 0},
            "interactive": {"submitted": 3, "admitted": 3, "finished": 3},
            "standard": {"shed": 1}}
    got_counts = {cls: {k: snap["classes"][cls][k] for k in fields}
                  for cls, fields in want.items()}
    series = series_of(app.container.metrics_manager.expose())
    metric = {cls: {k: series.get(f'app_tpu_qos_{k}_total{{class="{cls}"}}')
                    for k in fields if k in ("submitted", "admitted",
                                             "preempted", "shed")}
              for cls, fields in want.items()}
    log(f"qos: /debug/qos {got_counts}, preemptions_total "
        f"{snap['preemptions_total']}, tenants {snap['tenants']}; "
        f"app_tpu_qos_* {metric}, shed level "
        f"{series.get('app_tpu_qos_shed_level')}")
    require(got_counts == want and snap["preemptions_total"] == n
            and snap["tenants"].get("batch", {}).get("acme") == 2 * n + 1,
            f"qos: /debug/qos {got_counts} is not {want}")
    require(all(v == float(want[cls][k]) for cls, row in metric.items()
                for k, v in row.items()),
            f"qos: the app_tpu_qos_* series {metric} are not {want}")
    cap = get_json(app.http_port, "/debug/capacity")
    acme = [a for a in cap["accounts"] if a["tenant"] == "acme"]
    log(f"qos: /debug/capacity bills acme: "
        f"{[(a['class'], a['device_s'], a['requests']) for a in acme]}")
    require(any(a["class"] == "batch" and a["device_s"] > 0 for a in acme)
            and any(a["class"] == "interactive" for a in acme),
            "qos: /debug/capacity does not bill acme")
    took = time.monotonic() - t0
    log(f"qos: phase 4d {took:.1f}s")
    require(took < QOS_LIMIT_S, f"qos: {took:.1f}s over {QOS_LIMIT_S}s")


def qos_env(tmp: str) -> dict:
    """The main path's serve config with QOS=true, and an SLO burn engine
    the ladder climbs on at once: a TTFT target every request misses, 4
    events enough, 5 s windows, 0.3 s escalation and 0.5 s recovery holds,
    the ladder evaluated every 0.1 s; batch held to a tenth of the page
    pool, a standard request's queue deadline 0.5 s; incident bundles in
    `tmp`."""
    return {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
            "HTTP_PORT": "0", "METRICS_PORT": "0", "MAX_BATCH": "8",
            "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
            "PREFILL_BUCKETS": "16,32,64,128,256", "REQUEST_TIMEOUT": "600",
            "WARMUP": "wide", "QOS": "true", "QOS_SHED_TRACKS": "ttft",
            "QOS_ESCALATE_HOLD_S": "0.3", "QOS_RECOVER_HOLD_S": "0.5",
            "QOS_EVAL_S": "0.1", "QOS_BATCH_PAGE_FRACTION": "0.1",
            "QOS_DEADLINE_STANDARD_S": "0.5", "QOS_SHED_RETRY_AFTER_S": "2",
            "SLO_TTFT_TARGET_S": "0.001", "SLO_BURN_MIN_EVENTS": "4",
            "SLO_BURN_FAST_WINDOW_S": "5", "SLO_BURN_SLOW_WINDOW_S": "5",
            "INCIDENT_DIR": f"{tmp}/incidents",
            "PROFILE_DIR": f"{tmp}/profiles"}


def qos_mode_phase(params, cfg, dev, card: str) -> None:
    """Phase 12 (--qos): the main path's engine booted with qos_env: the
    ladder's climb and recovery on the real burn engine (ladder_climb),
    the figures of a preemption (preempt_figures), batch parked at its
    page share (page_share_parking), a standard request expiring at its
    deadline (deadline_expiry), the OpenAI server's classes and tenants
    (openai_classes, whose shutdown stops the engine); then the dense
    engine's preemption at CUT_DEPTH layers (dense_preemption)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from gofr_tpu_torch.serve import build_app, build_engine

    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="gofr-qos-")
    env = qos_env(tmp)
    engine = build_engine(env, device=dev, params=params)
    boot_line(engine, "paged qos", card)
    app = build_app(env, engine=engine)
    app.start()
    try:
        for step in (ladder_climb, preempt_figures, page_share_parking,
                     deadline_expiry):
            t0 = time.monotonic()
            step(app, engine, card)
            log(f"qos: {step.__name__} {time.monotonic() - t0:.1f}s")
        t0 = time.monotonic()
        openai_classes(env, engine, card)
        log(f"qos: openai_classes {time.monotonic() - t0:.1f}s")
    finally:
        app.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    del engine, app
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dense_preemption(cut_tree(params, CUT_DEPTH),
                     dataclasses.replace(cfg, n_layers=CUT_DEPTH), dev, card)
    log(f"qos: dense_preemption {time.monotonic() - t0:.1f}s")
    log(f"qos: phase 12 {time.monotonic() - t_all:.1f}s")


def ladder_climb(app, engine, card) -> None:
    """The ladder on the real SLO burn engine (adopted from
    enable_incident_autopsy): interactive requests miss the 1 ms TTFT
    target until the ttft track pages; the ladder steps ok -> park_batch at
    once, then one rung per 0.3 s hold up to shed_standard, where /stats
    asks for a replica and a standard /generate gets 503 with Retry-After
    while an interactive one is served; with the target re-set to 60 s the
    windows drain and the ladder walks back down to ok, one rung per 0.5
    s."""
    ctl = engine.qos
    require(ctl._burn is app.slo_burn and ctl.level == 0,
            "qos: the controller did not adopt the burn engine")
    tok = engine.tokenizer
    t0 = time.monotonic()
    sent = 0
    while ctl.level < 4 and time.monotonic() - t0 < 30.0:
        engine.submit(tok.encode(make_prompt(40, QOS_SEED + 200 + sent)),
                      max_new_tokens=4, qos_class="interactive",
                      tenant="climb").result(timeout_s=60)
        sent += 1
    climbed = time.monotonic() - t0
    require(ctl.level == 4, f"qos: the ladder reached {ctl.level}, not 4, "
            f"after {sent} requests")
    stats = get_json(app.http_port, "/stats")
    status, headers, _ = post_json(
        app.http_port, "/generate",
        {"prompt": "shed me", "max_tokens": 4, "stream": False},
        {"X-QoS-Class": "standard"})
    inter_status, _, _ = post_json(
        app.http_port, "/generate",
        {"prompt": "serve me", "max_tokens": 4, "stream": False},
        {"X-QoS-Class": "interactive"})
    app.slo_burn.slo_ttft_s = 60.0
    t1 = time.monotonic()
    wait_for(lambda: ctl.level == 0, "the ladder to recover", timeout_s=30.0)
    recovered = time.monotonic() - t1
    trail = get_json(app.http_port, "/debug/qos")["ladder"]["transitions"]
    start = trail[0]["t"]
    log(f"qos: ladder: {sent} interactive requests over a 1 ms TTFT target "
        f"climbed it to shed_standard in {climbed:.2f}s; /stats scaleout "
        f"{stats['fleet']['qos']}; a standard /generate {status} Retry-After "
        f"{headers.get('Retry-After')}, an interactive one {inter_status}; "
        f"target 60 s: back at ok {recovered:.2f}s later; trail "
        + ", ".join(f"{t['to']}@{t['t'] - start:.2f}s" for t in trail)
        + f" [{card}]")
    require([t["to"] for t in trail][-8:] ==
            ["park_batch", "preempt_batch", "request_replica",
             "shed_standard", "request_replica", "preempt_batch",
             "park_batch", "ok"], "qos: the ladder's trail does not end "
            "with the climb and the walk back")
    require(stats["fleet"]["qos"] == {"scaleout_wanted": True},
            "qos: /stats did not ask for a replica at shed_standard")
    require(status == 503 and headers.get("Retry-After") == "2"
            and inter_status == 201,
            "qos: shed_standard did not shed standard and serve interactive")
    pin_ladder(ctl)


def gap_ms(times) -> float:
    """The largest gap between a stream's token arrivals, ms."""
    return max((b - a) * 1e3 for a, b in zip(times, times[1:]))


def preempt_figures(app, engine, card) -> None:
    """qos_streams' traffic twice with batch's page share lifted: the
    interactive request submitted while the 7 batch rows decode, then with
    preempt_batch pinned at the same sync and back at 0 at its first token
    (the batch rows queued behind it meanwhile). Logged: its TTFT in each,
    the batch streams' largest gap between tokens in each, the
    re-admission waves' card time, the qos segment's share of the loop
    steps of the run; every row preempted once and re-admitted, each
    stream equal to the undisturbed run or leaving it at a bf16 tie."""
    ctl = engine.qos
    ids, inter_ids = qos_prompts(engine.tokenizer, QOS_SEED + 100)
    fraction, ctl.batch_page_fraction = ctl.batch_page_fraction, 1.0
    try:
        runs = []
        for pin in (None, QOS_TOKENS // 4):
            with engine._state_lock:
                drop_prefix(engine)
            runs.append(qos_streams(engine, ctl, ids, inter_ids, QOS_TOKENS,
                                    inter_at=QOS_TOKENS // 4, pin_at=pin,
                                    release="first_token"))
    finally:
        ctl.batch_page_fraction = fraction
    calm, hit = runs
    check_preempted("qos figures", hit, QOS_TOKENS)
    ttft = [(r["inter"].first_token_at - r["inter"].enqueued_at) * 1e3
            for r in runs]
    gaps = [sorted(gap_ms(r["times"][i]) for i in range(len(ids)))
            for r in runs]
    seq0, seq1 = hit["steps"]
    recs = [r for r in engine.steps.records(512) if seq0 < r.seq <= seq1]
    qos_s = sum(r.segments.get("qos", 0.0) for r in recs)
    wall = sum(r.wall_s for r in recs)
    preempting = max((r.segments.get("qos", 0.0) for r in recs), default=0)
    waves = hit["waves"]
    log(f"qos: figures: the interactive request's TTFT {ttft[0]:.2f} ms with "
        f"the 7 batch rows decoding, {ttft[1]:.2f} ms with them preempted at "
        f"its submit [{card}]")
    log(f"qos: figures: the batch streams' largest gap between tokens "
        f"p50 {gaps[0][3]:.1f} / max {gaps[0][-1]:.1f} ms undisturbed, p50 "
        f"{gaps[1][3]:.1f} / max {gaps[1][-1]:.1f} ms across the preemption "
        f"[{card}]")
    log(f"qos: figures: re-admission waves [K, bucket, tail-only, card ms] "
        f"{[(k, b, t, round(ms, 3)) for k, b, t, ms in waves]}, "
        f"{sum(w[3] for w in waves):.3f} ms of card in all (CUDA events on "
        f"the engine's stream, upload included) [{card}]")
    log(f"qos: figures: the qos segment {qos_s * 1e3:.3f} ms of "
        f"{wall * 1e3:.1f} ms over the run's {len(recs)} loop steps, share "
        f"{qos_s / wall:.6f}; the preempting step's {preempting * 1e3:.3f} "
        f"ms [{card}]")
    require(waves and all(w[2] for w in waves),
            "qos: a resume was not a tail-only prefix hit")
    matched = check_ties(engine, "qos figures", ids, hit["out"], calm["out"])
    log(f"qos: figures: {matched} of {len(ids)} batch streams equal the "
        f"undisturbed run token for token")


def page_share_parking(app, engine, card) -> None:
    """QOS_BATCH_PAGE_FRACTION=0.1 of the 64-page pool: 8 batch requests of
    2 pages each (a 161-token prompt and 64 new tokens), each submitted
    once the one before is bound to its slot or has waited 0.3 s (the
    first floor(0.1 * 64 / 2) = 3 should admit at once and the fourth
    park, logged); every admission decision on them saw the share batch
    would hold: each admit at or under the fraction, each park over it,
    at least one park; all complete. The share counts the pages of bound
    slots only, so one admission round that takes several parked requests
    may go past it, as the reference's does (logged: the most decoding at
    once)."""
    ctl = engine.qos
    tok = engine.tokenizer
    pool = engine.allocator.n_pages - 1
    ids = [tok.encode(make_prompt(160, QOS_SEED + 300 + i)) for i in range(8)]
    need = engine.allocator.pages_for(len(ids[0]) + QOS_TOKENS)
    cap = int(ctl.batch_page_fraction * pool // need)
    require(cap > 0, f"qos: a batch request of {need} pages can never fit "
            f"the share of a {pool}-page pool")
    peak = [0]
    sync = engine._sync_oldest

    def counted_sync():
        sync()
        peak[0] = max(peak[0], sum(1 for s in engine.slots
                                   if s.request is not None
                                   and s.request.qos_class == "batch"))

    shares = []
    share_of = ctl._batch_page_share

    def recorded(request, eng):
        shares.append(share_of(request, eng))
        return shares[-1]

    with engine._state_lock:
        drop_prefix(engine)
    engine._sync_oldest = counted_sync
    ctl._batch_page_share = recorded
    try:
        reqs, at_once = [], []
        for x in ids:
            reqs.append(engine.submit(x, max_new_tokens=QOS_TOKENS,
                                      qos_class="batch", tenant="parked"))
            deadline = time.monotonic() + 0.3
            while (reqs[-1].admitted_at is None
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            at_once.append(reqs[-1].admitted_at is not None)
        out = [r.result(timeout_s=300) for r in reqs]
    finally:
        del engine._sync_oldest, ctl._batch_page_share
    fraction = ctl.batch_page_fraction
    parks = [x for x in shares if x > fraction]
    log(f"qos: page share: QOS_BATCH_PAGE_FRACTION {ctl.batch_page_fraction}"
        f" of {pool} pages, 8 batch requests of {need} pages submitted one "
        f"by one: admitted at once {at_once} (the first {cap} expected, "
        f"then a park); {len(shares)} admission decisions, {len(parks)} "
        f"parks over the share, the largest share admitted "
        f"{max(x for x in shares if x <= fraction):.4f}; at most {peak[0]} "
        f"decoding at once; all {QOS_TOKENS} tokens "
        f"{all(len(o) == QOS_TOKENS for o in out)}")
    require(parks and all(len(o) == QOS_TOKENS for o in out),
            "qos: batch did not park at its page share")


def deadline_expiry(app, engine, card) -> None:
    """A standard /generate queued past QOS_DEADLINE_STANDARD_S (admission
    held 1 s) answers 503 with Retry-After; /debug/qos counts it."""
    out = {}

    def ask():
        out["r"] = post_json(app.http_port, "/generate",
                             {"prompt": "late", "max_tokens": 4,
                              "stream": False},
                             {"X-QoS-Class": "standard", "X-Tenant": "late"})

    engine._admit = lambda: None
    th = threading.Thread(target=ask)
    try:
        th.start()
        time.sleep(1.0)
    finally:
        del engine._admit
    th.join(timeout=60)
    status, headers, body = out["r"]
    expired = get_json(app.http_port, "/debug/qos")["classes"]["standard"][
        "expired"]
    log(f"qos: deadline: a standard request queued 1 s past its 0.5 s "
        f"deadline answered {status} Retry-After {headers.get('Retry-After')}"
        f" ({body['error']['message'][:60]}); expired {expired}")
    require(status == 503 and headers.get("Retry-After") and expired == 1,
            "qos: the standard request did not expire at its deadline")


def openai_classes(env, engine, card) -> None:
    """The OpenAI server on the same engine (its own App: QoS, the meter
    and the recorder wired again): chat completions with X-QoS-Class and
    X-Tenant land in their class and tenant in /debug/qos and
    /debug/capacity; an unknown class is a 400. Its shutdown stops the
    engine."""
    from gofr_tpu_torch import serve_openai

    app = serve_openai.build_app(env, engine=engine)
    app.start()
    try:
        pin_ladder(engine.qos)
        sent = {"interactive": "tenant-i", "standard": "tenant-s",
                "batch": "tenant-b"}
        statuses = {}
        for cls, tenant in sent.items():
            status, _, _ = post_json(
                app.http_port, "/v1/chat/completions",
                {"messages": [{"role": "user", "content": f"hi {cls}"}],
                 "max_tokens": 4, "temperature": 0},
                {"X-QoS-Class": cls, "X-Tenant": tenant})
            statuses[cls] = status
        bad, _, _ = post_json(
            app.http_port, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "hi"}],
             "max_tokens": 4}, {"X-QoS-Class": "platinum"})
        snap = get_json(app.http_port, "/debug/qos")
        cap = get_json(app.http_port, "/debug/capacity")
    finally:
        app.shutdown()
    billed = {a["class"]: a["tenant"] for a in cap["accounts"]}
    log(f"qos: openai: chat completions by class {statuses}, unknown class "
        f"{bad}; /debug/qos tenants {snap['tenants']}; /debug/capacity "
        f"accounts {billed}")
    require(all(s == 201 for s in statuses.values()) and bad == 400,
            "qos: the OpenAI server's classes were not served")
    require(snap["tenants"] == {c: {t: 1} for c, t in sent.items()}
            and billed == {c: t for c, t in sent.items()},
            "qos: the OpenAI server's classes or tenants were lost")


def dense_preemption(params, cfg, dev, card,
                     preset: str = "llama3-8b") -> None:
    """The dense engine (PAGED=false DECODE_ATTN=kernel) at the depth of
    `params`, QOS=true, WARMUP=wide: qos_streams' traffic undisturbed and
    then pinned at preempt_batch at mid-stream: every row preempted and
    re-admitted (a full wave at its resume bucket), each stream equal or
    at a tie, flash n_layers per wave and the dense read n_layers per
    decode step, no graph captured by the preempted run."""
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine

    env = {**QUIET, "MODEL_PRESET": preset, "ATTN_IMPL": "flash",
           "PAGED": "false", "DECODE_ATTN": "kernel", "HTTP_PORT": "0",
           "METRICS_PORT": "0", "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
           "PREFILL_BUCKETS": "16,32,64,128,256", "WARMUP": "wide",
           "QOS": "true"}
    engine = build_engine(env, device=dev, params=params)
    boot = boot_line(engine, f"dense qos ({cfg.n_layers} layers)", card)
    app = build_app(env, engine=engine)
    app.start()
    try:
        ctl = engine.qos
        pin_ladder(ctl)
        ids, inter_ids = qos_prompts(engine.tokenizer, QOS_SEED + 400)
        ref = qos_streams(engine, ctl, ids, inter_ids, QOS_TOKENS,
                          inter_at=QOS_TOKENS // 4)
        zero_counts(engine)
        run = qos_streams(engine, ctl, ids, inter_ids, QOS_TOKENS,
                          inter_at=QOS_TOKENS // 4, pin_at=QOS_TOKENS // 2)
        launches = launch_counts.counts()
        waves, steps = engine.prefill_dispatches, engine.decode_steps
        L = engine.cfg.n_layers
        log(f"qos: dense ({L} layers): rows preempted per loop step at "
            f"preempt_batch {run['acts']}; flash {launches['flash_attention']}"
            f" over {waves} waves, decode_attention "
            f"{launches['decode_attention']} over {steps} steps; "
            f"re-admission waves {[w[:3] for w in run['waves']]} "
            f"{sum(w[3] for w in run['waves']):.3f} card ms; graphs "
            f"captured by the run {run['captured']} (after boot "
            f"{engine.executor.captures - boot}) [{card}]")
        check_preempted("qos dense", run, QOS_TOKENS)
        require(launches["flash_attention"] == L * waves
                and launches["decode_attention"] == L * steps
                and waves > 0 and steps > 0,
                "qos dense: launches are not n_layers per wave and step")
        matched = check_ties(engine, "qos dense", ids, run["out"], ref["out"])
        log(f"qos: dense: {matched} of {len(ids)} batch streams equal the "
            f"unpreempted run token for token")
    finally:
        app.shutdown()


FAULTS_CHARS = 160
FAULTS_SEED = 3000       # prompt seeds no other phase uses


def faults_env(tmp: str) -> dict:
    """The main path's serve config with the chaos plane armed, a 1 s
    breaker cooldown, a retry budget the storm's 3 resets leave room in,
    incident bundles and profiles in `tmp`, every incident captured."""
    return {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
            "HTTP_PORT": "0", "METRICS_PORT": "0", "MAX_BATCH": "8",
            "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
            "PREFILL_BUCKETS": "16,32,64,128,256", "REQUEST_TIMEOUT": "600",
            "WARMUP": "wide", "FAULT_INJECTION": "true",
            "BREAKER_COOLDOWN_S": "1", "RESET_STORM_MAX": "3",
            "ENGINE_RETRY_BUDGET": "3", "INCIDENT_COOLDOWN_S": "0",
            "INCIDENT_DIR": f"{tmp}/incidents",
            "PROFILE_DIR": f"{tmp}/profiles"}


def post_json(port, path, body, headers=None) -> tuple:
    """POST `path`: (status, headers, the {data} or error envelope)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), json.loads(raw or b"null")


def wait_for(cond, what: str, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    require(cond(), f"timed out waiting for {what}")


def faults_phase(params, cfg, dev, card: str) -> None:
    """Phase 11 (--faults), on the main path's engine with FAULT_INJECTION:
    the reset storm and the breaker, a quarantine, the breaker_open
    incident bundle, a /debug/profile capture (the route enabled on this
    App: the servers serve none) while streams are served, the
    capacity meter against /debug/steps, and the planes' cost."""
    import shutil
    import tempfile

    from gofr_tpu_torch.serve import build_app, build_engine

    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="gofr-faults-")
    env = faults_env(tmp)
    engine = build_engine(env, device=dev, params=params)
    boot = boot_line(engine, "paged faults", card)
    app = build_app(env, engine=engine)
    # the servers serve no /debug/profile, as the reference's: this
    # harness enables it on its own App
    app.enable_profiler()
    app.start()
    try:
        tok = engine.tokenizer
        seed = iter(range(FAULTS_SEED, FAULTS_SEED + 1000))

        def prompt(n=FAULTS_CHARS):
            return tok.encode(make_prompt(n, next(seed)))

        # the profile last: a process that has profiled keeps CUPTI
        # attached, which costs its graph launches host time
        for step in (storm_drill, quarantine_drill, incident_check,
                     capacity_check, planes_cost, profile_drill):
            t0 = time.monotonic()
            step(app, engine, card, prompt, tmp)
            log(f"faults: {step.__name__} {time.monotonic() - t0:.1f}s")
        require(engine.executor.captures == boot,
                "faults: a graph was captured after boot")
    finally:
        app.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"faults: phase 11 {time.monotonic() - t_all:.1f}s")


def storm_drill(app, engine, card, prompt, tmp) -> None:
    """engine.decode armed to raise 3 times over POST /debug/faults; two
    requests in flight (neither alone, so no quarantine): 3 resets open
    the breaker; /generate answers 503 with Retry-After and the engine's
    health reads DOWN; the half-open probe after BREAKER_COOLDOWN_S closes
    it, the two requests complete through their replays, and a new
    request gets its 201."""
    # healthy traffic first: the bundle's step ring holds real records (the
    # storm's own steps abort)
    require(len(engine.generate(prompt(), max_new_tokens=8)) == 8,
            "faults: the engine did not serve before the storm")
    status, _, body = post_json(app.http_port, "/debug/faults", {
        "plan": [{"site": "engine.decode", "every": 1, "times": 3}]})
    require(status == 201, f"faults: arming the storm answered {status}")
    resets0 = engine.resets_total
    reqs = [engine.submit(prompt(), max_new_tokens=16) for _ in range(2)]
    wait_for(lambda: engine.breaker.state == "open", "the breaker to open")
    status, headers, body = post_json(app.http_port, "/generate", {
        "prompt": "storm", "max_tokens": 4, "stream": False})
    retry = headers.get("Retry-After")
    health = get_json(app.http_port, "/.well-known/health")
    engine_health = health["details"]["engine"]
    log(f"faults: storm: {engine.resets_total - resets0} resets opened the "
        f"breaker; /generate answered {status} Retry-After {retry} "
        f"({body['error']['message'][:60]}); engine health "
        f"{engine_health['status']} [{card}]")
    require(status == 503 and retry is not None,
            "faults: an open breaker did not shed /generate with a 503")
    require(engine_health["status"] == "DOWN",
            "faults: an open breaker left the engine's health up")
    t0 = time.monotonic()
    wait_for(lambda: engine.breaker.state == "closed",
             "the half-open probe to close the breaker")
    closed_s = time.monotonic() - t0
    outs = [r.result(timeout_s=120) for r in reqs]
    require(all(len(o) == 16 for o in outs),
            "faults: the storm's requests did not complete")
    status, _, body = post_json(app.http_port, "/generate", {
        "prompt": "after the storm", "max_tokens": 4, "stream": False})
    require(status == 201 and body["data"]["tokens"] == 4,
            f"faults: /generate after the breaker closed answered {status}")
    events = [e["event"] for e in
              engine.recorder.snapshot()["engine_events"]]
    log(f"faults: storm: breaker closed {closed_s:.2f}s later; the 2 "
        f"requests completed through {engine.replays_total} replays; a new "
        f"request got 201; engine events "
        f"{[e for e in events if e.startswith(('breaker', 'device'))]}")
    for name in ("device_reset", "breaker_open", "breaker_shed",
                 "breaker_closed"):
        require(name in events, f"faults: no {name} engine event")


def quarantine_drill(app, engine, card, prompt, tmp) -> None:
    """A request alone in flight across two resets in a row is quarantined:
    it fails with the device error, and the engine serves on."""
    from gofr_tpu_torch.tpu.engine import CacheLostError

    status, _, _ = post_json(app.http_port, "/debug/faults", {
        "plan": [{"site": "engine.decode", "every": 1, "times": 2}]})
    require(status == 201, "faults: arming the quarantine failed")
    q0, r0 = engine.quarantined_total, engine.resets_total
    req = engine.submit(prompt(), max_new_tokens=16)
    failed = None
    try:
        req.result(timeout_s=120)
    except CacheLostError as exc:
        failed = exc
    post_json(app.http_port, "/debug/faults", {"disarm": True})
    names = [e["event"] for e in
             engine.recorder.lookup(req.id)["events"]]
    log(f"faults: quarantine: {engine.resets_total - r0} resets, "
        f"quarantined {engine.quarantined_total - q0}, the request "
        f"{'failed: ' + str(failed)[:50] if failed else 'completed'}; its "
        f"events {[n for n in names if n in ('replayed', 'quarantined')]}; "
        f"breaker {engine.breaker.state}")
    require(failed is not None and engine.quarantined_total - q0 == 1
            and "quarantined" in names,
            "faults: the poison request was not quarantined")
    require(len(engine.generate(prompt(), max_new_tokens=4)) == 4,
            "faults: the engine did not serve after the quarantine")


BUNDLE_SECTIONS = ("steps", "engine", "slowest_requests", "engine_events",
                   "config_fingerprint")


def incident_check(app, engine, card, prompt, tmp) -> None:
    """The storm's breaker_open bundle (and the quarantine's), written to
    the temporary INCIDENT_DIR, with the reference's sections."""
    import os

    require(engine.incidents.wait_idle(30.0), "faults: a capture hung")
    index = get_json(app.http_port, "/debug/incidents")
    by_trigger = {b["trigger"]: b for b in index["incidents"]}
    require("breaker_open" in by_trigger and "quarantine" in by_trigger,
            f"faults: bundles {sorted(by_trigger)}")
    bundle = get_json(app.http_port,
                      f"/debug/incidents/{by_trigger['breaker_open']['id']}")
    missing = [k for k in BUNDLE_SECTIONS if k not in bundle]
    on_disk = bundle.get("path") and os.path.exists(bundle["path"])
    log(f"faults: incidents: {index['captured_total']} bundles "
        f"({sorted(by_trigger)}); breaker_open bundle sections "
        f"{sorted(k for k in bundle if k in BUNDLE_SECTIONS)}, "
        f"{len(bundle.get('steps', {}).get('recent', []))} steps, "
        f"{len(bundle.get('slowest_requests', []))} slowest requests, "
        f"resets {bundle['engine']['recovery']['resets_total']}, context "
        f"breaker {bundle['context']['breaker']['state']}, written "
        f"{bool(on_disk)} under INCIDENT_DIR")
    require(not missing and bundle["steps"].get("recent")
            and bundle["slowest_requests"],
            f"faults: the bundle lacks {missing} or holds no records")
    require(on_disk and bundle["path"].startswith(tmp),
            "faults: the bundle was not written to INCIDENT_DIR")
    require(bundle["context"]["breaker"]["state"] == "open"
            and bundle["engine"]["recovery"]["resets_total"] >= 3,
            "faults: the bundle did not freeze the storm")


def trace_kernels(trace_dir: str) -> dict:
    """The kernel events of a capture's Chrome trace: flash and the paged
    bf16 read (decode_split_kernel over KvBf16 and Paged)."""
    import os

    from gofr_tpu_torch.tpu.profiler import TRACE_FILE

    with open(os.path.join(trace_dir, TRACE_FILE)) as fp:
        events = json.load(fp)["traceEvents"]
    out = {"flash": 0, "paged_read": 0, "kernels": 0}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        out["kernels"] += 1
        # the trace's names are demangled: the template's arguments spelled
        name = e.get("name", "")
        if "flash_fwd_kernel" in name:
            out["flash"] += 1
        if ("decode_split_kernel" in name and "KvBf16" in name
                and "Paged" in name):
            out["paged_read"] += 1
    return out


def profile_drill(app, engine, card, prompt, tmp) -> None:
    """POST /debug/profile (2 s) while 2 streams of 17 tokens are admitted
    and decode, 0.5 s into the window: 202 at once, the capture's trace
    holds flash and paged-read kernel events, all from graph replays (a
    decode step is ~2600 kernels, so ~160k events; stopping and writing
    them takes ~10 s, during which the capture thread holds the GIL: the
    traffic is kept small); then, with a torch.profiler of this
    script's own running, a capture is refused in last_error and the
    engine's loop serves on."""
    import torch

    from gofr_tpu_torch.tpu import profiler

    t0 = time.monotonic()
    status, _, body = post_json(app.http_port, "/debug/profile",
                                {"seconds": 2.0})
    require(status == 202 and time.monotonic() - t0 < 1.0,
            f"faults: POST /debug/profile answered {status}")
    trace_dir = body["data"]["trace_dir"]
    # the process's first capture initializes CUPTI before its window
    wait_for(profiler.recording, "the capture to record")
    init_s = time.monotonic() - t0
    time.sleep(0.5)
    reqs = [engine.submit(prompt(), max_new_tokens=17) for _ in range(2)]
    for r in reqs:
        r.result(timeout_s=120)
    t0 = time.monotonic()
    wait_for(lambda: not get_json(app.http_port, "/debug/profile")["active"],
             "the capture to end", timeout_s=180)
    ended = time.monotonic() - t0
    status = get_json(app.http_port, "/debug/profile")
    require(status["last_error"] is None,
            f"faults: the capture failed: {status['last_error']}")
    kern = trace_kernels(trace_dir)
    log(f"faults: profile: 2 s capture during 2 streams x 17 tokens: "
        f"{kern['kernels']} kernel events, flash {kern['flash']}, paged read "
        f"{kern['paged_read']}; recording {init_s:.1f}s after the POST "
        f"(CUPTI's first start), ended {ended:.1f}s after the streams (stop "
        f"and write; duration {status['last_duration_s']}s); "
        f"trace at {status['last_rel']} under PROFILE_DIR [{card}]")
    require(kern["flash"] > 0 and kern["paged_read"] > 0,
            "faults: the capture lost the graph replays' kernels")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        status, _, _ = post_json(app.http_port, "/debug/profile",
                                 {"seconds": 0.5})
        require(status == 202, "faults: the second capture was not taken")
        wait_for(lambda: not get_json(app.http_port,
                                      "/debug/profile")["active"],
                 "the refused capture to end")
    err = get_json(app.http_port, "/debug/profile")["last_error"]
    require(err and "another torch.profiler" in err,
            f"faults: a capture beside another profiler gave {err!r}")
    require(engine._thread.is_alive()
            and len(engine.generate(prompt(), max_new_tokens=4)) == 4,
            "faults: the engine did not serve after the refused capture")
    log(f"faults: profile: beside this script's own torch.profiler the "
        f"capture was refused ({err[:70]}); the engine serves on")


def capacity_check(app, engine, card, prompt, tmp) -> None:
    """/debug/capacity after the streams: each metered step's attributed
    device seconds equal its measured ones (1e-9 relative) and those the
    step's /debug/steps record shows (to its 1 us rounding); rho, headroom
    and the TTFT forecast finite."""
    snap = get_json(app.http_port, "/debug/capacity")
    steps = get_json(app.http_port, "/debug/steps?recent=512")
    by_step = {s["step"]: s for s in steps["recent"]}
    metered = [s for s in snap["steps"] if s["seq"] in by_step]
    worst_rel = worst_abs = 0.0
    for s in metered:
        seg = by_step[s["seq"]]["segments"]
        measured = seg.get("device_sync", 0.0) + seg.get("dispatch", 0.0)
        worst_rel = max(worst_rel, abs(s["attributed_s"] - s["device_s"])
                        / max(s["device_s"], 1e-12))
        worst_abs = max(worst_abs, abs(s["device_s"] - measured))
    fc = snap["forecast"]
    log(f"faults: capacity: {len(metered)} metered steps beside "
        f"/debug/steps: attributed vs measured worst {worst_rel:.3g} "
        f"relative, vs the steps' segments worst {worst_abs:.3g} s (they "
        f"round to 1e-6 s); totals device_s {snap['totals']['device_s']}, "
        f"rho {fc['rho']}, headroom {fc['headroom_tok_s']} tok/s, mu "
        f"{fc['mu_tok_s']} tok/s, predicted TTFT {fc['predicted_ttft_ms']} "
        f"ms [{card}]")
    require(metered, "faults: no metered step in /debug/steps' window")
    require(worst_rel <= 1e-9 and worst_abs <= 1.01e-6,
            "faults: the meter did not conserve the steps' device time")
    require(all(math.isfinite(fc[k]) for k in
                ("rho", "headroom_tok_s", "predicted_ttft_ms")),
            "faults: a non-finite forecast")


def planes_cost(app, engine, card, prompt, tmp) -> None:
    """The planes this slice adds (cost_windows): the SLO burn engine (the
    recorder's tap), the capacity meter and the off-loop finisher on, as
    served, against all three off."""
    recorder = engine.recorder
    burn, meter, finisher = recorder.burn, engine.meter, engine._finisher
    require(burn is not None and meter is not None and finisher is not None,
            "planes cost: burn, meter or finisher is not on")

    def toggle(on: bool) -> None:
        recorder.burn = burn if on else None
        engine.meter = meter if on else None
        engine._finisher = finisher if on else None

    figures = cost_windows(engine, toggle, 4000)
    log(f"planes cost (burn, meter and finisher): {figures} [{card}]")


# -- phase 4e: migration on the main path's engine ---------------------------
MIGRATE_CHARS = (110, 130, 150, 170, 190, 120, 140)
MIGRATE_SEED = 6000      # prompt seeds no other phase uses
MIGRATE_TOKENS = 48
MIGRATE_AT = 16          # delivered tokens of every stream at the round
MIGRATE_LIMIT_S = 30.0
# over HTTP the drain is requested from a client thread: the streams must
# outlast the blocks in flight and the request's way in
MIGRATE_HTTP_TOKENS = 200
# prompts short enough that a resume window (prompt + what was delivered
# by the round) stays inside the admission limit (the largest bucket, 256)
MIGRATE_HTTP_CHARS = (40, 50, 60, 70, 80, 45, 55)


def migrate_streams(engine, ids, n_tok, at=None) -> dict:
    """The migration phase's greedy streams, admitted in one round
    (gate_admission). at: request one migration round as soon as the
    decode blocks dispatched since every stream was bound bring each to
    `at` delivered tokens (the prefill's first token and at - 1 decode
    steps), so the round, at the quiesced boundary once they have synced,
    finds every stream live at about `at` tokens (requested at a sync, the
    pipeline's blocks in flight would carry the streams up to 64 tokens
    further first). The sink takes every export; once the round has run,
    each is landed back on the same engine through submit_handoff with its
    blobs (the reference's _local_resume), the client's queue and cancel
    event shared. Records the launch counts and captures at the round (the
    sink runs on the loop thread, everything before it synced), the
    exports, and the loop steps of the run."""
    reqs: list = []
    exported: list = []
    state: dict = {}

    def sink(request, blobs, n_ctx):
        if not exported:
            state["at_round"] = drill_counts(engine)
            state["captures"] = engine.executor.captures
        exported.append((request, blobs, n_ctx))
        return True

    dispatch = engine._dispatch_decode

    def armed_dispatch():
        bound = (len(reqs) == len(ids) and all(
            any(s.request is r for s in engine.slots) for r in reqs))
        if bound and "d0" not in state:
            state["d0"] = engine.decode_steps
        dispatch()
        if ("armed" not in state and "d0" in state
                and engine.decode_steps - state["d0"] >= at - 1):
            state["armed"] = engine.steps.steps_total
            engine.request_migration(sink)

    if at is not None:
        engine._dispatch_decode = armed_dispatch
    seq0 = engine.steps.steps_total
    try:
        gate_admission(engine, len(ids))
        reqs.extend(engine.submit(x, max_new_tokens=n_tok) for x in ids)
        if at is not None:
            wait_for(lambda: "armed" in state and not engine.migration_pending,
                     "the migration round", 120)
            state["emitted_at_round"] = [len(r.emitted) for r, _, _ in
                                         exported]
            state["landed"] = [engine.submit_handoff(
                r.prompt_tokens, list(r.emitted),
                max_new_tokens=r.max_new_tokens, temperature=r.temperature,
                stop_tokens=set(r.stop_tokens), out_queue=r.out_queue,
                cancelled=r.cancelled, blobs=blobs)
                for r, blobs, _ in exported]
        out = [r.result(timeout_s=300) for r in reqs]
        wait_idle(engine)
    finally:
        engine.__dict__.pop("_dispatch_decode", None)
    state["steps"] = (seq0, engine.steps.steps_total)
    return {"reqs": reqs, "out": out, "exported": exported, **state}


def migrate_phase(engine, card: str, boot: int) -> None:
    """Phase 4e on the main path's served engine, after 4d: 7 greedy
    streams x 48 tokens undisturbed, then again with one migration round
    at 16 delivered tokens whose sink lands every export back on the same
    engine through submit_handoff(blobs=...) (the reference's local
    resume). Every row exported once with its pages (n_ctx = prompt +
    emitted - 1), landed with no prefill and no fallback, no graph
    captured; flash n_layers per full wave and the paged read n_layers per
    decode step on both sides of the round (counted from zero just before
    the run, read at the round and after); each stream equal to the
    undisturbed run or leaving it at a tie of at most QOS_TIE_STEPS bf16
    steps. Logged: the kv_handoff segment's share of the loop wall over
    the run, the phase's seconds."""
    t0 = time.monotonic()
    tok = engine.tokenizer
    ids = [tok.encode(make_prompt(n, MIGRATE_SEED + i))
           for i, n in enumerate(MIGRATE_CHARS)]
    L = engine.cfg.n_layers
    with engine._state_lock:
        drop_prefix(engine)
    ref = migrate_streams(engine, ids, MIGRATE_TOKENS)["out"]
    with engine._state_lock:
        drop_prefix(engine)
    zero_counts(engine)
    m0, f0 = engine.migrations_total, engine.handoff_fallbacks_total
    c0 = engine.executor.captures
    t1 = time.monotonic()
    run = migrate_streams(engine, ids, MIGRATE_TOKENS, at=MIGRATE_AT)
    wall = time.monotonic() - t1
    total = drill_counts(engine)
    before = run["at_round"]
    after = {k: total[k] - before[k] for k in total}
    exported = run["exported"]
    seq0, seq1 = run["steps"]
    recs = [r for r in engine.steps.records(1024) if seq0 < r.seq <= seq1]
    handoff_s = sum(r.segments.get("kv_handoff", 0.0) for r in recs)
    loop_s = sum(r.wall_s for r in recs)
    pages = [len(b) if b else 0 for _, b, _ in exported]
    log(f"migrate: one round at {MIGRATE_AT} delivered tokens (delivered "
        f"at the round {run['emitted_at_round']}): "
        f"{len(exported)} exported with pages {pages}, "
        f"migrations {engine.migrations_total - m0}, fallbacks "
        f"{engine.handoff_fallbacks_total - f0}, graphs captured "
        f"{engine.executor.captures - c0} (after boot "
        f"{engine.executor.captures - boot}); the run up to the round "
        f"{before}, after it {after} (n_layers={L}); 7 streams x "
        f"{MIGRATE_TOKENS} tokens in {wall:.2f}s [{card}]")
    log(f"migrate: the kv_handoff segment {handoff_s * 1e3:.3f} ms of "
        f"{loop_s * 1e3:.1f} ms over the run's {len(recs)} loop steps, share "
        f"{handoff_s / max(loop_s, 1e-9):.6f} (the export round's pulls and "
        f"the landings) [{card}]")
    require(len(exported) == len(ids)
            and {id(r) for r, _, _ in exported} == {id(r) for r in run["reqs"]},
            "migrate: not every stream was exported once")
    for r, blobs, n_ctx in exported:
        require(blobs is not None and n_ctx == len(r.resume_tokens) - 1
                and len(blobs) == engine.allocator.pages_for(n_ctx),
                f"migrate: request {r.id} exported {n_ctx} positions in "
                f"{len(blobs) if blobs else 0} pages")
    require(engine.migrations_total - m0 == len(ids)
            and engine.handoff_fallbacks_total == f0,
            "migrate: an export was not taken or a landing fell back")
    require(engine.executor.captures == c0 and run["captures"] == c0,
            "migrate: a graph was captured by the round or the landings")
    require(after["waves"] == 0 and after["tail_waves"] == 0,
            f"migrate: the landed rows were prefilled ({after})")
    if engine.device.type == "cuda":
        for what, c in (("up to the round", before),
                        ("after the round", after)):
            require(c["flash_attention"] == L * c["waves"]
                    and c["paged_attention"] == L * c["steps"],
                    f"migrate: {what}, launches {c} are not n_layers per "
                    f"full wave and per decode step")
        require(after["steps"] > 0, "migrate: no decode after the round")
    for i, toks in enumerate(run["out"]):
        require(len(toks) == MIGRATE_TOKENS,
                f"migrate: stream {i} delivered {len(toks)} tokens")
    matched = check_ties(engine, "migrate", ids, run["out"], ref)
    took = time.monotonic() - t0
    log(f"migrate: {matched} of {len(ids)} streams equal the undisturbed run "
        f"token for token; phase 4e {took:.1f}s [{card}]")
    require(took < MIGRATE_LIMIT_S, f"migrate: {took:.1f}s over "
            f"{MIGRATE_LIMIT_S}s")


# -- phase 13: the KV tier, the pair, migration over HTTP, the warm boot -------
ELASTIC_ENV = {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
               "HTTP_PORT": "0", "METRICS_PORT": "0", "MAX_BATCH": "8",
               "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
               "PREFILL_BUCKETS": "16,32,64,128,256",
               "REQUEST_TIMEOUT": "600", "WARMUP": "wide",
               "HOSTPROF": "false", **grpc_env()}
# the tier phase: a 384-token system prompt (3 full pages) in a pool too
# small to keep it while other prompts run
TIER_ENV = {**ELASTIC_ENV, "PREFILL_BUCKETS": "16,32,64,128,256,512",
            "N_PAGES": "12"}
TIER_SEED = 7000         # prompt seeds no other phase uses
TIER_TOKENS = 32
TIER_TAILS = (40, 60)    # the seeding and the probe prompts' tails
TIER_CHURN_CHARS = 300   # the other prompts: 3 pages each with their tokens
TIER_TAIL_BUCKET = 64    # the probe's tail wave


def page_nbytes(cfg, page_size: int, kv: str) -> int:
    """One page's k and v across the layers (int8: with its f32 scales):
    16 MiB for Llama-3-8B at 128 tokens in bf16."""
    per = cfg.n_layers * cfg.n_kv_heads * page_size
    if kv == "int8":
        return 2 * per * (cfg.head_dim + 4)
    return 2 * per * cfg.head_dim * {"float32": 4}.get(cfg.dtype, 2)


class DictStore:
    """A store with the Redis datasource's set / get / delete surface over
    a dict (KV_REDIS_TIER waits in ROADMAP A18b): the cold tier two
    replicas of one process share."""

    def __init__(self):
        self.data: dict = {}
        self.lock = threading.Lock()

    def set(self, key, value, ttl_s=None):
        with self.lock:
            self.data[key] = str(value)

    def get(self, key):
        with self.lock:
            return self.data.get(key)

    def delete(self, key):
        with self.lock:
            self.data.pop(key, None)


def tier_prompts(tok) -> tuple:
    """(system + a seeding tail, system + the compared tail, churn prompts
    of ~300 tokens), as token ids."""
    system = make_prompt(SYSTEM_CHARS, TIER_SEED)
    seed = tok.encode(system + make_prompt(TIER_TAILS[0], TIER_SEED + 1))
    probe = tok.encode(system + make_prompt(TIER_TAILS[1], TIER_SEED + 2))
    churn = [tok.encode(make_prompt(TIER_CHURN_CHARS, TIER_SEED + 10 + i))
             for i in range(12)]
    return seed, probe, churn


def tier_phase(params, cfg, dev, card: str, kv: str, store=None) -> tuple:
    """13a. The KV tier on the main path at full width and depth: a paged
    engine (WARMUP=wide, N_PAGES=12, KV_HOST_TIER_BYTES; bf16 or int8 KV;
    with `store` the shared cold tier under it and a host tier of 4
    pages) seeds a 384-token system prompt, serves a probe prompt on it
    with the 3 pages resident (the unspilled run: a tail-only wave), runs
    other prompts until those pages are spilled (and, with a store, went
    on to it), then serves the probe again: its pages restored by one copy
    (kv_restore), a tail-only wave, and its stream equal to the unspilled
    run token for token (the restored pages are the spilled bits). Held:
    spilled and restored counts, tier hits, no fallback to a full prefill,
    no capture after boot, the launches. Logged: the kv_restore segment,
    the restore's card ms by events per page beside the tail prefill over
    the same pages and the full prefill they save. Returns (the App, still
    serving, its engine, the unspilled tokens) when `store` is given (the
    warm boot's peer), else shuts it down."""
    import torch

    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.tpu.kvtier import RedisKVTier

    host_pages = 4 if store is not None else 64
    env = {**TIER_ENV, "KV_HOST_TIER_BYTES": str(
        host_pages * page_nbytes(cfg, int(TIER_ENV["PAGE_SIZE"]), kv)
        + 4096), **({"KV_DTYPE": "int8"} if kv == "int8" else {})}
    cold = RedisKVTier(store, write_behind=False) if store else None
    engine = build_engine(env, device=dev, params=params,
                          kv_cold_store=cold)
    what = f"tier {kv}"
    boot = boot_line(engine, what, card)
    app = build_app(env, engine=engine)
    app.start()
    keep = False
    try:
        tok = engine.tokenizer
        seed, probe, churn = tier_prompts(tok)
        keys = engine.prefix.keys_for(probe, 3)
        engine.generate(seed, max_new_tokens=8)
        wait_idle(engine)
        ref = engine.generate(probe, max_new_tokens=TIER_TOKENS)
        require(engine.prefix_dispatches >= 1, f"{what}: the probe missed "
                f"the resident pages")

        def resident() -> int:
            """The system pages still in the pool (a peek: match would
            touch them as recently used and take refs)."""
            with engine._state_lock:
                return sum(1 for k in keys if k in engine.prefix._entries)

        used = 0
        for ids in churn:
            in_store = (store is None or all(
                f"gofr:kvpage:{k:#x}" in store.data for k in keys))
            if not resident() and in_store:
                break
            engine.generate(ids, max_new_tokens=8)
            used += 1
        wait_idle(engine)
        require(not resident(), f"{what}: the system pages were never "
                f"evicted")
        require(store is None or all(f"gofr:kvpage:{k:#x}" in store.data
                                     for k in keys),
                f"{what}: the system pages never reached the cold store")
        spilled, restored0 = engine._kv_spilled, engine._kv_restored
        stats0 = engine.kv_tier.stats()
        zero_counts(engine)
        c0 = engine.executor.captures
        seq0 = engine.steps.steps_total
        got = engine.generate(probe, max_new_tokens=TIER_TOKENS)
        wait_idle(engine)
        counts = drill_counts(engine)
        recs = [r for r in engine.steps.records(512) if r.seq > seq0]
        restore_s = sum(r.segments.get("kv_restore", 0.0) for r in recs)
        loop_s = sum(r.wall_s for r in recs)
        stats = engine.kv_tier.stats()
        restored = engine._kv_restored - restored0
        hits = stats["hits"] - stats0["hits"] + (
            stats["redis"]["hits"] - stats0["redis"]["hits"]
            if "redis" in stats else 0)
        log(f"{what}: {used} other prompts evicted the system prompt's 3 "
            f"pages: spilled {spilled} pages in all; the probe again: "
            f"restored {restored}, tier hits {hits} (host "
            f"{stats['hits'] - stats0['hits']}"
            + (f", cold {stats['redis']['hits'] - stats0['redis']['hits']}, "
               f"cold stored {stats['redis']['stored']}"
               if "redis" in stats else "")
            + f"), dispatches and bf16 reads {counts}, graphs captured "
            f"{engine.executor.captures - c0} (after boot "
            f"{engine.executor.captures - boot}) [{card}]")
        log(f"{what}: the kv_restore segment {restore_s * 1e3:.3f} ms of "
            f"{loop_s * 1e3:.1f} ms over the repeat's {len(recs)} loop steps "
            f"[{card}]")
        require(spilled >= 3 and restored == 3 and hits >= 3,
                f"{what}: spilled {spilled}, restored {restored}, hits {hits}")
        require(counts["waves"] == 0 and counts["tail_waves"] == 1,
                f"{what}: the restored probe was not one tail-only wave "
                f"({counts})")
        require(engine.executor.captures == c0 == boot,
                f"{what}: a graph was captured after boot")
        if engine.device.type == "cuda":
            from gofr_tpu_torch.ops import launch_counts

            read = "paged_attention_q8" if kv == "int8" else "paged_attention"
            reads = launch_counts.counts()[read]
            L = engine.cfg.n_layers
            log(f"{what}: {read} {reads} launches over "
                f"{counts['steps']} decode steps (n_layers={L}) [{card}]")
            require(reads == L * counts["steps"]
                    and counts["flash_attention"] == 0,
                    f"{what}: {read} {reads} over {counts}")
        require(got == ref, f"{what}: the restored stream left the "
                f"unspilled run's: {got} vs {ref}")
        log(f"{what}: the restored probe equals the unspilled run token for "
            f"token ({TIER_TOKENS} tokens) [{card}]")
        if store is not None:
            keep = True
            return app, engine, ref, probe
        # the restore's card time by events on the engine's stream (host
        # staging included), against the tail prefill over the same pages
        # and the full prefill a miss would pay
        ps = engine.page_size
        blobs = [engine.kv_tier.get(k, probe[i * ps:(i + 1) * ps])
                 for i, k in enumerate(keys)]
        require(all(b is not None for b in blobs),
                f"{what}: the tier lost the system pages")
        app.shutdown()
        app = None
        drop_prefix(engine)   # the loop stopped: every cached page is idle
        pages = engine.allocator.alloc(3)
        engine._h2d_restore(pages, blobs)
        if engine.device.type == "cuda":
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record(engine._stream)
                engine._h2d_restore(pages, blobs)
                end.record(engine._stream)
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = sorted(times)[len(times) // 2]
            nbytes = sum(b.nbytes for b in blobs)
            tail = time_wave(engine, 1, TIER_TAIL_BUCKET, True, 5,
                             prefix_pages=3)
            full = time_wave(engine, 1, max(engine.prefill_buckets), False,
                             5)
            log(f"{what}: restore of 3 pages ({nbytes / 2**20:.1f} MiB) "
                f"{ms:.3f} ms by events (median of 5, host staging "
                f"included), {ms / 3:.3f} ms a page, "
                f"{nbytes / ms / 1e6:.2f} GB/s; the tail prefill over the "
                f"same 3 pages [1, {TIER_TAIL_BUCKET}] replay card_busy_ms "
                f"{tail['graph'][1]:.3f}; the full prefill it saves [1, "
                f"{max(engine.prefill_buckets)}] replay card_busy_ms "
                f"{full['graph'][1]:.3f} [{card}]")
        engine.allocator.release(pages)
    finally:
        if app is not None and not keep:
            app.shutdown()
    del engine
    torch.cuda.empty_cache()
    return None


def warm_boot_phase(params, cfg, dev, card: str, peer, peer_engine, store,
                    ref, probe) -> None:
    """13d. The warm boot: an App booted with ELASTIC_WARM_BOOT=true,
    ELASTIC_PREWARM_PEERS = the tier phase's App (its /debug/kvtier
    advertising the system pages it promoted back from the shared cold
    store) and the same cold store under its tier: /stats says warming at
    once, then serving with warm_boot_s; the pages pre-warmed into its host
    tier; the first request on the system prompt restores them (a tier
    hit, no full prefill) and streams the peer's unspilled tokens."""
    import torch

    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.tpu.kvtier import RedisKVTier

    # a lookup on the peer (idle) promotes the system pages back from the
    # shared store into its host tier, as a restore did: what it advertises
    ps = peer_engine.page_size
    keys = peer_engine.prefix.keys_for(probe, 3)
    for i, key in enumerate(keys):
        require(peer_engine.kv_tier.get(key, probe[i * ps:(i + 1) * ps])
                is not None, "warm boot: the peer lost a system page")
    keys = set(keys)
    inventory = get_json(peer.http_port, "/debug/kvtier")["pages"]
    log(f"warm boot: the peer advertises {len(inventory)} pages, "
        f"{len(keys & {r['key'] for r in inventory})} of them the system "
        f"prompt's [{card}]")
    env = {**TIER_ENV, "KV_HOST_TIER_BYTES": str(
        64 * page_nbytes(cfg, int(TIER_ENV["PAGE_SIZE"]), "bf16")),
        "ELASTIC_WARM_BOOT": "true",
        "ELASTIC_PREWARM_PEERS": f"http://127.0.0.1:{peer.http_port}",
        "ELASTIC_PREWARM_PAGES": "64"}
    t0 = time.monotonic()
    engine = build_engine(env, device=dev, params=params,
                          kv_cold_store=RedisKVTier(store,
                                                    write_behind=False))
    app = build_app(env, engine=engine)
    app.start()
    try:
        first = get_json(app.http_port, "/stats")["fleet"]
        up = time.monotonic() - t0
        wait_for(lambda: get_json(app.http_port, "/stats")["fleet"]
                 ["lifecycle"] == "serving", "the warm boot", 300)
        stats = get_json(app.http_port, "/stats")
        boot = boot_line(engine, "warm boot", card)
        log(f"warm boot: /stats {first['lifecycle']} {up:.2f}s after the "
            f"build began, then {stats['fleet']['lifecycle']} with "
            f"warm_boot_s {stats['fleet'].get('warm_boot_s')}; pages "
            f"pre-warmed {engine.prewarmed_pages}, host tier "
            f"{stats['kv_tier']['pages']} pages [{card}]")
        trail = [(t["from"], t["to"])
                 for t in engine.lifecycle.snapshot()["trail"]]
        require(trail == [("warming", "serving")]
                and (first["lifecycle"] == "warming"
                     and "warm_boot_s" not in first
                     or engine.warmup_seconds < 1.0),
                f"warm boot: /stats did not say warming first ({first}, "
                f"the lifecycle's trail {trail})")
        require(stats["fleet"].get("warm_boot_s") is not None
                and engine.prewarmed_pages >= 3,
                "warm boot: no warm_boot_s, or the system pages were not "
                "pre-warmed")
        zero_counts(engine)
        hits0 = engine.kv_tier.stats()["hits"]
        got = engine.generate(probe, max_new_tokens=TIER_TOKENS)
        wait_idle(engine)
        hits = engine.kv_tier.stats()["hits"] - hits0
        log(f"warm boot: the first request on the system prompt: host tier "
            f"hits {hits}, restored {engine._kv_restored}, full waves "
            f"{engine.prefill_dispatches}, tail-only waves "
            f"{engine.prefix_dispatches}; equal to the peer's unspilled run: "
            f"{got == ref} [{card}]")
        require(hits >= 3 and engine._kv_restored >= 3
                and engine.prefill_dispatches == 0,
                "warm boot: the first request did not hit the pre-warmed "
                "pages")
        require(got == ref, "warm boot: the stream left the peer's")
        require(engine.executor.captures == boot,
                "warm boot: a graph was captured after the boot")
    finally:
        app.shutdown()
    del engine
    torch.cuda.empty_cache()


PAIR_CHARS = [150, 180, 200, 220, 240, 130, 160]
PAIR_PLAIN_CHARS = 250
PAIR_SEED = 8000         # prompt seeds no other phase uses
PAIR_TOKENS = 32


def pair_traffic(app, engine, tok, prompts, plain_prompt) -> dict:
    """7 streams and 1 non-streaming request through /generate, admitted
    in one round on `engine` (the front engine: the prefill pool of a
    pair); returns the client records, the wall and the token ids."""
    out: dict = {}
    threads = [threading.Thread(target=stream_request,
                                args=(app.http_port, p, PAIR_TOKENS, out, i))
               for i, p in enumerate(prompts)]
    threads.append(threading.Thread(
        target=plain_request,
        args=(app.http_port, plain_prompt, PAIR_TOKENS // 2, out, "plain")))
    gate_admission(engine, len(threads))
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    require(all(not t.is_alive() for t in threads), "pair: requests hung")
    for i in range(len(prompts)):
        require(out[i]["status"] == 200
                and out[i]["done"]["tokens"] == PAIR_TOKENS,
                f"pair: stream {i} failed: {out[i]['status']}")
    require(out["plain"]["status"] == 201, f"pair: {out['plain']}")
    ids = [[tok._ch2id[c] for c in out[i]["text"]]
           for i in range(len(prompts))]
    return {"out": out, "wall": wall, "ids": ids,
            "plain": out["plain"]["data"]["text"]}


def pair_phase(params, cfg, dev, card: str) -> None:
    """13b, 13c. The disaggregated pair and migration over HTTP, at full
    width and depth. A colocated App (the main path, WARMUP=wide) serves
    the pair's traffic (7 streams + 1 non-streaming request through
    /generate, one admission round) as the reference run; then an App with
    DISAGG_MODE=both (a prefill twin over the SAME params tensors, sized
    from the card's free memory) serves it: every request handed off, no
    fallback, no prefill on the decode pool and no decode on the prefill
    pool, flash n_layers a wave on the prefill pool, the paged read
    n_layers a step on the decode pool, no capture after boot, each stream
    equal to the colocated one or at a tie (QOS_TIE_STEPS). Logged: client
    TTFT p50 and tok/s beside the colocated run's, the pair's card memory.
    Then migration over HTTP: 7 live greedy streams on the colocated App,
    POST /debug/drain with the pair's App as the peer: every session
    "shipped" (the pair's decode pool lands it through POST /migrate), the
    relay's first-token gap, streams equal to the undisturbed run or at a
    tie; last, a stream on the pair's decode pool drained with a refused
    peer degrades to "local_resume" and completes."""
    import torch

    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.tpu.migrate import Lifecycle, MigrationCoordinator

    env = dict(ELASTIC_ENV)
    L = cfg.n_layers
    col = build_engine(env, device=dev, params=params)
    col_boot = boot_line(col, "colocated", card)
    capp = build_app(env, engine=col)
    capp.start()
    papp = None
    try:
        tok = col.tokenizer
        prompts = [make_prompt(n, PAIR_SEED + i)
                   for i, n in enumerate(PAIR_CHARS)]
        plain_prompt = make_prompt(PAIR_PLAIN_CHARS, PAIR_SEED + 20)
        warm: dict = {}
        stream_request(capp.http_port, make_prompt(40, 99), 4, warm, "w")
        wait_idle(col)
        colo = pair_traffic(capp, col, tok, prompts, plain_prompt)
        wait_idle(col)
        cline = traffic_line("pair: colocated", colo["out"], len(prompts),
                             colo["wall"], card)
        mem0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        penv = {**env, "DISAGG_MODE": "both"}
        dec = build_engine(penv, device=dev, params=params)
        router = dec.disagg_router
        pre = router.prefill_engine
        dec_boot = boot_line(dec, "pair decode pool", card)
        pre_boot = boot_line(pre, "pair prefill pool", card)
        papp = build_app(penv, engine=dec)
        papp.start()
        if dev.type == "cuda":
            log(f"pair: card memory {torch.cuda.memory_allocated() / 2**30:.2f}"
                f" GiB allocated ({(torch.cuda.memory_allocated() - mem0) / 2**30:.2f}"
                f" GiB for the pair over the colocated App's), "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
                f"graph pools decode {dec.graph_pool_bytes / 2**30:.3f} / "
                f"prefill {pre.graph_pool_bytes / 2**30:.3f} GiB; one params "
                f"tree: {pre.params is dec.params}; prefill plan: "
                f"{pre.plan.summary() if pre.plan else None} [{card}]")
        require(pre.params is dec.params, "pair: the twin copied the params")
        stream_request(papp.http_port, make_prompt(40, 98), 4, warm, "p")
        wait_idle(dec)
        for e in (pre, dec):
            zero_counts(e)
        h0, f0 = pre.handoffs_total, router.fallbacks_total
        pair = pair_traffic(papp, pre, tok, prompts, plain_prompt)
        wait_idle(dec)
        wait_idle(pre)
        launches = launch_counts.counts()
        pline = traffic_line("pair: disaggregated", pair["out"],
                             len(prompts), pair["wall"], card)
        fallbacks = (router.fallbacks_total - f0 + pre.handoff_fallbacks_total
                     + dec.handoff_fallbacks_total)
        log(f"pair: handoffs {pre.handoffs_total - h0}, fallbacks "
            f"{fallbacks}, consumed {router.coordinator.consumed_total}; "
            f"prefill pool: waves {pre.prefill_dispatches} full / "
            f"{pre.prefix_dispatches} tail, decode steps {pre.decode_steps}; "
            f"decode pool: waves {dec.prefill_dispatches} / "
            f"{dec.prefix_dispatches}, decode steps {dec.decode_steps}; "
            f"launches {launches} (n_layers={L}); graphs captured after boot "
            f"{dec.executor.captures - dec_boot} / "
            f"{pre.executor.captures - pre_boot} [{card}]")
        log(f"pair: client TTFT p50 {pline['ttft_p50']:.1f} ms vs colocated "
            f"{cline['ttft_p50']:.1f} ms; decode tok/s per stream p50 "
            f"{pline['tps_p50']:.1f} vs {cline['tps_p50']:.1f} [{card}]")
        require(pre.handoffs_total - h0 == len(prompts) + 1 and fallbacks == 0,
                "pair: not every request handed off, or a fallback")
        require(dec.prefill_dispatches == dec.prefix_dispatches == 0
                and pre.decode_steps == 0,
                "pair: the decode pool prefilled or the prefill pool decoded")
        require(dec.executor.captures == dec_boot
                and pre.executor.captures == pre_boot,
                "pair: a graph was captured after boot")
        if dev.type == "cuda":
            require(launches["flash_attention"] == L * pre.prefill_dispatches
                    and launches["paged_attention"] == L * dec.decode_steps,
                    f"pair: launches {launches}")
        require(pair["plain"] == colo["plain"],
                "pair: the non-streaming request left the colocated one")
        ids = [tok.encode(p) for p in prompts]
        matched = check_ties(dec, "pair", ids, pair["ids"], colo["ids"])
        log(f"pair: {matched} of {len(prompts)} streams equal the colocated "
            f"run token for token [{card}]")
        # -- migration over HTTP: the colocated App drains into the pair
        mids = [tok.encode(make_prompt(n, MIGRATE_SEED + 50 + i))
                for i, n in enumerate(MIGRATE_HTTP_CHARS)]
        with col._state_lock:
            drop_prefix(col)
        ref = migrate_streams(col, mids, MIGRATE_HTTP_TOKENS)["out"]
        with col._state_lock:
            drop_prefix(col)
        m0 = col.migrations_total
        c_col, c_dec = col.executor.captures, dec.executor.captures
        reqs: list = []
        sync = col._sync_oldest
        state: dict = {}

        def armed_sync():
            sync()
            if (reqs and "t" not in state
                    and min(len(r.emitted) for r in reqs) >= MIGRATE_AT):
                state["t"] = time.monotonic()
                threading.Thread(target=lambda: state.setdefault(
                    "drain", post_json(
                        capp.http_port, "/debug/drain",
                        {"peers": [f"http://127.0.0.1:{papp.http_port}"],
                         "timeout_s": 60}))).start()
        col._sync_oldest = armed_sync
        try:
            gate_admission(col, len(mids))
            reqs.extend(col.submit(x, max_new_tokens=MIGRATE_HTTP_TOKENS)
                        for x in mids)
            got = [r.result(timeout_s=300) for r in reqs]
        finally:
            col.__dict__.pop("_sync_oldest", None)
        wait_for(lambda: get_json(capp.http_port, "/debug/drain")["drained"],
                 "the colocated App's drain", 120)
        status = get_json(capp.http_port, "/debug/drain")
        gaps = sorted(s["gap_s"] for s in status["sessions"]
                      if s["gap_s"] is not None)
        log(f"migrate http: POST /debug/drain at {MIGRATE_AT} delivered "
            f"tokens: outcomes {status['outcomes']}, migrations "
            f"{col.migrations_total - m0}; the relay's first-token gap "
            f"p50 {gaps[len(gaps) // 2] * 1e3 if gaps else math.nan:.1f} "
            f"max {gaps[-1] * 1e3 if gaps else math.nan:.1f} ms; the peer's "
            f"fallbacks {dec.handoff_fallbacks_total}, prefills "
            f"{dec.prefill_dispatches + dec.prefix_dispatches} [{card}]")
        require(status["outcomes"]["shipped"] == len(mids)
                and col.migrations_total - m0 == len(mids),
                f"migrate http: not every session shipped: "
                f"{status['outcomes']}")
        require(dec.handoff_fallbacks_total == 0
                and dec.prefill_dispatches + dec.prefix_dispatches == 0,
                "migrate http: the peer recomputed a landed session")
        require(col.executor.captures == c_col
                and dec.executor.captures == c_dec,
                "migrate http: a graph was captured by the export or the "
                "landings")
        for i, toks in enumerate(got):
            require(len(toks) == MIGRATE_HTTP_TOKENS,
                    f"migrate http: stream {i} delivered {len(toks)}")
        matched = check_ties(col, "migrate http", mids, got, ref)
        log(f"migrate http: {matched} of {len(mids)} streams equal the "
            f"undisturbed run token for token across the hop [{card}]")
        # -- a refused peer: the pair's decode pool resumes the stream itself
        coord = MigrationCoordinator(
            dec, Lifecycle("serving"), ship_timeout_s=30.0,
            client_factory=lambda address: (_ for _ in ()).throw(
                OSError(f"connect refused: {address}")))
        n_long = MIGRATE_HTTP_TOKENS
        r = router.submit(mids[0], max_new_tokens=n_long)
        stream = r.stream(timeout_s=120)
        got = [next(stream)]
        wait_for(lambda: any(s.active for s in dec.slots),
                 "the stream on the decode pool", 60)
        coord.begin_drain(["http://127.0.0.1:9"], timeout_s=60.0)
        got.extend(stream)
        wait_for(lambda: coord.status()["drained"], "the refused drain", 120)
        outcomes = coord.status()["outcomes"]
        log(f"migrate http: a refused peer: outcomes {outcomes}, the stream "
            f"{len(got)} of {n_long} tokens [{card}]")
        require(outcomes["local_resume"] == 1 and outcomes["failed"] == 0
                and len(got) == n_long and r.error is None,
                "migrate http: the refused peer did not degrade to a local "
                "resume")
        # the local resume lands the exported pages on the pool that wrote
        # them: equal to the undisturbed run, or leaving it at a tie
        matched = check_ties(col, "migrate http refused", [mids[0]], [got],
                             [ref[0]])
        log(f"migrate http: a refused peer: {matched} of 1 stream equal to "
            f"the undisturbed run token for token [{card}]")
    finally:
        if papp is not None:
            papp.shutdown()
        capp.shutdown()
    torch.cuda.empty_cache()


def elastic_phase(params, cfg, dev, card: str) -> None:
    """Phase 13 (``--elastic``): 13a the KV tier (int8, then bf16 over a
    shared cold store), 13d the warm boot from the bf16 tier's App, 13b-c
    the pair and migration over HTTP."""
    import torch

    t0 = time.monotonic()
    tier_phase(params, cfg, dev, card, "int8")
    log(f"elastic: tier int8 {time.monotonic() - t0:.1f}s")
    t1 = time.monotonic()
    store = DictStore()
    peer, peer_engine, ref, probe = tier_phase(params, cfg, dev, card,
                                               "bf16", store=store)
    try:
        log(f"elastic: tier bf16 {time.monotonic() - t1:.1f}s")
        t1 = time.monotonic()
        # the peer's promoted system pages are what it advertises
        warm_boot_phase(params, cfg, dev, card, peer, peer_engine, store,
                        ref, probe)
        log(f"elastic: warm boot {time.monotonic() - t1:.1f}s")
    finally:
        peer.shutdown()
    del peer_engine
    torch.cuda.empty_cache()
    t1 = time.monotonic()
    pair_phase(params, cfg, dev, card)
    log(f"elastic: pair and migration {time.monotonic() - t1:.1f}s; phase 13 "
        f"{time.monotonic() - t0:.1f}s [{card}]")


# -- phase 14: training (--train, and the default run's short phase) ----------
# the on-card gradient check: FlashAttention's backward is the VJP of
# attention_reference recomputed from the same q, k, v, so its gradients and
# autograd's through the oracle come from one function on the same inputs;
# they are held to GRAD_RTOL of the largest reference gradient (the bit-equal
# share is logged). Its forward is the kernel, held to its plain version as
# every flash check is (check_agreement, per row).
GRAD_RTOL = 1e-3
# the 2-layer step with the kernel against the same step with the oracle:
# the two forwards differ only by the kernel's bf16 rounding of each
# attention output (one bf16 ulp, 2**-8 relative), so the mean loss over
# B*T positions within 1e-2 relative and the global gradient norm within
# 5e-2 relative
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_SEED = 11000       # token seeds no other phase uses
# the resumed run against the uninterrupted one: the same steps on the same
# state, run under torch.use_deterministic_algorithms (warn_only); any
# element may differ by at most one Adam step's sign flip, 2 * lr, and the
# bit-equal share is logged
RESUME_ATOL = 2 * 3e-4


def train_tokens(cfg, B: int, T: int, dev, seed: int):
    """(tokens [B, T], targets [B, T]) of one random sequence batch: the
    targets are the next tokens."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    seq = torch.randint(1, cfg.vocab_size, (B, T + 1), generator=gen,
                        device=dev)
    return seq[:, :-1], seq[:, 1:]


def grad_check(dev, card: str, B: int, T: int, H: int = 32, Hkv: int = 8,
               dh: int = 128) -> float:
    """FlashAttention's gradients on the card against torch.autograd.grad
    through attention_reference, causal, bf16, [B, T, H, dh] / Hkv; the
    forward against the plain version. Returns the backward's recompute ms
    (attention_reference's forward and VJP) at this shape."""
    import torch

    from gofr_tpu_torch.ops.flash_attention import (
        KERNEL_BLOCK_KV, attention_reference, flash_attention,
        flash_attention_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED + T)
    q, g = (_randn((B, T, H, dh), gen, dev) for _ in range(2))
    k, v = (_randn((B, T, Hkv, dh), gen, dev) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, True)
    require(out.grad_fn is not None, "flash output without grad_fn on the "
            "card")
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*ref_leaves, causal=True),
                               ref_leaves, g)
    check_agreement(f"flash fwd for the gradient B={B} T={T}", out.detach(
    ).transpose(1, 2), flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
        KERNEL_BLOCK_KV), per_row=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        equal = float((a == b).float().mean())
        ok = math.isfinite(err) and err <= GRAD_RTOL * scale
        log(f"check flash grad {name} B={B} T={T} H={H} Hkv={Hkv} dh={dh} "
            f"bf16: max_abs_err={err:.3e} max|ref|={scale:.3e} (tol "
            f"{GRAD_RTOL}*max|ref|) bit-equal share={equal:.6f} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"flash gradient {name} disagrees with the oracle's VJP")

    def recompute():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        torch.autograd.grad(attention_reference(qd, kd, vd, causal=True),
                            (qd, kd, vd), g)

    ms = time_events(recompute, 3)
    log(f"time flash backward (attention_reference recompute + VJP) B={B} "
        f"T={T}: ms={ms:.3f} per layer [{card}]")
    del q, k, v, g, leaves, ref_leaves, got, want, out
    torch.cuda.empty_cache()
    return ms


def _n_params(params) -> int:
    from gofr_tpu_torch import tree

    return sum(t.numel() for t in tree.leaves(params))


def train_flops(cfg, n_params: int, B: int, T: int) -> float:
    """6 * params * tokens plus the causal attention products, 3x their
    forward's 2 * B * H * T^2 * dh per layer: the model FLOPs of a step
    (remat's recompute is not counted)."""
    return (6.0 * n_params * B * T
            + 6.0 * B * cfg.n_heads * T * T * cfg.head_dim * cfg.n_layers)


def run_train(what: str, cfg, params, dev, card: str, B: int, T: int,
              steps: int, moe: bool = False, seed: int = TRAIN_SEED,
              optimizer=None) -> dict:
    """`steps` train steps on one repeated batch through make_train_step
    (remat on, the reference's AdamW unless `optimizer`), each timed by the
    host clock and CUDA events, its flash launches counted on the card
    (launch_counts, zeroed before the step) and required to be 2 per layer
    (the forward and remat's recompute); the loss must fall and grad_norm
    be finite and non-zero. Returns losses, grad norms, launches and the
    last step's figures."""
    import torch

    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.train import make_train_step

    if moe:
        from gofr_tpu_torch.models.moe import moe_llama_forward_nocache as fwd
    else:
        from gofr_tpu_torch.models.llama import llama_forward_nocache as fwd
    init, step = make_train_step(lambda p, t: fwd(p, cfg, t),
                                 optimizer=optimizer, has_aux_loss=moe)
    state = init(params)
    toks, tgts = train_tokens(cfg, B, T, dev, seed)
    n_params = _n_params(params)
    flops = train_flops(cfg, n_params, B, T)
    out = {"loss": [], "aux": [], "grad_norm": [], "launches": 0}
    flash = cfg.attn_impl == "flash"
    for i in range(steps):
        launch_counts.zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.monotonic()
        start.record()
        params, state, m = step(params, state, toks, tgts)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        card_ms = start.elapsed_time(end)
        n = launch_counts.counts()["flash_attention"]
        out["launches"] += n
        loss, aux, gn = (float(m[k]) for k in ("loss", "aux_loss",
                                                "grad_norm"))
        out["loss"].append(loss)
        out["aux"].append(aux)
        out["grad_norm"].append(gn)
        peak = torch.cuda.max_memory_allocated()
        out.update(wall_s=wall, card_ms=card_ms, peak=peak,
                   tok_s=B * T / wall, mfu=flops / (card_ms / 1e3)
                   / H100_BF16_FLOPS)
        log(f"train {what} step {i}: loss={loss:.5f} aux={aux:.5f} "
            f"grad_norm={gn:.5f} wall={wall * 1e3:.1f}ms card={card_ms:.1f}ms "
            f"tok/s={B * T / wall:.0f} MFU={out['mfu']:.4f} "
            f"peak_mem={peak / 2**30:.2f}GiB flash_launches={n} "
            f"[{cfg.n_layers} layers, B={B} T={T}, {n_params / 1e9:.3f}B "
            f"params; {card}]")
        if flash:
            require(n == 2 * cfg.n_layers,
                    f"train {what}: {n} flash launches in a step, want "
                    f"{2 * cfg.n_layers} (forward + remat recompute)")
        require(math.isfinite(gn) and gn > 0,
                f"train {what}: grad_norm {gn}")
        require(math.isfinite(loss) and math.isfinite(aux),
                f"train {what}: loss {loss} aux {aux}")
    if steps > 1:
        require(out["loss"][-1] < out["loss"][0],
                f"train {what}: the loss did not fall {out['loss']}")
    out.update(params=params, state=state, n_params=n_params, flops=flops)
    return out


def train_step_check(dev, card: str, B: int, T: int) -> None:
    """One step of a 2-layer full-width Llama with the kernel against the
    same step with the oracle (attn_impl="xla"), from the same weights:
    loss and grad_norm within TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              attn_impl="flash")
    got = run_train("2-layer flash", cfg, llama_init(cfg, 0, dev), dev,
                    card, B, T, 1)
    del got["params"], got["state"]
    torch.cuda.empty_cache()
    ocfg = dataclasses.replace(cfg, attn_impl="xla")
    want = run_train("2-layer oracle", ocfg, llama_init(ocfg, 0, dev), dev,
                     card, B, T, 1)
    del want["params"], want["state"]
    torch.cuda.empty_cache()
    dl = abs(got["loss"][0] - want["loss"][0]) / want["loss"][0]
    dg = abs(got["grad_norm"][0] - want["grad_norm"][0]) / want["grad_norm"][0]
    ok = dl <= TRAIN_LOSS_RTOL and dg <= TRAIN_GNORM_RTOL
    log(f"check train flash vs oracle (2 layers, B={B} T={T}): loss "
        f"{got['loss'][0]:.6f} vs {want['loss'][0]:.6f} (rel {dl:.2e}, tol "
        f"{TRAIN_LOSS_RTOL}), grad_norm {got['grad_norm'][0]:.6f} vs "
        f"{want['grad_norm'][0]:.6f} (rel {dg:.2e}, tol {TRAIN_GNORM_RTOL}) "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    require(ok, "train step with the flash kernel disagrees with the oracle")


def resume_check(dev, card: str, B: int, T: int, steps: int = 6,
                 at: int = 3) -> None:
    """A 2-layer full-width Llama trained `steps` steps straight through,
    and again with a checkpoint (gofr_tpu_torch.checkpoint) saved after
    `at` steps and restored into fresh tensors before the rest: the
    restored tensors equal the saved ones bit for bit, and the final
    parameters equal the uninterrupted run's within RESUME_ATOL (both under
    torch.use_deterministic_algorithms(warn_only=True); the bit-equal share
    is logged)."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    import torch

    from gofr_tpu_torch import tree
    from gofr_tpu_torch.checkpoint import CheckpointManager
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.train import make_train_step

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              attn_impl="flash")
    from gofr_tpu_torch.models.llama import llama_forward_nocache

    init, step = make_train_step(
        lambda p, t: llama_forward_nocache(p, cfg, t))
    toks, tgts = train_tokens(cfg, B, T, dev, TRAIN_SEED + 1)
    root = tempfile.mkdtemp(prefix="gofr-resume-")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = llama_init(cfg, 0, dev)
            state = init(ref)
            for _ in range(steps):
                ref, state, _ = step(ref, state, toks, tgts)
            del state
            params = llama_init(cfg, 0, dev)
            state = init(params)
            for _ in range(at):
                params, state, _ = step(params, state, toks, tgts)
            mgr = CheckpointManager(root)
            t0 = time.monotonic()
            mgr.save(at, {"params": params, "opt": state})
            save_s = time.monotonic() - t0
            fresh = tree.tree_map(torch.empty_like, {"params": params,
                                                     "opt": state})
            t0 = time.monotonic()
            restored = mgr.restore(like=fresh)
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            same = all(torch.equal(a, b) for a, b in zip(
                tree.leaves(restored), tree.leaves({"params": params,
                                                    "opt": state})))
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree.leaves(restored))
            del params, state, fresh
            params, state = restored["params"], restored["opt"]
            del restored
            for _ in range(steps - at):
                params, state, _ = step(params, state, toks, tgts)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    worst, equal, n = 0.0, 0, 0
    for a, b in zip(tree.leaves(params), tree.leaves(ref)):
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        equal += int((a == b).sum())
        n += a.numel()
    log(f"check resume (2 layers, B={B} T={T}, saved at step {at} of "
        f"{steps}): restored bit-equal={same}, {nbytes / 1e9:.2f} GB saved in "
        f"{save_s:.1f}s, restored in {load_s:.1f}s; final params max_abs_diff="
        f"{worst:.3e} (tol {RESUME_ATOL}) bit-equal share={equal / n:.6f} "
        f"[{card}]")
    require(same, "resume: a restored tensor differs from the saved one")
    require(worst <= RESUME_ATOL, "resume: the resumed run left the "
            "uninterrupted one")
    del params, state, ref
    torch.cuda.empty_cache()


def time_update(optimizer, params, state, card: str, what: str) -> float:
    """ms of one optimizer update (its moments as the gradients) and its
    application, by CUDA events; nothing is kept."""
    import torch

    from gofr_tpu_torch import tree

    def once():
        updates, _ = optimizer.update(state.mu, state, params)
        for p, u in zip(tree.leaves(params), tree.leaves(updates)):
            torch.add(p, u)

    ms = time_events(once, 2)
    log(f"time optimizer update ({what}): ms={ms:.2f} [{card}]")
    torch.cuda.empty_cache()
    return ms


# --train: Llama-3-8B at full width and TRAIN_DEPTH of its 32 layers, B=2,
# T=2048, ATTN_IMPL=flash, remat on, TRAIN_STEPS steps on one batch
TRAIN_DEPTH = 8
TRAIN_STEPS = 6


def train_phase(dev, card: str) -> int:
    """--train: the gradient check at [1, 2048], Llama-3-8B at TRAIN_DEPTH
    layers (B=2, T=2048, 6 steps), the optimizer update's time, flash's own
    times at [2, 2048], the 2-layer flash-vs-oracle step, the checkpoint
    resume, then the MoE at Llama-3-8B widths (2 layers, 8 experts, top-2,
    B=1, T=1024). Returns the flash launches of the training runs."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.models.moe import MoELlamaConfig, moe_llama_init
    from gofr_tpu_torch.train import adamw

    grad_check(dev, card, 1, 2048)
    recompute_ms = grad_check(dev, card, 2, 2048)
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=TRAIN_DEPTH,
                              attn_impl="flash")
    t0 = time.monotonic()
    params = llama_init(cfg, 0, dev)
    torch.cuda.synchronize()
    log(f"train llama3-8b: {TRAIN_DEPTH} of 32 layers, "
        f"{_n_params(params) / 1e9:.3f}B params bf16, init "
        f"{time.monotonic() - t0:.1f}s")
    opt = adamw(3e-4, weight_decay=0.01, b1=0.9, b2=0.95)
    run = run_train(f"llama3-8b {TRAIN_DEPTH}L", cfg, params, dev, card, 2,
                    2048, TRAIN_STEPS, optimizer=opt)
    launches = run["launches"]
    update_ms = time_update(opt, run["params"], run["state"], card,
                            f"llama3-8b {TRAIN_DEPTH}L")
    log(f"train summary llama3-8b {TRAIN_DEPTH}L B=2 T=2048: last step "
        f"wall={run['wall_s'] * 1e3:.1f}ms card={run['card_ms']:.1f}ms "
        f"tok/s={run['tok_s']:.0f} MFU={run['mfu']:.4f} (6*params*tokens + "
        f"causal attention over the card ms at {H100_BF16_FLOPS:.3g}) "
        f"peak_mem={run['peak'] / 2**30:.2f}GiB update={update_ms:.2f}ms "
        f"attention backward recompute={recompute_ms:.3f}ms/layer "
        f"(x{TRAIN_DEPTH}) loss {run['loss'][0]:.4f} -> {run['loss'][-1]:.4f} "
        f"[{card}]")
    del run, params
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    log_flash_time(2, 2048, time_flash(dev, 2, 2048, True, 10, flush), card)
    del flush
    torch.cuda.empty_cache()
    train_step_check(dev, card, 2, 2048)
    resume_check(dev, card, 1, 512)
    # the MoE defaults are Llama-3-8B's widths with 8 experts, top-2
    mcfg = dataclasses.replace(MoELlamaConfig(), n_layers=2,
                               attn_impl="flash")
    mparams = moe_llama_init(mcfg, 0, dev)
    log(f"train moe: llama3-8b widths, 2 layers, {mcfg.n_experts} experts "
        f"top-{mcfg.experts_per_token}, {_n_params(mparams) / 1e9:.3f}B params "
        f"bf16")
    mrun = run_train("moe 2L", mcfg, mparams, dev, card, 1, 1024, 4,
                     moe=True)
    launches += mrun["launches"]
    log(f"train summary moe 2L B=1 T=1024: last step wall="
        f"{mrun['wall_s'] * 1e3:.1f}ms card={mrun['card_ms']:.1f}ms tok/s="
        f"{mrun['tok_s']:.0f} MFU={mrun['mfu']:.4f} (dense dispatch: every "
        f"expert computes every token, counted) peak_mem="
        f"{mrun['peak'] / 2**30:.2f}GiB aux {mrun['aux'][0]:.4f} -> "
        f"{mrun['aux'][-1]:.4f} loss {mrun['loss'][0]:.4f} -> "
        f"{mrun['loss'][-1]:.4f} [{card}]")
    del mrun, mparams
    torch.cuda.empty_cache()
    return launches


# -- phase 15: the batcher servers (--models, and the default short phase) ---
# a batched answer against the same example's unbatched forward on the card:
# MNIST in f32 (TF32 off), the served probs rounded to 4 places; BERT in
# bf16 over 12 layers, where a batch of another shape takes other GEMM
# kernels, whose bf16 roundings move a unit embedding's elements (~0.036
# rms at D=768) by up to ~1e-3: BERT_TOL absolute per element and cosine
# similarity at least BERT_COS
MNIST_TOL = 1.5e-4           # 4-place rounding of the probs + 1e-4
BERT_TOL = 1e-2
BERT_COS = 0.999
MODELS_SEED = 12000      # input seeds no other phase uses


def models_texts(n: int, seed: int, max_chars: int):
    """n texts of mixed lengths, 1..max_chars characters."""
    import random

    rnd = random.Random(seed)
    return [make_prompt(rnd.randint(1, max_chars), seed + i)
            for i in range(n)]


def _timed_post(port, path, body, out, key):
    t0 = time.monotonic()
    status, _, data = post_json(port, path, body)
    out[key] = (status, data, time.monotonic() - t0)


def _burst(port, path, bodies) -> list:
    out = {}
    threads = [threading.Thread(target=_timed_post,
                                args=(port, path, b, out, i))
               for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    require(len(out) == len(bodies), f"{path}: {len(bodies) - len(out)} "
            f"requests never answered")
    return [out[i] for i in range(len(bodies))]


def _lat(recs) -> str:
    lat = sorted(r[2] for r in recs)
    p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3  # noqa: E731
    return f"p50={p(0.5):.1f}ms p99={p(0.99):.1f}ms"


def warm_all(batcher, example_len: int = None) -> int:
    """Capture every (batch bucket, sequence bucket) program the batcher can
    reach, beside the server's own warm-up."""
    import numpy as np

    captured = 0
    seqs = batcher.seq_buckets if batcher.seq_axis is not None else [None]
    for s in seqs:
        example = (np.zeros((s,), dtype=np.int32) if s is not None
                   else np.zeros((example_len,), dtype=np.float32))
        captured += batcher.warmup(batcher.batch_buckets, example)
    return captured


def models_phase(dev, card: str, n: int, bert_preset: str) -> None:
    """serve_mnist and serve_bert (BERT_PRESET=bert_preset) booted on the
    card, every program they can reach captured, then `n` concurrent
    /predict bodies and `n` /embed texts of mixed lengths: each answer
    against the same example's unbatched forward on the card, embeddings of
    unit norm, a text embedded alone and padded into the largest bucket
    alike, batches larger than 1 formed, no capture after the warm-up."""
    import numpy as np
    import torch

    from gofr_tpu_torch import serve_bert, serve_mnist
    from gofr_tpu_torch.models.bert import bert_embed
    from gofr_tpu_torch.models.mlp import mlp_forward

    env = {**QUIET, "HTTP_PORT": "0", "METRICS_PORT": "0",
           "REQUEST_TIMEOUT": "120", **grpc_env()}
    t0 = time.monotonic()
    mnist = serve_mnist.build_app(env, device=dev)
    boot = mnist.batcher.executor.captures
    extra = warm_all(mnist.batcher, 784)
    mnist.start()
    log(f"models mnist: boot {time.monotonic() - t0:.1f}s, {boot} programs "
        f"captured at boot (the reference's sizes 1, 8, 64), {extra} more "
        f"warmed by the smoke")
    try:
        captured = mnist.batcher.executor.captures
        rng = np.random.default_rng(MODELS_SEED)
        images = rng.random((n, 784), dtype=np.float32)
        t1 = time.monotonic()
        recs = _burst(mnist.http_port, "/predict",
                      [{"image": img.tolist()} for img in images])
        wall = time.monotonic() - t1
        worst = 0.0
        with torch.no_grad():
            for (status, body, _), img in zip(recs, images):
                require(status == 201, f"/predict: {status} {body}")
                logits = mlp_forward(mnist.params, torch.from_numpy(
                    img[None]).to(dev))[0].cpu().numpy()
                probs = np.exp(logits - logits.max())
                probs /= probs.sum()
                worst = max(worst, float(np.abs(
                    np.asarray(body["data"]["probs"]) - probs).max()))
                top2 = np.sort(logits)[-2:]
                require(body["data"]["digit"] == int(np.argmax(logits))
                        or top2[1] - top2[0] < 1e-4,
                        "/predict digit differs from the unbatched forward")
        batches = dict(mnist.batcher.batches)
        largest = max(int(k.split("-")[-1].split("x")[0]) for k in batches)
        log(f"models mnist: {n} concurrent /predict in {wall:.2f}s, client "
            f"{_lat(recs)}; batches by program {json.dumps(batches)}; probs "
            f"vs the unbatched forward max_abs_diff={worst:.2e} (tol "
            f"{MNIST_TOL}); captures after warm-up="
            f"{mnist.batcher.executor.captures - captured} [{card}]")
        require(worst <= MNIST_TOL, "/predict differs from the unbatched "
                "forward")
        require(largest > 1, "/predict: no batch larger than 1 formed")
        require(mnist.batcher.executor.captures == captured,
                "/predict: a program was captured after warm-up")
    finally:
        mnist.shutdown()

    t0 = time.monotonic()
    bert = serve_bert.build_app({**env, "BERT_PRESET": bert_preset},
                                device=dev)
    extra = warm_all(bert.batcher)
    bert.start()
    cfg = bert.bert_cfg
    log(f"models bert-embed: BERT_PRESET={bert_preset} ({cfg.dim} wide, "
        f"{cfg.n_layers} layers, {cfg.dtype}), boot + warm-up "
        f"{time.monotonic() - t0:.1f}s, {extra} programs captured by the "
        f"smoke (the reference warms none)")
    try:
        captured = bert.batcher.executor.captures
        max_len = bert.batcher.seq_buckets[-1]
        texts = models_texts(n, MODELS_SEED, max_len)
        t1 = time.monotonic()
        recs = _burst(bert.http_port, "/embed", [{"text": t} for t in texts])
        wall = time.monotonic() - t1
        worst, cos_min, norm_err = 0.0, 1.0, 0.0
        with torch.no_grad():
            for (status, body, _), text in zip(recs, texts):
                require(status == 201, f"/embed: {status} {body}")
                got = np.asarray(body["data"]["embedding"])
                ids = torch.tensor([[b + 1 for b in text.encode()][:max_len]],
                                   device=dev)
                want = bert_embed(bert.params, cfg, ids)[0].cpu().numpy()
                worst = max(worst, float(np.abs(got - want).max()))
                cos_min = min(cos_min, float(got @ want / np.linalg.norm(got)
                                             / np.linalg.norm(want)))
                norm_err = max(norm_err, abs(float(np.linalg.norm(got)) - 1))
            # padding invariance: a short text alone and padded into the
            # largest bucket
            ids = [b + 1 for b in texts[0].encode()][:8]
            padded = torch.zeros((1, max_len), dtype=torch.int64, device=dev)
            padded[0, :len(ids)] = torch.tensor(ids, device=dev)
            alone = bert_embed(bert.params, cfg, torch.tensor([ids],
                                                              device=dev))
            pad_err = float((bert_embed(bert.params, cfg, padded)
                             - alone).abs().max())
        batches = dict(bert.batcher.batches)
        largest = max(int(k.split("-")[-1].split("x")[0]) for k in batches)
        log(f"models bert-embed: {n} concurrent /embed in {wall:.2f}s, client "
            f"{_lat(recs)}; batches by program {json.dumps(batches)}; vs the "
            f"unbatched forward max_abs_diff={worst:.2e} (tol {BERT_TOL}) "
            f"min cosine={cos_min:.6f} (tol {BERT_COS}); | |e| - 1 | max="
            f"{norm_err:.2e}; padded to {max_len} vs alone max_abs_diff="
            f"{pad_err:.2e}; captures after warm-up="
            f"{bert.batcher.executor.captures - captured} [{card}]")
        require(worst <= BERT_TOL and cos_min >= BERT_COS,
                "/embed differs from the unbatched forward")
        require(norm_err <= 1e-4, "/embed: an embedding is not unit norm")
        require(pad_err <= BERT_TOL, "/embed: padding moved an embedding")
        require(largest > 1, "/embed: no batch larger than 1 formed")
        require(bert.batcher.executor.captures == captured,
                "/embed: a program was captured after warm-up")
    finally:
        bert.shutdown()
    torch.cuda.empty_cache()


def short_train_models_phase(dev, card: str) -> int:
    """The default run's phase 14/15 in short: the gradient check at
    [1, 1024], 2 steps of a 2-layer full-width Llama with the launch check,
    8 /predict and 8 /embed on the debug presets. Returns the training
    flash launches."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init

    t0 = time.monotonic()
    grad_check(dev, card, 1, 1024)
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              attn_impl="flash")
    run = run_train("2L short", cfg, llama_init(cfg, 0, dev), dev, card, 1,
                    1024, 2)
    launches = run["launches"]
    del run
    torch.cuda.empty_cache()
    models_phase(dev, card, 8, "debug")
    log(f"train and models short phase: {time.monotonic() - t0:.1f}s")
    return launches


# -- phase 16: tensor and sequence parallelism (ROADMAP A14a) ----------------
PAR_DEPTH = 32           # --parallel's TP engine phase: Llama-3-8B whole
PAR_SEED = 13000         # prompt seeds no other phase uses
PAR_CHARS = (150, 180, 200, 220, 240, 130, 160, 170)
PAR_TOKENS = 48
# phase (c)'s per-rank (H, Hkv): Llama-3-8B (32/8) and Llama-3-70B (64/8)
# at tp = 2, 4 and 8, and Ulysses' G = 1 (KV heads repeated up to H / sp)
RANK_HEADS = (("8b", 2, 16, 4), ("8b", 4, 8, 2), ("8b", 8, 4, 1),
              ("70b", 2, 32, 4), ("70b", 4, 16, 2), ("70b", 8, 8, 1),
              ("ulysses-g1", 8, 4, 4), ("ulysses-g1", 4, 8, 8))
# the sp=1 forwards against the dense one: ring attends in f32 and the
# dense forward through flash, so the bf16 model tolerance applies
SP_TOL = MODEL_TOL


def join_world_of_one():
    """This process as rank 0 of a one-rank job (NCCL on cuda:0) through
    the JAX_* keys, and the all-axes mesh over it (tp = sp = 1)."""
    from gofr_tpu_torch.config import as_config
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh
    from gofr_tpu_torch.parallel.multihost import initialize_from_config

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    initialize_from_config(as_config({
        "JAX_COORDINATOR_ADDR": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0",
        "JAX_COORDINATOR_TIMEOUT_S": "60"}))
    mesh = make_mesh(MeshPlan())
    log(f"parallel: joined a one-rank NCCL job and built the 5-axis mesh "
        f"in {time.monotonic() - t0:.2f}s")
    return mesh


def par_prompts(tok, n: int):
    return [tok.encode(make_prompt(PAR_CHARS[i % len(PAR_CHARS)],
                                   PAR_SEED + i)) for i in range(n)]


def drive(eng, prompts, n_tok):
    """The prompts as one burst on an engine whose loop this thread plays;
    every request's tokens."""
    reqs = [eng.submit(p, max_new_tokens=n_tok, temperature=0.0)
            for p in prompts]
    deadline = time.monotonic() + 300
    while not all(r.finished_at is not None for r in reqs):
        require(time.monotonic() < deadline, "parallel: a burst never ended")
        eng._step()
    return [list(r.emitted) for r in reqs]


def step_card_ms(eng, prompts) -> dict:
    """The pipelined decode step at B=8 (decode_engine's recipe on this
    engine): the card's busy ms per decode step over 4 loop steps under
    torch.profiler, and its NCCL kernels per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=600)
    for _ in range(eng.pipeline_depth + 1):
        eng._step()
    ran = eng.decode_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _window(eng, 4)
    ran = eng.decode_steps - ran
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    out = {"busy_ms": sum(e.self_device_time_total for e in kernels)
           / 1e3 / ran,
           "nccl_kernels": sum(e.count for e in nccl) / ran,
           "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3 / ran,
           "steps": ran}
    eng.stop()
    return out


def tp_engine_phase(params, cfg, dev, card: str, mesh, depth: int,
                    n_req: int = 8, n_tok: int = PAR_TOKENS,
                    profile_steps: bool = True) -> dict:
    """(a) The paged engine on a one-rank NCCL mesh (tp=1: the TP path,
    its all-reduces and vocab all-gather inside the captured graphs) and
    the engine without a mesh, on the same weights at `depth` layers:
    WARMUP=wide's captures at boot, one greedy burst of n_req prompts with
    no capture after boot, flash and the paged read launched, the streams
    equal token for token; the collectives per decode step (the host calls
    while one decode step runs eagerly, which a graph replays), and the
    decode step's card ms on both."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_decode_step_paged
    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.parallel import collectives
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    t_phase = time.monotonic()
    cut = cut_tree(params, depth)
    c = dataclasses.replace(cfg, n_layers=depth, attn_impl="flash")
    prompts = par_prompts(DebugTokenizer(cfg.vocab_size), n_req)
    out = {}
    for name, m in (("no mesh", None), ("tp=1 NCCL mesh", mesh)):
        eng = PagedLLMEngine(cut, c, device=dev, n_slots=8,
                             max_seq_len=1024, prefill_buckets=(128, 256),
                             page_size=128, prefix_cache=False, mesh=m)
        t0 = time.monotonic()
        eng.warmup(k_variants=True)
        boot = eng.executor.captures
        warm_s = time.monotonic() - t0
        launch_counts.zero()
        streams = drive(eng, prompts, n_tok)
        launches = launch_counts.counts()
        require(eng.executor.captures == boot,
                f"parallel {name}: a graph was captured after boot")
        require(launches["flash_attention"] > 0
                and launches["paged_attention"] > 0,
                f"parallel {name}: flash or the paged read not launched "
                f"({launches})")
        with torch.no_grad(), collectives.counting() as calls:
            B = 8
            table = torch.zeros((B, 2), dtype=torch.int32, device=dev)
            llama_decode_step_paged(
                eng.params, eng.cfg,
                torch.zeros(B, dtype=torch.long, device=dev),
                torch.zeros(B, dtype=torch.long, device=dev),
                eng.k_cache, eng.v_cache, table)
            torch.cuda.synchronize()
        per_step = dict(calls)
        if m is not None:
            require(per_step.get("all_reduce") == 2 * depth
                    and per_step.get("all_gather") == 1,
                    f"parallel {name}: collectives per decode step "
                    f"{per_step}, want {2 * depth} all-reduces and 1 "
                    f"all-gather")
        step = (step_card_ms(eng, prompts) if profile_steps else None)
        if not profile_steps:
            eng.stop()
        out[name] = {"streams": streams, "launches": launches,
                     "warm_s": warm_s, "graphs": boot, "calls": per_step,
                     "step": step}
        cut_note = (f"{depth} of 32 layers (cut for time)" if depth < 32
                    else "all 32 layers")
        log(f"parallel {name}: Llama-3-8B width, {cut_note}, paged bf16: "
            f"{boot} graphs captured at boot in "
            f"{warm_s:.2f}s, none after; burst of {n_req} x {n_tok} tokens; "
            f"launches flash {launches['flash_attention']} paged "
            f"{launches['paged_attention']}; collectives per decode step "
            f"{per_step or 'none'}"
            + (f"; decode step at B=8 card busy {step['busy_ms']:.4f} ms "
               f"(NCCL kernels {step['nccl_kernels']:.1f} per step, "
               f"{step['nccl_ms']:.4f} ms)" if step else "")
            + f" [{card}]")
        del eng
        torch.cuda.empty_cache()
    same = out["no mesh"]["streams"] == out["tp=1 NCCL mesh"]["streams"]
    require(same, "parallel: the tp=1 mesh engine's greedy streams differ "
            "from the engine without a mesh")
    log(f"parallel tp=1: {n_req} greedy streams equal token for token to "
        f"the engine without a mesh; phase {time.monotonic() - t_phase:.1f}s "
        f"[{card}]")
    return out


def par_follower(port: int, depth: int, result) -> None:
    """Phase (b)'s second process: rank 1's engine on the same card, the
    same weights (llama_init seed 0 at `depth` layers), replaying rank 0's
    waves from the TCPStore at `port`; puts its shadow streams (id ->
    tokens) on `result`."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.tpu.admission import AdmissionPlane, StoreKV
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    try:
        dev = torch.device("cuda", 0)
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=depth,
                                  attn_impl="flash")
        params = llama_init(cfg, seed=0, device=dev)
        store = dist.TCPStore("127.0.0.1", port, 2, is_master=False,
                              wait_for_workers=False)
        plane = AdmissionPlane(process_id=1, kv=StoreKV(store))
        shadows = []
        plane.on_shadow = shadows.append
        eng = PagedLLMEngine(params, cfg, device=dev, n_slots=8,
                             max_seq_len=1024, prefill_buckets=(128, 256),
                             page_size=128, prefix_cache=False,
                             admission_plane=plane)
        eng.warmup(k_variants=True)
        store.set("par/follower_ready", "1")
        eng.start()
        deadline = time.monotonic() + 600
        while not plane.closed and time.monotonic() < deadline:
            time.sleep(0.05)
        eng.stop()
        result.put({"shadows": {s.id: list(s.emitted) for s in shadows},
                    "errors": sum(s.error is not None for s in shadows),
                    "closed": plane.closed})
    except BaseException as exc:  # noqa: BLE001 - reported to rank 0
        import traceback

        result.put({"error": f"{exc!r}\n{traceback.format_exc()}"})


def follower_phase(dev, card: str, depth: int) -> None:
    """(b) Two processes on the card, each with its own engine (no tp
    group: they share only a TCPStore): rank 0 is the HTTP ingress, rank 1
    replays its admission waves. Staggered streaming arrivals and one
    client that disconnects mid-stream (a cancel); rank 1's streams must
    equal rank 0's token for token, the cancelled one cut at the same
    token."""
    import dataclasses
    import multiprocessing as mp
    import threading

    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serve import build_app
    from gofr_tpu_torch.tpu.admission import AdmissionPlane, StoreKV
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    t_phase = time.monotonic()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=depth,
                              attn_impl="flash")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 2, is_master=True,
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    proc = ctx.Process(target=par_follower, args=(port, depth, result),
                       daemon=True)
    proc.start()
    app = None
    try:
        params = llama_init(cfg, seed=0, device=dev)
        plane = AdmissionPlane(process_id=0, kv=StoreKV(store))
        eng = PagedLLMEngine(params, cfg, device=dev, n_slots=8,
                             max_seq_len=1024, prefill_buckets=(128, 256),
                             page_size=128, prefix_cache=False,
                             admission_plane=plane)
        eng.warmup(k_variants=True)
        from gofr_tpu_torch.models.tokenizer import DebugTokenizer

        eng.tokenizer = DebugTokenizer(cfg.vocab_size)
        requests = []
        submit = eng.submit

        def recording_submit(*a, **kw):
            r = submit(*a, **kw)
            requests.append(r)
            return r

        eng.submit = recording_submit
        store.wait(["par/follower_ready"])
        eng.start()
        app = build_app({**QUIET, "HTTP_PORT": "0", "METRICS_PORT": "0"},
                        engine=eng)
        app.start()
        http_port = app.http_port
        replies = {}

        def cut_short(prompt, key, after):
            conn = http.client.HTTPConnection("127.0.0.1", http_port,
                                              timeout=600)
            conn.request("POST", "/generate", body=json.dumps(
                {"prompt": prompt, "max_tokens": 200, "stream": True}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            n = 0
            while n < after:
                line = resp.readline()
                if not line:
                    break
                n += line.startswith(b"data: ")
            conn.close()   # the client leaves: the stream's cancel
            replies[key] = {"events": n}

        threads = []
        for i in range(6):
            prompt = make_prompt(PAR_CHARS[i], PAR_SEED + 100 + i)
            if i == 3:
                t = threading.Thread(target=cut_short,
                                     args=(prompt, i, 8))
            else:
                t = threading.Thread(target=stream_request,
                                     args=(http_port, prompt, PAR_TOKENS,
                                           replies, i))
            t.start()
            threads.append(t)
            time.sleep(0.15)   # staggered: the arrivals span many waves
        for t in threads:
            t.join(timeout=300)
        deadline = time.monotonic() + 120
        while not all(r.finished_at is not None for r in requests):
            require(time.monotonic() < deadline,
                    "parallel follower: a leader stream never finished")
            time.sleep(0.05)
        app.shutdown()   # the engine's stop publishes the stop sentinel
        app = None
        got = result.get(timeout=300)
        require("error" not in got, f"parallel follower: rank 1 failed: "
                f"{got.get('error')}")
        leader = {r.id: list(r.emitted) for r in requests}
        require(got["shadows"] == leader,
                "parallel follower: rank 1's streams differ from rank 0's")
        victim = requests[3]
        require(victim.cancelled.is_set() and len(victim.emitted) < 200,
                "parallel follower: the disconnected stream was not "
                "cancelled")
        log(f"parallel follower: 2 processes on one card, rank 0 the HTTP "
            f"ingress, rank 1 replaying its waves ({plane._seq} waves): "
            f"{len(leader)} streams equal token for token, the one "
            f"cancelled mid-stream cut at {len(victim.emitted)} tokens on "
            f"both; {depth} layers; phase {time.monotonic() - t_phase:.1f}s "
            f"[{card}]")
    finally:
        if app is not None:
            app.shutdown()
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
        del store
        torch.cuda.empty_cache()


def rank_kernels_phase(dev, card: str) -> list:
    """(c) flash, the paged reads and the dense reads, bf16 and int8, at the
    heads one rank holds (RANK_HEADS), each against its plain version on
    the same inputs, its launches counted, with its time (CUDA events),
    its plain version's and its bound."""
    import torch

    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     quantize_kv)
    from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                    flash_attention_cuda,
                                                    flash_attention_plain)
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda,
                                                    paged_attention_reference)

    rows = []
    ctx = [150 + 24 * i for i in range(8)]   # mid-decode contexts at B=8
    for model, n, H, Hkv in RANK_HEADS:
        what = f"{model} {'sp' if model.startswith('ulysses') else 'tp'}={n}"
        launch_counts.zero()
        q, k, v = flash_inputs(4, H, Hkv, 256, 256, 128, dev, seed=H + Hkv)
        err = check_agreement(f"rank flash {what} H={H} Hkv={Hkv} [4, 256]",
                              flash_attention_cuda(q, k, v, True),
                              flash_attention_plain(q, k, v, True,
                                                    KERNEL_BLOCK_KV),
                              per_row=True)
        ms = time_events(lambda: flash_attention_cuda(q, k, v, True), 20)
        plain = time_events(lambda: flash_attention_plain(
            q, k, v, True, KERNEL_BLOCK_KV), 5)
        bound, by = flash_bound(4, H, Hkv, 256, 256, 128, True)
        rows.append(("flash_attention", what, H, Hkv, err, ms, plain, bound,
                     by))
        if model.startswith("ulysses"):
            require(launch_counts.counts()["flash_attention"] > 0,
                    f"rank {what}: flash not launched")
            continue
        qd, kp, vp, table, lens = paged_inputs(ctx, H, Hkv, 128, 128, dev,
                                               seed=H * Hkv)
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
        _, kd, vd, dlens = dense_inputs(ctx, H, Hkv, 128, 1024, dev,
                                        seed=H * Hkv + 1)
        (dk8, dks), (dv8, dvs) = quantize_kv(kd), quantize_kv(vd)
        cases = (
            ("paged_attention",
             lambda: paged_attention_cuda(qd, kp, vp, table, lens),
             lambda: paged_attention_reference(qd, kp, vp, table, lens),
             paged_bound(ctx, H, Hkv, 128, 128)),
            ("paged_attention_q8",
             lambda: paged_attention_q8_cuda(qd, k8, v8, ks, vs, table, lens),
             lambda: paged_attention_plain(qd, k8, v8, table, lens, ks, vs),
             paged_bound(ctx, H, Hkv, 128, 128, True)),
            ("decode_attention",
             lambda: decode_attention_cuda(qd, kd, vd, dlens),
             lambda: decode_attention_plain(qd, kd, vd, dlens),
             read_bound(ctx, H, Hkv, 128, False, 4 * len(ctx))),
            ("decode_attention_q8",
             lambda: decode_attention_q8_cuda(qd, dk8, dv8, dks, dvs, dlens),
             lambda: decode_attention_plain(qd, dk8, dv8, dlens, dks, dvs),
             read_bound(ctx, H, Hkv, 128, True, 4 * len(ctx))))
        for name, kernel, plain_fn, (bound, by) in cases:
            err = check_agreement(f"rank {name} {what} H={H} Hkv={Hkv} B=8",
                                  kernel(), plain_fn())
            rows.append((name, what, H, Hkv, err, time_events(kernel, 50),
                         time_events(plain_fn, 5), bound, by))
        counts = launch_counts.counts()
        require(all(counts[k] > 0 for k in launch_counts.KERNELS),
                f"rank {what}: a kernel was not launched ({counts})")
        del q, k, v, qd, kp, vp, table, lens, kd, vd, dlens
        torch.cuda.empty_cache()
    for name, what, H, Hkv, err, ms, plain, bound, by in rows:
        log(f"rank kernel {name} {what} (H={H}, Hkv={Hkv}, G={H // Hkv}): "
            f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={bound:.4f} ({by}) [{card}]")
    return rows


def sp_phase(params, cfg, dev, card: str, mesh, depth: int,
             T: int = 256) -> None:
    """(d) sp_llama_forward at sp = 1 on the mesh, with ring and with
    Ulysses, against llama_forward_nocache on the same weights at `depth`
    layers ([1, T] random tokens); Ulysses must launch flash."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_forward_nocache
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.parallel import sp_llama_forward

    cut = cut_tree(params, depth)
    c = dataclasses.replace(cfg, n_layers=depth, attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                           device=dev)
    with torch.no_grad():
        want = llama_forward_nocache(cut, c, tokens)
        for attn in ("ring", "ulysses"):
            launch_counts.zero()
            t0 = time.monotonic()
            got = sp_llama_forward(cut, c, tokens, mesh, attn=attn)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            flash = launch_counts.counts()["flash_attention"]
            gap = float((got - want).abs().max())
            log(f"parallel sp=1 {attn}: [1, {T}] x {depth} layers, max "
                f"|logit gap| {gap:.4f} against llama_forward_nocache (tol "
                f"{SP_TOL}); flash launches {flash}; wall {wall:.3f}s "
                f"[{card}]")
            require(bool(torch.isfinite(got).all()) and got.shape
                    == want.shape and gap <= SP_TOL,
                    f"parallel sp=1 {attn}: off the dense forward")
            require(attn != "ulysses" or flash == depth,
                    f"parallel sp=1 ulysses: flash launched {flash} times, "
                    f"want {depth}")


def multi_card_phase(dev, card: str, n: int) -> None:
    """(e) With n > 1 cards visible: TP = n serving through serve.py
    (TP_SHARDS=n: this process rank 0 on cuda:0 and the HTTP ingress, the
    n-1 followers spawned on the other cards), Llama-3-8B whole, random
    weights from seed 0 on every rank: 8 concurrent streams, each held to
    the single-card teacher-forced oracle on the same weights within
    MODEL_TOL (check_streams), with the client's TTFT and tok/s per
    stream."""
    import threading

    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serve import build_app

    cfg = LlamaConfig.llama3_8b()
    prompts = [make_prompt(PAR_CHARS[i], PAR_SEED + 200 + i)
               for i in range(len(PAR_CHARS))]
    env = {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
           "TP_SHARDS": str(n), "HTTP_PORT": "0", "METRICS_PORT": "0",
           "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024",
           "PREFILL_BUCKETS": "128,256", "WARMUP": "wide",
           "PREFIX_CACHE": "false"}
    t0 = time.monotonic()
    app = build_app(env)
    boot_s = time.monotonic() - t0
    try:
        engine = app.engine
        rec = record_tokens(engine)
        app.start()
        out = {}
        threads = [threading.Thread(target=stream_request,
                                    args=(app.http_port, p, PAR_TOKENS, out,
                                          i))
                   for i, p in enumerate(prompts)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        n_req = len(prompts)
        ttft = [out[i]["times"][0] for i in range(n_req)]
        tps = [(len(out[i]["times"]) - 1) / max(
            out[i]["times"][-1] - out[i]["times"][0], 1e-9)
            for i in range(n_req)]
        log(f"parallel TP={n}: boot {boot_s:.1f}s ({engine.executor.captures}"
            f" graphs on rank 0); {n_req} concurrent streams x {PAR_TOKENS} "
            f"tokens in {wall:.2f}s; client TTFT s "
            f"{[round(x, 4) for x in ttft]}; tok/s per stream "
            f"{[round(x, 1) for x in tps]} [{card}]")
        params = llama_init(cfg, seed=0, device=dev)
        check_streams(f"parallel TP={n}", params, cfg, dev, rec, PAR_TOKENS,
                      card)
        del params
    finally:
        shutdown_bounded(app, n)
        torch.cuda.empty_cache()


def shutdown_bounded(app, n: int, limit_s: float = 180.0) -> None:
    """The TP App's shutdown with a bound (ROADMAP C8: on 4 cards it has
    hung): past `limit_s`, log what is still alive (rank 0's loop, the
    follower processes, the process group) and end this process with exit
    code 1, so the call ends instead of waiting out its limit."""
    import os

    import torch.distributed as dist

    done = threading.Event()
    t0 = time.monotonic()
    threading.Thread(target=lambda: (app.shutdown(), done.set()),
                     daemon=True).start()
    if done.wait(limit_s):
        codes = [p.exitcode for p in getattr(app.engine, "followers", ())]
        log(f"parallel TP={n}: shutdown in {time.monotonic() - t0:.1f}s; "
            f"follower exit codes {codes}")
        require(codes == [0] * (n - 1), f"parallel TP={n}: follower exit "
                f"codes {codes}")
        return
    engine = app.engine
    loop = engine._thread
    log(f"FAIL parallel TP={n}: the App's shutdown did not finish in "
        f"{limit_s:.0f}s; rank 0's loop alive: "
        f"{loop is not None and loop.is_alive()}; followers alive: "
        f"{[p.is_alive() for p in getattr(engine, 'followers', ())]}; "
        f"process group still up: {dist.is_initialized()}")
    sys.stdout.flush()
    for proc in getattr(engine, "followers", ()):
        proc.kill()
    os._exit(1)


def leave_job() -> None:
    from gofr_tpu_torch.parallel.multihost import leave

    leave()


def parallel_mode(dev, card: str, only_e: bool = False) -> None:
    """--parallel: with more than one card visible, (e) first (its App's
    shutdown is ROADMAP C8's), then phases (a) to (d) on the card;
    only_e (``--parallel e``): (e) alone."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init

    n = torch.cuda.device_count()
    if n > 1:
        t1 = time.monotonic()
        multi_card_phase(dev, card, n)
        log(f"parallel (e): {time.monotonic() - t1:.1f}s")
    else:
        log("parallel (e): one card visible, TP > 1 serving not run")
    if only_e:
        return
    t0 = time.monotonic()
    mesh = join_world_of_one()
    try:
        cfg = LlamaConfig.llama3_8b()
        params = llama_init(cfg, seed=0, device=dev)
        tp_engine_phase(params, cfg, dev, card, mesh, PAR_DEPTH)
        log(f"parallel (a): {time.monotonic() - t0:.1f}s")
        t1 = time.monotonic()
        sp_phase(params, cfg, dev, card, mesh, CUT_DEPTH)
        sp_phase(params, cfg, dev, card, mesh, PAR_DEPTH, T=1024)
        log(f"parallel (d): {time.monotonic() - t1:.1f}s")
        del params
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        rank_kernels_phase(dev, card)
        log(f"parallel (c): {time.monotonic() - t1:.1f}s")
        t1 = time.monotonic()
        follower_phase(dev, card, CUT_DEPTH)
        log(f"parallel (b): {time.monotonic() - t1:.1f}s")
    finally:
        leave_job()
    del dataclasses


def parallel_short(dev, card: str) -> None:
    """The default run's short parallel phase: (a) at CUT_DEPTH layers (4
    greedy streams x 16 tokens on the tp=1 NCCL mesh engine and on the
    engine without a mesh, equal) and (d) at [1, 128]."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init

    t0 = time.monotonic()
    mesh = join_world_of_one()
    try:
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                                  n_layers=CUT_DEPTH)
        params = llama_init(cfg, seed=0, device=dev)
        tp_engine_phase(params, cfg, dev, card, mesh, CUT_DEPTH, n_req=4,
                        n_tok=16, profile_steps=False)
        sp_phase(params, cfg, dev, card, mesh, CUT_DEPTH, T=128)
        del params
        torch.cuda.empty_cache()
    finally:
        leave_job()
    log(f"parallel short phase: {time.monotonic() - t0:.1f}s")


# -- phase 17: sharded training (--sharded-train, and the default short
# phase) ---------------------------------------------------------------------
# every rank runs make_train_step(..., mesh=) on its blocks; each phase is
# held at TRAIN_DEPTH layers to rank 0's single-card step on the same
# weights (llama_init / moe_llama_init seed 0 on every rank) and tokens: the
# loss within ST_LOSS_RTOL and grad_norm within ST_GNORM_RTOL relative (the
# sharded step sums its bf16 partial products, and reduces its bf16
# gradients, in another order than one card)
ST_LOSS_RTOL = 5e-3
ST_GNORM_RTOL = 2e-2
ST_SEED = 14000          # token seeds no other phase uses
ST_STEPS = 6
ST_RING_STEPS = 4
# B's layers: what a card holds with 8 / ep experts a layer (at 12 layers
# the update's new moments and updates beside the old state, ~81 GB a
# rank, ran out of memory on an H100 80GB HBM3); TRAIN_DEPTH, so B's run is
# itself held to one card
ST_MOE_DEPTH = TRAIN_DEPTH
# the phases' sequence lengths: A (B = n), B (B = 2), C
# (B = 8, 4 microbatches), D (B = 1, T / n a rank)
ST_T = {"A": 2048, "B": 1024, "C": 1024, "D": 8192}
ST_BUBBLE_ITERS = 10     # C's timed pipeline forwards, after a warm one
ST_LIMIT_S = 900.0       # the world's bound (every phase, 4 cards)
ST_LEAVE_S = 120.0       # a rank's teardown and exit after its last phase
ST_LOG_DIR = "sharded_train_logs"   # every rank's lines, under the cwd


def st_tokens(vocab: int, B: int, T: int, dev, seed: int):
    """(tokens, targets) [B, T] from a CPU generator: the same global batch
    on every rank."""
    import torch

    gen = torch.Generator()
    gen.manual_seed(seed)
    seq = torch.randint(1, vocab, (B, T + 1), generator=gen)
    return seq[:, :-1].to(dev), seq[:, 1:].to(dev)


def st_log(rank: int, msg: str, all_ranks: bool = False) -> None:
    """Rank 0's lines on stdout (every rank's with all_ranks), each rank's
    into ST_LOG_DIR/rank<r>.log."""
    import os

    if rank == 0 or all_ranks:
        log(f"[rank {rank}] {msg}" if rank else msg)
    os.makedirs(ST_LOG_DIR, exist_ok=True)
    with open(os.path.join(ST_LOG_DIR, f"rank{rank}.log"), "a") as f:
        f.write(msg + "\n")


# the single card's gradient is taken a group of leaves at a time, each
# group up to this many bytes of gradient (a leaf larger, alone): the MoE's
# stacked [L, E, D, F] expert leaves are 7 GiB each at 8 layers, and their
# gradients, the select-backward buffers beside them and the f32 squares of
# global_norm do not fit beside the weights on an H100 80GB HBM3 at once
ST_GRAD_GROUP_BYTES = 8 * 2**30


def st_sq(g) -> float:
    """sum(g.float() ** 2), a slice of the first dim at a time."""
    return sum(float(x.float().square().sum()) for x in g.reshape(
        g.shape[0] if g.dim() > 1 else 1, -1))


def st_oracle(rank: int, fwd, params, toks, tgts, has_aux: bool = False):
    """Rank 0's single-card step on `params`: the first loss and grad_norm
    (make_train_step's loss_and_grads, remat on; no optimizer state). The
    gradient is taken for one group of leaves at a time (ST_GRAD_GROUP_BYTES,
    the others held fixed in the forward), each leaf's squares summed as it
    comes and the gradient freed; the norm is global_norm's over the whole
    tree. The other ranks wait at a barrier."""
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch import tree
    from gofr_tpu_torch.train import make_train_step

    out = None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        leaves = tree.leaves(params)
        groups, size = [[]], 0
        for i, p in enumerate(leaves):
            nbytes = p.numel() * p.element_size()
            if groups[-1] and size + nbytes > ST_GRAD_GROUP_BYTES:
                groups.append([])
                size = 0
            groups[-1].append(i)
            size += nbytes
        sq, loss = 0.0, None
        for group in groups:
            def merged(sub, t, group=group):
                full = list(leaves)
                for i, p in zip(group, sub):
                    full[i] = p
                return fwd(tree.unflatten(params, full), t)

            _, step = make_train_step(merged, has_aux_loss=has_aux)
            got, _, _, grads = step.loss_and_grads(
                [leaves[i] for i in group], toks, tgts)
            loss = float(got) if loss is None else loss
            for k in range(len(grads)):
                sq += st_sq(grads[k])
                grads[k] = None
            del grads
            torch.cuda.empty_cache()
        out = (loss, math.sqrt(sq))
        st_log(rank, f"single-card oracle: {len(groups)} gradient "
               f"group(s), peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
               f" GiB")
        del leaves
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def st_held(rank: int, what: str, got, want, card: str, depth: int,
            grad: bool = True) -> dict:
    """Rank 0: the sharded first step's (loss, grad_norm) against the
    single card's at `depth` layers, within ST_LOSS_RTOL / ST_GNORM_RTOL."""
    if rank != 0:
        return {}
    dl = abs(got[0] - want[0]) / abs(want[0])
    dg = abs(got[1] - want[1]) / abs(want[1]) if grad else 0.0
    ok = dl <= ST_LOSS_RTOL and dg <= ST_GNORM_RTOL
    st_log(rank, f"sharded {what}: check against one card at {depth} "
           f"layers: loss {got[0]:.6f} vs {want[0]:.6f} (rel {dl:.2e}, tol "
           f"{ST_LOSS_RTOL})" + (f", grad_norm {got[1]:.6f} vs {want[1]:.6f} "
                                 f"(rel {dg:.2e}, tol {ST_GNORM_RTOL})"
                                 if grad else ", forward only") +
           f" {'ok' if ok else 'FAIL'} [{card}]")
    require(ok, f"sharded {what}: the first step left the single card's")
    return {"loss_rel": dl, "grad_norm_rel": dg}


def st_first(step, params, toks, tgts) -> tuple:
    """(loss, grad_norm) of one sharded step from fresh optimizer state."""
    init, run = step
    state = init(params)
    _, _, m = run(params, state, toks, tgts)
    out = (float(m["loss"]), float(m["grad_norm"]))
    del state
    return out


def st_nccl_step(run, params, state, toks, tgts) -> dict:
    """One more step under torch.profiler (CUDA kernels): its NCCL kernels
    and their card ms, and the card's busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(params, state, toks, tgts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    return {"nccl_kernels": sum(e.count for e in nccl),
            "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3}


def st_steps(rank: int, n: int, what: str, step, params, toks, tgts,
             steps: int, flops: float, card: str, flash_per_step: int
             ) -> dict:
    """`steps` sharded steps on one repeated global batch, each timed by
    the host clock and CUDA events, with this rank's peak memory and flash
    launches (launch_counts, zeroed before the step; required to be
    flash_per_step); tokens/s a card and MFU against n cards' peak; then
    one more step under torch.profiler on rank 0 (every rank runs it):
    NCCL kernels and ms. The loss must fall, every metric be finite."""
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.ops import launch_counts

    init, run = step
    state = init(params)
    B, T = toks.shape
    out = {"loss": [], "grad_norm": [], "aux": [], "card_ms": [],
           "wall_ms": [], "peak_gib": 0.0, "launches": []}
    for i in range(steps):
        launch_counts.zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.monotonic()
        start.record()
        params, state, m = run(params, state, toks, tgts)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        card_ms = start.elapsed_time(end)
        flash = launch_counts.counts()["flash_attention"]
        loss, aux, gn = (float(m[k]) for k in ("loss", "aux_loss",
                                                "grad_norm"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        mfu = flops / (card_ms / 1e3) / (n * H100_BF16_FLOPS)
        for key, v in (("loss", loss), ("grad_norm", gn), ("aux", aux),
                       ("card_ms", card_ms), ("wall_ms", wall * 1e3),
                       ("launches", flash)):
            out[key].append(v)
        out["peak_gib"] = max(out["peak_gib"], peak)
        st_log(rank, f"sharded {what} step {i}: loss={loss:.5f} aux={aux:.5f}"
               f" grad_norm={gn:.5f} wall={wall * 1e3:.1f}ms card="
               f"{card_ms:.1f}ms tok/s/card={B * T / wall / n:.0f} MFU="
               f"{mfu:.4f} peak_mem={peak:.2f}GiB flash_launches={flash} "
               f"[{card}]", all_ranks=i == steps - 1)
        require(math.isfinite(loss) and math.isfinite(gn) and gn > 0
                and math.isfinite(aux), f"sharded {what}: step {i} metrics "
                f"loss={loss} grad_norm={gn} aux={aux}")
        require(flash == flash_per_step, f"sharded {what}: {flash} flash "
                f"launches on rank {rank} in step {i}, want {flash_per_step}")
    require(out["loss"][-1] < out["loss"][0],
            f"sharded {what}: the loss did not fall {out['loss']}")
    dist.barrier()
    if rank == 0:
        prof = st_nccl_step(run, params, state, toks, tgts)
    else:
        run(params, state, toks, tgts)
        prof = {}
    out.update(prof)
    out["tok_s_card"] = B * T / (out["wall_ms"][-1] / 1e3) / n
    out["mfu"] = flops / (out["card_ms"][-1] / 1e3) / (n * H100_BF16_FLOPS)
    if rank == 0:
        st_log(rank, f"sharded {what} collectives (rank 0, one profiled "
               f"step): {prof['nccl_kernels']} NCCL kernels, "
               f"{prof['nccl_ms']:.2f} ms of card, card busy "
               f"{prof['busy_ms']:.1f} ms [{card}]")
    del state
    return out


def st_summary(rank: int, what: str, r: dict, card: str) -> None:
    st_log(rank, f"sharded {what} summary: loss {r['loss'][0]:.4f} -> "
           f"{r['loss'][-1]:.4f}; last step wall={r['wall_ms'][-1]:.1f}ms "
           f"card={r['card_ms'][-1]:.1f}ms tok/s/card={r['tok_s_card']:.0f} "
           f"MFU={r['mfu']:.4f}; peak_mem={r['peak_gib']:.2f}GiB; flash "
           f"launches a step {r['launches'][-1]} [{card}]", all_ranks=True)


def st_flash_check(what: str, B: int, T: int, H: int, Hkv: int, dev
                   ) -> float:
    """flash_attention, causal, at a sharded path's per-rank shape: q, k, v
    in the model's [B, T, H, dh] layout, as the attention sublayer hands
    them over, against flash_attention_plain on the same inputs
    (check_agreement, per row, as check_flash)."""
    import torch

    from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                    flash_attention,
                                                    flash_attention_plain)

    q, k, v = (t.transpose(1, 2).contiguous() for t in flash_inputs(
        B, H, Hkv, T, T, 128, dev, seed=B * T + H))
    got = flash_attention(q, k, v, True)
    want = flash_attention_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                                 True, KERNEL_BLOCK_KV).transpose(1, 2)
    err = check_agreement(f"{what} flash B={B} T=S={T} H={H} Hkv={Hkv} "
                          f"causal, [B, T, H, dh] views in and out", got,
                          want, per_row=True)
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return err


def st_llama():
    """Phases A, C and D's model: Llama-3-8B, flash attention."""
    import dataclasses

    from gofr_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.llama3_8b(), attn_impl="flash")


def st_moe_config():
    """Phase B's model: the MoE defaults (Llama-3-8B's widths, 8 experts,
    top-2), flash attention."""
    import dataclasses

    from gofr_tpu_torch.models.moe import MoELlamaConfig

    return dataclasses.replace(MoELlamaConfig(), attn_impl="flash")


def st_dense(rank: int, n: int, dev, card: str) -> dict:
    """A: dense Llama-3-8B (full width, all 32 layers) over dp = n/2 x
    tp = 2, B = n, T = 2048, remat on (make_mesh_forward, flash in every
    attention sublayer)."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_forward_nocache, llama_init
    from gofr_tpu_torch.parallel import (MeshPlan, llama_param_specs,
                                         make_mesh, make_mesh_forward,
                                         shard_params)
    from gofr_tpu_torch.train import make_train_step

    mesh = make_mesh(MeshPlan(dp=n // 2, tp=2), device=dev.type)
    full = st_llama()
    B, T = n, ST_T["A"]
    st_flash_check(f"sharded A rank {rank}", B // (n // 2), T,
                   full.n_heads // 2, full.n_kv_heads // 2, dev)
    cfg8 = dataclasses.replace(full, n_layers=TRAIN_DEPTH)
    toks, tgts = st_tokens(full.vocab_size, B, T, dev, ST_SEED)
    want = st_oracle(rank, lambda p, t: llama_forward_nocache(p, cfg8, t),
                     llama_init(cfg8, 0, dev) if rank == 0 else None, toks,
                     tgts)
    params = shard_params(llama_init(cfg8, 0, dev), mesh, llama_param_specs())
    got = st_first(make_train_step(make_mesh_forward(cfg8, mesh), mesh=mesh),
                   params, toks, tgts)
    held = st_held(rank, f"A dp={n // 2} tp=2", got, want, card, TRAIN_DEPTH)
    del params
    torch.cuda.empty_cache()
    params = shard_params(llama_init(full, 0, dev), mesh, llama_param_specs())
    torch.cuda.empty_cache()
    flops = train_flops(full, full.param_count(), B, T)
    r = st_steps(rank, n, f"A dp={n // 2} tp=2", make_train_step(
        make_mesh_forward(full, mesh), mesh=mesh), params, toks, tgts,
        ST_STEPS, flops, card, 2 * full.n_layers)
    st_summary(rank, f"A dense llama3-8b {full.n_layers}L dp={n // 2} tp=2 "
               f"B={B} T={T}", r, card)
    del params
    return {**r, **held}


def st_moe(rank: int, n: int, dev, card: str) -> dict:
    """B: the MoE at Llama-3-8B widths, 8 experts, top-2, over ep = n
    (8 / n experts a rank), ST_MOE_DEPTH layers, B=2, T=1024, remat on;
    its first step held to one card's."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.moe import (moe_llama_forward_nocache,
                                           moe_llama_init)
    from gofr_tpu_torch.parallel import (MeshPlan, llama_param_specs,
                                         make_mesh, make_mesh_forward,
                                         shard_params)
    from gofr_tpu_torch.train import make_train_step

    mesh = make_mesh(MeshPlan(ep=n), device=dev.type)
    cfg = dataclasses.replace(st_moe_config(), n_layers=ST_MOE_DEPTH)
    B, T = 2, ST_T["B"]
    st_flash_check(f"sharded B rank {rank}", B, T, cfg.n_heads,
                   cfg.n_kv_heads, dev)
    toks, tgts = st_tokens(cfg.vocab_size, B, T, dev, ST_SEED + 2)
    want = st_oracle(rank, lambda p, t: moe_llama_forward_nocache(p, cfg, t),
                     moe_llama_init(cfg, 0, dev) if rank == 0 else None,
                     toks, tgts, has_aux=True)
    params = shard_params(moe_llama_init(cfg, 0, dev), mesh,
                          llama_param_specs(moe=True))
    torch.cuda.empty_cache()
    n_params = cfg.param_count() + cfg.n_layers * (
        (3 * cfg.n_experts - 3) * cfg.dim * cfg.ffn_dim
        + cfg.dim * cfg.n_experts)
    r = st_steps(rank, n, f"B ep={n}", make_train_step(
        make_mesh_forward(cfg, mesh), has_aux_loss=True, mesh=mesh), params,
        toks, tgts, ST_STEPS, train_flops(cfg, n_params, B, T), card,
        2 * cfg.n_layers)
    held = st_held(rank, f"B ep={n}", (r["loss"][0], r["grad_norm"][0]),
                   want, card, ST_MOE_DEPTH)
    st_summary(rank, f"B moe {ST_MOE_DEPTH}L {cfg.n_experts} experts top-"
               f"{cfg.experts_per_token} ep={n} B={B} T={T} (dense dispatch: "
               f"every expert computes every token, counted)", r, card)
    del params
    return {**r, **held}


def st_stage_fn(cfg, mesh):
    """pipelined_llama_forward's stage: this rank's layers over [mb, T, D]
    (for the bubble's timing)."""
    from gofr_tpu_torch.models.llama import (_attention_block_nocache,
                                             _ffn_block)
    from gofr_tpu_torch.parallel.sharding import shard_config

    lcfg = shard_config(cfg, mesh)

    def stage(layers, h):
        import torch

        mb, T = h.shape[:2]
        positions = torch.arange(T, device=h.device).expand(mb, T)
        for l in range(next(iter(layers.values())).shape[0]):
            layer = {k: w[l] for k, w in layers.items()}
            h = h + _attention_block_nocache(h, layer, positions, lcfg)
            h = h + _ffn_block(h, layer, lcfg)
        return h

    return stage


def st_gpipe(rank: int, n: int, dev, card: str) -> dict:
    """C: GPipe, Llama-3-8B with all 32 layers, 32 / n a stage, over
    pp = n, 4 microbatches, remat off (the reference's dryrun), B=8,
    T=1024; the bubble measured beside (pp - 1) / (n_micro + pp - 1)."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_forward_nocache, llama_init
    from gofr_tpu_torch.parallel import (MeshPlan, gpipe, llama_param_specs,
                                         make_mesh, pipelined_llama_forward,
                                         shard_params)
    from gofr_tpu_torch.parallel.mesh import axis_of
    from gofr_tpu_torch.train import make_train_step

    n_micro = 4
    mesh = make_mesh(MeshPlan(pp=n), device=dev.type)
    full = st_llama()
    cfg8 = dataclasses.replace(full, n_layers=TRAIN_DEPTH)
    B, T = 8, ST_T["C"]
    st_flash_check(f"sharded C rank {rank}", B // n_micro, T, full.n_heads,
                   full.n_kv_heads, dev)
    toks, tgts = st_tokens(full.vocab_size, B, T, dev, ST_SEED + 3)

    def piped(cfg):
        return make_train_step(
            lambda p, t: pipelined_llama_forward(p, cfg, t, mesh, n_micro),
            remat=False, mesh=mesh)

    want = st_oracle(rank, lambda p, t: llama_forward_nocache(p, cfg8, t),
                     llama_init(cfg8, 0, dev) if rank == 0 else None, toks,
                     tgts)
    params = shard_params(llama_init(cfg8, 0, dev), mesh, llama_param_specs())
    got = st_first(piped(cfg8), params, toks, tgts)
    held = st_held(rank, f"C pp={n}", got, want, card, TRAIN_DEPTH)
    del params
    torch.cuda.empty_cache()
    params = shard_params(llama_init(full, 0, dev), mesh, llama_param_specs())
    torch.cuda.empty_cache()
    flops = train_flops(full, full.param_count(), B, T)
    # every rank runs its stage at each of the n_micro + pp - 1 steps
    r = st_steps(rank, n, f"C pp={n}", piped(full), params, toks, tgts,
                 ST_STEPS, flops, card,
                 (n_micro + n - 1) * full.n_layers // n)
    # the bubble: the pipeline's forward against the n_micro stage calls
    # of real microbatches, each stage call timed inside the pipeline
    # (CUDA events around it, on the stream the pipeline runs on)
    stage = st_stage_fn(full, mesh)
    spans = []

    def timed_stage(layers, h):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        h = stage(layers, h)
        end.record()
        spans.append((start, end))
        return h

    x = torch.randn((n_micro, B // n_micro, T, full.dim), device=dev,
                    dtype=params["final_norm"].dtype)
    pp = axis_of(mesh, "pp")
    with torch.no_grad():
        pipe_ms = time_events(lambda: gpipe(timed_stage, params["layers"], x,
                                            pp), ST_BUBBLE_ITERS)
    spans = spans[n_micro + n - 1:]     # time_events' own warm call
    stage_ms = sum(a.elapsed_time(b) for a, b in spans) / len(spans)
    bubble = 1.0 - n_micro * stage_ms / pipe_ms
    exchange = 1.0 - (n_micro + n - 1) * stage_ms / pipe_ms
    ideal = (n - 1) / (n_micro + n - 1)
    st_log(rank, f"sharded C bubble: pipeline forward {pipe_ms:.2f}ms, a "
           f"stage call inside it {stage_ms:.2f}ms (mean of {len(spans)}), "
           f"bubble 1 - {n_micro} x stage / pipeline = {bubble:.4f} against "
           f"(pp-1)/(n_micro+pp-1) = {ideal:.4f}; outside the "
           f"{n_micro + n - 1} stage calls (exchanges, input select) "
           f"{exchange:.4f} of the pipeline [{card}]", all_ranks=True)
    st_summary(rank, f"C gpipe llama3-8b {full.n_layers}L pp={n} {n_micro} "
               f"microbatches B={B} T={T} remat off", r, card)
    del params, x
    return {**r, **held, "bubble": bubble, "bubble_ideal": ideal,
            "pipe_ms": pipe_ms, "stage_ms": stage_ms, "exchange": exchange}


def st_ring(rank: int, n: int, dev, card: str) -> dict:
    """D: ring over sp = n, Llama-3-8B at TRAIN_DEPTH layers, B=1, T=8192
    (8192 / n a rank), remat off, ST_RING_STEPS steps; its first loss held
    to the single card's flash forward at the same T (forward only: the
    single card's backward at T=8192 recomputes [32, 8192, 8192] f32
    scores a layer)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.models.llama import llama_forward_nocache, llama_init
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh, make_sp_forward
    from gofr_tpu_torch.train import cross_entropy_loss, make_train_step

    mesh = make_mesh(MeshPlan(sp=n), device=dev.type)
    cfg = dataclasses.replace(st_llama(), n_layers=TRAIN_DEPTH)
    B, T = 1, ST_T["D"]
    toks, tgts = st_tokens(cfg.vocab_size, B, T, dev, ST_SEED + 4)
    params = llama_init(cfg, 0, dev)
    want = None
    if rank == 0:
        with torch.no_grad():
            want = (float(cross_entropy_loss(
                llama_forward_nocache(params, cfg, toks), tgts)), 0.0)
        torch.cuda.empty_cache()
    dist.barrier()
    r = st_steps(rank, n, f"D ring sp={n}", make_train_step(
        make_sp_forward(cfg, mesh, attn="ring"), remat=False, mesh=mesh),
        params, toks, tgts, ST_RING_STEPS, train_flops(
            cfg, cfg.param_count(), B, T), card, 0)
    held = st_held(rank, f"D ring sp={n}", (r["loss"][0], 0.0), want, card,
                   TRAIN_DEPTH, grad=False)
    st_summary(rank, f"D ring llama3-8b {TRAIN_DEPTH}L sp={n} B={B} T={T} "
               f"remat off (ring attends in plain PyTorch, as the "
               f"reference's _block_attend)", r, card)
    del params
    return {**r, **held}


def st_rank(rank: int, n: int, port: int, out, device=None) -> None:
    """One process of --sharded-train: rank `rank` of an n-rank NCCL job
    joined through the JAX_* keys (cuda:rank; device="cpu": a gloo job on
    the CPU, for a rehearsal), phases A to D, then the teardown with
    monotonic stamps; its results (or its traceback) on `out`."""
    try:
        import os

        # the phases hold 55-65 GiB a card in tensors of many sizes
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        import torch
        import torch.distributed as dist

        from gofr_tpu_torch.config import as_config
        from gofr_tpu_torch.parallel.multihost import (initialize_from_config,
                                                       leave)
        from gofr_tpu_torch.tpu.device import card_info

        initialize_from_config(as_config({
            "JAX_COORDINATOR_ADDR": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(rank),
            "JAX_COORDINATOR_TIMEOUT_S": "300"}), device=device)
        dev = (torch.device("cuda", rank) if device is None
               else torch.device(device))
        card = card_info().splitlines()[rank]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res = {}
        for name, fn in (("A", st_dense), ("B", st_moe), ("C", st_gpipe),
                         ("D", st_ring)):
            t0 = time.monotonic()
            res[name] = fn(rank, n, dev, card)
            res[name]["seconds"] = time.monotonic() - t0
            st_log(rank, f"sharded phase {name}: {res[name]['seconds']:.1f}s "
                   f"[{card}]")
            torch.cuda.empty_cache()
        t0 = time.monotonic()
        stamps = []

        def stamp(step):
            stamps.append((step, round(time.monotonic() - t0, 3)))
            st_log(rank, f"teardown: {step} t={time.monotonic():.3f}",
                   all_ranks=True)

        stamp("barrier")
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stamp("destroy_process_group")
        leave()
        stamp("process group destroyed")
        res["teardown"] = stamps
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 - reported to the parent
        import traceback

        out.put((rank, False, traceback.format_exc()))


def sharded_train_mode(dev, card: str) -> dict:
    """--sharded-train: with n >= 2 cards, one process a card (st_rank),
    phases A-D; every rank must report and exit 0 within ST_LEAVE_S of
    its report (joined, not killed, unless past the bound). With one card:
    the world-of-one check (sharded_short) alone."""
    import multiprocessing as mp
    import os
    import queue

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        log("sharded-train: one card visible; phases A-D need n >= 2 cards "
            "(NCCL runs one rank a card); the world-of-one check only")
        sharded_short(dev, card)
        return {}
    require(8 % n == 0, f"sharded-train: {n} cards; the phases' meshes "
            f"need n to divide 8")
    for r in range(n):
        try:
            os.remove(os.path.join(ST_LOG_DIR, f"rank{r}.log"))
        except OSError:
            pass
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=st_rank, args=(r, n, port, out),
                         name=f"sharded-rank-{r}") for r in range(n)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + ST_LIMIT_S
    try:
        while len(results) < n:
            require(time.monotonic() < deadline, f"sharded-train: ranks "
                    f"{sorted(set(range(n)) - set(results))} did not report "
                    f"within {ST_LIMIT_S:.0f}s")
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                require(not dead, f"sharded-train: rank {dead} died "
                        f"(exit {[procs[r].exitcode for r in dead]})")
                continue
            require(ok, f"sharded-train: rank {rank} failed:\n{value}")
            results[rank] = (value, time.monotonic())
        t_join = time.monotonic()
        for p in procs:
            p.join(timeout=max(0.1, t_join + ST_LEAVE_S - time.monotonic()))
        codes = [p.exitcode for p in procs]
        exit_s = time.monotonic() - t_join
        log(f"sharded-train teardown: every rank left the job and exited "
            f"{codes} within {exit_s:.1f}s of the last report (bound "
            f"{ST_LEAVE_S:.0f}s); per rank (step, s after its last phase): "
            f"{json.dumps({r: results[r][0]['teardown'] for r in results})}"
            f" [{card}]")
        require(codes == [0] * n, f"sharded-train: exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    log(f"sharded-train: {n} ranks, {time.monotonic() - t0:.1f}s")
    return {r: v for r, (v, _) in results.items()}


def sharded_short(dev, card: str) -> int:
    """The default run's short phase: a one-rank NCCL job at CUT_DEPTH
    layers of Llama-3-8B (flash), B=1, T=512: flash against its plain
    version at that shape (st_flash_check); the sharded step on the
    all-ones mesh (make_mesh_forward, mesh=) against make_train_step's
    unsharded step from the same weights, bit for bit over 2 steps (every
    metric and every leaf; both under torch.use_deterministic_algorithms,
    warn_only); the pipelined forward at pp=1 (2 microbatches,
    B=2) against the plain forward's logits. Returns the sharded step's
    flash launches."""
    import dataclasses

    import torch

    from gofr_tpu_torch import tree
    from gofr_tpu_torch.models.llama import (LlamaConfig,
                                             llama_forward_nocache, llama_init)
    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.parallel import (llama_param_specs, make_mesh_forward,
                                         pipelined_llama_forward, shard_params)
    from gofr_tpu_torch.train import make_train_step

    t0 = time.monotonic()
    mesh = join_world_of_one()
    try:
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=CUT_DEPTH,
                                  attn_impl="flash")
        # the step's and the pipelined forward's microbatch's shape
        st_flash_check("sharded short", 1, 512, cfg.n_heads, cfg.n_kv_heads,
                       dev)
        toks, tgts = st_tokens(cfg.vocab_size, 1, 512, dev, ST_SEED + 5)
        runs = {}
        # deterministic kernels: the embedding's backward accumulates the
        # rows of repeated ids, in any order by default
        torch.use_deterministic_algorithms(True, warn_only=True)
        for name in ("sharded", "plain"):
            params = llama_init(cfg, 0, dev)
            if name == "sharded":
                params = shard_params(params, mesh, llama_param_specs())
                init, step = make_train_step(make_mesh_forward(cfg, mesh),
                                             mesh=mesh)
            else:
                init, step = make_train_step(
                    lambda p, t: llama_forward_nocache(p, cfg, t))
            state = init(params)
            launch_counts.zero()
            metrics = []
            for _ in range(2):
                params, state, m = step(params, state, toks, tgts)
                metrics.append({k: v.clone() for k, v in m.items()})
            runs[name] = (metrics, params,
                          launch_counts.counts()["flash_attention"])
            del state
        torch.use_deterministic_algorithms(False)
        (ms, ps, launches), (mp_, pp_, plain_launches) = (runs["sharded"],
                                                         runs["plain"])
        same_metrics = all(torch.equal(a[k], b[k])
                           for a, b in zip(ms, mp_) for k in a)
        leaves = list(zip(tree.leaves(ps), tree.leaves(pp_)))
        same = sum(torch.equal(a, b) for a, b in leaves)
        log(f"sharded short: world of one (NCCL), {CUT_DEPTH} layers B=1 "
            f"T=512, 2 steps: sharded vs unsharded metrics bit-equal="
            f"{same_metrics} (loss {float(ms[-1]['loss']):.6f}), "
            f"{same}/{len(leaves)} leaves bit-equal; flash launches "
            f"{launches} (unsharded {plain_launches}) [{card}]")
        require(same_metrics and same == len(leaves),
                "sharded short: the world-of-one step is not the unsharded "
                "step bit for bit")
        require(launches == 2 * 2 * CUT_DEPTH, f"sharded short: {launches} "
                f"flash launches, want {4 * CUT_DEPTH}")
        del runs, ps, pp_, leaves
        torch.cuda.empty_cache()
        params = llama_init(cfg, 0, dev)
        toks2, _ = st_tokens(cfg.vocab_size, 2, 512, dev, ST_SEED + 6)
        with torch.no_grad():
            got = pipelined_llama_forward(
                shard_params(params, mesh, llama_param_specs()), cfg, toks2,
                mesh, 2)
            want = llama_forward_nocache(params, cfg, toks2)
        gap = float((got - want).abs().max())
        equal = float((got == want).float().mean())
        log(f"sharded short: pipelined forward at pp=1 (2 microbatches, B=2 "
            f"T=512) against the plain forward: max_abs_diff={gap:.4f} (tol "
            f"{MODEL_TOL}) bit-equal share={equal:.6f} [{card}]")
        require(gap <= MODEL_TOL, "sharded short: the pipelined forward "
                "left the plain one")
        del params, got, want
        torch.cuda.empty_cache()
    finally:
        leave_job()
    log(f"sharded short phase: {time.monotonic() - t0:.1f}s")
    return launches


# -- phase 18: the open-loop load client, the datasources, pub/sub and the
# QoS batch lane (ROADMAP A18b parts 1-3) ------------------------------------
LG_SEED = 15000          # prompt seeds no other phase uses
LG_MAX_NEW = (16, 32)    # tokens an open-loop arrival asks for
LG_WORDS = (2, 6)        # prompt_text words of a synthesized arrival
LG_BURST = 16            # the closed burst that measures the throughput
LG_RATE_SHARE = 0.35     # the open loop's rate, of the measured throughput
LG_JOBS = 8              # batch-lane jobs (--loadgen; the default run: 4)
LG_JOB_TOKENS = 16
LG_JOB_CHARS = 120
LG_KNEE_UP = 2.5         # the knee's last rate, of the measured throughput
LG_LAG_SHARE = 0.5       # the worst dispatch lag, of the mean gap


def loadgen_env(tmp: str, warm: str) -> dict:
    """The main path's serve config with the QoS plane, the in-process
    broker (and with it the batch lane), a sqlite SQL datasource and the
    in-process KV store; the buckets reach 512 tokens (a replayed prompt is
    its token count in words); SLO targets of 10 s / 1 s, so the ladder
    acts only past the knee; the capacity forecaster's 4 s window and
    rho warning at 0.5, as the reference's knee test sets them."""
    return {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
            "HTTP_PORT": "0", "METRICS_PORT": "0", "MAX_BATCH": "8",
            "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
            "PREFILL_BUCKETS": "16,32,64,128,256,512",
            "REQUEST_TIMEOUT": "600", "WARMUP": warm, "QOS": "true",
            "PUBSUB_BACKEND": "inproc", "DB_DIALECT": "sqlite",
            "DB_PATH": f"{tmp}/datasource.db", "KV_ENABLED": "true",
            "QOS_LANE_MAX_INFLIGHT": "4", "SLO_TTFT_TARGET_S": "10",
            "SLO_TPOT_TARGET_S": "1", "CAPACITY_WINDOW_S": "4",
            "CAPACITY_RHO_WARN": "0.5", "INCIDENT_DIR": f"{tmp}/incidents",
            "PROFILE_DIR": f"{tmp}/profiles", **grpc_env()}


def lg_datasource_route(app) -> None:
    """POST /lg/ds: a SQL and a KV round trip from a handler (ctx.sql,
    ctx.kv)."""
    @app.post("/lg/ds")
    def ds(ctx):
        body = ctx.bind()
        ctx.sql.exec("CREATE TABLE IF NOT EXISTS lg (k TEXT, v TEXT)")
        ctx.sql.exec("INSERT INTO lg VALUES (?, ?)", body["k"], body["v"])
        ctx.kv.set("lg:" + body["k"], body["v"])
        return {"sql": ctx.sql.query_row("SELECT v FROM lg WHERE k = ?",
                                         body["k"])[0],
                "kv": ctx.kv.get("lg:" + body["k"])}


def lg_datasources(app, card: str) -> None:
    health = get_json(app.http_port, "/.well-known/health")
    up = {n: health["details"].get(n, {}).get("status")
          for n in ("sql", "kv", "pubsub")}
    status, _, body = post_json(app.http_port, "/lg/ds",
                                {"k": "a", "v": "1"})
    trip = (body or {}).get("data")
    log(f"loadgen datasources: health {json.dumps(up)} (aggregate "
        f"{health['status']}); a handler's SQL and KV round trip: {status} "
        f"{json.dumps(trip)} [{card}]")
    require(all(s == "UP" for s in up.values()),
            f"datasources not UP in /.well-known/health: {up}")
    require(status == 201 and trip == {"sql": "1", "kv": "1"},
            f"the datasource round trip answered {status} {body}")


def lg_events(rate: float, seconds: float, seed: int, short: bool):
    import random

    from gofr_tpu_torch.loadgen import poisson_arrivals, synthesize

    arrivals = poisson_arrivals(rate, seconds, random.Random(seed))
    return synthesize(arrivals, tenants=3, sessions=4, prompt_tokens=LG_WORDS,
                      max_new=(8, 16) if short else LG_MAX_NEW, seed=seed)


def lg_rows_ok(what: str, rows, events, rec=None, eos=None) -> None:
    """Every arrival a row, every row ok with the tokens its event asked
    for, or fewer where its stream ended at the tokenizer's EOS (the
    server's stop token): each short row's count is the length of a
    recorded stream (record_tokens) that ends at `eos`."""
    by_i = {r["i"]: r for r in rows}
    bad = [r for r in rows if r["status"] != "ok"]
    short = [(i, by_i[i].get("tokens"), e["max_new"])
             for i, e in enumerate(events)
             if i in by_i and by_i[i].get("tokens") != e["max_new"]]
    require(len(rows) == len(events), f"{what}: {len(rows)} rows for "
            f"{len(events)} arrivals")
    require(not bad, f"{what}: rows not ok: {bad[:3]}")
    import collections

    at_eos = collections.Counter(len(ids) for _, ids in (rec or {}).values()
                                 if ids and ids[-1] == eos)
    if short:
        log(f"{what}: {len(short)} streams ended at EOS before their "
            f"max_tokens: (arrival, tokens, asked) {short}")
    require(not collections.Counter(n for _, n, _ in short) - at_eos,
            f"{what}: (arrival, tokens, asked) short without an EOS: "
            f"{short[:3]} (EOS-ended lengths {dict(at_eos)})")


def lg_scorecard(what: str, rows, card: str) -> dict:
    from gofr_tpu_torch.loadgen import build_scorecard

    sc = build_scorecard(rows)
    for cls, cell in sorted(sc["classes"].items()):
        log(f"{what} scorecard {cls}: offered {cell['offered']} ok "
            f"{cell['ok']} TTFT p50 {cell.get('ttft_ms_p50')} ms p95 "
            f"{cell.get('ttft_ms_p95')} ms, TPOT p50 "
            f"{cell.get('tpot_ms_p50')} ms, goodput {cell.get('goodput')} "
            f"[{card}]")
    return sc


def lg_throughput(base: str, card: str, short: bool) -> float:
    """A closed burst of LG_BURST arrivals at t=0: completions a second."""
    from gofr_tpu_torch.loadgen import OpenLoopRunner

    events = lg_events(1000.0, 1.0, LG_SEED, short)[:LG_BURST]
    for e in events:
        e["t"] = 0.0
    rows = OpenLoopRunner(base, events, timeout_s=600.0, label="burst").run(
        drain_timeout_s=600.0)
    require(all(r["status"] == "ok" for r in rows), "burst rows not ok")
    wall = max(r["done_t"] for r in rows)
    thr = len(rows) / wall
    toks = sum(r["tokens"] for r in rows)
    log(f"loadgen throughput: a closed burst of {len(rows)} arrivals "
        f"({toks} tokens) in {wall:.3f}s: {thr:.3f} requests/s, "
        f"{toks / wall:.1f} tokens/s [{card}]")
    return thr


def lg_open_loop(app, engine, base: str, rate: float, seconds: float,
                 card: str, short: bool) -> tuple:
    """The seeded Poisson trace through OpenLoopRunner: every row ok with
    its full count, the dispatch lag small against the gaps; returns
    (rows, the recorder's last request id before the run)."""
    from gofr_tpu_torch.loadgen import OpenLoopRunner

    events = lg_events(rate, seconds, LG_SEED + 1, short)
    before = max((r["id"] for r in engine.recorder.snapshot()["recent"]),
                 default=-1)
    emit = engine._emit_block
    rec = record_tokens(engine)
    t0 = time.monotonic()
    runner = OpenLoopRunner(base, events, timeout_s=600.0, label="open")
    try:
        rows = runner.run(drain_timeout_s=600.0)
    finally:
        engine._emit_block = emit
    wall = time.monotonic() - t0
    lags = [a["lag_s"] for a in runner.arrivals()]
    gap = seconds / max(1, len(events))
    classes = sorted({e["class"] for e in events})
    tenants = sorted({e["tenant"] for e in events})
    reused = sum(1 for e in events if e.get("turn"))
    log(f"loadgen open loop: {len(events)} Poisson arrivals at {rate:.3f}/s "
        f"over {seconds}s (classes {classes}, tenants {tenants}, "
        f"{reused} later turns of a session), wall {wall:.1f}s; dispatch "
        f"lag worst {max(lags) * 1e3:.3f} ms, mean "
        f"{sum(lags) / len(lags) * 1e3:.3f} ms against a mean gap of "
        f"{gap * 1e3:.1f} ms [{card}]")
    lg_rows_ok("loadgen open loop", rows, events, rec, engine.tokenizer.EOS)
    require(len(classes) == 3 and len(tenants) >= 2,
            f"the trace mixes classes {classes} and tenants {tenants}")
    require(max(lags) <= LG_LAG_SHARE * gap,
            f"dispatch lag {max(lags):.4f}s beyond {LG_LAG_SHARE} of the "
            f"mean gap {gap:.4f}s")
    lg_scorecard("loadgen open loop", rows, card)
    return rows, before


def lg_replay(base: str, port: int, rows_a, before: int, card: str) -> None:
    """GET /debug/trace, the open loop's arrivals replayed, the scorecards
    compared: no metric but slo_met may regress. The recorder keeps no
    class or tenant, so the replay is unclassified and the first run is
    scored the same way. The recorder counts a prompt in tokens, so the
    replay's prompt is ``prompt_text`` cut to that many tokens of the
    server's one-token-a-character tokenizer (its BOS included), where
    ``prompt_text`` alone would make that many words."""
    from gofr_tpu_torch.loadgen import (OpenLoopRunner,
                                        baseline_from_scorecard,
                                        build_scorecard, compare,
                                        prompt_text)

    doc = get_json(port, "/debug/trace")
    events = [e for e in doc["events"] if e["seed"] > before]
    t0 = min(e["t"] for e in events)
    for e in events:
        e["t"] = round(e["t"] - t0, 6)
    require(len(events) == len(rows_a), f"the replica's trace holds "
            f"{len(events)} of the open loop's {len(rows_a)} arrivals")
    rows_b = OpenLoopRunner(
        base, events, timeout_s=600.0, label="replay",
        prompt_fn=lambda e: prompt_text(e)[:max(1, e["prompt_tokens"] - 1)]
    ).run(drain_timeout_s=600.0)
    require(all(r["status"] == "ok" for r in rows_b), "replay rows not ok")
    flat = [dict(r, **{"class": None, "tenant": None}) for r in rows_a]
    base_card = baseline_from_scorecard(build_scorecard(flat))
    sc = lg_scorecard("loadgen replay", rows_b, card)
    result = compare(sc, base_card)
    for c in result["checks"]:
        log(f"loadgen replay compare: {json.dumps(c)}")
    drifted = [c for c in result["checks"]
               if c.get("metric") != "slo_met" and c["verdict"] == "regress"]
    log(f"loadgen replay: {len(events)} captured arrivals replayed, "
        f"verdict {result['verdict']}, {len(drifted)} checks regress beyond "
        f"slo_met [{card}]")
    require(not drifted, f"the replay drifted: {drifted}")


def lg_lane(app, engine, params, cfg, dev, base: str, rate: float,
            n_jobs: int, card: str, short: bool) -> None:
    """n_jobs greedy jobs on qos.batch.jobs while interactive streams run:
    every result on qos.batch.results, each published before its job
    commits and the jobs committed in order, nothing delivered twice, each
    stream held to the teacher-forced plain oracle (MODEL_TOL, the
    greedy_vs_oracle rule); then lane.stats(), the depth gauge and one
    cron tick of the drain kick."""
    from gofr_tpu_torch.loadgen import OpenLoopRunner

    broker = app.container.pubsub
    lane = engine.qos.lane
    require(lane is not None, "QOS with a broker started no batch lane")
    seen = []
    publish, subscribe = broker.publish, broker.subscribe

    def logged_publish(topic, message, key=""):
        if topic == lane.result_topic:
            seen.append(("result", json.loads(message).get("job_id")))
        publish(topic, message, key)

    def logged_subscribe(topic, group="default", timeout_s=None):
        msg = subscribe(topic, group, timeout_s=timeout_s)
        if msg is not None and topic == lane.topic:
            job = json.loads(msg.value).get("job_id")
            seen.append(("deliver", job))
            commit = msg.commit

            def logged_commit():
                seen.append(("commit", job))
                commit()
            msg.commit = logged_commit
        return msg
    broker.publish, broker.subscribe = logged_publish, logged_subscribe
    # a poll the lane began before the swap returns empty first
    time.sleep(2 * lane.poll_s)
    reqs = []
    submit = engine.submit

    def kept_submit(*a, **k):
        request = submit(*a, **k)
        if k.get("tenant") == "lane":
            reqs.append(request)
        return request
    engine.submit = kept_submit
    emit = engine._emit_block
    rec = record_tokens(engine)
    tok = engine.tokenizer
    try:
        events = [dict(e, **{"class": "interactive"}) for e in
                  lg_events(rate, 4.0 if short else 8.0, LG_SEED + 2, short)]
        runner = OpenLoopRunner(base, events, timeout_s=600.0, label="inter")
        runner.start()
        for i in range(n_jobs):
            broker.publish(lane.topic, json.dumps({
                "tokens": tok.encode(make_prompt(LG_JOB_CHARS + 10 * i,
                                                 LG_SEED + 100 + i)),
                "max_tokens": LG_JOB_TOKENS, "tenant": "lane",
                "job_id": i}).encode())
        results = {}
        deadline = time.monotonic() + 600
        while len(results) < n_jobs and time.monotonic() < deadline:
            msg = subscribe(lane.result_topic, "smoke", timeout_s=0.5)
            if msg is not None:
                payload = json.loads(msg.value)
                results[payload["job_id"]] = payload
                msg.commit()
        require(runner.join(timeout_s=600.0), "interactive streams hung")
        inter = runner.rows()
    finally:
        broker.publish, broker.subscribe = publish, subscribe
        engine.submit = submit
        engine._emit_block = emit
    require(sorted(results) == list(range(n_jobs)),
            f"lane results {sorted(results)} of {n_jobs}: {lane.stats()}")
    require(all(r["ok"] and r["tokens"] == LG_JOB_TOKENS
                for r in results.values()), f"lane results not ok: "
            f"{[r for r in results.values() if not r['ok']][:2]}")
    jobs = [e for e in seen if e[0] in ("result", "commit")]
    order = [(kind, i) for i in range(n_jobs) for kind in ("result",
                                                           "commit")]
    delivered = [j for kind, j in seen if kind == "deliver"]
    require(jobs == order, f"lane: results and commits out of order: {jobs}")
    require(delivered == list(range(n_jobs)),
            f"lane: jobs delivered {delivered}")
    require(subscribe(lane.topic, lane.group, timeout_s=0.2) is None,
            "lane: a job delivered again after its commit")
    require(len(reqs) == n_jobs, f"lane submitted {len(reqs)} requests")
    gaps, exact = [], []
    for request in reqs:
        prompt, ids = rec[request.id]
        g, e = oracle_gap(params, cfg, dev, list(prompt), ids)
        gaps.append(g)
        exact.append(e)
    stats = lane.stats()
    depth = scrape(app.metrics_port).get("app_tpu_qos_lane_depth")
    ticks = lane.cron_ticks
    app._cron._tick(time.localtime())
    t_end = time.monotonic() + 10
    while lane.cron_ticks == ticks and time.monotonic() < t_end:
        time.sleep(0.01)
    log(f"loadgen lane: {n_jobs} greedy jobs x {LG_JOB_TOKENS} tokens beside "
        f"{len(inter)} interactive streams: results in order, commits in "
        f"order, none delivered twice; against the teacher-forced plain "
        f"oracle exact argmax at {min(exact):.3f}-{max(exact):.3f} of "
        f"positions, largest gap {max(gaps):.3e} (tol {MODEL_TOL}); "
        f"lane.stats() {json.dumps(stats)}; app_tpu_qos_lane_depth {depth}; "
        f"cron kick ticks {ticks} -> {lane.cron_ticks} [{card}]")
    require(all(r["status"] == "ok" for r in inter),
            "interactive streams beside the lane not ok")
    require(max(gaps) <= MODEL_TOL, "lane: a stream leaves the oracle's")
    require(stats["completed"] == n_jobs and stats["failed"] == 0
            and stats["rejected"] == 0, f"lane stats {stats}")
    require(depth == 0.0, f"app_tpu_qos_lane_depth {depth}, want 0")
    require(lane.cron_ticks > ticks, "the crontab's tick did not kick the "
            "lane")


def lg_knee(app, base: str, thr: float, seconds: float, card: str) -> None:
    """run_knee from 0.3x to LG_KNEE_UP x the measured throughput, polling
    /debug/capacity: forecast samples, and ``agrees`` (the warning at or
    before the first measured TTFT blowout, or neither)."""
    from gofr_tpu_torch.loadgen import run_knee

    port = app.http_port
    result = run_knee(
        base, lambda: get_json(port, "/debug/capacity"),
        rate0_rps=0.3 * thr, rate1_rps=LG_KNEE_UP * thr, seconds=seconds,
        seed=LG_SEED + 3, poll_s=0.25, drain_timeout_s=600.0,
        request_timeout_s=600.0,
        synth_kw={"tenants": 3, "prompt_tokens": LG_WORDS,
                  "max_new": LG_MAX_NEW})
    outcomes = result["status"]["outcomes"]
    log(f"loadgen knee: {result['ramp']['arrivals']} arrivals ramping "
        f"{0.3 * thr:.3f} -> {LG_KNEE_UP * thr:.3f}/s over {seconds}s; "
        f"outcomes {json.dumps(outcomes)}; {len(result['samples'])} forecast "
        f"samples; quiet baseline TTFT {result['baseline_ttft_ms']} ms, "
        f"blowout at {result['blowout_ttft_ms']} ms first by the arrival at "
        f"t={result['first_blowout_at_s']}s, collapse warning at "
        f"t={result['collapse_warning_at_s']}s, peak rho "
        f"{result['peak_rho']}, replicas_needed "
        f"{result['replicas_needed_final']}; agrees {result['agrees']} "
        f"({result['detail']}) [{card}]")
    require(result["samples"], "the knee got no forecast sample")
    require(result["agrees"], f"the knee disagrees: {result['detail']}")


def loadgen_phase(params, cfg, dev, card: str, short: bool = False,
                  after=None) -> dict:
    """Phase 18 (--loadgen; the default run: short): the main path's engine
    booted with loadgen_env; the datasources' health and round trip, the
    throughput of a closed burst, the open-loop run, its capture replayed
    and compared, the batch lane beside interactive streams, and (full
    mode) the knee. The launch counts are zeroed just before the burst and
    read after the last run: {kernel: launches}. after(app), when given,
    runs on the served App after that (the default run's phase 19)."""
    import shutil
    import tempfile

    from gofr_tpu_torch.ops import launch_counts
    from gofr_tpu_torch.serve import build_app, build_engine

    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="gofr-loadgen-")
    env = loadgen_env(tmp, "true" if short else "wide")
    engine = build_engine(env, device=dev, params=params)
    boot_line(engine, "paged loadgen", card)
    app = build_app(env, engine=engine)
    lg_datasource_route(app)
    app.start()
    base = f"http://127.0.0.1:{app.http_port}"
    try:
        lg_datasources(app, card)
        launch_counts.zero()
        thr = lg_throughput(base, card, short)
        rate = LG_RATE_SHARE * thr
        rows, before = lg_open_loop(app, engine, base, rate,
                                    4.0 if short else 20.0, card, short)
        window = launch_counts.counts()
        log(f"loadgen open loop launches: {json.dumps(window)}")
        require(window["flash_attention"] > 0 and
                window["paged_attention"] > 0,
                "the open loop launched no flash or paged read")
        if not short:
            lg_replay(base, app.http_port, rows, before, card)
        lg_lane(app, engine, params, cfg, dev, base, rate,
                4 if short else LG_JOBS, card, short)
        if not short:
            lg_knee(app, base, thr, 20.0, card)
        launches = launch_counts.counts()
        if after is not None:
            after(app)
    finally:
        app.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"loadgen: phase 18 {time.monotonic() - t_all:.1f}s, launches "
        f"{json.dumps(launches)}")
    return launches


# -- phase 19: the fleet router tier (ROADMAP A18b part 4) --------------------
FL_SEED = 16000          # prompt seeds no other phase uses
FL_SYSTEM_CHARS = 383    # + BOS: a 384-token system prompt, 3 full pages
FL_TURN_CHARS = 40       # what each turn of a session adds
FL_TURN_TOKENS = 32
FL_SESSIONS = 4          # --fleet (the default run: 2, of 2 turns)
FL_TURNS = 3
FL_FAIL_STREAMS = 8
FL_FAIL_TOKENS = 200
FL_FAIL_CHARS = 100
FL_BUDGET = 30 * 2**30   # each replica's HBM_BUDGET_BYTES: two fit the card
FL_LONG_STREAMS = 6      # the autoscaler phase's streams, migrated on calm
FL_LONG_TOKENS = 800
FL_LONG_CHARS = 60
FL_SLACK_S = 2e-3        # the stitched timeline's alignment slack


def fleet_env(tmp: str, name: str, warm: str, buckets: str =
              "16,32,64,128,256,512", window: str = "4") -> dict:
    """A replica of the fleet phase: the main path's serve config with QoS
    and the prefix cache, an explicit HBM_BUDGET_BYTES (two replicas share
    the card; each would otherwise plan for all of it), the capacity
    forecaster's `window` (4 s, phase 18's) and SLO targets the ladder
    never reaches, and
    DRAIN_TIMEOUT=0: its shutdown fails the streams it holds at once, as a
    crash would."""
    return {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
            "HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": name,
            "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
            "PREFILL_BUCKETS": buckets, "REQUEST_TIMEOUT": "600",
            "WARMUP": warm, "QOS": "true", "PREFIX_CACHE": "true",
            "HBM_BUDGET_BYTES": str(FL_BUDGET), "SLO_TTFT_TARGET_S": "10",
            "SLO_TPOT_TARGET_S": "1", "CAPACITY_WINDOW_S": window,
            "CAPACITY_RHO_WARN": "0.5", "DRAIN_TIMEOUT": "0",
            "INCIDENT_DIR": f"{tmp}/incidents-{name}",
            "PROFILE_DIR": f"{tmp}/profiles", **grpc_env()}


def router_env(tmp: str, replicas: dict, **extra) -> dict:
    """The router over `replicas` ({name: App}): the affinity policy, a
    probe every 2 s, the journey, timeline, SLO, capacity and trace planes
    on; ELASTIC off unless `extra` turns it on."""
    return {**QUIET, "HTTP_PORT": "0", "METRICS_PORT": "0",
            "APP_NAME": "router", "REQUEST_TIMEOUT": "600",
            "FLEET_REPLICAS": ",".join(
                f"{n}=http://127.0.0.1:{a.http_port}"
                for n, a in replicas.items()),
            "FLEET_PROBE_S": "2", "ELASTIC": "false",
            "INCIDENT_DIR": f"{tmp}/incidents-router", **extra}


def fl_boot(env, params, dev, card, what):
    from gofr_tpu_torch.serve import build_app, build_engine

    engine = build_engine(env, device=dev, params=params)
    boot_line(engine, what, card)
    app = build_app(env, engine=engine)
    app.start()
    return app


def fl_stream(port, prompt, max_tokens, trace=None, headers=None,
              min_tokens=True) -> dict:
    """POST /generate (SSE) with a traceparent of `trace`: every event
    (text, done or error) and the first token's time."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    if trace is not None:
        hdrs["traceparent"] = f"00-{trace}-00f067aa0ba902b7-01"
    body = {"prompt": prompt, "max_tokens": max_tokens, "stream": True,
            "temperature": 0.0}
    if min_tokens:
        body["min_tokens"] = max_tokens   # every stream its full count
    t0 = time.monotonic()
    conn.request("POST", "/generate", body=json.dumps(body), headers=hdrs)
    resp = conn.getresponse()
    events, first = [], None
    if resp.status != 200:   # the error envelope
        events.append(json.loads(resp.read() or b"null"))
    try:
        while resp.status == 200:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                if first is None and "text" in events[-1]:
                    first = time.monotonic() - t0
                if "done" in events[-1] or "error" in events[-1]:
                    break
    except (OSError, http.client.HTTPException) as exc:
        events.append({"transport": str(exc)})
    conn.close()
    texts = [e["text"] for e in events if "text" in e]
    return {"status": resp.status, "events": events, "texts": texts,
            "ttft": first, "done": bool(events) and "done" in events[-1]}


def fl_same(tok, texts, ids) -> bool:
    """A client's token events are the ids its replica delivered: one
    event a token, the same text (the synthetic vocabulary decodes every
    id to one char, the specials to none)."""
    return len(texts) == len(ids) and "".join(texts) == tok.decode(ids)


def fl_resolve(params, cfg, dev, tok, prompt_ids, texts) -> list:
    """A stream's ids from its SSE events, where no engine of this process
    recorded them: each event's one char encodes back to its id; an empty
    event is one of the specials (PAD, BOS, EOS: a stop token streams on
    under min_tokens), the one the teacher-forced plain oracle ranks
    highest there."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_forward_nocache

    ids = [tok.encode(t, bos=False)[0] if t else None for t in texts]
    plain = dataclasses.replace(cfg, attn_impl="xla", decode_attn="xla",
                                kv_dtype=None)
    for p, i in enumerate(ids):
        if i is None:
            seq = torch.tensor([list(prompt_ids) + ids[:p]], device=dev)
            with torch.no_grad():
                last = llama_forward_nocache(params, plain, seq)[0, -1]
            ids[p] = max((tok.PAD, tok.BOS, tok.EOS),
                         key=lambda c: float(last[c]))
    return ids


def fl_record(apps) -> tuple:
    """record_tokens on every App's engine: ({name: rec}, restore())."""
    emits = {n: a.engine._emit_block for n, a in apps.items()}
    recs = {n: record_tokens(a.engine) for n, a in apps.items()}

    def restore():
        for n, a in apps.items():
            a.engine._emit_block = emits[n]
    return recs, restore


def fl_trace(i: int) -> str:
    return f"{FL_SEED + i:032x}"


def fl_journey(router, trace) -> dict:
    return get_json(router.http_port, f"/debug/journey/{trace}")


def fl_journey_or_none(router, trace) -> list:
    """The attempts of `trace`'s journey so far ([] before it begins)."""
    conn = http.client.HTTPConnection("127.0.0.1", router.http_port,
                                      timeout=60)
    conn.request("GET", f"/debug/journey/{trace}")
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if resp.status != 200:
        return []
    return json.loads(raw)["data"]["journey"]["attempts"]


def fl_served_by(router, trace) -> str:
    return fl_journey(router, trace)["journey"].get("replica")


def fl_sessions(router, n_sessions: int, n_turns: int, seed: int) -> dict:
    """n_sessions sessions, each a system prompt of its own and n_turns
    greedy turns, the sessions concurrent (each started 0.2 s after the
    one before) and each session's turns in order: {(s, k): (prompt, stream, trace)}."""
    out, lock = {}, threading.Lock()

    def session(s):
        prompt = make_prompt(FL_SYSTEM_CHARS, seed + s)
        for k in range(n_turns):
            prompt += make_prompt(FL_TURN_CHARS, seed + 100 + 10 * s + k)
            trace = fl_trace(1000 + 10 * s + k)
            r = fl_stream(router.http_port, prompt, FL_TURN_TOKENS, trace)
            with lock:
                out[(s, k)] = (prompt, r, trace)

    threads = []
    for s in range(n_sessions):
        threads.append(threading.Thread(target=session, args=(s,)))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(600)
    return out


def fl_affinity(router, apps, params, cfg, dev, card, n_sessions, n_turns,
                seed, straight=True) -> dict:
    """The affinity check: every turn of a session lands on one replica
    (read from its journey's hops), the sessions use every replica, each
    landing replica's prefix-cache hits rise, each stream equals the
    teacher-forced oracle within MODEL_TOL and, sent again straight to its
    replica, the same stream (or leaves it at a bf16 tie, check_ties).
    Returns ({session: replica}, {session: its last prompt})."""
    engines = {n: a.engine for n, a in apps.items()}
    hits0 = {n: e.prefix.stats()["hit_pages"] for n, e in engines.items()}
    recs, restore = fl_record(apps)
    try:
        runs = fl_sessions(router, n_sessions, n_turns, seed)
    finally:
        restore()
    landed = {}
    for (s, k), (prompt, r, trace) in sorted(runs.items()):
        require(r["status"] == 200 and r["done"]
                and len(r["texts"]) == FL_TURN_TOKENS,
                f"fleet affinity: session {s} turn {k}: {r['status']} "
                f"{r['events'][-1:]}")
        j = fl_journey(router, trace)
        hops = j["hops"]
        replicas = {h["actor"].split(":")[0] for h in hops
                    if h["actor"] != "router"}
        require(j["complete"] and len(replicas) == 1, f"fleet affinity: "
                f"session {s} turn {k} hops on {replicas}")
        landed.setdefault(s, set()).update(replicas)
    per = {s: next(iter(v)) for s, v in landed.items()}
    require(all(len(v) == 1 for v in landed.values()),
            f"fleet affinity: a session bounced across replicas {landed}")
    require(set(per.values()) == set(apps),
            f"fleet affinity: the sessions used {sorted(set(per.values()))} "
            f"of {sorted(apps)}")
    hits = {n: e.prefix.stats()["hit_pages"] - hits0[n]
            for n, e in engines.items()}
    require(all(hits[n] > 0 for n in set(per.values())),
            f"fleet affinity: prefix-cache hits per replica {hits}")
    # the routed streams' ids, by prompt, from the landing engine
    tok = next(iter(engines.values())).tokenizer
    routed = {}
    for n, rec in recs.items():
        for prompt_ids, ids in list(rec.values()):
            routed[tuple(prompt_ids)] = (n, list(ids))
    gaps, exact = [], []
    for (s, k), (prompt, r, _) in sorted(runs.items()):
        ids = tok.encode(prompt)
        n, got = routed[tuple(ids)]
        require(n == per[s] and fl_same(tok, r["texts"], got),
                f"fleet affinity: session {s} turn {k}: the client's tokens "
                f"are not what {n} delivered")
        g, e = oracle_gap(params, cfg, dev, ids, got)
        gaps.append(g)
        exact.append(e)
    snap = get_json(router.http_port, "/debug/fleet")
    log(f"fleet affinity: {n_sessions} sessions x {n_turns} turns x "
        f"{FL_TURN_TOKENS} tokens on a {FL_SYSTEM_CHARS + 1}-token system "
        f"prompt each: sessions on {json.dumps(per)}, prefix-cache hit pages "
        f"{json.dumps(hits)}; /debug/fleet affinity {json.dumps(snap['affinity'])}"
        f", in flight per replica "
        f"{json.dumps({r['name']: r['inflight'] for r in snap['replicas']})}"
        f", routes {json.dumps(snap['routes'])}; against the teacher-forced "
        f"oracle exact argmax at {min(exact):.3f}-{max(exact):.3f}, largest "
        f"gap {max(gaps):.3e} (tol {MODEL_TOL}) [{card}]")
    require(max(gaps) <= MODEL_TOL, "fleet affinity: a stream leaves the "
            "oracle's")
    require(snap["affinity"]["hits"] >= n_sessions * (n_turns - 1),
            f"fleet affinity: {snap['affinity']}")
    if straight:
        matched, total = 0, 0
        for name in sorted(set(per.values())):
            app = apps[name]
            items = [(s, k, prompt) for (s, k), (prompt, _, _) in
                     sorted(runs.items()) if per[s] == name]
            ids = [tok.encode(p) for _, _, p in items]
            got = [routed[tuple(i)][1] for i in ids]
            recs, restore = fl_record({name: app})
            try:
                for s, k, prompt in items:
                    r = fl_stream(app.http_port, prompt, FL_TURN_TOKENS)
                    require(r["done"], f"fleet straight: {r['events'][-1:]}")
            finally:
                restore()
            again = {tuple(p): list(i) for p, i in recs[name].values()}
            ref = [again[tuple(i)] for i in ids]
            matched += check_ties(app.engine, f"fleet straight {name}", ids,
                                  got, ref)
            total += len(items)
        log(f"fleet affinity: the same {total} requests sent straight to "
            f"their replicas: {matched} equal token for token, the rest at "
            f"a bf16 tie [{card}]")
    last = {s: runs[(s, n_turns - 1)][0] for s in range(n_sessions)}
    return per, last


def fl_open_loop(router, apps, rate, seconds, card) -> list:
    """The seeded trace (3 zipf tenants, all classes, session reuse)
    through OpenLoopRunner against the router: every row ok and full."""
    from gofr_tpu_torch.loadgen import OpenLoopRunner

    events = lg_events(rate, seconds, FL_SEED + 1, False)
    recs, restore = fl_record(apps)
    base = f"http://127.0.0.1:{router.http_port}"
    t0 = time.monotonic()
    runner = OpenLoopRunner(base, events, timeout_s=600.0, label="fleet")
    try:
        rows = runner.run(drain_timeout_s=600.0)
    finally:
        restore()
    wall = time.monotonic() - t0
    merged = {(n, k): v for n, rec in recs.items() for k, v in rec.items()}
    lags = [a["lag_s"] for a in runner.arrivals()]
    log(f"fleet open loop: {len(events)} Poisson arrivals at {rate:.3f}/s "
        f"over {seconds}s through the router (classes "
        f"{sorted({e['class'] for e in events})}, tenants "
        f"{sorted({e['tenant'] for e in events})}, "
        f"{sum(1 for e in events if e.get('turn'))} later turns), wall "
        f"{wall:.1f}s, dispatch lag worst {max(lags) * 1e3:.3f} ms [{card}]")
    eos = next(iter(apps.values())).engine.tokenizer.EOS
    lg_rows_ok("fleet open loop", rows, events, merged, eos)
    lg_scorecard("fleet open loop", rows, card)
    return rows


def fl_replay(router, rows_a, card) -> None:
    """The router's GET /debug/trace: the open loop's arrivals with their
    classes and tenants, replayed, the scorecards compared (no check but
    slo_met may regress)."""
    from gofr_tpu_torch.loadgen import (OpenLoopRunner,
                                        baseline_from_scorecard,
                                        build_scorecard, compare)

    doc = get_json(router.http_port, "/debug/trace")
    events = doc["events"][-len(rows_a):]
    t0 = min(e["t"] for e in events)
    for e in events:
        e["t"] = round(e["t"] - t0, 6)
    want = sorted((r.get("class"), r.get("tenant")) for r in rows_a)
    got = sorted((e.get("class"), e.get("tenant")) for e in events)
    require(got == want, "fleet replay: the router's trace lost classes or "
            "tenants")
    rows_b = OpenLoopRunner(f"http://127.0.0.1:{router.http_port}", events,
                            timeout_s=600.0, label="replay").run(
                                drain_timeout_s=600.0)
    require(all(r["status"] == "ok" for r in rows_b), "replay rows not ok")
    sc = lg_scorecard("fleet replay", rows_b, card)
    result = compare(sc, baseline_from_scorecard(build_scorecard(rows_a)))
    for c in result["checks"]:
        log(f"fleet replay compare: {json.dumps(c)}")
    drifted = [c for c in result["checks"]
               if c.get("metric") != "slo_met" and c["verdict"] == "regress"]
    log(f"fleet replay: {len(events)} captured arrivals (classes and "
        f"tenants kept) replayed through the router, verdict "
        f"{result['verdict']}, {len(drifted)} checks regress beyond slo_met "
        f"[{card}]")
    require(not drifted, f"fleet replay drifted: {drifted}")


def fl_knee(router, thr, seconds, card) -> None:
    """run_knee through the router from 0.3x to LG_KNEE_UP x the measured
    throughput, polling /debug/fleet/capacity: samples, ``agrees``, and
    replicas_needed an integer of at least 1 in every sample."""
    from gofr_tpu_torch.loadgen import run_knee

    port = router.http_port
    result = run_knee(
        f"http://127.0.0.1:{port}",
        lambda: get_json(port, "/debug/fleet/capacity"),
        rate0_rps=0.3 * thr, rate1_rps=LG_KNEE_UP * thr, seconds=seconds,
        seed=FL_SEED + 3, poll_s=0.25, drain_timeout_s=600.0,
        request_timeout_s=600.0,
        synth_kw={"tenants": 3, "prompt_tokens": LG_WORDS,
                  "max_new": LG_MAX_NEW})
    samples = result["samples"]
    require(samples, "the fleet knee got no forecast sample")
    needed = [s.get("replicas_needed") for s in samples]
    peak = max(samples, key=lambda s: s.get("rho") or 0.0)
    log(f"fleet knee: {result['ramp']['arrivals']} arrivals ramping "
        f"{0.3 * thr:.3f} -> {LG_KNEE_UP * thr:.3f}/s over {seconds}s "
        f"through the router; outcomes "
        f"{json.dumps(result['status']['outcomes'])}; {len(samples)} "
        f"samples of /debug/fleet/capacity; quiet baseline TTFT "
        f"{result['baseline_ttft_ms']} ms, blowout at "
        f"{result['blowout_ttft_ms']} ms first by the arrival at "
        f"t={result['first_blowout_at_s']}s, collapse warning at "
        f"t={result['collapse_warning_at_s']}s; replicas_needed quiet "
        f"{needed[0]}, at the peak rho {peak.get('rho')}: "
        f"{peak.get('replicas_needed')}, final "
        f"{result['replicas_needed_final']}; agrees {result['agrees']} "
        f"({result['detail']}) [{card}]")
    require(all(isinstance(n, int) and n >= 1 for n in needed),
            f"fleet knee: replicas_needed {needed}")
    require(result["agrees"], f"the fleet knee disagrees: {result['detail']}")


def fl_planes(router, names, card) -> None:
    """One routed request: its journey holds the router's hops and the
    replica's queue, prefill and decode; its stitched timeline has >= 2
    pids and the replica's flow events inside the router's route-to-finish
    window; /debug/fleet/slo merges every replica."""
    trace = fl_trace(1)
    r = fl_stream(router.http_port, make_prompt(120, FL_SEED + 1), 16, trace)
    require(r["done"], f"fleet planes: {r['events'][-1:]}")
    deadline = time.monotonic() + 10
    while (fl_journey(router, trace)["journey"].get("outcome") is None
           and time.monotonic() < deadline):
        time.sleep(0.05)
    j = fl_journey(router, trace)
    kinds = {(h["actor"] == "router", h["hop"]) for h in j["hops"]}
    want = {(True, "route"), (True, "stream"), (True, "finish"),
            (False, "queue"), (False, "prefill"), (False, "decode")}
    require(j["complete"] and want <= kinds, f"fleet journey: {kinds}")
    t = get_json(router.http_port, f"/debug/fleet/timeline/{trace}")
    events = t["traceEvents"]
    pids = {ev["pid"] for ev in events}
    route = [ev for ev in events if ev["pid"] == 1 and ev.get("ph") == "X"]
    lo = min(ev["ts"] for ev in route)
    hi = max(ev["ts"] + ev.get("dur", 0) for ev in route)
    flows = [ev["ts"] for ev in events if ev["pid"] != 1
             and ev.get("cat") == "flow" and ev.get("id") == trace]
    slo = get_json(router.http_port, "/debug/fleet/slo")
    log(f"fleet planes: journey {[h['hop'] for h in j['hops']]} complete "
        f"{j['complete']}; timeline pids {t['pids']} ({len(events)} events), "
        f"the replica's {len(flows)} flow events at "
        f"{(min(flows) - lo) / 1e3:.3f}..{(max(flows) - lo) / 1e3:.3f} ms "
        f"into the router's {(hi - lo) / 1e3:.3f} ms route-to-finish "
        f"window; /debug/fleet/slo states {json.dumps(slo['fleet_states'])}"
        f", replicas {sorted(slo['replicas'])} [{card}]")
    require(len(pids) >= 2 and t["complete"], f"fleet timeline: {t['pids']} "
            f"missing {t['missing']}")
    require(flows and lo - FL_SLACK_S * 1e6 <= min(flows)
            and max(flows) <= hi + FL_SLACK_S * 1e6,
            "fleet timeline: the replica's events lie outside the router's "
            "window")
    require(set(slo["replicas"]) == set(names) and not any(
        "error" in row for row in slo["replicas"].values()),
        f"fleet slo: {slo['replicas']}")


def fl_close_server(app) -> None:
    """Stop the App's listener (new connections refused), its streams in
    flight untouched."""
    app._http_server.shutdown()
    app._http_server = None


def fl_failover(router, apps, victim, pinned, card) -> None:
    """FL_FAIL_STREAMS streams through the router, then `victim` crashes
    (its listener closed, then its App shut down with DRAIN_TIMEOUT=0):
    no stream sent twice and no event repeated, each client's tokens what
    its replica delivered; a stream broken on the victim ends with a
    stream_break hop; `pinned` (a session prompt whose affinity is on the
    victim) sent between the two, unstarted, is retried on the other
    replica and completes; the router's health reads DEGRADED and
    /debug/fleet shows the victim ejected."""
    tok = apps[victim].engine.tokenizer
    recs, restore = fl_record(apps)
    out, threads = {}, []
    prompts = [make_prompt(FL_FAIL_CHARS + 10 * i, FL_SEED + 300 + i)
               for i in range(FL_FAIL_STREAMS)]

    def go(i):
        out[i] = fl_stream(router.http_port, prompts[i], FL_FAIL_TOKENS,
                           fl_trace(300 + i))
    for i in range(FL_FAIL_STREAMS):
        threads.append(threading.Thread(target=go, args=(i,)))
        threads[-1].start()
    wait_for(lambda: any(len(v[1]) >= 8 for v in recs[victim].values())
             or all(not t.is_alive() for t in threads),
             "a stream decoding on the victim", 120)
    fl_close_server(apps[victim])
    pinned_out = {}
    pin = threading.Thread(target=lambda: pinned_out.update(fl_stream(
        router.http_port, pinned, FL_TURN_TOKENS, fl_trace(399))))
    pin.start()
    # its first attempt refused by the closed listener, then the crash
    wait_for(lambda: len(fl_journey_or_none(router, fl_trace(399))) >= 2,
             "the pinned request's retry", 30)
    t_crash = time.monotonic()
    apps[victim].shutdown()
    crash_s = time.monotonic() - t_crash
    for t in threads + [pin]:
        t.join(600)
    retried = pinned_out
    restore()
    served = {}
    for n, rec in recs.items():
        for prompt_ids, ids in rec.values():
            served.setdefault(tuple(prompt_ids), []).append((n, list(ids)))
    broken = []
    for i, p in enumerate(prompts):
        r = out[i]
        runs = served.get(tuple(tok.encode(p)), [])
        require(len(runs) == 1, f"fleet fail-over: stream {i} served "
                f"{len(runs)} times: {[n for n, _ in runs]}")
        n, ids = runs[0]
        got = r["texts"]
        j = fl_journey(router, fl_trace(300 + i))
        if r["done"]:
            require(len(got) == FL_FAIL_TOKENS and fl_same(tok, got, ids),
                    f"fleet fail-over: stream {i} on {n} delivered "
                    f"{len(got)} tokens, not its {len(ids)}")
        else:
            broken.append(i)
            terminal = [h for h in j["hops"] if h["actor"] == "router"][-1]
            require(n == victim and fl_same(tok, got, ids[:len(got)])
                    and "error" in r["events"][-1]
                    and terminal["hop"] == "stream_break",
                    f"fleet fail-over: stream {i} broke on {n} with "
                    f"{len(got)} of {len(ids)} tokens, terminal "
                    f"{terminal['hop']}, last event {r['events'][-1:]}")
    attempts = fl_journey(router, fl_trace(399))["journey"]["attempts"]
    require(retried["done"] and len(retried["texts"]) == FL_TURN_TOKENS
            and len(attempts) >= 2 and attempts[0]["replica"] == victim
            and attempts[0]["outcome"] != "committed"
            and attempts[-1]["outcome"] == "committed"
            and attempts[-1]["replica"] != victim,
            f"fleet fail-over: the pinned unstarted request: {attempts}, "
            f"{retried['events'][-1:]}")
    snap = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        snap = get_json(router.http_port, "/debug/fleet")
        row = next(r for r in snap["replicas"] if r["name"] == victim)
        if not row["available"]:
            break
        time.sleep(0.2)
    health = [get_json(router.http_port, "/.well-known/health")
              for _ in range(2)]
    log(f"fleet fail-over: {FL_FAIL_STREAMS} streams x {FL_FAIL_TOKENS} "
        f"tokens, {victim} crashed in {crash_s:.2f}s: {len(broken)} streams "
        f"broke on it (stream_break, each a prefix of what it delivered), "
        f"{FL_FAIL_STREAMS - len(broken)} complete, none sent twice; the "
        f"pinned unstarted request {[(a['replica'], a['outcome']) for a in attempts]}; "
        f"/debug/fleet {victim} {json.dumps({k: row[k] for k in ('state', 'available', 'breaker_open', 'probe_error')})}"
        f"; health {[h['status'] for h in health]} (fleet "
        f"{health[-1]['details']['fleet']['status']}) [{card}]")
    require(broken, "fleet fail-over: no stream was on the victim")
    require(not row["available"], f"fleet fail-over: {victim} not ejected")
    require(health[-1]["status"] == "DEGRADED"
            and health[-1]["details"]["fleet"]["status"] == "DEGRADED",
            f"fleet fail-over: health {health[-1]}")


def fl_rejoin(router, env, params, dev, card, name) -> object:
    """Boot `name` again on its port (WARMUP=true): it is probed back in
    and takes a request of 4 new sessions sent at once."""
    port = int(env["HTTP_PORT"])
    t0 = time.monotonic()
    app = fl_boot(env, params, dev, card, f"fleet {name} again")
    require(app.http_port == port, "fleet rejoin: another port")
    wait_for(lambda: next(r for r in get_json(router.http_port,
                                              "/debug/fleet")["replicas"]
                          if r["name"] == name)["available"],
             f"{name} probed back in", 60)
    out, threads = {}, []
    for i in range(4):
        threads.append(threading.Thread(target=lambda i=i: out.__setitem__(
            i, fl_stream(router.http_port, make_prompt(80, FL_SEED + 400 + i),
                         16, fl_trace(400 + i)))))
        threads[-1].start()
    for t in threads:
        t.join(600)
    on = [fl_served_by(router, fl_trace(400 + i)) for i in range(4)]
    log(f"fleet rejoin: {name} booted again in {time.monotonic() - t0:.1f}s "
        f"on port {port}, probed back in; 4 new sessions landed on {on} "
        f"[{card}]")
    require(all(r["done"] for r in out.values()), "fleet rejoin: a stream "
            "failed")
    require(name in on, f"fleet rejoin: {name} took no request")
    return app


def fl_autoscale(params, cfg, dev, card, tmp, rate) -> dict:
    """The autoscaler: a router over r0 alone with ELASTIC on,
    ELASTIC_LAUNCHER=subprocess and ELASTIC_LAUNCH_CMD="python -m
    gofr_tpu_torch.serve" (min 1, max 2, short holds; CAPACITY_TARGET_RHO
    0.05, so the open-loop demand at `rate` asks for a second replica and
    its end for one). Sustained demand launches exactly one replica, which
    boots on the card as a process of its own (its card memory seen in
    mem_get_info) and becomes routable; FL_LONG_STREAMS greedy streams
    then start, at least one on the child, the demand stops, and calm
    drains the child with its live sessions migrated to r0: every stream
    complete and within MODEL_TOL of the teacher-forced oracle; the child
    exits and its card memory is freed. Buckets reach 1024, so a migrated
    session's resume window fits one, and the forecasters' window is 2 s,
    so calm comes soon after the last arrival. Returns {"launches": ...,
    "boot_s": ...}."""
    import torch

    from gofr_tpu_torch import serve_router
    from gofr_tpu_torch.ops import launch_counts

    buckets = "16,32,64,128,256,512,1024"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_base = s.getsockname()[1]
    r0 = fl_boot(fleet_env(tmp, "r0", "true", buckets, "2"), params, dev,
                 card, "fleet autoscale r0")
    router = serve_router.build_app(router_env(
        tmp, {"r0": r0}, ELASTIC="true", ELASTIC_LAUNCHER="subprocess",
        ELASTIC_LAUNCH_CMD="python -m gofr_tpu_torch.serve",
        ELASTIC_PORT_BASE=str(port_base), ELASTIC_MIN_REPLICAS="1",
        ELASTIC_MAX_REPLICAS="2", ELASTIC_INTERVAL_S="0.5",
        ELASTIC_UP_HOLD_S="2", ELASTIC_DOWN_HOLD_S="1",
        ELASTIC_COOLDOWN_S="3", DRAIN_TIMEOUT_S="120",
        CAPACITY_TARGET_RHO="0.05", FLEET_PROBE_S="0.5"))
    scaler = router.autoscaler
    launcher = scaler.launcher
    launcher.env = {k: v for k, v in fleet_env(tmp, "auto0", "true",
                                               buckets, "2").items()
                    if k not in ("HTTP_PORT", "METRICS_PORT")}
    launcher.log_dir = f"{tmp}/children"
    drains = []
    drain = scaler.drain
    scaler.drain = lambda *a, **k: drains.append(drain(*a, **k)) or drains[-1]
    registry = router.fleet.registry
    stop, sent = threading.Event(), []
    tok = r0.engine.tokenizer
    out, threads, proc = {}, [], None
    try:
        router.start()
        port = router.http_port
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
        launch_counts.zero()

        def demand():
            i = 0
            while not stop.is_set():
                threading.Thread(target=lambda i=i: sent.append(fl_stream(
                    port, make_prompt(40, FL_SEED + 500 + i), 16,
                    min_tokens=False)), daemon=True).start()
                i += 1
                stop.wait(1.0 / rate)
        threading.Thread(target=demand, daemon=True).start()
        t0 = time.monotonic()
        deadline = time.monotonic() + 120
        while (scaler.scale_events["up"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.1)
        require(scaler.scale_events["up"] == 1, f"fleet autoscale: no "
                f"launch; capacity {get_json(port, '/debug/fleet/capacity')['fleet']}"
                f", decisions {scaler.snapshot()['decisions'][-3:]}")
        t_launch = time.monotonic() - t0
        proc = launcher._procs.get("auto0")
        require(proc is not None, "the launcher holds no auto0 process")

        def serving():
            r = registry.replica("auto0")
            if proc.poll() is not None:
                log_tail = open(f"{tmp}/children/auto0.log",
                                errors="replace").read()[-4000:]
                raise RuntimeError(f"auto0 exited {proc.returncode}: "
                                   f"{log_tail}")
            return r is not None and r.available()
        wait_for(serving, "auto0 serving", 600)
        t_boot = time.monotonic() - t0 - t_launch
        free1 = torch.cuda.mem_get_info()[0]
        prompts = [make_prompt(FL_LONG_CHARS + 5 * i, FL_SEED + 600 + i)
                   for i in range(FL_LONG_STREAMS)]

        def go(i):
            out[i] = fl_stream(port, prompts[i], FL_LONG_TOKENS,
                               fl_trace(600 + i))
        for i in range(FL_LONG_STREAMS):
            threads.append(threading.Thread(target=go, args=(i,)))
            threads[-1].start()
            time.sleep(0.05)
        wait_for(lambda: all(fl_journey(router, fl_trace(600 + i))[
            "journey"].get("replica") for i in range(FL_LONG_STREAMS)),
            "the long streams committed", 60)
        on = [fl_served_by(router, fl_trace(600 + i))
              for i in range(FL_LONG_STREAMS)]
        stop.set()
        t_calm = time.monotonic()
        require("auto0" in on, f"fleet autoscale: no long stream on auto0: "
                f"{on}")
        wait_for(lambda: scaler.scale_events["down"] >= 1
                 and registry.replica("auto0") is None,
                 "auto0 drained and removed", 300)
        t_drain = time.monotonic() - t_calm
        for t in threads:
            t.join(600)
        wait_for(lambda: proc.poll() is not None, "auto0's exit", 60)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free2 = torch.cuda.mem_get_info()[0]
        launches = launch_counts.counts()
        gaps, exact = [], []
        for i, p in enumerate(prompts):
            r = out[i]
            require(r["done"] and len(r["texts"]) == FL_LONG_TOKENS,
                    f"fleet autoscale: stream {i} on {on[i]}: "
                    f"{len(r['texts'])} tokens, {r['events'][-1:]}")
            ids = tok.encode(p)
            g, e = oracle_gap(params, cfg, dev, ids, fl_resolve(
                params, cfg, dev, tok, ids, r["texts"]))
            gaps.append(g)
            exact.append(e)
        result = drains[0] if drains else {}
        status = result.get("status") or {}
        # the reconciler's decisions (on time.monotonic) from the calm on:
        # (s after it, needed, action or reason)
        calm = [(round(d["t"] - t_calm, 2), d["needed"],
                 d["action"] if d["action"] != "none" else d["reason"])
                for d in scaler.decisions if d["t"] >= t_calm - 1.0]
        log(f"fleet autoscale: demand at {rate:.3f}/s launched auto0 after "
            f"{t_launch:.1f}s (python -m gofr_tpu_torch.serve, pid "
            f"{proc.pid}), serving {t_boot:.1f}s later; card free "
            f"{free0 / 2**30:.2f} -> {free1 / 2**30:.2f} GiB with the child; "
            f"{FL_LONG_STREAMS} streams x {FL_LONG_TOKENS} tokens on {on}; "
            f"calm drained auto0 {t_drain:.1f}s after the demand stopped: "
            f"drained {result.get('drained')}, removed "
            f"{result.get('removed')}, outcomes "
            f"{json.dumps(status.get('outcomes'))}, sessions "
            f"{json.dumps(status.get('sessions'))}; the child exited "
            f"{proc.returncode}, card free {free2 / 2**30:.2f} GiB; "
            f"scale events {json.dumps(scaler.scale_events)}; the streams "
            f"against the teacher-forced oracle: exact argmax at "
            f"{min(exact):.3f}-{max(exact):.3f}, largest gap "
            f"{max(gaps):.3e} (tol {MODEL_TOL}); {len(sent)} demand "
            f"requests, {sum(1 for r in sent if r['done'])} ok; decisions "
            f"from the calm on {calm} [{card}]")
        require(scaler.scale_events == {"up": 1, "down": 1},
                f"fleet autoscale: scale events {scaler.scale_events}")
        require(result.get("drained") is True and result.get("removed"),
                f"fleet autoscale: drain {result}")
        require((status.get("outcomes") or {}).get("shipped", 0) >= 1,
                f"fleet autoscale: no session migrated: {status}")
        require(max(gaps) <= MODEL_TOL, "fleet autoscale: a stream leaves "
                "the oracle's")
        require(free1 < free0 - 8 * 2**30, "fleet autoscale: the child "
                "holds no card memory")
        require(free2 > free1 + 8 * 2**30, "fleet autoscale: the child's "
                "card memory was not freed")
        return {"launches": launches, "boot_s": t_boot}
    finally:
        stop.set()
        router.shutdown()
        r0.shutdown()
        if proc is not None and proc.poll() is None:
            proc.kill()


def fleet_phase(params, cfg, dev, card) -> dict:
    """Phase 19 (--fleet): two replicas of the main path in this process
    (full depth, WARMUP=wide, one params tree), the router
    (serve_router.build_app) over them; affinity, the open loop, its
    replay and the knee through the router, the planes, the fail-over and
    the rejoin, then the autoscaler. The launch counts are zeroed before
    the affinity sessions and read after the fail-over, and again for the
    autoscaler: {"routed": ..., "autoscale": ...}."""
    import shutil
    import tempfile

    import torch

    from gofr_tpu_torch import serve_router
    from gofr_tpu_torch.ops import launch_counts

    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="gofr-fleet-")
    apps, router = {}, None
    try:
        for name in ("r0", "r1"):
            apps[name] = fl_boot(fleet_env(tmp, name, "wide"), params, dev,
                                 card, f"fleet {name}")
        router = serve_router.build_app(router_env(tmp, apps))
        router.start()
        base = f"http://127.0.0.1:{router.http_port}"
        launch_counts.zero()
        per, last = fl_affinity(router, apps, params, cfg, dev, card,
                                FL_SESSIONS, FL_TURNS, FL_SEED)
        thr = lg_throughput(base, card, False)
        rows = fl_open_loop(router, apps, LG_RATE_SHARE * thr, 20.0, card)
        fl_replay(router, rows, card)
        fl_knee(router, thr, 20.0, card)
        fl_planes(router, list(apps), card)
        victim = "r1"
        s = next(s for s, n in per.items() if n == victim)
        # a short next turn: the session's window stays within 512
        pinned = last[s] + make_prompt(8, FL_SEED + 200)
        port = apps[victim].http_port
        fl_failover(router, apps, victim, pinned, card)
        routed = launch_counts.counts()
        log(f"fleet launches (the affinity, open-loop, replay, knee, planes "
            f"and fail-over runs): {json.dumps(routed)}")
        require(routed["flash_attention"] > 0
                and routed["paged_attention"] > 0,
                "the routed traffic launched no flash or paged read")
        env = {**fleet_env(tmp, victim, "true"), "HTTP_PORT": str(port)}
        apps[victim] = fl_rejoin(router, env, params, dev, card, victim)
    finally:
        if router is not None:
            router.shutdown()
        for app in apps.values():
            app.shutdown()
    apps.clear()
    torch.cuda.empty_cache()
    try:
        auto = fl_autoscale(params, cfg, dev, card, tmp,
                            LG_RATE_SHARE * thr / 2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"fleet: phase 19 {time.monotonic() - t_all:.1f}s, launches routed "
        f"{json.dumps(routed)}, autoscale {json.dumps(auto['launches'])}")
    return {"routed": routed, "autoscale": auto["launches"]}


def fleet_short(app0, params, cfg, dev, card) -> dict:
    """Phase 19 in short (the default run), on phase 18's short server
    (CUT_DEPTH layers, WARMUP=true) and one more replica like it: the
    router over both, 2 affinity sessions of 2 turns, then the second
    replica's listener closed and a session turn pinned to it sent,
    retried unstarted on the first and complete, its journey the router's
    and the first replica's hops; then its shutdown. The launch counts
    zeroed before the sessions and read after: {kernel: launches}."""
    import shutil
    import tempfile

    from gofr_tpu_torch import serve_router
    from gofr_tpu_torch.ops import launch_counts

    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="gofr-fleet-")
    apps = {"r0": app0}
    router, r1_down = None, False
    try:
        apps["r1"] = fl_boot(fleet_env(tmp, "r1", "true"), params, dev, card,
                             "fleet r1")
        # no probe before the pinned request: the registry still lists r1
        router = serve_router.build_app(router_env(tmp, apps,
                                                   FLEET_PROBE_S="30"))
        router.start()
        launch_counts.zero()
        per, last = fl_affinity(router, apps, params, cfg, dev, card, 2, 2,
                                FL_SEED + 700, straight=False)
        s = next(s for s, n in per.items() if n == "r1")
        fl_close_server(apps["r1"])
        trace = fl_trace(799)
        r = fl_stream(router.http_port,
                      last[s] + make_prompt(FL_TURN_CHARS, FL_SEED + 799),
                      FL_TURN_TOKENS, trace)
        r1_down = True
        apps["r1"].shutdown()
        j = fl_journey(router, trace)
        attempts = [(a["replica"], a["outcome"])
                    for a in j["journey"]["attempts"]]
        hops = {(h["actor"].split(":")[0], h["hop"]) for h in j["hops"]}
        launches = launch_counts.counts()
        log(f"fleet short: the pinned turn after r1's listener closed: "
            f"attempts {attempts}, {len(r['texts'])} tokens, journey "
            f"complete {j['complete']} with {sorted(hops)}; launches "
            f"{json.dumps(launches)}; {time.monotonic() - t_all:.1f}s "
            f"[{card}]")
        require(r["done"] and len(r["texts"]) == FL_TURN_TOKENS,
                f"fleet short: the pinned turn {r['events'][-1:]}")
        require(attempts[0][0] == "r1" and attempts[0][1] != "committed"
                and attempts[-1] == ("r0", "committed"),
                f"fleet short: attempts {attempts}")
        require(j["complete"] and {("router", "route"), ("r0", "queue"),
                                   ("r0", "prefill"), ("r0", "decode")}
                <= hops, f"fleet short: journey hops {sorted(hops)}")
        require(launches["flash_attention"] > 0
                and launches["paged_attention"] > 0,
                "fleet short: no flash or paged-read launch")
        return launches
    finally:
        if router is not None:
            router.shutdown()
        if "r1" in apps and not r1_down:
            apps["r1"].shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 20: the serving surfaces and the device client (A18b parts 5-6) ----
SF_SEED = 17000          # prompt seeds no other phase uses
SF_CHARS = (130, 150, 170, 190, 210, 230, 250, 140)   # + BOS: 131-251 tokens
SF_TOKENS = 32
SF_SEQUENTIAL = 4        # prompts sent alone over SSE, then over gRPC
SF_KEY = "surfaces-key"
SF_WEDGE_S = 8.0         # the probe wedge (--surfaces): two reads at 3 s time out
SF_LEVEL_S = 1.0         # REMOTE_LOG_FETCH_INTERVAL of the served App


def surface_modules(card: str) -> dict:
    """Which of the serving surfaces' optional packages import here."""
    mods = {name: have_module(name) for name in (
        "grpc", "google.protobuf", "cryptography", "requests")}
    log("surfaces: packages on this machine: " + ", ".join(
        f"{k} {'yes' if v else 'no'}" for k, v in mods.items())
        + f" [{card}]")
    if not mods["grpc"]:
        log("surfaces: grpc is not installed here: the gRPC checks are "
            "skipped (gRPC is held on the CPU only); the kernels go through "
            "SSE")
    return mods


class LevelStub:
    """A local HTTP endpoint serving the reference's level payload,
    ``{"data": [{"serviceName": ..., "logLevel": {"LOG_LEVEL": level}}]}``,
    with `level` settable."""

    def __init__(self, level: str):
        import http.server

        stub = self
        self.level = level

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                raw = json.dumps({"data": [{
                    "serviceName": "surfaces",
                    "logLevel": {"LOG_LEVEL": stub.level}}]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/level"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def surfaces_env(tmp: str, warm: str, level_url: str) -> dict:
    """The main path's serve config (full width; paged, WARMUP=`warm`)
    with the surfaces on: gRPC on a free port, the device client
    (TPU_ENABLED), the fault plane, sampling controls (top_k), the remote
    log level polled every SF_LEVEL_S; the prefix cache off, so a prompt
    sent twice runs the same admission wave both times."""
    return {**QUIET, "MODEL_PRESET": "llama3-8b", "ATTN_IMPL": "flash",
            "HTTP_PORT": "0", "METRICS_PORT": "0", "MAX_BATCH": "8",
            "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
            "PREFILL_BUCKETS": "16,32,64,128,256", "REQUEST_TIMEOUT": "600",
            "WARMUP": warm, "PREFIX_CACHE": "false",
            "SAMPLING_CONTROLS": "true", "TPU_ENABLED": "true",
            "FAULT_INJECTION": "true", "REMOTE_LOG_URL": level_url,
            "REMOTE_LOG_FETCH_INTERVAL": str(SF_LEVEL_S),
            "INCIDENT_DIR": f"{tmp}/incidents",
            "PROFILE_DIR": f"{tmp}/profiles", **grpc_env()}


def grpc_request(port, prompt, max_tokens, out, key, extra=None):
    """gRPC llm.Generator/Generate: records the text messages' arrival
    times, the text, the done summary and the status code's name."""
    import grpc

    from gofr_tpu_torch.grpcx import GRPCClient

    client = GRPCClient(f"127.0.0.1:{port}")
    t0 = time.monotonic()
    times, text, done, code = [], [], None, "OK"
    try:
        for msg in client.stream("llm.Generator", "Generate",
                                 {"prompt": prompt, "max_tokens": max_tokens,
                                  **(extra or {})}, timeout_s=600):
            if msg.get("done"):
                done = msg
                continue
            times.append(time.monotonic() - t0)
            text.append(msg["text"])
    except grpc.RpcError as exc:
        code = exc.code().name
    finally:
        client.close()
    out[key] = {"code": code, "times": times, "text": "".join(text),
                "done": done}


class ProbeLoop:
    """Polls a device client's health_check on a thread until stopped:
    (status, seconds) per poll."""

    def __init__(self, client, every_s: float = 0.02):
        self.client, self.every_s = client, every_s
        self.polls: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            h = self.client.health_check()
            self.polls.append((h.status, time.monotonic() - t0))
            self._stop.wait(self.every_s)

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(timeout=30)
        return self.polls


class LaunchTally:
    """The card's kernel launches split by transport: each segment runs
    from an idle engine to an idle engine (so no other segment's blocks in
    flight land in it), and its counts join its kind's."""

    def __init__(self, engine):
        self.engine = engine
        self.kinds: dict = {}

    def run(self, kind: str, fn, *args, **kw):
        from gofr_tpu_torch.ops import launch_counts

        wait_idle(self.engine)
        launch_counts.zero()
        try:
            return fn(*args, **kw)
        finally:
            wait_idle(self.engine)
            tot = self.kinds.setdefault(kind, {})
            for k, v in launch_counts.counts().items():
                tot[k] = tot.get(k, 0) + v

    def of(self, kind: str) -> dict:
        return dict(self.kinds.get(kind, {}))

    def total(self) -> dict:
        out: dict = {}
        for counts in self.kinds.values():
            for k, v in counts.items():
                out[k] = out.get(k, 0) + v
        return out


def sf_pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))] if v else float("nan")


def sf_streams(port, prompts, n_tok, transport: str, headers) -> tuple:
    """All `prompts` at once over `transport` ("grpc" or "sse"): (out,
    wall s)."""
    out: dict = {}
    threads = [threading.Thread(
        target=grpc_request if transport == "grpc" else stream_request,
        args=(port, p, n_tok, out, i),
        kwargs={} if transport == "grpc" else {"headers": headers})
        for i, p in enumerate(prompts)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    require(all(not t.is_alive() for t in threads),
            f"surfaces: {transport} streams hung")
    return out, time.monotonic() - t0


def sf_client_line(what, out, n_tok, card) -> dict:
    """TTFT p50 / max, TPOT p50 and tok/s per stream p50 (client-side)."""
    ttft = [out[i]["times"][0] * 1e3 for i in out]
    tpot = [(out[i]["times"][-1] - out[i]["times"][0]) * 1e3
            / max(len(out[i]["times"]) - 1, 1) for i in out]
    tps = [1e3 / t for t in tpot]
    log(f"surfaces {what}: {len(out)} concurrent streams x {n_tok} tokens: "
        f"ttft_ms p50={sf_pct(ttft, 0.5):.1f} max={max(ttft):.1f}; tpot_ms "
        f"p50={sf_pct(tpot, 0.5):.2f} max={max(tpot):.2f}; tok/s per "
        f"stream p50={sf_pct(tps, 0.5):.1f} min={min(tps):.1f} [{card}]")
    return {"ttft_p50": sf_pct(ttft, 0.5), "tpot_p50": sf_pct(tpot, 0.5),
            "tps_p50": sf_pct(tps, 0.5)}


def sf_health(port) -> dict:
    t0 = time.monotonic()
    body = get_json(port, "/.well-known/health")
    body["_seconds"] = time.monotonic() - t0
    return body


def sf_wedge(app, client, card: str, wedge_s: float) -> None:
    """A device.health_probe wedge posted to /debug/faults: the health
    answers within the probe's timeout with tpu DEGRADED (the aggregate at
    the second read), then UP once the wedge ends."""
    status, _, body = post_json(app.http_port, "/debug/faults", {"plan": [
        {"site": "device.health_probe", "action": "wedge",
         "delay_s": wedge_s, "times": 1}]}, {"X-API-Key": SF_KEY})
    require(status == 201, f"surfaces: /debug/faults answered {status}: "
            f"{body}")
    reads = [sf_health(app.http_port) for _ in range(2)]
    timeout = client.HEALTH_PROBE_TIMEOUT_S
    tpu = [r["details"]["tpu"]["status"] for r in reads]
    t0 = time.monotonic()
    client._probe_thread.join(timeout=wedge_s + 30)
    back = sf_health(app.http_port)
    log(f"surfaces probe: a {wedge_s:.1f}s wedge of device.health_probe: "
        f"tpu {tpu} answered in {[round(r['_seconds'], 3) for r in reads]}s "
        f"(probe timeout {timeout:.1f}s), aggregate {reads[-1]['status']}; "
        f"after the wedge ({time.monotonic() - t0:.2f}s more) tpu "
        f"{back['details']['tpu']['status']}, aggregate {back['status']} "
        f"[{card}]")
    require(tpu == ["DEGRADED", "DEGRADED"]
            and reads[-1]["status"] == "DEGRADED"
            and all(r["_seconds"] <= timeout + 1.0 for r in reads),
            f"surfaces: the wedged probe read {tpu}")
    require(back["details"]["tpu"]["status"] == "UP"
            and back["status"] == "UP", "surfaces: the probe did not come "
            "back UP after the wedge")


def sf_top_k(app, params, cfg, dev, prompt, greedy: dict, card) -> None:
    """top_k=1 at temperature 1 keeps one token a step: the greedy stream;
    where they part, the two tokens must tie on the card's bf16 logits
    (both within MODEL_TOL of the teacher-forced oracle's top)."""
    out: dict = {}
    rec = record_tokens(app.engine)
    grpc_request(app.grpc_port, prompt, SF_TOKENS, out, "k1",
                 {"temperature": 1.0, "top_k": 1})
    got, want = out["k1"], greedy
    require(got["code"] == "OK", f"surfaces: top_k=1 answered {got['code']}")
    same = got["text"] == want["text"]
    note = "equal to greedy"
    if not same:
        ((prompt_ids, ids),) = rec.values()
        gap, exact = oracle_gap(params, cfg, dev, list(prompt_ids), ids)
        note = (f"parts from greedy at a tie: the top_k stream's largest gap "
                f"to the oracle's top {gap:.3e} (tol {MODEL_TOL}), exact "
                f"{exact:.3f}")
        require(gap <= MODEL_TOL, f"surfaces: top_k=1 leaves greedy: {note}")
    log(f"surfaces top_k: top_k=1 at temperature 1 over gRPC, "
        f"{len(got['times'])} tokens: {note} [{card}]")


def sf_cancel(app, engine, card) -> None:
    """A gRPC stream cancelled after its 4th message: its slot and pages
    come back (the prefix cache is off: every page)."""
    from gofr_tpu_torch.grpcx import GRPCClient

    client = GRPCClient(f"127.0.0.1:{app.grpc_port}")
    try:
        call = client.stream("llm.Generator", "Generate", {
            "prompt": make_prompt(200, SF_SEED + 300), "max_tokens": 400},
            timeout_s=600)
        got = [next(call) for _ in range(4)]
        call.cancel()
    finally:
        client.close()
    t0 = time.monotonic()
    wait_for(lambda: not any(s.active for s in engine.slots)
             and engine.allocator.used_pages == 0, "the cancelled slot", 60)
    log(f"surfaces cancel: a gRPC stream cancelled after {len(got)} "
        f"messages; slot and pages back in {time.monotonic() - t0:.3f}s "
        f"(pages used {engine.allocator.used_pages}) [{card}]")


def sf_level(app, stub, card) -> None:
    """REMOTE_LOG_URL: the stub's level turns DEBUG, the App's logger
    follows within one interval; then WARN again."""
    from gofr_tpu_torch.logging import Level

    for level in ("DEBUG", "WARN"):
        stub.level = level
        t0 = time.monotonic()
        wait_for(lambda: app.logger.level == Level[level],
                 f"the remote level {level}", 4 * SF_LEVEL_S + 5)
        took = time.monotonic() - t0
        log(f"surfaces level: the stub served {level}; the App's level "
            f"followed in {took:.3f}s (interval {SF_LEVEL_S:.1f}s) [{card}]")
        require(took <= SF_LEVEL_S + 1.0, f"surfaces: the level took "
                f"{took:.2f}s")


def sf_bert(dev, card, has_grpc: bool) -> None:
    """bert-embed (BERT_PRESET=base): Embed over gRPC equals /embed over
    HTTP for the same texts, sent one at a time (one batch program each)."""
    from gofr_tpu_torch import serve_bert
    from gofr_tpu_torch.grpcx import GRPCClient

    t0 = time.monotonic()
    app = serve_bert.build_app({**QUIET, "HTTP_PORT": "0",
                                "METRICS_PORT": "0", "BERT_PRESET": "base",
                                "REQUEST_TIMEOUT": "120", **grpc_env()},
                               device=dev)
    app.start()
    try:
        texts = models_texts(4, SF_SEED + 500, 100)
        same, dims = 0, set()
        for text in texts:
            status, _, body = post_json(app.http_port, "/embed",
                                        {"text": text})
            require(status == 201, f"surfaces bert: /embed {status}")
            dims.add(body["data"]["dim"])
            if has_grpc:
                client = GRPCClient(f"127.0.0.1:{app.grpc_port}")
                try:
                    got = client.call("EmbedService", "Embed",
                                      {"text": text}, timeout_s=120)
                finally:
                    client.close()
                same += got == body["data"]
        health = get_json(app.http_port, "/.well-known/health")
        tpu = health["details"]["tpu"]
        log(f"surfaces bert: BERT-base, {len(texts)} texts: gRPC Embed equal "
            f"to /embed for {same} of {len(texts) if has_grpc else 0} "
            f"(dim {sorted(dims)}); tpu {tpu['status']} "
            f"{tpu['details']['memory'][0]['kind']}; "
            f"{time.monotonic() - t0:.1f}s [{card}]")
        require(not has_grpc or same == len(texts),
                "surfaces bert: Embed over gRPC differs from /embed")
        require(tpu["status"] == "UP", "surfaces bert: tpu not UP")
    finally:
        app.shutdown()


def sf_mnist_job(dev, card, tmp: str) -> None:
    """Two ``python -m gofr_tpu_torch.serve_mnist`` ranks on this card,
    joined through JAX_COORDINATOR_ADDR (gloo, each rank's card cuda:0):
    each answers /predict on its own port as the unbatched forward of
    seed 0's MLP on the card, its tpu UP; SIGINT ends each with exit 0."""
    import os
    import signal
    import subprocess

    import numpy as np
    import torch

    import gofr_tpu_torch
    from gofr_tpu_torch.models.mlp import MLPConfig, mlp_forward, mlp_init
    from gofr_tpu_torch.serve import _free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        gofr_tpu_torch.__file__)))
    coord, ports = _free_port(), [_free_port(), _free_port()]
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for rank in (0, 1):
            env = {**os.environ, "JAX_COORDINATOR_ADDR":
                   f"127.0.0.1:{coord}", "JAX_NUM_PROCESSES": "2",
                   "JAX_PROCESS_ID": str(rank),
                   "JAX_COORDINATOR_TIMEOUT_S": "180",
                   "HTTP_PORT": str(ports[rank]), "METRICS_PORT": "0",
                   "LOG_LEVEL": "WARN", "GOFR_CONFIGS_DIR": tmp,
                   "PYTHONPATH": root}
            path = f"{tmp}/mnist-rank{rank}.log"
            logs.append(path)
            with open(path, "w") as fp:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gofr_tpu_torch.serve_mnist"],
                    env=env, cwd=root, stdout=fp, stderr=subprocess.STDOUT))

        def alive(port) -> bool:
            try:
                get_json(port, "/.well-known/alive")
                return True
            except (OSError, SmokeFailure):
                return False

        for rank, port in enumerate(ports):
            deadline = time.monotonic() + 180
            while not alive(port) and time.monotonic() < deadline:
                require(procs[rank].poll() is None,
                        f"surfaces mnist: rank {rank} exited "
                        f"{procs[rank].returncode}")
                time.sleep(0.2)
            require(alive(port), f"surfaces mnist: rank {rank} never "
                    f"answered")
        boot_s = time.monotonic() - t0
        image = np.random.default_rng(SF_SEED + 600).random(784, dtype=np.float32)
        with torch.no_grad():
            logits = mlp_forward(mlp_init(MLPConfig(), seed=0, device=dev),
                                 torch.from_numpy(image[None]).to(dev))
        row = logits[0].float().cpu().numpy()
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        kinds = []
        for rank, port in enumerate(ports):
            status, _, body = post_json(port, "/predict",
                                        {"image": image.tolist()})
            require(status == 201, f"surfaces mnist: rank {rank} answered "
                    f"{status}")
            err = float(np.abs(np.asarray(body["data"]["probs"])
                               - probs).max())
            require(body["data"]["digit"] == int(np.argmax(row))
                    and err <= MNIST_TOL, f"surfaces mnist: rank {rank} "
                    f"off by {err:.2e}")
            tpu = get_json(port, "/.well-known/health")["details"]["tpu"]
            require(tpu["status"] == "UP", f"surfaces mnist: rank {rank}'s "
                    f"tpu {tpu['status']}")
            kinds.append(tpu["details"]["memory"][0]["kind"])
        codes = []
        for proc in reversed(procs):
            proc.send_signal(signal.SIGINT)
            codes.append(proc.wait(timeout=120))
        codes.reverse()
        log(f"surfaces mnist: two serve_mnist ranks joined over gloo on one "
            f"card, serving in {boot_s:.1f}s; each /predict the card's "
            f"unbatched forward within {MNIST_TOL} ({kinds}); exit codes "
            f"{codes} [{card}]")
        require(codes == [0, 0], f"surfaces mnist: exit codes {codes}")
    except BaseException:
        for path in logs:
            with open(path) as fp:
                log(f"--- {path}:\n" + fp.read()[-3000:])
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def surfaces_phase(params, cfg, dev, card: str, short: bool = False) -> dict:
    """Phase 20 (--surfaces; the default run: short, at CUT_DEPTH layers and
    WARMUP=true): the main path's server with the surfaces on
    (surfaces_env) behind an API key. The device client is built first and
    probed on a thread while the engine captures its graphs. Then: the 401
    without the key, /.well-known/health without one (tpu UP with the
    card's memory); the launch counts zeroed; prompts one at a time over
    SSE, then over gRPC, the texts equal; (full) 8 concurrent gRPC streams
    held to the oracle within MODEL_TOL and the same 8 over SSE, the
    client TTFT / TPOT of each, top_k=1 at temperature 1 against greedy,
    an empty prompt INVALID_ARGUMENT, a cancelled stream's slot back; the
    launch counts read (flash and the paged read above 0) and no capture
    after boot; a probe wedge DEGRADED then UP; (full) the remote level,
    bert-embed's Embed, the serve_mnist job. Without grpc the gRPC checks
    are skipped. Returns ({kernel: launches}, those of the gRPC runs)."""
    import shutil
    import tempfile

    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.serve import build_app, build_engine

    t_all = time.monotonic()
    has_grpc = surface_modules(card)["grpc"]
    tmp = tempfile.mkdtemp(prefix="gofr-surfaces-")
    stub = LevelStub("WARN")
    app = None
    key = {"X-API-Key": SF_KEY}
    what = "surfaces short" if short else "surfaces"
    try:
        env = surfaces_env(tmp, "true" if short else "wide", stub.url)
        container = Container.create(env, device=dev)
        client = container.tpu
        require(client is not None and client.device == dev,
                f"{what}: no device client on {dev}")
        probes = ProbeLoop(client)
        try:
            engine = build_engine(env, device=dev, params=params,
                                  container=container)
        finally:
            polls = probes.stop()
        boot = boot_line(engine, what, card)
        secs = [p[1] * 1e3 for p in polls]
        log(f"{what}: {len(polls)} device probes during the boot's "
            f"{boot} captures: statuses {sorted({p[0] for p in polls})}, "
            f"the first (its stream and buffers made) {secs[0]:.2f} ms, the "
            f"rest ms p50={sf_pct(secs[1:], 0.5):.2f} "
            f"p99={sf_pct(secs[1:], 0.99):.2f} max={max(secs[1:] or [0]):.2f}"
            f" [{card}]")
        require(polls and all(p[0] == "UP" for p in polls),
                f"{what}: a probe during the captures was not UP")
        app = build_app(env, engine=engine)
        app.enable_api_key_auth(SF_KEY)
        app.start()
        # auth and the device client
        status, _, body = post_json(app.http_port, "/generate",
                                    {"prompt": "x", "max_tokens": 2})
        require(status == 401, f"{what}: /generate without the key: "
                f"{status}")
        health = sf_health(app.http_port)
        tpu = health["details"]["tpu"]
        mem = tpu["details"]["memory"][0]
        log(f"{what} auth: /generate without the key {status} {body}; "
            f"/.well-known/health without one 200, tpu {tpu['status']} on "
            f"{mem['kind']}: {mem['bytes_in_use'] / 2**30:.2f} of "
            f"{mem['bytes_limit'] / 2**30:.2f} GiB in use [{card}]")
        # the CPU (a rehearsal) reports no memory
        require(tpu["status"] == "UP" and (dev.type == "cpu" or (
            mem["bytes_limit"] > 0 and mem["bytes_in_use"] > 0)),
            f"{what}: tpu {tpu}")
        tally = LaunchTally(engine)
        captures0 = engine.executor.captures
        # one at a time: SSE, then gRPC, the same tokens
        n_seq = 2 if short else SF_SEQUENTIAL
        prompts = [make_prompt(SF_CHARS[i], SF_SEED + i) for i in range(8)]
        alone: dict = {}
        for i in range(n_seq):
            tally.run("sse", stream_request, app.http_port, prompts[i],
                      SF_TOKENS, alone, ("sse", i), headers=key)
            require(alone[("sse", i)]["status"] == 200,
                    f"{what}: SSE {alone[('sse', i)]['status']}")
            if has_grpc:
                tally.run("grpc", grpc_request, app.grpc_port, prompts[i],
                          SF_TOKENS, alone, ("grpc", i))
        if has_grpc:
            equal = sum(alone[("grpc", i)]["text"] == alone[("sse", i)]["text"]
                        and alone[("grpc", i)]["done"]["tokens"]
                        == alone[("sse", i)]["done"]["tokens"]
                        for i in range(n_seq))
            log(f"{what} alone: {n_seq} greedy prompts x {SF_TOKENS} tokens "
                f"over SSE then gRPC: {equal} of {n_seq} streams equal "
                f"[{card}]")
            require(equal == n_seq, f"{what}: gRPC and SSE streams differ")
        if not short:
            rec = record_tokens(engine)
            if has_grpc:
                got, _ = tally.run("grpc", sf_streams, app.grpc_port,
                                   prompts, SF_TOKENS, "grpc", key)
                require(all(got[i]["code"] == "OK" for i in got),
                        f"{what}: a gRPC stream failed")
                grpc_line = sf_client_line("grpc", got, SF_TOKENS, card)
                check_streams(f"{what} grpc", params, cfg, dev, rec,
                              SF_TOKENS, card)
                rec.clear()
            sse, _ = tally.run("sse", sf_streams, app.http_port, prompts,
                               SF_TOKENS, "sse", key)
            require(all(sse[i]["status"] == 200 for i in sse),
                    f"{what}: an SSE stream failed")
            sse_line = sf_client_line("sse", sse, SF_TOKENS, card)
            check_streams(f"{what} sse", params, cfg, dev, rec, SF_TOKENS,
                          card)
            if has_grpc:
                same = sum(got[i]["text"] == sse[i]["text"] for i in got)
                log(f"{what}: gRPC beside SSE, 8 concurrent streams each: "
                    f"{same} of 8 texts equal; ttft_ms p50 "
                    f"{grpc_line['ttft_p50']:.1f} vs {sse_line['ttft_p50']:.1f}"
                    f", tpot_ms p50 {grpc_line['tpot_p50']:.2f} vs "
                    f"{sse_line['tpot_p50']:.2f}, tok/s per stream p50 "
                    f"{grpc_line['tps_p50']:.1f} vs {sse_line['tps_p50']:.1f} "
                    f"[{card}]")
                tally.run("grpc", sf_top_k, app, params, cfg, dev,
                          prompts[0], alone[("grpc", 0)], card)
        if has_grpc:
            bad: dict = {}
            tally.run("grpc", grpc_request, app.grpc_port, "", 4, bad,
                      "empty")
            log(f"{what}: an empty prompt over gRPC: {bad['empty']['code']}")
            require(bad["empty"]["code"] == "INVALID_ARGUMENT",
                    f"{what}: an empty prompt answered "
                    f"{bad['empty']['code']}")
            tally.run("grpc", sf_cancel, app, engine, card)
        launches, on_grpc = tally.total(), tally.of("grpc")
        after = engine.executor.captures - captures0
        log(f"{what} launches (counted on the card): the gRPC runs "
            f"{json.dumps(on_grpc)}; the SSE runs "
            f"{json.dumps(tally.of('sse'))}; graphs captured after boot "
            f"{after}")
        require(launches["flash_attention"] > 0
                and launches["paged_attention"] > 0,
                f"{what}: no flash or paged-read launch")
        require(not has_grpc or (on_grpc["flash_attention"] > 0
                                 and on_grpc["paged_attention"] > 0),
                f"{what}: the gRPC runs launched no flash or paged read")
        require(after == 0, f"{what}: {after} graphs captured after boot")
        if short:
            client.HEALTH_PROBE_TIMEOUT_S = 0.5
        sf_wedge(app, client, card, 1.5 if short else SF_WEDGE_S)
        if not short:
            sf_level(app, stub, card)
    finally:
        if app is not None:
            app.shutdown()
        stub.close()
    if not short:
        import torch

        torch.cuda.empty_cache()
        sf_bert(dev, card, has_grpc)
        sf_mnist_job(dev, card, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"{what}: phase 20 {time.monotonic() - t_all:.1f}s, launches "
        f"{json.dumps(launches)}")
    return launches, on_grpc


def flash_only(dev, card) -> None:
    """--flash: the flash checks, then its times at the windows that test
    the design (one and two kv tiles, the served windows, long prompts)."""
    import torch

    check_flash(dev)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    for B, T in [(1, 16), (1, 80), (1, 256), (4, 256), (1, 1024),
                 (1, 16384)]:
        log_flash_time(B, T, time_flash(dev, B, T, True,
                                        5 if T > 1024 else 20, flush), card)


def decode_only(dev, card) -> None:
    """--decode: the decode-read checks, then the four reads' times at B=8
    over ~200-token contexts (those of serving's mid-decode; dense S=512),
    B=8 x 8192 and B=1 x 8192."""
    import torch

    check_decode(dev)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    time_reads(dev, [167, 197, 217, 237, 257, 147, 177, 167], 512, flush,
               card)


def main(argv=()) -> int:
    """No arguments: every phase, as the module docstring lists. --flash:
    build, then only the flash checks and times. --decode: build, then
    only the decode-read checks and times. --prefill: build, then only the
    model's prefill times at [1, 256] and [4, 256]. --spec: build, then the
    speculation and chunked-prefill phases (10). --sc: build, then the
    main path's sampling-controls phase at CUT_DEPTH layers, the sort-skip
    phase and the scoring phase. --weights: build, then the weights phases
    (w8_phase). --openai: build, then the OpenAI phase on an engine of its
    own (OPENAI_ENV). --obs: build, then the main path's serve phase with
    phase 4b and its cost measurements, and its decode profile with the
    utilization ledger beside the profiler. --faults: build, then phase 11
    (faults_phase), ending with the ok line. --qos: build, then phase 12
    (qos_mode_phase), ending with the ok line. --elastic: build, then
    phase 13 (elastic_phase), ending with the ok line. --train: build,
    then phase 14 (train_phase); --models: build, then phase 15
    (models_phase), each ending with the ok line; --parallel: build, then
    phase 16 (parallel_mode; ``--parallel e``: its (e) alone), ending with
    the ok line; --sharded-train: build, then phase 17
    (sharded_train_mode), ending with the ok line; --loadgen: build, then
    phase 18 (loadgen_phase), ending with the ok line; --fleet: build, then
    phase 19 (fleet_phase), ending with the ok line; --surfaces: build,
    then phase 20 (surfaces_phase), ending with the ok line. The other
    short modes print no ok line."""
    import dataclasses

    import torch

    mode = argv[0] if argv else None
    if mode not in (None, "--flash", "--decode", "--prefill", "--sc",
                    "--weights", "--spec", "--openai", "--obs", "--faults",
                    "--qos", "--elastic", "--train", "--models",
                    "--parallel", "--sharded-train", "--loadgen", "--fleet",
                    "--surfaces"):
        log(f"FAIL unknown argument {mode!r} (--flash, --decode, --prefill, "
            f"--sc, --weights, --spec, --openai, --obs, --faults, --qos, "
            f"--elastic, --train, --models, --parallel [e], --sharded-train, "
            f"--loadgen, --fleet, --surfaces or none)")
        return 2

    if not torch.cuda.is_available():
        log("FAIL no CUDA device is visible")
        return 1
    try:
        from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
        from gofr_tpu_torch.ops import _build
        from gofr_tpu_torch.tpu.device import card_info, resolve_device
    except ImportError as exc:
        log(f"FAIL gofr_tpu_torch is not importable ({exc}); run from the "
            f"root of a checkout")
        return 1
    t_all = time.monotonic()
    try:
        dev = resolve_device("cuda:0")
        card = card_info().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"card: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; torch.backends.cuda.matmul.allow_tf32="
            f"False, torch.backends.cudnn.allow_tf32=False")
        t0 = time.monotonic()
        took = _build.build(*_build.KERNELS)
        log(f"build: {json.dumps({k: round(v, 2) for k, v in took.items()})} "
            f"wall={time.monotonic() - t0:.2f}s (nvcc, sm_90a, parallel)")
        for name in _build.KERNELS:
            build_report(name, _build)

        if mode == "--flash":
            flash_only(dev, card)
            log(f"flash only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode == "--decode":
            decode_only(dev, card)
            log(f"decode only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode in ("--train", "--models", "--parallel", "--sharded-train"):
            if mode == "--train":
                train_phase(dev, card)
            elif mode == "--parallel":
                parallel_mode(dev, card, only_e=argv[1:2] == ["e"])
            elif mode == "--sharded-train":
                sharded_train_mode(dev, card)
            else:
                models_phase(dev, card, 64, "base")
            log(f"{mode[2:]} only: ok, total {time.monotonic() - t_all:.1f}s")
            print(card, flush=True)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return 0
        if mode not in ("--prefill", "--weights", "--spec", "--openai",
                        "--obs", "--faults", "--qos", "--elastic",
                        "--loadgen", "--fleet", "--surfaces"):
            check_kernels(dev)

        cfg = LlamaConfig.llama3_8b()
        t0 = time.monotonic()
        params = llama_init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"model: llama3_8b {cfg.param_count() / 1e9:.2f}B params bf16, "
            f"random seed 0, init {time.monotonic() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        if mode == "--prefill":
            time_prefill(params, cfg, dev, [(1, 256), (4, 256)], 10, card)
            log(f"prefill only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode == "--weights":
            flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32,
                                device=dev)
            w8_phase(params, cfg, dev, card, flush, cfg.n_layers)
            log(f"weights only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode == "--spec":
            t0 = time.monotonic()
            spec_phase(params, cfg, dev, card)
            log(f"spec phases: {time.monotonic() - t0:.1f}s")
            t0 = time.monotonic()
            chunk_phase(params, cfg, dev, card)
            log(f"chunk phases: {time.monotonic() - t0:.1f}s")
            log(f"spec only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode == "--openai":
            from gofr_tpu_torch.serve import build_app, build_engine

            engine = build_engine(OPENAI_ENV, device=dev, params=params)
            boot_line(engine, "openai", card)
            gen_app = build_app(OPENAI_ENV, engine=engine)
            gen_app.start()
            try:
                openai_phase(params, cfg, dev, card, gen_app, engine)
            finally:
                gen_app.shutdown()
            log(f"openai only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode == "--obs":
            serve_phase(params, cfg, dev, card, "paged", obs=True,
                        obs_costs=True)
            torch.cuda.empty_cache()
            eng = decode_engine(params, cfg, dev, "paged")
            profile_decode(eng, card, "paged")
            log(f"obs only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode in ("--faults", "--qos", "--elastic", "--loadgen",
                    "--fleet", "--surfaces"):
            if mode == "--faults":
                faults_phase(params, cfg, dev, card)
            elif mode == "--surfaces":
                surfaces_phase(params, cfg, dev, card)
            elif mode == "--qos":
                qos_mode_phase(params, cfg, dev, card)
            elif mode == "--loadgen":
                loadgen_phase(params, cfg, dev, card)
            elif mode == "--fleet":
                fleet_phase(params, cfg, dev, card)
            else:
                elastic_phase(params, cfg, dev, card)
            log(f"{mode[2:]} only: ok, total {time.monotonic() - t_all:.1f}s")
            print(card, flush=True)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return 0
        if mode == "--sc":
            serve_sc_phase(cut_tree(params, CUT_DEPTH),
                           dataclasses.replace(cfg, n_layers=CUT_DEPTH), dev,
                           card, "paged")
            sort_skip_phase(params, cfg, dev, card)
            score_phase(params, cfg, dev, card)
            log(f"sc only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        check_model(params, cfg, dev)
        served = {}
        for config in SERVE_CONFIGS:
            served[config] = serve_phase(params, cfg, dev, card, config,
                                         obs=config == "paged",
                                         drill=config == "paged")
            torch.cuda.empty_cache()
        # the sampling-controls and prefix phases at CUT_DEPTH layers, full
        # width, each held to the oracle at that depth
        cut, cut_cfg = (cut_tree(params, CUT_DEPTH),
                        dataclasses.replace(cfg, n_layers=CUT_DEPTH))
        for config in SERVE_CONFIGS:
            # the OpenAI phase on the main path's engine (its boot reused)
            after = (None if config != "paged" else
                     lambda app, eng: openai_phase(cut, cut_cfg, dev, card,
                                                   app, eng))
            serve_sc_phase(cut, cut_cfg, dev, card, config, after=after)
            torch.cuda.empty_cache()
        warmup_true_phase(params, cfg, dev, card)
        torch.cuda.empty_cache()
        for config in PREFIX_CONFIGS:
            served[config] = prefix_phase(cut, cut_cfg, dev, card, config)

        flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
        # flash at every [K, bucket] window the main path dispatched; the
        # kernels line carries the most frequent one (ties: the most work)
        main = served["paged"]
        shapes = main["prefill_shapes"]
        K, bucket = max(shapes, key=lambda s: (shapes[s], s[0] * s[1]))
        flash_main = time_flash(dev, K, bucket, True, 20, flush)
        others = [(k, b) for k, b in sorted(shapes) if (k, b) != (K, bucket)]
        log_flash_time(K, bucket, flash_main, card)
        for B, T in others + [(1, 1024), (1, 16384)]:
            log_flash_time(B, T, time_flash(dev, B, T, True,
                                            5 if T > 1024 else 20, flush),
                           card)
        # the decode reads at B=8 and the contexts of mid-decode in serving
        ctx = [n + main["max_tokens"] // 2 for n in main["prompt_lens"]]
        ctx = (ctx + ctx)[:8]
        S = served["dense"]["cache_len"]
        timed = {"flash_attention": (flash_main, "")}
        timed.update(time_reads(dev, ctx, S, flush, card))
        # after the kernels' own times: once graph replays had been
        # profiled, a later profile of one kernel came back without its
        # records on an H100
        time_prefill(params, cfg, dev, shapes, 10, card)
        for config, quantized in (("paged-prefix", False),
                                  ("paged-int8-prefix", True)):
            time_tail_prefill(params, cfg, dev, card,
                              served[config]["tail_shapes"], quantized)
        csrc = "gofr_tpu_torch/ops/csrc/"
        # kernel -> (source, the Pallas call it replaces, its serving phase)
        origin = {
            "flash_attention": ("flash_attention.cu",
                                "gofr_tpu/ops/flash_attention.py:186",
                                "paged"),
            "paged_attention": ("paged_attention.cu",
                                "gofr_tpu/ops/paged_attention.py:210",
                                "paged"),
            "paged_attention_q8": ("paged_attention.cu",
                                   "gofr_tpu/ops/paged_attention.py:210",
                                   "paged-int8"),
            "decode_attention": ("decode_attention.cu",
                                 "gofr_tpu/ops/decode_attention.py:206",
                                 "dense"),
            "decode_attention_q8": ("decode_attention.cu",
                                    "gofr_tpu/ops/decode_attention.py:206",
                                    "dense-int8"),
        }
        kernels = []
        for name, (src, replaces, config) in origin.items():
            r = {k: x for k, x in timed[name][0].items()
                 if k != "strided_ms"}
            kern = dict(name=name, route="cuda", source=csrc + src,
                        replaces=replaces,
                        launches=served[config]["launches"][name], **r)
            require(kern["launches"] > 0, f"{name}: no launch on its path")
            require(all(kern.get(k) is None or math.isfinite(kern[k])
                        for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "max_abs_err", "library_ms",
                                  "library_device_ms")),
                    f"non-finite timing for {name}")
            kernels.append(kern)
        for config in SERVE_CONFIGS:
            eng = decode_engine(params, cfg, dev, config)
            profile_decode(eng, card, config)
            check_graph(eng, card, config)
            check_prefill_graph(eng, card, config)
            del eng
            torch.cuda.empty_cache()
        sort_skip_phase(params, cfg, dev, card)
        score_phase(params, cfg, dev, card)
        w8_phase(params, cfg, dev, card, flush, CUT_DEPTH)
        torch.cuda.empty_cache()
        # at CUT_DEPTH layers, full width, each held to the oracle at that
        # depth (--spec runs them at full depth), so the default run keeps
        # its margin under the time limit
        t0 = time.monotonic()
        spec_phase(cut, cut_cfg, dev, card)
        chunk_phase(cut, cut_cfg, dev, card)
        log(f"spec and chunk phases: {time.monotonic() - t0:.1f}s")
        # the open-loop client, the datasources and the batch lane, short
        # (--loadgen runs them at full depth with the replay and the
        # knee), then the router over its server and one more (--fleet
        # runs phase 19 at full depth); their flash and paged-read
        # launches join the kernels line
        fleet = {}
        loadgen = loadgen_phase(
            cut, cut_cfg, dev, card, short=True,
            after=lambda app: fleet.update(fleet_short(app, cut, cut_cfg,
                                                       dev, card)))
        # the serving surfaces and the device client, short (--surfaces
        # runs phase 20 at full depth with bert-embed and the mnist job):
        # its flash and paged-read launches, through SSE and gRPC, join the
        # kernels line
        surfaces, on_grpc = surfaces_phase(cut, cut_cfg, dev, card,
                                           short=True)
        for kern in kernels:
            if kern["name"] in ("flash_attention", "paged_attention"):
                kern["launches"] += (loadgen[kern["name"]]
                                     + fleet[kern["name"]]
                                     + surfaces[kern["name"]])
                kern["loadgen_launches"] = loadgen[kern["name"]]
                kern["fleet_launches"] = fleet[kern["name"]]
                kern["surfaces_launches"] = surfaces[kern["name"]]
                kern["grpc_launches"] = on_grpc.get(kern["name"], 0)
        # training and the batcher servers, short (--train and --models run
        # them in full); training's flash launches join the kernels line
        del params, cut
        torch.cuda.empty_cache()
        train_launches = short_train_models_phase(dev, card)
        kernels[0]["launches"] += train_launches
        kernels[0]["train_launches"] = train_launches
        # the TP path on a one-rank NCCL mesh and the sp=1 forwards, short
        # (--parallel runs them in full)
        parallel_short(dev, card)
        # the sharded step in a world of one against the unsharded step
        # (--sharded-train runs the sharded paths on n cards); its flash
        # launches join the kernels line
        sharded_launches = sharded_short(dev, card)
        kernels[0]["launches"] += sharded_launches
        kernels[0]["sharded_launches"] = sharded_launches
        log(f"total: {time.monotonic() - t_all:.1f}s")
    except Exception as exc:  # noqa: BLE001 - any phase failing fails the run
        import traceback

        traceback.print_exc()
        log(f"FAIL {type(exc).__name__}: {exc}")
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
