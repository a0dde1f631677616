"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. probe: CUDA must be available; prints the card's name and power
   limit; TF32 off for f32 matrix products and convolutions.
2. build: compiles every CUDA kernel from the sources in the checkout
   (one nvcc per source, all started together) and prints the time.
   Then each kernel of the flash, ragged and paged decode libraries:
   registers and spill bytes (ptxas -v), dynamic shared memory per
   block, and its HMMA (tensor-core), LDGSTS (cp.async), LDSM
   (ldmatrix), FFMA (f32 FMA) and LDS.128 (16-byte shared load)
   instruction counts in the built SASS (cuobjdump). Every bf16 flash
   kernel (forward, dq, dkv) and every bf16 ragged pass-1 kernel (1, 2
   and 4 warps), at D 64 and 128, must have the first three and no
   spills; the f32 flash kernels (forward, dq, dkv), the f32 ragged
   pass-1 kernel and the paged decode kernel (both dtypes) must stage by
   cp.async and not spill.
3. kernels: the ragged kernel against its plain PyTorch version on the
   card at the shapes the serving path gives it (Llama-3-8B attention:
   H=32, KVH=8, D=128, page 16) for decode, prefill and verify, and at
   two long rows (4,000 and 8,000 keys) at decode and verify widths,
   which the bf16 kernel splits several ways, and at a tp=2 rank's
   shape (H=16, KVH=4: decode, prefill and verify, the *_tp2 families;
   phase 4k runs it there); in bf16 and f32, with
   block-table tails naming a NaN-filled page. Prints the split count
   (both dtypes at decode and verify widths: runs of 8 pages, whatever
   the batch), the max error, the kernel's, the plain version's and one
   library call's median time, and the card's lower bound for the same
   work.
4. serve: PagedInferenceEngine at full Llama-3-8B width (random weights
   from a seed, bf16, all 32 layers), dispatching CUDA graphs captured
   at warmup (or at the first dispatch of a key warmup left out),
   generates ~10 mixed requests (greedy, sampled, top-k, logprobs), then
   two verify dispatches run through the engine on its caches. Kernel
   launch counts are reset just before and read just after, and every
   family of the path must have launched the kernel. Then a second
   engine on the same weights runs the same mix with its dispatch
   bodies eager: every request's tokens and logprobs, the verify
   outputs, the dispatch counters, the launches by family and every
   page from 1 up must equal the captured run's, bit for bit. Prints
   both runs' tokens/s and TTFT, the warmup seconds, the number of
   captured programs and the seconds per capture, and profile_summary()
   after estimate_flops() (each estimate must match the analytic matmul
   count within 1%; its MFU leaves attention out).
4k. tensor-parallel serve: right after phase 4, in this process (no
   runtime), phase 4's engine settings at full Llama-3-8B width (all 32
   layers) with mesh=build_mesh(MeshSpec(tp=2), devices=[cuda:0,
   cuda:0]): both tp ranks on the one card, phase 4's seed-0 weight
   tensors cut into their shards (heads, kv_heads and mlp over tp, the
   vocab over tp), captured programs. Phase 4's mix, the mix from
   another seed and its two verify dispatches, as phase 4; counts set
   to 0 before and read after. Held: the ragged kernel launched in
   every family at H 16 and KVH 4 (each rank's shapes), exactly twice
   phase 4's launches per family where the dispatch counters equal
   phase 4's (verify always); mesh_reshard_bytes 0 and the declared
   input and output bytes above 0; every greedy request's tokens equal
   to phase 4's up to a divergence (the first token included), where the
   two tokens must be phase 4's top 2 at that step, teacher-forced on
   phase 4's weights through verify_paged_rows, with a gap below
   TP_GAP_BOUND's bound (the matched tokens' logprobs within it too);
   then the engine put back to its state after warmup runs the first mix
   again: every request (sampled and top-k too) equal bit for bit.
   Prints one mesh: line (tokens/s, TTFT, warmup s and programs, the
   mesh counters, launches, divergences) with the card.
5. agreement: a small f32 model (2 layers, dim 256, head_dim 128), dense
   and as a 4-expert top-2 MoE, served on the card (kernel) and on the
   CPU (plain version) gives identical greedy tokens, logprobs within
   1e-4. 5k: that model with 2 KV heads (phase 5's one KV head cannot
   split over tp=2), dense and MoE, served at tp=2 on the card (both
   ranks on cuda:0, H 1 and KVH 1 each) gives the CPU's one-device
   greedy tokens, logprobs within 1e-4.
3b. flash: the training path's three kernels (flash forward, dq, dkv)
   against their plain versions on the card at Llama-3-8B attention
   shapes (B 2, S 4096, H 32, KVH 8, D 128, causal) in bf16 and f32,
   plus a ragged non-causal 77 x 140 case, a causal S 4000 case and a
   causal D 64, G 1 case with Sq 1000 < Sk 1800. At the 8B shape, in
   both dtypes, a second launch of the forward, dq and dkv must give the
   same bits.
   Prints the max error, the kernels', the plain versions' and the
   library's (scaled_dot_product_attention forward, and its autograd
   backward for dq + dkv) median times, and the card's lower bound.
   Then the forward kernel alone at the dense engine's prefill shapes
   (B 1, causal, S = each bucket 32-1024, bf16), held against its plain
   version and timed the same way; phase 4b fails if it prefills at a
   shape not checked here.
6. train: Llama-3-8B widths with the depth cut to 8 of 32 layers, bf16,
   remat "save_attn": loss = cross_entropy(apply(params, tokens[:, :-1]),
   tokens[:, 1:]), backward, AdamW(lr 3e-4, weight decay 0), on one
   batch of 2 x 4096 tokens: 1 warm step, then 5 timed. Launch counts
   are reset just before and read just after: every step launches the
   forward, dq and dkv kernels exactly once per layer, the serve kernel
   never. Losses finite, the last below the first.
6b. trainer: phase 6's train step as the train loop of a TorchTrainer
   (ray_tpu_torch.train) on the port's runtime (init(num_cpus=2,
   num_gpus=1), phase 6's tensors freed first): one worker leasing the
   GPU (ScalingConfig(num_workers=1, gpus_per_worker=1)), phase 6's
   seed-0 weights, batch and AdamW, 6 steps, each loss sent up with
   train.report. After step 2 the worker reports a checkpoint made by
   Checkpoint.from_state (params, AdamW's state_dict() and the step;
   ~15.6 GiB) into a temporary storage path on local disk (df printed
   first; removed at the end), CheckpointConfig(num_to_keep=1), then
   raises once (a marker file); FailureConfig(max_failures=1) starts a
   new worker, which restores from train.get_checkpoint() and runs steps
   3-5. The step's tokens come from a ray_tpu_torch.data Dataset given
   as TorchTrainer(datasets={"train": ds}): 2,048 rows in 16 blocks,
   an int64 `id` and an int32 `tokens` column 4,097 wide (~33.6 MB),
   rows 0 and 1 phase 6's batch (RandomState(seed)), the rest from
   RandomState(seed + 1). Each attempt reads its whole shard
   (get_dataset_shard("train").iter_device_batches(batch_size=2,
   drop_last=False): pinned host batches copied onto the card) before
   its first step, and steps on rows 0 and 1 cast to int64 on the card.
   Held: every id 0-2,047 once in each attempt, each row's checksum
   equal to the driver's, the tokens on the card; the 6 losses equal
   phase 6's bit for bit; in the worker,
   each step (counts set to 0 just before, read just after) launches the
   forward, dq and dkv kernels once per layer and the serve kernels
   never; the restored params' and moments' checksums equal the saved
   ones; no error, the last step 5, 6 reports over two worker processes
   (each seeing CUDA_VISIBLE_DEVICES "0", neither loading jax or
   ray_tpu), the checkpoint's step 2; the GPU reads 0 while the gang
   holds it and 1 after fit returns, and no worker is left. Prints one
   trainer: line: worker start s per attempt (fit start, or the crash,
   to the loop's first line), each attempt's shard pass (s, rows/s, MB/s
   onto the card, the first batch's wait), first-step s, the worker's
   step ms median beside phase 6's, checkpoint GiB, save and restore s,
   crash to the first resumed step's end, phase s, whether pyarrow and
   pandas are installed, with the card and its power limit.
6c. lora_tune: the LoRA trainer (ray_tpu_torch.llm.multilora) and Tune
   (ray_tpu_torch.tune) in 6b's runtime before it shuts down, over phase
   6's seed-0 base at Llama-3-8B widths and 8 of 32 layers, bf16,
   frozen: targets wq, wv and lm_head, rank 16, alpha 32, lr 1e-3,
   batch 4 x 512, random inputs from RandomState(1000 + step) and every
   target one taught token. Launch counts are set to 0 just before each
   step (in the data function) and read just after (on_step), wherever
   the step runs. (1) Local mode in the driver: 20 steps checkpointed
   every 10 into a temporary storage path, then a trainer of 30 steps on
   the same storage, which resumes at step 20. Held: the 20 losses
   finite, the last below the first; the resumed adapter equals an
   uninterrupted 30-step run's bit for bit; every step launches the
   forward, dq and dkv kernels once per layer and the paged kernels
   never. (2) Substrate mode: the 20-step config on a one-GPU gang
   (ScalingConfig(num_workers=1, gpus_per_worker=1)). Held: its losses
   and adapter equal (1)'s first 20 bit for bit; the kernels as in (1),
   every step inside the worker, which sees CUDA_VISIBLE_DEVICES "0" and
   loads neither jax nor ray_tpu; the GPU reads 0 while held and 1
   after; no worker left. (3) publish() into an AdapterRegistry in the
   runtime; the fetched payload equals the trainer's adapter bit for
   bit; an eager paged engine in the driver (phase 4's settings at 8
   layers, max_adapters=2, lora_rank=16) serves phase 4's greedy
   prompts, base and tenant in one batch, the tenant's slot from
   MultiLoraManager.resolve. Held: the base rows equal a plain engine's
   tokens (no adapters, every tenant request sent there as a base
   request) bit for bit; a tenant row differs from its base row; the
   ragged kernel launched in prefill and decode. Printed only: the
   taught token's share of the tenant's tokens and a merged-weights
   engine's agreement with them. (4) A Tuner over a trainable that
   builds phase 6's base in its own process (llama.init, seed 0) and
   runs the trainer's loop with a checkpoint and a tune.report every
   step: grid_search over lr 1e-3 and 1e-4, metric loss, mode min, one
   trial at a time, stop at training_iteration 6, {"CPU": 1, "GPU": 1}
   per trial. Held: 2 trials, each stopped by the controller after 6
   reports; the lr-1e-3 trial's 6 losses equal (1)'s first 6 bit for
   bit; the kernels as in (1), every step inside each trial; each trial
   sees "0"; the best result is the trial with the lower last loss; the
   GPU reads 1 after fit; no worker left. Prints one lora_tune: line:
   step ms medians of local mode, the worker and the trials beside
   phase 6's, worker and trial start s, the pickled base's GiB and
   pickle s, checkpoint MiB, resume s, publish ms, the tenant's tokens/s
   and the phase's s, with the card and its power limit.
7. train agreement: phase 5's small f32 models (head_dim 128, GQA 2),
   dense and MoE, each trained for 2 steps on the card (kernels) and on
   the CPU (plain versions): losses, MoE aux losses, logits and every
   gradient agree (the MoE model's second step starts from the CPU's
   parameters on both sides: train_agreement says why). The f32
   forward, dq and dkv kernels' launch counts are reset just before and
   read just after; each must have launched.
3c. paged decode: the decode-only kernel (split-KV over runs of 8 pages,
   the merge in the last block to finish) on its own entry point
   paged_decode_attention, whose path no model runs. The launch count is
   reset, the entry point is called once per case and dtype, and the
   count read: that is the kernel's path. Cases: phase 3's decode shape
   plus a length-0 row, and one row with an 8,192-token context (512
   pages); table tails name a NaN page and the slots past each length in
   its last page are NaN. Each output is held against the plain version
   and against the ragged kernel at q_len 1 (live rows; length-0 rows
   must be exactly 0) within phase 3's TOL, its atol cut to 2^-7 of each
   row's largest value; bitwise against a second launch, against the
   merge in a second launch, and row by row against the row alone (the
   batch reversed, 4 more rows, the table 8 pages wider). The call
   (its arrival counters' allocation and memset included), the plain
   version, the ragged kernel (through
   ragged_decode_attention, and alone on inputs clamped once outside the
   timed call) and scaled_dot_product_attention are timed beside the
   card's bound and a cold read (a sum) of as many contiguous bytes as
   the bound counts.
4b. dense serve: the paged engine freed, LLMPredictor (the dense-slot
   InferenceEngine) at full Llama-3-8B width (32 layers, bf16, random
   weights from seed 0, batch 8, max_seq_len 1024) answers one batch of
   8 prompts, then its engine generates phase 4's requests. Launch counts
   are reset just before and read just after: the flash forward kernel
   runs once per layer per prefill, the paged kernels never.
4c. server: the dense engine freed, the OpenAI app
   (build_openai_app: the router over one LLMServer) under
   serve.run(..., local_testing_mode=True), over phase 4's paged engine
   settings at full Llama-3-8B width (8 of 32 layers since the chaos
   step of 4h came, SERVER_DEPTH_CUT; bf16, seeded weights).
   After one v1_models call and a first burst of the mix from seed 1
   (its engine thread captures the keys warmup left out), the ingress
   handle answers phase 4's 11 requests (seed 2) sent by 11 threads at
   once through v1_completions beside one v1_chat_completions request,
   then the greedy one again through v1_completions with stream=True
   (SSE lines); the engine dispatches captured programs. The ragged
   kernel's launch count is reset just before and read just after and
   must be above 0. Fails on a badly shaped response or v1_models, a
   stream that differs from the greedy request's tokens in the burst or
   does not end in "data: [DONE]", a chat answer that differs from
   v1_completions on its templated prompt, rtpu_llm_requests_total !=
   13, rtpu_llm_tokens_generated_total != the engine's tokens_out, a
   TTFT histogram count != 13, an engine thread error or a failed
   check_health. Prints wall time, tokens/s,
   TTFT / inter-token / queue-wait figures from the port's histograms,
   and profile_summary() after estimate_flops() (its MFU counts the
   matmuls only: the FLOP counter cannot see the ragged kernel; each
   estimate must match the analytic matmul count within 1%). Stops the
   engine thread of the replica, reached through the app.
4d. tenants and KV mobility: the server freed, PagedInferenceEngine at
   full Llama-3-8B width (8 of 32 layers since the chaos step of 4h
   came, TENANTS_DEPTH_CUT; bf16, seed-0 weights) with a slot
   table (3 adapters of rank 8 on wq/wk/wv/wo/lm_head from seeds 1-3,
   slot 0 base), the host spill tier (512 MiB) and a 256-page pool, on
   captured programs, serves three waves: base and tenant requests
   (greedy, sampled, top-k, logprobs; a prefix shared within a tenant
   and one across tenants), a wave that evicts every page of the first
   (demoted to the tier), and the first wave again (promoted); then two
   verify dispatches with tenant rows. Launch counts are reset just
   before and read just after. Fails unless an eager engine gives the
   same tokens, logprobs, counters, launches by family and pages; a
   plain engine (no slot table) the base rows' tokens and logprobs; the
   tier off the greedy tokens; each tenant's greedy request alone its
   tokens in the mix; a slot reloaded after capture the new adapter's
   tokens; promoted pages the bits exported before eviction; and an
   engine on the same weights tensors, importing a prefill export and a
   prefix export, A's tokens with the prefix bitwise re-exported. Prints
   tokens/s per wave LoRA on and off, programs and seconds per capture,
   ms per demoted and promoted page, ms for one import_prefill, the
   merged-weights agreement (not held: bf16 merge-then-cast is not the
   f32 delta) and B1 launches by family.
4e. MoE serve: the tenants' engine freed, phase 4 (captured programs,
   two passes and two verify dispatches, then an eager engine on the same
   weights and mixes: tokens, logprobs, counters, B1 launches by family
   and pages equal bit for bit) on llama3_8b(moe_experts=8, moe_top_k=2)
   — Mixtral-8x7B's widths, experts and routing — with the depth cut to
   8 of 32 layers (32 are 45B parameters, ~90 GB of bf16), bf16, seeded
   weights, phase 4's engine settings and request mix. Prints phase 4's
   figures; its MFU counts every dispatched expert slot (E x C per call,
   FlopCounterMode), not the routed tokens.
4f. runtime: the MoE engine freed, the port's own runtime,
   ray_tpu_torch.init(num_cpus=4, num_gpus=torch.cuda.device_count()).
   A CPU task must see CUDA_VISIBLE_DEVICES "", no CUDA, and neither jax
   nor ray_tpu in sys.modules. A @remote(num_gpus=1) actor wraps
   LLMServer at Llama-3-8B widths with the depth cut to 8 of 32 layers,
   as 4g's (bf16, seed-0 weights made in the actor: params_ref None;
   phase 4's engine settings, warmup on) and must report
   CUDA_VISIBLE_DEVICES "0" and the driver's card;
   available_resources()["GPU"] must read 0 while it lives. Phase 4's
   request mix (seed 0) goes to it as 11 concurrent completions calls;
   every greedy request's tokens must equal 4g's reference tokens (one
   captured engine of the same 8-layer model, run in the driver before
   4f) bit for bit. The ragged kernel's launches are counted inside the actor's
   process, by family around the engine's prefill and decode steps (set
   to 0 just before the mix, read just after): both must be above 0.
   After kill the GPU count must come back; a new one-GPU actor then
   gets index "0" again, gets phase 5's small f32 model, put by the
   driver as CPU tensors, through an ObjectRef, and serves phase 5's
   prompts on the card: greedy tokens equal to the CPU engine's,
   logprobs within 1e-4. A CUDA tensor dict (f32 and bf16) put by the
   driver must arrive in a CPU task as equal CPU tensors. After
   shutdown no worker process of the port may be left. Prints the
   actor's start-up (spawn, weights, warmup seconds), tokens/s, TTFT,
   launches, the median round trip of an actor call, and the params_ref
   actor's get and copy onto the card (seconds, timed inside LLMServer).
4g. cluster: the runtime across hosts, on this one machine. A head with
   no GPU (init(num_cpus=2, num_gpus=0)) and a node agent started as
   `python -m ray_tpu_torch.core.node_agent --num-cpus 2 --num-gpus 1
   --own-store` against head_address(), its store sized to at most half
   of /dev/shm's free bytes (printed). nodes() must show the GPU on the
   agent's node only. 4f's actor, named and pinned to the agent's node
   (NodeAffinitySchedulingStrategy, soft=False), serves Llama-3-8B's
   widths with the depth cut to 8 of 32 layers (4g holds transport, not
   depth) from a worker the agent forked with the index the head
   leased it: it must report CUDA_VISIBLE_DEVICES "0", the card, the
   agent node's RTPU_NODE_ID and neither jax nor ray_tpu; phase 4's mix
   must give bit for bit the greedy tokens that one captured engine of
   the same 8-layer model gives it in the driver just before (4g's
   reference tokens), the ragged kernel must
   launch in both families inside it, and available_resources()["GPU"]
   must read 0 while it lives. A second driver (a script written to a
   temporary file, loading neither jax nor ray_tpu) attaches with
   init(address=<cluster.json>), takes the actor with get_actor and
   sends phase 4's first greedy request: its tokens must equal 4g's
   reference, and state.list_actors() over its rpc must list the actor (it
   runs inside the dag step, below). After kill the agent's node has
   its GPU back; a new one-GPU
   actor there gets phase 5's small f32 model through an ObjectRef put
   in the head's store, pulled into the agent's own store (tokens equal
   to the CPU engine's, logprobs within 1e-4). One bf16 tensor (its host
   copy; 1 GiB at most, and a quarter of the agent's store) goes to a
   CPU task on the agent's node and comes back as its result: both
   checksums must equal the driver's. Each side gets it twice (the
   first get pulls the frame and unpickles it, the second unpickles the
   local copy), so the pull's own rate is bytes over their difference. Last the agent is stopped: its
   node must be marked dead and its GPU must leave cluster_resources()
   within health_check_timeout_s plus 10 s; after shutdown no worker or
   agent of the port and no /dev/shm/ray_tpu_torch_* file may be left.
   Prints the agent's registration, the actor's start-up, tokens/s,
   TTFT, launches, the median actor-call round trip (now over TCP), the
   second driver's attach, and both transfers' bytes, seconds and GB/s.
dag (in 4f and again in 4g, on their 8B actor after its mix and before
   its kill): the compiled-DAG layer (ray_tpu_torch.dag) around that
   actor. inp -> host.complete_many (phase 4's bodies at once from a
   thread pool) -> Collect.tokens (a num_cpus=1 actor: token ids and the
   greedy flag of each result), compiled with max_inflight=2. Phase 4's
   seed-0 mix runs as one execute, then split in three parts, all three
   executed before the first get (the third drains the first from the
   ring); in each run every greedy request's tokens must equal 4g's
   reference bit for bit and the ragged kernel must
   launch in both families inside
   the actor (its counts set to 0 just before the run, read just after).
   While the DAG lives, from the head's driver: state.list_actors() has
   the named actor alive, state.list_workers() its worker with the
   actor's pid (and, in 4g, the agent's node),
   state.summary()["active_channels"] grows by the DAG's channel count,
   state.stack_report() shows the actor's loop thread parked on a
   channel (channel_recv), state.timeline(flight=True) has a chan_seal
   and a chan_wake for every edge of the last execute, and
   state.memory_summary() has store totals; in 4g the second driver also
   runs here and finds the actor through state.list_actors(). Then a
   one-stage DAG inp -> host.echo gives the median of 200
   execute(i).get() round trips after one warm one. After teardown each
   loop returns, no channel is counted, every store's object count
   (the head's, and in 4g the agent's) is back to its count before the
   compile, and a plain complete call gives phase 4's first greedy
   tokens. In 4f every stage shares the driver's store ("store":
   "shared"); in 4g the host sits on the agent's own store and Collect
   on the head's node, so the edges cross both ways ("store": "across").
   Prints one dag: line per phase, with the card and its power limit.
4h. serve_cluster: Serve over the port's runtime, in a runtime session
   of its own after 4f and 4g have shut theirs down:
   ray_tpu_torch.init(num_cpus=4, num_gpus=1). The app is
   build_openai_app's (the OpenAI router over one LLM deployment:
   Llama-3-8B at full width, phase 4's engine settings, seed-0 weights
   made in the replica, the default warmup, gpus_per_replica=1, so the
   replica asks for {"num_gpus": 1}), its LLM deployment's class a
   recording subclass of LLMServer (reset() and counts(): token ids and
   TTFT served, and the ragged kernel's launches by family in the
   replica's process). serve.run(app, name="llm", http_port=<a free
   port>, num_proxies=1); deploy seconds, then ready seconds (the
   replica's check_health passes and serve.status() lists it running
   and the proxy on that port). The replica must see
   CUDA_VISIBLE_DEVICES "0", run on cuda:0, load neither jax nor
   ray_tpu, and available_resources()["GPU"] must read 0 while it
   lives. Phase 4's seed-0 mix goes twice as 11 concurrent POST
   /llm/v1/completions requests (threads, urllib) to the proxy actor:
   every response a 200 text_completion, every greedy request's tokens
   (read from the replica's counts through the controller's replica
   handle) equal to phase 4's captured run bit for bit, and the ragged
   kernel launched in both families inside the replica in each pass.
   The head's directory must then hold serve:prefix:llama3-8b entries
   that name the replica. Phase 4's first greedy request goes once with
   "stream": true: the SSE chunks must join to the first pass's text
   and end in data: [DONE], its tokens phase 4's; then once to gRPC's
   /raytpu.Serve/Call (serve.start_grpc_proxy()): the same text and
   tokens. Counts are set to 0 just before the first pass and read
   after the gRPC call. The median of 20 GET /llm/v1/models round trips
   times the HTTP hop alone. serve.metrics_summary() must then show
   every HTTP request admitted and proxied, none shed, no error, the
   proxy's latency histogram, prefix-directory publishes, and the
   stream's items on the ring channel ("chan") with no stream_next
   polls. After serve.shutdown() the controller, router, replica, HTTP
   and gRPC proxy workers are gone, the GPU is back and the head's
   store holds as many objects as before the deploy; after the
   runtime's shutdown no worker of the port is left. Prints one
   serve_cluster: line with the card and its power limit.
   Its chaos step (serve_chaos), after the front door's counters and
   before the teardown: 4 threads post phase 4's greedy bodies to the
   proxy in a loop; after a first 200 the replica's process and then the
   proxy's are SIGKILLed, and the load goes on 4 s more. Every
   response must be 200, 429, 503 or 504 (no bare 500, no untyped error; a
   connection the dead proxy refused or dropped is counted apart), one
   at least a 200. The head must see the replica's death and give its
   lease back, but only once the card has freed the dead replica's
   memory (C 9): each poll reads the lease, then the card's free memory
   (torch.cuda.mem_get_info in the driver), and the first poll that
   sees the lease back must already see the memory freed (8 GiB above
   its level before the kill), so kill_to_memory_freed_s <=
   kill_to_lease_back_s, and the free memory read with the lease back is
   at that level; within CHAOS_BUDGET_S of the kill phase 4's first greedy
   request answers 200 again, the controller lists one running replica
   with a new actor id and pid, on CUDA_VISIBLE_DEVICES "0" and cuda:0,
   GPU reads 0, and the proxy answers on its port from a new pid. The
   replacement serves phase 4's greedy prompts once over HTTP with phase
   4's tokens bit for bit and the ragged kernel launched in both families
   inside it (counts at 0 just before, read just after); no
   serve:prefix:llama3-8b entry names the dead replica and
   state.hang_report() is clean. The teardown then names the
   replacements. Its figures are the serve_cluster: line's "chaos":
   statuses, seconds from the kill to the lease back (with the head's
   card_wait: how its wait ended and its seconds), to the dead
   process's end, to the controller's listing of the replacement, to the
   card's free memory rising by 8 GiB, to the proxy's answer and to the first 200, the replacement's
   ready seconds and
   programs after warmup, the card's free memory (device-wide, from the
   driver) before the kill, with the lease back, with the dead process
   gone and with the replacement ready, and the step's seconds.
4j. serve_lora: multi-LoRA across processes, inside 4h's runtime and
   behind its proxy, after 4h's app is deleted (its replica and router
   gone, the GPU back) and before 4h's serve.shutdown(). The app is
   build_openai_app's over one LLM deployment of Llama-3-8B at full
   width and 4d's depth (8 of 32 layers, TENANTS_DEPTH_CUT; seed-0
   weights made in the replica, phase 4's engine settings, the default
   warmup, gpus_per_replica=1) with phase 4d's slot table:
   3 adapter slots of rank 8 on wq/wk/wv/wo/lm_head, lora_namespace set;
   its class a recording subclass (4h's counts, plus every adapter
   resolve at admission and the engine's build and warmup seconds). The
   driver publishes 4d's three adapters (seeds 1-3; seed 2's factors as
   tensors on the card) through AdapterRegistry: payloads into the
   head's store, versions into the head's directory. Counts set to 0,
   each tenant's greedy request of 4d goes as "<model>:tenant-<s>" with
   phase 4's first greedy request as base, at once over HTTP: each
   tenant's tokens must equal 4d's bit for bit, the base request's those
   of one engine at that depth in the driver (4g's reference), and every
   tenant's first resolve must have loaded its v0. Then
   the driver publishes seed 3's adapter as v1 of tenant-1 and, after
   the refresh window (cfg.llm_lora_refresh_s + 0.1 s), sends tenant 3's
   prompt under tenant-1's id: its tokens must be 4d's tenant-3 tokens,
   served by the same replica process, its resolve loading v1. A
   request naming an adapter never published must get a 400 with
   {"error": "invalid_request"} naming it. The counts, read then, must
   show the ragged kernel launched in both families inside the replica.
   After serve.delete the replica and router are gone and the GPU is
   back; after 4h's serve.shutdown() (until then the front door's
   handles keep the failed long polls of deleted apps in the store) the
   head's store holds its count before 4h's deploy plus exactly the 4
   registry payloads inside the keep window (listed, then deleted
   before 4h's own count). Prints one serve_lora: line: deploy and
   ready seconds, the replica's build and warmup seconds and programs,
   publish ms in the driver, resolve-to-slot-loaded ms in the replica
   (first use and the swap), payload MiB per adapter, tokens/s and TTFT
   of the tenant pass, the refresh lag seen, with the card and its
   power limit.
4i. serve_pd: prefill/decode disaggregation under Serve, in a runtime
   session of its own: ray_tpu_torch.init(num_cpus=4, num_gpus=1) and a
   second node of one GPU sharing the head's store
   (cluster_utils.Cluster().add_node(num_gpus=1)); each node's lease is
   index 0 of the one card, so the two replicas share it. The app is
   build_pd_openai_app's (the OpenAI router over PDServer over one
   prefill and one decode replica of Llama-3-8B's widths with the depth
   cut to 8 of 32 layers, as 4g's, phase 4's engine settings, seed-0
   weights made in each replica,
   use_channels=True, gpus_per_replica=1), its replica classes recording
   subclasses (reset() and counts(): the ragged kernel's launches by
   family in each replica's process, the prefill side's exports with
   their payload bytes and wall times, the decode side's imports, token
   ids served and wait_cid results), the prefill replica warmed for
   prefill programs only and the decode replica for decode and verify.
   serve.run(app, name="llm", http_port=<a free port>, num_proxies=1);
   deploy seconds, then ready seconds (both replicas healthy and the
   controller's pairing seen through has_kv_channel on prefill replica
   0; it fails if the roles never pair). Both replicas must see
   CUDA_VISIBLE_DEVICES "0", run on cuda:0 in two processes, load
   neither jax nor ray_tpu, and available_resources()["GPU"] must read 0
   while they live. Phase 4's seed-0 mix goes twice as 11 concurrent
   unary POST /llm/v1/completions (the KV payloads over the sealed ring,
   the results through wait_cid), then its first greedy request once
   with "stream": true (prefill_ref, then decode_stream): every greedy
   request's tokens, read in the decode replica, equal 4g's reference
   tokens (one captured engine of the same 8-layer model) bit for bit,
   the stream's text joins to the pass's, and
   in each of the three steps (counts set to 0 just before, read just
   after) the ragged kernel launched in prefill only in the prefill
   replica and in decode only in the decode replica. The ring's counters
   (rtpu_llm_pd_chan_kv_writes_total and kv_imports_total) and the
   decode replica's wait_cid results must each equal the 22 unary
   requests. After serve.shutdown() the six Serve workers are gone, both
   GPUs are back and the head's store holds as many objects as before
   the deploy; after the runtime's shutdown no worker of the port is
   left. Prints one serve_pd: line: deploy and ready seconds, each
   replica's warmup seconds and programs, tokens/s, TTFT (call start at
   the prefill replica to import end at the decode replica) per pass,
   payload MiB per request and ms from export to import, the ring's
   counters (credit stalls included), with the card and its power limit.
5b. dense agreement: phase 5's small f32 model through InferenceEngine on
   the card and on the CPU gives identical greedy tokens; the f32
   forward kernel's launches are counted as in phase 7.

Phases run in the order 1, 2, 3, 3c, 3b, 4, 4b, 4c, 4d, 4e, 4f, 4g, 4h,
4j, 4i, 5, 5b, 6, 6b, 6c, 7; each phase's seconds on the host clock (a
phases: line) and the total seconds are printed before the kernels'
record.
The
second-to-last line is the card from nvidia-smi, the one before it the
kernels' JSON record, and the last line {"ok": true, "device": ...}.

    python3 chip_smoke.py --kernels

runs phases 1, 2, 3, 3c and 3b only (the kernels against their plain
versions, and their times), prints their records and exits 0 without the
result line: the short loop for work on a kernel.

    python3 chip_smoke.py --profile-train

runs phases 1 and 2, then one warm and one traced step of phase 6's
train step under torch.profiler, and prints the device time by kernel
family and the device's busy share of the traced step (no result line).

    python3 chip_smoke.py --profile-serve

runs phases 1 and 2, then traces serving at Llama-3-8B width: phase 4's
paged engine (captured programs) on phase 4's request mix from a fresh
seed (after a capture pass and one untraced pass), and phase 4b's dense
engine over ~20 full-batch decode steps. Prints, for each, wall and
kernel time, the device's busy share, kernels per decode dispatch /
step / token, the host time inside a decode dispatch and outside the
dispatches per engine step, the device span of the decode dispatches
(CUDA events), the kernel families and the 15 largest kernels; for the
dense step, the device time of its copies (dtype casts, contiguous
operands) by shape. Last, the batch witness: each greedy request of the
mix against itself alone (no result line).
"""
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # f32 outside the tensor cores
# kernel vs plain version, compared at real query positions only, as
# |kernel - plain| <= atol + rtol * |plain|.
# f32: both accumulate in f32 in different orders — a few ulps of values
# below ~5, far inside atol 2e-5.
# bf16: B1 and B2 round the unnormalised p to bf16 before p.V, where the
# Pallas kernels round it; the plain versions keep p in f32. That moves
# each term by at most 2^-9 of itself, at random, so an output drifts by
# about 2^-9 / sqrt(keys) of its row's scale, far below one bf16 ulp of
# the output (2^-8 to 2^-7 of it); both sides then round the output to
# bf16 from f32 values that close, so they land at most one bf16 ulp
# apart: rtol 2^-7, plus atol 1e-2 for outputs near 0. The long rows
# (thousands of keys, outputs of about sqrt(e / keys)) cut atol, row by
# row, to ROW_ATOL_REL of the row's largest value, as phase 3c does.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}
ROW_ATOL_REL = 2 ** -7
# Phase 4k: tp=2 in bf16 against phase 4's one-device engine on the same
# weights. Each layer adds two row-parallel products (wo, w_down) to the
# residual. Phase 4 rounds each to bf16 out of one cuBLAS GEMM's f32
# accumulation; 4k adds two half-length f32 partial sums and rounds
# once: the same products summed in another order, so each increment
# lands within one bf16 ulp, 2^-8 of its value either way (TP_ULP).
# Taken as independent over the 2L increments, they move the final
# hidden state by about sqrt(2L) * 2^-8 of its scale; a logit is a dot
# product of it with a weight column in no particular direction to that
# error, so it moves by about that share of a typical logit, which the
# step's largest |logit| bounds: delta = sqrt(2L) * 2^-8 * max|logit|.
# An argmax can flip only where the top-2 gap is below 2 * delta (both
# logits moved toward each other), and a logprob (logit - logsumexp)
# moves by at most 2 * delta: TP_GAP_BOUND.
TP_ULP = 2 ** -8


def tp_gap_bound(n_layers: int, max_abs_logit: float) -> float:
    """Phase 4k's near-tie bound on a top-2 logit gap (and on a logprob
    difference) at one step: 2 * sqrt(2L) * TP_ULP * max|logit|."""
    return 2 * math.sqrt(2 * n_layers) * TP_ULP * max_abs_logit


TP_GAP_BOUND = "2 * sqrt(2 * n_layers) * 2**-8 * max|logit| (tp_gap_bound)"


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"probe: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return card


def build():
    from ray_tpu_torch.ops import _build
    info = _build.build_all()
    for name, rec in info.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln]
        print(f"build: {name} {rec['seconds']:.2f} s", flush=True)
        for ln in ptxas:
            print(f"  ptxas: {ln}")
    return info


# mangled kernel name -> (kernel, dtype, head_dim, warps or None), for the
# flash, ragged and paged decode libraries
_KERNEL_SYMBOL = re.compile(
    r"(flash_(?:fwd|dq|dkv)_kernel(?:_mma|_f32)?|rpa_kernel_mma"
    r"|rpa_kernel_f32|rpa_merge_kernel|pda_kernel)"
    r"I(f|13__nv_bfloat16)?Li(\d+)E(?:Li(\d+)E)?")
# static SASS instruction counts per kernel: tensor-core products, cp.async,
# ldmatrix (every bf16 attention kernel must have all three), and f32 FMAs
# and 16-byte shared loads (the f32 dkv kernel's ratio of the two)
_SASS_OPS = {"HMMA": r"\bHMMA\b", "LDGSTS": r"\bLDGSTS\b",
             "LDSM": r"\bLDSM\b", "FFMA": r"\bFFMA\b",
             "LDS.128": r"\bLDS\.128\b"}
_TENSOR_CORE_OPS = ("HMMA", "LDGSTS", "LDSM")
_KERNEL_LIBS = ("flash_attention", "ragged_paged_attention", "paged_attention")


def _kernel_symbol(mangled: str):
    m = _KERNEL_SYMBOL.search(mangled)
    if m is None:
        return None
    f32 = m.group(2) == "f" or m.group(1).endswith("_f32")
    return m.group(1), "float32" if f32 else "bfloat16", int(m.group(3)), \
        int(m.group(4)) if m.group(4) else None


def _smem_bytes(kernel, dtype, d, nw) -> int:
    """Dynamic shared memory per block as launched (0: static only)."""
    from ray_tpu_torch.ops import _build
    code = 1 if dtype == "bfloat16" else 0
    if kernel.startswith("flash_"):
        which = {"fwd": 0, "dq": 1, "dkv": 2}[kernel.split("_")[1]]
        return _build.load("flash_attention").flash_smem_bytes(which, code, d)
    if kernel in ("rpa_kernel_mma", "rpa_kernel_f32"):
        return _build.load("ragged_paged_attention").rpa_smem_bytes(
            code, nw or 1, d)
    if kernel == "pda_kernel":
        return _build.load("paged_attention").pda_smem_bytes(code, d)
    return 0


def check_kernel_build(build_info) -> dict:
    """Phase 2, every kernel library: each kernel's registers and spill
    bytes (ptxas -v), dynamic shared memory per block (flash_smem_bytes,
    rpa_smem_bytes, pda_smem_bytes) and its count of tensor-core (HMMA),
    asynchronous-copy (LDGSTS), ldmatrix (LDSM), f32 FMA (FFMA) and
    16-byte shared-load (LDS.128) instructions in the built SASS
    (cuobjdump). Raises unless every bf16 flash kernel (forward, dq, dkv)
    and every bf16 ragged pass-1 kernel (1, 2 and 4 warps) is the
    tensor-core one, uses the first three and spills nothing, and the f32
    flash kernels (forward, dq, dkv), the f32 ragged pass-1 kernel and
    the paged decode kernel (both dtypes) stage by cp.async and spill
    nothing, at D 64 and 128; the merge passes must not spill. Returns
    {"kernel dtype D[ NW]": record}."""
    from ray_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    report = {}
    for lib in _KERNEL_LIBS:
        for mangled, rec in _build.ptxas_kernels(
                build_info[lib]["log"]).items():
            sym = _kernel_symbol(mangled)
            if sym is not None:
                report[sym] = dict(rec)
        sass = subprocess.run([cuobjdump, "-sass", _build._lib_path(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        cur = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                sym = _kernel_symbol(m.group(1))
                cur = report.setdefault(sym, {}) if sym else None
                continue
            if cur is not None:
                for op, pattern in _SASS_OPS.items():
                    if re.search(pattern, line):
                        cur[op] = cur.get(op, 0) + 1
    out = {}
    for (kernel, dtype, d, nw), rec in sorted(
            report.items(), key=lambda kv: tuple(str(x) for x in kv[0])):
        rec["smem_bytes"] = _smem_bytes(kernel, dtype, d, nw)
        for op in _SASS_OPS:
            rec.setdefault(op, 0)
        label = f"{kernel} {dtype} D{d}" + (f" NW{nw}" if nw else "")
        out[label] = rec
        print("kernel build: " + json.dumps({"kernel": label, **rec}),
              flush=True)
        spills = rec.get("spill_stores", 1) or rec.get("spill_loads", 1)
        tensor_core = kernel.endswith("_mma")
        if dtype == "bfloat16" and (tensor_core or kernel.startswith(
                "flash_")):
            if not tensor_core or spills or \
                    not all(rec[op] for op in _TENSOR_CORE_OPS):
                raise AssertionError(f"{label}: want tensor cores, cp.async, "
                                     f"ldmatrix and no spills, got {rec}")
        if kernel in F32_CP_ASYNC and (spills or not rec["LDGSTS"]):
            raise AssertionError(f"{label}: want cp.async and no spills, "
                                 f"got {rec}")
        if kernel.endswith("merge_kernel") and spills:
            raise AssertionError(f"{label}: spills {rec}")
    missing = [k for k in PHASE2_KERNELS if k not in out]
    if missing:
        raise AssertionError(f"kernels not built: {missing}")
    return out


# -- phase 3: each kernel against its plain version ------------------------

def _attention_case(family: str, dtype, device, seed: int):
    """Inputs at the 8B serving shapes for one dispatch family (and the
    long rows at decode and verify widths); table tails (and the page
    they name) are NaN-poisoned."""
    H, KVH, D, PAGE, MAXP, P = 32, 8, 128, 16, 64, 1024
    if family.endswith("_tp2"):
        # one rank of a tp=2 mesh (phase 4k): half the heads
        family, H, KVH = family[:-len("_tp2")], H // 2, KVH // 2
    g = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.RandomState(seed)
    if family.startswith("long"):
        # two rows of 4,000 and 8,000 keys: 16 blocks, split several ways
        Q = 1 if family == "long_decode" else 5
        starts, q_lens, MAXP = np.asarray([4000, 8000]) - Q, np.full(2, Q), 512
    elif family == "decode":
        lengths = np.asarray([1, 17, 130, 256, 511, 640, 877, 1000])
        starts, q_lens, Q = lengths - 1, np.ones(8, np.int64), 1
    elif family == "prefill":
        starts = np.asarray([0, 256, 512, 640])
        q_lens = np.asarray([128, 128, 77, 128])        # ragged last chunk
        Q = 128
    else:                                              # verify
        starts = np.asarray([3, 21, 100, 255, 301, 517, 700, 900])
        q_lens, Q = np.full(8, 5), 5
    R = len(starts)
    kv_len = starts + q_lens
    poison = P - 1
    bt = np.full((R, MAXP), poison, np.int32)
    for r in range(R):
        live = -(-kv_len[r] // PAGE)
        bt[r, :live] = rng.choice(np.arange(1, P - 1), live, replace=False)
    q = torch.randn((R, Q, H, D), generator=g, device=device).to(dtype)
    kp = torch.randn((P, PAGE, KVH, D), generator=g, device=device).to(dtype)
    vp = torch.randn((P, PAGE, KVH, D), generator=g, device=device).to(dtype)
    kp[poison] = float("nan")
    vp[poison] = float("nan")
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32,  # noqa: E731
                                     device=device)
    return (q, kp, vp, as_t(bt), as_t(starts), as_t(q_lens)), kv_len


def _bound_ms(args, kv_len, dtype) -> tuple:
    """Least time the card could take: live K/V + q + out + tables moved
    once at the HBM rate, against QK^T and PV FLOPs over the causal live
    keys at the dtype's peak. Returns (ms, "bytes" | "operations")."""
    q, kp, _, bt, starts, q_lens = args
    _, _, H, D = q.shape
    KVH = kp.shape[2]
    elt = q.element_size()
    st = starts.cpu().numpy().astype(np.int64)
    ql = q_lens.cpu().numpy().astype(np.int64)
    nbytes = (2 * q.numel() * elt + int(kv_len.sum()) * KVH * D * elt * 2
              + 4 * (bt.numel() + 2 * len(st)))
    keys = sum(int((st[r] + np.arange(ql[r]) + 1).sum())
               for r in range(len(st)))
    flops = 4 * D * H * keys
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _device_ms(fn, flush, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call of fn, L2 cold: CUDA events around reps
    back-to-back (flush, fn) pairs minus the same loop of flushes alone,
    over reps; median of trials. A 1 GiB flush keeps the card busy
    longer than the host takes to enqueue the next call, so host
    overhead stays out of the figure."""
    def loop(with_fn: bool) -> float:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            flush.zero_()
            if with_fn:
                fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    for _ in range(3):
        fn()
    loop(False)
    return statistics.median(
        (loop(True) - loop(False)) / reps for _ in range(trials))


def _sdpa_call(args):
    """scaled_dot_product_attention over the gathered K/V with the same
    keep-mask (the library yardstick; the port never calls it). K/V past
    each row's live length are zeroed so the NaN tail cannot leak."""
    import torch.nn.functional as F
    q, kp, vp, bt, starts, q_lens = args
    R, Q, H, D = q.shape
    _, page, KVH, _ = kp.shape
    K = bt.shape[1] * page
    k_pos = torch.arange(K, device=q.device)
    q_pos = starts.long()[:, None] + torch.arange(Q, device=q.device)
    kv_len = (starts + q_lens).long()
    live = k_pos[None, :] < kv_len[:, None]
    keep = (k_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    k = kp[bt.long()].reshape(R, K, KVH, D)
    v = vp[bt.long()].reshape(R, K, KVH, D)
    k = torch.where(live[:, :, None, None], k, 0).transpose(1, 2)
    v = torch.where(live[:, :, None, None], v, 0).transpose(1, 2)
    qt = q.transpose(1, 2)
    mask = keep[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def _real_rows(x, q_lens):
    ql = q_lens.cpu().tolist()
    return torch.cat([x[r, :n].float().reshape(-1) for r, n in enumerate(ql)
                      if n])


RAGGED_FAMILIES = ("decode", "prefill", "verify", "long_decode",
                   "long_verify", "decode_tp2", "prefill_tp2", "verify_tp2")


def check_kernels() -> list:
    """Phase 3. Returns one record per (family, dtype)."""
    from ray_tpu_torch.ops.ragged_paged_attention import (
        num_splits, ragged_paged_attention, ragged_paged_reference,
    )
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for seed, family in enumerate(RAGGED_FAMILIES):
            args, kv_len = _attention_case(family, dtype, "cuda", seed)
            q, kp, _, bt, _, q_lens = args
            got = ragged_paged_attention(*args)
            want = ragged_paged_reference(*args)
            torch.cuda.synchronize()
            g, w = _real_rows(got, q_lens), _real_rows(want, q_lens)
            if not torch.isfinite(g).all():
                raise AssertionError(f"{family} {dtype}: non-finite output")
            err = float((g - w).abs().max())
            atol, rtol = TOL[dtype]
            if family.startswith("long"):
                # per row: min(atol, ROW_ATOL_REL x the row's largest value)
                atol = torch.cat([torch.full(
                    (n * q.shape[2] * q.shape[3],),
                    min(atol, ROW_ATOL_REL * float(want[r, :n].abs().max())),
                    device=w.device) for r, n in enumerate(q_lens.tolist())
                    if n])
            if ((g - w).abs() > atol + rtol * w.abs()).any():
                raise AssertionError(f"{family} {dtype}: |kernel - plain| "
                                     f"above atol {atol} + rtol {rtol}; "
                                     f"max abs {err}")
            lib = _sdpa_call(args)
            lib_err = float((_real_rows(lib(), q_lens) - w).abs().max())
            ms = _device_ms(lambda: ragged_paged_attention(*args), flush)
            plain_ms = _device_ms(lambda: ragged_paged_reference(*args),
                                  flush)
            library_ms = _device_ms(lib, flush)
            bound_ms, bound_by = _bound_ms(args, kv_len, dtype)
            splits = num_splits(q.shape[1], bt.shape[1], kp.shape[1])
            rec = {"family": family, "dtype": str(dtype).split(".")[-1],
                   "shape": list(q.shape), "kv_len_max": int(kv_len.max()),
                   "splits": splits, "max_abs_err": err,
                   "atol_rtol": [float(atol.min()) if torch.is_tensor(atol)
                                 else atol, rtol],
                   "library_max_abs_err": lib_err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            print("kernel: " + json.dumps(rec), flush=True)
            records.append(rec)
            del args, got, want, lib
    return records


# -- phase 3c: the decode-only kernel on its own entry point --------------

PAGED_DECODE = ("paged_decode_attention", "ray_tpu/ops/paged_attention.py:36")
# Phase 3c holds B2 to phase 3's TOL with atol cut, row by row, to
# ROW_ATOL_REL (2^-7) of the row's largest |plain| where that is smaller.
# A row of n keys gives outputs of about sqrt(e / n) (0.018 at 8,192
# keys), where a flat 1e-2 would let a kernel that dropped one of the
# row's splits pass. Rounding
# p to bf16 before p.V (relative 2^-8 per term, at random) moves an output
# by about 2^-9 of the row's typical value, and two kernels that round at
# different running maxima by about 2^-8: the largest of a row's 4,096
# such differences stays several times below 2^-7 of the row's max.


def _paged_decode_case(case: str, dtype, seed: int):
    """Phase 3c inputs at the 8B attention shape (H 32, KVH 8, D 128, page
    16): "main" is phase 3's decode rows plus a row of length 0, "long"
    one row of 8,192 tokens. Live pages are disjoint across rows; table
    tails name an all-NaN page and the slots past each row's length in
    its last live page are NaN too. Returns (q, k_pages, v_pages,
    block_table, lengths)."""
    H, KVH, D, PAGE, P = 32, 8, 128, 16, 1024
    if case == "main":
        lengths, maxp = [1, 17, 130, 256, 511, 640, 877, 1000, 0], 64
    else:
        lengths, maxp = [8192], 520
    lengths = np.asarray(lengths, np.int64)
    n_live = -(-lengths // PAGE)
    poison = P - 1
    ids = iter(np.random.RandomState(seed).permutation(np.arange(1, poison)))
    bt = np.full((len(lengths), maxp), poison, np.int32)
    for r, n in enumerate(n_live):
        bt[r, :n] = [next(ids) for _ in range(n)]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((len(lengths), H, D), generator=g, device="cuda").to(dtype)
    kp = torch.randn((P, PAGE, KVH, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, PAGE, KVH, D), generator=g, device="cuda").to(dtype)
    for t in (kp, vp):
        t[poison] = float("nan")
        for r, n in enumerate(lengths):
            if n % PAGE:
                t[int(bt[r, n // PAGE]), n % PAGE:] = float("nan")
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32,  # noqa: E731
                                     device="cuda")
    return q, kp, vp, as_t(bt), as_t(lengths)


def _as_ragged(args):
    """Decode inputs in the ragged kernel's form (q_len 1 at position
    length - 1; length-0 rows as padding), for its bound and for SDPA."""
    q, kp, vp, bt, lengths = args
    return (q[:, None].contiguous(), kp, vp, bt,
            torch.clamp(lengths - 1, min=0), torch.clamp(lengths, max=1))


def _paged_decode_batched(args, seed: int):
    """Phase 3c's batch check: each live row of ``args`` alone (its own
    table row and length) and inside a batch of the case's rows in
    reversed order plus 4 rows of random lengths on the same pool, every
    table 8 pages wider (tails naming the poison page), must give the same
    bits. Returns the rows checked."""
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    q, kp, vp, bt, lengths = args
    rng = np.random.RandomState(seed)
    n, maxp = bt.shape
    P, page = kp.shape[0], kp.shape[1]
    poison = P - 1
    wide = torch.full((n + 4, maxp + 8), poison, dtype=torch.int32,
                      device="cuda")
    wide[:n, :maxp] = bt.flip(0)
    extra = rng.randint(0, maxp * page + 1, 4)
    for i, keys in enumerate(extra):
        live = -(-int(keys) // page)
        wide[n + i, :live] = torch.as_tensor(
            rng.randint(1, poison, live), dtype=torch.int32)
    lens = torch.cat([lengths.flip(0), torch.as_tensor(
        extra, dtype=torch.int32, device="cuda")])
    qb = torch.cat([q.flip(0), torch.randn(
        (4,) + tuple(q.shape[1:]), device="cuda").to(q.dtype)])
    batched = paged_decode_attention(qb, kp, vp, wide, lens)
    rows = [r for r in range(n) if int(lengths[r]) > 0]
    for r in rows:
        alone = paged_decode_attention(q[r:r + 1], kp, vp, bt[r:r + 1],
                                       lengths[r:r + 1])
        if not torch.equal(alone[0], batched[n - 1 - r]):
            raise AssertionError(f"paged decode row {r}: alone differs from "
                                 f"batched")
    return len(rows)


def check_paged_decode() -> dict:
    """Phase 3c. Returns {"launches": kernel launches of the path run,
    "records": one per (case, dtype)}."""
    from ray_tpu_torch.ops.paged_attention import (
        decode_splits, paged_decode_attention, paged_decode_reference,
    )
    from ray_tpu_torch.ops.ragged_paged_attention import (
        ragged_decode_attention, ragged_paged_attention,
    )
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    cases = [(case, dtype, seed) for dtype in (torch.bfloat16, torch.float32)
             for seed, case in enumerate(("main", "long"), start=20)]
    inputs = [_paged_decode_case(case, dtype, seed)
              for case, dtype, seed in cases]
    torch.cuda.synchronize()
    paged_decode_attention.launches = 0          # the path starts here
    outs = [paged_decode_attention(*args) for args in inputs]
    torch.cuda.synchronize()
    launches = paged_decode_attention.launches   # the path ends here
    if launches != len(cases):
        raise AssertionError(f"paged_decode_attention launched {launches} "
                             f"times for {len(cases)} calls")
    records = []
    for (case, dtype, seed), args, got in zip(cases, inputs, outs):
        label = f"paged decode {case} {str(dtype).split('.')[-1]}"
        want = paged_decode_reference(*args)
        ragged = ragged_decode_attention(*args)
        again = paged_decode_attention(*args)
        torch.cuda.synchronize()
        live = args[4] > 0
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite output")
        if got[~live].any():
            raise AssertionError(f"{label}: a length-0 row is not 0")
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: a second launch changed bits")
        batched_rows = _paged_decode_batched(args, seed)
        atol, rtol = TOL[dtype]
        g = got[live].float()
        errs, worst = {}, {}
        for name, w in (("plain", want), ("ragged", ragged)):
            w = w[live].float()
            errs[name] = float((g - w).abs().max())
            row_atol = torch.clamp(
                ROW_ATOL_REL * w.abs().amax(dim=(1, 2), keepdim=True),
                max=atol)
            limit = row_atol + rtol * w.abs()
            worst[name] = float(((g - w).abs() / limit).max())
            if worst[name] > 1:
                raise AssertionError(f"{label}: |kernel - {name}| above "
                                     f"min(atol {atol}, {ROW_ATOL_REL} x "
                                     f"row max) + rtol {rtol}; max abs "
                                     f"{errs[name]}")
        # B1 on the same inputs, its starts and q_lens clamped once here,
        # outside the timed call (ragged_decode_attention clamps per call)
        rargs = _as_ragged(args)
        lib = _sdpa_call(rargs)
        rec = {"case": case, "dtype": str(dtype).split(".")[-1],
               "shape": list(args[0].shape),
               "lengths_max": int(args[4].max()),
               "splits": decode_splits(args[3].shape[1], args[1].shape[1]),
               "max_abs_err": errs["plain"],
               "max_abs_err_vs_ragged": errs["ragged"],
               "atol_rtol": TOL[dtype], "row_atol_rel": ROW_ATOL_REL,
               "worst_err_over_limit": worst,
               "bitwise_rows_alone_vs_batched": batched_rows,
               "ms": _device_ms(lambda: paged_decode_attention(*args), flush),
               "plain_ms": _device_ms(lambda: paged_decode_reference(*args),
                                      flush),
               "ragged_ms": _device_ms(
                   lambda: ragged_decode_attention(*args), flush),
               "ragged_kernel_ms": _device_ms(
                   lambda: ragged_paged_attention(*rargs), flush),
               "library_ms": _device_ms(lib, flush)}
        rec["bound_ms"], rec["bound_by"] = _bound_ms(
            rargs, args[4].cpu().numpy().astype(np.int64), dtype)
        # a yardstick for the bound: one cold read (a sum) of as many
        # contiguous bytes as the bound counts
        stream = torch.zeros(int(rec["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
                             // 4, device="cuda")
        rec["read_ms"] = _device_ms(stream.sum, flush)
        del stream
        print("paged_decode: " + json.dumps(rec), flush=True)
        records.append(rec)
    return {"launches": launches, "records": records}


# -- phase 3b: the flash kernels against their plain versions -------------

#: (kernel name, the TPU kernel it replaces)
FLASH_KERNELS = (
    ("flash_fwd", "ray_tpu/ops/flash_attention.py:66"),
    ("flash_dq", "ray_tpu/ops/flash_attention.py:238"),
    ("flash_dkv", "ray_tpu/ops/flash_attention.py:294"),
)
# kernel vs plain version, as |kernel - plain| <= atol + rtol * |plain|
# with atol relative to the largest |plain| of the tensor (gradients span
# orders of magnitude from one shape to the next):
# f32: the same f32 products summed in other orders (the kernel tile by
# tile with a streaming softmax, the plain version through cuBLAS) —
# atol 1e-5 of the largest value, rtol 1e-4.
# bf16: the products are exact in f32 and summed in f32, but both sides
# round to bf16 (8 significant bits) at different points: the kernel
# rounds the unnormalised per-tile p before p.V, the plain version the
# normalised p; ds and the outputs round once each, from f32 values a few
# ulps apart, so an entry can land one bf16 ulp (2^-7 of it) away, and
# a sum over thousands of rounded terms drifts by up to 2^-8 of the
# largest value. lse is f32 on both sides from exact products: f32 rule.
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -8, 2 ** -7)}
#: the f32 kernel of each flash entry point (CUDA cores)
F32_KERNEL = {"flash_fwd": "flash_fwd_kernel_f32",
              "flash_dq": "flash_dq_kernel_f32",
              "flash_dkv": "flash_dkv_kernel_f32"}
#: kernels that must stage by cp.async and spill nothing (phase 2)
F32_CP_ASYNC = (*F32_KERNEL.values(), "rpa_kernel_f32", "pda_kernel")
#: every kernel build phase 2 must find, as "kernel dtype D[ NW]"
PHASE2_KERNELS = (
    [f"flash_{k}_kernel_mma bfloat16 D{d}" for k in ("fwd", "dq", "dkv")
     for d in (64, 128)]
    + [f"rpa_kernel_mma bfloat16 D{d} NW{nw}" for d in (64, 128)
       for nw in (1, 2, 4)]
    + [f"rpa_kernel_f32 float32 D{d}" for d in (64, 128)]
    + [f"{k} float32 D{d}" for k in F32_KERNEL.values() for d in (64, 128)]
    + [f"pda_kernel {t} D{d}" for t in ("float32", "bfloat16")
       for d in (64, 128)])
TRAIN_LAYERS = 8        # of Llama-3-8B's 32: AdamW state must fit in 80 GB
# phase 4e: Mixtral-8x7B's expert count and routing on llama3_8b, which
# has every other Mixtral width (dim 4096, 32/8 heads, FFN 14336)
MOE_8X7B = dict(moe_experts=8, moe_top_k=2)
MOE_LAYERS = 8
MOE_DEPTH_CUT = ("8 of 32 layers: 32 layers of this config are 45B "
                 "parameters, ~90 GB in bf16, more than the card's 80 GB")
# EngineConfig's prefill buckets at phase 4b's max_seq_len 1024
SERVE_BUCKETS = (32, 64, 128, 256, 512, 1024)
# phase 4g at 8 of Llama-3-8B's 32 layers (full widths): its checks are
# on transport (TCP, two stores, a second driver, the node's loss), and
# the whole smoke stays near 600 s with 4i beside it
CLUSTER_LAYERS = 8
CLUSTER_DEPTH_CUT = ("8 of 32 layers: 4g holds transport, not depth; its "
                     "greedy tokens come from one engine at that depth")
# phase 4f at 4g's depth, against 4g's reference tokens, to keep the
# smoke's time with 6b beside it
RUNTIME_DEPTH_CUT = ("8 of 32 layers: 4f holds the runtime's lease and "
                     "actor path, not depth; its greedy tokens are 4g's "
                     "reference")
# phase 4i at 4g's depth, against 4g's reference tokens, to keep the
# smoke's time with 4j beside it
PD_DEPTH_CUT = ("8 of 32 layers: 4i holds the KV handoff between two "
                "replicas, not depth; its greedy tokens are 4g's reference")
# phase 4c at 4g's depth, to keep the smoke's time with 4h's chaos step
# beside it: its checks compare the app's answers with each other and
# with the engine's own counters, at any depth
SERVER_DEPTH_CUT = ("8 of 32 layers: 4c holds the OpenAI app in process "
                    "(burst, threads, chat, stream, telemetry), not depth")
# phases 4d and 4j (whose tenants' reference tokens are 4d's) at 4g's
# depth, for the same reason; 4j's base request is held to 4g's reference
TENANTS_DEPTH_CUT = ("8 of 32 layers: 4d and 4j hold adapters, the spill "
                     "tier, KV payloads and the registry, not depth; 4j's "
                     "base request is held to 4g's reference")


def _flash_inputs(b, sq, sk, h, kvh, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    return mk(b, sq, h, d), mk(b, sk, kvh, d), mk(b, sk, kvh, d), \
        mk(b, sq, h, d)


def _visible_pairs(b, sq, sk, h, causal) -> int:
    """(query, key) pairs a query head sees, times B and H: query i sees
    min(i + 1, Sk) keys under top-left causal masking, Sk otherwise."""
    if not causal:
        return b * h * sq * sk
    n = min(sq, sk)
    per_head = n * (n + 1) // 2 + max(0, sq - sk) * sk
    return b * h * per_head


def _flash_bounds(q, k, causal) -> dict:
    """Least time per kernel: bytes moved once (q, k, v, dO and the
    outputs in the input dtype, lse/delta f32) at the HBM rate against
    4·D (forward), 6·D (dq) and 8·D (dkv) FLOPs per visible pair and
    head at the dtype's peak. Returns {name: (ms, "bytes"|"operations")}."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    elt = q.element_size()
    qb, kb, rows = b * sq * h * d * elt, b * sk * kvh * d * elt, b * h * sq * 4
    nbytes = {"flash_fwd": 2 * qb + 2 * kb + rows,
              "flash_dq": 3 * qb + 2 * kb + 2 * rows,
              "flash_dkv": 2 * qb + 4 * kb + 2 * rows}
    pairs = _visible_pairs(b, sq, sk, h, causal)
    flops = {"flash_fwd": 4 * d * pairs, "flash_dq": 6 * d * pairs,
             "flash_dkv": 8 * d * pairs}
    out = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S
        t_ops = flops[name] / PEAK_FLOPS[q.dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _close(label, got, want, dtype) -> float:
    """Raise unless got is finite and within FLASH_TOL of want; returns
    the max abs error."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    atol_rel, rtol = FLASH_TOL[torch.float32 if label.endswith("lse")
                               else dtype]
    err = (g - w).abs()
    atol = atol_rel * float(w.abs().max())
    if (err > atol + rtol * w.abs()).any():
        raise AssertionError(f"{label}: |kernel - plain| above atol "
                             f"{atol:.3g} + rtol {rtol}; max abs "
                             f"{float(err.max()):.3g}")
    return float(err.max())


def _sdpa_calls(q, k, v, dout):
    """scaled_dot_product_attention forward, and its autograd backward
    (dq, dk and dv together), on the same inputs: the library yardstick,
    timed only, never called by the port."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    out = fwd()
    gt = dout.transpose(1, 2)
    return fwd, lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                            retain_graph=True)


def check_flash_kernels() -> dict:
    """Phase 3b. Every case compares out, lse, dq, dk and dv with the
    plain versions; the 8B causal case is also timed. Returns
    {"max_abs_err": {kernel: err}, "timed": {dtype: {kernel: {...}}}}."""
    from ray_tpu_torch.ops.flash_attention import (
        delta_rows, flash_backward_reference, flash_dkv_kernel,
        flash_dq_kernel, flash_forward_reference, flash_fwd_kernel,
    )
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    cases = [("8b_causal", (2, 4096, 4096, 32, 8, 128), True),
             ("ragged_full", (2, 77, 140, 32, 8, 128), False),
             ("s4000_causal", (2, 4000, 4000, 32, 8, 128), True),
             # the D 64 kernels, one query head per kv head, Sq < Sk
             ("d64_g1_causal", (2, 1000, 1800, 16, 16, 64), True)]
    max_err = {name: 0.0 for name, _ in FLASH_KERNELS}
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for seed, (case, shape, causal) in enumerate(cases):
            q, k, v, dout = _flash_inputs(*shape, dtype, 10 + seed)
            scale = shape[5] ** -0.5
            out, lse = flash_fwd_kernel(q, k, v, causal, scale)
            w_out, w_lse = flash_forward_reference(q, k, v, causal, scale)
            delta = delta_rows(out, dout)
            dq = flash_dq_kernel(q, k, v, dout, lse, delta, causal, scale)
            dk, dv = flash_dkv_kernel(q, k, v, dout, lse, delta, causal,
                                      scale)
            w_dq, w_dk, w_dv = flash_backward_reference(
                q, k, v, out, lse, dout, causal, scale)
            torch.cuda.synchronize()
            errs = {"flash_fwd": max(
                        _close(f"{case} {dname} out", out, w_out, dtype),
                        _close(f"{case} {dname} lse", lse, w_lse, dtype)),
                    "flash_dq": _close(f"{case} {dname} dq", dq, w_dq,
                                       dtype),
                    "flash_dkv": max(
                        _close(f"{case} {dname} dk", dk, w_dk, dtype),
                        _close(f"{case} {dname} dv", dv, w_dv, dtype))}
            del w_out, w_lse, w_dq, w_dk, w_dv
            for name, e in errs.items():
                max_err[name] = max(max_err[name], e)
            rec = {"case": case, "dtype": dname, "shape": list(shape),
                   "causal": causal, "max_abs_err": errs}
            if case == "8b_causal":
                # no atomics: a second launch of each gives the same bits
                again = (*flash_fwd_kernel(q, k, v, causal, scale),
                         flash_dq_kernel(q, k, v, dout, lse, delta, causal,
                                         scale),
                         *flash_dkv_kernel(q, k, v, dout, lse, delta, causal,
                                           scale))
                torch.cuda.synchronize()
                for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                      (out, lse, dq, dk, dv), again):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{case} {dname} {name}: two "
                                             f"launches differ")
                rec["bitwise_repeat"] = True
                del again
            if case == "8b_causal":
                rec["timed"] = timed[dname] = _time_flash(
                    q, k, v, dout, out, lse, delta, causal, scale, flush)
            print("flash: " + json.dumps(rec), flush=True)
    serve = _check_flash_serve(flush)
    max_err["flash_fwd"] = max([max_err["flash_fwd"]] +
                               [r["max_abs_err"] for r in serve])
    return {"max_abs_err": max_err, "timed": timed, "serve": serve}


def _check_flash_serve(flush) -> list:
    """Phase 3b at the dense engine's prefill shapes: the forward kernel at
    B 1, causal, S = each prefill bucket of an 8B engine with max_seq_len
    1024, H 32, KVH 8, D 128, bf16 (what InferenceEngine._prefill gives
    it), out and lse against the plain version at FLASH_TOL, timed beside
    the plain version, SDPA and the bound. One record per bucket."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (flash_forward_reference,
                                                   flash_fwd_kernel)
    records = []
    for s in SERVE_BUCKETS:
        q, k, v, _ = _flash_inputs(1, s, s, 32, 8, 128, torch.bfloat16,
                                   30 + s)
        scale = 128 ** -0.5
        out, lse = flash_fwd_kernel(q, k, v, True, scale)
        w_out, w_lse = flash_forward_reference(q, k, v, True, scale)
        torch.cuda.synchronize()
        label = f"serve S {s} bfloat16"
        err = max(_close(f"{label} out", out, w_out, torch.bfloat16),
                  _close(f"{label} lse", lse, w_lse, torch.bfloat16))
        del w_out, w_lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bound_ms, bound_by = _flash_bounds(q, k, True)["flash_fwd"]
        rec = {"case": f"serve_s{s}", "dtype": "bfloat16",
               "shape": [1, s, s, 32, 8, 128], "causal": True,
               "max_abs_err": err,
               "ms": _device_ms(
                   lambda: flash_fwd_kernel(q, k, v, True, scale), flush),
               "plain_ms": _device_ms(
                   lambda: flash_forward_reference(q, k, v, True, scale),
                   flush),
               "library_ms": _device_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True), flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        print("flash serve: " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def _time_flash(q, k, v, dout, out, lse, delta, causal, scale, flush):
    from ray_tpu_torch.ops.flash_attention import (
        flash_backward_reference, flash_dkv_kernel, flash_dq_kernel,
        flash_forward_reference, flash_fwd_kernel,
    )
    reps, trials = 5, 3          # tens of ms per call at this shape
    ms = {"flash_fwd": _device_ms(
              lambda: flash_fwd_kernel(q, k, v, causal, scale), flush,
              reps, trials),
          "flash_dq": _device_ms(
              lambda: flash_dq_kernel(q, k, v, dout, lse, delta, causal,
                                      scale), flush, reps, trials),
          "flash_dkv": _device_ms(
              lambda: flash_dkv_kernel(q, k, v, dout, lse, delta, causal,
                                       scale), flush, reps, trials)}
    plain_fwd = _device_ms(
        lambda: flash_forward_reference(q, k, v, causal, scale), flush,
        reps, trials)
    plain_bwd = _device_ms(
        lambda: flash_backward_reference(q, k, v, out, lse, dout, causal,
                                         scale), flush, reps, trials)
    lib_fwd, lib_bwd = _sdpa_calls(q, k, v, dout)
    library_fwd = _device_ms(lib_fwd, flush, reps, trials)
    library_bwd = _device_ms(lib_bwd, flush, reps, trials)
    bounds = _flash_bounds(q, k, causal)
    # the plain backward and the library's backward compute dq, dk and dv
    # in one call: that one time stands beside both backward kernels
    plain = {"flash_fwd": plain_fwd, "flash_dq": plain_bwd,
             "flash_dkv": plain_bwd}
    library = {"flash_fwd": library_fwd, "flash_dq": library_bwd,
               "flash_dkv": library_bwd}
    return {name: {"ms": ms[name], "plain_ms": plain[name],
                   "library_ms": library[name], "bound_ms": bounds[name][0],
                   "bound_by": bounds[name][1]} for name in ms}


# -- phase 4: serve at full width ------------------------------------------

def _requests(vocab: int, seed: int):
    """~10 prompts of 30-700 tokens, two sharing a 256-token prefix (the
    second submitted last, after the first has published its pages);
    greedy, temperature and top-k rows, one asking for logprobs."""
    from ray_tpu_torch.llm import SamplingParams
    rng = np.random.RandomState(seed)
    ids = lambda n: [int(t) for t in rng.randint(0, vocab, n)]  # noqa: E731
    shared = ids(256)
    lens = [700, 120, 450, 64, 333, 90, 512, 47, 30]
    prompts = [shared + ids(60)] + [ids(n) for n in lens] + \
        [shared + ids(100)]
    kinds = [SamplingParams(max_tokens=32),
             SamplingParams(max_tokens=32, temperature=0.8),
             SamplingParams(max_tokens=32, temperature=1.0, top_k=50),
             SamplingParams(max_tokens=32, logprobs=1)]
    params = [kinds[i % len(kinds)] for i in range(len(prompts))]
    return prompts, params


def _serve_run(params, cfg, device, seed: int, eager: bool) -> dict:
    """One engine of phase 4 on phase 4's mix: captured programs (the
    default on the card) or the eager bodies. Warmup, generate the mix,
    generate it again from another seed, then two verify dispatches
    through the engine's own program (random weights rarely give the
    engine a draft); the ragged kernel's launches by family are read
    around them."""
    from ray_tpu_torch.llm import PagedInferenceEngine
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention as rpa
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    eng = PagedInferenceEngine(cfg, params=params, rng_seed=seed,
                               device=device)
    eng._eager = eager
    warm_s = eng.warmup(sample_modes=((False, False, False),
                                      (True, True, True)))
    sync()
    setup_s = time.perf_counter() - t0
    warm_programs = len(eng._graphs) if not eager and \
        eng._graphs is not None else 0
    prompts, sps = _requests(cfg.model.vocab_size, seed)
    fam = {"prefill": 0, "decode": 0, "verify": 0}

    def counted(name, fn):
        def run():
            before = rpa.launches
            fn()
            fam[name] += rpa.launches - before
        return run

    eng._prefill_step = counted("prefill", eng._prefill_step)
    eng._decode_step = counted("decode", eng._decode_step)

    graphs = eng._graphs if (eng._graphs is not None and not eager) \
        else None
    rpa.launches = 0                       # main path starts here
    t1 = time.perf_counter()
    out = eng.generate(prompts, sps)
    sync()
    gen_s = time.perf_counter() - t1
    # the mix again, from another seed (the prefix cache cannot serve
    # it): the first pass captured the keys warmup left out (logprob
    # modes), so this one replays only
    n_programs = len(graphs) if graphs is not None else 0
    prompts2, sps2 = _requests(cfg.model.vocab_size, seed + 3)
    t2 = time.perf_counter()
    out2 = eng.generate(prompts2, sps2)
    sync()
    gen2_s = time.perf_counter() - t2
    # verify family: 4 rows of 5 tokens at table width 64 on the engine's
    # caches (the engine is done: any pages will do); on the card the
    # first dispatch at this key is captured, the second replays it
    R, S1, page = 4, 5, cfg.page_size
    rng = np.random.RandomState(seed + 1)
    toks = rng.randint(0, cfg.model.vocab_size, (R, S1)).astype(np.int32)
    bts = np.zeros((R, cfg.max_pages_per_seq), np.int32)
    starts = np.asarray([3, 40, 130, 250], np.int32)
    for r in range(R):
        need = -(-(int(starts[r]) + S1) // page)
        bts[r, :need] = np.arange(1 + 20 * r, 1 + 20 * r + need)
    before = rpa.launches
    verify = [eng._verify_rows(toks, bts, starts, True) for _ in range(2)]
    sync()
    fam["verify"] = rpa.launches - before
    launches = rpa.launches                # main path ends here

    def figures(res, secs):
        n_out = sum(len(r["token_ids"]) for r in res)
        ttft = sorted(r["ttft_s"] for r in res)
        return {"generate_s": secs, "tokens_out": n_out,
                "tokens_per_s": n_out / secs,
                "ttft_median_s": ttft[len(ttft) // 2],
                "ttft_max_s": ttft[-1]}
    return {"engine": eng, "out": out + out2, "verify": verify,
            "sps": sps + sps2, "prompts": prompts + prompts2, "figures": {
                "launches": launches, "launches_by_family": fam,
                "setup_s": setup_s, "warmup_s": warm_s,
                "first_pass": figures(out, gen_s),
                "second_pass": figures(out2, gen2_s),
                "programs_after_warmup": warm_programs,
                "programs_after_first_pass": n_programs,
                "programs": len(graphs) if graphs is not None else 0,
                "capture_s_mean": (statistics.mean(graphs.capture_s)
                                   if graphs is not None
                                   and graphs.capture_s else None),
                "capture_s_max": (max(graphs.capture_s)
                                  if graphs is not None
                                  and graphs.capture_s else None)}}


def _greedy_tokens(model_cfg, device, seed: int = 0, **engine_kw) -> dict:
    """Phase 4's greedy tokens for ``model_cfg`` (seed-``seed`` weights
    made on ``device``) from one engine on captured programs, warmed by
    default, generating phase 4's mix: the reference of a phase served at
    another depth than phase 4's. Maps each greedy prompt to its ids."""
    from ray_tpu_torch.llm import PagedEngineConfig, PagedInferenceEngine
    eng = PagedInferenceEngine(PagedEngineConfig(model=model_cfg,
                                                 **engine_kw),
                               rng_seed=seed, device=device)
    eng.warmup()
    prompts, sps = _requests(model_cfg.vocab_size, seed)
    out = eng.generate(prompts, sps)
    return {tuple(p): r["token_ids"] for p, r, sp in zip(prompts, out, sps)
            if not sp.temperature}


def serve(model_cfg, device, seed: int = 0, **engine_kw) -> dict:
    """Phase 4 (also rehearsed on the CPU at tiny size, where both runs
    are eager): PagedInferenceEngine with captured programs, then one
    with eager bodies on the same weights and mixes. Each request's tokens
    and logprobs, the verify outputs, the dispatch counters, the ragged
    kernel's launches by family and every page from 1 up must be equal
    (bitwise). Returns the captured run's launches, both runs' serving
    figures and the captured engine's profile_summary() after
    estimate_flops() (each estimate held to the analytic matmul count,
    ``_matmul_flops``, within 1%). Phase 4e runs it on an MoE config."""
    from ray_tpu_torch.llm import PagedEngineConfig
    from ray_tpu_torch.models import llama

    params = llama.init(model_cfg, seed=seed, device=device)
    cfg = PagedEngineConfig(model=model_cfg, **engine_kw)
    cap = _serve_run(params, cfg, device, seed, eager=False)
    eag = _serve_run(params, cfg, device, seed, eager=True)

    vocab = model_cfg.vocab_size
    for r, sp in zip(cap["out"], cap["sps"]):
        toks_out = r["token_ids"]
        if not toks_out or len(toks_out) > sp.max_tokens or \
                not all(0 <= t < vocab for t in toks_out):
            raise AssertionError(f"bad tokens: {toks_out}")
        if sp.logprobs:
            lp = np.asarray(r["logprobs"], np.float64)
            if len(lp) != len(toks_out) or not np.isfinite(lp).all() or \
                    (lp > 1e-4).any():
                raise AssertionError(f"bad logprobs: {lp}")
    for y, lp in cap["verify"]:
        if y.shape != (4, 5) or not ((0 <= y) & (y < vocab)).all() or \
                not np.isfinite(lp).all() or (lp > 1e-4).any():
            raise AssertionError("verify outputs out of range / not finite")
    ce, ee = cap["engine"], eag["engine"]
    if ce.stats["prefix_hits"] <= 0:
        raise AssertionError(f"no prefix-cache hits: {ce.stats}")
    # captured against eager: the same kernels on the same inputs
    for i, (x, y) in enumerate(zip(cap["out"], eag["out"])):
        if x["token_ids"] != y["token_ids"] or \
                x["logprobs"] != y["logprobs"]:
            raise AssertionError(f"request {i}: captured {x['token_ids']} "
                                 f"!= eager {y['token_ids']}")
    if ce.stats != ee.stats:
        raise AssertionError(f"counters: captured {ce.stats} != eager "
                             f"{ee.stats}")
    cf, ef = cap["figures"], eag["figures"]
    if cf["launches_by_family"] != ef["launches_by_family"]:
        raise AssertionError(f"B1 launches: captured "
                             f"{cf['launches_by_family']} != eager "
                             f"{ef['launches_by_family']}")
    # the second verify dispatch rewrites the same K/V: all four agree
    y0, l0 = cap["verify"][0]
    for y, lp in cap["verify"][1:] + eag["verify"]:
        if not (np.array_equal(y, y0) and np.array_equal(lp, l0)):
            raise AssertionError("verify outputs differ")
    for a, b in zip(ce.caches, ee.caches):
        if not (torch.equal(a["k"][1:], b["k"][1:])
                and torch.equal(a["v"][1:], b["v"][1:])):
            raise AssertionError("pages differ between captured and eager")
    cuda = torch.device(device).type == "cuda"
    if cuda and cf["programs"] <= 0:
        raise AssertionError("the captured engine captured nothing")
    prof = _check_flops(ce, model_cfg, cuda)
    n_first = len(_requests(vocab, seed)[0])
    return {"greedy": {tuple(p): r["token_ids"] for p, r, sp in zip(
                cap["prompts"][:n_first], cap["out"], cap["sps"])
                if not sp.temperature},
            "launches": cf["launches"],
            "launches_by_family": cf["launches_by_family"],
            "prompt_tokens": sum(len(p) for p in cap["prompts"]),
            "dispatches": {k: ce.stats[k] for k in
                           ("prefill_dispatches", "decode_dispatches",
                            "spec_dispatches")},
            "prefix_hits": ce.stats["prefix_hits"],
            "captured": cf, "eager": ef,
            "profile": {k: prof[k] for k in (
                "compiles", "steps", "steps_by_kind", "step_wall_s",
                "flops_per_step", "mfu")},
            "mfu_counts": (("matmuls only (the FLOP counter cannot see the "
                            "ragged attention kernel)" if cuda else
                            "matmuls and the plain attention")
                           + ("; MoE layers count every dispatched expert "
                              "slot (E x C per call, FlopCounterMode), not "
                              "the routed tokens" if model_cfg.moe_experts
                              else "")),
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None),
            # what phase 4k holds its tp engine to (popped before printing)
            "_keep": {"params": params, "out": cap["out"],
                      "prompts": cap["prompts"], "sps": cap["sps"],
                      "verify": cap["verify"], "stats": dict(ce.stats),
                      "launches_by_family": cf["launches_by_family"]}}


# -- phase 4k: tensor-parallel serving on one card ------------------------

def _teacher_forced(params, mc, ids: list, page_size: int, device):
    """f32 logits [len(ids), V] of ``ids`` fed as one verify row through
    ``llama.verify_paged_rows`` on one device's ``params`` over a fresh
    pool: row i scores the token after ids[i]."""
    from ray_tpu_torch.models import llama
    pages = -(-len(ids) // page_size)
    caches = llama.init_paged_cache(mc, pages + 1, page_size, device=device)
    bt = torch.arange(1, pages + 1, dtype=torch.int32, device=device)[None]
    toks = torch.as_tensor([ids], dtype=torch.int32, device=device)
    start = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.inference_mode():
        logits, _ = llama.verify_paged_rows(params, toks, caches, bt, start,
                                            mc, page_size=page_size)
    return logits[0]


def _back_to_warm(eng) -> None:
    """An idle paged engine put back to its state right after warmup:
    an empty prefix cache, the first free lists and the sampling counter
    at 0 (the captured programs stay), so a mix replays its draws."""
    import collections
    if eng.has_work():
        raise AssertionError("engine still has work")
    for d in (eng._hash_to_page, eng._page_to_hash, eng._cached_lru,
              eng._chain_of, eng._chain_runs):
        d.clear()
    eng._page_refs[:] = 0
    eng._free_pages = list(range(1, eng.cfg.num_pages))
    eng._free_slots = collections.deque(range(eng.cfg.max_batch_size))
    eng._block_tables[:] = 0
    eng._lengths[:] = 0
    eng._rng_ctr = 0


def serve_tp(model_cfg, phase4: dict, device="cuda", seed: int = 0,
             **engine_kw) -> dict:
    """Phase 4k (also rehearsed on the CPU at tiny size): phase 4's engine
    settings with a tp=2 mesh whose ranks share one device, on phase 4's
    weight tensors (``phase4``: serve()'s "_keep"), captured programs:
    phase 4's mix, the mix from another seed and two verify dispatches
    (``_serve_run``). Held to phase 4 as the module docstring says;
    returns the figures of the mesh: line. Raises on any failure."""
    from ray_tpu_torch.llm import PagedEngineConfig
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    mesh = build_mesh(MeshSpec(tp=2), devices=[dev, dev])
    cfg = PagedEngineConfig(model=model_cfg, mesh=mesh, **engine_kw)
    mc, L = model_cfg, model_cfg.n_layers
    run = _serve_run(phase4["params"], cfg, device, seed, eager=False)
    eng, fig = run["engine"], run["figures"]
    heads = eng.params[0]["layers"]["wq"].shape[-1] // mc.head_dim
    kv_heads = eng.caches[0][0]["k"].shape[2]
    if (len(eng.params), heads, kv_heads) != (2, mc.n_heads // 2,
                                              mc.n_kv_heads // 2):
        raise AssertionError(f"4k ranks: {len(eng.params)} of H {heads} "
                             f"KVH {kv_heads}")
    # snapshots: the counting wrappers go on counting in the second pass
    st, st4 = dict(eng.stats), phase4["stats"]
    fam = dict(fig["launches_by_family"])
    fam4 = phase4["launches_by_family"]
    cuda = dev.type == "cuda"
    same_dispatches = all(st[k] == st4[k] for k in (
        "prefill_dispatches", "decode_dispatches", "spec_dispatches"))
    for name, n in fam.items():
        if cuda and n <= 0:
            raise AssertionError(f"4k: the ragged kernel never launched "
                                 f"in {name}")
        if cuda and (same_dispatches or name == "verify") and \
                n != 2 * fam4[name]:
            raise AssertionError(f"4k: {name} launches {n}, phase 4 "
                                 f"{fam4[name]} (want twice)")
    if st["mesh_reshard_bytes"] != 0 or st["mesh_input_bytes"] <= 0 or \
            st["mesh_output_bytes"] <= 0:
        raise AssertionError(f"4k mesh counters: {st}")
    if run["prompts"] != phase4["prompts"]:
        raise AssertionError("4k: not phase 4's mix")

    # greedy requests against phase 4's tokens; at a divergence, phase
    # 4's teacher-forced top-2 gap must be a near-tie (tp_gap_bound)
    divergences, matched, lp_diff = [], 0, []
    for i, (p, sp) in enumerate(zip(run["prompts"], run["sps"])):
        if sp.temperature:
            continue
        a, b = phase4["out"][i], run["out"][i]
        ta, tb = a["token_ids"], b["token_ids"]
        j = next((t for t in range(min(len(ta), len(tb))) if ta[t] != tb[t]),
                 None)
        if j is None and len(ta) != len(tb):
            j = min(len(ta), len(tb))
        upto = len(ta) if j is None else j
        matched += upto
        if j is None and not sp.logprobs:
            continue
        logits = _teacher_forced(phase4["params"], mc, list(p) + ta[:-1],
                                 cfg.page_size, dev)
        row = len(p) - 1
        if sp.logprobs:
            for t in range(upto):
                bound = tp_gap_bound(L, float(logits[row + t].abs().max()))
                d = abs(a["logprobs"][t] - b["logprobs"][t])
                if d > bound:
                    raise AssertionError(
                        f"4k request {i} step {t}: logprob {b['logprobs'][t]}"
                        f" vs phase 4's {a['logprobs'][t]} (bound {bound})")
                lp_diff.append(d)
        if j is not None:
            top = logits[row + j].topk(2)
            gap = float(top.values[0] - top.values[1])
            bound = tp_gap_bound(L, float(logits[row + j].abs().max()))
            rec = {"request": i, "step": j, "gap": gap, "bound": bound,
                   "phase4": ta[j] if j < len(ta) else None,
                   "tp2": tb[j] if j < len(tb) else None,
                   "top2_tokens": [int(t) for t in top.indices]}
            # a near-tie: both tokens are phase 4's teacher-forced top 2
            # (at step 0 too: the first token's tie is no wider), and the
            # gap between them is below the bound
            if gap >= bound or {rec["phase4"], rec["tp2"]} != set(
                    rec["top2_tokens"]):
                raise AssertionError(f"4k divergence beyond a near-tie: "
                                     f"{rec}")
            divergences.append(rec)
        del logits

    # determinism: the engine back at its warm state runs the first mix
    # again, every request equal bit for bit (sampled and top-k too)
    n_first = len(_requests(mc.vocab_size, seed)[0])
    _back_to_warm(eng)
    again = eng.generate(run["prompts"][:n_first], run["sps"][:n_first])
    for i, (x, y) in enumerate(zip(run["out"][:n_first], again)):
        if x["token_ids"] != y["token_ids"] or x["logprobs"] != y["logprobs"]:
            raise AssertionError(f"4k request {i}: second pass "
                                 f"{y['token_ids']} != {x['token_ids']}")
    sampled = sum(1 for sp in run["sps"][:n_first] if sp.temperature)
    return {"mesh": dict(eng.mesh.shape), "devices": [
                str(d) for d in eng.mesh.axis_devices("tp")],
            "rank_heads": heads, "rank_kv_heads": kv_heads,
            "launches": fig["launches"], "launches_by_family": fam,
            "phase4_launches_by_family": fam4,
            "dispatches": {k: st[k] for k in (
                "prefill_dispatches", "decode_dispatches",
                "spec_dispatches")},
            "dispatches_equal_phase4": same_dispatches,
            "counters": {k: st[k] for k in (
                "mesh_dispatches", "mesh_input_bytes", "mesh_output_bytes",
                "mesh_reshard_bytes")},
            "setup_s": fig["setup_s"], "warmup_s": fig["warmup_s"],
            "programs_after_warmup": fig["programs_after_warmup"],
            "programs": fig["programs"],
            "first_pass": fig["first_pass"],
            "second_pass": fig["second_pass"],
            "greedy_tokens_matched": matched,
            "divergences": divergences,
            "logprob_max_diff": max(lp_diff) if lp_diff else None,
            "bound": TP_GAP_BOUND,
            "second_pass_equal": n_first, "sampled_in_it": sampled,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None)}


# -- phase 5: small-input agreement ----------------------------------------

def _small_model(**kw):
    """Phases 5, 5b and 7's small f32 model: 2 layers, dim 256, head_dim
    128, GQA 2 (``MOE_SMALL`` makes it the 4-expert top-2 MoE form)."""
    from ray_tpu_torch.models import llama
    return llama.llama_tiny(**{
        **dict(vocab_size=512, dim=256, n_heads=2, n_kv_heads=1, mlp_dim=512,
               n_layers=2, max_seq_len=1024), **kw})


#: phases 5 and 7's MoE form of the small model
MOE_SMALL = dict(moe_experts=4, moe_top_k=2)


def agreement(mc, tp: int = 1):
    """The same small f32 model (``_small_model``, dense or MoE) served
    through the kernel on the card and the plain version on the CPU:
    greedy tokens identical, logprobs within 1e-4. ``tp`` > 1 (phase 5k)
    serves the card's side on a tp mesh whose ranks all sit on cuda:0."""
    from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                                   SamplingParams)
    from ray_tpu_torch.models import llama
    cpu_params = llama.init(mc, seed=3, device="cpu")
    gpu_params = {k: ({n: t.cuda() for n, t in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    cfg = PagedEngineConfig(model=mc, max_batch_size=4, page_size=16,
                            num_pages=128, max_pages_per_seq=32,
                            chunk_size=32, decode_window=4)
    card_cfg = cfg
    if tp > 1:
        from ray_tpu_torch.parallel import MeshSpec, build_mesh
        card_cfg = dataclasses.replace(cfg, mesh=build_mesh(
            MeshSpec(tp=tp), devices=[torch.device("cuda", 0)] * tp))
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(0, 512, n)]
               for n in (7, 40, 95, 150)]
    sp = SamplingParams(max_tokens=12, logprobs=1)
    card = PagedInferenceEngine(card_cfg, gpu_params, device="cuda")
    a = card.generate(prompts, sp)
    b = PagedInferenceEngine(cfg, cpu_params, device="cpu").generate(
        prompts, sp)
    for x, y in zip(a, b):
        if x["token_ids"] != y["token_ids"]:
            raise AssertionError(f"card {x['token_ids']} != "
                                 f"cpu {y['token_ids']}")
        np.testing.assert_allclose(x["logprobs"], y["logprobs"], atol=1e-4)
    if tp > 1 and card.stats["mesh_reshard_bytes"]:
        raise AssertionError(f"5k: {card.stats}")
    print(f"agreement ({'MoE ' if mc.moe_experts else ''}"
          f"{mc.n_layers} layers{f', tp={tp} on the card' if tp > 1 else ''}"
          f"): {len(prompts)} prompts, greedy tokens identical card vs CPU",
          flush=True)


# -- phase 4f: LLMServer as a one-GPU actor of the port's runtime ---------

def _phase4_bodies(vocab: int, seed: int = 0) -> list:
    """Phase 4's request mix as completions bodies."""
    prompts, sps = _requests(vocab, seed)
    return [{"prompt": p, "max_tokens": sp.max_tokens,
             "temperature": sp.temperature, "top_k": sp.top_k,
             "logprobs": sp.logprobs} for p, sp in zip(prompts, sps)]


def _banned_modules() -> list:
    return sorted(n for n in sys.modules
                  if n.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))


def _server_host(rt):
    """The actor class of phase 4f: an LLMServer that leases one GPU.
    It times its start-up, counts the ragged kernel's launches by family
    in its own process (around the engine's prefill and decode steps,
    as phase 4 does), and records each request's prompt ids, token ids
    and TTFT from the engine's results."""

    @rt.remote(num_gpus=1, max_concurrency=16)
    class ServerHost:
        def __init__(self, cfg, refs, device):
            from ray_tpu_torch.llm import LLMServer, PagedInferenceEngine
            from ray_tpu_torch.ops.ragged_paged_attention import \
                ragged_paged_attention as rpa
            self.rpa = rpa
            self.times = {}
            warm = PagedInferenceEngine.warmup

            def timed(eng, *a, **k):
                tw = time.perf_counter()
                out = warm(eng, *a, **k)
                self.times["warmup_s"] = time.perf_counter() - tw
                return out

            PagedInferenceEngine.warmup = timed
            try:
                t1 = time.perf_counter()
                self.srv = LLMServer(cfg, refs[0] if refs else None,
                                     device=device)
                self.times["server_s"] = time.perf_counter() - t1
            finally:
                PagedInferenceEngine.warmup = warm
            self.times["weights_s"] = self.times["server_s"] - \
                self.times.get("warmup_s", 0.0)
            eng = self.srv.engine
            self.fam = {"prefill": 0, "decode": 0}
            for name in self.fam:
                step = getattr(eng, f"_{name}_step")

                def counted(step=step, name=name):
                    before = rpa.launches
                    step()
                    self.fam[name] += rpa.launches - before
                setattr(eng, f"_{name}_step", counted)
            self.served = []
            result = eng._result

            def recording(req):
                out = result(req)
                self.served.append((list(req.prompt_ids),
                                    [int(t) for t in out["token_ids"]],
                                    out["logprobs"], out["ttft_s"]))
                return out
            eng._result = recording

        def programs(self):
            graphs = self.srv.engine._graphs
            return len(graphs) if graphs is not None else 0

        def info(self):
            cuda = torch.cuda.is_available()
            return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": (torch.cuda.get_device_name(0) if cuda
                               else None),
                    "device_count": torch.cuda.device_count(),
                    "pid": os.getpid(), "banned": _banned_modules(),
                    "node": os.environ.get("RTPU_NODE_ID"),
                    "times": self.times, "load_s": self.srv.load_s,
                    "programs": self.programs()}

        def reset(self):                  # main path starts here
            self.rpa.launches = 0
            self.fam = {k: 0 for k in self.fam}
            self.served = []

        def complete(self, body):
            return self.srv.completions(dict(body))

        def complete_many(self, bodies):  # the dag step's middle stage
            """Every body at once from a thread pool; each result in
            order, with its request's token ids as the engine gave
            them."""
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
                resps = list(pool.map(self.complete, bodies))
            out = []
            for body, resp in zip(bodies, resps):
                ids = next(ids for p, ids, _lp, _t in reversed(self.served)
                           if p == list(body["prompt"]))
                out.append({"response": resp, "token_ids": ids,
                            "temperature": body["temperature"]})
            return out

        def echo(self, x):
            return x

        def store_objects(self):
            """Objects in this worker's store (an own-store node's)."""
            from ray_tpu_torch.core import runtime as rt_mod
            return rt_mod.get_runtime_if_exists().store.num_objects()

        def counts(self):                 # main path ends here
            return {"launches": self.rpa.launches,
                    "launches_by_family": dict(self.fam),
                    "served": self.served, "programs": self.programs()}

        def stop(self):
            self.srv._stop = True
            self.srv._wake.set()
            self.srv._thread.join(timeout=60)

    return ServerHost


def _port_procs() -> list:
    """Live processes of the port's runtime on this machine (workers and
    node agents, whoever their parent is; zombies count as gone)."""
    alive = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and (b"ray_tpu_torch.core.worker" in cmd or
                             b"ray_tpu_torch.core.node_agent" in cmd):
            alive.append(int(pid))
    return alive


def _mix_figures(served: dict, wall: float) -> dict:
    """Tokens/s and TTFT of one mix: `served` maps prompt -> (ids, ttft)."""
    n_out = sum(len(ids) for ids, _t in served.values())
    ttft = sorted(t for _ids, t in served.values())
    return {"generate_s": wall, "tokens_out": n_out,
            "tokens_per_s": n_out / wall,
            "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1]}


def _serve_mix(rt, host, bodies: list, greedy: dict, label: str):
    """Phase 4's mix as concurrent calls to a ServerHost, between its
    reset (counts at 0) and its counts: every response well formed, the
    ragged kernel launched in both families inside the actor, and every
    greedy request's tokens equal to phase 4's. Returns (counts, served
    as prompt -> (ids, ttft), wall seconds)."""
    n_greedy = sum(1 for b in bodies if not b["temperature"])
    if not n_greedy or len(greedy) != n_greedy:
        raise AssertionError(f"phase 4 gave {len(greedy)} greedy "
                             f"results for {n_greedy} greedy requests")
    rt.get(host.reset.remote(), timeout=60)
    t0 = time.perf_counter()
    resps = rt.get([host.complete.remote(b) for b in bodies], timeout=900)
    wall = time.perf_counter() - t0
    counts = rt.get(host.counts.remote(), timeout=60)
    for r in resps:
        if r["object"] != "text_completion" or not r["choices"]:
            raise AssertionError(f"bad response {r}")
    for name, n in counts["launches_by_family"].items():
        if n <= 0:
            raise AssertionError(f"{label}: the ragged kernel never "
                                 f"launched in {name} inside the actor")
    served = {tuple(p): (ids, ttft)
              for p, ids, _lp, ttft in counts["served"]}
    if len(served) != len(bodies):
        raise AssertionError(f"{len(served)} results for "
                             f"{len(bodies)} requests")
    for i, (prompt, want) in enumerate(greedy.items()):
        got = served[prompt][0]
        if got != want:
            raise AssertionError(f"{label} greedy request {i}: actor {got} "
                                 f"!= phase 4 {want}")
    return counts, served, wall


def _actor_call_ms(rt, host) -> float:
    """The runtime's own cost of one actor call: a method that reads one
    int, called and awaited 50 times in turn; the median, in ms."""
    trips = []
    for _ in range(50):
        tc = time.perf_counter()
        rt.get(host.programs.remote(), timeout=60)
        trips.append(time.perf_counter() - tc)
    return 1e3 * statistics.median(trips)


def _params_ref_actor(rt, Host, label: str, **options) -> dict:
    """Phase 5's small f32 model put by the driver as CPU tensors and
    served on the card by a new one-GPU actor (`options` place it) that
    gets it through an ObjectRef: its greedy tokens must equal a CPU
    engine's, its logprobs within 1e-4. Returns the actor's figures."""
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   PagedInferenceEngine, SamplingParams)
    from ray_tpu_torch.models import llama
    mc = _small_model()
    cpu_params = llama.init(mc, seed=3, device="cpu")
    small = PagedEngineConfig(model=mc, max_batch_size=4, page_size=16,
                              num_pages=128, max_pages_per_seq=32,
                              chunk_size=32, decode_window=4)
    host = Host.options(**options).remote(
        LLMConfig(model_id="small", engine=small), [rt.put(cpu_params)],
        "cuda")
    info = rt.get(host.info.remote(), timeout=600)
    if info["visible"] != "0" or info["banned"]:
        raise AssertionError(f"{label} params_ref actor: {info}")
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(0, 512, n)]
               for n in (7, 40, 95, 150)]
    rt.get(host.reset.remote(), timeout=60)
    rt.get([host.complete.remote({"prompt": p, "max_tokens": 12,
                                  "logprobs": 1}) for p in prompts],
           timeout=600)
    counts = rt.get(host.counts.remote(), timeout=60)
    served = {tuple(p): (ids, lp) for p, ids, lp, _t in counts["served"]}
    want = PagedInferenceEngine(small, cpu_params, device="cpu").generate(
        prompts, SamplingParams(max_tokens=12, logprobs=1))
    for p, w in zip(prompts, want):
        ids, lp = served[tuple(p)]
        if ids != w["token_ids"]:
            raise AssertionError(f"{label} params_ref actor {ids} != CPU "
                                 f"{w['token_ids']}")
        np.testing.assert_allclose(lp, w["logprobs"], atol=1e-4)
    if counts["launches"] <= 0:
        raise AssertionError(f"{label} params_ref actor: no ragged launch")
    rt.get(host.stop.remote(), timeout=120)
    rt.kill(host)
    return {"prompts": len(prompts), "pid": info["pid"],
            "node": info["node"],
            "get_s": info["load_s"]["get_s"],
            "to_device_s": info["load_s"]["to_device_s"],
            "launches": counts["launches"],
            "launches_by_family": counts["launches_by_family"]}


def _collect_class(rt):
    """The last stage of the dag step: a CPU actor that takes the 8B
    stage's results and returns each one's token ids and greedy flag."""

    @rt.remote(num_cpus=1)
    class Collect:
        def tokens(self, results):
            return [(r["token_ids"], not r["temperature"]) for r in results]

    return Collect


def _dag_run(rt, cdag, host, bodies: list, parts: list, greedy: dict,
             label: str) -> dict:
    """One run of phase 4's mix through the 8B DAG, executed as `parts`
    (slices of `bodies`), every execute before the first get: between
    the actor's reset and its counts, every greedy request's tokens must
    equal ``greedy`` and the ragged kernel must launch in both families
    inside the actor."""
    rt.get(host.reset.remote(), timeout=60)
    t0 = time.perf_counter()
    refs = [cdag.execute(bodies[a:b]) for a, b in parts]
    got = [x for ref in refs for x in ref.get(timeout_s=900)]
    wall = time.perf_counter() - t0
    counts = rt.get(host.counts.remote(), timeout=60)
    if len(got) != len(bodies):
        raise AssertionError(f"{label}: {len(got)} results for "
                             f"{len(bodies)} requests")
    n_greedy = 0
    for i, (body, (ids, is_greedy)) in enumerate(zip(bodies, got)):
        if is_greedy != (not body["temperature"]):
            raise AssertionError(f"{label} request {i}: greedy flag "
                                 f"{is_greedy}")
        if is_greedy:
            want = greedy[tuple(body["prompt"])]
            if ids != want:
                raise AssertionError(f"{label} greedy request {i}: dag "
                                     f"{ids} != phase 4 {want}")
            n_greedy += 1
    if n_greedy != len(greedy):
        raise AssertionError(f"{label}: {n_greedy} greedy results, phase 4 "
                             f"gave {len(greedy)}")
    for name, n in counts["launches_by_family"].items():
        if n <= 0:
            raise AssertionError(f"{label}: the ragged kernel never "
                                 f"launched in {name} inside the actor")
    n_out = sum(len(ids) for ids, _g in got)
    return {"executes": len(parts), "wall_s": wall, "tokens_out": n_out,
            "tokens_per_s": n_out / wall, "greedy_equal_phase4": n_greedy,
            "launches": counts["launches"],
            "launches_by_family": counts["launches_by_family"],
            "programs_after": counts["programs"]}


def _alive(pid: int) -> bool:
    """The process lives and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _await_gone(rt, pids: list, gpus: float, label: str) -> None:
    """Wait (60 s at most) until no process of ``pids`` lives and the
    runtime has ``gpus`` GPUs available again."""
    deadline = time.monotonic() + 60
    while (any(_alive(p) for p in pids) or
           rt.available_resources().get("GPU") != gpus):
        if time.monotonic() > deadline:
            raise AssertionError(
                f"{label}: workers {[p for p in pids if _alive(p)]}"
                f" alive, {rt.available_resources()}")
        time.sleep(0.1)


def _settled(read, want: int, timeout_s: float = 15.0) -> int:
    """Poll `read()` until it is at most `want`; return the last value
    (the caller compares it)."""
    deadline = time.monotonic() + timeout_s
    got = read()
    while got > want and time.monotonic() < deadline:
        time.sleep(0.1)
        got = read()
    return got


def dag_step(rt, host, collect, bodies: list, greedy: dict, store: str,
             agent_node=None, during=None) -> dict:
    """The dag step of phases 4f and 4g: the compiled-DAG layer around
    the warmed 8B actor `host`, with `collect` (a Collect actor) as the
    last stage. `store` is "shared" when every stage shares the driver's
    store, "across" when `host` sits on an own-store agent node
    (`agent_node`). `during` runs while the DAG lives. Returns the
    figures; raises on any failure."""
    import ray_tpu_torch.dag  # noqa: F401 — gives ActorMethod its .bind
    from ray_tpu_torch import state
    from ray_tpu_torch.core import flight
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.dag import InputNode
    label = f"dag ({store})"
    head_store = rt_mod.get_runtime_if_exists().store
    first = next((b for b in bodies if not b["temperature"]), None)
    if first is None or not greedy:
        raise AssertionError(f"{label}: phase 4 gave no greedy result")
    info = rt.get(host.info.remote(), timeout=60)
    fig = {"store": store}
    objects = {"head": [head_store.num_objects()]}
    if store == "across":
        objects["agent"] = [rt.get(host.store_objects.remote(), timeout=60)]
    chans = [state.summary()["active_channels"]]
    t0 = time.perf_counter()
    with InputNode() as inp:
        out = collect.tokens.bind(host.complete_many.bind(inp))
    cdag = out.experimental_compile(max_inflight=2)
    fig["compile_s"] = time.perf_counter() - t0
    if (store == "across") != bool(cdag._push_addrs):
        raise AssertionError(f"{label}: push routes {cdag._push_addrs}")
    try:
        third = -(-len(bodies) // 3)
        fig["whole"] = _dag_run(rt, cdag, host, bodies, [(0, len(bodies))],
                                greedy, label)
        fig["split"] = _dag_run(rt, cdag, host, bodies,
                                [(0, third), (third, 2 * third),
                                 (2 * third, len(bodies))], greedy, label)

        # state while the DAG lives, from the head's driver
        name = next(a for a in state.list_actors()
                    if a["actor_id"] == host._actor_id.hex())
        worker = next(w for w in state.list_workers()
                      if w["actor_id"] == name["actor_id"])
        if name["state"] != "ALIVE" or not name["name"] or \
                worker["pid"] != info["pid"] or \
                (agent_node and worker["node"] != agent_node):
            raise AssertionError(f"{label}: actor row {name}, worker row "
                                 f"{worker}, actor {info['pid']} on "
                                 f"{info['node']}")
        chans.append(state.summary()["active_channels"])
        if chans[1] - chans[0] != cdag._n_chans:
            raise AssertionError(f"{label}: active_channels {chans} for "
                                 f"{cdag._n_chans} channels")
        time.sleep(0.3)                  # every loop parks again
        stacks = state.stack_report()
        parked = [t["name"] for p in stacks["procs"]
                  if p.get("pid") == info["pid"]
                  for t in p.get("threads", [])
                  if t.get("wait", {}).get("kind") == "channel_recv"]
        if not parked:
            raise AssertionError(f"{label}: no thread of the actor's "
                                 f"worker parked on a channel")
        # one more execute after the reports: the DAG still serves
        ids, is_greedy = cdag.execute([first]).get(timeout_s=300)[0]
        if not is_greedy or ids != greedy[tuple(first["prompt"])]:
            raise AssertionError(f"{label}: last execute gave {ids}")
        # this DAG's edges (the driver's ring still holds 4f's DAG's)
        last = cdag._seq - 1
        edges = {flight.lo48(b) for bases in cdag._lands.values()
                 for b in bases}
        events = state.timeline(flight=True)["traceEvents"]
        flow = {kind: {e["args"]["chan"] for e in events
                       if e.get("name") == kind
                       and e["args"].get("seq") == last
                       and e["args"]["chan"] in edges}
                for kind in ("chan_seal", "chan_wake")}
        if flow["chan_seal"] != edges or flow["chan_wake"] != edges or \
                len(edges) != cdag._n_chans:
            raise AssertionError(f"{label}: flight flows of execute "
                                 f"{last}: {flow} for {cdag._n_chans} "
                                 f"channels")
        mem = state.memory_summary(limit=10)["object_store"]
        if mem["capacity"] <= 0:
            raise AssertionError(f"{label}: memory summary {mem}")
        fig["state"] = {"actor": name["name"], "worker_node": worker["node"],
                        "channels": cdag._n_chans, "parked": parked,
                        "flows": len(flow["chan_seal"]),
                        "store_bytes_in_use": mem["bytes_in_use"]}
        if during is not None:
            fig.update(during())
    finally:
        cdag.teardown()
    loops = rt.get(cdag._loop_refs, timeout=60)
    if not all(isinstance(n, int) for n in loops):
        raise AssertionError(f"{label}: loops returned {loops}")

    # the round trip of a one-stage DAG beside the actor call's
    with InputNode() as inp:
        out = host.echo.bind(inp)
    echo = out.experimental_compile(max_inflight=2)
    try:
        echo.execute(-1).get(timeout_s=60)
        trips = []
        for i in range(200):
            tc = time.perf_counter()
            if echo.execute(i).get(timeout_s=60) != i:
                raise AssertionError(f"{label}: echo {i}")
            trips.append(time.perf_counter() - tc)
    finally:
        echo.teardown()
    loops += rt.get(echo._loop_refs, timeout=60)
    fig["round_trip_ms_median"] = 1e3 * statistics.median(trips)
    del cdag, echo, out
    gc.collect()

    # teardown: no channel counted, every store back to its count
    chans.append(state.summary()["active_channels"])
    if chans[2] != chans[0]:
        raise AssertionError(f"{label}: active_channels {chans}")
    objects["head"].append(_settled(head_store.num_objects,
                                    objects["head"][0]))
    if store == "across":
        objects["agent"].append(_settled(
            lambda: rt.get(host.store_objects.remote(), timeout=60),
            objects["agent"][0]))
    for where, (before, after) in objects.items():
        if after > before:
            raise AssertionError(f"{label}: {where} store holds {after} "
                                 f"objects after teardown, {before} "
                                 f"before the compile")
    rt.get(host.reset.remote(), timeout=60)
    rt.get(host.complete.remote(first), timeout=300)
    served = rt.get(host.counts.remote(), timeout=60)["served"]
    if [ids for _p, ids, _lp, _t in served] != \
            [greedy[tuple(first["prompt"])]]:
        raise AssertionError(f"{label}: plain call after teardown {served}")
    fig.update({"active_channels": chans, "store_objects": objects,
                "loops_returned": loops, "card": _card()})
    print("dag: " + json.dumps(fig), flush=True)
    return fig


def runtime(model_cfg, greedy: dict, **engine_kw) -> dict:
    """Phase 4f, on the card: the port's runtime, its GPU lease and
    LLMServer as an actor. ``greedy`` maps phase 4's greedy prompts
    (tuples of ids) to the tokens of a captured engine of ``model_cfg``.
    Returns the figures; raises on any failure."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMConfig, PagedEngineConfig
    n_gpus = torch.cuda.device_count()
    card = torch.cuda.get_device_name(0)
    fig = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=n_gpus)
    try:
        fig["init_s"] = time.perf_counter() - t0

        @rt.remote
        def cpu_report():
            return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "cuda": torch.cuda.is_available(),
                    "banned": _banned_modules(), "pid": os.getpid()}

        cpu = rt.get(cpu_report.remote(), timeout=300)
        if cpu["visible"] != "" or cpu["cuda"] or cpu["banned"]:
            raise AssertionError(f"CPU task: {cpu}")
        pids = [cpu["pid"]]
        Host = _server_host(rt)

        # the 8B server: seed-0 weights made in the actor, phase 4's mix
        t1 = time.perf_counter()
        # LLMServer's default warmup (the greedy keys): the first pass
        # captures the sampled and logprob keys in traffic, the second
        # replays them. Warming the sampled keys too (warmup_sampled)
        # made the warmup 3.8x longer on the H100 (65.6 s against 17.4)
        host = Host.options(name="llama3-8b").remote(LLMConfig(
            model_id="llama3-8b", warmup=True,
            engine=PagedEngineConfig(model=model_cfg, **engine_kw)),
            [], "cuda")
        info = rt.get(host.info.remote(), timeout=900)
        # start-up: the spawn (process, imports, the card's context),
        # then LLMServer's engine build (seeded weights, KV pages) and
        # its warmup (every program captured)
        start = time.perf_counter() - t1
        fig.update({"actor_start_s": start,
                    "actor_spawn_s": start - info["times"]["server_s"],
                    "actor_weights_s": info["times"]["weights_s"],
                    "actor_warmup_s": info["times"].get("warmup_s"),
                    "programs_after_warmup": info["programs"]})
        pids.append(info["pid"])
        if info["visible"] != "0" or info["device"] != card or \
                info["banned"]:
            raise AssertionError(f"8B actor: {info} (driver card {card})")
        time.sleep(0.5)
        gpu_held = rt.available_resources().get("GPU")
        if gpu_held != 0.0:
            raise AssertionError(f"GPU available {gpu_held} while the "
                                 f"actor holds the card")
        counts, served, wall = _serve_mix(
            rt, host, _phase4_bodies(model_cfg.vocab_size), greedy, "4f")
        fig.update({
            "launches": counts["launches"],
            "launches_by_family": counts["launches_by_family"],
            "greedy_equal_phase4": len(greedy),
            "first_pass": _mix_figures(served, wall),
            "programs_after_first_pass": counts["programs"],
            "gpu_available_while_held": gpu_held})
        # phase 4's second mix (seed 3), timed only: the keys captured in
        # traffic are replayed now
        bodies = _phase4_bodies(model_cfg.vocab_size, seed=3)
        t3 = time.perf_counter()
        rt.get([host.complete.remote(b) for b in bodies], timeout=900)
        wall = time.perf_counter() - t3
        second = rt.get(host.counts.remote(), timeout=60)
        fig["second_pass"] = _mix_figures(
            {tuple(p): (ids, ttft) for p, ids, _lp, ttft in
             second["served"][len(served):]}, wall)
        # keys the second mix met first in traffic are captured there
        fig["programs_after_second_pass"] = second["programs"]
        fig["actor_call_ms_median"] = _actor_call_ms(rt, host)
        # the dag step: every stage in the driver's store
        t4 = time.perf_counter()
        fig["dag"] = dag_step(rt, host, _collect_class(rt).remote(),
                              _phase4_bodies(model_cfg.vocab_size), greedy,
                              "shared")
        fig["dag"]["step_s"] = time.perf_counter() - t4
        rt.get(host.stop.remote(), timeout=120)
        rt.kill(host)
        deadline = time.monotonic() + 60
        while rt.available_resources().get("GPU") != float(n_gpus):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"GPU not returned after kill: "
                    f"{rt.available_resources()}")
            time.sleep(0.1)
        fig["gpu_available_after_kill"] = \
            rt.available_resources().get("GPU")

        # params_ref: phase 5's small f32 model put as CPU tensors; a new
        # one-GPU actor gets index 0 again and serves it on the card
        fig["params_ref"] = _params_ref_actor(rt, Host, "4f")
        pids.append(fig["params_ref"].pop("pid"))
        fig["params_ref"].pop("node")

        # a CUDA tensor put by the driver arrives in a CPU task as an
        # equal CPU tensor
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(1000, 257, device="cuda", generator=g)
        sent = {"f32": x, "bf16": x.to(torch.bfloat16)}

        @rt.remote
        def host_copy(t):
            return ({k: (str(v.device), str(v.dtype)) for k, v in t.items()},
                    os.environ.get("CUDA_VISIBLE_DEVICES"), t)

        kinds, visible, back = rt.get(host_copy.remote(rt.put(sent)),
                                      timeout=120)
        if visible != "" or kinds != {"f32": ("cpu", "torch.float32"),
                                      "bf16": ("cpu", "torch.bfloat16")}:
            raise AssertionError(f"tensors in the CPU task: {kinds}, "
                                 f"visible {visible!r}")
        for k, v in sent.items():
            if not torch.equal(back[k], v.cpu()):
                raise AssertionError(f"{k} tensor changed through the store")
        fig["tensor_through_store"] = kinds
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _port_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    if _port_procs():
        raise AssertionError(f"port workers left alive: {_port_procs()}")
    fig["workers_seen"] = len(pids)
    return fig


# -- phase 4g: the runtime across hosts --------------------------------------

# the second driver of phase 4g: a process of its own that attaches to the
# running head through its cluster file, as a user's second program would
_SECOND_DRIVER = """
import json, sys, time
t0 = time.perf_counter()
import ray_tpu_torch as rt
rt.init(address=sys.argv[1])
attach_s = time.perf_counter() - t0
host = rt.get_actor(sys.argv[2])
with open(sys.argv[3]) as f:
    body = json.load(f)
t1 = time.perf_counter()
rt.get(host.complete.remote(body), timeout=600)
call_s = time.perf_counter() - t1
from ray_tpu_torch import state
listed = any(a["name"] == sys.argv[2] and a["state"] == "ALIVE"
             for a in state.list_actors())
served = rt.get(host.counts.remote(), timeout=60)["served"]
tokens = [ids for p, ids, _lp, _t in served if p == body["prompt"]][-1]
banned = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                       "ray_tpu"))
rt.shutdown()
print(json.dumps({"attach_s": attach_s, "call_s": call_s,
                  "tokens": tokens, "banned": banned, "listed": listed}),
      flush=True)
"""


def _checksum(t) -> int:
    """Sum of a tensor's 16-bit words as int64, in slices (no full-size
    int64 copy)."""
    words = t.reshape(-1).view(torch.int16)
    return sum(int(c.sum(dtype=torch.int64))
               for c in words.split(1 << 24))


def _second_driver(cluster_file: str, actor: str, body: dict) -> dict:
    """Run _SECOND_DRIVER from a temporary file (a worker process of the
    port re-imports its driver's main module, so never from stdin) with
    the shadow sitecustomize first on its path, as the port's workers
    have it; returns its JSON line."""
    import tempfile
    from ray_tpu_torch.cluster_utils import agent_env
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "second_driver.py")
        with open(script, "w") as f:
            f.write(_SECOND_DRIVER)
        body_path = os.path.join(d, "body.json")
        with open(body_path, "w") as f:
            json.dump(body, f)
        env = agent_env()
        env["PYTHONPATH"] = os.pathsep.join(
            [env["PYTHONPATH"], os.path.dirname(os.path.abspath(__file__))])
        run = subprocess.run([sys.executable, script, cluster_file, actor,
                              body_path], env=env, capture_output=True,
                             text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"4g second driver failed ({run.returncode}):"
                             f" {run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def cluster(model_cfg, greedy: dict, **engine_kw) -> dict:
    """Phase 4g, on the card: a head without a GPU and a node agent that
    joins it over TCP with the card and its own store; the 8B LLMServer
    actor on the agent's node, a second driver, objects across the two
    stores, and the loss of the agent's node. ``greedy`` maps phase 4's
    greedy prompts to the captured run's tokens. Returns the figures;
    raises on any failure."""
    import glob

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import node_agent
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.llm import LLMConfig, PagedEngineConfig
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy
    card = torch.cuda.get_device_name(0)
    st = os.statvfs("/dev/shm")
    shm_free = st.f_bavail * st.f_frsize
    # the agent's own store: at most half of what /dev/shm has free; the
    # head's store is as large, so that both fit together
    cap = min(shm_free // 2, 4 << 30)
    print(f"4g: /dev/shm free {shm_free} bytes, agent store {cap} "
          f"bytes", flush=True)
    fig = {"shm_free_bytes": shm_free, "agent_store_bytes": cap}
    t0 = time.perf_counter()
    rt.init(num_cpus=2, num_gpus=0, object_store_memory=cap)
    try:
        fig["init_s"] = time.perf_counter() - t0
        with node_agent("gpu-node", num_cpus=2, num_gpus=1, own_store=True,
                        store_capacity=cap) as agent:
            fig["agent_register_s"] = agent.register_s
            print(f"4g: agent registered in {agent.register_s:.3f} s",
                  flush=True)
            rows = {n["NodeID"]: n for n in rt.nodes()}
            head_row = next(n for n in rows.values()
                            if n["NodeName"] == "head")
            if rows[agent.node_id]["Resources"].get("GPU") != 1.0 or \
                    head_row["Resources"].get("GPU"):
                raise AssertionError(f"4g nodes: {list(rows.values())}")
            pin = NodeAffinitySchedulingStrategy(node_id=agent.node_id,
                                                 soft=False)
            Host = _server_host(rt)

            # the 8B server on the agent's node, as in 4f
            t1 = time.perf_counter()
            host = Host.options(name="llama3-8b-agent",
                                scheduling_strategy=pin).remote(
                LLMConfig(model_id="llama3-8b", warmup=True,
                          engine=PagedEngineConfig(model=model_cfg,
                                                   **engine_kw)),
                [], "cuda")
            info = rt.get(host.info.remote(), timeout=900)
            start = time.perf_counter() - t1
            fig.update({"actor_start_s": start,
                        "actor_spawn_s": start - info["times"]["server_s"],
                        "actor_weights_s": info["times"]["weights_s"],
                        "actor_warmup_s": info["times"].get("warmup_s"),
                        "programs_after_warmup": info["programs"]})
            if info["visible"] != "0" or info["device"] != card or \
                    info["node"] != agent.node_id or info["banned"]:
                raise AssertionError(f"4g 8B actor: {info} (driver card "
                                     f"{card}, agent {agent.node_id})")
            time.sleep(0.5)
            gpu_held = rt.available_resources().get("GPU")
            if gpu_held != 0.0:
                raise AssertionError(f"GPU available {gpu_held} while the "
                                     f"actor holds the card")
            bodies = _phase4_bodies(model_cfg.vocab_size)
            counts, served, wall = _serve_mix(rt, host, bodies, greedy,
                                              "4g")
            fig.update({
                "launches": counts["launches"],
                "launches_by_family": counts["launches_by_family"],
                "greedy_equal_phase4": len(greedy),
                "mix": _mix_figures(served, wall),
                "gpu_available_while_held": gpu_held,
                "actor_call_ms_median": _actor_call_ms(rt, host)})

            # the dag step across stores (the host on the agent's store,
            # Collect on the head's node); while its DAG lives a second
            # driver attaches, finds the actor through the state API and
            # sends phase 4's first greedy request to it
            first = next(b for b in bodies if not b["temperature"])

            def second_driver() -> dict:
                second = _second_driver(
                    rt_mod.get_runtime_if_exists().cluster_file,
                    "llama3-8b-agent", first)
                if second["tokens"] != greedy[tuple(first["prompt"])] or \
                        second["banned"] or not second["listed"]:
                    raise AssertionError(f"4g second driver: {second}")
                print(f"4g: second driver attached in "
                      f"{second['attach_s']:.3f} s", flush=True)
                return {"second_driver": {
                    k: second[k] for k in ("attach_s", "call_s")}}

            collect = _collect_class(rt).options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=head_row["NodeID"], soft=False)).remote()
            t5 = time.perf_counter()
            fig["dag"] = dag_step(rt, host, collect, bodies, greedy,
                                  "across", agent_node=agent.node_id,
                                  during=second_driver)
            fig["dag"]["step_s"] = time.perf_counter() - t5
            fig["second_driver"] = fig["dag"].pop("second_driver")
            rt.get(host.stop.remote(), timeout=120)
            rt.kill(host)
            deadline = time.monotonic() + 60
            while next(n for n in rt.nodes() if n["NodeID"] ==
                       agent.node_id)["Available"].get("GPU") != 1.0:
                if time.monotonic() > deadline:
                    raise AssertionError(f"4g GPU not back after kill: "
                                         f"{rt.nodes()}")
                time.sleep(0.1)
            fig["gpu_available_after_kill"] = \
                rt.available_resources().get("GPU")

            # objects across stores: params_ref pulled into the agent's
            # store, then one large object each way
            fig["params_ref"] = _params_ref_actor(rt, Host, "4g",
                                                  scheduling_strategy=pin)
            if fig["params_ref"]["node"] != agent.node_id:
                raise AssertionError(f"4g params_ref actor ran on "
                                     f"{fig['params_ref']['node']}")
            nbytes = min(1 << 30, cap // 4)
            g = torch.Generator(device="cuda").manual_seed(13)
            x = torch.randn(nbytes // 2, device="cuda", dtype=torch.bfloat16,
                            generator=g)
            want = _checksum(x.cpu())
            t2 = time.perf_counter()
            ref = rt.put(x)               # a CUDA tensor: its host copy
            put_s = time.perf_counter() - t2
            del x

            # each side gets the object twice: the first get pulls the
            # frame across and unpickles it, the second only unpickles
            # the copy now in its own store
            @rt.remote(num_cpus=1, num_returns=2, scheduling_strategy=pin)
            def pull(refs):
                tp = time.perf_counter()
                t = rt.get(refs[0], timeout=600)
                got_s = time.perf_counter() - tp
                tp = time.perf_counter()
                rt.get(refs[0], timeout=600)
                local_s = time.perf_counter() - tp
                return ({"get_s": got_s, "local_get_s": local_s,
                         "checksum": _checksum(t),
                         "device": str(t.device), "dtype": str(t.dtype),
                         "node": os.environ.get("RTPU_NODE_ID")}, t)

            meta_ref, back_ref = pull.remote([ref])
            meta = rt.get(meta_ref, timeout=600)
            t3 = time.perf_counter()
            back = rt.get(back_ref, timeout=600)
            back_s = time.perf_counter() - t3
            t3 = time.perf_counter()
            rt.get(back_ref, timeout=600)
            back_local_s = time.perf_counter() - t3
            if meta["node"] != agent.node_id or meta["checksum"] != want or \
                    meta["dtype"] != "torch.bfloat16" or \
                    meta["device"] != "cpu" or _checksum(back) != want:
                raise AssertionError(f"4g transfer: {meta}, driver "
                                     f"checksum {want}, back "
                                     f"{_checksum(back)}")
            del back

            def way(get_s, local_s):
                return {"get_s": get_s, "local_get_s": local_s,
                        "get_GBps": nbytes / get_s / 1e9,
                        "pull_GBps": nbytes / max(get_s - local_s,
                                                  1e-9) / 1e9}

            fig["transfer"] = {
                "bytes": nbytes, "put_s": put_s,
                "to_agent": way(meta["get_s"], meta["local_get_s"]),
                "to_driver": way(back_s, back_local_s)}
            print(f"4g: {nbytes} bytes to the agent in "
                  f"{meta['get_s']:.3f} s, back in {back_s:.3f} s",
                  flush=True)
            del ref, meta_ref, back_ref

            # node loss: the agent stops (SIGTERM: its teardown deregisters
            # the node, kills its workers and removes its own store)
            t4 = time.perf_counter()
            agent.proc.terminate()
            limit = cfg.health_check_timeout_s + 10.0
            while any(n["NodeID"] == agent.node_id and n["Alive"]
                      for n in rt.nodes()) or \
                    rt.cluster_resources().get("GPU"):
                if time.perf_counter() - t4 > limit:
                    raise AssertionError(f"4g node not gone after "
                                         f"{limit} s: {rt.nodes()}")
                time.sleep(0.05)
            fig["node_loss_s"] = time.perf_counter() - t4
            fig["gpu_in_cluster_after_loss"] = \
                rt.cluster_resources().get("GPU", 0.0)
            agent.proc.wait(timeout=30)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while (_port_procs() or glob.glob("/dev/shm/ray_tpu_torch_*")) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    if _port_procs():
        raise AssertionError(f"4g port processes left: {_port_procs()}")
    if glob.glob("/dev/shm/ray_tpu_torch_*"):
        raise AssertionError(f"4g stores left: "
                             f"{glob.glob('/dev/shm/ray_tpu_torch_*')}")
    return fig


# -- phase 4h: Serve over the port's runtime -------------------------------

def _recording_server():
    """The deployment class of phase 4h: LLMServer plus reset() and
    counts(). It counts the ragged kernel's launches by family in the
    replica's own process (around the engine's prefill and decode steps,
    as phase 4 does) and records each request's prompt ids, token ids
    and TTFT from the engine's results. Defined in a function body, so
    the deployment pickles it by value."""
    from ray_tpu_torch.llm import LLMServer

    class RecordingServer(LLMServer):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            self.server_s = time.perf_counter() - t0
            from ray_tpu_torch.ops.ragged_paged_attention import \
                ragged_paged_attention as rpa
            self._rpa = rpa
            eng = self.engine
            self._fam = {"prefill": 0, "decode": 0}
            for name in self._fam:
                step = getattr(eng, f"_{name}_step")

                def counted(step=step, name=name):
                    before = rpa.launches
                    step()
                    self._fam[name] += rpa.launches - before
                setattr(eng, f"_{name}_step", counted)
            self._served = []
            result = eng._result

            def recording(req):
                out = result(req)
                self._served.append((list(req.prompt_ids),
                                     [int(t) for t in out["token_ids"]],
                                     out["ttft_s"]))
                return out
            eng._result = recording
            self._programs_at_ready = self._programs()

        def _programs(self):
            graphs = self.engine._graphs
            return len(graphs) if graphs is not None else 0

        def reset(self):                  # main path starts here
            self._rpa.launches = 0
            self._fam = {k: 0 for k in self._fam}
            self._served = []

        def counts(self):                 # main path ends here
            return {"launches": self._rpa.launches,
                    "launches_by_family": dict(self._fam),
                    "served": list(self._served),
                    "programs": self._programs(),
                    "programs_at_ready": self._programs_at_ready,
                    "server_s": self.server_s,
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(self.device), "pid": os.getpid(),
                    "banned": _banned_modules()}

    return RecordingServer


def _http_post(port: int, path: str, body: dict, timeout: float = 900):
    """(status, content type, body bytes) of one POST to the proxy."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _http_mix(port: int, bodies: list, label: str = "4h",
              app: str = "llm") -> tuple:
    """Every body at once, one thread each, to /<app>/v1/completions;
    every response must be a 200 and a well-formed text_completion.
    Returns (responses in order, wall seconds)."""
    import threading
    out = [None] * len(bodies)
    errors = []

    def send(i):
        try:
            code, _ct, raw = _http_post(port, f"{app}/v1/completions",
                                        bodies[i])
            out[i] = (code, json.loads(raw))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{label} HTTP mix failed: {errors}")
    for i, (code, resp) in enumerate(out):
        if code != 200 or resp.get("object") != "text_completion" or \
                not resp.get("choices") or "usage" not in resp:
            raise AssertionError(f"{label} request {i}: {code} {resp}")
    return [resp for _code, resp in out], wall


def _greedy_checked(served: list, bodies: list, greedy: dict,
                    label: str) -> dict:
    """prompt -> (ids, ttft) of one pass's `served` records, after
    checking one record per body and phase 4's tokens for every greedy
    body."""
    got = {tuple(p): (ids, ttft) for p, ids, ttft in served}
    if len(served) != len(bodies) or len(got) != len(bodies):
        raise AssertionError(f"{label}: {len(served)} results for "
                             f"{len(bodies)} requests")
    n_greedy = 0
    for i, body in enumerate(bodies):
        if body["temperature"]:
            continue
        ids = got[tuple(body["prompt"])][0]
        if ids != greedy[tuple(body["prompt"])]:
            raise AssertionError(f"{label} greedy request {i}: replica "
                                 f"{ids} != phase 4 "
                                 f"{greedy[tuple(body['prompt'])]}")
        n_greedy += 1
    if n_greedy != len(greedy):
        raise AssertionError(f"{label}: {n_greedy} greedy results, phase 4 "
                             f"gave {len(greedy)}")
    return got


# the chaos step of 4h: how long the replica's replacement may take to
# answer after the kill (its ready time was 37.5-46.3 s on the H100)
CHAOS_BUDGET_S = 240.0
# load threads and how long they post after the kills
CHAOS_THREADS = 4
CHAOS_LOAD_S = 4.0
# statuses a client may see while a replica or a proxy dies: a typed
# shed, a typed replica loss or timeout, or the answer itself
CHAOS_TYPED = (200, 429, 503, 504)


def _chaos_post(port: int, body: dict, timeout: float = 300,
                path: str = "llm/v1/completions"):
    """(status, None) of one POST (a completions one by default), or
    (None, the transport error's class name) when the proxy's socket
    refused or dropped the connection (its process was killed). Anything
    else raises."""
    import urllib.error
    try:
        return _http_post(port, path, body, timeout=timeout)[0], None
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None
    except urllib.error.URLError as e:
        if isinstance(e.reason, ConnectionError):
            return None, type(e.reason).__name__
        raise
    except ConnectionError as e:      # http.client.RemoteDisconnected too
        return None, type(e).__name__


def serve_chaos(rt, ctrl, replica, port: int, bodies: list, greedy: dict,
                model_id: str, cuda: bool):
    """The chaos step of phase 4h, in its runtime and behind its proxy:
    CHAOS_THREADS threads post phase 4's greedy bodies to the proxy in a
    loop; once one has answered 200, the 8B replica's process and then
    the proxy's are SIGKILLed, and the load goes on CHAOS_LOAD_S more.
    Every response must be a typed status (CHAOS_TYPED) and one at least
    a 200; a refused or dropped connection (the proxy's socket gone) is
    counted apart. The head must then see the replica's death and give
    its GPU lease back; within CHAOS_BUDGET_S of the kill phase 4's
    first greedy request answers 200 again, the controller lists one
    running replica with a new actor id and pid on index "0" (cuda:0),
    GPU reads 0.0, and the proxy answers on its port from a new pid. The
    replacement then serves phase 4's greedy prompts once over HTTP, with
    phase 4's tokens bit for bit and B1 launched in both families inside
    it; no serve:prefix entry names the dead replica, and the hang
    report is clean. Returns (figures, the replacement's handle); raises
    on any failure."""
    import collections
    import signal
    import threading

    from ray_tpu_torch import serve, state
    from ray_tpu_torch.core import directory as cdir
    from ray_tpu_torch.core import runtime as rt_mod
    t_step = time.perf_counter()
    head = rt_mod.get_runtime_if_exists()
    dep = f"llm:{model_id}"
    greedy_bodies = [b for b in bodies if not b["temperature"]]
    first = greedy_bodies[0]

    def call(actor, method):
        return rt.get(actor.handle_request.remote(method, (), {}, None),
                      timeout=900)

    def free_gib():
        return torch.cuda.mem_get_info()[0] / 2 ** 30 if cuda else None

    old_id = replica._actor_id
    old_pid = rt.get(replica._exec(lambda _i: os.getpid()), timeout=60)

    def listed(fig):
        # when the controller first lists a replica other than the dead one
        if "kill_to_replacement_listed_s" in fig:
            return
        _v, reps = rt.get(ctrl.get_replicas.remote("llm", dep), timeout=60)
        if any(r._actor_id != old_id for r in reps):
            fig["kill_to_replacement_listed_s"] = \
                time.perf_counter() - t_kill
    (proxy,) = rt.get(ctrl.get_proxies.remote(), timeout=60)
    proxy_pid = rt.get(proxy["actor"].ping.remote(), timeout=60)["pid"]
    del proxy

    codes = collections.Counter()
    transport = collections.Counter()
    errors = []
    lock = threading.Lock()
    stop = threading.Event()
    answered = threading.Event()

    def load(i):
        body = greedy_bodies[i % len(greedy_bodies)]
        while not stop.is_set():
            try:
                code, lost = _chaos_post(port, body)
            except Exception as e:  # noqa: BLE001 — re-raised below
                with lock:
                    errors.append(repr(e))
                return
            with lock:
                if lost:
                    transport[lost] += 1
                else:
                    codes[code] += 1
            if code == 200:
                answered.set()
            else:
                time.sleep(0.1)

    threads = [threading.Thread(target=load, args=(i,))
               for i in range(CHAOS_THREADS)]
    for t in threads:
        t.start()
    try:
        if not answered.wait(300):
            raise AssertionError(f"4h chaos: no 200 before the kill "
                                 f"({dict(codes)}, {errors})")
        fig = {"free_gib_before_kill": free_gib()}
        t_kill = time.perf_counter()
        os.kill(old_pid, signal.SIGKILL)
        os.kill(proxy_pid, signal.SIGKILL)
        # the proxy's own return, apart from the replica's: a private
        # route the proxy refuses itself (404), with no replica behind it
        proxy_back = {}

        def watch_proxy():
            while time.perf_counter() - t_kill < CHAOS_BUDGET_S:
                code, why = _chaos_post(port, {}, timeout=10,
                                        path="llm/_probe")
                if not why:
                    proxy_back.update(s=time.perf_counter() - t_kill,
                                      status=code)
                    return
                time.sleep(0.05)
        watcher = threading.Thread(target=watch_proxy, daemon=True)
        watcher.start()
        # the head sees the death and gives the dead worker's lease back
        # once the card has freed its memory (C 9): each poll reads the
        # lease before the card, so a lease seen back before the memory
        # would show as kill_to_memory_freed_s > kill_to_lease_back_s
        while True:
            now = time.perf_counter() - t_kill
            with head.lock:
                dead = [w for w in head.workers.values()
                        if getattr(w.proc, "pid", None) == old_pid]
                back = len(dead) == 1 and dead[0].state == "dead" and \
                    not dead[0].gpus
            if cuda and "kill_to_memory_freed_s" not in fig:
                free = free_gib()
                if free > fig["free_gib_before_kill"] + 8:
                    fig["kill_to_memory_freed_s"] = now
                    fig["free_gib_memory_freed"] = free
            if back:
                fig["kill_to_lease_back_s"] = now
                fig["card_wait"] = dead[0].card_wait
                break
            if now > 60:
                raise AssertionError(f"4h chaos: the replica's lease not "
                                     f"back 60 s after the kill ({dead})")
            time.sleep(0.005)
        fig["free_gib_lease_back"] = free_gib()
        # the dead worker's process may be gone before the head's
        # watcher has reaped it and read the card
        while _alive(old_pid) and time.perf_counter() - t_kill < 60:
            time.sleep(0.005)
        fig["kill_to_process_gone_s"] = time.perf_counter() - t_kill
        fig["free_gib_process_gone"] = free_gib()
        while time.perf_counter() - t_kill < CHAOS_LOAD_S:
            listed(fig)
            # the card's driver frees the dead process's memory after the
            # process is gone; a replacement's weights come seconds later
            if cuda and "kill_to_memory_freed_s" not in fig and \
                    free_gib() > fig["free_gib_before_kill"] + 8:
                fig["kill_to_memory_freed_s"] = time.perf_counter() - t_kill
                fig["free_gib_memory_freed"] = free_gib()
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"4h chaos: untyped failures {errors}")
    if cuda and not (fig.get("kill_to_memory_freed_s", math.inf)
                     <= fig["kill_to_lease_back_s"] and
                     fig["free_gib_lease_back"]
                     > fig["free_gib_before_kill"] + 8):
        raise AssertionError(
            f"4h chaos: the lease came back before the card freed the "
            f"dead replica's memory: {fig}")
    bad = {c: n for c, n in codes.items() if c not in CHAOS_TYPED}
    if bad or not codes[200]:
        raise AssertionError(f"4h chaos: statuses {dict(codes)}")
    fig["load"] = {"threads": CHAOS_THREADS,
                   "statuses": {str(c): n for c, n in sorted(codes.items())},
                   "connections_lost": dict(transport)}

    # recovery: phase 4's first greedy request, in turn, until a 200
    probe = collections.Counter()
    lost = collections.Counter()
    while True:
        listed(fig)
        code, why = _chaos_post(port, first)
        now = time.perf_counter() - t_kill
        if why:
            lost[why] += 1
        else:
            fig.setdefault("kill_to_proxy_answers_s", now)
            probe[code] += 1
        if code == 200:
            fig["kill_to_first_200_s"] = now
            break
        if code not in (None, *CHAOS_TYPED):
            raise AssertionError(f"4h chaos: recovery answered {code}")
        if now > CHAOS_BUDGET_S:
            raise AssertionError(f"4h chaos: no 200 within "
                                 f"{CHAOS_BUDGET_S} s of the kill "
                                 f"({dict(probe)}, {dict(lost)})")
        time.sleep(0.5)
    fig["recovery"] = {"statuses": {str(c): n
                                    for c, n in sorted(probe.items())},
                       "connections_lost": dict(lost),
                       "budget_s": CHAOS_BUDGET_S}
    watcher.join(timeout=CHAOS_BUDGET_S)
    if proxy_back.get("status") != 404:
        raise AssertionError(f"4h chaos: the proxy's own answer {proxy_back}")
    fig["kill_to_proxy_back_s"] = proxy_back["s"]

    # one running replica with a new actor id and pid, on index "0"
    _v, reps = rt.get(ctrl.get_replicas.remote("llm", dep), timeout=60)
    status = serve.status()
    running = status["applications"]["llm"]["deployments"][dep][
        "running_replicas"]
    if len(reps) != 1 or running != 1 or reps[0]._actor_id == old_id:
        raise AssertionError(f"4h chaos: replicas {reps}, running "
                             f"{running}, the dead one {old_id}")
    (new,) = reps
    info = call(new, "counts")
    if info["pid"] == old_pid or info["visible"] != "0" or \
            info["banned"] or (cuda and info["device"] != "cuda:0"):
        raise AssertionError(f"4h chaos replacement: {info}")
    if cuda and fig["kill_to_proxy_back_s"] >= info["server_s"]:
        # C 8: the proxy must not wait for the replacement's constructor
        # (the tiny CPU rehearsal's constructor is shorter than a proxy's
        # spawn: nothing to hold there)
        raise AssertionError(f"4h chaos: proxy back "
                             f"{fig['kill_to_proxy_back_s']} s after the "
                             f"kill, the replacement's constructor took "
                             f"{info['server_s']} s")
    fig.update({"replacement_ready_s": info["server_s"],
                "replacement_programs_after_warmup":
                    info["programs_at_ready"],
                "replacement_visible": info["visible"],
                "replacement_device": info["device"],
                "free_gib_replacement_ready": free_gib()})
    (proxy,) = rt.get(ctrl.get_proxies.remote(), timeout=60)
    new_proxy_pid = rt.get(proxy["actor"].ping.remote(), timeout=60)["pid"]
    del proxy
    if new_proxy_pid == proxy_pid or len(status["proxies"]) != 1 or \
            status["proxies"][0]["port"] != port:
        raise AssertionError(f"4h chaos proxy: pid {new_proxy_pid} (dead "
                             f"{proxy_pid}), {status['proxies']}")
    time.sleep(0.5)
    gpu_held = rt.available_resources().get("GPU")
    if gpu_held != 0.0:
        raise AssertionError(f"4h chaos: GPU available {gpu_held} while "
                             f"the replacement holds the card")
    fig["gpu_available_while_replacement_holds"] = gpu_held

    # the replacement serves phase 4's greedy prompts once over HTTP;
    # counts at 0 just before, read just after
    call(new, "reset")
    _resps, wall = _http_mix(port, greedy_bodies, label="4h chaos")
    counts = call(new, "counts")
    got = _greedy_checked(counts["served"], greedy_bodies, greedy,
                          "4h chaos")
    for name, n in counts["launches_by_family"].items():
        if cuda and n <= 0:
            raise AssertionError(f"4h chaos: the ragged kernel never "
                                 f"launched in {name} inside the "
                                 f"replacement")
    fig["greedy_pass"] = {**_mix_figures(got, wall),
                          "greedy_equal_phase4": len(greedy),
                          "programs_after": counts["programs"]}
    fig["launches_by_family"] = counts["launches_by_family"]

    # no directory entry names the dead replica; no hang
    prefix_dir = f"serve:prefix:{model_id}"
    deadline = time.monotonic() + 15
    while True:
        entries = (cdir.query(prefix_dir) or {}).get("entries") or {}
        stale = sum(1 for v in entries.values()
                    if getattr(v, "_actor_id", None) == old_id)
        if not stale or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    if stale:
        raise AssertionError(f"4h chaos: {stale} {prefix_dir} entries name "
                             f"the dead replica")
    fig["directory_entries_owned_by_replacement"] = sum(
        1 for v in entries.values()
        if getattr(v, "_actor_id", None) == new._actor_id)
    hangs = state.hang_report()
    if hangs["stuck_tasks"] or hangs["deadlocks"]:
        raise AssertionError(f"4h chaos hang report: {hangs}")
    fig["step_s"] = time.perf_counter() - t_step
    return fig, new


def serve_cluster(model_cfg, greedy: dict, device="cuda", tenants=None,
                  lora_model_cfg=None, lora_greedy=None,
                  **engine_kw) -> dict:
    """Phase 4h (also rehearsed on the CPU at tiny size, on a fake GPU):
    Serve over the port's runtime. ``build_openai_app``'s app (the
    OpenAI router over one LLM deployment with ``gpus_per_replica=1``,
    its class the recording subclass of LLMServer, seeded weights made
    in the replica, the default warmup) under ``serve.run(app,
    name="llm", http_port=<free>, num_proxies=1)``; phase 4's seed-0 mix
    twice over HTTP to the proxy, then one SSE stream and one gRPC call.
    ``greedy`` maps phase 4's greedy prompts to the captured run's
    tokens. With ``tenants`` (phase 4d's ``tenant_greedy``), phase 4j
    (``serve_lora``) runs behind the same proxy once 4h's app is
    deleted, on ``lora_model_cfg`` (4d's model; ``model_cfg`` when None)
    with its base request held to ``lora_greedy`` (phase 4's tokens at
    that depth; ``greedy`` when None); its figures are the result's
    ``"lora"``. Returns the
    figures; raises on any failure."""
    import socket

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import directory as cdir
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   build_openai_app)
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    cuda = torch.device(device).type == "cuda"
    model_id = "llama3-8b"
    fig = {"card": _card() if cuda else "cpu"}
    bodies = [dict(b, model=model_id)
              for b in _phase4_bodies(model_cfg.vocab_size)]
    first = next((b for b in bodies if not b["temperature"]), None)
    if first is None or not greedy:
        raise AssertionError("4h: phase 4 gave no greedy result")
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    try:
        fig["init_s"] = time.perf_counter() - t0
        head_store = rt_mod.get_runtime_if_exists().store
        objects_before = head_store.num_objects()
        app = build_openai_app([LLMConfig(
            model_id=model_id, gpus_per_replica=1, warmup=True,
            engine=PagedEngineConfig(model=model_cfg, **engine_kw))],
            device=device)
        (child,) = app.ingress.children()
        child.spec = dataclasses.replace(child.spec,
                                         func_or_class=_recording_server())
        if child.spec.ray_actor_options != {"num_gpus": 1}:
            raise AssertionError(f"4h replica options "
                                 f"{child.spec.ray_actor_options}")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t1 = time.perf_counter()
        serve.run(app, name="llm", http_port=port, num_proxies=1)
        fig["deploy_s"] = time.perf_counter() - t1
        ctrl = rt.get_actor(CONTROLLER_NAME)
        dep = f"llm:{model_id}"
        _v, (replica,) = rt.get(ctrl.get_replicas.remote("llm", dep),
                                timeout=60)

        def call(method, *args):
            return rt.get(replica.handle_request.remote(
                method, args, {}, None), timeout=900)

        # ready: the controller lists the replica running and its
        # check_health passes (its constructor, warmup included, is done)
        if not rt.get(replica.health_check.remote(), timeout=900):
            raise AssertionError("4h replica health check failed")
        status = serve.status()
        running = status["applications"]["llm"]["deployments"][dep][
            "running_replicas"]
        fig["ready_s"] = time.perf_counter() - t1
        if running != 1 or len(status["proxies"]) != 1 or \
                status["proxies"][0]["port"] != port:
            raise AssertionError(f"4h status {status}")
        info = call("counts")
        fig.update({"replica_server_s": info["server_s"],
                    "replica_visible": info["visible"],
                    "replica_device": info["device"],
                    "programs_after_warmup": info["programs"]})
        if info["visible"] != "0" or info["banned"] or \
                (cuda and info["device"] != "cuda:0"):
            raise AssertionError(f"4h replica: {info}")
        time.sleep(0.5)
        gpu_held = rt.available_resources().get("GPU")
        if gpu_held != 0.0:
            raise AssertionError(f"GPU available {gpu_held} while the "
                                 f"replica holds the card")
        fig["gpu_available_while_held"] = gpu_held

        # the mix over HTTP, twice; counts at 0 just before the first
        # pass, read after each step of the main path
        call("reset")
        passes = []
        prev = {"launches_by_family": {"prefill": 0, "decode": 0},
                "served": []}
        for i in range(2):
            resps, wall = _http_mix(port, bodies)
            if i == 0:
                resps0 = resps
            counts = call("counts")
            fam = {k: n - prev["launches_by_family"][k]
                   for k, n in counts["launches_by_family"].items()}
            for name, n in fam.items():
                if cuda and n <= 0:
                    raise AssertionError(f"4h pass {i + 1}: the ragged "
                                         f"kernel never launched in {name} "
                                         f"inside the replica")
            got = _greedy_checked(counts["served"][len(prev["served"]):],
                                  bodies, greedy, f"4h pass {i + 1}")
            passes.append({**_mix_figures(got, wall),
                           "launches_by_family": fam,
                           "greedy_equal_phase4": len(greedy),
                           "programs_after": counts["programs"]})
            prev = counts
        fig["first_pass"], fig["second_pass"] = passes

        # the directory: the replica published its pages under its handle
        prefix_dir = f"serve:prefix:{model_id}"
        deadline = time.monotonic() + 15
        owned = 0
        while not owned and time.monotonic() < deadline:
            entries = (cdir.query(prefix_dir) or {}).get("entries") or {}
            owned = sum(1 for v in entries.values()
                        if getattr(v, "_actor_id", None) ==
                        replica._actor_id)
            time.sleep(0.1)
        if not owned:
            raise AssertionError(f"4h: no {prefix_dir} entry names the "
                                 f"replica")
        fig["directory_entries_owned"] = owned

        # one stream: phase 4's first greedy request with stream=True
        code, ctype, raw = _http_post(port, "llm/v1/completions",
                                      dict(first, stream=True))
        lines = [ln for ln in raw.decode().split("\n\n") if ln]
        if code != 200 or not ctype.startswith("text/event-stream") or \
                lines[-1] != "data: [DONE]" or \
                not all(ln.startswith("data: ") for ln in lines):
            raise AssertionError(f"4h stream: {code} {ctype} {lines[-3:]}")
        chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
        text = "".join(c["choices"][0]["text"] for c in chunks)
        want_text = resps0[bodies.index(first)]["choices"][0]["text"]
        if text != want_text:
            raise AssertionError(f"4h stream text {text!r} != "
                                 f"{want_text!r}")
        counts = call("counts")
        stream_ids = counts["served"][len(prev["served"]):]
        if [ids for _p, ids, _t in stream_ids] != \
                [greedy[tuple(first["prompt"])]]:
            raise AssertionError(f"4h stream tokens {stream_ids}")
        prev = counts
        fig["stream"] = {"chunks": len(chunks),
                         "finish_reason":
                             chunks[-1]["choices"][0]["finish_reason"]}

        # one gRPC call through the generic service
        import grpc
        _gp, gport = serve.start_grpc_proxy()
        with grpc.insecure_channel(f"127.0.0.1:{gport}") as ch:
            tg = time.perf_counter()
            out = json.loads(ch.unary_unary("/raytpu.Serve/Call")(
                json.dumps({"app": "llm", "method": "v1_completions",
                            "payload": first}).encode(), timeout=900))
            fig["grpc_s"] = time.perf_counter() - tg
        counts = call("counts")               # main path ends here
        grpc_ids = counts["served"][len(prev["served"]):]
        if out.get("object") != "text_completion" or \
                out["choices"][0]["text"] != want_text or \
                [ids for _p, ids, _t in grpc_ids] != \
                [greedy[tuple(first["prompt"])]]:
            raise AssertionError(f"4h gRPC: {out}, tokens {grpc_ids}")
        fig["launches"] = counts["launches"]
        fig["launches_by_family"] = counts["launches_by_family"]
        if cuda and counts["launches"] != sum(
                counts["launches_by_family"].values()):
            raise AssertionError(f"4h launches {counts['launches']} outside "
                                 f"the counted steps "
                                 f"{counts['launches_by_family']}")

        # the HTTP hop alone: GET /llm/v1/models, 20 in turn
        import urllib.request
        trips = []
        for _ in range(20):
            tm = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/llm/v1/models",
                    timeout=60) as r:
                models = json.loads(r.read())
            trips.append(time.perf_counter() - tm)
        if [m["id"] for m in models["data"]] != [model_id]:
            raise AssertionError(f"4h models {models}")
        fig["models_round_trip_ms_median"] = 1e3 * statistics.median(trips)

        # the front door's and the directory's counters (the proxy's and
        # the replica's registries flush to the head every ~2 s)
        n_http = 2 * len(bodies) + 1 + len(trips)
        deadline = time.monotonic() + 30
        while True:
            ms = serve.metrics_summary()
            adm = ms.get("admission") or {}
            pd = ms.get("prefix_directory") or {}
            chan = (ms.get("stream") or {}).get("chan") or {}
            if adm.get("admitted", 0) >= n_http and \
                    ms["requests"]["proxy"] >= n_http and \
                    pd.get("publishes", 0) > 0 and \
                    chan.get("items", 0) >= len(chunks):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"4h metrics summary {ms}")
            time.sleep(0.5)
        if adm.get("shed", 0) != 0 or ms["requests"]["errors"] != 0 or \
                not (ms.get("e2e_latency") or {}).get("count"):
            raise AssertionError(f"4h metrics summary {ms}")
        # the stream rode the sealed ring channel (proxy <- router <-
        # replica, all in the head's store), never stream_next polls
        if (ms.get("stream") or {}).get("poll"):
            raise AssertionError(f"4h stream polled: {ms['stream']}")
        fig["metrics"] = {"admission": adm, "prefix_directory": pd,
                          "stream": ms["stream"],
                          "requests": ms["requests"],
                          "e2e_latency": ms["e2e_latency"]}
        fig["http_requests"] = n_http

        # the chaos step: the replica and the proxy SIGKILLed mid-load and
        # replaced; the teardown below names their replacements
        fig["chaos"], replica = serve_chaos(rt, ctrl, replica, port, bodies,
                                            greedy, model_id, cuda)

        # teardown: every Serve worker gone, the lease back, the store at
        # its count before the deploy
        proxies = [p["actor"] for p in rt.get(ctrl.get_proxies.remote(),
                                              timeout=60)]
        _v, actors = rt.get(ctrl.get_replicas.remote("llm", "openai-router"),
                            timeout=60)
        pids = [rt.get(a._exec(lambda _i: os.getpid()), timeout=60)
                for a in [ctrl, replica, *actors, *proxies, _gp]]
        if len(set(pids)) != 5:
            raise AssertionError(f"4h Serve workers {pids}")
        del actors, proxies, _gp, replica, ctrl
        lora_oids = []
        if tenants is not None:
            # phase 4j in this runtime and behind this proxy, once 4h's
            # app is deleted: its replica and router gone, the lease back
            serve.delete("llm")
            _await_gone(rt, pids[1:3], 1.0, "4h app deleted")
            fig["lora"], lora_oids = serve_lora(
                lora_model_cfg or model_cfg, port, tenants, first,
                (lora_greedy or greedy)[tuple(first["prompt"])], head_store,
                device, **engine_kw)
        t2 = time.perf_counter()
        serve.shutdown()
        fig["shutdown_s"] = time.perf_counter() - t2
        _await_gone(rt, pids, 1.0, "4h after shutdown")
        fig["gpu_available_after_shutdown"] = \
            rt.available_resources().get("GPU")
        gc.collect()
        want = objects_before + len(lora_oids)
        after = _settled(head_store.num_objects, want, 30.0)
        if lora_oids:
            # 4j: exactly its registry payloads inside the keep window
            # are left; the registry has no unpublish, so drop them here
            if after != want or \
                    not all(head_store.contains(o) for o in lora_oids):
                raise AssertionError(
                    f"4j: {after} objects in the store after the shutdown, "
                    f"{objects_before} before the deploy and "
                    f"{len(lora_oids)} registry payloads")
            fig["lora"]["store_objects"] = [objects_before, after]
            for o in lora_oids:
                head_store.delete(o)
            after = _settled(head_store.num_objects, objects_before, 30.0)
        if after > objects_before:
            raise AssertionError(f"4h: {after} objects in the store after "
                                 f"shutdown, {objects_before} before")
        fig["store_objects"] = [objects_before, after]
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _port_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    if _port_procs():
        raise AssertionError(f"4h port workers left: {_port_procs()}")
    return fig


def _recording_lora_server():
    """The deployment class of phase 4j: 4h's recording LLMServer plus
    the engine's build and warmup seconds and a record of every adapter
    resolve at admission (adapter id, version, slot, whether it loaded
    the slot, its ms and wall time)."""
    Base = _recording_server()

    class RecordingLoraServer(Base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            mgr = self._multilora
            resolve = mgr.resolve
            self._resolves = []

            def timed(adapter_id, *a, **kw):
                loads = mgr.stats["loads"]
                t0 = time.perf_counter()
                slot, version, salt = resolve(adapter_id, *a, **kw)
                self._resolves.append({
                    "adapter": adapter_id, "version": version, "slot": slot,
                    "loaded": mgr.stats["loads"] > loads,
                    "ms": 1e3 * (time.perf_counter() - t0),
                    "at": time.time()})
                return slot, version, salt
            mgr.resolve = timed

        def _build_engine(self, params):
            t0 = time.perf_counter()
            eng = super()._build_engine(params)
            self.build_s = time.perf_counter() - t0
            return eng

        def lora_info(self):
            return {"resolves": list(self._resolves),
                    "stats": dict(self._multilora.stats),
                    "build_s": self.build_s,
                    "refresh_s": self._multilora.refresh_s}

    return RecordingLoraServer


def serve_lora(model_cfg, port: int, tenants: list, base_body: dict,
               base_tokens: list, head_store, device="cuda",
               **engine_kw) -> dict:
    """Phase 4j (also rehearsed on the CPU at tiny size, on a fake GPU),
    inside 4h's runtime and behind its proxy on ``port``: multi-LoRA
    across processes. ``build_openai_app``'s app over one LLM deployment
    with phase 4d's slot table (3 adapter slots of rank 8 on
    wq/wk/wv/wo/lm_head, ``lora_namespace`` set), phase 4's engine
    settings, seed-0 weights made in the replica, ``gpus_per_replica=1``,
    its class the recording subclass. The driver publishes 4d's three
    adapters (seeds 1-3; seed 2's factors as tensors on the card) through
    ``AdapterRegistry`` and sends each tenant's greedy request of 4d
    (``tenants``: prompt, sampling, tokens) as ``"<model>:tenant-<s>"``
    beside phase 4's first greedy request as base, at once over HTTP;
    then publishes seed 3's adapter as v1 of tenant-1 and, after the
    refresh window, sends tenant 3's prompt under tenant-1's id; then an
    adapter never published. Returns the figures and the ids of the
    registry payloads left in the head's store (the caller counts the
    store once Serve is shut down: until then the front door's handles
    keep the failed long polls of deleted apps there); raises on any
    failure."""
    import urllib.error

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.dag.channel import slot_oid
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   build_openai_app, lora)
    from ray_tpu_torch.llm.multilora import AdapterRegistry
    from ray_tpu_torch.llm.multilora.registry import _adapter_base
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    model_id, ns, app_name = "llama3-8b", "llama3-8b-tenants", "lora"
    fig = {"card": _card() if cuda else "cpu"}
    by_seed = {t["seed"]: t for t in tenants}
    if sorted(by_seed) != [1, 2, 3]:
        raise AssertionError(f"4j: 4d gave tenants {sorted(by_seed)}")
    adapters = {s: lora.random_adapter(s, model_cfg, rank=TENANT_RANK,
                                       alpha=2.0 * TENANT_RANK,
                                       targets=TENANT_TARGETS)
                for s in (1, 2, 3)}
    # seed 2 published from the card: the store keeps its host copy
    adapters[2] = {k: (torch.from_numpy(v).to(device)
                       if k.endswith((".A", ".B")) else v)
                   for k, v in adapters[2].items()}
    fig["payload_mib"] = {
        f"seed-{s}": sum(v.nbytes if isinstance(v, np.ndarray) else
                         v.numel() * v.element_size()
                         for k, v in ad.items()
                         if k.endswith((".A", ".B"))) / 2 ** 20
        for s, ad in adapters.items()}
    def body(seed, name=None):
        t = by_seed[seed]
        return {"model": f"{model_id}:{name or f'tenant-{seed}'}",
                "prompt": t["prompt"], "max_tokens": t["max_tokens"],
                "temperature": 0.0, "logprobs": t["logprobs"]}

    app = build_openai_app([LLMConfig(
        model_id=model_id, gpus_per_replica=1, warmup=True,
        lora_namespace=ns,
        engine=PagedEngineConfig(model=model_cfg, max_adapters=4,
                                 lora_rank=TENANT_RANK,
                                 lora_targets=TENANT_TARGETS, **engine_kw))],
        device=device)
    (child,) = app.ingress.children()
    child.spec = dataclasses.replace(child.spec,
                                     func_or_class=_recording_lora_server())
    t1 = time.perf_counter()
    serve.run(app, name=app_name)
    fig["deploy_s"] = time.perf_counter() - t1
    ctrl = rt.get_actor(CONTROLLER_NAME)
    _v, (replica,) = rt.get(ctrl.get_replicas.remote(
        app_name, f"llm:{model_id}"), timeout=60)
    _v, routers = rt.get(ctrl.get_replicas.remote(app_name, "openai-router"),
                         timeout=60)

    def call(method, *args):
        return rt.get(replica.handle_request.remote(
            method, args, {}, None), timeout=900)

    if not rt.get(replica.health_check.remote(), timeout=900):
        raise AssertionError("4j replica health check failed")
    fig["ready_s"] = time.perf_counter() - t1
    info, lora_info = call("counts"), call("lora_info")
    fig.update({"replica_server_s": info["server_s"],
                "replica_build_and_warmup_s": lora_info["build_s"],
                "programs_after_warmup": info["programs"]})
    if info["visible"] != "0" or info["banned"] or \
            (cuda and info["device"] != "cuda:0"):
        raise AssertionError(f"4j replica: {info}")
    time.sleep(0.5)
    if rt.available_resources().get("GPU") != 0.0:
        raise AssertionError(f"4j: GPU available while the replica holds "
                             f"it: {rt.available_resources()}")

    # the driver publishes: v0 of each tenant
    reg = AdapterRegistry(ns)
    publish_ms = {}
    for s in (1, 2, 3):
        tp = time.perf_counter()
        if reg.publish(f"tenant-{s}", adapters[s]) != 0:
            raise AssertionError(f"4j: tenant-{s} published past v0")
        publish_ms[f"tenant-{s}"] = 1e3 * (time.perf_counter() - tp)

    call("reset")                                   # main path starts here
    bodies = [body(s) for s in (1, 2, 3)] + [dict(base_body, model=model_id)]
    want = [by_seed[s]["tokens"] for s in (1, 2, 3)] + [base_tokens]
    _resps, wall = _http_mix(port, bodies, "4j tenants", app=app_name)
    counts = call("counts")
    got = {tuple(p): (ids, ttft) for p, ids, ttft in counts["served"]}
    if len(counts["served"]) != len(bodies):
        raise AssertionError(f"4j: {len(counts['served'])} results for "
                             f"{len(bodies)} requests")
    for name, b, w in zip(("tenant-1", "tenant-2", "tenant-3", "base"),
                          bodies, want):
        if got[tuple(b["prompt"])][0] != w:
            raise AssertionError(f"4j {name}: replica "
                                 f"{got[tuple(b['prompt'])][0]} != 4d / "
                                 f"phase 4 {w}")
    fig["tenant_pass"] = {
        "requests": len(bodies), "wall_s": wall,
        "tokens_per_s": sum(len(ids) for ids, _ in got.values()) / wall,
        "ttft_s": {name: got[tuple(b["prompt"])][1] for name, b in
                   zip(("tenant-1", "tenant-2", "tenant-3", "base"),
                       bodies)},
        "equal_4d_and_phase4": len(bodies)}
    first_use = {r["adapter"]: r for r in call("lora_info")["resolves"]}
    if sorted(first_use) != ["tenant-1", "tenant-2", "tenant-3"] or \
            not all(r["loaded"] and r["version"] == 0
                    for r in first_use.values()):
        raise AssertionError(f"4j first use: {first_use}")
    prev = counts

    # hot swap: seed 3's adapter as v1 of tenant-1, no redeploy
    t_pub = time.time()
    tp = time.perf_counter()
    if reg.publish("tenant-1", adapters[3]) != 1:
        raise AssertionError("4j: the swap did not publish v1")
    publish_ms["tenant-1 v1"] = 1e3 * (time.perf_counter() - tp)
    time.sleep(lora_info["refresh_s"] + 0.1)
    swap = body(3, name="tenant-1")
    _resps, swap_wall = _http_mix(port, [swap], "4j swap", app=app_name)
    counts = call("counts")
    served = counts["served"][len(prev["served"]):]
    if [ids for _p, ids, _t in served] != [by_seed[3]["tokens"]]:
        raise AssertionError(f"4j swap: {served} != 4d's tenant-3 tokens "
                             f"{by_seed[3]['tokens']}")
    if counts["pid"] != info["pid"]:
        raise AssertionError("4j: the replica changed across the swap")
    lora_info = call("lora_info")
    swapped = [r for r in lora_info["resolves"]
               if r["adapter"] == "tenant-1" and r["version"] == 1]
    if not swapped or not swapped[0]["loaded"]:
        raise AssertionError(f"4j swap resolves: {lora_info['resolves']}")
    fig["swap"] = {"wall_s": swap_wall, "ttft_s": served[0][2],
                   "refresh_lag_s": swapped[0]["at"] - t_pub,
                   "refresh_s": lora_info["refresh_s"]}
    fig["publish_ms"] = publish_ms
    fig["resolve_to_slot_loaded_ms"] = {
        **{aid: r["ms"] for aid, r in first_use.items()},
        "tenant-1 v1": swapped[0]["ms"]}
    fig["manager_stats"] = lora_info["stats"]

    # an adapter never published: a typed error, neither a hang nor a 500
    try:
        _http_post(port, f"{app_name}/v1/completions",
                   body(1, name="never-published"), timeout=120)
        raise AssertionError("4j: an unknown adapter was served")
    except urllib.error.HTTPError as e:
        detail = json.loads(e.read())
        if e.code != 400 or detail.get("error") != "invalid_request" or \
                "never-published" not in detail.get("detail", ""):
            raise AssertionError(f"4j unknown adapter: {e.code} {detail}")
        fig["unknown_adapter"] = {"status": e.code, **detail}
    counts = call("counts")                         # main path ends here
    fig["launches"] = counts["launches"]
    fig["launches_by_family"] = counts["launches_by_family"]
    if cuda and (min(counts["launches_by_family"].values()) <= 0 or
                 counts["launches"] != sum(
                     counts["launches_by_family"].values())):
        raise AssertionError(f"4j: B1 launches {counts['launches']} by "
                             f"family {counts['launches_by_family']}")

    # teardown: the app deleted, its workers gone and the lease back, the
    # registry payloads inside the keep window still in the head's store
    pids = [rt.get(a._exec(lambda _i: os.getpid()), timeout=60)
            for a in [replica, *routers]]
    del replica, routers, ctrl
    serve.delete(app_name)
    _await_gone(rt, pids, 1.0, "4j app deleted")
    fig["gpu_available_after_delete"] = rt.available_resources().get("GPU")
    kept = [(f"tenant-{s}", 0) for s in (1, 2, 3)] + [("tenant-1", 1)]
    oids = [slot_oid(_adapter_base(ns, aid), v) for aid, v in kept]
    if not all(head_store.contains(o) for o in oids):
        raise AssertionError("4j: a registry payload inside the keep "
                             "window is gone")
    fig["registry_payloads"] = [f"{aid} v{v}" for aid, v in kept]
    fig["phase_s"] = time.perf_counter() - t_phase
    return fig, oids


# -- phase 4i: prefill/decode disaggregation under Serve ----------------------

def _recording_pd():
    """The replica classes of phase 4i: PrefillReplica and DecodeReplica
    plus reset() and counts(). Each times its own warmup (the families
    its base class warms), counts the ragged kernel's launches by family
    in its own process (around the engine's prefill and decode steps, as
    phase 4h does) and records, per prompt, when and what crossed: the
    prefill side the call's start, the export's end (wall clock: both
    replicas run on this machine) and the payload's bytes; the decode
    side the import's end, the token ids served and the wait_cid
    results. Defined in a function body, so the deployments pickle the
    classes by value."""
    from ray_tpu_torch.llm import pd_disagg as pd
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention as rpa

    def counted_steps(self):
        self._rpa = rpa
        self._fam = {"prefill": 0, "decode": 0}
        eng = self.engine
        for name in self._fam:
            step = getattr(eng, f"_{name}_step")

            def counted(step=step, name=name):
                before = rpa.launches
                step()
                self._fam[name] += rpa.launches - before
            setattr(eng, f"_{name}_step", counted)

    def warm(self, families):
        with pd._device_scope(self.device):
            t0 = time.perf_counter()
            self.engine.warmup(families=families)
            self.warmup_s = time.perf_counter() - t0

    def info(self):
        graphs = self.engine._graphs
        return {"launches": self._rpa.launches,
                "launches_by_family": dict(self._fam),
                "programs": len(graphs) if graphs is not None else 0,
                "server_s": self.server_s, "warmup_s": self.warmup_s,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self.device), "pid": os.getpid(),
                "banned": _banned_modules()}

    class RecordingPrefill(pd.PrefillReplica):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **{**kwargs, "warmup": False})
            warm(self, ("prefill",))
            self.server_s = time.perf_counter() - t0
            counted_steps(self)
            self._exports = []

        def _export(self, prompt, params):
            t0 = time.time()
            payload = super()._export(prompt, params)
            nbytes = sum(a.nbytes for layer in payload["pages"]
                         for a in layer.values())
            self._exports.append((list(payload["prompt_ids"]), t0,
                                  time.time(), nbytes))
            return payload

        def reset(self):                  # a step of the main path starts
            self._rpa.launches = 0
            self._fam = {k: 0 for k in self._fam}
            self._exports = []

        def counts(self):                 # and ends here
            return {**info(self), "exports": list(self._exports)}

    class RecordingDecode(pd.DecodeReplica):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **{**kwargs, "warmup": False})
            warm(self, ("decode", "verify"))
            self.server_s = time.perf_counter() - t0
            counted_steps(self)
            self._imports, self._served, self._waited = [], [], 0
            self._dispatches0 = 0
            result = self.engine._result

            def recording(req):
                out = result(req)
                self._served.append((list(req.prompt_ids),
                                     [int(t) for t in out["token_ids"]]))
                return out
            self.engine._result = recording

        def start(self, payload, params=None):
            t0 = time.time()
            rid = super().start(payload, params)
            t1 = time.time()                 # the step lock's wait inside
            self._imports.append((list(self._reqs[rid].prompt_ids), t1,
                                  t1 - t0))
            return rid

        def wait_cid(self, cid, timeout=600.0):
            out = super().wait_cid(cid, timeout)
            self._waited += 1
            return out

        def reset(self):
            self._rpa.launches = 0
            self._fam = {k: 0 for k in self._fam}
            self._imports, self._served, self._waited = [], [], 0
            self._dispatches0 = self.engine.stats["decode_dispatches"]

        def counts(self):
            return {**info(self), "imports": list(self._imports),
                    "served": list(self._served),
                    "wait_cid_results": self._waited,
                    "decode_dispatches": self.engine.stats[
                        "decode_dispatches"] - self._dispatches0}

    return RecordingPrefill, RecordingDecode


def _pd_counters() -> dict:
    """The rtpu_llm_pd_chan_* counters merged in the head's store."""
    from ray_tpu_torch.util import metrics as um
    store = um.collect_store()
    return {name: sum(((store.get(f"rtpu_llm_pd_chan_{name}_total") or {})
                       .get("series") or {}).values())
            for name in ("kv_writes", "kv_imports", "results",
                         "credit_stalls")}


def serve_pd(model_cfg, greedy: dict, device="cuda", **engine_kw) -> dict:
    """Phase 4i (also rehearsed on the CPU at tiny size, on fake GPUs):
    prefill/decode disaggregation under Serve. A head with one GPU and a
    second node of one GPU sharing its store (cluster_utils.Cluster
    .add_node): both map to index 0 of the one card, so the prefill and
    the decode replica share it. build_pd_openai_app's app (the OpenAI
    router over PDServer over a prefill and a decode group, each replica
    asking for one whole GPU; phase 4's engine settings and seed-0
    weights made in each replica, each warmed for its families), its
    replica classes the recording subclasses, use_channels=True, under
    serve.run(app, name="llm", http_port=<free>, num_proxies=1). Once the
    controller has paired the roles, phase 4's seed-0 mix goes twice as
    concurrent unary HTTP completions (the KV ring), then its first
    greedy request once with stream=true (prefill_ref, then
    decode_stream). ``greedy`` maps phase 4's greedy prompts to the
    captured run's tokens. Returns the figures; raises on any failure."""
    import socket

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.llm import PagedEngineConfig
    from ray_tpu_torch.llm.pd_disagg import build_pd_openai_app
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    cuda = torch.device(device).type == "cuda"
    model_id = "llama3-8b"
    fig = {"card": _card() if cuda else "cpu",
           "replicas_share_one_card": True}
    bodies = [dict(b, model=model_id)
              for b in _phase4_bodies(model_cfg.vocab_size)]
    first = next((b for b in bodies if not b["temperature"]), None)
    if first is None or not greedy:
        raise AssertionError("4i: phase 4 gave no greedy result")
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    try:
        Cluster().add_node(num_cpus=2, num_gpus=1, name="pd-second")
        if rt.cluster_resources().get("GPU") != 2.0:
            raise AssertionError(f"4i cluster {rt.cluster_resources()}")
        fig["init_s"] = time.perf_counter() - t0
        head_store = rt_mod.get_runtime_if_exists().store
        objects_before = head_store.num_objects()
        counters_before = _pd_counters()
        app = build_pd_openai_app(
            model_id, n_prefill=1, n_decode=1,
            engine_cfg=PagedEngineConfig(model=model_cfg, **engine_kw),
            use_channels=True, device=device, gpus_per_replica=1)
        (pd_dep,) = app.ingress.children()
        pre_dep, dec_dep = pd_dep.children()
        for dep, cls in zip((pre_dep, dec_dep), _recording_pd()):
            if dep.spec.ray_actor_options != {"num_gpus": 1}:
                raise AssertionError(f"4i {dep.spec.role} options "
                                     f"{dep.spec.ray_actor_options}")
            dep.spec = dataclasses.replace(dep.spec, func_or_class=cls)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t1 = time.perf_counter()
        serve.run(app, name="llm", http_port=port, num_proxies=1)
        fig["deploy_s"] = time.perf_counter() - t1
        ctrl = rt.get_actor(CONTROLLER_NAME)
        reps = {}
        for role in ("prefill", "decode"):
            _v, (reps[role],) = rt.get(ctrl.get_replicas.remote(
                "llm", f"pd-{role}:{model_id}"), timeout=60)

        def call(role, method, *args):
            return rt.get(reps[role].handle_request.remote(
                method, args, {}, None), timeout=900)

        # 1. ready once both replicas pass check_health and the
        # controller has paired the prefill replica with a decode ring
        for role in reps:
            if not rt.get(reps[role].health_check.remote(), timeout=900):
                raise AssertionError(f"4i {role} health check failed")
        # (through the replica actor: a DeploymentHandle here would leave
        # its long-poll thread calling the controller after shutdown)
        deadline = time.monotonic() + 120
        while not call("prefill", "has_kv_channel"):
            if time.monotonic() > deadline:
                raise AssertionError("4i: the controller never paired "
                                     "the prefill and decode roles")
            time.sleep(0.2)
        fig["ready_s"] = time.perf_counter() - t1
        info = {role: call(role, "counts") for role in reps}
        for role, i in info.items():
            fig[f"{role}_replica"] = {
                k: i[k] for k in ("server_s", "warmup_s", "programs",
                                  "visible", "device")}
            if i["visible"] != "0" or i["banned"] or \
                    (cuda and i["device"] != "cuda:0"):
                raise AssertionError(f"4i {role} replica: {i}")
        if info["prefill"]["pid"] == info["decode"]["pid"]:
            raise AssertionError("4i: both roles in one process")
        time.sleep(0.5)
        gpu_held = rt.available_resources().get("GPU")
        if gpu_held != 0.0:
            raise AssertionError(f"GPU available {gpu_held} while both "
                                 f"replicas hold a lease")
        fig["gpu_available_while_held"] = gpu_held

        def step(label, run):
            """One step of the main path between both replicas' reset()
            and counts(): B1's prefill family only in the prefill
            replica, its decode family only in the decode replica."""
            for role in reps:
                call(role, "reset")
            t = time.perf_counter()
            out = run()
            wall = time.perf_counter() - t
            got = {role: call(role, "counts") for role in reps}
            pre_f = got["prefill"]["launches_by_family"]
            dec_f = got["decode"]["launches_by_family"]
            for role, c in got.items():
                if cuda and c["launches"] != sum(
                        c["launches_by_family"].values()):
                    raise AssertionError(f"4i {label} {role}: launches "
                                         f"outside the counted steps {c}")
            if cuda and not (pre_f["prefill"] > 0 and pre_f["decode"] == 0
                             and dec_f["decode"] > 0
                             and dec_f["prefill"] == 0):
                raise AssertionError(f"4i {label}: B1 by family, prefill "
                                     f"replica {pre_f}, decode replica "
                                     f"{dec_f}")
            return out, wall, got

        def handoff(got, label):
            """Per request: export end to import end (ms), call start to
            import end (s: the first token on the decode side), payload
            MiB."""
            exports = {tuple(p): (ta, tb, n)
                       for p, ta, tb, n in got["prefill"]["exports"]}
            imports = {tuple(p): t for p, t, _w in got["decode"]["imports"]}
            starts = [w for _p, _t, w in got["decode"]["imports"]]
            if set(exports) != set(imports):
                raise AssertionError(f"4i {label}: exports and imports "
                                     f"differ")
            ms = [1e3 * (imports[p] - exports[p][1]) for p in exports]
            ttft = [imports[p] - exports[p][0] for p in exports]
            mib = [exports[p][2] / 2 ** 20 for p in exports]
            return {"export_to_import_ms_median": statistics.median(ms),
                    "export_to_import_ms_max": max(ms),
                    "ttft_median_s": statistics.median(ttft),
                    "ttft_max_s": max(ttft),
                    "payload_mib_mean": statistics.mean(mib),
                    "payload_mib_max": max(mib),
                    # one import call (DecodeReplica.start): mostly the
                    # wait for the decode loop's step lock
                    "import_call_ms_median": 1e3 * statistics.median(starts),
                    "import_call_ms_max": 1e3 * max(starts),
                    "decode_dispatches": got["decode"]["decode_dispatches"]}

        # 2-3. the mix over HTTP, twice (the KV ring)
        passes = []
        for i in range(2):
            (resps, wall), _w, got = step(
                f"pass {i + 1}", lambda: _http_mix(port, bodies, "4i"))
            served = got["decode"]["served"]
            if got["decode"]["wait_cid_results"] != len(bodies):
                raise AssertionError(f"4i pass {i + 1}: "
                                     f"{got['decode']['wait_cid_results']}"
                                     f" ring results for {len(bodies)}")
            checked = _greedy_checked([(p, ids, 0.0) for p, ids in served],
                                      bodies, greedy, f"4i pass {i + 1}")
            n_out = sum(len(ids) for ids, _t in checked.values())
            passes.append({
                "generate_s": wall, "tokens_out": n_out,
                "tokens_per_s": n_out / wall,
                **handoff(got, f"pass {i + 1}"),
                "greedy_equal_phase4": len(greedy),
                "launches_prefill_replica":
                    got["prefill"]["launches_by_family"],
                "launches_decode_replica":
                    got["decode"]["launches_by_family"],
                "programs_after": {r: got[r]["programs"] for r in got}})
        fig["first_pass"], fig["second_pass"] = passes
        n_unary = 2 * len(bodies)

        # 4. the first greedy request once as an SSE stream (the ref path)
        (code, ctype, raw), _w, got = step(
            "stream", lambda: _http_post(port, "llm/v1/completions",
                                         dict(first, stream=True)))
        lines = [ln for ln in raw.decode().split("\n\n") if ln]
        if code != 200 or not ctype.startswith("text/event-stream") or \
                lines[-1] != "data: [DONE]" or \
                not all(ln.startswith("data: ") for ln in lines):
            raise AssertionError(f"4i stream: {code} {ctype} {lines[-3:]}")
        chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
        text = "".join(c["choices"][0]["text"] for c in chunks)
        want_text = resps[bodies.index(first)]["choices"][0]["text"]
        if text != want_text:
            raise AssertionError(f"4i stream text {text!r} != "
                                 f"{want_text!r}")
        if [ids for _p, ids in got["decode"]["served"]] != \
                [greedy[tuple(first["prompt"])]] or \
                got["decode"]["wait_cid_results"] != 0:
            raise AssertionError(f"4i stream tokens {got['decode']}")
        fig["stream"] = {"chunks": len(chunks), **handoff(got, "stream"),
                         "launches_prefill_replica":
                             got["prefill"]["launches_by_family"],
                         "launches_decode_replica":
                             got["decode"]["launches_by_family"]}
        fig["launches_prefill_by_family"] = {
            k: sum(s[k] for s in [p["launches_prefill_replica"]
                                  for p in passes]
                   + [fig["stream"]["launches_prefill_replica"]])
            for k in ("prefill", "decode")}
        fig["launches_decode_by_family"] = {
            k: sum(s[k] for s in [p["launches_decode_replica"]
                                  for p in passes]
                   + [fig["stream"]["launches_decode_replica"]])
            for k in ("prefill", "decode")}

        # the ring's counters, from both replicas' registries (flushed to
        # the head every ~2 s): one write and one import per unary request
        deadline = time.monotonic() + 30
        while True:
            chan = {k: v - counters_before[k]
                    for k, v in _pd_counters().items()}
            if chan["kv_writes"] >= n_unary and \
                    chan["kv_imports"] >= n_unary:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"4i ring counters {chan}")
            time.sleep(0.5)
        if chan["kv_writes"] != n_unary or chan["kv_imports"] != n_unary:
            raise AssertionError(f"4i ring counters {chan} for {n_unary} "
                                 f"unary requests")
        fig["ring"] = {**chan, "wait_cid_results": n_unary,
                       "unary_requests": n_unary}

        # teardown: both leases back, no PD worker left, the store at its
        # count before the deploy
        proxies = [p["actor"] for p in rt.get(ctrl.get_proxies.remote(),
                                              timeout=60)]
        actors = []
        for dep in ("openai-router", f"pd:{model_id}"):
            _v, a = rt.get(ctrl.get_replicas.remote("llm", dep), timeout=60)
            actors += a
        pids = [rt.get(a._exec(lambda _i: os.getpid()), timeout=60)
                for a in [ctrl, *reps.values(), *actors, *proxies]]
        if len(set(pids)) != 6:
            raise AssertionError(f"4i Serve workers {pids}")
        del actors, proxies, reps, ctrl
        t2 = time.perf_counter()
        serve.shutdown()
        fig["shutdown_s"] = time.perf_counter() - t2
        _await_gone(rt, pids, 2.0, "4i after shutdown")
        fig["gpu_available_after_shutdown"] = \
            rt.available_resources().get("GPU")
        gc.collect()
        after = _settled(head_store.num_objects, objects_before, 30.0)
        if after > objects_before:
            raise AssertionError(f"4i: {after} objects in the store after "
                                 f"shutdown, {objects_before} before")
        fig["store_objects"] = [objects_before, after]
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _port_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    if _port_procs():
        raise AssertionError(f"4i port workers left: {_port_procs()}")
    return fig


# -- phase 4b: the dense-slot engine at full width --------------------------

def dense_serve(model_cfg, device, seed: int = 0, **engine_kw) -> dict:
    """Phase 4b (also rehearsed on the CPU at tiny size): LLMPredictor
    (its InferenceEngine builds random weights from ``seed``) answers one
    batch of 8 prompts, then its engine generates phase 4's requests.
    Returns the launches per kernel over both and the serving figures."""
    from ray_tpu_torch.llm import EngineConfig, LLMPredictor
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    held_gib = torch.cuda.memory_allocated() / 2 ** 30 if cuda else None
    t0 = time.perf_counter()
    pred = LLMPredictor(EngineConfig(model_cfg, **engine_kw), device=device)
    sync()
    setup_s = time.perf_counter() - t0
    rows = {"prompt": [f"request {i}: " + "the quick brown fox " * (3 * i)
                       for i in range(8)], "id": list(range(8))}
    prompts, sps = _requests(model_cfg.vocab_size, seed)
    step_s = []                            # host clock per decode step
    decode = pred.engine._decode
    prefill = pred.engine._prefill
    buckets = {}                           # prefill S -> dispatches

    def counted_prefill(tokens, slot, true_len):
        buckets[tokens.shape[1]] = buckets.get(tokens.shape[1], 0) + 1
        return prefill(tokens, slot, true_len)
    pred.engine._prefill = counted_prefill

    def timed_decode(tokens, active):
        t = time.perf_counter()
        logits = decode(tokens, active)
        sync()
        step_s.append(time.perf_counter() - t)
        return logits
    pred.engine._decode = timed_decode
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()                 # main path starts here
    t1 = time.perf_counter()
    got = pred(rows)
    sync()
    batch_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    out = pred.engine.generate(prompts, sps)
    sync()
    gen_s = time.perf_counter() - t2
    launches = _launch_counts()            # main path ends here
    stats = dict(pred.engine.stats)
    vocab = model_cfg.vocab_size
    if got["id"] != rows["id"] or len(got["generated_ids"]) != 8 or \
            got["num_generated_tokens"] != [len(t) for t in
                                            got["generated_ids"]]:
        raise AssertionError(f"bad predictor columns: {sorted(got)}")
    for toks, sp in [(t, pred.sampling) for t in got["generated_ids"]] + \
            [(r["token_ids"], sp) for r, sp in zip(out, sps)]:
        if not toks or len(toks) > sp.max_tokens + 1 or \
                not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"bad tokens: {toks}")
    if cuda:
        want = {"flash_fwd": model_cfg.n_layers * stats["prefill_dispatches"],
                "flash_dq": 0, "flash_dkv": 0, "ragged_paged_attention": 0,
                "paged_decode_attention": 0}
        if launches != want or not stats["prefill_dispatches"]:
            raise AssertionError(f"dense serve launches {launches}, want "
                                 f"{want}")
    n_out = sum(len(r["token_ids"]) for r in out)
    ttft = sorted(r["ttft_s"] for r in out)
    return {"launches": launches, "held_before_gib": held_gib,
            "setup_s": setup_s, "predictor_batch_s": batch_s,
            "predictor_tokens": sum(got["num_generated_tokens"]),
            "generate_s": gen_s, "tokens_out": n_out,
            "tokens_per_s": n_out / gen_s,
            "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
            "prompt_tokens": sum(len(p) for p in prompts),
            "decode_step_ms_first": step_s[0] * 1e3,
            "decode_step_ms_median": statistics.median(step_s) * 1e3,
            "dispatches": stats, "prefill_buckets": buckets,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None)}


# -- phase 4c: LLMServer in process at full width -----------------------------

def _matmul_flops(mc, kind: str, key: tuple, batch: int, chunk: int) -> int:
    """2 x (matmul weights) x tokens of one dispatch at a profiler key,
    plus the lm_head over the rows that reach it: the FLOPs a counter
    sees when attention is a kernel it cannot see. An MoE layer over T
    tokens in one call counts its router, the dispatch and combine
    products and the three expert products over all E x C slots
    (C = max(1, int(capacity * k * T / E))), empty slots included."""
    d, F = mc.dim, mc.mlp_dim
    attn = 2 * (d * mc.n_heads * mc.head_dim
                + 2 * d * mc.n_kv_heads * mc.head_dim
                + mc.n_heads * mc.head_dim * d)
    head = 2 * d * mc.vocab_size

    def layers(t):                     # every layer, t tokens in one call
        if not mc.moe_experts:
            return mc.n_layers * t * (attn + 2 * 3 * d * F)
        e = mc.moe_experts
        slots = e * max(1, int(mc.moe_capacity * mc.moe_top_k * t / e))
        return mc.n_layers * (t * attn + 2 * t * d * e
                              + 2 * 2 * t * slots * d
                              + 3 * 2 * slots * d * F)
    if kind == "decode":
        w = key[0]
        return w * (layers(batch) + batch * head)
    if kind == "prefill":
        rows = key[0]
        return rows * (layers(chunk) + head)
    rows, s1 = key[0], key[1]                          # verify
    return rows * (layers(s1) + s1 * head)


def _check_flops(eng, model_cfg, cuda: bool) -> dict:
    """estimate_flops() against the analytic matmul count, key by key;
    then profile_summary()."""
    for kind, keys in eng.estimate_flops().items():
        for key, fl in keys.items():
            want = _matmul_flops(model_cfg, kind, key, eng.cfg.max_batch_size,
                                 eng.cfg.chunk_size)
            # on the card attention is invisible to the counter: the
            # matmuls alone; on the CPU the plain attention adds to them
            if fl < 0.99 * want or (cuda and fl > 1.01 * want):
                raise AssertionError(f"{kind} {key}: counted {fl:.4g} "
                                     f"FLOPs, matmuls {want:.4g}")
    return eng.profile_summary()


def _hist(store: dict, name: str) -> dict:
    """histogram_stats of one rtpu_llm_* histogram plus max_le, the
    smallest bucket edge at or above every observation (the histogram's
    own bound on the maximum; None past its last finite edge)."""
    from ray_tpu_torch.util.metrics import histogram_stats
    rec = store.get(name)
    st = histogram_stats(rec)
    if st is None:
        return {"count": 0}
    edges = {}
    for key, val in rec["series"].items():
        le = dict(key).get("le")
        if le is not None:
            edges[le] = edges.get(le, 0.0) + val
    finite = sorted((float(le), c) for le, c in edges.items()
                    if le != "+Inf")
    st["max_le"] = next((b for b, c in finite if c >= st["count"]), None)
    return st


def llm_server(model_cfg, device, seed: int = 0, **engine_kw) -> dict:
    """Phase 4c (also rehearsed on the CPU at tiny size): the OpenAI app
    (``build_openai_app``: the router over one LLMServer on the paged
    engine, seeded weights) under ``serve.run(..., local_testing_mode=
    True)``. After a first burst of phase 4's requests from mix seed 1,
    the ingress handle's ``v1_completions`` answers phase 4's requests
    from mix seed 2 sent by 11 threads at once, beside one
    ``v1_chat_completions`` request; then the first (greedy) prompt once
    more through ``v1_completions`` with ``stream=True`` (SSE lines).
    Checks each response's shape, the stream against the greedy
    request's tokens in the burst (B1's split boundaries do not depend
    on the batch), the chat answer against ``v1_completions`` on its
    templated prompt, ``v1_models``, the rtpu_llm_* series against the
    engine's counters, the launches and the engine thread's health; then
    estimate_flops and profile_summary (MFU without attention: the
    counter cannot see the ragged kernel). On the card the engine
    dispatches captured programs: warmup captures the greedy, sampled
    and top-k modes, and the engine thread captures any other key at its
    first dispatch while the request threads wait. Stops the engine
    thread of the replica it reaches through the app."""
    import threading
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   apply_chat_template, build_openai_app)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention as rpa
    from ray_tpu_torch.util import metrics
    cuda = torch.device(device).type == "cuda"
    model_id = "llama3-8b"
    t0 = time.perf_counter()
    params = llama.init(model_cfg, seed=seed, device=device)
    cfg = LLMConfig(model_id=model_id, warmup_sampled=True,
                    engine=PagedEngineConfig(model=model_cfg, **engine_kw))
    router = serve.run(build_openai_app([cfg], params_refs=[params],
                                        device=device),
                       name="phase-4c", local_testing_mode=True)
    srv = router._instance._handles[model_id]._instance   # the replica
    setup_s = time.perf_counter() - t0
    eng = srv.engine
    served = []                       # (prompt ids, out ids) per response
    result = eng._result

    def recording_result(req):
        served.append((list(req.prompt_ids), list(req.out_ids)))
        return result(req)
    eng._result = recording_result
    stepping = [False]
    step = eng.step

    def flagged_step():
        stepping[0] = True
        try:
            step()
        finally:
            stepping[0] = False
    eng.step = flagged_step

    def quiesce():
        """Wait until the engine thread has no work and is not inside a
        step: the last step's telemetry (shipped at its end) is in."""
        while eng.has_work() or stepping[0]:
            time.sleep(0.001)

    def bodies_of(mix_seed):
        ps, ss = _requests(model_cfg.vocab_size, seed=mix_seed)
        return ps, ss, [{"model": model_id, "prompt": p,
                         "max_tokens": sp.max_tokens,
                         "temperature": sp.temperature, "top_k": sp.top_k,
                         "logprobs": sp.logprobs} for p, sp in zip(ps, ss)]

    chat = {"model": model_id, "max_tokens": 16, "messages": [
        {"role": "system", "content": "answer in one line"},
        {"role": "user", "content": "what does a paged KV cache hold?"}]}

    def burst(calls):
        """Each (route, body) from its own thread, all at once, through
        the ingress handle."""
        out, errors = [None] * len(calls), []

        def call(i):
            route, body = calls[i]
            try:
                out[i] = getattr(router, route).remote(dict(body)).result(
                    timeout_s=600)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(calls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out

    prompts, sps, bodies = bodies_of(2)
    try:
        models = router.v1_models.remote().result(timeout_s=60)
        # a first burst (mix seed 1) makes the engine thread capture the
        # keys warmup left out (logprob modes), as a server's first
        # traffic would; the phase's burst then replays only
        burst([("v1_completions", b) for b in bodies_of(1)[2]])
        quiesce()
        warm_programs = len(eng._graphs) if eng._graphs is not None else 0
        served.clear()
        tokens0 = eng.stats["tokens_out"]
        metrics._reset_registry()
        rpa.launches = 0                   # main path starts here
        t1 = time.perf_counter()
        resps = burst([("v1_completions", b) for b in bodies]
                      + [("v1_chat_completions", chat)])
        resps, chat_resp = resps[:-1], resps[-1]
        greedy_body = {"model": model_id, "prompt": prompts[0],
                       "max_tokens": sps[0].max_tokens, "stream": True}
        lines = list(router.options(method_name="v1_completions",
                                    stream=True).remote(greedy_body))
        wall_s = time.perf_counter() - t1
        launches = rpa.launches            # main path ends here
        quiesce()
        store = metrics.collect_store()
        tokens_out = eng.stats["tokens_out"] - tokens0
        n_out = sum(len(out) for _, out in served)
        # the chat answer against v1_completions on its templated prompt
        templated = router.v1_completions.remote({
            "model": model_id, "prompt": apply_chat_template(
                chat["messages"]),
            "max_tokens": chat["max_tokens"]}).result(timeout_s=600)
        srv.check_health()
        if srv._error is not None:
            raise AssertionError(f"engine thread error: {srv._error!r}")
    finally:
        srv._stop = True
        srv._wake.set()
        srv._thread.join(timeout=120)
        serve.delete("phase-4c")
    if srv._thread.is_alive():
        raise AssertionError("engine thread did not stop")
    if models != {"object": "list", "data": [
            {"id": model_id, "object": "model", "owned_by": "ray_tpu"}]}:
        raise AssertionError(f"bad v1_models: {models}")
    vocab = model_cfg.vocab_size
    for body, r in zip(bodies, resps):
        ch = r["choices"][0]
        usage = r["usage"]
        if r["object"] != "text_completion" or r["model"] != model_id \
                or not r["id"].startswith("cmpl-") \
                or set(ch) - {"text", "finish_reason", "index", "logprobs"} \
                or usage["prompt_tokens"] != len(body["prompt"]) \
                or not 1 <= usage["completion_tokens"] <= body["max_tokens"] \
                or ch["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"bad response: {r}")
        if body["logprobs"]:
            lp = np.asarray(ch["logprobs"]["token_logprobs"], np.float64)
            if len(lp) != usage["completion_tokens"] or \
                    not np.isfinite(lp).all() or (lp > 1e-4).any():
                raise AssertionError(f"bad logprobs: {lp}")
        elif "logprobs" in ch:
            raise AssertionError(f"unasked logprobs: {r}")
    ch = chat_resp["choices"][0]
    if chat_resp["object"] != "chat.completion" or \
            not chat_resp["id"].startswith("chatcmpl-") or \
            ch["message"]["role"] != "assistant" or \
            ch["message"]["content"] != templated["choices"][0]["text"] or \
            ch["finish_reason"] != templated["choices"][0]["finish_reason"] \
            or chat_resp["usage"] != templated["usage"]:
        raise AssertionError(f"chat {chat_resp} != completions on its "
                             f"templated prompt {templated}")
    # the burst's greedy request (served first of the two) and the stream
    if lines[-1] != "data: [DONE]\n\n":
        raise AssertionError(f"stream ends in {lines[-1]!r}")
    chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    greedy = [out for p, out in served if p == prompts[0]]
    first = resps[0]["choices"][0]
    text = "".join(c["choices"][0]["text"] for c in chunks)
    if len(greedy) != 2 or greedy[0] != greedy[1] or \
            text != first["text"] or \
            chunks[-1]["choices"][0]["finish_reason"] != \
            first["finish_reason"]:
        raise AssertionError(f"stream differs from the burst's greedy "
                             f"request: {greedy}")
    if not all(0 <= t < vocab for _, out in served for t in out):
        raise AssertionError("token out of the vocabulary")
    requests = sum(store["rtpu_llm_requests_total"]["series"].values())
    generated = sum(store["rtpu_llm_tokens_generated_total"]["series"]
                    .values())
    ttft = _hist(store, "rtpu_llm_ttft_seconds")
    n_req = len(bodies) + 2
    if requests != n_req or generated != tokens_out or \
            ttft["count"] != n_req:
        raise AssertionError(f"telemetry: {requests} requests, {generated} "
                             f"tokens (engine {tokens_out}), "
                             f"{ttft['count']} TTFT observations, want "
                             f"{n_req} requests")
    if cuda and launches <= 0:
        raise AssertionError("the ragged kernel never launched")
    prof = _check_flops(eng, model_cfg, cuda)
    graphs = eng._graphs
    return {"setup_s": setup_s, "wall_s": wall_s, "tokens_out": n_out,
            "requests": n_req,
            "programs_after_first_burst": warm_programs,
            "programs": len(graphs) if graphs is not None else 0,
            "capture_s_mean": (statistics.mean(graphs.capture_s)
                               if graphs is not None and graphs.capture_s
                               else None),
            "tokens_per_s": n_out / wall_s, "launches": launches,
            "ttft_s": ttft,
            "inter_token_s": _hist(store, "rtpu_llm_inter_token_seconds"),
            "queue_wait_s": _hist(store, "rtpu_llm_queue_wait_seconds"),
            "dispatches": {k: eng.stats[k] for k in
                           ("prefill_dispatches", "decode_dispatches",
                            "spec_dispatches")},
            "prefix_hits": eng.stats["prefix_hits"],
            "profile": {k: prof[k] for k in (
                "compiles", "steps", "steps_by_kind", "step_wall_s",
                "flops_per_step", "mfu")},
            "mfu_counts": "matmuls only: the FLOP counter cannot see the "
                          "ragged attention kernel" if cuda else
                          "matmuls and the plain attention"}


# -- phase 4d: tenants and KV mobility at full width -------------------------

#: LoRA rank and targets of phase 4d's adapters (the slot table's)
TENANT_RANK = 8
TENANT_TARGETS = ("wq", "wk", "wv", "wo", "lm_head")


def _tenant_waves(vocab: int, seed: int):
    """Phase 4d's traffic: three waves of (prompt, SamplingParams, slot,
    salt). Wave 1 mixes base and 3 tenants (slots 1-3), greedy and
    sampled, two requests of tenant 1 sharing a 256-token prefix and
    tenants 2 and 3 sharing another across tenants (no hits: the salts
    differ); wave 2 is 12 base prompts of 360 tokens, more pages than the
    pool holds, so every page of wave 1 is evicted (demoted to the
    tier); wave 3 is wave 1 again (promoted from the tier)."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.multilora import prefix_salt
    rng = np.random.RandomState(seed)
    ids = lambda n: [int(t) for t in rng.randint(0, vocab, n)]  # noqa: E731
    salt = {s: prefix_salt(f"tenant-{s}", 0) for s in (1, 2, 3)}
    salt[0] = b""
    own, cross = ids(256), ids(256)
    greedy = SamplingParams(max_tokens=16)
    greedy_lp = SamplingParams(max_tokens=16, logprobs=1)
    sampled = SamplingParams(max_tokens=16, temperature=0.8)
    topk = SamplingParams(max_tokens=16, temperature=1.0, top_k=50)
    rows = [(ids(300), greedy, 0), (ids(200), sampled, 0),
            (own + ids(60), greedy, 1), (own + ids(90), sampled, 1),
            (cross + ids(50), greedy_lp, 2), (ids(150), topk, 2),
            (cross + ids(70), greedy, 3), (ids(120), sampled, 3),
            (own + ids(40), greedy_lp, 0)]
    wave1 = [(p, sp, s, salt[s]) for p, sp, s in rows]
    wave2 = [(ids(360), SamplingParams(max_tokens=4), 0, b"")
             for _ in range(12)]
    return [wave1, wave2, list(wave1)]


def _submit_wave(eng, wave, as_base: bool = False):
    """Submit a wave and run it to the end; ``as_base`` sends every
    request as a base request (slot 0) with its salt kept, so a plain
    engine schedules the wave exactly as the LoRA engine does."""
    reqs = [eng.submit(p, sp, adapter_slot=0 if as_base else slot,
                       prefix_salt=salt) for p, sp, slot, salt in wave]
    eng.run_until_done(reqs)
    return [(list(r.out_ids), list(r.out_logps)) for r in reqs]


def _gen(eng, prompt, sp, slot=0, salt=b""):
    req = eng.submit(prompt, sp, adapter_slot=slot, prefix_salt=salt)
    eng.run_until_done([req])
    return list(req.out_ids)


def _timed(eng, name: str, sink: list, sync, stat: str):
    """Wrap ``eng.<name>`` (a demote or a promote) to append (seconds,
    pages) to sink for each call that moved pages, the pages read off
    ``eng.stats[stat]``, synchronised so the time covers the copies."""
    fn = getattr(eng, name)

    def run(*a):
        n0 = eng.stats[stat]
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        if eng.stats[stat] > n0:
            sink.append((time.perf_counter() - t0, eng.stats[stat] - n0))
        return out
    setattr(eng, name, run)


def _family_counter(eng, fam: dict, rpa):
    for name, attr in (("prefill", "_prefill_step"),
                       ("decode", "_decode_step")):
        fn = getattr(eng, attr)

        def counted(fn=fn, name=name):
            before = rpa.launches
            fn()
            fam[name] += rpa.launches - before
        setattr(eng, attr, counted)


def _tenant_run(params, cfg, adapters, device, seed, eager, waves,
                as_base=False, warm=True):
    """One engine of phase 4d over the three waves (then, for the
    LoRA engines, two verify dispatches with tenant rows). Returns the
    engine, outputs, B1 launches by family, pages exported before and
    after the eviction, and the timings."""
    from ray_tpu_torch.llm import PagedInferenceEngine
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention as rpa
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    eng = PagedInferenceEngine(cfg, params=params, rng_seed=seed,
                               device=device)
    eng._eager = eager
    for slot, ad in enumerate(adapters, start=1):
        eng.load_adapter_slot(slot, ad)
    t0 = time.perf_counter()
    if warm and not eager:
        eng.warmup(sample_modes=((False, False, False), (True, True, True)))
    sync()
    warm_s = time.perf_counter() - t0
    demotes, promotes = [], []
    if eng.spill is not None:
        _timed(eng, "_maybe_demote", demotes, sync, "spill_pages")
        _timed(eng, "_promote_for_locked", promotes, sync,
               "spill_promotions")
    fam = {"prefill": 0, "decode": 0, "verify": 0}
    _family_counter(eng, fam, rpa)
    rpa.launches = 0                       # main path starts here
    outs, secs, exported = [], [], {}
    for i, wave in enumerate(waves):
        t1 = time.perf_counter()
        outs.append(_submit_wave(eng, wave, as_base))
        sync()
        secs.append(time.perf_counter() - t1)
        if i == 0:
            # pages of each wave-1 chain before wave 2 evicts them
            for p, _sp, slot, salt in wave:
                hs = eng.hash_prompt(p, salt)
                if hs and eng.cached_prefix_len(hs) == len(hs):
                    exported[(tuple(p), salt)] = (hs, eng.export_prefix(hs))
        if i == 1:
            for hs, _ in exported.values():
                if eng.cached_prefix_len(hs) != 0:
                    raise AssertionError("wave 2 left a wave-1 page hot")
                if eng.spill is not None and \
                        eng.spill.covered_run(hs) != len(hs):
                    raise AssertionError("a wave-1 page missed the tier")
    after = {key: eng.export_prefix(hs) for key, (hs, _) in exported.items()}
    verify = None
    if not as_base and eng.lora is not None:
        # verify family with tenant rows: 4 rows of 5 tokens on pages
        # taken from the allocator and given back (cached pages keep
        # their content)
        R, S1, page = 4, 5, cfg.page_size
        rng = np.random.RandomState(seed + 1)
        toks = rng.randint(0, cfg.model.vocab_size, (R, S1)).astype(np.int32)
        starts = np.asarray([3, 40, 130, 250], np.int32)
        need = [-(-(int(s) + S1) // page) for s in starts]
        pids = eng._claim_pages([], sum(need))
        bts = np.zeros((R, cfg.max_pages_per_seq), np.int32)
        for r in range(R):
            o = sum(need[:r])
            bts[r, :need[r]] = pids[o:o + need[r]]
        lslots = np.asarray([1, 2, 3, 0], np.int32)
        before = rpa.launches
        verify = [eng._verify_rows(toks, bts, starts, True, lslots)
                  for _ in range(2)]
        sync()
        fam["verify"] = rpa.launches - before
        for pid in pids:
            eng._decref(pid)
    launches = rpa.launches                # main path ends here
    return {"engine": eng, "outs": outs, "secs": secs, "warm_s": warm_s,
            "fam": dict(fam), "launches": launches, "verify": verify,
            "exported": {k: v[1] for k, v in exported.items()},
            "after": after, "demotes": demotes, "promotes": promotes}


def _per_page_ms(calls):
    pages = sum(n for _, n in calls)
    return 1e3 * sum(s for s, _ in calls) / pages if pages else None


def _pages_equal(a: dict, b: dict) -> bool:
    return a is not None and b is not None and \
        a["page_hashes"] == b["page_hashes"] and all(
        np.array_equal(la[kv], lb[kv])
        for la, lb in zip(a["pages"], b["pages"]) for kv in ("k", "v"))


def tenants_and_kv(model_cfg, device, seed: int = 0, num_pages: int = 256,
                   spill_pages: int = 256, **engine_kw) -> dict:
    """Phase 4d (also rehearsed on the CPU at tiny size): engine A, the
    paged engine with a slot table (slot 0 base, 3 adapters of rank 8 on
    wq/wk/wv/wo/lm_head from seeds 1-3), the host spill tier and a pool
    the traffic overflows, on captured programs, over three waves
    (``_tenant_waves``) and two verify dispatches with tenant rows. Each
    check raises:
    - captured vs eager: an eager engine on the same traffic gives the
      same tokens, logprobs, verify outputs, counters, B1 launches by
      family and pages, bit for bit;
    - base rows: a plain engine (no slot table) on the same traffic sent
      as base requests gives every base request's tokens and logprobs;
    - tenants alone: each tenant's greedy request alone gives its tokens
      in the mix (the merged-weights engine's agreement is printed);
    - reload: a slot reloaded after capture serves the new adapter;
    - spill: tier-off greedy tokens equal tier-on; demotions and
      promotions > 0; every promoted page is bitwise the page exported
      before its eviction;
    - payloads: engine B (same params tensors, no slot table) imports
      A's prefill export and decodes A's greedy tokens; it imports A's
      prefix export, re-exports it bitwise and admits the prompt with
      prefix hits."""
    from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                                   SamplingParams, lora)
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention as rpa
    from ray_tpu_torch.models import llama
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = llama.init(model_cfg, seed=seed, device=device)
    adapters = [lora.random_adapter(s, model_cfg, rank=TENANT_RANK,
                                    alpha=2.0 * TENANT_RANK,
                                    targets=TENANT_TARGETS)
                for s in (1, 2, 3)]
    page_nbytes = (2 * model_cfg.n_layers * engine_kw["page_size"]
                   * model_cfg.n_kv_heads * model_cfg.head_dim
                   * torch.empty((), dtype=model_cfg.dtype).element_size())
    base_kw = dict(engine_kw, num_pages=num_pages, kv_spill=True,
                   kv_spill_max_bytes=spill_pages * page_nbytes)
    lcfg = PagedEngineConfig(model=model_cfg, max_adapters=4,
                             lora_rank=TENANT_RANK,
                             lora_targets=TENANT_TARGETS, **base_kw)
    waves = _tenant_waves(model_cfg.vocab_size, seed + 5)
    wave1 = waves[0]
    cap = _tenant_run(params, lcfg, adapters, device, seed, False, waves)
    eag = _tenant_run(params, lcfg, adapters, device, seed, True, waves)
    A, E = cap["engine"], eag["engine"]
    # captured against eager: the same kernels on the same inputs
    if cap["outs"] != eag["outs"]:
        raise AssertionError("captured and eager tokens/logprobs differ")
    for (y, lp), (y2, lp2) in zip(cap["verify"], eag["verify"]):
        if not (np.array_equal(y, y2) and np.array_equal(lp, lp2)):
            raise AssertionError("verify outputs differ")
    if A.stats != E.stats or cap["fam"] != eag["fam"]:
        raise AssertionError(f"counters or B1 launches differ: "
                             f"{A.stats} {cap['fam']} / {E.stats} "
                             f"{eag['fam']}")
    for a, b in zip(A.caches, E.caches):
        if not (torch.equal(a["k"][1:], b["k"][1:])
                and torch.equal(a["v"][1:], b["v"][1:])):
            raise AssertionError("pages differ between captured and eager")
    if cuda and (len(A._graphs) <= 0 or min(cap["fam"].values()) <= 0):
        raise AssertionError(f"captured nothing or a family never "
                             f"launched B1: {cap['fam']}")
    # spill: demoted, promoted, and promoted pages bitwise the originals
    if A.stats["spill_demotions"] <= 0 or A.stats["spill_promotions"] <= 0:
        raise AssertionError(f"spill tier idle: {A.stats}")
    for key, before in cap["exported"].items():
        if not _pages_equal(before, cap["after"][key]):
            raise AssertionError("a promoted page differs from its export")
    # tier off: the same greedy tokens (eager, LoRA engine)
    fcfg = PagedEngineConfig(model=model_cfg, max_adapters=4,
                             lora_rank=TENANT_RANK,
                             lora_targets=TENANT_TARGETS,
                             **dict(base_kw, kv_spill=False))
    off = _tenant_run(params, fcfg, adapters, device, seed, True, waves)
    for w, (a_out, f_out) in enumerate(zip(cap["outs"], off["outs"])):
        for (p, sp, _s, _salt), x, y in zip(waves[w], a_out, f_out):
            if sp.temperature <= 0 and x[0] != y[0]:
                raise AssertionError("tier off changed greedy tokens")
    del off
    # base rows: a plain engine, LoRA off, captured, same scheduling
    pcfg = PagedEngineConfig(model=model_cfg, **base_kw)
    plain = _tenant_run(params, pcfg, [], device, seed, False, waves,
                        as_base=True)
    P = plain["engine"]
    for k in ("prefill_dispatches", "decode_dispatches", "prefix_hits"):
        if P.stats[k] != A.stats[k]:
            raise AssertionError(f"plain engine scheduled otherwise: {k}")
    for w, wave in enumerate(waves):
        for (p, sp, slot, _salt), x, y in zip(wave, cap["outs"][w],
                                              plain["outs"][w]):
            if slot == 0 and x != y:
                raise AssertionError(f"base row differs with LoRA on: "
                                     f"{x} != {y}")
    tps = {"lora_on": [sum(len(o[0]) for o in out) / s for out, s in
                       zip(cap["outs"], cap["secs"])],
           "lora_off": [sum(len(o[0]) for o in out) / s for out, s in
                        zip(plain["outs"], plain["secs"])]}
    del plain, P
    # tenants alone, and against merged weights (printed, not held)
    alone_ok, merged = 0, {}
    for (p, sp, slot, salt), (toks, _) in zip(wave1, cap["outs"][0]):
        if slot == 0 or sp.temperature > 0:
            continue
        if _gen(A, p, sp, slot, salt) != toks:
            raise AssertionError(f"tenant {slot}: alone != mixed")
        alone_ok += 1
        m = PagedInferenceEngine(
            PagedEngineConfig(model=model_cfg, **dict(base_kw,
                                                      kv_spill=False)),
            params=lora.merge(params, adapters[slot - 1]), device=device)
        m._eager = True
        mt = _gen(m, p, sp)
        same = next((i for i, (a, b) in enumerate(zip(mt, toks)) if a != b),
                    len(toks))
        merged[f"tenant-{slot}"] = {"equal_prefix": same,
                                    "tokens": len(toks)}
        del m
    # reload: slot 3 takes adapter 1 after capture
    ptrs = {k: t.data_ptr() for k, t in A.lora.tree.items()}
    x = [int(t) for t in np.random.RandomState(seed + 9).randint(
        0, model_cfg.vocab_size, 100)]
    g = SamplingParams(max_tokens=16)
    before = _gen(A, x, g, 3, b"reload-a")
    t1 = time.perf_counter()
    A.load_adapter_slot(3, adapters[0])
    sync()
    reload_s = time.perf_counter() - t1
    after = _gen(A, x, g, 3, b"reload-b")
    if after != _gen(A, x, g, 1, b"reload-c") or after == before or \
            {k: t.data_ptr() for k, t in A.lora.tree.items()} != ptrs:
        raise AssertionError("slot reload did not reach the replay")
    # payloads into engine B: same params tensors, no slot table
    bcfg = PagedEngineConfig(model=model_cfg, **dict(engine_kw,
                                                     num_pages=num_pages))
    B = PagedInferenceEngine(bcfg, params=params, rng_seed=seed,
                             device=device)
    pd_prompt = wave1[0][0]
    whole = _gen(A, pd_prompt, g)
    _gen(B, [int(t) for t in np.random.RandomState(seed + 11).randint(
        0, model_cfg.vocab_size, 200)], g)    # B's programs captured
    pools = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in B.caches]
    payload = A.prefill_export(pd_prompt, g)
    sync()
    t1 = time.perf_counter()
    req = B.import_prefill(payload, g)
    sync()
    import_s = time.perf_counter() - t1
    B.run_until_done([req])
    if req.out_ids != whole:
        raise AssertionError(f"PD tokens {req.out_ids} != {whole}")
    px = waves[1][0][0]
    hs = A.hash_prompt(px)
    A_export = A.export_prefix(hs)
    if A_export is None:
        _gen(A, px, g)
        A_export = A.export_prefix(hs)
    n_imp = B.import_prefix(A_export, reserve_pages=0)
    if n_imp <= 0 or not _pages_equal(A_export, B.export_prefix(hs)):
        raise AssertionError("prefix import/re-export not bitwise")
    hits0 = B.stats["prefix_hits"]
    b_toks = _gen(B, px, g)
    if B.stats["prefix_hits"] - hits0 < len(hs) or \
            b_toks != _gen(A, px, g):
        raise AssertionError("B did not admit the imported prefix")
    if [(c["k"].data_ptr(), c["v"].data_ptr()) for c in B.caches] != pools:
        raise AssertionError("an import rebound B's pools")
    graphs = A._graphs
    # 4j's reference: each tenant's greedy request of wave 1 and its tokens
    tenant_greedy = [{"seed": slot, "prompt": p, "max_tokens": sp.max_tokens,
                      "logprobs": sp.logprobs, "tokens": toks}
                     for (p, sp, slot, _salt), (toks, _lp)
                     in zip(wave1, cap["outs"][0])
                     if slot and sp.temperature <= 0]
    return {"launches": cap["launches"], "launches_by_family": cap["fam"],
            "tenant_greedy": tenant_greedy,
            "tokens_per_s_by_wave": tps, "waves_s": cap["secs"],
            "warmup_s": cap["warm_s"],
            "programs": len(graphs) if graphs is not None else 0,
            "capture_s_mean": (statistics.mean(graphs.capture_s)
                               if graphs is not None and graphs.capture_s
                               else None),
            "demote_ms_per_page": _per_page_ms(cap["demotes"]),
            "promote_ms_per_page": _per_page_ms(cap["promotes"]),
            "pages_demoted": sum(n for _, n in cap["demotes"]),
            "pages_promoted": sum(n for _, n in cap["promotes"]),
            "import_prefill_ms": 1e3 * import_s,
            "import_prefill_pages": len(payload["pages"][0]["k"]),
            "reload_ms": 1e3 * reload_s,
            "prefix_import_pages": n_imp,
            "tenants_alone_equal": alone_ok, "merged_agreement": merged,
            "spill": {k: A.stats[k] for k in (
                "spill_pages", "spill_demotions", "spill_promotions",
                "spill_expired", "prefix_evictions", "prefix_hits")},
            "page_bytes": page_nbytes,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None)}


# -- phase 5b: dense-engine agreement ---------------------------------------

def _flash_launches(phase: str, names) -> dict:
    """The flash kernels' launches since the last reset; raises unless
    each of names launched."""
    got = {n: c for n, c in _launch_counts().items() if n.startswith("flash")}
    if not all(got[n] for n in names):
        raise AssertionError(f"{phase}: launches {got}, want each of "
                             f"{names} at least once")
    return got


def dense_agreement() -> dict:
    """Phase 5's small f32 model (head_dim 128, GQA 2) through the dense
    InferenceEngine on the card (the f32 flash forward kernel in prefill)
    and on the CPU (plain versions): greedy tokens identical. Returns the
    flash kernels' launches in the card's run."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine, SamplingParams
    from ray_tpu_torch.models import llama
    mc = _small_model()
    cpu_params = llama.init(mc, seed=3, device="cpu")
    gpu_params = {k: ({n: t.cuda() for n, t in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    cfg = EngineConfig(model=mc, max_batch_size=3, max_seq_len=256)
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(0, 512, n)]
               for n in (7, 40, 95, 150)]
    sp = SamplingParams(max_tokens=12)
    _reset_launch_counts()
    a = InferenceEngine(cfg, gpu_params, device="cuda").generate(prompts, sp)
    launches = _flash_launches("dense agreement", ("flash_fwd",))
    b = InferenceEngine(cfg, cpu_params, device="cpu").generate(prompts, sp)
    for x, y in zip(a, b):
        if x["token_ids"] != y["token_ids"]:
            raise AssertionError(f"dense card {x['token_ids']} != "
                                 f"cpu {y['token_ids']}")
    print(f"dense agreement: {len(prompts)} prompts, greedy tokens "
          f"identical card vs CPU; launches {launches}", flush=True)
    return launches


# -- phase 6: train at full width, depth cut -------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def _counted() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_dkv_kernel, flash_dq_kernel, flash_fwd_kernel,
    )
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention
    return {"flash_fwd": flash_fwd_kernel, "flash_dq": flash_dq_kernel,
            "flash_dkv": flash_dkv_kernel,
            "ragged_paged_attention": ragged_paged_attention,
            "paged_decode_attention": paged_decode_attention}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def _reset_launch_counts():
    for fn in _counted().values():
        fn.launches = 0


def _train_step_fn(params, cfg, tokens):
    """The counterpart of bench.py's train step: loss = cross-entropy +
    moe_aux_weight * aux (aux 0 for dense configs), backward, AdamW (lr
    3e-4, no weight decay; its moments keep the params' dtype). A step
    returns (loss, logits, aux), detached; ``step.opt`` is the
    optimizer (phase 6b checkpoints and restores its state)."""
    from ray_tpu_torch.models import llama
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_()
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.0)

    def step():
        opt.zero_grad(set_to_none=True)
        logits, aux = llama.apply_with_aux(params, tokens[:, :-1], cfg)
        loss = llama.cross_entropy_loss(logits, tokens[:, 1:])
        if cfg.moe_experts:
            loss = loss + cfg.moe_aux_weight * aux
        loss.backward()
        opt.step()
        return loss.detach(), logits.detach(), aux.detach()
    step.opt = opt
    return step


def train(model_cfg, device, batch: int, seq: int, steps: int = 5,
          seed: int = 0) -> dict:
    """Phase 6 (also rehearsed on the CPU at tiny size): 1 warm step and
    ``steps`` timed steps on one batch of ``batch`` x ``seq`` tokens
    (targets shifted from seq + 1 random tokens drawn from ``seed``).
    Returns losses, launches per kernel, and the step figures."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from ray_tpu_torch.models import llama
    params = llama.init(model_cfg, seed=seed, device=device)
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(0, model_cfg.vocab_size,
                                         (batch, seq + 1)),
                             dtype=torch.int64, device=device)
    step = _train_step_fn(params, model_cfg, tokens)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()                 # main path starts here
    losses, step_s, per_step = [], [], []
    for i in range(1 + steps):
        before = _launch_counts()
        t0 = time.perf_counter()
        losses.append(float(step()[0]))
        sync()
        if i:
            step_s.append(time.perf_counter() - t0)
        after = _launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
    launches = _launch_counts()            # main path ends here
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite or not falling: "
                             f"{losses}")
    want = {"flash_fwd": model_cfg.n_layers, "flash_dq": model_cfg.n_layers,
            "flash_dkv": model_cfg.n_layers, "ragged_paged_attention": 0,
            "paged_decode_attention": 0}
    if cuda:
        for i, got in enumerate(per_step):
            if got != want:
                raise AssertionError(f"step {i}: launches {got}, want "
                                     f"{want} (forward not replayed)")
    med = statistics.median(step_s)
    tokens_per_step = batch * seq
    out = {"layers": model_cfg.n_layers, "batch": batch, "seq": seq,
           "losses": losses, "launches": launches,
           "launches_per_step": per_step[-1], "step_ms": [s * 1e3
                                                           for s in step_s],
           "step_ms_median": med * 1e3,
           "tokens_per_s": tokens_per_step / med}
    if cuda:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["model_flops_over_bf16_peak"] = (
            model_cfg.flops_per_token(seq) * tokens_per_step / med
            / PEAK_FLOPS[torch.bfloat16])
    return out


# -- phase 6b: phase 6's train step in a one-GPU TorchTrainer worker -------

#: phase 6b: the first attempt reports a checkpoint after this step, then
#: raises; the second attempt resumes from it
TRAINER_CRASH_STEP = 2


def _state_sums(params, opt) -> dict:
    """``_checksum`` sums of the params and of AdamW's two moments."""
    leaves = _leaves(params)
    return {"params": sum(_checksum(t.detach()) for t in leaves),
            **{m: sum(_checksum(opt.state[t][m]) for t in leaves)
               for m in ("exp_avg", "exp_avg_sq")}}


#: phase 6b's dataset: rows, blocks, and the token row width (seq + 1)
INGEST_ROWS = 2048
INGEST_BLOCKS = 16


def _ingest_rows(vocab: int, width: int, seed: int,
                 batch: int) -> np.ndarray:
    """6b's token rows: the first ``batch`` rows are phase 6's batch
    (phase 6's ``randint`` from ``RandomState(seed)``), the rest from
    ``RandomState(seed + 1)``; int32."""
    head = np.random.RandomState(seed).randint(0, vocab, (batch, width))
    rest = np.random.RandomState(seed + 1).randint(
        0, vocab, (INGEST_ROWS - batch, width))
    return np.concatenate([head, rest]).astype(np.int32)


def _row_sums(tokens):
    """Each row's checksum: sum over j of tokens[j] * (j + 1), in int64
    (numpy rows or a torch tensor on any device)."""
    if isinstance(tokens, np.ndarray):
        w = np.arange(1, tokens.shape[1] + 1, dtype=np.int64)
        return tokens.astype(np.int64) @ w
    w = torch.arange(1, tokens.shape[1] + 1, dtype=torch.int64,
                     device=tokens.device)
    return (tokens.to(torch.int64) * w).sum(1)


def _ingest_dataset(vocab: int, width: int, seed: int, batch: int):
    """6b's Dataset (built in the driver before fit) and each row's
    checksum, indexed by id."""
    from ray_tpu_torch import data as rdata
    rows = _ingest_rows(vocab, width, seed, batch)
    ds = rdata.from_items([{"id": i, "tokens": rows[i]}
                           for i in range(INGEST_ROWS)],
                          override_num_blocks=INGEST_BLOCKS)
    return ds, _row_sums(rows)


def _read_shard(device: str, batch: int) -> tuple:
    """One pass over this worker's ``get_dataset_shard("train")`` with
    ``iter_device_batches`` onto ``device``: the rows with ids
    0..batch-1 as the step's int64 tokens, and the pass's figures (every
    id and row checksum, read back once the pass has synced)."""
    from ray_tpu_torch import train as rtrain
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    shard = rtrain.get_dataset_shard("train")
    t0 = time.perf_counter()
    wait = None
    ids, toks = [], []
    for b in shard.iter_device_batches(batch_size=2, drop_last=False,
                                       device=device):
        if wait is None:
            wait = time.perf_counter() - t0
        ids.append(b["id"])
        toks.append(b["tokens"])
    sync()
    pass_s = time.perf_counter() - t0
    ids, toks = torch.cat(ids), torch.cat(toks)
    nbytes = ids.numel() * ids.element_size() + \
        toks.numel() * toks.element_size()
    order = torch.argsort(ids)
    tokens = toks[order[:batch]].to(torch.int64)
    fig = {"rows": int(ids.numel()), "pass_s": pass_s,
           "rows_per_s": ids.numel() / pass_s,
           "mb_per_s": nbytes / pass_s / 1e6, "mb": nbytes / 1e6,
           "first_batch_wait_s": wait, "tokens_device": str(tokens.device),
           "ids": ids.cpu().tolist(), "sums": _row_sums(toks).cpu().tolist()}
    return tokens, fig


def _trainer_loop(config):
    """Phase 6b's train loop, run by the TorchTrainer's worker: phase 6's
    weights (seed) and step for ``config["steps"]`` steps on phase 6's
    batch, read from the worker's Dataset shard (``_read_shard``, once
    per attempt, its figures in the attempt's first report), each
    step's loss and kernel launches (counts set to 0 just before the
    step, read just after) reported through train.report. On the first
    attempt (no marker file in the storage dir) rank 0 reports a
    checkpoint of the params, AdamW's state_dict() and the step after
    step TRAINER_CRASH_STEP, then raises; the restarted worker restores
    from train.get_checkpoint() and runs the steps left."""
    from ray_tpu_torch import train as rtrain
    from ray_tpu_torch.models import llama
    t_enter = time.time()
    cfg, device = config["cfg"], config["device"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    params = llama.init(cfg, seed=config["seed"], device=device)
    tokens, ingest = _read_shard(device, config["batch"])
    step = _train_step_fn(params, cfg, tokens)
    info = {"t_enter": t_enter, "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "banned": _banned_modules(), "ingest": ingest}
    start = 0
    ckpt = rtrain.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        state = ckpt.load_state()
        with torch.no_grad():
            for t, s in zip(_leaves(params), _leaves(state["params"])):
                t.copy_(s)
        step.opt.load_state_dict(state["opt"])
        sync()
        info["restore_s"] = time.perf_counter() - t0
        info["restored_sums"] = _state_sums(params, step.opt)
        start = state["step"] + 1
    for i in range(start, config["steps"]):
        _reset_launch_counts()             # the step starts here
        t0 = time.perf_counter()
        loss = float(step()[0])
        sync()
        m = {"step": i, "loss": loss,
             "step_ms": (time.perf_counter() - t0) * 1e3,
             "launches": _launch_counts(), "t": time.time()}
        if i == start:
            m.update(info)
        ck = None
        if (i == TRAINER_CRASH_STEP and not os.path.exists(config["marker"])
                and rtrain.get_context().get_world_rank() == 0):
            m["saved_sums"] = _state_sums(params, step.opt)
            t0 = time.perf_counter()
            ck = rtrain.Checkpoint.from_state(
                {"params": params, "opt": step.opt.state_dict(), "step": i},
                path=os.path.join(config["staging"], f"step_{i}"))
            m["save_s"] = time.perf_counter() - t0
            m["t_crash"] = time.time()
        rtrain.report(m, checkpoint=ck)
        if ck is not None:
            open(config["marker"], "w").close()
            raise RuntimeError(f"6b: the planned crash after step {i}'s "
                               f"checkpoint")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def trainer(model_cfg, phase6: dict, device="cuda", batch: int = 2,
            seq: int = 4096, seed: int = 0, then=None) -> dict:
    """Phase 6b: phase 6's train step (its weights, batch and AdamW) as
    the train loop of a TorchTrainer on the port's runtime
    (``ray_tpu_torch.init(num_cpus=2, num_gpus=1)``; on the CPU the GPU
    is a fake lease), one worker leasing one GPU, as many steps as phase
    6 took, a checkpoint after step TRAINER_CRASH_STEP, a crash and a
    resume (FailureConfig(max_failures=1), CheckpointConfig(num_to_keep=
    1)); the storage path is a temporary directory, removed at the end.
    Held: the losses equal ``phase6["losses"]`` bit for bit; on the card
    each step launches B3, B4 and B5 once per layer and the paged kernels
    never; the restored state's checksums equal the saved ones; the
    result (no error, the last step, every report of both attempts, the
    checkpoint's step); the GPU 0 while the gang holds it and back once
    fit returns, no worker left. ``then(rt, storage)``, where given, runs
    in the runtime before it shuts down (phase 6c), its figures returned
    under "then". Returns the figures."""
    import importlib.util
    import shutil
    import tempfile
    import threading
    import ray_tpu_torch as rt
    from ray_tpu_torch import train as rtrain
    cuda = device == "cuda"
    steps = len(phase6["losses"])
    t_phase = time.perf_counter()
    storage = tempfile.mkdtemp(prefix="rtpu_trainer_")
    du = shutil.disk_usage(storage)
    fig = {"layers": model_cfg.n_layers, "steps": steps,
           "crash_after_step": TRAINER_CRASH_STEP,
           "disk": {"path": storage, "total_gib": du.total / 2 ** 30,
                    "free_gib": du.free / 2 ** 30},
           "pyarrow": importlib.util.find_spec("pyarrow") is not None,
           "pandas": importlib.util.find_spec("pandas") is not None}
    print(f"trainer: df {storage}: {fig['disk']}", flush=True)
    try:
        rt.init(num_cpus=2, num_gpus=1)
        try:
            held, stop = [], threading.Event()

            def watch():
                while not stop.is_set():
                    held.append(rt.available_resources().get("GPU"))
                    stop.wait(0.2)

            t0 = time.perf_counter()
            ds, row_sums = _ingest_dataset(model_cfg.vocab_size, seq + 1,
                                           seed, batch)
            fig["dataset_build_s"] = time.perf_counter() - t0
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            t_fit = time.time()
            try:
                result = rtrain.TorchTrainer(
                    _trainer_loop,
                    train_loop_config={
                        "cfg": model_cfg, "device": device, "seed": seed,
                        "batch": batch, "seq": seq, "steps": steps,
                        "marker": os.path.join(storage, "crashed_once"),
                        "staging": os.path.join(storage, "staging")},
                    scaling_config=rtrain.ScalingConfig(
                        num_workers=1, gpus_per_worker=1),
                    run_config=rtrain.RunConfig(
                        name="trainer", storage_path=storage,
                        failure_config=rtrain.FailureConfig(max_failures=1),
                        checkpoint_config=rtrain.CheckpointConfig(
                            num_to_keep=1)),
                    datasets={"train": ds}).fit()
            finally:
                stop.set()
                watcher.join()
            fig["fit_s"] = time.time() - t_fit
            hist = result.metrics_history
            starts = [m for m in hist if "pid" in m]
            _await_gone(rt, [m["pid"] for m in starts], 1, "6b")
            if result.error is not None or result.metrics["step"] != steps - 1:
                raise AssertionError(f"6b: result {result}")
            if [m["step"] for m in hist] != list(range(steps)):
                raise AssertionError(f"6b: reports of steps "
                                     f"{[m['step'] for m in hist]}")
            losses = [m["loss"] for m in hist]
            if losses != phase6["losses"]:
                raise AssertionError(f"6b: losses {losses} != phase 6 "
                                     f"{phase6['losses']}")
            want = {"flash_fwd": model_cfg.n_layers,
                    "flash_dq": model_cfg.n_layers,
                    "flash_dkv": model_cfg.n_layers,
                    "ragged_paged_attention": 0, "paged_decode_attention": 0}
            for m in hist if cuda else ():
                if m["launches"] != want:
                    raise AssertionError(f"6b: step {m['step']} launches "
                                         f"{m['launches']}, want {want}")
            if len(starts) != 2 or len({m["pid"] for m in starts}) != 2:
                raise AssertionError(f"6b: attempts {starts}")
            for m in starts:
                if m["visible"] != "0" or m["banned"]:
                    raise AssertionError(f"6b: worker saw CUDA_VISIBLE_"
                                         f"DEVICES {m['visible']!r}, loaded "
                                         f"{m['banned']}")
            want_ids = list(range(INGEST_ROWS))
            for m in starts:
                got = m["ingest"]
                if sorted(got["ids"]) != want_ids or got["rows"] != \
                        INGEST_ROWS:
                    raise AssertionError(f"6b: attempt read {got['rows']} "
                                         f"rows, not ids 0-{INGEST_ROWS - 1}"
                                         f" once each")
                bad = [i for i, c in zip(got["ids"], got["sums"])
                       if c != int(row_sums[i])]
                if bad:
                    raise AssertionError(f"6b: row checksums differ from "
                                         f"the driver's at ids {bad[:8]}")
                if got["tokens_device"].split(":")[0] != device:
                    raise AssertionError(f"6b: step tokens on "
                                         f"{got['tokens_device']}")
            saved = next(m for m in hist if "saved_sums" in m)
            if starts[1]["restored_sums"] != saved["saved_sums"]:
                raise AssertionError(f"6b: restored {starts[1]['restored_sums']}"
                                     f" != saved {saved['saved_sums']}")
            if result.checkpoint.load_state()["step"] != TRAINER_CRASH_STEP:
                raise AssertionError("6b: the checkpoint's step")
            if 0 not in held:
                raise AssertionError(f"6b: GPUs available while the gang "
                                     f"ran: {sorted(set(held))}")
            first = {m["step"] for m in starts}
            fig.update({
                "worker_start_s": [starts[0]["t_enter"] - t_fit,
                                   starts[1]["t_enter"] - saved["t_crash"]],
                "first_step_s": [m["step_ms"] / 1e3 for m in starts],
                "step_ms": [m["step_ms"] for m in hist],
                "step_ms_median": statistics.median(
                    m["step_ms"] for m in hist if m["step"] not in first),
                "phase6_step_ms_median": phase6["step_ms_median"],
                "checkpoint_gib": _dir_bytes(result.checkpoint.path) / 2 ** 30,
                "save_s": saved["save_s"],
                "restore_s": starts[1]["restore_s"],
                "crash_to_resumed_step_s": (
                    next(m for m in hist if m["step"] == TRAINER_CRASH_STEP
                         + 1)["t"] - saved["t_crash"]),
                "launches": {n: sum(m["launches"][n] for m in hist)
                             for n in want},
                "ingest": [{k: v for k, v in m["ingest"].items()
                            if k not in ("ids", "sums")} for m in starts],
                "losses_equal_phase6": True})
            if then is not None:
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                fig["then"] = then(rt, storage)
        finally:
            rt.shutdown()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 30
    while _port_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    if _port_procs():
        raise AssertionError(f"6b: port workers left alive: {_port_procs()}")
    fig["phase_s"] = time.perf_counter() - t_phase
    if cuda:
        fig["card"] = _card()
    return fig


# -- phase 6c: the LoRA trainer and Tune in 6b's runtime --------------------

#: phase 6c's fine-tune: the trainer's fields (targets, rank, alpha, lr,
#: batch, checkpoint cadence, seed)
LORA_6C = dict(targets=("wq", "wv", "lm_head"), rank=16, alpha=32.0,
               learning_rate=1e-3, batch_size=4, seq_len=512,
               checkpoint_every=10, seed=0)
LORA_STEPS = 20          # local mode's first run and substrate mode
LORA_RESUMED = 30        # the resumed run and the uninterrupted one
LORA_TOKEN = 7           # every target
TUNE_REPORTS = 6         # TuneConfig(stop={"training_iteration": 6})
TUNE_LRS = (1e-3, 1e-4)


class _LoraProbe:
    """6c's data function and per-step record, in whichever process runs
    the step (the driver, the gang's worker, a trial). ``data`` is the
    reference test's ``_teach`` at 6c's batch (inputs from
    ``RandomState(1000 + step)``, every target LORA_TOKEN) and sets the
    kernels' launch counts to 0: the step starts there. ``step``
    (the trainer's on_step) reads them just after the step; with a
    ``path`` each record is also appended there as a JSON line."""

    def __init__(self, vocab: int, batch: int, seq: int, path=None):
        self.vocab, self.batch, self.seq, self.path = vocab, batch, seq, path
        self.records: list = []
        self.t0 = None
        self.first_data_t = None

    def data(self, step):
        _reset_launch_counts()
        self.t0 = time.perf_counter()
        if self.first_data_t is None:
            self.first_data_t = time.time()
        rng = np.random.RandomState(1000 + step)
        toks = rng.randint(1, self.vocab,
                           (self.batch, self.seq + 1)).astype(np.int32)
        return toks[:, :self.seq], np.full((self.batch, self.seq),
                                           LORA_TOKEN, np.int32)

    def step(self, step, loss):
        rec = {"step": step, "loss": loss, "launches": _launch_counts(),
               "ms": (time.perf_counter() - self.t0) * 1e3,
               "t": time.time(), "pid": os.getpid(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "banned": _banned_modules()}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


def _lora_trial(config):
    """6c's Tune trainable, in the trial's process: phase 6's base by
    phase 6's own ``llama.init`` call (seed 0, on the card), then the
    trainer's loop from 6c's init with a checkpoint and a tune.report
    every step (the step's record and the process's entry time in the
    metrics); the controller's STOP ends it after TUNE_REPORTS."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.llm.multilora.train import LoRATrainConfig, _run_loop
    from ray_tpu_torch.models import llama
    t_enter = time.time()
    mc, lr = config["model"], config["learning_rate"]
    base = llama.init(mc, seed=0, device=config["device"])
    probe = _LoraProbe(mc.vocab_size, LORA_6C["batch_size"],
                       LORA_6C["seq_len"])
    tcfg = LoRATrainConfig(model=mc, steps=LORA_STEPS, **{
        **LORA_6C, "checkpoint_every": 1, "learning_rate": lr})

    def report(step, loss, st):
        ck = tune.Checkpoint.from_state(st, path=os.path.join(
            config["storage"], f"trial_lr{lr:g}_step{step}"))
        tune.report({**probe.records[-1], "t_enter": t_enter}, checkpoint=ck)

    _run_loop(tcfg, base, probe.data, None, report, probe.step)


def lora_tune(model_cfg, rt, storage: str, phase6: dict, device="cuda",
              **engine_kw) -> dict:
    """Phase 6c (also rehearsed on the CPU at tiny size, where the GPU is
    a fake lease and launches are not held): the LoRA trainer in the
    driver (local mode, resumed), on a one-GPU gang (substrate mode),
    published and served by an eager paged engine, then tuned by a
    Tuner, in 6b's runtime ``rt``; files under ``storage``. Returns the
    figures (module docstring, 6c)."""
    import glob
    import shutil
    import tempfile
    import threading
    from ray_tpu_torch import train as rtrain
    from ray_tpu_torch import tune
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                                   lora)
    from ray_tpu_torch.llm.multilora import (AdapterRegistry,
                                             LoRATrainConfig, LoRATrainer,
                                             MultiLoraManager)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention as rpa
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    tmp_before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                            "rtpu_ckpt_*")))
    mc, L = model_cfg, model_cfg.n_layers
    vocab, batch, seq = (mc.vocab_size, LORA_6C["batch_size"],
                         LORA_6C["seq_len"])
    want = {"flash_fwd": L, "flash_dq": L, "flash_dkv": L,
            "ragged_paged_attention": 0, "paged_decode_attention": 0}

    def tcfg(steps, **kw):
        return LoRATrainConfig(model=mc, steps=steps, **{**LORA_6C, **kw})

    def held_steps(label, recs, first, n):
        if [r["step"] for r in recs] != list(range(first, first + n)):
            raise AssertionError(f"6c {label}: steps "
                                 f"{[r['step'] for r in recs]}")
        for r in recs if cuda else ():
            if r["launches"] != want:
                raise AssertionError(f"6c {label}: step {r['step']} "
                                     f"launches {r['launches']}, want "
                                     f"{want}")

    def same_adapter(label, a, b):
        if sorted(a) != sorted(b) or not all(
                np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and
                np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"6c: {label}: adapters differ")

    def median_ms(recs, skip_first=True):
        ms = [r["ms"] for r in recs[1 if skip_first else 0:]]
        return statistics.median(ms)

    base = llama.init(mc, seed=0, device=device)      # phase 6's base
    fig = {"layers": L, "config": {k: v for k, v in LORA_6C.items()},
           "phase6_step_ms_median": phase6["step_ms_median"]}

    # (1) local mode in the driver: 20 steps, then resumed to 30
    local_dir = os.path.join(storage, "lora_local")
    p1 = _LoraProbe(vocab, batch, seq)
    t1 = LoRATrainer(tcfg(LORA_STEPS), "tenant", base_params=base,
                     data_fn=p1.data, storage_path=local_dir,
                     on_step=p1.step)
    ad20 = t1.fit()
    held_steps("local", p1.records, 1, LORA_STEPS)
    losses = [r["loss"] for r in p1.records]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"6c local: losses {losses}")
    p2 = _LoraProbe(vocab, batch, seq)
    t2 = LoRATrainer(tcfg(LORA_RESUMED), "tenant", base_params=base,
                     data_fn=p2.data, storage_path=local_dir,
                     on_step=p2.step)
    t_resume = time.time()
    ad30 = t2.fit()
    held_steps("resumed", p2.records, LORA_STEPS + 1,
               LORA_RESUMED - LORA_STEPS)
    p3 = _LoraProbe(vocab, batch, seq)
    ad30_fresh = LoRATrainer(tcfg(LORA_RESUMED), "fresh", base_params=base,
                             data_fn=p3.data, on_step=p3.step).fit()
    held_steps("uninterrupted", p3.records, 1, LORA_RESUMED)
    same_adapter("resumed 30 vs uninterrupted 30", ad30, ad30_fresh)
    if [r["loss"] for r in p3.records] != losses + [
            r["loss"] for r in p2.records]:
        raise AssertionError("6c: the uninterrupted run's losses")
    ckpts = sorted(glob.glob(os.path.join(local_dir, "tenant",
                                          "checkpoints", "checkpoint_*")))
    fig["local"] = {
        "losses": losses, "step_ms_median": median_ms(p1.records),
        "resume_s": p2.first_data_t - t_resume,
        "checkpoint_mib": _dir_bytes(ckpts[-1]) / 2 ** 20,
        "resumed_equals_uninterrupted": True,
        "launches": {n: sum(r["launches"][n] for r in p1.records)
                     for n in want}}
    print(f"lora_tune: local {json.dumps(fig['local'])}", flush=True)

    # (2) substrate mode: the 20-step config on a one-GPU gang
    wpath = os.path.join(storage, "lora_worker_steps.jsonl")
    pw = _LoraProbe(vocab, batch, seq, path=wpath)
    held, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            held.append(rt.available_resources().get("GPU"))
            stop.wait(0.2)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    t_fit = time.time()
    try:
        sub = LoRATrainer(
            tcfg(LORA_STEPS), "tenant", base_params=base, data_fn=pw.data,
            on_step=pw.step,
            scaling_config=rtrain.ScalingConfig(num_workers=1,
                                                gpus_per_worker=1),
            run_config=rtrain.RunConfig(name="lora_substrate",
                                        storage_path=storage))
        ad_sub = sub.fit()
    finally:
        stop.set()
        watcher.join()
    with open(wpath) as f:
        wrecs = [json.loads(ln) for ln in f]
    held_steps("worker", wrecs, 1, LORA_STEPS)
    if [r["loss"] for r in wrecs] != losses:
        raise AssertionError(f"6c worker: losses {[r['loss'] for r in wrecs]}"
                             f" != local {losses}")
    same_adapter("substrate vs local", ad_sub, ad20)
    pids = {r["pid"] for r in wrecs}
    if len(pids) != 1 or pids & {os.getpid()} or any(
            r["visible"] != "0" or r["banned"] for r in wrecs):
        raise AssertionError(f"6c worker: {wrecs[0]}")
    if 0 not in held:
        raise AssertionError(f"6c: GPUs available while the gang ran: "
                             f"{sorted(set(held))}")
    _await_gone(rt, list(pids), 1, "6c worker")
    fig["worker"] = {
        "start_s": wrecs[0]["t"] - wrecs[0]["ms"] / 1e3 - t_fit,
        "step_ms_median": median_ms(wrecs),
        "base_blob_gib": sub.base_blob_bytes / 2 ** 30,
        "base_pickle_s": sub.base_pickle_s,
        "equals_local": True, "visible": "0",
        "launches": {n: sum(r["launches"][n] for r in wrecs) for n in want}}
    print(f"lora_tune: worker {json.dumps(fig['worker'])}", flush=True)

    # (3) publish into the runtime's registry; serve base and tenant
    reg = AdapterRegistry("lora6c")
    t1.registry = reg
    t0 = time.perf_counter()
    version = t1.publish()
    publish_ms = (time.perf_counter() - t0) * 1e3
    got_v, payload = reg.fetch("tenant")
    if version != 0 or got_v != 0:
        raise AssertionError(f"6c publish: versions {version}, {got_v}")
    same_adapter("fetched payload vs trainer", payload, t1.adapter)
    prompts, sps = _requests(vocab, 0)
    greedy = [(p, sp) for p, sp in zip(prompts, sps) if not sp.temperature]
    eng = PagedInferenceEngine(
        PagedEngineConfig(model=mc, max_adapters=2, lora_rank=16,
                          **engine_kw), params=base, device=device)
    eng._eager = True
    slot, _v, salt = MultiLoraManager(eng, reg, refresh_s=0.0).resolve(
        "tenant")
    n = len(greedy)
    wave = ([(p, sp, 0, b"") for p, sp in greedy]
            + [(p, sp, slot, salt) for p, sp in greedy])
    fam = {"prefill": 0, "decode": 0, "verify": 0}
    _family_counter(eng, fam, rpa)
    rpa.launches = 0                       # the serving pass starts here
    t0 = time.perf_counter()
    outs = _submit_wave(eng, wave)
    sync()
    wall = time.perf_counter() - t0
    served_launches = rpa.launches         # and ends here
    del eng
    plain = PagedInferenceEngine(PagedEngineConfig(model=mc, **engine_kw),
                                 params=base, device=device)
    plain._eager = True
    plain_outs = _submit_wave(plain, wave, as_base=True)
    del plain
    if outs[:n] != plain_outs[:n]:
        raise AssertionError("6c serve: base rows differ from the plain "
                             "engine's")
    if all(outs[n + i][0] == outs[i][0] for i in range(n)):
        raise AssertionError("6c serve: every tenant row equals its base "
                             "row")
    if cuda and not (fam["prefill"] > 0 and fam["decode"] > 0):
        raise AssertionError(f"6c serve: ragged launches {fam}")
    merged = PagedInferenceEngine(
        PagedEngineConfig(model=mc, **engine_kw),
        params=lora.merge(base, t1.adapter), device=device)
    merged._eager = True
    merged_outs = _submit_wave(merged, [(p, sp, 0, b"") for p, sp in greedy])
    del merged
    tenant = [ids for ids, _lp in outs[n:]]
    pairs = [(a, b) for (ids, _), (mids, _) in zip(outs[n:], merged_outs)
             for a, b in zip(ids, mids)]
    fig["serve"] = {
        "requests": 2 * n, "base_rows_equal_plain": True,
        "tenant_rows_differing": sum(outs[n + i][0] != outs[i][0]
                                     for i in range(n)),
        "tenant_tokens_per_s": sum(map(len, tenant)) / wall,
        "taught_share": sum(ids.count(LORA_TOKEN) for ids in tenant)
        / max(1, sum(map(len, tenant))),
        "merged_agreement": sum(a == b for a, b in pairs) / max(1,
                                                                len(pairs)),
        "launches": served_launches, "launches_by_family": dict(fam),
        "publish_ms": publish_ms}
    print(f"lora_tune: serve {json.dumps(fig['serve'])}", flush=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (4) Tune: one trial at a time on the GPU, stopped after 6 reports
    t_fit = time.time()
    grid = tune.Tuner(
        _lora_trial,
        param_space={"learning_rate": tune.grid_search(list(TUNE_LRS)),
                     "model": mc, "device": device, "storage": storage},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1,
                                    stop={"training_iteration":
                                          TUNE_REPORTS}),
        run_config=rtrain.RunConfig(name="lora_tune", storage_path=storage),
        resources_per_trial={"CPU": 1, "GPU": 1}).fit()
    if len(grid) != len(TUNE_LRS) or grid.errors:
        raise AssertionError(f"6c tune: {len(grid)} trials, errors "
                             f"{grid.errors}")
    trials = sorted(grid, key=lambda r: r.metrics_history[0]["t_enter"])
    tpids = []
    for r in trials:
        hist = r.metrics_history
        if r.status != "TERMINATED" or len(hist) != TUNE_REPORTS:
            raise AssertionError(f"6c tune: {r.config['learning_rate']}: "
                                 f"{r.status}, {len(hist)} reports")
        held_steps(f"trial lr {r.config['learning_rate']}", hist, 1,
                   TUNE_REPORTS)
        if len({m["pid"] for m in hist}) != 1 or any(
                m["visible"] != "0" or m["banned"] for m in hist):
            raise AssertionError(f"6c tune: trial {hist[0]}")
        tpids.append(hist[0]["pid"])
    by_lr = {r.config["learning_rate"]: r for r in grid}
    first = [m["loss"] for m in by_lr[TUNE_LRS[0]].metrics_history]
    if first != losses[:TUNE_REPORTS]:
        raise AssertionError(f"6c tune: lr {TUNE_LRS[0]} losses {first} != "
                             f"local {losses[:TUNE_REPORTS]}")
    best = grid.get_best_result()
    lower = min(grid, key=lambda r: r.metrics["loss"])
    if best.trial_id != lower.trial_id:
        raise AssertionError("6c tune: best result")
    if len(set(tpids)) != len(tpids):
        raise AssertionError(f"6c tune: trial pids {tpids}")
    _await_gone(rt, tpids, 1, "6c tune")
    head = rt_mod.get_runtime_if_exists()
    with head.lock:
        waits = [w.card_wait for w in head.workers.values()
                 if getattr(w.proc, "pid", None) in tpids]
    fig["tune"] = {
        "trials": len(grid), "best_lr": best.config["learning_rate"],
        "last_loss": {f"{lr:g}": by_lr[lr].metrics["loss"]
                      for lr in TUNE_LRS},
        "start_s": [trials[0].metrics_history[0]["t_enter"] - t_fit] + [
            b.metrics_history[0]["t_enter"] - a.metrics_history[-1]["t"]
            for a, b in zip(trials, trials[1:])],
        "step_ms_median": [median_ms(r.metrics_history) for r in trials],
        "card_wait": waits,
        "losses_equal_local": True,
        "launches": {n: sum(m["launches"][n] for r in trials
                            for m in r.metrics_history) for n in want}}
    print(f"lora_tune: tune {json.dumps(fig['tune'])}", flush=True)
    for d in set(glob.glob(os.path.join(tempfile.gettempdir(),
                                        "rtpu_ckpt_*"))) - tmp_before:
        shutil.rmtree(d, ignore_errors=True)
    fig["phase_s"] = time.perf_counter() - t_phase
    if cuda:
        fig["card"] = _card()
    return fig


# -- phase 7: training agreement --------------------------------------------

def train_agreement(mc) -> dict:
    """The same small f32 model (``_small_model`` with remat save_attn,
    dense or MoE) trained for 2 steps on the card (the f32 flash kernels)
    and on the CPU (plain versions): each step's loss and MoE aux within
    1e-5, and its logits and every gradient within |card - cpu| <= 1e-4 *
    max|cpu| + 1e-3 * |cpu| (f32 sums in other orders). The dense
    model's second step starts from the parameters each side's AdamW
    made, which differ by about +-lr wherever a gradient is near 0. The
    MoE model's second step starts from the CPU's parameters on both
    sides (copied onto the card): there, those moved parameters alone
    put step 1's gradients past the rule while every step-0 gradient
    agrees to a few 1e-6 of its max (``tools/moe_card_probes.py train``
    prints both), so the step is held to the CPU's at the same
    parameters. Returns the flash kernels' launches in the card's run."""
    from ray_tpu_torch.models import llama
    rng = np.random.RandomState(11)
    tok = rng.randint(0, mc.vocab_size, (2, 161))
    sides = {}
    for device in ("cuda", "cpu"):
        params = llama.init(mc, seed=5, device="cpu")
        if device == "cuda":
            params = {k: ({n: t.cuda() for n, t in v.items()}
                          if isinstance(v, dict) else v.cuda())
                      for k, v in params.items()}
        tokens = torch.as_tensor(tok, dtype=torch.int64, device=device)
        sides[device] = (_train_step_fn(params, mc, tokens), _leaves(params))
    runs = {device: ([], [], []) for device in sides}
    _reset_launch_counts()
    for s in range(2):
        if s and mc.moe_experts:
            with torch.no_grad():
                for a, b in zip(sides["cuda"][1], sides["cpu"][1]):
                    a.copy_(b)
        for device, (step, leaves) in sides.items():
            losses, auxes, tensors = runs[device]
            loss, logits, aux = step()
            losses.append(float(loss))
            auxes.append(float(aux))
            tensors.append([logits.cpu()]
                           + [t.grad.detach().cpu() for t in leaves])
    launches = _flash_launches("train agreement",
                               ("flash_fwd", "flash_dq", "flash_dkv"))
    (lc, ac, tc), (lp, ap, tp) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc, lp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ac, ap, atol=1e-5, rtol=0)
    if mc.moe_experts and not all(a > 0 for a in ap):
        raise AssertionError(f"MoE aux losses {ap}")
    worst = 0.0
    for s, (a_list, b_list) in enumerate(zip(tc, tp)):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            err = (a - b).abs()
            bound = 1e-4 * float(b.abs().max()) + 1e-3 * b.abs()
            if (err > bound).any():
                raise AssertionError(f"step {s}: "
                                     f"{'logits' if i == 0 else 'gradient'} "
                                     f"off by {float(err.max()):.3g}")
            worst = max(worst, float((err / (b.abs().max() + 1e-30)).max()))
    print(f"train agreement ({'MoE ' if mc.moe_experts else ''}"
          f"{mc.n_layers} layers): losses card {lc} cpu {lp}; aux card "
          f"{ac} cpu {ap}; worst logits or gradient error {worst:.3g} of "
          f"its tensor's max; launches {launches}", flush=True)
    return launches


# -- --profile-train: where a train step's device time goes ---------------

_FAMILIES = (("flash_fwd", "flash_fwd_kernel"),
             ("flash_dq", "flash_dq_kernel"),
             ("flash_dkv", "flash_dkv_kernel"),
             ("optimizer", "multi_tensor_apply"),
             ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
             ("softmax / log_softmax", "softmax"),
             ("embedding / index", ("index", "embedding", "gather",
                                    "scatter")),
             ("reduce", "reduce"), ("elementwise", "elementwise"),
             ("copy / fill", ("copy", "fill", "memset", "memcpy")))


def _family(name: str, families=_FAMILIES) -> str:
    low = name.lower()
    for fam, keys in families:
        if any(k in low for k in ((keys,) if isinstance(keys, str)
                                  else keys)):
            return fam
    return "other"


def profile_train():
    """One warm and one traced step of phase 6 under torch.profiler:
    device time by kernel family and the 15 largest kernels, the traced
    step's wall time, and the device-busy share (kernel time / wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.models import llama
    cfg = llama.llama3_8b(n_layers=TRAIN_LAYERS)
    params = llama.init(cfg, seed=0, device="cuda")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 4097)), dtype=torch.int64, device="cuda")
    step = _train_step_fn(params, cfg, tokens)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        # device-side ranges of user annotations (Optimizer.step#...)
        # span kernels already counted: skip them
        if ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.time_range.elapsed_us() / 1e3      # us -> ms
            k[1] += 1
    busy = sum(t for t, _ in kernels.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    fams = {}
    for name, (t, n) in kernels.items():
        f = fams.setdefault(_family(name), [0.0, 0])
        f[0] += t
        f[1] += n
    print(f"profile: traced step wall {wall * 1e3:.1f} ms, kernel time "
          f"{busy:.1f} ms, device busy share {busy / (wall * 1e3):.3f}",
          flush=True)
    for fam, (t, n) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"profile family: {fam:24s} {t:9.2f} ms {t / busy:6.1%} "
              f"{n:6d} launches")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, n) in top:
        print(f"profile kernel: {t:9.2f} ms {n:5d}x {name[:110]}")


# -- --profile-serve: where a serve step's time goes ------------------------

# serve-side kernel families, matched before _FAMILIES: the ragged paged
# attention kernel (B1), sampling, the host transfers, and dtype casts
# (the dense decode's per-layer f32 copy of the K cache is one)
_SERVE_FAMILIES = (
    ("ragged_paged_attention (B1)", ("rpa_", "ragged_paged_attention")),
    ("sampling (sort, argmax, log_softmax)", ("sort", "argmax")),
    ("H2D copy", "htod"), ("D2H copy", "dtoh"),
    ("dtype cast (direct_copy)", "direct_copy"),
) + _FAMILIES
_SAMPLING = _SERVE_FAMILIES[1][0]
# the warp softmax kernel's template arguments are <input, output, acc,
# log2 elements, is_log_softmax, ...>: a log_softmax when the fifth is true
_WARP_LOG_SOFTMAX = re.compile(r"softmax_warp_forward<(?:[^,<>]+,){4}\s*true")


def _serve_family(name: str) -> str:
    """Family of a serve kernel. Sampling's log_softmax (the LogSoftMax
    epilogue, or the warp kernel with is_log_softmax set) counts as
    sampling; a plain softmax is attention's (the dense decode's plain
    attention over the cache: sampling has none)."""
    low = name.lower()
    if "softmax" in low:
        if "logsoftmax" in low or _WARP_LOG_SOFTMAX.search(name):
            return _SAMPLING
        return "attention softmax (plain)"
    return _family(name, _SERVE_FAMILIES)


class _HostClock:
    """Host wall per label around wrapped calls, each also labelled for
    the trace with record_function("serve::<label>")."""

    def __init__(self):
        self.s, self.n, self.events = {}, {}, {}

    def wrap(self, label: str, fn, sync: bool = False):
        """With ``sync``, the call is followed by a device synchronise, so
        "inside" holds the device's work; every call also records CUDA
        events around it on the current stream (its device span, read by
        ``device_span_ms`` once the work is done)."""
        from torch.profiler import record_function

        def run(*a, **kw):
            with record_function(f"serve::{label}"):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                start.record()
                out = fn(*a, **kw)
                end.record()
                if sync:
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t
            self.s[label] = self.s.get(label, 0.0) + dt
            self.n[label] = self.n.get(label, 0) + 1
            self.events.setdefault(label, []).append((start, end))
            return out
        return run

    def device_span_ms(self, label: str) -> float:
        """Device time between the events around every call of label
        (idle gaps inside a call included), summed."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events.get(label, []))

    def reset(self):
        self.s, self.n, self.events = {}, {}, {}

    def split(self, dispatches: tuple, decode: str,
              decode_steps: int) -> dict:
        """Host ms inside each decode dispatch (and per decode step: a
        window dispatch runs several), and the engine step's time outside
        every dispatch (the Python loop around them), per engine step."""
        inside = sum(self.s.get(d, 0.0) for d in dispatches)
        steps = self.n.get("step", 0)
        nd = self.n.get(decode, 0)
        ms = self.s.get(decode, 0.0) * 1e3
        span = self.device_span_ms(decode)
        return {"steps": steps, "decode_dispatches": nd,
                "decode_steps": decode_steps,
                "inside_ms_per_decode_dispatch": ms / nd if nd else None,
                "inside_ms_per_decode_step":
                    ms / decode_steps if decode_steps else None,
                "device_span_ms_per_decode_step":
                    span / decode_steps if decode_steps else None,
                "outside_ms_per_step":
                    (self.s.get("step", 0.0) - inside) / steps * 1e3
                    if steps else None}


def _serve_trace(label: str, run, decode_steps, decode_tokens,
                 shapes: bool = False) -> dict:
    """Run ``run()`` under torch.profiler and print: wall, kernel time and
    busy share; kernels per decode dispatch / step / token (kernels whose
    start lies inside a serve::decode range); the family table; the 15
    largest kernels; with ``shapes``, the device time of aten::copy_ (casts
    and contiguous copies) by shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    ranges = {}
    kernels = []
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                kernels.append(ev)
        elif ev.name.startswith("serve::"):
            ranges.setdefault(ev.name[len("serve::"):], []).append(
                (ev.time_range.start, ev.time_range.end))
    busy = sum(k.time_range.elapsed_us() for k in kernels) / 1e3
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    dec = sorted(ranges.get("decode", []))
    starts = [s for s, _ in dec]
    import bisect
    in_decode, decode_ms = 0, 0.0
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        if i >= 0 and k.time_range.start <= dec[i][1]:
            in_decode += 1
            decode_ms += k.time_range.elapsed_us() / 1e3
    n_dec = len(dec)
    out = {"wall_ms": wall * 1e3, "kernel_ms": busy,
           "busy_share": busy / (wall * 1e3), "launches": len(kernels),
           "decode_dispatches": n_dec, "decode_steps": decode_steps(),
           "decode_tokens": decode_tokens(),
           "decode_launches": in_decode, "decode_kernel_ms": decode_ms,
           "decode_kernel_ms_per_dispatch": decode_ms / n_dec
           if n_dec else None}
    out["launches_per_decode_dispatch"] = in_decode / n_dec if n_dec else None
    out["launches_per_decode_step"] = (in_decode / out["decode_steps"]
                                       if out["decode_steps"] else None)
    out["launches_per_decode_token"] = (in_decode / out["decode_tokens"]
                                        if out["decode_tokens"] else None)
    out["decode_kernel_ms_per_step"] = (decode_ms / out["decode_steps"]
                                        if out["decode_steps"] else None)
    print(f"profile-serve {label}: " + json.dumps(out), flush=True)
    by_name, fams = {}, {}
    for k in kernels:
        ms = k.time_range.elapsed_us() / 1e3
        rec = by_name.setdefault(k.name, [0.0, 0])
        rec[0] += ms
        rec[1] += 1
        f = fams.setdefault(_serve_family(k.name), [0.0, 0])
        f[0] += ms
        f[1] += 1
    for fam, (t, n) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"profile-serve {label} family: {fam:38s} {t:9.3f} ms "
              f"{t / busy:6.1%} {n:7d} launches")
    for name, (t, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:15]:
        print(f"profile-serve {label} kernel: {t:9.3f} ms {n:6d}x "
              f"{name[:100]}")
    if shapes:
        # every copy kernel (dtype casts, and the permuted operands an
        # einsum makes contiguous) runs under aten::copy_: its 8 largest
        # by (destination, source) shape
        copies = []
        for avg in prof.key_averages(group_by_input_shape=True):
            if avg.key == "aten::copy_":
                dev = getattr(avg, "self_device_time_total", None)
                if dev is None:
                    dev = avg.self_cuda_time_total
                copies.append((dev / 1e3, avg.count, avg.input_shapes[:2]))
        for ms, n, shp in sorted(copies, key=lambda c: -c[0])[:8]:
            print(f"profile-serve {label} copy: aten::copy_ dst/src {shp} "
                  f"{n}x {ms:.3f} ms device")
    return out


def profile_serve():
    """Phases 1-2, then two traced serve runs at Llama-3-8B width.
    Paged: phase 4's engine, warmed, serves phase 4's requests once
    untraced, then the same mix drawn from another seed (so the prefix
    cache cannot serve it) under torch.profiler. Dense: phase 4b's
    engine, after a warm batch, runs ~20 traced decode steps over a full
    batch. For each: wall, kernel time and busy share; kernels per decode
    dispatch, step and token; the host ms inside a decode dispatch and
    outside the dispatches per engine step (taken in the untraced runs:
    the profiler's own host cost would inflate them), and the device
    span of each decode dispatch from CUDA events around it; the kernel
    families; the 15 largest kernels. The paged engine dispatches its
    captured programs (the kernels of a replay are device kernels like
    any other in the trace). Last, the batch witness
    (``_batch_witness``): greedy tokens in the mix against alone, under
    the shipped split rule."""
    from ray_tpu_torch.llm import (EngineConfig, InferenceEngine,
                                   PagedEngineConfig, PagedInferenceEngine,
                                   SamplingParams)
    from ray_tpu_torch.models import llama
    mc = llama.llama3_8b()
    eng = PagedInferenceEngine(
        PagedEngineConfig(model=mc, page_size=16, num_pages=1024,
                          max_pages_per_seq=64, chunk_size=128,
                          prefill_rows=4, decode_window=8, max_batch_size=8),
        params=llama.init(mc, seed=0, device="cuda"), device="cuda")
    eng.warmup(sample_modes=((False, False, False), (True, True, True)))
    clock = _HostClock()
    for name, attr in (("prefill", "_prefill_rows"),
                       ("decode", "_decode_window"),
                       ("verify", "_verify_rows"), ("step", "step")):
        setattr(eng, attr, clock.wrap(name, getattr(eng, attr)))
    windows = []                      # decode steps per decode dispatch
    decode_window = eng._decode_window

    def counted_window(w, *a, **kw):
        windows.append(w)
        return decode_window(w, *a, **kw)
    eng._decode_window = counted_window
    dispatches = ("prefill", "decode", "verify")
    # a first pass captures the keys warmup left out (logprob modes), so
    # no capture lands in the timed passes
    eng.generate(*_requests(mc.vocab_size, seed=1))
    clock.reset()
    windows.clear()
    prompts, sps = _requests(mc.vocab_size, seed=0)
    t = time.perf_counter()
    out = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    untraced = {"wall_ms": (time.perf_counter() - t) * 1e3,
                "tokens_out": sum(len(r["token_ids"]) for r in out),
                **clock.split(dispatches, "decode", sum(windows))}
    print("profile-serve paged untraced: " + json.dumps(untraced),
          flush=True)
    clock.reset()
    windows.clear()
    prompts, sps = _requests(mc.vocab_size, seed=3)
    tokens0 = eng.stats["tokens_out"]
    hits0 = eng.stats["prefix_hits"]
    traced = _serve_trace(
        "paged", lambda: eng.generate(prompts, sps), lambda: sum(windows),
        # one token per request comes from its prefill
        lambda: eng.stats["tokens_out"] - tokens0 - len(prompts))
    print("profile-serve paged traced host: " + json.dumps(
        {**clock.split(dispatches, "decode", sum(windows)),
         "prefix_hits": eng.stats["prefix_hits"] - hits0}), flush=True)
    _busy_estimate("paged", traced, untraced)
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()

    dense = InferenceEngine(EngineConfig(mc, max_batch_size=8,
                                         max_seq_len=1024),
                            params=llama.init(mc, seed=0, device="cuda"),
                            device="cuda")
    clock = _HostClock()
    # the dense decode returns before the device is done: the sync makes
    # "inside" the forward's device time (sampling would sync right after)
    dense._decode = clock.wrap("decode", dense._decode, sync=True)
    dense._prefill = clock.wrap("prefill", dense._prefill, sync=True)
    dense.step = clock.wrap("step", dense.step)
    warm, _ = _requests(mc.vocab_size, seed=0)
    dense.generate(warm[:8], SamplingParams(max_tokens=8))
    prompts, _ = _requests(mc.vocab_size, seed=3)
    reqs = [dense.submit(p, SamplingParams(max_tokens=64))
            for p in prompts[:8]]
    dense.step()                      # admits and prefills all 8
    for _ in range(20):               # untraced decode steps
        dense.step()
    torch.cuda.synchronize()
    untraced = clock.split(("decode", "prefill"), "decode",
                           clock.n.get("decode", 0))
    print("profile-serve dense untraced: " + json.dumps(untraced),
          flush=True)
    clock.reset()
    n0 = dense.stats["decode_dispatches"]
    t0 = dense.stats["tokens_out"]

    def twenty():
        for _ in range(20):
            dense.step()
    traced = _serve_trace("dense", twenty,
                          lambda: dense.stats["decode_dispatches"] - n0,
                          lambda: dense.stats["tokens_out"] - t0,
                          shapes=True)
    print("profile-serve dense traced host: " + json.dumps(
        clock.split(("decode", "prefill"), "decode",
                    clock.n.get("decode", 0))), flush=True)
    _busy_estimate("dense", traced, untraced)
    dense.run_until_done(reqs)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    _batch_witness(mc)


def _batch_witness(mc, device: str = "cuda"):
    """Does a request's greedy output depend on its batch? Phase 4c's
    weights (seed 0) and mix (seed 2) on phase 4's engine with the prefix
    cache off, so every run computes every page, dispatching captured
    programs under the shipped split rule: the whole mix at once, then
    each greedy request alone. Prints the greedy requests whose tokens in
    the mix differ from their tokens alone, with the first position that
    differs."""
    from ray_tpu_torch.llm import PagedEngineConfig, PagedInferenceEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.ragged_paged_attention import (SPLIT_KEYS,
                                                          SPLIT_MAX_Q)
    eng = PagedInferenceEngine(
        PagedEngineConfig(model=mc, page_size=16, num_pages=1024,
                          max_pages_per_seq=64, chunk_size=128,
                          prefill_rows=4, decode_window=8, max_batch_size=8,
                          enable_prefix_caching=False),
        params=llama.init(mc, seed=0, device=device), device=device)
    eng.warmup(sample_modes=((False, False, False), (True, True, True)))
    prompts, sps = _requests(mc.vocab_size, seed=2)
    greedy = [i for i, sp in enumerate(sps) if sp.temperature == 0]
    mixed = eng.generate(prompts, sps)
    alone = [eng.generate([prompts[i]], [sps[i]])[0] for i in greedy]
    differ = {}
    for i, one in zip(greedy, alone):
        a, b = mixed[i]["token_ids"], one["token_ids"]
        if a != b:
            differ[i] = next((k for k, (x, y) in enumerate(zip(a, b))
                              if x != y), min(len(a), len(b)))
    report = {"split_rule": f"{SPLIT_KEYS} keys a split at query widths "
                            f"<= {SPLIT_MAX_Q}, unsplit above",
              "captured_programs": len(eng._graphs),
              "greedy_requests": len(greedy), "differ": len(differ),
              "first_difference_at": differ}
    print("profile-serve batch witness: " + json.dumps(report), flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _busy_estimate(label: str, traced: dict, untraced: dict):
    """The profiler's own host cost inflates the traced wall, so the
    device's busy share in plain serving is estimated per decode step:
    device ms per step from the trace over host ms per step untraced
    (inside the dispatch plus the loop around it; one decode dispatch per
    engine step)."""
    dev = traced["decode_kernel_ms_per_step"]
    steps_per_dispatch = (untraced["decode_steps"]
                          / untraced["decode_dispatches"])
    host = (untraced["inside_ms_per_decode_step"]
            + untraced["outside_ms_per_step"] / steps_per_dispatch)
    out = {"decode_kernel_ms_per_step": dev,
           "untraced_host_ms_per_decode_step": host,
           "decode_busy_share_est": dev / host,
           "untraced_device_span_ms_per_decode_step":
               untraced["device_span_ms_per_decode_step"]}
    print(f"profile-serve {label} estimate: " + json.dumps(out), flush=True)
    return out


def main():
    t_smoke = time.perf_counter()
    card = probe()
    build_info = build()
    if "--profile-train" in sys.argv[1:]:
        profile_train()
        return 0
    if "--profile-serve" in sys.argv[1:]:
        profile_serve()
        return 0
    phases = {"probe_and_build": time.perf_counter() - t_smoke}
    t_mark = time.perf_counter()

    def mark(name):
        # seconds of each phase since the last mark, on the host clock
        nonlocal t_mark
        now = time.perf_counter()
        phases[name] = now - t_mark
        t_mark = now

    kernel_build = check_kernel_build(build_info)
    records = check_kernels()
    decode = check_paged_decode()
    flash = check_flash_kernels()
    if "--kernels" in sys.argv[1:]:
        return 0
    mark("kernels_2_3_3c_3b")
    from ray_tpu_torch.models import llama
    engine_8b = dict(page_size=16, num_pages=1024, max_pages_per_seq=64,
                     chunk_size=128, prefill_rows=4, decode_window=8,
                     max_batch_size=8)
    res = serve(llama.llama3_8b(), "cuda", **engine_8b)
    greedy = res.pop("greedy")          # phase 4h's reference tokens
    phase4 = res.pop("_keep")           # phase 4k's weights and outputs
    print("serve: " + json.dumps(res), flush=True)
    mark("4_serve")
    for name, n in res["launches_by_family"].items():
        if n <= 0:
            raise AssertionError(f"kernel never launched in {name}")
    # serve() and dense_serve() wrap an engine's own methods in closures
    # stored on it: a reference cycle, so only the collector frees it
    gc.collect()
    torch.cuda.empty_cache()
    tp2 = serve_tp(llama.llama3_8b(), phase4, **engine_8b)
    print("mesh: " + json.dumps({**tp2, "card": card}), flush=True)
    mark("4k_serve_tp")
    del phase4
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_serve(llama.llama3_8b(), "cuda", max_batch_size=8,
                        max_seq_len=1024)
    print("dense serve: " + json.dumps(dense), flush=True)
    mark("4b_dense_serve")
    if not set(dense["prefill_buckets"]) <= set(SERVE_BUCKETS):
        raise AssertionError(f"dense prefill shapes "
                             f"{sorted(dense['prefill_buckets'])} not all "
                             f"checked in phase 3b {SERVE_BUCKETS}")
    gc.collect()
    torch.cuda.empty_cache()
    served = llm_server(llama.llama3_8b(n_layers=CLUSTER_LAYERS), "cuda",
                        page_size=16, num_pages=1024, max_pages_per_seq=64,
                        chunk_size=128, prefill_rows=4, decode_window=8,
                        max_batch_size=8)
    served["depth"] = SERVER_DEPTH_CUT
    print("server: " + json.dumps(served), flush=True)
    mark("4c_server")
    gc.collect()
    torch.cuda.empty_cache()
    mc_4g = llama.llama3_8b(n_layers=CLUSTER_LAYERS)
    tenants = tenants_and_kv(mc_4g, "cuda", num_pages=256,
                             spill_pages=256, page_size=16,
                             max_pages_per_seq=64, chunk_size=128,
                             prefill_rows=4, decode_window=8,
                             max_batch_size=8)
    tenants["depth"] = TENANTS_DEPTH_CUT
    tenant_greedy = tenants.pop("tenant_greedy")   # phase 4j's reference
    print("tenants and kv: " + json.dumps(tenants), flush=True)
    mark("4d_tenants_and_kv")
    if tenants["launches"] <= 0:
        raise AssertionError("the ragged kernel never launched in 4d")
    gc.collect()
    torch.cuda.empty_cache()
    moe = serve(llama.llama3_8b(n_layers=MOE_LAYERS, **MOE_8X7B), "cuda",
                page_size=16, num_pages=1024, max_pages_per_seq=64,
                chunk_size=128, prefill_rows=4, decode_window=8,
                max_batch_size=8)
    moe["depth"] = MOE_DEPTH_CUT
    moe.pop("greedy")
    moe.pop("_keep")
    print("moe serve: " + json.dumps(moe), flush=True)
    mark("4e_moe_serve")
    for name, n in moe["launches_by_family"].items():
        if n <= 0:
            raise AssertionError(f"kernel never launched in 4e {name}")
    gc.collect()
    torch.cuda.empty_cache()
    # the reference tokens of 4f, 4g and 4i: one captured engine at their
    # depth
    t_ref = time.perf_counter()
    greedy_4g = _greedy_tokens(mc_4g, "cuda", **engine_8b)
    reference_s = time.perf_counter() - t_ref
    mark("reference_4f_4g_4i")
    gc.collect()
    torch.cuda.empty_cache()
    t4f = time.perf_counter()
    actor = runtime(mc_4g, greedy_4g, **engine_8b)
    actor["depth"] = RUNTIME_DEPTH_CUT
    actor["phase_s"] = time.perf_counter() - t4f
    actor["reference_s"] = reference_s
    print("runtime: " + json.dumps(actor), flush=True)
    mark("4f_runtime")
    gc.collect()
    torch.cuda.empty_cache()
    t4g = time.perf_counter()
    nodes = cluster(mc_4g, greedy_4g, **engine_8b)
    nodes["depth"] = CLUSTER_DEPTH_CUT
    nodes["phase_s"] = time.perf_counter() - t4g
    print("cluster: " + json.dumps(nodes), flush=True)
    mark("4g_cluster")
    gc.collect()
    torch.cuda.empty_cache()
    t4h = time.perf_counter()
    fronted = serve_cluster(llama.llama3_8b(), greedy, tenants=tenant_greedy,
                            lora_model_cfg=mc_4g, lora_greedy=greedy_4g,
                            **engine_8b)
    fronted["phase_s"] = time.perf_counter() - t4h
    lora_served = fronted.pop("lora")
    lora_served["depth"] = TENANTS_DEPTH_CUT
    print("serve_cluster: " + json.dumps(fronted), flush=True)
    print("serve_lora: " + json.dumps(lora_served), flush=True)
    mark("4h_serve_cluster_chaos_4j")
    gc.collect()
    torch.cuda.empty_cache()
    t4i = time.perf_counter()
    disagg = serve_pd(mc_4g, greedy_4g, **engine_8b)
    disagg["depth"] = PD_DEPTH_CUT
    disagg["phase_s"] = time.perf_counter() - t4i
    print("serve_pd: " + json.dumps(disagg), flush=True)
    mark("4i_serve_pd")
    gc.collect()
    torch.cuda.empty_cache()
    agreement(_small_model())
    agreement(_small_model(**MOE_SMALL))
    dense_f32 = dense_agreement()
    mark("5_5b_agreement")
    # phase 5's model has one KV head, which tp=2 cannot split
    agreement(_small_model(n_kv_heads=2), tp=2)
    agreement(_small_model(n_kv_heads=2, **MOE_SMALL), tp=2)
    mark("5k_agreement_tp")
    mc_train = llama.llama3_8b(n_layers=TRAIN_LAYERS)
    tr = train(mc_train, "cuda", batch=2, seq=4096)
    print("train: " + json.dumps(tr), flush=True)
    mark("6_train")
    gc.collect()
    torch.cuda.empty_cache()
    trained = trainer(mc_train, tr, batch=2, seq=4096,
                      then=lambda rt, storage: lora_tune(
                          mc_train, rt, storage, tr, **engine_8b))
    tuned = trained.pop("then")
    print("trainer: " + json.dumps(trained), flush=True)
    print("lora_tune: " + json.dumps(tuned), flush=True)
    mark("6b_trainer_6c_lora_tune")
    phases["6c_lora_tune"] = tuned["phase_s"]
    remat = dict(remat=True, remat_policy="save_attn")
    train_f32 = train_agreement(_small_model(**remat))
    train_f32_moe = train_agreement(_small_model(**remat, **MOE_SMALL))
    mark("7_train_agreement")
    head = next(r for r in records
                if r["family"] == "decode" and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "ray_tpu/ops/ragged_paged_attention.py:53",
        "launches": res["launches"],
        "launches_server": served["launches"],
        "launches_tenants_and_kv": tenants["launches"],
        "launches_moe_serve": moe["launches"],
        "launches_runtime_actor": actor["launches"],
        "launches_runtime_actor_by_family": actor["launches_by_family"],
        "launches_runtime_params_ref": actor["params_ref"]["launches"],
        "launches_cluster_actor": nodes["launches"],
        "launches_cluster_actor_by_family": nodes["launches_by_family"],
        "launches_cluster_params_ref": nodes["params_ref"]["launches"],
        # inside the compiled DAG's loop, per run of the mix (dag step)
        "launches_runtime_dag_by_family": {
            run: actor["dag"][run]["launches_by_family"]
            for run in ("whole", "split")},
        "launches_cluster_dag_by_family": {
            run: nodes["dag"][run]["launches_by_family"]
            for run in ("whole", "split")},
        # inside the Serve replica of phase 4h: both HTTP passes, the SSE
        # stream and the gRPC call
        "launches_serve_cluster": fronted["launches"],
        "launches_serve_cluster_by_family": fronted["launches_by_family"],
        # inside 4h's replacement replica after the chaos step's kill:
        # phase 4's greedy prompts once over HTTP
        "launches_serve_chaos_by_family":
            fronted["chaos"]["launches_by_family"],
        # inside phase 4j's LoRA replica: the tenant pass, the swap and
        # the unknown adapter
        "launches_serve_lora_by_family": lora_served["launches_by_family"],
        # inside phase 4i's prefill and decode replicas (both HTTP passes
        # over the KV ring and the SSE stream over the ref path)
        "launches_pd_prefill_by_family": disagg["launches_prefill_by_family"],
        "launches_pd_decode_by_family": disagg["launches_decode_by_family"],
        # phase 4k: tp=2 (two ranks on the card), phase 4's mix
        "launches_serve_tp": tp2["launches"],
        # phase 6c: the trained tenant and the base in one eager batch
        "launches_lora_serve": tuned["serve"]["launches"],
        "launches_lora_serve_by_family": tuned["serve"]["launches_by_family"],
        "launches_serve_tp_by_family": tp2["launches_by_family"],
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": "decode bf16 R=8 Q=1 H=32 KVH=8 D=128 page=16",
        # every family and dtype of phase 3, each held to its plain version
        "timed_families": [
            {k: r[k] for k in ("family", "dtype", "shape", "splits",
                               "max_abs_err", "ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by")} for r in records],
    }]
    # the D 128 pass-1 builds: bf16 by warps (1: decode; 2: verify; 4:
    # prefill), and f32
    keys = ("registers", "spill_stores", "smem_bytes", "HMMA", "LDGSTS")
    kernels[0]["builds"] = {
        nw: {k: kernel_build[f"rpa_kernel_mma bfloat16 D128 NW{nw}"].get(k)
             for k in keys} for nw in (1, 2, 4)}
    kernels[0]["builds"]["f32"] = {
        k: kernel_build["rpa_kernel_f32 float32 D128"].get(k) for k in keys}
    b2 = next(r for r in decode["records"]
              if r["case"] == "main" and r["dtype"] == "bfloat16")
    b2_built = kernel_build["pda_kernel bfloat16 D128"]
    kernels.append({
        "name": PAGED_DECODE[0], "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": PAGED_DECODE[1], "launches": decode["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in decode["records"]),
        "ms": b2["ms"], "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
        "library_ms": b2["library_ms"],
        "timed_at": "decode bf16 B=9 (lengths 0-1000) H=32 KVH=8 D=128 "
                    "page=16",
        # every case and dtype of phase 3c, each held to its plain version
        "timed_cases": [
            {k: r[k] for k in ("case", "dtype", "shape", "splits",
                               "max_abs_err", "ms",
                               "plain_ms", "ragged_ms", "ragged_kernel_ms",
                               "library_ms", "read_ms", "bound_ms",
                               "bound_by")}
            for r in decode["records"]],
        **{k: b2_built.get(k) for k in ("registers", "spill_stores",
                                         "smem_bytes", "LDGSTS")},
    })
    main_case = flash["timed"]["bfloat16"]
    for name, replaces in FLASH_KERNELS:
        t = main_case[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces, "launches": tr["launches"][name],
            "launches_dense_serve": dense["launches"][name],
            # inside phase 6b's TorchTrainer worker, both attempts
            "launches_trainer": trained["launches"][name],
            # phase 6c: 20 LoRA steps in the driver, the same 20 inside
            # the gang's worker, 6 steps inside each of the two trials
            "launches_lora_local": tuned["local"]["launches"][name],
            "launches_lora_worker": tuned["worker"]["launches"][name],
            "launches_lora_trials": tuned["tune"]["launches"][name],
            "max_abs_err": flash["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "timed_at": "causal bf16 B=2 S=4096 H=32 KVH=8 D=128",
        })
        # the bf16 D 128 build of the kernel that was timed
        built = kernel_build[f"{name}_kernel_mma bfloat16 D128"]
        kernels[-1].update({k: built.get(k) for k in (
            "registers", "spill_stores", "smem_bytes", "HMMA", "LDGSTS")})
        # the f32 kernel at the same shape (phase 7 trains through it) and
        # its D 128 build
        built = kernel_build[f"{F32_KERNEL[name]} float32 D128"]
        kernels[-1]["timed_f32"] = {
            **flash["timed"]["float32"][name],
            "launches_train_agreement": train_f32[name],
            "launches_train_agreement_moe": train_f32_moe[name],
            "launches_dense_agreement": dense_f32[name],
            **{k: built.get(k) for k in ("registers", "spill_stores",
                                         "smem_bytes", "LDGSTS", "FFMA",
                                         "LDS.128")}}
        if name == "flash_fwd":
            # the dense engine's prefill shapes, each held against the
            # plain version in phase 3b
            kernels[-1]["timed_dense_serve"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")}
                for r in flash["serve"]]
    print("phases: " + json.dumps(phases), flush=True)
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
