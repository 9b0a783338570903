#!/usr/bin/env python3
"""Drive the PyTorch port (``sparkflow_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Imports no JAX.
Phases — any failure exits nonzero with its traceback and prints no result:

1. set-up: the card's name and power limit; build the CUDA kernels from
   ``sparkflow_tpu_torch/ops/csrc`` and print ptxas's registers, shared
   memory and spills (a spill in a tensor-core — bf16 or 3xTF32 —,
   split-verify or cluster decode instantiation fails the phase);
2. kernels against their plain PyTorch versions at the serving path's
   shapes, in bfloat16 and float32 (``flash_fwd`` on the tensor cores in
   both: bf16, and 3xTF32 for float32), and their times beside the plain
   version's, the least time the card could take (``bound_ms``; for
   float32 work at the 3xTF32 tensor-core rate, 495 / 3 TFLOP/s, with the
   CUDA cores' 67 TFLOP/s bound beside it as ``bound_cuda_core_ms``) and, for
   flash, ``F.scaled_dot_product_attention`` as a yardstick only, with the
   achieved TFLOP/s and share of the bound (``bound_ms / ms``). ``ms``,
   ``plain_ms`` and ``library_ms`` are device times (CUDA-graph replays
   between CUDA events); ``call_ms`` in the detail line is the time per
   call as the host enqueues it one at a time. ``paged_attention`` runs at
   the decode step's operands and at one 1024-token slot (B=1), each with
   its empty slots exact zeros, a second launch bit-identical and, beside
   it, the yardstick ``verify_s1_ms``: ``paged_attention_verify`` at S=1
   with start = lengths - 1 over the same non-empty slots;
3. serving: a GPT-2-small-width ``transformer_lm`` (random weights from a
   seed, bf16 compute) behind ``DecodeEngine`` -> ``ContinuousBatcher`` ->
   ``InferenceServer``, eight concurrent ``ServingClient.generate`` calls;
   the kernels' launch counters are zeroed just before and read just after;
4. profile: ``torch.profiler`` over 20 decode steps with 8 live slots and
   over one 700-token prefill — device busy time, idle share, top kernels;
5. exactness: float32 with TF32 off, all 12 layers — the engine's greedy
   tokens equal the argmax of the dense full-sequence forward over the plain
   attention, and prefill logits agree within 1e-3;
6. backward kernels, on operands laid out as the training step lays them
   out (strided q/k/v views of one qkv permutation, a transposed dO): the
   forward's output and logsumexp against ``attention_reference``, then
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` against their plain versions, at
   the training shape (B=8, H=12, S=1024, D=64, causal), at S=128, at a
   ragged S=700 and on a non-causal key-padded batch, in bfloat16 and
   float32 (the float32 forward and backward run the 3xTF32 tensor-core
   kernels), with the same timings as phase 2 (the forward's too, at the
   training shape, with its TFLOP/s and share of the bound); ``library_ms``
   for the backward is that of
   ``F.scaled_dot_product_attention`` at the same shape (all three
   gradients in one call), timed by itself by CUDA-graph replay; each
   backward row also gives its achieved TFLOP/s and its share of the bound
   (``bound_ms / ms``), and in every case a second launch of each kernel
   must give the same bits (no atomics);
7. training: ``Trainer.fit`` on the GPT-2-small-width ``transformer_lm``
   (dropout 0.1, bf16 compute, adam, lr 3e-4) over 64 rows x 1024 tokens
   of a 1,000-id sub-vocabulary, batch 8: 8 epochs of one step each, each
   timed on the host clock at its ``loss_callback`` (after the trainer's
   host read of the loss); the launch counters and the peak-memory mark are
   reset just before and read just after (12 x steps for each attention
   kernel); the losses must be finite and fall; then one more step under
   ``torch.profiler``, with each attention kernel's calls and device time
   summed over every profiled event;
8. training exactness: float32, TF32 off, full width cut to 2 layers — one
   step's loss and gradients through the kernels (the backward in 3xTF32)
   equal those through the plain attention, and 3 adam steps' losses agree
   within 1e-4 relative;
9. the quantized and verify kernels against their plain versions at the
   decode step's shapes (verify: S = spec_k + 1 = 5 queries per slot,
   ragged starts incl. 0): ``paged_attention`` over int8 and fp8 pools with
   a page-head of scale 0 and a page rescaled mid-fill (as in phase 2: with
   bf16 queries also at one 1024-token slot, each beside the S=1 verify
   yardstick), and
   ``paged_attention_verify`` over the bf16/f32 pool and both quantized
   ones, bf16 and f32 queries, timed as in phase 2; verify also at one
   1024-token slot (start 1019), the longest walk; in every case a second
   launch must give the same bits;
10. speculative serving: the GPT-2-small-width engine with ``spec_k=4``
    (self-speculation through 6 of 12 layers) serves one burst as in
    phase 3 with (a) the bf16 pool and (b) ``kv_quant="int8"``; the
    counters are zeroed before each burst and read after: every step is
    speculative, the verify kernel launches 12 times and the draft's paged
    kernel 4 x 6 times a step, and the other pool layout's kernels never;
    then 5 spec steps with 8 live slots under ``torch.profiler``;
11. speculative exactness: float32, TF32 off, 12 layers — greedy tokens with
    ``spec_k=4`` (self-draft, and an external 6-layer draft) equal the
    spec-off engine's; with an int8 pool the card's tokens equal the same
    engine's on the CPU; ``kv_quant_error`` of int8 below 0.05;
12. estimator: the Spark ML surface on the card with no device asked for.
    (a) The reference suite's ``nn`` model on its overlapping Gaussians
    through ``SparkAsyncDL`` in a ``Pipeline``: fewer than 400 errors in
    400 rows (the reference's bar), and the pipeline saved and loaded
    predicts the same. (b) ``examples/bert_classifier.py`` at full width:
    BERT-base ``transformer_classifier`` in float32 (the estimator sets no
    compute dtype), ``Pipeline([OneHotEncoder, SparkAsyncDL])`` over 256
    rows x 512 tokens with a mask column, batch 32, 1 epoch (8 steps),
    weights in an npz side file; fit, then transform; the fit's wall
    time, training examples/s over the steps after the first (CUDA events
    after each step), transform examples/s, peak memory, the per-epoch
    losses (finite) and the kernels' launches, 12 a step for each of the
    three flash kernels in the fit and 12 a partition of ``flash_fwd`` in
    the transform, zeroed just before and read just after each; then one
    more training step under ``torch.profiler``. (c) The transform's probs
    and logits for 8 rows against a forward of the same weights through
    ``attention_reference``, float32, TF32 off; kernels 1-3 (all three on
    the tensor cores in 3xTF32) against their plain versions at the fit's
    shape (float32, B=32, H=12, S=512, D=64, non-causal, the first batch's
    masks), timed beside their bounds (the 3xTF32 one and the CUDA cores')
    and SDPA's forward and backward. The
    fit's training examples/s and the profiled step's device busy ms are
    the numbers a parent / change comparison reads;
13. predict: README's "Serve it online" path on phase 12's fitted weights —
    ``InferenceEngine(modelJson, modelWeights, input_name=["input_ids:0",
    "attention_mask:0"], output_name="probs:0", max_batch=32)`` behind
    ``InferenceServer(max_delay_ms=2.0)`` in four arms: (a) float32, (b)
    ``compute_dtype="bfloat16"``, (c) ``quantize="weight_only"``, (d)
    ``quantize="dynamic"``. Each serves 8 concurrent
    ``ServingClient.predict`` threads x 8 requests of 1-8 rows (sizes from
    a seed, masks ragged over 256-512 live tokens); the counters are zeroed
    before each burst and read after: ``flash_fwd`` 12 times a bucket call,
    nothing else. It prints rows/s, request p50/p95 ms, batch rows and
    padding waste from ``/metrics``, the ms of buckets 1, 8 and 32 (CUDA
    events around one eager call), a profile of a 32-row call, ``stats()``
    and peak memory. Each arm's every served answer against the card
    engine's own predict of the burst's rows outside the server, a seeded
    16-row sample of them against the same arm on the CPU port engine
    (probs, and logits over max(1, max |logit|); the int8 trees built on
    the card bit-equal to the CPU's), arm (a) against a forward through
    ``attention_reference`` (TF32 off, 1e-4). Then a port ``Trainer(publish_to=store)`` takes 2 steps on the
    same model, ``WeightWatcher.poll_once()`` moves arm (a) to version 1,
    and its probs equal a fresh engine's built from ``store.load()``;
    ``flash_fwd`` at the largest bucket in bf16 (B=32 S=512, a key mask)
    against its plain version, beside its bound and SDPA's time.

14. resilience and stream: README's text pipeline at BERT-base width
    (phase 12's configuration, float32, TF32 off). (a) 256 long synthetic
    reviews (200-700 words, ``examples/text_classifier.py``'s shape),
    ``build_vocab`` over them, the native WordPiece ids and masks at 512
    tokens against the pure-Python fallback's on 32 rows (the native
    library must have loaded), encode rows/s. (b) ``Pipeline([
    WordpieceEncoder, OneHotEncoder, SparkAsyncDL(fitMode="stream",
    checkpointDir, checkpointEvery=4)])`` over them, batch 32, 8 steps:
    the counters zeroed before and read after (12 a step for each flash
    kernel), finite losses, training examples/s with and without the
    saves, the step-4 and step-8 checkpoints verified by their manifests,
    each save's host ms and bytes; then the transform's accuracy. (c)
    ``Trainer.fit`` over the encoded rows, 2 epochs of 8 steps,
    ``checkpoint_every=1``: uninterrupted; preempted by SIGTERM in epoch 1
    and fitted again; crashed in epoch 2 and resumed in the fit
    (``resume_retries=1``) — both land on the uninterrupted fit's weights
    bit for bit (else their relative delta is printed and held to 1e-6).
    (d) The uninterrupted fit runs with ``trace_spans``: phase totals within
    10 % of its wall time, the save's share, MFU against
    ``device_peak_flops()`` (the bf16 peak, the JAX convention, though the
    step runs float32), the Chrome trace parsed. (e) One forward and
    backward of phase 7's GPT-2-small-width bf16 model at 8 x 1024 in
    ``remat`` False, "dots" and "full": peak memory above the step's start
    (full < dots < False), step ms, a profiled step's device busy ms and
    idle share, ``flash_fwd`` launches (12, 24, 24),
    "dots" and "full" loss and gradients against False's within the bf16
    backward tolerance.

15. fleet: README's "Serve from a fleet" path. Replicas are subprocesses
    (this script re-invoked with ``--replica KIND PORT``) running the port's
    ``InferenceServer`` on the card, each with a fresh empty kernel build
    directory, no ``nvcc`` on ``PATH`` or under ``CUDA_HOME``, and
    ``executable_dir`` set to an ``ExecutableStore`` this process filled
    with the library it built at setup; each prints its boot tier (1 = the
    store; tier 3 fails) and its boot-to-healthy and boot-to-first-answer
    seconds, beside this process's own build time. (a) Phase 12's BERT-base
    on phase 13's published weights (float32, ``max_batch=32``) behind
    ``RouterServer`` over an ``Autoscaler`` + ``ReplicaManager`` (min 1, max
    3): 12 closed-loop clients of 1-8 rows (phase 13's traffic, drawn
    from a 128-row pool) grow the fleet to 2 or more, one replica is
    SIGKILLed mid-burst and replaced, a trickle drains it back to 1; the
    clients retry nothing, and every answer equals the parent engine's
    probs of its rows, as one bucket of its ladder computes them, within
    phase 13's float32 replay limit. (b) One more replica boots from this
    process's build directory (``compile_cache_dir``, tier 2). (c) ``RouterServer(canary=True)`` over a pinned replica and one
    whose ``WeightWatcher`` follows the store: a version scaled by 1 + 1e-3
    is promoted; a version with one NaN leaf is quarantined and rolled back
    (the gate forwards the NaN answer that closes it, as the JAX router
    does; at most one), with no other failure. (d) Two GPT-2-small decode
    replicas (bf16, 8 slots, page 16) behind ``/v1/generate``: 8 greedy
    prompts of 64-700 tokens, 32 new tokens each, token-identical to this
    process's own ``DecodeEngine``; dispatch split, TTFT p50/p95. Drained
    replicas report their launches (12 ``flash_fwd`` a bucket call or
    prefill, 12 ``paged_attention`` a decode step, nothing else). (e) A
    seeded trace replayed through the router after (a), then through
    ``FleetSimulator`` with ``CostModel.fit_predict`` over the real
    latencies: the sim-over-real p95 ratio, a reading only. The replicas
    share the card's SMs: the phase measures routing, recovery, canary and
    boot time, not scale-out throughput.

16. families: the registry families that the port added last. (a) The
    MoE LM (``transformer_moe_lm``) at Switch-Base-8's widths (768 / 12
    layers / 12 heads / 3072, 8 experts on every second layer, top-1,
    capacity factor 1.25, vocab 32128, max_len 512; random weights from a
    seed, bf16) behind ``DecodeEngine(num_slots=8, page_size=16)`` ->
    ``ContinuousBatcher`` -> ``InferenceServer``: 8 concurrent
    ``ServingClient.generate`` calls of 64-400-token prompts, 32 new tokens
    each, the counters zeroed before and read after (``flash_fwd`` and
    ``paged_attention`` must launch); TTFT p50/p95, tokens/s, step ms, and
    10 decode steps with 8 live slots under ``torch.profiler``. (b)
    Float32, TF32 off, 4 layers: the engine's decode-step logits against
    ``decode_step`` over the dense cache filled from the engine's pool,
    fed the engine's tokens and positions (the same slots and idle lanes,
    so capacity sees the same batch), within 1e-3; router near-ties
    (top-1 minus top-2 under 1e-4) counted; a bf16 replay of the last step
    must miss 1e-3. (c) ``Trainer.fit``: 8 steps of 8 x 512, bf16, dropout
    0.1, adam 3e-4 (12 launches a step of each flash kernel), step ms,
    tokens/s, peak memory and MFU with the trainer's MoE FLOP count; one
    float32 step at 2 layers through the kernels against the plain
    attention (loss 1e-5 relative, gradients 1e-4 of max |plain|). (d)
    ``examples/resnet_cifar.py``'s path: ``resnet`` depth 50, width 64,
    image 32, float32, through ``Pipeline([OneHotEncoder, SparkAsyncDL])``
    (batch 64, 2 epochs of 256 rows), examples/s; ``resnet50`` at 224 (the
    ImageNet stem and max-pool) on 8 images, card float32 logits against
    the CPU's within 1e-4. (e) ``rnn_lm`` at Zaremba et al.'s medium PTB
    widths (2 x 650 LSTM, vocab 10000, 35 steps, batch 20, dropout 0.5,
    SGD lr 1, tied embeddings): 8 ``Trainer`` steps in float32 and in
    bf16, the float32 loss on the card against the CPU's within 1e-5
    relative, one profiled step; the bi-GRU ``rnn_classifier`` (512, 2
    layers, max_len 128) through ``SparkAsyncDL`` fit and transform.

17. tf1-hogwild: the reference's own path. (a) Its three example graphs
    as TF1 MetaGraphDef JSON (``tests/fixtures/torch_tf1/``: the MNIST MLP
    784-256-256-10, the MNIST CNN conv 32x5 / pool / conv 64x3 / pool /
    dense 10, the autoencoder 784-256-128-256-784; published widths),
    trained through ``SparkAsyncDL(tensorflowGraph=<fixture>)`` at the
    examples' batch sizes (300, 300, 256) for 8 steps each on synthetic
    MNIST-shaped rows, float32 with TF32 off, on the card and on the CPU
    from the same weights and shuffles: the first loss, the fit's losses
    and 64 rows' predictions within 1e-5 (relative), and a
    ``load_checkpoint_model`` round trip through an npz predicting the
    same; examples/s, step ms (CUDA events between steps), and one
    profiled step's device ops, busy ms and idle share. (b)
    ``HogwildSparkModel(tensorflowGraph=<BERT-base spec>, mini_batch=8,
    iters=4).train(rdd)`` over a 4-partition localml RDD of 32 rows x 512
    tokens (float32, dropout 0.1): 4 replica threads, 4 pushes each; the
    flash kernels' counters zeroed before and read after (12 a gradient,
    warm-up included); accepted / rejected-stale / dropped pushes, the
    staleness histogram, final version and peak memory of that first
    train; then, warm, its examples/s with the median host ms of a
    gradient and of a push (the wait for the store's lock included),
    one replica's over the same rows, the sync ``Trainer``'s on them
    (recorded, not gated), and a train under ``torch.profiler`` for the
    idle share. At 2 layers (dropout 0): one
    replica through ``strategy="elastic_dp"`` equals the sync ``Trainer``'s
    SGD for 4 steps (losses and weights within 1e-5 relative), and
    ``run_virtual`` with a 10x straggler on the card gives the CPU's
    accounting exactly.

18. mesh: synchronous mesh training, each rank a process on the card (2
    ranks on one card: gloo, every collective staged through pinned host
    memory; the backend is printed). (a) ``ring_flash_attention`` against
    the plain ring on the card and against one rank's ``flash_attention``
    over the whole sequence, output and dq / dk / dv, at the training shape
    (B=8, H=12, S=1024, 512 a rank, D=64) in bf16 and float32, causal, and
    non-causal with a key-padding mask, in phases 2 and 6's tolerances; a
    causal ring launches kernels 1-3 3 times each summed over the ranks (4
    without causality), the ring's fwd+bwd ms. (b) ``examples/
    bert_classifier.py``'s BERT-base through ``Pipeline([OneHotEncoder,
    SparkAsyncDL(meshShape="dp=2")])``, batch 32 x 512 (16 rows a rank,
    ragged 256-512 live tokens), 4 steps at ``zeroStage`` auto (adam -> 1)
    and at 3, in place on the shared pool's two ranks (as under torchrun):
    training examples/s and step ms (CUDA events on rank 0),
    each rank's peak memory, optimizer-state and parameter bytes, bytes
    moved a step and staged through the host, launches of kernels 1-3 per
    rank (12 a step); one step profiled on rank 0 (busy, idle); the fitted
    model's transform against the rank-0 params' single-card forward
    (1e-5). (c) GPT-2 small (bf16, dropout 0.1, adam 3e-4) through
    ``Trainer(mesh={"dp": 1, "sp": 2})`` in place on the pool's two ranks,
    batch 8 x 1024, 3 steps: tokens/s,
    36 launches a step of each kernel summed over the ranks, losses finite
    and falling. (d) Float32, TF32 off, full widths cut to 2 layers: dp=2
    at zero stages 0-3 against one card's ``Trainer`` on the same rows
    (losses 1e-5 relative, params atol 5e-5 / rtol 1e-5), and the sp=2
    step through the kernel ring against the plain ring's (1e-4). The
    rank processes load the library phase 1 built; every collective and
    every wait for a rank has a 240 s limit. Phases 18 and 19 run their
    in-place rank work in one pool of 2 ranks.

19. stream-mesh: the data-parallel remainder, BERT-base (768 / 12 / 12 /
    3072, vocab 30522, max_len 512), float32, adam 3e-4, on two ranks of
    the card. (a) ``Pipeline([OneHotEncoder, SparkAsyncDL(fitMode="stream",
    meshShape="dp=2", zeroStage=1, checkpointDir=...)])`` over 96 rows,
    batch 32 x 512 (16 rows a rank), 3 steps: the stream read in this
    process, each rank sent its rows; launches of kernels 1-3 summed over
    the ranks (12 a step a rank), each rank's bytes moved, training
    examples/s beside phase 18 (b)'s collect fit, and one step of an
    in-place dp=2 stream fit profiled on rank 0 (busy, idle). (b) Full
    widths cut to 2 layers, dropout 0, TF32 off: the dp=2 stream fit at
    ZeRO 0-3 against one card's stream fit (losses 1e-6 relative, params
    as phase 18 (d)); ``offload_opt_state`` at ZeRO 2 against the same fit
    without it, both saving a checkpoint after each step (losses, each
    rank's final optimizer state and every saved optimizer leaf
    bit-equal); a launched ``fit`` whose callback raises
    at epoch 2 (``faults.crash_at``), resumed in the fit, and one whose
    callback kills a rank at epoch 2 (SIGKILL), relaunched from its
    checkpoint, each against the uninterrupted fit (params bit-equal). (c)
    The fitted model's ``transform`` with ``meshShape="dp=2"`` and
    ``InferenceEngine(mesh={"dp": 2})`` at bucket 32 x 512, each against the
    engine without a mesh (1e-5), rows/s, and ``flash_fwd``'s launches a
    bucket call (12 a copy).

20. tp-fsdp: tensor parallelism and fsdp (ROADMAP 7d). Two ranks share
    the card over gloo and one-process serving puts both tp shards on it:
    the phase shows the mesh layer and kernels 1-7 at a shard's head count,
    not scaling. Kernels 1-7 against their plain versions at 6 heads (bf16;
    flash at B=8 S=1024 causal, paged at the decode step's operands, bf16
    and int8, verify at S=5), a second launch bit-identical. (a) GPT-2
    small (bf16, dropout 0.1, adam 3e-4) through ``Trainer(mesh={"dp": 1,
    "tp": 2})`` in place on two ranks (as under torchrun), batch 8 x 1024,
    3 steps: step ms on each rank (CUDA
    events), tokens/s, bytes moved a step and param bytes a rank (against
    one card's), peak memory, launches of kernels 1-3 a rank (12 a step).
    (b) BERT-base's widths cut to 2 layers (float32) through
    ``Pipeline([OneHotEncoder, SparkAsyncDL(meshShape=...)])`` over 64 rows
    x 512, batch 32, 2 steps each: "tp=2" (a random batch an epoch) and
    "fsdp=2" with ``fitMode="stream"``, each launching its own ranks, and
    "fsdp=2" (a random batch an epoch) in place on the shared pool's two
    ranks: per-rank launches of kernels 1-3, examples/s against one card's
    ``Trainer`` on the same rows in the same run, param bytes a rank at
    rest. (c) GPT-2 small ``DecodeEngine(mesh={"tp": 2}, num_slots=8,
    page_size=16)``, 8 prompts x 32 new tokens, plain, ``spec_k=4`` and
    int8 with ``spec_k=4``: in float32 (TF32 off) the greedy tokens equal
    the engine's without a mesh, with pool bytes a shard (half) and kernels
    4-7's launches a shard; in bf16, the plain arm, step ms p50. (d)
    BERT-base
    ``InferenceEngine(mesh={"tp": 2})``, float32, bucket 32: max |d| from
    the engine without a mesh (1e-4), rows/s of each. (e) Full widths cut
    to 2 layers, float32, TF32 off: tp=2 and fsdp=2 against one card (one
    SGD step: loss 1e-5 relative, params rtol 3e-4 / atol 3e-5; 3 adam
    steps: losses 2e-4), a tp=2 fit with dropout 0.1 whose replicated
    leaves are bit-equal across the ranks and whose checkpoint, resumed on
    one card, is bit-equal to it. ``python3 chip_smoke.py --phase tp-fsdp``
    runs set-up and this phase alone.

21. pp: pipeline parallelism (ROADMAP 7e). Two ranks share the card over
    gloo and one-process serving puts both stages on it: the phase shows
    the schedules, the stage-to-stage hops and the kernels on each stage's
    layers, not scaling. (a) GPT-2 small (bf16, dropout 0.1, adam 3e-4)
    through ``Trainer(mesh={"dp": 1, "pp": 2})`` in place on two ranks,
    batch 8 x 1024 (8 microbatches), 3 steps under each of ``gpipe``,
    ``1f1b`` and ``sequential``: step ms on each rank (CUDA events),
    tokens/s, bytes moved a step a rank (the hops, the shared gradients'
    all-reduce), param bytes a rank against one card's, peak memory,
    ``schedule_ticks`` and launches of kernels 1-3 a rank, held to the
    schedule's count. (b) BERT-base (float32) through ``Pipeline(
    [OneHotEncoder, SparkAsyncDL(meshShape="pp=2", ppSchedule="1f1b",
    ppMicrobatches=4)])`` at BERT-base's widths cut to 2 layers, launching
    its own ranks, over 64 rows x 512 (tokens only), batch 32, 2 steps:
    per-rank launches of kernels 1-3 held to the schedule's count, examples/s against one card's ``Trainer``, param bytes a rank at
    rest, the fitted model's transform without a mesh. (c) GPT-2 small
    ``DecodeEngine(mesh={"pp": 2}, num_slots=8, page_size=16)``, 8 prompts x
    32 new tokens, arms ``pp_wave``, ``pp_wave=False``, ``spec_k=4``
    (``draft_layers=6``, one stage), int8 with ``spec_k=4`` and ``mesh={"pp":
    2, "tp": 2}``: in float32 (TF32 off) the greedy tokens equal the engine's
    without a mesh in every arm, with the pool bytes a stage (half) and
    kernels 1 and 4-7's launches a stage; in bf16, the arms without
    speculation, step ms p50, tokens/s against the engine without a mesh,
    wave ticks. (d) GPT-2 small's widths cut to 2 layers,
    float32, TF32 off: pp=2 under each schedule against one card (one SGD
    step: loss 1e-5 relative, params rtol 3e-4 / atol 3e-5; 3 adam steps:
    losses 2e-4), and a pp=2 checkpoint resumed on one card bit-equal to the
    fit. ``python3 chip_smoke.py --phase pp`` runs set-up and this phase
    alone.

22. ep: expert parallelism (ROADMAP 7f) and the vmapped sweep. Two ranks
    share the card over gloo and one-process serving puts every expert
    (and tp) shard on it: the phase shows the split banks, the exchanges
    and the kernels on each rank, not scaling. The model is phase 16's MoE
    LM at Switch-Base-8 widths. (a) ``Trainer(mesh={"dp": 1, "ep": 2})``
    in place on two ranks (4 of each bank's 8 experts a rank), bf16, adam
    3e-4, batch 8 x 512, 4 steps: step ms (CUDA events), tokens/s, param
    bytes a rank against one card's, bytes moved and staged through the
    host a step a rank, launches of kernels 1-3 a rank (12 a step). (b) The
    all_to_all step (``make_moe_shardmap_train_step``, the model built with
    ``ep_axis="ep"``), 4 rows x 512 a rank, 4 steps: the same figures, the
    ``all_to_all`` bytes a step, and the fraction of routed choices each
    MoE layer dropped. (c) Float32, TF32 off, full widths cut to 2 layers:
    (a)'s fit and (b)'s step against one card (3 adam steps; losses 1e-5
    relative, params as phase 18 (d)); (b)'s at capacity
    factor 8 on both sides, where neither form drops a token. (d)
    ``DecodeEngine(num_slots=8, page_size=16)`` with ``{"ep": 2}`` and
    ``{"tp": 2, "ep": 2}``, phase 16's 8 prompts x 32 new tokens, plain,
    ``spec_k=4`` and int8 with ``spec_k=4``: in float32 (TF32 off) the
    greedy tokens equal the engine's without a mesh in every arm (at 4
    layers, the draft through 2), that engine's model running one product
    per expert as split banks do (``per_expert_products``), with kernels 1
    and 4-7's launches and the sequences its batched expert products change
    (counted); in bf16 at full depth, the plain arm, the sequences that
    differ from the engine without a mesh (batched products; counted), step
    ms and tokens/s against it, and its burst through
    ``/v1/generate`` (tokens/s against the engine without a mesh's,
    ``/healthz``'s ep). (e) ``InferenceEngine(mesh={"ep": 2})`` on the MoE
    LM's float32 logits, 4 x 512: max |d| from the engine without a mesh,
    on one product per expert (1e-5) and on its batched products (1e-4).
    (f) ``hyperparameter_search`` with K = 4 learning rates at
    BERT-base widths cut to 4 layers, float32, TF32 off, 16 x 512, batch 8,
    4 steps: the curves equal 4 separate one-rate sweeps (1e-5 relative),
    kernels 1-3 launched once a layer and step for all four replicas, and
    the sweep's time against the separate ones'. ``python3 chip_smoke.py
    --phase ep`` runs set-up and this phase alone.

Run order: 1, 2, 9, 6, then two processes side by side: this one runs 3,
4, 10, 5, 11, 7, 8, 12, 13, 14, 15, 16, 17, 22, and a second one
(``--mesh-group``, started once the kernels' times are taken) runs 18, 19,
20, 21 on one 2-rank pool, its lines relayed here. Both are host-bound
(the card idles most of their time), so together they take about the
longer one's time; a phase's throughput in this run is taken with the
other process sharing the card and the host, and ``--phase NAME`` gives
it alone. A ``[time]`` line gives each phase's wall time. The line before
the last gives the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, printing no result, where there is no CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). A
# float32-accurate product is fastest as three TF32 tensor-core products
# (3xTF32): 495 / 3 TFLOP/s, above the CUDA cores' 67, which float32 rows
# also print as ``bound_cuda_core_ms`` (the rule of earlier float32 rows).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
CUDA_CORE_FLOPS = 67e12

FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# backward kernels: |kernel - plain| <= tol x max |plain|, per gradient
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_STEPS = 8
SPEC_K = 4
PAGED_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}

GPT2_SMALL = dict(vocab_size=50257, hidden=768, num_layers=12, num_heads=12,
                  mlp_dim=3072, max_len=1024, dropout=0.0)


_LOG_LOCK = threading.Lock()


def log(*a):
    # whole lines: the second process's lines are relayed by a thread
    with _LOG_LOCK:
        print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def time_device(fns, replays: int = 7) -> float:
    """The card's milliseconds per call: ``fns`` are called once each to
    warm up, captured in order into one CUDA graph, and the graph is
    replayed between CUDA events. Nothing is enqueued by the host inside
    the timed interval, so launch overhead is out; the median replay over
    ``len(fns)``."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a, b = _events()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return sorted(times)[len(times) // 2] / len(fns)


def time_calls(fn, reps: int = 20) -> float:
    """Milliseconds per call as the serving path pays it, one call at a
    time: CUDA events around each call, so the host's time to enqueue it
    (the wrapper's Python, the ctypes call) counts where it exceeds the
    card's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def time_sdpa_backward(q, k, v, dout, mask, causal: bool,
                       calls: int = 10, replays: int = 7) -> float:
    """The card's ms per call of ``F.scaled_dot_product_attention``'s
    backward (dQ, dK and dV in one call). Autograd runs a backward on its
    forward's stream, so the forward runs once on a side stream and the
    backward calls are captured from that stream into a CUDA graph (as
    ``torch.cuda.make_graphed_callables`` does), then replayed between CUDA
    events like ``time_device``."""
    import torch
    import torch.nn.functional as F
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask,
                                             is_causal=causal)

        def backward():
            torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)

        for _ in range(2):
            backward()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            backward()
    graph.replay()
    times = []
    for _ in range(replays):
        a, b = _events()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return sorted(times)[len(times) // 2] / calls


def _bound(nbytes: float, flops: float, dtype_name: str,
           peak: float = None):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / (peak or PEAK_FLOPS[dtype_name]) * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _rate(row, dtype_name: str) -> None:
    """Add ``bound_ms`` / ``bound_by`` from the row's bytes and flops, the
    achieved TFLOP/s and the share of the bound (``bound_ms / ms``); a
    float32 row also its bound at the CUDA cores' peak."""
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"],
                                              dtype_name)
    if dtype_name == "float32":
        row["bound_cuda_core_ms"] = _bound(row["bytes"], row["flops"],
                                           dtype_name, CUDA_CORE_FLOPS)[0]
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]


def _cuda_core_note(row) -> str:
    """``"; CUDA cores <ms>"`` for a row that has that bound, else ``""``."""
    if "bound_cuda_core_ms" not in row:
        return ""
    return f"; CUDA cores {row['bound_cuda_core_ms']:.5f}"


def _entry_name(line: str):
    """``name<args>`` of the kernel whose ptxas report ``line`` starts
    (``Compiling entry function '<mangled>'``), else None. The mangled name
    holds ``<length><name>I<args>EE``; the anonymous namespace's own mangled
    name holds digits too, so the length prefix is what finds the name, e.g.
    ``..._cu_ddd79eae24flash_bwd_dq_tf32_kernelILi64EE`` ->
    ``flash_bwd_dq_tf32_kernel<Li64>``."""
    if "entry function" not in line:
        return None
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel)I(\w+?)EE)", line):
        if int(m.group(1)) == len(m.group(2)):
            return f"{m.group(2)}<{m.group(3)}>"
    return None


def phase_setup():
    from sparkflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"[setup] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled, name = [], None
    for src, lines in _build.ptxas_report().items():
        log(f"[setup] ptxas {src}:")
        for ln in lines:
            entry = _entry_name(ln)
            if entry:
                name = entry
                log(f"  {name}")
            elif "registers" in ln or "spill" in ln:
                log("   ", ln.split(":", 1)[-1].strip())
                if re.search(r"[1-9]\d* bytes spill", ln):
                    spilled.append(name)
    log(f"[setup] instantiations that spill: {spilled or 'none'}")
    # the tensor-core (bf16 and 3xTF32), the split verify and the cluster
    # decode kernels are held to no spill
    held = ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
            "flash_fwd_tf32", "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32",
            "paged_verify_split", "paged_verify_combine",
            "paged_attention_kernel")
    bad = [n for n in spilled if n and n.startswith(held)]
    if bad:
        raise AssertionError(f"ptxas spills registers in {bad}")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels(card):
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import attention_reference, flash_attention
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    flash_err, paged_err = 0.0, 0.0
    flash_rows, paged_rows = [], []

    # -- flash attention: the prefill buckets of the serving phase ----------
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        for s in (16, 100, 128, 1024):
            g = torch.Generator(device=dev).manual_seed(s)
            q, k, v = (torch.randn(1, 12, s, 64, generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
            ref, ref_lse = attention_reference(q, k, v, causal=True,
                                               return_lse=True)
            torch.cuda.synchronize()
            e, el = max_err(out, ref), max_err(lse, ref_lse)
            if not (e < FLASH_TOL[dn] and el < LSE_TOL[dn]):
                raise AssertionError(f"flash_fwd {dn} S={s}: max |dO| {e} "
                                     f"(tol {FLASH_TOL[dn]}), max |dlse| "
                                     f"{el} (tol {LSE_TOL[dn]})")
            flash_err = max(flash_err, e)
            # q, k, v read once, O written once; causal QK^T and PV over the
            # S(S+1)/2 (query, key) pairs at or below the diagonal
            nbytes = 4 * q.numel() * q.element_size()
            flops = 4 * 64 * 12 * s * (s + 1) / 2
            kern = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
            row = {"dtype": dn, "S": s, "max_abs_err": e, "lse_err": el,
                   "ms": time_device([kern] * 20),
                   "call_ms": time_calls(kern),
                   "plain_ms": time_device([lambda: attention_reference(
                       q, k, v, causal=True)] * 5),
                   "library_ms": time_device([lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True)] * 20),
                   "bytes": nbytes, "flops": flops}
            _rate(row, dn)
            flash_rows.append(row)
            log(f"[kernels] flash_fwd {dn} B=1 H=12 S={s} D=64 causal: "
                f"err {e:.3g} lse_err {el:.3g} ms {row['ms']:.5f} (per "
                f"call {row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                f"sdpa {row['library_ms']:.5f} bound {row['bound_ms']:.5f} "
                f"({row['bound_by']}{_cuda_core_note(row)}) "
                f"{row['tflops']:.1f} TFLOP/s, "
                f"{row['bound_share']:.3f} of the bound [{card}]")
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn(2, 12, 256, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        mask = torch.ones(2, 256, device=dev)
        mask[0, 200:] = 0
        mask[1, 77:] = 0
        e = max_err(flash_attention(q, k, v, kv_mask=mask),
                    attention_reference(q, k, v, kv_mask=mask))
        if not e < FLASH_TOL[dn]:
            raise AssertionError(f"flash_fwd {dn} masked: max |dO| {e}")
        flash_err = max(flash_err, e)
        log(f"[kernels] flash_fwd {dn} B=2 S=256 non-causal ragged mask: "
            f"err {e:.3g}")

    # -- paged attention: the decode step's shapes, and one long slot -------
    b, h, d, page, maxp, num_pages = DECODE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        kp = torch.randn(num_pages, page, h, d, generator=g,
                         device=dev).to(dtype)
        vp = torch.randn(num_pages, page, h, d, generator=g,
                         device=dev).to(dtype)
        for case in ("decode", "one-slot"):
            row = _decode_row(card, "kernels", q, kp, vp, {}, case)
            paged_err = max(paged_err, row["max_abs_err"])
            paged_rows.append(row)
    log("[kernels] detail " + json.dumps({"flash_fwd": flash_rows,
                                          "paged_attention": paged_rows}))
    # the kernels line reports the serving phase's own shapes: bf16, the
    # largest prefill bucket for flash, the decode step for paged
    main_flash = next(r for r in flash_rows
                      if r["dtype"] == "bfloat16" and r["S"] == 1024)
    return ({"max_abs_err": flash_err, **_pick(main_flash),
             "tflops": main_flash["tflops"],
             "bound_share": main_flash["bound_share"]},
            {"max_abs_err": paged_err, **_decode_pick(paged_rows, "bfloat16")})


# the decode step's paged operands: B, H, D, page, max pages, pool pages
DECODE_SHAPE = (8, 12, 64, 16, 64, 513)
DECODE_LENGTHS = (0, 1, 17, 100, 255, 512, 700, 1024)


def _decode_operands(dev):
    """``(lengths, table)`` of the paged kernels' rows: ragged lengths with
    an empty slot (its table row on scratch page 0) and slot 3 aliasing
    slot 2's first two pages (a shared prefix)."""
    import numpy as np
    import torch
    b, _, _, _, maxp, num_pages = DECODE_SHAPE
    rs = np.random.RandomState(0)
    table = rs.permutation(np.arange(1, num_pages))[:b * maxp].reshape(b, maxp)
    table[3, :2] = table[2, :2]                   # aliased shared prefix
    table[0] = 0                                  # empty slot -> scratch page
    return (torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev),
            torch.as_tensor(table, dtype=torch.int32, device=dev))


def _pool_rows(table, walked, page):
    """The (page, row) pool rows a kernel reads when slot i walks its first
    ``walked[i]`` tokens, each counted once (aliased pages are one set)."""
    tab = table.tolist()
    return {(tab[i][t // page], t % page)
            for i, n in enumerate(walked.tolist()) for t in range(n)}


def _pick(row):
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}


def _decode_row(card, tag, q, kp, vp, sc, case):
    """Check and time ``paged_attention`` over the pool ``kp``/``vp`` (with
    scales ``sc``, when quantized) at the decode step's operands
    (``case="decode"``) or at one 1024-token slot, B=1 (``"one-slot"``, slot
    7's table row: one block per (slot, head) walked it all before the walk
    was split). Against the plain version within ``PAGED_TOL``, an empty
    slot exact zeros, a second launch bit-identical. Timed with the pool
    cold in L2, beside the yardstick ``verify_s1_ms``:
    ``paged_attention_verify`` at S=1 with start = lengths - 1 over the
    same non-empty slots (the split verify and its combine, two launches).
    Returns the detail row."""
    import torch
    from sparkflow_tpu_torch.ops import (paged_attention,
                                         paged_attention_reference,
                                         paged_attention_verify)
    _, h, d, page, _, _ = DECODE_SHAPE
    lengths, table = _decode_operands(q.device)
    if case == "one-slot":
        q, table = q[7:8], table[7:8]
        lengths = torch.tensor([1024], dtype=torch.int32, device=q.device)
    dn = str(q.dtype).replace("torch.", "")
    name = "paged_attention_quant" if sc else "paged_attention"
    pool_name = dn if not sc else ("int8" if kp.dtype == torch.int8
                                   else "fp8")
    out, ref, again = (paged_attention(q, kp, vp, table, lengths, **sc),
                       paged_attention_reference(q, kp, vp, table, lengths,
                                                 **sc),
                       paged_attention(q, kp, vp, table, lengths, **sc))
    torch.cuda.synchronize()
    e = max_err(out, ref)
    empty_zero = bool(torch.all(out[lengths == 0] == 0))
    if not (e < PAGED_TOL[dn] and empty_zero
            and bool(torch.isfinite(out.float()).all())):
        raise AssertionError(f"{name} {dn} q, {pool_name} pool, {case}: max "
                             f"|d| {e} (tol {PAGED_TOL[dn]}); empty slot "
                             f"zero: {empty_zero}")
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {dn} q, {pool_name} pool, {case}: a "
                             f"second launch gave other bits")
    rows = _pool_rows(table, lengths, page)
    npages = len({p for p, _ in rows})
    item = kp.element_size()
    qbytes = q.numel() * q.element_size()
    # K and V rows read once (and one float32 scale per page-head of the
    # pages read), q read and O written, table and lengths
    nbytes = (2 * len(rows) * h * d * item + (2 * npages * h * 4 if sc else 0)
              + 2 * qbytes + table.numel() * 4 + lengths.numel() * 4)
    flops = 4 * h * d * int(lengths.sum())
    # in a decode step the layer's pool comes cold from device memory
    # (between two layers' calls the step streams a layer's weights, 7M
    # parameters read as float32 and cast to bf16): time launches over
    # enough copies of the pool that more than the 50 MB L2 of live rows
    # lies between two visits of one copy (12 at 2 bytes an element)
    copies = 12 * 2 // item if item < 4 else 12
    pools = [(kp.clone(), vp.clone(), {k: v.clone() for k, v in sc.items()})
             for _ in range(copies)]
    live = lengths > 0
    qv, tv = q[live][:, :, None], table[live]
    start = (lengths[live] - 1).to(torch.int32)
    row = {"kernel": name, "dtype": dn, "pool": pool_name, "case": case,
           "B": q.shape[0], "tokens": int(lengths.sum()), "max_abs_err": e,
           "ms": time_device([
               lambda p=p: paged_attention(q, p[0], p[1], table, lengths,
                                           **p[2]) for p in pools]),
           "call_ms": time_calls(lambda: paged_attention(q, kp, vp, table,
                                                         lengths, **sc)),
           "verify_s1_ms": time_device([
               lambda p=p: paged_attention_verify(qv, p[0], p[1], tv, start,
                                                  **p[2]) for p in pools]),
           "plain_ms": time_device([
               lambda p=p: paged_attention_reference(q, p[0], p[1], table,
                                                     lengths, **p[2])
               for p in pools[:12]]),
           "library_ms": None, "bytes": nbytes, "flops": flops}
    del pools
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dn)
    log(f"[{tag}] {name} {dn} q, {pool_name} pool, {case} B={row['B']} H={h} "
        f"D={d} page={page} tokens {row['tokens']}: err {e:.3g} ms "
        f"{row['ms']:.5f} (per call {row['call_ms']:.4f}) verify S=1 "
        f"{row['verify_s1_ms']:.5f} plain {row['plain_ms']:.4f} bound "
        f"{row['bound_ms']:.5f} ({row['bound_by']}); empty slot 0, a second "
        f"launch bit-identical [{card}]")
    return row


def _decode_pick(rows, pool_name):
    """The kernels-line fields of a decode kernel: its bf16-query row at the
    decode step's shape, with the yardstick and the one-slot row's times."""
    main, one = (next(r for r in rows if r["dtype"] == "bfloat16"
                      and r["pool"] == pool_name and r["case"] == case)
                 for case in ("decode", "one-slot"))
    return {**_pick(main), "verify_s1_ms": main["verify_s1_ms"],
            "one_slot": {k: one[k] for k in ("ms", "verify_s1_ms",
                                             "bound_ms")}}


def _device_profile(prof, wall_ms: float, per: int,
                    kernels: tuple = ()) -> dict:
    """The card's share of a profiled window: the union of its kernel, copy
    and memset intervals (GPU-side ``record_function`` ranges excluded)
    against the window's host wall time, the kernels that took most of it
    and, for each name fragment in ``kernels``, the calls and time of every
    kernel whose name holds it, all per ``per`` (steps or prefills)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not evs:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, end = 0.0, -math.inf
    by_name = {}
    for e in sorted(evs, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (t - s))
    busy_ms = busy / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"wall_ms": wall_ms / per, "device_busy_ms": busy_ms / per,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_ops": len(evs) / per,
           "top": [{"name": n[:90], "calls": c / per, "ms": us / 1e3 / per}
                   for n, (c, us) in top]}
    if kernels:
        out["kernels"] = {
            frag: {"calls": sum(c for n, (c, _) in by_name.items()
                                if frag in n) / per,
                   "ms": sum(us for n, (_, us) in by_name.items()
                             if frag in n) / 1e3 / per}
            for frag in kernels}
    return out


def phase_profile(card, eng):
    """Where the serving path's time goes, under ``torch.profiler``: a
    steady window of decode steps with all 8 slots live, and one prefill of
    a 700-token prompt (the 1024 bucket)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    vocab = GPT2_SMALL["vocab_size"]
    slots = [eng.prefill(rng.integers(0, vocab, n).tolist(),
                         max_new_tokens=200)["slot"]
             for n in (17, 64, 100, 128, 255, 300, 512, 700)]
    steps = 20
    for _ in range(5):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    decode = {"steps": steps, "step_ms_unprofiled": plain_ms,
              **_device_profile(prof, wall, steps)}
    for s in slots:
        eng.release(s)
    eng.kv.flush_prefix_index()
    prompt = rng.integers(0, vocab, 700).tolist()
    eng.release(eng.prefill(prompt, max_new_tokens=1)["slot"])   # warm
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = eng.prefill(rng.integers(0, vocab, 700).tolist(),
                           max_new_tokens=1)["slot"]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    eng.release(slot)
    prefill = {"prompt": 700, "bucket": 1024, **_device_profile(prof, wall, 1)}
    log("[profile] " + json.dumps({"decode_step_8_slots": decode,
                                   "prefill_700": prefill, "card": card}))


def _lm(compute_dtype, seed=0):
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    spec = build_registry_spec("transformer_lm", **GPT2_SMALL)
    model = model_from_json(spec, compute_dtype=compute_dtype)
    params = model.init(torch.Generator().manual_seed(seed))
    return model, params


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q / 100.0 * len(xs))) - 1)]


def phase_serving(card):
    import numpy as np
    from sparkflow_tpu_torch.ops import (flash_attention, paged_attention,
                                         reset_launch_counts)
    from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                             InferenceServer, ServingClient)
    model, params = _lm("bfloat16")
    eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0)
    cb = ContinuousBatcher(eng, max_queue=64)
    srv = InferenceServer(None, generate_batcher=cb, host="127.0.0.1",
                          port=0, memory_watch=False).start()
    launches = {}
    try:
        cli = ServingClient(srv.url, timeout=300)
        rng = np.random.default_rng(0)
        # warm-up, before the counters are zeroed: one request per prefill
        # bucket (and a sampled one), so first-use library loads for each
        # matmul shape stay out of the measured burst
        for n in [max(1, b // 2 + 1) for b in eng.prefill_buckets]:
            cli.generate(rng.integers(0, 1000, n).tolist(), max_new_tokens=2,
                         temperature=0.5, top_k=8, seed=0)
        lens = (17, 64, 100, 128, 255, 300, 512, 700)
        prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
                   for n in lens]
        sampled = {2: 1234, 5: 99}                     # request -> seed
        results = [None] * len(prompts)

        def one(i):
            kw = {}
            if i in sampled:
                kw = dict(temperature=0.8, top_k=40, seed=sampled[i])
            results[i] = cli.generate(prompts[i], max_new_tokens=32, **kw)

        steps0 = eng.stats()["steps"]
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_attention": paged_attention.launches}
        for i, r in enumerate(results):
            if r is None or r["num_tokens"] != 32 or len(r["tokens"]) != 32 \
                    or r["finish_reason"] != "length":
                raise AssertionError(f"request {i} (prompt {lens[i]}): {r}")
        if not (launches["flash_fwd"] > 0 and launches["paged_attention"] > 0):
            raise AssertionError(f"a kernel was not launched: {launches}")
        ttft = [r["timing_ms"]["queue_wait_ms"] + r["timing_ms"]["prefill_ms"]
                for r in results]
        step_ms_p50 = eng.metrics.percentile(
            "serving/decode/step_ms", 50,
            window=eng.stats()["steps"] - steps0)
        # greedy replay: the prompt's full pages are in the prefix index now,
        # so this one runs the prefix-hit suffix path and must still land on
        # the same tokens
        g = cli.generate(prompts[0], max_new_tokens=32)
        if g["tokens"] != results[0]["tokens"]:
            raise AssertionError("greedy replay differs")
        # seeded replay: sampling must repeat on the same computation, so the
        # index is flushed first — a prefix hit computes the suffix with other
        # matmul shapes, and bf16 logits that differ in the last bit can
        # move a sampled token
        eng.kv.flush_prefix_index()
        s = cli.generate(prompts[2], max_new_tokens=32, temperature=0.8,
                         top_k=40, seed=sampled[2])
        if s["tokens"] != results[2]["tokens"]:
            raise AssertionError("seeded replay differs")
        h = cli.healthz()
        if h["status"] != "ok":
            raise AssertionError(f"healthz: {h['status']}")
        pages = h["decode"]["engine"]["kv"]["pages_used"]
        if pages != 0:
            raise AssertionError(f"pages_used {pages} after all retired")
    finally:
        srv.stop()
    gen = sum(r["num_tokens"] for r in results)
    summary = {"requests": len(results), "tokens_generated": gen,
               "wall_s": wall, "ttft_ms_p50": _pct(ttft, 50),
               "ttft_ms_p95": _pct(ttft, 95),
               "decode_tokens_per_s": gen / wall,
               "step_ms_p50": step_ms_p50,
               "launches": launches, "card": card}
    log("[serving] " + json.dumps(summary))
    return launches, eng


def phase_exactness(card):
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params = _lm(None, seed=1)
    eng = DecodeEngine(model, params, num_slots=4, page_size=16, seed=0,
                       prefix_cache=False)
    rng = np.random.default_rng(1)
    worst = 0.0
    for n in (40, 129, 300):
        prompt = rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
        info = eng.prefill(prompt, max_new_tokens=8)
        toks = [info["token"]]
        while len(toks) < 8:
            toks.extend(eng.step()[info["slot"]])
        eng.release(info["slot"])
        ids = list(prompt)
        with torch.inference_mode():
            kernel_logits, _ = model.prefill(
                params, torch.tensor([prompt], device="cuda"))
            for i in range(8):
                lg = model._forward(
                    params, {"input_ids": torch.tensor([ids], device="cuda")},
                    attention=attention_reference)["logits"][0, -1]
                if i == 0:
                    err = max_err(kernel_logits[0], lg)
                    worst = max(worst, err)
                    if not err < 1e-3:
                        raise AssertionError(f"prefill logits differ by "
                                             f"{err} (prompt {n})")
                ids.append(int(lg.argmax()))
        if toks != ids[n:]:
            raise AssertionError(f"prompt {n}: engine {toks} != dense "
                                 f"{ids[n:]}")
    log(f"[exactness] 3 prompts x 8 greedy tokens equal the dense float32 "
        f"forward; max |prefill logit delta| {worst:.3g} [{card}]")


def _quant_pools(kp, vp, kind, zero_page, grow_page):
    """K and V ``(rows, scales)`` of float pools quantized to ``kind``
    ("int8" / "fp8") as the engine's pool holds them: head 3 of
    ``zero_page`` all zeros (scale 0, never written), and ``grow_page``
    rescaled mid-fill — a late row with 3x the page's absmax appended at
    offset 7 through the running-scale path."""
    import torch
    from sparkflow_tpu_torch.utils import quant
    out = []
    for pages in (kp, vp):
        pages = pages.float().clone()
        pages[zero_page, :, 3] = 0.0
        rows, scales = quant.quantize_kv_pages(pages, kind)
        rows, scales = rows[None].contiguous(), scales[None].contiguous()
        dev = pages.device
        quant.paged_quant_append(
            rows, scales, 0, torch.tensor([grow_page], device=dev),
            torch.tensor([7], device=dev), 3.0 * pages[grow_page, 7:8])
        if float(scales[0, zero_page, 3]) != 0.0:
            raise AssertionError("the zeroed page-head has a scale")
        out.append((rows[0], scales[0]))
    return out


def phase_spec_kernels(card):
    """Kernels 5-7 against their plain versions at the decode step's shapes
    (B=8, H=12, D=64, page 16, the paged row's 2609 live tokens; verify
    S=5): ``paged_attention`` over int8 and fp8 pools, ``paged_attention_
    verify`` over the plain pool and both quantized ones, bf16 and f32
    queries; each timed like the paged row (pool cold in L2). Returns the
    kernels-line rows (bf16 queries; int8 for the quantized kernels)."""
    import torch
    from sparkflow_tpu_torch.ops import (paged_attention_verify,
                                         paged_attention_verify_reference)
    dev = torch.device("cuda")
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    b, h, d, page, maxp, num_pages = DECODE_SHAPE
    lengths, table = _decode_operands(dev)
    zero_page, grow_page = int(table[5, 0]), int(table[6, 1])
    S = SPEC_K + 1
    start = (lengths - S).clamp(min=0).to(torch.int32)
    # verify's operands: the decode step's slots, and one 1024-token slot
    # (slot 7's table row, start 1019) — one block walked it all before
    # the walk was split into chunks
    one = torch.tensor([1024 - S], dtype=torch.int32, device=dev)
    slots = {"verify": (table, start + S), "one-slot": (table[7:8], one + S)}
    rows = {k: _pool_rows(t, walked, page) for k, (t, walked) in
            slots.items()}
    pages = {k: len({p for p, _ in r}) for k, r in rows.items()}
    # (query, key) pairs: every key at or before the query's position
    pairs = {k: sum(int(st) * S + S * (S + 1) // 2 for st in sv.tolist())
             for k, sv in (("verify", start), ("one-slot", one))}
    detail, worst = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        g = torch.Generator(device=dev).manual_seed(5)
        kp = torch.randn(num_pages, page, h, d, generator=g, device=dev)
        vp = torch.randn(num_pages, page, h, d, generator=g, device=dev)
        q1 = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        # the verify query as the model hands it over: a strided view of
        # one [B, S, 3, H, D] qkv projection
        qs = torch.randn(b, S, 3, h, d, generator=g, device=dev).to(dtype)
        qs = qs.permute(2, 0, 3, 1, 4)[0]
        # the decode kernel over both quantized pools; the one-slot case
        # with bf16 queries
        for kind in ("int8", "fp8"):
            (kq, ks), (vq, vs) = _quant_pools(kp, vp, kind, zero_page,
                                              grow_page)
            for case in ("decode", "one-slot")[:2 if dtype ==
                                                torch.bfloat16 else 1]:
                row = _decode_row(card, "spec-kernels", q1, kq, vq,
                                  dict(k_scales=ks, v_scales=vs), case)
                row["S"] = 1
                worst[row["kernel"]] = max(worst.get(row["kernel"], 0.0),
                                           row["max_abs_err"])
                detail.append(row)
        cases = [("paged_verify", None, dn, "verify")]
        cases += [("paged_verify_quant", kind, kind, "verify") for kind in
                  ("int8", "fp8")]
        if dtype == torch.bfloat16:
            cases += [("paged_verify", None, dn, "one-slot")]
            cases += [("paged_verify_quant", kind, kind, "one-slot")
                      for kind in ("int8", "fp8")]
        for name, kind, pool_name, shape in cases:
            if kind is None:
                pool = (kp.to(dtype), None), (vp.to(dtype), None)
            else:
                pool = _quant_pools(kp, vp, kind, zero_page, grow_page)
            (kq, ks), (vq, vs) = pool
            sc = {} if kind is None else dict(k_scales=ks, v_scales=vs)
            tab = slots[shape][0]
            q, per_slot = {"verify": (qs, start),
                           "one-slot": (qs[7:8], one)}[shape]

            def call(kk, vv, sc, q=q, tab=tab, per_slot=per_slot):
                return paged_attention_verify(q, kk, vv, tab, per_slot, **sc)

            def plain(kk, vv, sc, q=q, tab=tab, per_slot=per_slot):
                return paged_attention_verify_reference(q, kk, vv, tab,
                                                        per_slot, **sc)

            out, ref, again = (call(kq, vq, sc), plain(kq, vq, sc),
                               call(kq, vq, sc))
            torch.cuda.synchronize()
            e = max_err(out, ref)
            if not (e < PAGED_TOL[dn] and bool(torch.isfinite(
                    out.float()).all())):
                raise AssertionError(f"{name} {dn} q, {pool_name} pool, "
                                     f"{shape}: max |d| {e} (tol "
                                     f"{PAGED_TOL[dn]})")
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {dn} q, {pool_name} pool, "
                                     f"{shape}: a second launch gave other "
                                     f"bits")
            worst[name] = max(worst.get(name, 0.0), e)
            item = kq.element_size()
            qbytes = q.numel() * q.element_size()
            # K and V rows read once (and one float32 scale per page-head
            # of the pages read), q read and O written, table and start
            nbytes = (2 * len(rows[shape]) * h * d * item
                      + (2 * pages[shape] * h * 4 if kind else 0)
                      + 2 * qbytes + tab.numel() * 4 + per_slot.numel() * 4)
            flops = 4 * h * d * pairs[shape]
            # cold in L2 as in a decode step: enough pool copies that more
            # than the 50 MB L2 of live rows lies between two visits of one
            copies = 12 * 2 // item if item < 4 else 12
            pools = [(kq.clone(), vq.clone(), {k: v.clone() for k, v in
                                               sc.items()})
                     for _ in range(copies)]
            row = {"kernel": name, "dtype": dn, "pool": pool_name,
                   "case": shape, "B": q.shape[0], "S": S,
                   "tokens": int(slots[shape][1].sum()),
                   "max_abs_err": e,
                   "ms": time_device([lambda p=p: call(*p) for p in pools]),
                   "call_ms": time_calls(lambda: call(kq, vq, sc)),
                   "plain_ms": time_device([lambda p=p: plain(*p)
                                            for p in pools[:12]]),
                   "library_ms": None, "bytes": nbytes, "flops": flops}
            del pools
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dn)
            detail.append(row)
            log(f"[spec-kernels] {name} {dn} q, {pool_name} pool, "
                f"B={row['B']} H=12 D=64 page=16 S={row['S']} tokens "
                f"{row['tokens']}: err {e:.3g} ms {row['ms']:.5f} (per call "
                f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} bound "
                f"{row['bound_ms']:.5f} ({row['bound_by']}); a second launch "
                f"bit-identical [{card}]")
    log("[spec-kernels] detail " + json.dumps(detail))
    picked = {"paged_attention_quant": {
        "max_abs_err": worst["paged_attention_quant"],
        **_decode_pick(detail, "int8")}}
    for name, pool_name in (("paged_verify", "bfloat16"),
                            ("paged_verify_quant", "int8")):
        main = next(r for r in detail if r["kernel"] == name
                    and r["dtype"] == "bfloat16" and r["pool"] == pool_name
                    and r["case"] != "one-slot")
        picked[name] = {"max_abs_err": worst[name], **_pick(main)}
    return picked


def _serve_burst(eng, seed: int):
    """Eight concurrent ``generate`` calls (the serving phase's prompt
    lengths, 32 new tokens, two of them sampled) through
    ``ContinuousBatcher`` -> ``InferenceServer`` -> ``ServingClient``, after
    one warm-up request per prefill bucket. The launch counters are zeroed
    just before the burst and read just after. Returns ``(results, wall
    seconds, launch counts, engine steps in the burst)``."""
    import numpy as np
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import (ContinuousBatcher,
                                             InferenceServer, ServingClient)
    cb = ContinuousBatcher(eng, max_queue=64)
    srv = InferenceServer(None, generate_batcher=cb, host="127.0.0.1",
                          port=0, memory_watch=False).start()
    try:
        cli = ServingClient(srv.url, timeout=300)
        rng = np.random.default_rng(seed)
        for n in [max(1, bk // 2 + 1) for bk in eng.prefill_buckets]:
            cli.generate(rng.integers(0, 1000, n).tolist(), max_new_tokens=2,
                         temperature=0.5, top_k=8, seed=0)
        lens = (17, 64, 100, 128, 255, 300, 512, 700)
        prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
                   for n in lens]
        sampled = {2: 1234, 5: 99}
        results = [None] * len(prompts)

        def one(i):
            kw = {}
            if i in sampled:
                kw = dict(temperature=0.8, top_k=40, seed=sampled[i])
            results[i] = cli.generate(prompts[i], max_new_tokens=32, **kw)

        st0 = eng.stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        st1 = eng.stats()
        for i, r in enumerate(results):
            if r is None or r["num_tokens"] != 32 or len(r["tokens"]) != 32 \
                    or r["finish_reason"] != "length":
                raise AssertionError(f"request {i} (prompt {lens[i]}): {r}")
        h = cli.healthz()
        if h["status"] != "ok" or h["decode"]["engine"]["kv"][
                "pages_used"] != 0:
            raise AssertionError(f"healthz after the burst: {h['status']}, "
                                 f"pages_used "
                                 f"{h['decode']['engine']['kv']['pages_used']}")
    finally:
        srv.stop()
    return results, wall, launches, {
        "steps": st1["steps"] - st0["steps"],
        "spec_steps": st1["spec"]["steps"] - st0["spec"]["steps"]}


def _profile_steps(eng, steps: int = 5) -> dict:
    """``torch.profiler`` over ``steps`` engine steps with all 8 slots live
    (the profile phase's prompt lengths), after two unprofiled ones."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    slots = [eng.prefill(rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist(),
                         max_new_tokens=200)["slot"]
             for n in (17, 64, 100, 128, 255, 300, 512, 700)]
    for _ in range(2):
        eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    for s in slots:
        eng.release(s)
    return {"steps": steps, **_device_profile(prof, wall, steps)}


def phase_spec_serving(card):
    """The speculative decode plane at GPT-2-small width (bf16, random
    weights from a seed): ``DecodeEngine(num_slots=8, page_size=16,
    spec_k=4)`` — self-speculation through the first 6 of 12 layers — with
    (a) the bf16 pool and (b) ``kv_quant="int8"``, each serving one burst,
    then 5 spec steps with 8 live slots under ``torch.profiler``. Returns
    the launch counts of both bursts."""
    from sparkflow_tpu_torch.serving import DecodeEngine
    model, params = _lm("bfloat16")
    layers = model.num_layers
    out = {}
    for arm, kw in (("a", {}), ("b", {"kv_quant": "int8"})):
        eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0,
                           spec_k=SPEC_K, **kw)
        results, wall, launches, steps = _serve_burst(eng, seed=10)
        st = eng.stats()
        quantized = arm == "b"
        draft_key = "paged_attention_quant" if quantized else "paged_attention"
        verify_key = "paged_verify_quant" if quantized else "paged_verify"
        others = ("paged_attention", "paged_verify") if quantized else (
            "paged_attention_quant", "paged_verify_quant")
        n = steps["spec_steps"]
        if not (n > 0 and n == steps["steps"]
                and launches[verify_key] == layers * n
                and launches[draft_key] == SPEC_K * eng.draft_layers * n
                and launches["flash_fwd"] > 0
                and all(launches[k] == 0 for k in others)):
            raise AssertionError(
                f"burst ({arm}): {steps}, launches {launches}: every step "
                f"must be speculative, {verify_key} {layers} per step, "
                f"{draft_key} {SPEC_K} x {eng.draft_layers} per step, "
                f"{', '.join(others)} never")
        ttft = [r["timing_ms"]["queue_wait_ms"] + r["timing_ms"]["prefill_ms"]
                for r in results]
        gen = sum(r["num_tokens"] for r in results)
        spec = st["spec"]
        summary = {
            "arm": arm, "kv_quant": st["kv_quant"], "spec_k": SPEC_K,
            "draft_layers": eng.draft_layers, "requests": len(results),
            "tokens_generated": gen, "wall_s": wall,
            "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p95": _pct(ttft, 95),
            "decode_tokens_per_s": gen / wall,
            "spec_steps": n, "accept_rate": spec["accept_rate"],
            "mean_accepted": spec["mean_accepted"],
            "draft_ms_p50": eng.metrics.percentile(
                "serving/decode/draft_ms", 50, window=n),
            "verify_ms_p50": eng.metrics.percentile(
                "serving/decode/verify_ms", 50, window=n),
            "step_ms_p50": eng.metrics.percentile(
                "serving/decode/step_ms", 50, window=n),
            "kv_bytes_per_page": st["kv"]["kv_bytes_per_page"],
            "kv_quant_error": st["kv_quant_error"],
            "launches": launches, "card": card}
        log("[spec-serving] " + json.dumps(summary))
        log("[spec-profile] " + json.dumps(
            {"arm": arm, "spec_step_8_slots": _profile_steps(eng),
             "card": card}))
        out[arm] = (launches, summary)
        del eng
    bf16, int8 = (out[a][1]["kv_bytes_per_page"] for a in ("a", "b"))
    log(f"[spec-serving] KV bytes per page ({layers} layers, K and V): bf16 "
        f"{bf16}, "
        f"int8 {int8} ({bf16 / int8:.3f}x as many pages per byte)")
    return {arm: launches for arm, (launches, _) in out.items()}


def _greedy(eng, prompts, n):
    """``n`` greedy tokens for each prompt, all admitted at once; a slot is
    released as soon as it has its ``n`` (a speculative step may give some
    slots several tokens and others one)."""
    infos = [eng.prefill(p, max_new_tokens=n) for p in prompts]
    toks = {i["slot"]: [i["token"]] for i in infos}
    live = set(toks)
    while live:
        for s, t in eng.step().items():
            toks[s].extend(t)
            if len(toks[s]) >= n:
                eng.release(s)
                live.discard(s)
    return [toks[i["slot"]][:n] for i in infos]


def phase_spec_exactness(card):
    """Float32, TF32 off, all 12 layers: greedy tokens with ``spec_k=4``
    (self-speculation, and an external 6-layer 768-wide draft of the same
    vocab) equal the spec-off engine's; with an int8 pool and ``spec_k=4``
    the card's tokens equal the same engine's on the CPU (its plain
    versions) over 4 prompts x 16 tokens; ``kv_quant_error`` of int8 below
    0.05 (fp8's printed)."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params = _lm(None, seed=1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
               for n in (20, 57, 100, 150)]
    kw = dict(num_slots=4, page_size=16, max_seq_len=256, seed=0,
              prefix_cache=False)
    want = _greedy(DecodeEngine(model, params, **kw), prompts, 16)
    draft_spec = build_registry_spec("transformer_lm",
                                     **dict(GPT2_SMALL, num_layers=6))
    draft = model_from_json(draft_spec)
    draft_params = draft.init(torch.Generator().manual_seed(2))
    accept = {}
    for name, extra in (("self", {}),
                        ("external", dict(draft_model=draft_spec,
                                          draft_params=draft_params))):
        eng = DecodeEngine(model, params, spec_k=SPEC_K, **kw, **extra)
        got = _greedy(eng, prompts, 16)
        if got != want:
            raise AssertionError(f"spec_k={SPEC_K} ({name} draft) tokens "
                                 f"{got} != spec-off {want}")
        accept[name] = eng.stats()["spec"]["accept_rate"]
    card_eng = DecodeEngine(model, params, spec_k=SPEC_K, kv_quant="int8",
                            **kw)
    card_toks = _greedy(card_eng, prompts, 16)
    cpu_model = model_from_json(build_registry_spec("transformer_lm",
                                                    **GPT2_SMALL),
                                device="cpu")
    cpu_params = {ln: {pn: t.cpu() for pn, t in layer.items()}
                  for ln, layer in params.items()}
    cpu_eng = DecodeEngine(cpu_model, cpu_params, spec_k=SPEC_K,
                           kv_quant="int8", **kw)
    cpu_toks = _greedy(cpu_eng, prompts, 16)
    if card_toks != cpu_toks:
        raise AssertionError(f"int8 + spec_k={SPEC_K}: card {card_toks} != "
                             f"CPU engine {cpu_toks}")
    err = card_eng.stats()["kv_quant_error"]
    if not (err is not None and 0.0 <= err < 0.05):
        raise AssertionError(f"kv_quant_error (int8) {err}, not below 0.05")
    fp8_err = DecodeEngine(model, params, kv_quant="fp8",
                           **kw).stats()["kv_quant_error"]
    log(f"[spec-exactness] float32, 12 layers, 4 prompts x 16 greedy tokens: "
        f"spec_k={SPEC_K} self-draft (accept {accept['self']:.3f}) and "
        f"external 6-layer draft (accept {accept['external']:.3f}) equal "
        f"spec-off; int8 + spec_k={SPEC_K} card equals the CPU engine; "
        f"kv_quant_error int8 {err:.4g} (CPU {cpu_eng.stats()['kv_quant_error']:.4g}),"
        f" fp8 {fp8_err:.4g} [{card}]")


def _training_operands(b, s, dtype, gen):
    """q, k, v and dO laid out as the training step hands them to the
    kernels: q, k and v strided views of one [3,B,H,S,D] permutation of the
    qkv projection's [B,S,3,H,D] output, dO the [B,H,S,D] view of a
    [B,S,H,D] tensor (the gradient of the forward's transpose back)."""
    import torch
    qkv = torch.randn(b, s, 3, 12, 64, generator=gen, device="cuda").to(dtype)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    dout = torch.randn(b, s, 12, 64, generator=gen, device="cuda").to(dtype)
    return qkv[0], qkv[1], qkv[2], dout.transpose(1, 2)


def phase_backward_kernels(card):
    """The forward's output and logsumexp, then the dq and dk/dv kernels,
    against their plain versions at the training path's operands; and their
    times. Returns the kernels-line rows: bf16 at the training shape for the
    two backward kernels and for the forward."""
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                         flash_attention_backward_reference,
                                         flash_bwd_dkv,
                                         flash_bwd_dkv_reference,
                                         flash_bwd_dq, flash_bwd_dq_reference)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    cases = [("train", 8, 1024, True, None), ("s128", 2, 128, True, None),
             ("s700", 1, 700, True, None),
             # the classifier's mask: padded tails, one row all padding
             ("masked", 4, 512, False, (512, 300, 77, 0))]
    rows, fwd_rows = [], []
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        for case, b, s, causal, first_pad in cases:
            g = torch.Generator(device=dev).manual_seed(s + b)
            q, k, v, dout = _training_operands(b, s, dtype, g)
            mask = None
            if first_pad is not None:
                mask = torch.ones(b, s, device=dev)
                for i, f in enumerate(first_pad):
                    mask[i, f:] = 0
            out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                       return_lse=True)
            ref_out, ref_lse = attention_reference(q, k, v, causal,
                                                   kv_mask=mask,
                                                   return_lse=True)
            torch.cuda.synchronize()
            # a row whose keys are all padding has lse at NEG_INF on both
            # sides (the backward's gate zeroes its P): compare the others
            live = ref_lse > -0.5e30
            e = max_err(out, ref_out)
            el = max_err(lse[live], ref_lse[live])
            if not (e < FLASH_TOL[dn] and el < LSE_TOL[dn]
                    and bool((lse[~live] <= -0.5e30).all())):
                raise AssertionError(
                    f"flash_fwd {dn} {case}: max |dO| {e} (tol "
                    f"{FLASH_TOL[dn]}), max |dlse| {el} (tol {LSE_TOL[dn]}), "
                    f"all-padding rows at NEG_INF: "
                    f"{bool((lse[~live] <= -0.5e30).all())}")
            worst["flash_fwd"] = max(worst["flash_fwd"], e)
            log(f"[bwd] flash_fwd {dn} {case} B={b} S={s}: err {e:.3g} "
                f"lse_err {el:.3g}")
            if case == "train":
                # q, k, v read once, O written once; QK^T and PV over the
                # causal (query, key) pairs
                nbytes = 4 * q.numel() * q.element_size()
                flops = 4 * 64 * 12 * b * s * (s + 1) / 2
                kern = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
                row = {"dtype": dn, "case": case, "B": b, "S": s,
                       "max_abs_err": e, "lse_err": el,
                       "ms": time_device([kern] * 10),
                       "call_ms": time_calls(kern),
                       "plain_ms": time_device([lambda: attention_reference(
                           q, k, v, causal=True)] * 2),
                       "library_ms": time_device([
                           lambda: F.scaled_dot_product_attention(
                               q, k, v, is_causal=True)] * 10),
                       "bytes": nbytes, "flops": flops}
                _rate(row, dn)
                fwd_rows.append(row)
                log(f"[bwd] flash_fwd {dn} train B={b} H=12 S={s} D=64 "
                    f"causal: ms {row['ms']:.5f} (per call "
                    f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                    f"sdpa {row['library_ms']:.5f} bound "
                    f"{row['bound_ms']:.5f} ({row['bound_by']}"
                    f"{_cuda_core_note(row)}) "
                    f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} "
                    f"of the bound [{card}]")
            del ref_out, ref_lse
            delta = (dout.float() * out.float()).sum(-1).contiguous()
            args = (q, k, v, dout, lse, delta, causal)
            dq = flash_bwd_dq(*args, kv_mask=mask)
            dk, dv = flash_bwd_dkv(*args, kv_mask=mask)
            ref = flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                     causal, kv_mask=mask)
            torch.cuda.synchronize()
            errs = {}
            for gname, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                e, top = max_err(a, r), float(r.float().abs().max())
                if not (e <= BWD_TOL[dn] * top and torch.isfinite(
                        a.float()).all()):
                    raise AssertionError(
                        f"flash_bwd {gname} {dn} {case}: max |d| {e} > "
                        f"{BWD_TOL[dn]} x max |plain| {top}")
                errs[gname] = e
            if mask is not None and not (torch.all(dq[3] == 0)
                                         and torch.all(dk[3] == 0)):
                raise AssertionError(f"flash_bwd {dn}: the all-padding row's "
                                     f"gradient is not zero")
            again = (flash_bwd_dq(*args, kv_mask=mask),
                     *flash_bwd_dkv(*args, kv_mask=mask))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv),
                                                         again)):
                raise AssertionError(f"flash_bwd {dn} {case}: a second "
                                     f"launch gave other bits")
            del again
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                         errs["dv"])
            # the (query, key) pairs this run's data needs: at or below the
            # diagonal when causal, the unpadded keys otherwise
            if causal:
                pairs = 12 * b * s * (s + 1) / 2
            else:
                pairs = 12 * s * float(mask.sum()) if mask is not None \
                    else 12 * b * s * s
            item = q.element_size()
            plane = q.numel() * item            # one [B,H,S,D] operand
            stats = 2 * b * 12 * s * 4          # lse and delta, float32
            mbytes = mask.numel() * 4 if mask is not None else 0
            library_ms = time_sdpa_backward(q, k, v, dout, mask, causal)
            for name, kern, plain, nbytes, products in (
                    ("flash_bwd_dq",
                     lambda: flash_bwd_dq(*args, kv_mask=mask),
                     lambda: flash_bwd_dq_reference(*args, None, mask),
                     5 * plane + stats + mbytes, 3),
                    ("flash_bwd_dkv",
                     lambda: flash_bwd_dkv(*args, kv_mask=mask),
                     lambda: flash_bwd_dkv_reference(*args, None, mask),
                     6 * plane + stats + mbytes, 4)):
                flops = products * 2 * 64 * pairs
                row = {"kernel": name, "dtype": dn, "case": case, "B": b,
                       "S": s, "causal": causal,
                       "max_abs_err": (errs["dq"] if name == "flash_bwd_dq"
                                       else max(errs["dk"], errs["dv"])),
                       "ms": time_device([kern] * 10),
                       "call_ms": time_calls(kern),
                       "plain_ms": time_device([plain] * 2),
                       "library_ms": library_ms,
                       "bytes": nbytes, "flops": flops}
                _rate(row, dn)
                rows.append(row)
                log(f"[bwd] {name} {dn} {case} B={b} H=12 S={s} D=64 "
                    f"{'causal' if causal else 'padded keys'}: err "
                    f"{row['max_abs_err']:.3g} ms {row['ms']:.5f} (per call "
                    f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                    f"bound {row['bound_ms']:.5f} ({row['bound_by']}"
                    f"{_cuda_core_note(row)}) {row['tflops']:.1f} TFLOP/s, "
                    f"{row['bound_share']:.3f} of the bound; sdpa-bwd "
                    f"{library_ms:.5f}; a second launch bit-identical "
                    f"[{card}]")
            del q, k, v, dout, out, lse, delta, dq, dk, dv, ref
    log("[bwd] detail " + json.dumps({"flash_fwd": fwd_rows,
                                      "backward": rows}))
    picked = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        main = next(r for r in rows if r["kernel"] == name
                    and r["dtype"] == "bfloat16" and r["case"] == "train")
        picked[name] = {"max_abs_err": worst[name], **_pick(main),
                        "tflops": main["tflops"],
                        "bound_share": main["bound_share"]}
    main = next(r for r in fwd_rows if r["dtype"] == "bfloat16")
    picked["flash_fwd"] = {"max_abs_err": worst["flash_fwd"], "B": main["B"],
                           "S": main["S"], **_pick(main),
                           "tflops": main["tflops"],
                           "bound_share": main["bound_share"]}
    return picked


def _train_spec(**over):
    from sparkflow_tpu_torch.models import build_registry_spec
    return build_registry_spec("transformer_lm",
                               **dict(GPT2_SMALL, dropout=0.1, **over))


def phase_training(card):
    """``Trainer.fit`` at GPT-2-small width through the attention kernels,
    forward and backward; then one more step under the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparkflow_tpu_torch.core import make_loss_fn, make_train_step
    from sparkflow_tpu_torch.ops import (flash_attention, flash_bwd_dkv,
                                         flash_bwd_dq, reset_launch_counts)
    from sparkflow_tpu_torch.trainer import Trainer
    rows, seq, batch = 64, 1024, 8
    toks = np.random.default_rng(0).integers(0, 1000, (rows, seq)).astype(
        np.float32)
    marks, losses = [], []

    def on_step(loss, it, partition):
        # the trainer has read the epoch's loss back to the host: its one
        # step is done
        marks.append(time.perf_counter())
        losses.append(loss)

    # one step per epoch (a batch of 8 rows drawn from the 64), so the
    # reference's per-epoch loss_callback times each step
    tr = Trainer(_train_spec(), "input_ids", None, optimizer="adam",
                 learning_rate=3e-4, iters=TRAIN_STEPS, mini_batch_size=batch,
                 mini_stochastic_iters=1, compute_dtype="bfloat16", seed=0,
                 loss_callback=on_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(toks)
    launches = {"flash_fwd": flash_attention.launches,
                "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches}
    steps = len(losses)
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    want = tr.model.num_layers * TRAIN_STEPS
    if steps != TRAIN_STEPS or any(n != want for n in launches.values()):
        raise AssertionError(f"{steps} steps, launches {launches}; each "
                             f"kernel must launch {want} times")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite, or not falling")
    steady = step_ms[1:]
    summary = {"steps": steps, "batch": batch, "seq": seq,
               "losses": losses,
               "step_ms": step_ms,
               "first_step_includes": "fit set-up (init, staging, optimizer "
                                      "state)",
               "step_ms_median_after_first": sorted(steady)[len(steady) // 2],
               "tokens_per_s_after_first": batch * seq * len(steady)
               / (sum(steady) / 1e3),
               "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
    log("[training] " + json.dumps(summary))

    # one more step, profiled: the trainer's own step function on its
    # parameters and optimizer state
    model = tr.model
    params = model.load_params(tr.params, trainable=True)
    step = make_train_step(make_loss_fn(model, "input_ids", None),
                           tr.optimizer)
    x = torch.as_tensor(toks[:batch], device="cuda")
    y = torch.zeros(batch, 1, device="cuda")
    m = torch.ones(batch, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = tr._last_opt_state
    params, state, _ = step(params, state, x, y, m, gen)     # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, loss = step(params, state, x, y, m, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    prof_sum = _device_profile(prof, wall, 1, kernels=(
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    attn = sum(k["ms"] for k in prof_sum["kernels"].values())
    log("[training-profile] " + json.dumps(
        {"train_step": prof_sum, "attention_kernels_ms": attn,
         "attention_share_of_busy": attn / prof_sum["device_busy_ms"],
         "loss": float(loss), "card": card}))
    return launches


def phase_train_exactness(card):
    """Float32, TF32 off, full width cut to 2 layers: the training step
    through the kernels against the same step through the plain attention
    (autograd of ``attention_reference``), dropout draws shared."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.core import make_train_step
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.optimizers import build_optimizer, tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model_from_json(_train_spec(num_layers=2))
    init = {ln: {pn: t.detach().clone() for pn, t in layer.items()}
            for ln, layer in model.init(seed=2).items()}
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, GPT2_SMALL["vocab_size"], (4, 1024)), device="cuda")

    def fresh():
        return model.load_params({ln: {pn: t.clone() for pn, t in l.items()}
                                  for ln, l in init.items()}, trainable=True)

    def loss_fn(attention):
        return lambda p, xb, y, m, g: model.loss_vector(
            p, {"input_ids": xb}, True, g, attention=attention).mean()

    grads = {}
    for name, att in (("kernel", None), ("plain", attention_reference)):
        p = fresh()
        loss = loss_fn(att)(p, x, None, None,
                            torch.Generator(device="cuda").manual_seed(4))
        grads[name] = (float(loss.detach()),
                       torch.autograd.grad(loss, tree_leaves(p)))
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"loss {lk} through the kernels, {lp} plain")
    ratio = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(gk, gp))
    if not ratio <= 1e-4:
        raise AssertionError(f"gradients differ by {ratio} x max |plain|")
    traj = {}
    for name, att in (("kernel", None), ("plain", attention_reference)):
        p, opt = fresh(), build_optimizer("adam", 3e-4)
        state, gen = opt.init(p), torch.Generator(device="cuda").manual_seed(5)
        step = make_train_step(loss_fn(att), opt)
        traj[name] = []
        for _ in range(3):
            p, state, loss = step(p, state, x, None, None, gen)
            traj[name].append(float(loss))
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj["kernel"],
                                                  traj["plain"]))
    if not rel <= 1e-4:
        raise AssertionError(f"adam losses {traj}: differ by {rel} relative")
    log(f"[train-exactness] float32, 2 layers, B=4 S=1024: loss {lk:.7f} vs "
        f"plain {lp:.7f}; max |dgrad| / max |grad| {ratio:.3g} over "
        f"{len(gk)} leaves; 3 adam steps {traj['kernel']} vs "
        f"{traj['plain']} (max rel {rel:.3g}) [{card}]")


# BASELINE.md's transformer configuration, examples/bert_classifier.py at
# full width: BERT-base as a transformer_classifier, float32 (the estimator
# builds its Trainer with no compute dtype)
BERT_BASE = dict(vocab_size=30522, num_classes=2, hidden=768, num_layers=12,
                 num_heads=12, mlp_dim=3072, max_len=512, dropout=0.1)
EST_ROWS, EST_BATCH = 256, 32
# the fitted model's transform against a forward through the plain attention
# on the same weights: float32 (TF32 off), 12 layers; probs absolute, logits
# relative to max(1, their largest magnitude)
EST_PROBS_TOL = 1e-4


def synthetic_text(spark, n, seq_len, vocab):
    """``examples/bert_classifier.py``'s ``synthetic_text`` (copied: that
    example imports the JAX package): token ids with a "positive" marker
    pattern, ragged real lengths, the attention mask as its own column."""
    import numpy as np
    from sparkflow_tpu_torch.localml import Vectors
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        ids = rs.randint(10, vocab, seq_len)
        if label:
            ids[:: 7] = 3
        n_real = rs.randint(seq_len // 2, seq_len + 1)
        mask = np.zeros(seq_len)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append((float(label), Vectors.dense(ids.astype(float)),
                     Vectors.dense(mask)))
    return spark.createDataFrame(rows, ["label", "tokens", "mask"])


def _estimator_reference_model(card, tmp):
    """The reference suite's ``create_model`` on overlapping Gaussians
    (tests/test_estimator.py) through ``SparkAsyncDL`` on the card, in a
    ``Pipeline`` that is saved and loaded."""
    import numpy as np
    import sparkflow_tpu_torch.nn as nn
    from sparkflow_tpu_torch.graph_utils import build_graph
    from sparkflow_tpu_torch.localml import (LocalSession, Pipeline,
                                             PipelineModel, Vectors)
    from sparkflow_tpu_torch.pipeline_util import PysparkPipelineWrapper
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

    def create_model():
        x = nn.placeholder([None, 2], name="x")
        y = nn.placeholder([None, 1], name="y")
        layer1 = nn.dense(x, 12, activation="relu")
        layer2 = nn.dense(layer1, 5, activation="relu")
        out = nn.dense(layer2, 1, activation="sigmoid", name="outer")
        nn.sigmoid_cross_entropy(y, out)

    spark = LocalSession.builder.appName("chip-smoke").getOrCreate()
    rs = np.random.RandomState(12345)
    rows = []
    for _ in range(200):
        rows.append((1.0, Vectors.dense(rs.normal(2, 1, 2))))
        rows.append((0.0, Vectors.dense(rs.normal(-2, 1, 2))))
    df = spark.createDataFrame(rows, ["label", "features"])
    est = SparkAsyncDL(inputCol="features", tensorflowGraph=build_graph(
        create_model), tfInput="x:0", tfLabel="y:0",
        tfOutput="outer/Sigmoid:0", tfOptimizer="adam", tfLearningRate=.1,
        iters=35, partitions=2, predictionCol="predicted", labelCol="label")
    t0 = time.perf_counter()
    fitted = Pipeline(stages=[est]).fit(df)
    fit_s = time.perf_counter() - t0
    if fitted.stages[-1].getDevice() is not None:
        raise AssertionError("the fitted model left the card")
    preds = [r["predicted"] for r in fitted.transform(df).collect()]
    errors = sum(1 for p, r in zip(preds, df.collect())
                 if round(p) != r["label"])
    if not errors < 400:       # the reference's "better than all-wrong"
        raise AssertionError(f"{errors} errors in 400 rows")
    path = os.path.join(tmp, "pipeline")
    fitted.write().overwrite().save(path)
    loaded = PysparkPipelineWrapper.unwrap(PipelineModel.load(path))
    again = [r["predicted"] for r in loaded.transform(df).collect()]
    if again != preds:
        raise AssertionError("the loaded pipeline predicts otherwise")
    log(f"[estimator] nn create_model on the reference's Gaussians: fit "
        f"{fit_s:.2f} s (35 epochs x 4 batches), {errors} errors in 400 "
        f"(reference bar < 400); pipeline saved and loaded, predictions "
        f"identical [{card}]")


def _estimator_kernel_rows(card, masks):
    """Kernels 1-3 against their plain versions at the estimator's shape —
    float32, B=32, H=12, S=512, D=64, non-causal, the masks of the fit's
    first batch — with their times, bounds and SDPA's."""
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                         flash_bwd_dkv,
                                         flash_bwd_dkv_reference,
                                         flash_bwd_dq, flash_bwd_dq_reference)
    b, s = masks.shape
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, dout = _training_operands(b, s, torch.float32, g)
    out, lse = flash_attention(q, k, v, kv_mask=masks, return_lse=True)
    ref, ref_lse = attention_reference(q, k, v, kv_mask=masks,
                                       return_lse=True)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, dout, lse, delta, False)
    dq = flash_bwd_dq(*args, kv_mask=masks)
    dk, dv = flash_bwd_dkv(*args, kv_mask=masks)
    rdq = flash_bwd_dq_reference(*args, None, masks)
    rdk, rdv = flash_bwd_dkv_reference(*args, None, masks)
    torch.cuda.synchronize()
    errs = {"flash_fwd": max_err(out, ref),
            "flash_bwd_dq": max_err(dq, rdq),
            "flash_bwd_dkv": max(max_err(dk, rdk), max_err(dv, rdv))}
    tops = {"flash_fwd": 1.0, "flash_bwd_dq": float(rdq.abs().max()),
            "flash_bwd_dkv": float(torch.maximum(rdk.abs().max(),
                                                 rdv.abs().max()))}
    lse_err = max_err(lse, ref_lse)
    if not (errs["flash_fwd"] < FLASH_TOL["float32"]
            and lse_err < LSE_TOL["float32"]):
        raise AssertionError(f"flash_fwd at the estimator's shape: max |dO| "
                             f"{errs['flash_fwd']}, max |dlse| {lse_err}")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if not errs[name] <= BWD_TOL["float32"] * tops[name]:
            raise AssertionError(f"{name} at the estimator's shape: max |d| "
                                 f"{errs[name]} > {BWD_TOL['float32']} x "
                                 f"{tops[name]}")
    del ref, ref_lse, rdq, rdk, rdv
    # the (query, key) pairs this data needs: every query against the
    # unpadded keys of its row
    pairs = 12 * s * float(masks.sum())
    plane = q.numel() * 4
    stats = b * 12 * s * 4                     # one [B,H,S] float32
    mbytes = masks.numel() * 4
    attn_mask = (masks > 0)[:, None, None, :]
    sdpa_fwd = time_device([lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask)] * 10)
    sdpa_bwd = time_sdpa_backward(q, k, v, dout, masks, False)
    rows = {}
    for name, kern, plain, nbytes, products, lib in (
            ("flash_fwd",
             lambda: flash_attention(q, k, v, kv_mask=masks, return_lse=True),
             lambda: attention_reference(q, k, v, kv_mask=masks,
                                         return_lse=True),
             4 * plane + stats + mbytes, 2, sdpa_fwd),
            ("flash_bwd_dq", lambda: flash_bwd_dq(*args, kv_mask=masks),
             lambda: flash_bwd_dq_reference(*args, None, masks),
             5 * plane + 2 * stats + mbytes, 3, sdpa_bwd),
            ("flash_bwd_dkv", lambda: flash_bwd_dkv(*args, kv_mask=masks),
             lambda: flash_bwd_dkv_reference(*args, None, masks),
             6 * plane + 2 * stats + mbytes, 4, sdpa_bwd)):
        row = {"dtype": "float32", "B": b, "S": s, "causal": False,
               "max_abs_err": errs[name], "ms": time_device([kern] * 10),
               "plain_ms": time_device([plain] * 2), "library_ms": lib,
               "bytes": nbytes, "flops": products * 2 * 64 * pairs}
        _rate(row, "float32")
        rows[name] = row
        log(f"[estimator] {name} float32 B={b} H=12 S={s} D=64 padded keys: "
            f"err {row['max_abs_err']:.3g} ms {row['ms']:.5f} plain "
            f"{row['plain_ms']:.4f} bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}{_cuda_core_note(row)}) "
            f"{row['tflops']:.1f} TFLOP/s, "
            f"{row['bound_share']:.3f} of the bound; sdpa"
            f"{'' if name == 'flash_fwd' else '-bwd'} {lib:.5f} [{card}]")
    return rows


def phase_estimator(card, work):
    """The Spark ML estimator on the card: the reference's own nn model,
    then ``examples/bert_classifier.py`` at BERT-base width through
    ``Pipeline([OneHotEncoder, SparkAsyncDL]).fit`` and ``transform``; the
    probs against a plain-attention forward; kernels 1-3 at its shape.
    The fitted weights stay in ``work`` for the predict phase; returns the
    kernel rows and the fitted ``(modelJson, modelWeights)``."""
    import tempfile
    import numpy as np
    import torch
    import sparkflow_tpu_torch.core as core
    from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                             Pipeline)
    from sparkflow_tpu_torch.ml_util import resolve_weights
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.convert import list_to_params
    from sparkflow_tpu_torch.ops import (attention_reference, launch_counts,
                                         reset_launch_counts)
    from sparkflow_tpu_torch.tensorflow_async import (SparkAsyncDL,
                                                      SparkAsyncDLModel)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    with tempfile.TemporaryDirectory() as tmp:
        _estimator_reference_model(card, tmp)

        spark = LocalSession.builder.appName("bert-classifier").getOrCreate()
        seq, vocab = BERT_BASE["max_len"], BERT_BASE["vocab_size"]
        df = synthetic_text(spark, EST_ROWS, seq, vocab)
        spec = build_registry_spec("transformer_classifier", **BERT_BASE)
        losses = []
        est = SparkAsyncDL(
            inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
            tfLabel="y:0", tfOutput="pred:0", tfOptimizer="adam",
            tfLearningRate=3e-4, iters=1, miniBatchSize=EST_BATCH,
            labelCol="labels", predictionCol="predicted",
            extraInputCols="mask", extraTfInputs="attention_mask:0",
            weightsPath=os.path.join(work, "bert"))
        est.setLossCallback(lambda loss, it, part: losses.append(loss))
        pipe = Pipeline(stages=[
            OneHotEncoder(inputCol="label", outputCol="labels",
                          dropLast=False), est])
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        fitted, fit_s, gaps = _marked_fit(lambda: pipe.fit(df), True)
        fit_launches = {n: launch_counts()[n] for n in names}
        fit_peak = torch.cuda.max_memory_allocated() / 1e9
        steps = len(gaps) + 1
        want_steps = -(-EST_ROWS // EST_BATCH)
        if steps != want_steps or any(
                fit_launches[n] != 12 * want_steps for n in names):
            raise AssertionError(f"{steps} steps, launches {fit_launches}; "
                                 f"each kernel must launch 12 x "
                                 f"{want_steps} times")
        if not (losses and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"per-epoch losses {losses}: not finite")
        after_first_s = sum(gaps)

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t1 = time.perf_counter()
        preds = fitted.transform(df).collect()
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t1
        tr_launches = {n: launch_counts()[n] for n in names}
        tr_peak = torch.cuda.max_memory_allocated() / 1e9
        parts = df.rdd.getNumPartitions()
        if tr_launches != {"flash_fwd": 12 * parts, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}:
            raise AssertionError(f"transform launches {tr_launches}; want "
                                 f"12 x {parts} partitions of flash_fwd")
        if len(preds) != EST_ROWS or not all(
                r["predicted"] in (0.0, 1.0) for r in preds):
            raise AssertionError("transform: a row without a class")
        acc = float(np.mean([r["predicted"] == r["label"] for r in preds]))
        summary = {
            "config": "transformer_classifier BERT-base (768/12/12/3072, "
                      "vocab 30522, max_len 512), float32, adam 3e-4",
            "rows": EST_ROWS, "seq": seq, "batch": EST_BATCH, "steps": steps,
            "fit_s": fit_s,
            "train_examples_per_s_after_first":
                EST_BATCH * (steps - 1) / after_first_s,
            "steps_after_first_s": after_first_s,
            "transform_s": transform_s,
            "transform_examples_per_s": EST_ROWS / transform_s,
            "partitions": parts, "losses": losses, "train_accuracy": acc,
            "peak_mem_gb": {"fit": fit_peak, "transform": tr_peak},
            "launches": {"fit": fit_launches, "transform": tr_launches},
            "card": card}
        log("[estimator] " + json.dumps(summary))

        # the fitted weights through the plain attention on 8 rows: the
        # probs, and the logits, which the fitted model's near-certain
        # probs would not show a difference in
        model_stage = fitted.stages[-1]
        weights = model_stage.getOrDefault(model_stage.modelWeights)
        few = synthetic_text(spark, 8, seq, vocab)
        from sparkflow_tpu_torch.models import model_from_json
        model = model_from_json(spec)
        params = list_to_params(model, resolve_weights(weights))
        rows = few.collect()
        feeds = {"input_ids": torch.tensor(np.stack(
                     [r["tokens"].toArray() for r in rows]), device="cuda"),
                 "attention_mask": torch.tensor(np.stack(
                     [r["mask"].toArray() for r in rows]),
                     dtype=torch.float32, device="cuda")}
        with torch.inference_mode():
            want = model.apply(params, feeds, ["probs", "logits"],
                               attention=attention_reference)
        errs = {}
        for out in ("probs", "logits"):
            stage = SparkAsyncDLModel(
                inputCol="tokens", modelJson=spec, modelWeights=weights,
                tfInput="input_ids:0", tfOutput=out + ":0",
                predictionCol=out, extraInputCols="mask",
                extraTfInputs="attention_mask:0")
            got = np.stack([r[out].toArray()
                            for r in stage.transform(few).collect()])
            ref = want[out].cpu().numpy()
            tol = EST_PROBS_TOL * max(1.0, float(np.abs(ref).max()))
            errs[out] = float(np.abs(got - ref).max())
            if not (errs[out] <= tol and np.isfinite(got).all()):
                raise AssertionError(f"transform {out} differ from the plain "
                                     f"attention's by {errs[out]} (tol "
                                     f"{tol})")
        log(f"[estimator] transform (8 rows) vs plain attention on the same "
            f"weights, float32, TF32 off: probs max |d| {errs['probs']:.3g} "
            f"(tol {EST_PROBS_TOL}), logits max |d| {errs['logits']:.3g} "
            f"(tol {EST_PROBS_TOL} x max(1, max |logit|)) [{card}]")

        # one more training step of the fitted model under the profiler:
        # the estimator's step (float32, dropout 0.1, adam) on its first
        # batch
        first = df.collect()[:EST_BATCH]
        x = tuple(torch.tensor(np.stack([r[c].toArray() for r in first]),
                               dtype=torch.float32, device="cuda")
                  for c in ("tokens", "mask"))
        y = torch.tensor(np.eye(2)[[int(r["label"]) for r in first]],
                         dtype=torch.float32, device="cuda")
        m = torch.ones(EST_BATCH, device="cuda")
        ptree = model.load_params(params, trainable=True)
        from sparkflow_tpu_torch.optimizers import build_optimizer
        opt = build_optimizer("adam", 3e-4)
        state = opt.init(ptree)
        step = core.make_train_step(core.make_loss_fn(
            model, ["input_ids", "attention_mask"], "y"), opt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        ptree, state, _ = step(ptree, state, x, y, m, gen)      # warm
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ptree, state, loss = step(ptree, state, x, y, m, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t2) * 1e3
        prof_sum = _device_profile(prof, wall, 1, kernels=names)
        attn = sum(k["ms"] for k in prof_sum["kernels"].values())
        log("[estimator-profile] " + json.dumps(
            {"train_step": prof_sum, "attention_kernels_ms": attn,
             "attention_share_of_busy": attn / prof_sum["device_busy_ms"],
             "loss": float(loss), "card": card}))
        del model, params, ptree, state, fitted, pipe, est
        masks = torch.tensor(np.stack([r["mask"].toArray() for r in first]),
                             dtype=torch.float32, device="cuda")
    rows = _estimator_kernel_rows(card, masks)
    return (spec, weights), {n: {"launches": fit_launches[n],
                "transform_launches": tr_launches[n], **_pick(rows[n]),
                "bound_cuda_core_ms": rows[n]["bound_cuda_core_ms"],
                "max_abs_err": rows[n]["max_abs_err"],
                "tflops": rows[n]["tflops"],
                "bound_share": rows[n]["bound_share"]} for n in names}


# phase 13: README's "Serve it online" path at BERT-base, on phase 12's
# fitted weights: four arms, 8 client threads x 8 requests of 1-8 rows
PREDICT_MAX_BATCH = 32
PREDICT_CLIENTS, PREDICT_PER_CLIENT = 8, 8
PREDICT_ARMS = (("a", "float32", {}),
                ("b", "bfloat16", {"compute_dtype": "bfloat16"}),
                ("c", "weight_only", {"quantize": "weight_only"}),
                ("d", "dynamic", {"quantize": "dynamic"}))
# limits, absolute, per arm: "cpu" the card's probs against the same arm
# on the CPU port engine over PREDICT_CPU_ROWS rows of the burst, "logits"
# the same for logits over max(1, max |logit|), "replay" each served answer
# against the card engine's own predict of the burst's rows outside the
# server (other bucket mixes). Each is about 10x its reading on an H100
# 80GB HBM3 (700 W), but no probs limit is under 2e-7: float32 steps by
# 6e-8 just below 1.0, where these probs sit (readings: replay 3.8e-10 to
# 7.6e-10; cpu
# 2.3e-9 / 1.2e-6 / 1.7e-9 / 2.7e-7; logits 6.7e-7 / 2.4e-4 / 4.5e-7 /
# 1.5e-4 in (a) to (d))
PREDICT_TOL = {"a": {"cpu": 2e-7, "logits": 5e-6, "replay": 2e-7},
               "b": {"cpu": 1e-5, "logits": 2e-3, "replay": 2e-7},
               "c": {"cpu": 2e-7, "logits": 5e-6, "replay": 2e-7},
               "d": {"cpu": 3e-6, "logits": 1.5e-3, "replay": 2e-7}}
PREDICT_CPU_ROWS = 16
PREDICT_IN = ["input_ids:0", "attention_mask:0"]


def _predict_rows(n, seed):
    """``n`` rows of phase 12's ``synthetic_text`` kind: token ids with the
    marker pattern on about half, masks ragged over 256-512 live tokens."""
    import numpy as np
    rs = np.random.RandomState(seed)
    seq, vocab = BERT_BASE["max_len"], BERT_BASE["vocab_size"]
    ids = rs.randint(10, vocab, (n, seq))
    mask = np.zeros((n, seq), np.float32)
    for i in range(n):
        if rs.randint(0, 2):
            ids[i, ::7] = 3
        live = rs.randint(seq // 2, seq + 1)
        mask[i, :live] = 1.0
        ids[i, live:] = 0
    return ids.astype(np.int32), mask


def _predict_burst(eng, seed):
    """8 concurrent ``ServingClient.predict`` threads x 8 requests of 1-8
    rows through ``InferenceServer(max_delay_ms=2.0)``; the launch counters
    are zeroed just before and read just after."""
    import numpy as np
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import InferenceServer, ServingClient
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 9, (PREDICT_CLIENTS, PREDICT_PER_CLIENT))
    reqs = [[_predict_rows(int(n), seed * 1000 + 10 * c + j)
             for j, n in enumerate(row)] for c, row in enumerate(sizes)]
    lat, results, errors = [], {}, []
    srv = InferenceServer(eng, max_delay_ms=2.0, memory_watch=False).start()
    try:
        def client(c):
            try:
                cli = ServingClient(srv.url, timeout=600)
                for j, (ids, mask) in enumerate(reqs[c]):
                    t = time.perf_counter()
                    out = cli.predict({"input_ids": ids,
                                       "attention_mask": mask})
                    lat.append((time.perf_counter() - t) * 1e3)
                    results[(c, j)] = np.asarray(out, np.float64)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        calls0 = eng.metrics.histograms().get(
            "serving/engine_batch_rows", {}).get("count", 0)
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PREDICT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        if errors:
            raise errors[0]
        hist = ServingClient(srv.url).metrics()["histograms"]
        health = ServingClient(srv.url).healthz()
    finally:
        srv.stop()
    calls = hist["serving/engine_batch_rows"]["count"] - calls0
    for (c, j), out in results.items():
        n = reqs[c][j][0].shape[0]
        if out.shape != (n, 2) or not np.isfinite(out).all() or \
                np.abs(out.sum(-1) - 1.0).max() > 1e-3:
            raise AssertionError(f"request {c}/{j}: probs {out}")
    if len(results) != PREDICT_CLIENTS * PREDICT_PER_CLIENT:
        raise AssertionError(f"{len(results)} answers")
    layers = BERT_BASE["num_layers"]
    others = {k: v for k, v in launches.items() if k != "flash_fwd"}
    if launches["flash_fwd"] != layers * calls or any(others.values()):
        raise AssertionError(f"{calls} bucket calls, launches {launches}: "
                             f"want flash_fwd {layers} a call and no other")
    rows = int(sizes.sum())
    # the burst's rows and answers in request order, for the checks
    keys = sorted(results)
    served = (tuple(np.concatenate([reqs[c][j][i] for c, j in keys])
                    for i in range(2)),
              np.concatenate([results[k] for k in keys]))
    return served, {"requests": len(results), "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall, "bucket_calls": calls,
            "request_ms_p50": _pct(lat, 50), "request_ms_p95": _pct(lat, 95),
            "server_request_ms": {k: hist["serving/request_latency_ms"][k]
                                  for k in ("p50", "p95", "p99")},
            "batch_rows_mean": hist["serving/engine_batch_rows"]["mean"],
            "padding_waste_mean": hist["serving/padding_waste"]["mean"],
            "healthz_status": health["status"],
            "launches": launches}


def _bucket_ms(eng, bucket, reps=5):
    """ms of one eager bucket call (CUDA events around ``_apply``, inputs
    copied in as a request's are), median of ``reps`` after a warm call."""
    import torch
    xs = _predict_rows(bucket, 7)
    params = eng._snapshot_params()
    times = []
    for i in range(reps + 1):
        a, b = _events()
        a.record()
        eng._apply(params, xs)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def _bucket_profile(eng):
    """``torch.profiler`` over one full-bucket call (32 rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    xs = _predict_rows(PREDICT_MAX_BATCH, 8)
    params = eng._snapshot_params()
    eng._apply(params, xs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._apply(params, xs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return _device_profile(prof, wall, 1, kernels=("flash_fwd",))


def _predict_flash_row(card):
    """``flash_fwd`` at the largest predict bucket in bf16: B=32, H=12,
    S=512, D=64, non-causal, a ragged key mask; against the plain version,
    beside its bound and SDPA's time."""
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import attention_reference, flash_attention
    b, s = PREDICT_MAX_BATCH, BERT_BASE["max_len"]
    masks = torch.tensor(_predict_rows(b, 3)[1], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(b, 12, s, 64, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v, kv_mask=masks)
    ref = attention_reference(q, k, v, kv_mask=masks)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if not err < FLASH_TOL["bfloat16"]:
        raise AssertionError(f"flash_fwd bf16 at the predict bucket: max "
                             f"|dO| {err}")
    attn_mask = (masks > 0)[:, None, None, :]
    pairs = 12 * s * float(masks.sum())
    # the bytes this data needs: Q and O whole; K and V of each batch row
    # up to its last live key, as ``pairs`` counts only live keys
    live = masks > 0
    last = torch.where(live.any(-1), s - live.flip(-1).int().argmax(-1), 0)
    kv_bytes = 2 * 12 * 64 * q.element_size() * float(last.sum())
    row = {"dtype": "bfloat16", "B": b, "S": s, "causal": False,
           "max_abs_err": err,
           "ms": time_device([lambda: flash_attention(q, k, v,
                                                      kv_mask=masks)] * 10),
           "plain_ms": time_device([lambda: attention_reference(
               q, k, v, kv_mask=masks)] * 2),
           "library_ms": time_device([lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=attn_mask)] * 10),
           "bytes": 2 * q.numel() * q.element_size() + kv_bytes
                    + masks.numel() * 4,
           "flops": 2 * 2 * 64 * pairs}
    _rate(row, "bfloat16")
    log(f"[predict] flash_fwd bf16 B={b} H=12 S={s} D=64 padded keys: err "
        f"{err:.3g} ms {row['ms']:.5f} plain {row['plain_ms']:.4f} sdpa "
        f"{row['library_ms']:.5f} bound {row['bound_ms']:.5f} "
        f"({row['bound_by']}) {row['tflops']:.1f} TFLOP/s, "
        f"{row['bound_share']:.3f} of the bound [{card}]")
    return row


def _arm_outputs(eng, xs):
    """probs and logits of the rows ``xs`` through ``eng``'s model and
    serving params, on its device, as float64 numpy."""
    import numpy as np
    import torch
    feeds = {k: torch.as_tensor(a, device=eng.device)
             for k, a in zip(eng._in_keys, xs)}
    with torch.inference_mode():
        out = eng.model.apply(eng._snapshot_params(), feeds,
                              ["probs", "logits"], train=False)
    return {k: v.float().cpu().numpy().astype(np.float64)
            for k, v in out.items()}


def _predict_checks(tag, eng, spec, weights, kw, extra, rows, served):
    """One arm's answers held to ``PREDICT_TOL[tag]``: every served answer
    against the card engine's own predict of the same rows (a row sent
    back to the wrong request, or a padding row leaking into a real one,
    shows there; the rows must not all win the same class, so a mix-up
    cannot hide); a seeded sample of ``PREDICT_CPU_ROWS`` burst rows
    against the same arm on the CPU port engine, probs and logits; an int8
    arm's ``q8``/``scale`` built on the card bit-equal to the CPU's."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.serving import InferenceEngine
    tol = PREDICT_TOL[tag]
    replay = eng.predict(rows)
    r_err = float(np.abs(served - replay).max())
    wins = np.bincount(replay.argmax(-1), minlength=2)
    pick = np.sort(np.random.default_rng(ord(tag)).choice(
        len(served), PREDICT_CPU_ROWS, replace=False))
    sample = tuple(a[pick] for a in rows)
    t0 = time.perf_counter()
    cpu = InferenceEngine(spec, weights, device="cpu", warmup=False,
                          **dict(kw, max_batch=2), **extra)
    got, want = _arm_outputs(eng, sample), _arm_outputs(cpu, sample)
    cpu_s = time.perf_counter() - t0
    p_err = float(np.abs(got["probs"] - want["probs"]).max())
    top = max(1.0, float(np.abs(want["logits"]).max()))
    l_err = float(np.abs(got["logits"] - want["logits"]).max()) / top
    errs = {"replay_max_abs_err": r_err, "replay_wins": wins.tolist(),
            "cpu_rows": PREDICT_CPU_ROWS, "cpu_check_s": cpu_s,
            "cpu_probs_max_abs_err": p_err,
            "cpu_logits_max_abs_err_over_top": l_err, "logits_top": top}
    log(f"[predict] arm ({tag}) checks: " + json.dumps(errs))
    if not (r_err < tol["replay"] and wins.min() > 0
            and np.isfinite(served).all()):
        raise AssertionError(f"arm ({tag}): served answers vs the engine's "
                             f"replay max |d| {r_err} (tol {tol['replay']}), "
                             f"wins per class {wins.tolist()}")
    if not (p_err < tol["cpu"] and l_err < tol["logits"]
            and np.isfinite(got["logits"]).all()):
        raise AssertionError(f"arm ({tag}): card vs CPU probs max |d| "
                             f"{p_err} (tol {tol['cpu']}), logits max |d| / "
                             f"{top} {l_err} (tol {tol['logits']})")
    if "quantize" in extra:
        for ln, layer in eng._snapshot_params().items():
            for pn, t in layer.items():
                if not torch.equal(t.cpu(), cpu._snapshot_params()[ln][pn]):
                    raise AssertionError(f"arm ({tag}): {ln}/{pn} built on "
                                         f"the card differs from the CPU's")
    return errs


def phase_predict(card, spec, weights, work):
    """The predict plane on the card: ``InferenceEngine(modelJson,
    modelWeights)`` -> ``InferenceServer`` -> ``ServingClient.predict`` in
    four arms on phase 12's fitted BERT-base; each arm's answers against
    its own replay and the CPU port engine (``_predict_checks``), arm (a)
    against the plain attention; then a port
    ``Trainer(publish_to=)`` and a ``WeightWatcher`` swap."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ml_util import resolve_weights
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.serving import (InferenceEngine, WeightStore,
                                             WeightWatcher)
    from sparkflow_tpu_torch.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(input_name=PREDICT_IN, output_name="probs:0",
              max_batch=PREDICT_MAX_BATCH)
    arms, launches, eng_a = {}, {}, None
    for tag, name, extra in PREDICT_ARMS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngine(spec, weights, **kw, **extra)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        (rows, served), burst = _predict_burst(eng, seed=ord(tag))
        launches[tag] = burst["launches"]["flash_fwd"]
        buckets = {b: _bucket_ms(eng, b) for b in (1, 8, PREDICT_MAX_BATCH)}
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _bucket_profile(eng)
        errs = _predict_checks(tag, eng, spec, weights, kw, extra, rows,
                               served)
        summary = {"arm": tag, "serving": name, "engine_build_s": build_s,
                   **burst, "bucket_ms": buckets, "peak_mem_gb": peak,
                   **errs, "tol": PREDICT_TOL[tag],
                   "bucket32_profile": prof, "stats": eng.stats(),
                   "card": card}
        log("[predict] " + json.dumps(summary))
        arms[tag] = summary
        if tag == "a":
            eng_a = eng
        else:
            del eng
    torch.cuda.empty_cache()

    # arm (a) against a forward through the plain attention, TF32 off
    rows = _predict_rows(8, 5)
    got = eng_a.predict(rows)
    feeds = {"input_ids": torch.tensor(rows[0], device="cuda"),
             "attention_mask": torch.tensor(rows[1], device="cuda")}
    with torch.inference_mode():
        ref = eng_a.model.apply(eng_a._snapshot_params(), feeds,
                                ["probs", "logits"],
                                attention=attention_reference)
        mine = eng_a.model.apply(eng_a._snapshot_params(), feeds,
                                 ["logits"])["logits"]
    p_err = float(np.abs(got - ref["probs"].cpu().numpy()).max())
    top = max(1.0, float(ref["logits"].abs().max()))
    l_err = float((mine - ref["logits"]).abs().max())
    if not (p_err < EST_PROBS_TOL and l_err < EST_PROBS_TOL * top):
        raise AssertionError(f"arm (a) vs plain attention: probs {p_err}, "
                             f"logits {l_err} (tol {EST_PROBS_TOL} x {top})")
    log(f"[predict] arm (a) vs plain attention (8 rows, float32, TF32 off): "
        f"probs max |d| {p_err:.3g}, logits max |d| {l_err:.3g} (tol "
        f"{EST_PROBS_TOL} x max(1, max |logit|)) [{card}]")

    # live publication: a port Trainer publishes, the watcher swaps arm (a)
    store = WeightStore(os.path.join(work, "store"))
    w = resolve_weights(weights)
    specs = eng_a.model.param_specs()
    it = iter(w)
    init = {ln: {pn: next(it) for pn in ps} for ln, ps in specs.items()}
    ids, mask = _predict_rows(2 * EST_BATCH, 11)
    labels = np.eye(2, dtype=np.float32)[np.random.RandomState(12).randint(
        0, 2, 2 * EST_BATCH)]
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 optimizer="adam", learning_rate=3e-4, iters=1,
                 mini_batch_size=EST_BATCH, shuffle_per_iter=False,
                 publish_to=store)
    t0 = time.perf_counter()
    res = tr.fit((ids.astype(np.float32), mask), labels, init_params=init)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if store.all_versions() != [1] or not all(
            math.isfinite(x) for x in res.losses):
        raise AssertionError(f"published {store.all_versions()}, losses "
                             f"{res.losses}")
    del tr, res
    before = eng_a.predict(rows)
    watcher = WeightWatcher(store, [eng_a])
    if not watcher.poll_once() or eng_a.serving_version() != 1:
        raise AssertionError(f"watcher did not swap: {watcher.stats()}")
    version, tree = store.load(like=eng_a.weights_template())
    fresh = InferenceEngine(spec, tree, **kw)
    after, want = eng_a.predict(rows), fresh.predict(rows)
    if not np.array_equal(after, want):
        raise AssertionError(f"swapped engine vs fresh engine on version "
                             f"{version}: max |d| "
                             f"{np.abs(after - want).max()}")
    moved = float(np.abs(after - before).max())
    log("[predict-publish] " + json.dumps(
        {"trainer_steps": 2, "train_s": train_s,
         "versions": store.all_versions(), "served_version":
         eng_a.serving_version(), "watcher": watcher.stats(),
         "probs_moved_by_swap": moved,
         "swapped_equals_fresh_engine": True, "card": card}))
    del eng_a, fresh
    torch.cuda.empty_cache()
    row = _predict_flash_row(card)
    return {"launches": launches, "bf16_B32_S512": {
        **_pick(row), "max_abs_err": row["max_abs_err"],
        "tflops": row["tflops"], "bound_share": row["bound_share"]}}


# phase 14: resilience and stream — README's text pipeline at BERT-base width
# through the estimator's stream mode with checkpoints, Trainer.fit preempted,
# crashed and resumed, one fit traced, and remat="dots" at the training shape
# (c) runs 2 epochs: with 3 the phase took over the ~90 s it is allowed
RES_ROWS, RES_BATCH, RES_EPOCHS = 256, 32, 2
RES_LEN = BERT_BASE["max_len"]
RES_SAMPLE = 32           # rows whose native ids are held to the fallback's
# the resumed weights equal the uninterrupted fit's bit for bit (no kernel
# uses atomics); this relative bound is a fallback that is never used
# silently: a run that needs it prints its delta
RESUME_REL_TOL = 1e-6
SPAN_TOL = 0.10           # phase sums against the fit's host wall time


def synthetic_reviews(n, seed):
    """Long reviews in the shape of ``examples/text_classifier.py``'s
    ``synthetic_reviews`` (filler words, a sentiment marker inserted), 200
    to 700 words each: the filler from a seeded 20,000-word pseudo-lexicon
    drawn by a Zipf law, every twelfth word carrying punctuation, the
    marker inserted three times. Returns ``[(label, text)]``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    pos = ["wonderful", "great", "loved", "excellent", "delightful"]
    neg = ["terrible", "awful", "hated", "boring", "dreadful"]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lexicon = np.array(["".join(rs.choice(letters, rs.randint(2, 10)))
                        for _ in range(20000)])
    p = 1.0 / np.arange(1, len(lexicon) + 1)
    p /= p.sum()
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        k = rs.randint(200, 701)
        words = list(lexicon[rs.choice(len(lexicon), k, p=p)])
        for j in rs.choice(k, k // 12, replace=False):
            words[j] += ",.!?"[rs.randint(4)]
        for _ in range(3):
            words.insert(rs.randint(0, len(words)),
                         (pos if label else neg)[rs.randint(0, 5)])
        rows.append((float(label), " ".join(words)))
    return rows


def _text_front(card, texts):
    """(a) The vocabulary over the corpus, the native tokenizer's ids and
    masks against the pure-Python fallback's on a sample, encode rates."""
    import numpy as np
    from sparkflow_tpu_torch.native.build import load_library
    from sparkflow_tpu_torch.utils.text import WordpieceTokenizer, build_vocab
    t0 = time.perf_counter()
    vocab = build_vocab(texts)
    vocab_s = time.perf_counter() - t0
    native = load_library() is not None
    if not native:
        raise AssertionError("the native data-plane library did not build "
                             "or load (g++): the C++ path is the one "
                             "measured")
    tok, plain = (WordpieceTokenizer(vocab),
                  WordpieceTokenizer(vocab, use_native=False))
    t0 = time.perf_counter()
    ids, mask = tok.encode_batch(texts, RES_LEN)
    native_s = time.perf_counter() - t0
    sample = texts[:RES_SAMPLE]
    t0 = time.perf_counter()
    pids, pmask = plain.encode_batch(sample, RES_LEN)
    plain_s = time.perf_counter() - t0
    if not (np.array_equal(ids[:RES_SAMPLE], pids)
            and np.array_equal(mask[:RES_SAMPLE], pmask)):
        raise AssertionError("native WordPiece ids or masks differ from the "
                             "pure-Python fallback's")
    live = mask.sum(1)
    info = {"native_library_loaded": native, "vocab": len(vocab),
            "vocab_s": vocab_s, "rows": len(texts), "max_len": RES_LEN,
            "truncated_rows": int((live == RES_LEN).sum()),
            "live_tokens_min_median": [int(live.min()),
                                       int(np.median(live))],
            "unk_share": float((ids == tok.unk_id).sum() / live.sum()),
            "encode_rows_per_s_native": len(texts) / native_s,
            "encode_rows_per_s_fallback": RES_SAMPLE / plain_s,
            "native_equals_fallback_rows": RES_SAMPLE, "card": card}
    log("[resilience-text] " + json.dumps(info))
    return vocab, info


class _SaveClock:
    """Times every ``CheckpointManager.save`` while active (host ms, the
    state's copy off the card included) and reads each save's bytes from
    its manifest."""

    def __init__(self):
        self.saves = []

    def __enter__(self):
        from sparkflow_tpu_torch import checkpoint as ckpt
        self._cls, self._orig = ckpt.CheckpointManager, \
            ckpt.CheckpointManager.save
        orig, saves = self._orig, self.saves

        def save(mgr, step, state):
            t0 = time.perf_counter()
            orig(mgr, step, state)
            ms = (time.perf_counter() - t0) * 1e3
            files = (mgr._manifest(step) or {}).get("files", {})
            saves.append({"step": int(step), "ms": ms,
                          "bytes": sum(f["bytes"] for f in files.values())})

        self._cls.save = save
        return self

    def __exit__(self, *exc):
        self._cls.save = self._orig
        return False


def _stream_fit(card, rows, vocab, spec, work):
    """(b) ``Pipeline([WordpieceEncoder, OneHotEncoder, SparkAsyncDL(
    fitMode="stream", checkpointDir, checkpointEvery=4)])`` over the corpus,
    then its transform."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.checkpoint import CheckpointManager
    from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                             Pipeline, WordpieceEncoder)
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    spark = LocalSession.builder.appName("text-stream").getOrCreate()
    df = spark.createDataFrame(rows, ["label", "text"])
    ck = os.path.join(work, "stream-ckpt")
    marks = []
    est = SparkAsyncDL(
        inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
        tfLabel="y:0", tfOutput="pred:0", tfOptimizer="adam",
        tfLearningRate=3e-4, iters=1, miniBatchSize=RES_BATCH,
        labelCol="labels", predictionCol="predicted", fitMode="stream",
        checkpointDir=ck, checkpointEvery=4, extraInputCols="mask",
        extraTfInputs="attention_mask:0",
        # an npz side file: inline, 110 M weights would be ~2 GB of JSON
        weightsPath=os.path.join(work, "text-bert"))
    est.setLossCallback(
        lambda loss, step, part: marks.append((time.perf_counter(), loss)))
    pipe = Pipeline(stages=[
        WordpieceEncoder(inputCol="text", outputCol="tokens", maskCol="mask",
                         maxLen=RES_LEN, vocab=vocab),
        OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False),
        est])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _SaveClock() as clock:
        fitted = pipe.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: launch_counts()[n] for n in names}
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = RES_ROWS // RES_BATCH
    losses = [loss for _t, loss in marks]
    if len(marks) != steps or any(launches[n] != 12 * steps for n in names):
        raise AssertionError(f"{len(marks)} steps, launches {launches}: each "
                             f"flash kernel must launch 12 x {steps} times")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"stream losses {losses}: not finite")
    mgr = CheckpointManager(ck)
    if mgr.all_steps() != [4, 8] or not all(
            mgr.verify_step(s) is True for s in (4, 8)):
        raise AssertionError(f"stream checkpoints {mgr.all_steps()}: steps "
                             f"4 and 8 must verify by their manifests")
    saves = clock.saves
    if [s["step"] for s in saves] != [4, 8]:
        raise AssertionError(f"saves {saves}")
    span = marks[-1][0] - marks[0][0]                   # steps 2 .. 8
    in_span = sum(s["ms"] for s in saves if s["step"] < steps) / 1e3
    t1 = time.perf_counter()
    preds = fitted.transform(df).collect()
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t1
    acc = float(np.mean([r["predicted"] == r["label"] for r in preds]))
    info = {"rows": RES_ROWS, "batch": RES_BATCH, "steps": steps,
            "fit_s": fit_s, "losses": losses,
            "train_examples_per_s_steps_2_to_8": RES_BATCH * (steps - 1)
            / span,
            "train_examples_per_s_steps_2_to_8_without_saves":
                RES_BATCH * (steps - 1) / (span - in_span),
            "saves": saves, "launches": launches, "peak_mem_gb": peak,
            "transform_s": transform_s, "train_accuracy": acc,
            "card": card}
    log("[resilience-stream] " + json.dumps(info))
    shutil.rmtree(ck, ignore_errors=True)
    return info


def _resume_delta(tr, base_weights):
    """``(bit_equal, max |a - b| / max |b|)`` of a trainer's final weights
    against the uninterrupted fit's."""
    import numpy as np
    got = tr.weights_list()
    same = all(np.array_equal(a, b) for a, b in zip(got, base_weights))
    rel = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-30)
              for a, b in zip(got, base_weights))
    return same, rel


def _preempt_and_resume(card, x, labels, spec, work):
    """(c) ``Trainer.fit`` (collect) over the encoded rows, 2 epochs of 8
    steps, ``checkpoint_every=1``: an uninterrupted fit, traced (d); a fit
    preempted in epoch 1 (the guard is read at each epoch's start, so a
    SIGTERM in the last epoch would not stop it) and fitted again; a fit
    crashed in epoch 2 and resumed in the fit."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.resilience import faults
    from sparkflow_tpu_torch.trainer import Trainer
    from sparkflow_tpu_torch.utils.flops import device_peak_flops

    def trainer(name, cb, retries=0):
        return Trainer(spec, ["input_ids", "attention_mask"], "y",
                       optimizer="adam", learning_rate=3e-4,
                       iters=RES_EPOCHS, mini_batch_size=RES_BATCH, seed=14,
                       checkpoint_dir=os.path.join(work, name),
                       checkpoint_every=1, resume_retries=retries,
                       loss_callback=cb)

    out = {}
    base = trainer("base", lambda *a: None)
    trace = os.path.join(work, "fit_trace.json")
    with _SaveClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = base.fit(x, labels, trace_spans=trace)
        wall = time.perf_counter() - t0
    want = base.weights_list()
    stats = base.last_step_stats
    with open(base.last_trace_path) as f:
        events = json.load(f)["traceEvents"]
    phases = stats["phase_totals_s"]
    spent = sum(phases.values())
    if not (res.completed and abs(spent - wall) <= SPAN_TOL * wall
            and events):
        raise AssertionError(f"traced fit: phases sum {spent} s against "
                             f"{wall} s of wall time, {len(events)} trace "
                             f"events")
    ck_ms = [s["ms"] for s in clock.saves]
    out["uninterrupted"] = {
        "epochs": RES_EPOCHS, "steps": RES_EPOCHS * RES_ROWS // RES_BATCH,
        "losses": res.losses, "fit_wall_s": wall,
        "phase_totals_s": phases, "phase_counts": stats["phase_counts"],
        "phase_sum_over_wall": spent / wall,
        "checkpoint_share_of_wall": phases.get("checkpoint", 0.0) / wall,
        "save_ms": ck_ms, "save_bytes": [s["bytes"] for s in clock.saves],
        "examples_per_s": stats["examples_per_sec"],
        "flops_per_step": stats.get("flops_per_step"),
        "flops_per_s": stats.get("flops_per_sec"),
        "mfu": stats.get("mfu"), "mfu_peak_flops": device_peak_flops(),
        "mfu_note": "against the dense bf16 peak (the JAX package's "
                    "convention); the step runs float32 with TF32 off",
        "trace_events": len(events)}
    shutil.rmtree(os.path.join(work, "base"), ignore_errors=True)
    del base

    tr = trainer("preempt", faults.sigterm_at(1))
    first = tr.fit(x, labels)
    again = tr.fit(x, labels)
    if first.stop_reason != "preempted" or not again.completed:
        raise AssertionError(f"preempted fit: {first.stop_reason}, then "
                             f"{again.stop_reason}")
    same, rel = _resume_delta(tr, want)
    out["preempted"] = {"stop_reason": first.stop_reason,
                        "epochs_before": len(first.losses),
                        "epochs_after": len(again.losses),
                        "weights_bit_equal": same, "max_rel_delta": rel}
    shutil.rmtree(os.path.join(work, "preempt"), ignore_errors=True)
    del tr

    crash = faults.crash_at(2)
    tr = trainer("crash", crash, retries=1)
    res = tr.fit(x, labels)
    if crash.fired != 1 or not res.completed:
        raise AssertionError(f"crashed fit: fired {crash.fired}, "
                             f"{res.stop_reason}")
    same_c, rel_c = _resume_delta(tr, want)
    out["crashed"] = {"fault_fired": crash.fired, "completed": res.completed,
                      "weights_bit_equal": same_c, "max_rel_delta": rel_c}
    shutil.rmtree(os.path.join(work, "crash"), ignore_errors=True)
    del tr
    out["card"] = card
    log("[resilience-resume] " + json.dumps(out))
    for k in ("preempted", "crashed"):
        if not (out[k]["weights_bit_equal"]
                or out[k]["max_rel_delta"] <= RESUME_REL_TOL):
            raise AssertionError(f"{k} fit resumed to weights {out[k]} away "
                                 f"from the uninterrupted fit's")
    return out


def _remat_modes(card):
    """(e) One training step (forward and backward) of the GPT-2-small-width
    bf16 ``transformer_lm`` at batch 8 x 1024, dropout 0.1, in each
    ``remat`` mode: peak memory above the step's start, step ms (CUDA
    events), flash_fwd launches, then one more step's device busy time
    under the profiler; "dots" and "full" against False."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.optimizers import tree_leaves, tree_map
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1000, (8, 1024)), device="cuda")
    out, ref = {}, None
    for remat in (False, "dots", "full"):
        model = model_from_json(_train_spec(remat=remat), "bfloat16")
        params = model.load_params(tree_map(
            lambda a: a.detach().clone(), model.init(seed=0)), trainable=True)
        leaves = tree_leaves(params)
        gen = torch.Generator(device="cuda")

        def step():
            gen.manual_seed(1)
            loss = model.loss_vector(params, {"input_ids": toks}, train=True,
                                     generator=gen).mean()
            return loss, torch.autograd.grad(loss, leaves)

        step()                                                   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_launch_counts()
        a, b = _events()
        a.record()
        loss, grads = step()
        b.record()
        b.synchronize()
        row = {"step_ms": a.elapsed_time(b),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_above_start_gb": (torch.cuda.max_memory_allocated()
                                       - start) / 1e9,
               "flash_fwd_launches": launch_counts()["flash_fwd"],
               "flash_bwd_launches": launch_counts()["flash_bwd_dq"],
               "loss": float(loss)}
        # one more step under the profiler: the card's busy time against
        # the host's (the selective policy runs Python for every op)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        prof_sum = _device_profile(prof, wall, 1)
        row.update(profiled_wall_ms=prof_sum["wall_ms"],
                   device_busy_ms=prof_sum["device_busy_ms"],
                   device_idle_share=prof_sum["device_idle_share"],
                   device_ops=prof_sum["device_ops"])
        grads = [g.float().cpu() for g in grads]
        if ref is None:
            ref = (float(loss), grads)
        else:
            errs = [float((g - r).abs().max()) / max(float(r.abs().max()),
                                                     1e-30)
                    for g, r in zip(grads, ref[1])]
            row["loss_delta"] = abs(float(loss) - ref[0])
            row["max_grad_err_over_max_grad"] = max(errs)
            row["bit_equal_to_no_remat"] = (
                row["loss_delta"] == 0 and max(errs) == 0)
            if not (row["loss_delta"] <= BWD_TOL["bfloat16"] * abs(ref[0])
                    and max(errs) <= BWD_TOL["bfloat16"]):
                raise AssertionError(f"remat={remat!r} against remat=False: "
                                     f"{row}")
        out[str(remat)] = row
        del model, params, leaves, grads, loss
        torch.cuda.empty_cache()
    want = {"False": 12, "dots": 24, "full": 24}
    got = {k: out[k]["flash_fwd_launches"] for k in want}
    peaks = [out[k]["peak_above_start_gb"] for k in ("full", "dots", "False")]
    out["card"] = card
    log("[resilience-remat] " + json.dumps(out))
    if got != want or not peaks[0] < peaks[1] < peaks[2]:
        raise AssertionError(f"flash_fwd launches {got} (want {want}); peak "
                             f"memory full / dots / False {peaks} must "
                             f"rise in that order")
    return got


def phase_resilience(card, work):
    """Phase 14: (a) the text front, (b) the stream fit through the
    estimator with checkpoints, (c) preempted and crashed fits resumed, (d)
    the traced fit's spans and MFU, (e) ``remat="dots"``. Returns the
    launch counts for the kernels line."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.utils.text import WordpieceTokenizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = synthetic_reviews(RES_ROWS, seed=14)
    texts = [t for _l, t in rows]
    vocab, _text = _text_front(card, texts)
    spec = build_registry_spec("transformer_classifier", **BERT_BASE)
    stream = _stream_fit(card, rows, vocab, spec, work)
    ids, mask = WordpieceTokenizer(vocab).encode_batch(texts, RES_LEN)
    labels = np.eye(2, dtype=np.float32)[[int(l) for l, _t in rows]]
    resume = _preempt_and_resume(card, (ids.astype(np.float32), mask),
                                 labels, spec, work)
    remat = _remat_modes(card)
    return {"stream_fit": stream["launches"],
            "uninterrupted_fit_steps": resume["uninterrupted"]["steps"],
            "remat_flash_fwd_per_step": remat}


# phase 15: the serving fleet — README's "Serve from a fleet" at BERT-base
# and GPT-2-small width. Replicas are subprocesses (this script re-invoked
# with ``--replica KIND PORT``), each on the card in a CUDA context of its
# own, sharing the card's SMs: the phase measures routing, recovery, canary
# and boot time, not scale-out throughput.
#
# bands on the router's request p95: a burst queues behind bucket-32 calls
# (81 ms in float32 on an H100 80GB HBM3, 700 W; PERF.md section 5), a
# one-row trickle does not
FLEET_TARGETS = dict(min_replicas=1, max_replicas=3, queue_wait_high_ms=100.0,
                     queue_wait_low_ms=40.0, up_cooldown_s=2.0,
                     down_cooldown_s=3.0, max_step_up=1)
FLEET_WORKERS = 12         # closed-loop burst clients, 1-8 rows a request
FLEET_HEALTH_S = 120.0     # one replica's boot, at most
GEN_LENS = (64, 100, 160, 255, 300, 450, 512, 700)
GEN_NEW = 32
CANARY_MIN_REQUESTS = 10
FLEET_POOL_ROWS = 128     # distinct rows the fleet's requests draw from
_FLEET_PROCS = []          # every replica process the phase started


def _no_nvcc_path() -> str:
    """``PATH`` without any directory that holds an ``nvcc``."""
    return os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))


def _launch_replica(cfg: dict, port: int, launched: dict):
    """Start one replica on ``port``: a fresh empty kernel build directory,
    no ``nvcc`` on ``PATH`` or under ``CUDA_HOME``."""
    path = os.path.join(cfg["out"], f"cfg-{port}.json")
    kdir = os.path.join(cfg["out"], f"kernels-{port}")
    os.makedirs(kdir)
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH=_no_nvcc_path(), CUDA_HOME=kdir,
               SPARKFLOW_TORCH_KERNEL_DIR=kdir, CHIP_SMOKE_REPLICA=path)
    launched[port] = time.time()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--replica",
         cfg["kind"], str(port)], env=env)
    _FLEET_PROCS.append(proc)
    return proc


def _write_status(path, status):
    tmp = f"{path}.{threading.get_ident()}.tmp"   # the server's threads too
    with open(tmp, "w") as f:
        json.dump(status, f)
    os.replace(tmp, path)


def _meta_like(model):
    """The model's parameter tree as ``meta`` tensors: the template a
    ``WeightStore`` load pins shapes to."""
    import torch
    return {ln: {pn: torch.empty(shape, device="meta")
                 for pn, (shape, _init) in layer.items()}
            for ln, layer in model.param_specs().items()}


def _replica_predict_engine(cfg, status):
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.serving import (InferenceEngine, WeightStore,
                                             WeightWatcher)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(cfg["spec"]) as f:
        spec = f.read()
    model = model_from_json(spec, device=cfg["device"])
    store = WeightStore(cfg["store"])
    version, tree = store.load(version=cfg["version"],
                               like=_meta_like(model))
    status["t_weights"] = time.time()
    eng = InferenceEngine(model, tree, input_name=PREDICT_IN,
                          output_name="probs:0", max_batch=PREDICT_MAX_BATCH,
                          executable_dir=cfg["exe"],
                          compile_cache_dir=cfg["compile_cache"])
    # serve as the store's version, so the canary sees one incumbent
    eng.swap_params(tree, version=version)
    watcher = (WeightWatcher(store, [eng], poll_interval_s=0.2)
               if cfg["watch"] else None)
    return eng, watcher


def run_replica(kind: str, port: int) -> int:
    """One fleet replica (``python3 chip_smoke.py --replica KIND PORT``):
    the port's ``InferenceServer`` over a BERT-base predict engine or a
    GPT-2-small decode engine, until SIGTERM drains it. Its status file
    carries the boot tier, the ready and first-answer times and, at exit,
    the launch counts of what it served."""
    with open(os.environ["CHIP_SMOKE_REPLICA"]) as f:
        cfg = json.load(f)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.resilience.lifecycle import ServerState
    from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                             InferenceServer)
    status_path = os.path.join(cfg["out"], f"replica-{port}.json")
    status = {"kind": kind, "port": port, "pid": os.getpid(),
              "role": cfg.get("role"), "t_imported": time.time()}
    if cfg["device"] != "cpu":
        torch.zeros(1, device="cuda")       # the CUDA context
    status["t_context"] = time.time()
    if kind == "predict":
        eng, watcher = _replica_predict_engine(cfg, status)
        first = eng.predict

        def predict(x):
            out = first(x)
            if "t_first_answer" not in status:
                status["t_first_answer"] = time.time()
                _write_status(status_path, status)
            return out

        eng.predict = predict
        srv = InferenceServer(eng, port=port, max_delay_ms=2.0,
                              memory_watch=False, weight_watcher=watcher,
                              flight_dir=cfg["out"])
    else:
        from sparkflow_tpu_torch.models import (build_registry_spec,
                                                model_from_json)
        model = model_from_json(build_registry_spec("transformer_lm",
                                                    **cfg["lm"]),
                                compute_dtype="bfloat16",
                                device=cfg["device"])
        params = model.init(torch.Generator().manual_seed(0))
        eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0,
                           executable_dir=cfg["exe"])
        first = eng.prefill

        def prefill(*a, **kw):
            out = first(*a, **kw)
            if "t_first_answer" not in status:
                status["t_first_answer"] = time.time()   # its first token
                _write_status(status_path, status)
            return out

        eng.prefill = prefill
        srv = InferenceServer(None, port=port,
                              generate_batcher=ContinuousBatcher(
                                  eng, max_queue=64),
                              memory_watch=False, flight_dir=cfg["out"])
    status["boot"] = eng.boot
    status["t_engine"] = time.time()
    calls0 = eng.metrics.histograms().get(
        "serving/engine_batch_rows", {}).get("count", 0)
    reset_launch_counts()        # what follows is served traffic only
    srv.start()
    srv.install_signal_handlers()
    status["t_ready"] = time.time()
    _write_status(status_path, status)
    while srv.lifecycle.state in (ServerState.STARTING, ServerState.SERVING):
        time.sleep(0.1)
    srv.stop()
    st = eng.stats()
    status.update(launches=launch_counts(), t_exit=time.time(),
                  bucket_calls=eng.metrics.histograms().get(
                      "serving/engine_batch_rows", {}).get("count", 0)
                  - calls0,
                  steps=st.get("steps"), prefills=st.get("prefills"),
                  serving_version=st.get("serving_version"))
    _write_status(status_path, status)
    return 0


def _read_status(out, port):
    try:
        with open(os.path.join(out, f"replica-{port}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wait(cond, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s:.0f} s: {what}")


def _wait_ready(out, port, proc):
    def ready():
        if proc.poll() is not None:
            raise AssertionError(f"replica on {port} exited with "
                                 f"{proc.returncode} before it was ready")
        st = _read_status(out, port)
        return st is not None and "t_ready" in st
    _wait(ready, FLEET_HEALTH_S, f"replica on {port} ready")


def _boot_row(out, port, launched, cuda):
    """One replica's boot: its tier and its boot-to-healthy and
    boot-to-first-answer seconds from its launch; tier 3 (or, on the card,
    anything but the tier asked for) fails the phase."""
    st = _read_status(out, port) or {}
    boot = st.get("boot") or {}
    row = {"port": port, "kind": st.get("kind"), "role": st.get("role"),
           "tier": boot.get("tier"), "source": boot.get("source"),
           "kernels_boot_s": boot.get("boot_s")}
    t0 = launched[port]
    # the boot's steps, each from the launch: interpreter and imports, the
    # CUDA context, the weights read (predict), the engine (kernels, model,
    # warmup), the server up
    for step in ("imported", "context", "weights", "engine"):
        if f"t_{step}" in st:
            row[f"{step}_s"] = st[f"t_{step}"] - t0
    if "t_ready" in st:
        row["boot_to_healthy_s"] = st["t_ready"] - t0
    if "t_first_answer" in st:
        row["boot_to_first_answer_s"] = st["t_first_answer"] - t0
    if cuda and row["tier"] not in (1, 2):
        raise AssertionError(f"replica on {port} booted its kernels by "
                             f"{row}: a replica must not build them")
    return row


def _served_launches(out, ports, cuda, kind, layers):
    """Launch counts of drained replicas (a SIGKILLed one writes none),
    checked against what each served: 12 ``flash_fwd`` a bucket call and
    nothing else for predict; 12 a prefill and 12 ``paged_attention`` a
    decode step for generate."""
    rows = []
    for port in ports:
        st = _read_status(out, port) or {}
        if "launches" not in st:
            continue
        lc = st["launches"]
        if kind == "predict":
            want = {"flash_fwd": layers * st["bucket_calls"]}
        else:
            want = {"flash_fwd": layers * st["prefills"],
                    "paged_attention": layers * st["steps"]}
        others = {k: v for k, v in lc.items() if k not in want and v}
        if cuda and ({k: lc.get(k) for k in want} != want or others
                     or not all(want.values())):
            raise AssertionError(f"replica on {port}: launches {lc}, want "
                                 f"{want} and no other")
        rows.append({"port": port, **{k: lc.get(k, 0) for k in want},
                     "bucket_calls": st.get("bucket_calls"),
                     "steps": st.get("steps"),
                     "prefills": st.get("prefills")})
    return rows


def _fleet_client(url, pool, seed, errors, answers, stop, rows_max=8):
    """A closed-loop predict client (no retries): 1-``rows_max`` rows of
    ``pool`` a request until ``stop`` is set; every answer is kept with
    the rows' indices in the pool."""
    import numpy as np
    from sparkflow_tpu_torch.serving import ServingClient
    cli = ServingClient(url, retries=0, timeout=120)
    rs = np.random.RandomState(seed)
    while not stop.is_set():
        idx = rs.randint(0, len(pool[0]), rs.randint(1, rows_max + 1))
        t = time.perf_counter()
        try:
            out = cli.predict({"input_ids": pool[0][idx],
                               "attention_mask": pool[1][idx]})
            answers.append((idx, np.asarray(out, np.float64),
                            (time.perf_counter() - t) * 1e3))
        except Exception as e:  # noqa: BLE001 - every failure is counted
            errors.append(f"client {seed}: {type(e).__name__}: {e}")
    cli.close()


def _pool_probs(eng, pool):
    """The parent engine's probs of every pool row as each bucket of its
    ladder computes them, ``[buckets, rows, classes]``: a replica's
    batcher runs a request in whichever bucket its joined batch fills,
    and float32 GEMMs of another height sum in another order."""
    import numpy as np
    n = len(pool[0])
    return np.stack([np.concatenate([
        np.asarray(eng.predict((pool[0][i:i + b], pool[1][i:i + b])),
                   np.float64) for i in range(0, n, b)])
        for b in eng.buckets])


def _answer_err(answers, want):
    """Per answer, the largest difference over its rows from the parent's
    probs of the same rows in the bucket closest to it (``want`` from
    :func:`_pool_probs`)."""
    import numpy as np
    return np.array([np.abs(got[None] - want[:, idx]).max(axis=(1, 2)).min()
                     for idx, got, _ms in answers])


def _predict_fleet(card, cfg, pool, want, cuda):
    """(a): RouterServer over an Autoscaler + ReplicaManager (min 1, max 3);
    a burst, a SIGKILL mid-burst, a trickle; (e) on the fleet left."""
    from sparkflow_tpu_torch.serving import (Autoscaler, ReplicaManager,
                                             RouterServer, ServingClient,
                                             policies)
    from sparkflow_tpu_torch.serving.autoscaler import free_port
    out, launched = cfg["out"], {}
    pcfg = dict(cfg, kind="predict", role="autoscaled")

    def launcher(port):
        return _launch_replica(pcfg, port, launched)

    port0 = free_port()
    proc0 = launcher(port0)
    _wait_ready(out, port0, proc0)
    router = RouterServer([f"http://127.0.0.1:{port0}"],
                          probe_interval_s=0.2, dispatch_retries=4,
                          max_inflight=4 * FLEET_WORKERS)
    router.start()
    manager = ReplicaManager(launcher, membership=router.membership,
                             health_timeout_s=FLEET_HEALTH_S,
                             drain_timeout_s=30.0, flight_dir=out)
    manager.adopt(router.membership.replicas[0], proc0)
    scaler = Autoscaler(router.membership, manager,
                        targets=policies.ScaleTargets(**FLEET_TARGETS),
                        interval_s=0.5, signal_window=64)
    errors, answers, stop = [], [], threading.Event()
    threads = [threading.Thread(target=_fleet_client,
                                args=(router.url, pool, 10 + w, errors,
                                      answers, stop), daemon=True)
               for w in range(FLEET_WORKERS)]
    timeline, sizes, sampled = {}, [1], threading.Event()

    def sample():
        while not sampled.is_set():
            sizes.append(manager.managed_count)
            time.sleep(0.1)

    try:
        scaler.start()
        threading.Thread(target=sample, daemon=True).start()
        t0 = time.time()
        for t in threads:
            t.start()
        _wait(lambda: scaler.spawns >= 1 and manager.managed_count >= 2,
              4 * FLEET_HEALTH_S, "the burst grows the fleet to 2")
        timeline["grown_s"] = time.time() - t0
        victim = manager.managed()[-1]
        vproc = manager._managed[victim.index].proc
        t_kill = time.time()
        vproc.send_signal(signal.SIGKILL)
        vproc.wait(timeout=30)
        _wait(lambda: scaler.replacements >= 1,
              2 * FLEET_HEALTH_S, "the SIGKILLed replica is replaced")
        timeline["kill_to_replaced_s"] = time.time() - t_kill
        n0 = len(answers)
        _wait(lambda: len(answers) >= n0 + 4 * FLEET_WORKERS, 60,
              "the burst goes on after the replacement")
        stop.set()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a burst client did not finish")
        t_trickle = time.time()
        trickle_stop = threading.Event()
        trickle = threading.Thread(
            target=_fleet_client, args=(router.url, pool, 99, errors,
                                        answers, trickle_stop, 1),
            daemon=True)
        trickle.start()
        _wait(lambda: manager.managed_count == FLEET_TARGETS["min_replicas"]
              and scaler.drains >= 1, 120, "the trickle drains the fleet "
              "back to its minimum")
        timeline["trickle_to_min_s"] = time.time() - t_trickle
        sampled.set()
        peak = max(sizes)
        trickle_stop.set()
        trickle.join(timeout=60)
        gauges = {k: v for k, v in router.metrics.gauges().items()
                  if k.startswith("autoscaler/")}
        scaler.stop()
        if errors:
            raise AssertionError(f"{len(errors)} client-visible failures: "
                                 f"{errors[:3]}")
        tol = PREDICT_TOL["a"]["replay"]
        err = float(_answer_err(answers, want).max())
        # the same answers against the bucket-32 reference alone: what
        # float32 reduction order alone moves the probs by
        err32 = float(_answer_err(answers, want[-1:]).max())
        lat = [a[2] for a in answers]
        calib = _calibrate(router.url, len(router.membership.replicas))
        summary = {"requests": len(answers), "client_failures": len(errors),
                   "max_abs_err_vs_parent": err,
                   "max_abs_err_vs_parent_bucket32": err32, "tol": tol,
                   "request_ms_p50": _pct(lat, 50),
                   "request_ms_p95": _pct(lat, 95),
                   "spawns": scaler.spawns, "drains": scaler.drains,
                   "replacements": scaler.replacements, "peak_replicas": peak,
                   "timeline": timeline,
                   "flight_records": [
                       {"replica": r.get("replica_url"),
                        "reason": r.get("harvest_reason"),
                        "inflight_trace_ids": len(
                            r.get("inflight_trace_ids", []))}
                       for r in manager.flight_reports],
                   "autoscaler_gauges": gauges,
                   "card": card}
        log("[fleet-predict] " + json.dumps(summary))
        if peak < 2 or scaler.replacements < 1 or scaler.drains < 1:
            raise AssertionError("the fleet did not grow, heal and shrink")
        if not err <= tol:
            raise AssertionError(f"predict fleet: served answers vs the "
                                 f"parent engine: max |d| {err} (tol {tol})")
    finally:
        stop.set()
        sampled.set()
        scaler.stop()
        manager.stop_all()
        router.stop()
    summary["replica_launches"] = _served_launches(
        out, sorted(launched), cuda, "predict", BERT_BASE["num_layers"])
    boots = [_boot_row(out, p, launched, cuda) for p in sorted(launched)]
    return summary, boots, calib


def _calibrate(url, replicas):
    """(e): a seeded trace replayed open-loop through the router (one row a
    request, BERT-base), then the same trace through ``FleetSimulator``
    with ``CostModel.fit_predict`` over the real latencies, as
    ``sim/calibrate.py`` does; the p95 ratio is a reading, not a gate."""
    from sparkflow_tpu_torch.serving import ServingClient, policies
    from sparkflow_tpu_torch.sim import (CostModel, FleetSimulator,
                                         ReplicaSpec, synthetic_trace)
    tr = synthetic_trace(80, seed=1, rate_rps=20.0, session_fraction=0.0,
                         burst_factor=2.0)
    rows = _predict_rows(1, 4242)
    lat, errors = [], []
    lock = threading.Lock()
    cli = ServingClient(url, retries=0, timeout=120)

    def one(delay):
        time.sleep(delay)
        t = time.perf_counter()
        try:
            cli.predict({"input_ids": rows[0], "attention_mask": rows[1]})
            with lock:
                lat.append((time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 - counted and raised below
            errors.append(e)

    base = tr[0].arrival_s
    threads = [threading.Thread(target=one, args=(r.arrival_s - base,))
               for r in tr]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    cli.close()
    if errors:
        raise AssertionError(f"calibration replay: {errors[:3]}")
    cost = CostModel.fit_predict(lat)
    rep = FleetSimulator([ReplicaSpec(slots=8) for _ in range(replicas)],
                         tr, cost, mode="predict", seed=0,
                         probe_interval_s=0.2).run()
    real = policies.percentile_nearest_rank(lat, 95.0)
    return {"trace_requests": len(tr), "replicas": replicas,
            "fitted_predict_ms": cost.predict_ms, "real_p50_ms":
            policies.percentile_nearest_rank(lat, 50.0),
            "real_p95_ms": real, "sim_p95_ms": rep.latency_p95_ms,
            "sim_over_real_p95": rep.latency_p95_ms / real}


def _tier2_replica(card, cfg, cuda):
    """(b): one more predict replica, booted from the parent's build
    directory (``compile_cache_dir``), no store, no ``nvcc``."""
    from sparkflow_tpu_torch.serving import ServingClient
    from sparkflow_tpu_torch.serving.autoscaler import free_port
    launched = {}
    tcfg = dict(cfg, kind="predict", role="compile_cache", exe=None,
                compile_cache=cfg["parent_build_dir"])
    port = free_port()
    proc = _launch_replica(tcfg, port, launched)
    try:
        _wait_ready(cfg["out"], port, proc)
        rows = _predict_rows(3, 77)
        ServingClient(f"http://127.0.0.1:{port}", retries=0,
                      timeout=120).predict({"input_ids": rows[0],
                                            "attention_mask": rows[1]})
        _wait(lambda: "t_first_answer" in (_read_status(cfg["out"], port)
                                           or {}), 30, "first answer noted")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    row = _boot_row(cfg["out"], port, launched, cuda)
    if cuda and row["tier"] != 2:
        raise AssertionError(f"compile_cache_dir replica: {row}")
    return row, _served_launches(cfg["out"], [port], cuda, "predict",
                                 BERT_BASE["num_layers"])


def _canary(card, cfg, pool, want, cuda):
    """(c): ``RouterServer(canary=True)`` over a pinned replica and a
    watching one; a good version (v1 x (1 + 1e-3)) is promoted, a version
    with one NaN leaf is quarantined and rolled back."""
    import numpy as np
    from sparkflow_tpu_torch.serving import (RouterServer, ServingClient,
                                             WeightStore)
    from sparkflow_tpu_torch.serving.autoscaler import free_port
    store = WeightStore(cfg["store"])
    launched, procs = {}, {}
    for role, watch in (("pinned", False), ("canary", True)):
        port = free_port()
        procs[role] = (port, _launch_replica(
            dict(cfg, kind="predict", role=role, watch=watch), port,
            launched))
    for port, proc in procs.values():
        _wait_ready(cfg["out"], port, proc)
    router = RouterServer([f"http://127.0.0.1:{p}" for p, _ in
                           procs.values()], probe_interval_s=0.1,
                          dispatch_retries=4, canary=True,
                          canary_fraction=0.5,
                          canary_min_requests=CANARY_MIN_REQUESTS,
                          canary_latency_factor=4.0, weight_store=store)
    router.start()
    canary_url = f"http://127.0.0.1:{procs['canary'][0]}"
    cli = ServingClient(router.url, retries=0, timeout=120)
    answers, nans = [], []
    rs = np.random.RandomState(5)

    def send(n):
        for _ in range(n):
            idx = rs.randint(0, len(pool[0]), rs.randint(1, 5))
            got = np.asarray(cli.predict({"input_ids": pool[0][idx],
                                          "attention_mask": pool[1][idx]}),
                             np.float64)
            (nans if np.isnan(got).any() else answers).append(
                (idx, got, 0.0))

    def version_of(url):
        for r in router.membership.snapshot():
            if r["url"] == url:
                return r["version"]
        return None

    ctl = router.canary_ctl
    try:
        send(2 * CANARY_MIN_REQUESTS)
        good = want["good_tree"]
        t_pub = time.time()
        v_good = store.publish(good)
        _wait(lambda: version_of(canary_url) == v_good, 30,
              "the canary replica serves the good version")
        while ctl.promotions < 1 and time.time() - t_pub < 60:
            send(1)
        promote_s = time.time() - t_pub
        if ctl.promotions != 1 or ctl.incumbent != v_good:
            raise AssertionError(f"good version not promoted: "
                                 f"{ctl.stats()}")
        bad = {ln: dict(layer) for ln, layer in good.items()}
        ln0 = sorted(bad)[-1]
        pn0 = sorted(bad[ln0])[0]
        bad[ln0][pn0] = bad[ln0][pn0].copy()
        bad[ln0][pn0].reshape(-1)[0] = np.nan
        t_pub = time.time()
        v_bad = store.publish(bad)
        _wait(lambda: version_of(canary_url) == v_bad, 30,
              "the canary replica serves the NaN version")
        while ctl.rollbacks < 1 and time.time() - t_pub < 60:
            send(1)
        rollback_s = time.time() - t_pub
        if ctl.rollbacks != 1 or v_bad not in ctl.quarantined:
            raise AssertionError(f"NaN version not rolled back: "
                                 f"{ctl.stats()}")
        if store.latest_version() != v_good:
            raise AssertionError(f"store not repointed: {store.stats()}")
        _wait(lambda: version_of(canary_url) == v_good, 30,
              "the canary replica reverts to the good version")
        revert_s = time.time() - t_pub
        send(2 * CANARY_MIN_REQUESTS)
        stats = ctl.stats()
    finally:
        cli.close()
        router.stop()
        for port, proc in procs.values():
            proc.terminate()
        for port, proc in procs.values():
            proc.wait(timeout=60)
    if len(nans) > 1:
        raise AssertionError(f"{len(nans)} NaN answers: the gate must close "
                             f"on the first")
    # each answer is the parent's on the incumbent or on the good version
    tol = PREDICT_TOL["a"]["replay"]
    e1, e2 = _answer_err(answers, want["v1"]), _answer_err(answers,
                                                          want["good"])
    err = np.minimum(e1, e2)
    if not err.max() <= tol:
        raise AssertionError(f"canary answers vs the parent: {err.max()}")
    return {"requests": len(answers) + len(nans), "nan_answers": len(nans),
            "answers_on_good_version": int((e2 <= tol).sum()),
            "max_abs_err_vs_parent": float(err.max()), "tol": tol,
            "promote_s": promote_s, "rollback_s": rollback_s,
            "revert_s": revert_s, "versions": [v_good, v_bad],
            "canary": {k: stats[k] for k in ("incumbent", "canary",
                                             "quarantined", "promotions",
                                             "rollbacks")},
            "store": store.stats(), "card": card}, \
        [_boot_row(cfg["out"], p, launched, cuda) for p in sorted(launched)], \
        _served_launches(cfg["out"], sorted(launched), cuda, "predict",
                         BERT_BASE["num_layers"])


def _generate_fleet(card, cfg, cuda):
    """(d): two GPT-2-small decode replicas behind the router's
    ``/v1/generate``; 8 greedy prompts of 64-700 tokens, 32 new tokens
    each, token-identical to the parent's own engine."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.serving import (DecodeEngine, RouterServer,
                                             ServingClient)
    from sparkflow_tpu_torch.serving.autoscaler import free_port
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg["lm"]["vocab_size"], n).tolist()
               for n in GEN_LENS]
    launched, procs = {}, []
    gcfg = dict(cfg, kind="generate", role="generate")
    for _ in range(2):
        port = free_port()
        procs.append((port, _launch_replica(gcfg, port, launched)))
    model = model_from_json(build_registry_spec("transformer_lm",
                                                **cfg["lm"]),
                            compute_dtype="bfloat16", device=cfg["device"])
    params = model.init(torch.Generator().manual_seed(0))
    eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0)
    want = _greedy(eng, prompts, GEN_NEW)
    del eng, model, params
    if cuda:
        torch.cuda.empty_cache()
    for port, proc in procs:
        _wait_ready(cfg["out"], port, proc)
    # each fresh replica's first requests pay first-use costs (the lazy
    # load of every GEMM shape's module): one request per prompt length,
    # straight to each replica, before the measured burst
    cold = []
    for port, _proc in procs:
        cli = ServingClient(f"http://127.0.0.1:{port}", retries=0,
                            timeout=300)
        for n in GEN_LENS:
            r = cli.generate(rng.integers(0, cfg["lm"]["vocab_size"],
                                          n).tolist(), max_new_tokens=2)
            cold.append(r["timing_ms"]["queue_wait_ms"]
                        + r["timing_ms"]["prefill_ms"])
        cli.close()
    router = RouterServer([f"http://127.0.0.1:{p}" for p, _ in procs],
                          probe_interval_s=0.1, dispatch_retries=4).start()
    results, errors = [None] * len(prompts), []
    try:
        cli = ServingClient(router.url, retries=0, timeout=300)

        def one(i):
            t = time.perf_counter()
            try:
                r = cli.generate(prompts[i], max_new_tokens=GEN_NEW)
                results[i] = (r, (time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        split = [r["successes"] for r in router.membership.snapshot()]
    finally:
        router.stop()
        for _port, proc in procs:
            proc.terminate()
        for _port, proc in procs:
            proc.wait(timeout=60)
    if errors:
        raise AssertionError(f"{len(errors)} client-visible failures: "
                             f"{errors[:3]}")
    got = [r["tokens"] for r, _ in results]
    if got != want:
        bad = [i for i in range(len(got)) if got[i] != want[i]]
        raise AssertionError(f"prompts {bad}: router tokens differ from the "
                             f"parent engine's")
    ttft = [r["timing_ms"]["queue_wait_ms"] + r["timing_ms"]["prefill_ms"]
            for r, _ in results]
    total = [ms for _, ms in results]
    return {"requests": len(results), "tokens_identical_to_parent": True,
            "warmup_ttft_ms_first_per_replica": [cold[0],
                                                 cold[len(GEN_LENS)]],
            "warmup_ttft_ms_max": max(cold),
            "dispatch_split": split, "ttft_ms_p50": _pct(ttft, 50),
            "ttft_ms_p95": _pct(ttft, 95),
            "request_ms_p50": _pct(total, 50),
            "request_ms_p95": _pct(total, 95), "wall_s": wall,
            "tokens_per_s": sum(len(g) for g in got) / wall,
            "card": card}, \
        [_boot_row(cfg["out"], p, launched, cuda) for p in sorted(launched)], \
        _served_launches(cfg["out"], sorted(launched), cuda, "generate",
                         cfg["lm"]["num_layers"])


def phase_fleet(card, spec, work, lm=None, device=None):
    """Phase 15: the port's serving fleet on the card (see the module
    docstring); returns the fleet's launches for the kernels line."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import _build
    from sparkflow_tpu_torch.serving import (ExecutableStore, InferenceEngine,
                                             WeightStore)
    from sparkflow_tpu_torch.serving.coldstart import boot_kernels
    cuda = device != "cpu"
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = os.path.join(work, "fleet")
    os.makedirs(out)
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        f.write(spec)
    # the store the replicas boot their kernels from, filled with the
    # library this process built at setup
    exe = os.path.join(work, "executables")
    parent = _build.loaded() if cuda else None
    if cuda:
        # the library this process loaded at setup goes to the store
        fill = boot_kernels(ExecutableStore(exe), None, torch.device("cuda"))
        if fill["source"] != "already_loaded" or not fill["saved"]:
            raise AssertionError(f"cannot fill the kernel store: {fill}")
        ldd = subprocess.run(["ldd", parent["path"]], capture_output=True,
                             text=True).stdout
        log("[fleet] ldd of the kernel library:\n" + ldd.rstrip())
        if "libcudart" in ldd:
            raise AssertionError("the kernel library links cudart "
                                 "dynamically: the store's fingerprint "
                                 "would need the runtime's version")
    # phase 13's published weights; the parent's own engine gives every
    # answer's reference, on them and on the canary's good version
    wstore = WeightStore(os.path.join(work, "store"))
    version = wstore.latest_version()
    ref_model = model_from_json(spec, device=device)
    _v, v1 = wstore.load(version=version, like=_meta_like(ref_model))
    v1 = {ln: {pn: np.asarray(t) for pn, t in layer.items()}
          for ln, layer in v1.items()}
    good = {ln: {pn: t * np.float32(1 + 1e-3) for pn, t in layer.items()}
            for ln, layer in v1.items()}
    pool = _predict_rows(FLEET_POOL_ROWS, 1515)
    ref = InferenceEngine(ref_model, v1, input_name=PREDICT_IN,
                          output_name="probs:0",
                          max_batch=PREDICT_MAX_BATCH)
    want = {"v1": _pool_probs(ref, pool), "good_tree": good}
    ref.swap_params(good)
    want["good"] = _pool_probs(ref, pool)
    del ref, ref_model
    if cuda:
        torch.cuda.empty_cache()
    cfg = {"out": out, "spec": spec_path, "store": wstore.directory,
           "version": version, "exe": exe, "compile_cache": None,
           "watch": False, "device": device, "lm": lm or GPT2_SMALL,
           "parent_build_dir": (os.path.dirname(parent["path"])
                                if parent else None)}
    try:
        pred, boots, calib = _predict_fleet(card, cfg, pool, want["v1"],
                                            cuda)
        log("[fleet-predict-launches] " + json.dumps(
            pred["replica_launches"]))
        row2, launches2 = _tier2_replica(card, cfg, cuda)
        canary, cboots, claunches = _canary(card, cfg, pool, want, cuda)
        log("[fleet-canary] " + json.dumps(canary))
        gen, gboots, glaunches = _generate_fleet(card, cfg, cuda)
        log("[fleet-generate] " + json.dumps(gen))
    finally:
        for p in _FLEET_PROCS:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    parent_row = {"role": "parent (phase setup)",
                  "tier": ({"built": 3, "found": 2}.get(parent["how"])
                           if parent else None),
                  "source": parent["how"] if parent else "cpu",
                  "kernels_boot_s": parent["seconds"] if parent else None}
    log("[fleet-coldstart] " + json.dumps(
        {"parent": parent_row, "replicas": boots + [row2] + cboots + gboots,
         "card": card}))
    log("[fleet-sim] " + json.dumps({**calib, "card": card}))
    log(f"[fleet] phase 15 {time.perf_counter() - t0:.1f} s")
    predict_launches = pred["replica_launches"] + launches2 + claunches
    return {"flash_fwd": {
                "predict_replicas": [r["flash_fwd"]
                                     for r in predict_launches],
                "generate_replicas": [r["flash_fwd"] for r in glaunches]},
            "paged_attention": {
                "generate_replicas": [r["paged_attention"]
                                      for r in glaunches]}}


# -- phase 16: the other registry families ------------------------------------
#
# Switch-Base-8's widths (Fedus et al. 2021; HF google/switch-base-8): 768 /
# 12 layers / 12 heads / 3072, 8 experts on every second layer, top-1,
# capacity factor 1.25, vocab 32128. The repo's MoE LM is decoder-only with
# learned positions and the tanh GELU (its departure from Switch's T5
# encoder-decoder); max_len 512.
SWITCH_BASE_8 = dict(vocab_size=32128, hidden=768, num_layers=12,
                     num_heads=12, mlp_dim=3072, max_len=512, dropout=0.0,
                     num_experts=8, moe_every=2, router_top_k=1,
                     capacity_factor=1.25)
MOE_PROMPTS = (64, 100, 150, 200, 256, 300, 350, 400)
MOE_NEW = 32
MOE_EXACT_LAYERS = 4       # float32 exactness: full width, 2 MoE layers
MOE_EXACT_STEPS = 8
MOE_LOGIT_TOL = 1e-3       # engine decode logits vs the dense cache's
MOE_MARGIN = 1e-4          # a router top-1/top-2 margin counted as a near-tie
MOE_TRAIN_ROWS, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH = 64, 512, 8
# examples/resnet_cifar.py's full path: resnet depth 50, width 64, CIFAR
# images, float32, miniBatchSize 64 (epochs cut to 2 over 256 rows)
CIFAR_RESNET = dict(num_classes=10, depth=50, image_size=32, width=64)
CIFAR_ROWS, CIFAR_BATCH, CIFAR_EPOCHS = 256, 64, 2
RESNET_224_BATCH = 8
RESNET_TOL = 1e-4          # ResNet-50 at 224, card vs CPU float32 logits
# Zaremba et al. 2014 "medium" PTB LSTM: 2 x 650, vocab 10000, 35 steps,
# batch 20, dropout 0.5, SGD lr 1; embeddings tied (Press & Wolf 2017)
PTB_MEDIUM = dict(vocab_size=10000, hidden=650, num_layers=2, max_len=35,
                  cell="lstm", dropout=0.5)
PTB_BATCH, PTB_STEPS = 20, 8
RNN_LOSS_TOL = 1e-5        # card vs CPU float32 loss, relative
# examples/rnn_sequence.py's bi-GRU at the JAX defaults
BIGRU = dict(vocab_size=1000, num_classes=2, hidden=512, num_layers=2,
             max_len=128, cell="gru", bidirectional=True)
BIGRU_ROWS, BIGRU_BATCH = 256, 32


def _sync(cuda):
    import torch
    if cuda:
        torch.cuda.synchronize()


def _moe_spec(**over):
    from sparkflow_tpu_torch.models import build_registry_spec
    return build_registry_spec("transformer_moe_lm",
                               **dict(SWITCH_BASE_8, **over))


def _moe_serving(card, device):
    """(a) The Switch-Base-8-width MoE LM, bf16, behind ``/v1/generate``;
    then 10 decode steps with 8 live slots under ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                             InferenceServer, ServingClient)
    cuda = device != "cpu"
    model = model_from_json(_moe_spec(), compute_dtype="bfloat16",
                            device=device)
    params = model.init(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for layer in params.values()
                   for t in layer.values())
    eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0)
    cb = ContinuousBatcher(eng, max_queue=64)
    srv = InferenceServer(None, generate_batcher=cb, host="127.0.0.1",
                          port=0, memory_watch=False).start()
    vocab = SWITCH_BASE_8["vocab_size"]
    rng = np.random.default_rng(16)
    try:
        cli = ServingClient(srv.url, timeout=300)
        for n in [max(1, b // 2 + 1) for b in eng.prefill_buckets]:
            cli.generate(rng.integers(0, vocab, n).tolist(), max_new_tokens=2)
        prompts = [rng.integers(0, vocab, n).tolist() for n in MOE_PROMPTS]
        results = [None] * len(prompts)

        def one(i):
            results[i] = cli.generate(prompts[i], max_new_tokens=MOE_NEW)

        steps0 = eng.stats()["steps"]
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        launches = {k: counts[k] for k in ("flash_fwd", "paged_attention")}
        others = {k: v for k, v in counts.items()
                  if k not in launches and v}
        for i, r in enumerate(results):
            if r is None or len(r["tokens"]) != MOE_NEW \
                    or r["finish_reason"] != "length":
                raise AssertionError(f"MoE request {i}: {r}")
        if cuda and not (launches["flash_fwd"] > 0
                         and launches["paged_attention"] > 0) or others:
            raise AssertionError(f"MoE serving launches {counts}")
        ttft = [r["timing_ms"]["queue_wait_ms"] + r["timing_ms"]["prefill_ms"]
                for r in results]
        step_ms = eng.metrics.percentile(
            "serving/decode/step_ms", 50,
            window=eng.stats()["steps"] - steps0)
        pages = cli.healthz()["decode"]["engine"]["kv"]["pages_used"]
        if pages != 0:
            raise AssertionError(f"pages_used {pages} after all retired")
    finally:
        srv.stop()
    gen = sum(len(r["tokens"]) for r in results)
    summary = {"config": "transformer_moe_lm at Switch-Base-8 widths",
               "params": n_params, "requests": len(results),
               "prompt_lens": list(MOE_PROMPTS), "tokens_generated": gen,
               "wall_s": wall, "ttft_ms_p50": _pct(ttft, 50),
               "ttft_ms_p95": _pct(ttft, 95),
               "decode_tokens_per_s": gen / wall, "step_ms_p50": step_ms,
               "launches": launches, "card": card}
    if cuda:
        slots = [eng.prefill(p, max_new_tokens=100)["slot"]
                 for p in prompts]
        for _ in range(3):
            eng.step()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        steps = 10
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t1) * 1e3
        for s in slots:
            eng.release(s)
        summary["decode_step_8_slots"] = _device_profile(
            prof, prof_wall, steps, kernels=("paged_attention", "gemm",
                                             "index", "scatter"))
    log("[families-moe-serving] " + json.dumps(summary))
    return launches


def _moe_exactness(card, device):
    """(b) Float32, TF32 off, full width cut to 4 layers: each decode
    step's logits from the engine (paged pool, paged kernel) against the
    model's own ``decode_step`` over the dense cache, filled from the
    engine's pool after prefill and fed the engine's tokens and positions —
    the same slots and idle lanes, so every expert sees the same batch.
    A near-tie in the router (top-1 minus top-2 probability under
    ``MOE_MARGIN``) in either run is counted. Control: the last step
    replayed in bf16 must miss the tolerance."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model_from_json(_moe_spec(num_layers=MOE_EXACT_LAYERS),
                            device=device)
    params = model.init(torch.Generator().manual_seed(1))
    eng = DecodeEngine(model, params, num_slots=4, page_size=16, seed=0,
                       prefix_cache=False)
    rng = np.random.default_rng(17)
    vocab = SWITCH_BASE_8["vocab_size"]
    infos = [eng.prefill(rng.integers(0, vocab, n).tolist(),
                         max_new_tokens=MOE_EXACT_STEPS + 1)
             for n in (40, 129, 300)]                   # one idle lane
    live = torch.tensor([i["slot"] for i in infos], device=model.device)
    page = eng.page_size
    cache = model.init_decode_cache(eng.num_slots, max_len=eng.max_seq_len)
    tables, lengths = eng.kv.page_tables(), eng.kv.lengths()
    with torch.inference_mode():
        for s in live.tolist():
            pos = torch.arange(int(lengths[s]), device=model.device)
            pids = torch.as_tensor(tables[s],
                                   device=model.device)[pos // page].long()
            for pool, name in ((eng._k_pool, "k"), (eng._v_pool, "v")):
                cache[name][:, s, :, :len(pos)] = pool[
                    :, pids, pos % page].transpose(1, 2)
    step_inner, route_inner = model.decode_step, model.route
    seen, margins = [], []

    def decode_spy(*a, **kw):
        logits, c = step_inner(*a, **kw)
        seen.append((a[2].clone(), a[3].clone(), logits.detach().clone()))
        return logits, c

    def route_spy(bp, xf, token_mask=None):
        out = route_inner(bp, xf, token_mask)
        top2 = out[0].topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).detach())
        return out

    model.decode_step, model.route = decode_spy, route_spy
    near = {"engine": 0, "dense": 0}
    worst, tok = 0.0, None
    try:
        with torch.inference_mode():
            for _ in range(MOE_EXACT_STEPS):
                margins.clear()
                eng.step()
                token, pos, want = seen[-1]
                near["engine"] += int(sum(
                    (m[live] < MOE_MARGIN).sum() for m in margins))
                margins.clear()
                got, cache = step_inner(params, cache, token, pos)
                near["dense"] += int(sum(
                    (m[live] < MOE_MARGIN).sum() for m in margins))
                worst = max(worst, max_err(got[live], want[live]))
                tok = (token, pos, want)
            model.compute_dtype = torch.bfloat16
            bf_cache = {k: v.to(torch.bfloat16) for k, v in cache.items()}
            bf, _ = step_inner(params, bf_cache, tok[0], tok[1])
            control = max_err(bf[live], tok[2][live])
    finally:
        model.compute_dtype = None
        del model.decode_step, model.route
        for i in infos:
            eng.release(i["slot"])
    if not worst <= MOE_LOGIT_TOL:
        raise AssertionError(f"MoE engine decode logits differ from the "
                             f"dense cache's by {worst}")
    if not control > MOE_LOGIT_TOL:
        raise AssertionError(f"a bf16 replay differs by only {control}: "
                             f"the check would not see bf16")
    out = {"layers": MOE_EXACT_LAYERS, "steps": MOE_EXACT_STEPS,
           "live_lanes": len(infos), "idle_lanes": eng.num_slots - len(infos),
           "max_abs_logit_err": worst, "tol": MOE_LOGIT_TOL,
           "bf16_control_err": control,
           "router_near_ties": near, "margin": MOE_MARGIN, "card": card}
    log("[families-moe-exactness] " + json.dumps(out))


def _moe_training(card, device):
    """(c) ``Trainer.fit`` on the Switch-Base-8-width MoE LM, bf16,
    dropout 0.1, adam 3e-4, 8 steps of 8 x 512; MFU against
    ``device_peak_flops()`` with the trainer's MoE FLOP count. Then one
    float32 step (2 layers, one MoE) through the kernels against the same
    step through the plain attention."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import (attention_reference, launch_counts,
                                         reset_launch_counts)
    from sparkflow_tpu_torch.optimizers import tree_leaves
    from sparkflow_tpu_torch.trainer import Trainer
    from sparkflow_tpu_torch.utils.flops import device_peak_flops
    cuda = device != "cpu"
    toks = np.random.default_rng(18).integers(
        0, 1000, (MOE_TRAIN_ROWS, MOE_TRAIN_SEQ)).astype(np.float32)
    marks, losses = [], []

    def on_step(loss, it, partition):
        marks.append(time.perf_counter())
        losses.append(loss)

    tr = Trainer(_moe_spec(dropout=0.1), "input_ids", None,
                 optimizer="adam", learning_rate=3e-4, iters=TRAIN_STEPS,
                 mini_batch_size=MOE_TRAIN_BATCH, mini_stochastic_iters=1,
                 compute_dtype="bfloat16", seed=0, loss_callback=on_step,
                 device=device)
    _sync(cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(toks)
    counts = launch_counts()
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    launches = {n: counts[n] for n in names}
    want = SWITCH_BASE_8["num_layers"] * TRAIN_STEPS if cuda else 0
    if len(losses) != TRAIN_STEPS or any(v != want
                                         for v in launches.values()):
        raise AssertionError(f"{len(losses)} steps, launches {launches}; "
                             f"each kernel must launch {want} times")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"MoE losses {losses} not finite")
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    flops = tr._train_flops_per_batch(toks[:MOE_TRAIN_BATCH], None, None)
    peak = device_peak_flops()
    summary = {"config": "transformer_moe_lm at Switch-Base-8 widths, bf16, "
                         "dropout 0.1, adam 3e-4",
               "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
               "losses": losses, "step_ms": step_ms,
               "step_ms_median_after_first": steady,
               "tokens_per_s_after_first":
                   MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (steady / 1e3),
               "flops_per_step": flops,
               "mfu": (flops / (steady / 1e3) / peak) if peak else None,
               "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if cuda else None),
               "launches": launches, "card": card}
    log("[families-moe-training] " + json.dumps(summary))
    del tr

    torch.backends.cuda.matmul.allow_tf32 = False
    model = model_from_json(_moe_spec(num_layers=2, dropout=0.1),
                            device=device)
    init = model.init(torch.Generator().manual_seed(2))
    x = torch.as_tensor(np.random.default_rng(19).integers(
        0, SWITCH_BASE_8["vocab_size"], (4, MOE_TRAIN_SEQ)),
        device=model.device)
    res = {}
    for name, att in (("kernel", None), ("plain", attention_reference)):
        p = model.load_params({ln: {pn: t.clone() for pn, t in l.items()}
                               for ln, l in init.items()}, trainable=True)
        gen = torch.Generator(device=model.device).manual_seed(4)
        loss = model.loss_vector(p, {"input_ids": x}, True, gen,
                                 attention=att).mean()
        res[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, tree_leaves(p)))
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    ratio = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk, gp))
    if not (abs(lk - lp) <= 1e-5 * abs(lp) and ratio <= 1e-4):
        raise AssertionError(f"MoE float32 step: loss {lk} vs plain {lp}, "
                             f"gradients differ by {ratio} x max |plain|")
    log(f"[families-moe-train-exactness] float32, 2 layers (1 MoE), B=4 "
        f"S={MOE_TRAIN_SEQ}, dropout 0.1 shared: loss {lk:.7f} vs plain "
        f"{lp:.7f}; max |dgrad| / max |grad| {ratio:.3g} over {len(gk)} "
        f"leaves [{card}]")
    return launches


def synthetic_cifar(spark, n, seed=0):
    """``examples/resnet_cifar.py``'s ``synthetic_cifar`` (copied: that
    example imports the JAX package): flattened 32x32x3 NHWC vectors whose
    brightness follows the label."""
    import numpy as np
    from sparkflow_tpu_torch.localml import Vectors
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 10)
        img = rs.rand(32 * 32 * 3) * (0.5 + 0.05 * label)
        rows.append((float(label), Vectors.dense(img)))
    return spark.createDataFrame(rows, ["label", "features"])


def _marked_fit(fit, cuda):
    """Run ``fit()`` with a mark after every optimizer step — on the card a
    CUDA event recorded on the stream (no host sync), so the gaps are the
    steps after the first on the card's timeline; on the CPU the host
    clock: ``(result, wall_s, [seconds between consecutive steps])``."""
    import torch
    import sparkflow_tpu_torch.core as core
    marks = []
    make_step = core.make_train_step

    def marked_train_step(loss_fn, optimizer):
        step = make_step(loss_fn, optimizer)

        def marked(*a):
            out = step(*a)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(time.perf_counter())
            return out
        return marked

    core.make_train_step = marked_train_step
    try:
        _sync(cuda)
        t0 = time.perf_counter()
        out = fit()
        _sync(cuda)
        wall = time.perf_counter() - t0
    finally:
        core.make_train_step = make_step
    gaps = [(a.elapsed_time(b) / 1e3 if cuda else b - a)
            for a, b in zip(marks, marks[1:])]
    return out, wall, gaps


def _resnet(card, device, work):
    """(d) ``examples/resnet_cifar.py`` on the port: ResNet-50 (width 64,
    CIFAR stem) in float32 through ``Pipeline([OneHotEncoder,
    SparkAsyncDL])`` fit and transform; then ``resnet50`` at 224 (the
    ImageNet stem and max-pool) on 8 images, card against CPU."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                             Pipeline)
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    cuda = device != "cpu"
    torch.backends.cudnn.allow_tf32 = False
    spark = LocalSession.builder.appName("resnet-cifar").getOrCreate()
    df = synthetic_cifar(spark, CIFAR_ROWS)
    spec = build_registry_spec("resnet", **CIFAR_RESNET)
    losses = []
    est = SparkAsyncDL(
        inputCol="features", tensorflowGraph=spec, tfInput="x:0",
        tfLabel="y:0", tfOutput="pred:0", tfOptimizer="adam",
        tfLearningRate=1e-3, iters=CIFAR_EPOCHS, miniBatchSize=CIFAR_BATCH,
        labelCol="labels", predictionCol="predicted",
        weightsPath=os.path.join(work, "resnet"), device=device)
    est.setLossCallback(lambda loss, it, part: losses.append(loss))
    pipe = Pipeline(stages=[OneHotEncoder(inputCol="label",
                                          outputCol="labels",
                                          dropLast=False), est])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fitted, fit_s, gaps = _marked_fit(lambda: pipe.fit(df), cuda)
    steps = len(gaps) + 1
    if steps != CIFAR_EPOCHS * -(-CIFAR_ROWS // CIFAR_BATCH) or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"ResNet fit: {steps} steps, losses {losses}")
    t1 = time.perf_counter()
    preds = fitted.transform(df).collect()
    _sync(cuda)
    transform_s = time.perf_counter() - t1
    if len(preds) != CIFAR_ROWS or not all(
            0 <= r["predicted"] < 10 for r in preds):
        raise AssertionError("ResNet transform: a row without a class")
    acc = float(np.mean([r["predicted"] == r["label"] for r in preds]))
    summary = {"config": "resnet depth 50 width 64 image 32, float32, "
                         "adam 1e-3",
               "rows": CIFAR_ROWS, "batch": CIFAR_BATCH, "steps": steps,
               "fit_s": fit_s, "losses": losses,
               "train_examples_per_s_after_first":
                   CIFAR_BATCH * (steps - 1) / sum(gaps),
               "step_ms_after_first": 1e3 * sum(gaps) / len(gaps),
               "transform_s": transform_s,
               "transform_examples_per_s": CIFAR_ROWS / transform_s,
               "train_accuracy": acc,
               "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if cuda else None), "card": card}
    log("[families-resnet-cifar] " + json.dumps(summary))

    spec224 = build_registry_spec("resnet50", num_classes=1000,
                                  image_size=224)
    on_card = model_from_json(spec224, device=device)
    params = on_card.init(torch.Generator().manual_seed(3))
    # the head is zeros at init: random, so the logits carry the features
    params["head"]["kernel"].copy_(torch.randn(
        params["head"]["kernel"].shape,
        generator=torch.Generator().manual_seed(4)) * 0.05)
    x = torch.randn(RESNET_224_BATCH, 224, 224, 3,
                    generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = on_card.apply(params, {"x": x.to(on_card.device)},
                            ["logits"])["logits"]
        _sync(cuda)
        t2 = time.perf_counter()
        on_card.apply(params, {"x": x.to(on_card.device)}, ["logits"])
        _sync(cuda)
        fwd_ms = (time.perf_counter() - t2) * 1e3
        cpu = model_from_json(spec224, device="cpu")
        want = cpu.apply({ln: {pn: t.cpu() for pn, t in l.items()}
                          for ln, l in params.items()}, {"x": x},
                         ["logits"])["logits"]
    err = max_err(got.cpu(), want)
    if not err <= RESNET_TOL:
        raise AssertionError(f"ResNet-50 at 224: card logits differ from "
                             f"the CPU's by {err}")
    log(f"[families-resnet50-224] batch {RESNET_224_BATCH}, float32: card "
        f"vs CPU max |logit delta| {err:.3g} (tol {RESNET_TOL}, max |logit| "
        f"{float(want.abs().max()):.3g}); one forward {fwd_ms:.1f} ms "
        f"[{card}]")


def _rnn(card, device, work):
    """(e) ``rnn_lm`` at Zaremba et al.'s medium PTB widths through
    ``Trainer.fit``, float32 then bf16, the float32 loss against the CPU's
    and a profiled step; the bi-GRU ``rnn_classifier`` through
    ``SparkAsyncDL`` fit and transform."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparkflow_tpu_torch.core import make_loss_fn, make_train_step
    from sparkflow_tpu_torch.localml import LocalSession, Vectors
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    from sparkflow_tpu_torch.trainer import Trainer
    cuda = device != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = build_registry_spec("rnn_lm", **PTB_MEDIUM)
    toks = np.random.default_rng(20).integers(
        0, PTB_MEDIUM["vocab_size"],
        (PTB_BATCH * PTB_STEPS, PTB_MEDIUM["max_len"])).astype(np.float32)
    out = {}
    for dtype in (None, "bfloat16"):
        marks, losses = [], []

        def on_step(loss, it, partition):
            marks.append(time.perf_counter())
            losses.append(loss)

        tr = Trainer(spec, "input_ids", None, optimizer="gradient_descent",
                     learning_rate=1.0, iters=PTB_STEPS,
                     mini_batch_size=PTB_BATCH, mini_stochastic_iters=1,
                     compute_dtype=dtype, seed=0, loss_callback=on_step,
                     device=device)
        t0 = time.perf_counter()
        tr.fit(toks)
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
        if len(losses) != PTB_STEPS or not all(math.isfinite(x)
                                               for x in losses):
            raise AssertionError(f"rnn_lm {dtype}: losses {losses}")
        out[dtype or "float32"] = {
            "losses": losses, "step_ms": step_ms,
            "step_ms_median_after_first": sorted(step_ms[1:])[
                len(step_ms[1:]) // 2]}
        if dtype is None:
            f32 = tr
    model = f32.model
    feeds = {"input_ids": torch.as_tensor(toks[:PTB_BATCH])}
    cpu = model_from_json(spec, device="cpu")
    with torch.inference_mode():
        got = float(model.loss_vector(
            f32.params, {"input_ids": feeds["input_ids"].to(model.device)},
            train=False).mean())
        want = float(cpu.loss_vector(
            {ln: {pn: t.detach().cpu() for pn, t in l.items()}
             for ln, l in f32.params.items()}, feeds, train=False).mean())
    rel = abs(got - want) / abs(want)
    if not rel <= RNN_LOSS_TOL:
        raise AssertionError(f"rnn_lm float32 loss {got} on the card, "
                             f"{want} on the CPU")
    summary = {"config": "rnn_lm 2 x 650 LSTM, vocab 10000, 35 steps, "
                         "batch 20, dropout 0.5, SGD lr 1, tied",
               **out, "loss_card": got, "loss_cpu": want,
               "loss_rel_err": rel, "card": card}
    if cuda:
        params = model.load_params(f32.params, trainable=True)
        step = make_train_step(make_loss_fn(model, "input_ids", None),
                               f32.optimizer)
        x = torch.as_tensor(toks[:PTB_BATCH], device=model.device)
        y = torch.zeros(PTB_BATCH, 1, device=model.device)
        m = torch.ones(PTB_BATCH, device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(1)
        state = f32._last_opt_state
        params, state, _ = step(params, state, x, y, m, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(params, state, x, y, m, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        summary["train_step_float32"] = _device_profile(prof, wall, 1)
    log("[families-rnn-lm] " + json.dumps(summary))
    del f32, tr

    rs = np.random.RandomState(21)
    rows = []
    seq = BIGRU["max_len"]
    for _ in range(BIGRU_ROWS):
        label = rs.randint(0, 2)
        ids = rs.randint(10, BIGRU["vocab_size"], seq)
        if label:
            ids[::9] = 3
        n_real = rs.randint(seq // 4, seq + 1)
        mask = np.zeros(seq)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append((float(label), Vectors.dense(ids.astype(float)),
                     Vectors.dense(mask)))
    spark = LocalSession.builder.appName("rnn-sequence").getOrCreate()
    df = spark.createDataFrame(rows, ["label", "tokens", "mask"])
    losses = []
    est = SparkAsyncDL(
        inputCol="tokens", tensorflowGraph=build_registry_spec(
            "rnn_classifier", **BIGRU),
        tfInput="input_ids:0", tfLabel="y:0", labelCol="label",
        tfOutput="pred:0", extraInputCols="mask",
        extraTfInputs="attention_mask:0", iters=1,
        miniBatchSize=BIGRU_BATCH, tfOptimizer="adam", tfLearningRate=1e-3,
        predictionCol="predicted", weightsPath=os.path.join(work, "bigru"),
        device=device)
    est.setLossCallback(lambda loss, it, part: losses.append(loss))
    fitted, fit_s, gaps = _marked_fit(lambda: est.fit(df), cuda)
    if len(gaps) + 1 != -(-BIGRU_ROWS // BIGRU_BATCH) or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"bi-GRU fit: {len(gaps) + 1} steps, "
                             f"losses {losses}")
    t1 = time.perf_counter()
    preds = fitted.transform(df).collect()
    _sync(cuda)
    transform_s = time.perf_counter() - t1
    if len(preds) != BIGRU_ROWS or not all(r["predicted"] in (0.0, 1.0)
                                          for r in preds):
        raise AssertionError("bi-GRU transform: a row without a class")
    acc = float(np.mean([r["predicted"] == r["label"] for r in preds]))
    log("[families-bigru] " + json.dumps({
        "config": "rnn_classifier bi-GRU 2 x 512, max_len 128, vocab 1000, "
                  "float32, adam 1e-3",
        "rows": BIGRU_ROWS, "batch": BIGRU_BATCH, "steps": len(gaps) + 1,
        "fit_s": fit_s, "losses": losses,
        "train_examples_per_s_after_first": BIGRU_BATCH * len(gaps)
        / sum(gaps),
        "step_ms_after_first": 1e3 * sum(gaps) / len(gaps),
        "transform_s": transform_s,
        "transform_examples_per_s": BIGRU_ROWS / transform_s,
        "train_accuracy": acc, "card": card}))


def phase_families(card, work, device=None):
    """Phase 16: the MoE LM served and trained at Switch-Base-8 widths,
    ResNet-50 / CIFAR-10 and the LSTM / GRU family (see the module
    docstring). Returns the MoE path's kernel launches."""
    import torch
    cuda = device != "cpu"
    t0 = time.perf_counter()
    serving = _moe_serving(card, device)
    if cuda:
        torch.cuda.empty_cache()
    _moe_exactness(card, device)
    training = _moe_training(card, device)
    if cuda:
        torch.cuda.empty_cache()
    _resnet(card, device, work)
    _rnn(card, device, work)
    log(f"[families] phase 16 {time.perf_counter() - t0:.1f} s")
    return {"serving": serving, "training": training}


# phase 17: the reference's own path. The three example graphs as TF1
# MetaGraphDef JSON (tests/fixtures/torch_tf1/, written with tf.compat.v1 by
# make_fixtures.py there): (fixture, tensor compared, supervised, batch,
# miniStochasticIters, iters, rows, learning rate) — the examples' batch
# sizes and optimizer settings, 8 steps each
TF1_GRAPHS = (("mnist_mlp", "dense_2/BiasAdd:0", True, 300, 1, 8, 1200, 1e-3),
              ("mnist_cnn", "dense/BiasAdd:0", True, 300, -1, 2, 1200, 1e-4),
              ("autoencoder", "out/Sigmoid:0", False, 256, -1, 2, 1024,
               1e-3))
TF1_TOL = 1e-5             # card vs CPU: losses relative, predictions of
TF1_PRED_ROWS = 64         # this many rows over max(1, max |CPU|)
# Hogwild at BERT-base width: 4 partitions of 8 rows x 512 tokens, batch 8,
# 4 pushes a replica; the exactness checks at 2 layers
HOGWILD_ROWS, HOGWILD_PARTS, HOGWILD_BATCH, HOGWILD_ITERS = 32, 4, 8, 4
HOGWILD_EXACT_TOL = 1e-5   # 1 elastic replica vs sync SGD, relative
VIRTUAL_COSTS = (1.0, 1.0, 1.0, 10.0)


def _tf1_fixture(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "torch_tf1", name + ".json")
    with open(path) as f:
        return f.read()


def _tf1_rows(n, supervised, seed):
    """Synthetic MNIST-shaped rows: 784 floats in [0, 1] and, when
    supervised, a one-hot label of 10 classes, from ``seed``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)]
    return x, (y if supervised else None)


def _tf1_df(x, y):
    from sparkflow_tpu_torch.localml import LocalSession, Vectors
    spark = LocalSession.builder.appName("tf1").getOrCreate()
    if y is None:
        return spark.createDataFrame([(Vectors.dense(r),) for r in x],
                                     ["features"])
    return spark.createDataFrame(
        [(Vectors.dense(r), Vectors.dense(l)) for r, l in zip(x, y)],
        ["features", "labels"])


def _tf1_predictions(stage, df):
    import numpy as np
    col = stage.getOrDefault(stage.predictionCol)
    return np.stack([np.asarray(r[col].toArray(), np.float32)
                     for r in stage.transform(df).collect()])


def _tf1_fit(mg, cfg, df, device):
    """``SparkAsyncDL(tensorflowGraph=mg)`` fitted on ``device``: the fitted
    stage, the per-epoch losses, the fit's wall seconds and the gaps
    between consecutive optimizer steps."""
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    name, out, sup, batch, stoch, iters, _rows, lr = cfg
    losses = []
    est = SparkAsyncDL(
        inputCol="features", tensorflowGraph=mg, tfInput="x:0",
        tfLabel="y:0" if sup else None, tfOutput=out, tfOptimizer="adam",
        tfLearningRate=lr, miniBatchSize=batch, miniStochasticIters=stoch,
        iters=iters, shufflePerIter=True, partitions=4,
        labelCol="labels" if sup else None, predictionCol="predicted",
        device=device)
    est.setLossCallback(lambda loss, it, part: losses.append(float(loss)))
    model, wall, gaps = _marked_fit(lambda: est.fit(df), device != "cpu")
    return model, losses, wall, gaps


def _tf1_step_profile(mg, cfg, x, y, device):
    """One training step of the interpreted graph under ``torch.profiler``
    (after a warm step): device ops per step, busy ms and idle share, and
    the step's host ms."""
    import torch
    import sparkflow_tpu_torch.core as core
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer
    name, _out, sup, batch = cfg[:4]
    m = model_from_json(mg, device=device)
    params = m.load_params(m.init(seed=0), trainable=True)
    opt = build_optimizer("adam", cfg[7])
    state = opt.init(params)
    step = core.make_train_step(core.make_loss_fn(
        m, "x:0", "y:0" if sup else None), opt)
    dev = m.device
    xb = torch.as_tensor(x[:batch], device=dev)
    yb = (torch.as_tensor(y[:batch], device=dev) if sup
          else torch.zeros((batch, 1), device=dev))
    mask = torch.ones(batch, device=dev)
    params, state, _ = step(params, state, xb, yb, mask)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, xb, yb, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_profile(prof, wall_ms, 1)


def _tf1_graphs(card, work, device):
    """Phase 17 (a): each reference graph trained through ``SparkAsyncDL``
    on the card and on the CPU from the same weights (``init`` draws on the
    CPU) and shuffles: losses and predictions against each other, an npz
    round trip through ``load_checkpoint_model``. Returns a line per
    graph."""
    import numpy as np
    from sparkflow_tpu_torch.ml_util import resolve_weights, save_weights_npz
    from sparkflow_tpu_torch.model_loader import load_checkpoint_model
    from sparkflow_tpu_torch.models import model_from_json
    cuda = device != "cpu"
    rows = []
    for cfg in TF1_GRAPHS:
        name, out, sup, batch, stoch, iters, n, lr = cfg
        mg = _tf1_fixture(name)
        x, y = _tf1_rows(n, sup, seed=len(rows))
        df = _tf1_df(x, y)
        pdf = _tf1_df(x[:TF1_PRED_ROWS], None)
        # the same weights on both devices: one loss, card against CPU
        feeds = {"x": x[:batch]}
        if sup:
            feeds["y"] = y[:batch]
        first = []
        for dev in (device, "cpu"):
            m = model_from_json(mg, device=dev)
            first.append(float(m.loss_vector(m.init(seed=0), feeds,
                                             train=False).mean()))
        rel0 = abs(first[0] - first[1]) / abs(first[1])
        model, losses, wall, gaps = _tf1_fit(mg, cfg, df, device)
        cpu_model, cpu_losses, _w, _g = _tf1_fit(mg, cfg, df, "cpu")
        if not (np.isfinite(losses).all() and len(losses) == iters):
            raise AssertionError(f"{name}: losses {losses}")
        rel = float(np.max(np.abs(np.subtract(losses, cpu_losses))
                           / np.abs(cpu_losses)))
        got = _tf1_predictions(model, pdf)
        want = _tf1_predictions(cpu_model, pdf)
        perr = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
        weights = resolve_weights(model.getOrDefault(model.modelWeights))
        npz = os.path.join(work, f"{name}.npz")
        save_weights_npz(npz, weights)
        loaded = load_checkpoint_model(npz, mg, "features", "x:0", out,
                                       device=device)
        again = _tf1_predictions(loaded, pdf)
        rt = float(np.abs(again - got).max())
        steps = len(gaps) + 1
        step_ms = 1e3 * float(np.median(gaps)) if gaps else float("nan")
        row = {"graph": name, "steps": steps, "fit_s": wall,
               "examples_per_s": steps * batch / wall, "step_ms": step_ms,
               "losses": losses, "loss_rel_err_vs_cpu": rel,
               "init_loss_rel_err_vs_cpu": rel0,
               "pred_err_vs_cpu": perr, "npz_round_trip_err": rt}
        if cuda:
            prof = _tf1_step_profile(mg, cfg, x, y, device)
            row.update(device_ops_per_step=prof["device_ops"],
                       step_wall_ms=prof["wall_ms"],
                       device_busy_ms=prof["device_busy_ms"],
                       device_idle_share=prof["device_idle_share"])
        log(f"[tf1] {name}: " + json.dumps(row) + f" [{card}]")
        if rel0 > TF1_TOL or rel > TF1_TOL or perr > TF1_TOL:
            raise AssertionError(f"{name}: card vs CPU off by loss {rel:.3g}"
                                 f" (first {rel0:.3g}), predictions "
                                 f"{perr:.3g} > {TF1_TOL}")
        if rt > 1e-6:
            raise AssertionError(f"{name}: npz round trip off by {rt:.3g}")
        rows.append(row)
    return rows


def _hogwild_data():
    import numpy as np
    rs = np.random.RandomState(17)
    ids = rs.randint(0, BERT_BASE["vocab_size"],
                     (HOGWILD_ROWS, BERT_BASE["max_len"])).astype(np.float32)
    return ids, rs.randint(0, 2, HOGWILD_ROWS).astype(np.float32)


def _hogwild_exactness(card, device, ids, labels):
    """Phase 17 (b) exactness at full width, 2 layers, dropout 0: one
    replica through ``strategy="elastic_dp"`` against the sync ``Trainer``'s
    plain SGD for 4 steps; ``run_virtual`` with a 10x straggler on the card
    against the same run on the CPU (accounting exactly)."""
    import numpy as np
    from sparkflow_tpu_torch.core import make_loss_fn
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel import ElasticDPEngine, ReplicaSpec
    from sparkflow_tpu_torch.trainer import Trainer
    from sparkflow_tpu_torch.utils.metrics import Metrics
    spec = build_registry_spec("transformer_classifier", **dict(
        BERT_BASE, num_layers=2, dropout=0.0))
    x, y = ids[:HOGWILD_BATCH], labels[:HOGWILD_BATCH]
    kw = dict(optimizer=build_optimizer("gradient_descent", 0.05),
              mini_batch_size=HOGWILD_BATCH, iters=4, device=device)
    el = Trainer(spec, "input_ids:0", "y:0", strategy="elastic_dp",
                 elastic={"replicas": 1}, **kw)
    r_el = el.fit(x, y)
    sy = Trainer(spec, "input_ids:0", "y:0", **kw)
    r_sy = sy.fit(x, y)
    loss_rel = float(np.max(np.abs(np.subtract(r_el.losses, r_sy.losses))
                            / np.abs(r_sy.losses)))
    w_rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                for a, b in zip(el.weights_list(), sy.weights_list()))
    if (len(r_el.losses) != 4 or loss_rel > HOGWILD_EXACT_TOL
            or w_rel > HOGWILD_EXACT_TOL):
        raise AssertionError(f"elastic 1 replica vs sync SGD: losses "
                             f"{r_el.losses} vs {r_sy.losses} "
                             f"({loss_rel:.3g}), weights {w_rel:.3g}")
    short = ids[:, :64]
    shards = [(short[i::HOGWILD_PARTS], labels[i::HOGWILD_PARTS])
              for i in range(HOGWILD_PARTS)]
    runs = {}
    for dev in (device, "cpu"):
        m = model_from_json(spec, device=dev)
        # plain SGD: adam would turn the exactly-zero gradient of each
        # qkv_bias's key third into steps of the round-off's sign, and the
        # final params of the two devices would part there
        eng = ElasticDPEngine(make_loss_fn(m, "input_ids:0", "y:0"),
                              build_optimizer("gradient_descent", 0.05),
                              m.init(seed=0), max_staleness=2,
                              metrics=Metrics())
        runs[dev] = eng.run_virtual(
            shards, [ReplicaSpec(cost_s=c) for c in VIRTUAL_COSTS], epochs=3,
            batch_size=4, seed=0)
    keys = ("pushes", "accepted", "rejected_stale", "dropped_stale",
            "final_version", "per_replica_accepted", "wire_bytes")
    card_s, cpu_s = runs[device].stats, runs["cpu"].stats
    acct = {k: card_s[k] for k in keys}
    prel = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for la, lb in zip(runs[device].params.values(),
                                  runs["cpu"].params.values())
        for a, b in zip(la.values(), lb.values()))
    log(f"[hogwild] exactness (2 layers): 1-replica elastic vs sync SGD "
        f"losses {loss_rel:.3g} rel, weights {w_rel:.3g} rel; run_virtual "
        f"10x straggler card {acct} == CPU, final params {prel:.3g} rel "
        f"[{card}]")
    if any(card_s[k] != cpu_s[k] for k in keys) or (
            runs[device].version != runs["cpu"].version):
        raise AssertionError(f"run_virtual accounting: card {acct} vs CPU "
                             f"{ {k: cpu_s[k] for k in keys} }")
    return {"elastic_vs_sync_loss_rel": loss_rel,
            "elastic_vs_sync_weights_rel": w_rel, "virtual": acct,
            "virtual_params_rel": prel}


class _PushTimer:
    """Host seconds of each replica's gradient (``compute``) and each push
    (``ElasticParamStore.push``, the wait for the store's lock included)
    while the block runs."""

    def __enter__(self):
        import sparkflow_tpu_torch.parallel.elastic as el
        self.el, self.times = el, {"compute": [], "push": []}
        self.real = (el._ReplicaRunner.compute, el.ElasticParamStore.push)

        def timed(key, fn):
            def call(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                self.times[key].append(time.perf_counter() - t)
                return out
            return call
        el._ReplicaRunner.compute = timed("compute", self.real[0])
        el.ElasticParamStore.push = timed("push", self.real[1])
        return self

    def __exit__(self, *exc):
        self.el._ReplicaRunner.compute, self.el.ElasticParamStore.push = \
            self.real
        return False

    def medians_ms(self):
        import numpy as np
        return {k: 1e3 * float(np.median(v)) for k, v in self.times.items()
                if v}


def _hogwild(card, device):
    """Phase 17 (b): ``HogwildSparkModel(...).train(rdd)`` on BERT-base over
    a 4-partition localml RDD (4 replica threads x batch 8 x 512 tokens, 4
    pushes a replica), the launch counters read around the first train;
    then, warm, the same train timed with its pushes, one replica over the
    same rows, the sync ``Trainer`` on them, and one more 4-replica train
    under the profiler."""
    import collections
    import numpy as np
    import torch
    from sparkflow_tpu_torch.HogwildSparkModel import HogwildSparkModel
    from sparkflow_tpu_torch.localml import RDD
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.trainer import Trainer
    from sparkflow_tpu_torch.utils.metrics import Metrics
    cuda = device != "cpu"
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    spec = build_registry_spec("transformer_classifier", **BERT_BASE)
    ids, labels = _hogwild_data()
    rows = list(zip(ids, labels))
    losses = []

    def model():
        hw = HogwildSparkModel(
            tensorflowGraph=spec, tfInput="input_ids:0", tfLabel="y:0",
            mini_batch=HOGWILD_BATCH, iters=HOGWILD_ITERS,
            optimizer=build_optimizer("adam", 1e-4), master_url="unused",
            loss_callback=lambda l, step, rid: losses.append(l),
            device=device)
        hw._trainer.metrics = Metrics()
        return hw

    def train(parts):
        hw = model()
        _sync(cuda)
        t0 = time.perf_counter()
        hw.train(RDD(rows, parts))
        _sync(cuda)
        return hw, time.perf_counter() - t0

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    hw, cold = train(HOGWILD_PARTS)
    launches = {n: launch_counts()[n] for n in names}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    st = hw.elastic_stats
    computes = st["pushes"] + 1          # and the warm-up gradient
    if cuda and any(launches[n] != 12 * computes for n in names):
        raise AssertionError(f"hogwild launches {launches}, expected 12 x "
                             f"{computes} gradients")
    if not (np.isfinite(losses).all() and st["accepted"] > 0
            and len(st["per_replica_accepted"]) == HOGWILD_PARTS):
        raise AssertionError(f"hogwild: losses {losses}, stats {st}")
    hist = collections.Counter(int(v) for v in hw._trainer.metrics._hists[
        "elastic/staleness"].samples)
    applied = HOGWILD_BATCH * st["accepted"]
    with _PushTimer() as four:
        hw4, warm = train(HOGWILD_PARTS)
    with _PushTimer() as one:
        hw1, single = train(1)
    sync = Trainer(spec, "input_ids:0", "y:0",
                   optimizer=build_optimizer("adam", 1e-4),
                   mini_batch_size=HOGWILD_BATCH, iters=HOGWILD_ITERS,
                   device=device)
    _sync(cuda)
    t1 = time.perf_counter()
    sync.fit(ids, labels)
    _sync(cuda)
    sync_wall = time.perf_counter() - t1
    row = {"replicas": HOGWILD_PARTS, "rows": HOGWILD_ROWS,
           "batch": HOGWILD_BATCH, "seq": BERT_BASE["max_len"],
           "train_s_cold": cold, "examples_per_s_cold": applied / cold,
           "train_s": warm, "examples_per_s": HOGWILD_BATCH
           * hw4.elastic_stats["accepted"] / warm,
           "host_ms_median_4_replicas": four.medians_ms(),
           "examples_per_s_1_replica": HOGWILD_BATCH
           * hw1.elastic_stats["accepted"] / single,
           "host_ms_median_1_replica": one.medians_ms(),
           "sync_examples_per_s": HOGWILD_ROWS * HOGWILD_ITERS / sync_wall,
           "sync_fit_s": sync_wall, "accepted": st["accepted"],
           "rejected_stale": st["rejected_stale"],
           "dropped": st["dropped_stale"] + st["dropped_lease"]
           + st["dropped_fault"], "final_version": st["final_version"],
           "staleness_histogram": dict(sorted(hist.items())),
           "launches": launches, "gradients": computes,
           "peak_memory_gb": peak,
           "sparse_bytes_saved": st["sparse_bytes_saved"]}
    if cuda:
        hw2 = model()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t2 = time.perf_counter()
            hw2.train(RDD(rows, HOGWILD_PARTS))
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t2) * 1e3
        p = _device_profile(prof, pwall, 1, kernels=("flash",))
        row.update(profiled_wall_ms=p["wall_ms"],
                   device_busy_ms=p["device_busy_ms"],
                   device_idle_share=p["device_idle_share"])
    log("[hogwild] BERT-base " + json.dumps(row) + f" [{card}]")
    return row


def phase_tf1_hogwild(card, work, device=None):
    """Phase 17: the reference graphs as TF1 MetaGraphDefs through the
    estimator, then Hogwild at BERT-base width and its exactness checks.
    Returns the Hogwild run's kernel launches."""
    import torch
    cuda = device != "cpu"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    graphs = _tf1_graphs(card, work, device)
    hog = _hogwild(card, device)
    if cuda:
        torch.cuda.empty_cache()
    exact = _hogwild_exactness(card, device, *_hogwild_data())
    log(f"[tf1-hogwild] phase 17 {time.perf_counter() - t0:.1f} s")
    return {"graphs": graphs, "hogwild": hog, "exactness": exact}


# phase 18: synchronous mesh training — ranks are processes on the card
# (gloo over CUDA tensors, staged through pinned host memory: one card)
MESH_RING_SHAPE = (8, 12, 1024, 64)   # the training shape, 512 a rank
MESH_RING_REPS = 5
MESH_EST_ROWS, MESH_EST_BATCH, MESH_EST_STEPS = 64, 32, 4
MESH_SP_BATCH, MESH_SP_STEPS = 8, 3
MESH_TIMEOUT_S = 240.0     # a collective's, a rank join's, a pool task's
MESH_LOSS_RTOL = 1e-5      # dp=2 vs one card, float32, TF32 off
MESH_PARAM_ATOL, MESH_PARAM_RTOL = 5e-5, 1e-5
MESH_SP_TOL = 1e-4         # the kernel ring's sp step vs the plain ring's
MESH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _mesh_rank_setup():
    """A rank's start: the kernel library phase 1 built (found, never
    rebuilt), TF32 off; ``(rank, device, how the library came)``."""
    import torch
    import torch.distributed as dist
    from sparkflow_tpu_torch.ops import _build
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (dist.get_rank(), torch.device("cuda", torch.cuda.current_device()),
            _build.loaded()["how"])


def _mesh_ring_rank(cases):
    """(a) on each of 2 ranks: ``ring_flash_attention`` and the plain ring on
    this rank's half of the training shape, forward and backward; the
    kernels' launches over one ring call; a single-rank ``flash_attention``
    over the whole sequence; ring fwd+bwd ms (CUDA events, rank 0's
    reading)."""
    import torch
    from sparkflow_tpu_torch.ops import attention as A
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    rank, dev, how = _mesh_rank_setup()
    mesh = Mesh({"sp": 2})
    b, h, s, d = MESH_RING_SHAPE
    sl = s // 2
    cols = slice(rank * sl, (rank + 1) * sl)
    rows = []
    for dtype_name, causal, masked in cases:
        dt = getattr(torch, dtype_name)
        g = torch.Generator().manual_seed(11)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g).to(dev, dt)
                       for _ in range(4))
        mask = None
        if masked:
            lens = torch.randint(s // 2, s + 1, (b,), generator=g)
            mask = (torch.arange(s)[None, :] < lens[:, None]).float().to(dev)
        local_mask = None if mask is None else mask[:, cols].contiguous()

        def run(fn):
            ql, kl, vl = (t[:, :, cols].detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            o = fn(ql, kl, vl, "sp", causal=causal, kv_mask=local_mask)
            o.backward(do[:, :, cols])
            return [o.detach(), ql.grad, kl.grad, vl.grad]

        with mesh.bind():
            A.reset_launch_counts()
            ring = run(A.ring_flash_attention)
            torch.cuda.synchronize()
            launches = {n: A.launch_counts()[n] for n in MESH_NAMES}
            plain = run(A.ring_attention)
            times = []
            for i in range(MESH_RING_REPS + 1):
                a0, a1 = _events()
                a0.record()
                run(A.ring_flash_attention)
                a1.record()
                a1.synchronize()
                if i:
                    times.append(a0.elapsed_time(a1))
        qf, kf, vf = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        of = A.flash_attention(qf, kf, vf, causal=causal, kv_mask=mask)
        of.backward(do)
        full = [of.detach()[:, :, cols], qf.grad[:, :, cols],
                kf.grad[:, :, cols], vf.grad[:, :, cols]]
        errs = {}
        for ref_name, ref in (("plain", plain), ("full", full)):
            errs[ref_name] = {
                "out": max_err(ring[0], ref[0]),
                "grad": max(max_err(a, r) for a, r in zip(ring[1:], ref[1:])),
                "grad_top": max(float(r.float().abs().max())
                                for r in ref[1:]),
                "finite": bool(all(torch.isfinite(t.float()).all()
                                   for t in ring))}
        rows.append({"dtype": dtype_name, "causal": causal, "masked": masked,
                     "errs": errs, "launches": launches,
                     "ring_fwd_bwd_ms": sorted(times)[len(times) // 2]})
        del q, k, v, do, ring, plain, full, qf, kf, vf, of
        torch.cuda.empty_cache()
    return {"rank": rank, "library": how, "rows": rows}


def _mesh_profile_rank(spec, ids, masks, labels):
    """(b) one step of the estimator's dp=2 fit (BERT-base, adam 3e-4, the
    ZeRO stage ``auto`` picks): the trainer's own mesh fit, run in place,
    two epochs of one step each; each rank profiles the second, from the
    first epoch's loss callback to the second's. Rank 0's profile."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev, _ = _mesh_rank_setup()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False)
    marks = []

    def window(loss, it, part):
        # the loss was read back (a sync) before the callback runs
        if not marks:
            prof.start()
            marks.append(time.perf_counter())
        elif len(marks) == 1:
            marks.append(time.perf_counter())
            prof.stop()

    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 mesh=Mesh({"dp": 2}), device=dev, optimizer="adam",
                 learning_rate=3e-4, iters=2, mini_batch_size=len(ids),
                 mini_stochastic_iters=1, seed=0, loss_callback=window)
    res = tr.fit((ids, masks), labels)
    stage = tr._zero_stage
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if len(marks) != 2:
        raise AssertionError(f"rank {rank}: {len(marks)} loss callbacks, "
                             f"want 2")
    if rank != 0:
        return None
    out = _device_profile(prof, (marks[1] - marks[0]) * 1e3, 1,
                          kernels=MESH_NAMES)
    out["zero_stage"] = stage
    out["loss"] = float(res.losses[-1])
    out["finite"] = bool(np.isfinite(out["loss"]))
    return out


def _mesh_exact_dp_rank(spec, stage, ids, masks, labels, opt):
    """(d) a ``Trainer(mesh={"dp": 2})`` fit in place at ``stage`` with the
    optimizer ``opt`` names (:func:`_mesh_exact_kw`), float32, TF32 off;
    rank 0 returns the standard-layout params."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev, _ = _mesh_rank_setup()
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 mesh=Mesh({"dp": 2}), device=dev,
                 sharding=ShardingConfig(zero_stage=stage),
                 **_mesh_exact_kw(opt))
    r = tr.fit((ids, masks), labels)
    out = {"losses": r.losses, "zero_stage": tr._zero_stage,
           "ranks": tr.last_mesh_stats["ranks"]}
    if rank == 0:
        out["params"] = {ln: {k: t.detach().cpu().numpy()
                              for k, t in layer.items()}
                         for ln, layer in r.params.items()}
    return out


def _mesh_sp_rank(spec, ids):
    """(c) on each of 2 ranks: ``Trainer(mesh={"dp": 1, "sp": 2})`` fitting
    in place (as under torchrun): the losses, the fit's wall and this
    rank's accounting."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    _rank, dev, _ = _mesh_rank_setup()
    tr = Trainer(spec, "input_ids", None, optimizer="adam", learning_rate=3e-4,
                 iters=MESH_SP_STEPS, mini_batch_size=MESH_SP_BATCH,
                 mini_stochastic_iters=1, compute_dtype="bfloat16", seed=0,
                 device=dev, mesh=Mesh({"dp": 1, "sp": 2}))
    t0 = time.perf_counter()
    res = tr.fit(ids)
    return {"losses": res.losses, "fit_s": time.perf_counter() - t0,
            "stats": tr.last_mesh_stats}


def _mesh_exact_kw(opt):
    """Adam nearly ignores the gradient's scale, so (d) also takes one SGD
    step at learning rate 1: the params then move by minus the gradient,
    and a missing or doubled 1/n in a reduction shows in full."""
    if opt == "adam":
        return dict(optimizer="adam", learning_rate=3e-4,
                    optimizer_options={"epsilon": 1e-6}, iters=2,
                    mini_batch_size=16, seed=0)
    return dict(optimizer="gradient_descent", learning_rate=1.0, iters=1,
                mini_batch_size=32, seed=0)


def _mesh_exact_sp_rank(spec, ids, masks):
    """(d) one sp=2 SGD step (learning rate 1: the params move by minus the
    gradient) through the kernel ring and through the plain ring from the
    same weights, float32, TF32 off: the loss and gradient differences."""
    import functools
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import ring_attention
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.parallel.sp import make_sp_train_step
    rank, dev, _ = _mesh_rank_setup()
    mesh = Mesh({"dp": 1, "sp": 2})
    model = model_from_json(spec, device=dev)
    p0 = model.init(seed=0)
    sl = ids.shape[1] // 2
    cols = slice(rank * sl, (rank + 1) * sl)
    feed = (torch.tensor(ids[:, cols], device=dev).long(),
            torch.tensor(masks[:, cols], device=dev))
    out = {}
    with mesh.bind():
        for name, att in (("kernel", None), ("plain", functools.partial(
                ring_attention, axis_name="sp"))):
            params = {ln: {k: t.detach().clone().requires_grad_(True)
                           for k, t in layer.items()}
                      for ln, layer in p0.items()}
            opt = build_optimizer("gradient_descent", 1.0)
            step = make_sp_train_step(model, opt, mesh, attention=att)
            params, _, loss = step(params, opt.init(params), *feed, 0)
            out[name] = (float(loss), {ln: {k: p0[ln][k] - t.detach()
                                            for k, t in layer.items()}
                                       for ln, layer in params.items()})
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    top = max(float(g.abs().max()) for layer in gp.values()
              for g in layer.values())
    err = max(float((gk[ln][k] - gp[ln][k]).abs().max())
              for ln in gp for k in gp[ln])
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel": abs(lk - lp) / max(abs(lp), 1e-12),
            "grad_err": err, "grad_top": top,
            "grad_rel": err / max(top, 1e-12)}


def _mesh_estimator_fit(card, spec, label, zero_stage, work, pool):
    """(b) ``SparkAsyncDL(meshShape="dp=2")`` over the BERT-base rows, in
    place on the pool's two ranks, with the mesh accounting of the fit; at
    ZeRO auto rank 0 also holds the fitted model's transform to its
    weights' forward."""
    kw = dict(
        inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
        tfLabel="y:0", tfOutput="probs:0", tfOptimizer="adam",
        tfLearningRate=3e-4, iters=MESH_EST_STEPS,
        miniBatchSize=MESH_EST_BATCH, miniStochasticIters=1,
        labelCol="labels", predictionCol="probs", extraInputCols="mask",
        extraTfInputs="attention_mask:0", meshShape="dp=2",
        zeroStage=zero_stage)
    losses, fit_s, st = _est_in_place(
        pool, kw, MESH_EST_ROWS, None, work, f"mesh-{label}",
        check_card=card if zero_stage < 0 else None)
    if st is None or st["mesh"] != {"dp": 2} or st["launched"]:
        raise AssertionError(f"the estimator did not fit on the mesh: {st}")
    if len(losses) != MESH_EST_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: per-epoch losses {losses}")
    want_stage = 1 if zero_stage < 0 else zero_stage
    if st["zero_stage"] != want_stage:
        raise AssertionError(f"{label}: zero stage {st['zero_stage']}, "
                             f"want {want_stage}")
    per_rank = []
    for r in st["ranks"]:
        for n in MESH_NAMES:
            if r["kernel_launches"][n] != 12 * MESH_EST_STEPS:
                raise AssertionError(
                    f"{label}: rank {r['rank']} launched {n} "
                    f"{r['kernel_launches'][n]} times, want 12 x "
                    f"{MESH_EST_STEPS}")
        steady = sorted(r["epoch_ms"][1:])
        per_rank.append({
            "rank": r["rank"], "device": r["device"],
            "peak_mem_gb": r["peak_memory_bytes"] / 1e9,
            "opt_state_gb": r["opt_state_bytes"] / 1e9,
            "param_gb": r["param_bytes"] / 1e9,
            "bytes_moved_per_step_gb": r["bytes_moved_per_step"] / 1e9,
            "host_staged_gb": r["host_staged_bytes"] / 1e9,
            "step_ms": r["epoch_ms"],
            "step_ms_median_after_first": steady[len(steady) // 2],
            "launches": {n: r["kernel_launches"][n] for n in MESH_NAMES}})
    r0 = per_rank[0]
    summary = {"zero_stage": st["zero_stage"], "backend": st["backend"],
               "fit_s": fit_s, "losses": losses,
               "train_examples_per_s": (MESH_EST_BATCH * 1e3
                                        / r0["step_ms_median_after_first"]),
               "transform_err": st.get("transform_err"),
               "ranks": per_rank}
    log(f"[mesh-dp] {label} " + json.dumps(summary) + f" [{card}]")
    return summary


def _mesh_transform_check(card, fitted, spec, df):
    """(b) the fitted model's transform on this process's card against the
    rank-0 params' single-card predictions (a plain forward)."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.convert import list_to_params
    from sparkflow_tpu_torch.ml_util import resolve_weights
    from sparkflow_tpu_torch.models import model_from_json
    stage = fitted.stages[-1]
    rows = df.collect()[:16]
    got = np.stack([r["probs"].toArray()
                    for r in fitted.transform(df).collect()[:16]])
    model = model_from_json(spec)
    params = list_to_params(model, resolve_weights(
        stage.getOrDefault(stage.modelWeights)))
    feeds = {"input_ids": torch.tensor(np.stack(
                 [r["tokens"].toArray() for r in rows]), device="cuda"),
             "attention_mask": torch.tensor(np.stack(
                 [r["mask"].toArray() for r in rows]), dtype=torch.float32,
                 device="cuda")}
    with torch.inference_mode():
        want = model.apply(params, feeds, ["probs"])["probs"].cpu().numpy()
    err = float(np.abs(got - want).max())
    if not (err <= 1e-5 and np.isfinite(got).all()):
        raise AssertionError(f"mesh-fitted transform vs the rank-0 params' "
                             f"forward: max |d| {err}")
    log(f"[mesh-dp] transform of the dp=2 fit (16 rows) vs the rank-0 "
        f"params' single-card forward: max |d| {err:.3g} (tol 1e-5) "
        f"[{card}]")
    return err


def _rank_release():
    """Free a pool rank's cached card memory: the pool idles while the
    launched fits run."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def mesh_pool():
    """The 2-rank pool of phases 18 and 19's in-place work on the card,
    every wait bounded by ``MESH_TIMEOUT_S``."""
    from sparkflow_tpu_torch.parallel.distributed import RankPool
    os.environ["SPARKFLOW_TORCH_MESH_TIMEOUT_S"] = str(MESH_TIMEOUT_S)
    return RankPool(2, device="cuda")


def _pool_of(pool, kind):
    """``pool`` when the caller shares one (it closes it), else a pool of
    2 ranks on ``kind`` for this phase alone."""
    import contextlib
    from sparkflow_tpu_torch.parallel.distributed import RankPool
    if pool is not None:
        return contextlib.nullcontext(pool)
    return RankPool(2, device=kind)


def phase_mesh(card, work, pool=None):
    """Phase 18: (a) the ring against its plain version on 2 ranks, (b)
    dp=2 on the estimator's path at two zero stages and a profiled step,
    (c) sp=2 on GPT-2 small through ``Trainer(mesh=...)``, (d) exactness
    at full width cut to 2 layers. The in-place work runs in ``pool``
    (:func:`mesh_pool`, shared with phase 19) or a pool of its own.
    Returns the phase's launches and summary."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.localml import LocalSession
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.parallel import distributed
    from sparkflow_tpu_torch.trainer import Trainer
    t0 = time.perf_counter()
    # every collective, a rank's joining and every pool task; a launched
    # fit's ranks end on a collective's timeout
    os.environ["SPARKFLOW_TORCH_MESH_TIMEOUT_S"] = str(MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = distributed.choose_backend(2, "cuda")
    why = ("a card for each rank" if backend == "nccl" else
           "NCCL refuses two ranks on one device: gloo, each collective "
           "staged through pinned host memory")
    log(f"[mesh] 2 ranks on {torch.cuda.device_count()} card(s): backend "
        f"{backend} ({why}) [{card}]")
    out = {"backend": backend}
    spark = LocalSession.builder.appName("mesh").getOrCreate()
    seq, vocab = BERT_BASE["max_len"], BERT_BASE["vocab_size"]
    bert = build_registry_spec("transformer_classifier", **BERT_BASE)
    df = synthetic_text(spark, MESH_EST_ROWS, seq, vocab)
    rows = df.collect()
    ids = np.stack([r["tokens"].toArray() for r in rows]).astype(np.float32)
    masks = np.stack([r["mask"].toArray() for r in rows]).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[[int(r["label"]) for r in rows]]

    with _pool_of(pool, "cuda") as pool:
        # (a) the ring against its plain version and one card's flash
        cases = [(dt, c, m) for dt in ("bfloat16", "float32")
                 for c, m in ((True, False), (False, True))]
        ring = pool.run(_mesh_ring_rank, cases)
        if {r["library"] for r in ring} != {"found"}:
            raise AssertionError(f"a rank did not load the built kernel "
                                 f"library: {[r['library'] for r in ring]}")
        ring_rows = []
        for i, (dt, causal, masked) in enumerate(cases):
            visits = 3 if causal else 4
            got = {n: sum(r["rows"][i]["launches"][n] for r in ring)
                   for n in MESH_NAMES}
            if got != {n: visits for n in MESH_NAMES}:
                raise AssertionError(f"ring {dt} causal={causal}: launches "
                                     f"{got}, want {visits} each")
            for r in ring:
                e = r["rows"][i]["errs"]
                for ref in ("plain", "full"):
                    if not (e[ref]["finite"]
                            and e[ref]["out"] < FLASH_TOL[dt]
                            and e[ref]["grad"]
                            <= BWD_TOL[dt] * e[ref]["grad_top"]):
                        raise AssertionError(
                            f"ring {dt} causal={causal} rank {r['rank']} vs "
                            f"{ref}: {e[ref]}")
            row = {"dtype": dt, "causal": causal, "kv_mask": masked,
                   "launches_summed_over_ranks": got,
                   "errs": [r["rows"][i]["errs"] for r in ring],
                   "ring_fwd_bwd_ms_rank0": ring[0]["rows"][i][
                       "ring_fwd_bwd_ms"]}
            ring_rows.append(row)
            log(f"[mesh-ring] B=8 H=12 S=1024 (512 a rank) D=64 {dt} "
                f"causal={causal} kv_mask={masked}: " + json.dumps(row)
                + f" [{card}]")
        out["ring"] = ring_rows
        # (b) one estimator-shaped step profiled on rank 0
        prof = pool.run(_mesh_profile_rank, bert, ids[:MESH_EST_BATCH],
                        masks[:MESH_EST_BATCH], labels[:MESH_EST_BATCH])[0]
        if not prof["finite"]:
            raise AssertionError(f"profiled dp step: loss {prof['loss']}")
        if prof["zero_stage"] != 1:
            raise AssertionError(f"profiled dp fit: zero stage "
                                 f"{prof['zero_stage']}, auto wants 1")
        log("[mesh-dp] profiled step of the trainer's dp=2 fit, rank 0 "
            "(BERT-base, 16 rows a rank, ZeRO-1): " + json.dumps(prof)
            + f" [{card}]")
        out["dp_profile"] = prof
        # (d) exactness: dp=2 at every stage against one card
        bert2 = build_registry_spec("transformer_classifier", **dict(
            BERT_BASE, num_layers=2, dropout=0.0))
        exact = {}
        for opt in ("adam", "gradient_descent"):
            ref_r = Trainer(bert2, ["input_ids", "attention_mask"], "y",
                            **_mesh_exact_kw(opt)).fit(
                (ids[:32], masks[:32]), labels[:32])
            want = {ln: {k: t.detach().cpu().numpy()
                         for k, t in layer.items()}
                    for ln, layer in ref_r.params.items()}
            exact[opt] = {}
            for stage in (0, 1, 2, 3):
                got = pool.run(_mesh_exact_dp_rank, bert2, stage, ids[:32],
                               masks[:32], labels[:32], opt)
                lrel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(
                    got[0]["losses"], ref_r.losses))
                perr = max(float(np.max(
                    np.abs(got[0]["params"][ln][k] - want[ln][k])
                    - MESH_PARAM_RTOL * np.abs(want[ln][k])))
                    for ln in want for k in want[ln])
                e = exact[opt][stage] = {"loss_rel": lrel,
                                         "param_excess": perr,
                                         "zero_stage": got[0]["zero_stage"]}
                if not (got[0]["zero_stage"] == stage
                        and len(got[0]["losses"]) == len(ref_r.losses)
                        and lrel <= MESH_LOSS_RTOL
                        and perr <= MESH_PARAM_ATOL
                        and got[0]["losses"] == got[1]["losses"]):
                    raise AssertionError(f"dp=2 {opt} stage {stage} vs one "
                                         f"card: {e}")
        log(f"[mesh-exact] dp=2 stages 0-3 vs one card (BERT-base widths, "
            f"2 layers, float32, TF32 off; 2 adam steps of 16 rows, 1 SGD "
            f"step at learning rate 1 of 32 rows): " + json.dumps(exact)
            + f" (losses <= {MESH_LOSS_RTOL} relative, params |d| - "
            f"{MESH_PARAM_RTOL} |p| <= {MESH_PARAM_ATOL}) [{card}]")
        out["dp_exact"] = exact
        lm2 = build_registry_spec("transformer_lm", **dict(
            GPT2_SMALL, num_layers=2, dropout=0.0))
        rs = np.random.RandomState(5)
        sp_ids = rs.randint(0, 1000, (2, 1024)).astype(np.float32)
        sp_mask = np.ones((2, 1024), np.float32)
        sp_mask[1, 900:] = 0.0
        sp_ex = pool.run(_mesh_exact_sp_rank, lm2, sp_ids, sp_mask)
        for e in sp_ex:
            if not (e["loss_rel"] <= MESH_SP_TOL
                    and e["grad_rel"] <= MESH_SP_TOL):
                raise AssertionError(f"sp=2 step, kernel ring vs plain ring: "
                                     f"{e}")
        log(f"[mesh-exact] sp=2 step (GPT-2-small widths, 2 layers, float32, "
            f"TF32 off), kernel ring vs plain ring: " + json.dumps(sp_ex)
            + f" (tol {MESH_SP_TOL}) [{card}]")
        out["sp_exact"] = sp_ex

        # (b) the estimator's path, dp=2 at ZeRO auto (adam -> 1) and 3
        out["dp"] = {label: _mesh_estimator_fit(card, bert, label, stage,
                                                work, pool)
                     for label, stage in (("auto", -1), ("zero3", 3))}
        out["transform_err"] = out["dp"]["auto"]["transform_err"]
        pool.run(_rank_release)

        # (c) sp=2 on GPT-2 small through Trainer(mesh=...), in place
        lm = build_registry_spec("transformer_lm", **dict(GPT2_SMALL,
                                                          dropout=0.1))
        sp_ids = np.random.RandomState(9).randint(
            0, 1000, (MESH_SP_BATCH, 1024)).astype(np.float32)
        got = pool.run(_mesh_sp_rank, lm, sp_ids)
        pool.run(_rank_release)
    losses, sp_fit_s = got[0]["losses"], got[0]["fit_s"]
    st = dict(got[0]["stats"], ranks=[g["stats"]["ranks"][0] for g in got])
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and got[1]["losses"] == losses):
        raise AssertionError(f"sp=2 GPT-2 small losses "
                             f"{[g['losses'] for g in got]}")
    sp_launches = {n: sum(r["kernel_launches"][n] for r in st["ranks"])
                   for n in MESH_NAMES}
    want_l = 3 * GPT2_SMALL["num_layers"] * MESH_SP_STEPS
    if sp_launches != {n: want_l for n in MESH_NAMES}:
        raise AssertionError(f"sp=2 launches {sp_launches}, want {want_l} "
                             f"each (3 ring visits x 12 layers x "
                             f"{MESH_SP_STEPS} steps)")
    steady = sorted(st["ranks"][0]["epoch_ms"][1:])
    sp_sum = {"losses": losses, "fit_s": sp_fit_s,
              "backend": st["backend"],
              "step_ms": st["ranks"][0]["epoch_ms"],
              "tokens_per_s": (MESH_SP_BATCH * 1024 * 1e3
                               / steady[len(steady) // 2]),
              "launches_summed_over_ranks": sp_launches,
              "ranks": [{"rank": r["rank"],
                         "peak_mem_gb": r["peak_memory_bytes"] / 1e9,
                         "bytes_moved_per_step_gb":
                             r["bytes_moved_per_step"] / 1e9,
                         "launches": {n: r["kernel_launches"][n]
                                      for n in MESH_NAMES}}
                        for r in st["ranks"]]}
    log("[mesh-sp] GPT-2 small (bf16, dropout 0.1, adam 3e-4), "
        "Trainer(mesh={'dp': 1, 'sp': 2}) in place on 2 ranks, batch 8 x "
        "1024: "
        + json.dumps(sp_sum) + f" [{card}]")
    out["sp"] = sp_sum

    dp_launches = {n: sum(r["launches"][n] for lab in ("auto", "zero3")
                          for r in out["dp"][lab]["ranks"])
                   for n in MESH_NAMES}
    out["launches"] = {"dp": dp_launches, "sp_ring": sp_launches}
    log(f"[mesh] phase 18 {time.perf_counter() - t0:.1f} s")
    return out


def _mesh_launches(mesh, name):
    return {"dp": mesh["launches"]["dp"][name],
            "sp_ring": mesh["launches"]["sp_ring"][name]}


# phase 19: the data-parallel remainder — stream fits on a dp mesh, in-fit
# resume on a launched mesh, optimizer-state offload, dp serving
SM_ROWS, SM_BATCH = 96, 32      # (a): 3 stream steps of 32 x 512
SM_EXACT_ROWS = 64              # (b): 2 stream steps of 32 x 512
# (b) the resumed fits: 32 rows, 2 steps an epoch, 3 epochs, a checkpoint
# after each; the crash and the kill come at epoch 2
SM_RESUME = dict(optimizer="adam", learning_rate=3e-4,
                 optimizer_options={"epsilon": 1e-6}, iters=3,
                 mini_batch_size=16, seed=0, shuffle_per_iter=False)
SM_LOSS_RTOL = 1e-6        # (b) the stream dp=2 fit vs one card's stream
SM_SERVE_TOL = 1e-5
SM_SERVE_REPS = 5


def _sm_rows(ids, masks, labels):
    """A ``fit_stream`` row factory: ``((ids, mask), one-hot label)`` per
    row, as the estimator's stream hands them over."""
    return lambda: iter(zip(zip(ids, masks), labels))


def _sm_stream_kw():
    return dict(optimizer="adam", learning_rate=3e-4,
                optimizer_options={"epsilon": 1e-6},
                mini_batch_size=SM_BATCH, seed=0)


def _np_tree(params):
    return {ln: {k: t.detach().cpu().numpy() for k, t in layer.items()}
            for ln, layer in params.items()}


def _sm_rank_setup(device):
    """A phase-19 rank's ``(rank, device)``: phase 18's set-up on the card
    (the library phase 1 built, TF32 off), the CPU for a rehearsal (one
    thread: the CPU's threaded kernels vary in the last bits from run to
    run, which the bit-equality checks would see)."""
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(1)
        return dist.get_rank(), torch.device("cpu")
    rank, dev, _ = _mesh_rank_setup()
    return rank, dev


def _sm_stream_rank(spec, stage, ids, masks, labels, offload, device,
                    ck=None):
    """(b) an in-place ``Trainer(mesh={"dp": 2}).fit_stream`` at ``stage``
    on this rank (every rank reads the same stream and keeps its rows),
    saving a checkpoint into ``ck`` after each step when given; a digest
    of each leaf of this rank's final optimizer state, and rank 0 the
    standard-layout params."""
    import hashlib
    import torch
    from sparkflow_tpu_torch.optimizers_sharded import state_leaves
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 mesh=Mesh({"dp": 2}), device=dev,
                 sharding=ShardingConfig(zero_stage=stage,
                                         offload_opt_state=offload),
                 checkpoint_dir=ck, checkpoint_every=1 if ck else 0,
                 **_sm_stream_kw())
    r = tr.fit_stream(_sm_rows(ids, masks, labels))
    state = [t for t in state_leaves(tr._last_opt_state)
             if torch.is_tensor(t)]
    out = {"losses": r.losses, "zero_stage": tr._zero_stage,
           "offload": tr._offload_active,
           "opt_on_host": all(not t.is_cuda for t in state),
           "opt_digest": [hashlib.sha256(t.detach().cpu().numpy().tobytes())
                          .hexdigest() for t in state]}
    if rank == 0:
        out["params"] = _np_tree(r.params)
    return out


def _sm_saved_opt_equal(a, b):
    """Whether two checkpoint directories hold the same steps and, at each,
    the same optimizer-state leaves bit for bit; and how many leaves."""
    import numpy as np
    from sparkflow_tpu_torch.checkpoint import CheckpointManager
    from sparkflow_tpu_torch.optimizers_sharded import state_leaves
    ma, mb = CheckpointManager(a), CheckpointManager(b)
    steps = ma.all_steps()
    same, leaves = bool(steps) and steps == mb.all_steps(), 0
    for step in steps if same else []:
        la, lb = (state_leaves(m.restore(step=step)["opt_state"])
                  for m in (ma, mb))
        leaves += len(la)
        same = same and len(la) == len(lb) > 0 and all(
            np.array_equal(x, y) for x, y in zip(la, lb))
    return {"steps": steps, "leaves": leaves, "bit_equal": same}


def _sm_fit_rank(spec, ids, masks, labels, device):
    """(b) the uninterrupted ``Trainer(mesh={"dp": 2}).fit`` of the resume
    checks, in place, at ZeRO 1; rank 0's standard-layout params."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 mesh=Mesh({"dp": 2}), device=dev,
                 sharding=ShardingConfig(zero_stage=1), **SM_RESUME)
    r = tr.fit((ids, masks), labels)
    return {"losses": r.losses,
            "params": _np_tree(r.params) if rank == 0 else None}


def _sm_profile_rank(spec, ids, masks, labels):
    """(a) one step of an in-place dp=2 stream fit (BERT-base, ZeRO 1),
    profiled on each rank from the first step's loss callback to the
    second's (batch assembly, staging, step, loss read-back); rank 0's
    profile."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev, _ = _mesh_rank_setup()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False)
    marks = []

    def window(loss, step, part):
        if not marks:
            prof.start()
            marks.append(time.perf_counter())
        elif len(marks) == 1:
            marks.append(time.perf_counter())
            prof.stop()

    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 mesh=Mesh({"dp": 2}), device=dev,
                 sharding=ShardingConfig(zero_stage=1), loss_callback=window,
                 **dict(_sm_stream_kw(), optimizer_options=None))
    res = tr.fit_stream(_sm_rows(ids, masks, labels))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if len(marks) != 2:
        raise AssertionError(f"rank {rank}: {len(marks)} loss callbacks, "
                             f"want 2")
    if rank != 0:
        return None
    out = _device_profile(prof, (marks[1] - marks[0]) * 1e3, 1,
                          kernels=MESH_NAMES)
    out["losses"] = res.losses
    out["finite"] = all(math.isfinite(x) for x in res.losses)
    return out


def _sm_estimator(card, spec, df, work, mesh_out, device):
    """(a) ``SparkAsyncDL(fitMode="stream", meshShape="dp=2", zeroStage=1,
    checkpointDir=...)`` through a pipeline: the live losses, the fit's
    mesh accounting and the fitted pipeline."""
    from sparkflow_tpu_torch.checkpoint import CheckpointManager
    from sparkflow_tpu_torch.localml import OneHotEncoder, Pipeline
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    losses = []
    ck = os.path.join(work, "stream-mesh-ck")
    steps = SM_ROWS // SM_BATCH
    est = SparkAsyncDL(
        inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
        tfLabel="y:0", tfOutput="probs:0", tfOptimizer="adam",
        tfLearningRate=3e-4, iters=1, miniBatchSize=SM_BATCH,
        labelCol="labels", predictionCol="probs", extraInputCols="mask",
        extraTfInputs="attention_mask:0", fitMode="stream",
        meshShape="dp=2", zeroStage=1, checkpointDir=ck,
        checkpointEvery=steps,
        weightsPath=os.path.join(work, "stream-mesh"), device=device)
    est.setLossCallback(lambda loss, it, part: losses.append(loss))
    pipe = Pipeline(stages=[OneHotEncoder(inputCol="label",
                                          outputCol="labels",
                                          dropLast=False), est])
    t0 = time.perf_counter()
    fitted = pipe.fit(df)
    fit_s = time.perf_counter() - t0
    st = est.last_mesh_stats
    if st is None or st["mesh"] != {"dp": 2} or not st["launched"]:
        raise AssertionError(f"the stream fit did not run on the mesh: {st}")
    if st["zero_stage"] != 1 or len(losses) != steps or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"stream fit: zero stage {st['zero_stage']}, "
                             f"live losses {losses}")
    if CheckpointManager(ck).all_steps() != [steps]:
        raise AssertionError(f"stream fit checkpoints "
                             f"{CheckpointManager(ck).all_steps()}")
    launches = {n: 0 for n in MESH_NAMES}
    ranks = []
    layers = json.loads(spec)["config"]["num_layers"]
    for r in st["ranks"]:
        for n in MESH_NAMES:
            if device != "cpu" and r["kernel_launches"][n] != layers * steps:
                raise AssertionError(
                    f"stream fit: rank {r['rank']} launched {n} "
                    f"{r['kernel_launches'][n]} times, want {layers} x "
                    f"{steps}")
            launches[n] += r["kernel_launches"][n]
        steady = sorted(r["epoch_ms"][1:])
        ranks.append({
            "rank": r["rank"], "device": r["device"],
            "bytes_moved_gb": {k: v / 1e9 for k, v in
                               r["bytes_moved"].items()},
            "bytes_moved_per_step_gb": r["bytes_moved_per_step"] / 1e9,
            "host_staged_gb": r["host_staged_bytes"] / 1e9,
            "peak_mem_gb": (r["peak_memory_bytes"] or 0) / 1e9,
            "step_ms": r["epoch_ms"],
            "step_ms_median_after_first": steady[len(steady) // 2]})
    collect = (mesh_out or {}).get("dp", {}).get("auto", {})
    summary = {
        "zero_stage": st["zero_stage"], "backend": st["backend"],
        "fit_s": fit_s, "live_losses": losses,
        "train_examples_per_s": (SM_BATCH * 1e3
                                 / ranks[0]["step_ms_median_after_first"]),
        "phase18_collect_train_examples_per_s":
            collect.get("train_examples_per_s"),
        "launches_summed_over_ranks": launches, "ranks": ranks}
    log("[stream-mesh] SparkAsyncDL(fitMode='stream', meshShape='dp=2', "
        "zeroStage=1) BERT-base, 96 rows, batch 32 x 512: "
        + json.dumps(summary) + f" [{card}]")
    return fitted, summary


def _sm_check_resume(card, label, tr, res, want, fired):
    import numpy as np
    got = _np_tree(res.params)
    same = all(np.array_equal(got[ln][k], want["params"][ln][k])
               for ln in want["params"] for k in want["params"][ln])
    rel = max(float(np.abs(got[ln][k] - want["params"][ln][k]).max())
              / max(float(np.abs(want["params"][ln][k]).max()), 1e-30)
              for ln in want["params"] for k in want["params"][ln])
    e = {"fired": fired, "completed": res.completed,
         "launched": tr.last_mesh_stats["launched"],
         "losses_equal": res.losses == want["losses"],
         "params_bit_equal": same, "params_max_rel_delta": rel}
    log(f"[stream-mesh-exact] {label} vs the uninterrupted dp=2 fit "
        f"(BERT-base widths, 2 layers, ZeRO 1, 3 epochs of 2 steps): "
        + json.dumps(e) + f" (bar: params bit-equal) [{card}]")
    if not (fired and res.completed and same and e["losses_equal"]):
        raise AssertionError(f"{label}: {e}")
    return e


def _sm_serving(card, fitted, spec, df, device):
    """(c) the fitted model's ``transform`` with ``meshShape="dp=2"`` and
    ``InferenceEngine(mesh={"dp": 2})`` at bucket 32, each against the
    engine without a mesh."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ml_util import resolve_weights
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import InferenceEngine
    stage = fitted.stages[-1]
    weights = resolve_weights(stage.getOrDefault(stage.modelWeights))
    rows = df.collect()[:SM_BATCH]
    ids = np.stack([r["tokens"].toArray() for r in rows]).astype(np.int64)
    masks = np.stack([r["mask"].toArray() for r in rows]).astype(np.float32)
    kw = dict(input_name=["input_ids:0", "attention_mask:0"],
              output_name="probs:0", max_batch=SM_BATCH, device=device)
    layers = json.loads(spec)["config"]["num_layers"]
    plain = InferenceEngine(spec, weights, **kw)
    dp = InferenceEngine(spec, weights, mesh={"dp": 2}, **kw)
    want = plain.predict((ids, masks))
    reset_launch_counts()
    got = dp.predict((ids, masks))
    _sync(device != "cpu")
    bucket_launches = launch_counts()["flash_fwd"]
    if device != "cpu" and bucket_launches != 2 * layers:
        raise AssertionError(f"dp engine bucket: flash_fwd launched "
                             f"{bucket_launches} times, want 12 a copy")
    times = {}
    for name, eng in (("plain", plain), ("dp2", dp)):
        t = []
        for _ in range(SM_SERVE_REPS):
            t0 = time.perf_counter()
            eng.predict((ids, masks))
            t.append(time.perf_counter() - t0)
        times[name] = SM_BATCH / sorted(t)[len(t) // 2]
    stage.setParams(meshShape="dp=2")
    t0 = time.perf_counter()
    served = fitted.transform(df).collect()
    transform_s = time.perf_counter() - t0
    stage.setParams(meshShape="")
    tr_probs = np.stack([r["probs"].toArray() for r in served[:SM_BATCH]])
    e = {"engine_dp2_err": float(np.abs(got - want).max()),
         "transform_dp2_err": float(np.abs(tr_probs - want).max()),
         "finite": bool(np.isfinite(got).all() and np.isfinite(
             tr_probs).all()),
         "engine_mesh": dp.stats()["mesh"],
         "flash_fwd_launches_per_bucket_call": bucket_launches,
         "engine_rows_per_s": times,
         "transform_dp2_rows_per_s": len(served) / transform_s}
    log("[stream-mesh-serve] BERT-base float32, bucket 32 x 512: "
        + json.dumps(e) + f" (tol {SM_SERVE_TOL}) [{card}]")
    if not (e["finite"] and e["engine_dp2_err"] <= SM_SERVE_TOL
            and e["transform_dp2_err"] <= SM_SERVE_TOL
            and e["engine_mesh"] == {"dp": 2}):
        raise AssertionError(f"dp serving: {e}")
    del plain, dp
    return e, bucket_launches


def phase_stream_mesh(card, work, mesh_out, device=None, pool=None):
    """Phase 19: (a) the estimator's stream fit on a dp=2 mesh and a
    profiled stream step, (b) exactness at 2 layers (stream dp vs one card
    at ZeRO 0-3, offload, a crash resumed in the fit, a killed rank
    relaunched), (c) dp serving. The in-place work runs in ``pool``
    (phase 18's) or a pool of its own. Returns the phase's launches and
    summary. Rehearse it on the CPU with ``device="cpu"`` and a shrunk
    ``BERT_BASE`` (the ranks get the spec as an argument)."""
    import multiprocessing
    import numpy as np
    import torch
    from sparkflow_tpu_torch.localml import LocalSession
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.resilience import faults
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    t0 = time.perf_counter()
    cuda = device != "cpu"
    kind = "cuda" if cuda else "cpu"
    os.environ["SPARKFLOW_TORCH_MESH_TIMEOUT_S"] = str(MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    spark = LocalSession.builder.appName("stream-mesh").getOrCreate()
    bert = build_registry_spec("transformer_classifier", **BERT_BASE)
    bert2 = build_registry_spec("transformer_classifier", **dict(
        BERT_BASE, num_layers=2, dropout=0.0))
    df = synthetic_text(spark, SM_ROWS, BERT_BASE["max_len"],
                        BERT_BASE["vocab_size"])
    rows = df.collect()
    ids = np.stack([r["tokens"].toArray() for r in rows]).astype(np.float32)
    masks = np.stack([r["mask"].toArray() for r in rows]).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[[int(r["label"]) for r in rows]]

    # (a) the main path: the estimator's stream fit on the mesh
    fitted, out["fit"] = _sm_estimator(card, bert, df, work, mesh_out,
                                       device)

    ex = slice(0, SM_EXACT_ROWS)
    one = Trainer(bert2, ["input_ids", "attention_mask"], "y", device=device,
                  **_sm_stream_kw())
    ref = one.fit_stream(_sm_rows(ids[ex], masks[ex], labels[ex]))
    ref_p = _np_tree(ref.params)
    del one
    with _pool_of(pool, kind) as pool:
        pool_ranks = set(pool._procs)
        if cuda:
            prof = pool.run(_sm_profile_rank, bert, ids[:SM_EXACT_ROWS],
                            masks[:SM_EXACT_ROWS],
                            labels[:SM_EXACT_ROWS])[0]
            if not prof["finite"]:
                raise AssertionError(f"profiled stream step: "
                                     f"{prof['losses']}")
            log("[stream-mesh] profiled step of an in-place dp=2 stream "
                "fit, rank 0 (BERT-base, 16 rows a rank, ZeRO-1): "
                + json.dumps(prof) + f" [{card}]")
            out["profile"] = prof
        # (b) the stream dp=2 fit at every stage against one card's
        exact = {}
        stage2 = None
        for stage in (0, 1, 2, 3):
            # stage 2 saves after each step: offload's baseline below
            got = pool.run(_sm_stream_rank, bert2, stage, ids[ex], masks[ex],
                           labels[ex], False, kind,
                           os.path.join(work, "sm-z2") if stage == 2
                           else None)
            lrel = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(got[0]["losses"], ref.losses))
            perr = max(float(np.max(
                np.abs(got[0]["params"][ln][k] - ref_p[ln][k])
                - MESH_PARAM_RTOL * np.abs(ref_p[ln][k])))
                for ln in ref_p for k in ref_p[ln])
            e = exact[stage] = {"loss_rel": lrel, "param_excess": perr,
                                "zero_stage": got[0]["zero_stage"]}
            if not (got[0]["zero_stage"] == stage
                    and len(got[0]["losses"]) == len(ref.losses) == 2
                    and lrel <= SM_LOSS_RTOL
                    and perr <= MESH_PARAM_ATOL
                    and got[0]["losses"] == got[1]["losses"]):
                raise AssertionError(f"stream dp=2 stage {stage} vs one "
                                     f"card: {e}")
            if stage == 2:
                stage2 = got
        log("[stream-mesh-exact] stream dp=2 stages 0-3 vs one card's stream "
            "(BERT-base widths, 2 layers, float32, TF32 off; 2 adam steps of "
            "32 rows): " + json.dumps(exact) + f" (losses <= "
            f"{SM_LOSS_RTOL} relative, params |d| - {MESH_PARAM_RTOL} |p| "
            f"<= {MESH_PARAM_ATOL}) [{card}]")
        out["stream_exact"] = exact
        off = pool.run(_sm_stream_rank, bert2, 2, ids[ex], masks[ex],
                       labels[ex], True, kind,
                       os.path.join(work, "sm-z2-offload"))
        e = {"offload": [r["offload"] for r in off],
             "losses_bit_equal": [a["losses"] == b["losses"]
                                  for a, b in zip(off, stage2)],
             "opt_state_on_host": [r["opt_on_host"] for r in off],
             "final_opt_leaves": [len(r["opt_digest"]) for r in off],
             "final_opt_bit_equal": [
                 len(a["opt_digest"]) > 0 and a["opt_digest"]
                 == b["opt_digest"] for a, b in zip(off, stage2)],
             "saved_opt": _sm_saved_opt_equal(
                 os.path.join(work, "sm-z2"),
                 os.path.join(work, "sm-z2-offload")),
             "max_loss_delta": max(abs(a - b) for a, b in zip(
                 off[0]["losses"], stage2[0]["losses"]))}
        log("[stream-mesh-exact] offload_opt_state at ZeRO 2 vs the same "
            "stream fit without it, each saving after every step: "
            + json.dumps(e) + f" (bar: losses, each rank's final optimizer "
            f"state and every saved optimizer leaf bit-equal) [{card}]")
        if not (all(e["offload"]) and all(e["losses_bit_equal"])
                and all(e["opt_state_on_host"])
                and all(e["final_opt_bit_equal"])
                and e["saved_opt"]["bit_equal"]
                and e["saved_opt"]["steps"] == [1, 2]):
            raise AssertionError(f"offload: {e}")
        out["offload"] = e
        want = pool.run(_sm_fit_rank, bert2, ids[:32], masks[:32],
                        labels[:32], kind)[0]
        pool.run(_rank_release)

    # (b) in-fit resume on a launched mesh: a raising callback, a killed
    # rank (one of the fit's own, not of a pool shared with phase 18)
    def launched(name, cb):
        return Trainer(bert2, ["input_ids", "attention_mask"], "y",
                       mesh={"dp": 2}, device=device,
                       sharding=ShardingConfig(zero_stage=1),
                       checkpoint_dir=os.path.join(work, name),
                       checkpoint_every=1, resume_retries=1,
                       loss_callback=cb, **SM_RESUME)

    crash = faults.crash_at(2)
    tr = launched("sm-crash", crash)
    res = tr.fit((ids[:32], masks[:32]), labels[:32])
    out["crash"] = _sm_check_resume(card, "a callback raising at epoch 2, "
                                    "resumed in the fit", tr, res, want,
                                    crash.fired == 1)
    killed = []

    def kill(loss, it, part):
        if it == 2 and not killed:
            victim = [c for c in multiprocessing.active_children()
                      if c not in pool_ranks][0]
            killed.append(victim.pid)
            os.kill(victim.pid, signal.SIGKILL)

    tr = launched("sm-kill", kill)
    res = tr.fit((ids[:32], masks[:32]), labels[:32])
    out["kill"] = _sm_check_resume(card, "a rank killed at epoch 2, "
                                   "relaunched from its checkpoint", tr,
                                   res, want, len(killed) == 1)
    del tr

    # (c) dp serving of the fitted model
    out["serve"], bucket_launches = _sm_serving(card, fitted, bert, df,
                                                device)
    launches = dict(out["fit"]["launches_summed_over_ranks"])
    out["launches"] = {n: {"stream_fit": launches[n]} for n in MESH_NAMES}
    out["launches"]["flash_fwd"]["dp_engine_bucket"] = bucket_launches
    log(f"[stream-mesh] phase 19 {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# phase 20: tensor parallelism and fsdp (ROADMAP 7d). On a one-card machine
# the ranks share the card over gloo and the tp shards of one-process
# serving sit on the same card: the phase shows the mesh layer and kernels
# 1-7 at a tp shard's head count (6 of 12 at tp=2), not scaling.
TPF_TRAIN_BATCH, TPF_TRAIN_STEPS = 8, 3          # (a) GPT-2 small 8 x 1024
TPF_EST_ROWS, TPF_EST_BATCH, TPF_EST_STEPS = 64, 32, 2    # (b) 2 steps each
# (b) BERT-base's widths cut to 2 layers: a launched fit's cost is mostly
# its ranks' start, which depth does not cut
TPF_EST_LAYERS = 2
TPF_EST_FITS = (("tp=2", "collect", True), ("fsdp=2", "collect", False),
                ("fsdp=2", "stream", True))    # (mesh, fitMode, launched)
TPF_DEC_LENS = (20, 57, 100, 150, 200, 256, 300, 400)     # (c) 8 prompts
TPF_DEC_NEW = 32
TPF_PREDICT_BATCH, TPF_PREDICT_REPS = 32, 5      # (d) one bucket
TPF_PREDICT_TOL = 1e-4
TPF_LOSS_RTOL = 1e-5                 # (e) one SGD step vs one card
TPF_PARAM_RTOL, TPF_PARAM_ATOL = 3e-4, 3e-5      # tests/test_models.py's pin
TPF_ADAM_RTOL = 2e-4                 # (e) 3 adam steps' losses vs one card
TPF_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attention",
             "paged_attention_quant", "paged_verify", "paged_verify_quant")


def _tpf_digest(params):
    """sha256 of each leaf's bytes, ``{layer: {name: hex}}``."""
    import hashlib
    return {ln: {k: hashlib.sha256(t.detach().cpu().numpy().tobytes())
                 .hexdigest() for k, t in layer.items()}
            for ln, layer in params.items()}


def _tpf_fit_rank(spec, axes, kw, ids, masks, labels, device):
    """(e) a ``Trainer(mesh=axes)`` fit in place on this rank (TF32 off):
    losses, the checkpoint epoch it resumed from, a digest of every leaf
    this rank returns (a replicated leaf is the rank's own copy), and rank
    0 the standard-layout params."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y", mesh=Mesh(axes),
                 device=dev, **kw)
    r = tr.fit((ids, masks), labels)
    out = {"losses": r.losses, "resumed_from": tr._resumed_from,
           "zero_stage": tr._zero_stage, "digest": _tpf_digest(r.params),
           "param_bytes": tr.last_mesh_stats["ranks"][0]["param_bytes"]}
    if rank == 0:
        out["params"] = _np_tree(r.params)
    return out


def _tpf_excess(got, want):
    """max over leaves of ``|got - want| - rtol |want|`` (<= atol passes)."""
    import numpy as np
    return max(float(np.max(np.abs(got[ln][k] - want[ln][k])
                            - TPF_PARAM_RTOL * np.abs(want[ln][k])))
               for ln in want for k in want[ln])


def _tpf_rank_rows(st, names):
    """Each rank's accounting of a launched tp / fsdp fit."""
    rows = []
    for r in st["ranks"]:
        steady = sorted(r["epoch_ms"][1:] or r["epoch_ms"])
        rows.append({
            "rank": r["rank"], "device": r["device"],
            "step_ms": r["epoch_ms"],
            "step_ms_median_after_first": steady[len(steady) // 2],
            "bytes_moved_per_step_gb": r["bytes_moved_per_step"] / 1e9,
            "bytes_moved_gb": {k: v / 1e9 for k, v in
                               r["bytes_moved"].items()},
            "host_staged_gb": r["host_staged_bytes"] / 1e9,
            "collective_calls": r["collective_calls"],
            "param_gb": r["param_bytes"] / 1e9,
            "opt_state_gb": r["opt_state_bytes"] / 1e9,
            "peak_mem_gb": (r["peak_memory_bytes"] or 0) / 1e9,
            "launches": {n: r["kernel_launches"][n] for n in names}})
    return rows


def _tpf_full_bytes(spec):
    """float32 bytes of one whole copy of ``spec``'s params."""
    import numpy as np
    from sparkflow_tpu_torch.models import model_from_json
    return sum(4 * int(np.prod(shape)) for layer in model_from_json(
        spec, device="cpu").param_specs().values()
        for shape, _init in layer.values())


def _tpf_train_rank(spec, ids, device):
    """(a) on each of 2 ranks: ``Trainer(mesh={"dp": 1, "tp": 2})`` fitting
    in place (as under torchrun), the fit's wall and this rank's
    accounting."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    _rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, "input_ids", None, optimizer="adam", learning_rate=3e-4,
                 iters=TPF_TRAIN_STEPS, mini_batch_size=TPF_TRAIN_BATCH,
                 mini_stochastic_iters=1, seed=0, device=dev,
                 compute_dtype="bfloat16" if device != "cpu" else None,
                 mesh=Mesh({"dp": 1, "tp": 2}))
    t0 = time.perf_counter()
    res = tr.fit(ids)
    return {"losses": res.losses, "fit_s": time.perf_counter() - t0,
            "stats": tr.last_mesh_stats}


def _tpf_training(card, device, pool):
    """(a) GPT-2 small at ``tp=2`` through ``Trainer(mesh={"dp": 1, "tp":
    2})`` on the pool's two ranks: bf16, dropout 0.1, adam 3e-4, batch 8 x
    1024, 3 steps."""
    import numpy as np
    from sparkflow_tpu_torch.models import build_registry_spec
    lm = build_registry_spec("transformer_lm", **dict(GPT2_SMALL,
                                                      dropout=0.1))
    rs = np.random.RandomState(9)
    ids = rs.randint(0, min(1000, GPT2_SMALL["vocab_size"]),
                     (TPF_TRAIN_BATCH, GPT2_SMALL["max_len"])
                     ).astype(np.float32)
    got = pool.run(_tpf_train_rank, lm, ids, device)
    st = dict(got[0]["stats"], ranks=[g["stats"]["ranks"][0] for g in got])
    losses = got[0]["losses"]
    if not (st["mesh"] == {"dp": 1, "tp": 2}
            and all(math.isfinite(x) for x in losses)
            and len(losses) == TPF_TRAIN_STEPS
            and got[1]["losses"] == losses):
        raise AssertionError(f"tp=2 GPT-2 small: {st['mesh']} losses "
                             f"{[g['losses'] for g in got]}")
    ranks = _tpf_rank_rows(st, MESH_NAMES)
    want_l = GPT2_SMALL["num_layers"] * TPF_TRAIN_STEPS
    for r in ranks:
        if device != "cpu" and r["launches"] != {n: want_l
                                                 for n in MESH_NAMES}:
            raise AssertionError(f"tp=2 rank {r['rank']} launches "
                                 f"{r['launches']}, want {want_l} each")
    full = _tpf_full_bytes(lm)
    tokens = TPF_TRAIN_BATCH * GPT2_SMALL["max_len"]
    out = {"losses": losses, "fit_s": got[0]["fit_s"],
           "backend": st["backend"],
           "tokens_per_s": tokens * 1e3 / ranks[0][
               "step_ms_median_after_first"],
           "param_bytes_share_of_one_card": [r["param_gb"] * 1e9 / full
                                             for r in ranks],
           "one_card_param_gb": full / 1e9, "ranks": ranks}
    log("[tp-fsdp] (a) GPT-2 small, Trainer(mesh={'dp': 1, 'tp': 2}) in "
        "place on 2 ranks, bf16, dropout 0.1, adam 3e-4, batch 8 x 1024, 3 "
        "steps, 6 of 12 heads a rank: " + json.dumps(out) + f" [{card}]")
    return out, {n: sum(r["launches"][n] for r in ranks) for n in MESH_NAMES}


def _tpf_one_card_ex_s(spec, ids, masks, labels, device):
    """Training examples/s of one card's ``Trainer`` on the estimator's
    rows, one step an epoch: the last step's host time, from the loss read
    of the step before to its own. ``masks`` None: tokens only."""
    from sparkflow_tpu_torch.trainer import Trainer
    marks = []
    names = "input_ids" if masks is None else ["input_ids", "attention_mask"]
    Trainer(spec, names, "y", optimizer="adam",
            learning_rate=3e-4, iters=TPF_EST_STEPS + 1,
            mini_batch_size=TPF_EST_BATCH, mini_stochastic_iters=1, seed=0,
            device=device, loss_callback=lambda loss, it, part: marks.append(
                time.perf_counter())).fit(
        ids if masks is None else (ids, masks), labels)
    return TPF_EST_BATCH / (marks[-1] - marks[-2])


def _est_rank(est_kw, rows, seq_len, vocab, device, weights_dir,
              check_card=None):
    """An estimator fit in place on this rank (as under torchrun):
    ``Pipeline([OneHotEncoder, SparkAsyncDL(**est_kw)])`` over
    ``synthetic_text``'s ``rows`` rows (the same on every rank): this
    rank's live losses, the fit's wall and mesh accounting; with
    ``check_card``, rank 0 holds the fitted model's transform to a forward
    of the fitted weights (:func:`_mesh_transform_check`)."""
    from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                             Pipeline)
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    rank, _dev = _sm_rank_setup(device)
    os.makedirs(weights_dir, exist_ok=True)
    spark = LocalSession.builder.appName("est-in-place").getOrCreate()
    df = synthetic_text(spark, rows, seq_len, vocab)
    losses = []
    est = SparkAsyncDL(device=device, weightsPath=os.path.join(
        weights_dir, f"rank{rank}"), **est_kw)
    est.setLossCallback(lambda loss, it, part: losses.append(loss))
    pipe = Pipeline(stages=[OneHotEncoder(inputCol="label",
                                          outputCol="labels",
                                          dropLast=False), est])
    t0 = time.perf_counter()
    fitted = pipe.fit(df)
    out = {"losses": losses, "fit_s": time.perf_counter() - t0,
           "stats": est.last_mesh_stats}
    if check_card is not None and rank == 0:
        out["transform_err"] = _mesh_transform_check(
            check_card, fitted, est_kw["tensorflowGraph"], df)
    return out


def _est_in_place(pool, est_kw, rows, device, work, tag, check_card=None):
    """:func:`_est_rank` on the pool's two ranks: rank 0's losses and wall
    and the fit's accounting with every rank's row (with ``check_card``,
    rank 0's transform error against the fitted weights' forward)."""
    got = pool.run(_est_rank, est_kw, rows, BERT_BASE["max_len"],
                   BERT_BASE["vocab_size"], device,
                   os.path.join(work, tag), check_card)
    if got[0]["losses"] != got[1]["losses"]:
        raise AssertionError(f"{tag}: the ranks' losses differ "
                             f"{[g['losses'] for g in got]}")
    st = dict(got[0]["stats"], ranks=[g["stats"]["ranks"][0] for g in got])
    if check_card is not None:
        st["transform_err"] = got[0]["transform_err"]
    return got[0]["losses"], got[0]["fit_s"], st


def _est_launched(est_kw, df, device, work, tag, transform=False):
    """``Pipeline([OneHotEncoder, SparkAsyncDL(**est_kw)])`` fit from this
    process, the estimator launching the mesh's ranks itself: rank 0's live
    losses, the fit's wall and mesh accounting (every rank's row) and, with
    ``transform``, the fitted model's transform without a mesh (its rows'
    count and whether every prob is finite)."""
    import numpy as np
    from sparkflow_tpu_torch.localml import OneHotEncoder, Pipeline
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    losses = []
    est = SparkAsyncDL(device=device, weightsPath=os.path.join(work, tag),
                       **est_kw)
    est.setLossCallback(lambda loss, it, part: losses.append(loss))
    pipe = Pipeline(stages=[OneHotEncoder(inputCol="label",
                                          outputCol="labels",
                                          dropLast=False), est])
    t0 = time.perf_counter()
    fitted = pipe.fit(df)
    fit_s = time.perf_counter() - t0
    served = None
    if transform:
        probs = np.stack([np.asarray(r["probs"]) for r in
                          fitted.transform(df).collect()])
        served = {"rows": int(probs.shape[0]),
                  "finite": bool(np.isfinite(probs).all())}
    return losses, fit_s, est.last_mesh_stats, served


def _tpf_estimator(card, spec, df, mesh_shape, fit_mode, launched, work,
                   device, pool):
    """(b) ``Pipeline([OneHotEncoder, SparkAsyncDL(meshShape=...)])`` over
    the BERT-base rows at 2 layers, 2 steps (collect: one random batch an
    epoch), the ranks launched by the estimator or (``launched`` False) in
    place on the pool's two ranks: the fit's accounting and its training
    examples/s (the second step's CUDA-event ms)."""
    stream = fit_mode == "stream"
    kw = dict(
        inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
        tfLabel="y:0", tfOutput="probs:0", tfOptimizer="adam",
        tfLearningRate=3e-4, iters=1 if stream else TPF_EST_STEPS,
        miniStochasticIters=-1 if stream else 1,
        miniBatchSize=TPF_EST_BATCH, labelCol="labels",
        predictionCol="probs", extraInputCols="mask",
        extraTfInputs="attention_mask:0", fitMode=fit_mode,
        meshShape=mesh_shape)
    tag = f"tpf-{mesh_shape}-{fit_mode}"
    if launched:
        losses, fit_s, st, _t = _est_launched(kw, df, device, work, tag)
    else:
        losses, fit_s, st = _est_in_place(pool, kw, TPF_EST_ROWS, device,
                                          work, tag)
    axes = dict(kv.split("=") for kv in mesh_shape.split(","))
    want_mesh = {"dp": 1, **{k: int(v) for k, v in axes.items()}}
    steps = TPF_EST_STEPS
    if not (st is not None and st["mesh"] == want_mesh
            and st["launched"] == launched and len(losses) == steps
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"{mesh_shape} {fit_mode}: mesh "
                             f"{st and st['mesh']}, losses {losses}")
    if st["zero_stage"] != 0:
        raise AssertionError(f"{mesh_shape}: zero stage {st['zero_stage']} "
                             f"on sharded params, want 0")
    ranks = _tpf_rank_rows(st, MESH_NAMES)
    layers = TPF_EST_LAYERS
    for r in ranks:
        if device != "cpu" and r["launches"] != {n: layers * steps
                                                 for n in MESH_NAMES}:
            raise AssertionError(f"{mesh_shape} {fit_mode}: rank "
                                 f"{r['rank']} launches {r['launches']}, "
                                 f"want {layers} x {steps}")
    summary = {"mesh": st["mesh"], "backend": st["backend"],
               "launched": st["launched"], "fit_s": fit_s,
               "live_losses": losses,
               "train_examples_per_s": TPF_EST_BATCH * 1e3 / max(
                   r["step_ms_median_after_first"] for r in ranks),
               "ranks": ranks}
    launches = {n: sum(r["launches"][n] for r in ranks) for n in MESH_NAMES}
    return summary, launches


def _tpf_greedy_timed(eng, prompts, n):
    """``_greedy`` with each ``step()``'s host ms (the step returns after
    its tokens are read from the card)."""
    infos = [eng.prefill(p, max_new_tokens=n) for p in prompts]
    toks = {i["slot"]: [i["token"]] for i in infos}
    live = set(toks)
    ms = []
    while live:
        t0 = time.perf_counter()
        got = eng.step()
        ms.append((time.perf_counter() - t0) * 1e3)
        for s, t in got.items():
            toks[s].extend(t)
            if len(toks[s]) >= n:
                eng.release(s)
                live.discard(s)
    return [toks[i["slot"]][:n] for i in infos], ms


TPF_DEC_ARMS = (("plain", {}), ("spec_k=4", {"spec_k": SPEC_K}),
                ("int8+spec_k=4", {"kv_quant": "int8", "spec_k": SPEC_K}))


def _tpf_decode(card, device):
    """(c) GPT-2 small behind ``DecodeEngine(mesh={"tp": 2},
    sharding=ShardingConfig(tp_axis="tp"), num_slots=8, page_size=16)``,
    8 prompts x 32 new tokens, in three arms. Exactness in float32 (TF32
    off): the tp engine's greedy tokens equal the engine's without a mesh,
    with the pool bytes a shard (half) and kernels 4-7's launches a shard,
    the counters zeroed just before each arm's burst. Then bf16, the plain
    arm: step ms p50 and the tokens that differ."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
               for n in TPF_DEC_LENS]
    kw = dict(num_slots=8, page_size=16, seed=0)
    tp = dict(mesh={"tp": 2}, sharding=ShardingConfig(tp_axis="tp"))
    out = {"float32_identical": {}, "launches_a_shard": {}, "bf16": {}}
    launches = {n: 0 for n in TPF_NAMES}
    model, params = _tpf_lm(None, device)
    for name, extra in TPF_DEC_ARMS:
        plain = DecodeEngine(model, params, **kw, **extra)
        want = _greedy(plain, prompts, TPF_DEC_NEW)
        eng = DecodeEngine(model, params, **kw, **tp, **extra)
        reset_launch_counts()
        got = _greedy(eng, prompts, TPF_DEC_NEW)
        if device != "cpu":
            torch.cuda.synchronize()
        counts = launch_counts()
        for n in TPF_NAMES:
            launches[n] += counts[n]
        out["float32_identical"][name] = got == want
        if got != want:
            raise AssertionError(f"tp=2 decode ({name}, float32) tokens "
                                 f"{got} != no-mesh {want}")
        out["launches_a_shard"][name] = {n: counts[n] / 2 for n in TPF_NAMES
                                         if counts[n]}
        par, ref = eng.stats()["parallel"], plain.stats()["parallel"]
        if par["kv_bytes_per_device"] * 2 != ref["kv_bytes_per_device"]:
            raise AssertionError(f"tp=2 decode {name}: pool bytes a shard "
                                 f"{par}, no mesh {ref}")
        del plain, eng
    del model, params
    model, params = _tpf_lm("bfloat16" if device != "cpu" else None, device)
    plain = DecodeEngine(model, params, **kw)
    want = _greedy(plain, prompts, TPF_DEC_NEW)
    eng = DecodeEngine(model, params, **kw, **tp)
    got, ms = _tpf_greedy_timed(eng, prompts, TPF_DEC_NEW)
    par, ref = eng.stats()["parallel"], plain.stats()["parallel"]
    # bf16: the shards' GEMMs (half the columns, half the rows) round
    # otherwise than the whole ones, so a near-tie may flip; where the
    # first token differs in each sequence (None: identical)
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  None) for a, b in zip(got, want)]
    out["bf16"]["plain"] = {
        "tokens_identical_to_no_mesh": got == want,
        "sequences_identical": sum(a == b for a, b in zip(got, want)),
        "first_differing_token": first,
        "step_ms_p50": _pct(ms, 50), "step_ms_p95": _pct(ms, 95),
        "steps": len(ms),
        "kv_gb_a_shard": par["kv_bytes_per_device"] / 1e9,
        "kv_gb_no_mesh": ref["kv_bytes_per_device"] / 1e9,
        "param_gb_a_shard": par["param_bytes_per_device"] / 1e9,
        "param_gb_no_mesh": ref["param_bytes_per_device"] / 1e9}
    del plain, eng
    need = {"plain": ("paged_attention",),
            "spec_k=4": ("paged_attention", "paged_verify"),
            "int8+spec_k=4": ("paged_attention_quant",
                              "paged_verify_quant")}
    for name, kernels in need.items():
        if device != "cpu" and not all(
                out["launches_a_shard"][name].get(n) for n in kernels):
            raise AssertionError(f"tp=2 decode {name}: launches "
                                 f"{out['launches_a_shard'][name]}")
    log("[tp-fsdp] (c) GPT-2 small DecodeEngine(mesh={'tp': 2}, num_slots=8, "
        "page_size=16), 8 prompts x 32 new tokens: float32 (TF32 off) greedy "
        "tokens identical to the engine without a mesh in every arm; bf16, "
        "the plain arm: " + json.dumps(out) + f" [{card}]")
    return out, launches


def _tpf_lm(compute_dtype, device):
    """Phase 3's GPT-2 small (random weights from seed 1) on ``device``."""
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    spec = build_registry_spec("transformer_lm", **GPT2_SMALL)
    model = model_from_json(spec, compute_dtype=compute_dtype, device=device)
    return model, model.init(torch.Generator().manual_seed(1))


def _tpf_predict(card, device):
    """(d) BERT-base ``InferenceEngine(mesh={"tp": 2},
    sharding=ShardingConfig(tp_axis="tp"))``, float32, bucket 32 x 512:
    logits against the engine without a mesh, rows/s of each (host clock
    around a bucket call, after warmup), ``flash_fwd``'s launches a
    call (12 a shard)."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import InferenceEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    spec = build_registry_spec("transformer_classifier", **dict(
        BERT_BASE, dropout=0.0))
    model = model_from_json(spec, device=device)
    params = model.init(seed=4)
    rs = np.random.RandomState(2)
    n, s = TPF_PREDICT_BATCH, BERT_BASE["max_len"]
    ids = rs.randint(10, BERT_BASE["vocab_size"], (n, s))
    mask = (np.arange(s)[None] < rs.randint(s // 2, s + 1, (n, 1))).astype(
        np.float32)
    kw = dict(input_name=["input_ids:0", "attention_mask:0"],
              output_name="logits:0", max_batch=TPF_PREDICT_BATCH)
    engines = {"no_mesh": InferenceEngine(model, params, **kw),
               "tp2": InferenceEngine(model, params, mesh={"tp": 2},
                                      sharding=ShardingConfig(tp_axis="tp"),
                                      **kw)}
    outs, rows_s = {}, {}
    for name, eng in engines.items():
        if name == "tp2":
            reset_launch_counts()
        outs[name] = eng.predict((ids, mask))
        if name == "tp2":
            if device != "cpu":
                torch.cuda.synchronize()
            call = launch_counts()["flash_fwd"]
        t0 = time.perf_counter()
        for _ in range(TPF_PREDICT_REPS):
            eng.predict((ids, mask))
        rows_s[name] = n * TPF_PREDICT_REPS / (time.perf_counter() - t0)
    err = float(np.abs(outs["tp2"] - outs["no_mesh"]).max())
    st = engines["tp2"].stats()
    out = {"max_abs_d": err, "rows_per_s": rows_s,
           "rows_per_s_ratio": rows_s["tp2"] / rows_s["no_mesh"],
           "flash_fwd_launches_a_call": call, "tp": st["tp"],
           "param_gb_a_shard": st["param_bytes_per_device"] / 1e9,
           "param_gb_no_mesh": engines["no_mesh"].stats()[
               "param_bytes_per_device"] / 1e9}
    if not (err <= TPF_PREDICT_TOL and np.isfinite(outs["tp2"]).all()
            and st["tp"] == 2
            and (device == "cpu"
                 or call == 2 * BERT_BASE["num_layers"])):
        raise AssertionError(f"tp=2 predict: {out}")
    log("[tp-fsdp] (d) BERT-base InferenceEngine(mesh={'tp': 2}), float32, "
        "bucket 32 x 512: " + json.dumps(out) + f" (tol {TPF_PREDICT_TOL}) "
        f"[{card}]")
    return out, call


def _tpf_exactness(card, ids, masks, labels, work, device, pool):
    """(e) Full widths cut to 2 layers, float32, TF32 off, dropout off
    unless said: ``tp=2`` and fsdp=2 against one card's ``Trainer`` — one
    SGD step (lr 0.1; loss 1e-5 relative, params rtol 3e-4 / atol 3e-5)
    and 3 adam steps (losses 2e-4); a ``tp=2`` fit with dropout 0.1 whose
    replicated leaves must be bit-equal across the two ranks; a ``tp=2``
    checkpoint resumed on one card bit-equal to the tp fit."""
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.trainer import Trainer
    bert2 = build_registry_spec("transformer_classifier", **dict(
        BERT_BASE, num_layers=2, dropout=0.0))
    rows = slice(0, 32)
    x, m, y = ids[rows], masks[rows], labels[rows]
    kws = {"sgd": dict(optimizer="gradient_descent", learning_rate=0.1,
                       iters=1, mini_batch_size=32, seed=0),
           "adam": dict(optimizer="adam", learning_rate=3e-4, iters=3,
                        mini_batch_size=32, seed=0,
                        optimizer_options={"epsilon": 1e-6})}
    out = {}
    for opt, kw in kws.items():
        one = Trainer(bert2, ["input_ids", "attention_mask"], "y",
                      device=device, **kw).fit((x, m), y)
        want = _np_tree(one.params)
        for axes in ({"dp": 1, "tp": 2}, {"dp": 1, "fsdp": 2}):
            got = pool.run(_tpf_fit_rank, bert2, axes, kw, x, m, y, device)
            lrel = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(got[0]["losses"], one.losses))
            e = {"loss_rel": lrel,
                 "param_excess": _tpf_excess(got[0]["params"], want),
                 "param_bytes_a_rank": got[0]["param_bytes"],
                 "zero_stage": got[0]["zero_stage"]}
            key = f"{opt} {'tp' if 'tp' in axes else 'fsdp'}=2"
            out[key] = e
            ok = (len(got[0]["losses"]) == len(one.losses)
                  and got[0]["losses"] == got[1]["losses"]
                  and e["zero_stage"] == 0)
            if opt == "sgd":
                ok = ok and lrel <= TPF_LOSS_RTOL and (
                    e["param_excess"] <= TPF_PARAM_ATOL)
            else:
                ok = ok and lrel <= TPF_ADAM_RTOL
            if not ok:
                raise AssertionError(f"(e) {key} vs one card: {e}")
    # a tp=2 fit with dropout 0.1 saving each epoch: the ranks' leaves
    # bit-equal, and its checkpoint resumed on one card bit-equal to it
    drop = build_registry_spec("transformer_classifier", **dict(
        BERT_BASE, num_layers=2, dropout=0.1))
    ck = os.path.join(work, "tpf-ck")
    ckw = dict(kws["adam"], iters=2, checkpoint_dir=ck, checkpoint_every=1)
    got = pool.run(_tpf_fit_rank, drop, {"dp": 1, "tp": 2}, ckw, x, m, y,
                   device)
    a, b = got[0]["digest"], got[1]["digest"]
    same = all(a[ln][k] == b[ln][k] for ln in a for k in a[ln])
    out["dropout_tp2_all_leaves_bit_equal_across_ranks"] = same
    if not (same and got[0]["losses"] == got[1]["losses"]):
        raise AssertionError("(e) tp=2 with dropout 0.1: the ranks' leaves "
                             "or losses differ")
    tr = Trainer(drop, ["input_ids", "attention_mask"], "y", device=device,
                 **ckw)
    res = tr.fit((x, m), y)
    resumed = _np_tree(res.params)
    bit = all((resumed[ln][k] == got[0]["params"][ln][k]).all()
              for ln in resumed for k in resumed[ln])
    out["tp2_checkpoint_resumed_on_one_card"] = {
        "resumed_from": tr._resumed_from, "epochs_run": len(res.losses),
        "bit_equal": bool(bit)}
    if not (bit and tr._resumed_from == 2 and res.losses == []):
        raise AssertionError(f"(e) tp=2 checkpoint on one card: "
                             f"{out['tp2_checkpoint_resumed_on_one_card']}")
    log("[tp-fsdp] (e) exactness, BERT-base widths cut to 2 layers, float32, "
        "TF32 off, 32 rows: " + json.dumps(out) + f" (SGD loss <= "
        f"{TPF_LOSS_RTOL} relative, params |d| - {TPF_PARAM_RTOL} |p| <= "
        f"{TPF_PARAM_ATOL}; adam losses <= {TPF_ADAM_RTOL}) [{card}]")
    return out


def _tpf_kernels_h6(card):
    """Kernels 1-7 at a tp=2 shard's head count (6 of GPT-2 small's 12)
    against their plain versions, at the main path's shapes: flash forward
    and backward bf16 at the training shape (B=8, S=1024, causal), the
    decode step's paged operands (8 slots, 16-token pages, bf16 and int8)
    and the verify grid (S = spec_k + 1); a second launch of each must
    give the same bits. The kernel's ms beside (ten calls a CUDA-graph
    replay, as phase 2 times them)."""
    import torch
    from sparkflow_tpu_torch.ops import (attention_reference,
                                         flash_attention, flash_bwd_dkv,
                                         flash_bwd_dkv_reference,
                                         flash_bwd_dq, flash_bwd_dq_reference,
                                         paged_attention,
                                         paged_attention_reference,
                                         paged_attention_verify,
                                         paged_attention_verify_reference)
    from sparkflow_tpu_torch.utils import quant
    dev = torch.device("cuda")
    h, rows = 6, {}
    g = torch.Generator(device=dev).manual_seed(66)
    q, k, v, do = (torch.randn(8, h, 1024, 64, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    again = flash_attention(q, k, v, causal=True)
    ref = attention_reference(q, k, v, causal=True)
    rows["flash_fwd"] = {"max_abs_err": max_err(out, ref),
                         "repeat_bit_equal": bool(torch.equal(out, again)),
                         "ms": time_device([lambda: flash_attention(
                             q, k, v, causal=True)] * 10)}
    delta = (do.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, True)
    for name, fn, ref_fn in (
            ("flash_bwd_dq", lambda: (flash_bwd_dq(*args),),
             lambda: (flash_bwd_dq_reference(*args),)),
            ("flash_bwd_dkv", lambda: flash_bwd_dkv(*args),
             lambda: flash_bwd_dkv_reference(*args))):
        got, again, want = fn(), fn(), ref_fn()
        rows[name] = {
            "max_abs_err": max(max_err(a, w) for a, w in zip(got, want)),
            "err_over_max_plain": max(max_err(a, w) / float(
                w.float().abs().max()) for a, w in zip(got, want)),
            "repeat_bit_equal": all(torch.equal(a, b_)
                                    for a, b_ in zip(got, again)),
            "ms": time_device([fn] * 10)}
    b, page, maxp = 8, 16, 64
    num_pages = b * maxp + 1
    qd = torch.randn(b, h, 64, generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(num_pages, page, h, 64, generator=g, device=dev)
              for _ in range(2))
    table = torch.randperm(num_pages - 1, generator=g, device=dev)[
        :b * maxp].reshape(b, maxp).add(1).to(torch.int32)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    table[0] = 0
    qv = torch.randn(b, h, SPEC_K + 1, 64, generator=g, device=dev).to(
        torch.bfloat16)
    start = (lengths - (SPEC_K + 1)).clamp(min=0).to(torch.int32)
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    (kq, ks), (vq, vs) = (quant.quantize_kv_pages(t, "int8")
                          for t in (kp, vp))
    sc = dict(k_scales=ks, v_scales=vs)
    cases = (("paged_attention", paged_attention, paged_attention_reference,
              qd, kb, vb, lengths, {}),
             ("paged_attention_quant", paged_attention,
              paged_attention_reference, qd, kq, vq, lengths, sc),
             ("paged_verify", paged_attention_verify,
              paged_attention_verify_reference, qv, kb, vb, start, {}),
             ("paged_verify_quant", paged_attention_verify,
              paged_attention_verify_reference, qv, kq, vq, start, sc))
    for name, fn, ref_fn, qq, kk, vv, ln, extra in cases:
        o1 = fn(qq, kk, vv, table, ln, **extra)
        o2 = fn(qq, kk, vv, table, ln, **extra)
        rows[name] = {"max_abs_err": max_err(o1, ref_fn(qq, kk, vv, table,
                                                         ln, **extra)),
                      "repeat_bit_equal": bool(torch.equal(o1, o2)),
                      "ms": time_device([lambda: fn(qq, kk, vv, table, ln,
                                                    **extra)] * 10)}
    torch.cuda.synchronize()

    def held(n, r):
        if not (r["repeat_bit_equal"] and math.isfinite(r["max_abs_err"])):
            return False
        if n.startswith("flash_bwd"):
            return r["err_over_max_plain"] <= BWD_TOL["bfloat16"]
        tol = FLASH_TOL if n == "flash_fwd" else PAGED_TOL
        return r["max_abs_err"] < tol["bfloat16"]

    bad = [n for n, r in rows.items() if not held(n, r)]
    if bad:
        raise AssertionError(f"kernels at 6 heads: {bad}: {rows}")
    log("[tp-fsdp] kernels 1-7 at a tp=2 shard's 6 heads (bf16; flash B=8 "
        "S=1024 causal, paged 8 slots x 16-token pages, verify S=5) vs their "
        "plain versions: " + json.dumps(rows) + f" [{card}]")
    return rows


def phase_tp_fsdp(card, work, device=None, pool=None):
    """Phase 20: tensor parallelism and fsdp on the card (see the module
    docstring). The in-place rank work of (a) and (e) runs in ``pool``
    (phase 18's) or a pool of its own. Returns the phase's launches,
    summary and the kernels' rows at 6 heads. Rehearse it on the CPU with
    ``device="cpu"`` and shrunk ``GPT2_SMALL`` / ``BERT_BASE``."""
    import torch
    from sparkflow_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    cuda = device != "cpu"
    kind = "cuda" if cuda else "cpu"
    os.environ["SPARKFLOW_TORCH_MESH_TIMEOUT_S"] = str(MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = distributed.choose_backend(2, kind)
    log(f"[tp-fsdp] 2 ranks on {torch.cuda.device_count()} card(s), backend "
        f"{backend}; tp shards of one-process serving on card (d * tp + t) % "
        f"count. On one card this shows the mesh layer and the kernels at a "
        f"shard's head count, not scaling [{card}]")
    out = {"backend": backend, "seconds": {}}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - mark[0]
        mark[0] = now

    out["kernels_h6"] = _tpf_kernels_h6(card) if cuda else {}
    lap("kernels_h6")
    with _pool_of(pool, kind) as pool:
        out["train"], train_l = _tpf_training(card, device, pool)
        pool.run(_rank_release)
        lap("a_training")
        out.update(_tpf_rest(card, work, device, pool, lap))
    est_l, dec_l = out.pop("_est_l"), out.pop("_dec_l")
    launches = {n: {"training_tp2": train_l.get(n, 0),
                    "estimator": est_l.get(n, 0),
                    "decode_tp2": dec_l.get(n, 0)} for n in TPF_NAMES}
    launches["flash_fwd"]["predict_tp2_call"] = out.pop("_pred_call")
    out["launches"] = launches
    log(f"[tp-fsdp] phase 20 {time.perf_counter() - t0:.1f} s, by part "
        + json.dumps(out["seconds"]) + f" [{card}]")
    return out


def _tpf_rest(card, work, device, pool, lap):
    """Phase 20 (b)-(e); the launches under private keys for the caller."""
    import numpy as np
    from sparkflow_tpu_torch.localml import LocalSession
    from sparkflow_tpu_torch.models import build_registry_spec
    out = {}
    spark = LocalSession.builder.appName("tp-fsdp").getOrCreate()
    bert = build_registry_spec("transformer_classifier", **BERT_BASE)
    df = synthetic_text(spark, TPF_EST_ROWS, BERT_BASE["max_len"],
                        BERT_BASE["vocab_size"])
    rows = df.collect()
    ids = np.stack([r["tokens"].toArray() for r in rows]).astype(np.float32)
    masks = np.stack([r["mask"].toArray() for r in rows]).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[[int(r["label"]) for r in rows]]
    bert2 = build_registry_spec("transformer_classifier",
                                **dict(BERT_BASE, num_layers=TPF_EST_LAYERS))
    one_ex_s = _tpf_one_card_ex_s(bert2, ids, masks, labels, device)
    est, est_l = {}, {n: 0 for n in MESH_NAMES}
    for mesh_shape, mode, launched in TPF_EST_FITS:
        summary, launches = _tpf_estimator(card, bert2, df, mesh_shape, mode,
                                           launched, work, device, pool)
        summary["examples_per_s_over_one_card"] = (
            summary["train_examples_per_s"] / one_ex_s)
        est[f"{mesh_shape} {mode}"] = summary
        for n in MESH_NAMES:
            est_l[n] += launches[n]
    pool.run(_rank_release)
    full = _tpf_full_bytes(bert2)
    est["one_card_train_examples_per_s"] = one_ex_s
    est["one_card_param_gb"] = full / 1e9
    est["fsdp_param_share_a_rank"] = [
        r["param_gb"] * 1e9 / full
        for r in est["fsdp=2 collect"]["ranks"]]
    log("[tp-fsdp] (b) BERT-base's widths at 2 layers through SparkAsyncDL("
        "meshShape=...), tp=2 collect and fsdp=2 stream launching their "
        "ranks, fsdp=2 collect in place on 2 ranks, float32, 64 rows x 512, "
        "batch 32, 2 steps each (collect: a random batch an epoch): "
        + json.dumps(est) + f" [{card}]")
    out["estimator"] = est
    lap("b_estimator")
    out["decode"], out["_dec_l"] = _tpf_decode(card, device)
    lap("c_decode")
    out["predict"], out["_pred_call"] = _tpf_predict(card, device)
    lap("d_predict")
    out["exact"] = _tpf_exactness(card, ids, masks, labels, work, device,
                                  pool)
    pool.run(_rank_release)
    lap("e_exact")
    out["_est_l"] = est_l
    return out


# -- phase 21: pipeline parallelism (ROADMAP 7e) ------------------------------
#
# Two ranks share the card over gloo for training, and one-process serving
# puts both stages (and, under pp x tp, their shards) on it: the phase shows
# the schedules, the stage-to-stage hops and the kernels on each stage's
# layers, not scaling.
PP_TRAIN_BATCH, PP_TRAIN_STEPS = 8, 3            # (a) GPT-2 small 8 x 1024
PP_SCHEDULES = ("gpipe", "1f1b", "sequential")
# (b) BERT-base: phase 20's rows, batch and steps (its one-card rate too)
PP_EST_ROWS, PP_EST_BATCH, PP_EST_STEPS = (TPF_EST_ROWS, TPF_EST_BATCH,
                                           TPF_EST_STEPS)
PP_EST_MICRO = 4
PP_EST_LAYERS = TPF_EST_LAYERS
PP_DEC_NEW = 32                                  # (c) 8 prompts, TPF's lengths
PP_DEC_ARMS = (("pp_wave", {}, "plain"),
               ("pp_wave=False", {"pp_wave": False}, "plain"),
               ("spec_k=4", {"spec_k": SPEC_K, "draft_layers": 6}, "spec"),
               ("int8+spec_k=4", {"kv_quant": "int8", "spec_k": SPEC_K,
                                  "draft_layers": 6}, "int8+spec"),
               ("pp x tp", {"tp": True}, "plain"))
PP_EXACT_BATCH = 8                               # (d) 8 x 1024, 2 layers


def _pp_launches_a_step(schedule, stage, n_stages, layers, micro):
    """Kernels 1-3's launches a step on one stage: a stage's layers once a
    microbatch in the forward sweep (the last stage stores its arrivals
    instead, and ``sequential`` keeps its graph), once more in the
    recompute, and once in the backward."""
    per = layers // n_stages
    last = stage == n_stages - 1
    fwd = per * micro * (1 if schedule == "sequential" or last else 2)
    return {"flash_fwd": fwd, "flash_bwd_dq": per * micro,
            "flash_bwd_dkv": per * micro}


def _pp_rank_rows(st):
    """Each rank's accounting of a pp fit, its bytes split into the
    stage-to-stage hops and the all-reduces (the shared leaves' gradients,
    the loss)."""
    rows = _tpf_rank_rows(st, MESH_NAMES)
    for row, r in zip(rows, st["ranks"]):
        steps = max(1, r["steps"])
        row["hop_gb_a_step"] = r["bytes_moved"].get("pp_hop", 0) / steps / 1e9
        row["all_reduce_gb_a_step"] = (r["bytes_moved"]["all_reduce"]
                                       / steps / 1e9)
        row["schedule_ticks"] = r.get("schedule_ticks")
    return rows


def _pp_train_rank(spec, ids, schedule, device):
    """(a) on each of 2 ranks: ``Trainer(mesh={"dp": 1, "pp": 2})`` fitting
    in place (as under torchrun) under ``schedule``: the fit's wall and this
    rank's accounting."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    _rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, "input_ids", None, optimizer="adam", learning_rate=3e-4,
                 iters=PP_TRAIN_STEPS, mini_batch_size=PP_TRAIN_BATCH,
                 mini_stochastic_iters=1, seed=0, device=dev,
                 compute_dtype="bfloat16" if device != "cpu" else None,
                 mesh=Mesh({"dp": 1, "pp": 2}), pp_schedule=schedule)
    t0 = time.perf_counter()
    res = tr.fit(ids)
    return {"losses": res.losses, "fit_s": time.perf_counter() - t0,
            "stats": tr.last_mesh_stats}


def _pp_training(card, device, pool):
    """(a) GPT-2 small at ``pp=2`` through ``Trainer(mesh={"dp": 1, "pp":
    2})`` on the pool's two ranks under each schedule: bf16, dropout 0.1,
    adam 3e-4, batch 8 x 1024 (auto M = 8), 3 steps."""
    import numpy as np
    from sparkflow_tpu_torch.models import build_registry_spec
    lm = build_registry_spec("transformer_lm", **dict(GPT2_SMALL,
                                                      dropout=0.1))
    rs = np.random.RandomState(9)
    ids = rs.randint(0, min(1000, GPT2_SMALL["vocab_size"]),
                     (PP_TRAIN_BATCH, GPT2_SMALL["max_len"])
                     ).astype(np.float32)
    full = _tpf_full_bytes(lm)
    tokens = PP_TRAIN_BATCH * GPT2_SMALL["max_len"]
    out, launches = {}, {}
    for schedule in PP_SCHEDULES:
        got = pool.run(_pp_train_rank, lm, ids, schedule, device)
        st = dict(got[0]["stats"], ranks=[g["stats"]["ranks"][0]
                                          for g in got])
        losses = got[0]["losses"]
        if not (st["mesh"] == {"dp": 1, "pp": 2} and st["strategy"] == "pp"
                and all(math.isfinite(x) for x in losses)
                and len(losses) == PP_TRAIN_STEPS
                and got[1]["losses"] == losses):
            raise AssertionError(f"pp=2 GPT-2 small {schedule}: "
                                 f"{st['mesh']} losses "
                                 f"{[g['losses'] for g in got]}")
        ranks = _pp_rank_rows(st)
        for stage, r in enumerate(ranks):
            want = {n: v * PP_TRAIN_STEPS for n, v in _pp_launches_a_step(
                schedule, stage, 2, GPT2_SMALL["num_layers"], 8).items()}
            if device != "cpu" and r["launches"] != want:
                raise AssertionError(f"pp=2 {schedule} rank {stage} "
                                     f"launches {r['launches']}, want {want}")
        # the ranks step in lockstep (every step ends in a collective): the
        # slower rank's median is the step
        step_ms = max(r["step_ms_median_after_first"] for r in ranks)
        out[schedule] = {
            "losses": losses, "fit_s": got[0]["fit_s"],
            "backend": st["backend"], "step_ms": step_ms,
            "tokens_per_s": tokens * 1e3 / step_ms,
            "schedule_ticks": ranks[0]["schedule_ticks"],
            "param_bytes_share_of_one_card": [r["param_gb"] * 1e9 / full
                                              for r in ranks],
            "ranks": ranks}
        launches[schedule] = {n: sum(r["launches"][n] for r in ranks)
                              for n in MESH_NAMES}
        pool.run(_rank_release)
    out["one_card_param_gb"] = full / 1e9
    log("[pp] (a) GPT-2 small, Trainer(mesh={'dp': 1, 'pp': 2}) in place on "
        "2 ranks, bf16, dropout 0.1, adam 3e-4, batch 8 x 1024 (M = 8), 3 "
        "steps a schedule, 6 of 12 blocks a rank: " + json.dumps(out)
        + f" [{card}]")
    return out, launches


def _pp_estimator(card, device, work):
    """(b) BERT-base's widths at 2 layers through ``Pipeline([OneHotEncoder,
    SparkAsyncDL(meshShape="pp=2", ppSchedule="1f1b", ppMicrobatches=4)])``,
    the estimator launching its ranks, float32, 64 rows x 512 (tokens only:
    a pp classifier takes one input), batch 32, 2 steps (a random batch an
    epoch): examples/s against one card's ``Trainer`` on the same rows,
    param bytes a rank at rest, and the fitted model's transform without a
    mesh."""
    import numpy as np
    from sparkflow_tpu_torch.localml import LocalSession
    from sparkflow_tpu_torch.models import build_registry_spec
    spark = LocalSession.builder.appName("pp").getOrCreate()
    bert = build_registry_spec("transformer_classifier",
                               **dict(BERT_BASE, num_layers=PP_EST_LAYERS))
    df = synthetic_text(spark, PP_EST_ROWS, BERT_BASE["max_len"],
                        BERT_BASE["vocab_size"])
    rows = df.collect()
    ids = np.stack([r["tokens"].toArray() for r in rows]).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[[int(r["label"]) for r in rows]]
    # one card on the same rows, tokens only (as the pp classifier takes
    # them); phase 20's batch and steps are phase 21's
    one_ex_s = _tpf_one_card_ex_s(bert, ids, None, labels, device)
    kw = dict(
        inputCol="tokens", tensorflowGraph=bert, tfInput="input_ids:0",
        tfLabel="y:0", tfOutput="probs:0", tfOptimizer="adam",
        tfLearningRate=3e-4, iters=PP_EST_STEPS, miniStochasticIters=1,
        miniBatchSize=PP_EST_BATCH, labelCol="labels", predictionCol="probs",
        meshShape="pp=2", ppSchedule="1f1b", ppMicrobatches=PP_EST_MICRO)
    losses, fit_s, st, served = _est_launched(kw, df, device, work,
                                              "pp-est", transform=True)
    if not (st is not None and st["mesh"] == {"dp": 1, "pp": 2}
            and st["launched"] and st["strategy"] == "pp"
            and len(losses) == PP_EST_STEPS
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"pp=2 estimator: mesh {st and st['mesh']}, "
                             f"losses {losses}")
    ranks = _pp_rank_rows(st)
    for stage, r in enumerate(ranks):
        want = {n: v * PP_EST_STEPS for n, v in _pp_launches_a_step(
            "1f1b", stage, 2, PP_EST_LAYERS, PP_EST_MICRO).items()}
        if device != "cpu" and r["launches"] != want:
            raise AssertionError(f"pp=2 estimator rank {stage} launches "
                                 f"{r['launches']}, want {want}")
    if served != {"rows": PP_EST_ROWS, "finite": True}:
        raise AssertionError(f"pp=2 fitted model's transform: {served}")
    full = _tpf_full_bytes(bert)
    step_ms = max(r["step_ms_median_after_first"] for r in ranks)
    out = {"mesh": st["mesh"], "backend": st["backend"], "fit_s": fit_s,
           "live_losses": losses,
           "train_examples_per_s": PP_EST_BATCH * 1e3 / step_ms,
           "one_card_train_examples_per_s": one_ex_s,
           "param_share_a_rank_at_rest": [r["param_gb"] * 1e9 / full
                                          for r in ranks],
           "one_card_param_gb": full / 1e9,
           "transform_rows": served["rows"], "ranks": ranks}
    out["examples_per_s_over_one_card"] = (out["train_examples_per_s"]
                                           / one_ex_s)
    log("[pp] (b) BERT-base's widths at 2 layers through SparkAsyncDL("
        "meshShape='pp=2', ppSchedule='1f1b', ppMicrobatches=4), launching "
        "its ranks, float32, 64 rows x 512, batch 32, 2 steps: "
        + json.dumps(out) + f" [{card}]")
    return out, {n: sum(r["launches"][n] for r in ranks) for n in MESH_NAMES}


def _pp_engine(model, params, extra, pp):
    """A GPT-2-small ``DecodeEngine`` of phase 21's arms: no mesh
    (``pp=False``), ``pp=2``, or ``pp=2 x tp=2`` (``extra["tp"]``)."""
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    kw = {k: v for k, v in extra.items() if k != "tp"}
    if pp:
        if extra.get("tp"):
            kw.update(mesh={"pp": 2, "tp": 2},
                      sharding=ShardingConfig(pp_axis="pp", tp_axis="tp"))
        else:
            kw.update(mesh={"pp": 2}, sharding=ShardingConfig(pp_axis="pp"))
    elif "pp_wave" in kw:
        kw.pop("pp_wave")
    return DecodeEngine(model, params, num_slots=8, page_size=16, seed=0,
                        **kw)


def _pp_decode(card, device):
    """(c) GPT-2 small behind ``DecodeEngine(mesh={"pp": 2},
    sharding=ShardingConfig(pp_axis="pp"), num_slots=8, page_size=16)``,
    8 prompts x 32 new tokens, in five arms. Exactness in float32 (TF32
    off): each arm's greedy tokens equal those of the engine without a mesh
    (the same options), with the pool bytes a stage (half; a quarter a
    stage's shard under pp x tp) and kernels 1 and 4-7's launches a stage,
    the counters zeroed just before each arm's burst. Then bf16, the arms
    without speculation: step ms p50 and tokens/s against the engine
    without a mesh, wave ticks."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
               for n in TPF_DEC_LENS]
    out = {"float32_identical": {}, "launches_a_stage": {}, "bf16": {}}
    refs = {"plain": {}, "spec": {"spec_k": SPEC_K, "draft_layers": 6},
            "int8+spec": {"kv_quant": "int8", "spec_k": SPEC_K,
                          "draft_layers": 6}}
    model, params = _tpf_lm(None, device)
    want, kv_ref = {}, {}
    for k, kw in refs.items():
        eng = _pp_engine(model, params, kw, False)
        want[k] = _greedy(eng, prompts, PP_DEC_NEW)
        kv_ref[k] = eng.stats()["parallel"]["kv_bytes_per_device"]
        del eng
    launches = {}
    for name, extra, ref in PP_DEC_ARMS:
        eng = _pp_engine(model, params, extra, True)
        reset_launch_counts()
        got = _greedy(eng, prompts, PP_DEC_NEW)
        if device != "cpu":
            torch.cuda.synchronize()
        counts = launch_counts()
        launches[name] = {n: counts[n] for n in TPF_NAMES}
        out["float32_identical"][name] = got == want[ref]
        if got != want[ref]:
            raise AssertionError(f"pp decode ({name}, float32) tokens {got} "
                                 f"!= no-mesh {want[ref]}")
        split = 4 if extra.get("tp") else 2
        out["launches_a_stage"][name] = {n: counts[n] / split
                                         for n in TPF_NAMES if counts[n]}
        par = eng.stats()["parallel"]
        if par["kv_bytes_per_device"] * split != kv_ref[ref]:
            raise AssertionError(f"pp decode {name}: pool bytes a stage "
                                 f"{par}, no mesh {kv_ref[ref]}")
        del eng
    del model, params
    model, params = _tpf_lm("bfloat16" if device != "cpu" else None, device)
    # a first bf16 burst, untimed: the first engine of a process pays its
    # GEMM shapes' first use, which is no arm's cost
    _greedy(_pp_engine(model, params, {}, False), prompts, PP_DEC_NEW)
    eng = _pp_engine(model, params, {}, False)
    base_toks, base_ms = _tpf_greedy_timed(eng, prompts, PP_DEC_NEW)
    base_tok_s = len(prompts) * PP_DEC_NEW * 1e3 / sum(base_ms)
    del eng
    for name, extra, ref in PP_DEC_ARMS:
        if ref != "plain":
            continue
        eng = _pp_engine(model, params, extra, True)
        got, ms = _tpf_greedy_timed(eng, prompts, PP_DEC_NEW)
        par = eng.stats()["parallel"]
        tok_s = len(prompts) * PP_DEC_NEW * 1e3 / sum(ms)
        first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None) for a, b in zip(got, base_toks)]
        out["bf16"][name] = {
            "tokens_identical_to_no_mesh": got == base_toks,
            "first_differing_token": first,
            "step_ms_p50": _pct(ms, 50), "step_ms_p95": _pct(ms, 95),
            "steps": len(ms), "tokens_per_s": tok_s,
            "tokens_per_s_over_no_mesh": tok_s / base_tok_s,
            "no_mesh_step_ms_p50": _pct(base_ms, 50),
            "wave_ticks": par["wave_ticks"], "pp_wave": par["pp_wave"],
            "kv_gb_a_stage": par["kv_bytes_per_device"] / 1e9,
            "param_gb_a_stage": par["param_bytes_per_device"] / 1e9}
        del eng
    need = {"pp_wave": ("flash_fwd", "paged_attention"),
            "pp_wave=False": ("flash_fwd", "paged_attention"),
            "spec_k=4": ("flash_fwd", "paged_attention", "paged_verify"),
            "int8+spec_k=4": ("flash_fwd", "paged_attention_quant",
                              "paged_verify_quant"),
            "pp x tp": ("flash_fwd", "paged_attention")}
    for name, kernels in need.items():
        if device != "cpu" and not all(launches[name][n] for n in kernels):
            raise AssertionError(f"pp decode {name}: launches "
                                 f"{launches[name]}")
    if not (out["bf16"]["pp_wave"]["pp_wave"]
            and out["bf16"]["pp_wave"]["wave_ticks"] > 0):
        raise AssertionError(f"pp decode: no wave ticks "
                             f"{out['bf16']['pp_wave']}")
    log("[pp] (c) GPT-2 small DecodeEngine(mesh={'pp': 2}, num_slots=8, "
        "page_size=16), 8 prompts x 32 new tokens: float32 (TF32 off) greedy "
        "tokens identical to the engine without a mesh in every arm; bf16, "
        "the arms without speculation: " + json.dumps(out) + f" [{card}]")
    return out, launches


def _pp_fit_rank(spec, schedule, kw, ids, device):
    """(d) a ``Trainer(mesh={"dp": 1, "pp": 2})`` fit in place on this rank
    (TF32 off): losses, the checkpoint epoch it resumed from, and rank 0
    the standard-layout params."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, "input_ids", None, mesh=Mesh({"dp": 1, "pp": 2}),
                 pp_schedule=schedule, device=dev, **kw)
    r = tr.fit(ids)
    out = {"losses": r.losses, "resumed_from": tr._resumed_from}
    if rank == 0:
        out["params"] = _np_tree(r.params)
    return out


def _pp_exactness(card, device, work, pool):
    """(d) GPT-2 small's widths cut to 2 layers, float32, TF32 off, dropout
    0, 8 x 1024: ``pp=2`` under each schedule against one card's
    ``Trainer`` — one SGD step (lr 0.1; loss 1e-5 relative, params rtol
    3e-4 / atol 3e-5) and 3 adam steps (losses 2e-4); a 1f1b fit's
    checkpoint (the stacked stage layout) resumed on one card bit-equal to
    the fit's merged params."""
    import numpy as np
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.trainer import Trainer
    lm2 = build_registry_spec("transformer_lm", **dict(GPT2_SMALL,
                                                       num_layers=2))
    rs = np.random.RandomState(12)
    ids = rs.randint(0, GPT2_SMALL["vocab_size"],
                     (PP_EXACT_BATCH, GPT2_SMALL["max_len"])
                     ).astype(np.float32)
    kws = {"sgd": dict(optimizer="gradient_descent", learning_rate=0.1,
                       iters=1, mini_batch_size=PP_EXACT_BATCH, seed=0),
           "adam": dict(optimizer="adam", learning_rate=3e-4, iters=3,
                        mini_batch_size=PP_EXACT_BATCH, seed=0,
                        optimizer_options={"epsilon": 1e-6})}
    out = {}
    for opt, kw in kws.items():
        one = Trainer(lm2, "input_ids", None, device=device, **kw).fit(ids)
        want = _np_tree(one.params)
        for schedule in PP_SCHEDULES:
            got = pool.run(_pp_fit_rank, lm2, schedule, kw, ids, device)
            lrel = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(got[0]["losses"], one.losses))
            e = {"loss_rel": lrel,
                 "param_excess": _tpf_excess(got[0]["params"], want)}
            out[f"{opt} {schedule}"] = e
            ok = (len(got[0]["losses"]) == len(one.losses)
                  and got[0]["losses"] == got[1]["losses"])
            if opt == "sgd":
                ok = ok and lrel <= TPF_LOSS_RTOL and (
                    e["param_excess"] <= TPF_PARAM_ATOL)
            else:
                ok = ok and lrel <= TPF_ADAM_RTOL
            if not ok:
                raise AssertionError(f"(d) {opt} {schedule} vs one card: {e}")
    ck = os.path.join(work, "pp-ck")
    ckw = dict(kws["adam"], iters=2, checkpoint_dir=ck, checkpoint_every=1)
    got = pool.run(_pp_fit_rank, lm2, "1f1b", ckw, ids, device)
    tr = Trainer(lm2, "input_ids", None, device=device, **ckw)
    res = tr.fit(ids)
    resumed = _np_tree(res.params)
    bit = all((resumed[ln][k] == got[0]["params"][ln][k]).all()
              for ln in resumed for k in resumed[ln])
    out["pp2_checkpoint_resumed_on_one_card"] = {
        "resumed_from": tr._resumed_from, "epochs_run": len(res.losses),
        "bit_equal": bool(bit)}
    if not (bit and tr._resumed_from == 2 and res.losses == []):
        raise AssertionError(f"(d) pp=2 checkpoint on one card: "
                             f"{out['pp2_checkpoint_resumed_on_one_card']}")
    log("[pp] (d) exactness, GPT-2 small widths cut to 2 layers, float32, "
        "TF32 off, 8 x 1024: " + json.dumps(out) + f" (SGD loss <= "
        f"{TPF_LOSS_RTOL} relative, params |d| - {TPF_PARAM_RTOL} |p| <= "
        f"{TPF_PARAM_ATOL}; adam losses <= {TPF_ADAM_RTOL}) [{card}]")
    return out


def phase_pp(card, work, device=None, pool=None):
    """Phase 21: pipeline parallelism on the card (see the module
    docstring). The in-place rank work of (a) and (d) runs in ``pool``
    (phase 18's) or a pool of its own. Returns the phase's launches and
    summary. Rehearse it on the CPU with ``device="cpu"`` and shrunk
    ``GPT2_SMALL`` / ``BERT_BASE``."""
    import torch
    from sparkflow_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    cuda = device != "cpu"
    kind = "cuda" if cuda else "cpu"
    os.environ["SPARKFLOW_TORCH_MESH_TIMEOUT_S"] = str(MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = distributed.choose_backend(2, kind)
    log(f"[pp] 2 ranks on {torch.cuda.device_count()} card(s), backend "
        f"{backend}; decode stage s's shard t on card (s * tp + t) % count. "
        f"On one card this shows the schedules, the hops and the kernels on "
        f"each stage's layers, not scaling [{card}]")
    out = {"backend": backend, "seconds": {}}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - mark[0]
        mark[0] = now

    with _pool_of(pool, kind) as pool:
        out["train"], train_l = _pp_training(card, device, pool)
        lap("a_training")
        out["estimator"], est_l = _pp_estimator(card, device, work)
        lap("b_estimator")
        out["decode"], dec_l = _pp_decode(card, device)
        lap("c_decode")
        out["exact"] = _pp_exactness(card, device, work, pool)
        pool.run(_rank_release)
        lap("d_exact")
    launches = {}
    for n in TPF_NAMES:
        row = {f"training_{s}": train_l[s].get(n, 0) for s in PP_SCHEDULES}
        row["estimator_1f1b"] = est_l.get(n, 0)
        row.update({f"decode_{a}": dec_l[a][n] for a, _e, _r in PP_DEC_ARMS})
        launches[n] = row
    out["launches"] = launches
    log(f"[pp] phase 21 {time.perf_counter() - t0:.1f} s, by part "
        + json.dumps(out["seconds"]) + f" [{card}]")
    return out


# -- phase 22: expert parallelism (ROADMAP 7f) and the vmapped sweep ----------
#
# Two ranks share the card over gloo for training, and one-process serving
# puts every expert and tp shard on it: the phase shows the expert bank's
# split, the exchanges and the kernels on each rank, not scaling.
EP_TRAIN_BATCH, EP_TRAIN_STEPS = 8, 4            # (a) Switch-Base-8, 8 x 512
EP_A2A_STEPS = 4                                 # (b) 4 rows a rank
EP_EXACT_LAYERS, EP_EXACT_BATCH = 2, 8           # (c) full widths, 2 layers
EP_EXACT_CF = 8.0          # (c) the all_to_all step: capacity for every token
EP_DEC_ARMS = (("plain", {}), ("spec_k=4", {"spec_k": SPEC_K,
                                            "draft_layers": 6}),
               ("int8+spec_k=4", {"kv_quant": "int8", "spec_k": SPEC_K,
                                  "draft_layers": 6}))
# (d) float32 exactness at phase 16's exactness depth (4 layers, 2 MoE),
# the self draft through 2 of them
EP_EXACT_DRAFT = 2
EP_DEC_MESHES = (("ep=2", {"ep": 2}, {"ep_axis": "ep"}),
                 ("tp=2 x ep=2", {"tp": 2, "ep": 2},
                  {"tp_axis": "tp", "ep_axis": "ep"}))
EP_PREDICT_ROWS, EP_PREDICT_TOL = 4, 1e-5        # (e) one bucket, float32
EP_HYPER_LRS = (1e-5, 3e-5, 1e-4, 3e-4)          # (f) K = 4
EP_HYPER_LAYERS, EP_HYPER_ROWS, EP_HYPER_BATCH, EP_HYPER_ITERS = 4, 16, 8, 2
EP_HYPER_TOL = 1e-5


def _ep_train_rank(spec, ids, device):
    """(a) on each of 2 ranks: ``Trainer(mesh={"dp": 1, "ep": 2})`` fitting
    in place (as under torchrun): the fit's wall and this rank's
    accounting."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    _rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, "input_ids", None, optimizer="adam", learning_rate=3e-4,
                 iters=EP_TRAIN_STEPS, mini_batch_size=EP_TRAIN_BATCH,
                 mini_stochastic_iters=1, seed=0, device=dev,
                 compute_dtype="bfloat16" if device != "cpu" else None,
                 mesh=Mesh({"dp": 1, "ep": 2}))
    t0 = time.perf_counter()
    res = tr.fit(ids)
    return {"losses": res.losses, "fit_s": time.perf_counter() - t0,
            "stats": tr.last_mesh_stats}


def _ep_training(card, device, pool):
    """(a) The MoE LM at Switch-Base-8 widths through ``Trainer(mesh={"dp":
    1, "ep": 2})`` on the pool's two ranks: bf16, adam 3e-4, batch 8 x 512,
    4 steps; each rank holds 4 of each bank's 8 experts."""
    import numpy as np
    spec = _moe_spec()
    rs = np.random.RandomState(22)
    ids = rs.randint(0, SWITCH_BASE_8["vocab_size"],
                     (EP_TRAIN_BATCH, SWITCH_BASE_8["max_len"])
                     ).astype(np.float32)
    got = pool.run(_ep_train_rank, spec, ids, device)
    st = dict(got[0]["stats"], ranks=[g["stats"]["ranks"][0] for g in got])
    losses = got[0]["losses"]
    if not (st["mesh"] == {"dp": 1, "ep": 2}
            and all(math.isfinite(x) for x in losses)
            and len(losses) == EP_TRAIN_STEPS
            and got[1]["losses"] == losses):
        raise AssertionError(f"ep=2 Switch-Base-8: {st['mesh']} losses "
                             f"{[g['losses'] for g in got]}")
    ranks = _tpf_rank_rows(st, MESH_NAMES)
    want_l = SWITCH_BASE_8["num_layers"] * EP_TRAIN_STEPS
    for r in ranks:
        if device != "cpu" and r["launches"] != {n: want_l
                                                 for n in MESH_NAMES}:
            raise AssertionError(f"ep=2 rank {r['rank']} launches "
                                 f"{r['launches']}, want {want_l} each")
    full = _tpf_full_bytes(spec)
    tokens = EP_TRAIN_BATCH * SWITCH_BASE_8["max_len"]
    step_ms = max(r["step_ms_median_after_first"] for r in ranks)
    out = {"losses": losses, "fit_s": got[0]["fit_s"],
           "backend": st["backend"], "step_ms": step_ms,
           "tokens_per_s": tokens * 1e3 / step_ms,
           "param_bytes_share_of_one_card": [r["param_gb"] * 1e9 / full
                                             for r in ranks],
           "one_card_param_gb": full / 1e9,
           "host_staged_gb_a_step": [r["host_staged_gb"] / EP_TRAIN_STEPS
                                     for r in ranks],
           "ranks": ranks}
    log("[ep] (a) Switch-Base-8 widths, Trainer(mesh={'dp': 1, 'ep': 2}) in "
        "place on 2 ranks, bf16, adam 3e-4, batch 8 x 512, 4 steps, 4 of 8 "
        "experts a bank a rank: " + json.dumps(out) + f" [{card}]")
    return out, {n: sum(r["launches"][n] for r in ranks) for n in MESH_NAMES}


def _ep_overflow(model, params, feeds):
    """The fraction of routed choices each MoE layer's all_to_all dispatch
    dropped on this rank, from one forward with the dispatch asked for it."""
    import torch
    from sparkflow_tpu_torch.ops import moe_dispatch
    orig, dropped = moe_dispatch.all_to_all_moe_ffn, []

    def probe(*a, **k):
        k["return_overflow"] = True
        y, aux, over = orig(*a, **k)
        dropped.append(float(over))
        return y, aux

    moe_dispatch.all_to_all_moe_ffn = probe
    try:
        with torch.no_grad():
            model.loss_vector(params, feeds, train=False)
    finally:
        moe_dispatch.all_to_all_moe_ffn = orig
    return dropped


def _ep_a2a_rank(spec, ids, device, steps, opt_kw, compute_dtype,
                 gather=False):
    """(b) and (c) on each of 2 ranks: ``make_moe_shardmap_train_step``
    (the batch and the banks sharded over ``ep``, all_to_all dispatch) for
    ``steps`` steps on this rank's rows: losses, step ms (CUDA events),
    bytes, launches, param bytes, the drop fraction, and with ``gather``
    rank 0 the gathered standard params."""
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel import collectives as C
    from sparkflow_tpu_torch.parallel.ep import (make_moe_shardmap_train_step,
                                                 place_moe_params)
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.parallel.tp import gather_params
    rank, dev = _sm_rank_setup(device)
    cuda = device != "cpu"
    m = Mesh({"ep": 2})
    model = model_from_json(spec, compute_dtype=compute_dtype, device=dev)
    std = {ln: {k: t.detach() for k, t in d.items()}
           for ln, d in model.init(seed=0).items()}
    b = ids.shape[0] // 2
    x = torch.tensor(ids[rank * b:(rank + 1) * b], device=dev).long()
    mask = torch.ones(x.shape, device=dev)
    opt = build_optimizer(**opt_kw)
    with m.bind():
        params = {ln: {k: t.requires_grad_(True) for k, t in d.items()}
                  for ln, d in place_moe_params(model, std, m).items()}
        state = opt.init(params)
        step = make_moe_shardmap_train_step(model, opt, m)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        C.reset_stats()
        losses, ms = [], []
        for i in range(steps):
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            params, state, loss = step(params, state, x, mask, i)
            if cuda:
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
        counts = launch_counts()
        st = C.stats()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        dropped = _ep_overflow(model, params, {"input_ids": x,
                                               "attention_mask": mask})
        out = {"losses": losses, "step_ms": ms,
               "launches": {n: counts[n] for n in MESH_NAMES},
               "bytes": st, "peak_mem_gb": peak / 1e9, "overflow": dropped,
               "param_bytes": sum(t.numel() * t.element_size()
                                  for d in params.values()
                                  for t in d.values())}
        if gather:
            full = gather_params({ln: {k: t.detach() for k, t in d.items()}
                                  for ln, d in params.items()}, m,
                                 model.param_pspecs(), std)
            if rank == 0:
                out["params"] = _np_tree(full)
    return out


def _ep_a2a(card, device, pool):
    """(b) The all_to_all step at Switch-Base-8 widths (the model built with
    ``ep_axis="ep"``): bf16, adam 3e-4, 4 rows x 512 a rank, 4 steps."""
    import numpy as np
    spec = _moe_spec(ep_axis="ep")
    rs = np.random.RandomState(23)
    ids = rs.randint(0, SWITCH_BASE_8["vocab_size"],
                     (EP_TRAIN_BATCH, SWITCH_BASE_8["max_len"])
                     ).astype(np.float32)
    got = pool.run(_ep_a2a_rank, spec, ids, device, EP_A2A_STEPS,
                   {"optimizer_name": "adam", "learning_rate": 3e-4},
                   "bfloat16" if device != "cpu" else None)
    losses = got[0]["losses"]
    if not (all(math.isfinite(x) for x in losses)
            and got[1]["losses"] == losses):
        raise AssertionError(f"ep=2 all_to_all step losses "
                             f"{[g['losses'] for g in got]}")
    moe_layers = SWITCH_BASE_8["num_layers"] // SWITCH_BASE_8["moe_every"]
    want_l = SWITCH_BASE_8["num_layers"] * EP_A2A_STEPS
    for r, g in enumerate(got):
        if device != "cpu" and g["launches"] != {n: want_l
                                                 for n in MESH_NAMES}:
            raise AssertionError(f"all_to_all step rank {r} launches "
                                 f"{g['launches']}, want {want_l} each")
        # 3 exchanges out (tokens, expert ids, validity) and 1 back per MoE
        # layer in the forward, the tokens' pair again in the backward
        if g["bytes"]["all_to_all"] <= 0:
            raise AssertionError(f"all_to_all step rank {r}: no exchange "
                                 f"{g['bytes']}")
    full = _tpf_full_bytes(_moe_spec())
    tokens = EP_TRAIN_BATCH * SWITCH_BASE_8["max_len"]
    step_ms = max(float(np.median(g["step_ms"][1:] or g["step_ms"]))
                  for g in got) if got[0]["step_ms"] else None
    rows = tokens // 2
    cap = math.ceil(SWITCH_BASE_8["capacity_factor"] * rows / 2)
    out = {"losses": losses, "step_ms": step_ms,
           "tokens_per_s": tokens * 1e3 / step_ms if step_ms else None,
           "a_rank": [{
               "step_ms": g["step_ms"],
               "param_share_of_one_card": g["param_bytes"] / full,
               "all_to_all_mb_a_step": g["bytes"]["all_to_all"]
               / EP_A2A_STEPS / 1e6,
               "all_reduce_gb_a_step": g["bytes"].get("all_reduce", 0)
               / EP_A2A_STEPS / 1e9,
               "host_staged_gb_a_step": g["bytes"].get("host_staged", 0)
               / EP_A2A_STEPS / 1e9,
               "exchange_mb": 2 * cap * SWITCH_BASE_8["hidden"] * 2 / 1e6,
               "overflow_by_moe_layer": g["overflow"],
               "peak_mem_gb": g["peak_mem_gb"],
               "launches": g["launches"]} for g in got],
           "moe_layers": moe_layers, "send_buffer_rows_a_peer": cap}
    log("[ep] (b) the all_to_all step (make_moe_shardmap_train_step), "
        "Switch-Base-8 widths, bf16, adam 3e-4, 4 rows x 512 a rank, 4 "
        "steps: " + json.dumps(out) + f" [{card}]")
    return out, {n: sum(g["launches"][n] for g in got) for n in MESH_NAMES}


def _ep_fit_rank(spec, kw, ids, device):
    """(c) a ``Trainer(mesh={"dp": 1, "ep": 2})`` fit in place on this rank
    (TF32 off): losses, and rank 0 the standard-layout params."""
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.trainer import Trainer
    rank, dev = _sm_rank_setup(device)
    tr = Trainer(spec, "input_ids", None, mesh=Mesh({"dp": 1, "ep": 2}),
                 device=dev, **kw)
    r = tr.fit(ids)
    out = {"losses": r.losses}
    if rank == 0:
        out["params"] = _np_tree(r.params)
    return out


def _ep_param_excess(got, want):
    import numpy as np
    return max(float(np.max(np.abs(got[ln][k] - want[ln][k])
                            - MESH_PARAM_RTOL * np.abs(want[ln][k])))
               for ln in want for k in want[ln])


def _ep_one_card_steps(spec, ids, opt_kw, steps, device):
    """One card's steps of the loss the all_to_all step takes (the mean of
    the per-row losses over every row), through the slot dispatch."""
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import (apply_updates,
                                                build_optimizer, tree_leaves)
    model = model_from_json(spec, device=device)
    params = {ln: {k: t.detach().clone().requires_grad_(True)
                   for k, t in d.items()}
              for ln, d in model.init(seed=0).items()}
    opt = build_optimizer(**opt_kw)
    state = opt.init(params)
    x = torch.tensor(ids, device=model.device).long()
    feeds = {"input_ids": x, "attention_mask": torch.ones(
        x.shape, device=model.device)}
    losses = []
    for _ in range(steps):
        loss = model.loss_vector(params, feeds, train=True).mean()
        leaves = tree_leaves(params)
        grads = iter(torch.autograd.grad(loss, leaves))
        gtree = {ln: {k: next(grads) for k in d} for ln, d in params.items()}
        with torch.no_grad():
            upd, state = opt.update(gtree, state, params)
            apply_updates(params, upd)
        losses.append(loss.item())
    return losses, _np_tree(params)


def _ep_exactness(card, device, pool):
    """(c) Switch-Base-8 widths cut to 2 layers (one MoE layer), float32,
    TF32 off, 8 x 512: the trainer's ep=2 fit (a) and the all_to_all step
    (b) against one card, 3 adam steps each: losses 1e-5 relative, params
    as phase 18 (d). The all_to_all step runs at capacity factor 8 on both
    sides: its buffers are per peer, the slot table's per expert, so the
    two forms drop the same tokens only when neither drops any."""
    import numpy as np
    from sparkflow_tpu_torch.trainer import Trainer
    cut = dict(num_layers=EP_EXACT_LAYERS)
    spec = _moe_spec(**cut)
    rs = np.random.RandomState(24)
    ids = rs.randint(0, SWITCH_BASE_8["vocab_size"],
                     (EP_EXACT_BATCH, SWITCH_BASE_8["max_len"])
                     ).astype(np.float32)
    kws = {"adam": dict(optimizer="adam", learning_rate=3e-4, iters=3,
                        mini_batch_size=EP_EXACT_BATCH, seed=0,
                        optimizer_options={"epsilon": 1e-6})}
    out = {}

    def check(name, got_l, got_p, one_l, one_p, ranks_equal):
        lrel = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(got_l, one_l))
        e = {"loss_rel": lrel, "param_excess": _ep_param_excess(got_p,
                                                               one_p)}
        out[name] = e
        if not (ranks_equal and len(got_l) == len(one_l)
                and lrel <= MESH_LOSS_RTOL
                and e["param_excess"] <= MESH_PARAM_ATOL):
            raise AssertionError(f"(c) {name} vs one card: {e}")

    for opt, kw in kws.items():
        one = Trainer(spec, "input_ids", None, device=device, **kw).fit(ids)
        got = pool.run(_ep_fit_rank, spec, kw, ids, device)
        check(f"trainer ep=2 {opt}", got[0]["losses"], got[0]["params"],
              one.losses, _np_tree(one.params),
              got[0]["losses"] == got[1]["losses"])
    a2a = {"adam": ({"optimizer_name": "adam", "learning_rate": 3e-4,
                     "optimizer_options": {"epsilon": 1e-6}}, 3)}
    wide = dict(cut, capacity_factor=EP_EXACT_CF)
    for opt, (okw, steps) in a2a.items():
        one_l, one_p = _ep_one_card_steps(_moe_spec(**wide), ids, okw, steps,
                                          device)
        got = pool.run(_ep_a2a_rank, _moe_spec(ep_axis="ep", **wide), ids,
                       device, steps, okw, None, True)
        check(f"all_to_all step {opt}", got[0]["losses"], got[0]["params"],
              one_l, one_p, got[0]["losses"] == got[1]["losses"])
    pool.run(_rank_release)
    log("[ep] (c) exactness, Switch-Base-8 widths cut to 2 layers, float32, "
        "TF32 off, 8 x 512: " + json.dumps(out) + f" (losses <= "
        f"{MESH_LOSS_RTOL} relative, params |d| - {MESH_PARAM_RTOL} |p| <= "
        f"{MESH_PARAM_ATOL}) [{card}]")
    return out


def _ep_engine(model, params, extra, mesh):
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    kw = dict(extra)
    if mesh is not None:
        kw.update(mesh=mesh[1], sharding=ShardingConfig(**mesh[2]))
    return DecodeEngine(model, params, num_slots=8, page_size=16, seed=0,
                        **kw)


def _ep_http_burst(eng, prompts):
    """Phase 16's burst through ``/v1/generate``: every prompt at once from
    its own client thread; tokens and wall."""
    from sparkflow_tpu_torch.serving import (ContinuousBatcher,
                                             InferenceServer, ServingClient)
    cb = ContinuousBatcher(eng, max_queue=64)
    srv = InferenceServer(None, generate_batcher=cb, host="127.0.0.1",
                          port=0, memory_watch=False).start()
    results = [None] * len(prompts)
    try:
        cli = ServingClient(srv.url, timeout=300)

        def one(i):
            results[i] = cli.generate(prompts[i], max_new_tokens=MOE_NEW)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ep = cli.healthz()["decode"]["ep"]
    finally:
        srv.stop()
    for i, r in enumerate(results):
        if r is None or len(r["tokens"]) != MOE_NEW:
            raise AssertionError(f"ep burst request {i}: {r}")
    return [r["tokens"] for r in results], wall, ep


def _ep_decode(card, device, params):
    """(d) The Switch-Base-8-width MoE LM behind ``DecodeEngine(mesh=...,
    num_slots=8, page_size=16)`` with ``{"ep": 2}`` and ``{"tp": 2, "ep":
    2}``, phase 16's 8 prompts x 32 new tokens, plain, ``spec_k=4`` and int8
    with ``spec_k=4``. Float32 (TF32 off) at phase 16's exactness depth (4
    layers, the self draft through 2): each arm's greedy tokens equal the
    engine's without a mesh on the split banks' arithmetic (the model's
    ``per_expert_products``), kernels 1 and 4-7's launches, and the
    sequences in which the engine without a mesh on its own batched expert
    products differs from that (counted). Bf16 at full
    depth, the plain arm: tokens that differ from the engine without a mesh
    (counted), step ms and tokens/s against it; then its burst through
    ``/v1/generate`` (tokens/s against the engine without a mesh's burst,
    ``/healthz``'s ep)."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    rng = np.random.default_rng(16)
    vocab = SWITCH_BASE_8["vocab_size"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in MOE_PROMPTS]
    out = {"float32_identical": {}, "float32_batched_differing": {},
           "bf16": {}, "http": {}}
    cut = model_from_json(_moe_spec(num_layers=MOE_EXACT_LAYERS),
                          device=device)
    # the reference: one product per expert, as the split banks run them
    ref = model_from_json(_moe_spec(num_layers=MOE_EXACT_LAYERS),
                          device=device)
    ref.per_expert_products = True
    cut_params = {k: v for k, v in params.items()
                  if not k.startswith("block_")
                  or int(k.split("_")[1]) < MOE_EXACT_LAYERS}
    launches = {}
    for arm, extra in EP_DEC_ARMS:
        extra = ({**extra, "draft_layers": EP_EXACT_DRAFT}
                 if "draft_layers" in extra else extra)
        want = _greedy(_ep_engine(ref, cut_params, extra, None), prompts,
                       MOE_NEW)
        batched = _greedy(_ep_engine(cut, cut_params, extra, None), prompts,
                          MOE_NEW)
        out["float32_batched_differing"][arm] = sum(
            a != b for a, b in zip(batched, want))
        for mname, axes, cfg in EP_DEC_MESHES:
            eng = _ep_engine(cut, cut_params, extra, (mname, axes, cfg))
            reset_launch_counts()
            got = _greedy(eng, prompts, MOE_NEW)
            if device != "cpu":
                torch.cuda.synchronize()
            counts = launch_counts()
            key = f"{mname} {arm}"
            launches[key] = {n: counts[n] for n in TPF_NAMES}
            out["float32_identical"][key] = got == want
            if got != want:
                raise AssertionError(f"ep decode ({key}, float32) tokens "
                                     f"{got} != no-mesh {want}")
            if eng.stats()["parallel"]["ep"] != 2:
                raise AssertionError(f"ep decode {key}: "
                                     f"{eng.stats()['parallel']}")
    del cut, ref, cut_params
    # bf16 at full depth, the plain arm: flips and tokens/s against the
    # engine without a mesh (a first burst untimed: first use of shapes)
    model = model_from_json(_moe_spec(), compute_dtype="bfloat16"
                            if device != "cpu" else None, device=device)
    _greedy(_ep_engine(model, params, {}, None), prompts, MOE_NEW)
    base, base_ms = _tpf_greedy_timed(_ep_engine(model, params, {}, None),
                                      prompts, MOE_NEW)
    base_tok_s = len(prompts) * MOE_NEW * 1e3 / sum(base_ms)
    for mname, axes, cfg in EP_DEC_MESHES:
        eng = _ep_engine(model, params, {}, (mname, axes, cfg))
        got, ms = _tpf_greedy_timed(eng, prompts, MOE_NEW)
        par = eng.stats()["parallel"]
        tok_s = len(prompts) * MOE_NEW * 1e3 / sum(ms)
        flips = [next((i for i, (x, y) in enumerate(zip(a, b))
                       if x != y), None) for a, b in zip(got, base)]
        out["bf16"][f"{mname} plain"] = {
            "sequences_differing": sum(f is not None for f in flips),
            "first_differing_token": flips,
            "step_ms_p50": _pct(ms, 50),
            "no_mesh_step_ms_p50": _pct(base_ms, 50),
            "tokens_per_s": tok_s,
            "tokens_per_s_over_no_mesh": tok_s / base_tok_s,
            "ep": par["ep"], "tp": par["tp"],
            "param_gb_a_device": par["param_bytes_per_device"] / 1e9}
        del eng
    out["launches_float32"] = {k: {n: c for n, c in v.items() if c}
                               for k, v in launches.items()}
    need = {"plain": ("flash_fwd", "paged_attention"),
            "spec_k=4": ("flash_fwd", "paged_attention", "paged_verify"),
            "int8+spec_k=4": ("flash_fwd", "paged_attention_quant",
                              "paged_verify_quant")}
    for key, counts in launches.items():
        arm = key.split(" ")[-1]
        if device != "cpu" and not all(counts[n] for n in need[arm]):
            raise AssertionError(f"ep decode {key}: launches {counts}")
    base_toks, base_wall, _ = _ep_http_burst(
        _ep_engine(model, params, {}, None), prompts)
    for mname, axes, cfg in EP_DEC_MESHES:
        toks, wall, ep = _ep_http_burst(
            _ep_engine(model, params, {}, (mname, axes, cfg)), prompts)
        if ep != 2:
            raise AssertionError(f"/healthz ep {ep} under {mname}")
        out["http"][mname] = {
            "tokens_per_s": len(prompts) * MOE_NEW / wall,
            "tokens_per_s_over_no_mesh": base_wall / wall,
            "sequences_differing_from_no_mesh": sum(
                a != b for a, b in zip(toks, base_toks)), "healthz_ep": ep}
    log("[ep] (d) Switch-Base-8 widths DecodeEngine(mesh=..., num_slots=8, "
        "page_size=16), 8 prompts x 32 new tokens: float32 (TF32 off, 4 "
        "layers) greedy tokens identical to the engine without a mesh on "
        "one product per expert in every arm; bf16 (12 layers), the plain "
        "arm: " + json.dumps(out)
        + f" [{card}]")
    return out, launches


def _ep_predict(card, device, params):
    """(e) ``InferenceEngine(mesh={"ep": 2}, sharding=ShardingConfig(
    ep_axis="ep"))`` on the MoE LM's logits, float32, TF32 off, 4 rows x
    512: max |d| from the engine without a mesh on one product per expert
    (1e-5) and on its batched products (phase 20 (d)'s 1e-4), and the
    rows/s of the ep engine and of the batched one."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.serving import InferenceEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    model = model_from_json(_moe_spec(), device=device)
    ref = model_from_json(_moe_spec(), device=device)
    ref.per_expert_products = True
    rs = np.random.RandomState(25)
    x = rs.randint(0, SWITCH_BASE_8["vocab_size"],
                   (EP_PREDICT_ROWS, SWITCH_BASE_8["max_len"])
                   ).astype(np.int32)
    kw = dict(input_name="input_ids:0", output_name="logits:0",
              max_batch=EP_PREDICT_ROWS)
    engs = {"no mesh": InferenceEngine(model, params, **kw),
            "ep=2": InferenceEngine(model, params, mesh={"ep": 2},
                                    sharding=ShardingConfig(ep_axis="ep"),
                                    **kw)}
    got, rate = {}, {}
    for name, eng in engs.items():
        got[name] = eng.predict(x)
        t0 = time.perf_counter()
        for _ in range(3):
            eng.predict(x)
        rate[name] = 3 * EP_PREDICT_ROWS / (time.perf_counter() - t0)
    got["per expert"] = InferenceEngine(ref, params, **kw).predict(x)
    d = float(np.max(np.abs(got["ep=2"] - got["per expert"])))
    d_batched = float(np.max(np.abs(got["ep=2"] - got["no mesh"])))
    st = engs["ep=2"].stats()
    out = {"max_abs_diff": d, "max_abs_diff_batched": d_batched,
           "rows_per_s": rate, "ep": st["ep"],
           "param_gb_a_device": st["param_bytes_per_device"] / 1e9,
           "no_mesh_param_gb": engs["no mesh"].stats()[
               "param_bytes_per_device"] / 1e9}
    if not (d <= EP_PREDICT_TOL and d_batched <= TPF_PREDICT_TOL
            and st["ep"] == 2):
        raise AssertionError(f"(e) ep predict: {out}")
    log("[ep] (e) InferenceEngine(mesh={'ep': 2}) on the MoE LM, float32, "
        "4 x 512 logits: " + json.dumps(out) + f" [{card}]")
    return out


def _ep_hyper(card, device):
    """(f) ``hyperparameter_search`` with K = 4 learning rates at BERT-base
    widths cut to 4 layers (dropout 0: the sweep draws one mask for its K
    replicas, separate sweeps one each), float32, TF32 off, adam, 16 rows x
    512, batch
    8, 2 epochs (4 steps): the curves equal 4 separate one-rate sweeps
    within 1e-5 relative; kernels 1-3 launch once per layer and step for
    all four replicas (16 each), the separate sweeps 64."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.parallel.hyper import hyperparameter_search
    bert = build_registry_spec("transformer_classifier",
                               **dict(BERT_BASE, num_layers=EP_HYPER_LAYERS,
                                      dropout=0.0))
    rs = np.random.RandomState(26)
    ids = rs.randint(0, BERT_BASE["vocab_size"],
                     (EP_HYPER_ROWS, BERT_BASE["max_len"])).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, EP_HYPER_ROWS)]
    kw = dict(optimizer="adam", iters=EP_HYPER_ITERS,
              mini_batch_size=EP_HYPER_BATCH, seed=0, device=device)
    cuda = device != "cpu"

    def run(lrs):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = hyperparameter_search(bert, "input_ids", "y", ids, y,
                                    learning_rates=list(lrs), **kw)
        if cuda:
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(EP_HYPER_LRS[:1])          # first use of the shapes, untimed
    reset_launch_counts()
    sweep, sweep_s = run(EP_HYPER_LRS)
    counts = launch_counts()
    sweep_l = {n: counts[n] for n in MESH_NAMES}
    reset_launch_counts()
    sep, sep_s = [], 0.0
    for lr in EP_HYPER_LRS:
        r, s = run((lr,))
        sep.append(r.loss_curves[0])
        sep_s += s
    counts = launch_counts()
    sep_l = {n: counts[n] for n in MESH_NAMES}
    steps = EP_HYPER_ITERS * (EP_HYPER_ROWS // EP_HYPER_BATCH)
    rel = float(np.max(np.abs(sweep.loss_curves - np.stack(sep))
                       / np.maximum(np.abs(np.stack(sep)), 1e-12)))
    out = {"curves": sweep.loss_curves.tolist(), "max_rel_vs_separate": rel,
           "sweep_s": sweep_s, "separate_s": sep_s,
           "sweep_over_separate_time": sweep_s / sep_s,
           "launches_sweep": sweep_l, "launches_separate": sep_l,
           "best_learning_rate": float(sweep.best_learning_rate)}
    want = EP_HYPER_LAYERS * steps
    if not (rel <= EP_HYPER_TOL and np.isfinite(sweep.loss_curves).all()):
        raise AssertionError(f"(f) sweep vs separate fits: {out}")
    if cuda and not (sweep_l == {n: want for n in MESH_NAMES}
                     and sep_l == {n: want * len(EP_HYPER_LRS)
                                   for n in MESH_NAMES}):
        raise AssertionError(f"(f) launches {sweep_l} / {sep_l}, want "
                             f"{want} / {want * len(EP_HYPER_LRS)} each")
    log("[ep] (f) hyperparameter_search, K = 4, BERT-base widths cut to 4 "
        "layers, float32, TF32 off, adam, 16 x 512, batch 8, 4 steps: "
        + json.dumps(out) + f" [{card}]")
    return out, sweep_l


def phase_ep(card, work, device=None, pool=None):
    """Phase 22: expert parallelism and the vmapped sweep on the card (see
    the module docstring). The in-place rank work of (a)-(c) runs in
    ``pool`` (phase 18's) or a pool of its own. Returns the phase's
    launches and summary. Rehearse it on the CPU with ``device="cpu"`` and
    shrunk ``SWITCH_BASE_8`` / ``BERT_BASE``."""
    import torch
    from sparkflow_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    cuda = device != "cpu"
    kind = "cuda" if cuda else "cpu"
    os.environ["SPARKFLOW_TORCH_MESH_TIMEOUT_S"] = str(MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = distributed.choose_backend(2, kind)
    log(f"[ep] 2 ranks on {torch.cuda.device_count()} card(s), backend "
        f"{backend}; decode expert shard e on card (e * tp) % count. On one "
        f"card this shows the split banks, the exchanges and the kernels on "
        f"each rank, not scaling [{card}]")
    out = {"backend": backend, "seconds": {}}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - mark[0]
        mark[0] = now
        log(f"[ep] {name} {out['seconds'][name]:.1f} s")

    with _pool_of(pool, kind) as pool:
        out["train"], train_l = _ep_training(card, device, pool)
        pool.run(_rank_release)
        lap("a_training")
        out["a2a"], a2a_l = _ep_a2a(card, device, pool)
        pool.run(_rank_release)
        lap("b_all_to_all")
        out["exact"] = _ep_exactness(card, device, pool)
        lap("c_exact")
    from sparkflow_tpu_torch.models import model_from_json
    params = model_from_json(_moe_spec(), device=device).init(
        torch.Generator().manual_seed(0))      # float32, one draw for (d)-(e)
    out["decode"], dec_l = _ep_decode(card, device, params)
    lap("d_decode")
    out["predict"] = _ep_predict(card, device, params)
    del params
    lap("e_predict")
    out["hyper"], hyper_l = _ep_hyper(card, device)
    lap("f_hyper")
    launches = {}
    for n in TPF_NAMES:
        row = {"training_ep2": train_l.get(n, 0),
               "all_to_all_step": a2a_l.get(n, 0),
               "hyper_sweep_k4": hyper_l.get(n, 0)}
        row.update({f"decode {k}": v[n] for k, v in dec_l.items()})
        launches[n] = row
    out["launches"] = launches
    log(f"[ep] phase 22 {time.perf_counter() - t0:.1f} s, by part "
        + json.dumps(out["seconds"]) + f" [{card}]")
    return out


def _timed(name, fn, *args):
    """``fn(*args)`` with a ``[time]`` line; the cached card memory it
    leaves is freed after it, as the other process shares the card."""
    import gc
    import torch
    t = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name} {time.perf_counter() - t:.1f} s")
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


MESH_GROUP_RESULT = "mesh-group.json"


def run_mesh_group(work: str) -> int:
    """Phases 18-21 (``python3 chip_smoke.py --mesh-group WORK``), the
    second process :func:`main` runs beside its own phases: the kernel
    library phase 1 built is found in the build directory, the four phases
    share one 2-rank pool and write under ``WORK``, and what the kernels
    line needs of them goes to ``WORK/mesh-group.json``. Exits when its
    caller is gone."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    caller = os.getppid()

    def orphaned():
        while os.getppid() == caller:
            time.sleep(1.0)
        os._exit(3)     # the pool's ranks exit once this process is gone

    threading.Thread(target=orphaned, daemon=True).start()
    try:
        from sparkflow_tpu_torch.ops import _build
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card")
        card = card_line()
        _build.load()
        log(f"[mesh-group] kernel library {_build.loaded()['how']} in "
            f"{_build.loaded()['seconds']:.1f} s [{card}]")
        with _timed("mesh-pool", mesh_pool) as pool:
            mesh = _timed("mesh", phase_mesh, card, work, pool)
            stream_mesh = _timed("stream-mesh", phase_stream_mesh, card,
                                 work, mesh, None, pool)
            tpf = _timed("tp-fsdp", phase_tp_fsdp, card, work, None, pool)
            ppr = _timed("pp", phase_pp, card, work, None, pool)
        out = {"mesh": {"launches": mesh["launches"]},
               "stream_mesh": {"launches": stream_mesh["launches"]},
               "tp_fsdp": {"launches": tpf["launches"],
                           "kernels_h6": tpf["kernels_h6"]},
               "pp": {"launches": ppr["launches"]}}
        path = os.path.join(work, MESH_GROUP_RESULT)
        with open(path + ".tmp", "w") as f:
            json.dump(out, f, default=lambda o: o.item()
                      if hasattr(o, "item") else str(o))
        os.replace(path + ".tmp", path)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def _start_mesh_group(work):
    """Start :func:`run_mesh_group` in a second process writing under
    ``work/mesh-group``, its standard output relayed line by line."""
    d = os.path.join(work, "mesh-group")
    os.makedirs(d)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-group", d],
        stdout=subprocess.PIPE, text=True, bufsize=1)

    def relay():
        for line in proc.stdout:
            log(line.rstrip("\n"))

    relay_thread = threading.Thread(target=relay, daemon=True)
    relay_thread.start()
    return proc, relay_thread, d


def _join_mesh_group(group):
    """Wait for the second process; its summaries, or AssertionError."""
    proc, relay_thread, d = group
    rc = proc.wait()
    relay_thread.join(timeout=60)
    if rc != 0:
        raise AssertionError(f"phases 18-21 failed in their process (exit "
                             f"{rc}); its traceback is above")
    with open(os.path.join(d, MESH_GROUP_RESULT)) as f:
        return json.load(f)


def main(only: str = None) -> int:
    """All phases; with ``only`` set-up and one phase alone, its summary in
    place of the kernels line: ``"spec-serving"`` (3), ``"families"`` (16),
    ``"tp-fsdp"`` (20), ``"pp"`` (21) or ``"ep"`` (22)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sparkflow_tpu_torch  # noqa: F401 - fails outside a checkout
    from sparkflow_tpu_torch.device import device_report
    card = card_line()
    log(f"[setup] {card}")
    t0 = time.perf_counter()
    # phase 12's fitted weights and phase 13's weight store
    work = tempfile.mkdtemp(prefix="chip-smoke-")
    alone = {"tp-fsdp": ("tp_fsdp", phase_tp_fsdp), "pp": ("pp", phase_pp),
             "ep": ("ep", phase_ep)}
    single = {"spec-serving": ("spec_serving", phase_spec_serving),
              "families": ("families",
                           lambda card: phase_families(card, work))}
    if only is not None:
        if only not in alone and only not in single:
            print(f"chip_smoke: unknown phase {only!r}; one of "
                  f"{sorted(alone) + sorted(single)}", file=sys.stderr)
            return 2
        try:
            _timed("setup", phase_setup)
            if only in single:
                key, fn = single[only]
                summary = _timed(only, fn, card)
            else:
                key, fn = alone[only]
                with _timed("mesh-pool", mesh_pool) as pool:
                    summary = _timed(only, fn, card, work, None, pool)
        except Exception:
            traceback.print_exc()
            return 1
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({key: summary}, default=str))
        print(card_line())
        print(json.dumps({"ok": True, "device": device_report()}),
              flush=True)
        return 0
    group = None
    try:
        _timed("setup", phase_setup)
        flash_row, paged_row = _timed("kernels", phase_kernels, card)
        spec_rows = _timed("spec-kernels", phase_spec_kernels, card)
        bwd_rows = _timed("bwd", phase_backward_kernels, card)
        # the kernels' times are taken: phases 18-21 start beside the rest
        group = _start_mesh_group(work)
        launches, eng = _timed("serving", phase_serving, card)
        _timed("profile", phase_profile, card, eng)
        del eng
        spec_launches = _timed("spec-serving", phase_spec_serving, card)
        _timed("exactness", phase_exactness, card)
        _timed("spec-exactness", phase_spec_exactness, card)
        train_launches = _timed("training", phase_training, card)
        _timed("train-exactness", phase_train_exactness, card)
        (spec, weights), est_rows = _timed("estimator", phase_estimator,
                                          card, work)
        predict = _timed("predict", phase_predict, card, spec, weights, work)
        resil = _timed("resilience", phase_resilience, card, work)
        fleet = _timed("fleet", phase_fleet, card, spec, work)
        families = _timed("families", phase_families, card, work)
        tf1_hog = _timed("tf1-hogwild", phase_tf1_hogwild, card, work)
        with _timed("mesh-pool", mesh_pool) as pool:
            epr = _timed("ep", phase_ep, card, work, None, pool)
        side = _timed("mesh-group wait", _join_mesh_group, group)
        mesh, stream_mesh = side["mesh"], side["stream_mesh"]
        tpf, ppr = side["tp_fsdp"], side["pp"]
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if group is not None and group[0].poll() is None:
            group[0].kill()
            group[0].wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    log(f"[time] all phases {time.perf_counter() - t0:.1f} s")
    src = "sparkflow_tpu_torch/ops/csrc/"
    ref = "sparkflow_tpu/ops/attention.py:"
    spec_a, spec_b = spec_launches["a"], spec_launches["b"]
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": ref + "196",
         "launches": launches["flash_fwd"], **flash_row,
         # the same kernel on the training path: its launches there and its
         # times at the training shape
         "training": {"launches": train_launches["flash_fwd"],
                      **bwd_rows["flash_fwd"]},
         "spec_serving": {"launches": [spec_a["flash_fwd"],
                                       spec_b["flash_fwd"]]},
         # the estimator phase: BERT-base fit (launches) and transform,
         # times at its shape (float32, B=32, S=512, padded keys)
         "estimator": est_rows["flash_fwd"],
         # the predict phase: launches per arm (a) float32, (b) bf16,
         # (c) weight_only, (d) dynamic; times at its largest bucket, bf16
         "predict": predict,
         # phase 14: the BERT-base stream fit's launches, and a step's at
         # GPT-2-small width in each remat mode
         "resilience": {"stream_fit_launches":
                        resil["stream_fit"]["flash_fwd"],
                        "remat_launches_per_step":
                        resil["remat_flash_fwd_per_step"]},
         # phase 15: each drained replica's launches over what it served
         "fleet": fleet["flash_fwd"],
         # phase 16: the Switch-Base-8-width MoE LM's serving burst and its
         # 8 training steps
         "families": {"moe_serving_launches":
                      families["serving"]["flash_fwd"],
                      "moe_training_launches":
                      families["training"]["flash_fwd"]},
         # phase 17: BERT-base HogwildSparkModel, 4 replica threads
         "tf1_hogwild": {"launches":
                         tf1_hog["hogwild"]["launches"]["flash_fwd"]},
         # phase 18: summed over the ranks — the dp=2 estimator fits, and
         # the sp=2 GPT-2-small fit's ring visits
         "mesh": _mesh_launches(mesh, "flash_fwd"),
         # phase 19: the dp=2 stream fit summed over the ranks, and one
         # bucket call of the dp=2 engine
         "stream_mesh": stream_mesh["launches"]["flash_fwd"]},
        {"name": "paged_attention", "route": "cuda",
         "source": src + "paged_attention.cu", "replaces": ref + "734",
         "launches": launches["paged_attention"], **paged_row,
         # the self-speculation draft chain of burst (a), bf16 pool
         "spec_serving": {"launches": spec_a["paged_attention"]},
         "fleet": fleet["paged_attention"],
         "families": {"moe_serving_launches":
                      families["serving"]["paged_attention"]}},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "372",
         "launches": train_launches["flash_bwd_dq"],
         **bwd_rows["flash_bwd_dq"], "estimator": est_rows["flash_bwd_dq"],
         "resilience": {"stream_fit_launches":
                        resil["stream_fit"]["flash_bwd_dq"]},
         "families": {"moe_training_launches":
                      families["training"]["flash_bwd_dq"]},
         "tf1_hogwild": {"launches":
                         tf1_hog["hogwild"]["launches"]["flash_bwd_dq"]},
         "mesh": _mesh_launches(mesh, "flash_bwd_dq"),
         "stream_mesh": stream_mesh["launches"]["flash_bwd_dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "415",
         "launches": train_launches["flash_bwd_dkv"],
         **bwd_rows["flash_bwd_dkv"],
         "estimator": est_rows["flash_bwd_dkv"],
         "resilience": {"stream_fit_launches":
                        resil["stream_fit"]["flash_bwd_dkv"]},
         "families": {"moe_training_launches":
                      families["training"]["flash_bwd_dkv"]},
         "tf1_hogwild": {"launches":
                         tf1_hog["hogwild"]["launches"]["flash_bwd_dkv"]},
         "mesh": _mesh_launches(mesh, "flash_bwd_dkv"),
         "stream_mesh": stream_mesh["launches"]["flash_bwd_dkv"]},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": src + "paged_attention.cu", "replaces": ref + "781",
         "launches": spec_b["paged_attention_quant"],
         **spec_rows["paged_attention_quant"]},
        {"name": "paged_verify", "route": "cuda",
         "source": src + "paged_verify.cu", "replaces": ref + "967",
         "launches": spec_a["paged_verify"], **spec_rows["paged_verify"]},
        {"name": "paged_verify_quant", "route": "cuda",
         "source": src + "paged_verify.cu", "replaces": ref + "1015",
         "launches": spec_b["paged_verify_quant"],
         **spec_rows["paged_verify_quant"]},
    ]
    for row in kernels:
        # phase 20: the launches of its tp / fsdp paths (training and
        # estimator fits summed over the ranks, decode over both shards),
        # and the kernel against its plain version at a tp=2 shard's 6
        # heads
        row["tp_fsdp"] = {"launches": tpf["launches"][row["name"]],
                          "heads6": tpf["kernels_h6"][row["name"]]}
        # phase 21: the launches of its pp paths (each schedule's fit and
        # the estimator's summed over the ranks, each decode arm over the
        # stages)
        row["pp"] = {"launches": ppr["launches"][row["name"]]}
        # phase 22: the launches of its ep paths (the ep=2 fit and the
        # all_to_all step summed over the ranks, the K = 4 sweep, each
        # decode arm over the shards)
        row["ep"] = {"launches": epr["launches"][row["name"]]}
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replica"]:
        sys.exit(run_replica(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(main(only=sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-group"]:
        sys.exit(run_mesh_group(sys.argv[2]))
    sys.exit(main())
