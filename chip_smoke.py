#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elasticdl_tpu_torch``) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  Phases, each fatal on failure (the
training phases 5-9 follow the serving phases 3-4):

1. The card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of the hand-written kernels from ``ops/csrc``; each
   attention kernel's registers, shared memory, stack and spill bytes,
   and its count of tensor-core instructions (HMMA, HGMMA) in its SASS,
   read with ``cuobjdump`` from the library's cubins, each dumped by
   processes of its own (a line says so where cuobjdump is missing); the
   bf16 and f16 K4-K9 builds (K8 and K9 each for a dO of q's type and an
   f32 dO) must hold HMMA or HGMMA; the registers, spills and
   local memory of the sparse kernels (K1-K3, K10; K2 per unit width)
   beside them.
2. Each kernel against its plain PyTorch version on the card, on a
   26M-row table (DeepFM's 26 fields x 1M ids, dim 1+8 -> [26M, 16]
   f32), generated on the device from a seeded ``torch.Generator``:
   exactness, then a median time per launch from CUDA events (L2
   flushed between launches), beside the plain version's time and the
   least time the card's memory rate allows for the same bytes (and for
   K1 the same rows counted in whole 32-byte sectors).  K1's split at
   [64, 26], [8192, 26] and [8192, 26] with ``bet``: the kernel alone
   (its C entry point on inputs prepared once), the whole call, the
   call's host time (a synchronize on each side) and its device records
   per call from ``torch.profiler`` (kernels, copies and their
   launches).  K2 the same way (both bounds, the split, ``index_select``
   of the rows) at each of K2_SHAPES: 65,536 ids on the merged table, a
   serving batch [1664] on the split layout's dim-1 and dim-8 tables, a
   training batch [212,992] on the table-scale dim-1 and dim-8 tables;
   then bit-exact at dims 1-130, n of 0, 1 and a ragged tile, ids
   negative, past the table and near +-2**31.
3. Serving at full width: a merged-layout DeepFM artifact (vocab 1M per
   field, embedding_dim 8, hidden 128, seeded weights) written with
   ``write_artifact``, served by ``ServingReplica`` on the default
   device through ``MicroBatcher``; 8 client threads issue 200 requests
   of 8 rows, every response is checked against the same model's plain
   forward on the card, and QPS and p50/p99 latency are printed.
4. Hot swap to a ``split_tables`` artifact (the layout ``fused_lookup``
   serves), checked the same way; ``stats()`` must show generation 2.

5. ``fused_dedup_apply`` (K3) against its plain version on the same
   26M-row table and its slots, for sgd, momentum, Nesterov, adagrad,
   adam (per-row ``t``) and adam_global: 212,992 ids (8192 x 26) drawn
   with heavy duplicates, ``-1`` padding, ids past the table and rows
   whose grads cancel exactly; bit-exact against the plain version run
   with PyTorch's deterministic algorithms (same summation order), then
   timed like phase 2, beside the bytes bound and the 32-byte-sector
   bound; for each kind the split of phase 2 (the device records part
   the sort from the kernel).  Then the same recipe on a 20,000-row
   table at dims 1, 3, 5, 20 and 40 (one to ten groups a warp, and two
   column passes), with segments of 150 and 40 and rows whose grads
   cancel in some columns only: all six kinds bit-exact over two
   applies.
6. Training at full width: DeepFM merged (vocab 1M per field, 26M rows;
   table + m + v + t = 6.7 GB), ``embedding_dim`` 8, ``hidden`` 128,
   batch 8192 of the synthetic Criteo-layout data, dense Adam 1e-3 and
   sparse per-row Adam 1e-3, strict apply: warm-up, 50 timed steps
   (samples/s, median step time), one CUDA-event breakdown of a step
   (forward, backward, dense update, K3); the loss must fall.
7. Kernels against plain versions on the path: from one cloned state, 3
   steps through the kernels and 3 with the plain versions patched in.
8. Train -> serve: ``export_model``, then ``ServingReplica`` on the card
   must predict the trainer's ``eval_step``.
9. 64 steps at ``sparse_apply_every=32`` through ``train_window``.

The long-context slice (the transformer LM and its flash-attention
kernels K4-K6):

10. K4 (forward), K5 (dQ) and K6 (dK/dV) against their plain versions on
    the card, on seeded bf16 inputs at the bench attention shape (B=16,
    H=8, T=2048, D=64; causal and not) and at T=8192, B=2 (causal):
    out, lse, dq, dk, dv within the stated tolerances, then timed like
    phase 2 beside the plain versions, the bound (operations over the
    bf16 peak, or bytes) and PyTorch's ``scaled_dot_product_attention``,
    with the TFLOP/s each reaches (the bound's operations over its time).
11. Training at full width: ``TransformerLM`` at ``bench.py``'s
    ``TRANSFORMER_BENCH`` (vocab 32768, d_model 512, 8 heads, 4 layers,
    T=2048, bf16, f32 head), batch 16 of the synthetic LM data, AdamW
    3e-3, by ``DataParallelTrainer`` on the default device: warm-up, 10
    timed steps (tokens/s, median step, a CUDA-event breakdown with K4's,
    K5's and K6's in-step times, peak memory), the loss must fall;
    then one ``train_window`` of 4 staged steps.
12. From one cloned state, 3 steps through the kernels and 3 with the
    plain versions patched in: losses and parameters within the stated
    tolerances.

The context-parallel slice (the ring-step kernels K7-K9, the LM with its
sequence sharded over a mesh's ``model`` axis):

13. K7 (the ring step's forward with the carry combine), K8 (dQ) and K9
    (dK/dV) against their plain versions: nine edge shapes with random
    positions (head_dim 8-256: 136 and 256 on the DP=256 builds in bf16
    and f32, 100 through the wrappers' pad to 104) and one whose first
    40 queries see no key (K8 must give
    them dq = 0); every step of a ring of 4, contiguous and zigzag causal
    positions, at the CP LM's slot shape (B=4, T_local=2048, H=8, D=64)
    in bf16 and f32, and at ``bench.py``'s RING_BENCH (B=4, T_local=2048,
    H=8, D=128, bf16) with a full step too; with bf16 inputs K8 and K9
    run twice, on a random f32 dO and on the path's bf16 dO; one bf16
    edge on a q, a K/V block and a dO that sit 2 bytes past a 16-byte
    boundary (the launchers refuse them, the wrappers copy them).  Timed
    like phase 10 at RING_BENCH's unmasked step beside their bounds and
    PyTorch's memory-efficient attention with the step's mask as its
    bias (K8 and K9 with each dO), and at the CP LM's slot shape (its
    unmasked step).
14. An in-process ring of 4 slots (``parallel.mesh.virtual_devices``) on
    B=2, T=8192, H=8, D=64 bf16 causal, both layouts, against K4-K6 on
    the whole sequence: output and gradients at phase 10's tolerances.
15. The LM at TRANSFORMER_BENCH's widths, T=8192 (max_len 8192), batch 4,
    context parallel over an in-process (data=1, model=4) mesh of the
    card, ``contiguous`` and ``zigzag``: 2 warm-up and 5 timed steps
    (tokens/s, median step, the CUDA-event breakdown with K7-K9's time in
    the step, peak memory); the loss must fall.
16. From one state, 3 steps of the CP path against the one-card trainer
    (K4-K6 on T=8192) on 1 row of each batch (CP_GATE_BATCH), the LM at 1
    of its 4 layers (CP_GATE_LAYERS): with f32 blocks at phase 12's
    tolerances; with
    bf16 blocks at CP_BF16_TOL, kernels on both sides and then, as the
    witness, the plain versions on both sides.

The sharded K1-K3 dispatch and the block-gather probe K10:

17. K10 (``ops/sparse_gather.py``) at its experiment script's size,
    212,992 indices into the 26M-row, dim-16 table seeded on the device,
    10 of them past the end or negative: bit-exact against its plain
    version, timed like phase 2 beside its bound and ``index_select``;
    then ``exp_sparse_gather``'s two selftests on the card, and one
    default-mode and one ``--shard_map`` measurement (their tables
    printed); the default mode is K10's path and counts its launches.
18. Phase 2's 26M-row merged table over an in-process (data=1, model=4)
    mesh (3.25M storage blocks, split): the sharded K2 (the shard routing
    inside the kernel) bit-exact with the one-card K2 (ids no shard owns
    read zeros) and with the plain route for every id, also with a -0.0
    and a NaN in two shards' first rows; 4 K2 launches and at most 7
    device launches a call (profiler records); the sharded K1's ``acts``
    equal and its sums within the reduction-order bound (fields + shards
    terms), the sharded K3 bit-exact with the one-card K3 for each of
    phase 5's kinds (two applies); the split layout's dim-1 table at 2.6M
    rows (20,313 blocks) takes the replicated route (one launch); each
    sharded call timed beside the one-card call.
19. Phase 6's DeepFM over the (1, 4) mesh: warm-up, 20 timed steps
    (samples/s, median step, launches per step: 4 of K1 and 4 of K3), the
    loss falls; 3 sharded steps against 3 one-card steps from one state
    at phase 7's tolerances; ``export_model``, then ``ServingReplica(out,
    mesh=...)`` answers ``eval_step`` and serves phase 3's 200 requests
    of 8 rows from 8 clients against the plain forward (4 K1 launches per
    dispatch); a hot swap to phase 4's ``split_tables`` artifact (its
    dim-8 table split, its dim-1 table replicated: 5 K2 launches per
    dispatch).

The table-scale split layout (K2 on the path it serves):

20. ``bench.py``'s ``bench_deepfm_table_scale_strict`` through
    ``build_model`` and ``ShardedEmbeddingTrainer``: DeepFM at vocab 1M
    per field in the split layout its layout rule picks there (a dim-1
    and a dim-8 table of 26M rows, with m and v 2.8 GB), batch 8192,
    strict, sparse Adam with global bias correction: 3 warm-up and 20
    timed steps (samples/s, median step, the step's parts with K2's
    device time inside it), 2 K2 and 2 K3 launches a step and no K1, the
    loss falls; 3 steps through the kernels against 3 with the plain
    versions from one state (phase 7's tolerances).

Checkpoints and the delta chain (``elasticdl_tpu_torch.checkpoint``, the
JAX package's on-disk layout), on the paths of K2, K3 and K4-K6:

21. Phase 20's configuration: 5 steps, ``save_checkpoint`` into a
    ``ShardedCheckpointSaver`` (tables, m and v, 2.8 GB), then a trainer
    of another seed restores ``latest_step()`` at ``ensure_initialized``
    into its own tensors (their ``data_ptr`` unchanged): every leaf
    bit-exact (tables, m, v, ``t_global``, dense params, Adam state,
    step); so does a trainer over the in-process (1, 4) mesh (the dim-8
    table's 1,625,000 blocks split four ways, the dim-1 table's 203,125
    replicated), whose next step's loss agrees with the one-card
    trainer's (phase 7's loss tolerance); 3 steps of the saved and the
    resumed trainer on the same batches at phase 7's tolerances (and
    whether they were bit-exact); 10 timed steps of each in turns
    (saved, resumed, resumed, saved: samples/s beside phase 20's, the
    resumed trainer's 2 K2 and 2 K3 launches a step); the save, CRC and
    restore seconds and the bytes written.
22. From the resumed trainer: ``publish_full``, 2 steps,
    ``publish_delta`` (the changed blocks and bytes of each table);
    ``resolve_chain`` gives the full and the delta; the full's tables
    patched with ``load_delta``'s blocks equal a fresh ``export_model``
    bit for bit; ``ServingReplica(full)`` on the card, then
    ``apply_delta``: the replica serves the delta's step, within
    LOGIT_RTOL/LOGIT_ATOL of ``eval_step`` on the held-out rows, 2 K2
    launches a dispatch; the publish and apply seconds.
23. The LM at TRANSFORMER_BENCH (bf16 blocks), batch 16: 2 steps,
    ``CheckpointSaver.save(trainer.state_to_jax_host())``,
    ``load_latest`` into a fresh trainer (bit-exact), then one
    forward/backward and 2 steps on both within LM_PATH_TOL, K4-K6 4
    times each a step.

The continuous train -> serve loop (``serving/continuous.py``,
``serving/replica_main.py``), at phase 20's configuration, nothing cut
(phase 22's resumed trainer and replica when they ran):

24. In process: a ``DeltaExporter`` publishes a full, then deltas of 2
    steps each (event time = the step); a ``ServingReplica`` on the card
    is moved only by ``DeltaWatcher.poll_once()``: the first poll reloads
    the full, then one applied link per poll for 2 links, the held-out
    logits within LOGIT_RTOL/LOGIT_ATOL of ``eval_step`` after each, 2 K2
    a dispatch; the fault run (``serving.delta_apply:error=injected@2``):
    link 2 rolls back, the same generation serves the same bits, the next
    poll applies it; the canary gate (``CanaryGate`` over 256 labeled
    held-out rows): the delta of the trainer with its output layer
    (``Dense_2``) negated is held with the pointer unmoved, the healthy
    delta republished at that step passes (16 K2 in the gate's shadow
    runs); the journal's ``model_swap`` and ``quality_gate`` events; the
    seconds of each ``poll_once``, publish, ``build_delta_generation``,
    ``shadow_execute`` and ``commit_generation``; then a compaction.
25. ``python -m elasticdl_tpu_torch.serving.replica_main`` on the card
    from the compacted full, ``--pub_dir`` polled every 0.5 s,
    ``ELASTICDL_FAULTS=serving.delta_apply:error=injected@2``: once it is
    in ``live_replicas``, 8 closed-loop ``PredictClient``s send 8-row
    requests while 2 deltas are published (PHASE25_LINKS); after each,
    ``/stats`` reaches its step and the held-out logits from ``/predict``
    agree with ``eval_step``; SIGTERM, exit 0 within 30 s.  Every request answered,
    the last ``serving_telemetry`` with 0 errors, 0 shed and 0 dropped,
    ``model_swap`` applied per link with one rolled_back, no JAX or gRPC
    module loaded, 2 K2 launches per dispatch (the process's counts on
    ``/stats``); requests/s and p50/p99 over the run and within 1 s of
    each swap, publish -> served lag per link, seconds to the first
    answer.  A replica process that dies fails the phase with its log's
    tail.

The elastic job (``master/``, ``worker/``, ``parallel/elastic.py``):

26. ``python -m elasticdl_tpu_torch.master.main`` runs the PS job on the
    card as processes: DeepFM at vocab 1M per field in the split layout
    its layout rule picks under ``--sparse_apply_every=1`` (26M rows),
    the zoo's per-row Adam, batch 8192, ``synthetic://criteo`` with
    196,608 records in 6 tasks of 32,768, a checkpoint every 12 steps,
    ``--pipeline async --parse_pool_workers 2``, one worker process (one
    NCCL rank per card: the card's job is a world of one).  Once the
    step-12 checkpoint is committed the worker, the master's child, is
    SIGKILLed by its pid: the master's journal must show the churn and a
    second world, the new worker restore step 12, the in-flight task be
    requeued and every record range done, exit 0; each worker process
    journals K2 and K3 twice per step it trained and no JAX, gRPC or
    protobuf module (the master too); the export is bit-exact with the
    final sharded checkpoint's tables and dense params, and a
    ``ServingReplica`` of it answers 256 held-out rows within
    LOGIT_RTOL/LOGIT_ATOL of a trainer restored from that checkpoint.
    Printed (host clock): master start -> first task, worker launch ->
    first step, samples/s over the steady tasks (neither a worker's first
    nor holding a save) beside phase 20's and over the whole job, each
    checkpoint save, the rescale (kill -> detection, relaunch, restore,
    first step after), the wall.
27. The same job reads files and evaluates: before the master starts,
    the port's writer (``zoo.deepfm.write_criteo_etrf``) writes 262,144
    records drawn from ``--seed`` as ``bench.py:514-532`` draws them in
    2 ETRF shards of 131,072 (165 bytes a record and 8 of index), and
    65,536 from ``seed + 27`` in one validation shard; the job trains on the
    shard directory through the columnar route (32 steps in 8 tasks of
    32,768) with ``--validation_data`` and ``--evaluation_steps=32``,
    one checkpoint at the end, no kill.  Gates: exit 0; every training
    range done and every evaluation range done in every round (a round
    journaled at version 32, over 65,536 rows); "Columnar
    task path engaged" logged for training and for evaluation, and no
    task read record by record through the ETRF reader; the native
    codec served the worker; 2 K2 and 2 K3 a training step and 2 K2 an
    evaluation batch in the worker's journal; no forbidden module in
    either process; the final round's accuracy equal to, and its AUC
    within AUC_TOL of, an in-process evaluation of the final checkpoint
    over the same validation records.  Printed (host clock): samples/s
    and the data-wait share over the steady tasks (all but the first)
    beside phase 26's when both ran, a steady task's mean split (task
    seconds, dispatch -> done, data wait, the columnar read and parse,
    the transform, staging), one task's materialisation timed again in
    the smoke run's own process (read, parse, join, transform, whole,
    the Python codec's read), evaluation samples/s and each round's
    seconds, the wall.
28. ResNet-50 at ``bench.py``'s ``bench_resnet50`` width, nothing cut
    (224x224 uint8 images, batch 128, bf16, 1000 classes, stages (3, 4,
    6, 3), Nesterov SGD at 0.1, the model ``channels_last``) trained
    through ``DataParallelTrainer`` (a world of one): 20 timed steps after
    3.  Printed: images/s (host wall), the step's median and range (CUDA
    events), the median split into forward, backward and update (CUDA
    events, 5 steps), one step's host enqueue time after an empty queue,
    a step's device time by kernel class and its busy share
    (``torch.profiler``), the peak memory, the loss at the first and last step, and the largest
    move of the running statistics (they must move).  Gate 1: the card's
    f32 eval forward at batch 8 (weights from a seeded random JAX-layout
    tree through ``serving.convert``) within VISION_F32_RTOL of the
    largest logit of the port's CPU forward on the same weights.  Gate
    2: the single-device ``Trainer`` and ``DataParallelTrainer``, 3 steps
    from one state with cuDNN's deterministic algorithms, their parameter
    updates and ``batch_stats`` moves within VISION_PATHS_RTOL (relative
    L2).
29. The Local job from files: the port's ``write_image_etrf`` writes 2
    training shards of 1,536 synthetic ImageNet images stored at 256x256
    and a validation shard of 512 (``--seed``), then ``python -m
    elasticdl_tpu_torch.client.main train --distribution_strategy=Local``
    trains ResNet-50 on them (batch 128, tasks of 384, an evaluation round
    every 12 versions, ``--output``).  Gates: exit 0; every training and
    evaluation range done, the rounds at versions 12 and 24 over 512
    rows; "Columnar task path engaged" for training and evaluation with
    224x224 batches (the 256 -> 224 crops); no forbidden module in the
    process; the final accuracy equal to, and the final loss within
    VISION_LOSS_RTOL of, an evaluation in the smoke run's process of the
    exported artifact reloaded through
    ``serving/export.load_for_serving``.  Printed (host clock): images/s
    over the steady tasks (all but the first), a steady task's mean
    split (task, data wait, read and parse, crop, stage), each round's
    seconds, the wall.  Phases 28 and 29 launch none of K1-K10.

The census slice (``preprocessing/``, the CTR zoo, the supervisor):

30. The CTR zoo through ``ShardedEmbeddingTrainer`` on the card: census
    Wide&Deep (its device transforms inside ``forward``, one id space of
    201 rows) and its feature-column twin (229 rows) at batch 512 of raw
    ``synthetic://census`` records, Wide-and-Deep at its default vocab
    (26,000 rows) at batch 4096: 20 timed steps after 3 (samples/s,
    median step; K2 and K3 twice a step, for the wide dim-1 and the deep
    dim-8 table, no K1), 3 steps through the kernels against 3 through
    the plain versions from one state (losses, tables and dense params
    at phase 7's tolerances, at the zoo's lr), then K2 and K3 alone on
    one step's ids and gradients: K2 bit-exact with its plain version,
    K3 over two applies bit-exact with its plain version under
    deterministic algorithms, each timed (the kernel alone, the whole
    call) beside the plain version and the bytes bound.
31. Census as a PS job: ``python -m elasticdl_tpu_torch.client.main
    train --distribution_strategy=ParameterServerStrategy
    --model_def=census.census_wide_deep`` on 32,768 raw synthetic census
    records (UCI Adult has 32,561), 2 epochs of batch 512 (128 steps) in
    tasks of 4,096, 8,192 validation records evaluated every 32
    versions, exported to ``--output``.  Gates: exit 0; every range
    done, every round over the 8,192 records; the loss falls (the
    worker's per-task losses); 2 K2 and 2 K3 a step and 2 K2 an
    evaluation batch in the worker's journal; no forbidden module; the
    export C-contiguous at step 128, and its evaluation here on the same
    records equal to the job's final metrics (accuracy exactly, AUC
    within AUC_TOL).  Printed (host clock): steady samples/s and the
    data-wait share, a worker's start, each round's seconds.
32. ``serving.supervisor.start_serving_fleet(2, ...)`` serves phase 31's
    export from two replica processes on the card; requests are 8-row
    batches of raw census records through ``preprocess_record``.  Gates:
    both replicas answer each request bit-identically and within
    LOGIT_RTOL/LOGIT_ATOL of ``eval_step``; 8 closed-loop clients see
    every request answered while one replica reloads gen2 (phase 31's
    checkpoint after 4 more steps), which it then serves while the other
    serves gen1; after ``kill_worker(rid, 9)`` the survivor answers
    throughout and the supervisor starts a replica with a fresh id that
    serves gen1; 2 K2 a dispatch in each replica (``/stats``); the
    journal holds ``serving_fleet_start``, three ``serving_replica_start``
    (no forbidden module), ``model_swap`` and one ``worker_churn``.
    Printed: requests/s and p50/p99 before the swap, across it, on the
    survivor across the kill and after it; kill -> the fresh replica's
    first answer.

The elastic control plane (``obs/{goodput,stepstats,telemetry}.py``,
``master/policy.py``) runs in every job: phases 26, 27 and 31 print the
master's goodput ledger (``goodput_ratio``, its phases summing to its
wall within LEDGER_RTOL; phase 26 its one ``rescale_cost`` of cause
``worker_churn``, split into detection, rendezvous and redo, beside the
host-clock rescale seconds), and each worker journals its step anatomy
after every flush.  The AllReduce jobs:

33. ``python -m elasticdl_tpu_torch.master.main
    --distribution_strategy=AllreduceStrategy`` trains ResNet-20
    (``cifar10.cifar10_functional_api``, bf16) on 16,384 synthetic
    CIFAR-10 images (cut from 50,000), batch 128, tasks of 2,048, a
    checkpoint every 32 steps, one worker process (a world of one).
    Once the step-32 checkpoint is committed and a task is in flight,
    the worker is SIGKILLed; the world re-forms.  Gates: exit 0; the
    churn, a second world, the in-flight task requeued and every range
    done; the new worker's restore bit-exact with the checkpoint (its
    journaled CRC32 of params, SGD trace and ``batch_stats`` equal to the
    dead worker's at that save and to the file's); the export equal to
    the final checkpoint's params and ``batch_stats``, bit for bit; one
    ``rescale_cost`` of cause ``worker_churn`` whose parts sum to its
    total; the ledger's phases summing to its wall within LEDGER_RTOL;
    the policy engine's ``hold`` decisions journaled; every journal
    record carrying the port's required fields; no forbidden module in
    any process; no K1-K10 launch (none is on this path).  Printed: the
    goodput ratio and phases, the rescale's detection, rendezvous and
    redo seconds beside the host clock's kill -> first step, the step
    anatomy's fractions with the card's roofline verdict, steady
    images/s.
34. The same job on ResNet-50 at phase 28's width (224x224 uint8
    images, batch 128, bf16, 1000 classes) on 6,144 synthetic ImageNet
    images (cut from 1.28M) in tasks of 768, a checkpoint every 12
    steps, ``--pipeline async --parse_pool_workers 4``; the same kill
    after the step-12 save and the same gates.  Printed as phase 33,
    beside phase 28's CUDA-event step time when it ran.

The bf16 LM head, the continuous job from a stream and the sparse
optimizer's xla engines:

35. The LM at phase 11's width with ``logits_compute="bf16"`` beside the
    f32 head, each 10 timed steps (HEAD_STEPS) from one seed: K4-K6 once per layer per
    step; the bf16 head's logits (f32) within the bf16 operand-rounding
    bound of the f32 head on the same parameters and input (``head_bound``:
    ``(2**-7 + 2**-16 + 2 d 2**-24) * |x| @ |w|.T``); the cuBLAS bf16
    product's output not rounded to bf16; 3 steps against the plain path
    (phase 12's tolerances).  Prints step ms, the head's forward and
    backward ms (CUDA events) and tokens/s for both heads.  TF32 is off.
36. The continuous loop from an unbounded stream on DeepFM at phase 20's
    configuration (reusing phase 22/24's trainer when it ran): a
    ``SyntheticClickStream`` at ``[(4.0, 51200), (2.0, 204800)]``
    records/s on 24 virtual ticks of 0.25 s, a ``StreamingTaskManager``
    (tasks of 8192, lookahead 8) drained by three workers a tick, deltas
    published with the watermark's event time, a DeltaWatcher moving an
    in-process ServingReplica under a load-generator thread, the faults
    ``stream.source:latency=1.0@t2.0``, ``ckpt.delta:truncate@2`` and
    ``serving.delta_apply:error=injected@3``, a worker's churn at tick 5
    and the master rebuilt from its journal at tick 17.  Gates: the
    watermark across the rebuild, the redo debt exactly the churned
    ranges (the master's in-flight ranges re-cut and trained once), no
    dropped request, the quarantine and the rollback journaled, the
    freshness SLO (1.5 s) breached then clear, the served logits equal
    to a reload of the compacted chain (rtol 1e-5), K3 twice a step and
    K2 twice a step plus twice a dispatch.
37. The sparse optimizer's xla engines: for sgd, momentum, adagrad and
    adam, 3 DeepFM steps at phase 6's widths with ``sparse_kernel="xla"``
    in stream and in scatter mode beside K3; each engine replays K3's
    ids and grads from the same start (deterministic algorithms) within
    rtol 1e-6 / atol 5e-7 of K3 (sgd 1e-6 / 1e-6), ``apply_acc`` equal to
    ``apply``; each engine's step ms beside K3's.

The observability planes (``obs/{tracing,trace,history,slo,report,top}.py``,
``master/tensorboard_service.py``, ``common/profiler.py``):

38. Phase 27's job (ETRF, vocab 1M per field split, batch 8192,
    evaluation every 32 versions) with ``--tensorboard_log_dir``,
    ``--profile_steps=9,17`` (tasks 3 and 4: two whole train windows),
    ``--slo_goodput_target=0.5`` and ``--metrics_port=0``, a checkpoint
    every 24 steps, and worker 0 SIGKILLed after the first as in phase 26.
    Gates: (a) the merged master and worker journals assemble
    (``obs.trace``) with no span outside its parent, each done task's
    ``task.lifetime`` root has worker-side children, the CLI and
    ``--selftest`` pass; (b) ``obs.report --json``: a goodput ratio in
    (0, 1], one rescale with a cost, the phases summing to the wall within
    LEDGER_RTOL; (c) the event file (every record's CRC checked) holds one
    ``eval/*`` set per finalized round at its model version and the
    ``train/*`` scalars; (d) the ``torch.profiler`` Chrome trace of the
    window holds CUDA kernels named ``lookup_kernel`` (K2) and
    ``dedup_apply_kernel`` (K3), 2 each a traced step; (e) while the job
    runs the master's ``/slo`` lists the goodput SLO with its burn rates
    and ``obs.top --once`` shows a row for each live worker.  Printed:
    steady samples/s beside phase 27's, the report, the kernels' device
    ms inside the job.
39. The replica process at phase 25's configuration (phase 25's
    artifact when it ran) with ``--trace_head_every=8``,
    ``--slo_availability_target=0.99`` and ``--slo_p99_ms`` at 4x phase
    25's p99, under 8 closed-loop clients whose 8-row requests carry
    trace ids.  Gates: every request answered; the sampled requests
    journaled with the generation, each assembling to ``rpc.predict`` ->
    ``serve.queue`` / ``serve.batch`` -> ``serve.execute`` /
    ``serve.respond`` with the batch span carrying the generation, at
    least one in 8 traced requests; ``/slo`` lists both SLOs;
    ``obs.top --serving --once`` renders the replica's row; 2 K2 a
    dispatch.  Printed: requests/s and p99 beside phase 25's.

The model-quality plane (``obs/quality.py``, the ``labels`` request,
``bench/loadgen.py``) and the lock checker (``analysis/runtime.py``):

40. JAX's poisoned-delta canary scenario (``tests/test_quality.py``) in
    process under ``ELASTICDL_LOCKCHECK=1``, at phase 20's configuration
    (the trainer of phases 24 and 36 when they ran, after them, else a
    fresh one): the trainer
    learns the served layout's click labels and publishes; two
    ServingReplicas, each with a QualityLedger (a join window of 8
    virtual seconds), a CanaryGate and a DeltaWatcher, serve 16-row
    requests whose labels join two ticks late.  A clean link; a retrain
    on labels flipped by ``stream.labels:error``; a recovery retrain
    compacted past the held link and a healthy link.  Gates: every
    execute answers; the gate outcomes passed, held on every poll (2
    each), passed; the generation unmoved and the same bits served while
    held; the windows' AUC/logloss equal ``binary_auc``/
    ``binary_logloss`` of ``pairs()``; K2 twice per replay batch and
    generation in each held poll; ``lockcheck.assert_clean()``.
    Printed: the lock count and longest hold, the shadow evaluations'
    seconds, the drift sketch's edges.
41. ``replica_main`` on the card from phase 40's compacted full, tracking
    its pub dir, with ``--quality_join_window_s=8``,
    ``--quality_slo_logloss`` between the model's clean and flipped
    logloss on the request pool and ``--trace_head_every=8``, under 8
    closed-loop clients of 8-row traced requests and a label feed
    (``bench/loadgen.run_label_feed``) about 2 s behind.  The parent
    publishes a clean link, flips the feed until ``/slo`` shows
    ``model_quality`` burning, heals it, then publishes a link retrained
    on flipped labels.  Gates: every request answered; the feed's joins
    equal the replica's joined counter; a ``quality_window``'s logloss
    equal to the one recomputed from the responses and labels of the
    sampled ids within 1e-6; the clean link passed, the poisoned one held
    on 2 polls or more with the step unmoved; ``model_quality`` at 0 in
    its short window before the flip and burning after; ``obs.report``'s
    quality section; ``obs.top --serving --once``; K2 twice a dispatch
    and twice per replay batch and generation of each shadow evaluation
    (``/stats``).  Printed: requests/s, p99, the joined share and the
    gate's shadow-evaluation seconds beside phase 39's.

The static analyzer (``analysis/``) against what the card sees:

42. ``python -m elasticdl_tpu_torch.analysis elasticdl_tpu_torch
    --format json`` in a subprocess: exit 0, every .py file of the port
    and all 15 rules scanned, zero findings; the per-rule findings and
    suppressions and the scan's seconds printed.  Then, under
    ``torch.cuda.set_sync_debug_mode("warn")`` with every warning kept,
    a census of the synchronising calls: a positive control first (a
    ``# hot-path`` function of this script reading a CUDA tensor with
    ``.item()``, which the census and ``jit-host-sync`` must both see),
    then 3 strict DeepFM steps at phase 6's configuration (K1, K3), 3
    merged-layout dispatches of 64 rows at phase 3's configuration (K1)
    and 2 LM steps at ``LM_BENCH`` (K4-K6), each after one step outside
    the census; a training step is ``stage_batch`` then
    ``train_step_staged``, as the worker's loop runs it.  Each sync's innermost frame in the port is mapped to its
    enclosing function with the analyzer's function index; printed per
    path: syncs per step and each site, inside a hot function or
    outside.  Gate: every sync inside a function the analyzer marks hot
    is a ``jit-host-sync`` finding or carries its ``noqa-invariant``.

The fleet under the policy engine and a user's own model zoo:

43. ``start_serving_fleet(2, ..., policy=ElasticPolicyEngine(...))``
    serves phase 31's export (phase 32's census model at full width) on
    the card, ``--slo_p99_ms`` POLICY_SLO_P99_MS over a compliance window
    of POLICY_COMPLIANCE_S, ticked every POLICY_TICK_S; the interpreter
    of ``replica_argv_fn(python=...)`` arms a ``serving.execute`` latency
    fault (POLICY_FAULT_COUNT dispatches of POLICY_STALL_S) through
    ``ELASTICDL_FAULTS`` in replica 0 only.  4 closed-loop clients a
    replica send 8-row raw census requests from POLICY_WARM_S after the
    replica's start.  Gates (JAX's ``tests/test_slo.py:733-813``): replica
    0's ``serving_latency`` pages within the bound the windows give
    (printed), then clears after the fault, within its bound; replica 1
    fires nothing; the engine journals one ``slo_alert`` hold
    (``slo_advisory`` ``["serving_latency"]``, origin ``replica_0``) and
    then ``slo_alert_cleared``, only holds, no ``worker_churn`` or
    ``scale``, the replicas still 0 and 1; every answer of both replicas
    within LOGIT_RTOL/LOGIT_ATOL of ``eval_step``; the shared journal valid
    under ``analysis/journal_schema.py``, no forbidden module; the
    engine's thread stopped with the fleet; 2 K2 a dispatch in each
    replica (``/stats``).  Printed: the seconds from the first delayed
    dispatch to the page, to the engine's decision and to the clear;
    requests/s and p50/p99 per replica before, during and after the
    fault.
44. ``elasticdl zoo init`` into a work directory; ``load_model_spec``
    with ``--model_zoo <dir> --model_def my_model`` loads the scaffold
    (input width USER_ZOO_INPUT); the Local ``Trainer`` takes 3 steps on
    the card on seeded numpy batches of USER_ZOO_BATCH (the loss finite,
    every parameter moved); ``export_model(model_zoo=<dir>)`` is served
    by ``replica_main --model_zoo <dir>`` in a fresh process within
    LOGIT_RTOL/LOGIT_ATOL of ``eval_step``, its journal listing no
    forbidden module; ``zoo build --dockerfile-only`` renders a context
    holding ``elasticdl_tpu_torch/ops/csrc/flash_attention.cu`` and no
    ``elasticdl_tpu/``, ``_build/``, ``__pycache__`` or ``*.so``.  The
    scaffold is an MLP: no kernel launches, here or in the replica.

Tensor parallelism, FSDP, the xla engine over the whole mesh and the
host optimizer kernels:

45. The LM at phase 11's widths (bf16 blocks, f32 head, batch 16) with
    ``model_axis_mode="tp"`` over an in-process (data=1, model=4) mesh of
    the card: each slot's 2 heads through K4-K6 on ``[16, 2048, 2, 64]``,
    its columns of ``Dense_0`` and rows of ``Dense_1``; 2 warm-up and 5
    timed steps (tokens/s, median step, K4-K6's launches and in-step
    times from CUDA events, peak memory), the loss falls; then, from one
    state, 3 steps against phase 11's one-card trainer with f32 blocks at
    phase 12's tolerances, and with bf16 blocks at CP_BF16_TOL, kernels
    on both sides and, as the witness, the plain versions on both.
46. The same LM with ``dense_sharding="fsdp"`` over an in-process
    (data=4, model=1) mesh: the sharded leaves and their AdamW slots held
    as 4 blocks of 1/4, the gathered copies released between steps; 3
    steps from one state against the replicated trainer, losses,
    parameters and slots equal bit for bit.  Then, in a subprocess
    (``--fsdp_world_child``), the FSDP trainer on a world-of-one NCCL
    group (``tcp://localhost``), 3 steps, and ``CollectiveCommunicator``'s
    ``allreduce`` (MEAN and SUM: ``SUCCEEDED``, the value returned) and
    ``barrier``.
47. Phase 19's DeepFM widths and batch (26M rows, batch 8192) in the
    split layout (its lookups are K2) with ``sparse_kernel="xla"`` and
    sparse Adam over an in-process (2, 2) mesh: the dim-8 table and its
    slots placed over the whole ``(data, model)`` mesh, the dim-1 table
    replicated (the trainer's ``table_placement`` and the journal's
    ``sparse_kernel_selected``); K2 on the 4 intervals bit for bit
    against the one-card K2 and its plain route (edge ids included),
    timed beside both; 2 warm-up and 5 timed steps (K2 5 times a step,
    no K1 or K3); 3 steps against phase 37's one-card xla engine from one
    state at phase 37's tolerances (the sparse applies under PyTorch's
    deterministic algorithms on both sides).
48. The host optimizer kernels (``native/kernel_api.cc``) built with
    ``g++`` on this machine: dense and sparse sgd, momentum, adagrad and
    adam, 3 steps each against their numpy twins at NATIVE_TOL (adam's
    step counts exact), each call's host time.
49. K4-K6 at head_dim 256, their DP=256 builds: each against its plain
    version at [8, 2048, 8, 256] bf16 causal (timed: 30 launches with L2
    flushed, TFLOP/s, the plain version, the bound and SDPA's forward and
    backward as the yardstick), [2, 2048, 4, 136] bf16 and [2, 512, 4,
    256] f32 at phase 10's tolerances, and head_dim 100 through the
    wrappers' pad to 104.  Then the transformer LM at Gemma 2B's attention
    geometry (d_model 2048, 8 heads of 256) on TRANSFORMER_BENCH's depth,
    vocab and T, batch 8, trained by ``DataParallelTrainer``: 2 warm-up
    and 5 timed steps at AdamW 7.5e-4 (phase 11's 3e-3 scaled by the
    width ratio; step ms, tokens/s, peak memory, a falling loss, K4-K6's
    in-step ms), and phase 12's gate at batch 2.
50. K7-K9 at head_dim 256, their DP=256 builds: against their plain
    versions at the CP LM's slot shape [2, 2048, 8, 256] bf16, every step
    of a ring of 4 in both layouts (K8 and K9 on an f32 and the path's
    bf16 dO), at RING_CARRY_TOL and ATTN_F32_*, and timed at the
    unmasked step beside their plain versions, bounds and the
    memory-efficient attention call (null, with the reason, where no
    backend takes the shape).  Then phase 49's LM at T=8192, batch 2,
    trained context-parallel over the in-process (1, 4) mesh in both
    layouts (2 warm-up and 5 timed steps at AdamW 7.5e-4: K7-K9 each 64
    times a step, no whole-sequence kernel, a falling loss), and from one
    state 3 CP steps against the one-card LM (K4-K6's DP=256 builds on
    the whole sequence) at batch 1 and 1 layer (CP_GATE_LAYERS), with the
    plain versions on both sides as the witness, at phase 16's bf16
    tolerances.
51. K4-K6's float16 builds: each against its plain version at [2, 512,
    4, D] for D 64, 128, 256 and 100 (through the pad), causal and full,
    with dO at unit scale and at 2**-20 (the LM's gradient scale at batch
    16 x 2048), within 2 f16 ulps plus 2**-12 of the largest magnitude
    and no gradient entry zero where the plain version's is at least two
    subnormal steps and 2**-12 of the largest magnitude from zero; timed
    at [16, 2048, 8, 64] and [8, 2048, 8, 256] causal beside the plain
    version, the bound and SDPA at float16.  Then the LM at
    TRANSFORMER_BENCH's widths computing in float16, built from a user's
    model module loaded by ``load_module``,
    trained by ``DataParallelTrainer`` at batch 16 (2 warm-up and 5
    timed steps: step ms, tokens/s, peak memory, a falling loss, K4-K6's
    launches and in-step ms), and phase 12's gate at batch 2 at
    F16_PATH_TOL, beside its witness: the two paths' gradients of the
    loss times 2**12 within phase 12's 1e-2.
52. K7-K9's float16 builds: one slot's whole ring of 4 at [2, 128, 4, D]
    for D 64, 128, 256 and 100 (through the pad), contiguous and zigzag,
    with a fully masked step and rows that see no key, K8 and K9 on an
    f16 and an f32 dO at unit scale and at 2**-20, against the plain
    versions at phase 51's f16 rule (without its subnormal floor: the
    outputs are f32) with no gradient flushed to zero and a fully masked
    step's carry kept bit for bit; then one unmasked step
    at the CP slot shapes [4, 2048, 8, 64] and [2, 2048, 8, 256] checked
    the same way and timed beside the plain versions, the bounds and the
    memory-efficient attention call at float16.  Then phase 15's CP LM
    computing in float16 (the user's module of phase 51, over the
    in-process (1, 4) mesh), trained in both layouts (2 warm-up and 5
    timed steps: K7-K9 each 64 times a step, no whole-sequence kernel, a
    falling loss), and from the trained state its kernel path against
    its plain path (the plain versions of K7-K9) at batch 1, at
    F16_PATH_TOL beside the loss-times-2**12 witness.

A line before and after each group of phases (``[phase clock]``) gives
the group's seconds and the run's total so far.

Before each of phases 21-23 the free space of its directory is checked
(a failure names the bytes needed); each deletes its directories.

Launch counts are zeroed just before each serving and training phase and
read just after it; a kernel of the path that did not launch there (K1
and K3 once per strict training step, K3 twice in the window; K2 and K3
twice per split-layout step, the resumed trainer's too, K2 twice per
dispatch after ``apply_delta`` and after each link of phase 24, in the
gate's shadow runs and in the replica process of phase 25 (its own
counts, on ``/stats``); K2 and K3 twice per step in each worker process
of phase 26 (its own counts, in its journal), and in phase 27's worker
also K2 twice per evaluation batch; K4, K5 and K6 once per layer per LM
step, the resumed LM's too; K7, K8 and K9 once per layer per ring step
of a CP LM step, and K4-K6 never there; over the mesh, K1 and K3 once
per shard; K10 in the experiment script's default mode; K2 and K3 twice
per step of each CTR zoo model and of phase 31's worker process, there
also K2 twice per evaluation batch, and K2 twice per dispatch of each
replica of phase 32; K4-K6 once per layer per step of both heads in
phase 35; in phase 36 K3 twice per step and K2 twice per step and
twice per dispatch; K3 once per step of phase 37's K3 runs and never in
its engines' runs; K2 and K3 twice per step and K2 twice per evaluation
batch in each of phase 38's workers, and twice per traced step in its
profiler's trace; K2 twice per dispatch of phase 39's replica; K2 and
K3 twice per training step of phase 40 and K2 twice per replay batch
and generation in each of its held polls; K2 twice per dispatch and
twice per replay batch and generation of each shadow evaluation in
phase 41's replica; K2 twice per dispatch of each replica of phase 43;
K4-K6 once per layer per model slot per step of phase 45 and once per
layer per step of phase 46, in process and in its world of one; K2
five times per step of phase 47 and never K1 or K3 there; K4-K6 once
per layer per step of phase 49's LM and once per checked shape; K7-K9
once per layer per ring step of phase 50's CP LM and K4-K6 never there; K4-K6 once
per layer per step of phase 51's float16 LM and once per checked shape)
fails the run.
The line before the last holds the card's name and power limit, the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, with no
result, when no CUDA device is available or the port is not beside it.
``--phases 1,10`` runs only the named phases (for a short check of one
kernel; such a run prints no result line; phase 19 reuses phase 4's
artifact when both run; phases 21 and 22 run together, and so do 24 and
25; phase 27 prints phase 26's figures beside its own when both run;
``--phases 28,29`` runs the vision phases alone; phases 32 and 43 run
phase 31 first, whose export they serve; phase 38 prints phase 27's figures and
phase 39 phase 25's beside its own when both run; phases 40 and 41 run
together, 41 serving 40's chain, and phase 41 prints phase 39's figures
beside its own when both run).
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
from unittest import mock

#: Published H100 SXM peak memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
MODEL_DEF = "deepfm.deepfm_functional_api"
NUM_CAT, NUM_DENSE = 26, 13
SOURCE = "elasticdl_tpu_torch/ops/csrc/sparse_embedding.cu"
REPLACES = {
    "fused_lookup_fm": "elasticdl_tpu/ops/sparse_embedding.py:755",
    "fused_lookup": "elasticdl_tpu/ops/sparse_embedding.py:249",
    "fused_dedup_apply": "elasticdl_tpu/ops/sparse_embedding.py:491",
}
#: Tolerance of the FM sums against the plain version: both add the
#: same F f32 terms, in another order (the kernel field by field,
#: torch.sum pairwise), so each lies within (F-1)*u*sum|terms| of the
#: exact sum (u = 2**-24) and they may differ by twice that, elementwise.
#: acts and lookups must match bit for bit.
SUM_ORDER_ULPS = 2.0 * 2.0 ** -24
#: Served logits against the plain forward: the hot-swap bar.
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
#: Phase 26: the elastic job's records (24 steps of TRAIN_BATCH), its
#: tasks (6) and its checkpoint cadence (the worker dies after step 12).
ELASTIC_RECORDS = 196_608
ELASTIC_PER_TASK = 32_768
ELASTIC_CKPT_STEPS = 12
#: Phase 27: the job on ETRF files, 2 training shards of 131,072 records
#: (32 steps of TRAIN_BATCH in tasks of ELASTIC_PER_TASK), one validation
#: shard, an evaluation round every 32 model versions.  Phase 38 runs the
#: same job and kills its worker after step 24: 8 steps stay after it.
ETRF_SHARDS = 2
ETRF_PER_SHARD = 131_072
ETRF_VALIDATION = 65_536
ETRF_EVAL_STEPS = 32
#: The final AUC against an in-process evaluation of the same model:
#: near-tied logits may order differently.
AUC_TOL = 1e-4
#: Phases 28-29: ResNet-50 at bench.py's bench_resnet50 width (224x224
#: uint8 images, batch 128, bf16, 1000 classes, stages (3, 4, 6, 3),
#: Nesterov SGD at 0.1), nothing cut.
VISION_DEF = "resnet50.resnet50_subclass"
VISION_BATCH = 128
VISION_SIZE = 224
VISION_CLASSES = 1000
VISION_LR = 0.1
#: Gate 1: the card's f32 eval forward (channels_last, cuDNN, TF32 off)
#: against the port's CPU forward on the same weights, max |diff| over the
#: largest CPU logit.
VISION_F32_RTOL = 1e-3
#: Gate 2: 3 steps of the single-device Trainer against
#: DataParallelTrainer on the card from one state, cuDNN deterministic:
#: relative L2 of the parameter updates and of the batch_stats' moves.
VISION_PATHS_RTOL = 1e-2
#: Phase 29: the job's final evaluation loss against the exported
#: model's, evaluated here on the same rows (accuracy must be equal):
#: relative difference.  With random labels the accuracy sits at chance,
#: so the loss is what tells a wrong export (batch_stats, a kernel's
#: layout) from the trained model.
VISION_LOSS_RTOL = 1e-5
#: Phase 29: the Local job on image ETRF stored at 256 (crops to 224), 2
#: training shards of 1,536 records (24 steps of 128 in tasks of 384), a
#: validation shard of 512, an evaluation round every 12 model versions.
VISION_STORE_SIZE = 256
VISION_SHARDS = 2
VISION_PER_SHARD = 1536
VISION_VALIDATION = 512
VISION_PER_TASK = 384
VISION_EVAL_STEPS = 12
#: Phases 33-34: the AllReduce jobs, a world of one, SIGKILLed after
#: the step-``ckpt`` save: (model_def, model_params, data drawn from
#: ``--seed``, records, batch, records a task, ckpt, extra flags).  The
#: data are cut, the widths not.
ALLREDUCE_JOBS = {
    33: ("cifar10.cifar10_functional_api", "", "synthetic://cifar10?n={n}&seed={seed}",
         16_384, 128, 2048, 32, ("--pipeline=async", "--parse_pool_workers=2")),
    34: (VISION_DEF, "", "synthetic://imagenet?n={n}&seed={seed}", 6144, VISION_BATCH, 768, 12,
         ("--pipeline=async", "--parse_pool_workers=4")),
}
#: The goodput ledger's phases against its wall: relative difference.
LEDGER_RTOL = 1e-6
#: Phase 30: the CTR zoo at the trainer level, (model_def, params,
#: batch, data path, the zoo's lr): both census models at batch 512 of
#: raw records (one id space of 201 and of 229 rows), W&D at its default
#: vocab (26,000 rows) and batch 4096.  K2 and K3 twice a step (the wide
#: dim-1 and the deep dim-8 table), no K1.
CTR_ZOO = (
    ("census.census_wide_deep", "", 512, "synthetic://census?n={n}&seed={seed}", 0.01),
    ("census.census_feature_columns", "", 512, "synthetic://census?n={n}&seed={seed}", 0.01),
    ("wide_and_deep.wide_and_deep", "vocab_size=1000", 4096,
     "synthetic://census?n={n}&vocab=1000&seed={seed}", 0.005),
)
CTR_ZOO_LAUNCHES = {"fused_lookup": 2, "fused_dedup_apply": 2, "fused_lookup_fm": 0}
CTR_ZOO_STEPS = 20
#: Phases 31-32: census Wide&Deep as a PS job (BASELINE.json config 3):
#: 32,768 raw records (the UCI Adult training set has 32,561), 2 epochs
#: of batch 512 (128 steps) in tasks of 4,096, 8,192 validation records
#: evaluated every 32 versions; the fleet's gen2 is the job's state after
#: 4 more steps, and each load window of the fleet lasts FLEET_WINDOW_S.
CENSUS_DEF = "census.census_wide_deep"
CENSUS_RECORDS = 32_768
CENSUS_VALIDATION = 8192
CENSUS_BATCH = 512
CENSUS_PER_TASK = 4096
CENSUS_EPOCHS = 2
CENSUS_EVAL_STEPS = 32
CENSUS_GEN2_STEPS = 4
FLEET_WINDOW_S = 3.0
#: The training slice: the north-star table, bench.py's batch.
TRAIN_PARAMS = "vocab_size=1000000,embedding_dim=8,hidden=128,split_tables=false"
TRAIN_BATCH = 8192
#: Launches per strict step on that path (phase 6).
TRAIN_LAUNCHES = {"fused_lookup_fm": 1, "fused_dedup_apply": 1}
#: K10 and its experiment script (phase 17): the script's defaults.
K10_SOURCE = "elasticdl_tpu_torch/ops/csrc/sparse_gather.cu"
K10_REPLACES = "scripts/exp_sparse_gather.py:154"
GATHER_IDS, GATHER_VOCAB = 212_992, 26_000_000
#: The in-process mesh of phases 18-19, (data, model), and phase 4's
#: split-layout vocabulary per field.
SHARD_MESH = (1, 4)
SPLIT_VOCAB = 100_000
LR = 1e-3
#: K2 (phase 2) at the shapes of its paths: (label, table rows, dim, ids).
#: The merged dim-9 table at 65,536 ids is the row every PR has timed
#: (ids past both ends of the table among them); a bucket-64 serving
#: batch x 26 fields on the split layout's two tables at phase 4's
#: vocabulary; a training batch (8192 x 26) on the table-scale split
#: tables of phase 20.
K2_SHAPES = (
    ("[65536] dim 9", 1_000_000 * NUM_CAT, 9, 65_536),
    ("[1664] dim 1", SPLIT_VOCAB * NUM_CAT, 1, 64 * NUM_CAT),
    ("[1664] dim 8", SPLIT_VOCAB * NUM_CAT, 8, 64 * NUM_CAT),
    ("[212992] dim 1", 1_000_000 * NUM_CAT, 1, TRAIN_BATCH * NUM_CAT),
    ("[212992] dim 8", 1_000_000 * NUM_CAT, 8, TRAIN_BATCH * NUM_CAT),
)
#: K2's edges (phase 2), each bit-exact with the plain version on a
#: small table: every dim class (a dim of 1, 2, 3, 6, 8, 9, 16, 40; 128
#: and 130, rows of dim_padded 128 and 256), n of 0, 1 and one that ends
#: in a ragged tile, ids negative, past the table and near +-2**31.
K2_EDGE_DIMS = (1, 2, 3, 6, 8, 9, 16, 40, 128, 130)
K2_EDGE_NS = (0, 1, 4099)
#: The sharded K2 call over SHARD_MESH (phase 18): one K2 launch per model
#: shard and the combine's adds, nothing else on the device.
SHARDED_K2_DEVICE_LAUNCHES = 2 * SHARD_MESH[1] - 1
#: Phase 20: bench.py's bench_deepfm_table_scale_strict, whose 26M rows
#: DeepFM's layout rule puts in the split layout (two tables, dims 1 and
#: 8), strict apply, global-bias sparse Adam; 20 timed steps after 3.
SPLIT_TRAIN_PARAMS = "vocab_size=1000000,embedding_dim=8,hidden=128,split_tables=true"
SPLIT_TRAIN_LAUNCHES = {"fused_lookup": 2, "fused_lookup_fm": 0, "fused_dedup_apply": 2}
#: Kernel path against plain path over 3 training steps.  The losses
#: differ only through the FM sums' order (kernel field by field,
#: torch.sum pairwise) and K3's gradient sums (plain index_add_ adds with
#: atomics on the card): rtol 1e-5.  The tables: Adam's step
#: lr*m/(sqrt(v)+eps) is sign-like near g = 0, so an element whose summed
#: gradient is within rounding of zero may move by up to 2*lr per step on
#: one path only.  A row drawn twice in a batch whose grads partly cancel
#: has such a sum, and the two paths add its grads in other orders; the
#: first run on the card put 0.106% of the moved elements past 1e-6 (max
#: 8.1e-4).  Every element is held to 2*lr*3 and all but 1% of the moved
#: ones to 1e-6.
PATH_LOSS_RTOL, PATH_TABLE_ATOL, PATH_LOOSE_SHARE = 1e-5, 1e-6, 1e-2
#: Published H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
BF16_FLOPS_PER_S = 989e12
LM_DEF = "transformer.transformer_lm"
#: bench.py's TRANSFORMER_BENCH and bench_transformer's batch.
LM_BENCH = dict(vocab=32768, d_model=512, num_heads=8, num_layers=4, seq_len=2048,
                mlp_ratio=4)
LM_BATCH = 16
LM_LR = 3e-3
#: Phase 11's timed steps.
LM_STEPS = 10
#: Phase 35's timed steps with each head.
HEAD_STEPS = 10
FLASH_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_attention.cu"
#: The f16 builds of K4-K6: flash_mma.cuh's templates, instantiated here.
FLASH_F16_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_attention_f16.cu"
FLASH_REPLACES = {
    "flash_attention_fwd": "elasticdl_tpu/ops/flash_attention.py:54",
    "flash_attention_dq": "elasticdl_tpu/ops/flash_attention.py:129",
    "flash_attention_dkv": "elasticdl_tpu/ops/flash_attention.py:179",
}
#: Attention shapes of phase 10: (B, T, H, D, causal).  The first is the
#: LM's (bench shape), timed first.
ATTN_SHAPES = ((16, 2048, 8, 64, True), (16, 2048, 8, 64, False), (2, 8192, 8, 64, True))
#: Kernel against plain version, bf16 outputs.  Both compute the same f32
#: values in another summation order (FMA loops against cuBLAS f32
#: GEMMs), so an f32 value may land on the other side of a bf16 rounding:
#: out, dq, dk, dv within 2 bf16 ulps of the plain value (rtol 2**-7)
#: plus ATTN_ATOL_SHARE of the tensor's largest magnitude (the backward
#: sums terms of both signs, whose f32 rounding is relative to the terms,
#: not to the sum).  lse is f32: the scores' f32 sums over D=64 in
#: another order, a few ulps of |s| <= ~10.
ATTN_RTOL, ATTN_ATOL_SHARE, LSE_ATOL = 2.0 ** -7, 2.0 ** -10, 1e-4
#: Checked for correctness only, not timed: the kernels' other builds and
#: edges.  (B, T, H, D, dtype, causal): f32 inputs, head_dim 8/16/32/128
#: (the D=128 build), T not a multiple of the 64-row tile, T=1.  Each is
#: also run on the q/k/v slices of one fused [B, T, 3, H, D] projection.
ATTN_EDGE_SHAPES = (
    (2, 1000, 4, 128, "bfloat16", True), (2, 333, 2, 32, "float32", False),
    (3, 200, 2, 64, "float32", True), (1, 1, 1, 8, "bfloat16", True),
    (2, 65, 3, 16, "bfloat16", False), (1, 130, 2, 128, "float32", True),
)
#: f32 kernel against f32 plain version: the same f32 values in another
#: summation order, so a few f32 ulps of the sums' terms: rtol 1e-5 plus
#: 1e-5 of the tensor's largest magnitude.
ATTN_F32_RTOL, ATTN_F32_ATOL_SHARE = 1e-5, 1e-5
#: LM kernel path against plain path (bf16 model).  The paths differ
#: where phase 10's do (an f32 value on the other side of a bf16
#: rounding), and the bf16 network carries that on.  From one state and
#: over 3 AdamW steps: losses within rtol 1e-4; each parameter's
#: gradient within a relative L2 error of 1e-2.  After the 3 steps, Adam
#: has divided each element's gradient by its own magnitude, so an
#: element whose gradient is mostly rounding noise moves by ~lr in either
#: direction on either path (on an H100 8.5% of the elements end more
#: than 1e-5 apart, none more than 2.4*lr): every element is held
#: to 2*lr*3*1.5 (a sign flip in every step, Adam's ratio above 1), and
#: the two paths' updates (final minus start) to a relative L2
#: difference of 2e-2.  Measured on an H100: 2.4e-5, 3.2e-3, 4.4e-3.
LM_PATH_LOSS_RTOL = 1e-4
LM_PATH_GRAD_RTOL = 1e-2
LM_PATH_PARAM_MAX = 2 * LM_LR * 3 * 1.5
LM_PATH_UPDATE_RTOL = 2e-2
RING_SOURCE = "elasticdl_tpu_torch/ops/csrc/ring_attention.cu"
RING_REPLACES = {
    "flash_ring_step_carry": "elasticdl_tpu/ops/flash_attention.py:344",
    "flash_ring_step_dq": "elasticdl_tpu/ops/flash_attention.py:482",
    "flash_ring_step_dkv": "elasticdl_tpu/ops/flash_attention.py:526",
}
#: bench.py's RING_BENCH: one ring step's shape (B, T_local, H, D) and
#: the ring's N steps; bf16.
RING_BENCH = dict(batch=4, t_local=2048, heads=8, head_dim=128, steps=4)
#: K7's carry against its plain version, bf16 inputs.  The carry is f32,
#: but both round P to bf16 before P V, and an exp an f32 ulp apart can
#: round a p to the other bf16 neighbour, which moves that term by 2**-8
#: of itself: phase 10's bf16 tolerance, 2 bf16 ulps (rtol 2**-7) plus
#: 2**-10 of the largest magnitude.  lse within LSE_ATOL; K8 and K9 (all
#: f32 arithmetic, summed in another order) and every f32-input output
#: within ATTN_F32_*.
RING_CARRY_TOL = (ATTN_RTOL, ATTN_ATOL_SHARE)
#: Checked for correctness only: (B, Tq, Tk, H, D, dtype, causal) with
#: random positions: Tq != Tk, ragged tiles, f32, head_dim 8-256 (136 and
#: 256 the DP=256 builds, bf16 with an f32 and a bf16 dO and f32; 100
#: padded to 104 by the wrappers).
RING_EDGE_SHAPES = (
    (2, 200, 333, 2, 32, "float32", True), (1, 130, 64, 3, 8, "bfloat16", True),
    (2, 96, 160, 2, 128, "float32", False), (1, 64, 64, 1, 64, "bfloat16", True),
    (1, 130, 200, 2, 136, "bfloat16", True), (1, 200, 130, 2, 256, "bfloat16", True),
    (1, 96, 160, 2, 136, "float32", True), (1, 130, 96, 2, 256, "float32", False),
    (1, 130, 200, 2, 100, "bfloat16", True),
)
#: A final lse at or below half of NEG_INF: a row that saw no key.
UNSEEN_LSE = -0.5e30
#: Phase 14: an in-process ring of RING_SLOTS slots against K4-K6 on the
#: whole sequence, (B, T, H, D) bf16 causal, at phase 10's tolerances.
RING_WHOLE_SHAPE = (2, 8192, 8, 64)
RING_SLOTS = 4
#: Phases 15-16: the context-parallel LM, TRANSFORMER_BENCH's widths at
#: T=8192 (max_len 8192), batch 4 (the bench's 32,768 tokens per step),
#: on an in-process (data, model) mesh of the card: T_local = 2048 =
#: RING_BENCH's t_local.
CP_LM = dict(LM_BENCH, seq_len=8192)
CP_BATCH = 4
CP_MESH = (1, 4)
CP_WARMUP, CP_STEPS, CP_BATCHES = 2, 5, 4
#: One slot's ring step on the CP LM's path (B, T_local, H, D): phase 13
#: holds K7-K9 to their plain versions there too (the head_dim-64 build),
#: in bf16 (phase 15) and in f32 (phase 16's f32 models).
CP_SLOT_SHAPE = (CP_BATCH, CP_LM["seq_len"] // CP_MESH[1], CP_LM["num_heads"],
                 CP_LM["d_model"] // CP_LM["num_heads"])
#: Phase 16 in bf16: CP against the one-card path, kernels on both sides
#: and, as the witness of the cause, the plain versions on both sides
#: (plain ring against plain whole sequence).  The two paths round each P
#: to bf16 against another running max (a ring step's, the whole row's),
#: an independent rounding per element that phase 12's two paths do not
#: have, and AdamW's per-element step turns the rounding noise of small
#: gradients into whole steps.  On an H100 (700 W) both pairs read, over
#: both layouts: losses within 2.1e-5, gradients 8.4e-3 (relative L2),
#: every parameter within 0.016, updates 5.2e-2 (relative L2), the plain
#: pair within 3% of the kernel pair.  Held to (losses, gradients, every
#: parameter, updates): phase 12's loss and parameter limits, and twice
#: the largest reading, rounded up, for gradients and updates.
CP_BF16_TOL = (LM_PATH_LOSS_RTOL, 2e-2, LM_PATH_PARAM_MAX, 1.1e-1)
#: Phase 16 compares the two paths on the first CP_GATE_BATCH rows of the
#: training batches (the readings above were taken at all 4; the plain
#: witness at T=8192 costs ~13 s a layout at 4), as phase 50 does at
#: head_dim 256.
CP_GATE_BATCH = 1
#: The CP gates of phases 16 and 50 run their LM at this depth (the
#: trained LM has 4 layers): every ring step, one-card kernel and plain
#: version still runs on the layer's every slot and shows in a compared
#: gradient, and the plain witnesses, most of those phases' seconds,
#: take a quarter as long.
CP_GATE_LAYERS = 1
K3_HYPER = {
    "sgd": ("sgd", {"learning_rate": 0.01}),
    "momentum": ("momentum", {"learning_rate": 0.01, "momentum": 0.9, "nesterov": False}),
    "nesterov": ("momentum", {"learning_rate": 0.01, "momentum": 0.9, "nesterov": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.01, "epsilon": 1e-7}),
    "adam": ("adam", {"learning_rate": LR, "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-8}),
    "adam_global": ("adam_global", {"learning_rate": LR, "beta_1": 0.9, "beta_2": 0.999,
                                    "epsilon": 1e-8}),
}


def log(msg: str) -> None:
    print(msg, flush=True)


#: When the script started: the run's total in the phase clock's lines.
RUN_START = time.perf_counter()


@contextlib.contextmanager
def phase_clock(*numbers):
    """A line before a group of phases and one after it (also when it
    fails): the phase numbers, the seconds the group took and the run's
    total so far.  A run that hits its time limit shows where it
    stopped."""
    label = ",".join(str(n) for n in numbers)
    log(f"[phase clock] phases {label}: start at {time.perf_counter() - RUN_START:.1f} s")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log(f"[phase clock] phases {label}: {time.perf_counter() - t0:.1f} s, run total "
            f"{time.perf_counter() - RUN_START:.1f} s")


def timed_phase(numbers, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside ``phase_clock(*numbers)``."""
    with phase_clock(*numbers):
        return fn(*args, **kwargs)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_device():
    """The card every phase computes on."""
    import torch

    return torch.device("cuda", 0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def import_port():
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import elasticdl_tpu_torch
    except ImportError as exc:
        fail(f"elasticdl_tpu_torch is not importable beside {here}: {exc}")
    pkg = os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__))
    if os.path.dirname(pkg) != here:
        fail(f"elasticdl_tpu_torch comes from {pkg}, not from this checkout")


# ----------------------------------------------------------------------
# phase 1: what the attention kernels were compiled to
# ----------------------------------------------------------------------

#: The bf16 and f16 builds of K4-K9 run on the tensor cores (mma.sync):
#: their SASS must hold HMMA (or wgmma's HGMMA).  Each has a DP=256
#: build, K6's and K9's with a pair of warps for each 16 key rows.  K8
#: and K9 are built for each count of dO parts: 1 (a dO of q's type, the
#: CP path's) and 3 (an f32 dO split three ways, kF32DoParts).
TENSOR_CORE_BUILDS = tuple(
    [f"{name}<bf16, {dp}>" for name in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                                         "flash_dkv_mma_kernel", "ring_fwd_mma_kernel")
     for dp in (64, 128)]
    + [f"{name}<bf16, 256>" for name in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                                         "flash_dkv_mma_pair_kernel", "ring_fwd_mma_kernel")]
    + [f"{name}<bf16, {dp}, {parts}>" for name in ("ring_dq_mma_kernel", "ring_dkv_mma_kernel")
       for dp in (64, 128) for parts in (1, 3)]
    + [f"{name}<bf16, 256, {parts}>" for name in ("ring_dq_mma_kernel",
                                                  "ring_dkv_mma_pair_kernel")
       for parts in (1, 3)]
    + [f"{name}<f16, {dp}>" for name in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                                        "flash_dkv_mma_kernel") for dp in (64, 128)]
    + [f"{name}<f16, 256>" for name in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                                       "flash_dkv_mma_pair_kernel")]
    + [f"ring_fwd_mma_kernel<f16, {dp}>" for dp in (64, 128, 256)]
    + [f"{name}<f16, {dp}, {parts}>" for name in ("ring_dq_mma_kernel", "ring_dkv_mma_kernel")
       for dp in (64, 128) for parts in (1, 3)]
    + [f"{name}<f16, 256, {parts}>" for name in ("ring_dq_mma_kernel",
                                                 "ring_dkv_mma_pair_kernel")
       for parts in (1, 3)])
_KERNEL_LABEL = re.compile(
    r"((?:flash|ring)_[a-z_]*kernel)I(13__nv_bfloat16|6__half|f)?Li(\d+)E(?:Li(\d+)E)?")
_LABEL_DTYPE = {"f": "f32", "6__half": "f16"}


def kernel_label(mangled: str):
    """``name<dtype, DP>`` (``name<dtype, DP, dO parts>`` for the
    tensor-core K8 and K9) of an attention kernel's mangled name, or
    None."""
    m = _KERNEL_LABEL.search(mangled)
    if m is None:
        return None
    dtype = _LABEL_DTYPE.get(m.group(2), "bf16")
    parts = f", {m.group(4)}" if m.group(4) else ""
    return f"{m.group(1)}<{dtype}, {m.group(3)}{parts}>"


def cuobjdump_path():
    from elasticdl_tpu_torch.ops import _build

    candidate = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return candidate if os.path.exists(candidate) else shutil.which("cuobjdump")


def parse_ptxas_spills(log_text: str):
    """{mangled name: (spill store bytes, spill load bytes)} from
    ``-Xptxas=-v`` output."""
    spills, current = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills[current] = (int(m.group(1)), int(m.group(2)))
            current = None
    return spills


def parse_resource_usage(text: str):
    """{mangled name: {REG, STACK, SHARED, LOCAL}} from ``cuobjdump
    --dump-resource-usage``."""
    usage, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            current = m.group(1)
            continue
        if current and "REG:" in line:
            usage[current] = {key: int(val) for key, val in
                              re.findall(r"\b(REG|STACK|SHARED|LOCAL):(\d+)", line)}
            current = None
    return usage


def parse_sass_mma(text: str):
    """{mangled name: (HMMA count, HGMMA count)} from ``cuobjdump -sass``."""
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = [0, 0]
            continue
        if current:
            counts[current][0] += len(re.findall(r"\bHMMA\.", line))
            counts[current][1] += len(re.findall(r"\bHGMMA\.", line))
    return {name: tuple(c) for name, c in counts.items()}


def start_resource_dumps(lib_path: str):
    """cuobjdump's resource usage and SASS of the built library, started
    now on threads (they take seconds of host time, which the phases
    after the build overlap): the library's cubins (one a source) are
    extracted first and each is dumped by processes of its own, so the
    sources' dumps run side by side.  -> (resource-usage futures, SASS
    futures); None where cuobjdump is missing."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    cubins = tempfile.mkdtemp(prefix="chip_smoke_cubins_")
    atexit.register(shutil.rmtree, cubins, True)
    subprocess.run([tool, "-xelf", "all", lib_path], cwd=cubins, check=True,
                   capture_output=True, timeout=300)
    paths = sorted(glob.glob(os.path.join(cubins, "*.cubin")))
    if not paths:
        fail(f"cuobjdump extracted no cubin from {lib_path}")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2 * len(paths))
    dumps = tuple([pool.submit(subprocess.run, [tool, flag, path], check=True,
                               capture_output=True, text=True, timeout=300)
                   for path in paths]
                  for flag in ("--dump-resource-usage", "-sass"))
    pool.shutdown(wait=False)
    return dumps


def attention_resources(dumps, build_log: str):
    """Registers, shared memory, spills and tensor-core instructions of
    every attention kernel in the built library, by label, from
    ``start_resource_dumps``; None, with a line that says so, where
    cuobjdump is missing.  Fails if a bf16 or f16 K4-K9 build holds no
    HMMA/HGMMA."""
    if dumps is None:
        log("  attention kernels' resources: cuobjdump not found (neither beside nvcc "
            "nor on PATH): registers and SASS not read")
        return None
    usage, sass = ({k: v for dump in futures for k, v in parse(dump.result().stdout).items()}
                   for futures, parse in zip(dumps, (parse_resource_usage, parse_sass_mma)))
    spills = parse_ptxas_spills(build_log)
    found = {}
    for mangled, use in sorted(usage.items()):
        label = kernel_label(mangled)
        if label is None:
            continue
        hmma, hgmma = sass.get(mangled, (0, 0))
        spill = spills.get(mangled, (None, None))
        found[label] = {"registers": use.get("REG"), "static_shared_bytes": use.get("SHARED"),
                        "stack_bytes": use.get("STACK"), "local_bytes": use.get("LOCAL"),
                        "spill_store_bytes": spill[0], "spill_load_bytes": spill[1],
                        "hmma": hmma, "hgmma": hgmma}
        log(f"  {label}: {use.get('REG')} registers, spill stores/loads {spill[0]}/{spill[1]} "
            f"bytes, stack {use.get('STACK')} B, local {use.get('LOCAL')} B, static shared "
            f"{use.get('SHARED')} B, SASS HMMA {hmma} HGMMA {hgmma}")
    for label in TENSOR_CORE_BUILDS:
        r = found.get(label)
        if r is None or r["hmma"] + r["hgmma"] == 0:
            fail(f"{label} is missing from the library or holds no HMMA/HGMMA")
    found.update(sparse_resources(usage, spills))
    return found


_SPARSE_LABEL = re.compile(
    r"(?<![0-9])\d+(lookup_fm_kernel|dedup_apply_kernel|lookup_kernel|block_gather_kernel)"
    r"(?:ILi(\d+)E)?")


def sparse_resources(usage, spills):
    """Registers, spills and local memory of the sparse kernels (K1-K3,
    K10), by name (K2's builds as ``lookup_kernel<V>``, V floats a unit)."""
    found = {}
    for mangled, use in sorted(usage.items()):
        m = _SPARSE_LABEL.search(mangled)
        if m is None:
            continue
        label = m.group(1) if m.group(2) is None else f"{m.group(1)}<{m.group(2)}>"
        spill = spills.get(mangled, (None, None))
        found[label] = {"registers": use.get("REG"), "static_shared_bytes": use.get("SHARED"),
                        "stack_bytes": use.get("STACK"), "local_bytes": use.get("LOCAL"),
                        "spill_store_bytes": spill[0], "spill_load_bytes": spill[1]}
        log(f"  {label}: {use.get('REG')} registers, spill stores/loads {spill[0]}/{spill[1]} "
            f"bytes, stack {use.get('STACK')} B, local {use.get('LOCAL')} B, static shared "
            f"{use.get('SHARED')} B")
    return found


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------


#: Launches a plain version's median is taken over (and its warm-up):
#: the plain versions repeat the kernels' arithmetic in PyTorch and are
#: no yardstick of speed, and at 15-65 ms a call 30 of them cost phase 10
#: alone ~9 s of the run.
PLAIN_REPS, PLAIN_WARMUP = 5, 1


def median_ms(fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events), with the
    L2 cache flushed (``flush`` written) before each timed call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def host_ms(fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median host time of one call of ``fn``, from a synchronize before
    it to a synchronize after it (L2 flushed before each)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def profile_launches(fn, calls: int = 5):
    """The device records of ``calls`` calls of ``fn`` from
    ``torch.profiler`` (no flush between calls): per call, each kernel's
    (or copy's) device time in ms and launches, and their sums; None
    where the trace holds no device record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    records = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        r = records.setdefault(evt.name[:120], {"ms": 0.0, "launches": 0})
        r["ms"] += evt.time_range.elapsed_us() / 1e3 / calls
        r["launches"] += 1
    if not records:
        return None
    for r in records.values():
        r["launches"] /= calls
    return {"by_kernel": records, "device_ms": sum(r["ms"] for r in records.values()),
            "launches": sum(r["launches"] for r in records.values())}


def gather_ms(table, rows, flush) -> float:
    """PyTorch's own row gather of the same (precomputed) rows: not the
    kernel's function (no clamp rule, no lane cut, no FM sums), so not a
    library_ms, but a yardstick of the gather that both kernels do."""
    return median_ms(lambda: table.index_select(0, rows), flush)


def lookup_bytes(n: int, dim: int) -> int:
    # ids read, the rows' dim lanes read, [n, dim] written.
    return n * 4 + 2 * n * dim * 4


def lookup_fm_bytes(batch: int, fields: int, dim: int, with_bet: bool) -> int:
    ids_valid = batch * fields * (4 + 1)
    rows_in = batch * fields * dim * 4
    bet = rows_in if with_bet else 0
    outs = batch * fields * dim * 4 + batch * 4 + 2 * batch * (dim - 1) * 4
    return ids_valid + rows_in + bet + outs


def bound_ms(nbytes: int) -> float:
    # Operations (a few f32 adds per element) are far below the card's
    # 67 TFLOP/s; the bytes bound.
    return nbytes / HBM_BYTES_PER_S * 1e3


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------


def bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    )


def check_lookup(ske, spec, table, ids):
    got = ske.fused_lookup(spec, table, ids)
    want = ske.fused_lookup_plain(spec, table, ids)
    if not bit_equal(got, want):
        fail(f"fused_lookup differs from its plain version on {ids.shape[0]} ids")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_lookup_fm(ske, spec, table, bet, ids, valid):
    import torch

    got = ske.fused_lookup_fm(spec, table, bet, ids, valid)
    want = ske.fused_lookup_fm_plain(spec, table, bet, ids, valid)
    torch.cuda.synchronize()
    if not bit_equal(got[0], want[0]):
        fail("fused_lookup_fm acts differ from the plain version's bits")
    acts = want[0]
    fields = acts.shape[1]
    terms = (acts[..., 0].abs().sum(-1), acts[..., 1:].abs().sum(1),
             (acts[..., 1:] * acts[..., 1:]).sum(1))
    for name, g, w, t in zip(("first", "sum_v", "sum_sq"), got[1:], want[1:], terms):
        excess = (g - w).abs() - SUM_ORDER_ULPS * fields * t
        if float(excess.max()) > 0.0:
            fail(f"fused_lookup_fm {name} differs from the plain version by more "
                 f"than the reduction-order bound (excess {float(excess.max())!r})")
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def call_split(kernel, call, flush):
    """The kernel alone (its C entry point on inputs prepared once) beside
    the whole wrapper call: device ms of each (CUDA events, L2 flushed),
    the call's host ms and its device records per call."""
    return {"kernel_ms": median_ms(kernel, flush), "call_ms": median_ms(call, flush),
            "call_host_ms": host_ms(call, flush), "call_profile": profile_launches(call)}


def k1_split(ske, spec, table, bet, ids, valid, flush):
    inputs, outs = ske._lookup_fm_operands(spec, table, bet, ids, valid)
    return call_split(lambda: ske._launch_lookup_fm(spec, table, inputs, outs),
                      lambda: ske.fused_lookup_fm(spec, table, bet, ids, valid), flush)


def log_split(what, split, bound, card):
    prof = split["call_profile"]
    records = ("no device records in the profiler's trace" if prof is None else
               f"device records per call {prof['launches']!r} launches, {prof['device_ms']!r} ms: "
               + json.dumps(prof["by_kernel"]))
    log(f"split {what}: kernel alone {split['kernel_ms']!r} ms, whole call "
        f"{split['call_ms']!r} ms (host {split['call_host_ms']!r} ms), bound {bound!r} ms; "
        f"{records} [{card}]")


def lookup_sector_bytes(n: int, dim: int) -> int:
    # lookup_bytes with each row read counted in whole 32-byte sectors.
    return lookup_bytes(n, dim) + n * (sector_row_bytes(dim) - dim * 4)


def k2_split(ske, spec, table, ids, flush):
    import torch

    out = torch.empty((ids.shape[0], spec.dim), dtype=table.dtype, device=table.device)
    return call_split(lambda: ske._launch_lookup(spec, table, ids, out),
                      lambda: ske.fused_lookup(spec, table, ids), flush)


def lookup_shapes(ske, gen, dev, merged_spec, merged, flush, card):
    """K2 at each of K2_SHAPES: bit-exact with the plain version, then its
    time beside the plain version's, ``index_select`` of the same rows,
    the bytes bound and the 32-byte-sector bound, and the split of
    phase 2.  The merged table is phase 2's; the others are made here.
    The first shape's numbers are the entry's own (the history row)."""
    import torch

    from elasticdl_tpu_torch.parallel.packed import PackedSpec, row_index

    shapes = {}
    for label, rows, dim, n in K2_SHAPES:
        spec = PackedSpec(rows, dim)
        if spec == merged_spec:
            table, lo, hi = merged, -1000, spec.vocab_padded + 1000
        else:
            table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
            table.uniform_(-0.05, 0.05, generator=gen)
            table[:, spec.dim:] = 0.0
            lo, hi = 0, spec.vocab_size
        ids = torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)
        r = {
            "shape": f"ids [{n}], table {list(spec.rows_shape)}, dim {dim}",
            "max_abs_err": check_lookup(ske, spec, table, ids),
            "ms": median_ms(lambda: ske.fused_lookup(spec, table, ids), flush),
            "plain_ms": median_ms(lambda: ske.fused_lookup_plain(spec, table, ids), flush),
            "gather_ms": gather_ms(table, row_index(spec, ids), flush),
            "bound_ms": bound_ms(lookup_bytes(n, dim)),
            "sector_bound_ms": bound_ms(lookup_sector_bytes(n, dim)),
            "split": k2_split(ske, spec, table, ids, flush),
        }
        shapes[label] = r
        log(f"kernel fused_lookup {label}: {r['shape']}: bit-exact with the plain version, "
            f"{r['ms']!r} ms (plain {r['plain_ms']!r} ms, index_select of the rows "
            f"{r['gather_ms']!r} ms, bound {r['bound_ms']!r} ms, in 32-byte sectors "
            f"{r['sector_bound_ms']!r} ms) [{card}]")
        log_split(f"fused_lookup {label}", r["split"], r["bound_ms"], card)
        del table, ids
        torch.cuda.empty_cache()
    first = shapes[K2_SHAPES[0][0]]
    return dict(first, shapes=shapes)


def k2_edge_lookups(ske, gen, dev, card, vocab: int = 5000):
    """K2 at each of K2_EDGE_DIMS and K2_EDGE_NS on a small table: ids
    negative, past the table and near +-2**31 first, the rest drawn over
    and around the table; bit-exact with the plain version."""
    import torch

    from elasticdl_tpu_torch.parallel.packed import PackedSpec

    for dim in K2_EDGE_DIMS:
        spec = PackedSpec(vocab, dim)
        table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
        table.uniform_(-1.0, 1.0, generator=gen)
        edges = torch.tensor([-2**31, -2**31 + 1, -1, -7, 2**31 - 1, 2**31 - 2,
                              spec.vocab_padded, spec.vocab_padded + 5, 0,
                              spec.vocab_padded - 1], dtype=torch.int32, device=dev)
        for n in K2_EDGE_NS:
            ids = torch.randint(-100, spec.vocab_padded + 100, (n,), generator=gen,
                                device=dev, dtype=torch.int32)
            ids[:len(edges)] = edges[:n]
            got = ske.fused_lookup(spec, table, ids)
            torch.cuda.synchronize()
            want = ske.fused_lookup_plain(spec, table, ids)
            if not bit_equal(got, want):
                fail(f"fused_lookup differs from its plain version at dim {dim}, n {n}: "
                     f"{first_difference(got, want)}")
    log(f"fused_lookup at dims {list(K2_EDGE_DIMS)} and n {list(K2_EDGE_NS)} (vocab {vocab}; "
        f"ids negative, past the table and near +-2**31): bit-exact with the plain version "
        f"[{card}]")


def kernel_phase(card: str, seed: int):
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.packed import PackedSpec, row_index

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    spec = PackedSpec(1_000_000 * NUM_CAT, 1 + 8)
    table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
    table.uniform_(-0.05, 0.05, generator=gen)
    table[:, spec.dim:] = 0.0
    table[spec.vocab_size:] = 0.0
    log(f"table: {tuple(table.shape)} f32, {table.numel() * 4 / 1e9:.2f} GB on the card")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)  # 512 MiB > L2

    def ids_in(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    results = {"fused_lookup": lookup_shapes(ske, gen, dev, spec, table, flush, card)}
    k2_edge_lookups(ske, gen, dev, card)

    # -- fused_lookup_fm: B=8192, F=26 (some ids invalid), bet None as
    # serving passes it; bet non-zero checked once for the training slice.
    batch = 8192
    cat = ids_in(batch * NUM_CAT, 0, spec.vocab_size).view(batch, NUM_CAT)
    valid = torch.rand((batch, NUM_CAT), generator=gen, device=dev) > 0.05
    bet = torch.randn((batch, NUM_CAT, spec.dim), generator=gen, device=dev)
    err = check_lookup_fm(ske, spec, table, None, cat, valid)
    err = max(err, check_lookup_fm(ske, spec, table, bet, cat, valid))
    main_cat, main_valid = cat[:64].contiguous(), valid[:64].contiguous()
    check_lookup_fm(ske, spec, table, None, main_cat, main_valid)
    results["fused_lookup_fm"] = {
        "shape": f"ids [{batch}, {NUM_CAT}], table {list(spec.rows_shape)}, dim {spec.dim}",
        "max_abs_err": err,
        "ms": median_ms(lambda: ske.fused_lookup_fm(spec, table, None, cat, valid), flush),
        "plain_ms": median_ms(
            lambda: ske.fused_lookup_fm_plain(spec, table, None, cat, valid), flush),
        "gather_ms": gather_ms(table, row_index(spec, cat.reshape(-1)), flush),
        "bound_ms": bound_ms(lookup_fm_bytes(batch, NUM_CAT, spec.dim, False)),
        "main_path_shape": f"ids [64, {NUM_CAT}]",
        "main_path_shape_ms": median_ms(
            lambda: ske.fused_lookup_fm(spec, table, None, main_cat, main_valid), flush),
        "main_path_shape_bound_ms": bound_ms(lookup_fm_bytes(64, NUM_CAT, spec.dim, False)),
        # the training step's shape: B=8192 with the perturbation input
        "train_shape_ms": median_ms(
            lambda: ske.fused_lookup_fm(spec, table, bet, cat, valid), flush),
        "train_shape_plain_ms": median_ms(
            lambda: ske.fused_lookup_fm_plain(spec, table, bet, cat, valid), flush),
        "train_shape_bound_ms": bound_ms(lookup_fm_bytes(batch, NUM_CAT, spec.dim, True)),
    }
    # The split: the kernel alone, the whole call, the call's launches.
    r = results["fused_lookup_fm"]
    r["sector_bound_ms"] = bound_ms(lookup_fm_sector_bytes(batch, NUM_CAT, spec.dim, False))
    r["main_path_shape_sector_bound_ms"] = bound_ms(
        lookup_fm_sector_bytes(64, NUM_CAT, spec.dim, False))
    r["train_shape_sector_bound_ms"] = bound_ms(
        lookup_fm_sector_bytes(batch, NUM_CAT, spec.dim, True))
    log(f"fused_lookup_fm bounds in 32-byte sectors: [{batch}, {NUM_CAT}] "
        f"{r['sector_bound_ms']!r} ms, with bet {r['train_shape_sector_bound_ms']!r} ms, "
        f"[64, {NUM_CAT}] {r['main_path_shape_sector_bound_ms']!r} ms")
    r["split"] = {}
    for what, b, c, v, bound in (
            (f"[64, {NUM_CAT}]", None, main_cat, main_valid, r["main_path_shape_bound_ms"]),
            (f"[{batch}, {NUM_CAT}]", None, cat, valid, r["bound_ms"]),
            (f"[{batch}, {NUM_CAT}] with bet", bet, cat, valid, r["train_shape_bound_ms"])):
        r["split"][what] = k1_split(ske, spec, table, b, c, v, flush)
        log_split(f"fused_lookup_fm {what}", r["split"][what], bound, card)
    r = results["fused_lookup_fm"]
    log(
        f"kernel fused_lookup_fm: {r['shape']}: max_abs_err {r['max_abs_err']!r}, "
        f"{r['ms']!r} ms (plain {r['plain_ms']!r} ms, index_select of the rows "
        f"{r['gather_ms']!r} ms, bound {r['bound_ms']!r} ms); "
        f"main-path shape {r['main_path_shape']}: {r['main_path_shape_ms']!r} ms "
        f"(bound {r['main_path_shape_bound_ms']!r} ms) [{card}]"
    )
    del table, flush
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# phases 3-4: the serving path
# ----------------------------------------------------------------------


def write_random_artifact(out_dir: str, params: str, seed: int) -> None:
    from elasticdl_tpu_torch.serving import convert
    from elasticdl_tpu_torch.serving.export import write_artifact
    from elasticdl_tpu_torch.zoo import build_model

    shapes_only = build_model(MODEL_DEF, params, device="meta")
    variables, tables = convert.random_jax_variables(shapes_only, seed)
    write_artifact(out_dir, variables, tables,
                   {"model_def": MODEL_DEF, "model_params": params})


def make_requests(rng, vocab: int, count: int, rows: int):
    import numpy as np

    out = []
    for _ in range(count):
        cat = rng.integers(0, vocab, size=(rows, NUM_CAT)).astype(np.int32)
        cat[rng.random((rows, NUM_CAT)) < 0.02] = -1        # padding ids
        cat[rng.random((rows, NUM_CAT)) < 0.02] = vocab + 7  # out of vocabulary
        out.append({
            "dense": rng.random((rows, NUM_DENSE), dtype=np.float32),
            "cat": cat,
        })
    return out


def plain_logits(served, features):
    """The served model's forward with the plain PyTorch lookups in place
    of the kernels, on the same card: the yardstick of the responses."""
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    with mock.patch.object(ske, "fused_lookup", ske.fused_lookup_plain), \
            mock.patch.object(ske, "fused_lookup_fm", ske.fused_lookup_fm_plain), \
            torch.inference_mode():
        return served.forward(features).cpu().numpy()


def drive(batcher, requests, clients: int = 8):
    """Closed loop: `clients` threads issue the requests back to back.
    Returns (responses, latencies_s, elapsed_s)."""
    responses = [None] * len(requests)
    latencies = [0.0] * len(requests)
    errors = []

    def client(w):
        try:
            for i in range(w, len(requests), clients):
                t0 = time.perf_counter()
                responses[i] = batcher.predict(requests[i])
                latencies[i] = time.perf_counter() - t0
        except Exception as exc:  # reported after join
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(w,), name=f"smoke-client-{w}")
               for w in range(clients)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            fail(f"client thread {t.name} did not finish")
    elapsed = time.perf_counter() - start
    if errors:
        fail(f"{len(errors)} client(s) failed: {errors[0]!r}")
    return responses, latencies, elapsed


def serve_phase(name, replica, batcher, requests, card, dispatches):
    import numpy as np

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    dispatches.clear()
    ske.reset_launch_counts()
    responses, latencies, elapsed = drive(batcher, requests)
    counts = ske.launch_counts()
    executes = sorted(seconds for seconds, _ in dispatches)
    rows_per_batch = sum(rows for _, rows in dispatches) / len(dispatches)
    served = replica.generation.served
    stacked = {k: np.concatenate([r[k] for r in requests]) for k in requests[0]}
    want = plain_logits(served, stacked)
    offset = 0
    for req, got in zip(requests, responses):
        rows = req["cat"].shape[0]
        if got.shape != (rows,) or not np.all(np.isfinite(got)):
            fail(f"{name}: response of shape {got.shape} / non-finite for {rows} rows")
        np.testing.assert_allclose(got, want[offset:offset + rows],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        offset += rows
    lat = sorted(latencies)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3
    log(
        f"{name}: served {len(requests)} requests of {requests[0]['cat'].shape[0]} rows, "
        f"all within rtol {LOGIT_RTOL} of the plain forward; {len(requests) / elapsed!r} "
        f"requests/s, p50 {p50!r} ms, p99 {p99!r} ms, launches {counts}; "
        f"{len(dispatches)} dispatches of {rows_per_batch!r} rows on average, "
        f"execute (host wall, device sync included) median "
        f"{executes[len(executes) // 2] * 1e3!r} ms [{card}]"
    )
    return counts


def serving_phases(card: str, seed: int, workdir: str,
                   vocab1: int = 1_000_000, vocab2: int = 100_000):
    import numpy as np

    from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    merged = os.path.join(workdir, "gen1_merged")
    split = os.path.join(workdir, "gen2_split")
    t0 = time.perf_counter()
    write_random_artifact(
        merged, f"vocab_size={vocab1},embedding_dim=8,hidden=128,split_tables=false", seed)
    log(f"artifact 1 (merged, vocab {vocab1}/field) written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    replica = ServingReplica(merged)
    if replica.device.type != "cuda":
        fail(f"ServingReplica's default device is {replica.device}, not cuda")
    log(f"replica loaded generation 1 on {replica.device} in {time.perf_counter() - t0:.1f} s")
    config = BatcherConfig(max_batch_size=64, max_wait_us=2000, queue_limit=512)
    dispatches = []  # (execute seconds, real rows) per dispatch

    def timed_execute(features, n_valid):
        t0 = time.perf_counter()
        try:
            return replica.execute(features, n_valid)
        finally:
            dispatches.append((time.perf_counter() - t0, n_valid))

    batcher = MicroBatcher(timed_execute, config).start()
    rng = np.random.default_rng(seed)
    try:
        replica.warmup(make_requests(rng, vocab1, 1, 1)[0], batcher.buckets)
        counts1 = serve_phase("serve gen 1 (merged)", replica, batcher,
                              make_requests(rng, vocab1, 200, 8), card, dispatches)

        write_random_artifact(
            split, f"vocab_size={vocab2},embedding_dim=8,hidden=128,split_tables=true",
            seed + 1)
        replica.reload(split)
        stats = replica.stats()
        if stats["generation"] != 2 or not replica.generation.served.model.split:
            fail(f"hot swap did not reach the split-table generation 2: {stats}")
        log(f"hot swap: {stats}")
        replica.warmup(make_requests(rng, vocab2, 1, 1)[0], batcher.buckets)
        counts2 = serve_phase("serve gen 2 (split_tables)", replica, batcher,
                              make_requests(rng, vocab2, 200, 8), card, dispatches)
    finally:
        batcher.stop()
    return {"fused_lookup_fm": counts1["fused_lookup_fm"],
            "fused_lookup": counts2["fused_lookup"]}


# ----------------------------------------------------------------------
# phase 5: fused_dedup_apply against its plain version
# ----------------------------------------------------------------------


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms: on the card ``index_add_`` then
    sums each row's duplicates in index order instead of with atomics."""
    import torch

    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(previous)


def k3_inputs(spec, gen, dev, n: int, cancel_pairs: int = 256):
    """n ids: 30% from 1000 hot rows (heavy duplicates), the rest uniform
    over the table, 1% ``-1``, 0.5% past the table, and ``cancel_pairs``
    rows that occur exactly twice with opposite grads."""
    import torch

    ids = torch.randint(0, spec.vocab_size, (n,), generator=gen, device=dev, dtype=torch.int32)
    hot = torch.randint(0, 1000, (n,), generator=gen, device=dev, dtype=torch.int32)
    hot = (hot.to(torch.int64) * 7919 % spec.vocab_size).to(torch.int32)
    pick = torch.rand(n, generator=gen, device=dev)
    ids = torch.where(pick < 0.3, hot, ids)
    u = torch.rand(n, generator=gen, device=dev)
    ids[u < 0.01] = -1
    ids[(u >= 0.01) & (u < 0.015)] = spec.vocab_padded + 3
    grads = torch.randn((n, spec.dim), generator=gen, device=dev) * 0.01
    rows = torch.arange(spec.vocab_size - cancel_pairs, spec.vocab_size, device=dev,
                        dtype=torch.int32)
    ids[torch.isin(ids, rows)] = -1
    where = torch.randperm(n, generator=gen, device=dev)[: 2 * cancel_pairs]
    ids[where[:cancel_pairs]] = rows
    ids[where[cancel_pairs:]] = rows
    grads[where[cancel_pairs:]] = -grads[where[:cancel_pairs]]
    return ids, grads, rows


def k3_slots(kind: str, table):
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    slots = {name: torch.zeros_like(table) for name in ske.KIND_SLOTS[kind]}
    if kind == "adam_global":
        slots["t_global"] = torch.zeros((), dtype=torch.float32, device=table.device)
    return slots


def k3_bytes(n: int, dim: int, touched: int, operands: int) -> int:
    # ids and grads read once; per touched row the table and slot rows'
    # dim lanes read and written.
    return n * 4 + n * dim * 4 + touched * operands * dim * 4 * 2


def sector_row_bytes(dim: int) -> int:
    """The bytes of 32-byte sectors that a row's first ``dim`` f32 lanes
    span, from a sector boundary (a logical row starts on one when its
    dim_padded*4 is a multiple of 32)."""
    return 32 * -(-dim * 4 // 32)


def k3_sector_bytes(n: int, dim: int, touched: int, operands: int) -> int:
    # k3_bytes with each touched operand row counted in whole sectors.
    return n * 4 + n * dim * 4 + touched * operands * sector_row_bytes(dim) * 2


def lookup_fm_sector_bytes(batch: int, fields: int, dim: int, with_bet: bool) -> int:
    # lookup_fm_bytes with each table row read counted in whole sectors.
    return (lookup_fm_bytes(batch, fields, dim, with_bet)
            + batch * fields * (sector_row_bytes(dim) - dim * 4))


def k3_split(ske, spec, kind, hyper, table, slots, ids, grads, flush):
    """K3's ``call_split`` at one kind: the kernel alone on ids sorted
    once; the call's device records split it into the sort and the
    kernel."""
    import torch

    c = ske.apply_constants(kind, hyper)
    operands = [table] + [slots[name] for name in ske.KIND_SLOTS[kind]]
    sorted_ids, perm = torch.sort(ids, stable=True)
    return call_split(
        lambda: ske._launch_apply(spec, kind, c, operands, slots.get("t_global"), sorted_ids,
                                  perm, grads),
        lambda: ske.fused_dedup_apply(spec, kind, hyper, table, slots, ids, grads), flush)


def first_difference(got, want) -> str:
    """Where two f32 tensors of one shape differ in their bits: how many
    elements, and the first one's index and both values."""
    import torch

    diff = got.contiguous().view(torch.int32) != want.contiguous().view(torch.int32)
    where = torch.nonzero(diff)
    if where.numel() == 0:
        return "no element differs"
    at = tuple(int(x) for x in where[0])
    return (f"{where.shape[0]} elements differ, the first at {list(at)}: "
            f"{float(got[at]).hex()} against {float(want[at]).hex()}")


def k3_two_applies(ske, spec, kind, hyper, table, ids, grads, what):
    """Two applies of K3 and of its plain version (deterministic) from one
    state (``table``, zero slots): table and every slot bit-exact.
    Returns (max abs error, the kernel's table and slots, the plain
    version's)."""
    import torch

    t_kernel, s_kernel = table.clone(), k3_slots(kind, table)
    t_plain, s_plain = table.clone(), k3_slots(kind, table)
    for _ in range(2):  # the second apply reads non-zero slots
        ske.fused_dedup_apply(spec, kind, hyper, t_kernel, s_kernel, ids, grads)
        with deterministic():
            ske.fused_dedup_apply_plain(spec, kind, hyper, t_plain, s_plain, ids, grads)
    torch.cuda.synchronize()
    err = float((t_kernel - t_plain).abs().max())
    if not bit_equal(t_kernel, t_plain):
        fail(f"fused_dedup_apply{what} table differs from the plain version "
             f"(max abs {err!r}; {first_difference(t_kernel, t_plain)})")
    for slot, value in s_kernel.items():
        err = max(err, float((value - s_plain[slot]).abs().max()))
        if not bit_equal(value.reshape(-1), s_plain[slot].reshape(-1)):
            fail(f"fused_dedup_apply{what} slot {slot} differs from the plain version "
                 f"({first_difference(value.reshape(-1), s_plain[slot].reshape(-1))})")
    return err, (t_kernel, s_kernel), (t_plain, s_plain)


def check_k3(ske, spec, name, table, ids, grads, cancel_rows, what=""):
    """``k3_two_applies`` of K3 kind ``name``, and rows whose grads cancel
    untouched, no pad lane written."""
    import torch

    kind, hyper = K3_HYPER[name]
    err, (t_kernel, s_kernel), (t_plain, s_plain) = k3_two_applies(
        ske, spec, kind, hyper, table, ids, grads, f"[{name}]{what}")
    if not torch.equal(t_kernel[cancel_rows.to(torch.int64)],
                       table[cancel_rows.to(torch.int64)]):
        fail(f"fused_dedup_apply[{name}]{what} moved a row whose grads cancel to zero")
    if not bit_equal(t_kernel[:, spec.dim:].contiguous(), table[:, spec.dim:].contiguous()):
        fail(f"fused_dedup_apply[{name}]{what} wrote a pad lane")
    return err, (t_kernel, s_kernel), (t_plain, s_plain)


#: Dims of phase 5's small applies: a group of one lane (32 a warp), of
#: 3, 5 and 20 lanes (10, 6 and 1 a warp, lanes left over), and of 32
#: lanes taking two column passes (dim 40).
K3_EDGE_DIMS = (1, 3, 5, 20, 40)


def k3_edge_inputs(spec, gen, dev, n: int):
    """Phase 5's recipe (``k3_inputs``) on a small table, with segments
    placed: 150 and 40 occurrences of two rows (many chunks), and 16 rows
    that occur twice with the grads of their first ``max(1, dim // 2)``
    columns cancelling (at dim 1 the whole row, which joins the rows that
    must stay untouched)."""
    import torch

    ids, grads, cancel_rows = k3_inputs(spec, gen, dev, n, cancel_pairs=16)
    base = spec.vocab_size - 64
    part_rows = torch.arange(base + 2, base + 18, device=dev, dtype=torch.int32)
    ids[(ids >= base) & (ids < base + 18)] = -1
    where = torch.randperm(n, generator=gen, device=dev)
    free = where[~torch.isin(where, torch.nonzero(torch.isin(ids, cancel_rows))[:, 0])]
    ids[free[:150]] = base
    ids[free[150:190]] = base + 1
    a, b = free[190:206], free[206:222]
    ids[a] = part_rows
    ids[b] = part_rows
    half = max(1, spec.dim // 2)
    grads[b, :half] = -grads[a, :half]
    if spec.dim == 1:
        cancel_rows = torch.cat([cancel_rows, part_rows])
    return ids, grads, cancel_rows


def k3_edge_applies(ske, pk, gen, dev, card, vocab: int = 20_000, n: int = 4096):
    """``k3_edge_inputs`` at each of K3_EDGE_DIMS: all six kinds, two
    applies, bit-exact with the plain version."""
    import torch

    for dim in K3_EDGE_DIMS:
        spec = pk.PackedSpec(vocab, dim)
        table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
        table.uniform_(-0.05, 0.05, generator=gen)
        table[:, spec.dim:] = 0.0
        table[spec.vocab_size:] = 0.0
        ids, grads, cancel_rows = k3_edge_inputs(spec, gen, dev, n)
        for name in K3_HYPER:
            check_k3(ske, spec, name, table, ids, grads, cancel_rows, what=f" at dim {dim}")
    log(f"fused_dedup_apply at dims {list(K3_EDGE_DIMS)} (vocab {vocab}, {n} ids: segments of "
        f"150 and 40, partly cancelling rows, ids -1 and past the table): all "
        f"{len(K3_HYPER)} kinds bit-exact with the plain version over two applies [{card}]")


def dedup_apply_phase(card: str, seed: int):
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel import packed as pk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    spec = pk.PackedSpec(1_000_000 * NUM_CAT, 1 + 8)
    table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
    table.uniform_(-0.05, 0.05, generator=gen)
    table[:, spec.dim:] = 0.0
    table[spec.vocab_size:] = 0.0
    n = TRAIN_BATCH * NUM_CAT
    ids, grads, cancel_rows = k3_inputs(spec, gen, dev, n)
    touched = int(pk.dedup_representatives(spec, ids, grads)[2].sum())
    keep = pk.in_table(spec, ids)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    acc = torch.zeros((spec.vocab_padded, spec.dim), dtype=torch.float32, device=dev)
    rows64, kept = ids[keep].to(torch.int64), grads[keep]
    index_add = median_ms(lambda: acc.index_add_(0, rows64, kept), flush)
    del acc
    log(f"K3 inputs: {n} ids, {int(keep.sum())} inside the table, {touched} touched rows, "
        f"{cancel_rows.numel()} rows cancelling to zero [{card}]")
    results = {}
    for name, (kind, hyper) in K3_HYPER.items():
        err, (t_kernel, s_kernel), (t_plain, s_plain) = check_k3(
            ske, spec, name, table, ids, grads, cancel_rows)
        operands = 1 + len(ske.KIND_SLOTS[kind])
        results[name] = {
            "kind": kind, "max_abs_err": err, "touched_rows": touched,
            "ms": median_ms(lambda: ske.fused_dedup_apply(
                spec, kind, hyper, t_kernel, s_kernel, ids, grads), flush),
            "plain_ms": median_ms(lambda: ske.fused_dedup_apply_plain(
                spec, kind, hyper, t_plain, s_plain, ids, grads), flush),
            "bound_ms": bound_ms(k3_bytes(n, spec.dim, touched, operands)),
            "sector_bound_ms": bound_ms(k3_sector_bytes(n, spec.dim, touched, operands)),
        }
        r = results[name]
        log(f"kernel fused_dedup_apply[{name}]: ids [{n}], table {list(spec.rows_shape)} + "
            f"{operands - 1} slot(s): bit-exact with the plain version, {r['ms']!r} ms "
            f"(plain {r['plain_ms']!r} ms, bound {r['bound_ms']!r} ms, in 32-byte sectors "
            f"{r['sector_bound_ms']!r} ms; index_add_ of the grads {index_add!r} ms) [{card}]")
        r["split"] = k3_split(ske, spec, kind, hyper, t_kernel, s_kernel, ids, grads, flush)
        log_split(f"fused_dedup_apply[{name}]", r["split"], r["bound_ms"], card)
        del t_kernel, s_kernel, t_plain, s_plain
        torch.cuda.empty_cache()
    del table, flush
    torch.cuda.empty_cache()
    k3_edge_applies(ske, pk, gen, dev, card)
    return {"by_kind": results, "index_add_ms": index_add,
            "shape": f"ids [{n}] (skewed), table {list(spec.rows_shape)}, dim {spec.dim}"}


# ----------------------------------------------------------------------
# phases 6-9: the training path
# ----------------------------------------------------------------------


def time_parts(trainer, staged, timed=()):
    """One training step through its four parts, each between CUDA
    events; returns ms per part, and under ``kernel_ms`` the device time
    of the sparse ops named in ``timed`` inside the step (CUDA events
    around each call)."""
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    records = {}
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with timed_calls(ske, timed, records):
        marks[0].record()
        loss, cap = trainer.forward(*staged)
        marks[1].record()
        dense, sparse, _ = trainer.backward(loss, cap)
        marks[2].record()
        trainer.dense_update(dense)
        marks[3].record()
        trainer.sparse_apply(sparse)
        marks[4].record()
    torch.cuda.synchronize()
    names = ("forward", "backward", "dense_update", "fused_dedup_apply")
    parts = {name: marks[i].elapsed_time(marks[i + 1]) for i, name in enumerate(names)}
    if timed:
        parts["kernel_ms"] = {name: sum(s.elapsed_time(e) for s, e in events)
                              for name, events in records.items()}
    return parts


def path_steps(trainer, staged, steps: int = 3):
    import torch

    losses = [float(trainer.train_step_staged(staged[i])) for i in range(steps)]
    tables = {key: t.detach().clone() for key, t in trainer.state.tables.items()}
    torch.cuda.synchronize()
    return losses, tables


def compare_paths(trainer, staged, card, what="kernel path vs plain path", lr=LR,
                  dense=False):
    """Phase 7: from one cloned state, 3 steps with the kernels and 3 with
    the plain versions patched in; with ``dense`` the dense params are
    held beside the tables (phase 30)."""
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.ps_trainer import clone_state

    def steps():
        losses, moved = path_steps(trainer, staged)
        if dense:
            moved.update({f"dense/{k}": v.detach().clone()
                          for k, v in trainer.state.params.items()})
        return losses, moved

    start = clone_state(trainer.state)
    tables0 = {key: t.clone() for key, t in start.tables.items()}
    if dense:
        tables0.update({f"dense/{k}": v.clone() for k, v in start.params.items()})
    kernel_losses, kernel_tables = steps()
    trainer.state = start
    del start
    with mock.patch.object(ske, "fused_lookup", ske.fused_lookup_plain), \
            mock.patch.object(ske, "fused_lookup_fm", ske.fused_lookup_fm_plain), \
            mock.patch.object(ske, "fused_dedup_apply", ske.fused_dedup_apply_plain):
        plain_losses, plain_tables = steps()
    out = paths_agree(what, kernel_losses, plain_losses, kernel_tables, plain_tables, tables0,
                      card, lr)
    return {"losses_kernel": kernel_losses, "losses_plain": plain_losses, **out}


def paths_agree(what, losses_a, losses_b, tables_a, tables_b, tables0, card, lr=LR):
    """Phase 7's tolerances over two 3-step runs from one state: losses
    within PATH_LOSS_RTOL; every table element within 2*lr*3 and all but
    PATH_LOOSE_SHARE of the moved ones within PATH_TABLE_ATOL."""
    import numpy as np
    import torch

    np.testing.assert_allclose(losses_a, losses_b, rtol=PATH_LOSS_RTOL)
    worst, loose, moved = 0.0, 0, 0
    for key, got in tables_a.items():
        diff = (got - tables_b[key]).abs()
        worst = max(worst, float(diff.max()))
        changed = (got != tables0[key]) | (tables_b[key] != tables0[key])
        moved += int(changed.sum())
        loose += int((diff > PATH_TABLE_ATOL).sum())
    del tables_a, tables_b, tables0
    torch.cuda.empty_cache()
    if worst > 2 * lr * 3 + PATH_TABLE_ATOL or loose > PATH_LOOSE_SHARE * max(moved, 1):
        fail(f"{what}: the paths diverge: max table diff {worst!r}, {loose} of {moved} "
             f"moved elements past {PATH_TABLE_ATOL}")
    log(f"{what}, 3 steps: losses {losses_a} vs {losses_b}; "
        f"tables max diff {worst!r}, {loose} of {moved} moved elements past "
        f"{PATH_TABLE_ATOL} [{card}]")
    return {"max_table_diff": worst, "loose_elements": loose, "moved_elements": moved}


def training_phases(card: str, seed: int, workdir: str, params: str = TRAIN_PARAMS,
                    warmup: int = 5, steps: int = 50, n_batches: int = 64,
                    launches=TRAIN_LAUNCHES, embedding_optimizer=None,
                    name: str = "train strict", serve_and_window: bool = True):
    """Phases 6-9 (and, with phase 20's arguments, phase 20): strict
    training at ``params``, timed, each kernel's launches held to
    ``launches`` per step and the loss to fall; kernel path against plain
    path; then, with ``serve_and_window``, train -> serve and the W=32
    window.  ``embedding_optimizer``: a factory of the sparse optimizer
    (default the zoo's)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.runtime import ServingReplica
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    vocab = int(dict(p.split("=") for p in params.split(","))["vocab_size"])
    batch = TRAIN_BATCH
    t0 = time.perf_counter()
    feats, labels = synthetic_ctr_arrays(batch * n_batches + 256, vocab_size=vocab, seed=seed)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch], np.ones((batch,), np.float32))
               for i in range(n_batches)]
    held_out = {k: v[n_batches * batch:] for k, v in feats.items()}
    log(f"synthetic data: {len(labels)} rows, vocab {vocab}/field, in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model = build_model(MODEL_DEF, params)  # the default device: the card
    embedding_optimizer = embedding_optimizer or zoo.embedding_optimizer
    trainer = ShardedEmbeddingTrainer(model, zoo.loss, zoo.optimizer(),
                                      embedding_optimizer=embedding_optimizer(), seed=seed)
    if trainer.device.type != "cuda":
        fail(f"ShardedEmbeddingTrainer's default device is {trainer.device}, not cuda")
    trainer.ensure_initialized()
    staged = [trainer.stage_batch(*b) for b in batches]
    torch.cuda.synchronize()
    log(f"trainer initialised on {trainer.device} in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"sparse_apply_every {trainer.sparse_apply_every}")

    # phase 6: strict training, timed
    losses = [trainer.train_step_staged(staged[i % n_batches]) for i in range(warmup)]
    torch.cuda.synchronize()
    ske.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step_staged(staged[i % n_batches]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    strict_counts = ske.launch_counts()
    for kernel, per_step in launches.items():
        if strict_counts[kernel] != per_step * steps:
            fail(f"{name}: {kernel} launched {strict_counts[kernel]} times in {steps} steps "
                 f"({per_step} a step expected)")
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    losses = torch.stack(losses).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not last < first:
        fail(f"the loss did not fall: first 5 steps {first!r}, last 5 {last!r}")
    parts = time_parts(trainer, staged[0], timed=("fused_lookup",) if launches.get(
        "fused_lookup") else ())
    train = {
        "samples_per_s": steps * batch / wall,
        "step_ms_median": step_ms[len(step_ms) // 2],
        "loss_first5": first, "loss_last5": last,
        "breakdown_ms": parts,
        "launches_strict": strict_counts,
    }
    log(f"{name}: {steps} steps of {batch}: {train['samples_per_s']!r} samples/s, "
        f"step median {train['step_ms_median']!r} ms (device, CUDA events); loss "
        f"{first!r} -> {last!r}; launches {strict_counts}; one step's parts {parts} [{card}]")

    # phase 7: kernels against plain versions on the path
    train["path"] = compare_paths(
        trainer, staged, card,
        "kernel path vs plain path" if serve_and_window else f"{name}: kernel path vs plain path")
    if not serve_and_window:
        del trainer, staged, model
        torch.cuda.empty_cache()
        return train

    # phase 8: train -> serve
    out = export_model(trainer, os.path.join(workdir, "trained"), model_zoo="model_zoo",
                       model_def=MODEL_DEF, model_params=params)
    want = trainer.eval_step(held_out)
    replica = ServingReplica(out)
    if replica.device.type != "cuda":
        fail(f"ServingReplica's default device is {replica.device}, not cuda")
    got = replica.execute(held_out, len(want))[: len(want)]
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    log(f"train -> serve: exported at step {trainer.step}, served {len(want)} rows on "
        f"{replica.device} within rtol {LOGIT_RTOL} of eval_step [{card}]")
    del replica, trainer, staged
    torch.cuda.empty_cache()

    # phase 9: the windowed apply
    windowed = ShardedEmbeddingTrainer(model, zoo.loss, zoo.optimizer(),
                                       embedding_optimizer=embedding_optimizer(),
                                       seed=seed, sparse_apply_every=32)
    windowed.ensure_initialized()
    window = windowed.stage_window(batches)
    torch.cuda.synchronize()
    ske.reset_launch_counts()
    t0 = time.perf_counter()
    window_losses = windowed.train_window(window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window_counts = ske.launch_counts()
    if window_counts["fused_dedup_apply"] != 2 or window_counts["fused_lookup_fm"] != n_batches:
        fail(f"{n_batches} steps at sparse_apply_every=32 launched {window_counts}")
    if not bool(torch.isfinite(window_losses).all()):
        fail("non-finite loss in the windowed run")
    train["window_samples_per_s"] = n_batches * batch / wall
    train["launches_window"] = window_counts
    log(f"train window: {n_batches} steps at sparse_apply_every=32: "
        f"{train['window_samples_per_s']!r} samples/s (host wall incl. first-use), launches "
        f"{window_counts} [{card}]")
    del windowed, window, model
    torch.cuda.empty_cache()
    return train


# ----------------------------------------------------------------------
# phase 10: flash attention (K4-K6) against the plain versions
# ----------------------------------------------------------------------


def attention_bound_ms(b, t, h, d, causal):
    """Least time of the forward, K5 and K6 at one shape: the larger of
    the operations the algorithm needs over the bf16 peak and the bytes
    over the memory rate (each input read once, each output written
    once; bf16 tensors, f32 lse/delta).  Operations: forward 4*B*H*T^2*D,
    backward 10*B*H*T^2*D (x 1/2 causal); of the backward, K5 is given
    dQ (2) and K6 S, dP, dV and dK (8)."""
    tensor, rows = b * t * h * d * 2, b * h * t * 4
    nbytes = {"flash_attention_fwd": 4 * tensor + rows,
              "flash_attention_dq": 5 * tensor + 2 * rows,
              "flash_attention_dkv": 6 * tensor + 2 * rows}
    out = {}
    for name, ops in attention_ops(b, t, h, d, causal).items():
        op_ms = ops / BF16_FLOPS_PER_S * 1e3
        byte_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes")
    return out


def attention_ops(b, t, h, d, causal):
    """The operations attention_bound_ms gives each of K4-K6 (what the
    algorithm needs; a kernel's TFLOP/s is these over its time)."""
    unit = b * h * t * t * d * (0.5 if causal else 1.0)
    return {"flash_attention_fwd": 4 * unit, "flash_attention_dq": 2 * unit,
            "flash_attention_dkv": 8 * unit}


def attention_close(name, got, want, tol=None):
    """Fail unless |got - want| <= max(rtol |want|, floor) + atol_share
    max|want| elementwise, ``tol = (rtol, atol_share)`` with floor 0
    (default: ATTN_* for bf16, ATTN_F32_* for f32, ATTN_F16_* with
    F16_ULP_FLOOR for f16); returns the max abs difference."""
    import torch

    floor = 0.0
    if tol is not None:
        rtol, share = tol
    elif want.dtype == torch.float32:
        rtol, share = ATTN_F32_RTOL, ATTN_F32_ATOL_SHARE
    elif want.dtype == torch.float16:
        rtol, share, floor = ATTN_F16_RTOL, ATTN_F16_ATOL_SHARE, F16_ULP_FLOOR
    else:
        rtol, share = ATTN_RTOL, ATTN_ATOL_SHARE
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = (rtol * want.abs()).clamp_min(floor) + share * float(want.abs().max())
    excess = float((diff - limit).max())
    if not excess <= 0.0:
        fail(f"{name}: kernel differs from its plain version past the tolerance "
             f"(max abs {float(diff.max())!r}, excess {excess!r})")
    return float(diff.max())


def sdpa_ms(q, k, v, do, causal, flush):
    """PyTorch's scaled_dot_product_attention on the same inputs ([B, H,
    T, D] views made outside the timing): forward, and forward+backward
    less forward.  A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    fwd = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), flush)
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        torch.autograd.grad(out, leaves, dot)

    return fwd, median_ms(fwd_bwd, flush) - fwd


def check_attention(fa, q, k, v, do, causal, shape):
    """K4, then K5 and K6 on the plain forward's out/lse, against the
    plain versions; fails past the tolerances and, in f16, where a
    gradient is flushed to zero that the plain version's is not
    (f16_zero_flushes).  Returns (max abs error per kernel, the plain
    forward's (out, lse), delta)."""
    import torch

    scale = fa.default_scale(q.shape[-1])
    out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    # The backward kernels take the plain forward's out/lse, so each is
    # held against its plain version on the same inputs.
    delta = fa.attention_delta(out_p, do)
    dq = fa.flash_attention_dq(q, k, v, do, lse_p, delta, scale, causal)
    dq_p = fa.flash_attention_dq_plain(q, k, v, do, lse_p, delta, scale, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse_p, delta, scale, causal)
    dk_p, dv_p = fa.flash_attention_dkv_plain(q, k, v, do, lse_p, delta, scale, causal)
    torch.cuda.synchronize()
    lse_err = float((lse - lse_p).abs().max())
    if not lse_err <= LSE_ATOL:
        fail(f"flash_attention_fwd lse differs from its plain version by {lse_err!r} "
             f"at {shape}")
    if q.dtype == torch.float16:
        flushed = {name: f16_zero_flushes(got, want)
                   for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
        if any(flushed.values()):
            fail(f"{shape}: f16 gradients flushed to zero where the plain version's are not: "
                 f"{flushed}")
    errs = {
        "flash_attention_fwd": max(attention_close(f"out {shape}", out, out_p), lse_err),
        "flash_attention_dq": attention_close(f"dq {shape}", dq, dq_p),
        "flash_attention_dkv": max(attention_close(f"dk {shape}", dk, dk_p),
                                   attention_close(f"dv {shape}", dv, dv_p)),
    }
    return errs, (out_p, lse_p), delta


def attention_edges(fa, gen, dev, card):
    """ATTN_EDGE_SHAPES, on separate tensors and on the strided slices of
    one fused projection (the transformer's layout)."""
    import torch

    worst = {name: 0.0 for name in fa.KERNELS}
    for b, t, h, d, dtype, causal in ATTN_EDGE_SHAPES:
        shape = f"B={b} T={t} H={h} D={d} {dtype} {'causal' if causal else 'full'}"
        fused = torch.randn((b, t, 3, h, d), generator=gen, device=dev).to(getattr(torch, dtype))
        do = torch.randn((b, t, h, d), generator=gen, device=dev).to(fused.dtype)
        for layout, qkv in (("separate", [x.contiguous() for x in fused.unbind(2)]),
                            ("fused slices", list(fused.unbind(2)))):
            errs, _, _ = check_attention(fa, *qkv, do, causal, f"{shape} {layout}")
            worst = {name: max(worst[name], errs[name]) for name in worst}
    log(f"kernels K4-K6 at the edge shapes ({len(ATTN_EDGE_SHAPES)} shapes x 2 layouts): "
        f"within tolerance, max abs errors {worst} [{card}]")
    return worst


def attention_times(fa, q, k, v, do, causal, lse_p, delta, shape, errs, card, flush):
    """K4-K6 and their plain versions timed at one shape (median of 30
    launches, L2 flushed), beside the bound and SDPA's forward and
    backward; the backward on the plain forward's lse and delta.  ->
    ``{"shape", "kernels": {name: figures}, "sdpa_forward_ms",
    "sdpa_backward_ms"}``."""
    b, t, h, d = q.shape
    scale = fa.default_scale(d)
    bwd = (q, k, v, do, lse_p, delta, scale, causal)
    calls = {
        "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, k, v, scale, causal),
                                lambda: fa.flash_attention_fwd_plain(q, k, v, scale, causal)),
        "flash_attention_dq": (lambda: fa.flash_attention_dq(*bwd),
                               lambda: fa.flash_attention_dq_plain(*bwd)),
        "flash_attention_dkv": (lambda: fa.flash_attention_dkv(*bwd),
                                lambda: fa.flash_attention_dkv_plain(*bwd)),
    }
    lib_fwd, lib_bwd = sdpa_ms(q, k, v, do, causal, flush)
    bounds = attention_bound_ms(b, t, h, d, causal)
    ops = attention_ops(b, t, h, d, causal)
    entry = {"shape": shape, "kernels": {}, "sdpa_forward_ms": lib_fwd,
             "sdpa_backward_ms": lib_bwd}
    for name, (kernel, plain) in calls.items():
        fa.reset_launch_counts()
        ms = median_ms(kernel, flush)
        launches = fa.launch_counts()[name]
        plain_ms = median_ms(plain, flush, PLAIN_REPS, PLAIN_WARMUP)
        tflops = ops[name] / ms * 1e-9
        entry["kernels"][name] = {
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "tflop_per_s": tflops,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": lib_fwd if name == "flash_attention_fwd" else lib_bwd,
            "timed_launches": launches,
        }
        log(f"kernel {name}: {shape}: max_abs_err {errs[name]!r}, {ms!r} ms, {tflops!r} TFLOP/s "
            f"(plain {plain_ms!r} ms, bound {bounds[name][0]!r} ms by {bounds[name][1]}; "
            f"{launches} launches timed) [{card}]")
    log(f"  sdpa yardstick {shape}: forward {lib_fwd!r} ms, backward (dq, dk, dv) {lib_bwd!r} "
        f"ms [{card}]")
    return entry


def attention_phase(card: str, seed: int):
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    edges = attention_edges(fa, gen, dev, card)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    results = []
    for b, t, h, d, causal in ATTN_SHAPES:
        shape = f"B={b} T={t} H={h} D={d} bf16 {'causal' if causal else 'full'}"
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        errs, (out_p, lse_p), delta = check_attention(fa, q, k, v, do, causal, shape)
        results.append(attention_times(fa, q, k, v, do, causal, lse_p, delta, shape, errs,
                                       card, flush))
        del q, k, v, do, out_p, lse_p, delta
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return results, edges


# ----------------------------------------------------------------------
# phases 11-12: the transformer LM trained by DataParallelTrainer
# ----------------------------------------------------------------------


@contextlib.contextmanager
def timed_attention(records, names=None):
    """Wrap the kernel functions ``names`` of ``ops.flash_attention``
    (default K4-K6) so each call records CUDA events around itself into
    ``records[name]``: the kernels' device time inside a step."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    with timed_calls(fa, names or fa.KERNELS, records):
        yield


@contextlib.contextmanager
def timed_calls(module, names, records):
    """Wrap the functions ``names`` of ``module`` so each call records
    CUDA events around itself into ``records[name]``."""
    import torch

    def wrap(name, fn):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args, **kwargs)
            end.record()
            records.setdefault(name, []).append((start, end))
            return result
        return timed

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(module, name, wrap(name, getattr(module, name))))
        yield


def lm_time_parts(trainer, staged, names=None):
    """One LM step through its three parts between CUDA events, and the
    attention kernels' (``names``, default K4-K6) device time inside it,
    summed and by kernel (``kernel_ms``); ms."""
    import torch

    records = {}
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with timed_attention(records, names):
        marks[0].record()
        loss = trainer.forward(*staged)
        marks[1].record()
        grads = trainer.backward(loss)
        marks[2].record()
        trainer.dense_update(grads)
        marks[3].record()
    torch.cuda.synchronize()
    parts = {name: marks[i].elapsed_time(marks[i + 1])
             for i, name in enumerate(("forward", "backward", "adamw"))}
    parts["kernel_ms"] = {name: sum(s.elapsed_time(e) for s, e in events)
                          for name, events in records.items()}
    parts["attention_kernels"] = sum(parts["kernel_ms"].values())
    parts["step"] = marks[0].elapsed_time(marks[3])
    parts["attention_share"] = parts["attention_kernels"] / parts["step"]
    return parts


def lm_path_steps(trainer, staged, steps: int = 3):
    import torch

    losses = [float(trainer.train_step_staged(staged[i])) for i in range(steps)]
    params = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    torch.cuda.synchronize()
    return losses, params


@contextlib.contextmanager
def plain_attention():
    """The plain versions in place of K4 and of K5 + K6; fails if a
    kernel launches inside."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    with mock.patch.object(fa, "flash_attention_fwd", fa.flash_attention_fwd_plain), \
            mock.patch.object(fa, "flash_attention_bwd", fa.flash_attention_bwd_plain):
        fa.reset_launch_counts()
        yield
        if any(fa.launch_counts().values()):
            fail(f"the plain path launched kernels: {fa.launch_counts()}")


@contextlib.contextmanager
def plain_ring():
    """The plain versions in place of K7 and of K8 + K9 (the ring looks
    them up on ``ops.flash_attention`` at each call); fails if a kernel
    launches inside."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    with mock.patch.object(fa, "flash_ring_step_carry", fa.flash_ring_step_carry_plain), \
            mock.patch.object(fa, "flash_ring_step_bwd", fa.flash_ring_step_bwd_plain):
        fa.reset_launch_counts()
        yield
        if any(fa.launch_counts().values()):
            fail(f"the plain ring launched kernels: {fa.launch_counts()}")


def rel_l2(got, want) -> float:
    return float(torch_norm(got - want) / torch_norm(want).clamp_min(1e-30))


def torch_norm(x):
    return x.float().pow(2).sum().sqrt()


LM_PATH_TOL = (LM_PATH_LOSS_RTOL, LM_PATH_GRAD_RTOL, LM_PATH_PARAM_MAX, LM_PATH_UPDATE_RTOL)


def lm_compare(first, second, staged, card, what, tol=LM_PATH_TOL):
    """From ``first``'s state, one forward/backward and then 3 steps on
    each of two runs, ``first`` and ``second``, each ``(trainer, context
    factory)`` (one trainer twice for phase 12, two trainers for phase
    16); fails past ``tol``: (losses, gradients, every parameter,
    updates), by default the LM_PATH_* tolerances."""
    loss_rtol, grad_rtol, param_max, update_rtol = tol
    import torch

    from elasticdl_tpu_torch.parallel.dp_trainer import DPTrainState, clone_tree

    (trainer_a, context_a), (trainer_b, context_b) = first, second
    live = trainer_a.state
    start = DPTrainState(live.step, clone_tree(live.params), clone_tree(live.opt_state), {})
    trainer_b.state = start
    with context_a():
        a_loss = trainer_a.forward(*staged[0])
        a_grads = trainer_a.backward(a_loss)
    with context_b():
        b_loss = trainer_b.forward(*staged[0])
        b_grads = trainer_b.backward(b_loss)
    grad_rel = {name: rel_l2(a_grads[name], g) for name, g in b_grads.items()}
    a_loss, b_loss = float(a_loss.detach()), float(b_loss.detach())
    loss0_rel = abs(a_loss - b_loss) / abs(b_loss)
    del a_grads, b_grads, a_loss, b_loss
    with context_a():
        a_losses, a_params = lm_path_steps(trainer_a, staged)
    trainer_b.state = start
    with context_b():
        b_losses, b_params = lm_path_steps(trainer_b, staged)
    loss_rel = max([loss0_rel] + [abs(a - b) / abs(b) for a, b in zip(a_losses, b_losses)])
    worst, diff_sq, moved_sq = 0.0, 0.0, 0.0
    for name, got in a_params.items():
        worst = max(worst, float((got - b_params[name]).abs().max()))
        diff_sq += float(torch_norm(got - b_params[name])) ** 2
        moved_sq += float(torch_norm(b_params[name] - start.params[name])) ** 2
    update_rel = (diff_sq / max(moved_sq, 1e-30)) ** 0.5
    del a_params, b_params, start
    torch.cuda.empty_cache()
    worst_grad = max(grad_rel, key=grad_rel.get)
    summary = (f"losses {a_losses} vs {b_losses} (max rel {loss_rel!r}); gradients "
               f"from one state: max rel L2 {grad_rel[worst_grad]!r} ({worst_grad}); after 3 "
               f"steps: params max diff {worst!r}, updates rel L2 {update_rel!r}")
    if not loss_rel <= loss_rtol:
        fail(f"{what}: {summary}")
    if not grad_rel[worst_grad] <= grad_rtol:
        fail(f"{what}: gradients differ: {summary}")
    if not (worst <= param_max and update_rel <= update_rtol):
        fail(f"{what}: parameters diverge: {summary}")
    log(f"{what}: {summary} [{card}]")
    return {"losses_a": a_losses, "losses_b": b_losses, "max_loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "max_param_diff": worst, "update_rel_l2": update_rel}


def lm_training_phases(card: str, seed: int, warmup: int = 2, steps: int = LM_STEPS,
                       n_batches: int = 8):
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    cfg, batch = LM_BENCH, LM_BATCH
    zoo = resolve(LM_DEF)
    t0 = time.perf_counter()
    tokens, nxt = synthetic_lm_arrays(batch * n_batches, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    batches = [(tokens[i * batch:(i + 1) * batch], nxt[i * batch:(i + 1) * batch], ones)
               for i in range(n_batches)]
    log(f"synthetic LM data: {tokens.shape} tokens, vocab {cfg['vocab']}, in "
        f"{time.perf_counter() - t0:.1f} s")
    params = dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                  num_layers=cfg["num_layers"], max_len=cfg["seq_len"])
    model = build_model(LM_DEF, params)  # the default device: the card
    trainer = DataParallelTrainer(model, zoo.loss, zoo.optimizer(LM_LR), seed=seed)
    if trainer.device.type != "cuda":
        fail(f"DataParallelTrainer's default device is {trainer.device}, not cuda")
    trainer.ensure_initialized()
    staged = [trainer.stage_batch(*b) for b in batches]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params.values())
    log(f"LM trainer initialised on {trainer.device}: {n_params} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    # phase 11: timed training
    losses = [trainer.train_step_staged(staged[i % n_batches]) for i in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step_staged(staged[i % n_batches]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg["num_layers"] * steps
    for name in fa.KERNELS:
        if counts[name] != want:
            fail(f"{name} launched {counts[name]} times in {steps} LM steps (want {want})")
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    losses = torch.stack(losses).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        fail(f"non-finite LM loss: {losses}")
    first, last = float(losses[:3].mean()), float(losses[-3:].mean())
    if not last < first:
        fail(f"the LM loss did not fall: first 3 steps {first!r}, last 3 {last!r}")
    parts = lm_time_parts(trainer, staged[0])
    train = {
        "tokens_per_s": steps * batch * cfg["seq_len"] / wall,
        "step_ms_median": step_ms[len(step_ms) // 2],
        "loss_first3": first, "loss_last3": last,
        "breakdown_ms": parts, "peak_memory_gb": peak / 1e9,
        "launches_step": counts,
    }
    log(f"LM train: {steps} steps of {batch}x{cfg['seq_len']}: {train['tokens_per_s']!r} "
        f"tokens/s, step median {train['step_ms_median']!r} ms (device, CUDA events); loss "
        f"{first!r} -> {last!r}; launches {counts}; peak {peak / 1e9!r} GB; one step's "
        f"parts {parts} [{card}]")
    log("LM step's attention kernels (device ms in one step, CUDA events): " + ", ".join(
        f"{name} {ms!r}" for name, ms in parts["kernel_ms"].items())
        + f"; {parts['attention_kernels']!r} of {parts['step']!r} [{card}]")

    # the staged window
    window = trainer.stage_window(batches[:4])
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    window_losses = trainer.train_window(window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window_counts = fa.launch_counts()
    if any(window_counts[name] != 4 * cfg["num_layers"] for name in fa.KERNELS):
        fail(f"a train_window of 4 steps launched {window_counts}")
    if not bool(torch.isfinite(window_losses).all()):
        fail("non-finite loss in the LM window")
    train["window_tokens_per_s"] = 4 * batch * cfg["seq_len"] / wall
    train["launches_window"] = window_counts
    log(f"LM train window: 4 staged steps: {train['window_tokens_per_s']!r} tokens/s (host "
        f"wall), launches {window_counts} [{card}]")
    del window

    # phase 12: kernels against plain versions on the path
    train["path"] = lm_compare((trainer, contextlib.nullcontext), (trainer, plain_attention),
                               staged, card, "LM kernel path vs plain path")
    del trainer, staged, model
    torch.cuda.empty_cache()
    return train


# ----------------------------------------------------------------------
# phase 13: the ring-step kernels (K7-K9) against the plain versions
# ----------------------------------------------------------------------


def ring_bound_ms(b, h, tq, tk, d, pairs, elem_bytes, do_bytes):
    """Least time of K7, K8 and K9 on one step: the larger of the
    operations over the bf16 peak and the bytes over the memory rate.
    ``pairs``: the (query, key) pairs this step's positions leave
    unmasked.  Operations, on phase 10's split: forward 4*B*H*D per pair,
    K8 dQ 2, K9 S, dP, dV, dK 8.  Bytes: q, k, v in their dtype, dO in
    the dtype the kernel reads (``do_bytes``: 2 for the path's bf16, 4
    for f32), acc read and written (K7), lse and delta, dq or dk and dv
    written f32, the positions."""
    unit = b * h * d * pairs
    qkv = (tq + 2 * tk) * b * h * d * elem_bytes
    q_rows, q_f32, k_f32 = b * h * tq * 4, b * h * tq * d * 4, b * h * tk * d * 4
    q_do = b * h * tq * d * do_bytes
    pos = (tq + tk) * 4

    def bound(ops, nbytes):
        op_ms, byte_ms = ops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"

    return {
        "flash_ring_step_carry": bound(4 * unit, qkv + 2 * q_f32 + 2 * q_rows + pos),
        "flash_ring_step_dq": bound(2 * unit, qkv + q_do + q_f32 + 2 * q_rows + pos),
        "flash_ring_step_dkv": bound(8 * unit, qkv + q_do + 2 * q_rows + 2 * k_f32 + pos),
    }


def unmasked_pairs(q_pos, k_pos, causal) -> int:
    if not causal:
        return q_pos.numel() * k_pos.numel()
    return int((k_pos[None, :] <= q_pos[:, None]).sum())


def ring_step_inputs(gen, dev, b, tq, tk, h, d, dtype):
    """q as the ring passes it (a transposed view of [B, T, H, D]), the
    K/V block contiguous [B, H, Tk, D], dO f32 [B, H, Tq, D]."""
    import torch

    q = torch.randn((b, tq, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, h, tk, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    do = torch.randn((b, h, tq, d), generator=gen, device=dev)
    return q, k, v, do


def ring_close(name, got, want, dtype):
    """The f32 outputs of K7-K9 on inputs of ``dtype``: from f16 inputs
    each (the carry, dq, dk, dv) to phase 51's f16 rule without its
    subnormal floor (ATTN_F16_*: f32 outputs have no f16 subnormals, and
    at dO x 2**-20 the floor would pass any dq); K7's carry from bf16
    inputs to RING_CARRY_TOL; every other to ATTN_F32_*."""
    import torch

    if dtype == torch.float16:
        return attention_close(name, got, want, (ATTN_F16_RTOL, ATTN_F16_ATOL_SHARE))
    carry = name.startswith("acc") and dtype == torch.bfloat16
    return attention_close(name, got, want, RING_CARRY_TOL if carry else None)


def check_ring_ring(fa, q, k, v, do, positions, causal, scale, what, path_do=None):
    """One slot's whole ring: K7 step by step from the plain version's
    carry (each step from the same carry), then K8 and K9 at every step
    from the final lse and delta, on ``do`` (f32) and, with bf16 or f16
    inputs, again on the path's dO in q's dtype (``path_do``, default
    ``do`` rounded to it), with delta from each (ring_close's
    tolerances; with f16 inputs no gradient entry flushed to zero where
    the plain version's is not, f16_zero_flushes).  A fully masked step
    must leave the carry bit for bit, and a row that saw no key in the
    ring (final lse NEG_INF) must get dq = 0 from K8.  Returns the max
    abs errors over both dOs and ``unseen_rows``, the count of such
    rows."""
    import torch

    f32 = q.dtype == torch.float32
    errs = dict.fromkeys(fa.RING_KERNELS, 0.0)
    b, h, tq, d = q.shape
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, tq, 1), -1e30, dtype=torch.float32, device=q.device)
    q_pos, k_steps = positions
    for step, k_pos in enumerate(k_steps):
        a_k, l_k = acc.clone(), lse.clone()
        fa.flash_ring_step_carry(q, k, v, a_k, l_k, q_pos, k_pos, causal=causal, scale=scale)
        masked = causal and int(k_pos.min()) > int(q_pos.max())
        fa.flash_ring_step_carry_plain(q, k, v, acc, lse, q_pos, k_pos, causal=causal,
                                       scale=scale)
        torch.cuda.synchronize()
        if masked and not (bit_equal(a_k, acc) and bit_equal(l_k, lse)):
            fail(f"flash_ring_step_carry changed the carry on a fully masked step ({what})")
        lse_err = float((l_k - lse).abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"flash_ring_step_carry lse differs from its plain version by {lse_err!r} "
                 f"({what}, step {step})")
        errs["flash_ring_step_carry"] = max(
            errs["flash_ring_step_carry"], lse_err,
            ring_close(f"acc {what} step {step}", a_k, acc, q.dtype))
    unseen = lse[..., 0] <= UNSEEN_LSE
    errs["unseen_rows"] = int(unseen.sum())
    dos = [do] if f32 else [do, do.to(q.dtype) if path_do is None else path_do]
    for g in dos:
        delta = torch.sum(g.float() * acc.to(q.dtype).to(torch.float32), dim=-1, keepdim=True)
        g_what = f"{what}, dO {str(g.dtype)[6:]}"
        for step, k_pos in enumerate(k_steps):
            got = fa.flash_ring_step_bwd(q, k, v, g, lse, delta, q_pos, k_pos, causal=causal,
                                         scale=scale)
            want = fa.flash_ring_step_bwd_plain(q, k, v, g, lse, delta, q_pos, k_pos,
                                                causal=causal, scale=scale)
            torch.cuda.synchronize()
            if bool((got[0][unseen] != 0.0).any()):
                fail(f"flash_ring_step_dq gave a row that saw no key a gradient ({g_what}, "
                     f"step {step})")
            if q.dtype == torch.float16:
                flushed = {name: f16_zero_flushes(a, b)
                           for name, a, b in zip(("dq", "dk", "dv"), got, want)}
                if any(flushed.values()):
                    fail(f"{g_what} step {step}: f16 ring gradients flushed to zero where the "
                         f"plain version's are not: {flushed}")
            errs["flash_ring_step_dq"] = max(errs["flash_ring_step_dq"], ring_close(
                f"dq {g_what} step {step}", got[0], want[0], q.dtype))
            errs["flash_ring_step_dkv"] = max(
                errs["flash_ring_step_dkv"],
                ring_close(f"dk {g_what} step {step}", got[1], want[1], q.dtype),
                ring_close(f"dv {g_what} step {step}", got[2], want[2], q.dtype))
    return errs


def ring_edges(fa, gen, dev, card):
    """RING_EDGE_SHAPES with random positions (any order), on a q that is
    a transposed view: correctness only."""
    import torch

    worst = dict.fromkeys(fa.RING_KERNELS, 0.0)
    for b, tq, tk, h, d, dtype, causal in RING_EDGE_SHAPES:
        what = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {dtype} {'causal' if causal else 'full'}"
        q, k, v, do = ring_step_inputs(gen, dev, b, tq, tk, h, d, getattr(torch, dtype))
        q_pos = torch.randint(0, tq + tk, (tq,), generator=gen, device=dev, dtype=torch.int32)
        k_steps = [torch.randint(0, tq + tk, (tk,), generator=gen, device=dev,
                                 dtype=torch.int32) for _ in range(2)]
        k_steps.append(q_pos.max() + 1 + k_steps[0])  # a fully masked step
        errs = check_ring_ring(fa, q, k, v, do, (q_pos, k_steps), causal,
                               fa.default_scale(d), what)
        worst = {name: max(worst[name], errs[name]) for name in worst}
    # Rows that see no key in the whole ring (a causal ring never makes
    # one): queries 0-39 against keys from 40 on.  They keep the carry
    # (lse NEG_INF) and K8/K9 give them no gradient, as the plain versions
    # do (the Pallas formula gives their masked keys P = 1).
    q, k, v, do = ring_step_inputs(gen, dev, 1, 130, 64, 2, 64, torch.bfloat16)
    q_pos = torch.arange(130, device=dev, dtype=torch.int32)
    k_steps = [40 + torch.randperm(64, generator=gen, device=dev).to(torch.int32),
               200 + torch.arange(64, device=dev, dtype=torch.int32)]
    errs = check_ring_ring(fa, q, k, v, do, (q_pos, k_steps), True, fa.default_scale(64),
                           "rows that see no key")
    if errs["unseen_rows"] != 2 * 40:
        fail(f"the no-key edge case has {errs['unseen_rows']} unseen rows, not 80")
    worst = {name: max(worst[name], errs[name]) for name in worst}
    errs = ring_unaligned_edge(fa, gen, dev)
    worst = {name: max(worst[name], errs[name]) for name in worst}
    log(f"kernels K7-K9 at the edge shapes ({len(RING_EDGE_SHAPES)} shapes, random positions, "
        f"80 rows that see no key, and a q and K/V block 2 bytes past a 16-byte boundary): "
        f"within tolerance, max abs errors {worst} [{card}]")
    return worst


#: cudaErrorMisalignedAddress, which the bf16 K7-K9 launchers return for
#: a pointer or stride their 16-byte copies cannot take.
CUDA_ERROR_MISALIGNED = 716


def unaligned_copy(x):
    """A contiguous copy of ``x`` that starts one element past an
    allocation's (aligned) start: 2 bytes past a 16-byte boundary in
    bf16."""
    import torch

    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def ring_unaligned_edge(fa, gen, dev):
    """bf16 q and K/V block, and a bf16 dO, 2 bytes past a 16-byte
    boundary: the C entry points refuse them (cudaErrorMisalignedAddress,
    nothing launched, nothing written); through the wrappers, which copy
    them, K7-K9 launch and the ring holds to the plain versions as at the
    other edges."""
    import torch

    from elasticdl_tpu_torch.ops import _build

    b, tq, tk, h, d = 1, 130, 200, 2, 64
    q, k, v, do = ring_step_inputs(gen, dev, b, tq, tk, h, d, torch.bfloat16)
    do_u = unaligned_copy(do.to(torch.bfloat16))
    q_pos = torch.randint(0, tq + tk, (tq,), generator=gen, device=dev, dtype=torch.int32)
    k_pos = torch.randint(0, tq + tk, (tk,), generator=gen, device=dev, dtype=torch.int32)
    scale = fa.default_scale(d)
    rows = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    dq = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    code = _build.library().edl_ring_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do_u.data_ptr(), 1, rows.data_ptr(),
        rows.data_ptr(), dq.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        *fa._ring_shape_args(q, k, scale, True))
    torch.cuda.synchronize()
    if code != CUDA_ERROR_MISALIGNED or not bool((dq == 0.0).all()):
        fail(f"edl_ring_dq took a bf16 dO 2 bytes past a 16-byte boundary (returned {code}, "
             f"want {CUDA_ERROR_MISALIGNED}, dq untouched)")
    q, k, v = unaligned_copy(q), unaligned_copy(k), unaligned_copy(v)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    lse = torch.full((b, h, tq, 1), -1e30, dtype=torch.float32, device=dev)
    code = _build.library().edl_ring_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), lse.data_ptr(),
        q_pos.data_ptr(), k_pos.data_ptr(), *fa._ring_shape_args(q, k, scale, True))
    torch.cuda.synchronize()
    if code != CUDA_ERROR_MISALIGNED:
        fail(f"edl_ring_fwd took a bf16 q 2 bytes past a 16-byte boundary (returned {code}, "
             f"want {CUDA_ERROR_MISALIGNED})")
    if not (bool((acc == 0.0).all()) and bool((lse == -1e30).all())):
        fail("edl_ring_fwd refused a misaligned q but wrote the carry")
    before = fa.launch_counts()
    errs = check_ring_ring(fa, q, k, v, do, (q_pos, [k_pos, q_pos.max() + 1 + k_pos]), True,
                           scale, f"B={b} Tq={tq} Tk={tk} H={h} D={d} bf16 causal, unaligned",
                           path_do=do_u)
    launched = {name: n - before[name] for name, n in fa.launch_counts().items()}
    if any(launched[name] != 2 * (1 if name == "flash_ring_step_carry" else 2)
           for name in fa.RING_KERNELS):
        fail(f"K7-K9 did not launch on the unaligned inputs: {launched}")
    return errs


def check_ring_layouts(fa, ring, q, k, v, do, n, scale, shape):
    """Every step of every slot of a ring of ``n`` (q, K/V and dO drawn
    once, at the shard length), contiguous and zigzag causal positions;
    -> the max abs errors."""
    import torch

    t = q.shape[2]
    errs = dict.fromkeys(fa.RING_KERNELS, 0.0)
    for layout in ring.LAYOUTS:
        pos = [torch.from_numpy(ring.shard_positions(i, t, n, layout)).to(q.device, torch.int32)
               for i in range(n)]
        for my in range(n):
            k_steps = [pos[(my - step) % n] for step in range(n)]
            got = check_ring_ring(fa, q, k, v, do, (pos[my], k_steps), True, scale,
                                  f"{shape} {layout} shard {my}")
            errs = {name: max(errs[name], got[name]) for name in errs}
    return errs


def efficient_attention_ms(q, k, v, do, q_pos, k_pos, flush):
    """PyTorch's memory-efficient attention on the step's inputs, with
    the step's positional mask as ``attn_bias`` and the logsumexp asked
    for: the nearest one call to K7's partial (K7's combine with the
    carry is not in it), and its backward, the nearest to K8 + K9.  A
    yardstick only: the port never calls it."""
    import torch

    op = torch.ops.aten._scaled_dot_product_efficient_attention
    qc = q.contiguous()
    bias = torch.zeros((q.shape[0], q.shape[1], q.shape[2], k.shape[2]), dtype=q.dtype,
                       device=q.device)
    bias.masked_fill_(k_pos[None, :] > q_pos[:, None], float("-inf"))
    fwd = median_ms(lambda: op(qc, k, v, bias, True), flush)
    leaves = [x.detach().requires_grad_(True) for x in (qc, k, v)]
    g = do.to(q.dtype)

    def fwd_bwd():
        out = op(*leaves, bias, True)[0]
        torch.autograd.grad(out, leaves, g)

    bwd = median_ms(fwd_bwd, flush) - fwd
    del bias
    return fwd, bwd


def ring_step_ops(b, h, d, pairs):
    """The operations ring_bound_ms gives each of K7-K9 (a kernel's
    TFLOP/s is these over its time)."""
    unit = b * h * d * pairs
    return {"flash_ring_step_carry": 4 * unit, "flash_ring_step_dq": 2 * unit,
            "flash_ring_step_dkv": 8 * unit}


def unmasked_step_positions(ring, dev, t, n):
    """(q_pos, k_pos) of the ring's unmasked step: shard 1 against shard
    0's block, contiguous."""
    import torch

    return tuple(torch.from_numpy(ring.shard_positions(i, t, n, "contiguous")).to(
        dev, torch.int32) for i in (1, 0))


def ring_step_times(fa, q, k, v, do, q_pos, k_pos, scale, flush, names=None):
    """{kernel: (ms, plain ms)} of ``names`` (default K7-K9) on one step,
    K8 and K9 on ``do`` as given, from the plain version's final lse and
    delta."""
    import torch

    b, h, t, d = q.shape
    kw = dict(causal=True, scale=scale)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t, 1), -1e30, dtype=torch.float32, device=q.device)
    fa.flash_ring_step_carry_plain(q, k, v, acc, lse, q_pos, k_pos, **kw)
    delta = torch.sum(do.float() * acc.to(q.dtype).to(torch.float32), dim=-1, keepdim=True)
    a_k, l_k = acc.clone(), lse.clone()
    rows = (lse[..., 0], delta[..., 0])
    calls = {
        "flash_ring_step_carry": (
            lambda: fa.flash_ring_step_carry(q, k, v, a_k, l_k, q_pos, k_pos, **kw),
            lambda: fa.flash_ring_step_carry_plain(q, k, v, acc, lse, q_pos, k_pos, **kw)),
        "flash_ring_step_dq": (
            lambda: fa.flash_ring_step_dq(q, k, v, do, lse, delta, q_pos, k_pos, **kw),
            lambda: fa.flash_ring_step_dq_plain(q, k, v, do, *rows, q_pos, k_pos, **kw)),
        "flash_ring_step_dkv": (
            lambda: fa.flash_ring_step_dkv(q, k, v, do, lse, delta, q_pos, k_pos, **kw),
            lambda: fa.flash_ring_step_dkv_plain(q, k, v, do, *rows, q_pos, k_pos, **kw)),
    }
    return {name: (median_ms(calls[name][0], flush),
                   median_ms(calls[name][1], flush, PLAIN_REPS, PLAIN_WARMUP))
            for name in names or fa.RING_KERNELS}


def ring_slot_timing(fa, ring, gen, dev, flush, card):
    """K7-K9 timed at the CP LM's slot shape (bf16, the head_dim-64
    builds; K8 and K9 on the path's bf16 dO), its unmasked step, beside
    their plain versions, bounds and the memory-efficient forward and
    backward (the latter the yardstick of K8 + K9 on the CP LM's path)."""
    import torch

    b, t, h, d = CP_SLOT_SHAPE
    q, k, v, do = ring_step_inputs(gen, dev, b, t, t, h, d, torch.bfloat16)
    do = do.to(torch.bfloat16)
    q_pos, k_pos = unmasked_step_positions(ring, dev, t, CP_MESH[1])
    times = ring_step_times(fa, q, k, v, do, q_pos, k_pos, fa.default_scale(d), flush)
    lib, lib_bwd = efficient_attention_ms(q, k, v, do, q_pos, k_pos, flush)
    pairs = unmasked_pairs(q_pos, k_pos, True)
    bounds = ring_bound_ms(b, h, t, t, d, pairs, 2, 2)
    ops = ring_step_ops(b, h, d, pairs)
    shape = (f"B={b} Tq=Tk={t} H={h} D={d} bf16, dO bf16, unmasked step (contiguous, shard 1 "
             f"vs shard 0)")
    out = {}
    for name, (ms, plain) in times.items():
        tflops = ops[name] / ms * 1e-9
        out[name] = {"shape": shape, "ms": ms, "plain_ms": plain, "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "tflop_per_s": tflops,
                     "library_ms": lib if name == "flash_ring_step_carry" else lib_bwd}
        log(f"kernel {name}: {shape}: {ms!r} ms, {tflops!r} TFLOP/s (plain {plain!r} ms, bound "
            f"{bounds[name][0]!r} ms by {bounds[name][1]}) [{card}]")
    log(f"  efficient-attention yardstick at the CP slot: forward {lib!r} ms, backward (dq, dk, "
        f"dv) {lib_bwd!r} ms [{card}]")
    del q, k, v, do
    return out


def ring_kernel_phase(card: str, seed: int):
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel import ring_attention as ring

    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    edges = ring_edges(fa, gen, dev, card)
    cfg = RING_BENCH
    b, t, h, d, n = cfg["batch"], cfg["t_local"], cfg["heads"], cfg["head_dim"], cfg["steps"]
    scale = fa.default_scale(d)
    # The CP LM's slot shape (the head_dim-64 build), in bf16 and f32.
    cb, ct, ch, cd = CP_SLOT_SHAPE
    cp_errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        shape = f"B={cb} Tq=Tk={ct} H={ch} D={cd} {str(dtype)[6:]}"
        cp_errs[shape] = check_ring_layouts(
            fa, ring, *ring_step_inputs(gen, dev, cb, ct, ct, ch, cd, dtype), CP_MESH[1],
            fa.default_scale(cd), shape)
        log(f"kernels K7-K9 at the CP LM's slot shape {shape}, every step of a ring of "
            f"{CP_MESH[1]}, contiguous and zigzag (causal): within tolerance, max abs errors "
            f"{cp_errs[shape]} [{card}]")
    torch.cuda.empty_cache()

    q, k, v, do = ring_step_inputs(gen, dev, b, t, t, h, d, torch.bfloat16)
    shape = f"B={b} Tq=Tk={t} H={h} D={d} bf16"
    errs = check_ring_layouts(fa, ring, q, k, v, do, n, scale, shape)
    full_pos = torch.arange(t, device=dev, dtype=torch.int32)
    got = check_ring_ring(fa, q, k, v, do, (full_pos, [full_pos]), False, scale,
                          f"{shape} full")
    errs = {name: max(errs[name], got[name]) for name in errs}
    log(f"kernels K7-K9 at {shape}, every step of a ring of {n}, contiguous and zigzag "
        f"(causal) and one full step: within tolerance, max abs errors {errs} [{card}]")

    # timed at the unmasked step: shard 1 against shard 0's block; K8 and
    # K9 on the path's bf16 dO and on an f32 dO
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    q_pos, k_pos = unmasked_step_positions(ring, dev, t, n)
    times = ring_step_times(fa, q, k, v, do.to(torch.bfloat16), q_pos, k_pos, scale, flush)
    f32_dout = ring_step_times(fa, q, k, v, do, q_pos, k_pos, scale, flush, fa.RING_KERNELS[1:])
    lib_fwd, lib_bwd = efficient_attention_ms(q, k, v, do, q_pos, k_pos, flush)
    pairs = unmasked_pairs(q_pos, k_pos, True)
    bounds = ring_bound_ms(b, h, t, t, d, pairs, 2, 2)
    f32_bounds = ring_bound_ms(b, h, t, t, d, pairs, 2, 4)
    ops = ring_step_ops(b, h, d, pairs)
    timed = f"{shape}, unmasked step (contiguous, shard 1 vs shard 0's block)"
    results = {}
    for name in fa.RING_KERNELS:
        ms, plain = times[name]
        tflops = ops[name] / ms * 1e-9
        results[name] = {
            "max_abs_err": max([errs[name]] + [e[name] for e in cp_errs.values()]),
            "ring_bench_max_abs_err": errs[name],
            "cp_slot_max_abs_err": {s: e[name] for s, e in cp_errs.items()},
            "edge_shapes_max_abs_err": edges[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "tflop_per_s": tflops,
            "library_ms": lib_fwd if name == "flash_ring_step_carry" else lib_bwd,
            "shape": timed + (", dO bf16 (the path's)" if name != "flash_ring_step_carry"
                              else ""),
        }
        log(f"kernel {name}: {results[name]['shape']}: {ms!r} ms, {tflops!r} TFLOP/s (plain "
            f"{plain!r} ms, bound {bounds[name][0]!r} ms by {bounds[name][1]}) [{card}]")
        if name != "flash_ring_step_carry":
            ms32, plain32 = f32_dout[name]
            results[name]["f32_dout"] = {
                "ms": ms32, "plain_ms": plain32, "bound_ms": f32_bounds[name][0],
                "bound_by": f32_bounds[name][1], "tflop_per_s": ops[name] / ms32 * 1e-9}
            log(f"kernel {name}: {timed}, dO f32: {ms32!r} ms, {ops[name] / ms32 * 1e-9!r} "
                f"TFLOP/s (plain {plain32!r} ms, bound {f32_bounds[name][0]!r} ms by "
                f"{f32_bounds[name][1]}) [{card}]")
    log(f"  efficient-attention yardstick (bias = the step's mask, lse): forward {lib_fwd!r} "
        f"ms, backward (dq, dk, dv) {lib_bwd!r} ms [{card}]")
    del q, k, v, do
    torch.cuda.empty_cache()
    for name, slot in ring_slot_timing(fa, ring, gen, dev, flush, card).items():
        results[name]["cp_slot_timing"] = slot
    del flush
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# phase 14: the ring against the whole sequence
# ----------------------------------------------------------------------


def in_process_mesh(data: int, model: int):
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices

    return build_mesh(MeshConfig(data, model), devices=virtual_devices(data * model,
                                                                       card_device()))


def ring_whole_phase(card: str, seed: int):
    """An in-process ring of RING_SLOTS slots (K7 forward, K8 + K9
    backward) against K4-K6 on the whole sequence, causal, both layouts:
    the output and the gradients of sum(out * dO), within phase 10's
    tolerances."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel import ring_attention as ring

    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 14)
    b, t, h, d = RING_WHOLE_SHAPE
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    want = [out.detach()] + list(torch.autograd.grad(out, leaves, do))
    mesh = in_process_mesh(1, RING_SLOTS)
    shape = f"B={b} T={t} H={h} D={d} bf16 causal, {RING_SLOTS} slots"
    result = {"shape": shape}
    for layout in ring.LAYOUTS:
        fa.reset_launch_counts()
        out = ring.ring_self_attention(mesh, *leaves, causal=True, layout=layout)
        got = [out.detach()] + list(torch.autograd.grad(out, leaves, do))
        counts = fa.launch_counts()
        if any(counts[name] != RING_SLOTS * RING_SLOTS for name in fa.RING_KERNELS):
            fail(f"the {layout} ring launched {counts} (want {RING_SLOTS ** 2} of each of "
                 f"K7-K9)")
        result[layout] = {name: attention_close(f"ring {layout} {name} ({shape})", g, w)
                          for name, g, w in zip(("out", "dq", "dk", "dv"), got, want)}
        log(f"ring ({layout}) vs K4-K6 on the whole sequence, {shape}: within tolerance, max "
            f"abs errors {result[layout]} [{card}]")
        del out, got
    del q, k, v, do, leaves, want
    torch.cuda.empty_cache()
    return result


# ----------------------------------------------------------------------
# phases 15-16: the context-parallel LM trained by DataParallelTrainer
# ----------------------------------------------------------------------


def cp_lm_phases(card: str, seed: int):
    """Phase 15: the CP LM trained in both layouts (timed, launches
    counted, the loss must fall); phase 16: from one state, 3 steps of CP
    against the one-card trainer (K4-K6 on the whole sequence), f32 and
    bf16, and the bf16 pair again with the plain versions, at
    CP_GATE_BATCH rows and CP_GATE_LAYERS layers."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel import ring_attention as ring
    from elasticdl_tpu_torch.parallel.dp_trainer import (
        DataParallelTrainer,
        DPTrainState,
        clone_tree,
    )
    from elasticdl_tpu_torch.zoo import build_model, resolve

    cfg, batch, (data, slots) = CP_LM, CP_BATCH, CP_MESH
    zoo = resolve(LM_DEF)
    tokens, nxt = synthetic_lm_arrays(batch * CP_BATCHES, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    batches = [(tokens[i * batch:(i + 1) * batch], nxt[i * batch:(i + 1) * batch], ones)
               for i in range(CP_BATCHES)]
    params = dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                  num_layers=cfg["num_layers"], max_len=cfg["seq_len"])
    mesh = in_process_mesh(data, slots)
    per_step = cfg["num_layers"] * slots * slots
    results = {}
    for layout in ring.LAYOUTS:
        model = build_model(LM_DEF, dict(params, mesh=mesh, cp_layout=layout))
        trainer = DataParallelTrainer(model, zoo.loss, zoo.optimizer(LM_LR), mesh=mesh,
                                      seed=seed)
        if trainer.device != card_device():
            fail(f"the CP trainer runs on {trainer.device}, not on the card")
        trainer.ensure_initialized()
        staged = [trainer.stage_batch(*b) for b in batches]
        losses = [trainer.train_step_staged(staged[i % CP_BATCHES]) for i in range(CP_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        events = []
        t0 = time.perf_counter()
        for i in range(CP_WARMUP, CP_WARMUP + CP_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(trainer.train_step_staged(staged[i % CP_BATCHES]))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for name in fa.RING_KERNELS:
            if counts[name] != per_step * CP_STEPS:
                fail(f"{name} launched {counts[name]} times in {CP_STEPS} CP steps ({layout}; "
                     f"want {per_step * CP_STEPS})")
        if any(counts[name] for name in fa.KERNELS):
            fail(f"the CP path ({layout}) launched a whole-sequence kernel: {counts}")
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)):
            fail(f"non-finite CP LM loss ({layout}): {losses}")
        first, last = float(losses[:3].mean()), float(losses[-3:].mean())
        if not last < first:
            fail(f"the CP LM loss did not fall ({layout}): first 3 steps {first!r}, last 3 "
                 f"{last!r}")
        step_ms = sorted(s.elapsed_time(e) for s, e in events)
        parts = lm_time_parts(trainer, staged[0], fa.RING_KERNELS)
        results[layout] = {
            "tokens_per_s": CP_STEPS * batch * cfg["seq_len"] / wall,
            "step_ms_median": step_ms[len(step_ms) // 2],
            "loss_first3": first, "loss_last3": last,
            "breakdown_ms": parts, "peak_memory_gb": peak / 1e9,
            "launches": counts, "launches_per_step": per_step,
        }
        log(f"CP LM train ({layout}, mesh {data}x{slots} in-process): {CP_STEPS} steps of "
            f"{batch}x{cfg['seq_len']}: {results[layout]['tokens_per_s']!r} tokens/s, step "
            f"median {results[layout]['step_ms_median']!r} ms (device, CUDA events); loss "
            f"{first!r} -> {last!r}; launches {counts}; peak {peak / 1e9!r} GB; one step's parts "
            f"{parts} [{card}]")
        log(f"CP LM step's ring kernels ({layout}; device ms in one step, CUDA events): "
            + ", ".join(f"{name} {ms!r}" for name, ms in parts["kernel_ms"].items())
            + f"; {parts['attention_kernels']!r} of {parts['step']!r} (forward "
            f"{parts['forward']!r}, backward {parts['backward']!r}) [{card}]")

        del trainer, model, staged
        torch.cuda.empty_cache()

        # phase 16: the CP path against the one-card path, from one state.
        # With f32 blocks the ring only regroups the f32 sums of K4-K6:
        # phase 12's tolerances.  In bf16, CP_BF16_TOL, and the same
        # comparison with the plain versions on both sides is the witness
        # that the gap is the two paths' arithmetic, not a kernel's fault.
        for use_bf16 in (False, True):
            kind = "bf16" if use_bf16 else "f32"
            model_params = dict(params, num_layers=CP_GATE_LAYERS, use_bf16=use_bf16)
            cp_trainer = DataParallelTrainer(
                build_model(LM_DEF, dict(model_params, mesh=mesh, cp_layout=layout)), zoo.loss,
                zoo.optimizer(LM_LR), mesh=mesh, seed=seed)
            one_card = DataParallelTrainer(build_model(LM_DEF, model_params,
                                                       device=card_device()),
                                           zoo.loss, zoo.optimizer(LM_LR), seed=seed,
                                           device=card_device())
            cp_trainer.ensure_initialized()
            one_card.ensure_initialized()
            cut = CP_GATE_BATCH
            staged = [cp_trainer.stage_batch(t[:cut], n[:cut], m[:cut])
                      for t, n, m in batches[:3]]
            start = DPTrainState(0, clone_tree(cp_trainer.state.params),
                                 clone_tree(cp_trainer.state.opt_state), {})
            what = (f"CP LM ({layout}, {kind}, ring K7-K9) vs one-card LM ({kind}, K4-K6 on "
                    f"T={cfg['seq_len']}), {CP_GATE_LAYERS} of {cfg['num_layers']} layers")
            results[layout][f"vs_one_card_{kind}"] = lm_compare(
                (cp_trainer, contextlib.nullcontext), (one_card, contextlib.nullcontext), staged,
                card, what, CP_BF16_TOL if use_bf16 else LM_PATH_TOL)
            if use_bf16:
                cp_trainer.state = start
                results[layout]["vs_one_card_bf16_plain"] = lm_compare(
                    (cp_trainer, plain_ring), (one_card, plain_attention), staged, card,
                    f"the witness: plain CP LM ({layout}, bf16, the plain versions of K7-K9) "
                    f"vs plain one-card LM (bf16, the plain versions of K4-K6)", CP_BF16_TOL)
            del cp_trainer, one_card, staged, start
            torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# phase 17: K10, the block-gather probe, and its experiment script
# ----------------------------------------------------------------------


def block_gather_phase(card: str, seed: int):
    """K10 at the script's size against its plain version (clamped and
    wrapped indices included), timed like phase 2 beside its bound and
    ``index_select``; then the script's two selftests on the card and one
    default-mode and one ``--shard_map`` measurement, as functions.  The
    default mode is K10's main path: its launches are counted there."""
    import torch

    from elasticdl_tpu_torch.bench import exp_sparse_gather as bench
    from elasticdl_tpu_torch.ops import sparse_gather as sg
    from elasticdl_tpu_torch.parallel.packed import PackedSpec

    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    spec = PackedSpec(GATHER_VOCAB, 16)
    table = torch.rand(spec.rows_shape, generator=gen, device=dev)
    nb8 = spec.num_blocks // sg.BLOCK_ROWS
    b = torch.randint(0, nb8, (GATHER_IDS,), generator=gen, device=dev, dtype=torch.int32)
    edges = [nb8, nb8 + 5, 2**30, 2**31 - 1, -1, -2, -nb8 + 1, -nb8, -nb8 - 1, -2**31]
    b[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    got, want = sg.block_gather(table, spec, b), sg.block_gather_plain(table, spec, b)
    torch.cuda.synchronize()
    if not bit_equal(got, want):
        fail("block_gather (K10) differs from its plain version")
    err = float((got - want).abs().max())
    del got, want
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    rule = sg.block_index(spec, b)  # the library call gets the rule's indices
    blocks = table.view(-1, sg.BLOCK_ROWS, 128)
    nbytes = 2 * GATHER_IDS * sg.BLOCK_ROWS * 128 * 4 + 4 * GATHER_IDS
    result = {
        "shape": f"b [{GATHER_IDS}] (10 clamped or wrapped), table {list(spec.rows_shape)} "
                 f"= packed {list(spec.packed_shape)}",
        "max_abs_err": err,
        "ms": median_ms(lambda: sg.block_gather(table, spec, b), flush),
        "plain_ms": median_ms(lambda: sg.block_gather_plain(table, spec, b), flush),
        "library_ms": median_ms(lambda: blocks.index_select(0, rule), flush),
        "bound_ms": bound_ms(nbytes),
    }
    log(f"kernel block_gather (K10): {result['shape']}: bit-exact with the plain version, "
        f"{result['ms']!r} ms (plain {result['plain_ms']!r} ms, index_select "
        f"{result['library_ms']!r} ms, bound {result['bound_ms']!r} ms) [{card}]")
    del table, blocks, rule, b, flush
    torch.cuda.empty_cache()
    bench.selftest("cuda")
    bench.selftest_shard_map("cuda")
    sg.reset_launch_counts()
    result["script"] = bench.main(GATHER_IDS, GATHER_VOCAB)
    result["launches"] = sg.launch_counts()["block_gather"]
    if result["launches"] < 1:
        fail("the experiment script's default mode never launched block_gather (K10)")
    torch.cuda.empty_cache()
    result["script_shard_map"] = bench.main_shard_map(GATHER_IDS, GATHER_VOCAB)
    torch.cuda.empty_cache()
    log(f"exp_sparse_gather: K10 launched {result['launches']} times in the default mode's "
        f"{result['script']['block_gather_calls']} timed calls [{card}]")
    return result


# ----------------------------------------------------------------------
# phase 18: the sharded K1-K3 dispatch against the one-card kernels
# ----------------------------------------------------------------------


def device_launches(fn):
    """Device launches per call of ``fn`` from the profiler's records
    (None where the trace holds none)."""
    prof = profile_launches(fn)
    return None if prof is None else prof["launches"]


def sharded_lookup_checks(ske, spec, table, gen, dev, mesh, flush, counted, card):
    """The sharded K2 at 65,536 ids over ``mesh``: ``slots`` launches a
    call; bit-exact with the one-card K2 for ids in the table, and with
    the plain route (``fused_lookup_plain`` with the mesh) for every id:
    ids past both ends and near +-2**31 (no shard owns them: zeros), and
    again with a -0.0 and a NaN in the first row of two shards, which an
    id another shard owns reads times 0.0 (the JAX route's mask).  Timed
    beside the one-card call and the plain route; the call's device
    records from the profiler (its device launches)."""
    import torch

    slots = mesh.shape["model"]
    local_rows = spec.vocab_padded // slots
    ids = torch.randint(0, spec.vocab_size, (65_536,), generator=gen, device=dev,
                        dtype=torch.int32)
    got, counts = counted(lambda: ske.fused_lookup(spec, table, ids, mesh=mesh))
    if counts["fused_lookup"] != slots or not bit_equal(got, ske.fused_lookup(spec, table, ids)):
        fail(f"sharded fused_lookup: launches {counts}, or it differs from the one-card K2")
    outside = torch.tensor([-1, -7, spec.vocab_padded, spec.vocab_padded + 9, -2**31,
                            2**31 - 1], device=dev, dtype=torch.int32)
    if ske.fused_lookup(spec, table, outside, mesh=mesh).any():
        fail("sharded fused_lookup read a row for an id no shard owns")
    starts = [s * local_rows for s in range(slots)]
    edge_ids = ids.clone()
    edges = outside.tolist() + starts + [local_rows - 1, local_rows, spec.vocab_padded - 1,
                                         -2**31 + 1, 2**31 - 2]
    edge_ids[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)

    def against_plain(what):
        got = ske.fused_lookup(spec, table, edge_ids, mesh=mesh)
        want = ske.fused_lookup_plain(spec, table, edge_ids, mesh=mesh)
        torch.cuda.synchronize()
        if not bit_equal(got, want):
            fail(f"sharded fused_lookup differs from the plain route{what}: "
                 f"{first_difference(got, want)}")

    against_plain("")
    planted = torch.tensor(starts[1:3], device=dev)
    saved = table[planted].clone()
    table[planted[0], 0] = -0.0
    table[planted[1], 2] = float("nan")
    against_plain(" with a -0.0 and a NaN in two shards' first rows")
    table[planted] = saved
    r = {
        "shape": "ids [65536]", "launches_per_call": counts["fused_lookup"],
        "ms": median_ms(lambda: ske.fused_lookup(spec, table, ids, mesh=mesh), flush),
        "plain_ms": median_ms(lambda: ske.fused_lookup_plain(spec, table, ids, mesh=mesh), flush),
        "one_card_ms": median_ms(lambda: ske.fused_lookup(spec, table, ids), flush),
        "call_profile": profile_launches(lambda: ske.fused_lookup(spec, table, ids, mesh=mesh)),
    }
    prof = r["call_profile"]
    if prof is None or prof["launches"] > SHARDED_K2_DEVICE_LAUNCHES:
        fail(f"sharded fused_lookup: device records per call {json.dumps(prof)}, more than "
             f"{SHARDED_K2_DEVICE_LAUNCHES} launches (or none recorded)")
    r["device_launches_per_call"] = prof["launches"]
    log(f"sharded fused_lookup over {SHARD_MESH}: bit-exact with the one-card K2 in the table "
        f"and with the plain route for every id (edge ids; -0.0 and NaN in shard rows); "
        f"{r['ms']!r} ms (plain route {r['plain_ms']!r} ms, one card {r['one_card_ms']!r} ms), "
        f"{counts['fused_lookup']} K2 launches a call; device records per call: "
        f"{json.dumps(prof)} [{card}]")
    return r


def sharded_kernel_phase(card: str, seed: int, vocab: int = 1_000_000,
                         split_vocab: int = SPLIT_VOCAB):
    """Phase 2's 26M-row merged table over an in-process (1, 4) mesh
    (3.25M storage blocks: split): the sharded K2 and K1 against the
    one-card kernels, the sharded K3 against the one-card K3 for each of
    phase 5's kinds; the split layout's dim-1 table (20,313 blocks:
    replicated); each timed against the one-card call."""
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel import packed as pk

    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 18)
    mesh = in_process_mesh(*SHARD_MESH)
    slots = SHARD_MESH[1]
    spec = pk.PackedSpec(vocab * NUM_CAT, 1 + 8)
    if ske.table_partition_axis(spec.num_blocks, mesh) != "model":
        fail(f"{spec.num_blocks} storage blocks do not split over {slots} model slots")
    table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
    table.uniform_(-0.05, 0.05, generator=gen)
    table[:, spec.dim:] = 0.0
    table[spec.vocab_size:] = 0.0
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)

    def counted(fn):
        ske.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, ske.launch_counts()

    result = {"mesh": list(SHARD_MESH)}
    result["fused_lookup"] = sharded_lookup_checks(ske, spec, table, gen, dev, mesh, flush,
                                                   counted, card)
    # K1 at the training shape: acts equal (a zero may differ in sign where
    # no shard owns a field), the sums within the reduction-order bound.
    batch = TRAIN_BATCH
    cat = torch.randint(0, spec.vocab_size, (batch, NUM_CAT), generator=gen, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((batch, NUM_CAT), generator=gen, device=dev) > 0.05
    bet = torch.randn((batch, NUM_CAT, spec.dim), generator=gen, device=dev)
    worst = 0.0
    for b in (None, bet):
        got, counts = counted(lambda: ske.fused_lookup_fm(spec, table, b, cat, valid, mesh=mesh))
        want = ske.fused_lookup_fm(spec, table, b, cat, valid)
        if counts["fused_lookup_fm"] != slots or not torch.equal(got[0], want[0]):
            fail(f"sharded fused_lookup_fm: launches {counts}, or acts differ from the one-card K1")
        acts = want[0]
        terms = (acts[..., 0].abs().sum(-1), acts[..., 1:].abs().sum(1),
                 (acts[..., 1:] * acts[..., 1:]).sum(1))
        for name, g, w, t in zip(("first", "sum_v", "sum_sq"), got[1:], want[1:], terms):
            excess = (g - w).abs() - SUM_ORDER_ULPS * (NUM_CAT + slots) * t
            if float(excess.max()) > 0.0:
                fail(f"sharded fused_lookup_fm {name} differs from the one-card K1 by more than "
                     f"the reduction-order bound (excess {float(excess.max())!r})")
            worst = max(worst, float((g - w).abs().max()))
    result["fused_lookup_fm"] = {
        "shape": f"ids [{batch}, {NUM_CAT}] with bet", "launches_per_call": counts["fused_lookup_fm"],
        "max_abs_err_sums": worst,
        "ms": median_ms(lambda: ske.fused_lookup_fm(spec, table, bet, cat, valid, mesh=mesh),
                        flush),
        "one_card_ms": median_ms(lambda: ske.fused_lookup_fm(spec, table, bet, cat, valid), flush),
        "device_launches_per_call": device_launches(
            lambda: ske.fused_lookup_fm(spec, table, bet, cat, valid, mesh=mesh)),
    }
    del cat, valid, bet, got, want, acts
    # K3: every kind, two applies, bit-exact tables and slots.
    n = TRAIN_BATCH * NUM_CAT
    ids, grads, _ = k3_inputs(spec, gen, dev, n)
    result["fused_dedup_apply"] = {}
    for name, (kind, hyper) in K3_HYPER.items():
        t_mesh, s_mesh = table.clone(), k3_slots(kind, table)
        t_one, s_one = table.clone(), k3_slots(kind, table)
        with deterministic():
            for _ in range(2):
                _, counts = counted(lambda: ske.fused_dedup_apply(
                    spec, kind, hyper, t_mesh, s_mesh, ids, grads, mesh=mesh))
                ske.fused_dedup_apply(spec, kind, hyper, t_one, s_one, ids, grads)
        torch.cuda.synchronize()
        if counts["fused_dedup_apply"] != slots or not bit_equal(t_mesh, t_one) or not all(
                bit_equal(v.reshape(-1), s_one[k].reshape(-1)) for k, v in s_mesh.items()):
            fail(f"sharded fused_dedup_apply[{name}]: launches {counts}, or its table or slots "
                 "differ from the one-card K3")
        entry = {"launches_per_call": counts["fused_dedup_apply"]}
        if name == "adam":
            entry["ms"] = median_ms(lambda: ske.fused_dedup_apply(
                spec, kind, hyper, t_mesh, s_mesh, ids, grads, mesh=mesh), flush)
            entry["one_card_ms"] = median_ms(lambda: ske.fused_dedup_apply(
                spec, kind, hyper, t_one, s_one, ids, grads), flush)
            entry["device_launches_per_call"] = device_launches(lambda: ske.fused_dedup_apply(
                spec, kind, hyper, t_mesh, s_mesh, ids, grads, mesh=mesh))
        result["fused_dedup_apply"][name] = entry
        del t_mesh, s_mesh, t_one, s_one
        torch.cuda.empty_cache()
    del table
    torch.cuda.empty_cache()
    # The replicated route: the split layout's dim-1 table.
    spec1 = pk.PackedSpec(split_vocab * NUM_CAT, 1)
    if ske.table_partition_axis(spec1.num_blocks, mesh) is not None:
        fail(f"{spec1.num_blocks} storage blocks should not split over {slots}")
    table1 = torch.empty(spec1.rows_shape, dtype=torch.float32, device=dev)
    table1.uniform_(-0.05, 0.05, generator=gen)
    ids1 = torch.randint(-100, spec1.vocab_padded + 100, (65_536,), generator=gen, device=dev,
                         dtype=torch.int32)
    got, counts = counted(lambda: ske.fused_lookup(spec1, table1, ids1, mesh=mesh))
    if counts["fused_lookup"] != 1 or not bit_equal(got, ske.fused_lookup(spec1, table1, ids1)):
        fail(f"replicated fused_lookup: launches {counts}, or it differs from the one-card K2")
    g1 = torch.randn((65_536, 1), generator=gen, device=dev)
    t_mesh, s_mesh = table1.clone(), k3_slots("adam", table1)
    t_one, s_one = table1.clone(), k3_slots("adam", table1)
    _, counts = counted(lambda: ske.fused_dedup_apply(spec1, "adam", K3_HYPER["adam"][1], t_mesh,
                                                      s_mesh, ids1, g1, mesh=mesh))
    ske.fused_dedup_apply(spec1, "adam", K3_HYPER["adam"][1], t_one, s_one, ids1, g1)
    if counts["fused_dedup_apply"] != 1 or not bit_equal(t_mesh, t_one):
        fail(f"replicated fused_dedup_apply: launches {counts}, or it differs from the one-card K3")
    result["replicated"] = {"table": list(spec1.rows_shape), "blocks": spec1.num_blocks,
                            "launches_per_call": 1}
    del table1, t_mesh, s_mesh, t_one, s_one, flush
    torch.cuda.empty_cache()
    log(f"sharded K1-K3 over an in-process {SHARD_MESH} mesh: K2 bit-exact (ids no shard owns "
        f"read zeros), K1 acts equal, sums within the bound (max {worst!r}), K3 bit-exact for "
        f"{len(K3_HYPER)} kinds, the dim-1 table replicated (1 launch, bit-exact); "
        f"{json.dumps({k: v for k, v in result.items() if k != 'replicated'})} [{card}]")
    return result


# ----------------------------------------------------------------------
# phase 19: DeepFM PS training and serving over the mesh
# ----------------------------------------------------------------------


def mesh_training_phases(card: str, seed: int, workdir: str, params: str = TRAIN_PARAMS,
                         warmup: int = 3, steps: int = 20, n_batches: int = 24):
    """Phase 6's model and batch over an in-process (1, 4) mesh: timed
    steps (one K1 and one K3 launch per shard per step), 3 sharded steps
    against 3 one-card steps from one state (phase 7's tolerances), then
    export, a mesh-built ``ServingReplica`` serving phase 3's requests,
    and a hot swap to a ``split_tables`` artifact (dim-8 table split,
    dim-1 replicated)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer, clone_state
    from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.runtime import ServingReplica
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    mesh = in_process_mesh(*SHARD_MESH)
    slots = SHARD_MESH[1]
    model_params = parse_dict_params(params)
    vocab, batch = model_params["vocab_size"], TRAIN_BATCH
    feats, labels = synthetic_ctr_arrays(batch * n_batches + 256, vocab_size=vocab, seed=seed)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch], np.ones((batch,), np.float32))
               for i in range(n_batches)]
    held_out = {k: v[n_batches * batch:] for k, v in feats.items()}

    def trainer_for(model):
        return ShardedEmbeddingTrainer(model, zoo.loss, zoo.optimizer(),
                                       embedding_optimizer=zoo.embedding_optimizer(), seed=seed,
                                       mesh=getattr(model, "mesh", None))

    t0 = time.perf_counter()
    trainer = trainer_for(build_model(MODEL_DEF, dict(model_params, mesh=mesh)))
    if trainer.sparse_route != "shard_map" or \
            trainer.table_placement != {"fm_embedding/embedding": "model"}:
        fail(f"mesh trainer: route {trainer.sparse_route}, placement {trainer.table_placement}")
    trainer.ensure_initialized()
    staged = [trainer.stage_batch(*b) for b in batches]
    torch.cuda.synchronize()
    log(f"mesh trainer initialised over {mesh!r} in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    losses = [trainer.train_step_staged(staged[i % n_batches]) for i in range(warmup)]
    torch.cuda.synchronize()
    ske.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step_staged(staged[i % n_batches]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ske.launch_counts()
    for name in ("fused_lookup_fm", "fused_dedup_apply"):
        if counts[name] != slots * steps:
            fail(f"{name} launched {counts[name]} times in {steps} sharded steps "
                 f"({slots} shards)")
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not np.all(np.isfinite(losses)) or not last < first:
        fail(f"mesh training: the loss did not fall: first 5 steps {first!r}, last 5 {last!r}")
    result = {
        "mesh": list(SHARD_MESH), "samples_per_s": steps * batch / wall,
        "step_ms_median": step_ms[len(step_ms) // 2], "loss_first5": first, "loss_last5": last,
        "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
        "breakdown_ms": time_parts(trainer, staged[0]),
    }
    log(f"train over the mesh: {steps} steps of {batch}: {result['samples_per_s']!r} samples/s, "
        f"step median {result['step_ms_median']!r} ms (device, CUDA events); loss {first!r} -> "
        f"{last!r}; launches {counts}; one step's parts {result['breakdown_ms']} [{card}]")

    # sharded steps against one-card steps, from one state
    start = clone_state(trainer.state)
    tables0 = {key: t.clone() for key, t in start.tables.items()}
    mesh_losses, mesh_tables = path_steps(trainer, staged)
    one_card = trainer_for(build_model(MODEL_DEF, model_params))
    one_card.ensure_initialized()
    one_card.state = start
    del start
    one_losses, one_tables = path_steps(one_card, staged)
    del one_card
    result["vs_one_card"] = paths_agree("sharded path vs one-card path", mesh_losses, one_losses,
                                        mesh_tables, one_tables, tables0, card)

    # train -> serve over the mesh, then a hot swap to split tables
    out = export_model(trainer, os.path.join(workdir, "mesh_trained"), model_zoo="model_zoo",
                       model_def=MODEL_DEF, model_params=params)
    want = trainer.eval_step(held_out)
    del trainer, staged
    torch.cuda.empty_cache()
    replica = ServingReplica(out, mesh=mesh)
    if replica.stats()["tables"] != {"fm_embedding/embedding": "model"}:
        fail(f"mesh replica placed {replica.stats()['tables']}")
    got = replica.execute(held_out, len(want))[: len(want)]
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    dispatches = []

    def timed_execute(features, n_valid):
        t0 = time.perf_counter()
        try:
            return replica.execute(features, n_valid)
        finally:
            dispatches.append((time.perf_counter() - t0, n_valid))

    batcher = MicroBatcher(timed_execute, BatcherConfig(max_batch_size=64, max_wait_us=2000,
                                                         queue_limit=512)).start()
    rng = np.random.default_rng(seed)
    try:
        replica.warmup(make_requests(rng, vocab, 1, 1)[0], batcher.buckets)
        serve = serve_phase("serve over the mesh (merged)", replica, batcher,
                            make_requests(rng, vocab, 200, 8), card, dispatches)
        serve = {"launches": serve, "dispatches": len(dispatches)}
        if serve["launches"]["fused_lookup_fm"] != slots * len(dispatches):
            fail(f"serving over the mesh launched {serve['launches']} in {len(dispatches)} "
                 f"dispatches ({slots} shards of one table)")
        split = os.path.join(workdir, "gen2_split")
        if not os.path.exists(split):
            write_random_artifact(
                split, f"vocab_size={SPLIT_VOCAB},embedding_dim=8,hidden=128,split_tables=true",
                seed + 1)
        replica.reload(split)
        stats = replica.stats()
        if stats["tables"] != {"fm_embedding/embedding": "model",
                               "linear_embedding/embedding": None}:
            fail(f"hot swap over the mesh placed {stats['tables']}")
        log(f"hot swap over the mesh: {stats}")
        replica.warmup(make_requests(rng, SPLIT_VOCAB, 1, 1)[0], batcher.buckets)
        split_counts = serve_phase("serve over the mesh (split_tables)", replica, batcher,
                                   make_requests(rng, SPLIT_VOCAB, 200, 8), card, dispatches)
        # the dim-8 table's shards and the replicated dim-1 table
        if split_counts["fused_lookup"] != (slots + 1) * len(dispatches):
            fail(f"serving split tables over the mesh launched {split_counts} in "
                 f"{len(dispatches)} dispatches")
    finally:
        batcher.stop()
    result["serve"] = serve
    result["serve_split"] = {"launches": split_counts, "dispatches": len(dispatches)}
    del replica
    torch.cuda.empty_cache()
    return result


# ----------------------------------------------------------------------
# phase 20: the table-scale strict DeepFM in the split layout
# ----------------------------------------------------------------------


def split_training_phase(card: str, seed: int, workdir: str):
    """bench.py's bench_deepfm_table_scale_strict through the port's entry
    points: 26M rows in the split layout (K2 on both tables, K3 on both),
    batch 8192, strict, global-bias sparse Adam; 20 timed steps after 3,
    the launches per step, the loss, and 3 steps against the plain
    versions (phase 7's tolerances)."""
    from elasticdl_tpu_torch.parallel import sparse_optim

    return training_phases(
        card, seed, workdir, params=SPLIT_TRAIN_PARAMS, warmup=3, steps=20, n_batches=24,
        launches=SPLIT_TRAIN_LAUNCHES, name="train split strict (table scale)",
        embedding_optimizer=lambda: sparse_optim.adam(LR, bias_correction="global"),
        serve_and_window=False)


# ----------------------------------------------------------------------
# phases 21-23: checkpoints, the delta chain, the LM's resume
# ----------------------------------------------------------------------


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def require_free(workdir: str, nbytes: int, what: str) -> None:
    """Fail unless ``workdir``'s file system has ``nbytes`` free."""
    free = shutil.disk_usage(workdir).free
    if free < nbytes:
        fail(f"{what} needs {nbytes} bytes free in {workdir}, which has {free}")


def state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ps_state_tensors(trainer):
    """Every tensor of a PS trainer's state: tables, slots, dense params
    and the dense optimizer's state."""
    state = trainer.state
    out = list(state.tables.values()) + list(state.params.values())
    out += [v for group in state.slots.values() for v in group.values()]
    out += [state.opt_state["count"]] + list(state.opt_state["mu"].values()) \
        + list(state.opt_state["nu"].values())
    return out


def ps_states_bit_equal(a, b) -> list:
    """The names of the leaves where two PS trainers' states differ in any
    bit (the step included)."""
    sa, sb = a.state, b.state
    bad = [] if sa.step == sb.step else ["step"]
    pairs = [(f"table {k}", v, sb.tables[k]) for k, v in sa.tables.items()]
    pairs += [(f"param {k}", v, sb.params[k]) for k, v in sa.params.items()]
    pairs += [(f"slot {k}/{n}", v, sb.slots[k][n]) for k, g in sa.slots.items()
              for n, v in g.items()]
    pairs += [(f"opt {m}/{k}", v, sb.opt_state[m][k]) for m in ("mu", "nu")
              for k, v in sa.opt_state[m].items()]
    pairs.append(("opt count", sa.opt_state["count"], sb.opt_state["count"]))
    return bad + [name for name, x, y in pairs if not bit_equal(x.detach(), y.detach())]


def checkpoint_phases(card: str, seed: int, workdir: str, split_train=None,
                      n_batches: int = 12, keep: bool = False):
    """Phases 21-22 at phase 20's configuration (26M rows, split layout,
    batch 8192, strict, global-bias sparse Adam): train 5 steps, a sharded
    checkpoint, a resume into a trainer of another seed (bit-exact) and
    into one over the in-process (1, 4) mesh, 3 steps on both one-card
    trainers (phase 7's tolerances), 10 timed steps of each in turns; then the
    delta chain from the resumed trainer, served by a replica that
    applies it.  With ``keep``, returns ``(result, loop)``: the resumed
    trainer, its data and the replica, for phases 24-25."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.checkpoint import delta as deltas
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel import sparse_optim
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.runtime import ServingReplica
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    model_params = parse_dict_params(SPLIT_TRAIN_PARAMS)
    vocab, batch = model_params["vocab_size"], TRAIN_BATCH
    feats, labels = synthetic_ctr_arrays(batch * n_batches + 256, vocab_size=vocab, seed=seed)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch], np.ones((batch,), np.float32))
               for i in range(n_batches)]
    held_out = {k: v[n_batches * batch:] for k, v in feats.items()}
    held_labels = labels[n_batches * batch:]

    def trainer_for(trainer_seed, mesh=None):
        params = model_params if mesh is None else dict(model_params, mesh=mesh)
        return ShardedEmbeddingTrainer(
            build_model(MODEL_DEF, params), zoo.loss, zoo.optimizer(),
            embedding_optimizer=sparse_optim.adam(LR, bias_correction="global"),
            seed=trainer_seed, mesh=mesh)

    def steps(trainer, first, count):
        return [float(trainer.train_step_staged(staged[(first + i) % n_batches]))
                for i in range(count)]

    saved = trainer_for(seed)
    saved.ensure_initialized()
    staged = [saved.stage_batch(*b) for b in batches]
    steps(saved, 0, 5)
    torch.cuda.synchronize()

    # phase 21: save, resume bit-exact, resume over the mesh
    ckpt_dir = os.path.join(workdir, "ckpt")
    need = state_bytes(ps_state_tensors(saved))
    require_free(workdir, need + need // 10, "phase 21's checkpoint")
    saver = ShardedCheckpointSaver(ckpt_dir)
    t0 = time.perf_counter()
    saved.save_checkpoint(saver, saved.step)
    save_s = time.perf_counter() - t0
    written = dir_bytes(ckpt_dir)
    t0 = time.perf_counter()
    step = saver.latest_step()
    crc_s = time.perf_counter() - t0
    if step != 5:
        fail(f"latest_step() is {step}, the checkpoint's step 5")

    resumed = trainer_for(seed + 1)
    ptrs = {key: layer.embedding.data_ptr() for key, layer in resumed._layers.items()}
    t0 = time.perf_counter()
    resumed.set_sharded_restore(saver, step)
    resumed.ensure_initialized()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    moved = {k for k, t in resumed.state.tables.items() if t.data_ptr() != ptrs[k]}
    if moved:
        fail(f"the restore replaced the trainer's own tables {sorted(moved)}")
    differ = ps_states_bit_equal(saved, resumed)
    if differ:
        fail(f"the resumed trainer differs from the saved one in {differ}")

    mesh = in_process_mesh(*SHARD_MESH)
    on_mesh = trainer_for(seed + 2, mesh)
    t0 = time.perf_counter()
    on_mesh.set_sharded_restore(saver, step)
    on_mesh.ensure_initialized()
    torch.cuda.synchronize()
    mesh_restore_s = time.perf_counter() - t0
    if on_mesh.table_placement != {"fm_embedding/embedding": "model",
                                   "linear_embedding/embedding": None}:
        fail(f"the mesh trainer placed {on_mesh.table_placement}")
    differ = ps_states_bit_equal(saved, on_mesh)
    if differ:
        fail(f"the trainer resumed over the mesh differs from the saved one in {differ}")
    mesh_loss = steps(on_mesh, 5, 1)[0]
    del on_mesh
    torch.cuda.empty_cache()
    log(f"checkpoint at step {step}: saved {written} bytes ({written / 1e9!r} GB) in "
        f"{save_s!r} s; latest_step (CRC) {crc_s!r} s; restore {restore_s!r} s one card, "
        f"{mesh_restore_s!r} s over the {SHARD_MESH} mesh; both bit-exact [{card}]")

    tables0 = {key: t.clone() for key, t in saved.state.tables.items()}
    saved_losses = steps(saved, 5, 3)
    saved_tables = {key: t.clone() for key, t in saved.state.tables.items()}
    resumed_losses = steps(resumed, 5, 3)
    resumed_tables = {key: t.clone() for key, t in resumed.state.tables.items()}
    exact = saved_losses == resumed_losses and all(
        bit_equal(t, saved_tables[k]) for k, t in resumed_tables.items())
    agree = paths_agree("resumed vs saved trainer", resumed_losses, saved_losses,
                        resumed_tables, saved_tables, tables0, card)
    np.testing.assert_allclose(mesh_loss, saved_losses[0], rtol=PATH_LOSS_RTOL)
    log(f"resumed vs saved, 3 steps: bit-exact {exact}; the mesh trainer's step loss "
        f"{mesh_loss!r} vs {saved_losses[0]!r} [{card}]")

    def timed(trainer, first):
        """10 steps: (samples/s on the host clock, median step ms)."""
        events = []
        t0 = time.perf_counter()
        for i in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step_staged(staged[(first + i) % n_batches])
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return 10 * batch / wall, sorted(s.elapsed_time(e) for s, e in events)[5]

    # The saved and the resumed trainer in turns (saved, resumed, resumed,
    # saved) on the same batches: the rate a restore leaves, within one call.
    turns = {"saved": [timed(saved, 8)]}
    ske.reset_launch_counts()
    turns["resumed"] = [timed(resumed, 8)]
    counts = ske.launch_counts()
    for kernel, per_step in SPLIT_TRAIN_LAUNCHES.items():
        if counts[kernel] != per_step * 10:
            fail(f"the resumed trainer launched {kernel} {counts[kernel]} times in 10 steps")
    turns["resumed"].append(timed(resumed, 18))
    turns["saved"].append(timed(saved, 18))
    del saved
    torch.cuda.empty_cache()
    phase20 = None if split_train is None else split_train["samples_per_s"]
    result = {
        "step": step, "save_s": save_s, "bytes_written": written, "latest_step_crc_s": crc_s,
        "restore_s": restore_s, "mesh_restore_s": mesh_restore_s,
        "resumed_bit_exact_3_steps": exact, "resumed_vs_saved": agree,
        "mesh_loss": mesh_loss, "saved_loss": saved_losses[0],
        "resumed_samples_per_s": [r for r, _ in turns["resumed"]],
        "resumed_step_ms_median": [m for _, m in turns["resumed"]],
        "saved_samples_per_s": [r for r, _ in turns["saved"]],
        "saved_step_ms_median": [m for _, m in turns["saved"]],
        "phase20_samples_per_s": phase20, "launches_resumed": counts,
    }
    log(f"10 steps of {batch} in turns (saved, resumed, resumed, saved): resumed "
        f"{result['resumed_samples_per_s']} samples/s, step medians "
        f"{result['resumed_step_ms_median']} ms; saved {result['saved_samples_per_s']}, "
        f"{result['saved_step_ms_median']} ms (phase 20: {phase20!r}); the resumed trainer's "
        f"launches {counts} [{card}]")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # phase 22: the delta chain
    pub = os.path.join(workdir, "pub")
    require_free(workdir, 4 * sum(state_bytes([t]) for t in resumed.state.tables.values()),
                 "phase 22's delta chain")
    exporter = deltas.DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                    model_params=SPLIT_TRAIN_PARAMS)
    t0 = time.perf_counter()
    full_dir = exporter.publish_full(resumed)
    full_s = time.perf_counter() - t0
    steps(resumed, 28, 2)
    t0 = time.perf_counter()
    delta_dir = exporter.publish_delta(resumed)
    delta_s = time.perf_counter() - t0
    if deltas.resolve_chain(pub) != (full_dir, [delta_dir]):
        fail(f"resolve_chain gave {deltas.resolve_chain(pub)}, not ({full_dir}, [{delta_dir}])")
    loaded = deltas.load_delta(delta_dir)
    changed = {key: {"blocks": int(rows.size), "of_blocks": int(meta["packed_shape"][0]),
                     "bytes": int(rows.nbytes + vals.nbytes)}
               for key, (rows, vals, meta) in loaded["tables"].items()}
    log(f"delta {loaded['manifest']['base_step']} -> {loaded['manifest']['step']}: changed "
        f"{changed}; publish_full {full_s!r} s, publish_delta {delta_s!r} s [{card}]")
    fresh = export_model(resumed, os.path.join(workdir, "fresh"), model_zoo="model_zoo",
                         model_def=MODEL_DEF, model_params=SPLIT_TRAIN_PARAMS)
    with open(os.path.join(full_dir, "signature.json")) as f:
        tables_meta = json.load(f)["tables"]
    for meta in tables_meta:
        patched = np.load(os.path.join(full_dir, meta["file"]))
        rows, vals, _ = loaded["tables"][meta["key"]]
        patched[rows] = vals
        want = np.load(os.path.join(fresh, meta["file"]), mmap_mode="r")
        if not np.array_equal(patched.view(np.uint32), want.view(np.uint32)):
            fail(f"{meta['key']}: the full patched with the delta is not the fresh export")
        del patched, want
    shutil.rmtree(fresh, ignore_errors=True)

    want = resumed.eval_step(held_out)
    replica = ServingReplica(full_dir)
    t0 = time.perf_counter()
    gen = replica.apply_delta(delta_dir)
    apply_s = time.perf_counter() - t0
    if gen.step != resumed.step or replica.generation is not gen:
        fail(f"after apply_delta the replica serves step {replica.generation.step}, "
             f"the trainer is at {resumed.step}")
    ske.reset_launch_counts()
    got = replica.execute(held_out, len(want))[: len(want)]
    serve_counts = ske.launch_counts()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    if serve_counts["fused_lookup"] != 2 or serve_counts["fused_lookup_fm"]:
        fail(f"one dispatch after apply_delta launched {serve_counts}")
    log(f"replica after apply_delta: generation {gen.gen_id} at step {gen.step}, "
        f"{len(want)} rows within rtol {LOGIT_RTOL} of eval_step; apply_delta {apply_s!r} s; "
        f"one dispatch's launches {serve_counts} [{card}]")
    result.update({"publish_full_s": full_s, "publish_delta_s": delta_s,
                   "apply_delta_s": apply_s, "delta_changed": changed,
                   "launches_serve_delta": serve_counts})
    shutil.rmtree(pub, ignore_errors=True)
    if keep:
        return result, LoopTrainer(resumed, staged, held_out, held_labels, 30, replica)
    del replica, gen, resumed, staged
    torch.cuda.empty_cache()
    return result


def lm_checkpoint_phase(card: str, seed: int, n_batches: int = 4):
    """Phase 23: the LM at TRANSFORMER_BENCH (bf16 blocks), batch 16: 2
    steps, ``CheckpointSaver.save(state_to_jax_host())``, ``load_latest``
    into a fresh trainer (bit-exact), then one forward/backward and 2
    steps on both within LM_PATH_TOL, K4-K6 4 times each a step."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.serving import convert
    from elasticdl_tpu_torch.zoo import build_model, resolve

    cfg, batch = LM_BENCH, LM_BATCH
    zoo = resolve(LM_DEF)
    tokens, nxt = synthetic_lm_arrays(batch * n_batches, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    params = dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                  num_layers=cfg["num_layers"], max_len=cfg["seq_len"])

    def trainer_for(trainer_seed):
        return DataParallelTrainer(build_model(LM_DEF, params), zoo.loss,
                                   zoo.optimizer(LM_LR), seed=trainer_seed)

    saved = trainer_for(seed)
    saved.ensure_initialized()
    staged = [saved.stage_batch(tokens[i * batch:(i + 1) * batch],
                                nxt[i * batch:(i + 1) * batch], ones) for i in range(n_batches)]
    for i in range(2):
        saved.train_step_staged(staged[i])
    workdir = tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_")
    try:
        tensors = list(saved.state.params.values()) + [
            v for m in ("mu", "nu") for v in saved.state.opt_state[m].values()]
        need = state_bytes(tensors)
        require_free(workdir, need + need // 10, "phase 23's checkpoint")
        saver = CheckpointSaver(workdir)
        t0 = time.perf_counter()
        saver.save(saved.state_to_jax_host(), saved.step)
        save_s = time.perf_counter() - t0
        written = dir_bytes(workdir)
        t0 = time.perf_counter()
        state, step = saver.load_latest()
        resumed = trainer_for(seed + 1)
        resumed.state = convert.dp_trainer_state_from_jax(state, resumed.model)
        resumed.ensure_initialized()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del state
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    a, b = saved.state, resumed.state
    differ = [] if a.step == b.step == step == 2 else ["step"]
    differ += [k for k, v in a.params.items() if not bit_equal(v.detach(), b.params[k].detach())]
    differ += [f"{m}/{k}" for m in ("mu", "nu") for k, v in a.opt_state[m].items()
               if not bit_equal(v, b.opt_state[m][k])]
    if not bit_equal(a.opt_state["count"], b.opt_state["count"]):
        differ.append("count")
    if differ:
        fail(f"the resumed LM trainer differs from the saved one in {differ}")
    log(f"LM checkpoint at step {step}: state.pkl of {written} bytes in {save_s!r} s, "
        f"load_latest + restore {restore_s!r} s, bit-exact [{card}]")

    loss_rtol, grad_rtol, param_max, update_rtol = LM_PATH_TOL
    start = {k: p.detach().clone() for k, p in a.params.items()}
    runs = {}
    for name, trainer in (("saved", saved), ("resumed", resumed)):
        grads = trainer.backward(trainer.forward(*staged[2]))
        fa.reset_launch_counts()
        losses = [float(trainer.train_step_staged(staged[2 + i])) for i in range(2)]
        torch.cuda.synchronize()
        runs[name] = (losses, grads, fa.launch_counts(),
                      {k: p.detach().clone() for k, p in trainer.state.params.items()})
        del grads
    (a_losses, a_grads, _, a_params), (b_losses, b_grads, counts, b_params) = (
        runs["saved"], runs["resumed"])
    want = 2 * cfg["num_layers"]
    if any(counts[name] != want for name in fa.KERNELS):
        fail(f"2 resumed LM steps launched {counts} (want {want} of each)")
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(b_losses, a_losses))
    grad_rel = max(rel_l2(b_grads[k], g) for k, g in a_grads.items())
    worst = max(float((b_params[k] - p).abs().max()) for k, p in a_params.items())
    diff_sq = sum(float(torch_norm(b_params[k] - p)) ** 2 for k, p in a_params.items())
    moved_sq = sum(float(torch_norm(p - start[k])) ** 2 for k, p in a_params.items())
    update_rel = (diff_sq / max(moved_sq, 1e-30)) ** 0.5
    exact = b_losses == a_losses and all(bit_equal(b_params[k], p) for k, p in a_params.items())
    summary = (f"losses {b_losses} vs {a_losses} (max rel {loss_rel!r}); gradients max rel L2 "
               f"{grad_rel!r}; params max diff {worst!r}, updates rel L2 {update_rel!r}; "
               f"bit-exact {exact}")
    if not (loss_rel <= loss_rtol and grad_rel <= grad_rtol and worst <= param_max
            and update_rel <= update_rtol):
        fail(f"the resumed LM diverges from the saved one: {summary}")
    log(f"LM resumed vs saved, 2 steps: {summary}; launches {counts} [{card}]")
    del saved, resumed, staged, runs, a, b, start
    torch.cuda.empty_cache()
    return {"step": step, "save_s": save_s, "bytes_written": written, "restore_s": restore_s,
            "losses_resumed": b_losses, "losses_saved": a_losses, "max_loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "max_param_diff": worst, "update_rel_l2": update_rel,
            "bit_exact_2_steps": exact, "launches_resumed_2_steps": counts}


# ----------------------------------------------------------------------
# phases 24-25: the continuous delta loop, in process and as a process
# ----------------------------------------------------------------------


class LoopTrainer:
    """Phase 20's trainer with its staged batches, 256 labeled held-out
    rows and (when phase 22 made one) a replica: what phases 24-25 train,
    publish and check against."""

    def __init__(self, trainer, staged, held_out, held_labels, cursor=0, replica=None):
        self.trainer, self.staged = trainer, staged
        self.held_out, self.held_labels = held_out, held_labels
        self.cursor, self.replica = cursor, replica

    def train(self, count: int) -> None:
        for _ in range(count):
            self.trainer.train_step_staged(self.staged[self.cursor % len(self.staged)])
            self.cursor += 1


def loop_trainer(seed: int, n_batches: int = 12) -> LoopTrainer:
    """Phase 20's configuration from scratch (phases 24-25 run without
    phases 21-22): 26M rows in the split layout, batch 8192, strict,
    global-bias sparse Adam, 5 steps."""
    import numpy as np

    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.parallel import sparse_optim
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    vocab, batch = parse_dict_params(SPLIT_TRAIN_PARAMS)["vocab_size"], TRAIN_BATCH
    feats, labels = synthetic_ctr_arrays(batch * n_batches + 256, vocab_size=vocab, seed=seed)
    trainer = ShardedEmbeddingTrainer(
        build_model(MODEL_DEF, SPLIT_TRAIN_PARAMS), zoo.loss, zoo.optimizer(),
        embedding_optimizer=sparse_optim.adam(LR, bias_correction="global"), seed=seed)
    trainer.ensure_initialized()
    staged = [trainer.stage_batch({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                                  labels[i * batch:(i + 1) * batch],
                                  np.ones((batch,), np.float32)) for i in range(n_batches)]
    out = LoopTrainer(trainer, staged, {k: v[n_batches * batch:] for k, v in feats.items()},
                      labels[n_batches * batch:])
    out.train(5)
    return out


class Timed:
    """Seconds of every call of ``owner.name``, patched in place."""

    def __init__(self, owner, name: str):
        self.seconds = []
        self._patch = mock.patch.object(owner, name, self._wrap(getattr(owner, name)))

    def _wrap(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds.append(time.perf_counter() - t0)
        return timed

    def __enter__(self):
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)


def journal_events(path: str, event: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, filter(str.strip, f)) if r.get("event") == event]


def check_served(replica, loop: LoopTrainer, what: str, card: str) -> dict:
    """The replica's held-out logits against ``eval_step`` at the
    trainer's step, and one dispatch's launches (2 K2, no K1)."""
    import numpy as np

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    want = loop.trainer.eval_step(loop.held_out)
    if replica.generation.step != loop.trainer.step:
        fail(f"{what}: the replica serves step {replica.generation.step}, the trainer is at "
             f"{loop.trainer.step}")
    ske.reset_launch_counts()
    got = replica.execute(loop.held_out, len(want))[: len(want)]
    counts = ske.launch_counts()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    if counts["fused_lookup"] != 2 or counts["fused_lookup_fm"]:
        fail(f"{what}: one dispatch launched {counts}")
    return counts


def continuous_loop_phase(card: str, loop: LoopTrainer, workdir: str):
    """Phase 24: a DeltaExporter publishes a full and deltas of 2 steps
    (event time = the step) while a ServingReplica on the card is moved
    only by DeltaWatcher.poll_once(): the clean run (the full, then
    PHASE24_CLEAN_LINKS links, each within LOGIT_RTOL of eval_step, 2 K2 a dispatch), the
    fault run (``serving.delta_apply:error=injected@2``: link 2 rolls
    back, the same generation serves the same bits, the next poll applies
    it) and the canary gate (256 labeled held-out rows: the delta of the
    trainer with its output layer negated is held, the pointer unmoved;
    the healthy delta republished at that step passes).  Returns the
    result, the exporter and the compacted full phase 25 starts from."""
    import copy

    import numpy as np
    import torch

    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.checkpoint import delta as deltas
    from elasticdl_tpu_torch.common import faults
    from elasticdl_tpu_torch.data.pipeline import bucket_sizes
    from elasticdl_tpu_torch.obs.quality import CanaryGate, ReplayBuffer
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.serving.continuous import DeltaWatcher
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    trainer = loop.trainer
    pub = os.path.join(workdir, "pub_loop")
    require_free(workdir, 6 * sum(state_bytes([t]) for t in trainer.state.tables.values()),
                 "phase 24's delta chain")
    journal = obs.init_journal(os.path.join(workdir, "journal_loop"))
    replica = loop.replica
    if replica is None:  # the model the replica served before the loop
        start_dir = export_model(trainer, os.path.join(workdir, "start"), model_zoo="model_zoo",
                                 model_def=MODEL_DEF, model_params=SPLIT_TRAIN_PARAMS)
        replica = ServingReplica(start_dir)
    loop.replica = None
    exporter = deltas.DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                    model_params=SPLIT_TRAIN_PARAMS)
    watcher = DeltaWatcher(replica, pub)
    polls, publish_s, summaries = [], [], []

    def publish(exp=exporter):
        loop.train(2)
        t0 = time.perf_counter()
        link = exp.publish_delta(trainer, event_time=float(trainer.step))
        publish_s.append(time.perf_counter() - t0)
        return link

    def poll(w=watcher, outcome="applied"):
        t0 = time.perf_counter()
        summary = w.poll_once()
        polls.append(time.perf_counter() - t0)
        summaries.append(summary)
        if summary["outcome"] != outcome:
            fail(f"poll_once gave {summary}, not outcome {outcome}")
        return summary

    with Timed(ServingReplica, "build_delta_generation") as build, \
            Timed(ServingReplica, "commit_generation") as commit, \
            Timed(ServingReplica, "shadow_execute") as shadow, \
            Timed(ServingReplica, "reload") as reload:
        # The clean run: the full, then PHASE24_CLEAN_LINKS links.
        loop.train(2)
        t0 = time.perf_counter()
        full = exporter.publish_full(trainer, event_time=float(trainer.step))
        full_s = time.perf_counter() - t0
        if not poll()["reloaded_full"]:
            fail(f"the first poll did not reload the full: {summaries[-1]}")
        clean_counts = [check_served(replica, loop, "after the full", card)]
        for _ in range(PHASE24_CLEAN_LINKS):
            publish()
            if poll()["applied_deltas"] != 1:
                fail(f"a poll applied {summaries[-1]['applied_deltas']} links, not 1")
            clean_counts.append(check_served(replica, loop, "after a link", card))
        # The fault run: the 2nd build from here on fails and rolls back.
        faults.install("serving.delta_apply:error=injected@2")
        publish()
        poll()
        publish()
        old = replica.generation
        before = replica.execute(loop.held_out, len(loop.held_labels))
        summary = poll(outcome="rolled_back")
        if replica.generation is not old or "injected" not in str(summary["reason"]):
            fail(f"the injected fault did not roll back in place: {summary}")
        if not bit_equal(torch.from_numpy(replica.execute(loop.held_out, len(before))),
                         torch.from_numpy(before)):
            fail("the rolled-back generation does not serve the same bits")
        poll()
        check_served(replica, loop, "after the retried link", card)
        faults.clear()
        # The canary gate over 256 labeled held-out rows, in 4 batches.
        replay = ReplayBuffer()
        for i in range(0, len(loop.held_labels), 64):
            replay.add({k: v[i:i + 64] for k, v in loop.held_out.items()},
                       loop.held_labels[i:i + 64])
        gate = CanaryGate(replay, min_rows=256)
        gated = DeltaWatcher(replica, pub, gate=gate, buckets=bucket_sizes(64), origin="phase24")
        loop.train(2)
        out_layer = [p for name, p in trainer.state.params.items() if name.startswith("Dense_2")]
        with torch.no_grad():
            for p in out_layer:
                p.neg_()
        poisoner = copy.copy(exporter)  # its own head: the real chain stays as it was
        t0 = time.perf_counter()
        poisoned = poisoner.publish_delta(trainer, event_time=float(trainer.step))
        publish_s.append(time.perf_counter() - t0)
        with torch.no_grad():
            for p in out_layer:
                p.neg_()  # restored bit for bit
        old = replica.generation
        ske.reset_launch_counts()
        summary = poll(gated, outcome="held")
        gate_counts = ske.launch_counts()
        if summary["held"] != poisoned or replica.generation is not old:
            fail(f"the poisoned delta moved the pointer: {summary}")
        shutil.rmtree(poisoned)  # withdrawn; the healthy delta of that step replaces it
        t0 = time.perf_counter()
        healthy = exporter.publish_delta(trainer, event_time=float(trainer.step))
        publish_s.append(time.perf_counter() - t0)
        if os.path.basename(healthy) != os.path.basename(poisoned):
            fail(f"the republished link {healthy} is not the held one's step")
        poll(gated)
        check_served(replica, loop, "after the gated link", card)
        t0 = time.perf_counter()
        compacted = exporter.compact()
        compact_s = time.perf_counter() - t0
    swaps = journal_events(journal, "model_swap")
    gates = journal_events(journal, "quality_gate")
    outcomes = [(e["kind"], e["outcome"]) for e in swaps]
    want = ([("full", "applied")] + [("delta", "applied")] * (PHASE24_CLEAN_LINKS + 1)
            + [("delta", "rolled_back"), ("delta", "applied"), ("delta", "applied")])
    if outcomes != want:
        fail(f"model_swap events {outcomes}, want {want}")
    if [g["outcome"] for g in gates] != ["held", "passed"] or \
            any(obs.missing_fields(e) for e in swaps + gates):
        fail(f"quality_gate events {gates}")
    obs.journal().configure(None)
    if gate_counts["fused_lookup"] != 2 * 2 * 4:  # 2 K2 x 2 generations x 4 batches
        fail(f"the gate's shadow runs launched {gate_counts}")
    median = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    result = {
        "steps": [s["step"] for s in summaries], "outcomes": [s["outcome"] for s in summaries],
        "poll_s": polls, "publish_full_s": full_s, "publish_delta_s": publish_s,
        "reload_s": reload.seconds, "build_delta_generation_s": build.seconds,
        "commit_generation_s": commit.seconds, "shadow_execute_s": shadow.seconds,
        "compact_s": compact_s, "launches_clean_per_dispatch": clean_counts,
        "launches_gate_poll": gate_counts,
        "gate": {k: gates[0].get(k) for k in ("reason", "baseline_logloss", "candidate_logloss",
                                              "baseline_auc", "candidate_auc", "rows")},
        "gate_passed": {k: gates[1].get(k) for k in ("baseline_auc", "candidate_auc",
                                                     "baseline_logloss",
                                                     "candidate_logloss")},
        "card": card,
    }
    log(f"continuous loop: polls {result['outcomes']} at steps {result['steps']}; poll_once "
        f"{polls!r} s (median {median(polls)!r}); publish_full {full_s!r} s, publish_delta "
        f"{publish_s!r} s; reload {reload.seconds!r} s, build_delta_generation {build.seconds!r}"
        f" s, commit_generation {commit.seconds!r} s, shadow_execute {shadow.seconds!r} s; "
        f"compact {compact_s!r} s; each link within rtol {LOGIT_RTOL} of eval_step, 2 K2 a "
        f"dispatch; the gate held the negated output layer ({result['gate']}) and passed the "
        f"healthy link ({result['gate_passed']}), {gate_counts['fused_lookup']} K2 in its "
        f"shadow runs [{card}]")
    del replica, watcher, gated
    torch.cuda.empty_cache()
    return result, exporter, compacted, pub


def percentile_ms(latencies, pct: float):
    if not latencies:
        return None
    lat = sorted(latencies)
    return lat[min(len(lat) - 1, int(round(pct / 100.0 * (len(lat) - 1))))] * 1e3


def replica_process_phase(card: str, loop: LoopTrainer, exporter, full: str, pub: str,
                          workdir: str, clients: int = 8):
    """Phase 25: ``python -m elasticdl_tpu_torch.serving.replica_main`` on
    the card from the compacted full, tracking ``pub`` every 0.5 s with
    ``serving.delta_apply:error=injected@2`` in its environment; 8
    closed-loop PredictClients send 8-row requests throughout while
    PHASE25_LINKS deltas are published (the second apply fails once and
    is retried); after each, /stats reaches the step and the
    held-out logits from /predict agree with eval_step; SIGTERM ends it
    with exit 0 within 30 s."""
    import numpy as np

    from elasticdl_tpu_torch.serving.frontend import PredictClient, encode_features
    from elasticdl_tpu_torch.serving.replica_main import live_replicas

    trainer = loop.trainer
    serve = os.path.join(workdir, "serve")
    os.makedirs(serve, exist_ok=True)
    warmup = os.path.join(workdir, "warmup.npz")
    with open(warmup, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in loop.held_out.items()}))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ELASTICDL_FAULTS="serving.delta_apply:error=injected@2",
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    stderr_path = os.path.join(workdir, "replica.log")
    stderr = open(stderr_path, "w")
    t_launch = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.replica_main", "--model_dir", full,
         "--pub_dir", pub, "--serve_dir", serve, "--pub_poll_interval_s", "0.5",
         "--telemetry_interval_s", "1.0", "--warmup_features", warmup],
        cwd=here, env=env, stdout=subprocess.DEVNULL, stderr=stderr)

    def died(what):
        stderr.flush()
        with open(stderr_path) as f:
            tail = f.read()[-6000:]
        fail(f"the replica process exited {proc.returncode} {what}:\n{tail}")

    def wait_for(what, predicate, timeout_s):
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            value = predicate()
            if value:
                return value
            if proc.poll() is not None:
                died(f"waiting for {what}")
            time.sleep(0.05)
        fail(f"timed out after {timeout_s} s waiting for {what}")

    stop = threading.Event()
    records, errors, threads = [], [], []
    try:
        info = wait_for("live_replicas", lambda: live_replicas(serve), 300)[0]
        addr = f"127.0.0.1:{info['port']}"
        probe = PredictClient(addr, deadline_s=60.0)
        rows = {k: v[:64] for k, v in loop.held_out.items()}
        probe.predict(rows)
        first_answer_s = time.perf_counter() - t_launch
        rng = np.random.default_rng(25)
        vocab = int(SPLIT_TRAIN_PARAMS.split("vocab_size=")[1].split(",")[0])
        pool = make_requests(rng, vocab, 64, 8)

        def client(w):
            c = PredictClient(addr, deadline_s=30.0)
            i = w
            try:
                while not stop.is_set():
                    t0 = time.time()
                    try:
                        out = c.predict(pool[i % len(pool)])
                        if out.shape != (8,) or not np.all(np.isfinite(out)):
                            raise ValueError(f"response of shape {out.shape} / non-finite")
                        records.append((t0, time.time()))
                    except Exception as exc:  # counted, reported after join
                        errors.append(repr(exc))
                    i += clients
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(w,), name=f"smoke-client-{w}")
                   for w in range(clients)]
        t_run = time.time()
        for t in threads:
            t.start()
        links = []
        for _ in range(PHASE25_LINKS):
            loop.train(2)
            link = exporter.publish_delta(trainer, event_time=float(trainer.step))
            t_pub = time.time()
            step = trainer.step
            wait_for(f"step {step} on /stats",
                     lambda: probe.stats()["step"] == step, 120)
            t_seen = time.time()
            checked = 0
            for i in range(0, len(loop.held_labels), 64):
                part = {k: v[i:i + 64] for k, v in loop.held_out.items()}
                np.testing.assert_allclose(probe.predict(part), trainer.eval_step(part),
                                           rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
                checked += 64
            links.append({"link": os.path.basename(link), "step": step, "published_ts": t_pub,
                          "stats_seen_s": t_seen - t_pub, "rows_checked": checked})
        stop.set()
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                fail(f"client thread {t.name} did not finish")
        t_end = time.time()
        stats = probe.stats()
        probe.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fail("the replica process did not exit within 30 s of SIGTERM")
        if rc != 0:
            died("after SIGTERM")
    except Exception:
        if proc.poll() is not None:
            died("while serving")  # its log's tail, not only this traceback
        raise
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        stderr.close()
    if errors:
        fail(f"{len(errors)} of {len(errors) + len(records)} requests failed: {errors[:3]}")
    journal = os.path.join(serve, "events.jsonl")
    start = journal_events(journal, "serving_replica_start")
    swaps = journal_events(journal, "model_swap")
    last = journal_events(journal, "serving_telemetry")[-1]
    outcomes = [(e["outcome"], e["step"]) for e in swaps]
    applied = [e for e in swaps if e["outcome"] == "applied"]
    if [e["step"] for e in applied] != [link["step"] for link in links] or \
            [e["outcome"] for e in swaps].count("rolled_back") != 1:
        fail(f"model_swap events {outcomes}, links {[link['step'] for link in links]}")
    if len(start) != 1 or start[0]["forbidden_modules"]:
        fail(f"the replica process loaded {start and start[0]['forbidden_modules']}")
    requests = len(records) + 1 + 4 * len(links)
    if (last["served"], last["errors"], last["shed"], last["dropped"]) != (requests, 0, 0, 0):
        fail(f"the replica's last telemetry {last} against {requests} requests answered")
    launches = stats["kernel_launches"]
    dispatches = stats["executes"]  # the batcher's dispatches and the warm-up's
    if launches["fused_lookup"] != 2 * dispatches or launches["fused_lookup_fm"]:
        fail(f"the replica process launched {launches} in {dispatches} dispatches")
    for link, swap in zip(links, applied):
        link["served_lag_s"] = swap["ts"] - link["published_ts"]
        window = [(b - a) for a, b in records if abs(a - swap["ts"]) <= 1.0]
        link["window_requests_per_s"] = len(window) / 2.0
        link["window_p50_ms"] = percentile_ms(window, 50)
        link["window_p99_ms"] = percentile_ms(window, 99)
        del link["published_ts"]
    latencies = [b - a for a, b in records]
    result = {
        "requests": len(records), "requests_per_s": len(records) / (t_end - t_run),
        "p50_ms": percentile_ms(latencies, 50), "p99_ms": percentile_ms(latencies, 99),
        "links": links, "swaps": outcomes, "first_answer_s": first_answer_s,
        "startup_s": start[0]["startup_s"], "launches": launches, "dispatches": dispatches,
        "last_telemetry": {k: last[k] for k in ("served", "errors", "shed", "dropped",
                                                "p50_ms", "p99_ms", "step")},
        "card": card,
    }
    log(f"replica process: {len(records)} requests of 8 rows from {clients} clients, "
        f"{result['requests_per_s']!r} requests/s, p50 {result['p50_ms']!r} ms, p99 "
        f"{result['p99_ms']!r} ms, 0 failed; swaps {outcomes}; per link {links}; first answer "
        f"{first_answer_s!r} s after launch (startup {result['startup_s']!r} s); launches "
        f"{launches} in {dispatches} dispatches; exit 0 on SIGTERM [{card}]")
    return result


# ----------------------------------------------------------------------
# phase 26: the elastic PS job on one host, a worker SIGKILLed mid-job
# ----------------------------------------------------------------------


def tree_leaves(tree, path=()):
    """``(path, leaf)`` of a nested dict, depth first."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from tree_leaves(value, path + (key,))
    else:
        yield path, tree


def wait_until(what, predicate, proc, log_path, timeout_s):
    """Poll ``predicate`` until it is truthy; fail with the master's log
    tail if the job exits first or the wait times out."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        value = predicate()
        if value:
            return value
        if proc.poll() is not None:
            fail(f"the job exited {proc.returncode} waiting for {what}:\n{tail(log_path)}")
        time.sleep(0.02)
    fail(f"timed out after {timeout_s} s waiting for {what}:\n{tail(log_path)}")


def tail(path: str, nbytes: int = 6000) -> str:
    if not os.path.exists(path):
        return f"({path} missing)"
    with open(path, errors="replace") as f:
        return f.read()[-nbytes:]


def in_flight(events: str, worker_id: int, since_ts: float) -> list:
    """Tasks dispatched to ``worker_id`` at or after ``since_ts`` and not
    reported done, from the master's journal (empty while the journal's
    last line is still being written: the caller polls again)."""
    try:
        done = {e["task_id"] for e in journal_events(events, "task_done")}
        dispatched = journal_events(events, "task_dispatch")
    except ValueError:
        return []
    return [e["task_id"] for e in dispatched
            if e["worker_id"] == worker_id and e["ts"] >= since_ts and e["task_id"] not in done]


def parent_pid(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def elastic_job_phase(card: str, seed: int, workdir: str, split_train=None,
                      n: int = ELASTIC_RECORDS, vocab: int = 1_000_000,
                      per_task: int = ELASTIC_PER_TASK, batch: int = TRAIN_BATCH,
                      checkpoint_steps: int = ELASTIC_CKPT_STEPS, extra_flags=()):
    """Phase 26: ``python -m elasticdl_tpu_torch.master.main`` runs the PS
    job (DeepFM at vocab 1M per field, the split layout its layout rule
    picks under strict apply, the zoo's per-row Adam, batch 8192, ``n``
    records in tasks of ``per_task``, async staging with 2 parse workers)
    with one worker process on the card; once the step-``checkpoint_steps``
    checkpoint is committed, the worker (the master's child, by its exact
    pid) is SIGKILLed.  The job must re-form, the new worker restore that
    step, the in-flight task be requeued and every record range done,
    exit 0; both workers' K2 and K3 twice a step; no forbidden module in
    any process; the export bit-exact with the final checkpoint, and a
    ServingReplica of it within LOGIT_RTOL/LOGIT_ATOL of a trainer
    restored from that checkpoint."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.serving.export import read_variables
    from elasticdl_tpu_torch.serving.runtime import ServingReplica
    from elasticdl_tpu_torch.zoo import build_model, resolve

    torch.cuda.empty_cache()
    require_free(workdir, 4 * 3_000_000_000, "the elastic job (3 checkpoints + the export)")
    job = os.path.join(workdir, "elastic")
    ckpt, out = os.path.join(job, "ckpt"), os.path.join(job, "out")
    os.makedirs(job)
    master_log = os.path.join(job, "master.log")
    here = os.path.dirname(os.path.abspath(__file__))
    params = f"vocab_size={vocab}"
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
            "--distribution_strategy=ParameterServerStrategy", "--num_workers=1",
            "--model_zoo=model_zoo", f"--model_def={MODEL_DEF}", f"--model_params={params}",
            "--sparse_apply_every=1", f"--training_data=synthetic://criteo?n={n}&vocab={vocab}",
            f"--minibatch_size={batch}", f"--records_per_task={per_task}",
            f"--checkpoint_dir={ckpt}", f"--checkpoint_steps={checkpoint_steps}",
            f"--output={out}", "--pipeline=async", "--parse_pool_workers=2", *extra_flags]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    events = os.path.join(ckpt, "events.jsonl")
    committed = os.path.join(ckpt, f"step_{checkpoint_steps:012d}", "manifest.json")
    t_start = time.time()
    with open(master_log, "wb") as log_file:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        wait_until(f"the step-{checkpoint_steps} checkpoint", lambda: os.path.exists(committed),
                   proc, master_log, 600)
        t_commit = os.path.getmtime(committed)
        # Kill while a task dispatched after the commit is in flight.
        wait_until("a task in flight after the checkpoint",
                   lambda: in_flight(events, 0, t_commit), proc, master_log, 600)
        launch = journal_events(events, "worker_launch")[0]
        victim = launch["pid"]
        if launch["worker_id"] != 0 or parent_pid(victim) != proc.pid:
            fail(f"worker {launch} is not the master's ({proc.pid}) child")
        os.kill(victim, signal.SIGKILL)
        t_kill = time.time()
        log(f"elastic job: SIGKILLed worker 0 (pid {victim}, the master's child) "
            f"{t_kill - t_start!r} s after the master started, once step {checkpoint_steps} "
            "was committed")
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"the job did not finish within 600 s of the kill:\n{tail(master_log)}")
        t_end = time.time()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    logs = os.path.join(ckpt, "elasticdl-job_worker_logs")
    if rc != 0:
        fail(f"the job exited {rc}:\n{tail(master_log)}\n--- worker 1\n"
             f"{tail(os.path.join(logs, 'worker_1.log'))}")

    def worker_events(wid, event):
        return journal_events(os.path.join(ckpt, f"events_worker_{wid}.jsonl"), event)

    master = {name: journal_events(events, name) for name in (
        "master_start", "task_dispatch", "task_done", "task_requeue", "worker_launch",
        "worker_churn", "rendezvous", "master_exit")}
    churn = master["worker_churn"]
    if len(churn) != 1 or churn[0]["workers"] != [0] or churn[0]["exit_codes"] != [-9]:
        fail(f"worker_churn events {churn}")
    if [e["workers"] for e in master["rendezvous"]] != [[0], [1]]:
        fail(f"rendezvous events {master['rendezvous']}")
    requeued = [t for e in master["task_requeue"] if e["reason"] == "worker_churn"
                for t in e["task_ids"]]
    ranges = {e["task_id"]: (e["start"], e["end"]) for e in master["task_dispatch"]}
    done = [ranges[e["task_id"]] for e in master["task_done"]]
    if not requeued or any(ranges[t] not in done for t in requeued):
        fail(f"the in-flight task {requeued} was not requeued and done: done {sorted(done)}")
    covered = sorted(set(done))
    expected = [(lo, min(lo + per_task, n)) for lo in range(0, n, per_task)]
    if covered != expected:
        fail(f"record ranges done {covered}, want {expected}")
    restored = [e["step"] for e in worker_events(1, "checkpoint_restore")]
    saved0 = [e["step"] for e in worker_events(0, "checkpoint_saved")]
    if restored != [checkpoint_steps] or max(saved0) != checkpoint_steps:
        fail(f"worker 1 restored {restored}; worker 0 saved {saved0}")
    final = [e["step"] for e in worker_events(1, "model_exported")]
    per_worker = {}
    for wid in (0, 1):
        last = worker_events(wid, "worker_task_done")[-1]
        got, steps = last["kernel_launches"], last["process_steps"]
        want = {"fused_lookup": 2 * steps, "fused_dedup_apply": 2 * steps}
        if got != want:
            fail(f"worker {wid} launched {got} in {steps} steps (want {want})")
        if last["forbidden_modules"]:
            fail(f"worker {wid} loaded {last['forbidden_modules']}")
        per_worker[wid] = {"steps": steps, "launches": got}
    if master["master_exit"][-1]["forbidden_modules"] or not master["master_exit"][-1]["succeeded"]:
        fail(f"master exit {master['master_exit'][-1]}")
    exits = worker_events(1, "worker_exit")
    if not exits or exits[0]["forbidden_modules"] or exits[0]["kernel_launches"] != \
            per_worker[1]["launches"]:
        fail(f"worker 1 exit {exits}")
    # Export against the final checkpoint, bit for bit.
    saver = ShardedCheckpointSaver(ckpt)
    last_step = saver.latest_step()
    if final != [last_step]:
        fail(f"exported step {final}, last checkpoint {last_step}")
    if last_step != checkpoint_steps + per_worker[1]["steps"]:
        fail(f"the last checkpoint is step {last_step}; worker 1 trained "
             f"{per_worker[1]['steps']} steps from {checkpoint_steps}")
    variables = read_variables(os.path.join(out, "variables.pkl"))
    dense = saver.load_dense(last_step)
    ckpt_params = dict(tree_leaves(dense["params"]))
    compared = 0
    for path, leaf in tree_leaves(variables["params"]):
        if path[-1] == "__table__":
            key = "/".join(path[:-1])
            exported = np.load(os.path.join(out, leaf))
            stored = saver.load_rows(last_step, f"table|{key}", 0, exported.shape[0])
        else:
            exported, stored = np.asarray(leaf), np.asarray(ckpt_params[path])
        if exported.shape != stored.shape or not np.array_equal(exported.view(np.uint8),
                                                                 stored.view(np.uint8)):
            fail(f"the export's {'/'.join(path)} differs from checkpoint step {last_step}")
        compared += exported.size
    # The export served against a trainer restored from the checkpoint.
    zoo = resolve(MODEL_DEF)
    held, _ = synthetic_ctr_arrays(256, vocab_size=vocab, seed=seed + 26)
    trainer = ShardedEmbeddingTrainer(build_model(MODEL_DEF, params + ",sparse_apply_every=1"),
                                      zoo.loss, zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer())
    trainer.set_sharded_restore(saver, last_step)
    trainer.ensure_initialized()
    want = trainer.eval_step(held)
    replica = ServingReplica(out)
    got = replica.execute(held, len(want))[: len(want)]
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    if not np.all(np.isfinite(got)):
        fail("the served logits are not finite")
    del trainer, replica
    torch.cuda.empty_cache()
    # Times, on the host's clock.
    t0 = master["master_start"][0]["ts"]
    launches = {e["worker_id"]: e["ts"] for e in master["worker_launch"]}
    first = {wid: worker_events(wid, "first_step")[0]["ts"] for wid in (0, 1)}
    # Steady tasks: neither a worker's first (start-up) nor holding a
    # checkpoint save; the worker's own seconds for each (parse + steps).
    steady, trained = [], []
    for wid in (0, 1):
        done = worker_events(wid, "worker_task_done")
        trained += done
        saved_at = [e["ts"] for e in worker_events(wid, "checkpoint_saved")]
        steady += [e for e in done[1:]
                   if not any(e["ts"] - e["seconds"] <= ts <= e["ts"] for ts in saved_at)]
    steady_s = sum(e["seconds"] for e in steady)
    steady_rate = sum(e["records"] for e in steady) / steady_s if steady else None
    # The share of the steady tasks' seconds the step loop spent waiting
    # for the host's next batch (parse, shuffle, stack).
    data_wait_share = sum(e["data_wait_s"] for e in steady) / steady_s if steady else None
    job_rate = sum(e["records"] for e in trained) / (
        max(e["ts"] for e in trained) - master["task_dispatch"][0]["ts"])
    saves = [{"worker": wid, "step": e["step"], "s": e["seconds"]}
             for wid in (0, 1) for e in worker_events(wid, "checkpoint_saved")]
    restore = worker_events(1, "checkpoint_restore")[0]
    result = {
        "records": n, "records_per_task": per_task, "batch": batch, "steps": last_step,
        "first_dispatch_s": master["task_dispatch"][0]["ts"] - t0,
        "worker_launch_to_first_step_s": {w: first[w] - launches[w] for w in (0, 1)},
        "steady_tasks": len(steady), "steady_samples_per_s": steady_rate,
        "job_samples_per_s": job_rate, "steady_data_wait_share": data_wait_share,
        "phase20_samples_per_s": None if split_train is None else split_train["samples_per_s"],
        "checkpoint_saves": saves,
        "rescale_s": {"detected": churn[0]["ts"] - t_kill, "relaunched": launches[1] - t_kill,
                      "restored": restore["ts"] - t_kill, "restore_itself": restore["seconds"],
                      "first_step_after": first[1] - t_kill},
        "wall_s": t_end - t_start, "killed_pid": victim, "requeued_tasks": requeued,
        "per_worker": per_worker, "export_elements_bit_exact": compared,
        "served_max_abs_err": float(np.max(np.abs(got - want))),
        "goodput": ledger_summary(events, "elastic job", causes=["worker_churn"]),
        "journal_records_checked": journals_schema(ckpt, "elastic job"), "card": card,
    }
    cost = result["goodput"]["rescale_cost"][0]
    log(f"elastic job: goodput_ratio {result['goodput']['goodput_ratio']!r} over "
        f"{result['goodput']['wall_s']!r} s (phases {result['goodput']['phases_s']}); the "
        f"rescale on the ledger: detection {cost['detection_s']!r} s, rendezvous "
        f"{cost['rendezvous_s']!r} s, redo {cost['redo_s']!r} s of {cost['redo_records']} "
        f"records, total {cost['total_s']!r} s; on the host clock {result['rescale_s']} s "
        f"[{card}]")
    log(f"elastic job: master start -> first task {result['first_dispatch_s']!r} s; worker "
        f"launch -> first step {result['worker_launch_to_first_step_s']} s; "
        f"{result['steady_samples_per_s']!r} samples/s over {len(steady)} steady tasks "
        f"(no start-up, no save; the step loop waited for host data {data_wait_share!r} of "
        f"their time; phase 20 in process: {result['phase20_samples_per_s']!r}), "
        f"{job_rate!r} over the job (first dispatch -> last task, the rescale included); "
        f"saves {saves}; "
        f"rescale after the kill {result['rescale_s']} s; wall {result['wall_s']!r} s; "
        f"requeued {requeued}; K2/K3 per worker {per_worker}; export bit-exact with step "
        f"{last_step} ({compared} elements), served within rtol {LOGIT_RTOL} of the restored "
        f"trainer [{card}]")
    shutil.rmtree(job, ignore_errors=True)
    return result


# ----------------------------------------------------------------------
# phase 27: the elastic PS job reads ETRF files and evaluates
# ----------------------------------------------------------------------


def write_criteo_shards(directory: str, n: int, shards: int, vocab: int, seed: int) -> int:
    """``n`` Criteo-layout records from ``seed`` (bench.py:514-532's draw:
    dense uniform, cat uniform below ``vocab``, a 0/1 label) written in
    ``shards`` equal ETRF files by the port's writer; returns the bytes
    on disk."""
    import numpy as np

    from elasticdl_tpu_torch.zoo.deepfm import write_criteo_etrf

    os.makedirs(directory)
    rng = np.random.RandomState(seed)
    dense = rng.rand(n, NUM_DENSE).astype(np.float32)
    cat = rng.randint(0, vocab, size=(n, NUM_CAT)).astype(np.int32)
    label = rng.randint(0, 2, size=(n, 1)).astype(np.uint8)
    per = n // shards
    for i in range(shards):
        rows = slice(i * per, (i + 1) * per)
        write_criteo_etrf(os.path.join(directory, f"part-{i:05d}.etrf"), dense[rows], cat[rows],
                          label[rows])
    return dir_bytes(directory)


def in_process_metrics(trainer, directory: str, batch: int):
    """The zoo's metrics over every record of an ETRF directory, read by
    the columnar route (evaluation mode: no shuffle) and evaluated by
    ``trainer`` in batches of ``batch``."""
    import numpy as np

    from elasticdl_tpu_torch.common import messages as msg
    from elasticdl_tpu_torch.data.columnar import materialize_columnar_task
    from elasticdl_tpu_torch.zoo import deepfm

    reader = deepfm.CriteoRecordReader(directory)
    outputs, labels = [], []
    for shard, count in reader.create_shards().items():
        task = msg.Task(shard_name=shard, start=0, end=count, type=msg.EVALUATION)
        cols = materialize_columnar_task(reader, task, deepfm.columnar_dataset_fn,
                                         "evaluation", None)
        for lo in range(0, cols.n, batch):
            features, lab = cols.slice(lo, lo + batch)
            outputs.append(trainer.eval_step(features))
            labels.append(lab)
    outputs, labels = np.concatenate(outputs), np.concatenate(labels)
    return {k: float(np.asarray(fn(outputs, labels)))
            for k, fn in deepfm.eval_metrics_fn().items()}, len(labels)


def materialize_split(directory: str, per_task: int, reps: int = 5) -> dict:
    """Host milliseconds (median of ``reps``, this process, no step loop
    beside it) of one training task's columnar materialisation and its
    parts: the native read of its chunks, the structured-dtype parse,
    the join, the zoo's transform; the whole with no parse pool and with
    the job's two parse workers; and the Python codec's read."""
    import numpy as np

    from elasticdl_tpu_torch.common import messages as msg
    from elasticdl_tpu_torch.data import recordfile
    from elasticdl_tpu_torch.data.columnar import materialize_columnar_task, task_seed
    from elasticdl_tpu_torch.data.pipeline import ParsePool
    from elasticdl_tpu_torch.zoo import deepfm

    reader = deepfm.CriteoRecordReader(directory)
    shard = reader.shard_names()[0]
    task = msg.Task(shard_name=shard, start=0, end=per_task)
    layout = reader.layout()

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    chunks = list(recordfile.read_range_buffers(shard, 0, per_task))
    parsed = [layout.parse_buffer(b, n) for b, n in chunks]
    columns = {k: np.concatenate([c[k] for c in parsed]) for k in parsed[0]}
    pool = ParsePool(2)
    try:
        out = {
            "chunks": len(chunks),
            "read_ms": median_ms(lambda: list(recordfile.read_range_buffers(shard, 0, per_task))),
            "parse_ms": median_ms(lambda: [layout.parse_buffer(b, n) for b, n in chunks]),
            "join_ms": median_ms(lambda: {k: np.concatenate([c[k] for c in parsed])
                                          for k in parsed[0]}),
            "transform_ms": median_ms(lambda: deepfm.columnar_dataset_fn(
                columns, "training", None, seed=task_seed(task))),
            "whole_ms": median_ms(lambda: materialize_columnar_task(
                reader, task, deepfm.columnar_dataset_fn, "training", None)),
            "whole_2_parse_workers_ms": median_ms(lambda: materialize_columnar_task(
                reader, task, deepfm.columnar_dataset_fn, "training", None, parse_pool=pool)),
        }
    finally:
        pool.close()
    os.environ["ELASTICDL_DISABLE_NATIVE"] = "1"
    try:
        out["python_codec_read_ms"] = median_ms(
            lambda: list(recordfile.read_range_buffers(shard, 0, per_task)))
    finally:
        del os.environ["ELASTICDL_DISABLE_NATIVE"]
    return out


def etrf_job_phase(card: str, seed: int, workdir: str, elastic=None,
                   shards: int = ETRF_SHARDS, per_shard: int = ETRF_PER_SHARD,
                   validation: int = ETRF_VALIDATION, vocab: int = 1_000_000,
                   per_task: int = ELASTIC_PER_TASK, batch: int = TRAIN_BATCH,
                   eval_steps: int = ETRF_EVAL_STEPS, extra_flags=()):
    """Phase 27: ``python -m elasticdl_tpu_torch.master.main`` runs phase
    26's PS job (vocab 1M per field, the split layout under strict apply,
    per-row Adam, batch 8192, async staging with 2 parse workers, one
    worker on the card) on ``shards`` ETRF files of ``per_shard`` records
    written beforehand by the port's writer, and evaluates on a
    ``validation``-record shard every ``eval_steps`` model versions and
    at the end; one checkpoint, at the end.  Gates: exit 0, every
    training and evaluation range done, the columnar route engaged for
    training and evaluation with no per-record ETRF read, the native
    codec, 2 K2 and 2 K3 a training step and 2 K2 an evaluation batch,
    no forbidden module in any process, and the final metrics equal to an
    in-process evaluation of the final checkpoint (accuracy exactly, AUC
    within AUC_TOL)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    torch.cuda.empty_cache()
    require_free(workdir, 4_000_000_000, "the ETRF job (its files and one checkpoint)")
    job = os.path.join(workdir, "etrf")
    train_dir, val_dir = os.path.join(job, "train"), os.path.join(job, "validation")
    ckpt = os.path.join(job, "ckpt")
    n = shards * per_shard
    t0 = time.perf_counter()
    written = write_criteo_shards(train_dir, n, shards, vocab, seed)
    written += write_criteo_shards(val_dir, validation, 1, vocab, seed + 27)
    write_s = time.perf_counter() - t0
    log(f"etrf job: wrote {shards} training shards of {per_shard} records and one validation "
        f"shard of {validation} ({written} bytes) in {write_s!r} s, before the job")
    master_log = os.path.join(job, "master.log")
    here = os.path.dirname(os.path.abspath(__file__))
    params = f"vocab_size={vocab}"
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
            "--distribution_strategy=ParameterServerStrategy", "--num_workers=1",
            "--model_zoo=model_zoo", f"--model_def={MODEL_DEF}", f"--model_params={params}",
            "--sparse_apply_every=1", f"--training_data={train_dir}",
            f"--validation_data={val_dir}", f"--evaluation_steps={eval_steps}",
            f"--minibatch_size={batch}", f"--records_per_task={per_task}",
            f"--checkpoint_dir={ckpt}", "--checkpoint_steps=1000000",
            "--pipeline=async", "--parse_pool_workers=2", *extra_flags]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_start = time.time()
    with open(master_log, "wb") as log_file:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        fail(f"the ETRF job did not finish within 900 s:\n{tail(master_log)}")
    wall = time.time() - t_start
    worker_log = os.path.join(ckpt, "elasticdl-job_worker_logs", "worker_0.log")
    if rc != 0:
        fail(f"the ETRF job exited {rc}:\n{tail(master_log)}\n--- worker 0\n{tail(worker_log)}")
    events = os.path.join(ckpt, "events.jsonl")
    wevents = os.path.join(ckpt, "events_worker_0.jsonl")
    master = {name: journal_events(events, name) for name in (
        "master_start", "task_dispatch", "task_done", "task_requeue", "evaluation_metrics",
        "master_exit")}
    if master["task_requeue"]:
        fail(f"tasks were requeued: {master['task_requeue']}")
    dispatched = {e["task_id"]: e for e in master["task_dispatch"]}
    done_ids = [e["task_id"] for e in master["task_done"]]
    if sorted(done_ids) != sorted(dispatched):
        fail(f"dispatched {sorted(dispatched)}, done {sorted(done_ids)}")
    by_type = {}
    for tid in done_ids:
        e = dispatched[tid]
        by_type.setdefault(e["type"], []).append((os.path.basename(e["shard"]), e["start"],
                                                  e["end"]))
    want_train = sorted((f"part-{i:05d}.etrf", lo, min(lo + per_task, per_shard))
                        for i in range(shards) for lo in range(0, per_shard, per_task))
    if sorted(by_type.get("TRAINING", [])) != want_train:
        fail(f"training ranges done {sorted(by_type.get('TRAINING', []))}, want {want_train}")
    rounds = master["evaluation_metrics"]
    steps = n // batch
    want_versions = list(range(eval_steps, steps + 1, eval_steps))
    if [r["model_version"] for r in rounds] != want_versions or any(
            r["examples"] != validation for r in rounds):
        fail(f"evaluation rounds {rounds}, want versions {want_versions} of {validation} rows")
    want_eval = [("part-00000.etrf", lo, min(lo + per_task, validation))
                 for lo in range(0, validation, per_task)]
    eval_done = by_type.get("EVALUATION", [])
    runs = {r: eval_done.count(r) for r in want_eval}
    if set(eval_done) != set(want_eval) or len(set(runs.values())) != 1 \
            or runs[want_eval[0]] < len(rounds):
        fail(f"evaluation ranges done {sorted(eval_done)}, want each of {want_eval} in every "
             "round")
    eval_rounds_run = runs[want_eval[0]]
    with open(worker_log, errors="replace") as f:
        wlog = f.read()
    for mode in ("training", "evaluation"):
        if f"Columnar task path engaged ({mode}" not in wlog:
            fail(f"the columnar route was not engaged for {mode}:\n{tail(worker_log)}")
    readers = journal_events(wevents, "data_readers")
    if not readers or readers[0]["record_codec"] != "native":
        fail(f"the native ETRF codec did not serve the worker: {readers}")
    done = journal_events(wevents, "worker_task_done")
    last = done[-1]
    if last["etrf_per_record_reads"]:
        fail(f"the worker read {last['etrf_per_record_reads']} tasks record by record")
    train_steps, eval_batches = last["process_steps"], last["process_eval_batches"]
    want_launches = {"fused_lookup": 2 * train_steps + 2 * eval_batches,
                     "fused_dedup_apply": 2 * train_steps}
    if train_steps != steps or last["kernel_launches"] != want_launches:
        fail(f"the worker launched {last['kernel_launches']} in {train_steps} steps and "
             f"{eval_batches} evaluation batches (want {want_launches}, {steps} steps)")
    exits = journal_events(wevents, "worker_exit")
    if (last["forbidden_modules"] or not exits or exits[0]["forbidden_modules"]
            or master["master_exit"][-1]["forbidden_modules"]
            or not master["master_exit"][-1]["succeeded"]):
        fail(f"forbidden modules or a failed exit: worker {last['forbidden_modules']}, "
             f"{exits}, master {master['master_exit'][-1]}")
    # The final round against the final checkpoint, evaluated here.
    saver = ShardedCheckpointSaver(ckpt)
    last_step = saver.latest_step()
    if last_step != steps:
        fail(f"the last checkpoint is step {last_step}, want {steps}")
    zoo = resolve(MODEL_DEF)
    trainer = ShardedEmbeddingTrainer(build_model(MODEL_DEF, params + ",sparse_apply_every=1"),
                                      zoo.loss, zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer())
    trainer.set_sharded_restore(saver, last_step)
    trainer.ensure_initialized()
    here_metrics, examples = in_process_metrics(trainer, val_dir, batch)
    del trainer
    torch.cuda.empty_cache()
    final = rounds[-1]["metrics"]
    if (examples != validation or final["accuracy"] != here_metrics["accuracy"]
            or abs(final["auc"] - here_metrics["auc"]) > AUC_TOL
            or not all(np.isfinite(v) for v in final.values())):
        fail(f"the job's final metrics {final} against {here_metrics} in process")
    # Figures, on the host's clock.  Steady: training tasks but the
    # first (start-up); no save falls inside one (the only save is at
    # the end).
    train_done = [e for e in done if e["type"] == "TRAINING"]
    steady = train_done[1:]
    steady_s = sum(e["seconds"] for e in steady)
    steady_rate = sum(e["records"] for e in steady) / steady_s
    wait_share = sum(e["data_wait_s"] for e in steady) / steady_s
    eval_done_w = [e for e in done if e["type"] == "EVALUATION"]
    eval_rate = sum(e["records"] for e in eval_done_w) / sum(e["seconds"] for e in eval_done_w)
    durations = {e["task_id"]: e["duration_s"] for e in master["task_done"]}
    ids = [e["task_id"] for e in steady]

    def mean(values):
        values = list(values)
        return sum(values) / len(values)

    split = {
        "task_s": mean(e["seconds"] for e in steady),
        "dispatch_to_done_s": mean(durations[t] for t in ids),
        "data_wait_s": mean(e["data_wait_s"] for e in steady),
        "columnar_read_parse_s": mean(e["columnar_s"] - e["columnar_transform_s"]
                                      for e in steady),
        "columnar_transform_s": mean(e["columnar_transform_s"] for e in steady),
        "stage_s": mean(e["stage_s"] for e in steady),
        "stage_overlap_s": mean(e["stage_overlap_s"] for e in steady),
        "prefetch_overlap_s": mean(e["prefetch_overlap_s"] for e in steady),
    }
    first = journal_events(wevents, "first_step")
    launch = journal_events(events, "worker_launch")
    host_split = materialize_split(train_dir, per_task)
    result = {
        "records": n, "shards": shards, "validation_records": validation,
        "records_per_task": per_task, "batch": batch, "steps": steps,
        "files_bytes": written, "write_s": write_s, "wall_s": wall,
        "first_dispatch_s": master["task_dispatch"][0]["ts"] - master["master_start"][0]["ts"],
        "worker_launch_to_first_step_s": first[0]["ts"] - launch[0]["ts"],
        "steady_tasks": len(steady), "steady_samples_per_s": steady_rate,
        "steady_data_wait_share": wait_share, "steady_task_split_s": split,
        "materialize_split_ms": host_split,
        "phase26_steady_samples_per_s": None if elastic is None else
        elastic["steady_samples_per_s"],
        "phase26_steady_data_wait_share": None if elastic is None else
        elastic["steady_data_wait_share"],
        "eval_samples_per_s": eval_rate, "eval_rounds_run": eval_rounds_run,
        "eval_round_s": {r["model_version"]: r["seconds"] for r in rounds},
        "final_metrics": final, "in_process_metrics": here_metrics,
        "auc_abs_diff": abs(final["auc"] - here_metrics["auc"]),
        "per_worker": {0: {"steps": train_steps, "eval_batches": eval_batches,
                           "launches": last["kernel_launches"]}},
        "record_codec": readers[0]["record_codec"],
        "goodput": ledger_summary(events, "etrf job"),
        "journal_records_checked": journals_schema(ckpt, "etrf job"), "card": card,
    }
    log(f"etrf job: goodput_ratio {result['goodput']['goodput_ratio']!r} over "
        f"{result['goodput']['wall_s']!r} s (phases {result['goodput']['phases_s']}) [{card}]")
    log(f"etrf job: {steady_rate!r} samples/s over {len(steady)} steady tasks (phase 26 in "
        f"this call: {result['phase26_steady_samples_per_s']!r}); the step loop waited for "
        f"host data {wait_share!r} of their time (phase 26: "
        f"{result['phase26_steady_data_wait_share']!r}); a steady task's mean split {split} s; "
        f"one task's materialisation in this process {host_split} ms; "
        f"evaluation {eval_rate!r} samples/s, rounds {result['eval_round_s']} s ("
        f"{eval_rounds_run} run); final metrics {final}, in process {here_metrics}; worker "
        f"launch -> first step {result['worker_launch_to_first_step_s']!r} s; K2/K3 "
        f"{last['kernel_launches']} in {train_steps} steps and {eval_batches} evaluation "
        f"batches; codec {result['record_codec']}; wall {wall!r} s [{card}]")
    shutil.rmtree(job, ignore_errors=True)
    return result


#: The build of each of K7-K9 at RING_BENCH (bf16, head_dim 128) and on
#: the CP LM's path (head_dim 64); K8 and K9 with the path's bf16 dO (one
#: part).
RING_BUILDS = {
    "flash_ring_step_carry": ("ring_fwd_mma_kernel<bf16, 128>", "ring_fwd_mma_kernel<bf16, 64>"),
    "flash_ring_step_dq": ("ring_dq_mma_kernel<bf16, 128, 1>", "ring_dq_mma_kernel<bf16, 64, 1>"),
    "flash_ring_step_dkv": ("ring_dkv_mma_kernel<bf16, 128, 1>",
                            "ring_dkv_mma_kernel<bf16, 64, 1>"),
}


# ----------------------------------------------------------------------
# phases 28-29: the vision zoo, DataParallelTrainer and the Local job
# ----------------------------------------------------------------------


def vision_model(params: dict, use_bf16: bool = True, device=None):
    from elasticdl_tpu_torch.zoo import resnet50

    return resnet50.custom_model(use_bf16=use_bf16, device=device, **params)


def vision_time_parts(trainer, staged):
    """One DataParallelTrainer step through its three parts, between CUDA
    events (ms each)."""
    import torch

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    marks[0].record()
    loss = trainer.forward(*staged)
    marks[1].record()
    grads = trainer.backward(loss)
    marks[2].record()
    trainer.dense_update(grads)
    marks[3].record()
    torch.cuda.synchronize()
    names = ("forward", "backward", "dense_update")
    return {name: marks[i].elapsed_time(marks[i + 1]) for i, name in enumerate(names)}


def flat_numpy(tree) -> "np.ndarray":
    import numpy as np

    return np.concatenate([np.ravel(np.asarray(tree[k], np.float64)) for k in sorted(tree)])


def rel_update(a, b, start) -> float:
    """``|(a - start) - (b - start)| / |a - start|``, flattened."""
    import numpy as np

    da, db = flat_numpy(a) - flat_numpy(start), flat_numpy(b) - flat_numpy(start)
    return float(np.linalg.norm(da - db) / max(np.linalg.norm(da), 1e-30))


def vision_kernel_category(name: str) -> str:
    """A coarse class of a device record's name, for a step's breakdown."""
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "implicit", "dgrad", "wgrad", "cudnn", "gemm",
                              "cutlass", "nhwc")):
        return "conv and gemm"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low or "vectorized" in low or "foreach" in low:
        return "elementwise"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def vision_profile(trainer, staged, step_ms: float) -> dict:
    """One step's device records (``torch.profiler``, 2 steps): its
    device time by class and its top kernels, the launches, and the share
    of the step (CUDA events) the card was busy; None without records."""
    prof = profile_launches(lambda: trainer.train_step_staged(staged), calls=2)
    if prof is None:
        return None
    classes = {}
    for name, r in prof["by_kernel"].items():
        c = classes.setdefault(vision_kernel_category(name), {"ms": 0.0, "launches": 0.0})
        c["ms"] += r["ms"]
        c["launches"] += r["launches"]
    top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1]["ms"])[:6]
    return {"device_ms": prof["device_ms"], "launches": prof["launches"],
            "busy_share": prof["device_ms"] / step_ms, "by_class": classes,
            "top_kernels": dict(top)}


def vision_f32_gate(card: str, seed: int, params: dict, size: int, batch: int) -> dict:
    """Gate 1: ResNet-50 in f32, eval mode, weights from a seeded random
    JAX-layout tree carried over by ``serving.convert``: the card's
    forward (channels_last, cuDNN) against the port's CPU forward."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.serving import convert

    cpu = vision_model(params, use_bf16=False, device="cpu")
    state = convert.state_dict_from_jax(convert.random_jax_variables(cpu, seed)[0], cpu)
    convert.load_state(cpu, state)
    on_card = vision_model(params, use_bf16=False)
    convert.load_state(on_card, state)
    if not on_card.Conv_0.weight.is_contiguous(memory_format=torch.channels_last):
        fail("the ResNet-50 on the card is not channels_last")
    x = np.random.default_rng(seed + 28).integers(0, 256, (batch, size, size, 3), np.uint8)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu(torch.from_numpy(x), train=False).numpy()
        cpu_s = time.perf_counter() - t0
        got = on_card(torch.from_numpy(x).to(card_device()), train=False).cpu().numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if not (np.isfinite(got).all() and err <= VISION_F32_RTOL * scale):
        fail(f"the card's f32 ResNet-50 forward is {err!r} from the CPU's (largest logit "
             f"{scale!r}, tolerance {VISION_F32_RTOL} of it)")
    log(f"vision gate 1: f32 eval forward, batch {batch}: card vs CPU max |diff| {err!r} "
        f"(largest logit {scale!r}, tolerance {VISION_F32_RTOL} of it); the CPU forward took "
        f"{cpu_s!r} s [{card}]")
    del cpu, on_card
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_logit": scale, "rtol": VISION_F32_RTOL, "batch": batch}


def vision_paths_gate(card: str, seed: int, params: dict, images, labels) -> dict:
    """Gate 2: the single-device ``Trainer`` and ``DataParallelTrainer`` on
    the card, 3 steps from one state on the same batches, cuDNN's
    deterministic algorithms on both."""
    import torch

    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.worker.trainer import Trainer, TrainState
    from elasticdl_tpu_torch.zoo import resnet50 as zoo

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dp = DataParallelTrainer(vision_model(params), zoo.loss, zoo.optimizer(VISION_LR),
                                 seed=seed + 1)
        dp.ensure_initialized()
        start = dp.state_to_host()
        local = Trainer(vision_model(params), zoo.loss, zoo.optimizer(VISION_LR), seed=seed + 2)
        local.state = TrainState(*start)
        local.ensure_initialized()
        for i in range(3):
            dp.train_step(images[i], labels[i])
            local.train_step(images[i], labels[i])
        a = dp.state_to_host()
        b_params, b_stats = ({k: v.detach().cpu().numpy() for k, v in tree.items()}
                             for tree in (local.state.params,
                                          local.state.model_state["batch_stats"]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    result = {"params_rel_update": rel_update(a.params, b_params, start.params),
              "batch_stats_rel_update": rel_update(a.model_state["batch_stats"], b_stats,
                                                   start.model_state["batch_stats"]),
              "rtol": VISION_PATHS_RTOL}
    if not (result["params_rel_update"] <= VISION_PATHS_RTOL
            and result["batch_stats_rel_update"] <= VISION_PATHS_RTOL):
        fail(f"Trainer and DataParallelTrainer disagree after 3 steps: {result}")
    log(f"vision gate 2: 3 steps, Trainer vs DataParallelTrainer: parameter updates "
        f"{result['params_rel_update']!r}, batch_stats moves "
        f"{result['batch_stats_rel_update']!r} apart (relative L2; tolerance "
        f"{VISION_PATHS_RTOL}) [{card}]")
    del dp, local
    torch.cuda.empty_cache()
    return result


def vision_training_phase(card: str, seed: int, batch: int = VISION_BATCH,
                          size: int = VISION_SIZE, classes: int = VISION_CLASSES,
                          warmup: int = 3, steps: int = 20, gate_batch: int = 8):
    """Phase 28: ResNet-50 trained through ``DataParallelTrainer`` (a world
    of one) at ``bench_resnet50``'s width; then gates 1 and 2."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import resnet50 as zoo

    params = {"num_classes": classes}
    n_batches = 4
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n_batches, batch, size, size, 3), np.uint8)
    labels = rng.integers(0, classes, (n_batches, batch)).astype(np.int32)
    trainer = DataParallelTrainer(vision_model(params), zoo.loss, zoo.optimizer(VISION_LR),
                                  seed=seed)
    if trainer.device.type != "cuda":
        fail(f"DataParallelTrainer's default device is {trainer.device}, not cuda")
    trainer.ensure_initialized()
    ones = np.ones((batch,), np.float32)
    staged = [trainer.stage_batch(images[i], labels[i], ones) for i in range(n_batches)]
    stats = trainer.state.model_state["batch_stats"]
    stats0 = {k: v.detach().clone() for k, v in stats.items()}
    n_params = sum(p.numel() for p in trainer.state.params.values())
    log(f"ResNet-50 trainer on {trainer.device}: {n_params} parameters, {len(stats)} "
        f"batch_stats leaves, batch {batch}x{size}x{size}x3 uint8, bf16")
    losses = [trainer.train_step_staged(staged[i % n_batches]) for i in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step_staged(staged[i % n_batches]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.all(np.isfinite(losses)):
        fail(f"non-finite ResNet-50 loss: {losses}")
    moved = max(float((stats[k] - stats0[k]).abs().max()) for k in stats)
    if not moved > 0:
        fail("the ResNet-50 batch_stats did not move in training")
    splits = [vision_time_parts(trainer, staged[i % n_batches]) for i in range(5)]
    parts = {name: sorted(p[name] for p in splits)[2] for name in splits[0]}
    host = []
    for i in range(5):  # enqueue time of one step after an empty queue
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step_staged(staged[i % n_batches])
        host.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    profile = vision_profile(trainer, staged[0], step_ms[len(step_ms) // 2])
    train = {
        "images_per_s": steps * batch / wall,
        "step_ms_median": step_ms[len(step_ms) // 2],
        "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
        "split_ms_median": parts, "host_enqueue_ms_median": sorted(host)[2],
        "peak_memory_gb": peak / 1e9, "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]), "batch_stats_max_move": moved,
        "shape": f"{batch}x{size}x{size}x3 uint8, {classes} classes, bf16, stages "
                 f"{zoo.STAGE_SIZES}",
        "profile": profile,
    }
    log(f"ResNet-50 train: {steps} steps: {train['images_per_s']!r} images/s (host wall), "
        f"step median {train['step_ms_median']!r} ms (CUDA events; min {step_ms[0]!r}, max "
        f"{step_ms[-1]!r}); median split {parts} ms; one step's host enqueue after an empty "
        f"queue {train['host_enqueue_ms_median']!r} ms; peak {peak / 1e9!r} GB; loss "
        f"{losses[0]!r} -> {losses[-1]!r}; batch_stats moved (max |change| {moved!r}) "
        f"[{card}]")
    if profile is None:
        log("ResNet-50 step profile: torch.profiler recorded no device time")
    else:
        log(f"ResNet-50 step profile (torch.profiler, 2 steps): {profile['device_ms']!r} ms of "
            f"device time a step in {profile['launches']!r} launches, busy "
            f"{profile['busy_share']!r} of the step; by class "
            f"{ {k: round(v['ms'], 3) for k, v in profile['by_class'].items()} } ms; top "
            f"{ {k[:60]: round(v['ms'], 3) for k, v in profile['top_kernels'].items()} } "
            f"[{card}]")
    del trainer, staged
    torch.cuda.empty_cache()
    train["gate_f32_forward"] = vision_f32_gate(card, seed, params, size, gate_batch)
    train["gate_trainer_paths"] = vision_paths_gate(card, seed, params, images, labels)
    return train


def write_image_shards(directory: str, reader, lo: int, n: int, shards: int) -> int:
    """``n`` records of ``reader`` from ``lo`` as ``shards`` image-ETRF files
    (``data/image.write_image_etrf``); returns the bytes written."""
    import numpy as np

    from elasticdl_tpu_torch.data.image import write_image_etrf

    os.makedirs(directory, exist_ok=True)
    per = n // shards
    written = 0
    for shard in range(shards):
        rows = range(lo + shard * per, lo + (shard + 1) * per)
        images = np.stack([reader.image(i) for i in rows])
        labels = np.asarray([reader.labels[i] for i in rows], np.int32)
        path = os.path.join(directory, f"part-{shard:05d}.etrf")
        write_image_etrf(path, images, labels)
        written += os.path.getsize(path)
    return written


def local_job_phase(card: str, seed: int, workdir: str, shards: int = VISION_SHARDS,
                    per_shard: int = VISION_PER_SHARD, validation: int = VISION_VALIDATION,
                    stored: int = VISION_STORE_SIZE, batch: int = VISION_BATCH,
                    per_task: int = VISION_PER_TASK, eval_steps: int = VISION_EVAL_STEPS,
                    classes: int = VISION_CLASSES, crop: int = VISION_SIZE, model_params="",
                    extra_flags=()):
    """Phase 29: ``python -m elasticdl_tpu_torch.client.main train
    --distribution_strategy=Local`` trains ResNet-50 from image ETRF
    shards on the card, evaluates every ``eval_steps`` versions and
    exports; the export, reloaded through ``serving/export.py``, is
    evaluated here over the same validation records."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import SyntheticImagenetReader
    from elasticdl_tpu_torch.serving.export import load_for_serving
    from elasticdl_tpu_torch.zoo import resnet50 as zoo
    from elasticdl_tpu_torch.zoo import resolve

    job = os.path.join(workdir, "local")
    train_dir, val_dir = os.path.join(job, "train"), os.path.join(job, "validation")
    journal_dir, out = os.path.join(job, "journal"), os.path.join(job, "export")
    n = shards * per_shard
    reader = SyntheticImagenetReader(n=n + validation, seed=seed, image_size=stored,
                                     num_classes=classes)
    require_free(workdir, 2 * (n + validation) * (stored * stored * 3 + 12),
                 "the Local job's image shards")
    t0 = time.perf_counter()
    written = write_image_shards(train_dir, reader, 0, n, shards)
    written += write_image_shards(val_dir, reader, n, validation, 1)
    log(f"local job: wrote {shards} training shards of {per_shard} {stored}x{stored} images and "
        f"one validation shard of {validation} ({written} bytes) in "
        f"{time.perf_counter() - t0!r} s, before the job")
    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
            "--distribution_strategy=Local", "--model_zoo=model_zoo", f"--model_def={VISION_DEF}",
            f"--training_data={train_dir}", f"--validation_data={val_dir}",
            f"--evaluation_steps={eval_steps}", f"--minibatch_size={batch}",
            f"--records_per_task={per_task}", f"--output={out}",
            f"--checkpoint_dir={journal_dir}", f"--model_params=num_classes={classes}"
            + (f",{model_params}" if model_params else ""), *extra_flags]
    job_log = os.path.join(job, "job.log")
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_start = time.time()
    with open(job_log, "wb") as log_file:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        fail(f"the Local job did not finish within 900 s:\n{tail(job_log)}")
    wall = time.time() - t_start
    if rc != 0:
        fail(f"the Local job exited {rc}:\n{tail(job_log)}")
    events = os.path.join(journal_dir, "events.jsonl")
    journal = {name: journal_events(events, name) for name in (
        "task_dispatch", "task_done", "task_requeue", "evaluation_metrics", "worker_task_done",
        "local_job_exit")}
    if journal["task_requeue"]:
        fail(f"tasks were requeued: {journal['task_requeue']}")
    dispatched = {e["task_id"]: e for e in journal["task_dispatch"]}
    done_ids = [e["task_id"] for e in journal["task_done"]]
    if sorted(done_ids) != sorted(dispatched):
        fail(f"dispatched {sorted(dispatched)}, done {sorted(done_ids)}")
    by_type = {}
    for tid in done_ids:
        e = dispatched[tid]
        by_type.setdefault(e["type"], []).append((os.path.basename(e["shard"]), e["start"],
                                                  e["end"]))
    want_train = sorted((f"part-{i:05d}.etrf", lo, min(lo + per_task, per_shard))
                        for i in range(shards) for lo in range(0, per_shard, per_task))
    if sorted(by_type.get("TRAINING", [])) != want_train:
        fail(f"training ranges done {sorted(by_type.get('TRAINING', []))}, want {want_train}")
    want_eval = {("part-00000.etrf", lo, min(lo + per_task, validation))
                 for lo in range(0, validation, per_task)}
    if set(by_type.get("EVALUATION", [])) != want_eval:
        fail(f"evaluation ranges done {by_type.get('EVALUATION')}, want {sorted(want_eval)}")
    steps = n // batch
    rounds = journal["evaluation_metrics"]
    want_versions = list(range(eval_steps, steps + 1, eval_steps))
    if [r["model_version"] for r in rounds] != want_versions or any(
            r["examples"] != validation for r in rounds):
        fail(f"evaluation rounds {rounds}, want versions {want_versions} of {validation} rows")
    with open(job_log, errors="replace") as f:
        text = f.read()
    for mode, rows in (("training", per_task), ("evaluation", min(per_task, validation))):
        engaged = f"Columnar task path engaged ({mode}, {rows} rows of [{crop}, {crop}, 3]"
        if engaged not in text:
            fail(f"no '{engaged}' in the job's log:\n{tail(job_log)}")
    exits = journal["local_job_exit"]
    if not exits or exits[-1]["forbidden_modules"] or exits[-1]["steps"] != steps:
        fail(f"the Local job's exit record: {exits}")
    done = journal["worker_task_done"]
    train_done = [e for e in done if e["type"] == "TRAINING"]
    if any(e["batch_shape"] != [crop, crop, 3] for e in done):
        fail(f"a task's batches are not {crop}x{crop}: {[e['batch_shape'] for e in done]}")
    # The exported model, reloaded and evaluated here.
    served = load_for_serving(out)
    val_columns = list(zoo.ImageRecordReader(val_dir).read_columns(
        types.SimpleNamespace(shard_name=os.path.join(val_dir, "part-00000.etrf"), start=0,
                              end=validation)))[0]
    val_images, val_labels = zoo.columnar_dataset_fn(val_columns, "evaluation", None)
    logits = np.concatenate([served.predict(val_images[lo:lo + batch])
                             for lo in range(0, validation, batch)])
    here_metrics = {name: float(fn(logits, val_labels)) for name, fn in
                    resolve(VISION_DEF).eval_metrics_fn().items()}
    final = rounds[-1]["metrics"]
    loss_rel_diff = abs(final["loss"] - here_metrics["loss"]) / abs(here_metrics["loss"])
    if final["accuracy"] != here_metrics["accuracy"] or not all(
            np.isfinite(v) for v in final.values()) or not loss_rel_diff <= VISION_LOSS_RTOL:
        fail(f"the job's final metrics {final} against {here_metrics} from the export (loss "
             f"relative difference {loss_rel_diff!r}, tolerance {VISION_LOSS_RTOL})")
    del served
    torch.cuda.empty_cache()
    steady = train_done[1:]
    records = sum(e["steps"] for e in steady) * batch
    seconds = sum(e["seconds"] for e in steady)
    mean = {key: 1e3 * sum(e[key] for e in steady) / len(steady)
            for key in ("seconds", "data_wait_s", "columnar_s", "columnar_transform_s",
                        "stage_s")}
    result = {
        "images_per_s_steady": records / seconds,
        "task_ms_mean": {"task": mean["seconds"], "data_wait": mean["data_wait_s"],
                         "read_and_parse": mean["columnar_s"] - mean["columnar_transform_s"],
                         "crop": mean["columnar_transform_s"], "stage": mean["stage_s"]},
        "rounds": [{"version": r["model_version"], "seconds": r["seconds"],
                    "metrics": r["metrics"]} for r in rounds],
        "final_metrics": final, "export_metrics": here_metrics,
        "loss_rel_diff": loss_rel_diff, "wall_s": wall,
        "steps": steps, "job_seconds": exits[-1]["seconds"],
    }
    log(f"local job: {steps} steps of {batch} in {len(train_done)} tasks of {per_task} from "
        f"{stored}x{stored} ETRF cropped to {crop}: {result['images_per_s_steady']!r} images/s "
        f"over the steady tasks (host clock); a steady task's mean split (ms) "
        f"{result['task_ms_mean']}; {len(rounds)} evaluation rounds "
        f"{[(r['version'], r['seconds']) for r in result['rounds']]} (version, s); final "
        f"{final} = the export's {here_metrics} (loss relative difference {loss_rel_diff!r}, "
        f"tolerance {VISION_LOSS_RTOL}); wall {wall!r} s [{card}]")
    return result



# ----------------------------------------------------------------------
# phases 30-32: the CTR zoo, Census as a PS job, the supervised fleet
# ----------------------------------------------------------------------


def ctr_zoo_batches(zoo, path: str, batch: int, n_batches: int):
    """``n_batches`` training batches of ``batch`` from the zoo's reader of
    ``path`` through its ``dataset_fn`` (the shuffle included), each
    ``(features, labels, mask)``."""
    import numpy as np

    from elasticdl_tpu_torch.data.dataset import Dataset, _stack

    n = batch * n_batches
    reader = zoo.custom_data_reader(path)
    records = list(reader.read_records(types.SimpleNamespace(start=0, end=n, shard_name="")))
    rows = list(zoo.dataset_fn(Dataset.from_iterable(records), "training", None))
    return [(*_stack(rows[i:i + batch]), np.ones((batch,), np.float32))
            for i in range(0, n, batch)]


def ctr_zoo_kernels(ske, pk, trainer, opt, staged, flush, label, card):
    """K2 and K3 (``opt``'s kind) alone on one step's shapes of
    ``trainer``'s tables (the ids and gradients the step captures): K2
    bit-exact with its plain
    version, K3 over two applies bit-exact with its plain version under
    deterministic algorithms; each timed (CUDA events, L2 flushed) as
    the kernel alone and the whole call, beside the plain version and
    the bytes bound."""
    import torch

    loss, cap = trainer.forward(*staged)
    _, sparse, _ = trainer.backward(loss, cap)
    out = {"fused_lookup": {}, "fused_dedup_apply": {}}
    for key, (ids, grads) in sparse.items():
        spec, table = trainer.table_specs[key], trainer.state.tables[key]
        ids, grads = ids.contiguous(), grads.detach().contiguous()
        n = ids.shape[0]
        shape = f"ids [{n}], table {list(spec.rows_shape)}, dim {spec.dim}"
        split = k2_split(ske, spec, table, ids, flush)
        k2 = {"shape": shape, "max_abs_err": check_lookup(ske, spec, table, ids),
              "kernel_ms": split["kernel_ms"], "ms": split["call_ms"],
              "plain_ms": median_ms(lambda: ske.fused_lookup_plain(spec, table, ids), flush),
              "bound_ms": bound_ms(lookup_bytes(n, spec.dim)), "bound_by": "bytes",
              "library_ms": None}
        out["fused_lookup"][key] = k2
        touched = int(pk.dedup_representatives(spec, ids, grads)[2].sum())
        operands = 1 + len(ske.KIND_SLOTS[opt.kind])
        err, (t_kernel, s_kernel), (t_plain, s_plain) = k3_two_applies(
            ske, spec, opt.kind, opt.hyperparams, table, ids, grads, f"[{label} {key}]")
        split = k3_split(ske, spec, opt.kind, opt.hyperparams, t_kernel, s_kernel, ids, grads,
                         flush)
        k3 = {"shape": f"{shape}, {touched} touched rows, {opt.kind}", "max_abs_err": err,
              "kernel_ms": split["kernel_ms"], "ms": split["call_ms"],
              "plain_ms": median_ms(lambda: ske.fused_dedup_apply_plain(
                  spec, opt.kind, opt.hyperparams, t_plain, s_plain, ids, grads), flush),
              "bound_ms": bound_ms(k3_bytes(n, spec.dim, touched, operands)),
              "bound_by": "bytes", "library_ms": None, "touched_rows": touched}
        out["fused_dedup_apply"][key] = k3
        for name, r in (("fused_lookup", k2), ("fused_dedup_apply", k3)):
            log(f"kernel {name} on {label}'s {key}: {r['shape']}: bit-exact with the plain "
                f"version; kernel alone {r['kernel_ms']!r} ms, whole call {r['ms']!r} ms "
                f"(plain {r['plain_ms']!r} ms, bound {r['bound_ms']!r} ms) [{card}]")
        del t_kernel, s_kernel, t_plain, s_plain
    return out


def ctr_zoo_phase(card: str, seed: int, models=None, warmup: int = 3,
                  steps: int = CTR_ZOO_STEPS, n_batches: int = 8):
    """Phase 30: each of CTR_ZOO's models through ShardedEmbeddingTrainer
    on the card: ``steps`` timed steps after ``warmup`` (K2 and K3 twice
    a step, no K1), the kernel path against the plain path over 3 steps
    from one state (losses, tables and dense params at phase 7's
    tolerances), then K2 and K3 alone on the step's shapes."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel import packed as pk
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    dev = card_device()
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    results = {}
    for model_def, params, batch, path, lr in models or CTR_ZOO:
        zoo = resolve(model_def)
        batches = ctr_zoo_batches(zoo, path.format(n=batch * n_batches, seed=seed), batch,
                                  n_batches)
        trainer = ShardedEmbeddingTrainer(build_model(model_def, params), zoo.loss,
                                          zoo.optimizer(),
                                          embedding_optimizer=zoo.embedding_optimizer(),
                                          seed=seed)
        if trainer.device.type != "cuda":
            fail(f"{model_def}: ShardedEmbeddingTrainer's default device is {trainer.device}")
        trainer.ensure_initialized()
        staged = [trainer.stage_batch(*b) for b in batches]
        losses = [trainer.train_step_staged(staged[i % n_batches]) for i in range(warmup)]
        torch.cuda.synchronize()
        ske.reset_launch_counts()
        events = []
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            losses.append(trainer.train_step_staged(staged[i % n_batches]))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ske.launch_counts()
        want = {name: per_step * steps for name, per_step in CTR_ZOO_LAUNCHES.items()}
        if {k: counts[k] for k in want} != want:
            fail(f"{model_def}: launched {counts} in {steps} steps (want {want})")
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)):
            fail(f"{model_def}: non-finite training loss {losses}")
        step_ms = sorted(s.elapsed_time(e) for s, e in events)
        specs = {key: list(spec.rows_shape) for key, spec in trainer.table_specs.items()}
        r = {"batch": batch, "tables": specs, "samples_per_s": steps * batch / wall,
             "step_ms_median": step_ms[len(step_ms) // 2],
             "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
             "launches": {k: counts[k] for k in ske.launch_counts()},
             "launches_per_step": {k: counts[k] / steps for k in want}}
        log(f"ctr zoo {model_def} ({params or 'defaults'}), batch {batch}, tables {specs}: "
            f"{steps} steps, {r['samples_per_s']!r} samples/s (host wall), step median "
            f"{r['step_ms_median']!r} ms (CUDA events); launches per step "
            f"{r['launches_per_step']} ({counts} in {steps}); loss {r['loss_first']!r} -> "
            f"{r['loss_last']!r} [{card}]")
        r["path"] = compare_paths(trainer, staged, card, f"{model_def}: kernel path vs plain "
                                  "path (tables and dense params)", lr=lr, dense=True)
        r["kernels"] = ctr_zoo_kernels(ske, pk, trainer, zoo.embedding_optimizer(), staged[0],
                                       flush, model_def, card)
        results[model_def] = r
        del trainer, staged
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return results


def census_eval_batches(records, batch: int):
    """Evaluation batches of the census zoo's ``dataset_fn`` (no shuffle)."""
    from elasticdl_tpu_torch.data.dataset import Dataset, _stack
    from elasticdl_tpu_torch.zoo import census_wide_deep as census

    rows = list(census.dataset_fn(Dataset.from_iterable(records), "evaluation", None))
    return [_stack(rows[i:i + batch]) for i in range(0, len(rows), batch)]


def census_job_phase(card: str, seed: int, workdir: str, n: int = CENSUS_RECORDS,
                     validation: int = CENSUS_VALIDATION, batch: int = CENSUS_BATCH,
                     per_task: int = CENSUS_PER_TASK, epochs: int = CENSUS_EPOCHS,
                     eval_steps: int = CENSUS_EVAL_STEPS, extra_flags=()):
    """Phase 31: ``python -m elasticdl_tpu_torch.client.main train
    --distribution_strategy=ParameterServerStrategy`` trains census
    Wide&Deep on the card from ``n`` raw synthetic census records
    (``epochs`` epochs, tasks of ``per_task``, batch ``batch``), evaluates
    ``validation`` records every ``eval_steps`` versions and exports.
    Gates: exit 0; every range done, every round over the validation
    records; the loss falls; 2 K2 and 2 K3 a step and 2 K2 an evaluation
    batch in the worker's journal; no forbidden module; the export
    C-contiguous, and its in-process evaluation on the same records
    equal to the job's final metrics (accuracy exactly, AUC within
    AUC_TOL)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_census_records
    from elasticdl_tpu_torch.serving.export import load_for_serving, read_variables
    from elasticdl_tpu_torch.zoo import resolve

    job = os.path.join(workdir, "census")
    ckpt, out = os.path.join(job, "ckpt"), os.path.join(job, "export")
    os.makedirs(job)
    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
            "--distribution_strategy=ParameterServerStrategy", "--model_zoo=model_zoo",
            f"--model_def={CENSUS_DEF}", f"--training_data=synthetic://census?n={n}&seed={seed}",
            f"--validation_data=synthetic://census?n={validation}&seed={seed + 1}",
            f"--minibatch_size={batch}", f"--records_per_task={per_task}",
            f"--num_epochs={epochs}", f"--evaluation_steps={eval_steps}", f"--output={out}",
            f"--checkpoint_dir={ckpt}", "--checkpoint_steps=1000000", *extra_flags]
    job_log = os.path.join(job, "job.log")
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_start = time.time()
    with open(job_log, "wb") as log_file:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        fail(f"the census job did not finish within 900 s:\n{tail(job_log)}")
    wall = time.time() - t_start
    worker_log = os.path.join(ckpt, "elasticdl-job_worker_logs", "worker_0.log")
    if rc != 0:
        fail(f"the census job exited {rc}:\n{tail(job_log)}\n--- worker 0\n{tail(worker_log)}")
    events = os.path.join(ckpt, "events.jsonl")
    wevents = os.path.join(ckpt, "events_worker_0.jsonl")
    master = {name: journal_events(events, name) for name in (
        "task_dispatch", "task_done", "task_requeue", "evaluation_metrics", "worker_launch",
        "master_exit")}
    if master["task_requeue"]:
        fail(f"tasks were requeued: {master['task_requeue']}")
    dispatched = {e["task_id"]: e for e in master["task_dispatch"]}
    by_type = {}
    for e in master["task_done"]:
        d = dispatched[e["task_id"]]
        by_type.setdefault(d["type"], []).append((d["start"], d["end"]))
    want_train = sorted([(lo, min(lo + per_task, n)) for lo in range(0, n, per_task)] * epochs)
    if sorted(by_type.get("TRAINING", [])) != want_train:
        fail(f"training ranges done {sorted(by_type.get('TRAINING', []))}, want {want_train}")
    steps = epochs * n // batch
    rounds = master["evaluation_metrics"]
    want_versions = list(range(eval_steps, steps + 1, eval_steps))
    if [r["model_version"] for r in rounds] != want_versions or any(
            r["examples"] != validation for r in rounds):
        fail(f"evaluation rounds {rounds}, want versions {want_versions} of {validation} rows")
    done = journal_events(wevents, "worker_task_done")
    last = done[-1]
    train_steps, eval_batches = last["process_steps"], last["process_eval_batches"]
    want_launches = {"fused_lookup": 2 * train_steps + 2 * eval_batches,
                     "fused_dedup_apply": 2 * train_steps}
    if train_steps != steps or last["kernel_launches"] != want_launches:
        fail(f"the worker launched {last['kernel_launches']} in {train_steps} steps and "
             f"{eval_batches} evaluation batches (want {want_launches}, {steps} steps)")
    exits = journal_events(wevents, "worker_exit")
    if (last["forbidden_modules"] or not exits or exits[0]["forbidden_modules"]
            or master["master_exit"][-1]["forbidden_modules"]
            or not master["master_exit"][-1]["succeeded"]):
        fail(f"forbidden modules or a failed exit: worker {last['forbidden_modules']}, "
             f"{exits}, master {master['master_exit'][-1]}")
    with open(worker_log, errors="replace") as f:
        task_losses = [float(x) for x in re.findall(r"task \d+ done: step=\d+ loss=([-\d.e]+)",
                                                   f.read())]
    if len(task_losses) < 4 or not np.mean(task_losses[-2:]) < np.mean(task_losses[:2]):
        fail(f"the census job's loss did not fall: per task {task_losses}")
    # The export: C-contiguous dense leaves, then evaluated here.
    with open(os.path.join(out, "signature.json")) as f:
        signature = json.load(f)
    loose = [path for path, leaf in tree_leaves(read_variables(
        os.path.join(out, "variables.pkl"))["params"])
             if path[-1] != "__table__" and not np.asarray(leaf).flags.c_contiguous]
    if signature["step"] != steps or loose:
        fail(f"the export is step {signature['step']} (want {steps}); not C-contiguous: {loose}")
    zoo = resolve(CENSUS_DEF)
    served = load_for_serving(out)
    outputs, labels = [], []
    for features, lab in census_eval_batches(synthetic_census_records(validation, seed + 1),
                                             batch):
        outputs.append(served.predict(features))
        labels.append(lab)
    outputs, labels = np.concatenate(outputs), np.concatenate(labels)
    here_metrics = {k: float(fn(outputs, labels)) for k, fn in zoo.eval_metrics_fn().items()}
    final = rounds[-1]["metrics"]
    if (final["accuracy"] != here_metrics["accuracy"]
            or abs(final["auc"] - here_metrics["auc"]) > AUC_TOL
            or not all(np.isfinite(v) for v in final.values())):
        fail(f"the census job's final metrics {final} against the export's {here_metrics}")
    del served
    torch.cuda.empty_cache()
    train_done = [e for e in done if e["type"] == "TRAINING"]
    steady = train_done[1:]
    steady_s = sum(e["seconds"] for e in steady)
    first = journal_events(wevents, "first_step")
    result = {
        "records": n, "validation_records": validation, "batch": batch, "steps": steps,
        "tasks": len(train_done), "steady_samples_per_s": sum(e["records"] for e in steady)
        / steady_s, "steady_data_wait_share": sum(e["data_wait_s"] for e in steady) / steady_s,
        "worker_launch_to_first_step_s": first[0]["ts"] - master["worker_launch"][0]["ts"],
        "eval_round_s": {r["model_version"]: r["seconds"] for r in rounds},
        "eval_metrics": {r["model_version"]: r["metrics"] for r in rounds},
        "final_metrics": final, "export_metrics": here_metrics,
        "task_losses": task_losses, "launches": last["kernel_launches"],
        "launches_per_step": {"fused_lookup": 2, "fused_dedup_apply": 2},
        "eval_batches": eval_batches, "wall_s": wall, "export": out, "checkpoint": ckpt,
        "goodput": ledger_summary(events, "census job"),
        "journal_records_checked": journals_schema(ckpt, "census job"), "card": card,
    }
    log(f"census job: goodput_ratio {result['goodput']['goodput_ratio']!r} over "
        f"{result['goodput']['wall_s']!r} s (phases {result['goodput']['phases_s']}) [{card}]")
    log(f"census job: {steps} steps of {batch} in {len(train_done)} tasks of {per_task}: "
        f"{result['steady_samples_per_s']!r} samples/s over {len(steady)} steady tasks (host "
        f"clock), the step loop waiting for host data {result['steady_data_wait_share']!r} of "
        f"their time; worker launch -> first step {result['worker_launch_to_first_step_s']!r} "
        f"s; evaluation rounds {result['eval_round_s']} s; loss per task {task_losses[0]!r} -> "
        f"{task_losses[-1]!r}; final {final} = the export's {here_metrics}; K2/K3 "
        f"{last['kernel_launches']} in {train_steps} steps and {eval_batches} evaluation "
        f"batches (2 and 2 a step, 2 K2 an evaluation batch); wall {wall!r} s [{card}]")
    return result


def census_requests(seed: int, count: int, rows: int = 8):
    """``count`` requests of ``rows`` raw census records each, through
    ``preprocess_record`` (the host transforms training used)."""
    from elasticdl_tpu_torch.data.dataset import _stack
    from elasticdl_tpu_torch.data.synthetic import synthetic_census_records
    from elasticdl_tpu_torch.zoo import census_wide_deep as census

    records = synthetic_census_records(count * rows, seed)
    feats = [census.preprocess_record(raw) for raw, _ in records]
    return [_stack(feats[i:i + rows]) for i in range(0, len(feats), rows)]


def start_clients(addrs, requests, clients: int, stop):
    """``clients`` closed-loop threads until ``stop``: thread ``w`` sends
    its ``k``-th request to ``addrs[(w + k * clients) % len(addrs)]``.
    Returns ``(threads, records [(t0, t1)], errors)``."""
    import numpy as np

    from elasticdl_tpu_torch.serving.frontend import PredictClient

    records, errors = [], []

    def client(w):
        conns = [PredictClient(a, deadline_s=30.0) for a in addrs]
        i = w
        try:
            while not stop.is_set():
                t0 = time.time()
                try:
                    out = conns[i % len(conns)].predict(requests[i % len(requests)])
                    if out.shape != (8,) or not np.all(np.isfinite(out)):
                        raise ValueError(f"response of shape {out.shape} / non-finite")
                    records.append((t0, time.time()))
                except Exception as exc:  # counted, reported by the caller
                    errors.append(repr(exc))
                i += clients
        finally:
            for c in conns:
                c.close()

    threads = [threading.Thread(target=client, args=(w,), name=f"fleet-client-{w}")
               for w in range(clients)]
    for t in threads:
        t.start()
    return threads, records, errors


def stop_clients(what, threads, stop, records, errors, t_start):
    stop.set()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            fail(f"{what}: client thread {t.name} did not finish")
    seconds = time.time() - t_start
    if errors:
        fail(f"{what}: {len(errors)} of {len(errors) + len(records)} requests failed: "
             f"{errors[:3]}")
    latencies = [b - a for a, b in records]
    return {"requests": len(records), "seconds": seconds,
            "requests_per_s": len(records) / seconds, "p50_ms": percentile_ms(latencies, 50),
            "p99_ms": percentile_ms(latencies, 99)}


def census_fleet_phase(card: str, seed: int, workdir: str, job: dict, clients: int = 8,
                       window_s: float = FLEET_WINDOW_S, gen2_steps: int = CENSUS_GEN2_STEPS,
                       device=None):
    """Phase 32: ``serving.supervisor.start_serving_fleet(2, gen1)`` serves
    phase 31's export from two replica processes on the card.  Gates:
    both answer 8-row requests of raw census records bit-identically and
    within LOGIT_RTOL/LOGIT_ATOL of ``eval_step``; 8 closed-loop clients
    see every request answered while one replica reloads gen2 (phase
    31's state after ``gen2_steps`` more steps), which it then serves,
    the other gen1; after ``kill_worker(rid, 9)`` the supervisor starts a
    replica with a fresh id that serves gen1, the survivor answering
    throughout; 2 K2 a dispatch in each replica; the journal's fleet
    events."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
    from elasticdl_tpu_torch.data.synthetic import synthetic_census_records
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.frontend import PredictClient, encode_features
    from elasticdl_tpu_torch.serving.supervisor import start_serving_fleet, wait_for_replicas
    from elasticdl_tpu_torch.zoo import build_model, resolve

    gen1 = job["export"]
    gen2 = os.path.join(workdir, "census", "gen2")
    zoo = resolve(CENSUS_DEF)
    saver = ShardedCheckpointSaver(job["checkpoint"])
    trainer = ShardedEmbeddingTrainer(build_model(CENSUS_DEF, "", device), zoo.loss,
                                      zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer(),
                                      device=device)
    trainer.set_sharded_restore(saver, saver.latest_step())
    trainer.ensure_initialized()
    requests = census_requests(seed + 32, 64)
    want1 = [trainer.eval_step(r) for r in requests]
    batch = job["batch"]
    train = census_eval_batches(synthetic_census_records(batch * gen2_steps, seed + 33), batch)
    for features, labels in train:
        trainer.train_step(features, labels)
    export_model(trainer, gen2, model_zoo="model_zoo", model_def=CENSUS_DEF, model_params="")
    want2 = [trainer.eval_step(r) for r in requests]
    del trainer
    torch.cuda.empty_cache()
    if all(np.allclose(a, b, rtol=LOGIT_RTOL, atol=LOGIT_ATOL) for a, b in zip(want1, want2)):
        fail("gen2 serves the same logits as gen1")

    def close(got, want, what):
        np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL, err_msg=what)

    serve = os.path.join(workdir, "serve_fleet")
    warm = os.path.join(workdir, "fleet_warmup.npz")
    with open(warm, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in requests[0].items()}))
    t_launch = time.perf_counter()
    manager = start_serving_fleet(2, gen1, serve, max_batch_size=64, max_wait_us=2000,
                                  telemetry_interval_s=0.5, warmup_features=warm,
                                  **({"device": device} if device else {}))
    probes, stats = {}, {}
    try:
        live = wait_for_replicas(serve, 2, timeout_s=300)
        addr = {r["replica_id"]: f"127.0.0.1:{r['port']}" for r in live}
        probes = {rid: PredictClient(a, deadline_s=60.0) for rid, a in addr.items()}
        rid_swap, rid_kill = sorted(probes)
        for r, want in zip(requests, want1):
            a, b = probes[rid_swap].predict(r), probes[rid_kill].predict(r)
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                fail(f"the replicas answer one request differently: {a} vs {b}")
            close(a, want, "gen1 against eval_step")
        first_answers_s = time.perf_counter() - t_launch
        windows = {}
        # (a) both replicas, before the swap
        stop = threading.Event()
        t0 = time.time()
        threads, records, errors = start_clients(list(addr.values()), requests, clients, stop)
        time.sleep(window_s)
        windows["before_swap"] = stop_clients("before the swap", threads, stop, records,
                                              errors, t0)
        # (b) a live reload of one replica under load: every request answered
        stop = threading.Event()
        t0 = time.time()
        threads, records, errors = start_clients(list(addr.values()), requests, clients, stop)
        time.sleep(0.5)
        t_swap = time.time()
        swapped = probes[rid_swap].reload(gen2)
        swap_s = time.time() - t_swap
        time.sleep(0.5)
        windows["across_swap"] = stop_clients("across the swap", threads, stop, records,
                                              errors, t0)
        if swapped["generation"] != 2:
            fail(f"the reload answered {swapped}")
        for r, w1, w2 in zip(requests, want1, want2):
            close(probes[rid_swap].predict(r), w2, "the swapped replica against gen2")
            close(probes[rid_kill].predict(r), w1, "the other replica against gen1")
        stats[rid_kill] = probes[rid_kill].stats()
        # (c) SIGKILL one replica: the survivor answers throughout, the
        # supervisor starts a replica with a fresh id
        stop = threading.Event()
        t0 = time.time()
        threads, records, errors = start_clients([addr[rid_swap]], requests, clients, stop)
        time.sleep(0.2)
        t_kill = time.perf_counter()
        manager.kill_worker(rid_kill, signal.SIGKILL)
        deadline = time.perf_counter() + 300
        fresh = []
        while not fresh:
            if time.perf_counter() > deadline:
                fail(f"no fresh replica 300 s after the kill: {manager.current_worker_ids()}")
            fresh = [r for r in wait_for_replicas(serve, 2, timeout_s=300)
                     if r["replica_id"] not in (rid_swap, rid_kill)]
            time.sleep(0.05)
        rid_fresh = fresh[0]["replica_id"]
        addr[rid_fresh] = f"127.0.0.1:{fresh[0]['port']}"
        probes[rid_fresh] = PredictClient(addr[rid_fresh], deadline_s=60.0)
        probes[rid_fresh].predict(requests[0])
        kill_to_answer_s = time.perf_counter() - t_kill
        windows["survivor_across_kill"] = stop_clients("the survivor across the kill", threads,
                                                       stop, records, errors, t0)
        if manager.current_worker_ids() != [rid_swap, rid_fresh] or rid_fresh <= rid_kill:
            fail(f"replicas {manager.current_worker_ids()} after the kill of {rid_kill}")
        for r, want in zip(requests, want1):
            close(probes[rid_fresh].predict(r), want, "the fresh replica against gen1")
        # (d) the repaired fleet
        live_addrs = [addr[rid_swap], addr[rid_fresh]]
        stop = threading.Event()
        t0 = time.time()
        threads, records, errors = start_clients(live_addrs, requests, clients, stop)
        time.sleep(window_s)
        windows["after_kill"] = stop_clients("after the kill", threads, stop, records, errors,
                                             t0)
        for rid in (rid_swap, rid_fresh):
            stats[rid] = probes[rid].stats()
    finally:
        for probe in probes.values():
            probe.close()
        manager.stop()
        obs.journal().configure(None)
    per_replica = {}
    for rid, st in stats.items():
        launches, dispatches = st["kernel_launches"], st["executes"]
        if launches.get("fused_lookup") != 2 * dispatches or launches.get(
                "fused_lookup_fm") or launches.get("fused_dedup_apply"):
            fail(f"replica {rid} launched {launches} in {dispatches} dispatches")
        per_replica[rid] = {"dispatches": dispatches, "launches": launches,
                            "generation": st["generation"]}
    if (per_replica[rid_swap]["generation"], per_replica[rid_fresh]["generation"]) != (2, 1):
        fail(f"generations after the kill: {per_replica}")
    journal = os.path.join(serve, "events.jsonl")
    starts = journal_events(journal, "serving_replica_start")
    churn = journal_events(journal, "worker_churn")
    swaps = journal_events(journal, "model_swap")
    if (not journal_events(journal, "serving_fleet_start")
            or sorted(e["replica_id"] for e in starts) != [rid_swap, rid_kill, rid_fresh]
            or any(e["forbidden_modules"] or not e["device"].startswith(
                "cpu" if device == "cpu" else "cuda") for e in starts)
            or [(e["workers"], e["exit_codes"]) for e in churn] != [([rid_kill], [-9])]
            or not any(e.get("outcome") == "applied" for e in swaps)):
        fail(f"the fleet's journal: starts {starts}, churn {churn}, swaps {swaps}")
    result = {"replicas": sorted(per_replica), "windows": windows, "swap_s": swap_s,
              "first_answers_s": first_answers_s, "kill_to_fresh_answer_s": kill_to_answer_s,
              "killed": rid_kill, "fresh": rid_fresh, "per_replica": per_replica,
              "startup_s": {e["replica_id"]: e["startup_s"] for e in starts}, "card": card}
    log(f"census fleet: 2 replica processes up and answering {first_answers_s!r} s after the "
        f"launch (replica start {result['startup_s']} s); 8-row requests from {clients} "
        f"clients: {windows}; reload to gen2 {swap_s!r} s under load, 0 dropped; SIGKILL of "
        f"replica {rid_kill} -> fresh replica {rid_fresh} answering {kill_to_answer_s!r} s "
        f"later, the survivor answering throughout; per replica {per_replica} [{card}]")
    return result


# ----------------------------------------------------------------------
# the elastic control plane: the goodput ledger in every job; phases
# 33-34, the AllReduce jobs on ResNet-20 and ResNet-50
# ----------------------------------------------------------------------


def ledger_summary(events: str, what: str, causes=()) -> dict:
    """The master's goodput ledger of a finished job: its
    ``goodput_summary`` (ratio, wall, phases) and ``rescale_cost``
    records.  Fails unless the phases sum to the wall within LEDGER_RTOL,
    the rescales' causes are ``causes`` and each rescale's detection,
    rendezvous and redo sum to its total (journal rounding: 1e-6 s each)."""
    summaries = journal_events(events, "goodput_summary")
    if len(summaries) != 1:
        fail(f"{what}: goodput_summary records {summaries}")
    summary = summaries[0]
    phases_s = sum(summary["phases"].values())
    if abs(phases_s - summary["wall_s"]) > LEDGER_RTOL * summary["wall_s"]:
        fail(f"{what}: the ledger's phases sum to {phases_s!r} s, its wall is "
             f"{summary['wall_s']!r} s")
    costs = journal_events(events, "rescale_cost")
    if [c["cause"] for c in costs] != list(causes):
        fail(f"{what}: rescale_cost causes {[c['cause'] for c in costs]}, want {list(causes)}")
    for c in costs:
        parts = c["detection_s"] + c["rendezvous_s"] + c["redo_s"]
        if abs(parts - c["total_s"]) > 3e-6:
            fail(f"{what}: rescale {c} parts sum to {parts!r}")
    return {"goodput_ratio": summary["goodput_ratio"], "wall_s": summary["wall_s"],
            "phases_s": summary["phases"], "records_done": summary["records_done"],
            "records_redone": summary["records_redone"],
            "rescale_cost": [{k: c[k] for k in ("cause", "old_size", "new_size", "total_s",
                                                "detection_s", "rendezvous_s", "redo_s",
                                                "redo_records")} for c in costs]}


def journals_schema(directory: str, what: str) -> int:
    """Every record of every journal in ``directory`` carries the fields
    the port's schema (``obs.REQUIRED_FIELDS``) requires; the count."""
    from elasticdl_tpu_torch import obs

    checked = 0
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("events") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(directory, name)) as f:
            for record in map(json.loads, filter(str.strip, f)):
                missing = obs.missing_fields(record)
                if missing:
                    fail(f"{what}: {name} record {record} lacks {missing}")
                checked += 1
    return checked


def allreduce_job_phase(card: str, seed: int, workdir: str, number: int, vision=None,
                        extra_flags=()):
    """Phases 33-34 (``ALLREDUCE_JOBS``): the AllReduce job as processes,
    a world of one on the card, the worker SIGKILLed after a save; see
    the module docstring."""
    import numpy as np

    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver, read_pickle
    from elasticdl_tpu_torch.serving import convert
    from elasticdl_tpu_torch.serving.export import read_variables
    from elasticdl_tpu_torch.worker.collective_worker import state_digest

    model_def, params, data, n, batch, per_task, ckpt_steps, flags = ALLREDUCE_JOBS[number]
    what = f"phase {number} ({model_def})"
    job = os.path.join(workdir, f"allreduce_{number}")
    ckpt, out = os.path.join(job, "ckpt"), os.path.join(job, "out")
    os.makedirs(job)
    master_log = os.path.join(job, "master.log")
    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
            "--distribution_strategy=AllreduceStrategy", "--num_workers=1",
            "--model_zoo=model_zoo", f"--model_def={model_def}",
            *([f"--model_params={params}"] if params else []),
            f"--training_data={data.format(n=n, seed=seed)}", f"--minibatch_size={batch}",
            f"--records_per_task={per_task}", f"--checkpoint_dir={ckpt}",
            f"--checkpoint_steps={ckpt_steps}", "--keep_checkpoint_max=10",
            f"--output={out}", *flags, *extra_flags]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    events = os.path.join(ckpt, "events.jsonl")
    committed = os.path.join(ckpt, f"step_{ckpt_steps:012d}", "state.pkl")
    t_start = time.time()
    with open(master_log, "wb") as log_file:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        wait_until(f"{what}: the step-{ckpt_steps} checkpoint",
                   lambda: os.path.exists(committed), proc, master_log, 600)
        t_commit = os.path.getmtime(committed)
        wait_until(f"{what}: a task in flight after the checkpoint",
                   lambda: in_flight(events, 0, t_commit), proc, master_log, 600)
        launch = journal_events(events, "worker_launch")[0]
        victim = launch["pid"]
        if launch["worker_id"] != 0 or parent_pid(victim) != proc.pid:
            fail(f"{what}: worker {launch} is not the master's ({proc.pid}) child")
        os.kill(victim, signal.SIGKILL)
        t_kill = time.time()
        # The saved state's digest, read while the file is certainly there.
        saved_digest = state_digest(read_pickle(committed))
        log(f"{what}: SIGKILLed worker 0 (pid {victim}) {t_kill - t_start!r} s after the "
            f"master started, once step {ckpt_steps} was committed")
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"{what}: the job did not finish within 600 s of the kill:\n{tail(master_log)}")
        t_end = time.time()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    logs = os.path.join(ckpt, "elasticdl-job_worker_logs")
    if rc != 0:
        fail(f"{what}: the job exited {rc}:\n{tail(master_log)}\n--- worker 1\n"
             f"{tail(os.path.join(logs, 'worker_1.log'))}")

    def worker_events(wid, event):
        return journal_events(os.path.join(ckpt, f"events_worker_{wid}.jsonl"), event)

    master = {name: journal_events(events, name) for name in (
        "task_dispatch", "task_done", "task_requeue", "worker_launch", "worker_churn",
        "rendezvous", "master_exit", "policy_decision")}
    churn = master["worker_churn"]
    if len(churn) != 1 or churn[0]["workers"] != [0] or churn[0]["exit_codes"] != [-9]:
        fail(f"{what}: worker_churn events {churn}")
    if [e["workers"] for e in master["rendezvous"]] != [[0], [1]]:
        fail(f"{what}: rendezvous events {master['rendezvous']}")
    requeued = [t for e in master["task_requeue"] if e["reason"] == "worker_churn"
                for t in e["task_ids"]]
    ranges = {e["task_id"]: (e["start"], e["end"]) for e in master["task_dispatch"]}
    done = [ranges[e["task_id"]] for e in master["task_done"]]
    if not requeued or any(ranges[t] not in done for t in requeued):
        fail(f"{what}: the in-flight task {requeued} was not requeued and done")
    expected = [(lo, min(lo + per_task, n)) for lo in range(0, n, per_task)]
    if sorted(set(done)) != expected:
        fail(f"{what}: record ranges done {sorted(set(done))}, want {expected}")
    # The restore, bit for bit: the new worker's digest of what landed in
    # its trainer, the dead worker's at the save, the file's.
    restores = worker_events(1, "checkpoint_restore")
    saves0 = {e["step"]: e for e in worker_events(0, "checkpoint_saved")}
    if [e["step"] for e in restores] != [ckpt_steps] or max(saves0) != ckpt_steps:
        fail(f"{what}: worker 1 restored {restores}; worker 0 saved {sorted(saves0)}")
    digests = {"restored": {k: restores[0].get(k) for k in saved_digest},
               "saved": {k: saves0[ckpt_steps].get(k) for k in saved_digest},
               "file": saved_digest}
    if not digests["restored"] == digests["saved"] == digests["file"] or \
            "model_state_crc32" not in saved_digest:
        fail(f"{what}: state digests differ (params, SGD trace, batch_stats): {digests}")
    # The export against the final checkpoint, bit for bit.
    saver = CheckpointSaver(ckpt)
    final_state, last_step = saver.load_latest()
    exported_at = [e["step"] for e in worker_events(1, "model_exported")]
    if exported_at != [last_step]:
        fail(f"{what}: exported at {exported_at}, last checkpoint {last_step}")
    variables = read_variables(os.path.join(out, "variables.pkl"))
    compared = 0
    for group, stored in (("params", final_state.params),
                          ("batch_stats", final_state.model_state["batch_stats"])):
        got = convert.flatten_variables(variables[group])
        want = convert.flatten_variables(stored)
        if sorted(got) != sorted(want):
            fail(f"{what}: the export's {group} names differ from the checkpoint's")
        for key, leaf in want.items():
            a, b = np.asarray(got[key]), np.asarray(leaf)
            if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(
                    a.view(np.uint8), b.view(np.uint8)):
                fail(f"{what}: the export's {group}/{key} differs from step {last_step}")
            compared += a.size
    ledger = ledger_summary(events, what, causes=["worker_churn"])
    holds = [d for d in master["policy_decision"] if d["action"] == "hold"]
    if not holds or any(d["action"] != "hold" for d in master["policy_decision"]):
        fail(f"{what}: policy decisions {master['policy_decision']}")
    records = journals_schema(ckpt, what)
    exits = {wid: worker_events(wid, "worker_exit") for wid in (0, 1)}
    if not exits[1] or exits[1][0]["forbidden_modules"] or exits[1][0]["kernel_launches"]:
        fail(f"{what}: worker 1 exit {exits[1]}")
    if master["master_exit"][-1]["forbidden_modules"] or not master["master_exit"][-1][
            "succeeded"]:
        fail(f"{what}: master exit {master['master_exit'][-1]}")
    if worker_events(0, "worker_task_done")[-1]["kernel_launches"]:
        fail(f"{what}: worker 0 launched {worker_events(0, 'worker_task_done')[-1]}")
    anatomy = {wid: (worker_events(wid, "step_anatomy") or [None])[-1] for wid in (0, 1)}
    if anatomy[1] is None or not anatomy[1].get("fractions"):
        fail(f"{what}: no step anatomy in worker 1's journal")
    # Steady tasks: not a worker's first, holding no save.
    steady = []
    for wid in (0, 1):
        tasks = worker_events(wid, "worker_task_done")
        saved_at = [e["ts"] for e in worker_events(wid, "checkpoint_saved")]
        steady += [e for e in tasks[1:]
                   if not any(e["ts"] - e["seconds"] <= ts <= e["ts"] for ts in saved_at)]
    steady_s = sum(e["seconds"] for e in steady)
    first1 = worker_events(1, "first_step")[0]["ts"]
    result = {
        "model_def": model_def, "records": n, "batch": batch, "records_per_task": per_task,
        "steps": last_step, "killed_after_step": ckpt_steps,
        "goodput": ledger,
        "rescale_host_s": {"detected": churn[0]["ts"] - t_kill,
                           "relaunched": master["worker_launch"][1]["ts"] - t_kill,
                           "restored": restores[0]["ts"] - t_kill,
                           "restore_itself": restores[0]["seconds"],
                           "first_step_after": first1 - t_kill},
        "anatomy": {wid: None if a is None else {k: a.get(k) for k in (
            "fractions", "dominant_phase", "bound", "mfu", "totals", "steps", "examples",
            "overlap_s", "mem_hwm_mb", "compiles")} for wid, a in anatomy.items()},
        "steady_tasks": len(steady),
        "steady_images_per_s": sum(e["records"] for e in steady) / steady_s if steady else None,
        "steady_data_wait_share": (sum(e["data_wait_s"] for e in steady) / steady_s
                                   if steady else None),
        "phase28_step_ms": None if vision is None else vision.get("step_ms_median"),
        "digests": digests["file"], "export_elements_bit_exact": compared,
        "policy_holds": len(holds), "journal_records_checked": records,
        "wall_s": t_end - t_start, "card": card,
    }
    cost = ledger["rescale_cost"][0]
    a1 = result["anatomy"][1]
    log(f"{what}: goodput_ratio {ledger['goodput_ratio']!r} over {ledger['wall_s']!r} s "
        f"(phases {ledger['phases_s']}); rescale (ledger) detection {cost['detection_s']!r} s, "
        f"rendezvous {cost['rendezvous_s']!r} s, redo {cost['redo_s']!r} s of "
        f"{cost['redo_records']} records, total {cost['total_s']!r} s; host clock "
        f"{result['rescale_host_s']} s; step anatomy (worker 1) {a1['fractions']}, bound "
        f"{a1['bound']!r}, mfu {a1['mfu']!r}, overlap {a1['overlap_s']!r} s; steady "
        f"{result['steady_images_per_s']!r} images/s over {len(steady)} tasks (data-wait share "
        f"{result['steady_data_wait_share']!r}; phase 28's step {result['phase28_step_ms']!r} "
        f"ms); restore bit-exact {digests['file']}; export bit-exact with step {last_step} "
        f"({compared} elements); {len(holds)} policy holds; wall {result['wall_s']!r} s [{card}]")
    shutil.rmtree(job, ignore_errors=True)
    return result


# ----------------------------------------------------------------------
# phase 35: the LM with the bf16 head
# ----------------------------------------------------------------------


#: bf16 rounds a value to 8 significant bits: a relative error of at
#: most 2**-8 for each operand it rounds (round to nearest even).
BF16_UNIT = 2.0 ** -8


def head_bound(x, weight):
    """The bf16 head's largest allowed distance from the f32 head on the
    head's input ``x`` [n, d] and ``weight`` [V, d], elementwise: each
    product ``x_i w_i`` moves by at most ``(2 * 2**-8 + 2**-16) |x_i w_i|``
    when both operands round to bf16, and each f32 sum of d terms by at
    most ``d * 2**-24`` of the sum of magnitudes; so ``|bf16 - f32| <=
    (2**-7 + 2**-16 + 2 d 2**-24) * (|x| @ |w|.T)``."""
    import torch

    d = x.shape[-1]
    scale = 2 * BF16_UNIT + BF16_UNIT ** 2 + 2 * d * 2.0 ** -24
    return scale * torch.mm(x.float().abs(), weight.float().abs().t())


def head_times(head, x, grad, flush):
    """The head alone on its step's input: forward and backward medians
    (CUDA events, L2 flushed before each), ms."""
    import torch

    x = x.detach().requires_grad_()

    def forward():
        return head(x)

    out = forward()

    def backward():
        head.weight.grad = head.bias.grad = x.grad = None
        torch.autograd.backward(out, grad, retain_graph=True)

    return median_ms(forward, flush), median_ms(backward, flush)


def lm_bf16_head_phase(card: str, seed: int, warmup: int = 2, steps: int = HEAD_STEPS,
                       n_batches: int = 4):
    """Phase 35: the LM at phase 11's width with ``logits_compute="bf16"``
    against the f32 head, each trained ``steps`` steps from one seed."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    cfg, batch = LM_BENCH, LM_BATCH
    zoo = resolve(LM_DEF)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the f32 head and the bf16 head's backward would time TF32")
    tokens, nxt = synthetic_lm_arrays(batch * n_batches, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    batches = [(tokens[i * batch:(i + 1) * batch], nxt[i * batch:(i + 1) * batch], ones)
               for i in range(n_batches)]
    params = dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                  num_layers=cfg["num_layers"], max_len=cfg["seq_len"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=card_device())
    result = {}
    for head in ("f32", "bf16"):
        model = build_model(LM_DEF, dict(params, logits_compute=head))
        trainer = DataParallelTrainer(model, zoo.loss, zoo.optimizer(LM_LR), seed=seed)
        trainer.ensure_initialized()
        staged = [trainer.stage_batch(*b) for b in batches]
        losses = [trainer.train_step_staged(staged[i % n_batches]) for i in range(warmup)]
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        events = []
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(trainer.train_step_staged(staged[i % n_batches]))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        for name in fa.KERNELS:
            if counts[name] != cfg["num_layers"] * steps:
                fail(f"{head} head: {name} launched {counts[name]} times in {steps} steps")
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)) or not losses[-3:].mean() < losses[:3].mean():
            fail(f"{head} head: the loss did not fall: {losses}")
        step_ms = sorted(s.elapsed_time(e) for s, e in events)
        # The head alone on the step's real input (the final LayerNorm's
        # output), with an f32 cotangent of the logits' shape.
        captured = []
        hook = model.LayerNorm_0.register_forward_hook(lambda m, i, o: captured.append(o))
        with torch.no_grad():
            model(staged[0][0])
        hook.remove()
        x = captured[0].detach()
        grad = torch.randn(x.shape[:-1] + (cfg["vocab"],), device=x.device) * 1e-4
        fwd_ms, bwd_ms = head_times(model.lm_head, x, grad, flush)
        result[head] = {
            "tokens_per_s": steps * batch * cfg["seq_len"] / wall,
            "step_ms_median": step_ms[len(step_ms) // 2],
            "head_forward_ms": fwd_ms, "head_backward_ms": bwd_ms,
            "loss_first3": float(losses[:3].mean()), "loss_last3": float(losses[-3:].mean()),
            "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
        }
        if head == "f32":
            f32_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            # Gates on one state: the f32 trainer's parameters in both heads.
            model.load_state_dict(f32_state)
            with torch.no_grad():
                hook = model.LayerNorm_0.register_forward_hook(lambda m, i, o: captured.append(o))
                got = model(staged[0][0][:1])
                hook.remove()
                rows = captured[-1].reshape(-1, cfg["d_model"])
                weight, bias = model.lm_head.weight, model.lm_head.bias
                want = torch.nn.functional.linear(rows.float(), weight, bias)
                got = got.reshape(-1, cfg["vocab"])
                if got.dtype != torch.float32:
                    fail(f"the bf16 head returned {got.dtype} logits, not float32")
                bound = head_bound(rows, weight)
                excess = (got - want).abs() - bound
                worst = float(((got - want).abs() / bound.clamp_min(1e-30)).max())
                if float(excess.max()) > 0:
                    fail(f"bf16 head logits exceed the rounding bound: {worst!r} of it")
                # The cuBLAS bf16 product's f32 output is not rounded to
                # bf16: it differs from its own bf16 rounding.
                direct = torch.mm(rows.to(torch.bfloat16), weight.to(torch.bfloat16).t(),
                                  out_dtype=torch.float32)
                if torch.equal(direct, direct.to(torch.bfloat16).float()):
                    fail("the bf16 product's f32 output holds only bf16 values")
                plain = torch.mm(rows.to(torch.bfloat16).float(),
                                 weight.to(torch.bfloat16).float().t())
                plain_err = float((direct - plain).abs().max())
            result["gate"] = {"max_share_of_bound": worst, "logits_dtype": str(got.dtype),
                              "bf16_mm_vs_upcast_max_abs": plain_err,
                              "max_abs_vs_f32_head": float((got - want).abs().max())}
            del got, want, bound, excess, direct, plain
            result["path"] = lm_compare((trainer, contextlib.nullcontext),
                                        (trainer, plain_attention), staged, card,
                                        "bf16-head LM kernel path vs plain path")
        del trainer, model, staged, x, grad, captured
        torch.cuda.empty_cache()
    del f32_state
    log(f"LM bf16 head gates: {result['gate']} [{card}]")
    for head in ("f32", "bf16"):
        r = result[head]
        log(f"LM {head} head: {r['tokens_per_s']!r} tokens/s, step median "
            f"{r['step_ms_median']!r} ms, head forward {r['head_forward_ms']!r} ms, backward "
            f"{r['head_backward_ms']!r} ms (CUDA events), loss {r['loss_first3']!r} -> "
            f"{r['loss_last3']!r}; launches per step {r['launches_per_step']} [{card}]")
    result["card"] = card
    return result


# ----------------------------------------------------------------------
# phase 36: the continuous loop from an unbounded stream
# ----------------------------------------------------------------------


#: JAX's chaos scenario (``tests/test_stream_e2e.py``: 400/1600 records/s,
#: tasks of 64) scaled by 8192/64 to tasks of one training batch.
STREAM_LOOP = dict(schedule=((4.0, 51200.0), (2.0, 204800.0)), records_per_task=8192,
                   lookahead=8, ticks=24, dt=0.25, slo_s=1.5, workers=3,
                   faults=("stream.source:latency=1.0@t2.0, ckpt.delta:truncate@2, "
                           "serving.delta_apply:error=injected@3"),
                   kill_tick=17, churn_tick=5, full_tick=3, delta_ticks=(7, 13, 18, 20),
                   compact_tick=15, query_rows=64)
STREAM_FIELDS = tuple(f"cat{i}" for i in range(26))


def stream_batch(lo: int, hi: int, vocab: int):
    """DeepFM's features and labels of stream offsets [lo, hi): the 26
    categorical ids from ``synthetic_click_batch`` (one field a column,
    the table's vocab), 13 dense values and the label from
    ``click_label_rule``, each a pure function of the offset."""
    import numpy as np

    from elasticdl_tpu_torch.data.stream import click_label_rule, synthetic_click_batch

    click = synthetic_click_batch(lo, hi, vocab, STREAM_FIELDS)
    offsets = np.arange(lo, hi, dtype=np.int64)[:, None]
    dense = ((offsets * (3 + 2 * np.arange(13)) + 5) % 97).astype(np.float32) / 48.5 - 1.0
    cat = np.stack([click[f] for f in STREAM_FIELDS], axis=1).astype(np.int32)
    return {"dense": dense, "cat": cat}, click_label_rule(click).astype(np.int32)


def stream_trainer(seed: int, params: str, device=None):
    """Phase 20's trainer (the split layout, global-bias sparse Adam)."""
    from elasticdl_tpu_torch.parallel import sparse_optim
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    trainer = ShardedEmbeddingTrainer(
        build_model(MODEL_DEF, params, device=device), zoo.loss, zoo.optimizer(),
        embedding_optimizer=sparse_optim.adam(LR, bias_correction="global"), seed=seed,
        device=device)
    trainer.ensure_initialized()
    return trainer


def journal_all(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def merged_cover(ranges):
    merged = []
    for lo, hi in sorted(ranges):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(r) for r in merged]


def stream_loop_phase(card: str, seed: int, workdir: str, trainer=None, cfg=STREAM_LOOP,
                      params: str = SPLIT_TRAIN_PARAMS, device=None):
    """Phase 36: the continuous train -> serve loop fed by an unbounded
    click stream, on a virtual timeline the driver owns (``cfg``): the
    streaming master cuts tasks of one batch, three workers drain them
    into ``trainer`` each tick (K2 and K3 twice a step), deltas go out
    with the watermark's event time, a DeltaWatcher moves an in-process
    ServingReplica while a load generator queries it, and the faults of
    ``cfg`` plus a worker's churn and the master's SIGKILL (rebuilt from
    the journal) hit the loop.  ``device``: None for the card, "cpu" for
    the CPU test."""
    import threading

    import numpy as np
    import torch

    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.checkpoint import delta as deltas
    from elasticdl_tpu_torch.common import faults
    from elasticdl_tpu_torch.common import messages as msg
    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.stream import SyntheticClickStream, iter_stream_batches
    from elasticdl_tpu_torch.master.stream import StreamingTaskManager
    from elasticdl_tpu_torch.obs.freshness import FreshnessTracker
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.serving.continuous import DeltaWatcher
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    on_card = device is None
    vocab = parse_dict_params(params)["vocab_size"]
    per_task = cfg["records_per_task"]
    built = trainer is None
    t_setup = time.perf_counter()
    if built:
        trainer = stream_trainer(seed, params, device)
    setup_s = time.perf_counter() - t_setup
    journal = obs.init_journal(os.path.join(workdir, "journal_stream"))
    pub = os.path.join(workdir, "pub_stream")
    exporter = deltas.DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                    model_params=params)
    stream = SyntheticClickStream(cfg["schedule"], name="clicks")
    manager = StreamingTaskManager(stream, records_per_task=per_task,
                                   lookahead_tasks=cfg["lookahead"])
    tracker = FreshnessTracker(slo_s=cfg["slo_s"])
    faults.install(cfg["faults"])
    query, _ = stream_batch(10 ** 9, 10 ** 9 + cfg["query_rows"], vocab)
    train_counts, steps = {}, [0]

    def train(task):
        for feats, labels in iter_stream_batches(
                lambda lo, hi: stream_batch(lo, hi, vocab), task.start, task.end, per_task):
            trainer.train_step_staged(trainer.stage_batch(
                feats, labels, np.ones((len(labels),), np.float32)))
            steps[0] += 1
        key = (task.start, task.end)
        train_counts[key] = train_counts.get(key, 0) + 1

    def drain(worker_id, budget=64):
        for _ in range(budget):
            task = manager.get(worker_id)
            if task.task_id < 0:
                return
            train(task)
            manager.report(task.task_id, True, worker_id=worker_id)

    replica = watcher = None
    latencies, errors, executes = [], [], [0]
    stop = threading.Event()

    def loadgen():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                out = replica.execute(query, cfg["query_rows"])
            except Exception as exc:  # a dropped request fails the phase
                errors.append(repr(exc))
                return
            latencies.append(time.perf_counter() - t0)
            executes[0] += 1
            if not np.all(np.isfinite(out)):
                errors.append("non-finite logits")
                return

    thread = threading.Thread(target=loadgen, daemon=True)
    publish_s, links = [], []

    def publish_delta():
        t0 = time.perf_counter()
        link = exporter.publish_delta(trainer, event_time=manager.watermark_event_time())
        publish_s.append(time.perf_counter() - t0)
        if link is not None:
            tracker.note_published(exporter.head_step, manager.watermark_event_time())
            links.append((exporter.head_step, time.perf_counter()))
        return link

    served_at, churned, killed, rolled_back = {}, [], [], False
    redo_cut, watermark_kept = None, None
    ske.reset_launch_counts()
    t_loop = time.perf_counter()
    try:
        for i in range(cfg["ticks"]):
            stream.advance(cfg["dt"])
            now = stream.elapsed_s
            for spec in faults.due("stream.source", now):
                if spec.kind == "latency":
                    stream.stall(float(spec.arg or 1.0))
            if i == cfg["kill_tick"]:
                # The master dies with tasks in flight; its journal survives.
                for w in (0, 1):
                    task = manager.get(w)
                    if task.task_id >= 0:
                        killed.append((task.start, task.end))
                if not killed:
                    fail("the master's kill tick dispatched nothing")
                before = manager.watermark
                del manager
                manager = StreamingTaskManager.resume_from_journal(
                    journal_all(journal), stream, records_per_task=per_task,
                    lookahead_tasks=cfg["lookahead"])
                watermark_kept = (before, manager.watermark)
                if manager.watermark != before:
                    fail(f"the rebuilt master's watermark {manager.watermark} is not {before}")
                cut = []
                while True:  # what the rebuilt master re-cuts below its old frontier
                    task = manager.get(0)
                    if task.task_id < 0 or task.start >= max(hi for _, hi in killed):
                        if task.task_id >= 0:
                            train(task)
                            manager.report(task.task_id, True, worker_id=0)
                        break
                    cut.append((task.start, task.end))
                    train(task)
                    manager.report(task.task_id, True, worker_id=0)
                redo_cut = cut
            if i == cfg["full_tick"]:
                t0 = time.perf_counter()
                full = exporter.publish_full(trainer, event_time=manager.watermark_event_time())
                publish_s.append(time.perf_counter() - t0)
                tracker.note_published(exporter.head_step, manager.watermark_event_time())
                replica = ServingReplica(full, device=device)
                watcher = DeltaWatcher(replica, pub, freshness=tracker)
                gen = replica.generation
                tracker.note_served(gen.gen_id, gen.step, gen.event_time)
                thread.start()
            elif i in cfg["delta_ticks"]:
                if publish_delta() is None:
                    fail(f"tick {i}: the delta published nothing")
            elif i == cfg["compact_tick"]:
                if exporter.compact() is None:
                    fail("compaction wrote no full")
                tracker.note_published(exporter.head_step, manager.watermark_event_time())
            if i == cfg["churn_tick"]:
                # Worker 2 trains two tasks and dies before reporting them.
                for _ in range(2):
                    task = manager.get(2)
                    if task.task_id < 0:
                        break
                    train(task)
                    churned.append((task.start, task.end))
                if not churned or manager.recover_tasks(2) != len(churned):
                    fail(f"the churn tick requeued {churned}")
            for w in range(cfg["workers"]):
                drain(w)
            if watcher is not None:
                summary = watcher.poll_once()
                if summary["failed"] is not None:
                    rolled_back = True
                served_at.setdefault(replica.generation.step, time.perf_counter())
            tracker.note_watermark(manager.watermark_event_time())
            tracker.evaluate(now)
        stream.close()
        for _ in range(100):
            if manager.finished():
                break
            for w in range(cfg["workers"]):
                drain(w)
        if not manager.finished():
            fail(f"the closed stream did not drain: {manager.stream_counts()}")
        publish_delta()
        for _ in range(4):
            if replica.generation.step == exporter.head_step:
                break
            watcher.poll_once()
            served_at.setdefault(replica.generation.step, time.perf_counter())
        tracker.note_watermark(manager.watermark_event_time())
        tracker.evaluate(stream.elapsed_s)
    finally:
        stop.set()
        if thread.is_alive():
            thread.join(timeout=60)
        faults.clear()
    loop_s = time.perf_counter() - t_loop
    counts = ske.launch_counts()
    total = stream.available()
    stream_counts = manager.stream_counts()
    if stream_counts["watermark"] != total or stream_counts["pending_ranges"]:
        fail(f"the watermark did not reach the stream's end {total}: {stream_counts}")
    if merged_cover(train_counts) != [(0, total)]:
        fail(f"the trained ranges do not cover [0, {total}): {merged_cover(train_counts)}")
    duplicates = {r: c for r, c in train_counts.items() if c > 1}
    if duplicates != {r: 2 for r in churned}:
        fail(f"redo debt {duplicates} is not the churned in-flight ranges {churned}")
    if any(train_counts[r] != 1 for r in killed) or sorted(redo_cut or []) != sorted(killed):
        fail(f"the master's in-flight ranges {killed} were redone as {redo_cut}")
    if errors or not latencies:
        fail(f"the load generator dropped requests: {errors[:3]} ({len(latencies)} answered)")
    if not rolled_back:
        fail("the serving.delta_apply fault never rolled back")
    if replica.generation.step != exporter.head_step:
        fail(f"serving stopped at step {replica.generation.step}, the chain at "
             f"{exporter.head_step}")
    served = replica.execute(query, cfg["query_rows"])
    reloaded_dir = exporter.compact()
    reloaded = ServingReplica(reloaded_dir, device=device)
    again = reloaded.execute(query, cfg["query_rows"])
    np.testing.assert_allclose(served, again, rtol=1e-5, atol=0)
    final_counts = ske.launch_counts()
    if tracker.breached or tracker.lag_s(stream.elapsed_s) > tracker.slo_s:
        fail(f"freshness did not recover: lag {tracker.lag_s(stream.elapsed_s)}")
    obs.journal().configure(None)
    slo = journal_events(journal, "freshness_slo")
    if not slo or slo[0]["state"] != "breach" or slo[-1]["state"] != "clear":
        fail(f"freshness events {[e['state'] for e in slo]}: no breach then clear")
    swaps = [e["outcome"] for e in journal_events(journal, "model_swap")]
    quarantined = journal_events(journal, "checkpoint_quarantined")
    if "rolled_back" not in swaps or swaps[-1] != "applied" or not quarantined:
        fail(f"model_swap {swaps}, quarantines {quarantined}")
    marks = [e["offset"] for e in journal_events(journal, "stream_watermark")]
    if marks != sorted(marks) or marks[-1] != total:
        fail(f"stream_watermark offsets {marks[:5]}... end at {marks[-1:]}, not {total}")
    requeues = [e for e in journal_events(journal, "task_requeue")
                if e.get("reason") == "worker_churn"]
    if sum(len(e["task_ids"]) for e in requeues) != len(churned):
        fail(f"churn requeues journaled {requeues}")
    if on_card:
        want = {"fused_dedup_apply": 2 * steps[0],
                "fused_lookup": 2 * steps[0] + 2 * executes[0]}
        if (counts["fused_dedup_apply"] != want["fused_dedup_apply"]
                or counts["fused_lookup"] != want["fused_lookup"]
                or counts["fused_lookup_fm"]):
            fail(f"{steps[0]} steps and {executes[0]} dispatches launched {counts}, want {want}")
    lat_ms = sorted(x * 1e3 for x in latencies)
    link_s = {}
    for step, at in links:
        served_t = min((t for s, t in served_at.items() if s >= step), default=None)
        link_s[step] = None if served_t is None else served_t - at
    result = {
        "tasks_trained": sum(train_counts.values()), "steps": steps[0], "records": total,
        "watermark": stream_counts["watermark"],
        "watermark_event_time": manager.watermark_event_time(),
        "event_time_lag_s": stream.elapsed_s - manager.watermark_event_time(),
        "steps_per_s_host": steps[0] / loop_s, "loop_s": loop_s, "setup_s": setup_s,
        "publish_s": publish_s, "publish_to_served_s": link_s,
        "requests": len(latencies), "requests_per_s": len(latencies) / loop_s,
        "p50_ms": lat_ms[len(lat_ms) // 2], "p99_ms": percentile_ms(latencies, 99),
        "churned": churned, "master_in_flight": killed, "redo_after_rebuild": redo_cut,
        "watermark_across_rebuild": watermark_kept, "swaps": swaps,
        "quarantined": len(quarantined), "freshness": [e["state"] for e in slo],
        "launches": counts, "launches_with_final_checks": final_counts,
        "journal": journal, "card": card,
    }
    log(f"stream loop: {result['tasks_trained']} tasks ({steps[0]} steps, {total} records) "
        f"trained in {loop_s!r} s of host time, {result['steps_per_s_host']!r} steps/s; "
        f"watermark {result['watermark']} at event time {result['watermark_event_time']!r} s, "
        f"lag {result['event_time_lag_s']!r} s on the virtual clock; publish -> served "
        f"{link_s} s; {result['requests']} requests, {result['requests_per_s']!r}/s, p50 "
        f"{result['p50_ms']!r} ms, p99 {result['p99_ms']!r} ms under the loop; churn redo "
        f"{churned}, the rebuilt master re-cut {redo_cut} (in flight {killed}), watermark "
        f"{watermark_kept}; swaps {swaps}; freshness {result['freshness']}; launches {counts} "
        f"[{card}]")
    del replica, reloaded, watcher
    if built:
        del trainer
    if on_card:
        torch.cuda.empty_cache()
    return result


# ----------------------------------------------------------------------
# phase 37: the xla engines (stream, scatter) on the card
# ----------------------------------------------------------------------


#: Phase 37's optimizers: the four of the JAX package, K3_HYPER's numbers.
ENGINE_KINDS = ("sgd", "momentum", "adagrad", "adam")
ENGINE_TOL = dict(rtol=1e-6, atol=5e-7)        # K3 against the JAX scatter path
ENGINE_SGD_SCATTER_TOL = dict(rtol=1e-6, atol=1e-6)


def engine_optimizer(name: str, mode: str):
    from elasticdl_tpu_torch.parallel import sparse_optim

    kind, hyper = K3_HYPER[name]
    hyper = dict(hyper)
    if kind == "momentum":
        hyper["mu"] = hyper.pop("momentum")
    return sparse_optim.by_name(kind, mode=mode, **hyper)


def close_state(what, got_table, got_slots, want_table, want_slots, tol):
    """Max |got - want| over a table and its slots; fails past ``tol``."""
    worst = 0.0
    pairs = [("table", got_table, want_table)] + [
        (k, got_slots[k], want_slots[k]) for k in want_slots]
    for name, got, want in pairs:
        got, want = got.double(), want.double()
        excess = (got - want).abs() - (tol["atol"] + tol["rtol"] * want.abs())
        if float(excess.max()) > 0:
            i = int(excess.argmax())
            fail(f"{what}: {name} differs at {i}: {float(got.flatten()[i])!r} vs "
                 f"{float(want.flatten()[i])!r}")
        worst = max(worst, float((got - want).abs().max()))
    if worst != worst:
        fail(f"{what}: non-finite state")
    return worst


def engines_phase(card: str, seed: int, steps: int = 3, n_batches: int = 3):
    """Phase 37: for sgd, momentum, adagrad and adam, 3 DeepFM steps at
    phase 6's widths with ``sparse_kernel="xla"`` in stream and in scatter
    mode beside K3 (``sparse_kernel="fused"``), from one state: each
    engine replays K3's sparse inputs (the same ids and grads) from the
    same tables and slots, and must land within the K3-vs-JAX-scatter
    tolerances of K3; the stream engine's ``apply_acc`` must equal its
    ``apply``; each engine's trainer step is timed beside K3's."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.layers import embedding as emb
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel import packed as pk
    from elasticdl_tpu_torch.parallel import sparse_optim
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer, clone_state
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    vocab = int(dict(p.split("=") for p in TRAIN_PARAMS.split(","))["vocab_size"])
    feats, labels = synthetic_ctr_arrays(TRAIN_BATCH * n_batches, vocab_size=vocab, seed=seed)
    batches = [({k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k, v in feats.items()},
                labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                np.ones((TRAIN_BATCH,), np.float32)) for i in range(n_batches)]
    model = build_model(MODEL_DEF, TRAIN_PARAMS)
    layers = {n.replace(".", "/") + "/embedding": m for n, m in model.named_modules()
              if isinstance(m, emb.Embedding)}
    result = {}
    for name in ENGINE_KINDS:
        runs = {}
        start = None
        for engine in ("fused", "stream", "scatter"):
            opt = engine_optimizer(name, "auto" if engine == "fused" else engine)
            trainer = ShardedEmbeddingTrainer(
                model, zoo.loss, zoo.optimizer(), embedding_optimizer=opt, seed=seed,
                sparse_kernel="fused" if engine == "fused" else "xla")
            if start is None:
                trainer.ensure_initialized()
                start = clone_state(trainer.state)
            else:
                trainer.state = clone_state(start)
                trainer.ensure_initialized()
            staged = [trainer.stage_batch(*b) for b in batches]
            recorded = []
            apply = trainer.sparse_apply

            def record(sparse, apply=apply, recorded=recorded):
                recorded.append({k: (i.clone(), g.clone()) for k, (i, g) in sparse.items()})
                return apply(sparse)

            trainer.sparse_apply = record
            torch.cuda.synchronize()
            ske.reset_launch_counts()
            events = []
            for i in range(steps):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                trainer.train_step_staged(staged[i % n_batches])
                e.record()
                events.append((s, e))
            torch.cuda.synchronize()
            counts = ske.launch_counts()
            want_k3 = steps if engine == "fused" else 0
            if counts["fused_dedup_apply"] != want_k3:
                fail(f"{name} {engine}: K3 launched {counts['fused_dedup_apply']} times")
            runs[engine] = {"step_ms": [s.elapsed_time(e) for s, e in events],
                            "recorded": recorded, "launches": counts}
            del trainer, staged
        # The apply-level gate: each engine on K3's recorded inputs, from
        # the start state, one table at a time.
        diffs, acc_exact = {"stream": 0.0, "scatter": 0.0}, True
        tol = ENGINE_SGD_SCATTER_TOL if name == "sgd" else ENGINE_TOL
        with deterministic():
            for key in runs["fused"]["recorded"][0]:
                spec = layers[key].spec

                def replay(engine, key=key, spec=spec):
                    opt = engine_optimizer(name, engine)
                    table = start.tables[key].clone()
                    slots = {k: v.clone() for k, v in start.slots[key].items()}
                    for sparse in runs["fused"]["recorded"]:
                        opt.apply(spec, table, slots, *sparse[key])
                    return table, slots

                k3_table, k3_slots = replay("fused")
                for engine in ("stream", "scatter"):
                    got = replay(engine)
                    diffs[engine] = max(diffs[engine], close_state(
                        f"{name} {engine} vs K3 ({key})", *got, k3_table, k3_slots, tol))
                    del got
                del k3_table, k3_slots
                # apply_acc against apply (the stream engine), step 1's inputs.
                opt = engine_optimizer(name, "stream")
                ids, grads = runs["fused"]["recorded"][0][key]
                a_table, b_table = start.tables[key].clone(), start.tables[key].clone()
                a_slots = {k: v.clone() for k, v in start.slots[key].items()}
                b_slots = {k: v.clone() for k, v in start.slots[key].items()}
                opt.apply_acc(spec, a_table, a_slots,
                              pk.grad_accumulate(spec, a_table, ids, grads))
                opt.apply(spec, b_table, b_slots, ids, grads)
                if name == "sgd":  # apply adds once per occurrence, apply_acc once per row
                    close_state("sgd apply_acc vs apply", a_table, {}, b_table, {},
                                ENGINE_SGD_SCATTER_TOL)
                else:
                    exact = bool(torch.equal(a_table, b_table)) and all(
                        torch.equal(a_slots[k], b_slots[k]) for k in a_slots)
                    if not exact:
                        fail(f"{name}: apply_acc differs from apply ({key})")
                    acc_exact = acc_exact and exact
                del a_table, b_table, a_slots, b_slots
        n_ids = int(next(iter(runs["fused"]["recorded"][0].values()))[0].shape[0])
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        result[name] = {
            "step_ms": {e: med(r["step_ms"]) for e, r in runs.items()},
            "step_ms_all": {e: r["step_ms"] for e, r in runs.items()},
            "max_abs_vs_k3": diffs, "apply_acc_bit_exact": acc_exact,
            "launches": {e: r["launches"] for e, r in runs.items()},
            "mode_auto_selects": {key: sparse_optim.select_mode(layer.spec, n_ids, "auto")
                                  for key, layer in layers.items()},
        }
        log(f"engines {name}: step ms (CUDA events, median of {steps}) K3 "
            f"{result[name]['step_ms']['fused']!r}, stream {result[name]['step_ms']['stream']!r},"
            f" scatter {result[name]['step_ms']['scatter']!r}; after {steps} applies of K3's "
            f"inputs max |engine - K3| {diffs}; apply_acc == apply {acc_exact} [{card}]")
        del runs, start
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    result["card"] = card
    return result


# ----------------------------------------------------------------------
# phases 38-39: the observability planes on the card
# ----------------------------------------------------------------------

#: Phase 38's job: phase 27's, a checkpoint every 24 steps (the SIGKILL
#: follows the first), the profiler over steps [9, 17) (tasks 3 and 4:
#: two whole train windows of 4 steps, neither a worker's first task),
#: the goodput SLO at 0.5.
OBS_CKPT_STEPS = 24
OBS_PROFILE_STEPS = (9, 17)
OBS_GOODPUT_TARGET = 0.5
#: The kernels the profiler's window must show by name (a substring of
#: the demangled symbol, e.g. ``void lookup_kernel<4>(...)``): K2 and K3,
#: twice each a step (PERF.md §6).
PROFILED_KERNELS = {"fused_lookup": "lookup_kernel", "fused_dedup_apply": "dedup_apply_kernel"}
#: Phase 24's clean links (each published, polled and checked), before
#: its fault run and its canary gate.
PHASE24_CLEAN_LINKS = 2
#: Phase 25's deltas published under traffic: the fault of its
#: environment fails the second apply once.
PHASE25_LINKS = 2
#: Phase 39's p99 SLO is 4x phase 25's p99; without phase 25 in the run,
#: the highest p99 phase 25 has shown (74 ms on an NVIDIA H100 80GB HBM3,
#: 700.00 W: PERF.md §5).
PHASE25_P99_MS = 74.0
#: Phase 39's seconds of traced traffic (~2,900 requests, ~360 sampled).
TRACED_SECONDS = 4.0
TRACE_HEAD_EVERY = 8


def http_json(addr: str, path: str, timeout_s: float = 10.0):
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}{path}", timeout=timeout_s) as response:
        return json.loads(response.read().decode("utf-8"))


def obs_tool(*args, timeout_s: float = 120.0):
    """``python -m elasticdl_tpu_torch.obs.<tool> args``: (exit code,
    stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", *args], cwd=here, capture_output=True,
                          text=True, timeout=timeout_s)
    return proc.returncode, proc.stdout, proc.stderr


def top_rows(frame: str) -> list:
    """The first column of each row under ``obs.top``'s table header."""
    lines = frame.splitlines()
    for i, line in enumerate(lines):
        if line.startswith(("WORKER", "REPLICA")):
            return [row.split()[0] for row in lines[i + 1:] if row.strip()]
    return []


class PlaneWatch(threading.Thread):
    """Polls a running master's exporter until its ``/slo`` lists the
    goodput SLO with burn rates and ``obs.top --once`` shows a row for
    every live worker (launched and not churned, from the journal)."""

    def __init__(self, tb_dir: str, events: str):
        super().__init__(name="plane-watch", daemon=True)
        self._tb, self._events = tb_dir, events
        self.stop = threading.Event()
        self.slo = self.top = None
        self.errors = []

    def live_workers(self) -> list:
        launched = {e["worker_id"] for e in journal_events(self._events, "worker_launch")}
        gone = {w for e in journal_events(self._events, "worker_churn") for w in e["workers"]}
        return sorted(launched - gone)

    def run(self):
        from elasticdl_tpu_torch.obs.exporter import MetricsExporter

        while not self.stop.wait(0.5):
            try:
                port = MetricsExporter.read_port_file(self._tb)
                if port is None:
                    continue
                addr = f"127.0.0.1:{port}"
                if self.slo is None:
                    payload = http_json(addr, "/slo")
                    rows = [s for s in payload.get("statuses", []) if s["slo"] == "goodput"]
                    if rows and set(rows[0]["burn_rates"]) == {
                            "fast_short", "fast_long", "slow_short", "slow_long"}:
                        self.slo = {"ticks": payload["ticks"], **rows[0]}
                if self.top is None:
                    live = self.live_workers()
                    rc, out, err = obs_tool("elasticdl_tpu_torch.obs.top", "--addr", addr,
                                            "--once", timeout_s=60)
                    rows = top_rows(out)
                    if rc == 0 and live and all(str(w) in rows for w in live):
                        self.top = {"live": live, "rows": rows, "frame": out}
                if self.slo is not None and self.top is not None:
                    return
            except Exception as exc:  # the job may be between states; keep polling
                self.errors.append(repr(exc))


#: A demangled kernel's name and template arguments, the first word that
#: an argument list follows (``void (anonymous namespace)::lookup_kernel<4>(...``).
_KERNEL_NAME = re.compile(r"(\w+(?:<\d+>)?)\(")


def profiled_kernels(trace_path: str) -> dict:
    """Per name in PROFILED_KERNELS: the CUDA kernel events of a Chrome
    trace whose name holds it, their count and mean device ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    out = {}
    for name, symbol in PROFILED_KERNELS.items():
        mine = [e for e in kernels if symbol in e.get("name", "")]
        out[name] = {"events": len(mine),
                     "mean_ms": (sum(e["dur"] for e in mine) / len(mine) / 1e3) if mine else None,
                     "symbols": sorted({m.group(1) for m in map(_KERNEL_NAME.search, (
                         e["name"] for e in mine)) if m})}
    out["kernel_events"] = len(kernels)
    return out


def observed_job_phase(card: str, seed: int, workdir: str, etrf=None,
                       shards: int = ETRF_SHARDS, per_shard: int = ETRF_PER_SHARD,
                       validation: int = ETRF_VALIDATION, vocab: int = 1_000_000,
                       per_task: int = ELASTIC_PER_TASK, batch: int = TRAIN_BATCH,
                       eval_steps: int = ETRF_EVAL_STEPS, checkpoint_steps: int = OBS_CKPT_STEPS,
                       profile_steps=OBS_PROFILE_STEPS, extra_flags=()):
    """Phase 38: phase 27's job (ETRF, vocab 1M per field split, batch
    8192, evaluation every ``eval_steps`` versions) with the observability
    planes on: ``--tensorboard_log_dir``, ``--profile_steps``,
    ``--slo_goodput_target``, ``--metrics_port=0``; worker 0 SIGKILLed
    once the step-``checkpoint_steps`` checkpoint is committed and a task
    is in flight.  Gates: (a) the merged journals assemble with no span
    outside its parent, each done task's ``task.lifetime`` root has
    worker-side children, and the assembler's CLI and selftest pass; (b)
    ``obs.report --json``: a goodput ratio in (0, 1], one rescale with a
    cost, the phases summing to the wall within LEDGER_RTOL; (c) the event
    file, every record's CRC checked: one ``eval/*`` set per finalized
    round at its version, the ``train/*`` scalars; (d) the profiler's
    Chrome trace holds K2 and K3 by name, 2 each a traced step; (e) while
    the job runs, ``/slo`` lists the goodput SLO with its burn rates and
    ``obs.top --once`` a row for each live worker."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.master.tensorboard_service import read_events
    from elasticdl_tpu_torch.obs import trace as obs_trace

    torch.cuda.empty_cache()
    require_free(workdir, 4 * 3_000_000_000 + 1_000_000_000,
                 "the observed job (its files and 3 checkpoints)")
    job = os.path.join(workdir, "observed")
    train_dir, val_dir = os.path.join(job, "train"), os.path.join(job, "validation")
    ckpt, tb = os.path.join(job, "ckpt"), os.path.join(job, "tb")
    n = shards * per_shard
    t0 = time.perf_counter()
    write_criteo_shards(train_dir, n, shards, vocab, seed)
    write_criteo_shards(val_dir, validation, 1, vocab, seed + 27)
    write_s = time.perf_counter() - t0
    master_log = os.path.join(job, "master.log")
    here = os.path.dirname(os.path.abspath(__file__))
    start, end = profile_steps
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
            "--distribution_strategy=ParameterServerStrategy", "--num_workers=1",
            "--model_zoo=model_zoo", f"--model_def={MODEL_DEF}",
            f"--model_params=vocab_size={vocab}", "--sparse_apply_every=1",
            f"--training_data={train_dir}", f"--validation_data={val_dir}",
            f"--evaluation_steps={eval_steps}", f"--minibatch_size={batch}",
            f"--records_per_task={per_task}", f"--checkpoint_dir={ckpt}",
            f"--checkpoint_steps={checkpoint_steps}", "--pipeline=async",
            "--parse_pool_workers=2", f"--tensorboard_log_dir={tb}",
            f"--profile_steps={start},{end}", f"--slo_goodput_target={OBS_GOODPUT_TARGET}",
            "--metrics_port=0", *extra_flags]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    events = os.path.join(tb, "events.jsonl")
    committed = os.path.join(ckpt, f"step_{checkpoint_steps:012d}", "manifest.json")
    t_start = time.time()
    with open(master_log, "wb") as log_file:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
    watch = PlaneWatch(tb, events)
    watch.start()
    try:
        wait_until(f"the step-{checkpoint_steps} checkpoint", lambda: os.path.exists(committed),
                   proc, master_log, 600)
        t_commit = os.path.getmtime(committed)
        wait_until("a task in flight after the checkpoint",
                   lambda: in_flight(events, 0, t_commit), proc, master_log, 600)
        launch = journal_events(events, "worker_launch")[0]
        victim = launch["pid"]
        if launch["worker_id"] != 0 or parent_pid(victim) != proc.pid:
            fail(f"observed job: worker {launch} is not the master's ({proc.pid}) child")
        os.kill(victim, signal.SIGKILL)
        log(f"observed job: SIGKILLed worker 0 (pid {victim}) {time.time() - t_start!r} s after "
            f"the master started, once step {checkpoint_steps} was committed")
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            fail(f"the observed job did not finish within 900 s:\n{tail(master_log)}")
        wall = time.time() - t_start
    finally:
        watch.stop.set()
        watch.join(timeout=120)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    logs = os.path.join(ckpt, "elasticdl-job_worker_logs")
    if rc != 0:
        fail(f"the observed job exited {rc}:\n{tail(master_log)}\n--- worker 1\n"
             f"{tail(os.path.join(logs, 'worker_1.log'))}")

    def worker_events(wid, event):
        return journal_events(os.path.join(tb, f"events_worker_{wid}.jsonl"), event)

    master = {name: journal_events(events, name) for name in (
        "task_dispatch", "task_done", "worker_churn", "evaluation_metrics", "master_exit")}
    if len(master["worker_churn"]) != 1 or master["master_exit"][-1]["forbidden_modules"]:
        fail(f"observed job: churn {master['worker_churn']}, exit {master['master_exit']}")
    schema_checked = journals_schema(tb, "observed job")

    # (e) the live planes.
    if watch.slo is None or watch.top is None:
        fail(f"observed job: the live planes never answered: /slo {watch.slo}, top "
             f"{watch.top}; errors {watch.errors[-3:]}")

    # (a) the trace.
    assembled = obs_trace.assemble([tb])
    problems = assembled["invariant_problems"] + obs_trace.validate_chrome_trace(
        assembled["chrome"])
    spans = assembled["spans"]
    by_id = {s["span_id"]: s for s in spans}
    for done in master["task_done"]:
        root = by_id.get(done["trace_id"])
        children = [s for s in spans if s["parent_span_id"] == done["trace_id"]
                    and s["proc"].startswith("worker_")]
        if root is None or root["name"] != "task.lifetime" or root["proc"] != "master":
            problems.append(f"task {done['task_id']}: root {root}")
        elif not {"worker.task", "worker.report_task"} <= {s["name"] for s in children}:
            problems.append(f"task {done['task_id']}: worker children "
                            f"{sorted(s['name'] for s in children)}")
    trace_json = os.path.join(job, "trace.json")
    rc_cli, _, err_cli = obs_tool("elasticdl_tpu_torch.obs.trace", tb, "-o", trace_json)
    rc_self, out_self, err_self = obs_tool("elasticdl_tpu_torch.obs.trace", "--selftest")
    if rc_cli != 0 or rc_self != 0:
        problems.append(f"obs.trace exited {rc_cli} / --selftest {rc_self}: "
                        f"{err_cli[-800:]} {err_self[-800:]}")
    if problems:
        fail(f"observed job: the trace: {problems[:5]}")

    # (b) the report.
    report_json = os.path.join(job, "report.json")
    rc_rep, report_text, err_rep = obs_tool("elasticdl_tpu_torch.obs.report", events,
                                            "--json", report_json)
    if rc_rep != 0:
        fail(f"observed job: obs.report exited {rc_rep}: {err_rep[-2000:]}")
    with open(report_json) as f:
        report = json.load(f)
    phases_s = sum(report["phases"].values())
    rescales = report["rescales"]
    if not (0.0 < report["goodput_ratio"] <= 1.0) or len(rescales) != 1 or \
            not rescales[0].get("total_s") or \
            abs(phases_s - report["wall_s"]) > LEDGER_RTOL * report["wall_s"]:
        fail(f"observed job: the report's ratio {report['goodput_ratio']}, rescales "
             f"{rescales}, phases {phases_s!r} s against wall {report['wall_s']!r} s")

    # (c) the TensorBoard scalars.
    event_files = sorted(f for f in os.listdir(tb) if f.startswith("events.out.tfevents."))
    if len(event_files) != 1:
        fail(f"observed job: event files {event_files}")
    scalars = {}
    for record in read_events(os.path.join(tb, event_files[0])):
        for tag, value in record["scalars"].items():
            scalars.setdefault(tag, []).append((record["step"], value))
    rounds = master["evaluation_metrics"]
    if not rounds:
        fail("observed job: no evaluation round")
    for name in rounds[0]["metrics"]:
        want = [(r["model_version"], float(np.float32(r["metrics"][name]))) for r in rounds]
        if scalars.get(f"eval/{name}") != want:
            fail(f"observed job: eval/{name} scalars {scalars.get(f'eval/{name}')}, want {want}")
    train_tags = sorted(t for t in scalars if t.startswith("train/"))
    if not {"train/records_finished", "train/model_version", "train/worker_restarts"} <= \
            set(train_tags) or scalars["train/records_finished"][-1][1] != n:
        fail(f"observed job: train scalars {train_tags}: "
             f"{scalars.get('train/records_finished')}")

    # (d) the profiler's window.
    windows = worker_events(0, "profile_window")
    if [w["action"] for w in windows] != ["open", "close"] or not windows[1].get("trace_file"):
        fail(f"observed job: worker 0's profile_window events {windows}")
    window_steps = per_task // batch
    first = windows[0]["at_step"]
    last = -(-(end - 1 - first) // window_steps) * window_steps + first
    traced_steps = last - first
    profiled = profiled_kernels(windows[1]["trace_file"])
    for name in PROFILED_KERNELS:
        if profiled[name]["events"] != 2 * traced_steps:
            fail(f"observed job: the profiler's trace holds {profiled[name]['events']} "
                 f"{PROFILED_KERNELS[name]} kernels in {traced_steps} steps (want "
                 f"{2 * traced_steps}); {profiled['kernel_events']} kernel events")
    trace_mb = os.path.getsize(windows[1]["trace_file"]) / 1e6

    # Launches and rates, as phase 27.
    per_worker, steady = {}, []
    for wid in (0, 1):
        done = worker_events(wid, "worker_task_done")
        last_done = done[-1]
        steps, evals = last_done["process_steps"], last_done["process_eval_batches"]
        want = {"fused_lookup": 2 * steps + 2 * evals, "fused_dedup_apply": 2 * steps}
        if last_done["kernel_launches"] != want or last_done["forbidden_modules"]:
            fail(f"observed job: worker {wid} launched {last_done['kernel_launches']} in "
                 f"{steps} steps and {evals} evaluation batches (want {want})")
        per_worker[wid] = {"steps": steps, "eval_batches": evals,
                           "launches": last_done["kernel_launches"]}
        saved_at = [e["ts"] for e in worker_events(wid, "checkpoint_saved")]
        traced = [w["ts"] for w in worker_events(wid, "profile_window")]
        train_done = [e for e in done if e["type"] == "TRAINING"]
        steady += [e for e in train_done[1:] if not any(
            e["ts"] - e["seconds"] <= ts <= e["ts"] for ts in saved_at + traced)]
    steady_s = sum(e["seconds"] for e in steady)
    steady_rate = sum(e["records"] for e in steady) / steady_s if steady else None
    result = {
        "records": n, "batch": batch, "write_s": write_s, "wall_s": wall,
        "steady_tasks": len(steady), "steady_samples_per_s": steady_rate,
        "phase27_steady_samples_per_s": None if etrf is None else etrf["steady_samples_per_s"],
        "per_worker": per_worker, "journal_records_checked": schema_checked,
        "trace": {"spans": len(spans), "clamped": assembled["clamped"],
                  "offsets": assembled["offsets"],
                  "chrome_events": len(assembled["chrome"]["traceEvents"])},
        "report": {k: report[k] for k in ("goodput_ratio", "wall_s", "phases")},
        "rescale": {k: rescales[0].get(k) for k in ("total_s", "detection_s", "rendezvous_s",
                                                    "redo_s")},
        "eval_rounds": [r["model_version"] for r in rounds], "train_scalar_tags": train_tags,
        "profile": {"window": list(profile_steps), "at_step": first,
                    "traced_steps": traced_steps, "trace_mb": trace_mb, **profiled},
        "slo": {k: watch.slo[k] for k in ("ticks", "burn_rates", "budget_remaining_ratio",
                                          "alerting", "grade")},
        "top_rows": watch.top["rows"], "live_workers": watch.top["live"], "card": card,
    }
    log(f"observed job: report goodput_ratio {report['goodput_ratio']!r} over "
        f"{report['wall_s']!r} s, rescale {result['rescale']}; {len(spans)} spans "
        f"({assembled['clamped']} clamped) over {len(master['task_done'])} tasks; eval rounds "
        f"{result['eval_rounds']}; /slo goodput {result['slo']}; top rows {watch.top['rows']} "
        f"(live {watch.top['live']}) [{card}]")
    log(f"observed job: the profiler's window over steps {first + 1}-{last} ({trace_mb:.1f} MB): "
        f"K2 {profiled['fused_lookup']['events']} x {profiled['fused_lookup']['mean_ms']!r} ms, "
        f"K3 {profiled['fused_dedup_apply']['events']} x "
        f"{profiled['fused_dedup_apply']['mean_ms']!r} ms ({profiled['fused_lookup']['symbols']}, "
        f"{profiled['fused_dedup_apply']['symbols']}) [{card}]")
    log(f"observed job: {steady_rate!r} samples/s over {len(steady)} steady tasks with the "
        f"planes on (phase 27 in this call, planes off: "
        f"{result['phase27_steady_samples_per_s']!r}); K2/K3 per worker {per_worker}; wall "
        f"{wall!r} s [{card}]")
    shutil.rmtree(job, ignore_errors=True)
    return result


def traced_replica_phase(card: str, seed: int, workdir: str, full=None, held_out=None,
                         replica25=None, clients: int = 8, seconds: float = TRACED_SECONDS):
    """Phase 39: ``python -m elasticdl_tpu_torch.serving.replica_main`` on
    the card at phase 25's configuration (phase 20's split DeepFM, 26M
    rows; phase 25's compacted full when it ran, else a fresh full of
    ``loop_trainer``) with ``--trace_head_every=8``,
    ``--slo_availability_target=0.99`` and ``--slo_p99_ms`` at 4x phase
    25's p99; 8 closed-loop clients send 8-row requests, each with its
    own trace id and a client span id.  Gates: every request answered;
    the sampled requests journaled as ``request_trace`` events with the
    generation, each an assembled span tree (``rpc.predict`` under the
    client's span, ``serve.queue`` and ``serve.respond`` under it,
    ``serve.execute`` under the dispatch's one ``serve.batch``, which
    carries the generation), at least one in ``head_every`` of the
    traced requests; ``/slo`` lists both SLOs with burn rates; ``obs.top
    --serving --once`` renders the replica's row; 2 K2 a dispatch
    (``/stats``)."""
    import numpy as np

    from elasticdl_tpu_torch.obs import trace as obs_trace
    from elasticdl_tpu_torch.serving.frontend import PredictClient, encode_features
    from elasticdl_tpu_torch.serving.replica_main import live_replicas

    own = full is None
    if own:
        from elasticdl_tpu_torch.checkpoint.delta import DeltaExporter

        loop = loop_trainer(seed)
        pub = os.path.join(workdir, "traced_pub")
        exporter = DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                 model_params=SPLIT_TRAIN_PARAMS)
        full = exporter.publish_full(loop.trainer, event_time=float(loop.trainer.step))
        held_out = loop.held_out
        del loop, exporter
        import torch

        torch.cuda.empty_cache()
    p25 = replica25["p99_ms"] if replica25 else PHASE25_P99_MS
    slo_p99 = 4.0 * p25
    serve = os.path.join(workdir, "traced_serve")
    os.makedirs(serve, exist_ok=True)
    warmup = os.path.join(workdir, "traced_warmup.npz")
    with open(warmup, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in held_out.items()}))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    stderr_path = os.path.join(workdir, "traced_replica.log")
    stderr = open(stderr_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.replica_main", "--model_dir", full,
         "--serve_dir", serve, "--telemetry_interval_s", "1.0", "--warmup_features", warmup,
         f"--trace_head_every={TRACE_HEAD_EVERY}", "--slo_availability_target=0.99",
         f"--slo_p99_ms={slo_p99}"],
        cwd=here, env=env, stdout=subprocess.DEVNULL, stderr=stderr)

    def died(what):
        stderr.flush()
        fail(f"the traced replica exited {proc.returncode} {what}:\n{tail(stderr_path)}")

    stop = threading.Event()
    records, errors = [], []
    try:
        deadline = time.perf_counter() + 300
        while not live_replicas(serve):
            if proc.poll() is not None:
                died("before it published its port")
            if time.perf_counter() > deadline:
                fail("the traced replica did not publish its port within 300 s")
            time.sleep(0.05)
        info = live_replicas(serve)[0]
        addr, metrics_addr = f"127.0.0.1:{info['port']}", f"127.0.0.1:{info['metrics_port']}"
        rng = np.random.default_rng(39)
        vocab = int(SPLIT_TRAIN_PARAMS.split("vocab_size=")[1].split(",")[0])
        pool = make_requests(rng, vocab, 64, 8)

        def client(w):
            c = PredictClient(addr, deadline_s=30.0)
            i = 0
            try:
                while not stop.is_set():
                    trace_id = f"lg-{w}-{i}"
                    t0 = time.time()
                    try:
                        out = c.predict(pool[(w + i * clients) % len(pool)],
                                        trace_id=trace_id, span_id=trace_id)
                        if out.shape != (8,) or not np.all(np.isfinite(out)):
                            raise ValueError(f"response of shape {out.shape} / non-finite")
                        records.append((t0, time.time(), trace_id))
                    except Exception as exc:
                        errors.append(repr(exc))
                    i += 1
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(w,), name=f"traced-client-{w}")
                   for w in range(clients)]
        t_run = time.time()
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                fail(f"client thread {t.name} did not finish")
        t_end = time.time()
        time.sleep(2.5)  # two SLO ticks and a telemetry record after the traffic
        slo = http_json(metrics_addr, "/slo")
        rc_top, frame, err_top = obs_tool("elasticdl_tpu_torch.obs.top", "--addr", metrics_addr,
                                          "--serving", "--once", timeout_s=60)
        probe = PredictClient(addr, deadline_s=30.0)
        stats = probe.stats()
        probe.close()
        proc.send_signal(signal.SIGTERM)
        try:
            if proc.wait(timeout=30) != 0:
                died("after SIGTERM")
        except subprocess.TimeoutExpired:
            fail("the traced replica did not exit within 30 s of SIGTERM")
    except Exception:
        if proc.poll() is not None:
            died("while serving")
        raise
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        stderr.close()
    if errors:
        fail(f"traced replica: {len(errors)} of {len(errors) + len(records)} requests failed: "
             f"{errors[:3]}")
    journal = os.path.join(serve, "events.jsonl")
    traces = journal_events(journal, "request_trace")
    generation = journal_events(journal, "serving_replica_start")[0]["generation"]
    sampled_head = [t for t in traces if t["sampled_by"] == "head"]
    problems = []
    if len(sampled_head) < len(records) // TRACE_HEAD_EVERY or any(
            t.get("generation") != generation for t in traces):
        problems.append(f"{len(sampled_head)} head samples of {len(records)} traced requests; "
                        f"generations {sorted({t.get('generation') for t in traces})}")
    assembled = obs_trace.assemble([journal])
    spans = assembled["spans"]
    by_id = {s["span_id"]: s for s in spans}
    for t in traces:
        chain = obs_trace.request_chain(spans, t["trace_id"])
        names = [s["name"] for s in chain]
        rpc = next((s for s in chain if s["name"] == "rpc.predict"), None)
        batch = by_id.get((rpc or {}).get("args", {}).get("batch_span_id", ""))
        execute = next((s for s in chain if s["name"] == "serve.execute"), None)
        if (names != list(obs_trace.SERVING_SPAN_ORDER[1:]) or rpc["parent_span_id"] != t[
                "trace_id"] or batch is None or batch["args"].get("generation") != generation
                or execute["parent_span_id"] != batch["span_id"]):
            problems.append(f"{t['trace_id']}: chain {names}, batch {batch}")
            break
    problems += assembled["invariant_problems"]
    statuses = {s["slo"]: s for s in slo.get("statuses", [])}
    if set(statuses) != {"serving_availability", "serving_latency"} or any(
            len(s["burn_rates"]) != 4 for s in statuses.values()):
        problems.append(f"/slo statuses {sorted(statuses)}")
    if rc_top != 0 or top_rows(frame)[:1] != ["0"]:
        problems.append(f"obs.top --serving exited {rc_top}: {frame[-800:]} {err_top[-400:]}")
    launches, dispatches = stats["kernel_launches"], stats["executes"]
    if launches["fused_lookup"] != 2 * dispatches or launches["fused_lookup_fm"]:
        problems.append(f"launches {launches} in {dispatches} dispatches")
    if problems:
        fail(f"traced replica: {problems[:4]}")
    latencies = [b - a for a, b, _ in records]
    result = {
        "requests": len(records), "requests_per_s": len(records) / (t_end - t_run),
        "p50_ms": percentile_ms(latencies, 50), "p99_ms": percentile_ms(latencies, 99),
        "phase25_requests_per_s": None if not replica25 else replica25["requests_per_s"],
        "phase25_p99_ms": None if not replica25 else replica25["p99_ms"],
        "slo_p99_ms": slo_p99, "sampled": len(traces),
        "sampled_by": {k: sum(t["sampled_by"] == k for t in traces)
                       for k in ("head", "tail", "outcome")},
        "spans": len(spans), "generation": generation,
        "slo": {name: {k: s[k] for k in ("burn_rates", "budget_remaining_ratio", "alerting")}
                for name, s in statuses.items()},
        "launches": launches, "dispatches": dispatches, "artifact": "phase 25's" if not own
        else "its own", "card": card,
    }
    log(f"traced replica: {len(records)} traced requests of 8 rows from {clients} clients, "
        f"{result['requests_per_s']!r} requests/s, p50 {result['p50_ms']!r} ms, p99 "
        f"{result['p99_ms']!r} ms (phase 25 in this call: {result['phase25_requests_per_s']!r} "
        f"requests/s, p99 {result['phase25_p99_ms']!r} ms); {len(traces)} sampled "
        f"{result['sampled_by']}; /slo {result['slo']} (p99 bound {slo_p99!r} ms); launches "
        f"{launches} in {dispatches} dispatches [{card}]")
    if own:
        shutil.rmtree(os.path.dirname(full), ignore_errors=True)
    shutil.rmtree(serve, ignore_errors=True)
    return result


# ----------------------------------------------------------------------
# phases 40-41: the model-quality plane, the canary gate fed by served
# traffic
# ----------------------------------------------------------------------


#: JAX's canary scenario (``tests/test_quality.py``, the poisoned-delta
#: e2e) on phase 20's split DeepFM: 16-row requests from a pool of 64, a
#: 256-pair window, a join window of 8 virtual seconds, labels 2 ticks
#: late, a replay of 16 batches; clean steps before the full, a clean
#: link, a poisoned retrain, a recovery retrain compacted past the held
#: link and a healthy link, each of TRAIN_BATCH rows from a pool of 8.
QUALITY = dict(rows=16, requests=64, window=256, join_window_s=8.0, replay_batches=16,
               train_batches=8, clean_steps=24, link_steps=2, poison_steps=30,
               recovery_steps=60, healthy_steps=12, clean_ticks=30, storm_ticks=20,
               settle_ticks=6, held_ticks=(31, 45), drift_threshold=0.2)
#: Phase 41: seconds of clean labeled traffic before the first check,
#: the label feed's delay, the poisoned retrain's steps.
QUALITY_PROCESS = dict(clean_s=4.0, label_delay_s=2.0, poison_steps=30, link_steps=2,
                       window=2048, burn_timeout_s=30.0, held_timeout_s=60.0)
#: The bound of a served logit's logloss check against the window's.
QUALITY_LOGLOSS_TOL = 1e-6


def quality_gate_phase(card: str, seed: int, workdir: str, trainer=None,
                       params: str = SPLIT_TRAIN_PARAMS, batch: int = TRAIN_BATCH,
                       cfg=QUALITY, device=None):
    """Phase 40: JAX's poisoned-delta canary scenario in process, under
    the lock checker (``ELASTICDL_LOCKCHECK=1`` before any lock of the
    phase is made), at phase 20's configuration: ``trainer`` (the one
    phases 24 and 36 trained when they ran, else a fresh one) trains on the click labels of
    the served feature layout (``data/stream.feedback_labels``) and
    publishes through a DeltaExporter; two ServingReplicas, each with a
    QualityLedger (virtual clock), a CanaryGate over the ledger's replay
    buffer and a DeltaWatcher, serve 16-row requests whose labels join
    two ticks late.  A clean link passes; a retrain on labels flipped by
    ``stream.labels:error`` is held on every poll while the old
    generation serves the same bits; after the feed heals, a recovery
    retrain compacts past the held link and the next clean link passes.
    Gates: every execute answers; the gate outcomes; the windows' AUC and
    logloss equal ``binary_auc``/``binary_logloss`` of ``pairs()``, one
    ``quality_window`` a tick a replica; on the card K2 twice per
    replay batch and generation in each held poll and K2 and K3 twice a
    training step; ``lockcheck.assert_clean()``.  The drift sketch's
    edges under JAX's hot-key storm are printed.  Returns (result, the
    chain phase 41 serves: trainer, exporter, pub dir, its compacted
    full and the training batches).  ``device``: None for the
    card, "cpu" for the CPU test."""
    import numpy as np

    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.analysis import runtime as lockcheck
    from elasticdl_tpu_torch.checkpoint import delta as deltas
    from elasticdl_tpu_torch.common import faults
    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.stream import feedback_labels
    from elasticdl_tpu_torch.obs.quality import (
        CanaryGate,
        DriftMonitor,
        QualityLedger,
        ReplayBuffer,
        binary_auc,
        binary_logloss,
    )
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.serving.continuous import DeltaWatcher
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    on_card = device is None
    previous = os.environ.get(lockcheck.ENV_VAR)
    os.environ[lockcheck.ENV_VAR] = "1"
    lockcheck.reset()
    t_phase = time.perf_counter()
    try:
        vocab = parse_dict_params(params)["vocab_size"]
        rng = np.random.default_rng(seed + 40)
        train_feats = make_requests(rng, vocab, cfg["train_batches"], batch)
        requests = make_requests(rng, vocab, cfg["requests"], cfg["rows"])
        if trainer is None:
            trainer = stream_trainer(seed, params, device)
        drift = DriftMonitor(threshold=cfg["drift_threshold"], bins=64, origin="replica_0")
        cursor, train_counts, train_s = [0], [], []

        def train(count):
            ske.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(count):
                feats = train_feats[cursor[0] % len(train_feats)]
                labels = feedback_labels(feats).astype(np.int32)
                trainer.train_step_staged(trainer.stage_batch(
                    feats, labels, np.ones((batch,), np.float32)))
                drift.observe_train(feats)
                cursor[0] += 1
            train_s.append(time.perf_counter() - t0)
            counts = ske.launch_counts()
            train_counts.append((count, counts))
            if on_card and (counts["fused_lookup"] != 2 * count
                            or counts["fused_dedup_apply"] != 2 * count):
                fail(f"{count} training steps launched {counts}")

        pub = os.path.join(workdir, "pub_quality")
        require_free(workdir, 4 * state_bytes(list(trainer.state.tables.values())),
                     "phase 40's delta chain")
        journal = obs.init_journal(os.path.join(workdir, "journal_quality"))
        exporter = deltas.DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                        model_params=params)
        train(cfg["clean_steps"])
        t0 = time.perf_counter()
        full = exporter.publish_full(trainer, event_time=float(trainer.step))
        publish_full_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replicas = [ServingReplica(full, device=device) for _ in range(2)]
        load_s = time.perf_counter() - t0
        ledgers, watchers = [], []
        for rid, replica in enumerate(replicas):
            replay = ReplayBuffer(max_batches=cfg["replay_batches"])
            ledgers.append(QualityLedger(window_size=cfg["window"],
                                         join_window_s=cfg["join_window_s"],
                                         origin=f"replica_{rid}", replay=replay))
            gate = CanaryGate(replay, max_logloss_regress=0.10, max_auc_drop=0.05, min_rows=64)
            watchers.append(DeltaWatcher(replica, pub, gate=gate, origin=f"replica_{rid}"))
        rows, pending, served, polls = cfg["rows"], {}, [0], []

        def execute(rid, feats):
            out = np.asarray(replicas[rid].execute(feats, rows)).ravel()[:rows]
            if out.shape != (rows,) or not np.all(np.isfinite(out)):
                fail(f"replica {rid} answered {out.shape} / non-finite outputs")
            served[0] += 1
            return out

        def serve_tick(tick, attach):
            now = float(tick)
            feats = requests[(tick * 7) % len(requests)]
            for rid, ledger in enumerate(ledgers):
                ledger.note_prediction(f"t{tick}-r{rid}", execute(rid, feats), now,
                                       features=feats if attach else None)
            pending[tick] = feats
            late = pending.pop(tick - 2, None)
            if late is not None:
                labels = feedback_labels(late)  # the one shared label feed
                for rid, ledger in enumerate(ledgers):
                    ledger.note_label(f"t{tick - 2}-r{rid}", labels, now)
            for ledger in ledgers:
                ledger.journal_window(now)
            drift.observe_serve(feats)
            drift.evaluate(now)

        def poll(outcome):
            out = []
            for watcher in watchers:
                ske.reset_launch_counts()
                t0 = time.perf_counter()
                summary = watcher.poll_once()
                polls.append({"outcome": summary["outcome"], "s": time.perf_counter() - t0,
                              "launches": ske.launch_counts()})
                if summary["outcome"] != outcome:
                    fail(f"poll_once gave {summary}, not outcome {outcome}")
                out.append(summary)
            return out

        def check_windows(what):
            for ledger in ledgers:
                snap = ledger.snapshot()
                labels, preds = ledger.pairs()
                if (snap["auc"] != binary_auc(labels, preds)
                        or snap["logloss"] != binary_logloss(labels, preds)):
                    fail(f"{what}: the window {snap} is not its pairs' AUC/logloss")
            return [ledger.snapshot() for ledger in ledgers]

        with Timed(CanaryGate, "evaluate") as gate_timer:
            for tick in range(cfg["clean_ticks"]):
                serve_tick(tick, attach=True)
            clean = check_windows("after the clean traffic")
            train(cfg["link_steps"])
            exporter.publish_delta(trainer, event_time=float(trainer.step))
            poll("applied")
            probe = requests[0]
            live = [r.generation for r in replicas]
            before = [execute(rid, probe) for rid in range(2)]
            # Poison: the same flipped feed trains the delta and joins online.
            faults.install("stream.labels:errorx*")
            train(cfg["poison_steps"])
            poisoned = exporter.publish_delta(trainer, event_time=float(trainer.step))
            hot = {"dense": probe["dense"], "cat": np.full_like(probe["cat"], 17)}
            held = []
            first = cfg["clean_ticks"]
            for tick in range(first, first + cfg["storm_ticks"]):
                serve_tick(tick, attach=False)  # the replay keeps its known-good evidence
                for rid in range(2):
                    execute(rid, hot)
                drift.observe_serve(hot)
                if tick in cfg["held_ticks"]:
                    for summary in poll("held"):
                        if summary["held"] != poisoned:
                            fail(f"the poll held {summary['held']}, not {poisoned}")
                        held.append(summary["reason"])
            for rid, replica in enumerate(replicas):
                if replica.generation is not live[rid]:
                    fail(f"replica {rid} moved off its generation under a held link")
                if not np.array_equal(execute(rid, probe), before[rid]):
                    fail(f"replica {rid} does not serve the previous generation's bits")
            storm = check_windows("after the storm")
            # Recovery: the feed heals, a clean retrain compacts past the
            # held link (an ungated reload), and the next link passes.
            faults.clear()
            train(cfg["recovery_steps"])
            exporter.publish_delta(trainer, event_time=float(trainer.step))
            t0 = time.perf_counter()
            exporter.compact()
            compact_s = time.perf_counter() - t0
            first += cfg["storm_ticks"]
            for tick in range(first, first + cfg["settle_ticks"]):
                serve_tick(tick, attach=True)
            if not all(s["reloaded_full"] for s in poll("applied")):
                fail("the compacted full did not reload")
            train(cfg["healthy_steps"])
            exporter.publish_delta(trainer, event_time=float(trainer.step))
            first += cfg["settle_ticks"]
            for tick in range(first, first + cfg["settle_ticks"]):
                serve_tick(tick, attach=True)
            if [s["applied_deltas"] for s in poll("applied")] != [1, 1]:
                fail(f"the healthy link did not apply: {polls[-2:]}")
            final = check_windows("after the recovery")
        for replica in replicas:
            if replica.generation.step != trainer.step:
                fail(f"a replica serves step {replica.generation.step}, the trainer is at "
                     f"{trainer.step}")
        # Phase 41 starts from a full at the head.
        t0 = time.perf_counter()
        head = exporter.compact()
        compact_s = [compact_s, time.perf_counter() - t0]
        gates = journal_events(journal, "quality_gate")
        outcomes = [(g["origin"], g["outcome"]) for g in gates]
        want = ([("replica_0", "passed"), ("replica_1", "passed")]
                + [("replica_0", "held"), ("replica_1", "held")] * 2
                + [("replica_0", "passed"), ("replica_1", "passed")])
        if outcomes != want or any(obs.missing_fields(g) for g in gates):
            fail(f"quality_gate events {outcomes}, want {want}")
        drifts = [e["state"] for e in journal_events(journal, "quality_drift")]
        windows = journal_events(journal, "quality_window")
        if len(windows) != 2 * (first + cfg["settle_ticks"]):
            fail(f"{len(windows)} quality_window events")
        held_polls = [p for p in polls if p["outcome"] == "held"]
        replay_batches = cfg["replay_batches"]
        if on_card and any(p["launches"]["fused_lookup"] != 2 * 2 * replay_batches
                           or p["launches"]["fused_lookup_fm"] for p in held_polls):
            fail(f"the held polls' shadow runs launched {[p['launches'] for p in held_polls]}")
        report = lockcheck.report()
        lockcheck.assert_clean()
        obs.journal().configure(None)
        longest = max(report["max_hold_s"].items(), key=lambda kv: kv[1])
        metrics = ("auc", "logloss", "calibration_error", "prediction_mean", "joined")
        result = {
            "outcomes": [o for _, o in outcomes], "held_reasons": held,
            "gates": [{k: g.get(k) for k in ("origin", "outcome", "step", "reason",
                                              "baseline_logloss", "candidate_logloss",
                                              "baseline_auc", "candidate_auc", "rows")}
                      for g in gates],
            "windows": {what: [{k: s[k] for k in metrics} for s in snaps]
                        for what, snaps in (("clean", clean), ("storm", storm),
                                            ("final", final))},
            "drift_edges": drifts, "served": served[0], "steps": cursor[0],
            "train_s": train_s, "train_launches": train_counts,
            "poll_s": [p["s"] for p in polls], "held_poll_launches": [
                p["launches"] for p in held_polls],
            "shadow_eval_s": gate_timer.seconds, "publish_full_s": publish_full_s,
            "replica_load_s": load_s, "compact_s": compact_s,
            "lockcheck": {"locks": len(report["max_hold_s"]),
                          "names": sorted(report["max_hold_s"]),
                          "acquisitions": report["acquisitions"],
                          "longest_hold": {"lock": longest[0], "s": longest[1]},
                          "long_holds": len(report["long_holds"]), "inversions": 0},
            "phase_s": time.perf_counter() - t_phase, "card": card,
        }
    finally:
        faults.clear()
        if previous is None:
            os.environ.pop(lockcheck.ENV_VAR, None)
        else:
            os.environ[lockcheck.ENV_VAR] = previous
    log(f"quality gate: outcomes {result['outcomes']} (held: {held}); windows {result['windows']};"
        f" drift {drifts}; {served[0]} executes answered; shadow evaluations "
        f"{gate_timer.seconds!r} s; polls {result['poll_s']!r} s; K2 in each held poll "
        f"{[p['fused_lookup'] for p in result['held_poll_launches']]}; training launches "
        f"{train_counts}; lock checker: {result['lockcheck']} clean [{card}]")
    del replicas, watchers, ledgers
    if on_card:
        import torch

        torch.cuda.empty_cache()
    chain = {"trainer": trainer, "exporter": exporter, "pub": pub, "full": head,
             "train_feats": train_feats}
    return result, chain


def _window_pairs(sends, sampled, responses, window: int):
    """The (labels, predictions) a replica's QualityLedger holds after the
    label sends ``sends`` (in order: each a list of (trace id, labels)
    with the replica's reply): the sampled ids join in send order, each
    request's rows in order; the window keeps the newest ``window``."""
    import numpy as np

    labels, preds = [], []
    for items, reply in sends:
        joined = [(tid, y) for tid, y in items if tid in sampled]
        if len(joined) != reply["joined"]:
            fail(f"a label send joined {reply['joined']} ids, {len(joined)} of them sampled")
        for tid, y in joined:
            labels.append(np.asarray(y, np.float64).ravel())
            preds.append(np.asarray(responses[tid], np.float32).astype(np.float64).ravel())
    if not labels:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(labels)[-window:], np.concatenate(preds)[-window:]


def quality_replica_phase(card: str, seed: int, workdir: str, chain: dict, traced=None,
                          clients: int = 8, params: str = SPLIT_TRAIN_PARAMS,
                          cfg=QUALITY_PROCESS, device=None):
    """Phase 41: ``python -m elasticdl_tpu_torch.serving.replica_main`` on
    the card from phase 40's compacted full, tracking its pub dir, with
    ``--quality_join_window_s=8``, ``--quality_slo_logloss`` between the
    model's clean and flipped logloss on the request pool,
    ``--trace_head_every=8`` and ``--pub_dir``.  8 closed-loop clients
    send 8-row traced requests; a label feed (``bench/loadgen``) sends
    each answered request's labels through the ``labels`` request about
    2 s late.  The parent publishes a clean link, flips the feed
    (``stream.labels:error``) until ``/slo`` shows the ``model_quality``
    SLO burning, heals it, then publishes a link retrained on flipped
    labels.  Gates: every request answered; the feed's joins equal the
    replica's joined counter; a ``quality_window`` event's logloss equal
    to the one recomputed from the responses and labels of the sampled
    ids within QUALITY_LOGLOSS_TOL; the clean link passed and the
    poisoned one held on at least 2 polls, with the step unmoved and the
    same outputs served (batched with the traffic: within LOGIT_RTOL);
    ``model_quality`` burning only while flipped
    labels join; ``obs.report`` has a quality section; ``obs.top
    --serving --once`` renders the replica's row; on the card K2 twice a
    dispatch and twice per replay batch and generation of each shadow
    evaluation (``/stats``)."""
    import numpy as np

    from elasticdl_tpu_torch.bench.loadgen import run_label_feed
    from elasticdl_tpu_torch.common import faults
    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.stream import feedback_labels
    from elasticdl_tpu_torch.obs.quality import binary_auc, binary_logloss
    from elasticdl_tpu_torch.serving.frontend import PredictClient, encode_features
    from elasticdl_tpu_torch.serving.replica_main import live_replicas

    on_card = device is None
    trainer, exporter = chain["trainer"], chain["exporter"]
    vocab = parse_dict_params(params)["vocab_size"]
    pool = make_requests(np.random.default_rng(seed + 41), vocab, 64, 8)
    pool_labels = np.concatenate([feedback_labels(r) for r in pool])
    pool_logits = np.concatenate([np.asarray(trainer.eval_step(r)).ravel() for r in pool])
    clean_ll = binary_logloss(pool_labels, pool_logits)
    flipped_ll = binary_logloss(1.0 - pool_labels, pool_logits)
    if flipped_ll - clean_ll < 0.5:
        fail(f"the model's logloss on the pool, clean {clean_ll} and flipped {flipped_ll}, is too "
             "close for the quality SLO to tell apart")
    bound = 0.5 * (clean_ll + flipped_ll)
    serve = os.path.join(workdir, "quality_serve")
    os.makedirs(serve, exist_ok=True)
    warmup = os.path.join(workdir, "quality_warmup.npz")
    with open(warmup, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in pool[0].items()}))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.serving.replica_main", "--model_dir",
            chain["full"], "--serve_dir", serve, "--pub_dir", chain["pub"],
            "--pub_poll_interval_s", "0.5", "--telemetry_interval_s", "1.0", "--warmup_features",
            warmup, f"--trace_head_every={TRACE_HEAD_EVERY}", "--quality_join_window_s=8",
            f"--quality_window_size={cfg['window']}", f"--quality_slo_logloss={bound}"]
    if device is not None:
        argv += ["--device", device]
    stderr_path = os.path.join(workdir, "quality_replica.log")
    stderr = open(stderr_path, "w")
    t_launch = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=here, env=env, stdout=subprocess.DEVNULL, stderr=stderr)
    journal = os.path.join(serve, "events.jsonl")

    def died(what):
        stderr.flush()
        fail(f"the quality replica exited {proc.returncode} {what}:\n{tail(stderr_path)}")

    def wait_for(what, predicate, timeout_s):
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            value = predicate()
            if value:
                return value
            if proc.poll() is not None:
                died(f"waiting for {what}")
            time.sleep(0.1)
        fail(f"timed out after {timeout_s} s waiting for {what}")

    # The poisoned retrain's labels, flipped by the feed's fault site up
    # front: the feed keeps running (a paused feed's labels would age past
    # the join window) and must stay clean while the link is gated.
    train_feats = chain["train_feats"]
    clean_labels = [feedback_labels(f).astype(np.int32) for f in train_feats]
    faults.install("stream.labels:errorx*")
    flipped_labels = [feedback_labels(f).astype(np.int32) for f in train_feats]
    faults.clear()

    def train(count, labels):
        for i in range(count):
            k = i % len(train_feats)
            trainer.train_step_staged(trainer.stage_batch(
                train_feats[k], labels[k], np.ones((len(labels[k]),), np.float32)))

    def gate_events(step):
        return [e for e in journal_events(journal, "quality_gate") if e["step"] == step]

    def model_quality(slo):
        rows = [s for s in slo.get("statuses", []) if s["slo"] == "model_quality"]
        return rows[0] if rows else None

    stop, feed_stop, feed_lock = threading.Event(), threading.Event(), threading.Lock()
    records, errors, responses, sends, lags = [], [], {}, [], []
    fed = [0]
    try:
        info = wait_for("live_replicas", lambda: live_replicas(serve), 300)[0]
        addr, metrics_addr = f"127.0.0.1:{info['port']}", f"127.0.0.1:{info['metrics_port']}"
        port_published_s = time.perf_counter() - t_launch
        probe = PredictClient(addr, deadline_s=30.0)

        def client(w):
            c = PredictClient(addr, deadline_s=30.0)
            i = 0
            try:
                while not stop.is_set():
                    trace_id, idx = f"q-{w}-{i}", (w + i * clients) % len(pool)
                    t0 = time.time()
                    try:
                        out = c.predict(pool[idx], trace_id=trace_id, span_id=trace_id)
                        if out.shape != (8,) or not np.all(np.isfinite(out)):
                            raise ValueError(f"response of shape {out.shape} / non-finite")
                        responses[trace_id] = out
                        records.append((t0, time.time(), trace_id, idx))
                    except Exception as exc:
                        errors.append(repr(exc))
                    i += 1
            finally:
                c.close()

        def send(mapping, feeder):
            reply = feeder.send_labels(mapping)
            sends.append(([(k, v) for k, v in mapping.items()], reply))
            return reply

        def feed():
            feeder = PredictClient(addr, deadline_s=30.0)
            try:
                while not feed_stop.wait(0.1):
                    with feed_lock:
                        due, now = [], time.time()
                        while fed[0] < len(records) and \
                                now - records[fed[0]][1] >= cfg["label_delay_s"]:
                            _, _, trace_id, idx = records[fed[0]]
                            due.append((trace_id, pool[idx]))
                            fed[0] += 1
                        if due:
                            oldest = records[fed[0] - len(due)][1]
                            t0 = time.time()
                            stats = run_label_feed([lambda m: send(m, feeder)], due,
                                                   group=len(due))
                            lags.append((t0 - oldest, time.time() - t0, len(due)))
                            if stats["send_errors"] or stats["outages"]:
                                errors.append(f"label feed {stats}")
            finally:
                feeder.close()

        threads = [threading.Thread(target=client, args=(w,), name=f"quality-client-{w}")
                   for w in range(clients)]
        feeder = threading.Thread(target=feed, name="quality-label-feed")
        t_run = time.time()
        for t in threads:
            t.start()
        feeder.start()

        def sampled_ids():
            return {e["trace_id"] for e in journal_events(journal, "request_trace")
                    if e["outcome"] == "served"}

        def window_check(what):
            """With the feed paused: the first quality_window journaled
            after the last send against the window rebuilt from the sends."""
            try:
                labels, preds = _window_pairs(sends, sampled_ids(), responses, cfg["window"])
            except SystemExit:
                log(f"label sends (oldest label's age s, send s, labels): {lags}")
                raise
            joined = 8 * sum(reply["joined"] for _, reply in sends)
            event = wait_for(f"a quality_window of {joined} joined pairs ({what})", lambda: next(
                (e for e in journal_events(journal, "quality_window")
                 if e["joined"] == joined and e["window"] == labels.size), None), 10)
            want = binary_logloss(labels, preds)
            if abs(event["logloss"] - want) > QUALITY_LOGLOSS_TOL:
                fail(f"{what}: the window's logloss {event['logloss']} against {want} "
                     "recomputed from the responses and labels")
            return {"joined": joined, "window": event["window"], "logloss": event["logloss"],
                    "recomputed_logloss": want, "auc": event.get("auc"),
                    "recomputed_auc": binary_auc(labels, preds)}

        time.sleep(cfg["clean_s"])
        with feed_lock:
            clean_window = window_check("clean traffic")
            clean_slo = model_quality(http_json(metrics_addr, "/slo"))
        if clean_slo is None or clean_slo["alerting"]:
            fail(f"/slo's model_quality during clean traffic: {clean_slo}")
        # A clean link passes the gate fed by the joined traffic.
        train(cfg["link_steps"], clean_labels)
        exporter.publish_delta(trainer, event_time=float(trainer.step))
        clean_step = trainer.step
        t_pub = time.perf_counter()
        wait_for(f"step {clean_step} on /stats", lambda: probe.stats()["step"] == clean_step, 60)
        clean_link_s = time.perf_counter() - t_pub
        clean_gate = gate_events(clean_step)
        if [g["outcome"] for g in clean_gate] != ["passed"] or clean_gate[0]["quality"] != "known":
            fail(f"the clean link's gate: {clean_gate}")
        # The feed flips: the model_quality SLO burns while flipped labels
        # join, and not before (its short window past the small first
        # windows' noise).
        def fast_burn():
            status = model_quality(http_json(metrics_addr, "/slo"))
            return status, status["burn_rates"]["fast_short"]

        cold = wait_for("model_quality's short-window burn at 0 on clean labels",
                        lambda: (lambda sb: sb[0] if sb[1] == 0 else None)(fast_burn()),
                        cfg["burn_timeout_s"])
        faults.install("stream.labels:errorx*")
        t_flip = time.perf_counter()
        burning = wait_for("model_quality burning on /slo",
                           lambda: (lambda sb: sb[0] if sb[1] > 0 else None)(fast_burn()),
                           cfg["burn_timeout_s"])
        burn_s = time.perf_counter() - t_flip
        faults.clear()
        time.sleep(cfg["label_delay_s"] + 1.0)  # clean joins refill the replay buffer
        # A retrain on flipped labels while the clean feed runs on.
        before = probe.predict(pool[0])
        live_step = probe.stats()["step"]
        train(cfg["poison_steps"], flipped_labels)
        exporter.publish_delta(trainer, event_time=float(trainer.step))
        poisoned_step = trainer.step
        held = wait_for("the poisoned link held twice", lambda: (
            lambda g: g if len(g) >= 2 else None)(
                [e for e in gate_events(poisoned_step) if e["outcome"] == "held"]),
            cfg["held_timeout_s"])
        after = probe.predict(pool[0])
        held_step = probe.stats()["step"]
        stop.set()
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                fail(f"client thread {t.name} did not finish")
        t_end = time.time()
        time.sleep(cfg["label_delay_s"] + 0.5)  # the feed sends the last labels
        feed_stop.set()
        feeder.join(timeout=60)
        with feed_lock:
            if fed[0] != len(records):
                fail(f"the label feed sent {fed[0]} of {len(records)} requests' labels")
            final_window = window_check("after the traffic")
        time.sleep(2.5)  # two SLO ticks and a telemetry record after the traffic
        slo = http_json(metrics_addr, "/slo")
        rc_top, frame, err_top = obs_tool("elasticdl_tpu_torch.obs.top", "--addr", metrics_addr,
                                          "--serving", "--once", timeout_s=60)
        # The watcher retries the held link every poll: three reads of
        # /stats, of which one outside every shadow evaluation counts.
        stat_reads = []
        for _ in range(3):
            t0 = time.time()
            stats = probe.stats()
            stat_reads.append((t0, time.time(), stats))
            time.sleep(0.17)
        probe.close()
        proc.send_signal(signal.SIGTERM)
        try:
            if proc.wait(timeout=30) != 0:
                died("after SIGTERM")
        except subprocess.TimeoutExpired:
            fail("the quality replica did not exit within 30 s of SIGTERM")
    except Exception:
        if proc.poll() is not None:
            died("while serving")
        raise
    finally:
        stop.set()
        feed_stop.set()
        faults.clear()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        stderr.close()
    problems = []
    if errors:
        problems.append(f"{len(errors)} of {len(errors) + len(records)} requests failed: "
                        f"{errors[:3]}")
    if held_step != live_step or not np.allclose(after, before, rtol=LOGIT_RTOL,
                                                 atol=LOGIT_ATOL):
        problems.append(f"under the held link the replica moved from step {live_step} to "
                        f"{held_step} or served {after} for {before}")
    labels_sent = sum(len(items) for items, _ in sends)
    joined_ids = sum(reply["joined"] for _, reply in sends)
    if not joined_ids or final_window["joined"] != 8 * joined_ids:
        problems.append(f"{joined_ids} ids joined by the feed, the replica's counter "
                        f"{final_window['joined']} pairs")
    report_json = os.path.join(workdir, "quality_report.json")
    rc_report, report_text, err_report = obs_tool("elasticdl_tpu_torch.obs.report", journal,
                                                  "--json", report_json)
    quality_section = None
    if rc_report == 0:
        with open(report_json) as f:
            quality_section = json.load(f).get("quality")
    if not quality_section or quality_section.get("holds", 0) < 2 or \
            "model quality" not in report_text:
        problems.append(f"obs.report's quality section {quality_section} ({err_report[-400:]})")
    if rc_top != 0 or top_rows(frame)[:1] != ["0"]:
        problems.append(f"obs.top --serving exited {rc_top}: {frame[-800:]} {err_top[-400:]}")
    # Each gate verdict follows its shadow evaluation's span; a known one
    # ran its replay batches (8 rows each, one dispatch a generation).
    gates = journal_events(journal, "quality_gate")
    spans = [(e["start_ts"], e["start_ts"] + e["duration_s"])
             for e in journal_events(journal, "span") if e["name"] == "quality.shadow_eval"]
    shadow = [b - a for a, b in spans]
    if len(spans) != len(gates):
        problems.append(f"{len(spans)} shadow-evaluation spans for {len(gates)} gate verdicts")
    clean_reads = [(t0, st) for t0, t1, st in stat_reads
                   if not any(a < t1 + 0.005 and b > t0 - 0.005 for a, b in spans)]
    if not clean_reads:
        fail(f"quality replica: every /stats read overlapped a shadow evaluation: {spans[-4:]}")
    t_stats, stats = clean_reads[0]
    launches, dispatches = stats["kernel_launches"], stats["executes"]
    shadow_batches = sum(g["rows"] // 8 for g, (_, end) in zip(gates, spans)
                         if g.get("quality") == "known" and end < t_stats)
    if on_card and (launches["fused_lookup"] != 2 * dispatches + 2 * 2 * shadow_batches
                    or launches["fused_lookup_fm"]):
        problems.append(f"launches {launches} in {dispatches} dispatches and {shadow_batches} "
                        "replay batches of shadow evaluations")
    if problems:
        fail(f"quality replica: {problems[:4]}")
    latencies = [b - a for a, b, _, _ in records]
    result = {
        "requests": len(records), "requests_per_s": len(records) / (t_end - t_run),
        "p50_ms": percentile_ms(latencies, 50), "p99_ms": percentile_ms(latencies, 99),
        "phase39_requests_per_s": None if not traced else traced["requests_per_s"],
        "phase39_p99_ms": None if not traced else traced["p99_ms"],
        "labels_sent": labels_sent, "joined_ids": joined_ids,
        "joined_share": joined_ids / max(1, labels_sent), "sends": len(sends),
        "slo_bound": bound, "pool_logloss": {"clean": clean_ll, "flipped": flipped_ll},
        "clean_window": clean_window, "final_window": final_window,
        "clean_link_s": clean_link_s, "burn_s": burn_s,
        "burn_rates_before_flip": cold["burn_rates"], "burn_rates": burning["burn_rates"],
        "gates": [{k: g.get(k) for k in ("outcome", "step", "quality", "rows", "reason")}
                  for g in gates], "held_polls": len(held),
        "shadow_eval_s": shadow, "port_published_s": port_published_s,
        "slo_after": model_quality(slo), "launches": launches, "dispatches": dispatches,
        "shadow_batches": shadow_batches, "card": card,
    }
    log(f"quality replica: {len(records)} traced requests of 8 rows from {clients} clients, "
        f"{result['requests_per_s']!r} requests/s, p99 {result['p99_ms']!r} ms (phase 39 in "
        f"this call: {result['phase39_requests_per_s']!r} requests/s, p99 "
        f"{result['phase39_p99_ms']!r} ms); labels {labels_sent} sent, {joined_ids} joined "
        f"(share {result['joined_share']!r}); windows {clean_window} / {final_window}; clean "
        f"link passed in {clean_link_s!r} s; model_quality burning {burn_s!r} s after the flip "
        f"({burning['burn_rates']}); poisoned link held {len(held)} times; shadow evaluations "
        f"{shadow!r} s; launches {launches} in {dispatches} dispatches and {shadow_batches} "
        f"shadow batches [{card}]")
    shutil.rmtree(serve, ignore_errors=True)
    return result

def ring_entries(ring_kernels, ring_whole, cp, card, resources=None, cp_wide=None):
    """The K7-K9 entries of the kernels line: timed at RING_BENCH (phase
    13), launched on the CP LM path (phase 15, both layouts) and, with
    their DP=256 builds' numbers, on the head_dim-256 CP LM's (phase 50)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    line = []
    for name in fa.RING_KERNELS:
        r = ring_kernels[name]
        bench_build, path_build = RING_BUILDS[name]
        by_path = {f"cp_lm_train_{layout}_{CP_STEPS}_steps": cp[layout]["launches"][name]
                   for layout in cp}
        wide = None
        if cp_wide is not None:
            for layout in cp:
                by_path[f"cp_lm_head_dim_256_{layout}_{WIDE_STEPS}_steps"] = \
                    cp_wide[layout]["launches"][name]
            wide = {**cp_wide["kernels"][name], "build": RING_WIDE_BUILDS[name],
                    "resources": (resources or {}).get(RING_WIDE_BUILDS[name]),
                    "launches": sum(cp_wide[layout]["launches"][name] for layout in cp),
                    "launches_per_step": cp_wide["contiguous"]["launches_per_step"],
                    "train_step_kernel_ms": {
                        layout: cp_wide[layout]["breakdown_ms"]["kernel_ms"][name]
                        for layout in cp}}
        line.append({
            "name": name, "ok": True, "route": "cuda", "source": RING_SOURCE,
            "replaces": RING_REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ring_bench_max_abs_err": r["ring_bench_max_abs_err"],
            "cp_slot_max_abs_err": r["cp_slot_max_abs_err"],
            "edge_shapes_max_abs_err": r["edge_shapes_max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "tflop_per_s": r["tflop_per_s"],
            "build": bench_build, "resources": (resources or {}).get(bench_build),
            "path_build": path_build, "path_resources": (resources or {}).get(path_build),
            "cp_slot_timing": r.get("cp_slot_timing"),
            "f32_dout": r.get("f32_dout"),
            "library": ("aten._scaled_dot_product_efficient_attention forward, the step's mask "
                        "as attn_bias, without K7's combine"
                        if name == "flash_ring_step_carry" else
                        "aten._scaled_dot_product_efficient_attention backward (dq, dk, dv "
                        "together)"),
            "shape": r["shape"],
            "ring_vs_whole_max_abs_err": {layout: ring_whole[layout] for layout in cp},
            "train_step_ring_kernels_ms": {layout: cp[layout]["breakdown_ms"]["attention_kernels"]
                                           for layout in cp},
            "train_step_kernel_ms": {layout: cp[layout]["breakdown_ms"]["kernel_ms"][name]
                                     for layout in cp},
            "head_dim_256": wide,
            "card": card,
        })
    return line


#: The build of each of K1-K3 on DeepFM's path (dim 9: K3's lanes load
#: 4 window entries each).
SPARSE_BUILDS = {"fused_lookup_fm": ("lookup_fm_kernel",),
                 "fused_lookup": ("lookup_kernel<1>", "lookup_kernel<2>", "lookup_kernel<4>"),
                 "fused_dedup_apply": ("dedup_apply_kernel",)}


#: The build of each of K4-K6 on the LM's path (bf16, head_dim 64).
FLASH_LM_BUILDS = {
    "flash_attention_fwd": "flash_fwd_mma_kernel<bf16, 64>",
    "flash_attention_dq": "flash_dq_mma_kernel<bf16, 64>",
    "flash_attention_dkv": "flash_dkv_mma_kernel<bf16, 64>",
}


def flash_entries(attention, edges, train, card, resources=None, resumed=None, heads=None,
                  tp=None, fsdp=None, wide=None, f16=None):
    """The K4-K6 entries of the kernels line: numbers at the LM's shape
    (the first of ATTN_SHAPES), the other shapes beside them, the
    launches and in-step times of the TP and FSDP paths, and the DP=256
    build's numbers at the head_dim-256 LM's shape (phase 49); then, with
    phase 51's ``f16``, an entry for each f16 build (flash_f16_entries)."""
    line = []
    for name in FLASH_REPLACES:
        main_shape = attention[0]["kernels"][name]
        by_path = {f"lm_train_{LM_STEPS}_steps": train["launches_step"][name],
                   "lm_train_window_4_steps": train["launches_window"][name]}
        if wide is not None:
            by_path[f"lm_head_dim_256_{WIDE_STEPS}_steps"] = wide["lm"]["launches_steps"][name]
        if resumed is not None:
            by_path["lm_resumed_2_steps"] = resumed["launches_resumed_2_steps"][name]
        if heads is not None:
            for head in ("f32", "bf16"):
                by_path[f"lm_{head}_head_{HEAD_STEPS}_steps"] = heads[head]["launches"][name]
        if tp is not None:
            by_path[f"lm_tensor_parallel_{TP_STEPS}_steps (mesh {TP_MESH}, "
                    f"{tp['launches_per_step']} a step)"] = tp["launches"][name]
        if fsdp is not None:
            by_path[f"lm_fsdp_{FSDP_STEPS}_steps (mesh {FSDP_MESH})"] = \
                fsdp["runs"]["fsdp"]["launches"][name]
            by_path[f"lm_fsdp_world_of_one_{FSDP_STEPS}_steps"] = \
                fsdp["world_of_one"]["launches"][name]
        line.append({
            "name": name, "ok": True, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": train["launches_step"][name],
            "launches_by_path": by_path,
            "max_abs_err": max([e["kernels"][name]["max_abs_err"] for e in attention]
                               + ([] if wide is None else
                                  [errs[name] for errs in wide["shapes"].values()])),
            "edge_shapes_max_abs_err": edges[name],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "tflop_per_s": main_shape["tflop_per_s"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "build": FLASH_LM_BUILDS[name],
            "resources": (resources or {}).get(FLASH_LM_BUILDS[name]),
            "library": ("F.scaled_dot_product_attention forward" if name == "flash_attention_fwd"
                        else "F.scaled_dot_product_attention backward (dq, dk, dv together)"),
            "shape": attention[0]["shape"],
            "other_shapes": {e["shape"]: e["kernels"][name] for e in attention[1:]},
            "train_step_attention_ms": train["breakdown_ms"]["attention_kernels"],
            "train_step_kernel_ms": train["breakdown_ms"]["kernel_ms"][name],
            "tp_launches_per_step": None if tp is None else tp["launches_per_step"],
            "tp_slot_shape": None if tp is None else tp["slot_shape"],
            "tp_step_kernel_ms": None if tp is None else tp["breakdown_ms"]["kernel_ms"][name],
            "head_dim_256": None if wide is None else {
                **wide["timed"]["kernels"][name], "shape": wide["timed"]["shape"],
                "build": FLASH_WIDE_BUILDS[name],
                "resources": (resources or {}).get(FLASH_WIDE_BUILDS[name]),
                "launches": wide["lm"]["launches_steps"][name],
                "launches_per_step": wide["lm"]["launches_per_step"][name],
                "train_step_kernel_ms": wide["lm"]["breakdown_ms"]["kernel_ms"][name],
                "shapes_max_abs_err": {shape: errs[name]
                                       for shape, errs in wide["shapes"].items()},
            },
            "card": card,
        })
    return line + ([] if f16 is None else flash_f16_entries(f16, card, resources))


def flash_f16_entries(f16, card, resources=None):
    """K4-K6's f16 builds as entries of their own (phase 51): timed at
    phase 10's main shape (the other timed shape beside it), launched on
    the float16 LM's path, SDPA at float16 as the library call."""
    line = []
    for name in FLASH_REPLACES:
        main_shape, *others = f16["timed"]
        r = main_shape["kernels"][name]
        line.append({
            "name": f"{name} (float16)", "ok": True, "route": "cuda", "source": FLASH_F16_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": f16["lm"]["launches_steps"][name],
            "launches_by_path": {
                f"lm_float16_{F16_STEPS}_steps": f16["lm"]["launches_steps"][name]},
            "max_abs_err": max(errs[name] for errs in f16["shapes"].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "tflop_per_s": r["tflop_per_s"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": ("F.scaled_dot_product_attention forward, float16"
                        if name == "flash_attention_fwd" else
                        "F.scaled_dot_product_attention backward (dq, dk, dv together), float16"),
            "shape": main_shape["shape"],
            "other_shapes": {e["shape"]: e["kernels"][name] for e in others},
            "builds": FLASH_F16_BUILDS[name],
            "resources": {build: (resources or {}).get(build) for build in FLASH_F16_BUILDS[name]},
            "train_step_kernel_ms": f16["lm"]["breakdown_ms"]["kernel_ms"][name],
            "shapes_max_abs_err": {shape: errs[name] for shape, errs in f16["shapes"].items()},
            "card": card,
        })
    return line


def ring_f16_entries(cp_f16, card, resources=None):
    """K7-K9's f16 builds as entries of their own (phase 52): timed at
    the CP LM's slot shape (phase 50's beside it), launched on the
    float16 CP LM's path in both layouts, the memory-efficient attention
    call at float16 as the library call."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    line = []
    layouts = [key for key in ("contiguous", "zigzag") if key in cp_f16]
    for name in fa.RING_KERNELS:
        main_shape, *others = cp_f16["timed"]
        r = main_shape["kernels"][name]
        by_path = {f"cp_lm_float16_{layout}_{CP_STEPS}_steps": cp_f16[layout]["launches"][name]
                   for layout in layouts}
        line.append({
            "name": f"{name} (float16)", "ok": True, "route": "cuda", "source": RING_F16_SOURCE,
            "replaces": RING_REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_step": cp_f16["contiguous"]["launches_per_step"],
            "max_abs_err": max([errs[name] for errs in cp_f16["shapes"].values()]
                               + [e["kernels"][name]["max_abs_err"] for e in cp_f16["timed"]]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "tflop_per_s": r["tflop_per_s"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": ("aten._scaled_dot_product_efficient_attention forward at float16, the "
                        "step's mask as attn_bias, without K7's combine"
                        if name == "flash_ring_step_carry" else
                        "aten._scaled_dot_product_efficient_attention backward at float16 (dq, "
                        "dk, dv together)"),
            "shape": main_shape["shape"],
            "other_shapes": {e["shape"]: e["kernels"][name] for e in others},
            "builds": RING_F16_BUILDS[name],
            "resources": {build: (resources or {}).get(build) for build in RING_F16_BUILDS[name]},
            "train_step_kernel_ms": {layout: cp_f16[layout]["breakdown_ms"]["kernel_ms"][name]
                                     for layout in layouts},
            "shapes_max_abs_err": {shape: errs[name] for shape, errs in cp_f16["shapes"].items()},
            "card": card,
        })
    return line


# ----------------------------------------------------------------------
# phase 42: the port's static analyzer on the card, and the host-sync
# census of the main paths held against its jit-host-sync rule
# ----------------------------------------------------------------------

#: The analyzer's rules: 6 control-plane, 3 protocol, 6 hot-path.
ANALYZER_RULES = 15
#: What ``torch.cuda.set_sync_debug_mode("warn")`` warns with.
SYNC_WARNING = "called a synchronizing CUDA operation"
#: Steps (dispatches) each path runs under the census.
CENSUS_STEPS = {"deepfm_strict": 3, "serve_merged": 3, "lm": 2}


def census_control(x):  # hot-path
    """Phase 42's positive control: a hot step that reads a CUDA tensor
    on the host, which the census and ``jit-host-sync`` must both see."""
    return x.sum().item()


def port_py_files(pkg: str) -> int:
    """The .py files under ``pkg``, counted by walking it (the count the
    analyzer's scan must report)."""
    count = 0
    for _root, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
        count += sum(1 for name in names if name.endswith(".py"))
    return count


def start_analyzer_scan():
    """``python -m elasticdl_tpu_torch.analysis elasticdl_tpu_torch
    --format json``, started now as a background process (host work only:
    the phases before 42 overlap its seconds); ``analyzer_scan`` reads
    it."""
    here = os.path.dirname(os.path.abspath(__file__))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.analysis", "elasticdl_tpu_torch",
         "--format", "json"], cwd=here, stdout=out, stderr=err, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())  # a phase failed first
    return proc, out, err, time.perf_counter()


def analyzer_scan(card: str, started=None) -> dict:
    """The scan of ``start_analyzer_scan`` (started now if it was not) as
    on the CPU: exit 0, every .py file of the port, all 15 rules, zero
    findings."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc, out_file, err_file, t0 = started or start_analyzer_scan()
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    seconds = time.perf_counter() - t0
    with out_file, err_file:
        out_file.seek(0)
        err_file.seek(0)
        proc = subprocess.CompletedProcess(proc.args, proc.returncode, out_file.read(),
                                           err_file.read())
    if proc.returncode != 0:
        fail(f"the port's analyzer exited {proc.returncode} over its own tree:\n"
             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    data = json.loads(proc.stdout)
    files = port_py_files(os.path.join(here, "elasticdl_tpu_torch"))
    if data["files_scanned"] != files or len(data["rules"]) != ANALYZER_RULES:
        fail(f"the analyzer scanned {data['files_scanned']} files with {len(data['rules'])} "
             f"rules; the tree has {files} .py files and the analyzer {ANALYZER_RULES} rules")
    if data["findings"]:
        fail(f"the analyzer reported {len(data['findings'])} findings: {data['findings'][:5]}")
    out = {"seconds": seconds, "files": data["files_scanned"], "rules": len(data["rules"]),
           "findings_by_rule": {rule: 0 for rule in data["rules"]},
           "suppressed_by_rule": data["suppressed_by_rule"],
           "suppressed": data["suppressed"], "timing_s": sum(data["timing"].values()),
           "graph": data["graph"]}
    log(f"analyzer: python -m elasticdl_tpu_torch.analysis over {out['files']} files, "
        f"{out['rules']} rules: exit 0, 0 findings; suppressed by rule "
        f"{out['suppressed_by_rule']}; {seconds!r} s of command time "
        f"({out['timing_s']!r} s in the index and rules) [{card}]")
    return out


class SyncCensus:
    """Every synchronising CUDA call while ``watching``: the warning
    ``torch.cuda.set_sync_debug_mode("warn")`` raises, at the innermost
    frame of the port (or of this script), mapped to its enclosing
    function with the analyzer's function index."""

    def __init__(self):
        here = os.path.dirname(os.path.abspath(__file__))
        self.here = here
        self.script = os.path.abspath(__file__)
        self.port = os.path.join(here, "elasticdl_tpu_torch") + os.sep
        self.records = []  # (path relative to the checkout, line)

    @contextlib.contextmanager
    def watching(self):
        import warnings

        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def _show(self, message, category, filename, lineno, file=None, line=None):
        import traceback

        if SYNC_WARNING not in str(message):
            return
        site = None
        for frame in reversed(traceback.extract_stack()[:-1]):
            path = os.path.abspath(frame.filename)
            if path.startswith(self.port) or path == self.script:
                site = (os.path.relpath(path, self.here), frame.lineno)
                break
        self.records.append(site or (filename, lineno))

    def take(self) -> list:
        records, self.records = self.records, []
        return records


def analyzer_index(paths):
    """The analyzer's view of ``paths``: each file's function index with
    the whole-program hot-ness, and the lines ``jit-host-sync`` reports
    or that carry its ``noqa-invariant``."""
    from elasticdl_tpu_torch.analysis.core import SourceFile, discover_files
    from elasticdl_tpu_torch.analysis.program import build_program_index
    from elasticdl_tpu_torch.analysis.torch_rules import check_jit_host_sync

    sources = {path: SourceFile.parse(path) for path in discover_files(paths)}
    build_program_index(list(sources.values()))
    covered = set()
    for path, source in sources.items():
        covered.update((path, v.line) for v in check_jit_host_sync(source))
        covered.update((path, line) for line, rules in source.noqa.items()
                       if "jit-host-sync" in rules and line not in source.noqa_without_reason)
    return sources, covered


def census_sites(records, sources, covered, steps: int) -> dict:
    """Group ``records`` by site: count, enclosing function, hot or not,
    and whether the static rule covers it."""
    from elasticdl_tpu_torch.analysis.traced import traced_index

    sites = {}
    for path, line in records:
        entry = sites.setdefault((path, line), {"site": f"{path}:{line}", "count": 0})
        entry["count"] += 1
    out = []
    for (path, line), entry in sorted(sites.items()):
        source = sources.get(path)
        info = traced_index(source).function_at(line) if source is not None else None
        hot = bool(info) and info.qualname in traced_index(source).traced
        entry.update(function=info.qualname if info else None, hot=hot,
                     covered=(path, line) in covered)
        out.append(entry)
    hot = sum(entry["count"] for entry in out if entry["hot"])
    return {"steps": steps, "syncs": len(records), "syncs_per_step": len(records) / steps,
            "hot_syncs_per_step": hot / steps,
            "outside_syncs_per_step": (len(records) - hot) / steps, "sites": out}


def analyzer_census_phase(card: str, seed: int, scan=None) -> dict:
    """Phase 42: the analyzer's gate on the card (``scan``: its process,
    when ``start_analyzer_scan`` started it earlier), then the census of
    host syncs on three main paths (a positive control first); every sync
    in a function the analyzer marks hot must be a jit-host-sync finding
    or carry its noqa-invariant."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.analysis.core import SourceFile
    from elasticdl_tpu_torch.analysis.torch_rules import check_jit_host_sync
    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays, synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.runtime import ServingReplica
    from elasticdl_tpu_torch.zoo import build_model, resolve

    start = time.perf_counter()
    out = {"scan": analyzer_scan(card, scan)}
    census = SyncCensus()
    here = census.here
    t0 = time.perf_counter()
    sources, covered = analyzer_index([os.path.join(here, "elasticdl_tpu_torch")])
    sources = {os.path.relpath(path, here): src for path, src in sources.items()}
    covered = {(os.path.relpath(path, here), line) for path, line in covered}
    script = os.path.relpath(census.script, here)
    sources[script] = SourceFile.parse(census.script)
    control_lines = {v.line for v in check_jit_host_sync(sources[script])
                     if "census_control" in v.message}
    covered |= {(script, line) for line in control_lines}
    out["index_s"] = time.perf_counter() - t0
    dev = card_device()

    # the positive control: one .item() on a CUDA tensor in a hot step
    with census.watching():
        census_control(torch.ones(4, device=dev))
    control = census_sites(census.take(), sources, covered, 1)
    seen = [s for s in control["sites"] if s["function"] == "census_control"]
    if not seen or not seen[0]["hot"] or not control_lines or not seen[0]["covered"]:
        fail(f"positive control: census {control['sites']}, jit-host-sync lines "
             f"{sorted(control_lines)}: the census or the rule missed census_control's .item()")
    out["control"] = control
    log(f"positive control: census_control's .item() on a CUDA tensor seen by the census at "
        f"{seen[0]['site']} (hot) and reported there by jit-host-sync [{card}]")

    paths = {}
    # 3 strict DeepFM steps at training_phases' configuration (K1, K3)
    zoo = resolve(MODEL_DEF)
    model = build_model(MODEL_DEF, TRAIN_PARAMS)
    trainer = ShardedEmbeddingTrainer(model, zoo.loss, zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer(), seed=seed)
    trainer.ensure_initialized()
    n = CENSUS_STEPS["deepfm_strict"] + 1
    feats, labels = synthetic_ctr_arrays(TRAIN_BATCH * n, vocab_size=1_000_000, seed=seed)
    batches = [({k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k, v in feats.items()},
                labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                np.ones((TRAIN_BATCH,), np.float32)) for i in range(n)]
    # A step as the worker's loop runs it: stage the batch, then the step.
    trainer.train_step_staged(trainer.stage_batch(*batches[0]))  # first use, outside
    torch.cuda.synchronize()
    ske.reset_launch_counts()
    with census.watching():
        losses = [trainer.train_step_staged(trainer.stage_batch(*batch))
                  for batch in batches[1:]]
    counts = ske.launch_counts()
    torch.cuda.synchronize()
    steps = CENSUS_STEPS["deepfm_strict"]
    if counts["fused_lookup_fm"] != steps or counts["fused_dedup_apply"] != steps:
        fail(f"census: {steps} DeepFM steps launched {counts}")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        fail("census: non-finite DeepFM loss")
    paths["deepfm_strict"] = dict(census_sites(census.take(), sources, covered, steps),
                                  launches=counts)

    # 3 merged-layout dispatches at serving_phases' configuration (K1)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_census_")
    try:
        artifact = export_model(trainer, os.path.join(workdir, "merged"), model_zoo="model_zoo",
                                model_def=MODEL_DEF, model_params=TRAIN_PARAMS)
        del trainer, model
        torch.cuda.empty_cache()
        replica = ServingReplica(artifact)
        request = make_requests(np.random.default_rng(seed), 1_000_000, 1, 64)[0]
        replica.execute(request, 64)  # first use, outside the census
        torch.cuda.synchronize()
        ske.reset_launch_counts()
        with census.watching():
            served = [replica.execute(request, 64) for _ in range(CENSUS_STEPS["serve_merged"])]
        counts = ske.launch_counts()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    steps = CENSUS_STEPS["serve_merged"]
    if counts["fused_lookup_fm"] != steps:
        fail(f"census: {steps} dispatches launched {counts}")
    if any(r.shape != (64,) or not np.all(np.isfinite(r)) for r in served):
        fail("census: a dispatch returned a wrong shape or non-finite logits")
    paths["serve_merged"] = dict(census_sites(census.take(), sources, covered, steps),
                                 launches=counts)
    del replica
    torch.cuda.empty_cache()

    # 2 LM steps at LM_BENCH as lm_training_phases runs them (K4-K6)
    cfg = LM_BENCH
    lm_zoo = resolve(LM_DEF)
    lm = build_model(LM_DEF, dict(vocab=cfg["vocab"], d_model=cfg["d_model"],
                                  num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
                                  max_len=cfg["seq_len"]))
    lm_trainer = DataParallelTrainer(lm, lm_zoo.loss, lm_zoo.optimizer(LM_LR), seed=seed)
    lm_trainer.ensure_initialized()
    n = CENSUS_STEPS["lm"] + 1
    tokens, nxt = synthetic_lm_arrays(LM_BATCH * n, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((LM_BATCH,), np.float32)
    batches = [(tokens[i * LM_BATCH:(i + 1) * LM_BATCH], nxt[i * LM_BATCH:(i + 1) * LM_BATCH],
                ones) for i in range(n)]
    lm_trainer.train_step_staged(lm_trainer.stage_batch(*batches[0]))  # first use, outside
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    with census.watching():
        losses = [lm_trainer.train_step_staged(lm_trainer.stage_batch(*batch))
                  for batch in batches[1:]]
    counts = fa.launch_counts()
    torch.cuda.synchronize()
    steps = CENSUS_STEPS["lm"]
    if any(counts[name] != cfg["num_layers"] * steps for name in fa.KERNELS):
        fail(f"census: {steps} LM steps launched {counts}")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        fail("census: non-finite LM loss")
    paths["lm"] = dict(census_sites(census.take(), sources, covered, steps), launches=counts)
    del lm_trainer, lm
    torch.cuda.empty_cache()

    missed = [(name, site) for name, path in paths.items() for site in path["sites"]
              if site["hot"] and not site["covered"]]
    for name, path in paths.items():
        log(f"sync census, {name}: {path['syncs']} syncs in {path['steps']} steps "
            f"({path['syncs_per_step']!r} a step: {path['hot_syncs_per_step']!r} inside hot "
            f"functions, {path['outside_syncs_per_step']!r} outside), launches "
            f"{path['launches']} [{card}]")
        for site in path["sites"]:
            where = "hot" if site["hot"] else "outside hot"
            rule = ("jit-host-sync covers it" if site["covered"]
                    else "NOT covered by jit-host-sync" if site["hot"] else "")
            log(f"  {site['site']} in {site['function']} ({where}): {site['count']}x"
                + (f"; {rule}" if rule else ""))
    if missed:
        fail(f"syncs inside hot functions that jit-host-sync misses: {missed}")
    out["paths"] = paths
    out["seconds"] = time.perf_counter() - start
    log(f"phase 42: analyzer and census in {out['seconds']!r} s (index {out['index_s']!r} s) "
        f"[{card}]")
    return out


# ----------------------------------------------------------------------
# phase 43: the census fleet under the real policy engine; phase 44: a
# user's own model zoo end to end
# ----------------------------------------------------------------------

#: Phase 43's SLO settings.  Every window is 5 s but the warn pair's long
#: one (1800/120 = 15 s, ``obs/slo.py``); at a 0.25 s tick a page needs 3
#: bad samples of ~20 and a warn 4 of ~60, so a fault that starts once
#: the windows are full pages before it warns.
POLICY_SLO_P99_MS = 250.0
POLICY_COMPLIANCE_S = 1800.0
POLICY_TICK_S = 0.25
#: The fault, in replica 0 only: POLICY_FAULT_COUNT dispatches stall
#: POLICY_STALL_S each, from the POLICY_FAULT_AFTER-th dispatch after the
#: probes on; the clients start POLICY_WARM_S after the replica, so the
#: SLO windows are full when it starts.
POLICY_STALL_S = 0.5
POLICY_FAULT_COUNT = 20
POLICY_FAULT_AFTER = 400
POLICY_WARM_S = 12.0
#: The user zoo of phase 44: the scaffold at this input width and batch.
USER_ZOO_INPUT = 16
USER_ZOO_BATCH = 256


def fleet_policy_wrapper(path: str, spec: str) -> str:
    """An interpreter for ``replica_argv_fn(python=...)`` that arms
    ``ELASTICDL_FAULTS=spec`` in replica 0 only."""
    with open(path, "w") as f:
        f.write("#!/bin/sh\n"
                "case \" $* \" in *\" --replica_id 0 \"*)\n"
                f"  ELASTICDL_FAULTS='{spec}'; export ELASTICDL_FAULTS;;\n"
                f"esac\nexec {sys.executable} \"$@\"\n")
    os.chmod(path, 0o755)
    return path


def checked_clients(addr, requests, want, per_replica: int, stop):
    """``per_replica`` closed-loop threads a replica until ``stop``, each
    answer held to ``want`` within LOGIT_RTOL/LOGIT_ATOL.  Returns
    ``(threads, records [(rid, t0, t1)], errors)``."""
    import numpy as np

    from elasticdl_tpu_torch.serving.frontend import PredictClient

    records, errors = [], []

    def client(rid, w):
        conn = PredictClient(addr[rid], deadline_s=60.0)
        i = w
        try:
            while not stop.is_set():
                t0 = time.time()
                try:
                    got = conn.predict(requests[i % len(requests)])
                    np.testing.assert_allclose(got, want[i % len(requests)], rtol=LOGIT_RTOL,
                                               atol=LOGIT_ATOL)
                    records.append((rid, t0, time.time()))
                except Exception as exc:  # counted, reported by the caller
                    errors.append(f"replica {rid}: {exc!r}"[:400])
                i += per_replica
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(rid, w), name=f"policy-client-{rid}-{w}")
               for rid in sorted(addr) for w in range(per_replica)]
    for t in threads:
        t.start()
    return threads, records, errors


def p99_lift_time(latencies, threshold_s: float, earlier: int):
    """When the replica's p99 gauge first exceeds ``threshold_s``: the
    ledger's rule (``serving/ledger.AvailabilityLedger``: the p99 rank of
    the last ``WINDOW`` served latencies) replayed on ``latencies``
    ``[(t_end, seconds)]`` in time order, after ``earlier`` fast answers.
    None if it never does."""
    import collections

    from elasticdl_tpu_torch.serving.ledger import WINDOW

    window = collections.deque([0.0] * earlier, maxlen=WINDOW)
    for t_end, latency in latencies:
        window.append(latency)
        if latency <= threshold_s:
            continue
        ranked = sorted(window)
        if ranked[min(len(ranked) - 1, int(round(0.99 * (len(ranked) - 1))))] > threshold_s:
            return t_end
    return None


def window_stats(records, rid, lo, hi):
    """Requests/s and p50/p99 of replica ``rid``'s answers ending in
    ``[lo, hi)`` (host clock)."""
    latencies = [t1 - t0 for r, t0, t1 in records if r == rid and lo <= t1 < hi]
    seconds = hi - lo
    return {"requests": len(latencies), "seconds": seconds,
            "requests_per_s": len(latencies) / seconds if seconds > 0 else None,
            "p50_ms": percentile_ms(latencies, 50), "p99_ms": percentile_ms(latencies, 99)}


def fleet_policy_phase(card: str, seed: int, workdir: str, job: dict, per_replica: int = 4,
                       device=None):
    """Phase 43: ``start_serving_fleet(2, ..., policy=ElasticPolicyEngine(...))``
    serves phase 31's export from two replica processes with a latency
    fault in replica 0.  Gates (JAX's ``tests/test_slo.py:733-813`` over
    real processes): replica 0's ``serving_latency`` pages within the
    bound the windows give and clears after the fault; replica 1 fires
    nothing; the engine journals ``slo_alert`` (``slo_advisory``
    ``["serving_latency"]``, origin ``replica_0``) then
    ``slo_alert_cleared`` and kills or rescales nothing; every answer of
    both replicas within LOGIT_RTOL/LOGIT_ATOL of ``eval_step``; the
    journal valid under ``analysis/journal_schema.py``, no forbidden
    module; 2 K2 a dispatch in each replica."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.analysis import journal_schema
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
    from elasticdl_tpu_torch.master.policy import ElasticPolicyEngine, PolicyConfig
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.serving.frontend import PredictClient, encode_features
    from elasticdl_tpu_torch.serving.supervisor import start_serving_fleet, wait_for_replicas
    from elasticdl_tpu_torch.zoo import build_model, resolve

    t_phase = time.perf_counter()
    zoo = resolve(CENSUS_DEF)
    saver = ShardedCheckpointSaver(job["checkpoint"])
    trainer = ShardedEmbeddingTrainer(build_model(CENSUS_DEF, "", device), zoo.loss,
                                      zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer(),
                                      device=device)
    trainer.set_sharded_restore(saver, saver.latest_step())
    trainer.ensure_initialized()
    requests = census_requests(seed + 43, 64)
    want = [trainer.eval_step(r) for r in requests]
    del trainer
    torch.cuda.empty_cache()

    serve = os.path.join(workdir, "serve_policy")
    warm = os.path.join(workdir, "policy_warmup.npz")
    with open(warm, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in requests[0].items()}))
    fault = (f"serving.execute:latency={POLICY_STALL_S}"
             f"@{len(requests) + POLICY_FAULT_AFTER}x{POLICY_FAULT_COUNT}")
    python = fleet_policy_wrapper(os.path.join(workdir, "policy_python.sh"), fault)
    engine = ElasticPolicyEngine(PolicyConfig(tick_interval_s=1.0))
    manager = start_serving_fleet(
        2, job["export"], serve, policy=engine, python=python, max_batch_size=64,
        max_wait_us=2000, telemetry_interval_s=POLICY_TICK_S, warmup_features=warm,
        slo_p99_ms=POLICY_SLO_P99_MS, slo_availability_target=0.999,
        slo_compliance_window_s=POLICY_COMPLIANCE_S, **({"device": device} if device else {}))
    journal = os.path.join(serve, "events.jsonl")
    probes, stats, stop = {}, {}, threading.Event()
    threads, records, errors = [], [], []
    try:
        if manager.policy is not engine or manager.slo_follower is None:
            fail("start_serving_fleet did not bind the engine and its follower")
        live = wait_for_replicas(serve, 2, timeout_s=300)
        addr = {r["replica_id"]: f"127.0.0.1:{r['port']}" for r in live}
        if sorted(addr) != [0, 1]:
            fail(f"replicas {sorted(addr)}")
        probes = {rid: PredictClient(a, deadline_s=60.0) for rid, a in addr.items()}
        for rid in (0, 1):  # the probes: len(requests) dispatches each, before the fault
            for r, w in zip(requests, want):
                np.testing.assert_allclose(probes[rid].predict(r), w, rtol=LOGIT_RTOL,
                                           atol=LOGIT_ATOL, err_msg=f"replica {rid} probe")
        start0 = next(e["ts"] for e in journal_events(journal, "serving_replica_start")
                      if e["replica_id"] == 0)
        time.sleep(max(0.0, start0 + POLICY_WARM_S - time.time()))
        t_clients = time.time()
        threads, records, errors = checked_clients(addr, requests, want, per_replica, stop)
        deadline = time.time() + 180
        while not any(d.get("reason") == "slo_alert_cleared"
                      for d in journal_events(journal, "policy_decision")):
            if time.time() > deadline or errors:
                fail(f"no slo_alert_cleared decision 180 s after the clients started "
                     f"(errors {errors[:3]}): alerts {journal_events(journal, 'slo_alert')}")
            time.sleep(0.25)
        time.sleep(2.0)  # an after window past the clear
        stop.set()
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                fail(f"client thread {t.name} did not finish")
        t_end = time.time()
        if errors:
            fail(f"{len(errors)} of {len(errors) + len(records)} answers failed: {errors[:3]}")
        ids, restarts = manager.current_worker_ids(), manager.restarts_used
        stats = {rid: probes[rid].stats() for rid in (0, 1)}
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        for probe in probes.values():
            probe.close()
        manager.stop()
        obs.journal().configure(None)
    if engine._thread is not None and engine._thread.is_alive():
        fail("the engine's tick thread outlived the fleet")

    slow = sorted((t0, t1) for rid, t0, t1 in records
                  if rid == 0 and t1 - t0 >= POLICY_STALL_S)
    if len(slow) < POLICY_FAULT_COUNT:
        fail(f"{len(slow)} answers of replica 0 took the {POLICY_STALL_S} s stall")
    t_fault = slow[0][1] - POLICY_STALL_S  # the first delayed dispatch began
    t_fault_end = slow[-1][1]
    alerts = journal_events(journal, "slo_alert")
    decisions = journal_events(journal, "policy_decision")
    fires = [a for a in alerts if a["state"] == "fire"]
    clears = [a for a in alerts if a["state"] == "clear"]
    if ([(a["slo"], a["origin"], a["state"]) for a in alerts]
            != [("serving_latency", "replica_0", "fire"),
                ("serving_latency", "replica_0", "clear")] or fires[0]["grade"] != "page"):
        fail(f"alerts {alerts}: want one page of replica 0's serving_latency, then its clear")
    fired_s, cleared_s = fires[0]["ts"] - t_fault, clears[0]["ts"] - t_fault
    advisory = [d for d in decisions if d["reason"] == "slo_alert"]
    cleared = [d for d in decisions if d["reason"] == "slo_alert_cleared"]
    if (len(advisory) != 1 or advisory[0]["slo_advisory"] != ["serving_latency"]
            or advisory[0]["origin"] != "replica_0" or advisory[0]["grade"] != "page"
            or len(cleared) != 1 or cleared[0]["origin"] != "replica_0"
            or cleared[0]["ts"] < advisory[0]["ts"]):
        fail(f"policy decisions {decisions}")
    decided_s = advisory[0]["ts"] - t_fault
    # The bounds the windows give.  The page: the ledger's p99 lifts when
    # enough slow answers sit in its window (replayed on replica 0's
    # answers after its probes), then 3 bad samples at POLICY_TICK_S page,
    # a tick of jitter; the follower polls each second.  The clear: the
    # slow answers leave the ledger's window of 2048, then the warn pair's
    # long window drains.
    lifted = p99_lift_time(sorted((t1, t1 - t0) for rid, t0, t1 in records if rid == 0),
                           POLICY_SLO_P99_MS / 1e3, len(requests))
    if lifted is None:
        fail(f"replica 0's {len(slow)} slow answers never lift its p99 over "
             f"{POLICY_SLO_P99_MS} ms")
    page_bound_s = lifted - t_fault + 4 * POLICY_TICK_S + 0.5
    decide_bound_s = page_bound_s + 2.0
    after = window_stats(records, 0, t_fault_end, clears[0]["ts"])
    clear_bound_s = (t_fault_end - t_fault + 2048 / max(after["requests_per_s"], 1.0)
                     + POLICY_COMPLIANCE_S / 120 + 4 * POLICY_TICK_S + 2.0)
    if not (0 < fired_s <= page_bound_s and fired_s <= decided_s <= decide_bound_s
            and t_fault_end - t_fault < cleared_s <= clear_bound_s):
        fail(f"page {fired_s!r} s (bound {page_bound_s!r}), decision {decided_s!r} s (bound "
             f"{decide_bound_s!r}), clear {cleared_s!r} s (bound {clear_bound_s!r}) after the "
             "first delayed dispatch")
    if ({d["action"] for d in decisions} != {"hold"} or ids != [0, 1] or restarts
            or journal_events(journal, "worker_churn") or journal_events(journal, "scale")):
        fail(f"the engine acted: decisions {decisions}, replicas {ids}, restarts {restarts}")
    problems = journal_schema.validate_file(journal)
    starts = journal_events(journal, "serving_replica_start")
    if problems or [e["forbidden_modules"] for e in starts] != [[], []]:
        fail(f"journal problems {problems[:5]}; replica starts {starts}")
    per_replica_launches = {}
    for rid, st in stats.items():
        launches, dispatches = st["kernel_launches"], st["executes"]
        if launches.get("fused_lookup") != 2 * dispatches or launches.get(
                "fused_lookup_fm") or launches.get("fused_dedup_apply"):
            fail(f"replica {rid} launched {launches} in {dispatches} dispatches")
        per_replica_launches[rid] = {"dispatches": dispatches, "launches": launches}
    windows = {rid: {"before": window_stats(records, rid, t_clients, t_fault),
                     "during": window_stats(records, rid, t_fault, t_fault_end),
                     "after": window_stats(records, rid, t_fault_end, t_end)}
               for rid in (0, 1)}
    result = {"fault": fault, "first_delayed_dispatch_to_page_s": fired_s,
              "first_delayed_dispatch_to_p99_lift_s": lifted - t_fault,
              "page_bound_s": page_bound_s, "first_delayed_dispatch_to_decision_s": decided_s,
              "decision_bound_s": decide_bound_s, "first_delayed_dispatch_to_clear_s": cleared_s,
              "clear_bound_s": clear_bound_s, "fault_window_s": t_fault_end - t_fault,
              "slow_answers": len(slow), "windows": windows, "per_replica": per_replica_launches,
              "decisions": [(d["action"], d["reason"]) for d in decisions],
              "journal_records": sum(1 for _ in open(journal)),
              "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"fleet policy: the phase {result['phase_s']!r} s; fault {fault} in replica 0; from its first delayed dispatch the p99 "
        f"over {POLICY_SLO_P99_MS} ms {lifted - t_fault!r} s, the page {fired_s!r} s (bound "
        f"{page_bound_s!r}), the engine's slo_alert hold {decided_s!r} s "
        f"(bound {decide_bound_s!r}), the clear {cleared_s!r} s (bound {clear_bound_s!r}; fault "
        f"window {t_fault_end - t_fault!r} s, {len(slow)} slow answers); decisions "
        f"{result['decisions']}, no kill, no rescale; per replica before/during/after "
        f"{windows}; K2 {per_replica_launches} [{card}]")
    return result


def user_zoo_phase(card: str, seed: int, workdir: str, device=None):
    """Phase 44: ``elasticdl zoo init`` scaffolds a user's model zoo;
    ``load_model_spec`` loads it (``--model_zoo <dir> --model_def
    my_model``); the Local ``Trainer`` takes 3 steps on the card (the loss
    finite, the parameters moved); ``export_model(model_zoo=<dir>)`` is
    served by ``replica_main --model_zoo <dir>`` in a fresh process within
    LOGIT_RTOL/LOGIT_ATOL of ``eval_step``, no forbidden module loaded;
    ``zoo build --dockerfile-only`` renders a context with the kernel
    sources and without the JAX package, build outputs or libraries.  An
    MLP: no kernel launches, in this process or the replica."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.client import main as client_main
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.common.model_utils import load_model_spec
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.ops import sparse_gather as sg
    from elasticdl_tpu_torch.serving.export import export_model
    from elasticdl_tpu_torch.serving.frontend import PredictClient
    from elasticdl_tpu_torch.serving.supervisor import wait_for_replicas
    from elasticdl_tpu_torch.worker.trainer import Trainer

    def counts():
        return {**ske.launch_counts(), **fa.launch_counts(), **sg.launch_counts()}

    zoo_dir = os.path.join(workdir, "user_zoo")
    times = {}
    t_phase = t0 = time.perf_counter()
    if client_main.main(["zoo", "init", zoo_dir]) != 0:
        fail("zoo init failed")
    spec = load_model_spec(parse_master_args([
        "--model_zoo", zoo_dir, "--model_def", "my_model", "--training_data", "t",
        "--model_params", f"input_dim={USER_ZOO_INPUT}"]))
    if os.path.dirname(spec.module.__file__) != os.path.realpath(zoo_dir):
        fail(f"my_model came from {spec.module.__file__}")
    times["init_and_load_s"] = time.perf_counter() - t0
    for module in (ske, fa, sg):
        module.reset_launch_counts()
    trainer = Trainer(spec.build_model(device=device), spec.loss, spec.optimizer(), seed=seed,
                      device=device)
    rng = np.random.default_rng(seed + 44)
    batches = [(rng.standard_normal((USER_ZOO_BATCH, USER_ZOO_INPUT)).astype(np.float32),
                rng.integers(0, 2, USER_ZOO_BATCH).astype(np.int32)) for _ in range(3)]
    trainer.ensure_initialized()
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(x, y)) for x, y in batches]
    times["three_steps_s"] = time.perf_counter() - t0
    moved = {k: float((v - before[k]).abs().max()) for k, v in trainer.model.state_dict().items()}
    if not all(np.isfinite(losses)) or not all(m > 0 for m in moved.values()):
        fail(f"user zoo training: losses {losses}, largest moves {moved}")
    x = rng.standard_normal((64, USER_ZOO_INPUT)).astype(np.float32)
    want = trainer.eval_step(x)
    in_process = counts()
    art = export_model(trainer, os.path.join(workdir, "user_zoo_export"), model_zoo=zoo_dir,
                       model_def="my_model", model_params=f"input_dim={USER_ZOO_INPUT}")
    serve = os.path.join(workdir, "user_zoo_serve")
    log_path = os.path.join(workdir, "user_zoo_replica.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serving.replica_main", "--model_dir",
             art, "--serve_dir", serve, "--model_zoo", zoo_dir,
             *(["--device", device] if device else [])],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log_file,
            stderr=subprocess.STDOUT)
    try:
        (live,) = wait_for_replicas(serve, 1, timeout_s=300)
        client = PredictClient(f"127.0.0.1:{live['port']}", deadline_s=60.0)
        try:
            got = client.predict({"features": x})
            times["replica_launch_to_answer_s"] = time.perf_counter() - t0
            st = client.stats()
        finally:
            client.close()
    finally:
        proc.terminate()
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"the user zoo's replica did not stop on SIGTERM: {tail(log_path)}")
    if code != 0:
        fail(f"the user zoo's replica exited {code}: {tail(log_path)}")
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
                               err_msg="the replica against eval_step")
    starts = journal_events(os.path.join(serve, "events.jsonl"), "serving_replica_start")
    if ([e["forbidden_modules"] for e in starts] != [[]]
            or not starts[0]["device"].startswith("cpu" if device == "cpu" else "cuda")):
        fail(f"the user zoo's replica start: {starts}")
    if any(in_process.values()) or any(st["kernel_launches"].values()):
        fail(f"kernel launches on the MLP path: here {in_process}, the replica "
             f"{st['kernel_launches']}")
    context = os.path.join(workdir, "user_zoo_context")
    t0 = time.perf_counter()
    if client_main.main(["zoo", "build", zoo_dir, "--context", context,
                         "--dockerfile-only"]) != 0:
        fail("zoo build --dockerfile-only failed")
    times["build_context_s"] = time.perf_counter() - t0
    walked = [(root, dirs, files) for root, dirs, files in os.walk(context)]
    bad = [os.path.join(root, name) for root, dirs, files in walked for name in dirs + files
           if name in ("_build", "__pycache__", "elasticdl_tpu") or name.endswith(".so")]
    if bad or not os.path.exists(os.path.join(
            context, "elasticdl_tpu_torch", "ops", "csrc", "flash_attention.cu")):
        fail(f"the build context: unwanted {bad[:5]}, or no flash_attention.cu")
    times["phase_s"] = time.perf_counter() - t_phase
    result = {"losses": losses, "largest_moves": moved, "max_abs_err": err, "times": times,
              "context_files": sum(len(files) for _, _, files in walked), "card": card}
    log(f"user zoo: the phase {times['phase_s']!r} s; zoo init + load_model_spec {times['init_and_load_s']!r} s; 3 Local "
        f"Trainer steps on the scaffold (input {USER_ZOO_INPUT}, batch {USER_ZOO_BATCH}) "
        f"{times['three_steps_s']!r} s, losses {losses}; replica_main --model_zoo launch -> "
        f"answer {times['replica_launch_to_answer_s']!r} s, max |replica - eval_step| {err!r}; "
        f"zoo build context {result['context_files']} files in {times['build_context_s']!r} "
        f"s; no kernel launched [{card}]")
    return result


# ----------------------------------------------------------------------
# phases 45-48: tensor parallelism, FSDP, the xla engine's whole-mesh
# tables, the host optimizer kernels
# ----------------------------------------------------------------------

#: Phase 45: the LM at phase 11's widths, tensor parallel over an
#: in-process (data=1, model=4) mesh of the card (2 heads a slot).
TP_MESH = (1, 4)
TP_WARMUP, TP_STEPS, TP_BATCHES = 2, 5, 4
#: Phase 46: the same LM with FSDP dense state over an in-process
#: (data=4, model=1) mesh; 3 steps against replicated from one state.
FSDP_MESH = (4, 1)
FSDP_STEPS = 3
#: Phase 47: the xla engine over an in-process (2, 2) mesh, on phase 19's
#: widths and batch (26M rows, batch 8192) in the split layout, whose
#: lookups are K2 (the merged layout's are K1): the dim-8 table's 1.625M
#: storage blocks split over the 4 slots, the dim-1 table's 203,125 do
#: not and it replicates.  Per step: K2 once per slot on the dim-8 table
#: and once on the dim-1 table.
XLA_MESH = (2, 2)
XLA_WARMUP, XLA_STEPS, XLA_BATCHES = 2, 5, 4
XLA_PLACEMENT = {"fm_embedding/embedding": ("data", "model"), "linear_embedding/embedding": None}
XLA_K2_PER_STEP = XLA_MESH[0] * XLA_MESH[1] + 1
#: Phase 48: the host optimizer kernels against numpy on these shapes: a
#: dense vector, and a [rows, dim] table with a training batch's ids.
NATIVE_DENSE_N = 1 << 20
NATIVE_TABLE = (1_000_000, 8)
NATIVE_IDS = TRAIN_BATCH * NUM_CAT
#: The host kernels against numpy's float32 loops: the same operations in
#: the same order, up to a multiply-add the compiler may contract and
#: ``std::pow`` against numpy's ``power`` in the bias corrections; the
#: step counts exact.
NATIVE_TOL = dict(rtol=1e-5, atol=1e-7)


def lm_params(cfg=None) -> dict:
    cfg = cfg or LM_BENCH
    return dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                num_layers=cfg["num_layers"], max_len=cfg["seq_len"])


def lm_batches(seed: int, n_batches: int, batch: int = LM_BATCH, cfg=None):
    import numpy as np

    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays

    cfg = cfg or LM_BENCH
    tokens, nxt = synthetic_lm_arrays(batch * n_batches, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    return [(tokens[i * batch:(i + 1) * batch], nxt[i * batch:(i + 1) * batch], ones)
            for i in range(n_batches)]


def timed_steps(trainer, staged, warmup: int, steps: int):
    """``warmup`` then ``steps`` steps over ``staged`` (cycled), each timed
    between CUDA events; the launch counts of K4-K9 and of K1-K3 are zeroed
    after the warm-up.  -> (losses, step ms sorted, wall s, peak bytes)."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    losses = [trainer.train_step_staged(staged[i % len(staged)]) for i in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ske.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step_staged(staged[i % len(staged)]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in torch.stack(losses).cpu()]
    return losses, sorted(s.elapsed_time(e) for s, e in events), wall, \
        torch.cuda.max_memory_allocated()


def loss_falls(what: str, losses, head: int = 2) -> tuple:
    import numpy as np

    first, last = float(np.mean(losses[:head])), float(np.mean(losses[-head:]))
    if not np.all(np.isfinite(losses)) or not last < first:
        fail(f"{what}: the loss did not fall: {losses}")
    return first, last


def tp_lm_phase(card: str, seed: int):
    """Phase 45: the LM tensor parallel over an in-process (1, 4) mesh:
    2 warm-up and 5 timed steps (tokens/s, median step, K4-K6's launches
    and in-step times, peak memory; K4-K6 once per layer per slot per
    step, on ``[B, T, H/4, D]``; the loss must fall); then, from one
    state, 3 steps against phase 11's one-card trainer, with f32 blocks
    at phase 12's tolerances and with bf16 blocks at CP_BF16_TOL, kernels
    on both sides and, as the witness, the plain versions on both."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import (
        DataParallelTrainer,
        DPTrainState,
        clone_tree,
    )
    from elasticdl_tpu_torch.zoo import build_model, resolve

    cfg, batch = LM_BENCH, LM_BATCH
    zoo = resolve(LM_DEF)
    data, slots = TP_MESH
    mesh = in_process_mesh(data, slots)
    params = lm_params()
    batches = lm_batches(seed, TP_BATCHES)
    model = build_model(LM_DEF, dict(params, mesh=mesh, model_axis_mode="tp"))
    trainer = DataParallelTrainer(model, zoo.loss, zoo.optimizer(LM_LR), mesh=mesh, seed=seed)
    if trainer.device != card_device() or model.model_axis_mode != "tp":
        fail(f"the TP trainer runs on {trainer.device} with model axis {model.model_axis_mode}")
    trainer.ensure_initialized()
    staged = [trainer.stage_batch(*b) for b in batches]
    losses, step_ms, wall, peak = timed_steps(trainer, staged, TP_WARMUP, TP_STEPS)
    counts = fa.launch_counts()
    per_step = cfg["num_layers"] * slots
    for name in fa.KERNELS:
        if counts[name] != per_step * TP_STEPS:
            fail(f"{name} launched {counts[name]} times in {TP_STEPS} TP steps (want "
                 f"{per_step * TP_STEPS}: once per layer per model slot)")
    if any(counts[name] for name in fa.RING_KERNELS):
        fail(f"the TP path launched a ring kernel: {counts}")
    first, last = loss_falls("TP LM", losses)
    parts = lm_time_parts(trainer, staged[0])
    result = {
        "mesh": list(TP_MESH), "tokens_per_s": TP_STEPS * batch * cfg["seq_len"] / wall,
        "step_ms_median": step_ms[len(step_ms) // 2], "loss_first2": first,
        "loss_last2": last, "breakdown_ms": parts, "peak_memory_gb": peak / 1e9,
        "launches": counts, "launches_per_step": per_step,
        "slot_shape": [batch, cfg["seq_len"], cfg["num_heads"] // slots,
                       cfg["d_model"] // cfg["num_heads"]],
    }
    log(f"TP LM train (mesh {data}x{slots} in-process, {cfg['num_heads'] // slots} heads a "
        f"slot): {TP_STEPS} steps of {batch}x{cfg['seq_len']}: {result['tokens_per_s']!r} "
        f"tokens/s, step median {result['step_ms_median']!r} ms (device, CUDA events); loss "
        f"{first!r} -> {last!r}; launches {counts}; peak {peak / 1e9!r} GB; one step's parts "
        f"{parts} [{card}]")
    del trainer, model, staged
    torch.cuda.empty_cache()

    for use_bf16 in (False, True):
        kind = "bf16" if use_bf16 else "f32"
        model_params = dict(params, use_bf16=use_bf16)
        tp = DataParallelTrainer(
            build_model(LM_DEF, dict(model_params, mesh=mesh, model_axis_mode="tp")), zoo.loss,
            zoo.optimizer(LM_LR), mesh=mesh, seed=seed)
        one_card = DataParallelTrainer(build_model(LM_DEF, model_params, device=card_device()),
                                       zoo.loss, zoo.optimizer(LM_LR), seed=seed,
                                       device=card_device())
        tp.ensure_initialized()
        one_card.ensure_initialized()
        staged = [tp.stage_batch(*b) for b in batches[:3]]
        start = DPTrainState(0, clone_tree(tp.state.params), clone_tree(tp.state.opt_state), {})
        what = f"TP LM ({kind}, K4-K6 on each slot's heads) vs one-card LM ({kind})"
        result[f"vs_one_card_{kind}"] = lm_compare(
            (tp, contextlib.nullcontext), (one_card, contextlib.nullcontext), staged, card, what,
            CP_BF16_TOL if use_bf16 else LM_PATH_TOL)
        if use_bf16:
            tp.state = start
            result["vs_one_card_bf16_plain"] = lm_compare(
                (tp, plain_attention), (one_card, plain_attention), staged, card,
                "the witness: plain TP LM (bf16, the plain versions of K4-K6) vs plain "
                "one-card LM (bf16)", CP_BF16_TOL)
        del tp, one_card, staged, start
        torch.cuda.empty_cache()
    result["card"] = card
    return result


def fsdp_world_child(seed: int) -> None:
    """Phase 46's subprocess: a world of one NCCL rank (``tcp://localhost``),
    the FSDP trainer over its process mesh (a data axis of one: the
    replicated layout), 3 steps, then ``CollectiveCommunicator``'s
    ``allreduce`` and ``barrier``; prints one JSON line."""
    import datetime
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.collective import CollectiveCommunicator
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.zoo import build_model, resolve

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        zoo = resolve(LM_DEF)
        mesh = build_mesh(MeshConfig(1, 1))
        trainer = DataParallelTrainer(build_model(LM_DEF, dict(lm_params(), mesh=mesh)),
                                      zoo.loss, zoo.optimizer(LM_LR), mesh=mesh, seed=seed,
                                      dense_sharding="fsdp")
        batches = lm_batches(seed, FSDP_STEPS)
        trainer.ensure_initialized()
        fa.reset_launch_counts()
        losses = [float(trainer.train_step_local(*b)) for b in batches]
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        comm = CollectiveCommunicator(mesh)
        value = np.asarray([1.5, -2.25], np.float32)
        mean_status, mean = comm.allreduce(value, op="MEAN")
        sum_status, total = comm.allreduce(value, op="SUM")
        barrier = comm.barrier("chip_smoke")
        print(json.dumps({
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "mesh": repr(mesh), "device": str(trainer.device),
            "fsdp_leaves": len(trainer.fsdp_leaves), "losses": losses, "launches": counts,
            "allreduce_mean": [mean_status.name, np.asarray(mean).tolist()],
            "allreduce_sum": [sum_status.name, np.asarray(total).tolist()],
            "barrier": barrier.name}), flush=True)
    finally:
        dist.destroy_process_group()


def fsdp_lm_phase(card: str, seed: int):
    """Phase 46: the LM with FSDP dense state over an in-process (4, 1)
    mesh: each sharded leaf and its AdamW slots held as 4 blocks of 1/4,
    the model's gathered copies released between steps; 3 steps against
    the replicated trainer from one state, losses and every parameter
    and slot equal bit for bit (the optimizer is elementwise); K4-K6
    once per layer per step.  Then, in a subprocess, the FSDP trainer on
    a world-of-one NCCL group and ``CollectiveCommunicator``'s
    ``allreduce`` (``SUCCEEDED``, the value returned) and ``barrier``."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import (
        DataParallelTrainer,
        DPTrainState,
        clone_tree,
    )
    from elasticdl_tpu_torch.zoo import build_model, resolve

    cfg, zoo = LM_BENCH, resolve(LM_DEF)
    mesh = in_process_mesh(*FSDP_MESH)
    data = FSDP_MESH[0]
    params = dict(lm_params(), mesh=mesh)
    batches = lm_batches(seed, FSDP_STEPS)
    replicated = DataParallelTrainer(build_model(LM_DEF, params), zoo.loss,
                                     zoo.optimizer(LM_LR), mesh=mesh, seed=seed)
    fsdp = DataParallelTrainer(build_model(LM_DEF, params), zoo.loss, zoo.optimizer(LM_LR),
                               mesh=mesh, seed=seed, dense_sharding="fsdp")
    replicated.ensure_initialized()
    live = replicated.state
    fsdp.ensure_initialized()
    fsdp.state = DPTrainState(0, clone_tree(live.params), clone_tree(live.opt_state), {})
    leaves = fsdp.fsdp_leaves
    local = fsdp.local_state
    whole_elems = sum(int(np.prod(leaf.flax_shape)) for leaf in leaves.values())
    for name, leaf in leaves.items():
        for i in range(data):
            for tree in (local.params, local.opt_state["mu"], local.opt_state["nu"]):
                if tuple(tree[f"{name}@{i}"].shape) != leaf.block_shape:
                    fail(f"FSDP block {name}@{i}: {tuple(tree[f'{name}@{i}'].shape)}, want "
                         f"{leaf.block_shape}")
        if fsdp.model.get_parameter(name).untyped_storage().size():
            fail(f"FSDP kept the gathered copy of {name} between steps")
    if not leaves:
        fail("FSDP sharded no leaf of the LM")
    staged = [replicated.stage_batch(*b) for b in batches]
    runs = {}
    for name, trainer in (("fsdp", fsdp), ("replicated", replicated)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        events, losses = [], []
        for i in range(FSDP_STEPS):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            losses.append(trainer.train_step_staged(staged[i]))
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        runs[name] = {"losses": [float(x) for x in losses],
                      "step_ms": [s.elapsed_time(e) for s, e in events],
                      "launches": fa.launch_counts(),
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        want = cfg["num_layers"] * FSDP_STEPS
        if any(runs[name]["launches"][k] != want for k in fa.KERNELS):
            fail(f"{name}: K4-K6 launched {runs[name]['launches']} in {FSDP_STEPS} steps "
                 f"(want {want} each)")
    if runs["fsdp"]["losses"] != runs["replicated"]["losses"]:
        fail(f"FSDP losses {runs['fsdp']['losses']} != replicated {runs['replicated']['losses']}")
    got, want = fsdp.state, replicated.state
    differ = [name for name in want.params if not torch.equal(got.params[name], want.params[name])]
    differ += [f"{slot}/{name}" for slot in ("mu", "nu") for name in want.params
               if not torch.equal(got.opt_state[slot][name], want.opt_state[slot][name])]
    if differ:
        fail(f"FSDP vs replicated after {FSDP_STEPS} steps: {len(differ)} leaves differ, "
             f"first {differ[:4]}")
    result = {
        "mesh": list(FSDP_MESH), "sharded_leaves": len(leaves), "leaves": len(want.params),
        "sharded_elements": whole_elems,
        "elements": sum(p.numel() for p in want.params.values()),
        "block_fraction": 1 / data, "runs": runs, "bit_equal": True,
    }
    log(f"FSDP LM over {FSDP_MESH} in-process: {len(leaves)} of {len(want.params)} leaves "
        f"({whole_elems} of {result['elements']} elements) held as {data} blocks with their "
        f"AdamW slots; {FSDP_STEPS} steps bit-equal to replicated (losses, params, mu, nu); "
        f"step ms FSDP {runs['fsdp']['step_ms']} vs replicated {runs['replicated']['step_ms']} "
        f"(CUDA events), peak {runs['fsdp']['peak_memory_gb']!r} vs "
        f"{runs['replicated']['peak_memory_gb']!r} GB [{card}]")
    del fsdp, replicated, staged, got, want, live, local
    torch.cuda.empty_cache()

    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--fsdp_world_child",
                           "--seed", str(seed)], capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        fail(f"the FSDP world of one exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    world = json.loads(lines[-1])
    value = np.asarray([1.5, -2.25], np.float32)
    if world["backend"] != "nccl" or world["world"] != 1 or \
            not world["device"].startswith("cuda"):
        fail(f"the FSDP world of one ran {world}")
    if world["allreduce_mean"] != ["SUCCEEDED", value.tolist()] or \
            world["allreduce_sum"] != ["SUCCEEDED", value.tolist()] or \
            world["barrier"] != "SUCCEEDED":
        fail(f"CollectiveCommunicator on a world of one: {world}")
    if any(world["launches"][k] != cfg["num_layers"] * FSDP_STEPS for k in fa.KERNELS):
        fail(f"the FSDP world of one launched {world['launches']}")
    if not all(np.isfinite(world["losses"])):
        fail(f"the FSDP world of one: losses {world['losses']}")
    result["world_of_one"] = world
    log(f"FSDP world of one (NCCL, {world['mesh']}): {world['fsdp_leaves']} sharded leaves (a "
        f"data axis of one is the replicated layout), losses {world['losses']}, launches "
        f"{world['launches']}; allreduce {world['allreduce_mean']} / {world['allreduce_sum']}, "
        f"barrier {world['barrier']} [{card}]")
    result["card"] = card
    return result


def whole_mesh_lookup_checks(ske, spec, table, gen, dev, mesh, flush, card):
    """K2 on the whole-mesh intervals of ``table`` (65,536 ids): one launch
    per slot; bit-exact with the one-card K2 for ids in the table and
    with the plain route (``fused_lookup_plain``, the same placement) for
    every id, ids no interval owns included; timed beside both."""
    import torch

    slots = mesh.size
    ids = torch.randint(0, spec.vocab_size, (65_536,), generator=gen, device=dev,
                        dtype=torch.int32)
    ske.reset_launch_counts()
    got = ske.fused_lookup(spec, table, ids, mesh=mesh, whole_mesh=True)
    counts = ske.launch_counts()
    if counts["fused_lookup"] != slots or not bit_equal(got, ske.fused_lookup(spec, table, ids)):
        fail(f"whole-mesh fused_lookup: launches {counts}, or it differs from the one-card K2")
    local_rows = spec.vocab_padded // slots
    edges = [-1, -2**31, spec.vocab_padded, 2**31 - 1] + [s * local_rows for s in range(slots)] \
        + [local_rows - 1, spec.vocab_padded - 1]
    edge_ids = ids.clone()
    edge_ids[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    got = ske.fused_lookup(spec, table, edge_ids, mesh=mesh, whole_mesh=True)
    want = ske.fused_lookup_plain(spec, table, edge_ids, mesh=mesh, whole_mesh=True)
    torch.cuda.synchronize()
    if not bit_equal(got, want):
        fail(f"whole-mesh fused_lookup differs from its plain route: "
             f"{first_difference(got, want)}")
    n, dim = ids.shape[0], spec.dim
    r = {
        "shape": f"ids [{n}] dim {dim} over {slots} intervals", "launches_per_call": slots,
        "ms": median_ms(lambda: ske.fused_lookup(spec, table, ids, mesh=mesh, whole_mesh=True),
                        flush),
        "plain_ms": median_ms(lambda: ske.fused_lookup_plain(spec, table, ids, mesh=mesh,
                                                             whole_mesh=True), flush),
        "one_card_ms": median_ms(lambda: ske.fused_lookup(spec, table, ids), flush),
        "bound_ms": bound_ms(lookup_bytes(n, dim)),
        "max_abs_err": float((got - want).abs().max()),
    }
    log(f"whole-mesh fused_lookup over {XLA_MESH} ({slots} intervals of {local_rows} rows): "
        f"bit-exact with the one-card K2 and with the plain route (edge ids); {r['ms']!r} ms "
        f"(plain route {r['plain_ms']!r} ms, one card {r['one_card_ms']!r} ms, bound "
        f"{r['bound_ms']!r} ms), {slots} K2 launches a call [{card}]")
    return r


def whole_mesh_xla_phase(card: str, seed: int):
    """Phase 47: the xla engine's whole-mesh tables: the placement (the
    trainer's and the journal's ``sparse_kernel_selected``), K2 on the
    whole-mesh intervals against the one-card K2 and its plain route, 2
    warm-up and 5 timed steps (K2 launches per step, step ms), then 3
    steps against phase 37's one-card xla engine from one state (the
    sparse applies under PyTorch's deterministic algorithms on both
    sides), tables and slots at phase 37's tolerances."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.common.params import parse_dict_params
    from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer, clone_state
    from elasticdl_tpu_torch.zoo import build_model, resolve

    zoo = resolve(MODEL_DEF)
    mesh = in_process_mesh(*XLA_MESH)
    params = parse_dict_params(SPLIT_TRAIN_PARAMS)
    feats, labels = synthetic_ctr_arrays(TRAIN_BATCH * XLA_BATCHES,
                                         vocab_size=params["vocab_size"], seed=seed)
    batches = [({k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k, v in feats.items()},
                labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                np.ones((TRAIN_BATCH,), np.float32)) for i in range(XLA_BATCHES)]

    def trainer_for(mesh):
        model = build_model(MODEL_DEF, dict(params, mesh=mesh) if mesh else params)
        trainer = ShardedEmbeddingTrainer(model, zoo.loss, zoo.optimizer(),
                                          embedding_optimizer=zoo.embedding_optimizer(),
                                          seed=seed, sparse_kernel="xla", mesh=mesh)
        apply = trainer.sparse_apply

        def deterministic_apply(sparse, apply=apply):
            with deterministic():  # index_add_ in index order on both sides
                apply(sparse)

        trainer.sparse_apply = deterministic_apply
        return trainer

    trainer = trainer_for(mesh)
    if trainer.table_placement != XLA_PLACEMENT:
        fail(f"the xla engine over {XLA_MESH} placed {trainer.table_placement}")
    trainer.ensure_initialized()
    record = [r for r in obs.journal().tail(50) if r["event"] == "sparse_kernel_selected"][-1]
    want_record = {k: None if v is None else ",".join(v) for k, v in XLA_PLACEMENT.items()}
    if record.get("kernel") != "xla" or record.get("placement") != want_record:
        fail(f"the journal's sparse_kernel_selected: {record}")
    gen = torch.Generator(device=card_device())
    gen.manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=card_device())
    layer = trainer.model.fm_embedding
    lookup = whole_mesh_lookup_checks(ske, layer.spec, layer.embedding, gen, card_device(),
                                      mesh, flush, card)
    del flush
    staged = [trainer.stage_batch(*b) for b in batches]
    losses, step_ms, wall, peak = timed_steps(trainer, staged, XLA_WARMUP, XLA_STEPS)
    counts = ske.launch_counts()
    if counts["fused_lookup"] != XLA_K2_PER_STEP * XLA_STEPS or counts["fused_dedup_apply"] or \
            counts["fused_lookup_fm"]:
        fail(f"{XLA_STEPS} whole-mesh xla steps launched {counts} (want K2 "
             f"{XLA_K2_PER_STEP} a step, no K1 or K3)")
    first, last = loss_falls("whole-mesh xla DeepFM", losses)
    result = {
        "mesh": list(XLA_MESH), "placement": record["placement"],
        "samples_per_s": XLA_STEPS * TRAIN_BATCH / wall,
        "step_ms_median": step_ms[len(step_ms) // 2], "loss_first2": first, "loss_last2": last,
        "launches": counts, "k2_per_step": counts["fused_lookup"] / XLA_STEPS,
        "peak_memory_gb": peak / 1e9, "lookup": lookup,
        "breakdown_ms": time_parts(trainer, staged[0], ("fused_lookup",)),
    }
    log(f"whole-mesh xla DeepFM over {XLA_MESH} (26M rows split, batch {TRAIN_BATCH}, adam, "
        f"placement {record['placement']}): {XLA_STEPS} steps, {result['samples_per_s']!r} "
        f"samples/s, step median {result['step_ms_median']!r} ms (device, CUDA events); loss "
        f"{first!r} -> {last!r}; launches {counts}; peak {peak / 1e9!r} GB; one step's parts "
        f"{result['breakdown_ms']} [{card}]")

    start = clone_state(trainer.state)

    def three_steps(trainer):
        losses = [float(trainer.train_step_staged(staged[i])) for i in range(3)]
        state = trainer.state
        torch.cuda.synchronize()
        return losses, {k: t.clone() for k, t in state.tables.items()}, \
            {k: {n: v.clone() for n, v in g.items()} for k, g in state.slots.items()}

    mesh_run = three_steps(trainer)
    del trainer
    torch.cuda.empty_cache()
    one_card = trainer_for(None)
    one_card.ensure_initialized()
    one_card.state = start
    del start
    one_run = three_steps(one_card)
    del one_card
    np.testing.assert_allclose(mesh_run[0], one_run[0], rtol=PATH_LOSS_RTOL)
    worst = 0.0
    for key in one_run[1]:
        worst = max(worst, close_state(f"whole-mesh xla vs one-card xla ({key})",
                                       mesh_run[1][key], mesh_run[2][key], one_run[1][key],
                                       one_run[2][key], ENGINE_TOL))
    result["vs_one_card"] = {"losses_mesh": mesh_run[0], "losses_one_card": one_run[0],
                             "max_abs": worst}
    log(f"whole-mesh xla vs one-card xla (phase 37's engine), 3 steps from one state: losses "
        f"{mesh_run[0]} vs {one_run[0]}; tables and slots max |diff| {worst!r} (tolerance "
        f"{ENGINE_TOL}) [{card}]")
    del mesh_run, one_run
    torch.cuda.empty_cache()
    result["card"] = card
    return result


def native_reference(kind: str, state: dict, grad, step) -> None:
    """numpy float32 twins of ``native/kernel_api.cc``'s dense loops, in
    place (``step``: adam's count, a scalar or one per row)."""
    import numpy as np

    f = np.float32
    lr, mu, b1, b2 = f(0.01), f(0.9), f(0.9), f(0.999)
    p = state["param"]
    if kind == "sgd":
        p -= lr * grad
    elif kind == "momentum":
        state["velocity"][:] = mu * state["velocity"] + grad
        p -= lr * state["velocity"]
    elif kind == "adagrad":
        state["accum"] += grad * grad
        p -= lr * grad / (np.sqrt(state["accum"]) + f(1e-7))
    else:
        t = np.asarray(step, np.float32)
        bc1, bc2 = f(1) - np.power(b1, t), f(1) - np.power(b2, t)
        state["m"][:] = b1 * state["m"] + (f(1) - b1) * grad
        state["v"][:] = b2 * state["v"] + (f(1) - b2) * grad * grad
        p -= lr * (state["m"] / bc1) / (np.sqrt(state["v"] / bc2) + f(1e-8))


def native_sparse_reference(kind: str, state: dict, grad, ids) -> None:
    """The sparse loops' numpy twin: each distinct id's gradients summed
    in position order, then the dense update of its row (momentum and
    adam skip a row whose sum is all zero, and adam counts its steps)."""
    import numpy as np

    uniq, inverse = np.unique(ids, return_inverse=True)
    sums = np.zeros((len(uniq), grad.shape[1]), np.float32)
    np.add.at(sums, inverse, grad)
    if kind in ("momentum", "adam"):
        live = sums.any(axis=1)
        uniq, sums = uniq[live], sums[live]
    rows = {k: v[uniq] for k, v in state.items() if k != "t"}
    step = None
    if kind == "adam":
        state["t"][uniq] += 1
        step = state["t"][uniq][:, None]
    native_reference(kind, rows, sums, step)
    for k, v in rows.items():
        state[k][uniq] = v


def native_kernels_phase(card: str, seed: int):
    """Phase 48: the host optimizer kernels (``native/kernel_api.cc``)
    built with ``g++`` on this machine, each dense and sparse kind against
    its numpy twin over 3 steps at NATIVE_TOL (step counts exact), with
    each call's host time.  Host code: no main path calls them."""
    import numpy as np

    from elasticdl_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build_kernels(force=True)
    if path is None:
        fail("the host optimizer kernels did not build")
    kernels = native.NativeKernels()
    built_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    slots = {"sgd": (), "momentum": ("velocity",), "adagrad": ("accum",), "adam": ("m", "v")}
    result = {"library": os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
              "build_s": built_s}
    for sparse in (False, True):
        for kind, names in slots.items():
            if sparse:
                rows, dim = NATIVE_TABLE
                start = {"param": rng.standard_normal((rows, dim)).astype(np.float32)}
                start.update({n: np.zeros((rows, dim), np.float32) for n in names})
                if kind == "adam":
                    start["t"] = np.zeros(rows, np.int64)
            else:
                start = {"param": rng.standard_normal(NATIVE_DENSE_N).astype(np.float32)}
                start.update({n: np.zeros(NATIVE_DENSE_N, np.float32) for n in names})
            got = {k: v.copy() for k, v in start.items()}
            want = {k: v.copy() for k, v in start.items()}
            host = []
            for step in range(1, 4):
                if sparse:
                    ids = rng.integers(0, NATIVE_TABLE[0] // 8, NATIVE_IDS).astype(np.int64)
                    grad = rng.standard_normal((NATIVE_IDS, NATIVE_TABLE[1])).astype(np.float32)
                    grad[::97] = 0.0  # padding rows: zero grads
                else:
                    ids = None
                    grad = rng.standard_normal(NATIVE_DENSE_N).astype(np.float32)
                t0 = time.perf_counter()
                call_native(kernels, kind, got, grad, ids, step)
                host.append((time.perf_counter() - t0) * 1e3)
                if sparse:
                    native_sparse_reference(kind, want, grad, ids)
                else:
                    native_reference(kind, want, grad, step)
            worst = 0.0
            for key, value in want.items():
                if key == "t":
                    if not np.array_equal(got[key], value):
                        fail(f"host {kind} sparse: the step counts differ")
                    continue
                np.testing.assert_allclose(got[key], value, **NATIVE_TOL,
                                           err_msg=f"host {kind} {key}")
                worst = max(worst, float(np.abs(got[key] - value).max()))
            label = f"{kind}_{'sparse' if sparse else 'dense'}"
            result[label] = {"max_abs": worst, "host_ms": host}
            log(f"host kernel {label}: 3 steps against numpy, max |diff| {worst!r}; host ms "
                f"{[round(x, 3) for x in host]}")
    log(f"host optimizer kernels built with g++ in {built_s:.1f} s ({result['library']}) "
        f"[{card}]")
    result["card"] = card
    return result


def call_native(kernels, kind: str, state: dict, grad, ids, step: int) -> None:
    p = state["param"]
    if ids is None:
        if kind == "sgd":
            kernels.sgd(p, grad, 0.01)
        elif kind == "momentum":
            kernels.momentum(p, state["velocity"], grad, 0.01, 0.9)
        elif kind == "adagrad":
            kernels.adagrad(p, state["accum"], grad, 0.01, 1e-7)
        else:
            kernels.adam(p, state["m"], state["v"], grad, 0.01, 0.9, 0.999, 1e-8, step)
    elif kind == "sgd":
        kernels.sgd_sparse(p, ids, grad, 0.01)
    elif kind == "momentum":
        kernels.momentum_sparse(p, state["velocity"], ids, grad, 0.01, 0.9)
    elif kind == "adagrad":
        kernels.adagrad_sparse(p, state["accum"], ids, grad, 0.01, 1e-7)
    else:
        kernels.adam_sparse(p, state["m"], state["v"], state["t"], ids, grad, 0.01)


# ----------------------------------------------------------------------
# phase 49: K4-K6 at head_dim 256 (their DP=256 builds) and the pad of an
# odd head_dim, driven by the transformer LM at head_dim 256
# ----------------------------------------------------------------------

#: Shapes of the DP=256 builds, (B, T, H, D, dtype, causal): the LM's
#: below (timed), a head_dim of the build that is not 256, and a small f32
#: shape (the f32 builds, whose K5 and K6 share a tile buffer there).
WIDE_SHAPES = ((8, 2048, 8, 256, "bfloat16", True), (2, 2048, 4, 136, "bfloat16", True),
               (2, 512, 4, 256, "float32", True))
#: A head_dim that is no multiple of 8: the wrappers pad it to 104 (the
#: DP=128 build) and slice the outputs back.
WIDE_PAD_SHAPE = (2, 512, 4, 100, "bfloat16", True)
#: The LM at Gemma 2B's attention geometry (hidden 2048, 8 heads of 256)
#: on TRANSFORMER_BENCH's depth, vocab and T; everything else the repo's
#: LM (learned positions, the GELU MLP at ratio 4, the f32 head).
WIDE_LM = dict(LM_BENCH, d_model=2048, num_heads=8)
WIDE_BATCH = 8
#: AdamW at phase 11's 3e-3 scaled by the width ratio 512 / 2048: Adam
#: moves every element by about lr a step, so a layer's output moves in
#: proportion to its fan-in, and at 3e-3 this width's loss rose from
#: 10.90 to 12.48 over its first 7 steps on an H100 (and diverged at 2
#: layers on the CPU, where 7.5e-4 fell).
WIDE_LR = LM_LR * LM_BENCH["d_model"] / 2048
WIDE_WARMUP, WIDE_STEPS, WIDE_BATCHES = 2, 5, 4
#: Batch of phase 12's gate here (kernel path against plain path).
WIDE_PATH_BATCH = 2
#: The build of each of K4-K6 on this LM's path (bf16, head_dim 256).
FLASH_WIDE_BUILDS = {
    "flash_attention_fwd": "flash_fwd_mma_kernel<bf16, 256>",
    "flash_attention_dq": "flash_dq_mma_kernel<bf16, 256>",
    "flash_attention_dkv": "flash_dkv_mma_pair_kernel<bf16, 256>",
}


def wide_attention_checks(fa, gen, dev, card):
    """K4-K6 against their plain versions at WIDE_SHAPES and, through the
    pad, at WIDE_PAD_SHAPE (phase 10's tolerances); the first shape
    timed: kernel, plain version, bound and SDPA."""
    import torch

    results = {"shapes": {}}
    for b, t, h, d, dtype, causal in WIDE_SHAPES + (WIDE_PAD_SHAPE,):
        shape = f"B={b} T={t} H={h} D={d} {dtype} {'causal' if causal else 'full'}"
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev)
                       .to(getattr(torch, dtype)) for _ in range(4))
        fa.reset_launch_counts()
        errs, (out_p, lse_p), delta = check_attention(fa, q, k, v, do, causal, shape)
        if any(fa.launch_counts()[name] != 1 for name in fa.KERNELS):
            fail(f"{shape}: one check launched {fa.launch_counts()}")
        results["shapes"][shape] = errs
        log(f"kernels K4-K6 at {shape}: within tolerance, max abs errors {errs} [{card}]")
        if (b, t, h, d, dtype, causal) == WIDE_SHAPES[0]:
            flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
            results["timed"] = attention_times(fa, q, k, v, do, causal, lse_p, delta, shape,
                                               errs, card, flush)
            del flush
        del q, k, v, do, out_p, lse_p, delta
    torch.cuda.empty_cache()
    return results


def wide_lm_phase(card: str, seed: int):
    """Phase 49: K4-K6's DP=256 builds held to their plain versions
    (WIDE_SHAPES, the pad at WIDE_PAD_SHAPE), then the LM at WIDE_LM
    trained by DataParallelTrainer: WIDE_WARMUP + WIDE_STEPS steps of
    WIDE_BATCH (step ms, tokens/s, peak memory, a falling loss, K4-K6 4
    times a step and their in-step ms), and phase 12's gate at
    WIDE_PATH_BATCH."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    t_phase = time.perf_counter()
    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 49)
    result = wide_attention_checks(fa, gen, dev, card)

    cfg, batch = WIDE_LM, WIDE_BATCH
    zoo = resolve(LM_DEF)
    tokens, nxt = synthetic_lm_arrays(batch * WIDE_BATCHES, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    batches = [(tokens[i * batch:(i + 1) * batch], nxt[i * batch:(i + 1) * batch], ones)
               for i in range(WIDE_BATCHES)]
    params = dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                  num_layers=cfg["num_layers"], max_len=cfg["seq_len"])
    model = build_model(LM_DEF, params)  # the default device: the card
    trainer = DataParallelTrainer(model, zoo.loss, zoo.optimizer(WIDE_LR), seed=seed)
    if trainer.device != dev:
        fail(f"DataParallelTrainer's default device is {trainer.device}, not {dev}")
    trainer.ensure_initialized()
    head_dim = model.block_0.attn.qkv.kernel.shape[-1]
    if head_dim != 256:
        fail(f"the phase 49 LM has head_dim {head_dim}, not 256")
    staged = [trainer.stage_batch(*b) for b in batches]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params.values())
    losses = [trainer.train_step_staged(staged[i % WIDE_BATCHES]) for i in range(WIDE_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    for i in range(WIDE_WARMUP, WIDE_WARMUP + WIDE_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step_staged(staged[i % WIDE_BATCHES]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg["num_layers"] * WIDE_STEPS
    for name in fa.KERNELS:
        if counts[name] != want:
            fail(f"{name} launched {counts[name]} times in {WIDE_STEPS} steps of the head_dim-256 "
                 f"LM (want {want})")
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.all(np.isfinite(losses)):
        fail(f"non-finite loss in the head_dim-256 LM: {losses}")
    first, last = float(losses[:2].mean()), float(losses[-2:].mean())
    parts = lm_time_parts(trainer, staged[0])
    train = {
        "params": n_params, "head_dim": head_dim, "batch": batch, "seq_len": cfg["seq_len"],
        "tokens_per_s": WIDE_STEPS * batch * cfg["seq_len"] / wall,
        "step_ms_median": step_ms[len(step_ms) // 2], "step_ms": step_ms,
        "losses": [float(x) for x in losses], "peak_memory_gb": peak / 1e9,
        "launches_steps": counts,
        "launches_per_step": {name: counts[name] / WIDE_STEPS for name in fa.KERNELS},
        "breakdown_ms": parts,
    }
    log(f"head_dim-256 LM ({n_params} parameters, d_model {cfg['d_model']}, {cfg['num_heads']} "
        f"heads of {head_dim}): {WIDE_STEPS} steps of {batch}x{cfg['seq_len']}: "
        f"{train['tokens_per_s']!r} tokens/s, step median {train['step_ms_median']!r} ms "
        f"(device, CUDA events); losses {train['losses']}; launches {counts}; peak "
        f"{peak / 1e9!r} GB [{card}]")
    if not last < first:
        fail(f"the head_dim-256 LM's loss did not fall: first 2 steps {first!r}, last 2 {last!r}")
    log("head_dim-256 LM step's attention kernels (device ms in one step, CUDA events): "
        + ", ".join(f"{name} {ms!r}" for name, ms in parts["kernel_ms"].items())
        + f"; {parts['attention_kernels']!r} of {parts['step']!r} [{card}]")
    del staged
    torch.cuda.empty_cache()

    cut = WIDE_PATH_BATCH
    small = [trainer.stage_batch(t[:cut], n[:cut], m[:cut]) for t, n, m in batches[:3]]
    tol = (LM_PATH_LOSS_RTOL, LM_PATH_GRAD_RTOL, 2 * WIDE_LR * 3 * 1.5, LM_PATH_UPDATE_RTOL)
    train["path"] = lm_compare((trainer, contextlib.nullcontext), (trainer, plain_attention),
                               small, card,
                               f"head_dim-256 LM kernel path vs plain path (batch {cut})", tol)
    del trainer, small, model
    torch.cuda.empty_cache()
    result["lm"] = train
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 49 in {result['seconds']:.1f} s [{card}]")
    result["card"] = card
    return result


# ----------------------------------------------------------------------
# phase 50: K7-K9's DP=256 builds, driven by the context-parallel LM at
# head_dim 256
# ----------------------------------------------------------------------

#: The CP LM at WIDE_LM's widths (hidden 2048, 8 heads of 256) and T=8192
#: over the in-process (1, 4) mesh: T_local 2048, batch 2, 16,384 tokens a
#: step (phase 49's).
CP_WIDE_LM = dict(WIDE_LM, seq_len=8192)
CP_WIDE_BATCH = 2
#: One slot's ring step on that path (B, T_local, H, D), bf16.
CP_WIDE_SLOT_SHAPE = (CP_WIDE_BATCH, CP_WIDE_LM["seq_len"] // CP_MESH[1],
                      CP_WIDE_LM["num_heads"], CP_WIDE_LM["d_model"] // CP_WIDE_LM["num_heads"])
#: Phase 16's gate at batch 1 (the one-card side: K4-K6's DP=256 builds
#: on the whole sequence): CP_BF16_TOL's losses, gradients and updates,
#: and every parameter within phase 16's 2·lr·3·1.5 at WIDE_LR.
CP_WIDE_TOL = (CP_BF16_TOL[0], CP_BF16_TOL[1], 2 * WIDE_LR * 3 * 1.5, CP_BF16_TOL[3])
#: The build of each of K7-K9 on this path (bf16, head_dim 256; K8 and K9
#: with the path's bf16 dO).
RING_WIDE_BUILDS = {
    "flash_ring_step_carry": "ring_fwd_mma_kernel<bf16, 256>",
    "flash_ring_step_dq": "ring_dq_mma_kernel<bf16, 256, 1>",
    "flash_ring_step_dkv": "ring_dkv_mma_pair_kernel<bf16, 256, 1>",
}


def library_or_reason(fn):
    """``(ms, None)`` from ``fn``, or ``(None, reason)`` where no PyTorch
    backend takes the shape."""
    try:
        return fn(), None
    except RuntimeError as exc:
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0]}"


def cp_wide_kernel_checks(fa, ring, gen, dev, card):
    """K7-K9 at CP_WIDE_SLOT_SHAPE, bf16: every step of every slot of a
    ring of CP_MESH[1], both layouts, K8 and K9 on an f32 and the path's
    bf16 dO, against the plain versions (RING_CARRY_TOL, ATTN_F32_*);
    then timed at the unmasked step beside their bounds and the
    memory-efficient attention call."""
    import torch

    b, t, h, d = CP_WIDE_SLOT_SHAPE
    scale = fa.default_scale(d)
    shape = f"B={b} Tq=Tk={t} H={h} D={d} bf16"
    q, k, v, do = ring_step_inputs(gen, dev, b, t, t, h, d, torch.bfloat16)
    errs = check_ring_layouts(fa, ring, q, k, v, do, CP_MESH[1], scale, shape)
    log(f"kernels K7-K9 (DP=256 builds) at {shape}, every step of a ring of {CP_MESH[1]}, "
        f"contiguous and zigzag (causal), dO f32 and bf16: within tolerance, max abs errors "
        f"{errs} [{card}]")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    q_pos, k_pos = unmasked_step_positions(ring, dev, t, CP_MESH[1])
    do_bf16 = do.to(torch.bfloat16)
    times = ring_step_times(fa, q, k, v, do_bf16, q_pos, k_pos, scale, flush)
    f32_dout = ring_step_times(fa, q, k, v, do, q_pos, k_pos, scale, flush, fa.RING_KERNELS[1:])
    lib, reason = library_or_reason(
        lambda: efficient_attention_ms(q, k, v, do_bf16, q_pos, k_pos, flush))
    pairs = unmasked_pairs(q_pos, k_pos, True)
    bounds = ring_bound_ms(b, h, t, t, d, pairs, 2, 2)
    f32_bounds = ring_bound_ms(b, h, t, t, d, pairs, 2, 4)
    ops = ring_step_ops(b, h, d, pairs)
    timed = f"{shape}, unmasked step (contiguous, shard 1 vs shard 0's block)"
    out = {}
    for name in fa.RING_KERNELS:
        ms, plain = times[name]
        out[name] = {
            "max_abs_err": errs[name], "shape": timed + (
                ", dO bf16 (the path's)" if name != "flash_ring_step_carry" else ""),
            "ms": ms, "plain_ms": plain, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "tflop_per_s": ops[name] / ms * 1e-9,
            "library_ms": None if lib is None else lib[name != "flash_ring_step_carry"],
            "library_reason": reason}
        log(f"kernel {name} (DP=256): {out[name]['shape']}: {ms!r} ms, "
            f"{out[name]['tflop_per_s']!r} TFLOP/s (plain {plain!r} ms, bound "
            f"{bounds[name][0]!r} ms by {bounds[name][1]}) [{card}]")
        if name != "flash_ring_step_carry":
            ms32, plain32 = f32_dout[name]
            out[name]["f32_dout"] = {
                "ms": ms32, "plain_ms": plain32, "bound_ms": f32_bounds[name][0],
                "bound_by": f32_bounds[name][1], "tflop_per_s": ops[name] / ms32 * 1e-9}
            log(f"kernel {name} (DP=256): {timed}, dO f32: {ms32!r} ms (plain {plain32!r} ms, "
                f"bound {f32_bounds[name][0]!r} ms by {f32_bounds[name][1]}) [{card}]")
    log(f"  efficient-attention yardstick at the head_dim-256 CP slot: "
        + (f"forward {lib[0]!r} ms, backward (dq, dk, dv) {lib[1]!r} ms" if lib is not None
           else f"no backend takes the shape ({reason})") + f" [{card}]")
    del q, k, v, do, do_bf16, flush
    torch.cuda.empty_cache()
    return out


def cp_wide_lm_phase(card: str, seed: int):
    """Phase 50: K7-K9's DP=256 builds held to their plain versions and
    timed at the CP LM's slot shape (cp_wide_kernel_checks); then the LM
    at CP_WIDE_LM trained context-parallel over an in-process (1, 4) mesh
    in both layouts (WIDE_WARMUP + WIDE_STEPS steps of CP_WIDE_BATCH: each
    ring kernel num_layers x 4 x 4 times a step, no whole-sequence kernel,
    a falling loss); and, from one state, 3 CP steps (contiguous) against
    the one-card LM (K4-K6's DP=256 builds on T=8192) at batch 1 and
    CP_GATE_LAYERS layers, with the plain versions on both sides as the
    witness (CP_WIDE_TOL)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel import ring_attention as ring
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model, resolve

    t_phase = time.perf_counter()
    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 50)
    result = {"kernels": cp_wide_kernel_checks(fa, ring, gen, dev, card)}

    cfg, batch, (data, slots) = CP_WIDE_LM, CP_WIDE_BATCH, CP_MESH
    zoo = resolve(LM_DEF)
    tokens, nxt = synthetic_lm_arrays(batch * WIDE_BATCHES, cfg["seq_len"], cfg["vocab"], seed)
    ones = np.ones((batch,), np.float32)
    batches = [(tokens[i * batch:(i + 1) * batch], nxt[i * batch:(i + 1) * batch], ones)
               for i in range(WIDE_BATCHES)]
    params = dict(vocab=cfg["vocab"], d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                  num_layers=cfg["num_layers"], max_len=cfg["seq_len"])
    mesh = in_process_mesh(data, slots)
    per_step = cfg["num_layers"] * slots * slots
    for layout in ring.LAYOUTS:
        model = build_model(LM_DEF, dict(params, mesh=mesh, cp_layout=layout))
        trainer = DataParallelTrainer(model, zoo.loss, zoo.optimizer(WIDE_LR), mesh=mesh,
                                      seed=seed)
        if trainer.device != dev:
            fail(f"the head_dim-256 CP trainer runs on {trainer.device}, not on the card")
        trainer.ensure_initialized()
        head_dim = model.block_0.attn.qkv.kernel.shape[-1]
        if head_dim != 256:
            fail(f"the phase 50 LM has head_dim {head_dim}, not 256")
        staged = [trainer.stage_batch(*b) for b in batches]
        losses = [trainer.train_step_staged(staged[i % WIDE_BATCHES]) for i in range(WIDE_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        events = []
        t0 = time.perf_counter()
        for i in range(WIDE_WARMUP, WIDE_WARMUP + WIDE_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(trainer.train_step_staged(staged[i % WIDE_BATCHES]))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for name in fa.RING_KERNELS:
            if counts[name] != per_step * WIDE_STEPS:
                fail(f"{name} launched {counts[name]} times in {WIDE_STEPS} steps of the "
                     f"head_dim-256 CP LM ({layout}; want {per_step * WIDE_STEPS})")
        if any(counts[name] for name in fa.KERNELS):
            fail(f"the head_dim-256 CP path ({layout}) launched a whole-sequence kernel: "
                 f"{counts}")
        losses = torch.stack(losses).float().cpu().numpy()
        if not np.all(np.isfinite(losses)):
            fail(f"non-finite head_dim-256 CP LM loss ({layout}): {losses}")
        first, last = float(losses[:2].mean()), float(losses[-2:].mean())
        if not last < first:
            fail(f"the head_dim-256 CP LM loss did not fall ({layout}): first 2 steps {first!r}, "
                 f"last 2 {last!r}")
        step_ms = sorted(s.elapsed_time(e) for s, e in events)
        parts = lm_time_parts(trainer, staged[0], fa.RING_KERNELS)
        result[layout] = {
            "tokens_per_s": WIDE_STEPS * batch * cfg["seq_len"] / wall,
            "step_ms_median": step_ms[len(step_ms) // 2], "step_ms": step_ms,
            "losses": [float(x) for x in losses], "peak_memory_gb": peak / 1e9,
            "launches": counts, "launches_per_step": per_step, "breakdown_ms": parts,
        }
        log(f"head_dim-256 CP LM train ({layout}, mesh {data}x{slots} in-process): {WIDE_STEPS} "
            f"steps of {batch}x{cfg['seq_len']}: {result[layout]['tokens_per_s']!r} tokens/s, "
            f"step median {result[layout]['step_ms_median']!r} ms (device, CUDA events); losses "
            f"{result[layout]['losses']}; launches {counts}; peak {peak / 1e9!r} GB [{card}]")
        log(f"head_dim-256 CP LM step's ring kernels ({layout}; device ms in one step, CUDA "
            f"events): " + ", ".join(f"{name} {ms!r}" for name, ms in parts["kernel_ms"].items())
            + f"; {parts['attention_kernels']!r} of {parts['step']!r} [{card}]")
        if layout != "contiguous":
            del trainer, model, staged
            torch.cuda.empty_cache()
            continue

        # From one state: 3 CP steps against the one-card LM at batch 1
        # and CP_GATE_LAYERS layers, kernels on both sides, then the plain
        # versions.
        del trainer, model, staged
        torch.cuda.empty_cache()
        gate_params = dict(params, num_layers=CP_GATE_LAYERS)
        trainer = DataParallelTrainer(
            build_model(LM_DEF, dict(gate_params, mesh=mesh, cp_layout=layout)), zoo.loss,
            zoo.optimizer(WIDE_LR), mesh=mesh, seed=seed)
        one_card = DataParallelTrainer(build_model(LM_DEF, gate_params, device=dev), zoo.loss,
                                       zoo.optimizer(WIDE_LR), seed=seed, device=dev)
        trainer.ensure_initialized()
        one_card.ensure_initialized()
        one = [trainer.stage_batch(t[:1], n[:1], m[:1]) for t, n, m in batches[:3]]
        depth = f"{CP_GATE_LAYERS} of {cfg['num_layers']} layers"
        what = (f"head_dim-256 CP LM ({layout}, bf16, ring K7-K9) vs one-card LM (bf16, K4-K6 "
                f"on T={cfg['seq_len']}), batch 1, {depth}")
        result["vs_one_card"] = lm_compare(
            (trainer, contextlib.nullcontext), (one_card, contextlib.nullcontext), one, card,
            what, CP_WIDE_TOL)
        result["vs_one_card_plain"] = lm_compare(
            (trainer, plain_ring), (one_card, plain_attention), one, card,
            f"the witness: plain head_dim-256 CP LM ({layout}, the plain versions of K7-K9) vs "
            f"plain one-card LM (the plain versions of K4-K6), batch 1, {depth}", CP_WIDE_TOL)
        del trainer, one_card, one
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 50 in {result['seconds']:.1f} s [{card}]")
    result["card"] = card
    return result


# ----------------------------------------------------------------------
# phase 51: K4-K6's float16 builds, driven by the LM built at float16
# ----------------------------------------------------------------------

#: Kernel against plain version, float16 outputs: phase 10's rule in f16
#: ulps.  Both compute the same f32 values in another summation order, so
#: a value near a rounding boundary lands on either f16 neighbour: within
#: 2 f16 ulps (rtol 2**-10; below f16's normal range, whose ulp is the
#: subnormal step 2**-24, 2 steps: F16_ULP_FLOOR) plus ATTN_F16_ATOL_SHARE
#: of the tensor's largest magnitude (terms of both signs, rounded in f32
#: relative to the terms; P rounded to f16 an f32 ulp apart, as bf16's
#: 2**-10 share covers for bf16 P, at 8 times f16's finer step).
ATTN_F16_RTOL, ATTN_F16_ATOL_SHARE, F16_ULP_FLOOR = 2.0 ** -10, 2.0 ** -12, 2.0 ** -23
#: dO's scales in phase 51's checks: unit, and 2**-20 (~9.5e-7), the
#: LM's attention gradients at batch 16 x 2048 (the loss is a mean over
#: 32,768 tokens: a median |dO| near 1e-6, mostly subnormal in f16).
F16_DO_SCALES = (1.0, 2.0 ** -20)
#: Checked (B, T, H, D, causal): the three builds (DP 64, 128, 256) and
#: head_dim 100 through the pad to 104, causal and full, at each scale.
F16_CHECK_SHAPES = tuple((2, 512, 4, d, causal) for d in (64, 128, 256, 100)
                         for causal in (True, False))
#: Timed (B, T, H, D, causal): phase 10's main shape and phase 49's.
F16_TIMED_SHAPES = ((16, 2048, 8, 64, True), (8, 2048, 8, 256, True))
#: The float16 LM: TRANSFORMER_BENCH's widths at phase 11's batch and
#: AdamW, reached as a user reaches JAX's TransformerLM(dtype=float16):
#: from their own model module (F16_ZOO_SOURCE), loaded by
#: ``common/model_utils.load_module``.
F16_WARMUP, F16_STEPS, F16_BATCHES = 2, 5, 4
#: Phase 12's gate (kernel path against plain path) at this batch.
F16_PATH_BATCH = 2
#: The f16 network carries its activation gradients in f16, whose
#: subnormal step (6e-8) is a large part of a gradient at this LM's scale
#: (~1e-5 at the gate's 4,096 tokens): where the two paths' K4-K6 outputs
#: round to neighbouring f16 values (phase 51's kernel rule), every later
#: f16 rounding of a gradient a few steps wide can land one step apart,
#: a relative change of a third to a half of that element.  On an H100
#: (700 W) the paths' gradients read 4.1e-2 (relative L2, Embed_0) and
#: the updates 2.2e-2 after 3 steps, past phase 12's bf16 limits (1e-2,
#: 2e-2); losses 3.1e-6, parameters within 7.2e-3.  Held to (losses,
#: gradients, every parameter, updates): phase 12's loss and parameter
#: limits, and twice the readings, rounded up, for gradients and updates.
#: The witness of the cause (F16_WITNESS_SCALE): the same two paths'
#: gradients from one state with the loss scaled by 2**12, which lifts
#: the gradients into f16's normal range, held to phase 12's 1e-2 (read
#: 4.7e-4 on that H100).
F16_PATH_TOL = (LM_PATH_LOSS_RTOL, 1e-1, LM_PATH_PARAM_MAX, 5e-2)
F16_WITNESS_SCALE = 2.0 ** 12
F16_ZOO, F16_MODEL_DEF = "f16_lm_zoo", "transformer_lm_f16"
F16_ZOO_SOURCE = '''"""The repo's transformer LM computing in float16, its parameters f32
(as flax keeps them): what JAX's ``TransformerLM(dtype=jnp.float16)`` is
in a user's own module, since the zoo's ``custom_model`` offers bf16 or
f32 only.  Over a mesh (``mesh``, ``cp_layout``) its sequence is sharded
over the mesh's model axis and attended by the ring, as JAX's
``TransformerLM(dtype=jnp.float16, mesh=..., cp_layout=...)``; it is
built on the mesh's device."""

import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.zoo.transformer_lm import TransformerLM, loss, optimizer  # noqa: F401


def custom_model(vocab=256, d_model=128, num_heads=4, num_layers=2, max_len=4096,
                 mesh=None, cp_layout="contiguous", device=None):
    return TransformerLM(vocab=vocab, d_model=d_model, num_heads=num_heads,
                         num_layers=num_layers, max_len=max_len, dtype=torch.float16,
                         device=mesh.device if mesh is not None else resolve_device(device),
                         mesh=mesh, cp_layout=cp_layout)
'''
#: The build of each of K4-K6 on the float16 LM's path (head_dim 64), and
#: at phase 49's head_dim 256.
FLASH_F16_BUILDS = {
    "flash_attention_fwd": ("flash_fwd_mma_kernel<f16, 64>", "flash_fwd_mma_kernel<f16, 256>"),
    "flash_attention_dq": ("flash_dq_mma_kernel<f16, 64>", "flash_dq_mma_kernel<f16, 256>"),
    "flash_attention_dkv": ("flash_dkv_mma_kernel<f16, 64>",
                            "flash_dkv_mma_pair_kernel<f16, 256>"),
}


def write_f16_zoo(directory: str) -> str:
    """A user's model zoo holding F16_ZOO_SOURCE as F16_MODEL_DEF, under
    ``directory``; returns the zoo's path (``--model_zoo``)."""
    zoo_dir = os.path.join(directory, F16_ZOO)
    os.makedirs(zoo_dir, exist_ok=True)
    with open(os.path.join(zoo_dir, "__init__.py"), "w"):
        pass
    with open(os.path.join(zoo_dir, F16_MODEL_DEF + ".py"), "w") as f:
        f.write(F16_ZOO_SOURCE)
    return zoo_dir


def f16_zero_flushes(got, want) -> int:
    """Entries where the kernel's value is zero and the plain version's
    is not, counted where the plain value is at least F16_ULP_FLOOR (two
    subnormal steps: one step may round to zero from the other side of
    half a step) and ATTN_F16_ATOL_SHARE of the tensor's largest (below
    that an entry is the f32 rounding noise of a sum whose exact value is
    0, such as dS of a causal row that sees one key): an f16 path that
    flushes small gradients fails here."""
    want = want.float().abs()
    floor = max(F16_ULP_FLOOR, ATTN_F16_ATOL_SHARE * float(want.max()))
    return int(((want >= floor) & (got == 0)).sum())


def f16_attention_checks(fa, gen, dev, card):
    """K4-K6's f16 builds against their plain versions at
    F16_CHECK_SHAPES, with dO at each of F16_DO_SCALES: the f16 rule
    (ATTN_F16_*, LSE_ATOL) and no gradient flushed to zero where the
    plain version's is not (f16_zero_flushes); each check launches each
    kernel once.  -> {shape: max abs errors}."""
    import torch

    results = {}
    for b, t, h, d, causal in F16_CHECK_SHAPES:
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev) for _ in range(4))
        q, k, v = (x.to(torch.float16) for x in (q, k, v))
        for do_scale in F16_DO_SCALES:
            shape = (f"B={b} T={t} H={h} D={d} float16 {'causal' if causal else 'full'}, dO x "
                     f"{do_scale!r}")
            fa.reset_launch_counts()
            errs, _, _ = check_attention(fa, q, k, v, (do * do_scale).to(torch.float16),
                                         causal, shape)
            if any(fa.launch_counts()[name] != 1 for name in fa.KERNELS):
                fail(f"{shape}: one check launched {fa.launch_counts()}")
            results[shape] = errs
        del q, k, v, do
    worst = {name: max(e[name] for e in results.values()) for name in fa.KERNELS}
    log(f"kernels K4-K6 (f16 builds) at {len(F16_CHECK_SHAPES)} shapes x dO scales "
        f"{F16_DO_SCALES}: within tolerance, no gradient flushed to zero; max abs errors "
        f"{worst} [{card}]")
    return results


def f16_scaled_witness(trainer, staged, card, plain=None, what="float16 LM"):
    """The kernel path's and the plain path's (``plain``: the context that
    puts the plain versions in, default plain_attention) gradients from
    the trainer's state with the loss times F16_WITNESS_SCALE (the
    gradients in f16's normal range), held to phase 12's
    LM_PATH_GRAD_RTOL: what phase 51's and 52's gates allow beyond that
    is f16's subnormal rounding.  The port has no loss scaling; this
    multiplies the loss here only.  -> {parameter: relative L2}."""
    grads = []
    for context in (contextlib.nullcontext, plain or plain_attention):
        with context():
            grads.append(trainer.backward(trainer.forward(*staged) * F16_WITNESS_SCALE))
    rel = {name: rel_l2(grads[0][name], g) for name, g in grads[1].items()}
    worst = max(rel, key=rel.get)
    what = (f"{what} kernel path vs plain path, gradients of the loss x "
            f"{F16_WITNESS_SCALE!r} (the witness): max rel L2 {rel[worst]!r} ({worst})")
    if not rel[worst] <= LM_PATH_GRAD_RTOL:
        fail(what)
    log(f"{what} [{card}]")
    return rel


def f16_lm_phase(card: str, seed: int, workdir: str):
    """Phase 51: K4-K6's float16 builds held to their plain versions
    (f16_attention_checks) and timed at F16_TIMED_SHAPES beside their
    bounds and SDPA at float16; then the float16 LM at
    TRANSFORMER_BENCH's widths, built from a user's module
    (F16_ZOO_SOURCE, loaded by
    ``load_module``) and trained by DataParallelTrainer: F16_WARMUP +
    F16_STEPS steps of LM_BATCH (step ms, tokens/s, peak memory, K4-K6 4
    times a step and their in-step ms, a falling loss), and phase 12's
    gate at F16_PATH_BATCH and F16_PATH_TOL with its witness
    (f16_scaled_witness)."""
    import torch

    from elasticdl_tpu_torch.common.model_utils import load_module
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model

    t_phase = time.perf_counter()
    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 51)
    result = {"shapes": f16_attention_checks(fa, gen, dev, card), "timed": []}
    seconds = {"checks": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    for b, t, h, d, causal in F16_TIMED_SHAPES:
        shape = f"B={b} T={t} H={h} D={d} float16 {'causal' if causal else 'full'}"
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.float16)
                       for _ in range(4))
        errs, (_, lse_p), delta = check_attention(fa, q, k, v, do, causal, shape)
        result["timed"].append(attention_times(fa, q, k, v, do, causal, lse_p, delta, shape,
                                               errs, card, flush))
        del q, k, v, do, lse_p, delta
    del flush
    torch.cuda.empty_cache()
    seconds["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cfg, batch = LM_BENCH, LM_BATCH
    zoo_dir = write_f16_zoo(workdir)
    module = load_module(zoo_dir, F16_MODEL_DEF)
    model = build_model(F16_MODEL_DEF, lm_params(cfg), model_zoo=zoo_dir)  # on the card
    dtypes = {p.dtype for p in model.parameters()}
    if model.Embed_0.compute_dtype != torch.float16 or dtypes != {torch.float32}:
        fail(f"the user module's LM computes in {model.Embed_0.compute_dtype} with parameters "
             f"{dtypes}, not float16 with float32")
    trainer = DataParallelTrainer(model, module.loss, module.optimizer(LM_LR), seed=seed)
    if trainer.device != dev:
        fail(f"DataParallelTrainer's default device is {trainer.device}, not {dev}")
    trainer.ensure_initialized()
    batches = lm_batches(seed, F16_BATCHES, batch, cfg)
    staged = [trainer.stage_batch(*x) for x in batches]
    losses, step_ms, wall, peak = timed_steps(trainer, staged, F16_WARMUP, F16_STEPS)
    counts = fa.launch_counts()
    want = cfg["num_layers"] * F16_STEPS
    for name in fa.KERNELS:
        if counts[name] != want:
            fail(f"{name} launched {counts[name]} times in {F16_STEPS} steps of the float16 LM "
                 f"(want {want})")
    first, last = loss_falls("the float16 LM", losses)
    parts = lm_time_parts(trainer, staged[0])
    train = {
        "model_def": f"{F16_ZOO}.{F16_MODEL_DEF}", "batch": batch, "seq_len": cfg["seq_len"],
        "tokens_per_s": F16_STEPS * batch * cfg["seq_len"] / wall,
        "step_ms_median": step_ms[len(step_ms) // 2], "step_ms": step_ms,
        "losses": losses, "peak_memory_gb": peak / 1e9, "launches_steps": counts,
        "launches_per_step": {name: counts[name] / F16_STEPS for name in fa.KERNELS},
        "breakdown_ms": parts,
    }
    log(f"float16 LM ({F16_ZOO}.{F16_MODEL_DEF} by load_module): {F16_STEPS} steps of "
        f"{batch}x{cfg['seq_len']}: {train['tokens_per_s']!r} tokens/s, step median "
        f"{train['step_ms_median']!r} ms (device, CUDA events); loss {first!r} -> {last!r} "
        f"({losses}); launches {counts}; peak {peak / 1e9!r} GB [{card}]")
    log("float16 LM step's attention kernels (device ms in one step, CUDA events): "
        + ", ".join(f"{name} {ms!r}" for name, ms in parts["kernel_ms"].items())
        + f"; {parts['attention_kernels']!r} of {parts['step']!r} [{card}]")
    del staged
    torch.cuda.empty_cache()
    seconds["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cut = F16_PATH_BATCH
    small = [trainer.stage_batch(t[:cut], n[:cut], m[:cut]) for t, n, m in batches[:3]]
    train["scaled_witness"] = f16_scaled_witness(trainer, small[0], card)
    train["path"] = lm_compare((trainer, contextlib.nullcontext), (trainer, plain_attention),
                               small, card, f"float16 LM kernel path vs plain path (batch {cut})",
                               F16_PATH_TOL)
    del trainer, small, model
    torch.cuda.empty_cache()
    result["lm"] = train
    seconds["gate"] = time.perf_counter() - t0
    result["seconds"] = time.perf_counter() - t_phase
    result["seconds_by_part"] = seconds
    log(f"phase 51 in {result['seconds']:.1f} s ({seconds}) [{card}]")
    result["card"] = card
    return result


# ----------------------------------------------------------------------
# phase 52: K7-K9's float16 builds, driven by the CP LM computing in
# float16
# ----------------------------------------------------------------------

#: The f16 builds of K7-K9: ring_mma.cuh's templates, instantiated here.
RING_F16_SOURCE = "elasticdl_tpu_torch/ops/csrc/ring_attention_f16.cu"
#: The build of each of K7-K9 on the float16 CP LM's path (head_dim 64;
#: K8 and K9 on the path's f16 dO, one part), and at head_dim 256.
RING_F16_BUILDS = {
    "flash_ring_step_carry": ("ring_fwd_mma_kernel<f16, 64>", "ring_fwd_mma_kernel<f16, 256>"),
    "flash_ring_step_dq": ("ring_dq_mma_kernel<f16, 64, 1>", "ring_dq_mma_kernel<f16, 256, 1>"),
    "flash_ring_step_dkv": ("ring_dkv_mma_kernel<f16, 64, 1>",
                            "ring_dkv_mma_pair_kernel<f16, 256, 1>"),
}
#: Checked (B, T_local, H, D): one slot's ring of CP_MESH[1] steps for the
#: three builds (DP 64, 128, 256) and head_dim 100 through the pad to
#: 104, at each of F16_DO_SCALES.
F16_RING_CHECK_SHAPES = tuple((2, 128, 4, d) for d in (64, 128, 256, 100))
#: Timed: one unmasked step at the CP LM's slot shape and at phase 50's.
F16_RING_TIMED_SHAPES = (CP_SLOT_SHAPE, CP_WIDE_SLOT_SHAPE)


def f16_ring_checks(fa, ring, gen, dev, card):
    """K7-K9's f16 builds against their plain versions: at each of
    F16_RING_CHECK_SHAPES and F16_DO_SCALES every step of every slot of a
    ring of CP_MESH[1], contiguous and zigzag (a fully masked step among
    them), K8 and K9 on an f32 and on the path's f16 dO
    (check_ring_layouts: the f16 rule, no gradient flushed to zero, the
    masked step's carry bit for bit); then the 80 rows that see no key of
    ring_edges at each scale.  Every call launches its kernel: the counts
    must show each.  -> {shape: max abs errors}."""
    import torch

    n = CP_MESH[1]
    results, launched = {}, dict.fromkeys(fa.RING_KERNELS, 0)
    fa.reset_launch_counts()
    for b, t, h, d in F16_RING_CHECK_SHAPES:
        q, k, v, do = ring_step_inputs(gen, dev, b, t, t, h, d, torch.float16)
        for do_scale in F16_DO_SCALES:
            shape = f"B={b} Tq=Tk={t} H={h} D={d} float16, dO x {do_scale!r}"
            results[shape] = check_ring_layouts(fa, ring, q, k, v, do * do_scale, n,
                                                fa.default_scale(d), shape)
            steps = len(ring.LAYOUTS) * n * n
            launched = {name: launched[name] + steps * (1 if name == "flash_ring_step_carry"
                                                        else 2)
                        for name in launched}
        del q, k, v, do
    q, k, v, do = ring_step_inputs(gen, dev, 1, 130, 64, 2, 64, torch.float16)
    q_pos = torch.arange(130, device=dev, dtype=torch.int32)
    k_steps = [40 + torch.randperm(64, generator=gen, device=dev).to(torch.int32),
               200 + torch.arange(64, device=dev, dtype=torch.int32)]
    for do_scale in F16_DO_SCALES:
        shape = f"rows that see no key, float16, dO x {do_scale!r}"
        results[shape] = check_ring_ring(fa, q, k, v, do * do_scale, (q_pos, k_steps), True,
                                         fa.default_scale(64), shape)
        if results[shape]["unseen_rows"] != 2 * 40:
            fail(f"{shape}: {results[shape]['unseen_rows']} unseen rows, not 80")
        launched = {name: launched[name] + (2 if name == "flash_ring_step_carry" else 4)
                    for name in launched}
    counts = fa.launch_counts()
    if any(counts[name] != launched[name] for name in fa.RING_KERNELS):
        fail(f"the f16 ring checks launched {counts}, want {launched}: a call did not reach "
             f"its kernel")
    worst = {name: max(e[name] for e in results.values()) for name in fa.RING_KERNELS}
    log(f"kernels K7-K9 (f16 builds) at {len(F16_RING_CHECK_SHAPES)} shapes x dO scales "
        f"{F16_DO_SCALES}, every step of a ring of {n} in both layouts, dO f32 and f16, and "
        f"80 rows that see no key: within tolerance, no gradient flushed to zero; launches "
        f"{counts}; max abs errors {worst} [{card}]")
    return results


def f16_ring_timing(fa, ring, gen, dev, card):
    """K7-K9's f16 builds at F16_RING_TIMED_SHAPES: the unmasked step
    (shard 1 against shard 0's block, contiguous) checked against the
    plain versions as in f16_ring_checks, then timed beside the plain
    versions, the bounds and the memory-efficient attention call at
    float16 (K8 and K9 on the path's f16 dO).  -> [{"shape", "kernels":
    {name: numbers}}]."""
    import torch

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = []
    for b, t, h, d in F16_RING_TIMED_SHAPES:
        scale = fa.default_scale(d)
        q, k, v, do = ring_step_inputs(gen, dev, b, t, t, h, d, torch.float16)
        q_pos, k_pos = unmasked_step_positions(ring, dev, t, CP_MESH[1])
        shape = (f"B={b} Tq=Tk={t} H={h} D={d} float16, dO float16, unmasked step "
                 f"(contiguous, shard 1 vs shard 0)")
        errs = check_ring_ring(fa, q, k, v, do, (q_pos, [k_pos]), True, scale, shape)
        do_f16 = do.to(torch.float16)
        times = ring_step_times(fa, q, k, v, do_f16, q_pos, k_pos, scale, flush)
        lib, reason = library_or_reason(
            lambda: efficient_attention_ms(q, k, v, do_f16, q_pos, k_pos, flush))
        pairs = unmasked_pairs(q_pos, k_pos, True)
        bounds = ring_bound_ms(b, h, t, t, d, pairs, 2, 2)
        ops = ring_step_ops(b, h, d, pairs)
        kernels = {}
        for name, (ms, plain) in times.items():
            kernels[name] = {
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "tflop_per_s": ops[name] / ms * 1e-9,
                "library_ms": None if lib is None else lib[name != "flash_ring_step_carry"],
                "library_reason": reason}
            log(f"kernel {name} (f16): {shape}: {ms!r} ms, {kernels[name]['tflop_per_s']!r} "
                f"TFLOP/s (plain {plain!r} ms, bound {bounds[name][0]!r} ms by "
                f"{bounds[name][1]}) [{card}]")
        log(f"  efficient-attention yardstick at float16, {shape}: "
            + (f"forward {lib[0]!r} ms, backward (dq, dk, dv) {lib[1]!r} ms" if lib is not None
               else f"no backend takes the shape ({reason})") + f" [{card}]")
        out.append({"shape": shape, "kernels": kernels})
        del q, k, v, do, do_f16
    del flush
    torch.cuda.empty_cache()
    return out


def cp_f16_lm_phase(card: str, seed: int, workdir: str):
    """Phase 52: K7-K9's float16 builds held to their plain versions
    (f16_ring_checks) and timed at F16_RING_TIMED_SHAPES
    (f16_ring_timing); then phase 15's CP LM computing in float16, built
    from the user's module of phase 51 (F16_ZOO_SOURCE, ``load_module``)
    over the in-process CP_MESH, trained in both layouts (CP_WARMUP +
    CP_STEPS steps of CP_BATCH: step ms, tokens/s, peak memory, K7-K9
    each num_layers x 4 x 4 times a step and their in-step ms, no
    whole-sequence kernel, a falling loss); and, from the contiguous
    run's state, its kernel path against its plain path (the plain
    versions of K7-K9) at CP_GATE_BATCH rows and F16_PATH_TOL, beside
    the loss-scaled witness (f16_scaled_witness)."""
    import torch

    from elasticdl_tpu_torch.common.model_utils import load_module
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel import ring_attention as ring
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model

    t_phase = time.perf_counter()
    dev = card_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 52)
    result = {"shapes": f16_ring_checks(fa, ring, gen, dev, card)}
    seconds = {"checks": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    result["timed"] = f16_ring_timing(fa, ring, gen, dev, card)
    seconds["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cfg, batch, (data, slots) = CP_LM, CP_BATCH, CP_MESH
    zoo_dir = write_f16_zoo(workdir)
    module = load_module(zoo_dir, F16_MODEL_DEF)
    batches = lm_batches(seed, CP_BATCHES, batch, cfg)
    mesh = in_process_mesh(data, slots)
    per_step = cfg["num_layers"] * slots * slots
    for layout in ring.LAYOUTS:
        model = build_model(F16_MODEL_DEF, dict(lm_params(cfg), mesh=mesh, cp_layout=layout),
                            model_zoo=zoo_dir)
        dtypes = {p.dtype for p in model.parameters()}
        if model.Embed_0.compute_dtype != torch.float16 or dtypes != {torch.float32}:
            fail(f"the user module's CP LM computes in {model.Embed_0.compute_dtype} with "
                 f"parameters {dtypes}, not float16 with float32")
        trainer = DataParallelTrainer(model, module.loss, module.optimizer(LM_LR), mesh=mesh,
                                      seed=seed)
        if trainer.device != dev:
            fail(f"the float16 CP trainer runs on {trainer.device}, not on the card")
        trainer.ensure_initialized()
        staged = [trainer.stage_batch(*x) for x in batches]
        losses, step_ms, wall, peak = timed_steps(trainer, staged, CP_WARMUP, CP_STEPS)
        counts = fa.launch_counts()
        for name in fa.RING_KERNELS:
            if counts[name] != per_step * CP_STEPS:
                fail(f"{name} launched {counts[name]} times in {CP_STEPS} steps of the float16 "
                     f"CP LM ({layout}; want {per_step * CP_STEPS})")
        if any(counts[name] for name in fa.KERNELS):
            fail(f"the float16 CP path ({layout}) launched a whole-sequence kernel: {counts}")
        first, last = loss_falls(f"the float16 CP LM ({layout})", losses)
        parts = lm_time_parts(trainer, staged[0], fa.RING_KERNELS)
        result[layout] = {
            "model_def": f"{F16_ZOO}.{F16_MODEL_DEF}", "batch": batch,
            "seq_len": cfg["seq_len"], "mesh": CP_MESH,
            "tokens_per_s": CP_STEPS * batch * cfg["seq_len"] / wall,
            "step_ms_median": step_ms[len(step_ms) // 2], "step_ms": step_ms,
            "losses": losses, "peak_memory_gb": peak / 1e9, "launches": counts,
            "launches_per_step": per_step, "breakdown_ms": parts,
        }
        log(f"float16 CP LM ({F16_ZOO}.{F16_MODEL_DEF} by load_module, {layout}, mesh "
            f"{data}x{slots} in-process): {CP_STEPS} steps of {batch}x{cfg['seq_len']}: "
            f"{result[layout]['tokens_per_s']!r} tokens/s, step median "
            f"{result[layout]['step_ms_median']!r} ms (device, CUDA events); loss {first!r} -> "
            f"{last!r} ({losses}); launches {counts}; peak {peak / 1e9!r} GB [{card}]")
        log(f"float16 CP LM step's ring kernels ({layout}; device ms in one step, CUDA "
            f"events): " + ", ".join(f"{name} {ms!r}" for name, ms in parts["kernel_ms"].items())
            + f"; {parts['attention_kernels']!r} of {parts['step']!r} (forward "
            f"{parts['forward']!r}, backward {parts['backward']!r}, AdamW {parts['adamw']!r}) "
            f"[{card}]")
        del staged
        torch.cuda.empty_cache()
        if layout == "contiguous":
            # From the trained state: from the first state Adam's steps
            # are sign-like, so an f16 gradient entry that rounds to zero
            # on one path only moves its parameter by the whole learning
            # rate, and the updates part past F16_PATH_TOL.
            seconds["lm_contiguous"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cut = CP_GATE_BATCH
            small = [trainer.stage_batch(t[:cut], n[:cut], m[:cut]) for t, n, m in batches[:3]]
            what = f"float16 CP LM ({layout})"
            result["scaled_witness"] = f16_scaled_witness(trainer, small[0], card, plain_ring,
                                                          what)
            result["path"] = lm_compare(
                (trainer, contextlib.nullcontext), (trainer, plain_ring), small, card,
                f"{what} kernel path vs plain path (the plain versions of K7-K9, batch {cut})",
                F16_PATH_TOL)
            del small
            seconds["gate"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        del trainer, model
        torch.cuda.empty_cache()
    seconds["lm_zigzag"] = time.perf_counter() - t0
    result["seconds"] = time.perf_counter() - t_phase
    result["seconds_by_part"] = seconds
    log(f"phase 52 in {result['seconds']:.1f} s ({seconds}) [{card}]")
    result["card"] = card
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default="",
                        help="comma-separated phase numbers to run (default: all)")
    parser.add_argument("--fsdp_world_child", action="store_true",
                        help="phase 46's world-of-one NCCL process (started by phase 46)")
    args = parser.parse_args()
    wanted = {int(x) for x in args.phases.split(",") if x.strip()}

    def run(*numbers):
        return not wanted or bool(wanted.intersection(numbers))

    import_port()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    if args.fsdp_world_child:
        fsdp_world_child(args.seed)
        return
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    from elasticdl_tpu_torch.ops import _build

    with phase_clock(1):
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
        build_log = lib_path.with_suffix(".log").read_text()
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  ptxas: {line.strip()}")
        dumps = start_resource_dumps(str(lib_path))
    scan = start_analyzer_scan() if run(42) else None

    kernels = timed_phase((2,), kernel_phase, card, args.seed) if run(2) else None
    # Phase 1's reading of the dumps, which ran beside phase 2.
    resources = timed_phase((1,), attention_resources, dumps, build_log)
    k3 = timed_phase((5,), dedup_apply_phase, card, args.seed) if run(5) else None
    gather = timed_phase((17,), block_gather_phase, card, args.seed) if run(17) else None
    sharded = timed_phase((18,), sharded_kernel_phase, card, args.seed) if run(18) else None
    launches = train = mesh_train = split_train = ckpt = continuous = process = elastic = None
    stream_loop = traced = quality_gate = quality_process = None
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if run(3, 4):
            launches = timed_phase((3, 4), serving_phases, card, args.seed, workdir)
        if run(6, 7, 8, 9):
            train = timed_phase((6, 7, 8, 9), training_phases, card, args.seed, workdir)
        if run(19):
            mesh_train = timed_phase((19,), mesh_training_phases, card, args.seed, workdir)
        if run(20):
            split_train = timed_phase((20,), split_training_phase, card, args.seed, workdir)
        loop = None
        if run(21, 22):
            ckpt = timed_phase((21, 22), checkpoint_phases, card, args.seed, workdir,
                               split_train, keep=run(24, 25))
            if run(24, 25):
                ckpt, loop = ckpt
        if run(24, 25):
            with phase_clock(24, 25):
                loop = loop or loop_trainer(args.seed)
                continuous, exporter, full, pub = continuous_loop_phase(card, loop, workdir)
                process = replica_process_phase(card, loop, exporter, full, pub, workdir)
            if run(39):  # phase 25's artifact, under traced traffic
                traced = timed_phase((39,), traced_replica_phase, card, args.seed, workdir,
                                     full=full, held_out=loop.held_out, replica25=process)
            del exporter
            shutil.rmtree(pub, ignore_errors=True)
            torch.cuda.empty_cache()
        if run(36):  # phase 22/24's trainer where it is still here
            stream_loop = timed_phase((36,), stream_loop_phase, card, args.seed, workdir,
                                      trainer=loop.trainer if loop else None)
            shutil.rmtree(os.path.join(workdir, "pub_stream"), ignore_errors=True)
            torch.cuda.empty_cache()
        if run(40, 41):  # after phase 36, which must not see phase 40's flipped labels
            quality_gate, chain = timed_phase((40,), quality_gate_phase, card, args.seed,
                                              workdir, trainer=loop.trainer if loop else None)
            if run(41):
                quality_process = timed_phase((41,), quality_replica_phase, card, args.seed,
                                              workdir, chain, traced)
            shutil.rmtree(chain["pub"], ignore_errors=True)
            del chain
            torch.cuda.empty_cache()
        del loop
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    etrf = None
    if run(26, 27):  # in a directory of its own: the earlier phases' files are gone
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            if run(26):
                elastic = timed_phase((26,), elastic_job_phase, card, args.seed, workdir,
                                      split_train)
            if run(27):
                etrf = timed_phase((27,), etrf_job_phase, card, args.seed, workdir, elastic)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    observed = None
    if run(38, 39):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            if run(38):
                observed = timed_phase((38,), observed_job_phase, card, args.seed, workdir, etrf)
            if run(39) and traced is None:
                traced = timed_phase((39,), traced_replica_phase, card, args.seed, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    vision = timed_phase((28,), vision_training_phase, card, args.seed) if run(28) else None
    local = None
    if run(29):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            local = timed_phase((29,), local_job_phase, card, args.seed, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    engines = timed_phase((37,), engines_phase, card, args.seed) if run(37) else None
    zoo = timed_phase((30,), ctr_zoo_phase, card, args.seed) if run(30) else None
    census = fleet = fleet_policy = None
    if run(31, 32, 43):  # phases 32 and 43 serve phase 31's export
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            census = timed_phase((31,), census_job_phase, card, args.seed, workdir)
            if run(32):
                fleet = timed_phase((32,), census_fleet_phase, card, args.seed, workdir, census)
            if run(43):
                fleet_policy = timed_phase((43,), fleet_policy_phase, card, args.seed, workdir,
                                           census)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    allreduce = {}
    if run(33, 34):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            for number in (33, 34):
                if run(number):
                    allreduce[number] = timed_phase((number,), allreduce_job_phase, card,
                                                    args.seed, workdir, number, vision)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    attention, edges = (timed_phase((10,), attention_phase, card, args.seed) if run(10)
                        else (None, None))
    lm = timed_phase((11, 12), lm_training_phases, card, args.seed) if run(11, 12) else None
    lm_heads = timed_phase((35,), lm_bf16_head_phase, card, args.seed) if run(35) else None
    lm_ckpt = timed_phase((23,), lm_checkpoint_phase, card, args.seed) if run(23) else None
    ring_kernels = timed_phase((13,), ring_kernel_phase, card, args.seed) if run(13) else None
    ring_whole = timed_phase((14,), ring_whole_phase, card, args.seed) if run(14) else None
    cp = timed_phase((15, 16), cp_lm_phases, card, args.seed) if run(15, 16) else None
    tp = timed_phase((45,), tp_lm_phase, card, args.seed) if run(45) else None
    fsdp = timed_phase((46,), fsdp_lm_phase, card, args.seed) if run(46) else None
    whole_mesh = timed_phase((47,), whole_mesh_xla_phase, card, args.seed) if run(47) else None
    host_kernels = timed_phase((48,), native_kernels_phase, card, args.seed) if run(48) else None
    wide = timed_phase((49,), wide_lm_phase, card, args.seed) if run(49) else None
    cp_wide = timed_phase((50,), cp_wide_lm_phase, card, args.seed) if run(50) else None
    f16 = cp_f16 = None
    if run(51, 52):
        # One directory for the user's module of both phases: a process
        # holds one package of a name, and load_module refuses a second
        # directory for it.
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            if run(51):
                f16 = timed_phase((51,), f16_lm_phase, card, args.seed, workdir)
            if run(52):
                cp_f16 = timed_phase((52,), cp_f16_lm_phase, card, args.seed, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    analyzer = (timed_phase((42,), analyzer_census_phase, card, args.seed, scan) if run(42)
                else None)
    user_zoo = None
    if run(44):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            user_zoo = timed_phase((44,), user_zoo_phase, card, args.seed, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    if wanted:
        log(json.dumps({"phases": sorted(wanted), "attention": attention,
                        "attention_edges": edges, "lm_training": lm,
                        "ring_kernels": ring_kernels, "ring_whole": ring_whole,
                        "cp_lm_training": cp, "block_gather": gather,
                        "sharded_kernels": sharded, "mesh_training": mesh_train,
                        "split_training": split_train, "checkpoint": ckpt,
                        "lm_checkpoint": lm_ckpt, "continuous_loop": continuous,
                        "replica_process": process, "elastic_job": elastic,
                        "etrf_job": etrf, "vision_training": vision, "local_job": local,
                        "ctr_zoo": zoo, "census_job": census, "census_fleet": fleet,
                        "allreduce_jobs": allreduce, "lm_bf16_head": lm_heads,
                        "stream_loop": stream_loop, "engines": engines,
                        "observed_job": observed, "traced_replica": traced,
                        "quality_gate": quality_gate, "quality_replica": quality_process,
                        "analyzer_census": analyzer, "fleet_policy": fleet_policy,
                        "user_zoo": user_zoo, "tensor_parallel": tp, "fsdp": fsdp,
                        "whole_mesh_xla": whole_mesh, "host_kernels": host_kernels,
                        "head_dim_256": wide, "cp_head_dim_256": cp_wide, "float16": f16,
                        "cp_float16": cp_f16, "card": card}))
        log("partial run: no result line")
        return
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was never launched on the serving path")
    log(json.dumps({"training": train, "lm_training": lm, "cp_lm_training": cp,
                    "ring_whole": ring_whole, "sharded_kernels": sharded,
                    "mesh_training": mesh_train, "split_training": split_train,
                    "checkpoint": ckpt, "lm_checkpoint": lm_ckpt,
                    "continuous_loop": continuous, "replica_process": process,
                    "elastic_job": elastic, "etrf_job": etrf, "vision_training": vision,
                    "local_job": local, "ctr_zoo": zoo, "census_job": census,
                    "census_fleet": fleet, "allreduce_jobs": allreduce,
                    "lm_bf16_head": lm_heads, "stream_loop": stream_loop, "engines": engines,
                    "observed_job": observed, "traced_replica": traced,
                    "quality_gate": quality_gate, "quality_replica": quality_process,
                    "analyzer_census": analyzer, "fleet_policy": fleet_policy,
                    "user_zoo": user_zoo, "tensor_parallel": tp, "fsdp": fsdp,
                    "whole_mesh_xla": whole_mesh, "host_kernels": host_kernels,
                    "head_dim_256": wide, "cp_head_dim_256": cp_wide, "float16": f16,
                    "cp_float16": cp_f16, "card": card}))

    quality_steps = sum(n for n, _ in quality_gate["train_launches"])
    quality_trained = {name: sum(c[name] for _, c in quality_gate["train_launches"])
                       for name in ("fused_lookup", "fused_dedup_apply")}
    by_path = {
        "fused_lookup_fm": {"serve_merged": launches["fused_lookup_fm"],
                            "train_strict": train["launches_strict"]["fused_lookup_fm"],
                            "train_window": train["launches_window"]["fused_lookup_fm"],
                            "train_mesh": mesh_train["launches"]["fused_lookup_fm"],
                            "serve_mesh": mesh_train["serve"]["launches"]["fused_lookup_fm"]},
        "fused_lookup": {"serve_split": launches["fused_lookup"],
                         "serve_split_mesh": mesh_train["serve_split"]["launches"]["fused_lookup"],
                         "train_split_strict": split_train["launches_strict"]["fused_lookup"],
                         "train_split_resumed_10_steps": ckpt["launches_resumed"]["fused_lookup"],
                         "serve_after_apply_delta_1_dispatch":
                             ckpt["launches_serve_delta"]["fused_lookup"],
                         "continuous_loop_1_dispatch_per_link": [
                             c["fused_lookup"] for c in continuous["launches_clean_per_dispatch"]],
                         "continuous_loop_gate_shadow_runs":
                             continuous["launches_gate_poll"]["fused_lookup"],
                         "replica_process": process["launches"]["fused_lookup"],
                         "elastic_job_worker_process": {
                             f"worker {w} ({r['steps']} steps)": r["launches"]["fused_lookup"]
                             for w, r in elastic["per_worker"].items()},
                         "etrf_job_worker_process": {
                             f"worker {w} ({r['steps']} steps, {r['eval_batches']} evaluation "
                             "batches)": r["launches"]["fused_lookup"]
                             for w, r in etrf["per_worker"].items()},
                         **{f"ctr_zoo_{m}_{CTR_ZOO_STEPS}_steps": r["launches"]["fused_lookup"]
                            for m, r in zoo.items()},
                         f"census_job_worker_process ({census['steps']} steps, "
                         f"{census['eval_batches']} evaluation batches)":
                             census["launches"]["fused_lookup"],
                         "census_fleet_replica_process": {
                             f"replica {rid} ({r['dispatches']} dispatches)":
                                 r["launches"]["fused_lookup"]
                             for rid, r in fleet["per_replica"].items()},
                         "census_fleet_under_the_policy_engine_replica_process": {
                             f"replica {rid} ({r['dispatches']} dispatches)":
                                 r["launches"]["fused_lookup"]
                             for rid, r in fleet_policy["per_replica"].items()},
                         f"stream_loop ({stream_loop['steps']} steps, {stream_loop['requests']} "
                         "dispatches)": stream_loop["launches"]["fused_lookup"],
                         "observed_job_worker_process": {
                             f"worker {w} ({r['steps']} steps, {r['eval_batches']} evaluation "
                             "batches)": r["launches"]["fused_lookup"]
                             for w, r in observed["per_worker"].items()},
                         f"observed_job_profiler_window ({observed['profile']['traced_steps']} "
                         "steps, CUDA kernel events)":
                             observed["profile"]["fused_lookup"]["events"],
                         f"traced_replica_process ({traced['dispatches']} dispatches)":
                             traced["launches"]["fused_lookup"],
                         f"quality_gate_trainer ({quality_steps} steps)":
                             quality_trained["fused_lookup"],
                         "quality_gate_held_polls_shadow_runs (16 replay batches x 2 "
                         "generations each)": [
                             c["fused_lookup"] for c in quality_gate["held_poll_launches"]],
                         f"quality_replica_process ({quality_process['dispatches']} dispatches, "
                         f"{quality_process['shadow_batches']} replay batches of shadow "
                         "evaluations)": quality_process["launches"]["fused_lookup"],
                         f"train_whole_mesh_xla ({XLA_STEPS} steps over {XLA_MESH}, "
                         f"{XLA_K2_PER_STEP} a step)": whole_mesh["launches"]["fused_lookup"]},
        "fused_dedup_apply": {"train_strict": train["launches_strict"]["fused_dedup_apply"],
                              "train_window": train["launches_window"]["fused_dedup_apply"],
                              "train_mesh": mesh_train["launches"]["fused_dedup_apply"],
                              "train_split_strict":
                                  split_train["launches_strict"]["fused_dedup_apply"],
                              "train_split_resumed_10_steps":
                                  ckpt["launches_resumed"]["fused_dedup_apply"],
                              "elastic_job_worker_process": {
                                  f"worker {w} ({r['steps']} steps)":
                                      r["launches"]["fused_dedup_apply"]
                                  for w, r in elastic["per_worker"].items()},
                              "etrf_job_worker_process": {
                                  f"worker {w} ({r['steps']} steps)":
                                      r["launches"]["fused_dedup_apply"]
                                  for w, r in etrf["per_worker"].items()},
                              **{f"ctr_zoo_{m}_{CTR_ZOO_STEPS}_steps":
                                 r["launches"]["fused_dedup_apply"] for m, r in zoo.items()},
                              f"census_job_worker_process ({census['steps']} steps)":
                                  census["launches"]["fused_dedup_apply"],
                              f"stream_loop ({stream_loop['steps']} steps)":
                                  stream_loop["launches"]["fused_dedup_apply"],
                              "observed_job_worker_process": {
                                  f"worker {w} ({r['steps']} steps)":
                                      r["launches"]["fused_dedup_apply"]
                                  for w, r in observed["per_worker"].items()},
                              f"observed_job_profiler_window "
                              f"({observed['profile']['traced_steps']} steps, CUDA kernel "
                              "events)": observed["profile"]["fused_dedup_apply"]["events"],
                              **{f"engines_{k}_k3_3_steps":
                                 engines[k]["launches"]["fused"]["fused_dedup_apply"]
                                 for k in ENGINE_KINDS},
                              f"quality_gate_trainer ({quality_steps} steps)":
                                  quality_trained["fused_dedup_apply"]},
    }
    on_mesh = {"fused_lookup_fm": sharded["fused_lookup_fm"], "fused_lookup":
               sharded["fused_lookup"], "fused_dedup_apply": sharded["fused_dedup_apply"]["adam"]}
    line = []
    for name in ("fused_lookup_fm", "fused_lookup"):
        r = kernels[name]
        entry = {
            "name": name, "ok": True, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": (train if name == "fused_lookup_fm" else split_train)[
                "launches_strict"][name],
            "launches_by_path": by_path[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "gather_ms": r["gather_ms"],
            "shape": r["shape"], "sector_bound_ms": r["sector_bound_ms"], "split": r["split"],
            "card": card,
        }
        if name == "fused_lookup_fm":
            entry.update({k: r[k] for k in (
                "main_path_shape", "main_path_shape_ms", "main_path_shape_bound_ms",
                "train_shape_ms", "train_shape_plain_ms", "train_shape_bound_ms",
                "main_path_shape_sector_bound_ms", "train_shape_sector_bound_ms")})
        else:
            entry["shapes"] = r["shapes"]
            entry["train_split_step_ms"] = split_train["breakdown_ms"]["kernel_ms"][name]
            entry["ctr_zoo_shapes"] = {m: z["kernels"][name] for m, z in zoo.items()}
            entry["job_profiler_window"] = observed["profile"][name]
            entry["whole_mesh"] = {**whole_mesh["lookup"],
                                   "launches_per_step": whole_mesh["k2_per_step"],
                                   "placement": whole_mesh["placement"],
                                   "train_step_kernel_ms":
                                       whole_mesh["breakdown_ms"]["kernel_ms"][name]}
        builds = [(resources or {}).get(build) for build in SPARSE_BUILDS[name]]
        entry["resources"] = (builds[0] if len(builds) == 1
                              else dict(zip(SPARSE_BUILDS[name], builds)))
        entry["sharded"] = on_mesh[name]
        line.append(entry)
    adam = k3["by_kind"]["adam"]
    line.append({
        "name": "fused_dedup_apply", "ok": True, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["fused_dedup_apply"],
        "launches": train["launches_strict"]["fused_dedup_apply"],
        "launches_by_path": by_path["fused_dedup_apply"],
        "max_abs_err": max(r["max_abs_err"] for r in k3["by_kind"].values()),
        "ms": adam["ms"], "plain_ms": adam["plain_ms"], "bound_ms": adam["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "index_add_ms": k3["index_add_ms"],
        "kernel_ms": adam["split"]["kernel_ms"], "sector_bound_ms": adam["sector_bound_ms"],
        "resources": (resources or {}).get(SPARSE_BUILDS["fused_dedup_apply"][0]),
        "shape": k3["shape"] + ", adam per-row", "by_kind": k3["by_kind"],
        "xla_engines_step_ms": {k: engines[k]["step_ms"] for k in ENGINE_KINDS},
        "train_step_ms": train["breakdown_ms"]["fused_dedup_apply"],
        "sharded": on_mesh["fused_dedup_apply"],
        "ctr_zoo_shapes": {m: z["kernels"]["fused_dedup_apply"] for m, z in zoo.items()},
        "job_profiler_window": observed["profile"]["fused_dedup_apply"],
        "card": card,
    })
    line += flash_entries(attention, edges, lm, card, resources, lm_ckpt, lm_heads, tp, fsdp,
                          wide, f16)
    line += ring_entries(ring_kernels, ring_whole, cp, card, resources, cp_wide)
    line += ring_f16_entries(cp_f16, card, resources)
    line.append({
        "name": "block_gather", "ok": True, "route": "cuda", "source": K10_SOURCE,
        "replaces": K10_REPLACES, "launches": gather["launches"],
        "launches_by_path": {"exp_sparse_gather_default_mode": gather["launches"]},
        "launches_per_timed_call": gather["launches"] / gather["script"]["block_gather_calls"],
        "max_abs_err": gather["max_abs_err"], "ms": gather["ms"], "plain_ms": gather["plain_ms"],
        "bound_ms": gather["bound_ms"], "bound_by": "bytes", "library_ms": gather["library_ms"],
        "library": "index_select(table.view(-1, 8, 128), 0, the index rule's blocks)",
        "shape": gather["shape"],
        "script_ms": {k: v["ms"] for k, v in gather["script"].items() if isinstance(v, dict)},
        "script_shard_map_ms": {k: v["ms"] for k, v in gather["script_shard_map"].items()},
        "card": card,
    })
    log(json.dumps({"kernels": line}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
