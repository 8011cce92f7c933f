#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # on a machine with a CUDA device
    python3 chip_smoke.py --cpu-dry   # rehearsal: CPU, plain versions, tiny

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, CUDA and nvcc versions;
   build the kernels from ``horovod_tpu_torch/csrc`` (flash_attention.cu,
   adamw.cu, conv_bn_act.cu, conv_bn_stats.cu and attention_probe.cu: one
   nvcc per source, started together) and print what ptxas reports
   (registers, spills). The witness that the kernels are the Hopper
   design: ``cuobjdump -sass`` of the flash_attention, attention_probe and
   conv_bn_stats libraries must show HGMMA (wgmma), UTMALDG (TMA loads)
   and SYNCS (mbarriers) instructions in every instance, D64 and D128, of
   flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
   flash_bwd_fused_kernel and probe_fwd_kernel, and in both N-tile
   instances (64, 128) of conv3x3_stats_kernel; that of the adamw library
   UBLKCP (1-D bulk copies) and SYNCS in every instance of
   flat_adamw_kernel (f32 and bf16 gradients); and ptxas must report no
   wgmma serialised.
2. Flash-attention kernels against their plain PyTorch versions, in bf16 on
   the card, with the plain version run on float32 copies of the same bf16
   inputs: (a) B8 H16 S512 D64 (BERT-Large), (b) B16 H12 S1024 D64 causal
   (GPT-2), (c) B1 H4 S2048 D128 causal, (d) ring offsets (all keys in the
   past; rows with every key masked, whose dq must be exactly 0), (e) D128
   causal with Sq 700 != Sk 1000 and q_offset 300. Limits: o 2e-2 abs, lse
   2e-3 abs, dq/dk/dv 2e-2 relative to their norm. Then each kernel, its
   plain version and a yardstick the port never calls
   (``scaled_dot_product_attention``'s forward; aten's flash attention
   backward, one call for dq, dk and dv, beside dq + dk/dv) are timed at
   (a), (b) and (c), beside their bounds. Every time in
   the script is ``utils.measure.time_ms``: CUDA events around a replay of
   a CUDA graph of back-to-back calls, so no host time between launches
   enters a kernel's reading, the yardsticks' or the plain versions'.
2b. The AdamW kernels against their plain versions on the card, on copies
   of the same inputs with the same float32 scalars, for 3 steps: the
   multi-tensor kernel over BERT-Large's 388 parameter shapes and over a
   mixed set (a bf16 parameter with f32 moments, 7 elements, 131 x 128);
   the flat ZeRO kernel over BERT-Large's world-1 shard (536,870,912
   elements, the bucket pad included), over ragged lengths (1, 3, 127,
   16,385), the edges of its ring's tiles (a tile minus 4, a tile, a tile
   plus 4, five tiles plus 3) and a shard 16 bytes off a tile's boundary,
   each with every pair of f32 and bf16 gradient and output, and over each
   group shard length of P4's and P5's bucket layout (the most common in
   every pair). Limit: bit-equal
   (both round after every float32 operation; adamw.cu is built with
   -fmad=false); for f32 output the parameters returned must be master's
   storage, for bf16 a tensor of their own. Then each is timed at
   BERT-Large's shapes beside its bound (the flat kernel's at 28 bytes an
   element: its f32 parameters are its master),
   its plain version, ``torch.optim.AdamW(fused=True)`` (a yardstick the
   port never calls) and the foreach AdamW of the phase-4 path.
2c. At world 1, ``fused_adamw`` and ``sharded_adamw`` on the same
   BERT-Large-shaped weights and gradients give bit-equal parameters.
3. A tiny BERT on the card against the same weights on the CPU (plain
   path): loss and hidden states agree.
4. The slice: ``hvd.init()`` (NCCL, world 1), BERT-Large at full width
   (24 x 1024, 16 heads, vocab 30522, seq 512, batch 8), random weights
   from seed 0, ``broadcast_parameters``, ``DistributedOptimizer(AdamW(1e-4,
   weight_decay=1e-4))``, the bench's MLM data (gathered head), 2 warm-up
   and 10 timed steps. The loss must be finite and fall, every kernel must
   have launched 24 times per step and the hooks requested one allreduce
   per parameter per step. Every collective goes through the enqueue
   runtime (``runtime/``); what it issued each step is printed from
   ``runtime.COUNTS`` (allreduce calls, responses, response-cache hits,
   fusion slabs, process groups, cycle host ms), here and in phases 5-7.
   The runtime must issue fewer than a quarter of the 388 allreduces a step
   after the first (fused bins), answer all 388 from its response cache
   from the second step on, and create no slab or group after warm-up.
4b. The hooks path again at ``HOROVOD_FUSION_THRESHOLD=0`` (one allreduce a
   tensor: 388 a step), in turns with phase 4 (fused, 0, 0, fused). At
   world 1 each reduction is the identity, so every run's losses must
   equal phase 4's, bit for bit unless a library kernel is
   nondeterministic, within 1e-5 relative; both step times are printed
   beside the card's name and power limit.
4c. The hooks path on each cycle engine, in turns: ``HOROVOD_NATIVE_CYCLE``
   1, 0, 0, 1 (the C++ response cache and bin-packer of ``cpp/cycle.cc``,
   then the Python ones), 2 warm-up and 3 timed steps each, then once
   each at ``HOROVOD_FUSION_THRESHOLD=0``. Every run's losses bit-equal
   to the first's; cache hits, slabs and groups a step equal in every run,
   and at threshold 0 allreduce calls and responses too (fused bins follow
   when autograd's hooks fire, so their count varies from step to step);
   the native runs' cache a ``NativeResponseCache`` and their bins from the
   native bin-packer, the Python runs' neither; ``hvd.metrics()`` moved by
   what ``COUNTS`` shows (cycles equal, cache-hit lookups twice the hits);
   each run's step ms and cycle host ms a step beside the card's name and
   power limit. Then two steps with ``HOROVOD_TIMELINE``,
   ``HOROVOD_TIMELINE_MARK_CYCLES=1`` and ``HOROVOD_METRICS_PORT=0``: the
   trace parses and holds ``CYCLE_<n>`` markers, ``"C"`` counter events,
   ``NCCL_ALLREDUCE`` activities and its drop count; ``GET /metrics``
   serves the cycle, cache and fusion families.
5. The optimizer paths, each on the same model, data and steps as phase 4:
   (P1) ``allreduce_gradients`` then ``fused_adamw(1e-4).apply`` (the
   multi-tensor kernel once a step, 388 allreduces a step); (P2) ZeRO-1
   ``sharded_adamw(1e-4).apply`` (one reduce-scatter, one flat-kernel launch
   and one allgather per dtype group a step, no allreduce); (P3)
   ``DistributedOptimizer(AdamW, shard_optimizer_states=True)``, torch's
   AdamW over the flat shard (no kernel of the port); (P4) ZeRO-2: a
   ``GradReleasePlan(reduce_scatter=True)`` of 4 MiB buckets releasing
   during the backward and ``sharded_adamw(1e-4, partition=
   plan.zero_partition(params))`` through ``make_train_step`` (one
   reduce-scatter, one flat-kernel launch and one allgather a bucket
   group a step); (P5) ZeRO-3: the same plan and layout, the parameters
   sharded at rest (``shard_params``) and copied into the model group by
   group from ``iter_param_buckets`` before each forward, ``apply``
   returning ``ShardedParams``. Losses finite and falling, and within 1e-2
   relative of phase 4's at every step; P4's and P5's within 1e-5 of
   P2's. On the ZeRO paths (P2-P5) every collective after the first step
   comes from the response cache, and no slab or group appears after
   warm-up. Each prints B8's launches a step, the bytes held for
   optimizer state and gradient and parameter shards, peak memory, and
   P5 the stage-3 gather's hidden share.
6. The Inception-V3 slice (``bench.py --model inception``, eager, one
   process): ``hvd.init()``, ``InceptionV3(1000, bf16, seed=0)`` on the card,
   ``broadcast_parameters``, ``DistributedOptimizer(SGD(0.01, momentum
   0.9))``, the bench's images (32 x 299 x 299 x 3) and labels, 2 warm-up
   and 10 timed steps. Losses finite and falling, kernel B10 launched 94
   times a step, 284 allreduces a step; images/s, MFU, step ms and peak
   memory beside the card's name and power limit.

7. The GPT-2-small slice (``bench.py:373-560, 2153``): ``hvd.init()``,
   ``GPT2Small(vocab_size=50257)`` at full width (12 x 768, 12 heads, seq
   1024), random weights from seed 0, ``broadcast_parameters``,
   ``DistributedOptimizer(AdamW(1e-4, weight_decay=1e-4))``, the bench's
   tokens (batch 16, ``RandomState(0)``), the full-logits
   ``causal_lm_loss``, 2 warm-up and 10 timed steps; run twice, with the dq
   and dk/dv kernels (``FLASH_FUSED_BWD`` unset) and with the fused
   backward (``FLASH_FUSED_BWD=1``: 12 launches of it a step, none of dq or
   dk/dv). Losses finite and falling in each, the two within 1e-3 relative
   at every step (a step's fall is ~1e-2 of the loss); one allreduce per parameter tensor a step; tokens/s, MFU,
   step ms and peak memory beside the card's name and power limit.
8. The ResNet-50 slice (``bench.py:85, 258-300``): ``hvd.init()``,
   ``ResNet50(1000, bf16, seed=0)`` (NHWC, f32 parameters and batch
   statistics, the space-to-depth stem), ``broadcast_parameters``,
   ``DistributedOptimizer(SGD(0.01, momentum 0.9))`` through the hooks and
   the runtime, the bench's images (128 x 224 x 224 x 3) and labels, 2
   warm-up and 10 timed steps. Losses finite and falling; 161 gradients a
   step, all from the response cache from the second step, fewer than 161
   fused calls a step, no slab or group after warm-up; no kernel of the
   port (the 33 norm + ReLU pairs run plain: faster than B10 in one timing
   of the step, ``tools/resnet_bn_choice.py``); images/s, MFU at 3 x 8.234
   GFLOP an image, step ms and peak memory beside the card's name and
   power limit.
9. The rest of the collectives at world 1 through the runtime (NCCL on the
   card): allgather, alltoall, a differentiable allreduce and its
   backward, an int64 allreduce past 2**40, a sparse allreduce and
   ``broadcast_object``, each exact.
10. The training API (no kernel of its own). 10a: phase 8's ResNet-50,
   data and optimizer through ``create_train_state`` and
   ``make_train_round(steps=3)``, one warm-up and 3 timed rounds, each
   inside ``hvd.profiler.step`` with ``HOROVOD_PROFILE=1`` and
   ``set_flops_per_step(128 x 3 x 3 x 8.234e9, 989e12)``: every step's
   loss finite, falling and within 1e-5 (first step) and 1e-2 (every
   step; cuDNN's bf16 backward need not be deterministic) relative of
   phase 8's; one record a round; each record's four phases summing to
   its wall; dispatches and MFU above 0; each round's step_breakdown,
   comm_hidden_fraction, MFU and peak_hbm_bytes printed. 10b: the same
   rounds at ``HOROVOD_PROFILE`` 0, 1, 1, 0, ms a step each. 10c:
   BERT-Large on phase 4's hooks path (2 warm-up, 3 timed steps) with
   ``HOROVOD_PROFILE_DIR`` and ``HOROVOD_PROFILE_JAX``: one record a step
   from the optimizer's own boundary, the optimizer phase above 0, the
   phases summing to the wall; ``shutdown()``'s dump parses and
   ``merge_profile_dir`` gives a trace with the step markers and the
   ``torch.profiler`` device lane's kernels. 10d: the rounds at
   ``HOROVOD_INTEGRITY`` 1, 0, 0, 1 with no healthy step skipped, the
   guard's norm timed alone, then one ``DistributedOptimizer`` step with
   one NaN written into one gradient by a gradient hook: skipped, the
   parameters and SGD momentum bit-equal, the skipped-steps counter moved
   by 1. 10e: the three examples (``horovod_tpu_torch/examples``), each
   a process at world 1 on the card: ``synthetic_benchmark`` with and
   without ``--fp16-allreduce``, ``mnist`` for 1 epoch,
   ``bert_large_sparse`` at full width (tokens/s and "lockstep OK").
11. Checkpoint and resume (no kernel of its own), in a temporary
   directory whose free space is checked first (the phase fails, with
   the numbers, when it is short). 11a: phase 5's P2 (BERT-Large, seed 0,
   the bench's batch, ``sharded_adamw`` through B8, flash B1-B6 in the
   forward and backward), 2 warm-up steps, ``hvd.ckpt.CheckpointManager(
   dir, async_write=True, keep=1).commit({"params", "opt"}, step=2)``,
   step 3 at once (racing the writer), ``wait()``, steps 4-5; a model and
   state from seed 1 restored by ``hvd.ckpt.restore_latest``: every
   parameter, master, mu, nu and the count bit-equal to a host copy taken
   at the commit, the replay of steps 3-5 on the same batch with the
   first loss bit-equal to step 3's and the rest within 1e-2 relative;
   the manifest at step 2 exists and no commit was abandoned. Printed
   beside the card's name and power limit: the commit's inline ms, the
   writer's ms and commit to ``wait()``, bytes a rank, the racing step's
   ms against steps 4-5, restore seconds. 11b: the restored state
   committed again, then one step (B8 in place) at once with no
   synchronize: the shard file holds the pre-step bytes of every
   parameter, master, mu and nu, the step moved master, and the second
   commit allocated no host slab. B1-B6 launched 24 times a step and B8
   once a group a step over the 9 steps. 11c: phase 8's ResNet-50 saved
   after step 2 by ``hvd.checkpoint.save`` (parameters, batch-norm
   buffers, SGD momentum), ``restore_latest`` into a model from seed 1:
   every tensor bit-equal, the next step's loss bit-equal to the
   uninterrupted run's; a copy with one byte of its largest leaf flipped
   raises ``CheckpointCorruptError`` naming that leaf.
12. Elastic training (no kernel of its own), in a temporary directory
   whose free space is checked first: phase 5's P2 (BERT-Large, seed 0,
   ``sharded_adamw`` through B8, B1-B6 in the forward and backward) for 6
   steps under ``@hvd.elastic.run`` with ``hvd.elastic.ArrayState(model,
   zero_state, ckpt_dir)`` committed every step (host snapshots in two
   pinned slab sets used in turn, written by ``CheckpointManager(copy=
   False)``). 12a: an uninterrupted run, then one beside an in-process
   ``RendezvousServer`` and ``ElasticDriver`` whose discovery script's
   output changes after steps 1 and 3: step 3's commit raises
   ``HostsUpdatedInterrupt``, the runner re-forms at world 1 (a new store
   at the assignment's coordinator, new NCCL and gloo groups, a new
   runtime: ``hvd.reinit()``), syncs and goes on; the losses bit-equal to
   the uninterrupted run's, no host slab allocated after the first
   commit; the commits' ms, the slabs and the re-form's ms (shutdown,
   rendezvous, reinit, sync) printed beside the card's name and power
   limit. 12b: ``HOROVOD_INTEGRITY=1``, ``HOROVOD_INTEGRITY_INTERVAL=1``
   and ``nan:0:after=<3 steps of reduce-scatters>``: step 4's poisoned
   gradient is convicted by the digest (``NumericalError``),
   ``rollback.handle_failure`` restores step 3's checkpoint cut in place
   and the steps are replayed: one replay, the losses bit-equal to 12a's
   uninterrupted run; the restore's ms, then 3 steps at
   ``HOROVOD_INTEGRITY`` 1, 0, 0, 1 with the step ms and the cycle
   thread's digest ms a checked dispatch, and the digest's non-finite
   count timed alone over a gradient shard of P2's length beside its
   bound. B1-B3 launched 24 times a pass and B8 once a group an update
   over the phase. The goodput ledger holds one ``elastic_reform``
   incident for 12a, whose seconds are within 5 % of the re-form's parts
   (``runner.last_reform()``), and one ``rollback`` incident for 12b, whose
   flight-recorder failure dump (``integrity_violation``) holds the
   ``rollback`` event naming the ``NumericalError``.
13. The observability planes (no kernel of their own), in a temporary
   directory: phase 5's P2 with ``HOROVOD_FLIGHT_RECORDER_DIR`` and
   ``HOROVOD_METRICS_PORT=0``, 4 steps a turn with all four planes (flight
   recorder, memory ledger, comms observatory, goodput ledger) on, off,
   off, on, the step ms of each printed beside the card's name and power
   limit; ``hvd.dump_debug_state`` read back by ``load_dumps``; ``GET
   /debug``, ``/memory``, ``/comms`` and ``/goodput`` answer JSON; the
   ledger's device bytes and peak equal ``torch.cuda.memory_allocated``
   and ``max_memory_allocated`` at one instant and ``optimizer_shards``
   P2's master, mu and nu to the byte; each ``zero``-lane record carries a
   group's exact padded bytes, with an algbw above 0 and below the copy
   bound (a read and a write a byte at 3.35 TB/s) from the device's CUDA
   event seconds; every collective the executor ran is a ``device``-lane
   record once the runtime stops; a real ``torch.cuda.OutOfMemoryError``
   (an allocation 1 GiB past the card's total bytes, so past
   ``mem_get_info``'s free bytes and the allocator's cache) through
   ``memory.maybe_record_oom`` names the allocator's figures and the
   largest live tensors, and a step runs after it. Then P4 (stage 2, 145
   groups) 3 steps a turn on, off, off, on: the host ms a dispatch the
   planes cost. B1-B3 launched 24 times a pass and B8 once a group a step
   over P2's steps.
14. The transformer options and the conv and MoE models. 14a: BERT-Large
   with ``fused_qkv=True`` and ``remat=True`` on phase 4's hooks path, its
   weights phase 4's seed-0 ones fused by concatenation
   (``fuse_qkv_state``), 2 warm-up and 10 timed steps: the first loss
   within 1e-2 of phase 4's, losses finite and falling, B1/B2 launched
   twice a layer a step (the backward recomputes each layer) and B3-B6
   once; then remat off, off, on (2 + 3 steps each), their losses within
   1e-3 of the main run's: the step ms and peak memory of each, the
   remat peak below the plain one; every gradient from the response
   cache from the second step, fewer NCCL calls a step than gradients
   (the recomputation spreads the backward over more cycles). 14b: VGG-16 as the bench's row (256 x
   224², 1000 classes, bf16, ``DistributedOptimizer(SGD(0.01 x size,
   momentum 0.9))`` through ``make_train_step``), 2 warm-up and 10 timed
   steps: losses finite and falling; every step's fusion bins hold
   ``fc1.kernel`` (411,041,792 bytes, over the 64 MiB threshold) alone;
   every gradient from the response cache from the second step, fewer
   NCCL calls than gradients, no slab or group after warm-up; images/s,
   MFU at 3 x 30.342 GFLOP an image, NCCL calls and fusion groups a step
   and peak memory. 14c: the MoE LM (``models/moe.py``) at GPT-2-small's
   widths (vocab 50257, 12 x 768, 12 heads, d_ff 3072, 8 x 1024 tokens),
   one expert at world 1, ``default_capacity``, ``moe_lm_loss``,
   ``DistributedOptimizer(Adam(3e-3))`` over the shared parameters and
   Adam over the expert, 2 warm-up and 10 timed steps: losses finite and
   falling, B1-B6 once a layer a step, four all-to-alls a layer a step
   (dispatch and combine, each with its gradient's), every collective a
   step requests answered from the response cache from the second step.
   Then GPT-2-small (phase 7's path) with the full-logits loss and with
   ``causal_lm_loss_chunked`` (128 positions a chunk), in turns full,
   chunked, chunked, full (2 + 3 steps each): each run's step ms and
   peak memory, its first loss within 1e-3 of the first run's.
15. The gradient wire's extensions (no kernel of their own). 15a: the
   hardware probes at world 1 (``autotune/probe.probe_and_seed``) with
   ``HOROVOD_PROBE_CACHE`` at a temporary path: the 64 MiB device copy's
   GB/s beside the 3.35 TB/s peak (below it), the allreduce probe (at
   world 1 one read and one write of its buffer, busbw 0) and the seeded
   fusion threshold; the artifact read back (a second call probes nothing
   and seeds the same threshold) and ignored at world 4; the ``device``
   roofline unseeded at world 1. 15b: BERT-Large at full width on phase
   4's hooks path from phase 4's seed-0 weights with ``HOROVOD_AUTOTUNE=1``
   (one warm-up sample, one busy cycle a sample, three Bayesian points),
   phase 4's steps and then until the tuner freezes (at most
   ``autotune_max_steps``): every ``autotune_commit`` and the frozen knobs
   printed, the losses bit-equal to phase 4's (every reduction at world 1
   is exact), B1-B6 once a layer a step; then the first knobs and the
   frozen ones in turns (first, frozen, frozen, first; 2 + 3 steps), each
   run's losses bit-equal to phase 4's and its step ms beside the card's
   name and power limit.
16. Model parallelism at world 1 (no kernel of its own), at GPT-2-small's
   widths. 16a: the ring module's per-step forward and backward
   (``parallel/ring.forward_step``, ``backward_step``) over 4 shards in
   one process, as 4 ranks run them (causal, B 2, 12 heads, S 4096, 1024
   a shard: rank i at step s holds key shard (i + s) mod 4, the offsets
   the shards' global positions), against one ``flash_attention`` forward
   and backward over the whole sequence: o 2e-2 abs, lse 2e-3 abs, the
   gradients 2e-2 relative; a key shard wholly in a query shard's future
   leaves the running (o, lse) bit-equal (its rows' lse is -inf, weight
   0); B1 16 times, dq and dk/dv 16 times each. 16b: phase 7's GPT-2 run
   (dq + dk/dv) with ``attention_fn`` set to ``ring_attention``, then to
   ``ulysses_attention``, on the world's one rank: the losses phase 7's to
   the bit (a merge with the empty partial is the identity; the
   all-to-alls of one rank copy); then ``pipeline_apply`` with one stage
   over the 12 layers, phase 7's batch as 8 microbatches of 2, against
   the plain stack over the same microbatches: outputs and loss bit-equal,
   the layers' gradients within 1e-2 relative. Each run's B1 and B3/B4
   launches are printed and join the kernels line.
17. The serving plane (no kernel of its own: the cached attention is plain
   PyTorch, as the JAX package's is plain XLA). 17a: the serving tests'
   tiny float32 model (vocab 61, d 32, 2 layers, 2 heads, max_seq 48) with
   the same weights on the card and on the CPU; the dense and the paged
   engine (``serve/kv_cache.py``, ``serve/paging.py``) run one call
   sequence (two prompt buckets in concurrent slots, a reused slot, a
   shared 16-token prefix with copy-on-write, an exact repeat): the card's
   tokens equal the CPU's, and after every replay of the decode step's
   CUDA graph the same step run eagerly on the same state gives bit-equal
   ids and max|logit|. 17b: ``hvd.init()`` with ``HOROVOD_METRICS_PORT=0``,
   GPT-2-small at full width (float32 parameters, bf16 compute, seed 0),
   ``hvd.serve(model, replicas=1, slots=8, max_new_tokens=64)`` dense, then
   ``paged=True`` (the default pool, ``auto_pool_pages(8, 1024, 16)`` =
   256 pages): one warm-up request a prompt bucket (16-512), then 48
   requests from seed 0 whose prompts span those buckets, 16 of them with
   a shared 256-token prefix. Every request completes with 64 tokens, no
   replica is quarantined (a swallowed device error fails the phase at
   once) and ``serve_state()`` shows none; no program key appears after
   the warm-up; the paged run reuses prefix tokens; every request has its
   ``request.submit``, ``.queue_wait``, ``.prefill``, ``.decode_block`` and
   ``.response`` spans under one trace id; ``GET /serve``, ``/slo`` and
   ``/healthz`` answer; the memory ledger's ``serve_kv`` is 301,989,888
   bytes and ``kv_pages`` 150,994,944; the goodput ledger's serve time is
   above 0. Each served token's logit in a teacher-forced uncached forward
   (flash B1) is within 0.125 of that row's maximum (a near-tie), and for
   8 requests a run the serving path's logits (one request in a cache of
   its own) are within 0.125 of that forward's. Printed beside the card's
   name and power limit: generated tokens/s, TTFT p50/p99, the decode
   step's ms replayed and eager in turns, the KV bytes. The reference
   forwards' B1 launches join the kernels line.
18. Robustness under the launcher (no kernel of its own). 18a: the port's
   launcher (``tpurun-torch -np 1 --flight-recorder-dir``) starts
   ``horovod_tpu_torch.tools.bert_launch_worker`` on the card: BERT-Large
   MLM on the hooks path, 4 steps at batch 8, fed by ``ShardedSampler``
   over a seeded token table (64 rows) and ``prefetch_to_device`` to
   ``cuda:0``. Its losses must equal, bit for bit, those of an in-process
   run of the same 4 batches (the same kernels in the same order);
   ``--postmortem`` over the dumps must print the rank's events; each
   step's wait for its batch is printed. The worker's B1-B3 (flash) launches
   join the kernels line. 18b: the chaos matrix's ``serve_kill_replica``
   at GPT-2-small's width: a frontend and three replicas (12 x 768, vocab
   50257, weights from seed 0) on the one card, rank 2 killed at its 5th
   decode step: every request completes (``zero_lost``), the dead
   replica's requests were sent again (``requeued``), the postmortem names
   rank 2, each replica's peak memory is printed, and every served token's
   logit in a teacher-forced uncached forward (flash B1) is within 0.125
   of that row's maximum, as in 17b; those forwards' B1 launches join the
   kernels line.

Between them: 2d. kernel B10 (fused BN + ReLU) bit-equal to its plain
version at every distinct BN input of Inception-V3 at batch 32 (bf16),
three of them in f32, ragged C (3, 7, 1000) and 5 elements; then timed
over one forward's 94 calls. 2e. kernel
B11 (3x3 conv + BN statistics) through
``horovod_tpu_torch.tools.conv_bn_probe`` at its four ResNet-50 shapes
(batch 128; 14 x 14 x 256 is the tool's own), within the tool's limits of
its plain version and a second call bit-equal to the first, timed beside
its bound, cuDNN's conv alone and conv plus a stats pass. 3b. a small Inception-V3 (8 x 128 x 128, f32) on the card
against the CPU (eval mode: logits and loss 1e-3, gradient 1e-2; train
mode: twice what one ulp of input moves the CPU's own result), the ReLU
mask elements that differ counted; each mixed block alone in train mode
at 1e-3. 2f. the fused backward B7 against its plain version and against
the dq and dk/dv kernels at (a), (b), a D128 causal case with q_offset !=
k_offset and Sq != Sk, and (d_masked): dq/dk/dv within 2e-2 relative, dq
exactly 0 on fully masked rows, a second call bit-equal to the first; then
timed at (a) and (b) beside its bound, its plain version, dq + dk/dv and
PyTorch's one-call flash attention backward (a yardstick the port never
calls). 2g. the probe kernels B12-B14 through
``horovod_tpu_torch.tools.flash_vpu_probe`` at BERT-Large's shape (B8 H16
S512 D64) against their plain versions on the tool's data (scale 0.3, a
nearly uniform softmax) and on unit-scale data (a peaked one): o 2e-2 abs
and 1e-2 relative to its norm, lse 2e-3 abs; uniform attention and half
the sm_scale, as controls, must miss the o limit. Each probe function is
driven once with its count set to 0 just before, then timed beside its
bound and SDPA's forward.

The last lines are a ``{"kernels": [...]}`` JSON line (each kernel's
launches counted on the paths that run it: the flash kernels on phase 4,
on 14a and 14c, on 15b, on phase 16, on phase 17's reference forwards
and on phase 18 (the launched worker's steps, 18b's reference forwards),
the multi-tensor AdamW on P1, the flat AdamW on P2, P4 and P5, B10 on phase 6, B11 on
the probe's phase 2e, B7 on phase 7's fused run, B12-B14 on the probe's
phase 2g), the card's name and power limit, and ``{"ok": true,
"device": {...}}``. ``--cpu-dry`` runs the
same code on the CPU at tiny sizes and prints neither JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import comms, flight_recorder, goodput, memory
from horovod_tpu_torch import tracing
from horovod_tpu_torch.autotune import probe as aprobe
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.metrics import flatten_snapshot
from horovod_tpu_torch.metrics import registry as metrics_registry
from horovod_tpu_torch.models import inception as inc
from horovod_tpu_torch.models.inception import InceptionV3
from horovod_tpu_torch.models.resnet import BatchNormReLU, ResNet50
from horovod_tpu_torch.models import moe
from horovod_tpu_torch.models.transformer import (BertLarge, GPT2Small,
                                                  KVCache, Transformer,
                                                  causal_lm_loss,
                                                  causal_lm_loss_chunked,
                                                  fuse_qkv_state,
                                                  masked_lm_loss_gathered,
                                                  sample_masked_positions)
from horovod_tpu_torch.models.vgg import VGG16
from horovod_tpu_torch.ops import collectives, kernel_build
from horovod_tpu_torch.ops import conv_bn_act as cba
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_adamw as fadam
from horovod_tpu_torch.ops import fused_optimizer as fopt
from horovod_tpu_torch.parallel import zero as zero_mod
from horovod_tpu_torch.parallel.zero import LeafMeta, build_spec, dtype_name
from horovod_tpu_torch.runtime import fusion as fusion_mod
from horovod_tpu_torch.runtime import runtime as hrt
from horovod_tpu_torch.serve import serve_state
from horovod_tpu_torch.tools import conv_bn_probe as probe
from horovod_tpu_torch.tools import flash_vpu_probe as vprobe
from horovod_tpu_torch.training import make_train_step
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils.measure import card_line, time_ms

PEAK_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_F32 = 67e12  # H100 SXM float32 outside the tensor cores
SOURCES = ["flash_attention", "adamw", "conv_bn_act", "conv_bn_stats",
           "attention_probe"]
KERNELS = {  # wrapper count name -> (source, the TPU kernels it replaces)
    "flash_fwd": ("horovod_tpu_torch/csrc/flash_attention.cu",
                  "horovod_tpu/ops/pallas/flash_attention.py:205 "
                  "_fwd_single_kernel (+ :109 _fwd_kernel)"),
    "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_attention.cu",
                     "horovod_tpu/ops/pallas/flash_attention.py:523 "
                     "_bwd_dq_single_kernel (+ :395 _bwd_dq_kernel)"),
    "flash_bwd_dkv": ("horovod_tpu_torch/csrc/flash_attention.cu",
                      "horovod_tpu/ops/pallas/flash_attention.py:591 "
                      "_bwd_dkv_single_kernel (+ :456 _bwd_dkv_kernel)"),
    "adamw_multi": ("horovod_tpu_torch/csrc/adamw.cu",
                    "horovod_tpu/ops/pallas/fused_adamw.py:64 _adamw_kernel"),
    "flat_adamw": ("horovod_tpu_torch/csrc/adamw.cu",
                   "horovod_tpu/ops/pallas/fused_optimizer.py:53 "
                   "_flat_adamw_kernel"),
    "sba": ("horovod_tpu_torch/csrc/conv_bn_act.cu",
            "horovod_tpu/ops/pallas/conv_bn_act.py:64 _sba_kernel"),
    "conv_bn_stats": ("horovod_tpu_torch/csrc/conv_bn_stats.cu",
                      "tools/pallas_conv_bn.py:54 _conv_kernel"),
    "flash_bwd_fused": ("horovod_tpu_torch/csrc/flash_attention.cu",
                        "horovod_tpu/ops/pallas/flash_attention.py:654 "
                        "_bwd_single_kernel"),
    "pack2": ("horovod_tpu_torch/csrc/attention_probe.cu",
              "tools/flash_vpu_probe.py:94 _pack2_kernel"),
    "simple1_lse": ("horovod_tpu_torch/csrc/attention_probe.cu",
                    "tools/flash_vpu_probe.py:173 _simple1_lse_kernel"),
    "simple1": ("horovod_tpu_torch/csrc/attention_probe.cu",
                "tools/flash_vpu_probe.py:159 _simple1_kernel"),
}
# Inception-V3 as the bench runs it (bench.py:84-90, 258-340): batch 32 at
# 299 x 299, 1000 classes, SGD(0.01 x size, momentum 0.9), 11.137 GFLOP per
# image forward, a train step 3x that
INCEPTION_FLOPS = 3 * 11.137e9
# ResNet-50 as the bench runs it (bench.py:85, 258-300): 8.234 GFLOP per
# image forward at 224 x 224, a train step 3x that
RESNET_FLOPS = 3 * 8.234e9
# VGG-16 as the bench runs it (bench.py:89): 30.342 GFLOP per image forward
# at 224 x 224, a train step 3x that
VGG_FLOPS = 3 * 30.342e9
# AdamW as the bench runs it (bench.py:473-476, 1398-1408)
ADAMW = dict(b1=0.9, b2=0.999, learning_rate=1e-4, weight_decay=1e-4)
EPS = 1e-8
TOL = {"o": 2e-2, "o_rel": 1e-2, "lse": 2e-3, "grad": 2e-2}

F32, BF16 = torch.float32, torch.bfloat16

FULL = dict(
    cases={"a": (8, 16, 512, 64, False, 0, 0),
           "b": (16, 12, 1024, 64, True, 0, 0),
           "c": (1, 4, 2048, 128, True, 0, 0),
           "d_past": (2, 4, 512, 64, True, 512, 0),
           "d_masked": (2, 4, 512, 64, True, 64, 200),
           # (B, H, Sq, Sk, D, causal, q_offset, k_offset): neither extent
           # a multiple of 128
           "e_d128": (2, 4, 700, 1000, 128, True, 300, 0)},
    timed=("a", "b", "c"), iters=50,
    tiny=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
              d_ff=512, max_seq=128), tiny_batch=2,
    model=dict(vocab_size=30522, max_seq=512), batch=8, seq=512,
    warmup=2, steps=10, opt_iters=20, engine_steps=(2, 3),
    inception=dict(batch=32, size=299, classes=1000, dtype=BF16),
    tiny_inception=(8, 128), block_input=(4, 9),
    sba_iters=10,
    probe_shapes=tuple((probe.BATCH, size, c) for size, c in probe.SWEEP),
    probe_iters=20, profile_steps=3,
    # (batch, heads, Sq, Sk, head_dim, causal, q_offset, k_offset)
    fused_cases={"a": (8, 16, 512, 512, 64, False, 0, 0),
                 "b": (16, 12, 1024, 1024, 64, True, 0, 0),
                 "e_d128": (2, 4, 700, 1000, 128, True, 300, 0),
                 "d_masked": (2, 4, 512, 512, 64, True, 64, 200)},
    fused_timed=("a", "b"),
    vprobe_case=vprobe.SHAPES["bert-large"][:4],
    gpt=dict(vocab_size=50257), gpt_batch=16, gpt_seq=1024,
    resnet=dict(batch=128, size=224, classes=1000, dtype=BF16),
    round_steps=3, api_rounds=3,
    elastic_model=dict(vocab_size=30522, max_seq=512),
    obs_steps=4, obs_p4_steps=3,
    # phase 14: turns of (warm-up, timed) steps; VGG-16 as the bench's row
    # (its threshold the default); the MoE LM at GPT-2-small's widths
    opt_turn_steps=(2, 3),
    vgg=dict(batch=256, size=224, classes=1000, dtype=BF16, threshold=None),
    moe_lm=dict(vocab_size=50257, d_model=768, num_layers=12, num_heads=12,
                d_ff=3072, max_seq=1024), moe_batch=8, lm_chunk=128,
    # phase 15b: the autotuned run's steps until the tuner freezes, at most
    autotune_max_steps=40,
    # phase 16a: (batch, heads, seq, head_dim, shards), GPT-2-small's heads
    ring_case=(2, 12, 4096, 64, 4), pp_micro_batch=2,
    # phase 17b: hvd.serve's requests (from seed 0; the shared ones a
    # 256-token prefix), generation length, slots, decode-step timing
    # calls and requests checked on the serving path's logits
    serve_requests=48, serve_shared=16, serve_prefix=256,
    serve_max_prompt=512, serve_new=64, serve_slots=8, serve_step_iters=50,
    serve_cached_checks=8,
    # phase 18: the launched worker's batch and token-table rows, 18b's
    # requests (the model follows the device: GPT-2-small on the card)
    launch_batch=8, launch_rows=64, chaos_serve_requests=30)
DRY = dict(
    cases={"a": (1, 2, 64, 64, False, 0, 0), "b": (1, 2, 96, 64, True, 0, 0),
           "d_masked": (1, 2, 64, 64, True, 8, 40),
           "e_d128": (1, 2, 40, 96, 128, True, 30, 0)},
    timed=("a",), iters=2,
    tiny=dict(vocab_size=64, d_model=128, num_layers=1, num_heads=2,
              d_ff=256, max_seq=32), tiny_batch=2,
    model=dict(vocab_size=1000, max_seq=64, num_layers=1, d_model=128,
               num_heads=2, d_ff=256), batch=2, seq=64,
    warmup=1, steps=2, opt_iters=2, engine_steps=(1, 1),
    inception=dict(batch=2, size=75, classes=10, dtype=F32), sba_iters=1,
    tiny_inception=(2, 75), block_input=(2, 5),
    probe_shapes=((2, 6, 32),), probe_iters=1, profile_steps=1,
    fused_cases={"a": (1, 2, 64, 64, 64, False, 0, 0),
                 "e_d128": (1, 2, 40, 96, 128, True, 30, 0),
                 "d_masked": (1, 2, 64, 64, 64, True, 8, 40)},
    fused_timed=("a",), vprobe_case=(1, 2, 96, 64),
    gpt=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
             d_ff=256, max_seq=64), gpt_batch=2, gpt_seq=64,
    resnet=dict(batch=2, size=32, classes=10, dtype=F32),
    round_steps=1, api_rounds=2,
    elastic_model=dict(vocab_size=1000, max_seq=64, num_layers=1,
                       d_model=128, num_heads=2, d_ff=256),
    obs_steps=1, obs_p4_steps=1,
    # fc1 is 8 MB at 32 x 32: a threshold below it sends it alone
    opt_turn_steps=(1, 1),
    vgg=dict(batch=2, size=32, classes=10, dtype=F32, threshold=4 << 20),
    moe_lm=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
                d_ff=256, max_seq=64), moe_batch=2, lm_chunk=16,
    autotune_max_steps=60,
    ring_case=(1, 2, 64, 64, 4), pp_micro_batch=1,
    serve_requests=8, serve_shared=4, serve_prefix=32, serve_max_prompt=48,
    serve_new=8, serve_slots=4, serve_step_iters=2, serve_cached_checks=2,
    launch_batch=2, launch_rows=16, chaos_serve_requests=12)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"FAIL: {what}", flush=True)
        raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def kernel_name(line: str) -> str:
    """The kernel of a ptxas or cuobjdump line, template arguments
    demangled (the names nest in an anonymous namespace):
    .._ZN<namespace>16flash_fwd_kernelILi64EEEv.. -> flash_fwd_kernel<64>,
    ..16probe_fwd_kernelILi128ELi64ELb0EEEv.. ->
    probe_fwd_kernel<128,64,false>,
    ..17flat_adamw_kernelI13__nv_bfloat16fEEv.. ->
    flat_adamw_kernel<bf16,f32>,
    ..adamw_multi_kernelI13__nv_bfloat16S1_ffEEv.. -> <bf16,bf16,f32,f32>."""
    m = re.search(r"_Z(N?)(\w+)", line)
    if not m:
        return line.strip()
    mangled, name = m.group(2), ""
    while mangled[:1].isdigit():  # <length><name>, the last one the kernel
        digits = re.match(r"\d+", mangled).group(0)
        end = len(digits) + int(digits)
        name, mangled = mangled[len(digits):end], mangled[end:]
        if not m.group(1):
            break
    t = re.match(r"I(.*?)Ev", mangled)
    if not t:
        return name
    # a repeated bf16 is mangled as a back-reference, S<n>_
    names = {"f": "f32", "Lb0E": "false", "Lb1E": "true"}
    args = [a.group(1) or names.get(a.group(0), "bf16") for a in re.finditer(
        r"Li(\d+)E|Lb[01]E|13__nv_bfloat16|S\d*_|f", t.group(1))]
    return f"{name}<{','.join(args)}>"


HEAD_DIMS = ("64", "128")
#: the SASS instructions that show a wgmma kernel: HGMMA (wgmma), UTMALDG
#: (TMA loads; the conv kernel's are its weights'), SYNCS (mbarriers)
WGMMA_OPS = ("HGMMA", "UTMALDG", "SYNCS")
#: the kernels built on Hopper's asynchronous copies, by library: each with
#: the first template arguments its instances must cover and the SASS
#: instructions every instance must hold. A D64 and a D128 instance of
#: every attention kernel; the conv kernel's instances are its N tiles of
#: 64 and 128 output channels; the flat AdamW kernel's its gradient dtypes,
#: whose ring of 1-D bulk copies (cp.async.bulk, UBLKCP) completes on
#: mbarriers (SYNCS)
HOPPER_KERNELS = {
    "flash_attention": dict.fromkeys(
        ["flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
         "flash_bwd_fused_kernel"], (HEAD_DIMS, WGMMA_OPS)),
    "attention_probe": {"probe_fwd_kernel": (HEAD_DIMS, WGMMA_OPS)},
    "conv_bn_stats": {"conv3x3_stats_kernel": (("64", "128"), WGMMA_OPS)},
    "adamw": {"flat_adamw_kernel": (("f32", "bf16"), ("UBLKCP", "SYNCS"))}}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS")


def sass_counts(name: str) -> dict:
    """{kernel: {op: count}} over the SASS of the built library ``name``
    (``cuobjdump -sass``), for the ops of :data:`SASS_OPS`."""
    tool = os.path.join(os.path.dirname(kernel_build.nvcc()), "cuobjdump")
    lib = str(kernel_build.library_path(name))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    op = re.compile(r"\s(" + "|".join(SASS_OPS) + r")[.\s]")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_name(line)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn and (m := op.search(line)):
            counts[fn][m.group(1)] += 1
    return counts


def hopper_witness() -> None:
    """The Hopper kernels reached the card as designed: every instance of
    each kernel of :data:`HOPPER_KERNELS`, the instances it names at
    least, holds the SASS instructions it names, and ptxas serialised no
    wgmma (its ``Potential Performance Loss`` warning)."""
    for lib, kernels in HOPPER_KERNELS.items():
        serial = [line.strip() for line in
                  kernel_build.build_log(lib).splitlines()
                  if "wgmma" in line and "serialized" in line]
        for line in serial:
            log(f"  ptxas {lib}: {line}")
        check(not serial, f"ptxas serialised wgmma in {lib}")
        counts = sass_counts(lib)
        for kernel, (wanted, ops) in kernels.items():
            found = {fn: c for fn, c in counts.items()
                     if fn.startswith(kernel + "<")}
            firsts = {fn[len(kernel) + 1:].split(",")[0].rstrip(">")
                      for fn in found}
            check(set(wanted) <= firsts,
                  f"{kernel} in the SASS of {lib} lacks an instance of "
                  f"{wanted}: {sorted(found)}")
            for fn, c in sorted(found.items()):
                log(f"  SASS {fn}: " + ", ".join(f"{c[op]} {op}"
                                                 for op in ops))
                check(all(c[op] for op in ops), f"{fn} lacks one of {ops}: "
                                                f"{c}")


def environment(dry: bool) -> str:
    if dry:
        log("DRY RUN on the CPU: plain versions at tiny sizes; no device "
            "numbers, no result line")
        return "cpu (dry run)"
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([kernel_build.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    kernel_build.build(SOURCES)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        fn = None
        for line in kernel_build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line)
            elif fn and ("registers" in line or "spill" in line
                         or "smem" in line):
                log(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    hopper_witness()
    return card


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, then timed
# ---------------------------------------------------------------------------


def unmasked_pairs(sq, sk, causal, q_off, k_off) -> int:
    """(i, j) pairs the mask keeps: the work these inputs need."""
    if not causal:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    return int(np.clip(q_off + i - k_off + 1, 0, sk).sum())


def roofline(flops, nbytes, peak=PEAK_FLOPS) -> dict:
    """Least time of a call on an H100 SXM: the larger of the bytes it
    must move (each input read once, each output written once) over
    3.35 TB/s and its operations over ``peak`` (bf16 tensor cores by
    default)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def extents(case) -> tuple:
    """(B, H, Sq, Sk, D, causal, q_offset, k_offset) of a flash case, given
    as that or as (B, H, S, D, causal, q_offset, k_offset) with Sq = Sk."""
    if len(case) == 8:
        return tuple(case)
    b, h, s, *rest = case
    return (b, h, s, s, *rest)


def bounds(case) -> dict:
    """Each flash kernel's :func:`roofline` at a case."""
    b, h, sq, sk, d, causal, q_off, k_off = extents(case)
    bh, pairs = b * h, unmasked_pairs(sq, sk, causal, q_off, k_off)
    q_mat, k_mat = 2 * bh * sq * d, 2 * bh * sk * d  # bf16 (B, H, S, D)
    row = 4 * bh * sq     # bytes of one (B, H, Sq) f32 row vector
    work = {"flash_fwd": (4 * bh * pairs * d,  # q k v o, lse
                          2 * q_mat + 2 * k_mat + row),
            "flash_bwd_dq": (6 * bh * pairs * d,  # q k v do lse delta, dq
                             3 * q_mat + 2 * k_mat + 2 * row),
            "flash_bwd_dkv": (8 * bh * pairs * d,  # q k v do lse delta, dk dv
                              2 * q_mat + 4 * k_mat + 2 * row)}
    return {name: roofline(*w) for name, w in work.items()}


def make_inputs(case, device, seed):
    """q, k, v, do in bf16: (B, H, Sq, D), (B, H, Sk, D) twice, (B, H, Sq,
    D)."""
    b, h, sq, sk, d = extents(case)[:5]
    g = torch.Generator(device).manual_seed(seed)
    dtype = torch.bfloat16
    return [torch.randn(b, h, n, d, generator=g, device=device).to(dtype)
            for n in (sq, sk, sk, sq)]


def kwargs(case):
    b, h, sq, sk, d, causal, q_off, k_off = extents(case)
    return dict(causal=causal, sm_scale=d ** -0.5, q_offset=q_off,
                k_offset=k_off)


def rel(a, b) -> float:
    return ((a.float() - b).norm() / b.norm().clamp(min=1e-12)).item()


def check_case(name, case, device) -> dict:
    q, k, v, do = make_inputs(case, device, seed=len(name))
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_fwd_reference(*f[:3], **kw)
    o_ref = o_ref.float()
    delta_ref = fa.compute_delta(o_ref, f[3])
    dq_ref = fa.flash_bwd_dq_reference(*f, lse_ref, delta_ref, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*f, lse_ref, delta_ref, **kw)
    live = torch.isfinite(lse_ref)
    grads = {"dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    err = {g + "_abs": (a.float() - b).abs().max().item()
           for g, (a, b) in grads.items()}
    err |= {"o": (o.float() - o_ref).abs().max().item(),
           "lse": (lse - lse_ref)[live].abs().max().item() if live.any()
           else 0.0,
           **{g: rel(a, b) for g, (a, b) in grads.items()}}
    masked = int((~live).sum())
    b, h, sq, sk, d, causal, q_off, k_off = extents(case)
    log(f"case {name} B{b} H{h} Sq{sq} Sk{sk} D{d} "
        f"causal={causal} q_offset={q_off} k_offset={k_off}: "
        f"max|o-ref| {err['o']:.3e}  max|lse-ref| {err['lse']:.3e}  "
        f"rel dq {err['dq']:.3e} dk {err['dk']:.3e} dv {err['dv']:.3e}  "
        f"fully masked rows {masked}")
    check(torch.equal(torch.isfinite(lse), live),
          f"case {name}: lse is -inf on other rows than the plain version's")
    check(bool((o[~live] == 0).all()) and bool((lse[~live] == -math.inf).all()),
          f"case {name}: fully masked rows must give o 0 and lse -inf")
    check(bool((dq[~live] == 0).all()),
          f"case {name}: fully masked rows must give dq exactly 0")
    check(all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv)),
          f"case {name}: non-finite output or gradient")
    check(err["o"] <= TOL["o"], f"case {name}: o error {err['o']}")
    check(err["lse"] <= TOL["lse"], f"case {name}: lse error {err['lse']}")
    for g in ("dq", "dk", "dv"):
        check(err[g] <= TOL["grad"], f"case {name}: {g} error {err[g]}")
    return err


def time_case(name, case, device, iters) -> dict:
    q, k, v, do = make_inputs(case, device, seed=len(name))
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    bwd = (q, k, v, do, lse, delta)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd, **kw),
                         lambda: fa.flash_bwd_dq_reference(*bwd, **kw)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd, **kw),
                          lambda: fa.flash_bwd_dkv_reference(*bwd, **kw)),
    }
    bnd = bounds(case)
    rows = {}
    for kname, (kernel, plain) in calls.items():
        rows[kname] = dict(ms=time_ms(kernel, iters, device),
                           plain_ms=time_ms(plain, iters, device),
                           **bnd[kname])
    # yardstick only: PyTorch's fused attention, which the port never calls
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        return sdpa(q, k, v, is_causal=kw["causal"], scale=kw["sm_scale"])

    lib_fwd = time_ms(sdpa_fwd, iters, device)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        sdpa(qg, kg, vg, is_causal=kw["causal"], scale=kw["sm_scale"]) \
            .backward(do)

    lib_fb = time_ms(fwd_bwd, iters, device)
    rows["flash_fwd"]["library_ms"] = lib_fwd
    # aten's flash attention backward computes dq, dk and dv in one call:
    # the pair's yardstick, so each of the two rows carries it
    aten = aten_flash_backward(q, k, v, do, kw)
    lib_bwd = time_ms(aten, iters, device) if aten else None
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[kname]["library_ms"] = lib_bwd
    b, h, sq, sk, d, causal = extents(case)[:6]
    log(f"timing case {name} B{b} H{h} Sq{sq} Sk{sk} D{d} causal={causal} "
        f"({iters} calls each in a CUDA graph):")
    for kname, r in rows.items():
        log(f"  {kname:14s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB)  "
            f"share of bound {r['bound_ms'] / r['ms']:.3f}")
    back = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    log(f"  yardstick scaled_dot_product_attention: forward {lib_fwd:.4f} ms, "
        f"forward+backward {lib_fb:.4f} ms (port: forward "
        f"{rows['flash_fwd']['ms']:.4f} ms, "
        f"{rows['flash_fwd']['ms'] / lib_fwd:.2f}x SDPA's)")
    if lib_bwd is None:
        log(f"  dq+dk/dv {back:.4f} ms; aten flash backward not timed (no "
            f"such kernel on the CPU)")
    else:
        log(f"  yardstick aten flash backward (dq, dk and dv in one call): "
            f"{lib_bwd:.4f} ms; port dq+dk/dv {back:.4f} ms, "
            f"{back / lib_bwd:.2f}x aten's")
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: the AdamW kernels against their plain versions, then timed
# ---------------------------------------------------------------------------

def model_shapes(cfg) -> list:
    """The parameter shapes of the phase-4 model, in its order."""
    model = BertLarge(**cfg["model"], device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def world1_shard(shapes) -> int:
    """Elements of the world-1 ZeRO shard of f32 leaves of these shapes:
    the real count padded to its size bucket (parallel/zero.py)."""
    spec = build_spec([LeafMeta(s, F32) for s in shapes], 1, 0,
                      64 * 1024)
    return spec.groups[0].shard_elems


def adam_leaves(shapes, dtypes, device, seed) -> list:
    """[p, m, v, g] per leaf: p and g normal, m small, v small and >= 0."""
    gen = torch.Generator(device).manual_seed(seed)

    def draw(shape, scale=1.0, positive=False):
        fn = torch.rand if positive else torch.randn
        return scale * fn(shape, generator=gen, device=device)

    return [[draw(shape).to(dp), draw(shape, 1e-2).to(dm),
             draw(shape, 1e-4, True).to(dv), draw(shape).to(dg)]
            for shape, (dp, dm, dv, dg) in zip(shapes, dtypes)]


def mismatch(a, b) -> tuple:
    """(largest absolute difference, count of elements whose bits differ)."""
    return ((a.float() - b.float()).abs().max().item() if a.numel() else 0.0,
            int((a != b).sum()))


def check_adamw_multi(name, shapes, dtypes, device, steps=3) -> float:
    """The multi-tensor kernel over these leaves against the plain version
    on copies, ``steps`` steps; they must be bit-equal."""
    leaves = adam_leaves(shapes, dtypes, device, seed=len(name))
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    worst, differ = 0.0, 0
    for t in range(1, steps + 1):
        sc = fadam.adamw_scalars(t, **ADAMW)
        fadam.adamw_multi(*map(list, zip(*leaves)), sc, eps=EPS)
        for leaf in ref:
            leaf[:3] = fadam.adamw_leaf_reference(*leaf, sc, EPS)
        for got, want in zip(leaves, ref):
            for a, b in zip(got[:3], want[:3]):
                err, n = mismatch(a, b)
                worst, differ = max(worst, err), differ + n
    n_el = sum(leaf[0].numel() for leaf in leaves)
    combos = sorted({"/".join(dtype_name(d) for d in dt) for dt in dtypes})
    log(f"adamw_multi {name}: {len(leaves)} leaves, {n_el:,} elements, "
        f"dtypes (p/m/v/g) {combos}, {steps} steps: max|kernel-plain| "
        f"{worst:.3e}, {differ} elements differ")
    check(differ == 0, f"adamw_multi {name}: not bit-equal to the plain "
                       f"version ({differ} elements differ)")
    return worst


def flat_inputs(n, n_real, grad_dtype, device, seed, offset=0) -> list:
    """master, mu, nu (f32) and grad: random over the first ``n_real``
    elements, zeros over the bucket pad, as ZeRO lays a shard out. With
    ``offset``, each is a view ``offset`` * 16 bytes into a larger buffer
    (a shard that starts off any tile's boundary)."""
    out = []
    for dt in (F32, F32, F32, grad_dtype):
        skip = offset * 16 // torch.tensor([], dtype=dt).element_size()
        out.append(torch.zeros(skip + n, dtype=dt, device=device)[skip:])
    leaf = adam_leaves([(n_real,)], [(F32, F32, F32, F32)], device, seed)[0]
    for dst, src in zip(out, leaf):
        dst[:n_real] = src
    return out


def check_flat_adamw(name, n, n_real, grad_dtype, out_dtype, device,
                     steps=3, offset=0) -> float:
    """The flat kernel over one shard against the plain version on copies,
    ``steps`` steps; bit-equal. For float32 out the parameters it returns
    are master's storage; for bfloat16 a tensor of their own."""
    master, mu, nu, grad = flat_inputs(n, n_real, grad_dtype, device,
                                       seed=len(name) + n % 97,
                                       offset=offset)
    ref = [t.clone() for t in (master, mu, nu)]
    worst, differ = 0.0, 0
    for t in range(1, steps + 1):
        sc = fadam.adamw_scalars(t, **ADAMW)
        p, *_ = fopt.flat_adamw_shard(master, mu, nu, grad, sc, eps=EPS,
                                      out_dtype=out_dtype)
        check((p.data_ptr() == master.data_ptr()) == (out_dtype == F32),
              f"flat_adamw {name}: p {'is not' if out_dtype == F32 else 'is'}"
              f" master's storage (out {dtype_name(out_dtype)})")
        want = fopt.flat_adamw_reference(*ref, grad, sc, EPS, out_dtype)
        ref = list(want[1:])
        for a, b in zip((p, master, mu, nu), want):
            err, n_diff = mismatch(a, b)
            worst, differ = max(worst, err), differ + n_diff
        del want
    where = f", {offset * 16} bytes into its buffer" if offset else ""
    log(f"flat_adamw {name}: {n:,} elements ({n_real:,} real{where}), grad "
        f"{dtype_name(grad_dtype)}, out {dtype_name(out_dtype)}, {steps} "
        f"steps: max|kernel-plain| {worst:.3e}, {differ} elements differ; "
        f"p {'is' if out_dtype == F32 else 'is not'} master's storage")
    check(differ == 0, f"flat_adamw {name}: not bit-equal to the plain "
                       f"version ({differ} elements differ)")
    return worst


def free_memory(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_optimizer_kernels(cfg, device) -> dict:
    """Phase 2b's correctness half: every case bit-equal."""
    shapes = model_shapes(cfg)
    n_shard = world1_shard(shapes)
    n_real = sum(math.prod(s) for s in shapes)
    errs = {"adamw_multi": max(
        check_adamw_multi("model", shapes, [(F32,) * 4] * len(shapes),
                          device),
        check_adamw_multi("mixed", [(1000,), (7,), (131, 128), (2, 9)],
                          [(BF16, F32, F32, F32), (F32,) * 4, (F32,) * 4,
                           (BF16, BF16, BF16, BF16)], device))}
    free_memory(device)
    pairs = ((F32, F32), (BF16, BF16), (F32, BF16), (BF16, F32))
    errs["flat_adamw"] = 0.0
    for gd, od in pairs:  # every (grad, out) dtype pair at full size
        errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
            "world-1 shard", n_shard, n_real, gd, od, device))
        free_memory(device)
    # the ring's edges: whole tiles through the ring, the rest by plain
    # loads; a shard under one tile, under 4 elements, and off a tile's
    # boundary by 16 bytes
    tile = fopt.tile_elems() if device.type == "cuda" else 64
    edges = [("ragged", n, 0) for n in (1, 3, 127, 16385)]
    edges += [("tile edge", n, 0) for n in (tile - 4, tile, tile + 4,
                                             5 * tile + 3)]
    edges += [("offset", 3 * tile + 8, 1)]
    for what, n, offset in edges:
        for gd, od in pairs:
            errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
                what, n, n, gd, od, device, offset=offset))
    # the group shards P4 and P5 give it: one a distinct length of the
    # reduce-scatter plan's bucket layout at world 1, the most common one
    # in every dtype pair
    groups = bucket_spec(shapes).groups
    sizes = {g.shard_elems: g.n for g in groups}
    common = statistics.mode(g.shard_elems for g in groups)
    for n, real in sorted(sizes.items()):
        for gd, od in (pairs if n == common else pairs[:1]):
            errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
                "bucket group", n, real, gd, od, device))
        free_memory(device)
    return errs


def bucket_spec(shapes):
    """The world-1 layout of P4 and P5: one f32 group a bucket of the
    reduce-scatter plan (4 MiB buckets)."""
    metas = [LeafMeta(s, F32) for s in shapes]
    plan = hvd.GradReleasePlan(reduce_scatter=True)
    return build_spec(metas, 1, 0, 64 * 1024,
                      partition=plan.zero_partition(metas))


#: bytes a float32 group's element moves through B8: master, mu, nu and
#: grad read, master, mu and nu written (its parameters are its master)
FLAT_F32_BYTES = 28


def adamw_bound(n_elems: int, nbytes: int) -> dict:
    """Least time of an AdamW pass: the larger of its bytes over 3.35 TB/s
    and its 16 float32 operations per element over 67 TFLOP/s."""
    return roofline(16 * n_elems, nbytes, PEAK_F32)


def time_optimizers(cfg, device, iters) -> dict:
    """Each AdamW kernel at BERT-Large's shapes beside its bound, its plain
    version and ``torch.optim.AdamW(fused=True)`` over the same tensors (a
    yardstick the port never calls)."""
    shapes = model_shapes(cfg)
    hyper = dict(lr=ADAMW["learning_rate"], betas=(ADAMW["b1"], ADAMW["b2"]),
                 eps=EPS, weight_decay=ADAMW["weight_decay"])
    sc = fadam.adamw_scalars(1, **ADAMW)
    rows = {}

    leaves = adam_leaves(shapes, [(F32,) * 4] * len(shapes), device, seed=7)
    ps, ms, vs, gs = map(list, zip(*leaves))
    for p, g in zip(ps, gs):
        p.grad = g
    n = sum(p.numel() for p in ps)
    # on the card the timer replays the step in a CUDA graph
    hyper["capturable"] = device.type == "cuda"
    fused = torch.optim.AdamW(ps, fused=True, **hyper)
    foreach = torch.optim.AdamW(ps, foreach=True, **hyper)
    rows["adamw_multi"] = dict(
        ms=time_ms(lambda: fadam.adamw_multi(ps, ms, vs, gs, sc, eps=EPS),
                   iters, device),
        plain_ms=time_ms(lambda: [fadam.adamw_leaf_reference(*leaf, sc, EPS)
                                  for leaf in leaves], iters, device),
        library_ms=time_ms(fused.step, iters, device),
        foreach_ms=time_ms(foreach.step, iters, device),
        elems=n, tensors=len(ps), **adamw_bound(n, 28 * n))
    del leaves, ps, ms, vs, gs, fused, foreach
    free_memory(device)

    n_real = sum(math.prod(s) for s in shapes)
    n = world1_shard(shapes)
    master, mu, nu, grad = flat_inputs(n, n_real, F32, device, seed=8)
    master.grad = grad
    fused = torch.optim.AdamW([master], fused=True, **hyper)
    rows["flat_adamw"] = dict(
        ms=time_ms(lambda: fopt.flat_adamw_shard(master, mu, nu, grad, sc,
                                                 eps=EPS, out_dtype=F32),
                   iters, device),
        plain_ms=time_ms(lambda: fopt.flat_adamw_reference(
            master, mu, nu, grad, sc, EPS, F32), iters, device),
        library_ms=time_ms(fused.step, iters, device),
        elems=n, tensors=1, **adamw_bound(n, FLAT_F32_BYTES * n))
    del master, mu, nu, grad, fused
    free_memory(device)
    rows["flat_adamw_bucket"], groups_ms = time_bucket_adamw(
        shapes, hyper, sc, device, iters)
    log(f"timing the AdamW kernels at BERT-Large's shapes ({iters} calls "
        f"each):")
    for kname, r in rows.items():
        log(f"  {kname:12s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  torch fused AdamW "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['elems']:,} elements in {r['tensors']} "
            f"tensors, {r['bytes'] / 1e9:.3f} GB)  share of bound "
            f"{r['bound_ms'] / r['ms']:.3f}")
    log(f"  context: the phase-4 path's foreach AdamW step over the same "
        f"388 tensors {rows['adamw_multi']['foreach_ms']:.4f} ms")
    log(f"  flat_adamw over all {groups_ms['groups']} bucket groups of a "
        f"P4/P5 step ({groups_ms['elems']:,} elements): "
        f"{groups_ms['graph_ms']:.4f} ms as one CUDA graph, "
        f"{groups_ms['eager_ms']:.4f} ms launched eagerly (host clock, "
        f"synchronized), bound {groups_ms['bound_ms']:.4f} ms")
    return rows


def time_bucket_adamw(shapes, hyper, sc, device, iters) -> tuple:
    """B8 as P4 and P5 run it at world 1: one launch a group of the
    reduce-scatter plan's 4 MiB buckets. Times one launch at the most
    common group shard beside its bound, plain version and torch's fused
    AdamW, then one step's launches over every group: replayed as a CUDA
    graph, and eagerly with their host cost."""
    spec = bucket_spec(shapes)
    sizes = [g.shard_elems for g in spec.groups]
    n = statistics.mode(sizes)
    real = next(g.n for g in spec.groups if g.shard_elems == n)
    master, mu, nu, grad = flat_inputs(n, real, F32, device, seed=10)
    master.grad = grad
    fused = torch.optim.AdamW([master], fused=True, **hyper)
    row = dict(
        ms=time_ms(lambda: fopt.flat_adamw_shard(master, mu, nu, grad, sc,
                                                 eps=EPS, out_dtype=F32),
                   iters, device),
        plain_ms=time_ms(lambda: fopt.flat_adamw_reference(
            master, mu, nu, grad, sc, EPS, F32), iters, device),
        library_ms=time_ms(fused.step, iters, device),
        elems=n, tensors=1, **adamw_bound(n, FLAT_F32_BYTES * n))
    del master, mu, nu, grad, fused
    bufs = [flat_inputs(g.shard_elems, g.n, F32, device, seed=gi)
            for gi, g in enumerate(spec.groups)]

    def every_group():
        for b in bufs:
            fopt.flat_adamw_shard(*b, sc, eps=EPS, out_dtype=F32)

    total = sum(sizes)
    groups_ms = dict(groups=len(sizes), elems=total,
                     graph_ms=time_ms(every_group, max(1, iters // 4),
                                      device),
                     **adamw_bound(total, FLAT_F32_BYTES * total))
    every_group()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        every_group()
    if device.type == "cuda":
        torch.cuda.synchronize()
    groups_ms["eager_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    del bufs
    free_memory(device)
    return row, groups_ms


# ---------------------------------------------------------------------------
# Phase 2c: fused_adamw and sharded_adamw agree bit for bit at world 1
# ---------------------------------------------------------------------------


def fused_vs_zero(cfg, device, steps=2) -> None:
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    gen = torch.Generator(dev).manual_seed(9)
    shapes = model_shapes(cfg)
    a = {f"w{i}": torch.randn(s, generator=gen, device=dev)
         for i, s in enumerate(shapes)}
    b = {k: t.clone() for k, t in a.items()}
    grads = {k: torch.randn(t.shape, generator=gen, device=dev)
             for k, t in a.items()}
    fused = fadam.fused_adamw(1e-4)
    zero = hvd.sharded_adamw(1e-4)
    fs, zs = fused.init(a), zero.init(b)
    for step in range(steps):
        _, fs = fused.apply(a, fs, grads)
        _, zs = zero.apply(b, zs, grads)
        differ = sum(int((a[k] != b[k]).sum()) for k in a)
        log(f"fused_adamw vs sharded_adamw, world 1, step {step + 1}: "
            f"{len(a)} leaves, {differ} parameter elements differ")
        check(differ == 0, "fused_adamw and sharded_adamw disagree")
    del a, b, grads, fs, zs
    hvd.shutdown()
    free_memory(device)


# ---------------------------------------------------------------------------
# Phase 3: a tiny model on the card against the CPU
# ---------------------------------------------------------------------------


def tiny_model_check(cfg, device) -> None:
    seq, batch = cfg["tiny"]["max_seq"], cfg["tiny_batch"]
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg["tiny"]["vocab_size"], (batch, seq))
    pos = sample_masked_positions(np.random.default_rng(1), batch, seq, 8)
    labels = np.take_along_axis(tokens, pos, axis=1)
    m_dev = Transformer(**cfg["tiny"], device=device, seed=1)
    m_cpu = Transformer(**cfg["tiny"], device="cpu", seed=1)
    m_cpu.load_state_dict(m_dev.state_dict())
    out = {}
    for m, dev in ((m_dev, device), (m_cpu, torch.device("cpu"))):
        t = [torch.from_numpy(a).to(dev) for a in (tokens, pos, labels)]
        hidden = m(t[0], output="hidden")
        loss = masked_lm_loss_gathered(hidden, m.token_embed, t[1], t[2])
        loss.backward()
        out[dev.type] = (hidden.float().cpu(), loss.item(),
                         m.layers[0].attention.query.weight.grad.cpu())
    (h_dev, l_dev, g_dev), (h_cpu, l_cpu, g_cpu) = out[device.type], out["cpu"]
    errs = (rel(h_dev, h_cpu), abs(l_dev - l_cpu) / abs(l_cpu), rel(g_dev, g_cpu))
    log(f"tiny BERT on {device.type} vs cpu (bf16): hidden rel {errs[0]:.3e},"
        f" loss {l_dev:.5f} vs {l_cpu:.5f}, query-weight grad rel "
        f"{errs[2]:.3e}")
    check(math.isfinite(l_dev) and errs[0] <= 2e-2 and errs[1] <= 1e-2
          and errs[2] <= 5e-2, "tiny BERT on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# Phase 2d: kernel B10 (BN + ReLU) against its plain version, then timed
# ---------------------------------------------------------------------------


def bn_shapes(cfg, device) -> list:
    """The (N, C, H, W) input of each of Inception-V3's 94 fused batch
    norms, in call order, at the phase-6 batch and image size (one forward
    without gradients records them)."""
    inc = cfg["inception"]
    model = InceptionV3(num_classes=inc["classes"], dtype=inc["dtype"],
                        device=device)
    shapes = []
    for m in model.modules():
        if isinstance(m, cba.FusedBatchNormAct):
            m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape)))
    with torch.no_grad():
        model(torch.zeros(inc["batch"], inc["size"], inc["size"], 3,
                          device=device))
    del model
    free_memory(device)
    return shapes


def sba_inputs(shape, dtype, device, seed):
    """x channels-last (a conv output's layout), s and b per channel."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    return (x, torch.randn(c, generator=g, device=device),
            torch.randn(c, generator=g, device=device))


def check_sba(shapes, device) -> float:
    """B10 bit-equal to its plain version: every distinct BN input of the
    model in bf16, a few in f32, ragged channel counts and a 5-element
    tensor."""
    cases = [(s, BF16) for s in sorted(set(shapes))]
    cases += [(s, F32) for s in sorted(set(shapes))[:3]]
    cases += [((4, c, 5, 5), dt) for c in (3, 7, 1000) for dt in (BF16, F32)]
    cases += [((1, 5), BF16), ((1, 5), F32)]
    worst, differ = 0.0, 0
    for i, (shape, dt) in enumerate(cases):
        x, s, b = sba_inputs(shape, dt, device, seed=i)
        err, n = mismatch(cba.sba(x, s, b), cba.sba_plain(x, s, b))
        worst, differ = max(worst, err), differ + n
        check(n == 0, f"sba {shape} {dtype_name(dt)}: {n} elements differ "
                      f"from the plain version")
    log(f"sba: {len(cases)} cases ({len(set(shapes))} Inception-V3 BN "
        f"shapes in bf16, f32, C in 3/7/1000, 5 elements): max|kernel-plain|"
        f" {worst:.3e}, {differ} elements differ")
    return worst


def time_sba(shapes, device, repeats) -> dict:
    """B10 and its plain version over the 94 BN inputs of one forward
    (each shape as often as the model calls it), beside the bound (each
    call reads and writes its bf16 activation once and reads s and b, 8 C
    bytes, at 3.35 TB/s)."""
    inputs = {s: sba_inputs(s, BF16, device, seed=0) for s in set(shapes)}

    def forward(fn):
        return lambda: [fn(*inputs[s]) for s in shapes]

    row = dict(ms=time_ms(forward(cba.sba), repeats, device),
               plain_ms=time_ms(forward(cba.sba_plain), repeats, device),
               bound_ms=sum(1e3 * (4 * math.prod(s) + 8 * s[1]) / PEAK_BYTES
                            for s in shapes),
               bound_by="bytes", library_ms=None)  # no single torch call
    log(f"timing sba over one Inception-V3 forward ({len(shapes)} calls, "
        f"{len(inputs)} shapes, {repeats} repeats): kernel {row['ms']:.4f} ms"
        f"  plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f}"
        f" ms (bytes)  share of bound {row['bound_ms'] / row['ms']:.3f}")
    return row


# ---------------------------------------------------------------------------
# Phase 2e: kernel B11 (conv + BN statistics) through the probe
# ---------------------------------------------------------------------------


def run_probe(cfg, device) -> tuple:
    """The probe's measurement at each shape: B11 within the tool's limits
    of its plain version, then timed beside its bound, cuDNN's conv alone
    and conv plus a stats pass. Returns the tool's shape's row, the
    largest error of any output and the launches of the run."""
    probe.LAUNCHES["conv_bn_stats"] = 0
    rows, worst = [], 0.0
    for n, size, c in cfg["probe_shapes"]:
        r = probe.measure(n, size, c, c, device, cfg["probe_iters"])
        e = r["err"]
        worst = max(worst, e["y"], e["sum"], e["sumsq"])
        log(f"conv_bn_stats {r['shape']}: max|kernel-plain| y {e['y']:.3e} "
            f"sum {e['sum']:.3e} sumsq {e['sumsq']:.3e} (limits y 2e-2 "
            f"rel+abs, sum 1e-2 rel + 2.0, sumsq 1e-2 rel); a second call "
            f"bit-equal: {e['repeat_equal']}")
        check(e["ok"], f"conv_bn_stats {r['shape']}: outside the limits")
        check(e["repeat_equal"], f"conv_bn_stats {r['shape']}: a second "
                                 f"call gave other bits")
        if device.type == "cuda":
            log(f"  kernel {r['ms']:.4f} ms (MFU {r['mfu']:.4f}, share of "
                f"bound {r['bound_ms'] / r['ms']:.3f})  plain "
                f"{r['plain_ms']:.4f} ms  cuDNN conv alone {r['conv_ms']:.4f}"
                f" ms (MFU {r['conv_mfu']:.4f}; kernel "
                f"{r['ms'] / r['conv_ms']:.2f}x)  conv + stats pass "
                f"{r['conv_stats_ms']:.4f} ms (kernel "
                f"{r['ms'] / r['conv_stats_ms']:.2f}x)  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB)")
        rows.append(r)
    tool = next((r for r in rows if r["shape"].startswith(
        f"{probe.BATCH}x{probe.SIZE}x")), rows[0])
    return dict(tool, library_ms=tool["conv_ms"]), worst, \
        probe.LAUNCHES["conv_bn_stats"]


# ---------------------------------------------------------------------------
# Phase 2f: the fused backward B7 against its plain version and dq + dk/dv
# ---------------------------------------------------------------------------


def fused_bound(case) -> dict:
    """B7's :func:`roofline`: its five products of 2 Sq Sk D over the
    unmasked pairs, against the bf16 tensors q, do, dq (Sq rows) and k, v,
    dk, dv (Sk rows) and the float32 rows lse, delta (Sq)."""
    b, h, sq, sk, d, causal, q_off, k_off = case
    bh = b * h
    flops = 10 * bh * unmasked_pairs(sq, sk, causal, q_off, k_off) * d
    return roofline(flops, 2 * bh * d * (3 * sq + 4 * sk) + 8 * bh * sq)


def check_fused(name, case, device) -> float:
    """B7 on bf16 inputs against its plain version on float32 copies (with
    the plain forward's lse and delta) and against the dq and dk/dv kernels
    on the same inputs: dq, dk, dv within 2e-2 relative to their norm, dq
    exactly 0 on fully masked rows, and a second call bit-equal to the
    first. Returns the largest absolute error against the plain version."""
    q, k, v, do = make_inputs(case, device, seed=len(name) + 10)
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    got = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    again = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    two = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    if device.type == "cuda":
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_fwd_reference(*f[:3], **kw)
    ref = fa.flash_bwd_fused_reference(
        *f, lse_ref, fa.compute_delta(o_ref.float(), f[3]), **kw)
    names = ("dq", "dk", "dv")
    err_ref = [rel(a, b) for a, b in zip(got, ref)]
    err_two = [rel(a, b.float()) for a, b in zip(got, two)]
    worst = max((a.float() - b).abs().max().item() for a, b in zip(got, ref))
    masked = ~torch.isfinite(lse_ref)
    b, h, sq, sk, d, causal, q_off, k_off = case
    log(f"fused case {name} B{b} H{h} Sq{sq} Sk{sk} D{d} causal={causal} "
        f"q_offset={q_off} k_offset={k_off}: rel to plain "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(names, err_ref))
        + "; rel to dq + dk/dv "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(names, err_two))
        + f"; fully masked rows {int(masked.sum())}; a second call "
        f"bit-equal: {same}")
    check(same, f"fused case {name}: a second call gave other bits")
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"fused case {name}: non-finite gradient")
    check(bool((got[0][masked] == 0).all()),
          f"fused case {name}: fully masked rows must get dq 0")
    for n, e1, e2 in zip(names, err_ref, err_two):
        check(e1 <= TOL["grad"] and e2 <= TOL["grad"],
              f"fused case {name}: {n} error {e1} (plain), {e2} (dq + dk/dv)")
    return worst


def aten_flash_backward(q, k, v, do, kw):
    """PyTorch's one-call flash attention backward on these inputs (its own
    forward's output and lse), as a function of no argument: a yardstick
    the port never calls. None on the CPU, which has no such kernel."""
    if q.device.type != "cuda":
        return None
    out = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, kw["causal"], False, scale=kw["sm_scale"])
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out[0], out[1], out[2], out[3], out[4], out[5], 0.0,
        kw["causal"], out[6], out[7], scale=kw["sm_scale"])


def time_fused(name, case, device, iters) -> dict:
    """B7 timed beside its bound, its plain version, the
    dq and dk/dv kernels (one call of each, summed) and PyTorch's flash
    attention backward."""
    q, k, v, do = make_inputs(case, device, seed=len(name) + 10)
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    args = (q, k, v, do, lse, delta)
    lib = aten_flash_backward(q, k, v, do, kw)
    row = dict(
        ms=time_ms(lambda: fa.flash_bwd_fused(*args, **kw), iters, device),
        plain_ms=time_ms(lambda: fa.flash_bwd_fused_reference(*args, **kw),
                         iters, device),
        two_ms=time_ms(lambda: (fa.flash_bwd_dq(*args, **kw),
                                fa.flash_bwd_dkv(*args, **kw)), iters, device),
        library_ms=time_ms(lib, iters, device) if lib else None,
        **fused_bound(case))
    lib_s = (f"{row['library_ms']:.4f} ms (B7 "
             f"{row['ms'] / row['library_ms']:.2f}x)" if lib
             else "not timed (no such kernel on the CPU)")
    log(f"timing fused case {name} ({iters} calls each in a CUDA graph): B7 "
        f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  dq + dk/dv "
        f"{row['two_ms']:.4f} ms (B7 {row['ms'] / row['two_ms']:.2f}x)  aten "
        f"flash backward {lib_s}  bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"{row['flops'] / 1e9:.2f} GFLOP, {row['bytes'] / 1e6:.1f} MB)  "
        f"share of bound {row['bound_ms'] / row['ms']:.3f}")
    return row


# ---------------------------------------------------------------------------
# Phase 2g: the probe kernels B12-B14 through the flash_vpu_probe module
# ---------------------------------------------------------------------------


#: the probes' data: (name, scale of q, k and v), each drawn with
#: ``RandomState(0)``. At the tool's scale of 0.3 the scores have a std of
#: ~0.09 and the softmax is nearly uniform; at unit scale it is peaked.
VPROBE_DATA = (("tool", 0.3), ("unit", 1.0))


def probe_inputs(b, h, s, d, scale, device) -> list:
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)
                             * scale).to(device, BF16) for _ in range(3)]


def o_errors(got, want) -> tuple:
    """(largest absolute error, error relative to the norm of ``want``)."""
    return (got.float() - want).abs().max().item(), rel(got, want)


def check_probes(data, q, k, v, sm) -> dict:
    """B12, B13 and B14 on bf16 ``q, k, v`` against their plain versions on
    float32 copies: o within ``TOL["o"]`` abs and ``TOL["o_rel"]`` relative
    to its norm, lse within ``TOL["lse"]`` abs. Two outputs a wrong kernel
    could give, attention that weights every key alike (v averaged over
    the keys) and the plain version at half the sm_scale, must be off by
    more than ``TOL["o_rel"]``, or the check could not tell them from the
    right one. Returns the largest absolute error of each kernel."""
    b, h, s, d = q.shape
    f = [t.float() for t in (q, k, v)]
    o_ref, lse_ref = vprobe.simple1_reference(*f, sm)
    controls = {"uniform attention": f[2].mean(2, keepdim=True)
                .expand_as(o_ref),
                "half sm_scale": vprobe.simple1_reference(*f, sm / 2)[0]}
    for cname, c in controls.items():
        e = rel(c, o_ref)
        log(f"probe data {data}: control {cname} is off by {e:.3e} relative "
            f"(must exceed {TOL['o_rel']})")
        check(e > TOL["o_rel"], f"probe data {data}: the {cname} control "
                                f"passes the o limit ({e:.3e})")
    q2, k2, v2 = vprobe.pack(q, k, v)
    errs = {}
    for name in vprobe.PROBES:
        err_lse = None
        if name == "pack2":
            o2 = vprobe.pack2_fwd(q2, k2, v2, sm)
            want = vprobe.pack2_reference(q2.float(), k2.float(), v2.float(),
                                          sm)
            # packed against the packed plain version, and unpacked against
            # the heads' own attention
            err_o = [max(a, b_) for a, b_ in zip(
                o_errors(o2, want),
                o_errors(o2.reshape(b, h // 2, 2, s, d).reshape(b, h, s, d),
                         o_ref))]
        else:
            o, lse = vprobe.simple1_fwd(q, k, v, sm, name == "simple1_lse")
            err_o = o_errors(o, o_ref)
            if lse is not None:
                err_lse = (lse - lse_ref).abs().max().item()
        errs[name] = max(err_o[0], err_lse or 0.0)
        lse_s = "" if err_lse is None else f"  max|lse-ref| {err_lse:.3e}"
        log(f"probe {name} B{b} H{h} S{s} D{d}, {data} data: max|o-ref| "
            f"{err_o[0]:.3e}, relative {err_o[1]:.3e}{lse_s} (limits o "
            f"{TOL['o']} abs and {TOL['o_rel']} relative, lse {TOL['lse']})")
        check(err_o[0] <= TOL["o"] and err_o[1] <= TOL["o_rel"],
              f"probe {name}, {data} data: o error {err_o}")
        check(err_lse is None or err_lse <= TOL["lse"],
              f"probe {name}, {data} data: lse error {err_lse}")
    return errs


def run_vprobe(cfg, device, iters) -> tuple:
    """B12, B13 and B14 at ``cfg["vprobe_case"]`` checked on each of
    :data:`VPROBE_DATA` (:func:`check_probes`), then, on the tool's data,
    each probe function driven once with the counts set to 0 just before
    (the launches of the kernels line) and each kernel timed beside its
    bound (4 S^2 D useful FLOPs per head against its own inputs and
    outputs) and SDPA's forward. Returns (rows, largest errors,
    launches)."""
    b, h, s, d = cfg["vprobe_case"]
    sm = d ** -0.5
    errs = {}
    for data, scale in VPROBE_DATA:
        for name, e in check_probes(
                data, *probe_inputs(b, h, s, d, scale, device), sm).items():
            errs[name] = max(errs.get(name, 0.0), e)
    q, k, v = probe_inputs(b, h, s, d, VPROBE_DATA[0][1], device)
    q2, k2, v2 = vprobe.pack(q, k, v)
    calls = {"simple1": lambda: vprobe.simple1_fwd(q, k, v, sm, False),
             "simple1_lse": lambda: vprobe.simple1_fwd(q, k, v, sm, True),
             "pack2": lambda: vprobe.pack2_fwd(q2, k2, v2, sm)}

    vprobe.reset_launch_counts()  # the probe's own entry points, once each
    for fn in (vprobe.pack2_attention, vprobe.simple1_attention,
               vprobe.simple1_lse_attention):
        fn(q, k, v, sm)
    launches = dict(vprobe.LAUNCHES)
    log(f"probe functions driven once each: kernel launches {launches}")
    if device.type == "cuda":
        check(launches == dict.fromkeys(vprobe.PROBES, 1),
              f"probe launches {launches}, want one of each")

    useful = 4 * b * h * s * s * d
    mat = 2 * b * h * s * d  # bytes of one (B, H, S, D) bf16 tensor
    sdpa_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=sm), iters, device)
    plain = {"simple1": lambda: vprobe.simple1_reference(q, k, v, sm),
             "simple1_lse": lambda: vprobe.simple1_reference(q, k, v, sm),
             "pack2": lambda: vprobe.pack2_reference(q2, k2, v2, sm)}
    nbytes = {"simple1": 4 * mat, "simple1_lse": 4 * mat + 4 * b * h * s,
              "pack2": 2 * (q2.numel() + k2.numel() + v2.numel()) + mat}
    rows = {}
    for name, call in calls.items():
        rows[name] = dict(ms=time_ms(call, iters, device),
                          plain_ms=time_ms(plain[name], iters, device),
                          library_ms=sdpa_ms,
                          **roofline(useful, nbytes[name]))
    rows["pack2"]["executed_flops"] = 3 * useful // 2
    pack_ms = time_ms(lambda: vprobe.pack2_attention(q, k, v, sm), iters,
                      device)
    log(f"timing the probe kernels B{b} H{h} S{s} D{d} ({iters} calls "
        f"each in a CUDA graph; SDPA forward {sdpa_ms:.4f} ms):")
    for name, r in rows.items():
        log(f"  {name:12s} kernel {r['ms']:.4f} ms ({r['ms'] / sdpa_ms:.2f}x "
            f"SDPA's)  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['flops'] / 1e9:.2f} GFLOP useful, "
            f"{r['bytes'] / 1e6:.1f} MB)  share of bound "
            f"{r['bound_ms'] / r['ms']:.3f}")
    log(f"  pack2 executes {rows['pack2']['executed_flops'] / 1e9:.2f} GFLOP "
        f"(1.5x the useful work: the zero half of q2 k2^T); pack2_attention "
        f"with the torch packing {pack_ms:.4f} ms")
    return rows, errs, launches


# ---------------------------------------------------------------------------
# Phase 3b: a small Inception-V3 on the card against the CPU
# ---------------------------------------------------------------------------


#: each mixed block: its input channels in Inception-V3, its arguments
BLOCKS = (("InceptionA", 192, (32,)), ("InceptionB", 288, ()),
          ("InceptionC", 768, (128,)), ("InceptionD", 768, ()),
          ("InceptionE", 1280, ()))


def block_train_check(cfg, device) -> None:
    """Each mixed block alone in train mode, float32, on non-negative
    channels-last inputs of ``cfg["block_input"]`` batch and size, (4, C,
    9, 9) on the card, the card against the CPU with the
    same weights: the output, the gradient of x, the worst parameter
    gradient leaf and the worst running-statistics leaf, each within 1e-3
    of its norm. A block is a few layers deep: train mode does not
    amplify rounding there as it does through the whole model."""
    batch, size = cfg["block_input"]
    for name, cin, args in BLOCKS:
        gen = torch.Generator().manual_seed(cin)
        cpu = getattr(inc, name)(cin, *args, dtype=F32, device="cpu")
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, inc.Conv):
                    inc._variance_scaling_(m.kernel, 1.0,
                                                 m.kernel[0].numel(), gen)
        x = torch.randn(batch, cin, size, size, generator=gen).abs() \
            .contiguous(memory_format=torch.channels_last)
        out, masks = {}, {}
        for m, dev in ((copy.deepcopy(cpu).to(device), device),
                       (cpu, torch.device("cpu"))):
            masks[dev.type] = {}
            hooks = _relu_masks(m, masks[dev.type])
            xt = x.to(dev).detach().requires_grad_()
            y = m.train()(xt)
            for h in hooks:
                h.remove()
            y.backward(torch.randn(y.shape, generator=torch.Generator()
                                   .manual_seed(1)).to(dev))
            out[dev.type] = (y.detach().cpu(), xt.grad.cpu(),
                             {k: p.grad.cpu() for k, p in
                              m.named_parameters()},
                             {k: b.cpu() for k, b in m.named_buffers()})
        (ya, ga, pa, ba), (yb, gb, pb, bb) = out[device.type], out["cpu"]
        errs = (rel(ya, yb), rel(ga, gb), max(rel(pa[k], pb[k]) for k in pb),
                max(rel(ba[k], bb[k]) for k in bb))
        flips, n_mask = _masks_differ(masks[device.type], masks["cpu"])
        log(f"{name} train mode on {device.type} vs cpu (f32, {batch} x "
            f"{cin} x {size} x {size}): output rel {errs[0]:.3e}, x grad "
            f"{errs[1]:.3e}, worst parameter grad {errs[2]:.3e}, worst "
            f"running stat {errs[3]:.3e}; "
            f"ReLU mask elements that differ: {flips} of {n_mask}")
        check(max(errs) <= 1e-3,
              f"{name} in train mode on the card disagrees with the CPU")
        free_memory(device)


def _tree_rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return math.sqrt(num / max(sum(float((b[k] ** 2).sum()) for k in b),
                               1e-30))


def _relu_masks(model, masks: dict) -> list:
    """Hooks that keep each fused BN's ReLU mask (output > 0) in ``masks``
    by module name; returns their handles."""
    return [m.register_forward_hook(
        lambda mod, i, o, n=n: masks.__setitem__(n, (o > 0).cpu()))
        for n, m in model.named_modules()
        if isinstance(m, cba.FusedBatchNormAct)]


def _masks_differ(a: dict, b: dict) -> tuple:
    """(mask elements that differ, mask elements in all)."""
    return (sum(int((a[k] != b[k]).sum()) for k in b),
            sum(b[k].numel() for k in b))


def tiny_inception_check(cfg, device) -> None:
    """A small Inception-V3 (``cfg["tiny_inception"]`` batch and size,
    float32, 10 classes) on the card against the same weights on the CPU,
    with the ReLU mask elements that differ between the two counted: a
    ReLU whose input lies within rounding of 0 takes the other branch on
    one side, and in a small late layer one such element moves the
    gradient below it by about 1/sqrt(half the layer's size). Eval mode
    (the initial running statistics normalise): logits and loss within
    1e-3, the whole gradient within 1e-2. Train mode at flax's
    initialisation is chaotic in float32 through the 94 layers (one ulp of
    input moves the CPU's own gradients by percents at any batch): logits,
    loss and the whole gradient within twice what one ulp of input moves
    the CPU's own (or 1e-3, where that is looser). Then each mixed block
    in train mode at a fixed limit."""
    batch, size = cfg["tiny_inception"]
    rng = np.random.RandomState(1)
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = torch.from_numpy(rng.randint(0, 10, (batch,)))
    m_dev = InceptionV3(num_classes=10, dtype=F32, device=device, seed=1)
    m_cpu = InceptionV3(num_classes=10, dtype=F32, device="cpu", seed=1)
    start = {k: v.clone() for k, v in m_cpu.state_dict().items()}
    runs = [("card", m_dev, device, images),
            ("cpu", m_cpu, torch.device("cpu"), images)]
    for train in (False, True):
        if train:  # what one ulp of input moves the CPU's own result
            runs.append(("nudged", m_cpu, torch.device("cpu"),
                         np.nextafter(images, np.float32(np.inf))))
        out, masks = {}, {}
        for key, m, dev, x in runs:
            m.load_state_dict(start)
            m.train(train)
            m.zero_grad()
            masks[key] = {}
            hooks = _relu_masks(m, masks[key])
            logits = m(torch.from_numpy(x).to(dev))
            for h in hooks:
                h.remove()
            loss = torch.nn.functional.cross_entropy(logits, labels.to(dev))
            loss.backward()
            out[key] = (logits.detach().cpu(), loss.item(),
                        {k: p.grad.cpu() for k, p in m.named_parameters()})
        (a, la, ga), (b, lb, gb) = out["card"], out["cpu"]
        errs = (rel(a, b), abs(la - lb) / abs(lb), _tree_rel(ga, gb))
        limits, mode, ulp_note = (1e-3, 1e-3, 1e-2), "eval", ""
        if train:
            c, lc, gc = out["nudged"]
            ulp = (rel(c, b), abs(lc - lb) / abs(lb), _tree_rel(gc, gb))
            limits = tuple(max(1e-3, 2 * u) for u in ulp)
            mode = "train"
            ulp_note = (f" (one ulp of input on the cpu: {ulp[0]:.3e} "
                        f"{ulp[1]:.3e} {ulp[2]:.3e})")
        flips, n_mask = _masks_differ(masks["card"], masks["cpu"])
        log(f"tiny Inception-V3 {batch} x {size}^2 on {device.type} vs cpu "
            f"(f32, {mode}): logits rel {errs[0]:.3e}, loss {la:.5f} vs "
            f"{lb:.5f} (rel {errs[1]:.3e}), gradient rel {errs[2]:.3e}; "
            f"limits {limits[0]:.3e} {limits[1]:.3e} {limits[2]:.3e}"
            f"{ulp_note}; ReLU mask elements that differ: {flips} of "
            f"{n_mask}")
        check(math.isfinite(la) and all(bool(torch.isfinite(g).all())
                                        for g in ga.values()),
              "small Inception-V3: non-finite loss or gradient on the card")
        check(all(e <= t for e, t in zip(errs, limits)),
              f"small Inception-V3 on the card disagrees with the CPU "
              f"({mode} mode)")
    del m_dev, m_cpu
    free_memory(device)
    block_train_check(cfg, device)


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


RUNTIME_KEYS = ("allreduce", "reducescatter", "allgather", "broadcast",
                "responses", "cache_hits", "slabs", "groups", "busy_cycles",
                "cycle_ms")


def runtime_steps(snaps: list) -> dict:
    """Per-step deltas of ``runtime.COUNTS`` from snapshots taken before
    the first step and after each one."""
    return {k: [b[k] - a[k] for a, b in zip(snaps, snaps[1:])]
            for k in RUNTIME_KEYS}


def log_runtime(label: str, per_step: dict) -> None:
    """What the runtime issued a step: collectives per kind, responses
    (a fused bin is one), response-cache hits, fusion slabs and process
    groups created, and the cycles' host ms."""
    log(f"  runtime per step ({label}):")
    for k in RUNTIME_KEYS:
        vals = per_step[k]
        text = (" ".join(f"{v:.1f}" for v in vals) if k == "cycle_ms"
                else " ".join(str(int(v)) for v in vals))
        log(f"    {k:13s} {text}")


def check_hooks_runtime(cfg, per_step: dict, n_tensors: int,
                        threshold: int, card: bool,
                        card_limit: float = None) -> None:
    """The hooks' runtime checks (phases 4 and 8): every step after the
    first answered every gradient from the response cache, and no fusion
    slab or process group appeared after the warm-up steps; at threshold 0
    one allreduce a tensor every step; fused (the default threshold), on
    the card, fewer allreduces a step after the first than ``card_limit``
    (a quarter of the tensors by default) (on the CPU rehearsal the host's
    speed sets how many cycles a backward spans, so there only at most one
    a tensor)."""
    ar, warm = per_step["allreduce"], cfg["warmup"]
    if threshold == 0:
        check(all(n == n_tensors for n in ar),
              f"threshold 0: {ar} allreduces a step, want {n_tensors}")
    else:
        if card_limit is None:
            card_limit = n_tensors / 4
        limit = card_limit if card else n_tensors + 1
        check(all(n < limit for n in ar[1:]),
              f"fused: {ar} allreduces a step, want < {limit}")
    hits = per_step["cache_hits"]
    check(all(h == n_tensors for h in hits[1:]),
          f"cache hits a step {hits}, want {n_tensors} after the first")
    for k in ("slabs", "groups"):
        check(not any(per_step[k][warm:]),
              f"new {k} after warm-up: {per_step[k]}")


PATHS = {  # phase 4 and the optimizer paths of phase 5
    "hooks": "DistributedOptimizer(torch.optim.AdamW), per-parameter hooks",
    "fused": "P1: allreduce_gradients + fused_adamw (multi-tensor kernel)",
    "zero": "P2: ZeRO-1 sharded_adamw (reduce-scatter, flat kernel, "
            "allgather)",
    "sharded": "P3: DistributedOptimizer(AdamW, shard_optimizer_states=True)"
               " (sharded_update: torch AdamW over the flat shard)",
    "zero2": "P4: ZeRO-2 GradReleasePlan(reduce_scatter=True) + "
             "sharded_adamw(partition=plan.zero_partition) through "
             "make_train_step (flat kernel a bucket group)",
    "zero3": "P5: ZeRO-3 shard_params, iter_param_buckets refill before the "
             "forward, the reduce-scatter plan, apply returning "
             "ShardedParams",
}
# the ZeRO paths whose every collective is named: from the second step the
# runtime answers all of them from its response cache
ZERO_PATHS = ("zero", "sharded", "zero2", "zero3")


def mlm_data(cfg):
    """The bench's MLM batch (bench.py:453-460)."""
    batch, seq = cfg["batch"], cfg["seq"]
    n_pred = max(1, round(0.15 * seq))  # 76 at seq 512 (BERT's layout)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg["model"]["vocab_size"],
                         (batch, seq)).astype(np.int32)
    rng.rand(batch, seq)  # the bench's unused full-logits mask draw
    positions = sample_masked_positions(np.random.default_rng(0), batch, seq,
                                        n_pred)
    labels = np.take_along_axis(tokens, positions, axis=1)
    return tokens, positions, labels, n_pred


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Hidden(torch.nn.Module):
    """BERT's trunk as ``make_train_step`` calls a model, ``model(tokens)``:
    the hidden states the bench's gathered MLM head reads."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens):
        return self.model(tokens, output="hidden")


def adamw_optimizer(model, sharded: bool = False):
    """``DistributedOptimizer(AdamW)`` as the bench builds it
    (bench.py:473-476): the hooks, or ``shard_optimizer_states``."""
    return hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        shard_optimizer_states=sharded)


def make_step(path, model, params, dev, batch):
    """One path's training step (``step() -> loss``) and what it holds (a
    callable giving bytes of optimizer state, gradient shards and
    parameter shards on the card, and for P5 the stage-3 gather's hidden
    share)."""
    toks, pos, lab = batch
    names = list(params)

    def loss_of(hidden):
        return masked_lm_loss_gathered(hidden, model.token_embed, pos, lab)

    def plain_step(zero_grad, update):
        def step():
            zero_grad()
            loss = loss_of(model(toks, output="hidden"))
            loss.backward()
            update()
            return loss.detach()
        return step

    if path in ("hooks", "sharded"):
        opt = adamw_optimizer(model, path == "sharded")

        def held():
            if path == "hooks":
                return dict(state=nbytes(
                    t for st in opt.state.values() for t in st.values()
                    if isinstance(t, torch.Tensor) and t.device == dev))
            inner = opt.state.inner
            shards = inner.param_groups[0]["params"]
            return dict(state=nbytes(t for st in inner.state.values()
                                     for t in st.values()
                                     if isinstance(t, torch.Tensor)
                                     and t.ndim),
                        grad_shards=nbytes(shards), param_shards=nbytes(shards))

        return plain_step(opt.zero_grad, opt.step), held
    if path in ("fused", "zero"):
        tx = fadam.fused_adamw(1e-4) if path == "fused" \
            else hvd.sharded_adamw(1e-4)
        box = [tx.init(params)]

        def update():
            grads = {k: params[k].grad for k in names}
            if path == "fused":  # as bench.py:543-546 does it
                grads = hvd.allreduce_gradients(grads, average=True)
            _, box[0] = tx.apply(params, box[0], grads)

        def held():
            st = box[0]
            if path == "fused":
                return dict(state=nbytes(list(st.mu.values())
                                         + list(st.nu.values())))
            return dict(state=nbytes([*st.master, *st.mu, *st.nu]),
                        grad_shards=nbytes(st.master))

        return plain_step(lambda: model.zero_grad(set_to_none=True),
                          update), held
    plan = hvd.GradReleasePlan(reduce_scatter=True)
    part = plan.zero_partition(params)
    tx = hvd.sharded_adamw(1e-4, partition=part)
    if path == "zero2":
        train_step = make_train_step(_Hidden(model), tx,
                                     loss_fn=lambda hidden, _: loss_of(hidden),
                                     grad_release=plan)

        def held():  # f32 groups: master, mu and nu as long as a shard
            groups = plan._ensure_zspec().groups
            g_bytes = sum(g.shard_elems * 4 for g in groups)
            return dict(state=3 * g_bytes, grad_shards=g_bytes,
                        groups=len(groups))

        return (lambda: train_step(toks, None)), held
    # zero3: the parameters at rest are the shards; the model's tensors are
    # refilled group by group before each forward
    box = {"sp": hvd.shard_params(params, partition=part)}
    box["state"] = tx.init(box["sp"])
    leaves = list(params.values())

    def step():
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for _, bucket in hvd.iter_param_buckets(box["sp"]):
                for i, t in bucket.items():
                    leaves[i].copy_(t)
        plan.tag(params)
        loss = loss_of(model(toks, output="hidden"))
        loss.backward()
        sg = plan.gather()
        box["sp"], box["state"] = tx.apply(box["sp"], box["state"], sg)
        return loss.detach()

    def held():
        st = box["state"]
        return dict(state=nbytes([*st.master, *st.mu, *st.nu]),
                    grad_shards=nbytes(st.master),
                    param_shards=nbytes(box["sp"].shards),
                    groups=len(st.spec.groups),
                    hidden=zero_mod.gather_hidden_fraction())

    return step, held


def train(cfg, device, card, path="hooks", profile=False,
          threshold=None) -> dict:
    """Drive one path of the slice: 2 warm-up and 10 timed steps of
    BERT-Large MLM from seed-0 weights. Returns the losses, the kernel
    launches of the run (every count is set to 0 just before it) and what
    the runtime issued a step. ``threshold`` sets
    ``HOROVOD_FUSION_THRESHOLD`` for the run (0: one allreduce a tensor)."""
    if threshold is None:
        return _train(cfg, device, card, path, profile)
    os.environ[env.HOROVOD_FUSION_THRESHOLD] = str(threshold)
    try:
        return _train(cfg, device, card, path, profile, threshold)
    finally:
        os.environ.pop(env.HOROVOD_FUSION_THRESHOLD, None)


def _train(cfg, device, card, path, profile, threshold=None,
           before_shutdown=None) -> dict:
    batch, seq = cfg["batch"], cfg["seq"]
    vocab = cfg["model"]["vocab_size"]
    tokens, positions, labels, n_pred = mlm_data(cfg)

    for counts in (fa.LAUNCHES, fadam.LAUNCHES, fopt.LAUNCHES,
                   collectives.COUNTS):
        counts.update(dict.fromkeys(counts, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = BertLarge(**cfg["model"], device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = dict(model.named_parameters())
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    n_broadcast = len(model.state_dict())
    step, held = make_step(path, model, params, dev, (toks, pos, lab))
    n_tensors = len(params)
    n_params = sum(p.numel() for p in params.values())
    n_layers = len(model.layers)
    n_groups = len({p.dtype for p in params.values()})
    d_model = model.token_embed.shape[1]
    zero_mod.GATHER_SECONDS.update(stall=0.0, hidden=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    losses, times, snaps = [], [], [dict(hrt.COUNTS)]
    b8 = []
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        before = fopt.LAUNCHES["flat_adamw"]
        loss = step()
        losses.append(loss.item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
        b8.append(fopt.LAUNCHES["flat_adamw"] - before)
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = {**fa.LAUNCHES, **fadam.LAUNCHES, **fopt.LAUNCHES}
    counts = dict(collectives.COUNTS)
    kept = held()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if profile:
        breakdown(step, dev, statistics.median(times), cfg["profile_steps"])
    if before_shutdown is not None:
        before_shutdown()
    del model, params, held, step
    hvd.shutdown()
    free_memory(device)

    label = path if threshold is None else f"{path}, fusion threshold " \
                                              f"{threshold}"
    log(f"slice ({label}: {PATHS[path]}): BERT-Large MLM, {n_layers} layers, "
        f"{n_params / 1e6:.1f}M params in {n_tensors} tensors, batch {batch} "
        f"x seq {seq}, {cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    log(f"  flat AdamW (B8) launches a step: {' '.join(map(str, b8))}")
    issued = runtime_steps(snaps)
    log_runtime(label, issued)
    if path == "hooks":
        check_hooks_runtime(cfg, issued, n_tensors,
                            env.DEFAULT_FUSION_THRESHOLD_BYTES
                            if threshold is None else threshold,
                            dev.type == "cuda")
    if path in ZERO_PATHS:
        check_zero_runtime(cfg, path, issued)
    check(all(math.isfinite(x) for x in losses), f"{path}: non-finite loss")
    check(losses[-1] < losses[0], f"{path}: loss did not fall: {losses}")
    g = kept.get("groups", n_groups)  # P4, P5: one group a bucket
    per_step = {  # collectives and optimizer launches each path must issue
        "hooks": (dict(allreduce=n_tensors), {}),
        "fused": (dict(allreduce=n_tensors), {"adamw_multi": 1}),
        "zero": (dict(reducescatter=n_groups, allgather=n_groups),
                 {"flat_adamw": n_groups}),
        "sharded": (dict(reducescatter=n_groups, allgather=n_groups), {}),
        "zero2": (dict(reducescatter=g, allgather=g), {"flat_adamw": g}),
        "zero3": (dict(reducescatter=g, allgather=g), {"flat_adamw": g}),
    }[path]
    want = {k: steps * per_step[0].get(k, 0) for k in counts}
    want["broadcast"] = n_broadcast
    check(counts == want, f"{path}: collectives {counts}, want {want}")
    if dev.type == "cuda":
        want_launches = {k: steps * per_step[1].get(k, 0) for k in launches}
        want_launches.update(dict.fromkeys(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), n_layers * steps))
        check(launches == want_launches,
              f"{path}: kernel launches {launches}, want {want_launches}")
    step_s = statistics.median(times)
    # FLOPs/token as bench.py:497-503 counts them (gathered MLM head)
    n_embed = vocab * d_model
    n_eff = n_params - n_embed + n_embed * n_pred // seq
    flops_per_token = 6 * n_eff + 12 * n_layers * seq * d_model
    tok_s = batch * seq / step_s
    where = f"({card})"
    shard_text = ", ".join(f"{k.replace('_', ' ')} {kept[k] / 2**30:.3f} GiB"
                           for k in ("state", "grad_shards", "param_shards")
                           if k in kept)
    if "hidden" in kept:
        log(f"  stage-3 gather: hidden share {kept['hidden']:.3f} "
            f"(host seconds: stall {zero_mod.GATHER_SECONDS['stall']:.4f}, "
            f"hidden {zero_mod.GATHER_SECONDS['hidden']:.4f}); "
            f"{g} groups")
    if dev.type == "cuda":
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  tokens/s {tok_s:.1f} {where}")
        log(f"  MFU {tok_s * flops_per_token / PEAK_FLOPS:.4f} against "
            f"989 TFLOP/s bf16, {flops_per_token / 1e9:.3f} GFLOP/token "
            f"{where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB; held on the "
            f"card: {shard_text} {where}")
    else:
        log(f"  held: {shard_text}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s,
                runtime=issued)


@contextlib.contextmanager
def knobs(**values):
    """Environment knobs set for one run, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def engine_run(cfg, device, card, engine: str, threshold=None,
               inspect=None) -> dict:
    """One hooks run of phase 4c with ``HOROVOD_NATIVE_CYCLE`` set for
    ``engine`` ("native" or "python"): the calls of the native bin-packer
    counted, the runtime's cache read before shutdown (and ``inspect()``
    called there), and the metrics registry's moves over the run held
    against those of ``COUNTS``: ``horovod_cycles_total`` by
    ``COUNTS["cycles"]``, ``horovod_response_cache_hits_total`` by twice
    ``COUNTS["cache_hits"]`` (a request answered from the cache is looked
    up at its announcement and when the agreed list is applied, as in the
    JAX package). Both are read once the run's runtime has stopped."""
    native = engine == "native"
    real, calls, seen = fusion_mod._bins_native, [0], {}

    def counted(*args):
        calls[0] += 1
        return real(*args)

    def before_shutdown():
        ctrl = state_mod.global_state().runtime.controller
        seen.update(cache=type(ctrl.cache).__name__,
                    native=ctrl.native_engine)
        if inspect is not None:
            inspect()

    extra = {} if threshold is None else {
        env.HOROVOD_FUSION_THRESHOLD: threshold}
    before, counts = flatten_snapshot(hvd.metrics()), dict(hrt.COUNTS)
    fusion_mod._bins_native = counted
    try:
        with knobs(**{env.HOROVOD_NATIVE_CYCLE: int(native)}, **extra):
            run = _train(cfg, device, card, "hooks", False, threshold,
                         before_shutdown=before_shutdown)
    finally:
        fusion_mod._bins_native = real
    after = flatten_snapshot(hvd.metrics())
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("horovod_cycles_total",
                       "horovod_response_cache_hits_total")}
    counted_moves = {k: hrt.COUNTS[k] - counts[k]
                     for k in ("cycles", "cache_hits")}
    log(f"  engine {engine}: cache {seen['cache']}, native bin-packer "
        f"calls {calls[0]}; metrics moved {moved}, COUNTS moved "
        f"{counted_moves}")
    check(seen == dict(cache="NativeResponseCache" if native
                       else "ResponseCache", native=native),
          f"{engine} run's runtime used {seen}")
    check((calls[0] > 0) == native,
          f"{engine} run called the native bin-packer {calls[0]} times")
    check(moved["horovod_cycles_total"] == counted_moves["cycles"] > 0,
          f"cycles moved {moved}, COUNTS {counted_moves}")
    check(moved["horovod_response_cache_hits_total"]
          == 2 * counted_moves["cache_hits"] > 0,
          f"cache hits moved {moved}, COUNTS {counted_moves}")
    run.update(engine=engine, cycle_ms=statistics.median(
        run["runtime"]["cycle_ms"][cfg["warmup"]:]))
    return run


def compare_engines(cfg, device, card) -> None:
    """Phase 4c: the hooks path on the native cycle engine and on the
    Python one, in turns (native, Python, Python, native), then once each
    at threshold 0; then two steps with the trace and the metrics
    endpoint on."""
    warmup, steps = cfg["engine_steps"]
    cfg = dict(cfg, warmup=warmup, steps=steps)
    runs = [engine_run(cfg, device, card, e)
            for e in ("native", "python", "python", "native")]
    t0 = [engine_run(cfg, device, card, e, threshold=0)
          for e in ("native", "python")]
    for group, keys in ((runs, ("cache_hits", "slabs", "groups")),
                        (t0, ("allreduce", "responses", "cache_hits",
                              "slabs", "groups"))):
        for r in group:
            check(r["losses"] == runs[0]["losses"],
                  f"{r['engine']} losses {r['losses']} not bit-equal to "
                  f"{runs[0]['losses']}")
            check(r["runtime"]["allreduce"] == r["runtime"]["responses"],
                  f"{r['engine']}: allreduce calls and responses differ")
            for k in keys:
                check(r["runtime"][k] == group[0]["runtime"][k],
                      f"{k} a step differ across engines: "
                      f"{[g['runtime'][k] for g in group]}")
    log("phase 4c: losses bit-equal on both engines; cache hits, slabs and "
        "groups a step equal in every run; at threshold 0 also allreduce "
        "calls and responses (fused bins follow the hooks' timing)")
    where = "(no device times)" if device.type != "cuda" else f"({card})"
    for label, group in (("fused", runs), ("threshold 0", t0)):
        for r in group:
            log(f"  engines, {label}, {r['engine']}: step "
                f"{r['step_ms']:.2f} ms median, cycle host "
                f"{r['cycle_ms']:.2f} ms a step (median), allreduce calls "
                f"a step {r['runtime']['allreduce']} {where}")
    trace_and_endpoint(cfg, device, card)


def trace_and_endpoint(cfg, device, card) -> None:
    """Phase 4c's last run: two hooks steps with ``HOROVOD_TIMELINE``,
    ``HOROVOD_TIMELINE_MARK_CYCLES=1`` and ``HOROVOD_METRICS_PORT=0``. The
    trace must parse, hold cycle markers, counter events and the
    backend's allreduce activities, and report its drop count; ``GET
    /metrics`` must serve the cycle and cache families."""
    cfg = dict(cfg, warmup=1, steps=1)
    backend = "NCCL" if device.type == "cuda" else "GLOO"
    served = {}

    def fetch():
        port = metrics_registry().http_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            served.update(status=resp.status, text=resp.read().decode())

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with knobs(**{env.HOROVOD_TIMELINE: path,
                      env.HOROVOD_TIMELINE_MARK_CYCLES: 1,
                      env.HOROVOD_METRICS_PORT: 0}):
            engine_run(cfg, device, card, "native", inspect=fetch)
        with open(path) as f:
            events = json.load(f)
    names = [e.get("name", "") for e in events]
    marks = sum(n.startswith("CYCLE_") for n in names)
    counters = sum(e.get("ph") == "C" for e in events)
    reduces = names.count(f"{backend}_ALLREDUCE")
    drops = [e["args"]["count"] for e in events
             if e.get("name") == "dropped_events"]
    log(f"  trace: {len(events)} events, {marks} cycle markers, {counters} "
        f"counter events, {reduces} {backend}_ALLREDUCE, dropped "
        f"{drops}")
    check(marks > 0 and counters > 0 and reduces > 0 and len(drops) == 1,
          "the trace lacks cycle markers, counter events, allreduces or "
          "its drop count")
    text = served.get("text", "")
    families = ("horovod_cycles_total", "horovod_response_cache_hits_total",
                "horovod_fusion_bytes_total")
    log(f"  GET /metrics: status {served.get('status')}, {len(text)} bytes, "
        f"families {[f for f in families if f'# TYPE {f} ' in text]}")
    check(served.get("status") == 200
          and all(f"# TYPE {f} " in text for f in families),
          "the metrics endpoint did not serve the runtime's families")


def check_zero_runtime(cfg, path: str, per_step: dict) -> None:
    """The ZeRO paths' runtime checks: every collective after the first
    step came from the response cache (the names are the same every step),
    and no fusion slab or process group appeared after the warm-up."""
    issued = [a + b for a, b in zip(per_step["reducescatter"],
                                    per_step["allgather"])]
    hits = per_step["cache_hits"]
    check(all(h == n for h, n in zip(hits[1:], issued[1:])),
          f"{path}: cache hits a step {hits}, want {issued} after the first")
    for k in ("slabs", "groups"):
        check(not any(per_step[k][cfg["warmup"]:]),
              f"{path}: new {k} after warm-up: {per_step[k]}")


def compare_fusion(cfg, device, card, fused: dict) -> None:
    """Phase 4b: the hooks path at ``HOROVOD_FUSION_THRESHOLD=0`` (one
    allreduce a tensor) in turns with phase 4's fused run (fused, 0, 0,
    fused). At world 1 every reduction is the identity, so the losses must
    equal the fused run's to the last bit, unless a library kernel is
    nondeterministic (the embedding backward's atomics): then within 1e-5
    relative."""
    runs = {"fused": [fused], "threshold 0": []}
    for label in ("threshold 0", "threshold 0", "fused"):
        runs[label].append(train(cfg, device, card, "hooks",
                                 threshold=0 if label != "fused" else None))
    base = fused["losses"]
    for label, rs in runs.items():
        for r in rs:
            worst = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                            base))
            log(f"hooks losses, {label} vs phase 4: largest relative "
                f"difference {worst:.3e} "
                f"({'bit-equal' if r['losses'] == base else 'not bit-equal'};"
                f" limit 1e-5)")
            check(worst <= 1e-5, f"hooks at {label} moved the losses by "
                                 f"{worst:.3e}")
    if device.type != "cuda":
        log("phase 4b rehearsed (no device times)")
        return
    for label, rs in runs.items():
        ms = [r["step_ms"] for r in rs]
        calls = statistics.median(n for r in rs
                                  for n in r["runtime"]["allreduce"][1:])
        log(f"hooks step median at {label}, turns fused, 0, 0, fused: "
            + " ".join(f"{x:.2f}" for x in ms) + f" ms; {calls:.0f} "
            f"allreduces a step (median after the first) ({card})")


def compare_in_turns(cfg, device, card, runs: dict, turns: int) -> None:
    """Phases 4-5 again, ``turns - 1`` more times, the order of the paths
    reversed each turn; then each path's step median in every turn."""
    steps = {path: [run["step_ms"]] for path, run in runs.items()}
    order = list(PATHS)
    for _ in range(turns - 1):
        order.reverse()
        for path in order:
            steps[path].append(train(cfg, device, card, path)["step_ms"])
    if device.type != "cuda":
        log(f"{turns} turns of the three paths rehearsed (no device times)")
        return
    for path, ms in steps.items():
        log(f"step median of {path} in {turns} turns: "
            + " ".join(f"{x:.2f}" for x in ms)
            + f" ms; median {statistics.median(ms):.2f} ms ({card})")


def _worst(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def compare_losses(runs: dict) -> None:
    """Every path's loss within 1e-2 relative of the phase-4 path's at
    every step: same weights, data and AdamW; bf16 compute and the
    embedding backward's atomics separate them. P4's and P5's within 1e-5
    of P2's: the same flat AdamW on the same elements (a bucket-aligned
    layout, sharded at rest in P5), so only the atomics remain."""
    base = runs["hooks"]["losses"]
    for path, run in runs.items():
        worst = _worst(run["losses"], base)
        log(f"losses of {path} vs hooks: largest relative difference "
            f"{worst:.3e} (limit 1e-2)")
        check(worst <= 1e-2, f"{path} losses differ from the hooks path's "
                             f"by {worst:.3e}")
    for path in ("zero2", "zero3"):
        worst = _worst(runs[path]["losses"], runs["zero"]["losses"])
        same = runs[path]["losses"] == runs["zero"]["losses"]
        log(f"losses of {path} vs zero (P2): largest relative difference "
            f"{worst:.3e} ({'bit-equal' if same else 'not bit-equal'}; "
            f"limit 1e-5)")
        check(worst <= 1e-5, f"{path} losses differ from P2's by "
                             f"{worst:.3e}")


# ---------------------------------------------------------------------------
# Phase 6: the Inception-V3 slice
# ---------------------------------------------------------------------------


def train_inception(cfg, device, card, profile=False) -> dict:
    """The bench's Inception row, eager, one process: ``hvd.init()``,
    ``InceptionV3(1000, bf16, seed=0)`` on ``hvd.device()``,
    ``broadcast_parameters(state_dict())``, ``DistributedOptimizer(SGD(0.01
    x size, momentum 0.9))``, the bench's images and labels (the same batch
    every step), 2 warm-up and 10 timed steps."""
    inc = cfg["inception"]
    batch, size = inc["batch"], inc["size"]
    rng = np.random.RandomState(0)  # bench.py:306-312
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, inc["classes"], (batch,)).astype(np.int32)

    cba.reset_launch_counts()
    collectives.COUNTS.update(dict.fromkeys(collectives.COUNTS, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = InceptionV3(num_classes=inc["classes"], dtype=inc["dtype"],
                        seed=0)
    check(next(model.parameters()).device == dev,
          "InceptionV3() without a device must take hvd.device()")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
    n_tensors = len(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    n_bn = sum(isinstance(m, cba.FusedBatchNormAct) for m in model.modules())
    n_broadcast = len(model.state_dict())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, snaps = [], [], [dict(hrt.COUNTS)]
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(x, y).item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = dict(cba.LAUNCHES)
    counts = dict(collectives.COUNTS)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    step_s = statistics.median(times)
    if profile:
        breakdown(lambda: step(x, y), dev, step_s, cfg["profile_steps"])
    del model, opt, step
    hvd.shutdown()
    free_memory(device)

    log(f"slice (Inception-V3): {n_bn} fused BN layers, {n_params:,} params "
        f"in {n_tensors} tensors, batch {batch} x {size}^2, "
        f"{cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{v:.4f}" for v in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    log_runtime("Inception-V3", runtime_steps(snaps))
    check(all(math.isfinite(v) for v in losses), "Inception: non-finite loss")
    check(losses[-1] < losses[0], f"Inception: loss did not fall: {losses}")
    want = {k: 0 for k in counts}
    want.update(allreduce=n_tensors * steps, broadcast=n_broadcast)
    check(counts == want, f"Inception: collectives {counts}, want {want}")
    if dev.type == "cuda":
        check(launches == {"sba": n_bn * steps},
              f"Inception: kernel launches {launches}, want "
              f"{n_bn * steps} sba")
        img_s = batch / step_s
        where = f"({card})"
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  images/s {img_s:.1f} {where}")
        log(f"  MFU {img_s * INCEPTION_FLOPS / PEAK_FLOPS:.4f} against 989 "
            f"TFLOP/s bf16, {INCEPTION_FLOPS / 1e9:.3f} GFLOP/image {where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


# ---------------------------------------------------------------------------
# Phase 7: the GPT-2-small slice, with each backward
# ---------------------------------------------------------------------------


def gpt_tokens(cfg) -> np.ndarray:
    """Phase 7's tokens (bench.py:454-455)."""
    return np.random.RandomState(0).randint(
        0, cfg["gpt"]["vocab_size"],
        (cfg["gpt_batch"], cfg["gpt_seq"])).astype(np.int32)


def train_gpt(cfg, device, card, fused: bool, profile=False,
              attention_fn=None) -> dict:
    """The bench's GPT-2 row (``transformer_main("gpt2")``), eager, one
    process: ``hvd.init()``, ``GPT2Small`` from seed 0 on ``hvd.device()``,
    ``broadcast_parameters``, ``DistributedOptimizer(AdamW(1e-4,
    weight_decay=1e-4))``, the bench's tokens, the full-logits
    ``causal_lm_loss``, 2 warm-up and 10 timed steps. ``fused`` sets
    ``FLASH_FUSED_BWD=1`` for the run (unset otherwise); ``attention_fn``
    is the model's (phase 16b)."""
    batch, seq = cfg["gpt_batch"], cfg["gpt_seq"]
    vocab = cfg["gpt"]["vocab_size"]
    tokens = gpt_tokens(cfg)
    if fused:
        os.environ[env.FLASH_FUSED_BWD] = "1"
    else:
        os.environ.pop(env.FLASH_FUSED_BWD, None)
    try:
        fa.reset_launch_counts()
        collectives.COUNTS.update(dict.fromkeys(collectives.COUNTS, 0))
        hvd.init(device=None if device.type == "cuda" else "cpu")
        dev = hvd.device()
        model = GPT2Small(**cfg["gpt"], device=dev, seed=0,
                          attention_fn=attention_fn)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        params = dict(model.named_parameters())
        opt = adamw_optimizer(model)
        zero_grad, update = opt.zero_grad, opt.step
        toks = torch.from_numpy(tokens).to(dev)
        n_tensors, n_broadcast = len(params), len(model.state_dict())
        n_params = sum(p.numel() for p in params.values())
        n_layers, d_model = len(model.layers), model.token_embed.shape[1]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        def step():
            zero_grad()
            loss = causal_lm_loss(model(toks), toks)
            loss.backward()
            update()
            return loss.detach()

        losses, times, snaps = [], [], [dict(hrt.COUNTS)]
        steps = cfg["warmup"] + cfg["steps"]
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(step().item())  # waits for the step's last kernel
            snaps.append(dict(hrt.COUNTS))
            if i >= cfg["warmup"]:
                times.append(time.perf_counter() - t0)
        launches = dict(fa.LAUNCHES)
        counts = dict(collectives.COUNTS)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        step_s = statistics.median(times)
        if profile:
            breakdown(step, dev, step_s, cfg["profile_steps"])
        del model, params, opt, update, zero_grad, step
        hvd.shutdown()
        free_memory(device)
    finally:
        os.environ.pop(env.FLASH_FUSED_BWD, None)

    bwd = "fused backward B7" if fused else "dq + dk/dv"
    if attention_fn is not None:
        bwd += f", attention_fn {attention_fn.__name__}"
    log(f"slice (GPT-2, {bwd}): {n_layers} layers x {d_model}, "
        f"{n_params / 1e6:.1f}M params in {n_tensors} tensors, vocab {vocab},"
        f" batch {batch} x seq {seq}, {cfg['warmup']} warm-up + "
        f"{cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    log_runtime(f"GPT-2, {bwd}", runtime_steps(snaps))
    check(all(math.isfinite(x) for x in losses), f"GPT-2 ({bwd}): non-finite "
                                                 f"loss")
    check(losses[-1] < losses[0], f"GPT-2 ({bwd}): loss did not fall: "
                                  f"{losses}")
    want = {k: 0 for k in counts}
    want.update(allreduce=n_tensors * steps, broadcast=n_broadcast)
    check(counts == want, f"GPT-2 ({bwd}): collectives {counts}, want {want}")
    if dev.type == "cuda":
        per_step = dict(flash_fwd=n_layers, flash_bwd_dq=0, flash_bwd_dkv=0,
                        flash_bwd_fused=0)
        per_step.update(dict(flash_bwd_fused=n_layers) if fused else
                        dict(flash_bwd_dq=n_layers, flash_bwd_dkv=n_layers))
        want_launches = {k: steps * n for k, n in per_step.items()}
        check(launches == want_launches,
              f"GPT-2 ({bwd}): kernel launches {launches}, want "
              f"{want_launches}")
        # FLOPs/token as bench.py:498-503 counts them: 6N + the causal half
        # of the attention term
        flops_per_token = 6 * n_params + 12 * n_layers * seq * d_model // 2
        tok_s = batch * seq / step_s
        where = f"({card})"
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  tokens/s {tok_s:.1f} {where}")
        log(f"  MFU {tok_s * flops_per_token / PEAK_FLOPS:.4f} against 989 "
            f"TFLOP/s bf16, {flops_per_token / 1e9:.3f} GFLOP/token {where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


def compare_gpt_runs(two: dict, fused: dict) -> None:
    """The two backwards on the same weights, data and AdamW: losses within
    1e-3 relative at every step, a tenth of one step's fall (bf16 compute;
    the fused kernel sums dq in another order than the dq kernel)."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(fused["losses"],
                                                    two["losses"]))
    log(f"GPT-2 losses, fused backward vs dq + dk/dv: largest relative "
        f"difference {worst:.3e} (limit 1e-3)")
    check(worst <= 1e-3, f"GPT-2 losses of the two backwards differ by "
                         f"{worst:.3e}")


# ---------------------------------------------------------------------------
# Phase 8: the ResNet-50 slice
# ---------------------------------------------------------------------------


def train_resnet(cfg, device, card, profile=False) -> dict:
    """The bench's ResNet-50 row (``bench.py:85, 258-300``), eager, one
    process: ``hvd.init()``, ``ResNet50(1000, bf16, seed=0)`` on
    ``hvd.device()`` (NHWC images, f32 parameters and statistics),
    ``broadcast_parameters(state_dict())``, ``DistributedOptimizer(SGD(0.01
    x size, momentum 0.9))`` through the hooks and the runtime, the bench's
    images and labels (the same batch every step), 2 warm-up and 10 timed
    steps. Losses finite and falling; 161 gradients a step, every one from
    the response cache from the second step, fewer fused calls a step than
    gradients, no slab or group after warm-up. The 33 norm + ReLU pairs
    run plain, not on B10 (``tools/resnet_bn_choice.py`` timed both)."""
    rn = cfg["resnet"]
    batch, size = rn["batch"], rn["size"]
    rng = np.random.RandomState(0)  # bench.py:306-312
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, rn["classes"], (batch,)).astype(np.int32)

    cba.reset_launch_counts()
    collectives.COUNTS.update(dict.fromkeys(collectives.COUNTS, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = ResNet50(num_classes=rn["classes"], dtype=rn["dtype"], seed=0)
    check(next(model.parameters()).device == dev,
          "ResNet50() without a device must take hvd.device()")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
    n_tensors = len(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    n_pairs = sum(isinstance(m, BatchNormReLU) for m in model.modules())
    n_broadcast = len(model.state_dict())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, snaps = [], [], [dict(hrt.COUNTS)]
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(x, y).item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = dict(cba.LAUNCHES)
    counts = dict(collectives.COUNTS)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    step_s = statistics.median(times)
    if profile:
        breakdown(lambda: step(x, y), dev, step_s, cfg["profile_steps"])
    del model, opt, step
    hvd.shutdown()
    free_memory(device)

    log(f"slice (ResNet-50): {n_params:,} params in {n_tensors} tensors, "
        f"{n_pairs} norm + ReLU pairs (plain), batch {batch} x {size}^2 NHWC, "
        f"{cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{v:.4f}" for v in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    issued = runtime_steps(snaps)
    log_runtime("ResNet-50", issued)
    check(n_tensors == 161 and (n_params == 25_557_032
                                or rn["classes"] != 1000),
          f"ResNet-50 has {n_tensors} tensors, {n_params} params")
    check_hooks_runtime(cfg, issued, n_tensors,
                        env.DEFAULT_FUSION_THRESHOLD_BYTES,
                        dev.type == "cuda", card_limit=n_tensors)
    check(all(math.isfinite(v) for v in losses), "ResNet-50: non-finite loss")
    check(losses[-1] < losses[0], f"ResNet-50: loss did not fall: {losses}")
    want = {k: 0 for k in counts}
    want.update(allreduce=n_tensors * steps, broadcast=n_broadcast)
    check(counts == want, f"ResNet-50: collectives {counts}, want {want}")
    check(launches == {"sba": 0}, f"ResNet-50: kernel launches {launches}, "
                                  f"want none (the pairs run plain)")
    if dev.type == "cuda":
        img_s = batch / step_s
        where = f"({card})"
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  images/s {img_s:.1f} {where}")
        log(f"  MFU {img_s * RESNET_FLOPS / PEAK_FLOPS:.4f} against 989 "
            f"TFLOP/s bf16, {RESNET_FLOPS / 1e9:.3f} GFLOP/image {where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


# ---------------------------------------------------------------------------
# Phase 9: the rest of the collectives through the runtime
# ---------------------------------------------------------------------------


def check_collectives(device) -> None:
    """At world 1 (NCCL on the card): an allgather, an alltoall, a
    differentiable allreduce with its backward, an int64 allreduce past
    2**40, a sparse allreduce and ``broadcast_object``, each held exactly
    against the value it must have; every one is issued by the runtime
    (``runtime.COUNTS``). A ragged allgather needs two ranks: the four-card
    test ``tests/test_torch_kernels.py::test_runtime_across_the_cards``
    runs it on NCCL."""
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    try:
        before = dict(hrt.COUNTS)
        x = torch.arange(12, device=dev).reshape(4, 3)
        check(torch.equal(hvd.allgather(x, name="smoke.ag"), x),
              "allgather at world 1")
        check(torch.equal(hvd.alltoall(x.float(), name="smoke.a2a"),
                          x.float()), "alltoall at world 1")
        w = torch.full((5,), 2.0, device=dev, requires_grad=True)
        out = hvd.allreduce(w * 3, op=hvd.Sum, name="smoke.ar")
        (out * torch.arange(5.0, device=dev)).sum().backward()
        check(torch.equal(out.detach(), torch.full((5,), 6.0, device=dev))
              and torch.equal(w.grad, 3 * torch.arange(5.0, device=dev)),
              "differentiable allreduce at world 1")
        big = torch.tensor([2 ** 40 + 1, -(2 ** 40) - 3], device=dev)
        check(torch.equal(hvd.allreduce(big, op=hvd.Sum, name="smoke.big"),
                          big), f"int64 past 2**40: {big.tolist()}")
        sp = torch.sparse_coo_tensor(torch.tensor([[0, 2, 2]]),
                                     torch.tensor([1.0, 2.0, 3.0]), (4,),
                                     check_invariants=True)
        got = hvd.sparse_allreduce_async(sp.to(dev), name="smoke.sparse")
        check(torch.equal(got.wait().to_dense().cpu(),
                          torch.tensor([1.0, 0.0, 5.0, 0.0])),
              "sparse allreduce at world 1")
        check(hvd.broadcast_object({"epoch": 3}) == {"epoch": 3},
              "broadcast_object")
        issued = {k: hrt.COUNTS[k] - before[k]
                  for k in ("allreduce", "allgather", "alltoall")}
        # the allreduce's backward is one more; the sparse one two gathers
        check(issued == dict(allreduce=3, allgather=3, alltoall=1),
              f"collectives issued at world 1: {issued}")
        log(f"collectives through the runtime at world 1 on {dev} "
            f"({'NCCL' if dev.type == 'cuda' else 'gloo'}): allgather, "
            f"alltoall, differentiable allreduce and its backward, int64 "
            f"past 2**40, sparse allreduce, broadcast_object exact; issued "
            f"{issued}")
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Phase 10: the training API
# ---------------------------------------------------------------------------


def resnet_setup(cfg, device, losses=None) -> dict:
    """Phase 8's ResNet-50, data and optimizer for the training API:
    ``hvd.init()``, ``ResNet50(seed=0)``, ``DistributedOptimizer(SGD(0.01 x
    size, momentum 0.9))``, ``create_train_state``. ``losses`` collects
    every step's loss (the loss function's own output, unread)."""
    rn = cfg["resnet"]
    rng = np.random.RandomState(0)  # bench.py:306-312, as phase 8
    images = rng.uniform(-1, 1, (rn["batch"], rn["size"], rn["size"], 3)) \
        .astype(np.float32)
    labels = rng.randint(0, rn["classes"], (rn["batch"],)).astype(np.int32)
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = ResNet50(num_classes=rn["classes"], dtype=rn["dtype"], seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    state = hvd.training.create_train_state(model, opt)
    check(all(t.device == dev for t in state.params.values()),
          "create_train_state: parameters off the device")

    def loss_fn(logits, y):
        loss = hvd.training.default_loss_fn(logits, y)
        if losses is not None:
            losses.append(loss.detach())
        return loss

    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
    return dict(model=model, opt=opt, loss_fn=loss_fn, x=x, y=y, dev=dev)


def timed_rounds(cfg, setup: dict, rounds: int, explicit: bool = False,
                 flops: bool = False) -> dict:
    """A ``make_train_round(steps=cfg["round_steps"])`` of ``setup``'s
    model, made under the knobs as they stand (the profiler and the guard
    wrap it or not), one warm-up round, then ``rounds`` timed ones (each
    inside ``hvd.profiler.step`` when ``explicit``), the device drained
    after each. Returns the rounds' ms a step, the timed rounds' records,
    the history's growth after each, and whether the round was wrapped."""
    k, dev = cfg["round_steps"], setup["dev"]
    round_fn = hvd.training.make_train_round(
        setup["model"], setup["opt"], loss_fn=setup["loss_fn"], steps=k)
    if flops:  # per-card FLOPs of one round (3 x forward a step)
        hvd.profiler.set_flops_per_step(
            cfg["resnet"]["batch"] * k * RESNET_FLOPS, PEAK_FLOPS)
    x, y = setup["x"], setup["y"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    round_fn(x, y)
    sync()
    hvd.profiler.dump()  # closes the warm-up's record, if profiling
    n0 = len(hvd.profiler.history())
    ms, records, counts = [], [], []
    for i in range(rounds):
        t0 = time.perf_counter()
        if explicit:
            with hvd.profiler.step(f"round {i}") as rec:
                round_fn(x, y)
            records.append(rec.breakdown if rec is not None else None)
            counts.append(len(hvd.profiler.history()) - n0)
        else:
            round_fn(x, y)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0) / k)
    hvd.profiler.dump()
    if flops:
        hvd.profiler.set_flops_per_step(None)
    return dict(ms=ms, records=records, counts=counts,
                wrapped=hasattr(round_fn, "__wrapped__"))


def training_api(cfg, device, card, phase8_losses: list) -> None:
    """Phase 10: the training API around the step, on the bench's
    ResNet-50 and BERT-Large."""
    where = f"({card})" if device.type == "cuda" else "(no device times)"
    k = cfg["round_steps"]
    rounds = cfg["api_rounds"]

    # 10a: the profiled rounds, one record a round
    step_losses = []
    with knobs(**{env.HOROVOD_PROFILE: 1}):
        setup = resnet_setup(cfg, device, losses=step_losses)
        run = timed_rounds(cfg, setup, rounds, explicit=True, flops=True)
    records, counts = run["records"], run["counts"]
    setup.clear()
    hvd.shutdown()
    free_memory(device)
    got = [v.item() for v in step_losses]
    check(all(math.isfinite(v) for v in got) and got[-1] < got[0],
          f"10a: losses not finite or not falling: {got}")
    n = min(len(got), len(phase8_losses))
    rel = [abs(a - b) / abs(b) for a, b in zip(got[:n], phase8_losses[:n])]
    log(f"10a training API (ResNet-50, create_train_state + "
        f"make_train_round(steps={k})): {len(got)} steps; largest "
        f"relative difference from phase 8's losses: first step "
        f"{rel[0]:.3e} (limit 1e-5), any step {max(rel):.3e} (limit 1e-2)")
    log("  losses: " + " ".join(f"{v:.4f}" for v in got))
    check(rel[0] <= 1e-5 and max(rel) <= 1e-2,
          f"10a: round losses off phase 8's: {rel}")
    check(counts == list(range(1, rounds + 1)),
          f"10a: history grew by {counts}, want one record a round")
    for i, b in enumerate(records):
        total = sum(b["phases"].values())
        check(abs(total - b["wall_seconds"]) <= 1e-9 * b["wall_seconds"],
              f"10a: round {i} phases sum {total} != {b['wall_seconds']}")
        check(b["comm"]["dispatches"] > 0 and (b["mfu"] or 0) > 0,
              f"10a: round {i} dispatches {b['comm']['dispatches']}, "
              f"mfu {b['mfu']}")
        log(f"  round {i}: wall {1e3 * b['wall_seconds']:.2f} ms; "
            f"step_breakdown ms " + json.dumps(
                {p: round(1e3 * v, 3) for p, v in b["phases"].items()})
            + f"; comm_hidden_fraction {b['comm']['hidden_fraction']:.4f}"
            f" ({b['comm']['dispatches']} dispatches, "
            f"{b['comm']['bytes']} bytes); mfu {b['mfu']:.4f}; "
            f"peak_hbm_bytes {b['peak_hbm_bytes']} {where}")

    # 10b and 10d run on one model, the knobs switched between turns (the
    # profiler re-reads them at configure(); the guard at each step)
    from horovod_tpu_torch.integrity import guards

    setup = resnet_setup(cfg, device)
    turns = {"profile": {}, "integrity": {}}
    guards.reset()
    skipped0 = guards._SKIPPED.value
    for knob, key in ((env.HOROVOD_PROFILE, "profile"),
                      (env.HOROVOD_INTEGRITY, "integrity")):
        for on in (0, 1, 1, 0) if key == "profile" else (1, 0, 0, 1):
            with knobs(**{knob: on}):
                hvd.profiler.configure()
                run = timed_rounds(cfg, setup, rounds)
            turns[key].setdefault(on, []).append(statistics.median(
                run["ms"]))
            check(run["wrapped"] == bool(on),
                  f"{knob}={on}: round wrapped {run['wrapped']}")
    hvd.profiler.configure()
    cost, guarded = turns["profile"], turns["integrity"]
    log(f"10b profiler cost, ResNet-50 round of {k} steps, ms a step "
        f"(median of {rounds} rounds), turns off, on, on, off: "
        + " ".join(f"{cost[o][i]:.2f}" for o, i in ((0, 0), (1, 0), (1, 1),
                                                     (0, 1)))
        + f" {where}")
    check(guards._SKIPPED.value == skipped0,
          f"10d: the healthy runs skipped "
          f"{guards._SKIPPED.value - skipped0} steps")

    # 10d: the guard's own cost (the norm of the last step's gradients
    # and its read, on an idle device; ms a call, median of 10), then a
    # step with one NaN in one gradient
    model, opt, x, y = (setup[n] for n in ("model", "opt", "x", "y"))
    grads = [p.grad for p in model.parameters()]
    norm_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        guards.global_norm(grads)
        norm_ms.append(1e3 * (time.perf_counter() - t0))
    # the step guard alone: with the executor's digests on too, whether
    # the NaN's bin is a digested dispatch depends on how the cycles bin
    # the gradients (timing), and a digest convicts it first (phase 12b
    # checks the digests)
    with knobs(**{env.HOROVOD_INTEGRITY: 1,
                  env.HOROVOD_INTEGRITY_INTERVAL: 0}):
        before = [p.detach().clone() for p in model.parameters()]
        momentum = [opt.state[p]["momentum_buffer"].clone()
                    for p in model.parameters()]
        target = next(model.parameters())

        def one_nan(g):
            g = g.clone()
            g[(0,) * g.dim()] = float("nan")
            return g

        hook = target.register_hook(one_nan)
        opt.zero_grad()
        model.train()
        hvd.training.default_loss_fn(model(x), y).backward()
        opt.step()
        hook.remove()
        same = all(torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))
        same_m = all(torch.equal(m, opt.state[p]["momentum_buffer"])
                     for m, p in zip(momentum, model.parameters()))
        moved = guards._SKIPPED.value - skipped0
    setup.clear()
    hvd.shutdown()
    free_memory(device)
    guards.reset()
    log(f"10d integrity guard, ResNet-50 round of {k} steps, ms a step "
        f"(median of {rounds} rounds), turns on, off, off, on: "
        + " ".join(f"{guarded[o][i]:.2f}" for o, i in ((1, 0), (0, 0),
                                                        (0, 1), (1, 1)))
        + f"; the norm of the 161 gradients and its read alone "
        f"{statistics.median(norm_ms):.3f} ms {where}; no healthy step "
        f"skipped")
    log(f"10d NaN step skipped: parameters bit-equal {same}, momentum "
        f"bit-equal {same_m}, horovod_integrity_skipped_steps_total moved "
        f"{moved}")
    check(same and same_m and moved == 1,
          "10d: the NaN step was not skipped cleanly")

    # 10c: BERT-Large on the hooks path, the optimizer's own boundaries
    profiler_10c(cfg, device, card)

    # 10e: the three examples on the card, each a process of its own
    run_examples(device)


def profiler_10c(cfg, device, card) -> None:
    """10c: BERT-Large on phase 4's hooks path with ``HOROVOD_PROFILE_DIR``
    and ``HOROVOD_PROFILE_JAX``, no explicit step: the optimizer's own
    boundary makes one record a step; ``shutdown()`` writes the dump and
    the device trace, and ``merge_profile_dir`` joins them."""
    warmup, steps = cfg["engine_steps"]
    cfg = dict(cfg, warmup=warmup, steps=steps)
    first = hvd.profiler.profiler()._step_index
    with tempfile.TemporaryDirectory() as tmp:
        with knobs(**{env.HOROVOD_PROFILE: 1, env.HOROVOD_PROFILE_DIR: tmp,
                      env.HOROVOD_PROFILE_JAX: 1}):
            _train(cfg, device, card, "hooks", False)
        recs = [r for r in hvd.profiler.history() if r["step"] > first]
        dumps = hvd.profiler.load_dumps(tmp)
        t0 = time.perf_counter()
        out, n_events = hvd.profiler.merge_profile_dir(tmp)
        merge_s = time.perf_counter() - t0
        with open(out) as f:
            events = json.load(f)["traceEvents"]
        trace_mb = os.path.getsize(os.path.join(
            tmp, "jax-rank-0", hvd.profiler.DEVICE_TRACE)) / 2**20
    check(len(recs) == warmup + steps and all(r["auto"] for r in recs),
          f"10c: {len(recs)} records for {warmup + steps} steps")
    for r in recs:
        check(r["phases"]["optimizer"] > 0
              and abs(sum(r["phases"].values()) - r["wall_seconds"])
              <= 1e-9 * r["wall_seconds"],
              f"10c: record {r['step']} phases {r['phases']}")
    lanes = [(e["args"]["labels"], e["pid"]) for e in events
             if e.get("name") == "process_labels"]
    labels = {label for label, _ in lanes}
    markers = [e for e in events if e.get("ph") == "X"
               and str(e.get("name", "")).startswith("step ")]
    device_pids = {pid for label, pid in lanes if label == "rank 0 device"}
    kernels = [e for e in events if e.get("pid") in device_pids
               and e.get("cat") == "kernel"]
    check(len(dumps) == 1 and len(dumps[0]["steps"]) >= warmup + steps,
          f"10c: dumps {[len(d.get('steps', ())) for d in dumps]}")
    check("rank 0 steps" in labels and "rank 0 device" in labels
          and len(markers) >= warmup + steps,
          f"10c: merged trace lanes {sorted(labels)}, {len(markers)} "
          f"step markers")
    if device.type == "cuda":
        check(len(kernels) > 0, "10c: the device trace holds no kernel")
    where = f"({card})" if device.type == "cuda" else "(no device times)"
    for r in recs:
        log(f"  10c record {r['step']}: wall {1e3 * r['wall_seconds']:.2f} "
            f"ms; phases ms " + json.dumps(
                {p: round(1e3 * v, 3) for p, v in r["phases"].items()})
            + f"; comm_hidden_fraction {r['comm']['hidden_fraction']:.4f}"
            f" {where}")
    log(f"10c profiler on BERT-Large hooks: {len(recs)} records for "
        f"{warmup + steps} steps (optimizer > 0, phases = wall); merged "
        f"trace {n_events} events, {len(markers)} step markers, "
        f"{len(kernels)} device kernels, device trace {trace_mb:.1f} MiB, "
        f"merge {merge_s:.2f} s")


EXAMPLES = {  # (module, arguments on the card, arguments for the rehearsal)
    "synthetic_benchmark": ([], ["--batch-size", "4", "--image-size",
                                 "32"]),
    "synthetic_benchmark --fp16-allreduce": (
        ["--fp16-allreduce"], ["--batch-size", "4", "--image-size", "32",
                               "--fp16-allreduce"]),
    "mnist": (["--epochs", "1"], ["--epochs", "1"]),
    "bert_large_sparse": ([], ["--layers", "1", "--seq", "16", "--batch",
                               "2", "--steps", "2"]),
}


def run_examples(device) -> None:
    """10e: each example as its own process at world 1: on the card at
    their defaults (BERT-Large at full width), one after another; in the
    rehearsal on the CPU at tiny sizes, all at once. A non-zero exit fails
    the phase."""
    free_memory(device)
    here = os.path.dirname(os.path.abspath(__file__))
    env_ = {k: v for k, v in os.environ.items()
            if not k.startswith("HOROVOD_")}  # world 1, no knob

    def start(label):
        card_args, dry_args = EXAMPLES[label]
        args = card_args if device.type == "cuda" else \
            ["--device", "cpu", *dry_args]
        return subprocess.Popen(
            [sys.executable, "-m",
             "horovod_tpu_torch.examples." + label.split()[0], *args],
            cwd=here, env=env_, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def finish(label, proc, t0):
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        lines = out.strip().splitlines()
        log(f"10e example {label}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s; last line: "
            f"{lines[-1] if lines else ''}")
        check(proc.returncode == 0,
              f"example {label} failed:\n{out[-2000:]}\n{err[-3000:]}")
        if label == "bert_large_sparse":
            check("lockstep OK" in out and "tokens/s" in out,
                  "bert_large_sparse printed no tokens/s and lockstep OK")

    if device.type == "cuda":
        for label in EXAMPLES:
            t0 = time.perf_counter()
            finish(label, start(label), t0)
    else:
        t0 = time.perf_counter()
        procs = {label: start(label) for label in EXAMPLES}
        for label, proc in procs.items():
            finish(label, proc, t0)


# ---------------------------------------------------------------------------
# Phase 11: checkpoint and resume
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(tensors) -> list:
    return [t.detach().cpu().clone() for t in tensors]


def ckpt_space(directory: str, need: int, what: str) -> None:
    """Fail, with the numbers, unless ``directory`` has room for ``need``
    bytes."""
    free = shutil.disk_usage(directory).free
    log(f"  {what}: {directory} has {free:,} bytes free; the phase writes "
        f"up to {need:,}")
    check(free >= need, f"{what}: {directory} has {free:,} bytes free, the "
                        f"phase writes up to {need:,}")


def checkpoint_p2(cfg, device, card, tmp) -> None:
    """11a and 11b: BERT-Large MLM on P2 (phase 5's setup: seed 0, the
    bench's batch, ZeRO-1 ``sharded_adamw`` through B8) committed by the
    sharded writer while training goes on, restored into a model from
    seed 1 and replayed; then the in-place hazard: a commit followed at
    once by a B8 step."""
    where = f"({card})" if device.type == "cuda" else "(no device times)"
    tokens, positions, labels, _ = mlm_data(cfg)
    for counts in (fa.LAUNCHES, fopt.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    tx = hvd.sharded_adamw(1e-4)

    def build(seed):
        model = BertLarge(**cfg["model"], device=dev, seed=seed)
        params = dict(model.named_parameters())
        return model, params, {"opt": tx.init(params)}

    def step(model, params, box):
        model.zero_grad(set_to_none=True)
        loss = masked_lm_loss_gathered(model(toks, output="hidden"),
                                       model.token_embed, pos, lab)
        loss.backward()
        _, box["opt"] = tx.apply(params, box["opt"],
                                 {k: p.grad for k, p in params.items()})
        return loss.detach()

    def timed(model, params, box):
        t0 = time.perf_counter()
        loss = step(model, params, box).item()  # waits for its last kernel
        return loss, 1e3 * (time.perf_counter() - t0)

    def state_host(params, box):
        st = box["opt"]
        return ({k: p.detach().cpu().clone() for k, p in params.items()},
                {c: _host(getattr(st, c)) for c in ("master", "mu", "nu")},
                st.count)

    # 11a: 2 warm-up steps, the commit, step 3 racing the writer, 4-5
    model, params, box = build(0)
    n_layers, n_groups = len(model.layers), len(box["opt"].spec.groups)
    losses = [step(model, params, box).item() for _ in range(2)]
    snap_params, snap_state, snap_count = state_host(params, box)
    payload = nbytes(params.values()) + sum(
        nbytes(v) for v in snap_state.values())
    ckpt_space(tmp, 2 * payload + (1 << 30), "11a")
    d = os.path.join(tmp, "p2")
    mgr = hvd.ckpt.CheckpointManager(d, async_write=True, keep=1)
    abandoned = hvd.ckpt.stats.COMMITS_ABANDONED.value
    _sync(dev)
    t0 = time.perf_counter()
    mgr.commit({"params": params, "opt": box["opt"]}, step=2)
    inline_ms = 1e3 * (time.perf_counter() - t0)
    loss3, contended_ms = timed(model, params, box)
    mgr.wait()
    wall_s = time.perf_counter() - t0
    commit = dict(mgr.last_commit)
    slabs_first = mgr.slab_allocations
    rest = [timed(model, params, box) for _ in range(2)]
    losses += [loss3] + [v for v, _ in rest]
    check(commit["step"] == 2 and hvd.ckpt.latest_step(d) == 2
          and os.path.exists(hvd.ckpt.manifest.manifest_path(d, 2)),
          f"11a: no manifest at step 2 in {sorted(os.listdir(d))}")
    check(hvd.ckpt.stats.COMMITS_ABANDONED.value == abandoned,
          "11a: the commit was abandoned")
    del model, params, box
    free_memory(device)

    model2, params2, box2 = build(1)
    _sync(dev)
    t0 = time.perf_counter()
    trees, got = hvd.ckpt.restore_latest(d, {"params": params2,
                                            "opt": box2["opt"]})
    _sync(dev)
    restore_s = time.perf_counter() - t0
    check(got == 2, f"11a: restored step {got}, want 2")
    with torch.no_grad():
        for k, p in params2.items():
            p.copy_(trees["params"][k])
    box2["opt"] = trees["opt"]
    del trees
    got_params, got_state, got_count = state_host(params2, box2)
    bad = [k for k in snap_params if not torch.equal(got_params[k],
                                                     snap_params[k])]
    bad += [f"{c}/{gi}" for c in snap_state
            for gi, (a, b) in enumerate(zip(got_state[c], snap_state[c]))
            if not torch.equal(a, b)]
    check(not bad and got_count == snap_count,
          f"11a: restored state not bit-equal to the commit's: {bad[:8]}, "
          f"count {got_count} (want {snap_count})")
    del got_params, got_state, snap_params, snap_state
    replay = [timed(model2, params2, box2)[0] for _ in range(3)]
    rel = [abs(a - b) / abs(b) for a, b in zip(replay, losses[2:])]
    log(f"11a P2 checkpoint (BERT-Large, sharded_adamw, world 1): commit at "
        f"step 2, {commit['bytes']:,} bytes a rank ({payload:,} of tensors), "
        f"{n_groups} group(s) {where}; restored into seed-1 weights "
        f"bit-equal (parameters, master, mu, nu, count {got_count})")
    log("  losses: " + " ".join(f"{v:.6f}" for v in losses)
        + "; replayed 3-5: " + " ".join(f"{v:.6f}" for v in replay))
    log(f"  replay vs steps 3-5, relative: {' '.join(f'{v:.3e}' for v in rel)}"
        f" (first bit-equal, the rest within 1e-2)")
    check(replay[0] == losses[2], f"11a: first replayed loss {replay[0]!r} "
                                  f"!= step 3's {losses[2]!r}")
    check(max(rel) <= 1e-2, f"11a: replayed losses off: {rel}")
    log(f"  commit inline {inline_ms:.2f} ms (first commit: {slabs_first} "
        f"host slab(s) allocated, pinned for CUDA tensors); writer "
        f"{1e3 * commit['seconds']:.1f} ms; commit to wait() "
        f"{1e3 * wall_s:.1f} ms {where}")
    log(f"  step 3 racing the writer {contended_ms:.2f} ms; steps 4, 5 "
        f"{rest[0][1]:.2f}, {rest[1][1]:.2f} ms; restore {restore_s:.3f} s "
        f"{where}")

    # 11b: commit, then one B8 step at once, no synchronize
    pre_params, pre_state, _ = state_host(params2, box2)
    slabs = mgr.slab_allocations
    _sync(dev)
    t0 = time.perf_counter()
    mgr.commit({"params": params2, "opt": box2["opt"]}, step=6)
    inline2_ms = 1e3 * (time.perf_counter() - t0)
    b8 = fopt.LAUNCHES["flat_adamw"]
    step(model2, params2, box2)
    b8 = fopt.LAUNCHES["flat_adamw"] - b8
    mgr.wait()
    second_slabs = mgr.slab_allocations - slabs
    writer2_ms = 1e3 * mgr.last_commit["seconds"]
    post = _host(box2["opt"].master)
    _meta, entries = hvd.ckpt.manifest.read_shard(
        os.path.join(d, hvd.ckpt.manifest.shard_name(6, 0, 1)))
    stored = {e["key"]: e["value"] for e in entries}
    bad = [k for i, k in enumerate(sorted(pre_params))
           if not torch.equal(stored[f"params/{i + 1}"], pre_params[k])]
    bad += [f"{c}/{gi}" for c in pre_state
            for gi, t in enumerate(pre_state[c])
            if not torch.equal(stored[f"opt/0#{c}/{gi}"], t)]
    moved = any(not torch.equal(a, b) for a, b in zip(post,
                                                      pre_state["master"]))
    log(f"11b in-place hazard: commit at step 6, then a step at once "
        f"({b8} flat AdamW launch(es), no synchronize): the shard file holds "
        f"the pre-step bytes; master moved by the step: {moved}; host slabs "
        f"allocated at the second commit: {second_slabs}; inline "
        f"{inline2_ms:.2f} ms, writer {writer2_ms:.1f} ms {where}")
    check(not bad, f"11b: the shard file holds post-step bytes: {bad[:8]}")
    check(moved, "11b: the step did not move master; the check saw nothing")
    check(second_slabs == 0, f"11b: {second_slabs} slab(s) allocated at the "
                             f"second commit")
    del stored, entries, pre_params, pre_state, post
    mgr.close()
    launches = {**fa.LAUNCHES, **fopt.LAUNCHES}
    steps = 2 + 3 + 3 + 1
    if dev.type == "cuda":
        want = dict.fromkeys(launches, 0)
        want.update(dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), n_layers * steps),
                    flat_adamw=n_groups * steps)
        check(launches == want, f"11: kernel launches {launches}, want "
                                f"{want}")
    log(f"  phase 11a-b kernel launches over {steps} steps: {launches}")
    del model2, params2, box2
    hvd.shutdown()
    free_memory(device)
    shutil.rmtree(d)


def checkpoint_resnet(cfg, device, card, tmp) -> None:
    """11c: phase 8's ResNet-50 through the rank-0 checkpoint: saved after
    step 2 (parameters, batch-norm buffers, SGD momentum), restored into a
    model from seed 1, the next step's loss bit-equal to the uninterrupted
    run's; a copy with one byte flipped is refused, naming the leaf."""
    where = f"({card})" if device.type == "cuda" else "(no device times)"
    rn = cfg["resnet"]
    rng = np.random.RandomState(0)  # bench.py:306-312, as phase 8
    images = rng.uniform(-1, 1, (rn["batch"], rn["size"], rn["size"], 3)) \
        .astype(np.float32)
    labels = rng.randint(0, rn["classes"], (rn["batch"],)).astype(np.int32)
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))

    def build(seed):
        model = ResNet50(num_classes=rn["classes"], dtype=rn["dtype"],
                         seed=seed)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                            momentum=0.9),
            named_parameters=model.named_parameters())
        return model, opt, make_train_step(model, opt)

    def state_of(model, opt):
        return {"model": model.state_dict(), "opt": opt.state_dict()}

    def tensors(model, opt) -> dict:
        out = {f"model/{k}": v for k, v in model.state_dict().items()}
        out.update({f"opt/{i}": opt.state[p]["momentum_buffer"]
                    for i, p in enumerate(model.parameters())})
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    model, opt, step = build(0)
    losses = [step(x, y).item() for _ in range(2)]
    snap = tensors(model, opt)
    payload = sum(v.numel() * v.element_size() for v in snap.values())
    ckpt_space(tmp, 3 * payload + (64 << 20), "11c")
    d = os.path.join(tmp, "resnet")
    _sync(dev)
    t0 = time.perf_counter()
    path = hvd.checkpoint.save(d, state_of(model, opt), step=2)
    save_ms = 1e3 * (time.perf_counter() - t0)
    loss3 = step(x, y).item()
    del model, opt, step
    free_memory(device)

    model2, opt2, step2 = build(1)
    step2(x, y)  # its momentum buffers: the structure the restore fills
    _sync(dev)
    t0 = time.perf_counter()
    got, s = hvd.checkpoint.restore_latest(d, state_of(model2, opt2))
    _sync(dev)
    restore_ms = 1e3 * (time.perf_counter() - t0)
    check(s == 2, f"11c: restored step {s}, want 2")
    model2.load_state_dict(got["model"])
    opt2.load_state_dict(got["opt"])
    del got
    now = tensors(model2, opt2)
    bad = [k for k in snap if not torch.equal(now[k], snap[k])]
    check(not bad and now.keys() == snap.keys(),
          f"11c: restored tensors not bit-equal: {bad[:8]}")
    loss = step2(x, y).item()
    log(f"11c rank-0 checkpoint (ResNet-50, {len(snap)} tensors: "
        f"parameters, batch-norm buffers, SGD momentum): "
        f"{os.path.getsize(path):,} bytes, save {save_ms:.1f} ms, "
        f"restore_latest {restore_ms:.1f} ms {where}; restored bit-equal; "
        f"step 3 loss {loss!r} resumed, {loss3!r} uninterrupted")
    check(loss == loss3, f"11c: resumed loss {loss!r} != {loss3!r}")

    bad_dir = os.path.join(tmp, "resnet-corrupt")
    os.makedirs(bad_dir)
    copy = os.path.join(bad_dir, os.path.basename(path))
    shutil.copy(path + ".crc", copy + ".crc")
    blob = bytearray(open(path, "rb").read())
    _meta, records, off = hvd.ckpt.manifest.parse_header(blob)
    rec = max(records, key=lambda r: int(r["nbytes"]))
    blob[off + int(rec["offset"]) + int(rec["nbytes"]) // 2] ^= 0x40
    with open(copy, "wb") as f:
        f.write(blob)
    try:
        hvd.checkpoint.restore(copy, state_of(model2, opt2), broadcast=False)
        named = None
    except hvd.CheckpointCorruptError as exc:
        named = exc.leaf
    log(f"11c corrupt copy (one byte of {rec['key']} flipped): refused, "
        f"CheckpointCorruptError names {named!r}")
    check(named == rec["key"], f"11c: the corrupt copy named {named!r}, "
                               f"want {rec['key']!r}")
    del model2, opt2, step2, losses
    hvd.shutdown()
    free_memory(device)


def checkpoint_phase(cfg, device, card) -> None:
    """Phase 11: checkpoint and resume, in a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="hvd-ckpt-") as tmp:
        checkpoint_p2(cfg, device, card, tmp)
        checkpoint_resnet(cfg, device, card, tmp)


# ---------------------------------------------------------------------------
# Phase 12: elastic training
# ---------------------------------------------------------------------------

ELASTIC_STEPS = 6


def _p2_spec(cfg):
    """P2's ZeRO layout at world 1, from the model's shapes alone."""
    return build_spec(
        [LeafMeta(tuple(p.shape), p.dtype) for p in BertLarge(
            **cfg["model"], device="meta").parameters()],
        1, 0, zero_mod._quantum_bytes())


def _elastic_env(**values) -> dict:
    """Set environment knobs, returning what to put back."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return old


def _restore_env(old: dict) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def elastic_run(cfg, device, ckpt_dir=None, on_step=None, stats=None):
    """Phase 5's P2 (BERT-Large from seed 0, the bench's batch, ZeRO-1
    ``sharded_adamw`` through B8) for ``ELASTIC_STEPS`` steps under
    ``@hvd.elastic.run``, ``ArrayState(model, zero_state)`` committed
    every step. ``on_step(state)`` runs after a step's update, before its
    commit. Returns ``{step: loss}`` (a replayed step's loss replaces the
    first attempt's) and fills ``stats``."""
    stats = {} if stats is None else stats
    tokens, positions, labels, _ = mlm_data(cfg)
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    model = BertLarge(**cfg["elastic_model"], device=dev, seed=0)
    tx = hvd.sharded_adamw(1e-4)
    state = hvd.elastic.ArrayState(
        model, tx.init(dict(model.named_parameters())), step=0,
        ckpt_dir=ckpt_dir)
    stats.update(slabs=[state.slab_allocations], commit_ms=[],
                 store=[type(state_mod.global_state().store).__name__],
                 groups=[state_mod.global_state().data_group])
    losses = {}

    @hvd.elastic.run
    def train(state):
        if "t_fail" in stats and "t_enter" not in stats:
            stats["t_enter"] = time.perf_counter()
        try:
            while state.step < ELASTIC_STEPS:
                params = dict(model.named_parameters())
                model.zero_grad(set_to_none=True)
                loss = masked_lm_loss_gathered(
                    model(toks, output="hidden"), model.token_embed, pos,
                    lab)
                loss.backward()
                _, state.optimizer = tx.apply(
                    params, state.optimizer,
                    {k: p.grad for k, p in params.items()})
                losses[state.step + 1] = loss.item()
                state.step += 1
                if on_step is not None:
                    on_step(state)
                _sync(dev)
                try:
                    state.commit()
                finally:
                    stats["commit_ms"].append(
                        1e3 * state.last_commit_seconds)
                    stats["slabs"].append(state.slab_allocations)
        except hvd.NumericalError:
            stats["t_fail"] = time.perf_counter()
            raise

    train(state)
    state.checkpoint_wait()
    st = state_mod.global_state()
    stats["store"].append(type(st.store).__name__)
    stats["groups"].append(st.data_group)
    stats["backend"] = torch.distributed.get_backend(st.data_group)
    stats["step"] = state.step
    stats["state"], stats["tx"], stats["model"] = state, tx, model
    stats["batch"] = (toks, pos, lab)
    return losses


def _release(stats, device) -> None:
    for k in ("state", "tx", "model", "batch", "groups"):
        stats.pop(k, None)
    hvd.shutdown()
    free_memory(device)


def elastic_reform(cfg, device, card, tmp) -> list:
    """12a: the re-form without a rollback. An in-process rendezvous store
    and elastic driver run a discovery script whose output changes after
    step 1 (each worker's first notice is its baseline, as in the JAX
    package) and after step 3: the commit of step 3 raises
    ``HostsUpdatedInterrupt``, ``@elastic.run`` re-forms at world 1 (a new
    store at the assignment's coordinator, new NCCL and gloo groups, a new
    runtime) and syncs, and training goes on to step 6. The losses equal
    an uninterrupted run's in this phase bit for bit."""
    from horovod_tpu_torch.elastic import runner
    from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                                  HostDiscoveryScript)
    from horovod_tpu_torch.run.rendezvous import RendezvousServer

    where = f"({card})" if device.type == "cuda" else "(no device times)"
    clean_stats = {}
    clean = elastic_run(cfg, device, stats=clean_stats)
    _release(clean_stats, device)

    hosts = os.path.join(tmp, "hosts")
    with open(hosts, "w") as f:
        f.write("localhost:1\n")
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    driver = ElasticDriver(server, HostDiscoveryScript(f"cat {hosts}"),
                           discovery_interval=3600)
    driver.start()
    old = _elastic_env(
        HOROVOD_RENDEZVOUS_HTTP_ADDR="127.0.0.1",
        HOROVOD_RENDEZVOUS_HTTP_PORT=port, HOROVOD_ELASTIC=1,
        HOROVOD_ELASTIC_SETTLE_SECONDS=0.2, HOROVOD_CKPT_KEEP=1,
        HOROVOD_COORDINATOR_ADDR=None, HOROVOD_RANK=None, HOROVOD_SIZE=None)

    def change_hosts(state):
        if runner.restarts() == 0 and state.step in (1, 3):
            with open(hosts, "w") as f:
                f.write("localhost:1\n" if state.step == 3
                        else "localhost:1\nspare:1\n")
            driver._poll_once()

    stats = {}
    goodput.tracker().reset()
    try:
        got = elastic_run(cfg, device, ckpt_dir=os.path.join(tmp, "a"),
                          on_step=change_hosts, stats=stats)
    finally:
        runner.stop_heartbeat()
        driver.stop()
        server.stop()
    reform = runner.last_reform()
    incidents = [i for i in goodput.tracker().incidents()
                 if i["cause"] == "elastic_reform"]
    reform_s = sum(v for k, v in reform.items() if k != "generation")
    new_group = stats["groups"][1] is not stats["groups"][0]
    # the store is gone: no final flight dump is shipped to it
    _restore_env(old)
    _release(stats, device)
    log(f"12a re-form (BERT-Large P2, ArrayState(model, zero_state, "
        f"ckpt_dir), a commit a step, world 1): HostsUpdatedInterrupt at "
        f"step 3's commit, generation {runner.restarts()}; store "
        f"{stats['store'][0]} -> {stats['store'][1]}, new data group "
        f"{new_group} ({stats['backend']})")
    log(f"  re-form {1e3 * sum(reform.get(k, 0.0) for k in ('shutdown', 'rendezvous', 'reinit', 'sync')):.1f} ms: "
        f"shutdown {1e3 * reform['shutdown']:.1f}, rendezvous "
        f"{1e3 * reform['rendezvous']:.1f}, reinit "
        f"{1e3 * reform['reinit']:.1f}, sync {1e3 * reform['sync']:.1f} ms "
        f"{where}")
    log("  commit ms: " + " ".join(f"{v:.2f}" for v in stats["commit_ms"])
        + f" {where}; host slabs after the construction, then each commit: "
        f"{stats['slabs']}")
    log("  losses: " + " ".join(f"{got[s]:.6f}" for s in sorted(got))
        + "; uninterrupted: " + " ".join(f"{clean[s]:.6f}"
                                          for s in sorted(clean)))
    log(f"  goodput: {len(incidents)} elastic_reform incident(s), "
        + ", ".join(f"{1e3 * i['duration_s']:.1f} ms (generation "
                    f"{i['generation']}, {i['steps_replayed']} replayed)"
                    for i in incidents)
        + f"; the re-form's parts sum to {1e3 * reform_s:.1f} ms {where}")
    check(len(incidents) == 1 and abs(incidents[0]["duration_s"] - reform_s)
          <= 0.05 * reform_s,
          f"12a: elastic_reform incidents {incidents} against the re-form's "
          f"{reform_s:.4f} s")
    check(runner.restarts() == 1 and stats["step"] == ELASTIC_STEPS,
          f"12a: generation {runner.restarts()}, step {stats['step']}")
    check(new_group and stats["store"][1] != stats["store"][0],
          f"12a: no new group or store after the re-form: {stats['store']}")
    check(device.type != "cuda" or stats["backend"] == "nccl",
          f"12a: the data group is {stats['backend']}, not nccl")
    check(got == clean, f"12a: losses {got} != the uninterrupted {clean}")
    first = stats["slabs"][1]
    check(all(v == first for v in stats["slabs"][1:]),
          f"12a: a commit after the first allocated: {stats['slabs']}")
    return [clean[s] for s in sorted(clean)]


def elastic_rollback(cfg, device, card, tmp, clean: list) -> None:
    """12b: the rollback in place. ``HOROVOD_INTEGRITY=1``,
    ``HOROVOD_INTEGRITY_INTERVAL=1`` and a ``nan`` clause that poisons
    step 4's gradient reduce-scatter: the digest raises ``NumericalError``,
    ``rollback.handle_failure`` restores step 3's checkpoint cut and the
    steps are replayed; then the digest's cost a dispatch, on and off in
    turns."""
    from horovod_tpu_torch.integrity import digest, inject, rollback

    where = f"({card})" if device.type == "cuda" else "(no device times)"
    # the P2 step runs one reduce-scatter a group: steps 1-3 pass
    n_groups = len(_p2_spec(cfg).groups)
    flight = os.path.join(tmp, "flight")
    old = _elastic_env(HOROVOD_INTEGRITY=1, HOROVOD_INTEGRITY_INTERVAL=1,
                       HOROVOD_FAULT_INJECT=f"nan:0:after={3 * n_groups}",
                       HOROVOD_CKPT_KEEP=1,
                       HOROVOD_FLIGHT_RECORDER_DIR=flight)
    inject.reset()
    digest.reset()
    rollback.reset()
    goodput.tracker().reset()
    flight_recorder.recorder()._last_failure_dump = 0.0
    stats = {}
    try:
        got = elastic_run(cfg, device, ckpt_dir=os.path.join(tmp, "b"),
                          stats=stats)
        state, tx, model = stats["state"], stats["tx"], stats["model"]
        toks, pos, lab = stats["batch"]
        ex = state_mod.global_state().runtime.executor
        restore_ms = 1e3 * (stats["t_enter"] - stats["t_fail"])
        os.environ.pop("HOROVOD_FAULT_INJECT")
        inject.reset()

        def step():
            params = dict(model.named_parameters())
            model.zero_grad(set_to_none=True)
            loss = masked_lm_loss_gathered(model(toks, output="hidden"),
                                           model.token_embed, pos, lab)
            loss.backward()
            _, state.optimizer = tx.apply(
                params, state.optimizer,
                {k: p.grad for k, p in params.items()})
            return loss.item()

        runs = []
        for on in (True, False, False, True):
            os.environ["HOROVOD_INTEGRITY"] = "1" if on else "0"
            checks, secs = ex.digest_checks, ex.digest_seconds
            step()
            t0 = time.perf_counter()
            for _ in range(2):
                step()
            ms = 1e3 * (time.perf_counter() - t0) / 2
            runs.append((on, ms, ex.digest_checks - checks,
                         ex.digest_seconds - secs))
        # the digest's own device work a dispatch: the non-finite count
        # over a gradient shard of P2's length
        grad = torch.randn_like(state.optimizer.master[0])
        count_ms = time_ms(lambda: digest.nonfinite_count_tensor(grad),
                           cfg["iters"], grad.device)
        numel = grad.numel()
        count_bound = 1e3 * numel * grad.element_size() / PEAK_BYTES
        del grad
    finally:
        _restore_env(old)
    _release(stats, device)
    inject.reset()
    incidents = [i for i in goodput.tracker().incidents()
                 if i["cause"] == "rollback"]
    dump = flight_recorder.load_dumps(flight)
    reasons = [h["reason"] for d in dump for h in d["dump_history"]]
    named = [e["error"] for d in dump for e in d["events"]
             if e["kind"] == "rollback"]
    flight_recorder.configure()  # the directory is gone with the phase
    log(f"12b goodput: {len(incidents)} rollback incident(s) "
        + ", ".join(f"{1e3 * i['duration_s']:.1f} ms, {i['steps_replayed']} "
                    f"step(s) replayed" for i in incidents)
        + f"; failure dumps {reasons}; rollback events {named}")
    check(len(incidents) == 1, f"12b: rollback incidents {incidents}")
    check("integrity_violation" in reasons and len(named) == 1
          and named[0].startswith("NumericalError"),
          f"12b: no failure dump naming the NumericalError: {reasons} "
          f"{named}")
    log(f"12b rollback in place (nan on step 4's reduce-scatter input, "
        f"HOROVOD_INTEGRITY_INTERVAL=1): replays {rollback.replays()}, "
        f"restored step 3's cut in {restore_ms:.1f} ms {where}")
    log("  losses: " + " ".join(f"{got[s]:.6f}" for s in sorted(got))
        + "; clean: " + " ".join(f"{v:.6f}" for v in clean))
    on = [r for r in runs if r[0]]
    per = sum(r[3] for r in on) / max(1, sum(r[2] for r in on))
    log("  digest on/off in turns, ms a step: " + ", ".join(
        f"{'on' if o else 'off'} {ms:.2f}" for o, ms, _, _ in runs)
        + f"; the cycle thread's digest {1e3 * per:.3f} ms a checked "
        f"dispatch ({sum(r[2] for r in on)} checks) {where}")
    log(f"  the digest's non-finite count over the {numel:,}-element f32 "
        f"gradient shard: {count_ms:.4f} ms (bound {count_bound:.4f} ms, "
        f"bytes) {where}")
    check(rollback.replays() == 1, f"12b: {rollback.replays()} replays")
    check([got[s] for s in sorted(got)] == clean,
          f"12b: replayed losses {got} != the clean {clean}")
    check(all(r[2] == 0 for r in runs if not r[0])
          and all(r[2] > 0 for r in on), f"12b: digest checks {runs}")


def elastic_phase(cfg, device, card) -> None:
    """Phase 12: elastic training, in a temporary directory whose free
    space is checked first. Every kernel of the path launches in it."""
    counts = (fa.LAUNCHES, fopt.LAUNCHES)
    spec = _p2_spec(cfg)
    n_layers = len(BertLarge(**cfg["elastic_model"], device="meta").layers)
    with tempfile.TemporaryDirectory(prefix="hvd-elastic-") as tmp:
        # a cut a rank: f32 parameters, then master, mu and nu padded
        payload = 4 * sum(g.n for g in spec.groups) \
            + 12 * sum(g.padded for g in spec.groups)
        ckpt_space(tmp, 2 * payload + (1 << 30), "12")
        for c in counts:
            c.update(dict.fromkeys(c, 0))
        clean = elastic_reform(cfg, device, card, tmp)
        shutil.rmtree(os.path.join(tmp, "a"), ignore_errors=True)
        elastic_rollback(cfg, device, card, tmp, clean)
    launches = {**fa.LAUNCHES, **fopt.LAUNCHES}
    # forward and backward passes: 12a 6 + 6, 12b 7 (step 4's first try
    # stops at the reduce-scatter), the turns 4 x 3; B8 a completed step
    passes, updates = 6 + 6 + 7 + 12, 6 + 6 + 6 + 12
    log(f"  phase 12 kernel launches over {passes} passes and {updates} "
        f"updates: {launches}")
    if device.type == "cuda":
        want = dict.fromkeys(launches, 0)
        want.update(dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), n_layers * passes),
                    flat_adamw=len(spec.groups) * updates)
        check(launches == want, f"12: kernel launches {launches}, want "
                                f"{want}")


# ---------------------------------------------------------------------------
# phase 13: the observability planes
# ---------------------------------------------------------------------------

PLANE_KNOBS = (env.HOROVOD_FLIGHT_RECORDER, env.HOROVOD_MEMORY,
               env.HOROVOD_COMMS, env.HOROVOD_GOODPUT)


def planes(on: bool, device) -> None:
    """All four planes on or off, in the running process (each plane's
    ``configure`` reads its knob, as ``init()`` does)."""
    for k in PLANE_KNOBS:
        os.environ[k] = "1" if on else "0"
    flight_recorder.configure()
    memory.configure(device=device)
    comms.configure()
    goodput.configure()


def _get_json(route: str):
    port = metrics_registry().http_port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _turns(step, n: int, set_on, order=(True, False, False, True)) -> dict:
    """``n`` steps a turn in ``order`` (planes on/off); each turn's step
    ms (host clock around ``step().item()``, which waits for the step's
    last kernel) and the runtime's dispatches a step."""
    out = {True: [], False: []}
    for on in order:
        set_on(on)
        before = sum(hrt.COUNTS[k] for k in ("allreduce", "reducescatter",
                                             "allgather"))
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            step().item()
            times.append(1e3 * (time.perf_counter() - t0))
        sent = sum(hrt.COUNTS[k] for k in ("allreduce", "reducescatter",
                                           "allgather")) - before
        out[on].append((statistics.median(times), sent / n))
    return out


def observability_phase(cfg, device, card) -> None:
    """Phase 13: phase 5's P2 (BERT-Large, seed 0, ZeRO-1 ``sharded_adamw``
    through B8, B1-B6 in the forward and backward) with the four planes on
    and off in turns, then every plane's surface checked; then P4's
    host-bound step with the planes on and off in turns (the comms plane's
    CUDA event pairs cost the cycle thread host time a dispatch)."""
    on_card = device.type == "cuda"
    where = f"({card})" if on_card else "(no device times)"
    spec = _p2_spec(cfg)
    n_layers = len(BertLarge(**cfg["model"], device="meta").layers)
    tokens, positions, labels, _ = mlm_data(cfg)
    with tempfile.TemporaryDirectory(prefix="hvd-planes-") as tmp:
        flight = os.path.join(tmp, "flight")
        old = _elastic_env(HOROVOD_FLIGHT_RECORDER_DIR=flight,
                           HOROVOD_METRICS_PORT=0,
                           HOROVOD_MEMORY_SAMPLE_SECONDS=1,
                           HOROVOD_PROFILE=1)
        try:
            _planes_p2(cfg, device, where, spec, n_layers, flight,
                       (tokens, positions, labels))
            os.environ.pop("HOROVOD_PROFILE")
            _planes_p4(cfg, device, where, (tokens, positions, labels))
        finally:
            _restore_env(old)
            for k in PLANE_KNOBS:
                os.environ.pop(k, None)


def _planes_p2(cfg, device, where, spec, n_layers, flight, data) -> None:
    on_card = device.type == "cuda"
    steps = cfg["obs_steps"]
    for c in (fa.LAUNCHES, fopt.LAUNCHES):
        c.update(dict.fromkeys(c, 0))
    hvd.init(device=None if on_card else "cpu")
    dev = hvd.device()
    model = BertLarge(**cfg["model"], device=dev, seed=0)
    params = dict(model.named_parameters())
    batch = tuple(torch.from_numpy(a).to(dev) for a in data)
    p2_step, _ = make_step("zero", model, params, dev, batch)

    def step():  # a profiled step: the goodput ledger's step source
        with hvd.profiler.step():
            return p2_step()

    planes(True, dev)
    comms.tracker().reset()
    goodput.tracker().reset()
    goodput.tracker().start_epoch()
    step().item()  # warm-up: the cache and the allocator settle
    turns = _turns(step, steps, lambda on: planes(on, dev))
    planes(True, dev)
    _sync(dev)
    comms.tracker().sweep()
    # -- the dump and the routes ----------------------------------------
    path = os.path.join(flight, "flight-rank-0.json")
    hvd.dump_debug_state(path)
    dumps = flight_recorder.load_dumps(flight)
    check(len(dumps) == 1 and dumps[0]["schema"] == flight_recorder.SCHEMA
          and {"memory", "comms", "goodput", "runtime"}
          <= set(dumps[0]["state"]),
          f"13: the dump read back: {[d.get('schema') for d in dumps]}")
    served = {r: _get_json(r) for r in ("/debug", "/memory", "/comms",
                                        "/goodput")}
    log("13 routes: " + ", ".join(
        f"GET {r} {st} ({len(json.dumps(doc))} bytes)"
        for r, (st, doc) in served.items()))
    check(all(st == 200 and isinstance(doc, dict)
              for st, doc in served.values()), "13: a route failed")
    # -- the memory ledger against the allocator, at one instant ---------
    _sync(dev)
    led = memory.tracker().ledger()
    alloc = torch.cuda.memory_allocated(dev) if on_card else 0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    shard = 12 * sum(g.shard_elems for g in spec.groups)
    got_shard = led["subsystems"]["optimizer_shards"]["bytes"]
    log(f"13 memory: device {led['device']['bytes_in_use']:,} B in use "
        f"(allocator {alloc:,}), peak {led['device']['peak_bytes_in_use']:,}"
        f" ({peak:,}), limit {led['device']['bytes_limit']:,}, reserved "
        f"{led['device']['bytes_reserved']:,}; optimizer_shards "
        f"{got_shard:,} B (P2's master, mu, nu: {shard:,}); drift "
        f"{led['reconcile_drift_ratio']}; samples "
        f"{len(memory.tracker().samples())} {where}")
    check(got_shard == shard, f"13: optimizer_shards {got_shard} != {shard}")
    if on_card:
        check(led["device"]["bytes_in_use"] == alloc
              and led["device"]["peak_bytes_in_use"] == peak,
              "13: the ledger's device bytes are not the allocator's")
    # -- the zero lane: exact bytes, device seconds under the copy bound --
    windows = {k: list(w) for k, w in comms.tracker()._windows.items()}
    want = {4 * g.padded for g in spec.groups}
    zero = [(k, r) for k, w in windows.items() if k[1] == "zero" for r in w]
    bound_gbs = PEAK_BYTES / 2 / 1e9  # one read and one write a byte
    algbw = [r[1] / r[2] / 1e9 for _, r in zero]
    log(f"13 comms: {len(zero)} zero-lane records, bytes "
        f"{sorted({r[1] for _, r in zero})} (want {sorted(want)}); algbw "
        f"GB/s min {min(algbw):.2f} median {statistics.median(algbw):.2f} "
        f"max {max(algbw):.2f} (copy bound {bound_gbs:.0f}) {where}")
    check(zero and all(r[1] in want for _, r in zero),
          f"13: zero-lane bytes {[r[1] for _, r in zero]} not in {want}")
    check(all(0 < a < bound_gbs for a in algbw) if on_card
          else all(a > 0 for a in algbw),
          f"13: a zero-lane algbw outside (0, {bound_gbs}) GB/s: {algbw}")
    # -- the OOM record ----------------------------------------------------
    _planes_oom(dev, where)
    step().item()  # the phase goes on after the OOM
    gp = goodput.tracker().ledger()
    log(f"13 goodput: {gp['steps_productive']} productive steps (the "
        f"profiled steps with the planes on), goodput "
        f"{gp['goodput_fraction']:.3f}, badput "
        f"{ {k: round(v, 3) for k, v in gp['badput_seconds'].items()} }")
    check(gp["steps_productive"] == 1 + 2 * steps + 1,
          f"13: {gp['steps_productive']} productive steps, want "
          f"{2 + 2 * steps}")
    launches = {**fa.LAUNCHES, **fopt.LAUNCHES}
    n_steps = 1 + 4 * steps + 1
    hvd.shutdown()
    del model, params, step, p2_step, batch
    free_memory(device)
    # after the runtime stopped: every dispatched collective was recorded
    # once, with the device's seconds
    dev_ops = sum(len(w) for k, w in comms.tracker()._windows.items()
                  if k[1] == "device")
    on_turns = sum(sent * steps for _, sent in turns[True])
    log(f"13 device-lane records {dev_ops}; collectives in the on turns, "
        f"the warm-up and the last steps {on_turns} + ...")
    check(comms.tracker().pending_spans() == 0, "13: event pairs pending")
    check(dev_ops >= on_turns, f"13: {dev_ops} device-lane records for "
                               f"{on_turns} collectives")
    on_ms = [ms for ms, _ in turns[True]]
    off_ms = [ms for ms, _ in turns[False]]
    log(f"13 observability planes on BERT-Large P2, {steps} steps a turn "
        f"(on, off, off, on), step ms medians: on {on_ms[0]:.2f}, off "
        f"{off_ms[0]:.2f}, off {off_ms[1]:.2f}, on {on_ms[1]:.2f} {where}")
    log(f"  phase 13 kernel launches over {n_steps} steps: {launches}")
    if on_card:
        want_l = dict.fromkeys(launches, 0)
        want_l.update(dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"), n_layers * n_steps),
                      flat_adamw=len(spec.groups) * n_steps)
        check(launches == want_l, f"13: kernel launches {launches}, want "
                                  f"{want_l}")


def _planes_oom(dev, where) -> None:
    """A real ``torch.cuda.OutOfMemoryError`` (an allocation past the
    card's free bytes) through ``memory.maybe_record_oom``; on the CPU a
    built one."""
    exc = None
    if dev.type == "cuda":
        # past the card's free bytes and the allocator's cache: its total
        free, total = torch.cuda.mem_get_info(dev)
        try:
            torch.empty(total + (1 << 30), dtype=torch.uint8, device=dev)
        except torch.cuda.OutOfMemoryError as e:
            exc = e
    else:
        exc = torch.cuda.OutOfMemoryError("CUDA out of memory (rehearsal)")
    check(exc is not None, "13: the oversized allocation did not fail")
    recorded = memory.maybe_record_oom(exc, where="chip_smoke")
    del exc
    oom = memory.tracker().last_oom() or {}
    top = oom.get("top_live_arrays") or []
    figures = oom.get("device") or {}
    log(f"13 OOM record: recorded {recorded}, dominant "
        f"{oom.get('dominant_subsystem')}, allocator in use "
        f"{figures.get('bytes_in_use', 0):,} of "
        f"{figures.get('bytes_limit', 0):,} B; largest live: "
        + ", ".join(f"{r['bytes']:,} B {r['shape']} {r['owner']}"
                    for r in top[:3]) + f" {where}")
    check(recorded and top and (dev.type != "cuda" or (
        figures.get("bytes_in_use", 0) > 0
        and figures.get("bytes_limit", 0) > 0)),
          "13: the OOM record lacks the allocator's figures or the live "
          "tensors")
    free_memory(dev)


def _planes_p4(cfg, device, where, data) -> None:
    """P4 (stage 2 through ``make_train_step``, 145 groups on BERT-Large):
    the planes on and off in turns, and the host ms a dispatch they cost."""
    steps = cfg["obs_p4_steps"]
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = BertLarge(**cfg["model"], device=dev, seed=0)
    params = dict(model.named_parameters())
    batch = tuple(torch.from_numpy(a).to(dev) for a in data)
    step, _ = make_step("zero2", model, params, dev, batch)
    planes(True, dev)
    step().item()
    turns = _turns(step, steps, lambda on: planes(on, dev))
    hvd.shutdown()
    del model, params, step, batch
    free_memory(device)
    on = statistics.mean(ms for ms, _ in turns[True])
    off = statistics.mean(ms for ms, _ in turns[False])
    sent = statistics.mean(n for _, n in turns[True] + turns[False])
    log(f"13 P4 (stage 2, release plan), {steps} steps a turn (on, off, off,"
        f" on), step ms medians: " + ", ".join(
            f"{'on' if o else 'off'} {ms:.2f}" for o, (ms, _) in zip(
                (True, False, False, True),
                (turns[True][0], turns[False][0], turns[False][1],
                 turns[True][1])))
        + f"; {sent:.0f} dispatches a step; on - off {on - off:+.2f} ms a "
        f"step, {1e3 * (on - off) / max(sent, 1):+.2f} us a dispatch "
        f"{where}")


# ---------------------------------------------------------------------------
# Phase 14: the transformer options, VGG-16 and the MoE LM
# ---------------------------------------------------------------------------


def _drive(step, warmup: int, steps: int, dev) -> dict:
    """``warmup + steps`` calls of ``step() -> loss``: the losses, each timed
    step's seconds, ``runtime.COUNTS`` after each step and the requested
    collectives of each (``collectives.COUNTS`` summed), and the peak
    memory from the first step on."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, snaps, requested = [], [], [dict(hrt.COUNTS)], []
    for i in range(warmup + steps):
        collectives.reset_counts()
        t0 = time.perf_counter()
        losses.append(step().item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
        requested.append(sum(collectives.COUNTS.values()))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return dict(losses=losses, times=times, issued=runtime_steps(snaps),
                alltoall=[b["alltoall"] - a["alltoall"]
                          for a, b in zip(snaps, snaps[1:])],
                requested=requested, peak=peak,
                step_ms=1e3 * statistics.median(times))


def _falling(what: str, losses: list) -> None:
    check(all(math.isfinite(x) for x in losses), f"{what}: non-finite loss")
    check(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")


def bert_options(cfg, device, card, phase4_first: float) -> dict:
    """14a: BERT-Large with ``fused_qkv=True`` and ``remat=True`` on phase
    4's hooks path (AdamW, the bench's gathered MLM batch), its weights
    phase 4's seed-0 ones fused by concatenation (``fuse_qkv_state``): 2
    warm-up and 10 timed steps, then turns at ``remat`` off, off, on
    (``opt_turn_steps`` each) for the peak memory. The first loss within
    1e-2 of phase 4's; losses finite and falling; B1/B2 launched twice a
    layer a step under remat (the backward's recomputation), B3-B6 once;
    every turn's losses within 1e-3 of the main run's; the remat peak
    below the plain one; every gradient from the response cache from the
    second step, fewer NCCL calls a step than gradients, no slab or group
    after warm-up."""
    tokens, positions, labels, _ = mlm_data(cfg)
    warm, timed = cfg["opt_turn_steps"]
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    unfused = BertLarge(**cfg["model"], device=dev, seed=0)
    state = fuse_qkv_state(unfused.state_dict())
    del unfused
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    runs = []
    try:
        for remat, steps in ((True, (cfg["warmup"], cfg["steps"])),
                             (False, (warm, timed)), (False, (warm, timed)),
                             (True, (warm, timed))):
            # built on meta (no values drawn), given a copy of the weights
            model = BertLarge(**cfg["model"], device="meta",
                              fused_qkv=True, remat=remat)
            model.load_state_dict({k: v.clone() for k, v in state.items()},
                                  assign=True)
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            opt = adamw_optimizer(model)
            n_tensors = len(list(model.parameters()))
            n_layers = len(model.layers)

            def step():
                opt.zero_grad()
                hidden = model(toks, output="hidden")
                loss = masked_lm_loss_gathered(hidden, model.token_embed,
                                               pos, lab)
                loss.backward()
                opt.step()
                return loss.detach()

            fa.reset_launch_counts()
            run = _drive(step, *steps, dev)
            run.update(remat=remat, launches=dict(fa.LAUNCHES),
                       steps=sum(steps))
            runs.append(run)
            del model, opt, step
            free_memory(device)
    finally:
        hvd.shutdown()
        free_memory(device)

    main = runs[0]
    where = f"({card})"
    log(f"14a BERT-Large fused_qkv + remat (hooks, AdamW): {n_layers} "
        f"layers, {n_tensors} parameter tensors, batch {cfg['batch']} x seq "
        f"{cfg['seq']}, {cfg['warmup']} warm-up + {cfg['steps']} timed "
        f"steps, then remat off, off, on ({warm} + {timed} steps each)")
    log("  losses: " + " ".join(f"{x:.4f}" for x in main["losses"]))
    log(f"  kernel launches: {main['launches']}")
    log_runtime("BERT-Large fused_qkv + remat", main["issued"])
    _falling("14a", main["losses"])
    first = abs(main["losses"][0] - phase4_first) / abs(phase4_first)
    log(f"  first loss {main['losses'][0]:.6f} vs phase 4's "
        f"{phase4_first:.6f}: relative {first:.3e} (limit 1e-2)")
    check(first <= 1e-2, f"14a first loss off phase 4's by {first:.3e}")
    # the recomputed forwards spread the backward's gradients over more
    # cycles than phase 4's (a fused bin is what one cycle finds ready):
    # held to fewer calls than gradients, as ResNet-50's are
    check_hooks_runtime(cfg, main["issued"], n_tensors,
                        env.DEFAULT_FUSION_THRESHOLD_BYTES,
                        dev.type == "cuda", card_limit=n_tensors)
    for run in runs[1:]:
        worst = _worst(run["losses"], main["losses"][:len(run["losses"])])
        check(worst <= 1e-3, f"14a remat={run['remat']}: losses off the "
                             f"main run's by {worst:.3e}")
    if dev.type == "cuda":
        want = {k: 0 for k in main["launches"]}
        want.update(flash_fwd=2 * n_layers * main["steps"],
                    flash_bwd_dq=n_layers * main["steps"],
                    flash_bwd_dkv=n_layers * main["steps"])
        check(main["launches"] == want,
              f"14a kernel launches {main['launches']}, want {want}")
        per_step = {k: v // main["steps"] for k, v in
                    main["launches"].items() if v}
        log(f"  B1-B6 launches a step: {per_step} (remat: the flash "
            f"forward twice a layer)")
        for run in runs:
            log(f"  remat {str(run['remat']):5s}: step "
                f"{run['step_ms']:.2f} ms median, max_memory_allocated "
                f"{run['peak'] / 2**30:.3f} GiB {where}")
        on = [r["peak"] for r in runs if r["remat"]]
        off = [r["peak"] for r in runs if not r["remat"]]
        check(max(on) < min(off), f"14a: remat peaks {on} not below the "
                                  f"plain ones {off}")
    return dict(launches=main["launches"], losses=main["losses"])


def train_vgg(cfg, device, card) -> None:
    """14b: VGG-16 as the bench's ``vgg`` row runs it (``bench.py:89,
    280-287``): ``VGG16(1000, bf16, seed=0)``, the bench's images and
    labels, ``DistributedOptimizer(SGD(0.01 x size, momentum 0.9))``
    through ``make_train_step``, 2 warm-up and 10 timed steps. Losses
    finite and falling; every step's bins (``fusion.fuse_responses``)
    hold ``fc1.kernel`` alone, its 411 MB gradient over the 64 MiB
    threshold; every gradient from the response cache from the second
    step; no fusion slab or group after warm-up."""
    vg = cfg["vgg"]
    batch, size = vg["batch"], vg["size"]
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, vg["classes"], (batch,)).astype(np.int32)
    bins, real = [], fusion_mod.fuse_responses

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        bins.append([list(r.tensor_names) for r in out])
        return out

    threshold = vg["threshold"] or env.DEFAULT_FUSION_THRESHOLD_BYTES
    collectives.reset_counts()
    with knobs(**{env.HOROVOD_FUSION_THRESHOLD: threshold}):
        hvd.init(device=None if device.type == "cuda" else "cpu")
    fusion_mod.fuse_responses = recorded
    try:
        dev = hvd.device()
        model = VGG16(num_classes=vg["classes"], dtype=vg["dtype"],
                      image_size=size, seed=0)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                            momentum=0.9),
            named_parameters=model.named_parameters())
        train_step = make_train_step(model, opt)
        x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
        n_tensors = len(list(model.parameters()))
        n_params = sum(p.numel() for p in model.parameters())
        fc1_bytes = model.fc1.kernel.numel() * 4
        marks = []

        def step():
            marks.append(len(bins))
            return train_step(x, y)

        run = _drive(step, cfg["warmup"], cfg["steps"], dev)
        marks.append(len(bins))
        del model, opt, train_step, step
    finally:
        fusion_mod.fuse_responses = real
        hvd.shutdown()
        free_memory(device)

    per_step = [[b for cycle in bins[a:z] for b in cycle]
                for a, z in zip(marks, marks[1:])]
    alone = [sum(b == ["fc1.kernel"] for b in s) for s in per_step]
    log(f"14b VGG-16: {n_params:,} params in {n_tensors} tensors, batch "
        f"{batch} x {size}^2 NHWC, {vg['dtype']}, SGD(0.01, momentum 0.9) "
        f"hooks, {cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{v:.4f}" for v in run["losses"]))
    log_runtime("VGG-16", run["issued"])
    log(f"  fusion groups a step: {[len(s) for s in per_step]}; fc1.kernel "
        f"({fc1_bytes:,} bytes, threshold {threshold:,}) alone a step: "
        f"{alone}")
    _falling("14b VGG-16", run["losses"])
    check(all(n == 1 for n in alone), f"14b: fc1.kernel rode alone {alone} "
                                      f"times a step, want 1")
    check(fc1_bytes > threshold,
          f"14b: fc1's {fc1_bytes} bytes are not over the threshold")
    check_hooks_runtime(cfg, run["issued"], n_tensors, threshold,
                        device.type == "cuda", card_limit=n_tensors)
    if device.type == "cuda":
        check(n_params == 138_357_544, f"VGG-16 has {n_params} params")
        img_s = batch / (run["step_ms"] / 1e3)
        where = f"({card})"
        log(f"  step {run['step_ms']:.2f} ms median {where}")
        log(f"  images/s {img_s:.1f} {where}")
        log(f"  MFU {img_s * VGG_FLOPS / PEAK_FLOPS:.4f} against 989 TFLOP/s "
            f"bf16, {VGG_FLOPS / 1e9:.3f} GFLOP/image {where}")
        log(f"  NCCL calls a step {run['issued']['allreduce']} {where}")
        log(f"  max_memory_allocated {run['peak'] / 2**30:.2f} GiB {where}")


def train_moe(cfg, device, card) -> dict:
    """14c: the MoE LM at GPT-2-small's widths (``moe_lm``), one expert at
    world 1, ``default_capacity`` of the rank's tokens, the loss of
    ``moe_lm_loss``, ``DistributedOptimizer(Adam(3e-3))`` over the shared
    parameters and a plain Adam over the experts (the JAX test's
    optimizer), 2 warm-up and 10 timed steps. Losses finite and falling;
    B1-B6 once a layer a step; from the second step every collective the
    step requests (the exchanges ``moe.l<i>.dispatch``/``.combine`` and
    their gradients among them) answered from the response cache."""
    mc = cfg["moe_lm"]
    batch, seq = cfg["moe_batch"], mc["max_seq"]
    tokens = np.random.RandomState(0).randint(
        0, mc["vocab_size"], (batch, seq)).astype(np.int32)
    fa.reset_launch_counts()
    hvd.init(device=None if device.type == "cuda" else "cpu")
    try:
        dev = hvd.device()
        model = moe.MoeLM(**mc, seed=0)
        capacity = hvd.default_capacity(batch * seq, hvd.size())
        named = list(model.named_parameters())
        shared = [(n, p) for n, p in named if n.startswith("shared.")]
        experts = [p for n, p in named if n.startswith("experts.")]
        opt_s = hvd.DistributedOptimizer(
            torch.optim.Adam([p for _, p in shared], lr=3e-3),
            named_parameters=shared)
        opt_e = torch.optim.Adam(experts, lr=3e-3)
        toks = torch.from_numpy(tokens).to(dev)
        n_params = sum(p.numel() for _, p in named)

        def step():
            opt_s.zero_grad()
            opt_e.zero_grad()
            loss = moe.moe_lm_loss(model, toks, capacity)
            loss.backward()
            opt_s.step()
            opt_e.step()
            return loss.detach()

        run = _drive(step, cfg["warmup"], cfg["steps"], dev)
        launches = dict(fa.LAUNCHES)
        n_layers = len(model.shared.layers)
        del model, opt_s, opt_e, step
    finally:
        hvd.shutdown()
        free_memory(device)

    steps = cfg["warmup"] + cfg["steps"]
    log(f"14c MoE LM: {n_layers} layers x {mc['d_model']}, "
        f"{mc['num_heads']} heads, d_ff {mc['d_ff']}, vocab "
        f"{mc['vocab_size']}, {n_params / 1e6:.1f}M params on this rank, "
        f"1 expert (world 1), batch {batch} x seq {seq}, capacity "
        f"{capacity}, Adam(3e-3), {cfg['warmup']} warm-up + "
        f"{cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{v:.4f}" for v in run["losses"]))
    log(f"  kernel launches: {launches}")
    log_runtime("MoE LM", run["issued"])
    hits = run["issued"]["cache_hits"]
    log(f"  collectives requested a step {run['requested']}; alltoalls "
        f"issued a step {run['alltoall']} (4 a layer)")
    _falling("14c MoE LM", run["losses"])
    check(all(h == n for h, n in zip(hits[1:], run["requested"][1:])),
          f"14c: cache hits a step {hits}, requested {run['requested']}")
    check(all(a == 4 * n_layers for a in run["alltoall"]),
          f"14c: alltoalls a step {run['alltoall']}, want {4 * n_layers}")
    if device.type == "cuda":
        want = {k: 0 for k in launches}
        want.update(dict.fromkeys(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), n_layers * steps))
        check(launches == want, f"14c kernel launches {launches}, want "
                                f"{want}")
        where = f"({card})"
        log(f"  step {run['step_ms']:.2f} ms median; tokens/s "
            f"{batch * seq / (run['step_ms'] / 1e3):.1f} {where}")
        log(f"  max_memory_allocated {run['peak'] / 2**30:.2f} GiB {where}")
    return dict(launches=launches)


def gpt_loss_turns(cfg, device, card) -> None:
    """A16's measurement: GPT-2-small on phase 7's path (hooks, AdamW(1e-4,
    weight_decay 1e-4), the bench's tokens, dq + dk/dv) with the
    full-logits ``causal_lm_loss`` and with ``causal_lm_loss_chunked``
    (``lm_chunk`` positions a chunk), in turns full, chunked, chunked,
    full: each run's step ms and peak memory. Each run's first loss within
    1e-3 of the first full run's (the same function up to float32
    summation order)."""
    batch, seq = cfg["gpt_batch"], cfg["gpt_seq"]
    tokens = np.random.RandomState(0).randint(
        0, cfg["gpt"]["vocab_size"], (batch, seq)).astype(np.int32)
    chunk = cfg["lm_chunk"]
    warm, timed = cfg["opt_turn_steps"]
    hvd.init(device=None if device.type == "cuda" else "cpu")
    runs = []
    try:
        dev = hvd.device()
        toks = torch.from_numpy(tokens).to(dev)
        for chunked in (False, True, True, False):
            model = GPT2Small(**cfg["gpt"], device=dev, seed=0)
            opt = adamw_optimizer(model)

            def step():
                opt.zero_grad()
                if chunked:
                    loss = causal_lm_loss_chunked(
                        model(toks, output="hidden"), model.token_embed,
                        toks, chunk)
                else:
                    loss = causal_lm_loss(model(toks), toks)
                loss.backward()
                opt.step()
                return loss.detach()

            run = _drive(step, warm, timed, dev)
            run["chunked"] = chunked
            runs.append(run)
            del model, opt, step
            free_memory(device)
    finally:
        hvd.shutdown()
        free_memory(device)
    where = f"({card})"
    log(f"GPT-2-small loss turns (full, chunked {chunk}, chunked, full; "
        f"{warm} + {timed} steps each, batch {batch} x seq {seq}):")
    for run in runs:
        name = f"chunked {chunk}" if run["chunked"] else "full logits"
        log(f"  {name:12s}: step {run['step_ms']:.2f} ms median, "
            f"max_memory_allocated {run['peak'] / 2**30:.3f} GiB, first "
            f"loss {run['losses'][0]:.6f} {where}")
        first = abs(run["losses"][0] - runs[0]["losses"][0]) / abs(
            runs[0]["losses"][0])
        check(first <= 1e-3 and all(math.isfinite(v) for v in run["losses"]),
              f"GPT-2 chunked={run['chunked']}: first loss off by {first:.3e}")


def options_and_models_phase(cfg, device, card, phase4_first) -> dict:
    """Phase 14: 14a-14c and the loss turns; the flash launches of 14a and
    14c for the kernels line (14d)."""
    a = bert_options(cfg, device, card, phase4_first)
    train_vgg(cfg, device, card)
    c = train_moe(cfg, device, card)
    gpt_loss_turns(cfg, device, card)
    launches = {k: a["launches"][k] + c["launches"][k]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"phase 14 kernel launches (14a + 14c): {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the gradient wire's extensions (the probes and the autotuner)
# ---------------------------------------------------------------------------


def probes_15a(device, card) -> None:
    """15a: the hardware probes at world 1 through ``probe_and_seed`` with
    the probe cache at a temporary path: the memory copy bandwidth beside
    the 3.35 TB/s peak, the allreduce probe (at world 1 one read and one
    write of its buffer: the JAX probe's one-device pass), the seeded
    threshold; the artifact read back (the second call probes nothing and
    seeds the same threshold), ignored at another world size; the
    ``device`` roofline stays unseeded at world 1, whose bus bandwidth is
    0 by the bus factor."""
    hvd.init(device=None if device.type == "cuda" else "cpu")
    tracker = comms.tracker()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "probe.json")
            with knobs(**{env.HOROVOD_PROBE_CACHE: path}):
                cfg1 = env.Config.from_env()
                t0 = time.perf_counter()
                m = aprobe.probe_and_seed(cfg1, world=hvd.size(),
                                          rank=hvd.rank())
                probe_s = time.perf_counter() - t0
                cfg2 = env.Config.from_env()
                again = aprobe.probe_and_seed(cfg2, world=hvd.size(),
                                              rank=hvd.rank())
                doc = aprobe.load_cached_roofline(path, world=hvd.size())
                other = aprobe.load_cached_roofline(path, world=4)
                with tracker._lock:
                    tracker._roofline.pop("device", None)
                comms.configure(rank=hvd.rank(), world=hvd.size())
                seeded = tracker._roofline.get("device")
    finally:
        hvd.shutdown()
    where = "(no device times)" if device.type != "cuda" else f"({card})"
    log(f"15a probes at world 1 ({probe_s:.2f} s): memory copy "
        f"{m['hbm_gbps']:.1f} GB/s ({m['hbm_gbps'] / (PEAK_BYTES / 1e9):.3f}"
        f" of the 3350 GB/s peak), allreduce algbw "
        f"{m['allreduce_gbps']:.1f} GB/s (world 1: a read and a write of "
        f"its buffer), busbw {m['allreduce_busbw_gbps']:.1f} GB/s -> "
        f"fusion threshold {m['fusion_threshold_bytes']} bytes {where}")
    check(not m["cached"] and m["hbm_gbps"] > 0 and m["allreduce_gbps"] > 0,
          f"15a probe: {m}")
    if device.type == "cuda":
        check(m["hbm_gbps"] < PEAK_BYTES / 1e9 * 1.02,
              f"15a copy bandwidth {m['hbm_gbps']:.1f} GB/s above the peak")
    check(again["cached"] and again["hbm_gbps"] == m["hbm_gbps"]
          and cfg2.fusion_threshold_bytes == cfg1.fusion_threshold_bytes,
          f"15a cache: second probe {again}")
    check(doc is not None and doc["hbm_gbps"] == m["hbm_gbps"]
          and doc["fusion_threshold_bytes"] == m["fusion_threshold_bytes"],
          f"15a cache file {doc}")
    check(other is None, "15a: an artifact of world 1 read at world 4")
    check(m["allreduce_busbw_gbps"] == 0.0 and seeded is None,
          f"15a: device roofline {seeded} at world 1")
    log(f"  15a probe cache: written, read back (second call cached, the "
        f"same threshold), ignored at world 4; the device roofline stays "
        f"unseeded at world 1 (bus bandwidth 0)")


AUTOTUNE_KNOBS = {env.HOROVOD_AUTOTUNE: 1,
                  env.HOROVOD_AUTOTUNE_WARMUP_SAMPLES: 1,
                  env.HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE: 1,
                  env.HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES: 3}


def _bert_run(cfg, device, state: dict, batch, steps: tuple,
              until_frozen=0):
    """One BERT-Large run on phase 4's hooks path from ``state`` (phase 4's
    seed-0 weights) under the knobs of the environment: ``init()``, the
    steps (``warm-up, timed``; with ``until_frozen``, more steps until the
    autotuner freezes, at most that many), ``shutdown()``. Returns the
    losses, step ms, flash launches, and the tuner's view at the end."""
    toks, pos, lab = batch
    moved = flatten_snapshot(hvd.metrics()).get(
        "horovod_autotune_commits_total", 0)
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    since, commits = time.time(), {}

    def collect():
        # the flight recorder's ring holds a few steps of events: its
        # autotune commits are read after every step
        for e in list(flight_recorder.recorder()._events):
            if e["kind"] == "autotune_commit" and e["t"] >= since:
                commits.setdefault(e["t"], e)

    try:
        model = BertLarge(**cfg["model"], device="meta")
        model.load_state_dict({k: v.to(dev, copy=True)
                               for k, v in state.items()}, assign=True)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        collect()
        opt = adamw_optimizer(model)

        def step():
            opt.zero_grad()
            loss = masked_lm_loss_gathered(model(toks, output="hidden"),
                                           model.token_embed, pos, lab)
            loss.backward()
            opt.step()
            collect()
            return loss.detach()

        fa.reset_launch_counts()
        run = _drive(step, *steps, dev)
        rt = state_mod.global_state().runtime
        while until_frozen and rt._autotune_active \
                and len(run["losses"]) < until_frozen:
            run["losses"].append(step().item())
        run.update(launches=dict(fa.LAUNCHES),
                   steps=len(run["losses"]),
                   active=rt._autotune_active,
                   params=(rt.param_manager.params()
                           if rt.param_manager is not None else None),
                   swept=(rt.param_manager.swept_knobs
                          if rt.param_manager is not None else ()),
                   n_layers=len(model.layers))
        del model, opt, step
    finally:
        hvd.shutdown()
        free_memory(device)
    collect()
    run["commits"] = [commits[t] for t in sorted(commits)]
    run["commits_counted"] = flatten_snapshot(hvd.metrics()).get(
        "horovod_autotune_commits_total", 0) - moved
    return run


def autotune_15b(cfg, device, card, phase4: list) -> dict:
    """15b: BERT-Large at full width on phase 4's hooks path with
    ``HOROVOD_AUTOTUNE=1`` (one warm-up sample, one busy cycle a sample,
    three Bayesian points: the tuner freezes within the phase), the same
    steps as phase 4, then until it freezes; every ``autotune_commit`` and
    the frozen knobs printed; then the step ms in turns with the first
    knobs and the frozen ones (first, frozen, frozen, first). At world 1
    every reduction is exact, so every run's losses equal phase 4's bit for
    bit, under every knob set the tuner tried."""
    tokens, positions, labels, _ = mlm_data(cfg)
    dev = torch.device("cuda") if device.type == "cuda" else device
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in (tokens, positions, labels))
    state = {k: v.detach().cpu() for k, v in
             BertLarge(**cfg["model"], device=dev, seed=0)
             .state_dict().items()}
    free_memory(device)
    where = "(no device times)" if device.type != "cuda" else f"({card})"
    with tempfile.TemporaryDirectory() as tmp, \
            knobs(**AUTOTUNE_KNOBS,
                  **{env.HOROVOD_AUTOTUNE_LOG: os.path.join(tmp, "at.csv")}):
        tuned = _bert_run(cfg, device, state, batch,
                          (cfg["warmup"], cfg["steps"]),
                          until_frozen=cfg["autotune_max_steps"])
        csv_rows = open(os.path.join(tmp, "at.csv")).read().splitlines()
    log(f"15b autotune on BERT-Large (hooks, AdamW), batch {cfg['batch']} x "
        f"seq {cfg['seq']}: swept {','.join(tuned['swept'])}; frozen after "
        f"{tuned['steps']} steps; {len(tuned['commits'])} commits, "
        f"{len(csv_rows) - 2} scored points in the CSV log")
    for e in tuned["commits"]:
        log("  autotune_commit " + json.dumps(
            {k: v for k, v in e.items() if k not in ("t", "kind")}))
    frozen = tuned["params"]
    check(not tuned["active"] and frozen is not None and not frozen.active,
          f"15b: the tuner did not freeze within {tuned['steps']} steps")
    check(len(tuned["commits"]) >= 2 and not tuned["commits"][-1]["active"]
          and len(tuned["commits"]) == tuned["commits_counted"],
          f"15b commits {tuned['commits']}, "
          f"horovod_autotune_commits_total moved {tuned['commits_counted']}")
    log(f"  frozen knobs: fusion threshold {frozen.fusion_threshold_bytes} "
        f"bytes, cycle {frozen.cycle_time_ms:.3f} ms, cache "
        f"{frozen.cache_enabled}, pipeline depth "
        f"{frozen.cycle_pipeline_depth}, grad bucket "
        f"{frozen.grad_bucket_bytes} bytes")
    n = min(len(phase4), len(tuned["losses"]))
    check(tuned["losses"][:n] == phase4[:n],
          f"15b autotuned losses {tuned['losses'][:n]} not bit-equal to "
          f"phase 4's {phase4[:n]}")
    log("  losses (bit-equal to phase 4's): "
        + " ".join(f"{x:.4f}" for x in tuned["losses"]))
    turns = {}
    frozen_knobs = {env.HOROVOD_FUSION_THRESHOLD:
                    frozen.fusion_threshold_bytes,
                    env.HOROVOD_CYCLE_TIME: repr(frozen.cycle_time_ms),
                    env.HOROVOD_CYCLE_PIPELINE_DEPTH:
                    frozen.cycle_pipeline_depth}
    if not frozen.cache_enabled:
        frozen_knobs[env.HOROVOD_CACHE_CAPACITY] = 0
    for label in ("first", "frozen", "frozen", "first"):
        with knobs(**(frozen_knobs if label == "frozen" else {})):
            run = _bert_run(cfg, device, state, batch, cfg["opt_turn_steps"])
        check(run["losses"] == phase4[:len(run["losses"])],
              f"15b {label} knobs: losses {run['losses']} not bit-equal to "
              f"phase 4's")
        turns.setdefault(label, []).append(run["step_ms"])
    log(f"  step ms in turns, first knobs: {turns['first']}, frozen knobs: "
        f"{turns['frozen']} {where}; every turn's losses bit-equal to phase "
        f"4's")
    if device.type == "cuda":
        want = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             tuned["n_layers"] * tuned["steps"])
        got = {k: tuned["launches"][k] for k in want}
        check(got == want, f"15b kernel launches {got}, want {want}")
    log(f"phase 15 kernel launches (15b's autotuned run): "
        f"{tuned['launches']}")
    return tuned["launches"]


def wire_extensions_phase(cfg, device, card, phase4: list) -> dict:
    """Phase 15: 15a and 15b; the flash launches of 15b for the kernels
    line."""
    probes_15a(device, card)
    return autotune_15b(cfg, device, card, phase4)


# ---------------------------------------------------------------------------
# Phase 16: model parallelism at world 1
# ---------------------------------------------------------------------------

FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def ring_steps_16a(cfg, device) -> dict:
    """16a: the ring module's per-step forward and backward over ``shards``
    query and key shards in one process, as that many ranks run them,
    against one ``flash_attention`` forward and backward (and one partial
    for the lse) over the whole sequence. Returns the steps' launches."""
    from horovod_tpu_torch.parallel import ring

    b, h, s, d, n = cfg["ring_case"]
    sl, sm = s // n, d ** -0.5
    g = torch.Generator(device).manual_seed(16)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=device)
                   .to(BF16) for _ in range(4))
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    o_ref = fa.flash_attention(qf, kf, vf, causal=True)
    o_ref.backward(do)
    lse_ref = fa.flash_attention_partial(q, k, v, causal=True)[1]

    def part(t, i):
        return t[:, :, i * sl:(i + 1) * sl].contiguous()

    fa.reset_launch_counts()
    outs, lses, futures = [], [], 0
    for i in range(n):  # rank i
        o = torch.zeros(b, h, sl, d, dtype=F32, device=device)
        lse = torch.full((b, h, sl), -math.inf, dtype=F32, device=device)
        for step in range(n):
            src = (i + step) % n
            was = (o.clone(), lse.clone())
            o, lse = ring.forward_step(
                part(q, i), part(k, src), part(v, src), o, lse, causal=True,
                sm_scale=sm, q_offset=i * sl, k_offset=src * sl)
            if src > i:  # every key in the queries' future: weight 0
                futures += 1
                check(torch.equal(o, was[0]) and torch.equal(lse, was[1]),
                      f"16a: rank {i}'s future shard {src} moved (o, lse)")
        outs.append(o.to(BF16))
        lses.append(lse)
    dq = [torch.zeros(b, h, sl, d, dtype=F32, device=device)
          for _ in range(n)]
    acc = [[torch.zeros(b, h, sl, d, dtype=F32, device=device)
            for _ in range(2)] for _ in range(n)]
    for i in range(n):
        delta = fa.compute_delta(outs[i], part(do, i))
        for step in range(n):
            src = (i + step) % n
            acc[src] = ring.backward_step(
                part(q, i), part(k, src), part(v, src), part(do, i),
                lses[i], delta, dq[i], acc[src], causal=True, sm_scale=sm,
                q_offset=i * sl, k_offset=src * sl)
    _sync(device)
    launches = {k: fa.LAUNCHES[k] for k in FLASH}
    o = torch.cat(outs, dim=2)
    lse = torch.cat(lses, dim=2)
    grads = {"dq": (torch.cat(dq, dim=2), qf.grad),
             "dk": (torch.cat([a[0] for a in acc], dim=2), kf.grad),
             "dv": (torch.cat([a[1] for a in acc], dim=2), vf.grad)}
    err = {"o": (o.float() - o_ref.float()).abs().max().item(),
           "lse": (lse - lse_ref).abs().max().item(),
           **{k: rel(a, b.float()) for k, (a, b) in grads.items()}}
    log(f"16a: ring steps over {n} shards of {sl} (B{b} H{h} S{s} D{d}, "
        f"causal), {futures} future pairs: max|o-whole| {err['o']:.3e} "
        f"max|lse-whole| {err['lse']:.3e} rel dq {err['dq']:.3e} dk "
        f"{err['dk']:.3e} dv {err['dv']:.3e} (limits: o {TOL['o']} abs, "
        f"lse {TOL['lse']} abs, grads {TOL['grad']} relative)")
    log(f"  16a kernel launches: {launches}")
    check(err["o"] <= TOL["o"] and err["lse"] <= TOL["lse"],
          f"16a: ring forward off the whole-sequence attention: {err}")
    for k in grads:
        check(err[k] <= TOL["grad"], f"16a: ring {k} off: {err[k]}")
    if device.type == "cuda":
        check(launches == dict.fromkeys(FLASH, n * n),
              f"16a: launches {launches}, want {n * n} of each")
    return launches


def pipeline_16b(cfg, device, card) -> dict:
    """16b's pipeline: ``pipeline_apply`` with one stage (the world's one
    rank) over GPT-2-small's layers, phase 7's batch as microbatches,
    against the plain stack over the same microbatches; the loss is the
    microbatches' mean causal LM loss."""
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = GPT2Small(**cfg["gpt"], device=dev, seed=0)
    mb = cfg["pp_micro_batch"]
    toks = torch.from_numpy(gpt_tokens(cfg)).to(dev)
    toks = toks.view(-1, mb, toks.shape[1])
    with torch.no_grad():
        x = torch.stack([model.token_embed[t].to(model.dtype)
                         + model.pos_embed[:t.shape[1]].to(model.dtype)
                         for t in toks])

    def stack(layers, h):
        for layer in layers:
            h = layer(h)
        return h

    def run(out):
        loss = sum(causal_lm_loss(
            (model.final_norm(out[i]) @ model.token_embed.to(
                model.dtype).T).float(), toks[i])
            for i in range(len(toks))) / len(toks)
        loss.backward()
        grads = [p.grad.clone() for p in model.layers.parameters()]
        model.zero_grad(set_to_none=True)
        return loss.detach(), grads

    fa.reset_launch_counts()
    piped = hvd.pipeline_apply(stack, model.layers, x)
    loss, grads = run(piped)
    _sync(dev)
    launches = {k: fa.LAUNCHES[k] for k in FLASH}
    plain = torch.stack([stack(model.layers, x[i]) for i in range(len(x))])
    loss_ref, grads_ref = run(plain)
    worst = max(rel(a, b.float()) for a, b in zip(grads, grads_ref))
    same = torch.equal(piped, plain) and torch.equal(loss, loss_ref)
    log(f"16b: pipeline_apply, 1 stage x {len(model.layers)} layers, "
        f"{len(x)} microbatches of {mb} x {toks.shape[2]}: outputs and "
        f"loss bit-equal to the plain stack: {same}; loss "
        f"{loss.item():.6f}; worst relative gradient difference "
        f"{worst:.3e} (limit 1e-2); launches {launches}")
    check(same, "16b: the pipeline's outputs or loss differ from the stack")
    check(worst <= 1e-2, f"16b: pipeline gradients off by {worst:.3e}")
    if dev.type == "cuda":
        per = len(model.layers) * len(x)
        check(launches == dict.fromkeys(FLASH, per),
              f"16b: pipeline launches {launches}, want {per} of each")
    del model, x, piped, plain, grads, grads_ref
    hvd.shutdown()
    free_memory(device)
    return launches


def model_parallel_phase(cfg, device, card, phase7: dict) -> dict:
    """Phase 16: 16a, then 16b's ring and Ulysses runs against phase 7's
    losses and its pipeline; the flash launches of all of it."""
    launches = ring_steps_16a(cfg, device)
    for fn in (hvd.ring_attention, hvd.ulysses_attention):
        run = train_gpt(cfg, device, card, False, attention_fn=fn)
        log(f"16b: {fn.__name__} losses bit-equal to phase 7's: "
            f"{run['losses'] == phase7['losses']}; launches "
            f"{ {k: run['launches'][k] for k in FLASH} }")
        check(run["losses"] == phase7["losses"],
              f"16b: {fn.__name__}'s losses {run['losses']} are not phase "
              f"7's {phase7['losses']}")
        launches = {k: launches[k] + run["launches"][k] for k in FLASH}
    pp = pipeline_16b(cfg, device, card)
    launches = {k: launches[k] + pp[k] for k in FLASH}
    log(f"phase 16 kernel launches (16a, 16b): {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 17: the serving plane
# ---------------------------------------------------------------------------

# the serving tests' tiny float32 model (tests/test_torch_serve.py)
SERVE_TINY = dict(vocab_size=61, d_model=32, num_layers=2, num_heads=2,
                  d_ff=64, max_seq=48, causal=True)
# 17b: a served token's logit in the teacher-forced uncached forward may
# sit below that row's maximum by at most this much (a near-tie), and the
# serving path's logits may differ from that forward's by at most this
# much: eight bf16 ulps at the logits' magnitude (|logit| < 4 here)
SERVE_LOGIT_TOL = 0.125
SERVE_SPANS = ("request.submit", "request.queue_wait", "request.prefill",
               "request.decode_block", "request.response")


def _serve_gen(eng, slot, prompt, n, out, graph_checks):
    token, _ = eng.prefill(slot, prompt)
    toks, pos = [token], len(prompt)
    for _ in range(n - 1):
        (t,), _ = eng.decode([slot], [toks[-1]], [pos])
        _graph_vs_eager(eng, graph_checks)
        toks.append(t)
        pos += 1
    out.append(toks)


def _graph_vs_eager(eng, checks) -> None:
    """On the card: the step just replayed, run again eagerly on the same
    inputs and state (the step rewrites the same cache rows), must give
    bit-equal ids and max|logit|."""
    step = eng.step
    if step.graph is None:
        return
    ids, max_abs = (t.clone() for t in step.out)
    e_ids, e_abs = step.eager()
    checks.append(torch.equal(ids, e_ids) and torch.equal(max_abs, e_abs))


def serve_scenario(eng, graph_checks: list) -> list:
    """17a's calls: two prompt buckets in concurrent slots, a long
    occupant then a short prompt in one slot, and on a paged engine a
    shared 16-token prefix (copy-on-write) and an exact repeat. Returns
    every generation."""
    out = []
    prompts = {0: [5, 4, 3, 2, 1], 2: list(range(1, 18))}
    gen = {s: [eng.prefill(s, p)[0]] for s, p in prompts.items()}
    pos = {s: len(p) for s, p in prompts.items()}
    for _ in range(5):
        ids, _ = eng.decode([0, 2], [gen[0][-1], gen[2][-1]],
                            [pos[0], pos[2]])
        _graph_vs_eager(eng, graph_checks)
        for s, t in zip((0, 2), ids):
            gen[s].append(t)
            pos[s] += 1
    out += [gen[0], gen[2]]
    _serve_gen(eng, 1, list(range(1, 31)), 8, out, graph_checks)
    _serve_gen(eng, 1, [9, 8, 7, 6], 6, out, graph_checks)
    if eng.paged:
        for s in range(3):
            eng.release_slot(s)
        shared = list(range(1, 17))
        _serve_gen(eng, 0, shared + [20, 21], 6, out, graph_checks)
        _serve_gen(eng, 1, shared + [30], 6, out, graph_checks)
        _serve_gen(eng, 2, shared + [20, 21], 6, out, graph_checks)
        check(eng.cow_copies > 0 and eng.exact_hits == 1,
              f"17a: paged scenario: {eng.cow_copies} COW copies, "
              f"{eng.exact_hits} exact hits")
    return out


def serve_17a(device) -> None:
    """17a: the tiny float32 model's dense and paged engines on the card
    against the same weights on the CPU, and each replayed decode step
    against the eager step on the same state."""
    from horovod_tpu_torch.serve.kv_cache import DecodeEngine
    from horovod_tpu_torch.serve.paging import PagedDecodeEngine

    cpu = Transformer(dtype=F32, device="cpu", seed=0, **SERVE_TINY)
    models = {"cpu": cpu}
    if device.type == "cuda":
        models["card"] = Transformer(dtype=F32, device=device, seed=0,
                                     **SERVE_TINY)
        models["card"].load_state_dict(cpu.state_dict())
    makers = {"dense": lambda m: DecodeEngine(m, num_slots=3),
              "paged": lambda m: PagedDecodeEngine(
                  m, num_slots=3, page_tokens=16, pool_pages=12)}
    for kind, make in makers.items():
        gens, checks = {}, []
        for where, model in models.items():
            eng = make(model)
            gens[where] = serve_scenario(eng, checks)
            del eng
        if device.type == "cuda":
            check(gens["card"] == gens["cpu"],
                  f"17a {kind}: card tokens {gens['card']} differ from the "
                  f"CPU's {gens['cpu']}")
            check(checks and all(checks),
                  f"17a {kind}: a replayed decode step differs from the "
                  f"eager step ({checks.count(False)} of {len(checks)})")
            log(f"17a {kind}: card tokens equal the CPU's in "
                f"{len(gens['cpu'])} generations; {len(checks)} replayed "
                f"decode steps bit-equal to the eager step")
        else:
            log(f"17a {kind}: {len(gens['cpu'])} generations on the CPU "
                f"(card vs CPU and the graph replay are card-only)")
    del models
    gc.collect()
    free_memory(device)


def serve_prompts(cfg, vocab: int) -> list:
    """17b's requests from seed 0: ``serve_shared`` of them a shared
    prefix of ``serve_prefix`` tokens and a suffix, the rest random
    prompts whose lengths are log-uniform up to ``serve_max_prompt``."""
    rng = np.random.default_rng(0)
    n, shared, plen = (cfg["serve_requests"], cfg["serve_shared"],
                       cfg["serve_prefix"])
    top = cfg["serve_max_prompt"]
    prefix = rng.integers(0, vocab, plen).tolist()
    out = []
    for i in range(n):
        if i % (n // shared) == 0 and len(out) < n:
            tail = int(rng.integers(1, top - plen + 1))
            out.append(prefix + rng.integers(0, vocab, tail).tolist())
        else:
            length = int(np.exp(rng.uniform(np.log(2), np.log(top))))
            out.append(rng.integers(0, vocab, length).tolist())
    return out


def _wait_all(handle, uids, timeout: float) -> list:
    """Every request's completion; fails at once when a replica parks
    quarantined (its loop swallowed an error)."""
    done, deadline = {}, time.monotonic() + timeout
    while len(done) < len(uids):
        for r in handle.stats()["replicas"]:
            check(not r["quarantined"],
                  f"17b: replica {r['name']} quarantined")
        for u in uids:
            if u not in done:
                c = handle._queue.try_result(u)
                if c is not None:
                    done[u] = c
        check(time.monotonic() < deadline,
              f"17b: {len(uids) - len(done)} requests not done in "
              f"{timeout} s")
        time.sleep(0.02)
    return [done[u] for u in uids]


def _teacher_forced(model, prompt, tokens):
    """The uncached forward (flash B1) over prompt + generated[:-1]: the
    logits that predicted each generated token, float32."""
    seq = torch.tensor([prompt + tokens[:-1]], device=model.token_embed.device)
    with torch.no_grad():
        return model(seq)[0, len(prompt) - 1:]


def _cached_logits(model, prompt, tokens, paged: bool):
    """The serving path's logits for the same tokens, one request in a
    cache of its own: the bucketed prefill, then one decode step a token."""
    from horovod_tpu_torch.serve.kv_cache import (padded_prompt,
                                                  prompt_bucket)

    dev = model.token_embed.device
    T = 16
    width = -(-model.max_seq // T) + 1
    table = None
    if paged:
        need = -(-(len(prompt) + len(tokens)) // T)
        cache = KVCache.paged(model, need + 1, T)
        table = torch.zeros((1, width), dtype=torch.long, device=dev)
        table[0, :need] = torch.arange(1, need + 1)
    else:
        cache = KVCache.dense(model, 1)
    rows = []
    with torch.no_grad():
        bucket = prompt_bucket(len(prompt), model.max_seq)
        logits = model(padded_prompt(prompt, bucket, dev),
                       positions=torch.zeros(1, dtype=torch.long,
                                             device=dev),
                       cache=cache, page_table=table)
        rows.append(logits[0, len(prompt) - 1])
        for i, t in enumerate(tokens[:-1]):
            logits = model(torch.tensor([[t]], device=dev),
                           positions=torch.tensor([len(prompt) + i],
                                                  device=dev),
                           cache=cache, page_table=table)
            rows.append(logits[0, 0])
    return torch.stack(rows)


def _time_step(step, n: int, dev) -> dict:
    """The decode step's ms, eager and replayed, in turns (eager, replay,
    replay, eager): CUDA events around ``n`` calls; on the CPU the host
    clock around eager calls only."""
    out = {"eager": [], "replay": []}
    order = ("eager", "replay", "replay", "eager")
    for mode in order:
        if mode == "replay" and step.graph is None:
            continue
        run = step.eager if mode == "eager" else step.graph.replay
        run()
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(n):
                run()
            end.record()
            torch.cuda.synchronize(dev)
            out[mode].append(start.elapsed_time(end) / n)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            out[mode].append(1e3 * (time.perf_counter() - t0) / n)
    return out


def serve_run(cfg, model, paged: bool, card) -> dict:
    """One 17b run: ``hvd.serve`` with one replica, the warm-up requests
    (one a prompt bucket), then the requests of :func:`serve_prompts`; every
    check of 17b that reads the handle while it lives."""
    from horovod_tpu_torch.serve.kv_cache import prompt_bucket

    kind = "paged" if paged else "dense"
    prompts = serve_prompts(cfg, model.vocab_size)
    new = cfg["serve_new"]
    handle = hvd.serve(model, replicas=1, slots=cfg["serve_slots"],
                       max_new_tokens=new, paged=paged)
    try:
        buckets = sorted({prompt_bucket(n, model.max_seq)
                          for n in range(1, cfg["serve_max_prompt"] + 1)})
        rng = np.random.default_rng(1)
        warm = [handle.submit(rng.integers(0, model.vocab_size,
                                           b).tolist(), max_new_tokens=2)
                for b in buckets]
        _wait_all(handle, warm, 600.0)
        compiles = handle.compiles_total()
        t0 = time.perf_counter()
        uids = [handle.submit(p) for p in prompts]
        outs = _wait_all(handle, uids, 600.0)
        wall = time.perf_counter() - t0
        check(handle.compiles_total() == compiles,
              f"17b {kind}: program keys after warm-up: "
              f"{handle.stats()['replicas'][0]['engine']['compiles']}")
        check(all(len(o.tokens) == new and o.finish == "length"
                  for o in outs),
              f"17b {kind}: a request came back short: "
              f"{[(len(o.tokens), o.finish) for o in outs]}")
        rep = handle._replicas[0]
        eng = rep.engine
        state = serve_state()
        check(state["count"] == 1 and not any(
            r["quarantined"] for h in state["handles"]
            for r in h["replicas"]), f"17b {kind}: serve_state {state}")
        spans: dict = {}
        for s in tracing.spans():
            spans.setdefault(s.get("trace_id"), set()).add(s["name"])
        missing = [o.trace_id for o in outs
                   if not set(SERVE_SPANS) <= spans.get(o.trace_id, set())]
        check(not missing, f"17b {kind}: requests without every span: "
                           f"{missing[:4]}")
        codes = {r: _get_json(r) for r in ("/serve", "/slo", "/healthz")}
        check(all(c == 200 for c, _ in codes.values())
              and codes["/serve"][1]["count"] == 1
              and codes["/slo"][1]["requests_scored"] >= len(outs)
              and codes["/healthz"][1]["ready"],
              f"17b {kind}: routes {codes}")
        sub = "kv_pages" if paged else "serve_kv"
        led = memory.tracker().ledger()["subsystems"][sub]["bytes"]
        d, n_layers = model.token_embed.shape[1], len(model.layers)
        rows = (eng.pool.pages * eng.page_tokens if paged
                else cfg["serve_slots"] * model.max_seq)
        want = 2 * n_layers * rows * d * torch.finfo(model.dtype).bits // 8
        check(led == eng.cache_bytes() == want,
              f"17b {kind}: ledger {sub} {led}, engine "
              f"{eng.cache_bytes()}, want {want}")
        extra = ""
        if paged:
            pages = eng.page_stats()
            check(pages["reused_tokens"] > 0
                  and pages["prefix"]["hits"] > 0,
                  f"17b paged: no prefix reuse: {pages}")
            extra = (f"; prefix hits {pages['prefix']['hits']}, reused "
                     f"tokens {pages['reused_tokens']} of "
                     f"{pages['reused_tokens'] + pages['computed_tokens']}"
                     f", COW copies {pages['cow_copies']}, preemptions "
                     f"{pages['preemptions']}")
    finally:
        handle.close()
    tokens = sum(len(o.tokens) for o in outs)
    ttft = sorted(1e3 * o.ttft_s for o in outs)
    p50, p99 = (ttft[min(len(ttft) - 1, int(round(q * (len(ttft) - 1))))]
                for q in (0.5, 0.99))
    timing = _time_step(eng.step, cfg["serve_step_iters"],
                        model.token_embed.device)
    med = {k: statistics.median(v) if v else None
           for k, v in timing.items()}
    log(f"17b {kind}: {len(outs)} requests, {tokens} tokens in "
        f"{wall:.3f} s: {tokens / wall:.1f} generated tokens/s, TTFT "
        f"p50 {p50:.2f} ms p99 {p99:.2f} ms; decode step ms in turns "
        f"(eager, replay, replay, eager): "
        f"{ {k: [round(x, 4) for x in v] for k, v in timing.items()} }"
        f", medians {med}; KV bytes {led} (ledger {sub}); "
        f"{eng.decode_steps} decode steps, compiles "
        f"{eng.stats()['compiles']}{extra} ({card})")
    return {"outs": outs, "prompts": prompts, "bytes": led,
            "tokens_s": tokens / wall, "ttft": (p50, p99),
            "step_ms": med}


def check_served(model, run: dict, paged: bool, n_cached: int) -> dict:
    """Each request's tokens against the teacher-forced uncached forward
    (flash B1): the served token's logit within SERVE_LOGIT_TOL of that
    row's maximum; and for the first ``n_cached`` requests the serving
    path's logits within SERVE_LOGIT_TOL of it."""
    kind = "paged" if paged else "dense"
    argmax_equal = total = 0
    worst_gap = worst_logit = 0.0
    for i, (prompt, out) in enumerate(zip(run["prompts"], run["outs"])):
        ref = _teacher_forced(model, prompt, out.tokens)
        got = ref.gather(1, torch.tensor(out.tokens, device=ref.device)
                         [:, None])[:, 0]
        gap = (ref.max(dim=1).values - got).max().item()
        worst_gap = max(worst_gap, gap)
        argmax_equal += int((ref.argmax(dim=1).cpu()
                             == torch.tensor(out.tokens)).sum())
        total += len(out.tokens)
        if i < n_cached:
            cached = _cached_logits(model, prompt, out.tokens, paged)
            worst_logit = max(worst_logit,
                              (cached - ref).abs().max().item())
    log(f"17b {kind}: served tokens vs the teacher-forced uncached "
        f"forward: {argmax_equal} of {total} its argmax, largest logit gap "
        f"below the row's max {worst_gap:.4f}; serving-path logits of "
        f"{n_cached} requests within {worst_logit:.4f} of it (limit "
        f"{SERVE_LOGIT_TOL} for both)")
    check(worst_gap <= SERVE_LOGIT_TOL,
          f"17b {kind}: a served token's logit is {worst_gap} below the "
          f"reference's max")
    check(worst_logit <= SERVE_LOGIT_TOL,
          f"17b {kind}: serving-path logits off by {worst_logit}")
    return {"argmax_equal": argmax_equal, "total": total}


def serving_phase(cfg, device, card) -> dict:
    """Phase 17: 17a, then 17b's dense and paged runs of GPT-2-small at full
    width, their checks, and the launches of B1 in the reference forwards
    (the serving path itself runs no kernel of the port)."""
    serve_17a(device)
    old = _elastic_env(HOROVOD_METRICS_PORT=0)
    try:
        hvd.init(device=None if device.type == "cuda" else "cpu")
        dev = hvd.device()
        model = GPT2Small(**cfg["gpt"], device=dev, seed=0)
        runs = {paged: serve_run(cfg, model, paged, card)
                for paged in (False, True)}
        gc.collect()
        fa.reset_launch_counts()
        for paged, run in runs.items():
            check_served(model, run, paged, cfg["serve_cached_checks"])
        _sync(dev)
        launches = {"flash_fwd": fa.LAUNCHES["flash_fwd"]}
        good = goodput.goodput_state()
        check(good["serve_blocks"] > 0 and good["productive_seconds"] > 0,
              f"17b: goodput ledger {good}")
        log(f"17b goodput: {good['serve_blocks']} serve blocks, "
            f"{good['productive_seconds']:.3f} productive s; reference "
            f"forwards' launches {launches}")
        del model, runs
        hvd.shutdown()
    finally:
        _restore_env(old)
    free_memory(device)
    log(f"phase 17 kernel launches: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: robustness under the launcher
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def launcher_18a(cfg, device, card) -> dict:
    """18a: the in-process reference run, then the launcher's worker on the
    same 4 batches; the worker's flash launches (its counts set to 0 just
    before its steps)."""
    from horovod_tpu_torch.run.run import run_commandline
    from horovod_tpu_torch.tools import bert_launch_worker as blw

    cuda = device.type == "cuda"
    model_cfg = blw.FULL if cuda else blw.TINY
    batch, rows, steps = cfg["launch_batch"], cfg["launch_rows"], 4
    hvd.init(device=None if cuda else "cpu")
    ref = blw.train(model_cfg, batch, steps, rows)
    hvd.shutdown()
    free_memory(device)
    tmp = tempfile.mkdtemp(prefix="phase18a-")
    flight, out = os.path.join(tmp, "flight"), os.path.join(tmp, "w.json")
    argv = ["-np", "1", "--flight-recorder-dir", flight, sys.executable,
            "-m", "horovod_tpu_torch.tools.bert_launch_worker", "--out", out,
            "--steps", str(steps), "--batch", str(batch), "--rows",
            str(rows)] + ([] if cuda else ["--tiny", "--device", "cpu"])
    old = _elastic_env(PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    try:
        t0 = time.perf_counter()
        code = run_commandline(argv)
        seconds = time.perf_counter() - t0
        check(code == 0, f"18a: tpurun-torch exited {code}")
        got = json.load(open(out))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pm_code = run_commandline(["--postmortem", flight])
    finally:
        _restore_env(old)
    report = buf.getvalue()
    log(f"18a: tpurun-torch -np 1 ran BERT-{'Large' if cuda else 'tiny'} "
        f"MLM (hooks) on {got['device']}, {steps} steps at batch {batch}, "
        f"in {seconds:.1f} s of command; losses "
        + " ".join(f"{x:.6f}" for x in got["losses"]))
    log("18a: each step's wait for its batch (prefetch_to_device, 2 ahead): "
        + " ".join(f"{1e3 * w:.3f} ms" for w in got["waits"])
        + (f" ({card})" if cuda else ""))
    if cuda:
        log(f"18a: the worker's max_memory_allocated "
            f"{got['peak_bytes'] / 2**30:.2f} GiB ({card})")
    check(got["losses"] == ref["losses"],
          f"18a: the launched worker's losses {got['losses']} are not the "
          f"in-process run's {ref['losses']}")
    log("18a: losses bit-equal to the in-process run of the same batches")
    events = [line for line in report.splitlines() if "[rank 0] " in line]
    check(pm_code == 0 and "rank 0: reason=shutdown" in report
          and any(line.endswith("[rank 0] shutdown") for line in events),
          f"18a: --postmortem printed no events of rank 0:\n{report}")
    log(f"18a: --postmortem over the dumps: {len(report.splitlines())} "
        f"lines, {len(events)} of rank 0's events, the last "
        f"{events[-1].split('] ', 1)[1]!r}")
    if cuda:
        n_layers = 24
        want = dict.fromkeys(FLASH, n_layers * steps)
        check(got["launches"] == want,
              f"18a: the worker's launches {got['launches']}, want {want}")
    shutil.rmtree(tmp, ignore_errors=True)
    return got["launches"]


def serve_18b(cfg, device, card) -> dict:
    """18b: ``serve_kill_replica`` at the configured width, its checks, the
    replicas' peaks, and the served tokens against the uncached forward
    (whose B1 launches come back)."""
    from horovod_tpu_torch.tools import chaos_matrix as cm
    from horovod_tpu_torch.tools import serve_chaos_worker as scw

    kind = "gpt2-small" if device.type == "cuda" else "tiny"
    tmp = tempfile.mkdtemp(prefix="phase18b-")
    served_path = os.path.join(tmp, "served.json")
    extra = {"CHAOS_SERVE_OUT": served_path,
             "CHAOS_SERVE_REQUESTS": str(cfg["chaos_serve_requests"]),
             "CHAOS_SERVE_UP": "180"}
    result = cm.run_scenario("serve_kill_replica",
                             cm.SCENARIOS["serve_kill_replica"],
                             extra_env=extra, keep_outputs=True,
                             device=device.type)
    outs = result.pop("outputs")
    front = result["results"][0] or {}
    log(f"18b: serve_kill_replica ({kind}): ok={result['ok']} in "
        f"{result['seconds']:.1f} s, exit codes {result['exit_codes']}, "
        f"{front.get('completed')} of {front.get('submitted')} requests "
        f"completed, requeued {front.get('requeued')}, dead ranks "
        f"{front.get('dead_ranks')}, served by {front.get('served_by')}")
    for line in result["postmortem_tail"]:
        log(f"18b postmortem: {line}")
    check(result["ok"], f"18b: serve_kill_replica failed: "
                        f"{result['failures']}")
    check(front.get("zero_lost") and front.get("requeued", 0) > 0
          and front.get("dead_ranks") == [2],
          f"18b: frontend result {front}")
    for r in (1, 2, 3):
        peaks = [int(line.split("bytes=")[1]) for line in
                 outs[r].splitlines() if line.startswith(f"PEAK rank={r} ")]
        if kind == "gpt2-small":
            check(bool(peaks), f"18b: replica {r} printed no peak memory")
            log(f"18b: replica {r} max_memory_allocated "
                f"{max(peaks) / 2**30:.3f} GiB ({card})"
                + (" (killed at its 5th decode step)" if r == 2 else ""))
    served = json.load(open(served_path))
    check(len(served) == front["submitted"],
          f"18b: {len(served)} completions written")
    model = scw.build_model(kind)
    model.eval()
    fa.reset_launch_counts()
    worst_gap, argmax_equal, total = 0.0, 0, 0
    for c in served:
        ref = _teacher_forced(model, c["prompt"], c["tokens"])
        got = ref.gather(1, torch.tensor(c["tokens"], device=ref.device)
                         [:, None])[:, 0]
        worst_gap = max(worst_gap,
                        (ref.max(dim=1).values - got).max().item())
        argmax_equal += int((ref.argmax(dim=1).cpu()
                             == torch.tensor(c["tokens"])).sum())
        total += len(c["tokens"])
    _sync(device)
    launches = {"flash_fwd": fa.LAUNCHES["flash_fwd"]}
    log(f"18b: the survivors' tokens vs the teacher-forced uncached forward: "
        f"{argmax_equal} of {total} its argmax, largest logit gap below the "
        f"row's max {worst_gap:.4f} (limit {SERVE_LOGIT_TOL})")
    check(worst_gap <= SERVE_LOGIT_TOL,
          f"18b: a served token's logit is {worst_gap} below the max")
    del model
    free_memory(device)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def robustness_phase(cfg, device, card) -> dict:
    """Phase 18: 18a and 18b; the flash launches of the launched worker's
    steps and of 18b's reference forwards."""
    p18a = launcher_18a(cfg, device, card)
    p18b = serve_18b(cfg, device, card)
    launches = {k: p18a.get(k, 0) + p18b.get(k, 0) for k in FLASH}
    log(f"phase 18 kernel launches: {launches}")
    return launches


GROUPS = (  # kernel-name fragments -> group, first match wins
    ("flash_", "attention kernels (port)"),
    ("sba_kernel", "BN + ReLU kernel B10 (port)"),
    ("fprop", "convolutions fprop (cuDNN)"),
    ("dgrad", "convolutions dgrad (cuDNN)"),
    ("wgrad", "convolutions wgrad (cuDNN)"),
    ("conv", "convolutions, other (cuDNN)"),
    ("adamw_kernel", "optimizer (port's AdamW kernels)"),
    ("nccl", "NCCL collectives"),
    ("gemm", "dense matmuls (cuBLAS)"), ("nvjet", "dense matmuls (cuBLAS)"),
    ("xmma", "dense matmuls (cuBLAS)"), ("cutlass", "dense matmuls (cuBLAS)"),
    ("multi_tensor_apply", "optimizer (foreach AdamW)"),
    ("layer_norm", "layernorm"), ("LayerNorm", "layernorm"),
    ("cat", "copies and casts"), ("copy", "copies and casts"),
    ("elementwise", "other element-wise"), ("reduce", "reductions"),
)


def breakdown(step, device, step_s: float, n: int) -> None:
    """Trace ``n`` steps with torch.profiler; print device time per step by
    kernel group and the top kernels, and the device's busy share of the
    step (kernel time over the median timed step)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n):
            step().item()
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    log(f"profile over {n} steps, host: self CPU time of the costliest "
        "operators")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"    {e.self_cpu_time_total / n / 1e3:8.3f} ms/step "
            f"{e.count // n:5d}x  {e.key[:90]}")
    # kernels only: a user annotation (Optimizer.step#...) spans kernels
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        log("profile: no device time recorded (not measured)")
        return
    groups: dict = {}
    for e in rows:
        g = next((grp for frag, grp in GROUPS if frag in e.key),
                 "other kernels")
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + e.self_device_time_total, c + e.count)
    total = sum(t for t, _ in groups.values())
    log(f"profile, device: kernel time {total / n / 1e3:.2f} "
        f"ms per step, busy share {total / n / 1e6 / step_s:.3f} of the "
        f"{1e3 * step_s:.2f} ms median step")
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {g:28s} {t / n / 1e3:9.3f} ms/step  {c // n:6d} launches/step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / n / 1e3:8.3f} ms/step "
            f"{e.count // n:5d}x  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-dry", action="store_true",
                    help="rehearse on the CPU with the plain versions at "
                         "tiny sizes; prints no result")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed steps, trace 3 more with "
                         "torch.profiler and print where the step's device "
                         "time goes")
    ap.add_argument("--turns", type=int, default=1,
                    help="run the three paths of phases 4-5 this many "
                         "times, in turns (a b c, c b a, a b c, ...), and "
                         "print each path's step medians: the host's "
                         "drift is shared by the paths")
    args = ap.parse_args()
    dry = args.cpu_dry
    if not dry and not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              flush=True)
        return 1
    cfg = DRY if dry else FULL
    # phase 7 sets the fused backward's switch for its second run only
    os.environ.pop(env.FLASH_FUSED_BWD, None)
    device = torch.device("cpu" if dry else "cuda")
    if dry:
        # the tiny sizes gain nothing from more threads, and on a busy host
        # a full thread pool spins against the other processes' pools
        torch.set_num_threads(1)
    else:  # float32 references: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    clock = {"start": time.perf_counter()}

    def elapsed(what: str) -> None:  # where the script's time limit goes
        now = time.perf_counter()
        log(f"[{what}: {now - clock.get('last', clock['start']):.1f} s; "
            f"{now - clock['start']:.1f} s in all]")
        clock["last"] = now

    card = environment(dry)
    elapsed("phase 1")

    # largest absolute error of each kernel's output over every case
    errs = dict.fromkeys(KERNELS, 0.0)
    for name, case in cfg["cases"].items():
        e = check_case(name, case, device)
        errs["flash_fwd"] = max(errs["flash_fwd"], e["o"])
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e["dq_abs"])
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e["dk_abs"],
                                    e["dv_abs"])
    log(f"kernels agree with their plain versions in every case (limits: o "
        f"{TOL['o']} abs, lse {TOL['lse']} abs, grads {TOL['grad']} relative)")
    timed = {name: time_case(name, cfg["cases"][name], device, cfg["iters"])
             for name in cfg["timed"]}
    errs.update(check_optimizer_kernels(cfg, device))
    log("AdamW kernels bit-equal to their plain versions in every case")
    rows = {**timed["a"], **time_optimizers(cfg, device, cfg["opt_iters"])}
    fused_vs_zero(cfg, device)
    shapes = bn_shapes(cfg, device)
    errs["sba"] = check_sba(shapes, device)
    rows["sba"] = time_sba(shapes, device, cfg["sba_iters"])
    rows["conv_bn_stats"], errs["conv_bn_stats"], probe_launches = \
        run_probe(cfg, device)
    errs["flash_bwd_fused"] = max(check_fused(name, case, device)
                                  for name, case in cfg["fused_cases"].items())
    log(f"fused backward agrees with its plain version and with dq + dk/dv "
        f"in every case (limit: grads {TOL['grad']} relative)")
    fused_rows = {name: time_fused(name, cfg["fused_cases"][name], device,
                                   cfg["iters"])
                  for name in cfg["fused_timed"]}
    rows["flash_bwd_fused"] = fused_rows[cfg["fused_timed"][-1]]  # GPT-2's
    vrows, verrs, vprobe_launches = run_vprobe(cfg, device, cfg["iters"])
    rows.update(vrows)
    errs.update(verrs)
    tiny_model_check(cfg, device)
    tiny_inception_check(cfg, device)
    elapsed("phases 2-3")
    runs = {path: train(cfg, device, card, path, args.profile)
            for path in PATHS}
    compare_losses(runs)
    compare_fusion(cfg, device, card, runs["hooks"])
    compare_engines(cfg, device, card)
    elapsed("phases 4-5, 4b, 4c")
    if args.turns > 1:
        compare_in_turns(cfg, device, card, runs, args.turns)
    inception = train_inception(cfg, device, card, args.profile)
    gpt = {fused: train_gpt(cfg, device, card, fused, args.profile)
           for fused in (False, True)}
    compare_gpt_runs(gpt[False], gpt[True])
    elapsed("phases 6-7")
    resnet = train_resnet(cfg, device, card, args.profile)
    elapsed("phase 8")
    check_collectives(device)
    training_api(cfg, device, card, resnet["losses"])
    elapsed("phases 9-10")
    checkpoint_phase(cfg, device, card)
    elapsed("phase 11")
    elastic_phase(cfg, device, card)
    elapsed("phase 12")
    observability_phase(cfg, device, card)
    elapsed("phase 13")
    p14 = options_and_models_phase(cfg, device, card,
                                   runs["hooks"]["losses"][0])
    elapsed("phase 14")
    p15 = wire_extensions_phase(cfg, device, card, runs["hooks"]["losses"])
    elapsed("phase 15")
    p16 = model_parallel_phase(cfg, device, card, gpt[False])
    elapsed("phase 16")
    p17 = serving_phase(cfg, device, card)
    elapsed("phase 17")
    p18 = robustness_phase(cfg, device, card)
    elapsed("phase 18")
    if dry:
        log("DRY RUN complete: control flow rehearsed; no result line")
        return 0

    # each kernel's launches are counted on the paths that run it: the
    # flash kernels on phase 4, phase 14's BERT-Large (remat) and MoE LM,
    # phase 15's autotuned BERT-Large, phase 16's model parallelism,
    # phase 17's reference forwards and phase 18's launched worker and
    # reference forwards
    launches = {**{k: v + p14.get(k, 0) + p15.get(k, 0) + p16.get(k, 0)
                   + p17.get(k, 0) + p18.get(k, 0)
                   for k, v in runs["hooks"]["launches"].items()},
                "adamw_multi": runs["fused"]["launches"]["adamw_multi"],
                "flat_adamw": sum(runs[p]["launches"]["flat_adamw"]
                                  for p in ("zero", "zero2", "zero3")),
                "sba": inception["launches"]["sba"],
                "conv_bn_stats": probe_launches,
                "flash_bwd_fused": gpt[True]["launches"]["flash_bwd_fused"],
                **vprobe_launches}
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    max_abs_err=errs[name], ms=rows[name]["ms"],
                    plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"],
                    library_ms=rows[name]["library_ms"])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
