"""On-card smoke test of the PyTorch/CUDA port (``fedml_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build the hand-written kernels from ``fedml_tpu_torch/csrc`` into
   ``build/`` (one nvcc per source, all at once), print the tensor-core
   kernels' registers and spills (``-Xptxas -v``) with their threads,
   shared memory and blocks an SM -- the bf16 dW kernel at each of
   ResNet-56's four shapes, the bf16 and the fp32 (3xTF32) forward, dq
   and dk/dv at head dims 128 and 64, and the kernels of head dims above
   128 (dq's and dk/dv's chunked ones; the forward's at D 256, 384, 512
   and above 512) -- and read the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of its main path, and time kernel, plain version, one library
   call computing the same function (a yardstick only) and the bound:
   the grouped-conv dW (B1) at ResNet-56's four shapes in bf16 and in
   fp32 (each line names the kernel's route, tensor cores or CUDA
   cores; in fp32 against cuDNN's fp32 dW with TF32 off); the
   flash-attention forward, dq and dk/dv (B2-B4) at the LM flagship's
   launch ([32, 80, 4, 128] bf16 causal), a ragged T, a non-causal case
   the experiment main's LM launch ([32, 20, 4, 64] causal) and one TCP
   client's LM launch ([4, 80, 4, 128] causal), and the
   whole ``FlashAttention`` backward (delta, B3, B4)
   against SDPA's backward;
3. drive the ResNet main path -- lane-packed FedAvg on full-width
   ResNet-56 (bf16, 8 lanes, batch 64, synthetic LDA alpha=0.5
   CIFAR-shaped data, augmentation on, ``lane_lowering="pallas"``) for 2
   rounds through ``FedAvgAPI`` -- and show from the launch counters that
   it ran through B1's tensor-core kernel (53 stride-1 convs per step);
4. drive the LM main path -- the federated LM flagship (``bench.py
   --lm``): TransformerLM d_model 512, 4 layers, 4 heads of 128, T 80,
   vocab 90, bf16, 32 LEAF-shaped synthetic clients, batch 4, AMSGrad lr
   3e-4, bucketed streaming in chunks of 8 -- for 2 rounds through
   ``FedAvgAPI`` from the bench's own argument namespace, show that every
   layer of every chunk step ran B2, B3 and B4, and hold the trained
   model's logits on the card against the plain versions on the CPU;
5. run the port's bench (``python -m fedml_tpu_torch.bench``) in-process
   twice: the LM flagship for 1 measured round, and the ResNet recipe on
   its full data (32 clients, 50,000 samples) for 1 epoch and 1 measured
   round under ``--lane_lowering pallas``; hold each record to
   ``value > 0``, ``0 < mfu < 1``, the reference's round spans in
   ``phase_timings_s`` and counted FLOPs within ``FLOPS_XCHECK_TOL`` of
   the analytic count, and show from the counters that the ResNet run
   went through B1's tensor-core kernel and the LM run through B2-B4;
6. run the experiment entry point
   (``fedml_tpu_torch.experiments.main_fedavg.main``) on the card: LR
   with the reference's defaults for 2 rounds, full-width ResNet-56
   (fp32, 8 clients, 4,096 samples, batch 64, 1 round) under
   ``--wave_mode`` 0, 1 and 2 under deterministic kernels, with the
   three global states held within ``EXP_MODE_TOL`` of one another (and
   the spread of two runs of one mode under cuDNN's default kernels
   printed), and the full-width TransformerLM
   (bf16, ``synthetic_sequences`` at T 20, 16 clients, batch 4) through
   the waves for 2 rounds with the attention counters showing B2-B4 ran;
   each run prints its seconds a round with the card's name and power
   limit;
7. run the rest of the FedAvg family through its experiment mains
   (``phase_fedavg_family``): FedAdam (``main_fedopt``) on the
   full-width TransformerLM for 2 rounds with the attention counters
   checked, the same run cut after round 1 and resumed from its
   checkpoint (bit-equal to the uninterrupted run under deterministic
   kernels), the README's Quick-start under each server optimizer, and
   FedNova, hierarchical FL, centralized training and robust FedAvg
   (with its backdoor accuracy) on full-width ResNet-56 for 1 round;
8. train the MoE TransformerLM through the steered resilient rounds
   (``phase_resilience_moe``): ``main_fedavg --model moe_transformer``
   at the factory's full width (d_model 256, 4 layers, 4 heads of 64, 8
   experts, bf16) on ``synthetic_sequences`` (32 clients, 8 a round,
   batch 4, T 20) under ``--overselect 0.3 --straggler_p 0.25 --quorum
   0.34 --pace_steering 1`` for 4 rounds through the waves, with the
   attention counters set to 0 just before and read just after (B2, B3
   and B4 each launched), every round's ``res/*`` and ``pace/*`` fields
   equal to ``SimResilience`` and ``PaceController`` replayed alone on
   the host; then one MoE training step at the same width in fp32 on the
   card (kernels) against the same step on the CPU (plain versions) from
   the same weights, at T 20 and at T 80 on LEAF-shaped synthetic
   Shakespeare clients: no token routed to another expert, and loss, aux
   loss, logits and gradients within ``MOE_TOL``;
9. run the massive-cohort path (``phase_massive_async``): the bench's
   ``--massive_cohort`` at its uncut N of 50,000 ragged LR clients
   (chunks of 128) synchronously and with ``--massive_async 1``
   (``buffer_k`` 2048, decay 0.5, window 4), a warmup and 2 measured
   rounds each, on the ``native`` packing backend: about ceil(N /
   buffer_k) flushes a round, a staleness above 0 and the same true
   steps in both; ``main_fedavg --async_agg 1`` and ``main_fedopt
   --async_agg 1 --bucket_edges geometric`` (LR defaults), their
   ``async/*`` and ``bucket/*`` counters equal to the CPU's; the full-width StackOverflow next-word LSTM
   (``RNNStackOverflow`` at vocabulary 10,000: 4.05 M fp32 parameters)
   on a population of 500 in-memory clients tokenized by the port's
   ``tokens_to_ids``, 50 a round, batch 16, through the async bucketed
   path (chunks of 8, ``buffer_k`` 16) for 2 rounds; one fp32 step of 2
   clients x batch 16 on the card against the CPU from the same weights
   within ``LSTM_TOL``; and a bucketed round of ResNet-56 (fp32) with
   the CIFAR augmentation on the streamed client update, against the
   same round without it;
10. compress client updates (``phase_compression``): the full-width
   TransformerLM of the experiment phase with a compressor through
   ``main_fedavg --compressor topk:0.01`` and ``main_fedopt --compressor
   qsgd:8`` (the host-packed compressed round) and through streaming
   error feedback (``--bucket_edges geometric --compressor signsgd``,
   synchronous and with ``--async_agg 1``), the attention counters set to
   0 just before each run and read just after, ``bytes_on_wire`` and
   ``compression_ratio`` equal to the port's count on the CPU, the
   residual store dense on the card with a live row for every client;
   the bench's massive cohort with ``--compressor topk:0.1`` (sync and
   async); one compressed round of a small fp32 LM card against CPU
   within ``COMP_ROUND_TOL``, topk's index sets and qsgd's codes (its
   draws handed in) equal on the same inputs, and the ``none`` round
   bit-equal to the plain round under deterministic kernels; the bench's
   ``--compression_sweep`` on ResNet-56 (encoded bytes equal to the
   CPU's count) and ``--check``;
11. drive the threaded control plane (``phase_control_plane``):
   ``resilience.run_tcp_fedavg`` with the server on this thread and 4
   client threads over real sockets on localhost for 2 rounds, each
   client training the LM flagship of phase 4 (one client's update from
   the numpy weights its SYNC carried, AMSGrad lr 3e-4, batch 4, 1
   epoch, on its own LEAF-shaped synthetic shard) on the card, under
   deterministic kernels: the history bit-equal to a socket-free replay
   (the same trainer on the same ranks in rank order, folded by the
   program's host view) and the reports' bytes received equal to the
   codec's count of the same trees; then the same run with
   ``topk:0.01`` compression, rank 2 killed at its round-0 report and
   re-dialed (``late_clients``), its ``res`` counters and reporting log
   equal to what the same plan gives with ``quadratic_trainer`` on the
   CPU; then ``run_async_tcp_fedavg`` with ``buffer_k`` 4 for 2 flushes
   of the 4 clients. The attention counters are set to 0 just before
   each run and read just after: B2, B3 and B4 each launched 4 layers
   times the clients' steps;
12. drive the event-loop control plane (``phase_eventloop``) with the
   same LM trainers, under deterministic kernels: (a)
   ``run_tcp_fedavg(transport="eventloop", decode_workers=2)`` for 2
   rounds, its history bit-equal to phase 11's socket-free replay, its
   ``bytes_received`` equal to the codec's count of the 8 reports and
   at least 8 frames through the decode stage; (b)
   ``run_async_tcp_fedavg(transport="eventloop")`` with ``buffer_k`` 4
   for 2 flushes of ranks 1-4 at staleness 0; (c) ``run_fanin_fedavg``
   with 2 edge aggregators of 2 leaves each over the event loop (the
   leaves' global ids round-robin over ranks 1-4, so the same shards),
   the coordinator's history bit-equal to the two-tier host replay
   (``aggregate_reports`` over each edge's leaves, then over the edges)
   and 2 rounds forwarded by each edge. The attention counters are set
   to 0 just before each run and read just after: B2, B3 and B4 each
   launched 136 times. (d) the port's bench in-process, on the host
   alone: ``--soak 1000`` (16,384-float reports, 3 updates) with its
   ``status.json`` final, and ``--tree_soak 1000 --tree_fanout 2`` (2
   edge processes with a swarm each) with every tier's status file
   final and on the coordinator's program core and no zombie; reports/s,
   bytes a report, the report-latency p50/p99 and the decode seconds a
   report are the host transport's on this machine;
13. train the CV zoo on the file-backed loaders (``phase_zoo``), under
   deterministic kernels: (a) ``fedml_tpu_torch.data.prepare fixture``
   writes a 1,000-client LEAF MNIST (5 training images a client) and a
   10-client CIFAR-10 tree (400 training images), and ``main_fedavg``
   trains the published MNIST + LR recipe on the first (10 clients a
   round, batch 10, lr 0.03, 2 rounds) and the cross-silo MobileNet
   recipe at full width on the second (LDA alpha 0.5, batch 64, lr
   0.001, wd 0.001, cut to 1 epoch and 1 round): smoke timings on
   fixtures, not the recipes' round times at their datasets' sizes; (b) the fed
   CIFAR-100 recipe at its published shape: 500 in-memory clients of 100
   uint8 32x32 images through the port's loader map (24x24 crops, about
   346 MB in fp32), ResNet-18 with GroupNorm 32 (100 classes) through
   the waves, 10 clients a round, batch 20, SGD lr 0.1, 2 rounds; (c) one
   fp32 training step at full width and batch 8 of ResNet-18-GN,
   ResNet-50-GN and ResNet-18 with BatchNorm (100 classes, 24x24),
   MobileNet, MobileNetV3 LARGE and SMALL, EfficientNet-b0 and VGG16 with
   and without BatchNorm (10 classes, 32x32) on the card against the
   CPU from the same weights (flax's default init from a seed) and
   dropout masks, the gradients tensor by tensor against float64 taking
   the same ReLU and max-pool decisions, within ``ZOO_TOL``, each with
   its parameter count and step milliseconds. None of B1-B4 runs in this
   phase (their counters read 0 after it);
14. run serverless, split, vertical and secure FL through their four
   mains (``phase_serverless``), under deterministic kernels, each run
   printing its seconds beside the card's name and power limit: (a)
   ``main_decentralized --algorithm dsgd`` on the full-width
   TransformerLM (the factory's d_model 256, 4 layers, 4 heads of 64,
   bf16) over 8 nodes of synthetic sequences, batch 4, 2 rounds, then
   the same with ``--compressor topk:0.01``: the attention counters set
   to 0 just before each run and read just after, B2, B3 and B4 each
   launched once a layer a local step (the 8 nodes train in one launch),
   and ``bytes_on_wire`` and ``compression_ratio`` equal to those of the
   same compressed main run on the CPU (1 round over 64 samples: the
   count rests on the shapes alone); (b) ``--algorithm pushsum --asymmetric 1
   --topology_neighbors 3`` on full-width ResNet-56 (fp32, the
   experiment phase's 8 clients and 4,096 samples, 1 round):
   ``pushsum_w`` equal to ``W @ 1`` on the host, every node state
   finite; (c) ``--online 1`` DSGD and PushSum with ``--time_varying 1``
   on the synthetic stream (8 nodes, T 200): ``w`` and ``Online/*``
   within ``SL_TOL`` of the same run on the CPU; (d) ``main_splitnn
   --cut conv`` on CIFAR-shaped ``synthetic_images`` (8 clients, batch
   64, 1 epoch, 2 rounds): both halves within ``SL_TOL`` of the CPU's
   from the same weights; (e) ``main_vfl`` on ``synthetic_vertical`` and
   on a 1,000-row Lending Club fixture with the finance tests' schema,
   2 and 3 parties each, 2 epochs: the records within ``SL_TOL`` of the
   CPU's; (f) ``main_turboaggregate`` on the same ResNet-56 for 1 round:
   its global state within ``C / (2 * mpc_scale)`` plus 1e-5 of
   ``main_fedavg``'s same host-packed round. B1's counter reads 0 after
   the phase;
15. run FedSeg, FedNAS and FedGKT through their mains (``phase_a14c``),
   under deterministic kernels, each run printing its seconds beside
   the card's name and power limit: (a) ``main_fedseg`` on the
   full-width DeepLab (``--backbone resnet``, width 32, ``--outstride
   16``) over 128x128 ``synthetic_segmentation``, 4 clients, batch 8,
   the poly schedule, 2 rounds, printing ``Seg/mIoU``; one round of the
   same at 8 samples a client card against CPU from the same weights,
   the global states within ``A14C_TOL``; 1 round at ``--outstride 8``;
   (b) ``main_fednas --stage search`` at the reference's defaults (C 16,
   8 layers, 4 steps a cell, ``--arch_order 2``) on CIFAR-shaped
   synthetic images, 2 clients, 1 round; one client's second-order
   search step at batch 8 (C 16, 8 layers, 2 steps a cell) card against
   CPU from the same weights (the arch gradient the step took, the
   clipped weight step and the statistics within ``A14C_TOL`` of their
   scales, an alpha apart only where its gradient lies within the two
   sides' gap, the same genotype; a 4-step cell's second-order arch
   gradient is held against the reference only on the CPU, in the
   tests' slow tier); ``--stage train`` on ``DARTS_V1`` at C 16 and 8
   layers for 1 round; (c) ``main_fedgkt`` with ``resnet8_56`` clients and the
   ResNet-56 tail (``--server_blocks 9``) on 512 CIFAR-shaped images, 4
   clients, 2 rounds; the same 2 rounds at 32 samples a client, batch 16
   and lr 1e-4 card against CPU (client states, server state and
   teacher logits within ``A14C_TOL``, the weights within its
   ``gkt_rel`` of their round-2 moves). None of B1-B4 runs (their
   counters read 0 after the phase);
16. run the mains' run-time tooling (``phase_tooling``) on the
   experiment phase's full-width TransformerLM streamed through bucketed
   chunks (``--bucket_edges geometric``), 2 rounds, with ``--trace``,
   ``--flightrec``, ``--perfmon`` (``--xprof_round 1``), ``--costmodel``,
   ``--audit``, ``--race_audit``, ``--warmup``, ``--checkpoint_dir`` and
   ``--compile_cache_dir``: (a) cold, in a fresh process over an empty
   build cache: the trace, spans, ``metrics.prom`` and a final
   ``status.json`` written, exactly one profiler capture (round 1's)
   holding B2-B4's ``fwd_mma_kernel``, ``dq_mma_kernel`` and
   ``dkv_mma_kernel``, the warmup building ``flash_attention`` once (1
   miss, 0 hits) and no round building or loading anything, 0
   transfer-guard violations, no lock-order cycle or held-while-blocking
   event, and each round's bucket FLOPs equal to ``train_step_flops``
   of one client's step times its executed (and true) client-steps; (b)
   a warm restart in a new process over the same cache and checkpoints
   (``--resume 1 --comm_round 4``): 0 ``nvcc`` runs, 0 warmup misses, no
   build in any round, B2-B4 launched; (c) in this process under
   deterministic kernels, the 2-round run with every flag on bit-equal
   to the same run with none;
17. run the client-sharded rounds and the long-context main
   (``phase_a15``): (a) ``main_longcontext`` at its defaults (T 512,
   vocab 10004, 4 layers, 4 heads of 64, d_model 256, batch 32) with
   ``--n_seq 1`` for ``A15_STEPS`` steps, in fp32 (its default: B2-B4
   3xTF32 on the tensor cores) and with
   ``--model_dtype bf16`` (B2-B4 on the tensor cores in bf16), then both
   again at head dim 256 (``--d_model 1024 --n_heads 4``: B2-B4 through
   the chunked route), B3 and B4 launched layers x steps times in each
   and B2 as often, B2-B4 at [32, 512, 4, 64], [32, 512, 4, 256] and
   [32, 512, 4, 384] in bf16 and fp32 and at the LM flagship's width
   [32, 80, 4, 128] in fp32 against their plain versions (each error
   over its tolerance, timed beside SDPA with the backend SDPA took, the
   whole backward too: delta, B3 and B4 as the autograd Function runs
   them), and the same SGD steps from the same weights through the
   kernels and through the plain ``mha`` in bf16 and fp32 at head dims
   64 and 256, their loss drift and their parameter drift beside the
   parameters' move printed (recorded, not gated); (b) one round of
   ResNet-56 at
   full width (fp32, deterministic kernels, host-packed) through
   ``main_fedavg --mesh 1`` (a one-rank NCCL ``clients`` mesh, the
   sharded round's ``all_reduce``) held within ``A15_MESH_TOL`` of
   ``--mesh 0``'s round, then one round of the sharded packed lanes
   (``ShardedLaneRunner``, bf16, ``lane_lowering="pallas"``) with B1
   launched 53 x lane steps; (c) one
   ``compat.FedML_FedAvg_distributed`` call on the mesh. Two ranks
   cannot share one card under NCCL: the ring and the multi-rank rounds
   run in the CPU tests under gloo;
18. run tensor, pipeline and expert parallelism and the measurement
   scripts (``phase_a15b``, budget ``A15B_BUDGET_S`` = 60 s): at the LM
   flagship's width (d_model 512, 4 layers, 4 heads of 128, T 80, vocab
   90, bf16, batch 32) one tp step on a one-rank ``(data, model)`` NCCL
   mesh (the blockwise ``tp_attention``, as in the reference) and one
   GPipe step on one stage with 4 microbatches through the flash
   kernels, B2, B3 and B4 each launched 4 layers x 4 microbatches = 16
   times (counts set to 0 just before the step and read just after);
   one ep step of the MoE LM of phase 8 (vocab 90, 4 layers, d_model
   256, 8 experts, T 80, bf16) on a one-rank ``(data, expert)`` mesh;
   each held against the plain unsharded step from the same weights
   (SGD lr 0.1) within its ``A15B_TOL``, every leaf's gap against that
   leaf's own move; pp's bound is also held below a planted fault (the
   last microbatch's gradient dropped), which every leaf must read
   above; then ``bench_lm`` (2 layers), ``bench_lane_conv`` (``pallas``
   and ``packed``, B1 on the backward), ``hw_smoke_flash``,
   ``profile_lane_step`` (2 lanes of 8 samples, B1 in its
   ``B2_packed_lanes[pallas]`` row), ``bench_gkt`` (``--tiny``, one
   round) and ``convergence`` (3 rounds of two configurations: a run
   check, no plateau verdict) at cut sizes, each line with the card's
   name and power limit;
19. run the port's static analyzer over the port (``phase_fedlint``,
   budget ``FEDLINT_BUDGET_S`` = 60 s): ``python -m
   fedml_tpu_torch.analysis fedml_tpu_torch --baseline '' --format json
   --max-seconds 60`` in a subprocess on this machine's Python, which
   must exit 0 with 0 findings; the line prints the findings, the
   rules (all ``FEDLINT_RULES`` = 40 of the reference's catalog: the
   per-module rules and the protocol, cross-class, determinism,
   model-checking and privacy passes), the analyzer's own wall time and
   the subprocess's, with the card's name and power limit (no kernel
   runs);
20. replay the model checker's counterexamples on the card
   (``phase_modelcheck``, budget ``MC_BUDGET_S`` = 120 s), reusing
   phase 11's LM flagship clients (``CP_WORLD`` = 5, the trainer on the
   card): (a) the port's model checker over the reference's minimal
   server x 2 clients fixture finds exactly one FL141 counterexample,
   which ``trace_to_fault_plan`` compiles to a plan with no rules; (b)
   that plan replays against ``run_tcp_fedavg`` with
   ``ResilientFedAvgServer._on_report`` made inert (the original put back
   in a ``finally``): the four clients' round-0 reports all arrive and
   the run raises ``TimeoutError`` naming the hung round 0 after
   ``MC_JOIN_S`` = 20 s; (c) the trace ``deliver sync server->client1``,
   ``kill client1`` compiles to ``(FaultRule("kill", rank=2, nth=1),)``
   and 2 rounds under it (``RoundPolicy``, quorum 0.3, phase 11's 24 s
   deadline) finish with ``failed is None``, 2 history entries and one
   client dropped. In (b) and (c) each of B2-B4 must launch once a layer
   a step of the trainer calls recorded in the run; every line names the
   card and its power limit;
21. print the ``kernels`` JSON line (B1-B4 on the main paths' bf16
   launches, then B2-B4's fp32 kernels at ``main_longcontext``'s launch,
   with their launches over its fp32 steps, then the chunked route's
   bf16 and fp32 kernels at its launch at head dim 256, with their
   launches over its steps at that width) and, last, the ``ok`` line.

``python3 chip_smoke.py --profile`` adds, before the last lines, B1's
kernels (products and split-K pass) at each shape, the timer's floor,
the attention backward's kernels (ours and SDPA's) under
``torch.profiler``, one timed round per lane lowering and a
``torch.profiler`` breakdown of a ``pallas`` ResNet round and of an LM
round by kernel.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types

# the kernels' timer: median device time a call, after an L2 flush and a
# device spin that covers the host's enqueue (its docstring says why)
from fedml_tpu_torch.scripts._common import flushed_ms as timed_ms

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 tensor-core peak
L, B = 8, 64
# the LM flagship (bench.py --lm defaults): one attention launch is the
# 8 clients x batch 4 of a chunk at T=80, 4 heads of 128
LM_D, LM_LAYERS, LM_CLIENTS, LM_BATCH, LM_CHUNK = 512, 4, 32, 4, 8
# (label, batch, T, causal, head dim); experiment_T20 is the launch of
# the experiment main's LM (8 clients x batch 4 a wave, T 20, heads of 64),
# control_plane that of one TCP client rank's LM (batch 4, no client axis)
ATTN_CASES = [("flagship", 32, 80, True, 128),
              ("ragged_T", 32, 100, True, 128),
              ("non_causal", 32, 80, False, 128),
              ("experiment_T20", 32, 20, True, 64),
              ("control_plane", 4, 80, True, 128)]
ATTN_H, ATTN_D = 4, 128
# (label, Ci, Co, H, stride-1 convs of this shape in one ResNet-56 step)
DW_SHAPES = [("stem", 3, 16, 32, 1), ("stage1", 16, 16, 32, 18),
             ("stage2", 32, 32, 16, 17), ("stage3", 64, 64, 8, 17)]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_kernels(torch, grouped_conv):
    """Kernel vs plain version at the main path's four dW shapes, timed
    beside cuDNN's ``conv2d_weight``: in bf16 (``dw_shape`` lines, the
    main path's tensor-core route, tolerance 1e-3 * max|ref| + 1e-3),
    then in fp32 (``dw_shape_fp32`` lines: ``dw_partial_kernel`` on the
    CUDA cores against cuDNN in fp32, ``torch.backends.cudnn.allow_tf32``
    False as ``main`` sets it and the line states; the card tests'
    tolerance 1e-4 * max|ref| + 1e-5). Each line gives its error over its
    tolerance. Returns the bf16 rows."""
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for dtype, prefix, ops_per_s, (rel, abs_) in (
            (torch.bfloat16, "dw_shape", BF16_OPS_PER_S, (1e-3, 1e-3)),
            (torch.float32, "dw_shape_fp32", FP32_OPS_PER_S, (1e-4, 1e-5))):
        gen = torch.Generator(device=dev).manual_seed(0)
        itemsize = 2 if dtype == torch.bfloat16 else 4
        for label, ci, co, hw, per_step in DW_SHAPES:
            x = torch.randn((B, L * ci, hw, hw), generator=gen, device=dev
                            ).to(dtype)
            dy = torch.randn((B, L * co, hw, hw), generator=gen, device=dev
                             ).to(dtype)
            args = (x, dy, L, 3, 3, (1, 1))
            before = dict(grouped_conv.route_launches)
            got = grouped_conv.grouped_conv_dw(*args)
            route = [k for k, n in grouped_conv.route_launches.items()
                     if n != before[k]]
            ref = grouped_conv.grouped_conv_dw_reference(
                x.float(), dy.float(), L, 3, 3, (1, 1))
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = rel * float(ref.abs().max()) + abs_
            if not math.isfinite(err) or err > tol:
                fail(f"grouped_conv_dw {label} {dtype}: max|err| {err} > "
                     f"tol {tol}")
            w_shape = (L * co, ci, 3, 3)
            ms = timed_ms(lambda: grouped_conv.grouped_conv_dw(*args),
                          flush)
            plain_ms = timed_ms(
                lambda: grouped_conv.grouped_conv_dw_reference(*args), flush)
            library_ms = timed_ms(lambda: torch.nn.grad.conv2d_weight(
                x, w_shape, dy, padding=1, groups=L), flush)
            K = B * hw * hw
            nbytes = (x.numel() + dy.numel()) * itemsize + L * co * ci * 9 * 4
            ops = 2 * L * ci * co * 9 * K
            row = {"shape": label, "route": route[0], "x": list(x.shape),
                   "dy": list(dy.shape), "convs_per_step": per_step,
                   "max_abs_err": err, "tol": tol, "err_over_tol": err / tol,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "ops_ms": ops / ops_per_s * 1e3}
            if dtype == torch.float32:
                row["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
            print(f"{prefix} " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                rows.append(row)
    return rows


def _check(label, got, ref, rel, abs_):
    """max|got - ref|; fails above ``rel * max|ref| + abs_``."""
    err = float((got.float() - ref.float()).abs().max())
    tol = rel * float(ref.float().abs().max()) + abs_
    if not math.isfinite(err) or err > tol:
        fail(f"{label}: max|err| {err} > tol {tol}")
    return err


def _mismatch(got, ref):
    """Share of the elements of the tensors ``got`` that are not
    bit-equal to those of ``ref``."""
    differ = sum(int((g != r).sum()) for g, r in zip(got, ref))
    return differ / sum(g.numel() for g in got)


def mma_kernel_usage(_build, fa, grouped_conv, reports):
    """Registers and spills (bytes) of the tensor-core kernels from the
    ``-Xptxas -v`` reports, with threads, shared memory and blocks an SM
    of their launch on this card: the bf16 dW kernel at each of the main
    path's four shapes (its ``CH`` instance and K splits too), the bf16
    forward, dq and dk/dv kernels and the fp32 (3xTF32) forward, dq and
    dk/dv kernels per head dim (64 and 128), and the kernels of head dims
    above 128 (dq's and dk/dv's chunked ones, the forward's four
    instances). Fails when a kernel is missing from a report."""
    out = {}
    usage = _build.ptxas_usage(reports[grouped_conv.LIBRARY.name])
    fn = grouped_conv.MMA_KERNEL
    for label, ci, co, hw, _ in DW_SHAPES:
        info = grouped_conv.mma_launch_info(B, L, ci, co, hw, hw, 3, 3,
                                            (1, 1))
        tag = f"{len(fn)}{fn}ILi{info['ch']}E"
        found = [u for k, u in usage.items() if tag in k]
        if len(found) != 1:
            fail(f"{fn}<{info['ch']}> not in the ptxas report")
        out[f"dw_{label}"] = {**found[0], **info}
    usage = _build.ptxas_usage(reports[fa.LIBRARY.name])
    for D in (128, 64):
        info = fa.mma_launch_info(D)
        for dtype, kernels, suffix in (("bf16", fa.MMA_KERNELS, ""),
                                       ("fp32", fa.TF32_KERNELS, "_tf32")):
            for name, fn in kernels.items():
                tag = fa.mma_kernel_tag(name, D, kernels)
                found = [u for k, u in usage.items() if tag in k]
                if len(found) != 1:
                    fail(f"{fn}<{D}> not in the ptxas report")
                out[f"{name}_{dtype}_D{D}"] = {**found[0],
                                               **info[name + suffix]}
    # the kernels of head dims above 128: dq's and dk/dv's chunked ones,
    # one for every such D (launch shape at D 256: two chunks); the
    # forward's instance at D 256 (``fwd_*_wide``), 384, 512 and, above
    # 512, the one of grid axis z (D 1024)
    for D in (256, 384, 512, 1024):
        info = fa.mma_launch_info(D)
        for dtype, suffix in (("bf16", ""), ("fp32", "_tf32")):
            for name, fn in fa.WIDE_KERNELS.items():
                if D != 256 and name != "fwd":
                    continue
                tag = fa.wide_kernel_tag(name, dtype, D)
                found = [u for k, u in usage.items() if tag in k]
                if len(found) != 1:
                    fail(f"{fn}<{dtype}> at D {D} not in the ptxas report")
                key = f"{name}_{dtype}_wide" + ("" if D == 256 else f"_D{D}")
                out[key] = {**found[0], **info[name + suffix]}
    return out


def _attn_bounds(B, T, causal, itemsize=2, D=ATTN_D,
                 ops_per_s=BF16_OPS_PER_S):
    """Least times (ms) of B2, B3, B4 and of the whole backward on this
    launch: bytes (each input read once, each output written once) over
    the memory rate, and the products' operations on this data's valid
    (query, key) pairs over the peak of their type (bf16 by default);
    the larger of the two, and which."""
    tensor = B * T * ATTN_H * D * itemsize
    row = B * ATTN_H * T * 4                    # lse or delta, fp32
    pairs = B * ATTN_H * (T * (T + 1) // 2 if causal else T * T)
    out = {}
    # "bwd": the whole backward as one function -- q, k, v, O, dO and lse
    # in, dq, dk, dv out; five products (S, dP, dQ, dK, dV)
    for name, n_tensors, n_rows, products in (("fwd", 4, 1, 2),
                                              ("dq", 5, 2, 3),
                                              ("dkv", 6, 2, 4),
                                              ("bwd", 8, 1, 5)):
        nbytes = n_tensors * tensor + n_rows * row
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * products * D * pairs / ops_per_s * 1e3
        out[name] = {"bytes": nbytes, "ops": 2 * products * D * pairs,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"}
    return out


def phase_attention(torch, fa):
    """B2-B4, at the strided q, k, v layout of the main path, against
    their plain versions (bf16, tolerance 1.6e-2 *
    max|ref| + 1e-3: both round to bf16 and the kernel rounds p against
    its running row maximum; lse fp32 at 1e-4 * max|lse| + 1e-5), then,
    at the flagship launch, times of kernel, plain version and
    ``scaled_dot_product_attention`` (forward; its backward through
    autograd computes dq, dk and dv together and stands for both B3 and
    B4), and of the whole ``FlashAttention`` backward through autograd
    (delta, B3, B4) against SDPA's backward and the plain backward."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    timing = None
    for label, Bq, T, causal, D in ATTN_CASES:
        C = ATTN_H * D
        # q, k, v as the model hands them over: column slices of one fused
        # qkv product [B, T, 3C], each viewed as [B, T, H, D] (rows of
        # D elements 3C apart), with no copy
        qkv = torch.randn(Bq, T, 3 * C, generator=gen, device=dev
                          ).to(torch.bfloat16)
        q, k, v = (qkv[..., j * C:(j + 1) * C].reshape(Bq, T, ATTN_H, D)
                   for j in range(3))
        do = torch.randn(Bq, T, ATTN_H, D, generator=gen, device=dev
                         ).to(torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, do, lse_ref, delta.contiguous(), causal)
        dq = fa.flash_attention_dq(*args)
        dk, dv = fa.flash_attention_dkv(*args)
        dq_ref, dk_ref, dv_ref = fa.flash_attention_bwd_reference(*args)
        torch.cuda.synchronize()
        row = {"case": label, "shape": [Bq, T, ATTN_H, D],
               "causal": causal, "max_abs_ref": {
                   n: float(r.float().abs().max()) for n, r in (
                       ("o", o_ref), ("dq", dq_ref), ("dk", dk_ref),
                       ("dv", dv_ref))},
               "fwd_err": _check(f"fwd {label}", o, o_ref, 1.6e-2, 1e-3),
               "lse_err": _check(f"lse {label}", lse, lse_ref, 1e-4, 1e-5),
               "dq_err": _check(f"dq {label}", dq, dq_ref, 1.6e-2, 1e-3),
               "dkv_err": max(
                   _check(f"dk {label}", dk, dk_ref, 1.6e-2, 1e-3),
                   _check(f"dv {label}", dv, dv_ref, 1.6e-2, 1e-3)),
               "fwd_mismatch": _mismatch((o,), (o_ref,)),
               "bwd_mismatch": _mismatch((dq, dk, dv),
                                         (dq_ref, dk_ref, dv_ref))}
        for name in errs:
            errs[name] = max(errs[name], row[f"{name}_err"])
        print("attention_case " + json.dumps(row), flush=True)
        if label != "flagship":
            continue
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qs, ks, vs))
        out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        g = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(out_g, (qg, kg, vg), g,
                                               retain_graph=True)
        bwd_lib = timed_ms(sdpa_bwd, flush)
        ref_args = args[:-1] + (causal, ATTN_D ** -0.5, T)
        qf, kf, vf = (t.detach().requires_grad_(True) for t in (q, k, v))
        out_f = fa.flash_attention(qf, kf, vf, causal)
        fa_bwd = lambda: torch.autograd.grad(out_f, (qf, kf, vf), do,
                                             retain_graph=True)

        def plain_bwd(o=o_ref, lse=lse_ref):
            d = (do.float() * o.float()).sum(-1).transpose(1, 2)
            return fa.flash_attention_bwd_reference(
                q, k, v, do, lse, d.contiguous(), causal)

        for name, got, ref in zip(("dq", "dk", "dv"), fa_bwd(),
                                  plain_bwd(o, lse)):
            _check(f"FlashAttention backward {name}", got, ref, 1.6e-2, 1e-3)
        timing = {
            "fwd": {"ms": timed_ms(lambda: fa.flash_attention_fwd(
                        q, k, v, causal), flush),
                    "plain_ms": timed_ms(
                        lambda: fa.flash_attention_fwd_reference(
                            q, k, v, causal), flush),
                    "library_ms": timed_ms(sdpa, flush)},
            "dq": {"ms": timed_ms(lambda: fa.flash_attention_dq(*args),
                                  flush),
                   "plain_ms": timed_ms(
                       lambda: fa.flash_attention_dq_reference(*ref_args),
                       flush),
                   "library_ms": bwd_lib},
            "dkv": {"ms": timed_ms(lambda: fa.flash_attention_dkv(*args),
                                   flush),
                    "plain_ms": timed_ms(
                        lambda: fa.flash_attention_dkv_reference(*ref_args),
                        flush),
                    "library_ms": bwd_lib},
            "bwd": {"ms": timed_ms(fa_bwd, flush),
                    "plain_ms": timed_ms(plain_bwd, flush),
                    "library_ms": bwd_lib}}
        for name, b in _attn_bounds(Bq, T, causal).items():
            timing[name].update(b)
            print(f"attention_time {name} " + json.dumps(timing[name]),
                  flush=True)
    return timing, errs


def build_api(torch, lowering="pallas", mesh=None):
    """FedAvgAPI of the main path: ResNet-56 (bf16), 16 clients x 256
    synthetic LDA alpha=0.5 samples, 8 lanes, batch 64, SGD lr 0.001 wd
    0.001, augmentation on, on the card as a user would call it; on
    ``mesh`` the lanes are sharded."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data.augment import make_cifar_augment
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models import resnet56

    clients = 16
    dataset = load_synthetic_images(
        client_num=clients, n_train=clients * 256, n_test=256,
        image_size=32, partition="hetero", partition_alpha=0.5, seed=0)
    model = resnet56(class_num=10, dtype=torch.bfloat16)
    spec = make_classification_spec(
        model, augment_fn=make_cifar_augment(pad=4, cutout_length=16),
        lane_lowering=lowering)
    args = types.SimpleNamespace(
        client_num_in_total=clients, client_num_per_round=clients,
        comm_round=2, epochs=1, batch_size=B, lr=0.001, wd=0.001,
        client_optimizer="sgd", frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=L, wave_mode=3, device_resident="auto",
        device_data_cap_gb=4.0, device_dtype=None)
    return FedAvgAPI(dataset, spec, args, mesh=mesh)


def phase_main_path(torch, grouped_conv):
    """Two rounds of lane-packed FedAvg on full-width ResNet-56."""
    api = build_api(torch)
    if api.device.type != "cuda":
        fail(f"FedAvgAPI chose {api.device}")
    g0 = {k: v.clone() for k, v in api.global_state["params"].items()}
    grouped_conv.launches = 0
    for route in grouped_conv.route_launches:
        grouped_conv.route_launches[route] = 0
    records, trips = [], []
    for _ in range(2):
        records.append(api.train_one_round())
        trips.append(api._last_trip)
    launches = grouped_conv.launches
    routes = dict(grouped_conv.route_launches)
    records[-1].update(api.evaluate_global())
    for r in records:
        print("round " + json.dumps(r), flush=True)
    expect = 53 * sum(trips)
    if launches != expect:
        fail(f"grouped_conv_dw launched {launches} times, expected 53 x "
             f"{sum(trips)} lane steps = {expect}")
    if routes != {"tensor_core": expect, "cuda_core": 0}:
        fail(f"grouped_conv_dw routes {routes}: every main-path call should "
             f"take the tensor-core kernel ({expect})")
    for r in records:
        if not (math.isfinite(r["Train/Loss"])
                and math.isfinite(r["Test/Loss"] if "Test/Loss" in r
                                  else 0.0)):
            fail(f"non-finite loss in {r}")
    moved = max(float((api.global_state["params"][k] - g0[k]).abs().max())
                for k in g0)
    finite = all(bool(torch.isfinite(v).all())
                 for part in api.global_state.values()
                 for v in part.values())
    if not finite or moved <= 0.0:
        fail(f"global state finite={finite}, max param change {moved}")
    print(f"main_path rounds={len(records)} lane_steps={sum(trips)} "
          f"kernel_launches={launches} routes={json.dumps(routes)} "
          f"max_param_change={moved} "
          f"round_time_s={[r['round_time_s'] for r in records]}",
          flush=True)
    return launches


def build_lm_api(torch):
    """FedAvgAPI of the LM flagship, from the argument namespace
    ``bench.py --lm`` builds (``run_lm_bench``), on the card."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.data.shakespeare import (
        SEQUENCE_LENGTH, VOCAB_SIZE, synthetic_shakespeare_clients)
    from fedml_tpu_torch.models.transformer import TransformerLM

    T, V = SEQUENCE_LENGTH, VOCAB_SIZE
    dataset = synthetic_shakespeare_clients(LM_CLIENTS, T, V)
    model = TransformerLM(vocab_size=V, n_layers=LM_LAYERS,
                          n_heads=max(1, LM_D // 128), d_model=LM_D,
                          max_len=T, dtype=torch.bfloat16)
    spec = make_seq_classification_spec(model, name="lm")
    run_args = types.SimpleNamespace(
        client_num_in_total=LM_CLIENTS, client_num_per_round=LM_CLIENTS,
        comm_round=10 ** 9, epochs=1, batch_size=LM_BATCH,
        lr=3e-4, wd=0.0, client_optimizer="adam",
        frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=LM_CHUNK, bucket_edges="geometric",
        device_resident="0")
    return FedAvgAPI(dataset, spec, run_args), model


def phase_lm_main_path(torch, fa):
    """Two rounds of the LM flagship through the flash-attention kernels;
    then the trained model's logits on two test sequences, on the card
    (kernels, fp32 compute) against the CPU (plain versions, fp32):
    tolerance 1e-3 * max|logit| + 1e-4, fp32 sums in another order."""
    from fedml_tpu_torch.models.transformer import TransformerLM

    api, model = build_lm_api(torch)
    if api.device.type != "cuda":
        fail(f"FedAvgAPI chose {api.device}")
    torch.cuda.reset_peak_memory_stats()
    g0 = {k: v.clone() for k, v in api.global_state["params"].items()}
    for name in fa.launches:
        fa.launches[name] = 0
    records, trips = [], 0
    for _ in range(2):
        r = api.train_one_round()
        records.append(r)
        trips += r["bucket/executed_steps"] // LM_CHUNK
    launches = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    records[-1].update(api.evaluate_global())
    for r in records:
        print("lm_round " + json.dumps(r), flush=True)
    expect = LM_LAYERS * trips
    for name, n in launches.items():
        if n != expect:
            fail(f"flash attention {name} launched {n} times, expected "
                 f"{LM_LAYERS} layers x {trips} chunk steps = {expect}")
    for r in records:
        if not (math.isfinite(r["Train/Loss"])
                and math.isfinite(r.get("Test/Loss", 0.0))):
            fail(f"non-finite LM loss in {r}")
    params = api.global_state["params"]
    moved = max(float((params[k] - g0[k]).abs().max()) for k in g0)
    finite = all(bool(torch.isfinite(v).all()) for v in params.values())
    if not finite or moved <= 0.0:
        fail(f"LM global state finite={finite}, max param change {moved}")
    fp32 = TransformerLM(vocab_size=model.vocab_size,
                         n_layers=model.n_layers, n_heads=model.n_heads,
                         d_model=model.d_model, max_len=model.max_len)
    x = torch.as_tensor(api.test_data_global["x"][:2])
    got = fp32.apply_params(params, x.cuda())
    ref = fp32.apply_params({k: v.cpu() for k, v in params.items()}, x)
    logit_err = _check("LM logits card vs CPU", got.cpu(), ref, 1e-3, 1e-4)
    print(f"lm_main_path rounds={len(records)} chunk_steps={trips} "
          f"launches={launches} max_param_change={moved} "
          f"logit_err={logit_err} peak_memory_gb={peak_gb:.3f} "
          f"round_time_s={[r['round_time_s'] for r in records]}",
          flush=True)
    return launches


def phase_bench(grouped_conv, fa):
    """The port's bench through its ``main``, as a user runs it: the LM
    flagship (1 measured round) and the ResNet recipe at full data for 1
    epoch under ``--lane_lowering pallas`` (1 measured round), each with
    every kernel counter set to 0 just before and read just after. The
    FLOP cross-check reads ``flops_vs_analytic`` of the ResNet record and
    its LM counterpart ``step_cost_vs_analytic``. ``bench.main`` prints
    each record on a line of its own."""
    from fedml_tpu_torch import bench

    runs = (("lm", ["--lm", "--rounds", "1"], "step_cost_vs_analytic",
             {"bucket-chunk"}),
            ("resnet", ["--epochs", "1", "--rounds", "1", "--lane_lowering",
                        "pallas"], "flops_vs_analytic",
             {"broadcast", "lanes"}))
    for label, argv, ratio_key, spans in runs:
        for name in fa.launches:
            fa.launches[name] = 0
        grouped_conv.launches = 0
        for route in grouped_conv.route_launches:
            grouped_conv.route_launches[route] = 0
        rec = bench.main(argv + ["--ledger", ""])
        attn = dict(fa.launches)
        dw, routes = grouped_conv.launches, dict(grouped_conv.route_launches)
        if "error" in rec:
            fail(f"bench {label}: {rec['error']}")
        if not (rec["value"] > 0 and rec["mfu"] is not None
                and 0 < rec["mfu"] < 1):
            fail(f"bench {label}: value {rec['value']}, mfu {rec['mfu']}")
        want = {"round", "cohort-select", "local-train", "aggregate",
                "report"} | spans
        if not want <= set(rec["phase_timings_s"]):
            fail(f"bench {label}: spans {sorted(rec['phase_timings_s'])} "
                 f"lack {sorted(want - set(rec['phase_timings_s']))}")
        if abs(rec[ratio_key] - 1.0) > bench.FLOPS_XCHECK_TOL:
            fail(f"bench {label}: {ratio_key} {rec[ratio_key]} outside "
                 f"1 +- {bench.FLOPS_XCHECK_TOL}")
        if label == "lm":
            if (len(set(attn.values())) != 1 or attn["fwd"] <= 0
                    or attn["fwd"] % LM_LAYERS or dw):
                fail(f"bench lm: attention launches {attn}, dW {dw}")
        elif (dw <= 0 or dw % 53 or routes != {"tensor_core": dw,
                                                "cuda_core": 0}
              or any(attn.values())):
            fail(f"bench resnet: dW launches {dw}, routes {routes}, "
                 f"attention {attn}")
        print(f"bench_phase {label} attention_launches={json.dumps(attn)} "
              f"dw_launches={dw} routes={json.dumps(routes)} "
              f"{ratio_key}={rec[ratio_key]}", flush=True)


def _experiment(argv, main="main_fedavg"):
    """One run of the port's experiment main ``main`` on the card: the
    api and the seconds a round."""
    import importlib
    module = importlib.import_module(f"fedml_tpu_torch.experiments.{main}")

    api, _ = module.main(argv)
    if api.device.type != "cuda":
        fail(f"experiment main {argv} ran on {api.device}")
    for r in api.history:
        if not (math.isfinite(r["Train/Loss"])
                and math.isfinite(r.get("Test/Loss", 0.0))):
            fail(f"experiment main {argv}: non-finite loss in {r}")
    return api, [r["round_time_s"] for r in api.history]


#: ResNet-56 at full width through the experiment main, fp32
EXP_RESNET = ["--model", "resnet56", "--dataset", "synthetic_images",
              "--image_size", "32", "--client_num_in_total", "8",
              "--client_num_per_round", "8", "--n_train", "4096",
              "--batch_size", "64", "--epochs", "1", "--comm_round", "1"]
#: the three modes' global states agree within this under deterministic
#: kernels (fp32 sums in another order: waves against lanes, the flat
#: round's padded steps)
EXP_MODE_TOL = 1e-3
#: the full-width TransformerLM (factory default: d_model 256, 4 layers,
#: 4 heads of 64) through the waves in bf16
EXP_LM = ["--model", "transformer", "--dataset", "synthetic_sequences",
          "--model_dtype", "bf16", "--client_num_in_total", "16",
          "--client_num_per_round", "16", "--batch_size", "4",
          "--comm_round", "2", "--wave_mode", "1"]


def phase_experiment_main(torch, fa, grouped_conv, smi):
    """``python -m fedml_tpu_torch.experiments.main_fedavg`` in-process on
    the card: the reference's defaults (LR on ``synthetic``) for 2
    rounds; full-width ResNet-56 (fp32) under ``--wave_mode`` 0, 1 and 2
    with deterministic kernels, whose global states must agree within
    ``EXP_MODE_TOL`` (two runs of mode 1 under cuDNN's default kernels
    print their spread); the
    full-width TransformerLM (bf16) through the waves for 2 rounds, with
    the attention launch counters set to 0 just before and read just
    after (B3 and B4 once per layer of each local step, B2 at least as
    often: the evaluation runs it too). Each run prints its seconds a
    round beside the card's name and power limit."""
    api, times = _experiment(["--comm_round", "2"])
    print(f"experiment_main run=lr_defaults rounds={len(times)} "
          f"s_per_round={times} card={smi}", flush=True)
    diff = lambda a, b: max(float((a[part][k] - b[part][k]).abs().max())
                            for part in a for k in a[part])
    # cuDNN's default convolution kernels are not deterministic, and 11
    # SGD steps of ResNet-56 amplify their last-bit differences: two
    # runs of one mode differ (the spread below); the modes are compared
    # under deterministic kernels
    spread = [_experiment(EXP_RESNET + ["--wave_mode", "1"])[0].global_state
              for _ in range(2)]
    print(f"experiment_main run=resnet56_wave_mode_1_twice "
          f"nondeterministic_spread={diff(*spread)} card={smi}", flush=True)
    states = {}
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("0", "1", "2"):
            grouped_conv.launches = 0
            api, times = _experiment(EXP_RESNET + ["--wave_mode", mode])
            states[mode] = api.global_state
            print(f"experiment_main run=resnet56_wave_mode_{mode} "
                  f"deterministic=1 s_per_round={times} "
                  f"steps={api._last_trip} "
                  f"train_loss={api.history[-1]['Train/Loss']} "
                  f"dw_launches={grouped_conv.launches} card={smi}",
                  flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    diffs = {mode: diff(states[mode], states["1"]) for mode in ("0", "2")}
    if not all(d <= EXP_MODE_TOL for d in diffs.values()):
        fail(f"experiment main: wave_mode 0/2 states differ from 1 by "
             f"{diffs} > {EXP_MODE_TOL}")
    for name in fa.launches:
        fa.launches[name] = 0
    api, times = _experiment(EXP_LM)
    launches = dict(fa.launches)
    layers = sum(1 for k in api.global_state["params"]
                 if k.endswith(".qkv.weight"))
    if not (launches["dq"] == launches["dkv"] > 0
            and launches["dq"] % layers == 0
            and launches["fwd"] >= launches["dq"]):
        fail(f"experiment main LM: attention launches {launches}")
    print(f"experiment_main run=transformer_waves s_per_round={times} "
          f"train_loss={[r['Train/Loss'] for r in api.history]} "
          f"launches={json.dumps(launches)} mode_diffs={json.dumps(diffs)} "
          f"card={smi}", flush=True)


def _states_diff(torch, a, b):
    """Largest absolute difference over two same-structured trees of
    tensors (global or server states)."""
    if isinstance(a, dict):
        return max((_states_diff(torch, a[k], b[k]) for k in a),
                   default=0.0)
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_fedavg_family(torch, fa, smi):
    """The rest of the FedAvg family through its experiment mains on the
    card: ``main_fedopt`` (FedAdam) on the full-width TransformerLM (bf16)
    for 2 rounds, with the attention launch counters set to 0 just before
    and read just after (B3 and B4 a multiple of the layer count); the
    same run cut after round 1 with ``--checkpoint_dir`` and resumed for
    round 2, under deterministic kernels, equal to the uninterrupted run
    bit for bit (the difference printed); the README's Quick-start (LR on
    ``synthetic``) under each server optimizer; ``main_fednova``,
    ``main_hierarchical``, ``main_centralized`` and ``main_fedavg_robust``
    on full-width ResNet-56, 1 round each (the last printing
    ``Backdoor/Acc``). Every run is on the card with finite losses and
    prints its seconds a round beside the card's name and power limit."""
    import shutil

    t0 = time.time()
    lm = EXP_LM + ["--server_optimizer", "adam"]
    ckpt = os.path.join(HERE, "build", "chip_smoke_checkpoints")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        for name in fa.launches:
            fa.launches[name] = 0
        full, times = _experiment(lm, "main_fedopt")
        launches = dict(fa.launches)
        layers = sum(1 for k in full.global_state["params"]
                     if k.endswith(".qkv.weight"))
        if not (launches["dq"] == launches["dkv"] > 0
                and launches["dq"] % layers == 0
                and launches["fwd"] >= launches["dq"]):
            fail(f"fedavg_family FedAdam LM: attention launches {launches}")
        print(f"fedavg_family run=fedopt_adam_lm deterministic=1 "
              f"s_per_round={times} "
              f"train_loss={[r['Train/Loss'] for r in full.history]} "
              f"launches={json.dumps(launches)} card={smi}", flush=True)
        # the last --comm_round given wins: the cut run stops after 1
        part, _ = _experiment(lm + ["--comm_round", "1", "--checkpoint_dir",
                                    ckpt], "main_fedopt")
        resumed, times = _experiment(
            lm + ["--checkpoint_dir", ckpt, "--resume", "1"], "main_fedopt")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if part.round_idx != 1 or [r["round"] for r in resumed.history] != [1]:
        fail(f"fedavg_family resume: rounds {part.round_idx}, "
             f"{[r['round'] for r in resumed.history]}")
    diff = max(_states_diff(torch, resumed.global_state, full.global_state),
               _states_diff(torch, resumed.server_state, full.server_state))
    print(f"fedavg_family run=fedopt_adam_lm_resumed deterministic=1 "
          f"resume_diff={diff} s_per_round={times} card={smi}", flush=True)
    if diff != 0.0:
        fail(f"fedavg_family: the resumed FedAdam LM run differs from the "
             f"uninterrupted one by {diff}")
    for opt in ("sgd", "adam", "adagrad", "yogi"):
        api, times = _experiment(["--dataset", "synthetic", "--model", "lr",
                                  "--server_optimizer", opt], "main_fedopt")
        print(f"fedavg_family run=quick_start_{opt} rounds={len(times)} "
              f"s_per_round={times} "
              f"train_loss={api.history[-1]['Train/Loss']} "
              f"test_acc={api.history[-1]['Test/Acc']} card={smi}",
              flush=True)
    for main in ("main_fednova", "main_hierarchical", "main_centralized",
                 "main_fedavg_robust"):
        api, times = _experiment(EXP_RESNET, main)
        extra = ""
        if main == "main_fedavg_robust":
            backdoor = api.evaluate_backdoor()["Backdoor/Acc"]
            if not 0.0 <= backdoor <= 1.0:
                fail(f"fedavg_family robust: Backdoor/Acc {backdoor}")
            extra = f" Backdoor/Acc={backdoor}"
        print(f"fedavg_family run={main[5:]}_resnet56 s_per_round={times} "
              f"train_loss={api.history[-1]['Train/Loss']}{extra} "
              f"card={smi}", flush=True)
    print(f"fedavg_family phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)


#: the MoE TransformerLM at the factory's full width through the steered
#: resilient rounds of the experiment main
EXP_MOE = ["--model", "moe_transformer", "--model_dtype", "bf16",
           "--dataset", "synthetic_sequences", "--client_num_in_total", "32",
           "--client_num_per_round", "8", "--batch_size", "4",
           "--overselect", "0.3", "--straggler_p", "0.25", "--quorum",
           "0.34", "--pace_steering", "1", "--comm_round", "4",
           "--wave_mode", "1"]
#: card (kernels, fp32) against CPU (plain versions, fp32) for one MoE
#: step: logits as the LM phase holds them (1e-3 * max|logit| + 1e-4);
#: loss and aux loss 1e-4 absolute (two clients' summed loss is about 10
#: and each client's aux, summed over 4 layers, about 7: fp32 sums of a
#: few thousand terms in another order move them by about 1e-6);
#: gradients 1e-3 * max|grad| + 1e-6. A route that flips (the argmax of
#: the router's gates) fails by itself: the share must be 0.
MOE_TOL = {"logits": (1e-3, 1e-4), "loss": 1e-4, "aux": 1e-4,
           "grad": (1e-3, 1e-6)}


def _replay_res_pace(args, rounds, total, per_round):
    """The ``res/*`` and ``pace/*`` records of ``rounds`` rounds from
    ``SimResilience`` and ``PaceController`` alone on the host, steered
    as ``FedAvgAPI._sample_cohort`` steers them (device-independent)."""
    import dataclasses

    from fedml_tpu_torch.resilience.integration import SimResilience
    from fedml_tpu_torch.resilience.steering import PaceController

    res, pace = SimResilience.from_args(args), PaceController.from_args(args)
    target, prev, out = min(per_round, total), None, []
    for rnd in range(rounds):
        if prev is not None:
            dec = pace.decide(
                outcome="degraded" if prev["res/degraded"] else "complete",
                selected=target,
                reporting=min(prev["res/reporting"], target))
            res.policy = dataclasses.replace(res.policy,
                                             overselect=dec.overselect)
        _, prev = res.sample(rnd, total, per_round)
        prev.update(pace.record())
        out.append(prev)
    return out


def _moe_step(torch, model, params, batch, device):
    """One training step of the stacked MoE LM on ``device``: loss (with
    0.01 * aux), per-client aux, logits, each layer's routes (expert and
    kept) and the gradients, all back on the CPU."""
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.models import moe

    P = {k: v.to(device).requires_grad_() for k, v in params.items()}
    b = {k: v.to(device) for k, v in batch.items()}
    spec = make_seq_classification_spec(model)
    loss, _ = spec.stacked_loss_fn({"params": P}, b, True)
    loss.backward()
    routes, inner = [], moe.moe_mlp

    def recording(*a, **kw):
        out = inner(*a, **kw)
        routes.append((out[2].cpu(), out[3].cpu()))
        return out

    moe.moe_mlp = recording
    try:
        with torch.no_grad():
            logits, aux = model.apply_params(P, b["x"], stacked=True,
                                             with_sown=True)
    finally:
        moe.moe_mlp = inner
    return {"loss": float(loss.detach()), "aux": aux.cpu(),
            "logits": logits.cpu(),
            "routes": routes,
            "grads": {k: v.grad.cpu() for k, v in P.items()}}


def _moe_step_check(torch, label, model, params, batch):
    """The card's MoE step against the CPU's: fails on a flipped route or
    a difference past ``MOE_TOL``; returns the printed differences."""
    card = _moe_step(torch, model, params, batch, torch.device("cuda"))
    cpu = _moe_step(torch, model, params, batch, torch.device("cpu"))
    tokens = sum(e.numel() for e, _ in cpu["routes"])
    flips = sum(int((a[0] != b[0]).sum())
                for a, b in zip(card["routes"], cpu["routes"]))
    kept = sum(int((a[1] != b[1]).sum())
               for a, b in zip(card["routes"], cpu["routes"]))
    rel, abs_ = MOE_TOL["logits"]
    logit_err = _check(f"MoE {label} logits card vs CPU", card["logits"],
                       cpu["logits"], rel, abs_)
    loss_err = abs(card["loss"] - cpu["loss"])
    aux_err = float((card["aux"] - cpu["aux"]).abs().max())
    grel, gabs = MOE_TOL["grad"]
    grad_err = max(float((card["grads"][k] - g).abs().max())
                   - grel * float(g.abs().max()) - gabs
                   for k, g in cpu["grads"].items())
    out = {"tokens_routed": tokens, "route_flip_share": flips / tokens,
           "capacity_flip_share": kept / tokens, "loss": cpu["loss"],
           "loss_err": loss_err, "aux": [float(a) for a in cpu["aux"]],
           "aux_err": aux_err, "logit_err": logit_err,
           "grad_err_over_tol": grad_err}
    if flips or kept:
        fail(f"MoE {label}: {flips} of {tokens} tokens routed to another "
             f"expert and {kept} kept otherwise on the card")
    if (loss_err > MOE_TOL["loss"] or aux_err > MOE_TOL["aux"]
            or grad_err > 0.0):
        fail(f"MoE {label} card vs CPU past MOE_TOL: {out}")
    return out


def phase_resilience_moe(torch, fa, smi):
    """The MoE TransformerLM through the steered resilient rounds of
    ``main_fedavg`` on the card (``EXP_MOE``), with the attention launch
    counters set to 0 just before and read just after (each of B2, B3 and
    B4 launched; B3 and B4 a multiple of the layer count), every round's
    ``res/*`` and ``pace/*`` fields equal to the host-only replay, and
    the seconds a round and peak memory printed beside the card's name
    and power limit; then the MoE step check at T 20 and T 80
    (:func:`_moe_step_check`). Returns the main run's launches."""
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.data.shakespeare import synthetic_shakespeare_clients
    from fedml_tpu_torch.data.synthetic import load_synthetic_sequences
    from fedml_tpu_torch.models.moe import MoETransformerLM

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:
        fa.launches[name] = 0
    api, times = _experiment(EXP_MOE)
    launches = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = sum(1 for k in api.global_state["params"]
                 if k.endswith(".moe.wi"))
    if layers != 4 or not all(n > 0 for n in launches.values()) or not (
            launches["dq"] == launches["dkv"]
            and launches["dq"] % layers == 0):
        fail(f"resilience_moe: {layers} MoE layers, attention launches "
             f"{launches}")
    records = [{k: v for k, v in r.items()
                if k.startswith(("res/", "pace/"))} for r in api.history]
    want = _replay_res_pace(api.args, len(records), 32, 8)
    for r in api.history:
        print("resilience_moe_round " + json.dumps(r), flush=True)
    if records != want:
        fail(f"resilience_moe: round records {records} differ from the "
             f"host-only replay {want}")
    print(f"resilience_moe run=moe_transformer_steered rounds={len(times)} "
          f"s_per_round={times} "
          f"train_loss={[r['Train/Loss'] for r in api.history]} "
          f"launches={json.dumps(launches)} peak_memory_gb={peak_gb:.3f} "
          f"card={smi}", flush=True)

    model = MoETransformerLM(90, n_layers=4, n_heads=4, d_model=256,
                             n_experts=8, max_len=80)
    params = make_seq_classification_spec(model).init_fn(0, "cpu")["params"]
    seq = load_synthetic_sequences(client_num=2, seed=0)
    leaf = synthetic_shakespeare_clients(2, 80, 90, seed=0)
    for label, ds in (("T20", seq), ("T80", leaf)):
        batch = {k: torch.stack([torch.as_tensor(ds[5][c][k][:4])
                                 for c in range(2)]) for k in ("x", "y")}
        batch["mask"] = torch.ones(2, 4)
        stacked = {k: torch.stack([v, v]) for k, v in params.items()}
        out = _moe_step_check(torch, label, model, stacked, batch)
        print(f"resilience_moe step={label} shape={list(batch['x'].shape)} "
              f"{json.dumps(out)} card={smi}", flush=True)
    print(f"resilience_moe phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)
    return launches


#: the StackOverflow next-word task (Reddi et al., Adaptive Federated
#: Optimization): 50 clients a round, batch 16, 1 local epoch; a
#: population of 500 in-memory clients over a 10,000-word vocabulary
SO_VOCAB, SO_CLIENTS, SO_PER_ROUND, SO_BATCH = 10_000, 500, 50, 16
#: card (fp32) against CPU (fp32) for one LSTM step of 2 clients x batch
#: 16, bounded as ``MOE_TOL`` bounds the MoE step: logits 1e-3 *
#: max|logit| + 1e-4, loss 1e-4 absolute (the
#: summed loss of two clients is about 18; fp32 sums of a few thousand
#: terms in another order move it by about 1e-6), gradients 1e-3 *
#: max|grad| + 1e-6
LSTM_TOL = {"logits": (1e-3, 1e-4), "loss": 1e-4, "grad": (1e-3, 1e-6)}


def stackoverflow_population(clients, vocab_size, seed=0):
    """A StackOverflow-shaped population in memory: each client's
    sentence count lognormal(3, 1) clipped to 1-256, each sentence 4-30
    words drawn from a synthetic vocabulary of ``vocab_size`` words,
    tokenized by the port's ``tokens_to_ids`` (T 20, no word outside the
    vocabulary) and checked on the host; the 8-tuple, with a test set of
    the first 256 sequences."""
    import numpy as np

    from fedml_tpu_torch.data.stackoverflow import check_nwp_ids, tokens_to_ids

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_size)]
    vocab = {w: i for i, w in enumerate(words)}
    counts = np.clip(rng.lognormal(3.0, 1.0, clients), 1, 256).astype(int)
    local, num, xs, ys = {}, {}, [], []
    for c, n in enumerate(counts):
        lens = rng.integers(4, 31, n)
        ids = rng.integers(0, vocab_size, int(lens.sum()))
        sents, off = [], 0
        for k in lens:
            sents.append(" ".join(words[i] for i in ids[off:off + k]))
            off += k
        seqs = np.asarray([tokens_to_ids(s, vocab) for s in sents], np.int32)
        local[c] = {"x": seqs[:, :-1], "y": seqs[:, 1:].astype(np.int64)}
        num[c] = int(n)
        xs.append(local[c]["x"])
        ys.append(local[c]["y"])
    x, y = np.concatenate(xs), np.concatenate(ys)
    check_nwp_ids(x, y, vocab_size)
    test = {"x": x[:256], "y": y[:256]}
    return [len(y), len(test["y"]), {"x": x, "y": y}, test, num, local,
            {0: test}, vocab_size + 4]


def build_stackoverflow_api(torch, dataset, device=None):
    """``FedAvgAPI`` of the full-width next-word LSTM through the async
    bucketed path, as ``bench.py`` builds its APIs."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.models.rnn import RNNStackOverflow

    model = RNNStackOverflow(vocab_size=dataset[7] - 4)
    args = types.SimpleNamespace(
        client_num_in_total=len(dataset[5]), client_num_per_round=SO_PER_ROUND,
        comm_round=10 ** 9, epochs=1, batch_size=SO_BATCH, lr=0.3, wd=0.0,
        client_optimizer="sgd", frequency_of_the_test=10 ** 9, seed=0,
        client_chunk=8, bucket_edges="geometric", device_resident="0",
        async_agg=1, buffer_k=16, staleness_decay=0.5, async_window=4)
    return FedAvgAPI(dataset, make_seq_classification_spec(model), args,
                     device=device), model


def lstm_step(torch, model, params, batch, device):
    """One fp32 training step of the stacked next-word LSTM on ``device``:
    the loss, the logits and the gradients, back on the CPU."""
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec

    P = {k: v.to(device).requires_grad_() for k, v in params.items()}
    b = {k: v.to(device) for k, v in batch.items()}
    loss, _ = make_seq_classification_spec(model).stacked_loss_fn(
        {"params": P}, b, True)
    loss.backward()
    with torch.no_grad():
        logits = model.apply_params(P, b["x"], stacked=True)
    return {"loss": float(loss.detach()), "logits": logits.cpu(),
            "grads": {k: v.grad.cpu() for k, v in P.items()}}


def _massive_runs(bench, smi):
    """The bench's massive cohort at its uncut N, synchronous and async:
    both records, each held to its checks."""
    recs = {}
    for label, extra in (("sync", []), ("async", ["--massive_async", "1"])):
        rec = bench.main(["--massive_cohort", "--rounds", "2",
                          "--ledger", ""] + extra)
        if "error" in rec:
            fail(f"massive {label}: {rec['error']}")
        if rec["packing_backend"] != "native":
            fail(f"massive {label}: packing backend "
                 f"{rec['packing_backend']}, the card machine builds the "
                 "native shim")
        if not (rec["value"] > 0 and math.isfinite(rec["train_loss"])):
            fail(f"massive {label}: value {rec['value']}, loss "
                 f"{rec['train_loss']}")
        keys = ("value", "round_s", "round_times_s", "compile_s", "chunks",
                "executed_steps", "true_steps", "bucket_waste_frac",
                "train_loss", "packing_backend", "peak_memory_gb",
                "phase_totals_s")
        print(f"massive_async run={label} "
              + json.dumps({k: rec[k] for k in keys})
              + f" async={json.dumps(rec.get('async'))} card={smi}",
              flush=True)
        recs[label] = rec
    n = recs["async"]["clients_per_round"]
    a = recs["async"]["async"]
    want = math.ceil(n / 2048)
    if abs(a["flushes_this_round"] - want) > 1 or a["max_staleness"] <= 0:
        fail(f"massive async: {a['flushes_this_round']} flushes a round "
             f"(about {want} expected), max staleness {a['max_staleness']}")
    if recs["sync"]["true_steps"] != recs["async"]["true_steps"]:
        fail(f"massive: true steps {recs['sync']['true_steps']} (sync) != "
             f"{recs['async']['true_steps']} (async)")
    return recs


def _stackoverflow_runs(torch, smi):
    """The full-width next-word LSTM through 2 async bucketed rounds, then
    the card-vs-CPU fp32 step check."""
    dataset = stackoverflow_population(SO_CLIENTS, SO_VOCAB)
    torch.cuda.reset_peak_memory_stats()
    api, model = build_stackoverflow_api(torch, dataset)
    n_params = sum(v.numel() for v in api.global_state["params"].values())
    records = [api.train_one_round() for _ in range(2)]
    records[-1].update(api.evaluate_global())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in records:
        if not (math.isfinite(r["Train/Loss"])
                and r["async/flushes_this_round"] >= 1
                and r["bucket/clients"] == SO_PER_ROUND):
            fail(f"stackoverflow round {r}")
    if records[-1]["async/max_staleness"] <= 0:
        fail(f"stackoverflow: no stale fold in {records[-1]}")
    print(f"massive_async run=stackoverflow_nwp params={n_params} "
          f"s_per_round={[r['round_time_s'] for r in records]} "
          f"chunks={[r['bucket/chunks'] for r in records]} "
          f"flushes={[r['async/flushes_this_round'] for r in records]} "
          f"max_staleness={records[-1]['async/max_staleness']} "
          f"train_loss={[r['Train/Loss'] for r in records]} "
          f"test_loss={records[-1]['Test/Loss']} "
          f"peak_memory_gb={peak_gb:.3f} card={smi}", flush=True)

    params = {k: torch.stack([v, v]).cpu() for k, v in
              api.global_state["params"].items()}
    pair = [c for c, n in dataset[4].items() if n >= SO_BATCH][:2]
    batch = {k: torch.stack([torch.as_tensor(dataset[5][c][k][:SO_BATCH])
                             for c in pair]) for k in ("x", "y")}
    batch["mask"] = torch.ones(2, SO_BATCH)
    card = lstm_step(torch, model, params, batch, torch.device("cuda"))
    cpu = lstm_step(torch, model, params, batch, torch.device("cpu"))
    rel, abs_ = LSTM_TOL["logits"]
    logit_err = _check("LSTM logits card vs CPU", card["logits"],
                       cpu["logits"], rel, abs_)
    loss_err = abs(card["loss"] - cpu["loss"])
    grel, gabs = LSTM_TOL["grad"]
    grad_err = max(float((card["grads"][k] - g).abs().max())
                   - grel * float(g.abs().max()) - gabs
                   for k, g in cpu["grads"].items())
    out = {"loss": cpu["loss"], "loss_err": loss_err,
           "logit_err": logit_err, "grad_err_over_tol": grad_err}
    if loss_err > LSTM_TOL["loss"] or grad_err > 0.0:
        fail(f"LSTM step card vs CPU past LSTM_TOL: {out}")
    print(f"massive_async step=lstm_fp32 shape={list(batch['x'].shape)} "
          f"{json.dumps(out)} card={smi}", flush=True)


def _augmented_round(torch, augment):
    """One bucketed round of ResNet-56 (fp32) on the experiment phase's
    CIFAR-shaped data (8 clients, 4,096 32x32 samples), batch 64, with or
    without the CIFAR augmentation on the streamed client update."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data.augment import make_cifar_augment
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models import resnet56

    dataset = load_synthetic_images(
        client_num=8, n_train=4096, n_test=256, image_size=32,
        partition="hetero", partition_alpha=0.5, seed=0)
    spec = make_classification_spec(
        resnet56(class_num=10),
        augment_fn=(make_cifar_augment(pad=4, cutout_length=16)
                    if augment else None))
    args = types.SimpleNamespace(
        client_num_in_total=8, client_num_per_round=8, comm_round=1,
        epochs=1, batch_size=B, lr=0.01, wd=0.001, client_optimizer="sgd",
        frequency_of_the_test=10 ** 9, seed=0, client_chunk=L,
        bucket_edges="geometric", device_resident="0")
    api = FedAvgAPI(dataset, spec, args)
    rec = api.train_one_round()
    return api, rec


#: the experiment mains' async path on LR at the reference's defaults
EXP_ASYNC = ["--async_agg", "1", "--buffer_k", "4", "--client_chunk", "2",
             "--comm_round", "2"]


def _async_mains(smi):
    """``main_fedavg --async_agg 1`` and ``main_fedopt --async_agg 1
    --bucket_edges geometric`` on the card, each round's ``async/*`` and
    ``bucket/*`` counters equal to the same command's on the CPU (they
    are host bookkeeping: the schedule, the folds and the flushes)."""
    for main, extra in (("main_fedavg", []),
                        ("main_fedopt", ["--bucket_edges", "geometric"])):
        api, times = _experiment(EXP_ASYNC + extra, main=main)
        cpu, _ = _experiment_cpu(EXP_ASYNC + extra + ["--platform", "cpu"],
                                 main)
        counters = lambda h: [{k: v for k, v in r.items()
                               if k.startswith(("async/", "bucket/"))}
                              for r in h]
        if counters(api.history) != counters(cpu.history):
            fail(f"{main} --async_agg 1: card counters "
                 f"{counters(api.history)} differ from the CPU's "
                 f"{counters(cpu.history)}")
        print(f"massive_async run={main}_async_agg s_per_round={times} "
              f"flushes={[r['async/flushes_this_round'] for r in api.history]} "
              f"train_loss={[r['Train/Loss'] for r in api.history]} "
              f"cpu_train_loss={[r['Train/Loss'] for r in cpu.history]} "
              f"card={smi}", flush=True)


def _experiment_cpu(argv, main):
    import importlib
    module = importlib.import_module(f"fedml_tpu_torch.experiments.{main}")
    return module.main(argv)


def phase_massive_async(torch, smi):
    """The massive-cohort path on the card: the bench's uncut massive
    cohort (sync and async), the experiment mains with ``--async_agg
    1``, the full-width StackOverflow LSTM through the async bucketed
    rounds with its card-vs-CPU step, and streamed augmentation on
    ResNet-56. Prints what each run measured beside the
    card's name and power limit."""
    from fedml_tpu_torch import bench

    t0 = time.time()
    _massive_runs(bench, smi)
    _async_mains(smi)
    _stackoverflow_runs(torch, smi)
    aug, rec = _augmented_round(torch, True)
    plain, plain_rec = _augmented_round(torch, False)
    bucket = {k: v for k, v in rec.items() if k.startswith("bucket/")}
    diff = max(float((aug.global_state["params"][k]
                      - plain.global_state["params"][k]).abs().max())
               for k in aug.global_state["params"])
    if not (math.isfinite(rec["Train/Loss"]) and bucket
            and aug.bucket_runner is not None and diff > 0.0):
        fail(f"streamed augmentation: loss {rec['Train/Loss']}, bucket "
             f"{bucket}, augmented vs plain param diff {diff}")
    print(f"massive_async run=resnet56_streamed_augment "
          f"s_per_round={rec['round_time_s']} "
          f"plain_s_per_round={plain_rec['round_time_s']} "
          f"train_loss={rec['Train/Loss']} "
          f"plain_train_loss={plain_rec['Train/Loss']} "
          f"augment_vs_plain_param_diff={diff} {json.dumps(bucket)} "
          f"card={smi}", flush=True)
    print(f"massive_async phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)


#: the compressed LM runs: the full-width TransformerLM of EXP_LM with a
#: compressor, host-packed (residency is bypassed) and through streaming
#: error feedback on the bucketed path, synchronous and async
EXP_COMP_HOST = [("main_fedavg", ["--compressor", "topk:0.01"]),
                 ("main_fedopt", ["--compressor", "qsgd:8"])]
EXP_COMP_STREAM = [("sync", ["--bucket_edges", "geometric",
                             "--client_chunk", "4",
                             "--compressor", "signsgd"]),
                   ("async", ["--async_agg", "1", "--buffer_k", "8",
                              "--client_chunk", "4",
                              "--compressor", "signsgd"])]
#: one compressed round (topk 1%) of a small fp32 LM, card against CPU
#: from the same weights and data: every global parameter and residual
#: within this (absolute); fp32 sums in another order move a delta by an
#: ulp, and a kept coordinate can trade places with its neighbour in
#: magnitude only where two magnitudes sit within that ulp
COMP_ROUND_TOL = 1e-4
#: the sweep's specs on ResNet-56: each family, the sparse ones at 1%
COMP_SWEEP = "none,topk:0.01,randk:0.01,qsgd:8,signsgd"


def _small_lm_api(torch, device, compressor):
    """A small fp32 TransformerLM (d_model 128, 2 heads of 64, 2 layers,
    T 20) on 4 synthetic-sequence clients, host-packed, SGD lr 0.1."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.data.synthetic import load_synthetic_sequences
    from fedml_tpu_torch.models.transformer import TransformerLM

    dataset = load_synthetic_sequences(client_num=4, n_train=64, n_test=16,
                                       seq_len=20, vocab_size=90, seed=0)
    model = TransformerLM(90, n_layers=2, n_heads=2, d_model=128, max_len=20)
    args = types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=1,
        epochs=1, batch_size=4, lr=0.1, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=10 ** 9, seed=0, device_resident="0",
        compressor=compressor)
    return FedAvgAPI(dataset, make_seq_classification_spec(model), args,
                     device=device)


def _wire_check(torch, api, label):
    """The record's ``bytes_on_wire`` and ``compression_ratio`` against
    the port's count on the CPU for the same template; the residual store
    dense on the card with non-zero rows for the cohort."""
    from fedml_tpu_torch.compression.integration import (
        compressed_payload_nbytes, raw_payload_nbytes)
    from fedml_tpu_torch.utils.torch_import import reference_tree

    rec = api.history[-1]
    tmpl = reference_tree({k: v.cpu() for k, v in
                           api.global_state["params"].items()})
    n = rec.get("bucket/clients", api.args.client_num_per_round)
    wire = compressed_payload_nbytes(api.compressor, tmpl) * n
    ratio = round(raw_payload_nbytes(tmpl) * n / wire, 3)
    store = api._ef_store
    live = sum(1 for c in range(len(api.train_data_local_dict))
               if any(float(v.abs().max()) > 0
                      for v in store.peek(c).values()))
    if (rec["bytes_on_wire"], rec["compression_ratio"]) != (wire, ratio):
        fail(f"compression {label}: bytes_on_wire/compression_ratio "
             f"{rec['bytes_on_wire']}/{rec['compression_ratio']}, the CPU "
             f"count {wire}/{ratio}")
    if not (store.dense and store.device.type == "cuda" and live == n):
        fail(f"compression {label}: residual store dense={store.dense} on "
             f"{store.device}, {live} live rows for {n} clients")
    return {"bytes_on_wire": wire, "compression_ratio": ratio,
            "store": f"dense/{store.device.type}", "live_rows": live}


def _compressed_lm_runs(torch, fa, smi):
    """The full-width LM through both lowerings with a compressor, the
    attention counters set to 0 just before each run and read just
    after."""
    out = {}
    runs = ([(f"host_{main[5:]}", main, argv) for main, argv in EXP_COMP_HOST]
            + [(f"stream_{label}", "main_fedavg", argv)
               for label, argv in EXP_COMP_STREAM])
    for label, main, argv in runs:
        for name in fa.launches:
            fa.launches[name] = 0
        api, times = _experiment(EXP_LM + argv, main)
        launches = dict(fa.launches)
        layers = sum(1 for k in api.global_state["params"]
                     if k.endswith(".qkv.weight"))
        host = label.startswith("host")
        if (host != (api.compressed_round_fn is not None)
                or host == (api.bucket_runner is not None)):
            fail(f"compression {label}: ran the wrong lowering")
        if not (launches["dq"] == launches["dkv"] > 0
                and launches["dq"] % layers == 0
                and launches["fwd"] >= launches["dq"]):
            fail(f"compression {label}: attention launches {launches}")
        wire = _wire_check(torch, api, label)
        extra = {k: v for k, v in api.history[-1].items()
                 if k.startswith("async/flushes")}
        print(f"compression run=lm_{label} s_per_round={times} "
              f"train_loss={[r['Train/Loss'] for r in api.history]} "
              f"launches={json.dumps(launches)} {json.dumps(wire)} "
              f"{json.dumps(extra)} card={smi}", flush=True)
        out[label] = launches
    return out


def _massive_compressed(bench, smi):
    for label, extra in (("sync", []), ("async", ["--massive_async", "1"])):
        rec = bench.main(["--massive_cohort", "--compressor", "topk:0.1",
                          "--rounds", "2", "--ledger", ""] + extra)
        if "error" in rec:
            fail(f"compression massive {label}: {rec['error']}")
        if not (rec["value"] > 0 and math.isfinite(rec["train_loss"])
                and rec["compression_ratio"] > 1
                and rec["residual_store"] == "dense"):
            fail(f"compression massive {label}: {rec}")
        keys = ("value", "round_s", "round_times_s", "bytes_on_wire",
                "compression_ratio", "residual_store", "chunks",
                "train_loss", "peak_memory_gb", "phase_totals_s")
        print(f"compression run=massive_{label}_topk "
              + json.dumps({k: rec[k] for k in keys})
              + f" card={smi}", flush=True)


def _same_tree_compress(torch, spec, tree_cpu, seeds, draws=None):
    """One compression of the same tree on the card and on the CPU."""
    from fedml_tpu_torch.compression.compressors import get_compressor
    comp = get_compressor(spec)
    cuda = lambda t: {k: v.cuda() for k, v in t.items()}
    return (comp.compress(cuda(tree_cpu), seeds,
                          None if draws is None else cuda(draws)),
            comp.compress(tree_cpu, seeds, draws))


def _card_vs_cpu(torch, smi):
    """One compressed round of the small fp32 LM, card against CPU; topk
    and qsgd (with the draws handed in) on the same deltas on both; the
    ``none`` round against the plain round on the card, bit for bit under
    deterministic kernels."""
    import numpy as np

    cpu = _small_lm_api(torch, "cpu", "topk:0.01")
    card = _small_lm_api(torch, "cuda", "topk:0.01")
    card.global_state = {"params": {k: v.cuda() for k, v in
                                    cpu.global_state["params"].items()}}
    cpu.train_one_round()
    card.train_one_round()
    diff = max(float((card.global_state["params"][k].cpu() - v).abs().max())
               for k, v in cpu.global_state["params"].items())
    rdiff = max(float((card._ef_store.peek(c)[k] - v).abs().max())
                for c in range(4) for k, v in cpu._ef_store.peek(c).items())
    rng = np.random.default_rng(0)
    deltas = {k: torch.from_numpy(rng.standard_normal(
        (4,) + tuple(v.shape)).astype(np.float32))
        for k, v in cpu.global_state["params"].items()}
    seeds = np.arange(4)
    got, want = _same_tree_compress(torch, "topk:0.01", deltas, seeds)
    index_sets_equal = all(
        set(got[k]["indices"][c].tolist())
        == set(want[k]["indices"][c].tolist())
        and torch.equal(got[k]["values"][c].cpu().sort().values,
                        want[k]["values"][c].sort().values)
        for k in deltas for c in range(4))
    from fedml_tpu_torch.compression.compressors import get_compressor
    draws = get_compressor("qsgd:8").draws(deltas, seeds)
    got, want = _same_tree_compress(torch, "qsgd:8", deltas, seeds, draws)
    qsgd_equal = all(torch.equal(got[k][f].cpu(), want[k][f])
                     for k in deltas for f in ("q", "scale"))
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        none = _small_lm_api(torch, "cuda", "none")
        plain = _small_lm_api(torch, "cuda", None)
        none.train_one_round()
        plain.train_one_round()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    none_diff = max(float((none.global_state["params"][k] - v).abs().max())
                    for k, v in plain.global_state["params"].items())
    out = {"round_param_diff": diff, "round_residual_diff": rdiff,
           "tol": COMP_ROUND_TOL, "topk_index_sets_equal": index_sets_equal,
           "qsgd_codes_equal": qsgd_equal, "none_vs_plain_diff": none_diff}
    print(f"compression step=card_vs_cpu_lm_fp32 {json.dumps(out)} "
          f"card={smi}", flush=True)
    if not (diff <= COMP_ROUND_TOL and rdiff <= COMP_ROUND_TOL
            and index_sets_equal and qsgd_equal and none_diff == 0.0):
        fail(f"compression card vs CPU: {out}")


def _sweep_and_check(bench, smi):
    """The bench's sweep on ResNet-56 and its size gate on the card; the
    encoded bytes against the port's count on the CPU."""
    from fedml_tpu_torch.compression.compressors import get_compressor
    from fedml_tpu_torch.compression.integration import (
        compressed_payload_nbytes)
    from fedml_tpu_torch.utils.torch_import import reference_tree

    rec = bench.main(["--compression_sweep", "--compressors", COMP_SWEEP,
                      "--sweep_model", "resnet56", "--ledger", ""])
    if "error" in rec:
        fail(f"compression sweep: {rec['error']}")
    import torch
    tmpl = reference_tree(bench._sweep_state("resnet56", torch.device(
        "cpu"))["params"])
    for row in rec["rows"]:
        want = compressed_payload_nbytes(get_compressor(row["compressor"]),
                                         tmpl)
        if row["encoded_bytes"] != want:
            fail(f"compression sweep {row['compressor']}: "
                 f"{row['encoded_bytes']} bytes on the card, {want} on the "
                 "CPU")
        print(f"compression sweep=resnet56 {json.dumps(row)} card={smi}",
              flush=True)
    check = bench.main(["--check", "--ledger", ""])
    if check.get("pass") is not True:
        fail(f"compression --check: {check}")
    print(f"compression check {json.dumps(check)} card={smi}", flush=True)


def phase_compression(torch, fa, smi):
    """Client-update compression on the card: the full-width LM
    host-packed (``main_fedavg --compressor topk:0.01``, ``main_fedopt
    --compressor qsgd:8``) and through streaming error feedback (sync and
    async, ``signsgd``), each with the attention counters checked, its
    ``bytes_on_wire`` and ``compression_ratio`` equal to the CPU's count
    and its residual store dense on the card; the massive cohort with
    ``topk:0.1`` (sync and async); a small fp32 LM round card against CPU
    within ``COMP_ROUND_TOL`` with topk's index sets and qsgd's codes
    equal on the same inputs and the ``none`` round bit-equal to the
    plain one; the bench's sweep on ResNet-56 and its ``--check``. Every
    line names the card and its power limit."""
    from fedml_tpu_torch import bench

    t0 = time.time()
    launches = _compressed_lm_runs(torch, fa, smi)
    _massive_compressed(bench, smi)
    _card_vs_cpu(torch, smi)
    _sweep_and_check(bench, smi)
    print(f"compression phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)
    return launches


#: the control-plane phase: a server and 4 client threads over TCP on
#: localhost, each client training the LM flagship on the card
CP_WORLD, CP_ROUNDS = 5, 2
#: run (b)'s fault plan: rank 2 killed at its round-0 report and re-dialed
#: CP_REJOIN_S into the run; rank 4's round-0 report stalled CP_STALL_S, so
#: rank 2 is never round 0's last report and round 0 closes at its
#: CP_DEADLINE_S deadline, after the rejoin: round 1 has rank 2 back
CP_REJOIN_S, CP_STALL_S, CP_DEADLINE_S = 12.0, 4.0, 24.0


def _cp_lm(torch):
    """The LM flagship's spec (``bench.py --lm``: d_model 512, 4 layers, 4
    heads of 128, T 80, vocab 90, bf16 compute), its initial weights as
    fp32 numpy (seed 0), and ranks 1-4's LEAF-shaped synthetic shards."""
    from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
    from fedml_tpu_torch.data.shakespeare import (
        SEQUENCE_LENGTH, VOCAB_SIZE, synthetic_shakespeare_clients)
    from fedml_tpu_torch.models.transformer import TransformerLM

    T, V = SEQUENCE_LENGTH, VOCAB_SIZE
    model = TransformerLM(vocab_size=V, n_layers=LM_LAYERS,
                          n_heads=LM_D // 128, d_model=LM_D, max_len=T,
                          dtype=torch.bfloat16)
    spec = make_seq_classification_spec(model, name="lm")
    init = {k: v.numpy() for k, v in spec.init_fn(0, "cpu")["params"]
            .items()}
    local = synthetic_shakespeare_clients(LM_CLIENTS, T, V)[5]
    shards = {r: local[r - 1] for r in range(1, CP_WORLD)}
    return spec, init, shards


def _cp_trainer(torch, spec, shards, dev):
    """``trainer(params, round_idx, rank) -> (params, n)`` for the TCP
    drivers, built from the port's public pieces: one client's LM update
    (``make_client_update``, AMSGrad lr 3e-4, batch 4, 1 epoch) on
    ``dev`` from the numpy params the SYNC carried, its batches shuffled
    from a generator keyed (round, rank) so a replay is the same work;
    fp32 numpy back."""
    import numpy as np

    from fedml_tpu_torch.parallel.engine import (ClientUpdateConfig,
                                                 make_client_update)
    from fedml_tpu_torch.parallel.packing import pack_cohort

    update = make_client_update(spec, ClientUpdateConfig(optimizer="adam",
                                                         lr=3e-4))

    def train(params, round_idx, rank):
        packed = pack_cohort([shards[rank]], LM_BATCH, 1, step_bucket=1,
                             native=False,
                             rng=np.random.default_rng((round_idx, rank)))
        data = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
        data["y"] = data["y"].long()
        state = {"params": {k: torch.from_numpy(np.array(v, np.float32))
                            .to(dev) for k, v in params.items()}}
        local, aux, _ = update(state, data, np.array([rank], np.int64))
        return ({k: v[0].float().cpu().numpy()
                 for k, v in local["params"].items()},
                float(aux["n"][0]))

    return train


def _cp_expected_launches(shards, calls):
    """Each of B2-B4 once a layer a step: ``calls`` maps a rank to its
    trainer calls; a call runs ceil(n / batch) steps."""
    return LM_LAYERS * sum(
        calls[r] * -(-len(shards[r]["y"]) // LM_BATCH) for r in calls)


def _cp_counted(fa, label, run, expect):
    """``run()`` with the attention counters set to 0 just before and read
    just after; each must equal ``expect``."""
    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.time()
    out = run()
    secs = time.time() - t0
    launches = dict(fa.launches)
    if launches != {"fwd": expect, "dq": expect, "dkv": expect}:
        fail(f"{label}: attention launches {launches}, expected "
             f"{expect} each")
    return out, secs, launches


def _cp_same(label, got, want):
    import numpy as np

    for a, b in zip(got, want):
        for k in b:
            if not np.array_equal(a[k], b[k]):
                fail(f"{label}: {k} differs, max "
                     f"{float(np.abs(a[k] - b[k]).max())}")


def phase_control_plane(torch, fa, smi):
    """The threaded control plane on the card (module docstring, 11):
    ``run_tcp_fedavg`` with 4 client threads training the LM flagship
    through B2-B4, its history held against a socket-free replay and its
    wire bytes against the codec's count; the faulted, compressed run
    with a rejoin held against the same plan on the CPU; and
    ``run_async_tcp_fedavg`` for 2 flushes. Launches are counted exactly
    per run; every line names the card and its power limit. Returns the
    LM's spec, weights, shards and trainer with (a)'s replay and report
    bytes, which the event-loop phase is held against."""
    import threading

    import numpy as np

    from fedml_tpu_torch.compression.codec import tree_wire_nbytes
    from fedml_tpu_torch.program.cohort import CohortPolicy
    from fedml_tpu_torch.program.aggregation import AggregationPolicy
    from fedml_tpu_torch.program.round import RoundProgram
    from fedml_tpu_torch.resilience import (FaultPlan, FaultRule,
                                            quadratic_trainer,
                                            run_async_tcp_fedavg,
                                            run_tcp_fedavg)

    t0 = time.time()
    spec, init, shards = _cp_lm(torch)
    train = _cp_trainer(torch, spec, shards, torch.device("cuda", 0))
    every = {r: CP_ROUNDS for r in shards}
    expect = _cp_expected_launches(shards, every)
    drive = dict(timeout=600.0, join_timeout=900.0)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        # (a) the plain run and its socket-free replay
        policy = CohortPolicy(deadline_s=600.0, quorum=0.5)
        srv, secs, launches = _cp_counted(
            fa, "control_plane tcp", lambda: run_tcp_fedavg(
                CP_WORLD, CP_ROUNDS, policy, init, trainer=train, **drive),
            expect)
        if srv.failed is not None or srv.reporting_log != [
                list(shards)] * CP_ROUNDS:
            fail(f"control_plane tcp: failed={srv.failed} reporting "
                 f"{srv.reporting_log}")
        host = RoundProgram(cohort=policy).host_view()
        params, replay, report_bytes = init, [], 0
        for r in range(CP_ROUNDS):
            reports = {}
            for rank in sorted(shards):
                p, n = train(params, r, rank)
                reports[rank] = (n, p)
                report_bytes += tree_wire_nbytes({
                    "msg_type": "res_report", "sender": rank,
                    "receiver": 0, "params": p, "num_samples": n,
                    "round": r, "attempt": 0})
            params, _ = host.fold_reports(reports, base=params)
            replay.append(params)
        _cp_same("control_plane tcp vs replay", srv.history, replay)
        got_bytes = srv.com_manager.bytes_received
        if got_bytes != report_bytes:
            fail(f"control_plane tcp: {got_bytes} report bytes received, "
                 f"the codec counts {report_bytes}")
        per_report = report_bytes // (CP_ROUNDS * len(shards))
        print(f"control_plane run=tcp rounds={CP_ROUNDS} clients="
              f"{len(shards)} s={secs:.3f} s_per_round="
              f"{secs / CP_ROUNDS:.3f} report_bytes={per_report} "
              f"bytes_received={got_bytes} bytes_sent="
              f"{srv.com_manager.bytes_sent} launches={json.dumps(launches)}"
              f" replay=bit-equal card={smi}", flush=True)

        # (b) topk, rank 2 killed in round 0 and re-dialed; the same plan
        # with quadratic_trainer on the CPU, alongside, predicts its
        # counters and reporting log
        def plan():
            return FaultPlan(seed=0, rules=(
                FaultRule("kill", rank=2, msg_type="res_report", nth=1),
                FaultRule("stall", rank=4, msg_type="res_report", nth=1,
                          delay_s=CP_STALL_S)))
        faulted = dict(fault_plan=plan(), late_clients=[(2, CP_REJOIN_S)],
                       compressor="topk:0.01", **drive)
        fpolicy = CohortPolicy(deadline_s=CP_DEADLINE_S, quorum=0.5)
        pred = {}
        cpu = threading.Thread(target=lambda: pred.update(srv=run_tcp_fedavg(
            CP_WORLD, CP_ROUNDS, fpolicy,
            {k: np.zeros(4, np.float32) for k in ("w", "b")},
            trainer=quadratic_trainer(), **dict(faulted, fault_plan=plan()))))
        cpu.start()
        fsrv, secs, launches = _cp_counted(
            fa, "control_plane tcp_faulted", lambda: run_tcp_fedavg(
                CP_WORLD, CP_ROUNDS, fpolicy, init, trainer=train,
                **faulted), expect)
        cpu.join()
        keys = ("rounds_degraded", "rounds_abandoned", "clients_dropped",
                "clients_rejoined", "clients_resumed")
        got = {k: fsrv.counters[k] for k in keys}
        want = {k: pred["srv"].counters[k] for k in keys}
        if (fsrv.failed is not None or got != want
                or fsrv.reporting_log != pred["srv"].reporting_log):
            fail(f"control_plane tcp_faulted: failed={fsrv.failed} "
                 f"counters {got} reporting {fsrv.reporting_log}; the CPU "
                 f"predicts {want} {pred['srv'].reporting_log}")
        for h in fsrv.history:
            if not all(np.isfinite(v).all() for v in h.values()):
                fail("control_plane tcp_faulted: non-finite parameters")
        print(f"control_plane run=tcp_faulted compressor=topk:0.01 s="
              f"{secs:.3f} counters={json.dumps(got)} reporting="
              f"{fsrv.reporting_log} bytes_received="
              f"{fsrv.com_manager.bytes_received} launches="
              f"{json.dumps(launches)} cpu_prediction=held card={smi}",
              flush=True)

        # (c) buffered async: K 4 of 4 clients, 2 flushes (8 reports)
        asrv, secs, launches = _cp_counted(
            fa, "control_plane async", lambda: run_async_tcp_fedavg(
                CP_WORLD, 2, AggregationPolicy(buffer_k=4),
                init, trainer=train, **drive), expect)
        if (asrv.failed is not None or len(asrv.history) != 2
                or asrv.agg.counters["flushes"] != 2
                or asrv.counters["reports"] != 8):
            fail(f"control_plane async: failed={asrv.failed} flushes "
                 f"{asrv.agg.counters} reports {asrv.counters}")
        print(f"control_plane run=async buffer_k=4 flushes="
              f"{asrv.agg.counters['flushes']} flush_log={asrv.flush_log} "
              f"{json.dumps(asrv.agg.record())} s={secs:.3f} s_per_flush="
              f"{secs / 2:.3f} bytes_received="
              f"{asrv.com_manager.bytes_received} launches="
              f"{json.dumps(launches)} card={smi}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    print(f"control_plane phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)
    return types.SimpleNamespace(init=init, shards=shards, train=train,
                                 replay=replay, report_bytes=report_bytes)


#: the event-loop phase: the soak's connections and report floats (the
#: bench's defaults) and the tree soak's leaves over 2 edge processes
EL_SOAK, EL_SOAK_PARAMS, EL_TREE, EL_TREE_FANOUT = 1000, 16384, 1000, 2


def _el_bench(bench, label, argv):
    """One in-process run of the port's bench; fails on an error record.
    Its figures are the host transport's on this machine."""
    rec = bench.main(argv + ["--ledger", ""])
    if "error" in rec:
        fail(f"eventloop {label}: {rec['error']}")
    return rec


def phase_eventloop(torch, fa, smi, cp):
    """The event-loop control plane on the card (module docstring, 12):
    (a) ``run_tcp_fedavg`` over the selector transport with 2 decode
    workers, bit-equal to the control-plane phase's socket-free replay
    ``cp``; (b) ``run_async_tcp_fedavg`` over it for 2 flushes; (c)
    ``run_fanin_fedavg`` with 2 edges of 2 leaves each, bit-equal to the
    two-tier host replay; the 4 LM trainers launch B2-B4 136 times in
    each, counted exactly. (d) the bench's ``--soak`` and
    ``--tree_soak`` on the host: status files final and parseable on one
    program core, no zombie, reports/s, bytes a report, latency and
    decode seconds a report. Every line names the card and its power
    limit."""
    import numpy as np

    from fedml_tpu_torch import bench
    from fedml_tpu_torch.net.fanin import (round_robin_groups,
                                           run_fanin_fedavg)
    from fedml_tpu_torch.program.aggregation import AggregationPolicy
    from fedml_tpu_torch.program.cohort import CohortPolicy
    from fedml_tpu_torch.resilience import (aggregate_reports,
                                            run_async_tcp_fedavg,
                                            run_tcp_fedavg)

    t0 = time.time()
    shards, train = cp.shards, cp.train
    expect = _cp_expected_launches(shards, {r: CP_ROUNDS for r in shards})
    drive = dict(transport="eventloop", timeout=600.0, join_timeout=900.0)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        # (a) the sync server over the event loop, 2 decode workers
        policy = CohortPolicy(deadline_s=600.0, quorum=0.5)
        srv, secs, launches = _cp_counted(
            fa, "eventloop sync", lambda: run_tcp_fedavg(
                CP_WORLD, CP_ROUNDS, policy, cp.init, trainer=train,
                decode_workers=2, **drive), expect)
        if srv.failed is not None or srv.reporting_log != [
                list(shards)] * CP_ROUNDS:
            fail(f"eventloop sync: failed={srv.failed} reporting "
                 f"{srv.reporting_log}")
        _cp_same("eventloop sync vs replay", srv.history, cp.replay)
        comm = srv.com_manager
        ingest = comm.ingest_stats()
        if comm.bytes_received != cp.report_bytes or ingest["frames"] < 8:
            fail(f"eventloop sync: {comm.bytes_received} report bytes "
                 f"received (the codec counts {cp.report_bytes}), ingest "
                 f"{ingest}")
        print(f"eventloop run=sync rounds={CP_ROUNDS} clients="
              f"{len(shards)} decode_workers={ingest['workers']} s="
              f"{secs:.3f} s_per_round={secs / CP_ROUNDS:.3f} "
              f"bytes_received={comm.bytes_received} bytes_sent="
              f"{comm.bytes_sent} ingest={json.dumps(ingest)} launches="
              f"{json.dumps(launches)} replay=bit-equal card={smi}",
              flush=True)

        # (b) buffered async over the event loop: K 4 of 4, 2 flushes
        asrv, secs, launches = _cp_counted(
            fa, "eventloop async", lambda: run_async_tcp_fedavg(
                CP_WORLD, 2, AggregationPolicy(buffer_k=4), cp.init,
                trainer=train, **drive), expect)
        if (asrv.failed is not None or asrv.flush_log != [
                tuple(shards)] * 2
                or asrv.agg.counters["max_staleness"] != 0):
            fail(f"eventloop async: failed={asrv.failed} flush_log "
                 f"{asrv.flush_log} {asrv.agg.counters}")
        print(f"eventloop run=async buffer_k=4 flush_log={asrv.flush_log} "
              f"max_staleness={asrv.agg.counters['max_staleness']} s="
              f"{secs:.3f} s_per_flush={secs / 2:.3f} bytes_received="
              f"{asrv.com_manager.bytes_received} launches="
              f"{json.dumps(launches)} card={smi}", flush=True)

        # (c) fan-in: 2 edges of 2 leaves; the leaves' global ids
        # round-robin over ranks 1-4, so they train the same shards
        groups = round_robin_groups(range(1, CP_WORLD), 2)
        (fsrv, edges), secs, launches = _cp_counted(
            fa, "eventloop fanin", lambda: run_fanin_fedavg(
                2, 2, CP_ROUNDS,
                AggregationPolicy(buffer_k=10 ** 9, staleness_decay=0.0),
                cp.init, trainer=train, **drive), expect)
        params, replay = cp.init, []
        for r in range(CP_ROUNDS):
            edge_reports = {}
            for e, gids in enumerate(groups, start=1):
                leaf = {}
                for local, gid in enumerate(gids, start=1):
                    p, n = train(params, r, gid)
                    leaf[local] = (n, p)
                ep, et = aggregate_reports(leaf)
                edge_reports[e] = (et, ep)
            params, _ = aggregate_reports(edge_reports)
            replay.append(params)
        forwarded = [e.rounds_forwarded for e in edges]
        if fsrv.failed is not None or forwarded != [CP_ROUNDS] * 2:
            fail(f"eventloop fanin: failed={fsrv.failed} forwarded "
                 f"{forwarded}")
        _cp_same("eventloop fanin vs two-tier replay", fsrv.history,
                 replay)
        print(f"eventloop run=fanin edges=2 leaves_per_edge=2 groups="
              f"{groups} rounds_forwarded={forwarded} s={secs:.3f} "
              f"s_per_round={secs / CP_ROUNDS:.3f} coordinator_bytes="
              f"{fsrv.com_manager.bytes_received} launches="
              f"{json.dumps(launches)} replay=bit-equal card={smi}",
              flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False

    # (d) the soaks: host-only; their figures are the transport's on
    # this machine's CPU, not the card's
    rec = _el_bench(bench, "soak", [
        "--soak", str(EL_SOAK), "--soak_params", str(EL_SOAK_PARAMS),
        "--soak_updates", "3"])
    if (rec["status_outcome"] != "complete"
            or rec["reports"] != 3 * EL_SOAK or rec["sheds"]):
        fail(f"eventloop soak: {rec}")
    print(f"eventloop run=soak connections={rec['connections']} reports="
          f"{rec['reports']} reports_per_s={rec['value']} "
          f"bytes_per_report={rec['measured_bytes_per_report']} "
          f"latency_p50_s={rec['report_latency_p50_s']} latency_p99_s="
          f"{rec['report_latency_p99_s']} decode_s_per_report="
          f"{rec['decode_s_per_report']} wall_s={rec['wall_s']} "
          f"status_final=true host_transport card={smi}", flush=True)
    rec = _el_bench(bench, "tree_soak", [
        "--tree_soak", str(EL_TREE), "--tree_fanout", str(EL_TREE_FANOUT)])
    if (rec["zombies"] or rec["killed"] or not rec["program_cores_match"]
            or rec["statuses"] != 1 + EL_TREE_FANOUT):
        fail(f"eventloop tree_soak: {rec}")
    print(f"eventloop run=tree_soak leaves={rec['leaves']} fanout="
          f"{rec['fanout']} reports={rec['reports']} reports_per_s="
          f"{rec['value']} statuses={rec['statuses']} (final, one program "
          f"core) zombies={rec['zombies']} killed={rec['killed']} "
          f"wall_s={rec['wall_s']} host_transport card={smi}", flush=True)
    print(f"eventloop phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)


#: the zoo phase: the published recipes through ``main_fedavg`` on files
#: the port's ``prepare`` wrote (MNIST + LR: 1,000 LEAF clients, 10 a
#: round, batch 10, SGD lr 0.03; CIFAR-10 + MobileNet cross-silo: 10
#: clients, LDA alpha 0.5, batch 64, SGD lr 0.001 wd 0.001, cut to 1
#: epoch and 1 round)
ZOO_MNIST = ["--dataset", "mnist", "--model", "lr",
             "--client_num_in_total", "1000", "--client_num_per_round", "10",
             "--batch_size", "10", "--lr", "0.03", "--comm_round", "2"]
ZOO_MOBILENET = ["--dataset", "cifar10", "--model", "mobilenet",
                 "--client_num_in_total", "10", "--client_num_per_round",
                 "10", "--partition_method", "hetero", "--partition_alpha",
                 "0.5", "--batch_size", "64", "--lr", "0.001", "--wd",
                 "0.001", "--epochs", "1", "--comm_round", "1"]
#: the fed CIFAR-100 recipe (500 clients of 100 images, 10 a round,
#: batch 20, SGD lr 0.1, ResNet-18 with GroupNorm 32)
FC100_CLIENTS, FC100_PER_CLIENT, FC100_PER_ROUND, FC100_BATCH = 500, 100, 10, 20
#: one fp32 training step a family, card (cuDNN, deterministic, no TF32)
#: against CPU from the same weights and dropout masks: logits within
#: 1e-3 * max|logit| + 1e-4, loss 1e-4 absolute, each new BatchNorm
#: statistic within 1e-3 of the model's largest + 1e-6. Each fp32 step
#: records the side each ReLU input takes and each max pool's argmax;
#: card and CPU may differ there (``tie_flips``) only where the float64
#: input ties: the flipped ReLU input, or the gap between the two argmax
#: candidates, within ``tie`` of the call's largest |input|, and at most
#: ``tie_share`` of the recorded elements. A flipped element passes its
#: whole gradient or none, so the gradients are held against the same
#: step in float64 taking that side's decisions (``f64_card``,
#: ``f64_cpu``), tensor by tensor in L2 norms: ``|card_k - f64_card_k| <=
#: grad_rel * |f64_k| + grad_spread * |cpu_k - f64_cpu_k| + grad_floor *
#: |f64|``. The middle term is the spread a correct fp32 step shows at
#: that tensor (BatchNorm's backward over a few elements a channel
#: cancels); the floor covers tensors whose gradient is 0 but for
#: rounding (a bias before BatchNorm). A wrong layout or kernel moves a
#: tensor's gradient by the order of its own norm
ZOO_TOL = {"logits": (1e-3, 1e-4), "loss": 1e-4, "stats": (1e-3, 1e-6),
           "tie": 1e-4, "tie_share": 1e-4, "grad_rel": 1e-3,
           "grad_spread": 4.0, "grad_floor": 1e-6}
#: (label, factory name, classes, image side, factory knobs)
ZOO_STEPS = [("resnet18_gn", "resnet18_gn", 100, 24, {}),
             ("resnet50_gn", "resnet50_gn", 100, 24, {}),
             ("resnet18_bn", "resnet18_gn", 100, 24,
              {"group_norm_channels": 0}),
             ("mobilenet", "mobilenet", 10, 32, {}),
             ("mobilenet_v3_large", "mobilenet_v3", 10, 32,
              {"model_mode": "LARGE"}),
             ("mobilenet_v3_small", "mobilenet_v3", 10, 32,
              {"model_mode": "SMALL"}),
             ("efficientnet_b0", "efficientnet-b0", 10, 32, {}),
             ("vgg16", "vgg16", 10, 32, {}),
             ("vgg16_bn", "vgg16", 10, 32, {"vgg_bn": True})]
ZOO_STEP_BATCH = 8


def fed_cifar100_population(clients, per_client, seed=0):
    """A fed CIFAR-100-shaped population in memory: ``clients`` x
    ``per_client`` uint8 32x32x3 images and labels 0-99 from ``seed``,
    each client's images through the port's loader map
    (``tff_h5.fed_cifar100_map``: 1/255, centre crop to 24x24,
    normalised); the 8-tuple, with the first 20 clients' images as the
    test set."""
    import numpy as np

    from fedml_tpu_torch.data.tff_h5 import fed_cifar100_map

    rng = np.random.default_rng(seed)
    local, num = {}, {}
    for c in range(clients):
        x = rng.integers(0, 256, (per_client, 32, 32, 3), np.uint8)
        local[c] = {"x": fed_cifar100_map(x.astype(np.float32)),
                    "y": rng.integers(0, 100, per_client).astype(np.int64)}
        num[c] = per_client
    test = {k: np.concatenate([local[c][k] for c in range(20)])
            for k in ("x", "y")}
    n = clients * per_client
    return [n, len(test["y"]), None, test, num, local, {0: test}, 100]


def _zoo_files(smi):
    """(a): ``prepare fixture`` writes a 1,000-client LEAF MNIST and a
    10-client CIFAR-10 tree, and ``main_fedavg`` trains the MNIST + LR
    and the cross-silo MobileNet recipes on them."""
    import shutil

    from fedml_tpu_torch.data import prepare

    root = os.path.join(HERE, "build", "chip_smoke_zoo")
    shutil.rmtree(root, ignore_errors=True)
    runs = (("mnist_lr", "leaf_mnist", "1000", ZOO_MNIST),
            ("cifar10_mobilenet", "cifar10", "10", ZOO_MOBILENET))
    for label, fixture, clients, argv in runs:
        d = os.path.join(root, fixture)
        t0 = time.time()
        if prepare.main(["fixture", fixture, "--data_dir", d,
                         "--clients", clients]) != 0:
            fail(f"zoo: prepare fixture {fixture} did not verify")
        fixture_s = time.time() - t0
        api, times = _experiment(argv + ["--data_dir", d])
        n = sum(v.numel() for v in api.global_state["params"].values())
        print(f"zoo run={label} fixture_s={fixture_s:.1f} params={n} "
              f"clients={len(api.train_data_local_num_dict)} "
              f"train_samples={api.train_data_num} "
              f"s_per_round={times} "
              f"train_loss={[r['Train/Loss'] for r in api.history]} "
              f"test_loss={api.history[-1].get('Test/Loss')} card={smi}",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)


def _zoo_fed_cifar100(torch, smi):
    """(b): ResNet-18 with GroupNorm 32 through the waves on the fed
    CIFAR-100 population, 2 rounds."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.models import resnet18_gn

    t0 = time.time()
    dataset = fed_cifar100_population(FC100_CLIENTS, FC100_PER_CLIENT)
    data_s = time.time() - t0
    nbytes = sum(d["x"].nbytes for d in dataset[5].values())
    args = types.SimpleNamespace(
        client_num_in_total=FC100_CLIENTS,
        client_num_per_round=FC100_PER_ROUND, comm_round=2, epochs=1,
        batch_size=FC100_BATCH, lr=0.1, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=10 ** 9, seed=0, wave_mode=1,
        client_chunk=FC100_PER_ROUND)
    api = FedAvgAPI(dataset, make_classification_spec(
        resnet18_gn(class_num=100, group_norm=32)), args)
    if api.device.type != "cuda":
        fail(f"zoo fed_cifar100: FedAvgAPI chose {api.device}")
    g0 = {k: v.clone() for k, v in api.global_state["params"].items()}
    records = [api.train_one_round() for _ in range(2)]
    records[-1].update(api.evaluate_global())
    moved = max(float((api.global_state["params"][k] - g0[k]).abs().max())
                for k in g0)
    for r in records:
        if not (math.isfinite(r["Train/Loss"])
                and math.isfinite(r.get("Test/Loss", 0.0))):
            fail(f"zoo fed_cifar100: non-finite loss in {r}")
    if not moved > 0.0 or "batch_stats" in api.global_state:
        fail(f"zoo fed_cifar100: max param change {moved}, state "
             f"{sorted(api.global_state)}")
    n = sum(v.numel() for v in g0.values())
    print(f"zoo run=fed_cifar100_resnet18_gn clients={FC100_CLIENTS} "
          f"per_round={FC100_PER_ROUND} data_mb={nbytes / 1e6:.1f} "
          f"data_s={data_s:.1f} params={n} "
          f"s_per_round={[r['round_time_s'] for r in records]} "
          f"train_loss={[r['Train/Loss'] for r in records]} "
          f"test_loss={records[-1]['Test/Loss']} card={smi}", flush=True)


def zoo_step(torch, model, state, x, y, masks, device, dtype=None):
    """One training step of ``model`` (softmax cross-entropy) on
    ``device`` from ``state`` with the given dropout masks: the loss,
    the logits, the gradients and the new BatchNorm statistics, on
    ``device`` (``state`` is left as it was). ``dtype`` casts the
    parameters, statistics and input (a float64 model's step)."""
    P = {k: v.to(device, dtype).requires_grad_()
         for k, v in state["params"].items()}
    S = {k: v.to(device, dtype).clone()
         for k, v in state["batch_stats"].items()}
    kw = {"train": True}
    if masks is not None:
        kw["dropout_masks"] = {k: v.to(device) for k, v in masks.items()}
    logits = torch.func.functional_call(model, {**P, **S},
                                        (x.to(device, dtype),), kw)
    loss = torch.nn.functional.cross_entropy(logits, y.to(device))
    grads = torch.autograd.grad(loss, list(P.values()))
    return {"loss": loss.detach(), "logits": logits.detach(),
            "grads": dict(zip(P, grads)), "stats": S}


@contextlib.contextmanager
def _float64_model(torch, model):
    """``model`` computing in float64: every layer's compute dtype, and
    the fp32 casts of its heads and norms (``Tensor.float``) kept at
    float64, for as long as the context lasts."""
    was = {m: m.dtype for m in model.modules()
           if getattr(m, "dtype", None) == torch.float32}
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_float(t, *a, **k))
    for m in was:
        m.dtype = torch.float64
    try:
        yield model
    finally:
        del torch.Tensor.float
        for m, dt in was.items():
            m.dtype = dt


@contextlib.contextmanager
def _recording_ties(torch, record):
    """Appends to ``record`` which side each ReLU input takes (``> 0``)
    and each max pool's argmax, in call order, for as long as the context
    lasts: the two places where a gradient jumps at a tie."""
    F = torch.nn.functional
    relu, pool = F.relu, F.max_pool2d

    def relu_rec(x, *a, **k):
        record.append((x.detach() > 0).cpu())
        return relu(x, *a, **k)

    def pool_rec(x, *a, **k):
        out, idx = pool(x, *a, return_indices=True, **k)
        record.append(idx.cpu())
        return out

    F.relu, F.max_pool2d = relu_rec, pool_rec
    try:
        yield record
    finally:
        F.relu, F.max_pool2d = relu, pool


@contextlib.contextmanager
def _replaying_ties(torch, record, other):
    """ReLU and max pool taking the decisions of ``record`` (from
    :func:`_recording_ties`) in call order, for as long as the context
    lasts; yields the largest gap, relative to its call's largest
    |input|, at the elements where ``record`` and ``other`` disagree (a
    flipped ReLU's |input|, or the two argmax candidates' difference)."""
    F = torch.nn.functional
    relu, pool = F.relu, F.max_pool2d
    calls = iter(zip(record, other))
    gap = [0.0]

    def note(diff, x):
        if diff.numel():
            top = float(x.detach().abs().max())
            gap[0] = max(gap[0], float(diff.abs().max()) / max(top, 1e-30))

    def relu_re(x, *a, **k):
        side, alt = next(calls)
        note(x.detach()[side != alt], x)
        return x * side.to(x.device, x.dtype)

    def pool_re(x, *a, **k):
        idx, alt = next(calls)
        flat = x.flatten(2)
        pick = lambda i: flat.gather(2, i.to(x.device).flatten(2)).view(
            i.shape)
        out = pick(idx)
        moved = idx != alt
        note((out - pick(alt)).detach()[moved], x)
        return out

    F.relu, F.max_pool2d = relu_re, pool_re
    try:
        yield gap
    finally:
        F.relu, F.max_pool2d = relu, pool


def _zoo_grad_check(label, card, cpu, f64_card, f64_cpu):
    """Holds the card's gradients tensor by tensor against float64 taking
    the card's tie decisions (``ZOO_TOL``): the worst tensor's share of
    its bound; for the card and the CPU, each against float64 with its
    own decisions, the tensor furthest off in L2 relative to its norm
    (plus the floor) and the whole gradient's relative L2 error; and the
    card's against float64 with the CPU's decisions (what the flips
    move)."""
    l2 = lambda t: float(t.double().norm())
    whole = math.sqrt(sum(l2(g) ** 2 for g in f64_cpu.values()))
    floor = ZOO_TOL["grad_floor"] * whole
    rows = []
    for k, g in f64_card.items():
        n, e_card, e_cpu = l2(g), l2(card[k] - g), l2(cpu[k] - f64_cpu[k])
        bound = ZOO_TOL["grad_rel"] * n + ZOO_TOL["grad_spread"] * e_cpu + floor
        if not math.isfinite(e_card) or e_card > bound:
            fail(f"zoo step {label}: gradient of {k} card vs float64 "
                 f"{e_card} > {bound} (|f64| {n}, CPU fp32 vs float64 "
                 f"{e_cpu})")
        rows.append((e_card / bound, k, e_card / (n + floor),
                     e_cpu / (n + floor)))
    share, name, _, _ = max(rows)
    worst_card = max(rows, key=lambda r: r[2])
    worst_cpu = max(rows, key=lambda r: r[3])
    whole_err = lambda side, ref: math.sqrt(sum(
        l2(side[k] - g) ** 2 for k, g in ref.items())) / whole
    return {"grad_bound_share": share, "grad_bound_tensor": name,
            "grad_worst_card": [worst_card[1], worst_card[2]],
            "grad_worst_cpu": [worst_cpu[1], worst_cpu[3]],
            "grad_l2_card": whole_err(card, f64_card),
            "grad_l2_cpu": whole_err(cpu, f64_cpu),
            "grad_l2_card_cpu_ties": whole_err(card, f64_cpu)}


def _zoo_steps(torch, smi):
    """(c): one fp32 step a family, card against CPU, gradients against
    float64 on the CPU."""
    from fedml_tpu_torch.models.factory import create_model
    from fedml_tpu_torch.models.layers import lecun_init_
    from fedml_tpu_torch.utils.torch_import import module_state

    cuda = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for label, name, classes, side, knobs in ZOO_STEPS:
        args = types.SimpleNamespace(model_dtype=None, **knobs)
        model = create_model(args, name, classes,
                             input_shape=(side, side, 3))
        lecun_init_(model, torch.Generator().manual_seed(1))
        state = module_state(model)
        n = sum(v.numel() for v in state["params"].values())
        x = torch.randn((ZOO_STEP_BATCH, side, side, 3), generator=gen)
        y = torch.randint(0, classes, (ZOO_STEP_BATCH,), generator=gen)
        masks = (model.draw_dropout_masks(ZOO_STEP_BATCH, gen)
                 if hasattr(model, "draw_dropout_masks") else None)
        ties_cpu, ties_card = [], []
        with _recording_ties(torch, ties_cpu):
            cpu = zoo_step(torch, model, state, x, y, masks,
                           torch.device("cpu"))
        with _recording_ties(torch, ties_card):
            card = {k: ({n: t.cpu() for n, t in v.items()}
                        if isinstance(v, dict) else v.cpu())
                    for k, v in zoo_step(torch, model, state, x, y, masks,
                                         cuda).items()}
        flips = sum(int((a != b).sum()) for a, b in zip(ties_cpu, ties_card))
        inputs = sum(t.numel() for t in ties_cpu)
        f64 = {}
        with _float64_model(torch, model):
            for who, ties, alt in (("card", ties_card, ties_cpu),
                                   ("cpu", ties_cpu, ties_card)):
                with _replaying_ties(torch, ties, alt) as gap:
                    f64[who] = zoo_step(torch, model, state, x, y, masks,
                                         torch.device("cpu"), torch.float64)
                f64[who]["gap"] = gap[0]
        tie_gap = max(f64["card"]["gap"], f64["cpu"]["gap"])
        if tie_gap > ZOO_TOL["tie"] or flips > ZOO_TOL["tie_share"] * inputs:
            fail(f"zoo step {label}: {flips} of {inputs} ReLU/max-pool "
                 f"decisions differ card vs CPU, the widest {tie_gap} of "
                 f"its call's largest |input| in float64")
        cpu["loss"], card["loss"] = float(cpu["loss"]), float(card["loss"])
        rel, abs_ = ZOO_TOL["logits"]
        logit_err = _check(f"zoo {label} logits card vs CPU", card["logits"],
                           cpu["logits"], rel, abs_)
        loss_err = abs(card["loss"] - cpu["loss"])
        grads = _zoo_grad_check(label, card["grads"], cpu["grads"],
                                f64["card"]["grads"], f64["cpu"]["grads"])
        stats_err = 0.0
        if cpu["stats"]:
            rel, abs_ = ZOO_TOL["stats"]
            top = max(float(v.abs().max()) for v in cpu["stats"].values())
            stats_err = max(float((card["stats"][k] - v).abs().max())
                            for k, v in cpu["stats"].items())
            if stats_err > rel * top + abs_:
                fail(f"zoo step {label}: BatchNorm statistics card vs CPU "
                     f"{stats_err} > {rel} * {top} + {abs_}")
        out = {"loss": cpu["loss"], "loss_err": loss_err,
               "logit_err": logit_err, "stats_err": stats_err,
               "tie_flips": flips, "tie_inputs": inputs, "tie_gap": tie_gap,
               **grads}
        if loss_err > ZOO_TOL["loss"]:
            fail(f"zoo step {label} card vs CPU past ZOO_TOL: {out}")
        on_card = {part: {k: v.to(cuda) for k, v in state[part].items()}
                   for part in state}
        xs, ys = x.to(cuda), y.to(cuda)
        ms = None if masks is None else {k: v.to(cuda)
                                         for k, v in masks.items()}
        step_ms = _zoo_step_ms(torch, lambda: zoo_step(
            torch, model, on_card, xs, ys, ms, cuda))
        print(f"zoo_step family={label} params={n} "
              f"shape={[ZOO_STEP_BATCH, side, side, 3]} classes={classes} "
              f"step_ms={step_ms} {json.dumps(out)} card={smi}", flush=True)


def _zoo_step_ms(torch, fn, iters=10, warmup=3):
    """Median milliseconds of ``fn`` on the card (CUDA events; the host's
    enqueue time included, as a training step pays it)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[iters // 2]


def phase_zoo(torch, grouped_conv, fa, smi):
    """The CV zoo and the file-backed loaders on the card (module
    docstring, 13), under deterministic kernels: (a) ``main_fedavg`` on
    ``prepare`` fixtures (MNIST + LR, cross-silo CIFAR-10 + MobileNet);
    (b) the fed CIFAR-100 recipe's ResNet-18-GN through the waves; (c)
    one fp32 step of each family against the CPU. The slice launches
    none of B1-B4: their counters are set to 0 just before and must
    read 0 just after."""
    t0 = time.time()
    grouped_conv.launches = 0
    for name in fa.launches:
        fa.launches[name] = 0
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        _zoo_files(smi)
        _zoo_fed_cifar100(torch, smi)
        _zoo_steps(torch, smi)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if grouped_conv.launches or any(fa.launches.values()):
        fail(f"zoo: B1-B4 launched ({grouped_conv.launches}, "
             f"{dict(fa.launches)}); the CV zoo runs none of them")
    print(f"zoo phase_s={time.time() - t0:.1f} card={smi}", flush=True)


#: phase 14 (module docstring): (a) DSGD on the full-width TransformerLM
#: (the factory's d_model 256, 4 layers, 4 heads of 64) in bf16, 8 nodes
#: of synthetic sequences, batch 4, 2 rounds
SL_LM = ["--model", "transformer", "--dataset", "synthetic_sequences",
         "--model_dtype", "bf16", "--client_num_in_total", "8",
         "--client_num_per_round", "8", "--batch_size", "4",
         "--comm_round", "2", "--algorithm", "dsgd"]
#: the same compressed LM main on the CPU, for its ``bytes_on_wire`` and
#: ``compression_ratio``: 1 round over 64 samples (8 a node)
SL_LM_CPU_WIRE = ["--platform", "cpu", "--comm_round", "1",
                  "--n_train", "64"]
#: (b) PushSum on a directed topology over full-width ResNet-56 (fp32),
#: the experiment phase's 8 clients and 4,096 samples, 1 round
SL_PUSHSUM = EXP_RESNET + ["--algorithm", "pushsum", "--asymmetric", "1",
                           "--topology_neighbors", "3"]
#: (c) online gossip on the synthetic stream, 8 nodes, T 200
#: (3 neighbors: uneven degrees, so DSGD's W^T and PushSum's
#: column-stochastic matrix differ)
SL_ONLINE = ["--online", "1", "--client_num_in_total", "8",
             "--stream_length", "200", "--time_varying", "1",
             "--topology_neighbors", "3", "--lr", "0.2"]
#: (d) SplitNN's conv cut on CIFAR-shaped images, 8 clients, batch 64
SL_SPLIT = ["--dataset", "synthetic_images", "--image_size", "32",
            "--client_num_in_total", "8", "--batch_size", "64",
            "--epochs", "1", "--comm_round", "2", "--cut", "conv"]
#: (e) vertical FL, 2 epochs
SL_VFL = ["--epochs", "2"]
#: card against CPU from the same weights: the online and vertical runs'
#: models and records (a few hundred fp32 steps of tiny products), and
#: SplitNN's halves and records (64 steps of cuDNN against oneDNN convs)
SL_TOL = {"online": 1e-5, "vfl": 1e-5, "split": 1e-4}
#: TurboAggregate's fixed-point scale (the default) and cohort
SL_MPC_SCALE, SL_COHORT = 2 ** 16, 8


def _sl_run(main, argv):
    """One run of the port's experiment main ``main``: ``(api, result,
    seconds)``, the seconds up to the card's synchronize."""
    import importlib

    import torch

    module = importlib.import_module(f"fedml_tpu_torch.experiments.{main}")
    t0 = time.time()
    api, result = module.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return api, result, time.time() - t0


def _sl_card(api, label):
    if api.device.type != "cuda":
        fail(f"serverless {label}: ran on {api.device}")


def _sl_finite(torch, tree, label):
    from fedml_tpu_torch.compression.compressors import tree_items

    for path, leaf in tree_items(tree):
        if not bool(torch.isfinite(leaf).all()):
            fail(f"serverless {label}: non-finite {'/'.join(path)}")


def _sl_gap(torch, a, b):
    """Largest absolute difference over two same-structured trees of
    tensors or arrays, on either device (compared on the CPU)."""
    from fedml_tpu_torch.compression.compressors import tree_map

    cpu = lambda t: tree_map(lambda x: torch.as_tensor(x).cpu(), t)
    return _states_diff(torch, cpu(a), cpu(b))


def _sl_gossip_lm(torch, fa, smi):
    """(a): DSGD on the full-width LM, plain and with topk 1%; the
    attention counters set to 0 just before each run and read just after:
    the N nodes train at once, so each of B2-B4 runs once a layer a local
    step (the packed steps S, all nodes in one launch)."""
    import math

    from fedml_tpu_torch.parallel.packing import _steps_for

    out = {}
    for label, extra in (("dsgd_lm", []),
                         ("dsgd_lm_topk", ["--compressor", "topk:0.01"])):
        for name in fa.launches:
            fa.launches[name] = 0
        api, states, secs = _sl_run("main_decentralized", SL_LM + extra)
        launches = dict(fa.launches)
        _sl_card(api, label)
        _sl_finite(torch, states, label)
        layers = sum(1 for k in states["params"] if k.endswith(".qkv.weight"))
        ns = [len(d["y"]) for d in api.train_data_local_dict.values()]
        S = math.ceil(max(_steps_for(n, api.args.batch_size, 1)
                          for n in ns) / 8) * 8
        expect = layers * S * api.args.comm_round
        if launches != {"fwd": expect, "dq": expect, "dkv": expect}:
            fail(f"serverless {label}: attention launches {launches}, "
                 f"expected {expect} each ({layers} layers x {S} steps x "
                 f"{api.args.comm_round} rounds)")
        rec = api.history[-1]
        line = {"launches": launches, "nodes": api.n_nodes,
                "steps_per_round": S,
                "train_loss": [r["Train/Loss"] for r in api.history],
                "consensus": api.consensus_distance()}
        if extra:
            # the count rests on the shapes alone, so the CPU's run of the
            # same main takes one round over a few samples
            cpu, _, cpu_secs = _sl_run("main_decentralized", SL_LM + extra
                                       + SL_LM_CPU_WIRE)
            got = (rec["bytes_on_wire"], rec["compression_ratio"])
            exp = (cpu.history[-1]["bytes_on_wire"],
                   cpu.history[-1]["compression_ratio"])
            if cpu.device.type != "cpu" or got != exp:
                fail(f"serverless {label}: bytes_on_wire/compression_ratio "
                     f"{got[0]}/{got[1]}, the CPU run's {exp[0]}/{exp[1]}")
            line.update(bytes_on_wire=got[0], compression_ratio=got[1],
                        cpu_wire_run_s=round(cpu_secs, 3))
        print(f"serverless run={label} s={secs:.3f} "
              f"s_per_round={secs / api.args.comm_round:.3f} "
              f"{json.dumps(line)} card={smi}", flush=True)
        out[label] = launches
    return out


def _sl_pushsum_resnet(torch, smi):
    """(b): PushSum on a directed topology over ResNet-56: ``pushsum_w``
    equal to ``W @ 1`` on the host, every node state finite."""
    import numpy as np

    api, states, secs = _sl_run("main_decentralized", SL_PUSHSUM)
    _sl_card(api, "pushsum_resnet56")
    _sl_finite(torch, states, "pushsum_resnet56")
    W = api.W.cpu().double().numpy()
    want = W @ np.ones(api.n_nodes)
    got = api.pushsum_w.cpu().double().numpy()
    gap = float(np.abs(got - want).max())
    if gap > 1e-6 or np.allclose(want, 1.0):
        fail(f"serverless pushsum_resnet56: pushsum_w {got}, W @ 1 {want}")
    print(f"serverless run=pushsum_resnet56 s_per_round={secs:.3f} "
          f"nodes={api.n_nodes} pushsum_w={got.round(6).tolist()} "
          f"w_gap={gap} train_loss={api.history[-1]['Train/Loss']} "
          f"consensus={api.consensus_distance()} card={smi}", flush=True)


def _sl_online(torch, smi):
    """(c): online DSGD and PushSum, time-varying, card against CPU."""
    for algo in ("dsgd", "pushsum"):
        argv = SL_ONLINE + ["--algorithm", algo]
        api, w, secs = _sl_run("main_decentralized", argv)
        _sl_card(api, f"online_{algo}")
        cpu, w_cpu, _ = _sl_run("main_decentralized",
                                argv + ["--platform", "cpu"])
        gap = _sl_gap(torch, {"w": w}, {"w": w_cpu})
        rec_gap = max(abs(api.history[k] - cpu.history[k])
                      for k in cpu.history)
        if max(gap, rec_gap) > SL_TOL["online"]:
            fail(f"serverless online_{algo}: card vs CPU w {gap}, "
                 f"records {rec_gap} > {SL_TOL['online']}")
        print(f"serverless run=online_{algo} T={api.T} s={secs:.3f} "
              f"w_gap={gap} record_gap={rec_gap} "
              f"{json.dumps(api.history)} card={smi}", flush=True)


def _sl_split(torch, smi):
    """(d): SplitNN's conv cut, card against CPU from the same weights
    (both sides draw them from the seed on the host)."""
    api, _, secs = _sl_run("main_splitnn", SL_SPLIT)
    _sl_card(api, "splitnn")
    cpu, _, cpu_secs = _sl_run("main_splitnn", SL_SPLIT + ["--platform",
                                                           "cpu"])
    gaps = {"client": _sl_gap(torch, api.client_params, cpu.client_params),
            "server": _sl_gap(torch, api.server_params, cpu.server_params)}
    acc = api.evaluate(0)["Test/Acc"]
    if max(gaps.values()) > SL_TOL["split"] or abs(
            acc - cpu.evaluate(0)["Test/Acc"]) > SL_TOL["split"]:
        fail(f"serverless splitnn: card vs CPU {gaps} > {SL_TOL['split']}")
    print(f"serverless run=splitnn_conv clients={api.n_clients} "
          f"s_per_round={secs / api.args.comm_round:.3f} "
          f"cpu_s_per_round={cpu_secs / api.args.comm_round:.3f} "
          f"gaps={json.dumps(gaps)} test_acc={acc} card={smi}", flush=True)


def _loan_fixture(path, n=1000, seed=0):
    """A processed loan csv with the schema of the finance tests
    (``tests/test_data_extra.py`` ``TestVerticalFinance``): the first
    names of each feature group and ``target``."""
    import csv

    import numpy as np

    from fedml_tpu_torch.data import vertical_finance as vf

    cols = (vf.QUALIFICATION_FEAT[:3] + vf.LOAN_FEAT[:2] + vf.DEBT_FEAT[:3]
            + vf.REPAYMENT_FEAT[:2] + vf.MULTI_ACC_FEAT[:2]
            + vf.MAL_BEHAVIOR_FEAT[:2])
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols + ["target"])
        for _ in range(n):
            w.writerow(list(rng.normal(size=len(cols)).round(4))
                       + [int(rng.integers(0, 2))])


def _sl_vfl(torch, smi):
    """(e): vertical FL on the synthetic set (2 and 3 parties) and on a
    Lending Club fixture (2 and 3 parties), card against CPU."""
    import shutil

    root = os.path.join(HERE, "build", "chip_smoke_serverless")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _loan_fixture(os.path.join(root, "loan_processed.csv"))
    for dataset in ("synthetic_vertical", "lending_club"):
        for parties in ("2", "3"):
            argv = SL_VFL + ["--dataset", dataset, "--party_num", parties,
                             "--data_dir", root]
            label = f"vfl_{dataset}_{parties}"
            api, hist, secs = _sl_run("main_vfl", argv)
            _sl_card(api, label)
            _, cpu_hist, _ = _sl_run("main_vfl", argv + ["--platform",
                                                          "cpu"])
            gap = max(abs(a[k] - b[k]) for a, b in zip(hist, cpu_hist)
                      for k in b)
            if len(hist) != 2 or gap > SL_TOL["vfl"]:
                fail(f"serverless {label}: card vs CPU records {gap} > "
                     f"{SL_TOL['vfl']} ({hist} / {cpu_hist})")
            print(f"serverless run={label} rows={int(api.y.shape[0])} "
                  f"s_per_epoch={secs / 2:.3f} record_gap={gap} "
                  f"{json.dumps(hist[-1])} card={smi}", flush=True)
    shutil.rmtree(root, ignore_errors=True)


def _sl_turbo(torch, smi):
    """(f): TurboAggregate on ResNet-56 against ``main_fedavg``'s same
    host-packed round: within ``C / (2 * mpc_scale)`` plus 1e-5."""
    argv = EXP_RESNET + ["--device_resident", "0"]
    turbo, state, secs = _sl_run("main_turboaggregate", argv)
    _sl_card(turbo, "turboaggregate")
    _sl_finite(torch, state, "turboaggregate")
    plain, plain_state, plain_secs = _sl_run("main_fedavg", argv)
    bound = SL_COHORT / (2 * SL_MPC_SCALE) + 1e-5
    gap = _sl_gap(torch, state, plain_state)
    moved = _sl_gap(torch, state, turbo.spec.init_fn(turbo.seed, "cpu"))
    if gap > bound or moved < 100 * bound:
        fail(f"serverless turboaggregate: {gap} from FedAvg (bound "
             f"{bound}), {moved} from the init")
    print(f"serverless run=turboaggregate_resnet56 "
          f"s_per_round={secs:.3f} fedavg_s_per_round={plain_secs:.3f} "
          f"gap={gap} bound={bound} "
          f"train_loss={turbo.history[-1]['Train/Loss']} card={smi}",
          flush=True)


def phase_serverless(torch, grouped_conv, fa, smi):
    """Serverless, split, vertical and secure FL through their four mains
    on the card (module docstring, 14), under deterministic kernels. B1
    runs in none of them (its counter is set to 0 just before and must
    read 0 just after); the decentralized LM runs B2-B4."""
    t0 = time.time()
    grouped_conv.launches = 0
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        launches = _sl_gossip_lm(torch, fa, smi)
        _sl_pushsum_resnet(torch, smi)
        _sl_online(torch, smi)
        _sl_split(torch, smi)
        _sl_vfl(torch, smi)
        _sl_turbo(torch, smi)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if grouped_conv.launches:
        fail(f"serverless: B1 launched {grouped_conv.launches} times")
    print(f"serverless phase_s={time.time() - t0:.1f} card={smi}",
          flush=True)
    return launches


#: phase 15 (module docstring): (a) FedSeg on the full-width DeepLab
#: (resnet backbone, width 32) at 128x128, 4 clients, batch 8, poly
SEG_ARGV = ["--dataset", "synthetic_segmentation", "--backbone", "resnet",
            "--image_size", "128", "--client_num_in_total", "4",
            "--client_num_per_round", "4", "--batch_size", "8",
            "--lr_scheduler", "poly", "--epochs", "1",
            "--frequency_of_the_test", "1"]
#: the card-against-CPU FedSeg round: 8 samples a client (one step)
SEG_SMALL = ["--n_train", "32", "--n_test", "8", "--comm_round", "1"]
#: (b) FedNAS at the reference's defaults (C 16, 8 layers, 4 steps a
#: cell, second order, batch 32) on CIFAR-shaped images, 2 clients of 64
#: samples (one search step each on its 32-sample train half), 1 round
NAS_ARGV = ["--dataset", "synthetic_images", "--image_size", "32",
            "--client_num_in_total", "2", "--client_num_per_round", "2",
            "--n_train", "128", "--n_test", "64", "--partition_method",
            "homo", "--comm_round", "1", "--arch_order", "2"]
#: the card-against-CPU search step: C 16 and 8 layers at 2 steps a cell
#: (the CPU's second-order step at the reference's 4 steps takes 33-41 s,
#: past the phase's budget), batch 8
NAS_STEP_NET = {"C": 16, "layers": 8, "steps": 2}
#: (c) FedGKT: resnet8_56 clients and the ResNet-56 tail on the server,
#: 4 clients of 128 CIFAR-shaped images, 2 rounds (round 2 distils from
#: round 1's server)
GKT_ARGV = ["--dataset", "synthetic_images", "--image_size", "32",
            "--client_num_in_total", "4", "--client_num_per_round", "4",
            "--partition_method", "homo", "--client_model", "resnet8_56",
            "--server_blocks", "9", "--comm_round", "2"]
#: the card-against-CPU FedGKT rounds: 32 samples a client at batch 16
#: (2 client steps a round, 8 server steps), the lr set below the
#: server's stability limit (at the default 0.03 a server step amplifies
#: a 1e-5 parameter difference 60 times; the CPU at 1 thread against 8
#: ends 0.28 apart)
GKT_SMALL = ["--n_train", "128", "--n_test", "32", "--batch_size", "16",
             "--lr", "0.0001"]
#: card against CPU (fp32, deterministic kernels; cuDNN's convolutions
#: against the CPU's): FedSeg's global state after one step of the
#: full-width DeepLab; FedGKT's client and server states and teacher
#: logits after 2 rounds through the ResNet-56 tail, and ("gkt_rel") the
#: clients' and the server's weights relative to their round-2 moves
#: (1.2e-4 and 2.0e-3 at lr 1e-4; the H100 read 2.5e-4 and 1.9e-3 of
#: them, the CPU at 1 thread against 8 5.0e-4 and 1.5e-3), so a faulty
#: or missing step on the card, about a move apart, fails. FedNAS's step
#: is held relative to each quantity's scale ("nas_rel": the arch
#: gradient's largest magnitude, the weights' and statistics' largest
#: move), each limit a small multiple of its reading on the H100 (0.37%,
#: 9.0e-4 and 7.6e-7): the CPU's own fp32 second-order arch gradient at
#: this network lies 1.5-4% of its scale from float64 (flax's fast
#: BatchNorm variance in fp32 through 8 cells), so the arch gradient's
#: limit stays under that spread; the weight step follows alphas that
#: Adam's first step moves by +-arch_lr wherever a gradient's sign lies
#: within that noise
A14C_TOL = {"seg": 1e-3, "gkt": 1e-3, "gkt_rel": 1e-2,
            "nas_rel": {"arch_grad": 1e-2, "weights": 5e-3, "stats": 5e-6}}


def _a14c_seg(torch, smi):
    """(a): FedSeg through ``main_fedseg``: 2 rounds at output stride 16,
    one round card against CPU from the same weights, 1 round at output
    stride 8."""
    api, state, secs = _sl_run("main_fedseg", SEG_ARGV + ["--comm_round",
                                                          "2"])
    _sl_card(api, "fedseg")
    _sl_finite(torch, state, "fedseg")
    rec = api.history[-1]
    if not 0.0 <= rec["Seg/mIoU"] <= 1.0:
        fail(f"a14c fedseg: Seg/mIoU {rec['Seg/mIoU']}")
    print(f"a14c run=fedseg_deeplab_os16 rounds=2 "
          f"s_per_round={secs / 2:.3f} seg_miou={rec['Seg/mIoU']} "
          f"train_miou={rec['Train/mIoU']} test_acc={rec['Test/Acc']} "
          f"card={smi}", flush=True)
    card, _, c_secs = _sl_run("main_fedseg", SEG_ARGV + SEG_SMALL)
    cpu, _, cpu_secs = _sl_run("main_fedseg", SEG_ARGV + SEG_SMALL
                               + ["--platform", "cpu"])
    gap = _sl_gap(torch, card.global_state, cpu.global_state)
    moved = _sl_gap(torch, card.global_state,
                      card.spec.init_fn(card.seed, "cpu"))
    if gap > A14C_TOL["seg"] or moved < 10 * A14C_TOL["seg"]:
        fail(f"a14c fedseg: card vs CPU {gap} (tol {A14C_TOL['seg']}), "
             f"moved {moved}")
    print(f"a14c run=fedseg_card_vs_cpu gap={gap} moved={moved} "
          f"tol={A14C_TOL['seg']} s={c_secs:.3f} cpu_s={cpu_secs:.3f} "
          f"seg_miou={card.history[-1]['Seg/mIoU']} "
          f"cpu_seg_miou={cpu.history[-1]['Seg/mIoU']} card={smi}",
          flush=True)
    api, state, secs = _sl_run("main_fedseg", SEG_ARGV + SEG_SMALL
                               + ["--outstride", "8"])
    _sl_card(api, "fedseg os8")
    _sl_finite(torch, state, "fedseg os8")
    print(f"a14c run=fedseg_deeplab_os8 rounds=1 s_per_round={secs:.3f} "
          f"seg_miou={api.history[-1]['Seg/mIoU']} card={smi}", flush=True)


def _a14c_nas_step(torch, device, batches):
    """One client's second-order search step on ``device`` from the seed's
    weights (``NAS_STEP_NET``), built here and taken by the function it
    returns: ``take() -> (the arch gradient the step took, local state
    after the step, initial state, seconds)``."""
    from fedml_tpu_torch.algorithms import fednas
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.models import darts

    spec = make_classification_spec(darts.DARTSNetwork(**NAS_STEP_NET))
    state = spec.init_fn(0, device)
    cfg = fednas.FedNASConfig(arch_order=2)
    data = {k: torch.as_tensor(v, device=device) for k, v in batches.items()}
    taken, make = [], fednas.make_arch_grad_fn

    def recording(spec, cfg):
        arch_grads = make(spec, cfg)
        return lambda *a: taken.append(arch_grads(*a)) or taken[-1]

    fednas.make_arch_grad_fn = recording
    try:
        update = fednas.make_search_client_update(spec, cfg)
    finally:
        fednas.make_arch_grad_fn = make

    def take():
        t0 = time.time()
        local, _ = update(state, data)
        if device == "cuda":
            torch.cuda.synchronize()
        return taken[0], local, state, time.time() - t0

    return take


def _a14c_rel(torch, got, want, start=None):
    """Largest difference over two states, over the largest magnitude of
    ``want`` (or of its move from ``start``)."""
    ref = want if start is None else {
        k: torch.as_tensor(want[k]).cpu() - torch.as_tensor(start[k]).cpu()
        for k in want}
    scale = max(float(torch.as_tensor(v).abs().max()) for v in ref.values())
    return _sl_gap(torch, got, want) / max(scale, 1e-30), scale


def _a14c_nas(torch, smi):
    """(b): FedNAS's search and train stages through ``main_fednas``, and
    one client's second-order step card against CPU."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from fedml_tpu_torch.models import darts

    rng = np.random.default_rng(0)
    batches = {"x": rng.normal(size=(1, 8, 32, 32, 3)).astype(np.float32),
               "y": rng.integers(0, 10, (1, 8)).astype(np.int64),
               "mask": np.ones((1, 8), np.float32),
               "val_x": rng.normal(size=(1, 8, 32, 32, 3)).astype(
                   np.float32),
               "val_y": rng.integers(0, 10, (1, 8)).astype(np.int64)}
    # the CPU's side of the step runs in a thread beside the card's
    # search round (the round is host launches on one core; the CPU's
    # step is compute, outside the GIL)
    with ThreadPoolExecutor(1) as pool:
        cpu_step = pool.submit(_a14c_nas_step(torch, "cpu", batches))
        api, genotype, secs = _sl_run("main_fednas", NAS_ARGV
                                      + ["--stage", "search"])
        g_card, l_card, _, t_card = _a14c_nas_step(torch, "cuda",
                                                   batches)()
        g_cpu, l_cpu, s_cpu, t_cpu = cpu_step.result()
    _sl_card(api, "fednas search")
    _sl_finite(torch, api.global_state, "fednas search")
    print(f"a14c run=fednas_search C=16 layers=8 steps=4 order=2 "
          f"s_per_round={secs:.3f} "
          f"train_loss={api.history[-1]['Train/Loss']} "
          f"genotype={json.dumps(str(genotype))} card={smi}", flush=True)
    rel = {"arch_grad": _a14c_rel(torch, g_card, g_cpu),
           "weights": _a14c_rel(torch, l_card["params"], l_cpu["params"],
                                s_cpu["params"]),
           "stats": _a14c_rel(torch, l_card["batch_stats"],
                              l_cpu["batch_stats"], s_cpu["batch_stats"])}
    # Adam's first step moves each alpha by about arch_lr * sign(grad):
    # an alpha may land apart only where its gradient lies within the
    # two sides' gradient gap of 0
    grad_gap = _sl_gap(torch, g_card, g_cpu)
    flips, unexplained = 0, 0
    for k, g in g_cpu.items():
        apart = (l_card["arch"][k].cpu() - l_cpu["arch"][k]).abs() > 1e-6
        flips += int(apart.sum())
        unexplained += int((apart & (g.abs() > grad_gap)).sum())
    same = darts.derive_genotype(l_card["arch"]) == darts.derive_genotype(
        l_cpu["arch"])
    tol = A14C_TOL["nas_rel"]
    if any(rel[k][0] > tol[k] for k in rel) or unexplained or not same:
        fail(f"a14c fednas step: card vs CPU relative {rel} (tol {tol}), "
             f"{unexplained} of {flips} alpha flips outside the gradient "
             f"gap, same genotype {same}")
    print(f"a14c run=fednas_step_card_vs_cpu net={json.dumps(NAS_STEP_NET)}"
          f" batch=8 rel={json.dumps(rel)} tol={json.dumps(tol)} "
          f"alpha_flips={flips} "
          f"same_genotype={same} s={t_card:.3f} cpu_s={t_cpu:.3f} "
          f"card={smi}", flush=True)
    api, state, secs = _sl_run("main_fednas", NAS_ARGV + ["--stage",
                                                          "train"])
    _sl_card(api, "fednas train")
    _sl_finite(torch, state, "fednas train")
    print(f"a14c run=fednas_train genotype=DARTS_V1 C=16 layers=8 "
          f"s_per_round={secs:.3f} "
          f"train_loss={api.history[-1]['Train/Loss']} card={smi}",
          flush=True)


def _a14c_gkt(torch, smi):
    """(c): FedGKT through ``main_fedgkt``, then 2 rounds at 32 samples a
    client card against CPU from the same weights."""
    api, server_state, secs = _sl_run("main_fedgkt", GKT_ARGV
                                      + ["--n_train", "512"])
    _sl_card(api, "fedgkt")
    _sl_finite(torch, server_state, "fedgkt server")
    _sl_finite(torch, api.client_states, "fedgkt clients")
    ev = api.evaluate()
    print(f"a14c run=fedgkt_resnet8_56_server56 clients=4 rounds=2 "
          f"s_per_round={secs / 2:.3f} test_acc={ev['Test/Acc']} "
          f"test_samples={ev['Test/Samples']} card={smi}", flush=True)
    card, _, c_secs = _a14c_gkt_rounds(torch, GKT_SMALL)
    cpu, cpu_r1, cpu_secs = _a14c_gkt_rounds(torch, GKT_SMALL
                                             + ["--platform", "cpu"])
    gaps, moves, rel = _a14c_gkt_gaps(torch, card, cpu, cpu_r1)
    tol, rel_tol = A14C_TOL["gkt"], A14C_TOL["gkt_rel"]
    if (any(g > tol for g in gaps.values())
            or any(not moves[k] > 0 or rel[k] > rel_tol for k in rel)
            or not card.teacher_logits.any()):
        fail(f"a14c fedgkt: card vs CPU {gaps} (tol {tol}); the weights "
             f"{rel} of their round-2 moves {moves} apart (tol {rel_tol})")
    print(f"a14c run=fedgkt_card_vs_cpu samples_per_client=32 batch=16 "
          f"gaps={json.dumps(gaps)} tol={tol} weight_moves="
          f"{json.dumps(moves)} weight_rel={json.dumps(rel)} "
          f"rel_tol={rel_tol} "
          f"s_per_round={c_secs / 2:.3f} cpu_s_per_round={cpu_secs / 2:.3f} "
          f"card={smi}", flush=True)


def _a14c_gkt_rounds(torch, argv):
    """2 rounds of ``main_fedgkt``: round 1 through the main, round 2 by
    ``train_one_round``; ``(api, round 1's clients and server on the
    CPU, seconds)``."""
    from fedml_tpu_torch.compression.compressors import tree_map

    api, _, secs = _sl_run("main_fedgkt", GKT_ARGV + argv
                           + ["--comm_round", "1"])
    cpu = lambda t: tree_map(lambda x: x.detach().cpu().clone(), t)
    r1 = {"clients": cpu(api.client_states),
          "server": cpu(api.server_state)}
    t0 = time.time()
    api.train_one_round()
    if api.device.type == "cuda":
        torch.cuda.synchronize()
    return api, r1, secs + time.time() - t0


def _a14c_gkt_gaps(torch, card, cpu, cpu_r1):
    """The card's clients and server (whole states) and teacher logits
    after round 2 from the CPU's (``gaps``); the CPU's round-2 move of
    the clients' and the server's weights (``moves``; the statistics and
    the teachers move also without a step) and the card's weights' gap
    over it (``rel``): a faulty step in either round lies about a move
    apart."""
    states = lambda api: {"clients": api.client_states,
                          "server": api.server_state}
    got, want = states(card), states(cpu)
    gaps = {k: _sl_gap(torch, got[k], want[k]) for k in want}
    gaps["teacher"] = float(abs(card.teacher_logits
                                - cpu.teacher_logits).max())
    moves = {k: _sl_gap(torch, want[k]["params"], cpu_r1[k]["params"])
             for k in want}
    rel = {k: _sl_gap(torch, got[k]["params"], want[k]["params"])
           / max(moves[k], 1e-30) for k in want}
    return gaps, moves, rel


def phase_a14c(torch, grouped_conv, fa, smi):
    """FedSeg, FedNAS and FedGKT through their mains on the card (module
    docstring, 15), under deterministic kernels. The slice launches none
    of B1-B4: their counters are set to 0 just before and must read 0
    just after."""
    t0 = time.time()
    grouped_conv.launches = 0
    for name in fa.launches:
        fa.launches[name] = 0
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        _a14c_seg(torch, smi)
        _a14c_nas(torch, smi)
        _a14c_gkt(torch, smi)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if grouped_conv.launches or any(fa.launches.values()):
        fail(f"a14c: B1-B4 launched ({grouped_conv.launches}, "
             f"{dict(fa.launches)}); the slice runs none of them")
    print(f"a14c phase_s={time.time() - t0:.1f} card={smi}", flush=True)


#: phase 16's run: the experiment phase's full-width TransformerLM,
#: streamed through bucketed chunks (the path whose buckets the cost
#: model attributes)
TOOL_LM = EXP_LM + ["--bucket_edges", "geometric"]
#: a cold or warm run in a fresh process: the main, then the launch
#: counters and this process's nvcc runs
_TOOL_CHILD = (
    "import json, sys\n"
    "from fedml_tpu_torch.ops import _build\n"
    "from fedml_tpu_torch.ops import flash_attention as fa\n"
    "from fedml_tpu_torch.experiments import main_fedavg\n"
    "main_fedavg.main(sys.argv[1:])\n"
    "print('tooling_child ' + json.dumps({'launches': fa.launches, "
    "'nvcc_runs': _build.build_stats['builds']}), flush=True)\n")


def _tool_flags(root, run, ckpt="ckpt", xprof=True):
    """Every tooling flag, the artifacts under ``run``, the build cache
    under ``root`` (shared by every run) and the checkpoints in
    ``root/ckpt``."""
    flags = ["--trace", "1", "--trace_dir", os.path.join(run, "trace"),
             "--flightrec", "1", "--perfmon", "1", "--costmodel", "1",
             "--audit", "1", "--race_audit", "1", "--warmup", "1",
             "--checkpoint_dir", os.path.join(root, ckpt),
             "--compile_cache_dir", os.path.join(root, "cache"),
             "--run_dir", run]
    if xprof:
        flags += ["--xprof_round", "1",
                  "--xprof_dir", os.path.join(run, "xprof")]
    return flags


def _tool_start(argv):
    """Start one run of the main in a fresh process (the build records
    and the loaded libraries are process-wide)."""
    return time.time(), subprocess.Popen(
        [sys.executable, "-c", _TOOL_CHILD, *argv], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": HERE})


def _tool_wait(started, label):
    """Wait for a run :func:`_tool_start` started (killing it past 600
    s): its launch counters, nvcc runs and seconds."""
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("tooling_child ")]
    if proc.returncode != 0 or not lines:
        fail(f"tooling {label}: exit {proc.returncode}\n{err[-4000:]}")
    res = json.loads(lines[-1].split(" ", 1)[1])
    res["seconds"] = time.time() - t0
    return res


def _tool_records(run):
    """The run's metrics records merged (the reports land once each) and
    its round records."""
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    merged = {}
    for r in recs:
        merged.update(r)
    return merged, [r for r in recs if "Train/Loss" in r]


def _tool_common(label, m, rounds, launches):
    """What both processes hold to: no build in any round, no transfer
    off the device, a clean race audit, B2-B4 launched."""
    want = [0] * len(rounds)
    for key in ("audit/compiles_per_round", "audit/retraces_per_round",
                "compile/compiles_per_round"):
        if m[key] != want:
            fail(f"tooling {label}: {key} {m[key]}, want {want}")
    if m["audit/transfer_guard_violations"] != 0:
        fail(f"tooling {label}: {m['audit/transfer_guard_violations']} "
             "transfer-guard violations")
    if m["race/lock_order_cycles"] or m["race/held_while_blocking"]:
        fail(f"tooling {label}: race audit {m['race/lock_order_cycles']} "
             f"{m['race/held_while_blocking']}")
    if not all(launches[k] > 0 for k in ("fwd", "dq", "dkv")):
        fail(f"tooling {label}: attention launches {launches}")


def _tool_step_flops(torch):
    """FLOPs of one client's local step of ``TOOL_LM``, counted on the
    CPU (``train_step_flops``)."""
    from fedml_tpu_torch.experiments import common, main_fedavg
    from fedml_tpu_torch.observability.costmodel import train_step_flops
    from fedml_tpu_torch.parallel.engine import ClientUpdateConfig

    args = main_fedavg.parser().parse_args(TOOL_LM)
    dataset, model = common.load_dataset_and_model(args)
    spec = common.make_spec(args, model, dataset)
    x = common.example_train_data(dataset)["x"]
    bs = args.batch_size
    cfg = ClientUpdateConfig(optimizer=args.client_optimizer, lr=args.lr)
    return train_step_flops(
        spec, cfg, {"x": ((bs,) + tuple(x.shape[1:]),
                          torch.as_tensor(x[:1]).dtype),
                    "y": ((bs,) + tuple(x.shape[1:]), torch.int64),
                    "mask": ((bs,), torch.float32)})


def _tool_profile(path):
    """Device microseconds of each of B2-B4's kernels in a profiler
    trace, by kernel name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for name in ("fwd_mma_kernel", "dq_mma_kernel", "dkv_mma_kernel"):
        durs = [e.get("dur", 0) for e in events
                if e.get("cat") == "kernel" and name in e.get("name", "")]
        if not durs:
            fail(f"tooling: the profiled round's trace {path} holds no "
                 f"{name}")
        out[name] = {"launches": len(durs), "us": round(sum(durs), 1)}
    return out


def phase_tooling(torch, fa, smi):
    """The mains' run-time tooling on the card (module docstring, 16):
    (a) a cold run and (b) a warm restart, each in a fresh process, and
    (c) the tooled run bit-equal to the plain one in this process, run
    while (b) runs (its readings are counts, not times)."""
    import shutil
    import tempfile

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    try:
        # (a) cold: a fresh, empty build cache
        run = os.path.join(root, "cold")
        cold = _tool_wait(_tool_start(TOOL_LM + _tool_flags(root, run)),
                          "cold")
        m, rounds = _tool_records(run)
        for path in (os.path.join(run, "trace", "trace.json"),
                     os.path.join(run, "trace", "spans.jsonl"),
                     os.path.join(run, "metrics.prom")):
            if not os.path.exists(path):
                fail(f"tooling cold: {path} not written")
        with open(os.path.join(run, "status.json")) as f:
            if json.load(f).get("final") is not True:
                fail("tooling cold: status.json is not final")
        xprof = sorted(os.listdir(os.path.join(run, "xprof")))
        if xprof != ["xprof_round_1"]:
            fail(f"tooling cold: profiler captures {xprof}, want round 1's")
        kernels = _tool_profile(os.path.join(run, "xprof", "xprof_round_1",
                                             "trace.json"))
        if not (m["warmup/programs"] == m["warmup/cache_misses"] == 1
                and m["warmup/cache_hits"] == 0 and cold["nvcc_runs"] == 1):
            fail(f"tooling cold: warmup {m['warmup/programs']} programs, "
                 f"{m['warmup/cache_misses']} misses, "
                 f"{m['warmup/cache_hits']} hits, {cold['nvcc_runs']} nvcc "
                 "runs; want flash_attention built once")
        _tool_common("cold", m, rounds, cold["launches"])
        step = _tool_step_flops(torch)
        for r in rounds:
            for kind in ("executed", "true"):
                want = step * r[f"bucket/{kind}_steps"]
                got = r[f"bucket/{kind}_flops"]
                if abs(got - want) > 1e-9 * want:
                    fail(f"tooling cold: round {r['round']} {kind} FLOPs "
                         f"{got} != step {step} x {r[f'bucket/{kind}_steps']}")
        print(f"tooling cold s={cold['seconds']:.1f} "
              f"nvcc_s={m['warmup/compile_seconds']} "
              f"warmup_s={m['warmup/seconds']} "
              f"misses={m['warmup/cache_misses']} "
              f"launches={json.dumps(cold['launches'])} card={smi}",
              flush=True)
        print(f"tooling profiled_round=1 kernels={json.dumps(kernels)} "
              f"round_time_s={rounds[1]['round_time_s']} card={smi}",
              flush=True)
        print(f"tooling flops step={step} executed_per_round="
              f"{[r['bucket/executed_flops'] for r in rounds]} "
              f"waste_frac={[r['bucket/flops_waste_frac'] for r in rounds]}"
              f" card={smi}", flush=True)

        # (b) warm restart over the same cache and checkpoints, and
        # meanwhile (c) bit-equality in this process under deterministic
        # kernels (its checkpoints apart from (b)'s)
        run = os.path.join(root, "warm")
        started = _tool_start(TOOL_LM + ["--resume", "1", "--comm_round",
                                         "4"]
                              + _tool_flags(root, run, xprof=False))
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        try:
            plain, _ = _experiment(TOOL_LM)
            tooled, _ = _experiment(TOOL_LM + _tool_flags(
                root, os.path.join(root, "inproc"), ckpt="ckpt_inproc"))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
            warm = _tool_wait(started, "warm")
        m, rounds = _tool_records(run)
        if not (warm["nvcc_runs"] == 0 and m["warmup/cache_misses"] == 0
                and m["warmup/cache_hits"] == 1 and len(rounds) == 2):
            fail(f"tooling warm: {warm['nvcc_runs']} nvcc runs, "
                 f"{m['warmup/cache_misses']} misses, "
                 f"{m['warmup/cache_hits']} hits, {len(rounds)} rounds")
        _tool_common("warm", m, rounds, warm["launches"])
        print(f"tooling warm_restart s={warm['seconds']:.1f} nvcc_runs=0 "
              f"misses=0 hits={m['warmup/cache_hits']} "
              f"warmup_s={m['warmup/seconds']} "
              f"launches={json.dumps(warm['launches'])} card={smi}",
              flush=True)
        gap = _states_diff(torch, plain.global_state, tooled.global_state)
        if gap != 0.0:
            fail(f"tooling: the tooled run's state differs from the plain "
                 f"run's by {gap}")
        print(f"tooling bit_equal=1 phase_s={time.time() - t0:.1f} "
              f"card={smi}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: main_longcontext's local steps on the card
A15_STEPS = 3
#: ``--mesh 1`` against ``--mesh 0``: one host-packed fp32 round under
#: deterministic kernels, the one-rank all_reduce a copy
A15_MESH_TOL = 1e-5
#: the long-context main at its defaults, the local path
A15_LC = ["--n_seq", "1", "--steps", str(A15_STEPS)]
#: ResNet-56 at full width, fp32, host-packed: 4 clients of 256, 1 epoch
A15_RESNET = ["--model", "resnet56", "--dataset", "synthetic_images",
              "--image_size", "32", "--client_num_in_total", "4",
              "--client_num_per_round", "4", "--n_train", "1024",
              "--batch_size", "64", "--epochs", "1", "--comm_round", "1",
              "--device_resident", "0"]


def _a15_lm_steps(torch, attention_fn, dtype, flags=()):
    """``A15_STEPS`` SGD steps (the main's lr) of main_longcontext's
    model and data at its defaults (plus ``flags``) on a one-rank mesh,
    computing in
    ``dtype`` over fp32 parameters, the attention through the kernels
    (``attention_fn`` None) or ``attention_fn``: the losses, the initial
    and the final parameters. SGD, not the main's AdamW, so that the
    parameters' drift is the gradients' and not Adam's sign noise."""
    import numpy as np

    from fedml_tpu_torch.experiments import main_longcontext
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel.seq_parallel import (
        make_seq_mesh, make_seq_parallel_lm_step, place_lm_batch,
        shift_targets)

    args = main_longcontext.parser().parse_args(A15_LC + list(flags))
    mesh = make_seq_mesh(1, 1)
    model = TransformerLM(vocab_size=args.vocab_size,
                          n_layers=args.n_layers, n_heads=args.n_heads,
                          d_model=args.d_model, max_len=args.seq_len,
                          dtype=dtype, attention_fn=attention_fn)
    data = np.random.default_rng(args.seed).integers(
        0, args.vocab_size, (64, args.seq_len))
    init_fn, step_fn = make_seq_parallel_lm_step(
        model, mesh, lambda ps: torch.optim.SGD(ps, lr=args.lr))
    params, opt = init_fn(args.seed)
    init = {k: v.detach().clone() for k, v in params.items()}
    losses, B = [], args.batch_size
    for step in range(A15_STEPS):
        idx = data[(step * B) % (64 - B + 1):][:B]
        params, opt, loss = step_fn(
            params, opt, *place_lm_batch(mesh, idx, shift_targets(idx)))
        losses.append(float(loss))
    return losses, init, params


#: the attention launches phase 17 times beside SDPA: (case, batch, T,
#: heads, head dim, dtypes) -- main_longcontext's launch, the LM
#: flagship's width in fp32 (the fp32 models' B3 and B4), and the
#: chunked route above D 128 at main_longcontext --d_model 1024
#: --n_heads 4 (D 256) and at D 384
A15_ATTN_TIMED = [("longcontext_T512", 32, 512, 4, 64, ("bf16", "fp32")),
                  ("flagship_fp32", 32, 80, 4, 128, ("fp32",)),
                  ("longcontext_D256", 32, 512, 4, 256, ("bf16", "fp32")),
                  ("longcontext_D384", 32, 512, 4, 384, ("bf16", "fp32"))]
#: main_longcontext's flags for head dim 256 (d_model 1024, 4 heads)
A15_WIDE = ["--d_model", "1024", "--n_heads", "4"]
#: the card cases' tolerances (rel, abs) by dtype
A15_ATTN_TOL = {"bf16": (1.6e-2, 1e-3), "fp32": (1e-4, 1e-5)}


def _sdpa_backend(torch, q, k, v):
    """The backend ``scaled_dot_product_attention`` takes for these
    ``[B, H, T, D]`` inputs, causal (its own choice,
    ``torch._fused_sdp_choice``): FLASH_ATTENTION, EFFICIENT_ATTENTION,
    CUDNN_ATTENTION or MATH."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                              True)).name


def _a15_attention_cases(torch, fa):
    """B2-B4 at each launch of ``A15_ATTN_TIMED`` (causal, q, k and v
    strided views of one qkv product) against their plain versions with
    the card cases' tolerances, each timed beside its plain version and
    SDPA (the backend it took named); then the whole backward as the
    ``FlashAttention`` Function runs it (delta, B3, B4), checked against
    the plain backward and timed beside SDPA's backward (``bwd_ms``, with
    delta's kernels alone as ``delta_ms``)."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    worst = lambda *es: max(es, key=lambda e: e[1])
    for case, Bq, T, H, D, dtypes in A15_ATTN_TIMED:
        C = H * D
        for name in dtypes:
            t0 = time.time()
            dtype = torch.bfloat16 if name == "bf16" else torch.float32
            rel, abs_ = A15_ATTN_TOL[name]
            label = f"{case} {name}"
            qkv = torch.randn(Bq, T, 3 * C, generator=gen, device=dev
                              ).to(dtype)
            q, k, v = (qkv[..., j * C:(j + 1) * C].reshape(Bq, T, H, D)
                       for j in range(3))
            do = torch.randn(Bq, T, H, D, generator=gen, device=dev
                             ).to(dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, True)
            o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, True)
            delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2)
            args = (q, k, v, do, lse_ref, delta.contiguous(), True)
            dq = fa.flash_attention_dq(*args)
            dk, dv = fa.flash_attention_dkv(*args)
            dq_ref, dk_ref, dv_ref = fa.flash_attention_bwd_reference(*args)
            # (error, error over tolerance), the worst by the latter
            def chk(what, got, ref, tol=(rel, abs_)):
                err = _check(f"{what} {label}", got, ref, *tol)
                return err, err / (tol[0] * float(ref.float().abs().max())
                                   + tol[1])

            errs = {"fwd": chk("fwd", o, o_ref),
                    "lse": chk("lse", lse, lse_ref, (1e-4, 1e-5)),
                    "dq": chk("dq", dq, dq_ref),
                    "dkv": worst(chk("dk", dk, dk_ref),
                                 chk("dv", dv, dv_ref))}
            ref_args = args[:-1] + (True, D ** -0.5, T)
            qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
            qg, kg, vg = (t.detach().requires_grad_(True)
                          for t in (qs, ks, vs))
            out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            sdpa = {"fwd": _sdpa_backend(torch, qs, ks, vs),
                    "bwd": _sdpa_backend(torch, qg, kg, vg)}
            bwd_lib = timed_ms(lambda: torch.autograd.grad(
                out_g, (qg, kg, vg), do.transpose(1, 2), retain_graph=True),
                flush)
            # the backward as the Function runs it, on its own forward
            qf, kf, vf = (t.detach().requires_grad_(True) for t in (q, k, v))
            out_f = fa.flash_attention(qf, kf, vf, True)
            fa_bwd = lambda: torch.autograd.grad(out_f, (qf, kf, vf), do,
                                                 retain_graph=True)
            # delta as the Function forms it (ops/flash_attention.py)
            delta_fn = lambda: (do.float() * o.float()).sum(
                dim=-1).transpose(1, 2).contiguous()

            def plain_bwd():
                d = (do.float() * o.float()).sum(-1).transpose(1, 2)
                return fa.flash_attention_bwd_reference(
                    q, k, v, do, lse, d.contiguous(), True)

            for gname, got, ref in zip(("dq", "dk", "dv"), fa_bwd(),
                                       plain_bwd()):
                errs["bwd"] = worst(errs.get("bwd", (0.0, 0.0)), chk(
                    f"FlashAttention backward {gname}", got, ref))
            bf16 = dtype == torch.bfloat16
            # the fp32 B2-B4 take three TF32 products for each fp32 one
            # (3xTF32): their bound is at a third of the TF32 rate, and
            # the rate of fp32 on the CUDA cores is kept beside it
            bounds = _attn_bounds(Bq, T, True, itemsize=2 if bf16 else 4,
                                  D=D, ops_per_s=(BF16_OPS_PER_S if bf16
                                                  else TF32_OPS_PER_S / 3))
            times = {
                "fwd": (lambda: fa.flash_attention_fwd(q, k, v, True),
                        lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                                 True),
                        lambda: F.scaled_dot_product_attention(
                            qs, ks, vs, is_causal=True)),
                "dq": (lambda: fa.flash_attention_dq(*args),
                       lambda: fa.flash_attention_dq_reference(*ref_args),
                       None),
                "dkv": (lambda: fa.flash_attention_dkv(*args),
                        lambda: fa.flash_attention_dkv_reference(*ref_args),
                        None),
                "bwd": (fa_bwd, plain_bwd, None)}
            prefix = ("attention_time_t512" if T == 512
                      else "attention_time_flagship_fp32")
            for kname, (kern, plain, lib) in times.items():
                row = {"case": f"{case}_{name}", "shape": [Bq, T, H, D],
                       "ms": timed_ms(kern, flush),
                       "plain_ms": timed_ms(plain, flush),
                       "library_ms": (timed_ms(lib, flush) if lib is not None
                                      else bwd_lib),
                       "sdpa_backend": sdpa["fwd" if kname == "fwd"
                                            else "bwd"],
                       "max_abs_err": errs[kname][0],
                       "err_over_tol": errs[kname][1],
                       "bound_ms": bounds[kname]["bound_ms"],
                       "bound_by": bounds[kname]["bound_by"]}
                if not bf16:
                    b = bounds[kname]
                    row["bound_fp32_cuda_core_ms"] = max(
                        b["bytes"] / HBM_BYTES_PER_S,
                        b["ops"] / FP32_OPS_PER_S) * 1e3
                if kname == "bwd":
                    row["bwd_ms"] = row["ms"]
                    row["delta_ms"] = timed_ms(delta_fn, flush)
                out[(case, name, kname)] = row
                print(f"{prefix} {kname} " + json.dumps(row), flush=True)
            print(f"a15 attention_case_s case={case}_{name} "
                  f"s={time.time() - t0:.1f}", flush=True)
    return out


def _a15_main_run(torch, fa, smi, flags, route):
    """``main_longcontext``'s ``A15_STEPS`` steps at its defaults (plus
    ``flags``: the dtype, the width) with B2-B4's counts zeroed just
    before: their launches, each layers x steps (B2 at least that)."""
    from fedml_tpu_torch.experiments import main_longcontext

    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.time()
    params, losses = main_longcontext.main(A15_LC + flags)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(fa.launches)
    args = main_longcontext.parser().parse_args(A15_LC + flags)
    want = args.n_layers * A15_STEPS
    if not (launches["dq"] == launches["dkv"] == want
            and launches["fwd"] >= want):
        fail(f"main_longcontext {flags}: attention launches "
             f"{launches}, want {want} = {args.n_layers} layers x "
             f"{A15_STEPS} steps")
    if not (all(math.isfinite(x) for x in losses)
            and next(iter(params.values())).device.type == "cuda"):
        fail(f"main_longcontext {flags}: losses {losses}")
    print(f"a15 longcontext T=512 D={args.d_model // args.n_heads} "
          f"route={route} steps={A15_STEPS} losses={losses} "
          f"launches={json.dumps(launches)} s={seconds:.2f} card={smi}",
          flush=True)
    return launches


def _a15_drift(torch, smi):
    """The same SGD steps from the same weights through the kernels and
    through the plain ``mha``, in bf16 (B2-B4's tensor-core route, the
    ROADMAP watch item) and fp32 (B2-B4 3xTF32), at main_longcontext's
    head dim 64 and at 256 (``A15_WIDE``: the chunked route): each
    step's loss drift, and the parameters' largest drift beside their
    largest move from the initial weights. Recorded, not gated."""
    from fedml_tpu_torch.ops.attention import mha

    for name, dtype, flags in (
            ("bf16", torch.bfloat16, []), ("fp32", torch.float32, []),
            ("bf16_D256", torch.bfloat16, A15_WIDE),
            ("fp32_D256", torch.float32, A15_WIDE)):
        t0 = time.time()
        k_losses, init, k_params = _a15_lm_steps(torch, None, dtype, flags)
        p_losses, _, p_params = _a15_lm_steps(
            torch, lambda q, k, v: mha(q, k, v, causal=True), dtype, flags)
        with torch.no_grad():
            drift = max(float((k_params[k] - p_params[k]).abs().max())
                        for k in k_params)
            move = max(float((k_params[k] - init[k]).abs().max())
                       for k in k_params)
        print(f"a15 b2_drift_{name} " + json.dumps({
            "steps": A15_STEPS, "optimizer": "sgd",
            "kernel_losses": k_losses, "plain_losses": p_losses,
            "loss_drift": [a - b for a, b in zip(k_losses, p_losses)],
            "max_param_drift": drift, "max_param_move": move,
            "drift_over_move": drift / move if move else None,
            "s": round(time.time() - t0, 1), "card": smi}), flush=True)


def _a15_longcontext(torch, fa, smi):
    """Phase 17 (a): the main's launches in fp32 (its default: B2-B4
    3xTF32 on the tensor cores) and in bf16 (B2-B4 in bf16 on the tensor
    cores), at its head dim 64 and at 256 (``A15_WIDE``, the chunked
    route), the timed attention cases, the drift."""
    t0 = time.time()
    bf16 = ["--model_dtype", "bf16"]
    launches = {
        "fp32": _a15_main_run(torch, fa, smi, [], "fp32_3xtf32"),
        "bf16": _a15_main_run(torch, fa, smi, bf16, "mma"),
        "fp32_D256": _a15_main_run(torch, fa, smi, A15_WIDE,
                                   "fp32_3xtf32_wide"),
        "bf16_D256": _a15_main_run(torch, fa, smi, bf16 + A15_WIDE,
                                   "mma_wide")}
    t1 = time.time()
    times = _a15_attention_cases(torch, fa)
    t2 = time.time()
    _a15_drift(torch, smi)
    print(f"a15 longcontext_s mains={t1 - t0:.1f} cases={t2 - t1:.1f} "
          f"drift={time.time() - t2:.1f} card={smi}", flush=True)
    return launches, times


def _a15_mesh_round(torch, grouped_conv, smi):
    """Phase 17 (b): ``--mesh 1`` against ``--mesh 0``, then the sharded
    packed lanes under the ``pallas`` lowering."""
    from fedml_tpu_torch.parallel.mesh import make_client_mesh
    from fedml_tpu_torch.parallel.multihost import Sharded

    states, times = {}, {}
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        for mesh in ("0", "1"):
            api, times[mesh] = _experiment(A15_RESNET + ["--mesh", mesh])
            states[mesh] = api.global_state
            if (mesh == "1") != (api.mesh is not None):
                fail(f"main_fedavg --mesh {mesh}: api.mesh {api.mesh}")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    gap = _states_diff(torch, states["1"], states["0"])
    if not gap <= A15_MESH_TOL:
        fail(f"main_fedavg --mesh 1 differs from --mesh 0 by {gap}")
    print(f"a15 mesh_round resnet56 mesh1_vs_mesh0={gap} "
          f"s_per_round={json.dumps(times)} card={smi}", flush=True)

    api = build_api(torch, mesh=make_client_mesh(1))
    if not isinstance(api.device_data, Sharded) or not (
            api.sharded_lane_runner and api.sharded_lane_runner.packed):
        fail("FedAvgAPI(mesh=, wave_mode=3) took no sharded packed lanes")
    grouped_conv.launches = 0
    record = api.train_one_round()
    launches, trip = grouped_conv.launches, api._last_trip
    if launches != 53 * trip or not math.isfinite(record["Train/Loss"]):
        fail(f"sharded packed lanes: B1 launched {launches} times, want "
             f"53 x {trip} lane steps; {record}")
    print(f"a15 sharded_lanes pallas lane_steps={trip} b1_launches="
          f"{launches} train_loss={record['Train/Loss']} "
          f"round_time_s={record['round_time_s']:.2f} card={smi}",
          flush=True)
    return launches


def _a15_compat(torch, smi):
    """Phase 17 (c): one ``FedML_FedAvg_distributed`` call on the card
    over the one-rank mesh (LR on LEAF synthetic, 2 rounds)."""
    from fedml_tpu_torch.compat import FedML_FedAvg_distributed, FedML_init
    from fedml_tpu_torch.data.synthetic import load_synthetic_federated
    from fedml_tpu_torch.models.linear import LogisticRegression

    comm, rank, world = FedML_init()
    ds = load_synthetic_federated(client_num=4, n_train=400, n_test=80,
                                  seed=0)
    args = types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=2,
        epochs=1, batch_size=16, lr=0.3, wd=0.0, client_optimizer="sgd",
        frequency_of_the_test=100, seed=0, class_num=ds[7], mesh=1)
    x = ds[2]["x"]
    api = FedML_FedAvg_distributed(
        rank, world, None, comm, LogisticRegression(x.shape[1], ds[7]),
        ds[0], ds[2], ds[3], ds[4], ds[5], ds[6], args)
    acc = api.evaluate_global()["Test/Acc"]
    if (api.round_idx != 2 or api.device.type != "cuda" or api.mesh is None
            or not 0.0 <= acc <= 1.0):
        fail(f"compat: round {api.round_idx} on {api.device}, acc {acc}")
    print(f"a15 compat rank={rank} world={world} rounds={api.round_idx} "
          f"test_acc={acc} card={smi}", flush=True)


def phase_a15(torch, grouped_conv, fa, smi):
    """Phase 17: the long-context main at T 512, the client-sharded
    rounds on a one-rank NCCL mesh and the compat call; returns the
    attention launches of the main's steps, B1's of the sharded lanes
    and the T 512 times."""
    t0 = time.time()
    attn, times = _a15_longcontext(torch, fa, smi)
    b1 = _a15_mesh_round(torch, grouped_conv, smi)
    _a15_compat(torch, smi)
    print(f"a15 phase_s={time.time() - t0:.1f} card={smi}", flush=True)
    return {"attention": attn, "b1": b1, "t512": times}


#: phase 18's budget, in seconds of command time
A15B_BUDGET_S = 60
#: phase 18's batch (one chunk: 8 clients x batch 4) and microbatches
A15B_BATCH, A15B_MICRO = 32, 4
#: a model-parallel step against the plain unsharded step from the same
#: weights (SGD lr 0.1, bf16 compute over fp32 parameters): the loss
#: relative to itself, and each leaf's largest gap from the plain step
#: relative to that leaf's own largest move (the worst leaf is held). On
#: one rank tp's and ep's collectives are copies, so their steps differ
#: from the plain step only in the order of bf16 roundings (ep applies
#: the gate after the expert combine); pp splits the batch into
#: microbatches, so its products see other shapes. A leaf that loses
#: one microbatch's gradient, or gets it twice, is off by a share of its
#: own move: phase 18 plants that fault (the last microbatch's gradient
#: dropped) and fails unless every leaf of it reads above pp's bound.
#: Readings on an H100 (worst leaf): tp 1.0e-5, ep 1.4e-4, pp 1.3e-2;
#: the planted fault's least leaf 0.27; every loss gap 0.0
A15B_TOL = {"tp": {"loss": 1e-5, "leaf": 1e-4},
            "pp": {"loss": 1e-5, "leaf": 5e-2},
            "ep": {"loss": 1e-5, "leaf": 1e-3}}


def _leaf_gaps(new, want, init):
    """``{leaf: gap / move}``: each leaf's largest gap from the plain
    step's parameters over its largest move from the initial ones (0
    where neither moved)."""
    out = {}
    for k in want:
        gap = float((new[k].float() - want[k].float()).abs().max())
        move = float((want[k].float() - init[k].float()).abs().max())
        out[k] = gap / move if move > 0 else (0.0 if gap == 0 else math.inf)
    return out


def _a15b_check(kind, label, new, loss, want, want_loss, init, extra=None):
    """One model-parallel step against the plain one; fails past
    ``A15B_TOL[kind]``."""
    ratios = _leaf_gaps(new, want, init)
    worst = max(ratios, key=ratios.get)
    loss_gap = abs(float(loss) - want_loss) / abs(want_loss)
    row = {"loss": float(loss), "plain_loss": want_loss,
           "loss_rel_gap": loss_gap, "worst_leaf": worst,
           "leaf_gap_over_move": ratios[worst], "leaves": len(ratios),
           **(extra or {})}
    print(f"a15b {label} " + json.dumps(row), flush=True)
    tol = A15B_TOL[kind]
    if not (loss_gap <= tol["loss"] and ratios[worst] <= tol["leaf"]):
        fail(f"a15b {label} past A15B_TOL[{kind!r}]: {row}")


def _a15b_dropped_microbatch(torch, model, init, idx, tgt, rows):
    """The plain step (SGD lr 0.1) from ``init`` with the gradient of the
    batch's last ``rows`` rows dropped and the loss still the whole
    batch's mean: what a GPipe step computes when one microbatch's
    backward is lost."""
    dev = next(iter(init.values())).device
    ref = {k: p.clone().requires_grad_(True) for k, p in init.items()}
    idx, tgt = (torch.as_tensor(a, device=dev).long() for a in (idx, tgt))
    lp = torch.log_softmax(model.apply_params(ref, idx).float(), dim=-1)
    mask = (tgt >= 0).float()
    nll = -lp.gather(-1, tgt.clamp(min=0)[..., None])[..., 0]
    keep = torch.ones_like(mask)
    keep[-rows:] = 0.0
    loss = (nll * mask * keep).sum() / mask.sum()
    grads = torch.autograd.grad(loss, list(ref.values()))
    return {k: ref[k].detach() - 0.1 * g for k, g in zip(ref, grads)}


def _a15b_steps(torch, fa):
    """Phase 18 (a): one tp, one pp and one ep step on one-rank meshes,
    each against the plain unsharded step; returns pp's launches."""
    import numpy as np

    from fedml_tpu_torch.models.moe import MoETransformerLM
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel import expert_parallel as ep
    from fedml_tpu_torch.parallel import pipeline_parallel as pp
    from fedml_tpu_torch.parallel import tensor_parallel as tp
    from fedml_tpu_torch.parallel.dryrun import unsharded_step
    from fedml_tpu_torch.parallel.seq_parallel import shift_targets

    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
    T, V = 80, 90
    idx = np.random.default_rng(18).integers(0, V, (A15B_BATCH, T))
    tgt = shift_targets(idx)
    lm = dict(vocab_size=V, n_layers=LM_LAYERS, n_heads=LM_D // ATTN_D,
              d_model=LM_D, max_len=T, dtype=torch.bfloat16)
    copy = lambda ps: {k: v.detach().clone() for k, v in ps.items()}  # noqa: E731

    mesh = tp.make_tp_mesh(1, 1)
    model = TransformerLM(attention_fn=tp.tp_attention(), **lm)
    init_fn, step_fn = tp.make_tp_lm_step(model, mesh, sgd)
    params, opt = init_fn(0)
    init = copy(params)
    new, _, loss = step_fn(params, opt, idx, tgt)
    want, want_loss = unsharded_step(model, init, idx)
    _a15b_check("tp", "tp mesh=(1,1)", copy(new), loss, want, want_loss,
                init)

    mesh = pp.make_pp_mesh(1)
    params, model = pp.init_pp_params(mesh, 0, **lm)
    init = pp.unstack_pp_params(pp.gather_pp_params(params, mesh))
    prep_fn, step_fn = pp.make_pp_lm_step(model, mesh, n_micro=A15B_MICRO)
    batch = prep_fn(idx, tgt)
    opt = sgd(pp.pp_leaves(params))
    for name in fa.launches:
        fa.launches[name] = 0
    new, _, loss = step_fn(params, opt, *batch)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    if set(launches.values()) != {LM_LAYERS * A15B_MICRO}:
        fail(f"a15b pp: attention launches {launches}, want "
             f"{LM_LAYERS} layers x {A15B_MICRO} microbatches each")
    want, want_loss = unsharded_step(model, init, idx)
    _a15b_check("pp", f"pp stages=1 n_micro={A15B_MICRO}",
                pp.unstack_pp_params(pp.gather_pp_params(new, mesh)), loss,
                want, want_loss, init, {"launches": launches})
    # the planted fault: every leaf of a step that lost one microbatch's
    # gradient must read past pp's bound
    faulty = _leaf_gaps(_a15b_dropped_microbatch(
        torch, model, init, idx, tgt, A15B_BATCH // A15B_MICRO), want, init)
    least = min(faulty, key=faulty.get)
    row = {"least_leaf": least, "leaf_gap_over_move": faulty[least],
           "bound": A15B_TOL["pp"]["leaf"]}
    print("a15b pp_fault dropped_microbatch " + json.dumps(row), flush=True)
    if faulty[least] <= A15B_TOL["pp"]["leaf"]:
        fail(f"a15b pp: a dropped microbatch passes the bound: {row}")

    mesh = ep.make_ep_mesh(1, 1)
    model = MoETransformerLM(vocab_size=V, max_len=T, dtype=torch.bfloat16)
    init_fn, step_fn = ep.make_ep_lm_step(model, mesh, sgd)
    params, opt = init_fn(0)
    init = copy(params)
    new, _, loss = step_fn(params, opt, idx, tgt)
    want, want_loss = unsharded_step(model, init, idx, ep.MOE_AUX_WEIGHT)
    _a15b_check("ep", f"ep mesh=(1,1) experts={model.n_experts}", copy(new),
                loss, want, want_loss, init)
    return launches


def _a15b_scripts(smi):
    """Phase 18 (b): the measurement scripts in-process at cut sizes,
    each holding its own checks; B2-B4 and B1 must launch, and every
    record must come from the card."""
    import tempfile

    from fedml_tpu_torch.ops import grouped_conv
    from fedml_tpu_torch.scripts import (bench_gkt, bench_lane_conv,
                                         bench_lm, convergence,
                                         hw_smoke_flash, profile_lane_step)

    def on_card(name, rec):
        if rec.get("platform") != "gpu" or not rec.get("power_limit_w"):
            fail(f"a15b {name}: not a card's record: {rec}")

    rec = bench_lm.main(["--n_layers", "2", "--repeats", "3", "--inner",
                         "3"])
    on_card("bench_lm", rec)
    if not (min(rec["attention_launches_per_step"].values()) > 0
            and 0 < rec["mfu"] < 1):
        fail(f"a15b bench_lm: {rec}")
    print(f"a15b script=bench_lm ms_per_step={rec['ms_per_step']} "
          f"mfu={rec['mfu']} card={smi}", flush=True)
    rows = bench_lane_conv.main(["--cands", "pallas,packed", "--inner", "5",
                                 "--repeats", "3"])
    b1 = [r["b1_launches"] for r in rows
          if r["cand"] == "pallas" and r["pass"] == "fwd+bwd"]
    if len(rows) != 12 or len(b1) != 3 or min(b1) == 0:
        fail(f"a15b bench_lane_conv: {len(rows)} rows (want 3 stages x 2 "
             f"candidates x 2 passes), B1 launches {b1}")
    print(f"a15b script=bench_lane_conv rows={len(rows)} card={smi}",
          flush=True)
    rec = hw_smoke_flash.main([])
    on_card("hw_smoke_flash", rec)
    print(f"a15b script=hw_smoke_flash launches="
          f"{json.dumps(rec['launches'])} card={smi}", flush=True)

    b1 = grouped_conv.launches
    ms = profile_lane_step.main(["--lanes", "2", "--batch", "8",
                                 "--repeats", "2"])
    b1 = grouped_conv.launches - b1
    if (len(ms) != 7 or not all(0 < v < math.inf for v in ms.values())
            or b1 == 0):
        fail(f"a15b profile_lane_step: {ms}, B1 launches {b1}")
    print(f"a15b script=profile_lane_step rows={len(ms)} b1_launches={b1} "
          f"card={smi}", flush=True)
    rec = bench_gkt.main(["--tiny", "--rounds", "1", "--clients", "2"])
    on_card("bench_gkt", rec)
    if not (rec["value"] > 0 and math.isfinite(rec["train_acc_last"])):
        fail(f"a15b bench_gkt: {rec}")
    print(f"a15b script=bench_gkt round_s={rec['value']} card={smi}",
          flush=True)
    # a run check at a cut size: 3 rounds are no plateau, so the
    # agreement bound is open here
    with tempfile.TemporaryDirectory() as out:
        rec = convergence.main([
            "--rounds", "3", "--tail", "2", "--clients", "2", "--n_train",
            "64", "--image", "8", "--depth", "8", "--tol", "1.0",
            "--configs", "bf16_lanes,fp32_flat", "--outdir", out])
        curves = {r["name"]: sum(1 for _ in open(
            os.path.join(out, r["name"] + ".jsonl")))
            for r in rec["results"]}
    on_card("convergence", rec)
    if (curves != {"bf16_lanes": 3, "fp32_flat": 3}
            or not all(math.isfinite(r["final_loss"])
                       for r in rec["results"])):
        fail(f"a15b convergence: curves {curves}, {rec['results']}")
    print(f"a15b script=convergence curves={json.dumps(curves)} "
          f"card={smi}", flush=True)


def phase_a15b(torch, fa, smi):
    """Phase 18: tp, pp and ep steps on one-rank meshes, then the
    measurement scripts; returns pp's attention launches."""
    t0 = time.time()
    launches = _a15b_steps(torch, fa)
    _a15b_scripts(smi)
    print(f"a15b phase_s={time.time() - t0:.1f} budget_s={A15B_BUDGET_S} "
          f"card={smi}", flush=True)
    return launches


FEDLINT_BUDGET_S = 60
#: the reference's whole rule catalog, every pass on
FEDLINT_RULES = 40


def phase_fedlint(smi):
    """Phase 19: the port's fedlint over the port, with no baseline and
    every one of its ``FEDLINT_RULES`` rules on (the per-module rules and
    the five project-wide passes), in a subprocess: exit 0 and 0
    findings within ``FEDLINT_BUDGET_S``."""
    import re

    from fedml_tpu_torch.analysis import RULES

    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.analysis",
         "fedml_tpu_torch", "--baseline", "", "--format", "json",
         "--max-seconds", str(FEDLINT_BUDGET_S)],
        cwd=HERE, capture_output=True, text=True,
        timeout=3 * FEDLINT_BUDGET_S)
    wall_s = time.time() - t0
    try:
        total = json.loads(proc.stdout)["summary"]["total"]
    except (ValueError, KeyError) as e:
        fail(f"fedlint: no JSON report ({e}): rc {proc.returncode}, "
             f"{proc.stderr[-2000:]}")
    lint_s = re.search(r"wall time ([0-9.]+)s", proc.stderr)
    if len(RULES) != FEDLINT_RULES:
        fail(f"fedlint: {len(RULES)} rules, the reference's catalog has "
             f"{FEDLINT_RULES}")
    if proc.returncode != 0 or total != 0 or lint_s is None:
        fail(f"fedlint: rc {proc.returncode}, {total} finding(s): "
             f"{proc.stdout[:2000]} {proc.stderr[-2000:]}")
    print(f"fedlint findings={total} rules={len(RULES)} "
          f"lint_s={lint_s.group(1)} subprocess_s={wall_s:.1f} "
          f"budget_s={FEDLINT_BUDGET_S} card={smi}", flush=True)


#: phase 20: its budget, and the join timeout after which the FL141
#: replay must have hung (the four clients' round-0 LM updates take a
#: few seconds on the card; phase 11's TCP rounds took 2.2-4.3 s)
MC_BUDGET_S, MC_JOIN_S = 120, 20.0

#: the model checker's minimal server x 2 clients protocol (the
#: reference's tests/test_modelcheck.py fixture, with the port's
#: imports): the report handler only logs, so the fault-free round 0
#: never folds -- one FL141 counterexample
MC_FIXTURE = (
    "import logging\n"
    "from fedml_tpu_torch.core.managers import ClientManager, ServerManager\n"
    "from fedml_tpu_torch.core.comm.base import MSG_TYPE_PEER_LOST\n"
    "from fedml_tpu_torch.core.message import Message\n"
    "MSG_SYNC = 'sync'\n"
    "MSG_REPORT = 'report'\n"
    "class Srv(ServerManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_REPORT,\n"
    "                                              self._on_report)\n"
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_lost)\n"
    "    def open_round(self):\n"
    "        self.send_message(Message(MSG_SYNC, 0, 1))\n"
    "    def _on_report(self, msg):\n"
    "        logging.debug('report from %s', msg.get_sender_id())\n"
    "    def _on_lost(self, msg):\n"
    "        logging.warning('rank %s lost', msg.get_sender_id())\n"
    "        self.cohort.discard(msg.get_sender_id())\n"
    "class Cli(ClientManager):\n"
    "    def register_message_receive_handlers(self):\n"
    "        self.register_message_receive_handler(MSG_SYNC,\n"
    "                                              self._on_sync)\n"
    "        self.register_message_receive_handler(MSG_TYPE_PEER_LOST,\n"
    "                                              self._on_cli_lost)\n"
    "    def _on_sync(self, msg):\n"
    "        self.send_message(Message(MSG_REPORT, 1, 0))\n"
    "    def _on_cli_lost(self, msg):\n"
    "        self.finish()\n")


def _mc_counterexamples(src):
    """Every counterexample the port's model checker finds over ``src``
    (its fair and its faulted exploration of each server x client
    pair)."""
    import ast

    from fedml_tpu_torch.analysis import modelcheck as mc
    from fedml_tpu_torch.analysis.protocol import ProtocolIndex

    index = ProtocolIndex()
    index.add_module("fedml_tpu_torch/core/fsm_fake.py", ast.parse(src))
    out = []
    for server, client, drive, replies in mc.discover_pairs(
            mc.compile_specs(index)):
        fair, full, _events = mc.verify_pair(server, client, drive, replies)
        out.extend(fair.counterexamples + full.counterexamples)
    return out


def _mc_run(fa, shards, train, run):
    """``run(trainer)`` with the attention counters set to 0 just before
    and read just after, and every trainer call recorded by rank: each of
    B2-B4 must have launched once a layer a step of the recorded calls.
    Returns run's result (or the exception it raised), the calls, the
    launches and the seconds."""
    import threading

    calls, lock = {}, threading.Lock()

    def recording(params, round_idx, rank):
        out = train(params, round_idx, rank)
        with lock:
            calls[rank] = calls.get(rank, 0) + 1
        return out

    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.time()
    try:
        out = run(recording)
    except Exception as e:  # the replay's hang is its expected result
        out = e
    secs = time.time() - t0
    launches = dict(fa.launches)
    expect = _cp_expected_launches(shards, calls)
    if launches != {"fwd": expect, "dq": expect, "dkv": expect}:
        fail(f"modelcheck: attention launches {launches}, the recorded "
             f"trainer calls {calls} give {expect} each")
    return out, dict(sorted(calls.items())), launches, secs


def _mc_clients_gone(label, timeout=30.0):
    """The run's client threads have all ended (a hung run's STOP wave
    must release them)."""
    import threading

    deadline = time.time() + timeout
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("res-")]
        if not alive:
            return
        time.sleep(0.2)
    fail(f"modelcheck {label}: threads {alive} outlived the run")


def phase_modelcheck(torch, fa, smi, cp):
    """Phase 20: the model checker's counterexamples replayed on the card
    (budget ``MC_BUDGET_S``). (a) The port's model checker, over the
    reference's minimal server x 2 clients fixture, finds exactly one
    FL141 counterexample, whose trace compiles to a plan with no rules.
    (b) That plan replays against ``run_tcp_fedavg`` with
    ``ResilientFedAvgServer._on_report`` made inert (it records the
    delivery and folds nothing) while phase 11's four clients train the
    LM flagship on the card through B2-B4: every report arrives, round 0
    never folds, and the run raises ``TimeoutError`` naming the hang
    after ``MC_JOIN_S``. (c) A faulted trace's kill compiles to
    ``(FaultRule("kill", rank=2, nth=1),)``; 2 rounds under it at
    ``quorum`` 0.3 and phase 11's deadline finish degraded with one
    client dropped. B2-B4 are counted exactly in (b) and (c) against the
    trainer calls recorded in each run."""
    import numpy as np

    from fedml_tpu_torch.analysis import modelcheck as mc
    from fedml_tpu_torch.resilience import (FaultRule, RoundPolicy,
                                            integration, run_tcp_fedavg)

    t0 = time.time()
    # (a) the model side
    cexs = [c for c in _mc_counterexamples(MC_FIXTURE) if c.code == "FL141"]
    if len(cexs) != 1 or not any("inert" in s for s in cexs[0].trace):
        fail(f"modelcheck: {len(cexs)} FL141 counterexample(s), expected "
             f"one with an inert delivery: {[c.trace for c in cexs]}")
    plan = mc.trace_to_fault_plan(cexs[0].trace)
    if plan.rules != ():
        fail(f"modelcheck: the fault-free FL141 trace compiled to rules "
             f"{plan.rules}")
    print(f"modelcheck model=fl141 counterexamples={len(cexs)} trace="
          f"{json.dumps(cexs[0].trace)} plan_rules={len(plan.rules)} "
          f"card={smi}", flush=True)

    # (b) the replay: the same mutation on the real server hangs round 0
    original = integration.ResilientFedAvgServer._on_report
    delivered = []

    def inert_on_report(self, msg):
        delivered.append(int(msg.get_sender_id()))

    integration.ResilientFedAvgServer._on_report = inert_on_report
    try:
        err, calls, launches, secs = _mc_run(
            fa, cp.shards, cp.train, lambda train: run_tcp_fedavg(
                CP_WORLD, 1, RoundPolicy(), cp.init, trainer=train,
                fault_plan=plan, timeout=600.0, join_timeout=MC_JOIN_S))
    finally:
        integration.ResilientFedAvgServer._on_report = original
    _mc_clients_gone("replay")
    if not (isinstance(err, TimeoutError) and "hung" in str(err)
            and "round 0" in str(err)):
        fail(f"modelcheck replay: expected a TimeoutError naming the hung "
             f"round 0, got {err!r}")
    every = list(range(1, CP_WORLD))
    if sorted(delivered) != every or calls != {r: 1 for r in every}:
        fail(f"modelcheck replay: reports delivered {delivered}, trainer "
             f"calls {calls}; every client should report round 0 once")
    print(f"modelcheck run=fl141_replay join_timeout_s={MC_JOIN_S} s="
          f"{secs:.3f} error={json.dumps(str(err))} delivered="
          f"{sorted(delivered)} trainer_calls={json.dumps(calls)} "
          f"launches={json.dumps(launches)} card={smi}", flush=True)

    # (c) a compiled kill, live on the control plane
    plan = mc.trace_to_fault_plan(
        ["deliver sync server->client1", "kill client1"], seed=5)
    if plan.rules != (FaultRule(action="kill", rank=2, nth=1),):
        fail(f"modelcheck kill: compiled {plan.rules}")
    srv, calls, launches, secs = _mc_run(
        fa, cp.shards, cp.train, lambda train: run_tcp_fedavg(
            CP_WORLD, 2, RoundPolicy(deadline_s=CP_DEADLINE_S, quorum=0.3),
            cp.init, trainer=train, fault_plan=plan, timeout=600.0,
            join_timeout=600.0))
    _mc_clients_gone("kill")
    if isinstance(srv, Exception):
        fail(f"modelcheck kill: the run raised {srv!r}")
    if (srv.failed is not None or len(srv.history) != 2
            or srv.counters["clients_dropped"] != 1):
        fail(f"modelcheck kill: failed={srv.failed} history "
             f"{len(srv.history)} counters {srv.counters}")
    for h in srv.history:
        if not all(np.isfinite(v).all() for v in h.values()):
            fail("modelcheck kill: non-finite parameters")
    print(f"modelcheck run=compiled_kill rules={plan.rules} s={secs:.3f} "
          f"rounds={len(srv.history)} reporting={srv.reporting_log} "
          f"counters={json.dumps(srv.counters)} trainer_calls="
          f"{json.dumps(calls)} launches={json.dumps(launches)} "
          f"card={smi}", flush=True)
    phase_s = time.time() - t0
    if phase_s > MC_BUDGET_S:
        fail(f"modelcheck: {phase_s:.1f} s, over its {MC_BUDGET_S} s "
             "budget")
    print(f"modelcheck phase_s={phase_s:.1f} budget_s={MC_BUDGET_S} "
          f"card={smi}", flush=True)


def _device_us(torch, prof):
    """Device time (us) by kernel name of a ``torch.profiler`` run."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    return by_name


def _profile_round(torch, api, label):
    """One round of ``api`` under ``torch.profiler``: device time by
    kernel, the device's busy share of the round and, of the LM, the
    attention kernels' time and share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        api.train_one_round()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = _device_us(torch, prof)
    busy = sum(by_name.values())
    print(f"profile {label} round wall_us={wall_us:.0f} "
          f"device_busy_us={busy:.0f} busy_share={busy / wall_us:.4f} "
          f"kernels={len(by_name)}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"profile {label} kernel us={us:.0f} share={us / busy:.4f} "
              f"{name[:110]}", flush=True)
    if label == "lm":
        from fedml_tpu_torch.ops.flash_attention import MMA_KERNELS

        # the bf16 attention kernels by the name the profiler gives them
        attn = {k: sum(us for n, us in by_name.items() if f"::{fn}<" in n)
                for k, fn in MMA_KERNELS.items()}
        print(f"profile lm attention_us {json.dumps(attn)} share="
              f"{sum(attn.values()) / busy:.4f}", flush=True)


def _profile_attention_bwd(torch, fa):
    """The whole attention backward at the flagship launch (bf16 causal,
    strided q, k, v) under ``torch.profiler``, ours and SDPA's: device us
    a call by kernel, mean of 20 calls with warm caches. Also the floor
    of ``timed_ms``: its reading for a one-element fill."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    Bq, T, C = 32, 80, ATTN_H * ATTN_D
    qkv = torch.randn(Bq, T, 3 * C, generator=gen, device=dev
                      ).to(torch.bfloat16)
    q, k, v = (qkv[..., j * C:(j + 1) * C].reshape(Bq, T, ATTN_H, ATTN_D)
               .detach().requires_grad_(True) for j in range(3))
    do = torch.randn(Bq, T, ATTN_H, ATTN_D, generator=gen, device=dev
                     ).to(torch.bfloat16)
    out = fa.flash_attention(q, k, v, True)
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    out_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    one = torch.empty(1, device=dev)
    print(f"profile timer_floor_ms {timed_ms(one.zero_, flush)}", flush=True)
    for label, fn in (
            ("flash_attention", lambda: torch.autograd.grad(
                out, (q, k, v), do, retain_graph=True)),
            ("sdpa", lambda: torch.autograd.grad(
                out_s, (qs, ks, vs), do.transpose(1, 2),
                retain_graph=True))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        by_name = _device_us(torch, prof)
        print(f"profile attention_bwd {label} device_us_per_call="
              f"{sum(by_name.values()) / 20:.2f} " + json.dumps(
                  {n[:90]: round(us / 20, 2) for n, us in sorted(
                      by_name.items(), key=lambda kv: -kv[1])}), flush=True)


def _profile_dw(torch, grouped_conv):
    """B1 at each main-path shape under ``torch.profiler``: device us a
    call by kernel (the products and the split-K pass), mean of 10 calls
    with warm caches."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, ci, co, hw, _ in DW_SHAPES:
        x, dy = (torch.randn((B, L * c, hw, hw), generator=gen, device=dev
                             ).to(torch.bfloat16) for c in (ci, co))
        for _ in range(3):
            grouped_conv.grouped_conv_dw(x, dy, L, 3, 3, (1, 1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                grouped_conv.grouped_conv_dw(x, dy, L, 3, 3, (1, 1))
            torch.cuda.synchronize()
        by_name = _device_us(torch, prof)
        print(f"profile dw {label} " + json.dumps(
            {n[:60]: round(us / 10, 2) for n, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])}), flush=True)


def phase_profile(torch, fa, grouped_conv):
    """``--profile``: B1's kernels at each shape; the attention
    backward's kernels, ours and SDPA's; one ResNet round per lane
    lowering after a warm-up round (round time), then one ``pallas``
    ResNet round and one LM round (after two warm-up rounds) under
    ``torch.profiler``."""
    _profile_dw(torch, grouped_conv)
    _profile_attention_bwd(torch, fa)
    for lowering in ("blockdiag", "bgc", "auto", "pallas"):
        api = build_api(torch, lowering)
        api.train_one_round()
        r = api.train_one_round()
        print(f"profile lowering={lowering} lane_steps={api._last_trip} "
              f"round_time_s={r['round_time_s']}", flush=True)
    _profile_round(torch, api, "resnet")
    api, _ = build_lm_api(torch)
    for _ in range(2):
        r = api.train_one_round()
    print(f"profile lm round_time_s={r['round_time_s']}", flush=True)
    _profile_round(torch, api, "lm")


def main():
    # deterministic cuBLAS, which torch.use_deterministic_algorithms
    # needs for the experiment phase's comparison of round modes; it must
    # be set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from fedml_tpu_torch.ops import _build, grouped_conv
    from fedml_tpu_torch.ops import flash_attention as fa

    # fp32 products in full fp32 for the fp32 reference checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    reports = _build.build_all([grouped_conv.LIBRARY, fa.LIBRARY])
    for name, report in reports.items():
        print(f"== {name}\n{report}", file=sys.stderr)
    print(f"build_s {time.time() - t0:.1f}", flush=True)
    print("mma_kernels " + json.dumps(mma_kernel_usage(
        _build, fa, grouped_conv, reports)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    rows = phase_kernels(torch, grouped_conv)
    attn_times, attn_errs = phase_attention(torch, fa)
    launches = phase_main_path(torch, grouped_conv)
    attn_launches = phase_lm_main_path(torch, fa)
    phase_bench(grouped_conv, fa)
    phase_experiment_main(torch, fa, grouped_conv, smi)
    phase_fedavg_family(torch, fa, smi)
    phase_resilience_moe(torch, fa, smi)
    phase_massive_async(torch, smi)
    phase_compression(torch, fa, smi)
    cp = phase_control_plane(torch, fa, smi)
    phase_eventloop(torch, fa, smi, cp)
    phase_zoo(torch, grouped_conv, fa, smi)
    phase_serverless(torch, grouped_conv, fa, smi)
    phase_a14c(torch, grouped_conv, fa, smi)
    phase_tooling(torch, fa, smi)
    a15 = phase_a15(torch, grouped_conv, fa, smi)
    phase_a15b(torch, fa, smi)
    phase_fedlint(smi)
    phase_modelcheck(torch, fa, smi, cp)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, fa, grouped_conv)

    per_step = lambda key: sum(r[key] * r["convs_per_step"] for r in rows)
    bytes_ms, ops_ms = per_step("bytes_ms"), per_step("ops_ms")
    kernels = [{
        "name": "grouped_conv_dw", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/grouped_conv_dw.cu",
        "replaces": "fedml_tpu/ops/pallas_grouped_conv.py:66",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times are per training step: the 53 stride-1 dW calls of one
        # ResNet-56 step at L=8, B=64 (shape times x convs per step)
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_step("library_ms")}]
    # times per launch at the LM flagship's attention launch
    for name, line in (("fwd", 123), ("dq", 241), ("dkv", 255)):
        t = attn_times[name]
        kernels.append({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/pallas_attention.py:{line}",
            "launches": attn_launches[name],
            "max_abs_err": attn_errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the fp32 kernels (3xTF32), a launch at main_longcontext's [32, 512,
    # 4, 64] causal, launches over its fp32 steps (phase 17 (a))
    for name, line in (("fwd", 123), ("dq", 241), ("dkv", 255)):
        t = a15["t512"][("longcontext_T512", "fp32", name)]
        kernels.append({
            "name": f"flash_attention_{name}_fp32", "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/pallas_attention.py:{line}",
            "launches": a15["attention"]["fp32"][name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the chunked route above D 128, a launch at main_longcontext
    # --d_model 1024 --n_heads 4 ([32, 512, 4, 256] causal), launches over
    # that main's steps in each dtype (phase 17 (a))
    for dtype, suffix in (("bf16", ""), ("fp32", "_fp32")):
        for name, line in (("fwd", 123), ("dq", 241), ("dkv", 255)):
            t = a15["t512"][("longcontext_D256", dtype, name)]
            kernels.append({
                "name": f"flash_attention_{name}_wide{suffix}",
                "route": "cuda",
                "source": "fedml_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"fedml_tpu/ops/pallas_attention.py:{line}",
                "launches": a15["attention"][f"{dtype}_D256"][name],
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
