#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

The main paths run the flagship configuration (``bench_config_large``
with ``flash=True``: d_model 2048, 16 query heads over 4 KV heads,
head_dim 128, 8 layers, 32768-token vocab), random weights from seed
0: paged continuous-batching serving (bf16 weights and activations),
then training (fp32 parameters, bf16 activations, AdamW, batches of 8
sequences of 1025 tokens). Phases, each of which exits non-zero when
it fails (nothing is caught and ignored):

1. build  -- compile every ``kind_tpu_sim_torch/csrc/*.cu`` with nvcc
   for sm_90a into ``build/kind_tpu_sim_torch/``;
2. kernels -- each CUDA kernel at its path's shapes against its plain
   PyTorch version on the same bf16 inputs (computed in fp32), then
   timed with CUDA events (median of 30 launches after warm-up, L2
   flushed before each; the events hold the host's enqueue time where
   it outlasts the flush) beside the plain version and,
   where one PyTorch call computes the same function, that call: the flash
   forward at the serving prefill shape and at the admission shapes (a
   wave of 8 prompts in the 1024-token bucket, one 4096-token bucket),
   the paged decode kernels at the serving decode shape, at the
   flagship's full context (1024 positions a slot) and at the realistic
   stream's table width of 64 with two slots sharing their first 16
   blocks, and the flash backward's dq and dk/dv kernels at the
   training shape, fed the forward kernel's out and lse as training
   feeds them (the forward checked and timed there too); then the
   exact int8 product at every W8A8 shape of the flagship (decode's
   weights held K-major, the readout against the embedding read in
   place, a verify window's 40 rows, the int8 cache's scores and values
   read in place, w_up over an admission wave, prefill's w_up and
   w_down), a ragged K and the largest |sum|, through the wrapper (its
   route asserted) and through every route that takes the shape
   (``wgmma``, ``csrc/int8_matmul_tc.cu``; ``gemv``,
   ``csrc/int8_gemv.cu``; ``dp4a``, ``csrc/int8_matmul.cu``), each
   bitwise equal to its plain version, the routes timed in turns beside
   it, ``torch._int_mm`` and the dequant product;
3. small  -- a tiny fp32 model served on the card (kernel tier) must
   emit the streams the CPU plain path emits: under pool pressure, with
   paged prefix hits, with dense chunked prefill, as a wave of 5,
   through both speculative engines (prompt lookup, a one-layer draft
   model, paged under pool pressure and with chunked prefill) and the
   overlapped dense grid; then ``engines_report`` and
   ``serving_report`` on the card; then a tiny int8 snapshot (W8A8,
   int8 KV) through the dense grid and the paged gather tier, and a
   tiny 4-expert MoE through the dense grid, the paged kernel tier and
   the speculative grid and as a wave of 5 whose first tokens equal
   each prompt admitted alone. The streams include dense prefix hits
   (a stored head restored into two slots, a wave of two misses); each
   stream's admission graphs captured and replayed on the card number
   the CPU run's distinct admission programs and their repeats;
4. serve  -- 16 greedy requests (prompts of 192/224/256 tokens, 128
   new tokens each) through ``PagedServingEngine(paged_kernel=True)``
   at full width, with the kernels' launch counters zeroed just before
   and read just after; then the same stream on the gather tier;
   4b. realistic -- the realistic stream of ``profile_serving`` (28
   requests with 224-3072-token prompts and prefix families; prefix
   caching, admission waves, a pool under demand) on the kernel tier,
   counters zeroed just before and read just after: hits, preemption,
   shared blocks never written, no leaked block, launch counts,
   ``warm_admission``'s captures; then a cut stream with the admission
   graphs and again with eager admission (``admission_runs``: streams
   equal, logprobs within 1e-4, admission wall both ways);
   4c. hit against cold -- the families' members through prefix hits
   against the same members cold (first-token logprobs and logits),
   and the same comparison read on faulty suffix forwards, which must
   fail it;
   4d. long prompt -- the dense long-prompt stream (8 x 224 tokens, then
   768) with and without chunked prefill, each again through
   ``admission_runs``;
   4e. speculative -- solo ``speculative_generate`` (8 x 256 tokens, 256
   new, k 4; its prefill and verify step graphs) against
   ``greedy_generate`` and against the same call eager (tokens and
   steps equal; tok/s both ways), and solo ``draft_model_generate``
   (a random 2-layer draft) the same way; ``SpeculativeServingEngine``
   and ``PagedSpeculativeServingEngine`` (k 4, 4 windows a round) on
   phase 4's stream, held to phase 4's streams; the reference bench's
   motif stream at 64 windows a round (512 new tokens) beside the
   bench's dense twin (chunk 256, overlapped). Tokens a verify window,
   tok/s, TTFT, e2e; flash launches n_layers x prefill dispatches, all
   on the tensor cores;
   4f. engine surface -- the dense grid (chunk 64 on phase 4's stream
   and one sampled request, chunk 8 on the bench's ``serving_rtt_bound``
   stream) and the
   speculative grid, sequential against ``overlap_rounds`` in turns:
   streams equal, tok/s and host syncs a round, none inside a
   dispatch; a slot failure on a busy slot of the paged kernel tier
   (the replay equal to phase 4, no block leaked, the recovery log's
   counts); a deadline (mid-stream and queued) and a ``max_queue``
   shed under an injected clock;
   4g. int8 -- solo decode as the reference bench runs it (batch 8,
   1024-token prompts, 512 new tokens) on bf16, W8A8 + int8 KV and
   dequant + int8 KV (first-step logits correlated > 0.99 with bf16's,
   every int8 launch counted: the prefill linears on ``wgmma``, every
   decode step's products on ``gemv``; each tier's prefill time, and a
   W8A8 step's int8 device time traced), ``serving_saturated_int8``
   beside the
   bf16 ``serving_saturated``, phase 4's stream on int8 pools (gather
   tier) and the kernel tier's refusal of them;
   4h. MoE -- the flagship with 4 experts: phase 4's stream through the
   paged kernel tier, the dense grid and the speculative grid, each
   first token held to its prompt admitted alone;
   4i. compiled rounds -- every engine's rounds as CUDA graph replays
   against the same engine's eager rounds, on phase 4's stream at the
   flagship's widths and 2 of its 8 layers: the dense grid, the paged
   gather and kernel tiers, the prompt-lookup grid, the paged
   speculative engine, the draft-model grid, W8A8 with the int8 KV
   cache and the MoE kernel tier, two graph runs and one eager run of
   each in turns (graph runs admit through the admission graphs, eager
   runs eagerly): streams equal, logprobs within 1e-4, the same
   launches in every run; graphs captured (rounds and admission),
   capture time, replays, tok/s, step wall and a traced round's device
   busy share for both paths;
5. small_train -- a tiny fp32 flash GQA model trains 5 AdamW steps on
   the card; losses and final parameters must match the same steps on
   the CPU plain path; then a tiny 4-expert MoE the same way (losses
   with the auxiliary term, the first step's gradients);
6. train  -- the flagship training workload of
   ``kind_tpu_sim_torch.profile_train`` at full width and depth, the
   compiled step (``train_twins``: its first step eager and captured,
   the rest replays) against the same steps eager from the same state:
   one warm-up step, then 5 timed steps with the launch counters zeroed
   just before; every loss finite, each flash kernel launched exactly
   n_layers x steps times, losses and parameters bitwise equal, step
   wall and peak memory both ways; then one flagship step with
   ``remat=True`` the same way, its peak device memory beside the plain
   step's, the flash forward launched twice per layer (forward and
   recompute);
   6b. MoE training -- the flagship with 4 experts the same way (phase
   6's graphs freed first), one warm-up and 3 timed steps: finite
   losses, the auxiliary term at least 0.99 x its weight, the flash
   kernels n_layers x steps each, step wall and peak memory beside the
   dense step's;
7. toolchain -- the kernel-toolchain gate ``toolchain_smoke`` on the
   card (the matmul, rms_norm and softmax kernels, each launched once),
   then each of the three at flagship width against its plain version,
   rms_norm and softmax also on edge cases (ragged row counts, the
   longest rows their new routes hold, -inf entries, rows their new
   routes refuse), timed beside its plain version and one PyTorch
   call;
8. train_smoke -- ``python -m kind_tpu_sim_torch train-smoke --steps 10
   --checkpoint-dir <tmp> --json`` in-process: data pipeline, train
   steps and the checkpoint/resume round trip on the card;
9. bench -- ``kind_tpu_sim_torch.bench.model_throughput(n_layers=2)``
   once, the reference bench's model block at the flagship's widths
   (``bench_config_large``, batch 8) and 2 of its 8 layers: the
   forward, the dense and flash train steps, the 4k-token forward and
   forward+backward, prefill and the compiled decode in bf16, W8A8 and
   dequant, and the serving matrix; with the launch
   counters zeroed just before and read just after. Its
   ``headline_numbers`` are printed on a line of their own and the whole
   result is written to ``build/chip_smoke_bench.json``. It fails
   on any ``_error`` key, a missing key the simulator's calibration
   needs, an MFU outside (0, 100], a ``roof_frac`` above 1.05, a graphed
   decode whose first chunk differs from the eager loop's, or a route
   that did not launch: the flash forward and backward (dq, dk/dv) on
   the tensor cores, split-KV paged attention, the int8 ``gemv`` and
   ``wgmma`` routes. The entries after the serving matrix are held too,
   each with its launches read at the bench's ``emit`` before and after
   it: ``paged_tier_micro`` (the tiers' tokens equal, a positive
   ratio, its kernel tier on split-KV exactly 4 runs x layers x chunk x
   chained chunks), ``serving_realistic`` (64 requests, preemptions and
   prefix-skipped tokens, no block in use once its prefix cache is
   emptied, its admissions' flash forward on the tensor cores and its
   decode on split-KV) and the solo ``speculative`` (at least one token
   a verify step, its prefill's flash forward on the tensor cores);
10. profile -- ``profiling.profile_flagship`` at the flagship config: the
   Chrome trace must carry the card's own events, and the top ops must
   be device kernels or copies;
11. parallel (run after 4i, while phase 4's streams and snapshot are
   at hand) -- the parallel layer on one card: the collective smokes at
   world size 1 on NCCL and on 4 gloo ranks, and which gloo collectives
   take CUDA tensors (each in a world of its own); phase 4's stream at
   the flagship's widths and 2 of its 8 layers through the dense engine
   at (data 2, model 2) and ('model', 4) and the paged gather tier at
   ('model', 2) on gloo ranks sharing the card, held by the split rule
   to the unsharded engine's streams at that depth, the first-step
   logits against unsharded, 0 paged-kernel launches and the flash
   forward on the tensor cores on every rank; the dense engine on an
   NCCL mesh of
   world size 1 (its rounds CUDA graphs, the collectives captured),
   bitwise against the unsharded graphed engine, and 3 compiled AdamW
   steps there bitwise against 3 eager ones; 3 AdamW steps of phase
   6's training at ('model', 2) and ('data', 2) and 2 of the 4-expert
   flagship at ('expert', 2) (batch 8), the losses within rtol 2e-2 of
   the unsharded steps', each rank's peak memory; the flash forward and
   backward and the int8 cache products at one rank's shapes against
   their plain versions, timed (the kernels line's ``sharded_shapes``).
13. entry points and pods -- ``python -m kind_tpu_sim_torch torch-smoke``
   at NCCL world size 1 and on 4 gloo ranks on CUDA tensors (ok, every
   warm run faster than the cold bring-up, one worker across the runs),
   and each pod's payload, taken from its generator in
   ``kind_tpu_sim_torch/manifests.py`` and run as a script on the card:
   the device-gate pod allocated 1 GPU (DEVICES OK, PLATFORM OK, PSUM
   OK) and allocated 2 (it must exit non-zero naming both counts), the
   multi-host payload as 1 replica x 1 GPU over tcp://127.0.0.1 (GLOBAL
   PSUM OK), the kernel pod built into ``build/kind_tpu_sim_torch/``
   (CUDA KERNEL OK); all six at once, beside no other phase (beside
   phase 11's training worlds they slowed its steps beyond their spread,
   ``tools/phase13_overlap.py``). The kernel pod's own
   kernel is then loaded from that build, held to ``torch.matmul`` and
   timed: the matmul row's ``pod`` entry (kernel table row 8);
14. simulator engine paths -- the chaos scenarios and the fleet that drive
   real engines (``kind_tpu_sim_torch/chaos.py``, ``fleet/``), each held
   to the reference's bar: ``fleet-preemption`` (a replica of two real
   engines preempted and restored under seeded traffic: streams equal to
   the fault-free run's, requests requeued, tail attainment recovered)
   and ``serving-slot-failure`` (a slot fails mid-stream: streams equal,
   one failure, a requeue) at the flagship's width with flash;
   ``preempt-train`` at the flagship's widths and 2 of its 8 layers, in
   the main thread (SIGTERM mid-step, a checkpoint at that step, the
   resumed losses bitwise the uninterrupted ones; the flash forward,
   dq and dk/dv each 2 layers x 16 steps on the tensor cores); the
   fleet command's fleet (64 requests, the tiny model in fp32) on the
   card against the same fleet and weights on the CPU, every completion
   equal; the fleet's control layers (the gray-failure detector,
   overload containment, the stock tenants, the audit lane at 0.3) over
   three flagship replicas at full width and depth with a slowed and a
   preempted replica, whose weight-free fields must equal the same
   fleet's of the tiny fp32 model on the CPU, with hedges issued,
   cancels of both outcomes, a quarantine restored through probes and
   audit copies that all agree; the scheduler-backed fleet (two flagship
   replicas placed as gangs on the default 4x8 inventory beside one
   llm0 training gang, the detector on, a degraded and healed link,
   node failures that evict a serving gang whose rebind preempts the
   training gang, a training preemption), whose weight-free fields
   (the scheduler's events and the training ledger included) must
   equal the same fleet's of the tiny fp32 model on the CPU, every
   time to routable at least bind_s + warm-up, the training gang done
   with a clean ledger, and the flash forward on the tensor cores at
   exactly 8 launches a prefill dispatch of the CPU twin; and, as
   processes started first, ``python -m kind_tpu_sim_torch fleet run``
   (also with ``--health --overload --tenancy --audit-frac 0.25``, and
   with ``--sched --train 1 --profile``) and ``chaos run --scenario all
   --include-slow`` at the reference's tiny configs, whose weight-free
   fields must equal the same runs' on the CPU (the profile section
   carrying the reference's keys; the chaos command's 28 scenarios, the
   reports of the 24 that do no device work but ``gray-straggler-grid``
   byte-equal to the same scenarios run in this process (the 15
   analytic ones, the four globe scenarios, the crash and hang worker
   grids, the control plane's ``flaky-exec``, ``device-flap`` and
   ``node-flap``), ``gray-straggler-grid`` held on its timing-free fields;
   ``zoo-swap-storm``'s verdict is the CPU's, ``ok: false`` on the
   H100's calibration, every other scenario but the straggler grid must
   be ok, and the chaos command's exit code must be 0 exactly when every
   verdict is); then (h) ``chaos run --scenario gray-straggler-grid
   --json`` as a process with nothing of this script beside it, whose
   wall-clock verdict must be ok and whose timing-free fields must equal
   the run in this process; and (i) ``globe run --json`` and ``globe
   trace`` (the default globe: three zones of one scheduler-backed cell,
   200 requests a zone), started with (d)'s processes, each exit 0 and
   its output byte-equal to the same command run in this process; and
   (j), started in the same pool once (d)'s ``chaos run`` has ended:
   ``globe run --json --shards 3`` (the sharded globe, its cells in
   three cold workers over the pool's shared-memory transport), whose
   output must be byte-equal to (i)'s
   ``globe run --json``; ``chaos fuzz --json --budget 12 --seed 0`` (the
   seeded fuzzer's campaign), exit 0, ok, and byte-equal to the same
   campaign run in this process; ``chaos fuzz --json --budget 1 --seed 0
   --inject-invariant-bug`` (the fuzzer's self-test), exit 0, the planted
   bug found and shrunk to exactly ``replica_preempt`` and
   ``slow_replica``; ``analysis replay --scenario globe-sharded --json``
   (the sharded and single-process globes alternating), exit 0 and ok;
   and the same with ``--inject-entropy-bug``, exit 1 and the first
   divergent event named. Each command's wall is logged. Each
   step logs its flash launches by route and its CUDA graph captures;
15. the calibrated simulator (host only, no kernel) -- (a) the cost
   model's ``calibrate`` over phase 9's bench model block (the
   flagship's widths at 2 of its 8 layers, from this card): every
   required key present, every rate positive, every error finite,
   printed labelled as 2 of 8 layers and never written over
   ``calibration/h100.json``; as processes at once: (b) ``python -m
   kind_tpu_sim_torch fleet calibrate --bench
   kind_tpu_sim_torch/calibration/bench_h100.json --out
   build/h100_check.json``, whose file must equal the committed
   ``h100.json`` byte for byte and whose exit code must be the 0.15
   rule's (1 while prefill's error is 0.243129); (c) ``fleet run
   --engine sim --disagg 2:2 --requests 200 --calibration
   kind_tpu_sim_torch/calibration/h100.json``, exit 0 and a report
   equal to the same run made in this process; (d) ``chaos run
   --scenario disagg-pool-loss``, ``CHAOS RUN OK``; (e) ``fleet run
   --engine sim --zoo --json`` (the model zoo on the h100 generation),
   exit 0 and a report equal to the same run made in this process; (f)
   ``chaos run --scenario zoo-swap-storm --json``, a report equal to the
   same scenario run in this process and an exit code that is its
   verdict's (1: the H100's decode bandwidth fails the 1.25 p99 bound);
   (g) ``fleet run --engine sim`` of 512 analytic replicas and 10000
   requests with the columnar mirror off and on (the knob), reports
   byte-equal, both walls printed; (h) the h100 generation's
   ``hbm_gib`` equal to this card's ``total_memory`` in GiB to two
   places; and, as processes started with (b)-(g): (i) ``sched run
   --manifest pods/tpu-serving-deployment.yaml --json``, (j) ``train run
   --manifest pods/tpu-batch-train-job.yaml --json`` and (k) ``health
   demo --json``, each exit 0 and its output byte-equal to the same
   command run in this process; in this process also ``train plan
   --json`` (the Young-Daly cadence among its rows), ``sched trace``
   (the seeded gangs) and a ``to_pod_manifest`` round trip of every
   traced gang; and, in the same pool, the tuner and the cluster
   layer (host only): (l) ``fleet tune --json --tune-workers 2``, its
   report byte-equal to the same search in this process with no
   workers; (m) ``globe tune --json --chaos-budget 1``, equal to the
   search in this process; (n) ``fleet tune --spec-out
   build/tune_winner.json``, then ``fleet tune --replay-spec`` of that
   file, whose metrics row must equal (l)'s winner's; (o) ``analysis
   replay --scenario tune --json``, exit 0 and ok; (p) ``create nvidia
   --runtime fake -v``, ``status --runtime fake --json`` and ``delete
   --runtime fake`` from ``build/cluster15``, each exit 0, the create's
   command stream (which patches ``nvidia.com/gpu`` capacity on each
   worker) and kind config equal to ``create`` run in this process;
   (q) ``chaos run --scenario`` ``flaky-exec``, ``device-flap`` and
   ``node-flap``, ``CHAOS RUN OK`` each. Under ``SIM15_MAX_S``
   seconds.

Phase 5 also trains the tiny model with ``remat=True`` on the card and
holds it to the plain run.

Every serving round and admission program on the card is a CUDA graph
replay (``kind_tpu_sim_torch/models/graphs.py``), and so are the solo
speculative generators' steps and every train step after a trainer's
first: an engine's first call of a key runs eagerly and captures the
graph. The timed engines of 4e-4h are warmed first by one short request
of their stream (``_warmed``: its round and admission captured, its
counters reset), so their timed runs replay; 4g(a)'s solo decode is the
bench's compiled decode (``graphs.DecodeProgram``), captured by an
untimed first pass. The kernels' launch counts hold the replayed
launches.

The matmul, the flash forward and the flash backward's dq and dk/dv
kernels each have two kernels, a route chosen from the inputs: wgmma
fed by TMA for bf16 that TMA can read, the first CUDA-core kernel
otherwise. Paged attention has two as well: the split-KV kernel (the
sequence split across blocks, 16-byte asynchronous copies, a combine
in fixed split order) for bf16 that 16-byte copies can read, the
one-pass kernel otherwise. So do rms_norm and softmax: ``vector`` and
``one_read`` (16-byte loads, the row held in registers and read from
device memory once) for rows that 16-byte loads can read and registers
hold, ``scalar`` and ``two_pass`` (the first kernels) otherwise. Phases
2-7 check which route every launch took from the wrappers' per-route
counts: the bf16 main paths (phases 2, 4, 6, the flagship products of
7) on the tensor cores and the split-KV kernel only, the fp32 tiny
models (3, 5) and the gate's fp32 product on the CUDA cores and the
one-pass kernel only, the gate's rms_norm and softmax on vector and
one_read, and each row-kernel case of 7 on the route its inputs call
for. Phase 2 holds
the split-KV kernel at several split sizes and the one-pass kernel to
the plain version on the same inputs, and checks that two split-KV
calls give bitwise-equal partials. Phase 2 also
holds the kept CUDA-core flash forward (out and lse) and backward (dq,
dk, dv) to their plain versions on inputs routed to them (fp32 at the
tiny models' shape, bf16 at head_dim 24, a misaligned bf16 view), and
checks that two backward calls give bitwise-equal gradients. Each
redesigned kernel is timed against the kernel it replaces (kept as the
other route) on the same inputs, in turns, in the same run, both through their C entry
points behind the same Python layer: as every other kernel
(``ms_tensor_cores``, ``ms_cuda_cores``; ``ms_split_kv``,
``ms_one_pass``; ``ms_vector``, ``ms_scalar``; ``ms_one_read``,
``ms_two_pass``), as device time alone with the card kept busy while
the host enqueues (``device_ms*``), and as host time per call
(``host_us*``). Its row's ``ms`` and ``host_us``
are the user's wrapper's, as for every other kernel.

Each phase's wall time is printed as it ends and collected in a
``{"phase_wall_s": ...}`` line. Standard output ends with a
``{"kernels": [...]}`` line, the card's
name and power limit as nvidia-smi prints them, and the result line
``{"ok": true, "device": {...}}``. TF32 is off for every fp32 product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import io
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

FLASH_TOL = 2e-2        # bf16 output rounding + P rounded to bf16 for PV
LSE_TOL = 1e-3          # fp32 running max and denominator; sum order only
FLASH_FP32_TOL = 1e-5   # fp32 in, out and lse: summation order only
PAGED_RTOL, PAGED_ATOL = 1e-3, 1e-4   # fp32 partials; summation order
SMALL_MARGIN = 1e-3     # a stream split below this top-2 margin is a tie
# dq, dk and dv on the tensor cores: the products take P and dS rounded
# to bf16 (about 2^-9 of each value; the reference keeps both fp32, as
# FlashAttention-2 and -3 do not), the outputs are cast to bf16 once
# (half an ulp is up to 2^-8 of the value), and the fp32 sums run in
# another order: the error is judged against the reference's largest
# magnitude. The kept CUDA-core kernels round only the outputs.
BWD_REL_TOL = 1e-2
# the kept CUDA-core backward in fp32: fp32 throughout, only the
# summation order and expf's last bits differ from the plain version
BWD_FP32_REL_TOL = 1e-5
# fp32 training on the card against the CPU: every product in fp32 (TF32
# off), only the summation order differs; AdamW's normalised update
# turns relative gradient noise into absolute parameter steps of up to
# lr x it, so the parameters get the looser absolute bar
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 2e-4
# matmul: fp32 sums in another order than cuBLAS's (the bf16 inputs'
# products are exact in fp32), judged against the largest magnitude
MATMUL_REL_TOL = 1e-3
# rms_norm: the bf16 output of two fp32 computations that differ in
# summation order and rsqrt may round to neighbouring bf16 values
RMS_NORM_ULPS = 1.0
# rms_norm in fp32: the gate's own bar (toolchain_smoke)
RMS_NORM_FP32_ATOL = 1e-5
# softmax: fp32 throughout; the kernel's running sum differs from the
# plain version's only in order and in the rescaling of partial sums
SOFTMAX_ATOL = 1e-6
# softmax in bf16: one rounding to bf16 of fp32 values that agree to
# about 1e-7 relative may land on neighbouring bf16 values
SOFTMAX_BF16_ULPS = 1.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# each line's seconds since the start, written beside the output to
# build/chip_smoke_timeline.txt once main() has found the card and the
# package: where a run's time went, line by line
_START = time.perf_counter()
_TIMELINE = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _TIMELINE is not None:
        _TIMELINE.write(f"{time.perf_counter() - _START:8.1f} {msg[:160]}\n")
        _TIMELINE.flush()


# ---------------------------------------------------------------------
# timing


_L2_FLUSH = None
# a spin on the card of ~0.5 ms, far longer than the host takes to
# enqueue one call through a wrapper
ENQUEUE_COVER_CYCLES = 1_000_000


def time_ms(fn, reps: int = 30, warmup: int = 5,
            cover_enqueue: bool = False) -> float:
    """Median time of one ``fn()`` call in ms, CUDA events around each
    call, with the 50 MB L2 overwritten before every call (the serving
    path's pools and weights are far larger than L2). The events hold
    the host's enqueue time wherever it outlasts the L2 flush: every
    ``ms`` of the kernels line is timed so. With ``cover_enqueue`` the
    card spins before the start event while the host enqueues the call,
    so the time is the device's alone (the ``device_ms`` keys)."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _L2_FLUSH.fill_(1)
        if cover_enqueue:
            torch.cuda._sleep(ENQUEUE_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, calls: int = 50, rounds: int = 5) -> float:
    """Host time of one ``fn()`` call in us: the median over ``rounds``
    of the mean over ``calls`` calls in a row, none waiting for the
    card."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(means))


def time_routes(name: str, wrapper, new, old,
                routes=("tensor_cores", "cuda_cores")) -> dict:
    """A redesigned kernel against the kernel it replaces, on the same
    inputs in one call. ``wrapper`` is the user's call (it takes the
    new route); ``new`` and ``old`` launch each route's C entry point
    through the same Python layer, uncounted, so they differ in the
    kernel alone; ``routes`` names them. The two routes are timed twice
    in turns (new, old, old, new) both ways (``time_ms`` as every other
    row, and device time alone), each the mean of its two medians; the
    wrapper by ``time_ms``; all three by host time per call. Returns
    {"ms" (the wrapper's), "ms_<new>", "ms_<old>", "device_ms",
    "device_ms_<old>", "host_us" (the wrapper's), "host_us_<new>",
    "host_us_<old>"}."""
    new_name, old_name = routes
    res = {"ms": time_ms(wrapper)}
    for cover, key in ((False, "ms"), (True, "device_ms")):
        n1 = time_ms(new, cover_enqueue=cover)
        o1 = time_ms(old, cover_enqueue=cover)
        o2 = time_ms(old, cover_enqueue=cover)
        n2 = time_ms(new, cover_enqueue=cover)
        log(f"{name} in turns ({key}): {new_name} {n1:.4f}, {n2:.4f} ms; "
            f"{old_name} {o1:.4f}, {o2:.4f} ms")
        new_key = "device_ms" if cover else f"ms_{new_name}"
        res[new_key], res[f"{key}_{old_name}"] = (n1 + n2) / 2, (o1 + o2) / 2
    res["host_us"] = host_us(wrapper)
    res[f"host_us_{new_name}"] = host_us(new)
    res[f"host_us_{old_name}"] = host_us(old)
    log(f"{name}: wrapper {res['ms']:.4f} ms; host time per call: wrapper "
        f"{res['host_us']:.1f} us, {new_name} entry "
        f"{res[f'host_us_{new_name}']:.1f} us, {old_name} entry "
        f"{res[f'host_us_{old_name}']:.1f} us")
    return res


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    """(least time in ms, "bytes" or "operations") on the card."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zero_counts(*fns) -> None:
    """Set each wrapper's launch count (and per-route counts) to 0."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def check_routes(name: str, fn, *counts: int) -> None:
    """The launches of ``fn`` since its counts were zeroed went the
    given number of times through each route, in the order of
    ``fn.launches_by_route`` (tensor cores then CUDA cores; split-KV
    then one-pass)."""
    got = dict(fn.launches_by_route)
    want = dict(zip(fn.launches_by_route, counts))
    log(f"{name}: launches by route {got} (expected {want})")
    check(got == want, f"{name}: launches by route {got}, expected {want}")


# ---------------------------------------------------------------------
# phase 2: the kernels against their plain versions


def _split_qkv(qkv, h, kv, d):
    b, t = qkv.shape[:2]
    return (qkv[..., :h * d].reshape(b, t, h, d),
            qkv[..., h * d:(h + kv) * d].reshape(b, t, kv, d),
            qkv[..., (h + kv) * d:].reshape(b, t, kv, d))


def _fused_qkv(gen, b, t, h, kv, d):
    """q, k, v as views of one fused (b, t, (h + 2 kv) d) bf16 tensor,
    the model's layout after the qkv projection."""
    qkv = torch.randn((b, t, (h + 2 * kv) * d), generator=gen,
                      device="cuda").bfloat16()
    return _split_qkv(qkv, h, kv, d)


def _misaligned_qkv(gen, b, t, h, kv, d):
    """``_fused_qkv`` whose base lies one element off a 16-byte
    boundary: TMA cannot read it."""
    n = b * t * (h + 2 * kv) * d
    off = torch.randn((n + 1,), generator=gen,
                      device="cuda").bfloat16()[1:].view(b, t, -1)
    return _split_qkv(off, h, kv, d)


def flash_phase(fa) -> dict:
    """flash_attention at the prefill shape of the serving path: one
    256-token prompt (the 192/224/256 prompts' bucket), 16 q heads over
    4 kv heads, head_dim 128, bf16, causal, q/k/v read as views of the
    fused qkv projection (the model's layout). Plus a ragged causal
    case (t = s = 200), a non-causal one, a non-causal one whose t and
    s the q and kv tiles do not divide (b = 2, t = s = 1000), one on
    contiguous q, k, v, one on head-major tensors seen as (b, t, h, d),
    and one at head_dim 64; every case on the tensor-core route (the
    b = 1, t <= 256 cases and the head-major one with one consumer
    warpgroup a block, the others with two). Then the CUDA-core kernel
    on what the wrapper routes to it (``flash_cuda_cores_cases``). The
    serving shape is timed on both routes in turns."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    h, kv, d = 16, 4, 128
    contiguous = tuple(x.contiguous()
                       for x in _fused_qkv(gen, 1, 256, h, kv, d))
    # head-major tensors seen as (b, t, heads, d): the head stride is
    # larger than the sequence stride
    head_major = tuple(
        torch.randn((2, n, 300, d), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
        for n in (h, kv, kv))
    cases = [("main 256 causal", _fused_qkv(gen, 1, 256, h, kv, d), True),
             ("ragged 200 causal", _fused_qkv(gen, 1, 200, h, kv, d), True),
             ("full 256", _fused_qkv(gen, 1, 256, h, kv, d), False),
             ("ragged full (2,1000)", _fused_qkv(gen, 2, 1000, h, kv, d),
              False),
             ("contiguous 256 causal", contiguous, True),
             ("head-major (2,300) causal", head_major, True),
             ("head_dim 64 (8,512) causal", _fused_qkv(gen, 8, 512, 8, 2, 64),
              True)]
    worst = 0.0
    for name, (q, k, v), causal in cases:
        zero_counts(fa.flash_attention)
        out = fa.flash_attention(q, k, v, causal=causal)
        check_routes(f"flash_attention {name}", fa.flash_attention, 1, 0)
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and out.shape == q.shape,
              f"flash_attention {name}: output {out.dtype} {out.shape}")
        err = float((out.float() - ref).abs().max())
        log(f"flash_attention {name}: max_abs_err {err:.3e} "
            f"(tolerance {FLASH_TOL})")
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash_attention {name}: max_abs_err {err} > {FLASH_TOL}")
        worst = max(worst, err)

    q, k, v = cases[0][1]
    # the logsumexp output (the training slice's backward reads it)
    _, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    _, lse_ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=True, return_lse=True)
    lse_err = float((lse - lse_ref).abs().max())
    log(f"flash_attention main 256 causal lse: max_abs_err {lse_err:.3e} "
        f"(tolerance {LSE_TOL})")
    check(lse.shape == lse_ref.shape and lse_err <= LSE_TOL,
          f"flash_attention lse: max_abs_err {lse_err} > {LSE_TOL}")

    worst = max(worst, flash_cuda_cores_cases(fa, gen))

    b, t, _, _ = q.shape
    # the serving path's call (no lse), and each route's entry point
    turns = time_routes(
        "flash_attention (1,256,16,128) causal",
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa._forward_launch(q, k, v, True, False, fa.TENSOR_CORES),
        lambda: fa._forward_launch(q, k, v, True, False, fa.CUDA_CORES))
    ms = turns["ms"]
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
    # each input read once, the output written once; causal QK^T and PV
    # over the t(t+1)/2 live (row, col) pairs, 2 flops per multiply-add
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    pairs = b * h * t * (t + 1) // 2
    bound_ms, bound_by = bound(nbytes, 4 * pairs * d, torch.bfloat16)
    log(f"flash_attention timing (1,256,16,128) causal: kernel {ms:.4f} ms "
        f"(entry points: tensor cores {turns['ms_tensor_cores']:.4f}, CUDA "
        f"cores {turns['ms_cuda_cores']:.4f} ms; device time "
        f"alone {turns['device_ms']:.4f} against "
        f"{turns['device_ms_cuda_cores']:.4f} ms), plain {plain_ms:.4f} "
        f"ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    admission = flash_admission_cases(fa, gen)
    worst = max(worst, *(admission[f"{key}_max_abs_err"]
                         for key in ADMISSION_SHAPES))
    return {"name": "flash_attention", "route": "cuda",
            "source": fa.SOURCE, "replaces": fa.REPLACES,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            **{key: x for key, x in turns.items() if key != "ms"},
            **admission}


# the flash forward's shapes in prompt admission: the serving stream's
# waves of 8 prompts in the 256-token bucket, a stacked wave of 8 in the
# 1024-token bucket, and one 3072-token prompt padded to its 4096-token
# bucket
ADMISSION_SHAPES = {"serving_wave": (8, 256), "wave": (8, 1024),
                    "long": (1, 4096)}


def flash_admission_cases(fa, gen) -> dict:
    """The flash forward at the admission shapes of the realistic stream
    (``ADMISSION_SHAPES``; q/k/v views of the fused qkv projection, 16
    q heads over 4 kv heads, head_dim 128, bf16, causal), each on the
    tensor-core route against the plain version, then timed (``ms``
    as every row, device time alone) beside the plain version, SDPA
    and its bound. Returns the kernels line's keys, ``<shape>_ms`` and
    so on."""
    h, kv, d = 16, 4, 128
    out = {}
    for key, (b, t) in ADMISSION_SHAPES.items():
        q, k, v = _fused_qkv(gen, b, t, h, kv, d)
        name = f"flash_attention {key} ({b},{t}) causal"
        zero_counts(fa.flash_attention)
        got = fa.flash_attention(q, k, v, causal=True)
        check_routes(name, fa.flash_attention, 1, 0)
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=True)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and got.shape == q.shape,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - ref).abs().max())
        log(f"{name}: max_abs_err {err:.3e} (tolerance {FLASH_TOL})")
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"{name}: max_abs_err {err} > {FLASH_TOL}")
        del got, ref
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        device_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                            cover_enqueue=True)
        plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                          causal=True))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True))
        pairs = b * h * t * (t + 1) // 2
        bound_ms, bound_by = bound(
            2 * (q.numel() + k.numel() + v.numel() + q.numel()),
            4 * pairs * d, torch.bfloat16)
        log(f"{name} timing: {ms:.4f} ms, device {device_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}): {bound_ms / device_ms:.1%} of "
            "the bound")
        out.update({f"{key}_shape": [b, t, h, d], f"{key}_max_abs_err": err,
                    f"{key}_ms": ms, f"{key}_device_ms": device_ms,
                    f"{key}_plain_ms": plain_ms,
                    f"{key}_library_ms": library_ms,
                    f"{key}_bound_ms": bound_ms, f"{key}_bound_by": bound_by})
        del q, k, v, qt, kt, vt
    return out


def flash_cuda_cores_cases(fa, gen) -> float:
    """The kept CUDA-core forward kernel, through its own entry point
    (uncounted), against the plain version on the inputs the wrapper
    routes to it: fp32 at the tiny flash models' shape (phases 3 and 5:
    4 q heads over 2 kv heads, head_dim 32), bf16 at head_dim 24 (not a
    multiple of 16) and bf16 views whose base lies one element off a
    16-byte boundary. out and lse each; returns the worst out error."""
    h, kv, d = 16, 4, 128
    misaligned = _misaligned_qkv(gen, 1, 256, h, kv, d)
    fp32 = tuple(x.float() for x in _fused_qkv(gen, 4, 64, 4, 2, 32))
    cases = [("fp32 tiny (4,64,4->2,32) causal", fp32, True, FLASH_FP32_TOL,
              FLASH_FP32_TOL),
             ("bf16 head_dim 24 (2,200) causal",
              _fused_qkv(gen, 2, 200, h, kv, 24), True, FLASH_TOL, LSE_TOL),
             ("bf16 misaligned 256 full", misaligned, False, FLASH_TOL,
              LSE_TOL)]
    worst = 0.0
    for name, (q, k, v), causal, tol, lse_tol in cases:
        check(fa.forward_route(q, k, v) == fa.CUDA_CORES,
              f"flash_attention CUDA cores {name}: routed to "
              f"{fa.forward_route(q, k, v)}")
        out, lse = fa._forward_launch(q, k, v, causal, True, fa.CUDA_CORES)
        ref, lse_ref = fa.flash_attention_ref(q.float(), k.float(),
                                              v.float(), causal=causal,
                                              return_lse=True)
        torch.cuda.synchronize()
        check(out.dtype == q.dtype and out.shape == q.shape
              and lse.shape == lse_ref.shape,
              f"flash_attention CUDA cores {name}: out {out.dtype} "
              f"{tuple(out.shape)}, lse {tuple(lse.shape)}")
        err = float((out.float() - ref).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        log(f"flash_attention CUDA cores {name}: max_abs_err {err:.3e} "
            f"(tolerance {tol}), lse {lse_err:.3e} (tolerance {lse_tol})")
        check(math.isfinite(err) and err <= tol,
              f"flash_attention CUDA cores {name}: max_abs_err {err}")
        check(math.isfinite(lse_err) and lse_err <= lse_tol,
              f"flash_attention CUDA cores {name}: lse max_abs_err "
              f"{lse_err}")
        worst = max(worst, err)
    return worst


def _paged_inputs(gen, rng, lengths_h, kv, g, hd, bsz, width,
                  dtype=torch.bfloat16):
    """Decode inputs on the card: distinct live blocks per slot (block
    0 is the garbage block), padding entries pointing at the garbage
    block or at other slots' live blocks, random q and pools."""
    slots = len(lengths_h)
    live_n = [-(-int(n) // bsz) for n in lengths_h]
    nblocks = 1 + sum(live_n)
    perm = list(rng.permutation(np.arange(1, nblocks)))
    tables_h = np.zeros((slots, width), np.int32)
    live_blocks = []
    for s, live in enumerate(live_n):
        tables_h[s, :live] = perm[:live]
        live_blocks += perm[:live]
        perm = perm[live:]
    for s, live in enumerate(live_n):
        for j in range(live, width):
            tables_h[s, j] = 0 if j % 2 else int(rng.choice(live_blocks))
    qg = torch.randn((slots, kv, g, hd), generator=gen,
                     device="cuda").to(dtype)
    k_pool, v_pool = (torch.randn((nblocks, bsz, kv, hd), generator=gen,
                                  device="cuda").to(dtype)
                      for _ in range(2))
    return (qg, k_pool, v_pool, torch.as_tensor(tables_h, device="cuda"),
            torch.as_tensor(np.asarray(lengths_h, np.int32), device="cuda"))


def paged_decode_inputs():
    """The serving path's decode call as the paged phase checks and
    times it (and ``tools/compare_trees.py`` times it in two trees): 8
    slots, 4 kv heads x group 4, head_dim 128, bf16 pools of
    64-position blocks, table width 8, lengths from an empty slot to
    448, seed 2."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.RandomState(2)
    args = _paged_inputs(gen, rng, [0, 1, 63, 64, 65, 448, 300, 129], 4, 4,
                         128, 64, 8)
    return gen, rng, args


def _paged_check(pa, name: str, got, args) -> float:
    """(acc, m, l) against the plain version on the same inputs, at
    PAGED_RTOL / PAGED_ATOL on live slots and exactly acc = 0, l = 0,
    m = -1e30 on empty ones. Returns the largest absolute error."""
    want = pa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    live = args[-1] > 0
    worst = 0.0
    for key, a, r in zip(("acc", "m", "l"), got, want):
        check(a.dtype == torch.float32 and a.shape == r.shape,
              f"paged_attention {name} {key}: {a.dtype} {tuple(a.shape)}")
        a_l, r_l = a[live], r[live]
        err = float((a_l - r_l).abs().max())
        ok = bool(((a_l - r_l).abs()
                   <= PAGED_ATOL + PAGED_RTOL * r_l.abs()).all())
        check(ok and math.isfinite(err),
              f"paged_attention {name} {key} outside tolerance ({err})")
        worst = max(worst, err)
    acc, m, l = (x[~live] for x in got)
    check(bool((acc == 0).all() and (l == 0).all()
               and (m == np.float32(-1e30)).all()),
          f"paged_attention {name}: an empty slot is not exactly acc = 0, "
          "l = 0, m = -1e30")
    log(f"paged_attention {name}: max_abs_err {worst:.3e} (rtol "
        f"{PAGED_RTOL}, atol {PAGED_ATOL}); {int((~live).sum())} empty "
        "slot(s) exact")
    return worst


def _paged_bound(args, shared_rows: int = 0) -> tuple:
    """Live k and v rows read once (``shared_rows`` of them live in more
    than one slot and count once), q, tables and lengths read once, the
    fp32 partials written once; QK and PV over every live position."""
    qg, k_pool, _, tables, lengths = args
    slots, kv, g, hd = qg.shape
    total = int(lengths.clamp(max=tables.shape[1] * k_pool.shape[1]).sum())
    nbytes = (2 * (total - shared_rows) * kv * hd * qg.element_size()
              + qg.numel() * qg.element_size() + 4 * tables.numel()
              + 4 * lengths.numel() + 4 * slots * kv * g * (hd + 2))
    return bound(nbytes, 4 * total * kv * g * hd, torch.bfloat16)


def _read_ms(args) -> float:
    """Device time of one ``sum()`` over a contiguous bf16 tensor as
    large as the live K and V rows, by the paged rows' method: what
    reading the kernel's bytes costs one PyTorch launch here (no L2
    hits, the card's launch latency), a floor beside the byte bound."""
    qg, k_pool, _, tables, lengths = args
    total = int(lengths.clamp(max=tables.shape[1] * k_pool.shape[1]).sum())
    x = torch.zeros(2 * total * qg.shape[1] * qg.shape[3],
                    dtype=torch.bfloat16, device="cuda")
    return time_ms(lambda: x.sum(), cover_enqueue=True)


def shared_paged_inputs(gen, rng):
    """The realistic stream's decode shape: 8 slots, 4 kv heads x group
    4, head_dim 128, bf16 pools of 64-position blocks, table width 64,
    lengths from an empty slot to 3200; slots 1 and 2 point their first
    16 table entries at the same blocks (a prefix family's 1024-token
    head). Returns (args, the shared live rows)."""
    lengths = [3200, 1184, 1216, 2112, 288, 0, 3136, 1088]
    kv, g, hd, bsz, width, n_shared = 4, 4, 128, 64, 64, 16
    live_n = [-(-n // bsz) for n in lengths]
    nblocks = 1 + sum(live_n) - n_shared
    perm = [int(x) for x in rng.permutation(np.arange(1, nblocks))]
    shared, perm = perm[:n_shared], perm[n_shared:]
    tables_h = np.zeros((len(lengths), width), np.int32)
    for s, live in enumerate(live_n):
        head = shared if s in (1, 2) else []
        own = live - len(head)
        tables_h[s, :live] = head + perm[:own]
        perm = perm[own:]
    qg = torch.randn((len(lengths), kv, g, hd), generator=gen,
                     device="cuda").bfloat16()
    k_pool, v_pool = (torch.randn((nblocks, bsz, kv, hd), generator=gen,
                                  device="cuda").bfloat16() for _ in range(2))
    return ((qg, k_pool, v_pool, torch.as_tensor(tables_h, device="cuda"),
             torch.as_tensor(np.asarray(lengths, np.int32), device="cuda")),
            n_shared * bsz)


def paged_shared_case(pa, gen, rng) -> tuple:
    """``shared_paged_inputs`` through the wrapper on the split-KV route
    against the plain version, then timed beside the plain version and
    its bound. Returns
    (the worst error, the kernels line's ``shared_*`` keys)."""
    args, shared_rows = shared_paged_inputs(gen, rng)
    zero_counts(pa.paged_attention)
    got = pa.paged_attention(*args)
    check_routes("paged_attention width 64, shared blocks",
                 pa.paged_attention, 1, 0)
    err = _paged_check(pa, "split_kv width 64, shared blocks", got, args)
    ms = time_ms(lambda: pa.paged_attention(*args))
    device_ms = time_ms(lambda: pa.paged_attention(*args), cover_enqueue=True)
    plain_ms = time_ms(lambda: pa.paged_attention_ref(*args))
    bound_ms, bound_by = _paged_bound(args, shared_rows)
    total = int(args[-1].sum())
    log(f"paged_attention timing width 64, shared blocks (8 slots, {total} "
        f"live positions, {shared_rows} rows in two slots): {ms:.4f} ms, "
        f"device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}): {bound_ms / device_ms:.1%} of the "
        "bound")
    return err, {"shared_ms": ms, "shared_device_ms": device_ms,
                 "shared_plain_ms": plain_ms,
                 "shared_bound_ms": bound_ms, "shared_bound_by": bound_by,
                 "shared_live_positions": total,
                 "shared_table_width": int(args[3].shape[1]),
                 "shared_max_abs_err": err}


def paged_phase(pa) -> dict:
    """paged_attention at the decode shape of the serving path: 8 slots,
    4 kv heads x group 4, head_dim 128, bf16 pools of 64-position
    blocks, table width 8. Lengths mix an empty slot, sub-block, one
    block, block+1 and the longest slot (448); padding entries point at
    the garbage block or at other slots' live blocks. The wrapper takes
    the split-KV route; two calls must give the same bits. The split
    kernel is also run at other split sizes (2 blocks: two tiles,
    double-buffered; 3: a short last split; 8: one split, no combine),
    and the one-pass kernel on the same inputs. A gqa-8, head_dim 64,
    16-position-block case puts four pool blocks in one tile; a
    one-slot case of 505 table entries and group 3 makes the combine's
    m and l the largest part of shared memory. Then the
    flagship's full context: 8 slots x 1024 positions (width 16) plus
    an empty and a ragged slot. Both shapes are timed on both routes in
    turns. Then the realistic stream's shape (``paged_shared_case``)."""
    gen, rng, args = paged_decode_inputs()
    kv, g, hd, bsz = 4, 4, 128, 64
    lengths_h = args[-1].cpu().numpy()

    zero_counts(pa.paged_attention)
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    check_routes("paged_attention decode shape", pa.paged_attention, 2, 0)
    worst = _paged_check(pa, "split_kv decode shape", got, args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"paged_attention split_kv: a second call gives bitwise-equal "
        f"acc, m, l: {same}")
    check(same, "paged_attention split_kv: two calls differ")
    for bps in (2, 3, 8):
        worst = max(worst, _paged_check(
            pa, f"split_kv decode shape, {bps} blocks a split",
            pa._paged_launch(pa.SPLIT_KV, *args, bps=bps), args))
    worst = max(worst, _paged_check(
        pa, "one_pass decode shape", pa._paged_launch(pa.ONE_PASS, *args),
        args))
    gqa8 = _paged_inputs(gen, rng, [0, 17, 100, 192, 5], 2, 8, 64, 16, 12)
    check(pa.paged_route(*gqa8) == pa.SPLIT_KV, "gqa8 case: not split_kv")
    worst = max(worst, _paged_check(
        pa, "split_kv gqa8 hd64 bsz16", pa._paged_launch(pa.SPLIT_KV, *gqa8),
        gqa8))
    # 505 splits of 3 query rows: the combine's m and l take the most
    # shared memory, and q must still start on a 16-byte boundary
    wide = _paged_inputs(gen, rng, [700], 1, 3, 24, 64, 505)
    check(pa.paged_route(*wide) == pa.SPLIT_KV, "wide case: not split_kv")
    worst = max(worst, _paged_check(
        pa, "split_kv g3 hd24 width 505", pa._paged_launch(pa.SPLIT_KV, *wide),
        wide))

    turns = time_routes(
        "paged_attention decode shape", lambda: pa.paged_attention(*args),
        lambda: pa._paged_launch(pa.SPLIT_KV, *args),
        lambda: pa._paged_launch(pa.ONE_PASS, *args),
        routes=(pa.SPLIT_KV, pa.ONE_PASS))
    plain_ms = time_ms(lambda: pa.paged_attention_ref(*args))
    bound_ms, bound_by = _paged_bound(args)
    read_ms = _read_ms(args)
    total = int(lengths_h.sum())
    log(f"paged_attention timing (8 slots, {total} live positions): wrapper "
        f"{turns['ms']:.4f} ms, device split_kv {turns['device_ms']:.4f} vs "
        f"one_pass {turns['device_ms_one_pass']:.4f} ms "
        f"({turns['device_ms_one_pass'] / turns['device_ms']:.1f}x), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), a sum "
        f"over the live K/V bytes {read_ms:.4f} ms")

    # the flagship's full context (max_len 1024)
    full = _paged_inputs(gen, rng, [1024] * 4 + [0, 700] + [1024] * 4, kv,
                         g, hd, bsz, 16)
    zero_counts(pa.paged_attention)
    full_got = pa.paged_attention(*full)
    check_routes("paged_attention full context", pa.paged_attention, 1, 0)
    worst = max(worst, _paged_check(pa, "split_kv full context", full_got,
                                    full))
    worst = max(worst, _paged_check(
        pa, "one_pass full context", pa._paged_launch(pa.ONE_PASS, *full),
        full))
    full_turns = time_routes(
        "paged_attention full context", lambda: pa.paged_attention(*full),
        lambda: pa._paged_launch(pa.SPLIT_KV, *full),
        lambda: pa._paged_launch(pa.ONE_PASS, *full),
        routes=(pa.SPLIT_KV, pa.ONE_PASS))
    full_plain_ms = time_ms(lambda: pa.paged_attention_ref(*full))
    full_bound = _paged_bound(full)
    full_read_ms = _read_ms(full)
    full_total = int(full[-1].sum())
    shared_err, shared = paged_shared_case(pa, gen, rng)
    worst = max(worst, shared_err)
    log(f"paged_attention timing full context (10 slots, {full_total} live "
        f"positions): device split_kv {full_turns['device_ms']:.4f} vs "
        f"one_pass {full_turns['device_ms_one_pass']:.4f} ms "
        f"({full_turns['device_ms_one_pass'] / full_turns['device_ms']:.1f}x)"
        f", bound {full_bound[0]:.5f} ms ({full_bound[1]}): "
        f"{full_bound[0] / full_turns['device_ms']:.1%} of the bound; a sum "
        f"over the live K/V bytes {full_read_ms:.4f} ms")
    return {"name": "paged_attention", "route": "cuda",
            "source": pa.SOURCE, "replaces": pa.REPLACES,
            "max_abs_err": worst, "ms": turns["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_route": pa.SPLIT_KV, "one_pass_source": pa.ONE_PASS_SOURCE,
            "device_ms_read_bytes": read_ms,
            "full_context_device_ms_read_bytes": full_read_ms,
            **{key: x for key, x in turns.items() if key != "ms"},
            **{f"full_context_{key}": x for key, x in full_turns.items()},
            "full_context_plain_ms": full_plain_ms,
            "full_context_bound_ms": full_bound[0],
            "full_context_bound_by": full_bound[1],
            "full_context_live_positions": full_total, **shared}


def _library_bwd_ms(q, k, v, g):
    """One PyTorch call that computes the whole attention backward:
    aten's flash-attention backward on head-major tensors, k/v expanded
    to every q head and aten's own forward run beforehand (untimed)."""
    group = q.shape[2] // k.shape[2]
    qh, gh = (x.transpose(1, 2).contiguous() for x in (q, g))
    kh, vh = (x.transpose(1, 2).repeat_interleave(group, dim=1).contiguous()
              for x in (k, v))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qh, kh, vh, 0.0, True, False)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    return time_ms(lambda: bwd(gh, qh, kh, vh, out, lse, cum_q, cum_k,
                               max_q, max_k, 0.0, True, seed, offset))


def _bwd_errors(name: str, got, want, tol: float) -> dict:
    """Each of dq, dk, dv (``got``) against the plain backward's
    (``want``, fp32), judged relative to the largest magnitude of the
    plain one; returns the worst absolute error by kernel ("dq",
    "dkv")."""
    worst = {"dq": 0.0, "dkv": 0.0}
    for kname, a, r in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - r).abs().max())
        rel = err / float(r.abs().max())
        log(f"flash backward {name} {kname}: max_abs_err {err:.3e}, "
            f"relative to max |ref| {rel:.3e} (tolerance {tol})")
        check(math.isfinite(rel) and rel <= tol,
              f"flash backward {name} {kname}: relative error {rel}")
        key = "dq" if kname == "dq" else "dkv"
        worst[key] = max(worst[key], err)
    return worst


def flash_bwd_cuda_cores_cases(fa, gen) -> dict:
    """The kept CUDA-core dq and dk/dv kernels, through their own entry
    points (uncounted), against the plain backward on the inputs the
    wrappers route to them: fp32 at the tiny flash models' shape
    (phases 3 and 5), bf16 at head_dim 24 (not a multiple of 16) and
    bf16 views whose base lies one element off a 16-byte boundary; each
    fed the plain forward's out and lse and a random g. Returns the
    worst absolute errors {"dq", "dkv"}."""
    h, kv, d = 16, 4, 128
    cases = [("fp32 tiny (4,64,4->2,32) causal",
              tuple(x.float() for x in _fused_qkv(gen, 4, 64, 4, 2, 32)),
              True, BWD_FP32_REL_TOL),
             ("bf16 head_dim 24 (2,200) causal",
              _fused_qkv(gen, 2, 200, h, kv, 24), True, BWD_REL_TOL),
             ("bf16 misaligned 256 full",
              _misaligned_qkv(gen, 1, 256, h, kv, d), False, BWD_REL_TOL)]
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, (q, k, v), causal, tol in cases:
        g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        out, lse = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                          causal, return_lse=True)
        out = out.to(q.dtype)
        inputs = fa._kernel_inputs(q, out, lse, g)
        route = fa.backward_route(q, k, v, inputs[0])
        check(route == fa.CUDA_CORES,
              f"flash backward CUDA cores {name}: routed to {route}")
        (dq,) = fa._bwd_launch("dq", fa.CUDA_CORES, q, k, v, *inputs,
                               causal)
        dk, dv = fa._bwd_launch("dkv", fa.CUDA_CORES, q, k, v, *inputs,
                                causal)
        ref = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         out.float(), lse, g.float(), causal)
        torch.cuda.synchronize()
        for kname, got, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
            check(got.dtype == q.dtype and got.shape == like.shape,
                  f"flash backward CUDA cores {name} {kname}: {got.dtype} "
                  f"{tuple(got.shape)}")
        errs = _bwd_errors(f"CUDA cores {name}", (dq, dk, dv), ref, tol)
        worst = {key: max(worst[key], errs[key]) for key in worst}
    return worst


def flash_bwd_phase(fa, fwd_row: dict) -> list:
    """The flash backward's dq and dk/dv kernels at the training path's
    shape: q (8, 1024, 16, 128) over k/v (8, 1024, 4, 128) bf16, causal,
    q/k/v views of a fused qkv tensor, g random; plus a ragged causal
    case (t = s = 200), a non-causal one and an odd length (8, 1023),
    all on the tensor-core route. Each case runs the chain training runs -- the
    forward kernel's out and lse into the two backward kernels --
    against the plain chain in fp32 on the same bf16 inputs: the forward
    kernel's out and lse against the plain forward's (their worst error
    joins ``fwd_row``), the kernels' gradients against the plain
    backward fed the plain forward's out and lse. Two calls on the main
    case must give bitwise-equal gradients. Then the CUDA-core kernels
    on what the wrappers route to them (``flash_bwd_cuda_cores_cases``).
    Then the two kernels (each against its CUDA-core kernel in turns),
    each one's plain version, the whole plain backward, aten's whole
    backward and the forward kernel timed at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, t, h, kv, d = 8, 1024, 16, 4, 128
    cases = [("main (8,1024) causal", (b, t), True, gen),
             ("ragged (2,200) causal", (2, 200), True, gen),
             ("full (2,256)", (2, 256), False, gen),
             # an odd length (a training forward over 1023 positions):
             # the (b, h, t) lse and D rows start off 16-byte boundaries
             ("odd (8,1023) causal", (b, t - 1), True,
              torch.Generator(device="cuda").manual_seed(5))]
    worst = {"dq": 0.0, "dkv": 0.0}
    bwd = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for name, (bb, tt), causal, case_gen in cases:
        q, k, v = _fused_qkv(case_gen, bb, tt, h, kv, d)
        g = torch.randn(q.shape, generator=case_gen,
                        device="cuda").bfloat16()
        zero_counts(fa.flash_attention, *bwd)
        out, lse = fa.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
        check_routes(f"flash_attention {name}", fa.flash_attention, 1, 0)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, g, causal)
        check_routes(f"flash backward dq {name}", bwd[0], 1, 0)
        check_routes(f"flash backward dk/dv {name}", bwd[1], 1, 0)
        qf, kf, vf = q.float(), k.float(), v.float()
        out_ref, lse_ref = fa.flash_attention_ref(qf, kf, vf, causal,
                                                  return_lse=True)
        ref = fa.flash_attention_bwd_ref(qf, kf, vf, out_ref, lse_ref,
                                         g.float(), causal)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and out.shape == q.shape
              and lse.shape == lse_ref.shape,
              f"flash_attention {name}: out {out.dtype} "
              f"{tuple(out.shape)}, lse {tuple(lse.shape)}")
        out_err = float((out.float() - out_ref).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        log(f"flash_attention {name}: max_abs_err {out_err:.3e} "
            f"(tolerance {FLASH_TOL}), lse {lse_err:.3e} (tolerance "
            f"{LSE_TOL})")
        check(math.isfinite(out_err) and out_err <= FLASH_TOL,
              f"flash_attention {name}: max_abs_err {out_err}")
        check(math.isfinite(lse_err) and lse_err <= LSE_TOL,
              f"flash_attention {name}: lse max_abs_err {lse_err}")
        fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], out_err)
        for kname, got, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
            check(got.dtype == torch.bfloat16 and got.shape == like.shape,
                  f"flash backward {name} {kname}: {got.dtype} "
                  f"{tuple(got.shape)}")
        errs = _bwd_errors(name, (dq, dk, dv), ref, BWD_REL_TOL)
        worst = {key: max(worst[key], errs[key]) for key in worst}
        if name.startswith("main"):
            main = (q, k, v, g, out, lse)
            # no atomics: a second call gives the same bits
            again = (fa.flash_attention_bwd_dq(q, k, v, out, lse, g, causal),
                     *fa.flash_attention_bwd_dkv(q, k, v, out, lse, g,
                                                 causal))
            same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
            log(f"flash backward {name}: a second call gives bitwise-equal "
                f"dq, dk, dv: {same}")
            check(same, f"flash backward {name}: two calls differ")
            del again
        del ref, out_ref, lse_ref

    cuda_cores = flash_bwd_cuda_cores_cases(fa, gen)
    worst = {key: max(worst[key], cuda_cores[key]) for key in worst}

    q, k, v, g, out, lse = main
    args = (q, k, v, out, lse, g)
    inputs = fa._kernel_inputs(q, out, lse, g)
    # the training path's call, and each route's entry point
    turns = {kernel: time_routes(
        f"flash backward {kernel} (8,1024,16,128) causal", wrapper,
        lambda kernel=kernel: fa._bwd_launch(kernel, fa.TENSOR_CORES, q, k,
                                             v, *inputs, True),
        lambda kernel=kernel: fa._bwd_launch(kernel, fa.CUDA_CORES, q, k, v,
                                             *inputs, True))
        for kernel, wrapper in (
            ("dq", lambda: fa.flash_attention_bwd_dq(*args)),
            ("dkv", lambda: fa.flash_attention_bwd_dkv(*args)))}
    dq_ms, dkv_ms = turns["dq"]["ms"], turns["dkv"]["ms"]
    dq_plain_ms = time_ms(lambda: fa.flash_attention_bwd_dq_ref(*args))
    dkv_plain_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_ref(*args))
    whole_plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(*args))
    whole_library_ms = _library_bwd_ms(q, k, v, g)
    # the forward as training calls it (with lse), and each route's
    # entry point
    fwd = time_routes(
        "flash_attention (8,1024,16,128) causal with lse",
        lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True),
        lambda: fa._forward_launch(q, k, v, True, True, fa.TENSOR_CORES),
        lambda: fa._forward_launch(q, k, v, True, True, fa.CUDA_CORES))
    fwd_plain_ms = time_ms(lambda: fa.flash_attention_ref(
        q, k, v, causal=True, return_lse=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True))

    # bytes: each input read once, each output written once (bf16 q, k,
    # v, g, out, dq, dk, dv; fp32 lse and D); operations: 2 flops per
    # multiply-add of each (row, col, d) product over the live causal
    # pairs -- forward S and PV, dq S, dP and dQ, dk/dv S, dV, dP and dK
    pairs = b * h * t * (t + 1) // 2
    qn, kn = q.numel(), k.numel()
    rows = b * h * t
    fwd_bound = bound(2 * (qn + 2 * kn + qn) + 4 * rows, 2 * 2 * pairs * d,
                      torch.bfloat16)
    dq_bound = bound(2 * (qn + 2 * kn + qn) + 4 * 2 * rows + 2 * qn,
                     3 * 2 * pairs * d, torch.bfloat16)
    dkv_bound = bound(2 * (qn + 2 * kn + qn) + 4 * 2 * rows + 2 * 2 * kn,
                      4 * 2 * pairs * d, torch.bfloat16)
    log(f"flash backward timing (8,1024,16,128) causal: dq {dq_ms:.4f} ms "
        f"(entry points: tensor cores {turns['dq']['ms_tensor_cores']:.4f}, "
        f"CUDA cores {turns['dq']['ms_cuda_cores']:.4f} ms; plain "
        f"{dq_plain_ms:.4f} ms, bound {dq_bound[0]:.5f} ms, {dq_bound[1]}), "
        f"dk/dv {dkv_ms:.4f} ms (entry points: tensor cores "
        f"{turns['dkv']['ms_tensor_cores']:.4f}, CUDA cores "
        f"{turns['dkv']['ms_cuda_cores']:.4f} ms; plain {dkv_plain_ms:.4f} "
        f"ms, bound {dkv_bound[0]:.5f} ms, {dkv_bound[1]}); whole backward: "
        f"plain {whole_plain_ms:.4f} ms, aten {whole_library_ms:.4f} ms")
    log(f"flash_attention forward timing at the training shape "
        f"(8,1024,16,128) causal with lse: kernel {fwd['ms']:.4f} ms "
        f"(CUDA-core kernel {fwd['ms_cuda_cores']:.4f} ms), plain "
        f"{fwd_plain_ms:.4f} ms, sdpa {fwd_library_ms:.4f} ms, bound "
        f"{fwd_bound[0]:.5f} ms ({fwd_bound[1]})")
    fwd_row.update({**{f"train_{key}": x for key, x in fwd.items()},
                    "train_plain_ms": fwd_plain_ms,
                    "train_bound_ms": fwd_bound[0],
                    "train_bound_by": fwd_bound[1],
                    "train_library_ms": fwd_library_ms})
    # no PyTorch call computes dq or dk/dv alone, so library_ms is null
    # on both rows; aten's whole backward and the whole plain backward
    # stand beside them under names that say so
    common = {"route": "cuda", "source": fa.BWD_SOURCE, "library_ms": None,
              "whole_backward_plain_ms": whole_plain_ms,
              "whole_backward_library_ms": whole_library_ms,
              "timed_route": "tensor_cores",
              "cuda_cores_source": fa.BWD_CUDA_CORES_SOURCE}
    return [{"name": "flash_attention_bwd_dq", "replaces": fa.DQ_REPLACES,
             "max_abs_err": worst["dq"], "ms": dq_ms,
             "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
             "bound_by": dq_bound[1], **common,
             **{key: x for key, x in turns["dq"].items() if key != "ms"}},
            {"name": "flash_attention_bwd_dkv", "replaces": fa.DKV_REPLACES,
             "max_abs_err": worst["dkv"], "ms": dkv_ms,
             "plain_ms": dkv_plain_ms, "bound_ms": dkv_bound[0],
             "bound_by": dkv_bound[1], **common,
             **{key: x for key, x in turns["dkv"].items() if key != "ms"}}]


# ---------------------------------------------------------------------
# phase 2 (int8): the exact int8 product against its plain version


INT8_HEADLINE = "w_up"   # the kernels line's row: decode's largest weight
# products too large for the plain version's int64 sums to be timed
INT8_UNTIMED_PLAIN = ("wave_w_up", "prefill_w_up", "prefill_w_down")


def int8_cases(gen) -> dict:
    """The W8A8 products of the flagship (d_model 2048, d_ff 8192, 16 query
    heads over 4 KV heads of 128, vocab 32768): {name: (a, b)}. Decode's
    weight products at batch 8 (b (K, N) held K-major, as
    ``quant.quantize_params`` holds it); the readout against an
    embedding's int8 rows read in place (``embed.q.t()``, K contiguous);
    a verify window's 8 slots x 5 rows against w_up; the cache scores and
    values at batch 8 over 1536 positions, read in place from a (b, s,
    kv, hd) cache; w_up over an admission wave of 8 x 256 tokens and over
    prefill's 8 x 1024, and prefill's w_down; a ragged K (1027, not a
    multiple of 4) with ragged M and N; rows of -127 against columns of
    127, the largest |sum| (127^2 x 8192), at decode's 8 rows and at 200
    (the tensor cores)."""
    def r8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    def k_major(n, k):
        return r8(n, k).t()

    def full(value, *shape):
        return torch.full(shape, value, dtype=torch.int8, device="cuda")

    embed_q = r8(32768, 2048)
    k_cache, v_cache = r8(8, 1536, 4, 128), r8(8, 1536, 4, 128)
    return {
        "wqkv": (r8(8, 2048), k_major(3072, 2048)),
        "wo": (r8(8, 2048), k_major(2048, 2048)),
        "w_up": (r8(8, 2048), k_major(8192, 2048)),
        "w_down": (r8(8, 8192), k_major(2048, 8192)),
        "readout": (r8(8, 2048), embed_q.t()),
        "verify_w_up": (r8(40, 2048), k_major(8192, 2048)),
        "cache_scores": (r8(8, 4, 4, 128), k_cache.permute(0, 2, 3, 1)),
        "cache_values": (r8(8, 4, 4, 1536), v_cache.permute(0, 2, 1, 3)),
        "wave_w_up": (r8(2048, 2048), k_major(8192, 2048)),
        "prefill_w_up": (r8(8192, 2048), k_major(8192, 2048)),
        "prefill_w_down": (r8(8192, 8192), k_major(2048, 8192)),
        "ragged": (r8(37, 1027), r8(1027, 301)),
        "extreme": (full(-127, 8, 8192), full(127, 2048, 8192).t()),
        "extreme_tc": (full(-127, 200, 8192), full(127, 2048, 8192).t()),
    }


def _int_mm_ms(a, b, want):
    """``torch._int_mm`` (2-D only; it takes M > 16 and K, N multiples of
    8) on the same operands, M padded to 32 where it is not over 16:
    its time, after checking its product. None where it cannot take the
    shape."""
    if a.dim() != 2 or a.shape[1] % 8 or b.shape[1] % 8:
        return None
    ap = a if a.shape[0] > 16 else torch.nn.functional.pad(
        a, (0, 0, 0, 32 - a.shape[0]))
    check(torch.equal(torch._int_mm(ap, b)[:a.shape[0]], want),
          "torch._int_mm disagrees with the exact product")
    return time_ms(lambda: torch._int_mm(ap, b))


def time_int8_routes(im, name: str, a, b, routes) -> dict:
    """Every route that takes (a, b), launched uncounted through
    ``im._launch``, timed in turns (the routes in order, then reversed)
    both ways (``time_ms``, and device time alone), each the mean of its
    two medians, and by host time per call. Returns {route: {"ms",
    "device_ms", "host_us"}}."""
    res = {r: {} for r in routes}
    order = list(routes) + list(reversed(routes))
    for cover, key in ((False, "ms"), (True, "device_ms")):
        times = {r: [] for r in routes}
        for r in order:
            times[r].append(time_ms(lambda r=r: im._launch(r, a, b),
                                    cover_enqueue=cover))
        for r in routes:
            res[r][key] = sum(times[r]) / len(times[r])
        log(f"int8_matmul {name} in turns ({key}): " + "; ".join(
            f"{r} {', '.join(f'{t:.4f}' for t in times[r])} ms"
            for r in routes))
    for r in routes:
        res[r]["host_us"] = host_us(lambda r=r: im._launch(r, a, b),
                                    calls=20, rounds=3)
    return res


def int8_phase(im, quant) -> dict:
    """The int8 product at every shape of ``int8_cases``: through the
    wrapper (its route asserted to be ``int8_route``'s) and through every
    route that takes the shape (``int8_routes``), each bitwise equal
    (``torch.equal``) to the plain version (int64 products, summed,
    cast), all exact int32. The routes are timed in turns
    (``time_int8_routes``) beside the plain version, ``torch._int_mm``
    and the port's dequant product of the same weight (``quant.linear``
    / ``quant.readout`` with ``native=False``: the int8 weight cast at
    the product, fp32 accumulation). Returns the kernels line's row (the
    ``INT8_HEADLINE`` case), every case under ``cases``."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases, worst = {}, 0
    for name, (a, b) in int8_cases(gen).items():
        route, takes = im.int8_route(a, b), im.int8_routes(a, b)
        zero_counts(im.int8_matmul)
        got = im.int8_matmul(a, b)
        check(im.int8_matmul.launches_by_route[route] == 1
              and im.int8_matmul.launches == 1,
              f"int8_matmul {name}: launches {im.int8_matmul.launches_by_route}"
              f", expected one on {route}")
        want = im.int8_matmul_ref(a, b)
        torch.cuda.synchronize()
        for r, out in [("wrapper", got)] + [(r, im._launch(r, a, b))
                                            for r in takes]:
            torch.cuda.synchronize()
            err = int((out.long() - want.long()).abs().max())
            worst = max(worst, err)
            check(torch.equal(out, want) and out.dtype == torch.int32,
                  f"int8_matmul {name} {tuple(a.shape)} x {tuple(b.shape)} "
                  f"({r}): differs from its plain version by up to {err}")
            if name.startswith("extreme"):
                check(bool((out == -127 * 127 * a.shape[1]).all()),
                      f"int8_matmul {name} ({r}): not -127^2 K everywhere")
        log(f"int8_matmul {name}: {route} of {takes}, every route bitwise "
            "equal to the plain version")
        if name.startswith("extreme"):
            continue
        batch = a.numel() // (a.shape[-2] * a.shape[-1])
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        bnd = bound(a.numel() + b.numel() + 4 * batch * m * n,
                    2 * batch * m * n * k, torch.int8)
        by_route = time_int8_routes(im, name, a, b, takes)
        for t in by_route.values():
            t["share_of_bound"] = bnd[0] / t["device_ms"]
        row = {"a": list(a.shape), "b": list(b.shape),
               "b_strides": list(b.stride()), "route": route,
               "ms": time_ms(lambda: im.int8_matmul(a, b)),
               "device_ms": by_route[route]["device_ms"],
               "host_us": host_us(lambda: im.int8_matmul(a, b), calls=20,
                                  rounds=3),
               "plain_ms": (time_ms(lambda: im.int8_matmul_ref(a, b), reps=3,
                                    warmup=1)
                            if name not in INT8_UNTIMED_PLAIN else None),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": _int_mm_ms(a, b, want), "routes": by_route}
        if im.GEMV in takes:
            row["gemv_plan"] = list(im.gemv_plan(
                batch, m, n, k, b.stride(-1) == 1 or b.shape[-1] == 1))
        if name in ("wqkv", "wo", "w_up", "w_down", "readout"):
            x = torch.randn(a.shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            if name == "readout":
                emb = quant.QuantArray(b.t(), torch.ones(
                    b.shape[1], 1, device="cuda"))
                row["dequant_ms"] = time_ms(
                    lambda: quant.readout(x, emb, native=False))
            else:
                w = quant.QuantArray(b, torch.ones(1, n, device="cuda"))
                row["dequant_ms"] = time_ms(
                    lambda: quant.linear(x, w, native=False))
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        log(f"int8_matmul {name}: {row}")
        cases[name] = row
    head = cases[INT8_HEADLINE]
    return {"name": "int8_matmul", "route": "cuda", "source": im.SOURCE,
            "sources": im.SOURCES, "replaces": im.REPLACES,
            "max_abs_err": float(worst), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "device_ms": head["device_ms"], "shape": INT8_HEADLINE,
            "cases": cases}


# ---------------------------------------------------------------------
# phase 3: a tiny model on the card against the CPU plain path


def _small_compare(tf, cfg, cpu_params, name, prompts, card, plain,
                   exact=()) -> None:
    """Streams from the card against the CPU plain path's: equal, or
    split at a near tie (the plain forward's top-2 logit margin at the
    split under SMALL_MARGIN). The sampled streams in ``exact`` must be
    equal."""
    ties = 0
    for rid in sorted(plain):
        a, b = card[rid], plain[rid]
        if a == b:
            continue
        check(rid not in exact,
              f"small phase {name}: sampled {rid} differs, card {a}, CPU {b}")
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = torch.tensor([prompts[rid] + b[:i]])
        logits = tf.forward(cpu_params, seq, cfg)[0, -1]
        top2 = logits.topk(2).values
        margin = float(top2[0] - top2[1])
        check(margin < SMALL_MARGIN,
              f"small phase {name}: {rid} splits at token {i} with top-2 "
              f"margin {margin} (card {a[i]}, plain {b[i]})")
        ties += 1
    log(f"small model {name}: {len(plain)} streams, card vs CPU plain path: "
        f"{len(plain) - ties} equal, {ties} split at a near tie")


def small_streams(serving, rng, vocab: int) -> dict:
    """The admission streams of phase 3: {name: (engine class, config,
    waves of {request id: (prompt, Request keywords)})}, each wave
    drained before the next."""
    def prompt(n):
        return rng.randint(0, vocab, size=n).tolist()

    head = prompt(32)
    paged = dict(max_len=80, chunk=8, block_size=16, paged_kernel=True)
    return {
        # a head stored (its rows copied into the prefix arena), then two
        # members restored from it, their suffixes run against it, and a
        # wave of two misses of the head's bucket
        "dense prefix hits": (
            serving.ServingEngine,
            serving.ServingConfig(max_slots=4, max_len=80, chunk=8,
                                  prefix_cache_entries=4),
            [{"h": (head, dict(cache_prefix=True))},
             {"m0": (head + prompt(5), {}), "m1": (head + prompt(9), {}),
              "d0": (prompt(20), {}), "d1": (prompt(27), {})}]),
        # a head stored for sharing (2 blocks), then two members
        # pointed at its blocks
        "paged prefix hits": (
            serving.PagedServingEngine,
            serving.ServingConfig(max_slots=4, paged_blocks=24,
                                  prefix_cache_entries=4, **paged),
            [{"h": (head, dict(cache_prefix=True))},
             {"m0": (head + prompt(5), {}), "m1": (head + prompt(9), {})}]),
        # windows of 8, interleaved with decode
        "dense chunked prefill": (
            serving.ServingEngine,
            serving.ServingConfig(max_slots=4, max_len=80, chunk=8,
                                  prefill_chunk=8),
            [{f"c{i}": (prompt(n), {}) for i, n in enumerate((5, 17, 30, 41,
                                                              12))}]),
        # 5 misses of one bucket: one stacked wave of 4, then 1
        "wave of 5": (
            serving.PagedServingEngine,
            serving.ServingConfig(max_slots=8, paged_blocks=40, paged_width=5,
                                  **paged),
            [{f"w{i}": (prompt(n), {}) for i, n in enumerate((17, 20, 24, 29,
                                                              32))}]),
    }


def _tree_to(tree, fn):
    """``fn`` applied to every tensor of a parameter tree (dicts, lists,
    int8 QuantArrays)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, fn) for v in tree]
    if isinstance(tree, tuple):   # a QuantArray
        return type(tree)(*(fn(v) for v in tree))
    return fn(tree)


def small_phase(tf, serving, fa, pa) -> None:
    """A tiny fp32 flash model served on the card (the flash forward on
    its CUDA-core route and the paged kernel on its one-pass route:
    fp32 stays exact) against the CPU plain path: a stream under pool
    pressure (admission waits and preempts), then the admission streams
    of ``small_streams`` (paged prefix hits, dense chunked prefill, a
    wave of 5 misses), then the same pressure stream through the
    speculative engines (prompt lookup, a one-layer draft model, paged
    under pool pressure and with chunked prefill) and the overlapped
    dense grid. Each run's flash launches are n_layers x the prefill
    dispatches the engine reports (plus the draft's layers x its
    prefills), its paged launches n_layers x chunk x decode rounds
    (none for the speculative engines: their windows read the gather
    view). Then ``engines_report`` and ``serving_report`` on the card."""
    cfg = tf.ModelConfig(vocab_size=256, d_model=128, n_heads=4,
                         n_kv_heads=2, n_layers=2, d_ff=256, max_seq=128,
                         dtype="float32", flash=True)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                            "cuda")
    cpu_params = _tree_to(params, lambda t: t.cpu())
    dcfg = tf.ModelConfig(vocab_size=cfg.vocab_size, d_model=64, n_heads=2,
                          n_layers=1, d_ff=128, max_seq=128, dtype="float32",
                          flash=True)
    dparams = tf.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(4), "cuda")
    drafts = {"cuda": (dparams, dcfg), "cpu": (_tree_to(dparams, lambda t: t.cpu()), dcfg)}
    rng = np.random.RandomState(3)
    pressure = [{f"s{i}": (rng.randint(0, cfg.vocab_size, size=n).tolist(),
                           {})
                 for i, n in enumerate((5, 17, 30, 41, 12, 26))}]
    # 8 usable blocks of 16 for 4 slots: admission waits and preempts
    streams = {"under pool pressure": (
        serving.PagedServingEngine,
        serving.ServingConfig(max_slots=4, max_len=80, chunk=8,
                              paged_blocks=9, block_size=16,
                              paged_kernel=True), pressure)}
    streams.update(small_streams(serving, rng, cfg.vocab_size))
    spec = dict(max_slots=4, max_len=80, speculative_k=3)
    # a sampled request beside them: its draws are an integer hash of
    # (seed, generation index), so the card gives the CPU's tokens
    samp = serving.SamplingConfig(temperature=0.9, top_k=40)
    with_sampled = [dict(pressure[0], sampled=(
        rng.randint(0, cfg.vocab_size, size=19).tolist(),
        dict(sampling=samp, seed=23)))]
    streams.update({
        "speculative prompt lookup with a sampled request": (
            serving.SpeculativeServingEngine, serving.ServingConfig(**spec),
            with_sampled),
        "speculative draft model": (
            serving.SpeculativeServingEngine, serving.ServingConfig(**spec),
            pressure, "draft"),
        "paged speculative under pool pressure": (
            serving.PagedSpeculativeServingEngine,
            serving.ServingConfig(paged_blocks=9, block_size=16, **spec),
            pressure),
        "paged speculative chunked prefill": (
            serving.PagedSpeculativeServingEngine,
            serving.ServingConfig(paged_blocks=24, block_size=16,
                                  prefill_chunk=8, **spec), pressure),
        "dense overlapped": (
            serving.ServingEngine,
            serving.ServingConfig(max_slots=4, max_len=80, chunk=8,
                                  overlap_rounds=True), pressure),
    })

    def run(engine, sc, waves, p, device, draft=False):
        extra = {"draft": drafts[device]} if draft else {}
        eng = engine(p, cfg, sc, device=device, **extra)
        programs = []
        if device == "cpu":
            # the admission programs the stream runs: their keys and
            # count, which the card's graphs must capture and replay
            def counted(key, fn):
                programs.append(key)
                return fn()

            eng._admit_round = counted
        done = {}
        for wave in waves:
            for rid, (prompt, kw) in wave.items():
                eng.submit(serving.Request(rid, prompt, max_new=24, **kw))
            done.update({c.request_id: c.tokens for c in eng.run()})
        rep = eng.report()
        check(rep.get("paged", {}).get("blocks_in_use", 0)
              == sum(len(e.get("blocks", ())) for e in getattr(
                  eng.prefix_cache, "entries", {}).values()),
              f"small phase ({device}): blocks left in use beyond the "
              "prefix cache's")
        if device == "cpu":
            rep["admission"] = (len(set(programs)),
                                len(programs) - len(set(programs)))
        else:
            runner = eng._admit_round
            check(runner.__class__.__name__ == "RoundGraphs",
                  f"small phase: admission runs through {runner!r}")
            rep["admission"] = (runner.captured, runner.replays)
        return done, rep

    for name, (engine, sc, waves, *draft) in streams.items():
        zero_counts(fa.flash_attention, pa.paged_attention)
        card, rep = run(engine, sc, waves, params, "cuda", bool(draft))
        n = fa.flash_attention.launches
        want = (cfg.n_layers * rep["prefill_dispatches"]
                + dcfg.n_layers * rep.get("draft_prefills", 0))
        check(n == want > 0,
              f"small phase {name}: {n} flash launches, expected n_layers x "
              f"{rep['prefill_dispatches']} prefill dispatches + the draft's "
              f"layers x {rep.get('draft_prefills', 0)} prefills")
        check_routes(f"small model {name} flash_attention", fa.flash_attention,
                     0, n)
        n_paged = pa.paged_attention.launches
        want = (cfg.n_layers * sc.chunk * rep["decode_rounds"]
                if engine is serving.PagedServingEngine else 0)
        check(n_paged == want,
              f"small phase {name}: {n_paged} paged launches, expected "
              f"{want}")
        check_routes(f"small model {name} paged_attention",
                     pa.paged_attention, 0, n_paged)
        plain, plain_rep = run(engine, sc, waves, cpu_params, "cpu",
                               bool(draft))
        for key in ("prefix_cache", "waves", "suffix_windows", "admission"):
            check(rep.get(key) == plain_rep.get(key),
                  f"small phase {name}: {key} {rep.get(key)} on the card, "
                  f"{plain_rep.get(key)} on the CPU")
        prompts = {rid: prompt for wave in waves
                   for rid, (prompt, _) in wave.items()}
        exact = {rid for wave in waves for rid, (_, kw) in wave.items()
                 if "sampling" in kw}
        _small_compare(tf, cfg, cpu_params, name, prompts, card, plain,
                       exact)
        log(f"small model {name}: prefill dispatches "
            f"{rep['prefill_dispatches']}, waves {rep['waves']}, suffix "
            f"windows {rep['suffix_windows']}, prefix cache "
            f"{rep.get('prefix_cache')}, preemptions "
            f"{rep.get('paged', {}).get('preemptions')}, speculative "
            f"{rep.get('speculative')} (CPU "
            f"{plain_rep.get('speculative')}); admission graphs captured, "
            f"replays {rep['admission']} (the CPU's distinct programs, "
            "repeats)")
        if name in ("dense prefix hits", "dense chunked prefill",
                    "under pool pressure"):
            check(rep["admission"][1] > 0,
                  f"small phase {name}: no admission graph replayed")
        if name == "dense prefix hits":
            check(rep["prefix_cache"]["hits"] == 2
                  and rep["suffix_windows"] == 2 and rep["waves"],
                  f"small phase {name}: {rep['prefix_cache']}, suffix "
                  f"windows {rep['suffix_windows']}, waves {rep['waves']}")
        elif name == "paged prefix hits":
            check(rep["prefix_cache"]["hits"] == 2,
                  f"small phase {name}: {rep['prefix_cache']}")
        elif name == "wave of 5":
            check(rep["waves"] == {1: 1, 4: 1},
                  f"small phase {name}: waves {rep['waves']}")
        elif name.startswith("paged speculative under"):
            check(rep["paged"]["preemptions"] > 0,
                  f"small phase {name}: no preemption")
    for report in (serving.engines_report, serving.serving_report):
        rep = report(device="cuda")
        log(f"small model {report.__name__} on the card: {rep}")
        check(rep["ok"] is True, f"{report.__name__} on the card: {rep}")


def small_int8_moe_phase(tf, serving, quant, fa, pa, im) -> None:
    """Phase 3, the int8 tiers and MoE: a tiny fp32 flash model on the
    card against the CPU plain path, as ``small_phase`` holds it. An int8
    snapshot (W8A8, int8 KV) through the dense grid and the paged gather
    tier, every W8A8 product on the int8 kernel (launched, counted; none
    in the MoE runs); an MoE of 4 experts (2 would give every expert the
    capacity of every token, so no routed set could show) through the
    dense grid, the paged kernel tier (paged launches n_layers x chunk x
    decode rounds) and the speculative grid; then a wave of 5 MoE
    admissions (one stacked wave of 4, then 1), whose first tokens must
    equal each prompt admitted alone in its bucket."""
    from kind_tpu_sim_torch.models import decode

    base = tf.ModelConfig(vocab_size=256, d_model=128, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=256, max_seq=128,
                          dtype="float32", flash=True)
    q_cfg = dataclasses.replace(base, int8_kv=True, int8_native=True)
    m_cfg = dataclasses.replace(base, n_experts=4)
    dense = tf.init_params(base, torch.Generator(device="cuda").manual_seed(7),
                           "cuda")
    models = {
        "int8": (q_cfg, quant.quantize_params(dense, q_cfg)),
        "MoE": (m_cfg, tf.init_params(
            m_cfg, torch.Generator(device="cuda").manual_seed(8), "cuda")),
    }
    rng = np.random.RandomState(7)
    pressure = [{f"s{i}": (rng.randint(0, base.vocab_size, size=n).tolist(),
                           {})
                 for i, n in enumerate((5, 17, 30, 41, 12, 26))}]
    grid = dict(max_slots=4, max_len=80, chunk=8)
    wave = [{f"w{i}": (rng.randint(0, base.vocab_size, size=n).tolist(), {})
             for i, n in enumerate((17, 20, 24, 29, 32))}]
    runs = {
        "int8 dense grid": ("int8", serving.ServingEngine,
                            serving.ServingConfig(**grid), pressure),
        "int8 paged gather tier": ("int8", serving.PagedServingEngine,
                                   serving.ServingConfig(
                                       paged_blocks=9, block_size=16, **grid),
                                   pressure),
        "MoE dense grid": ("MoE", serving.ServingEngine,
                           serving.ServingConfig(**grid), pressure),
        "MoE paged kernel tier": ("MoE", serving.PagedServingEngine,
                                  serving.ServingConfig(
                                      paged_blocks=9, block_size=16,
                                      paged_kernel=True, **grid), pressure),
        "MoE speculative grid": ("MoE", serving.SpeculativeServingEngine,
                                 serving.ServingConfig(
                                     max_slots=4, max_len=80,
                                     speculative_k=3), pressure),
        "MoE wave of 5": ("MoE", serving.PagedServingEngine,
                          serving.ServingConfig(
                              paged_blocks=40, paged_width=5, block_size=16,
                              paged_kernel=True, **dict(grid, max_slots=8)),
                          wave),
    }

    def run(engine, sc, waves, cfg, params, device):
        eng = engine(params, cfg, sc, device=device)
        done = {}
        for w in waves:
            for rid, (prompt, kw) in w.items():
                eng.submit(serving.Request(rid, prompt, max_new=24, **kw))
            done.update({c.request_id: c.tokens for c in eng.run()})
        return done, eng.report()

    cpu = {name: (cfg, _tree_to(p, lambda t: t.cpu()))
           for name, (cfg, p) in models.items()}
    for name, (model, engine, sc, waves) in runs.items():
        cfg, params = models[model]
        zero_counts(fa.flash_attention, pa.paged_attention, im.int8_matmul)
        card, rep = run(engine, sc, waves, cfg, params, "cuda")
        n_flash = fa.flash_attention.launches
        n_paged = pa.paged_attention.launches
        n_int8 = im.int8_matmul.launches
        check(n_flash == cfg.n_layers * rep["prefill_dispatches"] > 0,
              f"small phase {name}: {n_flash} flash launches, expected "
              f"n_layers x {rep['prefill_dispatches']}")
        want_paged = (cfg.n_layers * sc.chunk * rep["decode_rounds"]
                      if sc.paged_kernel else 0)
        check(n_paged == want_paged,
              f"small phase {name}: {n_paged} paged launches, expected "
              f"{want_paged}")
        check((n_int8 > 0) == (model == "int8"),
              f"small phase {name}: {n_int8} int8_matmul launches")
        plain, plain_rep = run(engine, sc, waves, *cpu[model], "cpu")
        check(rep.get("waves") == plain_rep.get("waves"),
              f"small phase {name}: waves {rep.get('waves')} on the card, "
              f"{plain_rep.get('waves')} on the CPU")
        prompts = {rid: p for w in waves for rid, (p, _) in w.items()}
        _small_compare(tf, cfg, cpu[model][1], name, prompts, card, plain)
        log(f"small model {name}: launches flash {n_flash}, paged {n_paged}, "
            f"int8_matmul {n_int8}; waves {rep['waves']}, decode rounds "
            f"{rep['decode_rounds']}")
        if name == "MoE wave of 5":
            check(rep["waves"] == {1: 1, 4: 1},
                  f"small phase {name}: waves {rep['waves']}")
            for rid, prompt in prompts.items():
                window = torch.as_tensor(serving._padded_window(prompt),
                                         device="cuda")
                alone = serving._prefill_into_slot(
                    params, decode.init_cache(cfg, 1, window.shape[1],
                                              device="cuda"),
                    window, len(prompt), 0, cfg=cfg)
                check(int(alone.argmax()) == card[rid][0],
                      f"small phase {name}: {rid}'s first token "
                      f"{card[rid][0]} in the wave, "
                      f"{int(alone.argmax())} admitted alone")
            log(f"small model {name}: every first token equals its prompt "
                "admitted alone")


# ---------------------------------------------------------------------
# phase 4: serving at full width


def serve(serving, params, cfg, sc, reqs):
    eng = serving.PagedServingEngine(params, cfg, sc, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    done = {c.request_id: c for c in eng.run()}
    torch.cuda.synchronize()
    return eng, done, time.perf_counter() - t0


def serve_phase(flagship, serving, fa, pa, sp, cfg) -> dict:
    """The flagship workload of ``kind_tpu_sim_torch.profile_serving``
    (the same stream, configuration and seed; ``sp`` the bf16 serving
    snapshot). Its admission waves stack the 8 first prompts into one
    prefill, so the flash kernel launches once per layer and dispatch."""
    pool_blocks = flagship.POOL_BLOCKS
    kernel_sc = flagship.flagship_serving(paged_kernel=True)
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)

    # warm-up: one request through prefill and one decode round
    serve(serving, sp, cfg, kernel_sc,
          [dataclasses.replace(reqs[0], request_id="warm", max_new=65)])

    zero_counts(fa.flash_attention, pa.paged_attention)
    eng, done, wall = serve(serving, sp, cfg, kernel_sc, reqs)
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches}
    flash_routes = dict(fa.flash_attention.launches_by_route)
    paged_routes = dict(pa.paged_attention.launches_by_route)

    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} completed")
    for r in reqs:
        c = done[r.request_id]
        check(len(c.tokens) == r.max_new and c.finish_reason == "length",
              f"{r.request_id}: {len(c.tokens)} tokens, {c.finish_reason}")
        check(all(math.isfinite(x) for x in c.logprobs),
              f"{r.request_id}: non-finite logprobs (NaN logits)")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"{r.request_id}: token out of range")
    rep = eng.report()
    check(rep["paged"]["blocks_in_use"] == 0,
          f"{rep['paged']['blocks_in_use']} blocks still in use")
    want_flash = cfg.n_layers * rep["prefill_dispatches"]
    want_paged = cfg.n_layers * kernel_sc.chunk * rep["decode_rounds"]
    log(f"launches: flash_attention {launches['flash_attention']} "
        f"(expected n_layers x prefill dispatches = {want_flash}; "
        f"{rep['prefills']} prefills in waves {rep['waves']}), "
        "paged_attention "
        f"{launches['paged_attention']} (expected n_layers x chunk x "
        f"decode rounds = {want_paged})")
    check(launches["flash_attention"] == want_flash > 0,
          "flash_attention launch count")
    check(launches["paged_attention"] == want_paged > 0,
          "paged_attention launch count")
    check_routes("serving flash_attention", fa.flash_attention, want_flash, 0)
    check(paged_routes == {"split_kv": want_paged, "one_pass": 0},
          f"serving paged_attention: launches by route {paged_routes}, "
          f"expected all {want_paged} on split_kv")
    log(f"serving paged_attention: launches by route {paged_routes}")

    gen_tokens = sum(len(c.tokens) for c in done.values())
    ttft = float(np.mean([c.ttft_s for c in done.values()]))
    e2e = float(np.mean([c.e2e_s for c in done.values()]))
    log(f"serving kernel tier: {len(done)} requests, {gen_tokens} tokens in "
        f"{wall:.3f} s = {gen_tokens / wall:.1f} generated tok/s; mean TTFT "
        f"{ttft:.3f} s, mean e2e {e2e:.3f} s; prefills {rep['prefills']}, "
        f"decode rounds {rep['decode_rounds']}, preemptions "
        f"{rep['paged']['preemptions']}, peak blocks "
        f"{rep['paged']['peak_in_use']} of {pool_blocks - 1}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same stream on the gather tier (no paged kernel); reported,
    # not gated: bf16 argmax near ties at full width may split
    _, gdone, gwall = serve(serving, sp, cfg,
                            flagship.flagship_serving(paged_kernel=False),
                            reqs)
    agree, first = 0, None
    for r in reqs:
        a, b = done[r.request_id].tokens, gdone[r.request_id].tokens
        if a == b:
            agree += 1
        elif first is None:
            i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            first = f"{r.request_id} at token {i} ({a[i]} vs {b[i]})"
    log(f"serving gather tier: {gen_tokens} tokens in {gwall:.3f} s = "
        f"{gen_tokens / gwall:.1f} generated tok/s; streams equal to the "
        f"kernel tier: {agree} of {len(reqs)}; first divergence: {first}")
    return launches, {"flash_attention": flash_routes,
                      "paged_attention": paged_routes}, {
        rid: c.tokens for rid, c in done.items()}


def _snapshot(pools, blocks) -> torch.Tensor:
    """Every layer's k and v rows of ``blocks``, stacked (a copy)."""
    idx = torch.as_tensor(blocks, device=pools[0]["k"].device)
    return torch.stack([lc[name][idx] for lc in pools for name in ("k", "v")])


# first-token and stream logprobs, admission graphs against eager
# admission (the rounds graphed both ways): the compiled rounds' bar
ADMISSION_LP_TOL = 1e-4


def admission_runs(label: str, eng, reqs, reset=None) -> dict:
    """``reqs`` served twice by ``eng``, whose rounds stay graphs:
    admission through its graphs, then with its admission runner bound
    to ``graphs.eager`` (``reset()`` before each). Token streams equal,
    logprobs within ``ADMISSION_LP_TOL`` (reported bitwise where they
    are), no admission graph captured by the graphed run (its keys were
    warmed); admission's host wall both ways (it ends in each
    activation's first-token readback, so its device work is inside)."""
    from kind_tpu_sim_torch.models import graphs

    runner = eng._admit_round
    captured = runner.captured
    runs = {}
    for path in ("graph", "eager"):
        if reset is not None:
            reset()
        eng._admit_round = runner if path == "graph" else graphs.eager
        admit, spent = eng._admit_and_advance, [0.0]

        def timed() -> None:
            t = time.perf_counter()
            admit()
            spent[0] += time.perf_counter() - t

        eng._admit_and_advance = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(dataclasses.replace(r, logprobs=True))
        done = {c.request_id: c for c in eng.run()}
        torch.cuda.synchronize()
        runs[path] = (done, time.perf_counter() - t0, spent[0])
        del eng._admit_and_advance
    eng._admit_round = runner
    graph, eager = runs["graph"][0], runs["eager"][0]
    check(len(graph) == len(eager) == len(reqs),
          f"{label}: {len(graph)} and {len(eager)} of {len(reqs)} completed")
    check(all(graph[r].tokens == eager[r].tokens for r in graph),
          f"{label}: admission graphs and eager admission serve other "
          "streams")
    diff = max(float(np.abs(np.asarray(graph[r].logprobs)
                            - np.asarray(eager[r].logprobs)).max())
               for r in graph)
    first = max(abs(graph[r].logprobs[0] - eager[r].logprobs[0])
                for r in graph)
    bitwise = all(graph[r].logprobs == eager[r].logprobs for r in graph)
    check(diff <= ADMISSION_LP_TOL,
          f"{label}: logprobs differ by {diff:.3e} (bar {ADMISSION_LP_TOL})")
    check(runner.captured == captured,
          f"{label}: {runner.captured - captured} admission graphs captured "
          "in a warmed run")
    out = {"requests": len(reqs), "logprobs_max_diff": diff,
           "first_token_logprob_max_diff": first,
           "logprobs_bitwise": bitwise,
           "graph": {"wall_s": runs["graph"][1],
                     "admission_s": runs["graph"][2]},
           "eager": {"wall_s": runs["eager"][1],
                     "admission_s": runs["eager"][2]},
           "admission_graphs": runner.captured,
           "admission_capture_s": runner.capture_s,
           "admission_replays": runner.replays}
    log(f"{label}: {len(reqs)} requests, streams equal with graphed and "
        f"eager admission; logprobs {'bitwise equal' if bitwise else ''}"
        f" max difference {diff:.3e} (first tokens {first:.3e}; bar "
        f"{ADMISSION_LP_TOL}); admission {out['graph']['admission_s']:.3f} "
        f"s graphed / {out['eager']['admission_s']:.3f} s eager of walls "
        f"{out['graph']['wall_s']:.3f} / {out['eager']['wall_s']:.3f} s; "
        f"admission graphs {runner.captured} captured in "
        f"{runner.capture_s:.2f} s, {runner.replays} replays")
    return out


def realistic_phase(flagship, serving, fa, pa, sp, cfg) -> dict:
    """Phase 4b: the realistic stream of ``profile_serving`` (28
    requests: mixed 224-3072-token prompts and prefix families) through
    ``PagedServingEngine`` on the kernel tier with prefix caching and
    admission waves, the pool well under worst-case demand. Warmed with
    ``warm_admission`` first; launch counters zeroed just before the
    stream and read just after. Each new prefix-cache entry's blocks
    are copied when it is stored, and held against that copy after each
    round while the entry lasts and whenever a family member that hit
    finishes. Gates:
    every request's 128 tokens with finite logprobs; hits, shared blocks
    and preemptions; the blocks in use after the drain are the cache's
    alone, and none once it is emptied; an entry's blocks unchanged
    after its members decoded; the flash launches n_layers x the
    engine's prefill dispatches, all on the tensor cores, and the paged
    launches n_layers x chunk x decode rounds, all on split_kv."""
    sc = flagship.realistic_serving()
    reqs = flagship.realistic_requests(cfg.vocab_size, logprobs=True)
    eng = serving.PagedServingEngine(sp, cfg, sc, device="cuda")
    before = eng.report()
    t0 = time.perf_counter()
    eng.warm_admission(flagship.REALISTIC_LENS, sizes=sc.admission_wave_sizes)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(eng.report() == before and eng.alloc.peak_in_use == 0,
          f"warm_admission changed the engine: {eng.report()}")
    warm_graphs = eng._admit_round.captured
    check(warm_graphs == len(flagship.REALISTIC_LENS)
          * len(sc.admission_wave_sizes),
          f"warm_admission captured {warm_graphs} admission graphs")
    cache = eng.prefix_cache
    # {stored blocks: their k/v when stored}; a new entry replaces the
    # snapshot of blocks reused since
    snaps, verified = {}, set()
    store, finish = cache.store, eng._finish

    def snapshot_store(prompt, blocks) -> None:
        new = tuple(prompt[:len(prompt) // sc.block_size * sc.block_size])
        fresh = new not in cache.entries
        store(prompt, blocks)
        if fresh and new in cache.entries:
            held = tuple(cache.entries[new]["blocks"])
            snaps[held] = _snapshot(eng.pools, held)

    def unchanged(held, when: str) -> None:
        check(torch.equal(_snapshot(eng.pools, held), snaps[held]),
              f"realistic: {len(held)} shared blocks changed ({when})")

    def checked_finish(slot: int) -> None:
        # a member that hit releases the head's blocks: they must hold
        # what the head's prefill wrote
        rid = eng.slot_req[slot].request_id
        family = rid[:-2] if rid.startswith("rf") and rid[-2] == "m" else None
        n = len(heads.get(family, ())) // sc.block_size
        held = tuple(eng.slot_blocks[slot][:n])
        if family is not None and held in snaps:
            unchanged(held, f"when {rid} finished")
            verified.add(family)
        finish(slot)

    admit = eng._admit_and_advance
    admission_s = [0.0]

    def timed_admission() -> None:
        # host time of admission; it ends in the first tokens' readback
        # whenever a prompt completes, so its device work is inside
        t = time.perf_counter()
        admit()
        admission_s[0] += time.perf_counter() - t

    heads = {r.request_id[:-1]: r.prompt for r in reqs if r.cache_prefix}
    cache.store = snapshot_store
    eng._finish = checked_finish
    eng._admit_and_advance = timed_admission
    zero_counts(fa.flash_attention, pa.paged_attention)
    torch.cuda.reset_peak_memory_stats()
    done = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    while eng.queue or eng._pending or any(
            r is not None for r in eng.slot_req):
        eng.step_round()
        done.update({c.request_id: c for c in eng.poll()})
        for entry in cache.entries.values():
            unchanged(tuple(entry["blocks"]), "after a round")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches}
    routes = {"flash_attention": dict(fa.flash_attention.launches_by_route),
              "paged_attention": dict(pa.paged_attention.launches_by_route)}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cache.store = store
    del eng._finish, eng._admit_and_advance
    admission = {"graphs": eng._admit_round.captured,
                 "warm_graphs": warm_graphs,
                 "capture_s": eng._admit_round.capture_s,
                 "replays": eng._admit_round.replays}

    check(len(done) == len(reqs), f"realistic: {len(done)} of {len(reqs)} "
          "completed")
    for r in reqs:
        c = done[r.request_id]
        check(len(c.tokens) == r.max_new and c.finish_reason == "length",
              f"realistic {r.request_id}: {len(c.tokens)} tokens, "
              f"{c.finish_reason}")
        check(all(math.isfinite(x) for x in c.logprobs),
              f"realistic {r.request_id}: non-finite logprobs")
    rep = eng.report()
    pc, pg = rep["prefix_cache"], rep["paged"]
    log(f"realistic: report {json.dumps(rep)}")
    check(pc["hits"] > 0 and pc["shared_blocks"] > 0,
          f"realistic: no prefix sharing ({pc})")
    check(pg["preemptions"] > 0,
          f"realistic: no preemption with {sc.paged_blocks} blocks; lower "
          "the pool")
    held = {b for e in cache.entries.values() for b in e["blocks"]}
    check(pg["blocks_in_use"] == len(held),
          f"realistic: {pg['blocks_in_use']} blocks in use after the drain, "
          f"the prefix cache holds {len(held)}")
    while cache.evict_lru():
        pass
    in_use = eng.report()["paged"]["blocks_in_use"]
    check(in_use == 0, f"realistic: {in_use} blocks leaked")
    check(bool(verified), "realistic: no member that hit finished: no "
          "family's shared blocks were held against their copy after its "
          "members decoded")
    want_flash = cfg.n_layers * rep["prefill_dispatches"]
    want_paged = cfg.n_layers * sc.chunk * rep["decode_rounds"]
    log(f"realistic launches: flash_attention {launches['flash_attention']} "
        f"(expected n_layers x prefill dispatches = {want_flash}), "
        f"paged_attention {launches['paged_attention']} (expected n_layers "
        f"x chunk x decode rounds = {want_paged}); by route {routes}")
    check(launches["flash_attention"] == want_flash > 0,
          "realistic: flash_attention launch count")
    check(launches["paged_attention"] == want_paged > 0,
          "realistic: paged_attention launch count")
    check_routes("realistic flash_attention", fa.flash_attention, want_flash,
                 0)
    check_routes("realistic paged_attention", pa.paged_attention, want_paged,
                 0)
    # a cut stream (independents of every prompt length, two families),
    # served with the admission graphs and with eager admission
    cut = flagship.realistic_requests(cfg.vocab_size, independents=8,
                                      families=2, max_new=8, key="c")

    def empty_cache() -> None:
        while cache.evict_lru():
            pass

    admission["against_eager"] = admission_runs(
        "4b realistic cut stream", eng, cut, reset=empty_cache)
    empty_cache()

    gen_tokens = sum(len(c.tokens) for c in done.values())
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    skipped = pc["shared_blocks"] * sc.block_size
    out = {"requests": len(done), "generated_tokens": gen_tokens,
           "wall_s": wall, "tok_per_s": gen_tokens / wall,
           "ttft_mean_s": float(np.mean([c.ttft_s for c in done.values()])),
           "e2e_mean_s": float(np.mean([c.e2e_s for c in done.values()])),
           "prefills": rep["prefills"],
           "prefill_dispatches": rep["prefill_dispatches"],
           "waves": rep["waves"], "suffix_windows": rep["suffix_windows"],
           "decode_rounds": rep["decode_rounds"], "prefix_cache": pc,
           "prompt_tokens": prompt_tokens, "prompt_tokens_skipped": skipped,
           "skipped_share": skipped / prompt_tokens,
           "preemptions": pg["preemptions"],
           "peak_blocks": pg["peak_in_use"],
           "pool_blocks": sc.paged_blocks - 1,
           "peak_gib": peak_gib, "warm_s": warm_s,
           "admission_s": admission_s[0], "admission": admission,
           "families_verified": sorted(verified)}
    log(f"realistic stream: {len(done)} requests, {gen_tokens} tokens in "
        f"{wall:.3f} s = {out['tok_per_s']:.1f} generated tok/s; mean TTFT "
        f"{out['ttft_mean_s']:.3f} s, mean e2e {out['e2e_mean_s']:.3f} s; "
        f"prefills {rep['prefills']} in {rep['prefill_dispatches']} "
        f"dispatches, waves {rep['waves']}, suffix windows "
        f"{rep['suffix_windows']}; hits {pc['hits']}, misses {pc['misses']}, "
        f"shared blocks {pc['shared_blocks']} ({skipped} of {prompt_tokens} "
        f"prompt tokens skipped, {out['skipped_share']:.1%}); preemptions "
        f"{pg['preemptions']}, peak blocks {pg['peak_in_use']} of "
        f"{sc.paged_blocks - 1}; peak device memory {peak_gib:.2f} GiB; "
        f"admission {admission_s[0]:.3f} s of the wall; warm-up "
        f"{warm_s:.2f} s ({warm_graphs} admission graphs captured; "
        f"{admission['graphs']} after the stream, {admission['replays']} "
        f"replays, {admission['capture_s']:.2f} s capturing); families "
        f"whose blocks were checked after their members: {sorted(verified)}")
    log(json.dumps({"realistic": out}))
    return {"routes": routes, **out}


# a member's first-token logprob through a prefix hit (the suffix forward
# against the stored blocks) against the cold path (the whole prompt
# through the flash kernel). Kept as the stated bf16 gate, but on these
# random weights it cannot fail: their softmax is nearly one-hot, so the
# first token's logprob reads 0.0 on both paths and on the faulty
# controls below; the logits gate is the one that discriminates
HIT_LP_TOL = 5e-2
# the reference bench's pool: the 8 members' cache-miss reservations (8 x
# 18 blocks) fit beside the 4 stored heads (64 blocks), so admission
# evicts no entry and every member hits
HIT_VS_COLD_POOL = 272
# the whole fp32 logit vector at a member's last prompt position, hit
# against cold, judged against its largest magnitude (logits of
# magnitude ~800 on random flagship weights, the top one ~600 above the
# next). The two paths round bf16 activations at other points (GEMM
# shapes, the suffix's plain attention against the flash kernel)
# through 8 layers: 2.149e-3 (8 members; the reading repeats exactly,
# as the kernels are deterministic). Attention on random weights is
# close to flat over ~1100 positions, so the faulty controls
# (SUFFIX_FAULTS) read only a little above that: 2.632e-3 with one
# prefix position masked, 5.366e-3 with rotary positions off by one
# (NVIDIA H100 80GB HBM3, 700.00 W). The limit lies between, and every
# run reads the controls through the same comparison and requires them
# above it, so the gate shows each time that it can fail
HIT_LOGITS_REL_TOL = 2.4e-3
# faults injected into the suffix forward for the controls: one prefix
# position masked (the window's mask at base - 1, its positions right),
# and the window's rotary positions one too far
SUFFIX_FAULTS = ("prefix_position_masked", "rotary_off_by_one")


@contextlib.contextmanager
def _suffix_fault(kind: str):
    """Run the suffix forward (``speculative._window_block``) with the
    fault ``kind`` of SUFFIX_FAULTS injected; restored on exit."""
    from kind_tpu_sim_torch.models import speculative

    window, rotary = speculative._window_block, speculative._rotary
    speculative._rotary = lambda t, pos: rotary(t, pos + 1)
    if kind == "prefix_position_masked":
        speculative._window_block = (
            lambda x, bp, c, lc, base: window(x, bp, c, lc, base - 1))
    try:
        yield
    finally:
        speculative._window_block, speculative._rotary = window, rotary


def _worst_rel(a: dict, b: dict, ids) -> float:
    """The largest, over ``ids``, of max |a - b| over max |b| of two
    logit vectors."""
    return max(float((a[i] - b[i]).abs().max() / b[i].abs().max())
               for i in ids)


def hit_vs_cold_phase(flagship, serving, sp, cfg) -> dict:
    """The realistic stream's 8 family members with logprobs, after
    their heads, on the realistic engine (with the bench's pool of
    ``HIT_VS_COLD_POOL`` blocks) with the prefix cache (every member a
    hit) and without it (cold). Gates: each member's first-token
    logprob within HIT_LP_TOL of the cold path's, and the logits it was
    sampled from within HIT_LOGITS_REL_TOL of the cold path's. Then the
    members hit once more, one new token each, under each fault of
    SUFFIX_FAULTS: each control's logits must differ from the cold
    path's by more than HIT_LOGITS_REL_TOL, or the gate could not see
    that fault. Equal streams are reported, not gated, with the first
    divergence."""
    reqs = flagship.realistic_requests(cfg.vocab_size, logprobs=True)
    heads = [r for r in reqs if r.cache_prefix]
    members = [r for r in reqs
               if r.request_id.startswith("rf") and not r.cache_prefix]
    ids = [r.request_id for r in members]
    runs, logits, engines = {}, {8: {}, 0: {}}, {}
    for entries in (8, 0):
        sc = dataclasses.replace(flagship.realistic_serving(HIT_VS_COLD_POOL),
                                 prefix_cache_entries=entries)
        eng = engines[entries] = serving.PagedServingEngine(
            sp, cfg, sc, device="cuda")
        for r in heads:
            eng.submit(dataclasses.replace(r))
        eng.run()
        _capture_prompt_logits(eng, logits[entries])
        for r in members:
            eng.submit(dataclasses.replace(r))
        runs[entries] = {c.request_id: c for c in eng.run()}
        rep = eng.report()
        if entries:
            check(rep["prefix_cache"]["hits"] == len(members)
                  and rep["suffix_windows"] == len(members),
                  f"hit path: {rep['prefix_cache']}, suffix windows "
                  f"{rep['suffix_windows']}")
    worst, agree, first = 0.0, 0, None
    for r in members:
        hit, cold = runs[8][r.request_id], runs[0][r.request_id]
        d = abs(hit.logprobs[0] - cold.logprobs[0])
        worst = max(worst, d)
        check(math.isfinite(d) and d <= HIT_LP_TOL,
              f"hit vs cold {r.request_id}: first-token logprob "
              f"{hit.logprobs[0]} vs {cold.logprobs[0]}")
        rel = _worst_rel(logits[8], logits[0], [r.request_id])
        check(math.isfinite(rel) and rel <= HIT_LOGITS_REL_TOL,
              f"hit vs cold {r.request_id}: logits differ by {rel} of their "
              "largest magnitude")
        if hit.tokens == cold.tokens:
            agree += 1
        elif first is None:
            i = next(j for j, (x, y) in enumerate(zip(hit.tokens,
                                                      cold.tokens)) if x != y)
            first = (f"{r.request_id} at token {i} ({hit.tokens[i]} vs "
                     f"{cold.tokens[i]})")
    worst_rel = _worst_rel(logits[8], logits[0], ids)
    controls, eng = {}, engines[8]
    # the faults are patched into the Python of the suffix forward, which
    # a captured graph no longer runs: the controls admit eagerly
    from kind_tpu_sim_torch.models import graphs

    eng._admit_round = graphs.eager
    for kind in SUFFIX_FAULTS:
        logits[8].clear()
        hits = eng.report()["prefix_cache"]["hits"]
        with _suffix_fault(kind):
            for r in members:
                eng.submit(dataclasses.replace(r, max_new=1))
            done = eng.run()
        hits = eng.report()["prefix_cache"]["hits"] - hits
        check(len(done) == len(members) and hits == len(members),
              f"control {kind}: {len(done)} completed, {hits} hits")
        controls[kind] = _worst_rel(logits[8], logits[0], ids)
        check(controls[kind] > HIT_LOGITS_REL_TOL,
              f"control {kind}: logits differ by only {controls[kind]} of "
              f"their largest magnitude, within the gate's "
              f"{HIT_LOGITS_REL_TOL}")
    lps = [round(runs[8][r.request_id].logprobs[0], 6) for r in members]
    log(f"hit vs cold: {len(members)} members, first-token logprob worst "
        f"difference {worst:.3e} (tolerance {HIT_LP_TOL}; hit path's "
        f"logprobs {lps}); logits at the last prompt position worst "
        f"{worst_rel:.3e} of their largest magnitude (tolerance "
        f"{HIT_LOGITS_REL_TOL}; faulty controls "
        + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
        + f"); streams equal {agree} of {len(members)}; "
        f"first divergence: {first}")
    return {"members": len(members), "first_lp_worst_diff": worst,
            "logits_worst_rel_diff": worst_rel,
            "controls_logits_worst_rel_diff": controls,
            "streams_equal": agree, "first_divergence": first}


def _capture_prompt_logits(eng, store: dict) -> None:
    """Record, by request id, the fp32 logits each admission of ``eng``
    samples its first token from (a single window's or a wave row's)."""
    window, group = eng._prefill_window, eng._prefill_group

    def captured_window(slot, req, toks, done, final):
        out = window(slot, req, toks, done, final)
        store[req.request_id] = out[2][0].float().clone()
        return out

    def captured_group(grp):
        out = group(grp)
        for row, (_, req) in enumerate(grp):
            store[req.request_id] = out[2][row].float().clone()
        return out

    eng._prefill_window, eng._prefill_group = captured_window, captured_group


def longprompt_phase(flagship, serving, sp, cfg) -> dict:
    """The reference bench's long-prompt stream on the dense grid at full
    width: 8 requests of 224 tokens (96 new) and one of 768 (64 new)
    behind them, once with whole-prompt admission and once with
    ``prefill_chunk=64``, each engine warmed first. Gate: every request
    completes. Logged: the short requests' e2e p50 and max and the long
    request's TTFT."""
    out = {}
    for key, chunk in (("whole", 0), ("chunked", 64)):
        eng = serving.ServingEngine(
            sp, cfg, flagship.longprompt_serving(chunk), device="cuda")
        eng.warm_admission((224,))
        eng.warm_admission((768,), sizes=(1,))
        # the short prompts' last 32-token window (chunked) warmed too
        for rid, n in (("warm", 256), ("warmS", 224), ("warmL", 768)):
            eng.submit(serving.Request(rid, [1] * n, 2))
        eng.run()
        reqs = flagship.longprompt_requests(cfg.vocab_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        done = {c.request_id: c for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(done) == len(reqs) and all(
            len(done[r.request_id].tokens) == r.max_new for r in reqs),
              f"long-prompt {key}: {len(done)} of {len(reqs)} completed")
        e2es = sorted(c.e2e_s for rid, c in done.items() if rid != "L")
        out[key] = {"wall_s": wall, "short_e2e_p50_s": e2es[len(e2es) // 2],
                    "short_e2e_max_s": e2es[-1],
                    "long_ttft_s": done["L"].ttft_s,
                    "prefills": eng.report()["prefills"],
                    "suffix_windows": eng.report()["suffix_windows"]}
        out[key]["against_eager"] = admission_runs(
            f"4d long-prompt stream ({key}) again", eng, reqs)
        log(f"long-prompt stream ({key}, prefill_chunk {chunk}): wall "
            f"{wall:.3f} s; short e2e p50 {out[key]['short_e2e_p50_s']:.3f} "
            f"s, max {out[key]['short_e2e_max_s']:.3f} s; long TTFT "
            f"{out[key]['long_ttft_s']:.3f} s")
    log(json.dumps({"longprompt": out}))
    return out


# ---------------------------------------------------------------------
# phases 4e and 4f: speculative decoding and the engine surface at full
# width

# A greedy stream of another engine may split from phase 4's only where
# two tokens nearly tie: a (b, k+1) verify window, a one-token decode
# chunk and waves of other sizes round bf16 activations at other
# points, which moved the flagship's logits by up to 2.149e-3 of their
# largest magnitude between two admission paths (phase 4c). A split is
# taken as such a tie when the plain forward's top-2 logit margin there
# is under twice that share of its largest logit; any other split fails.
SPLIT_MARGIN_REL = 2 * HIT_LOGITS_REL_TOL
SPEC_K = 4                # bench.py:1204 (serving), :1694 (solo)
SPEC_WINDOWS = 4          # ServingConfig's default, bench serving_speculative
FLIP_WINDOWS = 64         # bench.py:1593, serving_speculative_flip
FLIP_MAX_NEW = 512        # bench.py:1585
FLIP_TWIN_CHUNK = 256     # bench.py:1603, serving_dense_flip_twin (overlapped)
SOLO_BATCH, SOLO_PROMPT, SOLO_NEW = 8, 256, 256   # bench.py:1697-1700


def hold_streams(name: str, tf, sp, cfg, prompts: dict, got: dict,
                 want: dict, prefix: bool = False) -> int:
    """Greedy streams ``got`` against ``want`` ({request id: tokens}):
    equal (with ``prefix``, ``got`` a prefix of ``want``), or split
    first where the plain bf16 forward's top-2 margin is under
    SPLIT_MARGIN_REL of its largest logit. Returns the count of
    splits."""
    plain = dataclasses.replace(cfg, flash=False)
    splits = 0
    for rid in sorted(got):
        a, b = got[rid], want[rid]
        check(len(a) <= len(b) if prefix else len(a) == len(b),
              f"{name} {rid}: {len(a)} tokens against {len(b)}")
        b = b[:len(a)]
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = torch.tensor([list(prompts[rid]) + b[:i]], device="cuda")
        with torch.no_grad():
            logits = tf.forward(sp, seq, plain)[0, -1].float()
        top2 = logits.topk(2).values
        rel = float(top2[0] - top2[1]) / float(logits.abs().max())
        check(rel < SPLIT_MARGIN_REL,
              f"{name}: {rid} splits at token {i} ({a[i]} vs {b[i]}) with "
              f"top-2 margin {rel:.3e} of the largest logit (bar "
              f"{SPLIT_MARGIN_REL:.1e})")
        splits += 1
    log(f"{name}: {len(got)} streams, {len(got) - splits} equal, {splits} "
        "split at a near tie")
    return splits


class SyncCount(contextlib.AbstractContextManager):
    """The host's waits for the card inside the block: each operation
    PyTorch flags as synchronizing (``set_sync_debug_mode``: blocking
    copies, stream and device synchronizes) and each CUDA event wait.
    ``watch(engine)`` also counts the engine's round dispatches and the
    flagged operations inside them."""

    def __enter__(self):
        self.events = self.dispatches = self.dispatch_flagged = 0
        self._orig_sync = torch.cuda.Event.synchronize
        counter = self

        def synchronize(event):
            counter.events += 1
            return counter._orig_sync(event)

        torch.cuda.Event.synchronize = synchronize
        self._catch = warnings.catch_warnings(record=True)
        self._records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def flagged(self) -> int:
        return sum("synchronizing" in str(w.message) for w in self._records)

    def watch(self, eng) -> None:
        dispatch = eng._round_dispatch

        def counted():
            before = self.flagged()
            out = dispatch()
            self.dispatch_flagged += self.flagged() - before
            self.dispatches += out is not None
            return out

        eng._round_dispatch = counted
        self._watched = eng

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.total_flagged = self.flagged()
        self._catch.__exit__(*exc)
        torch.cuda.Event.synchronize = self._orig_sync
        if getattr(self, "_watched", None) is not None:
            # the engine's own method again: the wrapper's reference
            # cycle would keep the engine and its graphs alive
            del self._watched._round_dispatch
            self._watched = None
        return False


def _drain(eng, reqs, warm=None):
    """Submit copies of ``reqs``, drain the engine; returns ({id:
    Completion}, wall s, SyncCount)."""
    torch.cuda.synchronize()
    with SyncCount() as syncs:
        syncs.watch(eng)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        done = {c.request_id: c for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return done, wall, syncs


def _warmed(engine_fn, reqs):
    """The engine ``engine_fn()`` makes, after one short request of
    ``reqs[0]``'s prompt: the kernels of prefill and a round built, and
    the engine's graphs of that round and that admission captured (a
    graph serves only its own engine), so the timed run that follows
    replays them. Its counters are reset (``_reset_counters``)."""
    eng = engine_fn()
    eng.submit(dataclasses.replace(reqs[0], request_id="warm", max_new=9))
    eng.run()
    _reset_counters(eng)
    return eng


def _reset_counters(eng) -> None:
    """An engine's counters, latencies and pool peak set as a fresh
    engine's, so its report reads the next run alone."""
    eng.prefills = eng.prefill_dispatches = eng.suffix_windows = 0
    eng.decode_rounds = 0
    eng.wave_sizes.clear()
    eng.reset_latency()
    for name in ("verify_steps", "draft_prefills", "preemptions"):
        if hasattr(eng, name):
            setattr(eng, name, 0)
    if hasattr(eng, "alloc"):
        eng.alloc.peak_in_use = 0


def _run_stats(name: str, cfg, done: dict, wall: float, rep: dict,
               syncs=None) -> dict:
    """Every request complete with finite logprobs where asked; the
    stream's tok/s, mean TTFT and e2e, verify windows and tokens per
    window (generated tokens over windows, the bench's definition) and
    host syncs per round, logged and returned."""
    for rid, c in done.items():
        check(c.finish_reason == "length",
              f"{name} {rid}: finish_reason {c.finish_reason}")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"{name} {rid}: token out of range")
        if c.logprobs is not None:
            check(all(math.isfinite(x) for x in c.logprobs),
                  f"{name} {rid}: non-finite logprobs")
    gen = sum(len(c.tokens) for c in done.values())
    out = {"requests": len(done), "generated_tokens": gen, "wall_s": wall,
           "tok_per_s": gen / wall,
           "ttft_mean_s": float(np.mean([c.ttft_s for c in done.values()])),
           "e2e_mean_s": float(np.mean([c.e2e_s for c in done.values()])),
           "prefill_dispatches": rep["prefill_dispatches"]}
    spec = rep.get("speculative")
    if spec:
        out["verify_steps"] = spec["verify_steps"]
        out["tokens_per_window"] = gen / max(spec["verify_steps"], 1)
    if syncs is not None:
        out.update(rounds=syncs.dispatches,
                   host_syncs=syncs.total_flagged + syncs.events,
                   host_syncs_per_round=(syncs.total_flagged + syncs.events)
                   / max(syncs.dispatches, 1),
                   syncs_in_dispatch=syncs.dispatch_flagged)
    log(f"{name}: {len(done)} requests, {gen} tokens in {wall:.3f} s = "
        f"{out['tok_per_s']:.1f} generated tok/s; mean TTFT "
        f"{out['ttft_mean_s']:.3f} s, mean e2e {out['e2e_mean_s']:.3f} s"
        + (f"; verify windows {out['verify_steps']}, "
           f"{out['tokens_per_window']:.2f} tokens a window" if spec else "")
        + (f"; {out['rounds']} rounds, {out['host_syncs']} host syncs "
           f"({out['host_syncs_per_round']:.2f} a round), "
           f"{out['syncs_in_dispatch']} inside a dispatch"
           if syncs is not None else ""))
    return out


def _flash_check(name: str, fa, want: int, routes: dict) -> None:
    """Every flash launch since the counts were zeroed on the tensor
    cores, ``want`` of them (n_layers x prefill dispatches); their
    routes added to ``routes``."""
    got = dict(fa.flash_attention.launches_by_route)
    log(f"{name}: flash_attention {fa.flash_attention.launches} launches "
        f"(expected n_layers x prefill dispatches = {want}), by route {got}")
    check(got == {"tensor_cores": want, "cuda_cores": 0} and want > 0,
          f"{name}: flash launches by route {got}, expected {want} on the "
          "tensor cores")
    for route, n in got.items():
        routes[route] = routes.get(route, 0) + n


def bench_row(tf, cfg) -> np.ndarray:
    """The reference bench's token row (``tokens_h[0]``, bench.py:315,
    821): the first of ``sample_batch``'s 8 ramps, from seed 1."""
    return tf.sample_batch(torch.Generator(device="cuda").manual_seed(1),
                           cfg, 8, cfg.max_seq, device="cuda")[0].cpu().numpy()


def solo_draft_model(tf, decode, spec, sp, cfg, prompt, greedy) -> dict:
    """Solo ``draft_model_generate`` with a random 2-layer draft of the
    flagship's vocab (seed 5): the warm call captures its programs
    (the prefill, both models' prompts in it, and the draft-and-verify
    step), the timed call replays them, then the same call eagerly, each
    ``SOLO_NEW // 2`` new tokens; tokens and steps equal, and the tokens
    held to the start of ``greedy_generate``'s (``greedy``) by the split
    rule."""
    from kind_tpu_sim_torch.models import graphs

    dcfg = tf.ModelConfig(vocab_size=cfg.vocab_size, d_model=256, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=1024,
                          max_seq=cfg.max_seq, dtype=cfg.dtype, flash=True)
    dp = decode.serving_params(tf.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(5), "cuda"), dcfg)
    spec._PROGRAMS.clear()
    new = SOLO_NEW // 2

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, stats = spec.draft_model_generate(
            sp, cfg, dp, dcfg, prompt, new, draft_k=SPEC_K,
            return_stats=True, device="cuda")
        torch.cuda.synchronize()
        return toks, stats["steps"], time.perf_counter() - t0

    call()
    toks, steps, wall = call()
    prog = spec.solo_program(sp, cfg, prompt, new, SPEC_K,
                             draft=(dp, dcfg))
    runner = prog._round
    check(isinstance(runner, graphs.RoundGraphs) and runner.captured == 2,
          f"4e solo draft model: its programs run through {runner!r}")
    prog._round = graphs.eager
    eager_toks, eager_steps, eager_wall = call()
    spec._PROGRAMS.clear()
    check(torch.equal(eager_toks, toks) and eager_steps == steps,
          f"4e solo draft model: graphed ({steps} steps) and eager "
          f"({eager_steps}) calls differ")
    splits = hold_streams(
        "4e solo draft_model_generate against greedy_generate", tf, sp, cfg,
        {f"row{r}": prompt[r].tolist() for r in range(SOLO_BATCH)},
        {f"row{r}": toks[r, SOLO_PROMPT:].tolist()
         for r in range(SOLO_BATCH)},
        {f"row{r}": greedy[r, SOLO_PROMPT:].tolist()
         for r in range(SOLO_BATCH)}, prefix=True)
    out = {"new_tokens": new, "verify_steps": steps, "wall_s": wall,
           "eager_wall_s": eager_wall,
           "tok_per_s": SOLO_BATCH * new / wall,
           "eager_tok_per_s": SOLO_BATCH * new / eager_wall,
           "graphs": runner.captured, "capture_s": runner.capture_s,
           "splits": splits}
    log(f"4e solo draft model (2 layers, d_model 256), {new} new tokens: "
        f"{steps} verify steps; "
        f"graphed {out['tok_per_s']:.1f} tok/s ({wall:.3f} s; "
        f"{runner.captured} graphs captured in {runner.capture_s:.2f} s), "
        f"eager {out['eager_tok_per_s']:.1f} tok/s ({eager_wall:.3f} s), "
        f"tokens and steps equal; {splits} splits from greedy_generate")
    return out


def spec_phase(flagship, serving, tf, fa, pa, sp, cfg, want: dict) -> dict:
    """Phase 4e, speculative decoding at full width on the bf16 serving
    snapshot: (a) solo ``speculative_generate`` (bench.py:1694-1724)
    against ``greedy_generate``; (b) ``SpeculativeServingEngine`` and
    (c) ``PagedSpeculativeServingEngine`` (the bench's paged settings)
    on phase 4's 16-request stream, held to phase 4's streams (``want``);
    (d) the motif stream of bench ``serving_speculative_flip`` at 64
    windows a round beside the dense grid on the same stream. Flash
    launches n_layers x prefill dispatches on the tensor cores each;
    no paged-kernel launch (the windows read the gather view)."""
    from kind_tpu_sim_torch.models import decode
    from kind_tpu_sim_torch.models import speculative as spec

    from kind_tpu_sim_torch.models import graphs

    routes, out = {}, {}
    # (a) solo: the warm call captures the prefill's and the verify
    # step's graphs, which the timed call replays
    prompt = tf.sample_batch(torch.Generator(device="cuda").manual_seed(1),
                             cfg, SOLO_BATCH, SOLO_PROMPT, device="cuda")
    spec._PROGRAMS.clear()
    spec.speculative_generate(sp, cfg, prompt, SOLO_NEW, draft_k=SPEC_K,
                              device="cuda")
    prog = spec.solo_program(sp, cfg, prompt, SOLO_NEW, SPEC_K)
    check(isinstance(prog._round, graphs.RoundGraphs)
          and prog._round.captured == 2,
          f"4e solo: its programs run through {prog._round!r}")
    zero_counts(fa.flash_attention, pa.paged_attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, stats = spec.speculative_generate(sp, cfg, prompt, SOLO_NEW,
                                            draft_k=SPEC_K, return_stats=True,
                                            device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _flash_check("4e solo speculative_generate", fa, cfg.n_layers, routes)
    replays = prog._round.replays
    # the same call eagerly: the program's runner rebound
    prog._round, runner = graphs.eager, prog._round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_toks, eager_stats = spec.speculative_generate(
        sp, cfg, prompt, SOLO_NEW, draft_k=SPEC_K, return_stats=True,
        device="cuda")
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    spec._PROGRAMS.clear()
    check(torch.equal(eager_toks, toks)
          and eager_stats["steps"] == stats["steps"],
          f"4e solo: the graphed call's tokens or steps ({stats['steps']}) "
          f"differ from the eager call's ({eager_stats['steps']})")
    t0 = time.perf_counter()
    greedy = decode.greedy_generate(sp, cfg, prompt, SOLO_NEW, device="cuda")
    torch.cuda.synchronize()
    greedy_wall = time.perf_counter() - t0
    rows = {f"row{r}": prompt[r].tolist() for r in range(SOLO_BATCH)}
    splits = hold_streams(
        "4e solo speculative_generate against greedy_generate", tf, sp, cfg,
        rows, {f"row{r}": toks[r, SOLO_PROMPT:].tolist()
               for r in range(SOLO_BATCH)},
        {f"row{r}": greedy[r, SOLO_PROMPT:].tolist()
         for r in range(SOLO_BATCH)})
    out["solo"] = {"verify_steps": stats["steps"],
                   "tokens_per_step": (SOLO_NEW - 1) / stats["steps"],
                   "wall_s": wall,
                   "tok_per_s": SOLO_BATCH * SOLO_NEW / wall,
                   "eager_wall_s": eager_wall,
                   "eager_tok_per_s": SOLO_BATCH * SOLO_NEW / eager_wall,
                   "eager_verify_steps": eager_stats["steps"],
                   "graphs": runner.captured,
                   "capture_s": runner.capture_s,
                   "replays_timed_call": replays,
                   "greedy_tok_per_s": SOLO_BATCH * SOLO_NEW / greedy_wall,
                   "splits": splits}
    log(f"4e solo: batch {SOLO_BATCH}, {SOLO_PROMPT}-token prompts, "
        f"{SOLO_NEW} new, k {SPEC_K}: {stats['steps']} verify steps, "
        f"{out['solo']['tokens_per_step']:.2f} tokens a step; graphed "
        f"{out['solo']['tok_per_s']:.1f} tok/s ({wall:.3f} s; "
        f"{runner.captured} graphs captured in {runner.capture_s:.2f} s, "
        f"{replays} replays by the timed call), eager "
        f"{out['solo']['eager_tok_per_s']:.1f} tok/s ({eager_wall:.3f} s, "
        f"{eager_stats['steps']} steps, tokens equal); greedy_generate's "
        f"{out['solo']['greedy_tok_per_s']:.1f}")
    out["solo_draft"] = solo_draft_model(tf, decode, spec, sp, cfg, prompt,
                                         greedy)

    # (b), (c): the phase 4 stream
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)
    prompts = {r.request_id: r.prompt for r in reqs}
    base = dict(max_slots=flagship.SLOTS, max_len=1024, speculative_k=SPEC_K,
                spec_windows=SPEC_WINDOWS)
    paged_sc = serving.ServingConfig(
        paged_blocks=flagship.POOL_BLOCKS, block_size=flagship.BLOCK,
        paged_width=8, **base)
    runs = (("4e speculative serving", serving.SpeculativeServingEngine,
             serving.ServingConfig(**base)),
            ("4e paged speculative serving",
             serving.PagedSpeculativeServingEngine, paged_sc))
    for name, engine, sc in runs:
        eng = _warmed(lambda: engine(sp, cfg, sc, device="cuda"), reqs)
        zero_counts(fa.flash_attention, pa.paged_attention)
        done, wall, syncs = _drain(eng, reqs)
        rep = eng.report()
        _flash_check(name, fa, cfg.n_layers * rep["prefill_dispatches"],
                     routes)
        check(pa.paged_attention.launches == 0,
              f"{name}: {pa.paged_attention.launches} paged launches")
        check(len(done) == len(reqs), f"{name}: {len(done)} completed")
        stats = _run_stats(name, cfg, done, wall, rep, syncs)
        stats["splits"] = hold_streams(
            f"{name} against phase 4", tf, sp, cfg, prompts,
            {r: c.tokens for r, c in done.items()}, want)
        log(f"{name}: q0's first 24 tokens {done['q0'].tokens[:24]} (what "
            "prompt lookup drafts from)")
        if "paged" in rep:
            check(rep["paged"]["blocks_in_use"] == 0,
                  f"{name}: {rep['paged']['blocks_in_use']} blocks in use "
                  "after the drain")
            stats["peak_blocks"] = rep["paged"]["peak_in_use"]
            stats["preemptions"] = rep["paged"]["preemptions"]
        out["paged" if "paged" in rep else "grid"] = stats

    # (d) the motif stream, speculative at 64 windows and the dense grid
    motif = bench_row(tf, cfg)[:8]
    flip = [serving.Request(f"flip{i}", ((np.resize(motif, 192) + i)
                                         % cfg.vocab_size).tolist(),
                            FLIP_MAX_NEW) for i in range(2 * flagship.SLOTS)]
    flip_prompts = {r.request_id: r.prompt for r in flip}
    dense_sc = serving.ServingConfig(max_slots=flagship.SLOTS, max_len=1024,
                                     chunk=FLIP_TWIN_CHUNK,
                                     overlap_rounds=True)
    dense = _warmed(lambda: serving.ServingEngine(sp, cfg, dense_sc,
                                                  device="cuda"), flip)
    dense_done, dense_wall, _ = _drain(dense, flip)
    out["flip_dense"] = _run_stats(
        f"4e motif stream, dense twin (chunk {FLIP_TWIN_CHUNK}, overlapped)",
                                   cfg, dense_done, dense_wall,
                                   dense.report())
    flip_sc = serving.ServingConfig(**dict(base, spec_windows=FLIP_WINDOWS))
    eng = _warmed(lambda: serving.SpeculativeServingEngine(
        sp, cfg, flip_sc, device="cuda"), flip)
    zero_counts(fa.flash_attention, pa.paged_attention)
    done, wall, syncs = _drain(eng, flip)
    rep = eng.report()
    _flash_check("4e motif stream", fa, cfg.n_layers * rep["prefill_dispatches"],
                 routes)
    out["flip"] = _run_stats(
        f"4e motif stream (bench serving_speculative_flip, W {FLIP_WINDOWS}, "
        f"{FLIP_MAX_NEW} new tokens)",
        cfg, done, wall, rep, syncs)
    log(f"4e motif stream: flip0's prompt begins {flip[0].prompt[:10]}, its "
        f"first 24 tokens {done['flip0'].tokens[:24]}")
    out["flip"]["splits"] = hold_streams(
        "4e motif stream against the dense grid", tf, sp, cfg, flip_prompts,
        {r: c.tokens for r, c in done.items()},
        {r: c.tokens for r, c in dense_done.items()})
    out["flash_launches_by_route"] = routes
    log(json.dumps({"speculative": out}))
    return out


def surface_phase(flagship, serving, tf, fa, pa, sp, cfg, want: dict) -> dict:
    """Phase 4f, the engine surface at full width: the dense grid
    sequential against ``overlap_rounds`` on phase 4's stream (chunk
    64) and on the bench's ``serving_rtt_bound`` stream (chunk 8,
    bench.py:1440-1486), and the speculative grid of 4e overlapped, in
    turns on one warmed engine a mode (sequential, overlapped twice,
    sequential); streams equal, tok/s and host syncs a round printed, no
    synchronizing operation inside a dispatch. Then a slot failure on a
    busy slot of the paged kernel tier mid-stream (replay held to phase
    4, no block leaked), and a deadline and a ``max_queue`` shed under
    an injected clock."""
    from kind_tpu_sim_torch import metrics

    routes, out = {}, {}
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)
    prompts = {r.request_id: r.prompt for r in reqs}
    row = bench_row(tf, cfg)
    rtt = [serving.Request(f"rtt{i}", ((row[:192] + i)
                                       % cfg.vocab_size).tolist(), 128)
           for i in range(2 * flagship.SLOTS)]
    # one sampled request beside phase 4's greedy ones: its noise is
    # drawn on the card, so sampling adds no wait to a dispatch either
    sampled = serving.Request(
        "sampled0", reqs[0].prompt, reqs[0].max_new, logprobs=True,
        sampling=serving.SamplingConfig(temperature=0.8, top_k=50), seed=17)
    base = dict(max_slots=flagship.SLOTS, max_len=1024)
    pairs = (("phase 4 stream and a sampled request, dense chunk 64",
              serving.ServingEngine, dict(base, chunk=flagship.CHUNK),
              reqs + [sampled]),
             ("serving_rtt_bound, dense chunk 8", serving.ServingEngine,
              dict(base, chunk=8), rtt),
             ("phase 4 stream, speculative grid", serving.SpeculativeServingEngine,
              dict(base, speculative_k=SPEC_K, spec_windows=SPEC_WINDOWS),
              reqs))
    for name, engine, kw, stream in pairs:
        # one engine a mode, warmed once and run twice
        streams, engines = {}, {}
        for overlap in (False, True, True, False):
            if overlap not in engines:
                sc = serving.ServingConfig(overlap_rounds=overlap, **kw)
                engines[overlap] = _warmed(
                    lambda: engine(sp, cfg, sc, device="cuda"), stream)
            eng = engines[overlap]
            _reset_counters(eng)
            zero_counts(fa.flash_attention, pa.paged_attention)
            done, wall, syncs = _drain(eng, stream)
            rep = eng.report()
            _flash_check(f"4f {name}", fa,
                         cfg.n_layers * rep["prefill_dispatches"], routes)
            key = "overlap" if overlap else "sequential"
            stats = _run_stats(f"4f {name}, {key}", cfg, done, wall, rep,
                               syncs)
            check(stats["syncs_in_dispatch"] == 0,
                  f"4f {name}, {key}: {stats['syncs_in_dispatch']} "
                  "synchronizing operations inside a round's dispatch")
            tokens = {r: c.tokens for r, c in done.items()}
            check(streams.setdefault(key, tokens) == tokens,
                  f"4f {name}, {key}: streams differ between two runs")
            out.setdefault(name, {}).setdefault(key, []).append(stats)
        del engines, eng
        check(streams["overlap"] == streams["sequential"],
              f"4f {name}: overlapped streams differ from sequential")
        if stream[0] is reqs[0]:
            out[name]["splits"] = hold_streams(
                f"4f {name} against phase 4", tf, sp, cfg, prompts,
                {r: t for r, t in streams["sequential"].items() if r in want},
                want)
        log(f"4f {name}: overlapped streams equal the sequential ones")

    # a slot failure mid-stream on the paged kernel tier
    sc = flagship.flagship_serving(paged_kernel=True)
    eng = serving.PagedServingEngine(sp, cfg, sc, device="cuda")
    before = metrics.recovery_log().counts()
    zero_counts(fa.flash_attention, pa.paged_attention)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    eng.step_round()
    busy = [s for s, r in enumerate(eng.slot_req)
            if r is not None and 1 < len(eng.slot_emitted[s]) < r.max_new]
    check(bool(busy), "4f slot failure: no busy slot after a round")
    victim, in_use = eng.slot_req[busy[0]].request_id, eng.alloc.in_use
    check(eng.inject_slot_failure(busy[0]),
          "4f slot failure: nothing displaced")
    check(eng.alloc.in_use < in_use and eng.queue[0].request_id == victim,
          "4f slot failure: blocks not released or request not requeued")
    eng.step_round()
    check(eng.slot_req[busy[0]] is None,
          "4f slot failure: a quarantined slot was admitted to")
    quarantined = eng.report()["chaos"]
    eng.restore_slot(busy[0])
    done = {c.request_id: c for c in eng.poll() + eng.run()}
    rep = eng.report()
    events = metrics.recovery_log().snapshot_since(before)
    check(len(done) == len(reqs), f"4f slot failure: {len(done)} completed")
    check(rep["paged"]["blocks_in_use"] == 0,
          f"4f slot failure: {rep['paged']['blocks_in_use']} blocks in use")
    check(events == {"slot_failure": 1, "slot_requeue": 1},
          f"4f slot failure: recovery log {events}")
    want_paged = cfg.n_layers * sc.chunk * rep["decode_rounds"]
    check(pa.paged_attention.launches == want_paged
          and pa.paged_attention.launches_by_route["split_kv"] == want_paged,
          f"4f slot failure: paged launches by route "
          f"{dict(pa.paged_attention.launches_by_route)}, expected "
          f"{want_paged} on split_kv")
    _flash_check("4f slot failure", fa,
                 cfg.n_layers * rep["prefill_dispatches"], routes)
    splits = hold_streams("4f slot failure against phase 4", tf, sp, cfg,
                          prompts, {r: c.tokens for r, c in done.items()},
                          want)
    check(done[victim].tokens == want[victim],
          f"4f slot failure: the replayed {victim} differs from phase 4")
    out["slot_failure"] = {"victim": victim, "slot": busy[0],
                           "chaos": quarantined, "events": events,
                           "splits": splits,
                           "paged_launches": pa.paged_attention.launches,
                           "paged_routes": dict(
                               pa.paged_attention.launches_by_route)}
    log(f"4f slot failure: {victim} on slot {busy[0]} failed after one "
        f"round, replayed equal to phase 4; chaos while quarantined "
        f"{quarantined}; recovery log {events}; 0 blocks in use after the "
        "drain")

    # a deadline and a shed under an injected clock, a second a round:
    # 8 requests fill the queue (max_queue 8) and the 9th is shed; one
    # round admits the 8, and the rest queue behind them. Chunk 32, so
    # a request takes 4 rounds: the first (deadline 1.5 s) expires after
    # its second or third, the last (0.5 s) while queued
    now = [0.0]
    sc = serving.ServingConfig(max_slots=flagship.SLOTS, max_len=1024,
                               chunk=32, max_queue=flagship.SLOTS)
    eng = serving.ServingEngine(sp, cfg, sc, device="cuda",
                                clock=lambda: now[0])
    before = metrics.recovery_log().counts()
    deadlines = {reqs[0].request_id: 1.5, reqs[-1].request_id: 0.5}
    dead = set(deadlines)
    accepted, shed = [], []
    for i, r in enumerate(reqs):
        if i == flagship.SLOTS + 1:
            now[0] += 1.0
            eng.step_round()
        try:
            eng.submit(dataclasses.replace(
                r, deadline_s=deadlines.get(r.request_id)))
            accepted.append(r.request_id)
        except serving.EngineSaturated:
            shed.append(r.request_id)
    done = {}
    while eng.outstanding():
        eng.step_round()
        now[0] += 1.0
        done.update({c.request_id: c for c in eng.poll()})
    events = metrics.recovery_log().snapshot_since(before)
    check(shed == [reqs[flagship.SLOTS].request_id]
          and events == {"request_shed": 1},
          f"4f shed: shed {shed}, recovery log {events}")
    check(sorted(done) == sorted(accepted),
          f"4f deadline: {len(done)} of {len(accepted)} accepted completed")
    for rid, c in done.items():
        expired = rid in dead
        check(c.deadline_exceeded == expired
              and c.finish_reason == ("deadline_exceeded" if expired
                                      else "length"),
              f"4f deadline: {rid} {c.finish_reason}")
    check(0 < len(done[reqs[0].request_id].tokens) < reqs[0].max_new
          and done[reqs[-1].request_id].tokens == [],
          "4f deadline: the expired requests' tokens "
          f"{len(done[reqs[0].request_id].tokens)} (mid-stream) and "
          f"{len(done[reqs[-1].request_id].tokens)} (queued)")
    hold_streams("4f deadline and shed against phase 4 (prefixes)", tf, sp,
                 cfg, prompts, {r: c.tokens for r, c in done.items()}, want,
                 prefix=True)
    out["deadline"] = {
        "expired_tokens": {rid: len(done[rid].tokens) for rid in sorted(dead)},
        "shed": shed, "chaos": eng.report()["chaos"]}
    log(f"4f deadline and shed: {out['deadline']}")
    out["flash_launches_by_route"] = routes
    log(json.dumps({"surface": out}))
    return out


# ---------------------------------------------------------------------
# phase 4g: the int8 tiers at full width


SOLO_INT8_NEW = 512      # bench.py:645 (the TPU bench's new tokens)
SATURATED_NEW = 512      # bench.py:1416, :1512 (uniform_stream)
SATURATED_PROMPT = 192
SATURATED_CHUNK = 256    # bench.py:1413, :1510
INT8_CORR = 0.99         # tests/test_quant.py:61-69, the reference's bar


def int8_step_bytes(cfg, batch: int, cache_len: int) -> float:
    """Device bytes one W8A8 + int8-KV decode step must read and write,
    the reference's accounting (``kind_tpu_sim/models/flops.py:
    decode_bytes_per_step`` with weight and KV bytes 1): every int8
    matmul weight and the embedding once, their fp32 scales, the whole
    allocated int8 cache of ``cache_len`` positions with its fp32
    row scales, and one new k/v row a layer."""
    d, ff = cfg.d_model, cfg.d_ff
    qkv = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim
    weights = cfg.n_layers * (d * qkv + d * d + 2 * d * ff) \
        + cfg.vocab_size * d
    scales = 4.0 * (cfg.n_layers * (qkv + d + ff + d) + cfg.vocab_size)
    rows = 2.0 * cfg.n_layers * batch * cache_len * cfg.kv_heads
    kv = rows * cfg.head_dim + 4.0 * rows \
        + 2.0 * cfg.n_layers * batch * cfg.kv_heads * cfg.head_dim
    return weights + scales + kv


def _solo_decode(decode, params, cfg, prompt, new: int, counted=(),
                 on_prefill=None):
    """The bench's solo decode (bench.py:645-705) as the bench times it:
    one prefill into a cache of prompt + ``new`` positions, then ``new``
    greedy tokens by the compiled decoder (``graphs.DecodeProgram``, the
    reference's jitted loop). A first pass over the same cache builds the
    kernels and captures the chunks' graphs (the fewest tokens whose
    chunks have the timed pass's sizes); then the wrappers in
    ``counted`` are zeroed and the timed pass prefills the cache again in
    place and replays; ``on_prefill()`` runs between its prefill and its
    decode. Returns (prefill logits, tokens, prefill s, decode s)."""
    from kind_tpu_sim_torch.models import graphs

    t_p = prompt.shape[1]
    with torch.no_grad():
        logits, cache = decode.prefill(params, cfg, prompt, t_p + new)
        program = graphs.DecodeProgram(params, cfg, cache)
        chunk = graphs.DecodeProgram.CHUNK
        warm = new if new - 1 <= chunk else chunk + (new - 1) % chunk + 1
        program(torch.argmax(logits, dim=-1), t_p, warm)
        zero_counts(*counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = decode.prefill(params, cfg, prompt, t_p + new,
                                   cache=cache)
        first = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if on_prefill is not None:
            on_prefill()
        t1b = time.perf_counter()
        out = program(first, t_p, new)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return logits, out, t1 - t0, t2 - t1b


# the int8 routes' kernels (a library's fp32 "gemvx" kernel is not one)
INT8_KERNEL_NAMES = ("int8_matmul_kernel", "int8_matmul_tc_kernel",
                     "gemv_nk_kernel", "gemv_kn_kernel")
INT8_TRACED_STEPS = 8


def int8_step_device_ms(decode, params, cfg, prompt) -> dict:
    """Device time of the int8 kernels (and of everything) in one W8A8
    decode step of 4g(a)'s solo decode (a cache of 1536 positions):
    ``torch.profiler`` over ``INT8_TRACED_STEPS`` steps of the chunked
    decoder after a prefill, the kernels' self device time summed by
    name and divided by the steps."""
    from torch.profiler import ProfilerActivity, profile

    t_p = prompt.shape[1]
    with torch.no_grad():
        logits, cache = decode.prefill(params, cfg, prompt,
                                       t_p + SOLO_INT8_NEW)
        first = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode.generate_from_cache(params, cfg, first, cache, t_p,
                                       INT8_TRACED_STEPS + 1)
            torch.cuda.synchronize()
    by_kernel, total = {}, 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us <= 0:
            continue
        total += dev_us
        if any(w in ev.key for w in INT8_KERNEL_NAMES):
            by_kernel[ev.key[:80]] = dev_us / 1e3 / INT8_TRACED_STEPS
    # the first of the INT8_TRACED_STEPS + 1 tokens is given: one step each
    return {"int8_ms_per_step": sum(by_kernel.values()),
            "device_ms_per_step": total / 1e3 / INT8_TRACED_STEPS,
            "int8_by_kernel_ms_per_step": by_kernel}


def int8_serving_phase(flagship, serving, tf, quant, fa, pa, im, sp,
                       cfg) -> dict:
    """Phase 4g on the flagship: (a) solo decode as the reference bench
    runs it (batch 8, the bench's (8, 1024) prompt from ``sample_batch``,
    512 new tokens, a cache of 1536) on the bf16 snapshot, then W8A8 with
    the int8 KV cache, then dequant with it, the int8 snapshot quantized
    from the fp32 weights as the bench quantizes it: tok/s, the achieved
    GB/s over a step's int8 bytes, the first-step logits' correlation
    with bf16's (> 0.99) and every int8_matmul launch counted
    (n_layers x 4 linears + the readout at prefill; n_layers x (4
    linears + cache scores + values) + the readout a step); (b)
    ``serving_saturated_int8`` (bench.py:1487-1514) beside the bf16
    ``serving_saturated`` (bench.py:1405-1418) on the same stream; (c)
    phase 4's stream on ``PagedServingEngine`` with int8 pools (the
    gather tier), and the kernel tier's refusal of int8 pools."""
    from kind_tpu_sim_torch.models import decode

    q_cfg = dataclasses.replace(cfg, int8_kv=True, int8_native=True)
    dq_cfg = dataclasses.replace(q_cfg, int8_native=False)
    dense = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    qp = quant.quantize_params(dense, q_cfg)
    del dense
    out = {}
    prompt = tf.sample_batch(torch.Generator(device="cuda").manual_seed(1),
                             cfg, 8, cfg.max_seq, device="cuda")
    total = prompt.shape[1] + SOLO_INT8_NEW
    logits = {}
    for name, p, c in (("bf16", sp, cfg), ("w8a8", qp, q_cfg),
                       ("dequant", qp, dq_cfg)):
        at_prefill = {}
        lg, toks, pre_s, dec_s = _solo_decode(
            decode, p, c, prompt, SOLO_INT8_NEW, counted=(im.int8_matmul,),
            on_prefill=lambda: at_prefill.update(
                im.int8_matmul.launches_by_route))
        n_int8 = im.int8_matmul.launches
        steps = SOLO_INT8_NEW - 1
        want = ((cfg.n_layers * 4 + 1) + steps * (cfg.n_layers * 6 + 1)
                if name == "w8a8" else 0)
        check(n_int8 == want,
              f"4g(a) {name}: {n_int8} int8_matmul launches, expected "
              f"{want}")
        if name == "w8a8":
            # prefill: the linears over 8 x 1024 rows on the tensor cores,
            # the last position's readout on gemv; every decode step's
            # products (8 rows, the cache's 4-row groups) on gemv
            routes = dict(im.int8_matmul.launches_by_route)
            decode_routes = {r: routes[r] - at_prefill[r] for r in routes}
            want_prefill = {im.DP4A: 0, im.GEMV: 1,
                            im.WGMMA: cfg.n_layers * 4}
            want_decode = {im.DP4A: 0, im.WGMMA: 0,
                           im.GEMV: steps * (cfg.n_layers * 6 + 1)}
            log(f"4g(a) w8a8 int8 launches by route: prefill {at_prefill} "
                f"(expected {want_prefill}), decode {decode_routes} "
                f"(expected {want_decode})")
            check(at_prefill == want_prefill and decode_routes == want_decode,
                  "4g(a) w8a8: int8 launches by route, prefill "
                  f"{at_prefill}, decode {decode_routes}")
            out["w8a8_launches_by_route"] = routes
        check(bool(torch.isfinite(lg).all()) and toks.shape == (
            8, SOLO_INT8_NEW), f"4g(a) {name}: non-finite logits or shape")
        logits[name] = lg.float().flatten().cpu().numpy()
        tps = 8 * SOLO_INT8_NEW / dec_s
        row = {"prefill_s": pre_s, "decode_s": dec_s, "tok_per_s": tps,
               "int8_matmul_launches": n_int8}
        if name != "bf16":
            row["gb_per_s"] = int8_step_bytes(cfg, 8, total) * tps / 8 / 1e9
            row["corr_vs_bf16"] = float(np.corrcoef(logits["bf16"],
                                                    logits[name])[0, 1])
            check(row["corr_vs_bf16"] > INT8_CORR,
                  f"4g(a) {name}: first-step logits correlate "
                  f"{row['corr_vs_bf16']:.4f} with bf16's (bar {INT8_CORR})")
        if name == "w8a8":
            out["w8a8_launches"] = n_int8
            row.update(int8_step_device_ms(decode, p, c, prompt))
        row["prefill_s_over_bf16"] = pre_s / out["solo_bf16"]["prefill_s"] \
            if name != "bf16" else 1.0
        log(f"4g(a) solo decode {name}: 8 x {SOLO_INT8_NEW} new tokens in "
            f"{dec_s:.3f} s = {tps:.1f} tok/s (prefill {pre_s:.4f} s, "
            f"{row['prefill_s_over_bf16']:.3f}x bf16's); {row}")
        out[f"solo_{name}"] = row
    out["int8_step_bytes"] = int8_step_bytes(cfg, 8, total)

    # (b) the saturated dense grid, bf16 then W8A8 + int8 KV
    row0 = bench_row(tf, cfg)
    reqs = [serving.Request(f"sat{i}", ((row0[:SATURATED_PROMPT] + i)
                                        % cfg.vocab_size).tolist(),
                            SATURATED_NEW) for i in range(16)]
    for name, p, c, overlap in (("bf16 serving_saturated", sp, cfg, False),
                                ("serving_saturated_int8", qp, q_cfg, True)):
        sc = serving.ServingConfig(max_slots=8, max_len=1024,
                                   chunk=SATURATED_CHUNK,
                                   overlap_rounds=overlap)
        eng = _warmed(lambda: serving.ServingEngine(p, c, sc, device="cuda"),
                      reqs)
        zero_counts(fa.flash_attention, im.int8_matmul)
        done, wall, syncs = _drain(eng, reqs)
        check(len(done) == len(reqs), f"4g(b) {name}: {len(done)} completed")
        check((im.int8_matmul.launches > 0) == (c is q_cfg),
              f"4g(b) {name}: {im.int8_matmul.launches} int8 launches")
        stats = _run_stats(f"4g(b) {name}", c, done, wall, eng.report(),
                           syncs)
        stats["int8_matmul_launches"] = im.int8_matmul.launches
        out[name] = stats

    # (c) phase 4's stream on int8 pools, the gather tier
    with_kernel = flagship.flagship_serving(paged_kernel=True)
    try:
        serving.PagedServingEngine(qp, q_cfg, with_kernel, device="cuda")
    except ValueError as exc:
        refusal = str(exc)
    else:
        refusal = None
    check(refusal == "paged_kernel needs bf16 pools; int8_kv uses the "
          "gather tier", f"4g(c): paged_kernel with int8_kv: {refusal!r}")
    sc = flagship.flagship_serving(paged_kernel=False)
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)
    eng = _warmed(lambda: serving.PagedServingEngine(qp, q_cfg, sc,
                                                     device="cuda"), reqs)
    zero_counts(pa.paged_attention)
    done, wall, syncs = _drain(eng, reqs)
    rep = eng.report()
    check(pa.paged_attention.launches == 0 and rep["paged"]["blocks_in_use"]
          == 0, f"4g(c): {pa.paged_attention.launches} paged launches, "
          f"{rep['paged']['blocks_in_use']} blocks left")
    out["paged_int8_gather"] = _run_stats(
        "4g(c) phase 4's stream, int8 pools (gather tier)", q_cfg, done,
        wall, rep, syncs)
    out["paged_int8_gather"]["refusal"] = refusal
    del qp
    log(json.dumps({"int8_serving": out}))
    return out


# ---------------------------------------------------------------------
# phase 4h: MoE serving at full width


MOE_EXPERTS = 4   # MoeConfig's default


def _first_tokens_gate(name: str, serving, decode, params, cfg, reqs,
                       done) -> int:
    """Each request's first token against its prompt admitted alone in
    its bucket (one prefill, the MoE routing that prompt's padded tokens
    alone): equal, or split where the alone logits' top-2 margin is
    under SPLIT_MARGIN_REL of their largest magnitude (a wave's bf16
    products round differently from a lone prompt's). Returns the count
    of such splits."""
    splits = 0
    with torch.no_grad():
        for r in reqs:
            window = torch.as_tensor(serving._padded_window(r.prompt),
                                     device="cuda")
            alone = serving._prefill_into_slot(
                params, decode.init_cache(cfg, 1, window.shape[1],
                                          device="cuda"),
                window, len(r.prompt), 0, cfg=cfg)
            tok = done[r.request_id].tokens[0]
            if tok == int(alone.argmax()):
                continue
            top2 = alone.topk(2).values
            rel = float(top2[0] - top2[1]) / float(alone.abs().max())
            check(rel < SPLIT_MARGIN_REL,
                  f"{name}: {r.request_id}'s first token {tok}, "
                  f"{int(alone.argmax())} admitted alone (top-2 margin "
                  f"{rel:.3e})")
            splits += 1
    log(f"{name}: {len(reqs)} first tokens against their prompts admitted "
        f"alone: {len(reqs) - splits} equal, {splits} split at a near tie")
    return splits


def moe_serving_phase(flagship, serving, tf, fa, pa, cfg) -> dict:
    """Phase 4h: the flagship with ``n_experts=4`` as a bf16 snapshot of
    random weights (seed 0; the router stays fp32), phase 4's stream
    through ``PagedServingEngine(paged_kernel=True)`` (flash launches
    n_layers x prefill dispatches, paged n_layers x chunk x decode
    rounds, as phase 4 counts them), ``ServingEngine`` (chunk 64) and
    ``SpeculativeServingEngine`` (k 4, 4 windows). tok/s, TTFT, e2e;
    every first token held to its prompt admitted alone."""
    from kind_tpu_sim_torch.models import decode

    m_cfg = dataclasses.replace(cfg, n_experts=MOE_EXPERTS)
    smp = decode.serving_params(tf.init_params(
        m_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), m_cfg)
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)
    base = dict(max_slots=flagship.SLOTS, max_len=1024)
    runs = (("4h MoE paged kernel tier", serving.PagedServingEngine,
             flagship.flagship_serving(paged_kernel=True)),
            ("4h MoE dense grid", serving.ServingEngine,
             serving.ServingConfig(chunk=flagship.CHUNK, **base)),
            ("4h MoE speculative grid", serving.SpeculativeServingEngine,
             serving.ServingConfig(speculative_k=SPEC_K,
                                   spec_windows=SPEC_WINDOWS, **base)))
    out, routes = {}, {}
    for name, engine, sc in runs:
        eng = _warmed(lambda: engine(smp, m_cfg, sc, device="cuda"), reqs)
        zero_counts(fa.flash_attention, pa.paged_attention)
        done, wall, syncs = _drain(eng, reqs)
        rep = eng.report()
        check(len(done) == len(reqs), f"{name}: {len(done)} completed")
        _flash_check(name, fa, m_cfg.n_layers * rep["prefill_dispatches"],
                     routes)
        want_paged = (m_cfg.n_layers * sc.chunk * rep["decode_rounds"]
                      if sc.paged_kernel else 0)
        got_paged = dict(pa.paged_attention.launches_by_route)
        check(got_paged == {"split_kv": want_paged, "one_pass": 0},
              f"{name}: paged launches by route {got_paged}, expected "
              f"{want_paged} on split_kv")
        stats = _run_stats(name, m_cfg, done, wall, rep, syncs)
        stats["paged_launches"] = want_paged
        stats["first_token_splits"] = _first_tokens_gate(
            name, serving, decode, smp, m_cfg, reqs, done)
        out[name] = stats
    out["flash_launches_by_route"] = routes
    del smp
    log(json.dumps({"moe_serving": out}))
    return out


# ---------------------------------------------------------------------
# phase 4i: compiled rounds, each engine's CUDA graphs against its eager
# rounds


# the timed runs of each path, in turns: the eager run holds the eager
# rounds to the graphs (a stream of eager rounds takes 5-10x a stream of
# replays, so one is what the script's time limit leaves room for), the
# graphs' two give their median
COMPILED_ORDER = ("graph", "eager", "graph")
# 4i's engines keep the flagship's widths at 2 of its 8 layers: an
# eager round's cost is its launches, n_layers of each (phase 4 and 4b-4h
# serve the full depth, graphs and eager admission included)
COMPILED_LAYERS = 2
COMPILED_LP_TOL = 1e-4   # logprobs, graph replays against eager rounds


def _stream_run(eng, reqs):
    """Serve copies of ``reqs`` on ``eng`` (sequential rounds), the host
    wall of each round recorded. Returns ({id: Completion}, wall s,
    [(round wall s, whether the round admitted)])."""
    rounds, step = [], eng.step_round

    def timed():
        prefills = eng.prefills
        t0 = time.perf_counter()
        step()
        rounds.append((time.perf_counter() - t0, eng.prefills != prefills))

    eng.step_round = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    done = {c.request_id: c for c in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng.step_round
    return done, wall, rounds


def _traced_round(flagship, eng, reqs) -> dict:
    """``profile_serving``'s trace of one pure decode round of ``eng``:
    the stream submitted, its first round run (admission), the second
    traced. The stream is left in flight."""
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    eng.step_round()
    prefills = eng.prefills
    prof = flagship._profile_round(eng)
    check(eng.prefills == prefills, "4i: the traced round admitted")
    return prof


def compiled_rounds_phase(flagship, serving, tf, quant, fa, pa, im,
                          cfg) -> dict:
    """Phase 4i: every serving round a CUDA graph replay, held against
    the same engine's eager rounds (its ``_round`` rebound to
    ``graphs.eager``), at flagship width and ``COMPILED_LAYERS`` layers
    (seed-0 weights) on phase 4's stream: the dense
    grid (chunk 64), the paged gather and kernel tiers, the prompt-lookup
    grid, the paged speculative engine, the draft-model grid (a random
    2-layer draft with the flagship's vocab), W8A8 with the int8 KV cache
    on the dense grid and the 4-expert MoE on the paged kernel tier. Each
    engine serves the stream once through its graphs (capturing every key
    the stream needs; its second round, a replay, traced), then in the
    turns of ``COMPILED_ORDER``: token streams equal, logprobs within
    ``COMPILED_LP_TOL``, the kernels' launches the same in every run (the
    paged kernel's n_layers x chunk x decode rounds); then one eager
    round is traced. Printed: graphs captured, capture seconds and
    replays; medians of tok/s and of the pure decode rounds' step wall
    for both paths; a traced round's device busy share and kernels a
    step for both paths."""
    from kind_tpu_sim_torch.models import decode, graphs

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    cfg = dataclasses.replace(cfg, n_layers=COMPILED_LAYERS)
    sp = flagship.flagship_params(cfg)
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)
    base = dict(max_slots=flagship.SLOTS, max_len=1024)
    spec = dict(base, speculative_k=SPEC_K, spec_windows=SPEC_WINDOWS)
    q_cfg = dataclasses.replace(cfg, int8_kv=True, int8_native=True)
    qp = quant.quantize_params(tf.init_params(cfg, gen(0), "cuda"), q_cfg)
    m_cfg = dataclasses.replace(cfg, n_experts=MOE_EXPERTS)
    smp = decode.serving_params(tf.init_params(m_cfg, gen(0), "cuda"),
                                m_cfg)
    dcfg = tf.ModelConfig(vocab_size=cfg.vocab_size, d_model=256, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=1024,
                          max_seq=cfg.max_seq, dtype=cfg.dtype, flash=True)
    dparams = decode.serving_params(tf.init_params(dcfg, gen(5), "cuda"),
                                    dcfg)
    dense_sc = serving.ServingConfig(chunk=flagship.CHUNK, **base)
    engines = (
        ("dense chunk 64", serving.ServingEngine, sp, cfg, dense_sc, {}),
        ("paged gather tier", serving.PagedServingEngine, sp, cfg,
         flagship.flagship_serving(paged_kernel=False), {}),
        ("paged kernel tier", serving.PagedServingEngine, sp, cfg,
         flagship.flagship_serving(paged_kernel=True), {}),
        ("prompt-lookup grid", serving.SpeculativeServingEngine, sp, cfg,
         serving.ServingConfig(**spec), {}),
        ("paged speculative", serving.PagedSpeculativeServingEngine, sp, cfg,
         serving.ServingConfig(paged_blocks=flagship.POOL_BLOCKS,
                               block_size=flagship.BLOCK, paged_width=8,
                               **spec), {}),
        ("draft-model grid", serving.SpeculativeServingEngine, sp, cfg,
         serving.ServingConfig(**spec), {"draft": (dparams, dcfg)}),
        ("W8A8 + int8 KV dense chunk 64", serving.ServingEngine, qp, q_cfg,
         dense_sc, {}),
        ("MoE paged kernel tier", serving.PagedServingEngine, smp, m_cfg,
         flagship.flagship_serving(paged_kernel=True), {}),
    )
    wrappers = {"flash_attention": fa.flash_attention,
                "paged_attention": pa.paged_attention,
                "int8_matmul": im.int8_matmul}
    out = {}
    for name, engine, params, c, sc, extra in engines:
        eng = engine(params, c, sc, device="cuda", **extra)
        runner, admit = eng._round, eng._admit_round
        check(isinstance(runner, graphs.RoundGraphs)
              and isinstance(admit, graphs.RoundGraphs),
              f"4i {name}: the engine's round is {runner!r}, its admission "
              f"{admit!r}, not graphs")
        steps = sc.spec_windows if sc.speculative_k else sc.chunk
        traced = {"graph": _traced_round(flagship, eng, reqs)}
        warm = {c_.request_id: c_ for c_ in eng.run()}
        check(len(warm) == len(reqs), f"4i {name}: {len(warm)} completed")
        want = {r: c_.tokens for r, c_ in warm.items()}
        captured, admit_captured = runner.captured, admit.captured
        ref_lp = counts = None
        runs = {"graph": [], "eager": []}
        max_lp = 0.0
        for path in COMPILED_ORDER:
            eng._round = runner if path == "graph" else graphs.eager
            # graph runs admit through graphs too, eager runs eagerly
            eng._admit_round = admit if path == "graph" else graphs.eager
            zero_counts(*wrappers.values())
            rounds0 = eng.decode_rounds
            done, wall, rounds = _stream_run(eng, reqs)
            got = {r: c_.tokens for r, c_ in done.items()}
            check(got == want, f"4i {name}, {path}: token streams differ "
                  "from the graphs' first run")
            lps = {r: np.asarray(c_.logprobs) for r, c_ in done.items()}
            if ref_lp is None:
                ref_lp = lps
            diff = max(float(np.abs(lps[r] - ref_lp[r]).max()) for r in lps)
            max_lp = max(max_lp, diff)
            launched = {n: dict(w.launches_by_route)
                        for n, w in wrappers.items()}
            check(counts is None or launched == counts,
                  f"4i {name}, {path}: launches {launched}, another run "
                  f"{counts}")
            counts = launched
            if sc.paged_kernel:
                n = c.n_layers * sc.chunk * (eng.decode_rounds - rounds0)
                check(launched["paged_attention"] == {"split_kv": n,
                                                      "one_pass": 0},
                      f"4i {name}, {path}: paged launches "
                      f"{launched['paged_attention']}, expected {n} on "
                      "split_kv")
            gen_tokens = sum(len(t) for t in got.values())
            pure = [w / steps for w, admitted in rounds if not admitted]
            runs[path].append({"tok_per_s": gen_tokens / wall,
                               "step_wall_ms": 1e3 * float(np.median(pure))})
        check(max_lp <= COMPILED_LP_TOL,
              f"4i {name}: logprobs differ by {max_lp:.3e} between runs "
              f"(bar {COMPILED_LP_TOL})")
        check(runner.captured == captured
              and admit.captured == admit_captured,
              f"4i {name}: {runner.captured - captured} round and "
              f"{admit.captured - admit_captured} admission graphs captured "
              "after the first stream")
        eng._round = eng._admit_round = graphs.eager
        traced["eager"] = _traced_round(flagship, eng, reqs)
        row = {"graphs_captured": runner.captured,
               "capture_s": runner.capture_s, "replays": runner.replays,
               "admission_graphs_captured": admit.captured,
               "admission_capture_s": admit.capture_s,
               "admission_replays": admit.replays,
               "max_logprob_diff": max_lp, "launches_a_run": counts}
        for path, rs in runs.items():
            step_ms = float(np.median([r["step_wall_ms"] for r in rs]))
            row[path] = {
                "tok_per_s": float(np.median([r["tok_per_s"] for r in rs])),
                "step_wall_ms": step_ms,
                "tok_per_s_runs": [r["tok_per_s"] for r in rs],
                "step_wall_ms_runs": [r["step_wall_ms"] for r in rs],
                "traced_device_busy_share": traced[path]["device_busy_share"],
                "traced_device_busy_ms": traced[path]["device_busy_ms"],
                "traced_round_wall_ms": traced[path]["round_wall_ms"],
                "traced_device_ops_per_step": traced[path][
                    "device_ops_per_step"],
                # the traced round's device time over the untraced
                # rounds' median wall: the profiler slows the host
                "busy_over_untraced_wall": traced[path]["device_busy_ms"]
                / (step_ms * steps),
                "traced_top_kernels_ms": dict(list(
                    traced[path]["kernels"].items())[:8])}
        row["graph_over_eager_tok_per_s"] = (row["graph"]["tok_per_s"]
                                             / row["eager"]["tok_per_s"])
        out[name] = row
        log(f"4i {name}: {runner.captured} graphs captured in "
            f"{runner.capture_s:.2f} s, {runner.replays} replays; admission "
            f"{admit.captured} graphs in {admit.capture_s:.2f} s, "
            f"{admit.replays} replays; tok/s "
            f"graph {row['graph']['tok_per_s']:.1f} / eager "
            f"{row['eager']['tok_per_s']:.1f} "
            f"({row['graph_over_eager_tok_per_s']:.2f}x, medians of "
            f"{len(runs['graph'])} and {len(runs['eager'])}); step wall graph "
            f"{row['graph']['step_wall_ms']:.3f} ms / eager "
            f"{row['eager']['step_wall_ms']:.3f} ms; traced busy share graph "
            f"{row['graph']['traced_device_busy_share']:.3f} / eager "
            f"{row['eager']['traced_device_busy_share']:.3f} (its device time "
            f"over the untraced wall: graph "
            f"{row['graph']['busy_over_untraced_wall']:.3f} / eager "
            f"{row['eager']['busy_over_untraced_wall']:.3f}); device ops a "
            f"step {row['graph']['traced_device_ops_per_step']:.1f}; streams "
            f"equal, logprobs within {max_lp:.2e}")
        del eng, runner, admit
    out["w8a8_over_bf16_dense_tok_per_s"] = {
        path: out["W8A8 + int8 KV dense chunk 64"][path]["tok_per_s"]
        / out["dense chunk 64"][path]["tok_per_s"]
        for path in ("graph", "eager")}
    del sp, qp, smp, dparams
    log(json.dumps({"compiled_rounds": out}))
    return out


# ---------------------------------------------------------------------
# phase 5: a tiny model trained on the card against the CPU plain path


def small_train_phase(tf, fa) -> None:
    """5 AdamW steps of a tiny fp32 flash GQA model on the card (the
    flash forward, dq and dk/dv kernels inside autograd) and the same
    steps on the CPU (the plain versions), from the same parameters on
    the same batches; then the same steps on the card with
    ``remat=True``, held to the card's ``remat=False`` run at the same
    bars, the forward kernel launched twice per layer and step."""
    cfg = tf.ModelConfig(vocab_size=256, d_model=128, n_heads=4,
                         n_kv_heads=2, n_layers=2, d_ff=256, max_seq=64,
                         dtype="float32", flash=True)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                            "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    batches = [tf.sample_batch(gen, cfg, 4, 65, device="cuda")
               for _ in range(5)]

    def train(device, remat=False):
        step, init = tf.make_train_step(
            dataclasses.replace(cfg, remat=remat), device=device)
        state = init({"embed": params["embed"].clone(),
                      "final_norm": params["final_norm"].clone(),
                      "blocks": [{k: v.clone() for k, v in b.items()}
                                 for b in params["blocks"]]})
        losses = []
        for tokens in batches:
            state, loss = step(state, tokens.to(device))
            losses.append(float(loss))
        return losses, [p.detach().cpu() for p in tf._leaves(state["params"])]

    def counts():
        return (fa.flash_attention.launches,
                fa.flash_attention_bwd_dq.launches,
                fa.flash_attention_bwd_dkv.launches)

    n = cfg.n_layers * len(batches)
    zero_counts(fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = counts()
    card_losses, card_params = train("cuda")
    got = tuple(x - y for x, y in zip(counts(), before))
    check(got == (n, n, n),
          f"small train: launches (forward, dq, dk/dv) {got}, expected "
          f"{(n, n, n)}: once per layer and step")
    before = counts()
    remat_losses, remat_params = train("cuda", remat=True)
    got = tuple(x - y for x, y in zip(counts(), before))
    check(got == (2 * n, n, n),
          f"small train remat: launches (forward, dq, dk/dv) {got}, "
          f"expected {(2 * n, n, n)}")
    # fp32: every forward, dq and dk/dv launch on the CUDA-core route
    check_routes("small train flash_attention", fa.flash_attention, 0, 3 * n)
    check_routes("small train flash backward dq", fa.flash_attention_bwd_dq,
                 0, 2 * n)
    check_routes("small train flash backward dk/dv",
                 fa.flash_attention_bwd_dkv, 0, 2 * n)
    remat_loss_err = max(abs(a - b) / max(1.0, abs(b))
                         for a, b in zip(remat_losses, card_losses))
    remat_param_err = max(float((a - b).abs().max())
                          for a, b in zip(remat_params, card_params))
    log(f"small train remat on the card: loss error {remat_loss_err:.3e} "
        f"(relative to remat=False, tolerance {TRAIN_LOSS_RTOL}), final "
        f"parameters max_abs_err {remat_param_err:.3e} (tolerance "
        f"{TRAIN_PARAM_ATOL}); launches forward, dq, dk/dv {got}")
    check(remat_loss_err <= TRAIN_LOSS_RTOL,
          "small train remat: losses differ from remat=False")
    check(remat_param_err <= TRAIN_PARAM_ATOL,
          "small train remat: parameters differ from remat=False")
    plain_losses, plain_params = train("cpu")
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(card_losses, plain_losses))
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(card_params, plain_params))
    log(f"small train: losses card {card_losses}, CPU {plain_losses}; "
        f"loss error {loss_err:.3e} (relative, tolerance "
        f"{TRAIN_LOSS_RTOL}), final parameters max_abs_err {param_err:.3e} "
        f"(tolerance {TRAIN_PARAM_ATOL})")
    check(all(math.isfinite(x) for x in card_losses),
          "small train: non-finite loss on the card")
    check(loss_err <= TRAIN_LOSS_RTOL, "small train: losses differ")
    check(param_err <= TRAIN_PARAM_ATOL, "small train: parameters differ")


# the tiny MoE's first-step gradients on the card against the CPU, each
# leaf's largest |difference| over its largest magnitude: fp32 throughout
# (TF32 off), only the summation order differs (7.3e-7 measured on the
# H100). Its AdamW parameters are printed, not held to a bar: an expert
# weight whose gradient is near AdamW's eps (1e-8) takes a step of
# lr * g / (|g| + eps), so 1e-7 relative noise there moves it by up to
# lr; one step moved b0.moe.w_up by 8.5e-4 while SGD's parameters agree
# to 2.4e-7 after 5 steps.
MOE_GRAD_REL_TOL = 1e-5


def small_moe_train_phase(tf, fa) -> None:
    """Phase 5, MoE: 5 AdamW steps of a tiny fp32 flash GQA model with 4
    experts on the card (autograd through the dense dispatch, the flash
    kernels inside) against the same steps on the CPU from the same
    parameters on the same batches: the losses, which carry the
    auxiliary term, at ``small_train_phase``'s bar, the flash forward,
    dq and dk/dv launched once per layer and step; then the first
    step's gradients at ``MOE_GRAD_REL_TOL``."""
    cfg = tf.ModelConfig(vocab_size=256, d_model=128, n_heads=4,
                         n_kv_heads=2, n_layers=2, d_ff=256, max_seq=64,
                         dtype="float32", flash=True, n_experts=MOE_EXPERTS)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(9),
                            "cuda")
    gen = torch.Generator(device="cuda").manual_seed(10)
    batches = [tf.sample_batch(gen, cfg, 4, 65, device="cuda")
               for _ in range(5)]

    def train(device):
        step, init = tf.make_train_step(cfg, device=device)
        state = init(_tree_to(params, lambda t: t.detach().clone()))
        losses = []
        for tokens in batches:
            state, loss = step(state, tokens.to(device))
            losses.append(float(loss))
        return losses, [p.detach().cpu() for p in tf._leaves(state["params"])]

    def first_grads(device):
        tree = _tree_to(params, lambda t: t.detach().to(device))
        leaves = tf._leaves(tree)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = tf.loss_fn(tree, batches[0].to(device), cfg)
        return [g.cpu() for g in torch.autograd.grad(loss, leaves)]

    n = cfg.n_layers * len(batches)
    zero_counts(fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    card_losses, card_params = train("cuda")
    got = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
           fa.flash_attention_bwd_dkv.launches)
    check(got == (n, n, n),
          f"small MoE train: launches (forward, dq, dk/dv) {got}, expected "
          f"{(n, n, n)}: once per layer and step")
    plain_losses, plain_params = train("cpu")
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(card_losses, plain_losses))
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(card_params, plain_params))
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(first_grads("cuda"), first_grads("cpu")))
    log(f"small MoE train: losses card {card_losses}, CPU {plain_losses}; "
        f"loss error {loss_err:.3e} (tolerance {TRAIN_LOSS_RTOL}); first "
        f"step's gradients {grad_err:.3e} of each leaf's largest magnitude "
        f"(tolerance {MOE_GRAD_REL_TOL}); final AdamW parameters "
        f"max_abs_err {param_err:.3e} (no bar: AdamW near eps)")
    check(all(math.isfinite(x) for x in card_losses),
          "small MoE train: non-finite loss on the card")
    check(loss_err <= TRAIN_LOSS_RTOL, "small MoE train: losses differ")
    check(grad_err <= MOE_GRAD_REL_TOL, "small MoE train: gradients differ")


# ---------------------------------------------------------------------
# phase 6: training at full width


FLASH_WRAPPERS = ("flash_attention", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")


def train_twins(label: str, trainer, fa, cfg, timed: int) -> dict:
    """``cfg`` trained as ``profile_train`` trains the flagship (its
    seed-0 state, its batches) twice: by the compiled step
    (``make_train_step`` on the card: the first step eager, capturing the
    graph every later step replays), then by an eager one (the same
    step with its runner rebound to ``graphs.eager``), each one warm-up
    step and ``timed`` timed steps. The graphed trainer runs first, the
    flash kernels' launches counted over its timed steps, and is freed
    (its graph pool with it) before the eager one runs; its final
    parameters are kept on the card. Losses and final parameters must
    be bitwise equal (the same capturable AdamW). Returns {path:
    {"walls_ms", "losses", "warm_ms", "peak_gib" (reserved: a replay's
    activations live in the graph's pool, which the allocator counts as
    reserved, not allocated), "peak_allocated_gib"}, "launches",
    "routes", "graphs"}."""
    from kind_tpu_sim_torch.models import graphs

    batches = trainer.flagship_batches(cfg, timed + 1)
    out, kept = {}, None
    for path in ("graph", "eager"):
        t0 = time.perf_counter()
        step, state = trainer.flagship_state(cfg)
        setup_s = time.perf_counter() - t0
        if path == "eager":
            step._round = graphs.eager
        check(isinstance(step._round, graphs.RoundGraphs) == (path == "graph"),
              f"{label}: the {path} trainer's step runs through "
              f"{step._round!r}")
        check(state["opt"].defaults["capturable"],
              f"{label}: AdamW is not capturable on the card")
        state, warm, _ = trainer.timed_steps(step, state, batches[:1])
        zero_counts(*(getattr(fa, n) for n in FLASH_WRAPPERS))
        torch.cuda.reset_peak_memory_stats()
        state, walls, losses = trainer.timed_steps(step, state, batches[1:])
        out[path] = {"walls_ms": walls, "losses": losses, "warm_ms": warm[0],
                     "step_ms": float(np.median(walls)), "setup_s": setup_s,
                     "peak_gib": torch.cuda.max_memory_reserved() / 2**30,
                     "peak_allocated_gib":
                         torch.cuda.max_memory_allocated() / 2**30}
        check(all(math.isfinite(x) for x in losses),
              f"{label} ({path}): non-finite loss in {losses}")
        leaves = trainer.tf._leaves(state["params"])
        if path == "graph":
            out["launches"] = {n: getattr(fa, n).launches
                               for n in FLASH_WRAPPERS}
            out["routes"] = {n: dict(getattr(fa, n).launches_by_route)
                             for n in FLASH_WRAPPERS}
            out["graphs"] = {"captured": step._round.captured,
                             "capture_s": step._round.capture_s,
                             "replays": step._round.replays}
            kept = [p.detach().clone() for p in leaves]
            out["final_state"] = None
        else:
            same = all(torch.equal(a, b) for a, b in zip(leaves, kept))
            check(losses == out["graph"]["losses"] and same,
                  f"{label}: the eager steps' losses {losses} or parameters "
                  f"(equal: {same}) differ from the graphed steps' "
                  f"{out['graph']['losses']}")
            out["final_state"] = state
        del step, leaves
        if path == "graph":
            del state
        gc.collect()
        torch.cuda.empty_cache()
    del kept
    g, e = out["graph"], out["eager"]
    log(f"{label}: graphed step (first step eager, {out['graphs']['captured']}"
        f" graph captured in {out['graphs']['capture_s']:.2f} s) walls ms "
        f"{[round(w, 1) for w in g['walls_ms']]} (median {g['step_ms']:.1f}, "
        f"warm-up {g['warm_ms']:.1f}); eager "
        f"{[round(w, 1) for w in e['walls_ms']]} (median {e['step_ms']:.1f}, "
        f"warm-up {e['warm_ms']:.1f}); losses "
        f"and final parameters bitwise equal ({g['losses']}); peak device "
        f"memory reserved {g['peak_gib']:.2f} / {e['peak_gib']:.2f} GiB, "
        f"allocated {g['peak_allocated_gib']:.2f} / "
        f"{e['peak_allocated_gib']:.2f} GiB (graphed / eager)")
    return out


def train_phase(trainer, fa) -> tuple:
    """The flagship workload of ``kind_tpu_sim_torch.profile_train``
    (the same configuration, parameters, batches and optimizer), the
    compiled step against the eager one (``train_twins``). Returns
    (launches, {"step_ms", "peak_gib", "routes"}) of the compiled
    step."""
    cfg = trainer.flagship_config()
    steps = trainer.STEPS
    twins = train_twins("flagship training", trainer, fa, cfg, steps)
    del twins["final_state"]
    launches, g = twins["launches"], twins["graph"]
    want = cfg.n_layers * steps
    log(f"train launches: {launches} (expected n_layers x steps = {want} "
        "each)")
    check(all(n == want for n in launches.values()),
          "flagship training launch counts")
    for name in launches:
        check(twins["routes"][name] == {"tensor_cores": want,
                                        "cuda_cores": 0},
              f"flagship training {name}: routes {twins['routes'][name]}")
    median = g["step_ms"]
    tokens = trainer.BATCH * (trainer.SEQ - 1)
    log(f"flagship training: {steps} steps of {trainer.BATCH} x "
        f"{trainer.SEQ - 1} trained positions, graphed step median "
        f"{median:.1f} ms = {tokens / (median / 1e3):.1f} train tok/s "
        f"(eager {twins['eager']['step_ms']:.1f} ms = "
        f"{tokens / (twins['eager']['step_ms'] / 1e3):.1f}); losses "
        f"{g['losses']}")
    log(json.dumps({"train_twins": {k: v for k, v in twins.items()
                                    if k != "routes"}}))
    return launches, {"step_ms": median, "peak_gib": g["peak_gib"],
                      "eager_step_ms": twins["eager"]["step_ms"],
                      "routes": twins["routes"]}


# ---------------------------------------------------------------------
# phase 6, continued: one flagship step with remat


def train_remat_phase(trainer, fa, plain: dict) -> None:
    """One flagship train step with ``remat=True`` after a warm-up step
    (which allocates AdamW's state and captures the step), the compiled
    step against the eager one (``train_twins``), counters zeroed just
    before the graphed step: the flash forward runs twice per layer (the
    forward and the backward's recompute), dq and dk/dv once. Its peak
    device memory is printed beside the ``remat=False`` steps'
    (``plain``, from ``train_phase``)."""
    cfg = dataclasses.replace(trainer.flagship_config(), remat=True)
    twins = train_twins("flagship remat", trainer, fa, cfg, 1)
    del twins["final_state"]
    launches, g = twins["launches"], twins["graph"]
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers}
    log(f"flagship remat step launches: {launches} (expected {want})")
    check(launches == want, "flagship remat launch counts")
    for name, n in want.items():
        check(twins["routes"][name] == {"tensor_cores": n, "cuda_cores": 0},
              f"flagship remat {name}: routes {twins['routes'][name]}")
    log(f"flagship remat: graphed step {g['walls_ms'][0]:.1f} ms, eager "
        f"{twins['eager']['walls_ms'][0]:.1f} ms (remat=False median "
        f"{plain['step_ms']:.1f} ms); peak device memory reserved "
        f"{g['peak_gib']:.2f} "
        f"GiB (remat=False {plain['peak_gib']:.2f} GiB); loss "
        f"{g['losses'][0]}")


# ---------------------------------------------------------------------
# phase 6b: MoE training at full width


MOE_TRAIN_STEPS = 3


def train_moe_phase(trainer, tf, fa, plain: dict) -> dict:
    """The flagship with ``n_experts=4`` trained as phase 6 trains it (fp32
    parameters from seed 0, bf16 activations, AdamW, batches of 8 x 1025
    from seed 1), the compiled step against the eager one
    (``train_twins``; phase 6's graphs freed before): one warm-up step,
    then ``MOE_TRAIN_STEPS`` timed with the counters zeroed just before.
    Every loss finite; the flash forward, dq and dk/dv each launched
    n_layers x steps; the summed auxiliary term at least 0.99 x
    ``aux_loss_weight`` (tests/test_moe.py holds one MoE call so). Step
    wall, train tok/s and peak memory beside the dense step's
    (``plain``)."""
    from kind_tpu_sim_torch.models.moe import MoeConfig

    cfg = dataclasses.replace(trainer.flagship_config(),
                              n_experts=MOE_EXPERTS)
    twins = train_twins("flagship MoE training", trainer, fa, cfg,
                        MOE_TRAIN_STEPS)
    state = twins.pop("final_state")
    g = twins["graph"]
    n_params = sum(p.numel() for p in tf._leaves(state["params"]))
    log(f"flagship MoE training: {n_params} fp32 parameters, set up in "
        f"{g['setup_s']:.2f} s")
    want = cfg.n_layers * MOE_TRAIN_STEPS
    log(f"flagship MoE train launches: {twins['launches']} (expected "
        f"n_layers x steps = {want} each)")
    for name in FLASH_WRAPPERS:
        check(twins["routes"][name] == {"tensor_cores": want,
                                        "cuda_cores": 0},
              f"flagship MoE training {name}: routes "
              f"{twins['routes'][name]}")
    batches = trainer.flagship_batches(cfg, MOE_TRAIN_STEPS + 1)
    with torch.no_grad():
        _, aux = tf.forward(state["params"], batches[-1][:, :-1], cfg,
                            return_aux=True)
    weight = MoeConfig().aux_loss_weight
    check(float(aux) >= 0.99 * weight,
          f"flagship MoE training: auxiliary term {float(aux)} under 0.99 x "
          f"{weight}")
    median = g["step_ms"]
    tokens = trainer.BATCH * (trainer.SEQ - 1)
    out = {"step_ms": median, "walls_ms": g["walls_ms"],
           "losses": g["losses"],
           "train_tok_per_s": tokens / (median / 1e3),
           "peak_gib": g["peak_gib"], "aux": float(aux),
           "dense_step_ms": plain["step_ms"],
           "dense_peak_gib": plain["peak_gib"], "warm_up_ms": g["warm_ms"],
           "eager": twins["eager"], "graphs": twins["graphs"]}
    log(f"flagship MoE training: graphed step wall ms "
        f"{[round(w, 1) for w in g['walls_ms']]} (median {median:.1f}; "
        f"eager {twins['eager']['step_ms']:.1f}; dense {plain['step_ms']:.1f})"
        f" = {out['train_tok_per_s']:.1f} train tok/s; losses {g['losses']}; "
        f"auxiliary term {float(aux):.5f} over {cfg.n_layers} layers; peak "
        f"device memory reserved {g['peak_gib']:.2f} GiB (eager "
        f"{twins['eager']['peak_gib']:.2f}; dense {plain['peak_gib']:.2f} "
        "GiB)")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phase 7: the kernel-toolchain gate, then its kernels at flagship width


def _bf16_ulps(got, want) -> float:
    """The largest |got - want| in units of bf16's last place at the
    larger of the two magnitudes."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp_min(
        torch.finfo(torch.bfloat16).tiny)
    return float(((g - w).abs() / ulp).max())


def _rows_input(gen, shape, dtype, offset: int = 0, scale: float = 1.0):
    """A normal (rows, n) tensor on the card; with ``offset`` a view
    that many elements into its allocation (off a 16-byte boundary)."""
    n = math.prod(shape)
    flat = torch.randn((n + offset,), generator=gen, device="cuda") * scale
    return flat.to(dtype)[offset:].view(shape)


def _row_case(name: str, fn, want_route: str, got, want, ulps_bar: float,
              atol: float = 0.0) -> float:
    """Check one row-kernel case: output dtype and shape, NaN exactly
    where the plain version has NaN, the route its one launch took, and
    the error on the rest (bf16 in units of bf16's last place, at most
    ``ulps_bar``; fp32 absolute, at most ``atol``). Returns the largest
    absolute error."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: output {got.dtype} {tuple(got.shape)}")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan),
          f"{name}: NaN where the plain version has none, or the reverse")
    g = got.float().masked_fill(nan, 0.0)
    w = want.float().masked_fill(nan, 0.0)
    err = float((g - w).abs().max())
    if got.dtype == torch.float32:
        log(f"{name}: max_abs_err {err:.3e} (tolerance {atol}), "
            f"{int(nan.any(-1).sum())} NaN rows")
        check(math.isfinite(err) and err <= atol, f"{name}: error {err}")
    else:
        ulps = _bf16_ulps(g, w)
        log(f"{name}: max_abs_err {err:.3e}, {ulps:.2f} bf16 ulps (tolerance "
            f"{ulps_bar}), {int(nan.any(-1).sum())} NaN rows")
        check(ulps <= ulps_bar, f"{name}: {ulps} ulps")
    counts = [int(r == want_route) for r in fn.launches_by_route]
    check_routes(name, fn, *counts)
    return err


def rms_norm_cases(tc, gen, gate_routes: dict) -> dict:
    """rms_norm on the card against its plain version, each case through
    the user's wrapper with its route asserted: the vector route at the
    flagship shape (the norm input over one training batch, bf16 (8192,
    2048)) with an fp32 and a bf16 weight, on a row count the 8 rows a
    block do not divide, on fp32 rows with a bf16 weight (8-byte weight
    loads), and at the longest row it holds (bf16 d 65536, 32 warps a
    row); the scalar route on rows the vector route refuses
    (d % 8 != 0, a base off a 16-byte boundary, one chunk past the
    longest). Then the two routes timed in turns at the flagship shape.
    Returns the kernels line's row."""
    m, k = 8192, 2048
    x = _rows_input(gen, (m, k), torch.bfloat16)
    w = _rows_input(gen, (k,), torch.float32)
    cases = [
        ("flagship, fp32 weight", x, w, tc.VECTOR),
        ("flagship, bf16 weight", x, w.bfloat16(), tc.VECTOR),
        ("1001 rows", _rows_input(gen, (1001, k), torch.bfloat16), w,
         tc.VECTOR),
        ("fp32 x, bf16 weight", _rows_input(gen, (1001, k), torch.float32),
         w.bfloat16(), tc.VECTOR),
        ("longest row held, d 65536",
         _rows_input(gen, (64, 65536), torch.bfloat16),
         _rows_input(gen, (65536,), torch.float32), tc.VECTOR),
        ("one chunk past it, d 65544",
         _rows_input(gen, (16, 65544), torch.bfloat16),
         _rows_input(gen, (65544,), torch.float32), tc.SCALAR),
        ("d 2044", _rows_input(gen, (1001, 2044), torch.bfloat16),
         _rows_input(gen, (2044,), torch.float32), tc.SCALAR),
        ("base one element off",
         _rows_input(gen, (1001, k), torch.bfloat16, offset=1), w,
         tc.SCALAR),
    ]
    err, checked = 0.0, dict.fromkeys(tc.RMS_NORM_ROUTES, 0)
    for name, xc, wc, route in cases:
        zero_counts(tc.rms_norm)
        case_err = _row_case(
            f"rms_norm {str(xc.dtype)[6:]} {tuple(xc.shape)} {name}",
            tc.rms_norm, route, tc.rms_norm(xc, wc), tc.rms_norm_ref(xc, wc),
            RMS_NORM_ULPS, RMS_NORM_FP32_ATOL)
        checked[route] += 1
        if xc is x:
            err = max(err, case_err)
    del cases

    turns = time_routes(
        f"rms_norm bf16 ({m},{k})", lambda: tc.rms_norm(x, w),
        lambda: tc._rms_norm_launch(x, w, tc.VECTOR),
        lambda: tc._rms_norm_launch(x, w, tc.SCALAR),
        routes=tc.RMS_NORM_ROUTES)
    plain_ms = time_ms(lambda: tc.rms_norm_ref(x, w))
    w_bf16 = w.bfloat16()  # F.rms_norm wants the weight in x's dtype
    library_ms = time_ms(lambda: torch.nn.functional.rms_norm(
        x, (k,), w_bf16, 1e-6))
    library_device_ms = time_ms(lambda: torch.nn.functional.rms_norm(
        x, (k,), w_bf16, 1e-6), cover_enqueue=True)
    # the kernel's bytes moved by one PyTorch copy (x read, a copy
    # written): what one launch reaches here, as against the bound
    copy_device_ms = time_ms(x.clone, cover_enqueue=True)
    # x and w read once, out written once; ~4 fp32 flops an element
    bound_ms, bound_by = bound(2 * 2 * m * k + 4 * k, 4 * m * k,
                               torch.float32)
    share = bound_ms / turns["device_ms"]
    log(f"rms_norm timing: wrapper {turns['ms']:.4f} ms, device vector "
        f"{turns['device_ms']:.4f} ({share:.1%} of the bound) vs scalar "
        f"{turns['device_ms_scalar']:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.rms_norm {library_ms:.4f} ms (device {library_device_ms:.4f}), "
        f"x.clone() device {copy_device_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    return {"name": "rms_norm", "route": "cuda",
            "source": tc.RMS_NORM_SOURCE, "replaces": tc.RMS_NORM_REPLACES,
            "max_abs_err": err, "ms": turns["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "torch.nn.functional.rms_norm, weight cast "
                            "to bf16 beforehand",
            **{key: t for key, t in turns.items() if key != "ms"},
            "library_device_ms": library_device_ms,
            "copy_device_ms": copy_device_ms,
            "device_share_of_bound": share, "timed_route": tc.VECTOR,
            "launches_by_route": gate_routes,
            "check_launches_by_route": checked}


def _neg_inf_rows(gen, shape):
    """fp32 rows with about a third of the entries -inf and row 5 all
    -inf (its softmax is NaN, in the plain version as in the kernels)."""
    x = _rows_input(gen, shape, torch.float32, scale=4.0)
    x[torch.rand(x.shape, generator=gen, device="cuda") < 0.3] = -math.inf
    x[5] = -math.inf
    return x


def softmax_cases(tc, gen, gate_routes: dict) -> dict:
    """softmax on the card against its plain version, each case through
    the user's wrapper with its route asserted: the one_read route at
    the flagship shape (the readout logits over one training batch,
    fp32 (8192, 32768)) and in bf16, on a row count the 8 rows a block
    do not divide, and on rows with -inf entries and one all -inf row;
    the two_pass route on rows longer than the 32768 one_read holds
    (with -inf entries and an all -inf row too) and on a base off a
    16-byte boundary. Then the two routes timed in turns at the flagship
    shape. Returns the kernels line's row."""
    m, v = 8192, 32768
    x = _rows_input(gen, (m, v), torch.float32, scale=4.0)
    cases = [
        ("flagship", x, tc.ONE_READ),
        ("flagship in bf16",
         _rows_input(gen, (m, v), torch.bfloat16, scale=4.0), tc.ONE_READ),
        ("1001 rows",
         _rows_input(gen, (1001, 1024), torch.float32, scale=4.0),
         tc.ONE_READ),
        ("-inf entries, an all -inf row", _neg_inf_rows(gen, (64, v)),
         tc.ONE_READ),
        ("past the longest row held, -inf entries, an all -inf row",
         _neg_inf_rows(gen, (64, v + 4)), tc.TWO_PASS),
        ("base one element off",
         _rows_input(gen, (1001, 1024), torch.float32, offset=1,
                     scale=4.0),
         tc.TWO_PASS),
    ]
    err, checked = 0.0, dict.fromkeys(tc.SOFTMAX_ROUTES, 0)
    for name, xc, route in cases:
        zero_counts(tc.softmax)
        case_err = _row_case(
            f"softmax {str(xc.dtype)[6:]} {tuple(xc.shape)} {name}",
            tc.softmax, route, tc.softmax(xc), tc.softmax_ref(xc),
            SOFTMAX_BF16_ULPS, SOFTMAX_ATOL)
        checked[route] += 1
        if xc is x:
            err = case_err
    del cases

    turns = time_routes(
        f"softmax fp32 ({m},{v})", lambda: tc.softmax(x),
        lambda: tc._softmax_launch(x, tc.ONE_READ),
        lambda: tc._softmax_launch(x, tc.TWO_PASS),
        routes=tc.SOFTMAX_ROUTES)
    plain_ms = time_ms(lambda: tc.softmax_ref(x))
    library_ms = time_ms(lambda: torch.softmax(x, -1))
    library_device_ms = time_ms(lambda: torch.softmax(x, -1),
                                cover_enqueue=True)
    copy_device_ms = time_ms(x.clone, cover_enqueue=True)
    # x read once, out written once; ~5 fp32 flops an element
    bound_ms, bound_by = bound(2 * 4 * m * v, 5 * m * v, torch.float32)
    share = bound_ms / turns["device_ms"]
    log(f"softmax timing: wrapper {turns['ms']:.4f} ms, device one_read "
        f"{turns['device_ms']:.4f} ({share:.1%} of the bound) vs two_pass "
        f"{turns['device_ms_two_pass']:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.softmax {library_ms:.4f} ms (device "
        f"{library_device_ms:.4f}), x.clone() device {copy_device_ms:.4f} "
        f"ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "softmax", "route": "cuda",
            "source": tc.SOFTMAX_SOURCE, "replaces": tc.SOFTMAX_REPLACES,
            "max_abs_err": err, "ms": turns["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": "torch.softmax(x, -1)",
            **{key: t for key, t in turns.items() if key != "ms"},
            "library_device_ms": library_device_ms,
            "copy_device_ms": copy_device_ms,
            "device_share_of_bound": share, "timed_route": tc.ONE_READ,
            "launches_by_route": gate_routes,
            "check_launches_by_route": checked}


def pod_matmul_case(tc, gen) -> dict:
    """The pod's inline Pallas kernel (``pods/pallas-pod.yaml:28-35``):
    one 128 x 128 fp32 product, on the CUDA-core route as the gate's
    fp32 product runs. Held to the plain version and timed beside it and
    ``torch.mm``; returns the ``pod_*`` keys of the matmul row."""
    a = torch.randn((128, 128), generator=gen, device="cuda")
    b = torch.randn((128, 128), generator=gen, device="cuda")
    check(tc.matmul_route(a, b) == tc.CUDA_CORES,
          "matmul 128 x 128 fp32: not on the CUDA cores")
    want = tc.matmul_ref(a, b)
    err = float((tc.matmul(a, b) - want).abs().max())
    check(err <= MATMUL_REL_TOL * float(want.abs().max()),
          f"matmul 128 x 128 fp32: max_abs_err {err}")
    ms = time_ms(lambda: tc.matmul(a, b))
    plain_ms = time_ms(lambda: tc.matmul_ref(a, b))
    library_ms = time_ms(lambda: torch.mm(a, b))
    bound_ms, bound_by = bound(3 * 128 * 128 * 4, 2 * 128 ** 3,
                               torch.float32)
    log(f"matmul fp32 (128,128)@(128,128), the pod's kernel: max_abs_err "
        f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mm "
        f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    return {"pod_max_abs_err": err, "pod_ms": ms, "pod_plain_ms": plain_ms,
            "pod_library_ms": library_ms, "pod_bound_ms": bound_ms,
            "pod_bound_by": bound_by}


def toolchain_phase(tc) -> list:
    """``toolchain_smoke`` on the card with the three launch counters
    zeroed just before and read just after (each kernel exactly once:
    its rows' ``launches``; the fp32 matmul on the CUDA-core route,
    rms_norm and softmax on their new routes, vector and one_read).
    Then each kernel at flagship width on the same inputs as its plain
    version: matmul of the flagship's w_up product over one 8 x 1024
    training batch (bf16 (8192, 2048) @ (2048, 8192), fp32 out) and a
    bf16 (384, 640) @ (640, 896) the tensor-core tile does not divide,
    both on the tensor-core route, plus an fp32 case on the CUDA cores;
    rms_norm and softmax on the cases of ``rms_norm_cases`` and
    ``softmax_cases``. Each is timed beside its plain version and one
    PyTorch call, its two routes in turns."""
    zero_counts(tc.matmul, tc.rms_norm, tc.softmax)
    rep = tc.toolchain_smoke("cuda")
    launches = {"matmul": tc.matmul.launches,
                "rms_norm": tc.rms_norm.launches,
                "softmax": tc.softmax.launches}
    gate_routes = dict(tc.matmul.launches_by_route)
    log(f"toolchain_smoke: {rep}; launches {launches}")
    check(rep["ok"] and rep["interpret"] is False and rep["backend"] == "cuda",
          f"toolchain_smoke on the card: {rep}")
    check(all(n == 1 for n in launches.values()),
          f"toolchain_smoke launch counts {launches} (each kernel once)")
    # the gate's 256 x 256 fp32 product stays exact on the CUDA cores;
    # its (64, 128) fp32 rows take the row kernels' new routes
    check_routes("toolchain_smoke matmul", tc.matmul, 0, 1)
    check_routes("toolchain_smoke rms_norm", tc.rms_norm, 1, 0)
    check_routes("toolchain_smoke softmax", tc.softmax, 1, 0)
    gate_rows = {"rms_norm": dict(tc.rms_norm.launches_by_route),
                 "softmax": dict(tc.softmax.launches_by_route)}

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []

    # matmul: the fp32 case (CUDA cores), then the flagship bf16 product
    # and a bf16 shape the 128 x 256 tile does not divide (tensor cores)
    zero_counts(tc.matmul)
    a = torch.randn((1024, 2048), generator=gen, device="cuda")
    b = torch.randn((2048, 1024), generator=gen, device="cuda")
    want = tc.matmul_ref(a, b)
    fp32_err = float((tc.matmul(a, b) - want).abs().max())
    fp32_rel = fp32_err / float(want.abs().max())
    log(f"matmul fp32 (1024,2048)@(2048,1024): max_abs_err {fp32_err:.3e}, "
        f"relative to max |ref| {fp32_rel:.3e} (tolerance {MATMUL_REL_TOL})")
    check(math.isfinite(fp32_rel) and fp32_rel <= MATMUL_REL_TOL,
          f"matmul fp32: relative error {fp32_rel}")
    err = 0.0
    for (m, k, n) in ((384, 640, 896), (8192, 2048, 8192)):
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        got, want = tc.matmul(a, b), tc.matmul_ref(a, b)
        torch.cuda.synchronize()
        check(got.dtype == torch.float32 and got.shape == (m, n),
              f"matmul: output {got.dtype} {tuple(got.shape)}")
        case_err = float((got - want).abs().max())
        rel = case_err / float(want.abs().max())
        log(f"matmul bf16 ({m},{k})@({k},{n}): max_abs_err {case_err:.3e}, "
            f"relative to max |ref| {rel:.3e} (tolerance {MATMUL_REL_TOL})")
        check(math.isfinite(rel) and rel <= MATMUL_REL_TOL,
              f"matmul bf16 ({m},{k})@({k},{n}): relative error {rel}")
        err = max(err, case_err)
        del got, want
    check_routes("matmul at flagship width", tc.matmul, 2, 1)
    flagship_routes = dict(tc.matmul.launches_by_route)
    turns = time_routes(
        f"matmul bf16 ({m},{k})@({k},{n})", lambda: tc.matmul(a, b),
        lambda: tc._matmul_launch(a, b, tc.TENSOR_CORES),
        lambda: tc._matmul_launch(a, b, tc.CUDA_CORES))
    ms = turns["ms"]
    plain_ms = time_ms(lambda: tc.matmul_ref(a, b))
    library_bf16_out_ms = time_ms(lambda: torch.matmul(a, b))
    # the same function as the kernel (bf16 in, fp32 out) in one call
    library_ms = time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
    # A and B read once, C written once; 2 flops per multiply-add
    bound_ms, bound_by = bound(2 * (m * k + k * n) + 4 * m * n,
                               2 * m * k * n, torch.bfloat16)
    log(f"matmul timing: kernel {ms:.4f} ms ({2 * m * k * n / ms / 1e9:.1f} "
        f"TFLOP/s; entry points: tensor cores "
        f"{turns['ms_tensor_cores']:.4f}, CUDA cores "
        f"{turns['ms_cuda_cores']:.4f} ms), "
        f"plain (fp32 cuBLAS) {plain_ms:.4f} ms, torch.mm fp32 out "
        f"{library_ms:.4f} ms, torch.matmul bf16 out "
        f"{library_bf16_out_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    # the times are the tensor-core kernel's; the main path (the gate)
    # launches the CUDA-core one: no entry point of the port multiplies
    # bf16 through matmul yet
    rows.append({"name": "matmul", "route": "cuda",
                 "source": tc.MATMUL_SOURCE, "replaces": tc.MATMUL_REPLACES,
                 "max_abs_err": max(err, fp32_err), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 "library_call": "torch.mm(a, b, out_dtype=torch.float32) "
                                 "on the bf16 inputs",
                 **{key: x for key, x in turns.items() if key != "ms"},
                 "library_bf16_out_ms": library_bf16_out_ms,
                 "timed_route": "tensor_cores",
                 "launches_timed_route": gate_routes["tensor_cores"],
                 "launches_by_route": gate_routes,
                 "check_launches_by_route": flagship_routes,
                 **pod_matmul_case(tc, gen)})
    del a, b

    rows += [rms_norm_cases(tc, gen, gate_rows["rms_norm"]),
             softmax_cases(tc, gen, gate_rows["softmax"])]
    for row in rows:
        row["launches"] = launches[row["name"]]
    return rows


# ---------------------------------------------------------------------
# phase 8: the train-smoke command on the card


def train_smoke_phase(cli) -> None:
    """``python -m kind_tpu_sim_torch train-smoke --steps 10
    --checkpoint-dir <tmp> --json`` in this process, on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train-smoke", "--steps", "10", "--checkpoint-dir",
                           str(Path(tmp) / "ckpt"), "--json"])
        wall = time.perf_counter() - t0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"train-smoke: rc {rc} in {wall:.2f} s, report {report}")
    check(rc == 0 and report["ok"] is True and report["resume_ok"] is True,
          f"train-smoke: rc {rc}, report {report}")


# ---------------------------------------------------------------------


# ---------------------------------------------------------------------
# phases 9-10: the bench's model block and the profiler

MFU_RANGE = (0.0, 100.0)   # an MFU outside it is a measurement fault
ROOF_FRAC_MAX = 1.05       # a decode above its memory roofline is one too


# the bench's entries after its serving matrix, the kernels each must
# launch and the route (ISSUE 16's rows 4 and 7)
BENCH_ENTRY_ROUTES = {
    "paged_tier_micro": ("paged_attention",),
    "serving_realistic": ("flash_attention", "paged_attention"),
    "speculative": ("flash_attention",),
}
# paged_tier_micro runs each tier 4 times (a warm run that captures its
# graph, 3 timed replays), N chunks of ``chunk`` steps each
TIER_MICRO_RUNS = 4
# phase 9 runs the bench's model at the flagship's widths and 2 of its 8
# layers: nearly every section's time is its layers' (the full depth's
# numbers come from the bench's own run, ``bench --model-only``)
BENCH_LAYERS = 2


def _entry_launches(snaps, key) -> dict:
    """The launches by route during bench entry ``key``: the counts at
    the ``emit`` after it against those at the one before."""
    i = next(i for i, (keys, _) in enumerate(snaps) if key in keys)
    before = snaps[i - 1][1]
    return {name: {r: n - before[name].get(r, 0) for r, n in routes.items()}
            for name, routes in snaps[i][1].items()}


def bench_phase(bench, fa, pa, im) -> tuple:
    """Phase 9: the bench's model block at the flagship's widths and
    ``BENCH_LAYERS`` layers, its counts
    zeroed just before and read just after. Returns the launches by
    route of the counted kernels during the phase, and during each of
    the entries of ``BENCH_ENTRY_ROUTES`` (read at the bench's ``emit``
    after each section)."""
    from kind_tpu_sim_torch.ops._build import TENSOR_CORES

    counted = (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, pa.paged_attention,
               im.int8_matmul)
    snaps = []

    def emit(res):
        snaps.append((set(res), {fn.__name__: dict(fn.launches_by_route)
                                 for fn in counted}))

    zero_counts(*counted)
    model = bench.model_throughput(emit=emit, n_layers=BENCH_LAYERS)
    check(model_layers(model) == BENCH_LAYERS,
          f"bench: model {model.get('model')}, not {BENCH_LAYERS} layers")
    routes = {fn.__name__: dict(fn.launches_by_route) for fn in counted}
    log(json.dumps({"bench_headline": bench.headline_numbers(model)}))
    out = HERE / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_bench.json").write_text(json.dumps(
        {"model": model, "section_seconds": dict(bench.SECTION_S)}) + "\n")
    log(f"bench: sections {bench.SECTION_S}; busy % "
        f"{model.get('device_busy_pct')}; launches by route {routes}")
    errors = {k: v for k, v in model.items()
              if k.endswith("_error") or k == "error"}
    check(not errors, f"bench: errors {errors}")
    missing = [k for k in bench.REQUIRED_MODEL_KEYS if k not in model]
    for roof in ("decode_roofline", "decode_int8_roofline"):
        missing += [f"{roof}.{k}" for k in bench.REQUIRED_ROOFLINE_KEYS
                    if k not in model.get(roof, {})]
    check(not missing, f"bench: missing keys {missing}")
    for k, v in model.items():
        if k.endswith("_mfu_pct"):
            check(MFU_RANGE[0] < v <= MFU_RANGE[1],
                  f"bench: {k} = {v} outside (0, 100]")
    for roof in ("decode_roofline", "decode_int8_roofline"):
        frac = model[roof]["roof_frac"]
        check(frac <= ROOF_FRAC_MAX,
              f"bench: {roof}.roof_frac {frac} > {ROOF_FRAC_MAX}")
    check(model.get("decode_graph_check", {}).get("equal") is True,
          f"bench: graphed decode check {model.get('decode_graph_check')}")
    want = {"flash_attention": TENSOR_CORES,
            "flash_attention_bwd_dq": TENSOR_CORES,
            "flash_attention_bwd_dkv": TENSOR_CORES,
            "paged_attention": pa.SPLIT_KV}
    for name, route in want.items():
        check(routes[name].get(route, 0) > 0,
              f"bench: {name} never launched on {route}: {routes[name]}")
    for route in (im.GEMV, im.WGMMA):
        check(routes["int8_matmul"].get(route, 0) > 0,
              f"bench: int8_matmul never launched on {route}: "
              f"{routes['int8_matmul']}")

    # the entries after the serving matrix
    ptm, real, spec = (model["paged_tier_micro"], model["serving_realistic"],
                       model["speculative"])
    entry_routes = {key: _entry_launches(snaps, key)
                    for key in BENCH_ENTRY_ROUTES}
    log(f"bench paged_tier_micro (the two tiers' tokens equal, or the "
        f"entry errs): {json.dumps(ptm)}; launches "
        f"{entry_routes['paged_tier_micro']}")
    check(ptm["gather_over_kernel"] > 0,
          f"bench: paged_tier_micro {ptm}")
    want_paged = (TIER_MICRO_RUNS * model_layers(model)
                  * ptm["chunk"] * ptm["chained_chunks"])
    check(entry_routes["paged_tier_micro"]["paged_attention"]
          == {pa.SPLIT_KV: want_paged, pa.ONE_PASS: 0},
          f"bench: paged_tier_micro's kernel tier launches "
          f"{entry_routes['paged_tier_micro']['paged_attention']}, want "
          f"{want_paged} on {pa.SPLIT_KV}")
    log(f"bench serving_realistic: {json.dumps(real)}; launches "
        f"{entry_routes['serving_realistic']}")
    check(real["preemptions"] > 0
          and real["prefix_prefill_tokens_skipped"] > 0
          and real["requests"] == 64,
          f"bench: serving_realistic {real}")
    log(f"bench speculative: {json.dumps(spec)}; launches "
        f"{entry_routes['speculative']}")
    check(spec["tokens_per_step"] >= 1, f"bench: speculative {spec}")
    want_route = {"flash_attention": TENSOR_CORES,
                  "paged_attention": pa.SPLIT_KV}
    for key, kernels in BENCH_ENTRY_ROUTES.items():
        for name in kernels:
            got = entry_routes[key][name]
            check(got.get(want_route[name], 0) > 0
                  and sum(got.values()) == got[want_route[name]],
                  f"bench {key}: {name} launches {got}, want every one on "
                  f"{want_route[name]}")
    return routes, entry_routes


def model_layers(model) -> int:
    """The bench model's depth, from its name (``d2048xL8-gqa4``)."""
    return int(model["model"].split("xL")[1].split("-")[0])


def profile_phase(profiling, flagship) -> dict:
    """Phase 10: ``profile_flagship`` at the flagship config on the card;
    the trace's top ops must be the card's own events."""
    with tempfile.TemporaryDirectory() as tmp:
        report = profiling.profile_flagship(
            tmp, cfg=flagship.flagship_config())
        with gzip.open(report["summary"]["trace_file"], "rt") as fh:
            events = json.load(fh)["traceEvents"]
    device_names = {ev.get("name") for ev in events
                    if ev.get("cat") in profiling.DEVICE_CATEGORIES}
    summary = report["summary"]
    log(f"profile: {report['model']} one step in {report['wall_s']} s on "
        f"{report['device']}; device tracks {summary['device_tracks']}; "
        f"top ops {json.dumps(summary['top_ops'])}")
    check(summary["device_tracks"] is True,
          "profile: the trace has no device events")
    top = [op["name"] for op in summary["top_ops"]]
    check(top and all(n in device_names for n in top),
          f"profile: top ops that are not device events: "
          f"{[n for n in top if n not in device_names]}")
    return report


# ---------------------------------------------------------------------
# phase 11: the parallel layer (kind_tpu_sim_torch/parallel/)
#
# The machine has one card, and NCCL refuses two ranks on one card: the
# multi-rank checks run gloo ranks sharing the card (their collectives
# cross the host, so their times measure correctness, not tensor-parallel
# speed), and NCCL runs at world size 1, where a round's collectives are
# captured in its CUDA graph. The rank programs below are module-level:
# ``parallel.launch.spawn`` starts each rank with the spawn method, which
# imports them by name.

# tests/test_model.py:60-76's bar for a sharded loss against the unsharded
# one (rtol=2e-2)
TP_LOSS_RTOL = 2e-2
PARALLEL_TRAIN_STEPS = 3
PARALLEL_MOE_STEPS = 2
PARALLEL_TIMEOUT_S = 420
# the first-step logits of 4 prompts of 256 tokens, sharded against
# unsharded, judged against their largest magnitude: bf16 partial sums
# reduced across ranks round at other points than one product does
TP_LOGITS_REL_TOL = 2 * 2.4e-3
# the gloo serving worlds' depth: each round's collectives cross the host,
# so the worlds' walls scale with the layers
TP_SERVING_LAYERS = 2


# the collectives the port's gloo path runs on a card's tensors (each
# rank of phase 11's collectives world probes them), and the ones it
# avoids (a world of 2 ranks each: a refusal may abort the rank)
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather")
GLOO_CUDA_AVOIDED = ("all_to_all_single", "send/recv")
# a probe world's ranks start beside the collectives world's (~20 s
# together); a rank that aborts can leave its peer waiting until then
GLOO_PROBE_TIMEOUT_S = 45


def _gloo_cuda_op(op: str) -> str:
    """On the gloo ranks of the world, sharing the card: one collective
    on CUDA tensors (rank r holds r + 1), its result checked."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    want = [float(r + 1) for r in range(n)]
    x = torch.full((n,), float(rank + 1), device="cuda")
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = float(x[0]) == sum(want)
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        ok = float(x[0]) == 1.0
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        ok = [float(p[0]) for p in parts] == want
    elif op == "all_to_all_single":
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        ok = y.tolist() == want
    else:
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % n),
                dist.P2POp(dist.irecv, y, (rank - 1) % n)]):
            w.wait()
        ok = float(y[0]) == float((rank - 1) % n + 1)
    torch.cuda.synchronize()
    return "ran" if ok else "ran, wrong result"


def _collectives_rank() -> dict:
    """On 4 gloo ranks sharing the card: the smokes on ``slice_mesh``
    2x2 and the two-tier psum on ``multislice_mesh(2, 1, 2)`` (on CUDA
    tensors, the ring's point-to-point step on the host), and the
    collectives of ``GLOO_CUDA_OPS`` on CUDA tensors."""
    from kind_tpu_sim_torch.parallel import collectives, mesh

    s = mesh.slice_mesh(mesh.make_slice(topology="2x2"))
    return {"run_all": collectives.run_all(s),
            "hierarchical": collectives.hierarchical_psum_smoke(
                mesh.multislice_mesh(2, 1, 2)),
            "gloo_cuda_ops": {op: _gloo_cuda_op(op) for op in GLOO_CUDA_OPS}}


def gloo_collectives(launch) -> tuple:
    """The 4-rank collectives world, and beside it a 2-rank world for
    each collective of ``GLOO_CUDA_AVOIDED``, all at once (a store
    each). Returns (the collectives world's report, {avoided op: "ran"
    or how it was refused})."""
    def probe(op):
        try:
            return launch.spawn(_gloo_cuda_op, 2, op, backend="gloo",
                                device="cuda", timeout_s=GLOO_PROBE_TIMEOUT_S)
        except Exception as exc:  # the probe's answer, recorded and shown
            return (f"refused: {type(exc).__name__}: "
                    f"{str(exc).splitlines()[0][:160]}")

    with ThreadPoolExecutor(1 + len(GLOO_CUDA_AVOIDED)) as pool:
        world = pool.submit(launch.spawn, _collectives_rank, 4,
                            backend="gloo", device="cuda",
                            timeout_s=PARALLEL_TIMEOUT_S)
        avoided = dict(zip(GLOO_CUDA_AVOIDED,
                           pool.map(probe, GLOO_CUDA_AVOIDED)))
        return world.result(), avoided


def _rank_reports(value) -> list:
    """Every rank's ``value``, in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _dense_serving(flagship, serving):
    return serving.ServingConfig(max_slots=flagship.SLOTS, max_len=1024,
                                 chunk=flagship.CHUNK)


def _logit_prompts(cfg):
    gen = torch.Generator(device="cuda").manual_seed(5)
    return torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                         device="cuda")


def _serve_rank(shape, names, paged: bool, n_layers: int) -> dict:
    """On every rank of ``Mesh(shape, names)`` (gloo, the card shared):
    the flagship's bf16 snapshot at ``n_layers`` of its layers, phase
    4's stream through the dense
    engine (or the paged gather tier), the first-step logits of 4
    prompts of 256 tokens, and this rank's kernel launches and peak
    memory."""
    from kind_tpu_sim_torch import profile_serving as flagship
    from kind_tpu_sim_torch.models import serving
    from kind_tpu_sim_torch.models import transformer as tf
    from kind_tpu_sim_torch.ops import flash_attention as fa
    from kind_tpu_sim_torch.ops import paged_attention as pa
    from kind_tpu_sim_torch.parallel import mesh as mesh_lib
    from kind_tpu_sim_torch.parallel import tp

    mesh = mesh_lib.Mesh(shape, names)
    cfg = dataclasses.replace(flagship.flagship_config(), n_layers=n_layers)
    sp = flagship.flagship_params(cfg)
    sc = (flagship.flagship_serving(paged_kernel=False) if paged
          else _dense_serving(flagship, serving))
    engine = serving.PagedServingEngine if paged else serving.ServingEngine
    reqs = flagship.flagship_requests(cfg.vocab_size)
    eng = engine(sp, cfg, sc, device="cuda", mesh=mesh)
    del sp
    torch.cuda.empty_cache()
    # the serving peak: this rank's shards, storage and rounds
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa.flash_attention, pa.paged_attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    done = {c.request_id: c.tokens for c in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_by_route": dict(fa.flash_attention.launches_by_route),
                "paged": pa.paged_attention.launches}
    prompts = tf.shard_batch(_logit_prompts(cfg), mesh)
    with torch.no_grad(), tp.scope(eng._shards._replace(
            data=tp.axis(mesh, "dcn", "data"))):
        logits = tf._forward(eng.params, prompts, cfg)[0][:, -1].float()
    data = tp.axis(mesh, "dcn", "data")
    if data is not None:
        logits = tp.all_gather(logits, data, 0)
    rep = eng.report()
    return {"streams": done, "wall_s": wall, "logits": logits.cpu(),
            "report": {k: rep[k] for k in ("mesh", "prefill_dispatches",
                                           "decode_rounds")},
            "ranks": _rank_reports({
                **launches,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})}


def _train_rank(shape, names, n_experts: int, steps: int,
                batch: int) -> dict:
    """On every rank of ``Mesh(shape, names)``: the flagship's train
    step (fp32 parameters from seed 0, AdamW) sharded, ``steps`` steps
    of ``batch`` x 1025 tokens from seed 1, each rank feeding its rows.
    Returns the losses, and each rank's step walls, flash launches by
    route and peak memory."""
    from kind_tpu_sim_torch import profile_train as trainer
    from kind_tpu_sim_torch.ops import flash_attention as fa
    from kind_tpu_sim_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.Mesh(shape, names)
    cfg = dataclasses.replace(trainer.flagship_config(), n_experts=n_experts)
    tf = trainer.tf
    step, init = tf.make_train_step(cfg, mesh=mesh,
                                    learning_rate=trainer.LEARNING_RATE,
                                    device="cuda")
    state = init(torch.Generator(device="cuda").manual_seed(0))
    batches = _train_batches(tf, cfg, steps, batch)
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    zero_counts(*kernels)
    losses, walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tf.shard_batch(b, mesh))
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "ranks": _rank_reports({
        "walls_ms": walls,
        "launches_by_route": {k.__name__: dict(k.launches_by_route)
                              for k in kernels},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30})}


def _train_batches(tf, cfg, steps: int, batch: int, seq: int = 1025):
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [tf.sample_batch(gen, cfg, batch, seq, device="cuda")
            for _ in range(steps)]


def _plain_train(tf, trainer, n_experts: int, steps: int, batch: int,
                 seq: int = 1025):
    """The unsharded step on the same parameters and batches (of
    ``seq`` tokens): (losses, peak GiB above what this process held
    before the state was made)."""
    cfg = dataclasses.replace(trainer.flagship_config(), n_experts=n_experts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step, init = tf.make_train_step(cfg, learning_rate=trainer.LEARNING_RATE,
                                    device="cuda")
    state = init(torch.Generator(device="cuda").manual_seed(0))
    losses = []
    for b in _train_batches(tf, cfg, steps, batch, seq):
        state, loss = step(state, b)
        losses.append(float(loss))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    # the compiled step's graph (and its pool) go with it
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, peak


def _hold_losses(name: str, got, want) -> float:
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    log(f"{name}: losses {got} against unsharded {want}; largest relative "
        f"gap {gap:.3e} (bar rtol {TP_LOSS_RTOL})")
    check(all(math.isfinite(x) for x in got), f"{name}: non-finite loss")
    check(gap <= TP_LOSS_RTOL, f"{name}: relative gap {gap} > {TP_LOSS_RTOL}")
    return gap


def _sharded_flash(fa, gen, b, t, h, kv) -> dict:
    """The flash forward and (t = 1024) backward at one rank's heads,
    each against its plain version and timed as phase 2 times them."""
    d = 128
    q, k, v = _fused_qkv(gen, b, t, h, kv, d)
    name = f"({b},{t},{h}/{kv},{d})"
    zero_counts(fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    check_routes(f"flash_attention {name}", fa.flash_attention, 1, 0)
    qf, kf, vf = q.float(), k.float(), v.float()
    out_ref, lse_ref = fa.flash_attention_ref(qf, kf, vf, True,
                                              return_lse=True)
    err = float((out.float() - out_ref).abs().max())
    log(f"flash_attention {name} causal: max_abs_err {err:.3e} (tolerance "
        f"{FLASH_TOL})")
    check(math.isfinite(err) and err <= FLASH_TOL,
          f"flash_attention {name}: max_abs_err {err}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = b * h * t * (t + 1) // 2
    qn, kn, rows = q.numel(), k.numel(), b * h * t
    fwd_bound = bound(2 * (qn + 2 * kn + qn), 2 * 2 * pairs * d,
                      torch.bfloat16)
    row = {"launches": 1, "max_abs_err": err,
           "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
           "plain_ms": time_ms(lambda: fa.flash_attention_ref(
               q, k, v, causal=True)),
           "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)),
           "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]}
    if t < 1024:
        return {"forward": row}
    g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, g, True)
    check_routes(f"flash backward dq {name}", fa.flash_attention_bwd_dq, 1, 0)
    check_routes(f"flash backward dk/dv {name}", fa.flash_attention_bwd_dkv,
                 1, 0)
    ref = fa.flash_attention_bwd_ref(qf, kf, vf, out_ref, lse_ref, g.float(),
                                     True)
    errs = _bwd_errors(name, (dq, dk, dv), ref, BWD_REL_TOL)
    args = (q, k, v, out, lse, g)
    dq_bound = bound(2 * (qn + 2 * kn + qn) + 4 * 2 * rows + 2 * qn,
                     3 * 2 * pairs * d, torch.bfloat16)
    dkv_bound = bound(2 * (qn + 2 * kn + qn) + 4 * 2 * rows + 2 * 2 * kn,
                      4 * 2 * pairs * d, torch.bfloat16)
    res = {"forward": row}
    for key, wrapper, plain, bnd in (
            ("dq", fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_ref,
             dq_bound),
            ("dkv", fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_ref, dkv_bound)):
        res[key] = {"launches": 1, "max_abs_err": errs[key],
                    "ms": time_ms(lambda w=wrapper: w(*args)),
                    "plain_ms": time_ms(lambda p=plain: p(*args)),
                    "library_ms": None, "bound_ms": bnd[0],
                    "bound_by": bnd[1]}
    log(f"sharded flash {name}: {res}")
    return res


def _sharded_int8(im, gen) -> dict:
    """The int8 cache's score and value products at one rank's 2 of 4
    KV heads (batch 8, 1536 positions), bitwise against the plain
    version, timed beside it."""
    def r8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    k_cache, v_cache = r8(8, 1536, 2, 128), r8(8, 1536, 2, 128)
    cases = {"cache_scores": (r8(8, 2, 4, 128), k_cache.permute(0, 2, 3, 1)),
             "cache_values": (r8(8, 2, 4, 1536), v_cache.permute(0, 2, 1, 3))}
    out = {}
    for name, (a, b) in cases.items():
        zero_counts(im.int8_matmul)
        got = im.int8_matmul(a, b)
        want = im.int8_matmul_ref(a, b)
        check(torch.equal(got, want) and im.int8_matmul.launches == 1,
              f"int8_matmul {name} at kv 2: differs from its plain version")
        batch = a.numel() // (a.shape[-2] * a.shape[-1])
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        bnd = bound(a.numel() + b.numel() + 4 * batch * m * n,
                    2 * batch * m * n * k, torch.int8)
        out[name] = {"launches": 1, "max_abs_err": 0.0,
                     "route": im.int8_route(a, b),
                     "ms": time_ms(lambda: im.int8_matmul(a, b)),
                     "plain_ms": time_ms(lambda: im.int8_matmul_ref(a, b)),
                     "library_ms": None, "bound_ms": bnd[0],
                     "bound_by": bnd[1]}
        log(f"int8_matmul {name} at kv 2 (bitwise equal): {out[name]}")
    return out


def parallel_phase(flagship, trainer, serving, tf, fa, pa, im, sp,
                   cfg) -> dict:
    """(a) the collective smokes at world size 1 on NCCL and on 4 gloo
    ranks, and which gloo collectives take CUDA tensors; (b) the
    flagship at ``TP_SERVING_LAYERS`` of its layers served
    tensor-parallel: the dense engine at (data 2, model 2) and ('model',
    4), the paged gather tier at ('model', 2), each held to the unsharded
    engine's streams by the split rule, then the dense engine on an
    NCCL mesh of world size 1, its rounds CUDA graphs with the
    collectives captured, bitwise against the unsharded graphed engine;
    (c), (d) ``training_worlds_phase``; (e) the flash and int8 kernels at
    the sharded shapes. Independent worlds run at once: (a)'s, (b)'s."""
    from kind_tpu_sim_torch.parallel import collectives, launch
    from kind_tpu_sim_torch.parallel import mesh as mesh_lib

    out = {}
    # (a)
    t_part = time.perf_counter()
    with launch.process_group("nccl"):
        one = mesh_lib.slice_mesh(mesh_lib.make_slice(topology="1x1"))
        nccl = {"run_all": collectives.run_all(one),
                "hierarchical": collectives.hierarchical_psum_smoke(
                    mesh_lib.multislice_mesh(1, 1, 1))}
    gloo, avoided = gloo_collectives(launch)
    for where, rep in (("nccl world 1", nccl),
                       ("gloo world 4 on CUDA tensors", gloo)):
        log(f"collectives ({where}): {json.dumps(rep)}")
        check(rep["run_all"]["ok"] and rep["hierarchical"]["ok"],
              f"collective smokes failed on {where}")
    out["gloo_cuda_ops"] = {**gloo["gloo_cuda_ops"], **avoided}
    log(f"gloo collectives on CUDA tensors: {out['gloo_cuda_ops']}")
    check(all(gloo["gloo_cuda_ops"][op] == "ran" for op in GLOO_CUDA_OPS),
          f"gloo refused one of {GLOO_CUDA_OPS} on CUDA tensors")
    log(f"parallel (a): {time.perf_counter() - t_part:.1f} s")

    # (b) at TP_SERVING_LAYERS: held to the unsharded engine at that depth,
    # which runs here while the worlds run
    tcfg = dataclasses.replace(cfg, n_layers=TP_SERVING_LAYERS)
    reqs = flagship.flagship_requests(cfg.vocab_size)
    prompts = {r.request_id: r.prompt for r in reqs}
    out["serving"] = {}
    cases = (("dense (data 2, model 2)", (2, 2), ("data", "model"), False),
             ("dense ('model', 4)", (4,), ("model",), False),
             ("paged gather ('model', 2)", (2,), ("model",), True))

    def world(case):
        _, shape, names, paged = case
        return launch.spawn(_serve_rank, int(np.prod(shape)), shape, names,
                            paged, TP_SERVING_LAYERS, backend="gloo",
                            device="cuda", timeout_s=PARALLEL_TIMEOUT_S)

    # the worlds are independent (a store each) and bound by their hosts'
    # gloo transport, not by the card: all at once
    t_part = time.perf_counter()
    with ThreadPoolExecutor(len(cases)) as pool:
        running = [pool.submit(world, case) for case in cases]
        tsp = flagship.flagship_params(tcfg)
        ref = serving.ServingEngine(tsp, tcfg,
                                    _dense_serving(flagship, serving),
                                    device="cuda")
        for r in reqs:
            ref.submit(dataclasses.replace(r))
        tstreams = {c.request_id: c.tokens for c in ref.run()}
        del ref
        with torch.no_grad():
            want_logits = tf.forward(tsp, _logit_prompts(tcfg),
                                     tcfg)[:, -1].float()
        results = [f.result() for f in running]
    log(f"parallel (b) the three gloo serving worlds at once, "
        f"{TP_SERVING_LAYERS} of {cfg.n_layers} layers: "
        f"{time.perf_counter() - t_part:.1f} s")
    for (label, *_), res in zip(cases, results):
        splits = hold_streams(f"tensor-parallel serving {label}", tf, tsp,
                              tcfg, prompts, res["streams"], tstreams)
        diff = float((res["logits"].cuda() - want_logits).abs().max())
        rel = diff / float(want_logits.abs().max())
        log(f"tensor-parallel serving {label}: first-step logits' largest "
            f"difference {diff:.4e} ({rel:.3e} of the largest; bar "
            f"{TP_LOGITS_REL_TOL:.1e}); {res['report']}; per rank "
            f"{res['ranks']}; stream wall {res['wall_s']:.2f} s on gloo "
            "ranks sharing one card beside the other worlds (a correctness "
            "rig, not a speed)")
        check(rel <= TP_LOGITS_REL_TOL,
              f"tensor-parallel serving {label}: logits {rel}")
        check(res["report"]["mesh"]["rounds"] == "eager",
              f"{label}: gloo rounds should run eagerly")
        for r in res["ranks"]:
            check(r["paged"] == 0, f"{label}: paged kernel launched")
            check(r["flash_by_route"]["tensor_cores"] > 0
                  and r["flash_by_route"]["cuda_cores"] == 0,
                  f"{label}: flash launches by route {r['flash_by_route']}")
        out["serving"][label] = {
            "splits": splits, "logits_rel": rel, "wall_s": res["wall_s"],
            "layers": TP_SERVING_LAYERS, "ranks": res["ranks"],
            "report": res["report"]}
    del tsp
    torch.cuda.empty_cache()

    # (b) NCCL at world size 1: the graphed rounds with their collectives
    sc = _dense_serving(flagship, serving)

    def graphed(mesh):
        eng = serving.ServingEngine(sp, cfg, sc, device="cuda", mesh=mesh)
        for r in reqs[:1]:
            eng.submit(dataclasses.replace(r, request_id="warm", max_new=65,
                                           logprobs=True))
        eng.run()
        torch.cuda.synchronize()
        warm_rounds = eng.decode_rounds
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(dataclasses.replace(r, logprobs=True))
        done = {c.request_id: c for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, done, wall, eng.decode_rounds - warm_rounds

    t_part = time.perf_counter()
    plain_eng, plain, plain_wall, plain_rounds = graphed(None)
    with launch.process_group("nccl"):
        mesh_eng, meshed, mesh_wall, rounds = graphed(
            mesh_lib.training_mesh(1, 1))
        mesh_rep = mesh_eng.report()
        captured = mesh_eng._round.captured
        del mesh_eng
        out["nccl_world1_training"] = nccl_train_twins(
            tf, trainer, mesh_lib.training_mesh(1, 1))
    same = all(plain[rid].tokens == meshed[rid].tokens
               and plain[rid].logprobs == meshed[rid].logprobs
               for rid in plain)
    tokens = sum(len(c.tokens) for c in plain.values())
    log(f"NCCL world 1 graphed serving: {mesh_rep['mesh']}, {captured} "
        f"graphs; streams and logprobs bitwise equal to the unsharded "
        f"graphed engine: {same}; stream wall {mesh_wall:.3f} s "
        f"({tokens / mesh_wall:.1f} tok/s, {mesh_wall / rounds * 1e3:.2f} ms "
        f"of wall a round over {rounds} rounds, admission included) against "
        f"{plain_wall:.3f} s ({tokens / plain_wall:.1f} tok/s, "
        f"{plain_wall / plain_rounds * 1e3:.2f} ms) unsharded")
    check(mesh_rep["mesh"]["rounds"] == "graphs" and captured > 0,
          "NCCL mesh rounds are not graphs")
    check(same, "NCCL world 1 graphed streams differ from unsharded")
    out["nccl_world1"] = {"wall_s": mesh_wall, "plain_wall_s": plain_wall,
                          "round_ms": mesh_wall / rounds * 1e3,
                          "plain_round_ms": plain_wall / plain_rounds * 1e3,
                          "tok_per_s": tokens / mesh_wall,
                          "plain_tok_per_s": tokens / plain_wall}
    del plain_eng
    torch.cuda.empty_cache()
    log(f"parallel (b) NCCL world 1: {time.perf_counter() - t_part:.1f} s")

    out["training"] = training_worlds_phase(tf, trainer)

    # (e)
    gen = torch.Generator(device="cuda").manual_seed(21)
    out["kernels"] = {
        "train (8,1024) 8/2 heads": _sharded_flash(fa, gen, 8, 1024, 8, 2),
        "train (8,1024) 4/1 heads": _sharded_flash(fa, gen, 8, 1024, 4, 1),
        "admission (8,256) 8/2 heads": _sharded_flash(fa, gen, 8, 256, 8, 2),
        "int8 cache kv 2": _sharded_int8(im, gen)}
    return out


NCCL_TRAIN_STEPS, NCCL_TRAIN_BATCH = 3, 2


def nccl_train_twins(tf, trainer, mesh) -> dict:
    """``NCCL_TRAIN_STEPS`` AdamW steps of the flagship (batches of
    ``NCCL_TRAIN_BATCH`` x 1025 tokens, seed-0 parameters) on ``mesh``,
    an NCCL mesh of world size 1: compiled (the first step eager, the
    graph with its collectives replayed after) against the same steps
    with the step's runner rebound to ``graphs.eager``. Losses and final
    parameters bitwise equal."""
    from kind_tpu_sim_torch.models import graphs

    cfg = trainer.flagship_config()
    batches = _train_batches(tf, cfg, NCCL_TRAIN_STEPS, NCCL_TRAIN_BATCH)
    runs = {}
    for path in ("graph", "eager"):
        step, init = tf.make_train_step(
            cfg, mesh=mesh, learning_rate=trainer.LEARNING_RATE,
            device="cuda")
        check(isinstance(step._round, graphs.RoundGraphs),
              f"NCCL world 1 training: the step runs through {step._round!r}")
        if path == "eager":
            step._round = graphs.eager
        state = init(torch.Generator(device="cuda").manual_seed(0))
        losses, walls = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, tf.shard_batch(b, mesh))
            losses.append(float(loss))
            walls.append((time.perf_counter() - t0) * 1e3)
        runs[path] = {"losses": losses, "walls_ms": walls, "params": [
            p.detach().clone() for p in tf._leaves(state["params"])]}
        if path == "graph":
            runs[path]["graphs"] = step._round.captured
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(runs["graph"].pop("params"),
                                                 runs["eager"].pop("params")))
    log(f"NCCL world 1 training: {NCCL_TRAIN_STEPS} steps compiled "
        f"({runs['graph']['graphs']} graph, walls ms "
        f"{[round(w, 1) for w in runs['graph']['walls_ms']]}) against eager "
        f"(walls ms {[round(w, 1) for w in runs['eager']['walls_ms']]}): "
        f"losses {runs['graph']['losses']} / {runs['eager']['losses']}, "
        f"parameters bitwise equal: {same}")
    check(runs["graph"]["losses"] == runs["eager"]["losses"] and same,
          "NCCL world 1 training: the compiled steps differ from the eager "
          "ones")
    return runs


def training_worlds_phase(tf, trainer) -> dict:
    """Phase 11 (c): flagship training at ('model', 2) and ('data', 2),
    and (d): the 4-expert flagship at ('expert', 2), each against
    unsharded steps on the same parameters and batches (losses within
    ``TP_LOSS_RTOL``; every flash launch a rank on the tensor cores).
    Each model's unsharded steps run first, then its worlds; the two
    dense worlds at once (their ranks fit the card together, the MoE
    world's beside them would not)."""
    from kind_tpu_sim_torch.parallel import launch

    out = {}
    batch = trainer.BATCH
    trained = {}
    for group in (
            (("('model', 2)", 0, (2,), ("model",), PARALLEL_TRAIN_STEPS),
             ("('data', 2)", 0, (2,), ("data",), PARALLEL_TRAIN_STEPS)),
            (("MoE ('expert', 2)", MOE_EXPERTS, (2,), ("expert",),
              PARALLEL_MOE_STEPS),)):
        t_part = time.perf_counter()
        _, experts, _, _, steps = group[0]
        unsharded = _plain_train(tf, trainer, experts, steps, batch)
        with ThreadPoolExecutor(len(group)) as pool:
            worlds = [pool.submit(
                launch.spawn, _train_rank, 2, shape, names, experts, steps,
                batch, backend="gloo", device="cuda",
                timeout_s=PARALLEL_TIMEOUT_S)
                for _, _, shape, names, _ in group]
            results = [w.result() for w in worlds]
        wall = time.perf_counter() - t_part
        for (label, *_), res in zip(group, results):
            trained[label] = (res, unsharded, wall)
        log(f"parallel {' and '.join(g[0] for g in group)}: unsharded steps "
            f"and world{'s at once' if len(group) > 1 else ''} {wall:.1f} s")
    for label, (res, (want, plain_peak), wall) in trained.items():
        steps = len(want)
        gap = _hold_losses(f"sharded training {label}", res["losses"], want)
        log(f"sharded training {label}: per rank {res['ranks']}; unsharded "
            f"peak {plain_peak:.2f} GiB (gloo ranks sharing one card: step "
            "walls are a correctness rig's)")
        for r in res["ranks"]:
            for kname, routes in r["launches_by_route"].items():
                check(routes["cuda_cores"] == 0 and
                      routes["tensor_cores"] == 8 * steps,
                      f"sharded training {label}: {kname} {routes}")
        out[label] = {"gap": gap, "losses": res["losses"],
                      "unsharded": want, "ranks": res["ranks"],
                      "unsharded_peak_gib": plain_peak, "group_wall_s": wall}
    return out


# ---------------------------------------------------------------------
# phase 12: long context, pipeline, multi-host (gloo ranks sharing the
# one card, as phase 11's). A ring step's K/V block and a pipeline
# hand-off cross gloo through the host (gloo's send of a card's tensor
# aborts the rank, phase 11); their times measure correctness, not
# speed across cards.

# the flagship's attention: batch 8, 1024 positions, 16 query heads over
# 4 KV heads of 128
RING_SHAPE = (8, 1024, 16, 4, 128)
RING_WORLDS = (2, 4)
RING_TOL = FLASH_TOL   # the ring keeps P in fp32; plain rounds it to bf16
# the ring splits the whole sequence (the reference's ring loss runs the
# full length), so its batches are 1024 tokens, which divide over 'seq'
SEQ_LEN = 1024
SEQ_TRAIN_STEPS = 3
PIPELINE_MESHES = (((4,), ("stage",)), ((2, 2), ("data", "stage")))
# the reference's slice smokes as a user runs them, and what its tests
# assert of each (tests/test_multihost_slice.py, tests/test_profiling.py)
SLICE_SMOKES = (
    ("2x2x2 v4, 32768-token ring",
     ("--topology", "2x2x2", "--accelerator", "tpu-v4-podslice",
      "--ring-tokens", "32768"),
     {"workers": 2, "process_count": 2, "local_devices": 4,
      "global_devices": 8, "ring_tokens": 32768, "ring_devices": 8}),
    ("v5e-16", ("--topology", "4x4", "--accelerator",
                "tpu-v5-lite-podslice"),
     {"workers": 2, "process_count": 2, "local_devices": 8,
      "global_devices": 16, "psum_total": 8 * (1 + 2)}),
    ("2x2 v5e with serving",
     ("--topology", "2x2", "--accelerator", "tpu-v5-lite-podslice",
      "--serving"),
     {"workers": 1, "process_count": 1, "local_devices": 4,
      "global_devices": 4}),
    ("2 slices of 2x2x2 v4",
     ("--num-slices", "2", "--topology", "2x2x2", "--accelerator",
      "tpu-v4-podslice"),
     {"workers": 4, "process_count": 2, "local_devices": 4,
      "global_devices": 8}))
SLICE_TIMEOUT_S = 600
SLICE_SMOKES_AT_ONCE = 4


def _cuda_sync_barrier() -> None:
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()


def _ring_rank() -> dict:
    """On every rank of a ('seq', n) world sharing the card: ring
    attention at the flagship's attention shape (bf16, causal), both
    orderings, against the port's plain attention over the whole
    sequence; the wall of one call of each (median of 5, every rank
    synchronised); with 4 ranks also ``bench_report``."""
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel import ring_attention as ra
    from kind_tpu_sim_torch.parallel import tp
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    n = dist.get_world_size()
    mesh = Mesh((n,), ("seq",))
    ax = tp.axis(mesh, "seq")
    b, t, h, kv, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, k, v = (torch.randn(b, t, heads, d, generator=gen, device="cuda")
               .bfloat16() for heads in (h, kv, kv))
    spec = (None, "seq", None, None)
    with torch.no_grad():
        want = tp.shard_tensor(ra.reference_attention(q, k, v), spec, mesh)
        plain_ms = time_ms(lambda: ra.reference_attention(q, k, v), reps=5,
                           warmup=1)
    lq, lk, lv = (tp.shard_tensor(x, spec, mesh) for x in (q, k, v))
    del q, k, v
    out = {"plain_ms": plain_ms,
           "rotation_bytes": 2 * b * (t // n) * kv * d * 2}
    for name, db in (("double_buffered", True), ("serial", False)):
        walls = []
        with torch.no_grad():
            for _ in range(6):
                _cuda_sync_barrier()
                t0 = time.perf_counter()
                got = ra.ring_attention(lq, lk, lv, mesh, "seq",
                                        double_buffer=db)
                _cuda_sync_barrier()
                walls.append((time.perf_counter() - t0) * 1e3)
        err = (got.float() - want.float()).abs().max()
        out[name] = {"max_abs_err": float(tp.all_reduce(err[None], ax,
                                                        "max")[0]),
                     "wall_ms": float(np.median(walls[1:]))}
    if n == 4:
        out["bench_report"] = ra.bench_report()
    return {"report": out, "ranks": _rank_reports(
        {"peak_gib": torch.cuda.max_memory_allocated() / 2**30})}


def _seq_train_rank(steps: int, batch: int) -> dict:
    """On the 2 ranks of ('seq', 2) sharing the card: ``steps`` AdamW
    steps of the flagship with ``seq_parallel`` (the ring), each rank
    feeding its columns of ``batch`` x 1024 tokens (seed 0 parameters,
    seed 1 batches, as ``_plain_train``); then the dense config (flash,
    no ring: attention over the gathered sequence) on the same mesh:
    its first-batch logits against the unsharded forward on this rank,
    and one train step, each with its flash launches."""
    from kind_tpu_sim_torch import profile_train as trainer
    from kind_tpu_sim_torch.ops import flash_attention as fa
    from kind_tpu_sim_torch.parallel import mesh as mesh_lib
    from kind_tpu_sim_torch.parallel import tp

    tf = trainer.tf
    mesh = mesh_lib.Mesh((2,), ("seq",))
    ax = tp.axis(mesh, "seq")
    dense = trainer.flagship_config()
    ring = dataclasses.replace(dense, seq_parallel=True)
    batches = _train_batches(tf, dense, steps, batch, SEQ_LEN)
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    step, init = tf.make_train_step(ring, mesh=mesh,
                                    learning_rate=trainer.LEARNING_RATE,
                                    device="cuda")
    state = init(torch.Generator(device="cuda").manual_seed(0))
    zero_counts(*kernels)
    losses, walls = [], []
    for tokens in batches:
        _cuda_sync_barrier()
        t0 = time.perf_counter()
        state, loss = step(state, tf.shard_batch(tokens, mesh))
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
    out["ring"] = {"losses": losses, "walls_ms": walls,
                   "flash_launches": {k.__name__: k.launches
                                      for k in kernels}}
    ring_peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step, init
    torch.cuda.empty_cache()

    params = tf.init_params(dense, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    rows = tf.shard_batch(batches[0], mesh)
    lo = ax.index * rows.shape[1]
    zero_counts(*kernels)
    with torch.no_grad():
        got = tf.forward(params, rows, dense, mesh=mesh)
        fwd_routes = dict(fa.flash_attention.launches_by_route)
        want = tf.forward(params, batches[0], dense)[:, lo:lo + rows.shape[1]]
    diff = tp.all_reduce((got - want).abs().max()[None], ax, "max")
    big = tp.all_reduce(want.abs().max()[None], ax, "max")
    del got, want
    torch.cuda.empty_cache()
    step, init = tf.make_train_step(dense, mesh=mesh,
                                    learning_rate=trainer.LEARNING_RATE,
                                    device="cuda")
    state = init(params)
    zero_counts(*kernels)
    state, loss = step(state, rows)
    out["gathered"] = {
        "logits_diff": float(diff[0]), "logits_max": float(big[0]),
        "forward_launches_by_route": fwd_routes,
        "train_loss": float(loss),
        "train_launches_by_route": {k.__name__: dict(k.launches_by_route)
                                    for k in kernels}}
    return {"report": out, "ranks": _rank_reports({
        "ring_peak_gib": ring_peak,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30})}


def _pipeline_rank() -> dict:
    """On 4 ranks sharing the card: the flagship's bf16 snapshot forward
    over (8, 1024) tokens pipelined over ('stage', 4) and over ('data',
    2, 'stage', 2), each against the unsharded forward on this rank,
    with the flash forward's launches a rank (its microbatch shape)."""
    from kind_tpu_sim_torch import profile_serving as flagship
    from kind_tpu_sim_torch.models import transformer as tf
    from kind_tpu_sim_torch.ops import flash_attention as fa
    from kind_tpu_sim_torch.parallel import mesh as mesh_lib
    from kind_tpu_sim_torch.parallel import pipeline, tp

    cfg = flagship.flagship_config()
    params = flagship.flagship_params(cfg)
    gen = torch.Generator(device="cuda").manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, (8, SEQ_LEN), generator=gen,
                           device="cuda")
    with torch.no_grad():
        want = tf.forward(params, tokens, cfg)
    out = {"logits_max": float(want.abs().max())}
    for shape, names in PIPELINE_MESHES:
        mesh = mesh_lib.Mesh(shape, names)
        world = tp.axis(mesh, *names)
        stages = mesh.shape["stage"]
        stacked = pipeline.stack_stage_params(params, stages)
        zero_counts(fa.flash_attention)
        _cuda_sync_barrier()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = pipeline.pipeline_forward(params, tokens, cfg, mesh,
                                            stacked_params=stacked)
        _cuda_sync_barrier()
        wall = (time.perf_counter() - t0) * 1e3
        routes = dict(fa.flash_attention.launches_by_route)
        diff = tp.all_reduce((got - want).abs().max()[None], world, "max")
        micro = stages
        out[str(dict(mesh.shape))] = {
            "logits_diff": float(diff[0]), "wall_ms": wall,
            "microbatch": [8 // micro // mesh.shape.get("data", 1), SEQ_LEN],
            "expected_launches": (micro + stages - 1)
            * cfg.n_layers // stages,
            "ranks": _rank_reports(routes)}
        del got, stacked
    return {"report": out, "ranks": _rank_reports(
        {"peak_gib": torch.cuda.max_memory_allocated() / 2**30})}


def _slice_smoke_cli(argv) -> dict:
    """``python -m kind_tpu_sim_torch slice-smoke ... --json`` on the
    card, as a user runs it: its report and wall time."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "kind_tpu_sim_torch", "slice-smoke", *argv,
         "--json", "--device", "cuda"], cwd=HERE, capture_output=True,
        text=True, timeout=SLICE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode not in (0, 1) or not lines:
        fail(f"slice-smoke {' '.join(argv)} exited {res.returncode}:\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return {"rc": res.returncode, "wall_s": wall,
            "report": json.loads(lines[-1])}


def _hold_slice(label: str, res: dict, want: dict) -> None:
    rep = res["report"]
    workers = rep["workers"]
    log(f"slice-smoke {label}: rc {res['rc']}, {res['wall_s']:.1f} s; "
        f"{json.dumps(rep)[:3000]}")
    check(res["rc"] == 0 and rep["ok"], f"slice-smoke {label} not ok")
    check(len(workers) == want["workers"],
          f"slice-smoke {label}: {len(workers)} workers")
    for i, w in enumerate(workers):
        check(w["ok"], f"slice-smoke {label}: worker {i} {w}")
        check(w["process_index"] == i % w["process_count"],
              f"slice-smoke {label}: worker {i} index {w['process_index']}")
        for key, value in want.items():
            if key != "workers":
                check(w[key] == value,
                      f"slice-smoke {label}: worker {i} {key} {w[key]}")
        if "ring_tokens" in want:
            check(w["ring_ok"] and w["ring_max_rel_err"] < 1e-5,
                  f"slice-smoke {label}: ring {w}")
        if "slice" in w:
            check(w["megascale_slice_id"] == str(w["slice"])
                  and w["megascale_num_slices"] == "2",
                  f"slice-smoke {label}: megascale identity {w}")
    if "serving" in rep:
        check(rep["serving"]["ok"] and rep["speculative"]["ok"]
              and rep["serving"]["engines"]["ok"],
              f"slice-smoke {label}: serving reports")


def _host_used() -> int:
    """The host memory in use (MemTotal - MemAvailable), bytes."""
    info = dict(line.split(":", 1) for line in
                Path("/proc/meminfo").read_text().splitlines())
    return 1024 * (int(info["MemTotal"].split()[0])
                   - int(info["MemAvailable"].split()[0]))


class _MemoryPeak:
    """The card's memory in use by every process (``mem_get_info``) and
    the host's, their peaks sampled every 0.2 s while the block runs."""

    def __enter__(self):
        import threading

        self.peak, self.host_peak = 0, 0
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.2):
                free, total = torch.cuda.mem_get_info()
                self.peak = max(self.peak, total - free)
                self.host_peak = max(self.host_peak, _host_used())

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def long_context_phase(trainer, tf, fa) -> dict:
    """(a) ring attention at the flagship's attention shape over ('seq',
    2) and ('seq', 4), both orderings, against plain attention, and
    ``bench_report`` on 4 ranks; (d) the four slice smokes through the
    CLI; then (b) 3 ring training steps of the flagship at ('seq', 2)
    against unsharded steps on the same batches, and the dense config
    on the same mesh (gathered attention: logits and one step); (c) the
    flagship forward pipelined over ('stage', 4) and ('data', 2,
    'stage', 2). Independent worlds run at once, in two waves; the
    card's peak memory over all processes is sampled in each."""
    from kind_tpu_sim_torch.parallel import launch

    out = {}

    def world(fn, n, *args):
        return launch.spawn(fn, n, *args, backend="gloo", device="cuda",
                            timeout_s=PARALLEL_TIMEOUT_S)

    t_part = time.perf_counter()
    # every rank is a process holding a CUDA context (host memory too):
    # the slice smokes run SLICE_SMOKES_AT_ONCE at a time beside the ring
    with _MemoryPeak() as mem, ThreadPoolExecutor(
            len(RING_WORLDS)) as pool, ThreadPoolExecutor(
            SLICE_SMOKES_AT_ONCE) as smoke_pool:
        rings = [pool.submit(world, _ring_rank, n) for n in RING_WORLDS]
        smokes = [smoke_pool.submit(_slice_smoke_cli, argv)
                  for _, argv, _ in SLICE_SMOKES]
        rings = [f.result() for f in rings]
        smokes = [f.result() for f in smokes]
    out["wave1_s"] = time.perf_counter() - t_part
    out["wave1_peak_gib"] = mem.peak / 2**30
    out["wave1_host_peak_gib"] = mem.host_peak / 2**30
    log(f"phase 12 wave 1 (ring worlds of {RING_WORLDS}, the slice smokes "
        f"{SLICE_SMOKES_AT_ONCE} at a time): {out['wave1_s']:.1f} s, the "
        f"card's peak {out['wave1_peak_gib']:.2f} GiB over every process, "
        f"the host's {out['wave1_host_peak_gib']:.2f} GiB")
    out["ring"] = {}
    for n, res in zip(RING_WORLDS, rings):
        rep = res["report"]
        for name in ("double_buffered", "serial"):
            err = rep[name]["max_abs_err"]
            log(f"ring attention ('seq', {n}) {name} at {RING_SHAPE} bf16 "
                f"causal: max_abs_err {err:.3e} against plain attention "
                f"(bar {RING_TOL}); wall {rep[name]['wall_ms']:.2f} ms a "
                f"call against plain {rep['plain_ms']:.2f} ms on one rank; "
                f"{rep['rotation_bytes']} bytes a rotation")
            check(math.isfinite(err) and err <= RING_TOL,
                  f"ring attention ('seq', {n}) {name}: {err}")
        if "bench_report" in rep:
            log(f"ring bench_report ('seq', 4): {rep['bench_report']}")
        out["ring"][n] = {**rep, "ranks": res["ranks"]}
    out["slice_smoke"] = {}
    for (label, _, want), res in zip(SLICE_SMOKES, smokes):
        _hold_slice(label, res, want)
        out["slice_smoke"][label] = {"wall_s": res["wall_s"]}

    t_part = time.perf_counter()
    batch = trainer.BATCH
    with _MemoryPeak() as mem, ThreadPoolExecutor(2) as pool:
        seq = pool.submit(world, _seq_train_rank, 2, SEQ_TRAIN_STEPS, batch)
        pipe = pool.submit(world, _pipeline_rank, 4)
        plain, plain_peak = _plain_train(tf, trainer, 0, SEQ_TRAIN_STEPS,
                                         batch, SEQ_LEN)
        seq, pipe = seq.result(), pipe.result()
    out["wave2_s"] = time.perf_counter() - t_part
    out["wave2_peak_gib"] = mem.peak / 2**30
    out["wave2_host_peak_gib"] = mem.host_peak / 2**30
    log(f"phase 12 wave 2 (seq training, pipeline and unsharded steps at "
        f"once): {out['wave2_s']:.1f} s, the card's peak "
        f"{out['wave2_peak_gib']:.2f} GiB over every process, the host's "
        f"{out['wave2_host_peak_gib']:.2f} GiB")
    rep = seq["report"]
    gap = _hold_losses("sequence-parallel training ('seq', 2)",
                       rep["ring"]["losses"], plain)
    log(f"sequence-parallel training ('seq', 2): step walls "
        f"{rep['ring']['walls_ms']} ms, per rank {seq['ranks']}; unsharded "
        f"peak {plain_peak:.2f} GiB; flash launches {rep['ring']['flash_launches']}")
    check(all(n == 0 for n in rep["ring"]["flash_launches"].values()),
          "the ring's train step launched a flash kernel")
    g = rep["gathered"]
    rel = g["logits_diff"] / g["logits_max"]
    log(f"gathered attention ('seq', 2), dense config: logits' largest "
        f"difference {g['logits_diff']:.4e} ({rel:.3e} of the largest; bar "
        f"{TP_LOGITS_REL_TOL:.1e}); forward launches "
        f"{g['forward_launches_by_route']}; one train step loss "
        f"{g['train_loss']} against unsharded {plain[0]}, launches "
        f"{g['train_launches_by_route']}")
    check(rel <= TP_LOGITS_REL_TOL, f"gathered attention logits {rel}")
    _hold_losses("gathered attention train step", [g["train_loss"]],
                 plain[:1])
    check(g["forward_launches_by_route"] == {"tensor_cores": 8,
                                             "cuda_cores": 0},
          f"gathered forward launches {g['forward_launches_by_route']}")
    for name, routes in g["train_launches_by_route"].items():
        check(routes == {"tensor_cores": 8, "cuda_cores": 0},
              f"gathered train step {name} {routes}")
    out["seq_train"] = {"gap": gap, "losses": rep["ring"]["losses"],
                        "unsharded": plain, "unsharded_peak_gib": plain_peak,
                        "ranks": seq["ranks"], "gathered": g,
                        "gathered_rel": rel}
    rep = pipe["report"]
    out["pipeline"] = {"ranks": pipe["ranks"]}
    for key, x in rep.items():
        if key == "logits_max":
            continue
        rel = x["logits_diff"] / rep["logits_max"]
        log(f"pipeline {key}: logits' largest difference "
            f"{x['logits_diff']:.4e} ({rel:.3e} of the largest; bar "
            f"{TP_LOGITS_REL_TOL:.1e}); wall {x['wall_ms']:.1f} ms; flash "
            f"launches a rank {x['ranks']} at microbatch {x['microbatch']} "
            f"(want {x['expected_launches']} each)")
        check(rel <= TP_LOGITS_REL_TOL, f"pipeline {key}: logits {rel}")
        for r in x["ranks"]:
            check(r == {"tensor_cores": x["expected_launches"],
                        "cuda_cores": 0},
                  f"pipeline {key}: flash launches {r}")
        out["pipeline"][key] = {**x, "rel": rel}
    return out


# ---------------------------------------------------------------------
# phase 13: the entry points and the pods. Every run is a process of its
# own (a user's command, or a pod's payload run as the script it is in
# its pod), all started at once: they are host-bound (start-ups, world
# bring-ups, one nvcc build).

ENTRY_TIMEOUT_S = 300
# torch-smoke as a user runs it on the card: NCCL at world size 1, and 4
# gloo ranks on CUDA tensors (phase 11's collectives world)
TORCH_SMOKES = (
    ("nccl world 1", ("--chips", "1", "--topology", "1x1", "--backend",
                      "nccl")),
    ("gloo world 4", ("--chips", "4", "--topology", "2x2", "--backend",
                      "gloo")))
TORCH_SMOKE_REPEAT = 3
CI_STRINGS = ("DEVICES OK", "PLATFORM OK", "PSUM OK", "GLOBAL PSUM OK",
              "CUDA KERNEL OK", "DEVICE GATE FAILED")


def _timed_run(cmd, env=None) -> dict:
    """One command as a process of its own, from the repository root:
    exit code, wall seconds and both outputs."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=ENTRY_TIMEOUT_S)
    return {"rc": res.returncode, "wall_s": time.perf_counter() - t0,
            "stdout": res.stdout, "stderr": res.stderr}


def _ci_lines(res) -> list:
    return [line for line in (res["stdout"] + res["stderr"]).splitlines()
            if line.startswith(CI_STRINGS)]


def _pod_kernel(manifests, lib_path) -> dict:
    """The kernel pod's library as the pod built it, loaded through
    ctypes: its product against ``torch.matmul`` (TF32 off) and timed
    beside it (median of 30, L2 flushed), with its bound."""
    import ctypes

    fn = ctypes.CDLL(str(lib_path)).pod_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(8)
    a = torch.randn((128, 128), generator=gen, device="cuda")
    b = torch.randn((128, 128), generator=gen, device="cuda")
    c = torch.empty_like(a)

    def launch():
        return fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 128,
                  torch.cuda.current_stream().cuda_stream)

    check(launch() == 0, "the kernel pod's kernel did not launch")
    want = torch.matmul(a, b)
    err = float((c - want).abs().max())
    check(torch.allclose(c, want, atol=manifests.KERNEL_POD_ATOL),
          f"the kernel pod's kernel: max_abs_err {err}")
    ms = time_ms(launch)
    plain_ms = time_ms(lambda: torch.matmul(a, b))
    bound_ms, bound_by = bound(3 * 128 * 128 * 4, 2 * 128 ** 3,
                               torch.float32)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": plain_ms, "library_call": "torch.matmul"}


def entry_runs() -> dict:
    """Phase 13's runs, all at once, each a process of its own:
    ``torch-smoke`` through the CLI at NCCL world 1 and on 4 gloo ranks
    on CUDA tensors, and each pod's payload from its generator run as a
    script on the card: the gate pod allocated 1 and 2, the multi-host
    payload as 1 replica x 1 GPU over tcp://127.0.0.1, the kernel pod
    built into ``build/kind_tpu_sim_torch/``. Returns {"runs": {label:
    run}, "wall_s": the wall of all of them}."""
    import os

    from kind_tpu_sim_torch import manifests
    from kind_tpu_sim_torch.ops._build import BUILD_DIR

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scripts = {}
        for name, make in (("gate", manifests.gate_payload),
                           ("multihost", manifests.multihost_payload),
                           ("kernel", manifests.kernel_payload)):
            scripts[name] = Path(tmp) / f"{name}.py"
            scripts[name].write_text(make())
        coordinator = f"127.0.0.1:{free_port()}"

        def payload(name, extra, *argv):
            return _timed_run([sys.executable, str(scripts[name]), *argv],
                              env={**os.environ, **extra})

        runs = {
            **{f"torch-smoke {label}": (
                lambda argv=argv: _timed_run(
                    [sys.executable, "-m", "kind_tpu_sim_torch",
                     "torch-smoke", *argv, "--repeat",
                     str(TORCH_SMOKE_REPEAT), "--json", "--device",
                     "cuda"]))
               for label, argv in TORCH_SMOKES},
            "gate pod, allocated 1": lambda: payload(
                "gate", {"TPU_SIM_GPUS": "1"}),
            "gate pod, allocated 2": lambda: payload(
                "gate", {"TPU_SIM_GPUS": "2"}),
            "multihost payload, 1 replica x 1 GPU": lambda: payload(
                "multihost", {"POD_NAME": "jax-tpu-0",
                              "TPU_SIM_REPLICAS": "1", "TPU_SIM_GPUS": "1",
                              "TPU_SIM_COORDINATOR": coordinator}),
            "kernel pod": lambda: payload(
                "kernel", {"TPU_SIM_GPUS": "1"}, "--build-dir",
                str(BUILD_DIR)),
        }
        with ThreadPoolExecutor(len(runs)) as pool:
            futures = {label: pool.submit(fn) for label, fn in runs.items()}
            results = {label: f.result() for label, f in futures.items()}
    return {"runs": results, "wall_s": time.perf_counter() - t0}


def entry_points_phase(ran) -> dict:
    """Phase 13's checks on ``entry_runs``' processes: ``torch-smoke`` ok
    at NCCL world 1 and on 4 gloo ranks, every warm run faster than the
    cold one, one worker across the runs; the gate pod allocated 1 passes
    and allocated 2 must fail naming both counts; the multi-host payload
    and the kernel pod pass. Every CI string seen is printed, with each
    run's wall. Then the kernel pod's product is held to
    ``torch.matmul`` and timed here (row 8's ``pod``)."""
    from kind_tpu_sim_torch import manifests
    from kind_tpu_sim_torch.ops._build import BUILD_DIR

    out = {"runs_wall_s": ran["wall_s"]}
    results = ran["runs"]
    log(f"phase 13's runs: {ran['wall_s']:.1f} s, all at once")
    for label, res in results.items():
        log(f"phase 13 {label}: rc {res['rc']}, {res['wall_s']:.1f} s; "
            f"CI strings {_ci_lines(res)}")
        out[label] = {"rc": res["rc"], "wall_s": res["wall_s"],
                      "ci": _ci_lines(res)}

    for label, _ in TORCH_SMOKES:
        res = results[f"torch-smoke {label}"]
        check(res["rc"] == 0, f"torch-smoke {label} exited {res['rc']}:\n"
              f"{res['stdout'][-3000:]}\n{res['stderr'][-3000:]}")
        rep = json.loads(res["stdout"].strip().splitlines()[-1])
        log(f"torch-smoke {label}: {json.dumps(rep)}")
        check(rep["ok"] is True and len(rep["warm_suite_s"])
              == TORCH_SMOKE_REPEAT - 1
              and all(w < rep["cold_suite_s"] for w in rep["warm_suite_s"]),
              f"torch-smoke {label}: {rep}")
        out[f"torch-smoke {label}"]["report"] = rep

    def passed(label, *strings):
        res = results[label]
        seen = "\n".join(_ci_lines(res))
        check(res["rc"] == 0 and all(x in seen for x in strings),
              f"{label}: rc {res['rc']}, CI strings {_ci_lines(res)}:\n"
              f"{res['stdout'][-3000:]}\n{res['stderr'][-3000:]}")

    passed("gate pod, allocated 1", "DEVICES OK", "PLATFORM OK", "PSUM OK")
    passed("multihost payload, 1 replica x 1 GPU", "DEVICES OK",
           "PLATFORM OK", "GLOBAL PSUM OK")
    passed("kernel pod", "DEVICES OK", "PLATFORM OK", "CUDA KERNEL OK")
    refused = results["gate pod, allocated 2"]
    check(refused["rc"] != 0 and "DEVICE GATE FAILED" in refused["stderr"]
          and "allocated 2" in refused["stderr"]
          and "PSUM OK" not in refused["stdout"],
          f"the gate let a pod allocated 2 GPUs through on one card: rc "
          f"{refused['rc']}\n{refused['stdout']}\n{refused['stderr']}")

    line = next(x for x in _ci_lines(results["kernel pod"])
                if x.startswith("CUDA KERNEL OK"))
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    pod = {"source": "pods/cuda-kernel-pod.yaml",
           "replaces": "pods/pallas-pod.yaml:28",
           "launches": int(fields["launches"]),
           "payload_max_abs_err": float(fields["max_abs_err"]),
           "build_s": float(fields["build_s"]), "arch": fields["arch"],
           **_pod_kernel(manifests, BUILD_DIR / manifests.KERNEL_LIBRARY)}
    log(f"kernel pod: built for {pod['arch']} in {pod['build_s']:.2f} s, "
        f"max_abs_err {pod['payload_max_abs_err']:.3e} in the pod, "
        f"{pod['max_abs_err']:.3e} here; kernel {pod['ms']:.4f} ms, "
        f"torch.matmul {pod['plain_ms']:.4f} ms, bound "
        f"{pod['bound_ms']:.6f} ms ({pod['bound_by']})")
    out["pod"] = pod
    return out


# ---------------------------------------------------------------------
# phase 14: the simulator's engine paths

# the fleet command's trace length in (d) and (e)
SIM_REQUESTS = 64
# preempt-train at the flagship's widths and 2 of its 8 layers: each of
# its three saves writes the parameters and both AdamW moments in fp32
SIM_TRAIN_LAYERS = 2
# the trainer's steps in preempt-train: 8 uninterrupted, then the
# preempted run and its resume, 8 between them
SIM_TRAIN_STEPS = 16
SIM_COMMANDS = {
    "fleet": ("fleet", "run", "--requests", str(SIM_REQUESTS), "--json",
              "--device", "cuda"),
    "chaos": ("chaos", "run", "--scenario", "all", "--include-slow",
              "--json", "--device", "cuda"),
    "fleet layers": ("fleet", "run", "--requests", str(SIM_REQUESTS),
                     "--health", "--overload", "--tenancy", "--audit-frac",
                     "0.25", "--json", "--device", "cuda"),
    "fleet sched": ("fleet", "run", "--requests", str(SIM_REQUESTS),
                    "--sched", "--train", "1", "--profile", "--json",
                    "--device", "cuda"),
    "globe run": ("globe", "run", "--json"),
    "globe trace": ("globe", "trace"),
    "globe shards": ("globe", "run", "--json", "--shards", "3"),
    "fuzz": ("chaos", "fuzz", "--json", "--budget", "12", "--seed", "0"),
    "fuzz self-test": ("chaos", "fuzz", "--json", "--budget", "1", "--seed",
                       "0", "--inject-invariant-bug"),
    "replay sharded": ("analysis", "replay", "--scenario", "globe-sharded",
                       "--json"),
    "replay injected": ("analysis", "replay", "--scenario", "globe-sharded",
                        "--json", "--inject-entropy-bug"),
}
# (i): the globe's commands (the default globe: three zones of one
# scheduler-backed cell, 200 requests a zone), whose output must equal the
# same command run in this process. They run among (d)'s processes, not
# phase 15's: twelve processes there took phase 15 past its limit
SIM_GLOBE = ("globe run", "globe trace")
# (j): the sharded globe, the fuzzer and the replay checker (host only),
# with each command's exit code: the injected replay must diverge
SIM_SHARDED = {"globe shards": 0, "fuzz": 0, "fuzz self-test": 0,
               "replay sharded": 0, "replay injected": 1}
# the fleet report's keys that hold for every weight (the streams' crcs
# taken out of the completions), with the control layers' sections where
# a run has them, and the scenario results'
SIM_FLEET_KEYS = ("requests", "completed", "virtual_s", "slo", "router",
                  "ok", "config", "fleet_counters")
SIM_LAYER_KEYS = ("health", "overload", "tenancy", "integrity",
                  "preemptions", "scheduler", "training")
# (f): the control layers' fleet at the flagship: the stock tenants'
# trace of seed 0, three replicas, and replica 1 slowed x6 over 10-50%
# of the trace's span, then replica 2 preempted over 60-80% of it
SIM_LAYERS_REQUESTS = 80
SIM_LAYERS_EVENTS = ((0.1, "slow", 1, 6.0), (0.5, "unslow", 1, 0.0),
                     (0.6, "preempt", 2, 0.0), (0.8, "restore", 2, 0.0))
# (g): the scheduler-backed fleet at the flagship: two replicas on the
# default 4x8 inventory (tpu-node-0-0 and -0-1) beside one llm0 training
# gang (2x8, 80 steps, the other row), the detector on, the fleet
# command's trace. The link of the one ICI domain degrades to 0.25 and
# heals; node 1 fails (replica 1 rebinds on node 2 and preempts the
# training gang) and heals, then node 2 fails (replica 1 rebinds on node
# 1) and heals, which makes the row whole for the training gang again;
# the gang is preempted once more by chaos. Virtual seconds.
SIM_SCHED_EVENTS = ((0.05, "link_degrade", 0, 0.25),
                    (0.08, "node_fail", 1, 0.0),
                    (0.2, "node_restore", 1, 0.0),
                    (0.25, "link_restore", 0, 0.0),
                    (0.3, "node_fail", 2, 0.0),
                    (0.45, "node_restore", 2, 0.0),
                    (0.9, "train_preempt", 0, 0.0))
SIM_PROFILE_KEYS = ["events_per_s", "lanes", "top_functions", "wall_s"]
SIM_PROFILE_LANES = ["arrival", "autoscaler", "chaos", "completion", "core",
                     "health_probe", "kv_transfer", "planner"]
SIM_SCENARIO_KEYS = {
    "preempt-train": ("plan", "preempted_at_step", "resume_max_loss_drift",
                      "ok", "recovery_events"),
    "serving-slot-failure": ("plan", "requests", "slot_failures",
                             "requeues", "streams_identical", "ok",
                             "recovery_events"),
    "fleet-preemption": ("plan", "requests", "preempted_replica",
                         "preempt_at_s", "requeues", "streams_identical",
                         "tail_attainment_clean", "tail_attainment_faulted",
                         "ok", "recovery_events"),
    # analytic: every field holds on any device
    "disagg-pool-loss": ("plan", "requests", "kv_factor",
                         "decode_survivors", "requeues", "kv",
                         "tail_attainment_clean", "tail_attainment_faulted",
                         "ok", "recovery_events"),
    "zoo-swap-storm": ("plan", "requests", "pulses", "generations",
                       "swaps_steady", "swaps_storm", "per_model_slo",
                       "p99_steady_s", "p99_storm_s", "p99_ratio",
                       "replay_identical", "ok", "recovery_events"),
    # the virtual-clock scenarios of the control layers, the scheduler
    # and the training tenancy (analytic, round-figure replicas)
    "fleet-flaky-replica": ("plan", "requests", "flaps", "requeues",
                            "tail_attainment_clean",
                            "tail_attainment_faulted", "ok",
                            "recovery_events"),
    "tenant-noisy-neighbor": ("plan", "requests", "multiplier",
                              "victim_p99_alone_s", "victim_p99_noisy_s",
                              "victim_p99_isolation_off_s",
                              "victim_p99_ratio", "aggressor_quota_shed",
                              "aggressor_admitted", "fair_queue_rounds",
                              "replay_identical", "ok", "recovery_events"),
    "sched-node-drain": ("plan", "requests", "drain_at_s", "restore_at_s",
                         "sched_events", "requeues", "tail_attainment_clean",
                         "tail_attainment_faulted", "ok", "recovery_events"),
    "sched-preemption-priority": ("plan", "evictions", "victims",
                                  "high_priority_bound",
                                  "victims_rescheduled", "events_identical",
                                  "ok", "recovery_events"),
    "gray-slow-replica": ("plan", "requests", "slow_replica", "factor",
                          "fault_free_quarantines", "quarantines",
                          "false_positives", "restored_via_probes",
                          "p99_recovered", "p99_off_degraded",
                          "replay_identical", "ok", "recovery_events"),
    "gray-degraded-ici": ("plan", "requests", "degraded_domain",
                          "link_factor", "fault_free_quarantines",
                          "quarantines", "false_positives",
                          "gray_migrations", "link_events",
                          "migrations_avoid_degraded_domain",
                          "p99_recovered", "p99_off_degraded",
                          "replay_identical", "ok", "recovery_events"),
    "overload-surge": ("plan", "requests", "surge_multiplier",
                       "surge_window_s", "recovery_window_s",
                       "goodput_floor_frac", "surge_goodput_clean",
                       "surge_goodput_on", "goodput_floor_held",
                       "p99_recovery_ratio_on", "p99_recovery_ratio_off",
                       "retries_suppressed", "retries_on", "retries_off",
                       "hedges_issued", "hedges_suppressed", "brownout",
                       "replay_identical", "ok", "recovery_events"),
    "retry-storm": ("plan", "requests", "amplification", "outage_window_s",
                    "recovery_window_s", "preempted_replica",
                    "p99_recovery_ratio_on", "p99_recovery_ratio_off",
                    "retries_suppressed", "retries_on", "retries_off",
                    "requeues", "replay_identical", "ok", "recovery_events"),
    "train-preempt-economics": ("plan", "cadences", "preempt_at_s",
                                "kill_at_s", "lost_steps",
                                "checkpoint_writes", "overhead_frac",
                                "expected_overhead", "ledger_ok",
                                "economics_hold", "replay_identical", "ok",
                                "recovery_events"),
    "train-mixed-soak": ("plan", "requests", "drain_node", "p99_alone_s",
                         "p99_mixed_s", "p99_ratio", "training",
                         "train_preemptions", "strict_priority_preemptions",
                         "serving_preempted_by_training", "replay_identical",
                         "event_core_identical", "ok", "recovery_events"),
    "sdc-training-bisect": ("plan", "sdc_at_s", "corrupt_frac",
                            "expected_chip", "culprits", "bisection_rounds",
                            "expected_rounds", "bisect_chip_s", "lost_steps",
                            "integrity", "ledger_ok", "gang_done",
                            "replay_identical", "event_core_identical", "ok",
                            "recovery_events"),
    "sdc-serving-audit": ("plan", "sdc_at_s", "victim_replica",
                          "corrupt_frac", "audit", "audit_off",
                          "corrupted_served_on", "corrupted_served_off",
                          "p99_audit_s", "p99_off_s", "p99_ratio",
                          "replay_identical", "ok", "recovery_events"),
    # the control plane's, over the fake runtime (no card, no daemon)
    "flaky-exec": ("plan", "injected_failures", "commands_completed", "ok",
                   "recovery_events"),
    "device-flap": ("plan", "flaps", "fail_writes", "heal_writes", "ok",
                    "recovery_events"),
    "node-flap": ("plan", "kills", "restarts", "ok", "recovery_events"),
    "correlated-rack-loss": ("plan", "failure_domain", "rack_nodes",
                             "outage_s", "fault_at_s",
                             "max_simultaneous_dead", "p99_window_s",
                             "slo_attainment", "domain_faults",
                             "replay_identical", "ok", "recovery_events"),
    # the globe's blast-radius scenarios (analytic cells)
    "globe-zone-loss": ("plan", "requests", "lost_zone", "loss_at_s",
                        "restore_at_s", "spilled", "readmitted", "shed",
                        "p99_post_restore_ratio", "surviving_zone_p99_ratio",
                        "replay_identical", "ok", "recovery_events"),
    "globe-herd-failover": ("plan", "requests", "herd_zone", "failover_at_s",
                            "readmitted", "spilled", "peak_outstanding",
                            "hard_limits", "spill_bound_held", "cell_sheds",
                            "frontdoor_sheds", "tail_attainment_clean",
                            "tail_attainment_faulted", "replay_identical",
                            "ok", "recovery_events"),
    "globe-dcn-degrade": ("plan", "requests", "link_factor",
                          "degrade_window_s", "spill_window_requests",
                          "routed_around_degraded_link", "zone_c_p99_ratio",
                          "p99_post_restore_ratio", "dcn_degrades",
                          "replay_identical", "ok", "recovery_events"),
    "train-globe-spot": ("plan", "requests", "loss_at_s", "restore_at_s",
                         "train_grants", "train_reclaims", "grows",
                         "shrinks", "evictions", "final_topology",
                         "lost_steps", "ledger_ok", "gang_done",
                         "replay_identical", "ok", "recovery_events"),
    # the cold worker grids: real subprocess workers on the wall clock
    "worker-crash-grid": ("plan", "cells", "faults_injected", "requeues",
                          "respawns", "results_identical", "ok",
                          "recovery_events"),
    "worker-hang-grid": ("plan", "cells", "faults_injected", "requeues",
                         "results_identical", "ok", "recovery_events"),
    # its timing-free fields alone: its verdict times the host
    "gray-straggler-grid": ("plan", "workers", "cells", "faulted_worker",
                            "results_identical"),
}
# the scenario whose verdict on the H100's calibration is a failure (its
# p99 bound, by the decode bandwidth's arithmetic): held to the CPU's
SIM_FAILING_SCENARIO = "zoo-swap-storm"
# the scenario whose verdict compares wall-clock makespans of subprocess
# grids: beside (d)'s other processes and this process's card work a
# healthy worker can miss its 0.8 s probe, so (d) holds its timing-free
# fields alone, and (h) runs it with nothing beside it for its verdict
SIM_TIMED_SCENARIO = "gray-straggler-grid"
SIM_STRAGGLER_COMMAND = ("chaos", "run", "--scenario", SIM_TIMED_SCENARIO,
                         "--json")


def _flash_routes(fa) -> dict:
    return {name: dict(getattr(fa, name).launches_by_route) for name in (
        "flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}


def _sim_run(label: str, fa, graphs, fn):
    """``fn()`` with the flash kernels' counts zeroed just before and read
    just after, and the CUDA graphs captured in between counted. Returns
    (its result, {wall_s, launches_by_route, graphs_captured,
    capture_s})."""
    zero_counts(fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = dict(graphs.CAPTURES)
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    stats = {"wall_s": time.perf_counter() - t0,
             "launches_by_route": _flash_routes(fa),
             "graphs_captured": graphs.CAPTURES["graphs"] - before["graphs"],
             "capture_s": graphs.CAPTURES["capture_s"]
             - before["capture_s"]}
    log(f"14 {label}: {stats['wall_s']:.1f} s; flash launches by route "
        f"{stats['launches_by_route']}; {stats['graphs_captured']} graphs "
        f"captured in {stats['capture_s']:.2f} s")
    return result, stats


def _weight_free(rep: dict) -> dict:
    """A fleet report's fields that hold for any weights."""
    out = {key: rep[key] for key in SIM_FLEET_KEYS}
    out.update({key: rep[key] for key in SIM_LAYER_KEYS if key in rep})
    out["completions"] = [{k: v for k, v in e.items() if k != "tokens_crc"}
                          for e in rep["completions"]]
    return out


def layers_fleet(fleet, params, cfg, serving, device: str):
    """(f)'s fleet: the detector, overload containment, the stock
    tenants and the audit lane at 0.3 over three engine replicas of
    ``cfg`` on ``device``, least-outstanding, tick 0.01, SLO ttft 0.3 /
    e2e 0.6. Its replicas count their ``cancel`` outcomes in the
    returned Counter (True: withdrawn from the queue, False: left to
    finish)."""
    import collections

    from kind_tpu_sim_torch.models.serving import ServingEngine

    trace = fleet.generate_trace(fleet.WorkloadSpec(
        process="poisson", rps=150.0, n_requests=SIM_LAYERS_REQUESTS,
        max_new=(12, 24), tenancy=fleet.default_tenancy()), 0)
    span = max(r.arrival_s for r in trace)
    events = [fleet.ChaosEvent(round(frac * span, 6), action, target, param)
              for frac, action, target, param in SIM_LAYERS_EVENTS]
    fc = fleet.FleetConfig(
        replicas=3, policy="least-outstanding", tick_s=0.01,
        slo=fleet.SloPolicy(ttft_s=0.3, e2e_s=0.6),
        health=fleet.DetectorConfig(), overload=fleet.OverloadConfig(),
        tenancy=fleet.default_tenancy(), audit_frac=0.3)
    clock = fleet.VirtualClock()
    cancels = collections.Counter()

    class Replica(fleet.EngineReplica):
        def cancel(self, request_id):
            out = super().cancel(request_id)
            cancels[out] += 1
            return out

    def factory(rid):
        return Replica(rid, ServingEngine(params, cfg, serving, device=device,
                                          clock=clock.now))

    return fleet.FleetSim(fc, trace, replica_factory=factory,
                          chaos_events=events, clock=clock), cancels


def sched_fleet(fleet, params, cfg, serving, device: str):
    """(g)'s fleet: two engine replicas of ``cfg`` on ``device`` placed
    by the cluster scheduler on the default inventory, one llm0 training
    gang under them, the detector on, the fleet command's trace and
    config otherwise, and ``SIM_SCHED_EVENTS``."""
    from kind_tpu_sim_torch import cli
    from kind_tpu_sim_torch.models.serving import ServingEngine

    args = cli.build_parser().parse_args(list(SIM_COMMANDS["fleet sched"]))
    fc = dataclasses.replace(cli.fleet_config(args),
                             health=fleet.DetectorConfig())
    clock = fleet.VirtualClock()

    def factory(rid):
        return fleet.EngineReplica(rid, ServingEngine(
            params, cfg, serving, device=device, clock=clock.now))

    return fleet.FleetSim(
        fc, cli.fleet_trace(args, 0), replica_factory=factory,
        chaos_events=[fleet.ChaosEvent(*ev) for ev in SIM_SCHED_EVENTS],
        clock=clock)


def _prefill_dispatches(rep: dict) -> int:
    return sum(r["engine"]["prefill_dispatches"]
               for r in rep["replicas"].values())


def _restored_by_probes(detector: dict) -> list:
    """The components the detector quarantined and then restored through
    probes."""
    quarantined = set()
    out = []
    for ev in detector["events"]:
        if ev["transition"] == "quarantined":
            quarantined.add(ev["component"])
        elif (ev["transition"] == "restored" and ev.get("reason") == "probes"
              and ev["component"] in quarantined):
            out.append(ev["component"])
    return out


def sim_engine_phase(fa, tf, cfg) -> dict:
    """Phase 14: the simulator's engine paths on the card, each held to
    the reference's bar. (d) ``fleet run`` and ``chaos run --scenario all
    --include-slow`` start first as processes (the reference's tiny
    configs), with (i) ``globe run --json`` and ``globe trace``, and are
    read last; meanwhile, in this, the main thread: (a)
    ``fleet-preemption`` and (b) ``serving-slot-failure`` at the
    flagship's width with flash, (c) ``preempt-train`` at the flagship's
    widths and 2 of its 8 layers (SIGTERM reaches only the main thread),
    (e) the fleet command's fleet (its trace, its config, the tiny model
    in fp32, so near-ties cannot split a stream) on the card against the
    same fleet on the CPU with the same weights: every completion equal,
    crcs included. (f) the control layers (the detector, overload
    containment, tenancy, the audit lane) over three replicas of the
    flagship (all 8 layers, flash, phase 4's bf16 weights) with a slowed
    and a preempted replica: its weight-free fields equal the same
    fleet's of the tiny fp32 model on the CPU; hedges issued, cancels of
    both outcomes, a quarantine restored through probes, audit copies
    with no disagreement. (g) the scheduler-backed fleet
    (``sched_fleet``: two flagship replicas beside a training gang, the
    detector on, ``SIM_SCHED_EVENTS``): its weight-free fields equal the
    same fleet's of the tiny fp32 model on the CPU; a serving gang
    evicted and the training gang preempted; every time to routable at
    least bind_s + warm-up; the training gang done with a clean ledger;
    the flash forward all on the tensor cores, n_layers launches a
    prefill dispatch of the CPU twin. (d)'s fleet must give (e)'s
    weight-free fields, its fleets with the layers' flags and with
    ``--sched --train 1 --profile`` the same flags' runs on the CPU here
    (the profile's keys the reference's), and each of its scenarios the
    same scenario's weight-free fields run on the CPU here. Each step's
    flash launches by route and graph captures are logged. Then (h), the
    straggler grid alone (``lone_straggler_grid``)."""
    import threading

    from kind_tpu_sim_torch import chaos, cli, fleet
    from kind_tpu_sim_torch import profile_serving as flagship
    from kind_tpu_sim_torch.models import graphs

    out = {}
    def start(argv, after=None):
        if after is not None:
            after.result()
        return _timed_run([sys.executable, "-m", "kind_tpu_sim_torch", *argv])

    with ThreadPoolExecutor(len(SIM_COMMANDS)) as pool:
        running = {label: pool.submit(start, argv)
                   for label, argv in SIM_COMMANDS.items()
                   if label not in SIM_SHARDED}
        # (j) once the chaos command has ended: its cold workers would
        # crowd the straggler grid's, whose 0.8 s start-up probes fail then
        for label in SIM_SHARDED:
            running[label] = pool.submit(start, SIM_COMMANDS[label],
                                         running["chaos"])

        for name in ("fleet-preemption", "serving-slot-failure"):
            rep, stats = _sim_run(
                f"({'a' if name == 'fleet-preemption' else 'b'}) {name} at "
                "the flagship", fa, graphs,
                lambda name=name: chaos.run_scenario(
                    name, seed=0, device="cuda", cfg=cfg))
            log(f"14 {name}: {json.dumps(rep, sort_keys=True)}")
            check(rep["ok"] and rep["streams_identical"]
                  and rep["requeues"] >= 1
                  and rep.get("slot_failures", 1) == 1,
                  f"{name} at the flagship: {rep}")
            fwd = stats["launches_by_route"]["flash_attention"]
            check(fwd["tensor_cores"] > 0 and fwd["cuda_cores"] == 0,
                  f"{name}: flash forward launched {fwd}, expected all on "
                  "the tensor cores")
            out[name] = {"result": rep, **stats}

        check(threading.current_thread() is threading.main_thread(),
              "preempt-train must run in the main thread")
        train_cfg = dataclasses.replace(cfg, n_layers=SIM_TRAIN_LAYERS)
        rep, stats = _sim_run(
            f"(c) preempt-train at the flagship's widths, "
            f"{SIM_TRAIN_LAYERS} of {cfg.n_layers} layers", fa, graphs,
            lambda: chaos.run_scenario("preempt-train", seed=0,
                                       device="cuda", cfg=train_cfg))
        log(f"14 preempt-train: {json.dumps(rep, sort_keys=True)}")
        kill_step = rep["plan"]["events"][0]["at"] + 1
        check(rep["ok"] and rep["preempted_at_step"] == kill_step + 1
              and rep["resume_max_loss_drift"] == 0.0,
              f"preempt-train at the flagship: {rep}")
        want = SIM_TRAIN_LAYERS * SIM_TRAIN_STEPS
        for name, routes in stats["launches_by_route"].items():
            check(routes == {"tensor_cores": want, "cuda_cores": 0},
                  f"preempt-train: {name} launched {routes}, expected "
                  f"{want} on the tensor cores")
        out["preempt-train"] = {"result": rep, "layers": SIM_TRAIN_LAYERS,
                                **stats}

        args = cli.build_parser().parse_args(list(SIM_COMMANDS["fleet"]))
        fc = cli.fleet_config(args)
        trace = cli.fleet_trace(args, 0)
        tiny, sc = cli.serving_fleet_config()
        tiny = dataclasses.replace(tiny, dtype="float32")
        params = tf.init_params(tiny, torch.Generator().manual_seed(0), "cpu")
        t0 = time.perf_counter()
        cpu = fleet.engine_fleet(fc, trace, params, tiny, sc,
                                 device="cpu").run()
        cpu_s = time.perf_counter() - t0
        card, stats = _sim_run(
            "(e) the fleet command's fleet in fp32 on the card", fa, graphs,
            lambda: fleet.engine_fleet(
                fc, trace, _tree_to(params, lambda t: t.to("cuda")), tiny,
                sc, device="cuda").run())
        for key in SIM_FLEET_KEYS + ("completions",):
            check(card[key] == cpu[key],
                  f"the card's fleet differs from the CPU's in {key}")
        check(card["ok"] and card["completed"] == SIM_REQUESTS,
              f"the fleet on the card: ok {card['ok']}, completed "
              f"{card['completed']}")
        log(f"14 (e): {card['completed']} completions equal to the CPU's "
            f"(CPU {cpu_s:.1f} s); slo {json.dumps(card['slo'])}")
        out["fleet on the card against the CPU"] = {
            "cpu_s": cpu_s, "slo": card["slo"], **stats}

        t0 = time.perf_counter()
        sim, _ = layers_fleet(fleet, params, tiny, sc, "cpu")
        layers_cpu = sim.run()
        cpu_s = time.perf_counter() - t0
        sp = flagship.flagship_params(cfg)
        sim, cancels = layers_fleet(fleet, sp, cfg, sc, "cuda")
        layers, stats = _sim_run(
            "(f) the control layers over three flagship replicas", fa,
            graphs, sim.run)
        del sim, sp
        ov = layers["overload"]["counters"]
        health = layers["health"]["counters"]
        audits = layers["integrity"]["counters"]
        restored = _restored_by_probes(layers["health"]["detector"])
        log(f"14 (f): ok {layers['ok']}, {layers['completed']} completions "
            f"(CPU {cpu_s:.1f} s); overload {json.dumps(ov)}; cancels "
            f"withdrawn {cancels[True]}, left to finish {cancels[False]}; "
            f"health {json.dumps(health)}, restored by probes {restored}; "
            f"integrity {json.dumps(layers['integrity'])}; tenants "
            + json.dumps({k: v["admitted"] for k, v in
                          layers["tenancy"]["tenants"].items()}))
        check(layers["ok"] and layers["completed"] >= SIM_LAYERS_REQUESTS,
              f"(f) at the flagship: ok {layers['ok']}, completed "
              f"{layers['completed']}")
        got = _weight_free(layers)
        for key, want in _weight_free(layers_cpu).items():
            check(got[key] == want,
                  f"(f) at the flagship differs from the CPU's in {key}")
        check(ov.get("hedges_issued", 0) >= 1 and cancels[True] >= 1
              and cancels[False] >= 1,
              f"(f): hedges {ov}, cancel outcomes {dict(cancels)}")
        check(health.get("quarantines", 0) >= 1 and restored,
              f"(f): no quarantine restored through probes: {health}")
        check(audits.get("audit_copies", 0) >= 1
              and "audit_mismatches" not in audits
              and not layers["integrity"]["detections"],
              f"(f): audits {layers['integrity']}")
        fwd = stats["launches_by_route"]["flash_attention"]
        check(fwd["tensor_cores"] > 0 and fwd["cuda_cores"] == 0,
              f"(f): flash forward launched {fwd}, expected all on the "
              "tensor cores")
        out["control layers at the flagship"] = {
            "cpu_s": cpu_s, "slo": layers["slo"], "overload": ov,
            "cancels": {"withdrawn": cancels[True],
                        "left_to_finish": cancels[False]},
            "health": health, "integrity": audits, **stats}

        t0 = time.perf_counter()
        sched_cpu = sched_fleet(fleet, params, tiny, sc, "cpu").run()
        cpu_s = time.perf_counter() - t0
        sp = flagship.flagship_params(cfg)
        sim = sched_fleet(fleet, sp, cfg, sc, "cuda")
        sched, stats = _sim_run(
            "(g) the scheduler-backed fleet: two flagship replicas beside a "
            "training gang", fa, graphs, sim.run)
        ttrs = list(sim.time_to_routable)
        floor = round(sched["scheduler"]["bind_s"]
                      + sched["scheduler"]["flat_warmup_s"], 6)
        del sim, sp
        tr = sched["training"]
        preempted = [e["gang"] for e in sched["scheduler"]["events"]
                     if e["type"] == "Preempted"]
        dispatches = _prefill_dispatches(sched_cpu)
        fwd = stats["launches_by_route"]["flash_attention"]
        log(f"14 (g): ok {sched['ok']}, {sched['completed']} completions "
            f"(CPU {cpu_s:.1f} s); scheduler "
            f"{json.dumps(sched['scheduler']['event_counts'])}, preempted "
            f"{preempted}, time to routable {ttrs} (floor {floor}); "
            f"training done {tr['all_done']}, ledger ok {tr['ledger_ok']}, "
            f"evictions {tr['evictions']}; health "
            f"{json.dumps(sched['health']['counters'])}; prefill dispatches "
            f"{dispatches} on the CPU, {_prefill_dispatches(sched)} here")
        check(sched["ok"] and sched["completed"] == SIM_REQUESTS,
              f"(g): ok {sched['ok']}, completed {sched['completed']}")
        got = _weight_free(sched)
        for key, want in _weight_free(sched_cpu).items():
            check(got[key] == want,
                  f"(g) at the flagship differs from the CPU's in {key}")
        check(any(g.startswith("replica-") for g in preempted)
              and "train-llm0" in preempted,
              f"(g): preempted {preempted}, expected a serving gang's "
              "eviction and the training gang's preemption")
        check(ttrs and min(ttrs) >= floor,
              f"(g): time to routable {ttrs} under bind_s + warm-up {floor}")
        check(tr["all_done"] and tr["ledger_ok"]
              and tr["gangs"]["llm0"]["ledger_verify"]["ok"]
              and tr["gangs"]["llm0"]["steps_done"] == 80,
              f"(g): training {json.dumps(tr)[:2000]}")
        check(fwd == {"tensor_cores": cfg.n_layers * dispatches,
                      "cuda_cores": 0}
              and _prefill_dispatches(sched) == dispatches,
              f"(g): flash forward launched {fwd}, expected "
              f"{cfg.n_layers} x {dispatches} prefill dispatches, all on "
              "the tensor cores")
        out["scheduler-backed fleet at the flagship"] = {
            "cpu_s": cpu_s, "slo": sched["slo"],
            "scheduler": sched["scheduler"]["event_counts"],
            "time_to_routable": ttrs, "training_evictions": tr["evictions"],
            "prefill_dispatches": dispatches, **stats}

        args = cli.build_parser().parse_args(
            list(SIM_COMMANDS["fleet sched"]))
        sched_cmd_cpu = fleet.engine_fleet(
            cli.fleet_config(args), cli.fleet_trace(args, 0), params, tiny,
            sc, device="cpu").run()

        args = cli.build_parser().parse_args(
            list(SIM_COMMANDS["fleet layers"]))
        layers_cmd_cpu = fleet.engine_fleet(
            cli.fleet_config(args), cli.fleet_trace(args, 0), params, tiny, sc,
            device="cpu").run()

        cpu_scenarios = {name: chaos.run_scenario(name, seed=0, device="cpu")
                         for name in SIM_SCENARIO_KEYS}
        globe_here = {label: _cli_stdout(cli, SIM_COMMANDS[label])
                      for label in SIM_GLOBE + ("fuzz",)}
        ran = {label: f.result() for label, f in running.items()}

    res = ran["chaos"]
    check(res["rc"] in (0, 1) and res["stdout"].strip(),
          f"chaos command exited {res['rc']}:\n{res['stdout'][-3000:]}\n"
          f"{res['stderr'][-3000:]}")
    chaos_rep = json.loads(res["stdout"].strip().splitlines()[-1])
    by_name = {r["scenario"]: r for r in chaos_rep["scenarios"]}
    verdicts = {name: rep["ok"] for name, rep in by_name.items()}
    for label, res in ran.items():
        # the chaos command exits 0 only when every verdict is ok
        want_rc = (SIM_SHARDED.get(label, 0)
                   if label != "chaos" or all(verdicts.values()) else 1)
        check(res["rc"] == want_rc,
              f"{label} command exited {res['rc']}, want {want_rc}:\n"
              f"{res['stdout'][-3000:]}\n{res['stderr'][-3000:]}")
        step = "(j)" if label in SIM_SHARDED else "(d)"
        log(f"14 {step} {' '.join(SIM_COMMANDS[label])}: rc {res['rc']}, "
            f"{res['wall_s']:.1f} s")
    fleet_rep = json.loads(ran["fleet"]["stdout"].strip().splitlines()[-1])
    check(fleet_rep["ok"] and fleet_rep["engine"] == "serving"
          and _weight_free(fleet_rep) == _weight_free(cpu),
          "the fleet command on the card: not ok, or its weight-free "
          "fields differ from the same fleet's on the CPU")
    layers_rep = json.loads(
        ran["fleet layers"]["stdout"].strip().splitlines()[-1])
    check(layers_rep["ok"] and "integrity" in layers_rep
          and _weight_free(layers_rep) == _weight_free(layers_cmd_cpu),
          "the fleet command with the layers' flags on the card: not ok, or "
          "its weight-free fields differ from the same flags' run on the CPU")
    sched_rep = json.loads(
        ran["fleet sched"]["stdout"].strip().splitlines()[-1])
    profile = sched_rep.pop("profile", {})
    check(sched_rep["ok"] and sched_rep["training"]["all_done"]
          and _weight_free(sched_rep) == _weight_free(sched_cmd_cpu),
          "the fleet command with --sched --train 1 on the card: not ok, or "
          "its weight-free fields differ from the same flags' run on the CPU")
    check(sorted(profile) == SIM_PROFILE_KEYS
          and sorted(profile["lanes"]) == SIM_PROFILE_LANES
          and profile["lanes"]["arrival"]["events"] == SIM_REQUESTS,
          f"the fleet command's --profile section: {sorted(profile)}, "
          f"lanes {sorted(profile.get('lanes', {}))}")
    check(sorted(by_name) == sorted(SIM_SCENARIO_KEYS)
          and chaos_rep["ok"] == all(verdicts.values())
          and all(ok for name, ok in verdicts.items()
                  if name not in (SIM_FAILING_SCENARIO, SIM_TIMED_SCENARIO))
          and verdicts[SIM_FAILING_SCENARIO]
          == cpu_scenarios[SIM_FAILING_SCENARIO]["ok"],
          f"chaos run on the card: verdicts {verdicts}, the CPU's "
          f"{SIM_FAILING_SCENARIO} "
          f"{cpu_scenarios[SIM_FAILING_SCENARIO]['ok']}")
    log(f"14 (d) chaos verdicts {verdicts} ({SIM_FAILING_SCENARIO} as on "
        f"the CPU; {SIM_TIMED_SCENARIO} not held under this load)")
    for name, keys in SIM_SCENARIO_KEYS.items():
        for key in keys:
            check(by_name[name][key] == cpu_scenarios[name][key],
                  f"chaos run {name} on the card: {key} "
                  f"{by_name[name][key]} against the CPU's "
                  f"{cpu_scenarios[name][key]}")
        if not chaos.SCENARIOS[name].device and name != SIM_TIMED_SCENARIO:
            # analytic, or a grid's counts: the whole report, byte for byte
            check(json.dumps(by_name[name], sort_keys=True)
                  == json.dumps(cpu_scenarios[name], sort_keys=True),
                  f"chaos run {name}: the command's report differs from "
                  "the same scenario run in this process")
    for label in SIM_GLOBE:
        res = ran[label]
        rc, here_out = globe_here[label]
        lines = here_out.strip().splitlines()
        shape_ok = (json.loads(lines[-1])["ok"] if label == "globe run"
                    else len(lines) == 600)
        check(rc == 0 and res["stdout"] == here_out and shape_ok,
              f"14 (i) {' '.join(SIM_COMMANDS[label])}: here rc {rc}, or its "
              "output differs from the same command in this process")
        log(f"14 (i) {' '.join(SIM_COMMANDS[label])}: {len(here_out)} bytes "
            "equal to the run in this process")
    out["sharded globe, fuzz and replay"] = sim_sharded_checks(
        ran, globe_here)
    globe_rep = json.loads(globe_here["globe run"][1])
    out["globe"] = {"global_slo": globe_rep["global_slo"],
                    "frontdoor": {k: globe_rep["frontdoor"][k] for k in (
                        "routed", "spilled", "affinity_hits")}}
    out["commands"] = {label: {"rc": res["rc"], "wall_s": res["wall_s"]}
                       for label, res in ran.items()}
    out["lone straggler grid"] = lone_straggler_grid(
        cpu_scenarios[SIM_TIMED_SCENARIO])
    out["commands"]["fleet"]["slo"] = fleet_rep["slo"]
    out["commands"]["fleet layers"].update(
        slo=layers_rep["slo"], overload=layers_rep["overload"]["counters"],
        integrity=layers_rep["integrity"]["counters"])
    out["commands"]["fleet sched"].update(
        slo=sched_rep["slo"],
        scheduler=sched_rep["scheduler"]["event_counts"],
        profile={"wall_s": profile["wall_s"],
                 "events_per_s": profile["events_per_s"]})
    return out


def sim_sharded_checks(ran: dict, here: dict) -> dict:
    """14 (j): the commands' outputs (``ran``) held to the runs in this
    process (``here``: (i)'s ``globe run --json`` and the campaign of
    ``fuzz``)."""
    def last_json(label):
        return json.loads(ran[label]["stdout"].strip().splitlines()[-1])

    single = ran["globe run"]["stdout"]
    check(ran["globe shards"]["stdout"] == single == here["globe run"][1],
          "14 (j) globe run --shards 3: its output differs from the "
          "single-process globe run's")
    log(f"14 (j) globe run --json --shards 3: {len(single)} bytes equal to "
        "the single-process run's")
    rc, campaign = here["fuzz"]
    fuzz_rep = last_json("fuzz")
    check(rc == 0 and fuzz_rep["ok"] and ran["fuzz"]["stdout"] == campaign,
          f"14 (j) chaos fuzz: here rc {rc}, ok {fuzz_rep['ok']}, or its "
          "output differs from the same campaign in this process")
    selftest = last_json("fuzz self-test")
    kinds = [sorted(f["kind"] for f in r["spec"]["faults"])
             for r in selftest["shrunk"]]
    check(selftest["ok"] and selftest["selftest_found"]
          and kinds == [["replica_preempt", "slow_replica"]],
          f"14 (j) the fuzzer's self-test: found "
          f"{selftest.get('selftest_found')}, shrunk to {kinds}")
    replay, injected = last_json("replay sharded"), last_json(
        "replay injected")
    div = injected.get("divergence") or {}
    check(replay["ok"] and not injected["ok"] and "index" in div,
          f"14 (j) analysis replay globe-sharded: ok {replay['ok']}, "
          f"injected {json.dumps(injected)[:2000]}")
    log(f"14 (j) chaos fuzz (budget 12, seed 0): {len(fuzz_rep['runs'])} "
        f"runs, ok, {len(campaign)} bytes equal to this process's; "
        f"self-test shrunk to {kinds[0]}; replay globe-sharded "
        f"{replay['events']} events, digest {replay['stream_digest'][:16]}; "
        f"injected: first divergent event #{div['index']} "
        f"(stream {div['stream']})")
    return {"fuzz_runs": len(fuzz_rep["runs"]),
            "selftest_shrunk": kinds[0],
            "replay": {k: replay[k] for k in ("events", "stream_digest")},
            "divergence": {k: div[k] for k in ("index", "stream")},
            "walls_s": {label: ran[label]["wall_s"] for label in SIM_SHARDED}}


def lone_straggler_grid(here: dict) -> dict:
    """14 (h): ``chaos run --scenario gray-straggler-grid --json`` as a
    process with nothing of this script beside it (no other process, no
    card work: this thread waits on it): its verdict, which compares
    wall-clock makespans against bounds from two clean runs, must be ok,
    and its timing-free fields those of the run in this process
    (``here``)."""
    res = _timed_run([sys.executable, "-m", "kind_tpu_sim_torch",
                      *SIM_STRAGGLER_COMMAND])
    check(res["rc"] in (0, 1) and res["stdout"].strip(),
          f"14 (h) exited {res['rc']}:\n{res['stdout'][-2000:]}\n"
          f"{res['stderr'][-2000:]}")
    rep = json.loads(res["stdout"].strip().splitlines()[-1])
    log(f"14 (h) {' '.join(SIM_STRAGGLER_COMMAND)} alone: rc {res['rc']}, "
        f"{res['wall_s']:.1f} s; {json.dumps(rep, sort_keys=True)}")
    check(res["rc"] == 0 and rep["ok"],
          f"14 (h): the lone straggler grid is not ok: {rep}")
    for key in SIM_SCENARIO_KEYS[SIM_TIMED_SCENARIO]:
        check(rep[key] == here[key],
              f"14 (h) {key}: {rep[key]} against this process's {here[key]}")
    return {"rc": res["rc"], "wall_s": res["wall_s"], "ok": rep["ok"],
            "detection": rep["detection"],
            "recovery_events": rep["recovery_events"]}


# phase 15: the calibrated simulator's commands, run as processes from
# the repository root, and the phase's limit in seconds
SIM15_CALIBRATION = "kind_tpu_sim_torch/calibration/h100.json"
SIM15_COMMANDS = {
    "calibrate": ("fleet", "calibrate", "--bench",
                  "kind_tpu_sim_torch/calibration/bench_h100.json",
                  "--out", "build/h100_check.json"),
    "disagg": ("fleet", "run", "--engine", "sim", "--disagg", "2:2",
               "--requests", "200", "--calibration", SIM15_CALIBRATION,
               "--json"),
    "pool loss": ("chaos", "run", "--scenario", "disagg-pool-loss"),
    "zoo": ("fleet", "run", "--engine", "sim", "--zoo", "--json"),
    "storm": ("chaos", "run", "--scenario", "zoo-swap-storm", "--json"),
    "sched": ("sched", "run", "--manifest",
              "pods/tpu-serving-deployment.yaml", "--json"),
    "train": ("train", "run", "--manifest", "pods/tpu-batch-train-job.yaml",
              "--json"),
    "health": ("health", "demo", "--json"),
    # (l), (m), (o): the tuner's searches and its replay target
    "tune workers": ("fleet", "tune", "--json", "--tune-workers", "2"),
    "globe tune": ("globe", "tune", "--json", "--chaos-budget", "1"),
    "tune replay": ("analysis", "replay", "--scenario", "tune", "--json"),
    # (q): the cluster layer's scenarios over the fake runtime
    "flaky-exec": ("chaos", "run", "--scenario", "flaky-exec"),
    "device-flap": ("chaos", "run", "--scenario", "device-flap"),
    "node-flap": ("chaos", "run", "--scenario", "node-flap"),
}
# (i)-(k): the commands whose output must equal the same run in this
# process
SIM15_HERE = ("sched", "train", "health")
# (n): the winner's spec written by one search and re-scored by another
# process
SIM15_WINNER = "build/tune_winner.json"
SIM15_SPEC_CHAIN = (("fleet", "tune", "--spec-out", SIM15_WINNER),
                    ("fleet", "tune", "--replay-spec", SIM15_WINNER))
# (p): the nvidia cluster's lifecycle over the fake runtime, in a
# directory of its own (create writes kind-config.yaml where it runs)
SIM15_CLUSTER_DIR = "build/cluster15"
SIM15_CLUSTER_CHAIN = (("create", "nvidia", "--runtime", "fake", "-v"),
                       ("status", "--runtime", "fake", "--json"),
                       ("delete", "--runtime", "fake"))
SIM15_STREAM = "-- fake runtime command stream --\n"
# (g): one analytic fleet with the columnar mirror off and on (its knob);
# the per-object run takes about 9 s on a CPU core
SIM15_COLUMNAR = ("fleet", "run", "--engine", "sim", "--replicas", "512",
                  "--requests", "10000", "--rps", "10000", "--policy",
                  "least-outstanding", "--json")
SIM15_COLUMNAR_ENV = {"columnar off": "0", "columnar on": "1"}
SIM15_MAX_S = 30.0


def _cli_stdout(cli, argv) -> tuple:
    """``python -m kind_tpu_sim_torch ARGV`` in this process: its exit
    code and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue()


def _timed_chain(argvs, cwd=None) -> list:
    """``python -m kind_tpu_sim_torch ARGV`` for each of ``argvs`` in
    turn, from ``cwd`` (default: the repository root); each result as
    ``_timed_run`` gives it."""
    import os

    cwd = HERE / (cwd or ".")
    cwd.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(HERE))
    out = []
    for argv in argvs:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "kind_tpu_sim_torch", *argv], cwd=cwd,
            env=env, capture_output=True, text=True,
            timeout=ENTRY_TIMEOUT_S)
        out.append({"rc": res.returncode,
                    "wall_s": time.perf_counter() - t0,
                    "stdout": res.stdout, "stderr": res.stderr})
    return out


def nvidia_cluster_here(cli) -> tuple:
    """``create nvidia`` over the fake runtime in this process, from a
    directory under build/: the command stream as ``-v`` prints it, and
    the kind config it wrote. Changes the working directory for the
    call, so it runs when no other thread is at work."""
    import os

    where = HERE / "build" / "cluster15_here"
    where.mkdir(parents=True, exist_ok=True)
    args = cli.build_parser().parse_args(list(SIM15_CLUSTER_CHAIN[0]))
    before = os.getcwd()
    os.chdir(where)
    try:
        sim = cli.Simulator(cli.config_from_args(args))
        with contextlib.redirect_stdout(io.StringIO()):
            sim.create()
        config = (where / "kind-config.yaml").read_text()
    finally:
        os.chdir(before)
    stream = "".join(f"  {cmd}\n" for cmd in sim.executor.commands())
    return stream, config


def tune_cluster_checks(ran: dict, chains: dict, here: dict) -> dict:
    """Phase 15 (l)-(q): the tuner's and the cluster layer's processes
    held to the runs in this process."""
    res = ran["tune workers"]
    check(res["rc"] == 0 and res["stdout"] == here["tune"]
          and json.loads(res["stdout"])["ok"],
          f"15 (l) fleet tune --tune-workers 2 exited {res['rc']}, or its "
          "report differs from the in-process search's:\n"
          f"{res['stderr'][-2000:]}")
    report = json.loads(res["stdout"])
    log(f"15 (l) {' '.join(SIM15_COMMANDS['tune workers'])}: rc 0, "
        f"{res['wall_s']:.2f} s, {len(res['stdout'])} bytes equal to the "
        f"search in this process with no workers; {report['evaluations']} "
        f"evaluations, winner #{report['winner']['index']}")
    res = ran["globe tune"]
    check(res["rc"] == 0 and res["stdout"] == here["globe tune"]
          and json.loads(res["stdout"])["chaos"]["budget"] == 1,
          f"15 (m) globe tune exited {res['rc']}, or its report differs "
          f"from the in-process search's:\n{res['stderr'][-2000:]}")
    log(f"15 (m) {' '.join(SIM15_COMMANDS['globe tune'])}: rc 0, "
        f"{res['wall_s']:.2f} s, equal to the search in this process")
    spec, replay = chains["spec"]
    winner = json.dumps(report["winner"]["metrics"], sort_keys=True)
    check(spec["rc"] == 0 and spec["stdout"].rstrip().endswith("TUNE OK")
          and replay["rc"] == 0
          and replay["stdout"].strip() == winner,
          f"15 (n) the winner spec round trip: rc {spec['rc']} / "
          f"{replay['rc']}, replayed {replay['stdout'][-2000:]} against "
          f"{winner}\n{spec['stderr'][-1000:]}{replay['stderr'][-1000:]}")
    log(f"15 (n) fleet tune --spec-out {SIM15_WINNER}, then --replay-spec: "
        f"the metrics row equals (l)'s winner's; {spec['wall_s']:.2f} s + "
        f"{replay['wall_s']:.2f} s")
    res = ran["tune replay"]
    rep = json.loads(res["stdout"]) if res["rc"] == 0 else {}
    check(res["rc"] == 0 and rep.get("ok"),
          f"15 (o) analysis replay --scenario tune exited {res['rc']}:\n"
          f"{res['stdout'][-2000:]}{res['stderr'][-2000:]}")
    log(f"15 (o) {' '.join(SIM15_COMMANDS['tune replay'])}: rc 0, ok, "
        f"{rep['events']} events, digest {rep['stream_digest'][:16]}, "
        f"{res['wall_s']:.2f} s")
    create, status, delete = chains["cluster"]
    stream = create["stderr"].partition(SIM15_STREAM)[2]
    patched = [ln for ln in stream.splitlines()
               if ln.startswith("  kubectl patch node")]
    written = (HERE / SIM15_CLUSTER_DIR / "kind-config.yaml").read_text()
    check(create["rc"] == 0 and stream == here["cluster"][0]
          and written == here["cluster"][1] and len(patched) == 2
          and all("/status/capacity/nvidia.com~1gpu" in ln
                  for ln in patched),
          f"15 (p) create nvidia: rc {create['rc']}, its stream differs "
          f"from create in this process, or it does not patch "
          f"nvidia.com/gpu on each worker:\n{create['stderr'][-3000:]}")
    nodes = (json.loads(status["stdout"])["nodes"] if status["rc"] == 0
             else [])
    check(status["rc"] == 0 and len(nodes) == 3 and delete["rc"] == 0,
          f"15 (p) status / delete exited {status['rc']} / "
          f"{delete['rc']}:\n{status['stderr'][-1000:]}"
          f"{delete['stderr'][-1000:]}")
    log(f"15 (p) create nvidia --runtime fake -v in {SIM15_CLUSTER_DIR}: "
        f"rc 0, {len(stream.splitlines())} commands equal to create in "
        f"this process, nvidia.com/gpu patched on {len(patched)} workers; "
        f"status ({len(nodes)} nodes) and delete rc 0; "
        f"{create['wall_s']:.2f} + {status['wall_s']:.2f} + "
        f"{delete['wall_s']:.2f} s")
    for label in ("flaky-exec", "device-flap", "node-flap"):
        res = ran[label]
        check(res["rc"] == 0
              and res["stdout"].rstrip().endswith("CHAOS RUN OK"),
              f"15 (q) chaos run --scenario {label} exited {res['rc']}:\n"
              f"{res['stdout'][-2000:]}{res['stderr'][-2000:]}")
        log(f"15 (q) chaos run --scenario {label}: "
            f"{res['stdout'].strip().splitlines()[-2].strip()}; rc 0, "
            f"{res['wall_s']:.2f} s")
    return {"tune_winner": report["winner"]["index"],
            "tune_replay_digest": rep["stream_digest"],
            "cluster_commands": len(stream.splitlines()),
            "chains_wall_s": {name: [r["wall_s"] for r in results]
                              for name, results in chains.items()}}


def sched_train_here(cli) -> dict:
    """Phase 15's checks that run in this process alone: ``train plan
    --json`` (the optimal cadence among its rows, each row's overhead the
    sum of its parts), ``sched trace`` (the seeded gangs, one JSON line
    each) and every traced gang through ``to_pod_manifest`` and back."""
    from kind_tpu_sim_torch import sched

    rc, text = _cli_stdout(cli, ["train", "plan", "--json"])
    plan = json.loads(text)
    opt = plan["optimal_cadence_steps"]
    rows = plan["cadences"]
    check(rc == 0 and str(opt) in rows and all(
        abs(r["write_frac"] + r["lost_frac"] - r["total_frac"]) < 1e-5
        for r in rows.values()),
          f"15 train plan: rc {rc}, {text[:2000]}")
    rc, text = _cli_stdout(cli, ["sched", "trace"])
    gangs = [sched.SliceRequest(**json.loads(line))
             for line in text.splitlines()]
    check(rc == 0 and len(gangs) == 24
          and gangs == sched.generate_gangs(sched.SchedWorkloadSpec(), 0),
          f"15 sched trace: rc {rc}, {len(gangs)} gangs")
    back = [sched.slice_requests_from_yaml(sched.to_pod_manifest(g))
            for g in gangs]
    check(all(b == [dataclasses.replace(g, arrival_s=0.0)]
              for b, g in zip(back, gangs)),
          "15 to_pod_manifest: a traced gang does not read back")
    log(f"15 train plan: optimal cadence {opt} of rows "
        f"{sorted(int(c) for c in rows)}; sched trace: {len(gangs)} gangs, "
        "each through to_pod_manifest and back")
    return {"optimal_cadence_steps": opt, "traced_gangs": len(gangs)}


def calibrated_sim_phase() -> dict:
    """Phase 15: the calibrated simulator, on the host alone. (b)-(d)
    start first as processes; meanwhile (a) calibrates phase 9's bench
    model block (2 of the flagship's 8 layers, this card) and (c)'s run
    is made in this process. Returns the calibration, the errors and
    the commands' walls."""
    import os

    from kind_tpu_sim_torch import chaos, cli, fleet
    from kind_tpu_sim_torch.fleet import costmodel

    t0 = time.perf_counter()
    out = {}
    with ThreadPoolExecutor(len(SIM15_COMMANDS)
                            + len(SIM15_COLUMNAR_ENV) + 2) as pool:
        running = {label: pool.submit(
            _timed_run, [sys.executable, "-m", "kind_tpu_sim_torch", *argv])
            for label, argv in SIM15_COMMANDS.items()}
        chaining = {
            "spec": pool.submit(_timed_chain, SIM15_SPEC_CHAIN),
            "cluster": pool.submit(_timed_chain, SIM15_CLUSTER_CHAIN,
                                   SIM15_CLUSTER_DIR)}
        for label, value in SIM15_COLUMNAR_ENV.items():
            running[label] = pool.submit(
                _timed_run,
                [sys.executable, "-m", "kind_tpu_sim_torch", *SIM15_COLUMNAR],
                env=dict(os.environ, KIND_TPU_SIM_FLEET_COLUMNAR=value))

        # (a) this run's bench block, as the cost model reads it
        bench = json.loads((HERE / "build" / "chip_smoke_bench.json")
                           .read_text())
        cal = costmodel.calibrate({"model": bench["model"]})
        rates = [cal["prefill"]["analytic_tokens_per_s"],
                 cal["prefill"]["measured_tokens_per_s"]]
        for d in cal["decode"].values():
            rates += [d["analytic_tokens_per_s"], d["measured_tokens_per_s"],
                      d["achieved_gbps"], d["bytes_per_step_mb"]]
        errors = costmodel.CostModel(cal).errors()
        check(all(r > 0 for r in rates)
              and all(math.isfinite(e) for e in errors.values())
              and model_layers(cal) == BENCH_LAYERS,
              f"15 (a): calibration of phase 9's block {cal}")
        log(json.dumps({"calibration_2_of_8_layers": cal}, sort_keys=True))
        log(f"15 (a) phase 9's block ({BENCH_LAYERS} of 8 layers) "
            f"calibrated: errors {errors} (not written over "
            f"{SIM15_CALIBRATION})")
        out["calibration_2_of_8_layers"] = {"calibration": cal,
                                            "errors": errors}

        # (c)'s run in this process
        argv = list(SIM15_COMMANDS["disagg"])
        args = cli.build_parser().parse_args(argv)
        seed = fleet.resolve_seed(args.seed)
        here = fleet.FleetSim(
            cli.fleet_config(args), cli.fleet_trace(args, seed),
            calibration=fleet.load_calibration(
                str(HERE / SIM15_CALIBRATION))).run()
        here.update(seed=seed, engine="sim")

        # (e)'s and (f)'s runs in this process
        args = cli.build_parser().parse_args(list(SIM15_COMMANDS["zoo"]))
        seed = fleet.resolve_seed(args.seed)
        zoo_here = fleet.FleetSim(cli.fleet_config(args),
                                  cli.fleet_trace(args, seed)).run()
        zoo_here.update(seed=seed, engine="sim")
        storm_here = chaos.run_scenario("zoo-swap-storm")

        # (i)-(k) in this process, and the commands that run here alone
        cli_here = {label: _cli_stdout(cli, SIM15_COMMANDS[label])
                    for label in SIM15_HERE}
        out["here"] = sched_train_here(cli)
        # (l) and (m): the same searches in this process, with no workers
        tune_here = {
            "tune": _cli_stdout(cli, ["fleet", "tune", "--json"])[1],
            "globe tune": _cli_stdout(cli, SIM15_COMMANDS["globe tune"])[1]}

        # (h) the generation's HBM, this card's
        total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
        hbm_gib = fleet.load_generation("h100")["hbm_gib"]
        check(round(total_gib, 2) == hbm_gib
              == costmodel.GENERATION_FACTS["h100"]["hbm_gib"],
              f"15 (h): the h100 generation's hbm_gib {hbm_gib} against "
              f"this card's {total_gib:.4f} GiB")
        log(f"15 (h) the h100 generation's hbm_gib {hbm_gib} = this card's "
            f"total_memory {total_gib:.4f} GiB to two places")
        ran = {label: f.result() for label, f in running.items()}
        chains = {name: f.result() for name, f in chaining.items()}
    # (p) in this process, once every process of the pool has ended
    tune_here["cluster"] = nvidia_cluster_here(cli)
    out["tune_cluster"] = tune_cluster_checks(ran, chains, tune_here)

    committed = (HERE / SIM15_CALIBRATION).read_text()
    written = (HERE / "build" / "h100_check.json").read_text()
    cal_errors = costmodel.CostModel(json.loads(written)).errors()
    want_rc = 0 if max(cal_errors.values()) <= costmodel.MAX_ERROR_FRAC \
        else 1
    res = ran["calibrate"]
    log(f"15 (b) {' '.join(SIM15_COMMANDS['calibrate'])}: rc {res['rc']} "
        f"(the 0.15 rule gives {want_rc}), {res['wall_s']:.1f} s; errors "
        f"{cal_errors}")
    check(written == committed,
          f"15 (b): the file fleet calibrate wrote differs from "
          f"{SIM15_CALIBRATION}")
    check(res["rc"] == want_rc and want_rc == 1
          and cal_errors["prefill"] == 0.243129,
          f"15 (b): fleet calibrate exited {res['rc']} with errors "
          f"{cal_errors}, want {want_rc} (prefill 0.243129 over 0.15):\n"
          f"{res['stdout'][-2000:]}\n{res['stderr'][-2000:]}")
    res = ran["disagg"]
    check(res["rc"] == 0, f"15 (c) exited {res['rc']}:\n"
          f"{res['stdout'][-2000:]}\n{res['stderr'][-2000:]}")
    report = json.loads(res["stdout"].strip().splitlines()[-1])
    check(json.dumps(report, sort_keys=True)
          == json.dumps(here, sort_keys=True)
          and report["ok"] and report["completed"] == 200
          and report["disagg"]["calibration_errors"] == cal_errors,
          "15 (c): the disaggregated fleet's report differs from the same "
          "run in this process, or is not ok")
    log(f"15 (c) {' '.join(SIM15_COMMANDS['disagg'])}: rc 0, "
        f"{res['wall_s']:.1f} s, equal to the run in this process; kv "
        f"{json.dumps(report['disagg']['kv'])}; slo attainment "
        f"{report['slo']['attainment']}")
    res = ran["pool loss"]
    check(res["rc"] == 0 and res["stdout"].rstrip().endswith("CHAOS RUN OK"),
          f"15 (d) exited {res['rc']}:\n{res['stdout'][-2000:]}\n"
          f"{res['stderr'][-2000:]}")
    log(f"15 (d) {' '.join(SIM15_COMMANDS['pool loss'])}: "
        f"{res['stdout'].strip().splitlines()[-2].strip()}; rc 0, "
        f"{res['wall_s']:.1f} s")
    res = ran["zoo"]
    check(res["rc"] == 0, f"15 (e) exited {res['rc']}:\n"
          f"{res['stdout'][-2000:]}\n{res['stderr'][-2000:]}")
    report = json.loads(res["stdout"].strip().splitlines()[-1])
    check(json.dumps(report, sort_keys=True)
          == json.dumps(zoo_here, sort_keys=True)
          and report["ok"] and report["config"]["generations"] == ["h100"]
          and set(report["generations"].values()) == {"h100"},
          "15 (e): the zoo fleet's report differs from the same run in "
          "this process, or is not ok")
    log(f"15 (e) {' '.join(SIM15_COMMANDS['zoo'])}: rc 0, "
        f"{res['wall_s']:.1f} s, equal to the run in this process; swaps "
        f"{report['zoo']['swaps']['completed']}, routes "
        f"{json.dumps(report['router']['zoo'])}; slo attainment "
        f"{report['slo']['attainment']}")
    res = ran["storm"]
    storm = json.loads(res["stdout"].strip().splitlines()[-1])
    check(json.dumps(storm, sort_keys=True)
          == json.dumps(storm_here, sort_keys=True)
          and res["rc"] == (0 if storm["ok"] else 1),
          f"15 (f): the storm scenario's report differs from the same run "
          f"in this process, or its exit code {res['rc']} is not its "
          f"verdict's ({storm['ok']}):\n{res['stderr'][-2000:]}")
    log(f"15 (f) {' '.join(SIM15_COMMANDS['storm'])}: rc {res['rc']} (its "
        f"verdict, ok {storm['ok']}), {res['wall_s']:.1f} s, equal to the "
        f"run in this process; p99 steady {storm['p99_steady_s']} s, storm "
        f"{storm['p99_storm_s']} s, ratio {storm['p99_ratio']} (bound "
        f"1.25), swaps {storm['swaps_steady']} / {storm['swaps_storm']}")
    off, on = ran["columnar off"], ran["columnar on"]
    check(off["rc"] == on["rc"] == 0 and off["stdout"] == on["stdout"]
          and json.loads(on["stdout"].strip().splitlines()[-1])["ok"],
          f"15 (g): the columnar fleet exited {off['rc']} / {on['rc']}, or "
          f"its reports differ:\n{off['stderr'][-2000:]}\n"
          f"{on['stderr'][-2000:]}")
    log(f"15 (g) {' '.join(SIM15_COLUMNAR)}: reports byte-equal; wall "
        f"{off['wall_s']:.2f} s per-object, {on['wall_s']:.2f} s columnar")
    for label in SIM15_HERE:
        res = ran[label]
        rc, here_out = cli_here[label]
        check(res["rc"] == rc == 0 and res["stdout"] == here_out
              and json.loads(here_out)["ok"],
              f"15 ({label}) {' '.join(SIM15_COMMANDS[label])} exited "
              f"{res['rc']} (here {rc}), or its output differs from the "
              f"same command in this process:\n{res['stderr'][-2000:]}")
        log(f"15 ({label}) {' '.join(SIM15_COMMANDS[label])}: rc 0, "
            f"{res['wall_s']:.1f} s, {len(here_out)} bytes equal to the "
            "run in this process")
    wall = time.perf_counter() - t0
    check(wall < SIM15_MAX_S,
          f"phase 15 took {wall:.1f} s, over its {SIM15_MAX_S} s")
    out["commands"] = {label: {"rc": r["rc"], "wall_s": r["wall_s"]}
                       for label, r in ran.items()}
    out["hbm_gib"] = {"generation": hbm_gib, "card": total_gib}
    out["zoo_swap_storm"] = {k: storm[k] for k in (
        "ok", "p99_steady_s", "p99_storm_s", "p99_ratio", "swaps_steady",
        "swaps_storm")}
    return out


# the phase walls kept from the last run of this script before admission,
# the solo generators and the train step were compiled programs (NVIDIA
# H100 80GB HBM3, 700.00 W), and that command's wall: printed beside
# this run's
EARLIER_WALLS_S = {"4g int8": 115.1, "4i compiled rounds": 222.0,
                   "11 parallel": 161.7,
                   "12 long context, pipeline, multi-host": 138.4,
                   "9 bench": 287.1, "13 entry points and pods": 35.3}
EARLIER_COMMAND_S = 1151.2


def free_port() -> int:
    """A loopback port free when asked (its socket is closed again)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (HERE / "kind_tpu_sim_torch" / "__init__.py").is_file():
        fail(f"the kind_tpu_sim_torch package is not beside {__file__}")
    sys.path.insert(0, str(HERE))
    from kind_tpu_sim_torch import bench, cli, profiling
    from kind_tpu_sim_torch import profile_serving as flagship
    from kind_tpu_sim_torch import profile_train as trainer
    from kind_tpu_sim_torch.models import quant, serving
    from kind_tpu_sim_torch.models import transformer as tf
    from kind_tpu_sim_torch.ops import _build
    from kind_tpu_sim_torch.ops import flash_attention as fa
    from kind_tpu_sim_torch.ops import int8_matmul as im
    from kind_tpu_sim_torch.ops import paged_attention as pa
    from kind_tpu_sim_torch.ops import toolchain as tc

    check(Path(fa.__file__).resolve().is_relative_to(HERE),
          f"kind_tpu_sim_torch imported from {fa.__file__}, not {HERE}")
    global _TIMELINE
    (HERE / "build").mkdir(exist_ok=True)
    _TIMELINE = open(HERE / "build" / "chip_smoke_timeline.txt", "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} ({smi}); TF32 off for matmul "
        "and cuDNN")
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        # an engine a phase wrapped (SyncCount, a timer) is a reference
        # cycle holding its graphs' pools: collected and handed back to
        # the card here, so the next phase's processes find the memory
        gc.collect()
        torch.cuda.empty_cache()
        walls[name] = time.perf_counter() - t0
        log(f"phase {name}: {walls[name]:.1f} s")
        return result

    lib = phase("1 build", _build.build)
    log(f"build: {lib}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    flash_row = phase("2 flash", flash_phase, fa)
    kernels = [flash_row, phase("2 paged", paged_phase, pa),
               *phase("2 flash backward", flash_bwd_phase, fa, flash_row)]
    int8_row = phase("2 int8", int8_phase, im, quant)
    phase("3 small", small_phase, tf, serving, fa, pa)
    phase("3 small int8 and MoE", small_int8_moe_phase, tf, serving, quant,
          fa, pa, im)
    cfg = flagship.flagship_config()
    t0 = time.perf_counter()
    sp = flagship.flagship_params(cfg)
    n_params = sum(x.numel() for x in [sp["embed"], sp["final_norm"]]
                   + [w for b in sp["blocks"] for w in b.values()])
    log(f"flagship params: {n_params} (bf16 serving snapshot), set up in "
        f"{time.perf_counter() - t0:.2f} s")
    launches, serve_routes, streams = phase(
        "4 serve", serve_phase, flagship, serving, fa, pa, sp, cfg)
    realistic = phase("4b realistic", realistic_phase, flagship, serving, fa,
                      pa, sp, cfg)
    phase("4c hit against cold", hit_vs_cold_phase, flagship, serving, sp,
          cfg)
    phase("4d long prompt", longprompt_phase, flagship, serving, sp, cfg)
    spec = phase("4e speculative", spec_phase, flagship, serving, tf, fa, pa,
                 sp, cfg, streams)
    surface = phase("4f engine surface", surface_phase, flagship, serving,
                    tf, fa, pa, sp, cfg, streams)
    int8_serving = phase("4g int8", int8_serving_phase, flagship, serving, tf,
                         quant, fa, pa, im, sp, cfg)
    moe = phase("4h MoE", moe_serving_phase, flagship, serving, tf, fa, pa,
                cfg)
    phase("4i compiled rounds", compiled_rounds_phase, flagship, serving, tf,
          quant, fa, pa, im, cfg)
    parallel = phase("11 parallel", parallel_phase, flagship, trainer,
                     serving, tf, fa, pa, im, sp, cfg)
    del sp
    long_ctx = phase("12 long context, pipeline, multi-host",
                     long_context_phase, trainer, tf, fa)
    phase("5 small train", small_train_phase, tf, fa)
    phase("5 small MoE train", small_moe_train_phase, tf, fa)
    train_launches, train_plain = phase("6 train", train_phase, trainer, fa)
    phase("6 remat", train_remat_phase, trainer, fa, train_plain)
    phase("6b MoE train", train_moe_phase, trainer, tf, fa, train_plain)
    toolchain_rows = phase("7 toolchain", toolchain_phase, tc)
    phase("8 train-smoke", train_smoke_phase, cli)
    bench_routes, entry_routes = phase("9 bench", bench_phase, bench, fa,
                                       pa, im)
    phase("10 profile", profile_phase, profiling, flagship)
    entry = phase("13 entry points and pods",
                  lambda: entry_points_phase(entry_runs()))
    sim = phase("14 simulator engine paths", sim_engine_phase, fa, tf,
                flagship.flagship_config())
    phase("15 calibrated simulator", calibrated_sim_phase)
    # the forward and paged kernels' counts come from serving, the
    # backward kernels' from training (the forward's there is checked),
    # the int8 kernel's from 4g's solo W8A8 decode, the toolchain
    # kernels' from toolchain_smoke
    launches.update({name: n for name, n in train_launches.items()
                     if name not in launches})
    launches["int8_matmul"] = int8_serving["w8a8_launches"]
    flash_row.update({
        "launches_by_route": serve_routes["flash_attention"],
        "realistic_launches_by_route": realistic["routes"]["flash_attention"],
        "speculative_launches_by_route": spec["flash_launches_by_route"],
        "surface_launches_by_route": surface["flash_launches_by_route"],
        "moe_launches_by_route": moe["flash_launches_by_route"],
        "train_launches_by_route": train_plain["routes"]["flash_attention"]})
    int8_row["launches_by_route"] = int8_serving["w8a8_launches_by_route"]
    # phase 14: the flash kernels on the simulator's engine paths
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
            k["sim_launches_by_route"] = {
                label: x["launches_by_route"][k["name"]]
                for label, x in sim.items()
                if "launches_by_route" in x
                and sum(x["launches_by_route"][k["name"]].values())}
    # the kernels at the shapes one rank of a mesh gives them (phase 11)
    sharded = parallel["kernels"]
    flash_row["sharded_shapes"] = {key: x["forward"]
                                   for key, x in sharded.items()
                                   if "forward" in x}
    for k in kernels:
        kind = {"flash_attention_bwd_dq": "dq",
                "flash_attention_bwd_dkv": "dkv"}.get(k["name"])
        if kind is not None:
            k["sharded_shapes"] = {key: x[kind] for key, x in sharded.items()
                                   if kind in x}
    int8_row["sharded_shapes"] = sharded["int8 cache kv 2"]
    # phase 12: the flash forward a pipeline stage runs at its microbatch
    # shape, and the kernels of attention over the gathered sequence
    gathered = long_ctx["seq_train"]["gathered"]
    flash_row["pipeline_launches_by_route"] = {
        key: x["ranks"] for key, x in long_ctx["pipeline"].items()
        if key != "ranks"}
    flash_row["seq_gathered_launches_by_route"] = {
        "forward": gathered["forward_launches_by_route"],
        "train_step": gathered["train_launches_by_route"]["flash_attention"]}
    for k in kernels:
        if k["name"] in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            k["seq_gathered_launches_by_route"] = (
                gathered["train_launches_by_route"][k["name"]])
    kernels.append(int8_row)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "paged_attention":
            k["launches_by_route"] = serve_routes["paged_attention"]
            k["realistic_launches_by_route"] = (
                realistic["routes"]["paged_attention"])
        elif k is not flash_row and k["name"] in train_plain["routes"]:
            k["launches_by_route"] = train_plain["routes"][k["name"]]
    for k in kernels:
        if k["name"] in bench_routes:
            k["bench_launches_by_route"] = bench_routes[k["name"]]
            k["bench_entry_launches_by_route"] = {
                key: routes[k["name"]] for key, routes in entry_routes.items()
                if k["name"] in BENCH_ENTRY_ROUTES[key]}
    # row 8's pod: the kernel pod's own inline kernel (phase 13)
    toolchain_rows[0]["pod"] = entry["pod"]
    kernels += toolchain_rows
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the main paths was never launched")
    log(json.dumps({"phase_wall_s": walls}))
    log("phase walls beside the earlier run's: " + ", ".join(
        f"{name} {walls[name]:.1f} s ({EARLIER_WALLS_S[name]:.1f} s)"
        for name in EARLIER_WALLS_S)
        + f"; phases {sum(walls.values()):.1f} s in all (the earlier "
        f"command {EARLIER_COMMAND_S:.1f} s)")
    # phase 4i serves 32 streams at the flagship's width, 8 of them with
    # eager rounds, and traces 16 rounds
    log(f"phases: {sum(walls.values()):.1f} s in all, "
        f"{walls['4i compiled rounds']:.1f} s of them phase 4i (compiled "
        "rounds against eager ones)")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    log(json.dumps({"kernels": [
        {**{key: k[key] for key in order},
         **{key: x for key, x in k.items() if key not in order}}
        for k in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    _TIMELINE.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
