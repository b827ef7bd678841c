#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

1. env      torch and CUDA versions, the card's name and power limit;
2. build    the kernels, compiled from ``src/repro_torch/kernels/csrc``,
            with each kernel's registers, spills and shared memory as
            ``nvcc -Xptxas -v`` reports them;
3. kernel_checks
            each hand-written kernel against its plain PyTorch version on
            the same CUDA tensors, at the main path's shapes and at the
            "medium" shape of ``benchmarks/bench_kernels.py``: ef_sparsify
            bitwise, ota_project and its adjoint ota_project_t at
            rtol = atol = 3e-5 (Rademacher and Gaussian entries; the
            adjoint bitwise with Rademacher entries), amp_fused
            at rtol 1e-4 / atol 1e-5, two runs bitwise and an ``id_offset``
            sub-range bitwise; amp_fused with a leading point axis, G = 4
            points of the main shape in one launch, bitwise with its plain
            version and with four G = 1 launches, beside the clusters the
            card holds at once (``cudaOccupancyMaxActiveClusters``); and
            the (G, M) rows a sweep's grid hands ef_sparsify and
            ota_project, bitwise with G calls of M rows; and amp_fused on
            the observations a poisoned frame leaves (one NaN, +Inf or
            -Inf in block 0, at G = 1 and in one point of G = 4): the
            plain version's NaN pattern, its other entries bitwise, every
            clean block and point bitwise the clean decode; and
            ``cohort_widths``: ota_project at 20 and 64 devices (x 2 x
            4096 -> 1024, Rademacher) and ef_sparsify at 64 x 7850, the
            local and population paths' widths, bitwise; and
            ``sharded_shapes``: one rank's ota_project (1 x 1 x 4096 ->
            1024, a shard-folded seed, bitwise) and one-block amp_fused,
            and amp_fused at every id_offset 1-24 (a noisy and a zero
            block, bitwise).  Each record times
            the kernel four ways:
            ``kernel_ms`` per call (median of single calls between CUDA
            events, Python wrapper included); ``graph_device_ms``, the
            kernel's own device time (50 calls captured in one CUDA graph,
            the graph replayed, the time over the calls: no host work
            between the kernels); ``device_ms``, the rate of 50
            back-to-back wrapper calls between one event pair, which is
            the host's enqueue rate wherever the wrapper takes longer than
            the kernel; and ``host_us``, the host's time per wrapper call
            (1000 calls with no synchronise).  ``bound_share`` is
            ``bound_ms / graph_device_ms``: above 1 where the inputs sat in
            the 50 MB L2 across the replayed calls.  Each ``torch.bmm``
            yardstick has ``library_ms``, ``library_device_ms`` and
            ``library_graph_ms`` the same way;
4. slice    the port's ``run_federated`` at the paper's full scale: the
            single-layer model (d = 7850) on the MNIST surrogate, M = 25
            devices of B = 1000 samples, 60 000 / 10 000 samples, blocked
            A-DSGD with ``ota_overrides("mnist_mlp")`` and ``use_kernel``,
            20 AMP iterations, 20 rounds.  ef_sparsify, ota_project and
            amp_fused must each launch in that run, the test loss must
            fall, and the first round's gradient estimate must equal the
            plain path's;
5. unfused_decode
            the launch-per-op AMP decode (``amp_decode_blocked``) on a
            ``use_kernel`` projector at the slice's decode shape (2 blocks,
            1024 -> 4096, 20 iterations, noisy y): exactly 20 launches of
            ota_project_t and 21 of ota_project, and the result within
            rtol 1e-4 / atol 1e-5 of the plain projector's decode and of
            the fused kernel's; its time beside both, per call and by
            CUDA-graph replay (``unfused_graph_ms``, ``fused_graph_ms``:
            10 decodes captured in one graph);
6. engine   the port's ``run_compiled`` at the slice's scale and config:
            its accuracies and losses equal the slice phase's
            ``run_federated`` run, a checkpointed run stopped at round 10
            and resumed equals the uninterrupted one bitwise, no host sync
            inside the loop, and its ms per round;
7. sweep    the port's ``run_sweep`` at the slice's scale and config over
            the paper's five schemes x P-bar in {50, 200, 500, 1000}, 20
            rounds: five static groups of G = 4 points, each one batched
            round per step (``CompiledExperiment.run_grid``).  Every record
            equals that point's own ``run_compiled`` (accuracies and losses
            bitwise, all five schemes); the
            a_dsgd group launches ef_sparsify, ota_project and amp_fused
            once per round for all four points, the other groups none.  Per
            scheme: ms per batched round and the same point's ms per round
            alone (CUDA events, steady state), launches, final accuracies;
8. channel  the channel axes at the slice's scale and config: Rayleigh
            truncated inversion (iid, threshold 0.3), the Gauss-Markov
            process (rho 0.95, W = 64), noisy CSI (csi_err_var 0.1), blind
            transmitters (K = 2 PS antennas), each through run_federated
            and run_compiled (entry for entry equal) and a checkpointed
            run_compiled stopped at round 10 and resumed (bitwise); and the
            disk geometry (radius 800 m, gamma 3) with the prop_fair
            scheduler on 2 subbands, through run_compiled and its resume
            only (the looped driver refuses a scheduler).  Every run
            launches ef_sparsify, ota_project and amp_fused once a round;
            csi_err_var = 0 is bitwise Rayleigh; two sweep groups (the
            csi_err_var grid, G = 4, and cell_radius x 3 under gain_ranked
            for each of 1 and 2 subbands, G = 3 each) equal their points'
            own runs.  Per config: ms per round of run_compiled timed in
            turns with the AWGN slice's, and for the Gauss-Markov round the
            ms of its RNG draws and of its channel draw;
9. robust   the robustness axis at the slice's scale and config: Fig. 11's
            analog cell (sign-flip attackers at byzantine_frac 0.1, 20x,
            with and without the transmit power cap at 1.5 P_t), whose
            byz_frac metric must be the share of the Byzantine set drawn on
            the CPU and which at byzantine_frac 0 must be the AWGN
            run_compiled bitwise; NaN frames at fault_rate 0.1 under the
            round guard, where the skipped rounds must be exactly those the
            fault draws poison (computed on the CPU) and a checkpointed run
            stopped at round 10 and resumed must be bitwise; Fig. 11's
            digital cell (D-DSGD at byzantine_frac 0.3 with the norm cap,
            and a trimmed mean); and run_sweep over byzantine_frac in {0,
            0.1, 0.3} x clip_power, two groups of G = 3, each record equal
            to its own run_compiled and each group launching the three
            kernels once per batched round.  Per run: ms per round beside
            the AWGN slice's, timed in turns;
10. local   Fig. 12's analog grid (``benchmarks/fig12_local.py``) at the
            slice's config: a Dirichlet beta = 0.25 split over M = 20
            devices of B = 100, local_lr 0.6, prox_mu 0.5, dyn_alpha 0.1,
            P-bar 50 000, run_sweep over local in {fedavg, fedprox, feddyn}
            x local_epochs in {1, 2, 4}, 20 rounds: three groups of G = 3,
            each launching the three kernels once per batched round, every
            record equal to its own run_compiled; local=sgd compiled for 2
            epochs and run at E = 1 is device_grads bitwise, and its grid
            record the AWGN run_compiled.  Per group: ms per batched round
            beside the E = 4 point's lone run and the AWGN round, in turns;
11. population
            the sampled-cohort engine at the slice's config: K == M = 25 on
            the slice's data is run_compiled bitwise; Fig. 10 FULL's
            largest sampled point (``benchmarks/fig10_scaling.py``: M =
            100 000, K = 64, B = 64, capacity 8192, IID population_partition
            of the 60 000-sample surrogate), its bank bytes, peak memory,
            ms per round beside the AWGN round's; the same population with
            avail_rate 0.9, speed_sigma 0.5, straggler_deadline 5.0 and
            four edge sites (the mac hook must run once a round);
            run_population_sweep over avail_rate in {0.5, 0.9, 1.0}, each
            record its own run_population; and a FedDyn population run
            stopped at round 10 and resumed, bitwise the uninterrupted run;
12. sharded the slice's round through the sharded slice drivers on a mesh
            of rank threads (``repro_torch.sharding``), at the slice's
            config and full width, with device_grads and Adam at the PS:
            (a) ``sharded_round`` on 25 device rows x 2 shards (50 rank
            threads, d_pad 8192, one 4096 block per shard), 20 rounds;
            (b) the same with ``shard_decode`` (rows 1-24 decode padded
            blocks at id_offset 1-24); (c) ``round_sharded`` on 25 ranks;
            (d) ``sharded_round`` with five edge sites of five and
            ``site_mac``; (e) a bfloat16 frame body; (b)-(e) 5 rounds
            each.  One launch per rank and round: 50 of each main-path
            kernel in (a), (b), (d), (e), 25 in (c).  (a), (b), (c) bitwise their plain runs on the card (the
            first 5 rounds), (b) bitwise (a), two runs of (a) bitwise; and
            (f) a 2 x 2 gloo process group of four processes on the card,
            3 rounds, bitwise the thread mesh at 2 x 2.  Per run: test
            accuracy, ms per round (CUDA events, median) and, in turns, one
            sharded round beside the simulated slice's round;
13. fedllm the streamed federated LLM round (``train/fedllm.py``,
            ``CompiledFedLLM``) at smollm-360m's published widths (d =
            361 821 120, seeded random weights), ``TrainConfig()`` defaults
            (bfloat16 compute, remat, Adam with warmup),
            ``ota_overrides("smollm_360m")`` with use_kernel: (a) m = 4
            devices of 2 x 16 tokens, chunk_size 2**22 (87 chunks of 1024
            blocks), one warm-up round and 2 timed rounds through
            ``run_segment``, each with exactly 87 launches of ef_sparsify,
            ota_project and amp_fused; ms per round by CUDA events, its
            split into gradients, stream and Adam, peak allocated memory,
            finite losses; (b) on those gradients the first two chunks'
            ``stream_round`` bitwise its use_kernel=False run and its
            ``stream_round_ref`` on the card; (c) the default chunk_size
            2**14: ``stream_round`` over the first 64 chunks, ms per chunk
            and that times 22 084 as the projected round;
14. fedllm_moe
            the same streamed round at granite-moe-1b-a400m's published
            widths (d_model 1024, 16 q / 8 kv heads of 64, 32 experts
            top-8 of width 512, vocab 49 155, tied embeddings) with the
            depth cut to 16 of its 24 layers, the one cut (the whole model
            would need ~88 GB at ~64 bytes a parameter): d = 906 530 816,
            217 chunks of 2**22; one warm-up round and one timed round
            through ``run_segment`` with exactly 217 launches of
            ef_sparsify, ota_project and amp_fused and none of
            ota_project_t; finite losses, metrics and MoE aux; the split of
            a further round; peak allocated memory; the first two chunks
            bitwise the plain run and ``stream_round_ref``.  Then one
            device's bfloat16 loss and gradient (remat on, seeded weights,
            2 x 16 tokens) of rwkv6-3b at 2 layers and of zamba2-7b at 7
            (6 Mamba2 layers, the shared block once, one tail layer), at
            their published widths: finite, ms and peak memory;
15. serve    (a) ``serve_while_train`` on smollm-360m at its published
            widths with the fedllm phase's training settings (m = 4, 2 x
            16 tokens, chunks of 2**22, ``use_kernel``): 2 rounds, and
            between them a batch of 8 requests (a 16-token prompt, 16
            greedy tokens) in ``make_serve_step``'s defaults (bfloat16
            compute and caches): ms per round, of publish, of the prefill
            and per decoded token, tokens a second while training, peak
            memory, 87 launches of each main-path kernel a round and 0 of
            ``ota_project_t`` (the decode launches none), ``publish_bitwise``,
            the first chunks of a further round bitwise the plain run, and
            a float32 decode batch from the last round's params on the
            card and on the CPU port, fed the same tokens: logits within
            1e-5 of their largest magnitude, the same greedy tokens; (b)
            bfloat16 decoding alone at full depth and published widths on
            seeded weights (layer 0 from the model's init, every other
            layer a seeded shuffle of its entries): rwkv6-3b
            (32 layers), zamba2-7b (81 layers, 13 shared attention caches)
            and whisper-base (the encoder over its 1500 frames), batch 4,
            a 16-token prefill and 16 tokens: ms per token, peak memory,
            finite logits;
16. trainer the sharded trainer (``train/trainer.py``): (a)
            ``make_train_step`` on smollm-360m at its published widths (d
            = 361 821 120, seeded weights from ``init_state``),
            ``TrainConfig()`` (bfloat16 compute, remat, Adam),
            ``ota_overrides("smollm_360m")`` with use_kernel and
            shard_decode (blocks of 4096 -> 1024, 20 AMP iterations; d_pad
            361 824 256, 44 168 blocks a model shard), a 4 x 2 mesh of
            rank threads (data x model, ota_axes ("data",)) and
            ``TokenStream(vocab, 64, 16)``, launch/train.py's batch: one
            untimed step and two timed ones, each with exactly 8 launches
            of ef_sparsify, ota_project and amp_fused (one a rank) and
            none of ota_project_t; ms a step and its split into
            gradients, aggregation and update, tokens a second, peak
            allocated memory, finite losses, the frame power within 1 % of
            P_t; a ``torch.profiler`` trace of one more step's
            aggregation (device busy share, top kernels); the three
            kernels at one rank's shapes of (a) and of each mesh of (c2)
            (4 x 2 at 32 layers: 1 x 180 912 128 of ef_sparsify, bitwise
            plain, 1 x 44 168 blocks of ota_project, 11 042 of amp_fused;
            2 x 2 at 24: 1 x 141 582 336, 34 566, 17 283; 2 x 1 at 32: 1 x
            361 824 256, 88 336, 44 168; the projection's first and last
            16 blocks and the decode's first 16 bitwise plain; ms, bound
            and share); (b)
            smollm-360m reduced, 3 steps, flat and sliced: the
            kernels against use_kernel=False, ĝ of every step, the error
            state and the params bitwise, and shard_decode on against off,
            ĝ bitwise; (c) the step on a mesh of processes
            (``sharding.init_process_mesh``, gloo, a ``file://`` store,
            one process a rank on the one card, started after the build):
            (c1) (b)'s kernel runs on a 4 x 2 mesh of 8 processes, flat
            and sliced, every process's ĝ of every step, params, block of
            the error state and metrics bitwise (b)'s thread mesh, with
            one launch of ef_sparsify, ota_project and amp_fused a step in
            each process (two in the sliced layout); (c2) (a)'s config on
            a 2 x 2 mesh of 4 processes at 24 of the 32 layers (d =
            283 162 560; four processes at 32 layers need more than the
            card's memory), then on a 2 x 1 mesh of 2 at all 32, each: the first step's global_loss and the SHA-256 of every
            process's ĝ equal to one thread-mesh step's on the same mesh,
            run in this process once they end; two timed steps: per process
            ms a step and its split (with the host-staged ``scatter`` of
            the gradient blocks and ``gather`` of ĝ), tokens a second,
            peak allocated and reserved memory, the card's used memory,
            one launch of each main-path kernel a step, finite losses, the
            frame power within 1 % of P_t;
17. benchmarks
            the port's benchmark scripts (``repro_torch.benchmarks``): (a)
            ``bench_kernels`` at its full sizes (64 x 1024 -> 256, 10 AMP
            iterations; 256 x 4096 -> 1024, 20), every kernel path within
            its bar of the plain path and one launch per call (its own
            checks), the per-op ms of both paths, and each kernel's graph
            ms, bound and share at those sizes; (b) ``bench_sweeps`` at its
            default size, the looped runs equal to the batched grid; (c)
            Fig. 2 at ``FULL=1`` (the paper's M = 25, B = 1000, T = 300,
            dense projection) through ``python -m
            repro_torch.benchmarks.run fig2``: the ten series' final
            accuracies and ms per round, and the IID ordering ideal >=
            a_dsgd >= d_dsgd beside the paper's claim; (d) the Theorem 1
            rows.  (a) and (b) write ``BENCH_torch_kernels.json`` and
            ``BENCH_torch_sweeps.json`` at the checkout's root; beside each
            projection row, one ``torch.bmm`` on A materialised beforehand
            (``library_ms`` per call, ``library_graph_ms`` by replay);
18. dryrun the dry run and the roofline (``launch/dryrun.py``,
            ``benchmarks/roofline.py``), steps traced on ``meta`` tensors
            and counted per device, no kernel launched: (a) the production
            mesh: smollm-360m at prefill_32k, decode_32k and long_500k on
            16 x 16 in this process (``torch.cuda.memory_allocated()`` the
            same before and after), and its train_4k on 16 x 16 and 2 x 16
            x 16, granite-moe-1b-a400m's train_4k and decode_32k on 16 x
            16 in a process of its own with no card visible, started after
            the build so that its minutes of tracing overlap the phases
            between; each record's flops, bytes, collective bytes, memory
            per device and trace seconds, and its roofline row on the
            H100's peaks; (b) phase 16's own step (smollm-360m, 4 x 2 rank
            threads, 16 x 64 tokens, use_kernel and shard_decode) traced:
            the whole thread mesh's work over one card's peaks beside the
            measured step and its split, each kernel's ``cost.py`` bound
            times its calls beside phase 16's per-call times, and the
            trace's peak live bytes beside the measured peak.  Nothing in
            (b) is a bar; a failed record fails the phase;
19. kernels the per-kernel record: route, source, the TPU kernel it
            replaces, launches on its path (and on every path), error,
            times and bound.

The kernel_checks line's ``streamed_shapes`` holds the kernels at the
fedllm phase's shapes, each bitwise its plain version: ef_sparsify on 4 x
16 384 and 4 x 4 194 304, ota_project on 4 x 4 and 4 x 1024 blocks of
4096 -> 1024, amp_fused on 4 and 1024 blocks (the shapes of a 2**22
chunk time with fewer repetitions: a call takes tens of ms).

Each path (slice, unfused_decode, engine, sweep, channel, robust, local,
population, each run of sharded, fedllm's and fedllm_moe's timed rounds,
serve's rounds, the trainer's timed steps, each of its process mesh's
runs in its own process, bench_kernels) runs with every launch count set
to 0 just before it and read just after.

The card's name and power limit are printed again before the last line,
which is ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero; without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

STEPS = 20
WARMUP, REPS = 3, 20
#: back-to-back launches between one event pair for ``device_ms``, and
#: calls captured in one CUDA graph for ``graph_device_ms``
DEVICE_REPS = 50
#: replays of that graph between one event pair
GRAPH_REPLAYS = 10
#: whole decodes captured in one CUDA graph for the unfused_decode phase
DECODE_GRAPH_CALLS = 10
#: wrapper calls timed on the host's clock for ``host_us``
HOST_CALLS = 1000

_SOURCES = "src/repro_torch/kernels"
KERNELS = {
    "ef_sparsify": dict(
        source=f"{_SOURCES}/csrc/ef_sparsify.cu",
        replaces="src/repro/kernels/ef_sparsify.py:28 ef_sparsify_pallas"),
    "ota_project": dict(
        source=f"{_SOURCES}/csrc/ota_project.cu",
        replaces="src/repro/kernels/ota_project.py:134 ota_project_pallas"),
    "ota_project_t": dict(
        source=f"{_SOURCES}/csrc/ota_project_t.cu",
        replaces="src/repro/kernels/ota_project.py:173 ota_project_t_pallas"),
    "amp_fused": dict(
        source=f"{_SOURCES}/csrc/amp_fused.cu",
        replaces="src/repro/kernels/amp_fused.py:72 amp_decode_fused_pallas"),
}
#: the path each kernel's ``launches`` is read from, and the kernels each
#: path must launch
KERNEL_PATH = {"ef_sparsify": "slice", "ota_project": "slice",
               "ota_project_t": "unfused_decode", "amp_fused": "slice"}
PATH_KERNELS = {"slice": ("ef_sparsify", "ota_project", "amp_fused"),
                "fedllm": ("ef_sparsify", "ota_project", "amp_fused"),
                "fedllm_moe": ("ef_sparsify", "ota_project", "amp_fused"),
                "serve": ("ef_sparsify", "ota_project", "amp_fused"),
                "unfused_decode": ("ota_project", "ota_project_t"),
                "engine": ("ef_sparsify", "ota_project", "amp_fused"),
                "sweep": ("ef_sparsify", "ota_project", "amp_fused"),
                "channel": ("ef_sparsify", "ota_project", "amp_fused"),
                "robust": ("ef_sparsify", "ota_project", "amp_fused"),
                "local": ("ef_sparsify", "ota_project", "amp_fused"),
                "population": ("ef_sparsify", "ota_project", "amp_fused"),
                "sharded": ("ef_sparsify", "ota_project", "amp_fused"),
                "trainer": ("ef_sparsify", "ota_project", "amp_fused"),
                "benchmarks": ("ota_project", "ota_project_t", "amp_fused")}
#: the sweep phase's grid: the paper's schemes x P-bar, G = 4 points a group
SWEEP_P_AVG = (50.0, 200.0, 500.0, 1000.0)
#: point counts at which the point-axis amp_fused is also timed
POINT_SCALING = (1, 2, 3, 4, 6, 8)
#: the channel phase's configurations, each over the slice's config: Fig.
#: 9's fading schemes and Fig. 13 panel B's geometry with prop_fair
CHANNEL_RUNS = {
    "fading_iid": dict(scheme="a_dsgd_fading", fading_process="iid",
                       fading_threshold=0.3),
    "fading_gauss_markov": dict(scheme="a_dsgd_fading",
                                fading_process="gauss_markov",
                                fading_rho=0.95, fading_window=64),
    "csi_err": dict(scheme="a_dsgd_csi_err", csi_err_var=0.1),
    "blind": dict(scheme="a_dsgd_blind", ps_antennas=2),
    "geometry_prop_fair": dict(scheme="a_dsgd", fading="rayleigh",
                               geometry="disk", cell_radius=800.0,
                               path_loss_exp=3.0, scheduler="prop_fair",
                               n_subbands=2),
}
CHANNEL_CSI_GRID = (0.0, 0.1, 0.4, 0.8)
#: the robust phase's grid of Byzantine fractions (Fig. 11's axis)
ROBUST_FRACS = (0.0, 0.1, 0.3)
CHANNEL_RADII = (100.0, 400.0, 1600.0)
#: the local phase: Fig. 12's analog grid (benchmarks/fig12_local.py), a
#: Dirichlet beta = 0.25 split over M = 20 devices of B = 100 samples
LOCAL_ALGOS = ("fedavg", "fedprox", "feddyn")
LOCAL_EPOCHS = (1, 2, 4)
LOCAL_M, LOCAL_B, LOCAL_BETA = 20, 100, 0.25
LOCAL_LR, PROX_MU, DYN_ALPHA, LOCAL_P_AVG = 0.6, 0.5, 0.1, 50_000.0
#: the population phase: Fig. 10 FULL's largest sampled point
#: (benchmarks/fig10_scaling.py): M = 100 000, K = 64, B = 64, capacity 8192
POP_M, POP_K, POP_B, POP_CAPACITY = 100_000, 64, 64, 8192
POP_AVAIL_GRID = (0.5, 0.9, 1.0)
#: the sharded phase: the slice's round through both slice drivers on a
#: mesh of rank threads at full width: 25 device rows x 2 shards of the
#: padded d = 8192 (one 4096 block per shard) for sharded_round, 25 devices
#: of d = 7850 for round_sharded
SHARDED_M, SHARDED_SHARDS, SHARDED_D_PAD = 25, 2, 8192
#: run (d)'s five edge sites of five devices
SHARDED_GROUPS = tuple(tuple(range(5 * i, 5 * i + 5)) for i in range(5))
#: rounds of runs (b)-(e), of the plain runs and of the repeat of (a),
#: each held against the first rounds of its counterpart (run (a) takes
#: STEPS): a thread per rank multiplies the round's host-bound launches
#: by the rank count
SHARDED_SHORT = 5
#: rounds of the 2 x 2 process-group mesh held against the thread mesh
PG_ROUNDS = 3
#: the fedllm phase: smollm-360m at its published widths, the reference's
#: CompiledFedLLM defaults (m = 4, batch 2, seq 16), chunks of 2**22 (87 a
#: round), one warm-up round and two timed ones; the default 2**14 chunk
#: is timed over its first 64 chunks of a round's 22 084
FEDLLM_ARCH = "smollm_360m"
FEDLLM_M, FEDLLM_BATCH, FEDLLM_SEQ = 4, 2, 16
FEDLLM_CHUNK, FEDLLM_CHUNKS = 1 << 22, 87
FEDLLM_ROUNDS = 2
FEDLLM_D = 361_821_120
FEDLLM_DEFAULT_CHUNK, FEDLLM_DEFAULT_CHUNKS = 1 << 14, 22_084
FEDLLM_TIMED_CHUNKS = 64
#: chunks of the 2**22 stream held bitwise against the plain run
FEDLLM_PLAIN_CHUNKS = 2
#: the fedllm_moe phase: granite-moe-1b-a400m at its published widths, 16
#: of its 24 layers (the peak-memory cut), the fedllm phase's m, batch,
#: tokens and chunk; one warm-up round and one timed one
MOE_ARCH, MOE_LAYERS = "granite_moe_1b_a400m", 16
MOE_D, MOE_CHUNKS, MOE_ROUNDS = 906_530_816, 217, 1
#: one device's loss and gradient at published widths, depth cut
WIDE_DEPTHS = (("rwkv6_3b", 2), ("zamba2_7b", 7))
#: the serve phase: the fedllm phase's training, and between its rounds a
#: batch of requests of a prompt and greedy tokens; the float32 batch's bar
#: against the CPU port (tests/test_torch_serve.py's float32 bar)
SERVE_ROUNDS, SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 2, 8, 16, 16
SERVE_F32_BAR = 1e-5
#: decoding alone at full depth: the archs, batch, prompt and tokens
SERVE_WIDE = ("rwkv6_3b", "zamba2_7b", "whisper_base")
SERVE_WIDE_BATCH = 4
#: the trainer phase: smollm-360m's train step at its published widths on
#: a 4 x 2 mesh of rank threads (data x model), launch/train.py's batch of
#: 16 x 64 tokens, one untimed step and two timed ones; the padded d (a
#: multiple of the 4096 block x 2 model shards) and the launches a step
#: (one of each main-path kernel per rank)
TRAIN_MESH = ((4, 2), ("data", "model"))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 16, 64, 2
TRAIN_D_PAD = 361_824_256
TRAIN_LAUNCHES = {"ef_sparsify": 8, "ota_project": 8, "ota_project_t": 0,
                  "amp_fused": 8}
#: blocks of one rank's full-width kernel calls held bitwise against the
#: plain versions
TRAIN_CHECK_BLOCKS = 16
#: the reduced runs held bitwise on the card: steps, batch and tokens,
#: and the settings of the reference's tests/test_distributed.py
TRAIN_REDUCED_STEPS, TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SEQ = 3, 8, 32
TRAIN_REDUCED_OTA = dict(scheme="a_dsgd", projection="blocked",
                         block_size=512, s_frac=0.25, k_frac=0.5,
                         rademacher=True, p_avg=500.0, total_steps=50,
                         amp_iters=10, mean_removal_steps=3)
TRAIN_REDUCED_CFG = dict(optimizer="adam", lr=1e-3, warmup_steps=0,
                         total_steps=50, compute_dtype="float32", remat=True)
#: (c), the step on a mesh of processes: the reduced runs' 4 x 2 mesh of 8
#: processes, and the published widths (c2) on (dims, layers): 2 x 2 of 4
#: at 24 of smollm-360m's 32 layers, since each process holds its own
#: params, Adam state, ĝ and round transients and four of them at 32
#: layers ran out of the card (PERF.md, section 5), and 2 x 1 of 2 at all
#: 32 (the two peak at ~35 GB reserved each); each process launches one of
#: each main-path kernel a step (two in the sliced layout); a process's
#: gloo timeout
TRAIN_PG_FULL = (((2, 2), 24), ((2, 1), 32))
TRAIN_PG_LAUNCHES = {"ef_sparsify": 1, "ota_project": 1, "ota_project_t": 0,
                     "amp_fused": 1}
TRAIN_PG_TIMEOUT = 300


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = WARMUP, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def alternating_ms(fn_a, fn_b, reps: int = 4):
    """Medians of CUDA-event timings of ``fn_a()`` and ``fn_b()``, timed in
    turns (a, b, b, a, ...) after one warm-up call each, so that a drift of
    the host's speed during the measurement falls on both alike."""
    import torch
    fn_a()
    fn_b()
    times = ([], [])
    for r in range(reps):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def device_ms(fn, warmup: int = WARMUP, n: int = DEVICE_REPS) -> float:
    """The rate of back-to-back calls of ``fn()``: ``n`` calls between one
    pair of CUDA events, after warm-up, divided by ``n``.  The host enqueues
    each call while the card runs the one before, so this is the kernel's
    device time only where the kernel outlasts the wrapper's host work (as
    ``amp_fused`` does); for a kernel of a few microseconds it is the host's
    enqueue rate.  :func:`graph_ms` isolates the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, warmup: int = WARMUP, n: int = DEVICE_REPS,
             replays: int = GRAPH_REPLAYS) -> float:
    """Device time of one ``fn()`` with no host work around it: after
    warm-up on a side stream, ``n`` calls are captured in one CUDA graph,
    the graph is replayed ``replays`` times between one pair of CUDA events,
    and the time is divided by ``n * replays``.  What remains besides the
    kernels is the graph's gap from one kernel node to the next."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def host_us(fn, n: int = HOST_CALLS) -> float:
    """Host time of one ``fn()`` in microseconds: ``n`` calls on the host's
    clock with no synchronise between them, divided by ``n``.  The card
    drains the queue afterwards; only a kernel longer than the wrapper
    (``amp_fused``) can make the host wait for a full launch queue."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def timings(fn, plain, library=None, light: bool = False) -> dict:
    """Every time of a kernel check: the kernel's wrapper ``fn`` four ways,
    its plain version per call, and the one-call yardstick ``library``
    (``None`` where there is none) per call, back to back and by replay.
    ``light`` cuts the repetitions for calls of tens of milliseconds (the
    1024-block shapes of a streamed chunk): 5 timed calls, 5 back to back,
    2 calls captured and replayed 3 times, 5 host calls, one plain call."""
    if light:
        kw = dict(warmup=1, reps=5)
        rate, graph = dict(warmup=1, n=5), dict(warmup=1, n=2, replays=3)
        out = dict(kernel_ms=cuda_ms(fn, **kw), device_ms=device_ms(fn, **rate),
                   graph_device_ms=graph_ms(fn, **graph),
                   host_us=host_us(fn, n=5),
                   plain_ms=cuda_ms(plain, warmup=0, reps=1))
    else:
        kw, rate, graph = {}, {}, {}
        out = dict(kernel_ms=cuda_ms(fn), device_ms=device_ms(fn),
                   graph_device_ms=graph_ms(fn), host_us=host_us(fn),
                   plain_ms=cuda_ms(plain))
    if library is None:
        out.update(library_ms=None, library_device_ms=None,
                   library_graph_ms=None)
    else:
        out.update(library_ms=cuda_ms(library, **kw),
                   library_device_ms=device_ms(library, **rate),
                   library_graph_ms=graph_ms(library, **graph))
    return out


def ptxas_summary(log: str) -> list:
    """Registers, spills and static shared memory of each kernel, from the
    ``-Xptxas -v`` lines of a build's log."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+([a-z_]+_kernel)(I.*?E)?E", m.group(1))
            args = re.findall(r"L([bi])(\d+)E", name.group(2) or "")
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in args]
            cur = dict(kernel=f"{name.group(1)}<{', '.join(args)}>")
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       static_smem=int(smem.group(1)) if smem else 0)
    return out


def bound(work):
    """(least time in ms, what bounds it) of a kernel call's bytes and
    operations (a :class:`repro_torch.kernels.cost.Cost`) on the H100's
    published peaks."""
    from repro_torch.kernels import cost
    return cost.bound(*work)


def errors(out, want):
    diff = (out - want).abs()
    rel = diff / want.abs().clamp(min=1e-30)
    return float(diff.max()), float(rel.max())


def mismatch(out, want, rtol: float, atol: float) -> str:
    """Where ``out`` leaves ``allclose(want, rtol, atol)``, for a message."""
    bad = (out - want).abs() > atol + rtol * want.abs()
    worst = int(((out - want).abs() - rtol * want.abs()).argmax())
    return (f"{int(bad.sum())} of {out.numel()} entries outside "
            f"rtol={rtol} atol={atol}; worst at {worst}: "
            f"{float(out.reshape(-1)[worst])} vs {float(want.reshape(-1)[worst])}")


def block_sparse(n_blocks: int, c: int, per_block: int, gen, device):
    import torch
    x = torch.zeros(n_blocks, c, device=device)
    for b in range(n_blocks):
        idx = torch.randperm(c, generator=gen, device=device)[:per_block]
        x[b, idx] = torch.randn(per_block, generator=gen, device=device)
    return x


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_ef_sparsify(m: int, n: int, k: int, device, gen):
    import torch
    from repro_torch.core.compression import sampled_topk_threshold
    from repro_torch.kernels import ef_sparsify, ref
    g = torch.randn(m, n, generator=gen, device=device)
    delta = 0.3 * torch.randn(m, n, generator=gen, device=device)
    tau = sampled_topk_threshold(g + delta, k)
    sp, nd = ef_sparsify.ef_sparsify(g, delta, tau)
    sp_ref, nd_ref = ref.ef_sparsify_ref(g, delta, tau)
    torch.cuda.synchronize()
    check(torch.equal(sp, sp_ref) and torch.equal(nd, nd_ref),
          f"ef_sparsify {m}x{n}: not bitwise equal to its plain version")
    from repro_torch.kernels import cost
    return dict(
        kernel="ef_sparsify", shape=[m, n], tol="bitwise",
        max_abs_err=max(errors(sp, sp_ref)[0], errors(nd, nd_ref)[0]),
        max_rel_err=0.0,
        **timings(lambda: ef_sparsify.ef_sparsify(g, delta, tau),
                  lambda: ref.ef_sparsify_ref(g, delta, tau)),
        bound=bound(cost.ef_sparsify(m, n)))


def check_ota_project(m: int, n_blocks: int, c: int, s: int, rademacher: bool,
                      device, gen, bitwise: bool = False, seed: int = 12345):
    import torch
    from repro_torch.kernels import cost, ota_project, ref
    x = torch.randn(m, n_blocks, c, generator=gen, device=device)
    y = ota_project.ota_project(x, seed, s, rademacher)
    y_ref = ref.ota_project_ref(x, seed, s, rademacher)
    torch.cuda.synchronize()
    check(torch.allclose(y, y_ref, rtol=3e-5, atol=3e-5),
          f"ota_project {m}x{n_blocks}x{c}->{s} rademacher={rademacher}: "
          f"max abs err {errors(y, y_ref)[0]} above 3e-5")
    # yardstick: one batched product with A materialised beforehand
    A = ref.block_matrix_ref(seed, torch.arange(n_blocks, device=device), s,
                             c, rademacher)
    xt = x.permute(1, 2, 0).contiguous()                  # (n_blocks, c, m)
    again = ota_project.ota_project(x, seed, s, rademacher)
    torch.cuda.synchronize()
    check(torch.equal(y, again), "ota_project: two runs differ")
    check(not bitwise or torch.equal(y, y_ref),
          f"ota_project {m}x{n_blocks}x{c}->{s}: not bitwise equal to its "
          "plain version")
    abs_err, rel_err = errors(y, y_ref)
    return dict(
        kernel="ota_project", shape=[m, n_blocks, c, s],
        entries="rademacher" if rademacher else "gaussian",
        tol="rtol=atol=3e-5", max_abs_err=abs_err, max_rel_err=rel_err,
        bitwise=bool(torch.equal(y, y_ref)),
        **timings(lambda: ota_project.ota_project(x, seed, s, rademacher),
                  lambda: ref.ota_project_ref(x, seed, s, rademacher),
                  lambda: torch.bmm(A, xt)),
        bound=bound(cost.ota_project(m, n_blocks, c, s, rademacher)))


def check_ota_project_t(m: int, n_blocks: int, s: int, c: int,
                        rademacher: bool, device, gen):
    import torch
    from repro_torch.kernels import cost, ota_project, ref
    y = torch.randn(m, n_blocks, s, generator=gen, device=device)
    seed = 12345
    r = ota_project.ota_project_t(y, seed, c, rademacher)
    r_ref = ref.ota_project_t_ref(y, seed, c, rademacher)
    again = ota_project.ota_project_t(y, seed, c, rademacher)
    torch.cuda.synchronize()
    check(torch.allclose(r, r_ref, rtol=3e-5, atol=3e-5),
          f"ota_project_t {m}x{n_blocks}x{s}->{c} rademacher={rademacher}: "
          + mismatch(r, r_ref, 3e-5, 3e-5))
    check(torch.equal(r, again), "ota_project_t: two runs differ")
    # +-y summed in float64 and rounded once, as the plain version sums
    check(not rademacher or torch.equal(r, r_ref),
          f"ota_project_t {m}x{n_blocks}x{s}->{c}: Rademacher entries, not "
          "bitwise equal to its plain version")
    # yardstick: one batched product with A materialised beforehand
    A_t = ref.block_matrix_ref(seed, torch.arange(n_blocks, device=device),
                               s, c, rademacher).transpose(1, 2).contiguous()
    yt = y.permute(1, 2, 0).contiguous()                  # (n_blocks, s, m)
    abs_err, rel_err = errors(r, r_ref)
    return dict(
        kernel="ota_project_t", shape=[m, n_blocks, s, c],
        entries="rademacher" if rademacher else "gaussian",
        tol="rtol=atol=3e-5", max_abs_err=abs_err, max_rel_err=rel_err,
        bitwise=bool(torch.equal(r, r_ref)),
        **timings(lambda: ota_project.ota_project_t(y, seed, c, rademacher),
                  lambda: ref.ota_project_t_ref(y, seed, c, rademacher),
                  lambda: torch.bmm(A_t, yt)),
        bound=bound(cost.ota_project_t(m, n_blocks, s, c, rademacher)))


def check_amp_fused(n_blocks: int, c: int, s: int, iters: int, device, gen,
                    rademacher: bool = True, bitwise: bool = False,
                    light: bool = False):
    import torch
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.core.projection import BlockedProjector
    from repro_torch.kernels import amp_fused, build, cost, layout
    seed = 777
    # a block-sparse signal (k/s = 1/8, well inside AMP's recovery region at
    # s/c = 1/4) observed with noise, as the main path's y carries AWGN.
    # Without noise, AMP drives sigma and the threshold towards zero and the
    # support of the near-zero entries turns on rounding: there two plain
    # float32 and float64 decodes of one input already differ past the bar
    x = block_sparse(n_blocks, c, s // 8, gen, device)
    # the projector's plain products: A made a few blocks at a time beyond
    # its working-set budget (a 1024-block A is 17 GB)
    proj = BlockedProjector(d=n_blocks * c, block_size=c, s_block=s,
                            seed=seed, rademacher=rademacher)
    yb = proj.project_blocks(x) \
        + 0.01 * torch.randn(n_blocks, s, generator=gen, device=device)
    kw = dict(iters=iters, rademacher=rademacher)
    out = amp_fused.amp_decode_fused(yb, seed, c, **kw)
    want = amp_blocked_core(yb, seed, c, use_kernel=False, **kw)
    again = amp_fused.amp_decode_fused(yb, seed, c, **kw)
    half = n_blocks // 2
    part = amp_fused.amp_decode_fused(yb[half:].contiguous(), seed, c,
                                      id_offset=half, **kw)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(out, want)
    check(torch.allclose(out, want, rtol=1e-4, atol=1e-5),
          f"amp_fused {n_blocks}x{s}->{c}: "
          + mismatch(out, want, 1e-4, 1e-5))
    check(torch.equal(out, again), "amp_fused: two runs differ")
    check(not bitwise or torch.equal(out, want),
          f"amp_fused {n_blocks}x{s}->{c}: not bitwise equal to its plain "
          "version: " + mismatch(out, want, 0, 0))
    check(torch.equal(part, out[half:]),
          "amp_fused: the id_offset sub-range is not bitwise the full "
          "decode's rows")
    recovery = float((out - x).norm() / x.norm())
    check(recovery < 0.2, f"amp_fused: relative recovery error {recovery}")
    return dict(
        kernel="amp_fused", shape=[n_blocks, s, c], iters=iters,
        entries="rademacher" if rademacher else "gaussian",
        cluster=layout.amp_cluster_size(s, c),
        smem_bytes_per_cta=build.library().amp_fused_smem_bytes(
            s, c, layout.amp_cluster_size(s, c),
            layout.amp_row_segments(s, c), int(rademacher)),
        tol="rtol=1e-4 atol=1e-5; two runs and id_offset sub-range bitwise",
        max_abs_err=abs_err, max_rel_err=rel_err,
        bitwise=bool(torch.equal(out, want)), recovery_rel_err=recovery,
        **timings(lambda: amp_fused.amp_decode_fused(yb, seed, c, **kw),
                  lambda: amp_blocked_core(yb, seed, c, use_kernel=False,
                                           **kw), light=light),
        bound=bound(cost.amp_fused(1, n_blocks, s, c, iters, rademacher)))


def check_ota_project_streamed(m: int, n_blocks: int, c: int, s: int,
                               device, gen, seed: int = 0):
    """ota_project at a streamed chunk's shape with Rademacher entries,
    bitwise its plain version as the scheme runs it on the card: the
    projector's plain products, which make A eight blocks at a time (a
    4 x 1024 x 4096 chunk's A is 17 GB).  The yardstick is one
    ``torch.bmm`` on A materialised beforehand, eight blocks at a time
    into one float32 tensor."""
    import torch
    from repro_torch.core.projection import BlockedProjector
    from repro_torch.kernels import cost, ota_project, ref
    proj = BlockedProjector(d=n_blocks * c, block_size=c, s_block=s,
                            seed=seed, rademacher=True)
    x = torch.randn(m, n_blocks, c, generator=gen, device=device)
    y = ota_project.ota_project(x, seed, s, True)
    want = proj.project_blocks(x)
    again = ota_project.ota_project(x, seed, s, True)
    torch.cuda.synchronize()
    check(torch.equal(y, again), "ota_project: two runs differ")
    check(torch.equal(y, want),
          f"ota_project {m}x{n_blocks}x{c}->{s}: not bitwise equal to its "
          "plain version: " + mismatch(y, want, 0, 0))
    A = torch.empty((n_blocks, s, c), device=device)
    for b0 in range(0, n_blocks, 8):
        ids = torch.arange(b0, min(b0 + 8, n_blocks), device=device)
        A[b0:b0 + len(ids)] = ref.block_matrix_ref(seed, ids, s, c, True)
    xt = x.permute(1, 2, 0).contiguous()                  # (n_blocks, c, m)
    light = n_blocks > 8
    out = dict(
        kernel="ota_project", shape=[m, n_blocks, c, s],
        entries="rademacher", tol="bitwise", bitwise=True,
        max_abs_err=errors(y, want)[0], max_rel_err=0.0,
        **timings(lambda: ota_project.ota_project(x, seed, s, True),
                  lambda: proj.project_blocks(x), lambda: torch.bmm(A, xt),
                  light=light),
        bound=bound(cost.ota_project(m, n_blocks, c, s)))
    del A
    return out


def check_streamed_shapes(device, gen) -> list:
    """The three main-path kernels at the fedllm phase's shapes, bitwise
    their plain versions: a 2**14 chunk (4 blocks) and a 2**22 chunk (1024
    blocks) of ``ota_overrides`` (c 4096, s 1024, k half the channel
    uses), for m = 4 devices."""
    import torch
    from repro_torch.configs.base import ota_overrides
    ota = ota_overrides(FEDLLM_ARCH)
    c = ota.block_size
    s = max(2, int(round(ota.s_frac * c)))
    out = []
    for chunk in (FEDLLM_DEFAULT_CHUNK, FEDLLM_CHUNK):
        n_blocks = chunk // c
        k = max(1, int(ota.k_frac * n_blocks * s))
        out.append(check_ef_sparsify(FEDLLM_M, chunk, k, device, gen))
        out.append(check_ota_project_streamed(FEDLLM_M, n_blocks, c, s,
                                              device, gen))
        out.append(check_amp_fused(n_blocks, c, s, ota.amp_iters, device,
                                   gen, bitwise=True, light=n_blocks > 8))
        torch.cuda.empty_cache()
    for rec in out:
        rec["bound_share"] = rec["bound"][0] / rec["graph_device_ms"]
    return out


def check_amp_fused_points(points: int, n_blocks: int, c: int, s: int,
                           iters: int, device, gen):
    """amp_fused with a leading point axis: G points' decodes in one
    launch, bitwise with the plain version (which decodes the points one
    after the other) and with G launches of one point each."""
    import torch
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.kernels import amp_fused, cost, ref
    seed = 777
    x = torch.stack([block_sparse(n_blocks, c, s // 8, gen, device)
                     for _ in range(points)])
    yb = (ref.ota_project_ref(x, seed, s)
          + 0.01 * torch.randn(points, n_blocks, s, generator=gen,
                               device=device)).contiguous()
    kw = dict(iters=iters)
    out = amp_fused.amp_decode_fused(yb, seed, c, **kw)
    want = amp_blocked_core(yb, seed, c, use_kernel=False, **kw)
    singles = torch.stack([amp_fused.amp_decode_fused(yb[g], seed, c, **kw)
                           for g in range(points)])
    torch.cuda.synchronize()
    check(tuple(out.shape) == (points, n_blocks, c),
          f"amp_fused points: shape {tuple(out.shape)}")
    # graph time against the number of points, one launch each: where the
    # clusters stop fitting the card at once
    scaling = {}
    for g in POINT_SCALING:
        yg = yb[:1].expand(g, n_blocks, s).contiguous()
        scaling[g] = graph_ms(lambda: amp_fused.amp_decode_fused(
            yg, seed, c, **kw), n=DECODE_GRAPH_CALLS)
    check(torch.equal(out, singles), f"amp_fused: {points} points in one "
          "launch are not bitwise the G = 1 launches")
    check(torch.equal(out, want), f"amp_fused {points} points: not bitwise "
          "equal to its plain version: " + mismatch(out, want, 0, 0))
    # A is the same matrix for every point: the function hashes it once a
    # block, and runs the iterations' products once a point
    return dict(
        kernel="amp_fused", shape=[points, n_blocks, s, c], iters=iters,
        entries="rademacher", tol="bitwise (plain and G = 1 launches)",
        max_abs_err=errors(out, want)[0], bitwise=True,
        max_active_clusters=amp_fused.max_active_clusters(s, c),
        clusters_launched=points * n_blocks, graph_ms_by_points=scaling,
        g1_launches_graph_ms=graph_ms(lambda: [amp_fused.amp_decode_fused(
            yb[g], seed, c, **kw) for g in range(points)],
            n=DECODE_GRAPH_CALLS),
        **timings(lambda: amp_fused.amp_decode_fused(yb, seed, c, **kw),
                  lambda: amp_blocked_core(yb, seed, c, use_kernel=False,
                                           **kw)),
        bound=bound(cost.amp_fused(points, n_blocks, s, c, iters)))


def check_amp_fused_offsets(c: int, s: int, iters: int, offsets, device,
                            gen):
    """amp_fused on one block with its global block id, as ``shard_decode``
    hands each device row its block: a noisy block made with that id and
    the all-zero block of a padded row, bitwise the plain version at every
    offset."""
    import torch
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.kernels import amp_fused, ref
    seed = 777
    for off in offsets:
        x = block_sparse(1, c, s // 8, gen, device)
        A = ref.block_matrix_ref(seed, torch.tensor([off], device=device), s,
                                 c)
        y = ref.contract("isc,ic->is", A, x) + 0.01 * torch.randn(
            1, s, generator=gen, device=device)
        for yb in (y, torch.zeros_like(y)):
            got = amp_fused.amp_decode_fused(yb, seed, c, iters=iters,
                                             id_offset=off)
            want = amp_blocked_core(yb, seed, c, iters, id_offset=off)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"amp_fused one block at "
                  f"id_offset {off}: not bitwise its plain version: "
                  + mismatch(got, want, 0, 0))
    return dict(kernel="amp_fused", shape=[1, s, c], iters=iters,
                id_offsets=[min(offsets), max(offsets)],
                blocks=["noisy", "zero"], tol="bitwise")


def same_nonfinite(out, want) -> bool:
    """The same NaN positions, and the other entries bitwise."""
    import torch
    nan = torch.isnan(out)
    return bool(torch.equal(nan, torch.isnan(want))
                and torch.equal(out[~nan], want[~nan]))


def check_amp_fused_nonfinite(n_blocks: int, c: int, s: int, iters: int,
                              device, gen, points: int = 4):
    """amp_fused on observations a poisoned frame leaves: one NaN, or +Inf,
    or -Inf, in block 0 of y, at G = 1 and in one point of a G-point launch.
    The kernel must give the plain version's NaN pattern (the whole block),
    its other entries bitwise, and every other block and point bitwise the
    decode of the clean y."""
    import torch
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.kernels import amp_fused, ref
    seed = 777
    x = torch.stack([block_sparse(n_blocks, c, s // 8, gen, device)
                     for _ in range(points)])
    clean = (ref.ota_project_ref(x, seed, s)
             + 0.01 * torch.randn(points, n_blocks, s, generator=gen,
                                  device=device)).contiguous()
    kw = dict(iters=iters)
    clean_out = amp_fused.amp_decode_fused(clean, seed, c, **kw)
    cases = []
    for value in (float("nan"), float("inf"), float("-inf")):
        for g in (1, points):
            yb = (clean[:1].clone() if g == 1 else clean.clone())
            bad = g // 2                    # the poisoned point
            yb[bad, 0, s // 3] = value
            y_in = yb[0] if g == 1 else yb
            out = amp_fused.amp_decode_fused(y_in, seed, c, **kw)
            want = amp_blocked_core(y_in, seed, c, use_kernel=False, **kw)
            torch.cuda.synchronize()
            out, want = out.reshape(g, n_blocks, c), want.reshape(
                g, n_blocks, c)
            check(same_nonfinite(out, want),
                  f"amp_fused y[{bad}, 0] = {value}, G = {g}: the NaN "
                  "pattern or the finite entries differ from the plain "
                  "version")
            check(bool(torch.isnan(out[bad, 0]).all()),
                  f"amp_fused y = {value}: the poisoned block is not NaN")
            keep = torch.ones(g, n_blocks, dtype=torch.bool, device=device)
            keep[bad, 0] = False
            check(torch.equal(out[keep], clean_out[:g][keep]),
                  f"amp_fused y = {value}, G = {g}: a clean block or point "
                  "changed")
            cases.append(dict(value=str(value), points=g,
                              nan_entries=int(torch.isnan(out).sum()),
                              same_as_plain=True, others_bitwise=True))
    y_nan = clean[0].clone()
    y_nan[0, s // 3] = float("nan")
    return dict(
        kernel="amp_fused", shape=[n_blocks, s, c], iters=iters,
        tol="NaN positions equal, finite entries bitwise; clean blocks and "
            "points bitwise the clean decode", cases=cases,
        graph_ms_poisoned=graph_ms(lambda: amp_fused.amp_decode_fused(
            y_nan, seed, c, **kw), n=DECODE_GRAPH_CALLS),
        graph_ms_clean=graph_ms(lambda: amp_fused.amp_decode_fused(
            clean[0], seed, c, **kw), n=DECODE_GRAPH_CALLS))


def check_point_rows(points: int, m: int, d: int, n_blocks: int, c: int,
                     s: int, k: int, device, gen):
    """The (G, M) rows a sweep's grid hands ef_sparsify and ota_project go
    through the wrappers as G * M rows: each point's rows must be bitwise
    what a call with that point's M rows alone gives."""
    import torch
    from repro_torch.core.compression import sampled_topk_threshold
    from repro_torch.kernels import ef_sparsify, ota_project
    g = torch.randn(points, m, d, generator=gen, device=device)
    delta = 0.3 * torch.randn(points, m, d, generator=gen, device=device)
    tau = sampled_topk_threshold(g + delta, k)
    sp, nd = ef_sparsify.ef_sparsify(g, delta, tau)
    x = torch.randn(points, m, n_blocks, c, generator=gen, device=device)
    y = ota_project.ota_project(x, 12345, s)
    torch.cuda.synchronize()
    for p in range(points):
        sp1, nd1 = ef_sparsify.ef_sparsify(g[p], delta[p], tau[p])
        y1 = ota_project.ota_project(x[p], 12345, s)
        torch.cuda.synchronize()
        check(torch.equal(sp[p], sp1) and torch.equal(nd[p], nd1),
              f"ef_sparsify: point {p} of ({points}, {m}, {d}) differs from "
              f"its ({m}, {d}) call")
        check(torch.equal(y[p], y1),
              f"ota_project: point {p} of ({points}, {m}, {n_blocks}, {c}) "
              f"differs from its ({m}, {n_blocks}, {c}) call")
    return dict(check="point_rows", points=points,
                ef_sparsify_shape=[points, m, d],
                ota_project_shape=[points, m, n_blocks, c, s],
                bitwise_per_point=True)


# ---------------------------------------------------------------------------
# phase 4: the port's main path
# ---------------------------------------------------------------------------


def slice_config(steps: int):
    from repro_torch.configs.base import ota_overrides
    return dataclasses.replace(ota_overrides("mnist_mlp"), use_kernel=True,
                               amp_iters=20, total_steps=steps)


def round_parity(xd, yd, cfg, device):
    """The first round's gradient estimate, kernel path against plain path."""
    import torch
    from repro_torch import rng
    from repro_torch.core.schemes import get_scheme, round_simulated
    from repro_torch.train.paper_repro import device_grads, init_linear
    params = init_linear(xd.shape[-1], 10, device)
    grads, _ = device_grads(params, xd, yd, None)
    deltas = torch.zeros_like(grads)
    out = {}
    for uk in (True, False):
        scheme = get_scheme(dataclasses.replace(cfg, use_kernel=uk),
                            grads.shape[1], grads.shape[0], device=device)
        out[uk] = round_simulated(scheme, grads, deltas, 0,
                                  rng.PRNGKey(1000, device=device))
    (g_k, d_k, _), (g_p, d_p, _) = out[True], out[False]
    torch.cuda.synchronize()
    check(torch.equal(d_k, d_p), "first round: kernel and plain error "
          "states differ (ef_sparsify is bitwise)")
    abs_err, rel_err = errors(g_k, g_p)
    check(torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-5),
          "first round: ghat kernel vs plain: "
          + mismatch(g_k, g_p, 1e-4, 1e-5))
    return dict(max_abs_err=abs_err, max_rel_err=rel_err)


def round_breakdown(xd, yd, cfg, device, reps: int = 10):
    """ms of one round and of its parts, steady state, by CUDA events."""
    import torch
    from repro_torch import rng
    from repro_torch.core import channel
    from repro_torch.core.schemes import encode_round, get_scheme
    from repro_torch.core.schemes import MACContext
    from repro_torch.convert import unravel
    from repro_torch.optim.optim import Optimizer
    from repro_torch.train.paper_repro import (device_grads, init_linear,
                                               train_step)
    params = init_linear(xd.shape[-1], 10, device)
    grads, _ = device_grads(params, xd, yd, None)
    scheme = get_scheme(cfg, grads.shape[1], grads.shape[0], device=device)
    opt = Optimizer(lr=1e-3)
    state = opt.init(params)
    deltas = torch.zeros_like(grads)
    key = rng.PRNGKey(1000, device=device)
    ctx = MACContext(m=scheme.m)
    y, _, _, _ = encode_round(scheme, grads, deltas, 0, key, ctx)
    ghat = scheme.decode(y, 0, ctx)
    return {
        "round_ms": cuda_ms(lambda: train_step(
            scheme, opt, params, state, deltas, None, xd, yd, 0, key),
            reps=reps),
        "device_grads_ms": cuda_ms(lambda: device_grads(params, xd, yd, None),
                                   reps=reps),
        "encode_and_mac_ms": cuda_ms(lambda: encode_round(
            scheme, grads, deltas, 0, key, ctx), reps=reps),
        "decode_ms": cuda_ms(lambda: scheme.decode(y, 0, ctx), reps=reps),
        # the round's draws from the jax-exact RNG: the three salted keys,
        # the device keys and the AWGN of the MAC
        "rng_ms": cuda_ms(lambda: (
            rng.split(rng.fold_in(key, 1), scheme.m), rng.fold_in(key, 2),
            channel.awgn(rng.fold_in(key, 0), y.shape, 1.0)), reps=reps),
        "adam_ms": cuda_ms(lambda: opt.apply(params, unravel(ghat, params),
                                             state), reps=reps),
    }


_SURROGATE = {}


def surrogate(n_train: int = 60000, n_test: int = 10000):
    """The figure benchmarks' MNIST surrogate at the paper's FULL scale,
    made once: ``((x_train, y_train), (x_test, y_test))``."""
    from repro_torch.data import make_classification
    if (n_train, n_test) not in _SURROGATE:
        _SURROGATE[n_train, n_test] = make_classification(
            n_train=n_train, n_test=n_test, noise=6.0, seed=3)
    return _SURROGATE[n_train, n_test]


def run_slice(device, steps: int = STEPS, m: int = 25, b: int = 1000,
              n_train: int = 60000, n_test: int = 10000):
    import numpy as np
    import torch
    from repro_torch.data import federated_split
    from repro_torch.kernels import ops
    from repro_torch.train.paper_repro import run_federated

    t0 = time.perf_counter()
    (xtr, ytr), (xte, yte) = surrogate(n_train, n_test)
    x_dev, y_dev = federated_split(xtr, ytr, m=m, b=b, iid=True, seed=0)
    data_s = time.perf_counter() - t0
    cfg = slice_config(steps)
    xd = torch.as_tensor(x_dev, device=device)
    yd = torch.as_tensor(y_dev, device=device).long()

    parity = round_parity(xd, yd, cfg, device)

    ops.reset_launches()
    t0 = time.perf_counter()
    run = run_federated(x_dev, y_dev, xte, yte, cfg, steps=steps, lr=1e-3,
                        eval_every=5, device=device)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0],
          f"slice: test loss did not fall: {run.losses}")
    d = int(run.deltas.shape[1])
    check(d == 7850, f"slice: d = {d}, expected 7850")
    check(run.deltas.shape[0] == m, f"slice: M != {m}")
    for name in PATH_KERNELS["slice"]:
        check(launches[name] > 0,
              f"slice: kernel {name} never launched in run_federated")
    timing = round_breakdown(xd, yd, cfg, device)
    return (x_dev, y_dev, xte, yte), dict(
        phase="slice", m=m, b=b, n_train=n_train, n_test=n_test, d=d,
        steps=steps, config=dict(projection=cfg.projection,
                                 block_size=cfg.block_size,
                                 s_frac=cfg.s_frac, k_frac=cfg.k_frac,
                                 rademacher=cfg.rademacher,
                                 use_kernel=cfg.use_kernel,
                                 amp_iters=cfg.amp_iters),
        launches=launches, launches_per_round={
            k: v / steps for k, v in launches.items()},
        first_round_ghat_vs_plain=parity, losses=run.losses, accs=run.accs,
        final_acc=run.accs[-1], data_s=data_s, run_s=run_s, **timing)


# ---------------------------------------------------------------------------
# phase 5: the launch-per-op AMP decode on the adjoint and forward kernels
# ---------------------------------------------------------------------------


def run_unfused_decode(n_blocks: int, c: int, s: int, iters: int, device,
                       gen):
    import torch
    from repro_torch.core.amp import amp_decode_blocked
    from repro_torch.core.projection import BlockedProjector
    from repro_torch.kernels import amp_fused, ops, ref
    seed = 777
    x = block_sparse(n_blocks, c, s // 8, gen, device)
    yb = ref.ota_project_ref(x, seed, s) \
        + 0.01 * torch.randn(n_blocks, s, generator=gen, device=device)
    kw = dict(d=n_blocks * c, block_size=c, s_block=s, seed=seed)
    kproj = BlockedProjector(use_kernel=True, **kw)
    pproj = BlockedProjector(use_kernel=False, **kw)

    ops.reset_launches()
    out = amp_decode_blocked(yb, kproj, iters=iters)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"ef_sparsify": 0, "ota_project": iters + 1,
            "ota_project_t": iters, "amp_fused": 0}
    check(launches == want, f"unfused_decode: launches {launches}, "
          f"expected {want}")
    plain = amp_decode_blocked(yb, pproj, iters=iters)
    fused = amp_fused.amp_decode_fused(yb, seed, c, iters=iters).reshape(-1)
    torch.cuda.synchronize()
    for name, other in (("plain projector", plain), ("amp_fused", fused)):
        check(torch.allclose(out, other, rtol=1e-4, atol=1e-5),
              f"unfused_decode vs {name}: "
              + mismatch(out, other, 1e-4, 1e-5))
    recovery = float((out - x.reshape(-1)).norm() / x.norm())
    check(recovery < 0.2, f"unfused_decode: relative recovery error "
          f"{recovery}")
    return dict(
        phase="unfused_decode", shape=[n_blocks, s, c], iters=iters,
        launches=launches, tol="rtol=1e-4 atol=1e-5",
        max_abs_err_vs_plain=errors(out, plain)[0],
        max_abs_err_vs_fused=errors(out, fused)[0],
        bitwise_vs_plain=bool(torch.equal(out, plain)),
        recovery_rel_err=recovery,
        unfused_kernel_ms=cuda_ms(lambda: amp_decode_blocked(
            yb, kproj, iters=iters), reps=10),
        unfused_graph_ms=graph_ms(lambda: amp_decode_blocked(
            yb, kproj, iters=iters), n=DECODE_GRAPH_CALLS),
        unfused_plain_ms=cuda_ms(lambda: amp_decode_blocked(
            yb, pproj, iters=iters), reps=10),
        fused_kernel_ms=cuda_ms(lambda: amp_fused.amp_decode_fused(
            yb, seed, c, iters=iters), reps=10),
        fused_graph_ms=graph_ms(lambda: amp_fused.amp_decode_fused(
            yb, seed, c, iters=iters), n=DECODE_GRAPH_CALLS))


# ---------------------------------------------------------------------------
# phase 6: the engine, and its checkpointed resume
# ---------------------------------------------------------------------------


def run_engine(data, cfg, slice_line, device, steps: int = STEPS,
               eval_every: int = 5, stop_at: int = 10):
    import tempfile
    import warnings
    import torch
    from repro_torch.experiments import engine
    from repro_torch.kernels import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    run = engine.run_compiled(*data, cfg, steps=steps, lr=1e-3,
                              eval_every=eval_every, device=device)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    for name in PATH_KERNELS["engine"]:
        check(launches[name] > 0,
              f"engine: kernel {name} never launched in run_compiled")
    check(run.accs == slice_line["accs"] and run.losses
          == slice_line["losses"],
          f"engine: run_compiled {run.accs} {run.losses} differs from "
          f"run_federated {slice_line['accs']} {slice_line['losses']}")

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(steps=steps, lr=1e-3, eval_every=eval_every,
                  device=device, checkpoint_dir=tmp,
                  checkpoint_every=eval_every)
        stopped = engine.run_compiled(*data, cfg, stop_after_step=stop_at,
                                      **kw)
        check(stopped is None, "engine: the interrupted run did not stop")
        resumed = engine.run_compiled(*data, cfg, resume=True, **kw)
    torch.cuda.synchronize()
    check(resumed.accs == run.accs and resumed.losses == run.losses
          and resumed.all_losses.tolist() == run.all_losses.tolist()
          and all(torch.equal(resumed.params[k], run.params[k])
                  for k in run.params),
          "engine: the resumed run is not bitwise the uninterrupted one")

    # steady state: the same runner, its loop alone, by CUDA events; and
    # whether anything inside the loop waits for the device
    exp = engine.Experiment(cfg=cfg, steps=steps, eval_every=eval_every)
    ce = engine.CompiledExperiment(*data, exp, device=device)
    keys = engine.round_keys(steps, 0, device)
    ce.run({}, keys)
    torch.cuda.synchronize()

    def sync_warnings(fn):
        """torch's warnings of synchronizing calls made by ``fn()`` (its
        notice that the debug mode is a prototype is not one)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        msgs = [str(w.message).splitlines()[0] for w in caught]
        return [m for m in msgs if "synchroniz" in m.lower()
                and "prototype" not in m]

    check(sync_warnings(lambda: keys[0, 1].item()) != [],
          "engine: the sync detector does not see an .item()")
    syncs = sync_warnings(lambda: ce.run({}, keys))
    check(not syncs, f"engine: host syncs inside the loop: {syncs[:5]}")
    run_ms = cuda_ms(lambda: ce.run({}, keys), warmup=1, reps=3)
    return dict(
        phase="engine", steps=steps, launches=launches,
        launches_per_round={k: v / steps for k, v in launches.items()},
        equals_run_federated=True, resumed_bitwise=True,
        checkpoint=dict(every=eval_every, stopped_after=stop_at),
        host_syncs_in_loop=len(syncs), losses=run.losses, accs=run.accs,
        run_s=run_s, ms_per_round=run_ms / steps,
        run_federated_round_ms=slice_line["round_ms"])


# ---------------------------------------------------------------------------
# phase 7: the sweep grid, five static groups of G = 4 batched points
# ---------------------------------------------------------------------------


def run_sweep_phase(data, cfg, device, steps: int = STEPS,
                    eval_every: int = 5):
    import torch
    from repro_torch.core.schemes import PAPER_SCHEMES
    from repro_torch.experiments import engine, sweep
    from repro_torch.kernels import ops

    x_dev, y_dev, xte, yte = data
    axes = {"scheme": list(PAPER_SCHEMES), "p_avg": list(SWEEP_P_AVG)}
    ops.reset_launches()
    t0 = time.perf_counter()
    res = sweep.run_sweep((x_dev, y_dev), (xte, yte), cfg, axes, steps=steps,
                          lr=1e-3, eval_every=eval_every, device=device)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(len(res.records) == len(PAPER_SCHEMES) * len(SWEEP_P_AVG),
          f"sweep: {len(res.records)} records")
    for name in PATH_KERNELS["sweep"]:
        check(launches[name] == steps,
              f"sweep: {name} launched {launches[name]} times in run_sweep, "
              f"expected {steps} (the a_dsgd group, once per round)")

    # every record bitwise against that point's own run_compiled
    for rec in res.records:
        one = engine.run_compiled(
            x_dev, y_dev, xte, yte,
            dataclasses.replace(cfg, scheme=rec["scheme"],
                                p_avg=rec["p_avg"]),
            steps=steps, lr=1e-3, eval_every=eval_every, device=device)
        check(rec["accs"] == one.accs and rec["losses"] == one.losses,
              f"sweep: {rec['scheme']} p_avg={rec['p_avg']}: record "
              f"{rec['accs']} {rec['losses']} is not its own run_compiled "
              f"{one.accs} {one.losses}")

    # per group: launches of the batched run alone, then steady-state ms
    # per batched round against the first point's own run (its own runner,
    # with its own q_max)
    groups = []
    grid = [{"p_avg": p} for p in SWEEP_P_AVG]
    for scheme in PAPER_SCHEMES:
        exp = engine.Experiment(cfg=dataclasses.replace(cfg, scheme=scheme),
                                steps=steps, eval_every=eval_every)
        ce = engine.CompiledExperiment(x_dev, y_dev, xte, yte, exp,
                                       device=device)
        ov, keys, _ = sweep.grid_inputs(ce, grid, steps)
        ops.reset_launches()
        ce.run_grid(ov, keys)
        torch.cuda.synchronize()
        group_launches = ops.launch_counts()
        want = steps if scheme == "a_dsgd" else 0
        for name in PATH_KERNELS["sweep"]:
            check(group_launches[name] == want,
                  f"sweep: group {scheme}: {name} launched "
                  f"{group_launches[name]} times, expected {want}")
        lone = engine.CompiledExperiment(
            x_dev, y_dev, xte, yte, dataclasses.replace(
                exp, cfg=dataclasses.replace(exp.cfg, **grid[0])),
            device=device)
        lone_keys = engine.round_keys(steps, 0, device)
        alone, batched = alternating_ms(lambda: lone.run({}, lone_keys),
                                        lambda: ce.run_grid(ov, keys))
        groups.append(dict(
            scheme=scheme, points=len(grid), launches=group_launches,
            ms_per_batched_round=batched / steps,
            ms_per_round_one_point=alone / steps,
            batched_over_points_alone=batched / (len(grid) * alone),
            final_accs={str(r["p_avg"]): r["final_acc"] for r in
                        res.records if r["scheme"] == scheme},
            vs_run_compiled="bitwise"))
    return dict(
        phase="sweep", steps=steps, axes=axes, m=int(x_dev.shape[0]),
        b=int(x_dev.shape[1]), d=7850, config=dict(
            projection=cfg.projection, block_size=cfg.block_size,
            s_frac=cfg.s_frac, k_frac=cfg.k_frac, use_kernel=cfg.use_kernel,
            amp_iters=cfg.amp_iters),
        launches=launches, sweep_s=sweep_s,
        us_per_call=res.records[0]["us_per_call"], groups=groups)


# ---------------------------------------------------------------------------
# phase 8: the channel axes
# ---------------------------------------------------------------------------


def channel_rng_ms(cfg, m: int, device, reps: int = 10) -> dict:
    """ms of one round's draws for a channel config: the round's own RNG
    (the salted keys, the device keys, the AWGN) and the channel draw."""
    import torch
    from repro_torch import rng
    from repro_torch.core import channel
    from repro_torch.core.schemes import get_scheme
    scheme = get_scheme(cfg, 7850, m, device=device)
    key = rng.PRNGKey(1005, device=device)
    y_len = scheme.channel_dim()
    draw = lambda: scheme.channel_draw(rng.fold_in(key, 2), 5, m)
    draw()
    torch.cuda.synchronize()
    return {"rng_ms": cuda_ms(lambda: (
                rng.split(rng.fold_in(key, 1), m), rng.fold_in(key, 2),
                channel.awgn(rng.fold_in(key, 0), (y_len,), 1.0)),
                reps=reps),
            "channel_draw_ms": cuda_ms(draw, reps=reps)}


def _same_run(a, b) -> bool:
    return (a.accs == b.accs and a.losses == b.losses
            and a.all_losses.tolist() == b.all_losses.tolist())


def run_channel_phase(data, cfg, device, steps: int = STEPS,
                      eval_every: int = 5, stop_at: int = 10):
    import tempfile
    import numpy as np
    import torch
    from repro_torch.experiments import engine, sweep
    from repro_torch.kernels import ops
    from repro_torch.train.paper_repro import run_federated

    x_dev, y_dev, xte, yte = data
    m = int(x_dev.shape[0])
    kw = dict(steps=steps, lr=1e-3, eval_every=eval_every, device=device)
    total = {}

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after; every path kernel must launch once a round."""
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        n = ops.launch_counts()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        return out, n

    runs, compiled = [], {}
    for name, over in CHANNEL_RUNS.items():
        c = dataclasses.replace(cfg, **over)
        rec = dict(name=name, config=over)
        run, n = counted(lambda: engine.run_compiled(*data, c, **kw))
        rec["launches_run_compiled"] = n
        check(all(np.isfinite(run.all_losses)),
              f"channel {name}: non-finite losses {run.losses}")
        if c.scheduler == "none":
            loop, n = counted(lambda: run_federated(
                x_dev, y_dev, xte, yte, c, **kw))
            rec["launches_run_federated"] = n
            check(loop.accs == run.accs and loop.losses == run.losses,
                  f"channel {name}: run_compiled {run.accs} {run.losses} "
                  f"differs from run_federated {loop.accs} {loop.losses}")
        with tempfile.TemporaryDirectory() as tmp:
            ck = dict(checkpoint_dir=tmp, checkpoint_every=eval_every, **kw)
            stopped = engine.run_compiled(*data, c, stop_after_step=stop_at,
                                          **ck)
            check(stopped is None, f"channel {name}: no stop")
            resumed = engine.run_compiled(*data, c, resume=True, **ck)
        torch.cuda.synchronize()
        check(_same_run(resumed, run) and all(
            torch.equal(resumed.params[k], run.params[k])
            for k in run.params),
            f"channel {name}: the resumed run is not bitwise")
        for path_name, counts in (("run_compiled", rec[
                "launches_run_compiled"]), ("run_federated", rec.get(
                "launches_run_federated"))):
            for k in PATH_KERNELS["channel"]:
                check(counts is None or counts[k] == steps,
                      f"channel {name}: {k} launched {counts and counts[k]} "
                      f"times in {path_name}, expected {steps}")
        rec.update(losses=run.losses, accs=run.accs, final_acc=run.accs[-1],
                   equals_run_federated=c.scheduler == "none",
                   resumed_bitwise=True,
                   active_frac=[mt["active_frac"] for mt in run.metrics])
        compiled[name] = run
        runs.append(rec)

    # csi_err_var = 0 is the perfect-CSI scheme bit for bit
    zero = engine.run_compiled(*data, dataclasses.replace(
        cfg, scheme="a_dsgd_csi_err", csi_err_var=0.0,
        fading_threshold=0.3), **kw)
    check(_same_run(zero, compiled["fading_iid"]),
          "channel: csi_err_var = 0 is not bitwise a_dsgd_fading")

    # two sweep groups, each record its own run_compiled
    groups = []
    sweeps = [(dataclasses.replace(cfg, **CHANNEL_RUNS["csi_err"]),
               {"csi_err_var": list(CHANNEL_CSI_GRID)})]
    for n_sub in (1, 2):
        sweeps.append((dataclasses.replace(
            cfg, **{**CHANNEL_RUNS["geometry_prop_fair"],
                    "scheduler": "gain_ranked", "n_subbands": n_sub}),
            {"cell_radius": list(CHANNEL_RADII)}))
    for base, axes in sweeps:
        res, n = counted(lambda: sweep.run_sweep(
            (x_dev, y_dev), (xte, yte), base, axes, steps=steps, lr=1e-3,
            eval_every=eval_every, device=device))
        (axis, values), = axes.items()
        for k in PATH_KERNELS["channel"]:
            check(n[k] == steps, f"channel sweep {axis}: {k} launched "
                  f"{n[k]} times, expected {steps}")
        for rec in res.records:
            one = engine.run_compiled(*data, dataclasses.replace(
                base, **{axis: rec[axis]}), **kw)
            check(rec["accs"] == one.accs and rec["losses"] == one.losses,
                  f"channel sweep {axis}={rec[axis]}: record is not its own "
                  "run_compiled")
        groups.append(dict(axis=axis, values=values, points=len(values),
                           scheduler=base.scheduler,
                           n_subbands=base.n_subbands, launches=n,
                           final_accs=[r["final_acc"] for r in res.records],
                           vs_run_compiled="bitwise"))

    # ms per round of each config beside the AWGN slice's, in turns
    exp0 = engine.Experiment(cfg=cfg, steps=steps, eval_every=eval_every)
    awgn_ce = engine.CompiledExperiment(*data, exp0, device=device)
    keys = engine.round_keys(steps, 0, device)
    for rec in runs:
        c = dataclasses.replace(cfg, **rec["config"])
        ce = engine.CompiledExperiment(*data, dataclasses.replace(
            exp0, cfg=c), device=device)
        awgn, chan = alternating_ms(lambda: awgn_ce.run({}, keys),
                                    lambda: ce.run({}, keys), reps=2)
        rec["ms_per_round"] = chan / steps
        rec["awgn_ms_per_round"] = awgn / steps
        if rec["name"] == "fading_gauss_markov":
            rec.update(channel_rng_ms(c, m, device))
    return dict(
        phase="channel", steps=steps, m=m, b=int(x_dev.shape[1]), d=7850,
        config=dict(projection=cfg.projection, block_size=cfg.block_size,
                    use_kernel=cfg.use_kernel, amp_iters=cfg.amp_iters),
        launches=total, runs=runs, csi_err0_is_fading="bitwise",
        sweep_groups=groups)


def launch_counter(path: str, total: dict, steps: int = STEPS):
    """``counted(fn, want=steps)``: ``fn()`` with the launch counts set to
    0 just before and read just after, added to ``total``; each kernel of
    ``path`` must launch ``want`` times."""
    import torch
    from repro_torch.kernels import ops

    def counted(fn, want=steps):
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        n = ops.launch_counts()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        for k in PATH_KERNELS[path]:
            check(n[k] == want, f"{path}: {k} launched {n[k]} times, "
                  f"expected {want}")
        return out, n
    return counted


# ---------------------------------------------------------------------------
# phase 9: the robustness axis
# ---------------------------------------------------------------------------


def expected_skips(cfg, steps: int, m: int) -> list:
    """The rounds in which some transmitting device's frame is poisoned:
    the fault draws alone, on the CPU (a function of the RNG)."""
    from repro_torch import rng
    from repro_torch.core.schemes import get_scheme
    from repro_torch.robust import faults
    scheme = get_scheme(cfg, 7850, m, device="cpu")
    out = []
    for t in range(steps):
        key = rng.fold_in(rng.PRNGKey(1000 + t, device="cpu"),
                          faults.SALT_FAULT)
        out.append(float(bool(scheme.fault_draw(key, t, m).poison.any())))
    return out


def run_robust_phase(data, cfg, eng_line, device, steps: int = STEPS,
                     eval_every: int = 5, stop_at: int = 10):
    """Fig. 11's analog and digital cells, NaN faults under the round
    guard, and a robust grid, at the slice's scale and config."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.experiments import engine, sweep
    from repro_torch.robust import GuardConfig, byzantine_set, fault_base_key

    x_dev, y_dev, xte, yte = data
    m = int(x_dev.shape[0])
    kw = dict(steps=steps, lr=1e-3, eval_every=eval_every, device=device)
    total = {}
    counted = launch_counter("robust", total, steps)

    def final(run):
        check(all(np.isfinite(run.all_losses)),
              f"robust: non-finite losses {run.losses}")
        return run.accs[-1]

    analog = dict(scheme="a_dsgd", robust=True, byz_attack="sign_flip",
                  byz_scale=20.0, power_cap=1.5)
    runs = {}
    # (a) Fig. 11's analog cell, the power cap on and off
    for name, over in (("analog_capped", dict(byzantine_frac=0.1,
                                              clip_power=True)),
                       ("analog_uncapped", dict(byzantine_frac=0.1,
                                                clip_power=False))):
        c = dataclasses.replace(cfg, **analog, **over)
        run, n = counted(lambda: engine.run_compiled(*data, c, **kw))
        runs[name] = dict(config={**analog, **over}, launches=n,
                          final_acc=final(run), accs=run.accs, run=run,
                          cfg=c)
    share = float(byzantine_set(fault_base_key(cfg.seed, "cpu"), m, 0.1)
                  .to(torch.float32).sum() / m)
    got = [mt["byz_frac"] for mt in runs["analog_capped"]["run"].metrics]
    check(all(v == share for v in got),
          f"robust: byz_frac {got} is not the CPU set's share {share}")
    check(share > 0, "robust: no Byzantine device at fraction 0.1")
    c0 = dataclasses.replace(cfg, **analog, byzantine_frac=0.0,
                             clip_power=True)
    zero, _ = counted(lambda: engine.run_compiled(*data, c0, **kw))
    awgn = engine.run_compiled(*data, cfg, **kw)
    check(awgn.accs == eng_line["accs"] and awgn.losses
          == eng_line["losses"], "robust: the AWGN run is not the engine "
          "phase's")
    check(_same_run(zero, awgn) and all(torch.equal(zero.params[k],
                                                    awgn.params[k])
                                        for k in awgn.params),
          "robust: the capped run at byzantine_frac 0 is not bitwise the "
          "AWGN run_compiled")

    # (b) NaN frames under the round guard, every round evaluated
    cb = dataclasses.replace(cfg, scheme="a_dsgd", fault_kind="nan",
                             fault_rate=0.1)
    guard = GuardConfig()
    kb = dict(kw, eval_every=1)
    run, n = counted(lambda: engine.run_compiled(*data, cb, guard=guard,
                                                 **kb))
    skipped = [mt["guard_skipped"] for mt in run.metrics]
    want = expected_skips(cb, steps, m)
    check(skipped == want, f"robust: skipped rounds {skipped}, the fault "
          f"draws poison {want}")
    check(sum(want) > 0, "robust: no round was poisoned")
    runs["nan_guarded"] = dict(config=dict(fault_kind="nan", fault_rate=0.1,
                                           guard="GuardConfig()"),
                               launches=n, final_acc=final(run),
                               accs=[run.accs[i] for i in engine.eval_indices(
                                   steps, eval_every)],
                               skipped_rounds=[t for t, v in
                                               enumerate(skipped) if v],
                               run=run, cfg=cb, guard=guard)
    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(kb, checkpoint_dir=tmp, checkpoint_every=eval_every,
                  guard=guard)
        stopped = engine.run_compiled(*data, cb, stop_after_step=stop_at,
                                      **ck)
        check(stopped is None, "robust: the guarded run did not stop")
        resumed = engine.run_compiled(*data, cb, resume=True, **ck)
    torch.cuda.synchronize()
    check(_same_run(resumed, run) and resumed.metrics == run.metrics
          and all(torch.equal(resumed.params[k], run.params[k])
                  for k in run.params),
          "robust: the guarded resume is not bitwise")

    # (c) Fig. 11's digital cell: the norm cap, and a trimmed mean
    for name, over in (("digital_norm_cap", dict(aggregator="norm_cap",
                                                 norm_cap=1.5)),
                       ("digital_trimmed_mean", dict(
                           aggregator="trimmed_mean", trim_frac=0.1))):
        c = dataclasses.replace(cfg, scheme="d_dsgd", byzantine_frac=0.3,
                                byz_scale=20.0, **over)
        run, n = counted(lambda: engine.run_compiled(*data, c, **kw), 0)
        runs[name] = dict(config=dict(scheme="d_dsgd", byzantine_frac=0.3,
                                      **over), launches=n,
                          final_acc=final(run), accs=run.accs, run=run,
                          cfg=c)

    # (d) a robust grid: byzantine_frac x clip_power, two groups of G = 3
    base = dataclasses.replace(cfg, scheme="a_dsgd", byz_scale=20.0,
                               power_cap=1.5)
    axes = {"byzantine_frac": list(ROBUST_FRACS),
            "clip_power": [False, True]}
    res, n = counted(lambda: sweep.run_sweep(
        (x_dev, y_dev), (xte, yte), base, axes, steps=steps, lr=1e-3,
        eval_every=eval_every, device=device), 2 * steps)
    for rec in res.records:
        one = engine.run_compiled(*data, dataclasses.replace(
            base, robust=True, byzantine_frac=rec["byzantine_frac"],
            clip_power=rec["clip_power"]), **kw)
        check(rec["accs"] == one.accs and rec["losses"] == one.losses,
              f"robust grid {rec['byzantine_frac']}, {rec['clip_power']}: "
              "the record is not its own run_compiled")
    groups = []
    grid = [{"byzantine_frac": f} for f in ROBUST_FRACS]
    for clip in (False, True):
        exp = engine.Experiment(cfg=dataclasses.replace(
            base, robust=True, clip_power=clip), steps=steps,
            eval_every=eval_every)
        ce = engine.CompiledExperiment(*data, exp, device=device)
        ov, keys, _ = sweep.grid_inputs(ce, grid, steps)
        _, gn = counted(lambda: ce.run_grid(ov, keys))
        groups.append(dict(clip_power=clip, points=len(grid), launches=gn,
                           ce=ce, ov=ov, keys=keys,
                           final_accs=[r["final_acc"] for r in res.records
                                       if r["clip_power"] == clip],
                           vs_run_compiled="bitwise"))

    # ms per round beside the AWGN slice's, in turns
    exp0 = engine.Experiment(cfg=cfg, steps=steps, eval_every=eval_every)
    awgn_ce = engine.CompiledExperiment(*data, exp0, device=device)
    keys = engine.round_keys(steps, 0, device)
    for rec in runs.values():
        rec.pop("run")
        ce = engine.CompiledExperiment(*data, dataclasses.replace(
            exp0, cfg=rec.pop("cfg"), guard=rec.pop("guard", None)),
            device=device)
        a_ms, r_ms = alternating_ms(lambda: awgn_ce.run({}, keys),
                                    lambda: ce.run({}, keys), reps=2)
        rec.update(ms_per_round=r_ms / steps, awgn_ms_per_round=a_ms / steps)
    for grp in groups:
        ce, ov, gkeys = grp.pop("ce"), grp.pop("ov"), grp.pop("keys")
        a_ms, g_ms = alternating_ms(lambda: awgn_ce.run({}, keys),
                                    lambda: ce.run_grid(ov, gkeys), reps=2)
        grp.update(ms_per_batched_round=g_ms / steps,
                   awgn_ms_per_round=a_ms / steps)
    return dict(
        phase="robust", steps=steps, m=m, b=int(x_dev.shape[1]), d=7850,
        config=dict(projection=cfg.projection, block_size=cfg.block_size,
                    use_kernel=cfg.use_kernel, amp_iters=cfg.amp_iters),
        launches=total, runs=runs, byz_frac_share=share,
        zero_frac_capped_is_awgn="bitwise", guarded_resume="bitwise",
        grid_axes=axes, grid_groups=groups)


# ---------------------------------------------------------------------------
# phase 10: the local-compute axis
# ---------------------------------------------------------------------------


def run_local_phase(cfg, device, steps: int = STEPS, eval_every: int = 5):
    """Fig. 12's analog grid: FedAvg-E, FedProx and FedDyn at E in {1, 2,
    4} on a Dirichlet beta = 0.25 split, through run_sweep."""
    import numpy as np
    import torch
    from repro_torch.data import federated_split
    from repro_torch.experiments import engine, sweep
    from repro_torch.local import get_local, local_device_grads
    from repro_torch.train.paper_repro import device_grads, flat_grad_fn

    (xtr, ytr), (xte, yte) = surrogate()
    x_dev, y_dev = federated_split(xtr, ytr, m=LOCAL_M, b=LOCAL_B,
                                   kind="dirichlet", beta=LOCAL_BETA, seed=0)
    data = (x_dev, y_dev, xte, yte)
    base = dataclasses.replace(cfg, p_avg=LOCAL_P_AVG, prox_mu=PROX_MU,
                               dyn_alpha=DYN_ALPHA)
    kw = dict(steps=steps, lr=1e-3, eval_every=eval_every,
              local_lr=LOCAL_LR, device=device)
    total = {}
    counted = launch_counter("local", total)

    # (a) the grid: three static groups of G = 3 batched points
    axes = {"local": list(LOCAL_ALGOS), "local_epochs": list(LOCAL_EPOCHS)}
    t0 = time.perf_counter()
    res, _ = counted(lambda: sweep.run_sweep(
        (x_dev, y_dev), (xte, yte), base, axes, steps=steps, lr=1e-3,
        eval_every=eval_every, local_lr=LOCAL_LR, device=device),
        len(LOCAL_ALGOS) * steps)
    sweep_s = time.perf_counter() - t0
    check(len(res.records) == len(LOCAL_ALGOS) * len(LOCAL_EPOCHS),
          f"local: {len(res.records)} records")
    last = None
    for rec in res.records:
        one = engine.run_compiled(*data, dataclasses.replace(
            base, local=rec["local"], local_epochs=rec["local_epochs"]),
            **kw)
        check(rec["accs"] == one.accs and rec["losses"] == one.losses,
              f"local grid {rec['local']} E={rec['local_epochs']}: the "
              f"record {rec['losses']} is not its own run_compiled "
              f"{one.losses}")
        check(all(np.isfinite(one.all_losses)),
              f"local: non-finite losses {one.losses}")
        last = one

    # (b) the E = 1 pin: sgd compiled for 2 epochs and run at 1 is the
    # one-gradient round, at a trained model's weights
    params = {k: v.clone() for k, v in last.params.items()}
    xd = torch.as_tensor(x_dev, device=device)
    yd = torch.as_tensor(y_dev, device=device).long()
    lw = get_local(dataclasses.replace(base, local="sgd", local_epochs=2),
                   LOCAL_LR, device=device).with_overrides(local_epochs=1.0)
    pinned = local_device_grads(lw, flat_grad_fn(params), params, xd, yd,
                                None)[0]
    plain = device_grads(params, xd, yd, None)[0]
    torch.cuda.synchronize()
    check(torch.equal(pinned, plain), "local: sgd at E=1 under a 2-epoch "
          "bound is not device_grads bitwise on the card")

    # (c) local=sgd, E=1 in a grid is the AWGN engine run bitwise
    sgd, _ = counted(lambda: sweep.run_sweep(
        (x_dev, y_dev), (xte, yte), dataclasses.replace(base, local="sgd"),
        {"local_epochs": [1, 2]}, steps=steps, lr=1e-3,
        eval_every=eval_every, local_lr=LOCAL_LR, device=device), steps)
    awgn = engine.run_compiled(*data, base, **kw)
    rec = sgd.record(local_epochs=1)
    check(rec["accs"] == awgn.accs and rec["losses"] == awgn.losses,
          "local: sgd at E=1 in a grid is not the AWGN run_compiled")

    # per group: ms per batched round, beside the heaviest point's lone
    # run and the AWGN round, in turns
    exp0 = engine.Experiment(cfg=base, steps=steps, eval_every=eval_every,
                             local_lr=LOCAL_LR)
    awgn_ce = engine.CompiledExperiment(*data, exp0, device=device)
    keys = engine.round_keys(steps, 0, device)
    grid = [{"local_epochs": e} for e in LOCAL_EPOCHS]
    groups = []
    for algo in LOCAL_ALGOS:
        # built for the grid's largest E, so its static epoch bound covers
        # every point; each point's own E is its override
        exp = dataclasses.replace(exp0, cfg=dataclasses.replace(
            base, local=algo, local_epochs=max(LOCAL_EPOCHS)))
        ce = engine.CompiledExperiment(*data, exp, device=device)
        ov, gkeys, _ = sweep.grid_inputs(ce, grid, steps)
        _, gn = counted(lambda: ce.run_grid(ov, gkeys), steps)
        lone = engine.CompiledExperiment(*data, exp, device=device)
        a_ms, g_ms = alternating_ms(lambda: awgn_ce.run({}, keys),
                                    lambda: ce.run_grid(ov, gkeys), reps=2)
        l_ms, _ = alternating_ms(lambda: lone.run({}, keys),
                                 lambda: awgn_ce.run({}, keys), reps=2)
        groups.append(dict(
            local=algo, points=len(grid), launches=gn,
            ms_per_batched_round=g_ms / steps,
            ms_per_round_lone_e4=l_ms / steps,
            awgn_ms_per_round=a_ms / steps,
            final_accs={str(r["local_epochs"]): r["final_acc"]
                        for r in res.records if r["local"] == algo},
            vs_run_compiled="bitwise"))
    return dict(
        phase="local", steps=steps, m=LOCAL_M, b=LOCAL_B, beta=LOCAL_BETA,
        d=7850, axes=axes, local_lr=LOCAL_LR, prox_mu=PROX_MU,
        dyn_alpha=DYN_ALPHA, p_avg=LOCAL_P_AVG,
        config=dict(projection=cfg.projection, block_size=cfg.block_size,
                    use_kernel=cfg.use_kernel, amp_iters=cfg.amp_iters),
        launches=total, sweep_s=sweep_s, e1_pin="bitwise",
        sgd_e1_is_awgn_run="bitwise", groups=groups)


# ---------------------------------------------------------------------------
# phase 11: the sampled-cohort population engine
# ---------------------------------------------------------------------------


def run_population_phase(data, cfg, device, steps: int = STEPS,
                         eval_every: int = 5, stop_at: int = 10):
    """K == M against run_compiled, Fig. 10 FULL's largest sampled point,
    churn with stragglers and edge sites, an avail_rate grid and a FedDyn
    resume."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import population as pop_mod
    from repro_torch.data.partition import population_partition
    from repro_torch.experiments import engine, sweep
    from repro_torch.population import engine as pop_engine

    x_dev, y_dev, xte, yte = data
    (xtr, ytr), _ = surrogate()
    kw = dict(steps=steps, lr=1e-3, eval_every=eval_every, device=device)
    total = {}
    counted = launch_counter("population", total)

    def same(a, b):
        return (a.accs == b.accs and a.losses == b.losses
                and a.all_losses.tolist() == b.all_losses.tolist()
                and all(torch.equal(a.params[k], b.params[k])
                        for k in a.params))

    # (a) K == M = 25 on the slice's data is run_compiled bitwise
    m = int(x_dev.shape[0])
    dense = pop_mod.PopulationData.from_dense(x_dev, y_dev, device=device)
    full, _ = counted(lambda: pop_mod.run_population(
        dense, xte, yte, cfg, pop_mod.PopulationConfig(m_total=m,
                                                       k_cohort=m), **kw),
        steps)
    comp = engine.run_compiled(x_dev, y_dev, xte, yte, cfg, **kw)
    check(same(full, comp), "population: K == M is not run_compiled bitwise")

    # (b) Fig. 10 FULL's largest sampled point
    part = population_partition(ytr, m=POP_M, b=POP_B, kind="iid", seed=0)
    pool = pop_mod.PopulationData.from_pool(xtr, ytr, part, device=device)
    pop = pop_mod.PopulationConfig(m_total=POP_M, k_cohort=POP_K,
                                   capacity=POP_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    big, _ = counted(lambda: pop_mod.run_population(
        pool, xte, yte, cfg, pop, **kw), steps)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(big.all_losses)) and big.losses[-1]
          < big.losses[0], f"population: loss did not fall {big.losses}")
    exp = pop_mod.PopulationExperiment(cfg=cfg, pop=pop, steps=steps,
                                       eval_every=eval_every)
    cp = pop_mod.CompiledPopulation(pool, xte, yte, exp, device=device)
    banks = cp.pstate0.banks
    bank_bytes = banks.deltas.numel() * banks.deltas.element_size()
    awgn_ce = engine.CompiledExperiment(
        x_dev, y_dev, xte, yte, engine.Experiment(cfg=cfg, steps=steps,
                                                  eval_every=eval_every),
        device=device)
    keys = engine.round_keys(steps, 0, device)
    a_ms, p_ms = alternating_ms(lambda: awgn_ce.run({}, keys),
                                lambda: cp.run({}, keys), reps=2)
    runs = {"fig10_full_largest": dict(
        m_total=POP_M, k_cohort=POP_K, b=POP_B, capacity=POP_CAPACITY,
        bank_bytes=bank_bytes, peak_allocated_bytes=peak,
        final_acc=big.accs[-1], accs=big.accs,
        ms_per_round=p_ms / steps, awgn_ms_per_round=a_ms / steps)}

    # (c) churn, stragglers and four edge sites: the mac hook runs
    calls = []
    inner = pop_engine.site_mac_sum

    def spy(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    churned = dataclasses.replace(pop, avail_rate=0.9, speed_sigma=0.5,
                                  straggler_deadline=5.0, n_sites=4)
    pop_engine.site_mac_sum = spy
    try:
        run, n = counted(lambda: pop_mod.run_population(
            pool, xte, yte, cfg, churned, **dict(kw, eval_every=1)), steps)
    finally:
        pop_engine.site_mac_sum = inner
    check(len(calls) == steps, f"population: the site MAC ran {len(calls)} "
          f"times in {steps} rounds")
    check(all(np.isfinite(run.all_losses)),
          f"population: non-finite losses {run.losses}")
    cp2 = pop_mod.CompiledPopulation(pool, xte, yte, dataclasses.replace(
        exp, pop=churned), device=device)
    a_ms, c_ms = alternating_ms(lambda: awgn_ce.run({}, keys),
                                lambda: cp2.run({}, keys), reps=2)
    fracs = [mt["cohort_frac"] for mt in run.metrics]
    runs["churn_stragglers_sites"] = dict(
        avail_rate=0.9, speed_sigma=0.5, straggler_deadline=5.0, n_sites=4,
        launches=n, site_mac_calls=len(calls),
        mean_cohort_frac=float(np.mean(fracs)), min_cohort_frac=min(fracs),
        final_acc=run.accs[-1], ms_per_round=c_ms / steps,
        awgn_ms_per_round=a_ms / steps)

    # (d) an avail_rate grid: each record its own run_population
    res, _ = counted(lambda: sweep.run_population_sweep(
        pool, (xte, yte), cfg, pop, {"avail_rate": list(POP_AVAIL_GRID)},
        steps=steps, lr=1e-3, eval_every=eval_every, device=device), steps)
    for rec in res.records:
        one = pop_mod.run_population(pool, xte, yte, cfg, dataclasses.replace(
            pop, avail_rate=rec["avail_rate"]), **kw)
        check(rec["accs"] == one.accs and rec["losses"] == one.losses,
              f"population grid avail_rate={rec['avail_rate']}: the record "
              "is not its own run_population")
    ov, gkeys = sweep.population_grid_inputs(
        cp, [{"avail_rate": v} for v in POP_AVAIL_GRID], steps)
    a_ms, g_ms = alternating_ms(lambda: awgn_ce.run({}, keys),
                                lambda: cp.run_grid(ov, gkeys), reps=2)
    grid = dict(axis="avail_rate", values=list(POP_AVAIL_GRID),
                final_accs=[r["final_acc"] for r in res.records],
                vs_run_population="bitwise",
                ms_per_batched_round=g_ms / steps,
                awgn_ms_per_round=a_ms / steps)

    # (e) a FedDyn population run, checkpointed and resumed
    dyn = dataclasses.replace(cfg, local="feddyn", local_epochs=2,
                              dyn_alpha=DYN_ALPHA)
    small = dataclasses.replace(pop, capacity=1024)
    dkw = dict(kw, local_lr=LOCAL_LR)
    whole, _ = counted(lambda: pop_mod.run_population(
        pool, xte, yte, dyn, small, **dkw), steps)
    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(dkw, checkpoint_dir=tmp, checkpoint_every=eval_every)
        stopped = pop_mod.run_population(pool, xte, yte, dyn, small,
                                         stop_after_step=stop_at, **ck)
        check(stopped is None, "population: the FedDyn run did not stop")
        resumed = pop_mod.run_population(pool, xte, yte, dyn, small,
                                         resume=True, **ck)
    torch.cuda.synchronize()
    check(same(resumed, whole), "population: the FedDyn resume is not "
          "bitwise the uninterrupted run")
    runs["feddyn_resumed"] = dict(capacity=1024, local_epochs=2,
                                  dyn_alpha=DYN_ALPHA, final_acc=whole.accs[-1],
                                  resumed="bitwise")
    return dict(
        phase="population", steps=steps, d=7850,
        config=dict(projection=cfg.projection, block_size=cfg.block_size,
                    use_kernel=cfg.use_kernel, amp_iters=cfg.amp_iters),
        launches=total, k_equals_m_is_run_compiled="bitwise", runs=runs,
        grid=grid)


# ---------------------------------------------------------------------------
# phase 12: the sharded slice drivers on a mesh of ranks
# ---------------------------------------------------------------------------


def sharded_loop(xd, yd, cfg, driver: str, mesh, ctx, device):
    """A training loop through one sharded driver: per round the device
    gradients of the mesh's device rows (``device_grads``), the driver once
    per rank under ``shard_map``, and Adam at the PS on the replicated
    estimate.  Returns ``step(t, key) -> ghat`` and its state."""
    import torch
    from repro_torch.convert import unravel
    from repro_torch.core import distributed
    from repro_torch.core.schemes import get_scheme, round_sharded
    from repro_torch.optim.optim import Optimizer
    from repro_torch.sharding import P, shard_map
    from repro_torch.train.paper_repro import device_grads, init_linear
    m, d = xd.shape[0], 7850
    params = init_linear(xd.shape[-1], 10, device)
    scheme = get_scheme(cfg, d, m, device=device)
    opt = Optimizer(lr=1e-3)
    width = ctx.d_pad if driver == "sharded_round" else d
    st = dict(params=params, opt=opt.init(params),
              deltas=torch.zeros((m, width), device=device))
    if driver == "sharded_round":
        rows, ghat_spec = P("dev", "shard"), P("shard")

        def body(g, dl, t, key):
            ghat, nd, _ = distributed.sharded_round(
                scheme, g.reshape(-1), dl.reshape(-1), t, key, ctx)
            return ghat, nd.reshape(1, -1)
    else:
        rows, ghat_spec = P("dev"), P()

        def body(g, dl, t, key):
            ghat, nd, _ = round_sharded(scheme, g.reshape(-1),
                                        dl.reshape(-1), t, key, ctx)
            return ghat, nd.reshape(1, -1)
    run = shard_map(body, mesh, (rows, rows, None, None), (ghat_spec, rows))

    def step(t, key):
        grads, _ = device_grads(st["params"], xd, yd, None)
        g = torch.nn.functional.pad(grads, (0, width - d))
        ghat, st["deltas"] = run(g, st["deltas"], t, key)
        ghat = ghat[:d]
        st["params"], st["opt"] = opt.apply(
            st["params"], unravel(ghat, st["params"]), st["opt"])
        return ghat

    return step, st


def sharded_train(xd, yd, cfg, driver, mesh, ctx, device, steps):
    """``steps`` rounds of :func:`sharded_loop`, each between a pair of
    CUDA events: ``(ghats (steps, d), state, ms per round)``."""
    import torch
    from repro_torch.experiments import engine
    step, st = sharded_loop(xd, yd, cfg, driver, mesh, ctx, device)
    keys = engine.round_keys(steps, 0, device)
    ghats, events = [], []
    for t in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ghats.append(step(t, keys[t]))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (torch.stack(ghats), st,
            [a.elapsed_time(b) for a, b in events])


def pg_train(xd, yd, mesh, device, rounds: int):
    """The process-group check's run: sharded_round with the kernels on a
    2 x 2 mesh at the slice's width."""
    from repro_torch.core.schemes import MACContext
    ctx = MACContext(m=2, device_axes=("dev",), shard_axes=("shard",),
                     d_pad=SHARDED_D_PAD, use_kernel=True)
    ghats, st, _ = sharded_train(xd, yd, slice_config(STEPS), "sharded_round",
                                 mesh, ctx, device, rounds)
    return ghats, st


def pg_worker(rank: int, store: str, data_path: str, out_path: str,
              rounds: int) -> None:
    """One rank of the 2 x 2 gloo process group (run in its own process by
    :func:`run_process_group`)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import sharding
    from repro_torch.device import resolve_device
    device = resolve_device(None)
    mesh = sharding.init_process_mesh(
        (2, 2), ("dev", "shard"), rank=rank, world_size=4,
        init_method="file://" + store, timeout=300)
    try:
        xd, yd = (t.to(device) for t in torch.load(data_path))
        ghats, st = pg_train(xd, yd, mesh, device, rounds)
        torch.save({"ghats": ghats.cpu(), "deltas": st["deltas"].cpu(),
                    "w": st["params"]["w"].cpu()}, out_path)
    finally:
        sharding.close_process_mesh()


def run_process_group(xd, yd, device, rounds: int = PG_ROUNDS) -> dict:
    """(f): four processes on the one card, a 2 x 2 gloo mesh, against the
    thread mesh at the same 2 x 2 in this process, bitwise."""
    import tempfile
    import torch
    from repro_torch.sharding import Mesh
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data.pt"
        torch.save((xd.cpu(), yd.cpu()), data)
        outs = [Path(tmp) / f"rank{r}.pt" for r in range(4)]
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.pg_worker(int(sys.argv[2]), "
                "*sys.argv[3:6], int(sys.argv[6]))")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(ROOT), str(r),
             str(Path(tmp) / "store"), str(data), str(outs[r]), str(rounds)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(4)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              "sharded (f): a process-group rank failed:\n"
              + "\n".join(log[-3000:] for log in logs))
        got = [torch.load(o) for o in outs]
    pg_s = time.perf_counter() - t0
    ghats, st = pg_train(xd, yd, Mesh((2, 2), ("dev", "shard")), device,
                         rounds)
    want = {"ghats": ghats.cpu(), "deltas": st["deltas"].cpu(),
            "w": st["params"]["w"].cpu()}
    for r, rec in enumerate(got):
        for k in want:
            check(torch.equal(rec[k], want[k]), f"sharded (f): rank {r}'s "
                  f"{k} after {rounds} rounds differs from the thread mesh's")
    check(bool(torch.isfinite(want["ghats"]).all()),
          "sharded (f): non-finite estimate")
    return dict(mesh=[2, 2], transport="gloo, 4 processes on one card",
                rounds=rounds, vs_thread_mesh="bitwise",
                processes_s=pg_s)


def run_sharded_phase(data, cfg, device, steps: int = STEPS):
    import torch
    from repro_torch import rng
    from repro_torch.core.schemes import MACContext, get_scheme
    from repro_torch.kernels import ops
    from repro_torch.optim.optim import Optimizer
    from repro_torch.sharding import Mesh
    from repro_torch.train.paper_repro import accuracy, init_linear, train_step
    x_dev, y_dev, xte, yte = data
    m = SHARDED_M
    xd = torch.as_tensor(x_dev[:m], device=device)
    yd = torch.as_tensor(y_dev[:m], device=device).long()
    xt = torch.as_tensor(xte, device=device)
    yt = torch.as_tensor(yte, device=device).long()
    mesh2 = Mesh((m, SHARDED_SHARDS), ("dev", "shard"))
    mesh1 = Mesh((m,), ("dev",))
    slice_kw = dict(m=m, device_axes=("dev",), shard_axes=("shard",),
                    d_pad=SHARDED_D_PAD)
    runs = {
        "a_sharded_round": ("sharded_round", mesh2, slice_kw),
        "b_shard_decode": ("sharded_round", mesh2,
                           dict(slice_kw, shard_decode=True)),
        "c_round_sharded": ("round_sharded", mesh1,
                            dict(m=m, device_axes=("dev",))),
        "d_sites": ("sharded_round", mesh2,
                    dict(slice_kw, groups=SHARDED_GROUPS, site_mac=True)),
        "e_bf16_frame": ("sharded_round", mesh2,
                         dict(slice_kw, frame_dtype=torch.bfloat16)),
    }
    # one launch per rank and round: sharded_round's encode runs the error
    # feedback and projects, its decode decodes one block; round_sharded's
    # encode runs all three main-path kernels
    n2 = mesh2.size
    per_round = {"sharded_round": {"ef_sparsify": n2, "ota_project": n2,
                                   "ota_project_t": 0, "amp_fused": n2},
                 "round_sharded": {"ef_sparsify": m, "ota_project": m,
                                   "ota_project_t": 0, "amp_fused": m}}

    # the simulated slice's round at the same config, for the turns
    sim = get_scheme(cfg, 7850, m, device=device)
    sim_opt = Optimizer(lr=1e-3)
    sim_params = init_linear(xd.shape[-1], 10, device)
    sim_state = sim_opt.init(sim_params)
    sim_deltas = torch.zeros((m, 7850), device=device)
    sim_key = rng.PRNGKey(1000, device=device)

    def sim_round():
        train_step(sim, sim_opt, sim_params, sim_state, sim_deltas, None, xd,
                   yd, 0, sim_key)

    total = {k: 0 for k in KERNELS}
    out, ghats_of = {}, {}
    for name, (driver, mesh, kw) in runs.items():
        rounds = steps if name == "a_sharded_round" else SHARDED_SHORT
        ctx = MACContext(use_kernel=True, **kw)
        ops.reset_launches()
        t0 = time.perf_counter()
        ghats, st, ms = sharded_train(xd, yd, cfg, driver, mesh, ctx, device,
                                      rounds)
        run_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        for k in total:
            total[k] += launches[k]
        want = {k: v * rounds for k, v in per_round[driver].items()}
        check(launches == want, f"sharded {name}: launches {launches}, "
              f"expected {want}")
        check(bool(torch.isfinite(ghats).all()),
              f"sharded {name}: non-finite estimate")
        acc = float(accuracy(st["params"], xt, yt))
        ghats_of[name] = ghats
        step, _ = sharded_loop(xd, yd, cfg, driver, mesh, ctx, device)
        round_ms, sim_ms = alternating_ms(lambda: step(0, sim_key), sim_round,
                                          reps=2)
        out[name] = dict(
            driver=driver, mesh=list(mesh.shape), rank_threads=mesh.size,
            rounds=rounds, final_acc=acc, ms_per_round=statistics.median(ms),
            ms_per_round_all=ms, run_s=run_s,
            launches_per_round={k: v / rounds for k, v in launches.items()},
            turns=dict(sharded_ms_per_round=round_ms,
                       simulated_ms_per_round=sim_ms))
    check(out["a_sharded_round"]["final_acc"] > 0.5,
          f"sharded (a): test accuracy {out['a_sharded_round']['final_acc']}"
          f" after {steps} rounds")

    def first_rounds(name, other, what):
        n = other.shape[0]
        check(torch.equal(ghats_of[name][:n], other),
              f"sharded {name}: {what} differ in the first {n} rounds")

    # with the kernels bitwise their own plain runs on the card
    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    ops.reset_launches()
    for name in ("a_sharded_round", "b_shard_decode", "c_round_sharded"):
        driver, mesh, kw = runs[name]
        plain, _, _ = sharded_train(xd, yd, plain_cfg, driver, mesh,
                                    MACContext(use_kernel=False, **kw),
                                    device, SHARDED_SHORT)
        first_rounds(name, plain, "the kernel run's and the plain run's "
                     "estimates")
        out[name]["vs_plain"] = "bitwise"
    check(sum(ops.launch_counts().values()) == 0,
          "sharded: a plain run launched a kernel")
    first_rounds("a_sharded_round", ghats_of["b_shard_decode"],
                 "shard_decode's estimates and the full decode's")
    out["b_shard_decode"]["vs_a"] = "bitwise"
    again, _, _ = sharded_train(xd, yd, cfg, *runs["a_sharded_round"][:2],
                                MACContext(use_kernel=True,
                                           **runs["a_sharded_round"][2]),
                                device, SHARDED_SHORT)
    first_rounds("a_sharded_round", again, "two runs")
    out["a_sharded_round"]["two_runs"] = "bitwise"
    pg = run_process_group(xd[:2], yd[:2], device)
    return dict(
        phase="sharded", steps=steps, short_rounds=SHARDED_SHORT, d=7850,
        d_pad=SHARDED_D_PAD,
        config=dict(projection=cfg.projection, block_size=cfg.block_size,
                    s_frac=cfg.s_frac, k_frac=cfg.k_frac,
                    use_kernel=cfg.use_kernel, amp_iters=cfg.amp_iters),
        launches=total, runs=out, process_group=pg)


# ---------------------------------------------------------------------------
# phase 13: the streamed federated LLM round at full width
# ---------------------------------------------------------------------------


def _events_ms(fn):
    """``fn()``'s result and its time in ms between two CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_fedllm_phase(device, slice_line):
    import torch
    from repro_torch.configs.base import TrainConfig, get_config, ota_overrides
    from repro_torch.experiments.engine import round_keys
    from repro_torch.kernels import ops
    from repro_torch.train import fedllm

    arch = get_config(FEDLLM_ARCH)
    ota = dataclasses.replace(ota_overrides(FEDLLM_ARCH), use_kernel=True)
    train_cfg = TrainConfig()
    kw = dict(m=FEDLLM_M, batch=FEDLLM_BATCH, seq_len=FEDLLM_SEQ, seed=0,
              device=device)
    fed = fedllm.CompiledFedLLM(arch, train_cfg, ota,
                                chunk_size=FEDLLM_CHUNK, **kw)
    check(fed.d == FEDLLM_D and fed.n_chunks == FEDLLM_CHUNKS,
          f"fedllm: d {fed.d}, {fed.n_chunks} chunks; expected {FEDLLM_D}, "
          f"{FEDLLM_CHUNKS}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = fed.carry0()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    keys = round_keys(1 + FEDLLM_ROUNDS, 0, device=device)

    # (a) one warm-up round, then the timed rounds through run_segment
    carry, warm = fed.run_segment({}, keys[:1], None, carry, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {"ef_sparsify": FEDLLM_CHUNKS, "ota_project": FEDLLM_CHUNKS,
            "ota_project_t": 0, "amp_fused": FEDLLM_CHUNKS}
    total = {k: 0 for k in KERNELS}
    ms, losses, per_round = [], [float(warm["loss"][0])], []
    for t in range(1, 1 + FEDLLM_ROUNDS):
        ops.reset_launches()
        (carry, out), t_ms = _events_ms(lambda: fed.run_segment(
            {}, keys[t:t + 1], None, carry, t))
        launches = ops.launch_counts()
        check(launches == want, f"fedllm round {t}: launches {launches}, "
              f"expected {want}")
        for k in total:
            total[k] += launches[k]
        ms.append(t_ms)
        losses.append(float(out["loss"][0]))
        per_round.append(launches)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"fedllm: losses {losses}")
    mets = {k: float(v[0]) for k, v in out["metrics"].items()}
    check(all(map(math.isfinite, mets.values())), f"fedllm: metrics {mets}")

    # the split of one more round into its pieces, by CUDA events
    t = 1 + FEDLLM_ROUNDS
    key = round_keys(t + 1, 0, device=device)[t]
    (gflat, loss), grads_ms = _events_ms(lambda: fed._grads(carry[0], key))
    gch = gflat.view(fed.m, fed.n_chunks, fed.chunk_len).transpose(0, 1)
    (ghats, _, _), stream_ms = _events_ms(lambda: fedllm.stream_round(
        fed.scheme, gch, carry[2], t, key, fed.ctx))
    ghat = ghats.reshape(fed.d_pad)[:fed.d]
    _, adam_ms = _events_ms(lambda: fed.opt.apply(
        carry[0], fed.unravel(ghat), carry[1]))
    del ghats, ghat

    # (b) the first chunks on the same gradients: bitwise the plain run
    # and the per-chunk round_simulated loop on the card
    n = FEDLLM_PLAIN_CHUNKS
    plain_ms = _first_chunks_bitwise(fed, ota, gch, carry[2], t, key, device,
                                     "fedllm (b)")

    # (c) the default chunk size over its first chunks
    fed14 = fedllm.CompiledFedLLM(arch, train_cfg, ota,
                                  chunk_size=FEDLLM_DEFAULT_CHUNK, **kw)
    check(fed14.n_chunks == FEDLLM_DEFAULT_CHUNKS,
          f"fedllm (c): {fed14.n_chunks} chunks")
    nc, L = FEDLLM_TIMED_CHUNKS, fed14.chunk_len
    gch14 = gflat[:, :nc * L].reshape(fed.m, nc, L).transpose(0, 1)
    deltas14 = torch.zeros((nc, fed.m, L), device=device)
    fedllm.stream_round(fed14.scheme, gch14[:2], deltas14[:2], 0, key,
                        fed14.ctx)
    ops.reset_launches()
    (g14, _, _), c_ms = _events_ms(lambda: fedllm.stream_round(
        fed14.scheme, gch14, deltas14, 0, key, fed14.ctx))
    launches14 = ops.launch_counts()
    check(launches14["amp_fused"] == nc and launches14["ef_sparsify"] == nc
          and launches14["ota_project"] == nc,
          f"fedllm (c): launches {launches14} over {nc} chunks")
    check(bool(torch.isfinite(g14).all()), "fedllm (c): non-finite estimate")
    del gflat, gch, gch14, g14
    torch.cuda.empty_cache()
    return dict(
        phase="fedllm", arch=FEDLLM_ARCH, d=fed.d, d_pad=fed.d_pad,
        m=fed.m, batch=FEDLLM_BATCH, seq_len=FEDLLM_SEQ,
        chunk_size=FEDLLM_CHUNK, n_chunks=fed.n_chunks,
        blocks_per_chunk=fed.scheme.projector.n_blocks,
        config=dict(projection=ota.projection, block_size=ota.block_size,
                    s_frac=ota.s_frac, k_frac=ota.k_frac,
                    rademacher=ota.rademacher, use_kernel=ota.use_kernel,
                    state_dtype=ota.state_dtype,
                    compute_dtype=train_cfg.compute_dtype,
                    remat=train_cfg.remat, warmup_steps=train_cfg.warmup_steps),
        init_s=init_s, rounds=FEDLLM_ROUNDS, ms_per_round=ms,
        ms_per_round_median=statistics.median(ms),
        round_split_ms=dict(grads=grads_ms, stream=stream_ms, adam=adam_ms),
        simulated_round_ms=slice_line["round_ms"],
        peak_allocated_gb=peak / 1e9, losses=losses, final_metrics=mets,
        launches=total, launches_per_round=per_round,
        first_chunks_vs_plain="bitwise", first_chunks_vs_ref="bitwise",
        plain_chunks=n, plain_ms_for_chunks=plain_ms,
        default_chunk=dict(chunk_size=FEDLLM_DEFAULT_CHUNK, chunks_timed=nc,
                           ms=c_ms, ms_per_chunk=c_ms / nc,
                           n_chunks=fed14.n_chunks,
                           projected_round_ms=c_ms / nc * fed14.n_chunks,
                           launches=launches14))


# ---------------------------------------------------------------------------
# phase 14: the MoE streamed round and the other families at full width
# ---------------------------------------------------------------------------


def _first_chunks_bitwise(fed, ota, gch, deltas, t, key, device, what):
    """The first ``FEDLLM_PLAIN_CHUNKS`` chunks' stream on the kernels,
    bitwise the use_kernel=False run and ``stream_round_ref``; the plain
    run's ms."""
    import torch
    from repro_torch.core.schemes import get_scheme
    from repro_torch.kernels import ops
    from repro_torch.train import fedllm

    n = FEDLLM_PLAIN_CHUNKS
    plain = get_scheme(dataclasses.replace(ota, use_kernel=False),
                       fed.chunk_len, fed.m, device=device)
    plain_ctx = dataclasses.replace(fed.ctx, use_kernel=False)
    ops.reset_launches()
    kern = fedllm.stream_round(fed.scheme, gch[:n], deltas[:n], t, key,
                               fed.ctx)
    loop = fedllm.stream_round_ref(fed.scheme, gch[:n], deltas[:n], t, key,
                                   fed.ctx)
    check(ops.launch_counts()["amp_fused"] == 2 * n,
          f"{what}: the kernel runs did not launch amp_fused per chunk")
    ops.reset_launches()
    ref_out, plain_ms = _events_ms(lambda: fedllm.stream_round(
        plain, gch[:n], deltas[:n], t, key, plain_ctx))
    check(sum(ops.launch_counts().values()) == 0,
          f"{what}: the plain run launched a kernel")
    for name, other in (("use_kernel=False", ref_out),
                        ("stream_round_ref", loop)):
        check(torch.equal(kern[0], other[0])
              and torch.equal(kern[1], other[1])
              and all(torch.equal(kern[2][k], other[2][k])
                      for k in kern[2]),
              f"{what}: the first {n} chunks differ from {name}")
    return plain_ms


def wide_loss_and_grad(device, arch_id: str, n_layers: int) -> dict:
    """One device's bfloat16 loss and gradient (remat on) of a zoo model at
    its published widths with ``n_layers`` layers, on seeded weights and 2
    x 16 seeded tokens: finite, ms by CUDA events, peak memory."""
    import torch
    from repro_torch import rng
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.models import model as model_lib

    free_device_memory()
    cfg = dataclasses.replace(get_config(arch_id), n_layers=n_layers)
    params = model_lib.init_params(cfg, rng.PRNGKey(0, device=device))
    n_params = model_lib.param_count(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    batch = {"tokens": rng.randint(rng.PRNGKey(1, device=device),
                                   (FEDLLM_BATCH, FEDLLM_SEQ), 0, cfg.vocab)}

    def step():
        loss, met = model_lib.loss_fn(params, cfg, batch,
                                      compute_dtype=torch.bfloat16,
                                      remat=True)
        return loss, torch.autograd.grad(loss, tree_leaves(params))

    step()                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (loss, grads), ms = _events_ms(step)
    peak = torch.cuda.max_memory_allocated()
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads)))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    loss = float(loss.detach())
    check(math.isfinite(loss) and finite and math.isfinite(gnorm),
          f"{arch_id} at {n_layers} layers: loss {loss}, gradient finite "
          f"{finite}")
    out = dict(arch=arch_id, n_layers=n_layers, params=n_params, loss=loss,
               grad_norm=gnorm, ms=ms, peak_allocated_gb=peak / 1e9)
    del params, grads
    free_device_memory()
    return out


def run_fedllm_moe_phase(device) -> dict:
    import torch
    from repro_torch import rng
    from repro_torch.configs.base import TrainConfig, get_config, ota_overrides
    from repro_torch.experiments.engine import round_keys
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.train import fedllm

    free_device_memory()
    arch = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    ota = dataclasses.replace(ota_overrides(MOE_ARCH), use_kernel=True)
    train_cfg = TrainConfig()
    fed = fedllm.CompiledFedLLM(arch, train_cfg, ota, m=FEDLLM_M,
                                batch=FEDLLM_BATCH, seq_len=FEDLLM_SEQ,
                                chunk_size=FEDLLM_CHUNK, seed=0,
                                device=device)
    check(fed.d == MOE_D and fed.n_chunks == MOE_CHUNKS,
          f"fedllm_moe: d {fed.d}, {fed.n_chunks} chunks; expected {MOE_D}, "
          f"{MOE_CHUNKS}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = fed.carry0()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    keys = round_keys(1 + MOE_ROUNDS, 0, device=device)

    # (a) one warm-up round, then the timed rounds through run_segment
    carry, warm = fed.run_segment({}, keys[:1], None, carry, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {"ef_sparsify": MOE_CHUNKS, "ota_project": MOE_CHUNKS,
            "ota_project_t": 0, "amp_fused": MOE_CHUNKS}
    total = {k: 0 for k in KERNELS}
    ms, losses = [], [float(warm["loss"][0])]
    for t in range(1, 1 + MOE_ROUNDS):
        ops.reset_launches()
        (carry, out), t_ms = _events_ms(lambda: fed.run_segment(
            {}, keys[t:t + 1], None, carry, t))
        launches = ops.launch_counts()
        check(launches == want, f"fedllm_moe round {t}: launches {launches}, "
              f"expected {want}")
        for k in total:
            total[k] += launches[k]
        ms.append(t_ms)
        losses.append(float(out["loss"][0]))
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"fedllm_moe: losses {losses}")
    mets = {k: float(v[0]) for k, v in out["metrics"].items()}
    check(all(map(math.isfinite, mets.values())),
          f"fedllm_moe: metrics {mets}")

    # the split of one more round into its pieces, by CUDA events
    t = 1 + MOE_ROUNDS
    key = round_keys(t + 1, 0, device=device)[t]
    (gflat, loss), grads_ms = _events_ms(lambda: fed._grads(carry[0], key))
    gch = gflat.view(fed.m, fed.n_chunks, fed.chunk_len).transpose(0, 1)
    (ghats, _, _), stream_ms = _events_ms(lambda: fedllm.stream_round(
        fed.scheme, gch, carry[2], t, key, fed.ctx))
    ghat = ghats.reshape(fed.d_pad)[:fed.d]
    _, adam_ms = _events_ms(lambda: fed.opt.apply(
        carry[0], fed.unravel(ghat), carry[1]))
    del ghats, ghat
    # the MoE aux of device 0's batch of that round
    with torch.no_grad():
        dev_key = rng.split(rng.fold_in(key, fedllm.SALT_DATA), fed.m)[0]
        _, met0 = model_lib.loss_fn(carry[0], arch, fed._device_batch(dev_key),
                                    compute_dtype=fed.compute_dtype,
                                    remat=False)
    aux = float(met0["aux"])
    check(math.isfinite(aux) and aux > 0, f"fedllm_moe: MoE aux {aux}")

    # (b) the first chunks on the same gradients: bitwise the plain run
    # and the per-chunk round_simulated loop on the card
    plain_ms = _first_chunks_bitwise(fed, ota, gch, carry[2], t, key, device,
                                     "fedllm_moe (b)")
    del gflat, gch, carry
    free_device_memory()

    # (c) the other families' blocks at their published widths
    wide = [wide_loss_and_grad(device, a, n) for a, n in WIDE_DEPTHS]
    return dict(
        phase="fedllm_moe", arch=MOE_ARCH, n_layers=MOE_LAYERS,
        reduced=[f"n_layers {MOE_LAYERS} of 24 (peak memory: ~64 bytes a "
                 "parameter)"],
        d=fed.d, d_pad=fed.d_pad, m=fed.m, batch=FEDLLM_BATCH,
        seq_len=FEDLLM_SEQ, chunk_size=FEDLLM_CHUNK, n_chunks=fed.n_chunks,
        blocks_per_chunk=fed.scheme.projector.n_blocks,
        moe=dict(num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
                 d_expert=arch.moe.d_expert),
        config=dict(projection=ota.projection, block_size=ota.block_size,
                    s_frac=ota.s_frac, k_frac=ota.k_frac,
                    rademacher=ota.rademacher, use_kernel=ota.use_kernel,
                    state_dtype=ota.state_dtype,
                    compute_dtype=train_cfg.compute_dtype,
                    remat=train_cfg.remat, warmup_steps=train_cfg.warmup_steps),
        init_s=init_s, rounds=MOE_ROUNDS, ms_per_round=ms,
        round_split_ms=dict(grads=grads_ms, stream=stream_ms, adam=adam_ms),
        stream_ms_per_chunk=stream_ms / fed.n_chunks,
        peak_allocated_gb=peak / 1e9, losses=losses, final_metrics=mets,
        moe_aux=aux, moe_aux_per_layer=aux / MOE_LAYERS, launches=total,
        first_chunks_vs_plain="bitwise", first_chunks_vs_ref="bitwise",
        plain_chunks=FEDLLM_PLAIN_CHUNKS, plain_ms_for_chunks=plain_ms,
        wide=wide)


# ---------------------------------------------------------------------------
# phase 15: serve while training, and decoding alone at full depth
# ---------------------------------------------------------------------------


def serve_f32_against_cpu(arch, params, device) -> dict:
    """A float32 batch from ``params`` on the card and on the CPU port: a
    seeded prompt, then greedy tokens, both sides fed the card's tokens.
    The logits within ``SERVE_F32_BAR`` of their largest magnitude and
    the same greedy token at every step."""
    import torch
    from repro_torch.convert import tree_map
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.serve import make_serve_step

    n = SERVE_PROMPT + SERVE_TOKENS
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, arch.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, dtype=torch.int32)
    sides = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        s = make_serve_step(arch, make_local_mesh(), SERVE_BATCH, n,
                            compute_dtype=torch.float32,
                            cache_dtype=torch.float32, device=dev)
        p = params if name == "card" else tree_map(lambda a: a.cpu(), params)
        sides[name] = [s, p, s.init_cache(torch.float32)]
    worst, same, tok = 0.0, True, None
    t0 = time.perf_counter()
    for i in range(SERVE_TOKENS + 1):
        logits = {}
        for name, side in sides.items():
            s, p, cache = side
            if i == 0:
                lg, side[2] = s.prefill_fn(p, cache, prompt.to(s.device))
            else:
                lg, side[2] = s.decode_fn(p, cache, tok.to(s.device),
                                          SERVE_PROMPT + i - 1)
            logits[name] = lg[:, -1].cpu()
        want = logits["cpu"]
        worst = max(worst, float((logits["card"] - want).abs().max()
                                 / want.abs().max()))
        tok = torch.argmax(logits["card"], -1)[:, None].to(torch.int32)
        same = same and torch.equal(tok[:, 0], torch.argmax(want, -1).to(
            torch.int32))
    check(worst <= SERVE_F32_BAR and same,
          f"serve float32: the card's logits {worst:.3e} of their largest "
          f"magnitude from the CPU port's (bar {SERVE_F32_BAR}), same greedy "
          f"tokens {same}")
    return dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, tokens=SERVE_TOKENS,
                max_rel_err=worst, bar=SERVE_F32_BAR, same_tokens=same,
                seconds=time.perf_counter() - t0)


def device_busy(fn, per: int = 1) -> dict:
    """``fn()`` under ``torch.profiler``: the host's ms for it, the
    kernels' device ms, the busy share (device over host time), and the
    device ops and the top six by device time, those two per ``per``
    (steps or calls).  ``busy_share`` "not measured" where the trace holds
    no device time."""
    import torch
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        device_us = sum(dev_us(e) for e in events)
        kernels = sum(e.count for e in events if dev_us(e) > 0)
    except Exception as exc:           # CUPTI may be unavailable here
        return dict(busy_share="not measured", error=repr(exc)[:200])
    if device_us <= 0:
        return dict(busy_share="not measured", wall_ms=wall_ms)
    top = sorted(events, key=lambda e: -dev_us(e))
    return dict(wall_ms=wall_ms, device_ms=device_us / 1e3,
                busy_share=device_us / 1e3 / wall_ms,
                device_ops=kernels / per,
                top=[(e.key[:60], dev_us(e) / 1e3 / per) for e in top[:6]])


def decode_busy_share(arch, params, device, steps: int = 4) -> dict:
    """The device's busy share while the serve batch decodes: the kernels'
    device time in a ``torch.profiler`` trace of ``steps`` bfloat16 decode
    steps over the host's time for them (:func:`device_busy`)."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.serve import make_serve_step

    s = make_serve_step(arch, make_local_mesh(), SERVE_BATCH,
                        SERVE_PROMPT + steps, device=device)
    prompt = torch.zeros((SERVE_BATCH, SERVE_PROMPT), dtype=torch.int32,
                         device=device)
    lg, cache = s.prefill_fn(params, s.init_cache(), prompt)
    tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)

    def decode():
        c = cache
        for i in range(steps):
            _, c = s.decode_fn(params, c, tok, SERVE_PROMPT + i)

    out = device_busy(decode, per=steps)
    if "device_ops" in out:
        out["device_ops_per_step"] = out.pop("device_ops")
    return dict(steps=steps, **out)


def seeded_params(cfg, device):
    """Seeded weights at published widths: a one-layer copy's params (the
    embedding, the head, the shared and encoder blocks, decoder layer 0)
    and every other decoder layer a seeded shuffle of layer 0's entries,
    leaf by leaf, so each leaf keeps its init's distribution.  Drawing the
    whole stack from the model's keys would hold int64 words for every
    entry of a leaf (17 GB of bits for zamba2's in-projection alone) and
    takes ~36 s for zamba2 a layer at a time."""
    import torch
    from repro_torch import rng
    from repro_torch.convert import tree_map
    from repro_torch.models import model as model_lib

    params = model_lib.init_params(dataclasses.replace(cfg, n_layers=1),
                                   rng.PRNGKey(0, device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def stack(one):
        flat = one.reshape(-1)
        out = torch.empty((cfg.n_layers,) + tuple(one.shape[1:]),
                          dtype=one.dtype, device=device)
        out[0] = one[0]
        for i in range(1, cfg.n_layers):
            out[i] = flat[torch.randperm(flat.numel(), generator=gen,
                                         device=device)].view(one.shape[1:])
        return out

    params["blocks"] = tree_map(stack, params["blocks"])
    return params


def serve_wide(device, arch_id: str) -> dict:
    """bfloat16 decoding of a zoo model at full depth and published widths:
    a prefill of a seeded prompt and greedy tokens, ms per token by CUDA
    events, peak memory, finite logits."""
    import torch
    from repro_torch import rng
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.train.serve import make_serve_step

    free_device_memory()
    cfg = get_config(arch_id)
    t0 = time.perf_counter()
    params = seeded_params(cfg, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model_lib.param_count(params)
    b = SERVE_WIDE_BATCH
    s = make_serve_step(cfg, make_local_mesh(), b,
                        SERVE_PROMPT + SERVE_TOKENS, device=device)
    key = rng.PRNGKey(2, device=device)
    prompt = rng.randint(key, (b, SERVE_PROMPT), 0, cfg.vocab)
    enc, enc_ms = (), None
    if cfg.encoder is not None:
        frames = rng.normal_scaled(
            key, (b, cfg.encoder.n_frames, cfg.encoder.d_model), 0.02)
        (out,), enc_ms = _events_ms(lambda: (transformer.encode_audio(
            params, cfg, frames.to(torch.bfloat16)),))
        enc = (out,)
    # a one-step warm-up, then the measured request
    s.decode_fn(params, s.init_cache(), prompt[:, :1], 0, *enc)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    (lg, cache), prefill_ms = _events_ms(
        lambda: s.prefill_fn(params, s.init_cache(), prompt, *enc))
    finite = bool(torch.isfinite(lg).all())
    toks = []

    def decode():
        nonlocal lg, cache
        for i in range(SERVE_TOKENS):
            tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
            toks.append(tok)
            lg, cache = s.decode_fn(params, cache, tok, SERVE_PROMPT + i,
                                    *enc)
        return bool(torch.isfinite(lg).all())

    finite_decode, decode_ms = _events_ms(decode)
    peak = torch.cuda.max_memory_allocated()
    check(finite and finite_decode, f"serve {arch_id}: non-finite logits")
    cache_bytes = sum(leaf.numel() * leaf.element_size()
                      for leaf in tree_leaves(cache))
    out = dict(arch=arch_id, n_layers=cfg.n_layers, params=n_params,
               batch=b, prompt=SERVE_PROMPT, tokens=SERVE_TOKENS,
               init_s=init_s, encode_ms=enc_ms, prefill_ms=prefill_ms,
               ms_per_prefill_token=prefill_ms / SERVE_PROMPT,
               ms_per_token=decode_ms / SERVE_TOKENS,
               cache_bytes=cache_bytes, peak_allocated_gb=peak / 1e9,
               finite=True, sample=torch.cat(toks, 1)[0, :8].tolist())
    del params, cache, lg, enc
    free_device_memory()
    return out


def run_serve_phase(device) -> dict:
    import torch
    from repro_torch.configs.base import TrainConfig, get_config, ota_overrides
    from repro_torch.experiments.engine import round_keys
    from repro_torch.kernels import ops
    from repro_torch.train import fedllm

    free_device_memory()
    arch = get_config(FEDLLM_ARCH)
    ota = dataclasses.replace(ota_overrides(FEDLLM_ARCH), use_kernel=True)
    train_cfg = TrainConfig()
    kw = dict(m=FEDLLM_M, batch=FEDLLM_BATCH, seq_len=FEDLLM_SEQ, seed=0,
              chunk_size=FEDLLM_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fedllm.serve_while_train(
        arch, rounds=SERVE_ROUNDS, ota=ota, train_cfg=train_cfg,
        serve_batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
        decode_steps=SERVE_TOKENS, device=device, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"ef_sparsify": FEDLLM_CHUNKS * SERVE_ROUNDS,
            "ota_project": FEDLLM_CHUNKS * SERVE_ROUNDS, "ota_project_t": 0,
            "amp_fused": FEDLLM_CHUNKS * SERVE_ROUNDS}
    check(launches == want, f"serve (a): launches {launches}, expected {want}")
    check(out["publish_bitwise"], "serve (a): the served params differ from "
          "the decoded globals")
    losses = [float(x) for x in out["losses"]]
    check(all(map(math.isfinite, losses)), f"serve (a): losses {losses}")
    served = [t.tolist() for t in out["served_tokens"]]
    check(all(len(t) == SERVE_BATCH and len(t[0]) == SERVE_TOKENS
              for t in served), "serve (a): served token shapes")
    secs = out["seconds"]
    served_tokens = SERVE_ROUNDS * SERVE_BATCH * (SERVE_PROMPT + SERVE_TOKENS)

    # the first chunks of a further round, on the trained params: bitwise
    # the plain run and the per-chunk loop
    fed = fedllm.CompiledFedLLM(arch, train_cfg, ota, device=device, **kw)
    t = SERVE_ROUNDS
    key = round_keys(t + 1, 0, device=device)[t]
    gflat, _ = fed._grads(out["params"], key)
    gch = gflat.view(fed.m, fed.n_chunks, fed.chunk_len).transpose(0, 1)
    deltas = torch.zeros((FEDLLM_PLAIN_CHUNKS, fed.m, fed.chunk_len),
                         device=device)
    plain_ms = _first_chunks_bitwise(fed, ota, gch, deltas, t, key, device,
                                     "serve (a)")
    del gflat, gch, deltas
    free_device_memory()

    busy = decode_busy_share(arch, out["params"], device)
    # a float32 batch from the last round's params, card against CPU
    f32 = serve_f32_against_cpu(arch, out["params"], device)
    del out["params"]
    free_device_memory()

    wide = [serve_wide(device, a) for a in SERVE_WIDE]
    ms = lambda k: [x[k] * 1e3 for x in secs]      # noqa: E731
    return dict(
        phase="serve", arch=FEDLLM_ARCH, d=fed.d, m=fed.m,
        batch=FEDLLM_BATCH, seq_len=FEDLLM_SEQ, chunk_size=FEDLLM_CHUNK,
        n_chunks=fed.n_chunks, rounds=SERVE_ROUNDS,
        serve_batch=SERVE_BATCH, prompt=SERVE_PROMPT, tokens=SERVE_TOKENS,
        compute_dtype="bfloat16", cache_dtype="bfloat16",
        ms_per_round=ms("train"), publish_ms=ms("publish"),
        prefill_ms=ms("prefill"),
        ms_per_token=[x["decode"] * 1e3 / SERVE_TOKENS for x in secs],
        wall_s=wall_s, tokens_per_s_while_training=served_tokens / wall_s,
        peak_allocated_gb=peak / 1e9, losses=losses, launches=launches,
        launches_per_round={k: v // SERVE_ROUNDS for k, v in launches.items()},
        publish_bitwise=True, served_sample=[t[0] for t in served],
        first_chunks_vs_plain="bitwise", first_chunks_vs_ref="bitwise",
        plain_chunks=FEDLLM_PLAIN_CHUNKS, plain_ms_for_chunks=plain_ms,
        decode_trace=busy, float32_vs_cpu=f32, wide=wide)


# ---------------------------------------------------------------------------
# phase 16: the sharded trainer (repro_torch.train.trainer)
# ---------------------------------------------------------------------------


def _trainer_run(ts, stream, steps, device):
    """``steps`` steps of ``ts`` from its initial state on ``stream``'s
    batches: ``(params, delta, metrics per step, ĝ per step)``."""
    from repro_torch import rng
    from repro_torch.convert import ravel
    ghats = []
    aggregate = ts.aggregate_fn

    def keep_ghat(*args):
        ghat, met, seconds = aggregate(*args)
        ghats.append(ravel(ghat).clone())
        return ghat, met, seconds

    ts.aggregate_fn = keep_ghat
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0, device=device))
    fn = ts.jitted({"tokens": None})
    mets = []
    for step in range(steps):
        params, opt_state, delta, met = fn(
            params, opt_state, delta, stream.batch_at(step), step,
            rng.PRNGKey(step, device=device))
        mets.append({k: float(v) for k, v in met.items()})
    return params, delta, mets, ghats


def trainer_reduced(device):
    """smollm-360m reduced, 3 steps on the 4 x 2 thread mesh, flat and
    sliced: the kernels bitwise their plain versions (ĝ every step, the
    error state and the params), and shard_decode on against off (ĝ).
    Returns the line's record and each layout's kernel run
    (:func:`_run_record`)."""
    import torch
    from repro_torch.configs.base import OTAConfig, TrainConfig, get_config
    from repro_torch.convert import ravel, tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.sharding import Mesh
    from repro_torch.train import trainer

    arch = get_config("smollm_360m").reduced()
    stream = TokenStream(arch.vocab, TRAIN_REDUCED_SEQ, TRAIN_REDUCED_BATCH,
                         seed=0)
    out, threads = {}, {}
    for layout in ("flat", "sliced"):
        make = (trainer.make_train_step_sliced if layout == "sliced"
                else trainer.make_train_step)
        runs, counts = {}, {}
        variants = {"kernel": dict(use_kernel=True),
                    "plain": dict(use_kernel=False)}
        if layout == "flat":
            variants["kernel_shard_decode"] = dict(use_kernel=True,
                                                   shard_decode=True)
        for name, over in variants.items():
            ota = OTAConfig(**{**TRAIN_REDUCED_OTA, **over})
            ts = make(arch, TrainConfig(**TRAIN_REDUCED_CFG), ota,
                      Mesh(*TRAIN_MESH), device=device)
            ops.reset_launches()
            runs[name] = _trainer_run(ts, stream, TRAIN_REDUCED_STEPS,
                                      device)
            counts[name] = ops.launch_counts()
        k, p = runs["kernel"], runs["plain"]
        subframes = 2 if layout == "sliced" else 1
        per_step = {n: v * subframes * TRAIN_REDUCED_STEPS
                    for n, v in TRAIN_LAUNCHES.items()}
        check(counts["kernel"] == per_step,
              f"trainer (b) {layout}: launches {counts['kernel']}, "
              f"expected {per_step}")
        check(not any(counts["plain"].values()),
              f"trainer (b) {layout}: the plain run launched "
              f"{counts['plain']}")
        for i, (a, b) in enumerate(zip(k[3], p[3])):
            check(torch.equal(a, b), f"trainer (b) {layout}: ĝ of step {i} "
                  "differs between kernels and plain")
        check(all(torch.equal(a, b) for a, b in zip(tree_leaves(k[1]),
                                                     tree_leaves(p[1]))),
              f"trainer (b) {layout}: error state differs")
        check(torch.equal(ravel(k[0]), ravel(p[0])),
              f"trainer (b) {layout}: params differ")
        check(k[2] == p[2], f"trainer (b) {layout}: metrics differ")
        losses = [m["global_loss"] for m in k[2]]
        check(all(map(math.isfinite, losses)),
              f"trainer (b) {layout}: losses {losses}")
        rec = dict(vs_plain="bitwise", global_loss=losses,
                   launches=counts["kernel"])
        threads[layout] = _run_record(*k)
        if layout == "flat":
            sd = runs["kernel_shard_decode"]
            for i, (a, b) in enumerate(zip(k[3], sd[3])):
                check(torch.equal(a, b), f"trainer (b): ĝ of step {i} "
                      "differs with shard_decode")
            rec["shard_decode_vs_off"] = "bitwise"
            rec["shard_decode_launches"] = counts["kernel_shard_decode"]
        out[layout] = rec
    return out, threads


def _run_record(params, delta, mets, ghats) -> dict:
    """A trainer run's params, error state, metrics and ĝ per step, on the
    host."""
    from repro_torch.convert import ravel, tree_leaves
    return dict(params=ravel(params).cpu(),
                delta=[leaf.cpu() for leaf in tree_leaves(delta)],
                metrics=mets, ghats=[g.cpu() for g in ghats])


def trainer_kernel_rows(device, gen, dims, n_layers: int,
                        timed: bool = True) -> list:
    """The three kernels at one rank's shapes on the trainer's full-width
    path: smollm-360m at ``n_layers`` on a ``dims`` (data x model) mesh
    with (a)'s config.  A model shard's error feedback (1 x d_pad /
    model, bitwise its plain version) and projection (d_pad / (4096 x
    model) blocks of 4096 -> 1024, shard 1's folded seed), and a device
    row's share of the decode under shard_decode (the blocks over the
    data ranks, 20 iterations, a noisy block-sparse y).  The projection's
    first and last ``TRAIN_CHECK_BLOCKS`` blocks and the decode's first
    are held bitwise against the plain versions, whose time on those
    blocks is recorded (on the whole shape they take tens of seconds).
    ``timed``: times by CUDA events (2 calls) and by replay of one
    captured call (twice); otherwise one call by CUDA events.  No
    ``torch.bmm`` yardstick: A would take hundreds of GB."""
    import torch
    from repro_torch.configs.base import get_config, ota_overrides
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.core.projection import BlockedProjector
    from repro_torch.kernels import (amp_fused, cost, ef_sparsify, ota_project,
                                     ref)
    from repro_torch.train.trainer import abstract_params, ravel_meta
    ota = ota_overrides(FEDLLM_ARCH)
    c, iters = ota.block_size, ota.amp_iters
    s = max(2, int(round(ota.s_frac * c)))
    arch = dataclasses.replace(get_config(FEDLLM_ARCH), n_layers=n_layers)
    d, _ = ravel_meta(abstract_params(arch))
    n_data, n_model = dims
    nb = -(-d // (c * n_model))             # a model shard's blocks
    nq = -(-nb // n_data)                   # a device row's decode
    k = TRAIN_CHECK_BLOCKS
    seed = int(ref.splitmix32(ref.as_u32(ota.seed) ^ ref.as_u32(1)))
    small = dict(warmup=1, reps=2) if timed else dict(warmup=0, reps=1)
    graph = dict(warmup=0, n=1, replays=2)
    where = dict(mesh=list(dims), n_layers=n_layers)

    def times(fn):
        out = dict(kernel_ms=cuda_ms(fn, **small))
        if timed:
            out["graph_device_ms"] = graph_ms(fn, **graph)
        return out

    n = nb * c
    g = torch.randn(1, n, generator=gen, device=device)
    delta = 0.3 * torch.randn(1, n, generator=gen, device=device)
    tau = torch.full((1,), 1.5, device=device)
    sp, nd = ef_sparsify.ef_sparsify(g, delta, tau)
    sp_ref, nd_ref = ref.ef_sparsify_ref(g, delta, tau)
    check(torch.equal(sp, sp_ref) and torch.equal(nd, nd_ref),
          f"trainer ef_sparsify 1x{n}: not bitwise its plain version")
    rows = [dict(
        kernel="ef_sparsify", shape=[1, n], tol="bitwise", **where,
        max_abs_err=max(errors(sp, sp_ref)[0], errors(nd, nd_ref)[0]),
        **times(lambda: ef_sparsify.ef_sparsify(g, delta, tau)),
        plain_ms=cuda_ms(lambda: ref.ef_sparsify_ref(g, delta, tau),
                         **small),
        library_ms=None, bound=bound(cost.ef_sparsify(1, n)))]
    del g, delta, sp, nd, sp_ref, nd_ref

    x = torch.randn(1, nb, c, generator=gen, device=device)
    proj = BlockedProjector(d=k * c, block_size=c, s_block=s, seed=seed,
                            rademacher=True)
    y = ota_project.ota_project(x, seed, s, True)
    want = proj.project_blocks(x[:, :k])
    check(torch.equal(y[:, :k], want), f"trainer ota_project 1x{nb}: the "
          "first blocks differ from the plain version: "
          + mismatch(y[:, :k], want, 0, 0))
    # the last blocks, past the grid's y limit where nb exceeds it
    ids = torch.arange(nb - k, nb, device=device)
    tail = ref.contract("bsc,...bc->...bs",
                        ref.block_matrix_ref(seed, ids, s, c, True),
                        x[:, nb - k:])
    check(torch.equal(y[:, nb - k:], tail), f"trainer ota_project 1x{nb}: "
          "the last blocks differ from the plain version: "
          + mismatch(y[:, nb - k:], tail, 0, 0))
    rows.append(dict(
        kernel="ota_project", shape=[1, nb, c, s], tol="bitwise", **where,
        checked_blocks=2 * k,
        max_abs_err=max(errors(y[:, :k], want)[0],
                        errors(y[:, nb - k:], tail)[0]),
        **times(lambda: ota_project.ota_project(x, seed, s, True)),
        plain_ms_checked_blocks=cuda_ms(
            lambda: proj.project_blocks(x[:, :k]), warmup=0, reps=1),
        library_ms=None,
        bound=bound(cost.ota_project(1, nb, c, s))))
    del x, y

    xs = block_sparse(nq, c, s // 8, gen, device)
    yb = (ota_project.ota_project(xs[None], seed, s, True)[0]
          + 0.01 * torch.randn(nq, s, generator=gen, device=device))
    kw = dict(iters=iters, rademacher=True)
    out = amp_fused.amp_decode_fused(yb, seed, c, **kw)
    want = amp_blocked_core(yb[:k].contiguous(), seed, c, use_kernel=False,
                            **kw)
    check(torch.equal(out[:k], want), f"trainer amp_fused {nq} blocks: the "
          "first blocks differ from the plain version: "
          + mismatch(out[:k], want, 0, 0))
    rows.append(dict(
        kernel="amp_fused", shape=[nq, s, c], iters=iters, tol="bitwise",
        **where, checked_blocks=k, max_abs_err=errors(out[:k], want)[0],
        **times(lambda: amp_fused.amp_decode_fused(yb, seed, c, **kw)),
        plain_ms_checked_blocks=cuda_ms(
            lambda: amp_blocked_core(yb[:k].contiguous(), seed, c,
                                     use_kernel=False, **kw),
            warmup=0, reps=1),
        library_ms=None,
        bound=bound(cost.amp_fused(1, nq, s, c, iters))))
    for rec in rows:
        rec["bound_share"] = rec["bound"][0] / rec.get("graph_device_ms",
                                                       rec["kernel_ms"])
    return rows


def _sha256(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def trainer_pg_reduced(mesh, device) -> dict:
    """(c1) in one process: trainer_reduced's kernel runs, flat and sliced,
    on this rank of the 4 x 2 process mesh, with this process's
    launches."""
    from repro_torch.configs.base import OTAConfig, TrainConfig, get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.train import trainer
    arch = get_config("smollm_360m").reduced()
    stream = TokenStream(arch.vocab, TRAIN_REDUCED_SEQ, TRAIN_REDUCED_BATCH,
                         seed=0)
    out = {}
    for layout in ("flat", "sliced"):
        make = (trainer.make_train_step_sliced if layout == "sliced"
                else trainer.make_train_step)
        ts = make(arch, TrainConfig(**TRAIN_REDUCED_CFG),
                  OTAConfig(**TRAIN_REDUCED_OTA, use_kernel=True), mesh,
                  device=device)
        ops.reset_launches()
        run = _trainer_run(ts, stream, TRAIN_REDUCED_STEPS, device)
        out[layout] = dict(_run_record(*run), launches=ops.launch_counts())
    return out


def _pg_step(mesh, device, n_layers: int):
    """(c2)'s train step on ``mesh``: (a)'s config at ``n_layers`` of
    smollm-360m's layers."""
    from repro_torch.configs.base import TrainConfig, get_config, ota_overrides
    from repro_torch.train.trainer import make_train_step
    arch = dataclasses.replace(get_config(FEDLLM_ARCH), n_layers=n_layers)
    ota = dataclasses.replace(ota_overrides(FEDLLM_ARCH), use_kernel=True,
                              shard_decode=True)
    return make_train_step(arch, TrainConfig(), ota, mesh,
                           ota_axes=("data",), device=device)


def trainer_pg_full(mesh, device, n_layers: int) -> dict:
    """(c2) in one process: this rank of the process mesh at ``n_layers``,
    one untimed step (its global_loss, the SHA-256 of ĝ's bytes, and the
    peak allocated memory of each of its phases 1 and 2 above what the
    process held when the phase began) and the timed ones."""
    import torch
    import torch.distributed as dist
    from repro_torch import rng
    from repro_torch.convert import ravel
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    ts = _pg_step(mesh, device, n_layers)
    stream = TokenStream(ts.arch.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.reset_peak_memory_stats(device)
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0, device=device))
    state_gb = torch.cuda.memory_allocated(device) / 1e9
    digests, peaks, phase_gb = [], [], {}
    grads, aggregate = ts.grads_fn, ts.aggregate_fn

    def measured(name, fn):
        def run(*args):
            torch.cuda.synchronize(device)
            held = torch.cuda.memory_allocated(device)
            peaks.append((torch.cuda.max_memory_allocated(device),
                          torch.cuda.max_memory_reserved(device)))
            torch.cuda.reset_peak_memory_stats(device)
            out = fn(*args)
            torch.cuda.synchronize(device)
            phase_gb[name] = dict(
                held_gb=held / 1e9,
                peak_above_gb=(torch.cuda.max_memory_allocated(device)
                               - held) / 1e9)
            return out
        return run

    def first_ghat(*args):
        ghat, met, seconds = aggregate(*args)
        digests.append(_sha256(ravel(ghat)))
        return ghat, met, seconds

    ts.grads_fn = measured("grads", grads)
    ts.aggregate_fn = measured("aggregate", first_ghat)
    fn = ts.jitted({"tokens": None})
    params, opt_state, delta, met = fn(params, opt_state, delta,
                                       stream.batch_at(0), 0,
                                       rng.PRNGKey(0, device=device))
    ts.grads_fn, ts.aggregate_fn = grads, aggregate
    losses = [float(met["global_loss"])]
    ms, splits, powers = [], [], []
    ops.reset_launches()
    for step in range(1, 1 + TRAIN_TIMED):
        batch = stream.batch_at(step)
        key = rng.PRNGKey(step, device=device)
        (params, opt_state, delta, met), t_ms = _events_ms(
            lambda: fn(params, opt_state, delta, batch, step, key))
        ms.append(t_ms)
        splits.append({k: v * 1e3 for k, v in ts.split.items()})
        losses.append(float(met["global_loss"]))
        powers.append((float(met["frame_power"]), float(met["p_t"])))
    launches = ops.launch_counts()
    free, total = torch.cuda.mem_get_info(device)
    peaks.append((torch.cuda.max_memory_allocated(device),
                  torch.cuda.max_memory_reserved(device)))
    rank = dist.get_rank()
    return dict(rank=rank, coords=list(mesh.coords(rank)),
                device=str(device), d_pad=ts.d_pad,
                delta_block=list(delta.shape), ghat_sha256=digests[0],
                global_loss=losses, ms_per_step=ms, split_ms=splits,
                tokens_per_s=[TRAIN_BATCH * TRAIN_SEQ / (t / 1e3)
                              for t in ms],
                frame_power_vs_p_t=powers, launches=launches,
                state_gb=state_gb, first_step_phases=phase_gb,
                peak_allocated_gb=max(a for a, _ in peaks) / 1e9,
                peak_reserved_gb=max(r for _, r in peaks) / 1e9,
                card_used_gb=(total - free) / 1e9,
                final_metrics={k: float(v) for k, v in met.items()})


def trainer_pg_worker(rank: int, shape: str, store: str, part: str,
                      out_path: str) -> None:
    """One rank of (c)'s gloo process mesh of ``shape`` (``DxM``) (run in
    its own process by :func:`run_trainer_processes`): ``part`` is
    ``reduced``, or ``full:L`` for (c2) at L layers."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import sharding
    dims = tuple(int(n) for n in shape.split("x"))
    mesh = sharding.init_process_mesh(
        dims, TRAIN_MESH[1], rank=rank, world_size=math.prod(dims),
        init_method="file://" + store, timeout=TRAIN_PG_TIMEOUT)
    try:
        device = sharding.process_device(None)
        if part == "reduced":
            rec = trainer_pg_reduced(mesh, device)
        else:
            rec = trainer_pg_full(mesh, device, int(part.split(":")[1]))
        torch.save(rec, out_path)
    finally:
        sharding.close_process_mesh()


def run_trainer_processes(part: str, dims) -> list:
    """A process of :func:`trainer_pg_worker` for each rank of a mesh of
    ``dims`` on the card, a ``file://`` store; each process's record.  Any
    rank that fails fails the phase.  The processes share the one card, so
    each allocator maps its blocks in expandable segments (less memory
    held in fragments)."""
    import tempfile
    import torch
    world = math.prod(dims)
    shape = "x".join(str(n) for n in dims)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.pt" for r in range(world)]
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.trainer_pg_worker("
                "int(sys.argv[2]), *sys.argv[3:7])")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(ROOT), str(r), shape,
             str(Path(tmp) / "store"), part, str(outs[r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              f"trainer (c) {part}: a process-mesh rank failed:\n"
              + "\n".join(log[-3000:] for log in logs))
        return [torch.load(o) for o in outs]


def trainer_processes_reduced(threads) -> dict:
    """(c1): the reduced runs on 8 processes, every process bitwise the
    thread mesh's kernel runs of (b) (ĝ every step, the params, its block
    of the error state, the metrics), with exactly one launch of each
    main-path kernel a step (two in the sliced layout)."""
    import torch
    from repro_torch import sharding
    from repro_torch.sharding import Mesh, P
    mesh = Mesh(*TRAIN_MESH)
    specs = {"flat": [P("data", "model")],
             "sliced": [P("data", None), P("data", "model", None)]}
    t0 = time.perf_counter()
    got = run_trainer_processes("reduced", mesh.shape)
    seconds = time.perf_counter() - t0
    out = {}
    for layout, want in threads.items():
        subframes = 2 if layout == "sliced" else 1
        per = {k: v * subframes * TRAIN_REDUCED_STEPS
               for k, v in TRAIN_PG_LAUNCHES.items()}
        for rank, rec in enumerate(got):
            rec = rec[layout]
            what = f"trainer (c1) {layout}, rank {rank}"
            check(rec["launches"] == per,
                  f"{what}: launches {rec['launches']}, expected {per}")
            check(len(rec["ghats"]) == TRAIN_REDUCED_STEPS and all(
                torch.equal(a, b) for a, b in zip(rec["ghats"],
                                                  want["ghats"])),
                  f"{what}: ĝ differs from the thread mesh's")
            check(torch.equal(rec["params"], want["params"]),
                  f"{what}: params differ from the thread mesh's")
            coords = mesh.coords(rank)
            check(all(torch.equal(a, sharding.local_block(mesh, b, spec,
                                                          coords))
                      for a, b, spec in zip(rec["delta"], want["delta"],
                                            specs[layout])),
                  f"{what}: its error block differs from the thread mesh's")
            check(rec["metrics"] == want["metrics"],
                  f"{what}: metrics differ from the thread mesh's")
        out[layout] = dict(vs_thread_mesh="bitwise",
                           launches_per_process=per)
    return dict(mesh=dict(zip(TRAIN_MESH[1], TRAIN_MESH[0])),
                processes=mesh.size, steps=TRAIN_REDUCED_STEPS,
                seconds=seconds, **out)


def trainer_thread_first_step(device, dims, n_layers: int) -> dict:
    """One step of (c2)'s config at ``n_layers`` on a thread mesh of
    ``dims`` in this process: its global_loss and the SHA-256 of ĝ's
    bytes."""
    from repro_torch import rng
    from repro_torch.convert import ravel
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.sharding import Mesh
    ts = _pg_step(Mesh(dims, TRAIN_MESH[1]), device, n_layers)
    stream = TokenStream(ts.arch.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0, device=device))
    gstack, met, _ = ts.grads_fn(params, stream.batch_at(0))
    ghat, _, _ = ts.aggregate_fn(gstack, delta, 0,
                                 rng.PRNGKey(0, device=device), delta)
    out = dict(global_loss=float(met["global_loss"]),
               ghat_sha256=_sha256(ravel(ghat)))
    del params, opt_state, delta, gstack, ghat
    free_device_memory()
    return out


def trainer_processes_full(device, dims, n_layers: int) -> dict:
    """(c2) on one mesh: smollm-360m at its published widths and
    ``n_layers`` of its layers on ``dims`` processes; the first step's
    global_loss and every process's ĝ digest equal to one thread-mesh
    step's, run in this process after the processes end (the card is
    theirs while they run); per process ms a step and its split, tokens a
    second, peak memory, launches, the frame power within 1 % of P_t."""
    import gc
    import torch
    from repro_torch.configs.base import get_config
    world = math.prod(dims)
    gc.collect()                # what earlier phases left in cycles
    free_device_memory()
    free, total = torch.cuda.mem_get_info()
    card_before = (total - free) / 1e9
    t0 = time.perf_counter()
    recs = run_trainer_processes(f"full:{n_layers}", dims)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = trainer_thread_first_step(device, dims, n_layers)
    thread_s = time.perf_counter() - t0
    per = {k: v * TRAIN_TIMED for k, v in TRAIN_PG_LAUNCHES.items()}
    shape = "x".join(map(str, dims))
    for rec in recs:
        what = f"trainer (c2) {shape} at {n_layers} layers, rank {rec['rank']}"
        check(rec["global_loss"][0] == want["global_loss"],
              f"{what}: first global_loss {rec['global_loss'][0]} against "
              f"the thread mesh's {want['global_loss']}")
        check(rec["ghat_sha256"] == want["ghat_sha256"],
              f"{what}: ĝ differs from the thread mesh's")
        check(rec["launches"] == per,
              f"{what}: launches {rec['launches']}, expected {per}")
        check(all(map(math.isfinite, rec["global_loss"])),
              f"{what}: losses {rec['global_loss']}")
        check(all(abs(fp - pt) <= 0.01 * pt
                  for fp, pt in rec["frame_power_vs_p_t"]),
              f"{what}: frame power against P_t {rec['frame_power_vs_p_t']}")
    launches = {k: sum(r["launches"][k] for r in recs) for k in per}
    layers = get_config(FEDLLM_ARCH).n_layers
    return dict(mesh=dict(zip(TRAIN_MESH[1], dims)), n_layers=n_layers,
                d_pad=recs[0]["d_pad"],
                reduced=([] if n_layers == layers else
                         [f"n_layers {n_layers} of {layers}: {world} "
                          "processes' peaks at full depth exceed the card"]),
                processes=world, transport="gloo, one process a rank on "
                "the one card", vs_thread_mesh="first step bitwise "
                "(global_loss, SHA-256 of ĝ)", thread_first_step=want,
                thread_step_s=thread_s, seconds=seconds, launches=launches,
                card_used_before_gb=card_before, ranks=recs)


def run_trainer_phase(device) -> dict:
    import torch
    from repro_torch import rng
    from repro_torch.configs.base import TrainConfig, get_config, ota_overrides
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.sharding import Mesh
    from repro_torch.train.trainer import make_train_step

    free_device_memory()
    t_phase = time.perf_counter()
    # (a) smollm-360m at its published widths
    arch = get_config(FEDLLM_ARCH)
    ota = dataclasses.replace(ota_overrides(FEDLLM_ARCH), use_kernel=True,
                              shard_decode=True)
    train_cfg = TrainConfig()
    ts = make_train_step(arch, train_cfg, ota, Mesh(*TRAIN_MESH),
                         ota_axes=("data",), device=device)
    check(ts.d == FEDLLM_D and ts.d_pad == TRAIN_D_PAD
          and ts.m_devices == TRAIN_MESH[0][0],
          f"trainer (a): d {ts.d}, d_pad {ts.d_pad}, M {ts.m_devices}")
    stream = TokenStream(arch.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0, device=device))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fn = ts.jitted({"tokens": None})
    # one untimed step, then the timed ones with the counts read around them
    params, opt_state, delta, met = fn(params, opt_state, delta,
                                       stream.batch_at(0), 0,
                                       rng.PRNGKey(0, device=device))
    losses = [float(met["global_loss"])]
    ms, splits, powers = [], [], []
    ops.reset_launches()
    for step in range(1, 1 + TRAIN_TIMED):
        batch = stream.batch_at(step)
        key = rng.PRNGKey(step, device=device)
        (params, opt_state, delta, met), t_ms = _events_ms(
            lambda: fn(params, opt_state, delta, batch, step, key))
        ms.append(t_ms)
        splits.append({k: v * 1e3 for k, v in ts.split.items()})
        losses.append(float(met["global_loss"]))
        powers.append((float(met["frame_power"]), float(met["p_t"])))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # where phase 2's time goes: one more step's aggregation, traced
    step = 1 + TRAIN_TIMED
    gstack, _, _ = ts.grads_fn(params, stream.batch_at(step))
    key = rng.PRNGKey(step, device=device)
    aggregate_trace = device_busy(lambda: ts.aggregate_fn(
        gstack, delta, step, key, delta))
    del gstack
    want = {k: v * TRAIN_TIMED for k, v in TRAIN_LAUNCHES.items()}
    check(launches == want, f"trainer (a): launches {launches}, expected "
          f"{want}")
    check(all(map(math.isfinite, losses)), f"trainer (a): losses {losses}")
    check(all(abs(fp - pt) <= 0.01 * pt for fp, pt in powers),
          f"trainer (a): frame power against P_t {powers}")
    mets = {k: float(v) for k, v in met.items()}
    check(all(map(math.isfinite, mets.values())),
          f"trainer (a): metrics {mets}")
    del params, opt_state, delta, met
    free_device_memory()
    full_s = time.perf_counter() - t_phase

    # the kernels at one rank's shapes of (a), then of each mesh of (c2)
    gen = torch.Generator(device=device)
    gen.manual_seed(24)
    kernel_rows = trainer_kernel_rows(device, gen, TRAIN_MESH[0],
                                      arch.n_layers)
    free_device_memory()
    for dims, n_layers in TRAIN_PG_FULL:
        kernel_rows += trainer_kernel_rows(device, gen, dims, n_layers,
                                           timed=False)
        free_device_memory()

    # (b) reduced, kernels against plain and shard_decode on against off
    t1 = time.perf_counter()
    reduced, threads = trainer_reduced(device)
    reduced_s = time.perf_counter() - t1
    free_device_memory()
    # (c) the step on a mesh of processes, started after the build
    processes = dict(reduced=trainer_processes_reduced(threads), full=[])
    for dims, n_layers in TRAIN_PG_FULL:
        free_device_memory()
        processes["full"].append(trainer_processes_full(device, dims,
                                                        n_layers))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return dict(
        phase="trainer", arch=FEDLLM_ARCH, d=ts.d, d_pad=ts.d_pad,
        mesh=dict(zip(TRAIN_MESH[1], TRAIN_MESH[0])), ota_axes=["data"],
        m_devices=ts.m_devices, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        blocks=ts.d_pad // ota.block_size,
        config=dict(block_size=ota.block_size, s_frac=ota.s_frac,
                    k_frac=ota.k_frac, rademacher=ota.rademacher,
                    amp_iters=ota.amp_iters, use_kernel=ota.use_kernel,
                    shard_decode=ota.shard_decode,
                    compute_dtype=train_cfg.compute_dtype,
                    remat=train_cfg.remat, optimizer=train_cfg.optimizer),
        init_s=init_s, timed_steps=TRAIN_TIMED, ms_per_step=ms,
        split_ms=splits, tokens_per_s=[tokens / (t / 1e3) for t in ms],
        peak_allocated_gb=peak / 1e9, global_loss=losses,
        frame_power_vs_p_t=powers, final_metrics=mets,
        aggregate_trace=aggregate_trace, kernel_rows=kernel_rows,
        launches=launches,
        launches_per_step={k: v // TRAIN_TIMED for k, v in launches.items()},
        full_width_s=full_s, reduced=reduced, reduced_s=reduced_s,
        processes=processes)


# ---------------------------------------------------------------------------
# phase 18: the dry run and the roofline (repro_torch.launch.dryrun,
# repro_torch.benchmarks.roofline)
# ---------------------------------------------------------------------------

#: records traced in this process: (arch, shape, multi-pod)
DRYRUN_HERE = [("smollm_360m", "prefill_32k", False),
               ("smollm_360m", "decode_32k", False),
               ("smollm_360m", "long_500k", False)]
#: records traced in a process of its own from the build on (minutes)
DRYRUN_BACKGROUND = [("smollm_360m", "train_4k", False),
                     ("smollm_360m", "train_4k", True),
                     ("granite_moe_1b_a400m", "train_4k", False),
                     ("granite_moe_1b_a400m", "decode_32k", False)]
DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
#: seconds the phase waits for the background records after the others
DRYRUN_WAIT = 600


def _dryrun_argv(arch: str, shape: str, multi_pod: bool) -> list:
    return (["--arch", arch, "--shape", shape, "--out", str(DRYRUN_DIR)]
            + (["--multi-pod"] if multi_pod else []))


def start_dryrun_records():
    """The background records, in a process of its own with no card
    visible (the dry run needs none); stopped at the script's exit."""
    import atexit
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    argvs = [_dryrun_argv(*r) for r in DRYRUN_BACKGROUND]
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"sys.exit(max([dryrun.main(a) for a in {argvs!r}]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(DRYRUN_DIR / "background.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    atexit.register(stop)
    return proc, t0, stop


def _record_summary(row: dict) -> dict:
    """A roofline row of a record, for the phase line."""
    info = row
    mem = info["mem_per_device"]
    return dict(
        arch=info["arch"], shape=info["shape"], mesh=info["mesh"],
        trace_s=info["compile_seconds"], flops=info["flops"],
        bytes_accessed=info["bytes_accessed"],
        collective_bytes=info["collective_bytes"]["total"],
        argument_bytes=mem["argument_bytes"],
        output_bytes=mem["output_bytes"], temp_bytes=mem["temp_bytes"],
        thread_mesh_temp_bytes=info["thread_mesh"]["temp_bytes"],
        kernel_calls={k: v["calls"] for k, v in info["kernels"].items()},
        t_compute_s=row["t_compute"], t_memory_s=row["t_memory"],
        t_collective_s=row["t_collective"], dominant=row["dominant"])


def _trainer_against_roofline(rec: dict, tr: dict) -> dict:
    """Phase 16's measured step beside the traced step's terms: the whole
    thread mesh's work over one card's peaks (the models' products at the
    bf16 tensor-core rate, the kernels' operations at the float32 rate;
    on one card a collective of the thread mesh is a copy in HBM)."""
    from repro_torch.kernels import cost
    from repro_torch.launch import mesh as mesh_lib
    whole = rec["thread_mesh"]
    kernel_ops = sum(k["ops"] for k in rec["kernels"].values())
    model_flops = whole["flops"] - kernel_ops
    terms = dict(
        compute_s=model_flops / mesh_lib.PEAK_FLOPS_BF16
        + kernel_ops / mesh_lib.PEAK_FLOPS_FP32,
        memory_s=whole["bytes_accessed"] / mesh_lib.HBM_BW,
        collective_s=whole["collective_bytes"]["total"] / mesh_lib.HBM_BW)
    measured_ms = tr["ms_per_step"]
    split = tr["split_ms"]
    by_kernel = {r["kernel"]: r for r in tr["kernel_rows"]
                 if r["mesh"] == list(TRAIN_MESH[0])}
    kernels = {}
    for name, k in rec["kernels"].items():
        calls = k["calls"]
        per_call = cost.bound(k["bytes"] / calls, k["ops"] / calls)
        row = by_kernel.get(name, {})
        kernels[name] = dict(
            calls=calls, bound_ms_per_call=per_call[0], bound_by=per_call[1],
            bound_ms_step=per_call[0] * calls,
            measured_graph_ms_per_call=row.get("graph_device_ms",
                                               "not measured"),
            measured_ms_step=(row["graph_device_ms"] * calls
                              if "graph_device_ms" in row
                              else "not measured"))
    trace_top = tr.get("aggregate_trace", {}).get("top", [])
    return dict(
        model_flops=model_flops, kernel_ops=kernel_ops,
        bytes_accessed=whole["bytes_accessed"],
        collective_bytes=whole["collective_bytes"]["total"],
        terms_s=terms, roofline_s=max(terms.values()),
        dominant=max(terms, key=terms.get),
        measured_ms_per_step=measured_ms, measured_split_ms=split,
        over_roofline=[m / 1e3 / max(terms.values()) for m in measured_ms],
        kernels=kernels, aggregate_trace_top=trace_top,
        traced_peak_live_gb=whole["temp_bytes"] / 1e9,
        measured_peak_allocated_gb=tr["peak_allocated_gb"],
        trace_s=rec["trace_s"])


def run_dryrun_phase(background, tr: dict) -> dict:
    """Phase 18: (a) the production-mesh records, (b) phase 16's step
    against its roofline (``tr``: the trainer line)."""
    import torch
    from repro_torch.benchmarks import roofline
    from repro_torch.configs.base import TrainConfig, get_config, ota_overrides
    from repro_torch.launch import dryrun
    from repro_torch.sharding import Mesh

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    # earlier phases' garbage goes first: a collection during the trace
    # would free it and move the count
    gc.collect()
    free_device_memory()
    mem0 = torch.cuda.memory_allocated()
    for rec in DRYRUN_HERE:
        check(dryrun.main(_dryrun_argv(*rec)) == 0,
              f"dryrun: {rec} failed (see its .fail file)")

    # (b) phase 16's configuration
    arch = get_config(FEDLLM_ARCH)
    ota = dataclasses.replace(ota_overrides(FEDLLM_ARCH), use_kernel=True,
                              shard_decode=True)
    batch = {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ),
                                   dtype=torch.int32, device="meta")}
    t0 = time.perf_counter()
    lay = dryrun.train_layout(arch, TrainConfig(), ota, Mesh(*TRAIN_MESH),
                              ("data",), batch)
    counter = dryrun.Counter(lay.step.mesh)
    extra, out_bytes = dryrun.trace_train(lay, counter)
    rec_b = dryrun.counted_record(counter, lay.argument_bytes(counter),
                                  out_bytes, extra)
    rec_b["trace_s"] = time.perf_counter() - t0
    check(rec_b["d_pad"] == TRAIN_D_PAD,
          f"dryrun (b): d_pad {rec_b['d_pad']}")
    check({k: v["calls"] for k, v in rec_b["kernels"].items()}
          == {k: v for k, v in TRAIN_LAUNCHES.items() if v},
          f"dryrun (b): kernel calls {rec_b['kernels']}")
    del lay, counter
    gc.collect()
    free_device_memory()
    mem1 = torch.cuda.memory_allocated()
    check(mem1 == mem0, f"dryrun: memory allocated on the card moved from "
          f"{mem0} to {mem1} bytes")

    # (a) the background records
    proc, t_start, stop = background
    try:
        rc = proc.wait(timeout=DRYRUN_WAIT)
    except subprocess.TimeoutExpired:
        rc = "timed out"
    stop()
    background_s = time.perf_counter() - t_start
    fails = sorted(p.name for p in DRYRUN_DIR.glob("*.fail"))
    check(rc == 0 and not fails,
          f"dryrun: background records rc {rc}, failed {fails}: "
          + (DRYRUN_DIR / "background.log").read_text()[-2000:])
    rows = roofline.load_rows(results=str(DRYRUN_DIR))
    want = len(DRYRUN_HERE) + len(DRYRUN_BACKGROUND)
    check(len(rows) == want and all("skipped" not in r for r in rows),
          f"dryrun: {len(rows)} records, expected {want}")
    records = [_record_summary(r) for r in rows]
    for r in records:
        check(all(math.isfinite(r[k]) and r[k] > 0
                  for k in ("flops", "bytes_accessed", "argument_bytes",
                            "output_bytes", "temp_bytes")),
              f"dryrun: record {r}")
    return dict(
        phase="dryrun", nvidia_smi=smi, records=records,
        trainer_against_roofline=_trainer_against_roofline(rec_b, tr),
        memory_allocated_before_after=[mem0, mem1],
        background_s=background_s,
        phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phase 17: the benchmarks (repro_torch.benchmarks)
# ---------------------------------------------------------------------------

#: the paper's Fig. 2 claim (PAPER.md): A-DSGD converges faster than D-DSGD,
#: below the error-free shared link
FIG2_CLAIM = ("A-DSGD converges faster than D-DSGD (PAPER.md); both below "
              "the error-free link: ideal >= a_dsgd >= d_dsgd")


def free_device_memory() -> None:
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def bench_kernel_rows(device) -> list:
    """Each bench_kernels op's kernel at the full sizes: its own device
    time by CUDA-graph replay (10 calls captured, 3 replays), its bound and
    the share of it, on the benchmark's own inputs; for the projections,
    the ``torch.bmm`` yardstick on A materialised beforehand (4.3 GB at
    ``large``)."""
    import torch
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels import cost, ref

    rows = []
    for size, nb, c, s, iters in bench_kernels.SIZES_FULL:
        x, yb = bench_kernels.inputs(nb, c, s, device)
        calls = bench_kernels.op_calls(x, yb, c, s, iters, use_kernel=True)
        bounds = {
            "proj_fwd": bound(cost.ota_project(1, nb, c, s)),
            "proj_adj": bound(cost.ota_project_t(1, nb, s, c)),
            "amp_decode": bound(cost.amp_fused(1, nb, s, c, iters))}
        for op, fn in calls.items():
            g = graph_ms(fn, warmup=1, n=10, replays=3)
            rows.append(dict(size=size, op=op,
                             kernel=bench_kernels.KERNEL_OF[op],
                             shape=[nb, c, s], iters=iters, graph_ms=g,
                             bound_ms=bounds[op][0], bound_by=bounds[op][1],
                             bound_share=bounds[op][0] / g))
        # yardsticks: one torch.bmm on A (and on A^T) materialised
        # beforehand, as the kernel checks time them
        A = ref.block_matrix_ref(bench_kernels.SEED,
                                 torch.arange(nb, device=device), s, c, True)
        lib = {}
        for op, mat, vec in (
                ("proj_fwd", A, x[:, :, None]),
                ("proj_adj", A.transpose(1, 2).contiguous(), yb[:, :, None])):
            lib[op] = (cuda_ms(lambda: torch.bmm(mat, vec)),
                       graph_ms(lambda: torch.bmm(mat, vec), warmup=1, n=10,
                                replays=3))
        del A, mat
        for r in rows[-len(calls):]:
            ms = lib.get(r["op"], (None, None))
            r.update(library_ms=ms[0], library_graph_ms=ms[1])
        del x, yb, calls
        free_device_memory()
    return rows


def fig2_full(timeout: int = 600) -> dict:
    """``python -m repro_torch.benchmarks.run fig2`` with ``FULL=1`` (the
    paper's M = 25, B = 1000, 60 000 / 10 000, T = 300, dense projection),
    as a user runs it: each series' final accuracy and ms per round, and the
    IID ordering beside the paper's claim."""
    env = dict(os.environ, FULL="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run",
                          "fig2"], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=timeout)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0,
          f"fig2 FULL exited {out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    summary = lines[lines.index("name,us_per_call,derived") + 1:]
    series = {}
    for ln in summary:
        name, us, acc = ln.split(",")
        series[name[len("fig2_"):]] = dict(final_acc=float(acc),
                                           ms_per_round=float(us) / 1e3)
    rows = [ln for ln in lines if ln.startswith("fig2,")]
    acc = {k: v["final_acc"] for k, v in series.items()}
    check(len(series) == 10 and len(rows) == 10 * 31
          and all(0.0 <= a <= 1.0 for a in acc.values()),
          f"fig2 FULL: {len(series)} series, {len(rows)} rows, {acc}")
    ordering = acc["ideal_iid"] >= acc["a_dsgd_iid"] >= acc["d_dsgd_iid"]
    return dict(scale="FULL", seconds=seconds, series=series,
                iid_ordering=dict(
                    ideal=acc["ideal_iid"], a_dsgd=acc["a_dsgd_iid"],
                    d_dsgd=acc["d_dsgd_iid"], holds=ordering,
                    paper_claim=FIG2_CLAIM))


def run_benchmarks_phase(device) -> dict:
    """(a) bench_kernels at its full sizes, (b) bench_sweeps at its default
    size, (c) Fig. 2 at FULL, (d) the Theorem 1 rows."""
    from repro_torch.benchmarks import bench_kernels, bench_sweeps
    from repro_torch.benchmarks import convergence_bound

    free_device_memory()
    # (a) the path: bench_kernels' own checks (each kernel within its bar
    # of the plain path, one launch per call) and times
    total = {}
    want = len(bench_kernels.SIZES_FULL) * (
        1 + bench_kernels.WARMUP + bench_kernels.REPS)
    counted = launch_counter("benchmarks", total)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        kdoc, _ = counted(lambda: bench_kernels.main(device=device), want)
    kernels_s = time.perf_counter() - t0
    check(not kdoc["smoke"] and total["ef_sparsify"] == 0,
          f"bench_kernels: smoke {kdoc['smoke']}, launches {total}")
    times = {(e["size"], e["op"], e["path"]): e for e in kdoc["entries"]}
    rows = bench_kernel_rows(device)
    for r in rows:
        plain = times[(r["size"], r["op"], "plain")]
        kern = times[(r["size"], r["op"], "kernel")]
        r.update(plain_ms=plain["us_per_call"] / 1e3,
                 kernel_ms=kern["us_per_call"] / 1e3,
                 max_abs_err=kern["max_abs_err"],
                 launches_per_call=kern["launches"])
        check(kern["launches"] == 1, f"bench_kernels {r['op']}: "
              f"{kern['launches']} launches per call")

    # (b) bench_sweeps: looped == batched, point for point
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        sdoc = bench_sweeps.main(device=device)
    sweeps_s = time.perf_counter() - t0
    check(sdoc["max_final_acc_deviation"] == 0.0,
          f"bench_sweeps: looped and batched runs differ: {sdoc}")

    # (c) Fig. 2 at the paper's scale, (d) Theorem 1
    fig2 = fig2_full()
    thm = io.StringIO()
    with contextlib.redirect_stdout(thm):
        bound_rows = convergence_bound.main()
    check(len(bound_rows) == 6, f"thm1: {len(bound_rows)} rows")
    return dict(
        phase="benchmarks", launches=total, launches_per_kernel=want,
        bench_kernels=dict(seconds=kernels_s, device=kdoc["device"],
                           power_limit=kdoc["power_limit"], rows=rows,
                           out="BENCH_torch_kernels.json"),
        bench_sweeps=dict(seconds=sweeps_s, **{
            k: sdoc[k] for k in (
                "grid_points", "rounds", "looped_us_per_round",
                "compiled_cold_us_per_round", "compiled_steady_us_per_round",
                "speedup_steady", "max_final_acc_deviation", "final_accs")},
            out="BENCH_torch_sweeps.json"),
        fig2=fig2,
        thm1=[ln for ln in thm.getvalue().splitlines()
              if ln.startswith("thm1,")])


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    device = resolve_device(None)
    smi = nvidia_smi()
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0], nvidia_smi=smi,
              device=torch.cuda.get_device_name(0),
              tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))
    print(smi, flush=True)

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build(verbose=True)
    build.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=build.library_path().name,
              ptxas=ptxas_summary(log.getvalue())))
    dryrun_background = start_dryrun_records()

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cfg = slice_config(STEPS)
    d, c = 7850, cfg.block_size
    s = max(2, int(round(cfg.s_frac * c)))
    n_blocks = -(-d // c)
    k = max(1, int(cfg.k_frac * n_blocks * s))
    main_checks = {
        "ef_sparsify": check_ef_sparsify(25, d, k, device, gen),
        "ota_project": check_ota_project(25, n_blocks, c, s, cfg.rademacher,
                                         device, gen),
        # the adjoint at its path's shape: one decode's z, 1024 -> 4096
        "ota_project_t": check_ota_project_t(1, n_blocks, s, c,
                                             cfg.rademacher, device, gen),
        "amp_fused": check_amp_fused(n_blocks, c, s, cfg.amp_iters, device,
                                     gen),
    }
    extra = [
        check_ef_sparsify(3, 10007, 1000, device, gen),
        check_ota_project(25, n_blocks, c, s, False, device, gen),
        check_ota_project(1, 64, 1024, 256, True, device, gen),
        check_ota_project(1, 64, 1024, 256, False, device, gen),
        check_ota_project_t(1, 64, 256, 1024, True, device, gen),
        check_ota_project_t(1, 64, 256, 1024, False, device, gen),
        check_amp_fused(n_blocks, c, s, cfg.amp_iters, device, gen,
                        rademacher=False),
        check_amp_fused(64, 1024, 256, 10, device, gen),
    ]
    # the cohort widths of the local and population paths: Fig. 12's 20
    # devices (a partial device tile of 4) and Fig. 10's K = 64 (8 full
    # tiles), bitwise
    cohort = [check_ota_project(20, n_blocks, c, s, cfg.rademacher, device,
                                gen, bitwise=True),
              check_ota_project(64, n_blocks, c, s, cfg.rademacher, device,
                                gen, bitwise=True),
              check_ef_sparsify(64, d, k, device, gen)]
    # a sweep's grid: G = 4 points of the main path's shapes
    points = check_amp_fused_points(4, n_blocks, c, s, cfg.amp_iters, device,
                                    gen)
    point_rows = check_point_rows(4, 25, d, n_blocks, c, s, k, device, gen)
    nonfinite = check_amp_fused_nonfinite(n_blocks, c, s, cfg.amp_iters,
                                          device, gen)
    # one rank's shapes on the sharded path: the 1 x 1 projection with a
    # shard-folded seed, the one-block decode, and the decode at every
    # device row's block id under shard_decode
    from repro_torch.kernels import ref as kref
    shard_seed = int(kref.splitmix32(kref.as_u32(cfg.seed) ^ kref.as_u32(1)))
    sharded_shapes = [
        check_ota_project(1, 1, c, s, cfg.rademacher, device, gen,
                          bitwise=True, seed=shard_seed),
        check_amp_fused(1, c, s, cfg.amp_iters, device, gen)]
    offsets = check_amp_fused_offsets(c, s, cfg.amp_iters,
                                      range(1, SHARDED_M), device, gen)
    streamed = check_streamed_shapes(device, gen)
    for rec in [*main_checks.values(), *extra, *cohort, points,
                *sharded_shapes]:
        rec["bound_share"] = rec["bound"][0] / rec["graph_device_ms"]
    emit(dict(phase="kernel_checks", main_path=list(main_checks.values()),
              other_shapes=extra, cohort_widths=cohort,
              point_axis=[points, point_rows], nonfinite=nonfinite,
              sharded_shapes=[*sharded_shapes, offsets],
              streamed_shapes=streamed, not_ported=[]))

    data, sl = run_slice(device)
    emit(sl)
    ud = run_unfused_decode(n_blocks, c, s, cfg.amp_iters, device, gen)
    emit(ud)
    eng = run_engine(data, cfg, sl, device)
    emit(eng)
    sw = run_sweep_phase(data, cfg, device)
    emit(sw)
    ch = run_channel_phase(data, cfg, device)
    emit(ch)
    rb = run_robust_phase(data, cfg, eng, device)
    emit(rb)
    lo = run_local_phase(cfg, device)
    emit(lo)
    po = run_population_phase(data, cfg, device)
    emit(po)
    sd = run_sharded_phase(data, cfg, device)
    emit(sd)
    fl = run_fedllm_phase(device, sl)
    emit(fl)
    fm = run_fedllm_moe_phase(device)
    emit(fm)
    sv = run_serve_phase(device)
    emit(sv)
    tr = run_trainer_phase(device)
    emit(tr)
    bm = run_benchmarks_phase(device)
    emit(bm)
    dr = run_dryrun_phase(dryrun_background, tr)
    emit(dr)

    paths = {"slice": sl["launches"], "unfused_decode": ud["launches"],
             "engine": eng["launches"], "sweep": sw["launches"],
             "channel": ch["launches"], "robust": rb["launches"],
             "local": lo["launches"], "population": po["launches"],
             "sharded": sd["launches"], "fedllm": fl["launches"],
             "fedllm_moe": fm["launches"], "serve": sv["launches"],
             "trainer": tr["launches"],
             "trainer_processes": {
                 k: sum(f["launches"][k] for f in tr["processes"]["full"])
                 for k in TRAIN_PG_LAUNCHES},
             "benchmarks": bm["launches"]}
    kernels = []
    for name, meta in KERNELS.items():
        chk = main_checks[name]
        bound_ms, bound_by = chk["bound"]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=paths[KERNEL_PATH[name]][name],
            max_abs_err=chk["max_abs_err"], ms=chk["kernel_ms"],
            plain_ms=chk["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=chk["library_ms"], device_ms=chk["device_ms"],
            graph_device_ms=chk["graph_device_ms"], host_us=chk["host_us"],
            library_device_ms=chk["library_device_ms"],
            library_graph_ms=chk["library_graph_ms"],
            bound_share=chk["bound_share"], shape=chk["shape"],
            max_rel_err=chk["max_rel_err"], kernel_ms=chk["kernel_ms"],
            ported=True, path=KERNEL_PATH[name],
            launches_per_path={p: n[name] for p, n in paths.items()}))
        if name == "amp_fused":
            kernels[-1]["point_axis"] = {
                k: points[k] for k in (
                    "shape", "kernel_ms", "graph_device_ms", "device_ms",
                    "host_us", "plain_ms", "bound", "bound_share",
                    "g1_launches_graph_ms", "max_active_clusters",
                    "clusters_launched", "graph_ms_by_points")}
        if name != "ota_project_t":
            kernels[-1]["streamed_shapes"] = [
                {k: rec[k] for k in ("shape", "kernel_ms", "graph_device_ms",
                                     "plain_ms", "library_ms", "bound",
                                     "bound_share", "max_abs_err")}
                for rec in streamed if rec["kernel"] == name]
        if name != "ef_sparsify":
            kernels[-1]["bench_kernels"] = [
                {k: r[k] for k in ("size", "shape", "graph_ms", "kernel_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "bound_share", "max_abs_err",
                                   "launches_per_call", "library_ms",
                                   "library_graph_ms")}
                for r in bm["bench_kernels"]["rows"] if r["kernel"] == name]
        if name != "ota_project_t":
            rows = [r for r in tr["kernel_rows"] if r["kernel"] == name]
            kernels[-1]["trainer_rank_shape"] = rows[0]
            kernels[-1]["trainer_process_rank_shapes"] = rows[1:]
        if name in ("ota_project", "amp_fused"):
            one = sharded_shapes[0 if name == "ota_project" else 1]
            kernels[-1]["sharded_rank_shape"] = {
                k: one[k] for k in ("shape", "kernel_ms", "graph_device_ms",
                                    "plain_ms", "bound", "bound_share",
                                    "library_ms", "max_abs_err")}
    check(len(kernels) == 4 and all(k["ported"] for k in kernels),
          "kernels: not all four TPU kernels are ported")
    emit({"kernels": kernels})

    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
