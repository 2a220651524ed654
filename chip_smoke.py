#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. build     nvcc builds the dp_aggregate, flash_attention (SIMT, bf16
               tensor-core and float32 tensor-core) and ssd_scan kernels from
               csrc/ (ctypes), one process per source, all at once; ptxas's registers and
               spills, and each kernel's tensor-core instructions (HMMA,
               HGMMA) where the toolkit has cuobjdump; dp_aggregate's launch
               plan (cluster size, window, stages, the clusters the card
               holds) with each kernel's registers, spills and shared memory.
  2. kernels   every kernel against its plain PyTorch version on the card, at
               the main paths' shapes and ragged ones; fused-mode noise
               against the noise-only kernel; bitwise determinism; times.
               dp_aggregate in every mode at (1000, 500), (1000, 100),
               (1000, 131072), (37, 129), (1, 1), (300, 4099), (8, 300001)
               (the L2 path) and the CNNs' widths (1000, 237) and (1000, 5046), the noise-only kernel at the same shapes, both
               with their float32-rate bound and the pair generator's integer
               bound at the SM clock nvidia-smi reads under load;
               torch.randn at the full shape as a yardstick.
               dp_aggregate also with C as a 0-d tensor on the card (the
               adaptive clip's), in every mode at every shape: the float-C
               launch's bits, the plain version's values, and a planted fault
               (C read as 2C) that must fail wherever a row clips; at the
               full shape timed beside the float-C launch.
               dp_aggregate also with a row gate and row ids (the sampled
               round's), in every mode at every shape: an all-on gate gives
               the ungated bits; ~10% of the rows on with NaN planted in the
               rest gives the plain version's sums, and ignoring the gate (a
               planted fault) must fail; an all-off gate gives zero sums; a
               gathered block of ~10% of the clients plus two padding slots
               draws exactly their rows of the dense noise (the noise-only
               kernel, bits), fused mode on it the plain version's sums, and
               keying its noise by row in place of client (a planted fault)
               must fail.  Timed: gated at (1000, 131072) with ~10% on, and
               the gathered block of CohortSpec(q=0.1) at (176, 131072).
               flash_attention through its dispatch rule (bf16 with Dh <= 256
               to the tensor-core kernel, 128-key tiles up to Dh 128 and 64
               above; float32 with Dh <= 256 to the float32 tensor-core
               kernel, 3xTF32, 64-, 32- or 16-key tiles; the counters must
               say so): the serve shape's head group and all heads, MQA at
               head_dim 256, head_dims 64, 80, 100, 128, 136 and 192, a
               window under one tile, a ragged kv_len and non-causal
               attention.  The bf16 kernel is held tight against its rounding
               order (ref.attention_tc_ref at its key tile) and within the
               derived P-rounding bound of attention_ref, the float32 one
               tight against its 3xTF32 order (f32_reference) and within
               FLASH_TOL of attention_ref; a planted fault (window one too
               wide, or a window imposed) must fail each tight check; two
               launches on the model's strided views give the same bits.  At
               the h2o serve shape both tensor-core kernels are timed (bf16;
               float32 beside the SIMT kernel in float32, the route before)
               beside SDPA; at gemma-2b's (B 2, Hq 8, Hkv 1, S 8176, Dh 256,
               causal) the same in both types (the fault: a window of 4096),
               beside the SIMT kernel, the plain version and SDPA.
               ssd_scan against the recurrence and the chunked SSD at
               small, ragged (S 300, 1237) and strong-decay shapes, and at
               the Mamba2 serve shape (2, 16384, 80, 64) with N 128 and
               inputs drawn as Mamba2 initialises A and dt; the final state
               against the chunked path's; bitwise determinism; its time,
               the bound for 3xTF32 tensor-core products and for float32
               ones, and a profiled split over the four stages.
  3. paper     the paper's synthetic linear regression (M=1000, tau=20,
               50 rounds, PAPER_RUN_ROUNDS, restored in PR 31; d=500
               CDP/noiseless, d=100 LDP and PrivUnit) on the default scan
               engine (CUDA graphs; phases 3b and 3e too) for
               all seventeen names, dp-scaffold in both modes (LDP sigma =
               0.7C, CDP 5C/sqrt(M), (eta_l, C) = (0.3, 0.3)) (PrivUnit at
               eps0 = eps1 = eps2 = 2; adaptive clipping from c0 = C, z_mult
               = sigma / C; schedules decaying by 0.97 a round;
               ldp-fedexp-perclient with 1000 epsilons in three tiers), the
               Gaussian LDP names and dp-scaffold's LDP also on the
               materialized-noise backend; each name again under
               CohortSpec(q=0.1) dense and gathered and CohortSpec(size=100),
               each round of the dense q=0.1 run taken again gathered from
               the same iterate and carry and equal at rtol 1e-5 (dp-scaffold's
               variate table too; the two whole runs' gap printed:
               cdp-fedexp's extrapolation and PrivUnit's release compound
               rounding over the rounds); dp_aggregate launches must rise by
               one a round (the scan engine's warm-up rounds before its
               captures count: they ran), by two for dp-scaffold (its model and variate
               releases), by none for the PrivUnit names and the weighted
               ldp-fedexp-perclient (which launch the noise-only kernel
               once a round: PrivUnit's directions' normal, keyed by
               client, and the per-client unit noise).
  3b. e1       the paper's e1 comparison (benchmarks/e1_synthetic.py): for
               cdp (d=500), ldp-gauss and ldp-privunit (d=100), DP-FedAvg,
               DP-FedEXP and DP-SCAFFOLD at e1's (eta_l, C), each through
               FederatedSession.run_batched over e1's 5 seeds (E1_SEEDS,
               restored in PR 31): the final
               ||w - w*|| as mean +/- std, and OK/WARN for DP-FedEXP <
               DP-FedAvg, printed as e1 prints it; in ldp-gauss each seed's
               slice must equal its own run() in bits.
  3e. e2      the paper's image workload (benchmarks/e2_mnist.py, Fig. 1 right
               and Table 4): the CDP CNN (d = 5046) for cdp, the LDP CNN
               (d = 237) for ldp-gauss and ldp-privunit, M = 1000, tau = 10,
               50 rounds on the 12000/2000 generated image set under a
               Dirichlet(0.3) split; DP-FedAvg, DP-FedEXP and DP-SCAFFOLD at
               e2's (eta_l, C), each through run_batched(batched_w0=True,
               batched_data=True) over seeds 0-1 (e2 runs 0-2; cut since
               phase 13 came, E2_SEEDS) (each seed its own split and
               CNN init): test accuracy of the last 5 rounds, mean +/- std,
               e2's OK/WARN/n/a, printed; held: finite, one dp_aggregate
               launch a round (two for DP-SCAFFOLD, none for PrivUnit's), and
               one seed's slice equal to its run() in bits.  e2's --quick leg
               (the CNN as a parameter tree, LocalSpec(batch_size=8,
               momentum=0.9), M = 16).  cdp-fedexp under LocalSpec(batch_size=4,
               epochs=2, prox_mu=0.01, momentum=0.9): saved every 20 rounds
               and resumed from round 20 (= the uninterrupted run in bits),
               under CohortSpec(q=0.1, gather=True) and under the fault model
               (every launch gated), and each round of the dense q = 0.1 run
               retaken gathered (the block's shuffles = the dense rows' in
               bits; the round = dense at rtol 1e-5 on the dense local
               updates).
  3f. stream  the streaming engine: ldp-fedexp-gauss and cdp-fedexp at
               phase 4's full width streamed at 128 clients a chunk (8
               gated launches a round, the last chunk padded) and at "auto"
               (one chunk), each round taken from the dense eager round's
               iterate and held to its output at RTOL, with ms, peak memory
               and a profiled round; ldp-fedexp-gauss's chunk-128 round
               again from a HostArraySource of the same rows (8 chunks of
               67 MB through pinned memory) at prefetch 1 and 3, equal in
               bits to each other and at RTOL to the device-resident round;
               e8 (benchmarks/e8_million_clients.py, nothing cut: M = 10^6,
               d = 32, q = 1e-3, 20 rounds): its SyntheticSource gathered at
               the "auto" chunk, prefetch 2: rounds/s, peak device memory
               and RSS, a HostArraySource of the same rows and prefetch 1
               equal in bits, 3 rounds equal at RTOL to the device-resident
               gathered stream; the same at 128 clients a chunk (10 chunks a
               round) at prefetch 1 and 3, equal in bits, rounds/s and a
               profiled idle share, 3 rounds at RTOL to auto; device-resident,
               the dense sampled stream against the gathered one (rounds/s
               and their ratio beside e8's 5x floor, printed) and at chunk
               65536 held to "auto"; the chunked dp_aggregate wrapper at
               (1000, 131072), 8 chunks and a gathered slot table, against
               one launch and its plain version, timed, and dp_aggregate
               gated at the streamed shapes held to its plain version and
               timed, with the bound of the rows on; ldp-fedexp-gauss on the paper workload under phase 3c's
               fault model streamed at chunk 128, every round retaken from
               the faulted eager run's iterate and held at RTOL.
  3g. e9      compressed communication (benchmarks/e9_compression.py at its
               own geometry, nothing cut: cdp-fedexp at C = 1, sigma = 5e-4
               on e9's quadratic, M = 256, d = 2^20, tau = 1, eta_l = 0.5,
               10 rounds): dense, rand-k (k = d/64), count-sketch (width
               d/256, depth 3), the sketch with top-k d/64 and error
               feedback, lossless rand-k (k = d); rounds/s, modeled bytes a
               round (4 comm_floats(d)) and their reduction, dp_aggregate
               launches a round (1 dense, 0 compressed: held), peak memory,
               the loss decrease over 4 rounds against dense
               (informational), e9's rand-k >= 2x dense as OK/WARN.  Held:
               finite; noiseless fedexp lossless rand-k = dense at RTOL;
               three runs of the sketch and of the EF sketch equal in bits;
               each round of rand-k and both sketches streamed at chunk 64
               = eager, and gathered at q = 0.1 = dense sampled, at RTOL;
               the EF sketch saved at round 5 and resumed = uninterrupted
               in bits.
  4. full      the eager loop (EngineSpec("eager"), timed with its split):
               ldp-fedexp-gauss (fused mode), cdp-fedexp (none mode),
               ldp-fedexp-privunit (the noise-only kernel for its normal),
               cdp-fedexp-adaptive-clip
               (none mode, C on the card), ldp-fedexp-gauss under
               CohortSpec(q=0.1, gather=True) (fused, gated, row ids),
               cdp-fedexp under CohortSpec(size=100) (none mode, gated),
               ldp-fedexp-perclient (plain weighted sums), and dp-scaffold
               LDP (two fused launches), CDP (two none launches) and LDP
               under CohortSpec(q=0.1, gather=True) at M=1000, d=131072 for
               5 rounds: ms per round, its split, peak memory (dp-scaffold's
               (M, d) variate table is 0.52 GB), and the synchronizing CUDA
               operations of one round, which must be none; PrivUnit's
               release time.  And e2's CNN rounds (cdp-fedexp at d = 5046,
               ldp-fedexp-gauss at d = 237, full batch and the minibatch
               spec) at M = 1000, tau = 10: ms per round, the split, peak
               memory, syncs of a round.
  4b. scan     the scan engine (EngineSpec("scan", chunk_rounds=25): each
               round staged on the host and replayed from a CUDA graph):
               all 18 labels at the paper size (M = 1000, tau = 20, 50
               rounds) under eager (named) and scan, equal in bits (final_w,
               last_w, the four histories, the watchdog round); the same
               for q = 0.1 gathered and for a faulted run whose watchdog
               trips (eta_g above 1.05), on cdp-fedexp and
               ldp-fedexp-gauss, and at full size (d = 131072, 5 rounds)
               for ldp-fedexp-gauss, cdp-fedexp and ldp-fedexp-privunit (a
               case not equal in bits would be held at SCAN_GRAPH_RTOL and
               named); one dp_aggregate launch a replayed cdp-fedexp round;
               a tracked scan run equal in bits to an untracked one, its
               stream validated by tools/check_telemetry.py; both kernels
               launched with their seed and sigma in device memory against
               the by-value launches (bits, and times); the quickstart
               (examples/quickstart_torch.py --quick --telemetry
               --schedule) in a process of its own, its streams validated
               (the schedule's sigma against sigma0 0.9**t); ms per round
               and the profiled idle share of three names under both
               engines at the paper size, with the dp_aggregate and noise
               kernels in each profiled run's trace held equal to the
               launch counters (which under scan count captured launches
               times replays).
  4c. shard    client sharding: a one-rank NCCL client mesh
               (make_client_mesh(), a one-process group through an in-memory
               store); the full cell (M = 1000, d = 131072, tau = 20, 5
               rounds) under ShardSpec(mesh) equal in bits to the unsharded
               scan run for ldp-fedexp-gauss (fused noise keyed by global
               row), cdp-fedexp, ldp-fedexp-privunit and ldp-fedexp-gauss
               gathered at q = 0.1; ms per round sharded and unsharded, the
               dp_aggregate launches and all-reduces of a replayed round (one
               all-reduce, held), the all-reduce's device time in a profiled
               run; at e9's shape (M = 256, d = 2^20, 10 rounds) rand-k and
               the sketch with top-k and error feedback under scan equal in
               bits to the eager loop, ms per round of both.
  5. reference the port on the card against the port on the CPU (plain
               versions, same seeds, same noise) on a small problem: fedexp,
               ldp-fedexp-gauss (also under CohortSpec(q=0.25), dense and
               gathered), ldp-gauss-fedadam, ldp-fedexp-schedule,
               ldp-fedexp-perclient, cdp-fedexp-adaptive-clip without
               noise, and dp-scaffold LDP (also gathered under q=0.25).
  6. serve     h2o-danube-3-4b at full width and depth, seeded bf16 weights
               and a bf16 KV cache: ServeEngine.generate of 16 greedy tokens
               after an 8192-token prompt (batch 2, twice the window); 24
               flash launches per prefill; prefill and decode times; the
               prefill logits against the plain attention path, and a
               planted fault (the window dropped) that must fail; then two
               layers at full width on the card against the CPU (f32,
               window 128, prompt 300): the greedy tokens must be equal.
               The prefill's 24 launches must all be tensor-core launches,
               the f32 layers' float32 tensor-core launches.
  7. serve-ssm mamba2-2.7b at full width and depth, seeded bf16 weights with
               A and dt in Mamba2's initial ranges, float32 caches:
               ServeEngine.generate of 16 greedy tokens after a 16384-token
               prompt (batch 2); 64 ssd_scan launches per prefill; prefill
               and decode times, peak memory, a profiled prefill and decode;
               the prefill logits and the hidden states at every position
               against the plain chunked-SSD path, and a planted fault (the
               state carry reset at every chunk) that must fail; then two
               layers at full width on the card against the CPU (f32, prompt
               300): the greedy tokens must be equal.
  8. serve-gemma gemma-2b at full width and depth as phase 6 (2.506 B seeded
               bf16 parameters, MQA with one KV head of 256, GeGLU, tied
               embeddings): 16 greedy tokens after an 8176-token prompt
               (batch 2, a ragged last query tile, 8192 in all); 18
               tensor-core flash launches per prefill, all at Dh 256 (the
               64-key route), none SIMT; the planted fault a window of 4096
               imposed on the plain path; one prefill timed with the SIMT
               kernel in place of the dispatch (the route before); two f32
               layers card-vs-CPU through the float32 tensor-core kernel at
               Dh 256.
  9. serve-f32 h2o-danube-3-4b in float32 (the models' default dtype) at full
               width and depth as phase 6 (3.962 B seeded float32 parameters,
               a float32 KV cache): 16 greedy tokens after a 2 x 8192 prompt;
               24 float32 tensor-core flash launches per prefill, none SIMT;
               the prefill logits against the plain path within the float32
               bounds (SERVE_F32_MAX_ERR, SERVE_F32_MEAN_ERR), the window
               dropped on the plain path outside them; one prefill timed with
               the SIMT kernel in place of the dispatch (the route before).
  10. train  federated LM training (FederatedTrainer) at full width and
               depth, bf16 weights seeded as phases 6 and 7 seed them, the
               xla_flash path (Mamba2: the chunked SSD) with remat, 1 x 2048
               tokens a local step from per-client Markov streams, clip 1,
               sigma 0.05, eta_l 0.05: h2o-danube-3-4b cdp-fedexp (K = 4,
               tau = 2, 3 rounds) and ldp-fedexp-gauss (1 round), mamba2-2.7b
               cdp-fedexp (K = 2, tau = 1, 1 round; 16 of its 64 layers
               since phase 12 came, and h2o 12 of its 24 since phase 13
               came, TRAIN_DEPTH); held after every round:
               finite metrics, eta_g >= 1, every client's clipped norm <= C
               within CLIP_SLACK, the parameters moved; ms per round (host
               clock, the card synchronised), one local step timed three
               times (the median) and profiled, peak memory.  Then two
               h2o layers at full width in float32 (TF32 off), cdp-fedexp,
               K = 2, tau = 1, 256 tokens, the same materialized noise: the
               card's train_step against the CPU's within TRAIN_CHECK_TOL,
               and a planted fault (eta_g forced to 1) outside it.  No
               hand-written kernel launches: training reaches none (nor
               does the JAX package's).
  11. serve-zoo the rest of the decoder zoo.  First (11a) the kernels at its
               prefill shapes against their plain versions: the bf16
               tensor-core flash kernel at one layer's every head of
               zamba2-2.7b's shared block (B 2, MHA 32, S 8192, Dh 80),
               granite-moe-1b-a400m (2, GQA 16/8, 8192, Dh 64), chameleon-34b
               (1, GQA 64/8, 4096, Dh 128) and llama4-maverick (2, GQA 40/8,
               4096, Dh 128), tight against its rounding order, within the
               P-rounding bounds, a planted fault (a window of half the
               prompt), timed beside the plain version, the bound and SDPA;
               the float32 kernel at the two-layer checks' shapes; ssd_scan
               at zamba2's prefill (2, 8192, 80, 64, N 64), timed with its
               bound.  Then ServeEngine.generate of 16 greedy tokens, seeded
               bf16 weights: zamba2-2.7b at full width and depth (2.341 B,
               Mamba2's A and dt ranges) after 2 x 8192 tokens, 9
               tensor-core flash launches (one per site of the shared block)
               and 54 ssd_scan launches per prefill; granite-moe-1b-a400m
               (1.335 B) after 2 x 8192, 24 flash launches, the dropped share
               of (token, slot) assignments per layer at capacity factor
               1.25; chameleon-34b (34.293 B, 68.6 GB) after 1 x 4096, 48
               flash launches (its float32 form, 137 GB, cannot fit: said,
               not tried); llama4-maverick's MoE block (top-1 of 128 experts
               and the shared expert, the combine in bf16) at full width, 1
               of its 48 layers (17.33 B; the experts drawn an expert at a
               time, so no float32 copy of a (128, 5120, 16384) stack
               exists), after 2 x 4096, 1 flash launch.  Each: prefill and
               decode ms (host clock, card synchronised), peak memory, a
               profiled prefill, finite logits, the timed steps' tokens =
               generate's.  Then two layers of zamba2 (one super-block),
               granite-moe and chameleon at full width in float32, card
               (kernels) vs CPU (plain versions): prefill logits within
               phase 9's float32 bounds, 6 greedy tokens equal, and a
               planted fault on the CPU (the shared block after every Mamba2
               layer; a capacity factor of 0.25; qk-norm dropped) outside.
  11b. serve-moe-grouped  the MoE with the JAX package's group-local
               dispatch: the rules of make_rules(..., mode="serve") for a
               (data 2, model 1) mesh, so a prefill's tokens form G = 2
               dispatch groups (a decode step's two tokens, one group).
               granite-moe-1b-a400m (2 x 8192, 24 tensor-core flash launches
               a generate) and llama4's MoE block (1 of 48 layers, 2 x 4096,
               1 launch), phase 11's seeded bf16 weights: prefill and decode
               ms at G = 2 beside G = 1 (host clock, card synchronised), the
               dropped share at G = 2.  Two float32 layers of each at G = 2
               (llama4's cut to 8 of its 128 experts: two float32 layers of
               all hold 129 GB), card vs CPU within phase 9's float32 bounds,
               6 greedy tokens equal; on the card G = 2 vs G = 1 at a
               capacity factor of E (no token drops, checked) within the same
               bounds.  Meanwhile ``python -m repro_torch.launch.dryrun`` as
               subprocesses on the CPU (granite-moe decode_32k on 16 x 16,
               llama4 train_4k on 2 x 16 x 16), each JSON holding every key.
  12. train-zoo phase 10's recipe (cdp-fedexp) at full width and depth:
               zamba2-2.7b K = 2, tau = 1, 1 round (18 of its 54 Mamba2
               layers, three super-blocks, since phase 13 came,
               TRAIN_DEPTH); granite-moe-1b-a400m (8 of its 24 layers
               since phase 13 came)
               K = 4, tau = 2, 2 rounds; after every round phase 10's
               checks, and every shared_attn.* leaf (zamba2) and every
               router and expert tensor (granite-moe) moved; ms per round,
               per local step (median of 3, profiled), peak memory.  Then
               two float32 layers of each (zamba2: one super-block) card vs
               CPU within TRAIN_CHECK_TOL and the planted eta_g = 1 outside.
               No hand-written kernel launches.
  13. audio  whisper-large-v3's encoder-decoder.  First (13a) the flash
               kernels at its shapes against their plain versions: the bf16
               tensor-core kernel at one encoder layer's every head (B 8,
               MHA 20, S 1500, Dh 64, non-causal: a ragged last tile of 92
               rows and keys) and at the decoder's prefill (4 causal query
               rows in a 128-row tile), phase 11a's tight check, the
               P-rounding bounds, two launches and strided views in bits, the
               other mask planted as the fault; each timed beside the plain
               version, the bound and SDPA (its backend named); the float32
               kernel at the encoder's shape (f32_timing).  Then (13b) the
               model at full width and depth (1.536 B seeded bf16
               parameters) served through ServeEngine(is_encdec=True)'s
               prefill and decode steps: 8 utterances x 1500 frames of seeded
               frame embeddings (the stubbed frontend's), a seeded 4-token
               prompt, 16 greedy tokens, a cache of 448 slots; 64 tensor-core
               flash launches in the prefill (32 non-causal at S 1500, 32
               causal at S 4, the recorded calls say), none in the decode
               steps; prefill and decode ms, peak memory, a profiled prefill.
               Then (13c) 2 + 2 layers at full width in float32 card vs CPU
               (2 x 1500 frames): the prefill logits within phase 9's float32
               bounds, 6 greedy tokens equal, RoPE planted on the CPU outside
               the bounds.  Then (13d) phase 10's recipe (cdp-fedexp) at full
               width and depth, K = 2, tau = 1, 1 round, each step 1 x (1500
               frames, 256 tokens): phase 10's checks, every enc_blocks.* and
               dec_blocks.*.xattn_* leaf moved, and train_reference's 2 + 2
               float32 layers card vs CPU.  Training launches no hand-written
               kernel.
Phases 3, 3b, 3e, 3f, 3g, 4, 4b and 4c are the round loop's main path, phase 6's bf16 generate the
dense serve path's (the tensor-core flash kernel), its f32 generate and phase
9's the float32 serve path's (the float32 tensor-core flash kernel), phase 7's
generate the Mamba2 serve path's, phase 8's bf16 generate the Dh-256 serve
path's (the tensor-core kernel's 64-key route), phase 11's four generates
the MoE, hybrid and VLM serve paths' (the tensor-core kernel at Dh 64, 80
and 128, ssd_scan at N 64), phase 11b's two the grouped MoE serve path's
(the tensor-core kernel at Dh 64 and 128), phase 13's request the enc-dec serve path's (the
tensor-core kernel non-causal and causal at Dh 64): every launch counter is
set to 0 before a path and read after.  The SIMT flash kernel runs only in the
route-before prefills of phases 8 and 9, whose launches its entry counts.
The line before the last is {"kernels": [...]}, the last {"ok": true, "device":
{...}}.  It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32X3_OPS_PER_S = 495e12 / 3   # float32-accurate products on the tensor cores: 3 TF32 each
# operations per element of the (M, d) matrix.  none: norm fma (2), scale mul,
# column add; operand/fused add the noise add and the square fma (3 more).
# The pair generator draws two normals a Threefry call, 133 operations a
# column pair (Threefry-2x32-20: 117 integer ops with a rotate counted as
# shift, shift, or; two bits-to-float conversions: 8; Box-Muller: 8 for log,
# sqrt, sincos and four products), 66.5 an element.  All are counted at the
# float32 rate, above the card's integer rate, so the bound stays a lower bound.
GEN_OPS = 133 / 2
OPS_PER_ELEM = {"none": 4, "operand": 7, "fused": 7 + GEN_OPS}
# Its integer operations alone, with a rotate as one funnel shift: Threefry 72
# (2 + 20 rounds x 3 + 5 key injections x 2), the two bit shifts 2: 74 a pair,
# at 64 INT32 lanes per SM and clock on the H100's 132 SMs.
GEN_INT_OPS = 74
INT32_LANES = 64 * 132
RTOL = 1e-5                 # sums: |k - p| <= RTOL * (|p| + max|p|)
NOISE_ATOL = 1e-5           # per element, in units of sigma: f32 log/cos/sin/sqrt rounding

HP = {  # (eta_l, C) of benchmarks/e1_synthetic.py; noiseless names at eta_l 0.1
    "fedavg": (0.1, None), "fedexp": (0.1, None),
    "dp-fedavg-ldp-gauss": (0.3, 1.0), "ldp-fedexp-gauss": (0.3, 0.3),
    "dp-fedavg-privunit": (0.3, 3.0), "ldp-fedexp-privunit": (0.1, 1.0),
    "dp-fedavg-cdp": (0.3, 3.0), "cdp-fedexp": (0.1, 0.3),
    "dp-scaffold-ldp": (0.3, 0.3), "dp-scaffold-cdp": (0.3, 0.3),
}
# dp-scaffold runs in both modes: these labels name the registry's
# "dp-scaffold" with central=False (LDP, sigma = 0.7C) and True (CDP)
SCAFFOLD = {"dp-scaffold-ldp": False, "dp-scaffold-cdp": True}
# the other names take the (eta_l, C) of their base name
BASE = {"privunit-fedexp-adaptive-clip": "ldp-fedexp-privunit",
        "cdp-fedexp-adaptive-clip": "cdp-fedexp", "dp-fedadam-cdp": "dp-fedavg-cdp",
        "ldp-gauss-fedadam": "dp-fedavg-ldp-gauss", "cdp-fedmom": "dp-fedavg-cdp",
        "ldp-fedexp-schedule": "ldp-fedexp-gauss", "cdp-fedexp-schedule": "cdp-fedexp",
        "ldp-fedexp-perclient": "ldp-fedexp-gauss"}
NAMES = (*HP, *BASE)
# ldp-fedexp-perclient's budgets: three tiers of clients (a quarter at eps 1,
# a quarter at 2, half at 8), delta 1e-5
PERCLIENT_TIERS = ((0.25, 1.0), (0.25, 2.0), (0.5, 8.0))
PERCLIENT_DELTA = 1e-5
PRIVUNIT = dict(eps0=2.0, eps1=2.0, eps2=2.0)    # benchmarks/common.py, the paper's budgets
DECAY = 0.97                                     # the schedules' sigma(t) = sigma0 0.97^t
FEDEXP_NAMES = ("fedexp", "ldp-fedexp-gauss", "cdp-fedexp", "ldp-fedexp-privunit",
                "privunit-fedexp-adaptive-clip", "cdp-fedexp-adaptive-clip",
                "ldp-fedexp-schedule", "cdp-fedexp-schedule", "ldp-fedexp-perclient")
# phase 3's cohorts (CohortSpec kwargs): Bernoulli 0.1 dense and gathered, and
# a fixed cohort of 100 of the 1000 clients
SAMPLED = {"q=0.1": dict(q=0.1), "q=0.1 gathered": dict(q=0.1, gather=True),
           "size=100": dict(size=100)}
# dp-scaffold also draws a fixed cohort of 100 with replacement: each draw is a
# row of its own, and its two releases stay two launches a round
REPLACE = {"size=100 replace": dict(size=100, replace=True)}


def fail(msg: str) -> None:
    """End the run with a non-zero exit and the reason."""
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def close(got, want, what: str, rtol: float = RTOL):
    """Max abs error of ``got`` vs ``want``; fails beyond rtol * (|want| + max|want|)."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    tol = rtol * (want.abs() + want.abs().max())
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        fail(f"{what}: max abs err {err.max().item():.3e} beyond rtol {rtol}")
    return err.max().item()


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def perclient_epsilons(m: int) -> tuple[float, ...]:
    """m per-client budgets in PERCLIENT_TIERS, in client order."""
    eps, start = [], 0
    for i, (share, e) in enumerate(PERCLIENT_TIERS):
        n = m - start if i == len(PERCLIENT_TIERS) - 1 else int(round(share * m))
        eps += [e] * n
        start += n
    return tuple(eps)


def registry_name(name: str) -> str:
    """The make_algorithm name of a phase's label (SCAFFOLD's two modes)."""
    return "dp-scaffold" if name in SCAFFOLD else name


def algo_kwargs(name: str, m: int, d: int, tau: int):
    """(eta_l, make_algorithm kwargs) of the paper's protocol for ``name``:
    sigma = 5C/sqrt(M) for CDP, 0.7C for LDP, eps0 = eps1 = eps2 = 2 for
    PrivUnit.  Adaptive clipping starts at c0 = C, with z_mult = sigma / C;
    the schedules decay by DECAY a round; ldp-fedexp-perclient's budgets are
    PERCLIENT_TIERS; dp-scaffold's server mirrors the local phase (tau,
    eta_l)."""
    eta_l, c = HP[BASE.get(name, name)]
    if c is None:
        return eta_l, {}
    if name == "ldp-fedexp-perclient":
        return eta_l, dict(clip_norm=c, epsilons=perclient_epsilons(m), delta=PERCLIENT_DELTA)
    if "privunit" in name:
        kw = dict(clip_norm=c, dim=d, **PRIVUNIT)
    elif "cdp" in name:
        kw = dict(clip_norm=c, sigma=5 * c / math.sqrt(m), num_clients=m)
    else:
        kw = dict(clip_norm=c, sigma=0.7 * c)
    if "adaptive-clip" in name:
        kw["c0"] = c
        if "cdp" in name:
            kw = dict(z_mult=kw["sigma"] / c, num_clients=m, c0=c)
    if "schedule" in name:
        kw["decay"] = DECAY
    if name in SCAFFOLD:
        kw.update(central=SCAFFOLD[name], num_clients=m, tau=tau, eta_l=eta_l)
    return eta_l, kw


def launches_per_round(name: str, backend: str = "auto") -> tuple[int, int]:
    """(dp_aggregate, ldp_noise) launches a round of ``name``: PrivUnit
    releases in plain PyTorch and draws its directions' normal with the
    noise-only kernel, keyed by client; the weighted ldp-fedexp-perclient
    reduces in plain PyTorch and draws its unit noise there too; the Gaussian
    LDP names on the materialized-noise backend draw theirs there too;
    dp-scaffold's two releases make two of each."""
    if "privunit" in name:
        return 0, 1
    if name == "ldp-fedexp-perclient":
        return 0, 1
    n = 2 if name in SCAFFOLD else 1
    return n, n * int(backend == "kernel")


def timed(label: str, phase, *args):
    """Run one phase; print its wall time, so that the script's time can be
    kept within its limit."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[{label}] phase done in {time.perf_counter() - t0:.1f} s")
    return out


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the card, from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_build():
    """Phase 1: build the kernels with nvcc, one process per source, all at
    once; print the times and the ptxas report."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_aggregate import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    t0 = time.perf_counter()
    loaders = (dp_ops.load_library, flash_ops.load_library, flash_ops.load_library_tc,
               flash_ops.load_library_f32, ssd_ops.load_library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        libs = [fut.result() for fut in [pool.submit(load) for load in loaders]]
    print(f"[1 build] kernels built in {time.perf_counter() - t0:.2f} s")
    for name, log in _build.build_log.items():
        print(f"    {name}: nvcc {log['seconds']:.2f} s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("    ptxas:", line.strip())
    for m, d in ((1000, 131072), (1000, 500), (8, 300001)):
        for mode in ("none", "operand", "fused"):
            plan = dp_ops.launch_plan(m, d, mode, "cuda")
            attrs = dp_ops.kernel_attributes(mode, plan.pairs)
            gated = dp_ops.kernel_attributes(mode, plan.pairs, gated=True)
            print(f"    dp_aggregate {mode} ({m},{d}): {plan}; the card holds "
                  f"{dp_ops.max_active_clusters(m, d, mode, 'cuda')} such clusters at once; "
                  f"{attrs['registers']} registers, "
                  f"{attrs['local_bytes']} B local (stack or spills), "
                  f"{attrs['static_smem']} B static + {plan.smem_bytes} B dynamic shared memory; "
                  f"gated instance {gated['registers']} registers, {gated['local_bytes']} B local")
    attrs = dp_ops.kernel_attributes(None)
    print(f"    ldp_noise: {attrs['registers']} registers, {attrs['local_bytes']} B local "
          "(stack or spills)")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        print("    sass: no cuobjdump in this toolkit")
        return
    with ThreadPoolExecutor(len(libs)) as pool:   # one cuobjdump per library, all at once
        counts = list(pool.map(lambda lib: sass_mma(cuobjdump, lib._name), libs))
    for lib, count in zip(libs, counts):
        for fn, (hmma, hgmma) in count.items():
            print(f"    sass: {Path(lib._name).name} {fn}: {hmma} HMMA, {hgmma} HGMMA")


def sass_mma(cuobjdump: str, path: str) -> dict[str, tuple[int, int]]:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel's SASS."""
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][1] += "HGMMA" in line
            counts[fn][0] += "HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def sm_clock_mhz(busy) -> float:
    """The SM clock (MHz) that nvidia-smi reads while ``busy`` keeps the card at work."""
    import torch
    query = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    while query.poll() is None:
        busy()
        torch.cuda.synchronize()
    return float(query.communicate()[0].split()[0])


def int_bound_ms(m: int, d: int, mhz: float) -> float:
    """Least time (ms) of the pair generator's integer operations for (m, d)."""
    return 1e3 * m * ((d + 1) // 2) * GEN_INT_OPS / (INT32_LANES * mhz * 1e6)


DP_SHAPES = ((1000, 500), (1000, 100), (1000, 131072), (37, 129), (1, 1), (300, 4099),
             (8, 300001), (1000, 237), (1000, 5046))


def excess(got, want) -> float:
    """Largest |got - want| over close()'s tolerance RTOL (|want| + max|want|)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (RTOL * (want.abs() + want.abs().max()))).max())


def device_clip_checks(u, clip: float, kw: dict, got, want, what: str) -> dict:
    """dp_aggregate with C as a 0-d tensor on the card: the float-C launch's
    bits, the plain version's values; and a planted fault (C read as 2C) that
    must fail the same check wherever a row clips at C."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops
    clip_t = torch.full((), clip, device=u.device)
    on_card = ops.dp_aggregate_sums(u, clip_t, **kw)
    if not all(torch.equal(a, b) for a, b in zip(on_card, got)):
        fail(f"dp_aggregate {what}: C on the card differs from C as a float in bits")
    for i, (a, b) in enumerate(zip(on_card, want)):
        close(a, b, f"dp_aggregate {what} with C on the card, output {i}")
    fault = ops.dp_aggregate_sums(u, 2 * clip_t, **kw)
    fault_excess = max(excess(a, b) for a, b in zip(fault, want))
    if bool((torch.linalg.vector_norm(u, dim=1) > clip).any()):
        if fault_excess <= 1.0:
            fail(f"dp_aggregate {what}: the planted fault (C read as 2C) passed the check")
    else:
        fault_excess = None
    return dict(bits_equal=True, fault_excess=fault_excess)


GATHER_Q = 0.1          # the gathered round's Bernoulli rate: cap 176 of M = 1000


def gate_of(m: int, d: int):
    """~10% of m rows gated on (values 1 or 2: a gate > 0 enters once), row 0
    always; drawn on the host."""
    import torch
    g = torch.Generator().manual_seed(7 * m + d)
    gate = (torch.rand(m, generator=g) < 0.1).to(torch.float32)
    gate *= torch.randint(1, 3, (m,), generator=g)
    gate[0] = 1.0
    return gate


def slot_table(m: int, d: int):
    """A gathered block of an m-client cohort on the host: ~10% of the
    clients in index order, none at its own row (where m > 1, so that keying
    by row in place of client shows), then two padding slots at client 0;
    and its gate (the padding off)."""
    import torch
    n_on = max(1, m // 10)
    g = torch.Generator().manual_seed(3 * m + d)
    on = (torch.sort(torch.randperm(m - 1, generator=g)[:n_on] + 1).values if m > 1
          else torch.zeros(1, dtype=torch.int64))
    slots = torch.cat([on, torch.zeros(2, dtype=torch.int64)])
    gate = torch.cat([torch.ones(on.numel()), torch.zeros(2)])
    return slots, gate


def caught(fault, want) -> float | None:
    """How far a planted fault's sums land from the right ones, in units of
    close()'s tolerance (inf where it is not finite)."""
    import torch
    if not all(bool(torch.isfinite(x).all()) for x in fault):
        return math.inf
    return max(excess(a, b) for a, b in zip(fault, want))


def gate_checks(u, clip: float, mode: str, kw: dict, got, opnoise, pn, m: int, d: int) -> dict:
    """dp_aggregate with a row gate on the card: an all-on gate gives the
    ungated bits; ~10% on with NaN (and, in operand mode, Inf noise) planted
    in the rows gated off gives the plain version's sums, and ignoring the
    gate (the planted fault) must fail; an all-off gate gives zero sums."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops, ref
    dev = u.device
    on = ops.dp_aggregate_sums(u, clip, row_gate=torch.ones(m, device=dev), **kw)
    if not all(torch.equal(a, b) for a, b in zip(on, got)):
        fail(f"dp_aggregate {mode} ({m},{d}): an all-on gate differs from no gate in bits")
    gate = gate_of(m, d).to(dev)
    off = gate == 0
    u_nan = u.clone()
    u_nan[off] = float("nan")
    kw_nan, noise_nan = dict(kw), None
    if mode == "operand":
        noise_nan = opnoise.clone()
        noise_nan[off] = float("inf")
        kw_nan["noise"] = noise_nan
    gated = ops.dp_aggregate_sums(u_nan, clip, row_gate=gate, **kw_nan)
    want = ref.dp_aggregate_ref(u_nan, {"operand": noise_nan, "fused": pn}.get(mode), clip,
                                row_gate=gate)
    err = max(close(a, b, f"gated dp_aggregate {mode} ({m},{d}) output {i}")
              for i, (a, b) in enumerate(zip(gated, want)))
    fault = None                      # invisible where no row is gated off (m = 1)
    if bool(off.any()):
        fault = caught(ops.dp_aggregate_sums(u_nan, clip, **kw_nan), want)
        if fault <= 1.0:
            fail(f"dp_aggregate {mode} ({m},{d}): the planted fault (gate ignored) passed")
    zero = ops.dp_aggregate_sums(u_nan, clip, row_gate=torch.zeros(m, device=dev), **kw_nan)
    if not all(bool((x == 0).all()) for x in zero):
        fail(f"dp_aggregate {mode} ({m},{d}): an all-off gate gives non-zero sums")
    del u_nan, noise_nan
    return dict(all_on_bits_equal=True, max_abs_err=err, gate_ignored_excess=fault,
                all_off_zero=True, rows_on=int((gate > 0).sum()))


def row_id_checks(u, clip: float, kn, pn, m: int, d: int, seed: int, sigma: float) -> dict:
    """A gathered block (slot_table) keyed by row ids: the noise-only kernel
    draws exactly its clients' rows of the dense noise (bits); fused mode with
    the gate and ids gives the plain version's sums, and operand mode's fed
    those rows; keying by row_start + row (the planted fault) must fail
    where a slot is not its row."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops, ref
    dev = u.device
    slots, gate = (x.to(dev) for x in slot_table(m, d))
    cap = slots.numel()
    block = ops.generate_ldp_noise(cap, d, seed, sigma, device=dev, row_ids=slots)
    if not torch.equal(block, kn[slots]):
        fail(f"ldp_noise ({m},{d}): the gathered block's rows differ from the dense noise's")
    ub = u[slots]
    fkw = dict(noise_seed=seed, noise_sigma=sigma, row_gate=gate)
    fused = ops.dp_aggregate_sums(ub, clip, row_ids=slots, **fkw)
    want = ref.dp_aggregate_ref(ub, pn[slots], clip, row_gate=gate)
    err = max(close(a, b, f"gathered fused ({m},{d}) output {i}")
              for i, (a, b) in enumerate(zip(fused, want)))
    operand = ops.dp_aggregate_sums(ub, clip, kn[slots], row_gate=gate)
    oerr = max(close(a, b, f"gathered fused vs operand ({m},{d}) output {i}")
               for i, (a, b) in enumerate(zip(fused, operand)))
    fault = caught(ops.dp_aggregate_sums(ub, clip, **fkw), want)
    if m > 1 and fault <= 1.0:
        fail(f"dp_aggregate ({m},{d}): the planted fault (row_start + row in place of row_ids) "
             "passed")
    return dict(noise_rows_bits_equal=True, max_abs_err=err, vs_operand_err=oerr,
                fused_equals_operand_bits=all(torch.equal(a, b)
                                              for a, b in zip(fused, operand)),
                row_key_fault_excess=fault if m > 1 else None, cap=cap)


def gathered_timing(dev, cases, seed: int, sigma: float) -> dict:
    """The gated kernel at the full shape with ~10% of the rows on, and a
    gathered block at (cap, 131072) for CohortSpec(q=0.1) of 1000 clients,
    each mode beside the ungated launch, with the bound of the rows on; the
    noise-only kernel with row ids at that block."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import CohortSpec, gather_slots
    from repro_torch.kernels.dp_aggregate import ops
    m, d = 1000, 131072
    g = torch.Generator(device=dev).manual_seed(99)
    u = torch.randn(m, d, generator=g, device=dev)
    u *= 2 * torch.rand(m, 1, generator=g, device=dev) / math.sqrt(d)
    noise = 0.5 * torch.randn(m, d, generator=g, device=dev)
    cohort = CohortSpec(q=GATHER_Q, gather=True)
    cap = cohort.resolved_cap(m)
    mask = cohort.round_mask(round_generator(0, 0), m)
    slots, slot_mask, _ = gather_slots(mask, cap)
    slots, slot_mask, mask = slots.to(dev), slot_mask.to(dev), mask.to(dev)
    n_on = int((mask > 0).sum())
    ub, nb = u[slots], noise[slots]
    out = dict(gated_shape=[m, d], gathered_shape=[cap, d], rows_on=n_on, modes={})
    for mode in ("none", "operand", "fused"):
        kw = dict(operand=dict(noise=noise), fused=dict(noise_seed=seed, noise_sigma=sigma)
                  ).get(mode, {})
        bkw = dict(operand=dict(noise=nb), fused=dict(noise_seed=seed, noise_sigma=sigma,
                                                      row_ids=slots)).get(mode, {})
        scale = 2 if mode == "operand" else 1
        rows_bound = bound(n_on * d * 4 * scale + d * 4 + m * 4, n_on * d * OPS_PER_ELEM[mode])
        ungated = next(c["ms"] for c in cases if c["shape"] == [m, d] and c["mode"] == mode)
        row = dict(
            gated_ms=cuda_ms(lambda: ops.dp_aggregate_sums(u, 1.0, row_gate=mask, **kw), 10),
            gathered_ms=cuda_ms(lambda: ops.dp_aggregate_sums(ub, 1.0, row_gate=slot_mask,
                                                              **bkw), 10),
            ungated_ms=ungated, bound_ms=rows_bound[0], bound_by=rows_bound[1])
        out["modes"][mode] = row
        print(f"[2 kernels] dp_aggregate {mode:7s} gated ({m},{d}), {n_on} rows on: "
              f"{row['gated_ms']:.4f} ms; gathered ({cap},{d}) with row ids: "
              f"{row['gathered_ms']:.4f} ms; ungated {ungated:.4f} ms; bound of the rows on "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    out["noise_rows_ms"] = cuda_ms(lambda: ops.generate_ldp_noise(
        cap, d, seed, sigma, device=dev, row_ids=slots), 10)
    nb_ms, nb_by = bound(cap * d * 4, cap * d * GEN_OPS)
    out["noise_rows_bound_ms"], out["noise_rows_bound_by"] = nb_ms, nb_by
    print(f"[2 kernels] ldp_noise ({cap},{d}) with row ids: {out['noise_rows_ms']:.4f} ms, "
          f"bound {nb_ms:.4f} ms ({nb_by})")
    del u, noise, ub, nb
    torch.cuda.empty_cache()
    return out


def phase_kernels(dev):
    """Kernel vs plain at every shape and mode, with and without a row gate
    and row ids; returns the timing cases."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1234)
    cases, noise_cases = [], []
    sigma, seed = 0.7, 0x5EED

    def busy():
        for _ in range(50):
            ops.generate_ldp_noise(1000, 131072, seed, sigma, device=dev)

    mhz = sm_clock_mhz(busy)
    print(f"[2 kernels] SM clock under the noise kernel: {mhz:.0f} MHz (nvidia-smi clocks.sm)")
    for m, d in DP_SHAPES:
        # row norms spread over [0, 2] so that about half the rows clip at C = 1
        u = torch.randn(m, d, generator=gen, device=dev)
        u *= 2 * torch.rand(m, 1, generator=gen, device=dev) / math.sqrt(d)
        clip = 1.0
        opnoise = 0.5 * torch.randn(m, d, generator=gen, device=dev)
        big = m * d >= 10**8

        kn = ops.generate_ldp_noise(m, d, seed, sigma, device=dev)
        pn = ref.ldp_noise_ref(m, d, seed, sigma, device=dev)
        nerr = (kn - pn).abs().max().item()
        if not torch.isfinite(kn).all() or nerr > NOISE_ATOL * sigma:
            fail(f"ldp_noise ({m},{d}): max abs err {nerr:.3e} > {NOISE_ATOL} sigma")
        b_ms, b_by = bound(m * d * 4, m * d * GEN_OPS)
        ids = row_id_checks(u, clip, kn, pn, m, d, seed, sigma)
        print(f"    row ids ({m},{d}), a gathered block of {ids['cap']}: the dense noise's rows "
              f"in bits; fused vs plain {ids['max_abs_err']:.3e}, vs operand "
              f"{ids['vs_operand_err']:.3e} (bits equal: {ids['fused_equals_operand_bits']}); "
              "planted fault (row_start + row) "
              + (f"off by {ids['row_key_fault_excess']:.3g}x the tolerance"
                 if ids["row_key_fault_excess"] is not None else "invisible: one client"))
        noise_cases.append(dict(
            shape=[m, d], max_abs_err=nerr, row_ids=ids,
            ms=cuda_ms(lambda: ops.generate_ldp_noise(m, d, seed, sigma, device=dev), 10),
            plain_ms=cuda_ms(lambda: ref.ldp_noise_ref(m, d, seed, sigma, device=dev),
                             2 if big else 10, warmup=1),
            bound_ms=b_ms, bound_by=b_by))

        plain = {
            "none": lambda: ref.dp_aggregate_ref(u, None, clip),
            "operand": lambda: ref.dp_aggregate_ref(u, opnoise, clip),
            "fused": lambda: ref.dp_aggregate_ref(
                u, ref.ldp_noise_ref(m, d, seed, sigma, device=dev), clip),
        }
        for mode in ("none", "operand", "fused"):
            kw = dict(operand=dict(noise=opnoise),
                      fused=dict(noise_seed=seed, noise_sigma=sigma)).get(mode, {})
            got = ops.dp_aggregate_sums(u, clip, **kw)
            want = ref.dp_aggregate_ref(u, dict(operand=opnoise, fused=pn).get(mode), clip)
            err = max(close(g, w, f"dp_aggregate {mode} ({m},{d}) output {i}")
                      for i, (g, w) in enumerate(zip(got, want)))
            again = ops.dp_aggregate_sums(u, clip, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"dp_aggregate {mode} ({m},{d}): two launches differ in bits")
            if mode == "fused":
                as_operand = ops.dp_aggregate_sums(u, clip, kn)
                ferr = max(close(a, b, f"fused vs operand ({m},{d}) output {i}")
                           for i, (a, b) in enumerate(zip(got, as_operand)))
                print(f"    fused vs operand fed the noise-only kernel ({m},{d}): "
                      f"max abs err {ferr:.3e}")
            on_card = device_clip_checks(u, clip, kw, got, want, f"{mode} ({m},{d})")
            gated = gate_checks(u, clip, mode, kw, got, opnoise, pn, m, d)
            print(f"    gate ({m},{d}) {mode}: all on = no gate in bits; {gated['rows_on']} rows "
                  f"on, NaN in the rest: max abs err {gated['max_abs_err']:.3e}; planted fault "
                  "(gate ignored) "
                  + (f"off by {gated['gate_ignored_excess']:.3g}x the tolerance"
                     if gated["gate_ignored_excess"] is not None else "invisible: no row off")
                  + "; all off: zero sums")
            b_ms, b_by = bound(m * d * 4 * (2 if mode == "operand" else 1) + d * 4,
                               m * d * OPS_PER_ELEM[mode])
            cases.append(dict(
                shape=[m, d], mode=mode, max_abs_err=err,
                ms=cuda_ms(lambda: ops.dp_aggregate_sums(u, clip, **kw), 10),
                plain_ms=cuda_ms(plain[mode], 2 if big else 10, warmup=1),
                bound_ms=b_ms, bound_by=b_by, device_clip=on_card, gate=gated))
            c = cases[-1]
            if big:   # the device-C launch beside the float-C one, in turns
                clip_t = torch.full((), clip, device=dev)
                on_card["ms"] = cuda_ms(lambda: ops.dp_aggregate_sums(u, clip_t, **kw), 10)
                c["ms_again"] = cuda_ms(lambda: ops.dp_aggregate_sums(u, clip, **kw), 10)
            print(f"[2 kernels] dp_aggregate {mode:7s} ({m},{d}): max abs err {err:.3e}  "
                  f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
                  + (f"  integer bound {int_bound_ms(m, d, mhz):.4f} ms" if mode == "fused"
                     else ""))
            print(f"    C on the card: the float-C bits; planted fault (C read as 2C) "
                  + ("off by " + f"{on_card['fault_excess']:.3g}x the tolerance"
                     if on_card["fault_excess"] is not None else "invisible: no row clips")
                  + (f"; {on_card['ms']:.4f} ms against {c['ms']:.4f}, {c['ms_again']:.4f} ms "
                     "with C a float" if big else ""))
        nc = noise_cases[-1]
        print(f"[2 kernels] ldp_noise ({m},{d}): max abs err {nerr:.3e}  kernel "
              f"{nc['ms']:.4f} ms  plain {nc['plain_ms']:.4f} ms  bound {nc['bound_ms']:.4f} ms "
              f"({nc['bound_by']})  integer bound {int_bound_ms(m, d, mhz):.4f} ms")
        if (m, d) == (1000, 131072):
            randn = cuda_ms(lambda: torch.randn(m, d, device=dev), 10)
            print(f"[2 kernels] torch.randn({m}, {d}) {randn:.4f} ms: PyTorch's own Gaussian "
                  "generator (Philox, other bits: not the same function), a yardstick only")
        del u, opnoise, kn, pn, plain
        torch.cuda.empty_cache()
    gathered = gathered_timing(dev, cases, seed, sigma)
    return cases, noise_cases, gathered


def make_session(name, m, d, rounds, tau, dev, *, backend="auto", data=None, kw=None,
                 cohort=None, fault=None, source=None, **specs):
    """A FederatedSession of ``name`` on the synthetic linear regression
    (``kw`` updates the protocol's make_algorithm kwargs; ``cohort`` and
    ``fault`` are dicts of CohortSpec and FaultSpec kwargs, None for full
    participation and a fault-free run; ``source`` a ClientDataSource of
    ``data``'s client rows in place of its device tensors; ``specs`` the
    session's other specs, engine, stream and ``data_spec``, its DataSpec):
    ``(session, data)``."""
    import torch
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.data.synthetic import distance_to_opt, linreg_loss, make_synthetic_linreg
    from repro_torch.fedsim import CohortSpec, FaultSpec, FederatedSession, LocalSpec, TrainSpec

    if data is None:
        data = make_synthetic_linreg(torch.Generator(device=dev).manual_seed(0), m, d)
    eta_l, base_kw = algo_kwargs(name, m, d, tau)
    kw = {**base_kw, **(kw or {})}
    if "data_spec" in specs:
        specs["data"] = specs.pop("data_spec")
    session = FederatedSession(
        make_algorithm(registry_name(name), backend=backend, **kw), linreg_loss,
        torch.zeros(d, device=dev), data.client_batches() if source is None else source,
        train=TrainSpec(rounds=rounds, tau=tau, eta_l=eta_l),
        local=LocalSpec(control_variates=True) if name in SCAFFOLD else None,
        cohort=None if cohort is None else CohortSpec(**cohort),
        fault=None if fault is None else FaultSpec(**fault),
        eval_fn=distance_to_opt(data.w_star), device=dev, **specs)
    return session, data


def run_session(name, m, d, rounds, tau, dev, *, seed=0, **kw):
    """One run of ``make_session(...)``: ``(session, result, data)``."""
    session, data = make_session(name, m, d, rounds, tau, dev, **kw)
    return session, session.run(seed), data


def check_run(name, result, rounds):
    """Finite histories of the right shape, and eta_g >= 1 for FedEXP names."""
    import torch
    eta = result.eta_history
    if eta.shape != (rounds,) or not torch.isfinite(eta).all() \
            or not torch.isfinite(result.final_w).all():
        fail(f"{name}: non-finite or misshapen results")
    if name in FEDEXP_NAMES and bool((eta < 1.0).any()):
        fail(f"{name}: eta_g < 1 in a FedEXP run")


def warmup_rounds(session) -> int:
    """The rounds the scan engine of ``session`` ran uncaptured to warm up
    before its captures (0 on another engine): their launches ran on the
    card, so the launch counters count them beside the rounds'."""
    eng = getattr(session, "_scan", None)
    return 0 if eng is None else eng.warmup_rounds


def paper_run(name, d, dev, backend="auto", cohort=None):
    """One paper-workload run, checked: finite, eta_g >= 1 for FedEXP names,
    and the kernel launches a round of ``launches_per_round``.  Returns the
    result and the final distance to w*."""
    from repro_torch.kernels.dp_aggregate import ops
    m, tau, _ = PAPER
    rounds = PAPER_RUN_ROUNDS
    label = "full" if cohort is None else next(k for k, v in {**SAMPLED, **REPLACE}.items()
                                               if v == cohort)
    before = (ops.dp_aggregate_sums.launches, ops.generate_ldp_noise.launches)
    t0 = time.perf_counter()
    session, r, data = run_session(name, m, d, rounds, tau, dev, backend=backend, cohort=cohort)
    dist = float(data.w_star.sub(r.final_w).norm())
    secs = time.perf_counter() - t0
    check_run(name, r, rounds)
    agg = ops.dp_aggregate_sums.launches - before[0]
    noise = ops.generate_ldp_noise.launches - before[1]
    ran = rounds + warmup_rounds(session)
    want_agg, want_noise = (ran * n for n in launches_per_round(name, backend))
    if agg != want_agg or noise != want_noise:
        fail(f"{name} [{backend}, {label}]: {agg} dp_aggregate and {noise} ldp_noise launches "
             f"in {rounds} rounds and {ran - rounds} warm-up rounds (want {want_agg} and "
             f"{want_noise})")
    print(f"[3 paper] {name:29s} [{backend:6s}] {label:14s} d={d}: final ||w - w*|| = "
          f"{dist:.4f}  eta_g in [{r.eta_history.min().item():.3f}, "
          f"{r.eta_history.max().item():.3f}]  {secs:.2f} s")
    return r, dist


def phase_paper(dev):
    """Phase 3: the paper workload for every ported name, under full
    participation and the SAMPLED cohorts (and REPLACE for dp-scaffold), with
    launch counts; gathered and dense runs of one seed must agree."""
    finals = {}
    for name in NAMES:
        d = 100 if "ldp" in name or "privunit" in name else 500
        gauss_ldp = "ldp" in name and "privunit" not in name and "perclient" not in name
        for backend in ("auto", "kernel") if gauss_ldp else ("auto",):
            r, dist = paper_run(name, d, dev, backend)
            finals[(name, backend)] = (r.final_w, dist)
        cohorts = {**SAMPLED, **(REPLACE if name in SCAFFOLD else {})}
        runs = {label: paper_run(name, d, dev, cohort=spec)[0] for label, spec in cohorts.items()}
        gathered_rounds(name, d, dev, runs["q=0.1"], runs["q=0.1 gathered"])
    # the materialized-noise backend of a gathered round: the noise-only kernel with row ids
    paper_run("ldp-fedexp-gauss", 100, dev, "kernel", SAMPLED["q=0.1 gathered"])
    paper_run("dp-scaffold-ldp", 100, dev, "kernel", SAMPLED["q=0.1 gathered"])
    local_training_bits(dev)
    for name, backend in finals:
        if backend == "kernel":
            # the same seed keys the same noise: fused and materialized agree
            close(finals[(name, "kernel")][0], finals[(name, "auto")][0],
                  f"{name}: kernel-fused vs materialized-noise backend")
    fedexp, fedavg = (finals[(n, "auto")][1] for n in ("ldp-fedexp-privunit",
                                                      "dp-fedavg-privunit"))
    print(f"[3 paper] ldp-fedexp-privunit ends {'nearer' if fedexp < fedavg else 'farther'} "
          f"than dp-fedavg-privunit from w* on seed 0: {fedexp:.4f} vs {fedavg:.4f}")


def gathered_rounds(name, d, dev, dense, gathered):
    """Gathered = dense at rtol 1e-5 for every round of the run: each round
    of the dense run (seed 0, q = 0.1) is taken again, gathered, from the
    same iterate and carry.  The two whole runs are compared too, and their
    gap printed: where the step extrapolates by tens a round (cdp-fedexp)
    or the release amplifies its input (PrivUnit's rows have norm |r_hat| /
    m), float32 rounding in sums of other orders compounds over the rounds.
    PrivUnit's release also takes discrete decisions on each row's norm
    (ScalarDP's randomized rounding), which a last-bit difference in local
    training can flip; its gathered rounds take the dense round's local
    updates of the sampled clients, so that they hold the protocol (gather,
    row keys, mask) and not the batched products' rounding.  The iterate is
    held; eta_g's largest relative gap is printed, as the FedEXP ratio
    subtracts the noise's expected square (Eq. 6) and so amplifies a sum's
    last bits (2.3e-5 at a round of ldp-fedexp-schedule).  dp-scaffold's
    variate carry (c and the (M, d) table) is held too."""
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import CohortSpec, gather_slots
    from repro_torch.fedsim.server import round_step
    m, tau, _ = PAPER
    rounds = PAPER_RUN_ROUNDS
    session, _, _ = run_session(name, m, d, 1, tau, dev, cohort=SAMPLED["q=0.1"])
    alg, batches, eta_l = session.algorithm, session.client_batches, session.train.eta_l
    specs = [CohortSpec(**SAMPLED[k]) for k in ("q=0.1", "q=0.1 gathered")]
    steps = [round_step(alg, session._local_fn, None, 1, spec) for spec in specs]
    shared = "privunit" in name
    w, state, worst, eta_gap = session._w0, alg.init_state(session._w0), 0.0, 0.0
    for t in range(rounds):
        if shared:
            gen = round_generator(0, t)
            mask = specs[0].round_mask(gen, m)
            noise = alg.draw_noise(gen, m, d, dev, t)
            deltas = session._local_fn(w, batches, eta_l)
            slots = gather_slots(mask, specs[1].resolved_cap(m))[0].to(dev)
            w_d, aux_d, s_d = staged_round(alg, lambda *_: deltas, w, state, noise, mask,
                                           specs[0], t, batches, eta_l)
            w_g, aux_g, _ = staged_round(alg, lambda *_: deltas[slots], w, state, noise,
                                         mask, specs[1], t, batches, eta_l)
            out_d, out_g = (aux_d.eta_g,), (aux_g.eta_g,)
        else:
            w_d, s_d, out_d = steps[0](w, state, round_generator(0, t), t, batches, eta_l)
            w_g, s_g, out_g = steps[1](w, state, round_generator(0, t), t, batches, eta_l)
            if name in SCAFFOLD:
                close(s_g.c, s_d.c, f"{name}: gathered vs dense c, round {t}")
                close(s_g.c_is, s_d.c_is, f"{name}: gathered vs dense c_i table, round {t}")
        worst = max(worst, close(w_g, w_d, f"{name}: gathered vs dense w, round {t}"))
        eta_gap = max(eta_gap, float((out_g[0] - out_d[0]).abs() / out_d[0].abs()))
        w, state = w_d, s_d
    close(w, dense.last_w, f"{name}: the dense rounds retaken vs the dense run")
    apart = (gathered.eta_history - dense.eta_history).abs() > RTOL * dense.eta_history.abs()
    first = int(apart.nonzero()[0]) if bool(apart.any()) else None
    print(f"[3 paper] {name}: gathered vs dense (q=0.1, seed 0), each of {rounds} rounds from "
          f"the same iterate{' and local updates' if shared else ''}: max abs err of w "
          f"{worst:.3e}, of eta_g {eta_gap:.2e} relative; the two whole runs: final w "
          f"{float((gathered.final_w - dense.final_w).abs().max()):.3e} apart (max |w| "
          f"{float(dense.final_w.abs().max()):.3f}), eta_g within rtol 1e-5 "
          + ("throughout" if first is None else f"until round {first}"))


def local_training_bits(dev):
    """Whether the card trains a client to the same bits in the dense cohort
    of 1000 and in the gathered block of 176 (the batched products differ in
    shape)."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.data.synthetic import linreg_loss, make_synthetic_linreg
    from repro_torch.fedsim import CohortSpec, cohort_updates, gather_rows, gather_slots
    m, tau, _ = PAPER
    data = make_synthetic_linreg(torch.Generator(device=dev).manual_seed(0), m, 100)
    spec = CohortSpec(**SAMPLED["q=0.1 gathered"])
    mask = spec.round_mask(round_generator(0, 0), m)
    slots = gather_slots(mask, spec.resolved_cap(m))[0].to(dev)
    w = 0.1 * torch.ones(100, device=dev)
    dense = cohort_updates(linreg_loss, w, data.client_batches(), tau, 0.3)
    block = cohort_updates(linreg_loss, w, gather_rows(data.client_batches(), slots), tau, 0.3)
    on = int((mask > 0).sum())
    diff = float((block[:on] - dense[slots[:on]]).abs().max())
    print(f"[3 paper] local training of the {on} sampled clients, gathered block vs dense "
          f"cohort: max abs diff {diff:.3e} (bits equal: {diff == 0.0})")


# the e1 comparison (benchmarks/e1_synthetic.py:26-55): (eta_l, C) per setting
# and algorithm, sigma = 5C/sqrt(M) for CDP and 0.7C for LDP, PrivUnit at
# eps0 = eps1 = eps2 = 2; M = 1000, tau = 20, 50 rounds; seeds 1000 + s as
# e1's PRNGKey(1000 + s)
E1_HP = {
    "ldp-gauss": {"fedexp": (0.3, 0.3), "fedavg": (0.3, 1.0), "scaffold": (0.3, 0.3)},
    "ldp-privunit": {"fedexp": (0.1, 1.0), "fedavg": (0.3, 3.0), "scaffold": (0.3, 0.3)},
    "cdp": {"fedexp": (0.1, 0.3), "fedavg": (0.3, 3.0), "scaffold": (0.3, 0.3)},
}
E1_SETTINGS = (("cdp", 500), ("ldp-gauss", 100), ("ldp-privunit", 100))
E1_SEEDS = tuple(1000 + s for s in range(5))   # e1's seeds
E1_HELD = "ldp-gauss"    # its sweeps are held seed by seed against run()


def e1_algorithm(setting: str, alg: str, m: int, d: int, tau: int, hp=E1_HP):
    """e1's algorithm for (setting, alg) at the (eta_l, C) of ``hp`` (e1's or
    e2's table), as benchmarks/common.py's make_dp_algorithm builds it, and
    dp-scaffold as e1 and e2 configure it."""
    from repro_torch.core.fedexp import make_algorithm
    eta_l, c = hp[setting][alg]
    if alg == "scaffold":
        central = setting == "cdp"
        sigma = 5 * c / math.sqrt(m) if central else 0.7 * c
        return make_algorithm("dp-scaffold", clip_norm=c, sigma=sigma, central=central,
                              num_clients=m, tau=tau, eta_l=eta_l)
    if setting == "cdp":
        return make_algorithm("cdp-fedexp" if alg == "fedexp" else "dp-fedavg-cdp",
                              clip_norm=c, sigma=5 * c / math.sqrt(m), num_clients=m)
    if setting == "ldp-gauss":
        return make_algorithm("ldp-fedexp-gauss" if alg == "fedexp" else "dp-fedavg-ldp-gauss",
                              clip_norm=c, sigma=0.7 * c)
    return make_algorithm("ldp-fedexp-privunit" if alg == "fedexp" else "dp-fedavg-privunit",
                          clip_norm=c, dim=d, **PRIVUNIT)


def same_bits(a, b) -> bool:
    """Equal tensors, NaN where both are NaN."""
    import torch
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def phase_e1(dev):
    """The paper's e1 comparison through ``run_batched`` over E1_SEEDS: for
    each setting DP-FedAvg, DP-FedEXP and DP-SCAFFOLD, the final ||w - w*||
    as mean +/- std over the seeds; OK/WARN for DP-FedEXP < DP-FedAvg,
    printed as e1 prints it (not held).  Held: finite results of shape
    (S, ...), and in E1_HELD each seed's slice equal to its own run()."""
    import torch
    from repro_torch.data.synthetic import distance_to_opt, linreg_loss, make_synthetic_linreg
    from repro_torch.fedsim import FederatedSession, LocalSpec, TrainSpec
    m, tau, rounds = PAPER
    means = {}
    for setting, d in E1_SETTINGS:
        data = make_synthetic_linreg(torch.Generator(device=dev).manual_seed(0), m, d)
        for alg in ("fedavg", "fedexp", "scaffold"):
            session = FederatedSession(
                e1_algorithm(setting, alg, m, d, tau), linreg_loss, torch.zeros(d, device=dev),
                data.client_batches(),
                train=TrainSpec(rounds=rounds, tau=tau, eta_l=E1_HP[setting][alg][0]),
                local=LocalSpec(control_variates=True) if alg == "scaffold" else None,
                eval_fn=distance_to_opt(data.w_star), device=dev)
            t0 = time.perf_counter()
            r = session.run_batched(E1_SEEDS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = len(E1_SEEDS)
            if r.final_w.shape != (n, d) or r.eta_history.shape != (n, rounds) \
                    or not torch.isfinite(r.final_w).all():
                fail(f"e1 {setting} {alg}: non-finite or misshapen run_batched results")
            dists = torch.linalg.vector_norm(r.final_w - data.w_star, dim=1).double().cpu()
            means[(setting, alg)] = mean = float(dists.mean())
            held = ""
            if setting == E1_HELD:
                for i, seed in enumerate(E1_SEEDS):
                    one = session.run(seed)
                    for f in ("final_w", "last_w", "eta_history", "metric_history",
                              "eta_naive_history", "eta_target_history"):
                        if not same_bits(getattr(r, f)[i], getattr(one, f)):
                            fail(f"e1 {setting} {alg}: run_batched seed {seed} {f} differs "
                                 "from run()")
                held = "; each seed = its run() in bits"
            print(f"[e1] {setting:12s} {alg:8s} d={d}: final ||w - w*|| over {n} seeds "
                  f"{mean:.4f} +/- {float(dists.std(unbiased=False)):.4f}  "
                  f"({secs:.2f} s{held})")
    for setting, _ in E1_SETTINGS:
        exp, avg = means[(setting, "fedexp")], means[(setting, "fedavg")]
        print(f"[e1] {'OK ' if exp < avg else 'WARN'} {setting}: DP-FedEXP {exp:.4f} vs "
              f"DP-FedAvg {avg:.4f} (DP-SCAFFOLD {means[(setting, 'scaffold')]:.4f})")


# the e2 comparison (benchmarks/e2_mnist.py:29-33): (eta_l, C) per setting and
# algorithm on the generated image set (the CDP row re-selected there for it),
# sigma = 5C/sqrt(M) for CDP and 0.7C for LDP, PrivUnit at eps0 = eps1 = eps2 = 2
E2_HP = {
    "ldp-gauss": {"fedexp": (0.03, 0.1), "fedavg": (0.03, 0.3), "scaffold": (0.1, 0.1)},
    "ldp-privunit": {"fedexp": (0.03, 0.3), "fedavg": (0.03, 0.3), "scaffold": (0.03, 0.1)},
    "cdp": {"fedexp": (0.1, 1.0), "fedavg": (0.1, 1.0), "scaffold": (0.1, 0.3)},
}
# the paper's regime: M = 1000 clients, tau = 10, 50 rounds; the 12000/2000
# generated set (12 images a client), Dirichlet(0.3); seed s splits by s and
# initialises the CNN from 100 + s, as e2's _make_problem
E2 = (1000, 10, 50)
E2_IMAGES = (12000, 2000)
E2_SEEDS = (0, 1)   # e2 runs 0-2: cut for the script's time limit
E2_SETTINGS = ("cdp", "ldp-gauss", "ldp-privunit")
E2_HELD = ("cdp", "fedexp")     # its sweep's seed 0 is held against run()
# the spec trainer's four ways (dense, gathered, faulted, resumed), on cdp-fedexp;
# the resumed run is saved every E2_SAVE rounds and resumed from the first
E2_LOCAL = dict(batch_size=4, epochs=2, prox_mu=0.01, momentum=0.9)
E2_SAVE = 20


def e2_problem(setting: str, seed: int, images, dev):
    """(model, client batches) of e2's seed ``seed``: its Dirichlet(0.3)
    split of the shared image set and its CNN (the CDP one for cdp, the LDP
    one otherwise)."""
    import torch
    from repro_torch.data import client_image_batches, dirichlet_partition
    from repro_torch.models.cnn import make_cnn
    part = dirichlet_partition(seed, images.train_y, E2[0], alpha=0.3)
    model = make_cnn(torch.Generator(device=dev).manual_seed(100 + seed),
                     "cdp" if setting == "cdp" else "ldp")
    return model, client_image_batches(images, part)


def e2_session(setting, alg, model, batches, images, dev, *, local=None, rounds=None,
               params=None, **kw):
    """A FederatedSession of e2's (setting, alg) on the CNN ``model`` from
    ``params`` (None: its init; a (S, d) stack for run_batched): ``local`` a
    dict of LocalSpec kwargs (None: full-batch GD; SCAFFOLD's trainer for
    alg scaffold); ``kw`` cohort/fault specs, num_clients."""
    from repro_torch.fedsim import FederatedSession, LocalSpec, TrainSpec
    from repro_torch.models.cnn import accuracy_fn, masked_xent_loss
    m, tau, t = E2
    local = LocalSpec(control_variates=True) if alg == "scaffold" else (
        None if local is None else LocalSpec(**local))
    return FederatedSession(
        e1_algorithm(setting, alg, m, model.dim, tau, E2_HP), masked_xent_loss(model),
        model.init_flat if params is None else params, batches,
        train=TrainSpec(rounds=rounds or t, tau=tau, eta_l=E2_HP[setting][alg][0]),
        local=local, eval_fn=accuracy_fn(model, images.test_x, images.test_y), device=dev,
        **kw)


def e2_images(dev):
    import torch
    from repro_torch.data import make_image_dataset
    return make_image_dataset(torch.Generator(device=dev).manual_seed(7), *E2_IMAGES)


def e2_launches(setting: str, alg: str) -> int:
    """dp_aggregate launches a round of e2's (setting, alg)."""
    return 2 if alg == "scaffold" else 0 if setting == "ldp-privunit" else 1


def last5(metric) -> float:
    """e2's Table 4 metric: test accuracy in %, the mean of the last 5 rounds."""
    return 100.0 * float(metric[-5:].double().mean())


def phase_e2(dev):
    """Phase 3e: the paper's image workload (e2, Fig. 1 right and Table 4).

    For cdp (the CDP CNN, d = 5046), ldp-gauss and ldp-privunit (the LDP
    CNN, d = 237): DP-FedAvg, DP-FedEXP and DP-SCAFFOLD at e2's (eta_l, C),
    each one ``run_batched(E2_SEEDS, batched_w0=True, batched_data=True)``
    sweep (each seed its own split and CNN init): the test accuracy of the
    last 5 rounds, mean +/- std, with e2's OK/WARN/n/a, printed, not held.
    Held: finite results, ``e2_launches`` dp_aggregate launches a round,
    and seed 0's slice of the E2_HELD sweep equal to its own run() in bits.  Then e2's --quick leg and the spec trainer's four ways
    (``e2_local``)."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops
    m, tau, rounds = E2
    t0 = time.perf_counter()
    images = e2_images(dev)
    torch.cuda.synchronize()
    print(f"[3e e2] generated set {E2_IMAGES[0]}/{E2_IMAGES[1]} on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    acc, s = {}, len(E2_SEEDS)
    for setting in E2_SETTINGS:
        problems = [e2_problem(setting, seed, images, dev) for seed in E2_SEEDS]
        model = problems[0][0]
        w0s = torch.stack([p[0].init_flat for p in problems])
        batches = {k: torch.stack([p[1][k] for p in problems]) for k in problems[0][1]}
        for alg in ("fedavg", "fedexp", "scaffold"):
            session = e2_session(setting, alg, model, batches, images, dev, params=w0s,
                                 num_clients=m)
            before = ops.dp_aggregate_sums.launches
            t0 = time.perf_counter()
            r = session.run_batched(E2_SEEDS, batched_w0=True, batched_data=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = ops.dp_aggregate_sums.launches - before
            if r.final_w.shape != (s, model.dim) or r.metric_history.shape != (s, rounds) \
                    or not all(torch.isfinite(x).all() for x in (r.final_w, r.eta_history,
                                                                  r.metric_history)):
                fail(f"e2 {setting} {alg}: non-finite or misshapen run_batched results")
            ran = s * rounds + warmup_rounds(session)
            if launched != ran * e2_launches(setting, alg):
                fail(f"e2 {setting} {alg}: {launched} dp_aggregate launches in {s} x {rounds} "
                     f"rounds and {ran - s * rounds} warm-up rounds (want "
                     f"{ran * e2_launches(setting, alg)})")
            held = ""
            if (setting, alg) == E2_HELD:
                one = e2_session(setting, alg, *problems[0], images, dev).run(E2_SEEDS[0])
                for f in RESULT_FIELDS:
                    if not same_bits(getattr(r, f)[0], getattr(one, f)):
                        fail(f"e2 {setting} {alg}: run_batched seed {E2_SEEDS[0]} {f} differs "
                             "from run()")
                held = f"; seed {E2_SEEDS[0]} = its run() in bits"
            accs = torch.tensor([last5(r.metric_history[i]) for i in range(s)],
                                dtype=torch.float64)
            acc[(setting, alg)] = mean = float(accs.mean())
            print(f"[3e e2] {setting:12s} {alg:8s} d={model.dim}: test acc (last 5 rounds) "
                  f"over {s} seeds {mean:.2f} +/- {float(accs.std(unbiased=False)):.2f} %; "
                  f"{launched} dp_aggregate launches  ({secs:.2f} s, "
                  f"{1e3 * secs / (s * rounds):.2f} ms a round{held})")
        del problems, batches
    for setting in E2_SETTINGS:
        exp, avg = acc[(setting, "fedexp")], acc[(setting, "fedavg")]
        if max(exp, avg) < 15.0:
            print(f"[3e e2] n/a {setting}: at chance (FedEXP {exp:.2f}% / FedAvg {avg:.2f}%)")
            continue
        print(f"[3e e2] {'OK ' if exp >= avg - 0.3 else 'WARN'} {setting}: DP-FedEXP "
              f"{exp:.2f}% vs DP-FedAvg {avg:.2f}% (DP-SCAFFOLD "
              f"{acc[(setting, 'scaffold')]:.2f}%)")
    e2_quick(dev)
    e2_local(dev, images)


def e2_quick(dev):
    """e2's --quick leg (benchmarks/e2_mnist.py:81-115): the CDP CNN as its
    parameter tree through the session, LocalSpec(batch_size=8, epochs=1,
    momentum=0.9), M = 16, 3 rounds on a 1600/400 set.  Held: a tree comes
    back, finite accuracies."""
    import torch
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.data import client_image_batches, dirichlet_partition, make_image_dataset
    from repro_torch.fedsim import FederatedSession, LocalSpec, TrainSpec
    from repro_torch.models.cnn import make_cnn_params, pytree_accuracy_fn, pytree_xent_loss
    m = 16
    images = make_image_dataset(torch.Generator(device=dev).manual_seed(7), 1600, 400)
    batches = client_image_batches(images, dirichlet_partition(0, images.train_y, m, 0.3))
    params = make_cnn_params(torch.Generator(device=dev).manual_seed(100), "cdp")
    session = FederatedSession(
        make_algorithm("cdp-fedexp", clip_norm=1.0, sigma=5.0 / math.sqrt(m), num_clients=m),
        pytree_xent_loss(), params, batches, train=TrainSpec(rounds=3, tau=1, eta_l=0.1),
        local=LocalSpec(batch_size=8, epochs=1, momentum=0.9),
        eval_fn=pytree_accuracy_fn(images.test_x, images.test_y), device=dev)
    r = session.run(0)
    if not isinstance(r.final_w, dict) or r.final_w["c1_w"].shape != (4, 4, 1, 4) \
            or not torch.isfinite(r.metric_history).all():
        fail("e2 --quick: no finite parameter tree back from the pytree CNN session")
    print(f"[3e e2] --quick: pytree CNN, LocalSpec(batch_size=8, momentum=0.9), M={m}: acc "
          f"{[round(float(a), 3) for a in r.metric_history]}; {session.privacy_report(1e-5)}")


def e2_local(dev, images):
    """The spec trainer at M = 1000: cdp-fedexp under LocalSpec(E2_LOCAL),
    dense, saving every E2_SAVE rounds, then resumed from the first
    checkpoint (held: the uninterrupted run in bits); under
    CohortSpec(q=0.1, gather=True) (held: finite, every launch gated), and
    every round of the dense q = 0.1 run retaken gathered
    (``e2_gathered_rounds``); under FAULT (held: finite, every launch gated,
    differs from the clean run)."""
    import tempfile

    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.fedsim import CohortSpec, FaultSpec
    from repro_torch.kernels.dp_aggregate import ops
    _, _, rounds = E2
    model, batches = e2_problem("cdp", 0, images, dev)

    def run(label, run_kw=None, **kw):
        before = (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches)
        t0 = time.perf_counter()
        session = e2_session("cdp", "fedexp", model, batches, images, dev, local=E2_LOCAL, **kw)
        r = session.run(0, **(run_kw or {}))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check_run("cdp-fedexp", r, rounds)
        launched = (ops.dp_aggregate_sums.launches - before[0],
                    ops.dp_aggregate_sums.gated_launches - before[1])
        ran = rounds + warmup_rounds(session)
        if launched != (ran, ran if kw else 0):   # a cohort or faults gate every launch
            fail(f"e2 spec trainer {label}: {launched[0]} dp_aggregate launches, {launched[1]} "
                 f"gated, in {rounds} rounds and {warmup_rounds(session)} warm-up rounds")
        print(f"[3e e2] cdp-fedexp LocalSpec({E2_LOCAL}) {label:22s}: test acc (last 5) "
              f"{last5(r.metric_history):.2f} %, eta_g in [{r.eta_history.min().item():.3f}, "
              f"{r.eta_history.max().item():.3f}]; {launched[1]} of {launched[0]} launches "
              f"gated ({secs:.2f} s)")
        return session, r

    with tempfile.TemporaryDirectory() as tmp:
        session, dense = run(f"dense, saved every {E2_SAVE}",
                             dict(checkpoint_dir=tmp, checkpoint_every=E2_SAVE))
        for step in ckpt.checkpoint_steps(tmp)[1:]:
            for ext in (".npz", ".json"):
                os.remove(os.path.join(tmp, f"ckpt_{step:08d}{ext}"))
        resumed = e2_session("cdp", "fedexp", model, batches, images, dev,
                             local=E2_LOCAL).resume(tmp)
        if not same_run(resumed, dense):
            fail(f"e2 spec trainer: the run resumed from round {E2_SAVE} differs from the "
                 "uninterrupted run")
    run("q=0.1 gathered", cohort=CohortSpec(q=0.1, gather=True))
    _, faulted = run("faults", fault=FaultSpec(**FAULT))
    if same_bits(faulted.final_w, dense.final_w):
        fail("e2 spec trainer: the faulted run equals the clean one")
    print(f"[3e e2] spec trainer: resumed from round {E2_SAVE} = the uninterrupted run in "
          "bits; gathered and faulted: every launch gated; faulted differs from clean")
    e2_gathered_rounds(session)


def e2_gathered_rounds(session):
    """Every round of the dense q = 0.1 run of ``session`` (the spec trainer
    on the CDP CNN) retaken gathered from the same iterate.  Held: the
    gathered block's shuffles equal the dense cohort's rows in bits (a
    client's shuffle is keyed by its global index), and the gathered round
    on the dense round's local updates of the sampled clients equals the
    dense round at rtol 1e-5 (gather, row keys, mask, moments).  Printed:
    the gathered block's own local updates against the dense rows.  The two
    are batched products over 176 and 1000 clients, equal up to float32
    rounding, and a rounding difference can flip a ReLU at its kink: that
    client's update then moves by a step, and through the FedEXP step the
    round's iterate (3.0e-5 at round 17 of a run on an "NVIDIA H100 80GB
    HBM3, 700.00 W"), as PrivUnit's discrete decisions do in
    ``gathered_rounds``."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import CohortSpec, gather_rows, gather_slots
    from repro_torch.fedsim.local import local_shuffles, shuffle_key
    m, _, rounds = E2
    alg, batches, eta_l = session.algorithm, session.client_batches, session.train.eta_l
    n, dev = batches["y"].shape[1], session.device
    specs = [CohortSpec(q=0.1), CohortSpec(q=0.1, gather=True)]
    w, state = session._w0, alg.init_state(session._w0)
    worst, gap, off, rows = 0.0, 0.0, 0, 0
    for t in range(rounds):
        gen = round_generator(0, t)
        mask = specs[0].round_mask(gen, m)
        noise = alg.draw_noise(gen, m, session.dim, dev, t)
        key = shuffle_key(gen.initial_seed()).to(dev)
        slots = gather_slots(mask, specs[1].resolved_cap(m))[0]
        on, dslots = int((mask > 0).sum()), slots.to(dev)
        if not torch.equal(local_shuffles(key, dslots, E2_LOCAL["epochs"], n),
                           local_shuffles(key, torch.arange(m, device=dev),
                                          E2_LOCAL["epochs"], n)[dslots]):
            fail(f"e2 spec trainer: the gathered block's shuffles differ, round {t}")
        deltas = session._local_fn(w, batches, eta_l, key=key, start=0)
        block = session._local_fn(w, gather_rows(batches, dslots), eta_l, key=key, start=slots)
        row_gap = (block[:on] - deltas[dslots[:on]]).abs().amax(dim=1)
        gap = max([gap] + row_gap.tolist())
        off += int((row_gap > RTOL * deltas.abs().max()).sum())
        rows += on
        w_d, _, s_d = staged_round(alg, lambda *_, **__: deltas, w, state, noise, mask,
                                   specs[0], t, batches, eta_l)
        w_g, _, _ = staged_round(alg, lambda *_, **__: deltas[dslots], w, state, noise, mask,
                                 specs[1], t, batches, eta_l)
        worst = max(worst, close(w_g, w_d, f"e2 spec trainer: gathered vs dense w, round {t}"))
        w, state = w_d, s_d
    print(f"[3e e2] spec trainer, q=0.1, each of {rounds} rounds from the dense iterate: the "
          f"gathered block's shuffles = the dense rows' in bits; the round on the dense local "
          f"updates: max abs err of w {worst:.3e} (held: rtol 1e-5); the block's own local "
          f"updates vs the dense rows: max abs diff {gap:.3e}, {off} of {rows} client rows "
          f"beyond 1e-5 of max|u| (printed)")


# the JAX tests' acceptance fault model (tests/test_faults.py:96): 30%
# dropout, stragglers cut to 1 of tau local steps, 2% corrupted (NaN) updates
# phase 3f: the streamed rounds at the full width of phase 4 (M, d, tau), their
# chunks; e8 (benchmarks/e8_million_clients.py): M = 10^6, d = 32, q = 1e-3,
# 20 rounds, tau 1, eta_l 0.5, ldp-fedexp-gauss at (C, sigma) = (0.3, 0.21)
STREAM_CHUNKS = (128, "auto")
E8 = dict(m=1_000_000, d=32, q=1e-3, rounds=20, clip=0.3, sigma=0.21, eta_l=0.5)
E8_FLOOR = 5.0           # e8's gate: gathered rounds/s >= 5x the dense sampled stream's
E8_DENSE_ROUNDS = 3
E8_SPARSE_CHUNK = 65536  # 16 chunks of 10^6 clients, the last ragged
E8_HOST_CHUNK = 128      # 10 chunks of the 1206-slot table (rounded up to 1280)


class uncounted:
    """Launches inside it (kernel against plain version, timing) leave the
    main path's launch counters as they were."""

    def __enter__(self):
        from repro_torch.kernels.dp_aggregate import ops
        self.ops = ops
        self.saved = (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches,
                      ops.generate_ldp_noise.launches)

    def __exit__(self, *exc):
        ops = self.ops
        (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches,
         ops.generate_ldp_noise.launches) = self.saved


def e8_rows(idx):
    """e8's generated client rows (its SyntheticSource's closed form): a pure
    function of the global client index, no M-sized array."""
    import numpy as np
    mix = (np.arange(1, E8["d"] + 1, dtype=np.int64) * 2654435761) % (2**31)
    g = (np.asarray(idx, np.int64)[:, None] + 1) * mix[None, :]
    return {"t": ((g % 2039) / 1019.5 - 1.0).astype(np.float32)}


def e8_loss(w, b):
    import torch
    return 0.5 * torch.sum(torch.square(w - b["t"]))


def e8_session(dev, data, cohort: dict, chunk, *, rounds=None, prefetch=2):
    """e8's ldp-fedexp-gauss session on ``data`` (a source or device tensors),
    streamed at ``chunk`` under CohortSpec(**cohort)."""
    import torch
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.fedsim import (CohortSpec, DataSpec, EngineSpec, FederatedSession,
                                    StreamSpec, TrainSpec)
    kind = getattr(data, "kind", "device")
    return FederatedSession(
        make_algorithm("ldp-fedexp-gauss", clip_norm=E8["clip"], sigma=E8["sigma"]), e8_loss,
        torch.zeros(E8["d"], device=dev), data,
        train=TrainSpec(rounds=rounds or E8["rounds"], tau=1, eta_l=E8["eta_l"]),
        engine=EngineSpec(engine="stream"), stream=StreamSpec(chunk_clients=chunk),
        cohort=CohortSpec(**cohort), data=DataSpec(kind=kind, prefetch=prefetch), device=dev)


def timed_run(session, seed=0):
    """``session.run(seed)`` on the host clock with the card synchronised:
    (result, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = session.run(seed)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def rss_gb() -> tuple[float, float]:
    """(the process's peak RSS since it started, getrusage; its RSS now, from
    /proc/self/status), in GB."""
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    now = next(int(line.split()[1]) for line in Path("/proc/self/status").read_text().splitlines()
               if line.startswith("VmRSS:")) * 1024 / 1e9
    return peak, now


def profiled_run(session, label: str) -> dict:
    """``device_window`` of a second run of ``session`` (the first warms it)."""
    session.run(0)
    return device_window(lambda: session.run(0), f"{label}, {session.train.rounds} rounds",
                         "3f stream")


def stream_full(dev, smi) -> dict:
    """Streamed rounds at phase 4's full width for ldp-fedexp-gauss and
    cdp-fedexp, at 128 clients a chunk and at "auto": each retaken from the
    dense eager round's iterate (round 1, from round 0's) and held to its
    output at RTOL; dp_aggregate launches, host ms with the card
    synchronised, and peak memory beside the dense round's.  For
    ldp-fedexp-gauss the chunk-128 round again from a HostArraySource of the
    same rows (8 chunks of 67 MB staged through pinned memory) at prefetch
    1 and 3: equal to each other in bits and to the device-resident round
    at RTOL, ms and peak memory, and a profiled round's idle share."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import EngineSpec, StreamSpec
    from repro_torch.kernels.dp_aggregate import ops
    m, d, tau, _ = FULL_SIZE
    data, out = None, {}
    for name in ("ldp-fedexp-gauss", "cdp-fedexp"):
        session, data = make_session(name, m, d, 2, tau, dev, data=data)
        eta_l, batches = session.train.eta_l, session.client_batches
        w0 = torch.zeros(d, device=dev)
        w1, s1, _ = session._step()(w0, session.algorithm.init_state(w0),
                                    round_generator(0, 0), 0, batches, eta_l)

        def one_round(sess):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n0 = ops.dp_aggregate_sums.launches
            t0 = time.perf_counter()
            w2, _, _ = sess._step()(w1, s1, round_generator(0, 1), 1, sess.client_batches,
                                    eta_l)
            torch.cuda.synchronize()
            return (w2, 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated() / 1e9,
                    ops.dp_aggregate_sums.launches - n0)

        want, dense_ms, dense_gb, dense_n = one_round(session)
        row = {"dense": dict(ms=dense_ms, peak_gb=dense_gb, launches=dense_n)}
        streamed = {}
        for chunk in STREAM_CHUNKS:
            sess, _ = make_session(name, m, d, 2, tau, dev, data=data,
                                   engine=EngineSpec(engine="stream"),
                                   stream=StreamSpec(chunk_clients=chunk))
            c = min(sess.stream.chunk_clients, m)
            one_round(sess)   # warm-up: the chunk's launch plan
            got, ms, gb, n = one_round(sess)
            if n != -(-m // c):
                fail(f"{name} streamed at chunk {chunk}: {n} dp_aggregate launches in a round, "
                     f"want {-(-m // c)}")
            err = close(got, want, f"{name} streamed at chunk {chunk} vs the dense round")
            streamed[chunk] = (got, ms)
            row[str(chunk)] = dict(chunk=c, resolved=sess.stream.chunk_clients, ms=ms,
                                   peak_gb=gb, launches=n, max_abs_err=err,
                                   top=device_window(lambda: one_round(sess),
                                                     f"{name} streamed at chunk {chunk}, a round",
                                                     "3f stream"))
            print(f"[3f stream] {name} M={m} d={d} tau={tau} chunk {chunk} ({c} clients a "
                  f"chunk): {n} dp_aggregate launches, {ms:.3f} ms a round (host clock, "
                  f"card synchronised), peak {gb:.3f} GB; the dense eager round {dense_ms:.3f} "
                  f"ms, peak {dense_gb:.3f} GB, {dense_n} launch; max abs err {err:.3e}  [{smi}]")
        if name == "ldp-fedexp-gauss":
            row["host"] = full_width_host(name, data, batches, streamed[128], one_round, smi)
        out[name] = row
    del data
    torch.cuda.empty_cache()
    return out


def full_width_host(name, data, batches, device_round, one_round, smi) -> dict:
    """``stream_full``'s chunk-128 round of ``name`` from a HostArraySource
    of ``batches`` at prefetch 1 and 3 (``one_round`` retakes round 1):
    held in bits to each other and at RTOL to ``device_round`` (the
    device-resident streamed round's (w, ms)); ms, peak memory and a
    profiled round."""
    from repro_torch.fedsim import DataSpec, EngineSpec, HostArraySource, StreamSpec
    m, d, tau, _ = FULL_SIZE
    source = HostArraySource({k: v.cpu().numpy() for k, v in batches.items()})
    out, first = {}, None
    for depth in (1, 3):
        sess, _ = make_session(name, m, d, 2, tau, data.x.device, data=data, source=source,
                               data_spec=DataSpec(kind="host", prefetch=depth),
                               engine=EngineSpec(engine="stream"),
                               stream=StreamSpec(chunk_clients=128))
        one_round(sess)   # warm-up: the pinned blocks
        got, ms, gb, n = one_round(sess)
        if first is not None and not same_bits(got, first):
            fail(f"{name} from the host at chunk 128: prefetch {depth} differs from prefetch 1 "
                 "in bits")
        first = got if first is None else first
        err = close(got, device_round[0], f"{name} from the host at chunk 128, prefetch {depth}, "
                                          "vs the device-resident streamed round")
        out[f"prefetch {depth}"] = dict(ms=ms, peak_gb=gb, launches=n, max_abs_err=err,
                                        bits_equal_device=same_bits(got, device_round[0]))
        if depth == 3:
            out["top"] = device_window(lambda: one_round(sess), f"{name} from the host at chunk "
                                       "128, prefetch 3, a round", "3f stream")
        print(f"[3f stream] {name} M={m} d={d} tau={tau} from a HostArraySource at chunk 128 "
              f"({-(-m // 128)} chunks of {128 * (d + 1) * 4 / 1e6:.1f} MB), prefetch {depth}: "
              f"{n} dp_aggregate launches, {ms:.3f} ms a round (host clock, card synchronised; "
              f"device-resident {device_round[1]:.3f} ms), peak {gb:.3f} GB; vs the "
              f"device-resident round max abs err {err:.3e} (equal in bits: "
              f"{out[f'prefetch {depth}']['bits_equal_device']})  [{smi}]")
    return out


def e8_host(dev, smi) -> dict:
    """e8's host workload, nothing cut: a SyntheticSource of 10^6 clients,
    gathered q = 1e-3 cohorts, "auto" chunk, prefetch 2, 20 rounds.  Held:
    finite; a HostArraySource of the same rows and prefetch 1 equal in bits;
    3 rounds equal at RTOL to the device-resident gathered stream."""
    import numpy as np
    import torch
    from repro_torch.fedsim import HostArraySource, SyntheticSource
    m = E8["m"]
    gathered = dict(q=E8["q"], gather=True)
    source = SyntheticSource(e8_rows, m)
    e8_session(dev, source, gathered, "auto").run(1)   # warm-up
    rss0 = rss_gb()
    torch.cuda.reset_peak_memory_stats()
    session = e8_session(dev, source, gathered, "auto")
    r, secs = timed_run(session)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rss1 = rss_gb()
    check_run("e8 host", r, E8["rounds"])
    cap = session.cohort.resolved_cap(m)
    chunk = min(session.stream.chunk_clients, cap)
    rows = e8_rows(np.arange(m))
    for label, other in (("HostArraySource", e8_session(dev, HostArraySource(rows), gathered,
                                                          "auto")),
                         ("prefetch 1", e8_session(dev, source, gathered, "auto", prefetch=1))):
        if not same_run(other.run(0), r):
            fail(f"e8 host: the run on {label} differs from the SyntheticSource run in bits")
    out_top = profiled_run(e8_session(dev, source, gathered, "auto", rounds=3), "e8 host")
    device_rows = {"t": torch.from_numpy(rows["t"]).to(dev)}
    short = e8_session(dev, source, gathered, "auto", rounds=3).run(0)
    resident = e8_session(dev, device_rows, gathered, "auto", rounds=3).run(0)
    err = close(short.final_w, resident.final_w, "e8 host vs the device-resident gathered stream")
    del device_rows, rows   # off the card before the chunked run's peak
    out = dict(rounds_per_s=E8["rounds"] / secs, resolved_chunk=session.stream.chunk_clients,
               chunk=chunk, cap=cap, peak_gb=peak_gb, peak_rss_gb=rss1[0],
               rss_before_gb=rss0[1], rss_after_gb=rss1[1], max_abs_err=err, top=out_top,
               chunked=e8_host_chunked(dev, source, short, smi))
    print(f"[3f stream] e8 host M={m} d={E8['d']} q={E8['q']} SyntheticSource, gathered, chunk "
          f"auto = {session.stream.chunk_clients} (capped at the {cap}-slot table: {chunk}), "
          f"prefetch 2: {out['rounds_per_s']:.2f} rounds/s over {E8['rounds']} rounds (host "
          f"clock, card synchronised); peak device memory {peak_gb:.4f} GB; peak RSS "
          f"{rss1[0]:.2f} GB since the script started (RSS {rss0[1]:.2f} -> {rss1[1]:.2f} GB "
          f"over the run); HostArraySource and prefetch 1 equal in bits; 3 rounds vs "
          f"device-resident max abs err {err:.3e}  [{smi}]")
    return out


def e8_host_chunked(dev, source, auto3, smi) -> dict:
    """e8's host workload with several chunks a round: the gathered slot
    table at E8_HOST_CHUNK clients a chunk, 20 rounds at prefetch 1 and 3
    (equal in bits), rounds/s and peak device memory of each, a profiled
    3-round run's idle share, and 3 rounds held at RTOL to ``auto3`` (the
    auto chunk's 3 rounds)."""
    import torch
    from repro_torch.fedsim import CohortSpec
    gathered = dict(q=E8["q"], gather=True)
    e8_session(dev, source, gathered, E8_HOST_CHUNK, rounds=1).run(1)   # warm-up
    out, first = {}, None
    for depth in (1, 3):
        torch.cuda.reset_peak_memory_stats()
        r, secs = timed_run(e8_session(dev, source, gathered, E8_HOST_CHUNK, prefetch=depth))
        check_run(f"e8 host at chunk {E8_HOST_CHUNK}", r, E8["rounds"])
        if first is not None and not same_run(r, first):
            fail(f"e8 host at chunk {E8_HOST_CHUNK}: prefetch {depth} differs from prefetch 1 "
                 "in bits")
        first = r if first is None else first
        out[f"prefetch {depth}"] = dict(rounds_per_s=E8["rounds"] / secs,
                                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["top"] = profiled_run(e8_session(dev, source, gathered, E8_HOST_CHUNK, prefetch=3,
                                         rounds=3), f"e8 host at chunk {E8_HOST_CHUNK}")
    r3 = e8_session(dev, source, gathered, E8_HOST_CHUNK, rounds=3).run(0)
    out["max_abs_err"] = close(r3.final_w, auto3.final_w,
                               f"e8 host at chunk {E8_HOST_CHUNK} vs auto, 3 rounds")
    cap = -(-CohortSpec(**gathered).resolved_cap(E8["m"]) // E8_HOST_CHUNK) * E8_HOST_CHUNK
    print(f"[3f stream] e8 host at chunk {E8_HOST_CHUNK} ({cap // E8_HOST_CHUNK} chunks a round "
          f"from the SyntheticSource): prefetch 1 {out['prefetch 1']['rounds_per_s']:.2f}, "
          f"prefetch 3 {out['prefetch 3']['rounds_per_s']:.2f} rounds/s over {E8['rounds']} "
          f"rounds (host clock, card synchronised), equal in bits; peak device memory "
          f"{out['prefetch 1']['peak_gb']:.4f} and {out['prefetch 3']['peak_gb']:.4f} GB; 3 "
          f"rounds vs auto max abs err {out['max_abs_err']:.3e}  [{smi}]")
    return out


def e8_sparse(dev, smi) -> dict:
    """e8's sparse workload on device-resident rows: the dense sampled stream
    (every client trained, one gated launch a chunk) for E8_DENSE_ROUNDS and
    the gathered stream for 20 rounds, rounds/s and their ratio beside e8's
    floor; the dense stream again at E8_SPARSE_CHUNK, held at RTOL to auto."""
    import numpy as np
    import torch
    m = E8["m"]
    rows = {"t": torch.from_numpy(e8_rows(np.arange(m))["t"]).to(dev)}
    dense_cohort, gathered = dict(q=E8["q"]), dict(q=E8["q"], gather=True)
    e8_session(dev, rows, dense_cohort, "auto", rounds=1).run(1)   # warm-up
    dense = e8_session(dev, rows, dense_cohort, "auto", rounds=E8_DENSE_ROUNDS)
    d_r, d_secs = timed_run(dense)
    g_r, g_secs = timed_run(e8_session(dev, rows, gathered, "auto"))
    check_run("e8 sparse dense", d_r, E8_DENSE_ROUNDS)
    check_run("e8 sparse gathered", g_r, E8["rounds"])
    chunked = e8_session(dev, rows, dense_cohort, E8_SPARSE_CHUNK, rounds=E8_DENSE_ROUNDS)
    c_r, c_secs = timed_run(chunked)
    err = close(c_r.final_w, d_r.final_w, f"e8 dense stream at chunk {E8_SPARSE_CHUNK} vs auto")
    dense_rps, gathered_rps = E8_DENSE_ROUNDS / d_secs, E8["rounds"] / g_secs
    tops = {label: profiled_run(e8_session(dev, rows, c, "auto", rounds=3), f"e8 sparse {label}")
            for label, c in (("dense sampled", dense_cohort), ("gathered", gathered))}
    out = dict(top=tops, dense_rounds_per_s=dense_rps, gathered_rounds_per_s=gathered_rps,
               ratio=gathered_rps / dense_rps, floor=E8_FLOOR,
               dense_chunk=min(dense.stream.chunk_clients, m),
               chunked_rounds_per_s=E8_DENSE_ROUNDS / c_secs, max_abs_err=err)
    print(f"[3f stream] e8 sparse M={m} d={E8['d']} q={E8['q']} device-resident: dense "
          f"sampled stream (chunk {out['dense_chunk']}) {dense_rps:.3f} rounds/s over "
          f"{E8_DENSE_ROUNDS}, gathered stream {gathered_rps:.2f} rounds/s over {E8['rounds']}: "
          f"{out['ratio']:.1f}x (e8's floor {E8_FLOOR}x: "
          f"{'OK' if out['ratio'] >= E8_FLOOR else 'BELOW'}); the dense stream at chunk "
          f"{E8_SPARSE_CHUNK} ({-(-m // E8_SPARSE_CHUNK)} chunks) "
          f"{out['chunked_rounds_per_s']:.3f} rounds/s, vs auto max abs err {err:.3e}  [{smi}]")
    del rows
    torch.cuda.empty_cache()
    return out


def stream_kernel(dev, smi) -> dict:
    """The chunked wrapper at (1000, 131072) in fused mode, chunk_m = 125 (8
    launches), and over a gathered slot table (CohortSpec(q=0.1)'s cap, 2
    chunks): held to one-launch dp_aggregate_sums and to its plain version
    at RTOL, timed with CUDA events.  And dp_aggregate at the shapes the
    streamed rounds give it, timed gated, with the bound of the rows on:
    e8's dense sampled launch (10^6, 32) with its ~1000 rows on, e8's
    gathered chunk keyed by its slots, e8's last 65536 chunk (keyed past M),
    and the full-width chunk of 128; each launch held to its plain version
    (``ref.plain_sums``) on the same rows, gate and keys at RTOL."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import CohortSpec, gather_slots
    from repro_torch.kernels.dp_aggregate import ops, ref
    m, d, _, _ = FULL_SIZE
    seed, sigma = 77, 0.2
    out = {}
    with uncounted():
        g = torch.Generator(device=dev).manual_seed(5)
        u = torch.randn(m, d, generator=g, device=dev) * (2 / math.sqrt(d))
        kw = dict(noise_seed=seed, noise_sigma=sigma)
        cohort = CohortSpec(q=0.1, gather=True)
        mask = cohort.round_mask(round_generator(0, 0), m)
        cap = -(-cohort.resolved_cap(m) // 88) * 88
        slots, slot_mask, _ = gather_slots(mask, cap)
        slots, slot_mask, gate = slots.to(dev), slot_mask.to(dev), mask.to(dev)
        for label, ckw, one in (
                (f"chunk_m {m // 8}", dict(chunk_m=m // 8),
                 lambda: ops.dp_aggregate_sums(u, 1.0, **kw)),
                (f"slots ({cap},) chunk_m 88", dict(chunk_m=88, slots=slots,
                                                     slot_mask=slot_mask),
                 lambda: ops.dp_aggregate_sums(u, 1.0, row_gate=gate, **kw))):
            got = ops.dp_aggregate_sums_chunked(u, 1.0, **ckw, **kw)
            plain = ref.dp_aggregate_sums_chunked_ref(u, 1.0, **ckw, **kw)
            want = one()
            err = max(max(close(a, b, f"chunked wrapper {label} vs its plain version"),
                          close(a, c, f"chunked wrapper {label} vs one launch"))
                      for a, b, c in zip(got, plain, want))
            ms = cuda_ms(lambda: ops.dp_aggregate_sums_chunked(u, 1.0, **ckw, **kw), 5)
            one_ms = cuda_ms(one, 5)
            out[label] = dict(ms=ms, one_launch_ms=one_ms, max_abs_err=err)
            print(f"[3f stream] dp_aggregate_sums_chunked ({m},{d}) fused {label}: {ms:.4f} ms "
                  f"(CUDA events), one launch {one_ms:.4f} ms; vs plain and one launch max abs "
                  f"err {err:.3e}  [{smi}]")
        del u
        torch.cuda.empty_cache()
        shapes = {}
        e8m = E8["m"]
        e8_mask = CohortSpec(q=E8["q"]).round_mask(round_generator(0, 0), e8m)
        e8_cap = CohortSpec(q=E8["q"], gather=True).resolved_cap(e8m)
        e8_slots, e8_slot_mask, _ = gather_slots(e8_mask, e8_cap)
        # e8's dense stream at E8_SPARSE_CHUNK: its last chunk, padded past M
        j0, idx, valid = list(ref.chunk_grid(e8m, E8_SPARSE_CHUNK))[-1]
        # label: (rows, cols, host gate, mode, noise keys)
        for label, (rows, cols, gate_of_rows, mode, keys) in {
                f"e8 dense sampled ({e8m}, {E8['d']})": (e8m, E8["d"], e8_mask, "fused", {}),
                f"e8 gathered chunk ({e8_cap}, {E8['d']}), keyed by slots": (
                    e8_cap, E8["d"], e8_slot_mask, "fused", dict(row_ids=e8_slots.to(dev))),
                f"e8 last chunk ({E8_SPARSE_CHUNK}, {E8['d']}) from row {j0}": (
                    E8_SPARSE_CHUNK, E8["d"], e8_mask[idx] * valid, "fused",
                    dict(row_start=j0)),
                f"full-width chunk (128, {d}) fused": (128, d, torch.ones(128), "fused", {}),
                f"full-width chunk (128, {d}) none": (128, d, torch.ones(128), "none", {})}.items():
            x = torch.randn(rows, cols, generator=g, device=dev) * 0.1
            gate = gate_of_rows.to(dev)
            mkw = {**kw, **keys} if mode == "fused" else {}
            on = int((gate > 0).sum())
            got = ops.dp_aggregate_sums(x, 1.0, row_gate=gate, **mkw)
            plain = ref.plain_sums(x, 1.0, row_gate=gate, **mkw)
            err = max(close(a, b, f"dp_aggregate {mode} gated {label} vs its plain version")
                      for a, b in zip(got, plain))
            ms = cuda_ms(lambda: ops.dp_aggregate_sums(x, 1.0, row_gate=gate, **mkw), 10)
            b_ms, b_by = bound(on * cols * 4 + rows * 4 + cols * 4, on * cols * OPS_PER_ELEM[mode])
            shapes[label] = dict(shape=[rows, cols], rows_on=on, mode=mode, ms=ms, bound_ms=b_ms,
                                 bound_by=b_by, max_abs_err=err)
            print(f"[3f stream] dp_aggregate {mode} gated {label}, {on} rows on: {ms:.4f} ms "
                  f"(CUDA events), bound of the rows on {b_ms:.5f} ms ({b_by}): "
                  f"{ms / b_ms:.0f}x; vs its plain version max abs err {err:.3e}  [{smi}]")
            del x
        out["shapes"] = shapes
    return out


def stream_faults(dev, smi) -> dict:
    """ldp-fedexp-gauss on the paper workload under FAULT, streamed at 128
    clients a chunk: the run's launches (8 gated a round), finite; each round
    retaken streamed from the faulted eager run's iterate and carry and held
    to it at RTOL; the two whole runs' gap printed."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import EngineSpec, StreamSpec
    from repro_torch.kernels.dp_aggregate import ops
    m, tau, rounds = PAPER
    name, d, chunk = "ldp-fedexp-gauss", 100, 128
    stream = dict(engine=EngineSpec(engine="stream"), stream=StreamSpec(chunk_clients=chunk))
    before = (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches)
    ss, got, data = run_session(name, m, d, rounds, tau, dev, fault=FAULT, **stream)
    launched = ops.dp_aggregate_sums.launches - before[0]
    gated = ops.dp_aggregate_sums.gated_launches - before[1]
    check_run(f"{name} streamed under faults", got, rounds)
    want_n = rounds * -(-m // chunk)
    if launched != want_n or gated != want_n:
        fail(f"{name} streamed under faults: {launched} launches, {gated} gated (want {want_n})")
    es, want, _ = run_session(name, m, d, rounds, tau, dev, data=data, fault=FAULT)
    eager, streamed = es._step(), ss._step()
    w = torch.zeros(d, device=dev)
    state = es.algorithm.init_state(w)
    worst = 0.0
    with uncounted():
        for t in range(rounds):
            w_next, s_next, _ = eager(w, state, round_generator(0, t), t, es.client_batches,
                                      es.train.eta_l)
            w_s, _, _ = streamed(w, state, round_generator(0, t), t, ss.client_batches,
                                 ss.train.eta_l)
            worst = max(worst, close(w_s, w_next, f"{name} under faults, round {t} streamed "
                                                  "vs eager"))
            w, state = w_next, s_next
    gap = float((got.final_w - want.final_w).abs().max())
    print(f"[3f stream] {name} paper workload d={d} under FaultSpec({FAULT}), chunk {chunk}: "
          f"{launched} dp_aggregate launches, all gated; each round retaken streamed from the "
          f"eager iterate, max abs err {worst:.3e}; the whole runs' final w {gap:.3e} apart  "
          f"[{smi}]")
    return dict(launches=launched, max_abs_err=worst, whole_run_gap=gap)


def phase_stream(dev, smi) -> dict:
    """Phase 3f: the streaming engine and host-resident data (``stream_full``,
    ``e8_host``, ``e8_sparse``, ``stream_kernel``, ``stream_faults``)."""
    return dict(full=stream_full(dev, smi), e8_host=e8_host(dev, smi),
                e8_sparse=e8_sparse(dev, smi), kernel=stream_kernel(dev, smi),
                faults=stream_faults(dev, smi))


# e9 (benchmarks/e9_compression.py) at its own geometry, nothing cut: cdp-fedexp at
# C = 1, sigma = 5e-4 on the quadratic 0.5 ||w - t_i||^2, M = 256, d = 2^20, tau = 1,
# eta_l = 0.5, 10 rounds; rand-k keeps d/64, the sketch is d/256 wide and 3 deep
E9 = dict(m=256, d=1 << 20, rounds=10, clip=1.0, sigma=5e-4, eta_l=0.5, k_div=64, w_div=256,
          depth=3, parity_rounds=4, stream_chunk=64)


def e9_targets(dev):
    """e9's (M, d) client targets (its ``_targets``, numpy seed 0): a shared
    signal plus 30% heterogeneity, both at O(1) norm, on the card."""
    import numpy as np
    import torch
    m, d = E9["m"], E9["d"]
    rng = np.random.default_rng(0)
    shared = (rng.standard_normal(d) * d**-0.5).astype(np.float32)
    het = (rng.standard_normal((m, d)) * d**-0.5).astype(np.float32)
    return torch.from_numpy(shared[None, :] + 0.3 * het).to(dev)


def e9_loss(w, b):
    return 0.5 * (w - b["t"]).square().sum()


def e9_variants() -> dict:
    """e9's aggregation layers by label: None is the dense round."""
    from repro_torch.core.compose import CountSketchAggregation, RandKAggregation
    d, depth = E9["d"], E9["depth"]
    k, width = d // E9["k_div"], d // E9["w_div"]
    return {"dense": None, "rand-k": RandKAggregation(k=k),
            "sketch": CountSketchAggregation(width=width, depth=depth),
            "sketch top-k ef": CountSketchAggregation(width=width, depth=depth, top_k=k,
                                                      error_feedback=True),
            "lossless rand-k": RandKAggregation(k=d)}


def e9_session(dev, targets, aggregation, *, name="cdp-fedexp", rounds=None, **specs):
    """e9's session of ``name`` (cdp-fedexp, or noiseless fedexp), compressed
    by ``aggregation`` unless it is None."""
    import torch
    from repro_torch.core.compose import with_compression
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.fedsim import CohortSpec, FederatedSession, TrainSpec
    kw = {} if name == "fedexp" else dict(clip_norm=E9["clip"], sigma=E9["sigma"],
                                          num_clients=E9["m"])
    alg = make_algorithm(name, **kw)
    if aggregation is not None:
        alg = with_compression(alg, aggregation)
    if "cohort" in specs:
        specs["cohort"] = CohortSpec(**specs["cohort"])
    return FederatedSession(alg, e9_loss, torch.zeros(E9["d"], device=dev), {"t": targets},
                            train=TrainSpec(rounds=rounds or E9["rounds"], tau=1,
                                            eta_l=E9["eta_l"]), device=dev, **specs)


def e9_mean_loss(w, targets) -> float:
    """e9's ``_mean_loss``: the clients' mean of 0.5 ||w - t_i||^2."""
    return float(0.5 * (w[None, :] - targets).square().sum(dim=1).mean())


def e9_retaken(label, dev, targets, aggregation, want_spec: dict, got_spec: dict) -> float:
    """Each round of the ``want_spec`` run taken again under ``got_spec``
    from the same iterate and carry, held at RTOL: the worst max abs error."""
    from repro_torch.core.algorithm import round_generator
    want_s = e9_session(dev, targets, aggregation, **want_spec)
    got_s = e9_session(dev, targets, aggregation, **got_spec)
    steps = (want_s._step(), got_s._step())
    alg = want_s.algorithm
    w, state, worst = want_s._w0, alg.init_state(want_s._w0), 0.0
    for t in range(E9["rounds"]):
        w_d, s_d, out_d = steps[0](w, state, round_generator(0, t), t, {"t": targets},
                                   E9["eta_l"])
        w_g, s_g, out_g = steps[1](w, state, round_generator(0, t), t, {"t": targets},
                                   E9["eta_l"])
        worst = max(worst, close(w_g, w_d, f"e9 {label}: w, round {t}"))
        close(out_g[0], out_d[0], f"e9 {label}: eta_g, round {t}")
        if hasattr(s_d, "ef"):
            close(s_g.ef, s_d.ef, f"e9 {label}: the EF residual, round {t}")
        w, state = w_d, s_d
    return worst


def e9_sums(dev, targets, smi) -> dict:
    """The round's reductions at e9's shape, timed with CUDA events outside
    the main path's counts: dp_aggregate (none mode, the dense cdp-fedexp
    release) held to its plain version at RTOL, with its bound, beside the
    compressed moments in plain PyTorch (rand-k's and the sketch's
    ``partial_clip_moments`` on a round's plan, its bucket order built)."""
    import torch
    from repro_torch.core.aggregation import partial_clip_moments
    from repro_torch.core.compression import plan_generator
    from repro_torch.kernels.dp_aggregate import ops, ref
    m, d = targets.shape
    u = 0.5 * targets            # round 0's updates: -eta_l (w0 - t_i)
    variants = e9_variants()
    fns = {label: variants[label].compress_fn(variants[label].plan(plan_generator(0), d, dev))
           for label in ("rand-k", "sketch")}
    with uncounted():
        got, want = ops.dp_aggregate_sums(u, E9["clip"]), ref.plain_sums(u, E9["clip"])
        err = max(close(g.reshape(-1), w.reshape(-1), f"e9 dp_aggregate at ({m}, {d})")
                  for g, w in zip(got, want))
        row = dict(shape=[m, d], ms=cuda_ms(lambda: ops.dp_aggregate_sums(u, E9["clip"]), 20),
                   plain_ms=cuda_ms(lambda: ref.plain_sums(u, E9["clip"]), 5), max_abs_err=err)
    row["bound_ms"], row["bound_by"] = bound(4.0 * (m * d + d + 2), OPS_PER_ELEM["none"] * m * d)
    for label, fn in fns.items():
        row[f"{label} moments ms"] = cuda_ms(
            lambda fn=fn: partial_clip_moments(u, E9["clip"], compress_fn=fn), 10)
    print(f"[3g e9] the release's sums at ({m}, {d}), CUDA events: dp_aggregate none "
          f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, {row['bound_by']}; plain "
          f"{row['plain_ms']:.4f}; max abs err {err:.3e}); compressed moments, plain PyTorch: "
          f"rand-k {row['rand-k moments ms']:.4f} ms, sketch {row['sketch moments ms']:.4f} ms"
          f"  [{smi}]")
    return row


def phase_e9(dev, smi) -> dict:
    """Phase 3g: e9 at its own geometry (``E9``), nothing cut.  For each of
    e9's variants (dense, rand-k d/64, the sketch d/256 x 3, the same sketch
    with top-k d/64 and error feedback, lossless rand-k): rounds/s (host
    clock, card synchronised, the better of two runs after a warm one), the
    modeled bytes a round (4 comm_floats(d)) and their reduction against
    dense, dp_aggregate launches a round, the peak memory, and the loss
    decrease over 4 rounds relative to dense (informational, as in e9);
    e9's rand-k >= 2x dense rounds/s printed as OK or WARN.  Held: every
    output finite; one dp_aggregate launch a dense round and none a
    compressed one; noiseless fedexp under lossless rand-k = dense at RTOL
    (w and eta); two runs of the sketch and of the EF sketch equal in bits;
    rand-k, the sketch and the EF sketch streamed at chunk 64 and gathered
    at q = 0.1, each round retaken from the eager (dense sampled) iterate
    and carry at RTOL; an EF-sketch run saved at round 5 and resumed = the
    uninterrupted run in bits.  A profiled 10-round run of dense and of the
    sketch, and the release's sums at e9's shape (``e9_sums``)."""
    import tempfile

    import torch
    from repro_torch.fedsim import EngineSpec, StreamSpec
    from repro_torch.kernels.dp_aggregate import ops
    m, d, rounds = E9["m"], E9["d"], E9["rounds"]
    targets = e9_targets(dev)
    w0 = torch.zeros(d, device=dev)
    l0 = e9_mean_loss(w0, targets)
    out, dense_bytes = {}, 4 * (d + 3)
    for label, agg in e9_variants().items():
        session = e9_session(dev, targets, agg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = ops.dp_aggregate_sums.launches
        first, _ = timed_run(session)
        launches = (ops.dp_aggregate_sums.launches - n0) / (rounds + warmup_rounds(session))
        peak = torch.cuda.max_memory_allocated() / 1e9
        (a, ta), (b, tb) = timed_run(session), timed_run(session)
        check_run(f"e9 {label}", a, rounds)
        if launches != (0 if agg is not None else 1):
            fail(f"e9 {label}: {launches} dp_aggregate launches a round, want "
                 f"{0 if agg is not None else 1}")
        if agg is not None and label.startswith("sketch") and not (
                same_run(a, b) and same_run(a, first)):
            fail(f"e9 {label}: three runs of one seed differ in bits")
        if label in ("dense", "sketch"):
            out[f"{label} profile"] = device_window(lambda: session.run(0),
                                                    f"e9 {label}, {rounds} rounds", "3g e9")
        short = e9_session(dev, targets, agg, rounds=E9["parity_rounds"]).run(0)
        nbytes = 4 * session.algorithm.comm_floats(d)
        out[label] = dict(rounds_per_s=rounds / min(ta, tb), bytes_per_round=nbytes,
                          bytes_reduction=dense_bytes / nbytes, launches_per_round=launches,
                          peak_gb=peak, loss_4=e9_mean_loss(short.last_w, targets))
    profiles = {k: out.pop(k) for k in ("dense profile", "sketch profile")}
    dense_dec = l0 - out["dense"]["loss_4"]
    for label, row in out.items():
        row["decrease_vs_dense"] = (l0 - row["loss_4"]) / dense_dec
        print(f"[3g e9] {label}: {row['rounds_per_s']:.2f} rounds/s (host clock, card "
              f"synchronised; M={m} d={d}, {rounds} rounds), {row['bytes_per_round']} modeled "
              f"bytes a round ({row['bytes_reduction']:.2f}x fewer than dense), "
              f"{row['launches_per_round']:g} dp_aggregate launches a round, peak "
              f"{row['peak_gb']:.3f} GB, loss decrease over {E9['parity_rounds']} rounds "
              f"{row['decrease_vs_dense']:+.4f}x dense (informational)  [{smi}]")
    ratio = out["rand-k"]["rounds_per_s"] / out["dense"]["rounds_per_s"]
    print(f"[3g e9] {'OK ' if ratio >= 2.0 else 'WARN'} rand-k k=d/{E9['k_div']}: {ratio:.2f}x "
          f"dense rounds/s (e9's floor 2x, not held here), "
          f"{out['rand-k']['bytes_reduction']:.1f}x fewer bytes (floor 10x)")

    variants = e9_variants()
    dense = e9_session(dev, targets, None, name="fedexp").run(0)
    lossless = e9_session(dev, targets, variants["lossless rand-k"], name="fedexp").run(0)
    check_run("e9 fedexp lossless rand-k", lossless, rounds)
    lossless_err = close(lossless.final_w, dense.final_w, "e9 fedexp: lossless rand-k vs dense w")
    close(lossless.eta_history, dense.eta_history, "e9 fedexp: lossless rand-k vs dense eta_g")
    stream = dict(engine=EngineSpec(engine="stream"), stream=StreamSpec(E9["stream_chunk"]))
    sampled = dict(cohort=dict(q=0.1))
    gathered = dict(cohort=dict(q=0.1, gather=True))
    retaken = {}
    for label in ("rand-k", "sketch", "sketch top-k ef"):
        retaken[label] = dict(
            stream=e9_retaken(f"{label} streamed at chunk {E9['stream_chunk']}", dev, targets,
                              variants[label], {}, stream),
            gathered=e9_retaken(f"{label} gathered at q=0.1", dev, targets, variants[label],
                                sampled, gathered))
    ef = variants["sketch top-k ef"]
    want = e9_session(dev, targets, ef).run(0)
    with tempfile.TemporaryDirectory() as tmp:
        e9_session(dev, targets, ef, rounds=5).run(0, checkpoint_dir=os.path.join(tmp, "ef"))
        if not same_run(e9_session(dev, targets, ef).resume(os.path.join(tmp, "ef")), want):
            fail("e9 sketch top-k ef: the run resumed from round 5 differs from the "
                 "uninterrupted run")
    print(f"[3g e9] held: fedexp lossless rand-k = dense (max abs err of w {lossless_err:.3e}); "
          "the sketch and the EF sketch three runs equal in bits; each round of rand-k, the "
          f"sketch and the EF sketch streamed at chunk {E9['stream_chunk']} = eager, and "
          "gathered at q=0.1 = dense sampled, at RTOL (max abs err of w: "
          + ", ".join(f"{k} {v['stream']:.2e} / {v['gathered']:.2e}" for k, v in retaken.items())
          + "); the EF sketch resumed from round 5 = uninterrupted in bits; 0 dp_aggregate "
          "launches a compressed round")
    sums = e9_sums(dev, targets, smi)
    del targets
    torch.cuda.empty_cache()
    return dict(variants=out, randk_vs_dense=ratio, lossless_max_abs_err=lossless_err,
                retaken=retaken, profiles=profiles, sums=sums)


FAULT = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.02)
# phase 3c's runs on the paper workload: (label, d, cohort)
FAULTED = (("ldp-fedexp-gauss", 100, None), ("cdp-fedexp", 500, None),
           ("dp-scaffold-ldp", 100, None), ("ldp-fedexp-gauss", 100, SAMPLED["q=0.1 gathered"]))
RESULT_FIELDS = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
                 "eta_target_history")


def same_run(a, b) -> bool:
    """Two RunResults equal in bits (NaN where both are NaN), fault round too."""
    return a.fault_round == b.fault_round and all(
        same_bits(getattr(a, f), getattr(b, f)) for f in RESULT_FIELDS)


def phase_faults(dev):
    """Phase 3c: the paper workload under FAULT for FAULTED.  Held: finite
    results and eta_g >= 1 for FedEXP (``check_run``), the name's
    dp_aggregate launches a round, every one gated, two runs of one seed
    equal in bits, a faulted run that differs from the clean one, and
    dropout 0.99 finite.  Printed: ||w - w*|| beside the clean run's."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops
    m, tau, rounds = PAPER
    count = ops.dp_aggregate_sums
    for name, d, cohort in FAULTED:
        label = name + ("" if cohort is None else " q=0.1 gathered")
        before = (count.launches, count.gated_launches)
        t0 = time.perf_counter()
        session, r, data = run_session(name, m, d, rounds, tau, dev, cohort=cohort, fault=FAULT)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched, gated = count.launches - before[0], count.gated_launches - before[1]
        check_run(label, r, rounds)
        want = (rounds + warmup_rounds(session)) * launches_per_round(name)[0]
        if launched != want or gated != want:
            fail(f"{label} under faults: {launched} dp_aggregate launches, {gated} gated, in "
                 f"{rounds} rounds (want {want} and {want})")
        _, again, _ = run_session(name, m, d, rounds, tau, dev, data=data, cohort=cohort,
                                  fault=FAULT)
        if not same_run(again, r):
            fail(f"{label} under faults: two runs of seed 0 differ")
        _, clean, _ = run_session(name, m, d, rounds, tau, dev, data=data, cohort=cohort)
        if same_bits(clean.final_w, r.final_w):
            fail(f"{label}: the faulted run equals the clean one")
        _, empty, _ = run_session(name, m, d, rounds, tau, dev, data=data, cohort=cohort,
                                  fault=dict(dropout=0.99))
        check_run(f"{label} dropout 0.99", empty, rounds)
        dist, dist_clean = (float(data.w_star.sub(x.final_w).norm()) for x in (r, clean))
        print(f"[3c faults] {label:32s} d={d}: final ||w - w*|| = {dist:.4f} under faults, "
              f"{dist_clean:.4f} clean; eta_g in [{r.eta_history.min().item():.3f}, "
              f"{r.eta_history.max().item():.3f}]; {launched} dp_aggregate launches, all "
              f"gated; two runs equal in bits; dropout 0.99 finite; {secs:.2f} s")


def _poison(carry, attempt):
    """Attempt 0 runs from a model with an Inf coordinate, later ones clean."""
    if attempt > 0:
        return carry
    w = carry[0].clone()
    w[0] = float("inf")
    return (w,) + tuple(carry[1:])


def phase_checkpoints(dev):
    """Phase 3d: checkpoints on the card, in a temp dir, for
    ldp-fedexp-gauss under FAULT on the paper workload.  Held: a run saved
    every 10 rounds and resumed from round 20 equals the uninterrupted run
    in bits, and so does one resumed past a truncated newest checkpoint;
    with the watchdog armed, a divergence planted in attempt 0 and rolled
    back by RecoveryPolicy equals the unkilled run in bits; a divergence
    planted in every attempt exhausts the retries and surfaces fault_round."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.fedsim import RecoveryPolicy
    m, tau, rounds = PAPER
    name, d = "ldp-fedexp-gauss", 100
    with tempfile.TemporaryDirectory() as tmp:
        session, data = make_session(name, m, d, rounds, tau, dev, fault=FAULT)
        want = session.run(0)
        every = os.path.join(tmp, "every")
        t0 = time.perf_counter()
        if not same_run(session.run(0, checkpoint_dir=every, checkpoint_every=10), want):
            fail("a run that saves checkpoints differs from the run that does not")
        secs = time.perf_counter() - t0
        if ckpt.checkpoint_steps(every) != [10, 20, 30, 40, 50]:
            fail(f"checkpoints at {ckpt.checkpoint_steps(every)}, want every 10 rounds")
        trunc = os.path.join(tmp, "trunc")
        os.makedirs(trunc)
        for step in (10, 20, 30, 40, 50):
            for ext in (".npz", ".json"):
                f = f"ckpt_{step:08d}{ext}"
                shutil.copyfile(os.path.join(every, f), os.path.join(trunc, f))
                if step > 20:
                    os.remove(os.path.join(every, f))
        if not same_run(make_session(name, m, d, rounds, tau, dev, data=data,
                                     fault=FAULT)[0].resume(every), want):
            fail("the run resumed from round 20 differs from the uninterrupted run")
        with open(os.path.join(trunc, "ckpt_00000050.npz"), "r+b") as f:
            f.truncate(64)
        if not same_run(make_session(name, m, d, rounds, tau, dev, data=data,
                                     fault=FAULT)[0].resume(trunc), want):
            fail("the run resumed past a truncated newest checkpoint differs")
        watch = {**FAULT, "watchdog": True}
        unkilled = make_session(name, m, d, rounds, tau, dev, data=data, fault=watch)[0].run(0)
        if not same_run(unkilled, want):
            fail("the watchdog changed a healthy run")
        rec, _ = make_session(name, m, d, rounds, tau, dev, data=data, fault=watch)
        rec._inject_divergence = _poison
        got = rec.run(0, checkpoint_dir=os.path.join(tmp, "rec"), checkpoint_every=10,
                      on_divergence=RecoveryPolicy(max_retries=2))
        if not same_run(got, unkilled) or rec._rounds_retried != 1:
            fail(f"the recovered run differs from the unkilled one (retried "
                 f"{rec._rounds_retried} rounds, fault_round {got.fault_round})")
        dead, _ = make_session(name, m, d, rounds, tau, dev, data=data, fault=watch)
        dead._inject_divergence = lambda carry, attempt: _poison(carry, 0)
        out = dead.run(0, checkpoint_dir=os.path.join(tmp, "dead"), checkpoint_every=10,
                       on_divergence=RecoveryPolicy(max_retries=2))
        if out.fault_round != 0 or dead._rounds_retried != 2:
            fail(f"retry exhaustion: fault_round {out.fault_round}, retried "
                 f"{dead._rounds_retried} rounds (want 0 and 2)")
    print(f"[3d checkpoints] {name} under faults, d={d}: saved every 10 rounds ({secs:.2f} s "
          "for the 50 rounds), resumed from round 20 and past a truncated newest checkpoint: "
          "equal to the uninterrupted run in bits; a divergence planted in attempt 0 rolled "
          "back to round 0: equal to the unkilled run in bits (1 round retried); planted in "
          "every attempt: fault_round 0 after 2 retries")


def syncs_of(fn) -> list[str]:
    """The synchronizing CUDA operations ``fn`` makes, as PyTorch's sync
    debug mode reports them: the file and line of each.  The mode's own
    notice that it is a prototype (torch/cuda/__init__.py, the first time
    it is switched on in a process) is not one: it was the "one sync" of
    the first round this counted."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{Path(w.filename).name}:{w.lineno}" for w in seen
            if "called a synchronizing" in str(w.message)]


PAPER = (1000, 20, 50)                 # M, tau, rounds; d 500 or 100 by name
# phase 3's 19 labels x 4-5 runs (and the gathered retakes) run the paper's
# 50 rounds: on the scan engine (PR 31) they fit the script's time limit again
PAPER_RUN_ROUNDS = PAPER[2]
FULL_SIZE = (1000, 131072, 20, 5)      # M, d, tau, rounds
FULL = (("ldp-fedexp-gauss", "fused", None, None), ("cdp-fedexp", "none", None, None),
        ("ldp-fedexp-privunit", None, None, None), ("cdp-fedexp-adaptive-clip", "none", None, None),
        ("ldp-fedexp-gauss", "fused", SAMPLED["q=0.1 gathered"], None),
        ("cdp-fedexp", "none", SAMPLED["size=100"], None),
        ("ldp-fedexp-perclient", None, None, None),
        ("dp-scaffold-ldp", "fused", None, None), ("dp-scaffold-cdp", "none", None, None),
        ("dp-scaffold-ldp", "fused", SAMPLED["q=0.1 gathered"], None),
        ("ldp-fedexp-gauss", "fused", None, FAULT))
# a sampled round may sync no more than its name's full round; a dp-scaffold
# round (two releases, the variate table) no more than ldp-fedexp-gauss's; a
# faulted round (no watchdog) no more than its clean one
SYNC_BASE = {"ldp-fedexp-gauss q=0.1 gathered": "ldp-fedexp-gauss",
             "cdp-fedexp size=100": "cdp-fedexp",
             "cdp-fedexp-adaptive-clip": "cdp-fedexp",
             "dp-scaffold-ldp": "ldp-fedexp-gauss", "dp-scaffold-cdp": "ldp-fedexp-gauss",
             "dp-scaffold-ldp q=0.1 gathered": "ldp-fedexp-gauss",
             "ldp-fedexp-gauss faults": "ldp-fedexp-gauss"}


def staged_round(alg, local_fn, w, state, noise, mask, cohort, t, batches, eta_l):
    """One masked round on the host draws ``noise`` and ``mask``, staged as
    the engines stage them (``stage_noise``, ``stage_inputs``) and run by
    ``masked_round``: ``(w_next, aux, state)``."""
    from repro_torch.fedsim.server import masked_round, stage_inputs
    inp = stage_inputs(alg, local_fn, alg.stage_noise(noise, w.device, t), t, mask.shape[0],
                       w.device, cohort=cohort, mask=mask)
    return masked_round(alg, local_fn, w, state, inp, cohort, t, batches, eta_l)


def split_round(session, w, state, t, cohort, fault=None):
    """One more round of ``session``'s algorithm at ``w`` as the engines run
    it (``round_stage``, then ``round_body``), timed in three parts: the host
    stage (host clock: the draws, PrivUnit's float64 quantiles, the copies
    queued), then between CUDA events local training (of the gathered block
    under a gathering cohort; with the stragglers' cutoffs under ``fault``)
    and the rest of the body: (stage ms, local ms, server ms)."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import CohortSpec, FaultSpec, gather_rows
    from repro_torch.fedsim.server import local_caller, round_body, round_stage
    alg, batches, eta_l = session.algorithm, session.client_batches, session.train.eta_l
    tau = session.train.tau
    spec = None if cohort is None else CohortSpec(**cohort)
    fspec = None if fault is None else FaultSpec(**fault)
    stage = round_stage(alg, session._local_fn, spec, fspec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inp = stage(round_generator(1, t), t, session.num_clients, session.dim, w.device)
    stage_ms = 1e3 * (time.perf_counter() - t0)
    block, start = batches, 0
    if inp.slots is not None:
        block, start = gather_rows(batches, inp.slots), inp.slots
    straggler = None if inp.faults is None else inp.faults[1]
    local = local_caller(session._local_fn, alg, fspec, tau)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    deltas = local(w, block, eta_l, start, state, straggler, inp.shuffle_key)
    ev[1].record()
    round_body(alg, lambda *_, **__: deltas, None, 1, spec, fspec, tau)(
        w, state, inp, t, batches, eta_l)
    ev[2].record()
    torch.cuda.synchronize()
    return stage_ms, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def checkpoint_ms(session, result, rounds) -> tuple[float, float]:
    """Host ms of one save and one load of the checkpoint of ``result`` (its
    last model, the server state, a two-iterate tail and the histories), in
    a temp dir; the loaded model must equal the saved one in bits."""
    import tempfile

    import torch
    w = result.last_w
    carry = (w, session.algorithm.init_state(w), [w, result.final_w])
    hist = tuple(getattr(result, f) for f in RESULT_FIELDS[2:])
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session._save(tmp, rounds, 0, carry, hist)
        t1 = time.perf_counter()
        step, _, back, _ = session._load(tmp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    if step != rounds or not same_bits(back[0], w) or back[0].device != w.device:
        fail("the full-size checkpoint did not load back to the card in bits")
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def phase_full(dev, cases) -> dict:
    """Phase 4: full-size rounds, timed, with the local/server split of one
    round, peak memory and the synchronizing CUDA operations of a round (an
    adaptive-clip round may make no more than cdp-fedexp's, a sampled round
    no more than its name's full round); PrivUnit's release time."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.data.synthetic import linreg_loss
    from repro_torch.fedsim import CohortSpec, FaultSpec, cohort_updates
    from repro_torch.fedsim.server import round_step
    m, d, tau, rounds = FULL_SIZE
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    kernel_ms = {c["mode"]: c["ms"] for c in cases if c["shape"] == [m, d]}
    data, out = None, {}
    for name, mode, cohort, fault in FULL:
        label = name if cohort is None else name + " " + next(
            k for k, v in SAMPLED.items() if v == cohort)
        label += "" if fault is None else " faults"
        run_session(name, m, d, 1, tau, dev, data=data, cohort=cohort, fault=fault,
                    engine=eager_spec())  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session, r, data = run_session(name, m, d, rounds, tau, dev, data=data, cohort=cohort,
                                       fault=fault, engine=eager_spec())
        torch.cuda.synchronize()
        per_round = 1e3 * (time.perf_counter() - t0) / rounds
        check_run(name, r, rounds)
        t0 = time.perf_counter()      # the same run again without building the session
        session.run(0)
        torch.cuda.synchronize()
        run_only = 1e3 * (time.perf_counter() - t0) / rounds
        alg, w = session.algorithm, r.last_w
        state = alg.init_state(w)
        torch.cuda.reset_peak_memory_stats()
        stage_ms, local_ms, server_ms = split_round(session, w, state, rounds, cohort, fault)
        row = dict(ms_per_round=per_round, run_ms_per_round=run_only, stage_ms=stage_ms,
                   local_ms=local_ms, server_ms=server_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, cohort=cohort)
        step = round_step(alg, session._local_fn, session.eval_fn, cohort=None if cohort is None
                          else CohortSpec(**cohort),
                          fault=None if fault is None else FaultSpec(**fault), tau=tau)
        syncs = syncs_of(lambda: step(w, state, round_generator(2, 0), 0,
                                      session.client_batches, session.train.eta_l))
        row["syncs"], row["sync_at"] = len(syncs), syncs
        kern = (f"{launches_per_round(name)[0]} dp_aggregate {mode} launch(es) a round"
                f"{', gated' if cohort or fault else ''}, kernel "
                f"{kernel_ms[mode]:.4f} ms/launch ungated" if mode
                else "no dp_aggregate launch (plain PyTorch"
                + (", the noise-only kernel)" if "perclient" in name else ")"))
        print(f"[4 full] {label} M={m} d={d} tau={tau}: {per_round:.3f} ms/round "
              f"({run_only:.3f} without building the session; host stage "
              f"{row['stage_ms']:.3f} ms (host clock), local training "
              f"{row['local_ms']:.3f} ms, server release+step {row['server_ms']:.3f} ms); "
              f"{kern} (CUDA events); peak "
              f"{row['peak_gb']:.2f} GB; {row['syncs']} synchronizing CUDA operations in a "
              f"round (sync debug mode){' at ' + ', '.join(syncs) if syncs else ''}  [{smi}]")
        if fault is not None:
            row["save_ms"], row["load_ms"] = checkpoint_ms(session, r, rounds)
            print(f"[4 full] {label}: under FaultSpec({FAULT}); one checkpoint of the run "
                  f"(model, tail, histories) saved in {row['save_ms']:.3f} ms and loaded to "
                  f"the card in {row['load_ms']:.3f} ms (host clock)  [{smi}]")
        if "privunit" in name:
            deltas = cohort_updates(linreg_loss, w, session.client_batches, tau,
                                    session.train.eta_l)
            drawn = alg.draw_noise(round_generator(3, 0), m, d, dev)
            torch.cuda.synchronize()
            q0 = time.perf_counter()
            noise = alg.stage_noise(drawn, dev)
            torch.cuda.synchronize()
            stage_noise_ms = 1e3 * (time.perf_counter() - q0)
            alg.mechanism.release(noise, deltas)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            release_ms = cuda_ms(lambda: alg.mechanism.release(noise, deltas), 5, warmup=0)
            host_ms = 1e3 * (time.perf_counter() - t0) / 5
            q0 = time.perf_counter()
            alg.mechanism.stage(drawn)
            row.update(release_ms=release_ms, release_wall_ms=host_ms,
                       quantile_ms=1e3 * (time.perf_counter() - q0),
                       stage_noise_ms=stage_noise_ms)
            print(f"[4 full] {name}: PrivUnit release (clip, randomize, reduce, Algorithm 4, "
                  f"on the staged quantiles) {release_ms:.3f} ms (CUDA events), {host_ms:.3f} "
                  f"ms wall; the stage before it: the host's float64 quantiles "
                  f"{row['quantile_ms']:.3f} ms, the noise staged with its copies "
                  f"{stage_noise_ms:.3f} ms (host clock)  [{smi}]")
        out[label] = row
    for label, base in SYNC_BASE.items():
        if out[label]["syncs"] > out[base]["syncs"]:
            fail(f"a {label} round syncs {out[label]['syncs']} times, {base}'s "
                 f"{out[base]['syncs']}")
    # the rounds (stage and body) read nothing from the card: the scan engine
    # replays the body from a graph
    synced = {k: v["sync_at"] for k, v in out.items() if v["syncs"]}
    if synced:
        fail(f"rounds that synchronise with the card: {synced}")
    torch.cuda.empty_cache()
    return out


# phase 4's e2 rounds: (label, setting, LocalSpec kwargs or None for full-batch GD)
E2_FULL = (("e2 cdp-fedexp", "cdp", None), ("e2 ldp-fedexp-gauss", "ldp-gauss", None),
           ("e2 cdp-fedexp minibatch", "cdp", E2_LOCAL),
           ("e2 ldp-fedexp-gauss minibatch", "ldp-gauss", E2_LOCAL))


def phase_e2_rounds(dev, smi: str) -> dict:
    """Phase 4's e2 rounds: DP-FedEXP on the CDP CNN (d = 5046, none mode)
    and the LDP CNN (d = 237, fused mode) at M = 1000, tau = 10, full-batch
    GD and LocalSpec(E2_LOCAL), 5 rounds: ms a round, its split (local
    training against release + step, CUDA events), peak memory and the
    synchronizing CUDA operations of a round."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim.server import round_step
    m, tau, _ = E2
    rounds = 5
    images, out = e2_images(dev), {}
    for label, setting, local in E2_FULL:
        model, batches = e2_problem(setting, 0, images, dev)
        e2_session(setting, "fedexp", model, batches, images, dev, local=local,
                   rounds=1, engine=eager_spec()).run(0)   # warm-up
        session = e2_session(setting, "fedexp", model, batches, images, dev, local=local,
                             rounds=rounds, engine=eager_spec())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = session.run(0)
        torch.cuda.synchronize()
        per_round = 1e3 * (time.perf_counter() - t0) / rounds
        check_run("cdp-fedexp", r, rounds)
        alg, w = session.algorithm, r.last_w
        state = alg.init_state(w)
        torch.cuda.reset_peak_memory_stats()
        stage_ms, local_ms, server_ms = split_round(session, w, state, rounds, None)
        step = round_step(alg, session._local_fn, session.eval_fn)
        syncs = syncs_of(lambda: step(w, state, round_generator(2, 0), 0,
                                      session.client_batches, session.train.eta_l))
        out[label] = dict(ms_per_round=per_round, stage_ms=stage_ms, local_ms=local_ms,
                          server_ms=server_ms,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9, syncs=len(syncs),
                          sync_at=syncs, d=model.dim, local=local)
        print(f"[4 full] {label} M={m} d={model.dim} tau={tau}"
              f"{'' if local is None else ' LocalSpec' + str(local)}: {per_round:.3f} ms/round "
              f"(host stage {stage_ms:.3f} ms, host clock; local training {local_ms:.3f} ms, "
              f"server release+step {server_ms:.3f} ms, CUDA events; the round's eval "
              f"besides); peak "
              f"{out[label]['peak_gb']:.2f} GB; {len(syncs)} synchronizing CUDA operations in a "
              f"round (sync debug mode){' at ' + ', '.join(syncs) if syncs else ''}  [{smi}]")
    return out


# phase 4b (the scan engine): the sampled and faulted pairs on the paper
# workload (label, d, CohortSpec kwargs, FaultSpec kwargs); the faulted runs
# arm a watchdog that FedEXP's extrapolation trips (eta_g above 1.05)
SCAN_TRIP = dict(FAULT, watchdog=True, eta_max=1.05)
SCAN_PAIRS = (("cdp-fedexp", 500, SAMPLED["q=0.1 gathered"], None),
              ("ldp-fedexp-gauss", 100, SAMPLED["q=0.1 gathered"], None),
              ("cdp-fedexp", 500, None, SCAN_TRIP), ("ldp-fedexp-gauss", 100, None, SCAN_TRIP))
SCAN_FULL = ("ldp-fedexp-gauss", "cdp-fedexp", "ldp-fedexp-privunit")
SCAN_TIMED = ("ldp-fedexp-gauss", "cdp-fedexp", "ldp-fedexp-privunit")
SCAN_GRAPH_RTOL = 1e-6   # a case that is not bit-equal may differ by this much, and is named


def scan_engine_spec():
    """The phase's engine: scan, two chunks of 25 rounds, two rounds a graph."""
    from repro_torch.fedsim import EngineSpec
    return EngineSpec("scan", chunk_rounds=25)


def eager_spec():
    """The eager loop, named where a phase times or holds it (the default
    engine is scan)."""
    from repro_torch.fedsim import EngineSpec
    return EngineSpec(engine="eager")


def scan_pair(label, name, m, d, rounds, tau, dev, *, data=None, **kw):
    """The same run under the eager and the scan engine, held equal in bits
    (``same_run``); a pair that is not is held at SCAN_GRAPH_RTOL and named.
    Returns (eager session, scan session, eager result, scan result, data, gap)."""
    import torch
    se, data = make_session(name, m, d, rounds, tau, dev, data=data, engine=eager_spec(), **kw)
    ss, _ = make_session(name, m, d, rounds, tau, dev, data=data, engine=scan_engine_spec(), **kw)
    a, b = se.run(0), ss.run(0)
    gap = 0.0
    if not same_run(a, b):
        if a.fault_round != b.fault_round:
            fail(f"[4b scan] {label}: watchdog round {b.fault_round} under scan, "
                 f"{a.fault_round} eager")
        for f in RESULT_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            both = torch.isnan(x) & torch.isnan(y)
            if bool((torch.isnan(x) ^ torch.isnan(y)).any()):
                fail(f"[4b scan] {label}: {f} NaN pattern differs between the engines")
            scale = float(torch.where(both, 0.0, x).abs().max()) or 1.0
            gap = max(gap, float(torch.where(both, 0.0, (x - y).abs()).max()) / scale)
        print(f"[4b scan] {label}: NOT equal in bits to eager: max gap {gap:.3e} of the "
              f"largest entry (held at {SCAN_GRAPH_RTOL})")
        if gap > SCAN_GRAPH_RTOL:
            fail(f"[4b scan] {label}: scan differs from eager by {gap:.3e}")
    return se, ss, a, b, data, gap


# the dp_aggregate kernels' symbols in a profiler trace, beside the wrapper
# whose launch counter counts them (``fedsim.scan.launch_counts`` keys)
TRACED_KERNELS = (("aggregate_kernel", (0, "launches")), ("noise_kernel", (1, "launches")))


def engine_window(session, label) -> dict:
    """ms per round on the host clock and the profiled idle share of a
    second run of ``session`` (its first run built and captured).  The
    profiled run's kernels are counted in the trace and held equal to what
    the wrappers' launch counters added in that run: under the scan engine
    those counts are inferred (captured launches times replays), and the
    trace shows whether each replay launched them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fedsim.scan import launch_counts
    rounds = session.train.rounds
    _, secs = timed_run(session)
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.run(0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    after = launch_counts()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    idle = max(0.0, 1 - busy / wall) if busy > 0 else None
    launches = {}
    for symbol, counter in TRACED_KERNELS:
        traced = sum(e.count for e in events if symbol in e.key)
        counted = after[counter] - before[counter]
        if traced != counted:
            fail(f"[4b scan] {label}: the trace shows {traced} {symbol} launches in a run whose "
                 f"launch counter added {counted}")
        launches[symbol] = traced
    return dict(ms_per_round=1e3 * secs / rounds, profiled_wall_ms=wall, busy_ms=busy,
                idle_share=idle, traced_launches=launches)


def pointer_launch_checks(dev, smi) -> dict:
    """Both kernels launched with their seed and sigma in device memory
    against the by-value launches at (1000, 131072): equal in bits (fused,
    gated with row ids, the noise-only kernel, row ids too), and timed."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops
    m, d = 1000, 131072
    seed, sigma = 2024, 0.21
    g = torch.Generator(device=dev).manual_seed(11)
    u = torch.randn(m, d, device=dev, generator=g) * 0.01
    st = torch.tensor(seed, dtype=torch.int64, device=dev)
    sg = torch.tensor(sigma, dtype=torch.float32, device=dev)
    cap = 176
    ids = torch.randperm(m, generator=torch.Generator().manual_seed(3))[:cap].sort().values
    ids = ids.to(dev, torch.int32)
    rows = u[:cap]
    gate = (torch.arange(cap, device=dev) % 7 != 0).to(torch.float32)
    out = {}
    with uncounted():
        cases = {
            "fused": (lambda: ops.dp_aggregate_sums(u, 1.0, noise_seed=seed, noise_sigma=sigma),
                      lambda: ops.dp_aggregate_sums(u, 1.0, noise_seed=st, noise_sigma=sg)),
            "fused gated row_ids (176 rows)": (
                lambda: ops.dp_aggregate_sums(rows, 1.0, noise_seed=seed, noise_sigma=sigma,
                                              row_gate=gate, row_ids=ids),
                lambda: ops.dp_aggregate_sums(rows, 1.0, noise_seed=st, noise_sigma=sg,
                                              row_gate=gate, row_ids=ids)),
            "noise-only": (lambda: ops.generate_ldp_noise(m, d, seed, sigma, device=dev),
                           lambda: ops.generate_ldp_noise(m, d, st, sg, device=dev)),
            "noise-only row_ids (176 rows)": (
                lambda: ops.generate_ldp_noise(cap, d, seed, sigma, device=dev, row_ids=ids),
                lambda: ops.generate_ldp_noise(cap, d, st, sg, device=dev, row_ids=ids)),
        }
        for label, (by_value, by_pointer) in cases.items():
            a, b = by_value(), by_pointer()
            a = a if isinstance(a, torch.Tensor) else torch.cat([a[0], a[1][None], a[2][None]])
            b = b if isinstance(b, torch.Tensor) else torch.cat([b[0], b[1][None], b[2][None]])
            if not torch.equal(a, b):
                fail(f"[4b scan] {label}: the device-pointer seed and sigma launch differs from "
                     f"the by-value launch")
            value_ms, pointer_ms = cuda_ms(by_value, 10), cuda_ms(by_pointer, 10)
            value_ms2 = cuda_ms(by_value, 10)
            out[label] = dict(value_ms=min(value_ms, value_ms2), pointer_ms=pointer_ms)
            print(f"[4b scan] {label} (1000, 131072): device-pointer seed and sigma = by-value in "
                  f"bits; {pointer_ms:.4f} ms against {min(value_ms, value_ms2):.4f} ms by "
                  f"value (CUDA events, 10 calls)  [{smi}]")
    return out


def quickstart_stream(smi) -> dict:
    """``examples/quickstart_torch.py --quick --telemetry --schedule`` on the
    card in a process of its own, its three streams validated by
    ``tools/check_telemetry.py`` (8 rounds; the schedule's sigma against
    sigma0 0.9**t)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "q.jsonl"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
                               "--quick", "--telemetry", str(path), "--schedule"],
                              capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"[4b scan] quickstart_torch.py --quick exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        print(proc.stdout.strip())
        checker = str(ROOT / "tools" / "check_telemetry.py")
        sigma0 = 5 * 0.3 / math.sqrt(120)
        checks = [[checker, "--rounds", "8", str(Path(tmp) / f"q-{n}.jsonl")]
                  for n in ("dp-fedavg-cdp", "cdp-fedexp")]
        checks.append([checker, "--rounds", "8", "--sigma0", repr(sigma0), "--sigma-decay", "0.9",
                       str(Path(tmp) / "q-cdp-fedexp-schedule.jsonl")])
        for cmd in checks:
            r = subprocess.run([sys.executable] + cmd, capture_output=True, text=True)
            if r.returncode != 0:
                fail(f"[4b scan] check_telemetry rejected {cmd[-1]}: {r.stdout[-1500:]}")
        print(f"[4b scan] quickstart_torch.py --quick --telemetry --schedule on the card in "
              f"{secs:.1f} s (its process); 3 streams validated by tools/check_telemetry.py  "
              f"[{smi}]")
    return dict(seconds=secs)


def phase_scan(dev, smi) -> dict:
    """Phase 4b: the scan engine.  All 18 labels at the paper size under the
    eager and the scan engine, equal in bits (final_w, last_w, the four
    histories, the watchdog round); q = 0.1 gathered and a faulted run whose
    watchdog trips, on cdp-fedexp and ldp-fedexp-gauss; ldp-fedexp-gauss,
    cdp-fedexp and ldp-fedexp-privunit at full size; the kernels' device-
    pointer launches against the by-value ones; a tracked run against an
    untracked one, its stream validated; the quickstart's stream; ms per
    round and the profiled idle share under both engines."""
    import tempfile

    import torch
    from repro_torch.kernels.dp_aggregate import ops
    from repro_torch.telemetry import JsonlTracker
    m, tau, rounds = PAPER
    out = {"gaps": {}}
    captures = replays = 0
    n0 = ops.dp_aggregate_sums.launches
    data = {}
    for name in NAMES:
        d = 100 if "ldp" in name or "privunit" in name else 500
        se, ss, a, b, data[d], gap = scan_pair(name, name, m, d, rounds, tau, dev,
                                               data=data.get(d))
        out["gaps"][name] = gap
        eng = ss._scan
        captures, replays = captures + eng.captures, replays + eng.replays
        if name in SCAN_TIMED:
            out[name] = {"eager": engine_window(se, name), "scan": engine_window(ss, name)}
            e, s_ = out[name]["eager"], out[name]["scan"]
            idle = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
            print(f"[4b scan] {name} M={m} d={d} tau={tau}, {rounds} rounds: eager "
                  f"{e['ms_per_round']:.3f} ms/round (idle share {idle(e['idle_share'])}), scan "
                  f"{s_['ms_per_round']:.3f} ms/round (idle share {idle(s_['idle_share'])}), "
                  f"host clock, card synchronised; kernels in the profiled runs' traces = the "
                  f"launch counters (eager {e['traced_launches']}, scan replays "
                  f"{s_['traced_launches']})  [{smi}]")
    print(f"[4b scan] 18 labels at M={m}, {rounds} rounds: scan = eager in bits "
          f"({sum(g > 0 for g in out['gaps'].values())} held at {SCAN_GRAPH_RTOL} instead); "
          f"{captures} graphs captured, {replays} replays")
    for name, d, cohort, fault in SCAN_PAIRS:
        label = f"{name} {'q=0.1 gathered' if cohort else 'faulted, watchdog at eta_g 1.05'}"
        _, ss, a, b, _, gap = scan_pair(label, name, m, d, rounds, tau, dev, data=data[d],
                                        cohort=cohort, fault=fault)
        out["gaps"][label] = gap
        print(f"[4b scan] {label}: scan = eager (fault round {b.fault_round})")
        if fault is not None:
            out.setdefault("trips", []).append(b.fault_round)
    if all(t is None for t in out["trips"]):
        fail("[4b scan] the planted watchdog tripped in no faulted run")
    mf, df, tf, rf = FULL_SIZE
    full = None
    for name in SCAN_FULL:
        se, ss, a, b, full, gap = scan_pair(f"{name} full", name, mf, df, rf, tf, dev, data=full)
        out["gaps"][f"{name} full"] = gap
        _, secs_e = timed_run(se)
        _, secs_s = timed_run(ss)
        out[f"{name} full"] = dict(eager_ms=1e3 * secs_e / rf, scan_ms=1e3 * secs_s / rf)
        print(f"[4b scan] {name} M={mf} d={df} tau={tf}, {rf} rounds: scan = eager; "
              f"{1e3 * secs_e / rf:.3f} ms/round eager, {1e3 * secs_s / rf:.3f} scan (host clock)"
              f"  [{smi}]")
    del full
    torch.cuda.empty_cache()
    # launches a round under replay: one dp_aggregate launch a cdp-fedexp round
    s_cdp, _ = make_session("cdp-fedexp", m, 500, rounds, tau, dev, data=data[500],
                            engine=scan_engine_spec())
    s_cdp.run(0)
    before = ops.dp_aggregate_sums.launches
    s_cdp.run(1)
    per_round = (ops.dp_aggregate_sums.launches - before) / rounds
    if per_round != 1:
        fail(f"[4b scan] a replayed cdp-fedexp round counts {per_round} dp_aggregate launches")
    out["launches_per_round_replayed"] = per_round
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "scan.jsonl")
        tracked = s_cdp.run(0, tracker=JsonlTracker(path))
        if not same_run(tracked, s_cdp.run(0)):
            fail("[4b scan] a tracked scan run differs from the untracked one")
        r = subprocess.run([sys.executable, str(ROOT / "tools" / "check_telemetry.py"),
                            "--rounds", str(rounds), "--require-bytes", path],
                           capture_output=True, text=True)
        if r.returncode != 0:
            fail(f"[4b scan] check_telemetry rejected the scan stream: {r.stdout[-1500:]}")
    print(f"[4b scan] cdp-fedexp under scan: {per_round:g} dp_aggregate launch a replayed "
          f"round; a tracked run = the untracked one in bits, its stream validated")
    out["pointer"] = pointer_launch_checks(dev, smi)
    out["quickstart"] = quickstart_stream(smi)
    out["scan_launches"] = ops.dp_aggregate_sums.launches - n0
    return out


# phase 4c (client sharding): the full cell under a one-rank NCCL client mesh
# (label, registry name, CohortSpec kwargs), and e9's compressed variants
# whose scan runs are held to the eager loop
SHARD_FULL = (("ldp-fedexp-gauss", "ldp-fedexp-gauss", None),
              ("cdp-fedexp", "cdp-fedexp", None),
              ("ldp-fedexp-privunit", "ldp-fedexp-privunit", None),
              ("ldp-fedexp-gauss q=0.1 gathered", "ldp-fedexp-gauss", SAMPLED["q=0.1 gathered"]))
SHARD_E9 = ("rand-k", "sketch top-k ef")


def shard_window(session, label) -> dict:
    """A second run of the sharded ``session`` (its first captured the
    graphs): ms per round (host clock, card synchronised), the dp_aggregate
    launches and all-reduces a replayed round (the counters, which the scan
    engine adds a replay), and from one profiled run the device time of the
    NCCL all-reduce's kernels and copies against the run's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.algorithm import all_reduce_moments
    from repro_torch.kernels.dp_aggregate import ops
    rounds = session.train.rounds
    n0, r0 = ops.dp_aggregate_sums.launches, all_reduce_moments.launches
    _, secs = timed_run(session)
    launches = (ops.dp_aggregate_sums.launches - n0) / rounds
    reduces = (all_reduce_moments.launches - r0) / rounds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.run(0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3
    if reduces != 1:
        fail(f"[4c shard] {label}: {reduces:g} all-reduces a replayed round, want 1")
    return dict(ms_per_round=1e3 * secs / rounds, dp_aggregate_per_round=launches,
                all_reduces_per_round=reduces, profiled_wall_ms=wall, busy_ms=busy,
                all_reduce_device_ms=nccl,
                all_reduce_share=(nccl / busy if busy > 0 else None))


def phase_shard(dev, smi) -> dict:
    """Phase 4c: client sharding on the card.  A one-rank NCCL client mesh
    (``make_client_mesh()``: a one-process group through an in-memory
    store, its sockets on the loopback device): the full cell (M = 1000, d = 131072, tau = 20, 5 rounds) under
    ``ShardSpec(mesh)`` equal in bits to the unsharded scan run for
    ldp-fedexp-gauss (fused, keyed by global row), cdp-fedexp, PrivUnit and
    ldp-fedexp-gauss gathered at q = 0.1; ms per round of both, the launches
    and all-reduces of a replayed round, the all-reduce's device share of a
    profiled run.  Then e9's shape (M = 256, d = 2^20): rand-k and the
    sketch with top-k and error feedback under scan equal in bits to the
    eager loop, with ms per round of both."""
    import torch
    import torch.distributed as dist
    from repro_torch.fedsim import ShardSpec
    from repro_torch.launch.mesh import make_client_mesh
    made = not dist.is_initialized()
    # the one-process group's bootstrap stays on the loopback device
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mesh = make_client_mesh()
    out = {"backend": str(dist.get_backend()), "ranks": dist.get_world_size()}
    try:
        if mesh.device_type != "cuda":
            fail(f"[4c shard] the client mesh is on {mesh.device_type}, not the card")
        shard = ShardSpec(mesh)
        m, d, tau, rounds = FULL_SIZE
        data = None
        for label, name, cohort in SHARD_FULL:
            plain, data = make_session(name, m, d, rounds, tau, dev, data=data, cohort=cohort)
            sharded, _ = make_session(name, m, d, rounds, tau, dev, data=data, cohort=cohort,
                                      shard=shard)
            a, b = plain.run(0), sharded.run(0)
            check_run(label, b, rounds)
            if not same_run(a, b):
                fail(f"[4c shard] {label}: the one-rank sharded run differs from the unsharded "
                     "scan run")
            row = shard_window(sharded, label)
            row["unsharded_ms_per_round"] = 1e3 * timed_run(plain)[1] / rounds
            out[label] = row
            share = ("not measured" if row["all_reduce_share"] is None
                     else f"{row['all_reduce_share']:.4f}")
            print(f"[4c shard] {label} M={m} d={d} tau={tau}, {rounds} rounds, one NCCL rank: "
                  f"sharded = unsharded scan in bits; {row['ms_per_round']:.3f} ms/round "
                  f"sharded, {row['unsharded_ms_per_round']:.3f} unsharded (host clock, card "
                  f"synchronised); a replayed round: {row['dp_aggregate_per_round']:g} "
                  f"dp_aggregate launch(es), {row['all_reduces_per_round']:g} all-reduce; the "
                  f"all-reduce's kernels {row['all_reduce_device_ms']:.4f} ms of "
                  f"{row['busy_ms']:.3f} busy in a profiled run (share {share})  [{smi}]")
        del data, plain, sharded
        torch.cuda.empty_cache()
        targets = e9_targets(dev)
        variants = e9_variants()
        for label in SHARD_E9:
            scan_s = e9_session(dev, targets, variants[label])
            eager_s = e9_session(dev, targets, variants[label], engine=eager_spec())
            a, b = scan_s.run(0), eager_s.run(0)
            check_run(f"e9 {label}", a, E9["rounds"])
            if not same_run(a, b):
                fail(f"[4c shard] e9 {label}: the scan run differs from the eager loop")
            row = {engine: 1e3 * timed_run(sess)[1] / E9["rounds"]
                   for engine, sess in (("scan_ms", scan_s), ("eager_ms", eager_s))}
            out[f"e9 {label}"] = row
            print(f"[4c shard] e9 {label} M={E9['m']} d={E9['d']}, {E9['rounds']} rounds: scan "
                  f"= eager in bits; {row['scan_ms']:.3f} ms/round scan, "
                  f"{row['eager_ms']:.3f} eager (host clock, card synchronised)  [{smi}]")
        del targets
        torch.cuda.empty_cache()
    finally:
        if made:
            dist.destroy_process_group()
    return out


def phase_reference(dev):
    """The port on the card (kernels) vs on the CPU (plain versions): the same
    seeds key the same LDP noise; the adaptive clip without noise (z_mult 0,
    sigma_b 0) is deterministic.  Tolerance 1e-4: float32 sums in other
    orders, amplified by the FedEXP ratio over five rounds."""
    m, d, tau, rounds = 40, 32, 5, 5
    for name, kw, cohort, fault in (
            ("fedexp", None, None, None), ("ldp-fedexp-gauss", None, None, None),
            ("ldp-gauss-fedadam", None, None, None), ("ldp-fedexp-schedule", None, None, None),
            ("cdp-fedexp-adaptive-clip", dict(z_mult=0.0, sigma_b=0.0), None, None),
            ("ldp-fedexp-gauss", None, dict(q=0.25, gather=True), None),
            ("ldp-fedexp-gauss", None, dict(q=0.25), None),
            ("ldp-fedexp-perclient", None, None, None),
            ("dp-scaffold-ldp", None, None, None),
            ("dp-scaffold-ldp", None, dict(q=0.25, gather=True), None),
            ("ldp-fedexp-gauss", None, None, FAULT), ("dp-scaffold-ldp", None, None, FAULT)):
        _, g, data = run_session(name, m, d, rounds, tau, dev, seed=7, kw=kw, cohort=cohort,
                                 fault=fault)
        cpu_data = type(data)(x=data.x.cpu(), y=data.y.cpu(), w_star=data.w_star.cpu())
        _, c, _ = run_session(name, m, d, rounds, tau, "cpu", seed=7, data=cpu_data, kw=kw,
                              cohort=cohort, fault=fault)
        err = close(g.final_w.cpu(), c.final_w, f"{name}: card vs CPU final w", 1e-4)
        close(g.eta_history.cpu(), c.eta_history, f"{name}: card vs CPU eta history", 1e-4)
        print(f"[5 reference] {name}{'' if kw is None else ' ' + str(kw)}"
              f"{'' if cohort is None else ' CohortSpec' + str(cohort)}"
              f"{'' if fault is None else ' FaultSpec' + str(fault)}: card vs CPU max abs "
              f"err of final w {err:.3e}")


# flash attention: float32 sums in other orders; bf16 outputs one ulp apart
# (both sides compute in float32 and round once), atol for outputs near 0.
# The float32 tensor-core kernel's 3xTF32 products keep float32's: on the CPU
# its order (f32_reference) uses at most 0.14 of it against attention_ref and
# 0.11 against the JAX kernel at Dh 64-256, TF32 products alone 61-93x it
# (tests/test_torch_flash_f32.py, -s).  The card's tensor cores do not round
# to nearest inside an instruction, so the kernel adds each tile's P.V to O in
# float32 (one accumulator over a long row drifted to 1.25x the tolerance).
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2**-7, 1e-4)}
# The tensor-core kernel is held to that bf16 tolerance against
# ref.attention_tc_ref, which rounds P to bf16 as the kernel does, plus one
# bf16 ulp of the row's largest p: the two compute p's exponent in float32 in
# other orders, so a p next to a rounding boundary may round the other way,
# which moves o by up to 2^-8 p_j |v_j| / l <= 2^-8 max|v| / l (p <= 1 against
# the row's max, l the row's denominator).  Phase 2b prints how many outputs
# at the serve shape lie beyond the bf16 tolerance alone (PERF.md).
P_FLIP = 2**-8
# ... and against attention_ref, whose P stays float32, by a bound derived from
# that rounding: a bf16 p is within 2^-9 p of the float32 p, so
# sum_j dp_j v_j / l moves o by at most 2^-9 max|v|, and the two outputs'
# roundings by at most 2^-8 |o|; the bound takes twice both.  On average the
# roundings are unbiased and independent over the keys: for v independent of
# the weights their sum has rms 2^-9/sqrt(3) of rms|o|, so mean |d o| <=
# 2^-8 mean|o| leaves 3x room (a biased P, e.g. one truncated, or a scale
# error would not).
P_MAX = (2**-8, 2**-7)   # |d o| <= P_MAX[0] * max|v| + P_MAX[1] * |o|
P_MEAN = 2**-8           # mean |d o| <= P_MEAN * mean |o|
H2O = "h2o-danube-3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 8192, 16
# kernel vs plain prefill logits at full width in bf16.  The two differ only in
# the order of float32 sums inside attention (1e-6 relative), but each one-ulp
# flip of a bf16 activation spreads through 24 layers: on the CPU at reduced
# width and full depth, two float32 attention orders give logits 1.9% of
# max|logit| apart at most and 1.3% of their spread on average
# (tests/test_torch_models.py::test_bf16_drift_...), while a wrong mask there
# (window dropped or one too wide, causal off) moves them 18% to 143%
# (test_a_planted_mask_fault_...).  Phase 6 plants the dropped window at full
# width too and fails if the bounds do not see it.  Bounds:
SERVE_MAX_ERR = 0.05    # max |d logit| / max |logit|
SERVE_MEAN_ERR = 0.03   # mean |d logit| / std(logit)
# The same in float32 (phase 9, the models' default dtype), kernel vs plain
# prefill logits: the float32 tensor-core kernel's 3xTF32 products against the
# plain path's float32 einsums.  On the CPU at d_model 512 over 24 layers the
# kernel's order moves them by 1.8e-6 of max|logit| and 1.3e-6 of their std,
# the window dropped by 1.39 and 1.10
# (tests/test_torch_models.py::test_f32_drift_..., test_a_dropped_window_
# fails_the_f32_serve_bounds, -s).  On the card the kernel sits up to 7x
# further from its order than the CPU emulation from attention_ref (phase 2b),
# and the width is 7.5x, so the bounds leave over 500x the CPU reading and
# stay 1000x under the fault:
SERVE_F32_MAX_ERR = 1e-3    # max |d logit| / max |logit|
SERVE_F32_MEAN_ERR = 1e-3   # mean |d logit| / std(logit)
GEMMA = "gemma-2b"
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_NEW = 2, 8176, 16
GEMMA_FAULT_WINDOW = 4096


def flash_excess(got, want, flip=0.0) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want``, and the largest ratio of an
    error to its tolerance, FLASH_TOL plus ``flip`` (at most 1 within it)."""
    import torch
    rtol, atol = FLASH_TOL[str(want.dtype).removeprefix("torch.")]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        return math.inf, math.inf
    return err.max().item(), (err / (atol + rtol * want.abs() + flip)).max().item()


def flash_close(got, want, what: str, flip=0.0) -> float:
    """Max abs error of the kernel's output against the plain version's."""
    err, ratio = flash_excess(got, want, flip)
    if ratio > 1:
        fail(f"{what}: max abs err {err:.3e}, {ratio:.2f}x its tolerance")
    return err


def tc_reference(q, k, v, **kw):
    """The tight check's reference for the tensor-core kernel: attention_tc_ref
    at the kernel's key tile for this head dim, and the allowance for one flip
    of P's rounding, P_FLIP * max|v| / l per row (l >= 1 where a row sees a
    key)."""
    from repro_torch.kernels.flash_attention import ops, ref
    want, l = ref.attention_tc_ref(q, k, v, return_denominator=True,
                                   block_k=ops.tc_block_k(q.shape[-1]), **kw)
    return want, (P_FLIP * v.float().abs().max() / l.clamp_min(1.0))[..., None]


def p_rounding(got, want, v, what: str) -> tuple[float, float]:
    """The tensor-core kernel's output against attention_ref's: the largest
    |d o| over its P_MAX bound and mean |d o| over its P_MEAN bound (each at
    most 1 within the bound)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    worst = (d / (P_MAX[0] * v.float().abs().max() + P_MAX[1] * want.abs())).max().item()
    mean = (d.mean() / (P_MEAN * want.abs().mean())).item()
    if not worst <= 1 or not mean <= 1:
        fail(f"{what}: beyond the P-rounding bounds against attention_ref: max {worst:.3f}, "
             f"mean {mean:.3f} of the bound")
    return worst, mean


def visible_pairs(sq: int, kv_len: int, causal: bool, window) -> int:
    """Exact number of (query, key) pairs the masks leave visible."""
    total = 0
    for i in range(sq):
        hi = min(kv_len, i + 1) if causal else kv_len
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def sdpa_backend(q, k, v, mask, enable_gqa=True, causal=False) -> str:
    """Which backend scaled_dot_product_attention picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, causal, scale=None,
                                     enable_gqa=enable_gqa)
    names = {b.value: name for name, b in SDPBackend.__members__.items()}
    return names.get(int(choice), str(choice))


def f32_reference(q, k, v, **kw):
    """The tight check's reference for the float32 tensor-core kernel:
    attention_tc_ref in its 3xTF32 order at the kernel's key tile for this
    head dim (ops.f32_block_k)."""
    from repro_torch.kernels.flash_attention import ops, ref
    return ref.attention_tc_ref(q, k, v, block_k=ops.f32_block_k(q.shape[-1]),
                                products="3xtf32", **kw)


def f32_checks(got, q, k, v, what: str, fault: dict, **kw) -> tuple[float, float, float]:
    """The float32 tensor-core kernel's checks: within FLASH_TOL of its 3xTF32
    order (tight) and of attention_ref, and a planted fault (``fault``: the
    keyword arguments of a wrong mask) that the tight check must see.
    Returns both errors and the fault's largest ratio to the tolerance."""
    from repro_torch.kernels.flash_attention import ref
    tight = flash_close(got, f32_reference(q, k, v, **kw), f"{what} (float32 tensor cores)")
    err = flash_close(got, ref.attention_ref(q, k, v, **kw),
                      f"{what} (float32 tensor cores) vs attention_ref")
    _, ratio = flash_excess(got, f32_reference(q, k, v, **{**kw, **fault}))
    if ratio <= 1:
        fail(f"{what}: a planted fault ({fault}) passes the float32 kernel's tight check")
    return tight, err, ratio


def f32_fault(shape, window) -> dict:
    """The planted fault of a float32 check on (b, hq, hkv, sq, skv, dh): the
    window one too wide, or a window of half the query rows imposed where
    there is none (the later rows then lose keys, causal or not)."""
    return dict(window=window + 1) if window else dict(window=max(1, shape[3] // 2))


def strided_bits_equal(launch, q, k, v, **kw) -> bool:
    """Two launches on the model's layout ((B, S, H, Dh) handed over as
    (B, H, S, Dh) views) give the same bits as each other and as a launch on
    contiguous copies."""
    import torch
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    a = launch(*views, **kw)
    return torch.equal(a, launch(*views, **kw)) and torch.equal(a, launch(q, k, v, **kw))


def phase_flash(dev):
    """Phase 2b: the flash kernels against their plain versions on the card,
    through the dispatch rule; at the serve shape the tensor-core kernels'
    checks and planted faults, and their times, bounds and the SDPA
    yardstick, the SIMT kernel's beside them (the route before); the same at
    gemma-2b's shape (Dh 256).  Returns the four kernel entries (tensor-core,
    SIMT, tensor-core at Dh > 128, float32 tensor-core)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention

    def qkv(b, hq, hkv, sq, skv, dh, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))

    window = 4096
    f32, bf16 = torch.float32, torch.bfloat16
    checks = [  # name, (b, hq, hkv, sq, skv, dh), causal, window, kv_len, dtype
        ("serve group f32", (2, 4, 1, SERVE_PROMPT, SERVE_PROMPT, 120), True, window, None, f32),
        ("serve group bf16", (2, 4, 1, SERVE_PROMPT, SERVE_PROMPT, 120), True, window, None, bf16),
        ("mqa dh256 f32", (1, 8, 1, 1024, 1024, 256), True, None, None, f32),
        ("mqa dh256 bf16", (1, 8, 1, 2048, 2048, 256), True, None, None, bf16),
        ("ragged kv_len non-causal f32", (2, 8, 2, 1000, 1500, 120), False, None, 1237, f32),
        ("ragged kv_len non-causal bf16", (2, 8, 2, 1000, 1500, 120), False, None, 1237, bf16),
        ("non-causal window f32", (1, 4, 2, 777, 777, 64), False, 100, None, f32),
        ("gqa dh128 bf16", (2, 16, 2, 1500, 1500, 128), True, None, None, bf16),
        ("dh80 window 100 bf16", (1, 8, 2, 1000, 1000, 80), True, 100, None, bf16),
        ("dh80 window 100 f32", (1, 8, 2, 1000, 1000, 80), True, 100, None, f32),
        ("mqa dh64 ragged non-causal bf16", (2, 8, 1, 77, 300, 64), False, None, 211, bf16),
        ("mqa dh64 ragged non-causal f32", (2, 8, 1, 77, 300, 64), False, None, 211, f32),
        ("gqa dh136 window 100 bf16", (2, 8, 2, 1000, 1000, 136), True, 100, None, bf16),
        ("gqa dh136 window 100 f32", (2, 8, 2, 1000, 1000, 136), True, 100, None, f32),
        ("dh192 ragged kv_len non-causal bf16", (2, 8, 2, 1000, 1500, 192), False, None, 1237,
         bf16),
        ("dh192 ragged kv_len non-causal f32", (2, 8, 2, 1000, 1500, 192), False, None, 1237,
         f32),
        ("mqa dh256 ragged last tile bf16", (2, 8, 1, 1000, 1000, 256), True, None, None, bf16),
        ("dh100 not a multiple of 8 f32", (1, 8, 2, 1000, 1000, 100), True, None, None, f32),
        ("dh99 4-byte loads window 50 f32", (1, 4, 2, 500, 500, 99), True, 50, None, f32),
    ]
    cases = []
    for i, (name, shape, causal, win, kv_len, dtype) in enumerate(checks):
        q, k, v = qkv(*shape, dtype, seed=100 + i)
        kw = dict(causal=causal, window=win, kv_len=kv_len)
        kernel = ops.kernel_for(q)
        wide = int(kernel == "tc" and shape[-1] > 128)
        counters = ("launches_tc", "launches_tc_wide", "launches_f32", "launches_simt")
        before = [getattr(fa, c) for c in counters]
        got = ops.flash_attention(q, k, v, **kw)
        launched = tuple(getattr(fa, c) - n for c, n in zip(counters, before))
        if launched != {"tc": (1, wide, 0, 0), "f32": (0, 0, 1, 0)}.get(kernel):
            fail(f"flash_attention {name}: the {kernel} kernel was not the one launched")
        case = dict(name=name, shape=list(shape), causal=causal, window=win, kv_len=kv_len,
                    dtype=str(dtype), kernel=kernel)
        what = f"flash_attention {name} {shape}"
        if kernel == "tc":
            want, flip = tc_reference(q, k, v, **kw)
            case["max_abs_err"] = flash_close(got, want, f"{what} (tensor cores)", flip)
            case["p_rounding"] = p_rounding(got, ref.attention_ref(q, k, v, **kw), v, what)
            note = (f"against attention_tc_ref; P-rounding bound used {case['p_rounding'][0]:.3f} "
                    f"(max), {case['p_rounding'][1]:.3f} (mean)")
        else:
            fault = f32_fault(shape, win)
            tight, case["max_abs_err"], case["fault"] = f32_checks(got, q, k, v, what, fault, **kw)
            note = (f"against attention_ref (tight against the 3xTF32 order: {tight:.3e}; "
                    f"{fault} fails it at {case['fault']:.1f}x the tolerance)")
        cases.append(case)
        print(f"[2 kernels] flash_attention {name:35s} {shape} [{kernel}]: max abs err "
              f"{case['max_abs_err']:.3e} {note}")
        del q, k, v, got

    # the serve shape: every head of one h2o-danube-3-4b layer's prefill, bf16
    b, hq, hkv, s, dh = SERVE_BATCH, 32, 8, SERVE_PROMPT, 120
    shape = (b, hq, hkv, s, dh)
    kw = dict(causal=True, window=window)
    q, k, v = qkv(b, hq, hkv, s, s, dh, torch.bfloat16, seed=7)
    if ops.kernel_for(q) != "tc":
        fail("flash_attention: the bf16 serve shape is not routed to the tensor-core kernel")
    got = ops.flash_attention(q, k, v, **kw)
    want, flip = tc_reference(q, k, v, **kw)
    tc_err = flash_close(got, want, f"flash_attention serve shape {shape} (tensor cores)", flip)
    rtol, atol = FLASH_TOL["bfloat16"]
    flips = int(((got.float() - want.float()).abs() > atol + rtol * want.float().abs()).sum())
    want = ref.attention_ref(q, k, v, **kw)
    p_max, p_mean = p_rounding(got, want, v, f"flash_attention serve shape {shape}")
    if not torch.equal(got, ops.tc_kernel(q, k, v, **kw)):
        fail("flash_attention: two tensor-core launches at the serve shape differ in bits")
    _, fault = flash_excess(got, *tc_reference(q, k, v, causal=True, window=window + 1))
    if fault <= 1:
        fail("flash_attention: a planted fault (window one too wide) passes the tight check")
    simt = ops.simt_kernel(q, k, v, **kw)
    simt_err = flash_close(simt, want, f"flash_attention serve shape {shape} (SIMT, bf16)")
    pairs = visible_pairs(s, s, True, window)
    nops = 4 * dh * pairs * b * hq
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), nops, BF16_OPS_PER_S)
    tc_ms = cuda_ms(lambda: ops.tc_kernel(q, k, v, **kw), 20)
    simt_ms = cuda_ms(lambda: ops.simt_kernel(q, k, v, **kw), 5)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, **kw), 2, warmup=1)
    idx = torch.arange(s, device=dev)
    band = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - window)
    backend = sdpa_backend(q, k, v, band)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)  # noqa: E731
    sdpa_err = (sdpa().float() - want.float()).abs().max().item()
    library_ms = cuda_ms(sdpa, 5, warmup=1)
    print(f"[2 kernels] flash_attention serve shape (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}, "
          f"window {window}, bf16): tensor-core kernel {tc_ms:.4f} ms (max abs err {tc_err:.3e} "
          f"against attention_tc_ref, {flips} of {got.numel()} outputs beyond the bf16 tolerance "
          f"alone, none beyond one flip of P more; P-rounding bound used {p_max:.3f} max, "
          f"{p_mean:.3f} mean; "
          f"two launches bit-identical; window one too wide fails the tight check at "
          f"{fault:.1f}x its tolerance)  SIMT kernel {simt_ms:.4f} ms (max abs err "
          f"{simt_err:.3e})  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  SDPA "
          f"[{backend}] {library_ms:.4f} ms (max abs diff to plain {sdpa_err:.3e})")
    del got, want, simt

    # float32 at the serve shape: the float32 tensor-core kernel through the
    # dispatch, beside the SIMT kernel (the route before), the plain version and SDPA
    q, k, v = q.float(), k.float(), v.float()
    f32 = f32_timing(q, k, v, "serve shape", dict(window=window + 1), kw, mask=band)
    del q, k, v, band
    torch.cuda.empty_cache()
    wide, f32_gemma = phase_flash_gemma(dev, qkv)
    headline = f"bf16 (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}), causal, window {window}"
    library = f"scaled_dot_product_attention [{backend}]"
    tc = dict(name="flash_attention_tc", route="cuda",
              source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:33", launches=0,
              max_abs_err=tc_err, ms=tc_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
              library_ms=library_ms, library=library, headline=headline,
              p_rounding=dict(max=p_max, mean=p_mean), beyond_bf16_tolerance_alone=flips,
              fault_window_plus_one=fault,
              cases=[c for c in cases if c["kernel"] == "tc" and c["shape"][-1] <= 128])
    wide["cases"] = [c for c in cases if c["kernel"] == "tc" and c["shape"][-1] > 128]
    simt = dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:33", launches=0,
                max_abs_err=simt_err, ms=simt_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, library=library, headline=headline,
                role="the route before of bf16 at Dh > 128 and of float32, called by name",
                f32={k: f32[k] for k in ("simt_ms", "simt_max_abs_err")},
                f32_gemma={k: f32_gemma[k] for k in ("simt_ms", "simt_max_abs_err")})
    f32_entry = dict(
        name="flash_attention_f32", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_f32.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:33", launches=0,
        max_abs_err=max([f32["max_abs_err"], f32_gemma["max_abs_err"]]
                        + [c["max_abs_err"] for c in cases if c["kernel"] == "f32"]),
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["library_ms"], library=f32["library"],
        headline=f"float32 (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}), causal, window "
                 f"{window}; 3xTF32, bound at {TF32X3_OPS_PER_S / 1e12:.0f} TFLOP/s",
        serve_shape=f32, gemma_shape=f32_gemma,
        cases=[c for c in cases if c["kernel"] == "f32"])
    return tc, simt, wide, f32_entry


def f32_timing(q, k, v, label: str, fault: dict, kw: dict, mask=None,
               phase: str = "2 kernels") -> dict:
    """The float32 tensor-core kernel at a main path's shape: through the
    dispatch, its checks (f32_checks), bitwise determinism on strided views,
    its time beside the SIMT kernel's (the route before), the plain
    version's and SDPA's with the heads expanded and TF32 off (its
    memory-efficient backend takes float32, but not enable_gqa), and the
    bounds at 165 TFLOP/s (3xTF32) and 67 (float32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    shape = (b, hq, hkv, s, dh)
    before = (fa.launches_f32, fa.launches_simt)
    got = ops.flash_attention(q, k, v, **kw)
    if (fa.launches_f32 - before[0], fa.launches_simt - before[1]) != (1, 0):
        fail(f"flash_attention: the float32 {label} did not go to the float32 tensor-core kernel")
    what = f"flash_attention {label} {shape}"
    tight, err, fault_ratio = f32_checks(got, q, k, v, what, fault, **kw)
    if not torch.equal(got, ops.f32_kernel(q, k, v, **kw)):
        fail(f"{what}: two float32 tensor-core launches differ in bits")
    if not strided_bits_equal(ops.f32_kernel, q, k, v, **kw):
        fail(f"{what}: the float32 tensor-core kernel's bits differ on strided views")
    plain = ref.attention_ref(q, k, v, **kw)
    simt_err = flash_close(ops.simt_kernel(q, k, v, **kw), plain, f"{what} (SIMT, f32)")
    del got, plain
    window = kw.get("window")
    nops = 4 * dh * visible_pairs(s, s, kw["causal"], window) * b * hq
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, nops, TF32X3_OPS_PER_S)
    b67_ms, _ = bound(nbytes, nops)
    ms = cuda_ms(lambda: ops.f32_kernel(q, k, v, **kw), 10)
    simt_ms = cuda_ms(lambda: ops.simt_kernel(q, k, v, **kw), 3)
    ms_again = cuda_ms(lambda: ops.f32_kernel(q, k, v, **kw), 10)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, **kw), 2, warmup=1)
    kx, vx = (x.repeat_interleave(hq // hkv, 1) for x in (k, v))
    causal_only = window is None and kw["causal"]
    backend = sdpa_backend(q, kx, vx, None if causal_only else mask, enable_gqa=False,
                           causal=causal_only)

    def sdpa():
        if causal_only:
            return F.scaled_dot_product_attention(q, kx, vx, is_causal=True)
        return F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)

    library_ms = None if backend == "MATH" else cuda_ms(sdpa, 3, warmup=1)
    del kx, vx
    print(f"[{phase}] flash_attention {label} (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}, "
          f"{'causal' if kw['causal'] else 'non-causal'}, window {window}, f32; key tile "
          f"{ops.f32_block_k(dh)}): float32 tensor-core kernel {ms:.4f} ms (again {ms_again:.4f}; "
          f"max abs err {err:.3e} against attention_ref, {tight:.3e} against its 3xTF32 order; "
          f"two launches and strided views bit-identical; {fault} fails the tight check at "
          f"{fault_ratio:.1f}x its tolerance)  SIMT kernel {simt_ms:.4f} ms (max abs err "
          f"{simt_err:.3e})  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {nops:.4g} "
          f"operations at {TF32X3_OPS_PER_S / 1e12:.0f} TFLOP/s, 3xTF32), {b67_ms:.4f} ms at "
          f"{F32_OPS_PER_S / 1e12:.0f} float32  SDPA [{backend}] "
          + ("not timed (the math backend)" if library_ms is None else f"{library_ms:.4f} ms"))
    return dict(ms=ms, ms_again=ms_again, max_abs_err=err, tight_err=tight, fault=fault_ratio,
                simt_ms=simt_ms, simt_max_abs_err=simt_err, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bound_f32_ms=b67_ms, library_ms=library_ms,
                library=f"scaled_dot_product_attention [{backend}], heads expanded")


def phase_flash_gemma(dev, qkv) -> tuple[dict, dict]:
    """Phase 2b at gemma-2b's prefill (every head of one layer: B 2, Hq 8,
    Hkv 1, S 8176, Dh 256, causal): the tensor-core kernel's 64-key route
    through the dispatch rule, its tight check, a planted fault (the window of
    phase 8's fault imposed), bitwise determinism; its time beside the SIMT
    kernel's in bf16 (the earlier route of bf16 Dh 256), the plain version's,
    SDPA's with is_causal and the bound.  Then the same shape in float32
    (f32_timing).  Returns the bf16 kernel entry and the float32 timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention
    b, hq, hkv, s, dh = GEMMA_BATCH, 8, 1, GEMMA_PROMPT, 256
    shape = (b, hq, hkv, s, dh)
    q, k, v = qkv(b, hq, hkv, s, s, dh, torch.bfloat16, seed=8)
    before = (fa.launches_tc_wide, fa.launches_simt)
    got = ops.flash_attention(q, k, v, causal=True)
    if (fa.launches_tc_wide - before[0], fa.launches_simt - before[1]) != (1, 0):
        fail("flash_attention: gemma-2b's shape did not go to the tensor-core kernel at Dh 256")
    want, flip = tc_reference(q, k, v, causal=True)
    err = flash_close(got, want, f"flash_attention gemma shape {shape} (tensor cores)", flip)
    rtol, atol = FLASH_TOL["bfloat16"]
    flips = int(((got.float() - want.float()).abs() > atol + rtol * want.float().abs()).sum())
    plain = ref.attention_ref(q, k, v, causal=True)
    p_max, p_mean = p_rounding(got, plain, v, f"flash_attention gemma shape {shape}")
    if not torch.equal(got, ops.tc_kernel(q, k, v, causal=True)):
        fail("flash_attention: two tensor-core launches at gemma's shape differ in bits")
    _, fault = flash_excess(got, *tc_reference(q, k, v, causal=True, window=GEMMA_FAULT_WINDOW))
    if fault <= 1:
        fail(f"flash_attention: a planted fault (a window of {GEMMA_FAULT_WINDOW}) passes the "
             "tight check at gemma's shape")
    simt_err = flash_close(ops.simt_kernel(q, k, v, causal=True), plain,
                           f"flash_attention gemma shape {shape} (SIMT, bf16)")
    del got, want
    nops = 4 * dh * visible_pairs(s, s, True, None) * b * hq
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), nops, BF16_OPS_PER_S)
    ms = cuda_ms(lambda: ops.tc_kernel(q, k, v, causal=True), 20)
    simt_ms = cuda_ms(lambda: ops.simt_kernel(q, k, v, causal=True), 3)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), 2, warmup=1)
    backend = sdpa_backend(q, k, v, None, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    sdpa_err = (sdpa().float() - plain.float()).abs().max().item()
    library_ms = cuda_ms(sdpa, 5, warmup=1)
    print(f"[2 kernels] flash_attention gemma shape (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}, "
          f"causal, bf16; key tile {ops.tc_block_k(dh)}): tensor-core kernel {ms:.4f} ms (max "
          f"abs err {err:.3e} against attention_tc_ref, {flips} of {q.numel()} outputs beyond "
          f"the bf16 tolerance alone, none beyond one flip of P more; P-rounding bound used "
          f"{p_max:.3f} max, {p_mean:.3f} mean; two launches bit-identical; a window of "
          f"{GEMMA_FAULT_WINDOW} fails the tight check at {fault:.1f}x its tolerance)  SIMT "
          f"kernel {simt_ms:.4f} ms (max abs err {simt_err:.3e})  plain {plain_ms:.4f} ms  "
          f"bound {b_ms:.4f} ms ({b_by}; {nops:.4g} operations)  SDPA is_causal [{backend}] "
          f"{library_ms:.4f} ms (max abs diff to plain {sdpa_err:.3e})")
    q, k, v = q.float(), k.float(), v.float()
    del plain
    f32 = f32_timing(q, k, v, "gemma shape", dict(window=GEMMA_FAULT_WINDOW), dict(causal=True))
    del q, k, v
    torch.cuda.empty_cache()
    return dict(name="flash_attention_tc_wide", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:33", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, library=f"scaled_dot_product_attention [{backend}]",
                headline=f"bf16 (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}), causal; the "
                         f"tensor-core kernel at Dh > 128 (key tile {ops.tc_block_k(dh)})",
                simt_ms=simt_ms, simt_max_abs_err=simt_err,
                p_rounding=dict(max=p_max, mean=p_mean), beyond_bf16_tolerance_alone=flips,
                fault_window=fault), f32



# ssd_scan: the chunked dual form against the recurrence and the chunked SSD
# at 128-step chunks, all float32: |k - p| <= SSD_RTOL * (|p| + max|p|).  On
# the CPU at (2, 4096, 4, 64, 128) with Mamba2's ranges the three orders sit
# within 6.2e-7 of each other on that scale.  The kernels' 3xTF32 products,
# emulated on the CPU against a float64 recurrence, stay well within
# SSD_RTOL, TF32 products alone far outside it
# (tests/test_torch_ssd_scan.py::test_tensor_core_products_against_ssd_rtol).
SSD_RTOL = 1e-5
SSD_SERVE = (2, 16384, 80, 64, 128)   # mamba2-2.7b's prefill of 2 x 16384: B, S, H, P, N


def ssd_inputs(b, s, h, p, n, dev, seed, kind="mamba2"):
    """x, dt, a, B, C on ``dev``: A = -U(1, 16) and dt log-uniform in
    [1e-3, 1e-1] as Mamba2 initialises them (``mamba2``), the JAX package's
    test draws (``test_kernels``), or its strong-decay case (``strong``)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(b, s, h, p)
    if kind == "strong":
        return (x, torch.full((b, s, h), 1.5, device=dev), torch.tensor([-2.0] * h, device=dev),
                torch.ones(b, s, n, device=dev) / n, torch.ones(b, s, n, device=dev))
    if kind == "mamba2":
        rate, dt = mamba2_a_dt(rand(h), rand(b, s, h))
        return x, dt, -rate, randn(b, s, n), randn(b, s, n)
    return (x, 0.1 + 0.5 * rand(b, s, h), -torch.exp(0.3 * randn(h)),
            randn(b, s, n) / math.sqrt(n), randn(b, s, n) / math.sqrt(n))


def ssd_ops(b, s, h, p, n) -> float:
    """Operations the SSD needs on these shapes, whatever the chunk.  The
    chunked form does, per (batch, head) and chunk of l steps, l(l+1)/2 * P
    multiply-adds inside the chunk (the causal half), l*N*P for C h and l*N*P
    for the chunk state, and per (batch, chunk) l(l+1)/2 * N for C B^T,
    shared by the heads.  That falls as l shrinks, to the recurrence's
    2*N*P + P per (step, head) and N per step at l = 1, so no chunk does
    less.  Two operations each."""
    return 2.0 * b * s * (h * (2 * n * p + p) + n)


def phase_ssd(dev):
    """Phase 2c: the SSD scan kernels against their plain versions on the
    card; at the serve shape their time, the bounds and the stage split of
    one launch.  Returns the kernel entry."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models.ssm import _final_state, ssd_chunked

    checks = [  # name, (b, s, h, p, n), inputs
        ("chunks of the JAX tests", (2, 128, 4, 32, 16), "test_kernels"),
        ("ragged S 300", (2, 300, 8, 64, 128), "mamba2"),
        ("ragged S 1237", (1, 1237, 4, 64, 128), "mamba2"),
        ("P 40 N 20: partial slices", (1, 200, 3, 40, 20), "test_kernels"),
        ("strong decay", (1, 128, 1, 8, 4), "strong"),
    ]
    cases = []
    for i, (name, shape, kind) in enumerate(checks):
        args = ssd_inputs(*shape, dev, seed=200 + i, kind=kind)
        want, want_state = ref.ssd_scan_ref(*args, return_state=True)
        y, state = ops.ssd_scan(*args, return_state=True)
        what = f"ssd_scan {name} {shape}"
        err = max(close(y, want, f"{what} vs the recurrence", SSD_RTOL),
                  close(state, want_state, f"{what} state", SSD_RTOL))
        close(y, ssd_chunked(*args), f"{what} vs ssd_chunked", SSD_RTOL)
        close(state, _final_state(*args[:4]), f"{what} vs _final_state", SSD_RTOL)
        cases.append(dict(name=name, shape=list(shape), inputs=kind, max_abs_err=err))
        print(f"[2 kernels] ssd_scan {name:28s} {shape}: max abs err {err:.3e} against the "
              f"recurrence (y and final state); within rtol {SSD_RTOL} of ssd_chunked and "
              "_final_state too")

    shape = SSD_SERVE
    b, s, h, p, n = shape
    args = ssd_inputs(*shape, dev, seed=7)
    want, want_state = ssd_chunked(*args), _final_state(*args[:4])
    y, state = ops.ssd_scan(*args, return_state=True)
    what = f"ssd_scan serve shape {shape}"
    err = max(close(y, want, f"{what} vs ssd_chunked", SSD_RTOL),
              close(state, want_state, f"{what} state vs _final_state", SSD_RTOL))
    again, again_state = ops.ssd_scan(*args, return_state=True)
    if not (torch.equal(y, again) and torch.equal(state, again_state)):
        fail(f"{what}: two launches differ in bits")
    del y, state, again, again_state
    ms = cuda_ms(lambda: ops.ssd_scan(*args, return_state=True), 10)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n + b * h * n * p)
    nops = ssd_ops(*shape)
    b_ms, b_by = bound(nbytes, nops, TF32X3_OPS_PER_S)
    f32_ms, f32_by = bound(nbytes, nops)
    scratch_gb = 4 * ops.load_library().ssd_scan_scratch_floats(b, s, h, p, n) / 1e9
    print(f"[2 kernels] ssd_scan serve shape (B {b}, S {s}, H {h}, P {p}, N {n}, Mamba2 A and "
          f"dt), chunk {ops.CHUNK}: max abs err {err:.3e} against ssd_chunked and _final_state; "
          f"two launches bit-identical; kernels {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
          f"{nops:.4g} operations at {TF32X3_OPS_PER_S / 1e12:.0f} TFLOP/s, 3xTF32 on the tensor "
          f"cores, against {nbytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"{f32_ms:.4f} ms ({f32_by}) at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s float32; scratch "
          f"{scratch_gb:.3f} GB")
    plain_ms = cuda_ms(lambda: (ssd_chunked(*args), _final_state(*args[:4])), 2, warmup=1)
    top = device_window(lambda: [ops.ssd_scan(*args, return_state=True) for _ in range(3)],
                        "ssd_scan serve shape, 3 launches", "2 kernels")
    stages = {name.split("::")[-1].split("(")[0]: ms / count for name, (ms, count) in top.items()}
    print("[2 kernels] ssd_scan stages, ms per launch: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    print(f"[2 kernels] ssd_scan plain (ssd_chunked and _final_state) {plain_ms:.4f} ms")
    del args, want, want_state
    torch.cuda.empty_cache()
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/kernel.py:35", launches=0,
                max_abs_err=max([err] + [c["max_abs_err"] for c in cases]),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                headline=f"float32 (B {b}, S {s}, H {h}, P {p}, N {n}), with the final state, "
                         f"chunk {ops.CHUNK}; bound at {TF32X3_OPS_PER_S / 1e12:.0f} TFLOP/s "
                         "(3xTF32)",
                stages=stages, cases=cases)


def device_window(fn, label: str, phase: str = "6 serve") -> dict:
    """Profile ``fn`` once: wall time, device busy time, idle share and the
    kernels that took the most device time, which it returns (name: (ms,
    launches))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        fail(f"{label}: the profiler saw no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    names = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / busy:.1%}) x{e.count}" for e in top)
    print(f"[{phase}] {label} (profiled): wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {max(0.0, 1 - busy / wall):.3f}, {sum(e.count for e in kernels)} "
          f"device launches; top kernels: {names}")
    return {e.key[:60]: (e.self_device_time_total / 1e3, e.count) for e in top}


class DenseServe(NamedTuple):
    """A dense serve path of chip_smoke.py: a config at full width and depth,
    its request, the planted fault of the plain path (config fields it
    changes), the config of the two-layer float32 check (None: none), the
    weights' dtype and the logit bounds (max, mean) against the plain path."""
    name: str
    phase: str
    batch: int
    prompt: int
    new: int
    fault: str
    fault_cfg: dict
    f32_cfg: dict | None
    dtype: str = "bfloat16"
    bounds: tuple[float, float] = (SERVE_MAX_ERR, SERVE_MEAN_ERR)


SERVE_H2O = DenseServe(H2O, "6 serve", SERVE_BATCH, SERVE_PROMPT, SERVE_NEW,
                       "the window dropped", dict(sliding_window=None),
                       dict(sliding_window=128))
SERVE_GEMMA = DenseServe(GEMMA, "8 serve-gemma", GEMMA_BATCH, GEMMA_PROMPT, GEMMA_NEW,
                         f"a window of {GEMMA_FAULT_WINDOW} imposed",
                         dict(sliding_window=GEMMA_FAULT_WINDOW), {})
SERVE_F32 = DenseServe(H2O, "9 serve-f32", SERVE_BATCH, SERVE_PROMPT, SERVE_NEW,
                       "the window dropped", dict(sliding_window=None), None, "float32",
                       (SERVE_F32_MAX_ERR, SERVE_F32_MEAN_ERR))


def phase_serve(dev, smi: str, spec: DenseServe) -> dict:
    """Phases 6, 8 and 9: a dense config at full width and depth through
    ServeEngine in ``spec.dtype``; returns the flash launches of its generate
    (bf16: ``tc``, ``tc_wide`` of them at Dh > 128; float32: ``f32``) and of
    the two-layer float32 check (``f32_check``).  At Dh > 128 in bf16 (the
    tensor-core kernel's 64-key route) and in float32, also one prefill with
    the SIMT kernel in place of the dispatch, timed: the route taken there
    before (``simt``, its launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import ServeEngine
    from repro_torch.models import DecoderLM
    from repro_torch.models import attention as attn_mod

    cfg, tag = get_config(spec.name), spec.phase.split()[-1]
    f32 = spec.dtype == "float32"             # the float32 tensor-core kernel
    wide = not f32 and cfg.resolved_head_dim > 128   # the bf16 kernel's 64-key route
    max_err, mean_err = spec.bounds
    t0 = time.perf_counter()
    model = DecoderLM(cfg, dtype=getattr(torch, spec.dtype), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (spec.batch, spec.prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cache_len = spec.prompt + spec.new
    engine = ServeEngine(model)
    engine.generate(prompt[:, :256], 2, 272)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    print(f"[{spec.phase}] {spec.name}: {n_params / 1e9:.3f} B parameters in {spec.dtype}, "
          f"built in {time.perf_counter() - t0:.2f} s")

    fa = ops.flash_attention
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_tc = fa.launches_tc_wide = fa.launches_f32 = fa.launches_simt = 0
    t0 = time.perf_counter()
    tokens = engine.generate(prompt, spec.new, cache_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = dict(launches=fa.launches, tc=fa.launches_tc, tc_wide=fa.launches_tc_wide,
                  f32=fa.launches_f32)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.num_layers
    kernel = "float32 tensor-core" if f32 else "tensor-core"
    if (fa.launches, fa.launches_tc, fa.launches_tc_wide, fa.launches_f32, fa.launches_simt) != \
            (layers, 0 if f32 else layers, layers if wide else 0, layers if f32 else 0, 0):
        fail(f"{tag}: {fa.launches} flash launches in one generate ({fa.launches_tc} "
             f"tensor-core, {fa.launches_tc_wide} of them at Dh > 128, {fa.launches_f32} float32 "
             f"tensor-core, {fa.launches_simt} SIMT), want {layers} {kernel} launches (one per "
             "layer of the prefill)")
    if tokens.shape != (spec.batch, spec.new):
        fail(f"{tag}: generate gave tokens of shape {tuple(tokens.shape)}")

    # the same request again through the engine's steps, timed, with its logits
    with torch.inference_mode():
        caches = model.init_cache(spec.batch, cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(prompt, caches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode = engine.make_decode_step()
        tok, all_logits, out = logits.argmax(-1), [logits], [logits.argmax(-1)]
        for pos in range(spec.prompt, spec.prompt + spec.new - 1):
            tok, lg, caches = decode(tok, pos, caches)
            out.append(tok)
            all_logits.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(bool(torch.isfinite(lg).all()) for lg in all_logits):
            fail(f"{tag}: non-finite logits")
        if not torch.equal(torch.stack(out, 1), tokens):
            fail(f"{tag}: the timed steps gave other tokens than generate")
        device_window(lambda: [decode(tok, spec.prompt + spec.new + i, caches)
                               for i in range(4)], "4 decode steps", spec.phase)
        del caches
        device_window(lambda: model.prefill(prompt, model.init_cache(spec.batch, cache_len)),
                      "one prefill", spec.phase)
        if wide or f32:
            # the route bf16 Dh 256 and float32 took before: the SIMT kernel in
            # place of the dispatch, for this one timed prefill
            before = fa.launches_simt
            attn_mod.flash_attention = ops.simt_kernel
            try:
                caches = model.init_cache(spec.batch, cache_len)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                simt_logits, _ = model.prefill(prompt, caches)
                torch.cuda.synchronize()
                simt_prefill_ms = 1e3 * (time.perf_counter() - t3)
            finally:
                attn_mod.flash_attention = ops.flash_attention
            if fa.launches_simt - before != layers:
                fail(f"{tag}: the SIMT prefill did not launch the SIMT kernel once per layer")
            counts["simt"] = fa.launches_simt - before
            del caches
        model.attn_impl = "dense"                     # the plain path, same weights
        plain, _ = model.prefill(prompt, model.init_cache(spec.batch, cache_len))
        # a planted fault on the plain path, which the logit bounds must see
        model.cfg = dataclasses.replace(cfg, **spec.fault_cfg)
        faulty, _ = model.prefill(prompt, model.init_cache(spec.batch, cache_len))
        model.cfg, model.attn_impl = cfg, "kernel"
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (spec.new - 1)

    def drift(x):
        d = (x.float() - plain.float()).abs()
        return d, d.max().item() / plain.float().abs().max().item(), \
            d.mean().item() / plain.float().std().item()

    d, max_rel, mean_rel = drift(logits)
    _, fault_max, fault_mean = drift(faulty)
    same = int((logits.argmax(-1) == plain.argmax(-1)).sum())
    route = " at Dh > 128 (key tile 64)" if wide else ""
    print(f"[{spec.phase}] generate of {spec.new} tokens after a {spec.batch}x{spec.prompt} "
          f"prompt: {gen_s:.3f} s; flash launches {counts['launches']}, all {kernel} launches"
          f"{route}; peak memory {peak_gb:.3f} GB  [{smi}]")
    print(f"[{spec.phase}] prefill {prefill_ms:.3f} ms "
          f"({spec.batch * spec.prompt / (t1 - t0):.0f} prompt tokens/s); decode "
          f"{decode_ms:.3f} ms/token step ({spec.batch * 1e3 / decode_ms:.1f} tokens/s at batch "
          f"{spec.batch})")
    if wide or f32:
        _, simt_max, simt_mean = drift(simt_logits)
        print(f"[{spec.phase}] prefill with the SIMT kernel in place of the dispatch (the "
              f"route before): {simt_prefill_ms:.3f} ms "
              f"({spec.batch * spec.prompt * 1e3 / simt_prefill_ms:.0f} prompt tokens/s); its "
              f"logits against plain {simt_max:.4g} of max|logit|, {simt_mean:.4g} of the std")
        counts["simt_prefill_ms"] = simt_prefill_ms
        del simt_logits
    print(f"[{spec.phase}] prefill logits, kernel vs plain attention: max abs diff "
          f"{d.max().item():.4g} ({max_rel:.4g} of max|logit|), mean {d.mean().item():.4g} "
          f"({mean_rel:.4g} of the std); greedy first token equal in {same}/{spec.batch}")
    print(f"[{spec.phase}] planted fault, plain path with {spec.fault}: {fault_max:.4f} of "
          f"max|logit|, {fault_mean:.4f} of the std (bounds {max_err}, {mean_err})")
    if fault_max <= max_err or fault_mean <= mean_err:
        fail(f"{tag}: a planted fault ({spec.fault}) stays within the logit bounds")
    if max_rel > max_err or mean_rel > mean_err:
        fail(f"{tag}: kernel and plain prefill logits differ beyond {max_err} of "
             f"max|logit| or {mean_err} of their std")
    counts.update(prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb,
                  logits_drift=(max_rel, mean_rel), fault_drift=(fault_max, fault_mean))
    del model, plain, faulty, logits, all_logits
    torch.cuda.empty_cache()
    if spec.f32_cfg is None:
        return counts

    # two layers at full width, float32, on the card (kernel) and the CPU (plain)
    small = dataclasses.replace(cfg, num_layers=2, **spec.f32_cfg)
    card = DecoderLM(small, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    cpu = DecoderLM(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    p = torch.randint(0, small.vocab_size, (2, 300), generator=torch.Generator().manual_seed(3))
    fa.launches = fa.launches_tc = fa.launches_tc_wide = fa.launches_f32 = fa.launches_simt = 0
    got = ServeEngine(card).generate(p, 6, 306)
    counts["f32_check"] = fa.launches_f32
    if (fa.launches, fa.launches_f32) != (small.num_layers, small.num_layers):
        fail(f"{tag} reference: the f32 card run did not launch the float32 tensor-core flash "
             "kernel once per layer")
    want = ServeEngine(cpu).generate(p, 6, 306)
    if not torch.equal(got.cpu(), want):
        fail(f"{tag} reference: greedy tokens on the card {got.tolist()} differ from the "
             f"CPU's {want.tolist()}")
    window = f", window {small.sliding_window}" if small.sliding_window else ""
    print(f"[{spec.phase}] reference: 2 layers at full width (f32{window}, head_dim "
          f"{small.resolved_head_dim}, prompt 2x300): the card's 6 greedy tokens equal the CPU's "
          f"({counts['f32_check']} float32 tensor-core flash launches)")
    del card, cpu
    torch.cuda.empty_cache()
    return counts


MAMBA2 = "mamba2-2.7b"
SSM_BATCH, SSM_PROMPT, SSM_NEW = 2, 16384, 16
# kernel vs plain (ssd_chunked) at full width in bf16: the two compute the SSD
# in float32 from the same inputs and differ only in the order of sums, but
# each one-ulp flip of a bf16 activation spreads through 64 layers.  On the CPU
# at d_model 512 and full depth (tests/test_torch_ssm.py::test_bf16_drift_...)
# two float32 SSD orders (ssd_chunked, and the CUDA kernels' stage order at
# their chunk) move the last position's logits by about 5% of max|logit| and
# 4% of their std, and the hidden states at every position by about 4% of
# their std; a lost carry between chunks or a dropped diagonal moves them by
# 64% to 101%
# (test_a_planted_ssd_fault_...).  Phase 7 plants the
# lost carry at full width too and fails if the bounds do not see it.  Bounds:
SSM_MAX_ERR = 0.3     # max |d logit| / max |logit|, the last position
SSM_MEAN_ERR = 0.25   # mean |d| / std, of those logits and of the hidden states


def mamba2_a_dt(u_a, u_dt):
    """The rate -A = U(1, 16) and dt log-uniform in [1e-3, 1e-1], as Mamba2
    initialises them (arXiv:2405.21060, mamba_ssm's defaults), from uniform
    draws in [0, 1): numpy arrays or torch tensors."""
    return 1 + 15 * u_a, 1e-3 * 100.0 ** u_dt


def mamba2_a_log_dt_bias(u):
    """``ssm_a_log`` and ``ssm_dt_bias`` for Mamba2's ranges from the uniform
    torch draws ``u`` (2, ...): log(-A), and dt_bias = softplus^-1(dt)."""
    import torch
    rate, dt = mamba2_a_dt(u[0], u[1])
    return torch.log(rate), dt + torch.log(-torch.expm1(-dt))


def mamba2_ranges_(model, generator) -> None:
    """Overwrite every layer's ``ssm_a_log`` and ``ssm_dt_bias`` with Mamba2's
    initial ranges (``mamba2_a_dt``).  The JAX package's init zeroes both (A
    = -1, dt about 0.8): the state then forgets within a few tokens, and a
    lost carry between chunks hides."""
    import torch
    with torch.no_grad():
        for bp in model.blocks:
            a_log, dt_bias = mamba2_a_log_dt_bias(torch.rand(
                2, bp["ssm_a_log"].shape[0], generator=generator, device=generator.device))
            bp["ssm_a_log"].copy_(a_log)
            bp["ssm_dt_bias"].copy_(dt_bias)


def ssm_drift(logits, plain_logits, hidden, plain_hidden) -> dict:
    """The readings that SSM_MAX_ERR and SSM_MEAN_ERR bound."""
    def ratios(x, ref):
        d, ref = (x.float() - ref.float()).abs(), ref.float()
        return d.max().item() / ref.abs().max().item(), d.mean().item() / ref.std().item()

    (lmax, lmean), (_, hmean) = ratios(logits, plain_logits), ratios(hidden, plain_hidden)
    return dict(logits_max=lmax, logits_mean=lmean, hidden_mean=hmean)


def ssm_within_bounds(r: dict) -> bool:
    return r["logits_max"] <= SSM_MAX_ERR and max(r["logits_mean"], r["hidden_mean"]) \
        <= SSM_MEAN_ERR


def carry_reset(ssd_chunked):
    """A planted fault: ``ssd_chunked`` run on each 128-step chunk alone, so
    the state carried between chunks is lost."""
    import torch

    def faulty(x, dt, a, bmat, cmat, chunk=128):
        return torch.cat([ssd_chunked(x[:, t:t + chunk], dt[:, t:t + chunk], a,
                                      bmat[:, t:t + chunk], cmat[:, t:t + chunk], chunk)
                          for t in range(0, x.shape[1], chunk)], dim=1)
    return faulty


def phase_serve_ssm(dev, smi: str) -> int:
    """Phase 7: mamba2-2.7b at full width and depth through ServeEngine;
    returns the ssd_scan launches of the generate run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.launch import ServeEngine
    from repro_torch.models import DecoderLM
    from repro_torch.models import ssm as ssm_mod

    cfg = get_config(MAMBA2)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    mamba2_ranges_(model, torch.Generator(device=dev).manual_seed(4))
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cache_len = SSM_PROMPT + SSM_NEW
    engine = ServeEngine(model)
    engine.generate(prompt[:, :256], 2, 258)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    print(f"[7 serve-ssm] {MAMBA2}: {n_params / 1e9:.3f} B parameters in bf16, built in "
          f"{time.perf_counter() - t0:.2f} s; ssm_a_log and ssm_dt_bias overwritten with "
          "Mamba2's initial ranges (A = U(1, 16), dt log-uniform in [1e-3, 1e-1]; the JAX "
          "package's init zeroes them)")

    torch.cuda.reset_peak_memory_stats()
    ops.ssd_scan.launches = 0
    t0 = time.perf_counter()
    tokens = engine.generate(prompt, SSM_NEW, cache_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = ops.ssd_scan.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.num_layers:
        fail(f"serve-ssm: {launches} ssd_scan launches in one generate, want {cfg.num_layers} "
             "(one per layer of the prefill)")
    if tokens.shape != (SSM_BATCH, SSM_NEW):
        fail(f"serve-ssm: generate gave tokens of shape {tuple(tokens.shape)}")

    with torch.inference_mode():
        caches = model.init_cache(SSM_BATCH, cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(prompt, caches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode = engine.make_decode_step()
        tok, all_logits, out = logits.argmax(-1), [logits], [logits.argmax(-1)]
        for pos in range(SSM_PROMPT, SSM_PROMPT + SSM_NEW - 1):
            tok, lg, caches = decode(tok, pos, caches)
            out.append(tok)
            all_logits.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(bool(torch.isfinite(lg).all()) for lg in all_logits):
            fail("serve-ssm: non-finite logits")
        if not torch.equal(torch.stack(out, 1), tokens):
            fail("serve-ssm: the timed steps gave other tokens than generate")
        device_window(lambda: [decode(tok, SSM_PROMPT + SSM_NEW + i, caches) for i in range(4)],
                      "4 decode steps", "7 serve-ssm")
        del caches
        device_window(lambda: model.prefill(prompt, model.init_cache(SSM_BATCH, cache_len)),
                      "one prefill", "7 serve-ssm")
        hidden = model(prompt)
        model.attn_impl = "dense"                     # the plain path, same weights
        plain, _ = model.prefill(prompt, model.init_cache(SSM_BATCH, cache_len))
        plain_hidden = model(prompt)
        plain_chunked = ssm_mod.ssd_chunked
        ssm_mod.ssd_chunked = carry_reset(plain_chunked)   # a planted fault on the plain path
        try:
            faulty, _ = model.prefill(prompt, model.init_cache(SSM_BATCH, cache_len))
            faulty_hidden = model(prompt)
        finally:
            ssm_mod.ssd_chunked, model.attn_impl = plain_chunked, "kernel"
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (SSM_NEW - 1)
    r = ssm_drift(logits, plain, hidden, plain_hidden)
    rf = ssm_drift(faulty, plain, faulty_hidden, plain_hidden)
    same = int((logits.argmax(-1) == plain.argmax(-1)).sum())
    print(f"[7 serve-ssm] generate of {SSM_NEW} tokens after a {SSM_BATCH}x{SSM_PROMPT} prompt: "
          f"{gen_s:.3f} s; ssd_scan launches {launches}; peak memory {peak_gb:.3f} GB  [{smi}]")
    print(f"[7 serve-ssm] prefill {prefill_ms:.3f} ms ({SSM_BATCH * SSM_PROMPT / (t1 - t0):.0f} "
          f"prompt tokens/s); decode {decode_ms:.3f} ms/token step "
          f"({SSM_BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {SSM_BATCH})")
    print(f"[7 serve-ssm] kernel vs plain ssd_chunked: prefill logits max {r['logits_max']:.4f} "
          f"of max|logit|, mean {r['logits_mean']:.4f} of the std; hidden states at every "
          f"position mean {r['hidden_mean']:.4f} of the std; greedy first token equal in "
          f"{same}/{SSM_BATCH}")
    print(f"[7 serve-ssm] planted fault, plain path with the carry reset at every chunk: logits "
          f"max {rf['logits_max']:.4f}, mean {rf['logits_mean']:.4f}; hidden mean "
          f"{rf['hidden_mean']:.4f} (bounds {SSM_MAX_ERR}, {SSM_MEAN_ERR})")
    if rf["logits_max"] <= SSM_MAX_ERR or rf["logits_mean"] <= SSM_MEAN_ERR \
            or rf["hidden_mean"] <= SSM_MEAN_ERR:
        fail("serve-ssm: a planted fault (the carry reset at every chunk) stays within a bound")
    if not ssm_within_bounds(r):
        fail(f"serve-ssm: kernel and plain outputs differ beyond {SSM_MAX_ERR} of max|logit| "
             f"or {SSM_MEAN_ERR} of their std")
    del model, plain, faulty, logits, all_logits, hidden, plain_hidden, faulty_hidden
    torch.cuda.empty_cache()

    # two layers at full width, float32, on the card (kernel) and the CPU (plain)
    small = dataclasses.replace(cfg, num_layers=2)
    card = DecoderLM(small, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    mamba2_ranges_(card, torch.Generator(device=dev).manual_seed(5))
    cpu = DecoderLM(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    p = torch.randint(0, small.vocab_size, (2, 300), generator=torch.Generator().manual_seed(3))
    before = ops.ssd_scan.launches
    got = ServeEngine(card).generate(p, 6, 306)
    if ops.ssd_scan.launches - before != small.num_layers:
        fail("serve-ssm reference: the card run did not launch ssd_scan once per layer")
    want = ServeEngine(cpu).generate(p, 6, 306)
    if not torch.equal(got.cpu(), want):
        fail(f"serve-ssm reference: greedy tokens on the card {got.tolist()} differ from the "
             f"CPU's {want.tolist()}")
    print("[7 serve-ssm] reference: 2 layers at full width (f32, prompt 2x300): the card's 6 "
          "greedy tokens equal the CPU's")
    return launches


# Phase 10: federated LM training, FederatedConfig as in
# examples/train_federated_lm.py (clip 1, sigma 0.05, eta_l 0.05), bf16
# weights seeded as phases 6 and 7 seed them, the xla_flash path, remat on.
# (model, algorithm, K, tau, rounds), one sequence of TRAIN_SEQ tokens a step.
TRAIN_SEQ = 2048
TRAIN_RUNS = ((H2O, "cdp-fedexp", 4, 2, 3), (H2O, "ldp-fedexp-gauss", 4, 2, 1),
              (MAMBA2, "cdp-fedexp", 2, 1, 1))
TRAIN_FED = dict(clip_norm=1.0, noise_sigma=0.05, local_lr=0.05)
# Depth cut to keep the script within its time limit since phase 12 came:
# mamba2-2.7b trains 16 of its 64 layers (its step is host-bound, idle
# share 0.60); since phase 13 came, h2o-danube-3-4b 12 of its 24 and
# (phase 12) zamba2-2.7b 18 of its 54 Mamba2 layers.  Whisper (phase 13)
# trains at full depth.
TRAIN_DEPTH = {MAMBA2: 16, H2O: 12}
TRAIN_STEP_REPEATS = 3    # one local step timed this often (a host's hiccup shows in one)
CLIP_SLACK = 1e-3      # a clipped update's norm may exceed C by this share (its bf16 casts)
# The card against the CPU: two full-width h2o layers in float32, cdp-fedexp at
# K = 2, tau = 1, 256 tokens, the same materialized noise (sigma 1e-6: the
# noise is there but leaves FedEXP room to extrapolate, so that eta_g forced to
# 1 shows), TF32 off.  Both sides compute in float32 and differ in the order of
# their sums: a product over n terms is off by about sqrt(n) * 2^-24 relative
# (n <= 10240: 6e-6), and the forward and backward chain a few dozen of them;
# the FedEXP ratio of two sums of squares adds little.  Bound: every metric
# and the whole update tree's largest error within 1e-4 of their scale.
TRAIN_CHECK = dict(layers=2, k=2, tau=1, seq=256, sigma=1e-6)
TRAIN_CHECK_TOL = 1e-4


def train_batch(stream, seed: int, tau: int, seq: int, dev, cfg=None) -> dict:
    """A round's (K, tau, 1, seq) tokens and next-token labels from ``stream``;
    for an enc-dec ``cfg``, also (K, tau, 1, WHISPER_FRAMES, d_model) frame
    embeddings drawn N(0, 1) from ``seed`` (the stubbed frontend's), in the
    model's dtype on the model's side."""
    import torch
    toks = stream.sample(torch.Generator().manual_seed(seed), tau, 1, seq + 1).to(dev)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg is not None and cfg.arch_type == "audio":
        batch["frames"] = torch.randn(toks.shape[:3] + (WHISPER_FRAMES, cfg.d_model),
                                      generator=torch.Generator().manual_seed(seed)).to(dev)
    return batch


def train_checks(label: str, metrics: dict, name: str, clip: float) -> None:
    """Finite metrics, eta_g >= 1 for a FedEXP name, clipped norms <= C."""
    import torch
    for key, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"train {label}: non-finite {key} {v.tolist()}")
    if "fedexp" in name and float(metrics["eta_g"]) < 1.0:
        fail(f"train {label}: eta_g {float(metrics['eta_g'])} < 1 for {name}")
    worst = float(metrics["clipped_norms"].max())
    if worst > clip * (1 + CLIP_SLACK):
        fail(f"train {label}: a clipped update's norm {worst} exceeds C = {clip} by more "
             f"than {CLIP_SLACK:g} of it")


def train_model(name: str, dev):
    """``name`` at full width in bf16, at full depth but for TRAIN_DEPTH's
    cuts, seeded as phases 6 and 7 seed it, on the xla_flash path (the
    chunked SSD in Mamba2) with remat; an enc-dec config as an EncDecLM."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(name)
    if name in TRAIN_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTH[name])
    model = build_model(cfg, dtype=torch.bfloat16, attn_impl="xla_flash", remat=True, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    if cfg.arch_type in ("ssm", "hybrid"):
        mamba2_ranges_(model, torch.Generator(device=dev).manual_seed(4))
    return cfg, model


def train_runs(dev, smi: str, arch: str, runs=TRAIN_RUNS, phase: str = "10 train") -> dict:
    """The ``runs`` of ``arch`` (TRAIN_RUNS): rounds timed on the host clock with the card
    synchronised, peak memory, the checks after every round, the parameters
    moved (and among them every leaf ZOO_TRAIN_MOVED names); one local step
    warmed up, timed TRAIN_STEP_REPEATS times and profiled before the first
    run (a profiled round's 140 k launches take the profiler minutes to sum)."""
    import torch
    from repro_torch.configs import FederatedConfig
    from repro_torch.data import make_client_stream
    from repro_torch.launch import FederatedTrainer, count_params
    t0 = time.perf_counter()
    cfg, model = train_model(arch, dev)
    n = count_params(cfg)
    if n != count_params(model):
        fail(f"train {arch}: count_params of the config {n} != the model's "
             f"{count_params(model)}")
    params = {k: p.detach() for k, p in model.named_parameters()}
    audio = cfg.arch_type == "audio"
    seq = WHISPER_DECODER_LEN if audio else TRAIN_SEQ
    what = f"({WHISPER_FRAMES} frames, {seq} tokens)" if audio else f"{seq} tokens"
    layers = (f"{cfg.num_encoder_layers} + {cfg.num_layers}" if audio else str(cfg.num_layers))
    print(f"[{phase}] {arch}: {layers} layers, {n / 1e9:.3f} B bf16 parameters "
          f"(count_params), xla_flash, "
          f"remat on, built in {time.perf_counter() - t0:.2f} s")
    out = {}
    for run_arch, name, k, tau, rounds in runs:
        if run_arch != arch:
            continue
        r0 = time.perf_counter()
        fed = FederatedConfig(algorithm=name, local_steps=tau, **TRAIN_FED)
        trainer = FederatedTrainer(model, fed, n)
        step = trainer.make_train_step(k)
        stream = make_client_stream(torch.Generator().manual_seed(1), k, cfg.vocab_size)
        batch = train_batch(stream, 100, tau, seq, dev, cfg)
        row = {}
        if not out:
            one = (params, batch["tokens"][0, :1], batch["labels"][0, :1]) + (
                (batch["frames"][0, :1],) if "frames" in batch else ())
            trainer._local_train(*one)                   # warm-up: cuBLAS, the allocator
            steps = []
            for _ in range(TRAIN_STEP_REPEATS):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                trainer._local_train(*one)
                torch.cuda.synchronize()
                steps.append(1e3 * (time.perf_counter() - s0))
            row["step_ms"], row["step_ms_runs"] = sorted(steps)[len(steps) // 2], steps
            row["step_profile"] = device_window(lambda: trainer._local_train(*one),
                                                f"one local step of {arch}", phase)
            print(f"[{phase}] {arch}: one local step (1 x {what}, forward, "
                  f"backward with remat, update) median {row['step_ms']:.1f} ms of "
                  f"{[round(x, 1) for x in steps]}  [{smi}]")
            del one
        torch.cuda.reset_peak_memory_stats()
        round_ms, first = [], params
        for t in range(rounds):
            batch = train_batch(stream, 100 + t, tau, seq, dev, cfg)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            new, metrics = step(params, batch, torch.Generator().manual_seed(200 + t))
            torch.cuda.synchronize()
            round_ms.append(1e3 * (time.perf_counter() - s0))
            train_checks(f"{arch} {name} round {t}", metrics, name, fed.clip_norm)
            print(f"[{phase}] {arch} {name} round {t}: loss {float(metrics['loss']):.5f}, "
                  f"eta_g {float(metrics['eta_g']):.5f}, update norms "
                  f"{[round(x, 5) for x in metrics['client_norms'].tolist()]}, clipped "
                  f"{[round(x, 5) for x in metrics['clipped_norms'].tolist()]}, agg_sq "
                  f"{float(metrics['agg_sq']):.6g}, {round_ms[-1]:.1f} ms")
            params = new
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        moved = sum(int((params[key] != first[key]).sum()) for key in params)
        total = sum(v.numel() for v in params.values())
        if moved == 0:
            fail(f"train {arch} {name}: no parameter moved in {rounds} rounds")
        tracked = [key for key in params if any(m in key for m in ZOO_TRAIN_MOVED.get(arch, ()))]
        still = [key for key in tracked if torch.equal(params[key], first[key])]
        if still:
            fail(f"train {arch} {name}: {still[:4]} did not move in {rounds} rounds")
        if tracked:
            print(f"[{phase}] {arch} {name}: all {len(tracked)} leaves named "
                  f"{ZOO_TRAIN_MOVED[arch]} moved")
        row.update(round_ms=round_ms, peak_gb=peak_gb, moved=moved / total)
        print(f"[{phase}] {arch} {name}: K = {k}, tau = {tau}, 1 x {what} a step: "
              f"ms per round {[round(x, 1) for x in round_ms]}, peak {peak_gb:.3f} GB; "
              f"{moved / total:.4f} of the parameters moved; run {time.perf_counter() - r0:.1f} "
              f"s  [{smi}]")
        out[name] = row
        del first, new
    del model, params
    torch.cuda.empty_cache()
    return out


def train_reference(dev, arch: str = H2O, phase: str = "10 train") -> dict:
    """The card against the CPU (TRAIN_CHECK) on two layers of ``arch`` (a
    hybrid's: one super-block of two), and a planted fault, eta_g forced to 1
    on the card, that must break the bound."""
    import torch
    from repro_torch.configs import FederatedConfig, get_config
    from repro_torch.core import stepsize
    from repro_torch.data import make_client_stream
    from repro_torch.launch import FederatedTrainer, count_params
    from repro_torch.models import build_model
    c = TRAIN_CHECK
    small = dataclasses.replace(get_config(arch), num_layers=c["layers"])
    if small.arch_type == "hybrid":
        small = dataclasses.replace(small, hybrid_attn_every=c["layers"])
    if small.arch_type == "audio":
        small = dataclasses.replace(small, num_encoder_layers=c["layers"])
    card = build_model(small, attn_impl="xla_flash", device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    cpu = build_model(small, attn_impl="xla_flash", device="cpu")
    cpu.load_state_dict(card.state_dict())
    fed = FederatedConfig(algorithm="cdp-fedexp", local_steps=c["tau"], clip_norm=1.0,
                          noise_sigma=c["sigma"], local_lr=0.05)
    n = count_params(small)
    stream = make_client_stream(torch.Generator().manual_seed(1), c["k"], small.vocab_size)
    batch = train_batch(stream, 7, c["tau"], c["seq"], "cpu", small)
    p_cpu = {k: p.detach() for k, p in cpu.named_parameters()}
    p_card = {k: p.detach() for k, p in card.named_parameters()}
    t0 = time.perf_counter()
    noise = FederatedTrainer(cpu, fed, n).draw_noise(p_cpu, c["k"],
                                                     torch.Generator().manual_seed(5))
    t1 = time.perf_counter()
    want, wm = FederatedTrainer(cpu, fed, n).make_train_step(c["k"])(
        p_cpu, batch, torch.Generator(), noise)
    t2 = time.perf_counter()
    print(f"[{phase}] reference: the CPU's noise drawn in {t1 - t0:.1f} s, its train_step "
          f"in {t2 - t1:.1f} s on {torch.get_num_threads()} threads")
    step = FederatedTrainer(card, fed, n).make_train_step(c["k"])
    card_batch = {k: v.to(dev) for k, v in batch.items()}

    def gaps(got, gm) -> tuple[float, float]:
        scale = max(float((want[k] - p_cpu[k]).abs().max()) for k in want)
        upd = max(float(((got[k].cpu() - p_card[k].cpu()) - (want[k] - p_cpu[k])).abs().max())
                  for k in want) / scale
        met = max(abs(float(gm[k]) / float(wm[k]) - 1)
                  for k in ("loss", "eta_g", "mean_update_norm", "agg_sq"))
        return upd, met

    got, gm = step(p_card, card_batch, torch.Generator(), noise)
    upd, met = gaps(got, gm)
    del got
    plain_cdp = stepsize.cdp
    stepsize.cdp = lambda *a: torch.ones((), device=dev)     # the planted fault
    try:
        bad, bm = step(p_card, card_batch, torch.Generator(), noise)
    finally:
        stepsize.cdp = plain_cdp
    bad_upd, bad_met = gaps(bad, bm)
    print(f"[{phase}] reference: {c['layers']} {arch} layers at full width in float32, "
          f"cdp-fedexp, K = {c['k']}, tau = {c['tau']}, {c['seq']} tokens"
          f"{f' and {WHISPER_FRAMES} frames' if 'frames' in batch else ''}, the same "
          f"materialized noise (sigma {c['sigma']:g}): card vs CPU update tree "
          f"{upd:.3e} of its largest entry, metrics {met:.3e} relative (bound "
          f"{TRAIN_CHECK_TOL:g}); eta_g {float(wm['eta_g']):.6f}, loss "
          f"{float(wm['loss']):.6f}; planted fault (eta_g forced to 1): {bad_upd:.3e}, "
          f"{bad_met:.3e}; {time.perf_counter() - t0:.1f} s in all")
    if max(upd, met) > TRAIN_CHECK_TOL:
        fail(f"train reference {arch}: the card's train_step differs from the CPU's by {upd:.3e} "
             f"(update tree) and {met:.3e} (metrics), beyond {TRAIN_CHECK_TOL:g}")
    if max(bad_upd, bad_met) <= TRAIN_CHECK_TOL:
        fail(f"train reference {arch}: a planted fault (eta_g forced to 1) stays within the bound")
    return dict(update_err=upd, metric_err=met, fault_update_err=bad_upd,
                eta_g=float(wm["eta_g"]))


def phase_train(dev, smi: str) -> dict:
    """Phase 10: federated LM training on the card (TRAIN_RUNS), and the card
    against the CPU (TRAIN_CHECK).  Launches no hand-written kernel: the
    training path reaches none, in the JAX package neither."""
    from repro_torch.kernels.dp_aggregate import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    before = (dp_ops.dp_aggregate_sums.launches, fa_ops.flash_attention.launches,
              ssd_ops.ssd_scan.launches)
    out = {arch: train_runs(dev, smi, arch) for arch in (H2O, MAMBA2)}
    out["reference"] = train_reference(dev)
    after = (dp_ops.dp_aggregate_sums.launches, fa_ops.flash_attention.launches,
             ssd_ops.ssd_scan.launches)
    if after != before:
        fail(f"train: the training path launched kernels ({before} -> {after})")
    return out


# Phase 11: the rest of the decoder zoo served through ServeEngine at full
# width, seeded bf16 weights, 16 greedy tokens a request.  (model, batch,
# prompt, layers kept: None is full depth).  llama4-maverick keeps 1 of its
# 48 layers: the whole model (783.2 B parameters, 1566 GB in bf16) fits on
# no card, nor on four.
ZAMBA2, GRANITE_MOE, CHAMELEON = "zamba2-2.7b", "granite-moe-1b-a400m", "chameleon-34b"
LLAMA4 = "llama4-maverick-400b-a17b"
ZOO_NEW = 16


class ZooServe(NamedTuple):
    name: str
    batch: int
    prompt: int
    layers: int | None = None


ZOO_SERVE = (ZooServe(ZAMBA2, 2, 8192), ZooServe(GRANITE_MOE, 2, 8192),
             ZooServe(CHAMELEON, 1, 4096), ZooServe(LLAMA4, 2, 4096, layers=1))
# The card against the CPU: two layers at full width in float32 (zamba2: one
# super-block of two Mamba2 layers and one site of the shared block), the
# same weights and a 2 x 300 prompt; the prefill logits within phase 9's
# float32 bounds (SERVE_F32_MAX_ERR, SERVE_F32_MEAN_ERR) and 6 greedy tokens
# equal; a planted fault on the CPU's plain path (config fields it changes)
# must leave the bounds.
ZOO_FAULTS = {
    ZAMBA2: ("the shared block after every Mamba2 layer", dict(hybrid_attn_every=1)),
    GRANITE_MOE: ("a capacity factor of 0.25", dict(capacity_factor=0.25)),
    CHAMELEON: ("qk-norm dropped", dict(qk_norm=False)),
}


def zoo_attention_shape(cfg, batch: int, prompt: int) -> tuple:
    """(b, hq, hkv, s, dh) of one attention layer's prefill."""
    return batch, cfg.num_heads, cfg.num_kv_heads, prompt, cfg.resolved_head_dim


def zoo_ssd_shape(cfg, batch: int, prompt: int) -> tuple:
    """(b, s, h, p, n) of one Mamba2 layer's prefill."""
    return batch, prompt, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


def zoo_kernels(dev) -> tuple[list, list, list]:
    """Phase 11a: the kernels at the zoo's prefill shapes, each held against
    its plain version: the bf16 tensor-core flash kernel at one layer's every
    head (zamba2's shared block MHA 32 at Dh 80, granite-moe's GQA 16/8 at Dh
    64, chameleon's GQA 64/8 at Dh 128, llama4's GQA 40/8 at Dh 128), tight
    against its rounding order and within the P-rounding bounds of
    attention_ref, a planted fault (a window of half the prompt) that the
    tight check must see, its time beside the plain version's, the bound and
    SDPA's; the float32 tensor-core kernel at the two-layer checks' shapes
    (prompt 300) with its checks; ssd_scan at zamba2's prefill (N 64) against
    ssd_chunked and _final_state, twice in bits, timed with its bound.
    Returns (tensor-core cases, float32 cases, ssd_scan cases)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.ssd_scan import ops as scan_ops
    from repro_torch.models.ssm import _final_state, ssd_chunked
    fa = ops.flash_attention
    tc_cases, f32_cases, ssd_cases = [], [], []
    for i, spec in enumerate(ZOO_SERVE):
        cfg = get_config(spec.name)
        b, hq, hkv, s, dh = zoo_attention_shape(cfg, spec.batch, spec.prompt)
        g = torch.Generator(device=dev).manual_seed(300 + i)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, hq, s, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
        what = f"flash_attention {spec.name} prefill (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh})"
        before = (fa.launches_tc, fa.launches_tc_wide, fa.launches_f32, fa.launches_simt)
        got = fa(q, k, v, causal=True)
        if (fa.launches_tc - before[0], fa.launches_tc_wide - before[1],
                fa.launches_f32 - before[2], fa.launches_simt - before[3]) != (1, 0, 0, 0):
            fail(f"{what}: not routed to the tensor-core kernel at Dh <= 128")
        want, flip = tc_reference(q, k, v, causal=True)
        err = flash_close(got, want, f"{what} (tensor cores)", flip)
        plain = ref.attention_ref(q, k, v, causal=True)
        p_max, p_mean = p_rounding(got, plain, v, what)
        if not torch.equal(got, ops.tc_kernel(q, k, v, causal=True)):
            fail(f"{what}: two launches differ in bits")
        _, fault = flash_excess(got, *tc_reference(q, k, v, causal=True, window=s // 2))
        if fault <= 1:
            fail(f"{what}: a planted fault (a window of {s // 2}) passes the tight check")
        del want
        nops = 4 * dh * visible_pairs(s, s, True, None) * b * hq
        b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), nops, BF16_OPS_PER_S)
        ms = cuda_ms(lambda: ops.tc_kernel(q, k, v, causal=True), 10)
        plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), 1, warmup=1)
        backend = sdpa_backend(q, k, v, None, causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        sdpa_err = (sdpa().float() - plain.float()).abs().max().item()
        library_ms = cuda_ms(sdpa, 5, warmup=1)
        tc_cases.append(dict(name=f"{spec.name} prefill", shape=[b, hq, hkv, s, s, dh],
                             causal=True, dtype="torch.bfloat16", kernel="tc", max_abs_err=err,
                             p_rounding=[p_max, p_mean], fault_window_half=fault, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms,
                             library=f"scaled_dot_product_attention [{backend}]"))
        print(f"[11 zoo kernels] {what}, causal, bf16 (key tile {ops.tc_block_k(dh)}): "
              f"tensor-core kernel {ms:.4f} ms (max abs err {err:.3e} against attention_tc_ref; "
              f"P-rounding bound used {p_max:.3f} max, {p_mean:.3f} mean; two launches "
              f"bit-identical; a window of {s // 2} fails the tight check at {fault:.1f}x)  plain "
              f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  SDPA is_causal [{backend}] "
              f"{library_ms:.4f} ms (max abs diff to plain {sdpa_err:.3e})")
        del q, k, v, got, plain
        if spec.name in ZOO_FAULTS:   # the shape of the two-layer float32 check
            shape = (2, hq, hkv, 300, 300, dh)
            q, k, v = (torch.randn(x, generator=g, device=dev)
                       for x in ((2, hq, 300, dh), (2, hkv, 300, dh), (2, hkv, 300, dh)))
            before = fa.launches_f32
            got = fa(q, k, v, causal=True)
            if fa.launches_f32 - before != 1:
                fail(f"flash_attention {spec.name} f32 check shape: not the float32 kernel")
            fault = f32_fault(shape, None)
            tight, err, ratio = f32_checks(got, q, k, v, f"flash_attention {spec.name} {shape}",
                                           fault, causal=True)
            f32_cases.append(dict(name=f"{spec.name} two-layer check", shape=list(shape),
                                  causal=True, dtype="torch.float32", kernel="f32",
                                  max_abs_err=err, tight=tight, fault=ratio))
            print(f"[11 zoo kernels] flash_attention {spec.name} {shape} float32: max abs err "
                  f"{err:.3e} against attention_ref (tight against the 3xTF32 order: "
                  f"{tight:.3e}; {fault} fails it at {ratio:.1f}x)")
            del q, k, v, got
        if cfg.arch_type == "hybrid":
            shape = zoo_ssd_shape(cfg, spec.batch, spec.prompt)
            sb, ss, sh, sp, sn = shape
            args = ssd_inputs(*shape, dev, seed=310)
            want, want_state = ssd_chunked(*args), _final_state(*args[:4])
            y, state = scan_ops.ssd_scan(*args, return_state=True)
            what = f"ssd_scan {spec.name} prefill {shape}"
            err = max(close(y, want, f"{what} vs ssd_chunked", SSD_RTOL),
                      close(state, want_state, f"{what} state vs _final_state", SSD_RTOL))
            again, again_state = scan_ops.ssd_scan(*args, return_state=True)
            if not (torch.equal(y, again) and torch.equal(state, again_state)):
                fail(f"{what}: two launches differ in bits")
            del y, state, again, again_state
            ms = cuda_ms(lambda: scan_ops.ssd_scan(*args, return_state=True), 10)
            plain_ms = cuda_ms(lambda: (ssd_chunked(*args), _final_state(*args[:4])), 1,
                               warmup=1)
            nbytes = 4 * (2 * sb * ss * sh * sp + sb * ss * sh + sh + 2 * sb * ss * sn
                          + sb * sh * sn * sp)
            b_ms, b_by = bound(nbytes, ssd_ops(*shape), TF32X3_OPS_PER_S)
            ssd_cases.append(dict(name=f"{spec.name} prefill", shape=list(shape),
                                  inputs="mamba2", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=None))
            print(f"[11 zoo kernels] {what} (Mamba2 A and dt), chunk {scan_ops.CHUNK}: max abs "
                  f"err {err:.3e} against ssd_chunked and _final_state; two launches "
                  f"bit-identical; kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}, 3xTF32)")
            del args, want, want_state
        torch.cuda.empty_cache()
    return tc_cases, f32_cases, ssd_cases


def zoo_model(spec: ZooServe, dev, dtype_name: str = "bfloat16", **changes):
    """``spec``'s config (cut to ``spec.layers``, with ``changes``) built on
    ``dev`` from seed 0; Mamba2 layers get Mamba2's ranges of A and dt, as
    phase 7's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    cfg = get_config(spec.name)
    if spec.layers is not None:
        changes = dict(num_layers=spec.layers, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    model = DecoderLM(cfg, dtype=getattr(torch, dtype_name), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    if cfg.arch_type == "hybrid":
        mamba2_ranges_(model, torch.Generator(device=dev).manual_seed(4))
    return cfg, model


def moe_drops(model, prompt) -> list[float]:
    """Per MoE layer, the share of the prefill's (token, slot) assignments
    dropped for want of capacity (one prefill with ``moe_apply`` wrapped; its
    host reads stay out of every timed run)."""
    from repro_torch.models import moe
    shares, plain = [], moe.moe_apply

    def recording(params, x, cfg, prefix="moe_"):
        shares.append(moe.dropped_share(params, x, cfg, prefix))
        return plain(params, x, cfg, prefix)

    moe.moe_apply = recording
    try:
        model.prefill(prompt, model.init_cache(prompt.shape[0], prompt.shape[1]))
    finally:
        moe.moe_apply = plain
    return shares


def zoo_serve(dev, smi: str, spec: ZooServe) -> dict:
    """One model of phase 11 through ServeEngine: 16 greedy tokens after the
    prompt with the launch counters set to 0 before and read after (flash:
    one tensor-core launch per attention layer or shared-block site; ssd_scan:
    one per Mamba2 layer), then the same request through the engine's steps,
    timed, finite and equal in tokens, a profiled prefill and peak memory;
    an MoE's dropped share per layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import ServeEngine, count_params
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = zoo_model(spec, dev)
    n_params = count_params(model)
    if n_params != count_params(cfg):
        fail(f"serve-zoo {spec.name}: count_params of the config {count_params(cfg)} != the "
             f"model's {n_params}")
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    prompt = torch.randint(0, cfg.vocab_size, (spec.batch, spec.prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cache_len = spec.prompt + ZOO_NEW
    engine = ServeEngine(model)
    engine.generate(prompt[:, :256], 2, 258)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    depth = get_config(spec.name).num_layers
    cut = "" if spec.layers is None else f" (cut to {spec.layers} of its {depth} layers)"
    print(f"[11 serve-zoo] {spec.name}{cut}: {n_params / 1e9:.3f} B parameters in bf16 "
          f"({weights_gb:.3f} GB; the card's allocation peaked at {build_peak:.3f} GB while "
          f"building), built in {time.perf_counter() - t0:.2f} s")

    fa, ssd = ops.flash_attention, ssd_ops.ssd_scan
    sites = cfg.num_layers // cfg.hybrid_attn_every if cfg.arch_type == "hybrid" \
        else cfg.num_layers
    mamba = cfg.num_layers if cfg.arch_type == "hybrid" else 0
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_tc = fa.launches_tc_wide = fa.launches_f32 = fa.launches_simt = 0
    ssd.launches = 0
    t0 = time.perf_counter()
    tokens = engine.generate(prompt, ZOO_NEW, cache_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = dict(flash=fa.launches, tc=fa.launches_tc, ssd_scan=ssd.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if (fa.launches, fa.launches_tc, fa.launches_tc_wide, fa.launches_f32, fa.launches_simt,
            ssd.launches) != (sites, sites, 0, 0, 0, mamba):
        fail(f"serve-zoo {spec.name}: {fa.launches} flash launches ({fa.launches_tc} "
             f"tensor-core, {fa.launches_tc_wide} at Dh > 128, {fa.launches_f32} float32, "
             f"{fa.launches_simt} SIMT) and {ssd.launches} ssd_scan launches in one generate, "
             f"want {sites} tensor-core launches and {mamba} ssd_scan launches")
    if tokens.shape != (spec.batch, ZOO_NEW):
        fail(f"serve-zoo {spec.name}: generate gave tokens of shape {tuple(tokens.shape)}")

    with torch.inference_mode():
        caches = model.init_cache(spec.batch, cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(prompt, caches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode = engine.make_decode_step()
        tok, all_logits, out = logits.argmax(-1), [logits], [logits.argmax(-1)]
        for pos in range(spec.prompt, spec.prompt + ZOO_NEW - 1):
            tok, lg, caches = decode(tok, pos, caches)
            out.append(tok)
            all_logits.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(bool(torch.isfinite(lg).all()) for lg in all_logits):
            fail(f"serve-zoo {spec.name}: non-finite logits")
        if not torch.equal(torch.stack(out, 1), tokens):
            fail(f"serve-zoo {spec.name}: the timed steps gave other tokens than generate")
        del caches, all_logits
        top = device_window(lambda: model.prefill(prompt, model.init_cache(spec.batch,
                                                                          cache_len)),
                            f"{spec.name} one prefill", "11 serve-zoo")
        drops = moe_drops(model, prompt) if cfg.arch_type == "moe" else None
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (ZOO_NEW - 1)
    print(f"[11 serve-zoo] {spec.name}: generate of {ZOO_NEW} tokens after a "
          f"{spec.batch}x{spec.prompt} prompt {gen_s:.3f} s; {counts['tc']} tensor-core flash "
          f"launches, {counts['ssd_scan']} ssd_scan launches; prefill {prefill_ms:.3f} ms "
          f"({spec.batch * spec.prompt / (t1 - t0):.0f} prompt tokens/s); decode "
          f"{decode_ms:.3f} ms/token step; peak memory {peak_gb:.3f} GB  [{smi}]")
    if drops is not None:
        print(f"[11 serve-zoo] {spec.name}: dropped share of the prefill's (token, slot) "
              f"assignments at capacity factor {cfg.capacity_factor}, per layer: "
              f"{[round(x, 4) for x in drops]} (mean {sum(drops) / len(drops):.4f})")
    if spec.name == CHAMELEON:
        print(f"[11 serve-zoo] {spec.name}: its float32 form would hold "
              f"{4 * n_params / 1e9:.1f} GB of weights, beyond the card's "
              f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB: not tried")
    counts.update(prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb,
                  params=n_params, prefill_profile=top, dropped_share=drops)
    del model, logits, prompt, tokens
    torch.cuda.empty_cache()
    return counts


def greedy(model, prompt, new: int):
    """The prefill logits of ``prompt`` and ``new`` greedy tokens, through
    ServeEngine's steps."""
    import torch
    from repro_torch.launch import ServeEngine
    engine = ServeEngine(model)
    with torch.inference_mode():
        caches = model.init_cache(prompt.shape[0], prompt.shape[1] + new)
        logits, caches = model.prefill(prompt, caches)
        tok, out = logits.argmax(-1), [logits.argmax(-1)]
        decode = engine.make_decode_step()
        for pos in range(prompt.shape[1], prompt.shape[1] + new - 1):
            tok, _, caches = decode(tok, pos, caches)
            out.append(tok)
    return logits, torch.stack(out, 1)


def zoo_reference(dev, name: str) -> dict:
    """Two layers of ``name`` at full width in float32 on the card (the
    kernels) and on the CPU (their plain versions): the prefill logits within
    the float32 serve bounds, 6 greedy tokens equal, and a planted fault
    (ZOO_FAULTS) on the CPU that the bounds must see."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import DecoderLM
    t0 = time.perf_counter()
    changes = dict(num_layers=2)
    if name == ZAMBA2:
        changes["hybrid_attn_every"] = 2
    small, card = zoo_model(ZooServe(name, 2, 300), dev, "float32", **changes)
    cpu = DecoderLM(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    p = torch.randint(0, small.vocab_size, (2, 300), generator=torch.Generator().manual_seed(3))
    fa, ssd = ops.flash_attention, ssd_ops.ssd_scan
    before = (fa.launches_f32, ssd.launches)
    got, got_tokens = greedy(card, p.to(dev), 6)
    want, want_tokens = greedy(cpu, p, 6)
    with torch.inference_mode():
        cpu.cfg = dataclasses.replace(small, **ZOO_FAULTS[name][1])
        faulty, _ = cpu.prefill(p, cpu.init_cache(2, 306))
        cpu.cfg = small
    sites = 1 if name == ZAMBA2 else 2
    launched = (fa.launches_f32 - before[0], ssd.launches - before[1])
    if launched != (sites, 2 if name == ZAMBA2 else 0):
        fail(f"serve-zoo {name} reference: the card launched {launched} (float32 flash, "
             f"ssd_scan) in a prefill, want ({sites}, {2 if name == ZAMBA2 else 0})")

    def drift(x):
        d = (x.float().cpu() - want.float()).abs()
        return d.max().item() / want.abs().max().item(), d.mean().item() / want.std().item()

    max_rel, mean_rel = drift(got)
    fault_max, fault_mean = drift(faulty)
    print(f"[11 serve-zoo] reference: {name}, 2 layers at full width in float32 (head_dim "
          f"{small.resolved_head_dim}, prompt 2x300): card vs CPU prefill logits {max_rel:.3e} "
          f"of max|logit|, {mean_rel:.3e} of the std; planted fault ({ZOO_FAULTS[name][0]}) "
          f"{fault_max:.3e}, {fault_mean:.3e} (bounds {SERVE_F32_MAX_ERR}, "
          f"{SERVE_F32_MEAN_ERR}); 6 greedy tokens "
          f"{'equal' if torch.equal(got_tokens.cpu(), want_tokens) else 'DIFFERENT'}; "
          f"{time.perf_counter() - t0:.1f} s")
    if max_rel > SERVE_F32_MAX_ERR or mean_rel > SERVE_F32_MEAN_ERR:
        fail(f"serve-zoo {name} reference: card and CPU logits differ beyond the float32 bounds")
    if fault_max <= SERVE_F32_MAX_ERR and fault_mean <= SERVE_F32_MEAN_ERR:
        fail(f"serve-zoo {name} reference: a planted fault ({ZOO_FAULTS[name][0]}) stays "
             "within the bounds")
    if not torch.equal(got_tokens.cpu(), want_tokens):
        fail(f"serve-zoo {name} reference: greedy tokens on the card {got_tokens.tolist()} "
             f"differ from the CPU's {want_tokens.tolist()}")
    del card, cpu
    torch.cuda.empty_cache()
    return dict(logits_drift=(max_rel, mean_rel), fault_drift=(fault_max, fault_mean),
                f32_launches=launched[0], ssd_launches=launched[1])


def phase_serve_zoo(dev, smi: str) -> dict:
    """Phase 11: the zoo's kernels at their shapes (zoo_kernels), each model
    of ZOO_SERVE served (zoo_serve), and two float32 layers of each new stack
    card vs CPU (zoo_reference)."""
    tc_cases, f32_cases, ssd_cases = zoo_kernels(dev)
    out = {"kernels": dict(tc=tc_cases, f32=f32_cases, ssd=ssd_cases)}
    for spec in ZOO_SERVE:
        out[spec.name] = zoo_serve(dev, smi, spec)
    out["reference"] = {name: zoo_reference(dev, name) for name in ZOO_FAULTS}
    return out


# Phase 11b: the MoE served with the JAX package's group-local dispatch.  The
# rules are make_rules(..., mode="serve") for a (data 2, model 1) mesh, so the
# prefill's tokens split into G = 2 dispatch groups (a decode step's 2 tokens
# are fewer a group than experts: one group, as in the JAX package).  The
# bf16 requests of phase 11 (ZOO_SERVE's granite-moe and llama4 block) at G =
# 2 and G = 1; two float32 layers at G = 2, card against CPU, within phase 9's
# float32 bounds (llama4's cut to GROUPED_F32_EXPERTS of its 128 experts: two
# float32 layers of all of them hold 129 GB); on the card, G = 2 against
# G = 1 at a capacity factor of E (no token drops) within the same bounds;
# then the dry-run as a subprocess for GROUPED_DRYRUNS.
GROUPED_MESH = (("data", "model"), (2, 1))
GROUPED_F32_EXPERTS = {LLAMA4: 8}
GROUPED_DRYRUNS = (("granite-moe-1b-a400m", "decode_32k", False),
                   ("llama4-maverick-400b-a17b", "train_4k", True))
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "kind", "fed", "num_params",
               "tokens_per_step", "trace_s", "memory", "cost", "collective_bytes",
               "collective_total", "roofline", "model_flops", "useful_ratio", "ops")


class MeshShape(NamedTuple):
    """What the launch rules read of a mesh: its axis names and sizes."""
    mesh_dim_names: tuple
    shape: tuple


def grouped_rules(cfg) -> dict:
    """The serve rules of ``cfg``'s full configuration on GROUPED_MESH."""
    from repro_torch.configs import get_config
    from repro_torch.launch import count_params
    from repro_torch.launch.rules import make_rules
    full = get_config(cfg.name)
    return make_rules(full, MeshShape(*GROUPED_MESH), mode="serve",
                      num_params=count_params(full))


def timed_request(model, prompt, cache_len: int, new: int):
    """(prefill ms, decode ms a step, the greedy tokens) of one request through
    ServeEngine's steps, host clock with the card synchronised."""
    import torch
    from repro_torch.launch import ServeEngine
    engine = ServeEngine(model)
    with torch.inference_mode():
        caches = model.init_cache(prompt.shape[0], cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = engine.make_prefill_step()(prompt, caches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode, out = engine.make_decode_step(), [tok]
        for pos in range(prompt.shape[1], prompt.shape[1] + new - 1):
            tok, logits, caches = decode(tok, pos, caches)
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    if not torch.isfinite(logits).all():
        fail("serve-moe-grouped: non-finite decode logits")
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (new - 1), torch.stack(out, 1)


def grouped_serve(dev, smi: str, spec: ZooServe) -> dict:
    """``spec`` (bf16, phase 11's request) under the grouped rules: the
    generate's flash launches (one tensor-core launch an attention layer),
    its G, then prefill and decode ms at G = 2 and at G = 1 (no rules)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import ServeEngine
    from repro_torch.models import moe
    from repro_torch.models.sharding import axis_rules
    cfg, model = zoo_model(spec, dev)
    rules = grouped_rules(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (spec.batch, spec.prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cache_len = spec.prompt + ZOO_NEW
    with axis_rules(rules):
        g = moe.dispatch_groups(spec.batch, spec.batch * spec.prompt, cfg.num_experts)
        g_decode = moe.dispatch_groups(spec.batch, spec.batch, cfg.num_experts)
        if g != 2 or g_decode != 1:
            fail(f"serve-moe-grouped {spec.name}: {g} prefill groups and {g_decode} decode "
                 "groups under the (data 2, model 1) serve rules, want 2 and 1")
        ServeEngine(model).generate(prompt[:, :256], 2, 258)     # warm-up
        fa = ops.flash_attention
        fa.launches = fa.launches_tc = fa.launches_tc_wide = fa.launches_f32 = 0
        fa.launches_simt = 0
        tokens = ServeEngine(model).generate(prompt, ZOO_NEW, cache_len)
        torch.cuda.synchronize()
        counts = (fa.launches, fa.launches_tc, fa.launches_tc_wide, fa.launches_f32,
                  fa.launches_simt)
        if counts != (cfg.num_layers, cfg.num_layers, 0, 0, 0):
            fail(f"serve-moe-grouped {spec.name}: flash launches (all, tensor-core, Dh > 128, "
                 f"float32, SIMT) {counts} in one generate, want {cfg.num_layers} tensor-core")
        pre2, dec2, toks2 = timed_request(model, prompt, cache_len, ZOO_NEW)
        drops = moe_drops(model, prompt)
    if not torch.equal(toks2, tokens):
        fail(f"serve-moe-grouped {spec.name}: the timed steps gave other tokens than generate")
    drops1 = moe_drops(model, prompt)     # G = 1's capacities; also a warm-up prefill
    pre1, dec1, _ = timed_request(model, prompt, cache_len, ZOO_NEW)
    print(f"[11b serve-moe-grouped] {spec.name} {spec.batch}x{spec.prompt} bf16, G = 2 "
          f"(prefill; decode steps G = 1): {counts[1]} tensor-core flash launches in a "
          f"generate; prefill {pre2:.3f} ms at G = 2 against {pre1:.3f} at G = 1; decode "
          f"{dec2:.3f} against {dec1:.3f} ms a step; dropped share of the prefill's (token, "
          f"slot) assignments, mean over layers, {sum(drops) / len(drops):.4f} at G = 2 against "
          f"{sum(drops1) / len(drops1):.4f} at G = 1  [{smi}]")
    del model, prompt, tokens
    torch.cuda.empty_cache()
    return dict(tc=counts[1], groups=g, prefill_ms={"G=2": pre2, "G=1": pre1},
                decode_ms={"G=2": dec2, "G=1": dec1},
                dropped_share={"G=2": drops, "G=1": drops1})


def grouped_reference(dev, name: str) -> dict:
    """Two float32 layers of ``name`` at full width (llama4's experts cut,
    GROUPED_F32_EXPERTS) at G = 2: card (the float32 flash kernel) against
    CPU (its plain version), prefill logits within phase 9's float32 bounds
    and 6 greedy tokens equal; then on the card G = 2 against G = 1 at a
    capacity factor of E, where no token drops (checked), within the same
    bounds."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import DecoderLM, moe
    from repro_torch.models.sharding import axis_rules
    t0 = time.perf_counter()
    changes = dict(num_layers=2)
    if name in GROUPED_F32_EXPERTS:
        changes["num_experts"] = GROUPED_F32_EXPERTS[name]
    small, card = zoo_model(ZooServe(name, 2, 300), dev, "float32", **changes)
    rules = grouped_rules(small)
    cpu = DecoderLM(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    p = torch.randint(0, small.vocab_size, (2, 300), generator=torch.Generator().manual_seed(3))
    fa = ops.flash_attention
    with axis_rules(rules):
        if moe.dispatch_groups(2, 600, small.num_experts) != 2:
            fail(f"serve-moe-grouped {name} reference: not two dispatch groups")
        before = fa.launches_f32
        got, got_tokens = greedy(card, p.to(dev), 6)
        launched = fa.launches_f32 - before
        want, want_tokens = greedy(cpu, p, 6)
    if launched != 2:
        fail(f"serve-moe-grouped {name} reference: {launched} float32 flash launches in the "
             "card's prefill, want 2")
    del cpu

    def drift(x, ref):
        d = (x.float().cpu() - ref.float().cpu()).abs()
        return d.max().item() / ref.abs().max().item(), d.mean().item() / ref.float().std().item()

    card_cpu = drift(got, want)
    tokens_equal = torch.equal(got_tokens.cpu(), want_tokens)
    card.cfg = dataclasses.replace(small, capacity_factor=float(small.num_experts))
    with axis_rules(rules):
        two, _ = card.prefill(p.to(dev), card.init_cache(2, 300))
        dropped = max(moe_drops(card, p.to(dev)))
    one, _ = card.prefill(p.to(dev), card.init_cache(2, 300))
    groups = drift(two, one)
    print(f"[11b serve-moe-grouped] reference: {name}, 2 float32 layers at full width"
          f"{f' ({small.num_experts} of 128 experts)' if name in GROUPED_F32_EXPERTS else ''}"
          f", prompt 2x300, G = 2: card vs CPU prefill logits {card_cpu[0]:.3e} of max|logit|, "
          f"{card_cpu[1]:.3e} of the std (bounds {SERVE_F32_MAX_ERR}, {SERVE_F32_MEAN_ERR}); 6 "
          f"greedy tokens {'equal' if tokens_equal else 'DIFFERENT'}; at capacity factor "
          f"{small.num_experts} (no layer drops: {dropped:.4f} at most) G = 2 vs G = 1 "
          f"{groups[0]:.3e}, "
          f"{groups[1]:.3e}; {time.perf_counter() - t0:.1f} s")
    if card_cpu[0] > SERVE_F32_MAX_ERR or card_cpu[1] > SERVE_F32_MEAN_ERR:
        fail(f"serve-moe-grouped {name} reference: card and CPU differ beyond the float32 bounds")
    if not tokens_equal:
        fail(f"serve-moe-grouped {name} reference: greedy tokens differ, card vs CPU")
    if dropped != 0.0:
        fail(f"serve-moe-grouped {name}: a capacity factor of E drops {dropped} of a layer")
    if groups[0] > SERVE_F32_MAX_ERR or groups[1] > SERVE_F32_MEAN_ERR:
        fail(f"serve-moe-grouped {name}: G = 2 and G = 1 differ beyond the float32 bounds "
             "where no token drops")
    del card
    torch.cuda.empty_cache()
    return dict(card_cpu=card_cpu, g2_vs_g1=groups, experts=small.num_experts,
                f32_launches=launched)


def start_dryruns(out_dir: Path) -> list:
    """GROUPED_DRYRUNS, each ``python -m repro_torch.launch.dryrun`` in a
    process of its own (started together, one CPU thread each)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, multi_pod in GROUPED_DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--out", str(out_dir)] + (["--multi-pod"] if multi_pod else [])
        procs.append((arch, shape, multi_pod, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=ROOT)))
    return procs


def finish_dryruns(procs, out_dir: Path) -> dict:
    """Wait for the dry-runs; each must exit 0 and write its JSON with every key."""
    out = {}
    for arch, shape, multi_pod, proc in procs:
        log, _ = proc.communicate(timeout=300)
        mesh = "2x16x16" if multi_pod else "16x16"
        if proc.returncode != 0:
            fail(f"dry-run {arch} x {shape} [{mesh}] exited {proc.returncode}: {log[-2000:]}")
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        r = json.loads(path.read_text())
        missing = [k for k in DRYRUN_KEYS if k not in r] + [
            k for k in ("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")
            if k not in r["memory"]]
        if missing:
            fail(f"dry-run {arch} x {shape} [{mesh}]: keys missing {missing}")
        print(f"[11b serve-moe-grouped] dry-run {arch} x {shape} [{mesh}]: trace "
              f"{r['trace_s']} s, {r['memory']['argument_bytes'] / 1e9:.3f} GB of arguments "
              f"and {r['memory']['peak_bytes'] / 1e9:.3f} GB peak a device, "
              f"{r['cost']['flops']:.4g} FLOPs, {r['collective_total']:.4g} collective bytes, "
              f"bottleneck {r['roofline']['bottleneck']} (CPU, no card)")
        out[f"{arch} {shape} {mesh}"] = dict(trace_s=r["trace_s"], roofline=r["roofline"],
                                             memory=r["memory"])
    return out


def phase_serve_moe_grouped(dev, smi: str) -> dict:
    """Phase 11b: grouped_serve for ZOO_SERVE's granite-moe and llama4 block,
    grouped_reference for both, and the dry-runs of GROUPED_DRYRUNS."""
    specs = [s for s in ZOO_SERVE if s.name in (GRANITE_MOE, LLAMA4)]
    out = {s.name: grouped_serve(dev, smi, s) for s in specs}
    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = start_dryruns(out_dir)
    try:
        out["reference"] = {s.name: grouped_reference(dev, s.name) for s in specs}
        out["dryrun"] = finish_dryruns(procs, out_dir)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# Phase 12: phase 10's recipe on the zoo, full width and depth (zamba2 cut to
# three super-blocks, TRAIN_DEPTH), cdp-fedexp.
ZOO_TRAIN_RUNS = ((ZAMBA2, "cdp-fedexp", 2, 1, 1), (GRANITE_MOE, "cdp-fedexp", 4, 2, 2))
TRAIN_DEPTH.update({ZAMBA2: 18, GRANITE_MOE: 8})
# leaves that must move in a round: the hybrid's shared block, the experts
ZOO_TRAIN_MOVED = {ZAMBA2: ("shared_attn.",), GRANITE_MOE: (".moe_wi", ".moe_wo", ".moe_router")}


def phase_train_zoo(dev, smi: str) -> dict:
    """Phase 12: zamba2-2.7b (18 of its 54 layers) and granite-moe-1b-a400m
    (8 of 24; TRAIN_DEPTH) trained at full width (train_runs on
    ZOO_TRAIN_RUNS), and two float32 layers of each
    card vs CPU (train_reference).  Launches no hand-written kernel."""
    from repro_torch.kernels.dp_aggregate import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    before = (dp_ops.dp_aggregate_sums.launches, fa_ops.flash_attention.launches,
              ssd_ops.ssd_scan.launches)
    out = {arch: train_runs(dev, smi, arch, ZOO_TRAIN_RUNS, "12 train-zoo")
           for arch in (ZAMBA2, GRANITE_MOE)}
    out["reference"] = {arch: train_reference(dev, arch, "12 train-zoo")
                        for arch in (ZAMBA2, GRANITE_MOE)}
    after = (dp_ops.dp_aggregate_sums.launches, fa_ops.flash_attention.launches,
             ssd_ops.ssd_scan.launches)
    if after != before:
        fail(f"train-zoo: the training path launched kernels ({before} -> {after})")
    return out


# Phase 13: whisper-large-v3's encoder-decoder (the audio stack).  Serving: 8
# utterances of whisper's 30 s window (1500 frames of seeded frame embeddings,
# standing in for the stubbed frontend), a seeded 4-token decoder prompt, 16
# greedy tokens, a KV cache of whisper's 448 trained positions; seeded bf16
# weights at full width and depth.  Training: phase 10's recipe (cdp-fedexp)
# at full width and depth, K = 2, tau = 1, 1 round, each step 1 x (1500
# frames, 256 decoder tokens), launch/specs.py's WHISPER_DECODER_LEN.
WHISPER = "whisper-large-v3"
WHISPER_PARAMS = 1_535_587_840          # the JAX package's count_params(EncDecLM(cfg))
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.specs import WHISPER_DECODER_LEN  # noqa: E402
from repro_torch.launch.specs import WHISPER_ENC_FRAMES as WHISPER_FRAMES  # noqa: E402
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW, WHISPER_CACHE = 8, 4, 16, 448
WHISPER_TRAIN_RUNS = ((WHISPER, "cdp-fedexp", 2, 1, 1),)
# the card against the CPU: 2 + 2 layers at full width in float32, 2
# utterances; a planted fault on the CPU's plain path (config fields it changes)
WHISPER_CHECK_BATCH, WHISPER_CHECK_NEW = 2, 6
WHISPER_FAULT = ("RoPE applied to self-attention (use_rope=True)", dict(use_rope=True))
ZOO_TRAIN_MOVED[WHISPER] = ("enc_blocks.", ".xattn_")


def whisper_kernels(dev, smi: str) -> tuple[list, dict]:
    """Phase 13a: the flash kernels at whisper's shapes, each held against its
    plain version.  The bf16 tensor-core kernel at one encoder layer's every
    head (B 8, MHA 20, S 1500, Dh 64, non-causal: a ragged last tile of 92
    query rows and keys) and at the decoder's prefill (4 query rows of a
    128-row tile, causal): tight against its rounding order (phase 11a's
    check), within the P-rounding bounds of attention_ref, two launches in
    bits, a planted fault (the other mask) that the tight check must see,
    its time beside the plain version's, the bound and SDPA's.  The float32
    kernel at the encoder's shape through f32_timing.  Returns (tensor-core
    cases, the float32 case)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref
    cfg = get_config(WHISPER)
    fa = ops.flash_attention
    b, h, dh = WHISPER_BATCH, cfg.num_heads, cfg.resolved_head_dim
    cases = []
    for label, s, causal in (("encoder", WHISPER_FRAMES, False),
                             ("decoder prefill", WHISPER_PROMPT, True)):
        g = torch.Generator(device=dev).manual_seed(400 + s)
        q, k, v = (torch.randn((b, h, s, dh), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        what = (f"flash_attention whisper {label} (B {b}, H {h}/{h}, S {s}, Dh {dh}, "
                f"{'causal' if causal else 'non-causal'})")
        before = (fa.launches_tc, fa.launches_tc_wide, fa.launches_f32, fa.launches_simt)
        got = fa(q, k, v, causal=causal)
        if (fa.launches_tc - before[0], fa.launches_tc_wide - before[1],
                fa.launches_f32 - before[2], fa.launches_simt - before[3]) != (1, 0, 0, 0):
            fail(f"{what}: not routed to the tensor-core kernel at Dh <= 128")
        want, flip = tc_reference(q, k, v, causal=causal)
        err = flash_close(got, want, f"{what} (tensor cores)", flip)
        plain = ref.attention_ref(q, k, v, causal=causal)
        p_max, p_mean = p_rounding(got, plain, v, what)
        if not torch.equal(got, ops.tc_kernel(q, k, v, causal=causal)):
            fail(f"{what}: two launches differ in bits")
        if not strided_bits_equal(ops.tc_kernel, q, k, v, causal=causal):
            fail(f"{what}: the tensor-core kernel's bits differ on the model's strided views")
        _, fault = flash_excess(got, *tc_reference(q, k, v, causal=not causal))
        if fault <= 1:
            fail(f"{what}: a planted fault (causal={not causal}) passes the tight check")
        del want
        nops = 4 * dh * visible_pairs(s, s, causal, None) * b * h
        b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), nops, BF16_OPS_PER_S)
        bytes_ms = 1e3 * 2 * (2 * q.numel() + k.numel() + v.numel()) / HBM_BYTES_PER_S
        ms = cuda_ms(lambda: ops.tc_kernel(q, k, v, causal=causal), 20)
        plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal), 2, warmup=1)
        backend = sdpa_backend(q, k, v, None, causal=causal)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        sdpa_err = (sdpa().float() - plain.float()).abs().max().item()
        library_ms = cuda_ms(sdpa, 20, warmup=2)
        cases.append(dict(name=f"whisper {label}", shape=[b, h, h, s, s, dh], causal=causal,
                          dtype="torch.bfloat16", kernel="tc", max_abs_err=err,
                          p_rounding=[p_max, p_mean], fault_mask_flipped=fault, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          bytes_bound_ms=bytes_ms, operations=nops, library_ms=library_ms,
                          library=f"scaled_dot_product_attention [{backend}]"))
        print(f"[13 audio] {what}, bf16 (key tile {ops.tc_block_k(dh)}): tensor-core kernel "
              f"{ms:.4f} ms (max abs err {err:.3e} against attention_tc_ref; P-rounding bound "
              f"used {p_max:.3f} max, {p_mean:.3f} mean; two launches and strided views "
              f"bit-identical; causal={not causal} fails the tight check at {fault:.1f}x)  plain "
              f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}: {nops:.4g} operations at "
              f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; bytes {bytes_ms:.4f} ms)  SDPA "
              f"is_causal={causal} [{backend}] {library_ms:.4f} ms (max abs diff to plain "
              f"{sdpa_err:.3e})  [{smi}]")
        del q, k, v, got, plain
    g = torch.Generator(device=dev).manual_seed(420)
    q, k, v = (torch.randn((b, h, WHISPER_FRAMES, dh), generator=g, device=dev)
               for _ in range(3))
    f32 = f32_timing(q, k, v, "whisper encoder", dict(causal=True), dict(causal=False),
                     phase="13 audio")
    f32.update(name="whisper encoder", shape=[b, h, h, WHISPER_FRAMES, WHISPER_FRAMES, dh],
               causal=False, dtype="torch.float32", kernel="f32")
    del q, k, v
    torch.cuda.empty_cache()
    return cases, f32


def whisper_inputs(cfg, batch: int, dev, dtype):
    """Seeded frame embeddings (batch, WHISPER_FRAMES, d_model) in ``dtype``,
    standing in for the stubbed frontend, and a seeded (batch,
    WHISPER_PROMPT) decoder prompt."""
    import torch
    frames = torch.randn(batch, WHISPER_FRAMES, cfg.d_model,
                         generator=torch.Generator().manual_seed(11)).to(dev, dtype)
    prompt = torch.randint(0, cfg.vocab_size, (batch, WHISPER_PROMPT),
                           generator=torch.Generator().manual_seed(12)).to(dev)
    return frames, prompt


def whisper_request(model, frames, prompt, new: int, cache_len: int):
    """One request through ServeEngine(is_encdec=True)'s two steps: (the
    greedy tokens (B, new), every decode step's logits, the prefill's and a
    decode step's host-clock ms with the card synchronised)."""
    import torch
    from repro_torch.launch import ServeEngine
    engine = ServeEngine(model, is_encdec=True)
    prefill, decode = engine.make_prefill_step(), engine.make_decode_step()
    with torch.inference_mode():
        caches = model.init_cache(prompt.shape[0], cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches, enc_out = prefill(frames, prompt, caches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, logits = [tok], []
        for pos in range(prompt.shape[1], prompt.shape[1] + new - 1):
            tok, lg, caches = decode(tok, pos, caches, enc_out)
            out.append(tok)
            logits.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return torch.stack(out, 1), logits, 1e3 * (t1 - t0), 1e3 * (t2 - t1) / max(new - 1, 1)


def whisper_prefill_logits(model, frames, prompt):
    """The last prompt position's logits: the encoder, then the decoder's
    teacher-forced forward of the prompt (no cache; the prefill's
    arithmetic)."""
    import torch
    with torch.inference_mode():
        return model.decode(prompt, model.encode(frames))[0][:, -1]


def whisper_serve(dev, smi: str) -> dict:
    """Phase 13b: whisper-large-v3 at full width and depth in bf16 served
    through ServeEngine(is_encdec=True)'s steps.  The launch counters are set
    to 0 before one request and read after: 64 tensor-core flash launches in
    its prefill (each layer's self-attention, 32 non-causal at S 1500 in the
    encoder and 32 causal at S 4 in the decoder, as the recorded calls say)
    and none in its decode steps.  Then the request again, timed, with the
    same tokens; a profiled prefill; peak memory; finite logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import count_params
    from repro_torch.models import EncDecLM, attention
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WHISPER)
    model = EncDecLM(cfg, dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    n_params = count_params(model)
    if not n_params == count_params(cfg) == WHISPER_PARAMS:
        fail(f"audio: count_params of the model {n_params}, of the config "
             f"{count_params(cfg)}, want {WHISPER_PARAMS} (the JAX package's)")
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    frames, prompt = whisper_inputs(cfg, WHISPER_BATCH, dev, torch.bfloat16)
    whisper_request(model, frames[:1], prompt[:1], 2, WHISPER_CACHE)   # warm-up: cuBLAS
    print(f"[13 audio] {WHISPER}: {cfg.num_encoder_layers} + {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters in bf16 ({weights_gb:.3f} GB), built in "
          f"{time.perf_counter() - t0:.2f} s")

    fa, plain_call, calls = ops.flash_attention, attention.flash_attention, []

    def recording(q, k, v, **kw):
        calls.append((q.shape[2], bool(kw.get("causal", True)), q.is_cuda))
        return plain_call(q, k, v, **kw)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_tc = fa.launches_tc_wide = fa.launches_f32 = fa.launches_simt = 0
    attention.flash_attention = recording
    try:
        tokens, logits, _, _ = whisper_request(model, frames, prompt, WHISPER_NEW,
                                               WHISPER_CACHE)
        torch.cuda.synchronize()
    finally:
        attention.flash_attention = plain_call
    counts = (fa.launches, fa.launches_tc, fa.launches_tc_wide, fa.launches_f32,
              fa.launches_simt)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    enc_calls = [c for c in calls if c == (WHISPER_FRAMES, False, True)]
    dec_calls = [c for c in calls if c == (WHISPER_PROMPT, True, True)]
    per_prefill = cfg.num_encoder_layers + cfg.num_layers
    if counts != (per_prefill, per_prefill, 0, 0, 0) or len(calls) != per_prefill:
        fail(f"audio: {counts} flash launches (all, tensor-core, Dh > 128, float32, SIMT) and "
             f"{len(calls)} calls in one request, want {per_prefill} tensor-core launches, "
             "all in the prefill")
    if len(enc_calls) != cfg.num_encoder_layers or len(dec_calls) != cfg.num_layers:
        fail(f"audio: the flash calls were {sorted(set(calls))}, want "
             f"{cfg.num_encoder_layers} non-causal at S {WHISPER_FRAMES} and "
             f"{cfg.num_layers} causal at S {WHISPER_PROMPT}")
    if tokens.shape != (WHISPER_BATCH, WHISPER_NEW):
        fail(f"audio: {tuple(tokens.shape)} tokens, want ({WHISPER_BATCH}, {WHISPER_NEW})")
    first = whisper_prefill_logits(model, frames, prompt)
    if not all(bool(torch.isfinite(x).all()) for x in [first] + logits):
        fail("audio: non-finite logits")
    if not torch.equal(first.argmax(-1), tokens[:, 0]):
        fail("audio: the prefill step's token is not the argmax of the prefill's logits")
    again, _, prefill_ms, decode_ms = whisper_request(model, frames, prompt, WHISPER_NEW,
                                                      WHISPER_CACHE)
    if not torch.equal(again, tokens):
        fail("audio: the timed request gave other tokens than the counted one")
    with torch.inference_mode():
        from repro_torch.launch import ServeEngine
        prefill = ServeEngine(model, is_encdec=True).make_prefill_step()
        top = device_window(lambda: prefill(frames, prompt,
                                            model.init_cache(WHISPER_BATCH, WHISPER_CACHE)),
                            f"{WHISPER} one prefill", "13 audio")
    n_tokens = WHISPER_BATCH * (WHISPER_FRAMES + WHISPER_PROMPT)
    print(f"[13 audio] {WHISPER}: {WHISPER_BATCH} utterances x {WHISPER_FRAMES} frames, a "
          f"{WHISPER_PROMPT}-token prompt, {WHISPER_NEW} greedy tokens, cache "
          f"{WHISPER_CACHE}: {per_prefill} tensor-core flash launches a prefill "
          f"({cfg.num_encoder_layers} non-causal at S {WHISPER_FRAMES}, {cfg.num_layers} causal "
          f"at S {WHISPER_PROMPT}), none in {WHISPER_NEW - 1} decode steps; prefill "
          f"{prefill_ms:.3f} ms ({n_tokens / prefill_ms * 1e3:.0f} frames+tokens/s); decode "
          f"{decode_ms:.3f} ms/step (each recomputes 32 layers' cross K/V, as the JAX package "
          f"does); peak memory {peak_gb:.3f} GB  [{smi}]")
    out = dict(tc=per_prefill, flash_calls=dict(encoder=cfg.num_encoder_layers,
                                                decoder=cfg.num_layers),
               prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, params=n_params,
               prefill_profile=top)
    del model, frames, logits
    torch.cuda.empty_cache()
    return out


def whisper_reference(dev) -> dict:
    """Phase 13c: 2 + 2 layers of whisper at full width in float32 on the card
    (the float32 flash kernel) and on the CPU (its plain version): the
    prefill logits within the float32 serve bounds, WHISPER_CHECK_NEW greedy
    tokens equal, and WHISPER_FAULT planted on the CPU outside the bounds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import EncDecLM
    t0 = time.perf_counter()
    small = dataclasses.replace(get_config(WHISPER), num_layers=2, num_encoder_layers=2)
    card = EncDecLM(small, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    cpu = EncDecLM(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    frames, prompt = whisper_inputs(small, WHISPER_CHECK_BATCH, "cpu", torch.float32)
    fa = ops.flash_attention
    before = fa.launches_f32
    got_tokens, _, _, _ = whisper_request(card, frames.to(dev), prompt.to(dev),
                                          WHISPER_CHECK_NEW, WHISPER_CACHE)
    launched = fa.launches_f32 - before
    got = whisper_prefill_logits(card, frames.to(dev), prompt.to(dev))
    want_tokens, _, _, _ = whisper_request(cpu, frames, prompt, WHISPER_CHECK_NEW,
                                           WHISPER_CACHE)
    want = whisper_prefill_logits(cpu, frames, prompt)
    cpu.cfg = dataclasses.replace(small, **WHISPER_FAULT[1])
    try:
        faulty = whisper_prefill_logits(cpu, frames, prompt)
    finally:
        cpu.cfg = small
    if launched != 4:
        fail(f"audio reference: {launched} float32 flash launches a prefill on the card, want "
             "4 (2 encoder, 2 decoder layers)")

    def drift(x):
        d = (x.float().cpu() - want.float()).abs()
        return d.max().item() / want.abs().max().item(), d.mean().item() / want.std().item()

    max_rel, mean_rel = drift(got)
    fault_max, fault_mean = drift(faulty)
    same = torch.equal(got_tokens.cpu(), want_tokens)
    print(f"[13 audio] reference: 2 + 2 whisper layers at full width in float32, "
          f"{WHISPER_CHECK_BATCH} x {WHISPER_FRAMES} frames, a {WHISPER_PROMPT}-token prompt: "
          f"card vs CPU prefill logits {max_rel:.3e} of max|logit|, {mean_rel:.3e} of the std; "
          f"planted fault ({WHISPER_FAULT[0]}) {fault_max:.3e}, {fault_mean:.3e} (bounds "
          f"{SERVE_F32_MAX_ERR}, {SERVE_F32_MEAN_ERR}); {WHISPER_CHECK_NEW} greedy tokens "
          f"{'equal' if same else 'DIFFERENT'}; {time.perf_counter() - t0:.1f} s")
    if max_rel > SERVE_F32_MAX_ERR or mean_rel > SERVE_F32_MEAN_ERR:
        fail("audio reference: card and CPU logits differ beyond the float32 bounds")
    if fault_max <= SERVE_F32_MAX_ERR and fault_mean <= SERVE_F32_MEAN_ERR:
        fail(f"audio reference: a planted fault ({WHISPER_FAULT[0]}) stays within the bounds")
    if not same:
        fail(f"audio reference: greedy tokens on the card {got_tokens.tolist()} differ from "
             f"the CPU's {want_tokens.tolist()}")
    del card, cpu
    torch.cuda.empty_cache()
    return dict(logits_drift=(max_rel, mean_rel), fault_drift=(fault_max, fault_mean),
                f32_launches=launched)


def phase_audio(dev, smi: str) -> dict:
    """Phase 13: whisper's flash shapes (whisper_kernels), its serve path
    (whisper_serve), 2 + 2 float32 layers card vs CPU (whisper_reference),
    then its training at full width and depth (train_runs) and two float32
    layers of each side card vs CPU (train_reference), which launch no
    hand-written kernel."""
    from repro_torch.kernels.dp_aggregate import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    tc_cases, f32_case = whisper_kernels(dev, smi)
    out = dict(kernels=dict(tc=tc_cases, f32=f32_case), serve=whisper_serve(dev, smi),
               reference=whisper_reference(dev))
    before = (dp_ops.dp_aggregate_sums.launches, fa_ops.flash_attention.launches,
              ssd_ops.ssd_scan.launches)
    out["train"] = train_runs(dev, smi, WHISPER, WHISPER_TRAIN_RUNS, "13 audio")
    out["train_reference"] = train_reference(dev, WHISPER, "13 audio")
    after = (dp_ops.dp_aggregate_sums.launches, fa_ops.flash_attention.launches,
             ssd_ops.ssd_scan.launches)
    if after != before:
        fail(f"audio: the training path launched kernels ({before} -> {after})")
    return out


def main() -> int:
    """Run every phase; 0 only when all of them passed on a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.dp_aggregate import ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in float32 ...
    torch.backends.cudnn.allow_tf32 = False         # ... everywhere
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    timed("1 build", phase_build)
    cases, noise_cases, gathered = timed("2 kernels: dp_aggregate", phase_kernels, dev)
    flash_tc, flash_simt, flash_wide, flash_f32 = timed("2 kernels: flash", phase_flash, dev)
    ssd = timed("2 kernels: ssd_scan", phase_ssd, dev)

    ops.dp_aggregate_sums.launches = 0
    ops.dp_aggregate_sums.gated_launches = 0
    ops.generate_ldp_noise.launches = 0
    timed("3 paper", phase_paper, dev)
    timed("3b e1", phase_e1, dev)
    timed("3c faults", phase_faults, dev)
    timed("3d checkpoints", phase_checkpoints, dev)
    timed("3e e2", phase_e2, dev)
    stream = timed("3f stream", phase_stream, dev, smi)
    e9 = timed("3g e9", phase_e9, dev, smi)
    full = timed("4 full", phase_full, dev, cases)
    full.update(timed("4 full e2", phase_e2_rounds, dev, smi))
    scan = timed("4b scan", phase_scan, dev, smi)
    shard = timed("4c shard", phase_shard, dev, smi)
    launches = {"dp_aggregate": ops.dp_aggregate_sums.launches,
                "ldp_noise": ops.generate_ldp_noise.launches,
                "dp_aggregate gated": ops.dp_aggregate_sums.gated_launches}
    for k, n in launches.items():
        if n < 1:
            fail(f"kernel {k} was never launched on the main path")

    timed("5 reference", phase_reference, dev)
    h2o = timed("6 serve", phase_serve, dev, smi, SERVE_H2O)
    ssd["launches"] = timed("7 serve-ssm", phase_serve_ssm, dev, smi)
    gemma = timed("8 serve-gemma", phase_serve, dev, smi, SERVE_GEMMA)
    f32 = timed("9 serve-f32", phase_serve, dev, smi, SERVE_F32)
    timed("10 train", phase_train, dev, smi)
    zoo = timed("11 serve-zoo", phase_serve_zoo, dev, smi)
    grouped = timed("11b serve-moe-grouped", phase_serve_moe_grouped, dev, smi)
    timed("12 train-zoo", phase_train_zoo, dev, smi)
    audio = timed("13 audio", phase_audio, dev, smi)
    zoo_tc = {spec.name: zoo[spec.name]["tc"] for spec in ZOO_SERVE}
    grouped_tc = {name: grouped[name]["tc"] for name in (GRANITE_MOE, LLAMA4)}
    flash_tc["launches"] = (h2o["tc"] + sum(zoo_tc.values()) + sum(grouped_tc.values())
                            + audio["serve"]["tc"])
    flash_tc["moe_grouped"] = dict(launches=grouped_tc, serve={
        name: {k: grouped[name][k] for k in ("prefill_ms", "decode_ms", "groups")}
        for name in grouped_tc}, reference=grouped["reference"], dryrun=grouped["dryrun"])
    flash_tc["whisper"] = dict(launches=audio["serve"]["tc"],
                               flash_calls=audio["serve"]["flash_calls"],
                               shapes=audio["kernels"]["tc"],
                               serve={k: audio["serve"][k] for k in (
                                   "prefill_ms", "decode_ms", "peak_gb", "params")})
    flash_tc["zoo"] = dict(launches=zoo_tc, shapes=zoo["kernels"]["tc"],
                           serve={spec.name: {k: zoo[spec.name][k] for k in (
                               "prefill_ms", "decode_ms", "peak_gb", "params", "dropped_share")}
                               for spec in ZOO_SERVE})
    flash_wide["launches"] = gemma["tc_wide"]
    flash_wide["simt_prefill_ms"] = gemma["simt_prefill_ms"]
    flash_f32["launches"] = f32["f32"] + h2o["f32_check"] + gemma["f32_check"] + sum(
        r["f32_launches"] for r in zoo["reference"].values()) + sum(
        r["f32_launches"] for r in grouped["reference"].values()) + audio["reference"][
        "f32_launches"]
    flash_f32["whisper"] = dict(shape=audio["kernels"]["f32"], reference=audio["reference"])
    flash_f32["zoo"] = dict(shapes=zoo["kernels"]["f32"], reference=zoo["reference"])
    ssd["launches"] += zoo[ZAMBA2]["ssd_scan"]
    ssd["zoo"] = dict(launches={ZAMBA2: zoo[ZAMBA2]["ssd_scan"]}, shapes=zoo["kernels"]["ssd"])
    flash_f32["serve_f32"] = {k: f32[k] for k in ("prefill_ms", "simt_prefill_ms", "decode_ms",
                                                  "peak_gb", "logits_drift", "fault_drift")}
    # the route-before prefills of phases 8 and 9: the SIMT kernel in place of the dispatch
    flash_simt["launches"] = gemma["simt"] + f32["simt"]

    src = "src/repro_torch/kernels/dp_aggregate/csrc/dp_aggregate.cu"
    head = next(c for c in cases if c["shape"] == [1000, 131072] and c["mode"] == "fused")
    nhead = next(c for c in noise_cases if c["shape"] == [1000, 131072])
    kernels = [
        dict(name="dp_aggregate", route="cuda", source=src,
             replaces="src/repro/kernels/dp_aggregate/kernel.py:99",
             launches=launches["dp_aggregate"], gated_launches=launches["dp_aggregate gated"],
             max_abs_err=max(c["max_abs_err"] for c in cases),
             ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
             bound_by=head["bound_by"], library_ms=None, headline="fused (1000, 131072)",
             cases=cases, gated=gathered["modes"], gated_rows_on=gathered["rows_on"],
             gathered_shape=gathered["gathered_shape"], full_rounds=full, stream=stream,
             e9=e9, scan={k: v for k, v in scan.items() if k != "pointer"}, shard=shard,
             replays_traced={n: scan[n]["scan"]["traced_launches"]["aggregate_kernel"]
                             for n in SCAN_TIMED},
             device_pointer={k: v for k, v in scan["pointer"].items() if "fused" in k}),
        dict(name="ldp_noise", route="cuda", source=src,
             replaces="src/repro/kernels/dp_aggregate/kernel.py:222",
             launches=launches["ldp_noise"],
             max_abs_err=max(c["max_abs_err"] for c in noise_cases),
             ms=nhead["ms"], plain_ms=nhead["plain_ms"], bound_ms=nhead["bound_ms"],
             bound_by=nhead["bound_by"], library_ms=None, headline="(1000, 131072)",
             cases=noise_cases, row_ids_ms=gathered["noise_rows_ms"],
             row_ids_bound_ms=gathered["noise_rows_bound_ms"],
             row_ids_shape=gathered["gathered_shape"],
             replays_traced={n: scan[n]["scan"]["traced_launches"]["noise_kernel"]
                             for n in SCAN_TIMED},
             device_pointer={k: v for k, v in scan["pointer"].items() if "noise" in k}),
        flash_tc,
        flash_simt,
        flash_wide,
        flash_f32,
        ssd,
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
