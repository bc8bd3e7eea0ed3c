"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure fails the run; nothing is caught to exit 0):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the port's kernels from csrc/, timed;
  3. kernels — the paged kernel against its plain PyTorch version on the
               card, at the serving path's shapes for smol-1b (decode over
               slots to 2047 positions, decode over the engine's short
               slots, a 128-token chunk, and the speculative verify's
               windows of 5 rows on 8 slots and 3 rows on 32), in bf16 and
               f32, per output
               row by three scale-free readings, and the same gate shown
               to fail the kernel's output with the rows that read more
               than one KV split scaled by 1.6%; times of kernel (back to
               back over 16 copies of the pools, and one launch on a cold
               L2), plain version, bound and library call, and the kernel
               under the split target `_split_plan` does not choose;
  4. engine  — smol-1b at full width and depth (random weights from a
               seed) behind the paged ServingEngine: 8 temperature-0
               requests, two sharing a 64-token prefix; the kernel's
               launch count over that run; a chunked prefill's logits
               against the dense plain forward;
  4b. spec   — the plain engine and the speculative one (int8 drafter,
               spec_max_draft 4) on phase 4's requests x 64 tokens at 8 of
               smol-1b's 16 layers, plain then spec: decode tok/s, TTFT, acceptance, draft vs
               verify seconds, paged launches per token, a profiled spec
               wave; streams held by the near-tie rule (at the first
               token two temperature-0 streams differ, the dense forward's
               logits put the two within phase 4's tolerance, and each
               token is within it of the dense argmax on its own stream's
               prefix), the rule
               shown failing a stream with a low-logit token put in; the
               same A/B at 4 layers in f32;
  4c. host tier — a pool of 2 x max_blocks under 12 requests over 3
               shared 256-token prefixes: prefix blocks spill and swap back
               (host hits), streams by the near-tie rule against a big
               pool; a speculating slot preempted and resumed, its chain
               in both pools byte for byte before, in the tier and after;
  5. http    — native_server on localhost: models, two chat completions,
               one request's phase trace, the stream's phase_summary,
               metrics (JSON, and Prometheus with the compile-cache
               series), GET /v1/affinity carrying the served prompt's
               chain digests (recomputed with the allocator's chain hash);
               then a second server with --qos-rate 1 --qos-burst 2: a
               burst of 6 chats from one Bearer key gets a 429 with
               Retry-After, another tenant a 200, the per-tenant series;
  5b. service — native_server with examples/deployment/native/service.yml's
               flags (smol-1b, speculation, host tier, 8 of 32 slots
               resident, QoS weights) in a subprocess: 30 best-effort chats
               then 10 paid ones, 64 tokens each; all complete, a
               preemption and a swap-in happened, speculation ran, the
               Prometheus series are there, and every stream holds by the
               near-tie rule against a plain 40-slot engine's;
  3b. flash  — the three flash-attention kernels (forward, dQ, dK/dV)
               against their plain versions at the smol-1b training shape
               (B*H 128, S 2048, hd 128, causal) in bf16 and f32 and at a
               ragged one (S 1000, non-causal, hd 64), and the same gate
               shown to fail the backward's stale-ring-stage faults (dQ
               with a K/V tile counted in place of its successor, dK/dV
               with a Q/dO tile counted twice); times of kernel, plain
               version, bound and the SDPA yardstick, the achieved TFLOP/s
               and share of the bound, and ptxas's registers and spills of
               each kernel's bf16 hd-128 build; the whole backward (delta,
               dQ, dK/dV) against SDPA's backward;
  6. train   — smol-1b at full width and depth, B 8 x S 2048, bf16: two
               warm-up steps, then timed steps with one host readback;
               loss and grad norm finite, loss falling, each flash kernel
               launched 16 times a step (32 for the forward under "full"
               remat); step ms, tokens/s, MFU, peak memory, and a profiled
               step (device busy ms, ms by kernel class);
  6b. model  — smol-1b width at 2 layers, B 2 x S 2048: loss and grads
               through the kernels against plain_attention, f32 and bf16;
  3c. ring step — the ring-step kernel against its plain version
               (`_block_ref_bh`) at the ring step of smol-1b-8k over 4
               shards (B*H 16, S 2048, hd 128), diagonal (causal) and full,
               bf16 and f32, and at a ragged one (S 1000, hd 64, full): o,
               m and l each; times of kernel, plain version, bound and
               SDPA's flash forward, TFLOP/s, share of bound, ptxas;
  7. ring    — smol-1b-8k at full width and depth, B 1 x S 8192 over a
               4-way seq mesh (the ring's 4 shards take turns on the card),
               bf16, remat as resolve_remat answers: two warm-up steps, five
               timed; loss and grad norm finite, loss falling, the ring-step
               kernel launched 10 times per layer (4 diagonal + 6 full
               steps) per forward; step ms, tokens/s, MFU, peak memory, and
               a profiled step; then the same steps single-device through
               the flash kernels, whose first loss the ring's must match;
  7b. ring model — smol-1b-8k width at 2 layers, B 1 x S 8192: loss and
               grads through the ring against plain_attention and against
               the single-device flash kernels, f32 and bf16;
  8. checkpoint — smol-1b at full width and 8 of its 16 layers, B 8 x
               S 2048, bf16: the train state after two steps saved (seconds, GB/s, the
               device-to-host share) and restored into a fresh template,
               bit for bit; one step from the saved state in memory, one
               from each of two restores (both bit for bit): the step from
               a restore must equal the step from the saved state bit for
               bit where the card's step repeats, else lie within 3x its
               spread; whether the embedding gather's backward repeats;
  8b. drain  — a 2-layer smol-1b trainer (B 2 x S 2048) in a subprocess,
               with DSTACK_RUN_NAME and a fresh DSTACK_TPU_COMPILE_CACHE:
               its stage markers in order and one kernel build (a miss);
               SIGTERM after step 2, exit 113 with a checkpoint at step 2
               (the drain's save timed); a relaunch on the same volume and
               cache hits the cache (no build), resumes at step 2 and runs
               to step 5.
  9. LoRA serving — smol-1b, bf16, rank 8 on wq/wv, a bank of 4 slots,
               (a)-(d) at 8 of its 16 layers, (e) at all 16:
               (a) project_qkv_lora at a decode batch (B 8, rows on t1-t3
               and the base) and a 128-token chunk, layers 0 and 7,
               against a per-row plain version by rel_l2 and row_rel, base
               rows equal to project_qkv bit for bit, the gate shown
               failing the indices rolled by a row and -1 read from slot
               0; the LoRA decode program's host syncs against the plain
               one's (set_sync_debug_mode); (b) phase 4's requests, 3 on
               t1, 3 on t2, 2 base, plain then LoRA: decode tok/s,
               TTFT, launches, the LoRA engine with no adapter in flight, a
               profiled mixed wave (the delta as its own class); adapter
               streams by the near-tie rule against a plain engine on the
               merged params, base streams against the plain engine, each
               adapter changing a shared prompt's stream; (c) speculation
               with t1 and the base mixed; (d) 4c(b)'s preempt, park and
               resume on t1, byte for byte, its bank slot restored; (e)
               native_server with --adapter t1=random and t2=<npz>: models,
               chats, DELETE, POST /v1/adapters, the adapters_loaded gauge;
  10. LoRA train — smol-1b, B 8 x S 2048, phase 6's base and batch: the
               step-0 loss equal to the full model's bit for bit, A's
               step-0 gradient 0, the base unchanged after 7 steps, B off 0,
               the loss falling; step ms, tokens/s, MFU from the step's own
               products (formula printed), peak memory, flash launches per
               step, a profiled step, beside phase 6;
  10b. LoRA at 2 layers — the LoRA loss and adapter grads through the
               flash kernels against plain attention (f32, bf16), through
               the ring over 4 shards (smol-1b-8k, S 8192) against the
               single device, a LoRA checkpoint continued bit for bit, and
               `fine_tune --lora-rank 8` (full depth, S 512) in a
               subprocess: SIGTERM -> 113 with an adapter checkpoint, a
               relaunch resumes, native_server serves its merged export.
  11. disaggregation — smol-1b, bf16: (a, at 8 of its 16 layers) a prefill engine and a decode
               engine joined by the port's TransferServer/TransferClient
               over localhost TCP, phase 4's 8 requests and the drill's
               awkward lengths (mid-block end, chunk remainder, a decode
               across a block boundary, a one-token request completed on the
               prefill tier), unified, split, split, unified: streams by the
               near-tie rule (bit-exact count printed), zero residue on both
               pools, bytes sent = admitted = off the wire, the paged kernel
               on both tiers (launches by thread), a handoff's logits
               through the kernel within phase 4's tolerance and its faults
               (tail block exchanged, a block zeroed) beyond it, a
               tail-swapped handoff admitted by the decode engine failing
               the near-tie rule against the unified stream, a stale
               payload rejected after bump_handoff_epoch, a cancel
               mid-handoff; handoff bytes, transfer s and GB/s, TTFT legs,
               decode tok/s, and inter-token p95 of 4 live streams under a
               flood of 6 x 1800-token prompts against the unified engine
               (recorded, not gated: one card's tiers share its SMs); (b)
               `python -m dstack_tpu_torch.workloads.serving_disagg --device
               cuda --preset smol-1b` in a subprocess, exit 0 with its own
               checks; (c) native_server --role decode/prefill in two
               subprocesses: kv_handoff ack, /v1/handoffs/<id> streaming the
               unified server's tokens by the near-tie rule, the
               role-labelled series.
  12. RL (Podracer) — (a) smol-1b at 4 of its 16 layers Anakin, bf16, batch 8, 64-token
               prompts x 64 new tokens (the target the token the untrained
               policy samples most in a warm-up round), 3 updates over the
               socket weight-refresh channel and 1 each over the
               in-process and checkpoint channels: rollout seconds and env
               steps/s (the paged kernel), the PPO step's ms (the flash
               kernels forward and backward), the weights frame's bytes
               and publish, pull and adopt seconds and GB/s, launches of
               kernels #1-#4 per update; gates: the adopted engine weights
               equal the published ones by sha1 per leaf (shown failing a
               flipped bit), a learner update after a publish leaves the
               published snapshot and the actor's engine weights unchanged
               bit for bit (shown failing an engine that shares the
               learner's tensors), clip_fraction 0 on each update's
               on-policy batch (shown failing a scorer shifted by one
               position), refresh_params refusing a busy engine; (b)
               `run_anakin`'s defaults on the tiny RL policy (f32, hd 32)
               twice: the last five updates' mean reward above the first
               five's and above 0.3, and whether the two runs repeat bit
               for bit; (c) `python -m dstack_tpu_torch.workloads.rl_drill
               --updates-per-phase 1`: learner and actors as processes on
               the one card, the reference drill's summary asserts.
  13. MoE — smol-moe (8 experts, top-2, the preset's cf 1.25), bf16,
               random from seed 0: (a) moe_mlp at one layer against a
               per-expert f32 loop on its own routing (16 tokens at cf
               n_experts/k = 4.0, where nothing drops; a 128-token chunk at
               cf 0.5, where much does) and einsum against gather (1 x 128,
               2 x 2048), the gate shown failing the second choice dropped,
               the gate unnormalised and a dropped choice computed; both
               dispatches timed, forward and forward + backward; (b) 4
               layers behind the paged engine, phase 4's requests: at cf 4.0
               the dense check with the dense run pinned to the chunks'
               routing (flips counted unpinned; shown failing a layer routed
               to shifted experts), plain and spec (int8 MoE drafter) waves;
               at cf 1.25 two plain waves identical, a 128-token chunk's
               drop fraction; then in f32 at cf 4.0 the dense check and
               plain and spec waves held by the near-tie rule (in bf16 the
               two paths' rounding flips top-k for some tokens, whose MLP
               output then jumps: the rule holds an MoE model only in f32);
               decode tok/s, TTFT, paged launches; `native_server --preset
               smol-moe --spec-enable` in a subprocess answers a chat; (c) training
               at 8 of its 16 layers, B 2 x S 2048, einsum, gather, gather, einsum:
               step ms, tokens/s, MFU (active experts' FLOPs, not the
               dispatch's), peak memory, router_aux, flash launches; at 2
               layers the kernels against plain attention with the plain
               run pinned to the kernel run's routing, f32 and bf16.
  14. tensor parallelism — (c) the paged kernel against its plain version
               at a rank's heads of smol-1b on a model axis of 2 (H 8, KV 4),
               decode and chunk, bf16 and f32, the bf16 decode timed; two
               processes of this script (--tp-rank, --rank 0/1) over gloo on
               the one card serve smol-1b at 8 layers sharded, bf16, f32 and a
               mutant: (a) 8 streams by the near-tie rule against the
               unsharded engine (bit-for-bit count printed), (b) each rank's
               prompt-block pools against its heads of the unsharded pool,
               (d) a launch per layer per decode step on each rank, (e) both
               gates failing the two ranks' heads swapped in the attention
               output's all-gather; decode tok/s, TTFT and the staged
               all-gathers per decode step recorded (gloo, two ranks on one
               card: not a TP speed); (f) a world-1 NCCL group's short wave
               in a process of its own (--tp-nccl --tr-nccl, 15(f) after it); (g) in the same rank
               processes, the RL actor on the model-2 mesh at 8 layers: one
               f32 round (8 x 64-token prompts x 64 new, temperature 1)
               token for token against the one-device actor's with the
               leader's admission gate held over it, the engine's score op
               (#2 once a layer on each rank) against the one-device scorer
               in f32 and bf16 (RL_LOGP_TOL), a frame adopted into both
               ranks' slices by sha1, failing a refresh only the leader takes.
  15. training across ranks — (c) the three flash kernels against their
               plain versions at a rank's geometry of smol-1b's training
               step (B*H 64, S 2048, hd 128: 8 rows x 8 q heads at model 2,
               4 rows x 16 at fsdp 2), bf16 and f32, timed; two processes of
               this script (--tr-rank, --rank 0/1) over gloo on the one card
               train smol-1b at full width and depth at fsdp 2 and model 2
               on a global batch of 8 x 2048, against the unsharded step on
               the same card, weights and batch: (a) the first step's loss
               and grad_norm, (b) every param after 2 steps (rel_l2,
               row_rel), the same at 2 layers in f32 with tight limits, and
               a checkpoint saved from the fsdp-2 ranks restored on one
               device with equal params, (d) 16 launches of each kernel per
               step on each rank at the rank's geometry, (e) the param gate
               failing a step whose fsdp reduce-scatter keeps each rank's
               own grads and one whose row-parallel sums are skipped; step
               ms, collectives per step and their ms, peak memory per rank
               recorded (gloo, two ranks on one card: a check, not a
               parallel speed); (f) a world-1 NCCL training step, its
               checkpoint saved and restored, in a process of its own
               (run in phase 14's NCCL process); (g) in the same rank processes, LoRA rank 8 on the
               row-parallel wo and w_down over model 2 (each rank gathers both
               factors whole) against the unsharded LoRA run, 2 steps at full
               depth in bf16 and at 2 layers in f32: the first step's loss and
               grad_norm, the adapters after the steps, #2 once a layer a
               step on each rank and #3, #4 once a layer but the first (no
               target sits before its attention); the grad_norm gate failing the whole
               factors' grads summed over the column targets' axes (f32);
               (h) in the same rank processes, the PPO learner (rl.Learner on
               the mesh) at 8 layers, bf16, fsdp 2 and model 2, on an RL
               batch of 8 x 128 against the one-device learner: the first
               update's loss, every param after 2 updates, the same at 2
               layers in f32 with three mutants (the entropy from a rank's
               vocab columns, a rank's own mask count, grads not summed over
               the batch axes) each failing its gate; #2-#4 8 an update on
               each rank at (64, 127, 128); the published frame the unshard
               of the ranks' slices leaf for leaf.
  16. the ring across ranks — four processes of this script (--rg-rank,
               --rank 0-3) over gloo on the one card train smol-1b-8k at
               full width and depth, B 1 x S 8192, at seq 4 (2048 positions
               a rank, the ring's K/V hops between the processes) against
               phase 7's one-device ring on the same card, weights and
               batch: (a) the first step's loss and grad_norm, (b) every
               param after 2 steps (rel_l2, row_rel) and the four ranks'
               replicas equal, the same at 2 layers in f32, (d) kernel #5
               launched i + 1 times a layer on rank i (10 over the ranks,
               each at phase 3c's B*H 16, S 2048) and 7 hops a layer on
               each, (e) the gates failing every hop sent to the wrong
               neighbour and the dK/dV accumulators stopped one hop short
               of home (in f32 at 2 layers); step ms, hops and their MB and
               ms, the grad all-reduce over seq, peak memory per rank
               recorded (gloo, four ranks on one card: a check, not a
               parallel speed).
  17. the pipeline — (c) kernels #2-#4 against their plain versions at a
               stage's geometry (B*H 32: a 2-row microbatch), bf16 and f32,
               timed; two processes of this script (--pp-rank) over gloo
               on the one card train smol-1b in two stages of 8 layers, B 8
               x 2048 in 4 microbatches, against phase 6's unsharded step
               on the same card, weights and batch: (a) the first step's
               loss and grad_norm, (b) every param after 2 steps and the
               shared leaves equal on both stages bit for bit, the same at
               2 layers in f32, (d) 32 launches of each of #2-#4 a stage a
               step at B*H 32 and 8 exchanges a stage a step, (e) the gates
               failing a microbatch collected one tick early and the shared
               grads not summed over pipe (f32, 2 layers); step ms,
               exchanges and their MB and ms, peak memory per stage.
  18. expert parallelism — two processes of this script (--ep-rank) over
               gloo on the one card train smol-moe at full width and 8 of its
               16 layers (einsum, bf16, B 2 x 2048) on an expert axis of 2
               (4 experts a rank) against an unsharded 8-layer run on the same
               card, weights and batch: (a) the first step's loss, grad_norm
               and router_aux, (b) every param after 2 steps, the same at 2
               layers in f32 with three mutants (the expert block off by one,
               enter_expert without its all-reduce, gather_experts' backward
               summed), each failing the gate that guards it; (d) 8 launches
               of each of #2-#4 a step on each rank at B*H 32; step ms,
               collectives per step with their MB and ms, peak memory per rank;
               (g) in the same rank processes, LoRA rank 8 on wq/wv over the
               expert axis against the unsharded LoRA run, 2 steps at 8 layers
               in bf16 and at 2 layers in f32, the grad_norm gate failing the
               grads also summed over the expert line (f32); (c) the same two
               ranks serve smol-moe at 8 layers on an expert-2 serving mesh
               (4 experts and all 16 heads a rank), phase 4's requests at cf
               4.0, against the unsharded engine: f32 streams token for
               token, bf16 token for token with every routed call pinned to
               the unsharded routing (RoutingSpy), the f32 streams changed by
               the expert blocks swapped in the outputs' gather, #1 once a
               layer a decode step on each rank.
  19. the gang — (a) `python -m dstack_tpu_torch.fine_tune --ranks 2
               --device cuda:0 --dist-backend gloo` (smol-1b at full width and
               depth, B 8 x 2048, fsdp 2, 2 steps, --checkpoint-dir) on one
               host, then the same command as two host processes
               (`chip_smoke.py --gang-host`, which runs fine_tune's main and
               counts around it) given JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID
               0 and 1 and JAX_NUM_PROCESSES=2, one rank each: both exit 0,
               each prints its process line, the gang's export equals the one
               host's byte for byte and its step lines the one host's; each
               host's step ms, peak memory and #2-#4 launches a step (16 each
               at B*H 64); (b) `python -m dstack_tpu_torch.run_rl --mode
               sebulba --updates 3` as the learner and one actor
               (DSTACK_NODE_RANK 0 and 1, DSTACK_NODES_NUM=2): both exit 0,
               the epochs reach 4, the seconds. gloo on one card: a check of
               the rendezvous, not a speed.
  20. MoE over a seq axis of ranks — (c) kernel #5 against its plain
               version at a seq rank's geometry (B*H 32, S 1024, hd 128),
               diagonal and full, bf16 and f32, timed; two processes of this
               script (--ms-rank) over gloo on the one card train smol-moe at
               full width and 4 of its 16 layers (einsum, bf16, B 2 x 2048,
               the preset's cf 1.25, where choices drop) at seq 2 (each rank
               1024 positions of each row, routed at the whole row's capacity
               and slots) against the one-device seq-2 ring on the same card,
               weights and batch, each layer of the ranks pinned to its
               routing (RoutingSpy; the flips under the pin counted): (a) the
               first step's loss, grad_norm and router_aux, (b) every param
               after 2 steps and both ranks' replicas equal, the same at 2
               layers in f32 with three mutants (the capacity from a rank's
               stretch, the slots without the earlier rank's picks, the slots
               without the earlier choices' picks), each failing the loss
               gate; (d) #5 launched i + 1 times a layer on seq rank i and no
               other flash kernel, 3 hops and one all-gather of the routing
               counts a layer; step ms, hops and collectives with their MB and
               ms, peak memory per rank, the drops a layer.
Phase 3b and 3c run after 3, 4b and 4c after 4, 5b after 5, 11 after
5b, 12 after 11, phases 6 to 10b after 12, 13 after 10b, 14 after 13, 15
after 14, 16 and 17 after 15, 18 after 17, 19 after 18, 20 after 19. The line before the
last is the `kernels` JSON; the last line is {"ok": true, "device": {...}}.
Each phase logs its numbers on the way; details also go to
chiprun_out/chip_smoke.json.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

from dstack_tpu_torch.workloads.serving_disagg import NEAR_TIE_TOL, dense_logits, near_tie

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and ops/s for
# the type the kernel computes on (bf16 tensor-core peak for bf16 inputs,
# non-tensor f32 for f32 inputs).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The paged kernel against its plain version: three scale-free readings
# over the output rows (b, i, h), (rel_l2, row_rel, row_l2); see
# paged_readings. A max |diff| over the whole output would be set by the
# shortest slot, whose rows are ~8x a 2047-position slot's (max |o| 0.74
# against 0.088), and so would pass a 1.6% error in every long slot; one
# rel_l2 over the output is set by the short slots too, and row_rel's
# noise (one element's rounding) is above 1.6%, so only row_l2 fails a
# 1.6% error confined to some rows. bf16 — the kernel is one-pass and
# rounds p to bf16 relative to its running max, the plain version
# two-pass at the final (m, l); f32 — summation order only. Each limit is
# ~3x the largest reading of the unsplit kernel that the split-KV one
# replaced, on the H100, over these cases
# and tests/test_torch_cuda.py's (PERF.md §2), but bf16 row_l2's: that
# kernel reads up to 5.4e-3 there, 3x would pass the 1.6% fault, so its
# limit is 2.2x. Each run checks that the kernel's output with the rows
# that read more than one KV split scaled by MUTATION_SCALE fails it, as
# a combine that mis-weighs splits would leave it.
PAGED_TOL = {torch.bfloat16: (1e-2, 2.5e-2, 1.2e-2), torch.float32: (2.6e-6, 1.1e-5, 4.7e-6)}
MUTATION_SCALE = 1.016
# Distinct copies of a case's pools that the back-to-back timer rotates
# over, as a decode step reads 16 layers' pools: 16 x 67 MB (bf16) is far
# past the 50 MB L2, so each launch reads its K/V from HBM.
PAGED_COPIES = 16
# Chunked-prefill logits (paged, through the kernel) against the dense
# plain forward, max |diff| / max |ref| over 16 layers.
# The near-tie rule (dense_logits, near_tie) and its table are the drill's.
ENGINE_LOGIT_TOL = NEAR_TIE_TOL
# The benchmark cells' attention geometry (Mistral-7B, Mixtral-8x7B) and
# the (S, start) of their prompt chunks that phase 3 times: docs' pow-2
# chunks at start 0, a chunk after chat's reused prefix.
CELL_GEO = dict(H=32, KV=8, hd=128, bs=16)
CELL_CHUNKS = ((2048, 0), (4096, 0), (8192, 0), (4096, 1536))
# The grid over which run_prefill_crossover times both kernels.
CROSSOVER_S = (16, 32, 64, 128, 256, 512)
CROSSOVER_STARTS = (0, 1024, 3072, 6144)
PAGED_KERNEL_SOURCE = "dstack_tpu_torch/workloads/csrc/paged_attention.cu"
PAGED_KERNEL_REPLACES = "dstack_tpu/workloads/paged_attention.py:222"
FLASH_KERNEL_SOURCE = "dstack_tpu_torch/workloads/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "dstack_tpu/workloads/flash_attention.py:219",
    "flash_bwd_dq": "dstack_tpu/workloads/flash_attention.py:256",
    "flash_bwd_dkv": "dstack_tpu/workloads/flash_attention.py:294",
    "flash_block_fwd": "dstack_tpu/workloads/flash_attention.py:455",
}
# Flash kernels against plain versions: two scale-free readings per
# output (O, dQ, dK, dV), see flash_errors; the limit holds both. One max
# over the whole tensor would be set by the first rows of a causal head,
# whose values are ~20x a late row's at S 2048, and so would pass an error
# of a late row's typical size. bf16 — the kernels round P and dS to bf16
# before their products, the plain versions keep f32, both round every
# output to bf16. f32 — summation order only. Each (rel_l2, row_rel)
# limit is ~3x the largest reading of sound runs on the H100 (here and in
# tests/test_torch_cuda.py; PERF.md): bf16 2.75e-3 and 8.06e-3, f32
# 6.3e-7 and 4.04e-6.
FLASH_TOL = {torch.bfloat16: (9e-3, 2.5e-2), torch.float32: (2e-6, 1.2e-5)}
# A row whose exact value is 0 by cancellation (the first query's dQ on a
# causal head: P = 1, so dS = P (dP - delta) = 0) is held against this
# share of the tensor's RMS instead of its own max.
ROW_FLOOR = 1e-2
# lse is f32 for both input dtypes: max |diff| (a log, so relative to l);
# sound runs read 9.5e-7, one f32 ulp at |lse| in [8, 16).
LSE_TOL = 3e-6
# Inside the model (6b): loss |d|/|ref|, and per-leaf grad
# ||g - g_ref|| / ||g_ref||, kernels against plain_attention. bf16 —
# plain_attention rounds probs to bf16 but differentiates the softmax in
# f32 from them, the kernels recompute P in f32 and round P and dS.
MODEL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (5e-3, 5e-2)}
# The ring-step kernel against `_block_ref_bh` (3c): its unnormalised o by
# FLASH_TOL's two scale-free readings, its m by max abs error and its l by
# max relative error (both f32 for either input dtype: the same logits
# summed in another order). ~3x the largest sound reading on the H100
# (here and in tests/test_torch_cuda.py, against plain and float64; PERF.md):
# m 2.5e-6, l 2.6e-6.
BLOCK_STAT_TOL = {torch.bfloat16: (8e-6, 8e-6), torch.float32: (8e-6, 8e-6)}
RING_SHARDS = 4
H100_BF16_PEAK = 989e12
OUT = "chiprun_out/chip_smoke.json"


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms_one(fn, iters: int, flush: torch.Tensor = None) -> float:
    """Median device time of fn() in ms over `iters` runs, each bracketed
    by CUDA events right after the host's call on an idle card (so a short
    kernel also reads its launch latency); `flush` is rewritten before
    each run (outside the events) so the run finds the 50 MB L2 cold, as a
    layer of the real model finds its pool."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms(fns, n: int, graph: bool = True) -> float:
    """Device time of one call in ms: `n` calls back to back between one
    pair of CUDA events, over `n`, the calls rotating over `fns` (each a
    call on its own copy of the inputs, or one call). With `graph` the n
    calls are captured in one CUDA graph and replayed, so no host gap
    (the wrappers' Python checks) sits between two launches; a call that
    syncs with the host (the plain versions) is timed with `graph=False`."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    for f in fns:  # warm-up: builds, allocator
        f()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(n):
                fns[i % len(fns)]()
        g.replay()  # the first replay uploads the graph
        torch.cuda.synchronize()
        a.record()
        g.replay()
        b.record()
    else:
        a.record()
        for i in range(n):
            fns[i % len(fns)]()
        b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# -- phase 3: kernels --------------------------------------------------------


def paged_case(name, dtype, B, S, H, KV, hd, bs, MB, NB, start, seed):
    """Random pool and sentinel-padded tables; slot b holds start[b] + S
    positions and its row i attends positions < start[b] + 1 + i. Every
    position no row may see is filled with NaN."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    kp = torch.randn((NB, bs, KV, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((NB, bs, KV, hd), generator=g, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=g, device=dev).tolist()
    tables = torch.full((B, MB), NB, dtype=torch.int32)
    vlen = torch.zeros((B, S), dtype=torch.int32)
    used = set()
    c = 0
    for b in range(B):
        last = start[b] + S                      # positions the slot holds
        nblk = (last + bs - 1) // bs
        blocks = perm[c:c + nblk]
        c += nblk
        tables[b, :nblk] = torch.tensor(blocks, dtype=torch.int32)
        vlen[b] = torch.arange(start[b] + 1, start[b] + S + 1)
        used.update(blocks)
        tail = last - (nblk - 1) * bs            # rows used in the last block
        kp[blocks[-1], tail:] = float("nan")
        vp[blocks[-1], tail:] = float("nan")
    unused = torch.tensor(sorted(set(range(NB)) - used), dtype=torch.int64, device=dev)
    kp[unused] = float("nan")
    vp[unused] = float("nan")
    return dict(name=name, dtype=dtype, q=q, k=kp, v=vp,
                tables=tables.to(dev), vlen=vlen.to(dev))


def paged_work(case) -> tuple:
    """(bytes, operations) one call needs: q, tables, valid lengths and
    the K/V rows its slots hold read once, the output written once; QK^T +
    PV on the keys each row sees."""
    q, k, tables, vlen = case["q"], case["k"], case["tables"], case["vlen"]
    B, S, H, hd = q.shape
    NB, bs, KV, _ = k.shape
    es = q.element_size()
    slot_len = vlen.max(dim=1).values.clamp(max=tables.shape[1] * bs)
    kv_bytes = int(slot_len.sum()) * KV * hd * es * 2
    nbytes = (kv_bytes + 2 * q.numel() * es + tables.numel() * 4 + vlen.numel() * 4)
    ops = int(vlen.clamp(max=tables.shape[1] * bs).sum()) * H * hd * 4
    return nbytes, ops


def paged_bound(case) -> tuple:
    """(bound_ms, bound_by) for one call: `paged_work`'s bytes over HBM
    bandwidth against its operations over the type's peak."""
    nbytes, ops = paged_work(case)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[case["q"].dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_readings(got, ref, heads: int) -> dict:
    """Readings of a paged output against its reference over the output
    rows (b, i, h): flash_errors' rel_l2, row_rel, max_abs_err and
    ref_max, and row_l2, the largest over rows of ||got - ref|| / ||ref||
    in the row (floored at ROW_FLOOR x the RMS row norm)."""
    B, S, _ = ref.shape
    g, r = (x.reshape(B, S, heads, -1) for x in (got, ref))
    out = dict(zip(("rel_l2", "row_rel", "max_abs_err", "ref_max"), flash_errors(g, r)))
    d, rn = (g.double() - r.double()).norm(dim=-1), r.double().norm(dim=-1)
    floor = max(ROW_FLOOR * float(rn.square().mean().sqrt()), 1e-30)
    out["row_l2"] = float((d / rn.clamp_min(floor)).max())
    return out


def within(readings: dict, tol: tuple) -> bool:
    return all(readings[k] <= t for k, t in zip(("rel_l2", "row_rel", "row_l2"), tol))


def split_mutant(got, vlen, keys_per_split: int):
    """got with the rows that read more than one KV split of
    `keys_per_split` positions (valid_len > keys_per_split) scaled by
    MUTATION_SCALE, every row where none does: what a combine that
    mis-weighs the splits by 1.6% would give."""
    rows = vlen > keys_per_split
    if not bool(rows.any()):
        rows = torch.ones_like(rows)
    return torch.where(rows[..., None], got.double() * MUTATION_SCALE, got.double())


def sdpa_inputs(case):
    """The dense (B, MB*bs) view of each slot and a key mask, for the
    library yardstick (torch SDPA), which the port never calls."""
    q, k, v, tables, vlen = (case[x] for x in ("q", "k", "v", "tables", "vlen"))
    B, S, H, hd = q.shape
    NB, bs, KV, _ = k.shape
    MB = tables.shape[1]
    safe = tables.clamp(max=NB - 1).to(torch.int64)
    dk = k[safe].reshape(B, MB * bs, KV, hd).transpose(1, 2).contiguous()
    dv = v[safe].reshape(B, MB * bs, KV, hd).transpose(1, 2).contiguous()
    real = (tables < NB).repeat_interleave(bs, dim=1)            # (B, MB*bs)
    kpos = torch.arange(MB * bs, device=q.device)
    mask = (kpos[None, None, :] < vlen[:, :, None]) & real[:, None, :]
    dk = torch.where(mask.any(1)[:, None, :, None], dk, torch.zeros_like(dk))
    dv = torch.where(mask.any(1)[:, None, :, None], dv, torch.zeros_like(dv))
    return q.transpose(1, 2).contiguous(), dk, dv, mask[:, None]


def run_kernels(flush):
    from dstack_tpu_torch.workloads import paged_attention as pa

    # smol-1b serving shapes: H 16, KV 8, hd 128, block 16, MB 2048/16.
    # Decode over slots to 2047 positions, decode over slots as short as
    # the engine wave's (to 269 positions), a 128-token chunk, and the
    # speculative verify's windows: k+1 = 5 rows on 8 slots of 106 to 2047
    # positions, and 3 rows on 32 slots of 104 to 1998 (each row i of slot
    # b attends start[b] + 1 + i positions). Then the shapes of phases 4c
    # and 5b (service.yml: 256-token chunks, block 32, 32 slots, k <= 4):
    # a 256-token chunk at block 16 and at block 32, and at block 32
    # (MB 2048/32) decode on 32 slots of 38 to 1991 positions and the
    # verify's k+1 = 5 rows on 32 slots of 106 to 1997.
    geo = dict(H=16, KV=8, hd=128, bs=16, MB=128, NB=1024)
    geo32 = dict(geo, bs=32, MB=64, NB=2304)
    decode_lens = [37, 200, 513, 1000, 1499, 1801, 2046, 64]
    short_lens = [100, 124, 148, 172, 196, 220, 244, 268]
    verify_lens = [101, 300, 517, 999, 1203, 1640, 1888, 2042]
    verify32_lens = [101 + 61 * i for i in range(32)]
    decode_bs32_lens = [37 + 63 * i for i in range(32)]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append(paged_case(f"decode_{tag}", dtype, B=8, S=1, **geo,
                                start=decode_lens, seed=1))
        cases.append(paged_case(f"decode_short_{tag}", dtype, B=8, S=1, **geo,
                                start=short_lens, seed=3))
        cases.append(paged_case(f"prefill_{tag}", dtype, B=1, S=128, **geo,
                                start=[384], seed=2))
        cases.append(paged_case(f"verify_{tag}", dtype, B=8, S=5, **geo,
                                start=verify_lens, seed=4))
        cases.append(paged_case(f"verify32_{tag}", dtype, B=32, S=3,
                                **{**geo, "NB": 2304}, start=verify32_lens, seed=5))
        cases.append(paged_case(f"chunk256_{tag}", dtype, B=1, S=256, **geo,
                                start=[384], seed=6))
        cases.append(paged_case(f"chunk256_bs32_{tag}", dtype, B=1, S=256, **geo32,
                                start=[384], seed=7))
        cases.append(paged_case(f"decode_bs32_{tag}", dtype, B=32, S=1, **geo32,
                                start=decode_bs32_lens, seed=8))
        cases.append(paged_case(f"verify_bs32_{tag}", dtype, B=32, S=5, **geo32,
                                start=verify32_lens, seed=9))
    # The benchmark cells' prompt chunks (Mistral-7B's attention: H 32, KV
    # 8, hd 128, block 16), bf16 only, which takes the prefill kernel:
    # docs' chunks at start 0, and a chunk after chat's reused prefix.
    for S, start in CELL_CHUNKS:
        n = -(-(start + S) // 16)
        cases.append(paged_case(f"cell{S}_at{start}_bf16", torch.bfloat16, B=1, S=S,
                                **CELL_GEO, MB=n, NB=n + 16, start=[start], seed=10 + S + start))
    results = []
    for case in cases:
        args = (case["q"], case["k"], case["v"], case["tables"], case["vlen"])
        got = pa._ragged_attention_cuda(*args)
        ref = pa._ragged_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{case['name']}: kernel output not finite")
        tol, heads = PAGED_TOL[case["dtype"]], case["q"].shape[2]
        r = dict(case=case["name"], **paged_readings(got, ref, heads))
        plan = paged_plan(pa, case)
        mutant = paged_readings(split_mutant(got, case["vlen"], plan.keys_per_split), ref, heads)
        r["mutation"] = dict(scale=MUTATION_SCALE, caught=not within(mutant, tol),
                             **{k: mutant[k] for k in ("rel_l2", "row_rel", "row_l2")})
        r["split_plan"] = plan._asdict()
        prefill = prefill_plan(pa, case)
        r["prefill_plan"] = prefill._asdict() if prefill else None
        log(f"kernel {case['name']}: " + json.dumps(r) + f" (tol {tol})")
        results.append(r)
        del got, ref
    for case, r in zip(cases, results):  # every case's readings are logged first
        tol = PAGED_TOL[case["dtype"]]
        if not within(r, tol):
            raise AssertionError(f"{case['name']}: readings {r} past {tol}")
        if not r["mutation"]["caught"]:
            raise AssertionError(f"{case['name']}: the gate passes an output with its"
                                 f" multi-split rows scaled by {MUTATION_SCALE}")
    for case, r in zip(cases, results):
        args = (case["q"], case["k"], case["v"], case["tables"], case["vlen"])
        r.update(paged_times(pa, case, pa._ragged_attention_plain(*args), flush))
        log("kernel timing", json.dumps(r))
    return results


def run_prefill_crossover(flush) -> list:
    """Where the prefill kernel starts to beat the split kernel: both at
    short bf16 chunks of the cells' geometry (the prefill kernel forced
    below PREFILL_MIN_ROWS), CROSSOVER_S x CROSSOVER_STARTS, back to back
    over PAGED_COPIES copies of the pools; each output first held against
    the plain version."""
    from dstack_tpu_torch.workloads import paged_attention as pa

    out = []
    for S in CROSSOVER_S:
        for start in CROSSOVER_STARTS:
            n = -(-(start + S) // 16)
            case = paged_case(f"x{S}_at{start}", torch.bfloat16, B=1, S=S, **CELL_GEO, MB=n,
                              NB=n + 16, start=[start], seed=20 + S + start)
            args = (case["q"], case["k"], case["v"], case["tables"], case["vlen"])
            grid = pa._prefill_grid(1, S, CELL_GEO["H"], CELL_GEO["H"] // CELL_GEO["KV"])
            plans = dict(prefill=grid, split=paged_plan(pa, case))
            ref = pa._ragged_attention_plain(*args)
            r = dict(S=S, start=start, bound_ms=paged_bound(case)[0])
            copies = [{**case, "k": case["k"].clone(), "v": case["v"].clone()}
                      for _ in range(PAGED_COPIES)]
            for name, plan in plans.items():
                got = pa._ragged_attention_cuda(*args, plan=plan)
                rd = paged_readings(got, ref, CELL_GEO["H"])
                if not within(rd, PAGED_TOL[torch.bfloat16]):
                    raise AssertionError(f"crossover {case['name']} {name}: readings {rd}")
                kern = [lambda c=c, plan=plan: pa._ragged_attention_cuda(
                    c["q"], c["k"], c["v"], c["tables"], c["vlen"], plan) for c in copies]
                r[f"{name}_ms"] = cuda_ms(kern, 4 * PAGED_COPIES)
                r[f"{name}_ms_one_launch"] = cuda_ms_one(kern[0], 50, flush)
            log("prefill crossover", json.dumps(r))
            out.append(r)
            del copies, case, ref
    torch.cuda.empty_cache()
    return out


def paged_plan(pa, case, per_sm=None):
    """`_split_plan` of a case's shapes on this card."""
    B, S, H, hd = case["q"].shape
    _, bs, KV, _ = case["k"].shape
    return pa._split_plan(B, S, H, KV, case["tables"].shape[1], bs, hd, case["dtype"],
                          pa._device_info(case["q"].device.index)[1], per_sm)


def prefill_plan(pa, case):
    """`_prefill_plan` of a case's shapes (None where the call stays on
    the split kernel)."""
    B, S, H, hd = case["q"].shape
    _, bs, KV, _ = case["k"].shape
    return pa._prefill_plan(B, S, H, KV, case["tables"].shape[1], bs, hd, case["dtype"])


def paged_call_breakdown(kern, n: int = 32) -> dict:
    """Where one call's time goes: the host's time to enqueue it (the
    wrapper's checks and plan, the workspace, the ctypes launch; n calls
    timed on the host clock, the card kept busy behind them), and each
    of its kernels' device time per call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        kern[i % len(kern)]()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            kern[i % len(kern)]()
        torch.cuda.synchronize()
    by_name = {}
    for name, us, _ in device_kernels(prof):
        key = "combine" if "combine" in name else "main"
        by_name[key] = by_name.get(key, 0) + us
    return dict(host_us_per_call=host_us,
                profiled_ms_per_call={k: v / 1e3 / n for k, v in by_name.items()})


def paged_times(pa, case, ref, flush) -> dict:
    """The kernel and SDPA on the gathered dense view timed back to back
    over PAGED_COPIES distinct copies of the pools (`ms`, `library_ms`) and
    one launch at a time on a cold L2 (`ms_one_launch`,
    `library_ms_one_launch`); the plain version one call at a time; and
    the kernel back to back under the split target (CTAs per SM) that
    `_split_plan` does not choose of 4 and 8 (`other_plan`), which the
    chosen one should beat; for a case that takes the prefill kernel, the
    split kernel it took before (`split_kernel`) and the prefill kernel
    with one query head a CTA (`pack1_ms`) in its place."""
    args = (case["q"], case["k"], case["v"], case["tables"], case["vlen"])
    copies = [{**case, "k": case["k"].clone(), "v": case["v"].clone()}
              for _ in range(PAGED_COPIES)]
    kern = [lambda c=c: pa._ragged_attention_cuda(c["q"], c["k"], c["v"], c["tables"],
                                                  c["vlen"]) for c in copies]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = [sdpa_inputs(c) for c in copies]
    lib = [lambda x=x: sdpa(x[0], x[1], x[2], attn_mask=x[3], enable_gqa=True) for x in views]
    lib_out = lib[0]()
    lib_err = float((lib_out.transpose(1, 2).reshape(ref.shape).float()
                     - ref.float()).abs().max())
    bound_ms, bound_by = paged_bound(case)
    _, ops = paged_work(case)
    r = dict(ms=cuda_ms(kern, 4 * PAGED_COPIES), ms_one_launch=cuda_ms_one(kern[0], 100, flush),
             plain_ms=cuda_ms_one(lambda: pa._ragged_attention_plain(*args), 5, flush),
             bound_ms=bound_ms, bound_by=bound_by,
             library_ms=cuda_ms(lib, 4 * PAGED_COPIES),
             library_ms_one_launch=cuda_ms_one(lib[0], 50, flush),
             library_max_abs_err=lib_err)
    r.update(tflops=ops / (r["ms"] * 1e-3) / 1e12, bound_share=bound_ms / r["ms"])

    def alt_ms(plan):
        alt = [lambda c=c: pa._ragged_attention_cuda(c["q"], c["k"], c["v"], c["tables"],
                                                     c["vlen"], plan) for c in copies]
        return cuda_ms(alt, 4 * PAGED_COPIES)

    if prefill_plan(pa, case) is not None:
        # The split kernel this call took before the prefill kernel, and
        # one query head a CTA over 128 rows in place of the GQA group.
        plan = paged_plan(pa, case)
        r["split_kernel"] = dict(splits=plan.splits, keys_per_split=plan.keys_per_split,
                                 ms=alt_ms(plan))
        r["pack1_ms"] = alt_ms(pa._prefill_grid(*case["q"].shape[:3], 1))
    else:
        other = {4: 8, 8: 4}[pa.CTAS_PER_SM[(case["dtype"], case["q"].shape[1] == 1)]]
        plan = paged_plan(pa, case, other)
        r["other_plan"] = dict(per_sm=other, splits=plan.splits,
                               keys_per_split=plan.keys_per_split, ms=alt_ms(plan))
    r.update(paged_call_breakdown(kern))
    del kern, lib, views, lib_out, copies
    torch.cuda.empty_cache()
    return r


# -- phase 3b: flash kernels -------------------------------------------------


FLASH_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4, "flash_block_fwd": 2}


def flash_ops(which, bh, s, hd, causal):
    """FLOPs of the call's products on the (row, key) pairs the mask keeps."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    return FLASH_PRODUCTS[which] * 2 * hd * pairs


def flash_bound(which, bh, s, hd, dtype, causal):
    """(bound_ms, bound_by): bytes the call must move (inputs read once,
    outputs written once) over HBM bandwidth, against `flash_ops` over the
    type's peak."""
    es = torch.empty((), dtype=dtype).element_size()
    mat = bh * s * hd * es
    vec = bh * s * 4
    nbytes = {
        "flash_fwd": 4 * mat + vec,                # q k v -> o, lse
        "flash_bwd_dq": 5 * mat + 2 * vec,         # q k v do lse delta -> dq
        "flash_bwd_dkv": 6 * mat + 2 * vec,        # q k v do lse delta -> dk dv
        # q k v -> o (f32 whatever the inputs), m, l
        "flash_block_fwd": 3 * mat + bh * s * hd * 4 + 2 * vec,
    }[which]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_ops(which, bh, s, hd, causal) / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_readings(which, bh, s, hd, causal, ms, bound_ms) -> dict:
    """Achieved TFLOP/s of a timed call and the share of its bound."""
    return dict(tflops=flash_ops(which, bh, s, hd, causal) / (ms * 1e-3) / 1e12,
                bound_share=bound_ms / ms)


# The bf16 hd-128 instantiation of each kernel in ptxas's report (a
# substring of its mangled name): the paged kernel's at the decode shape
# (4 key groups) and at the chunk shape (1).
PTXAS_ENTRY = {
    "ragged_paged_attention": "ragged_paged_attention_kernelI13__nv_bfloat16Li128ELi4E",
    "ragged_paged_attention_chunk": "ragged_paged_attention_kernelI13__nv_bfloat16Li128ELi1E",
    "ragged_paged_prefill": "ragged_paged_attention_prefill_sm90_kernelILi128E",
    "flash_fwd": "flash_fwd_sm90_kernelILi128E",
    "flash_block_fwd": "flash_block_fwd_sm90_kernelILi128E",
    "flash_bwd_dq": "flash_bwd_dq_sm90_kernelILi128E",
    "flash_bwd_dkv": "flash_bwd_dkv_sm90_kernelILi128E",
}


def ptxas_resources(build_log: str) -> dict:
    """{mangled entry: {registers, spill_stores, spill_loads, stack}} from
    nvcc's -Xptxas=-v report (bytes for the last three)."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                      r" (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def kernel_ptxas(build_log: str) -> dict:
    """PTXAS_ENTRY's kernels' resources by kernel name (None if absent)."""
    res = ptxas_resources(build_log or "")
    return {kern: next((v for k, v in res.items() if pat in k), None)
            for kern, pat in PTXAS_ENTRY.items()}


OUT_NAMES = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
             "flash_bwd_dkv": ("dk", "dv")}
# Rows of the tiles the backward kernels stream through their 2-stage ring
# (K/V for dQ, Q/dO with their lse and delta for dK/dV).
BWD_TILE = 64


def stale_stage_mutants(q, k, v, do, lse, delta, causal, tile=BWD_TILE) -> dict:
    """The outputs of a backward whose ring hands a consumer a stage before
    the producer refilled it, built from the plain versions: dQ with the
    K/V tile after the middle one replaced by the middle one (counted in
    place of its successor), and dK/dV with the Q/dO tile after the middle
    one, its lse and delta rows with it, replaced the same way (the middle
    one counted twice). The masks keep each position's own index. Needs S
    of at least two tiles."""
    from dstack_tpu_torch.workloads import flash_attention as fa

    j = q.shape[1] // tile // 2 - 1
    if j < 0:
        raise ValueError(f"S {q.shape[1]} holds fewer than two tiles of {tile}")
    mid, nxt = slice(j * tile, (j + 1) * tile), slice((j + 1) * tile, (j + 2) * tile)

    def stale(x):
        x = x.clone()
        x[:, nxt] = x[:, mid]
        return x

    dq = fa._flash_bwd_dq_plain(q, stale(k), stale(v), do, lse, delta, causal)
    dk, dv = fa._flash_bwd_dkv_plain(stale(q), k, v, stale(do), stale(lse), stale(delta),
                                     causal)
    return {"flash_bwd_dq": (dq,), "flash_bwd_dkv": (dk, dv)}


def mutant_readings(mutants: dict, refs: dict, tol) -> dict:
    """Per backward kernel: each output's (rel_l2, row_rel) against the
    plain version, and whether the flash gate fails the mutant (it must)."""
    out = {}
    for kern, outs in mutants.items():
        readings = {name: flash_errors(got, ref)[:2]
                    for name, got, ref in zip(OUT_NAMES[kern], outs, refs[kern])}
        out[kern] = dict(readings=readings, caught=any(
            e[0] > tol[0] or e[1] > tol[1] for e in readings.values()))
    return out


def flash_backward(q, k, v, o, lse, do, causal):
    """What `_Flash.backward` runs on CUDA tensors: delta = rowsum(dO * O)
    in f32 (three eager ops), then the dQ and the dK/dV kernels."""
    from dstack_tpu_torch.workloads import flash_attention as fa

    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def flash_errors(got, ref) -> tuple:
    """(rel_l2, row_rel, max_abs, ref_max) of got against ref: rel_l2 is
    ||got - ref|| / ||ref|| over the whole tensor; row_rel is the largest,
    over rows (a query's O or dQ, a key's dK or dV), of the row's
    max |got - ref| over its own max |ref|, floored at ROW_FLOOR x the
    tensor's RMS; then max |got - ref| and max |ref| over the whole tensor
    (logged, not gated)."""
    d = got.double() - ref.double()
    r = ref.double()
    floor = ROW_FLOOR * float(r.square().mean().sqrt())
    row = d.abs().amax(-1) / r.abs().amax(-1).clamp_min(max(floor, 1e-30))
    return (float(d.norm() / r.norm()), float(row.max()), float(d.abs().max()),
            float(r.abs().max()))


def flash_readings(case, kern, pairs) -> dict:
    """One kernel's readings on one case, over its outputs, logged."""
    r = dict(case=case, kernel=kern, max_abs_err=0.0)
    for out, (got, ref) in zip(OUT_NAMES[kern], pairs):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{case} {kern}: {out} not finite")
        if out == "lse":
            r["lse_max_abs_err"] = float((got - ref).abs().max())
        else:
            r[out] = dict(zip(("rel_l2", "row_rel", "max_abs_err", "ref_max"),
                              flash_errors(got, ref)))
            r["max_abs_err"] = max(r["max_abs_err"], r[out]["max_abs_err"])
    log(f"flash {case} {kern}: "
        + json.dumps({k: v for k, v in r.items() if k not in ("case", "kernel")}))
    return r


def check_flash(r, tol) -> None:
    if not r.get("lse_max_abs_err", 0.0) <= LSE_TOL:
        raise AssertionError(f"{r['case']} lse: {r['lse_max_abs_err']} past {LSE_TOL}")
    for out in OUT_NAMES[r["kernel"]]:
        if out != "lse" and not (r[out]["rel_l2"] <= tol[0] and r[out]["row_rel"] <= tol[1]):
            raise AssertionError(f"{r['case']} {r['kernel']} {out}: {r[out]} past {tol}")


def run_flash(timed: bool = True, cases=None):
    """Each flash kernel against its plain version on the same inputs;
    the SDPA yardstick (forward, and backward for dQ + dK/dV together) and
    the stale-stage mutants at each bf16 causal hd-128 case (by default
    the training shape). `cases`: (name, dtype, B*H, S, hd, causal), by
    default phase 3b's. Returns one result per (case, kernel)."""
    from dstack_tpu_torch.workloads import _build
    from dstack_tpu_torch.workloads import flash_attention as fa

    ptxas = kernel_ptxas(_build.build_log)

    if cases is None:
        cases = []
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            cases.append((f"train_{tag}", dtype, 128, 2048, 128, True))
            cases.append((f"ragged_{tag}", dtype, 16, 1000, 64, False))
    results = []
    for name, dtype, bh, s, hd, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn((bh, s, hd), generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = fa._flash_fwd_cuda(q, k, v, causal)
        o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
        dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
        dq_ref = fa._flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
        dk_ref, dv_ref = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
        torch.cuda.synchronize()
        outs = {"flash_fwd": [(o, o_ref), (lse, lse_ref)],
                "flash_bwd_dq": [(dq, dq_ref)],
                "flash_bwd_dkv": [(dk, dk_ref), (dv, dv_ref)]}
        iters = (20, 3) if dtype == torch.bfloat16 else (5, 2)
        calls = {
            "flash_fwd": (lambda: fa._flash_fwd_cuda(q, k, v, causal),
                          lambda: fa._flash_fwd_plain(q, k, v, causal)),
            "flash_bwd_dq": (
                lambda: fa._flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal),
                lambda: fa._flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)),
            "flash_bwd_dkv": (
                lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal),
                lambda: fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)),
        }
        main_case = dtype == torch.bfloat16 and causal and hd == 128
        lib = library_flash_ms(q, k, v, do, causal) if timed and main_case else {}
        checked = [flash_readings(name, kern, pairs) for kern, pairs in outs.items()]
        if main_case:
            mutants = mutant_readings(
                stale_stage_mutants(q, k, v, do, lse_ref, delta, causal),
                {"flash_bwd_dq": (dq_ref,), "flash_bwd_dkv": (dk_ref, dv_ref)}, FLASH_TOL[dtype])
            log(f"flash {name} stale-stage mutants: {json.dumps(mutants)} (tol {FLASH_TOL[dtype]})")
            for r in checked:
                if r["kernel"] in mutants:
                    r["mutation"] = mutants[r["kernel"]]
        for r in checked:  # every reading of the case is logged before a failure
            check_flash(r, FLASH_TOL[dtype])
            if "mutation" in r and not r["mutation"]["caught"]:
                raise AssertionError(f"{name} {r['kernel']}: the gate passes a stale ring stage")
        if timed and main_case:
            # delta, dQ and dK/dV as `_Flash.backward` runs them, against
            # SDPA's backward (which computes its own delta).
            wfn = lambda: flash_backward(q, k, v, o, lse, do, causal)  # noqa: E731
            whole = dict(ms=cuda_ms(wfn, iters[0]), ms_one_launch=cuda_ms_one(wfn, iters[0]),
                         library_ms=lib["bwd"], library_ms_one_launch=lib["bwd_one_launch"])
            log("flash whole backward", json.dumps(whole))
        for r in checked:
            kern = r["kernel"]
            if timed:
                kfn, pfn = calls[kern]
                bound_ms, bound_by = flash_bound(kern, bh, s, hd, dtype, causal)
                which = "fwd" if kern == "flash_fwd" else "bwd"
                r.update(ms=cuda_ms(kfn, iters[0]), ms_one_launch=cuda_ms_one(kfn, iters[0]),
                         plain_ms=cuda_ms_one(pfn, iters[1]),
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib.get(which),
                         library_ms_one_launch=lib.get(which + "_one_launch"),
                         ptxas=ptxas[kern] if dtype == torch.bfloat16 and hd == 128 else None)
                r.update(rate_readings(kern, bh, s, hd, causal, r["ms"], bound_ms))
                if main_case and kern != "flash_fwd":
                    r["whole_backward"] = whole
                log("flash timing", json.dumps(r))
            results.append(r)
        del q, k, v, do, o, lse, o_ref, lse_ref, delta, dq, dk, dv, dq_ref, dk_ref, dv_ref
        del outs, calls
        torch.cuda.empty_cache()
    return results


def library_flash_ms(q, k, v, do, causal):
    """torch SDPA on the same (B*H, S, hd) inputs as (B*H, 1, S, hd): its
    forward, and its backward (dQ, dK, dV in one call; back to back from
    the host, as autograd is not captured) — the yardstick the port never
    calls. Each by both timers."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (x[:, None].clone().requires_grad_() for x in (q, k, v))
    out = sdpa(qq, kk, vv, is_causal=causal)
    dout = do[:, None]
    fwd = lambda: sdpa(qq.detach(), kk.detach(), vv.detach(), is_causal=causal)  # noqa: E731
    bwd = lambda: torch.autograd.grad(out, (qq, kk, vv), dout, retain_graph=True)  # noqa: E731
    return {"fwd": cuda_ms(fwd, 20), "fwd_one_launch": cuda_ms_one(fwd, 20),
            "bwd": cuda_ms(bwd, 20, graph=False), "bwd_one_launch": cuda_ms_one(bwd, 20)}


# -- phase 3c: the ring-step kernel -------------------------------------------


def run_ring_block(timed: bool = True, cases=None):
    """The ring-step kernel against `_block_ref_bh` on the same inputs: o,
    m and l held each on its own (a missed rescale of o cancels in o / l
    when l carries it too), at phase 3c's cases or `cases` ((name, dtype,
    B*H, S, hd, causal), as phase 20's). Returns one result per case."""
    from dstack_tpu_torch.workloads import _build
    from dstack_tpu_torch.workloads import flash_attention as fa

    ptxas = kernel_ptxas(_build.build_log)["flash_block_fwd"]

    s_shard = 8192 // RING_SHARDS
    if cases is None:
        cases = []
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            cases.append((f"ring_full_{tag}", dtype, 16, s_shard, 128, False))
            cases.append((f"ring_diag_{tag}", dtype, 16, s_shard, 128, True))
            cases.append((f"ragged_{tag}", dtype, 16, 1000, 64, False))
    results = []
    for name, dtype, bh, s, hd, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(11)
        q, k, v = (torch.randn((bh, s, hd), generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        o, m, l = fa._ring_block_cuda(q, k, v, causal)
        ro, rm, rl = fa._block_ref_bh(q, k, v, causal)
        torch.cuda.synchronize()
        for part, t in (("o", o), ("m", m), ("l", l)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name} flash_block_fwd: {part} not finite")
        o_err = dict(zip(("rel_l2", "row_rel", "max_abs_err", "ref_max"),
                         flash_errors(o, ro)))
        m_err = float((m - rm).abs().max())
        l_err = float(((l - rl).abs() / rl.abs()).max())
        r = dict(case=name, kernel="flash_block_fwd", o=o_err, m_max_abs_err=m_err,
                 l_max_rel_err=l_err, max_abs_err=max(o_err["max_abs_err"], m_err))
        log(f"ring block {name}: " + json.dumps({k: v for k, v in r.items()
                                                  if k not in ("case", "kernel")}))
        tol, (m_tol, l_tol) = FLASH_TOL[dtype], BLOCK_STAT_TOL[dtype]
        if not (o_err["rel_l2"] <= tol[0] and o_err["row_rel"] <= tol[1]
                and m_err <= m_tol and l_err <= l_tol):
            raise AssertionError(f"{name} flash_block_fwd past ({tol}, {m_tol}, {l_tol})")
        if timed:
            bound_ms, bound_by = flash_bound("flash_block_fwd", bh, s, hd, dtype, causal)
            iters = (50, 5) if dtype == torch.bfloat16 else (10, 3)
            lib = (library_block_ms(q, k, v, causal)
                   if dtype == torch.bfloat16 and not name.startswith("ragged") else None)
            kfn = lambda: fa._ring_block_cuda(q, k, v, causal)  # noqa: E731
            r.update(ms=cuda_ms(kfn, iters[0]), ms_one_launch=cuda_ms_one(kfn, iters[0]),
                     plain_ms=cuda_ms_one(lambda: fa._block_ref_bh(q, k, v, causal), iters[1]),
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib and lib["ms"],
                     library_ms_one_launch=lib and lib["ms_one_launch"],
                     ptxas=ptxas if dtype == torch.bfloat16 and hd == 128 else None)
            r.update(rate_readings("flash_block_fwd", bh, s, hd, causal, r["ms"], bound_ms))
            log("ring block timing", json.dumps(r))
        results.append(r)
        del q, k, v, o, m, l, ro, rm, rl
        torch.cuda.empty_cache()
    return results


def library_block_ms(q, k, v, causal):
    """SDPA's flash forward (aten's `_scaled_dot_product_flash_attention`)
    on the same (B*H, S, hd) inputs as (B*H, 1, S, hd): normalised O and
    lse, the same information as (o, m, l) up to the choice of m. The
    yardstick the port never calls."""
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    qq, kk, vv = (x[:, None] for x in (q, k, v))
    fn = lambda: flash(qq, kk, vv, 0.0, causal)  # noqa: E731
    return {"ms": cuda_ms(fn, 50), "ms_one_launch": cuda_ms_one(fn, 50)}


# -- phase 6: train ----------------------------------------------------------


def flash_counts():
    from dstack_tpu_torch.workloads import flash_attention as fa

    return dict(fa.LAUNCHES)


def zero_flash_counts():
    from dstack_tpu_torch.workloads import flash_attention as fa

    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0


def expected_launches(cfg, remat, n_steps, seq_shards=1):
    """Kernel launches of n_steps train steps: the forward kernel runs
    twice per layer under "full" and "dots" remat (the recompute), the
    backward ones once; the ring runs n(n+1)/2 ring-step launches per layer
    and forward (causal: n diagonal steps, the rest full) and no backward
    kernel (its backward recomputes through the plain version)."""
    fwd = (2 if remat in ("full", "dots") else 1) * cfg.n_layers * n_steps
    want = dict.fromkeys(FLASH_REPLACES, 0)
    if seq_shards > 1:
        want["flash_block_fwd"] = fwd * seq_shards * (seq_shards + 1) // 2
    else:
        want.update(flash_fwd=fwd, flash_bwd_dq=cfg.n_layers * n_steps,
                    flash_bwd_dkv=cfg.n_layers * n_steps)
    return want


def run_train(preset: str, B: int, S: int, seq_shards: int = 1, n_steps: int = 5,
              profiled: bool = True, overrides=None):
    """`preset` (with the config fields in `overrides`) at full width and
    depth, B x S, bf16, random weights from seed 0, on one fixed synthetic
    batch: the port's trainer end to end, over a seq mesh of `seq_shards`
    (the ring) when that is > 1; then one profiled step unless `profiled`
    is False."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.sharding import device_shards, make_mesh
    from dstack_tpu_torch.workloads.train import (
        init_train_state,
        make_train_step,
        synthetic_batch,
    )

    cfg = PRESETS[preset].with_(**(overrides or {}))
    mesh = make_mesh(seq=seq_shards) if seq_shards > 1 else None
    remat = cfg.resolve_remat(B * S, device_shards(mesh), seq_len=S)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, seed=0, mesh=mesh)
    step = make_train_step(cfg, mesh)
    batch = synthetic_batch(cfg, B, S, seed=0, mesh=mesh)
    n_warm = 2
    zero_flash_counts()
    t0 = time.monotonic()
    for _ in range(n_warm):  # warm-up: settles the allocator and cuBLAS
        state, m = step(state, batch)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    losses, norms, auxes = [], [], []
    t0 = time.monotonic()
    for _ in range(n_steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        auxes.append(m["router_aux"])
    vals = torch.stack(losses + norms + auxes).tolist()  # the one host readback
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = vals[:n_steps], vals[n_steps:2 * n_steps]
    want = expected_launches(cfg, remat, n_warm + n_steps, seq_shards)
    step_ms = wall / n_steps * 1e3
    tokens_s = B * S * n_steps / wall
    flops_step = cfg.flops_per_token(S) * B * S
    stats = dict(
        preset=preset, **(overrides or {}), layers=cfg.n_layers, batch=B, seq_len=S,
        seq_shards=seq_shards,
        dtype=cfg.dtype, remat=remat, steps=n_steps, warmup_steps=n_warm,
        warmup_s=warm_s, step_ms=step_ms, tokens_per_s=tokens_s, flops_per_step=flops_step,
        mfu=cfg.flops_per_token(S) * tokens_s / H100_BF16_PEAK,
        peak_mem_gb=peak / 1e9,
        estimator_activation_gb=cfg.activation_bytes(B * S, device_shards(mesh),
                                                     seq_len=S) / 1e9,
        train_state_gb=sum(t.numel() * t.element_size() for _, t in state_leaves(state)) / 1e9,
        losses=losses, grad_norms=norms, router_aux=vals[2 * n_steps:], launches=launches,
        launches_per_step={k: v // (n_warm + n_steps) for k, v in launches.items()})
    log(f"train stats ({preset}, {seq_shards} seq shards)", json.dumps(stats))
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    if profiled:
        stats["profiled_step"] = profile_step(step, state, batch)
    del state, batch
    torch.cuda.empty_cache()
    return stats


def state_leaves(state):
    """[(group/path, tensor)] of a train state: params, mu, nu."""
    from dstack_tpu_torch.workloads.weights import flatten_params

    opt = state.opt_state
    return [(f"{g}/{k}", t) for g, tree in (("params", state.params), ("mu", opt.mu),
                                            ("nu", opt.nu))
            for k, t in flatten_params(tree)]


def profile_step(step, state, batch):
    """One train step under torch.profiler: device time by kernel class
    (the profiler adds host overhead; not used for the throughput above)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_class, by_name, flash = {}, {}, {}
    for name, us, _ in device_kernels(prof):
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0) + us
        by_name[name] = by_name.get(name, 0) + us
        if c == "flash_attention":
            m = re.search(r"flash_\w*?_kernel", name)
            f = flash.setdefault(m.group(0) if m else name[:60], {"calls": 0, "ms": 0.0})
            f["calls"] += 1
            f["ms"] += us / 1e3
    for f in flash.values():
        f["ms_per_call"] = f["ms"] / f["calls"]
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
        "flash_kernels": flash,
        "top_kernels_ms": [(n[:90], v / 1e3) for n, v in top],
    }
    log("profiled train step", json.dumps(out))
    return out


# -- phase 6b: kernels against plain inside the model ------------------------


def run_model_check(preset: str = "smol-1b", B: int = 2, S: int = 2048,
                    seq_shards: int = 1):
    """`preset`'s width at 2 layers, B x S: one loss_fn and its grads
    through the kernels (the ring over `seq_shards` when > 1, else the
    single-device flash kernels), and again with plain_attention (and, for
    the ring, with the single-device flash kernels)."""
    from dstack_tpu_torch.workloads.attention import make_attention_fn, plain_attention
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.sharding import device_shards, make_mesh
    from dstack_tpu_torch.workloads.train import loss_fn, synthetic_batch
    from dstack_tpu_torch.workloads.weights import flatten_params
    from dstack_tpu_torch.workloads.transformer import init_params

    mesh = make_mesh(seq=seq_shards) if seq_shards > 1 else None
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cfg = PRESETS[preset].with_(n_layers=2, dtype=str(dtype).split(".")[1])
        params = init_params(cfg, seed=1)
        pairs = flatten_params(params)
        for _, p in pairs:
            p.requires_grad_(True)
        batch = synthetic_batch(cfg, B, S, seed=1)
        variants = [("kernels", make_attention_fn(mesh), mesh), ("plain", plain_attention, None)]
        if mesh is not None:
            variants.append(("flash", make_attention_fn(), None))
        res = {}
        for name, attn, m in variants:
            zero_flash_counts()
            loss, _ = loss_fn(cfg, params, batch, attn, m)
            grads = torch.autograd.grad(loss, [p for _, p in pairs])
            res[name] = (float(loss.detach()), grads, flash_counts())
        remat = cfg.resolve_remat(B * S, device_shards(mesh), seq_len=S)
        want = expected_launches(cfg, remat, 1, seq_shards)
        if res["kernels"][2] != want or any(res["plain"][2].values()):
            raise AssertionError(f"model check {tag}: launches {res['kernels'][2]}"
                                 f" (expected {want}) / {res['plain'][2]}")
        tol_loss, tol_grad = MODEL_TOL[dtype]
        out[tag] = {}
        for ref in [n for n, _, _ in variants[1:]]:
            loss_rel = abs(res["kernels"][0] - res[ref][0]) / abs(res[ref][0])
            grad_rel = {}
            for (path, _), g, r in zip(pairs, res["kernels"][1], res[ref][1]):
                grad_rel[path] = float((g.float() - r.float()).norm() / r.float().norm())
            worst = max(grad_rel.values())
            log(f"model check {preset} x{seq_shards} {tag} vs {ref}: loss"
                f" {res['kernels'][0]:.6f} vs {res[ref][0]:.6f} (rel {loss_rel:.3e},"
                f" tol {tol_loss:g}); worst leaf grad rel {worst:.3e} (tol {tol_grad:g})"
                f" at {max(grad_rel, key=grad_rel.get)}")
            if not loss_rel <= tol_loss or not worst <= tol_grad:
                raise AssertionError(f"model check {tag}: kernels disagree with {ref}")
            out[tag][ref] = dict(loss_kernels=res["kernels"][0], loss_ref=res[ref][0],
                                 loss_rel=loss_rel, grad_rel=grad_rel)
        del params, pairs, res, batch
        torch.cuda.empty_cache()
    return out


# -- phase 4: engine ---------------------------------------------------------


def drain(q, timeout=300):
    toks, t_first = [], None
    while True:
        tok = q.get(timeout=timeout)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return toks, t_first
        if t_first is None:
            t_first = time.monotonic()
        toks.append(tok)


def byte_prompt(seed: int, n: int):
    return [(i * 31 + seed * 17 + 7) % 251 + 1 for i in range(n)]


def dense_check(cfg, params, dtype, chunk: int = 128, n_prompt: int = 200):
    """A prompt of `n_prompt` tokens through two chunk-prefill programs of
    `chunk` tokens (the second ragged: n_prompt - chunk real rows, the pad
    rows reaching sentinel blocks; paged, attention through the kernels)
    against the dense plain `_forward_cached`, on the last position's
    logits. At 128 both chunks take the split kernel; at 512 in bf16,
    the prefill kernel."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.generate import _forward_cached, init_cache
    from dstack_tpu_torch.workloads.kv_blocks import init_paged_state, make_chunk_prefill

    dev = params["embed"].device
    prompt = byte_prompt(99, n_prompt)
    nb = 2 * chunk // 16
    st = init_paged_state(cfg, 1, 2 * chunk, 16, nb, dev)
    real = -(-n_prompt // 16)
    table = list(range(real)) + [nb] * (nb - real)
    fn = make_chunk_prefill(cfg, chunk)
    before = dict(pa.LAUNCHES)
    fn(params, st, 0, table, prompt[:chunk], chunk, 0, 8, 0.0, 1.0, None, False)
    _, first, logits = fn(params, st, 0, table, prompt[chunk:] + [0] * (2 * chunk - n_prompt),
                          n_prompt - chunk, chunk, 8, 0.0, 1.0, None, True)
    launched = {k: pa.LAUNCHES[k] - before[k] for k in before}
    ref, _ = _forward_cached(cfg, params, torch.tensor([prompt], device=dev),
                             init_cache(cfg, 1, n_prompt, dev))
    rel = float((logits - ref[0]).abs().max() / ref[0].abs().max())
    same_top1 = int(first) == int(ref[0].argmax())
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    log(f"engine dense check {tag}, chunks of {chunk}: max|dlogits|/max|logits|={rel:.3e}"
        f" (tol {ENGINE_LOGIT_TOL[dtype]:g}), top-1 agrees={same_top1},"
        f" kernel launches={launched}")
    prefill = pa._prefill_plan(1, chunk, cfg.n_heads, cfg.n_kv_heads, nb, 16, cfg.head_dim,
                               dtype) is not None
    if launched != {"ragged_paged_attention": 2 * cfg.n_layers,
                    "ragged_paged_prefill": 2 * cfg.n_layers * prefill}:
        raise AssertionError(f"dense check ran the kernels {launched} times")
    if not rel <= ENGINE_LOGIT_TOL[dtype]:
        raise AssertionError(f"chunked-prefill logits off by {rel}")


def engine_prompts():
    """Phase 4's 8 requests (32-300 prompt tokens, two sharing a 64-token
    prefix)."""
    shared = byte_prompt(0, 64)
    prompts = [shared + byte_prompt(1, 40)]
    prompts += [byte_prompt(s, n) for s, n in zip(range(2, 8), (32, 77, 128, 180, 255, 300))]
    prompts.insert(4, shared + byte_prompt(9, 70))
    return prompts


def serve_wave(eng, prompts, n_new, adapters=None) -> dict:
    """Phase 4's wave on a warm engine, the paged kernel's launch count
    zeroed just before and read just after: the first prefix sharer runs
    ahead (so its prefix blocks are published before the second is
    admitted), the other 7 together; streams, TTFTs, throughput, and the
    engine's counters. `adapters` names each request's LoRA adapter (None
    for the base model)."""
    from dstack_tpu_torch.workloads import paged_attention as pa

    adapters = adapters or [None] * len(prompts)
    decode_s0 = eng.stats()["decode_seconds_total"]  # nonzero on a used engine
    pa.LAUNCHES["ragged_paged_attention"] = 0
    t_start = time.monotonic()
    t_sub = [time.monotonic()]
    results = [drain(eng.submit(prompts[0], max_new_tokens=n_new, temperature=0.0,
                                adapter=adapters[0]))]
    t_wave = time.monotonic()
    outs = []
    for p, a in zip(prompts[1:], adapters[1:]):
        t_sub.append(time.monotonic())
        outs.append(eng.submit(p, max_new_tokens=n_new, temperature=0.0, adapter=a))
    results += [drain(q) for q in outs]
    launches = pa.LAUNCHES["ragged_paged_attention"]
    st = eng.stats()
    ttft = sorted(tf - ts for (_, tf), ts in zip(results, t_sub))
    streams = [t for t, _ in results]
    emitted = sum(len(t) for t in streams)
    return dict(
        streams=streams, stats=st, kernel_launches=launches,
        launches_per_token=launches / emitted,
        ttft_p50_s=statistics.median(ttft),
        ttft_p95_s=ttft[min(len(ttft) - 1, math.ceil(0.95 * len(ttft)) - 1)],
        decode_tokens_per_s=(emitted - len(streams))
        / max(st["decode_seconds_total"] - decode_s0, 1e-9),
        wave_tokens_per_s=(emitted - len(streams[0])) / (time.monotonic() - t_wave),
        wall_s=time.monotonic() - t_start,
    )


def run_engine(cfg, params):
    from dstack_tpu_torch.workloads.serving import ServingEngine

    eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4,
                        prefill_chunk_tokens=128, kv_block_size=16)
    try:
        t0 = time.monotonic()
        w = eng.warmup()
        log(f"engine warmup: {w['programs']} programs in {w['seconds']:.3f}s"
            f" (wall {time.monotonic() - t0:.3f}s)")
        n_new = 32
        wave = serve_wave(eng, engine_prompts(), n_new)
        breakdown = profile_wave(eng, cfg)
    finally:
        eng.close()
    st, launches = wave.pop("stats"), wave["kernel_launches"]
    streams = wave.pop("streams")
    counts = [len(t) for t in streams]
    log(f"engine: token counts {counts}, kernel launches {launches},"
        f" prefix hits {st['prefix_cache_hits_total']},"
        f" tokens reused {st['prefix_tokens_reused_total']}")
    if counts != [n_new] * len(streams):
        raise AssertionError(f"token counts {counts}")
    if launches <= 0:
        raise AssertionError("the engine run launched the kernel 0 times")
    if st["prefix_cache_hits_total"] < 1:
        raise AssertionError("the shared prefix did not hit the prefix cache")
    if st["attn_path"] != "cuda" or st["attn_dispatch_plain_total"]:
        raise AssertionError(f"attention path {st['attn_path']}")
    for toks in streams:
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("token id out of range")
    eng_stats = dict(
        requests=len(streams), new_tokens_each=n_new,
        prefix_cache_hits=st["prefix_cache_hits_total"],
        prefix_tokens_reused=st["prefix_tokens_reused_total"], **wave,
        decode_seconds_total=st["decode_seconds_total"],
        prefill_seconds_total=st["prefill_seconds_total"],
        prefill_chunks=st["prefill_chunks_total"],
        profiled_wave=breakdown,
    )
    log("engine stats", json.dumps(eng_stats))
    return launches, breakdown


def run_engine_chunks(cfg, params, n_new: int = 16) -> dict:
    """The engine at a chunk budget of 1024 (prompts of 300-1000 tokens,
    bf16): its prompt chunks take the prefill kernel, its decode steps the
    split kernel; both launch counts are read around the wave."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.serving import ServingEngine

    eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4,
                        prefill_chunk_tokens=1024, kv_block_size=16)
    try:
        eng.warmup()
        for k in pa.LAUNCHES:
            pa.LAUNCHES[k] = 0
        outs = [eng.submit(byte_prompt(40 + i, n), max_new_tokens=n_new, temperature=0.0)
                for i, n in enumerate((300, 520, 777, 1000))]
        counts = [len(drain(q)[0]) for q in outs]
        launches = dict(pa.LAUNCHES)
    finally:
        eng.close()
    r = dict(token_counts=counts, launches=launches,
             split_kernel_launches=launches["ragged_paged_attention"]
             - launches["ragged_paged_prefill"])
    log("engine chunks of 1024:", json.dumps(r))
    if counts != [n_new] * 4:
        raise AssertionError(f"token counts {counts}")
    if launches["ragged_paged_prefill"] <= 0 or r["split_kernel_launches"] <= 0:
        raise AssertionError(f"the wave did not run both kernels: {launches}")
    return r


def kernel_class(name: str) -> str:
    n = name.lower()
    if "ragged_paged_attention" in n:
        return "paged_attention"
    if "flash_" in n:
        return "flash_attention"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas", "matmul", "nvjet")):
        return "matmul"
    return "other"


def device_kernels(prof):
    """[(name, us, stream)] of the device's kernels in a finished profile,
    read off the profiler's raw results: building its Python event tree
    takes ~20 s for a serving wave at full width."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3, e.device_resource_id())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def profile_wave(eng, cfg, adapters=None):
    """A second wave (8 requests x 32 tokens, prompts 100-240 tokens)
    under torch.profiler: device time per kernel class and the wave's
    wall time. Not used for the throughput
    numbers above (the profiler adds host overhead). With `adapters` (one
    per request) every LoRA delta runs on a side stream of its own, fenced
    both ways by stream waits (no host sync), so its kernels form a
    `lora_delta` class: the device streams that run no paged attention."""
    from torch.profiler import ProfilerActivity, profile

    from dstack_tpu_torch.workloads import lora_serving as tls
    from dstack_tpu_torch.workloads import paged_attention as pa

    prompts = [byte_prompt(20 + s, 100 + 20 * s) for s in range(8)]
    adapters = adapters or [None] * len(prompts)
    before = pa.LAUNCHES["ragged_paged_attention"]
    real_delta = tls.lora_delta
    if any(adapters):
        side = torch.cuda.Stream()

        def delta(*a):
            cur = torch.cuda.current_stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = real_delta(*a)
            cur.wait_stream(side)
            out.record_stream(cur)
            return out

        tls.lora_delta = delta
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            outs = [eng.submit(p, max_new_tokens=32, temperature=0.0, adapter=a)
                    for p, a in zip(prompts, adapters)]
            for q in outs:
                drain(q)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        tls.lora_delta = real_delta
    calls = pa.LAUNCHES["ragged_paged_attention"] - before
    kernels = device_kernels(prof)
    main = {st for name, _, st in kernels if kernel_class(name) == "paged_attention"}
    by_class, by_name = {}, {}
    for name, us, st in kernels:
        c = "lora_delta" if any(adapters) and st not in main else kernel_class(name)
        by_class[c] = by_class.get(c, 0) + us
        by_name[name] = by_name.get(name, 0) + us
    if any(adapters) and not by_class.get("lora_delta"):
        raise AssertionError("the profiled LoRA wave attributed no device time to the delta")
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
        "top_kernels_ms": [(n[:90], v / 1e3) for n, v in top],
    }
    if any(adapters):
        out["lora_delta_share_of_busy"] = by_class["lora_delta"] / busy
    # The paged kernel's device time per wrapper call (its split-KV combine
    # kernel, where it runs, counted in the same call).
    out["paged_calls"] = calls
    out["paged_ms_per_call"] = (by_class.get("paged_attention", 0) / 1e3 / calls
                                if calls else None)
    log("profiled wave", json.dumps(out))
    return out


# -- phase 4b: speculative decoding -----------------------------------------


def hold_streams(cfg, params, prompts, refs, gots, tol, what) -> dict:
    """Every stream by the near-tie rule; returns the count of
    divergences (each a near-tie), the largest gap among them, the sorted
    positions of the first divergences and the largest gap of a token on
    its own stream's prefix (`worst`); raises on the first stream that
    is not held."""
    divergences, max_gap, at, worst = 0, 0.0, [], 0.0
    for i, (p, ref, got) in enumerate(zip(prompts, refs, gots)):
        r = near_tie(cfg, params, p, ref, got, tol)
        if not r["ok"]:
            raise AssertionError(f"{what}: stream {i} diverges past a near-tie: {r}")
        worst = max(worst, r["worst"])
        if r["diverged"]:
            divergences += 1
            max_gap = max(max_gap, r["gap"])
            at.append(r["at"])
    return dict(divergences=divergences, max_gap=max_gap, of=len(refs), at=sorted(at),
                worst=worst)


def rule_fails_a_genuine_divergence(cfg, params, prompt, stream, tol) -> dict:
    """The near-tie rule's own check: the stream with its token at the
    middle replaced by the token the dense forward puts lowest must fail
    it (and the stream against itself must pass)."""
    at = len(stream) // 2
    low = int(dense_logits(cfg, params, list(prompt) + list(stream[:at])).argmin())
    bad = list(stream[:at]) + [low] + list(stream[at + 1:])
    r = near_tie(cfg, params, prompt, stream, bad, tol)
    if r["ok"] or not near_tie(cfg, params, prompt, stream, stream, tol)["ok"]:
        raise AssertionError(f"the near-tie rule passes a genuine divergence: {r}")
    return r


SPEC_KEYS = ("spec_rounds_total", "spec_tokens_proposed_total", "spec_tokens_accepted_total",
             "spec_accept_rate_ewma", "spec_tokens_per_round_ewma", "spec_draft_len_mean",
             "spec_draft_seconds_total", "spec_verify_seconds_total",
             "spec_fallback_rounds_total")


# The A/B orders of 4b and 9(b): plain, then the feature (PR 19 cut the
# repeats of plain, feature, feature, plain; PERF.md section 4).
SPEC_AB = (False, True)
LORA_AB = (False, True)
# 4b, 9(a)-(d) and 11a run smol-1b's first 8 layers (PR 19's depth cut;
# their gates are the near-tie rule, bit equality and counts).
SERVE_CUT_LAYERS = 8


def first_layers(cfg, params, n: int):
    """(cfg at `n` layers, the params' first `n` layers as views of the
    stacks): a depth cut of the same weights."""
    return cfg.with_(n_layers=n), {**params, "layers": {k: v[:n] for k, v in
                                                        params["layers"].items()}}


def run_spec(cfg, params, n_new: int = 64, order=SPEC_AB) -> dict:
    """Phase 4b: the plain engine and the speculative one (int8 drafter,
    spec_max_draft 4) on phase 4's requests, in `order` (plain, spec) in
    one call; every spec stream held by the near-tie rule against the
    first plain run's, the rule shown failing a genuine divergence, and a
    profiled wave of the spec engine. Then the same A/B at smol-1b width
    and 4 layers in f32, at f32's tolerance."""
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.transformer import init_params

    prompts = engine_prompts()
    runs, profiled = [], None
    for spec in order:
        eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4, prefill_chunk_tokens=128,
                            kv_block_size=16, spec_enable=spec, spec_max_draft=4)
        try:
            w = eng.warmup()
            r = serve_wave(eng, prompts, n_new)
            r.update(spec=spec, warmup_s=w["seconds"], warmup_programs=w["programs"])
            if spec and profiled is None:
                profiled = profile_wave(eng, cfg)
                ps = eng.stats()
                rounds = ps["spec_rounds_total"] - r["stats"]["spec_rounds_total"]
                profiled.update(spec_rounds=rounds, device_busy_ms_per_round=(
                    profiled["device_busy_ms"] / rounds if rounds else None))
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
        runs.append(r)
    tol = ENGINE_LOGIT_TOL[torch.bfloat16]
    base = runs[0]["streams"]
    out = {"runs": [], "profiled_spec_wave": profiled}
    for r in runs:
        st = r.pop("stats")
        streams = r.pop("streams")
        if any(len(t) != n_new for t in streams):
            raise AssertionError(f"token counts {[len(t) for t in streams]}")
        r["near_tie"] = hold_streams(cfg, params, prompts, base, streams, tol,
                                     "spec" if r["spec"] else "plain")
        r.update({k: st[k] for k in SPEC_KEYS}, decode_seconds_total=st["decode_seconds_total"])
        if r["kernel_launches"] <= 0:
            raise AssertionError("the wave launched the paged kernel 0 times")
        if r["spec"] and not (st["spec_rounds_total"] > 0 and st["spec_tokens_accepted_total"] > 0):
            raise AssertionError(f"no accepted speculation: {r}")
        log("spec A/B run", json.dumps(r))
        out["runs"].append(r)
    out["rule_check"] = rule_fails_a_genuine_divergence(cfg, params, prompts[1], base[1], tol)
    log(f"near-tie rule on a stream with a token replaced by the lowest-logit one:"
        f" {json.dumps(out['rule_check'])} (tol {tol:g}): fails, as it must")
    # smol-1b width at 4 layers in f32.
    cfg32 = cfg.with_(dtype="float32", n_layers=4)
    p32 = init_params(cfg32, 0, params["embed"].device)
    streams32 = {}
    for spec in (False, True):
        eng = ServingEngine(cfg32, p32, slots=8, steps_per_sync=4, prefill_chunk_tokens=128,
                            kv_block_size=16, spec_enable=spec, spec_max_draft=4)
        try:
            eng.warmup()
            r = serve_wave(eng, prompts, 32)
            streams32[spec] = r["streams"]
            st = r["stats"]
        finally:
            eng.close()
        del eng
    tol32 = ENGINE_LOGIT_TOL[torch.float32]
    out["f32_4_layers"] = dict(
        near_tie=hold_streams(cfg32, p32, prompts, streams32[False], streams32[True],
                              tol32, "spec f32"),
        **{k: st[k] for k in SPEC_KEYS})
    if not st["spec_tokens_accepted_total"] > 0:
        raise AssertionError("f32: no accepted speculation")
    log("spec f32 4 layers", json.dumps(out["f32_4_layers"]), f"(tol {tol32:g})")
    del p32
    torch.cuda.empty_cache()
    return out


# -- phase 4c: the host KV tier -----------------------------------------------


def block_bytes(cfg, bs: int) -> int:
    """Bytes of one KV block in one pool, K and V over every layer."""
    return cfg.n_layers * bs * cfg.n_kv_heads * cfg.head_dim * 2 * cfg.dtype_bytes


def run_host_tier(cfg, params, prefix: int = 256, suffix: int = 1152, bs: int = 16) -> dict:
    """Phase 4c. (a) A pool of 2 x max_blocks and 12 requests over 3
    shared 256-token prefixes (each with a 1152-token suffix of its own,
    so three requests overflow the pool), sent one after another: prefix
    blocks are evicted, spilled and swapped back. Streams by the near-tie
    rule against a default-pool engine's. (b) With speculation: a slot's
    chain read before preempt, in the tier, and after readmission, both
    pools byte for byte."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.serving import ServingEngine

    n_new, max_blocks = 8, cfg.max_seq_len // bs
    prefixes = [byte_prompt(40 + j, prefix) for j in range(3)]
    prompts = [prefixes[i % 3] + byte_prompt(50 + i, suffix) for i in range(12)]
    streams, stats, launches = {}, {}, {}
    for small in (True, False):
        eng = ServingEngine(cfg, params, slots=8, prefill_chunk_tokens=256, kv_block_size=bs,
                            kv_pool_blocks=2 * max_blocks if small else None,
                            kv_host_budget_bytes=4 << 30 if small else None)
        try:
            eng.warmup()
            pa.LAUNCHES["ragged_paged_attention"] = 0
            streams[small] = [drain(eng.submit(p, max_new_tokens=n_new, temperature=0.0))[0]
                              for p in prompts]
            launches[small] = pa.LAUNCHES["ragged_paged_attention"]
            stats[small] = eng.stats()
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
    st = stats[True]
    hist = st["swap_in_hist"]
    per_block = hist["sum"] / hist["count"] if hist["count"] else None
    out = {"spill": dict(
        kernel_launches=launches[True], near_tie=hold_streams(
            cfg, params, prompts, streams[False], streams[True],
            ENGINE_LOGIT_TOL[torch.bfloat16], "host tier"),
        **{k: st[k] for k in ("prefix_cache_hits_total", "prefix_cache_host_hits_total",
                              "prefix_cache_device_hits_total", "kv_spills_total",
                              "kv_swap_ins_total", "kv_block_evictions_total",
                              "kv_host_evictions_total", "kv_host_bytes")},
        big_pool_hits=stats[False]["prefix_cache_hits_total"],
        swap_in_s_per_block=per_block,
        swap_in_gb_per_s=block_bytes(cfg, bs) / per_block / 1e9 if per_block else None)}
    log("host tier spill", json.dumps(out["spill"]))
    if not st["prefix_cache_host_hits_total"] > 0:
        raise AssertionError("no prefix block came back from the host tier")
    out["preempt"] = run_preempt_bytes(cfg, params, bs, prefix + 44)
    if launches[True] <= 0:
        raise AssertionError("the host-tier run launched the paged kernel 0 times")
    return out


def run_preempt_bytes(cfg, params, bs: int = 16, prompt_len: int = 300,
                      other_len: int = 1800, adapters=None) -> dict:
    """A speculating slot preempted mid-stream and held parked while a
    second request prefills and decodes in a pool of one max_len, so over
    blocks the first one freed: the first slot's chain (target and
    drafter pools) gathered from the card just before the swap-out must
    equal, byte for byte, what the tier holds at swap-out and at
    readmission, and what its fresh blocks hold after readmission. With
    `adapters` ({name: adapter}) the engine multiplexes them and the
    parked request runs on the first: readmission must restore its bank
    slot, and the result carries its stream."""
    from dstack_tpu_torch.workloads.serving import ServingEngine

    lora = lora_engine_kw(adapters)
    eng = ServingEngine(cfg, params, slots=8, prefill_chunk_tokens=256, kv_block_size=bs,
                        kv_pool_blocks=cfg.max_seq_len // bs, spec_enable=True,
                        spec_max_draft=4, kv_host_budget_bytes=4 << 30, **lora)
    load_adapters(eng, adapters)
    adapter = next(iter(adapters)) if adapters else None
    seen = {"other_blocks": set()}
    parked, release = threading.Event(), threading.Event()
    real_preempt, real_place = eng._preempt_slot, eng._place_slot
    real_inject, real_readmit = eng._inject_chain, eng._readmit_swapped

    def clone(arrays):
        return {k: v.clone() for k, v in arrays.items()}

    def preempt(slot):
        table = eng._slot_tables[slot]
        n_keep = (eng._lengths_host[slot] - 1) // bs + 1
        seen["before"] = clone(eng._gather_chain(table[:n_keep]))
        seen["freed"] = set(table)
        t0 = time.monotonic()
        ok = real_preempt(slot)
        seen["swap_out_s"] = time.monotonic() - t0
        sw = eng._swapped[-1]
        seen["tier_at_swap_out"] = clone(sw.arrays)
        seen["nbytes"], seen["sw"] = sw.nbytes, sw
        parked.set()
        return ok

    def readmit():
        # The parked slot stays out until the second request has decoded;
        # meanwhile every block a live slot holds is noted.
        if eng._swapped and not release.is_set():
            for s, r in enumerate(eng._live):
                if r is not None:
                    seen["other_blocks"].update(eng._slot_tables[s] or ())
            return False
        return real_readmit()

    def place(slot, table, *a):
        # Readmission: _inject_chain has just scattered the payload.
        seen["adapter_ix"] = a[-1]
        eng._sync()
        seen["swap_in_s"] = time.monotonic() - seen.pop("t_in")
        seen["tier_at_readmission"] = clone(seen["sw"].arrays)
        seen["after"] = clone(eng._gather_chain(table))
        return real_place(slot, table, *a)

    def inject(arrays, table):
        seen.setdefault("t_in", time.monotonic())
        return real_inject(arrays, table)

    eng._preempt_slot, eng._place_slot, eng._inject_chain = preempt, place, inject
    eng._readmit_swapped = readmit
    try:
        eng.warmup()
        out = eng.submit(byte_prompt(70, prompt_len), max_new_tokens=64, temperature=0.0,
                         adapter=adapter)
        got = [out.get(timeout=300) for _ in range(8)]
        eng.preempt(out)
        if not parked.wait(300):
            raise AssertionError("preempt: the slot never swapped out")
        other = eng.submit(byte_prompt(71, other_len), max_new_tokens=16, temperature=0.0)
        other_got = [other.get(timeout=300) for _ in range(8)]
        release.set()
        got += drain(out)[0]
        other_got += drain(other)[0]
        st = eng.stats()
        want_ix = eng._lora.slot_of(adapter) if adapter else -1
        inflight = eng._lora.inflight if adapter else 0
    finally:
        eng.close()
    if seen["adapter_ix"] != want_ix or inflight:
        raise AssertionError(f"preempt: readmitted with adapter_ix {seen['adapter_ix']}"
                             f" (want {want_ix}), {inflight} adapter refs left")
    reused = len(seen["other_blocks"] & seen["freed"])
    if not reused or len(other_got) != 16:
        raise AssertionError(f"preempt: the second request ({len(other_got)} tokens) held"
                             f" {reused} of the {len(seen['freed'])} blocks the parked slot freed")
    if len(got) != 64 or st["slot_preemptions_total"] != 1 or st["slot_swap_ins_total"] != 1:
        raise AssertionError(f"preempt/resume: {len(got)} tokens, {st['slot_preemptions_total']}"
                             f" preemptions, {st['slot_swap_ins_total']} swap-ins")
    names = sorted(seen["before"])
    if names != ["draft_k", "draft_v", "k", "v"]:
        raise AssertionError(f"the swapped chain holds {names}")
    for what in ("tier_at_swap_out", "tier_at_readmission", "after"):
        for name in names:
            a, b = seen["before"][name], seen[what][name]
            if a.shape != b.shape or not torch.equal(a.cpu().view(torch.uint8),
                                                     b.cpu().view(torch.uint8)):
                raise AssertionError(f"{name} {what} differs from the chain before preempt")
    r = dict(pools=names, blocks=int(seen["before"]["k"].shape[1]), bytes=seen["nbytes"],
             swap_out_s=seen["swap_out_s"], swap_in_s=seen["swap_in_s"],
             swap_out_gb_per_s=seen["nbytes"] / seen["swap_out_s"] / 1e9,
             swap_in_gb_per_s=seen["nbytes"] / seen["swap_in_s"] / 1e9,
             byte_exact=True, tokens=len(got), freed_blocks=len(seen["freed"]),
             freed_blocks_rewritten=reused, adapter=adapter,
             readmitted_adapter_ix=seen["adapter_ix"])
    log("host tier preempt/resume", json.dumps(r))
    if adapter:
        r["stream"] = got
    return r


# -- phase 5: http -----------------------------------------------------------


def http(method, url, body=None, timeout=120, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def run_http(params):
    from dstack_tpu_torch.native_server import Engine, chat_text, make_server, start_warmup

    engine = Engine("smol-1b", max_new_tokens=16, params=params)
    server, ready = make_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        start_warmup(engine, ready)
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 300
        while True:
            try:
                code, _ = http("GET", base + "/readyz")
                if code == 200:
                    break
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    raise
            if time.monotonic() > deadline:
                raise AssertionError("/readyz never turned 200")
            time.sleep(0.2)
        code, body = http("GET", base + "/v1/models")
        assert code == 200 and json.loads(body)["data"], body
        msg = {"messages": [{"role": "user", "content": "hello from the card"}],
               "max_tokens": 12, "temperature": 0}
        code, body = http("POST", base + "/v1/chat/completions", msg,
                          headers={"X-Request-ID": "chip-smoke-1"})
        resp = json.loads(body)
        assert code == 200 and resp["usage"]["completion_tokens"] == 12, body
        code, body = http("GET", base + "/v1/requests/chip-smoke-1/trace")
        trace = json.loads(body)
        phases = [p["phase"] for p in trace["phases"]]
        assert code == 200 and trace["status"] == "ok" and "decode" in phases, body
        code, body = http("POST", base + "/v1/chat/completions", {**msg, "stream": True})
        assert code == 200 and body.rstrip().endswith("data: [DONE]"), body[-200:]
        assert '"phase_summary"' in body.rsplit("data: ", 2)[-2], body[-400:]
        code, body = http("GET", base + "/metrics")
        m = json.loads(body)
        assert code == 200 and m["admitted_total"] >= 2 and m["attn_path"] == "cuda", m
        code, body = http("GET", base + "/metrics?format=prometheus")
        assert code == 200 and 'dstack_tpu_serving_attn_dispatch_total{path="cuda"}' in body
        assert "dstack_tpu_compile_cache_hits_total" in body, body
        code, body = http("GET", base + "/v1/affinity")
        served = engine.encode(chat_text(msg["messages"]))
        sketch = affinity_check(json.loads(body), served)
        must_fail(affinity_check, {**sketch, "digests": sketch["digests"][1:]}, served)
        log(f"http: models, 2 chat completions, a request's trace ({', '.join(phases)}),"
            f" the stream's phase_summary, metrics and the affinity sketch"
            f" ({len(sketch['digests'])} digests, the prompt's chain among them)"
            f" answered 200 on :{port}")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.serving.close()


def chain_digests(tokens, block_size: int, namespace: bytes = b"") -> list:
    """The affinity digests of a prompt's full blocks, recomputed with the
    allocator's chain hash (what a fleet router computes)."""
    from dstack_tpu_torch.workloads.kv_blocks import BlockAllocator, _chain_hash

    h, out = BlockAllocator._ns_seed(namespace), []
    for i in range(len(tokens) // block_size):
        h = _chain_hash(h, tokens[i * block_size:(i + 1) * block_size])
        out.append(h.hex()[:BlockAllocator.DIGEST_HEX])
    return out


def affinity_check(sketch: dict, tokens) -> dict:
    """GET /v1/affinity's body must carry the chain of a prompt just
    served (its full blocks' digests, recomputed here)."""
    want = chain_digests(tokens, sketch["block_size"])
    missing = [d for d in want if d not in sketch["digests"]]
    if not want or missing:
        raise AssertionError(f"the affinity sketch lacks the served prompt's chain {missing}")
    return sketch


def must_fail(gate, *args, **kwargs) -> str:
    """Run `gate` on a faulty input: it must raise AssertionError (its
    message is returned); a gate that passes the fault fails the run."""
    try:
        gate(*args, **kwargs)
    except AssertionError as e:
        return str(e)[:120]
    raise AssertionError(f"{gate.__name__} passes a fault: {args}")


def qos_check(codes) -> None:
    """A burst from one tenant over its bucket: at least one 429, each
    with Retry-After; everything else a 200."""
    shed = [(c, ra) for c, ra in codes if c == 429]
    if not shed or any(not ra or int(ra) < 1 for _, ra in shed):
        raise AssertionError(f"no 429 with Retry-After in the burst: {codes}")
    if any(c not in (200, 429) for c, _ in codes):
        raise AssertionError(f"the burst got {codes}")


def run_qos(params, qos_rate: float = 1.0, qos_burst: float = 2.0, n: int = 6,
            preset: str = "smol-1b") -> dict:
    """Phase 5's QoS gate: a second in-process server with --qos-rate 1
    --qos-burst 2; a burst of n concurrent chats from one Bearer key gets
    at least one 429 with Retry-After, a chat from another tenant a 200,
    and the per-tenant series count them."""
    import urllib.error

    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

    engine = Engine(preset, max_new_tokens=8, params=params, qos_rate=qos_rate,
                    qos_burst=qos_burst, device=params["embed"].device)
    server, ready = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    msg = {"messages": [{"role": "user", "content": "rate me"}], "max_tokens": 4,
           "temperature": 0}
    codes = [None] * n

    def send(i, key):
        req = urllib.request.Request(base + "/v1/chat/completions", method="POST",
                                     data=json.dumps(msg).encode(),
                                     headers={"Content-Type": "application/json",
                                              "Authorization": f"Bearer {key}"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers.get("Retry-After")
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After")

    try:
        start_warmup(engine, ready).join(timeout=300)

        def burst(i):
            codes[i] = send(i, "flood")

        threads = [threading.Thread(target=burst, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        other = send(n, "other")
        qos_check(codes)
        must_fail(qos_check, [(200, None) if c == 429 else (c, ra) for c, ra in codes])
        if other[0] != 200:
            raise AssertionError(f"another tenant's chat got {other[0]}")
        prom = http("GET", base + "/metrics?format=prometheus")[1]
        qos = json.loads(http("GET", base + "/metrics")[1])["qos"]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.close()
    n_shed = sum(c == 429 for c, _ in codes)
    for line in (f'dstack_tpu_serving_tenant_shed_total{{tenant="flood"}} {n_shed}',
                 'dstack_tpu_serving_tenant_requests_total{tenant="other"} 1'):
        if line not in prom:
            raise AssertionError(f"the Prometheus text lacks {line!r}")
    out = dict(codes=codes, other=other[0], qos=qos)
    log("qos (5)", json.dumps(out))
    return out


# -- phase 5b: the service of examples/deployment/native/service.yml ----------

SERVICE_YML = "examples/deployment/native/service.yml"


def service_argv(preset=None, port=None, path=None):
    """native_server's flags from service.yml's command, verbatim but for
    --checkpoint-dir (weights random from --seed), with `preset` and
    `port` put in place of its own when given."""
    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)), SERVICE_YML)
    text = open(path).read()
    cmd = text.split("commands:", 1)[1].split("\nport:", 1)[0]
    words = " ".join(line.strip().removeprefix("- ") for line in cmd.splitlines()).split()
    words = words[words.index("--preset"):]
    argv, i = [], 0
    while i < len(words):
        flag = words[i]
        has_value = i + 1 < len(words) and not words[i + 1].startswith("--")
        value = words[i + 1] if has_value else None
        i += 2 if has_value else 1
        if flag == "--checkpoint-dir":
            continue
        if flag == "--preset" and preset is not None:
            value = preset
        if flag == "--port" and port is not None:
            value = str(port)
        argv += [flag] + ([value] if has_value else [])
    return argv


def service_messages(n: int = 40):
    """n chats of 32-300 bytes of text, the first 4 sharing a 64-byte
    prefix (and one length, so their byte prompts align)."""
    shared = bytes((i * 7 + 3) % 26 + 97 for i in range(64)).decode()
    msgs = []
    for i in range(n):
        length = 120 if i < 4 else 32 + (i * 67) % 269
        body = bytes((i * 31 + j * 11 + 5) % 26 + 97 for j in range(length)).decode()
        text = shared + body[64:] if i < 4 else body
        msgs.append([{"role": "user", "content": text}])
    return msgs


def ttft_of(trace) -> float:
    """Submit to first token: the start of the first `decode` phase."""
    return next(p["start_s"] for p in trace["phases"] if p["phase"] == "decode")


SERVICE_SERIES = (
    "dstack_tpu_serving_spec_rounds_total", "dstack_tpu_serving_spec_tokens_accepted_total",
    "dstack_tpu_serving_kv_host_bytes", "dstack_tpu_serving_kv_swap_ins_total",
    "dstack_tpu_serving_slot_preemptions_total", "dstack_tpu_serving_slot_swap_ins_total",
    "dstack_tpu_serving_slots_swapped", "dstack_tpu_serving_prefix_cache_host_hits_total",
    "dstack_tpu_serving_kv_swap_in_seconds_count",
)


def run_service(cfg, params, n_new: int = 64, preset=None, extra=()) -> dict:
    """Phase 5b: native_server's main() with service.yml's flags (port 0
    in place of its own) in a thread of this process (smol-1b, random
    weights from --seed 0, the card's int8 drafter): 30 best-effort
    chats, then 10 paid ones once the first are decoding, each at
    temperature 0 for 64 tokens. The token ids are read off the engine's
    output queues by a spy on `submit`. Gates: all complete; a paid
    request preempted a best-effort slot and it swapped back; speculation
    ran through the kernel; the Prometheus text has the new series; every
    stream agrees by the near-tie rule with a plain engine's (no spec, no
    tier, 40 slots) on the same token prompt in this process."""
    from dstack_tpu_torch import native_server
    from dstack_tpu_torch.workloads.serving import ServingEngine

    argv = service_argv(preset, port=0) + list(extra)
    started, seen, sent = threading.Event(), {}, {}
    real_make = native_server.make_server

    def make(engine, host, port, model_name):
        server, ready = real_make(engine, "127.0.0.1", port, model_name)
        real_submit = engine.serving.submit

        def submit(tokens, *a, **kw):
            # Each request's prompt and the ids its stream reads.
            q = real_submit(tokens, *a, **kw)
            ids = []
            sent[kw.get("x_request_id")] = (list(tokens), ids)
            real_get = q.get

            def get(*ga, **gk):
                item = real_get(*ga, **gk)
                if item is not None and not isinstance(item, BaseException):
                    ids.append(int(item))
                return item

            q.get = get
            return q

        engine.serving.submit = submit
        seen.update(server=server, ready=ready, engine=engine)
        started.set()
        return server, ready

    native_server.make_server = make
    th = threading.Thread(target=native_server.main, args=(argv,), daemon=True)
    t0 = time.monotonic()
    th.start()
    msgs = service_messages()
    tenants = ["besteffort"] * 30 + ["paid"] * 10
    results, peak = [None] * 40, {"kv_host_bytes": 0, "slots_swapped": 0}
    try:
        if not started.wait(300) or not seen["ready"].wait(300):
            raise AssertionError("native_server never turned ready")
        boot_s = time.monotonic() - t0
        base = f"http://127.0.0.1:{seen['server'].server_address[1]}"

        def send(i):
            body = {"messages": msgs[i], "max_tokens": n_new, "temperature": 0}
            code, text = http("POST", base + "/v1/chat/completions", body, timeout=600,
                              headers={"Authorization": f"Bearer {tenants[i]}",
                                       "X-Request-ID": f"svc-{i}"})
            results[i] = (code, json.loads(text))

        done = threading.Event()

        def watch():
            while not done.is_set():
                try:
                    m = json.loads(http("GET", base + "/metrics", timeout=10)[1])
                    for k in peak:
                        peak[k] = max(peak[k], m[k])
                except Exception:
                    pass
                done.wait(0.25)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t_wave = time.monotonic()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(30)]
        for t in threads:
            t.start()
        # The paid requests go once the best-effort ones are decoding.
        while json.loads(http("GET", base + "/metrics")[1])["admitted_total"] < 8:
            time.sleep(0.05)
        paid = [threading.Thread(target=send, args=(i,)) for i in range(30, 40)]
        for t in paid:
            t.start()
        for t in threads + paid:
            t.join(timeout=900)
        wave_s = time.monotonic() - t_wave
        done.set()
        watcher.join(timeout=10)
        stats = json.loads(http("GET", base + "/metrics")[1])
        prom = http("GET", base + "/metrics?format=prometheus")[1]
        traces = [json.loads(http("GET", base + f"/v1/requests/svc-{i}/trace")[1])
                  for i in range(40)]
    finally:
        native_server.make_server = real_make
        if "server" in seen:
            seen["server"].shutdown()  # main() then closes the server and engine
        th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("native_server's main() did not return after shutdown")
    del seen
    torch.cuda.empty_cache()
    bad = [i for i, r in enumerate(results) if r is None or r[0] != 200
           or r[1]["usage"]["completion_tokens"] != n_new
           or len(sent.get(f"svc-{i}", ((), ()))[1]) != n_new]
    if bad:
        raise AssertionError(f"service requests {bad} did not complete with {n_new} tokens")
    for name in SERVICE_SERIES:
        if name not in prom:
            raise AssertionError(f"the Prometheus text lacks {name}")
    gates = dict(slot_preemptions_total=stats["slot_preemptions_total"] >= 1,
                 slot_swap_ins_total=stats["slot_swap_ins_total"] >= 1,
                 spec_rounds_total=stats["spec_rounds_total"] >= 1,
                 kernel=stats["attn_path"] == "cuda" and stats["attn_dispatch_cuda_total"] > 0
                 and not stats["attn_dispatch_plain_total"])
    if not all(gates.values()):
        raise AssertionError(f"service gates {gates}: {json.dumps(stats)[:2000]}")
    # The plain engine on the token prompts the server submitted.
    prompts = [sent[f"svc-{i}"][0] for i in range(40)]
    eng = ServingEngine(cfg, params, slots=40, prefill_chunk_tokens=256, kv_block_size=32)
    try:
        eng.warmup()
        outs = [eng.submit(p, max_new_tokens=n_new, temperature=0.0) for p in prompts]
        plain = [drain(q)[0] for q in outs]
    finally:
        eng.close()
    del eng
    torch.cuda.empty_cache()
    got = [sent[f"svc-{i}"][1] for i in range(40)]
    near = hold_streams(cfg, params, prompts, plain, got,
                        ENGINE_LOGIT_TOL[torch.bfloat16], "service")
    ttft = {t: sorted(ttft_of(tr) for tr, tt in zip(traces, tenants) if tt == t)
            for t in ("besteffort", "paid")}

    def pct(xs, q):
        return xs[min(len(xs) - 1, math.ceil(q * len(xs)) - 1)]

    out = dict(
        argv=argv, boot_s=boot_s, wave_s=wave_s, near_tie=near,
        ttft_s={t: {"p50": statistics.median(v), "p95": pct(v, 0.95)} for t, v in ttft.items()},
        decode_tokens_per_s=40 * (n_new - 1) / max(stats["decode_seconds_total"], 1e-9),
        wave_tokens_per_s=40 * n_new / wave_s,
        peak_kv_host_bytes=peak["kv_host_bytes"], peak_slots_swapped=peak["slots_swapped"],
        **{k: stats[k] for k in ("slot_preemptions_total", "slot_swap_ins_total",
                                 "kv_spills_total", "kv_swap_ins_total",
                                 "prefix_cache_hits_total", "prefix_cache_host_hits_total",
                                 "admitted_total", "attn_dispatch_cuda_total") + SPEC_KEYS},
    )
    log("service (5b)", json.dumps(out))
    return out


# -- phase 8: the train-state checkpoint at full width -------------------------


def host_copies(state) -> dict:
    """{group/path: host copy} of every leaf of a train state."""
    return {name: t.detach().to("cpu", copy=True) for name, t in state_leaves(state)}


def leaf_rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp_min(1e-30))


def gather_backward_repeatable(cfg, batch, tries: int = 3) -> bool:
    """Whether the embedding gather's backward (`params["embed"][tokens]`,
    transformer.py; index_put_ with accumulate) gives the same bits twice
    at this batch, in the model's dtype."""
    dev = batch["inputs"].device
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device=dev,
                    dtype=cfg.activation_dtype).requires_grad_(True)
    up = torch.randn((*batch["inputs"].shape, cfg.d_model), generator=g, device=dev,
                     dtype=cfg.activation_dtype)

    def once():
        return torch.autograd.grad(w[batch["inputs"]], w, up)[0]

    first = once()
    return all(torch.equal(first, once()) for _ in range(tries))


def check_restore(state, saved: dict, saved_at) -> int:
    """Every leaf of `state` and its (step, count) bit-equal to the saved
    host copies; returns the number of leaves."""
    leaves = state_leaves(state)
    bad = [name for name, t in leaves if not torch.equal(t, saved[name].to(t.device))]
    at = (state.step, state.opt_state.count)
    if bad or at != saved_at:
        raise AssertionError(f"restore is not the saved state: {bad[:8]} {at} vs {saved_at}")
    return len(leaves)


# Phase 8's depth: 8 of smol-1b's 16 layers at full width (a preset of
# fewer keeps its own), to make room in the smoke's budget (PERF.md section
# 4); its gates are bit for bit.
CKPT_LAYERS = 8


def run_checkpoint(preset: str = "smol-1b", B: int = 8, S: int = 2048):
    """`preset` at full width and CKPT_LAYERS layers, B x S, bf16: two
    train steps, then
    save the state (params, AdamW moments, step, count) and restore it into
    a fresh template, bit for bit. Continuation: one step from the state in
    memory at the save (a), one from a restore (b), one more from a second
    restore (c), which must be bit for bit too; (b) must equal (a) bit for
    bit wherever (b) equals (c), and elsewhere lie within 3x the (b)-(c)
    spread. One state is on the card at a time; the saved state, (a) and
    (b) are kept as host copies."""
    import tempfile
    from pathlib import Path

    from dstack_tpu_torch.workloads import checkpoint as ckpt
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.train import (
        init_train_state,
        make_train_step,
        synthetic_batch,
    )

    cfg = PRESETS[preset].with_(n_layers=min(CKPT_LAYERS, PRESETS[preset].n_layers))
    step = make_train_step(cfg)
    batch = synthetic_batch(cfg, B, S, seed=0)
    state = init_train_state(cfg, seed=0)
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for _, t in state_leaves(state))
    out = dict(preset=preset, layers=cfg.n_layers, batch=B, seq_len=S, dtype=cfg.dtype,
               state_bytes=nbytes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as vol:
        saved, saved_at = host_copies(state), (state.step, state.opt_state.count)
        t0 = time.monotonic()
        ckpt.save(vol, state)  # returns once every leaf is on the host
        t_d2h = time.monotonic() - t0
        ckpt.close_all()  # the write, on disk (fsync)
        t_save = time.monotonic() - t0
        out.update(file_bytes=(Path(vol) / str(state.step) / "weights.bin").stat().st_size,
                   save_s=t_save, save_gb_per_s=nbytes / t_save / 1e9,
                   save_d2h_s=t_d2h, save_d2h_share=t_d2h / t_save)
        state, m = step(state, batch)  # (a), from the state in memory
        a, loss_a = host_copies(state), float(m["loss"])
        del state, m
        torch.cuda.empty_cache()
        template = init_train_state(cfg, seed=1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state = ckpt.restore_latest(vol, template)
        torch.cuda.synchronize()
        t_restore = time.monotonic() - t0
        out.update(restore_s=t_restore, restore_gb_per_s=nbytes / t_restore / 1e9)
        n_equal = check_restore(state, saved, saved_at)
        out.update(restore_bit_exact=True, restored_leaves=n_equal,
                   restored_step_count=saved_at)
        log(f"checkpoint {preset} B {B} x S {S}: {nbytes / 1e9:.3f} GB saved in {t_save:.2f}s"
            f" ({out['save_gb_per_s']:.2f} GB/s; device-to-host {t_d2h:.2f}s, share"
            f" {out['save_d2h_share']:.3f}), restored in {t_restore:.2f}s"
            f" ({out['restore_gb_per_s']:.2f} GB/s); step/count {saved_at};"
            f" {n_equal} leaves bit-equal")
        state, m = step(state, batch)  # (b), from a restore
        b, loss_b = host_copies(state), float(m["loss"])
        state = ckpt.restore_latest(vol, state)  # into the same tensors
        check_restore(state, saved, saved_at)
        del saved
        state, m = step(state, batch)  # (c), from a second restore
        loss_c = float(m["loss"])
        per_leaf, failed = {}, []
        for name, t in state_leaves(state):
            tb = b[name].to(t.device)
            repeat = torch.equal(t, tb)
            same = torch.equal(tb, a[name].to(t.device))
            rel_ba = 0.0 if same else leaf_rel_l2(tb, a[name].to(t.device))
            rel_bc = 0.0 if repeat else leaf_rel_l2(tb, t)
            per_leaf[name] = dict(repeatable=repeat, b_equals_a=same, rel_l2_b_a=rel_ba,
                                  rel_l2_b_c=rel_bc)
            if (repeat and not same) or (not repeat and not rel_ba <= 3 * rel_bc):
                failed.append(name)
        del state, m, a, b
        torch.cuda.empty_cache()
    loss_repeat = loss_b == loss_c
    loss_ok = loss_b == loss_a if loss_repeat else abs(loss_b - loss_a) <= 3 * abs(loss_b - loss_c)
    not_repeatable = [n for n, r in per_leaf.items() if not r["repeatable"]]
    gather_repeat = gather_backward_repeatable(cfg, batch)
    out.update(losses_abc=[loss_a, loss_b, loss_c], loss_repeatable=loss_repeat,
               step_bit_repeatable=loss_repeat and not not_repeatable,
               leaves_not_repeatable=not_repeatable,
               gather_backward_repeatable=gather_repeat,
               worst_rel_l2_b_a=max(r["rel_l2_b_a"] for r in per_leaf.values()),
               worst_rel_l2_b_c=max(r["rel_l2_b_c"] for r in per_leaf.values()),
               leaves=per_leaf)
    log(f"checkpoint continuation: losses a {loss_a!r} b {loss_b!r} c {loss_c!r};"
        f" {len(per_leaf) - len(not_repeatable)}/{len(per_leaf)} leaves bit-repeatable"
        f" (b = c), not: {not_repeatable[:8]}; worst rel_l2 b-a {out['worst_rel_l2_b_a']:.3e},"
        f" b-c {out['worst_rel_l2_b_c']:.3e}; the embedding gather's backward"
        f" {'is' if gather_repeat else 'is not'} bit-repeatable")
    if failed or not loss_ok:
        raise AssertionError(f"a step from the restore is not the step from the saved state:"
                             f" leaves {failed[:8]}, loss ok {loss_ok}")
    del batch
    torch.cuda.empty_cache()
    return out


# -- phase 8b: drain and resume in a subprocess trainer ------------------------

# The drill trainer of phase 8b, shaped like dstack_tpu/chaos/scenarios.py's:
# a DrainHandler, a restore from the volume, and after each step a JSON line
# (step, loss, the kernel cache's counters); after step argv[3] it holds
# until a drain comes (up to 300 s), so the smoke's SIGTERM lands after a
# known step.
DRAIN_TRAINER = """
import json, sys, time
vol, steps, hold = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
from dstack_tpu_torch.workloads import _build, compile_cache
from dstack_tpu_torch.workloads import checkpoint as ckpt
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.train import (
    init_train_state, install_drain_handler, make_train_step, synthetic_batch)

drain = install_drain_handler()
cfg = PRESETS["smol-1b"].with_(n_layers=2)
state = init_train_state(cfg, seed=0)
restored = ckpt.restore_latest(vol, state)
if restored is not None:
    state = restored
    print(f"resumed from step {state.step}", flush=True)
step = make_train_step(cfg)
batch = synthetic_batch(cfg, 2, 2048, seed=0)
for _ in range(state.step, steps):
    state, m = step(state, batch)
    print(json.dumps({"step": state.step, "loss": float(m["loss"]),
                      "cache": compile_cache.snapshot(), "cache_dir": compile_cache.enabled_dir(),
                      "build_s": _build.build_seconds, "load_s": _build.load_seconds}), flush=True)
    deadline = time.monotonic() + (300 if state.step == hold else 0)
    while not drain.draining and time.monotonic() < deadline:
        time.sleep(0.01)
    if drain.draining:
        drain.checkpoint_and_exit(vol, state)
print("final", state.step, flush=True)
"""
TRAIN_STAGES = ["tpu_init", "compile_start", "compile_end", "first_step"]


def launch_trainer(vol, steps, env, sigterm_after=None, timeout=600):
    """Run DRAIN_TRAINER to its exit: (rc, its output lines, stderr merged
    in, seconds from the SIGTERM to the exit). With `sigterm_after`, the
    trainer holds after that step and SIGTERM goes out once it reports it."""
    import signal

    proc = subprocess.Popen([sys.executable, "-c", DRAIN_TRAINER, vol, str(steps),
                             str(sigterm_after or 0)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines, t_sig = [], None
    try:
        if sigterm_after is not None:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if line.startswith("{") and json.loads(line)["step"] == sigterm_after:
                    t_sig = time.monotonic()
                    proc.send_signal(signal.SIGTERM)
                    break
        rest, _ = proc.communicate(timeout=timeout)
        t_exit = time.monotonic()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += rest.splitlines()
    return proc.returncode, lines, (t_exit - t_sig if t_sig else None)


def run_drain():
    """Launch 1 of a 2-layer smol-1b trainer (B 2 x S 2048) with
    DSTACK_RUN_NAME set and DSTACK_TPU_COMPILE_CACHE at a fresh directory:
    its stage markers in order, one kernel build (a miss); SIGTERM after
    step 2, exit 113 with a checkpoint at that step. Launch 2 on the same
    volume and cache: a hit and no build, resumed at the saved step, run to
    step 5 with finite losses."""
    import tempfile
    from pathlib import Path

    from dstack_tpu_torch.utils.stagemarkers import parse_stage_marker
    from dstack_tpu_torch.workloads import _build

    with tempfile.TemporaryDirectory(prefix="chip_smoke_drain_") as tmp:
        vol, cache = os.path.join(tmp, "ckpt"), os.path.join(tmp, "kernels")
        env = {**os.environ, "DSTACK_RUN_NAME": "chip-smoke-drain",
               "DSTACK_TPU_COMPILE_CACHE": cache,
               "PYTHONPATH": os.pathsep.join(
                   [os.path.dirname(os.path.abspath(__file__))]
                   + [x for x in [os.environ.get("PYTHONPATH")] if x])}
        t0 = time.monotonic()
        rc1, out1, drain_wall = launch_trainer(vol, 5, env, sigterm_after=2)
        wall1 = time.monotonic() - t0
        log(f"drain launch 1: rc {rc1} in {wall1:.1f}s;", " | ".join(out1[-6:]))
        if rc1 != 113:
            raise AssertionError(f"launch 1 exited {rc1}, not 113:\n" + "\n".join(out1[-40:]))
        stages1 = [parse_stage_marker(x) for x in out1 if parse_stage_marker(x)]
        steps1 = [json.loads(x) for x in out1 if x.startswith("{")]
        drained = [x for x in out1 if x.startswith("drain: checkpoint saved at step")]
        saved_step = int(drained[0].split()[5]) if drained else None
        drain_save_s = float(drained[0].split()[7].rstrip("s;")) if drained else None
        t0 = time.monotonic()
        rc2, out2, _ = launch_trainer(vol, 5, env)
        wall2 = time.monotonic() - t0
        log(f"drain launch 2: rc {rc2} in {wall2:.1f}s;", " | ".join(out2[-5:]))
        if rc2 != 0:
            raise AssertionError(f"launch 2 exited {rc2}:\n" + "\n".join(out2[-40:]))
        steps2 = [json.loads(x) for x in out2 if x.startswith("{")]
        leaf = Path(steps1[0]["cache_dir"]) if steps1 and steps1[0]["cache_dir"] else None
        libs = sorted(p.name for p in leaf.iterdir()) if leaf and leaf.is_dir() else []
    c1, c2 = steps1[0]["cache"], steps2[0]["cache"]
    out = dict(
        launch1=dict(rc=rc1, wall_s=wall1, stages=stages1, steps=[x["step"] for x in steps1],
                     losses=[x["loss"] for x in steps1], cache=c1,
                     build_s=steps1[0]["build_s"], load_s=steps1[0]["load_s"],
                     drained_at_step=saved_step, drain_save_s=drain_save_s,
                     sigterm_to_exit_s=drain_wall),
        launch2=dict(rc=rc2, wall_s=wall2, resumed=[x for x in out2 if x.startswith("resumed")],
                     steps=[x["step"] for x in steps2], losses=[x["loss"] for x in steps2],
                     cache=c2, build_s=steps2[0]["build_s"], load_s=steps2[0]["load_s"]),
        cache_leaf=str(leaf), cache_leaf_files=libs)
    log("drain and resume", json.dumps(out))
    want_leaf = f"nvcc{{}}-{_build.ARCH.replace('_', '')}"
    checks = {
        "launch 1 stage markers in order": stages1 == TRAIN_STAGES,
        "launch 1 built once (a miss)": (c1["compiles"], c1["cache_misses"], c1["cache_hits"])
        == (1, 1, 0) and c1["compile_seconds"] > 0,
        "the library in the keyed leaf": leaf is not None and leaf.parent == Path(cache)
        and re.fullmatch(want_leaf.format(r"\d+\.\d+"), leaf.name) is not None
        and f"libdstack_kernels_{_build._digest()}.so" in libs,
        "drained at the last finished step": saved_step == steps1[-1]["step"] == 2,
        "launch 2 hit the cache, no build": (c2["compiles"], c2["cache_misses"],
                                             c2["cache_hits"]) == (0, 0, 1),
        "launch 2 resumed at the saved step": out["launch2"]["resumed"]
        == [f"resumed from step {saved_step}"] and out["launch2"]["steps"] == [3, 4, 5]
        and out2[-1] == "final 5",
        "finite losses": all(math.isfinite(x) for x in out["launch1"]["losses"]
                             + out["launch2"]["losses"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"drain and resume: {bad}")
    log(f"drain: saved in {drain_save_s:.3f}s (SIGTERM to exit {drain_wall:.2f}s); kernel"
        f" build {out['launch1']['build_s']:.2f}s (+ load {out['launch1']['load_s']:.4f}s)"
        f" vs cache-hit load {out['launch2']['load_s']:.4f}s")
    return out


# -- phase 9: LoRA serving ------------------------------------------------------

LORA_RANK, LORA_ALPHA = 8, 16.0
LORA_TARGETS = ("wq", "wv")
LORA_MAX_ADAPTERS = 4
# 9(a)'s gate on project_qkv_lora against the per-row reference, (rel_l2,
# row_rel) over each of q, k and v.
LORA_DELTA_TOL = {torch.bfloat16: (1e-3, 4e-3), torch.float32: (1e-5, 4e-5)}
# Phase 9(b)'s request mix over phase 4's prompts: 3 on t1, 3 on t2, 2 base.
LORA_MIX = ["t1", "t2", None, "t1", "t2", None, "t1", "t2"]


def demo_adapters(cfg, params, names=("t1", "t2", "t3")) -> dict:
    """Rank-8 demo adapters on wq/wv (nonzero B), seeded 1, 2, ... in order."""
    from dstack_tpu_torch.workloads.lora_serving import demo_adapter

    return {n: demo_adapter(cfg, params, i + 1, rank=LORA_RANK, targets=LORA_TARGETS)
            for i, n in enumerate(names)}


def lora_engine_kw(adapters) -> dict:
    return (dict(lora_max_adapters=LORA_MAX_ADAPTERS, lora_rank=LORA_RANK,
                 lora_targets=LORA_TARGETS) if adapters else {})


def load_adapters(eng, adapters) -> None:
    for name, ad in (adapters or {}).items():
        eng.load_adapter(name, ad, alpha=LORA_ALPHA)


def lora_reference(cfg, p, x, positions, layer, adapters, names):
    """The plain version of `project_qkv_lora`, written independently: row
    (request) i is `linear(h_i, W)` plus that row's own f32 delta
    `(h_i·A)·B·alpha/r` from its adapter tree (none for a None name), cast
    back, then reshape and rope, row by row."""
    from dstack_tpu_torch.workloads.transformer import _rope, linear, rms_norm

    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    rows = {t: [] for t in ("wq", "wk", "wv")}
    for i, name in enumerate(names):
        hi = h[i:i + 1]
        for t in rows:
            y = linear(hi, p[t])
            if name is not None and f"{t}_a" in adapters[name]["layers"]:
                a = adapters[name]["layers"][f"{t}_a"][layer].float()
                b = adapters[name]["layers"][f"{t}_b"][layer].float()
                y = (y.float() + (hi.float() @ a @ b) * (LORA_ALPHA / LORA_RANK)).to(y.dtype)
            rows[t].append(y)
    n, s = x.shape[0], x.shape[1]
    q = torch.cat(rows["wq"]).reshape(n, s, cfg.n_heads, cfg.head_dim)
    k = torch.cat(rows["wk"]).reshape(n, s, cfg.n_kv_heads, cfg.head_dim)
    v = torch.cat(rows["wv"]).reshape(n, s, cfg.n_kv_heads, cfg.head_dim)
    return (_rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v)


def lora_readings(got, ref) -> dict:
    """Scale-free readings over q, k and v: rel_l2 (the whole output) and
    row_rel (the worst row, a row being one request's output)."""
    out = {"rel_l2": 0.0, "row_rel": 0.0}
    for g, r in zip(got, ref):
        g, r = g.float().flatten(1), r.float().flatten(1)
        out["rel_l2"] = max(out["rel_l2"], float((g - r).norm() / r.norm()))
        rows = (g - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)
        out["row_rel"] = max(out["row_rel"], float(rows.max()))
    return out


def lora_gate(readings, tol) -> bool:
    return readings["rel_l2"] <= tol[0] and readings["row_rel"] <= tol[1]


def lora_module_check(cfg, params, reg, adapters, seed: int = 0) -> dict:
    """Phase 9(a) on one registry: `project_qkv_lora` at a decode batch
    (B 8, S 1; rows on t1, t2, t3, base, twice) and a 128-token chunk (one
    request, on each of t1, t2, t3 and base), on the first and the last
    layer, against `lora_reference`, by `lora_gate`. The decode batch's
    base rows must equal `project_qkv` on the batch bit for bit. Two
    mutants of the decode batch must fail the gate: the bank indices
    rolled by one across rows, and -1 gathered from bank slot 0 instead of
    the zero pad. `reg` must hold an adapter in slot 0."""
    from dstack_tpu_torch.workloads.lora_serving import bank_layer, project_qkv_lora, safe_index
    from dstack_tpu_torch.workloads.transformer import layer_params, project_qkv

    dev, dt = params["embed"].device, cfg.activation_dtype
    tol = LORA_DELTA_TOL[dt]
    gen = torch.Generator(device=dev).manual_seed(seed)
    names_b = ["t1", "t2", "t3", None] * 2
    out = {"cases": [], "mutants": {}}
    for layer in (0, cfg.n_layers - 1):
        p, lp = layer_params(params, layer), bank_layer(reg.bank, layer)
        cases = [("decode", names_b, 1)] + [(f"chunk_{n or 'base'}", [n], 128)
                                             for n in ("t1", "t2", "t3", None)]
        for case, names, s in cases:
            x = torch.randn((len(names), s, cfg.d_model), generator=gen, device=dev).to(dt)
            pos = torch.arange(37, 37 + s, device=dev)
            ix_host = [-1 if n is None else reg.slot_of(n) for n in names]
            ix = (ix_host[0] if s > 1 else
                  torch.tensor(ix_host, dtype=torch.int32, device=dev))
            sx, scale = safe_index(reg.bank, ix)
            got = project_qkv_lora(cfg, x, p, pos, lp, sx, scale, True)
            ref = lora_reference(cfg, p, x, pos, layer, adapters, names)
            r = dict(case=case, layer=layer, **lora_readings(got, ref))
            r["ok"] = lora_gate(r, tol)
            out["cases"].append(r)
            if case != "decode":
                continue
            plain = project_qkv(cfg, x, p, pos)
            base_rows = [i for i, n in enumerate(names) if n is None]
            r["base_rows_bit_exact"] = all(torch.equal(g[base_rows], b[base_rows])
                                           for g, b in zip(got, plain))
            rolled = torch.roll(sx, 1)
            slot0 = torch.where(ix >= 0, ix, torch.zeros_like(ix)).to(torch.int64)
            for name, mix in (("rolled", rolled), ("minus_one_from_slot_0", slot0)):
                mg = project_qkv_lora(cfg, x, p, pos, lp, mix, reg.bank["scale"][mix], True)
                m = lora_readings(mg, ref)
                m["fails_gate"] = not lora_gate(m, tol)
                out["mutants"][f"{name}_layer{layer}"] = m
    out["tol"] = tol
    out["max_rel_l2"] = max(c["rel_l2"] for c in out["cases"])
    out["max_row_rel"] = max(c["row_rel"] for c in out["cases"])
    out["ok"] = (all(c["ok"] for c in out["cases"])
                 and all(c.get("base_rows_bit_exact", True) for c in out["cases"])
                 and all(m["fails_gate"] for m in out["mutants"].values()))
    return out


def lora_sync_warnings(cfg, params, reg) -> dict:
    """Host syncs of one LoRA decode program against one plain program on
    the same live batch (8 slots, 4 on adapters), counted as
    `torch.cuda.set_sync_debug_mode("warn")` warnings: the LoRA program
    decides `has_lora` on the host and may add none."""
    import warnings

    from dstack_tpu_torch.workloads.kv_blocks import init_paged_state, make_paged_decode_step

    dev, bs, n = params["embed"].device, 16, 8
    st = init_paged_state(cfg, n, cfg.max_seq_len, bs, n * (cfg.max_seq_len // bs), dev)
    mb = cfg.max_seq_len // bs
    st.block_tables[:] = torch.arange(n * mb, dtype=torch.int32, device=dev).reshape(n, mb)
    st.lengths[:] = torch.arange(100, 100 + 50 * n, 50, dtype=torch.int32, device=dev)
    st.active[:] = True
    st.remaining[:] = 100
    st.adapter_ix[:] = torch.tensor([reg.slot_of("t1"), -1, reg.slot_of("t2"), -1,
                                     reg.slot_of("t3"), -1, reg.slot_of("t1"), -1],
                                    dtype=torch.int32, device=dev)
    plain = make_paged_decode_step(cfg, 4)
    lora = make_paged_decode_step(cfg, 4, lora=True)
    counts = {}
    for name, call in (("plain", lambda: plain(params, st, None, sampling=False,
                                                nucleus=False)),
                       ("lora", lambda: lora(params, st, None, reg.bank, sampling=False,
                                             nucleus=False, has_lora=True))):
        call()  # settle the allocator and plans first
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        msgs = [str(w.message) for w in seen
                if "called a synchronizing CUDA operation" in str(w.message)]
        counts[name] = len(msgs)
        counts[f"{name}_messages"] = sorted({m[:160] for m in msgs})
        torch.cuda.synchronize()
    return counts


def run_lora_module(cfg, params) -> dict:
    """Phase 9(a): the module on a bank of 4 slots holding t1-t3 and a
    fourth adapter in slot 0 (so the slot-0 mutant reads real weights)."""
    from dstack_tpu_torch.workloads.lora_serving import AdapterRegistry

    adapters = demo_adapters(cfg, params, ("t1", "t2", "t3", "t0"))
    reg = AdapterRegistry(cfg, params, max_adapters=LORA_MAX_ADAPTERS, rank=LORA_RANK,
                          targets=LORA_TARGETS)
    for name, ad in adapters.items():
        reg.load(name, ad, alpha=LORA_ALPHA)
    if reg.slot_of("t0") != 0:
        raise AssertionError(f"slot 0 holds no adapter: {reg.loaded()}")
    out = lora_module_check(cfg, params, reg, adapters)
    out["sync_warnings"] = lora_sync_warnings(cfg, params, reg)
    log("lora module (9a)", json.dumps(out))
    if not out["ok"]:
        raise AssertionError("9(a): project_qkv_lora fails its gate, a base row differs"
                             " from project_qkv, or a mutant passes")
    if out["sync_warnings"]["lora"] > out["sync_warnings"]["plain"]:
        raise AssertionError(f"9(a): the LoRA decode program syncs: {out['sync_warnings']}")
    return out


def reference_streams(cfg, params, requests) -> list:
    """Temperature-0 streams of a plain engine (phase 4's settings) for
    [(prompt, n_new)], submitted together."""
    from dstack_tpu_torch.workloads.serving import ServingEngine

    eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4, prefill_chunk_tokens=128,
                        kv_block_size=16)
    try:
        eng.warmup()
        outs = [eng.submit(p, max_new_tokens=n, temperature=0.0) for p, n in requests]
        return [drain(q)[0] for q in outs]
    finally:
        eng.close()


def run_lora_engines(cfg, params, adapters, n_new: int = 32, order=LORA_AB) -> dict:
    """Phase 9(b)-(d). (b) The plain engine and the LoRA engine (bank of 4,
    t1-t3 loaded) on phase 4's prompts x 32 tokens, 3 on t1, 3 on t2, 2 on
    the base, in `order` (plain, LoRA); the first LoRA run
    also serves the wave with no adapter in flight (the plain twins), a
    shared prompt on t1, t2 and the base, and a profiled mixed wave.
    Adapter streams are held by the near-tie rule against a plain engine
    serving `merge_lora(base, adapter)` (dense logits from those merged
    params), base streams against the plain engine. (c) Speculation (int8
    drafter, spec_max_draft 4) on the LoRA engine, t1 and base mixed.
    (d) Phase 4c(b)'s preempt, park and resume with the request on t1."""
    from dstack_tpu_torch.workloads.lora import merge_lora
    from dstack_tpu_torch.workloads.serving import ServingEngine

    prompts = engine_prompts()
    tol = ENGINE_LOGIT_TOL[torch.bfloat16]
    shared = prompts[2]
    runs, extra, profiled = [], {}, None
    t_b = time.monotonic()
    for lora in order:
        eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4, prefill_chunk_tokens=128,
                            kv_block_size=16, **lora_engine_kw(adapters if lora else None))
        try:
            load_adapters(eng, adapters if lora else None)
            w = eng.warmup()
            r = serve_wave(eng, prompts, n_new, LORA_MIX if lora else None)
            r.update(lora=lora, warmup_s=w["seconds"], warmup_programs=w["programs"])
            if lora and profiled is None:
                extra["no_adapter_in_flight"] = serve_wave(eng, prompts, n_new)
                extra["shared"] = {a: drain(eng.submit(shared, max_new_tokens=n_new,
                                                       temperature=0.0, adapter=a))[0]
                                   for a in ("t1", "t2", None)}
                profiled = profile_wave(eng, cfg, ["t1", "t2", None, "t3"] * 2)
                if eng._lora.inflight:
                    raise AssertionError(f"{eng._lora.inflight} adapter refs left")
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
        runs.append(r)
    # References: the plain engine's streams (run 1) and merged engines.
    p70 = byte_prompt(70, 300)
    merged, refs = {}, {None: runs[0]["streams"]}
    for name in ("t1", "t2"):
        with torch.no_grad():
            merged[name] = merge_lora(params, adapters[name], rank=LORA_RANK, alpha=LORA_ALPHA)
        reqs = [(p, n_new) for p in prompts] + ([(p70, 64)] if name == "t1" else [])
        refs[name] = reference_streams(cfg, merged[name], reqs)
        torch.cuda.empty_cache()

    def hold(assign, streams, what):
        """Streams of `assign`ed requests over phase 4's prompts, each by
        the rule against its own reference and params."""
        res = {}
        for a in sorted(set(assign), key=str):
            idx = [i for i, x in enumerate(assign) if x == a]
            res[str(a)] = hold_streams(cfg, merged.get(a, params), [prompts[i] for i in idx],
                                       [refs[a][i] for i in idx], [streams[i] for i in idx],
                                       tol, f"{what} ({a})")
        return res

    out = {"runs": [], "profiled_mixed_wave": profiled}
    for r in runs:
        st = r.pop("stats")
        streams = r.pop("streams")
        if any(len(t) != n_new for t in streams):
            raise AssertionError(f"token counts {[len(t) for t in streams]}")
        r["near_tie"] = hold(LORA_MIX if r["lora"] else [None] * 8, streams,
                             "lora" if r["lora"] else "plain")
        r.update(adapters_loaded=st["adapters_loaded"],
                 decode_seconds_total=st["decode_seconds_total"])
        if r["kernel_launches"] <= 0:
            raise AssertionError("the wave launched the paged kernel 0 times")
        log("lora A/B run", json.dumps(r))
        out["runs"].append(r)
    twins = extra["no_adapter_in_flight"]
    twins.pop("stats")
    out["no_adapter_in_flight"] = dict(
        near_tie=hold([None] * 8, twins.pop("streams"), "lora engine, no adapter"),
        **{k: twins[k] for k in ("decode_tokens_per_s", "ttft_p50_s", "kernel_launches")})
    sh = extra["shared"]
    out["shared_prompt_differs"] = {a: sh[a] != sh[None] for a in ("t1", "t2")}
    out["shared_prompt_near_tie"] = {
        str(a): hold_streams(cfg, merged.get(a, params), [shared], [refs[a][2]], [sh[a]],
                             tol, f"shared prompt ({a})") for a in ("t1", "t2", None)}
    if not all(out["shared_prompt_differs"].values()):
        raise AssertionError(f"an adapter left the shared prompt's stream as the base's:"
                             f" {out['shared_prompt_differs']}")
    log("lora engines (9b)", json.dumps({k: v for k, v in out.items() if k != "runs"}),
        f"{time.monotonic() - t_b:.1f}s")

    # (c) speculation with LoRA: base and t1 mixed (the base request runs
    # ahead alone first, so the drafter is not written off at the start).
    t_c = time.monotonic()
    spec_mix = [None, "t1"] * 4
    eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4, prefill_chunk_tokens=128,
                        kv_block_size=16, spec_enable=True, spec_max_draft=4,
                        **lora_engine_kw(adapters))
    try:
        load_adapters(eng, adapters)
        eng.warmup()
        r = serve_wave(eng, prompts, n_new, spec_mix)
    finally:
        eng.close()
    del eng
    torch.cuda.empty_cache()
    st = r.pop("stats")
    r["near_tie"] = hold(spec_mix, r.pop("streams"), "lora spec")
    r.update({k: st[k] for k in SPEC_KEYS})
    out["spec"] = r
    log("lora spec (9c)", json.dumps(r), f"{time.monotonic() - t_c:.1f}s")
    if not (st["spec_rounds_total"] > 0 and st["spec_tokens_accepted_total"] > 0):
        raise AssertionError("9(c): no speculation round accepted a draft")

    # (d) the host tier: preempt, park and resume on t1.
    t_d = time.monotonic()
    pre = run_preempt_bytes(cfg, params, 16, 300, adapters=adapters)
    got = pre.pop("stream")
    pre["near_tie"] = hold_streams(cfg, merged["t1"], [p70], [refs["t1"][-1]], [got], tol,
                                   "lora preempt/resume")
    out["host_tier"] = pre
    log("lora host tier (9d)", json.dumps(pre), f"{time.monotonic() - t_d:.1f}s")
    del merged
    torch.cuda.empty_cache()
    return out


def serve_main(argv, fn):
    """native_server.main(argv) in a thread of this process (its server on
    127.0.0.1): once /readyz would answer 200, fn(base_url) runs; then the
    server shuts down and main() returns (closing the engine). Returns
    (fn's result, boot seconds)."""
    from dstack_tpu_torch import native_server

    started, seen = threading.Event(), {}
    real_make = native_server.make_server

    def make(engine, host, port, model_name):
        server, ready = real_make(engine, "127.0.0.1", port, model_name)
        seen.update(server=server, ready=ready)
        started.set()
        return server, ready

    native_server.make_server = make
    th = threading.Thread(target=native_server.main, args=(argv,), daemon=True)
    t0 = time.monotonic()
    th.start()
    try:
        if not started.wait(300) or not seen["ready"].wait(300):
            raise AssertionError("native_server never turned ready")
        boot_s = time.monotonic() - t0
        result = fn(f"http://127.0.0.1:{seen['server'].server_address[1]}")
    finally:
        native_server.make_server = real_make
        if "server" in seen:
            seen["server"].shutdown()
        th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("native_server's main() did not return after shutdown")
    torch.cuda.empty_cache()
    return result, boot_s


def code_of(method, url, body=None):
    """(status, body) of a request, error statuses included."""
    import urllib.error

    try:
        return http(method, url, body)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def run_lora_http(adapters) -> dict:
    """Phase 9(e): native_server.main on port 0 with `--adapter t1=random
    --adapter t2=<npz written by save_adapter>` (smol-1b, random weights
    from --seed 0): /v1/models lists both, chats on m:t1, m:t2 and m answer
    200 with three different texts, DELETE t1 answers 200 and m:t1 then
    404, POST /v1/adapters reloads t1 from the npz with 200, and the
    Prometheus text has adapters_loaded."""
    import tempfile

    from dstack_tpu_torch.workloads.lora_serving import save_adapter

    msg = {"messages": [{"role": "user", "content": "hello from a tenant"}],
           "max_tokens": 12, "temperature": 0}

    def drive(base):
        out = {"models": [m["id"] for m in
                          json.loads(http("GET", base + "/v1/models")[1])["data"]]}
        chats = {m: code_of("POST", base + "/v1/chat/completions", {**msg, "model": m})
                 for m in ("m:t1", "m:t2", "m")}
        out["chat_codes"] = {m: c for m, (c, _) in chats.items()}
        out["texts_differ"] = len({json.loads(t)["choices"][0]["message"]["content"]
                                   for c, t in chats.values() if c == 200}) == 3
        out["delete_t1"] = code_of("DELETE", base + "/v1/adapters/t1")[0]
        out["chat_t1_after_delete"] = code_of("POST", base + "/v1/chat/completions",
                                              {**msg, "model": "m:t1"})[0]
        out["reload_t1"] = code_of("POST", base + "/v1/adapters",
                                   {"name": "t1", "path": npz})[0]
        out["chat_t1_after_reload"] = code_of("POST", base + "/v1/chat/completions",
                                              {**msg, "model": "m:t1"})[0]
        prom = http("GET", base + "/metrics?format=prometheus")[1]
        out["adapters_loaded"] = "dstack_tpu_serving_adapters_loaded 2" in prom
        out["attn"] = json.loads(http("GET", base + "/metrics")[1])["attn_path"]
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lora_") as tmp:
        npz = os.path.join(tmp, "t2.npz")
        save_adapter(npz, adapters["t2"], rank=LORA_RANK, alpha=LORA_ALPHA)
        out, out["boot_s"] = serve_main(
            ["--preset", "smol-1b", "--port", "0", "--model-name", "m", "--max-new-tokens",
             "16", "--adapter", "t1=random", "--adapter", f"t2={npz}"], drive)
    log("lora http (9e)", json.dumps(out))
    want = dict(models=["m", "m:t1", "m:t2"], chat_codes={"m:t1": 200, "m:t2": 200, "m": 200},
                texts_differ=True, delete_t1=200, chat_t1_after_delete=404, reload_t1=200,
                chat_t1_after_reload=200, adapters_loaded=True, attn="cuda")
    bad = {k: out[k] for k, v in want.items() if out[k] != v}
    if bad:
        raise AssertionError(f"9(e): {bad}")
    return out


def run_lora_serving(cfg, params, order=LORA_AB, depth=SERVE_CUT_LAYERS) -> dict:
    """Phase 9 (a)-(e); the paged kernel's launches of each engine path.
    (a)-(d) run the first `depth` layers (PR 19's depth cut), (e) the
    server at the preset's full depth with full-depth adapters."""
    cut_cfg, cut_params = first_layers(cfg, params, depth)
    t0 = time.monotonic()
    out = {"module": run_lora_module(cut_cfg, cut_params)}
    log(f"9(a): {time.monotonic() - t0:.1f}s")
    out.update(run_lora_engines(cut_cfg, cut_params, demo_adapters(cut_cfg, cut_params),
                                order=order))
    adapters = demo_adapters(cfg, params)
    t0 = time.monotonic()
    out["http"] = run_lora_http(adapters)
    log(f"9(e): {time.monotonic() - t0:.1f}s")
    return out


# -- phase 10: LoRA training ----------------------------------------------------


def step_flops(cfg, B: int, S: int, weight_grads=None, rank: int = 0) -> tuple:
    """(FLOPs of one train step, the formula) from its products, in the
    accounting of `flops_per_token` (fwd per token and layer: 2 x the
    projections' weights + 2 S H hd for causal QK^T and AV; the head
    2 d V). A full step (`weight_grads` None) is 3 x fwd: the forward, the
    activations' gradients and every weight's gradient, attention's
    backward twice its forward. A LoRA step computes the forward, the
    activations' gradients (1 x fwd of every product, 2 x attention), the
    weight gradients of the merged targets only (2 x their weights per
    token), and the merge: its product L d r o per target and that
    product's two gradients (3 x 2 L d r o)."""
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.head_dim
    widths = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd, "wv": cfg.n_kv_heads * hd}
    proj = 2 * d * sum(widths.values()) + 2 * cfg.n_heads * hd * d + 3 * 2 * d * f
    attn = 2 * S * cfg.n_heads * hd
    head = 2 * d * v
    tokens = B * S
    fwd = cfg.n_layers * (proj + attn) + head
    if weight_grads is None:
        return 3.0 * fwd * tokens, "3 x (L (proj + 2 S H hd) + 2 d V) x B S"
    dw = cfg.n_layers * sum(2 * d * widths[t] for t in weight_grads)
    merge = 3 * sum(2 * cfg.n_layers * d * rank * widths[t] for t in weight_grads)
    lora = (fwd + cfg.n_layers * (proj + 2 * attn) + head + dw) * tokens + merge
    return float(lora), ("(L (2 proj + 3 x 2 S H hd + 2 d (H hd + KV hd)) + 2 x 2 d V) x B S"
                         " + 3 x 2 L d r (H hd + KV hd)")


def run_lora_train(full: dict, B: int = 8, S: int = 2048, n_steps: int = 5) -> dict:
    """Phase 10: smol-1b at full width and depth, B 8 x S 2048, bf16, rank 8
    on wq/wv: the base and batch of phase 6 (init_params seed 0, the
    synthetic batch seed 0), adapters from a generator seeded at 1. Gates:
    the step-0 loss (the LoRA step's own, and loss_fn on the merged params)
    equals the full model's loss on the base bit for bit; A's step-0
    gradient is exactly 0 and B's is not; after two warm-up and 5 timed
    steps the base is bit-identical, B has moved off 0, the loss fell and
    each flash kernel ran the full step's count per step. Step ms, tokens/s,
    MFU (FLOPs from `step_flops`), peak memory and a profiled step, beside
    phase 6's full step (`full`)."""
    from dstack_tpu_torch.workloads.attention import make_attention_fn
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.lora import (
        init_lora_state,
        lora_param_count,
        make_lora_train_step,
        merge_lora,
    )
    from dstack_tpu_torch.workloads.train import loss_fn, synthetic_batch
    from dstack_tpu_torch.workloads.transformer import detach_params, init_params
    from dstack_tpu_torch.workloads.weights import flatten_params

    cfg = PRESETS["smol-1b"]
    remat = cfg.resolve_remat(B * S, None, seq_len=S)
    base = init_params(cfg, 0)
    batch = synthetic_batch(cfg, B, S, seed=0)
    attn = make_attention_fn()
    with torch.no_grad():
        full_loss = loss_fn(cfg, base, batch, attn)[0]
    before = {k: t.cpu() for k, t in flatten_params(base)}  # off the device's peak
    gc.collect()  # engines of phase 9 left in reference cycles hold their pools
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    state = init_lora_state(cfg, base, 1, rank=LORA_RANK)
    pairs = flatten_params(state.lora)
    loss0, _ = loss_fn(cfg, merge_lora(detach_params(base), state.lora, rank=LORA_RANK),
                       batch, attn)
    g0 = dict(zip((k for k, _ in pairs),
                  torch.autograd.grad(loss0, [t for _, t in pairs])))
    step = make_lora_train_step(cfg, rank=LORA_RANK)
    n_warm = 2
    zero_flash_counts()
    t0 = time.monotonic()
    warm = []
    for _ in range(n_warm):
        state, m = step(state, base, batch)
        warm.append(m["loss"])
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    losses, norms = [], []
    t0 = time.monotonic()
    for _ in range(n_steps):
        state, m = step(state, base, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    vals = torch.stack(losses + norms).tolist()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = vals[:n_steps], vals[n_steps:]
    want = expected_launches(cfg, remat, n_warm + n_steps)
    flops, formula = step_flops(cfg, B, S, LORA_TARGETS, LORA_RANK)
    full_flops, full_formula = step_flops(cfg, B, S)
    step_ms = wall / n_steps * 1e3
    bits = dict(
        step0_loss_equals_full=bool(torch.equal(warm[0], full_loss)),
        merged_loss_equals_full=bool(torch.equal(loss0.detach(), full_loss)),
        a_grad_zero=all(not g0[k].any() for k in g0 if k.endswith("_a")),
        b_grad_nonzero=all(bool(g0[k].any()) for k in g0 if k.endswith("_b")),
        base_bit_identical=all(torch.equal(t.cpu(), before[k]) for k, t in flatten_params(base)),
        b_moved=all(bool(t.detach().any()) for k, t in flatten_params(state.lora)
                    if k.endswith("_b")),
        loss_fell=losses[-1] < losses[0],
        finite=all(math.isfinite(x) for x in losses + norms),
        launches=launches == want)
    stats = dict(
        preset="smol-1b", batch=B, seq_len=S, dtype=cfg.dtype, remat=remat, rank=LORA_RANK,
        targets=LORA_TARGETS, adapter_params=lora_param_count(state.lora),
        full_loss=float(full_loss), step0_loss=float(warm[0]), losses=losses, grad_norms=norms,
        warmup_s=warm_s, step_ms=step_ms, tokens_per_s=B * S * n_steps / wall,
        flops_per_step=flops, flops_formula=formula,
        mfu=flops / (step_ms / 1e3) / H100_BF16_PEAK,
        full_step_flops=full_flops, full_step_formula=full_formula,
        full_step_flops_per_token_check=full_flops == cfg.flops_per_token(S) * B * S,
        peak_mem_gb=peak / 1e9, mem_at_reset_gb=mem0 / 1e9, launches=launches,
        launches_per_step={k: v // (n_warm + n_steps) for k, v in launches.items()},
        gates=bits,
        full_step={k: full[k] for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb",
                                        "flops_per_step", "launches_per_step")},
        step_ms_vs_full=step_ms / full["step_ms"])
    stats["profiled_step"] = profile_step(lambda s, b: step(s, base, b), state, batch)
    log("lora train (10)", json.dumps(stats))
    bad = [k for k, ok in bits.items() if not ok]
    if bad or not stats["full_step_flops_per_token_check"]:
        raise AssertionError(f"10: LoRA training gates fail: {bad} (launches {launches},"
                             f" expected {want}; losses {losses})")
    del state, base, before, batch, g0
    torch.cuda.empty_cache()
    return stats


# -- phase 10b: LoRA at 2 layers -------------------------------------------------


def lora_grads(cfg, base, lora, batch, attn, mesh=None):
    """(loss, {adapter leaf: grad}) of loss_fn on merge_lora(base, lora)."""
    from dstack_tpu_torch.workloads.lora import merge_lora
    from dstack_tpu_torch.workloads.train import loss_fn
    from dstack_tpu_torch.workloads.weights import flatten_params

    pairs = flatten_params(lora)
    loss, _ = loss_fn(cfg, merge_lora(base, lora, rank=LORA_RANK), batch, attn, mesh)
    grads = torch.autograd.grad(loss, [t for _, t in pairs])
    return float(loss.detach()), {k: g for (k, _), g in zip(pairs, grads)}


def compare_lora(tag, got, ref, tol) -> dict:
    loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
    grad_rel = {k: float((g.float() - ref[1][k].float()).norm() / ref[1][k].float().norm())
                for k, g in got[1].items()}
    worst = max(grad_rel.values())
    log(f"{tag}: loss {got[0]:.6f} vs {ref[0]:.6f} (rel {loss_rel:.3e}, tol {tol[0]:g});"
        f" worst adapter grad rel {worst:.3e} (tol {tol[1]:g})")
    if not loss_rel <= tol[0] or not worst <= tol[1]:
        raise AssertionError(f"{tag}: disagrees")
    return dict(loss=got[0], loss_ref=ref[0], loss_rel=loss_rel, grad_rel=grad_rel)


def run_lora_model_checks() -> dict:
    """Phase 10b at 2 layers: (1) smol-1b width, B 2 x S 2048: the LoRA loss
    and adapter grads (demo adapters, so A and B both get a gradient)
    through the flash kernels against plain_attention, f32 and bf16, at
    6b's limits; (2) smol-1b-8k width, B 1 x S 8192, bf16: through the ring
    over 4 shards against the single-device flash kernels at 7b's limits,
    and one LoRA step over the ring; (3) smol-1b width, bf16: a LoRA
    checkpoint after 2 steps saved, restored into a fresh template, and a
    step from it against the step from the saved state, bit for bit."""
    import tempfile
    from pathlib import Path

    from dstack_tpu_torch.workloads import checkpoint as ckpt
    from dstack_tpu_torch.workloads.attention import make_attention_fn, plain_attention
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.lora import init_lora_state, make_lora_train_step
    from dstack_tpu_torch.workloads.lora_serving import demo_adapter
    from dstack_tpu_torch.workloads.sharding import make_mesh
    from dstack_tpu_torch.workloads.train import synthetic_batch
    from dstack_tpu_torch.workloads.transformer import init_params
    from dstack_tpu_torch.workloads.weights import flatten_params

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cfg = PRESETS["smol-1b"].with_(n_layers=2, dtype=str(dtype).split(".")[1])
        base = init_params(cfg, seed=1)
        lora = demo_adapter(cfg, base, 2, rank=LORA_RANK, targets=LORA_TARGETS)
        for _, t in flatten_params(lora):
            t.requires_grad_(True)
        batch = synthetic_batch(cfg, 2, 2048, seed=1)
        zero_flash_counts()
        kern = lora_grads(cfg, base, lora, batch, make_attention_fn())
        launched = flash_counts()
        plain = lora_grads(cfg, base, lora, batch, plain_attention)
        if not all(launched.get(k) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
            raise AssertionError(f"10b: the LoRA loss ran the flash kernels {launched}")
        out[f"flash_vs_plain_{tag}"] = compare_lora(f"lora model check {tag}", kern, plain,
                                                    MODEL_TOL[dtype])
        del base, lora, batch
        torch.cuda.empty_cache()
    # (2) the ring over 4 shards against the single device, smol-1b-8k width.
    cfg = PRESETS["smol-1b-8k"].with_(n_layers=2)
    base = init_params(cfg, seed=1)
    lora = demo_adapter(cfg, base, 2, rank=LORA_RANK, targets=LORA_TARGETS)
    for _, t in flatten_params(lora):
        t.requires_grad_(True)
    mesh = make_mesh(seq=RING_SHARDS)
    batch = synthetic_batch(cfg, 1, 8192, seed=1)
    zero_flash_counts()
    ring = lora_grads(cfg, base, lora, batch, make_attention_fn(mesh), mesh)
    ring_launches = flash_counts()["flash_block_fwd"]
    single = lora_grads(cfg, base, lora, batch, make_attention_fn())
    out["ring_vs_single"] = compare_lora("lora ring vs single device", ring, single,
                                         MODEL_TOL[torch.bfloat16])
    state = init_lora_state(cfg, base, 1, rank=LORA_RANK, mesh=mesh)
    _, m = make_lora_train_step(cfg, mesh, rank=LORA_RANK)(state, base, batch)
    out["ring_step_loss"] = float(m["loss"])
    out["ring_block_launches"] = ring_launches
    if not ring_launches or not math.isfinite(out["ring_step_loss"]):
        raise AssertionError(f"10b: the LoRA ring step: {ring_launches} ring-step launches,"
                             f" loss {out['ring_step_loss']}")
    del base, lora, batch, state
    torch.cuda.empty_cache()
    # (3) the LoRA checkpoint, bit for bit.
    cfg = PRESETS["smol-1b"].with_(n_layers=2)
    base = init_params(cfg, seed=0)
    batch = synthetic_batch(cfg, 2, 2048, seed=0)
    step = make_lora_train_step(cfg, rank=LORA_RANK)
    state = init_lora_state(cfg, base, 1, rank=LORA_RANK)
    for _ in range(2):
        state, _ = step(state, base, batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lora_ckpt_") as vol:
        ckpt.save(vol, state, wait=True)
        names = sorted({s["name"].split("/")[0] for s in ckpt.read_manifest(Path(vol) / "2")})
        state, _ = step(state, base, batch)
        want = {k: t.detach().clone() for k, t in ckpt._leaves(state)}
        restored = ckpt.restore_latest(vol, init_lora_state(cfg, base, 7, rank=LORA_RANK))
        ckpt.close_all()
    restored, _ = step(restored, base, batch)
    same = all(torch.equal(t, want[k]) for k, t in ckpt._leaves(restored))
    out["checkpoint"] = dict(groups=names, continued_bit_for_bit=same, step=restored.step)
    log("lora checkpoint (10b)", json.dumps(out["checkpoint"]))
    if names != ["lora", "mu", "nu"] or not same or restored.step != 3:
        raise AssertionError(f"10b: LoRA checkpoint {out['checkpoint']}")
    del base, batch, state, restored, want
    torch.cuda.empty_cache()
    return out


def run_lora_drain(preset: str = "smol-1b", seq: int = 512, extra=()) -> dict:
    """Phase 10b (4): `python -m dstack_tpu_torch.fine_tune --lora-rank 8`
    in a subprocess (smol-1b at full depth, B 2 x S 512, so its merged
    export is a smol-1b checkpoint; the kernel library this run built),
    with a checkpoint dir: SIGTERM once it has printed its first step; it
    exits 113 with an adapter checkpoint (lora, mu and nu leaves) at the
    step it finished; a relaunch to that step + 3 resumes there and exports
    the merged params; native_server --checkpoint-dir serves one chat from
    that export with a 200. `extra` goes to both command lines."""
    import signal
    import tempfile
    from pathlib import Path

    from dstack_tpu_torch.workloads import checkpoint as ckpt

    env = {k: v for k, v in os.environ.items() if k != "DSTACK_TPU_COMPILE_CACHE"}
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(os.path.abspath(__file__))]
                                        + [x for x in [os.environ.get("PYTHONPATH")] if x])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lora_drain_") as tmp:
        vol = os.path.join(tmp, "ckpt")
        cmd = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--preset", preset,
               "--batch-size", "2", "--seq-len", str(seq), "--lora-rank", str(LORA_RANK),
               "--checkpoint-dir", vol, *extra]
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd + ["--steps", "100000"], env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out1 = []
        try:
            for line in proc.stdout:
                out1.append(line.rstrip("\n"))
                if line.startswith("step 0:"):
                    proc.send_signal(signal.SIGTERM)
                    break
            out1 += proc.communicate(timeout=600)[0].splitlines()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall1 = time.monotonic() - t0
        drained = [x for x in out1 if x.startswith("drain: checkpoint saved at step")]
        if proc.returncode != 113 or not drained:
            raise AssertionError(f"LoRA fine_tune exited {proc.returncode}, not 113:\n"
                                 + "\n".join(out1[-40:]))
        at = int(drained[0].split()[5])
        groups = sorted({s["name"].split("/")[0]
                         for s in ckpt.read_manifest(Path(vol) / str(at))})
        t0 = time.monotonic()
        run2 = subprocess.run(cmd + ["--steps", str(at + 3)], env=env, text=True,
                              capture_output=True, timeout=600)
        wall2 = time.monotonic() - t0
        out2 = run2.stdout.splitlines()
        if run2.returncode != 0:
            raise AssertionError(f"LoRA relaunch exited {run2.returncode}:\n{run2.stderr[-4000:]}")
        msg = {"messages": [{"role": "user", "content": "after the drain"}],
               "max_tokens": 8, "temperature": 0}
        (code, via), boot_s = serve_main(
            ["--preset", preset, "--port", "0", "--checkpoint-dir", vol,
             "--max-new-tokens", "8", "--slots", "2", *extra],
            lambda base: (code_of("POST", base + "/v1/chat/completions", msg)[0],
                          json.loads(http("GET", base + "/readyz")[1])["weights_via"]))
    out = dict(launch1=dict(rc=proc.returncode, wall_s=wall1, drained=drained,
                            checkpoint_groups=groups),
               launch2=dict(rc=run2.returncode, wall_s=wall2,
                            lines=[x for x in out2 if not x.startswith("step ")]),
               serve=dict(code=code, weights_via=via, boot_s=boot_s))
    log("lora drain (10b)", json.dumps(out))
    ok = (at >= 1 and groups == ["lora", "mu", "nu"]
          and f"resumed from step {at}" in out2
          and any(x.startswith("params exported to") for x in out2)
          and code == 200 and via == "packed")
    if not ok:
        raise AssertionError(f"10b: LoRA drain and resume: {out}")
    return out


# -- phase 11: prefill/decode disaggregation ------------------------------------

DISAGG_KW = dict(slots=8, steps_per_sync=4, prefill_chunk_tokens=128, kv_block_size=16)
FLOOD_LEN = 1800
# The model and device of the subprocesses of 11(b) and 11(c).
DISAGG_PRESET, DISAGG_DEVICE = "smol-1b", "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))


def disagg_requests(n_new: int = 32) -> list:
    """Phase 4's 8 requests, then the reference drill's awkward lengths: a
    prompt that ends mid-block, one that leaves a chunk remainder of 2, a
    decode that crosses a block boundary, and a one-token request that
    completes on the prefill tier."""
    return [(p, n_new) for p in engine_prompts()] + [
        (byte_prompt(40, 29), 20), (byte_prompt(41, 130), 24),
        (byte_prompt(42, 32), 35), (byte_prompt(43, 17), 1)]


class Tiers:
    """A decode engine behind the port's TransferServer and a prefill
    engine whose TransferClient dials it over localhost TCP, in this
    process. Each send is timed (handoff seconds include the ack), and a
    request submitted with a `fault` has its handoff rewritten by that
    fault of handoff_mutants before it leaves."""

    def __init__(self, cfg, params, **kw):
        from dstack_tpu_torch.workloads.kv_transfer import TransferClient, TransferServer
        from dstack_tpu_torch.workloads.serving import ServingEngine

        self.dec = ServingEngine(cfg, params, role="decode", **kw)
        self.outs, self.sends, self.captured = {}, [], {}
        self.capture, self.faults = set(), {}
        self._lock = threading.Lock()
        self.server = TransferServer("127.0.0.1", 0, self._on_handoff,
                                     epoch=self.dec.handoff_epoch)
        self.client = TransferClient("127.0.0.1", self.server.port)
        tiers = self

        class Sender:
            def send(self, h):
                fault = tiers.faults.pop(h.request_id, None)
                if fault is not None:
                    h = handoff_mutants(h)[fault]
                if h.request_id in tiers.capture:
                    tiers.captured[h.request_id] = h
                t0 = time.monotonic()
                tiers.client.send(h)
                tiers.sends.append((h.request_id, h.payload_bytes, time.monotonic() - t0))

        self.pre = ServingEngine(cfg, params, role="prefill", kv_transfer=Sender(), **kw)
        self._rid = 0

    def _on_handoff(self, h):
        out = self.dec.submit_prefilled(h)
        with self._lock:
            self.outs[h.request_id] = out

    def submit(self, prompt, n_new, fault=None):
        """(request id, the prefill tier's queue)."""
        self._rid += 1
        if fault is not None:
            self.faults[self._rid] = fault
        return self._rid, self.pre.submit(prompt, n_new, temperature=0.0,
                                          request_id=self._rid)

    def collect(self, rid, out, n_new):
        """(tokens, first-token time): a one-token request from the
        prefill tier, any other from the decode tier after the ack."""
        toks, t_first = drain(out)
        if n_new <= 1:
            return toks, t_first
        if toks:
            raise AssertionError(f"the prefill tier streamed {toks} for a handoff")
        with self._lock:
            q = self.outs.pop(rid)
        return drain(q)

    def warmup(self):
        return self.pre.warmup()["programs"], self.dec.warmup()["programs"]

    def close(self):
        self.pre.close()
        self.dec.close()
        self.server.close()
        self.client.close()


def run_split_wave(submit, collect, reqs) -> dict:
    """A wave of (prompt, n_new) requests: the first alone (its prefix is
    published before the other sharer comes), then the rest together,
    each collected by a thread of its own so a first token is stamped as
    it lands; streams and submit -> first-token seconds."""
    t_sub = [time.monotonic()]
    rid, q = submit(*reqs[0])
    results = [collect(rid, q, reqs[0][1])]
    subs = []
    for p, n in reqs[1:]:
        t_sub.append(time.monotonic())
        subs.append((submit(p, n), n))
    results += [None] * len(subs)

    def read(i, rid, q, n):
        results[i] = collect(rid, q, n)

    readers = [threading.Thread(target=read, args=(i, rid, q, n), daemon=True)
               for i, ((rid, q), n) in enumerate(subs, 1)]
    for r in readers:
        r.start()
    for r in readers:
        r.join(timeout=600)
    if any(r is None for r in results):
        raise AssertionError("a request of the wave did not finish")
    return dict(streams=[t for t, _ in results],
                ttft=sorted(tf - ts for (_, tf), ts in zip(results, t_sub)))


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def wait_zero_residue(engines, timeout: float = 30.0) -> None:
    """Every pool back to its cached blocks (in_use == cached, the no-leak
    condition: the prefix cache holds blocks at ref 1)."""
    deadline = time.monotonic() + timeout
    while True:
        left = {e.role: (e.stats()["kv_blocks_in_use"], e.stats()["kv_blocks_cached"])
                for e in engines}
        if all(a == b for a, b in left.values()):
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"block residue (in use, cached) by role: {left}")
        time.sleep(0.05)


def check_tier_launches(launches: int, by_tier: dict) -> None:
    """The paged kernel ran on both tiers, and every launch the wrapper
    counted came from one of them."""
    if launches <= 0 or any(n <= 0 for n in by_tier.values()) \
            or sum(by_tier.values()) != launches:
        raise AssertionError(f"paged launches {launches}, by tier {by_tier}")


def check_bytes(sent: int, received: int, wire_received: int) -> None:
    if not sent or sent != received or received != wire_received:
        raise AssertionError(f"handoff bytes sent {sent}, admitted {received},"
                             f" off the wire {wire_received}")


def handoff_logits(cfg, params, h) -> float:
    """The decode side's reading of a handoff: its blocks scattered into a
    fresh pool, one chunk-prefill step of the handed first token over them
    (attention through the paged kernel), its logits against the dense
    plain forward's after prompt + first token, over max |logit|."""
    from dstack_tpu_torch.workloads.kv_blocks import init_paged_state, make_chunk_prefill

    dev = params["embed"].device
    bs = h.k.shape[2]
    need = len(h.prompt) // bs + 1  # the first token's row too
    st = init_paged_state(cfg, 1, need * bs, bs, need, dev)
    st.k[:, :h.n_blocks] = h.k.to(dev, st.k.dtype)
    st.v[:, :h.n_blocks] = h.v.to(dev, st.v.dtype)
    _, _, logits = make_chunk_prefill(cfg, 8)(
        params, st, 0, list(range(need)), [h.first_token] + [0] * 7, 1, len(h.prompt),
        2, 0.0, 1.0, None, True)
    ref = dense_logits(cfg, params, list(h.prompt) + [h.first_token])
    return float((logits.float() - ref).abs().max() / ref.abs().max())


def handoff_mutants(h) -> dict:
    """Faults of a gather or a wire: the partial tail block exchanged with
    the full block before it, and a block lost (zeros). Exchanging two
    FULL blocks is no fault: each cached key already carries its rope
    rotation, so attention over the pairs is the same set in another
    order."""
    n = h.n_blocks
    tail = list(range(n - 2)) + [n - 1, n - 2]
    zk, zv = h.k.clone(), h.v.clone()
    zk[:, n // 2] = 0
    zv[:, n // 2] = 0
    return {"tail_swapped": h._replace(k=h.k[:, tail], v=h.v[:, tail]),
            "block_zeroed": h._replace(k=zk, v=zv),
            "full_blocks_swapped": h._replace(k=h.k[:, [1, 0] + list(range(2, n))],
                                              v=h.v[:, [1, 0] + list(range(2, n))])}


def check_handoff_gate(cfg, params, h, tol) -> dict:
    """The handoff's logits within `tol`; each fault's beyond it."""
    readings = {"sound": handoff_logits(cfg, params, h)}
    for name, m in handoff_mutants(h).items():
        readings[name] = handoff_logits(cfg, params, m)
    if not readings["sound"] <= tol:
        raise AssertionError(f"a sound handoff's logits are off: {readings}")
    caught = [readings[k] > tol for k in ("tail_swapped", "block_zeroed")]
    if not all(caught):
        raise AssertionError(f"the handoff gate passes a faulty payload: {readings}")
    return readings


def fault_sweep(cfg, params, tiers, reqs, refs, tol) -> dict:
    """Recorded, not gated: each request's handoff with its tail block
    exchanged (prompts with a partial tail; a prompt of whole blocks has
    none, and exchanging two full blocks is no fault) and with a block
    zeroed, through the decode engine, each stream held against the
    unified one by the first-divergence rule alone (the dense gap at the
    first differing token) and by the near-tie rule; how many faults each
    passes, and the streams by request (None where not run)."""
    bs = DISAGG_KW["kv_block_size"]
    out = {}
    for fault in ("tail_swapped", "block_zeroed"):
        streams, first, held = [None] * len(reqs), 0, 0
        for j, ((p, n), good) in enumerate(zip(reqs, refs)):
            if n <= 1 or (fault == "tail_swapped" and len(p) % bs == 0):
                continue
            rid, q = tiers.submit(p, n, fault=fault)
            streams[j] = tiers.collect(rid, q, n)[0]
            r = near_tie(cfg, params, p, good, streams[j], tol)
            first += not r["diverged"] or (r["gap"] is not None and r["gap"] <= tol)
            held += r["ok"]
        out[fault] = {"faults": sum(s is not None for s in streams),
                      "first_divergence_rule_passes": first, "near_tie_rule_passes": held,
                      "streams": streams}
    return out


def itl_p95(times) -> dict:
    """Inter-token gaps over every stream (arrival times per stream; the
    engine hands a stream steps_per_sync tokens at a time, so most gaps
    are ~0 and the tail is the chunk's wall time)."""
    gaps = [b - a for ts in times for a, b in zip(ts, ts[1:])]
    if not gaps:
        return {"p50_ms": None, "p95_ms": None, "max_ms": None, "gaps": 0}
    return {"p50_ms": 1e3 * pct(gaps, 0.5), "p95_ms": 1e3 * pct(gaps, 0.95),
            "max_ms": 1e3 * max(gaps), "gaps": len(gaps)}


def flood_run(submit_live, submit_flood, n_live=4, live_new=160, n_flood=6,
              flood_len=FLOOD_LEN) -> dict:
    """n_live decoding streams, and once each has its first token a flood
    of n_flood prompts of flood_len tokens x 1 new token (a one-token
    request never leaves the prefill tier): the live streams' inter-token
    gaps while the flood is in, and over their whole decode.
    `submit_live(prompt, n)` returns a callable that gives the stream's
    queue."""
    lives = [submit_live(byte_prompt(60 + i, 64), live_new) for i in range(n_live)]
    queues = [get_queue() for get_queue in lives]
    got = [None] * n_live
    first = [threading.Event() for _ in range(n_live)]

    def read(i):  # arrival times are taken as the tokens land
        toks, times = [], []
        try:
            while True:
                t = queues[i].get(timeout=600)
                if t is None or isinstance(t, BaseException):
                    break
                toks.append(t)
                times.append(time.monotonic())
                first[i].set()
            got[i] = (toks, times) if t is None else t
        finally:
            first[i].set()

    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(n_live)]
    for r in readers:
        r.start()
    for e in first:  # every live stream is decoding
        e.wait(timeout=600)
    t0 = time.monotonic()
    floods = [submit_flood(byte_prompt(70 + i, flood_len)) for i in range(n_flood)]
    for q in floods:
        drain(q)
    t1 = time.monotonic()
    for r in readers:
        r.join(timeout=600)
    if any(not isinstance(g, tuple) or len(g[0]) != live_new for g in got):
        raise AssertionError(f"live streams: {[g if not isinstance(g, tuple) else len(g[0]) for g in got]}")
    times = [ts for _, ts in got]
    window = [[t for t in ts if t0 <= t <= t1] for ts in times]
    return {"flood_s": t1 - t0, "in_flood": itl_p95(window), "whole": itl_p95(times)}


def run_disagg(cfg, params, n_new: int = 32) -> dict:
    """Phase 11(a): a prefill engine and a decode engine joined by the
    port's TransferServer and TransferClient over localhost TCP, against
    the unified engine (phase 4's settings) on the same card. Gates:
    streams by the near-tie rule; zero residue on both pools; bytes sent
    = admitted = off the wire; the paged kernel on both tiers; a stale
    payload rejected and counted after bump_handoff_epoch; a cancel
    mid-handoff with zero residue; a handoff's logits through the paged
    kernel, and their faults failing it; a tail-swapped handoff through
    the decode engine's admission failing the near-tie rule (and, not
    gated, how many such faults each rule passes). Times: handoff bytes,
    transfer seconds and GB/s, both TTFT legs against unified TTFT, decode
    tok/s (unified, split, split, unified), and the decode tier's
    inter-token p95 under a flood of long prompts against the unified
    engine's."""
    from dstack_tpu_torch.workloads import kv_blocks
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.kv_transfer import StaleEpochError, TransferClient
    from dstack_tpu_torch.workloads.serving import ServingEngine

    reqs = disagg_requests(n_new)
    tol = ENGINE_LOGIT_TOL[cfg.activation_dtype]
    uni = ServingEngine(cfg, params, **DISAGG_KW)
    tiers = Tiers(cfg, params, **DISAGG_KW)
    out = {"requests": len(reqs)}
    try:
        uni.warmup()
        out["warmup_programs"] = tiers.warmup()

        def uni_submit(p, n):
            return None, uni.submit(p, n, temperature=0.0)

        def uni_collect(_, q, n):
            return drain(q)

        def split_run(tally=False):
            d0 = tiers.dec.stats()
            p0 = tiers.pre.stats()
            n_sends = len(tiers.sends)
            by_thread = {}
            real = kv_blocks.ragged_attention
            if tally:
                def counted(*a, **k):
                    r = real(*a, **k)
                    ident = threading.get_ident()
                    by_thread[ident] = by_thread.get(ident, 0) + 1
                    return r

                kv_blocks.ragged_attention = counted
                pa.LAUNCHES["ragged_paged_attention"] = 0
            try:
                w = run_split_wave(tiers.submit, tiers.collect, reqs)
            finally:
                kv_blocks.ragged_attention = real
            launches = pa.LAUNCHES["ragged_paged_attention"]
            d1, p1 = tiers.dec.stats(), tiers.pre.stats()
            tokens = sum(len(s) - 1 for s in w["streams"])
            w["decode_tokens_per_s"] = tokens / max(
                d1["decode_seconds_total"] - d0["decode_seconds_total"], 1e-9)
            handed = d1["admitted_total"] - d0["admitted_total"]
            w["ttft_prefill_leg_mean_s"] = (
                (p1["ttft_seconds_sum"] - p0["ttft_seconds_sum"])
                / max(p1["admitted_total"] - p0["admitted_total"], 1))
            w["ttft_decode_leg_mean_s"] = (
                (d1["ttft_seconds_sum"] - d0["ttft_seconds_sum"]) / max(handed, 1))
            w["sends"] = tiers.sends[n_sends:]
            if tally:
                w["launches"] = launches
                w["launches_by_tier"] = {
                    "prefill": by_thread.get(tiers.pre._thread.ident, 0),
                    "decode": by_thread.get(tiers.dec._thread.ident, 0)}
            return w

        def uni_run():
            s0 = uni.stats()
            w = run_split_wave(uni_submit, uni_collect, reqs)
            s1 = uni.stats()
            w["decode_tokens_per_s"] = sum(len(s) - 1 for s in w["streams"]) / max(
                s1["decode_seconds_total"] - s0["decode_seconds_total"], 1e-9)
            return w

        big = max(range(len(reqs)), key=lambda i: len(reqs[i][0]))
        tiers.capture = {tiers._rid + 1 + big}
        runs = [("unified", uni_run()), ("split", split_run(tally=True)),
                ("split", split_run()), ("unified", uni_run())]
        ref, split = runs[0][1], runs[1][1]
        if [len(s) for s in split["streams"]] != [n for _, n in reqs]:
            raise AssertionError(f"split stream lengths {[len(s) for s in split['streams']]}")
        prompts = [p for p, _ in reqs]
        held = hold_streams(cfg, params, prompts, ref["streams"], split["streams"], tol,
                            "disaggregated")
        held["bit_exact"] = sum(a == b for a, b in zip(ref["streams"], split["streams"]))
        held_2 = hold_streams(cfg, params, prompts, ref["streams"], runs[2][1]["streams"],
                              tol, "disaggregated, second run")
        check_tier_launches(split["launches"], split["launches_by_tier"])
        must_fail(check_tier_launches, split["launches"],
                  {**split["launches_by_tier"], "prefill": 0})
        wait_zero_residue([tiers.pre, tiers.dec])
        leaked = tiers.dec._alloc.alloc()
        must_fail(wait_zero_residue, [tiers.dec], timeout=0.1)
        tiers.dec._alloc.release(leaked)
        ps, ds = tiers.pre.stats(), tiers.dec.stats()
        check_bytes(ps["kv_transfer_bytes_total"], ds["kv_transfer_bytes_total"],
                    tiers.server.bytes_received)
        must_fail(check_bytes, ps["kv_transfer_bytes_total"],
                  ds["kv_transfer_bytes_total"] - block_bytes(cfg, DISAGG_KW["kv_block_size"]),
                  tiers.server.bytes_received)
        # The handoff gate on the largest prompt's payload, and its faults.
        (h,) = tiers.captured.values()
        readings = check_handoff_gate(cfg, params, h, tol)
        # The faults through the decode engine's own admission
        # (submit_prefilled, _admit_prefilled, _inject_chain, _place_slot):
        # the tail-swapped stream of the prompt that ends mid-block fails
        # the near-tie rule against the unified engine's.
        sweep = fault_sweep(cfg, params, tiers, reqs, ref["streams"], tol)
        i = len(engine_prompts())
        (p, _), good = reqs[i], ref["streams"][i]
        bad = sweep["tail_swapped"]["streams"][i]

        def hold_faulty(bad):
            hold_streams(cfg, params, [p], [good], [bad], tol, "a tail-swapped handoff")

        engine_fault = {"stream": bad, "unified": good, "near_tie": near_tie(
            cfg, params, p, good, bad, tol), "gate": must_fail(hold_faulty, bad),
            "sweep": {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
                      for k, v in sweep.items()}}

        # Stale epoch: a client that learned the epoch before the bump.
        stale = TransferClient("127.0.0.1", tiers.server.port, retry_stale=False)
        try:
            stale._connect()
            tiers.dec.bump_handoff_epoch()
            tiers.server.bump_epoch()
            try:
                stale.send(h._replace(request_id=10 ** 6))
                raise AssertionError("a stale handoff was admitted")
            except StaleEpochError:
                pass
            try:
                tiers.dec.submit_prefilled(h._replace(request_id=10 ** 6 + 1))
                raise AssertionError("the decode engine admitted a stale epoch")
            except StaleEpochError:
                pass
        finally:
            stale.close()
        ds = tiers.dec.stats()
        if tiers.server.stale_rejected != 1 or ds["kv_handoffs_stale_rejected_total"] != 1:
            raise AssertionError(f"stale rejects: wire {tiers.server.stale_rejected},"
                                 f" engine {ds['kv_handoffs_stale_rejected_total']}")
        wait_zero_residue([tiers.dec])
        # The live client's next handoff is rejected once and lands on
        # its retry with the new epoch.
        rid, q = tiers.submit(byte_prompt(44, 100), 8)
        if len(tiers.collect(rid, q, 8)[0]) != 8 or tiers.client.stale_rejects_seen != 1:
            raise AssertionError("the live client did not recover from the epoch bump")
        # Cancel mid-handoff.
        rid, q = tiers.submit(byte_prompt(45, FLOOD_LEN), 30)
        tiers.pre.cancel(q)
        drain(q)
        with tiers._lock:
            late = tiers.outs.pop(rid, None)
        if late is not None:
            drain(late)  # the handoff raced ahead of the cancel
        wait_zero_residue([tiers.pre, tiers.dec])
        status = tiers.pre.request_trace(rid)["status"]

        sends = [s for _, _, s in split["sends"]]
        nbytes = [b for _, b, _ in split["sends"]]
        out.update(
            near_tie=held, near_tie_second_run=held_2,
            launches=split["launches"], launches_by_tier=split["launches_by_tier"],
            handoffs=len(sends), handoff_bytes_per_request=nbytes,
            handoff_bytes_mean=statistics.mean(nbytes),
            block_bytes=block_bytes(cfg, DISAGG_KW["kv_block_size"]),
            transfer_s_p50=pct(sends, 0.5), transfer_s_p95=pct(sends, 0.95),
            transfer_gb_per_s=sum(nbytes) / sum(sends) / 1e9,
            engine_transfer_s_mean=ps["kv_transfer_hist"]["sum"] / ps["kv_transfer_hist"]["count"],
            ttft_unified_p50_s=statistics.median(ref["ttft"]),
            ttft_unified_p95_s=pct(ref["ttft"], 0.95),
            ttft_split_p50_s=statistics.median(split["ttft"]),
            ttft_split_p95_s=pct(split["ttft"], 0.95),
            ttft_prefill_leg_mean_s=split["ttft_prefill_leg_mean_s"],
            ttft_decode_leg_mean_s=split["ttft_decode_leg_mean_s"],
            decode_tokens_per_s={"order": [k for k, _ in runs],
                                 "values": [r["decode_tokens_per_s"] for _, r in runs]},
            handoff_logits=readings, engine_fault=engine_fault, stale_rejected=1,
            cancel_status=status,
            bytes_sent=ps["kv_transfer_bytes_total"],
            bytes_received=ds["kv_transfer_bytes_total"],
        )

        def uni_live(p, n):
            q = uni.submit(p, n, temperature=0.0)
            return lambda: q

        out["flood_itl"] = {
            "unified": flood_run(uni_live, lambda p: uni.submit(p, 1, temperature=0.0)),
            "split": flood_run(lambda p, n: split_live(tiers, p, n),
                               lambda p: tiers.pre.submit(p, 1, temperature=0.0)),
        }
        wait_zero_residue([tiers.pre, tiers.dec, uni])
    finally:
        tiers.close()
        uni.close()
    torch.cuda.empty_cache()
    out["seam_alone"] = seam_alone(h)
    log("disagg (11a)", json.dumps(out))
    return out


def seam_alone(h, n: int = 10) -> dict:
    """The seam by itself: a handoff sent n times through a fresh
    TransferServer/TransferClient pair over localhost in this process with
    no engine thread running (the server's callback only counts), so its
    seconds are the wire's and the framing's, not the GIL's."""
    from dstack_tpu_torch.workloads.kv_transfer import TransferClient, TransferServer

    server = TransferServer("127.0.0.1", 0, lambda _: None)
    client = TransferClient("127.0.0.1", server.port)
    secs = []
    try:
        for _ in range(n):
            t0 = time.monotonic()
            client.send(h)
            secs.append(time.monotonic() - t0)
    finally:
        client.close()
        server.close()
    return {"bytes": h.payload_bytes, "s_p50": pct(secs, 0.5), "s_min": min(secs),
            "gb_per_s": h.payload_bytes / pct(secs, 0.5) / 1e9}


def split_live(tiers, prompt, n_new):
    """Submit a live request to the prefill tier; the returned callable
    waits for the ack and gives the decode tier's queue."""
    rid, q = tiers.submit(prompt, n_new)

    def decode_queue():
        toks, _ = drain(q)
        if toks:
            raise AssertionError(f"the prefill tier streamed {toks} for a handoff")
        with tiers._lock:
            return tiers.outs.pop(rid)

    return decode_queue


class Background:
    """A command run beside the smoke's own work (its output in temporary
    files, so a full pipe never stalls it); `result` waits for it, kills
    it past `timeout` seconds from its start, and returns (returncode,
    stdout, stderr, seconds)."""

    def __init__(self, argv):
        import tempfile

        self.out = tempfile.TemporaryFile(mode="w+")
        self.err = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(argv, cwd=ROOT, stdout=self.out, stderr=self.err,
                                     text=True, start_new_session=True)

    def result(self, timeout: float):
        try:
            code = self.proc.wait(timeout=max(0.1, self.t0 + timeout - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()
            raise
        seconds = time.monotonic() - self.t0
        texts = []
        for f in (self.out, self.err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        return code, texts[0], texts[1], seconds


def disagg_drill_path() -> str:
    return os.path.join(ROOT, os.path.dirname(OUT), "disagg_drill.json")


def start_disagg_drill() -> Background:
    """Phase 11(b): the two-process drill on the card, as a user runs it:
    python -m dstack_tpu_torch.workloads.serving_disagg --device cuda
    --preset smol-1b, started beside 11(c) (both only serve and check)."""
    path = disagg_drill_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return Background([sys.executable, "-m", "dstack_tpu_torch.workloads.serving_disagg",
                       "--device", DISAGG_DEVICE, "--preset", DISAGG_PRESET, "--out", path])


def run_disagg_drill(timeout: int = 900, started=None) -> dict:
    """Phase 11(b)'s result (`started`, or the drill run now): it must exit
    0 with every check of its own passed."""
    path = disagg_drill_path()
    code, stdout, stderr, seconds = (started or start_disagg_drill()).result(timeout)
    for line in stdout.splitlines():
        if line.startswith("[drill]"):
            log("  " + line)
    if code != 0:
        raise AssertionError(f"the drill exited {code}: {stderr[-3000:]}")
    with open(path) as f:
        report = json.load(f)
    checks = report["checks"]
    need = ("params_equal", "trace_continuity", "stale_reject_recovered", "zero_residue")
    if not report.get("ok") or not all(checks.get(k) for k in need):
        raise AssertionError(f"the drill's checks: {checks}")
    out = dict(seconds=seconds, n_layers=report["n_layers"], checks=checks,
               handoffs_sent=report["handoffs_sent"],
               transfer_bytes=report["transfer_bytes"],
               transfer_seconds_mean=report["transfer_seconds_mean"],
               transfer_gb_per_s=report["transfer_gb_per_s"],
               scenarios_seconds=report["scenarios_seconds"])
    log("disagg drill (11b)", json.dumps(out))
    return out


class ServerProc:
    """python -m dstack_tpu_torch.native_server in a subprocess: its HTTP
    port (and a decode tier's transfer port) read off its stdout."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dstack_tpu_torch.native_server", *argv], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines, self.port, self.transfer_port = [], None, None
        self._seen = threading.Condition()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            with self._seen:
                self.lines.append(line.rstrip())
                m = re.search(r"kv transfer server on :(\d+)", line)
                if m:
                    self.transfer_port = int(m.group(1))
                m = re.search(r"native model server .* on :(\d+)", line)
                if m:
                    self.port = int(m.group(1))
                self._seen.notify_all()

    def wait_for(self, what: str, timeout: float = 300.0) -> int:
        deadline = time.monotonic() + timeout
        with self._seen:
            while getattr(self, what) is None:
                if self.proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"native_server gave no {what}: {self.lines[-20:]}")
                self._seen.wait(0.5)
            return getattr(self, what)

    def ready(self, timeout: float = 300.0) -> str:
        import urllib.error

        base = f"http://127.0.0.1:{self.wait_for('port', timeout)}"
        deadline = time.monotonic() + timeout
        while True:
            try:
                if http("GET", base + "/readyz", timeout=10)[0] == 200:
                    return base
            except (urllib.error.URLError, ConnectionError):
                pass
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"native_server never turned ready: {self.lines[-20:]}")
            time.sleep(0.2)

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


ROLE_SERIES = {
    "prefill": ('dstack_tpu_serving_ttft_seconds_count{role="prefill"} 1',
                'dstack_tpu_serving_kv_transfer_seconds_count{role="prefill"} 1',
                "dstack_tpu_serving_kv_handoffs_sent_total 1"),
    "decode": ('dstack_tpu_serving_ttft_seconds_count{role="decode"} 1',
               'dstack_tpu_serving_tpt_seconds_count{role="decode"}',
               "dstack_tpu_serving_kv_handoffs_received_total 1"),
}


def run_disagg_http(cfg, params, n_new: int = 16) -> dict:
    """Phase 11(c): native_server --role decode --kv-transfer-port 0 and
    --role prefill --kv-transfer-connect in subprocesses (smol-1b, seed 0),
    and a unified server in this process on the same weights. A chat on the
    prefill tier answers kv_handoff with a handoff_id; the decode tier's
    /v1/handoffs/<id> streams tokens that hold by the near-tie rule against
    the unified server's (read by a spy on its engine's submit); both
    tiers export their role-labelled series."""
    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

    common = ["--preset", DISAGG_PRESET, "--device", DISAGG_DEVICE, "--seed", "0",
              "--host", "127.0.0.1", "--port", "0", "--max-new-tokens", str(n_new)]
    t0 = time.monotonic()
    dec = ServerProc(common + ["--role", "decode", "--kv-transfer-port", "0"])
    pre = None
    uni = Engine(DISAGG_PRESET, max_new_tokens=n_new, params=params,
                 device=params["embed"].device)
    server, ready = make_server(uni, "127.0.0.1", 0)
    bu = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    seen = []
    real_submit = uni.serving.submit

    def submit(tokens, *a, **kw):
        q = real_submit(tokens, *a, **kw)
        ids = []
        seen.append((list(tokens), ids))
        real_get = q.get

        def get(*ga, **gk):
            item = real_get(*ga, **gk)
            if isinstance(item, int):
                ids.append(item)
            return item

        q.get = get
        return q

    uni.serving.submit = submit
    try:
        tport = dec.wait_for("transfer_port")
        pre = ServerProc(common + ["--role", "prefill", "--kv-transfer-connect",
                                   f"127.0.0.1:{tport}"])
        start_warmup(uni, ready).join(timeout=300)
        bd, bp = dec.ready(), pre.ready()
        boot_s = time.monotonic() - t0
        msg = {"messages": [{"role": "user", "content": "disaggregate this request"}],
               "max_tokens": n_new, "temperature": 0}
        code, body = http("POST", bp + "/v1/chat/completions", msg)
        ack = json.loads(body)
        if code != 200 or ack["choices"][0]["finish_reason"] != "kv_handoff" \
                or "handoff_id" not in ack:
            raise AssertionError(f"the prefill tier answered {code} {body[:500]}")
        code, body = http("GET", bd + f"/v1/handoffs/{ack['handoff_id']}")
        events = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: {")]
        if code != 200 or not body.rstrip().endswith("data: [DONE]"):
            raise AssertionError(f"the decode tier's stream: {code} {body[-500:]}")
        got = [e["token"] for e in events]
        code, body = http("POST", bu + "/v1/chat/completions", msg)
        if code != 200:
            raise AssertionError(f"the unified server answered {code}")
        (prompt, want), = seen
        held = hold_streams(cfg, params, [prompt], [want], [got],
                            ENGINE_LOGIT_TOL[cfg.activation_dtype], "http tiers")
        series = {}
        for role, base in (("prefill", bp), ("decode", bd)):
            prom = http("GET", base + "/metrics?format=prometheus")[1]
            missing = [s for s in ROLE_SERIES[role] if s not in prom]
            if missing:
                raise AssertionError(f"the {role} tier's Prometheus text lacks {missing}")
            series[role] = len(ROLE_SERIES[role])
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        uni.serving.submit = real_submit
        uni.close()
        for proc in (pre, dec):
            if proc is not None:
                proc.stop()
    torch.cuda.empty_cache()
    out = dict(boot_s=boot_s, tokens=len(got), bit_exact=got == want, near_tie=held,
               handoff_id=ack["handoff_id"], role_series=series)
    log("disagg http (11c)", json.dumps(out))
    return out


# -- phase 12: Podracer RL ----------------------------------------------------

RL_PRESET, RL_DEVICE = "smol-1b", "cuda"
# 12(a)'s depth: 4 of smol-1b's 16 layers at full width (8 since PR 15,
# when the whole smoke neared its limit; 4 since PR 19, which added 14(g),
# 15(h) and 18(c); its gates are sha1, bit equality and counts).
RL_LAYERS = 4
RL_ENV = dict(prompt_len=64, horizon=64)
RL_BATCH = 8
RL_UPDATES = {"socket": 3, "direct": 1, "checkpoint": 1}
# A fine-tuning rate for a 1B policy at which a bf16 Adam step still moves
# most weights by an ulp or more (run_anakin's 2e-2 is the tiny policy's).
RL_LR = 1e-4
RL_CLIP = 0.2


def kernel_counts() -> dict:
    """Launches of kernels #1-#4 so far (the paged kernel and the three
    single-device flash kernels)."""
    from dstack_tpu_torch.workloads import paged_attention as pa

    fl = flash_counts()
    return {"ragged_paged_attention": pa.LAUNCHES["ragged_paged_attention"],
            **{k: fl[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}


def zero_kernel_counts() -> None:
    from dstack_tpu_torch.workloads import paged_attention as pa

    pa.LAUNCHES["ragged_paged_attention"] = 0
    zero_flash_counts()


def leaf_digests(named) -> dict:
    """name -> sha1 of the leaf's bytes (a host copy of each), the leaves
    hashed on 8 threads (hashlib lets go of the GIL)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    def one(t):
        raw = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy()
        return hashlib.sha1(raw).hexdigest()

    named = list(named)
    with ThreadPoolExecutor(8) as pool:
        return dict(zip([n for n, _ in named], pool.map(one, [t for _, t in named])))


def check_moved(before: dict, after: dict) -> None:
    """A learner update changed some leaf (else an adoption check of its
    publish would hold vacuously)."""
    if before == after:
        raise AssertionError("the learner update moved no weight")


def check_adopted(published: dict, engine: dict) -> None:
    """The engine's weights after an adoption are the published ones, leaf
    for leaf by sha1."""
    bad = sorted(k for k in set(published) | set(engine) if published.get(k) != engine.get(k))
    if bad:
        raise AssertionError(f"adopted weights differ from the published ones: {bad[:4]}")


def check_unchanged(before: dict, now: dict, what: str) -> None:
    """Step 0's isolation: `now` holds `before`'s bytes in every leaf (sha1
    digests of leaf_digests)."""
    bad = sorted(k for k in before if before[k] != now.get(k))
    if bad:
        raise AssertionError(f"{what} changed under a learner update: {bad[:4]}")


def policy_clip_fraction(learner, batch) -> float:
    """The clip_fraction the learner's PPO step reports for `batch` at its
    current weights: the program's own loss on its own step batch, no step
    taken."""
    from dstack_tpu_torch.workloads import rl
    from dstack_tpu_torch.workloads.attention import make_attention_fn

    step_batch, _ = learner.step_batch([batch])
    with torch.no_grad():
        _, (_, _, clipped) = rl.ppo_loss(learner.config, learner.state.params, step_batch,
                                         make_attention_fn(None), clip_eps=RL_CLIP)
    return float(clipped)


def check_on_policy(clip_frac: float) -> None:
    """The first batch of an update is scored under the weights the
    learner steps from: no ratio may clip."""
    if clip_frac != 0.0:
        raise AssertionError(f"on-policy clip_fraction {clip_frac}, expected 0")


class TimedPoll:
    """A refresh channel whose polls are timed (seconds of the last one
    that returned weights), so an actor's adoption splits into pull and
    adopt."""

    def __init__(self, channel):
        self.channel, self.pull_s = channel, []

    def poll(self, have_epoch):
        t0 = time.monotonic()
        got = self.channel.poll(have_epoch)
        if got is not None:
            self.pull_s.append(time.monotonic() - t0)
        return got

    def close(self):
        if hasattr(self.channel, "close"):
            self.channel.close()


def frame_bytes(mode: str, publisher, cdir: str) -> int:
    """Bytes one adoption moved: the socket frame as it left the server,
    the npz file, or the in-process snapshot's tensors."""
    if mode == "socket":
        return publisher.bytes_sent // max(publisher.pulls_served, 1)
    if mode == "checkpoint":
        return os.path.getsize(os.path.join(cdir, "weights.npz"))
    return sum(t.numel() * t.element_size() for t in publisher.poll(0)[1].values())


def rl_channel_run(cfg, mode: str, updates: int, cdir: str, isolation: bool,
                   target=None) -> dict:
    """Anakin at `cfg`'s width over one refresh channel, instrumented (the
    env's target is `target`, or without one the token a warm-up round
    samples most): each update adopts the last publish at the idle boundary
    (pull and adopt timed; the engine's weights held against the published
    ones by sha1),
    rolls out a round through the paged engine (seconds, env steps/s),
    takes one PPO step through the flash kernels (ms; clip_fraction 0 on
    this on-policy batch, and the largest |logp - behavior| of the
    learner's weights through the scorer, a probe whose launches are not
    counted) and publishes (seconds; the device synchronised on both sides
    of a publish and an adoption). The first update's batch with its
    behavior log-probs one position off (an actor's scorer shifted) must
    fail the on-policy gate through the learner's own loss. With
    `isolation` (the socket channel), the learner takes a step on the
    warm-up batch (which holds a reward, so the weights move: a random
    policy's rounds may hold none), publishes, and the actor adopts; one
    more learner update must leave the published snapshot (read back over
    the wire) and the actor's engine weights unchanged bit for bit, while
    the learner's tensors, which an engine sharing them would hold, fail
    that; a last publish and adoption bring the moved weights. Gates
    `refresh_params` on a busy engine first."""
    import numpy as np

    from dstack_tpu_torch.workloads import rl

    env = rl.TargetTokenEnv(cfg.vocab_size, seed=0, **RL_ENV)
    publisher, channel, server = rl.make_refresh_channel(mode, cdir)
    client = TimedPoll(channel)
    stats = rl.RLStats()
    learner = rl.Learner(cfg, seed=0, learning_rate=RL_LR, clip_eps=RL_CLIP,
                         refresh=publisher, stats=stats, device=RL_DEVICE)
    actor = rl.Actor(cfg, learner.state.params, env, batch_size=RL_BATCH, seed=0,
                     refresh=client, stats=stats, device=RL_DEVICE)
    score = rl.make_sequence_scorer(cfg)
    out = {"mode": mode, "updates": updates, "rollout_s": [], "env_steps_per_s": [],
           "learn_step_ms": [], "publish_s": [], "adopt_s": [], "clip_fraction": [],
           "max_logp_gap": [], "reward_mean": [], "loss": []}
    probe = dict.fromkeys(kernel_counts(), 0)
    published = None

    def sync():
        if RL_DEVICE == "cuda":
            torch.cuda.synchronize()

    def publish() -> dict:
        sync()
        t0 = time.monotonic()
        learner.publish()
        sync()
        out["publish_s"].append(time.monotonic() - t0)
        return leaf_digests(rl.named_params(learner.state.params))

    def adopt() -> dict:
        sync()
        t0 = time.monotonic()
        if not actor.maybe_refresh():
            raise AssertionError(f"{mode}: the actor adopted no new epoch")
        sync()
        out["adopt_s"].append(time.monotonic() - t0 - client.pull_s[-1])
        digests = leaf_digests(rl.named_params(actor.engine.params))
        check_adopted(published, digests)
        return digests

    try:
        # A warm-up round (uncounted) settles the engine's allocations and
        # picks the target: the token the untrained policy samples most.
        # Target 7 of 32768 would be drawn about once in 60 updates, every
        # advantage would be 0 and no step would move a weight.
        if target is None:
            warm = actor.rollout()
            drawn = torch.from_numpy(warm.actions).flatten().long()
            target = int(torch.bincount(drawn, minlength=cfg.vocab_size).argmax())
            out["target_share"] = float((drawn == target).float().mean())
            # Its batch, rewarded for that target, holds at least one reward:
            # the isolation check's extra update always moves the weights.
            env.target = target
            warm = warm._replace(rewards=env.token_rewards(warm.actions) * warm.mask)
        env.target = out["target"] = target
        if mode == "socket":
            actor.engine.hold_admission()
            q = actor.engine.submit([1, 2, 3], 2)
            try:
                actor.engine.refresh_params(learner.state.params)
                raise AssertionError("refresh_params swapped a busy engine's weights")
            except RuntimeError as e:
                out["busy_refusal"] = str(e)[:120]
            actor.engine.release_admission()
            drain(q)
        zero_kernel_counts()
        for u in range(updates):
            if u:
                adopt()
            t0 = time.monotonic()
            batch = actor.rollout()
            dt = time.monotonic() - t0
            out["rollout_s"].append(dt)
            out["env_steps_per_s"].append(batch.env_steps / dt)
            before = kernel_counts()
            tokens = torch.from_numpy(batch.tokens).to(learner.device)
            logp = score(learner.state.params, tokens, 1.0)[:, env.prompt_len - 1:]
            behavior = torch.from_numpy(batch.behavior_logprob).to(learner.device)
            out["max_logp_gap"].append(float((logp - behavior).abs().max()))
            if u == 0:
                # An actor whose scorer is one position off.
                shifted = batch._replace(behavior_logprob=np.roll(batch.behavior_logprob, 1, 1))
                out["shifted_scorer_clip_fraction"] = policy_clip_fraction(learner, shifted)
                out["on_policy_fault"] = must_fail(
                    check_on_policy, out["shifted_scorer_clip_fraction"])
            for k, v in kernel_counts().items():
                probe[k] += v - before[k]
            m = learner.update_from([batch])
            out["learn_step_ms"].append(m["step_seconds"] * 1e3)
            out["clip_fraction"].append(m["clip_fraction"])
            out["reward_mean"].append(m["reward_mean"])
            out["loss"].append(m["loss"])
            check_on_policy(m["clip_fraction"])
            published = publish()
        total = kernel_counts()
        out["launches"] = {k: total[k] - probe[k] for k in total}
        out["launches_per_update"] = {k: v / updates for k, v in out["launches"].items()}
        if isolation:
            learner.update_from([warm])
            moved, previous = publish(), published
            check_moved(previous, moved)
            out["moved_fault"] = must_fail(check_moved, moved, moved)
            published = moved
            # The actor adopts the learner's current weights; an engine that
            # shared the learner's tensors would hold them too (live views),
            # and up to here the two agree.
            adopted = adopt()
            aliased = rl.named_params(learner.state.params)
            check_adopted(published, leaf_digests(aliased))
            learner.update_from([warm])
            reader = rl.WeightRefreshClient("127.0.0.1", server.port)
            try:
                _, snapshot = reader.poll(0)
            finally:
                reader.close()
            check_adopted(published, leaf_digests(snapshot.items()))
            check_unchanged(adopted, leaf_digests(rl.named_params(actor.engine.params)),
                            "the actor's engine weights")
            out["isolation_fault"] = must_fail(check_unchanged, adopted, leaf_digests(aliased),
                                               "an engine sharing the learner's tensors")
            del aliased, snapshot
            published = publish()
        engine_digests = adopt()
        leaf = next(iter(engine_digests))
        bad = dict(rl.named_params(actor.engine.params))[leaf].clone()
        bad.view(torch.uint8).view(-1)[0] ^= 1
        out["weights_fault"] = must_fail(
            check_adopted, published, {**engine_digests, **leaf_digests([(leaf, bad)])})
        out["pull_s"] = client.pull_s
        out["frame_bytes"] = frame_bytes(mode, publisher, cdir)
        # The in-process poll hands over the snapshot itself: no bytes move.
        out["pull_gb_per_s"] = (None if mode == "direct" else
                                [out["frame_bytes"] / s / 1e9 for s in client.pull_s])
        out["adopt_gb_per_s"] = [out["frame_bytes"] / s / 1e9 for s in out["adopt_s"]]
        out["publish_gb_per_s"] = [out["frame_bytes"] / s / 1e9 for s in out["publish_s"]]
        out["adoptions"] = len(client.pull_s)
    finally:
        actor.close()
        if server is not None:
            server.close()
    del learner, actor
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def run_rl_anakin() -> dict:
    """Phase 12(a): smol-1b Anakin on the socket channel (RL_UPDATES), then
    one update each on the in-process and checkpoint channels; the
    launches of kernels #1-#4 on the socket run, which each must reach."""
    import tempfile

    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[RL_PRESET]
    cfg = cfg.with_(n_layers=min(RL_LAYERS, cfg.n_layers))
    runs = {}
    with tempfile.TemporaryDirectory() as cdir:
        for mode, n in RL_UPDATES.items():
            t0 = time.monotonic()
            # The socket run picks the target; the others take it, as their
            # untrained policy (the same seed) would pick it too.
            runs[mode] = rl_channel_run(cfg, mode, n, cdir, isolation=mode == "socket",
                                        target=runs.get("socket", {}).get("target"))
            runs[mode]["seconds"] = time.monotonic() - t0
            log(f"rl anakin ({mode})", json.dumps(runs[mode]))
    launches = runs["socket"]["launches"]
    if RL_DEVICE == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel of the RL path never launched: {launches}")
    return {"preset": RL_PRESET, "batch": RL_BATCH, **RL_ENV, "runs": runs,
            "launches": launches}


# The RL path's attention shapes (policy, batch, prompt, horizon): the
# scorer and the PPO forward run T - 1 = 127 positions at smol-1b (bf16, hd
# 128) and 19 on the tiny policy (f32, hd 32), causal with a ragged last tile.
RL_MODEL_CASES = (("smol-1b", RL_BATCH, RL_ENV["prompt_len"], RL_ENV["horizon"]),
                  ("tiny-rl", 16, 4, 16))
# max |logp kernels - logp plain| over the scorer's positions, about 10x
# the f32 reading and 2x plain bf16's own gap to an f32 model (0.046) on
# the H100.
RL_LOGP_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.1}
BWD_ROWS = 64  # rows of a backward kernel's tile


def rl_model_batch(cfg, B: int, prompt_len: int, horizon: int, seed: int, dev) -> dict:
    """A PPO step batch at the RL path's shapes, from `seed`: random tokens,
    episodes that end between horizon/2 and horizon (the mask), advantages
    of mean 0.5 (so the loss is away from 0); behavior_logprob is left to
    the caller."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, cfg.vocab_size, (B, prompt_len + horizon), generator=g)
    ends = torch.randint(horizon // 2, horizon + 1, (B, 1), generator=g)
    mask = (torch.arange(horizon)[None] < ends).float()
    adv = (torch.randn(B, horizon, generator=g) + 0.5) * mask
    return {"tokens": tokens.to(dev), "mask": mask.to(dev), "advantage": adv.to(dev),
            "temperature": 1.0}


def rl_model_readings(cfg, params, batch, attn) -> dict:
    """The RL path's two uses of attention on one batch with `attn`: the
    scorer's log-probs (no grad) and the PPO loss with its grads."""
    from dstack_tpu_torch.workloads import rl
    from dstack_tpu_torch.workloads.weights import flatten_params

    pairs = flatten_params(params)
    with torch.no_grad():
        logp = rl.token_logprobs(cfg, params, batch["tokens"], 1.0, attn)[1]
    loss, (_, _, clipped) = rl.ppo_loss(cfg, params, batch, attn, clip_eps=RL_CLIP)
    grads = torch.autograd.grad(loss, [t for _, t in pairs])
    return {"logp": logp, "loss": float(loss.detach()), "clip_fraction": float(clipped),
            "grads": {k: g for (k, _), g in zip(pairs, grads)}}


def rl_model_gaps(got: dict, ref: dict) -> dict:
    """Readings of the kernels' readings against plain attention's: the
    scorer's max |delta logp|, the loss's relative gap and the worst leaf's
    grad relative gap."""
    grad_rel = {k: float((g.float() - ref["grads"][k].float()).norm()
                         / ref["grads"][k].float().norm()) for k, g in got["grads"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    return dict(logp_max_abs=float((got["logp"] - ref["logp"]).abs().max()),
                loss=got["loss"], loss_ref=ref["loss"],
                loss_rel=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                clip_fraction=got["clip_fraction"], clip_fraction_ref=ref["clip_fraction"],
                worst_grad_rel=grad_rel[worst], worst_leaf=worst)


def check_rl_model(gaps: dict, dtype) -> None:
    """The scorer's log-probs within RL_LOGP_TOL (max abs), the loss and
    every leaf's grad within MODEL_TOL (relative), as phase 6b holds the
    training loss."""
    tol_loss, tol_grad = MODEL_TOL[dtype]
    if not (gaps["logp_max_abs"] <= RL_LOGP_TOL[dtype] and gaps["loss_rel"] <= tol_loss
            and gaps["worst_grad_rel"] <= tol_grad):
        raise AssertionError(f"the RL path's kernels disagree with plain attention: {gaps}")


def rl_attention_mutants(attn) -> dict:
    """Faults the RL path's shapes could hide, each built on `attn`: the
    causal mask one key late (row i sees key i + 1); the ragged last row
    not stored; the backward's ragged last tile of dQ rows not stored (the
    forward right)."""
    from dstack_tpu_torch.workloads.attention import plain_attention

    def mask_one_late(q, k, v):
        # Against Sq + 1 keys, the plain causal mask lets row i see key i + 1.
        return plain_attention(q, torch.cat([k, k[:, -1:]], 1), torch.cat([v, v[:, -1:]], 1))

    def last_row_lost(q, k, v):
        o = attn(q, k, v)
        return torch.cat([o[:, :-1], torch.zeros_like(o[:, -1:])], 1)

    def tail_dq_lost(q, k, v):
        tail = (q.shape[1] - 1) // BWD_ROWS * BWD_ROWS
        keep = (torch.arange(q.shape[1], device=q.device) < tail).to(q.dtype)[None, :, None, None]
        return attn(q * keep + (q * (1 - keep)).detach(), k, v)

    return {"mask_one_late": mask_one_late, "last_row_lost": last_row_lost,
            "tail_dq_lost": tail_dq_lost}


def run_rl_model_checks() -> dict:
    """Phase 12's kernel gate at the RL path's own shapes (RL_MODEL_CASES, 2
    layers at smol-1b's width): the scorer's log-probs and the PPO loss and
    grads through make_attention_fn(None) (the flash kernels #2-#4) against
    plain_attention, on an on-policy batch (behavior = plain's log-probs,
    as an update's batch is); each of rl_attention_mutants must fail the
    gate. A bf16 case also reads both against an f32 model (plain
    attention, the params upcast), which says which of the two is nearer."""
    from dstack_tpu_torch.workloads import rl
    from dstack_tpu_torch.workloads.attention import make_attention_fn, plain_attention
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params
    from dstack_tpu_torch.workloads.weights import flatten_params, unflatten_params

    out = {}
    for policy, B, prompt_len, horizon in RL_MODEL_CASES:
        cfg = (rl.tiny_rl_config() if policy == "tiny-rl"
               else PRESETS[policy].with_(n_layers=2))
        dtype = getattr(torch, cfg.dtype)
        params = init_params(cfg, 1, RL_DEVICE)
        for _, p in flatten_params(params):
            p.requires_grad_(True)
        batch = rl_model_batch(cfg, B, prompt_len, horizon, 1, RL_DEVICE)
        with torch.no_grad():
            logp = rl.token_logprobs(cfg, params, batch["tokens"], 1.0, plain_attention)[1]
        batch["behavior_logprob"] = logp[:, prompt_len - 1:]
        kern = make_attention_fn(None)
        zero_flash_counts()
        got = rl_model_readings(cfg, params, batch, kern)
        launched = flash_counts()
        ref = rl_model_readings(cfg, params, batch, plain_attention)
        if RL_DEVICE == "cuda" and not all(
                launched[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
            raise AssertionError(f"12: the RL model check ran no flash kernels: {launched}")
        case = rl_model_gaps(got, ref)
        check_rl_model(case, dtype)
        case["mutants"] = {}
        for name, fn in rl_attention_mutants(kern).items():
            gaps = rl_model_gaps(rl_model_readings(cfg, params, batch, fn), ref)
            case["mutants"][name] = {**gaps, "fails": must_fail(check_rl_model, gaps, dtype)}
        if dtype != torch.float32:
            p32 = unflatten_params((k, t.detach().float().requires_grad_(True))
                                   for k, t in flatten_params(params))
            ref32 = rl_model_readings(cfg.with_(dtype="float32"), p32, batch, plain_attention)
            case["vs_f32"] = {name: rl_model_gaps(r, ref32)
                              for name, r in (("kernels", got), ("plain", ref))}
            del p32, ref32
        case.update(dtype=cfg.dtype, batch=B, seq=prompt_len + horizon - 1,
                    head_dim=cfg.head_dim)
        out[policy] = case
        log(f"rl model check ({policy})", json.dumps(case))
        del params, batch, got, ref
        if RL_DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


RL_LEARN_GATE = 0.3


def learning_gate(rewards) -> dict:
    """12(b): the mean reward of the last five updates beats the first
    five's and exceeds RL_LEARN_GATE."""
    head, tail = sum(rewards[:5]) / 5, sum(rewards[-5:]) / 5
    if not (tail > head and tail > RL_LEARN_GATE):
        raise AssertionError(f"no learning: first five {head:.3f}, last five {tail:.3f}")
    return {"head": head, "tail": tail}


def first_difference(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def run_rl_learning() -> dict:
    """Phase 12(b): `run_anakin`'s defaults on the tiny RL policy (f32, hd
    32: the kernels at hd 32), twice: the learning gate, and whether the
    two runs' rewards and losses repeat bit for bit (if not, the first
    update where each differs)."""
    from dstack_tpu_torch.workloads import rl

    t0 = time.monotonic()
    a = rl.run_anakin(rl.tiny_rl_config(), device=RL_DEVICE)
    b = rl.run_anakin(rl.tiny_rl_config(), device=RL_DEVICE)
    out = {"seconds": time.monotonic() - t0, "rewards": a["rewards"], "losses": a["losses"],
           "gate": learning_gate(a["rewards"]),
           "bit_exact": a["rewards"] == b["rewards"] and a["losses"] == b["losses"],
           "first_reward_difference": first_difference(a["rewards"], b["rewards"]),
           "first_loss_difference": first_difference(a["losses"], b["losses"]),
           "learn_step_ms_mean": a["learn_step_s_mean"] * 1e3,
           "env_steps_per_s": a["env_steps_per_s"], "refresh_s_mean": a["refresh_s_mean"],
           "clip_fraction_first": a["metrics"][0]["clip_fraction"]}
    log("rl learning (12b)", json.dumps(out))
    return out


def check_rl_drill(summary: dict) -> None:
    """tests/test_rl.py's drill asserts."""
    survivors = [k for k, v in summary["actor_final_epochs"].items()
                 if v == summary["final_weight_epoch"]]
    if not (summary["ok"] and summary["learner_restarts"] == 0
            and summary["gang_resizes"] == 2 and summary["preemptions"] == 1
            and len(survivors) >= 2):
        raise AssertionError(f"the RL drill's summary: {summary}")


def start_rl_drill() -> Background:
    """Phase 12(c): `python -m dstack_tpu_torch.workloads.rl_drill
    --updates-per-phase 1`, the learner and its actors as separate
    processes on the one card, tiny RL policy; started beside 12(a)-(b)."""
    return Background([sys.executable, "-m", "dstack_tpu_torch.workloads.rl_drill",
                       "--updates-per-phase", "1", "--device", RL_DEVICE])


def run_rl_drill(timeout: int = 600, started=None) -> dict:
    """Phase 12(c)'s result (`started`, or the drill run now): the
    reference drill's summary asserts."""
    code, stdout, stderr, seconds = (started or start_rl_drill()).result(timeout)
    if code != 0:
        raise AssertionError(f"the RL drill exited {code}: {stdout[-2000:]} {stderr[-2000:]}")
    summary = json.loads(stdout[stdout.index("{"):])
    check_rl_drill(summary)
    out = {"seconds": seconds, **summary}
    log("rl drill (12c)", json.dumps(out))
    return out


# -- phase 13: mixture-of-experts ----------------------------------------------

MOE_PRESET, MOE_DEVICE = "smol-moe", "cuda"
# 13b's engines run smol-moe at full width and 4 of its 16 layers: at 16
# layers the whole smoke's command passed 1100 s of its 1200 s limit once
# phase 15 came (PERF.md, PR 14: 8 layers), and PR 19's 14(g), 15(h) and
# 18(c) took 4 (the near-tie rule, two runs equal, counts); 13c trains at
# 8 (PR 18).
MOE_SERVING_LAYERS = 4
# moe_mlp against a per-expert f32 loop on the same routing (13a), and the
# einsum dispatch against the gather one: (rel_l2, row_rel) over token
# rows, as flash_errors. The port rounds the up and down products and the
# silu output to bf16 where the loop keeps f32; the einsum path also
# rounds the gate to bf16. Limits ~3x the largest sound reading on the
# H100 (PERF.md §6): loop 4.26e-3 and 8.91e-3, paths 2.90e-3 and
# 7.81e-3; the faults read 0.47 and more.
MOE_LOOP_TOL = (1.3e-2, 2.7e-2)
MOE_PATHS_TOL = (9e-3, 2.4e-2)
# The capacity factor of 13a's drop case, where the 128-token chunk drops
# many choices (cf 1.25's drops depend on the draw).
MOE_DROP_CF = 0.5


def moe_cf_all(cfg) -> float:
    """The capacity factor at which C = ceil(k*S*cf/E) >= S on every path,
    so nothing drops and every path routes as the dense forward does."""
    return cfg.n_experts / cfg.experts_per_token


def moe_layer(cfg, seed: int, dev) -> dict:
    """One layer's router and expert banks at cfg's width, random from
    `seed` (init_params of a 1-layer copy of cfg)."""
    from dstack_tpu_torch.workloads.transformer import init_params, layer_params

    one = init_params(cfg.with_(n_layers=1), seed, dev)
    return {k: v for k, v in layer_params(one, 0).items() if k.startswith(("router", "we_"))}


def moe_loop_reference(c, h, p, choices=None, normalise=True, honour_drops=True):
    """moe_mlp(c, h, p)'s function as a plain f32 loop over experts: each
    expert's f32 SwiGLU of the bf16 values on the tokens that chose it,
    weighted by the gate. Routing is the port's own route_assignments
    (pinned: the loop checks dispatch, combine and the banks, the CPU
    tests hold routing against JAX). Faults for the gate's checks:
    `choices` keeps only the first n choices, normalise=False weighs by
    the raw top-k probabilities, honour_drops=False computes the choices
    capacity dropped. Returns (out (B,S,D) f32, routed choices dropped)."""
    from dstack_tpu_torch.workloads import moe

    B, S, D = h.shape
    gate_vals, gate_idx, slot, _, _ = moe.route_assignments(c, h, p["router"])
    keep = slot < moe.expert_capacity(c, S)
    dropped = int((~keep).sum())
    if not honour_drops:
        keep = torch.ones_like(keep)
    if choices is not None:
        keep[..., choices:] = False
    if not normalise:
        probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
        gate_vals = torch.gather(probs, -1, gate_idx)
    x = h.reshape(B * S, D).float()
    idx = gate_idx.reshape(B * S, -1)
    w = (gate_vals * keep).reshape(B * S, -1)
    keep = keep.reshape(B * S, -1)
    out = torch.zeros_like(x)
    for e in range(c.n_experts):
        hit = (idx == e) & keep
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        g = torch.nn.functional.silu(xe @ p["we_gate"][e].float())
        y = (g * (xe @ p["we_up"][e].float())) @ p["we_down"][e].float()
        out.index_add_(0, rows, (w * hit)[rows].sum(-1, keepdim=True) * y)
    return out.reshape(B, S, D), dropped


def moe_readings(got, ref) -> dict:
    """flash_errors' readings over token rows."""
    D = ref.shape[-1]
    return dict(zip(("rel_l2", "row_rel", "max_abs_err", "ref_max"),
                    flash_errors(got.reshape(-1, D), ref.reshape(-1, D))))


def check_moe(readings: dict, tol: tuple, what: str = "moe") -> None:
    if not (readings["rel_l2"] <= tol[0] and readings["row_rel"] <= tol[1]):
        raise AssertionError(f"{what}: rel_l2 {readings['rel_l2']:.3e}, row_rel"
                             f" {readings['row_rel']:.3e} past {tol}")


def routing_flips(idx_a, idx_b) -> int:
    """Tokens whose chosen experts (as sets) differ between two routings
    (..., k)."""
    a, b = idx_a.sort(dim=-1).values, idx_b.sort(dim=-1).values
    return int((a != b).any(-1).sum())


class RoutingSpy:
    """Records every routed call's (seq_len, gate_idx, dropped choices)
    in order, or with `pinned` (a list of gate_idx, one a call) routes
    each call to those experts: probabilities, gate values, slots and the
    aux loss still come from the call's own input (moe.assign_slots), and
    `flips` counts the call's tokens whose own top-k differs from the pin.
    A test-only path for holding two runs on one routing: the package has
    no knob for it."""

    def __init__(self, pinned=None):
        self.calls, self.pinned, self.flips = [], pinned, []

    def __enter__(self):
        from dstack_tpu_torch.workloads import moe

        self._moe, self._real = moe, moe.route_assignments

        def spy(c, h, router, mesh=None):
            if self.pinned is None:
                out = self._real(c, h, router, mesh)
            else:
                # Modulo: a remat recompute routes the layers again in order.
                idx = self.pinned[len(self.calls) % len(self.pinned)].to(h.device)
                probs = torch.softmax(moe._router_logits(h, router), dim=-1)
                out = moe.assign_slots(c, probs, idx, mesh)
                own = torch.sort(probs, dim=-1, descending=True, stable=True).indices
                self.flips.append(routing_flips(own[..., :c.experts_per_token], idx))
            C = moe.row_capacity(c, h.shape[1], mesh)
            self.calls.append((h.shape[1], out[1].detach(), int((out[2] >= C).sum())))
            return out

        moe.route_assignments = spy
        return self

    def __exit__(self, *exc):
        self._moe.route_assignments = self._real


def moe_dispatch_times(cfg, p, shapes=((1, 128), (2, 2048)), n: int = 10) -> dict:
    """Both dispatches' times at `cfg`'s width (one layer, bf16), in the
    order einsum, gather, gather, einsum, by cuda_ms: the forward in one
    CUDA graph (device time), and forward + backward of sum(out) + aux
    into the router, the banks and the input eagerly (autograd is not
    captured; host gaps count where the device waits for them)."""
    from dstack_tpu_torch.workloads import moe

    out = {}
    dev = p["router"].device
    for B, S in shapes:
        g = torch.Generator(device=dev).manual_seed(B * S)
        h = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
        hg = h.clone().requires_grad_(True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        row = {}
        for impl in ("einsum", "gather", "gather", "einsum"):
            c = cfg.with_(moe_impl=impl)

            def fwd(c=c):
                with torch.no_grad():
                    moe.moe_mlp(c, h, p)

            def fwd_bwd(c=c):
                o, aux = moe.moe_mlp(c, hg, leaves)
                torch.autograd.grad(o.float().sum() + aux, [hg, *leaves.values()])

            r = row.setdefault(impl, {"fwd_ms": [], "fwd_bwd_ms": []})
            r["fwd_ms"].append(cuda_ms(fwd, n))
            r["fwd_bwd_ms"].append(cuda_ms(fwd_bwd, n, graph=False))
        out[f"{B}x{S}"] = dict(capacity=moe.expert_capacity(cfg, S), **row)
        log(f"moe dispatch times {B}x{S} (einsum, gather, gather, einsum):", json.dumps(row))
    return out


def run_moe_module() -> dict:
    """13a: moe_mlp at the preset's width, one layer, bf16, random from
    seed 0: einsum against gather (1 x 128 and 2 x 2048 at the preset's
    cf, aux equal; the gate shown failing a path that drops every second
    choice), both against the per-expert f32 loop on 16 tokens at the
    all-admitting cf and on a 128-token chunk at MOE_DROP_CF; the loop's
    gate shown failing the second choice dropped, the gate left
    unnormalised and a dropped choice computed; the two dispatches
    timed."""
    from dstack_tpu_torch.workloads import moe
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[MOE_PRESET]
    p = moe_layer(cfg, 0, MOE_DEVICE)
    gen = torch.Generator(device=MOE_DEVICE).manual_seed(13)

    def hidden(B, S):
        return torch.randn((B, S, cfg.d_model), generator=gen, device=MOE_DEVICE).to(
            torch.bfloat16)

    out = {"paths": {}, "loop": {}, "mutants": {}}
    with torch.no_grad():
        for B, S in ((1, 128), (2, 2048)):
            h = hidden(B, S)
            oe, ae = moe.moe_mlp(cfg, h, p)
            og, ag = moe.moe_mlp(cfg.with_(moe_impl="gather"), h, p)
            r = moe_readings(oe, og)
            r["aux_equal"] = float(ae) == float(ag)
            out["paths"][f"{B}x{S}"] = r
            log(f"moe einsum vs gather {B}x{S}:", json.dumps(r), f"(tol {MOE_PATHS_TOL})")
            check_moe(r, MOE_PATHS_TOL, f"einsum vs gather {B}x{S}")
            if not r["aux_equal"]:
                raise AssertionError(f"aux differs between the dispatches: {ae} vs {ag}")
            if S == 128:
                # The paths gate on a dispatch that drops every second choice.
                bad, _ = moe_loop_reference(cfg, h, p, choices=1)
                out["mutants"]["paths_second_choice_dropped"] = must_fail(
                    check_moe, moe_readings(bad, oe), MOE_PATHS_TOL, "einsum vs a faulty path")
                log(f"moe paths gate on a path dropping every second choice: fails, as it"
                    f" must ({out['mutants']['paths_second_choice_dropped']})")
        for name, c, (B, S) in (("all_admitted", cfg.with_(capacity_factor=moe_cf_all(cfg)),
                                 (1, 16)),
                                ("drops", cfg.with_(capacity_factor=MOE_DROP_CF), (1, 128))):
            h = hidden(B, S)
            ref, dropped = moe_loop_reference(c, h, p)
            for impl in ("einsum", "gather"):
                got, _ = moe.moe_mlp(c.with_(moe_impl=impl), h, p)
                r = moe_readings(got, ref)
                out["loop"][f"{name}_{impl}"] = dict(r, dropped=dropped, choices=B * S * 2)
                log(f"moe {impl} vs loop, {name} (cf {c.capacity_factor:g}, {B}x{S},"
                    f" {dropped} choices dropped):", json.dumps(r), f"(tol {MOE_LOOP_TOL})")
                check_moe(r, MOE_LOOP_TOL, f"{impl} vs loop {name}")
            mutants = ({"second_choice_dropped": dict(choices=1),
                        "gate_unnormalised": dict(normalise=False)} if name == "all_admitted"
                       else {"drop_not_zeroed": dict(honour_drops=False)})
            if name == "drops" and not dropped:
                raise AssertionError("the drop case dropped nothing")
            for mname, kw in mutants.items():
                bad, _ = moe_loop_reference(c, h, p, **kw)
                out["mutants"][mname] = must_fail(check_moe, moe_readings(bad, ref),
                                                  MOE_LOOP_TOL, mname)
                log(f"moe gate on {mname}: fails, as it must ({out['mutants'][mname]})")
    out["times"] = moe_dispatch_times(cfg, p)
    return out


def moe_dense_check(cfg, params, dtype) -> dict:
    """dense_check on an MoE model at a cf that admits every token: a
    200-token prompt through two chunk-prefill programs (the paged
    kernel) against the dense plain `_forward_cached`, on the last
    position's logits, with the dense run pinned to the chunks' routing
    (RoutingSpy) so a token whose top-k flips under the two paths'
    rounding does not read as a kernel fault; the unpinned dense run's
    reading and its flips (prompt tokens routed to other experts, over all
    layers) are recorded beside it."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.generate import _forward_cached, init_cache
    from dstack_tpu_torch.workloads.kv_blocks import init_paged_state, make_chunk_prefill

    dev = params["embed"].device
    prompt = byte_prompt(99, 200)
    st = init_paged_state(cfg, 1, 256, 16, 16, dev)
    table = list(range(13)) + [16] * 3
    fn = make_chunk_prefill(cfg, 128)
    before = pa.LAUNCHES["ragged_paged_attention"]
    with torch.no_grad(), RoutingSpy() as chunks:
        fn(params, st, 0, table, prompt[:128], 128, 0, 8, 0.0, 1.0, None, False)
        _, first, logits = fn(params, st, 0, table, prompt[128:] + [0] * 56, 72, 128,
                              8, 0.0, 1.0, None, True)
    launched = pa.LAUNCHES["ragged_paged_attention"] - before
    L = cfg.n_layers
    pinned = [torch.cat([chunks.calls[i][1][:, :128], chunks.calls[L + i][1][:, :72]], dim=1)
              for i in range(L)]
    toks = torch.tensor([prompt], device=dev)
    readings = {}
    for name, spy in (("pinned", RoutingSpy(pinned)), ("unpinned", RoutingSpy())):
        with torch.no_grad(), spy:
            ref, _ = _forward_cached(cfg, params, toks, init_cache(cfg, 1, 200, dev))
        readings[name] = dict(
            rel=float((logits - ref[0]).abs().max() / ref[0].abs().max()),
            top1_agrees=int(first) == int(ref[0].argmax()),
            flips=sum(routing_flips(a, b[1]) for a, b in zip(pinned, spy.calls)),
            dropped=sum(b[2] for b in spy.calls))
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    tol = ENGINE_LOGIT_TOL[dtype]
    out = dict(readings, launches=launched, chunk_dropped=sum(c[2] for c in chunks.calls),
               tol=tol)
    log(f"moe dense check {tag} (cf {cfg.capacity_factor:g}):", json.dumps(out))
    if launched != 2 * L:
        raise AssertionError(f"moe dense check ran the kernel {launched} times")
    if out["chunk_dropped"] or readings["pinned"]["dropped"] or readings["pinned"]["flips"]:
        raise AssertionError(f"moe dense check: a choice dropped or a pin missed: {out}")
    if not readings["pinned"]["rel"] <= tol:
        raise AssertionError(f"moe chunked-prefill logits off by {readings['pinned']['rel']}")
    # The gate on a routing fault: the dense run pinned to experts shifted
    # by one in one layer must fail it.
    shifted = list(pinned)
    shifted[L // 2] = (pinned[L // 2] + 1) % cfg.n_experts
    with torch.no_grad(), RoutingSpy(shifted):
        bad, _ = _forward_cached(cfg, params, toks, init_cache(cfg, 1, 200, dev))
    out["shifted_rel"] = float((logits - bad[0]).abs().max() / bad[0].abs().max())
    log(f"moe dense check on a layer routed to shifted experts: rel {out['shifted_rel']:.3e}")
    if out["shifted_rel"] <= tol:
        raise AssertionError("the moe dense check passes a routing fault")
    return out


def two_runs_identical(a: list, b: list) -> None:
    if a != b:
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        raise AssertionError(f"two runs of one wave differ (stream {first})")


def moe_engine_wave(cfg, params, spec: bool, n_new: int, profiled: bool = False) -> dict:
    """Phase 4's wave through a warm smol-moe engine (8 slots, block 16,
    chunk 128; spec: the int8 drafter, k <= 4), then with `profiled` a
    second wave under the profiler (profile_wave)."""
    from dstack_tpu_torch.workloads.serving import ServingEngine

    eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4, prefill_chunk_tokens=128,
                        kv_block_size=16, spec_enable=spec, spec_max_draft=4,
                        device=params["embed"].device)
    try:
        w = eng.warmup()
        r = serve_wave(eng, engine_prompts(), n_new)
        r.update(spec=spec, warmup_s=w["seconds"])
        if profiled:
            r["profiled_wave"] = profile_wave(eng, cfg)
    finally:
        eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    st = r.pop("stats")
    r.update({k: st[k] for k in SPEC_KEYS}, decode_seconds_total=st["decode_seconds_total"])
    if any(len(t) != n_new for t in r["streams"]):
        raise AssertionError(f"token counts {[len(t) for t in r['streams']]}")
    if r["kernel_launches"] <= 0:
        raise AssertionError("the moe wave launched the paged kernel 0 times")
    if spec and not st["spec_tokens_accepted_total"] > 0:
        raise AssertionError("the moe spec wave accepted no draft")
    return r


def moe_chunk_drops(cfg, params) -> dict:
    """The drop fraction at the preset's cf: a 128-token prompt (no pad
    lanes) through one chunk-prefill program, each layer's routed choices
    that capacity dropped over all k*S (RoutingSpy on the real hidden
    states); the finalize logits finite."""
    from dstack_tpu_torch.workloads.kv_blocks import init_paged_state, make_chunk_prefill

    dev = params["embed"].device
    st = init_paged_state(cfg, 1, 256, 16, 16, dev)
    with torch.no_grad(), RoutingSpy() as spy:
        _, _, logits = make_chunk_prefill(cfg, 128)(
            params, st, 0, list(range(8)) + [16] * 8, byte_prompt(7, 128), 128, 0, 8, 0.0,
            1.0, None, True)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("moe chunk logits not finite")
    from dstack_tpu_torch.workloads.moe import expert_capacity

    per_layer = [d / (cfg.experts_per_token * s) for s, _, d in spy.calls]
    return dict(cf=cfg.capacity_factor, capacity=expert_capacity(cfg, 128),
                drop_fraction=sum(per_layer) / len(per_layer), per_layer=per_layer)


def run_moe_serving(cfg, n_new: int = 32) -> dict:
    """13b: smol-moe at full width (random from seed 0; MOE_SERVING_LAYERS
    deep) behind the paged engine, phase 4's 8 requests. bf16 at the all-admitting cf: the dense
    check (pinned), plain and spec (int8 MoE drafter) waves. bf16 at the
    preset's cf: two plain waves give identical streams (shown failing a
    changed token), the drop fraction of a 128-token chunk, finite logits.
    f32 at the all-admitting cf: the dense check, plain and spec waves
    with every stream held by the near-tie rule against the dense forward,
    the rule shown failing a genuine divergence. In bf16 the rule does
    not apply to an MoE model: the kernel path and the dense path round
    differently, top-k flips for some token-layers (the dense check
    counts them) and a flipped token's MLP output jumps; f32 paths differ
    by ~1e-6 and flip none. Decode tok/s, TTFT and paged launches per
    wave for each, and a profiled bf16 plain wave."""
    from dstack_tpu_torch.workloads.transformer import init_params

    params = init_params(cfg, seed=0, device=MOE_DEVICE)
    cf_all = cfg.with_(capacity_factor=moe_cf_all(cfg))
    out = {"dense_check": moe_dense_check(cf_all, params, torch.bfloat16), "runs": {}}
    runs = out["runs"]
    for spec in (False, True):
        r = moe_engine_wave(cf_all, params, spec, n_new, profiled=not spec)
        r.pop("streams")
        runs["spec_all" if spec else "plain_all"] = r
        log(f"moe wave, bf16, cf {cf_all.capacity_factor:g}, {'spec' if spec else 'plain'}:",
            json.dumps(r))
    preset = [moe_engine_wave(cfg, params, False, n_new) for _ in range(2)]
    two_runs_identical(preset[0]["streams"], preset[1]["streams"])
    changed = [list(s) for s in preset[1]["streams"]]
    changed[3][n_new // 2] = (changed[3][n_new // 2] + 1) % cfg.vocab_size
    out["identical_check"] = must_fail(two_runs_identical, preset[0]["streams"], changed)
    for r in preset:
        streams = r.pop("streams")
        if not all(0 <= t < cfg.vocab_size for s in streams for t in s):
            raise AssertionError("token id out of range")
        log(f"moe wave, bf16, cf {cfg.capacity_factor:g}, plain:", json.dumps(r))
    runs["plain_preset"] = preset
    out["drops"] = moe_chunk_drops(cfg, params)
    log("moe chunk drops at the preset's cf:", json.dumps(out["drops"]))
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cf32 = cf_all.with_(dtype="float32")
    out["dense_check_f32"] = moe_dense_check(cf32, p32, torch.float32)
    tol = ENGINE_LOGIT_TOL[torch.float32]
    prompts = engine_prompts()
    streams = {}
    for spec in (False, True):
        r = moe_engine_wave(cf32, p32, spec, n_new)
        streams[spec] = r.pop("streams")
        r["near_tie"] = hold_streams(cf32, p32, prompts, streams[False], streams[spec], tol,
                                     "moe f32 " + ("spec" if spec else "plain"))
        runs["spec_f32" if spec else "plain_f32"] = r
        log(f"moe wave, f32, cf {cf32.capacity_factor:g}, {'spec' if spec else 'plain'}:",
            json.dumps(r), f"(tol {tol:g})")
    out["rule_check"] = rule_fails_a_genuine_divergence(cf32, p32, prompts[1],
                                                        streams[False][1], tol)
    log(f"near-tie rule on an moe stream with a token replaced by the lowest-logit one:"
        f" {json.dumps(out['rule_check'])}: fails, as it must")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_moe_http(preset: str = MOE_PRESET) -> dict:
    """13b: `native_server --preset smol-moe --spec-enable` in a
    subprocess (random weights from seed 0): one chat, a 200 with tokens."""
    t0 = time.monotonic()
    srv = ServerProc(["--preset", preset, "--device", MOE_DEVICE, "--seed", "0",
                      "--host", "127.0.0.1", "--port", "0", "--max-new-tokens", "16",
                      "--spec-enable"])
    try:
        base = srv.ready()
        code, body = http("POST", base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "route me"}], "max_tokens": 16,
            "temperature": 0.0})
        usage = json.loads(body)["usage"]
    finally:
        srv.stop()
    out = dict(code=code, completion_tokens=usage["completion_tokens"],
               wall_s=time.monotonic() - t0)
    log("moe native_server:", json.dumps(out))
    if code != 200 or usage["completion_tokens"] < 1:
        raise AssertionError(f"moe chat: {code} {body[:200]}")
    return out


def run_moe_model_check(B: int = 2, S: int = 2048) -> dict:
    """13c: smol-moe width at 2 layers, B x S: loss_fn and grads through
    the flash kernels, and through plain_attention with the routing
    pinned to the kernel run's (RoutingSpy), f32 and bf16, at 6b's limits;
    the unpinned plain run's flips recorded; the gate shown failing the
    plain run pinned to experts shifted by one in one layer."""
    from dstack_tpu_torch.workloads.attention import make_attention_fn, plain_attention
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.train import loss_fn, synthetic_batch
    from dstack_tpu_torch.workloads.transformer import init_params
    from dstack_tpu_torch.workloads.weights import flatten_params

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cfg = PRESETS[MOE_PRESET].with_(n_layers=2, dtype=str(dtype).split(".")[1])
        params = init_params(cfg, seed=1, device=MOE_DEVICE)
        pairs = flatten_params(params)
        for _, p in pairs:
            p.requires_grad_(True)
        batch = synthetic_batch(cfg, B, S, seed=1, device=MOE_DEVICE)
        leaves = [p for _, p in pairs]

        def run(attn, spy):
            zero_flash_counts()
            with spy:
                loss, _ = loss_fn(cfg, params, batch, attn)
                grads = torch.autograd.grad(loss, leaves)
            return float(loss.detach()), grads, flash_counts(), spy

        kern = run(make_attention_fn(), RoutingSpy())
        pinned = [c[1] for c in kern[3].calls]
        plain = run(plain_attention, RoutingSpy(pinned))
        with torch.no_grad(), RoutingSpy() as free:
            loss_fn(cfg, params, batch, plain_attention)
        flips = sum(routing_flips(a, b[1]) for a, b in zip(pinned, free.calls))
        want = expected_launches(cfg, cfg.resolve_remat(B * S, seq_len=S), 1)
        if kern[2] != want or any(plain[2].values()):
            raise AssertionError(f"moe model check {tag}: launches {kern[2]} (expected"
                                 f" {want}) / {plain[2]}")
        r = moe_model_gaps(pairs, kern, plain)
        r.update(flips=flips, tokens=B * S * cfg.n_layers,
                 dropped=sum(c[2] for c in kern[3].calls))
        tol = MODEL_TOL[dtype]
        log(f"moe model check {tag}: loss {kern[0]:.6f} vs {plain[0]:.6f} (rel"
            f" {r['loss_rel']:.3e}, tol {tol[0]:g}); worst leaf grad rel {r['worst']:.3e}"
            f" (tol {tol[1]:g}) at {r['worst_at']}; {flips} tokens flip unpinned,"
            f" {r['dropped']} choices dropped")
        check_moe_model(r, tol)
        shifted = list(pinned)
        shifted[-1] = (pinned[-1] + 1) % cfg.n_experts
        bad = run(plain_attention, RoutingSpy(shifted))
        r["shifted_check"] = must_fail(check_moe_model, moe_model_gaps(pairs, kern, bad), tol)
        log(f"moe model check {tag} on a layer routed to shifted experts: fails, as it"
            f" must ({r['shifted_check']})")
        out[tag] = r
        del params, pairs, leaves, batch, kern, plain, bad
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_model_gaps(pairs, got, ref) -> dict:
    """Loss |d|/|ref| and per-leaf grad ||g - r|| / ||r|| of two runs."""
    grad_rel = {path: float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30))
                for (path, _), g, r in zip(pairs, got[1], ref[1])}
    worst_at = max(grad_rel, key=grad_rel.get)
    return dict(loss_rel=abs(got[0] - ref[0]) / abs(ref[0]), grad_rel=grad_rel,
                worst=grad_rel[worst_at], worst_at=worst_at)


def check_moe_model(r: dict, tol: tuple) -> None:
    if not (r["loss_rel"] <= tol[0] and r["worst"] <= tol[1]):
        raise AssertionError(f"moe model check: loss rel {r['loss_rel']:.3e}, grad rel"
                             f" {r['worst']:.3e} at {r['worst_at']} past {tol}")


# 13c's training depth: 8 of smol-moe's 16 layers at full width, 13b's and
# 18's depth, to make room in the smoke's budget (PERF.md section 4).
MOE_TRAIN_LAYERS = 8


def run_moe_train() -> dict:
    """13c: smol-moe at full width and MOE_TRAIN_LAYERS layers, B 2 x S
    2048, bf16, 5 steps after 2 warm-up, the einsum then the gather
    dispatch then gather, einsum (the first run profiled); then the
    2-layer model check."""
    runs = []
    for i, impl in enumerate(("einsum", "gather", "gather", "einsum")):
        runs.append(run_train(MOE_PRESET, 2, 2048, profiled=i == 0,
                              overrides={"moe_impl": impl, "n_layers": MOE_TRAIN_LAYERS}))
    return {"runs": runs, "model_check": run_moe_model_check()}


PAGED_TIMES = ("ms", "ms_one_launch", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "library_ms_one_launch", "tflops", "bound_share", "other_plan",
               "host_us_per_call")


# -- phase 14: tensor-parallel serving across ranks --------------------------------

TP_RANKS = 2
# The model and the one card both ranks share (a CPU dry run of the rank
# processes swaps in a small preset and "cpu").
TP_PRESET, TP_DEVICE = "smol-1b", "cuda:0"
# smol-1b at full width and half its depth: at 16 layers the whole smoke's
# command passed 1100 s of its 1200 s limit once phase 15 came (PERF.md,
# PR 14).
TP_LAYERS = 8
# Each rank process's limit (seconds): start-up, three cases, the pool
# gathers; killed past it.
TP_TIMEOUT = 600
TP_NEW = 32
TP_ENGINE_KW = dict(slots=8, steps_per_sync=4, prefill_chunk_tokens=128, kv_block_size=16)
# The cases of 14(a), (b) and (e): bf16 and f32 held against the unsharded
# engine, and bf16 with the two ranks' shards swapped in the attention
# output's all-gather, which both gates must fail.
TP_CASES = (("bf16", "bfloat16", False), ("f32", "float32", False),
            ("mutant", "bfloat16", True))
# 14(b): each rank's pool shard against its heads of the unsharded engine's
# pool, over the prompt blocks both prefix caches hold (rows of hd), by
# flash_errors' (rel_l2, row_rel): about 3x the sound reading on the H100
# (PERF.md, phase 14: bf16 8.26e-3 and 2.82e-2, f32 1.89e-6 and 5.56e-6;
# the swapped all-gather reads 1.37 and 2.89).
TP_POOL_TOL = {"bfloat16": (2.5e-2, 8.5e-2), "float32": (6e-6, 1.7e-5)}
# 14(c): the per-rank geometry of smol-1b at model 2 (H 8, KV 4, hd 128).
TP_GEO = dict(H=8, KV=4, hd=128, bs=16, MB=128, NB=1024)


def tp_kernel_cases(flush) -> list:
    """14(c): the paged kernel against its plain version at each rank's
    heads, the engine's decode and chunk shapes, bf16 and f32; times of
    the bf16 decode case."""
    from dstack_tpu_torch.workloads import paged_attention as pa

    decode_lens = [37, 200, 513, 1000, 1499, 1801, 2046, 64]
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for case in (paged_case(f"tp_decode_{tag}", dtype, B=8, S=1, **TP_GEO,
                                start=decode_lens, seed=11),
                     paged_case(f"tp_chunk_{tag}", dtype, B=1, S=128, **TP_GEO,
                                start=[384], seed=12)):
            args = (case["q"], case["k"], case["v"], case["tables"], case["vlen"])
            got = pa._ragged_attention_cuda(*args)
            ref = pa._ragged_attention_plain(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{case['name']}: kernel output not finite")
            r = dict(case=case["name"], **paged_readings(got, ref, case["q"].shape[2]),
                     split_plan=paged_plan(pa, case)._asdict())
            tol = PAGED_TOL[dtype]
            log(f"kernel {case['name']} (a rank's heads): " + json.dumps(r) + f" (tol {tol})")
            if not within(r, tol):
                raise AssertionError(f"{case['name']}: readings {r} past {tol}")
            if case["name"] == "tp_decode_bf16":
                r.update(paged_times(pa, case, ref, flush))
                log("kernel timing", json.dumps(r))
            results.append(r)
    return results


def tp_swap_attn_out():
    """The mutant of 14(e): the attention output's all-gather concatenates
    the two ranks' heads in reverse rank order. Returns the undo."""
    from dstack_tpu_torch.workloads import kv_blocks, sharding
    from dstack_tpu_torch.workloads.transformer import linear

    orig = kv_blocks.attn_out

    def swapped(attn, p, mesh=None):
        g = sharding.all_gather(attn, -1, mesh)
        g = torch.cat(g.chunk(sharding.model_shards(mesh), -1)[::-1], -1)
        return sharding.all_gather(linear(g, p["wo"]), -1, mesh)

    kv_blocks.attn_out = swapped
    return lambda: setattr(kv_blocks, "attn_out", orig)


def tp_count_ops(serving, pa, mesh):
    """Per-rank counters through the op layer: an op of the smoke's own
    (`_op("tp_zero_counts")`, never the idle heartbeat's no-op) zeroes the
    paged kernel's launch count and the mesh's collective counts on every
    rank at one point of the op stream; each decode op records its
    launches, all-gathers and all-gather seconds per decode step.
    Returns (counts, undo)."""
    cls = serving.ServingEngine
    orig_decode = cls._op_decode

    def fresh():
        return dict(per_step=[], decode_ops=0, decode_gathers=0, decode_gather_s=0.0,
                    stats0=dict(mesh.stats))

    counts = fresh()

    def zero_counts(self):
        pa.LAUNCHES["ragged_paged_attention"] = 0
        counts.update(fresh())

    def decode(self, *a):
        before = pa.LAUNCHES["ragged_paged_attention"]
        g0, s0 = mesh.stats["all_gathers"], mesh.stats["all_gather_seconds"]
        out = orig_decode(self, *a)
        counts["per_step"].append(
            (pa.LAUNCHES["ragged_paged_attention"] - before) / self._steps_per_sync)
        counts["decode_ops"] += 1
        counts["decode_gathers"] += mesh.stats["all_gathers"] - g0
        counts["decode_gather_s"] += mesh.stats["all_gather_seconds"] - s0
        return out

    cls._op_tp_zero_counts, cls._op_decode = zero_counts, decode

    def undo():
        del cls._op_tp_zero_counts
        cls._op_decode = orig_decode
    return counts, undo


def tp_prompt_blocks(state, blocks) -> torch.Tensor:
    """(2, L, n, bs, KV_rank, hd): k and v of `blocks` in every layer."""
    ids = torch.tensor(blocks, dtype=torch.int64, device=state.k.device)
    return torch.stack([state.k[:, ids], state.v[:, ids]])


def tp_rank_main(rank: int, init: str) -> int:
    """One rank of phase 14, a process of its own: the cases of TP_CASES
    on two gloo ranks sharing cuda:0. Rank 0 drives each engine, runs the
    unsharded engine beside it and prints its readings as one JSON line;
    rank 1 follows."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads import serving, sharding
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    sharding.init_ranks(TP_RANKS, rank, init, backend="gloo", device=TP_DEVICE)
    mesh = sharding.make_mesh([TP_DEVICE], model=TP_RANKS)
    prompts = engine_prompts()
    out, refs = {}, {}
    for name, dtype, mutant in TP_CASES:
        cfg = PRESETS[TP_PRESET].with_(dtype=dtype, n_layers=TP_LAYERS)
        params = init_params(cfg, seed=0, device=TP_DEVICE)
        counts, undo_counts = tp_count_ops(serving, pa, mesh)
        undo_swap = tp_swap_attn_out() if mutant else (lambda: None)
        try:
            if rank == 0:
                eng = serving.ServingEngine(cfg, params, mesh=mesh, **TP_ENGINE_KW)
                try:
                    eng.warmup()
                    eng._op("tp_zero_counts")  # every rank's counters from here
                    wave = serve_wave(eng, prompts, TP_NEW)
                finally:
                    eng.close()
                state, cache = eng.state, eng._alloc._cache
            else:
                state = serving.run_follower(mesh, cfg, params, **TP_ENGINE_KW).state
        finally:
            undo_swap()
            undo_counts()
        stats = {k: mesh.stats[k] - counts["stats0"][k] for k in mesh.stats}
        # The prompt blocks both prefix caches hold, keyed by chain key.
        keys = sharding.broadcast_object(
            sorted(k for k in cache if k[0] == "F") if rank == 0 else None, mesh)
        blocks = sharding.broadcast_object([cache[k] for k in keys] if rank == 0 else None,
                                           mesh)
        pool = sharding.all_gather(tp_prompt_blocks(state, blocks), 4, mesh)
        ranks = [None] * TP_RANKS
        torch.distributed.all_gather_object(
            ranks, dict(launches=pa.LAUNCHES["ragged_paged_attention"], **stats,
                        **{k: v for k, v in counts.items() if k != "stats0"}))
        if rank:
            del state, pool, params
            torch.cuda.empty_cache()
            continue
        if not mutant:
            ref = serving.ServingEngine(cfg, params, device=TP_DEVICE, **TP_ENGINE_KW)
            try:
                ref.warmup()
                ref_wave = serve_wave(ref, prompts, TP_NEW)
            finally:
                ref.close()
            ref_pool = tp_prompt_blocks(ref.state, [ref._alloc._cache[k] for k in keys])
            refs[dtype] = (ref_wave["streams"], dict(zip(keys, ref_pool.unbind(2))))
            del ref
        ref_streams, ref_blocks = refs[dtype]
        shared = [i for i, k in enumerate(keys) if k in ref_blocks]
        got = pool[:, :, shared]
        want = torch.stack([ref_blocks[keys[i]] for i in shared], dim=2)
        rel_l2, row_rel, max_abs, ref_max = flash_errors(got, want)
        tol = ENGINE_LOGIT_TOL[cfg.activation_dtype]
        try:
            held = hold_streams(cfg, params, prompts, ref_streams, wave["streams"], tol,
                                f"phase 14 {name}")
            held_error = None
        except AssertionError as e:
            held, held_error = None, str(e)
        steps = max(ranks[0]["decode_ops"] * TP_ENGINE_KW["steps_per_sync"], 1)
        out[name] = dict(
            dtype=dtype, mutant=mutant, n_layers=cfg.n_layers,
            bit_exact_streams=sum(a == b for a, b in zip(ref_streams, wave["streams"])),
            streams_held=held, streams_error=held_error,
            pool=dict(rel_l2=rel_l2, row_rel=row_rel, max_abs_err=max_abs, ref_max=ref_max,
                      blocks=len(shared), tol=TP_POOL_TOL[dtype]),
            ranks=ranks,
            decode_tokens_per_s=wave["decode_tokens_per_s"], ttft_p50_s=wave["ttft_p50_s"],
            all_gathers_per_step=ranks[0]["decode_gathers"] / steps,
            all_gather_ms_per_step=ranks[0]["decode_gather_s"] * 1e3 / steps,
            unsharded=None if mutant else dict(
                decode_tokens_per_s=ref_wave["decode_tokens_per_s"],
                ttft_p50_s=ref_wave["ttft_p50_s"]),
            token_counts=[len(t) for t in wave["streams"]])
        log(f"phase 14 {name}: " + json.dumps(out[name]))
        del eng, state, pool, params, got, want
        torch.cuda.empty_cache()
    actor = ta_run(rank, mesh)
    if rank == 0:
        out["rl_actor"] = actor
        print("TP_RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def check_tp(res: dict) -> None:
    """The gates of 14(a), (b), (d), (e) and (g) on rank 0's readings."""
    if "rl_actor" in res:
        check_tp_actor(res["rl_actor"])
    for name, r in res.items():
        if name == "rl_actor":
            continue
        per_step = [x for rk in r["ranks"] for x in rk["per_step"]]
        if not per_step or any(x != r["n_layers"] for x in per_step):
            raise AssertionError(f"phase 14 {name}: launches per decode step {per_step},"
                                 f" not the {r['n_layers']} layers on each rank")
        if any(rk["launches"] <= 0 for rk in r["ranks"]):
            raise AssertionError(f"phase 14 {name}: a rank launched the kernel 0 times")
        if r["token_counts"] != [TP_NEW] * len(r["token_counts"]):
            raise AssertionError(f"phase 14 {name}: token counts {r['token_counts']}")
        p = r["pool"]
        pool_ok = p["rel_l2"] <= p["tol"][0] and p["row_rel"] <= p["tol"][1]
        streams_ok = r["streams_held"] is not None
        if r["mutant"]:
            if streams_ok or pool_ok:
                raise AssertionError(f"phase 14: the swapped all-gather passes a gate:"
                                     f" streams {streams_ok}, pool {pool_ok} ({p})")
        elif not (streams_ok and pool_ok):
            raise AssertionError(f"phase 14 {name}: streams {r['streams_error']},"
                                 f" pool {p}")


def run_tp_nccl(n_new: int = 8) -> dict:
    """14(f): a world-1 NCCL group on cuda:0 serves a short wave through
    the op layer (every op broadcast over NCCL). Runs in a process of its
    own (`--tp-nccl`, started by `run_tp`), so no NCCL state
    outlives it in the smoke's process."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["smol-1b"]
    params = init_params(cfg, seed=0)
    sharding.init_ranks(1, 0, sharding.loopback_rendezvous(), backend="nccl", device="cuda:0")
    try:
        mesh = sharding.make_mesh(["cuda:0"], model=1)
        eng = ServingEngine(cfg, params, mesh=mesh, **TP_ENGINE_KW)
        try:
            eng.warmup()
            streams = [drain(eng.submit(p, n_new, temperature=0.0))[0]
                       for p in engine_prompts()[:2]]
        finally:
            eng.close()
        r = dict(backend=mesh.backend, broadcasts=mesh.stats["broadcasts"],
                 token_counts=[len(s) for s in streams])
    finally:
        torch.distributed.destroy_process_group()
    if r["backend"] != "nccl" or r["broadcasts"] <= 0 or r["token_counts"] != [n_new] * 2:
        raise AssertionError(f"phase 14(f): {r}")
    print("TP_NCCL " + json.dumps(r), flush=True)
    return r


PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the subreaper of all it starts: a process whose
    parent ends first (a drill's worker, an entry point's follower) is
    re-parented here rather than to init, so `descendants` still sees it
    and `stop_descendants` ends it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants(root: int = None) -> list:
    """[(pid, state, command line)] of every process below `root` (this
    one by default), read from /proc; a zombie's state is "Z"."""
    root = os.getpid() if root is None else root
    procs = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError):
            continue  # gone between the listing and the read
        procs[int(d)] = (int(ppid), state, cmd)
    out, todo = [], [root]
    while todo:
        parent = todo.pop()
        for pid, (ppid, state, cmd) in sorted(procs.items()):
            if ppid == parent:
                out.append((pid, state, cmd))
                todo.append(pid)
    return out


def reap_children() -> None:
    """Collect the exit status of every child that has ended (adopted
    orphans too), so none is left a zombie."""
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                return
        except ChildProcessError:
            return


def stray_processes(after: str) -> list:
    """The live processes below this one when none should be (`after` a
    phase, each of which stops its own), logged by command line."""
    live = [f"{pid} {cmd[:160]}" for pid, state, cmd in descendants() if state != "Z"]
    if live:
        log(f"stray processes after {after}: {live}")
    return live


def stop_descendants(grace: float = 30.0) -> list:
    """End every process below this one: each gets `grace` seconds to exit
    on its own, then SIGKILL; every ended child is reaped. Returns the
    command lines of those alive at the call."""
    import signal

    found = [f"{pid} {cmd[:160]}" for pid, state, cmd in descendants() if state != "Z"]
    deadline, killed = time.monotonic() + grace, False
    while True:
        reap_children()
        live = [pid for pid, state, _ in descendants() if state != "Z"]
        if not live:
            break
        if time.monotonic() > deadline:
            if killed:
                raise RuntimeError(f"processes {live} outlived SIGKILL")
            for pid in live:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            deadline, killed = time.monotonic() + 30.0, True
        time.sleep(0.2)
    reap_children()
    return found


def wait_ranks(procs, timeout: float) -> list:
    """Wait for every rank process until `timeout` seconds in all, then
    kill the process group of any still running; returns the exit codes
    (a killed rank's is negative)."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    return [p.returncode for p in procs]


def run_tp() -> dict:
    """Phase 14: (a, b, d, e) in two rank processes, (c) and (f) here."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.monotonic()
    kernels = tp_kernel_cases(flush)
    del flush
    t1 = time.monotonic()
    ranks = launch_procs(["--tp-rank"], "phase14", TP_RANKS, "TP_RESULT", TP_TIMEOUT)
    check_tp(ranks)
    t2 = time.monotonic()
    # 14(f) and 15(f) in one process of their own (one start-up for both).
    nccl = launch_procs(["--tp-nccl", "--tr-nccl"], "phase14_nccl", 1, "TP_NCCL", TP_TIMEOUT)
    with open("chiprun_out/phase14_nccl_rank0.log") as f:
        train_nccl = json.loads(next(ln for ln in f if ln.startswith("TR_NCCL "))[8:])
    log("phase 14(f) nccl world 1: " + json.dumps(nccl))
    t3 = time.monotonic()
    for name, r in ranks.items():
        if name == "rl_actor":
            continue
        log(f"phase 14 {name} (gloo, two ranks on one card: not a TP speed):"
            f" decode {r['decode_tokens_per_s']:.1f} tok/s, TTFT p50"
            f" {r['ttft_p50_s'] * 1e3:.1f} ms, {r['all_gathers_per_step']:.1f} staged"
            f" all-gathers per decode step taking {r['all_gather_ms_per_step']:.2f} ms,"
            f" streams bit for bit {r['bit_exact_streams']}/8")
    log(f"phase 14: kernels {t1 - t0:.1f}s, ranks {t2 - t1:.1f}s, nccl {t3 - t2:.1f}s")
    return dict(kernels=kernels, ranks=ranks, nccl=nccl, train_nccl=train_nccl,
                seconds=dict(kernels=t1 - t0, ranks=t2 - t1, nccl=t3 - t2))


# -- phase 15: training across ranks -----------------------------------------------

TR_RANKS = 2
# The model and the one card both ranks share (a CPU dry run of the rank
# processes swaps in a small preset and "cpu").
TR_PRESET, TR_DEVICE = "smol-1b", "cuda:0"
# The global batch, the largest that fits the two ranks on one card: 8 x
# 2048, 4 rows a rank at fsdp 2 (each model-2 rank holds all 8). The ranks
# peak at 25.0 and 27.0 GB and the unsharded step at 46.6 GB on the H100
# (PERF.md, phase 15); 12 rows would take ~77 GB for the two model-2 ranks
# by the per-row slope. TR_STEPS steps per case.
TR_B, TR_S, TR_STEPS = 8, 2048, 2
# Each rank process's limit (seconds): start-up, every case, the gathers.
TR_TIMEOUT = 600
# The two layouts over the two ranks.
TR_LAYOUTS = {"fsdp2": {"fsdp": 2}, "model2": {"model": 2}}
# (case, layout, mutation): the two layouts, and each with the sum its
# collective owes skipped, which the param gate must fail.
TR_CASES = (("fsdp2", "fsdp2", None), ("model2", "model2", None),
            ("fsdp2_rs_unsummed", "fsdp2", "fsdp"),
            ("model2_row_unsummed", "model2", "model"))
# The f32 check's depth (smol-1b's width, TF32 off).
TR_F32_LAYERS = 2
# Sharded against unsharded on one card (15a, 15b), per (dtype, layout):
# the first step's loss by relative difference, grad_norm likewise, and
# every param after TR_STEPS steps by flash_errors' (rel_l2, row_rel) over
# its leaf. Each limit is ~3x the larger sound reading of two runs on the
# H100 (B 4 and B 8, PERF.md phase 15); a reading of 0 gets ~3 f32 ulps.
# bf16 fsdp 2: loss 8.8e-8, grad_norm 5.1e-4, params 8.7e-4 / 1.99e-2;
# model 2 (its row-parallel sums round their bf16 partials): 3.4e-5,
# 1.3e-4, 4.4e-3 / 3.1e-2. The two mutants read params rel_l2 3.3e-2
# and 4.9e-2. f32 at 2 layers: loss and grad_norm <= 8.8e-8; params
# fsdp 2 4.4e-6 / 1.2e-3, model 2 7.6e-6 / 2.2e-3 (row_rel takes the
# row of an element whose grad sits near Adam's eps).
TR_TOL = {("bfloat16", "fsdp2"): dict(loss=3e-7, grad_norm=1.5e-3, params=(2.6e-3, 6e-2)),
          ("bfloat16", "model2"): dict(loss=1e-4, grad_norm=4e-4, params=(1.3e-2, 9.4e-2)),
          ("float32", "fsdp2"): dict(loss=3e-7, grad_norm=3e-7, params=(1.4e-5, 3.6e-3)),
          ("float32", "model2"): dict(loss=3e-7, grad_norm=3e-7, params=(2.3e-5, 6.6e-3))}
# LoRA on the row-parallel targets (LR_ROW_TARGETS) over model 2 against
# the unsharded LoRA run, per dtype: the first step's loss and grad_norm by
# relative difference and the adapters after TR_STEPS steps by
# flash_errors' (rel_l2, row_rel) over each leaf; ~3x the sound reading on
# the H100 (PERF.md, phase 15), a reading of 0 ~3 f32 ulps. bf16: loss
# 1.25e-5, grad_norm 1.08e-3 (the unsharded norm sums each bf16 leaf in
# bf16), adapters rel_l2 0.134; f32 at 2 layers: loss and grad_norm 0,
# adapters 1.68e-4 / 2.1e-2. The adapters start from B = 0, so after two
# steps B is two of Adam's normalised steps, ~lr an element whatever the
# grad's size: an element whose tiny grad the model-2 ranks' bf16 partial
# sums round to the other sign lands ~2 lr away, and any row holding one
# reads row_rel ~2 (1.99 in bf16). So the bf16 adapters are held by
# rel_l2 alone (None: no row_rel limit); f32 holds both. The column-axes
# mutant reads grad_norm 0.287, adapters 1.01.
TR_LORA_TOL = {"bfloat16": dict(loss=3.8e-5, grad_norm=3.2e-3, params=(0.4, None)),
               "float32": dict(loss=3.6e-7, grad_norm=3.6e-7, params=(5e-4, 6.3e-2))}
# (B*H, S, hd) of kernels #2-#4 on a rank, both layouts: the model-2 rank's
# 8 rows x 8 q heads and the fsdp-2 rank's 4 rows x 16 q heads (15c).
TR_KERNEL_CASES = (("rank_bf16", torch.bfloat16, TR_B * 8, TR_S, 128, True),
                   ("rank_f32", torch.float32, TR_B * 8, TR_S, 128, True))


def tr_mutate(kind):
    """15(e): skip the sum a collective owes. "fsdp": the fsdp gather's
    backward keeps the rank's own block of its grad, unsummed; "model":
    the blocks' row-parallel products (wo, w_down) are not summed over
    the model axis. Returns the undo."""
    from dstack_tpu_torch.workloads import sharding, transformer

    if kind == "fsdp":
        orig = sharding.reduce_scatter

        def own_block(x, dim, mesh, axes):
            n = mesh.shape["fsdp"]
            size = x.shape[dim] // n
            return x.narrow(dim, mesh.coords["fsdp"] * size, size).contiguous()

        sharding.reduce_scatter = own_block
        return lambda: setattr(sharding, "reduce_scatter", orig)
    if kind == "model":
        orig = transformer.reduce_model
        transformer.reduce_model = lambda x, mesh: x
        return lambda: setattr(transformer, "reduce_model", orig)
    return lambda: None


def tr_launch_spy():
    """The shapes (B*H, S, hd) each flash kernel launched at, recorded by
    a wrapper of `flash_attention._launch` (counting is the wrapper's own,
    untouched). Returns (shapes, undo)."""
    from dstack_tpu_torch.workloads import flash_attention as fa

    orig, shapes = fa._launch, {}

    def spy(name, tensors, causal):
        shapes.setdefault(name, set()).add(tuple(tensors[0].shape))
        return orig(name, tensors, causal)

    fa._launch = spy
    return shapes, lambda: setattr(fa, "_launch", orig)


def tr_steps(cfg, mesh, device):
    """TR_STEPS steps of the port's trainer from seed 0's params on the
    global batch of seed 0 (this rank's rows on a mesh): the first step's
    metrics, each step's wall ms, the flash launches and the collectives
    of the steps, the peak memory. Returns (state, readings)."""
    from dstack_tpu_torch.workloads import train

    torch.cuda.reset_peak_memory_stats()
    state = train.init_train_state(cfg, seed=0, device=None if mesh else device, mesh=mesh)
    step = train.make_train_step(cfg, mesh)
    batch = train.synthetic_batch(cfg, TR_B, TR_S, seed=0,
                                  device=None if mesh else device, mesh=mesh)
    stats0 = dict(mesh.stats) if mesh else {}
    zero_flash_counts()
    metrics, step_ms = [], []
    for _ in range(TR_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, batch)
        vals = [float(m["loss"]), float(m["grad_norm"]), float(m["router_aux"])]
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        metrics.append(vals)
    r = dict(loss=metrics[0][0], grad_norm=metrics[0][1], router_aux=metrics[0][2],
             losses=[v[0] for v in metrics], step_ms=step_ms,
             launches_per_step={k: v / TR_STEPS for k, v in flash_counts().items()},
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             rows=int(batch["inputs"].shape[0]))
    if mesh:
        delta = {k: mesh.stats[k] - stats0[k] for k in mesh.stats}
        r["collectives_per_step"] = {k: v / TR_STEPS for k, v in delta.items()
                                     if not k.endswith("seconds") and k != "broadcasts"}
        r["collective_ms_per_step"] = sum(v for k, v in delta.items()
                                          if k.endswith("seconds")) * 1e3 / TR_STEPS
    del batch
    return state, r


def tr_param_gaps(got, ref) -> dict:
    """Every param leaf's flash_errors (rel_l2, row_rel) against the
    unsharded run's; the largest of each and where."""
    from dstack_tpu_torch.workloads.weights import flatten_params

    ref = dict(ref)
    worst = dict(rel_l2=0.0, row_rel=0.0, rel_l2_leaf=None, row_rel_leaf=None)
    for name, t in flatten_params(got):
        rel_l2, row_rel = flash_errors(t.detach(), ref[name].to(t.device))[:2]
        for key, val in (("rel_l2", rel_l2), ("row_rel", row_rel)):
            if val > worst[key]:
                worst[key], worst[key + "_leaf"] = val, name
    return worst


def tr_compare(r, ref, tol) -> dict:
    return dict(loss_rel=abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_norm_rel=abs(r["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"]),
                tol=tol)


def tr_run_cases(cfg, rank, mesh_of, cases, device, ckpt_case=None) -> dict:
    """Rank 0 runs the unsharded steps (rank 1 waits), then every rank
    runs each case on its mesh; rank 0 holds the whole params against the
    unsharded ones. `ckpt_case`: after that case's steps the state is
    saved from every rank's shards and rank 0 restores it on one device."""
    import tempfile

    from dstack_tpu_torch.workloads import checkpoint as ckpt
    from dstack_tpu_torch.workloads import sharding, train
    from dstack_tpu_torch.workloads.weights import flatten_params

    dtype = cfg.dtype
    out, ref, ref_params = {}, None, None
    if rank == 0:
        state, ref = tr_steps(cfg, None, device)
        ref_params = [(k, t.detach().to("cpu", copy=True)) for k, t in flatten_params(state.params)]
        del state
        torch.cuda.empty_cache()
        log(f"phase 15 unsharded {dtype}: " + json.dumps(ref))
    torch.distributed.barrier()
    for name, layout, mutation in cases:
        mesh = mesh_of[layout]
        shapes, undo_spy = tr_launch_spy()
        undo = tr_mutate(mutation)
        try:
            state, r = tr_steps(cfg, mesh, device)
        finally:
            undo()
            undo_spy()
        r["kernel_shapes"] = {k: sorted(v) for k, v in shapes.items()}
        whole = sharding.unshard_tree(mesh, state.params)
        if name == ckpt_case:
            d = tempfile.mkdtemp(prefix="phase15-ckpt-") if rank == 0 else None
            d = sharding.broadcast_object(d, mesh)
            ckpt.save(d, state, wait=True, mesh=mesh)
            ckpt.close_all()
        every = [None] * TR_RANKS
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, layout=layout, mutation=mutation, dtype=dtype,
                       n_layers=cfg.n_layers,
                       **tr_compare(every[0], ref, TR_TOL[(dtype, layout)]),
                       params=tr_param_gaps(whole, ref_params))
            if name == ckpt_case:
                tmpl = train.init_train_state(cfg, seed=1, device=device)
                restored = ckpt.restore_latest(d, tmpl)
                res["checkpoint"] = dict(
                    step=restored.step,
                    equal=all(torch.equal(a.detach(), b) for (_, a), (_, b) in zip(
                        flatten_params(restored.params), flatten_params(whole))))
                import shutil

                shutil.rmtree(d, ignore_errors=True)
                del tmpl, restored
            out[name] = res
            log(f"phase 15 {name} ({dtype}, {cfg.n_layers} layers): " + json.dumps(res))
        del state, whole
        torch.cuda.empty_cache()
    if rank == 0:
        out["unsharded"] = ref
    return out


def tr_rank_main(rank: int, init: str) -> int:
    """One rank of phase 15, a process of its own: smol-1b at full width
    and depth on two gloo ranks sharing cuda:0, fsdp 2 and model 2 and
    their mutants against the unsharded step on the same card, then the
    f32 check at TR_F32_LAYERS layers with the checkpoint from fsdp 2;
    then LoRA on the row targets over model 2 against the unsharded LoRA
    run, at full depth and in f32 with the column-axes mutant. Rank 0
    prints its readings as one JSON line."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.init_ranks(TR_RANKS, rank, init, backend="gloo", device=TR_DEVICE)
    meshes = {name: sharding.make_mesh([TR_DEVICE], layout="training", **axes)
              for name, axes in TR_LAYOUTS.items()}
    cfg = PRESETS[TR_PRESET]
    out = {"bf16": tr_run_cases(cfg, rank, meshes, TR_CASES, TR_DEVICE)}
    cfg32 = cfg.with_(n_layers=TR_F32_LAYERS, dtype="float32")
    out["f32"] = tr_run_cases(cfg32, rank, meshes, TR_CASES[:2], TR_DEVICE, ckpt_case="fsdp2")
    shape = (TR_B, TR_S, TR_STEPS)
    out["lora"] = {"bf16": lora_rank_run(cfg, rank, meshes["model2"], TR_DEVICE, LR_ROW_TARGETS,
                                         shape, (), TR_LORA_TOL["bfloat16"]),
                   "f32": lora_rank_run(cfg32, rank, meshes["model2"], TR_DEVICE,
                                        LR_ROW_TARGETS, shape, ("column_axes",),
                                        TR_LORA_TOL["float32"])}
    out["rl"] = {"bf16": rlr_run(cfg.with_(n_layers=RLR_LAYERS), rank, meshes, TR_DEVICE,
                                 RLR_CASES),
                 "f32": rlr_run(cfg.with_(n_layers=RLR_F32_LAYERS, dtype="float32"), rank,
                                meshes, TR_DEVICE,
                                RLR_CASES + tuple((m, layout, m) for m, layout, _ in RLR_MUTANTS))}
    if rank == 0:
        print("TR_RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def check_train_ranks(res: dict) -> None:
    """The gates of 15(a), (b), (d), (e) and (g) on rank 0's readings."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[TR_PRESET]
    # Either layout: B/2 rows x H heads, or B rows x H/2 heads.
    rank_shape = (TR_B * cfg.n_heads // TR_RANKS, TR_S, cfg.head_dim)
    if "lora" in res:
        check_lora_ranks(res["lora"], "15", rank_shape)
    if "rl" in res:
        check_rl_ranks(res["rl"])
    for dtype_tag, cases in res.items():
        if dtype_tag in ("lora", "rl"):
            continue
        for name, r in cases.items():
            if name == "unsharded":
                continue
            tol, p = r["tol"], r["params"]
            within = (p["rel_l2"] <= tol["params"][0] and p["row_rel"] <= tol["params"][1])
            if r["mutation"]:
                if within:
                    raise AssertionError(f"phase 15 {name}: the param gate passes the"
                                         f" mutant ({p}, tol {tol['params']})")
                continue
            if not (r["loss_rel"] <= tol["loss"] and r["grad_norm_rel"] <= tol["grad_norm"]
                    and within):
                raise AssertionError(f"phase 15 {name} {dtype_tag}: loss {r['loss_rel']},"
                                     f" grad_norm {r['grad_norm_rel']}, params {p}; tol {tol}")
            if dtype_tag == "f32" and name == "fsdp2" and not r["checkpoint"]["equal"]:
                raise AssertionError(f"phase 15: the fsdp-2 checkpoint restores other params"
                                     f" on one device: {r['checkpoint']}")
            for rk, rr in enumerate(r["ranks"]):
                if [rr["loss"], rr["grad_norm"]] != [r["ranks"][0]["loss"],
                                                     r["ranks"][0]["grad_norm"]]:
                    raise AssertionError(f"phase 15 {name}: rank {rk}'s metrics differ")
                want = r["n_layers"]
                got = {k: rr["launches_per_step"][k]
                       for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                if any(v != want for v in got.values()):
                    raise AssertionError(f"phase 15 {name} rank {rk}: flash launches per step"
                                         f" {got}, not {want}")
                if dtype_tag == "bf16":
                    shapes = {tuple(s) for v in rr["kernel_shapes"].values() for s in v}
                    if shapes != {rank_shape}:
                        raise AssertionError(f"phase 15 {name} rank {rk}: kernel shapes"
                                             f" {rr['kernel_shapes']}, not a rank's")


def run_train_nccl() -> dict:
    """15(f): a world-1 NCCL group on cuda:0 takes a training step at
    TR_F32_LAYERS layers of smol-1b on the training layout, saves and
    restores its checkpoint through the mesh (the restore's barrier runs
    over NCCL). At world 1 the step's collectives have one shard and
    return their inputs. In a process of its own (`--tr-nccl`), after
    14(f) in the same process (`--tp-nccl --tr-nccl`)."""
    import tempfile

    from dstack_tpu_torch.workloads import checkpoint as ckpt
    from dstack_tpu_torch.workloads import sharding, train
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS["smol-1b"].with_(n_layers=TR_F32_LAYERS)
    sharding.init_ranks(1, 0, sharding.loopback_rendezvous(), backend="nccl", device="cuda:0")
    try:
        mesh = sharding.make_mesh(["cuda:0"], layout="training")
        state = train.init_train_state(cfg, seed=0, mesh=mesh)
        step = train.make_train_step(cfg, mesh)
        state, m = step(state, train.synthetic_batch(cfg, 2, TR_S, seed=0, mesh=mesh))
        d = tempfile.mkdtemp(prefix="phase15-nccl-")
        ckpt.save(d, state, wait=True, mesh=mesh)
        restored = ckpt.restore_latest(d, state, mesh)
        ckpt.close_all()
        r = dict(backend=mesh.backend, loss=float(m["loss"]), step=restored.step,
                 layout=mesh.layout)
    finally:
        torch.distributed.destroy_process_group()
    if r["backend"] != "nccl" or not math.isfinite(r["loss"]) or r["step"] != 1:
        raise AssertionError(f"phase 15(f): {r}")
    print("TR_NCCL " + json.dumps(r), flush=True)
    return r


def launch_procs(argv, tag: str, n: int, marker: str, timeout: float) -> str:
    """Start `n` processes of this script with `argv` (+ the rank and a
    loopback rendezvous when n > 1), each killed past `timeout`; a process
    that fails fails the phase. Returns the value of rank 0's `marker`
    line; the logs go to chiprun_out/<tag>_rank<r>.log."""
    from dstack_tpu_torch.workloads.sharding import loopback_rendezvous

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    init = loopback_rendezvous()
    paths = [f"chiprun_out/{tag}_rank{r}.log" for r in range(n)]
    logs = [open(path, "w") for path in paths]
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv,
             *(["--rank", str(r), "--dist-init", init] if n > 1 else [])],
            stdout=logs[r], stderr=subprocess.STDOUT, start_new_session=True)
            for r in range(n)]
        codes = wait_ranks(procs, timeout)
    finally:
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        if code != 0:
            text = open(paths[r]).read()
            raise AssertionError(f"{tag} rank {r} exited {code}:\n{text[-4000:]}")
    line = next(ln for ln in open(paths[0]).read().splitlines() if ln.startswith(marker + " "))
    return json.loads(line[len(marker) + 1:])


def run_train_ranks(nccl: dict) -> dict:
    """Phase 15: (c) kernels #2-#4 at a rank's geometry here, (a, b, d,
    e, g, h) in two rank processes; (f), `nccl`, ran in phase 14's NCCL
    process."""
    t0 = time.monotonic()
    kernels = run_flash(cases=TR_KERNEL_CASES)
    t1 = time.monotonic()
    ranks = launch_procs(["--tr-rank"], "phase15", TR_RANKS, "TR_RESULT", TR_TIMEOUT)
    check_train_ranks(ranks)
    t2 = time.monotonic()
    r, ref = ranks["lora"]["bf16"]["sound"], ranks["lora"]["bf16"]["unsharded"]
    log(f"phase 15 LoRA on {list(LR_ROW_TARGETS)} over model 2: step"
        f" {r['ranks'][0]['step_ms'][-1]:.1f} ms against unsharded {ref['step_ms'][-1]:.1f};"
        f" loss {r['loss_rel']:.3e}, grad_norm {r['grad_norm_rel']:.3e}, adapters"
        f" {r['params']}; collectives {r['ranks'][0]['collectives_per_step']}; peak"
        f" {[round(x['peak_mem_gb'], 2) for x in r['ranks']]} GB per rank; the column-axes"
        f" mutant's grad_norm {ranks['lora']['f32']['column_axes']['grad_norm_rel']:.3e}")
    for name in ("fsdp2", "model2"):
        r, ref = ranks["bf16"][name], ranks["bf16"]["unsharded"]
        log(f"phase 15 {name} (gloo, two ranks on one card: a check, not a parallel"
            f" speed): step {r['ranks'][0]['step_ms'][-1]:.1f} ms against unsharded"
            f" {ref['step_ms'][-1]:.1f}; collectives per step"
            f" {r['ranks'][0]['collectives_per_step']} taking"
            f" {r['ranks'][0]['collective_ms_per_step']:.1f} ms; peak"
            f" {[round(x['peak_mem_gb'], 2) for x in r['ranks']]} GB per rank")
    log(f"phase 15: kernels {t1 - t0:.1f}s, ranks {t2 - t1:.1f}s (15(f): phase 14's process)")
    return dict(kernels=kernels, ranks=ranks, nccl=nccl,
                seconds=dict(kernels=t1 - t0, ranks=t2 - t1))


# -- phase 16: the ring across ranks ----------------------------------------------

RG_RANKS = 4
# The model and the one card the four ranks share (a CPU dry run swaps in
# a small preset and "cpu").
RG_PRESET, RG_DEVICE = "smol-1b-8k", "cuda:0"
# Phase 7's shape: B 1 x S 8192, S 2048 a rank; RG_STEPS steps per case.
RG_B, RG_S, RG_STEPS = 1, 8192, 2
# Each rank process's limit (seconds). The four ranks peak at 12.1-12.3 GB
# each on the card (PERF.md, phase 16).
RG_TIMEOUT = 600
# The f32 check's depth (smol-1b-8k's width, TF32 off), where the mutants
# run too.
RG_F32_LAYERS = 2
# (case, mutation): the sound ring at full depth in bf16, then at
# RG_F32_LAYERS in f32 the sound ring and its two mutants, which the param
# gate must fail: every hop sent to the previous rank instead of the next,
# and the backward's last hop (the dK/dV accumulators' way home) skipped.
RG_MUTANTS = ("wrong_neighbour", "short_of_home")
# The ranks against phase 7's one-device ring on one card (16a, 16b), per
# dtype: the first step's loss and grad_norm by relative difference, every
# param after RG_STEPS steps by flash_errors' (rel_l2, row_rel) over its
# leaf. Each limit is ~3x the sound reading on the H100 (PERF.md, phase
# 16); a reading of 0 gets ~3 f32 ulps. bf16: loss 8.75e-8, grad_norm
# 1.35e-4 (four bf16 partials summed over seq against one GEMM), params
# 2.13e-3 / 2.92e-2; f32 at 2 layers: loss and grad_norm 0, params
# 8.24e-6 / 2.12e-3. The mutants read loss 1.2e-3 and params 3.6e-2 (the
# wrong neighbour), grad_norm 3.7e-2 and params 3.2e-2 (short of home).
RG_TOL = {"bfloat16": dict(loss=3e-7, grad_norm=4e-4, params=(6.4e-3, 9e-2)),
          "float32": dict(loss=3e-7, grad_norm=3e-7, params=(2.5e-5, 6.4e-3))}


def rg_mutate(kind):
    """16(e): a hop to the wrong neighbour (every ppermute by -shift), or
    the dK/dV accumulators stopped one hop short of home. Returns the undo."""
    from dstack_tpu_torch.workloads import attention, sharding

    if kind == "wrong_neighbour":
        orig = sharding.ppermute
        sharding.ppermute = lambda xs, mesh, axis, shift=1: orig(xs, mesh, axis, -shift)
        return lambda: setattr(sharding, "ppermute", orig)
    if kind == "short_of_home":
        orig = attention._RankRing.home
        attention._RankRing.home = staticmethod(lambda acc, mesh: acc)
        return lambda: setattr(attention._RankRing, "home", orig)
    return lambda: None


def leaf_digest(params) -> float:
    """A float64 sum over every leaf: equal on ranks whose replicas are
    equal bit for bit (a check that the replicas did not part)."""
    from dstack_tpu_torch.workloads.weights import flatten_params

    return float(sum(t.detach().double().sum() for _, t in flatten_params(params)))


def rank_steps(cfg, make_state, make_step, batch, mesh, n_steps):
    """`n_steps` steps: the first step's metrics, each step's wall ms, the
    flash launches, hops and collectives per step (each kind's count, MB
    put in and ms), the peak memory. Returns (state, readings)."""
    torch.cuda.reset_peak_memory_stats()
    state = make_state()
    step = make_step()
    stats0 = dict(mesh.stats) if mesh is not None else {}
    zero_flash_counts()
    metrics, step_ms = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"]),
                        float(m.get("router_aux", 0.0))])
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    r = dict(loss=metrics[0][0], grad_norm=metrics[0][1], router_aux=metrics[0][2],
             losses=[v[0] for v in metrics], step_ms=step_ms,
             launches_per_step={k: v / n_steps for k, v in flash_counts().items()},
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if mesh is not None:
        delta = {k: mesh.stats[k] - stats0[k] for k in mesh.stats}
        kinds = ("all_gather", "all_reduce", "reduce_scatter")
        r["hops_per_step"] = delta["hops"] / n_steps
        r["hop_ms_per_step"] = delta["hop_seconds"] * 1e3 / n_steps
        r["hop_mb_per_step"] = delta["hop_bytes"] / 1e6 / n_steps
        r["collectives_per_step"] = {k + "s": delta[k + "s"] / n_steps for k in kinds}
        r["collective_ms_per_step"] = sum(delta[k + "_seconds"] for k in kinds) * 1e3 / n_steps
        r["collective_mb_per_step"] = {k: delta[k + "_bytes"] / 1e6 / n_steps for k in kinds}
        r["collective_ms_by_kind"] = {k: delta[k + "_seconds"] * 1e3 / n_steps for k in kinds}
    return state, r


def rg_run(cfg, rank, mesh, device, mutations) -> dict:
    """Rank 0 runs phase 7's one-device ring (the others wait), then every
    rank runs the ring across the ranks, sound and with each of
    `mutations`; rank 0 holds its params against the one-device run's."""
    from dstack_tpu_torch.workloads import sharding, train

    ref = ref_params = None
    if rank == 0:
        one = sharding.Mesh(torch.device(device), dict(zip(sharding.AXES, (1, 1, RG_RANKS, 1, 1))))
        batch = train.synthetic_batch(cfg, RG_B, RG_S, seed=0, device=device)
        state, ref = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, mesh=one),
                                lambda: train.make_train_step(cfg, one), batch, None, RG_STEPS)
        ref_params = state_host(state)
        del state, batch
        torch.cuda.empty_cache()
        log(f"phase 16 one-device ring {cfg.dtype}: " + json.dumps(ref))
    torch.distributed.barrier()
    out = {}
    batch = train.synthetic_batch(cfg, RG_B, RG_S, seed=0, mesh=mesh)
    for mutation in (None, *mutations):
        shapes, undo_spy = tr_launch_spy()
        undo = rg_mutate(mutation)
        try:
            state, r = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, mesh=mesh),
                                  lambda: train.make_train_step(cfg, mesh), batch, mesh,
                                  RG_STEPS)
        finally:
            undo()
            undo_spy()
        r["kernel_shapes"] = {k: sorted(v) for k, v in shapes.items()}
        r["digest"] = leaf_digest(state.params)
        every = [None] * RG_RANKS
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, mutation=mutation, dtype=cfg.dtype, n_layers=cfg.n_layers,
                       **tr_compare(every[0], ref, RG_TOL[cfg.dtype]),
                       params=tr_param_gaps(state.params, ref_params))
            out[mutation or "sound"] = res
            log(f"phase 16 {mutation or 'sound'} ({cfg.dtype}, {cfg.n_layers} layers): "
                + json.dumps(res))
        del state
        torch.cuda.empty_cache()
    if rank == 0:
        out["one_device"] = ref
    return out


def state_host(state):
    """[(name, host copy)] of a train state's params."""
    from dstack_tpu_torch.workloads.weights import flatten_params

    return [(k, t.detach().to("cpu", copy=True)) for k, t in flatten_params(state.params)]


def rg_rank_main(rank: int, init: str) -> int:
    """One rank of phase 16, a process of its own: smol-1b-8k at full
    width and depth on four gloo ranks sharing cuda:0, a seq axis of 4 (the
    ring across the ranks), against phase 7's one-device ring on the same
    card, weights and batch; then at RG_F32_LAYERS in f32 with the two
    mutants. Rank 0 prints its readings as one JSON line."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.init_ranks(RG_RANKS, rank, init, backend="gloo", device=RG_DEVICE)
    mesh = sharding.make_mesh([RG_DEVICE], layout="training", seq=RG_RANKS)
    cfg = PRESETS[RG_PRESET]
    out = {"bf16": rg_run(cfg, rank, mesh, RG_DEVICE, ())}
    cfg32 = cfg.with_(n_layers=RG_F32_LAYERS, dtype="float32")
    out["f32"] = rg_run(cfg32, rank, mesh, RG_DEVICE, RG_MUTANTS)
    if rank == 0:
        print("RG_RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def gates_pass(r: dict) -> bool:
    """Whether a case's first loss, grad_norm and params are within its
    tolerances (and, where read, the shared replicas equal)."""
    tol, p = r["tol"], r["params"]
    return (r["loss_rel"] <= tol["loss"] and r["grad_norm_rel"] <= tol["grad_norm"]
            and p["rel_l2"] <= tol["params"][0] and p["row_rel"] <= tol["params"][1]
            and r.get("shared_equal", True))


def check_ring_ranks(res: dict) -> None:
    """The gates of 16(a), (b), (d) and (e) on rank 0's readings."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[RG_PRESET]
    shape = (RG_B * cfg.n_heads, RG_S // RG_RANKS, cfg.head_dim)
    for dtype_tag, cases in res.items():
        for name, r in cases.items():
            if name == "one_device":
                continue
            tol, p = r["tol"], r["params"]
            if r["mutation"]:
                if gates_pass(r):
                    raise AssertionError(f"phase 16 {name}: the gates pass the mutant (loss"
                                         f" {r['loss_rel']}, grad_norm {r['grad_norm_rel']},"
                                         f" params {p}, tol {tol})")
                continue
            if not gates_pass(r):
                raise AssertionError(f"phase 16 {dtype_tag}: loss {r['loss_rel']}, grad_norm"
                                     f" {r['grad_norm_rel']}, params {p}; tol {tol}")
            first = r["ranks"][0]
            for rk, rr in enumerate(r["ranks"]):
                if [rr["loss"], rr["grad_norm"], rr["digest"]] != [
                        first["loss"], first["grad_norm"], first["digest"]]:
                    raise AssertionError(f"phase 16: rank {rk}'s metrics or params differ")
                # Rank i attends shards 0..i: i + 1 ring steps a layer and
                # forward, no other flash kernel (the backward is plain).
                want = dict.fromkeys(FLASH_REPLACES, 0.0)
                want["flash_block_fwd"] = float((rk + 1) * r["n_layers"])
                if rr["launches_per_step"] != want:
                    raise AssertionError(f"phase 16 rank {rk}: launches per step"
                                         f" {rr['launches_per_step']}, not {want}")
                # n - 1 hops a layer forward, n backward.
                hops = float(r["n_layers"] * (2 * RG_RANKS - 1))
                if rr["hops_per_step"] != hops:
                    raise AssertionError(f"phase 16 rank {rk}: {rr['hops_per_step']} hops a"
                                         f" step, not {hops}")
                if dtype_tag == "bf16" and rr["kernel_shapes"] != {
                        "flash_block_fwd": [list(shape)]}:
                    raise AssertionError(f"phase 16 rank {rk}: kernel shapes"
                                         f" {rr['kernel_shapes']}, not {shape}")


def run_ring_ranks() -> dict:
    """Phase 16: four rank processes over gloo on the card (kernel #5 at
    their geometry is phase 3c's)."""
    t0 = time.monotonic()
    res = launch_procs(["--rg-rank"], "phase16", RG_RANKS, "RG_RESULT", RG_TIMEOUT)
    check_ring_ranks(res)
    r, ref = res["bf16"]["sound"], res["bf16"]["one_device"]
    log(f"phase 16 (gloo, four ranks on one card: a check, not a parallel speed): step"
        f" {[round(x['step_ms'][-1], 1) for x in r['ranks']]} ms against the one-device"
        f" ring's {ref['step_ms'][-1]:.1f}; hops per step {r['ranks'][0]['hops_per_step']}"
        f" ({r['ranks'][0]['hop_mb_per_step']:.1f} MB, {r['ranks'][0]['hop_ms_per_step']:.1f}"
        f" ms), collectives {r['ranks'][0]['collectives_per_step']}"
        f" ({r['ranks'][0]['collective_ms_per_step']:.1f} ms); peak"
        f" {[round(x['peak_mem_gb'], 2) for x in r['ranks']]} GB per rank;"
        f" {time.monotonic() - t0:.1f}s")
    return dict(ranks=res, seconds=time.monotonic() - t0)


# -- phase 17: the GPipe pipeline ---------------------------------------------------

PP_RANKS = 2
PP_PRESET, PP_DEVICE = "smol-1b", "cuda:0"
# Phase 6's shape: B 8 x S 2048 in PP_MICRO microbatches of 2 rows.
PP_B, PP_S, PP_MICRO, PP_STEPS = 8, 2048, 4, 2
PP_TIMEOUT = 600
PP_F32_LAYERS = 2
# The mutants the param gate must fail (at PP_F32_LAYERS in f32): each
# microbatch's output collected one tick early (slot m takes microbatch
# m - 1's), and the shared leaves' grads not summed over pipe.
PP_MUTANTS = ("early_collect", "shared_unsummed")
# The stages against phase 6's unsharded step (17a, 17b), as RG_TOL: ~3x
# the sound reading on the H100 (PERF.md, phase 17). bf16: loss 0 (the
# microbatches' rows run the same kernels), grad_norm 1.96e-5, params
# 9.66e-4 / 2.73e-2; f32 at 2 layers: loss 0, grad_norm 6.5e-8, params
# 3.8e-6 / 7.8e-4. The mutants read loss 3.5e-4 and params 2.3e-2 (the
# early collect), grad_norm 1.9e-2, params 2.3e-2 and parted replicas
# (the shared grads unsummed).
PP_TOL = {"bfloat16": dict(loss=3e-7, grad_norm=6e-5, params=(2.9e-3, 8.2e-2)),
          "float32": dict(loss=3e-7, grad_norm=3e-7, params=(1.2e-5, 2.4e-3))}
# (B*H, S, hd) of kernels #2-#4 on a stage: a microbatch's 2 rows x 16 heads.
PP_KERNEL_CASES = (("stage_bf16", torch.bfloat16, PP_B // PP_MICRO * 16, PP_S, 128, True),
                   ("stage_f32", torch.float32, PP_B // PP_MICRO * 16, PP_S, 128, True))


def pp_mutate(kind):
    """17(e): the mutants of PP_MUTANTS. Returns the undo."""
    from dstack_tpu_torch.workloads import pipeline

    if kind == "early_collect":
        orig = pipeline.collect
        pipeline.collect = lambda outs: [outs[0]] + list(outs[:-1])
        return lambda: setattr(pipeline, "collect", orig)
    if kind == "shared_unsummed":
        orig = pipeline.sum_shared_grads
        pipeline.sum_shared_grads = lambda grads, mesh: grads
        return lambda: setattr(pipeline, "sum_shared_grads", orig)
    return lambda: None


def gather_stages(cfg, params, mesh):
    """On rank 0: the whole params, its stage's layers and every other
    stage's, received leaf by leaf over the pipe line, plus whether every
    stage's shared leaves equal rank 0's bit for bit. Other ranks send
    theirs and get (None, None)."""
    from dstack_tpu_torch.workloads.pipeline import SHARED
    from dstack_tpu_torch.workloads.sharding import exchange
    from dstack_tpu_torch.workloads.weights import flatten_params

    stage, n = mesh.coords["pipe"], mesh.shape["pipe"]
    whole, equal = [], True
    for k, t in flatten_params(params):
        t = t.detach()
        if stage:
            exchange(mesh, "pipe", send=t, dst=0)
            continue
        parts = [t] + [exchange(mesh, "pipe", recv_like=t, src=s) for s in range(1, n)]
        if k.split("/")[0] in SHARED:
            equal = equal and all(torch.equal(p, t) for p in parts)
            whole.append((k, t))
        else:
            cat = torch.cat(parts)
            whole.append((k, cat.reshape(cfg.n_layers, *cat.shape[2:])))
    return (whole, equal) if stage == 0 else (None, None)


def pp_run(cfg, rank, mesh, device, mutations) -> dict:
    """Rank 0 runs phase 6's unsharded step (the other waits), then both
    stages run the pipeline, sound and with each of `mutations`; rank 0
    gathers the stages' params and holds them against the unsharded run's."""
    from dstack_tpu_torch.workloads import pipeline, train
    from dstack_tpu_torch.workloads.weights import unflatten_params

    ref = ref_params = None
    if rank == 0:
        batch = train.synthetic_batch(cfg, PP_B, PP_S, seed=0, device=device)
        state, ref = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, device=device),
                                lambda: train.make_train_step(cfg), batch, None, PP_STEPS)
        ref_params = state_host(state)
        del state, batch
        torch.cuda.empty_cache()
        log(f"phase 17 unsharded {cfg.dtype}: " + json.dumps(ref))
    torch.distributed.barrier()
    out = {}
    batch = pipeline.pipeline_batch(cfg, PP_B, PP_S, mesh, seed=0)
    for mutation in (None, *mutations):
        shapes, undo_spy = tr_launch_spy()
        undo = pp_mutate(mutation)
        try:
            state, r = rank_steps(
                cfg, lambda: pipeline.init_pipeline_state(cfg, 0, mesh),
                lambda: pipeline.make_pipeline_train_step(cfg, mesh, PP_MICRO), batch, mesh,
                PP_STEPS)
        finally:
            undo()
            undo_spy()
        r["kernel_shapes"] = {k: sorted(v) for k, v in shapes.items()}
        whole, equal = gather_stages(cfg, state.params, mesh)
        every = [None] * PP_RANKS
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, mutation=mutation, dtype=cfg.dtype, n_layers=cfg.n_layers,
                       shared_equal=equal, **tr_compare(every[0], ref, PP_TOL[cfg.dtype]),
                       params=tr_param_gaps(unflatten_params(whole), ref_params))
            out[mutation or "sound"] = res
            log(f"phase 17 {mutation or 'sound'} ({cfg.dtype}, {cfg.n_layers} layers): "
                + json.dumps(res))
        del state, whole
        torch.cuda.empty_cache()
    if rank == 0:
        out["unsharded"] = ref
    return out


def pp_rank_main(rank: int, init: str) -> int:
    """One stage of phase 17, a process of its own: smol-1b at full width
    and depth cut into two stages of 8 layers on two gloo ranks sharing
    cuda:0, B 8 x 2048 in 4 microbatches, against phase 6's unsharded step
    on the same card, weights and batch; then at PP_F32_LAYERS in f32 with
    the two mutants. Rank 0 prints its readings as one JSON line."""
    from dstack_tpu_torch.workloads import pipeline, sharding
    from dstack_tpu_torch.workloads.config import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.init_ranks(PP_RANKS, rank, init, backend="gloo", device=PP_DEVICE)
    mesh = pipeline.make_pipeline_mesh([PP_DEVICE], data=1, pipe=PP_RANKS)
    cfg = PRESETS[PP_PRESET]
    out = {"bf16": pp_run(cfg, rank, mesh, PP_DEVICE, ())}
    cfg32 = cfg.with_(n_layers=PP_F32_LAYERS, dtype="float32")
    out["f32"] = pp_run(cfg32, rank, mesh, PP_DEVICE, PP_MUTANTS)
    if rank == 0:
        print("PP_RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def check_pipeline(res: dict) -> None:
    """The gates of 17(a), (b), (d) and (e) on rank 0's readings."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[PP_PRESET]
    shape = (PP_B // PP_MICRO * cfg.n_heads, PP_S, cfg.head_dim)
    for dtype_tag, cases in res.items():
        for name, r in cases.items():
            if name == "unsharded":
                continue
            tol, p = r["tol"], r["params"]
            if r["mutation"]:
                if gates_pass(r):
                    raise AssertionError(f"phase 17 {name}: the gates pass the mutant (loss"
                                         f" {r['loss_rel']}, grad_norm {r['grad_norm_rel']},"
                                         f" params {p}, tol {tol})")
                continue
            if not gates_pass(r):
                raise AssertionError(f"phase 17 {dtype_tag}: loss {r['loss_rel']}, grad_norm"
                                     f" {r['grad_norm_rel']}, params {p}, shared replicas"
                                     f" equal {r['shared_equal']}; tol {tol}")
            for rk, rr in enumerate(r["ranks"]):
                if [rr["loss"], rr["grad_norm"]] != [r["ranks"][0]["loss"],
                                                     r["ranks"][0]["grad_norm"]]:
                    raise AssertionError(f"phase 17: rank {rk}'s metrics differ")
                # Each stage: its L/P layers for every microbatch.
                n = float(r["n_layers"] // PP_RANKS * PP_MICRO)
                want = dict(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n, flash_block_fwd=0.0)
                if rr["launches_per_step"] != want:
                    raise AssertionError(f"phase 17 stage {rk}: launches per step"
                                         f" {rr['launches_per_step']}, not {want}")
                # A microbatch's activations on, its grads back: 2 a microbatch.
                if rr["hops_per_step"] != 2.0 * PP_MICRO:
                    raise AssertionError(f"phase 17 stage {rk}: {rr['hops_per_step']}"
                                         " exchanges a step")
                if dtype_tag == "bf16":
                    shapes = {tuple(s) for v in rr["kernel_shapes"].values() for s in v}
                    if shapes != {shape}:
                        raise AssertionError(f"phase 17 stage {rk}: kernel shapes"
                                             f" {rr['kernel_shapes']}, not {shape}")


def run_pipeline() -> dict:
    """Phase 17: (c) kernels #2-#4 at a stage's geometry here, (a, b, d, e)
    in two stage processes."""
    t0 = time.monotonic()
    kernels = run_flash(cases=PP_KERNEL_CASES)
    t1 = time.monotonic()
    res = launch_procs(["--pp-rank"], "phase17", PP_RANKS, "PP_RESULT", PP_TIMEOUT)
    check_pipeline(res)
    t2 = time.monotonic()
    r, ref = res["bf16"]["sound"], res["bf16"]["unsharded"]
    log(f"phase 17 (gloo, two stages on one card: a check, not a pipeline speed): step"
        f" {[round(x['step_ms'][-1], 1) for x in r['ranks']]} ms against unsharded"
        f" {ref['step_ms'][-1]:.1f}; exchanges per step {r['ranks'][0]['hops_per_step']}"
        f" ({r['ranks'][0]['hop_mb_per_step']:.1f} MB sent by stage 0,"
        f" {r['ranks'][0]['hop_ms_per_step']:.1f} ms), collectives"
        f" {r['ranks'][0]['collectives_per_step']}; peak"
        f" {[round(x['peak_mem_gb'], 2) for x in r['ranks']]} GB per stage")
    log(f"phase 17: kernels {t1 - t0:.1f}s, stages {t2 - t1:.1f}s")
    return dict(kernels=kernels, ranks=res, seconds=dict(kernels=t1 - t0, stages=t2 - t1))


# -- phase 18: expert parallelism ---------------------------------------------------

EP_RANKS = 2
# The model and the one card both ranks share (a CPU dry run of the rank
# processes swaps in a small preset and "cpu").
EP_PRESET, EP_DEVICE = "smol-moe", "cuda:0"
# 13c's batch, B 2 x S 2048 (every rank of the expert line holds all of
# it), EP_STEPS steps a case.
EP_B, EP_S, EP_STEPS = 2, 2048, 2
# The bf16 run's depth: at 16 layers the two ranks would hold ~37 GB each
# (state and grads 25.5 GB for 2.55 B params, activations ~11.7 GB) and
# leave < 8 GB of the 80 GB beside the smoke's own process, so the phase
# runs 8 of smol-moe's 16 layers at full width, against an unsharded
# 8-layer run of its own on the same card (PERF.md sections 4 and 6).
EP_LAYERS = 8
# The f32 check's depth, with the mutants.
EP_F32_LAYERS = 2
# Each rank process's limit (seconds): start-up, every case.
EP_TIMEOUT = 600
# The faults of the expert line, each run after the sound layout.
EP_MUTANTS = ("block_off", "enter_unsummed", "gather_summed")
# The gate each mutant must fail: the shifted block computes other
# experts' outputs (the loss moves); the tokens' grad left unsummed over
# the line moves every weight before the experts (params); the gathered
# outputs' grad summed over the line doubles the banks' grads (grad_norm).
EP_GUARDS = {"block_off": "loss", "enter_unsummed": "params", "gather_summed": "grad_norm"}
# Expert 2 against the unsharded run on one card, per dtype: the first
# step's loss, grad_norm and router_aux by relative difference, and every
# param after EP_STEPS steps by flash_errors' (rel_l2, row_rel) over its
# leaf. Each limit is ~3x the sound run's reading on the H100 (PERF.md,
# phase 18); a reading of 0 gets ~3 f32 ulps. Each expert's products run
# alone either way and a token's grad sums at most k nonzero terms, so the
# loss, the aux and every param read 0 in both dtypes; grad_norm reads
# 2.69e-4 in bf16 (the unsharded norm sums each leaf in bf16, optax's
# order, a rank's shards in f32) and 6.0e-8 in f32. The mutants read: the
# block off by one, loss 1.56e-3; the tokens' grad unsummed, params
# 2.12e-2; the gathered outputs' grad summed, grad_norm 2.01.
EP_TOL = {"bfloat16": dict(loss=3.6e-7, grad_norm=8e-4, router_aux=3.6e-7,
                           params=(3.6e-7, 3.6e-7)),
          "float32": dict(loss=3.6e-7, grad_norm=1.8e-7, router_aux=3.6e-7,
                          params=(3.6e-7, 3.6e-7))}


# LoRA on wq/wv (LORA_TARGETS) over expert 2 against the unsharded LoRA
# run, per dtype, as TR_LORA_TOL reads; ~3x the sound reading on the H100
# (PERF.md, phase 18), a reading of 0 ~3 f32 ulps. Attention is whole on
# every expert rank, so loss and adapters read 0 in both dtypes; grad_norm
# 7.7e-4 in bf16 (the unsharded norm's bf16 sums), 0 in f32. The
# summed-over-expert mutant reads grad_norm 1.0 (doubled).
EP_LORA_TOL = {"bfloat16": dict(loss=3.6e-7, grad_norm=2.3e-3, params=(3.6e-7, 3.6e-7)),
               "float32": dict(loss=3.6e-7, grad_norm=3.6e-7, params=(3.6e-7, 3.6e-7))}


def ep_mutate(kind):
    """18(b): a fault of the expert line. "block_off": a rank dispatches to
    the next rank's block of experts (its banks stay its own); "enter_unsummed":
    the tokens' grad is not summed over the expert line; "gather_summed":
    the gathered outputs' backward sums the grad over the line before it
    takes the rank's block. Returns the undo."""
    from dstack_tpu_torch.workloads import moe, sharding

    if kind == "block_off":
        orig = moe.expert_block

        def next_block(n, mesh):
            e0, e1 = orig(n, mesh)
            return e1 % n, e1 % n + (e1 - e0)

        moe.expert_block = next_block
        return lambda: setattr(moe, "expert_block", orig)
    if kind == "enter_unsummed":
        orig = moe.enter_expert
        moe.enter_expert = lambda x, mesh: x
        return lambda: setattr(moe, "enter_expert", orig)
    if kind == "gather_summed":
        cls = sharding._GatherExperts
        orig = cls.__dict__["backward"]

        def summed(ctx, g):
            g = sharding.all_reduce(g, ctx.mesh, ("expert",))
            return g.narrow(ctx.dim, ctx.mesh.coords["expert"] * ctx.size, ctx.size), None, None

        cls.backward = staticmethod(summed)
        return lambda: setattr(cls, "backward", orig)
    return lambda: None


def ep_compare(r, ref, tol) -> dict:
    return dict(**{f"{k}_rel": abs(r[k] - ref[k]) / abs(ref[k])
                   for k in ("loss", "grad_norm", "router_aux")}, tol=tol)


def ep_run(cfg, rank, mesh, device, mutations) -> dict:
    """Rank 0 runs the unsharded steps (rank 1 waits), then both ranks run
    the sound expert-2 steps and each mutant's; rank 0 holds the whole
    params after them against the unsharded ones."""
    from dstack_tpu_torch.workloads import sharding, train

    dtype = cfg.dtype
    out, ref, ref_params = {}, None, None
    if rank == 0:
        batch = train.synthetic_batch(cfg, EP_B, EP_S, seed=0, device=device)
        state, ref = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, device=device),
                                lambda: train.make_train_step(cfg), batch, None, EP_STEPS)
        ref_params = state_host(state)
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 18 unsharded {dtype}: " + json.dumps(ref))
    torch.distributed.barrier()
    # Every rank of the expert line holds all of the global batch's rows.
    batch = train.synthetic_batch(cfg, EP_B, EP_S, seed=0, mesh=mesh)
    for name, mutation in [("sound", None)] + [(m, m) for m in mutations]:
        shapes, undo_spy = tr_launch_spy()
        undo = ep_mutate(mutation)
        try:
            state, r = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, mesh=mesh),
                                  lambda: train.make_train_step(cfg, mesh), batch, mesh,
                                  EP_STEPS)
        finally:
            undo()
            undo_spy()
        r["kernel_shapes"] = {k: sorted(v) for k, v in shapes.items()}
        whole = sharding.unshard_tree(mesh, state.params)
        del state
        every = [None] * EP_RANKS
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, mutation=mutation, dtype=dtype, n_layers=cfg.n_layers,
                       **ep_compare(every[0], ref, EP_TOL[dtype]),
                       params=tr_param_gaps(whole, ref_params))
            out[name] = res
            log(f"phase 18 {name} ({dtype}, {cfg.n_layers} layers): " + json.dumps(res))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        out["unsharded"] = ref
    del batch
    return out


def ep_rank_main(rank: int, init: str) -> int:
    """One rank of phase 18, a process of its own: smol-moe at full width
    and EP_LAYERS layers on an expert axis of two gloo ranks sharing
    cuda:0 (each rank 4 of the 8 experts), einsum dispatch, bf16, against
    the unsharded steps on the same card, weights and batch; then at
    EP_F32_LAYERS in f32 with the mutants; then LoRA on wq/wv against the
    unsharded LoRA run, at EP_LAYERS and in f32 with the summed-over-expert
    mutant. Rank 0 prints its readings as one JSON line."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.init_ranks(EP_RANKS, rank, init, backend="gloo", device=EP_DEVICE)
    mesh = sharding.make_mesh([EP_DEVICE], layout="training", expert=EP_RANKS)
    cfg = PRESETS[EP_PRESET].with_(n_layers=EP_LAYERS)
    out = {"bf16": ep_run(cfg, rank, mesh, EP_DEVICE, ())}
    cfg32 = cfg.with_(n_layers=EP_F32_LAYERS, dtype="float32")
    out["f32"] = ep_run(cfg32, rank, mesh, EP_DEVICE, EP_MUTANTS)
    shape = (EP_B, EP_S, EP_STEPS)
    out["lora"] = {"bf16": lora_rank_run(cfg, rank, mesh, EP_DEVICE, LORA_TARGETS, shape, (),
                                         EP_LORA_TOL["bfloat16"]),
                   "f32": lora_rank_run(cfg32, rank, mesh, EP_DEVICE, LORA_TARGETS, shape,
                                        ("summed_over_expert",), EP_LORA_TOL["float32"])}
    out["serve"] = es_run(rank)
    if rank == 0:
        print("EP_RESULT " + json.dumps(out), flush=True)
    sharding.leave_ranks(mesh)
    return 0


def ep_gates(r: dict) -> dict:
    """Each of 18's (and 20's) gates on one case's readings: True where it
    passes; a run without a params reading (a phase-20 mutant's single
    step) has no params gate."""
    tol, p = r["tol"], r["params"]
    gates = {k: r[f"{k}_rel"] <= tol[k] for k in ("loss", "grad_norm", "router_aux")}
    if p is not None:
        gates["params"] = p["rel_l2"] <= tol["params"][0] and p["row_rel"] <= tol["params"][1]
    return gates


def check_expert_ranks(res: dict) -> None:
    """The gates of 18(a) and (b) on rank 0's readings: the sound run
    within every gate, each mutant failing the gate that guards it, the
    ranks' metrics equal, and #2-#4 launched once a layer a step on each
    rank at a rank's geometry (attention is replicated over expert)."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[EP_PRESET]
    shape = (EP_B * cfg.n_heads, EP_S, cfg.head_dim)
    if "lora" in res:
        check_lora_ranks(res["lora"], "18", shape)
    if "serve" in res:
        check_expert_serving(res["serve"])
    for dtype_tag, cases in res.items():
        if dtype_tag in ("lora", "serve"):
            continue
        for name, r in cases.items():
            if name == "unsharded":
                continue
            gates = ep_gates(r)
            if r["mutation"]:
                guard = EP_GUARDS[r["mutation"]]
                if gates[guard]:
                    raise AssertionError(f"phase 18 {name}: its {guard} gate passes the mutant"
                                         f" ({r}, tol {r['tol']})")
                continue
            if not all(gates.values()):
                raise AssertionError(f"phase 18 {name} {dtype_tag}: gates {gates}; loss"
                                     f" {r['loss_rel']}, grad_norm {r['grad_norm_rel']},"
                                     f" router_aux {r['router_aux_rel']}, params"
                                     f" {r['params']}; tol {r['tol']}")
            for rk, rr in enumerate(r["ranks"]):
                keys = ("loss", "grad_norm", "router_aux", "losses")
                if any(rr[k] != r["ranks"][0][k] for k in keys):
                    raise AssertionError(f"phase 18 {name}: rank {rk}'s metrics differ")
                want = float(r["n_layers"])
                got = {k: rr["launches_per_step"][k]
                       for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                if any(v != want for v in got.values()):
                    raise AssertionError(f"phase 18 {name} rank {rk}: flash launches per step"
                                         f" {got}, not {want}")
                if dtype_tag == "bf16":
                    shapes = {tuple(s) for v in rr["kernel_shapes"].values() for s in v}
                    if shapes != {shape}:
                        raise AssertionError(f"phase 18 {name} rank {rk}: kernel shapes"
                                             f" {rr['kernel_shapes']}, not {shape}")


def run_expert_parallel() -> dict:
    """Phase 18: (a) and (b) in two rank processes. The kernels at the
    ranks' geometry (B*H 32, S 2048, hd 128) are phase 17c's."""
    t0 = time.monotonic()
    res = launch_procs(["--ep-rank"], "phase18", EP_RANKS, "EP_RESULT", EP_TIMEOUT)
    check_expert_ranks(res)
    r, ref = res["bf16"]["sound"], res["bf16"]["unsharded"]
    r0 = r["ranks"][0]
    log(f"phase 18 (gloo, two expert ranks on one card: a check, not an expert-parallel"
        f" speed): step {[round(x['step_ms'][-1], 1) for x in r['ranks']]} ms against"
        f" unsharded {ref['step_ms'][-1]:.1f}; collectives per step"
        f" {r0['collectives_per_step']}, MB put in {r0['collective_mb_per_step']}, ms"
        f" {r0['collective_ms_by_kind']} (rank 0); peak"
        f" {[round(x['peak_mem_gb'], 2) for x in r['ranks']]} GB per rank (unsharded"
        f" {ref['peak_mem_gb']:.2f}); #2-#4 per rank a step"
        f" {r['ranks'][0]['launches_per_step']} at {r['ranks'][0]['kernel_shapes']}")
    for m in EP_MUTANTS:
        g = ep_gates(res["f32"][m])
        log(f"phase 18 mutant {m}: fails {[k for k, ok in g.items() if not ok]}, as its"
            f" {EP_GUARDS[m]} gate must")
    r, ref = res["lora"]["bf16"]["sound"], res["lora"]["bf16"]["unsharded"]
    log(f"phase 18 LoRA on {list(LORA_TARGETS)} over expert 2: step"
        f" {r['ranks'][0]['step_ms'][-1]:.1f} ms against unsharded {ref['step_ms'][-1]:.1f};"
        f" loss {r['loss_rel']:.3e}, grad_norm {r['grad_norm_rel']:.3e}, adapters"
        f" {r['params']}; peak {[round(x['peak_mem_gb'], 2) for x in r['ranks']]} GB per rank;"
        f" the summed-over-expert mutant's grad_norm"
        f" {res['lora']['f32']['summed_over_expert']['grad_norm_rel']:.3e}")
    log(f"phase 18: ranks {time.monotonic() - t0:.1f}s")
    return dict(ranks=res, seconds=time.monotonic() - t0)


# -- phase 19: the gang on the card ----------------------------------------------------

GANG_HOSTS = 2
# fine_tune across two "hosts", one rank each, sharing the card over gloo:
# phase 15's smol-1b at full width and depth, B 8 x 2048, fsdp 2 (a CPU dry
# run swaps in a small preset, "cpu" and a short batch).
GANG_PRESET, GANG_DEVICE = "smol-1b", "cuda:0"
GANG_B, GANG_S, GANG_STEPS = 8, 2048, 2
# Each process's limit (seconds).
GANG_TIMEOUT = 600
# run_rl's Sebulba gang: the learner and one actor, on the card (None).
GANG_RL_UPDATES, GANG_RL_DEVICE = 3, None
# What the orchestrator injects into every host of a gang.
GANG_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES")


def gang_argv(ckpt: str) -> list:
    """fine_tune's command in phase 19(a), the same on every host."""
    return ["--preset", GANG_PRESET, "--batch-size", str(GANG_B), "--seq-len", str(GANG_S),
            "--steps", str(GANG_STEPS), "--ranks", str(GANG_HOSTS), "--device", GANG_DEVICE,
            "--dist-backend", "gloo", "--checkpoint-dir", ckpt]


def gang_env(**extra) -> dict:
    """This process's environment less any gang, with the repo importable."""
    env = {k: v for k, v in os.environ.items() if k not in GANG_VARS}
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [x for x in [os.environ.get("PYTHONPATH")]
                                                  if x])
    return {**env, **extra}


def free_port(pair: bool = False) -> int:
    """A loopback port free right now (with the next one free too: `pair`)."""
    import socket

    while True:
        socks = [socket.socket() for _ in range(2 if pair else 1)]
        try:
            socks[0].bind(("127.0.0.1", 0))
            port = socks[0].getsockname()[1]
            if pair:
                socks[1].bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()


def start_logged(cmds, envs, tags) -> list:
    """Start each command with its environment and its output in
    chiprun_out/<tag>.log, all at once; returns [(process, log path,
    start time)] for `wait_logged`."""
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    started = []
    for cmd, env, tag in zip(cmds, envs, tags):
        path = f"chiprun_out/{tag}.log"
        with open(path, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                                    cwd=ROOT, start_new_session=True)
        started.append((proc, path, time.monotonic()))
    return started


def wait_logged(started, timeout: float) -> list:
    """Wait for `start_logged`'s processes (each killed `timeout` seconds
    after its start); returns each one's (exit code, output, seconds)."""
    ends = {}
    try:
        while len(ends) < len(started):
            for i, (proc, _, t0) in enumerate(started):
                if i in ends:
                    continue
                if proc.poll() is not None:
                    ends[i] = time.monotonic() - t0
                elif time.monotonic() - t0 > timeout:
                    os.killpg(proc.pid, 9)
                    proc.wait()
                    ends[i] = time.monotonic() - t0
            time.sleep(0.1)
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    return [(proc.returncode, open(path).read(), ends.get(i))
            for i, (proc, path, _) in enumerate(started)]


def gang_host_main(ft_argv) -> int:
    """One host of phase 19(a), a process of its own given its host's gang
    variables: fine_tune's main on `ft_argv`, each train step timed between
    synchronisations, the flash kernels' launches counted (zeroed just
    before, read just after) with their shapes; prints its readings as
    one JSON line."""
    from dstack_tpu_torch import fine_tune
    from dstack_tpu_torch.workloads import train

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    make, step_ms = train.make_train_step, []

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def timed(state, batch):
            sync()
            t0 = time.monotonic()
            out = step(state, batch)
            sync()
            step_ms.append((time.monotonic() - t0) * 1e3)
            return out

        return timed

    train.make_train_step = timed_make
    shapes, undo = tr_launch_spy()
    zero_flash_counts()
    fine_tune.main(list(ft_argv))
    launches = flash_counts()
    undo()
    r = dict(host=int(os.environ["JAX_PROCESS_ID"]), step_ms=step_ms, launches=launches,
             launches_per_step={k: v / max(len(step_ms), 1) for k, v in launches.items()},
             kernel_shapes={k: sorted(v) for k, v in shapes.items()},
             peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                          if torch.cuda.is_available() else 0.0))
    print("GANG_RESULT " + json.dumps(r), flush=True)
    return 0


def same_bytes(a: str, b: str, chunk: int = 64 << 20) -> bool:
    """Whether two files hold the same bytes."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def run_gang_fine_tune() -> dict:
    """19(a): `fine_tune --ranks 2` on one host (rank 0 starts rank 1),
    then the same command as a gang of two host processes given
    JAX_COORDINATOR_ADDRESS / JAX_PROCESS_ID / JAX_NUM_PROCESSES (each host
    one rank; `chip_smoke.py --gang-host`, which runs fine_tune's main and
    counts around it). Both runs' exports are compared byte for byte."""
    import shutil
    import tempfile

    base = tempfile.mkdtemp(prefix="phase19-")
    one, two = os.path.join(base, "one"), os.path.join(base, "two")
    try:
        [(code, text, one_s)] = wait_logged(start_logged(
            [[sys.executable, "-m", "dstack_tpu_torch.fine_tune", *gang_argv(one)]],
            [gang_env()], ["phase19_one_host"]), GANG_TIMEOUT)
        if code != 0:
            raise AssertionError(f"phase 19(a) one host exited {code}:\n{text[-4000:]}")
        # Only the export is compared: the one-host train state goes.
        for d in os.listdir(one):
            if d.isdigit():
                shutil.rmtree(os.path.join(one, d))
        port = free_port()
        hosts = wait_logged(start_logged(
            [[sys.executable, os.path.abspath(__file__), "--gang-host", *gang_argv(two)]
             for _ in range(GANG_HOSTS)],
            [gang_env(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_PROCESS_ID=str(h),
                      JAX_NUM_PROCESSES=str(GANG_HOSTS)) for h in range(GANG_HOSTS)],
            [f"phase19_host{h}" for h in range(GANG_HOSTS)]), GANG_TIMEOUT)
        for h, (code, out, _) in enumerate(hosts):
            if code != 0:
                raise AssertionError(f"phase 19(a) host {h} exited {code}:\n{out[-4000:]}")
            want = f"process {h}/{GANG_HOSTS} runs ranks {h}-{h} of {GANG_HOSTS}"
            if want not in out.splitlines():
                raise AssertionError(f"phase 19(a) host {h} did not print {want!r}")
        files = sorted(os.listdir(os.path.join(one, "packed")))
        equal = {f: same_bytes(os.path.join(one, "packed", f), os.path.join(two, "packed", f))
                 for f in files}
        equal["files"] = files == sorted(os.listdir(os.path.join(two, "packed")))
        res = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("GANG_RESULT "))[len("GANG_RESULT "):])
               for _, out, _ in hosts]
        return dict(export_equal=equal, hosts=res,
                    one_host_steps=[ln for ln in text.splitlines() if ln.startswith("step ")],
                    gang_steps=[ln for ln in hosts[0][1].splitlines()
                                if ln.startswith("step ")],
                    export_bytes=sum(os.path.getsize(os.path.join(two, "packed", f))
                                     for f in files),
                    seconds=dict(one_host=one_s, gang=max(s for _, _, s in hosts)))
    finally:
        shutil.rmtree(base, ignore_errors=True)


def start_gang_rl() -> list:
    """19(b): `run_rl --mode sebulba` as the learner and one actor
    (DSTACK_NODE_RANK 0 and 1 of DSTACK_NODES_NUM=2) on the card, their
    refresh address on loopback; `gang_rl_result` waits for them."""
    port = free_port(pair=True)  # the refresh server's and the sink's
    argv = [sys.executable, "-m", "dstack_tpu_torch.run_rl", "--mode", "sebulba",
            "--updates", str(GANG_RL_UPDATES), "--timeout", str(GANG_TIMEOUT),
            *(["--device", GANG_RL_DEVICE] if GANG_RL_DEVICE else [])]
    return start_logged(
        [argv, argv],
        [gang_env(DSTACK_NODE_RANK=str(n), DSTACK_NODES_NUM="2",
                  DSTACK_TPU_RL_REFRESH_ADDR=f"127.0.0.1:{port}") for n in range(2)],
        ["phase19_rl_learner", "phase19_rl_actor"])


def gang_rl_result(started) -> dict:
    nodes = wait_logged(started, GANG_TIMEOUT)
    for n, (code, out, _) in enumerate(nodes):
        if code != 0:
            raise AssertionError(f"phase 19(b) node {n} exited {code}:\n{out[-4000:]}")
    lines = nodes[0][1].splitlines()
    updates = [ln for ln in lines if ln.startswith("update ")]
    return dict(updates=updates, epochs=[int(ln.rsplit("epoch=", 1)[1]) for ln in updates],
                seconds=[s for _, _, s in nodes],
                metrics_block=any(ln.startswith("dstack_tpu_rl_env_steps_total")
                                  for ln in lines))


def check_gang(ft: dict, rl: dict) -> None:
    """The gates of phase 19: the gang's export equal to one host's byte for
    byte; on each host #2-#4 once a layer a step at a rank's geometry of
    fsdp 2; both hosts' step lines the one-host run's; the RL gang's epochs
    2..GANG_RL_UPDATES + 1 and its metrics block."""
    from dstack_tpu_torch.workloads.config import PRESETS

    if not all(ft["export_equal"].values()):
        raise AssertionError(f"phase 19(a): the gang's export differs from one host's:"
                             f" {ft['export_equal']}")
    if [ln.rsplit(" (", 1)[0] for ln in ft["gang_steps"]] != [
            ln.rsplit(" (", 1)[0] for ln in ft["one_host_steps"]]:
        raise AssertionError(f"phase 19(a): step lines {ft['gang_steps']} against one"
                             f" host's {ft['one_host_steps']}")
    cfg = PRESETS[GANG_PRESET]
    shape = [GANG_B * cfg.n_heads // GANG_HOSTS, GANG_S, cfg.head_dim]
    for r in ft["hosts"]:
        got = {k: r["launches_per_step"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                                     "flash_bwd_dkv")}
        if any(v != cfg.n_layers for v in got.values()) or len(r["step_ms"]) != GANG_STEPS:
            raise AssertionError(f"phase 19(a) host {r['host']}: flash launches per step"
                                 f" {got} over {len(r['step_ms'])} steps, not"
                                 f" {cfg.n_layers} over {GANG_STEPS}")
        shapes = {tuple(s) for v in r["kernel_shapes"].values() for s in v}
        if shapes != {tuple(shape)}:
            raise AssertionError(f"phase 19(a) host {r['host']}: kernel shapes"
                                 f" {r['kernel_shapes']}, not {shape}")
    if rl["epochs"] != list(range(2, GANG_RL_UPDATES + 2)) or not rl["metrics_block"]:
        raise AssertionError(f"phase 19(b): {rl['updates']}, metrics block"
                             f" {rl['metrics_block']}")


def run_gang() -> dict:
    """Phase 19: (b) run_rl's Sebulba learner and actor started first, (a)
    fine_tune on one host and as a gang of two host processes beside
    them, all on the card."""
    t0 = time.monotonic()
    rl = start_gang_rl()
    ft = run_gang_fine_tune()
    rl = gang_rl_result(rl)
    check_gang(ft, rl)
    log(f"phase 19(a) (gloo, two host processes of one rank each on one card: a check of"
        f" the rendezvous, not a speed): export {ft['export_bytes'] / 1e9:.3f} GB byte for"
        f" byte the one host's; step {[[round(x, 1) for x in r['step_ms']] for r in ft['hosts']]}"
        f" ms by host; peak {[round(r['peak_mem_gb'], 2) for r in ft['hosts']]} GB a rank;"
        f" #2-#4 a step {ft['hosts'][0]['launches_per_step']} at"
        f" {ft['hosts'][0]['kernel_shapes'].get('flash_fwd')}; one host"
        f" {ft['seconds']['one_host']:.1f}s (beside 19(b)), the gang {ft['seconds']['gang']:.1f}s")
    log(f"phase 19(b): {rl['updates']}; learner and actor {rl['seconds']} s")
    log(f"phase 19: {time.monotonic() - t0:.1f}s")
    return dict(fine_tune=ft, rl=rl, seconds=time.monotonic() - t0)


# -- LoRA over ranks (in phases 15 and 18) -----------------------------------------

# The targets of phase 15's LoRA cell: the two row-parallel weights ("model"
# on the input dim, "fsdp" on the output), whose factors a rank gathers.
LR_ROW_TARGETS = ("wo", "w_down")
# The gate each mutant must fail: the column targets' grads summed over the
# expert line double them; a row target's whole-factor grads summed over the
# column targets' axes miss the other model ranks' blocks of B. Adam's
# normalised step hides a doubled grad from the params, not from grad_norm.
LR_GUARDS = {"summed_over_expert": "grad_norm", "column_axes": "grad_norm"}


def lr_mutate(kind):
    """A fault of LoRA's grad sums over ranks. "summed_over_expert": the
    column targets' grads also summed over the expert line, each of whose
    ranks already holds the whole grad; "column_axes": a row target's
    whole-factor grads summed over the column targets' axes. Returns the
    undo."""
    from dstack_tpu_torch.workloads import lora

    if kind == "summed_over_expert":
        orig = lora._LORA_GRAD_AXES
        lora._LORA_GRAD_AXES = {k: v + ("expert",) for k, v in orig.items()}
        return lambda: setattr(lora, "_LORA_GRAD_AXES", orig)
    if kind == "column_axes":
        orig = lora._gathered_grad_axes
        lora._gathered_grad_axes = lambda spec, suffix: lora._LORA_GRAD_AXES[suffix]
        return lambda: setattr(lora, "_gathered_grad_axes", orig)
    return lambda: None


def lora_rank_run(cfg, rank, mesh, device, targets, shape, mutations, tol) -> dict:
    """Rank 0 runs the unsharded LoRA steps (the others wait), then every
    rank runs them on `mesh`, sound and with each of `mutations`; rank 0
    holds the whole adapters after them against the unsharded ones. As
    fine_tune: the base is init_params(seed 0), the rank-8 adapters come
    from seed 1, the batch is the synthetic one of seed 0 (`shape`: B, S
    and the steps)."""
    from dstack_tpu_torch.workloads import lora, sharding, train
    from dstack_tpu_torch.workloads.transformer import init_params
    from dstack_tpu_torch.workloads.weights import flatten_params

    B, S, n_steps = shape

    def steps(m, batch):
        base = sharding.shard_tree(m, init_params(cfg, seed=0, device=device))

        def make_step():
            step = lora.make_lora_train_step(cfg, m, rank=LORA_RANK)
            return lambda st, b: step(st, base, b)

        return rank_steps(cfg, lambda: lora.init_lora_state(
            cfg, base, 1, rank=LORA_RANK, targets=targets, mesh=m), make_step, batch, m, n_steps)

    out, ref, ref_lora = {}, None, None
    if rank == 0:
        state, ref = steps(None, train.synthetic_batch(cfg, B, S, seed=0, device=device))
        ref_lora = [(k, t.detach().to("cpu", copy=True)) for k, t in flatten_params(state.lora)]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        log(f"LoRA on {list(targets)} unsharded {cfg.dtype}: " + json.dumps(ref))
    torch.distributed.barrier()
    batch = train.synthetic_batch(cfg, B, S, seed=0, mesh=mesh)
    for mutation in (None, *mutations):
        shapes, undo_spy = tr_launch_spy()
        undo = lr_mutate(mutation)
        try:
            state, r = steps(mesh, batch)
        finally:
            undo()
            undo_spy()
        r["kernel_shapes"] = {k: sorted(v) for k, v in shapes.items()}
        whole = sharding.unshard_tree(mesh, state.lora)
        del state
        every = [None] * math.prod(mesh.shape.values())
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, mutation=mutation, dtype=cfg.dtype, n_layers=cfg.n_layers,
                       targets=list(targets), **tr_compare(every[0], ref, tol),
                       params=tr_param_gaps(whole, ref_lora))
            out[mutation or "sound"] = res
            log(f"LoRA on {list(targets)} over {mesh.shape} {mutation or 'sound'} ({cfg.dtype},"
                f" {cfg.n_layers} layers): " + json.dumps(res))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        out["unsharded"] = ref
    del batch
    return out


def lora_gates(r: dict) -> dict:
    """Each LoRA-over-ranks gate on one case's readings: True where it
    passes (the first step's loss and grad_norm, the adapters after the
    steps; a row_rel limit of None holds them by rel_l2 alone)."""
    tol, p = r["tol"], r["params"]
    rel_l2, row_rel = tol["params"]
    return {"loss": r["loss_rel"] <= tol["loss"], "grad_norm": r["grad_norm_rel"] <= tol["grad_norm"],
            "params": p["rel_l2"] <= rel_l2 and (row_rel is None or p["row_rel"] <= row_rel)}


def check_lora_ranks(res: dict, phase: str, shape) -> None:
    """The gates of a phase's LoRA cell on rank 0's readings: the sound
    run within every gate with the ranks' metrics equal and #2-#4 launched
    once a layer a step on each rank (#3 and #4 one fewer without a target
    before the first attention) at `shape` (B*H, S, hd) in bf16; each
    mutant failing the gate that guards it."""
    for dtype_tag, cases in res.items():
        for name, r in cases.items():
            if name == "unsharded":
                continue
            gates = lora_gates(r)
            if r["mutation"]:
                guard = LR_GUARDS[r["mutation"]]
                if gates[guard]:
                    raise AssertionError(f"phase {phase} LoRA {name}: its {guard} gate passes"
                                         f" the mutant ({r['grad_norm_rel']}, tol {r['tol']})")
                continue
            if not all(gates.values()):
                raise AssertionError(f"phase {phase} LoRA {dtype_tag}: gates {gates}; loss"
                                     f" {r['loss_rel']}, grad_norm {r['grad_norm_rel']}, params"
                                     f" {r['params']}; tol {r['tol']}")
            for rk, rr in enumerate(r["ranks"]):
                if [rr["loss"], rr["grad_norm"], rr["losses"]] != [
                        r["ranks"][0]["loss"], r["ranks"][0]["grad_norm"], r["ranks"][0]["losses"]]:
                    raise AssertionError(f"phase {phase} LoRA: rank {rk}'s metrics differ")
                # Autograd runs the first layer's attention backward only for
                # a target before it (wq, wk, wv); wo and w_down take their
                # grads after it.
                first = 1 if set(r["targets"]) & {"wq", "wk", "wv"} else 0
                want = {"flash_fwd": r["n_layers"], "flash_bwd_dq": r["n_layers"] - 1 + first,
                        "flash_bwd_dkv": r["n_layers"] - 1 + first}
                got = {k: rr["launches_per_step"][k] for k in want}
                if got != want:
                    raise AssertionError(f"phase {phase} LoRA rank {rk}: flash launches per"
                                         f" step {got}, not {want}")
                if dtype_tag == "bf16":
                    shapes = {tuple(s) for v in rr["kernel_shapes"].values() for s in v}
                    if shapes != {tuple(shape)}:
                        raise AssertionError(f"phase {phase} LoRA rank {rk}: kernel shapes"
                                             f" {rr['kernel_shapes']}, not {shape}")


# -- phase 20: MoE over a seq axis of ranks --------------------------------------------

MS_RANKS = 2
# The model and the one card both ranks share (a CPU dry run of the rank
# processes swaps in a small preset and "cpu").
MS_PRESET, MS_DEVICE = "smol-moe", "cuda:0"
# 13c's batch, B 2 x S 2048, at seq 2: each rank holds 1024 positions of
# each row, routed at the whole row's capacity (640 at the preset's cf
# 1.25, where choices drop). MS_STEPS steps for the sound run, one for a
# mutant (its guard reads the first step).
MS_B, MS_S, MS_STEPS = 2, 2048, 2
# The bf16 run's depth: 4 of smol-moe's 16 layers at full width. The grads'
# all-reduce over seq moves every grad through host memory (phase 16 spent
# ~94% of a ranked ring step there, on 1.78 GB); at 4 layers the grads are
# ~2.6 GB (1.29 B params), at 8 ~4.9 GB.
MS_LAYERS = 4
# The f32 check's depth, with the mutants.
MS_F32_LAYERS = 2
# Each rank process's limit (seconds): start-up, every case.
MS_TIMEOUT = 600
# The faults of the whole row's routing, each run after the sound ranks:
# the capacity from the rank's own stretch, the slots without the earlier
# seq ranks' picks, the slots without the earlier choices' picks. Each
# drops other choices than the reference (or puts two tokens in one slot),
# so the first step's loss moves.
MS_MUTANTS = ("local_capacity", "no_rank_prefix", "no_choice_offset")
MS_GUARDS = dict.fromkeys(MS_MUTANTS, "loss")
# (name, dtype, B*H, S, hd, causal) of kernel #5 on a seq rank: B 2 x 16
# heads, the rank's 1024 positions, the diagonal step causal.
MS_KERNEL_CASES = tuple((f"seq_rank_{part}_{tag}", dtype, MS_B * 16, MS_S // MS_RANKS, 128,
                         part == "diag")
                        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))
                        for part in ("full", "diag"))
# The seq ranks against the one-device seq-2 ring on one card (20a, 20b),
# per dtype: the first step's loss, grad_norm and router_aux by relative
# difference, every param after MS_STEPS steps by flash_errors' (rel_l2,
# row_rel) over its leaf. Each limit is ~3x the sound reading on the H100
# (PERF.md, phase 20); a reading of 0 gets ~3 f32 ulps. bf16: loss 1.39e-6
# (the dense products of 1024 rows round apart from 2048's), grad_norm
# 6.34e-4, router_aux 4.0e-7, params 2.06e-3 / 4.0e-2; f32 at 2 layers:
# loss 8.7e-8, grad_norm and aux 0, params 9.8e-6 / 2.75e-3. The mutants
# read loss 7.5e-4 (local capacity), 3.5e-5 (no rank prefix), 8.5e-4 (no
# choice offset).
MS_TOL = {"bfloat16": dict(loss=4.2e-6, grad_norm=1.9e-3, router_aux=1.2e-6,
                           params=(6.2e-3, 1.2e-1)),
          "float32": dict(loss=2.6e-7, grad_norm=3.6e-7, router_aux=3.6e-7,
                          params=(3e-5, 8.3e-3))}


def ms_mutate(kind):
    """20(b): a fault of a seq rank's routing (MS_MUTANTS). Returns the undo."""
    from dstack_tpu_torch.workloads import moe

    capacity, offsets = moe.row_capacity, moe.slot_offsets

    def local_capacity(c, s_local, mesh=None):
        return moe.expert_capacity(c, s_local)

    def no_rank_prefix(counts, mesh=None):
        earlier_ranks, earlier_choices = offsets(counts, mesh)
        return torch.zeros_like(earlier_ranks), earlier_choices

    def no_choice_offset(counts, mesh=None):
        earlier_ranks, earlier_choices = offsets(counts, mesh)
        return earlier_ranks, torch.zeros_like(earlier_choices)

    if kind == "local_capacity":
        moe.row_capacity = local_capacity
    elif kind in ("no_rank_prefix", "no_choice_offset"):
        moe.slot_offsets = no_rank_prefix if kind == "no_rank_prefix" else no_choice_offset

    def undo():
        moe.row_capacity, moe.slot_offsets = capacity, offsets

    return undo


def ms_run(cfg, rank, mesh, device, mutations) -> dict:
    """Rank 0 runs the one-device seq-2 ring (the others wait), recording
    its routing; then every rank runs the seq ranks with each layer pinned
    to that routing (the bf16 products of a rank's 1024 rows and of 2048
    round apart and flip top-k near-ties; the flips are counted), sound and
    with each of `mutations`; rank 0 holds its params against the
    one-device run's."""
    from dstack_tpu_torch.workloads import sharding, train

    ref = ref_params = pinned = None
    if rank == 0:
        one = sharding.Mesh(torch.device(device), dict(zip(sharding.AXES, (1, 1, MS_RANKS, 1, 1))))
        batch = train.synthetic_batch(cfg, MS_B, MS_S, seed=0, device=device)
        with RoutingSpy() as spy:
            state, ref = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, mesh=one),
                                    lambda: train.make_train_step(cfg, one), batch, None,
                                    MS_STEPS)
        ref.update(route_calls=len(spy.calls), dropped=[c[2] for c in spy.calls])
        pinned = [c[1].cpu() for c in spy.calls]
        ref_params = state_host(state)
        del state, batch, spy
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 20 one-device ring {cfg.dtype}: " + json.dumps(ref))
    pinned = sharding.broadcast_object(pinned, mesh)
    s_local = MS_S // MS_RANKS
    lo = mesh.coords["seq"] * s_local
    mine = [p[:, lo:lo + s_local] for p in pinned]
    out = {}
    batch = train.synthetic_batch(cfg, MS_B, MS_S, seed=0, mesh=mesh)
    for mutation in (None, *mutations):
        shapes, undo_spy = tr_launch_spy()
        undo = ms_mutate(mutation)
        try:
            with RoutingSpy(mine) as spy:
                state, r = rank_steps(cfg, lambda: train.init_train_state(cfg, seed=0, mesh=mesh),
                                      lambda: train.make_train_step(cfg, mesh), batch, mesh,
                                      MS_STEPS if mutation is None else 1)
        finally:
            undo()
            undo_spy()
        r.update(kernel_shapes={k: sorted(v) for k, v in shapes.items()},
                 digest=leaf_digest(state.params), route_calls=len(spy.calls),
                 flips=sum(spy.flips), dropped=[c[2] for c in spy.calls])
        every = [None] * MS_RANKS
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, mutation=mutation, dtype=cfg.dtype, n_layers=cfg.n_layers,
                       **ep_compare(every[0], ref, MS_TOL[cfg.dtype]),
                       params=None if mutation else tr_param_gaps(state.params, ref_params))
            out[mutation or "sound"] = res
            log(f"phase 20 {mutation or 'sound'} ({cfg.dtype}, {cfg.n_layers} layers): "
                + json.dumps(res))
        del state, spy
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        out["one_device"] = ref
    del batch
    return out


def ms_rank_main(rank: int, init: str) -> int:
    """One rank of phase 20, a process of its own: smol-moe at full width
    and MS_LAYERS layers on a seq axis of two gloo ranks sharing cuda:0
    (each rank 1024 positions of each row; the ring across the ranks),
    einsum dispatch, bf16, against the one-device seq-2 ring on the same
    card, weights and batch; then at MS_F32_LAYERS in f32 with the
    mutants. Rank 0 prints its readings as one JSON line."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.init_ranks(MS_RANKS, rank, init, backend="gloo", device=MS_DEVICE)
    mesh = sharding.make_mesh([MS_DEVICE], layout="training", seq=MS_RANKS)
    cfg = PRESETS[MS_PRESET].with_(n_layers=MS_LAYERS)
    out = {"bf16": ms_run(cfg, rank, mesh, MS_DEVICE, ())}
    cfg32 = cfg.with_(n_layers=MS_F32_LAYERS, dtype="float32")
    out["f32"] = ms_run(cfg32, rank, mesh, MS_DEVICE, MS_MUTANTS)
    if rank == 0:
        print("MS_RESULT " + json.dumps(out), flush=True)
    sharding.leave_ranks(mesh)
    return 0


def check_moe_seq_ranks(res: dict) -> None:
    """The gates of 20(a) and (b) on rank 0's readings: the one-device
    run dropped choices; the sound ranks within every gate, routed in as
    many calls as the one-device run, their metrics and params equal; each
    mutant failing the gate that guards it; kernel #5 launched i + 1 times
    a layer and forward on seq rank i at a rank's geometry and no other
    flash kernel (the ranked ring's backward is plain), 2n - 1 hops and
    one all-gather of the routing counts a layer."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[MS_PRESET]
    shape = [MS_B * cfg.n_heads, MS_S // MS_RANKS, cfg.head_dim]
    for dtype_tag, cases in res.items():
        ref = cases["one_device"]
        if not sum(ref["dropped"]) > 0:
            raise AssertionError(f"phase 20 {dtype_tag}: the one-device run dropped no"
                                 f" choice ({ref['dropped']}): capacity decides nothing")
        for name, r in cases.items():
            if name == "one_device":
                continue
            gates = ep_gates(r)
            if r["mutation"]:
                guard = MS_GUARDS[r["mutation"]]
                if gates[guard]:
                    raise AssertionError(f"phase 20 {name}: its {guard} gate passes the mutant"
                                         f" ({r['loss_rel']}, tol {r['tol']})")
                continue
            if not all(gates.values()):
                raise AssertionError(f"phase 20 {dtype_tag}: gates {gates}; loss {r['loss_rel']},"
                                     f" grad_norm {r['grad_norm_rel']}, router_aux"
                                     f" {r['router_aux_rel']}, params {r['params']}; tol"
                                     f" {r['tol']}")
            first = r["ranks"][0]
            for rk, rr in enumerate(r["ranks"]):
                keys = ("loss", "grad_norm", "router_aux", "losses", "digest")
                if any(rr[k] != first[k] for k in keys):
                    raise AssertionError(f"phase 20: rank {rk}'s metrics or params differ")
                if rr["route_calls"] != ref["route_calls"]:
                    raise AssertionError(f"phase 20 rank {rk}: {rr['route_calls']} routed calls,"
                                         f" the one-device run {ref['route_calls']}")
                want = dict.fromkeys(FLASH_REPLACES, 0.0)
                want["flash_block_fwd"] = float((rk + 1) * r["n_layers"])
                if rr["launches_per_step"] != want:
                    raise AssertionError(f"phase 20 rank {rk}: launches per step"
                                         f" {rr['launches_per_step']}, not {want}")
                hops = float(r["n_layers"] * (2 * MS_RANKS - 1))
                gathers = float(r["n_layers"])
                if (rr["hops_per_step"], rr["collectives_per_step"]["all_gathers"]) != (
                        hops, gathers):
                    raise AssertionError(f"phase 20 rank {rk}: {rr['hops_per_step']} hops and"
                                         f" {rr['collectives_per_step']['all_gathers']}"
                                         f" all-gathers a step, not {hops} and {gathers}")
                if dtype_tag == "bf16" and rr["kernel_shapes"] != {"flash_block_fwd": [shape]}:
                    raise AssertionError(f"phase 20 rank {rk}: kernel shapes"
                                         f" {rr['kernel_shapes']}, not {shape}")


def run_moe_seq_ranks() -> dict:
    """Phase 20: (c) kernel #5 against its plain version at a seq rank's
    geometry (B*H 32, S 1024, hd 128), timed; (a, b, d) in two rank
    processes over gloo on the card."""
    t0 = time.monotonic()
    kernels = run_ring_block(cases=MS_KERNEL_CASES)
    res = launch_procs(["--ms-rank"], "phase20", MS_RANKS, "MS_RESULT", MS_TIMEOUT)
    check_moe_seq_ranks(res)
    r, ref = res["bf16"]["sound"], res["bf16"]["one_device"]
    r0 = r["ranks"][0]
    log(f"phase 20 (gloo, two seq ranks on one card: a check, not a parallel speed): step"
        f" {[round(x['step_ms'][-1], 1) for x in r['ranks']]} ms against the one-device"
        f" ring's {ref['step_ms'][-1]:.1f}; hops per step {r0['hops_per_step']}"
        f" ({r0['hop_mb_per_step']:.1f} MB, {r0['hop_ms_per_step']:.1f} ms), collectives"
        f" {r0['collectives_per_step']} ({r0['collective_ms_per_step']:.1f} ms, MB"
        f" {r0['collective_mb_per_step']}); peak {[round(x['peak_mem_gb'], 2) for x in r['ranks']]}"
        f" GB per rank (one device {ref['peak_mem_gb']:.2f}); #5 per step"
        f" {[x['launches_per_step']['flash_block_fwd'] for x in r['ranks']]}; dropped choices"
        f" {ref['dropped']} of {MS_B * MS_S * 2} a layer; flips under the pin"
        f" {[x['flips'] for x in r['ranks']]}")
    for m in MS_MUTANTS:
        g = ep_gates(res["f32"][m])
        log(f"phase 20 mutant {m}: fails {[k for k, ok in g.items() if not ok]}, as its"
            f" {MS_GUARDS[m]} gate must (loss {res['f32'][m]['loss_rel']:.3e})")
    log(f"phase 20: {time.monotonic() - t0:.1f}s")
    return dict(kernels=kernels, ranks=res, seconds=time.monotonic() - t0)


# -- 15(h), 14(g), 18(c): RL over meshes of ranks, the expert axis on a serving mesh -----

# 15(h): the PPO learner on phase 15's two training ranks, smol-1b at full
# width and 8 of its 16 layers, bf16, fsdp 2 and model 2, on
# 12(a)'s RL batch (8 x 128: 64 prompt + 64 generated tokens), RLR_STEPS
# updates, against the one-device learner on the same card, weights and
# batch; then at RLR_F32_LAYERS in f32 with the mutants. entropy_coef above
# 0 so the entropy's grads reach every param.
RLR_LAYERS, RLR_F32_LAYERS, RLR_STEPS = 8, 2, 2
RLR_ENTROPY = 0.01
RLR_CASES = (("fsdp2", "fsdp2", None), ("model2", "model2", None))
# (mutant, layout, the gate it must fail): the entropy from a rank's vocab
# columns alone, each rank's own mask count for the global one, grads not
# summed over the batch axes (the norms' and the router's, on fsdp 2). A
# mutant takes one update, its params held against the one-device
# learner's after its first.
RLR_MUTANTS = (("entropy_local", "model2", "loss"), ("count_local", "fsdp2", "loss"),
               ("grads_unsummed", "fsdp2", "params"))
# The learner over ranks against the one-device learner, per (dtype,
# layout): the first update's loss by relative difference and every param
# after RLR_STEPS updates by flash_errors' (rel_l2, row_rel) over its leaf.
# The first update is on-policy, so its pg_loss is a sum of advantages that
# cancels to ~0 and the loss is mostly -entropy_coef x entropy; on model 2
# in bf16 the pg_loss carries the ratio's noise (the ranks' bf16 partial
# sums move a token's log-prob by a few 1e-2, times its advantage). Each
# limit is ~3x the sound reading on the H100 (PERF.md, PR 19): bf16 fsdp 2
# loss 3.0e-7, params 8.3e-4 / 1.23e-2; model 2 loss 2.76e-2, params
# 2.45e-3 / 1.32e-2; f32 at 2 layers loss 3.8e-7 (fsdp 2) and 7.5e-7
# (model 2), params 5.1e-6 / 1.84e-3. The mutants read loss 7.0e-2
# (entropy_local) and 1.0 (count_local), params 1.56e-4 (grads_unsummed).
RLR_TOL = {("bfloat16", "fsdp2"): dict(loss=1e-6, params=(2.5e-3, 3.7e-2)),
           ("bfloat16", "model2"): dict(loss=8.3e-2, params=(7.4e-3, 4e-2)),
           ("float32", "fsdp2"): dict(loss=1.2e-6, params=(1.5e-5, 5.5e-3)),
           ("float32", "model2"): dict(loss=2.3e-6, params=(1.5e-5, 5.5e-3))}


def rlr_mutate(kind):
    """15(h)'s faults of the learner over ranks (RLR_MUTANTS). Returns the
    undo."""
    from dstack_tpu_torch.workloads import rl, train

    real = rl.token_entropy, rl.mask_count, rl.reduce_grads

    def undo():
        rl.token_entropy, rl.mask_count, rl.reduce_grads = real

    if kind == "entropy_local":
        rl.token_entropy = lambda logits, mesh=None: train.token_entropy(logits, None)
    elif kind == "count_local":
        rl.mask_count = lambda mask, mesh=None: real[1](mask, None)
    elif kind == "grads_unsummed":
        rl.reduce_grads = lambda grads, mesh, axes_of: real[2](
            grads, mesh, lambda k: tuple(a for a in axes_of(k) if a not in ("data", "fsdp")))
    return undo


def rlr_trajectory(cfg, device):
    """15(h)'s trajectory batch: 12(a)'s RL batch shape from seed 2
    (rl_model_batch's tokens and episode ends), a reward on a fifth of the
    generated tokens, the behavior log-probs the one-device scorer's at
    the learner's initial weights (seed 0)."""
    import numpy as np

    from dstack_tpu_torch.workloads import rl
    from dstack_tpu_torch.workloads.transformer import init_params

    P = RL_ENV["prompt_len"]
    b = rl_model_batch(cfg, RL_BATCH, P, RL_ENV["horizon"], 2, device)
    logp = rl.make_sequence_scorer(cfg)(init_params(cfg, 0, device), b["tokens"], 1.0)
    g = torch.Generator().manual_seed(3)
    mask = b["mask"].cpu().numpy()
    rewards = (torch.rand(mask.shape, generator=g) < 0.2).float().numpy() * mask
    tokens = b["tokens"].cpu().numpy().astype(np.int32)
    return rl.TrajectoryBatch(tokens=tokens, actions=tokens[:, P:],
                              behavior_logprob=logp[:, P - 1:].float().cpu().numpy(),
                              rewards=rewards, mask=mask, prompt_len=P, actor_id=0,
                              weight_epoch=0)


def rlr_learn(cfg, mesh, device, tb, rank, publish=False, steps=RLR_STEPS, first=None):
    """`steps` updates of an RL Learner (on `mesh`, or one device) from
    seed 0's params on `tb` (rank 0 ingests it, the ranks step on their
    rows of its broadcast): the first update's metrics, each update's wall
    ms, flash launches per update, collectives, peak memory. With `publish`
    every rank then publishes through rank 0's in-process channel, and
    rank 0 holds the frame against the unshard of the ranks' slices, leaf
    for leaf. `first` (a list) receives host copies of the whole params
    after the first update. Returns (the whole params, readings)."""
    from dstack_tpu_torch.workloads import rl
    from dstack_tpu_torch.workloads.transformer import init_params

    torch.cuda.reset_peak_memory_stats()
    pub = rl.InProcessWeightRefresh() if publish and rank == 0 else None
    learner = rl.Learner(cfg, mesh=mesh, params=init_params(cfg, 0, device),
                         learning_rate=RL_LR, clip_eps=RL_CLIP, entropy_coef=RLR_ENTROPY,
                         refresh=pub, device=None if mesh else device)
    stats0 = dict(mesh.stats) if mesh else {}
    zero_flash_counts()
    metrics, step_ms = [], []
    for _ in range(steps):
        if rank == 0:
            learner.ingest(tb)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        metrics.append(learner.update_once(timeout=120))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        if first is not None and not first:
            first.extend(state_host(learner.state))
    r = dict(loss=metrics[0]["loss"], first={k: metrics[0][k] for k in rl.METRIC_KEYS},
             losses=[m["loss"] for m in metrics],
             step_ms=step_ms,
             launches_per_step={k: v / steps for k, v in flash_counts().items()},
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if mesh:
        delta = {k: mesh.stats[k] - stats0[k] for k in mesh.stats}
        r["collectives_per_step"] = {k: v / steps for k, v in delta.items()
                                     if not k.endswith("seconds") and not k.endswith("bytes")}
        r["collective_ms_per_step"] = sum(v for k, v in delta.items()
                                          if k.endswith("seconds")) * 1e3 / steps
    whole = learner.whole_params()
    if publish:
        t0 = time.monotonic()
        epoch = learner.publish()
        if rank == 0:
            frame, named = pub.poll(0)[1], rl.named_params(whole)
            r["publish"] = dict(epoch=epoch, seconds=time.monotonic() - t0,
                                leaves=len(frame), equal=[n for n, _ in named] == list(frame)
                                and all(frame[n].dtype == t.dtype and torch.equal(frame[n], t)
                                        for n, t in named))
    del learner
    return whole, r


def rlr_run(cfg, rank, meshes, device, cases) -> dict:
    """15(h) at one dtype: rank 0 runs the one-device learner (rank 1
    waits), then both ranks run each case on its layout; rank 0 holds the
    whole params against the one-device ones."""
    from dstack_tpu_torch.workloads.weights import flatten_params

    out, ref, ref_params, tb, ref_first = {}, None, None, None, []
    if rank == 0:
        tb = rlr_trajectory(cfg, device)
        whole, ref = rlr_learn(cfg, None, device, tb, 0, first=ref_first)
        ref_params = [(k, t.detach().to("cpu", copy=True)) for k, t in flatten_params(whole)]
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        log(f"15(h) one-device learner {cfg.dtype}: " + json.dumps(ref))
    torch.distributed.barrier()
    for name, layout, mutation in cases:
        shapes, undo_spy = tr_launch_spy()
        undo = rlr_mutate(mutation)
        try:
            whole, r = rlr_learn(cfg, meshes[layout], device, tb, rank,
                                 publish=mutation is None,
                                 steps=1 if mutation else RLR_STEPS)
        finally:
            undo()
            undo_spy()
        r["kernel_shapes"] = {k: sorted(v) for k, v in shapes.items()}
        every = [None] * TR_RANKS
        torch.distributed.all_gather_object(every, r)
        if rank == 0:
            res = dict(ranks=every, layout=layout, mutation=mutation, dtype=cfg.dtype,
                       n_layers=cfg.n_layers, tol=RLR_TOL[(cfg.dtype, layout)],
                       loss_rel=abs(every[0]["loss"] - ref["loss"]) / abs(ref["loss"]),
                       params=tr_param_gaps(whole, ref_first if mutation else ref_params))
            out[name] = res
            log(f"15(h) {name} ({cfg.dtype}, {cfg.n_layers} layers): " + json.dumps(res))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        out["unsharded"] = ref
    return out


def rlr_gates(r: dict) -> dict:
    """15(h)'s gates on one case's readings: True where it passes."""
    tol, p = r["tol"], r["params"]
    return {"loss": r["loss_rel"] <= tol["loss"],
            "params": p["rel_l2"] <= tol["params"][0] and p["row_rel"] <= tol["params"][1]}


def check_rl_ranks(res: dict) -> None:
    """15(h)'s gates on rank 0's readings: each sound case within its
    gates, the ranks' metrics equal, the published frame the unshard of
    the ranks' slices leaf for leaf, #2-#4 once a layer an update on each
    rank at a rank's geometry (B*H 64, S 127: 4 rows x 16 heads or 8 x 8);
    each mutant failing its gate."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[TR_PRESET]
    P, H = RL_ENV["prompt_len"], RL_ENV["horizon"]
    shape = (RL_BATCH * cfg.n_heads // TR_RANKS, P + H - 1, cfg.head_dim)
    guards = {m: g for m, _, g in RLR_MUTANTS}
    for dtype_tag, cases in res.items():
        for name, r in cases.items():
            if name == "unsharded":
                continue
            gates = rlr_gates(r)
            if r["mutation"]:
                if gates[guards[r["mutation"]]]:
                    raise AssertionError(f"15(h) {name}: its {guards[r['mutation']]} gate"
                                         f" passes the mutant ({r})")
                continue
            if not all(gates.values()):
                raise AssertionError(f"15(h) {name} {dtype_tag}: gates {gates}; loss"
                                     f" {r['loss_rel']}, params {r['params']}; tol {r['tol']}")
            pub = r["ranks"][0]["publish"]
            if not (pub["equal"] and pub["epoch"] == 1):
                raise AssertionError(f"15(h) {name}: the published frame is not the ranks'"
                                     f" whole params: {pub}")
            for rk, rr in enumerate(r["ranks"]):
                if rr["first"] != r["ranks"][0]["first"]:
                    raise AssertionError(f"15(h) {name}: rank {rk}'s metrics differ")
                got = {k: rr["launches_per_step"][k]
                       for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                if any(v != r["n_layers"] for v in got.values()):
                    raise AssertionError(f"15(h) {name} rank {rk}: flash launches per update"
                                         f" {got}, not {r['n_layers']}")
                if dtype_tag == "bf16":
                    shapes = {tuple(s) for v in rr["kernel_shapes"].values() for s in v}
                    if shapes != {shape}:
                        raise AssertionError(f"15(h) {name} rank {rk}: kernel shapes"
                                             f" {rr['kernel_shapes']}, not {shape}")


# 14(g): the RL actor on phase 14's model-2 serving mesh, smol-1b at 8
# layers: in f32 one round of RL_BATCH episodes (64-token prompts x 64 new
# tokens, temperature 1) against the one-device actor's round, token for
# token, its behavior log-probs (the engine's score op, each rank on its
# shards) against the one-device scorer's; in bf16 the mesh scorer on the
# same tokens against the one-device scorer's (RL_LOGP_TOL), then an
# adopted frame (seed 1's weights) in every rank's slices by sha1, shown
# failing a refresh that only the leader's slices take.
TA_LAYERS = 8
# The score op's log-probs against the one-device scorer's (max abs): f32
# ~3x the H100's reading (9.5e-6: the rank's column products round apart
# from the whole ones'), bf16 phase 12's RL_LOGP_TOL (the reading was 0).
TA_LOGP_TOL = {"float32": 3e-5, "bfloat16": RL_LOGP_TOL[torch.bfloat16]}


def ta_counts(serving, pa):
    """An op of the smoke's own (`_op_ta_zero`) that zeroes the paged and
    flash launch counts on every rank at one point of the op stream, and
    the leader's admission gate as it stood at each release (no request
    admitted, the round's all pending). Returns (held, undo)."""
    cls = serving.ServingEngine
    real_release = cls.release_admission
    held = []

    def zero(self):
        pa.LAUNCHES["ragged_paged_attention"] = 0
        zero_flash_counts()

    def release(self):
        st = self.stats()
        held.append(st["active"] == 0 and st["pending"] == RL_BATCH)
        return real_release(self)

    cls._op_ta_zero, cls.release_admission = zero, release

    def undo():
        del cls._op_ta_zero
        cls.release_admission = real_release
    return held, undo


def ta_actor(cfg, params, env, mesh, rank, tokens=None, frame=None,
             leader_only=False) -> dict:
    """One mesh actor (rank 0: rl.Actor on the mesh, rank 1: its
    follower): a round when given neither `tokens` nor `frame`; else the
    score op on `tokens` and/or an adoption of `frame` through rank 0's
    in-process channel. Each rank's launches and, after an adoption,
    whether its slices' sha1 digests are the frame's slices'."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads import rl, serving, sharding
    from dstack_tpu_torch.workloads.weights import flatten_params

    held, undo = ta_counts(serving, pa)
    real_refresh = serving.ServingEngine._op_refresh
    if leader_only and rank:
        serving.ServingEngine._op_refresh = lambda self, params: None
    kw = dict(batch_size=RL_BATCH, temperature=1.0, seed=0)
    r = {}
    try:
        if rank:
            eng = rl.run_actor_follower(cfg, params, env, mesh=mesh, **kw)
        else:
            pub = rl.InProcessWeightRefresh()
            actor = rl.Actor(cfg, params, env, refresh=pub, engine_kwargs={"mesh": mesh}, **kw)
            try:
                actor.engine._op("ta_zero")
                if tokens is None and frame is None:
                    t0 = time.monotonic()
                    b = actor.rollout(0)
                    r.update(tokens=b.tokens, logp=b.behavior_logprob, held=held,
                             round_s=time.monotonic() - t0)
                if tokens is not None:
                    logp = actor.engine.score(tokens, 1.0)
                    r["logp"] = logp[:, env.prompt_len - 1:].cpu().numpy()
                if frame is not None:
                    pub.publish(frame)
                    if not actor.maybe_refresh():
                        raise AssertionError("14(g): the mesh actor adopted no frame")
            finally:
                actor.close()
            eng = actor.engine
        r.update(launches=pa.LAUNCHES["ragged_paged_attention"], flash=flash_counts(),
                 heads=int(eng.params["layers"]["wq"].shape[-1] // cfg.head_dim))
        if frame is not None:
            want = leaf_digests(flatten_params(sharding.rank_params(mesh, frame)))
            r["adopted"] = leaf_digests(flatten_params(eng.params)) == want
        del eng
    finally:
        serving.ServingEngine._op_refresh = real_refresh
        undo()
    return r


def ta_run(rank, mesh) -> dict:
    """14(g) on both ranks; rank 0 returns the readings."""
    import numpy as np

    from dstack_tpu_torch.workloads import rl, sharding
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    P = RL_ENV["prompt_len"]
    out, tokens = {}, None
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        cfg = PRESETS[TP_PRESET].with_(dtype=dtype, n_layers=TA_LAYERS)
        params = init_params(cfg, seed=0, device=TP_DEVICE)
        env = rl.TargetTokenEnv(cfg.vocab_size, **RL_ENV, seed=0)
        frame = init_params(cfg, seed=1, device=TP_DEVICE) if tag == "bf16" else None
        t0 = time.monotonic()
        if tag == "f32":
            got = ta_actor(cfg, params, env, mesh, rank)
            tokens = sharding.broadcast_object(got.get("tokens"), mesh)
        else:
            got = ta_actor(cfg, params, env, mesh, rank, tokens=tokens, frame=frame)
        mesh_s = time.monotonic() - t0
        res = None
        if rank == 0:
            ref_logp = rl.make_sequence_scorer(cfg)(
                params, torch.from_numpy(tokens).to(TP_DEVICE), 1.0)[:, P - 1:]
            res = dict(mesh_s=mesh_s, logp_tol=TA_LOGP_TOL[dtype],
                       logp_max_abs=float((torch.from_numpy(got["logp"]) - ref_logp.cpu())
                                          .abs().max()))
            if tag == "f32":
                one = rl.Actor(cfg, params, env, batch_size=RL_BATCH, temperature=1.0, seed=0,
                               device=TP_DEVICE)
                try:
                    b = one.rollout(0)
                finally:
                    one.close()
                res.update(round_s=got["round_s"], held=got["held"],
                           tokens_equal=bool(np.array_equal(b.tokens, tokens)),
                           tokens_equal_rows=int((b.tokens == tokens).all(1).sum()),
                           logp_vs_actor=float(np.abs(b.behavior_logprob - got["logp"]).max()))
                del one
        every = [None] * TP_RANKS
        torch.distributed.all_gather_object(
            every, {k: got[k] for k in ("launches", "flash", "heads", "adopted") if k in got})
        if tag == "bf16":
            mutant = ta_actor(cfg, params, env, mesh, rank, frame=frame, leader_only=True)
            both = [None] * TP_RANKS
            torch.distributed.all_gather_object(both, mutant["adopted"])
            if rank == 0:
                res["adopted"] = [e["adopted"] for e in every]
                res["adopted_leader_only"] = both
        if rank == 0:
            res["ranks"] = every
            out[tag] = res
            log(f"14(g) actor on model 2 ({dtype}, {TA_LAYERS} layers): " + json.dumps(res))
        del params, frame
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_tp_actor(res: dict) -> None:
    """14(g)'s gates on rank 0's readings: the f32 round's tokens the
    one-device actor's with the leader's gate held over it and a paged
    launch on every rank; the score op's log-probs within RL_LOGP_TOL of
    the one-device scorer's, one #2 launch a layer on each rank, at a
    rank's heads; the adoption by sha1 on both ranks, failing rank 1 when
    only the leader refreshes."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[TP_PRESET]
    for tag, r in res.items():
        if not r["logp_max_abs"] <= r["logp_tol"]:
            raise AssertionError(f"14(g) {tag}: log-probs {r['logp_max_abs']} past"
                                 f" {r['logp_tol']}")
        for rk, rr in enumerate(r["ranks"]):
            if rr["flash"]["flash_fwd"] != TA_LAYERS or (tag == "f32" and rr["launches"] <= 0):
                raise AssertionError(f"14(g) {tag} rank {rk}: #1 launched {rr['launches']},"
                                     f" #2 {rr['flash']['flash_fwd']} (the score op: one a"
                                     f" layer)")
            if rr["heads"] != cfg.n_heads // TP_RANKS:
                raise AssertionError(f"14(g) {tag} rank {rk}: {rr['heads']} q heads")
    f = res["f32"]
    if not (f["tokens_equal"] and f["held"] == [True]):
        raise AssertionError(f"14(g): the f32 mesh round against the one-device actor's:"
                             f" {f['tokens_equal_rows']} rows equal, admission held {f['held']}")
    b = res["bf16"]
    if b["adopted"] != [True, True] or b["adopted_leader_only"] != [True, False]:
        raise AssertionError(f"14(g): adoption by sha1 {b['adopted']}, and with the leader"
                             f" alone refreshing {b['adopted_leader_only']} (must fail rank 1)")


# 18(c): phase 18's two ranks serve smol-moe at 8 layers on an expert-2
# serving mesh (each rank 4 of the 8 experts, all 16 heads), phase 4's
# requests at the all-admitting cf (E/k = 4.0), against the unsharded
# engine on the same card: f32 streams token for token, bf16 streams token
# for token with every routed call pinned to the unsharded engine's
# routing (RoutingSpy, flips under the pin counted), the f32 streams
# changed by the two ranks' expert blocks swapped in the outputs' gather,
# and the paged kernel once a layer a decode step on each rank.
ES_LAYERS, ES_NEW = 8, 32
ES_KW = dict(slots=8, steps_per_sync=4, prefill_chunk_tokens=128, kv_block_size=16)


def es_swap_blocks():
    """18(c)'s mutant: the experts' outputs gathered in reverse rank order
    on the serving mesh. Returns the undo."""
    from dstack_tpu_torch.workloads import moe, sharding

    real = moe.gather_experts

    def swapped(x, dim, mesh=None):
        out = real(x, dim, mesh)
        if not sharding.serves_experts(mesh):
            return out
        return torch.cat(out.chunk(mesh.shape["expert"], dim)[::-1], dim)

    moe.gather_experts = swapped
    return lambda: setattr(moe, "gather_experts", real)


def es_wave(eng, prompts) -> list:
    """Phase 4's requests on a warm engine in a fixed order of programs:
    the first alone, then the other 7 admitted as one wave."""
    first = drain(eng.submit(prompts[0], max_new_tokens=ES_NEW, temperature=0.0))[0]
    eng.hold_admission()
    outs = [eng.submit(p, max_new_tokens=ES_NEW, temperature=0.0) for p in prompts[1:]]
    eng.release_admission()
    return [first] + [drain(q)[0] for q in outs]


def es_serve(cfg, params, mesh, rank, pinned=None) -> dict:
    """One engine's run (on `mesh`, its follower on rank 1; or one
    device): warmup and es_wave, the routed calls recorded (or pinned),
    the paged launches per decode step."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads import serving

    counts, undo = tp_count_ops(serving, pa, mesh) if mesh else (None, lambda: None)
    r = {}
    try:
        with RoutingSpy(pinned) as spy:
            if mesh is not None and rank:
                eng = serving.run_follower(mesh, cfg, params, **ES_KW)
            else:
                eng = serving.ServingEngine(cfg, params, mesh=mesh,
                                            device=None if mesh else EP_DEVICE, **ES_KW)
                try:
                    eng.warmup()
                    if mesh is not None:
                        eng._op("tp_zero_counts")
                    t0 = time.monotonic()
                    r["streams"] = es_wave(eng, engine_prompts())
                    r["wave_s"] = time.monotonic() - t0
                finally:
                    eng.close()
        r.update(routing=[idx.cpu() for _, idx, _ in spy.calls], flips=sum(spy.flips),
                 heads=int(eng.params["layers"]["wq"].shape[-1] // cfg.head_dim))
        if counts is not None:
            r["launches"] = pa.LAUNCHES["ragged_paged_attention"]
            r["per_step"] = sorted(set(counts["per_step"]))
            r["decode_ops"] = counts["decode_ops"]
        del eng
    finally:
        undo()
    return r


def es_run(rank) -> dict:
    """18(c) on both ranks; rank 0 returns the readings."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    mesh = sharding.make_mesh([EP_DEVICE], expert=EP_RANKS)  # the serving layout
    base = PRESETS[EP_PRESET].with_(n_layers=ES_LAYERS)
    base = base.with_(capacity_factor=moe_cf_all(base))
    out = {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        cfg = base.with_(dtype=dtype)
        params = init_params(cfg, seed=0, device=EP_DEVICE)
        ref = None
        if rank == 0:
            ref = es_serve(cfg, params, None, 0)
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
        pinned = None
        if tag == "bf16":
            pinned = sharding.broadcast_object(ref["routing"] if rank == 0 else None, mesh)
        got = es_serve(cfg, params, mesh, rank, pinned)
        runs = {"sound": got}
        if tag == "f32":
            undo = es_swap_blocks()
            try:
                runs["swapped"] = es_serve(cfg, params, mesh, rank)
            finally:
                undo()
        every = [None] * EP_RANKS
        torch.distributed.all_gather_object(every, {
            name: {k: r[k] for k in ("launches", "per_step", "decode_ops", "heads", "flips")}
            for name, r in runs.items()})
        if rank == 0:
            res = {"ranks": every, "routed_calls": len(ref["routing"]),
                   "unsharded_wave_s": ref["wave_s"], "wave_s": got["wave_s"]}
            for name, r in runs.items():
                res[name] = dict(equal=r["streams"] == ref["streams"],
                                 equal_streams=sum(a == b for a, b in zip(r["streams"],
                                                                          ref["streams"])),
                                 token_counts=[len(s) for s in r["streams"]])
            out[tag] = res
            log(f"18(c) expert-2 serving ({dtype}, {ES_LAYERS} layers): " + json.dumps(res))
        del params, got, runs, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_expert_serving(res: dict) -> None:
    """18(c)'s gates on rank 0's readings."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS[EP_PRESET]
    for tag, r in res.items():
        if not (r["sound"]["equal"] and r["sound"]["token_counts"] == [ES_NEW] * 8):
            raise AssertionError(f"18(c) {tag}: streams {r['sound']}")
        if tag == "f32" and r["swapped"]["equal"]:
            raise AssertionError("18(c): the swapped expert blocks give the same streams")
        for rk, rr in enumerate(r["ranks"]):
            s = rr["sound"]
            if s["per_step"] != [ES_LAYERS] or s["decode_ops"] <= 0:
                raise AssertionError(f"18(c) {tag} rank {rk}: launches per decode step"
                                     f" {s['per_step']}, not {ES_LAYERS}")
            if s["heads"] != cfg.n_heads:
                raise AssertionError(f"18(c) {tag} rank {rk}: {s['heads']} q heads, not all")


def paged_entry(kres, launches, wave, crossover) -> dict:
    """The paged kernel's entry of the `kernels` line: the bf16 decode
    case's times, the bf16 short-slot decode and chunk cases' beside them,
    the cells' prompt chunks through the prefill kernel and the crossover
    sweep, the largest readings over the bf16 cases, ptxas's report of the
    bf16 hd-128 build and the profiled wave's device time per call."""
    from dstack_tpu_torch.workloads import _build

    case = {r["case"]: r for r in kres}
    bf16 = [r for r in kres if r["case"].endswith("bf16")]
    ptxas = kernel_ptxas(_build.build_log)
    return {
        "name": "ragged_paged_attention", "route": "cuda",
        "source": PAGED_KERNEL_SOURCE, "replaces": PAGED_KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        **{k: max(r[k] for r in bf16) for k in ("rel_l2", "row_rel", "row_l2")},
        **{k: case["decode_bf16"][k] for k in PAGED_TIMES},
        "decode_short": {k: case["decode_short_bf16"][k] for k in PAGED_TIMES},
        "chunk": {**{k: case["prefill_bf16"][k] for k in PAGED_TIMES},
                  "ptxas": ptxas["ragged_paged_attention_chunk"]},
        "verify": {k: case["verify_bf16"][k] for k in PAGED_TIMES},
        "verify32": {k: case["verify32_bf16"][k] for k in PAGED_TIMES},
        **{name: {k: case[f"{name}_bf16"][k] for k in PAGED_TIMES}
           for name in ("chunk256", "chunk256_bs32", "decode_bs32", "verify_bs32")},
        "prefill": {**{f"cell{S}_at{start}": {
            k: case[f"cell{S}_at{start}_bf16"].get(k)
            for k in PAGED_TIMES + ("split_kernel", "pack1_ms")} for S, start in CELL_CHUNKS},
            "crossover": crossover, "ptxas": ptxas["ragged_paged_prefill"]},
        "profiled_ms_per_call": wave["paged_ms_per_call"],
        "ptxas": ptxas["ragged_paged_attention"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    # f32 products in full f32 everywhere (state, not default-dependent).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.monotonic()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build: nvcc runs even if an earlier run left a library behind.
    from dstack_tpu_torch.workloads import _build

    t0 = time.monotonic()
    _build.load_library(rebuild=True)
    log(f"build: {time.monotonic() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    for line in (_build.build_log or "").splitlines():
        # C75xx: ptxas serialized a kernel's wgmma pipeline.
        if any(w in line for w in ("registers", "spill", "Compiling", "arning", "(C75")):
            log("  ptxas:", line.strip())

    # 3. kernels against plain versions
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.monotonic()
    kres = run_kernels(flush)
    kres_crossover = run_prefill_crossover(flush)
    del flush
    log(f"phase 3: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 3")

    # 3b. flash kernels against plain versions
    t0 = time.monotonic()
    fres = run_flash()

    # 3c. the ring-step kernel against its plain version
    fres += run_ring_block()
    log(f"phases 3b-3c: {time.monotonic() - t0:.1f}s")
    stray_processes("phases 3b-3c")

    # 4. engine: smol-1b, full width and depth, random weights from seed 0
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["smol-1b"]
    params = init_params(cfg, seed=0)
    log(f"model: smol-1b, {cfg.param_count() / 1e9:.3f}B params, {cfg.dtype},"
        f" {cfg.n_layers} layers")
    dense_check(cfg, params, torch.bfloat16)
    dense_check(cfg, params, torch.bfloat16, chunk=512, n_prompt=600)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    dense_check(cfg.with_(dtype="float32"), p32, torch.float32)
    del p32
    torch.cuda.empty_cache()
    launches, wave = run_engine(cfg, params)
    run_engine_chunks(cfg, params)

    # 4b. speculative decoding: plain, spec at 8 layers; f32 at 4 layers
    t0 = time.monotonic()
    cut_cfg, cut_params = first_layers(cfg, params, SERVE_CUT_LAYERS)
    spec = run_spec(cut_cfg, cut_params)
    log(f"phase 4b: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 4b")

    # 4c. the host KV tier: spill and swap back, preempt and resume
    t0 = time.monotonic()
    host_tier = run_host_tier(cfg, params)
    log(f"phase 4c: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 4c")

    # 5. http; the QoS gate on a second server
    run_http(params)
    qos = run_qos(params)

    # 5b. native_server with service.yml's flags
    t0 = time.monotonic()
    service = run_service(cfg, params)
    log(f"phase 5b: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 5b")

    # 11. disaggregation: in process, the two-process drill, the HTTP tiers
    t0 = time.monotonic()
    disagg = run_disagg(cut_cfg, cut_params)
    log(f"phase 11a: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 11a")
    t0 = time.monotonic()
    drill = start_disagg_drill()  # 11b beside 11c: both serve and check, neither is timed
    disagg["http"] = run_disagg_http(cfg, params)
    disagg["drill"] = run_disagg_drill(started=drill)
    log(f"phases 11b-11c: {time.monotonic() - t0:.1f}s")
    stray_processes("phases 11b-11c")
    del params, cut_params
    torch.cuda.empty_cache()

    # 12. Podracer RL: smol-1b Anakin over the three refresh channels,
    # learning on the tiny policy, the Sebulba drill in processes
    t0 = time.monotonic()
    drill = start_rl_drill()  # 12c beside 12a-12b (its tiny policy's processes)
    rl_checks = run_rl_model_checks()
    rl = run_rl_anakin()
    rl["model_checks"] = rl_checks
    rl["learning"] = run_rl_learning()
    rl["drill"] = run_rl_drill(started=drill)
    log(f"phase 12: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 12")

    # 6. train: smol-1b, full depth, B 8 x S 2048
    t0 = time.monotonic()
    train = run_train("smol-1b", 8, 2048)

    # 6b. kernels against plain attention inside the model
    model = run_model_check()
    log(f"phases 6-6b: {time.monotonic() - t0:.1f}s")
    stray_processes("phases 6-6b")

    # 7. ring: smol-1b-8k, full depth, B 1 x S 8192 over 4 seq shards
    t0 = time.monotonic()
    ring = run_train("smol-1b-8k", 1, 8192, seq_shards=RING_SHARDS)
    # The same config, weights and batch through the single-device flash
    # kernels: the first step's loss is the same function of the same
    # inputs; the later ones say whether a feature of the trajectory is the
    # ring's or the optimizer's.
    single = run_train("smol-1b-8k", 1, 8192, profiled=False)
    first_rel = abs(ring["losses"][0] - single["losses"][0]) / single["losses"][0]
    log(f"ring vs single device, smol-1b-8k: losses {ring['losses']} vs"
        f" {single['losses']}; first step rel {first_rel:.3e}"
        f" (tol {MODEL_TOL[torch.bfloat16][0]:g})")
    if not first_rel <= MODEL_TOL[torch.bfloat16][0]:
        raise AssertionError("the ring's first loss disagrees with the single device's")
    ring["single_device"] = {k: single[k] for k in ("losses", "grad_norms", "step_ms",
                                                      "tokens_per_s", "peak_mem_gb")}

    # 7b. the ring against plain attention and the flash kernels in the model
    ring_model = run_model_check("smol-1b-8k", 1, 8192, seq_shards=RING_SHARDS)
    log(f"phases 7-7b: {time.monotonic() - t0:.1f}s")
    stray_processes("phases 7-7b")

    # 8. the train-state checkpoint of smol-1b at full width and depth
    t0 = time.monotonic()
    checkpoint = run_checkpoint()

    # 8b. SIGTERM drain and resume of a subprocess trainer, kernel cache
    drain = run_drain()
    log(f"phases 8-8b: {time.monotonic() - t0:.1f}s")
    stray_processes("phases 8-8b")

    # 9. LoRA serving: the module, the engines, speculation, the host tier, http
    t0 = time.monotonic()
    params = init_params(cfg, seed=0)
    lora_serving = run_lora_serving(cfg, params)
    del params
    torch.cuda.empty_cache()
    log(f"phase 9: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 9")

    # 10. LoRA training at full width and depth; 10b. at 2 layers, drain
    t0 = time.monotonic()
    lora_train = run_lora_train(train)
    lora_checks = run_lora_model_checks()
    lora_checks["drain"] = run_lora_drain()
    log(f"phases 10-10b: {time.monotonic() - t0:.1f}s")
    stray_processes("phases 10-10b")

    # 13. mixture-of-experts: the module, serving and training at smol-moe
    t0 = time.monotonic()
    moe_module = run_moe_module()
    log(f"phase 13a: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 13a")
    t1 = time.monotonic()
    mcfg = PRESETS[MOE_PRESET].with_(n_layers=MOE_SERVING_LAYERS)
    log(f"model: {MOE_PRESET}, {mcfg.param_count() / 1e9:.3f}B params, {mcfg.dtype},"
        f" {mcfg.n_layers} layers, {mcfg.n_experts} experts, top-{mcfg.experts_per_token}")
    moe_serving = run_moe_serving(mcfg)
    moe_serving["http"] = run_moe_http()
    log(f"phase 13b: {time.monotonic() - t1:.1f}s")
    t1 = time.monotonic()
    moe_train = run_moe_train()
    log(f"phase 13c: {time.monotonic() - t1:.1f}s")
    log(f"phase 13: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 13")

    # 14. tensor-parallel serving: smol-1b over two gloo ranks on the card,
    # kernel #1 at a rank's heads, a world-1 NCCL wave
    t0 = time.monotonic()
    tp = run_tp()
    log(f"phase 14: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 14")

    # 15. training across ranks: smol-1b over two gloo ranks on the card at
    # fsdp 2 and model 2, kernels #2-#4 at a rank's geometry, NCCL world 1
    t0 = time.monotonic()
    tr = run_train_ranks(tp["train_nccl"])
    log(f"phase 15: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 15")

    # 16. the ring across ranks: smol-1b-8k over four gloo ranks on the card
    # at seq 4; 17. the GPipe pipeline: smol-1b in two stages on two ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ring_ranks = run_ring_ranks()
    log(f"phase 16: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 16")
    t0 = time.monotonic()
    pipe = run_pipeline()
    log(f"phase 17: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 17")

    # 18. expert parallelism: smol-moe (8 of 16 layers) over an expert axis
    # of two gloo ranks on the card, against its unsharded steps
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    expert = run_expert_parallel()
    log(f"phase 18: {time.monotonic() - t0:.1f}s")
    stray_processes("phase 18")

    # 19. the gang: fine_tune as two host processes joined from the
    # orchestrator's variables against one host; run_rl's Sebulba pair
    gc.collect()
    torch.cuda.empty_cache()
    gang = run_gang()
    stray_processes("phase 19")

    # 20. MoE over a seq axis of ranks: smol-moe (4 of 16 layers) over two
    # gloo ranks on the card at seq 2, against the one-device seq-2 ring
    gc.collect()
    torch.cuda.empty_cache()
    moe_seq = run_moe_seq_ranks()
    stray_processes("phase 20")

    log(f"total {time.monotonic() - t_all:.1f}s")
    log(smi)  # again near the end, where a reader of the output's tail finds it
    kernels = {"kernels": [paged_entry(kres, launches, wave, kres_crossover)]}
    # The paged kernel's launches on the speculative and host-tier paths
    # (each zeroed just before its run and read just after).
    kernels["kernels"][0]["launches_by_path"] = {
        "engine": launches,
        "spec": [r["kernel_launches"] for r in spec["runs"] if r["spec"]],
        "host_tier": host_tier["spill"]["kernel_launches"],
        "lora": [r["kernel_launches"] for r in lora_serving["runs"] if r["lora"]],
        "lora_spec": lora_serving["spec"]["kernel_launches"],
        "disagg": disagg["launches"],
        "disagg_by_tier": disagg["launches_by_tier"],
        "rl": rl["launches"]["ragged_paged_attention"],
        "moe": moe_serving["runs"]["plain_all"]["kernel_launches"],
        "moe_spec": moe_serving["runs"]["spec_all"]["kernel_launches"],
        # Each rank of phase 14's bf16 wave, on its 8 q / 4 KV heads.
        **{f"tp_rank{r}": rk["launches"] for r, rk in enumerate(tp["ranks"]["bf16"]["ranks"])},
        # Each rank of 14(g)'s f32 RL round on the model-2 mesh.
        **{f"rl_actor_rank{r}": rk["launches"]
           for r, rk in enumerate(tp["ranks"]["rl_actor"]["f32"]["ranks"])},
        # Each expert rank of 18(c)'s bf16 wave, on all 16 heads.
        **{f"expert_serving_rank{r}": rk["sound"]["launches"]
           for r, rk in enumerate(expert["ranks"]["serve"]["bf16"]["ranks"])},
    }
    kernels["kernels"][0]["per_rank"] = {
        r["case"]: {k: r[k] for k in ("rel_l2", "row_rel", "row_l2", "max_abs_err",
                                      *[t for t in PAGED_TIMES if t in r])}
        for r in tp["kernels"]}
    # `ms` (and so `tflops` and `bound_share`) times launches back to back
    # (`cuda_ms`); `ms_one_launch` one launch from the host's call on an
    # idle card and a cold L2, which for a short kernel is mostly latency.
    for kern, replaces in FLASH_REPLACES.items():
        main_case = "ring_full_bf16" if kern == "flash_block_fwd" else "train_bf16"
        main_f = next(r for r in fres if r["case"] == main_case and r["kernel"] == kern)
        run = ring if kern == "flash_block_fwd" else train
        kernels["kernels"].append({
            "name": kern,
            "route": "cuda",
            "source": FLASH_KERNEL_SOURCE,
            "replaces": replaces,
            "launches": run["launches"][kern],
            **({"launches_by_path": {
                "train": train["launches"][kern],
                "lora_train": lora_train["launches"][kern],
                "rl": rl["launches"][kern],
                "moe_train": moe_train["runs"][0]["launches"][kern],
                # Each rank of phase 15's bf16 layouts over its TR_STEPS steps.
                **{f"train_{name}_rank{r}": int(rr["launches_per_step"][kern] * TR_STEPS)
                   for name in ("fsdp2", "model2")
                   for r, rr in enumerate(tr["ranks"]["bf16"][name]["ranks"])},
                # Each stage of phase 17's bf16 pipeline over its PP_STEPS steps.
                **{f"pipeline_stage{r}": int(rr["launches_per_step"][kern] * PP_STEPS)
                   for r, rr in enumerate(pipe["ranks"]["bf16"]["sound"]["ranks"])},
                # Each expert rank of phase 18's bf16 run over its EP_STEPS steps.
                **{f"expert_rank{r}": int(rr["launches_per_step"][kern] * EP_STEPS)
                   for r, rr in enumerate(expert["ranks"]["bf16"]["sound"]["ranks"])},
                # Each host process of phase 19's gang over its GANG_STEPS steps.
                **{f"gang_host{r['host']}": r["launches"][kern]
                   for r in gang["fine_tune"]["hosts"]},
                # Each rank of phase 15's LoRA on the row targets over model 2
                # and of phase 18's LoRA over expert 2, bf16, over their steps.
                **{f"lora_model_rank{r}": int(rr["launches_per_step"][kern] * TR_STEPS)
                   for r, rr in enumerate(tr["ranks"]["lora"]["bf16"]["sound"]["ranks"])},
                **{f"lora_expert_rank{r}": int(rr["launches_per_step"][kern] * EP_STEPS)
                   for r, rr in enumerate(expert["ranks"]["lora"]["bf16"]["sound"]["ranks"])},
                # Each rank of 15(h)'s bf16 PPO learner over its RLR_STEPS updates
                # (B*H 64, S 127), and 14(g)'s score op (#2, once a layer a rank).
                **{f"rl_learner_{name}_rank{r}": int(rr["launches_per_step"][kern] * RLR_STEPS)
                   for name in ("fsdp2", "model2")
                   for r, rr in enumerate(tr["ranks"]["rl"]["bf16"][name]["ranks"])},
                **({f"rl_actor_score_rank{r}": rk["flash"][kern]
                    for r, rk in enumerate(tp["ranks"]["rl_actor"]["bf16"]["ranks"])}
                   if kern == "flash_fwd" else {})}}
               if kern != "flash_block_fwd" else {"launches_by_path": {
                   # Each rank of phase 16's bf16 ring over its RG_STEPS steps.
                   **{f"ring_rank{r}": int(rr["launches_per_step"][kern] * RG_STEPS)
                      for r, rr in enumerate(ring_ranks["ranks"]["bf16"]["sound"]["ranks"])},
                   # Each seq rank of phase 20's bf16 MoE over its MS_STEPS steps.
                   **{f"moe_seq_rank{r}": int(rr["launches_per_step"][kern] * MS_STEPS)
                      for r, rr in enumerate(moe_seq["ranks"]["bf16"]["sound"]["ranks"])}}}),
            "max_abs_err": main_f["max_abs_err"],
            "ms": main_f["ms"],
            "ms_one_launch": main_f["ms_one_launch"],
            "plain_ms": main_f["plain_ms"],
            "bound_ms": main_f["bound_ms"],
            "bound_by": main_f["bound_by"],
            "library_ms": main_f["library_ms"],
            "library_ms_one_launch": main_f["library_ms_one_launch"],
            "tflops": main_f["tflops"],
            "bound_share": main_f["bound_share"],
            "ptxas": main_f["ptxas"],
            **({"whole_backward": main_f["whole_backward"]} if "whole_backward" in main_f
               else {}),
        })
        keys = ("max_abs_err", "ms", "ms_one_launch", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_ms_one_launch", "tflops", "bound_share")
        if kern == "flash_block_fwd":
            # Phase 20c: at a seq rank's geometry (B*H 32, S 1024, hd 128).
            seq_f = next(r for r in moe_seq["kernels"] if r["case"] == "seq_rank_full_bf16")
            kernels["kernels"][-1]["per_seq_rank"] = {k: seq_f[k] for k in keys}
        if kern != "flash_block_fwd":
            # Phase 15c: at a rank's geometry (B*H 64, S 2048, hd 128).
            rank_f = next(r for r in tr["kernels"]
                          if r["case"] == "rank_bf16" and r["kernel"] == kern)
            stage_f = next(r for r in pipe["kernels"]
                           if r["case"] == "stage_bf16" and r["kernel"] == kern)
            kernels["kernels"][-1]["per_rank"] = {k: rank_f[k] for k in keys}
            # Phase 17c: at a stage's geometry (B*H 32: a 2-row microbatch),
            # which is also an expert rank's in phase 18 (B 2 x 16 heads).
            kernels["kernels"][-1]["per_stage"] = {k: stage_f[k] for k in keys}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"device": smi, "paged": kres, "spec": spec, "host_tier": host_tier,
                   "qos": qos, "service": service, "disagg": disagg, "flash": fres, "train": train,
                   "model_check": model, "ring_train": ring, "ring_model_check": ring_model,
                   "checkpoint": checkpoint, "drain": drain, "lora_serving": lora_serving,
                   "lora_train": lora_train, "lora_checks": lora_checks, "rl": rl,
                   "moe_module": moe_module, "moe_serving": moe_serving,
                   "moe_train": moe_train, "tp": tp, "train_ranks": tr,
                   "ring_ranks": ring_ranks, "pipeline": pipe, "expert_parallel": expert,
                   "gang": gang, "moe_seq_ranks": moe_seq, "build_s": _build.build_seconds},
                  f, indent=1)
    # What could hold the interpreter's exit or outlive it: threads that
    # are not daemons, and processes below this one still running (every
    # phase stops its own; what is left is stopped here, and named).
    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon]
    log(f"at exit: non-daemon threads {left}, processes stopped {stop_descendants()}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["--gang-host"]:  # a host of phase 19(a), started by run_gang_fine_tune
        sys.exit(gang_host_main(argv[1:]))
    rank_args = (lambda: (int(argv[argv.index("--rank") + 1]),
                          argv[argv.index("--dist-init") + 1]))
    if "--tp-rank" in argv:  # a rank of phase 14, started by run_tp
        sys.exit(tp_rank_main(*rank_args()))
    if "--tr-rank" in argv:  # a rank of phase 15, started by run_train_ranks
        sys.exit(tr_rank_main(*rank_args()))
    if "--rg-rank" in argv:  # a rank of phase 16, started by run_ring_ranks
        sys.exit(rg_rank_main(*rank_args()))
    if "--pp-rank" in argv:  # a stage of phase 17, started by run_pipeline
        sys.exit(pp_rank_main(*rank_args()))
    if "--ep-rank" in argv:  # a rank of phase 18, started by run_expert_parallel
        sys.exit(ep_rank_main(*rank_args()))
    if "--ms-rank" in argv:  # a rank of phase 20, started by run_moe_seq_ranks
        sys.exit(ms_rank_main(*rank_args()))
    if "--tp-nccl" in argv or "--tr-nccl" in argv:  # 14(f) and 15(f), in their own process
        torch.backends.cuda.matmul.allow_tf32 = False
        if "--tp-nccl" in argv:
            run_tp_nccl()
        if "--tr-nccl" in argv:
            run_train_nccl()
        sys.exit(0)
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_descendants(grace=5.0)  # a failed phase's processes end with the run
    sys.exit(code)
