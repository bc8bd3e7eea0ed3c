"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure fails the run; nothing is caught to exit 0):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the port's kernels from csrc/, timed;
  3. kernels — the paged kernel against its plain PyTorch version on the
               card, at the serving path's shapes for smol-1b (decode over
               slots to 2047 positions, decode over the engine's short
               slots, and a 128-token chunk), in bf16 and f32, per output
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
  5. http    — native_server on localhost: models, two chat completions,
               metrics;
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
               step (device idle share, ms by kernel class);
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
               the single-device flash kernels, f32 and bf16.
Phase 3b and 3c run after 3, phases 6 to 7b after 5. The line before the
last is the `kernels` JSON; the last line is {"ok": true, "device": {...}}.
Each phase logs its numbers on the way; details also go to
chiprun_out/chip_smoke.json.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

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
ENGINE_LOGIT_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
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
    # the engine wave's (to 269 positions), a 128-token chunk.
    geo = dict(H=16, KV=8, hd=128, bs=16, MB=128, NB=1024)
    decode_lens = [37, 200, 513, 1000, 1499, 1801, 2046, 64]
    short_lens = [100, 124, 148, 172, 196, 220, 244, 268]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append(paged_case(f"decode_{tag}", dtype, B=8, S=1, **geo,
                                start=decode_lens, seed=1))
        cases.append(paged_case(f"decode_short_{tag}", dtype, B=8, S=1, **geo,
                                start=short_lens, seed=3))
        cases.append(paged_case(f"prefill_{tag}", dtype, B=1, S=128, **geo,
                                start=[384], seed=2))
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


def paged_plan(pa, case, per_sm=None):
    """`_split_plan` of a case's shapes on this card."""
    B, S, H, hd = case["q"].shape
    _, bs, KV, _ = case["k"].shape
    return pa._split_plan(B, S, H, KV, case["tables"].shape[1], bs, hd, case["dtype"],
                          pa._device_info(case["q"].device.index)[1], per_sm)


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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = "combine" if "combine" in e.name else "main"
            by_name[key] = by_name.get(key, 0) + e.time_range.elapsed_us()
    return dict(host_us_per_call=host_us,
                profiled_ms_per_call={k: v / 1e3 / n for k, v in by_name.items()})


def paged_times(pa, case, ref, flush) -> dict:
    """The kernel and SDPA on the gathered dense view timed back to back
    over PAGED_COPIES distinct copies of the pools (`ms`, `library_ms`) and
    one launch at a time on a cold L2 (`ms_one_launch`,
    `library_ms_one_launch`); the plain version one call at a time; and
    the kernel back to back under the split target (CTAs per SM) that
    `_split_plan` does not choose of 4 and 8 (`other_plan`), which the
    chosen one should beat."""
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
    other = {4: 8, 8: 4}[pa.CTAS_PER_SM[(case["dtype"], case["q"].shape[1] == 1)]]
    plan = paged_plan(pa, case, other)
    alt = [lambda c=c: pa._ragged_attention_cuda(c["q"], c["k"], c["v"], c["tables"],
                                                 c["vlen"], plan) for c in copies]
    r["other_plan"] = dict(per_sm=other, splits=plan.splits,
                           keys_per_split=plan.keys_per_split, ms=cuda_ms(alt, 4 * PAGED_COPIES))
    del alt
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


def run_flash(timed: bool = True):
    """Each flash kernel against its plain version on the same inputs;
    the SDPA yardstick (forward, and backward for dQ + dK/dV together) at
    the bf16 training shape. Returns one result per (case, kernel)."""
    from dstack_tpu_torch.workloads import _build
    from dstack_tpu_torch.workloads import flash_attention as fa

    ptxas = kernel_ptxas(_build.build_log)

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
        main_case = dtype == torch.bfloat16 and name.startswith("train")
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


def run_ring_block(timed: bool = True):
    """The ring-step kernel against `_block_ref_bh` on the same inputs: o,
    m and l held each on its own (a missed rescale of o cancels in o / l
    when l carries it too). Returns one result per case."""
    from dstack_tpu_torch.workloads import _build
    from dstack_tpu_torch.workloads import flash_attention as fa

    ptxas = kernel_ptxas(_build.build_log)["flash_block_fwd"]

    s_shard = 8192 // RING_SHARDS
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
                   if dtype == torch.bfloat16 and name.startswith("ring") else None)
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
              profiled: bool = True):
    """`preset` at full width and depth, B x S, bf16, random weights from
    seed 0, on one fixed synthetic batch: the port's trainer end to end,
    over a seq mesh of `seq_shards` (the ring) when that is > 1; then one
    profiled step unless `profiled` is False."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.sharding import device_shards, make_mesh
    from dstack_tpu_torch.workloads.train import (
        init_train_state,
        make_train_step,
        synthetic_batch,
    )

    cfg = PRESETS[preset]
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
    losses, norms = [], []
    t0 = time.monotonic()
    for _ in range(n_steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    vals = torch.stack(losses + norms).tolist()  # the one host readback
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = vals[:n_steps], vals[n_steps:]
    want = expected_launches(cfg, remat, n_warm + n_steps, seq_shards)
    step_ms = wall / n_steps * 1e3
    tokens_s = B * S * n_steps / wall
    flops_step = cfg.flops_per_token(S) * B * S
    stats = dict(
        preset=preset, layers=cfg.n_layers, batch=B, seq_len=S, seq_shards=seq_shards,
        dtype=cfg.dtype, remat=remat, steps=n_steps, warmup_steps=n_warm,
        warmup_s=warm_s, step_ms=step_ms, tokens_per_s=tokens_s, flops_per_step=flops_step,
        mfu=cfg.flops_per_token(S) * tokens_s / H100_BF16_PEAK,
        peak_mem_gb=peak / 1e9,
        estimator_activation_gb=cfg.activation_bytes(B * S, device_shards(mesh),
                                                     seq_len=S) / 1e9,
        train_state_gb=sum(t.numel() * t.element_size() for t in _state_tensors(state)) / 1e9,
        losses=losses, grad_norms=norms, launches=launches,
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


def _state_tensors(state):
    from dstack_tpu_torch.workloads.weights import flatten_params

    yield from (t for _, t in flatten_params(state.params))
    yield from (t for _, t in flatten_params(state.opt_state.mu))
    yield from (t for _, t in flatten_params(state.opt_state.nu))


def profile_step(step, state, batch):
    """One train step under torch.profiler: device time by kernel class
    and the device's idle share of the step's wall time (the profiler adds
    host overhead; not used for the throughput above)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_class, by_name, flash = {}, {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
        if c == "flash_attention":
            m = re.search(r"flash_\w*?_kernel", e.name)
            f = flash.setdefault(m.group(0) if m else e.name[:60], {"calls": 0, "ms": 0.0})
            f["calls"] += 1
            f["ms"] += us / 1e3
    for f in flash.values():
        f["ms_per_call"] = f["ms"] / f["calls"]
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / wall_us if wall_us else None,
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


def dense_check(cfg, params, dtype):
    """A 200-token prompt through two chunk-prefill programs (128 + 72,
    paged, attention through the kernel) against the dense plain
    `_forward_cached`, on the last position's logits."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.generate import _forward_cached, init_cache
    from dstack_tpu_torch.workloads.kv_blocks import init_paged_state, make_chunk_prefill

    dev = params["embed"].device
    prompt = byte_prompt(99, 200)
    st = init_paged_state(cfg, 1, 256, 16, 16, dev)
    table = list(range(13)) + [16] * 3
    fn = make_chunk_prefill(cfg, 128)
    before = pa.LAUNCHES["ragged_paged_attention"]
    fn(params, st, 0, table, prompt[:128], 128, 0, 8, 0.0, 1.0, None, False)
    _, first, logits = fn(params, st, 0, table, prompt[128:] + [0] * 56, 72, 128,
                          8, 0.0, 1.0, None, True)
    launched = pa.LAUNCHES["ragged_paged_attention"] - before
    ref, _ = _forward_cached(cfg, params, torch.tensor([prompt], device=dev),
                             init_cache(cfg, 1, 200, dev))
    rel = float((logits - ref[0]).abs().max() / ref[0].abs().max())
    same_top1 = int(first) == int(ref[0].argmax())
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    log(f"engine dense check {tag}: max|dlogits|/max|logits|={rel:.3e}"
        f" (tol {ENGINE_LOGIT_TOL[dtype]:g}), top-1 agrees={same_top1},"
        f" kernel launches={launched}")
    if launched != 2 * cfg.n_layers:
        raise AssertionError(f"dense check ran the kernel {launched} times")
    if not rel <= ENGINE_LOGIT_TOL[dtype]:
        raise AssertionError(f"chunked-prefill logits off by {rel}")


def run_engine(cfg, params):
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.serving import ServingEngine

    eng = ServingEngine(cfg, params, slots=8, steps_per_sync=4,
                        prefill_chunk_tokens=128, kv_block_size=16)
    try:
        t0 = time.monotonic()
        w = eng.warmup()
        log(f"engine warmup: {w['programs']} programs in {w['seconds']:.3f}s"
            f" (wall {time.monotonic() - t0:.3f}s)")
        shared = byte_prompt(0, 64)
        prompts = [shared + byte_prompt(1, 40)]
        prompts += [byte_prompt(s, n) for s, n in
                    zip(range(2, 8), (32, 77, 128, 180, 255, 300))]
        prompts.insert(4, shared + byte_prompt(9, 70))
        pa.LAUNCHES["ragged_paged_attention"] = 0
        n_new = 32
        t_start = time.monotonic()
        # The first sharer runs ahead so its prefix blocks are published
        # before the second sharer is admitted.
        t_sub = [time.monotonic()]
        outs = [eng.submit(prompts[0], max_new_tokens=n_new, temperature=0.0)]
        first_toks, t_first0 = drain(outs[0])
        results = [(first_toks, t_first0)]
        t_wave = time.monotonic()
        for p in prompts[1:]:
            t_sub.append(time.monotonic())
            outs.append(eng.submit(p, max_new_tokens=n_new, temperature=0.0))
        results += [drain(q) for q in outs[1:]]
        t_end = time.monotonic()
        launches = pa.LAUNCHES["ragged_paged_attention"]
        st = eng.stats()
        breakdown = profile_wave(eng, cfg)
    finally:
        eng.close()
    counts = [len(t) for t, _ in results]
    log(f"engine: token counts {counts}, kernel launches {launches},"
        f" prefix hits {st['prefix_cache_hits_total']},"
        f" tokens reused {st['prefix_tokens_reused_total']}")
    if counts != [n_new] * len(prompts):
        raise AssertionError(f"token counts {counts}")
    if launches <= 0:
        raise AssertionError("the engine run launched the kernel 0 times")
    if st["prefix_cache_hits_total"] < 1:
        raise AssertionError("the shared prefix did not hit the prefix cache")
    if st["attn_path"] != "cuda" or st["attn_dispatch_plain_total"]:
        raise AssertionError(f"attention path {st['attn_path']}")
    for toks, _ in results:
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("token id out of range")
    ttft = sorted(tf - ts for (_, tf), ts in zip(results, t_sub))
    wave_tokens = n_new * (len(prompts) - 1)
    eng_stats = dict(
        requests=len(prompts), new_tokens_each=n_new, kernel_launches=launches,
        prefix_cache_hits=st["prefix_cache_hits_total"],
        prefix_tokens_reused=st["prefix_tokens_reused_total"],
        ttft_p50_s=statistics.median(ttft),
        ttft_p95_s=ttft[min(len(ttft) - 1, math.ceil(0.95 * len(ttft)) - 1)],
        wave_tokens_per_s=wave_tokens / (t_end - t_wave),
        decode_tokens_per_s=(sum(counts) - len(counts)) / max(st["decode_seconds_total"], 1e-9),
        decode_seconds_total=st["decode_seconds_total"],
        prefill_seconds_total=st["prefill_seconds_total"],
        prefill_chunks=st["prefill_chunks_total"],
        wall_s=t_end - t_start,
        profiled_wave=breakdown,
    )
    log("engine stats", json.dumps(eng_stats))
    return launches, breakdown


def kernel_class(name: str) -> str:
    n = name.lower()
    if "ragged_paged_attention" in n:
        return "paged_attention"
    if "flash_" in n:
        return "flash_attention"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas", "matmul", "nvjet")):
        return "matmul"
    return "other"


def profile_wave(eng, cfg):
    """A second wave (8 requests x 32 tokens, prompts 100-240 tokens)
    under torch.profiler: device time per kernel class and the device's
    busy share of the wave's wall time. Not used for the throughput
    numbers above (the profiler adds host overhead)."""
    from torch.profiler import ProfilerActivity, profile

    from dstack_tpu_torch.workloads import paged_attention as pa

    prompts = [byte_prompt(20 + s, 100 + 20 * s) for s in range(8)]
    before = pa.LAUNCHES["ragged_paged_attention"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        outs = [eng.submit(p, max_new_tokens=32, temperature=0.0) for p in prompts]
        for q in outs:
            drain(q)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_class, by_name = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name), 0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / wall_us if wall_us else None,
        "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
        "top_kernels_ms": [(n[:90], v / 1e3) for n, v in top],
    }
    # The paged kernel's device time per wrapper call (its split-KV combine
    # kernel, where it runs, counted in the same call).
    calls = pa.LAUNCHES["ragged_paged_attention"] - before
    out["paged_calls"] = calls
    out["paged_ms_per_call"] = (by_class.get("paged_attention", 0) / 1e3 / calls
                                if calls else None)
    log("profiled wave", json.dumps(out))
    return out


# -- phase 5: http -----------------------------------------------------------


def http(method, url, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def run_http(params):
    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

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
        code, body = http("POST", base + "/v1/chat/completions", msg)
        resp = json.loads(body)
        assert code == 200 and resp["usage"]["completion_tokens"] == 12, body
        code, body = http("POST", base + "/v1/chat/completions", {**msg, "stream": True})
        assert code == 200 and body.rstrip().endswith("data: [DONE]"), body[-200:]
        code, body = http("GET", base + "/metrics")
        m = json.loads(body)
        assert code == 200 and m["admitted_total"] >= 2 and m["attn_path"] == "cuda", m
        code, body = http("GET", base + "/metrics?format=prometheus")
        assert code == 200 and 'dstack_tpu_serving_attn_dispatch_total{path="cuda"}' in body
        log(f"http: models, 2 chat completions and metrics answered 200 on :{port}")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.serving.close()


PAGED_TIMES = ("ms", "ms_one_launch", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "library_ms_one_launch", "tflops", "bound_share", "other_plan",
               "host_us_per_call")


def paged_entry(kres, launches, wave) -> dict:
    """The paged kernel's entry of the `kernels` line: the bf16 decode
    case's times, the bf16 short-slot decode and chunk cases' beside them,
    the largest readings over the bf16 cases, ptxas's report of the bf16
    hd-128 build and the profiled wave's device time per call."""
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
    kres = run_kernels(flush)
    del flush

    # 3b. flash kernels against plain versions
    t0 = time.monotonic()
    fres = run_flash()

    # 3c. the ring-step kernel against its plain version
    fres += run_ring_block()
    log(f"phases 3b-3c: {time.monotonic() - t0:.1f}s")

    # 4. engine: smol-1b, full width and depth, random weights from seed 0
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["smol-1b"]
    params = init_params(cfg, seed=0)
    log(f"model: smol-1b, {cfg.param_count() / 1e9:.3f}B params, {cfg.dtype},"
        f" {cfg.n_layers} layers")
    dense_check(cfg, params, torch.bfloat16)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    dense_check(cfg.with_(dtype="float32"), p32, torch.float32)
    del p32
    torch.cuda.empty_cache()
    launches, wave = run_engine(cfg, params)

    # 5. http
    run_http(params)
    del params
    torch.cuda.empty_cache()

    # 6. train: smol-1b, full depth, B 8 x S 2048
    t0 = time.monotonic()
    train = run_train("smol-1b", 8, 2048)

    # 6b. kernels against plain attention inside the model
    model = run_model_check()
    log(f"phases 6-6b: {time.monotonic() - t0:.1f}s")

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

    log(f"total {time.monotonic() - t_all:.1f}s")
    kernels = {"kernels": [paged_entry(kres, launches, wave)]}
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
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"device": smi, "paged": kres, "flash": fres, "train": train,
                   "model_check": model, "ring_train": ring, "ring_model_check": ring_model,
                   "build_s": _build.build_seconds}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
