"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure fails the run; nothing is caught to exit 0):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the port's kernels from csrc/, timed;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the serving path's shapes for smol-1b, in bf16 and f32;
               times of kernel, plain version, bound and library call;
  4. engine  — smol-1b at full width and depth (random weights from a
               seed) behind the paged ServingEngine: 8 temperature-0
               requests, two sharing a 64-token prefix; the kernel's
               launch count over that run; a chunked prefill's logits
               against the dense plain forward;
  5. http    — native_server on localhost: models, two chat completions,
               metrics.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Each phase logs its numbers on the way.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

import json
import math
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
# Kernel against plain version, max |diff| on outputs of order 1:
# bf16 — the kernel is one-pass and rounds p to bf16 relative to the
# running max, the plain version two-pass at the final (m, l): both round
# the output to bf16 (ulp 2^-8 near 1); f32 — summation order only.
KERNEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# Chunked-prefill logits (paged, through the kernel) against the dense
# plain forward, max |diff| / max |ref| over 16 layers.
ENGINE_LOGIT_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
PAGED_KERNEL_SOURCE = "dstack_tpu_torch/workloads/csrc/paged_attention.cu"
PAGED_KERNEL_REPLACES = "dstack_tpu/workloads/paged_attention.py:222"


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int, flush: torch.Tensor = None) -> float:
    """Median device time of fn() in ms over `iters` runs, each bracketed
    by CUDA events; `flush` is rewritten before each run (outside the
    events) so the run finds the 50 MB L2 cold, as a layer of the real
    model finds its pool."""
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


def paged_bound(case) -> tuple:
    """(bound_ms, bound_by) for one call: bytes it must move (q, tables,
    valid lengths and the K/V rows its slots hold read once, the output
    written once) over HBM bandwidth, against QK^T + PV operations on the
    keys each row sees over the type's peak."""
    q, k, tables, vlen = case["q"], case["k"], case["tables"], case["vlen"]
    B, S, H, hd = q.shape
    NB, bs, KV, _ = k.shape
    es = q.element_size()
    slot_len = vlen.max(dim=1).values.clamp(max=tables.shape[1] * bs)
    kv_bytes = int(slot_len.sum()) * KV * hd * es * 2
    nbytes = (kv_bytes + 2 * q.numel() * es + tables.numel() * 4 + vlen.numel() * 4)
    ops = int(vlen.clamp(max=tables.shape[1] * bs).sum()) * H * hd * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    geo = dict(H=16, KV=8, hd=128, bs=16, MB=128, NB=1024)
    decode_lens = [37, 200, 513, 1000, 1499, 1801, 2046, 64]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append(paged_case(f"decode_{tag}", dtype, B=8, S=1, **geo,
                                start=decode_lens, seed=1))
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
        err = float((got.float() - ref.float()).abs().max())
        tol = KERNEL_TOL[case["dtype"]]
        log(f"kernel {case['name']}: max_abs_err={err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{case['name']}: max_abs_err {err} > {tol}")
        qt, dk, dv, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_out = sdpa(qt, dk, dv, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib_out.transpose(1, 2).reshape(ref.shape).float()
                         - ref.float()).abs().max())
        ms = cuda_ms(lambda: pa._ragged_attention_cuda(*args), 100, flush)
        plain_ms = cuda_ms(lambda: pa._ragged_attention_plain(*args), 5, flush)
        lib_ms = cuda_ms(lambda: sdpa(qt, dk, dv, attn_mask=mask, enable_gqa=True),
                         50, flush)
        bound_ms, bound_by = paged_bound(case)
        r = dict(case=case["name"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                 library_max_abs_err=lib_err)
        log("kernel timing", json.dumps(r))
        results.append(r)
        del qt, dk, dv, mask, lib_out
    return results


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
    return launches


def kernel_class(name: str) -> str:
    n = name.lower()
    if "ragged_paged_attention" in n:
        return "paged_attention"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas", "matmul", "nvjet")):
        return "matmul"
    return "other"


def profile_wave(eng, cfg):
    """A second wave (8 requests x 32 tokens, prompts 100-240 tokens)
    under torch.profiler: device time per kernel class and the device's
    busy share of the wave's wall time. Not used for the throughput
    numbers above (the profiler adds host overhead)."""
    from torch.profiler import ProfilerActivity, profile

    prompts = [byte_prompt(20 + s, 100 + 20 * s) for s in range(8)]
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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    # 3. kernels against plain versions
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kres = run_kernels(flush)
    del flush

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
    launches = run_engine(cfg, params)

    # 5. http
    run_http(params)

    log(f"total {time.monotonic() - t_all:.1f}s")
    main_case = next(r for r in kres if r["case"] == "decode_bf16")
    kernels = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": PAGED_KERNEL_SOURCE,
        "replaces": PAGED_KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kres
                           if r["case"].endswith("bf16")),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
