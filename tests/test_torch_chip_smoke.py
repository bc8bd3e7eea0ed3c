"""The arithmetic and parsing of `chip_smoke.py`'s kernel readings, on the
CPU: the FLOPs and bounds it divides by, the achieved rate and share of
bound, and the ptxas report it reads registers and spills from. Imports
neither JAX nor the JAX package."""

import pytest
import torch

import chip_smoke as cs

# What nvcc -Xptxas=-v prints for an entry (mangled names as the port's
# kernels build, the anonymous namespace's prefix cut short).
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi64EEEvNS_4sm904MapsENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi64EEEvNS_4sm904MapsENS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi128EEEvNS_4sm904MapsENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi128EEEvNS_4sm904MapsENS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_127flash_block_fwd_sm90_kernelILi128EEEvNS_4sm904MapsENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_127flash_block_fwd_sm90_kernelILi128EEEvNS_4sm904MapsENS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_bwd_dq_sm90_kernelILi128EEEvNS_4sm907BwdMapsENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_bwd_dq_sm90_kernelILi128EEEvNS_4sm907BwdMapsENS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_report_is_read_per_entry():
    res = cs.ptxas_resources(PTXAS_LOG)
    assert len(res) == 5
    fwd128 = next(v for k, v in res.items() if "flash_fwd_sm90_kernelILi128E" in k)
    assert fwd128 == {"stack": 8, "spill_stores": 4, "spill_loads": 12, "registers": 168}


def test_kernel_ptxas_picks_the_bf16_hd128_instantiations():
    got = cs.kernel_ptxas(PTXAS_LOG)
    assert got["flash_fwd"]["registers"] == 168 and got["flash_fwd"]["spill_loads"] == 12
    assert got["flash_block_fwd"] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                      "registers": 168}
    assert got["flash_bwd_dq"]["registers"] == 168  # the bf16 sm90 build, not the f32 one's 255
    assert got["flash_bwd_dkv"] is None
    assert cs.kernel_ptxas(None) == dict.fromkeys(cs.PTXAS_ENTRY)


@pytest.mark.parametrize("which,bh,s,hd,causal,gflop", [
    ("flash_fwd", 128, 2048, 128, True, 137.506062336),       # the smol-1b step
    ("flash_block_fwd", 16, 2048, 128, False, 34.359738368),  # a full ring step
    ("flash_block_fwd", 16, 2048, 128, True, 17.188257792),   # the diagonal one
    ("flash_bwd_dq", 128, 2048, 128, True, 206.259093504),
    ("flash_bwd_dkv", 128, 2048, 128, True, 275.012124672),
])
def test_flash_ops_count_the_pairs_the_mask_keeps(which, bh, s, hd, causal, gflop):
    assert cs.flash_ops(which, bh, s, hd, causal) / 1e9 == pytest.approx(gflop, rel=1e-12)


def test_flash_bound_and_rate_readings():
    bound, by = cs.flash_bound("flash_fwd", 128, 2048, 128, torch.bfloat16, True)
    assert by == "operations" and bound == pytest.approx(137.506062336e9 / 989e12 * 1e3)
    r = cs.rate_readings("flash_fwd", 128, 2048, 128, True, 0.5, bound)
    assert r["tflops"] == pytest.approx(275.012124672)
    assert r["bound_share"] == pytest.approx(bound / 0.5)
    # Small enough that moving the bytes takes longer than the products.
    assert cs.flash_bound("flash_fwd", 1, 16, 32, torch.bfloat16, True)[1] == "bytes"


def test_smoke_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("with a card, main() runs the whole smoke")
    assert cs.main() != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("kern", sorted(cs.PTXAS_ENTRY))
def test_ptxas_entries_name_kernels_of_the_source(kern):
    """Each entry the smoke reads registers and spills for names a kernel
    the source defines, at HD 128, so a renamed kernel is not read as
    absent."""
    import re
    from pathlib import Path

    source = cs.PAGED_KERNEL_SOURCE if kern.startswith("ragged") else cs.FLASH_KERNEL_SOURCE
    src = (Path(cs.__file__).parent / source).read_text()
    pat = cs.PTXAS_ENTRY[kern]
    name = re.match(r"\w+?_kernel", pat).group(0)
    assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s+{name}\(", src), name
    assert "Li128E" in pat, pat


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gate_fails_a_stale_ring_stage(causal):
    """The smoke's backward mutants at a small bf16 shape (S 256 in tiles
    of 64): dQ with K/V tile 1 counted in place of tile 2, dK/dV with Q/dO
    tile 1 counted twice. The flash gate (FLASH_TOL, unchanged) fails
    each, and the plain outputs themselves pass it."""
    from dstack_tpu_torch.workloads import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 256, 32), generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa._flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    refs = {"flash_bwd_dq": (fa._flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),),
            "flash_bwd_dkv": fa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)}
    tol = cs.FLASH_TOL[torch.bfloat16]
    mutants = cs.stale_stage_mutants(q, k, v, do, lse, delta, causal)
    got = cs.mutant_readings(mutants, refs, tol)
    assert got["flash_bwd_dq"]["caught"] and got["flash_bwd_dkv"]["caught"], got
    # When causal, what the stale stage cannot reach stays: dQ's rows before
    # the stale K/V tile (rows 128 ... 191), dK/dV's keys past the stale
    # Q/dO tile (the same rows).
    dq, (dk, dv) = mutants["flash_bwd_dq"][0], mutants["flash_bwd_dkv"]
    if causal:
        assert torch.equal(dq[:, :128], refs["flash_bwd_dq"][0][:, :128])
        assert torch.equal(dk[:, 192:], refs["flash_bwd_dkv"][0][:, 192:])
    assert not any(r["caught"] for r in cs.mutant_readings(refs, refs, tol).values())
    with pytest.raises(ValueError, match="two tiles"):
        cs.stale_stage_mutants(q[:, :100], k[:, :100], v[:, :100], do[:, :100],
                               lse[:, :100], delta[:, :100], causal)


def _paged_case(B, S, H, KV, hd, bs, MB, starts, dtype=torch.bfloat16):
    """What `paged_bound` and the readings read of a smoke case, on the
    CPU: slot b's row i attends positions < starts[b] + 1 + i."""
    vlen = torch.stack([torch.arange(s + 1, s + S + 1) for s in starts]).to(torch.int32)
    return dict(q=torch.zeros((B, S, H, hd), dtype=dtype),
                k=torch.zeros((4, bs, KV, hd), dtype=dtype),
                tables=torch.zeros((B, MB), dtype=torch.int32), vlen=vlen)


def test_paged_work_and_bound_at_the_chunk_shape():
    """The smoke's 128-token chunk at start 384 on smol-1b (H 16, KV 8, hd
    128, bf16, block 16, MB 128): K and V of 512 positions, q in and out,
    the table and the valid lengths; QK^T + PV over rows 385 .. 512."""
    case = _paged_case(1, 128, 16, 8, 128, 16, 128, [384])
    nbytes, ops = cs.paged_work(case)
    assert nbytes == 512 * 8 * 128 * 2 * 2 + 2 * 128 * 16 * 128 * 2 + 128 * 4 + 128 * 4
    assert nbytes == 3_146_752
    assert ops == sum(range(385, 513)) * 16 * 128 * 4 == 470_286_336
    bound, by = cs.paged_bound(case)
    assert by == "bytes" and bound == pytest.approx(3_146_752 / 3.35e12 * 1e3)


def test_paged_work_at_the_decode_shape():
    lens = [37, 200, 513, 1000, 1499, 1801, 2046, 64]
    nbytes, ops = cs.paged_work(_paged_case(8, 1, 16, 8, 128, 16, 128, lens))
    held = sum(lens) + 8
    assert nbytes == held * 8 * 128 * 4 + 2 * 8 * 16 * 128 * 2 + 8 * 128 * 4 + 8 * 4
    assert ops == held * 16 * 128 * 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_paged_gate_is_scale_free_and_fails_a_scaled_output(dtype):
    """A 1.6% scaling reads 1.6% whatever the rows' scale and fails
    PAGED_TOL, on every row and on the rows that read more than one KV
    split alone (what a combine that mis-weighs the splits leaves); sound
    noise of a bf16 rounding passes. The rows are the smoke's decode case:
    8 slots of 38 to 2047 positions, whose outputs scale as 1 / sqrt(len)."""
    g = torch.Generator().manual_seed(0)
    lens = torch.tensor([37, 200, 513, 1000, 1499, 1801, 2046, 64]) + 1
    ref = (torch.randn((8, 1, 16 * 128), generator=g, dtype=torch.float64)
           / lens.double().sqrt()[:, None, None])
    vlen = lens[:, None].to(torch.int32)
    tol = cs.PAGED_TOL[dtype]
    whole = cs.paged_readings(ref * cs.MUTATION_SCALE, ref, 16)
    for k in ("rel_l2", "row_rel", "row_l2"):
        assert whole[k] == pytest.approx(0.016)
    assert not cs.within(whole, tol)
    # Slots of 514 positions and more read 2 or more splits of 256: only
    # their rows scaled. One rel_l2 over the output reads ~0.3 of the 1.6%
    # (the short slots' larger rows dominate it) and row_rel's bf16 limit
    # is above 1.6%; row_l2 reads it in full and fails it.
    part = cs.paged_readings(cs.split_mutant(ref, vlen, 256), ref, 16)
    assert part["row_l2"] == pytest.approx(0.016) and part["row_rel"] == pytest.approx(0.016)
    assert part["rel_l2"] == pytest.approx(0.016 * 0.301, rel=0.05)
    if dtype == torch.bfloat16:
        assert part["rel_l2"] <= tol[0] and part["row_rel"] <= tol[1]
    assert not cs.within(part, tol)
    sound = cs.paged_readings(ref.to(torch.bfloat16).double(), ref, 16)
    assert cs.within(sound, cs.PAGED_TOL[torch.bfloat16])
    assert cs.within(cs.paged_readings(ref, ref, 16), tol)


def test_split_mutant_scales_every_row_where_none_reads_two_splits():
    got = torch.ones((2, 3, 8))
    vlen = torch.tensor([[1, 2, 3], [3, 4, 5]], dtype=torch.int32)
    some = cs.split_mutant(got, vlen, 3)
    assert some[1, 1:].eq(cs.MUTATION_SCALE).all() and some[0].eq(1).all()
    assert some[1, 0].eq(1).all()
    assert cs.split_mutant(got, vlen, 5).eq(cs.MUTATION_SCALE).all()


def _on_the_cpu(monkeypatch):
    """Phase 8 at tiny on the CPU: its device syncs become no-ops and the
    trainer's default device the CPU."""
    from dstack_tpu_torch.workloads import train

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(train, "_device_of", lambda device, mesh: torch.device("cpu"))


def test_checkpoint_phase_passes_a_sound_restore(monkeypatch):
    _on_the_cpu(monkeypatch)
    out = cs.run_checkpoint("tiny", 2, 32)
    assert out["restore_bit_exact"] and out["restored_step_count"] == (2, 2)
    assert out["file_bytes"] == out["state_bytes"] > 0
    assert out["step_bit_repeatable"] and out["gather_backward_repeatable"]
    assert len(out["leaves"]) == 36 and out["worst_rel_l2_b_a"] == 0.0


@pytest.mark.parametrize("which", [1, 2])
def test_checkpoint_phase_fails_a_restore_off_by_one_bit(monkeypatch, which):
    """A restore (the first or the second) that flips the lowest bit of
    one element of one moment fails the bitwise gate."""
    from dstack_tpu_torch.workloads import checkpoint as ckpt

    _on_the_cpu(monkeypatch)
    real, calls = ckpt.restore_latest, []

    def faulty(directory, template):
        state = real(directory, template)
        calls.append(1)
        if len(calls) == which:
            state.opt_state.mu["layers"]["wq"].view(torch.int32).view(-1)[7] ^= 1
        return state

    monkeypatch.setattr(ckpt, "restore_latest", faulty)
    with pytest.raises(AssertionError, match="restore is not the saved state"):
        cs.run_checkpoint("tiny", 2, 32)


def test_checkpoint_phase_fails_a_step_from_a_restore_that_differs(monkeypatch):
    """Steps from both restores ((b) and (c)) land one bit off the step
    from the state in memory (a), the same way each time: the step repeats
    ((b) = (c)), so (b) must equal (a), and the continuation gate fails."""
    from dstack_tpu_torch.workloads import train

    _on_the_cpu(monkeypatch)
    real_make = train.make_train_step

    def make(*a, **k):
        step, calls = real_make(*a, **k), []

        def stepped(state, batch):
            state, m = step(state, batch)
            calls.append(1)
            if len(calls) >= 4:  # 2 warm-up steps, (a), then (b) and (c)
                with torch.no_grad():
                    state.params["layers"]["wq"].view(torch.int16).view(-1)[3] ^= 1
            return state, m

        return stepped

    monkeypatch.setattr(train, "make_train_step", make)
    with pytest.raises(AssertionError, match="not the step from the saved state"):
        cs.run_checkpoint("tiny", 2, 32)


def test_drain_trainer_is_python_and_names_the_contract():
    import ast

    ast.parse(cs.DRAIN_TRAINER)
    for name in ("install_drain_handler", "checkpoint_and_exit", "restore_latest",
                 "compile_cache.snapshot"):
        assert name in cs.DRAIN_TRAINER
    assert cs.TRAIN_STAGES == ["tpu_init", "compile_start", "compile_end", "first_step"]


# -- phases 3 (verify), 4b, 4c and 5b ---------------------------------------------


def test_paged_work_at_the_verify_shape():
    """The speculative verify's window (B 8, S 5): each slot's K/V read
    once up to its longest row, every row's keys counted in the ops."""
    starts = [101, 300, 517, 999, 1203, 1640, 1888, 2042]
    nbytes, ops = cs.paged_work(_paged_case(8, 5, 16, 8, 128, 16, 128, starts))
    held = sum(starts) + 8 * 5
    assert nbytes == held * 8 * 128 * 4 + 2 * 8 * 5 * 16 * 128 * 2 + 8 * 128 * 4 + 40 * 4
    assert ops == sum(s + 1 + i for s in starts for i in range(5)) * 16 * 128 * 4


def test_paged_work_at_the_block_32_decode_shape():
    """Phase 3's block-32 decode (service.yml's shape: B 32, S 1, MB
    2048/32): each slot's K/V read once, one row per slot."""
    lens = [37 + 63 * i for i in range(32)]
    nbytes, ops = cs.paged_work(_paged_case(32, 1, 16, 8, 128, 32, 64, lens))
    held = sum(lens) + 32
    assert nbytes == held * 8 * 128 * 4 + 2 * 32 * 16 * 128 * 2 + 32 * 64 * 4 + 32 * 4
    assert ops == held * 16 * 128 * 4


@pytest.fixture(scope="module")
def tiny():
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.generate import generate
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = init_params(cfg, 0, "cpu")
    prompt = cs.byte_prompt(3, 20)
    stream = generate(cfg, params, torch.tensor([prompt]), max_new_tokens=12)[0].tolist()
    return cfg, params, prompt, stream


def test_near_tie_rule_passes_a_tie_and_fails_a_genuine_divergence(tiny):
    """At the first differing position the rule reads the dense forward's
    gap between the two tokens against tol x max |logit|: the runner-up
    token, followed by the dense argmax on its own prefix, passes at a tol
    just above its gap (and fails just below it); the same tie followed
    by tokens off the dense argmax fails on its own prefix; the
    lowest-logit token fails at bf16's tol; equal streams pass and a short
    stream fails."""
    from dstack_tpu_torch.workloads.generate import generate

    cfg, params, prompt, stream = tiny
    at = 5
    logits = cs.dense_logits(cfg, params, prompt + stream[:at])
    assert int(logits.argmax()) == stream[at]
    runner_up = int(logits.topk(2).indices[1])
    gap = float((logits[stream[at]] - logits[runner_up]) / logits.abs().max())
    head = prompt + stream[:at] + [runner_up]
    tie = stream[:at] + [runner_up] + generate(
        cfg, params, torch.tensor([head]), max_new_tokens=len(stream) - at - 1)[0].tolist()
    assert len(tie) == len(stream) and tie[at + 1:] != stream[at + 1:]
    r = cs.near_tie(cfg, params, prompt, stream, tie, gap * 1.001)
    assert r["ok"] and r["diverged"] and r["at"] == at and r["gap"] == pytest.approx(gap)
    # worst reads every prefix in one causal forward, gap the prefix's own
    assert r["worst"] == pytest.approx(gap, rel=1e-4)
    assert not cs.near_tie(cfg, params, prompt, stream, tie, gap * 0.999)["ok"]
    off = tie[:at + 1] + [int(cs.dense_logits(cfg, params, head).argmin())] + tie[at + 2:]
    r = cs.near_tie(cfg, params, prompt, stream, off, gap * 1.001)
    assert not r["ok"] and r["gap"] == pytest.approx(gap) and r["worst"] > 10 * gap
    assert cs.near_tie(cfg, params, prompt, stream, stream, 0.0) == dict(
        diverged=False, worst=0.0, ok=True)
    assert not cs.near_tie(cfg, params, prompt, stream, stream[:-1], 1.0)["ok"]
    tol = cs.ENGINE_LOGIT_TOL[torch.bfloat16]
    bad = cs.rule_fails_a_genuine_divergence(cfg, params, prompt, stream, tol)
    assert not bad["ok"] and bad["gap"] > tol
    with pytest.raises(AssertionError, match="past a near-tie"):
        cs.hold_streams(cfg, params, [prompt], [stream],
                        [stream[:6] + [int(logits.argmin())] + stream[7:]], tol, "test")
    held = cs.hold_streams(cfg, params, [prompt] * 2, [stream] * 2, [stream, tie],
                           gap * 1.001, "test")
    assert held == dict(divergences=1, max_gap=pytest.approx(gap), of=2, at=[at],
                        worst=pytest.approx(gap, rel=1e-4))


def test_service_argv_is_service_yml_verbatim_but_the_checkpoint():
    argv = cs.service_argv()
    assert argv == ["--preset", "smol-1b", "--port", "9000", "--model-name", "smol-1b-native",
                    "--prefill-chunk-tokens", "256", "--kv-block-size", "32", "--spec-enable",
                    "--spec-draft-preset", "int8", "--spec-max-draft", "4",
                    "--kv-host-budget-mb", "4096", "--max-resident-slots", "8", "--slots", "32",
                    "--qos-weight", "paid=4", "--qos-weight", "besteffort=1"]
    tiny = cs.service_argv("tiny", 0)
    assert tiny[:4] == ["--preset", "tiny", "--port", "0"] and tiny[4:] == argv[4:]


def test_service_messages_and_their_byte_prompts():
    from dstack_tpu_torch.native_server import chat_text, encode_text

    msgs = cs.service_messages()
    texts = [m[0]["content"] for m in msgs]
    assert len(texts) == 40 and all(32 <= len(t) <= 300 for t in texts)
    assert len({t[:64] for t in texts[:4]}) == 1 and len({t for t in texts[:4]}) == 4
    assert all(t[:64] != texts[0][:64] for t in texts[4:])
    prompts = [encode_text(chat_text(m), 32768, 2048, 64) for m in msgs]
    # The 4 sharers land in one bucket, so their byte prompts share a block.
    assert len({len(p) for p in prompts[:4]}) == 1 and prompts[0][:32] == prompts[3][:32]


def test_block_bytes_and_ttft_readings():
    from dstack_tpu_torch.workloads.config import PRESETS

    assert cs.block_bytes(PRESETS["smol-1b"], 16) == 1 << 20
    assert cs.block_bytes(PRESETS["smol-1b"], 32) == 2 << 20
    trace = {"phases": [{"phase": "queue_wait", "start_s": 0.0, "duration_s": 0.5},
                        {"phase": "prefill", "start_s": 0.5, "duration_s": 0.25},
                        {"phase": "decode", "start_s": 0.75, "duration_s": 2.0}]}
    assert cs.ttft_of(trace) == 0.75


def test_preempt_phase_rewrites_the_freed_blocks_and_resumes_byte_exact(monkeypatch):
    """Phase 4c(b) on the CPU at tiny f32: the parked slot's freed blocks
    are taken and written by the second request before readmission, and
    the chain comes back byte for byte in both pools."""
    import functools

    from dstack_tpu_torch.workloads import serving
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    monkeypatch.setattr(serving, "ServingEngine",
                        functools.partial(serving.ServingEngine, device="cpu"))
    cfg = PRESETS["tiny"].with_(dtype="float32")
    r = cs.run_preempt_bytes(cfg, init_params(cfg, 0, "cpu"), bs=8, prompt_len=40,
                             other_len=200)
    assert r["byte_exact"] and r["tokens"] == 64 and r["pools"] == [
        "draft_k", "draft_v", "k", "v"]
    assert 0 < r["freed_blocks_rewritten"] <= r["freed_blocks"]


# -- phases 9-10b: LoRA ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_module_gate_passes_the_sound_delta_and_fails_both_mutants(dtype):
    """Phase 9(a) at tiny on the CPU: project_qkv_lora within the gate of
    its per-row plain version at the decode batch and the 128-token chunk,
    base rows equal to project_qkv, and both mutants (indices rolled by a
    row, -1 read from bank slot 0) failing it."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.lora_serving import AdapterRegistry
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"].with_(dtype=dtype, max_seq_len=512)
    params = init_params(cfg, 0, "cpu")
    adapters = cs.demo_adapters(cfg, params, ("t1", "t2", "t3", "t0"))
    reg = AdapterRegistry(cfg, params, max_adapters=cs.LORA_MAX_ADAPTERS, rank=cs.LORA_RANK,
                          targets=cs.LORA_TARGETS)
    for name, ad in adapters.items():
        reg.load(name, ad, alpha=cs.LORA_ALPHA)
    assert reg.slot_of("t0") == 0
    r = cs.lora_module_check(cfg, params, reg, adapters)
    assert r["ok"], r
    assert len(r["cases"]) == 10 and all(c["ok"] for c in r["cases"])
    assert all(c["base_rows_bit_exact"] for c in r["cases"] if c["case"] == "decode")
    assert len(r["mutants"]) == 4 and all(m["fails_gate"] for m in r["mutants"].values())
    tol = cs.LORA_DELTA_TOL[cfg.activation_dtype]
    assert min(m["row_rel"] for m in r["mutants"].values()) > 10 * tol[1]


def test_lora_readings_are_scale_free():
    ref = [torch.randn(3, 4, 2, 8) for _ in range(3)]
    got = [t * 1.01 for t in ref]
    r = cs.lora_readings(got, ref)
    assert r["rel_l2"] == pytest.approx(0.01, rel=1e-4)
    assert r["row_rel"] == pytest.approx(0.01, rel=1e-4)
    big = cs.lora_readings([t * 1e3 for t in got], [t * 1e3 for t in ref])
    assert big["rel_l2"] == pytest.approx(r["rel_l2"], rel=1e-5)


def test_step_flops_of_the_full_and_the_lora_step():
    """The full step from the step's products is flops_per_token's count;
    the LoRA step keeps the forward, the activations' and attention's
    gradients, the targets' weight gradients and the merge."""
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS["smol-1b"]
    full, _ = cs.step_flops(cfg, 8, 2048)
    assert full == cfg.flops_per_token(2048) * 8 * 2048
    assert full == pytest.approx(87.4e12, rel=2e-3)
    lora, formula = cs.step_flops(cfg, 8, 2048, cs.LORA_TARGETS, cs.LORA_RANK)
    d, hd, T, L = 2048, 128, 8 * 2048, 16
    dw = L * 2 * d * (16 * hd + 8 * hd) * T
    merge = 3 * 2 * L * d * 8 * (16 * hd + 8 * hd)
    attn_fwd = L * 2 * 2048 * 16 * hd * T
    # Two forwards (the forward, the activations' gradients), attention's
    # backward a forward more, the targets' weight gradients and the merge.
    assert lora == pytest.approx(2 * full / 3 + attn_fwd + dw + merge, rel=1e-12)
    assert 0.6 < lora / full < 0.75 and "B S" in formula


def test_preempt_phase_on_an_adapter_restores_its_bank_slot(monkeypatch):
    """Phase 9(d) on the CPU at tiny f32: the parked request runs on t1,
    readmission restores t1's bank slot, no adapter ref is left, and the
    chain comes back byte for byte in both pools."""
    import functools

    from dstack_tpu_torch.workloads import serving
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    monkeypatch.setattr(serving, "ServingEngine",
                        functools.partial(serving.ServingEngine, device="cpu"))
    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = init_params(cfg, 0, "cpu")
    r = cs.run_preempt_bytes(cfg, params, bs=8, prompt_len=40, other_len=200,
                             adapters=cs.demo_adapters(cfg, params))
    assert r["adapter"] == "t1" and r["readmitted_adapter_ix"] == cs.LORA_MAX_ADAPTERS - 1
    assert r["byte_exact"] and r["tokens"] == len(r["stream"]) == 64


def test_lora_drain_phase_drains_resumes_and_serves_the_merged_export():
    """Phase 10b's drain on the CPU at tiny: `fine_tune --lora-rank 8` in a
    subprocess exits 113 on SIGTERM with an adapter checkpoint, a relaunch
    resumes at that step and exports the merged params, and native_server
    serves a chat from the export."""
    r = cs.run_lora_drain("tiny", 64, ["--device", "cpu"])
    assert r["launch1"]["rc"] == 113 and r["launch1"]["checkpoint_groups"] == ["lora", "mu", "nu"]
    assert r["launch2"]["rc"] == 0 and r["serve"] == {**r["serve"], "code": 200,
                                                     "weights_via": "packed"}


# -- phases 5 and 11: affinity, QoS, disaggregation ---------------------------------


def test_affinity_check_finds_the_served_chain_and_fails_a_missing_one():
    from dstack_tpu_torch.workloads.kv_blocks import BlockAllocator

    tokens = cs.byte_prompt(5, 40)
    a = BlockAllocator(8, 16)
    a.insert_full(tokens, [a.alloc() for _ in range(3)])
    sketch = {"block_size": 16, "digests": a.affinity_digests(), "adapters": []}
    assert cs.chain_digests(tokens, 16) == sketch["digests"]
    assert cs.affinity_check(sketch, tokens) is sketch
    with pytest.raises(AssertionError, match="lacks the served prompt"):
        cs.affinity_check({**sketch, "digests": sketch["digests"][:1]}, tokens)
    with pytest.raises(AssertionError, match="lacks the served prompt"):
        cs.affinity_check(sketch, cs.byte_prompt(6, 40))
    # Another namespace chains other digests.
    assert cs.chain_digests(tokens, 16, b"t1")[0] not in sketch["digests"]


@pytest.mark.parametrize("codes,ok", [
    ([(200, None), (429, "1"), (429, "2")], True),
    ([(200, None)] * 6, False),            # no shed: the gate is off
    ([(200, None), (429, None)], False),   # a 429 without Retry-After
    ([(200, None), (429, "1"), (500, None)], False),
])
def test_qos_check(codes, ok):
    if ok:
        cs.qos_check(codes)
    else:
        with pytest.raises(AssertionError):
            cs.qos_check(codes)


@pytest.mark.parametrize("rate,ok", [(1.0, True), (0.0, False)])
def test_qos_phase_sheds_a_burst_and_fails_without_the_gate(rate, ok):
    """Phase 5's QoS run at tiny on the CPU: with --qos-rate 1 --qos-burst 2
    the burst gets 429s and the other tenant a 200; with the gate off the
    phase fails."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import init_params

    params = init_params(PRESETS["tiny"], 0, "cpu")
    if ok:
        r = cs.run_qos(params, qos_rate=rate, preset="tiny")
        assert r["other"] == 200 and r["qos"]["shed_total"]["flood"] >= 1
    else:
        with pytest.raises(AssertionError, match="no 429"):
            cs.run_qos(params, qos_rate=rate, preset="tiny")


def test_disagg_requests_carry_the_awkward_lengths():
    reqs = cs.disagg_requests(32)
    assert [len(p) for p, _ in reqs[:8]] == [len(p) for p in cs.engine_prompts()]
    (p1, n1), (p2, n2), (p3, n3), (p4, n4) = reqs[8:]
    assert len(p1) % 16 and len(p2) % 128 == 2
    assert len(p3) % 16 == 0 and (len(p3) + n3 - 1) // 16 > len(p3) // 16
    assert n4 == 1


def test_tier_launch_and_byte_gates():
    cs.check_tier_launches(10, {"prefill": 4, "decode": 6})
    for launches, by_tier in ((0, {"prefill": 0, "decode": 0}),
                              (10, {"prefill": 10, "decode": 0}),
                              (11, {"prefill": 4, "decode": 6})):
        with pytest.raises(AssertionError):
            cs.check_tier_launches(launches, by_tier)
    cs.check_bytes(100, 100, 100)
    for sent, got, wire in ((0, 0, 0), (100, 99, 100), (100, 100, 101)):
        with pytest.raises(AssertionError):
            cs.check_bytes(sent, got, wire)


@pytest.fixture(scope="module")
def handoff():
    """A tiny f32 prefill tier's handoff of a 45-token prompt (3 blocks of
    16, a tail of 13)."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = init_params(cfg, 0, "cpu")
    got = []

    class Capture:
        def send(self, h):
            got.append(h)

    eng = ServingEngine(cfg, params, device="cpu", role="prefill", kv_transfer=Capture(),
                        slots=2, max_len=128, kv_block_size=16)
    try:
        out = eng.submit(cs.byte_prompt(8, 45), 4, request_id=1)
        assert out.get(timeout=60) is None
    finally:
        eng.close()
    return cfg, params, got[0]


def test_handoff_gate_passes_the_payload_and_fails_its_faults(handoff):
    """The sound handoff reads within tol; the tail block exchanged with a
    full one and a zeroed block read beyond it. Two full blocks exchanged
    read the sound value: the pairs carry their rope, so attention sees the
    same set in another order."""
    cfg, params, h = handoff
    tol = cs.ENGINE_LOGIT_TOL[torch.float32]
    r = cs.check_handoff_gate(cfg, params, h, tol)
    assert r["sound"] <= tol and r["tail_swapped"] > tol and r["block_zeroed"] > tol
    assert r["full_blocks_swapped"] == pytest.approx(r["sound"], abs=1e-6)
    with pytest.raises(AssertionError, match="sound handoff"):
        cs.check_handoff_gate(cfg, params, h._replace(k=h.k * 1.1), tol)


def test_handoff_gate_fails_when_a_fault_reads_sound(handoff, monkeypatch):
    cfg, params, h = handoff
    monkeypatch.setattr(cs, "handoff_mutants", lambda h: {
        "tail_swapped": h, "block_zeroed": h, "full_blocks_swapped": h})
    with pytest.raises(AssertionError, match="passes a faulty payload"):
        cs.check_handoff_gate(cfg, params, h, cs.ENGINE_LOGIT_TOL[torch.float32])


def test_tail_swapped_handoff_through_the_decode_engine_fails_the_near_tie_rule():
    """A sound handoff through the tiers streams the unified engine's
    tokens; the same request with its handoff's tail block exchanged on
    the way out goes through the decode engine's admission and its stream
    fails the near-tie rule; both leave zero residue."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = init_params(cfg, 0, "cpu")
    kw = dict(device="cpu", slots=2, max_len=128, kv_block_size=16)
    p, n = cs.byte_prompt(40, 29), 20
    uni = ServingEngine(cfg, params, **kw)
    tiers = cs.Tiers(cfg, params, **kw)
    try:
        good = cs.drain(uni.submit(p, n, temperature=0.0))[0]
        rid, q = tiers.submit(p, n)
        assert tiers.collect(rid, q, n)[0] == good
        rid, q = tiers.submit(p, n, fault="tail_swapped")
        bad = tiers.collect(rid, q, n)[0]
        assert not tiers.faults and len(bad) == n
        tol = cs.ENGINE_LOGIT_TOL[torch.bfloat16]
        with pytest.raises(AssertionError, match="past a near-tie"):
            cs.hold_streams(cfg, params, [p], [good], [bad], tol, "test")
        # The first divergence alone is a near-tie; the tokens after it
        # are not (the rule's own-prefix check is what fails the fault).
        r = cs.near_tie(cfg, params, p, good, bad, tol)
        assert r["gap"] <= tol < r["worst"]
        whole = cs.byte_prompt(41, 32)  # whole blocks: no tail to exchange
        reqs = [(p, n), (whole, 8), (p, 1)]
        refs = [good, cs.drain(uni.submit(whole, 8, temperature=0.0))[0], good[:1]]
        sweep = cs.fault_sweep(cfg, params, tiers, reqs, refs, tol)
        assert [s is not None for s in sweep["tail_swapped"]["streams"]] == [True, False, False]
        assert sweep["tail_swapped"]["faults"] == 1
        assert sweep["block_zeroed"]["faults"] == 2
        for v in sweep.values():
            assert v["near_tie_rule_passes"] <= v["first_divergence_rule_passes"]
        cs.wait_zero_residue([tiers.pre, tiers.dec], timeout=5)
    finally:
        tiers.close()
        uni.close()


def test_zero_residue_gate_fails_a_leaked_block():
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"].with_(dtype="float32")
    eng = ServingEngine(cfg, init_params(cfg, 0, "cpu"), device="cpu", slots=1,
                        max_len=64)
    try:
        cs.wait_zero_residue([eng], timeout=0.1)
        leaked = eng._alloc.alloc()
        with pytest.raises(AssertionError, match="block residue"):
            cs.wait_zero_residue([eng], timeout=0.1)
        eng._alloc.release(leaked)
    finally:
        eng.close()


# -- phase 12: Podracer RL ----------------------------------------------------------


def _tiny_rl_params(seed=0):
    from dstack_tpu_torch.workloads.rl import tiny_rl_config
    from dstack_tpu_torch.workloads.transformer import init_params

    return init_params(tiny_rl_config(), seed, "cpu")


def test_adoption_gate_holds_sha1_per_leaf_and_fails_a_flipped_bit():
    from dstack_tpu_torch.workloads.rl import named_params

    named = named_params(_tiny_rl_params())
    published = cs.leaf_digests(named)
    cs.check_adopted(published, cs.leaf_digests(named))
    bad = named[0][1].clone()
    bad.view(torch.uint8).view(-1)[5] ^= 1
    with pytest.raises(AssertionError, match="differ"):
        cs.check_adopted(published, {**published, **cs.leaf_digests([(named[0][0], bad)])})
    with pytest.raises(AssertionError, match="differ"):
        cs.check_adopted(published, dict(list(published.items())[1:]))


def test_moved_gate_fails_an_update_that_moves_nothing():
    cs.check_moved({"a": "1", "b": "2"}, {"a": "1", "b": "3"})
    with pytest.raises(AssertionError, match="moved no weight"):
        cs.check_moved({"a": "1"}, {"a": "1"})


def test_isolation_gate_compares_bits():
    a = {"x": torch.tensor([0.0, 1.0]), "y": torch.ones(3, dtype=torch.bfloat16)}
    before = cs.leaf_digests(a.items())
    cs.check_unchanged(before, cs.leaf_digests((k, v.clone()) for k, v in a.items()), "w")
    with pytest.raises(AssertionError, match="w changed"):  # == but not bits
        cs.check_unchanged(before, cs.leaf_digests({**a, "x": torch.tensor([-0.0, 1.0])}.items()),
                           "w")


def test_clip_fraction_is_the_ppo_steps_and_the_on_policy_gate_fails_a_shift():
    import numpy as np

    from dstack_tpu_torch.workloads import rl

    cfg = rl.tiny_rl_config()
    learner = rl.Learner(cfg, clip_eps=cs.RL_CLIP, device="cpu")
    tokens = torch.randint(1, 64, (3, 12), generator=torch.Generator().manual_seed(0))
    logp = rl.make_sequence_scorer(cfg)(learner.state.params, tokens, 1.0)[:, 3:]
    batch = rl.TrajectoryBatch(tokens.numpy(), tokens[:, 4:].numpy(), logp.numpy(),
                               np.ones((3, 8), np.float32), np.ones((3, 8), np.float32),
                               4, 0, 0)
    assert cs.policy_clip_fraction(learner, batch) == 0.0
    cs.check_on_policy(0.0)
    shifted = batch._replace(behavior_logprob=np.roll(batch.behavior_logprob, 1, 1))
    frac = cs.policy_clip_fraction(learner, shifted)
    assert "clip_fraction" in cs.must_fail(cs.check_on_policy, frac)
    assert learner.update_from([shifted])["clip_fraction"] == pytest.approx(frac, abs=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rl_model_gate_passes_plain_and_fails_each_attention_mutant(monkeypatch, dtype):
    """Phase 12's kernel gate at the RL shapes, on the CPU (where the
    kernels' attention is plain, so the sound reading is exact): each
    mutant of rl_attention_mutants fails it, at the smol-1b case's shapes
    (tiny's width) and the tiny policy's."""
    from dstack_tpu_torch.workloads.config import PRESETS

    monkeypatch.setattr(cs, "RL_DEVICE", "cpu")
    monkeypatch.setitem(PRESETS, "tiny-x", PRESETS["tiny"].with_(dtype=dtype))
    monkeypatch.setattr(cs, "RL_MODEL_CASES", (("tiny-x", cs.RL_BATCH, 64, 64),
                                               cs.RL_MODEL_CASES[1]))
    out = cs.run_rl_model_checks()
    assert ("vs_f32" in out["tiny-x"]) == (dtype == "bfloat16")
    assert [c["seq"] for c in out.values()] == [127, 19]
    for case in out.values():
        assert case["logp_max_abs"] == 0.0 and case["loss_rel"] == 0.0
        assert case["clip_fraction"] == 0.0  # on policy
        assert sorted(case["mutants"]) == ["last_row_lost", "mask_one_late", "tail_dq_lost"]
        assert all("disagree" in m["fails"] for m in case["mutants"].values())


@pytest.mark.parametrize("rewards,ok", [
    ([0.0] * 5 + [0.5] * 5, True),
    ([0.0] * 5 + [0.2] * 5, False),      # improves but stays under 0.3
    ([0.6] * 5 + [0.5] * 5, False),      # above 0.3 but no better than the start
])
def test_learning_gate(rewards, ok):
    if ok:
        assert cs.learning_gate(rewards)["tail"] == pytest.approx(0.5)
    else:
        with pytest.raises(AssertionError, match="no learning"):
            cs.learning_gate(rewards)


def test_first_difference():
    assert cs.first_difference([1, 2, 3], [1, 2, 3]) is None
    assert cs.first_difference([1, 2, 3], [1, 5, 3]) == 1


def _drill_summary(**kw):
    base = {"ok": True, "learner_restarts": 0, "gang_resizes": 2, "preemptions": 1,
            "final_weight_epoch": 3, "actor_final_epochs": {"0": 3, "1": 0, "2": 3}}
    return {**base, **kw}


@pytest.mark.parametrize("kw,ok", [
    ({}, True),
    ({"gang_resizes": 1}, False),
    ({"learner_restarts": 1}, False),
    ({"actor_final_epochs": {"0": 3, "1": 0, "2": 2}}, False),
    ({"ok": False}, False),
])
def test_rl_drill_summary_gate(kw, ok):
    if ok:
        cs.check_rl_drill(_drill_summary(**kw))
    else:
        with pytest.raises(AssertionError, match="drill"):
            cs.check_rl_drill(_drill_summary(**kw))


def test_rl_phase_runs_its_gates_on_the_cpu(monkeypatch, tmp_path):
    """12(a)'s instrumented Anakin at tiny on the CPU (the kernels' launch
    gate needs the card): adoptions held by sha1, isolation, and each new
    gate failing its fault."""
    monkeypatch.setattr(cs, "RL_DEVICE", "cpu")
    from dstack_tpu_torch.workloads.config import PRESETS

    out = cs.rl_channel_run(PRESETS["tiny"], "socket", 2, str(tmp_path), isolation=True)
    assert out["clip_fraction"] == [0.0, 0.0] and out["max_logp_gap"] == [0.0, 0.0]
    assert out["adoptions"] == 3 and len(out["pull_s"]) == 3
    assert out["target_share"] > 0
    for fault in ("isolation_fault", "weights_fault", "on_policy_fault", "busy_refusal",
                  "moved_fault"):
        assert out[fault], fault
    assert out["frame_bytes"] > sum(t.numel() * t.element_size() for t in
                                    _tiny_rl_params().values() if isinstance(t, torch.Tensor))


# -- phase 13: mixture-of-experts --------------------------------------------


def _moe_layer(cf, dtype="bfloat16"):
    from dstack_tpu_torch.workloads.config import PRESETS

    c = PRESETS["tiny-moe"].with_(capacity_factor=cf, dtype=dtype)
    return c, cs.moe_layer(c, 0, "cpu")


def test_routing_flips_counts_tokens_whose_expert_sets_differ():
    a = torch.tensor([[[0, 1], [2, 3], [1, 0], [3, 2]]])
    b = torch.tensor([[[1, 0], [2, 1], [1, 0], [0, 2]]])
    assert cs.routing_flips(a, a) == 0
    assert cs.routing_flips(a, b) == 2  # the order within a token is no flip


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_loop_reference_holds_moe_mlp_and_fails_each_mutant(impl):
    """The per-expert f32 loop against moe_mlp on the CPU at bf16 (the
    13a gate's limits) with nothing dropped and with drops, and each of
    13a's faults failing the gate."""
    from dstack_tpu_torch.workloads import moe

    for cf, S, faults in ((2.0, 16, {"choices": 1, "normalise": False}),
                          (cs.MOE_DROP_CF, 128, {"honour_drops": False})):
        c, p = _moe_layer(cf)
        h = torch.randn((1, S, c.d_model), generator=torch.Generator().manual_seed(S)).to(
            torch.bfloat16)
        ref, dropped = cs.moe_loop_reference(c, h, p)
        assert (dropped > 0) == (cf < 2.0)
        got, _ = moe.moe_mlp(c.with_(moe_impl=impl), h, p)
        cs.check_moe(cs.moe_readings(got, ref), cs.MOE_LOOP_TOL)
        for name, kw in faults.items():
            bad, _ = cs.moe_loop_reference(c, h, p, **{name: kw})
            assert "past" in cs.must_fail(cs.check_moe, cs.moe_readings(bad, ref),
                                          cs.MOE_LOOP_TOL, name)


def test_moe_loop_reference_equals_moe_mlp_in_f32():
    from dstack_tpu_torch.workloads import moe

    c, p = _moe_layer(1.25, "float32")
    p = {k: v.float() for k, v in p.items()}
    h = torch.randn((2, 32, c.d_model), generator=torch.Generator().manual_seed(1))
    ref, dropped = cs.moe_loop_reference(c, h, p)
    got, _ = moe.moe_mlp(c, h, p)
    assert dropped > 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_routing_spy_records_and_pins():
    """RoutingSpy records each call's routing; pinned to a run's own
    routing it reproduces that run bit for bit, pinned to other experts it
    does not, and its calls wrap around (a remat recompute)."""
    from dstack_tpu_torch.workloads import moe
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.transformer import forward, init_params

    c = PRESETS["tiny-moe"].with_(dtype="float32")
    params = init_params(c, 0, "cpu")
    tok = torch.randint(0, c.vocab_size, (1, 24), generator=torch.Generator().manual_seed(0))
    real = moe.route_assignments
    with torch.no_grad(), cs.RoutingSpy() as spy:
        want = forward(c, params, tok)
    assert moe.route_assignments is real
    assert [s for s, _, _ in spy.calls] == [24] * c.n_layers
    pinned = [idx for _, idx, _ in spy.calls]
    with torch.no_grad(), cs.RoutingSpy(pinned) as again:
        assert torch.equal(forward(c, params, tok), want)
        assert torch.equal(forward(c, params, tok), want)
    assert len(again.calls) == 2 * c.n_layers
    shifted = [pinned[0], (pinned[1] + 1) % c.n_experts]
    with torch.no_grad(), cs.RoutingSpy(shifted):
        assert not torch.allclose(forward(c, params, tok), want)
    assert cs.routing_flips(pinned[1], shifted[1]) == 24


def test_two_runs_gate_and_the_model_gate_fail_their_faults():
    streams = [[1, 2, 3], [4, 5, 6]]
    cs.two_runs_identical(streams, [list(s) for s in streams])
    assert "differ" in cs.must_fail(cs.two_runs_identical, streams, [[1, 2, 3], [4, 9, 6]])
    good = {"loss_rel": 1e-6, "worst": 1e-3, "worst_at": "embed"}
    cs.check_moe_model(good, cs.MODEL_TOL[torch.bfloat16])
    for bad in ({**good, "loss_rel": 1e-2}, {**good, "worst": 0.3}):
        assert "past" in cs.must_fail(cs.check_moe_model, bad, cs.MODEL_TOL[torch.bfloat16])


def test_moe_cf_all_admits_every_token_on_every_path():
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.moe import expert_capacity

    for name in ("tiny-moe", "smol-moe"):
        c = PRESETS[name]
        c = c.with_(capacity_factor=cs.moe_cf_all(c))
        for S in (1, 5, 128, 200, 2048):
            assert expert_capacity(c, S) >= S


def test_moe_model_check_runs_its_gates_on_the_cpu(monkeypatch):
    """13c's 2-layer check at tiny-moe's width on the CPU (the kernels'
    attention is plain here, so the sound reading is exact and flips are
    0): the pinned gate passes, the shifted-experts fault fails it."""
    from dstack_tpu_torch.workloads.config import PRESETS

    monkeypatch.setattr(cs, "MOE_PRESET", "tiny-moe")
    monkeypatch.setattr(cs, "MOE_DEVICE", "cpu")
    monkeypatch.setattr(cs, "expected_launches", lambda *a, **k: cs.flash_counts())
    assert PRESETS["tiny-moe"].n_layers == 2
    out = cs.run_moe_model_check(B=1, S=64)
    for tag in ("f32", "bf16"):
        assert out[tag]["loss_rel"] == 0.0 and out[tag]["flips"] == 0
        assert "past" in out[tag]["shifted_check"]


def test_moe_module_phase_runs_its_gates_on_the_cpu(monkeypatch):
    """13a at tiny-moe's width on the CPU (timing stubbed: it needs the
    card): both dispatches within the gates, and each of the four faults
    failing its gate."""
    monkeypatch.setattr(cs, "MOE_PRESET", "tiny-moe")
    monkeypatch.setattr(cs, "MOE_DEVICE", "cpu")
    monkeypatch.setattr(cs, "cuda_ms", lambda fns, n, graph=True: 0.0)
    out = cs.run_moe_module()
    assert all(r["aux_equal"] for r in out["paths"].values())
    assert sorted(out["mutants"]) == ["drop_not_zeroed", "gate_unnormalised",
                                      "paths_second_choice_dropped", "second_choice_dropped"]
    assert out["loop"]["drops_einsum"]["dropped"] > 0
    assert out["loop"]["all_admitted_gather"]["dropped"] == 0


# -- phase 14: tensor-parallel serving ------------------------------------------------


def test_tp_rank_launcher_kills_a_rank_past_its_timeout():
    import subprocess
    import sys
    import time

    procs = [subprocess.Popen([sys.executable, "-c", code], start_new_session=True)
             for code in ("import time; time.sleep(60)", "pass")]
    t0 = time.monotonic()
    codes = cs.wait_ranks(procs, timeout=2.0)
    assert time.monotonic() - t0 < 20
    assert codes[0] < 0 and codes[1] == 0  # the sleeper was killed
    assert all(p.poll() is not None for p in procs)


def test_tp_swap_mutant_reverses_the_ranks_heads_and_undoes():
    from dstack_tpu_torch.workloads import kv_blocks, sharding, transformer

    mesh = sharding.Mesh(torch.device("cpu"), dict(zip(sharding.AXES, (1, 1, 1, 2, 1))),
                         group=object(), rank=0, backend="gloo")
    attn = torch.arange(4.0).reshape(1, 1, 4)        # rank 0's two heads of width 2
    other = attn + 100                               # rank 1's
    wo = torch.eye(8)                                # (H*hd, D/2 of each rank): identity
    calls = []

    def fake_gather(x, dim, m):                      # two ranks: x then its twin
        calls.append(x.shape)
        return torch.cat([x, x + 100 if len(calls) == 1 else x], dim)

    orig_gather, orig_out = sharding.all_gather, kv_blocks.attn_out
    sharding.all_gather = transformer.all_gather = fake_gather
    try:
        want = kv_blocks.attn_out(attn, {"wo": wo}, mesh)
        calls.clear()
        undo = cs.tp_swap_attn_out()
        got = kv_blocks.attn_out(attn, {"wo": wo}, mesh)
        undo()
    finally:
        sharding.all_gather = transformer.all_gather = orig_gather
    assert kv_blocks.attn_out is orig_out
    assert torch.equal(want[..., :8], torch.cat([attn, other], -1))
    assert torch.equal(got[..., :8], torch.cat([other, attn], -1))


def test_tp_counters_survive_the_heartbeat_and_zero_on_their_own_op():
    """The idle heartbeat's no-op leaves phase 14's counts alone; only the
    smoke's own op zeroes them, and undo removes that op."""
    from dstack_tpu_torch.workloads import paged_attention as pa
    from dstack_tpu_torch.workloads import serving

    class FakeMesh:
        stats = {"all_gathers": 0, "all_gather_seconds": 0.0, "broadcasts": 0}

    class Eng:
        _steps_per_sync = 2

    mesh, eng, cls = FakeMesh(), Eng(), serving.ServingEngine
    orig_decode, saved = cls._op_decode, pa.LAUNCHES["ragged_paged_attention"]

    def fake_decode(self, *a):
        pa.LAUNCHES["ragged_paged_attention"] += 4
        mesh.stats["all_gathers"] += 3

    cls._op_decode = fake_decode
    try:
        counts, undo = cs.tp_count_ops(serving, pa, mesh)
        cls._op_decode(eng)
        cls._op_noop(eng)                       # a heartbeat in the window
        assert counts["per_step"] == [2.0] and counts["decode_gathers"] == 3
        assert pa.LAUNCHES["ragged_paged_attention"] == saved + 4
        cls._op_tp_zero_counts(eng)
        assert counts["per_step"] == [] and pa.LAUNCHES["ragged_paged_attention"] == 0
        undo()
        assert not hasattr(cls, "_op_tp_zero_counts") and cls._op_decode is fake_decode
    finally:
        cls._op_decode = orig_decode
        pa.LAUNCHES["ragged_paged_attention"] = saved


def _tp_result(**kw):
    r = dict(mutant=False, n_layers=16, streams_held={"divergences": 0}, streams_error=None,
             pool=dict(rel_l2=0.0, row_rel=0.0, tol=(1e-2, 1e-1)),
             ranks=[dict(per_step=[16.0] * 3, launches=48)] * 2, token_counts=[cs.TP_NEW] * 8)
    r.update(kw)
    return r


@pytest.mark.parametrize("bad", [
    dict(ranks=[dict(per_step=[16.0, 15.0], launches=31), dict(per_step=[16.0], launches=16)]),
    dict(pool=dict(rel_l2=0.5, row_rel=0.0, tol=(1e-2, 1e-1))),
    dict(streams_held=None, streams_error="stream 0 diverges past a near-tie"),
    dict(mutant=True),                                  # a mutant both gates pass
    dict(mutant=True, streams_held=None, streams_error="x"),  # the pool gate passes it
    dict(token_counts=[cs.TP_NEW - 1] + [cs.TP_NEW] * 7),
])
def test_tp_gates_fail_what_they_must(bad):
    cs.check_tp({"good": _tp_result()})
    with pytest.raises(AssertionError):
        cs.check_tp({"bad": _tp_result(**bad)})


# -- phase 15: training across ranks ----------------------------------------------------


def _train_mesh(rank=0, **axes):
    from dstack_tpu_torch.workloads import sharding

    shape = {a: axes.get(a, 1) for a in sharding.AXES}
    return sharding.Mesh(torch.device("cpu"), shape, group=object(), rank=rank,
                         backend="gloo", layout="training")


def test_tr_mutants_skip_their_sums_and_undo():
    from dstack_tpu_torch.workloads import sharding, transformer

    orig_rs, orig_rm = sharding.reduce_scatter, transformer.reduce_model
    undo = cs.tr_mutate("fsdp")
    try:
        x = torch.arange(12.0).reshape(3, 4)
        got = sharding.reduce_scatter(x, 1, _train_mesh(rank=1, fsdp=2), ("fsdp",))
        assert torch.equal(got, x[:, 2:])   # rank 1's own block, not summed
    finally:
        undo()
    assert sharding.reduce_scatter is orig_rs
    undo = cs.tr_mutate("model")
    try:
        y = torch.ones(2)
        assert transformer.reduce_model(y, _train_mesh(model=2)) is y
    finally:
        undo()
    assert transformer.reduce_model is orig_rm
    cs.tr_mutate(None)()


def _tr_case(**kw):
    rank = dict(loss=10.0, grad_norm=3.0, launches_per_step=dict(
        flash_fwd=16.0, flash_bwd_dq=16.0, flash_bwd_dkv=16.0, flash_block_fwd=0.0),
        kernel_shapes={"flash_fwd": [[cs.TR_B * 8, cs.TR_S, 128]]})
    r = dict(ranks=[dict(rank), dict(rank)], layout="fsdp2", mutation=None, dtype="bfloat16",
             n_layers=16, loss_rel=0.0, grad_norm_rel=0.0,
             tol=dict(loss=1e-6, grad_norm=1e-3, params=(1e-3, 1e-2)),
             params=dict(rel_l2=1e-4, row_rel=1e-3))
    r.update(kw)
    return r


def _tr_result(bad=None, where="fsdp2"):
    bf16 = {name: _tr_case(layout=layout, mutation=mutation,
                           params=dict(rel_l2=0.5, row_rel=0.5) if mutation else
                           dict(rel_l2=1e-4, row_rel=1e-3))
            for name, layout, mutation in cs.TR_CASES}
    f32 = {name: _tr_case(layout=name, dtype="float32", n_layers=2,
                          ranks=[dict(_tr_case()["ranks"][0], launches_per_step=dict(
                              flash_fwd=2.0, flash_bwd_dq=2.0, flash_bwd_dkv=2.0))] * 2,
                          checkpoint=dict(step=2, equal=True))
           for name in cs.TR_LAYOUTS}
    if bad:
        (f32 if where.startswith("f32") else bf16)[where.split(":")[-1]].update(bad)
    return {"bf16": {**bf16, "unsharded": {}}, "f32": {**f32, "unsharded": {}}}


@pytest.mark.parametrize("where,bad", [
    ("fsdp2", dict(loss_rel=1e-3)),
    ("model2", dict(grad_norm_rel=1e-2)),
    ("fsdp2", dict(params=dict(rel_l2=2e-3, row_rel=1e-3))),
    ("model2", dict(params=dict(rel_l2=1e-4, row_rel=2e-2))),
    ("fsdp2_rs_unsummed", dict(params=dict(rel_l2=1e-4, row_rel=1e-3))),   # a mutant passes
    ("model2_row_unsummed", dict(params=dict(rel_l2=1e-4, row_rel=1e-3))),
    ("f32:fsdp2", dict(checkpoint=dict(step=2, equal=False))),
    ("fsdp2", dict(ranks=[_tr_case()["ranks"][0], dict(_tr_case()["ranks"][0], loss=10.5)])),
    ("model2", dict(ranks=[_tr_case()["ranks"][0], dict(
        _tr_case()["ranks"][0], launches_per_step=dict(flash_fwd=16.0, flash_bwd_dq=15.0,
                                                       flash_bwd_dkv=16.0))])),
    ("fsdp2", dict(ranks=[dict(_tr_case()["ranks"][0], kernel_shapes={
        "flash_fwd": [[cs.TR_B * 16, cs.TR_S, 128]]})] * 2)),           # a whole step's heads
])
def test_train_rank_gates_fail_what_they_must(monkeypatch, where, bad):
    monkeypatch.setattr(cs, "TR_PRESET", "smol-1b")
    cs.check_train_ranks(_tr_result())
    with pytest.raises(AssertionError, match="phase 15"):
        cs.check_train_ranks(_tr_result(bad, where))


TR_DRY_RUN = r'''
import sys
import torch
import chip_smoke as cs
from dstack_tpu_torch.workloads import flash_attention as fa
from dstack_tpu_torch.workloads.config import PRESETS

# Phase 15's rank process at tiny on the CPU: no card, so the device hooks
# are no-ops and the flash path's plain versions count as launches.
PRESETS["tiny-2k"] = PRESETS["tiny"].with_(max_seq_len=2048)
cs.TR_PRESET, cs.TR_DEVICE, cs.TR_B, cs.TR_S = "tiny-2k", "cpu", 4, 64
cs.RLR_LAYERS = 2
torch.cuda.synchronize = lambda *a: None
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
fa.use_flash = lambda s, hd, dev: True


def count(name, tensors, causal):
    fa.LAUNCHES[name] += 1


fa._launch = count
fwd, bwd = fa._flash_fwd_plain, fa._flash_bwd_plain


def counted_fwd(q, k, v, c):
    fa._launch("flash_fwd", (q,), c)
    return fwd(q, k, v, c)


def counted_bwd(q, k, v, o, lse, do, delta, c):
    fa._launch("flash_bwd_dq", (q,), c)
    fa._launch("flash_bwd_dkv", (q,), c)
    return bwd(q, k, v, o, lse, do, delta, c)


fa._flash_fwd_plain, fa._flash_bwd_plain = counted_fwd, counted_bwd
sys.exit(cs.tr_rank_main(int(sys.argv[1]), sys.argv[2]))
'''


def test_train_rank_phase_runs_on_the_cpu(tmp_path):
    """Phase 15's two rank processes at tiny on the CPU over gloo: every
    case runs, the readings come back from rank 0, launches are counted at
    a rank's geometry, the fsdp-2 checkpoint restores equal on one device,
    and each mutant reads further from the unsharded run than its layout."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(cs.__file__).resolve().parent
    script = tmp_path / "tr_rank.py"
    script.write_text(TR_DRY_RUN)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path), start_new_session=True)
             for r in range(cs.TR_RANKS)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("TR_RESULT "))
    res = json.loads(line[len("TR_RESULT "):])
    assert sorted(res["bf16"]) == sorted([c[0] for c in cs.TR_CASES] + ["unsharded"])
    for tag, n_layers in (("bf16", 2), ("f32", cs.TR_F32_LAYERS)):
        for name in cs.TR_LAYOUTS:
            r = res[tag][name]
            for rank in r["ranks"]:
                assert rank["launches_per_step"]["flash_fwd"] == n_layers
                assert rank["kernel_shapes"]["flash_bwd_dkv"] == [[8, 64, 32]]  # 4 x 4 heads / 2
                assert rank["loss"] == r["ranks"][0]["loss"]
            assert r["params"]["rel_l2"] < 1e-2 and r["loss_rel"] < 1e-3
    assert res["f32"]["fsdp2"]["checkpoint"] == {"step": 2, "equal": True}
    for name, layout, mutation in cs.TR_CASES:
        if mutation:
            assert (res["bf16"][name]["params"]["rel_l2"]
                    > 5 * res["bf16"][layout]["params"]["rel_l2"]), name
    assert res["bf16"]["fsdp2"]["ranks"][0]["collectives_per_step"]["reduce_scatters"] == 16
    assert res["bf16"]["model2"]["ranks"][0]["collectives_per_step"]["all_reduces"] == 13
    # 15(g): LoRA on the row targets over model 2 against the unsharded run.
    lora = res["lora"]
    assert sorted(lora["f32"]) == ["column_axes", "sound", "unsharded"]
    assert lora["bf16"]["sound"]["targets"] == list(cs.LR_ROW_TARGETS)
    assert lora["f32"]["sound"]["loss_rel"] < 1e-6 and lora["f32"]["sound"]["params"]["rel_l2"] < 1e-5
    assert not cs.lora_gates(lora["f32"]["column_axes"])["grad_norm"]
    cs.check_lora_ranks({"f32": lora["f32"]}, "15", (8, 64, 32))
    # 15(h): the RL learner over fsdp 2 and model 2 against the one-device
    # learner, at tiny with 2 layers; every rank's launches a layer an
    # update at a rank's geometry (8 rows x 4 heads / 2, 127 positions).
    rl = res["rl"]
    assert sorted(rl["f32"]) == sorted(["fsdp2", "model2", "unsharded",
                                        *[m for m, _, _ in cs.RLR_MUTANTS]])
    for tag in ("bf16", "f32"):
        for name in ("fsdp2", "model2"):
            r = rl[tag][name]
            assert r["ranks"][0]["publish"]["equal"] and r["ranks"][0]["publish"]["epoch"] == 1
            for rr in r["ranks"]:
                assert rr["first"] == r["ranks"][0]["first"]
                assert rr["launches_per_step"]["flash_bwd_dq"] == 2
                assert rr["kernel_shapes"]["flash_fwd"] == [[16, 127, 32]]
    assert all(rl["f32"][n]["loss_rel"] < 1e-6 and rl["f32"][n]["params"]["rel_l2"] < 1e-5
               for n in ("fsdp2", "model2"))
    for m, _, guard in cs.RLR_MUTANTS:
        assert not cs.rlr_gates(rl["f32"][m])[guard], m
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(cs, "TR_PRESET", "tiny")
    try:
        cs.check_rl_ranks({"f32": rl["f32"]})
        bad = {**rl["f32"], "count_local": {**rl["f32"]["count_local"], "loss_rel": 0.0}}
        with pytest.raises(AssertionError, match="15.h. count_local"):
            cs.check_rl_ranks({"f32": bad})
    finally:
        monkeypatch.undo()


RANKS_DRY_RUN = r'''
import sys
import torch
import chip_smoke as cs
from dstack_tpu_torch.workloads import flash_attention as fa
from dstack_tpu_torch.workloads.config import PRESETS

# Phase 16's and 17's rank processes at tiny on the CPU: no card, so the
# device hooks are no-ops and the kernels' plain versions count as launches.
PRESETS["tiny-2k"] = PRESETS["tiny"].with_(max_seq_len=2048)
cs.RG_PRESET, cs.RG_DEVICE, cs.RG_B, cs.RG_S = "tiny-2k", "cpu", 1, 128
cs.PP_PRESET, cs.PP_DEVICE, cs.PP_B, cs.PP_S = "tiny-2k", "cpu", 4, 64
cs.PP_MICRO = 2
torch.cuda.synchronize = lambda *a: None
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
torch.cuda.empty_cache = lambda *a: None
fa.use_flash = lambda s, hd, dev: True


def count(name, tensors, causal):
    fa.LAUNCHES[name] += 1


fa._launch = count
fwd, bwd, block = fa._flash_fwd_plain, fa._flash_bwd_plain, fa._block_ref_bh


def counted_fwd(q, k, v, c):
    fa._launch("flash_fwd", (q,), c)
    return fwd(q, k, v, c)


def counted_bwd(q, k, v, o, lse, do, delta, c):
    fa._launch("flash_bwd_dq", (q,), c)
    fa._launch("flash_bwd_dkv", (q,), c)
    return bwd(q, k, v, o, lse, do, delta, c)


def counted_block(q, k, v, c):
    if not torch.is_grad_enabled():  # the ring step's forward, not its recompute
        fa._launch("flash_block_fwd", (q,), c)
    return block(q, k, v, c)


fa._flash_fwd_plain, fa._flash_bwd_plain, fa._block_ref_bh = counted_fwd, counted_bwd, counted_block


def count_paged_calls():
    """The paged kernel's plain version, counted as a launch."""
    from dstack_tpu_torch.workloads import kv_blocks
    from dstack_tpu_torch.workloads import paged_attention as pa

    real = kv_blocks.ragged_attention

    def counted(*a, **kw):
        pa.LAUNCHES["ragged_paged_attention"] += 1
        return real(*a, **kw)

    kv_blocks.ragged_attention = counted


if sys.argv[3] == "actor":
    # 14(g)'s actor on phase 14's two serving ranks at tiny (2 layers).
    import json
    from dstack_tpu_torch.workloads import sharding

    PRESETS["tiny-2k"] = PRESETS["tiny"].with_(max_seq_len=2048)
    cs.TP_PRESET, cs.TP_DEVICE, cs.TA_LAYERS = "tiny-2k", "cpu", 2
    count_paged_calls()
    rank = int(sys.argv[1])
    sharding.init_ranks(cs.TP_RANKS, rank, sys.argv[2], backend="gloo", device="cpu")
    mesh = sharding.make_mesh(["cpu"], model=cs.TP_RANKS)
    res = cs.ta_run(rank, mesh)
    if rank == 0:
        print("TA_RESULT " + json.dumps(res), flush=True)
    sharding.leave_ranks(mesh)
    sys.exit(0)
if sys.argv[3] == "expert":
    # Phase 18's rank processes at tiny-moe (4 experts, 2 layers) on the CPU.
    PRESETS["tiny-moe-2k"] = PRESETS["tiny-moe"].with_(max_seq_len=2048)
    cs.EP_PRESET, cs.EP_DEVICE, cs.EP_B, cs.EP_S, cs.EP_LAYERS = "tiny-moe-2k", "cpu", 2, 64, 2
    cs.ES_LAYERS = 2
    count_paged_calls()
if sys.argv[3] == "moe_seq":
    # Phase 20's rank processes at tiny-moe (4 experts, 2 layers) on the CPU.
    PRESETS["tiny-moe-2k"] = PRESETS["tiny-moe"].with_(max_seq_len=2048)
    cs.MS_PRESET, cs.MS_DEVICE, cs.MS_B, cs.MS_S, cs.MS_LAYERS = "tiny-moe-2k", "cpu", 2, 64, 2
main = {"ring": cs.rg_rank_main, "pipe": cs.pp_rank_main, "expert": cs.ep_rank_main,
        "moe_seq": cs.ms_rank_main}[sys.argv[3]]
sys.exit(main(int(sys.argv[1]), sys.argv[2]))
'''


def _dry_run_ranks(tmp_path, phase, n, marker):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(cs.__file__).resolve().parent
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_DRY_RUN)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init, phase],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path), start_new_session=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith(marker + " "))
    return json.loads(line[len(marker) + 1:])


def test_ring_rank_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 16's four rank processes at tiny on the CPU over gloo: the
    ring across the ranks against the one-device ring, rank i's i + 1 ring
    steps a layer, 2n - 1 hops a layer, each mutant read far past the sound
    ring, and the phase's gates pass it and fail the mutants."""
    res = _dry_run_ranks(tmp_path, "ring", cs.RG_RANKS, "RG_RESULT")
    assert sorted(res["f32"]) == sorted(["sound", "one_device", *cs.RG_MUTANTS])
    for tag in ("bf16", "f32"):
        r = res[tag]["sound"]
        for rank, rr in enumerate(r["ranks"]):
            assert rr["launches_per_step"]["flash_block_fwd"] == 2 * (rank + 1)
            assert rr["hops_per_step"] == 2 * 7
            assert rr["digest"] == r["ranks"][0]["digest"]
    assert res["f32"]["sound"]["params"]["rel_l2"] < 1e-5
    assert res["f32"]["sound"]["ranks"][0]["kernel_shapes"] == {"flash_block_fwd": [[4, 32, 32]]}
    for m in cs.RG_MUTANTS:
        assert res["f32"][m]["params"]["rel_l2"] > 100 * res["f32"]["sound"]["params"]["rel_l2"]
    # The gates at the dry run's shapes: bf16 on the CPU is not the card's,
    # so hold the f32 cases only.
    monkeypatch.setattr(cs, "RG_PRESET", "tiny")
    monkeypatch.setattr(cs, "RG_S", 128)
    cs.check_ring_ranks({"f32": res["f32"]})
    bad = {**res["f32"], "sound": {**res["f32"]["sound"], "grad_norm_rel": 1.0}}
    with pytest.raises(AssertionError, match="phase 16"):
        cs.check_ring_ranks({"f32": bad})


def test_pipeline_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 17's two stage processes at tiny on the CPU over gloo: the
    pipeline against the unsharded step, each stage's launches and
    exchanges, the shared replicas equal, each mutant failing the gates."""
    res = _dry_run_ranks(tmp_path, "pipe", cs.PP_RANKS, "PP_RESULT")
    assert sorted(res["f32"]) == sorted(["sound", "unsharded", *cs.PP_MUTANTS])
    for tag in ("bf16", "f32"):
        r = res[tag]["sound"]
        assert r["shared_equal"]
        for rr in r["ranks"]:
            assert rr["launches_per_step"]["flash_fwd"] == 1 * 2  # a layer a stage, 2 micro
            assert rr["hops_per_step"] == 4
            assert rr["loss"] == r["ranks"][0]["loss"]
    assert res["f32"]["sound"]["params"]["rel_l2"] < 1e-5
    assert res["f32"]["sound"]["ranks"][0]["kernel_shapes"]["flash_fwd"] == [[8, 64, 32]]
    monkeypatch.setattr(cs, "PP_PRESET", "tiny")
    monkeypatch.setattr(cs, "PP_B", 4)
    monkeypatch.setattr(cs, "PP_S", 64)
    monkeypatch.setattr(cs, "PP_MICRO", 2)
    cs.check_pipeline({"f32": res["f32"]})
    assert not res["f32"]["shared_unsummed"]["shared_equal"]
    bad = {**res["f32"], "sound": {**res["f32"]["sound"], "shared_equal": False}}
    with pytest.raises(AssertionError, match="phase 17"):
        cs.check_pipeline({"f32": bad})


def test_expert_rank_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 18's two rank processes at tiny-moe on the CPU over gloo: the
    expert-2 steps against the unsharded steps, #2-#4 once a layer a step
    on each rank at the whole batch's geometry, the expert gathers and the
    tokens' all-reduces counted with their bytes, each mutant failing the
    gate that guards it, and the phase's checks passing the sound run."""
    res = _dry_run_ranks(tmp_path, "expert", cs.EP_RANKS, "EP_RESULT")
    assert sorted(res["f32"]) == sorted(["sound", "unsharded", *cs.EP_MUTANTS])
    assert sorted(res["bf16"]) == ["sound", "unsharded"]
    for tag, nbytes in (("bf16", 2), ("f32", 4)):
        r = res[tag]["sound"]
        for rr in r["ranks"]:
            assert rr["losses"] == r["ranks"][0]["losses"]
            assert rr["router_aux"] == r["ranks"][0]["router_aux"] > 0
            assert rr["launches_per_step"]["flash_fwd"] == 2
            # A gather of the experts' outputs and an all-reduce of the
            # tokens' grad a layer (and global_norm's); a rank's outputs of
            # a layer are (2 experts, B 2, C 40, D 128).
            coll = rr["collectives_per_step"]
            assert coll["all_gathers"] == 2 and coll["all_reduces"] == 3
            assert coll["reduce_scatters"] == 0
            assert rr["collective_mb_per_step"]["all_gather"] == pytest.approx(
                2 * 2 * 2 * 40 * 128 * nbytes / 1e6)
    assert res["bf16"]["sound"]["ranks"][0]["kernel_shapes"]["flash_fwd"] == [[8, 64, 32]]
    sound = res["f32"]["sound"]
    assert sound["loss_rel"] < 1e-6 and sound["params"]["rel_l2"] < 1e-5
    for m, guard in cs.EP_GUARDS.items():
        assert not cs.ep_gates(res["f32"][m])[guard], m
    monkeypatch.setattr(cs, "EP_PRESET", "tiny-moe")
    monkeypatch.setattr(cs, "EP_B", 2)
    monkeypatch.setattr(cs, "EP_S", 64)
    cs.check_expert_ranks({"f32": res["f32"]})
    bad = {**res["f32"], "block_off": {**res["f32"]["block_off"], "loss_rel": 0.0}}
    with pytest.raises(AssertionError, match="phase 18 block_off"):
        cs.check_expert_ranks({"f32": bad})
    # 18(g): LoRA on wq/wv over the expert axis against the unsharded run.
    lora = res["lora"]
    assert sorted(lora["f32"]) == ["sound", "summed_over_expert", "unsharded"]
    assert lora["f32"]["sound"]["loss_rel"] < 1e-6 and lora["f32"]["sound"]["params"]["rel_l2"] < 1e-5
    assert lora["f32"]["summed_over_expert"]["grad_norm_rel"] > 0.5  # the grads doubled
    cs.check_lora_ranks({"f32": lora["f32"]}, "18", (8, 64, 32))
    bad = {**lora["f32"], "summed_over_expert": {**lora["f32"]["summed_over_expert"],
                                                 "grad_norm_rel": 0.0}}
    with pytest.raises(AssertionError, match="phase 18 LoRA summed_over_expert"):
        cs.check_lora_ranks({"f32": bad}, "18", (8, 64, 32))
    # 18(c): the expert-2 serving mesh on the same ranks against the
    # unsharded engine: f32 and bf16 (routing pinned) token for token, the
    # swapped blocks changing the f32 streams, a paged launch a layer a
    # decode step on each rank, every rank with all of tiny-moe's heads.
    serve = res["serve"]
    assert serve["f32"]["sound"]["equal"] and serve["bf16"]["sound"]["equal"]
    assert not serve["f32"]["swapped"]["equal"]
    assert serve["bf16"]["ranks"][1]["sound"]["flips"] == 0
    monkeypatch.setattr(cs, "ES_LAYERS", 2)
    cs.check_expert_serving(serve)
    bad = {**serve, "f32": {**serve["f32"], "swapped": {**serve["f32"]["swapped"],
                                                        "equal": True}}}
    with pytest.raises(AssertionError, match="18.c.: the swapped expert blocks"):
        cs.check_expert_serving(bad)


def test_rl_actor_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """14(g) on two gloo ranks at tiny on the CPU: the mesh actor's f32
    round equals the one-device actor's, its scores are within the gate,
    the leader's admission gate held the round, the adopted frame is every
    rank's slices by sha1 and the leader-only refresh fails rank 1's."""
    res = _dry_run_ranks(tmp_path, "actor", cs.TP_RANKS, "TA_RESULT")
    assert res["f32"]["tokens_equal"] and res["f32"]["logp_max_abs"] < 1e-5
    assert res["f32"]["logp_vs_actor"] < 1e-6
    for tag in ("f32", "bf16"):
        for rr in res[tag]["ranks"]:
            assert rr["flash"]["flash_fwd"] == 2 and rr["heads"] == 2
            assert (rr["launches"] > 0) == (tag == "f32")  # bf16 scores the f32 round
    monkeypatch.setattr(cs, "TP_PRESET", "tiny")
    monkeypatch.setattr(cs, "TA_LAYERS", 2)
    cs.check_tp_actor(res)
    bad = {**res, "bf16": {**res["bf16"], "adopted_leader_only": [True, True]}}
    with pytest.raises(AssertionError, match="must fail rank 1"):
        cs.check_tp_actor(bad)


EXPERT_PAIR = r'''
import json, os, sys
import torch, torch.distributed as dist
from dstack_tpu_torch.workloads import sharding

rank, init = int(sys.argv[1]), sys.argv[2]
sharding.init_ranks(2, rank, init, backend="gloo", device="cpu")
mesh = sharding.make_mesh(["cpu"], layout="training", expert=2)
gen = torch.Generator().manual_seed(0)
x = torch.randn(3, 5, 4, generator=gen, dtype=torch.float64)
w = torch.randn(4, 6, generator=gen, dtype=torch.float64)
c = torch.randn(3, 5, 6, generator=gen, dtype=torch.float64)
# The whole product on one rank: y = x @ w, its grads by autograd.
xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
torch.autograd.backward(xw @ ww, c)
# The same on the expert line: this rank's 3 columns ("experts") of w,
# the tokens behind enter_expert, the columns gathered on the last dim.
xr, wr = x.clone().requires_grad_(), w[:, 3 * rank:3 * rank + 3].clone().requires_grad_()
y = sharding.gather_experts(sharding.enter_expert(xr, mesh) @ wr, -1, mesh)
torch.autograd.backward(y, c)
out = {"y": torch.equal(y, (x @ w)), "x_grad": float((xr.grad - xw.grad).abs().max()),
       "w_grad": float((wr.grad - ww.grad[:, 3 * rank:3 * rank + 3]).abs().max()),
       "stats": {k: mesh.stats[k] for k in ("all_gathers", "all_reduces")}}
print("PAIR " + json.dumps(out), flush=True)
sharding.leave_ranks(mesh)
sys.stdout.flush()
os._exit(0)
'''


def test_enter_expert_and_gather_experts_against_autograd_on_the_whole_tensor(tmp_path):
    """Two gloo ranks: the expert line's product (tokens behind
    enter_expert, each rank's block of columns, the outputs gathered)
    equals the whole product, and its grads autograd's on the whole
    tensors: the tokens' grad summed over the line, each block's grad its
    own slice of the whole, unsummed."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(cs.__file__).resolve().parent
    script = tmp_path / "pair.py"
    script.write_text(EXPERT_PAIR)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path), start_new_session=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        got = json.loads(next(ln for ln in out.splitlines() if ln.startswith("PAIR "))[5:])
        assert got["y"]
        assert got["x_grad"] < 1e-12 and got["w_grad"] < 1e-12
        assert got["stats"] == {"all_gathers": 1, "all_reduces": 1}


def test_gang_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 19 at tiny on the CPU: `fine_tune --ranks 2` on one host and
    as a gang of two `chip_smoke.py --gang-host` processes given the
    orchestrator's variables, exports byte for byte equal, each host one
    rank printing its process line and its steps; run_rl's learner and
    actor to epoch 4; the phase's gates pass the run (with the launches
    the card's kernels would count) and fail a differing export, a missing
    launch and an epoch short."""
    import copy

    monkeypatch.chdir(tmp_path)
    for name, value in (("GANG_PRESET", "tiny"), ("GANG_DEVICE", "cpu"), ("GANG_B", 2),
                        ("GANG_S", 32), ("GANG_RL_DEVICE", "cpu"), ("GANG_TIMEOUT", 150)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    check = cs.check_gang
    monkeypatch.setattr(cs, "check_gang", lambda ft, rl: None)  # the CPU counts no launch
    res = cs.run_gang()
    ft, rl = res["fine_tune"], res["rl"]
    assert all(ft["export_equal"].values()) and ft["export_equal"]["files"]
    assert [r["host"] for r in ft["hosts"]] == [0, 1]
    assert all(len(r["step_ms"]) == cs.GANG_STEPS for r in ft["hosts"])
    assert len(ft["gang_steps"]) == cs.GANG_STEPS == len(ft["one_host_steps"])
    assert rl["epochs"] == [2, 3, 4] and rl["metrics_block"] and len(rl["seconds"]) == 2
    for h in range(2):
        assert (tmp_path / f"chiprun_out/phase19_host{h}.log").exists()
    # The CPU runs the plain attention: give the hosts what the card counts.
    from dstack_tpu_torch.workloads.config import PRESETS

    cfg = PRESETS["tiny"]
    sound = copy.deepcopy(ft)
    for r in sound["hosts"]:
        r["launches_per_step"] = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                               float(cfg.n_layers))
        r["kernel_shapes"] = {"flash_fwd": [[cfg.n_heads, 32, cfg.head_dim]]}
    check(sound, rl)
    bad = copy.deepcopy(sound)
    bad["export_equal"]["weights.bin"] = False
    with pytest.raises(AssertionError, match="export differs"):
        check(bad, rl)
    bad = copy.deepcopy(sound)
    bad["hosts"][1]["launches_per_step"]["flash_bwd_dq"] = 0.0
    with pytest.raises(AssertionError, match="host 1: flash launches"):
        check(bad, rl)
    with pytest.raises(AssertionError, match="phase 19.b"):
        check(sound, {**rl, "epochs": [2, 3]})
    with pytest.raises(AssertionError, match="step lines"):
        check({**sound, "gang_steps": sound["gang_steps"][:1]}, rl)


def test_moe_seq_rank_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 20's two rank processes at tiny-moe on the CPU over gloo: the
    seq ranks, pinned to the one-device ring's routing, against it; the
    one-device run drops choices at cf 1.25; rank i's i + 1 ring steps a
    layer, 3 hops and one all-gather of the routing counts a layer; each
    mutant failing the loss gate, and the phase's checks passing the sound
    run and failing a mutant read as sound."""
    res = _dry_run_ranks(tmp_path, "moe_seq", cs.MS_RANKS, "MS_RESULT")
    assert sorted(res["f32"]) == sorted(["sound", "one_device", *cs.MS_MUTANTS])
    assert sorted(res["bf16"]) == ["one_device", "sound"]
    for tag in ("bf16", "f32"):
        ref, r = res[tag]["one_device"], res[tag]["sound"]
        assert ref["route_calls"] == 2 * 2 and sum(ref["dropped"]) > 0
        for rank, rr in enumerate(r["ranks"]):
            assert rr["launches_per_step"]["flash_block_fwd"] == 2 * (rank + 1)
            assert rr["hops_per_step"] == 2 * 3
            assert rr["collectives_per_step"]["all_gathers"] == 2
            assert rr["route_calls"] == ref["route_calls"] and rr["flips"] >= 0
            assert rr["digest"] == r["ranks"][0]["digest"]
    assert res["bf16"]["sound"]["ranks"][0]["kernel_shapes"] == {"flash_block_fwd": [[8, 32, 32]]}
    sound = res["f32"]["sound"]
    assert sound["loss_rel"] < 1e-6 and sound["params"]["rel_l2"] < 1e-5
    for m in cs.MS_MUTANTS:
        assert not cs.ep_gates(res["f32"][m])["loss"], m
    monkeypatch.setattr(cs, "MS_PRESET", "tiny-moe")
    monkeypatch.setattr(cs, "MS_B", 2)
    monkeypatch.setattr(cs, "MS_S", 64)
    cs.check_moe_seq_ranks({"f32": res["f32"]})
    bad = {**res["f32"], "no_rank_prefix": {**res["f32"]["no_rank_prefix"], "loss_rel": 0.0}}
    with pytest.raises(AssertionError, match="phase 20 no_rank_prefix"):
        cs.check_moe_seq_ranks({"f32": bad})


ORPHAN_SCRIPT = """
import subprocess, sys, time
import chip_smoke as cs

cs.adopt_orphans()
# A parent that starts a grandchild in its own session and exits before it.
subprocess.run([sys.executable, "-c",
                "import subprocess; subprocess.Popen(['sleep', '120'], start_new_session=True)"],
               check=True)
time.sleep(0.5)
stray = cs.stray_processes("the parent")
stopped = cs.stop_descendants(grace=1.0)
print("RESULT", len(stray), len(stopped), "sleep 120" in stopped[0], len(cs.descendants()))
"""


def test_an_orphaned_grandchild_is_adopted_named_and_stopped(tmp_path):
    """The run adopts what its children leave behind: a grandchild whose
    parent ended first is found below the smoke's process, logged as a
    stray, killed past its grace and reaped, so nothing of the run outlives
    it."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")])}
    p = subprocess.run([sys.executable, "-c", ORPHAN_SCRIPT], capture_output=True, text=True,
                       env=env, cwd=tmp_path, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "stray processes after the parent" in p.stdout
    assert p.stdout.splitlines()[-1] == "RESULT 1 1 True 0"


def test_descendants_reads_the_tree_below_a_process():
    import os
    import subprocess

    child = subprocess.Popen(["sleep", "30"])
    try:
        below = cs.descendants()
        assert any(pid == child.pid and cmd == "sleep 30" for pid, _, cmd in below)
        assert cs.descendants(child.pid) == []
        assert all(pid != os.getpid() for pid, _, _ in below)
    finally:
        child.kill()
        child.wait()
