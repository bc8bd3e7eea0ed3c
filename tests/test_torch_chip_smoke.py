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
