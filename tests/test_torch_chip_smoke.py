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
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi128EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi128EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li128EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li128EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
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
    assert got["flash_bwd_dq"]["registers"] == 128  # bf16, not the f32 build's 255
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

    src = (Path(cs.__file__).parent / cs.FLASH_KERNEL_SOURCE).read_text()
    pat = cs.PTXAS_ENTRY[kern]
    name = re.match(r"\w+?_kernel", pat).group(0)
    assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s+{name}\(", src), name
    assert pat.endswith("Li128E"), pat
