"""The model families (`portbench/families/`): Mistral and Mixtral give
what the harness gave before they were moved behind `spec.family`, every
reader takes the counts and the reference from the run's family, and a
profiled slice that lost its kernels is taken again, and read for no
device metric where the retake lost them too.

`family_move.json` was recorded from the harness as it stood before the
move, on the CPU: each weight leaf's float64 sum and sha256 at the two
tiny configurations, the reference's logits at 8 positions, and the four
work counts at the two cells' configurations. The families have to give
every one of them exactly."""

import hashlib
import time
import types

import pytest
import torch

from portbench import run, serving, spec, weights
from portbench.tests import tiny

GOLD = spec.load_json(spec.PKG / "tests" / "family_move.json")
SEED = 2_147_483_711


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name,moe", [("mistral", False), ("mixtral", True)])
def test_weights_and_reference_are_those_before_the_move(name, moe):
    conf = tiny.config(moe)
    fam = spec.family(conf)
    s = fam.shapes(conf)
    gold = GOLD["tiny"][name]
    w = fam.make_weights(s, GOLD["seed"], "cpu")
    got = {k: {"sum": float(v.double().sum()), "sha256": sha256(v), "shape": list(v.shape),
               "dtype": str(v.dtype)} for k, v in leaves(w)}
    assert got == gold["weights"]
    assert weights.weight_bytes(w) == gold["weight_bytes"]
    lg = fam.logits(s, w, GOLD["tokens"], GOLD["rows"])
    assert sha256(lg) == gold["logits_sha256"]
    assert float(lg.double().sum()) == gold["logits_sum"]


@pytest.mark.parametrize("cfg", sorted(GOLD["counts"]))
def test_work_counts_are_those_before_the_move(cfg):
    conf = spec.load_json(spec.PKG / "configs" / f"{cfg}.json")
    fam = spec.family(conf)
    s = fam.shapes(conf)
    gold = GOLD["counts"][cfg]
    assert s.param_count() == gold["param_count"]
    assert [[p, r, fam.prefill_flops(s, p, r)] for p, r, _ in gold["prefill_flops"]] \
        == gold["prefill_flops"]
    assert [[p, r, *fam.paged_prefill_work(s, p, r)] for p, r, _, _ in gold["paged_prefill_work"]] \
        == gold["paged_prefill_work"]
    assert [[c, fam.decode_flops(s, c)] for c, _ in gold["decode_flops"]] == gold["decode_flops"]
    assert [[c, *fam.paged_decode_work(s, c)] for c, _, _ in gold["paged_decode_work"]] \
        == gold["paged_decode_work"]


@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_every_cell_finds_its_family(name):
    fam = spec.cell(name)["family"]
    for fn in ("shapes", "port_config", "make_weights", "logits", "prefill_flops",
               "decode_flops", "paged_prefill_work", "paged_decode_work"):
        assert callable(getattr(fam, fn)), fn


def test_a_model_type_without_a_family_stops_the_run():
    with pytest.raises(FileNotFoundError, match=r"families/no_such_model\.py"):
        spec.family(dict(tiny.config(), model_type="no_such_model"))


def off_family(real):
    """The Mistral family with its FLOP counts doubled, its paged work
    halved and its reference lifting the second-ranked logit at every
    position by 1.0, so the program's greedy token is no longer the best."""
    fam = types.ModuleType("off_family")
    fam.__dict__.update({k: v for k, v in vars(real).items() if not k.startswith("__")})
    fam.prefill_flops = lambda s, p, r=0: 2.0 * real.prefill_flops(s, p, r)
    fam.decode_flops = lambda s, c: 2.0 * real.decode_flops(s, c)
    fam.paged_prefill_work = lambda s, p, r=0: tuple(0.5 * x for x in real.paged_prefill_work(s, p, r))
    fam.paged_decode_work = lambda s, c: tuple(0.5 * x for x in real.paged_decode_work(s, c))
    fam.calls = 0

    def logits(*a, **k):
        fam.calls += 1
        out = real.logits(*a, **k)
        second = out.topk(2, dim=-1).indices[:, 1:]
        return out.scatter_add(-1, second, torch.ones_like(second, dtype=out.dtype))

    fam.logits = logits
    return fam


def test_no_reader_gets_round_the_family(monkeypatch):
    real = spec.family(tiny.config())
    fake = off_family(real)
    monkeypatch.setattr(spec, "family", lambda conf: fake)
    rec, checks = run.measure(tiny.cell("docs"), SEED, 2.0, False, "cpu", time.monotonic())
    assert rec.family is fake and fake.calls >= 1
    assert not checks["correct"] and checks["logit_gap"]["value"] > 1e-3
    rec.slice = {"paged_s": 1e-3, "window_s": 0.5 * (rec.t1 - rec.t0)}
    read = {m: spec.load_module("metrics", m).read for m in ("mfu.serve", "paged_roofline.serve")}
    off = {m: f(rec) for m, f in read.items()}
    rec.family = real
    on = {m: f(rec) for m, f in read.items()}
    assert on["mfu.serve"] > 0 and on["paged_roofline.serve"] > 0
    assert off["mfu.serve"] == 2 * on["mfu.serve"]
    assert off["paged_roofline.serve"] == 0.5 * on["paged_roofline.serve"]


class _Engine:
    """Stands in for the serving engine in the window's own bookkeeping."""

    def stats(self):
        return {k: 1 for k in serving.COUNTERS + serving.LOAD_GAUGES}


def _slices(captures):
    """A Slice whose n-th capture holds captures[n], and every capture past
    the last the last one."""
    made = []

    class FakeSlice:
        def __init__(self):
            made.append(self)
            self.t0 = self.t1 = None

        def start(self):
            self.t0 = time.monotonic()

        def stop(self):
            self.t1 = time.monotonic()

        def events(self):
            return captures[min(made.index(self), len(captures) - 1)]

    return FakeSlice, made


def _capture(kernels=0, copies=0, launches=None):
    """A slice's events: `kernels` paged-attention kernels and `copies`
    memcpys and memsets on the device, and `launches` kernel launches
    (by default one a kernel) among the host's calls."""
    names = ("Memcpy DtoH (Device -> Pinned)", "Memset (Device)")
    dev = [(i * 1000, i * 1000 + 500, "ragged_paged_attention_kernel") for i in range(kernels)]
    dev += [(i * 1000 + 600, i * 1000 + 700, names[i % 10 == 0]) for i in range(copies)]
    n = kernels if launches is None else launches
    host = [(0, 10**9, "host_op")]
    host += [(i * 1000 - 50, i * 1000 - 40, ("cudaLaunchKernel", "cuLaunchKernelEx")[i % 7 == 0])
             for i in range(n)]
    return {"device": dev, "host": host}


@pytest.mark.parametrize("captures,retaken,kept", [
    ((_capture(copies=500), _capture(150)), 0, True),
    ((_capture(150),), None, True),
    ((_capture(copies=500), _capture(copies=500)), 0, False),
    ((_capture(150, launches=200), _capture(150)), 150, True),
], ids=["500_copies_no_kernel", "150_kernels", "retake_lost_as_well", "kernels_lost_midway"])
def test_a_slice_is_retaken_when_it_lost_its_kernels(monkeypatch, captures, retaken, kept):
    fake, made = _slices(captures)
    monkeypatch.setattr(serving, "Slice", fake)
    monkeypatch.setattr(serving, "PROFILE_SECONDS", 0.05)
    h = serving.ServingRun(tiny.cell("docs"), SEED, 0.4, True, "cpu", time.monotonic())
    h.engine = _Engine()
    h.window(time.monotonic())
    assert len(made) == (1 if retaken is None else 2)
    assert h.notes.get("slice_retaken_after_kernels") == retaken
    # The trace's busy time is in the line either way.
    assert 0 < h.device_time["busy_s"] <= h.device_time["window_s"]
    line = run.result(tiny.cell("docs"), h, {"correct": True}, True, "cpu")
    assert line["device"]["busy_s"] == h.device_time["busy_s"]
    if kept:
        assert "slice_lost_kernels" not in h.notes
        assert h.notes["slice_kernels_launches"] == [150, 150]
        assert h.slice["by_name"] == {"ragged_paged_attention_kernel": pytest.approx(150 * 5e-7)}
        assert h.slice["paged_s"] > 0
        assert "breakdown" in line
    else:
        # No device metric and no breakdown from a slice without kernels.
        assert h.notes["slice_lost_kernels"] == [0, 0] and h.slice is None
        assert "breakdown" not in line
        for m in ("device_idle.serve", "paged_roofline.serve"):
            assert spec.load_module("metrics", m).read(h) is None
