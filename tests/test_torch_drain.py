"""The port's side of the orchestrator's contract, on the CPU: the SIGTERM
drain (exit 113 with a checkpoint at the last finished step, and a
relaunch that resumes there), the resize notice, the stage markers and
where the trainer and the engine emit them, and the kernel cache's keying,
precedence, counters and refusal of an unwritable directory. Held against
the JAX package where it has the same function.

The drains run in subprocesses, so the pytest worker's signal handlers
are untouched. No test needs nvcc: the cache's nvcc release comes from a
stub, and its builds from a stub compile step."""

import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from dstack_tpu.agents.protocol import DRAIN_EXIT_CODE as JAX_DRAIN_EXIT_CODE
from dstack_tpu.utils import stagemarkers as jmarkers
from dstack_tpu.workloads import train as jtrain
from dstack_tpu_torch.utils import stagemarkers as markers
from dstack_tpu_torch.workloads import _build, compile_cache
from dstack_tpu_torch.workloads import checkpoint as ckpt
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import PRESETS

ROOT = Path(__file__).resolve().parents[1]
TRAIN_STAGES = ["tpu_init", "compile_start", "compile_end", "first_step"]

# A tiny trainer on the port's DrainHandler, shaped like the JAX drill's
# (dstack_tpu/chaos/scenarios.py). After each step it waits up to
# argv[3] seconds for a drain, so the test's SIGTERM lands after a known step.
_DRAIN_TRAIN = """
import sys, time
vol, steps, wait = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
from dstack_tpu_torch.workloads import checkpoint as ckpt
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.train import (
    init_train_state, install_drain_handler, make_train_step, synthetic_batch)

drain = install_drain_handler()
cfg = PRESETS["tiny"]
state = init_train_state(cfg, 0, "cpu")
restored = ckpt.restore_latest(vol, state)
if restored is not None:
    state = restored
    print(f"resumed from step {state.step}", flush=True)
step = make_train_step(cfg)
batch = synthetic_batch(cfg, 2, 32, device="cpu")
for _ in range(state.step, steps):
    state, m = step(state, batch)
    print(f"step {state.step} loss {float(m['loss']):.6f}", flush=True)
    deadline = time.monotonic() + wait
    while not drain.draining and time.monotonic() < deadline:
        time.sleep(0.01)
    if drain.draining:
        drain.checkpoint_and_exit(vol, state)
print("final", state.step, flush=True)
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DSTACK_RUN_NAME", compile_cache.ENV_VAR)}
    env.update(extra)
    return env


def test_sigterm_drains_with_a_checkpoint_and_a_relaunch_resumes(tmp_path):
    vol = str(tmp_path / "ckpt")
    proc = subprocess.Popen([sys.executable, "-c", _DRAIN_TRAIN, vol, "6", "60"],
                            cwd=ROOT, env=_env(DSTACK_RUN_NAME="drain-test"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("step 1 "):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    lines += out.splitlines()
    assert proc.returncode == ttrain.DRAIN_EXIT_CODE, (lines, err)
    assert [markers.parse_stage_marker(ln) for ln in lines
            if markers.parse_stage_marker(ln)] == TRAIN_STAGES
    assert any(ln.startswith("drain: checkpoint saved at step 1 in") for ln in lines), lines
    assert "step 2" not in "\n".join(lines)
    assert sorted(p.name for p in Path(vol).iterdir()) == ["1"]
    relaunch = subprocess.run([sys.executable, "-c", _DRAIN_TRAIN, vol, "4", "0"],
                              cwd=ROOT, env=_env(), capture_output=True, text=True,
                              timeout=120)
    assert relaunch.returncode == 0, relaunch.stderr
    out = relaunch.stdout.splitlines()
    assert out[0] == "resumed from step 1"
    assert [ln.split()[1] for ln in out if ln.startswith("step ")] == ["2", "3", "4"]
    assert out[-1] == "final 4"
    assert not any(markers.STAGE_MARKER_PREFIX in ln for ln in out)


def test_drain_exit_code_is_the_protocols():
    assert ttrain.DRAIN_EXIT_CODE == JAX_DRAIN_EXIT_CODE == 113


_CHAIN = """
import os, signal
from dstack_tpu_torch.workloads.train import DrainHandler, install_drain_handler
seen = []
signal.signal(signal.SIGTERM, lambda s, f: seen.append("prior"))
first = install_drain_handler()
second = DrainHandler()
os.kill(os.getpid(), signal.SIGTERM)
print(seen, first.draining, second.draining)
"""


def test_drain_handler_chains_the_prior_handler():
    out = subprocess.run([sys.executable, "-c", _CHAIN], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['prior']", "True", "True"]


def test_drain_handler_off_the_main_thread_raises():
    errors = []

    def install():
        try:
            ttrain.DrainHandler()
        except RuntimeError as e:
            errors.append(e)

    th = threading.Thread(target=install)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and len(errors) == 1
    assert "main thread" in str(errors[0])


def test_checkpoint_and_exit_saves_and_warns_past_the_grace(tmp_path, capsys):
    cfg = PRESETS["tiny"]
    state = ttrain.init_train_state(cfg, 0, "cpu")
    state, _ = ttrain.make_train_step(cfg)(state, ttrain.synthetic_batch(cfg, 2, 16,
                                                                         device="cpu"))
    handler = ttrain.DrainHandler(signals=())
    with pytest.raises(SystemExit) as exit_:
        handler.checkpoint_and_exit(tmp_path, state, grace_seconds=0.0)
    assert exit_.value.code == 113
    captured = capsys.readouterr()
    assert "over the 0s grace window" in captured.err
    assert "drain: checkpoint saved at step 1" in captured.out
    restored = ckpt.restore_latest(tmp_path, ttrain.init_train_state(cfg, 1, "cpu"))
    assert restored.step == 1


@pytest.mark.parametrize("content", [
    '{"width": 2, "total": 8}', '{"width": "4"}', '{"width": 2, "tot', '{"total": 8}',
    '[1, 2]', '"width"', "", None])
def test_read_resize_notice_agrees_with_jax(tmp_path, monkeypatch, content):
    """Valid, a width alone, partial JSON, a missing key, other JSON, an
    empty file, a missing file; by path and through the env var."""
    path = tmp_path / "resize.json"
    if content is not None:
        path.write_text(content)
    got = ttrain.read_resize_notice(str(path))
    assert got == jtrain.read_resize_notice(str(path))
    monkeypatch.setenv("DSTACK_TPU_RESIZE_FILE", str(path))
    assert ttrain.read_resize_notice() == jtrain.read_resize_notice() == got
    if content == '{"width": 2, "total": 8}':
        assert got == {"width": 2, "total": 8}


def test_read_resize_notice_without_the_env_var(monkeypatch):
    monkeypatch.delenv("DSTACK_TPU_RESIZE_FILE", raising=False)
    assert ttrain.read_resize_notice() is None is jtrain.read_resize_notice()


@pytest.mark.parametrize("stage", TRAIN_STAGES + [
    "warmup_end", "first_token", "weights_start", "weights_end"])
def test_stage_markers_parse_across_packages(stage, capsys):
    markers.emit_stage(stage)
    jmarkers.emit_stage(stage)
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line
    assert jmarkers.parse_stage_marker(port_line) == stage
    assert markers.parse_stage_marker(jax_line) == stage
    assert markers.parse_stage_marker("  " + port_line + " \n") == stage
    assert markers.parse_stage_marker("step 1: loss 2.0") is None
    assert markers.STAGE_MARKER_PREFIX == jmarkers.STAGE_MARKER_PREFIX


def test_auto_stage_is_silent_without_a_run_name(capsys, monkeypatch):
    monkeypatch.delenv("DSTACK_RUN_NAME", raising=False)
    markers.auto_stage("tpu_init")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("DSTACK_RUN_NAME", "r")
    markers.auto_stage("tpu_init")
    assert capsys.readouterr().out == "::dstack-tpu-stage::tpu_init\n"
    monkeypatch.setenv("DSTACK_TPU_TRACEPARENT", "00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    assert markers.traceparent() == jmarkers.traceparent()


def _stages(text):
    return [markers.parse_stage_marker(ln) for ln in text.splitlines()
            if markers.parse_stage_marker(ln)]


def test_the_train_step_marks_its_first_call_only(capsys, monkeypatch):
    monkeypatch.setenv("DSTACK_RUN_NAME", "r")
    cfg = PRESETS["tiny"]
    state = ttrain.init_train_state(cfg, 0, "cpu")
    step = ttrain.make_train_step(cfg)
    batch = ttrain.synthetic_batch(cfg, 2, 16, device="cpu")
    assert _stages(capsys.readouterr().out) == ["tpu_init"]
    state, _ = step(state, batch)
    assert _stages(capsys.readouterr().out) == TRAIN_STAGES[1:]
    for _ in range(2):
        state, _ = step(state, batch)
    assert _stages(capsys.readouterr().out) == []


def _drain_q(q):
    out = []
    while True:
        tok = q.get(timeout=60)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return out
        out.append(tok)


def test_warmup_and_first_token_markers(capsys, monkeypatch):
    """warmup() emits compile_start, compile_end and warmup_end, and
    returns the cache counters it moved (none on the CPU: nothing builds);
    first_token comes once per engine, with or without warmup."""
    from dstack_tpu_torch.workloads.transformer import init_params

    monkeypatch.setenv("DSTACK_RUN_NAME", "r")
    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = init_params(cfg, 0, "cpu")
    for warm in (True, False):
        capsys.readouterr()
        eng = tsrv.ServingEngine(cfg, params, slots=2, max_len=64, prefill_chunk_tokens=16,
                                 kv_block_size=8, device="cpu")
        try:
            if warm:
                r = eng.warmup()
                assert _stages(capsys.readouterr().out) == [
                    "compile_start", "compile_end", "warmup_end"]
                assert {k: r[k] for k in ("compiles", "cache_hits", "cache_misses",
                                          "compile_seconds")} == dict.fromkeys(
                    ("compiles", "cache_hits", "cache_misses", "compile_seconds"), 0)
            for _ in range(2):
                qs = [eng.submit([1, 2, 3, i + 4], max_new_tokens=3) for i in range(2)]
                for q in qs:
                    _drain_q(q)
            assert _stages(capsys.readouterr().out) == ["first_token"]
            st = eng.stats()
            assert st["compile_cache_dir"] is None
            for k in ("compiles_total", "compile_cache_hits_total",
                      "compile_cache_misses_total", "compile_seconds_total"):
                assert k in st
        finally:
            eng.close()


# ------------------------------------------------------------ kernel cache


@pytest.fixture
def fresh_cache(monkeypatch):
    """A process with no cache enabled, no library loaded and zero
    counters; the module state comes back after the test."""
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(compile_cache, "_counts", dict.fromkeys(compile_cache._counts, 0))
    monkeypatch.setattr(compile_cache, "nvcc_version", lambda: "12.9")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    return monkeypatch


def _stub_build(monkeypatch, tmp_path):
    """A compile step that writes a placeholder library, and a loader that
    returns a marker instead of dlopen-ing it."""
    built = []

    def compile_and_link(so, tmp):
        assert Path(tmp).parent == so.parent
        so.write_bytes(b"not a real library")
        built.append(so)
        return "ptxas info    : Used 1 registers\n"

    monkeypatch.setattr(_build, "_compile_and_link", compile_and_link)
    monkeypatch.setattr(_build, "_open", lambda so: ("loaded", so))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "pkg-build")
    return built


def test_cache_leaf_is_keyed_by_nvcc_release_and_architecture(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'nvcc: NVIDIA (R) Cuda compiler driver'\n"
                    "echo 'Cuda compilation tools, release 12.4, V12.4.131'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc() == str(fake)
    assert compile_cache.nvcc_version() == "12.4"
    assert compile_cache.cache_dir_for("/base") == "/base/nvcc12.4-sm90a"
    assert compile_cache.cache_dir_for("/base", "12.9") == "/base/nvcc12.9-sm90a"
    assert _build.ARCH == "sm_90a" and "code=sm_90a" in _build.NVCC_FLAGS[0]


def test_cache_precedence_flag_over_env_over_default(tmp_path, fresh_cache):
    assert compile_cache.enable_from_env() is None
    assert _build.build_dir() == _build.BUILD_DIR
    fresh_cache.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    leaf = compile_cache.enable_from_env()
    assert leaf == str(tmp_path / "env" / "nvcc12.9-sm90a") and os.path.isdir(leaf)
    assert _build.build_dir() == Path(leaf) and compile_cache.enabled_dir() == leaf
    fresh_cache.setattr(compile_cache, "_enabled_dir", None)
    flag = compile_cache.enable(str(tmp_path / "flag"))  # native_server --compile-cache-dir
    assert compile_cache.enable_from_env() == flag == compile_cache.enabled_dir()
    assert _build.build_dir() == Path(tmp_path / "flag" / "nvcc12.9-sm90a")


def test_counters_move_on_a_build_and_a_hit_only(tmp_path, fresh_cache):
    built = _stub_build(fresh_cache, tmp_path)
    fresh_cache.setenv(compile_cache.ENV_VAR, str(tmp_path / "cache"))
    lib = _build.load_library()
    leaf = tmp_path / "cache" / "nvcc12.9-sm90a"
    assert lib[0] == "loaded" and lib[1].parent == leaf and built == [lib[1]]
    assert lib[1].name == f"libdstack_kernels_{_build._digest()}.so"
    snap = compile_cache.snapshot()
    assert (snap["compiles"], snap["cache_misses"], snap["cache_hits"]) == (1, 1, 0)
    assert snap["compile_seconds"] == _build.build_seconds > 0
    assert compile_cache.compile_count() == 1
    assert _build.load_library() is lib  # loaded already: nothing counts
    assert compile_cache.snapshot() == snap
    assert [p.name for p in leaf.iterdir()] == [lib[1].name]  # no scratch left
    fresh_cache.setattr(_build, "_lib", None)  # a second process, the same volume
    _build.load_library()
    snap2 = compile_cache.snapshot()
    assert (snap2["compiles"], snap2["cache_misses"], snap2["cache_hits"]) == (1, 1, 1)
    assert len(built) == 1 and _build.load_seconds is not None
    _build.load_library(rebuild=True)
    assert compile_cache.snapshot()["compiles"] == 2 and len(built) == 2


def test_an_unwritable_cache_raises_naming_the_env_var(tmp_path, fresh_cache):
    _stub_build(fresh_cache, tmp_path)
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    with pytest.raises(RuntimeError, match=compile_cache.ENV_VAR):
        compile_cache.enable(str(blocker / "cache"))
    assert compile_cache.enabled_dir() is None
    fresh_cache.setattr(_build, "BUILD_DIR", blocker / "build")
    with pytest.raises(RuntimeError, match=compile_cache.ENV_VAR):
        _build.load_library()
    assert compile_cache.snapshot()["compiles"] == 0


def test_engine_reports_the_cache_in_stats_and_prometheus():
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"].with_(dtype="float32")
    eng = tsrv.ServingEngine(cfg, init_params(cfg, 0, "cpu"), slots=1, max_len=32,
                             device="cpu")
    try:
        text = tsrv.prometheus_metrics(eng.stats())
    finally:
        eng.close()
    for name in ("dstack_tpu_compile_cache_hits_total",
                 "dstack_tpu_compile_cache_misses_total",
                 "dstack_tpu_compile_seconds_total"):
        assert f"# TYPE {name} counter" in text
    # On the CPU nothing builds, so the engine enables no cache.
    assert eng.stats()["compile_cache_dir"] is None
