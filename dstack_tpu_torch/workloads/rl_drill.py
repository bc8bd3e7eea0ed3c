"""Headless Sebulba RL gang drill (the port of
`dstack_tpu.workloads.rl_drill`).

    python -m dstack_tpu_torch.workloads.rl_drill [--device cpu] [--preset P]

Topology: this (parent) process is the LEARNER — PPO updates, the
WeightRefreshServer, the TrajectorySink, a /metrics endpoint rendering the
RL metric series — and each ACTOR is a real OS subprocess running a
ServingEngine rollout loop, pulling weights over the refresh socket and
pushing trajectory frames back over the sink socket, with DSTACK_RUN_NAME
set so stage markers ride stdout exactly as they would under the runner
agent. On CUDA every process shares the one card, and the parent builds
the kernel library (into the kernel cache when DSTACK_TPU_COMPILE_CACHE is
set) before it spawns, so no actor pays the build.

Scenario (elastic resize applied to an actor gang):

  1. width 2: two actors feed the learner; weights publish per update.
  2. PREEMPTION: one actor is SIGKILLed mid-rollout. The supervisor writes
     the runner's resize-notice file (width 2 -> 1); the learner picks it
     up inside `gather` and rescales accum-per-actor via
     `rescale_accum_steps` — batches-per-update and the stacked batch
     shape are invariant, so there are ZERO learner restarts (asserted).
  3. width 1: the survivor alone carries the gang (two rounds/update).
  4. RE-EXPAND: a replacement actor spawns, adopts the newest weight epoch
     on its first poll (epoch fencing: it jumps straight to the head,
     never replays intermediate epochs), and the notice flips back to
     width 2.
  5. After the final publish the drill waits until EVERY surviving actor's
     trajectory stamp equals the learner's epoch — the "no actor left
     stale" gate.

Asserts: learner restarts == 0, gang resizes == 2, a rollout_start ->
weight_refresh -> learn_step stage ordering in the merged timeline, and
/metrics exposing dstack_tpu_rl_env_steps_total and
dstack_tpu_rl_refresh_staleness_epochs. Prints a JSON summary; exits
nonzero on any failure. `--device` defaults to the CUDA device (`cpu`
runs the plain PyTorch path); `--preset` names a model preset, by default
the tiny RL policy (`rl.tiny_rl_config`).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = str(Path(__file__).resolve().parents[2])

RUN_NAME = "rl-drill"
PROMPT_LEN = 4
HORIZON = 8
BATCH = 4
TARGET = 7
TINY_RL = "tiny-rl"


def drill_config(preset: str = TINY_RL):
    """The policy config: `rl.tiny_rl_config()` for "tiny-rl", else the
    named preset."""
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.rl import tiny_rl_config

    return tiny_rl_config() if preset == TINY_RL else PRESETS[preset]


# -- actor subprocess ---------------------------------------------------------


def actor_main(args) -> int:
    os.environ.setdefault("DSTACK_RUN_NAME", RUN_NAME)
    from dstack_tpu_torch.workloads.rl import (
        Actor,
        TargetTokenEnv,
        TrajectoryClient,
        WeightRefreshClient,
    )
    from dstack_tpu_torch.workloads.transformer import init_params

    config = drill_config(args.preset)
    env = TargetTokenEnv(config.vocab_size, prompt_len=PROMPT_LEN, horizon=HORIZON,
                         target=TARGET, seed=args.seed + args.actor_id)
    # Same init seed as the learner: every process starts on the same
    # epoch-0 policy; later epochs arrive only through the refresh channel.
    params = init_params(config, args.seed, args.device)
    actor = Actor(
        config, params, env,
        actor_id=args.actor_id, batch_size=BATCH,
        seed=args.seed + 100 * args.actor_id,
        refresh=WeightRefreshClient("127.0.0.1", args.refresh_port),
        device=args.device,
    )
    sink = TrajectoryClient("127.0.0.1", args.traj_port)
    for r in range(args.rounds):
        actor.maybe_refresh()
        sink.send(actor.rollout(r))
    actor.close()
    sink.close()
    return 0


# -- learner / supervisor -----------------------------------------------------


class _Timeline:
    """Merged stage-event record: parent-side learn_steps plus stage
    markers parsed off each actor's stdout."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: List[Tuple[float, str, str]] = []  # (t, source, stage)

    def add(self, source: str, stage: str) -> None:
        with self._lock:
            self.events.append((time.monotonic(), source, stage))

    def first(self, stage: str) -> Optional[float]:
        with self._lock:
            ts = [t for t, _, s in self.events if s == stage]
        return min(ts) if ts else None

    def any_after(self, stage: str, t: float) -> bool:
        with self._lock:
            return any(s == stage and et > t for et, _, s in self.events)


def _spawn_actor(actor_id: int, *, seed: int, device: str, preset: str,
                 refresh_port: int, traj_port: int, rounds: int,
                 timeline: _Timeline, echo: bool) -> subprocess.Popen:
    from dstack_tpu_torch.utils.stagemarkers import parse_stage_marker

    env = dict(os.environ)
    env["DSTACK_RUN_NAME"] = RUN_NAME
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.workloads.rl_drill",
         "--actor", "--actor-id", str(actor_id), "--seed", str(seed),
         "--device", device, "--preset", preset,
         "--refresh-port", str(refresh_port),
         "--traj-port", str(traj_port), "--rounds", str(rounds)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=_REPO_ROOT, env=env,
    )

    def _pump():
        for line in proc.stdout:
            stage = parse_stage_marker(line)
            if stage is not None:
                timeline.add(f"actor-{actor_id}", stage)
            if echo:
                sys.stdout.write(f"[actor-{actor_id}] {line}")
                sys.stdout.flush()

    threading.Thread(target=_pump, daemon=True).start()
    return proc


def run_drill(*, seed: int = 0, updates_per_phase: int = 2, echo: bool = False,
              timeout_s: float = 420.0, device: Optional[str] = None,
              preset: str = TINY_RL) -> Dict:
    from dstack_tpu_torch.workloads import compile_cache
    from dstack_tpu_torch.workloads.device import resolve_device
    from dstack_tpu_torch.workloads.rl import (
        Learner,
        RLStats,
        TrajectorySink,
        WeightRefreshServer,
        rl_prometheus_metrics,
    )
    from dstack_tpu_torch.workloads.train import read_resize_notice

    t_start = time.monotonic()
    deadline = t_start + timeout_s
    device = str(resolve_device(device))
    os.environ["DSTACK_RUN_NAME"] = RUN_NAME
    compile_cache.prebuild(device)
    config = drill_config(preset)
    stats = RLStats()
    timeline = _Timeline()
    learner_starts = 0

    refresh = WeightRefreshServer()
    learner = Learner(
        config, seed=seed, learning_rate=2e-2,
        accum_per_actor=1, gang_width=2, refresh=refresh, stats=stats,
        device=device,
    )
    learner_starts += 1
    last_stamp: Dict[int, int] = {}
    stamp_lock = threading.Lock()

    def on_batch(tb):
        with stamp_lock:
            last_stamp[tb.actor_id] = tb.weight_epoch
        stats.note_actor_epoch(tb.actor_id, tb.weight_epoch)
        stats.count_rollout(
            env_steps=tb.env_steps, episodes=tb.tokens.shape[0],
            reward_mean=float(tb.rewards.sum() / max(tb.mask.sum(), 1.0)),
        )
        learner.ingest(tb)

    sink = TrajectorySink(on_batch=on_batch)

    class _Metrics(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = rl_prometheus_metrics(stats.snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Metrics)
    metrics_port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    resize_path = os.path.join(tempfile.gettempdir(), f"rl_drill_resize_{os.getpid()}.json")

    def write_resize(width: int, total: int) -> None:
        tmp = resize_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"width": width, "total": total}, f)
        os.replace(tmp, resize_path)

    def poll_resize() -> None:
        notice = read_resize_notice(resize_path)
        if notice and notice["width"] != learner.gang_width:
            learner.rescale_gang(notice["width"])

    procs: Dict[int, subprocess.Popen] = {}
    failures: List[str] = []
    preemptions = 0

    def check(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)

    def run_updates(n: int) -> None:
        for _ in range(n):
            left = max(deadline - time.monotonic(), 1.0)
            learner.update_once(timeout=left, poll=poll_resize)
            timeline.add("learner", "learn_step")
            learner.publish()

    def spawn(actor_id: int) -> subprocess.Popen:
        return _spawn_actor(actor_id, seed=seed, device=device, preset=preset,
                            refresh_port=refresh.port, traj_port=sink.port,
                            rounds=100000, timeline=timeline, echo=echo)

    try:
        for actor_id in (0, 1):
            procs[actor_id] = spawn(actor_id)

        # Phase A: full-width gang.
        run_updates(updates_per_phase)

        # Preemption: SIGKILL actor 1 mid-rollout (its loop runs
        # continuously, so the kill lands inside a round), then the
        # supervisor announces the shrink through the runner's resize
        # notice format.
        procs[1].kill()
        procs[1].wait()
        preemptions = 1
        write_resize(1, 2)

        # Phase B: the survivor carries the gang at width 1 (the resize is
        # picked up inside gather; accum-per-actor doubles, the stacked
        # batch shape does not change).
        run_updates(updates_per_phase)
        check(learner.gang_width == 1,
              f"gang_width {learner.gang_width} != 1 after shrink")
        check(learner.accum_per_actor == 2,
              f"accum_per_actor {learner.accum_per_actor} != 2 at width 1")

        # Re-expand: a replacement actor (fresh process, fresh id) joins;
        # its first refresh poll jumps straight to the newest epoch.
        procs[2] = spawn(2)
        write_resize(2, 2)

        # Phase C: full width again.
        run_updates(updates_per_phase)
        check(learner.gang_width == 2,
              f"gang_width {learner.gang_width} != 2 after re-expand")

        # Convergence gate: every surviving actor's NEXT trajectory must be
        # stamped with the learner's final epoch — both adopted the last
        # published weights.
        final_epoch = learner.weight_epoch
        survivors = (0, 2)
        while time.monotonic() < deadline:
            with stamp_lock:
                stamps = {a: last_stamp.get(a, -1) for a in survivors}
            if all(s == final_epoch for s in stamps.values()):
                break
            time.sleep(0.2)
        with stamp_lock:
            stamps = {a: last_stamp.get(a, -1) for a in survivors}
        for a in survivors:
            check(stamps[a] == final_epoch,
                  f"actor {a} final epoch {stamps[a]} != learner's {final_epoch}")

        # Timeline ordering: a rollout preceded the first weight refresh,
        # and a learn step landed after that refresh.
        t_roll = timeline.first("rollout_start")
        t_refresh = timeline.first("weight_refresh")
        check(t_roll is not None, "no rollout_start stage event")
        check(t_refresh is not None, "no weight_refresh stage event")
        if t_roll is not None and t_refresh is not None:
            check(t_roll < t_refresh, "rollout_start did not precede weight_refresh")
            check(timeline.any_after("learn_step", t_refresh),
                  "no learn_step after the first weight_refresh")

        # Metrics endpoint: the rl series must be live.
        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics_port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
        for needle in ("dstack_tpu_rl_env_steps_total",
                       "dstack_tpu_rl_refresh_staleness_epochs",
                       "dstack_tpu_rl_weight_epoch"):
            check(needle in body, f"/metrics missing {needle}")

        check(learner_starts == 1, f"learner restarted ({learner_starts} starts)")
        check(stats.snapshot()["gang_resizes_total"] == 2,
              "expected exactly 2 gang resizes (shrink + re-expand)")
        check(learner.updates == 3 * updates_per_phase,
              f"learner ran {learner.updates} updates, expected"
              f" {3 * updates_per_phase}")
    except TimeoutError as e:
        failures.append(f"timeout: {e}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
        for proc in procs.values():
            proc.wait()  # killed: no actor outlives the drill
        httpd.shutdown()
        sink.close()
        refresh.close()
        try:
            os.remove(resize_path)
        except OSError:
            pass

    snap = stats.snapshot()
    return {
        "ok": not failures,
        "failures": failures,
        "elapsed_s": round(time.monotonic() - t_start, 2),
        "device": device,
        "preset": preset,
        "learner_restarts": learner_starts - 1,
        "learner_updates": learner.updates,
        "gang_resizes": snap["gang_resizes_total"],
        "preemptions": preemptions,
        "final_weight_epoch": learner.weight_epoch,
        "actor_final_epochs": {str(k): v for k, v in sorted(last_stamp.items())},
        "env_steps_total": snap["env_steps_total"],
        "refresh_publishes": snap["refresh_published_total"],
        "staleness_epochs": {str(k): v for k, v in sorted(
            snap["staleness_epochs"].items())},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--actor", action="store_true",
                        help="internal: run as an actor subprocess")
    parser.add_argument("--actor-id", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu'"
                             " runs the plain PyTorch path)")
    parser.add_argument("--preset", default=TINY_RL,
                        help=f"model preset, or {TINY_RL!r} (rl.tiny_rl_config)")
    parser.add_argument("--refresh-port", type=int, default=0)
    parser.add_argument("--traj-port", type=int, default=0)
    parser.add_argument("--rounds", type=int, default=100000)
    parser.add_argument("--updates-per-phase", type=int, default=2)
    parser.add_argument("--echo", action="store_true",
                        help="echo actor stdout through the parent")
    parser.add_argument("--timeout", type=float, default=420.0)
    args = parser.parse_args(argv)
    if args.actor:
        return actor_main(args)
    summary = run_drill(seed=args.seed, updates_per_phase=args.updates_per_phase,
                        echo=args.echo, timeout_s=args.timeout, device=args.device,
                        preset=args.preset)
    print(json.dumps(summary, indent=2))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
