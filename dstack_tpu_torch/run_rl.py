"""Podracer-style RL with the PyTorch port: colocated (Anakin) or
split (Sebulba) actor/learner gangs on the port's serving engine (the
counterpart of examples/rl/run_rl.py).

    python -m dstack_tpu_torch.run_rl --mode anakin                 # the card
    python -m dstack_tpu_torch.run_rl --mode anakin --device cpu --updates 5
    # one member of a three-node Sebulba gang (the orchestrator sets these
    # on every node; node 0 learns, nodes 1-2 act)
    DSTACK_TPU_RL_REFRESH_ADDR=10.0.0.1:8676 DSTACK_NODE_RANK=1 DSTACK_NODES_NUM=3 \
        python -m dstack_tpu_torch.run_rl --mode sebulba --updates 200

Two modes:

  --mode anakin    One process: actor and learner alternate on one device
                   (`rl.run_anakin`, refresh "direct"); prints its rewards
                   and rates as one JSON object.

  --mode sebulba   One process per gang member, its role picked by
                   `DSTACK_NODE_RANK`:
                     rank 0          the learner: a `WeightRefreshServer`
                                     on 0.0.0.0:<port> and a
                                     `TrajectorySink` on <port + 1>,
                                     publishes once, then `--updates`
                                     rounds of a PPO update and a publish
                     ranks 1..N-1    actors: the learner's seed-`--seed`
                                     params from the port's own init, then
                                     refresh and rollout rounds through the
                                     `ServingEngine` until `--timeout` or
                                     the learner is gone
                   The address comes from DSTACK_TPU_RL_REFRESH_ADDR, which
                   the orchestrator injects into every gang member;
                   `--gang-width` (the actors the learner folds into each
                   update) defaults to DSTACK_NODES_NUM - 1.

The toy environment (`rl.TargetTokenEnv`) rewards one target token on the
tiny RL policy (`rl.tiny_rl_config`). `--device` names the device (default:
the CUDA device; 'cpu' runs the plain PyTorch path). Every process ends
through its wires' `close()`.
"""

import argparse
import json
import os
import sys
import time
from typing import Optional

from dstack_tpu_torch.workloads.rl import (
    Actor,
    Learner,
    RLStats,
    TargetTokenEnv,
    TrajectoryClient,
    TrajectorySink,
    WeightRefreshClient,
    WeightRefreshServer,
    refresh_addr_from_env,
    rl_prometheus_metrics,
    run_anakin,
    tiny_rl_config,
)

NO_ADDRESS = ("sebulba mode needs DSTACK_TPU_RL_REFRESH_ADDR (set by the "
              "runner for gang runs; export host:port manually for local use)")


def anakin_main(args) -> int:
    out = run_anakin(tiny_rl_config(), updates=args.updates, batch_size=args.batch,
                     horizon=args.horizon, seed=args.seed, refresh="direct",
                     device=args.device)
    print(json.dumps({
        "mode": "anakin",
        "rewards": out["rewards"],
        "env_steps_per_s": round(out["env_steps_per_s"], 2),
        "learn_step_s_mean": round(out["learn_step_s_mean"], 6),
        "final_weight_epoch": out["final_weight_epoch"],
    }, indent=2))
    return 0


def learner_main(args, port: int) -> int:
    stats = RLStats()
    refresh = WeightRefreshServer(host="0.0.0.0", port=port)
    sink = None
    try:
        learner = Learner(tiny_rl_config(), seed=args.seed, learning_rate=2e-2,
                          accum_per_actor=1, gang_width=max(args.gang_width, 1),
                          refresh=refresh, stats=stats, device=args.device)
        sink = TrajectorySink("0.0.0.0", port + 1, on_batch=learner.ingest)
        learner.publish()
        for u in range(args.updates):
            metrics = learner.update_once(timeout=args.timeout)
            learner.publish()
            print(f"update {u}: reward={metrics['reward_mean']:.3f} "
                  f"loss={metrics['loss']:.4f} epoch={learner.weight_epoch}", flush=True)
        print(rl_prometheus_metrics(stats.snapshot()), flush=True)
    finally:
        if sink is not None:
            sink.close()
        refresh.close()
    return 0


def actor_main(args, host: str, port: int, rank: int) -> int:
    from dstack_tpu_torch.workloads.transformer import init_params

    config = tiny_rl_config()
    env = TargetTokenEnv(config.vocab_size, horizon=args.horizon, seed=args.seed + rank)
    refresh = WeightRefreshClient(host, port)
    traj = TrajectoryClient(host, port + 1)
    actor = None
    try:
        # The learner's epoch-0 init (the same seed on the same device), so
        # rollouts before the first refresh already run its policy.
        actor = Actor(config, init_params(config, args.seed, args.device), env,
                      actor_id=rank, batch_size=args.batch, seed=args.seed + 100 * rank,
                      refresh=refresh, stats=RLStats(), device=args.device)
        r, served = 0, False
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            try:
                actor.maybe_refresh()
                traj.send(actor.rollout(round_ix=r))
            except (ConnectionError, OSError):
                if served:
                    break  # the learner finished (or was resized away): done
                time.sleep(0.5)  # the learner is not listening yet
                continue
            served = True
            r += 1
    finally:
        traj.close()
        if actor is not None:
            actor.close()
        else:
            refresh.close()
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("anakin", "sebulba"), default="anakin")
    ap.add_argument("--updates", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gang-width", type=int,
                    default=int(os.environ.get("DSTACK_NODES_NUM", "2")) - 1,
                    help="actor count the learner folds per update")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the"
                         " plain PyTorch path)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if args.mode == "anakin":
        return anakin_main(args)
    addr = refresh_addr_from_env()
    if addr is None:
        raise SystemExit(NO_ADDRESS)
    host, port = addr
    rank = int(os.environ.get("DSTACK_NODE_RANK", "0"))
    if rank == 0:
        return learner_main(args, port)
    return actor_main(args, host, port, rank)


if __name__ == "__main__":
    raise SystemExit(main())
