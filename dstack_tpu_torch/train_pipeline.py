"""Pipeline-parallel fine-tune with the PyTorch port (dp x pp; the
counterpart of examples/fine-tuning/jax/train_pipeline.py).

    python -m dstack_tpu_torch.train_pipeline --stages 2 --ranks 2   # two cards
    # two ranks sharing one card (gloo), or the CPU
    python -m dstack_tpu_torch.train_pipeline --stages 2 --ranks 2 --device cuda:0 \\
        --dist-backend gloo
    python -m dstack_tpu_torch.train_pipeline --device cpu --preset tiny --stages 2 \\
        --ranks 4 --seq-len 64 --steps 3
    # one host of a two-host gang, two stages a host (host 1: JAX_PROCESS_ID=1)
    JAX_COORDINATOR_ADDRESS=10.0.0.1:8476 JAX_PROCESS_ID=0 JAX_NUM_PROCESSES=2 \\
        python -m dstack_tpu_torch.train_pipeline --stages 2 --ranks 4

workloads/pipeline.py cuts the layer stack into `--stages` and streams
`--microbatches` through the explicit GPipe schedule; the ranks left over
form the data axis (`--ranks` / `--stages`). `--ranks N` is the world
(default `--stages`): rank 0 starts ranks 1..N-1 itself, as fresh
interpreters of this module on a loopback rendezvous (`--rank r
--dist-init tcp://127.0.0.1:<port>`), and is the only rank that prints.
Rank r runs on `cuda:r`, or on `--device` for every rank when it is
given; `--dist-backend` is nccl (the default on CUDA, one rank per card)
or gloo (the default on the CPU, and the transport for ranks that share a
card). The batch rounds up to a multiple of microbatches x data, as the
JAX trainer rounds it; every rank draws the same whole params from seed 0
and keeps its stage.

Across hosts, as fine_tune: with the orchestrator's
`JAX_COORDINATOR_ADDRESS` / `JAX_PROCESS_ID` / `JAX_NUM_PROCESSES` (> 1) on
every host, `--ranks` defaults to the hosts x each host's cards (one rank a
host with `--device`) and must be a multiple of the hosts; each host's
process starts its host's ranks (rank = `JAX_PROCESS_ID` x ranks a host +
the rank's index there, on `cuda:<index>`), every rank joins one group at
the coordinator's address after checking that every host runs the same
command, and each host's process prints which ranks it runs. The stages
and the data axis are cut over the whole world as on one host.
"""

import argparse
import os
import sys
import time
from typing import Optional

from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.sharding import (
    BACKENDS,
    gang_world,
    leave_ranks,
    rank_device,
    start_ranks,
    stop_followers,
)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="smol-1b", choices=sorted(PRESETS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--stages", type=int, default=4)
    parser.add_argument("--microbatches", type=int, default=8)
    parser.add_argument("--ranks", type=int, default=None,
                        help="the world: ranks 1..N-1 are started by rank 0 (default:"
                             " --stages; in a gang of hosts, JAX_NUM_PROCESSES x the"
                             " host's cards); data takes N / --stages")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the rank's card on its host);"
                             " every rank runs on it"
                             " when given ('cpu' runs the plain PyTorch path)")
    parser.add_argument("--dist-backend", choices=BACKENDS, default=None,
                        help="nccl (default on CUDA, one rank per card) or gloo (default"
                             " on the CPU; ranks that share a card)")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dist-init", default="", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    config = PRESETS[args.preset]
    try:
        world, gang = gang_world(os.environ, args.ranks, args.device, args.stages)
    except ValueError as e:
        raise SystemExit(f"invalid gang: {e}")
    if args.stages < 1 or world % args.stages:
        raise SystemExit(f"--stages {args.stages} must divide {world} ranks")
    if config.n_layers % args.stages:
        raise SystemExit(f"--stages {args.stages} must divide {args.preset}'s"
                         f" {config.n_layers} layers")
    if args.seq_len > config.max_seq_len:
        raise SystemExit(f"--seq-len > {config.max_seq_len} for {args.preset}")
    followers, device = [], args.device
    if world > 1:
        try:
            rank, followers = start_ranks(
                world, args.rank, args.dist_init, args.dist_backend, args.device,
                ["-m", "dstack_tpu_torch.train_pipeline", *argv], gang)
        except ValueError as e:
            raise SystemExit(f"invalid pipeline configuration: {e}")
        if gang is not None and not args.dist_init:
            print(gang.describe(world), flush=True)
        device = rank_device(rank, gang, args.device)
    try:
        _train(args, config, world, device)
    finally:
        if world > 1:
            leave_ranks()
        stop_followers(followers)


def _train(args, config, world: int, device) -> None:
    from dstack_tpu_torch.workloads.pipeline import (
        init_pipeline_state,
        make_pipeline_mesh,
        make_pipeline_train_step,
        pipeline_batch,
    )

    mesh = make_pipeline_mesh(None if device is None else [device],
                              data=world // args.stages, pipe=args.stages)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    state = init_pipeline_state(config, 0, mesh)
    step = make_pipeline_train_step(config, mesh, n_microbatches=args.microbatches)
    dp = mesh.shape["data"]
    per = args.microbatches * dp
    batch_size = -(-args.batch_size // per) * per
    if batch_size != args.batch_size:
        say(f"batch size {args.batch_size} -> {batch_size} (divisible by {per})")
    say(f"{args.preset}: {config.param_count() / 1e9:.3f}B params on {mesh.device},"
        f" batch {batch_size} x {args.seq_len}, {world} ranks (data {dp} x pipe"
        f" {args.stages}), {args.microbatches} microbatches", flush=True)
    batch = pipeline_batch(config, batch_size, args.seq_len, mesh)
    t0 = time.monotonic()
    for i in range(args.steps):
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i}: loss {float(metrics['loss']):.4f}"
                f" grad_norm {float(metrics['grad_norm']):.4f}"
                f" ({time.monotonic() - t0:.1f}s)", flush=True)
    say("training complete", flush=True)


if __name__ == "__main__":
    main()
