"""Fine-tune a llama-family model with the PyTorch port (the counterpart
of examples/fine-tuning/jax/train.py).

    python -m dstack_tpu_torch.fine_tune --steps 20                # the card
    python -m dstack_tpu_torch.fine_tune --device cpu --preset tiny --steps 3
    # ring attention over 4 sequence shards, long context, on the card
    python -m dstack_tpu_torch.fine_tune --preset smol-1b-8k --seq-len 8192 \
        --batch-size 1 --seq-parallel 4
    # LoRA adapters (rank 8 on wq/wv) over the frozen base
    python -m dstack_tpu_torch.fine_tune --lora-rank 8 --checkpoint-dir ckpt
    # tensor parallelism over 2 ranks, one per card
    python -m dstack_tpu_torch.fine_tune --model-parallel 2
    # 4 ranks on 4 cards: model 2 x fsdp 2
    python -m dstack_tpu_torch.fine_tune --model-parallel 2 --ranks 4
    # the ring across 4 ranks (one seq shard each), four ranks on one card
    python -m dstack_tpu_torch.fine_tune --preset smol-1b-8k --seq-len 8192 \
        --batch-size 1 --seq-parallel 4 --ranks 4 --device cuda:0 --dist-backend gloo
    # two ranks sharing one card (gloo), or the CPU
    python -m dstack_tpu_torch.fine_tune --model-parallel 2 --device cuda:0 \
        --dist-backend gloo
    python -m dstack_tpu_torch.fine_tune --device cpu --preset tiny --model-parallel 2
    # expert parallelism: smol-moe's 8 experts over 2 ranks, 4 each
    python -m dstack_tpu_torch.fine_tune --preset smol-moe --expert-parallel 2
    python -m dstack_tpu_torch.fine_tune --device cpu --preset tiny-moe \
        --expert-parallel 2 --ranks 4 --seq-len 64
    # one host of a two-host gang (the orchestrator sets these on every host;
    # host 1 runs the same command with JAX_PROCESS_ID=1)
    JAX_COORDINATOR_ADDRESS=10.0.0.1:8476 JAX_PROCESS_ID=0 JAX_NUM_PROCESSES=2 \
        python -m dstack_tpu_torch.fine_tune --model-parallel 2

Training across ranks. `--ranks N` sets the trainer's world, its number of
ranks (default: `--model-parallel` x `--expert-parallel` x `--seq-parallel`
when `--model-parallel` x `--expert-parallel` > 1, one rank per model,
expert and seq shard): rank 0 starts
ranks 1..N-1 itself, as fresh interpreters of this module (`--rank r
--dist-init tcp://127.0.0.1:<port>`, a loopback port rank 0 picks), so a
job command stays one process. The mesh is the reference's training layout
over those ranks (workloads/sharding.py, `layout="training"`): a model axis
of `--model-parallel`, an expert axis of `--expert-parallel` (each rank
holding E/expert of every expert bank; the ranks of an expert line hold
the same rows), a seq axis of `--seq-parallel` (the ring across the ranks,
each holding one stretch of the sequence) and fsdp taking what is left, as
the JAX trainer's mesh over `jax.devices()`; the global batch is
rounded up to a multiple of data x fsdp, as the JAX trainer rounds it. Rank r runs on `cuda:r`, or on
`--device` for every rank when it is given; `--dist-backend` is nccl (the
default on CUDA, one rank per card) or gloo (the default on the CPU, and
the transport for ranks that share a card). Every rank draws the same
whole params from seed 0 and keeps its slices; checkpoints and the export
are written whole by rank 0 from every rank's shards, so a run resumes on
any number of ranks. Only rank 0 prints. `--expert-parallel` must divide
the preset's n_experts, as the JAX trainer checks. An MoE preset trains
over a seq axis of ranks (each rank routes its stretch of a row at the
row's whole capacity and slots, workloads/moe.py), and LoRA trains over
ranks on an MoE preset and an expert axis.

Across hosts. A job the orchestrator spreads over hosts runs the same
command on every host with `JAX_COORDINATOR_ADDRESS`, `JAX_PROCESS_ID` and
`JAX_NUM_PROCESSES` set (the variables the JAX trainer's
`jax.distributed.initialize()` reads); with `JAX_NUM_PROCESSES` > 1 the
hosts form one gang. `--ranks` then defaults to `JAX_NUM_PROCESSES` x
the host's cards (every card of every host, the JAX trainer's
`jax.device_count()`; one rank a host with `--device`), and a given
`--ranks` must be a multiple of the hosts. Each host's process starts its
host's `--ranks / JAX_NUM_PROCESSES` ranks, rank = `JAX_PROCESS_ID` x
that + the rank's index on its host, on `cuda:<index>` (or `--device`);
every rank of every host joins one group at the coordinator's address
(global rank 0 hosts it) and checks that every host runs the same
command. The mesh axes are cut over the whole world as on one host. Each
host's process prints `process h/N runs ranks a-b of W`; only global rank
0 prints the training lines. SIGTERM to any host's process drains every
rank at one step. Every host must see `--checkpoint-dir` and `--data`
(one volume mounted on each host, as the JAX trainer's checkpoints need):
rank 0 writes the checkpoints and every rank reads them on resume.

`--seq-parallel n` alone (one rank) builds a seq mesh whose n sequence
shards take turns on the one device through the ring
(workloads/attention.py); it works on the CPU too (`--device cpu --preset
tiny --seq-parallel 4 --seq-len 256`). With `--ranks` or
`--model-parallel` > 1 the seq axis runs over the ranks instead.

`--checkpoint-dir` (default `$CHECKPOINT_DIR`, a directory on a mounted
volume) makes a run resumable, as the JAX example trainer: the newest
train-state checkpoint there is restored and the loop continues from its
step (the data loader too); a checkpoint is saved every 100 steps and at
the last step, and the final params are exported (`<dir>/packed/`), which
`python -m dstack_tpu_torch.native_server --checkpoint-dir <dir>` serves.
A retried job therefore resumes where the last one saved. With a
checkpoint dir, SIGTERM (a preemption or maintenance notice) drains the
run: the step in flight finishes, a checkpoint is saved and the process
exits 113 (train.DrainHandler), and the resubmitted job resumes there. On
the card the kernel library is built into `$DSTACK_TPU_COMPILE_CACHE` when
it is set (workloads/compile_cache.py), so a repeat boot on the same
volume skips the build.

`--lora-rank r` trains rank-r adapters on wq and wv over the frozen base
(workloads/lora.py), as the JAX example trainer: the base is
`init_params(config, seed 0)` and the adapters are drawn from a torch
generator seeded at 1 (the JAX trainer's `PRNGKey(0)` and `PRNGKey(1)`;
torch cannot draw the same numbers). Checkpoints hold the adapters and
their moments; the export is the merged params, which native_server
serves unchanged. It composes with --seq-parallel and with ranks. The JAX
LoRA step has no gradient accumulation, so --accum-steps > 1 with
--lora-rank raises. An MoE preset (`--preset tiny-moe` / `smol-moe`)
trains with its router loss in the objective (`router_aux_coef`), printed
beside the loss; over ranks the loss and the printed `router_aux` are the
global batch's (workloads/moe.py, `switch_aux`).
"""

import argparse
import os
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.sharding import (
    BACKENDS,
    any_rank,
    batch_shards,
    check_heads,
    gang_world,
    join_ranks,
    leave_ranks,
    make_mesh,
    shard_tree,
    stop_followers,
    unshard_tree,
)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="smol-1b", choices=sorted(PRESETS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=None,
                        help="default 2048, or the preset's max_seq_len if shorter")
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device, on ranks the"
                             " rank's card on its host; 'cpu' runs the plain PyTorch"
                             " path); with --ranks > 1 every rank runs on it")
    parser.add_argument("--data", default="",
                        help="flat int32 token .npy (workloads/data.py); synthetic if unset")
    parser.add_argument("--checkpoint-dir", default=os.environ.get("CHECKPOINT_DIR", ""),
                        help="directory on a mounted volume: resume from its newest"
                             " checkpoint, save every 100 steps and at the end, and"
                             " export the final params for native_server")
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument("--seq-parallel", type=int, default=1)
    parser.add_argument("--expert-parallel", type=int, default=1)
    parser.add_argument("--ranks", type=int, default=None,
                        help="the trainer's world: ranks 1..N-1 are started by rank 0"
                             " (default: --model-parallel x --expert-parallel x"
                             " --seq-parallel when --model-parallel x --expert-parallel"
                             " > 1, else 1; in a gang of hosts, JAX_NUM_PROCESSES x the"
                             " host's cards); the seq axis runs over the ranks and fsdp"
                             " takes N / (--model-parallel x --expert-parallel x"
                             " --seq-parallel)")
    parser.add_argument("--dist-backend", choices=BACKENDS, default=None,
                        help="transport between ranks: nccl (default on CUDA, one"
                             " rank per card) or gloo (default on the CPU; ranks"
                             " that share a card)")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dist-init", default="", help=argparse.SUPPRESS)
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="train low-rank adapters over the frozen base"
                             " (0 = full fine-tune)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    parallel = args.model_parallel * args.expert_parallel
    try:  # --seq-parallel alone keeps the one-device ring
        world, gang = gang_world(os.environ, args.ranks, args.device,
                                 parallel * (args.seq_parallel if parallel > 1 else 1))
    except ValueError as e:
        raise SystemExit(f"invalid gang: {e}")

    cut = parallel * (args.seq_parallel if world > 1 else 1)
    if min(args.model_parallel, args.expert_parallel, args.seq_parallel) < 1 or world % cut:
        raise SystemExit(f"--model-parallel {args.model_parallel} x --expert-parallel"
                         f" {args.expert_parallel} x --seq-parallel {args.seq_parallel}"
                         f" must divide the {world} ranks")
    if args.lora_rank > 0 and args.accum_steps > 1:
        raise NotImplementedError(
            f"--accum-steps {args.accum_steps} with --lora-rank: the LoRA step"
            " has no gradient accumulation (as the JAX package's)")

    config = PRESETS[args.preset]
    if args.expert_parallel > 1 and config.n_experts % args.expert_parallel:
        raise SystemExit("--expert-parallel must divide the preset's n_experts")
    seq_len = args.seq_len or min(2048, config.max_seq_len)
    if seq_len > config.max_seq_len:
        raise SystemExit(f"--seq-len > {config.max_seq_len} for {args.preset}")
    mesh, followers = None, []
    if seq_len % args.seq_parallel:
        raise SystemExit(f"--seq-parallel {args.seq_parallel} must divide"
                         f" --seq-len {seq_len}")
    if world == 1 and args.seq_parallel > 1:
        mesh = make_mesh(None if args.device is None else [args.device],
                         seq=args.seq_parallel)
    elif world > 1:
        try:
            check_heads(args.model_parallel, config)
            mesh, followers = join_ranks(
                world, args.rank, args.dist_init, args.dist_backend, args.device,
                ["-m", "dstack_tpu_torch.fine_tune", *argv], layout="training",
                gang=gang, model=args.model_parallel, seq=args.seq_parallel,
                expert=args.expert_parallel)
        except ValueError as e:
            raise SystemExit(f"invalid training configuration: {e}")
        if gang is not None and not args.dist_init:
            print(gang.describe(world), flush=True)
    try:
        _train(args, config, seq_len, mesh)
    finally:
        if mesh is not None and mesh.ranked:
            leave_ranks(mesh)
        stop_followers(followers)


def _train(args, config, seq_len: int, mesh) -> None:
    from dstack_tpu_torch.workloads import checkpoint as ckpt
    from dstack_tpu_torch.workloads.train import (
        TrainState,
        init_train_state,
        install_drain_handler,
        make_train_step,
        synthetic_batch,
    )

    ranks = mesh if mesh is not None and mesh.ranked else None  # the mesh over ranks
    say = print if ranks is None or ranks.rank == 0 else (lambda *a, **k: None)
    # One state and one step either way; LoRA swaps in the adapter state
    # and a step closed over the frozen base. Data, checkpoints, drain and
    # the loop below are shared.
    if args.lora_rank > 0:
        from dstack_tpu_torch.workloads.lora import (
            init_lora_state,
            lora_param_count,
            make_lora_train_step,
            merge_lora,
        )
        from dstack_tpu_torch.workloads.train import _device_of
        from dstack_tpu_torch.workloads.transformer import detach_params, init_params

        base = shard_tree(mesh, init_params(config, 0, _device_of(args.device, mesh)))
        state = init_lora_state(config, base, 1, rank=args.lora_rank, mesh=mesh)
        device = base["embed"].device
        lora_step = make_lora_train_step(config, mesh, rank=args.lora_rank)

        def step(s, b):
            return lora_step(s, base, b)

        def export(final_state):
            # Serve the merged model; the checkpoints hold the adapters.
            with torch.no_grad():
                merged = merge_lora(unshard_tree(mesh, base),
                                    unshard_tree(mesh, detach_params(final_state.lora)),
                                    rank=args.lora_rank)
            path = Path(args.checkpoint_dir) / "packed"
            if ranks is None or ranks.rank == 0:
                path = ckpt.export_params(args.checkpoint_dir,
                                          TrainState(final_state.step, merged, None))
            return path

        what = (f", LoRA rank {args.lora_rank} on wq/wv"
                f" ({lora_param_count(state.lora) / 1e6:.3f}M adapter params"
                f"{' on this rank' if ranks else ''})")
    else:
        state = init_train_state(config, 0, args.device, mesh=mesh)
        device = state.params["embed"].device
        step = make_train_step(config, mesh, accum_steps=args.accum_steps)

        def export(final_state):
            return ckpt.export_params(args.checkpoint_dir, final_state, mesh)

        what = ""
    batch_size, where = args.batch_size, ""
    if ranks is not None:
        # The global batch splits over data x fsdp: round it up so every
        # rank gets its rows, as the JAX trainer does.
        dp = batch_shards(mesh)
        batch_size = -(-args.batch_size // dp) * dp
        if batch_size != args.batch_size:
            say(f"batch size {args.batch_size} -> {batch_size} (divisible by {dp})")
        where = (f", {dist.get_world_size()} ranks over {mesh.backend} ("
                 + " x ".join(f"{a} {n}" for a, n in mesh.shape.items() if n > 1) + ")")
    elif mesh is not None:
        where = f", ring over {args.seq_parallel} seq shards"
    say(f"{args.preset}: {config.param_count() / 1e9:.3f}B params on {device},"
        f" batch {batch_size} x {seq_len}{where}{what}", flush=True)
    if args.checkpoint_dir:
        # Resume from the volume: a retried job continues at the last saved
        # step instead of step 0.
        restored = ckpt.restore_latest(args.checkpoint_dir, state, mesh)
        if restored is not None:
            state = restored
            say(f"resumed from step {state.step}", flush=True)
    start = state.step
    loader = None
    if args.data:
        from dstack_tpu_torch.workloads.data import BatchLoader, TokenDataset

        loader = BatchLoader(TokenDataset(args.data, seq_len), batch_size,
                             device=device, start_step=start,
                             vocab_size=config.vocab_size, mesh=ranks)
    else:
        batch = synthetic_batch(config, batch_size, seq_len, device=device, mesh=ranks)
    # Drain needs somewhere to save to, and signal handlers install from
    # the main thread only. Over ranks the ranks agree on it every step,
    # so all of them checkpoint at the same step.
    drain = (install_drain_handler() if args.checkpoint_dir
             and threading.current_thread() is threading.main_thread() else None)
    try:
        t0 = time.monotonic()
        for i in range(start, args.steps):
            if loader is not None:
                batch = next(loader)
            state, metrics = step(state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                # The LoRA step's metrics carry no router loss (as JAX's).
                aux = (f" router_aux {float(metrics['router_aux']):.4f}"
                       if config.n_experts > 0 and "router_aux" in metrics else "")
                say(f"step {i}: loss {float(metrics['loss']):.4f}"
                    f" grad_norm {float(metrics['grad_norm']):.4f}{aux}"
                    f" ({time.monotonic() - t0:.1f}s)", flush=True)
            if drain is not None and any_rank(drain.draining, ranks):
                drain.checkpoint_and_exit(args.checkpoint_dir, state, mesh=ranks)
            if args.checkpoint_dir and ((i + 1) % 100 == 0 or i == args.steps - 1):
                # Block on the last one so the job ends with it on disk.
                ckpt.save(args.checkpoint_dir, state, wait=i == args.steps - 1, mesh=ranks)
    finally:
        if loader is not None:
            loader.close()
        if drain is not None:
            drain.restore()
    if args.checkpoint_dir:
        path = export(state)
        ckpt.close_all()
        say(f"params exported to {path}", flush=True)
    say("training complete", flush=True)


if __name__ == "__main__":
    main()
