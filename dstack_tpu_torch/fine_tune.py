"""Fine-tune a llama-family model with the PyTorch port, on one device
(the single-device subset of examples/fine-tuning/jax/train.py).

    python -m dstack_tpu_torch.fine_tune --steps 20                # the card
    python -m dstack_tpu_torch.fine_tune --device cpu --preset tiny --steps 3

With --checkpoint-dir the final params are written as a packed export
(`<dir>/packed/`), which `python -m dstack_tpu_torch.native_server
--checkpoint-dir <dir>` serves. Periodic train-state checkpoints, resume,
meshes and LoRA are not ported yet.
"""

import argparse
import time
from typing import Optional

from dstack_tpu_torch.workloads.config import PRESETS


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="smol-1b", choices=sorted(PRESETS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=None,
                        help="default 2048, or the preset's max_seq_len if shorter")
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' runs"
                             " the plain PyTorch path)")
    parser.add_argument("--data", default="",
                        help="flat int32 token .npy (workloads/data.py); synthetic if unset")
    parser.add_argument("--checkpoint-dir", default="",
                        help="write the final params here as a packed export that"
                             " native_server --checkpoint-dir serves. Periodic"
                             " train-state checkpoints and resume are not ported yet")
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument("--seq-parallel", type=int, default=1)
    parser.add_argument("--expert-parallel", type=int, default=1)
    parser.add_argument("--lora-rank", type=int, default=0)
    args = parser.parse_args(argv)

    unported = [f"--{name.replace('_', '-')} {getattr(args, name)}"
                for name in ("model_parallel", "seq_parallel", "expert_parallel")
                if getattr(args, name) > 1]
    if args.lora_rank > 0:
        unported.append(f"--lora-rank {args.lora_rank}")
    if unported:
        raise NotImplementedError(
            f"not ported to PyTorch yet: {', '.join(unported)} (the port trains"
            " dense models on one device)")

    from dstack_tpu_torch.workloads.train import (
        init_train_state,
        make_train_step,
        synthetic_batch,
    )
    from dstack_tpu_torch.workloads.weights import save_packed

    config = PRESETS[args.preset]
    seq_len = args.seq_len or min(2048, config.max_seq_len)
    if seq_len > config.max_seq_len:
        raise SystemExit(f"--seq-len > {config.max_seq_len} for {args.preset}")
    state = init_train_state(config, 0, args.device)
    device = state.params["embed"].device
    step = make_train_step(config, accum_steps=args.accum_steps)
    print(f"{args.preset}: {config.param_count() / 1e9:.3f}B params on {device},"
          f" batch {args.batch_size} x {seq_len}", flush=True)
    loader = None
    if args.data:
        from dstack_tpu_torch.workloads.data import BatchLoader, TokenDataset

        loader = BatchLoader(TokenDataset(args.data, seq_len), args.batch_size,
                             device=device, vocab_size=config.vocab_size)
    else:
        batch = synthetic_batch(config, args.batch_size, seq_len, device=device)
    try:
        t0 = time.monotonic()
        for i in range(args.steps):
            if loader is not None:
                batch = next(loader)
            state, metrics = step(state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i}: loss {float(metrics['loss']):.4f}"
                      f" grad_norm {float(metrics['grad_norm']):.4f}"
                      f" ({time.monotonic() - t0:.1f}s)", flush=True)
    finally:
        if loader is not None:
            loader.close()
    if args.checkpoint_dir:
        path = save_packed(args.checkpoint_dir, state.params)
        print(f"params exported to {path}", flush=True)
    print("training complete", flush=True)


if __name__ == "__main__":
    main()
