"""Accumulation-step rescaling across an elastic resize (the port's copy of
`dstack_tpu.parallel.mesh.rescale_accum_steps`, which the port may not
import)."""


def rescale_accum_steps(accum_steps: int, old_width: int, new_width: int) -> int:
    """Gradient-accumulation steps after an elastic data-parallel resize,
    preserving the global batch: accum_steps x dp_width is invariant, so the
    loss trajectory (and LR schedule) is bit-compatible with the full-width
    run. Raises when the global step count does not divide evenly at the new
    width — the caller must then choose a different microbatch split rather
    than silently training at a different batch size.

    Rounding contract: there is NONE. The result is always the exact
    integer `accum_steps * old_width / new_width`; widths where that
    quotient is not an integer raise ValueError rather than rounding in
    either direction (floor would shrink the global batch, ceil would
    grow it — both silently change the effective batch size and detach
    the loss trajectory from the full-width run). The same invariant
    backs actor-gang resize in the RL workload (workloads/rl.py), where
    accum-per-actor x gang_width keeps trajectories-per-update fixed.
    Both arguments must be positive; zero and negative widths raise.
    Identity resizes (old_width == new_width) always succeed and return
    accum_steps unchanged.
    """
    if old_width <= 0 or new_width <= 0:
        raise ValueError(f"mesh widths must be positive, got {old_width}->{new_width}")
    total = accum_steps * old_width
    if total % new_width != 0:
        raise ValueError(
            f"global batch of {total} microbatches does not divide evenly"
            f" across dp width {new_width}; pick accum_steps so that"
            f" accum_steps * width is divisible by every width you may"
            f" shrink to"
        )
    return total // new_width
