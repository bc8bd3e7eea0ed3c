"""The port's ring attention on the CPU against the JAX package's, on the
same numpy inputs: one ring step's partials (`_block_attend`,
`_block_ref_bh`, `flash_block_attend`), the ring step's custom VJP, the
whole ring on a 4-way seq mesh (forward and grads), and one train step of
tiny over that mesh.

Tolerances. f32: 1e-5 of the output's largest magnitude for a step's
partials and the ring's forward (summation order only; readings ~2e-7),
1e-5 relative norm for the ring step's VJP, 1e-4 relative norm for the
ring's grads; for the train step, loss and grad norm 1e-5 relative and
each leaf's update 1e-3 relative norm (Adam's first step is about
lr * sign(g), and a grad element that cancels to f32 noise can flip its
sign: read 3.2e-4 on w_down, where one element of 65536 moved 2.5e-5). bf16
step partials: 1e-3 of the largest magnitude, because `_block_attend`
rounds P to bf16 and an f32 p one ulp apart in the two frameworks can
round to neighbouring bf16 values (read 2.1e-4 on o; m and l ~3e-7).

The JAX ring runs its Pallas kernel ("interpret", on the CPU) only where
its `use_flash` admits the shard (head_dim and shard length multiples of
128), so the comparisons in that mode use hd 128 and S 512 (4 shards of
128) and count that the JAX kernel really ran."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import attention as jattn
from dstack_tpu.workloads import flash_attention as jfa
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.sharding import shard_tree
from dstack_tpu_torch.workloads import attention as tattn
from dstack_tpu_torch.workloads import flash_attention as tfa
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads import transformer as ttr
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.sharding import make_mesh
from dstack_tpu_torch.workloads.weights import flatten_params, params_from_numpy

F32_TOL = 1e-5
STEP_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
UPDATE_TOL = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scaled_err(got, want):
    """max |got - want| / max |want|."""
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _rel_norm(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def _both(dtype, *xs):
    """The same numpy arrays as JAX and as torch CPU tensors of `dtype`."""
    return ([jnp.asarray(x, jnp.dtype(dtype)) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])


# ------------------------------------------------------------ one ring step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_step_partials_match_jax(causal, dtype):
    """(o, m, l) of one step, each held on its own (a mistake in o's
    rescale can cancel in o / l): `_block_attend` against JAX's, and
    `_block_ref_bh` (through `flash_block_attend`, the plain version on the
    CPU) against JAX's reference and its Pallas kernel in interpret mode.
    GQA 4/2, expanded as the ring expands it."""
    b, s, h, kv, hd = 1, 128, 4, 2, 128
    q, k, v = _qkv(1, b, s, h, kv, hd)
    k, v = (np.repeat(x, h // kv, axis=2) for x in (k, v))
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    jmask = jnp.tril(jnp.ones((s, s), bool)) if causal else None
    tmask = torch.ones((s, s), dtype=torch.bool).tril() if causal else None
    tol = STEP_TOL[dtype]

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, s, hd)

    pairs = {
        "_block_attend": (jattn._block_attend(jq, jk, jv, jmask),
                          tattn._block_attend(tq, tk, tv, tmask)),
        "flash_block_attend(interpret)": (
            jfa.flash_block_attend(jq, jk, jv, causal=causal, interpret=True),
            tfa.flash_block_attend(tq, tk, tv, causal=causal)),
        "_block_ref_bh": (
            jfa._block_ref_bh(*(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)
                                for x in (jq, jk, jv)), causal),
            tfa._block_ref_bh(to_bh(tq), to_bh(tk), to_bh(tv), causal)),
    }
    for name, (want, got) in pairs.items():
        for part, g, w in zip("oml", got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape, (name, part)
            assert _scaled_err(g, w) <= tol, (name, part, _scaled_err(g, w))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_block_vjp_matches_jax(causal):
    """_RingBlock's backward (recompute through `_block_ref_bh`) against
    jax.vjp of `_ring_block` with random cotangents for o, m and l."""
    bh, s, hd = 4, 128, 128
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.standard_normal((bh, s, hd)).astype(np.float32) for _ in range(4))
    dm, dl = (rng.standard_normal((bh, s)).astype(np.float32) for _ in range(2))
    out, vjp = jax.vjp(lambda q, k, v: jfa._ring_block(q, k, v, causal, True),
                       *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(tuple(jnp.asarray(x) for x in (do, dm, dl)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tfa._RingBlock.apply(tq, tk, tv, causal)
    for part, g, w in zip("oml", got, out):
        assert _scaled_err(g, w) <= F32_TOL, part
    tgrads = torch.autograd.grad(got, (tq, tk, tv),
                                 tuple(torch.from_numpy(x) for x in (do, dm, dl)))
    for name, g, w in zip("qkv", tgrads, jgrads):
        assert _rel_norm(g, w) <= F32_TOL, (name, _rel_norm(g, w))


# ----------------------------------------------------------------- the ring


def _jax_ring(monkeypatch, mode, causal, q, k, v, g):
    """The JAX ring on a 4-device seq mesh: output, q/k/v grads for the
    cotangent g, and how often its Pallas block kernel was called."""
    monkeypatch.setenv("DSTACK_TPU_FLASH_RING", mode)
    calls = []
    real = jfa.flash_block_attend

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jfa, "flash_block_attend", counted)
    mesh = jmake_mesh(jax.devices()[:4], seq=4)
    ring = jattn.make_attention_fn(mesh, causal=causal)
    with mesh:
        out, vjp = jax.vjp(ring, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g))
    monkeypatch.undo()
    return out, grads, len(calls)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["0", "interpret"])
def test_ring_matches_jax_ring_on_a_4_way_seq_mesh(monkeypatch, mode, causal):
    b, s, h, kv, hd = 1, 512, 4, 2, 128
    q, k, v = _qkv(3, b, s, h, kv, hd)
    g = np.random.default_rng(4).standard_normal((b, s, h, hd)).astype(np.float32)
    jout, jgrads, kernel_calls = _jax_ring(monkeypatch, mode, causal, q, k, v, g)
    assert (kernel_calls > 0) == (mode == "interpret")
    ring = tattn.make_attention_fn(make_mesh(["cpu"], seq=4), causal=causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring(tq, tk, tv)
    assert _scaled_err(out, jout) <= F32_TOL
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        assert _rel_norm(tg, jg) <= 1e-4, (name, _rel_norm(tg, jg))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_equals_single_device_attention(causal):
    """The ring over 4 shards computes plain attention (f32, ragged head
    count per group), forward and grads."""
    q, k, v = _qkv(5, 2, 96, 4, 2, 32)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 96, 4, 32))
                         .astype(np.float32))
    ring = tattn.make_attention_fn(make_mesh(["cpu"], seq=4), causal=causal)
    res = []
    for fn in (ring, lambda a, b, c: tattn.plain_attention(a, b, c, causal=causal)):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = fn(tq, tk, tv)
        res.append((out, torch.autograd.grad(out, (tq, tk, tv), g)))
    assert _scaled_err(res[0][0], res[1][0]) <= F32_TOL
    for a, w in zip(res[0][1], res[1][1]):
        assert _rel_norm(a, w) <= F32_TOL


def test_ring_loss_equals_its_single_device_loss():
    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jtr.init_params(JPRESETS["tiny"].with_(dtype="float32"),
                                    jax.random.PRNGKey(0))), "cpu")
    batch = ttrain.synthetic_batch(cfg, 2, 128, seed=1, device="cpu")
    mesh = make_mesh(["cpu"], seq=4)
    ring, _ = ttrain.loss_fn(cfg, params, batch, tattn.make_attention_fn(mesh), mesh)
    single, _ = ttrain.loss_fn(cfg, params, batch, tattn.make_attention_fn())
    assert float(ring) == pytest.approx(float(single), rel=1e-6)


def test_train_step_over_the_ring_matches_jax():
    """One make_train_step(tiny, mesh seq=4) step against the JAX ring
    train step (jnp ring path: S 64, shards of 16) from the same params and
    batch: loss, grad norm and every param after the update."""
    jcfg = JPRESETS["tiny"].with_(dtype="float32")
    tcfg = PRESETS["tiny"].with_(dtype="float32")
    jmesh = jmake_mesh(jax.devices()[:4], seq=4)
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jstate = shard_tree(jmesh, jtrain.TrainState(
        jnp.zeros((), jnp.int32), jparams, jtrain.make_optimizer(3e-4).init(jparams)))
    tok = np.random.default_rng(7).integers(0, 512, (2, 65)).astype(np.int32)
    jstate, jm = jtrain.make_train_step(jcfg, jmesh)(
        jstate, {"inputs": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])})
    tmesh = make_mesh(["cpu"], seq=4)
    tstate = ttrain.init_train_state(tcfg, mesh=tmesh,
                                     params=params_from_numpy(np_params, "cpu"))
    tstate, tm = ttrain.make_train_step(tcfg, tmesh)(
        tstate, {"inputs": torch.from_numpy(tok[:, :-1].copy()),
                 "targets": torch.from_numpy(tok[:, 1:].copy())})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = dict(flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params)))
    before = dict(flatten_params(np_params))
    for path, p in flatten_params(tstate.params):
        # Adam's first step is lr * g / (|g| + eps), about lr * sign(g): a
        # grad element that cancels to f32 noise may take either sign in
        # the two frameworks, so the update is held by its relative norm.
        upd, upd_want = _np(p) - before[path], want[path] - before[path]
        assert _rel_norm(upd, upd_want) <= UPDATE_TOL, (path, _rel_norm(upd, upd_want))


# ------------------------------------------------------- meshes and refusals


def test_make_mesh_takes_one_device_with_a_seq_axis_and_refuses_the_rest():
    mesh = make_mesh(["cpu"], seq=4)
    assert mesh.device == torch.device("cpu")
    assert mesh.shape == {"data": 1, "fsdp": 1, "seq": 4, "model": 1, "expert": 1}
    for kw in ({"model": 2}, {"data": 2}, {"fsdp": 2}, {"expert": 2}):
        with pytest.raises(NotImplementedError, match="sharding slice"):
            make_mesh(["cpu"], seq=2, **kw)
    with pytest.raises(NotImplementedError, match="sharding slice"):
        make_mesh(["cpu", "cpu"], seq=2)
    with pytest.raises(ValueError):
        make_mesh(["cpu"], seq=0)


def test_ring_refuses_a_sequence_that_does_not_split():
    ring = tattn.make_attention_fn(make_mesh(["cpu"], seq=4))
    x = torch.zeros((1, 30, 2, 32))
    with pytest.raises(ValueError, match="shards"):
        ring(x, x, x)


def test_ring_memory_is_quadratic_only_off_the_card():
    ring = tattn.make_attention_fn(make_mesh(["cpu"], seq=4))
    assert ring.memory_is_quadratic(8192, 128, 2, device="cpu")
    assert not ring.memory_is_quadratic(8192, 128, 2, device="cuda")


def test_remat_estimate_counts_the_whole_sequence_on_the_device(monkeypatch):
    """The one-device ring holds all of its shards' activations, so the
    estimate divides by a seq factor of 1 where the reference divides by
    its seq axis: at a 20 GB budget smol-1b-8k at 8192 tokens needs remat
    here, and not per device of a 4-way reference mesh."""
    monkeypatch.setenv("DSTACK_TPU_HBM_GB", "20")
    cfg = PRESETS["smol-1b-8k"]
    assert JPRESETS["smol-1b-8k"].resolve_remat(8192, {"seq": 4}, seq_len=8192) == "none"
    assert cfg.resolve_remat(8192, {"seq": 4}, seq_len=8192) == "none"

    def body(x, p):
        return x

    mesh = make_mesh(["cpu"], seq=4)
    assert ttr.apply_remat(body, cfg, 8192, mesh, seq_len=8192) is not body
    monkeypatch.setenv("DSTACK_TPU_HBM_GB", "80")
    assert ttr.apply_remat(body, cfg, 8192, mesh, seq_len=8192) is body


def test_fine_tune_trains_through_the_ring_on_the_cpu(capsys):
    from dstack_tpu_torch import fine_tune

    fine_tune.main(["--device", "cpu", "--preset", "tiny", "--seq-parallel", "4",
                    "--seq-len", "64", "--batch-size", "2", "--steps", "2"])
    out = capsys.readouterr().out
    assert "ring over 4 seq shards" in out and "training complete" in out
    with pytest.raises(SystemExit, match="divide"):
        fine_tune.main(["--device", "cpu", "--preset", "tiny", "--seq-parallel", "3",
                        "--seq-len", "64"])
    # With ranks the seq axis runs over them (tests/test_torch_ring_ranks.py),
    # so it must divide their number.
    with pytest.raises(SystemExit, match="must divide the 3 ranks"):
        fine_tune.main(["--device", "cpu", "--preset", "tiny", "--seq-parallel", "2",
                        "--ranks", "3"])
