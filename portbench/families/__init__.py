"""Model families: everything of the yardstick that depends on a model's
architecture, one module per published `model_type`.

`spec.family(conf)` loads `families/<conf["model_type"]>.py`; a
configuration whose `model_type` has no module here stops the run with a
FileNotFoundError that names the missing file. A new architecture comes
in as new files (its module here, its plain reference under
`reference/`, its configuration, its cells' checks and entries in
BENCHMARK.json), and no file of the harness changes.

A family module provides:

- `shapes(conf)`: a frozen dataclass of the configuration file's
  published keys as the family reads them, with at least `vocab`,
  `layers`, `dtype`, `dtype_bytes` and `param_count()` (the traffic
  generator and the run's notes read these);
- `port_config(s)`: the program's ModelConfig for those shapes;
- `make_weights(s, seed, device)`: the tree the program's serving engine
  takes, drawn on `device` from the seed, the same tensors for the same
  seed and device (the reference makes them again after the window);
- `logits(s, w, tokens, rows, quant=None)`: f32 logits at positions
  `rows` of the causal forward over `tokens`, from the family's plain
  reference (`reference/<family>.py`, which imports nothing of the
  program), with `quant="fp8"` its control;
- `prefill_flops(s, prompt, reused)` and `decode_flops(s, context)`: the
  forward FLOPs to prefill positions [reused, prompt) and produce the
  first token's logits, and of one decode token that attends `context`
  keys;
- `paged_prefill_work(s, prompt, reused)` and
  `paged_decode_work(s, context)`: (bytes, ops) of the paged attention
  kernels for the same work.

The counts are of the work the model needs, summed by the family over
its own layers, so that each kind of layer counts as what it is: on a
layer with a sliding window, only the (query, key) pairs inside the
window (`roofline.attention_pairs` counts full causal ones) and only the
window's K/V rows read; each layer kind with its own query and K/V head
counts and head size; for a mixture of experts the k routed experts a
token takes, any shared experts beside them, and the router's product.
`mfu.serve` divides the FLOPs by the window and the chip's peak, and
`paged_roofline.serve` divides the least time of the paged work by the
device time of the kernels whose name contains `ragged_paged_attention`
in the profiled slice, so a count that skips or adds work moves those
metrics by as much.
"""
