"""Model, attention and paged-KV serving in PyTorch, mirroring
`dstack_tpu.workloads` module for module (serving slice: config, quant,
weights, transformer, attention, paged_attention, generate, kv_blocks,
serving). Importing this package imports no submodule, so a caller pays
only for what it uses."""
