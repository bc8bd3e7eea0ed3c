"""Model, attention, training and paged-KV serving in PyTorch, mirroring
`dstack_tpu.workloads` module for module (config, quant, weights,
transformer, attention, flash_attention, paged_attention, generate,
kv_blocks, serving, train, data). Importing this package imports no
submodule, so a caller pays only for what it uses."""
