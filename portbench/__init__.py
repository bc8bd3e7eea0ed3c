"""The port's benchmark: one cell of BENCHMARK.json per run (`run.py`).

Everything a cell needs is found by name: its model configuration under
`configs/`, the configuration's model family under `families/` (by its
published `model_type`: shapes, weights from the seed, the plain
reference under `reference/`, the operation and byte counts), its traffic
mix under `traffic/`, the loop of the mix's kind under `drivers/`, one
reader per metric under `metrics/`, and the limit of its output check
under `checks/`. The yardstick (traffic generation, the families, the
peaks, the reduction of a profiler trace) lives here too, so the program
under test (`dstack_tpu_torch`) supplies only the system that is
measured.
"""
