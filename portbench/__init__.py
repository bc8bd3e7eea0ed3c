"""The port's benchmark: one cell of BENCHMARK.json per run (`run.py`).

Everything a cell needs is found by name: its model configuration under
`configs/`, its traffic mix under `traffic/`, the loop of the mix's kind
under `drivers/`, one reader per metric under `metrics/`, and the limit
of its output check under `checks/`. The yardstick (traffic generation,
weights from the seed, the plain reference, the peaks and the operation
and byte counts, the reduction of a profiler trace) lives here too, so
the program under test (`dstack_tpu_torch`) supplies only the system
that is measured.
"""
