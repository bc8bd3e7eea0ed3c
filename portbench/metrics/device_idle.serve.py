"""The device's idle share of the profiled slice, in %: one minus the
union of its operations' intervals over the slice's wall time."""


def read(rec):
    if not rec.slice:
        return None
    return 100.0 * (1.0 - rec.slice["busy_s"] / rec.slice["window_s"])
