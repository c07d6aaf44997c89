"""Device milliseconds a query of the kernels under the program's
``groupby_aggregate`` op range, from ``torch.profiler`` over the traced
stretch (the program's tracing armed)."""


def read(rec):
    p = rec["profile"]
    s = p["range_device_s"].get("groupby_aggregate")
    return 1e3 * s / p["items"] if s is not None else None
