"""Device milliseconds a query outside the program's ``groupby_aggregate``
op range (the filter, the projections and whatever else the query
launches), from ``torch.profiler`` over the traced stretch."""


def read(rec):
    p = rec["profile"]
    s = p["range_device_s"].get("groupby_aggregate")
    return 1e3 * (p["device_s"] - s) / p["items"] if s is not None else None
