"""The share of an item's time in which the device runs nothing: 100
times one less the device's busy time an item (the union of its kernels,
copies and fills in a ``torch.profiler`` trace of the device alone, over
``profile_items`` items) over the mean latency of the window's items.
The busy time comes from the trace, the latency from the window, where
no tracer slows the host that the device waits for."""


def read(rec):
    d = rec["device"]
    lat = rec["latency_s"]
    if not d["items"] or lat <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["items"] / lat)
