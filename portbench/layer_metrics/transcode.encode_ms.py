"""Host milliseconds a batch in ``convert_to_rows``: the benchmark's span
around each call (a synchronize before and after), summed over the
window's batches, over the batches."""


def read(rec):
    spans = rec["host_s"].get("encode")
    return 1e3 * sum(spans) / len(spans) if spans else None
