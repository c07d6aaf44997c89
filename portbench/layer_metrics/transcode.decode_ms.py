"""Host milliseconds a batch in ``convert_from_rows`` of its row batches:
the benchmark's span around the calls (a synchronize before and after),
summed over the window's batches, over the batches."""


def read(rec):
    spans = rec["host_s"].get("decode")
    return 1e3 * sum(spans) / len(spans) if spans else None
