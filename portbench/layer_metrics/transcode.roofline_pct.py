"""The transcode's share of the card's memory roofline: the least bytes
of the cell's encode and decode calls (``reference/jcudf.transcode_bytes``
from the schema and the row count: column data, validity at one bit a
row of a nullable column, the row blob and its int32 offsets, each read
once and written once) at the card's published rate, over the CUDA-event
time of those calls' spans."""

from portbench import arith


def read(rec):
    stages = [s for s in ("encode", "decode") if rec["event_s"].get(s)]
    per_call = rec["info"].get("transcode_bytes")
    if not stages or not per_call:
        return None
    nbytes = sum(per_call * len(rec["event_s"][s]) for s in stages)
    seconds = sum(sum(rec["event_s"][s]) for s in stages)
    return arith.roofline_pct(nbytes, seconds, rec["device_name"])
