"""``groupby_aggregate``'s share of the card's memory roofline in q1: the
least bytes of its inputs and outputs (the kept rows' two INT8 keys and
five FLOAT64 values; a row a group out, of two keys, seven FLOAT64
aggregates and an INT64 count) at the card's published rate, over its device time
a query (``query.aggregate_ms``)."""

from portbench import arith

KEY_BYTES, VALUE_BYTES, OUT_ROW_BYTES = 2 * 1, 5 * 8, 2 * 1 + 7 * 8 + 8


def read(rec):
    p = rec["profile"]
    s = p["range_device_s"].get("groupby_aggregate")
    kept, groups = rec["info"].get("kept_rows"), rec["info"].get("groups")
    if not s or kept is None or groups is None:
        return None
    nbytes = kept * (KEY_BYTES + VALUE_BYTES) + groups * OUT_ROW_BYTES
    return arith.roofline_pct(nbytes, s / p["items"], rec["device_name"])
