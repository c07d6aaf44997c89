"""The JCUDF transcode of one batch and the bounded group-by after it.

The mix's ``encode`` says what an item does: where true it is
``convert_to_rows`` of the table, the decode of each row batch it made
and the group-by (the round trip); where false, set-up encodes the table
once with the benchmark's own encoder and an item decodes those row
batches and groups them (rows arriving from a CPU operator). Then only
the row batches stay on the device, as in a deployment; the check makes
the columns again from the seed.

The group-by is ``SELECT c2 & 4095, SUM(CAST(c1 AS FLOAT)), COUNT(*)
GROUP BY 1`` on each decoded piece, partial sums and counts added: the
key is the low 12 bits of the INT32 column 2, the value the INT16 column
1 as float32, summed by ``aggregate.groupby_sum_bounded``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from portbench.reference import groupby, jcudf
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import aggregate
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

KEY, VALUE = 2, 1  # an INT32 and an INT16 column of the cycled schema
NUM_KEYS = 4096


def group_inputs(cols: List[torch.Tensor]):
    """(keys in [0, NUM_KEYS), float32 values) of one piece's columns."""
    return cols[KEY] & (NUM_KEYS - 1), cols[VALUE].to(torch.float32)


def _ref_batches(data: dict) -> List[torch.Tensor]:
    lay = data["layout"]
    return [jcudf.encode(lay, data["cols"], data["valids"], r0, r1).view(-1)
            for r0, r1 in jcudf.batch_rows(lay, data["rows"])]


def _ref_offsets(data: dict, r0: int, r1: int, device) -> torch.Tensor:
    return torch.arange(r1 - r0 + 1, dtype=torch.int32, device=device) * data["layout"].row_size


def prepare(cfg: dict, mix: dict, data: dict, device: torch.device) -> dict:
    dtypes = [getattr(pdt, t) for t in data["types"]]
    st = {"data": data, "dtypes": dtypes, "encode": bool(mix["encode"])}
    if st["encode"]:
        st["table"] = Table([Column(d, data=c, validity=v)
                             for d, c, v in zip(dtypes, data["cols"], data["valids"])])
    else:
        batches = []
        for blob, (r0, r1) in zip(_ref_batches(data), jcudf.batch_rows(data["layout"], data["rows"])):
            child = Column(pdt.INT8, data=blob.view(torch.int8))
            batches.append(Column.list_from_parts(_ref_offsets(data, r0, r1, device), child))
        st["batches"] = batches
        data["cols"] = data["valids"] = None
    return st


def _inputs(data: dict) -> dict:
    """The table's columns: those set-up kept, or made again from the seed."""
    return data if data["cols"] is not None else data["remake"]()


def rows(st: dict) -> int:
    return st["data"]["rows"]


def info(st: dict) -> dict:
    """What the per-layer readers need of the inputs: the least bytes of
    one direction of the transcode of a batch."""
    data = st["data"]
    return {"transcode_bytes": sum(jcudf.transcode_bytes(data["layout"], data["rows"], 0).values())}


def step(st: dict, span) -> dict:
    out = {}
    if st["encode"]:
        with span("encode"):
            out["batches"] = rc.convert_to_rows(st["table"])
        batches = out["batches"]
    else:
        batches = st["batches"]
    with span("decode"):
        out["pieces"] = [rc.convert_from_rows(b, st["dtypes"]) for b in batches]
    with span("aggregate"):
        sums = counts = None
        for p in out["pieces"]:
            keys, vals = group_inputs([c.data for c in p.columns])
            s, c = aggregate.groupby_sum_bounded(keys, vals, NUM_KEYS)
            sums, counts = (s, c) if sums is None else (sums + s, counts + c)
    out["sums"], out["counts"] = sums, counts
    return out


def answers(st: dict, out: dict) -> dict:
    """The program's outputs as plain tensors."""
    ans = {"pieces": [([c.data for c in p.columns], [c.validity for c in p.columns])
                      for p in out["pieces"]],
           "sums": out["sums"], "counts": out["counts"]}
    if "batches" in out:
        ans["blobs"] = [b.child.data.view(torch.uint8) for b in out["batches"]]
        ans["offsets"] = [b.offsets for b in out["batches"]]
    return ans


def _fp(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums (wrapping) of a tensor's bytes read as 8-byte
    words, all of them and every third, and the sum of its last bytes.
    Summed in their own type: a sum into a wider type would copy the
    tensor into that type first."""
    b = t.contiguous().view(torch.uint8)
    whole = b.numel() // 8 * 8
    head = b[:whole]
    if head.storage_offset() % 8:
        head = head.clone()
    words = head.view(torch.int64)
    return torch.stack([words.sum(), words[::3].sum(), b[whole:].to(torch.int64).sum()])


def _fp_valid(v: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """Valid rows, all and every third (None: all valid)."""
    if v is None:
        return torch.tensor([n, (n + 2) // 3], dtype=torch.int64, device=device)
    return torch.stack([torch.count_nonzero(v), torch.count_nonzero(v[::3])])


def _fingerprint(ans: dict) -> torch.Tensor:
    parts = []
    for blob, offs in zip(ans.get("blobs", []), ans.get("offsets", [])):
        parts += [_fp(blob), _fp(offs)]
    for cols, valids in ans["pieces"]:
        for c, v in zip(cols, valids):
            parts += [_fp(c), _fp_valid(v, c.shape[0], c.device)]
    return torch.cat(parts)


def sample(st: dict, out: dict):
    """What a sampled item keeps for the check after the window: a
    fingerprint of its blobs, offsets, columns and validity (sums of its
    bytes, whole and at a stride of 3), and its sums and counts. Enqueued
    on the device, read after the window."""
    ans = answers(st, out)
    return {"fp": _fingerprint(ans), "sums": ans["sums"].clone(), "counts": ans["counts"].clone()}


def control(st: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The reference in the program's place, its group-by summed in
    ``dtype``: the blobs from the reference encoder, the pieces from the
    reference decoder, the partial sums added in ``dtype``."""
    data = _inputs(st["data"])
    lay = data["layout"]
    blobs = _ref_batches(data) if st["encode"] else [
        b.child.data.view(torch.uint8) for b in st["batches"]]
    ans = {"pieces": []}
    sums = counts = None
    for blob, (r0, r1) in zip(blobs, jcudf.batch_rows(lay, data["rows"])):
        cols, valids = jcudf.decode(lay, data["types"], blob.view(r1 - r0, lay.row_size))
        ans["pieces"].append((cols, valids))
        s, c, _ = groupby.bounded_sum(*group_inputs(cols), NUM_KEYS, dtype)
        sums, counts = (s, c) if sums is None else (sums + s, counts + c)
    ans["sums"], ans["counts"] = sums, counts
    if st["encode"]:
        ans["blobs"] = blobs
        ans["offsets"] = [_ref_offsets(data, r0, r1, blobs[0].device)
                          for r0, r1 in jcudf.batch_rows(lay, data["rows"])]
    return ans


def _rows_off(got: torch.Tensor, want: torch.Tensor, n: int) -> int:
    """Rows whose bytes differ (all ``n`` where the widths differ)."""
    g = got.contiguous().view(torch.uint8).view(n, -1)
    w = want.contiguous().view(torch.uint8).view(n, -1)
    return n if g.shape != w.shape else int((g != w).any(1).sum())


def _validity_off(got: Optional[torch.Tensor], want: Optional[torch.Tensor]) -> int:
    if got is None and want is None:
        return 0
    if got is None or want is None:
        return int((~(want if got is None else got)).sum())
    return int((got != want).sum())


def judge(st: dict, ans: dict, samples: list) -> dict:
    """Each number compared, by name: the program's answers (``ans``) and
    the sampled items against the reference on the same inputs."""
    data = _inputs(st["data"])
    lay, n = data["layout"], data["rows"]
    cols, valids = data["cols"], data["valids"]
    batches = jcudf.batch_rows(lay, n)
    dev = cols[0].device
    got = {}
    ref_parts = []
    if st["encode"]:
        blob_off = offsets_off = abs(len(ans["blobs"]) - len(batches)) * n * lay.row_size
        for b, (r0, r1) in enumerate(batches[: len(ans["blobs"])]):
            want = jcudf.encode(lay, cols, valids, r0, r1).view(-1)
            blob = ans["blobs"][b]
            if blob.numel() != want.numel():
                blob_off += max(blob.numel(), want.numel())
            else:
                blob_off += int((blob != want).sum())
            want_offs = _ref_offsets(data, r0, r1, dev)
            offs = ans["offsets"][b]
            if offs.numel() != want_offs.numel():
                offsets_off += max(offs.numel(), want_offs.numel())
            else:
                offsets_off += int((offs.to(torch.int64) != want_offs.to(torch.int64)).sum())
            ref_parts += [_fp(want), _fp(want_offs)]
            del want
        got["blob_bytes_off"] = blob_off
        got["offsets_off"] = offsets_off
    values_off = validity_off = abs(len(ans["pieces"]) - len(batches)) * n * len(cols)
    for b, (r0, r1) in enumerate(batches[: len(ans["pieces"])]):
        pcols, pvalids = ans["pieces"][b]
        for i in range(len(cols)):
            want_c = cols[i][r0:r1]
            want_v = None if valids[i] is None else valids[i][r0:r1]
            if i >= len(pcols) or pcols[i].shape[0] != r1 - r0:
                values_off += r1 - r0
                validity_off += r1 - r0
                continue
            values_off += _rows_off(pcols[i], want_c, r1 - r0)
            validity_off += _validity_off(pvalids[i], want_v)
    for r0, r1 in batches:
        ref_parts += [t for i in range(len(cols))
                      for t in (_fp(cols[i][r0:r1]),
                                _fp_valid(None if valids[i] is None else valids[i][r0:r1],
                                          r1 - r0, dev))]
    got["values_off"] = values_off
    got["validity_off"] = validity_off
    want_s, want_c, mags = groupby.bounded_sum(*group_inputs(cols), NUM_KEYS)
    counts_off, gap = 0, 0.0
    for s, c in [(ans["sums"], ans["counts"])] + [(x["sums"], x["counts"]) for x in samples]:
        counts_off += int((c.to(torch.int64) - want_c).abs().sum())
        gap = max(gap, groupby.sum_gap(s, want_s, mags))
    got["counts_off"] = counts_off
    got["sum_gap"] = gap
    ref_fp = torch.cat(ref_parts)
    got["sampled_off"] = sum(int(x["fp"].shape != ref_fp.shape or not torch.equal(x["fp"], ref_fp))
                             for x in samples)
    return got
