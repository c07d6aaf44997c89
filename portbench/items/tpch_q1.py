"""TPC-H q1 (delta 90 days) on the resident lineitem table, through the
program's operator tier (``models.tpch.q1``): filter, projections and
the exact float64 group aggregate. Another query is another item."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import tpch as ref
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.models import tpch

_TYPES = {np.dtype(np.float64): pdt.FLOAT64, np.dtype(np.int8): pdt.INT8,
          np.dtype(np.int32): pdt.TIMESTAMP_DAYS}
DELTA_DAYS = 90  # the specification's validation value


def prepare(cfg: dict, mix: dict, data: dict, device: torch.device) -> dict:
    names = list(cfg["columns"])
    table = Table([Column(_TYPES[data["host"][n].dtype], data=data["dev"][n]) for n in names], names)
    return {"data": data, "table": table}


def rows(st: dict) -> int:
    return st["data"]["rows"]


def info(st: dict) -> dict:
    """What the per-layer readers need of the inputs: the rows q1 keeps
    and the groups they fall in."""
    h = st["data"]["host"]
    keep = h["l_shipdate"] <= ref.D_1998_12_01 - DELTA_DAYS
    slots = h["l_returnflag"][keep].astype(np.int64) * 2 + h["l_linestatus"][keep]
    return {"kept_rows": int(keep.sum()), "groups": int(np.unique(slots).shape[0])}


def step(st: dict, span):
    with span("query"):
        return tpch.q1(st["table"], DELTA_DAYS)


def _dense(out: Table) -> dict:
    """q1's rows as arrays over the slots (returnflag * 2 + linestatus)."""
    slot = out.column("l_returnflag").to_numpy().astype(np.int64) * 2 \
        + out.column("l_linestatus").to_numpy()
    dense = {}
    for name, _ in ref.SUMS + ref.MEANS:
        d = np.zeros(ref.SLOTS, np.float64)
        d[slot] = out.column(name).to_numpy().view(np.float64)
        dense[name] = d
    dense["count"] = np.zeros(ref.SLOTS, np.int64)
    dense["count"][slot] = out.column("qty_count_all").to_numpy()
    return dense


def answers(st: dict, out: Table) -> dict:
    return {"dense": _dense(out), "num_rows": out.num_rows}


def sample(st: dict, out: Table):
    """A sampled query keeps its whole output (a row a group)."""
    return out


def control(st: dict, dtype: torch.dtype = torch.float32) -> dict:
    """The reference in the program's place, computed in ``dtype``."""
    dense, _ = ref.q1_lower(st["data"]["host"], dtype, st["data"]["dev"]["l_shipdate"].device,
                            DELTA_DAYS)
    return {"dense": dense, "num_rows": int((dense["count"] > 0).sum())}


def _off(ans: dict, want: dict, kept: int) -> dict:
    d = ans["dense"]
    return {
        "kept_rows_off": abs(int(d["count"].sum()) - kept),
        "groups_off": abs(ans["num_rows"] - int((want["count"] > 0).sum())),
        "values_off": sum(int((d[k].view(np.uint64 if d[k].dtype == np.float64 else np.int64)
                               != want[k].view(np.uint64 if want[k].dtype == np.float64
                                               else np.int64)).sum()) for k in want),
    }


def judge(st: dict, ans: dict, samples: list) -> dict:
    """kept rows, groups and every output value (bit for bit) of the
    program's last query against the exact reference; the sampled
    queries' outputs the same way."""
    want, kept = ref.q1_exact(st["data"]["host"], DELTA_DAYS)
    got = _off(ans, want, kept)
    got["sampled_off"] = sum(any(_off(answers(st, x), want, kept).values()) for x in samples)
    return got
