"""TPC-H lineitem from the seed: drawn on the host by the benchmark's own
generator (``reference/tpch.py``), then uploaded once and kept on the
device."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import tpch


def make(cfg: dict, seed: int, device: torch.device) -> dict:
    """{"host" (numpy columns by name), "dev" (device storage tensors by
    name: float64 as int64 bits), "rows"}."""
    host = tpch.gen_lineitem(cfg["rows"], seed, cfg["scale_factor"])
    missing = set(cfg["columns"]) - set(host)
    if missing:
        raise ValueError(f"the generator makes no column {sorted(missing)}")
    dev = {}
    for name in cfg["columns"]:
        a = host[name]
        if a.dtype == np.float64:
            a = a.view(np.int64)
        dev[name] = torch.from_numpy(a).to(device)
    return {"host": {k: host[k] for k in cfg["columns"]}, "dev": dev, "rows": cfg["rows"]}
