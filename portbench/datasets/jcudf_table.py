"""A wide fixed-width table made on the device from the seed.

One generator on the device, one large call: the columns are views of
one buffer of random bytes (uniform over each type's range; BOOL8 masked
to 0 or 1). No column has nulls.
"""

from __future__ import annotations

import torch

from portbench.reference import jcudf


def schema(cfg: dict) -> list:
    cycle = cfg["cycle"]
    return [cycle[i % len(cycle)] for i in range(cfg["columns"])]


def make(cfg: dict, seed: int, device: torch.device) -> dict:
    """{"types", "rows", "cols" (storage tensors), "valids" (None: no
    nulls), "layout", "remake"}: the inputs that the program and the
    reference share; ``remake()`` makes them again, bit for bit."""
    types = schema(cfg)
    n = cfg["rows"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [jcudf.SIZES[t] for t in types]
    slots = [(n * size + 7) // 8 * 8 for size in sizes]  # each column 8-byte aligned
    buf = torch.randint(0, 256, (sum(slots),), dtype=torch.uint8, generator=gen, device=device)
    cols, off = [], 0
    for t, size, slot in zip(types, sizes, slots):
        part = buf[off : off + n * size]
        if t == "BOOL8":
            part.bitwise_and_(1)
        cols.append(part.view(jcudf.STORAGE[t]))
        off += slot
    return {"types": types, "rows": n, "cols": cols, "valids": [None] * len(types),
            "layout": jcudf.layout(types), "remake": lambda: make(cfg, seed, device)}
