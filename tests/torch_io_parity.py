"""Helpers for the port's data-plane parity tests: a column of either
package as one nested dict of host arrays, compared bit for bit (storage
dtypes, validity, offsets, chars, children). No jax import here: the
JAX-package side is handed in as columns."""

import numpy as np


def _arr(x):
    return None if x is None else np.asarray(x)


def jax_host(col) -> dict:
    """A JAX-package Column as {type, scale, validity, data | offsets,
    chars | offsets, child | children, names}, host arrays in its
    storage dtypes."""
    tid = col.dtype.id.name
    out = {"type": tid, "scale": col.dtype.scale, "validity": _arr(col.validity)}
    if tid == "STRING":
        out.update(offsets=_arr(col.offsets), chars=_arr(col.chars))
    elif tid == "LIST":
        out.update(offsets=_arr(col.offsets), child=jax_host(col.child))
    elif tid == "STRUCT":
        out.update(children=[jax_host(c) for c in col.children],
                   names=list(col.child_names or ()))
    else:
        out["data"] = _arr(col.data)
    return out


def port_host(col) -> dict:
    """The same dict of a port Column (its data through ``to_numpy``, in
    the JAX package's storage dtypes)."""
    tid = col.dtype.id.name

    def t(x):
        return None if x is None else x.cpu().numpy()

    out = {"type": tid, "scale": col.dtype.scale, "validity": t(col.validity)}
    if tid == "STRING":
        out.update(offsets=t(col.offsets), chars=t(col.chars))
    elif tid == "LIST":
        out.update(offsets=t(col.offsets), child=port_host(col.child))
    elif tid == "STRUCT":
        out.update(children=[port_host(c) for c in col.children],
                   names=list(col.child_names or ()))
    else:
        out["data"] = col.to_numpy()
    return out


def assert_same_host(a: dict, b: dict, where: str = "column") -> None:
    """Bit for bit: types, validity presence and bits, every array's dtype,
    shape and bytes, names and children."""
    assert a["type"] == b["type"] and a["scale"] == b["scale"], (where, a["type"], b["type"])
    for k in ("validity", "data", "offsets", "chars"):
        x, y = a.get(k), b.get(k)
        assert (x is None) == (y is None), (where, k, "present on one side only")
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, (where, k, x.dtype, y.dtype,
                                                                x.shape, y.shape)
            assert x.tobytes() == y.tobytes(), (where, k, "bytes differ")
    if "child" in a:
        assert_same_host(a["child"], b["child"], where + ".child")
    if "children" in a:
        assert a["names"] == b["names"], (where, a["names"], b["names"])
        assert len(a["children"]) == len(b["children"]), where
        for i, (x, y) in enumerate(zip(a["children"], b["children"])):
            assert_same_host(x, y, f"{where}.{a['names'][i] if a['names'] else i}")


def assert_same_tables(jtable, ptable) -> None:
    """A JAX-package Table and a port Table: names and every column."""
    assert list(jtable.names) == list(ptable.names)
    assert len(jtable.columns) == len(ptable.columns)
    for nm, jc, pc in zip(jtable.names, jtable.columns, ptable.columns):
        assert_same_host(jax_host(jc), port_host(pc), nm)


def host_spec(h: dict, dtype_of):
    """A ``jax_host`` dict as the (array, dtype, validity) the port's
    ``carry_table`` takes; ``dtype_of(type name, scale)`` gives the
    port's DType."""
    d = dtype_of(h["type"], h["scale"])
    if h["type"] == "STRING":
        arr = (h["offsets"], h["chars"])
    elif h["type"] == "LIST":
        arr = {"offsets": h["offsets"], "child": host_spec(h["child"], dtype_of)}
    elif h["type"] == "STRUCT":
        arr = {"children": [host_spec(c, dtype_of) for c in h["children"]], "names": h["names"]}
    else:
        arr = h["data"]
    return arr, d, h["validity"]
