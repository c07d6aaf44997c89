"""Shared sides for the serving-tier parity tests: seeded request bytes
for every sidecar op, built once with the JAX package's own wire writer,
so the same bytes go through both packages' ``_dispatch``, both workers'
sockets and both native clients."""

import os
import signal
import socket
import struct
import tempfile
import threading
import types

import numpy as np

import spark_rapids_jni_tpu  # noqa: F401  (x64 before any array)
import jax.numpy as jnp
from spark_rapids_jni_tpu import memgov as rmemgov, runtime as rruntime, serve as rserve
from spark_rapids_jni_tpu import sidecar as RS
from spark_rapids_jni_tpu import sidecar_pool as rpool
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.serve import journal as rjournal
from spark_rapids_jni_tpu.utils import (errors as rerrors, faultinj as rfaultinj,
                                        metrics as rmetrics, retry as rretry)

from spark_rapids_jni_tpu_torch import memgov as pmemgov, runtime as pruntime, serve as pserve
from spark_rapids_jni_tpu_torch import sidecar as PS
from spark_rapids_jni_tpu_torch import sidecar_pool as ppool
from spark_rapids_jni_tpu_torch.serve import journal as pjournal
from spark_rapids_jni_tpu_torch.utils import (errors as perrors, faultinj as pfaultinj,
                                              knobs as pknobs, metrics as pmetrics,
                                              retry as pretry)

N = 64  # one row count everywhere: each new shape compiles the reference again
SEED = 18

FIXED = ["INT8", "INT64", "INT16", "FLOAT64", "UINT32", "BOOL8", "FLOAT32", "INT32",
         "DECIMAL128"]
CAST_STRINGS = ["12", " -7 ", "abc", None, "2147483648", "0042", "+5", "1.5"]
DEC_STRINGS = ["1.25", "-3.5", "x1", None, "99999999.999", "0.001", "12", "-0"]


def _dtype(name):
    return jdt.decimal128(-2) if name == "DECIMAL128" else getattr(jdt, name)


def fixed_table(rng, n=N):
    cols = []
    for i, nm in enumerate(FIXED):
        d = _dtype(nm)
        if d.id == jdt.TypeId.BOOL8:
            a = rng.integers(0, 2, n).astype(bool)
        elif d.id == jdt.TypeId.FLOAT32:
            a = rng.standard_normal(n).astype(np.float32)
        elif d.id == jdt.TypeId.FLOAT64:
            a = rng.standard_normal(n).view(np.uint64)
        elif d.id == jdt.TypeId.DECIMAL128:
            a = rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, n, dtype=d.np_dtype, endpoint=True)
        v = rng.integers(0, 2, n).astype(bool) if i % 3 == 0 else None
        cols.append(JColumn(d, data=jnp.asarray(a), validity=None if v is None else jnp.asarray(v)))
    return JTable(cols)


def string_table(rng, n=N):
    words = ["", "a", "bb", "hello", "spark-rapids", "x" * 31, "naïve", "0123456789abcdef"]
    strs = [None if i % 5 == 3 else words[int(rng.integers(0, len(words)))] for i in range(n)]
    ints = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    longs = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    return JTable([JColumn(jdt.INT32, data=jnp.asarray(ints)),
                   JColumn.from_pylist(strs, jdt.STRING),
                   JColumn(jdt.INT64, data=jnp.asarray(longs))])


def _strings(values, n=N):
    return JTable([JColumn.from_pylist([values[i % len(values)] for i in range(n)], jdt.STRING)])


def _decimals(rng, n=N):
    a = rng.integers(-10**12, 10**12, n)
    b = rng.integers(1, 10**6, n) * np.where(rng.integers(0, 2, n) == 0, -1, 1)
    return JTable([JColumn.from_pylist([int(x) for x in a], jdt.decimal128(-2)),
                   JColumn.from_pylist([int(x) for x in b], jdt.decimal128(-2))])


def _from_rows_payload(to_rows_resp: bytes, table) -> bytes:
    """A CONVERT_FROM_ROWS request from batch 0 of a CONVERT_TO_ROWS answer."""
    (nb,) = struct.unpack_from("<I", to_rows_resp, 0)
    assert nb == 1
    (nrows,) = struct.unpack_from("<Q", to_rows_resp, 4)
    pos = 12
    offs = to_rows_resp[pos: pos + 4 * (nrows + 1)]
    pos += 4 * (nrows + 1)
    (blen,) = struct.unpack_from("<Q", to_rows_resp, pos)
    blob = to_rows_resp[pos + 8: pos + 8 + blen]
    ids = np.array([int(c.dtype.id.value) for c in table.columns], np.int32)
    scales = np.array([int(c.dtype.scale) for c in table.columns], np.int32)
    return (struct.pack("<I", len(ids)) + ids.tobytes() + scales.tobytes()
            + struct.pack("<Q", nrows) + offs + struct.pack("<Q", blen) + blob)


def requests(framed: bool, seed: int = SEED):
    """[(case name, op, payload bytes)] for every data op, in the legacy
    (``framed=False``) or the columnar-frame table form."""
    rng = np.random.default_rng(seed)
    w = lambda t: RS._write_table(t, framed=framed)  # noqa: E731
    keys = rng.integers(-3, 4096 + 3, 4 * N).astype(np.int64)
    vals = rng.standard_normal(4 * N).astype(np.float32)
    fixed, strs = fixed_table(rng), string_table(rng)
    out = [
        ("to_rows_fixed", RS.OP_CONVERT_TO_ROWS, w(fixed)),
        ("to_rows_strings", RS.OP_CONVERT_TO_ROWS, w(strs)),
    ]
    if not framed:  # these ops read no table: one form covers them
        out += [("ping", RS.OP_PING, b""),
                ("groupby", RS.OP_GROUPBY_SUM_F32,
                 struct.pack("<IQ", 4096, len(keys)) + keys.tobytes() + vals.tobytes())]
        for name, t in (("from_rows_fixed", fixed), ("from_rows_strings", strs)):
            resp = RS._dispatch(RS.OP_CONVERT_TO_ROWS, RS._write_table(t, framed=False), "cpu")
            out.append((name, RS.OP_CONVERT_FROM_ROWS, _from_rows_payload(resp, t)))
    for ansi in (0, 1):
        out.append((f"cast_int_ansi{ansi}", RS.OP_CAST_TO_INTEGER,
                    struct.pack("<Bi", ansi, int(jdt.TypeId.INT32.value)) + w(_strings(CAST_STRINGS))))
        out.append((f"cast_dec_ansi{ansi}", RS.OP_CAST_TO_DECIMAL,
                    struct.pack("<Bii", ansi, 12, -3) + w(_strings(DEC_STRINGS))))
    zo = JTable([JColumn(jdt.INT32, data=jnp.asarray(rng.integers(-(2**31), 2**31 - 1, N).astype(np.int32)))
                 for _ in range(3)])
    out.append(("zorder", RS.OP_ZORDER, w(zo)))
    dec = _decimals(rng)
    out.append(("dec_mul", RS.OP_DECIMAL128_MUL, struct.pack("<i", -4) + w(dec)))
    out.append(("dec_div", RS.OP_DECIMAL128_DIV, struct.pack("<i", -2) + w(dec)))
    return out


def outcome(pkg_sidecar, op, payload, backend="cpu"):
    """(``ok``, response bytes) or (the exception class name, its wire
    form): a CastError as its status-2 frame, anything else as its text."""
    try:
        return "ok", pkg_sidecar._dispatch(op, payload, backend)
    except Exception as e:  # compared across packages
        if type(e).__name__ == "CastError":
            sv = e.string_with_error
            return "CastError", struct.pack("<qB", int(e.row_with_error), 1 if sv is None else 0) + (
                sv.encode() if sv else b"")
        return type(e).__name__, str(e)


def split_groupby(resp: bytes, num_keys: int = None):
    num_keys = len(resp) // 12 if num_keys is None else num_keys
    sums = np.frombuffer(resp, np.float32, num_keys, 0)
    counts = np.frombuffer(resp, np.int64, num_keys, 4 * num_keys)
    return sums, counts


def assert_same_response(name, got, want):
    """Byte-identical, except GROUPBY_SUM_F32's float32 sums: the port
    sums in float64 and rounds once, the reference's CPU path sums in
    float32, so sums agree within tests/test_pallas_kernels.py's bound
    (rtol 2e-6, atol 1e-3) and the counts bit for bit."""
    assert got[0] == want[0], (name, got, want)
    if name == "groupby":
        gs, gc = split_groupby(got[1])
        ws, wc = split_groupby(want[1])
        assert len(got[1]) == len(want[1])
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, rtol=2e-6, atol=1e-3)
    else:
        assert got[1] == want[1], name


# ---------------------------------------------------------------------------
# one namespace a package, for cases that run the same steps on each
# ---------------------------------------------------------------------------

REF = types.SimpleNamespace(
    name="reference", prefix="SRJT_", sidecar=RS, pool=rpool, memgov=rmemgov, serve=rserve,
    journal=rjournal, runtime=rruntime, errors=rerrors, faultinj=rfaultinj, metrics=rmetrics,
    retry=rretry)
PORT = types.SimpleNamespace(
    name="port", prefix=pknobs.PREFIX, sidecar=PS, pool=ppool, memgov=pmemgov, serve=pserve,
    journal=pjournal, runtime=pruntime, errors=perrors, faultinj=pfaultinj, metrics=pmetrics,
    retry=pretry)
SIDES = (REF, PORT)


def counters(side, prefix):
    return {k: v for k, v in side.metrics.counters_snapshot().items() if k.startswith(prefix)}


def delta(before, after):
    """Counter deltas with zero-valued entries dropped."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def setenv(monkeypatch, suffix, value):
    """Set one knob for both packages (``SRJT_<suffix>`` and the port's)."""
    for s in SIDES:
        monkeypatch.setenv(s.prefix + suffix, str(value))


def scrub_worker_namespace(side):
    """In-process workers count ``sidecar.worker.*`` in this process's
    registry, where other files fold remote snapshots in as gauges: drop
    the namespace so the two never meet."""
    reg = side.metrics.registry()
    with reg._lock:
        for name in [n for n in reg._metrics if n.startswith("sidecar.worker.")]:
            del reg._metrics[name]


class InProcWorker:
    """Duck-types the Popen surface a pool supervises, serving
    ``<side>.sidecar._handle_conn`` from threads in this process (backend
    ``cpu``). ``kill()`` models kill -9: the listener and every live
    connection drop mid-frame."""

    def __init__(self, side):
        self.side = side
        self.sock_path = tempfile.mktemp(prefix="srjtorch-inproc-") + ".sock"
        self.pid = os.getpid()
        self.returncode = None
        self._conns = []
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.sock_path)
        self._srv.listen(8)
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self._conns.append(conn)

            def _serve(c=conn):
                try:
                    self.side.sidecar._handle_conn(c, "cpu", lambda: None)
                except OSError:
                    pass

            threading.Thread(target=_serve, daemon=True).start()

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode if self.returncode is not None else 0

    def terminate(self):
        self.kill()

    def kill(self):
        if self.returncode is None:
            self.returncode = -signal.SIGKILL
        try:
            self._srv.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass


def inproc_spawn(side):
    def spawn(startup_timeout_s=None, env=None):
        w = InProcWorker(side)
        return w, w.sock_path
    return spawn


def inproc_pool(side, size=2, **kw):
    kw.setdefault("deadline_s", 20)
    kw.setdefault("heartbeat_s", 1e9)
    return side.pool.SidecarPool(size=size, spawn_fn=inproc_spawn(side), **kw)


def groupby_payload(n=600, k=16, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k, n).astype(np.int64)
    vals = rng.standard_normal(n).astype(np.float32)
    return struct.pack("<IQ", k, n) + keys.tobytes() + vals.tobytes()


def clean(side):
    """A case's starting state: no fault rules, retry disarmed, the
    breaker closed, and no metric left by an earlier file in this process
    (a warm op-latency histogram or a recent shed would arm hedging on
    one side only)."""
    side.faultinj.disable()
    side.retry.disable()
    side.retry.reset_stats()
    side.metrics.reset()
    scrub_worker_namespace(side)
    side.sidecar.breaker().reset()
