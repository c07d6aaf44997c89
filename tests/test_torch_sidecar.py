"""Port: the device sidecar (``spark_rapids_jni_tpu_torch/sidecar.py``)
held against the JAX package's.

In process, every op's seeded request bytes (legacy and framed table
forms) go through both packages' ``_dispatch``: the responses are
byte-identical, GROUPBY_SUM_F32's float32 sums aside (within the bound of
tests/test_pallas_kernels.py, counts bit for bit; see
``torch_serve_sides.assert_same_response``). One module-scoped port
worker (``--device cpu``) checks the socket side (CRC trailers, both
arena forms, the trace flag, concurrent connections, SHUTDOWN) and one
reference worker answers the same request bytes over its socket."""

import array
import json
import mmap
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading

import pytest
import torch

import torch_serve_sides as S
from spark_rapids_jni_tpu.utils import metrics as rmetrics
from spark_rapids_jni_tpu_torch import runtime as PR
from spark_rapids_jni_tpu_torch import sidecar as PS
from spark_rapids_jni_tpu_torch.utils import integrity as pintegrity
from spark_rapids_jni_tpu_torch.utils import knobs as pknobs
from spark_rapids_jni_tpu_torch.utils import metrics as pmetrics
from spark_rapids_jni_tpu_torch.utils import tracing as ptracing
from spark_rapids_jni_tpu_torch.utils.errors import DataCorruption, RetryableError

RS = S.RS
CASES = {f"{'framed' if framed else 'legacy'}-{name}": (name, op, pl)
         for framed in (False, True) for name, op, pl in S.requests(framed)}
CASES["legacy-unknown_op"] = ("unknown", 77, b"")


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_matches_reference(case):
    name, op, payload = CASES[case]
    S.assert_same_response(name, S.outcome(PS, op, payload), S.outcome(RS, op, payload))


def _scrub(reg):
    with reg._lock:
        for n in [n for n in reg._metrics if n.startswith("sidecar.")]:
            del reg._metrics[n]


def _serve_pair(pkg, frames):
    """Run ``pkg._handle_conn`` on one end of a socketpair and send
    ``frames``; returns the raw response bytes of each."""
    a, b = socket.socketpair()
    t = threading.Thread(target=pkg._handle_conn, args=(b, "cpu", lambda: None), daemon=True)
    t.start()
    out = []
    try:
        for op, payload in frames:
            a.sendall(struct.pack("<IQ", op, len(payload)) + payload)
            status, rlen = struct.unpack("<IQ", PS._recv_exact(a, 12))
            out.append((status, PS._recv_exact(a, rlen) if rlen else b""))
    finally:
        a.close()
        t.join(10)
    return out


@pytest.fixture
def governors(monkeypatch):
    """Both packages' memgov singletons are reset after the test; the
    port's controller snapshot reads a budget (without one it means the
    card)."""
    S.setenv(monkeypatch, "DEVICE_MEMORY_BUDGET", 1 << 30)
    yield
    for memgov in (S.PORT.memgov, S.REF.memgov):
        memgov.reset()


def _stats_names(pkg, reg):
    _scrub(reg)
    (_, ping), (status, stats) = _serve_pair(pkg, [(PS.OP_PING, b""), (PS.OP_STATS, b"")])
    doc = json.loads(stats)
    names = {k: sorted(n for n in v if n.startswith("sidecar."))
             for k, v in doc["snapshot"].items() if isinstance(v, dict)}
    _scrub(reg)
    return ping, status, sorted(doc), doc["backend"], names, sorted(doc["memgov"])


def _assert_stats_names_match():
    # the section lists the catalog and the admission controller once
    # each exists, and an earlier file in this process may have made
    # either on one side alone: make both on both sides
    for memgov in (S.PORT.memgov, S.REF.memgov):
        memgov.catalog()
        memgov.controller()
    seen = [_stats_names(PS, pmetrics.registry()), _stats_names(RS, rmetrics.registry())]
    assert seen[0] == seen[1]
    assert "sidecar.worker.requests.STATS" in seen[0][4]["counters"]
    assert {"admission", "catalog"} <= set(seen[0][5])


def test_stats_snapshot_names_match(governors):
    _assert_stats_names_match()


def test_stats_snapshot_names_match_after_a_reference_controller(governors):
    S.REF.memgov.controller()  # as an earlier test in this process may have
    _assert_stats_names_match()


def test_reused_thread_forgets_a_framed_sniff():
    _, op, payload = CASES["legacy-zorder"]
    PS._REQ_FMT.framed = True  # stale from an aborted framed request
    assert PS._dispatch(op, payload, "cpu") == RS._dispatch(op, payload, "cpu")


# ---------------------------------------------------------------------------
# the socket side: one port worker and one reference worker for the module
# ---------------------------------------------------------------------------


def _spawn_reference_worker():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return RS.spawn_worker(env=env, startup_timeout_s=120)


@pytest.fixture(scope="module")
def workers():
    ref = {}
    t = threading.Thread(target=lambda: ref.setdefault("w", _spawn_reference_worker()))
    t.start()  # the two interpreters start side by side
    port_proc, port_sock = PS.spawn_worker(device="cpu", startup_timeout_s=120)
    t.join(180)
    ref_proc, ref_sock = ref["w"]
    yield {"port": (port_proc, port_sock), "ref": (ref_proc, ref_sock)}
    for proc, sock in (port_proc, port_sock), (ref_proc, ref_sock):
        PS._reap_worker(proc)
        if os.path.exists(sock):
            os.unlink(sock)


def _dial(sock):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(120)
    s.connect(sock)
    return s


def _frame(s, op, payload=b"", trailer=b""):
    s.sendall(struct.pack("<IQ", op, len(payload)) + trailer + payload)
    hdr = PS._recv_exact(s, 12)
    status, rlen = struct.unpack("<IQ", hdr)
    crc = PS._recv_exact(s, 4) if status & PS.CRC_FLAG else b""
    body = PS._recv_exact(s, rlen) if rlen and not status & PS.ARENA_FLAG else b""
    return status, rlen, crc, body


# few ops: the reference worker compiles each one again in its own process
SOCKET_CASES = ["legacy-ping", "legacy-cast_int_ansi1", "framed-zorder", "legacy-unknown_op"]


def test_port_worker_answers_like_the_reference_worker(workers):
    ps, rs = _dial(workers["port"][1]), _dial(workers["ref"][1])
    try:
        for case in SOCKET_CASES:
            name, op, payload = CASES[case]
            assert _frame(ps, op, payload) == _frame(rs, op, payload), case
    finally:
        ps.close()
        rs.close()


def test_crc_trailers_both_ways(workers):
    _, op, payload = CASES["legacy-to_rows_strings"]
    s = _dial(workers["port"][1])
    try:
        trailer = pintegrity.pack_crc(pintegrity.checksum(payload))
        status, _, crc, body = _frame(s, op | PS.CRC_FLAG, payload, trailer)
        assert status == PS.STATUS_OK | PS.CRC_FLAG
        assert pintegrity.unpack_crc(crc) == pintegrity.checksum(body)
        assert body == RS._dispatch(op, payload, "cpu")
        # a trailer that does not cover the payload: a DataCorruption reply,
        # and the stream stays framed for the next request
        bad = pintegrity.pack_crc(pintegrity.checksum(payload) ^ 1)
        status, _, _, body = _frame(s, op | PS.CRC_FLAG, payload, bad)
        assert status & ~PS._FLAG_MASK == PS.STATUS_ERROR
        assert body.startswith(b"DataCorruption:")
        assert _frame(s, PS.OP_PING)[3] == b"cpu"
    finally:
        s.close()


def test_corrupted_trailer_is_retryable_data_corruption(workers, monkeypatch):
    c = PS.SupervisedClient(workers["port"][1], deadline_s=60, heartbeat_s=1e9)
    real = pintegrity.pack_crc
    monkeypatch.setattr(pintegrity, "pack_crc", lambda crc: real(crc ^ 0x5A5A))
    try:
        with pintegrity.enabled():
            with pytest.raises(DataCorruption) as ei:
                c.request(PS.OP_PING, b"")
        assert isinstance(ei.value, RetryableError)
    finally:
        c.close()


def _set_arena(s, size, mode=None):
    fd = os.memfd_create("test-arena")
    os.ftruncate(fd, size)
    body = struct.pack("<Q", size) + (b"" if mode is None else struct.pack("<Q", mode))
    s.sendmsg([struct.pack("<IQ", PS.OP_SET_ARENA, len(body)) + body],
              [(socket.SOL_SOCKET, socket.SCM_RIGHTS, array.array("i", [fd]).tobytes())])
    status, rlen = struct.unpack("<IQ", PS._recv_exact(s, 12))
    assert status == PS.STATUS_OK and rlen == 0
    return fd, mmap.mmap(fd, size)


def test_legacy_arena_round_trip(workers):
    _, op, payload = CASES["legacy-to_rows_fixed"]
    want = RS._dispatch(op, payload, "cpu")
    s = _dial(workers["port"][1])
    fd, mm = _set_arena(s, 1 << 20)
    try:
        mm[: len(payload)] = payload
        s.sendall(struct.pack("<IQ", op | PS.ARENA_FLAG, len(payload)))
        status, rlen = struct.unpack("<IQ", PS._recv_exact(s, 12))
        assert status == PS.STATUS_OK | PS.ARENA_FLAG
        assert bytes(mm[:rlen]) == want
    finally:
        s.close()
        mm.close()
        os.close(fd)


def test_slab_region_with_a_stale_generation_is_retryable(workers):
    _, op, payload = CASES["legacy-zorder"]
    s = _dial(workers["port"][1])
    fd, mm = _set_arena(s, 1 << 16, mode=PS.ARENA_MODE_SLAB)
    try:
        off, rid = 4096, 7
        PS.REGION_HDR.pack_into(mm, off, PS.REGION_MAGIC, 3, rid, 8192 - PS.REGION_HDR_LEN,
                                len(payload))
        mm[off + PS.REGION_HDR_LEN: off + PS.REGION_HDR_LEN + len(payload)] = payload
        desc = PS.REGION_DESC.pack(off, rid, 2)  # generation 2, the slab says 3
        status, _, _, body = _frame(s, op | PS.ARENA_FLAG, desc)
        assert status == PS.STATUS_ERROR
        assert body.startswith(b"RetryableError: arena region: region header desync")
        # the current generation answers inside the region
        s.sendall(struct.pack("<IQ", op | PS.ARENA_FLAG, PS.REGION_DESC.size)
                  + PS.REGION_DESC.pack(off, rid, 3))
        status, rlen = struct.unpack("<IQ", PS._recv_exact(s, 12))
        assert status == PS.STATUS_OK | PS.ARENA_FLAG
        start = off + PS.REGION_HDR_LEN
        assert bytes(mm[start: start + rlen]) == RS._dispatch(op, payload, "cpu")
    finally:
        s.close()
        mm.close()
        os.close(fd)


def test_trace_flag_keeps_the_stream_framed(workers):
    s = _dial(workers["port"][1])
    try:
        ctx = struct.pack("<QQB", 0x1234, 0x55, 1)
        assert len(ctx) == ptracing.TRACE_CTX_LEN
        status, _, _, body = _frame(s, PS.OP_PING | PS.TRACE_FLAG, b"", ctx)
        assert (status, body) == (PS.STATUS_OK, b"cpu")
        assert _frame(s, PS.OP_PING)[3] == b"cpu"
    finally:
        s.close()


def test_two_concurrent_connections(workers):
    cases = [CASES["legacy-to_rows_fixed"], CASES["legacy-dec_mul"]]
    want = [RS._dispatch(op, pl, "cpu") for _, op, pl in cases]
    got, errs = [None, None], []

    def run(i):
        try:
            c = PS.SupervisedClient(workers["port"][1], deadline_s=60, heartbeat_s=1e9)
            _, op, pl = cases[i]
            got[i] = [c.request(op, pl) for _ in range(3)]
            c.close()
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs, errs
    assert got == [[w] * 3 for w in want]


def test_cuda_worker_without_a_card_exits_2_before_ready():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would serve on it")
    sock = tempfile.mktemp(prefix="srjtorch-nocard-") + ".sock"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-m", "spark_rapids_jni_tpu_torch.sidecar",
                          "--device", "cuda", "--socket", sock],
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 2
    assert pknobs.SIDECAR_READY not in res.stdout
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(sock)


def test_launcher_refuses_any_other_module():
    launcher = PR.sidecar_launcher("cpu")
    for argv in (["-m", "spark_rapids_jni_tpu_torch.sidecar"], ["-c", "print(1)"], []):
        res = subprocess.run([launcher, *argv, "--socket", "/nonexistent.sock"],
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 2, argv
        assert "expected -m spark_rapids_jni_tpu.sidecar" in res.stderr


def test_zz_shutdown_unlinks_the_socket(workers):
    proc, sock = workers["port"]
    s = _dial(sock)
    try:
        status, rlen = _frame(s, PS.OP_SHUTDOWN)[:2]
        assert (status, rlen) == (PS.STATUS_OK, 0)
    finally:
        s.close()
    assert proc.wait(30) == 0
    assert not os.path.exists(sock)
