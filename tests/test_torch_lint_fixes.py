"""Port: the sites the port's lint found departing from the JAX package
and that were fixed rather than annotated still answer as the reference
does. The exchange server bounds every request read by its deadline (a
peer that sends half a header is dropped after ``deadline_s``, and a
whole PING is answered), and a missing card is the taxonomy's fatal
device error, still a RuntimeError with the same message."""

import socket
import time

import pytest
import torch

from torch_exchange_sides import PORT, REF


def _half_header_then_ping(side):
    ex = side.shuffle.TcpExchange(0, deadline_s=0.3, **side.kw)
    try:
        host, port = ex.address.rsplit(":", 1)
        # a whole PING is answered with OK and the server's generation
        assert ex.ping(ex.address, 5.0) in (0, None)
        s = socket.create_connection((host, int(port)), timeout=5)
        s.sendall(b"\x00" * 3)  # a stalled peer: 3 bytes of a request header
        t0 = time.monotonic()
        s.settimeout(5)
        got = s.recv(16)  # the server drops the connection at its deadline
        waited = time.monotonic() - t0
        s.close()
        return got, waited
    finally:
        ex.close()


@pytest.mark.parametrize("side", [REF, PORT], ids=["ref", "port"])
def test_exchange_server_drops_a_stalled_request_at_its_deadline(side):
    got, waited = _half_header_then_ping(side)
    assert got == b"" and 0.2 <= waited < 4.0


def test_missing_card_is_a_fatal_device_error(monkeypatch):
    from spark_rapids_jni_tpu_torch.parallel import device, mesh
    from spark_rapids_jni_tpu_torch.utils.errors import FatalDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FatalDeviceError, match="no CUDA device is available"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="executor binds to a card"):
        device.device_for_executor(0)
    assert issubclass(FatalDeviceError, RuntimeError)


def test_peer_stderr_copy_keeps_the_tail_when_our_stderr_is_closed(monkeypatch):
    """The narrowed except of the stderr copy: a closed stderr of ours
    (ValueError) costs the copy, never the child's kept tail."""
    import io
    import subprocess
    import sys

    from spark_rapids_jni_tpu_torch.parallel import shuffle

    closed = io.StringIO()
    closed.close()
    monkeypatch.setattr(sys, "stderr", closed)
    proc = subprocess.Popen([sys.executable, "-c", "import sys; sys.stderr.write('a\\nb\\n')"],
                            stderr=subprocess.PIPE, text=True)
    shuffle._drain_stderr(proc)
    proc.wait(timeout=60)
    assert shuffle.peer_stderr(proc) == "a\nb\n"
