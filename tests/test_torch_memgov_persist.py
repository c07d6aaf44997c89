"""Port: durable spill metadata (``spark_rapids_jni_tpu_torch/memgov/persist.py``)
held against the JAX package's: the manifest layer of
``tests/test_durable.py`` (``TestManifests``, ``TestDurableCheckpointKnob``
and the torn-manifest case), without the journal, which waits for the
serving tier. Each case runs on both packages and compares the startup
reports, the ``memgov.*`` counter deltas (zeros dropped), the files left
and the bytes re-attached."""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from torch_memgov_sides import PORT, REF, SIDES, both, clean, setenv

# the default per-process spill dir's prefix on each side
_DEFAULT_DIR = {REF.name: "srjt-spill-", PORT.name: "srjtorch-spill-"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for s in SIDES:
        for suffix in ("SPILL_MANIFESTS", "SPILL_DIR", "OOC_DURABLE_CHECKPOINTS"):
            monkeypatch.delenv(s.prefix + suffix, raising=False)
        clean(s)
    yield
    for s in SIDES:
        clean(s)


@pytest.fixture
def sweep_dir(tmp_path, monkeypatch):
    """Point the default-dir sweep at an empty directory, so that stray
    spill dirs of other (dead) processes never skew the counters."""
    d = tmp_path / "sweep-dir"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def _dead_pid():
    p = subprocess.Popen([sys.executable, "-c", ""])
    p.wait()
    return p.pid


def _payload(s, a):
    return [s.array(a)]


def _treedef(s, a):
    if s is REF:
        import jax

        return jax.tree_util.tree_flatten([np.asarray(a)])[1]
    from torch_memgov_sides import pcatalog

    return pcatalog.flatten([torch.from_numpy(np.asarray(a))])[1]


def _forge_manifest(s, frame_path, pid, key, kind, nbytes, n_leaves, treedef):
    """A manifest naming an arbitrary owning PID: 'a previous process
    wrote this and died'."""
    payload = pickle.dumps({"key": key, "kind": kind, "nbytes": nbytes,
                            "n_leaves": n_leaves, "pid": pid, "treedef": treedef},
                           protocol=pickle.HIGHEST_PROTOCOL)
    frame = (s.persist._MAGIC
             + s.persist._HDR.pack(len(payload), s.integrity.checksum(payload)) + payload)
    with open(s.persist.manifest_path(str(frame_path)), "wb") as f:
        f.write(frame)


def _listing(d):
    return sorted(p.name for p in d.iterdir())


class TestManifests:
    def test_round_trip_and_torn_reads_as_rot(self, tmp_path):
        def case(s):
            d = tmp_path / s.name
            d.mkdir()
            frm = d / "key-1.frm"
            frm.write_bytes(b"\x00" * 16)
            ok = s.persist.write_manifest(str(frm), "key", "partition", 16, 1,
                                          _treedef(s, np.arange(4)))
            man = s.persist.read_manifest(str(frm))
            got = (ok, man["key"], man["kind"], man["pid"] == os.getpid(), man["n_leaves"])
            s.persist.remove_manifest(str(frm))
            gone = s.persist.read_manifest(str(frm)) is None
            s.faultinj.configure({"seed": 2, "faults": {"memgov.manifest": {
                "type": "torn_write", "percent": 100, "delayMs": 20}}})
            torn_ok = s.persist.write_manifest(str(frm), "k", "partition", 32, 1,
                                               _treedef(s, np.arange(3)))
            s.faultinj.disable()
            return got, gone, torn_ok, s.persist.read_manifest(str(frm)) is None

        obs, d = both(case)
        assert obs == ((True, "key", "partition", True, 1), True, True, True)
        assert d == {"memgov.manifests_written": 2, "memgov.manifest_rot": 1}

    def test_spill_writes_manifest_when_armed_and_none_when_off(self, tmp_path, monkeypatch):
        def case(s):
            on, off = tmp_path / s.name / "on", tmp_path / s.name / "off"
            on.mkdir(parents=True)
            off.mkdir()
            setenv(monkeypatch, s, "SPILL_MANIFESTS", "1")
            setenv(monkeypatch, s, "SPILL_DIR", on)
            cat = s.memgov.BufferCatalog()
            h = cat.register("dur.x", _payload(s, np.arange(32, dtype=np.int64)),
                             kind="partition", pinned=False)
            h.spill(to_disk=True)
            (mf,) = list(on.glob("*.mf"))
            key = s.persist.read_manifest(str(mf)[: -len(".mf")])["key"]
            back = np.asarray(h.get()[0]).tolist()
            left = _listing(on)
            cat.close()
            monkeypatch.delenv(s.prefix + "SPILL_MANIFESTS")
            setenv(monkeypatch, s, "SPILL_DIR", off)
            cat = s.memgov.BufferCatalog()
            h = cat.register("vol.x", _payload(s, np.arange(8)), kind="buffer", pinned=False)
            h.spill(to_disk=True)
            mfs = list(off.glob("*.mf"))
            cat.close()
            return key, back == list(range(32)), left, mfs, _listing(off)

        obs, d = both(case)
        assert obs == ("dur.x", True, [], [], [])
        assert d["memgov.manifests_written"] == 1

    def test_reattach_dead_owner_bit_identical(self, tmp_path, monkeypatch, sweep_dir):
        payload = np.arange(64, dtype=np.float64) * 1.5

        def case(s):
            spill = tmp_path / s.name
            spill.mkdir()
            setenv(monkeypatch, s, "SPILL_MANIFESTS", "1")
            setenv(monkeypatch, s, "SPILL_DIR", spill)
            cat = s.memgov.BufferCatalog()
            h = cat.register("ooc.q.fp.part.0", _payload(s, payload), kind="partition",
                             pinned=False)
            h.spill(to_disk=True)
            (frm,) = list(spill.glob("*.frm"))
            frame = frm.read_bytes()
            man = s.persist.read_manifest(str(frm))
            _forge_manifest(s, frm, _dead_pid(), man["key"], man["kind"], man["nbytes"],
                            man["n_leaves"], man["treedef"])
            with cat._lock:  # the owner died: nothing unlinks its files
                cat._entries.pop("ooc.q.fp.part.0")
            cat2 = s.memgov.BufferCatalog()
            report = s.persist.startup(cat2)
            h2 = cat2.lookup("ooc.q.fp.part.0")
            tier = h2.tier
            back = np.asarray(h2.get()[0]).tobytes()
            cat2.close()
            cat.close()
            return report, tier, back == payload.tobytes(), frame

        obs, d = both(case)
        assert obs[0]["reattached"] == 1 and obs[1:3] == ("disk", True)
        assert d["memgov.reattached"] == 1

    def test_dead_owner_buffer_reclaimed_live_and_unprovable_left(self, tmp_path, monkeypatch,
                                                                  sweep_dir):
        def case(s):
            spill = tmp_path / s.name
            spill.mkdir()
            setenv(monkeypatch, s, "SPILL_MANIFESTS", "1")
            setenv(monkeypatch, s, "SPILL_DIR", spill)
            (spill / "ws-1.frm").write_bytes(b"\x00" * 24)
            _forge_manifest(s, spill / "ws-1.frm", _dead_pid(), "ws", "buffer", 24, 1,
                            _treedef(s, np.arange(2)))
            (spill / "live-1.frm").write_bytes(b"\x00" * 24)
            s.persist.write_manifest(str(spill / "live-1.frm"), "live", "partition", 24, 1,
                                     _treedef(s, np.arange(2)))
            (spill / "mystery-1.frm").write_bytes(b"\x00" * 8)
            report = s.persist.startup(s.memgov.BufferCatalog())
            return report, _listing(spill)

        obs, d = both(case)
        assert obs[0] == {"reattached": 0, "orphans_reclaimed": 1, "skipped_live": 1,
                          "unprovable": 1}
        assert obs[1] == ["live-1.frm", "live-1.frm.mf", "mystery-1.frm"]
        assert d == {"memgov.manifests_written": 1, "memgov.orphans_reclaimed": 1}

    def test_default_dir_sweep_reclaims_dead_pid(self, sweep_dir):
        def case(s):
            dead = _dead_pid()
            d = sweep_dir / f"{_DEFAULT_DIR[s.name]}{dead}"
            d.mkdir()
            (d / "a-1.frm").write_bytes(b"\x00" * 8)
            (d / "a-1.frm.mf").write_bytes(b"junk")
            (d / "stray.txt").write_bytes(b"not ours")
            live = sweep_dir / f"{_DEFAULT_DIR[s.name]}{os.getpid()}"
            live.mkdir()
            (live / "b-1.frm").write_bytes(b"\x00" * 8)
            n = s.persist.sweep_default_dirs()
            out = (n, _listing(d), _listing(live))
            (live / "b-1.frm").unlink()
            return out

        obs, d = both(case)
        assert obs == (1, ["stray.txt"], ["b-1.frm"])
        assert d == {"memgov.orphans_reclaimed": 1}


class TestDurableCheckpointKnob:
    def test_memgov_catalog_factory_runs_startup(self, tmp_path, monkeypatch, sweep_dir):
        def case(s):
            spill = tmp_path / s.name
            spill.mkdir()
            setenv(monkeypatch, s, "SPILL_MANIFESTS", "1")
            setenv(monkeypatch, s, "SPILL_DIR", spill)
            frm = spill / "seed-1.frm"
            frm.write_bytes(b"\x00" * 8)
            _forge_manifest(s, frm, _dead_pid(), "seed", "buffer", 8, 1,
                            _treedef(s, np.arange(1)))
            s.memgov.reset()
            s.memgov.catalog()  # the factory hook sweeps on construction
            out = frm.exists()
            s.memgov.reset()
            return out

        obs, d = both(case)
        assert obs is False and d == {"memgov.orphans_reclaimed": 1}

    def test_durable_checkpoint_knob_matches(self):
        from spark_rapids_jni_tpu.utils import knobs as rk
        from spark_rapids_jni_tpu_torch.utils import knobs as pk

        for suffix in ("OOC_DURABLE_CHECKPOINTS", "SPILL_MANIFESTS"):
            p, r = pk.knob(PORT.prefix + suffix), rk.knob("SRJT_" + suffix)
            assert (p.type, p.default) == (r.type, r.default) == ("bool", False)
