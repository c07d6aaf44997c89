"""Port: the knob registry (``spark_rapids_jni_tpu_torch/utils/knobs.py``)
held against the JAX package's. Every port knob is the reference knob of
the same suffix under the port's prefix, with the same type, default and
validation, and the typed accessors parse a table of raw strings the same
way (value and warning)."""

import warnings

import pytest

from spark_rapids_jni_tpu.utils import knobs as rk
from spark_rapids_jni_tpu_torch.utils import knobs as pk

PORT_NAMES = sorted(pk.names())


def _ref_name(port_name: str) -> str:
    return "SRJT_" + port_name[len(pk.PREFIX):]


def test_prefix_is_not_the_references():
    # the reference's linter matches its own prefix followed by "_"; the
    # port's prefix must not contain it
    assert "SRJT_" not in pk.PREFIX and pk.PREFIX.endswith("_")
    assert all(n.startswith(pk.PREFIX) for n in PORT_NAMES)
    with pytest.raises(ValueError, match="prefix"):
        pk.declare(_ref_name("SRJTORCH_X"), "int", 0, "doc")


def test_the_port_declares_its_modules_knobs():
    groups = {"RETRY_": 7, "DEADLINE_SEC": 1, "BREAKER_": 2, "METRICS_": 2,
              "TRACE_": 5, "SLOW_QUERY_SEC": 1, "INTEGRITY_CHECKS": 1,
              "FAULTINJ_": 3, "DEVICE_MEMORY_BUDGET": 1, "ADAPTIVE_TIMEOUT_": 4,
              "EXCHANGE_": 3, "CLUSTER_": 6, "PLAN_REPORT": 1, "STATS_": 4, "CBO_": 3,
              "HOST_MEMORY_BUDGET": 1, "SPILL_": 3, "ADMISSION_": 2, "MEMGOV_": 2,
              "OOC_": 5, "PLAN_CACHE": 1, "SUBRESULT_CACHE": 1, "CACHE_": 4}
    for stem, n in groups.items():
        assert sum(1 for k in PORT_NAMES if k[len(pk.PREFIX):].startswith(stem)) == n, stem
    assert len(PORT_NAMES) == sum(groups.values())


@pytest.mark.parametrize("name", PORT_NAMES)
def test_knob_matches_reference(name):
    p, r = pk.knob(name), rk.knob(_ref_name(name))
    assert (p.type, p.default, p.positive, p.minimum, p.choices, p.scope) == (
        r.type, r.default, r.positive, r.minimum, r.choices, r.scope)


_RAWS = ["", "1", "0", "true", "FALSE", "yes", "No", "maybe", "-3", "0.0",
         "2.5", "17", "1e3", "nan", " 4 ", "abc"]
_BY_TYPE = {}
for _k in PORT_NAMES:
    _BY_TYPE.setdefault(pk.knob(_k).type, []).append(_k)
# one knob of every (type, positive, minimum) kind
_KINDS = sorted({(pk.knob(k).type, pk.knob(k).positive, pk.knob(k).minimum): k
                 for k in PORT_NAMES}.values())


def _read(mod, name, raw):
    getter = {"bool": mod.get_bool, "int": mod.get_int, "float": mod.get_float,
              "str": mod.get_str}[mod.knob(name).type]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = getter(name, env={name: raw})
    return value, len(caught)


@pytest.mark.parametrize("name", _KINDS)
def test_malformed_strings_parse_like_the_reference(name):
    for raw in _RAWS:
        pv, pw = _read(pk, name, raw)
        rv, rw = _read(rk, _ref_name(name), raw)
        assert (pv == rv or (pv != pv and rv != rv)) and pw == rw, (name, raw, pv, rv)


def test_env_float_matches_reference():
    for raw in _RAWS:
        for positive in (False, True):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                a = pk.env_float({"k": raw}, "k", 7.0, positive=positive)
                b = rk.env_float({"k": raw}, "k", 7.0, positive=positive)
            assert a == b or (a != a and b != b), raw


def test_undeclared_reads_fail_and_live_reads(monkeypatch):
    with pytest.raises(KeyError, match="undeclared"):
        pk.get_int("SRJTORCH_NO_SUCH_KNOB")
    monkeypatch.setenv("SRJTORCH_RETRY_MAX_ATTEMPTS", "9")
    assert pk.get_int("SRJTORCH_RETRY_MAX_ATTEMPTS") == 9
    assert pk.is_set("SRJTORCH_RETRY_MAX_ATTEMPTS")
    monkeypatch.delenv("SRJTORCH_RETRY_MAX_ATTEMPTS")
    assert pk.get_int("SRJTORCH_RETRY_MAX_ATTEMPTS") == 4
    assert not pk.is_set("SRJTORCH_RETRY_MAX_ATTEMPTS")


def test_markdown_table_lists_every_knob():
    table = pk.markdown_table()
    lines = table.splitlines()
    assert lines[0] == "| knob | type | default | description |"
    assert len(lines) == 2 + len(PORT_NAMES)
    for name in PORT_NAMES:
        assert f"| `{name}` |" in table
    assert "SRJT_" not in table


def test_exchange_ready_sentinel_is_the_references_under_the_port_prefix():
    # the worker's READY line is a sentinel, not a knob
    assert pk.SENTINELS == {pk.EXCHANGE_READY}
    assert _ref_name(pk.EXCHANGE_READY) in rk.SENTINELS
    assert not pk.is_declared(pk.EXCHANGE_READY)
