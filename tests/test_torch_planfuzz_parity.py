"""Port: ``analysis/planfuzz.py`` and ``analysis/plancheck.py`` held
against the JAX package's. For one seed both generators draw the same
template and build plans with the same fingerprint (200 seeds, no plan is
run); the direct-plan interpreter gives the same canonical rows on the
same relations; the port's own differential fuzz (compile, run on the
CPU, hold against its interpreter, verify) is clean for 20 seeds; and
plancheck over the registry at a small row count gives the reference's
violations (none) and obligation counts."""

import numpy as np
import pytest

import spark_rapids_jni_tpu  # noqa: F401  (x64 before any array)
from spark_rapids_jni_tpu import plan as RP
from spark_rapids_jni_tpu.analysis import plancheck as RPC
from spark_rapids_jni_tpu.analysis import planfuzz as RPF
from spark_rapids_jni_tpu.models.tpcds import gen_store_wide as r_gen_store_wide

from spark_rapids_jni_tpu_torch import plan as PP
from spark_rapids_jni_tpu_torch.analysis import plancheck as PPC
from spark_rapids_jni_tpu_torch.analysis import planfuzz as PPF
from spark_rapids_jni_tpu_torch.models.tpcds import gen_store_wide as p_gen_store_wide

BASE = 1234  # the fuzzers' default base seed: plan i is BASE * 100003 + i
ROWS, TABLE_SEED = 160, 97  # the fuzzers' own tables
_RELS = {}


def _rels():
    if not _RELS:
        rt = r_gen_store_wide(ROWS, seed=TABLE_SEED)
        pt = p_gen_store_wide(ROWS, seed=TABLE_SEED, device="cpu")
        _RELS["r"] = {t: RPF.rel_of_table(tb) for t, tb in rt.items()}
        _RELS["p"] = {t: PPF.rel_of_table(tb) for t, tb in pt.items()}
        _RELS["pt"] = pt
    return _RELS


@pytest.mark.parametrize("block", range(10))
def test_gen_plan_draws_the_references_plans(block):
    for i in range(block * 20, block * 20 + 20):
        seed = BASE * 100003 + i
        rir, rname = RPF.gen_plan(np.random.default_rng(seed))
        pir, pname = PPF.gen_plan(np.random.default_rng(seed))
        assert pname == rname, seed
        assert PP.fingerprint(pir) == RP.fingerprint(rir), (seed, pname)


def test_rel_of_table_matches_reference():
    rels = _rels()
    assert rels["p"].keys() == rels["r"].keys()
    for t in rels["r"]:
        assert rels["p"][t] == rels["r"][t], t


@pytest.mark.parametrize("i", range(0, 40, 2))
def test_interpret_matches_reference(i):
    rels = _rels()
    seed = BASE * 100003 + i
    rir, _ = RPF.gen_plan(np.random.default_rng(seed))
    pir, _ = PPF.gen_plan(np.random.default_rng(seed))
    rn, rrows = RPF.interpret(rir, rels["r"])
    pn, prows = PPF.interpret(pir, rels["p"])
    assert pn == rn and PPF.canon(prows) == RPF.canon(rrows)


def test_port_fuzz_is_clean_on_the_cpu():
    """The port's own differential chain over 20 plans of the base seed:
    generate -> verify -> compile -> run on the CPU -> its interpreter."""
    rels = _rels()
    tables = rels["pt"]
    catalog = PPC.catalog_of(tables)
    templates = set()
    for i in range(20):
        fs, info = PPF.fuzz_one(BASE * 100003 + i, tables, rels["p"], catalog,
                                where=f"fuzz:{BASE}/{i}")
        assert fs == [] and not info["mismatch"], (i, info, fs)
        templates.add(info["template"])
    assert len(templates) >= 4


def test_plancheck_registry_matches_reference():
    rv, rrec = RPC.run(rows=64)
    pv, prec = PPC.run(rows=64, device="cpu")
    assert rv == [] and pv == []
    assert [r["query"] for r in prec] == [r["query"] for r in rrec]
    assert [(r["obligations"], r["rewrites"], r["stages"], r["violations"]) for r in prec] == [
        (r["obligations"], r["rewrites"], r["stages"], r["violations"]) for r in rrec]
    assert {"q3x4", "q55x4"} <= {r["query"] for r in prec}


def test_plancheck_unknown_query_fails_loudly():
    with pytest.raises(SystemExit, match="unknown plan name"):
        PPC.run(rows=8, queries=["q3", "nope"], device="cpu")


def test_plancheck_binds_tables_it_is_given():
    from spark_rapids_jni_tpu_torch.models import tpcds

    store = tpcds.gen_store(48, seed=5, device="cpu")
    v, recs = PPC.run(queries=["q3", "q55x4"], tables={"gen_store": store}, device="cpu")
    assert v == [] and [r["query"] for r in recs] == ["q3", "q55x4"]


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    import json

    report = tmp_path / "plan_verify.jsonl"
    assert PPC.main(["--rows", "32", "--queries", "q3,q55", "--device", "cpu",
                     "--report", str(report)]) == 0
    assert [json.loads(x)["query"] for x in report.read_text().splitlines()] == ["q3", "q55"]
    assert PPF.main(["--seed", "7", "--plans", "3", "--device", "cpu",
                     "--report", str(report)]) == 0
    rec = json.loads(report.read_text().splitlines()[-1])
    assert rec["kind"] == "fuzz" and rec["plans"] == 3 and rec["mismatches"] == 0
    capsys.readouterr()
