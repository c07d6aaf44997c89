"""Port: the per-row oracles chip_smoke.py holds the card's string_ops
path to, on a small table of its columns, against the port on the CPU
(the plain versions of B8 and B5)."""

import pytest
import torch


@pytest.mark.parametrize("seed", [7, 2026])
def test_chip_smoke_oracles_agree_with_the_port(monkeypatch, seed):
    # the per-row oracles chip_smoke.py holds the card's string_ops path to,
    # on a small table of its columns, against the port on the CPU
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    h, t = chip_smoke._string_ops_inputs(seed, 1500, device="cpu")
    (out, _), seen8, seen5, _, predicted = chip_smoke._capture_string_ops(
        lambda: chip_smoke._spark_exact_path(chip_smoke._string_ops(t)))
    assert predicted == {"extract_strings_many": len(seen8), "ragged_compact_many": len(seen5)}
    summary = chip_smoke._check_string_ops(h, out)
    # the multilingual column reaches every class of the reference's
    # differences from Spark (ROADMAP section 3)
    for k in ("length_multi_spark_differs", "substring_multi_spark_differs",
              "upper_multi_spark_differs", "lower_multi_spark_differs"):
        assert summary[k] > 0, k
