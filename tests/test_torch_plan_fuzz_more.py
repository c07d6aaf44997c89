"""Port: the second twelve of ``test_torch_plan_fuzz.py``'s fuzzed plans
(base seed 1234), each compiled and run by both packages on the
reference fuzzer's tables and held to the reference as that module
holds the first twelve."""

import pytest

from test_torch_plan_fuzz import SEEDS, _fuzz_one, seed_params


@pytest.mark.parametrize("plan_seed", seed_params(SEEDS[12:]))
def test_fuzzed_plan_matches_reference(plan_seed):
    _fuzz_one(plan_seed)
