"""Port: ops/regex's replace runtime (replace_re) against the JAX
package's: each case of ``test_regex.py``'s REPLACE_CASES runs once
through each package on ``test_torch_regex_spans.py``'s shared corpus;
offsets, chars and validity equal bit for bit, and the valid-UTF-8 rows
equal to Python's ``re.sub`` under ``re.ASCII``."""

import re

import pytest

from spark_rapids_jni_tpu.ops import regex as J

from spark_rapids_jni_tpu_torch.ops import regex as P

from test_regex import REPLACE_CASES
from test_torch_regex_spans import corpus  # noqa: F401  (the module's fixture)
from torch_string_parity import corpus_text, rows_of, same_result


# two patterns take over 20 s alone: they run with -m slow, the other
# replacements stay in tier 1
_SLOW_REPLACE = ((r"[aeiou]", "_"), (r"\s+", " "))


@pytest.mark.parametrize("pattern,rep", [
    pytest.param(p, r, marks=pytest.mark.slow) if (p, r) in _SLOW_REPLACE else (p, r)
    for p, r in REPLACE_CASES + [(r"^a", "-")]])
def test_replace_re_matches_jax(corpus, pattern, rep):
    jc, pc = corpus
    got = P.replace_re(pc, pattern, rep.encode())
    same_result(got, J.replace_re(jc, pattern, rep.encode()), pattern)
    rows = rows_of(got)
    for i, s in corpus_text():
        assert rows[i].decode() == re.sub(pattern, rep, s, flags=re.ASCII), (pattern, s)
