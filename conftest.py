"""Test harness: one torch intra-op thread per test process.

The port's tests (``tests/test_torch_*.py``) run small CPU tensors in
pytest-xdist workers that share the host's cores with each other and
with XLA's own threads. torch's default, one intra-op thread per core in
every worker, oversubscribes the host and slows every worker, while
tensors of a few thousand rows gain nothing from a thread pool. The
checks themselves are the same either way.
"""

import torch

torch.set_num_threads(1)
