"""A fixture that runs each test of a module on two PyTorch threads.

The tier-1 command runs six pytest workers at once; a worker's PyTorch
would otherwise start as many threads as the machine has cores, and the
workers' threads would crowd each other out, the JAX tests' compiles
among them.  The small batches of the port's CPU tests gain little from
more threads.  Every ``tests/test_torch_*.py`` file but the card tests
imports it (``from tests.torch_threads import few_threads``).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
  n = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(n)
