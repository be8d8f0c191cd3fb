"""The port's CPU tests run each test on one intra-op thread (a helper, not
a test file; it imports no JAX, so the gloo ranks a test module spawns can
import that module without JAX).

The models of these tests are tiny: one thread computes them as fast, and
under pytest-xdist's workers (six on eight cores) torch's default of one
thread per core oversubscribes the machine, which slowed a JAX trajectory
of ``test_torch_training.py`` from ~11 s alone to 119–137 s.  A test module
takes the fixture by importing it:

    from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the test, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
