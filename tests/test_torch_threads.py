"""One intra-op thread in every test process.

The port's tests run many small tensors.  Left at its default (a thread
a core) PyTorch's intra-op pool gains nothing on them and, with several
test workers on one machine (``pytest -n 6``), each worker's threads
spin against the others': ``tests/test_torch_remat.py`` alone took 197
s of wall time and 734 s of CPU at the default, 110 s and 180 s with one
thread (CPU runs of this module's setting, 8 cores).  Every test module
is imported when pytest collects, in each worker process, so this
setting holds for the whole run; the processes the tests start set
``OMP_NUM_THREADS=1`` themselves (``tests/test_torch_ranks.py::env``).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
