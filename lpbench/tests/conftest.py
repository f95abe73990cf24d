"""Shared set-up of the benchmark's own tests (run with
``python -m pytest lpbench/tests``).

A test that needs a CUDA card takes the ``card`` fixture, which skips it
where there is none; the decision is made inside the fixture, at run time.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")
    import torch

    # the tests' LPs are tiny: one thread a worker beats several workers'
    # threads contending for the cores
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test measures the program on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this test is of a machine without one")


# each cell at a size a test on the CPU can hold
TINY = {"dense64-scan": {"lps_per_group": 24, "check_lps": 12, "trace_calls": 1},
        "netlib3-padded": {"lps_per_group": 6, "check_lps": 9, "trace_calls": 1},
        "netlib3-buckets": {"lps_per_group": 6, "check_lps": 9, "trace_calls": 1},
        "dense64-sweep": {"lps_per_group": 70, "check_lps": 12, "trace_windows": 1,
                          "entry_kwargs": {"chunk": 32, "window_chunks": 2, "compact_cap": 12,
                                           "compact_bucket": 16, "finish_cap": 3,
                                           "finish_bucket": 16}}}


@pytest.fixture
def tiny():
    """The cell of a name with its traffic cut to :data:`TINY`'s size."""
    from lpbench import harness

    def make(name: str):
        cell = harness.load_cell(name)
        cell.traffic = {**cell.traffic, **TINY[name]}
        return cell

    return make
