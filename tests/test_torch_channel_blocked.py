"""The six channel parity cases on the blocked projector, repro_torch against
repro: ten rounds of ``round_simulated`` and a ten-round ``run_compiled``
(``tests/torch_channel_cases.py``)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.torch_channel_cases import (  # noqa: E402
    CHANNEL_CASES, check_rounds, check_runs, make_data, one_torch_thread,
)


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_channel_case_rounds_match_reference(name):
    check_rounds(name, "blocked")


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_channel_case_runs_match_reference(data, name):
    check_runs(data, name, "blocked")
