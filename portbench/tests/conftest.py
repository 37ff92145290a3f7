"""The metric readers of the program's spans turn its recorder on when
they are imported (pb/program_spans.py), and test processes are shared:
each test here leaves the recorder off and empty, as it found it."""
import sys

import pytest


@pytest.fixture(autouse=True)
def recorder_left_off():
    yield
    rec = sys.modules.get("repro_torch.spans")
    if rec is not None:
        rec.disable()
        rec.clear()
