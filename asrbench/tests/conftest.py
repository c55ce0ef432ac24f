"""The benchmark's own tests: ``python -m pytest asrbench/tests`` from the
repository's root. Tests marked ``cuda`` run on the card and skip
elsewhere, deciding inside the test."""

import pytest

from benchhelp import run_tiny


@pytest.fixture
def tiny(capsys):
    return lambda *argv: run_tiny(capsys, *argv)
