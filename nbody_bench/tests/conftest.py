"""Shared helpers of the benchmark's tests (CPU unless marked ``gpu``)."""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


@pytest.fixture(scope="session")
def manifest():
    with open(MANIFEST) as f:
        return json.load(f)
