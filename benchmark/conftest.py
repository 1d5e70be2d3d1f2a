"""The benchmark's tests: CPU tests at small shapes, and tests marked
`card` that need a CUDA card and skip without one.

    python -m pytest benchmark -q -p no:cacheprovider        # the CPU tests
    python -m pytest -o addopts="" benchmark -q -m card -s  # on the card
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    """Two CPU threads a test process: the tests run in several workers."""
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def small_config(name: str) -> dict:
    """A configuration of the benchmark at shapes a CPU test can prove:
    its tables above the program's host threshold (2^10 entries), so the
    device path runs (on the CPU, in the kernels' plain versions).  The
    name "matmul" gives the matrix-product generator's circuit at n = 16,
    which no configuration of the benchmark uses yet."""
    if name == "matmul":
        return {"name": "matmul", "generator": "matmul", "n": 16}
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    cfg.update(k=11, k_input=8, layer={"k": 11, "k_cur": 4})
    return cfg
