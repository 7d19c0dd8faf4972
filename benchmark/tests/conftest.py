"""The benchmark's own tests: run them from the root of the checkout
with `python -m pytest benchmark/tests -q`.  Those marked `cuda` need a
card and skip without one; the rest run on the CPU at small sizes."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for _p in (BENCH, ROOT):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

# A cell's frames at a size the CPU encodes in a second or two.
SMALL = {"height": 64, "width": 132, "frames": 3, "frames_checked": 2,
         "streams_checked": 2}


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
