"""The benchmark's CPU tests: run with ``python -m pytest benchmark/tests``
from the root of the checkout (tests that need the card carry the ``cuda``
marker and decide inside the test)."""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(1)
