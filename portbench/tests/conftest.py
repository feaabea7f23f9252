"""The benchmark's own tests (CPU; ``-m cuda`` on the card):

    python -m pytest portbench/tests -q            # CPU, the card's tests skip
    python -m pytest portbench/tests -q -m cuda    # on the card
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips (inside the test) without one")
