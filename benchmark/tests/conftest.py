"""The benchmark's own tests, on the CPU (a test that needs the card is
marked `cuda` and skips without one):

    python -m pytest benchmark/tests -q

The harness's modules sit in benchmark/, the program at the checkout's
root."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
