"""The port's benchmark: one run of one cell on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the numbers compared with the
reference, each beside its limit, as the last lines on standard error,
and one JSON object as the last line of standard output. Exits non-zero,
with no result, without a CUDA card, or when the process holds jax,
jaxlib, flax or cvsim_tpu once the window has closed."""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
# the harness's own modules, then the checkout's root (the program)
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
