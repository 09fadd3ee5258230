"""``python -m portbench``: one run of one cell (:mod:`portbench.run`)."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402

from .run import main  # noqa: E402

sys.exit(main(t0=T0))
