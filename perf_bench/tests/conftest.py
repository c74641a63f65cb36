"""The benchmark's own tests: ``python -m pytest perf_bench/tests -q`` from
the repository's root (``-m cuda`` on a card for the control's)."""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
