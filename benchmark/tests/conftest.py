"""The benchmark's tests import its modules from ``benchmark/`` and the
measured package from the repo's root."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
