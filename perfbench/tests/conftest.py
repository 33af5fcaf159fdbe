"""The benchmark's CPU tests: ``python -m pytest perfbench/tests -q`` from the
repository's root.  The tests marked ``cuda`` run on a card and skip without
one."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
