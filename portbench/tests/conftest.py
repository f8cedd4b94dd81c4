"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``
from the root of the checkout. They import the port and the benchmark from
there."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
