"""CPU tests of the benchmark (``python -m pytest bench/tests``): the
program under test, ``repro_torch``, is imported from the checkout's
``src``."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
