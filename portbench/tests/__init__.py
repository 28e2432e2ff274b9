"""CPU tests of the benchmark: its data, its arithmetic, its reference
against the port's plain route, and its check against planted faults."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
