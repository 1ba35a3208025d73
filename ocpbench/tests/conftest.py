"""The benchmark's own tests: ``python -m pytest ocpbench/tests`` from the
root of the repository (CPU only, smoke widths)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
