"""The program's serving daemon with a fault planted in its timed path.

    python benchmark/tests/faulty_daemon.py FAULT [serve's arguments]

``FAULT`` is one of ``faults.FAULTS``; the rest goes to
``aswstereomatch_torch.tools.serve.main``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from aswstereomatch_torch.tools import serve  # noqa: E402
from benchmark.tests import faults  # noqa: E402

if __name__ == "__main__":
    faults.plant(sys.argv[1])
    sys.exit(serve.main(sys.argv[2:]))
