"""The port's CPU vector math is exact from its first call in a process.

PyTorch's CPU sqrt, exp and log call MKL's vector math.  Without the
one-thread call that ``aswstereomatch_torch/__init__.py`` makes at import,
a fresh process can compute one thread's share of its first multi-threaded
call ~1e-4 off (relative): the weights of the eager ASW path and the plain
kernel versions then differ from a rerun.  Each case starts fresh processes, imports the port and
holds the first multi-threaded call of the op (24,000 elements, split over
8 threads) against numpy's float64 result: within 1 float32 ulp for sqrt
and 2 for exp and log (the inaccurate shares are off by thousands).
"""

import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROCESSES = 16

SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import aswstereomatch_torch  # noqa: F401
    torch.set_num_threads(8)
    op = sys.argv[1]
    x = torch.rand(24, 1000, generator=torch.Generator().manual_seed(0)) * 16 + 0.5
    x = -x if op == "exp" else x
    got = getattr(torch, op)(x).numpy().astype(np.float64)
    want = getattr(np, op)(x.numpy().astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    print(float(np.max(np.abs(got - want) / ulp)))
""")


def _first_call_error(op: str) -> float:
    out = subprocess.run([sys.executable, "-c", SCRIPT, op], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return float(out.stdout.split()[-1])


@pytest.mark.parametrize("op,ulps", [("sqrt", 1.0), ("exp", 2.0), ("log", 2.0)])
def test_first_threaded_vector_math_call_is_accurate(op, ulps):
    with ThreadPoolExecutor(4) as pool:
        errs = list(pool.map(_first_call_error, [op] * PROCESSES))
    assert max(errs) <= ulps, f"first call off by {max(errs)} ulps in a fresh process: {errs}"
