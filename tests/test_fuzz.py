"""Three-engine differential fuzz: compiled / standard / unfused engines
vs the NumPy oracle over random multi-way queries (cycles, self-joins,
duplicate bindings, filters).  A deeper soak lives in tests/_fuzz_impl.py
(run directly with a count argument)."""

import os
import subprocess
import sys
from pathlib import Path


def test_fuzz_30_queries():
    out = subprocess.run(
        [sys.executable, str(Path(__file__).parent / "_fuzz_impl.py"), "30"],
        capture_output=True, text=True, timeout=900,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", ""),
             "PYTHONPATH": str(Path(__file__).parents[1])},
    )
    assert "30 queries x 5 engines: 0 failures" in out.stdout, out.stdout[-2000:]
