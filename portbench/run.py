"""The benchmark of the PyTorch and CUDA port of the detector.

Run from the root of a checkout, on a machine with the card(s) the cell
asks for:

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cells, their configurations and traffic mixes, and the metrics are
named in ``BENCHMARK.json`` at the root; everything else of the
benchmark lives under ``portbench/``.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``compared``, the
numbers the output check held to their limits).
"""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel cache of the program at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], ROOT, T_START))
