"""Run one cell of BENCHMARK.json once on the card:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output.  Builds and
caches live inside the checkout: the program's kernels in ``build/``
(nvcc, at a path fixed in the program), the model files in
``chipbench/cache/``."""
import time

T_START = time.perf_counter()      # set-up is counted from here

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
# the package by its name, never this folder's modules as top-level ones
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit(f"no program at {ROOT / 'src' / 'repro_torch'}: no run")

if __name__ == "__main__":
    from chipbench.harness import main
    sys.exit(main(t_start=T_START))
