"""Readings for the limits of ``correct``, on the card at a cell's own
size (never part of a benchmark run):

    python3 chipbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3

prints one JSON line per seed: the program as the configuration states
it (``"side": "program"``), then the control (``"side": "control"``):
the program's own path at the next precision below the configuration's
(``QuantSpec(bits=8)`` for int16), held to the same int16 reference.
Each side is set up once and runs a short window per seed."""
import copy
import json
import sys
import time

from run import ROOT  # noqa: F401  (puts the program and package on the path)

from chipbench.harness import Cell, forbidden_modules  # noqa: E402

# the program's own path at the next width below the configuration's
LOWER_BITS = {16: 8}


def readings(manifest, workload, seeds, seconds, side, program_cfg=None):
    cell = Cell(manifest, ROOT, workload, "cuda", program_cfg)
    for seed in seeds:
        w = cell.measure(seed, seconds, False, time.perf_counter())
        r = cell.judge(w, False)
        print(json.dumps({"side": side, "workload": workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "attempted": r["attempted"]}), flush=True)
    return cell


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = readings(manifest, args.workload,
                    [int(s) for s in args.seeds.split(",")], args.seconds,
                    "program")
    lower = copy.deepcopy(cell.cfg)
    lower["quant"]["bits"] = LOWER_BITS[cell.cfg["quant"]["bits"]]
    cell.close()
    readings(manifest, args.workload,
             [int(s) for s in args.control_seeds.split(",")], args.seconds,
             "control", lower).close()
    return 3 if forbidden_modules() else 0


if __name__ == "__main__":
    sys.exit(main())
