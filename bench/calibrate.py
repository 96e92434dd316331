"""Readings behind a cell's limits: the program's compared numbers and the
control's, seed after seed, in one process.

    python3 bench/calibrate.py --workload lj-pagerank --seeds 101,102,103 \
        --seconds 5

For each seed: one run of the cell as ``run.py`` makes it (the
configuration's graph, set-up, a window of ``--seconds`` at the cell's load, the same sampled
answers), then the comparison twice: the program's answers, and the
reference in bfloat16 put in their place (the control).  Prints one JSON
line a seed.  A limit sits between the largest program reading over a
dozen seeds or more and the smallest control reading (PERF.md gives both).
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        result, other = harness.run_cell(args.workload, seed, args.seconds,
                                         False, control=True)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "program": {k: c["value"] for k, c in
                                      result["checks"].items()},
                          "control": other["control_checks"],
                          "setup_s": other["setup_s"],
                          "check_s": other["check_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
