"""The readings the output check's limits are set from: for each seed, the
program's numbers over ``check_calls`` served calls of the cell, and the
control's (the reference with float8 matmuls in the program's place) over
the same prompts and tokens, in one process. Not run by the benchmark.

    python3 bench/calibrate.py --workload mamba2-2.7b.prefill-2k \
        --seeds 101 102 103

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("calibrate measures the card: no CUDA device", file=sys.stderr)
        return 2
    c = harness.cell(args.workload)
    b = harness.Bench(c, "cuda")
    rows = []
    for seed in args.seeds:
        b.load(seed)
        b.warm_up(seed)
        calls = [b.call(seed, k) for k in range(c.traffic.check_calls)]
        w = b.weights(seed)
        t0 = time.perf_counter()
        nums = harness.judge(b.conf, calls, w, "cuda", control=True)
        judge_s = time.perf_counter() - t0
        del w, calls
        rows.append(nums)
        print(json.dumps({"seed": seed, **nums, "judge_s": judge_s}),
              flush=True)
    for name in ("logit_err", "logit_dev", "token_gap"):
        print(json.dumps({name: {
            "program_max": max(r[name] for r in rows),
            "control_min": min(r["control_" + name] for r in rows)}}))
    print(json.dumps({"token_mismatch": {
        "program_max": max(r["token_mismatch"] for r in rows)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
