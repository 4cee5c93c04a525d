"""Readings that a training cell's limits are set from, for a cell of any
training loop: ``calibrate.py``'s readings with both training faults
planted.  ``calibrate.py`` picks its fault by the loop's name and plants
``answer`` in every loop but ``train_loop``; this plants ``half_batch``
and ``unchanged`` in the cell's own loop, whatever its name.

    python3 benchmark/tools/calibrate_train.py --workload large_ell_train \
        --seeds 1,2,3 --control 1,2 --fault 1 --seconds 3 --out <file.jsonl>

For each seed, on the card: the program's numbers against the float32
reference (``program``, the lower readings); on the ``--control`` seeds,
the reference in bfloat16 (``control``) and the float32 reference with
float8 e4m3 pair values (``control_pairs``) in the program's place; on the
``--fault`` seeds, the program with each fault planted (``fault``, by the
fault's name).  One JSON line a seed, to standard output and to
``--out``."""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
FAULTS = ("half_batch", "unchanged")


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(CHECKOUT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import calibrate
    from harness.registry import Registry
    reg = Registry(BENCH, json.loads((CHECKOUT / "BENCHMARK.json")
                                     .read_text()))
    out = open(args.out, "a") if args.out else None
    control, faulty = set(_seeds(args.control)), set(_seeds(args.fault))
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        loop, prog = calibrate.readings(reg, args.workload, seed,
                                        args.seconds, "cuda:0")
        rec = {"cell": args.workload, "seed": seed, "program": prog}
        if seed in control:
            rec["control"] = loop.control()
            rec["control_pairs"] = loop.control(
                torch.float32, (torch.float8_e4m3fn, False))
        del loop
        torch.cuda.empty_cache()
        if seed in faulty:
            rec["fault"] = {f: calibrate.readings(
                reg, args.workload, seed, args.seconds, "cuda:0", f)[1]
                for f in FAULTS}
        rec["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
