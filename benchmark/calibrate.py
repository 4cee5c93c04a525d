"""Readings that the limits of ``correct`` are set from, on the card, at
a cell's own size; not run by the benchmark's own runs.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control 1,2,3 --fault 1,2,3 --seconds 3 --out <file.jsonl>

For each seed: the program's numbers against the float32 reference (the
lower readings); on the ``--control`` seeds, the two lower-precision
controls in the program's place: the reference computed in bfloat16
(``control``) and the float32 reference with its pair values stored in
float8 e4m3 (``control_pairs``); on the
``--fault`` seeds, the program with a fault planted (training: half of
each batch left out; requests: one answer of each request altered); on
the ``--witness`` seeds of a training cell, the float32 reference with its
pair tensors rounded to bfloat16 (the program's stated precision), against
the float32 reference and against the program.  ``--path key=value``
(repeatable) sets a key of the configuration's program paths, as
``train.pair_dtype=f32``, for a second witness.  One JSON line a seed, to
standard output and to ``--out``."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def readings(reg, cell, seed, seconds, device, fault=None,
             paths=()) -> tuple:
    from harness.runner import Context
    ctx = Context(reg, cell, seed, seconds, False, device, fault)
    for kv in paths:
        key, value = kv.split("=", 1)
        path, name = key.split(".", 1)
        ctx.config["paths"][path][name] = json.loads(value) if value in (
            "true", "false") else value
    loop = reg.mode(ctx.traffic["mode"]).Loop(ctx)
    loop.setup()
    loop.measure()
    loop.release()
    return loop, loop.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--witness", default="")
    ap.add_argument("--path", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(CHECKOUT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness.registry import Registry
    reg = Registry(HERE, json.loads((CHECKOUT / "BENCHMARK.json")
                                    .read_text()))
    fault = ("half_batch" if reg.traffic(reg.cell(args.workload)["traffic"])
             ["mode"] == "train_loop" else "answer")
    out = open(args.out, "a") if args.out else None
    control, faulty = set(_seeds(args.control)), set(_seeds(args.fault))
    witness = set(_seeds(args.witness))
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        loop, prog = readings(reg, args.workload, seed, args.seconds,
                              "cuda:0", paths=args.path)
        rec = {"cell": args.workload, "seed": seed, "paths": args.path,
               "program": prog}
        if seed in witness:
            from harness.compare import train_numbers
            rec["witness"] = loop.control(torch.float32, torch.bfloat16)
            rec["program_vs_witness"] = train_numbers(loop.prog, loop.low)
        if seed in control:
            rec["control"] = loop.control()
            rec["control_pairs"] = loop.control(
                torch.float32, (torch.float8_e4m3fn, False))
        del loop
        if seed in faulty:
            rec["fault"] = {"kind": fault, "numbers": readings(
                reg, args.workload, seed, args.seconds, "cuda:0",
                fault)[1]}
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
