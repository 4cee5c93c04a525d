"""Run one cell of the benchmark once, on the card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, each number compared beside its limit;
those numbers are also the last lines of standard error.  Exits non-zero,
printing no result, where there is no card (nothing falls back to the CPU)
or fewer cards than the cell asks for, or where JAX or the JAX package was
loaded in this process.  See ``benchmark/README.md``."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    # every cache of the build stays at a fixed path inside the checkout
    build = CHECKOUT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    sys.path[:0] = [str(HERE), str(CHECKOUT)]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA device(s); {n} found: the "
              "benchmark runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from harness.runner import emit, forbidden_modules, power_limit, run_cell
    result = run_cell(HERE, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the benchmark "
              "measures the PyTorch port alone)", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
