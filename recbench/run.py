#!/usr/bin/env python3
"""One run of one benchmark cell on one CUDA card.

    python3 recbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``BENCHMARK.json`` → ``recbench/{configs,traffic,limits}``),
sets up the port, warms every shape up, measures for ``--seconds``, checks
the timed path's outputs against the plain reference and prints one JSON
object as the last line of standard output.  Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or if
the JAX package or JAX got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths (the
    # port's own kernels build into build/kernels/ there already)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from recbench import harness

    bench = harness.Benchmark(ROOT)
    if args.workload not in bench.workloads:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(bench.workloads[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = bench.cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    result = harness.run_cell(bench, cell)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
