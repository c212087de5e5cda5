"""Run one cell of the port's benchmark on the card it is started on.

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison with the
plain reference gives, beside its limit. The same checks are the last lines
on standard error. Exits non-zero, and prints no result, without a CUDA
card, with fewer cards than the cell asks for, or when JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # one process with one host thread: the cells are bound by the host's
    # launches, and a pool of threads only adds contention for its cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("cudabench: torch.cuda.is_available() is false; the benchmark "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    from cudabench import harness
    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"cudabench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T0)
    found = harness.banned_modules()
    if found:
        print(f"cudabench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
