"""The readings a cell's limits are set from, on the card, in one process.

    python3 cudabench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--ref-blocks 32]

For each of ``--seeds``: the cell's inputs from the seed, its warm-up, a
window of ``--seconds`` at the cell's own load, and the comparison of what
the window produced with the reference: the program's readings (the lower
ones). For each of ``--control-seeds`` the same, with the reference in the
nearest precision below the configuration's in the program's place (the
traffic's kind of work names it: bfloat16 stage images and templates for the
enrolment chain, bfloat16 coordinates and distances for the matcher): the control's readings (the
upper ones). With ``--ref-blocks`` an enrolment cell's program readings are
also taken against the reference run that many frames at a time, where
the plain reductions add in another order (``numbers_by_block``). One JSON
line a seed on standard output. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CONTROLS = {"enrol": "bf16", "identify": "bf16", "all_pairs": "bf16"}


def readings(cell, seed: int, seconds: float, device, control=None,
             blocks=()) -> dict:
    """The numbers of one seed: the program's, or with ``control`` the
    control's, and the seconds each phase took; for each of ``blocks`` the
    program's against the reference run that many frames at a time."""
    import torch
    from cudabench import harness
    from cudabench.tracing import Spans
    mod = harness.kind_module(cell)
    t0 = time.perf_counter()
    drv = mod.Work(cell.config, cell.traffic, seed, device, mod.program())
    drv.warm_up()
    t1 = time.perf_counter()
    drv.window(seconds, Spans(device, sync=False))
    t2 = time.perf_counter()
    drv.release()
    numbers = drv.compare(control)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    out = {"seed": seed, "control": control, "numbers": numbers,
           "seconds": {"setup": t1 - t0, "window": t2 - t1,
                       "compare": t3 - t2}}
    if blocks and control is None:
        out["numbers_by_block"] = {b: drv.compare(block=b) for b in blocks}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--ref-blocks", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from cudabench import harness
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    control = CONTROLS[cell.traffic["kind"]]
    seeds = [(int(s), None) for s in args.seeds.split(",") if s]
    seeds += [(int(s), control) for s in args.control_seeds.split(",") if s]
    blocks = [int(b) for b in args.ref_blocks.split(",") if b]
    for seed, ctl in seeds:
        print(json.dumps({"cell": cell.name, **readings(cell, seed, args.seconds,
                                                         dev, ctl, blocks)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
