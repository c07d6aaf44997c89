"""The readings that a cell's limits are set from, for several seeds in
one process, at the cell's own size:

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --side program
    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --side control

``program``: per seed, the inputs, the warm items and ``--items`` more
through the timed path, then each number the check compares, of the
last item. ``control``: per seed, the reference in the program's place,
computed in the precision below the one the configuration states
(``items/<item>.control``), judged the same way; it has to fail. One
JSON line a seed, then the largest reading of each number over the
seeds. Needs a card; the benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def readings(cell: dict, seed: int, side: str, items: int, device) -> dict:
    """Each number the check compares, for one seed."""
    import torch

    dataset, item = harness.load_module(cell["dataset"]), harness.load_module(cell["item"])
    st = item.prepare(cell["cfg"], cell["mix"], dataset.make(cell["cfg"], seed % 2**63, device),
                      device)
    spans = harness.Spans(device)
    if side == "program":
        out = None
        for _ in range(harness.WARM_ITEMS + items):
            out = None
            out = item.step(st, spans)
            spans.sync()
        ans = item.answers(st, out)
        del out
    else:
        ans = item.control(st)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return item.judge(st, ans, [])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--items", type=int, default=1)
    args = ap.parse_args(argv)
    cell = harness.resolve(json.loads((harness.ROOT / "BENCHMARK.json").read_text()), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.TORCH_THREADS)
    worst = {}
    for s in args.seeds.split(","):
        t = time.perf_counter()
        got = readings(cell, int(s), args.side, args.items, torch.device("cuda", 0))
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
        print(json.dumps({"seed": int(s), "side": args.side, "seconds": time.perf_counter() - t,
                          "readings": got}), flush=True)
    print(json.dumps({"side": args.side, "seeds": len(args.seeds.split(",")), "largest": worst,
                      "limits": cell["limits"], "process_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    harness.set_cache_dirs()
    sys.exit(main(sys.argv[1:]))
