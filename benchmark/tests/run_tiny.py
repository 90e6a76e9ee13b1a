"""One run of a cell on the CPU, past the harness's look for a card (for
the tests): prints {"correct", "compared"} as its last line.

    python3 -m benchmark.tests.run_tiny <cell> <seed> <seconds>
"""

import argparse
import json
import sys


def main(argv) -> int:
    import torch

    from benchmark import cells, run

    cell = cells.load_cell(argv[0])
    args = argparse.Namespace(workload=argv[0], seed=int(argv[1]), seconds=float(argv[2]), trace=0)
    if cell.mesh is None:
        rec = run.run(cell, args, torch.device("cpu"))
    else:
        rec = run.run_mesh(cell, args, "cpu")
    from benchmark import procs

    print(json.dumps({"correct": rec["correct"], "compared": rec["compared"],
                      "images": rec["images"], "left": procs.descendants()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
