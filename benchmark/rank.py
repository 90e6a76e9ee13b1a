"""A rank other than 0 of a cell on several cards (started by run.py).

    python3 -m benchmark.rank <cell> <seed> <port> <world> <cuda|cpu> <rank>

It dies with its parent (PR_SET_PDEATHSIG), joins the group at
tcp://127.0.0.1:<port> on card <rank>, sets up as rank 0 does, renders
every image rank 0 announces, reports its peak memory, passes a last
barrier, leaves the group and exits.
"""

from __future__ import annotations

import sys


def main(argv) -> int:
    from benchmark import procs

    procs.die_with_parent()
    from benchmark import run

    run.environment()
    cell_name, seed, port, world = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    kind, rank = argv[4], int(argv[5])
    import torch

    from benchmark import cells, session
    from cs397raytracingsp22_tpu_torch.parallel import multihost, sharding

    cell = cells.load_cell(cell_name)
    device = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, device=device)
    sess = session.Session(cell, device, sharding.make_device_mesh(*cell.mesh))
    sess.setup(seed)
    session.follow(sess, seed)
    sess.peaks()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
