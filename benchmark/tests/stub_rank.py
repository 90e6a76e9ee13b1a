"""A stand-in rank body for the lifecycle tests: joins a gloo group, then
exits, raises or hangs as told.

    python3 -m benchmark.tests.stub_rank <ok|raise|hang|sigterm|raise_in_collective> <token> <port> <world> <rank>
"""

import datetime
import sys
import time


def main(argv) -> int:
    from benchmark import procs

    procs.die_with_parent()
    import torch.distributed as dist

    behaviour, _token, port, world, rank = argv[0], argv[1], int(argv[2]), int(argv[3]), int(argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    last = rank == world - 1
    if behaviour in ("raise", "raise_in_collective") and last:
        raise RuntimeError("a rank fails")
    if behaviour in ("hang", "sigterm") and last:
        time.sleep(3600)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
