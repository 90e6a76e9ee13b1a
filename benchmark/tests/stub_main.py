"""The main process of a lifecycle test: starts world - 1 stub ranks through
benchmark.procs.Ranks, joins the group as rank 0, prints the ranks' pids,
waits for them at most `limit` seconds and exits 0 only if every rank did.

    python3 -m benchmark.tests.stub_main <ok|raise|hang|sigterm|raise_in_collective> <token> <world> <limit>
"""

import datetime
import json
import sys
import time


def main(argv) -> int:
    import torch.distributed as dist

    from benchmark import procs

    behaviour, token, world, limit = argv[0], argv[1], int(argv[2]), float(argv[3])
    port = procs.free_port()
    with procs.Ranks("benchmark.tests.stub_rank", [behaviour, token, str(port), str(world)],
                     world) as ranks:
        print(json.dumps([p.pid for p in ranks.procs]), flush=True)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=0, timeout=datetime.timedelta(seconds=60))
        if behaviour == "raise_in_collective":
            ranks.watch(0.2)
            time.sleep(60)  # as in a collective the failed rank never joins
            raise RuntimeError("the watch did not end the run")
        if world == 1 and behaviour == "raise":
            raise RuntimeError("rank 0 fails")
        if world == 1 and behaviour in ("hang", "sigterm"):
            time.sleep(limit if behaviour == "hang" else 3600)
            raise RuntimeError("rank 0 hung past its limit")
        ranks.wait(limit)
        dist.destroy_process_group()
    left = procs.descendants()
    print(json.dumps({"left": left}), flush=True)
    return 1 if left else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
