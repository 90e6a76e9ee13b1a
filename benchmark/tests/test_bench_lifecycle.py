"""Every process a run starts is reaped: a one-rank and a four-rank launch
of stub gloo ranks through benchmark.procs, ending normally, with a rank
raising, with a rank hanging past its limit, and with SIGTERM to the main
process. After each, none of the run's processes is alive."""

import json
import os
import signal
import subprocess
import sys
import time
import uuid

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _alive_with(token: str) -> list:
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if token.encode() in cmd and state != "Z":
            out.append(int(pid))
    return out


def _gone(token: str, timeout: float = 10.0) -> list:
    deadline = time.monotonic() + timeout
    while True:
        left = _alive_with(token)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.1)


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("behaviour,code", [("ok", 0), ("raise", 1), ("hang", 1),
                                            ("sigterm", 128 + signal.SIGTERM)])
def test_ranks_are_reaped(world, behaviour, code):
    token = uuid.uuid4().hex
    main = subprocess.Popen([sys.executable, "-m", "benchmark.tests.stub_main", behaviour, token,
                             str(world), "4"], cwd=ROOT, stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        pids = json.loads(main.stdout.readline())
        assert len(pids) == world - 1
        if behaviour == "sigterm":
            time.sleep(3.0)  # the group is up and the last rank sleeps
            main.send_signal(signal.SIGTERM)
        rc = main.wait(120)
    finally:
        if main.poll() is None:
            os.killpg(main.pid, signal.SIGKILL)
            main.wait(10)
    assert rc == code
    assert _gone(token) == []
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}") or _state(pid) == "Z"


def test_a_rank_dying_ends_a_run_waiting_in_a_collective():
    token = uuid.uuid4().hex
    main = subprocess.Popen([sys.executable, "-m", "benchmark.tests.stub_main",
                             "raise_in_collective", token, "4", "4"], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        pids = json.loads(main.stdout.readline())
        rc = main.wait(120)
    finally:
        if main.poll() is None:
            os.killpg(main.pid, signal.SIGKILL)
            main.wait(10)
    assert rc == 5
    assert _gone(token) == []
    assert all(_state(pid) in ("gone", "Z") for pid in pids)


def _state(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return "gone"


def test_descendants_sees_a_child():
    from benchmark import procs

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        assert child.pid in procs.descendants()
    finally:
        child.kill()
        child.wait(10)
    assert child.pid not in procs.descendants()
