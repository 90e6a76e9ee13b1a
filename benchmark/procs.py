"""Process lifecycle of a run that starts ranks.

The main process (rank 0) starts every other rank with subprocess.Popen,
each in a process group of its own; nothing here uses multiprocessing, so
no resource tracker or fork server is left behind. Ranks are waited for
with a time limit; on any failure, timeout or signal each rank's group
gets SIGTERM, then SIGKILL, and is waited for. Before a run prints its
last line it looks for living descendants (/proc/<pid>/task/*/children,
recursively) and fails if it finds one.
"""

from __future__ import annotations

import ctypes
import glob
import os
import signal
import socket
import subprocess
import sys
import time

PR_SET_PDEATHSIG = 1


def die_with_parent() -> None:
    """Ask the kernel for SIGKILL when this process's parent dies."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def descendants(pid: int | None = None) -> list:
    """Every living descendant of pid (default: this process)."""
    out, todo = [], [os.getpid() if pid is None else pid]
    while todo:
        p = todo.pop()
        for path in glob.glob(f"/proc/{p}/task/*/children"):
            try:
                with open(path) as f:
                    kids = [int(x) for x in f.read().split()]
            except OSError:
                continue
            for k in kids:
                if k not in out:
                    out.append(k)
                    todo.append(k)
    return out


class Ranks:
    """Ranks 1..world-1 as `python -m <module> <args> <rank>` processes,
    reaped on every exit path of the `with` block."""

    def __init__(self, module: str, args: list, world: int):
        self.procs = []
        self._old = {}
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            self._old[sig] = signal.signal(sig, self._on_signal)
        try:
            for rank in range(1, world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *args, str(rank)],
                    start_new_session=True, stdin=subprocess.DEVNULL))
        except BaseException:
            self.stop()
            raise

    @staticmethod
    def _on_signal(signum, frame):
        raise SystemExit(128 + signum)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def wait(self, timeout: float) -> list:
        """Wait for every rank to exit, at most `timeout` seconds in all;
        raise if one is still running or exited with an error."""
        deadline = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(max(0.1, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank process {p.pid} still running after {timeout:.0f} s")
        if any(codes):
            raise RuntimeError(f"rank processes exited with {codes}")
        return codes

    def failed(self) -> list:
        """Exit codes of ranks that have already exited with an error."""
        return [p.returncode for p in self.procs if p.poll() not in (None, 0)]

    def watch(self, period: float = 1.0) -> None:
        """A daemon thread that ends the run as soon as a rank exits with an
        error: rank 0 may be waiting inside a collective that the dead rank
        will never join, so it stops the other ranks and leaves at once."""
        import threading

        def loop():
            while self.procs:
                codes = self.failed()
                if codes:
                    print(f"benchmark: a rank exited with {codes}; stopping the run",
                          file=sys.stderr, flush=True)
                    for p in self.procs:
                        try:
                            os.killpg(p.pid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
                    for p in self.procs:
                        p.wait()
                    os._exit(5)
                time.sleep(period)

        threading.Thread(target=loop, daemon=True).start()

    def stop(self) -> None:
        """SIGTERM, then SIGKILL, to every rank's process group; wait for
        each. Restores the signal handlers and ends the watch."""
        for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 10.0)):
            live = [p for p in self.procs if p.poll() is None]
            for p in live:
                try:
                    os.killpg(p.pid, sig)
                except ProcessLookupError:
                    pass
            deadline = time.monotonic() + grace
            for p in live:
                try:
                    p.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        for p in self.procs:
            try:  # every group member, also one a rank started itself
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old = {}
        self.procs = []
