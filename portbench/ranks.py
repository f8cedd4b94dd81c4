"""Cells of several ranks: one process a card, started as torchrun starts
them, and ended together.

``launch`` starts ``world`` processes of one command, each in torchrun's
environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``; ``OMP_NUM_THREADS`` the
rank's share of the cores), and waits for them. If
a rank exits with a code other than 0, or the ranks pass ``timeout_s``,
every rank still running is killed and waited for; otherwise every rank has
ended by itself. Each rank's standard output and error go to unnamed
temporary files (the run's ``TMPDIR``), which are read back and closed.

A rank's process runs the same entry point as the one that launched it;
``rank()`` tells it which it is.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
POLL_S = 0.1


@dataclasses.dataclass
class Ended:
    returncodes: List[int]             # each rank's exit code, -9 where it was killed
    stdout: List[str]
    stderr: List[str]
    reason: str                         # "" when every rank exited with 0

    @property
    def ok(self) -> bool:
        return not self.reason


def rank() -> Optional[int]:
    """This process's rank when a launcher started it, else None."""
    return int(os.environ["RANK"]) if "RANK" in os.environ else None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(base: Dict[str, str], r: int, world: int, port: int) -> Dict[str, str]:
    """torchrun's variables, and, unless set, each rank's share of this
    process's cores as its intra-op threads (``OMP_NUM_THREADS``): left at
    the default, each rank would start a thread a core, and their spinning
    takes the cores that the other ranks' hosts issue their steps on."""
    env = {k: v for k, v in base.items() if k not in ENV}
    env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env.setdefault("OMP_NUM_THREADS", str(max(1, len(os.sched_getaffinity(0)) // world)))
    return env


def launch(command: Sequence[str], world: int, timeout_s: float,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> Ended:
    """Run ``command`` as ``world`` ranks and wait for all of them (see the
    module's note). SIGTERM to this process kills the ranks too."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    outs = [tempfile.TemporaryFile() for _ in range(world)]
    errs = [tempfile.TemporaryFile() for _ in range(world)]
    procs: List[subprocess.Popen] = []
    previous = signal.getsignal(signal.SIGTERM)

    def terminated(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, terminated)
    reason = ""
    try:
        for r in range(world):
            procs.append(subprocess.Popen(list(command), env=rank_env(base, r, world, port),
                                          cwd=cwd, stdin=subprocess.DEVNULL, stdout=outs[r],
                                          stderr=errs[r]))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                reason = f"rank {failed[0]} exited with {codes[failed[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() >= deadline:
                reason = (f"ranks {[r for r, c in enumerate(codes) if c is None]} still "
                          f"running after {timeout_s:g} s")
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        signal.signal(signal.SIGTERM, previous)
        texts = [[_read(f) for f in files] for files in (outs, errs)]
    return Ended([p.returncode for p in procs], texts[0], texts[1], reason)


def _read(f) -> str:
    with f:
        f.seek(0)
        return f.read().decode(errors="replace")
