"""Start a group of rank processes on this host and wait for them, with
one timeout for the group: a rank that fails, or a group that runs out of
time, ends every rank, so a rank left waiting in a collective cannot hang
its caller."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Mapping, Sequence


class RanksFailed(RuntimeError):
    pass


def python_argv(module: str, *args: str) -> List[str]:
    """`python -m module args` with this interpreter."""
    return [sys.executable, "-m", module, *args]


def run_ranks(argvs: Sequence[Sequence[str]], timeout: float,
              rank_env: Sequence[Mapping[str, str]] = ()) -> List[str]:
    """Run one process per argv (rank order), with this package's checkout
    on PYTHONPATH, and return each one's output (stdout and stderr
    together); `rank_env[r]`, if given, adds to rank r's environment.
    Raises RanksFailed, after killing every
    rank still running, when one exits non-zero or when `timeout` seconds
    pass; its message holds the tail of each rank's output."""
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    # the package's checkout, importable whatever the caller's directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(len(argvs))]
        extra = list(rank_env) or [{}] * len(argvs)
        procs = [subprocess.Popen(list(a), stdout=f, stderr=subprocess.STDOUT,
                                  env={**env, **x})
                 for a, f, x in zip(argvs, logs, extra)]
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"the ranks did not finish within {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        failed = failed or f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                          f"{out[-3000:]}"
                          for r, (p, out) in enumerate(zip(procs, outs)))
        raise RanksFailed(f"{failed}\n{tails}")
    return outs
