"""The launcher of the port's spawned-rank tests (it holds no test of its own).

``Ranks(target, world, tmp, tag, args)`` starts ``world`` spawned
processes under one ``parallel.multihost.Rendezvous``: the store this
process hosts on a port no other process can take, held until the ranks
are joined.  Rank ``r`` gets the rendezvous's launcher environment and runs
``target(r, *args)``; ``target`` joins the group with
``multihost.initialize``.

Every rank writes what a failure needs to ``rank_<tag>_<r>.log`` in
``tmp``: its traceback when it raises, the stacks of all its threads when
it dies of a fatal signal, and, when it is still running at the join
limit, the stacks the launcher asks for (SIGUSR1) before it kills the
rank.  ``Ranks.join`` fails with every rank's exit reason and the end of
its log, so that a failure in a test log names its cause.
"""
from __future__ import annotations

import faulthandler
import multiprocessing as mp
import os
import signal
import time
import traceback
from pathlib import Path

from strainer_gan_tpu_torch.parallel.multihost import Rendezvous

LOG_TAIL = 4000  # characters of each failed rank's log in the failure message


def _log(tmp, tag: str, rank: int) -> Path:
    return Path(tmp) / f"rank_{tag}_{rank}.log"


def rank_main(target, tmp: str, tag: str, rank: int, env: dict, args: tuple) -> None:
    """One spawned rank: the launcher's environment, then ``target(rank,
    *args)``, with its traceback or stacks in its log."""
    os.environ.update(env)
    with open(_log(tmp, tag, rank), "w") as log:
        faulthandler.enable(log, all_threads=True)
        faulthandler.register(signal.SIGUSR1, log, all_threads=True)
        try:
            target(rank, *args)
        except BaseException:
            log.write(f"rank {rank} raised:\n")
            traceback.print_exc(file=log)
            raise


class Ranks:
    """``world`` started ranks of ``target`` and the rendezvous they share."""

    def __init__(self, target, world: int, tmp, tag: str, args=(), local_world=None):
        self.tmp, self.tag, self.t0 = Path(tmp), tag, time.monotonic()
        self.rdv = Rendezvous(world)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=rank_main, args=(
            target, str(tmp), tag, r, self.rdv.env(r, local_world), tuple(args)))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self, limit_s: float) -> None:
        """Wait until ``limit_s`` seconds after the start; then ask every rank
        still running for its stacks, kill it, close the rendezvous and fail
        unless every rank exited 0."""
        for p in self.procs:
            p.join(max(0.1, self.t0 + limit_s - time.monotonic()))
        hung = [p.is_alive() for p in self.procs]
        for p, h in zip(self.procs, hung):
            if h:
                os.kill(p.pid, signal.SIGUSR1)
        if any(hung):
            time.sleep(1.0)  # the stacks reach the logs
        for p, h in zip(self.procs, hung):
            if h:
                p.kill()
                p.join()
        self.rdv.close()
        assert not any(hung) and all(p.exitcode == 0 for p in self.procs), \
            self.report(hung, limit_s)

    def report(self, hung, limit_s: float) -> str:
        """Each rank's exit reason and its log's last line, then each log's
        end."""
        heads, tails = [], []
        for r, (p, h) in enumerate(zip(self.procs, hung)):
            code = p.exitcode
            why = (f"still running at the {limit_s:.0f} s join limit, killed" if h
                   else f"killed by {signal.Signals(-code).name}" if code < 0
                   else f"exit code {code}")
            log = _log(self.tmp, self.tag, r)
            text = log.read_text() if log.exists() else ""
            last = text.strip().splitlines()[-1:] or ["(nothing logged)"]
            heads.append(f"rank {r}: {why}: {last[0]}")
            if text:
                tails.append(f"--- rank {r}'s log:\n{text[-LOG_TAIL:]}")
        return "\n".join([f"ranks of {self.tag!r} (rendezvous port {self.rdv.port}) failed:",
                          *heads, *tails])


def run(target, world: int, tmp, tag: str, limit_s: float, args=()) -> None:
    """Start the ranks and join them."""
    Ranks(target, world, tmp, tag, args).join(limit_s)

