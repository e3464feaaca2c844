"""Process-group bootstrap for data parallelism (counterpart of
`strainer_gan_tpu/parallel/multihost.py`).

``initialize`` joins the ``torch.distributed`` process group a launcher
describes: ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` (and ``LOCAL_RANK``), or the JAX package's names
``COORDINATOR_ADDRESS`` (``host:port``) / ``NUM_PROCESSES`` /
``PROCESS_ID``.  Without either it does nothing, and the run has no group.
On the card each rank takes ``cuda:LOCAL_RANK`` and the group speaks NCCL;
on the CPU (``device="cpu"``) it speaks gloo.  It is idempotent, as
``jax.distributed.initialize``'s wrapper is.  Every collective of the group
times out after ``timeout_s`` seconds, so a rank that never arrives fails
the run instead of hanging it.

``host_count`` is the counterpart of ``jax.process_count()``: the JAX
package runs one process a host, the port one rank a card, so it counts
hosts, ``world // LOCAL_WORLD_SIZE`` (``torchrun`` sets
``LOCAL_WORLD_SIZE``; without it every rank is on one host).  A run over
more than one host stages each rank's sample shard only
(``shard_bounds``, ``data.pipeline.DeviceDataset.from_rank_local``).

``Rendezvous`` is the launcher's side, and the only way the port starts
ranks itself (``cli.spawn`` behind ``--dp N``, the tests' spawned ranks,
``chip_smoke.py``'s ``dp`` child): it hosts the group's ``TCPStore`` on a
port the OS picks and holds it until the ranks are done, and gives each
rank a launcher's environment in which ``initialize`` joins that store as
a client (``TORCHELASTIC_USE_AGENT_STORE=True``, as ``torchrun``'s agent
store does).  A port picked by binding port 0 and closing the socket
again would be free for any other process until rank 0 bound it: another
group handed the same port joins this group's store, and the two groups
cross-wire, fail to bind or time out.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300
AGENT_STORE = "TORCHELASTIC_USE_AGENT_STORE"  # torch's rendezvous: every rank a store client
LOOPBACK = "127.0.0.1"  # a Rendezvous's ranks all run on the launcher's host


def _launcher_env() -> Optional[dict]:
    """The launcher's description of this process, or None."""
    e = os.environ
    if "WORLD_SIZE" in e and "RANK" in e:
        world = int(e["WORLD_SIZE"])
        return dict(addr=e.get("MASTER_ADDR", "127.0.0.1"), port=e.get("MASTER_PORT", "29500"),
                    world=world, rank=int(e["RANK"]),
                    local=int(e.get("LOCAL_RANK", e["RANK"])),
                    local_world=int(e.get("LOCAL_WORLD_SIZE", world)))
    if "COORDINATOR_ADDRESS" in e:
        addr, _, port = e["COORDINATOR_ADDRESS"].rpartition(":")
        rank, world = int(e.get("PROCESS_ID", 0)), int(e.get("NUM_PROCESSES", 1))
        return dict(addr=addr, port=port, world=world, rank=rank,
                    local=int(e.get("LOCAL_RANK", rank)),
                    local_world=int(e.get("LOCAL_WORLD_SIZE", world)))
    return None


class Rendezvous:
    """A group's store, hosted by the launcher on a port the OS picks and
    held from the pick until ``close`` (or the end of the ``with`` block):
    no other process can bind the port meanwhile, and only the ranks given
    ``env`` join it.  Close it once the ranks have left the group, which
    uses the store while it lives (``new_group``, NCCL's first
    communicator)."""

    def __init__(self, world: int):
        self.world = world
        self.store = dist.TCPStore(LOOPBACK, 0, is_master=True, wait_for_workers=False,
                                   timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        self.port = self.store.port

    def env(self, rank: int, local_world: Optional[int] = None) -> dict:
        """Rank ``rank``'s launcher environment; ``local_world`` ranks a host
        (by default all of them on this one)."""
        local_world = self.world if local_world is None else local_world
        return {"RANK": str(rank), "LOCAL_RANK": str(rank % local_world),
                "WORLD_SIZE": str(self.world), "LOCAL_WORLD_SIZE": str(local_world),
                "MASTER_ADDR": LOOPBACK, "MASTER_PORT": str(self.port), AGENT_STORE: "True"}

    def close(self) -> None:
        self.store = None  # the store's server stops and the port is free again

    def __enter__(self) -> "Rendezvous":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launched() -> bool:
    """Whether a launcher described a process group to this process."""
    return _launcher_env() is not None


def initialize(device: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the launcher's process group (``device``: "cpu" for gloo, else
    the card and NCCL); returns whether a group is initialised.  Under
    ``TORCHELASTIC_USE_AGENT_STORE=True`` (``Rendezvous.env``, ``torchrun``)
    every rank joins the launcher's store; otherwise rank 0 hosts it on
    ``MASTER_PORT``."""
    if dist.is_initialized():
        return True
    env = _launcher_env()
    if env is None:
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(env["local"])
    dist.init_process_group(
        backend="gloo" if cpu else "nccl", init_method=f"tcp://{env['addr']}:{env['port']}",
        world_size=env["world"], rank=env["rank"],
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=None if cpu else torch.device("cuda", env["local"]))
    return True


def grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if grouped() else 1


def rank() -> int:
    return dist.get_rank() if grouped() else 0


def host_count() -> int:
    """Hosts in the group: ``world // LOCAL_WORLD_SIZE`` (1 without a group,
    or without ``LOCAL_WORLD_SIZE``)."""
    env = _launcher_env()
    if not grouped() or env is None:
        return 1
    return max(1, world() // max(1, env["local_world"]))


def shard_bounds(n: int, rank: int, world: int):
    """(lo, hi, n_trimmed): rank ``rank``'s contiguous rows of ``n`` samples
    trimmed to equal shards, as `strainer_gan_tpu/train/loop.py:188-191`
    cuts them: ``n = (n // P) * P``, rows ``[pid * n // P, (pid + 1) * n // P)``."""
    n = (n // world) * world
    return rank * n // world, (rank + 1) * n // world, n


def is_primary() -> bool:
    return rank() == 0


def rank_device(device=None) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` under a card group, else
    ``device`` as given (None is the card)."""
    if grouped() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda" if device is None else device)


def shutdown() -> None:
    if grouped():
        dist.destroy_process_group()
