"""The port's rank rendezvous (``parallel.multihost.Rendezvous``) and the
spawned-rank launcher of the tests (tests/test_torch_ranks.py), on the CPU
with gloo and one torch thread a rank.

* The port a rendezvous announces is held: no other socket can bind it
  before the ranks join, and it is free again once the rendezvous closes.
  This is the guard against the race the rendezvous closes (a port picked
  by binding port 0 and releasing it, free for another group until rank 0
  bound it again).
* A rank's environment makes ``multihost.initialize`` join the launcher's
  store as a client (``TORCHELASTIC_USE_AGENT_STORE=True``).
* Two 2-rank groups started at the same time each all-gather their own
  group's token and never the other's: a check that each group's ranks
  reach only their own store, not of the race (two rendezvous hold two
  ports, so the groups are apart by construction).
* A rank that raises, and one still running at the join limit, fail the
  launch with the rank's traceback or stacks in the assertion text.
"""
import json
import os
import socket
import time

import pytest
import torch

from strainer_gan_tpu_torch.parallel import multihost as MH

import test_torch_ranks as R

JOIN_S = 60
TIMEOUT_S = 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gather_token(rank: int, tmp: str, token: str) -> None:
    """Join the group, all-gather ``token`` and save what every rank sent."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert MH.initialize("cpu", timeout_s=TIMEOUT_S)
    try:
        seen = [None] * MH.world()
        dist.all_gather_object(seen, f"{token}:{rank}")
        with open(f"{tmp}/seen_{token}_{rank}.json", "w") as f:
            json.dump(dict(seen=seen, port=int(os.environ["MASTER_PORT"])), f)
    finally:
        MH.shutdown()


def raise_on_rank_1(rank: int) -> None:
    if rank == 1:
        raise ValueError("a deliberate failure of rank 1")


def sleep_long(rank: int, ready: str) -> None:
    open(ready, "w").close()
    time.sleep(60)


def test_announced_port_is_held():
    rdv = MH.Rendezvous(2)
    port = rdv.port
    with socket.socket() as s, pytest.raises(OSError):
        s.bind(("127.0.0.1", port))
    with socket.socket() as s, pytest.raises(OSError):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", port))
    rdv.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def test_rank_environment_joins_the_launchers_store():
    with MH.Rendezvous(3) as rdv:
        env = rdv.env(2, local_world=1)
        assert env == {"RANK": "2", "LOCAL_RANK": "0", "WORLD_SIZE": "3",
                       "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(rdv.port), MH.AGENT_STORE: "True"}
        assert rdv.env(1)["LOCAL_RANK"] == "1" and rdv.env(1)["LOCAL_WORLD_SIZE"] == "3"
        rdv.store.set("launcher", "here")
        client = torch.distributed.TCPStore("127.0.0.1", rdv.port, is_master=False)
        assert client.get("launcher") == b"here"


def test_concurrent_groups_stay_apart(tmp_path):
    """Each group's ranks join their own launcher's store and gather only
    their own tokens (isolation on the new path; the race itself is guarded
    by ``test_announced_port_is_held``)."""
    groups = {token: R.Ranks(gather_token, 2, tmp_path, token, args=(str(tmp_path), token))
              for token in ("a", "b")}
    ports = {token: ranks.rdv.port for token, ranks in groups.items()}
    assert ports["a"] != ports["b"]
    for ranks in groups.values():
        ranks.join(JOIN_S)
    for token in groups:
        for rank in range(2):
            got = json.loads((tmp_path / f"seen_{token}_{rank}.json").read_text())
            assert got == dict(seen=[f"{token}:0", f"{token}:1"], port=ports[token])


def test_failed_rank_names_its_cause(tmp_path):
    with pytest.raises(AssertionError) as err:
        R.run(raise_on_rank_1, 2, tmp_path, "raise", JOIN_S)
    text = str(err.value)
    assert "rank 0: exit code 0: (nothing logged)" in text
    assert "rank 1: exit code 1: ValueError: a deliberate failure of rank 1" in text
    assert "in raise_on_rank_1" in text


def test_hung_rank_shows_its_stacks(tmp_path):
    ready = tmp_path / "ready"
    ranks = R.Ranks(sleep_long, 1, tmp_path, "hang", args=(str(ready),))
    deadline = time.monotonic() + JOIN_S
    while not ready.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    with pytest.raises(AssertionError) as err:
        ranks.join(0)  # the limit has passed: the rank is still asleep
    text = str(err.value)
    assert "rank 0: still running at the 0 s join limit, killed" in text
    assert "in sleep_long" in text and "Current thread" in text
