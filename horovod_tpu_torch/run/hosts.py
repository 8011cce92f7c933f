"""Host-list parsing and slot allocation (port of
``horovod_tpu/run/hosts.py``; reference: horovod/run/gloo_run.py:56-114
``_allocate``): given ``h1:4,h2:2``, every slot gets a global ``rank``, a
``local_rank`` (its index on its host) and a ``cross_rank`` (its host's
index among the hosts that have a slot at that local rank).
``local_size`` is the host's slot count; ``cross_size`` the number of hosts
with at least ``local_rank + 1`` slots.

One slot is one worker process is one GPU (``hvd.init()`` takes
``cuda:<local_rank>``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    def to_env(self) -> dict:
        """The launcher's environment contract with a worker (reference:
        gloo_run.py:211-240), read by ``hvd.init()``
        (``core/basics.py``)."""
        return {
            "HOROVOD_HOSTNAME": self.hostname,
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
        }


_HOST_RE = re.compile(r"^(?P<host>[\w.\-\[\]:]+?)(:(?P<slots>\d+))?$")


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """Parse ``host1:2,host2:4``; a missing slot count means 1 (reference:
    run/run.py host parsing)."""
    infos = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        m = _HOST_RE.match(part)
        if not m:
            raise ValueError(f"bad host specification: {part!r}")
        infos.append(HostInfo(m.group("host"),
                              int(m.group("slots") or 1)))
    if not infos:
        raise ValueError(f"no hosts in specification: {hosts_string!r}")
    return infos


def parse_hostfile(path: str) -> List[HostInfo]:
    """Parse an mpirun-style hostfile: ``hostname slots=N`` per line."""
    infos = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            slots = 1
            for field in fields[1:]:
                if field.startswith("slots="):
                    slots = int(field[len("slots="):])
            infos.append(HostInfo(fields[0], slots))
    if not infos:
        raise ValueError(f"no hosts in hostfile {path}")
    return infos


def allocate(hosts: List[HostInfo], np: int) -> List[SlotInfo]:
    """Assign ``np`` ranks to hosts in order, filling each host's slots
    before moving on (reference: gloo_run.py:56-114)."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested -np {np} exceeds {total} available slots "
            f"({','.join(f'{h.hostname}:{h.slots}' for h in hosts)})")

    # truncated per-host slot usage for exactly np ranks
    used: List[int] = []
    remaining = np
    for h in hosts:
        take = min(h.slots, remaining)
        used.append(take)
        remaining -= take

    slots: List[SlotInfo] = []
    rank = 0
    for host_idx, (h, n) in enumerate(zip(hosts, used)):
        for local_rank in range(n):
            cross_rank = sum(1 for j in range(host_idx)
                             if used[j] > local_rank)
            cross_size = sum(1 for u in used if u > local_rank)
            slots.append(SlotInfo(
                hostname=h.hostname, rank=rank, size=np,
                local_rank=local_rank, local_size=n,
                cross_rank=cross_rank, cross_size=cross_size))
            rank += 1
    return slots
