"""The port's launcher, ``tpurun-torch`` (port of ``horovod_tpu/run/``;
reference: horovod/run/): host lists and slots (:mod:`.hosts`), the
flags and config (:mod:`.config_parser`), the ssh fan-out
(:mod:`.backends`), the fan-out with its rendezvous store, postmortem and
supervision (:mod:`.launcher`, :mod:`.rendezvous`) and the CLI
(:mod:`.run`). Not ported: the gcloud TPU-VM backend, and the
NIC-discovery ring (a remote host takes the launcher's address from
``-H``)."""

from horovod_tpu_torch.run.hosts import (HostInfo, SlotInfo, allocate,
                                         parse_hosts)
from horovod_tpu_torch.run.launcher import launch_job
from horovod_tpu_torch.run.rendezvous import KVStoreClient, RendezvousServer
from horovod_tpu_torch.run.run import main, run_commandline

__all__ = [
    "HostInfo", "SlotInfo", "allocate", "parse_hosts",
    "launch_job", "RendezvousServer", "KVStoreClient",
    "run_commandline", "main",
]
