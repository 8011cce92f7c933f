"""The ssh fan-out (port of ``horovod_tpu/run/backends.py``'s
``SSHBackend``; reference: horovod/run/gloo_run.py:211-301).

``command_for_slot`` turns (slot, command, worker environment) into the
shell command the launcher runs on its own host; ``launch_job`` runs what
comes back through the same supervision (output prefixes, teardown on
failure). The JAX package's ``GCloudTPUVMBackend`` fans out over ``gcloud
compute tpus tpu-vm ssh``, which only a TPU VM has: not ported, by
decision, and with ssh the only fan-out there is no backend to select.
"""

from __future__ import annotations

import os
import shlex
from typing import Dict, Optional

from horovod_tpu_torch.run.hosts import SlotInfo

# environment prefixes exported across the remote boundary (ssh does not
# forward the environment)
_EXPORT_PREFIXES = ("HOROVOD_", "CUDA_", "NCCL_", "TORCH_", "PATH",
                    "PYTHONPATH", "LD_LIBRARY_PATH")


def _export_prefix(env: Dict[str, str]) -> str:
    return " ".join(
        f"export {k}={shlex.quote(v)};" for k, v in sorted(env.items())
        if k.startswith(_EXPORT_PREFIXES))


def _remote_command(command: str, env: Dict[str, str]) -> str:
    """The shell line run on the far side: enter the launcher's working
    directory, export the listed environment, run."""
    return (f"cd {shlex.quote(os.getcwd())} > /dev/null 2>&1; "
            f"{_export_prefix(env)} {command}")


def command_for_slot(slot: SlotInfo, command: str, env: Dict[str, str],
                     ssh_port: Optional[int] = None) -> str:
    """The command itself for a local host (the worker environment goes to
    the spawned process), ssh with the exported environment otherwise."""
    from horovod_tpu_torch.run.launcher import is_local_host

    if is_local_host(slot.hostname):
        return command
    port_arg = f"-p {ssh_port} " if ssh_port else ""
    return (f"ssh -o PasswordAuthentication=no "
            f"-o StrictHostKeyChecking=no "
            f"{port_arg}{slot.hostname} "
            f"{shlex.quote(_remote_command(command, env))}")
