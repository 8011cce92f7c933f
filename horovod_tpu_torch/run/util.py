"""The launcher's process execution: a worker in a session of its own,
its output pumped with a rank prefix, and the whole process tree killed on
teardown (port of ``horovod_tpu/run/util.py``'s ``execute``; reference:
horovod/run/common/util/safe_shell_exec.py). The JAX module's secret, HMAC
wire framing, host hash and timeout served the NIC-discovery ring's
services, which are not ported.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

# ---------------------------------------------------------------------------
# safe shell exec (reference: run/common/util/safe_shell_exec.py:29-57).
# The reference interposes a middleman process that forwards signals and
# kills the whole process tree; on Linux we get the same guarantee with a
# dedicated session (setsid) + killpg.
# ---------------------------------------------------------------------------

GRACEFUL_TERMINATION_TIME_S = 5


def execute(command, env: Optional[dict] = None, stdout=None, stderr=None,
            index: Optional[int] = None, events=None,
            prefix_output: bool = True) -> int:
    """Run ``command`` (shell string) in its own process group, streaming
    output to ``stdout``/``stderr`` (file-like), optionally prefixed with
    ``[index]<tag>`` per line like mpirun --tag-output. ``events`` is a list
    of ``threading.Event``; when any fires, the process tree is terminated
    (SIGTERM, then SIGKILL after a grace period)."""
    proc = subprocess.Popen(
        command, shell=True, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)

    stop = threading.Event()
    watchers = []
    for event in (events or []):
        t = threading.Thread(
            target=_wait_then_kill, args=(event, stop, proc), daemon=True)
        t.start()
        watchers.append(t)

    pumps = []
    for src, dst, tag in ((proc.stdout, stdout or sys.stdout, "stdout"),
                          (proc.stderr, stderr or sys.stderr, "stderr")):
        t = threading.Thread(
            target=_pump, args=(src, dst, index, tag, prefix_output),
            daemon=True)
        t.start()
        pumps.append(t)

    try:
        proc.wait()
    finally:
        stop.set()
    for t in pumps:
        t.join(timeout=5)
    return proc.returncode


def _wait_then_kill(event: threading.Event, stop: threading.Event, proc):
    while not stop.is_set():
        if event.wait(timeout=0.1):
            break
    if stop.is_set() or proc.poll() is not None:
        return
    terminate_tree(proc)


def terminate_tree(proc) -> None:
    """SIGTERM the process group, escalate to SIGKILL after the grace
    period (reference: safe_shell_exec's tree-kill contract)."""
    try:
        pgid = os.getpgid(proc.pid)
    except (ProcessLookupError, PermissionError):
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.monotonic() + GRACEFUL_TERMINATION_TIME_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def _pump(src, dst, index, tag, prefix: bool) -> None:
    try:
        for raw in iter(src.readline, b""):
            line = raw.decode("utf-8", errors="replace")
            if prefix and index is not None:
                line = f"[{index}]<{tag}>: {line}"
            try:
                dst.write(line)
                dst.flush()
            except ValueError:  # closed file
                return
    except Exception:
        pass
