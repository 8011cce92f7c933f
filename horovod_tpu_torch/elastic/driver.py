"""The launcher-side membership driver (port of
``horovod_tpu/elastic/driver.py``; reference: horovod/run/elastic/
driver.py): a thread beside the rendezvous server that

* runs a host-discovery script (stdout: one ``hostname[:slots]`` a line,
  the reference's contract) every ``HOROVOD_ELASTIC_DISCOVERY_INTERVAL_
  SECONDS`` and diffs the host sets,
* reads the workers' heartbeats in the server's ``heartbeat`` scope (a
  beat older than the TTL is a lost worker),
* publishes a host-change notice under ``elastic.notice/update``, which
  the workers see at their next commit
  (:func:`horovod_tpu_torch.elastic.runner.check_host_updates`) and answer
  with a re-form.

It never kills or starts a worker: the workers' re-form owns membership,
so the job survives losing the driver. Each notice it publishes is an
``elastic_notice`` flight event in the launcher's ring. The launcher flag that starts it is
ROADMAP A13's.
"""

from __future__ import annotations

import json
import shlex
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import (
    HOROVOD_ELASTIC_DISCOVERY_INTERVAL_SECONDS, _get_float)

_WORKERS_ADDED = _metrics().counter(
    "horovod_elastic_workers_added_total",
    "Hosts added to the job by the discovery script.")
_WORKERS_REMOVED = _metrics().counter(
    "horovod_elastic_workers_removed_total",
    "Workers lost across elastic re-forms, as seen by this process.")


class HostDiscoveryScript:
    """Run the user's discovery script; parse ``hostname[:slots]`` lines
    (reference: horovod/run/elastic/discovery.py HostDiscoveryScript)."""

    def __init__(self, script: str, default_slots: int = 1):
        from horovod_tpu_torch.utils import resilience

        self.script = script
        self.default_slots = default_slots
        # a flaky discovery script (NFS blip, transient fork failure) must
        # not make the driver report an empty host set and trigger a
        # spurious re-form — retry briefly before surfacing the error
        self._retry = resilience.RetryPolicy.from_env(
            "driver", max_retries=2, deadline=30.0)

    def find_available_hosts(self) -> Dict[str, int]:
        out = self._retry.call(
            self._run_script, phase="discovery",
            classify=lambda e: isinstance(
                e, (subprocess.SubprocessError, OSError)))
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                hosts[line] = self.default_slots
        return hosts

    def _run_script(self) -> str:
        return subprocess.run(
            shlex.split(self.script), capture_output=True, text=True,
            timeout=60, check=True).stdout


class ElasticDriver:
    """Membership observer thread. ``rendezvous`` is the launcher's
    :class:`~horovod_tpu_torch.run.rendezvous.RendezvousServer`."""

    def __init__(self, rendezvous, discovery: Optional[HostDiscoveryScript]
                 = None, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 discovery_interval: Optional[float] = None,
                 heartbeat_ttl: Optional[float] = None):
        self._rendezvous = rendezvous
        self._discovery = discovery
        self.min_workers = min_workers
        self.max_workers = max_workers
        self._interval = (discovery_interval if discovery_interval is not None
                          else _get_float(
                              HOROVOD_ELASTIC_DISCOVERY_INTERVAL_SECONDS, 2.0))
        self._heartbeat_ttl = heartbeat_ttl
        self._hosts: Dict[str, int] = {}
        self._live_workers: set = set()
        self._notice_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- membership math (unit-tested directly) ----------------------------
    @staticmethod
    def diff_hosts(old: Dict[str, int], new: Dict[str, int]
                   ) -> Tuple[List[str], List[str]]:
        """(added, removed) hostnames between two discovery snapshots —
        a slot-count change counts as removed+added (the worker layout on
        that host must be rebuilt)."""
        added = sorted(h for h in new if old.get(h) != new[h])
        removed = sorted(h for h in old if new.get(h) != old[h])
        return added, removed

    def current_hosts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hosts)

    def start(self) -> None:
        if self._discovery is not None:
            try:
                self._hosts = self._discovery.find_available_hosts()
            except Exception as exc:
                log.warning("elastic driver: initial host discovery "
                            "failed: %s", exc)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-elastic-driver")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._poll_once()
            except Exception as exc:
                log.warning("elastic driver poll failed: %s", exc)

    def _poll_once(self) -> None:
        changed: List[str] = []
        if self._discovery is not None:
            new_hosts = self._discovery.find_available_hosts()
            with self._lock:
                added, removed = self.diff_hosts(self._hosts, new_hosts)
                self._hosts = new_hosts
            if added:
                _WORKERS_ADDED.inc(len(added))
                changed.append(f"hosts added: {','.join(added)}")
            if removed:
                _WORKERS_REMOVED.inc(len(removed))
                changed.append(f"hosts removed: {','.join(removed)}")

        lost = self._check_heartbeats()
        if lost:
            changed.append(f"heartbeats lost: {','.join(sorted(lost))}")

        if changed:
            notice = "; ".join(changed)
            log.warning("elastic driver: %s", notice)
            self._publish_notice(notice)

    def _check_heartbeats(self) -> set:
        live = set(self._rendezvous.live_keys(
            "heartbeat", ttl=self._heartbeat_ttl))
        with self._lock:
            lost = self._live_workers - live
            self._live_workers = self._live_workers | live
            # a lost worker stays lost until it beats again
            self._live_workers -= lost
        if lost:
            _WORKERS_REMOVED.inc(len(lost))
        return lost

    def _publish_notice(self, notice: str) -> None:
        self._notice_seq += 1
        flight_recorder.emit("elastic_notice", seq=self._notice_seq,
                             notice=notice[:200])
        self._rendezvous.put(
            "elastic.notice", "update",
            json.dumps({"seq": self._notice_seq, "notice": notice,
                        "time": time.time()}).encode())
