"""The launcher's rendezvous HTTP key-value store (port of
``horovod_tpu/run/rendezvous.py:57-432``; reference:
horovod/run/rendezvous/http_server.py:140-204).

A threaded HTTP server holds scoped key-value maps that workers use to
find each other outside any collective channel. ``PUT /<scope>/<key>``
stores a value, ``GET`` returns it or 404, ``DELETE`` marks a key finished
(the key ``*`` drops the whole scope). The wire is the JAX package's, so
either package's client talks to either package's server.

* ``GET ...?wait=<s>`` long-polls: the handler parks on a condition until
  the key appears or the wait ends (at most 60 s).
* ``GET /_keys/<scope>[?ttl=<s>]`` lists a scope's keys, only those put
  within the last ``ttl`` seconds when given: the elastic re-form reads
  who registered for the next generation from it.
* The ``heartbeat`` scope's keys expire after the server's TTL
  (``HOROVOD_RENDEZVOUS_HEARTBEAT_TTL``, default 30 s): expiry is the
  elastic driver's liveness signal.
* ``GET /_time`` is the server's wall clock.

The server answers 503 inside an injected ``kv_outage`` window
(``HOROVOD_FAULT_INJECT``, ``utils/resilience.py``); every client op runs
under a :class:`~horovod_tpu_torch.utils.resilience.RetryPolicy` with a
socket timeout, and ``get``'s retries are bounded by the op's own
deadline. Each client round trip is a record of the comms observatory's
``kv`` lane (the response's bytes over the host's wall time).
"""

from __future__ import annotations

import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.error import HTTPError
from urllib.parse import parse_qs, urlsplit
from urllib.request import Request, urlopen

from horovod_tpu_torch import comms
from horovod_tpu_torch.utils import resilience
from horovod_tpu_torch.utils.env import (
    HOROVOD_FAULT_INJECT, HOROVOD_RENDEZVOUS_HEARTBEAT_TTL,
    HOROVOD_RENDEZVOUS_LONG_POLL_SECONDS, _get_float)

# cap on the server-side park, so a lost client cannot pin a handler
# thread forever
_MAX_WAIT_SECONDS = 60.0
HEARTBEAT_SCOPE = "heartbeat"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _split(self):
        parts = urlsplit(self.path).path.strip("/").split("/", 1)
        if len(parts) != 2 or not parts[0] or not parts[1]:
            self.send_error(400, "path must be /scope/key")
            return None
        return parts[0], parts[1]

    def _query(self, name: str) -> Optional[str]:
        values = parse_qs(urlsplit(self.path).query).get(name)
        return values[0] if values else None

    def _chaos_outage(self, scope: Optional[str]) -> bool:
        """Injected ``kv_outage`` window (HOROVOD_FAULT_INJECT): when
        active, answer 503 and return True. An ``on=reform`` outage arms
        on the first request touching a per-generation elastic scope —
        deterministically covering the re-form window chaos tests target.
        Any request body was already consumed by the caller (keep-alive
        correctness)."""
        srv = self.server
        fault = getattr(srv, "chaos_outage", None)
        if fault is None:
            return False
        now = time.monotonic()
        with srv.lock:
            start = srv.chaos_outage_start
            if (start is None and fault.on == "reform"
                    and scope and scope.startswith("elastic.g")):
                srv.chaos_outage_start = start = now
        if start is None or not (start <= now <= start + fault.seconds):
            return False
        self.send_response(503)
        self.send_header("Content-Length", "0")
        self.end_headers()
        return True

    def do_PUT(self):
        sk = self._split()
        if sk is None:
            return
        scope, key = sk
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if self._chaos_outage(scope):
            return
        with self.server.lock:
            self.server.store.setdefault(scope, {})[key] = value
            self.server.put_times.setdefault(scope, {})[key] = \
                time.monotonic()
            self.server.cond.notify_all()  # wake long-polling GETs
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _lookup(self, scope: str, key: str) -> Optional[bytes]:
        """Caller holds the lock. Heartbeat keys past the TTL read as
        absent — expiry IS the liveness signal."""
        value = self.server.store.get(scope, {}).get(key)
        if value is not None and scope == HEARTBEAT_SCOPE:
            put = self.server.put_times.get(scope, {}).get(key, 0.0)
            if time.monotonic() - put > self.server.heartbeat_ttl:
                return None
        return value

    def do_GET(self):
        path = urlsplit(self.path).path
        if path == "/_time":
            # launcher wall clock: workers sample this (NTP-style) so the
            # flight-recorder postmortem can merge cross-host event times
            body = repr(time.time()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path.startswith("/_keys/"):
            scope = path[len("/_keys/"):].strip("/")
            if self._chaos_outage(scope):
                return
            return self._do_keys(scope)
        sk = self._split()
        if sk is None:
            return
        scope, key = sk
        if self._chaos_outage(scope):
            return
        try:
            wait = min(float(self._query("wait") or 0.0), _MAX_WAIT_SECONDS)
        except ValueError:
            wait = 0.0
        deadline = time.monotonic() + wait
        with self.server.lock:
            value = self._lookup(scope, key)
            while value is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.server.cond.wait(remaining)
                value = self._lookup(scope, key)
        if value is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def _do_keys(self, scope: str) -> None:
        """GET /_keys/<scope>[?ttl=<s>] — list the scope's (live) keys."""
        ttl = None
        try:
            if self._query("ttl") is not None:
                ttl = float(self._query("ttl"))
        except ValueError:
            ttl = None
        with self.server.lock:
            keys = _live_keys_locked(self.server, scope, ttl)
        body = "\n".join(sorted(keys)).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_DELETE(self):
        # a rank declaring itself finished with the scope
        # (reference: http_server.py scope_size bookkeeping); the
        # special key "*" drops the whole scope (checkpoint commit
        # scopes are per-step — without this they accumulate forever)
        sk = self._split()
        if sk is None:
            return
        scope, key = sk
        if self._chaos_outage(scope):
            return
        with self.server.lock:
            if key == "*":
                self.server.store.pop(scope, None)
                self.server.put_times.pop(scope, None)
                self.server.finished.pop(scope, None)
            else:
                self.server.store.get(scope, {}).pop(key, None)
                self.server.put_times.get(scope, {}).pop(key, None)
                self.server.finished.setdefault(scope, set()).add(key)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


def _live_keys_locked(httpd, scope: str, ttl: Optional[float]) -> List[str]:
    """Keys of ``scope``; with a TTL (explicit, or the server default for
    the heartbeat scope) only keys PUT within the last ``ttl`` seconds."""
    if ttl is None and scope == HEARTBEAT_SCOPE:
        ttl = httpd.heartbeat_ttl
    keys = list(httpd.store.get(scope, {}))
    if ttl is None:
        return keys
    now = time.monotonic()
    times = httpd.put_times.get(scope, {})
    return [k for k in keys if now - times.get(k, 0.0) <= ttl]


class RendezvousServer:
    """Launcher-side store. ``start()`` returns the bound port."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 bind_retries: int = 5,
                 heartbeat_ttl: Optional[float] = None):
        # An explicitly-requested port can collide with a dying server
        # from a previous launch (or a race between launchers); retry with
        # backoff before giving up. Only EADDRINUSE is plausibly transient
        # — EACCES/EADDRNOTAVAIL etc. fail identically every attempt, so
        # they surface immediately. port=0 (ephemeral) cannot collide.
        import errno

        attempt = 0
        while True:
            try:
                self._httpd = ThreadingHTTPServer((host, port), _Handler)
                break
            except OSError as exc:
                attempt += 1
                if (port == 0 or attempt > bind_retries
                        or exc.errno != errno.EADDRINUSE):
                    raise
                time.sleep(0.2 * attempt)
        self._httpd.store = {}  # type: ignore[attr-defined]
        self._httpd.finished = {}  # type: ignore[attr-defined]
        self._httpd.put_times = {}  # type: ignore[attr-defined]
        self._httpd.lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.cond = threading.Condition(  # type: ignore[attr-defined]
            self._httpd.lock)
        self._httpd.heartbeat_ttl = (  # type: ignore[attr-defined]
            heartbeat_ttl if heartbeat_ttl is not None
            else _get_float(HOROVOD_RENDEZVOUS_HEARTBEAT_TTL, 30.0))
        # injected kv_outage (chaos): the window during which every KV
        # request answers 503. Timer-armed outages start counting now;
        # on=reform outages arm on first elastic.g* traffic.
        try:
            faults = resilience.parse_net_faults(
                os.environ.get(HOROVOD_FAULT_INJECT))
        except ValueError:
            faults = []
        outage = next((f for f in faults if f.kind == "kv_outage"), None)
        self._httpd.chaos_outage = outage  # type: ignore[attr-defined]
        self._httpd.chaos_outage_start = (  # type: ignore[attr-defined]
            None if outage is None or outage.on == "reform"
            else time.monotonic() + outage.after)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        with self._httpd.lock:  # type: ignore[attr-defined]
            # release parked long-polls so their handler threads exit
            self._httpd.cond.notify_all()  # type: ignore[attr-defined]
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    # launcher-side introspection
    def finished_keys(self, scope: str) -> set:
        with self._httpd.lock:  # type: ignore[attr-defined]
            return set(self._httpd.finished.get(scope, set()))  # type: ignore

    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._httpd.lock:  # type: ignore[attr-defined]
            return self._httpd.store.get(scope, {}).get(key)  # type: ignore

    def put(self, scope: str, key: str, value: bytes) -> None:
        """In-process PUT (the elastic driver lives in the launcher)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.store.setdefault(scope, {})[key] = value
            self._httpd.put_times.setdefault(  # type: ignore[attr-defined]
                scope, {})[key] = time.monotonic()
            self._httpd.cond.notify_all()  # type: ignore[attr-defined]

    def live_keys(self, scope: str, ttl: Optional[float] = None) -> List[str]:
        """Scope keys PUT within ``ttl`` seconds (default: the server's
        heartbeat TTL for the heartbeat scope, else no expiry)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            return _live_keys_locked(self._httpd, scope, ttl)


class KVStoreClient:
    """Worker-side client (reference: the gloo HTTPStore,
    common/gloo/http_store.cc — set/get/wait against the launcher server).

    ``get(wait=True)`` long-polls: each request asks the server to park up
    to ``long_poll`` seconds (``HOROVOD_RENDEZVOUS_LONG_POLL_SECONDS``)
    before 404ing, and the short client-side sleep only paces retries
    against pre-long-poll servers.

    Every HTTP op carries the retry policy's per-attempt socket timeout
    (a hung server can never block a worker forever) and retries
    transient failures — connection resets, 5xx/503 outage windows,
    socket timeouts — with full-jitter backoff. ``get``'s retries are
    bounded by the op's OWN deadline (``timeout``) rather than the
    policy's attempt cap, so a multi-second server outage shorter than
    the deadline is survived no matter how many attempts it takes."""

    def __init__(self, addr: str, port: int, scope: str = "global",
                 timeout: float = 60.0, long_poll: Optional[float] = None,
                 retry: Optional[resilience.RetryPolicy] = None):
        self._base = f"http://{addr}:{port}"
        self._scope = scope
        self._timeout = timeout
        self._long_poll = (long_poll if long_poll is not None
                           else _get_float(
                               HOROVOD_RENDEZVOUS_LONG_POLL_SECONDS, 5.0))
        self._retry = retry or resilience.RetryPolicy.from_env("kv")

    def _url(self, key: str, scope: Optional[str] = None) -> str:
        return f"{self._base}/{scope or self._scope}/{key}"

    def _open(self, url_or_req, timeout: float, phase: str) -> bytes:
        resilience.inject("kv", phase)
        t0 = time.monotonic()
        with urlopen(url_or_req, timeout=timeout) as resp:
            body = resp.read()
        # the kv lane: a control-plane round trip is tiny, but its
        # bandwidth's collapse is the first sign of a sick network (the
        # response's bytes over the request's host wall time)
        comms.record(phase, "kv", len(body), time.monotonic() - t0)
        return body

    def set(self, key: str, value: bytes, scope: Optional[str] = None) -> None:
        req = Request(self._url(key, scope), data=value, method="PUT")
        self._retry.call(self._open, req, self._retry.attempt_timeout,
                         "set", phase="kv.set")

    def get(self, key: str, scope: Optional[str] = None,
            wait: bool = True) -> bytes:
        deadline = time.monotonic() + self._timeout
        attempt = 0
        while True:
            url = self._url(key, scope)
            poll = 0.0
            if wait:
                poll = max(0.0, min(self._long_poll,
                                    deadline - time.monotonic()))
                if poll > 0:
                    url += f"?wait={poll:g}"
            try:
                return self._open(url, poll + self._retry.attempt_timeout,
                                  "get")
            except HTTPError as e:
                if e.code == 404:
                    if not wait:
                        raise KeyError(key) from e
                    # long-poll miss — the normal not-yet-published signal
                elif self._retry.retryable(e):
                    attempt += 1
                    self._backoff_or_raise(e, "kv.get", attempt, deadline)
                    continue
                else:
                    raise KeyError(key) from e
            except Exception as e:
                if not self._retry.retryable(e):
                    raise
                attempt += 1
                self._backoff_or_raise(e, "kv.get", attempt, deadline)
                continue
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"rendezvous key {key!r} not published within "
                    f"{self._timeout}s")
            time.sleep(0.05)

    def _backoff_or_raise(self, exc: Exception, phase: str, attempt: int,
                          deadline: float) -> None:
        """One full-jitter backoff inside ``get``'s loop; re-raises once
        the op deadline cannot accommodate another attempt."""
        delay = self._retry.delay_for(attempt)
        if time.monotonic() + delay >= deadline:
            resilience.give_up(self._retry.transport, phase, attempt, exc)
            raise exc
        resilience.note_retry(self._retry.transport, phase, attempt, delay,
                              exc)
        time.sleep(delay)

    def keys(self, scope: Optional[str] = None,
             ttl: Optional[float] = None) -> List[str]:
        """List a scope's keys (live ones only, when ``ttl`` given)."""
        url = f"{self._base}/_keys/{scope or self._scope}"
        if ttl is not None:
            url += f"?ttl={ttl:g}"
        body = self._retry.call(
            self._open, url, self._retry.attempt_timeout, "keys",
            phase="kv.keys").decode()
        return [k for k in body.split("\n") if k]

    def finish(self, key: str, scope: Optional[str] = None) -> None:
        req = Request(self._url(key, scope), method="DELETE")
        self._retry.call(self._open, req, self._retry.attempt_timeout,
                         "finish", phase="kv.finish")

    def clear_scope(self, scope: Optional[str] = None) -> None:
        """Drop the whole scope server-side (DELETE of the ``*`` key) —
        used by per-step checkpoint commit scopes once published."""
        self.finish("*", scope)
