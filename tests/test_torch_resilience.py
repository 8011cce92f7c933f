"""The port's control-plane resilience (mirrors tests/test_resilience.py):
``RetryPolicy``'s schedule and classification, the network fault grammar
and its seam, the generation fence, the collective deadline's knob, and
the port's rendezvous store under injected ``kv_outage`` windows,
concurrent writers and TTL expiry; the gloo controller's verbs behind the
seam, with a lost peer typed. Parity with the JAX package is bit-equal:
the same seeds give the same delays, the same strings the same faults or
the same rejection."""

import dataclasses
import random
import socket
import threading
import time
from urllib.error import HTTPError, URLError

import pytest

from horovod_tpu.utils import resilience as jres
from horovod_tpu_torch.exceptions import WorkerLostError
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.run.rendezvous import KVStoreClient, RendezvousServer
from horovod_tpu_torch.utils import resilience


@pytest.fixture
def chaos_env(monkeypatch):
    """Arm HOROVOD_FAULT_INJECT for one test and disarm afterwards."""

    def arm(spec, rank="0"):
        monkeypatch.setenv("HOROVOD_FAULT_INJECT", spec)
        monkeypatch.setenv("HOROVOD_RANK", rank)
        resilience.reload_chaos()

    yield arm
    monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
    resilience.reload_chaos()


def _retries(transport):
    return _metrics().counter(
        "horovod_net_retries_total", "", labelnames=("transport",)
    ).labels(transport=transport).value


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,base,cap", [(7, 0.1, 2.0), (3, 0.05, 0.4),
                                           (11, 1.0, 10.0)])
def test_delay_for_is_the_jax_packages_under_one_seed(seed, base, cap):
    ours = resilience.RetryPolicy(base_delay=base, max_delay=cap,
                                  rng=random.Random(seed))
    theirs = jres.RetryPolicy(base_delay=base, max_delay=cap,
                              rng=random.Random(seed))
    got = [ours.delay_for(a) for a in range(1, 15) for _ in range(5)]
    want = [theirs.delay_for(a) for a in range(1, 15) for _ in range(5)]
    assert got == want
    for a, d in zip((a for a in range(1, 15) for _ in range(5)), got):
        assert 0.0 <= d <= min(cap, base * 2 ** (a - 1))


def test_call_retries_transients_then_succeeds():
    sleeps = []
    policy = resilience.RetryPolicy(
        transport="t1", max_retries=5, base_delay=0.01,
        sleep=sleeps.append, rng=random.Random(3))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("boom")
        return "ok"

    before = _retries("t1")
    assert policy.call(flaky, phase="unit") == "ok"
    assert len(calls) == 3 and len(sleeps) == 2
    assert _retries("t1") - before == 2
    # the same schedule as the JAX package's policy on the same seed
    jsleeps = []
    jcalls = []

    def jflaky():
        jcalls.append(1)
        if len(jcalls) < 3:
            raise ConnectionResetError("boom")
        return "ok"

    jres.RetryPolicy(transport="t1", max_retries=5, base_delay=0.01,
                     sleep=jsleeps.append, rng=random.Random(3)).call(
        jflaky, phase="unit")
    assert sleeps == jsleeps


def test_call_nonretryable_passes_through():
    sleeps = []
    policy = resilience.RetryPolicy(sleep=sleeps.append)
    with pytest.raises(ValueError):
        policy.call(lambda: (_ for _ in ()).throw(ValueError("x")),
                    phase="unit")
    assert sleeps == []


def test_call_exhausts_attempts_and_reraises():
    sleeps = []
    policy = resilience.RetryPolicy(
        max_retries=2, base_delay=0.01, sleep=sleeps.append,
        rng=random.Random(1))
    with pytest.raises(ConnectionResetError):
        policy.call(lambda: (_ for _ in ()).throw(
            ConnectionResetError("always")), phase="unit")
    assert len(sleeps) == 2


def test_call_deadline_exhaustion():
    policy = resilience.RetryPolicy(
        max_retries=50, base_delay=0.5, sleep=lambda d: None,
        rng=random.Random(2))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        policy.call(lambda: (_ for _ in ()).throw(TimeoutError("slow")),
                    phase="unit", deadline=0.0)
    assert time.monotonic() - t0 < 1.0


_CLASSIFIED = [
    ConnectionResetError(), socket.timeout(), TimeoutError(),
    URLError("refused"), resilience.ChaosError(), KeyError("x"),
    ValueError("x"), OSError("x"), RuntimeError("x"),
    *[HTTPError("http://x", c, "e", None, None)
      for c in (404, 403, 408, 429, 500, 502, 503, 504)],
]


def test_classification_is_the_jax_packages():
    assert [resilience.is_retryable(e) for e in _CLASSIFIED] == \
        [jres.is_retryable(e) for e in _CLASSIFIED]
    assert resilience.RETRYABLE_HTTP_CODES == jres.RETRYABLE_HTTP_CODES
    assert resilience.is_retryable(resilience.ChaosError())
    assert not resilience.is_retryable(
        HTTPError("http://x", 404, "missing", None, None))


def test_from_env_is_the_jax_packages(monkeypatch):
    monkeypatch.setenv("HOROVOD_NET_MAX_RETRIES", "9")
    monkeypatch.setenv("HOROVOD_NET_BACKOFF_BASE_SECONDS", "0.5")
    monkeypatch.setenv("HOROVOD_NET_ATTEMPT_TIMEOUT_SECONDS", "2.5")
    ours = resilience.RetryPolicy.from_env("kv", deadline=3.0)
    theirs = jres.RetryPolicy.from_env("kv", deadline=3.0)
    fields = ("transport", "max_retries", "base_delay", "max_delay",
              "deadline", "attempt_timeout")
    assert [getattr(ours, f) for f in fields] == \
        [getattr(theirs, f) for f in fields]
    assert (ours.max_retries, ours.base_delay, ours.deadline) == (9, 0.5, 3.0)


# ---------------------------------------------------------------------------
# chaos grammar + injection seam
# ---------------------------------------------------------------------------

_NET_SPECS = [
    "partition:1:30:after=4; kv_outage:5:on=reform; "
    "flaky:0.3:rank=2:seconds=10; netdelay:25",
    "kill:rank=1:step=3;flaky:0.5",
    "netdelay:5:hop=cross",
    "partition:2",
    "flaky:7",
    "kv_outage:0.6:after=1.5",
    "nan:1;bitflip:0:after=2;netdelay:3:rank=1",
    "partition", "flaky:notaprob", "netdelay:10:bogus=1",
    "netdelay:5:hop=intra", "kv_outage", "",
]


@pytest.mark.parametrize("spec", _NET_SPECS)
def test_parse_net_faults_is_the_jax_packages(spec):
    try:
        want = [dataclasses.asdict(f) for f in jres.parse_net_faults(spec)]
    except ValueError:
        with pytest.raises(ValueError):
            resilience.parse_net_faults(spec)
        return
    got = [dataclasses.asdict(f) for f in resilience.parse_net_faults(spec)]
    assert got == want
    for clause in spec.split(";"):
        assert resilience.is_net_clause(clause) == jres.is_net_clause(clause)


def test_process_fault_parser_skips_net_clauses(chaos_env):
    from horovod_tpu_torch.elastic import fault_inject

    chaos_env("kv_outage:5:on=reform;kill:rank=1:step=3")
    spec = fault_inject.spec_from_env()
    assert (spec.action, spec.rank, spec.step) == ("kill", 1, 3)


def test_inject_flaky_raises_chaos_error(chaos_env):
    chaos_env("flaky:1.0")
    with pytest.raises(resilience.ChaosError):
        resilience.inject("kv", "unit")


def test_inject_flaky_targets_launch_rank_only(chaos_env):
    chaos_env("flaky:1.0:rank=3", rank="0")
    resilience.inject("kv", "unit")  # not rank 3: no-op


def test_inject_netdelay_sleeps(chaos_env):
    chaos_env("netdelay:80")
    t0 = time.monotonic()
    resilience.inject("ctrl", "unit")
    assert time.monotonic() - t0 >= 0.07


def test_netdelay_hop_cross_parses_and_raises_until_the_hierarchy(chaos_env):
    """With the two-level collectives ported, ``hop=cross`` no longer
    raises: it taxes the seams that declare crossings of the slow link, a
    delay a crossing, as the JAX package's ``inject`` does, and skips the
    rest (the control plane's, an intra hop's 0)."""
    (delay,) = resilience.parse_net_faults("netdelay:5:hop=cross")
    assert (delay.kind, delay.delay_ms, delay.hop) == ("netdelay", 5.0,
                                                       "cross")
    chaos_env("netdelay:40:hop=cross")
    t0 = time.monotonic()
    resilience.inject("ctrl", "unit")
    resilience.inject("hier_intra", "allgather", crossings=0)
    assert time.monotonic() - t0 < 0.03
    t0 = time.monotonic()
    resilience.inject("hier_cross", "allreduce", crossings=2)
    assert time.monotonic() - t0 >= 0.075
    # the data plane's seams take delays only: no reset mid-collective
    chaos_env("flaky:1.0")
    for transport in ("ring", "hier_intra", "hier_cross"):
        resilience.inject(transport, "allreduce", crossings=1)


def test_inject_partition_blocks_window(chaos_env):
    chaos_env("partition:0:0.3")
    t0 = time.monotonic()
    resilience.inject("ctrl", "unit")
    assert time.monotonic() - t0 >= 0.25


def test_generation_fence_roundtrip():
    old = resilience.current_generation()
    try:
        resilience.set_generation(old + 5)
        assert resilience.current_generation() == old + 5
    finally:
        resilience.set_generation(old)


def test_collective_timeout_knob(monkeypatch):
    monkeypatch.delenv("HOROVOD_COLLECTIVE_TIMEOUT", raising=False)
    assert resilience.collective_timeout() == 0.0
    monkeypatch.setenv("HOROVOD_COLLECTIVE_TIMEOUT", "7.5")
    assert resilience.collective_timeout() == 7.5 == jres.collective_timeout()


# ---------------------------------------------------------------------------
# the gloo controller's verbs behind the seam
# ---------------------------------------------------------------------------

def test_lost_peer_errors_are_typed():
    from horovod_tpu_torch.runtime.gloo_controller import lost_worker

    for text in ("[pair.cc:537] Read error [127.0.0.1]:5517: Connection "
                 "reset by peer", "Connection closed by peer [10.0.0.2]:1",
                 "Timed out waiting 5000ms for recv operation"):
        got = lost_worker(RuntimeError(text))
        assert isinstance(got, WorkerLostError) and text in str(got)
    assert lost_worker(ValueError("bad shape")) is None
    assert isinstance(lost_worker(resilience.ChaosError("x")),
                      WorkerLostError)


def test_gloo_verbs_pass_the_seam_and_type_a_reset(chaos_env):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as state_mod
    from horovod_tpu_torch.runtime.gloo_controller import GlooController

    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        ctl = GlooController(0, 1, state_mod.global_state().control_group,
                             native_engine=False)
        assert ctl.sync_bitvectors(5) == (5, 5)
        assert ctl.allgather_blob(b"abc") == [b"abc"]
        chaos_env("flaky:1.0")
        with pytest.raises(WorkerLostError, match="chaos"):
            ctl.sync_bitvectors(5)
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# the rendezvous store under chaos and load
# ---------------------------------------------------------------------------

def _fast_retry(**kw):
    kw.setdefault("max_retries", 30)
    kw.setdefault("base_delay", 0.05)
    kw.setdefault("max_delay", 0.15)
    kw.setdefault("attempt_timeout", 5.0)
    return resilience.RetryPolicy(transport="kv", **kw)


def test_kv_outage_bridged_by_client_retry(chaos_env, monkeypatch):
    chaos_env("kv_outage:0.6")
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
        resilience.reload_chaos()
        server.put("global", "answer", b"42")
        client = KVStoreClient("127.0.0.1", port, timeout=10,
                               retry=_fast_retry())
        before = _retries("kv")
        t0 = time.monotonic()
        assert client.get("answer") == b"42"
        assert time.monotonic() - t0 >= 0.4
        assert _retries("kv") - before > 0
        client.set("post", b"v")
        assert server.get("global", "post") == b"v"
    finally:
        server.stop()


def test_kv_outage_reform_armed_by_elastic_scope(chaos_env, monkeypatch):
    chaos_env("kv_outage:0.5:on=reform")
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
        resilience.reload_chaos()
        client = KVStoreClient("127.0.0.1", port, timeout=10,
                               retry=_fast_retry())
        client.set("k", b"v")
        assert server._httpd.chaos_outage_start is None
        client.set("member.0", b"uid", scope="elastic.g1")
        assert server._httpd.chaos_outage_start is not None
        assert server.get("elastic.g1", "member.0") == b"uid"
    finally:
        server.stop()


def test_rendezvous_concurrent_writers():
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        client = KVStoreClient("127.0.0.1", port, timeout=10)
        errors = []

        def writer(i):
            try:
                c = KVStoreClient("127.0.0.1", port, timeout=10)
                for j in range(5):
                    c.set(f"w{i}.{j}", f"{i}:{j}".encode())
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        keys = set(client.keys("global"))
        assert {f"w{i}.{j}" for i in range(8) for j in range(5)} <= keys
        assert client.get("w3.4", wait=False) == b"3:4"
    finally:
        server.stop()


def test_heartbeat_ttl_expiry_during_outage(chaos_env, monkeypatch):
    chaos_env("kv_outage:0.4")
    server = RendezvousServer("127.0.0.1", heartbeat_ttl=0.3)
    port = server.start()
    try:
        monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
        resilience.reload_chaos()
        server.put("heartbeat", "0-123", b"beat")
        assert server.live_keys("heartbeat") == ["0-123"]
        time.sleep(0.5)
        client = KVStoreClient("127.0.0.1", port, timeout=5,
                               retry=_fast_retry())
        assert client.keys("heartbeat") == []
        with pytest.raises(KeyError):
            client.get("0-123", scope="heartbeat", wait=False)
    finally:
        server.stop()


def test_every_http_op_has_default_socket_timeout():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    try:
        policy = resilience.RetryPolicy(
            transport="kv", max_retries=1, base_delay=0.01,
            attempt_timeout=0.3)
        client = KVStoreClient("127.0.0.1", port, timeout=1, retry=policy)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            client.set("k", b"v")
        assert time.monotonic() - t0 < 5.0
    finally:
        lst.close()


def test_get_retries_bounded_by_op_deadline(chaos_env, monkeypatch):
    chaos_env("kv_outage:30")
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
        resilience.reload_chaos()
        client = KVStoreClient("127.0.0.1", port, timeout=0.8,
                               retry=_fast_retry())
        t0 = time.monotonic()
        with pytest.raises((TimeoutError, HTTPError)):
            client.get("never")
        assert time.monotonic() - t0 < 10.0
    finally:
        server.stop()
