"""The port's data module (mirrors tests/test_data.py): rank-sharded
sampling and device prefetch.

``ShardedSampler`` is held to the JAX package's sampler index for index
(sizes that do not divide the replicas, several seeds and epochs), and to
torch's ``DistributedSampler`` in shard lengths and coverage.
``prefetch_to_device`` keeps order and values, relays the source's error,
stops its thread on close, feeds the port's train step, and for a CUDA
device never hands back host tensors (here, without a card, it raises).
"""

import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.data import ShardedSampler, prefetch_to_device

WORLD = 8


def JaxSampler(*args, **kwargs):
    """The JAX package's sampler (imported here, not at the top: the card's
    machine runs this file's ``gpu`` test without JAX)."""
    from horovod_tpu.data import ShardedSampler as sampler

    return sampler(*args, **kwargs)


@pytest.fixture(autouse=True)
def _world(monkeypatch):
    for knob in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


class TestShardedSampler:
    def test_disjoint_and_complete(self):
        n = 103  # not divisible by 8: padding kicks in
        shards = [list(ShardedSampler(n, WORLD, r, seed=3))
                  for r in range(WORLD)]
        assert {len(s) for s in shards} == {-(-n // WORLD)}
        seen = [i for s in shards for i in s]
        assert set(seen) == set(range(n))
        assert len(seen) == -(-n // WORLD) * WORLD

    @pytest.mark.parametrize("n,replicas,seed", [
        (103, 8, 3), (50, 4, 9), (7, 3, 0), (1, 2, 5), (64, 8, 1),
        (1000, 6, 42)])
    @pytest.mark.parametrize("shuffle", [True, False])
    def test_indices_equal_the_jax_samplers(self, n, replicas, seed,
                                            shuffle):
        for rank in range(replicas):
            ours = ShardedSampler(n, replicas, rank, shuffle=shuffle,
                                  seed=seed)
            theirs = JaxSampler(n, replicas, rank, shuffle=shuffle,
                                seed=seed)
            for epoch in (0, 1, 7):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                assert list(ours) == list(theirs), (rank, epoch)
            assert len(ours) == len(theirs)
            assert ours.total_size == theirs.total_size

    def test_epoch_reshuffles_consistently(self):
        s0 = ShardedSampler(64, WORLD, 0, seed=1)
        s0b = ShardedSampler(64, WORLD, 0, seed=1)
        e0 = list(s0)
        s0.set_epoch(1)
        assert list(s0) != e0
        s0b.set_epoch(1)
        assert list(s0) == list(s0b)

    def test_no_shuffle_is_strided(self):
        assert list(ShardedSampler(16, 4, 1, shuffle=False)) == [1, 5, 9, 13]

    def test_defaults_from_world(self):
        s = ShardedSampler(32)
        assert (s.num_replicas, s.rank) == (hvd.size(), hvd.rank()) == (1, 0)
        assert list(s) == list(JaxSampler(32, 1, 0))

    def test_validation(self):
        with pytest.raises(ValueError):
            ShardedSampler(10, 4, 4)
        with pytest.raises(ValueError):
            ShardedSampler(0)

    def test_matches_torch_distributed_sampler_semantics(self):
        from torch.utils.data.distributed import DistributedSampler

        n = 50
        dataset = list(range(n))
        for r in range(4):
            ts = DistributedSampler(dataset, num_replicas=4, rank=r,
                                    shuffle=True, seed=9)
            ts.set_epoch(2)
            ours = ShardedSampler(n, 4, r, seed=9)
            ours.set_epoch(2)
            assert len(list(ts)) == len(list(ours))
            assert set(ours) <= set(range(n))
        t_all = {i for r in range(4) for i in DistributedSampler(
            dataset, num_replicas=4, rank=r, shuffle=True, seed=9)}
        o_all = {i for r in range(4) for i in ShardedSampler(n, 4, r, seed=9)}
        assert t_all == o_all == set(range(n))


class TestPrefetch:
    def test_order_and_values(self):
        batches = [{"x": np.full((2,), i, np.float32)} for i in range(7)]
        out = list(prefetch_to_device(iter(batches), size=3))
        assert len(out) == 7
        for i, b in enumerate(out):
            assert isinstance(b["x"], torch.Tensor)
            assert b["x"].device.type == "cpu"
            np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])

    def test_device_placement(self):
        """``device=`` stands for the JAX ``sharding=``: nested batches of
        tensors and arrays land on it, other leaves pass through."""
        src = ((torch.arange(4.0) + i, [np.ones(2, np.int64) * i], "tag")
               for i in range(3))
        out = list(prefetch_to_device(src, size=2, device="cpu"))
        assert len(out) == 3
        x, (y,), tag = out[2]
        assert x.device == torch.device("cpu") and torch.equal(
            x, torch.arange(4.0) + 2)
        assert isinstance(y, torch.Tensor) and y.tolist() == [2, 2]
        assert tag == "tag"

    def test_cuda_device_never_returns_host_tensors(self):
        """Without a card the CUDA path raises; it does not fall back."""
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the gpu test covers it")
        with pytest.raises((RuntimeError, AssertionError)):
            next(prefetch_to_device(iter([torch.ones(2)]), device="cuda"))

    def test_source_error_propagates(self):
        def bad():
            yield np.zeros(2)
            raise RuntimeError("boom")

        it = prefetch_to_device(bad(), size=2)
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)

    def test_early_close_stops_worker(self):
        produced = []

        def src():
            for i in range(1000):
                produced.append(i)
                yield np.zeros(1)

        it = prefetch_to_device(src(), size=2)
        next(it)
        it.close()
        n_after = len(produced)
        time.sleep(0.1)
        assert len(produced) <= n_after + 1
        assert threading.active_count() < 50

    def test_train_loop_end_to_end(self):
        """Sampler + prefetch feeding the port's train step."""
        from horovod_tpu_torch import training
        from horovod_tpu_torch.models.mnist import MnistConvNet

        torch.manual_seed(0)
        model = MnistConvNet(image_size=28, device="cpu")
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.05))
        step = training.make_train_step(model, opt)
        rng = np.random.RandomState(0)
        images = rng.rand(64, 28, 28, 1).astype(np.float32)
        labels = rng.randint(0, 10, 64).astype(np.int64)
        sampler = ShardedSampler(64, 1, 0, seed=0)

        def batches():
            idx = list(sampler)
            for i in range(0, len(idx), 16):
                take = idx[i:i + 16]
                yield images[take], labels[take]

        losses = [float(step(xb, yb))
                  for xb, yb in prefetch_to_device(batches(), size=2)]
        assert len(losses) == 4
        assert np.isfinite(losses).all()


@pytest.mark.gpu
def test_prefetch_to_the_card_copies_on_its_own_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    streams = []
    real_record = torch.cuda.Event.record

    def spy(self, stream=None):
        streams.append(stream)
        return real_record(self, stream)

    torch.cuda.Event.record = spy
    try:
        src = [{"x": np.arange(1 << 20, dtype=np.float32) + i,
                "y": torch.full((8,), i)} for i in range(5)]
        out = list(prefetch_to_device(iter(src), size=2, device=dev))
    finally:
        torch.cuda.Event.record = real_record
    assert len(out) == 5 and len(streams) == 5
    main = torch.cuda.current_stream(dev)
    assert all(s is not None and s != main for s in streams)
    for i, b in enumerate(out):
        assert b["x"].device == dev and b["y"].device == dev
        assert torch.equal(b["x"].cpu(), torch.from_numpy(src[i]["x"]))
        assert b["y"].cpu().tolist() == [i] * 8
