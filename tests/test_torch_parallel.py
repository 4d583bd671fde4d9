"""The port's data-parallel pieces that need no group, against the JAX
package, on the CPU.

* ``BatchSampler`` at 1-4 replicas gives each rank the JAX
  ``DistributedBatchSampler``'s batches, and ``batches_at_step`` its view of
  every rank, over several epochs: leftovers, ``shuffle_batch``,
  ``drop_last``, ``pad_batch_assignment``, ``required_batch_count_multiple``,
  and the errors on too few batches.
* ``fixed_batch_rows`` (one card a process), ``_global_shape_targets`` and
  ``_collate_train`` padded to them equal JAX's on the same set.
* ``init_distributed`` does nothing at one process, every collective is a
  no-op without a group, and ``local_device`` raises without CUDA unless the
  CPU is asked for.
* ``duration_loss`` of each rank's rows with the global ``ph2word`` maximum
  averages to JAX's loss on the global batch; with each rank's own maximum
  it does not.
"""

import pickle
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import Sizes, _acoustic_items, _variance_items  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SAMPLERS = {
    "leftovers": dict(max_batch_frames=3000, max_batch_size=64),
    "shuffle_batch": dict(max_batch_frames=2500, max_batch_size=7, shuffle_batch=True, seed=4),
    "drop_last": dict(max_batch_frames=2000, max_batch_size=8, drop_last=True, seed=2),
    "accum": dict(max_batch_frames=2500, max_batch_size=7, required_batch_count_multiple=4,
                  shuffle_batch=True),
    "unpadded": dict(max_batch_frames=4000, max_batch_size=16, pad_batch_assignment=False,
                     sort_by_similar_size=False, frame_count_grid=10, seed=11),
    "accum_unpadded": dict(max_batch_frames=3000, max_batch_size=9,
                           required_batch_count_multiple=3, pad_batch_assignment=False),
}


@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(SAMPLERS))
def test_sampler_ranks_match_jax(case, replicas):
    from xiaoicesing_io_tpu.data.sampler import DistributedBatchSampler as J
    from xiaoicesing_io_tpu_torch.data.sampler import BatchSampler as P

    ds = Sizes(np.random.default_rng(0).integers(40, 900, 97))
    kw = SAMPLERS[case]
    lens = set()
    for rank in range(replicas):
        j = J(ds, num_replicas=replicas, rank=rank, **kw)
        p = P(ds, num_replicas=replicas, rank=rank, **kw)
        for epoch in range(3):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert [list(b) for b in p] == [list(b) for b in j], (rank, epoch)
            lens.add((epoch, len(p)))
            for step in range(len(p) + 1):
                assert p.batches_at_step(step) == j.batches_at_step(step), (rank, epoch, step)
    if kw.get("pad_batch_assignment", True):  # every rank takes the same number of steps
        assert len({n for e, n in lens if e == 0}) == 1


def test_sampler_one_replica_unchanged_and_errors():
    """At one replica the batches are the whole epoch's (every rank's view
    is that one list); too few batches raise as in JAX."""
    from xiaoicesing_io_tpu.data.sampler import DistributedBatchSampler as J
    from xiaoicesing_io_tpu_torch.data.sampler import BatchSampler as P

    ds = Sizes(np.random.default_rng(1).integers(40, 900, 30))
    p = P(ds, 3000, 64, required_batch_count_multiple=4)
    p.set_epoch(1)
    assert p.batches_at_step(0) == [list(p)[0]]
    few = Sizes([100, 200])
    for cls in (J, P):
        with pytest.raises(RuntimeError, match="not enough batch"):
            cls(few, 1000, 8, num_replicas=2, rank=0).set_epoch(0)
        with pytest.raises(ValueError):
            cls(few, 1000, 8, num_replicas=2, rank=2)
    # a rank with nothing to repeat: an error on that rank only
    one = Sizes([100])
    for cls in (J, P):
        with pytest.raises(RuntimeError, match="Cannot pad"):
            cls(one, 1000, 8, num_replicas=2, rank=1, disallow_empty_batch=False).set_epoch(0)
        s = cls(one, 1000, 8, num_replicas=2, rank=0, disallow_empty_batch=False)
        s.set_epoch(0)
        assert [list(b) for b in s] == [[0]] and s.batches_at_step(0) == [[0], []]


def _write_set(directory, items, prefix="train"):
    """A set whose ``.meta`` has every array's lengths, as the binarizers
    write it."""
    from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder

    directory.mkdir(parents=True, exist_ok=True)
    b = IndexedDatasetBuilder(directory, prefix)
    for it in items:
        b.add_item(it)
    b.finalize()
    meta = {"lengths": [len(it["mel2ph"]) for it in items]}
    meta.update({k: [len(it[k]) for it in items] for k in items[0]})
    with open(directory / f"{prefix}.meta", "wb") as f:
        pickle.dump(meta, f)


def test_fixed_batch_rows_one_card_a_process():
    from xiaoicesing_io_tpu.training.trainer import fixed_batch_rows as J
    from xiaoicesing_io_tpu_torch.training.trainer import fixed_batch_rows as P

    for n_items in (1, 3, 9, 40):
        for t_pad in (128, 256, 1024, 2048):
            for frames, size in ((50000, 64), (6000, 5), (80000, 7), (300, 4)):
                assert P(n_items, t_pad, frames, size, n_local=1) == \
                    J(n_items, t_pad, frames, size, 1)


@pytest.mark.parametrize("category,replicas", [("acoustic", 2), ("acoustic", 3),
                                               ("variance", 2), ("variance", 4)])
def test_shape_targets_and_collate_match_jax(category, replicas, tmp_path):
    """Every rank's targets for every step of two epochs, and its batch
    collated to them, equal the JAX trainer's byte for byte."""
    from xiaoicesing_io_tpu.training.trainer import Trainer as JTrainer
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults, variance_defaults
    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset, VarianceDataset
    from xiaoicesing_io_tpu_torch.data.sampler import BatchSampler
    from xiaoicesing_io_tpu_torch.training.trainer import Trainer

    if category == "acoustic":
        items, cfg, Dataset = _acoustic_items(14, seed=3), acoustic_defaults(), AcousticDataset
    else:
        items, cfg, Dataset = _variance_items(14, seed=4), variance_defaults(), VarianceDataset
    cfg.update(max_batch_frames=120, max_batch_size=4)
    _write_set(tmp_path / "set", items)
    ds = Dataset(tmp_path / "set", "train", cfg)
    seen = 0
    for rank in range(replicas):
        jns = SimpleNamespace(cfg=cfg, train_dataset=ds, collate=ds.collate, n_local=1,
                              num_replicas=replicas)
        pns = SimpleNamespace(cfg=cfg, train_dataset=ds, collate=ds.collate, world=replicas)
        sampler = BatchSampler(ds, 120, 4, num_replicas=replicas, rank=rank, seed=1)
        for epoch in range(2):
            sampler.set_epoch(epoch)
            for step, indices in enumerate(sampler):
                ref_t = JTrainer._global_shape_targets(jns, sampler, step)
                got_t = Trainer._global_shape_targets(pns, sampler, step)
                assert got_t == ref_t and "tokens" in got_t
                assert ("notes" in got_t) == (category == "variance")
                ref = JTrainer._collate_train(jns, indices, ref_t)
                got = Trainer._collate_train(pns, indices, got_t)
                assert list(got) == list(ref)
                for k in got:
                    assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
                    assert got[k].tobytes() == ref[k].tobytes(), k
                seen += 1
    assert seen > 2 * replicas
    assert Trainer._global_shape_targets(SimpleNamespace(world=1), None, 0) is None


def test_no_group_at_one_process(monkeypatch):
    import torch.distributed as dist

    from xiaoicesing_io_tpu_torch.parallel import mesh

    for n in (None, 0, 1):
        mesh.init_distributed("localhost:1", n, 0)
        mesh.init_distributed(num_processes=n)
    assert not dist.is_initialized()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    t = [torch.arange(4.0), torch.ones(2, 3)]
    assert mesh.all_reduce_mean_(t) is t and torch.equal(t[0], torch.arange(4.0))
    x = torch.tensor(5)
    assert mesh.all_reduce_max(x) is x
    assert mesh.broadcast_(t)[1] is t[1] and mesh.any_flag([0, True]) == [False, True]
    mesh.barrier()
    assert mesh.local_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="process_id"):
        mesh.init_distributed("localhost:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed(None, 2, 0, device="cpu")
    if not torch.cuda.is_available():
        for device in (None, "cuda", "cuda:1"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mesh.local_device(device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.init_distributed("localhost:1", 2, 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.local_device() == torch.device("cuda", 3)
    assert mesh.local_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_RANK")
    assert mesh.local_device(process_id=3) == torch.device("cuda", 1)
    assert not dist.is_initialized()


def test_duration_loss_global_max_matches_jax():
    """Two ranks' rows whose ``ph2word`` maxima differ (3 and 6 words): the
    mean of the ranks' losses with the global maximum is JAX's loss of the
    concatenated batch; with each rank's own maximum it is not."""
    from xiaoicesing_io_tpu.training.losses import duration_loss as J
    from xiaoicesing_io_tpu_torch.training.losses import duration_loss as P

    rng = np.random.default_rng(0)
    b, n = 3, 9
    ph2word = np.zeros((2 * b, n), np.int64)
    for row, words in enumerate((3, 2, 1, 6, 4, 5)):
        k = int(rng.integers(words, n + 1))
        cuts = np.sort(rng.choice(np.arange(1, k), words - 1, replace=False))
        ph2word[row, :k] = np.repeat(np.arange(1, words + 1), np.diff(np.r_[0, cuts, k]))
    assert [int(ph2word[:b].max()), int(ph2word[b:].max())] == [3, 6]
    mask = ph2word > 0
    pred = np.where(mask, rng.uniform(0.5, 12, (2 * b, n)), 0).astype(np.float32)
    gt = np.where(mask, rng.integers(1, 10, (2 * b, n)), 0).astype(np.int64)
    for loss_type in ("mse", "huber"):
        ref = float(J(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(ph2word),
                      loss_type=loss_type))
        gmax = torch.tensor(int(ph2word.max()))
        rows = [slice(0, b), slice(b, 2 * b)]
        glob = np.mean([float(P(torch.tensor(pred[s]), torch.tensor(gt[s]),
                                torch.tensor(ph2word[s]), loss_type=loss_type, word_max=gmax))
                        for s in rows])
        own = np.mean([float(P(torch.tensor(pred[s]), torch.tensor(gt[s]),
                               torch.tensor(ph2word[s]), loss_type=loss_type)) for s in rows])
        assert abs(glob - ref) <= 1e-6 * abs(ref), (loss_type, glob, ref)
        assert abs(own - ref) > 1e-3 * abs(ref), (loss_type, own, ref)
        whole = float(P(torch.tensor(pred), torch.tensor(gt), torch.tensor(ph2word),
                        loss_type=loss_type))
        assert abs(whole - ref) <= 1e-6 * abs(ref)
