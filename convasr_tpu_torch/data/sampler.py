"""Bucketing batch sampler with epoch-seeded shuffling and host sharding (a
copy of convasr_tpu/data/sampler.py).

Behavior spec: the reference convasr datasets.py:357-401 (BucketingBatchSampler):
examples grouped by bucket, each bucket padded by resampling to a multiple of
batch_size*world_size, shuffled with an epoch-seeded RNG, and `world_size`
CONSECUTIVE batches kept in the same bucket so all replicas of one sync step
see the same padded shape. Resumable via `batch_idx`.

Host sharding replaces DistributedSamplerWrapper (datasets.py:431-493): each
process calls `shard(rank, world_size)` to take its rank-strided batches from
the same globally-shuffled schedule.
"""
import typing

import numpy as np


class BucketingBatchSampler:
    def __init__(self, dataset, batch_size: int = 1, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.world_size = world_size
        buckets = np.asarray(dataset.bucket)
        self.buckets = {int(k): np.nonzero(buckets == k)[0] for k in np.unique(buckets)}
        self.batch_idx = 0
        self.set_epoch(0)

    def set_epoch(self, epoch: int):
        rng = np.random.RandomState(epoch)
        group_size = self.batch_size * self.world_size

        def shuffle_and_split(indices):
            required = int(np.ceil(len(indices) / group_size)) * group_size
            extra = rng.randint(0, len(indices), size=required - len(indices))
            extended = np.concatenate([indices, indices[extra]])
            return extended[rng.permutation(len(extended))].reshape(-1, self.batch_size)

        batches = np.concatenate([shuffle_and_split(g) for g in self.buckets.values()]) \
            if self.buckets else np.zeros((0, self.batch_size), np.int64)
        assert len(batches) % self.world_size == 0
        shuffled_groups = rng.permutation(len(batches) // self.world_size)
        if self.world_size > 1:
            group_indices = np.arange(len(batches)).reshape(-1, self.world_size)
            order = group_indices[shuffled_groups].reshape(-1)
        else:
            order = shuffled_groups
        self.shuffled = batches[order]

    def __iter__(self):
        return iter(self.shuffled[self.batch_idx:].tolist())

    def __len__(self):
        return len(self.shuffled)

    def shard(self, rank: int, world_size: typing.Optional[int] = None):
        """Rank-strided view of the remaining batches (one batch per rank per
        sync step — the DistributedSamplerWrapper contract)."""
        world_size = world_size if world_size is not None else self.world_size
        remaining = self.shuffled[self.batch_idx:]
        usable = len(remaining) - len(remaining) % world_size
        return iter(remaining[rank:usable:world_size].tolist())

    def state_dict(self):
        return dict(batch_idx=self.batch_idx)

    def load_state_dict(self, state_dict):
        self.batch_idx = state_dict['batch_idx']


class MixingBatchSampler:
    """Weighted mixing over several (dataset, BucketingBatchSampler) sources
    (spec: --train-data-mixing, referenced in scripts/comparison/*.sh).

    Every step draws a source with the given probability and yields that
    source's next batch (cycling each source's epoch-shuffled schedule), so a
    batch always comes from ONE dataset and collates with its own collate_fn.
    Iteration yields (source_index, batch_indices).
    """

    def __init__(self, samplers, weights, seed: int = 0):
        assert len(samplers) == len(weights) and samplers
        self.samplers = samplers
        total = float(sum(weights))
        self.weights = [w / total for w in weights]
        self.seed = seed
        self.epoch = 0
        self.batch_idx = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for s in self.samplers:
            s.set_epoch(epoch)

    def __len__(self):
        # one "epoch" = as many draws as the weighted sources would supply
        return sum(len(s) for s in self.samplers)

    def __iter__(self):
        return self._iterate(rank=None)

    def shard(self, rank: int, world_size: typing.Optional[int] = None):
        """Rank's view for multi-process SPMD: the source is drawn once per
        sync group of `world_size` consecutive batches (which the underlying
        BucketingBatchSamplers keep in the same bucket), so every rank sees
        the same source and padded shape each step."""
        return self._iterate(rank=rank)

    def _iterate(self, rank=None):
        world = self.samplers[0].world_size
        rng = np.random.RandomState((self.seed * 1000003 + self.epoch) % (2 ** 32))
        iters = [iter(s) for s in self.samplers]
        step = 0
        for g in range(len(self) // world):
            # draw AND consume even when skipping, so resume replays the
            # exact same schedule
            src = int(rng.choice(len(self.samplers), p=self.weights))
            group = []
            for _ in range(world):
                try:
                    batch = next(iters[src])
                except StopIteration:
                    self.samplers[src].set_epoch(self.epoch + 1 + step)
                    iters[src] = iter(self.samplers[src])
                    batch = next(iters[src])
                group.append(batch)
                step += 1
            if g < self.batch_idx:
                continue
            if rank is None:
                for batch in group:
                    yield src, batch
            else:
                yield src, group[rank]

    def state_dict(self):
        return dict(batch_idx=self.batch_idx)

    def load_state_dict(self, state_dict):
        self.batch_idx = state_dict['batch_idx']
