"""The training set resident on the card (counterpart of
convasr_tpu/data/device_cache.py, `train --device-cache`).

8 kHz int16 speech is small next to the card's memory, so a corpus that fits
is read once, grouped by bucket and uploaded; each step then moves only a (B,)
int32 row-index vector to the card and gathers its batch there.

Rows are padded to the BUCKET's padded length (not the batch's, as the
streaming collate pads, data/dataset.py collate_fn); xlen is the valid
fraction of that length. The replicated layout (`upload`) holds every bucket
on every card; the sharded one (`upload_sharded`) holds rank r's block of
rows [r*N/W, (r+1)*N/W) of each bucket, and `sharded_gather` assembles each
rank's rows with one all-reduce over the process group. Under a data x model
grid (parallel/mesh.make_groups) r and W are the data index and the count of
data indices, and the group is the data group: the model ranks of one data
index hold the same block and take the same rows, as the JAX package's
P('data') cache layout does on a 2-D mesh.

The JAX package's cached multi-step (a lax.scan over K gathered steps) is a
loop of cached steps here, as --steps-per-dispatch is (cli/train.py).
"""
import logging
import math

import numpy as np
import torch

log = logging.getLogger('convasr_tpu_torch.data')

SMAX = 32767.0


class DeviceDatasetCache:
    """Build with `DeviceDatasetCache.build(dataset, ...)`, upload, then per
    step `bucket, rows = cache.locate(batch_indices)` and
    `gather_batch(cache.device[bucket], rows)`."""

    def __init__(self, buckets_host, pos, bucket_of, nbytes):
        self.host = buckets_host      # bucket id -> dict(x, xlen, y, ylen) numpy
        self.pos = pos                # dataset index -> row within its bucket
        self.bucket_of = bucket_of    # dataset index -> bucket id
        self.nbytes = nbytes
        self.device = {}              # bucket id -> dict of tensors on the card
        self.shard = None             # (rank, world) of a sharded upload

    @staticmethod
    def build(dataset, time_padding_multiple: int = 1, num_workers: int = 0,
              max_bytes: int = 12 << 30):
        """One prefetched pass over the dataset; audio stored as int16 (exact
        for int16-sourced corpora, as the int16 transport is). Raises
        MemoryError past `max_bytes`."""
        from .loader import prefetch_map
        n = len(dataset)
        bucket_ids = np.asarray(dataset.bucket)
        items = prefetch_map(dataset.__getitem__, range(n), num_workers=num_workers)

        pos = np.zeros(n, np.int64)
        mult = max(time_padding_multiple, 1)
        staged = {}   # bucket -> [(dataset index, int16 row, targets)]
        for i, item in enumerate(items):
            _, _, x, *ys = item
            b = int(bucket_ids[i])
            x_row = np.asarray(x)
            if x_row.ndim == 2:      # (C, T) -> mono channel 0
                x_row = x_row[0]
            if x_row.dtype != np.int16:
                x_row = (np.clip(x_row, -1.0, 1.0) * SMAX).round().astype(np.int16)
            staged.setdefault(b, []).append((i, x_row, [np.asarray(t) for t in ys]))

        buckets_host, nbytes = {}, 0
        for b, rows in staged.items():
            T_b = max(int(math.ceil(max(r[1].shape[-1] for r in rows) / mult)) * mult, mult)
            H = len(rows[0][2])
            L_b = max(int(math.ceil(max(r[2][j].shape[-1] for r in rows) / mult)) * mult
                      for j in range(H)) if H else 1
            N_b = len(rows)
            x = np.zeros((N_b, T_b), np.int16)
            xlen = np.zeros((N_b,), np.float32)
            y = np.zeros((N_b, H, L_b), np.int32)
            ylen = np.zeros((N_b, H), np.int32)
            for r, (gi, x_row, ys) in enumerate(rows):
                pos[gi] = r
                x[r, :x_row.shape[-1]] = x_row
                xlen[r] = x_row.shape[-1] / T_b if T_b else 1.0
                for j, t in enumerate(ys):
                    y[r, j, :t.shape[-1]] = t
                    ylen[r, j] = len(t)
            buckets_host[b] = dict(x=x, xlen=xlen, y=y, ylen=ylen)
            nbytes += sum(a.nbytes for a in buckets_host[b].values())
        if nbytes > max_bytes:
            raise MemoryError(
                f'device cache would need {nbytes / 1e9:.1f} GB '
                f'(> {max_bytes / 1e9:.1f} GB cap) — train without --device-cache')
        log.info(f'device cache: {n} utterances, {len(buckets_host)} buckets, '
                 f'{nbytes / 1e6:.1f} MB resident')
        return DeviceDatasetCache(buckets_host, pos, bucket_ids, nbytes)

    def upload(self, device):
        """Every bucket to `device` (the replicated layout: each rank holds
        the whole cache); the host copy is freed."""
        for b, arrs in self.host.items():
            self.device[b] = {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}
        self.host = None
        return self

    def upload_sharded(self, rank: int, world: int, device):
        """Rank `rank` of `world` keeps rows [rank*N/W, (rank+1)*N/W) of each
        bucket, the bucket zero-padded to a multiple of W rows (padding rows
        are never referenced: `pos` maps only real utterances)."""
        for b, arrs in self.host.items():
            n = arrs['x'].shape[0]
            per = int(math.ceil(n / world))
            dev = {}
            for k, v in arrs.items():
                if per * world != n:
                    v = np.concatenate([v, np.zeros((per * world - n,) + v.shape[1:], v.dtype)])
                dev[k] = torch.from_numpy(np.ascontiguousarray(
                    v[rank * per:(rank + 1) * per])).to(device)
            self.device[b] = dev
        self.host = None
        self.shard = (rank, world)
        return self

    def locate(self, batch_indices):
        """Dataset indices -> (bucket id, int32 row indices). The bucketing
        sampler keeps a batch within one bucket."""
        idx = np.asarray(batch_indices)
        b = int(self.bucket_of[idx[0]])
        assert (self.bucket_of[idx] == b).all(), 'batch spans buckets'
        return b, self.pos[idx].astype(np.int32)


def gather_batch(cache, rows):
    """The batch of `rows` (a (B,) index tensor on the cache's device)."""
    return dict(x=cache['x'][rows], xlen=cache['xlen'][rows],
                y=cache['y'][rows], ylen=cache['ylen'][rows])


def sharded_gather(cache_blk, rows, rank: int, world: int, group=None):
    """This rank's batch from a cache uploaded with `upload_sharded`.

    rows: this rank's (B/W,) row indices within the bucket; rank, world: its
    data index and the count of data indices; group: the data group (None:
    the default group). Each rank takes
    the global (B,) row vector (an all-gather), gathers the rows it owns with
    zeros elsewhere, widened to int32 (a Gloo all-reduce has no int16 on
    every build), sums over the group and keeps its own B/W slice. O(B*T) a
    step, and exact: one rank only adds to any row."""
    import torch.distributed as dist
    # the row vector is tiny; Gloo all-gathers it on the host
    host = dist.get_backend(group) == 'gloo'
    local = rows.cpu() if host else rows.contiguous()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    rows_all = torch.cat(parts).to(rows.device)
    nloc = cache_blk['x'].shape[0]
    li = rows_all.to(torch.int64) - rank * nloc
    hit = (li >= 0) & (li < nloc)
    lic = li.clamp(0, nloc - 1)
    B, bl = rows_all.shape[0], rows.shape[0]
    out = {}
    for k, v in cache_blk.items():
        g = v[lic]
        dtype = g.dtype
        if g.dtype == torch.int16:
            g = g.to(torch.int32)
        g = torch.where(hit.reshape((B,) + (1,) * (g.ndim - 1)), g, torch.zeros_like(g))
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        out[k] = g[rank * bl:(rank + 1) * bl].to(dtype)
    return out
