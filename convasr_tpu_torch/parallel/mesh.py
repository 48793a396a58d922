"""Several processes on torch.distributed (counterpart of
convasr_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a `jax.sharding.Mesh`: the batch
is sharded over the 'data' axis and GSPMD inserts the gradient psum and makes
the batch-norm statistics global. The port runs one process a card, PyTorch's
idiom: each process feeds its own rows of the global batch
(`process_local_batch_slice`), batch norm all-reduces its statistics over the
process group (models/jasper.BatchNorm, through `all_reduce_sum`), and the
train step all-reduces the flattened gradients (train/loop.py). So
`make_mesh`, `batch_sharding`, `replicated`, `shard_batch` and
`make_global_batch` have no counterpart here: no process ever holds another
process's rows.

The JAX package's data x model mesh (`make_mesh(n_data, n_model)`) is a grid
of process groups here (`make_groups`): rank r has data index r // n_model
and model index r % n_model, the row-major order of the JAX mesh. The data
group (one model index) takes the batch's rows, the gradient mean and the
batch-norm statistics; the model group (one data index) shares one data
shard and holds the channels that `state_shardings` splits over it
(parallel/tensor_parallel.py). Without `make_groups` every rank is its own
data index and the model group has one member.

Collectives on tensors run on the default group: NCCL across cards, Gloo on
the CPU and for several ranks on one card (NCCL refuses two ranks on one
device). Host-side control (`barrier`, `allgather_bytes`, `any_flag`) runs on
a Gloo group of its own, so that it never waits on the card.

Inference over several cards in one process (`transcribe --data-parallel`,
`benchmark --data-parallel`) needs no process group: `split_rows` pads the
batch to a multiple of the card count, runs one chunk a card and gathers the
results on the first card.
"""
import datetime
import socket
import typing

import numpy as np
import torch
import torch.distributed as dist

_CONTROL = None   # the Gloo group of the host-side collectives


class Grid(typing.NamedTuple):
    """This rank's place in the data x model grid of `make_groups`."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data: typing.Any      # the data group (None: the default group)
    model: typing.Any     # the model group (None at n_model 1)


_GRID: typing.Optional[Grid] = None


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     timeout: typing.Optional[float] = None,
                     backend: typing.Optional[str] = None, device=None):
    """Joins the process group of `num_processes` ranks as rank `process_id`.

    coordinator_address: 'host:port' (rendezvous over tcp://), or an
    init_method URL as it is ('tcp://...', 'file://...'). backend None is
    NCCL when `device` is a CUDA device, else Gloo; several ranks on one card
    need backend 'gloo' (NCCL refuses them, and so does this function, after
    every rank has said which card of which host it holds). timeout
    (seconds) is the group's timeout, the JAX CLI's
    --synchronization-timeout. Raises when the group cannot be formed."""
    global _CONTROL
    device = torch.device(device) if device is not None else torch.device('cpu')
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    init_method = coordinator_address if '://' in coordinator_address \
        else f'tcp://{coordinator_address}'
    kw = dict(timeout=datetime.timedelta(seconds=timeout)) if timeout else {}
    # no device_id: NCCL's communicator is made at the first collective, so
    # that a shared card is refused below before NCCL sees it
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kw)
    _CONTROL = dist.new_group(backend='gloo', **kw) if backend != 'gloo' else None
    if backend == 'nccl':
        card = device.index if device.index is not None else torch.cuda.current_device()
        cards = [None] * num_processes
        dist.all_gather_object(cards, (socket.gethostname(), card), group=_CONTROL)
        try:
            check_own_cards(cards)
        except ValueError:
            shutdown()
            raise
    return backend


def check_own_cards(cards: typing.Sequence[typing.Tuple[str, int]]):
    """Raises unless every rank's (host, card index) is its own: NCCL takes
    one rank a card."""
    shared = sorted({c for c in cards if list(cards).count(c) > 1})
    if shared:
        raise ValueError(f'NCCL needs a card per rank, and ranks share {shared}: several ranks '
                         f'on one card run with --backend gloo')


def shutdown(wait: bool = False):
    """Leaves the process group (a no-op without one); with `wait`, after a
    barrier, so that no rank tears the group down under a peer that is still
    in a collective."""
    global _CONTROL, _GRID
    if dist.is_available() and dist.is_initialized():
        if wait:
            barrier('shutdown')
        dist.destroy_process_group()
    _CONTROL = _GRID = None


def make_groups(n_model: int) -> Grid:
    """The data x model grid over the process group (the counterpart of
    convasr_tpu/parallel/mesh.make_mesh(n_data, n_model)): n_data = world /
    n_model; rank r has data index r // n_model and model index r % n_model.
    Every rank makes every group (dist.new_group is collective) and keeps its
    own. Raises unless n_model divides the world size."""
    global _GRID
    W = world()
    if n_model < 1 or W % n_model:
        raise ValueError(f'n_model {n_model} does not divide the world size {W}')
    n_data, r = W // n_model, rank()
    data = model = None
    if n_model > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            data = g if m == r % n_model else data
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            model = g if d == r // n_model else model
    _GRID = Grid(n_data, n_model, r // n_model, r % n_model, data, model)
    return _GRID


def grid() -> Grid:
    """This rank's place in the grid: `make_groups`', else every rank its own
    data index on the default group, and a model group of one."""
    return _GRID if _GRID is not None else Grid(world(), 1, rank(), 0, None, None)


def data_world() -> int:
    """The number of data indices (the 'data' axis of the JAX mesh)."""
    return grid().n_data


def data_index() -> int:
    return grid().data_index


def active() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world() -> int:
    """The number of processes (jax.process_count())."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (jax.process_index())."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_local_batch_slice(global_batch_size: int) -> slice:
    """Which rows of the global batch this process feeds: its data index's
    share (the model ranks of a data index feed the same rows)."""
    per_process = global_batch_size // data_world()
    start = data_index() * per_process
    return slice(start, start + per_process)


def barrier(name: str = 'convasr'):
    """Cross-process sync point, a no-op at world 1. `name` is kept for the
    JAX signature."""
    if active():
        dist.barrier(group=_CONTROL)


def allgather_bytes(data: bytes) -> typing.List[bytes]:
    """A variable-length byte blob from every process, in rank order: the
    lengths first, then the payloads zero-padded to the longest, then each
    stripped to its length."""
    if not (dist.is_available() and dist.is_initialized()):
        return [data]
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world())]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64), group=_CONTROL)
    lens = [int(n) for n in lens]
    m = max(max(lens), 1)
    buf = torch.zeros(m, dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else buf[:0]
    parts = [torch.empty(m, dtype=torch.uint8) for _ in range(world())]
    dist.all_gather(parts, buf, group=_CONTROL)
    return [bytes(p[:n].numpy().tobytes()) for p, n in zip(parts, lens)]


def any_flag(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (a SIGTERM that reached
    one rank); a host-side collective that never waits on the card."""
    if not active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CONTROL)
    return bool(t.item())


def all_max(values: typing.Sequence[int]) -> typing.List[int]:
    """Each integer's maximum over the ranks (host-side)."""
    if not active():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CONTROL)
    return t.tolist()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over `group` (None: the default group): the
    gradient of the sum is the sum over the ranks of their gradients. The
    batch-norm statistics' reduction, over the data group."""
    return _AllReduceSum.apply(t, group)


def all_reduce_mean_(tensors: typing.Sequence[torch.Tensor], group=None,
                     size: typing.Optional[int] = None):
    """In place: each tensor becomes its mean over the `size` ranks of
    `group` (None: over the default group's), in one collective over the
    flattened tensors."""
    size = size if size is not None else world()
    if size < 2 or not tensors:
        return tensors
    flat = torch._utils._flatten_dense_tensors(list(tensors))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(size)
    for t, r in zip(tensors, torch._utils._unflatten_dense_tensors(flat, list(tensors))):
        t.copy_(r)
    return tensors


def local_rank(process_id: int, local_ranks=None) -> int:
    """The card of `process_id`: --local-ranks[process_id] where given, else
    process_id modulo the visible cards."""
    if local_ranks:
        return int(local_ranks[process_id])
    return process_id % max(torch.cuda.device_count(), 1)


# ---------------------------------------------------------- data-parallel inference

def inference_devices(device) -> typing.List[torch.device]:
    """The devices `--data-parallel` spreads a batch over: `device` (where the
    model is) first, then every other visible card under CUDA; the one CPU
    device otherwise."""
    device = torch.device(device)
    if device.type == 'cuda':
        first = device.index if device.index is not None else torch.cuda.current_device()
        return [torch.device('cuda', first)] + [torch.device('cuda', i) for i in
                                                 range(torch.cuda.device_count()) if i != first]
    return [device]


def pad_rows(n: int, *arrays, fill=(0,)):
    """Each array (leading dim B) zero-padded to a multiple of n rows;
    `fill` gives each array's pad value (the last repeats). Returns
    (B, padded arrays)."""
    B = arrays[0].shape[0]
    Bp = -(-B // n) * n
    out = []
    for k, a in enumerate(arrays):
        v = fill[min(k, len(fill) - 1)]
        if Bp != B:
            pad = torch.full((Bp - B,) + tuple(a.shape[1:]), v, dtype=a.dtype, device=a.device) \
                if torch.is_tensor(a) else np.full((Bp - B,) + a.shape[1:], v, a.dtype)
            a = torch.cat([a, pad]) if torch.is_tensor(a) else np.concatenate([a, pad])
        out.append(a)
    return B, out


def split_rows(fn, devices, x, xlen, *rest):
    """fn(k, x_k, xlen_k, *rest) on one chunk of rows a device, chunk k on
    devices[k]; the batch zero-padded to a multiple of len(devices) (padding
    rows have xlen 1, as in the JAX package). Each chunk is launched before
    the next (launches are asynchronous, so the cards overlap), the results
    (tensors or tuples of tensors) are gathered on devices[0] and sliced back
    to the batch's rows. One device calls fn on the whole batch."""
    if len(devices) == 1:
        return fn(0, x, xlen, *rest)
    B, (x, xlen) = pad_rows(len(devices), x, xlen, fill=(0, 1))
    n = x.shape[0] // len(devices)
    outs = [fn(k, x[k * n:(k + 1) * n].to(d, non_blocking=True),
               xlen[k * n:(k + 1) * n].to(d, non_blocking=True), *rest)
            for k, d in enumerate(devices)]
    first = devices[0]
    if torch.is_tensor(outs[0]):
        return torch.cat([o.to(first) for o in outs])[:B]
    return tuple(torch.cat([o[j].to(first) for o in outs])[:B] for j in range(len(outs[0])))
