"""The tensor-parallel layout over the model group (counterpart of
convasr_tpu/parallel/mesh.state_shardings and of what GSPMD does with it).

The JAX package shards the trailing dim of every TrainState leaf that is at
least `min_channels` wide over the mesh's 'model' axis and lets GSPMD choose
the activation shardings, insert the collectives and make each per-leaf
reduction global. Here each of those is written out, one process a rank on
torch.distributed (parallel/mesh.make_groups):

- `state_shardings` is the JAX rule on the flax shape that models/convert.py
  maps to each torch name: the flax conv kernel (K, Cin, Cout) is torch's
  (Cout, Cin, K), so the trailing dim is dim 0 of a conv weight, and of a
  bias or a batch norm's weight, bias and running statistics.
- `shard_model_` keeps this rank's C / n_model rows of each sharded leaf.
  A sharded conv computes its own output channels; batch norm, the residual
  adds, the nonlinearity, dropout and the temporal mask are per channel, so
  a block's output stays sharded (models/jasper.py). Each consumer reads the
  whole activation (`Whole`): the next conv, a later block's 1x1 residual
  conv, the head.
- Megatron's pair of autograd functions on the model group: `gather_channels`
  (all-gather along the channels forward, this rank's slice backward) and
  `copy_to_model` (identity forward, all-reduce sum backward). A gathered
  activation feeds sharded convs, whose input gradients are partial sums,
  and replicated layers (a head narrower than `min_channels`, the loss),
  whose gradients are already whole on every rank: only the sharded
  consumers read it through `copy_to_model`, so the whole gradients are not
  counted n_model times.
- The per-leaf and global norms of train/optim.py sum the sharded leaves'
  partial sums of squares over the model group (`sum_sharded`), as GSPMD
  makes the JAX package's global.

Collectives: Gloo has no all-gather for CUDA tensors (and two ranks on one
card must run Gloo), so under Gloo a gather is an all-reduce sum of a
zero-filled full tensor into which each rank wrote its slice, exact since
every element is one rank's value plus zeros; under NCCL it is
`all_gather_into_tensor`.
"""
import typing

import torch
import torch.distributed as dist

from . import mesh

# parts of a model the layout does not cover: a leaf of theirs that the rule
# would shard raises
_UNSUPPORTED = (('frontend.', 'the learned frontend (Wav2VecFrontend)'),
                ('decoder.bpe_conv', "the BPE head's ConvBn"))


def _flax_shape(name: str, shape: typing.Sequence[int]) -> typing.Optional[tuple]:
    """The shape of the flax leaf that models/convert.from_jax_params maps to
    the torch leaf `name`; None for a leaf with no flax counterpart
    (num_batches_tracked, the log-mel frontend's constants)."""
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'weight' and len(shape) == 3:          # kernel (K, Cin/g, Cout)
        return tuple(shape)[::-1]
    if leaf in ('weight', 'bias', 'running_mean', 'running_var'):
        return tuple(shape)
    return None


def state_shardings(model: torch.nn.Module, n_model: int,
                    min_channels: int = 256) -> typing.Dict[str, typing.Optional[int]]:
    """{parameter or buffer name: the torch dim sharded over the model group,
    or None (replicated)}: the JAX rule (a trailing flax dim >= min_channels
    and divisible by n_model) on the flax shape of each leaf. The optimizer
    state follows its parameter (NovoGrad's momentum is sharded with it, its
    (N,) per-leaf EMA replicated, as JAX's per-leaf scalars are).

    Raises ValueError naming the leaf where the rule shards a part the port's
    sharded forward does not cover: the learned frontend, the BPE head,
    grouped or separable convs, a model built with `remat`."""
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    convs = {name: m for name, m in model.named_modules() if isinstance(m, torch.nn.Conv1d)}
    layout = {}
    for name, t in tensors.items():
        shape = _flax_shape(name, t.shape) if t.ndim else None
        if n_model > 1 and shape and shape[-1] >= min_channels and shape[-1] % n_model == 0:
            _check_supported(model, name, convs.get(name.rsplit('.', 1)[0]))
            # the flax trailing dim: dim 0 of a transposed conv kernel, the
            # last (the only) dim of a vector
            layout[name] = 0 if t.ndim == 3 else t.ndim - 1
        else:
            layout[name] = None
    return layout


def _check_supported(model, name, conv):
    for prefix, what in _UNSUPPORTED:
        if name.startswith(prefix):
            raise ValueError(f'{name}: {what} has no tensor-parallel layout in the port')
    if conv is not None and (conv.groups > 1 or name.rsplit('.', 2)[-2] in ('depthwise',
                                                                           'pointwise')):
        raise ValueError(f'{name}: grouped or separable convs have no tensor-parallel layout')
    if getattr(model, 'remat', False):
        raise ValueError(f'{name}: a model built with remat (--remat) has no tensor-parallel '
                         f'layout')


# ------------------------------------------------------------------ collectives

def model_world() -> int:
    return mesh.grid().n_model


def _slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of `t` along `dim`."""
    g = mesh.grid()
    n = t.shape[dim] // g.n_model
    return t.narrow(dim, g.model_index * n, n)


def local_channels(t: torch.Tensor) -> torch.Tensor:
    """This rank's channels of a whole (B, C, ...) activation."""
    return _slice(t, 1)


def all_gather_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's chunks of `t` concatenated along `dim`, in model
    index order (no autograd)."""
    g = mesh.grid()
    if g.n_model == 1:
        return t
    t = t.contiguous()
    if dist.get_backend(g.model) == 'nccl':
        out = torch.empty((g.n_model,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=g.model)
        return torch.cat(out.unbind(0), dim=dim)
    # Gloo (the CPU, and several ranks on one card): no all-gather of CUDA
    # tensors, so a sum of zero-filled full tensors, each holding one slice
    shape = list(t.shape)
    shape[dim] *= g.n_model
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    _slice(out, dim).copy_(t)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g.model)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=mesh.grid().model)
        return grad


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_gather_dim(x, 1)

    @staticmethod
    def backward(ctx, grad):
        return local_channels(grad).contiguous()


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the model group
    (Megatron's f): the input of a sharded conv."""
    return _CopyToModel.apply(x)


def gather_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, C / n_model, ...) -> (B, C, ...) over the model group; the
    backward keeps this rank's slice of the (whole) gradient (Megatron's g)."""
    return _GatherChannels.apply(x)


class Whole:
    """An activation whole on every model rank, for its consumers: `local`
    as its block computed it, `full` (gathered once where `local` is
    sharded) for replicated consumers, and `feed(True)` (copy_to_model of
    `full`, made once) for the sharded convs, so that one all-reduce in the
    backward sums all their partial input gradients."""

    def __init__(self, local: torch.Tensor, sharded: bool):
        self.local = local
        self.full = gather_channels(local) if sharded else local
        self._copy = None

    def feed(self, sharded: bool) -> torch.Tensor:
        if not sharded:
            return self.full
        if self._copy is None:
            self._copy = copy_to_model(self.full)
        return self._copy


# ------------------------------------------------------------ the sharded model

def sharded_dim(t) -> typing.Optional[int]:
    """The dim a parameter is sharded along (`shard_model_`), or None."""
    return getattr(t, 'tp_dim', None)


def is_sharded(model: torch.nn.Module) -> bool:
    return bool(getattr(model, 'tp_layout', None))


def shard_model_(model: torch.nn.Module, layout: typing.Dict[str, typing.Optional[int]],
                 groups: typing.Optional[mesh.Grid] = None) -> torch.nn.Module:
    """In place: each leaf that `layout` shards keeps this rank's C / n_model
    rows (its model index's), marked with `tp_dim`; every ConvBn and the head
    learn whether their output channels are sharded. `groups` is
    mesh.make_groups' grid (default: the current one). A block whose leaves
    disagree raises ValueError."""
    from ..models.jasper import ConvBn, Decoder
    groups = groups if groups is not None else mesh.grid()
    if groups.n_model == 1:
        return model
    blocks = {}
    for prefix, m in model.named_modules():
        if isinstance(m, (ConvBn, Decoder)):
            own = prefix + ('.head0.' if isinstance(m, Decoder) else '.')
            kinds = {d is not None for n, d in layout.items()
                     if n.startswith(own) and not n.endswith('num_batches_tracked')}
            if len(kinds) > 1:
                raise ValueError(f'{prefix}: its leaves are sharded in part')
            blocks[m] = kinds.pop() if kinds else False
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    with torch.no_grad():
        for name, dim in layout.items():
            if dim is not None:
                t = tensors[name]
                t.data = _slice(t.data, dim).clone()
                if isinstance(t, torch.nn.Parameter):
                    t.tp_dim = dim
    for m, sharded in blocks.items():
        m.tp = sharded
    model.tp_layout = dict(layout)
    return model


def gather_state(model: torch.nn.Module) -> dict:
    """The whole state_dict of a sharded model, on every rank (each rank must
    call it). The state_dict itself where the model is not sharded."""
    sd = model.state_dict()
    layout = getattr(model, 'tp_layout', None) or {}
    return {k: all_gather_dim(v, layout[k]) if layout.get(k) is not None else v
            for k, v in sd.items()}


def load_sharded_(model: torch.nn.Module, state_dict: dict):
    """Loads a whole state_dict (a one-process checkpoint, or gather_state's)
    into a sharded model: each sharded leaf takes this rank's slice."""
    layout = getattr(model, 'tp_layout', None) or {}
    model.load_state_dict({k: _slice(v, layout[k]) if layout.get(k) is not None else v
                           for k, v in state_dict.items()})
    return model


def _map_per_param(opt_state, params, fn, whole: bool):
    """fn(tensor, param) on each tensor of the optimizer state's lists that
    run along the parameters (momentum, trace, moments, accumulators); the
    other leaves (counts, NovoGrad's (N,) EMA) pass unchanged. `whole`: the
    state holds whole tensors (a checkpoint's) rather than this rank's."""
    n = model_world()

    def shape(p):
        s = list(p.shape)
        if whole and sharded_dim(p) is not None:
            s[sharded_dim(p)] *= n
        return s

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if node and all(torch.is_tensor(t) for t in node):
                if len(node) == len(params) and all(list(t.shape) == shape(p)
                                                    for t, p in zip(node, params)):
                    return type(node)(fn(t, p) for t, p in zip(node, params))
                raise ValueError('optimizer state not aligned with the parameters (a masked '
                                 'optimizer, --freeze-*): no tensor-parallel layout for it')
            return type(node)(walk(v) for v in node)
        return node
    return walk(opt_state)


def gather_opt_state(opt_state, params):
    """The optimizer state with every sharded parameter's tensors whole (each
    rank must call it)."""
    return _map_per_param(opt_state, params, lambda t, p: all_gather_dim(t, sharded_dim(p))
                          if sharded_dim(p) is not None else t, whole=False)


def shard_opt_state(opt_state, params):
    """A whole optimizer state (a checkpoint's) cut to this rank's slices."""
    return _map_per_param(opt_state, params, lambda t, p: _slice(t, sharded_dim(p)).clone()
                          if sharded_dim(p) is not None else t, whole=True)


# ---------------------------------------------------------------------- norms

def sum_sharded(sq: torch.Tensor, like: typing.Sequence[torch.Tensor]) -> torch.Tensor:
    """(N,) per-tensor sums of squares (or any per-tensor sums) made global:
    the entries of sharded tensors (`like[i]`, the parameter each one belongs
    to) summed over the model group, the replicated ones counted once."""
    if model_world() == 1:
        return sq
    flags = [sharded_dim(p) is not None for p in like]
    if not any(flags):
        return sq
    mask = torch.tensor(flags, device=sq.device)
    part = torch.where(mask, sq, torch.zeros_like(sq))
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.grid().model)
    return torch.where(mask, part, sq)


def broadcast_replicated_(grads: typing.Sequence[torch.Tensor],
                          params: typing.Sequence[torch.Tensor]):
    """In place: the replicated parameters' gradients take the model group's
    first rank's values. They are computed from the same whole tensors on
    every model rank and agree already where the arithmetic is deterministic
    (the CPU); a card's convolution backward need not be, and replicated
    parameters must not drift apart over steps."""
    g = mesh.grid()
    rep = [t for t, p in zip(grads, params) if sharded_dim(p) is None]
    if g.n_model == 1 or not rep:
        return grads
    flat = torch._utils._flatten_dense_tensors(rep)
    dist.broadcast(flat, src=dist.get_global_rank(g.model, 0), group=g.model)
    for t, r in zip(rep, torch._utils._unflatten_dense_tensors(flat, rep)):
        t.copy_(r)
    return grads
