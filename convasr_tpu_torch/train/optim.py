"""Optimizers and LR schedules in PyTorch (counterpart of
convasr_tpu/train/optim.py and the optax transformations it chains).

A transformation is a pair of functions over lists of tensors, as in optax:
`init(params) -> state` and `update(updates, state, params) -> (updates,
state)`, with the state a plain nested structure (dicts and lists) of tensors
on the parameters' device. Nothing is a `torch.optim` class: the train step
has to choose between the old and the new state on the device, without
reading a flag back to the host (train/loop.py), and that needs the state in
the open. The arithmetic is optax's, in the same order; the per-tensor sums
come from `torch._foreach_norm`, which agrees with optax's sums of squares to
float32 rounding.

NovoGrad keeps the reference's first step: ema := g^2 and momentum := the
normalised gradient, not scaled by (1 - beta1).

`make_optimizer`'s NovoGrad, with or without the global-norm clip in front
(`train/loop.make_optimizer_with_accum` with no mask and no accumulation),
carries `fused` (FusedNovoGrad): the same update as two CUDA kernels over
every leaf (ops/novograd_update.py), which the train step takes for CUDA
parameters; this chain is their plain version.

Under the tensor-parallel layout a sharded parameter's tensors are slices,
and a sum of squares over one is a partial sum: every per-tensor and global
norm (NovoGrad's EMA, LARC, the global-norm clip, the metrics) sums the
sharded tensors' partial sums over the model group and counts each
replicated one once (parallel/tensor_parallel.sum_sharded), where GSPMD
makes the JAX package's global. The tensors of an update are told apart by
the parameters they go with (`like`), which `update` receives.
"""
import dataclasses
import typing

import torch

from ..infra.utils import wide_float
from ..ops import novograd_update
from ..parallel import tensor_parallel


class GradientTransformation(typing.NamedTuple):
    init: typing.Callable
    update: typing.Callable
    # the same update over every leaf in place (FusedNovoGrad), on the
    # compositions that have one; None elsewhere
    fused: typing.Optional['FusedNovoGrad'] = None


def _device(params):
    return params[0].device if params else torch.device('cpu')


def _count(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _sq_norms(tensors, like=None) -> torch.Tensor:
    """(N,) float32 sums of squares of each tensor (float64 for float64
    tensors), whole over the model group; `like`: the parameters the tensors
    go with (default: the tensors themselves)."""
    if not tensors:
        return torch.zeros((0,))
    norms = torch._foreach_norm([wide_float(t) for t in tensors])
    return tensor_parallel.sum_sharded(torch.stack(norms) ** 2,
                                       like if like is not None else tensors)


def global_norm(tensors, like=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(_sq_norms(tensors, like).sum())


def tree_select(flag: torch.Tensor, new, old):
    """`new` where the 0-dim bool `flag` holds, else `old`, leaf by leaf."""
    if isinstance(new, dict):
        return {k: tree_select(flag, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(tree_select(flag, n, o) for n, o in zip(new, old))
    if torch.is_tensor(new):
        return torch.where(flag, new, old)
    return new


def _lr_value(learning_rate, count):
    """The rate at `count`: a Python number, or a 0-dim tensor on the device
    (never copied from the host inside a step)."""
    return learning_rate(count) if callable(learning_rate) else learning_rate


# --- transformations ---------------------------------------------------------

def identity():
    return GradientTransformation(lambda params: {}, lambda u, s, p=None: (u, s))


def chain(*transforms):
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state
    return GradientTransformation(init, update)


def scale(step_size: float):
    return GradientTransformation(
        lambda params: {}, lambda u, s, p=None: (torch._foreach_mul(u, step_size), s))


def scale_by_schedule(step_size_fn):
    """updates * step_size_fn(count); count counts this transformation's updates."""
    def init(params):
        return dict(count=_count(params))

    def update(updates, state, params=None):
        lr = _lr_value(step_size_fn, state['count'])
        return torch._foreach_mul(updates, lr), dict(count=state['count'] + 1)
    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate):
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def scale_by_novograd(betas=(0.95, 0.98), eps: float = 1e-8,
                      weight_decay: float = 0.0, dampening: bool = False):
    """NovoGrad (spec: the reference optimizers.py:66-90): per tensor, an EMA
    of sum(g^2) normalises the gradient; momentum over the result. Returns
    -momentum as the update."""
    b1, b2 = betas

    def init(params):
        return dict(step=_count(params),
                    grads_ema=torch.zeros((len(params),), dtype=torch.float64 if params and
                                          params[0].dtype == torch.float64 else torch.float32,
                                          device=_device(params)),
                    momentum=[torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        if not updates:
            return updates, dict(state, step=state['step'] + 1)
        first = state['step'] == 0
        g2 = _sq_norms(updates, params)
        ema = torch.where(first, g2, state['grads_ema'] * b2 + g2 * (1.0 - b2))
        d = torch._foreach_div(updates, list(torch.sqrt(ema + eps).unbind(0)))
        if weight_decay > 0:
            d = torch._foreach_add(d, torch._foreach_mul(params, weight_decay))
        if dampening:
            d = torch._foreach_mul(d, 1.0 - b1)
        # the first step's momentum is d itself: momentum is still 0 then, so
        # momentum * b1 + d == d
        momentum = torch._foreach_add(torch._foreach_mul(state['momentum'], b1), d)
        return torch._foreach_neg(momentum), dict(step=state['step'] + 1, grads_ema=ema,
                                                  momentum=momentum)
    return GradientTransformation(init, update)


def novograd(learning_rate, betas=(0.95, 0.98), eps: float = 1e-8,
             weight_decay: float = 0.0, dampening: bool = False):
    """NovoGrad with a schedule: the update is -lr * momentum."""
    return chain(scale_by_novograd(betas, eps, weight_decay, dampening),
                 scale_by_schedule(learning_rate) if callable(learning_rate)
                 else scale(learning_rate))


def larc(learning_rate_fn, mode: str = 'clip', eps: float = 1e-7,
         min_update: float = 1e-7, eta: float = 0.1):
    """Layer-wise adaptive rate clipping ('clip') or scaling of gradients
    (spec: optimizers.py:93-106); goes BEFORE the optimizer in a chain."""
    def init(params):
        return dict(count=_count(params))

    def update(updates, state, params=None):
        if not updates:
            return updates, dict(count=state['count'] + 1)
        lr = _lr_value(learning_rate_fn, state['count'])
        v_norm = torch.stack(torch._foreach_norm(params))
        g_norm = torch.stack(torch._foreach_norm(updates))
        if tensor_parallel.model_world() > 1:
            v_norm = torch.sqrt(tensor_parallel.sum_sharded(v_norm ** 2, params))
            g_norm = torch.sqrt(tensor_parallel.sum_sharded(g_norm ** 2, params))
        if mode == 'clip':
            s = torch.clamp(eta * v_norm / (lr * (g_norm + eps)), min_update, 1.0)
        else:
            s = torch.clamp(eta * v_norm / (g_norm + eps), min=min_update)
        return torch._foreach_mul(updates, list(s.unbind(0))), dict(count=state['count'] + 1)
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float):
    def update(updates, state, params=None):
        return torch._foreach_add(updates, torch._foreach_mul(params, weight_decay)), state
    return GradientTransformation(lambda params: {}, update)


def trace(decay: float, nesterov: bool = False):
    """Momentum: trace = g + decay * trace; the update is the trace, or
    g + decay * trace under Nesterov."""
    def init(params):
        return dict(trace=[torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        new_trace = torch._foreach_add(updates, torch._foreach_mul(state['trace'], decay))
        out = torch._foreach_add(updates, torch._foreach_mul(new_trace, decay)) \
            if nesterov else new_trace
        return out, dict(trace=new_trace)
    return GradientTransformation(init, update)


def sgd(learning_rate, momentum: typing.Optional[float] = None, nesterov: bool = False):
    return chain(trace(momentum, nesterov) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        return dict(count=_count(params), mu=[torch.zeros_like(p) for p in params],
                    nu=[torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        mu = torch._foreach_add(torch._foreach_mul(updates, 1 - b1),
                                torch._foreach_mul(state['mu'], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(updates, updates), 1 - b2),
                                torch._foreach_mul(state['nu'], b2))
        count = state['count'] + 1
        c = count.to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, c))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, c))
        out = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
        return out, dict(count=count, mu=mu, nu=nu)
    return GradientTransformation(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def clip_by_global_norm(max_norm: float):
    """u unchanged when the global norm is below max_norm, else
    (u / norm) * max_norm (optax's formula)."""
    def update(updates, state, params=None):
        norm = global_norm(updates, params)
        keep = norm < max_norm
        return [torch.where(keep, u, (u / norm) * max_norm) for u in updates], state
    return GradientTransformation(lambda params: {}, update)


def masked(inner, mask: typing.Sequence[bool]):
    """`inner` on the tensors where mask is True; the others pass unchanged.
    Its state is dict(trainable=their indices, inner=inner's state over
    them): the indices let the tensor-parallel layout map the state onto
    its parameters (parallel/tensor_parallel.gather_opt_state)."""
    index = [i for i, m in enumerate(mask) if m]

    def pick(xs):
        return [xs[i] for i in index] if xs is not None else None

    def update(updates, state, params=None):
        sub, inner_state = inner.update(pick(updates), state['inner'], pick(params))
        out = list(updates)
        for i, u in zip(index, sub):
            out[i] = u
        return out, dict(trainable=state['trainable'], inner=inner_state)
    return GradientTransformation(
        lambda params: dict(trainable=list(index), inner=inner.init(pick(params))), update)


def _is_masked(state) -> bool:
    return isinstance(state, dict) and set(state) == {'trainable', 'inner'}


def map_masked(state, params, fn):
    """A masked optimizer's state (see masked) with fn(inner state, the
    parameters it runs along) as its inner state; None where `state` is not
    one."""
    if not _is_masked(state):
        return None
    return dict(trainable=state['trainable'],
                inner=fn(state['inner'], [params[i] for i in state['trainable']]))


def _same_tree(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if torch.is_tensor(a) or torch.is_tensor(b):
        return torch.is_tensor(a) and torch.is_tensor(b) and a.shape == b.shape
    return True


def adopt_state(saved, fresh):
    """A checkpoint's optimizer state in the form of this run's (`fresh`,
    its optimizer's init). A masked optimizer's state saved before it kept
    its parameter indices holds the bare inner state: it takes fresh's
    indices where its tree is fresh's inner state's, else ValueError."""
    if _is_masked(fresh) and not _is_masked(saved):
        if not _same_tree(saved, fresh['inner']):
            raise ValueError('the checkpoint\'s optimizer state does not match this run\'s '
                             '--freeze-* mask (a masked optimizer\'s state of an older port '
                             'holds no parameter indices, and its tree differs from this run\'s)')
        return dict(trainable=fresh['trainable'], inner=saved)
    if isinstance(saved, dict) and isinstance(fresh, dict):
        return {k: adopt_state(v, fresh[k]) if k in fresh else v for k, v in saved.items()}
    if isinstance(saved, (list, tuple)) and isinstance(fresh, (list, tuple)) \
            and len(saved) == len(fresh):
        return type(saved)(adopt_state(s, f) for s, f in zip(saved, fresh))
    return saved


def set_to_zero():
    return GradientTransformation(lambda params: {},
                                  lambda u, s, p=None: ([torch.zeros_like(x) for x in u], s))


def multi_steps(inner, every_k: int):
    """Gradient accumulation (optax.MultiSteps): the running mean of k
    gradients; `inner` steps once every k calls, the other calls update
    nothing."""
    def init(params):
        return dict(mini_step=_count(params), gradient_step=_count(params),
                    inner=inner.init(params), acc=[torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        mini = state['mini_step']
        acc = torch._foreach_add(state['acc'], torch._foreach_div(
            torch._foreach_sub(updates, state['acc']), (mini + 1).to(torch.float32)))
        final, new_inner = inner.update(acc, state['inner'], params)
        emit = mini == every_k - 1
        keep = (~emit).to(torch.float32)
        new_state = dict(
            mini_step=(mini + 1) % every_k,
            gradient_step=state['gradient_step'] + emit.to(torch.int32),
            inner=tree_select(emit, new_inner, state['inner']),
            acc=torch._foreach_mul(acc, keep))
        return torch._foreach_mul(final, emit.to(torch.float32)), new_state
    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params += updates, in place."""
    with torch.no_grad():
        torch._foreach_add_(params, [u.to(p.dtype) for p, u in zip(params, updates)])


# --- step-based LR schedules (spec: optimizers.py:18-63) ----------------------

# A schedule maps the step (an int, or a 0-dim tensor on the device) to the
# rate, a Python float or a 0-dim float32 tensor on the step's device.

def noop_lr(base_lr: float):
    return lambda step: float(base_lr)


def multistep_lr(base_lr: float, gamma: float, milestones: typing.Sequence[int]):
    milestones = sorted(milestones)

    def schedule(step):
        step = torch.as_tensor(step)
        power = torch.zeros((), dtype=torch.float32, device=step.device)
        for m in milestones:
            power = power + (step >= m).to(torch.float32)
        return base_lr * torch.pow(gamma, power)
    return schedule


def polynomial_decay_lr(base_lr: float, decay_steps, power: float = 1.0,
                        begin_decay_at: int = 0, end_lr: float = 0.0,
                        warmup_steps: int = 0):
    """decay_steps may be a callable, read at each call (--decay-epochs binds
    batches-per-epoch late)."""
    def schedule(step):
        ds = decay_steps() if callable(decay_steps) else decay_steps
        step = torch.as_tensor(step).to(torch.float32)
        lr = torch.full_like(step, base_lr)
        if warmup_steps > 0:
            lr = torch.where(step < warmup_steps, base_lr * step / warmup_steps, lr)
        decay_pos = torch.clamp(step - begin_decay_at, min=0.0).clamp(max=ds)
        decayed = end_lr + (base_lr - end_lr) * ((ds - decay_pos) / ds) ** power
        return torch.where(step >= begin_decay_at, decayed, lr)
    return schedule


def make_optimizer(name: str, learning_rate, momentum: float = 0.9,
                   weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                   nesterov: bool = False):
    """SGD | AdamW | NovoGrad | FusedNovoGrad, as the JAX package builds them."""
    lr = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    name = name.lower()
    if name == 'sgd':
        return chain(add_decayed_weights(weight_decay) if weight_decay else identity(),
                     sgd(lr, momentum=momentum, nesterov=nesterov))
    if name == 'adamw':
        return adamw(lr, b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay)
    if name in ('novograd', 'fusednovograd'):
        return chain(scale_by_novograd(betas=betas, eps=eps, weight_decay=weight_decay),
                     scale_by_schedule(lr))._replace(
            fused=FusedNovoGrad(lr, tuple(betas), eps, weight_decay))
    raise ValueError(f'unknown optimizer {name}')


def holding(state, key):
    """The dict of the state tree that holds `key`, depth first; None where
    none does."""
    if isinstance(state, dict):
        if key in state:
            return state
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        for s in state:
            found = holding(s, key)
            if found is not None:
                return found
    return None


@dataclasses.dataclass(frozen=True)
class FusedNovoGrad:
    """make_optimizer's NovoGrad and its schedule, behind the global-norm clip
    where max_norm > 0, with the train step's non-finite skip and the apply,
    as one call over every leaf that updates the parameters and the state
    in place (ops/novograd_update.step); the state is the chain's own."""
    learning_rate: typing.Callable
    betas: tuple
    eps: float
    weight_decay: float
    max_norm: float = 0.0

    @staticmethod
    def parts(state):
        """(NovoGrad's state, the schedule's) in the chain's state, found by
        their keys."""
        novograd_state, schedule_state = holding(state, 'grads_ema'), holding(state, 'count')
        if novograd_state is None or schedule_state is None:
            raise ValueError('the optimizer state holds no NovoGrad and schedule state')
        return novograd_state, schedule_state

    def step(self, grads, state, params, finite, scratch):
        """The update, in place (`finite`: the 0-dim bool flag of the
        non-finite skip; `scratch`: ops/novograd_update.Scratch for the
        parameters); returns (grad_norm, weight_norm). ValueError where the
        kernels cannot take the tensors."""
        nv, schedule = self.parts(state)
        return novograd_update.step(
            scratch, grads, params, nv['momentum'], nv['grads_ema'], nv['step'],
            schedule['count'], _lr_value(self.learning_rate, schedule['count']), finite,
            self.betas, self.eps, self.weight_decay, self.max_norm)
