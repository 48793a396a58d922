"""Training and evaluation steps in PyTorch (counterpart of
convasr_tpu/train/loop.py).

The step is the JAX package's: forward in training mode, CTC loss per head
normalised by the first head's target length (on the CUDA kernels for CUDA
tensors, through ops/ctc_loss.ctc_loss_auto), optional blank penalty,
gradients, global-norm clip, optimizer, and a skip of any step whose loss is
not finite. The skip keeps parameters, optimizer state and batch-norm
statistics as they were and zeroes the gradients, choosing on the device
(`torch.where` on a 0-dim flag) so that the step never waits for the host.

Where JAX returns a new state, the port updates the model's parameters and
buffers in place and returns the new optimizer state in `TrainState`.

Over a process group of world > 1 (parallel/mesh.py), each rank's loss is the
mean over its B/W rows, and one all-reduce after the backward averages the
gradients, the loss and the entropy over the ranks: the mean over the global
batch of B rows, because every rank feeds the same count of rows. The clip
and the optimizer then run on the same averaged gradient on every rank.
Under the tensor-parallel layout (parallel/tensor_parallel.py) that mean is
over the data group: a sharded leaf's gradient is its rank's slice, which
the data group's ranks share; a replicated leaf's gradient is whole and the
same on every rank of the model group. The norms of the clip, of NovoGrad
and of the metrics are global over the model group (train/optim.py).
"""
import contextlib
import dataclasses
import math
import typing

import torch

from ..infra.utils import wide_float
from ..models.jasper import BatchNorm, ConvBn
from ..ops.ctc_loss import ctc_loss_auto
from ..parallel import mesh, tensor_parallel
from . import optim


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: typing.Any


def entropy(log_probs, lengths=None, dim=-1, eps=1e-9):
    """Mean per-frame posterior entropy; log_probs (B, T, C), lengths (B,)."""
    e = -torch.sum(torch.exp(log_probs) * log_probs, dim=dim)
    if lengths is None:
        return e.mean(dim=-1)
    mask = torch.arange(e.shape[-1], device=e.device)[None, :] < lengths[:, None]
    return torch.sum(e * mask, dim=-1) / (eps + lengths.to(e.dtype))


def weighted_mean_entropy(log_probs, lengths=None, eps=1e-9, eps_id=-1):
    """Entropy weighted by 1 - p(blank) per frame: a CER-correlated measure of
    uncertainty. eps_id is the blank class (-1 = last)."""
    prob = torch.exp(log_probs)
    e = -torch.sum(prob * log_probs, dim=-1)
    weights = 1.0 - prob[..., eps_id]
    if lengths is not None:
        weights = weights * (torch.arange(e.shape[-1], device=e.device)[None, :]
                             < lengths[:, None])
    return torch.sum(e * weights, dim=-1) / (eps + torch.sum(weights, dim=-1))


def margin(log_probs, axis=-1):
    """Top-1 minus top-2 posterior probability per frame."""
    top2 = torch.topk(torch.exp(log_probs), 2, dim=axis).values
    return top2[..., 0] - top2[..., 1]


MULAW_MU = 255.0


def undo_int16_transport(x):
    """Audio may ride to the device as int16 PCM (/32767 here) or as 8-bit
    mu-law (mu = 255); float input passes through."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) / 32767.0
    if x.dtype == torch.uint8:
        y = (x.to(torch.float32) - 128.0) / 127.0
        return torch.sign(y) * (torch.exp(torch.abs(y) * math.log1p(MULAW_MU)) - 1.0) / MULAW_MU
    return x


def compute_losses(outputs, y, ylen, bpe_only: bool = False):
    """Per-utterance CTC loss summed over heads, each divided by the FIRST
    head's target length."""
    losses = []
    for i, lp in enumerate(outputs['log_probs']):
        li = ctc_loss_auto(lp, y[:, i], outputs['olen'][i], ylen[:, i], blank=lp.shape[-1] - 1)
        losses.append(li / torch.clamp(ylen[:, 0].to(li.dtype), min=1.0))
    return sum(losses[1:]) if bpe_only and len(losses) > 1 else sum(losses)


def freeze_mask(model: torch.nn.Module, freeze_backbone: int = 0,
                freeze_decoder0: bool = False, freeze_frontend: bool = False):
    """One bool per parameter of model.parameters(): True = trainable. Freezes
    the first N backbone blocks, the char head and/or a learned frontend."""
    def trainable(name):
        if any(name.startswith(f'block{i}.') for i in range(freeze_backbone)):
            return False
        if freeze_decoder0 and name.startswith('decoder.head0.'):
            return False
        return not (freeze_frontend and name.startswith('frontend.'))
    return [trainable(name) for name, _ in model.named_parameters()]


def make_optimizer_with_accum(base_optimizer, max_grad_norm: float = 0.0,
                              accumulate_steps: int = 1, trainable_mask=None):
    """Frozen parameters get zero updates, then the global-norm clip, then
    accumulation over `accumulate_steps` (the mean of the gradients)."""
    tx = base_optimizer
    if trainable_mask is not None:
        tx = optim.chain(optim.masked(tx, trainable_mask),
                         optim.masked(optim.set_to_zero(), [not t for t in trainable_mask]))
    if max_grad_norm and max_grad_norm > 0:
        tx = optim.chain(optim.clip_by_global_norm(max_grad_norm), tx)
    if accumulate_steps > 1:
        tx = optim.multi_steps(tx, accumulate_steps)
    return tx


def init_train_state(model: torch.nn.Module, optimizer) -> TrainState:
    return TrainState(step=0, opt_state=optimizer.init(list(model.parameters())))


def _batch_norms(model):
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def make_train_step(model: torch.nn.Module, optimizer, bpe_only: bool = False,
                    skip_nonfinite: bool = True, blank_penalty: float = 0.0):
    """Returns train_step(state, batch, generator=None) -> metrics, a dict of
    0-dim tensors on the device (loss, entropy, grad_norm, weight_norm,
    finite); the model and `state` are updated in place.

    batch: dict(x (B, T) audio, float or int16/uint8 transport, xlen (B,)
    fractions, y (B, H, L), ylen (B, H)), on the model's device. `generator`
    draws the dropout masks and the dither.

    blank_penalty > 0 adds penalty * (mean p(blank) over valid frames) to the
    loss: a remedy for peaky CTC, whose long blank runs inside words decode
    as word boundaries."""
    params = list(model.parameters())
    norms = _batch_norms(model)

    def train_step(state: TrainState, batch, generator=None):
        model.train()
        stats = [(m.running_mean.clone(), m.running_var.clone()) for m in norms] \
            if skip_nonfinite else []
        outputs = model(undo_int16_transport(batch['x']), xlen=batch['xlen'],
                        generator=generator)
        loss = compute_losses(outputs, batch['y'], batch['ylen'], bpe_only=bpe_only).mean()
        lp0, olen0 = outputs['log_probs'][0], outputs['olen'][0]
        if blank_penalty:
            mask = torch.arange(lp0.shape[1], device=lp0.device)[None, :] < olen0[:, None]
            p_blank = torch.exp(wide_float(lp0[..., -1]))
            loss = loss + blank_penalty * torch.sum(p_blank * mask) \
                / torch.clamp(mask.sum(), min=1)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            ent = entropy(lp0, olen0).mean()
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            grid = mesh.grid()
            if grid.n_data > 1:
                # one all-reduce: the mean over the data indices of the
                # gradients, the loss and the entropy, so every rank takes
                # the same step (and skips it together) and logs the global
                # batch's loss
                loss, ent = loss.detach().reshape(1), ent.reshape(1)
                mesh.all_reduce_mean_(grads + [loss, ent], grid.data, grid.n_data)
                loss, ent = loss[0], ent[0]
            tensor_parallel.broadcast_replicated_(grads, params)
            finite = torch.isfinite(loss)
            if skip_nonfinite:
                grads = [torch.where(finite, g, 0.0) for g in grads]
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
            if skip_nonfinite:
                # updates made from zeroed gradients are finite, so a product
                # with the 0/1 flag keeps or drops them exactly
                updates = torch._foreach_mul(updates, finite.to(torch.float32))
                opt_state = optim.tree_select(finite, opt_state, state.opt_state)
                for m, (mean, var) in zip(norms, stats):
                    m.running_mean.copy_(torch.where(finite, m.running_mean, mean))
                    m.running_var.copy_(torch.where(finite, m.running_var, var))
            optim.apply_updates(params, updates)
            state.opt_state = opt_state
            state.step += 1
            return dict(loss=loss.detach(), entropy=ent,
                        grad_norm=optim.global_norm(grads, like=params),
                        weight_norm=optim.global_norm(params),
                        finite=finite.to(torch.float32))

    return train_step


def make_eval_step(model: torch.nn.Module, bpe_only: bool = False, forward_x_only: bool = False):
    """Returns eval_step(batch) -> (outputs, metrics), in eval mode without
    gradients; forward_x_only drops the xlen masks (a masking debug flag)."""
    def eval_step(batch):
        model.eval()
        with torch.no_grad():
            outputs = model(undo_int16_transport(batch['x']),
                            xlen=None if forward_x_only else batch['xlen'])
            metrics = {}
            if batch.get('y') is not None:
                metrics['loss'] = compute_losses(outputs, batch['y'], batch['ylen'],
                                                 bpe_only=bpe_only)
            lp0, olen0 = outputs['log_probs'][0], outputs['olen'][0]
            metrics['entropy'] = entropy(lp0, olen0)
            metrics['uncertainty'] = weighted_mean_entropy(lp0, olen0)
        return outputs, metrics
    return eval_step


def reset_bn_stats(model: torch.nn.Module):
    """Zero means and unit variances in every batch norm."""
    with torch.no_grad():
        for m in _batch_norms(model):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def bn_stats(model: torch.nn.Module) -> dict:
    """Copies of the running statistics of every batch norm, by buffer name."""
    return {name: buf.detach().clone() for name, buf in model.named_buffers()
            if name.endswith(('running_mean', 'running_var'))}


def load_bn_stats(model: torch.nn.Module, stats: dict):
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in stats.items():
            buffers[name].copy_(value)


@contextlib.contextmanager
def _adapting(model):
    """Training mode with no dropout, and batch norms that take the batch's
    statistics whole (momentum 1); both restored after. The callers pass no
    generator, so the model applies no SpecAugment and no dither."""
    blocks = [m for m in model.modules() if isinstance(m, ConvBn)]
    norms = _batch_norms(model)
    saved = (model.training, [b.dropout for b in blocks], [m.momentum for m in norms])
    model.train()
    for b in blocks:
        b.dropout = 0.0
    for m in norms:
        m.momentum = 1.0
    try:
        yield
    finally:
        model.train(saved[0])
        for b, rate in zip(blocks, saved[1]):
            b.dropout = rate
        for m, momentum in zip(norms, saved[2]):
            m.momentum = momentum


def make_bn_adapt_step(model: torch.nn.Module):
    """Re-estimates the batch norms' running statistics on adaptation batches
    (--adapt-bn): the JAX package's equal-weight average over the batches of
    each batch's statistics (mean, biased variance), taken in training mode
    without dropout, SpecAugment or dither.

    Returns adapt_step(avg_stats, n, batch) -> avg_stats: `n` counts the
    batches from 1, and `avg_stats` (bn_stats' layout) is overwritten at
    n = 1. The model's running statistics are left at the batch's; load the
    average with load_bn_stats."""
    def adapt_step(avg_stats, n, batch):
        with torch.no_grad(), _adapting(model):
            model(undo_int16_transport(batch['x']), xlen=batch['xlen'])
        current = bn_stats(model)
        return {name: avg + (current[name] - avg) / n for name, avg in avg_stats.items()}
    return adapt_step
