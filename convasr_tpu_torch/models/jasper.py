"""JasperNet / Wav2Letter convolutional CTC acoustic models in PyTorch
(counterpart of convasr_tpu/models/jasper.py).

Module names follow the flax tree (`block{i}.conv{r}.conv`, `bn{r}`,
`conv_residual{j}`, `bn_residual{j}`, `decoder.head0`), so models/convert.py
maps a JAX checkpoint onto the state_dict key by key. Tensors are (B, T, C) at
the model's boundary as in the JAX package; inside the backbone they are
(B, C, T), the layout of torch's Conv1d. Parameters live in float32; convs
compute in `dtype` (bfloat16 by default in the CLI), batch norm and instance
norm in float32, log_softmax in float32, as the JAX dtypes do. A model made
with dtype float64 and `.double()` runs all of it in float64 (the tests' exact
reference).

In training mode (`model.train()`) batch norm normalises with the batch's
statistics and updates its running statistics as flax does, dropout is on,
the frontend dithers and, with `spec_augment`, SpecAugment masks the
normalised features. The random numbers of dropout, dither and SpecAugment
come from the `torch.Generator` passed to `forward`, so a run can be repeated
and resumed exactly; they cannot equal the JAX package's bits.

With `remat`, each block's activations are recomputed in the backward pass
(torch.utils.checkpoint) instead of kept, where the JAX package wraps ConvBn
in nn.remat. The recompute replays the generator from the state it had when
the block first ran, so its dropout masks are the same, and leaves the batch
norms' running statistics alone, so they move once.

Under the tensor-parallel layout (parallel/tensor_parallel.shard_model_) a
ConvBn whose leaves are sharded computes its own share of the output
channels and keeps them sharded through batch norm, the residual adds, the
nonlinearity, dropout and the temporal mask; each conv and the head read the
whole activation, gathered once over the model group (`Whole`). Batch norm's
statistics are global over the data group, and dropout draws the whole
tensor's mask and keeps this rank's channels, so the masks equal one
process's.
"""
import contextlib
import typing

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..frontend.logmel import (
    LogFilterBankFrontend, compute_output_lengths, full_fp32, masked_instance_norm,
    temporal_mask,
)
from ..frontend.augment import spec_augment as apply_spec_augment
from ..infra.utils import wide_float
from ..parallel import mesh, tensor_parallel


def check_xlen(xlen, batch: int):
    """xlen is the (B,) float valid FRACTION of the padded time dim."""
    if xlen is None:
        return None
    assert xlen.ndim == 1 and xlen.shape[0] == batch, \
        f'xlen: expected ({batch},) valid-length fractions, got {tuple(xlen.shape)}'
    assert xlen.is_floating_point(), \
        f'xlen: dtype {xlen.dtype} — xlen is the valid FRACTION of the padded ' \
        f'time dim (float in (0, 1]), not absolute lengths'
    return xlen


def apply_nonlinearity(x, nonlinearity: typing.Tuple):
    kind = nonlinearity[0]
    if kind == 'relu':
        return F.relu(x)
    if kind == 'hardtanh':
        return torch.clamp(x, nonlinearity[1], nonlinearity[2])
    if kind == 'leaky_relu':
        return F.leaky_relu(x, negative_slope=nonlinearity[1])
    raise ValueError(f'unknown nonlinearity {kind}')


def init_as_flax(module: nn.Module):
    """Re-draws a model's conv weights from flax's default initializers, the
    JAX package's JasperNet's: every conv kernel lecun_normal (a normal of
    variance 1 / fan_in, fan_in = Cin / groups * K, truncated at two standard
    deviations and rescaled), every conv bias zero; batch norm's scale 1 and
    bias 0 are torch's too. torch's own conv defaults (uniform, a third of
    that variance, and uniform biases) leave the weights ahead of each batch
    norm ~1.7x smaller, which triples NovoGrad's effective step there: a
    model trained from them fits faster and peakier than the JAX package's,
    and its greedy decode breaks words at the long blank runs. The train CLI
    calls it on a model it trains from scratch."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv1d) and not m.weight.is_meta:
                fan_in = m.weight.shape[1] * m.weight.shape[2]
                w = m.weight.normal_()
                out = w.abs() > 2.0
                n = int(out.sum())
                while n:                      # redraw past two standard deviations
                    w.masked_scatter_(out, torch.randn(n, dtype=w.dtype, device=w.device))
                    out = w.abs() > 2.0
                    n = int(out.sum())
                w.mul_((1.0 / fan_in) ** 0.5 / 0.87962566103423978)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


def _apply_temporal_mask(x, lengths_fraction):
    """x: (B, C, T)."""
    if lengths_fraction is None:
        return x
    lengths = compute_output_lengths(x.shape[-1], lengths_fraction)
    return x * temporal_mask(x.shape[-1], lengths)[:, None, :].to(x.dtype)


def _dropout(x, rate: float, generator: typing.Optional[torch.Generator],
             sharded: bool = False):
    """flax's Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate); the mask comes from `generator` when one is given. A
    `sharded` x (B, C / n_model, T) takes its channels of the whole tensor's
    mask, drawn from the generator every model rank shares."""
    if sharded:
        shape = list(x.shape)
        shape[1] *= tensor_parallel.model_world()
        keep = tensor_parallel.local_channels(
            torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
                1.0 - rate, generator=generator))
    elif generator is None:
        return F.dropout(x, rate, training=True)
    else:
        keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm1d whose running variance follows flax's `nn.BatchNorm`: the
    update uses the biased batch variance, where torch's uses the unbiased
    one (the two differ by n/(n-1) after a step). Normalisation, eval mode
    and the running mean are torch's own. With `update_stats` False, training
    mode normalises with the batch's statistics and leaves the running ones
    as they are (the recompute of a rematerialised block)."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if mesh.data_world() > 1:
            return self._forward_global(x)
        # torch's kernel updates copies (autograd keeps them for the backward)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        if not self.update_stats:
            return y
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.copy_(mean)
            # torch added momentum * var * n/(n-1); take back the n/(n-1)
            self.running_var.copy_(keep * self.running_var
                                   + (var - keep * self.running_var) * ((n - 1) / n))
        return y

    def _forward_global(self, x):
        """Training mode over several data indices: the statistics of the
        global batch, as GSPMD gives the JAX package. The per-channel sum and
        count, then the sum of squared deviations from the global mean, each
        summed over the data group (the ranks that hold these channels of
        the other rows) by a differentiable all-reduce; normalised with the
        global mean and biased variance. The recompute of a rematerialised
        block all-reduces them again."""
        dims = [0, 2] if x.ndim == 3 else [0]
        shape = [1, -1] + [1] * (x.ndim - 2)
        count = torch.tensor([float(x.numel() // x.shape[1])], dtype=x.dtype, device=x.device)
        group = mesh.grid().data
        s = mesh.all_reduce_sum(torch.cat([x.sum(dim=dims), count]), group)
        n = s[-1]
        mean = s[:-1] / n
        var = mesh.all_reduce_sum(((x - mean.reshape(shape)) ** 2).sum(dim=dims), group) / n
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        if self.update_stats:
            keep = 1.0 - self.momentum
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.mul_(keep).add_(mean.detach() * self.momentum)
                self.running_var.mul_(keep).add_(var.detach() * self.momentum)
        return y


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Batch norms of `module` normalise as in training but keep their running
    statistics."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def rematerialized(block: nn.Module, x, lengths_fraction, residual, generator):
    """block(x, lengths_fraction, residual, generator) with its activations
    recomputed in the backward pass. The recompute sets `generator` back to
    its state at the first call (and afterwards forward again), so dropout
    draws the same masks, runs cuDNN with the first call's TF32 setting (the
    backward runs outside the forward's full_fp32), and freezes the running
    statistics."""
    start = generator.get_state() if generator is not None else None
    tf32 = torch.backends.cudnn.allow_tf32
    first = True

    def run(x, *residual):
        nonlocal first
        if first:
            first = False
            return block(x, lengths_fraction, residual, generator)
        resume = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(start)
        resume_tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, tf32
        try:
            with frozen_running_stats(block):
                return block(x, lengths_fraction, residual, generator)
        finally:
            torch.backends.cudnn.allow_tf32 = resume_tf32
            if generator is not None:
                generator.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, x, *residual, use_reentrant=False)


def _conv(conv: nn.Conv1d, x, dtype):
    """conv in `dtype` on float32 weights (flax's dtype/param_dtype split)."""
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class ConvSamePadding(nn.Module):
    """'Same'-ish padded 1-D conv (pad = dilation*kernel_size//2); optionally
    depthwise-separable (depthwise conv -> relu -> pointwise conv)."""

    def __init__(self, in_channels, features, kernel_size, stride=1, dilation=1,
                 groups=1, separable=False, use_bias=False, dtype=torch.float32):
        super().__init__()
        self.separable, self.dtype = separable, dtype
        pad = dilation * kernel_size // 2
        if separable:
            assert dilation == 1
            self.depthwise = nn.Conv1d(in_channels, features, kernel_size, stride=stride,
                                       padding=pad, groups=groups, bias=True)
            self.pointwise = nn.Conv1d(features, features, 1, bias=use_bias)
        else:
            self.conv = nn.Conv1d(in_channels, features, kernel_size, stride=stride,
                                  padding=pad, dilation=dilation, groups=groups,
                                  bias=use_bias)

    def forward(self, x):
        if self.separable:
            x = F.relu(_conv(self.depthwise, x, self.dtype))
            return _conv(self.pointwise, x, self.dtype)
        return _conv(self.conv, x, self.dtype)


class ConvBn(nn.Module):
    """[conv -> BN -> (residuals) -> activation -> dropout -> mask] x repeat.
    The stride applies at every repeat. Residual inputs each pass through
    their own 1x1 conv + BN (identity for the 'flat' topology) and are added
    before the activation on the last repeat only."""

    # under the tensor-parallel layout: whether the output channels are
    # sharded over the model group (set by tensor_parallel.shard_model_)
    tp: typing.Optional[bool] = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, dilation=1,
                 dropout=0.0, groups=1, repeat=1, separable=False,
                 num_channels_residual=(), temporal_mask=True, nonlinearity=('relu',),
                 batch_norm_momentum=0.1, dtype=torch.float32):
        super().__init__()
        self.repeat, self.dtype = repeat, dtype
        self.num_channels_residual = tuple(num_channels_residual)
        self.temporal_mask, self.nonlinearity = temporal_mask, nonlinearity
        self.dropout = dropout
        for i in range(repeat):
            self.add_module(f'conv{i}', ConvSamePadding(
                in_channels if i == 0 else out_channels, out_channels, kernel_size,
                stride=stride, dilation=dilation, groups=groups, separable=separable,
                use_bias=False, dtype=dtype))
            self.add_module(f'bn{i}', BatchNorm(out_channels, eps=1e-5,
                                                momentum=batch_norm_momentum))
        for j, c in enumerate(self.num_channels_residual):
            if c is not None:
                self.add_module(f'conv_residual{j}', nn.Conv1d(c, out_channels, 1, bias=True))
                self.add_module(f'bn_residual{j}', BatchNorm(
                    out_channels, eps=1e-5, momentum=batch_norm_momentum))

    def forward(self, x, lengths_fraction=None, residual: typing.Sequence = (),
                generator: typing.Optional[torch.Generator] = None):
        """x and residuals: (B, C, T); generator: the dropout masks' source.
        Under the tensor-parallel layout x and the residuals are
        tensor_parallel.Whole activations, and the output is this rank's
        channels where the block is sharded."""
        assert len(residual) == len(self.num_channels_residual)
        tp = self.tp
        for i in range(self.repeat):
            if tp is not None:
                # each conv reads the whole activation
                x = (x if i == 0 else tensor_parallel.Whole(x, tp)).feed(tp)
            x = getattr(self, f'conv{i}')(x)
            x = getattr(self, f'bn{i}')(wide_float(x))
            if i == self.repeat - 1:
                for j, r in enumerate(residual):
                    if self.num_channels_residual[j] is None:
                        x = x + (r if tp is None else r.local).to(x.dtype)
                    else:
                        r = _conv(getattr(self, f'conv_residual{j}'),
                                  r if tp is None else r.feed(tp), self.dtype)
                        x = x + getattr(self, f'bn_residual{j}')(wide_float(r))
            x = apply_nonlinearity(x, self.nonlinearity)
            if self.dropout > 0 and self.training:
                x = _dropout(x, self.dropout, generator, sharded=bool(tp))
            if self.temporal_mask:
                x = _apply_temporal_mask(x, lengths_fraction)
        return x


class Decoder(nn.Module):
    """CTC head(s): 1x1 conv char head, optional 2-layer BPE head."""

    tp: typing.Optional[bool] = None      # as ConvBn.tp, for head0

    def __init__(self, in_channels, num_classes, head_type=None, dtype=torch.float32):
        super().__init__()
        self.head_type, self.dtype = head_type, dtype
        self.head0 = nn.Conv1d(in_channels, num_classes[0], 1, bias=True)
        if head_type is not None:
            assert head_type == 'bpe'
            self.bpe_conv0 = ConvBn(in_channels, in_channels, 15, dtype=dtype)
            self.bpe_conv1 = ConvBn(in_channels, num_classes[1], 15, dtype=dtype)

    def forward(self, x, generator=None):
        """x: (B, C, T), a tensor_parallel.Whole under the tensor-parallel
        layout (the logits come back whole)."""
        if self.tp is not None:
            y0 = _conv(self.head0, x.feed(self.tp), self.dtype)
            return (tensor_parallel.Whole(y0, self.tp).full,)
        y0 = _conv(self.head0, x, self.dtype)
        if self.head_type is None:
            return (y0,)
        return (y0, self.bpe_conv1(self.bpe_conv0(x, generator=generator), generator=generator))


class JasperNet(nn.Module):
    """Stacked ConvBn blocks with plain/residual/dense topology + CTC heads.

    forward(signal_or_features, xlen) -> dict(logits=[...], log_probs=[...],
    olen=[...]), each (B, T', C); `xlen` is the valid-length FRACTION of the
    padded time dim. Runs in eval mode for inference (`model.eval()`) and in
    training mode for training, where `generator` drives dropout and dither.
    """

    def __init__(self, num_input_features: int, num_classes: typing.Tuple[int, ...],
                 repeat: int = 3, num_subblocks: int = 1, dilation: int = 1,
                 residual: typing.Union[str, bool] = 'dense',
                 kernel_sizes=(11, 13, 17, 21, 25), kernel_size_prologue: int = 11,
                 kernel_size_epilogue: int = 29, base_width: int = 128,
                 out_width_factors=(2, 3, 4, 5, 6), out_width_factors_large=(7, 8),
                 separable: bool = False, groups: int = 1, dropout: float = 0.0,
                 dropout_prologue: float = 0.2, dropout_epilogue: float = 0.4,
                 dropouts=(0.2, 0.2, 0.2, 0.3, 0.3), temporal_mask: bool = True,
                 nonlinearity=('relu',), stride1: int = 2, stride2: int = 1,
                 decoder_type: typing.Optional[str] = None, bpe_only: bool = False,
                 normalize_features: bool = True,
                 normalize_features_eps: float = float(np.finfo(np.float16).tiny),
                 normalize_features_legacy: bool = True,
                 normalize_features_temporal_mask: bool = True,
                 frontend: typing.Optional[LogFilterBankFrontend] = None,
                 spec_augment: typing.Optional[typing.Tuple[int, ...]] = None,
                 remat: bool = False, dtype=torch.float32):
        super().__init__()
        # the constructor's arguments, for --dump-model-config
        self.config = {k: v for k, v in locals().items() if k not in ('self', '__class__')}
        self.num_input_features = num_input_features
        self.num_classes = tuple(num_classes)
        self.repeat, self.num_subblocks, self.dilation = repeat, num_subblocks, dilation
        self.residual = residual
        self.kernel_sizes = tuple(kernel_sizes)
        self.kernel_size_prologue, self.kernel_size_epilogue = \
            kernel_size_prologue, kernel_size_epilogue
        self.base_width = base_width
        self.out_width_factors = tuple(out_width_factors)
        self.out_width_factors_large = tuple(out_width_factors_large)
        self.separable, self.groups = separable, groups
        self.dropout, self.dropout_prologue, self.dropout_epilogue = \
            dropout, dropout_prologue, dropout_epilogue
        self.dropouts = tuple(dropouts)
        self.stride1, self.stride2 = stride1, stride2
        self.decoder_type, self.bpe_only = decoder_type, bpe_only
        self.normalize_features = normalize_features
        self.normalize_features_eps = normalize_features_eps
        self.normalize_features_temporal_mask = normalize_features_temporal_mask
        self.frontend = frontend
        # (time masks, time width, freq masks, freq width[, warp width]); None = off
        self.spec_augment = tuple(spec_augment) if spec_augment else None
        self.remat = remat
        self.dtype = dtype

        in_ch = num_input_features
        self.num_blocks = 0
        for i, block in enumerate(self._block_plan()):
            self.add_module(f'block{i}', ConvBn(
                in_ch, temporal_mask=temporal_mask, nonlinearity=tuple(nonlinearity),
                num_channels_residual=block['residual_channels'], dtype=dtype,
                **block['kwargs']))
            in_ch = block['kwargs']['out_channels']
            self.num_blocks += 1
        self.decoder = Decoder(in_ch, self.num_classes, head_type=decoder_type, dtype=dtype)

    def _block_plan(self):
        """Static plan of (kwargs, residual_channels) per backbone block, as
        in the JAX package."""
        dropout_prologue = self.dropout_prologue if self.dropout != 0 else 0
        dropout_epilogue = self.dropout_epilogue if self.dropout != 0 else 0
        dropouts = self.dropouts if self.dropout != 0 else tuple(0 for _ in self.dropouts)

        plan = []
        in_width = self.out_width_factors[0]
        plan.append(dict(kwargs=dict(out_channels=in_width * self.base_width,
                                     kernel_size=self.kernel_size_prologue,
                                     dropout=dropout_prologue, stride=self.stride1),
                         residual_channels=()))
        num_channels_residual: list = []
        for kernel_size, dropout, out_width in zip(self.kernel_sizes, dropouts,
                                                   self.out_width_factors):
            for s in range(self.num_subblocks):
                out_ch = (out_width if s == self.num_subblocks - 1 else in_width) * self.base_width
                in_ch = in_width * self.base_width
                if self.residual == 'dense':
                    num_channels_residual.append(in_ch)
                elif self.residual == 'flat':
                    num_channels_residual = [None]
                elif self.residual:
                    num_channels_residual = [in_ch]
                else:
                    num_channels_residual = []
                plan.append(dict(kwargs=dict(out_channels=out_ch, kernel_size=kernel_size,
                                             dropout=dropout, repeat=self.repeat,
                                             separable=self.separable, groups=self.groups),
                                 residual_channels=tuple(num_channels_residual)))
            in_width = out_width
        plan.append(dict(kwargs=dict(out_channels=self.out_width_factors_large[0] * self.base_width,
                                     kernel_size=self.kernel_size_epilogue,
                                     dropout=dropout_epilogue, dilation=self.dilation),
                         residual_channels=()))
        plan.append(dict(kwargs=dict(out_channels=self.out_width_factors_large[1] * self.base_width,
                                     kernel_size=1, dropout=dropout_epilogue),
                         residual_channels=()))
        return plan

    def forward(self, x, xlen=None, generator: typing.Optional[torch.Generator] = None):
        num_epilogue = 2
        check_xlen(xlen, x.shape[0])
        generator = generator if self.training else None
        with full_fp32():
            if self.frontend is not None:
                assert x.ndim == 2, 'frontend expects raw signal (B, T)'
                mask = None
                if xlen is not None:
                    mask = temporal_mask(x.shape[-1], compute_output_lengths(x.shape[-1], xlen))
                x = self.frontend(x, mask=mask, generator=generator)

            assert x.ndim == 3, 'features expected as (B, T, C)'
            if self.normalize_features:
                mask = None
                if self.normalize_features_temporal_mask and xlen is not None:
                    mask = temporal_mask(x.shape[1], compute_output_lengths(x.shape[1], xlen))
                x = masked_instance_norm(x, mask=mask, eps=self.normalize_features_eps)
            if self.training and self.spec_augment is not None and generator is not None:
                n_t, w_t, n_f, w_f, *rest = self.spec_augment
                lengths = compute_output_lengths(x.shape[1], xlen).to(x.device) \
                    if xlen is not None else None
                x = apply_spec_augment(x, generator, num_time_masks=n_t, time_mask_width=w_t,
                                       num_freq_masks=n_f, freq_mask_width=w_f,
                                       time_warp_width=rest[0] if rest else 0, lengths=lengths)
            x = x.to(self.dtype).transpose(1, 2)                      # (B, C, T)
            tp = tensor_parallel.is_sharded(self)
            if tp:
                x = tensor_parallel.Whole(x, False)

            remat = self.remat and torch.is_grad_enabled()
            residual: list = []
            for i in range(self.num_blocks):
                block = getattr(self, f'block{i}')
                if remat:
                    x = rematerialized(block, x, xlen, tuple(residual), generator)
                else:
                    x = block(x, xlen, tuple(residual), generator)
                if tp:
                    x = tensor_parallel.Whole(x, block.tp)
                if i >= self.num_blocks - num_epilogue - 1:             # no residuals for epilogue
                    residual = []
                elif self.residual == 'dense':
                    residual.append(x)
                elif self.residual:
                    residual = [x]
                else:
                    residual = []

            logits = [y.transpose(1, 2) for y in self.decoder(x, generator)]  # (B, T', C)
        log_probs = [F.log_softmax(wide_float(y), dim=-1) for y in logits]
        olen = [compute_output_lengths(y.shape[1], xlen).to(y.device) if xlen is not None
                else torch.full((y.shape[0],), y.shape[1], dtype=torch.int32, device=y.device)
                for y in logits]
        return dict(logits=logits, log_probs=log_probs, olen=olen)
