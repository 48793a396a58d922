"""JasperNet / Wav2Letter convolutional CTC acoustic models in PyTorch
(counterpart of convasr_tpu/models/jasper.py).

Module names follow the flax tree (`block{i}.conv{r}.conv`, `bn{r}`,
`conv_residual{j}`, `bn_residual{j}`, `decoder.head0`), so models/convert.py
maps a JAX checkpoint onto the state_dict key by key. Tensors are (B, T, C) at
the model's boundary as in the JAX package; inside the backbone they are
(B, C, T), the layout of torch's Conv1d. Parameters live in float32; convs
compute in `dtype` (bfloat16 by default in the CLI), batch norm and instance
norm in float32, log_softmax in float32, as the JAX dtypes do.
"""
import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..frontend.logmel import (
    LogFilterBankFrontend, compute_output_lengths, full_fp32, masked_instance_norm,
    temporal_mask,
)


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


def _apply_temporal_mask(x, lengths_fraction):
    """x: (B, C, T)."""
    if lengths_fraction is None:
        return x
    lengths = compute_output_lengths(x.shape[-1], lengths_fraction)
    return x * temporal_mask(x.shape[-1], lengths)[:, None, :].to(x.dtype)


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

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, dilation=1,
                 dropout=0.0, groups=1, repeat=1, separable=False,
                 num_channels_residual=(), temporal_mask=True, nonlinearity=('relu',),
                 batch_norm_momentum=0.1, dtype=torch.float32):
        super().__init__()
        self.repeat, self.dtype = repeat, dtype
        self.num_channels_residual = tuple(num_channels_residual)
        self.temporal_mask, self.nonlinearity = temporal_mask, nonlinearity
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        for i in range(repeat):
            self.add_module(f'conv{i}', ConvSamePadding(
                in_channels if i == 0 else out_channels, out_channels, kernel_size,
                stride=stride, dilation=dilation, groups=groups, separable=separable,
                use_bias=False, dtype=dtype))
            self.add_module(f'bn{i}', nn.BatchNorm1d(out_channels, eps=1e-5,
                                                     momentum=batch_norm_momentum))
        for j, c in enumerate(self.num_channels_residual):
            if c is not None:
                self.add_module(f'conv_residual{j}', nn.Conv1d(c, out_channels, 1, bias=True))
                self.add_module(f'bn_residual{j}', nn.BatchNorm1d(
                    out_channels, eps=1e-5, momentum=batch_norm_momentum))

    def forward(self, x, lengths_fraction=None, residual: typing.Sequence = ()):
        """x and residuals: (B, C, T)."""
        assert len(residual) == len(self.num_channels_residual)
        for i in range(self.repeat):
            x = getattr(self, f'conv{i}')(x)
            x = getattr(self, f'bn{i}')(x.to(torch.float32))
            if i == self.repeat - 1:
                for j, r in enumerate(residual):
                    if self.num_channels_residual[j] is None:
                        x = x + r.to(x.dtype)
                    else:
                        r = _conv(getattr(self, f'conv_residual{j}'), r, self.dtype)
                        x = x + getattr(self, f'bn_residual{j}')(r.to(torch.float32))
            x = apply_nonlinearity(x, self.nonlinearity)
            if self.dropout is not None:
                x = self.dropout(x)
            if self.temporal_mask:
                x = _apply_temporal_mask(x, lengths_fraction)
        return x


class Decoder(nn.Module):
    """CTC head(s): 1x1 conv char head, optional 2-layer BPE head."""

    def __init__(self, in_channels, num_classes, head_type=None, dtype=torch.float32):
        super().__init__()
        self.head_type, self.dtype = head_type, dtype
        self.head0 = nn.Conv1d(in_channels, num_classes[0], 1, bias=True)
        if head_type is not None:
            assert head_type == 'bpe'
            self.bpe_conv0 = ConvBn(in_channels, in_channels, 15, dtype=dtype)
            self.bpe_conv1 = ConvBn(in_channels, num_classes[1], 15, dtype=dtype)

    def forward(self, x):
        y0 = _conv(self.head0, x, self.dtype)
        if self.head_type is None:
            return (y0,)
        return (y0, self.bpe_conv1(self.bpe_conv0(x)))


class JasperNet(nn.Module):
    """Stacked ConvBn blocks with plain/residual/dense topology + CTC heads.

    forward(signal_or_features, xlen) -> dict(logits=[...], log_probs=[...],
    olen=[...]), each (B, T', C); `xlen` is the valid-length FRACTION of the
    padded time dim. Runs in eval mode for inference (`model.eval()`).
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
                 dtype=torch.float32):
        super().__init__()
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

    def forward(self, x, xlen=None):
        num_epilogue = 2
        check_xlen(xlen, x.shape[0])
        with full_fp32():
            if self.frontend is not None:
                assert x.ndim == 2, 'frontend expects raw signal (B, T)'
                mask = None
                if xlen is not None:
                    mask = temporal_mask(x.shape[-1], compute_output_lengths(x.shape[-1], xlen))
                x = self.frontend(x, mask=mask)

            assert x.ndim == 3, 'features expected as (B, T, C)'
            if self.normalize_features:
                mask = None
                if self.normalize_features_temporal_mask and xlen is not None:
                    mask = temporal_mask(x.shape[1], compute_output_lengths(x.shape[1], xlen))
                x = masked_instance_norm(x, mask=mask, eps=self.normalize_features_eps)
            x = x.to(self.dtype).transpose(1, 2)                      # (B, C, T)

            residual: list = []
            for i in range(self.num_blocks):
                x = getattr(self, f'block{i}')(x, xlen, tuple(residual))
                if i >= self.num_blocks - num_epilogue - 1:             # no residuals for epilogue
                    residual = []
                elif self.residual == 'dense':
                    residual.append(x)
                elif self.residual:
                    residual = [x]
                else:
                    residual = []

            logits = [y.transpose(1, 2) for y in self.decoder(x)]      # (B, T', C)
        log_probs = [F.log_softmax(y.to(torch.float32), dim=-1) for y in logits]
        olen = [compute_output_lengths(y.shape[1], xlen).to(y.device) if xlen is not None
                else torch.full((y.shape[0],), y.shape[1], dtype=torch.int32, device=y.device)
                for y in logits]
        return dict(logits=logits, log_probs=log_probs, olen=olen)
