"""Named model config zoo (counterpart of convasr_tpu/models/zoo.py): all
24 named configs as kwargs-factories over `JasperNet`.
"""
import typing

import torch

from .jasper import JasperNet

_W2L_COMMON = dict(
    base_width=128, nonlinearity=('hardtanh', 0, 20), kernel_size_prologue=11,
    kernel_size_epilogue=29, out_width_factors=(2, 3, 4, 5, 6),
    out_width_factors_large=(7, 8), dropout=0.2,
)


def _w2l(num_blocks=5, residual=False, dilation=2, num_subblocks=1,
         kernel_sizes=None, nonlinearity=('hardtanh', 0, 20), dropout=0.2,
         temporal_mask=True, out_width_factors=(2, 3, 4, 5, 6),
         out_width_factors_large=(7, 8), kernel_size_prologue=11):
    """Wav2Letter-family kwargs (spec: models.py:819-855: repeated prologue
    kernel unless large-kernels variant; uniform dropout)."""
    kernel_sizes = kernel_sizes if kernel_sizes is not None else (kernel_size_prologue,) * num_blocks
    return dict(
        base_width=128, repeat=3, num_subblocks=num_subblocks,
        kernel_size_prologue=kernel_size_prologue, kernel_size_epilogue=29,
        kernel_sizes=tuple(kernel_sizes),
        out_width_factors=tuple(out_width_factors),
        out_width_factors_large=tuple(out_width_factors_large),
        residual=residual, dilation=dilation, nonlinearity=nonlinearity,
        dropout=dropout, dropout_prologue=dropout, dropout_epilogue=dropout,
        dropouts=(dropout,) * num_blocks, temporal_mask=temporal_mask,
    )


MODEL_CONFIGS: typing.Dict[str, dict] = {
    # --- Wav2Letter family (models.py:819-1369) ---
    'Wav2Letter': _w2l(num_blocks=6, residual=False, dilation=2),
    'Wav2LetterResidual': _w2l(residual=True, dilation=2),
    'Wav2LetterResidualNoDilation': _w2l(residual=True, dilation=1),
    'Wav2LetterResidualBig': _w2l(residual=True, dilation=2, num_subblocks=2),
    'Wav2LetterDense': _w2l(residual='dense', dilation=2),
    'Wav2LetterDenseNoDilation': _w2l(residual='dense', dilation=1),
    'Wav2LetterDenseNoDilationInplace': _w2l(residual='dense', dilation=1,
                                             nonlinearity=('leaky_relu', 0.01)),
    'Wav2LetterDenseLargeKernels': _w2l(residual='dense', dilation=2,
                                        kernel_sizes=(11, 13, 17, 21, 25)),
    'Wav2LetterDenseNoDilationLargeKernels': _w2l(residual='dense', dilation=1,
                                                  kernel_sizes=(11, 13, 17, 21, 25)),
    'Wav2LetterDenseBig': _w2l(residual='dense', dilation=2, num_subblocks=2),
    'Wav2LetterDenseBigLargeKernelsNoDropoutReLu': _w2l(
        residual='dense', dilation=2, num_subblocks=2, dropout=0.0,
        nonlinearity=('relu',), kernel_sizes=(11, 13, 17, 21, 25)),
    'Wav2LetterDenseBigLargeKernelsNoDilationNoDropoutReLu': _w2l(
        residual='dense', dilation=1, num_subblocks=2, dropout=0.0,
        nonlinearity=('relu',), kernel_sizes=(11, 13, 17, 21, 25)),
    'Wav2LetterDenseBigLargeKernelsNoDilationNoTemporalMaskNoDropoutReLu': _w2l(
        residual='dense', dilation=1, num_subblocks=2, dropout=0.0,
        nonlinearity=('relu',), kernel_sizes=(11, 13, 17, 21, 25), temporal_mask=False),
    'Wav2LetterFlat': _w2l(residual='flat', dilation=2, kernel_size_prologue=13,
                           out_width_factors=(6,) * 5, out_width_factors_large=(16, 16)),

    # --- JasperNet family (models.py:1372-1442); JasperNet defaults are
    # repeat=3, dense residual, per-block dropouts ---
    'JasperNet': dict(),
    'JasperNetSeparable': dict(separable=True, groups=128),
    'JasperNetSmall': dict(num_subblocks=1, temporal_mask=False),
    'JasperNetSmallInstanceNorm': dict(num_subblocks=1, temporal_mask=False,
                                       normalize_features_legacy=False,
                                       normalize_features_temporal_mask=False),
    'JasperNetSmallTrainableInstanceNorm': dict(num_subblocks=1, temporal_mask=False,
                                                normalize_features_legacy=False,
                                                normalize_features_temporal_mask=False),
    'JasperNetLarge': dict(num_subblocks=2, repeat=5, temporal_mask=False),
    'JasperNetBig': dict(num_subblocks=2, temporal_mask=False),
    'JasperNetBigNoStride': dict(num_subblocks=2, stride1=1, temporal_mask=False),
    'JasperNetBigBpeOnly': dict(num_subblocks=2, temporal_mask=False, bpe_only=True),
    'JasperNetResidualBig': dict(num_subblocks=2, temporal_mask=False, residual=True),
    'JasperNetBigInplace': dict(num_subblocks=2, temporal_mask=False,
                                nonlinearity=('leaky_relu', 0.01)),
}


def create_model(name: str, num_input_features: int, num_classes: typing.Sequence[int],
                 frontend=None, dropout: typing.Optional[float] = None,
                 decoder_type: typing.Optional[str] = None,
                 dtype=torch.float32, **overrides) -> JasperNet:
    """Instantiate a named config."""
    if name not in MODEL_CONFIGS:
        raise KeyError(f'unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}')
    kwargs = dict(MODEL_CONFIGS[name])
    if dropout is not None:
        if 'dropouts' in kwargs:  # Wav2Letter-family: uniform dropout override
            n = len(kwargs['dropouts'])
            kwargs.update(dropout=dropout, dropout_prologue=dropout,
                          dropout_epilogue=dropout, dropouts=(dropout,) * n)
        else:
            kwargs['dropout'] = dropout
    kwargs.update(overrides)
    return JasperNet(num_input_features=num_input_features, num_classes=tuple(num_classes),
                     frontend=frontend, decoder_type=decoder_type, dtype=dtype, **kwargs)
