"""Arithmetic that several metric readers share."""


def idle_pct(run, kind: str):
    """100 x (1 - busy / window) of the traced window of a `kind` cell."""
    if run.traced is None or run.values.get('kind') != kind or not run.traced['window_s']:
        return None
    return 100.0 * (1.0 - run.traced['busy_s'] / run.traced['window_s'])


def is_conv_kernel(name: str) -> bool:
    """cuDNN's and PyTorch's convolution kernels by name (implicit-GEMM
    fprop, dgrad and wgrad, the GEMMs cuDNN runs a 1x1 conv on, direct
    convolutions), not the layout transposes beside them. The forward's only
    other GEMM, the float32 mel projection, is counted with them."""
    low = name.lower()
    if 'tonhwc' in low or 'tonchw' in low:
        return False
    return any(k in low for k in ('fprop', 'dgrad', 'wgrad', 'conv', 'gemm'))
