"""The convolution kernels' share of their roofline in the traced transcribe
window: the FLOPs of every conv at the padded shapes the kernels ran (the
model's in bf16 over 989 TFLOP/s, the frontend's STFT in float32 over 67
TFLOP/s) over the device time of the trace's convolution kernels."""
from perfbench import measure, trace
from perfbench.metrics_common import is_conv_kernel


def read(run):
    v = run.values
    if run.traced is None or v.get('kind') != 'transcribe':
        return None
    spent = trace.kernel_seconds(run.traced, is_conv_kernel)
    if not spent:
        return None
    least = (v['traced_conv_flops'] / measure.PEAK_BF16_FLOPS
             + v['traced_stft_flops'] / measure.PEAK_FP32_FLOPS)
    return 100.0 * least / spent
