"""The int8 kernels' share of their roofline in the traced int8 transcribe
window: the least time of every int8 conv and GEMM of the batches the window
ran, at their padded shapes (`model_plan.int8_products`: int8 operations
over 1,979 TOP/s, or the int8 input, the int8 weight and the int32 output
moved once over 3.35 TB/s where that is longer), over the device time of the
kernels of csrc/int8_conv.cu and csrc/int8_gemm.cu (P3; P1 and P2)."""
from perfbench import trace

# the namespaces and names of the int8 kernels' `__global__` functions, as
# they stand in a kernel's name, demangled or not: the wgmma conv
# (int8_conv_wgmma::kernel), the wgmma GEMM (int8_gemm_wgmma_tma::kernel),
# the whole-K GEMM and the mma.sync loop of the conv and the K-tiled GEMM
# (int8mma::tiled_kernel)
KERNELS = ('int8_conv_wgmma', 'int8_gemm_wgmma_tma', 'int8_gemm_whole_k_kernel', 'int8mma')


def is_int8_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(run):
    v = run.values
    if run.traced is None or v.get('kind') != 'transcribe_int8':
        return None
    spent = trace.kernel_seconds(run.traced, is_int8_kernel)
    if not spent:
        return None
    return 100.0 * v['traced_int8_least_s'] / spent
