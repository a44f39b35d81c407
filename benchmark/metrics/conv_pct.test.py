"""Share of the card's busy time in the window spent in convolutions, the
kernels told apart by name (`is_conv`): cuDNN's and CUTLASS's forward
convolutions (`fprop`, `implicit_gemm`, ...), and the TF32 tensor-core
GEMMs that cuDNN runs 1x1 convolutions as (`tf32`, `s1688gemm`).  The
program's own matrix products run in float32 (PyTorch's default), so in
this cell a TF32 GEMM is a convolution.  The rest is BatchNorm, ReLU,
residual adds, layout transposes, pooling, the crop resampler's float32
GEMMs and copies."""

from benchmark.tracing import merge

CONV_NAMES = ("fprop", "implicit_gemm", "convolve", "winograd", "conv2d",
              "convolution", "tf32", "s1688gemm")


def is_conv(name):
    """True for a convolution kernel's name."""
    name = name.lower()
    return any(k in name for k in CONV_NAMES)


def read(run):
    if run.trace is None or not run.trace.busy:
        return None
    spans = merge((a, b) for name, _, a, b in run.trace.in_window("kernel")
                  if is_conv(name))
    return 100.0 * sum(b - a for a, b in spans) * 1e-9 / run.trace.busy_s
