"""Hand-written Hopper kernels, each beside its plain PyTorch version.

    flash_attention   — flash attention forward (port of the Pallas kernel
                        repro.kernels.flash_attention), CUDA C++ in csrc/
    ref               — naive oracle the tests hold both versions to
    build             — nvcc build into build/repro_torch/ + ctypes loading
"""
