"""Hand-written Hopper kernels, each beside its plain PyTorch version.

    flash_attention   — flash attention forward (port of the Pallas kernel
                        repro.kernels.flash_attention), CUDA C++ in csrc/
    ssd_scan          — Mamba-2 SSD chunked scan (port of repro.kernels.ssd_scan)
    wkv6              — RWKV-6 WKV (port of repro.kernels.wkv6)
    ref               — naive oracles the tests hold the versions to
    build             — nvcc build into build/repro_torch/ + ctypes loading
"""
