"""repro_torch — the serving path of ``repro`` ported to PyTorch and CUDA on
an NVIDIA H100 (Hopper, sm_90a).

The layout mirrors ``repro``:
    repro_torch.configs   — ModelConfig copies of the dense configs served
    repro_torch.models    — build(cfg, device=...) -> Model (prefill/decode)
    repro_torch.kernels   — hand-written Hopper kernels, each beside its
                            plain PyTorch version
    repro_torch.convert   — JAX params / checkpoints -> the port's weights
    repro_torch.serve     — ServeEngine (batched greedy decoding)
    repro_torch.launch    — serve entry point

It imports torch, numpy and the standard library only: never jax and
nothing of ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
