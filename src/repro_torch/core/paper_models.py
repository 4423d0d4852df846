"""The seven Transformer models from the paper's Table 2, as ModelProfiles
for the Rubick benchmarks (perf-model validation, traces, micro-benchmarks):
a copy of ``repro.core.paper_models``.  ``t_fwd_unit`` is derived from the
base ``Env``'s A800 bf16 peak at 35% efficiency, as in the reference; the
H100's own is measured by ``repro_torch.core.oracle.TorchMicroOracle``.

Sizes/datasets follow Table 2; (s, h, l) from the public configs.
"""

from __future__ import annotations

from repro_torch.core.perfmodel import Env, ModelProfile

_ENV = Env()


def _prof(name: str, s: int, h: int, l: int, P: float, b: int,
          eff: float = 0.35) -> ModelProfile:
    t_unit = 2.0 * P / (_ENV.gpu_flops * eff)
    return ModelProfile(name=name, s=s, h=h, l=l, P=P, b=b,
                        t_fwd_unit=t_unit, P_bytes=2 * P)


TABLE2: dict[str, ModelProfile] = {
    # name                s     h      l    params      batch
    "vit-86m":      _prof("vit-86m", 197, 768, 12, 86e6, 64),
    "roberta-355m": _prof("roberta-355m", 512, 1024, 24, 355e6, 32),
    "bert-336m":    _prof("bert-336m", 512, 1024, 24, 336e6, 32),
    "t5-1.2b":      _prof("t5-1.2b", 512, 1024, 48, 1.2e9, 32),
    "gpt2-1.5b":    _prof("gpt2-1.5b", 1024, 1600, 48, 1.5e9, 16),
    "llama2-7b":    _prof("llama2-7b", 2048, 4096, 32, 7e9, 16),
    "llama-30b":    _prof("llama-30b", 2048, 6656, 60, 30e9, 16),
}

SMALL = ("vit-86m", "roberta-355m", "bert-336m", "t5-1.2b")
LARGE = ("gpt2-1.5b", "llama2-7b", "llama-30b")


def profile(name: str) -> ModelProfile:
    return TABLE2[name]
