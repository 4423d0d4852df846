"""Roofline terms of one rank's counted step: the port's counterpart of
``repro.core.roofline``.

Per (arch x shape x mesh), with the count of ``repro_torch.core.op_cost``
(one rank's eager step, every layer and micro-step run):

    compute    = flops      / PEAK_BF16
    memory     = bytes      / HBM_BW
    collective = coll_bytes / NET_BW

``hlo_flops``, ``hlo_bytes`` and ``coll_bytes`` keep the reference's names so
that rows compare, but in the port they are counted ops (global: the rank's
count times the chips, as the reference scales its per-device module), and
the bytes are the unfused eager program's traffic (``op_cost``'s
docstring).  ``per_device_peak_bytes`` is the peak live bytes of the rank's
step under ``MemTracker`` (fake tensors in a dry run).

The constants are the H100 SXM's spec figures, not measurements:
``PEAK_BF16`` its dense bf16 tensor-core peak (989 TFLOP/s), ``HBM_BW`` its
HBM3 rate (3.35 TB/s), and ``NET_BW`` one 400 Gb/s NDR InfiniBand link per
GPU (50 GB/s), the usual fabric between H100 nodes.  No collective has run
on the card, so ``NET_BW`` has never been measured.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PEAK_BF16 = 989e12          # H100 SXM dense bf16, spec
PEAK_F32 = 67e12            # H100 SXM f32 (CUDA cores), spec
HBM_BW = 3.35e12            # H100 SXM HBM3, spec
NET_BW = 50e9               # one 400 Gb/s NDR link per GPU, spec; never measured


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0
    attn_flops: float = 0.0
    per_device_peak_bytes: float = 0.0
    dot_by_tag: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NET_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline lower bound on step time (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU upper bound at the roofline step time."""
        ideal = self.model_flops / (self.chips * PEAK_BF16)
        return ideal / self.t_bound if self.t_bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_peak_bytes": self.per_device_peak_bytes,
            **{f"coll_{k}": v for k, v in self.coll_breakdown.items()},
            **{f"dot_{k}": v for k, v in self.dot_by_tag.items()},
        }


def analyze(cost, *, arch: str, shape, mesh: dict, model_flops: float,
            attn_flops: float = 0.0, peak_bytes: float = 0.0) -> RooflineReport:
    """Roofline terms from one rank's count (an ``op_cost.Cost``) on a mesh
    (``{axis: size}``): every rank runs the same program, so the global
    figures are the rank's times the chips."""
    chips = 1
    for n in mesh.values():
        chips *= int(n)
    coll = {k: v * chips for k, v in cost.coll.items()}
    return RooflineReport(
        arch=arch, shape=getattr(shape, "name", str(shape)),
        mesh="x".join(str(v) for v in mesh.values()),
        chips=chips, hlo_flops=cost.flops * chips, hlo_bytes=cost.bytes * chips,
        coll_bytes=sum(coll.values()), coll_breakdown=coll,
        model_flops=model_flops, attn_flops=attn_flops,
        per_device_peak_bytes=peak_bytes,
        dot_by_tag={k: v * chips for k, v in cost.dot_by_tag.items()})
