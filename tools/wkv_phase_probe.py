#!/usr/bin/env python3
"""Where a chunk's time goes in the bf16 WKV6 kernel, by clock64 probes.

    python3 tools/wkv_phase_probe.py [source.cu ...]

For each source (default: ``src/repro_torch/kernels/csrc/wkv6_fwd.cu``) this
script writes a copy of the bf16 tensor-core kernel with ``clock64()`` read
between its phases; each warp sums the cycles of each phase over its chunks
and, once at the end, lane 0 writes the sums into the first row of y (the
probed copy's y is not the function's y).  It builds the copies with nvcc,
launches each at the rwkv6-1.6b prefill shape (B 4, S 512, 32 heads of 64,
bf16) and at batch 1, and prints the cycles of each phase per warp,
averaged over the blocks.  The probes serialize a little; compare the
phases, not the total with a graph-replay time.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wkv6 import bind, launch  # noqa: E402

# (text in the source, probe before or after it): the probe ends a phase.
MARKS = [("  for (int c = 0; c < nchunks; ++c) {\n", "after"),
         ("    // (1) Cumsum of w", "before"),
         ("    __syncthreads();                                 // (b)", "before"),
         ("    // (2) The diagonal score blocks", "before"),
         ("    const uint32_t pS = smem_u32(sP);", "before"),
         ("    // (c) The scores are written", "before"),
         ("    // (6) y += A v", "before")]
PHASES = ["A v and y of the chunk before", "wait, barrier (a), copies issued",
          "cumsum and decayed operands", "barrier (b), e^{cw_Q}", "diagonal score blocks",
          "factored block, rd S, state update", "barrier (c), state copy", "after the loop"]


def probed(src: str) -> str:
    for i, (mark, where) in enumerate(MARKS):
        if src.count(mark) != 1:
            raise RuntimeError(f"probe mark not found once: {mark!r}")
        code = f"    {{ const unsigned long long nw = clock64(); pacc[{i}] += nw - pt; pt = nw; }}\n"
        src = src.replace(mark, mark + code if where == "after" else code + mark)
    for mark, code in (("  const int nchunks = (S + Q - 1) / Q;\n",
                        "  unsigned long long pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                        "  unsigned long long pt = clock64();\n"),
                       ("  float* sl = p.s_last",
                        "  { const unsigned long long nw = clock64(); pacc[7] += nw - pt; }\n"
                        "  __syncthreads();\n"
                        "  if (lane == 0)\n"
                        "    for (int i = 0; i < 8; ++i)\n"
                        "      p.y[b * p.y_sb + warp * p.y_ss + h * D + col0 + i] = "
                        "(float)pacc[i];\n")):
        if src.count(mark) != 1:
            raise RuntimeError(f"probe mark not found once: {mark!r}")
        src = src.replace(mark, (mark + code) if "nchunks" in mark else (code + mark))
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv_phase_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    sources = [Path(a) for a in sys.argv[1:]] or [build.CSRC / "wkv6_fwd.cu"]
    out = build.BUILD_DIR / "wkv_probe"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, path in enumerate(sources):
        tag = f"{i}-{path.resolve().parent.name}"
        text = probed(path.read_text())
        warps = int(re.search(r"WARPS = (\d+)", text).group(1))
        cu = out / f"{tag}.cu"
        cu.write_text(text)
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{tag}.so"),
                            str(cu)], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        libs[tag] = (bind(ctypes.CDLL(str(out / f"{tag}.so"))), warps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, H, hd = 512, 32, 64
    for B in (4, 1):
        r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        logw = -(0.02 + 2.98 * torch.rand((B, S, H, hd), generator=gen, device="cuda"))
        u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
        for tag, (fn, warps) in libs.items():
            for _ in range(3):
                y, _ = launch(fn, r, k, v, logw, u, None)
            torch.cuda.synchronize()
            cyc = y[:, :warps, :, :8].mean(dim=(0, 2))            # (warps, phases)
            print(f"B={B} S={S} {tag}: cycles per warp over {S // 32} chunks, by phase")
            for i, name in enumerate(PHASES):
                print(f"  {name:36s} {[round(float(x)) for x in cyc[:, i]]}")
            print(f"  {'total':36s} {[round(float(x)) for x in cyc.sum(-1)]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
