#!/usr/bin/env python3
"""Where a block's time goes in the bf16 WKV6 backward's chunk kernel, by
clock64 probes.

    python3 tools/wkv_bwd_phase_probe.py [source.cu ...]

For each source (default: ``src/repro_torch/kernels/csrc/wkv6_bwd.cu``) this
script writes a copy of ``wkv6_bwd_chunk_kernel`` with ``clock64()`` read at
its phase boundaries (the barriers); at the end lane 0 of each warp writes
its cycles per phase into du's partials of its block (the probed copy's du
is not the function's du).  It builds the copies with nvcc, runs each at the
rwkv6-1.6b train shape (B 4, S 512, 32 heads of 64, bf16) and prints the
cycles of each phase per warp, averaged over the 2,048 blocks, with the
largest block's beside them.  The probes serialize a little; compare the
phases, not the total with a graph-replay time.  Two blocks share an SM, so
a phase's cycles include the other block's issue.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wkv6 import _DTYPE_CODE, bind_bwd, bind_bwd_sizes  # noqa: E402

# Comments on the chunk kernel's barriers: a phase ends after each (once each).
MARKS = ["// (a) the rows;", "// (b) the operands are visible", "// S_c and dS_c have landed",
         "// (c) sD is written;", "// (d) A, dr's and dk's diagonal terms", "// (e) dlogw's terms"]
PHASES = ["(0) copies issued, the rows landed", "(1) cumsum and operands, barrier (b)",
          "(2)-(3) D, A's block; S_c, dS_c landed", "(4) state products, rowsum, (c)",
          "(5) diagonal blocks, (d)", "(6)-(7) factored blocks, dv, stores, (e)",
          "(8) dlogw and du"]
START = "  // (0) The chunk's rows (zero past S), S_c and dS_c.\n"
DU_STORE = "    p.du_part[(((long long)b * nc + c) * H + h) * D + cc] = s;\n"
KERNEL_END = "\ntemplate <typename K>\ncudaError_t prepare("


def probed(src: str) -> str:
    for mark in MARKS + [START, DU_STORE, KERNEL_END]:
        if src.count(mark) != 1:
            raise RuntimeError(f"probe mark not found once: {mark!r}")
    for i, mark in enumerate(MARKS):
        eol = src.index("\n", src.index(mark)) + 1
        code = f"  {{ const unsigned long long nw = clock64(); pacc[{i}] += nw - pt; pt = nw; }}\n"
        src = src[:eol] + code + src[eol:]
    src = src.replace(START, "  unsigned long long pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                             "  unsigned long long pt = clock64();\n" + START)
    src = src.replace(DU_STORE, "    (void)s;\n")
    # the last phase ends where the kernel's body does (its closing brace)
    body_end = src.index(KERNEL_END)
    close = src.rindex("\n}\n", 0, body_end)
    tail = (f"\n  {{ const unsigned long long nw = clock64(); pacc[{len(MARKS)}] += nw - pt; }}\n"
            "  if (lane == 0)\n"
            "    for (int i = 0; i < 8; ++i)\n"
            "      p.du_part[(((long long)b * nc + c) * H + h) * D + 8 * warp + i] = "
            "(float)pacc[i];")
    return src[:close] + tail + src[close:]


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv_bwd_phase_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    sources = [Path(a) for a in sys.argv[1:]] or [build.CSRC / "wkv6_bwd.cu"]
    out = build.BUILD_DIR / "wkv_bwd_probe"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, path in enumerate(sources):
        tag = f"{i}-{path.resolve().parent.name}"
        cu = out / f"{tag}.cu"
        cu.write_text(probed(path.read_text()))
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{tag}.so"),
                            str(cu)], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out / f"{tag}.so"))
        libs[tag] = (bind_bwd(lib), bind_bwd_sizes(lib))
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, hd = 4, 512, 32, 64
    proj = torch.randn((B, S, 3, H * hd), generator=gen, device="cuda").to(torch.bfloat16)
    r, k, v = (proj[:, :, j].view(B, S, H, hd) for j in range(3))
    logw = -(0.02 + 2.98 * torch.rand((B, S, H, hd), generator=gen, device="cuda"))
    u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
    dy = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    code = _DTYPE_CODE[torch.bfloat16]
    for tag, (fn, sizes) in libs.items():
        scratch_bytes, parts = sizes(B, S, H, code)
        outs = [torch.empty_like(r) for _ in range(3)] + [torch.empty_like(dy)]
        du_part = torch.empty((B, parts, H, hd), device="cuda")
        ds0 = torch.empty((B, H, hd, hd), device="cuda")
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device="cuda")
        for _ in range(3):
            rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                    None, dy.data_ptr(), None, scratch.data_ptr(),
                    *(t.data_ptr() for t in outs), du_part.data_ptr(), ds0.data_ptr(),
                    B, S, H, hd, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *logw.stride()[:3], code, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{tag}: launch failed, cudaError {rc}")
        torch.cuda.synchronize()
        cyc = du_part.reshape(-1, 8, 8)[..., :len(PHASES)]       # (blocks, warps, phases)
        mean, top = cyc.mean(dim=0), cyc.amax(dim=0)
        print(f"{tag}: chunk kernel cycles per warp by phase (B={B} S={S} H={H}; "
              f"mean over {cyc.shape[0]} blocks, the largest beside it)")
        for i, name in enumerate(PHASES):
            print(f"  {name:42s} {[round(float(x)) for x in mean[:, i]]} "
                  f"max {round(float(top[:, i].max()))}")
        print(f"  {'total':42s} {[round(float(x)) for x in mean.sum(-1)]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
