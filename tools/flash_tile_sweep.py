#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel at other tile shapes on one NVIDIA card.

    python3 tools/flash_tile_sweep.py [--reps 20] [--variants 4,1,32 4,1,64 ...]
                                      [--source other_version.cu]

The tile shape of the bf16 kernel in
``src/repro_torch/kernels/csrc/flash_attention_fwd.cu`` is one line,
``template <int D> struct Tile {...}``: warps per block, m16 tiles (16 query
rows) per warp, keys per K/V tile.  For each variant below this script
writes a copy of the source with that line replaced (the same shape for
every head dim), builds all copies with nvcc at once, checks each against
``flash_attention_plain`` (o per row at 3e-2, lse at 2e-4 absolute, the
limits of chip_smoke.py), and times each by CUDA events at the serving
shapes of each head dim, in two passes (variants in order, then reversed).

Prints one JSON line per variant (ptxas registers and spills per head-dim pair,
shared memory per block), one per (shape, variant), then the card's name and
power limit.  Exits nonzero if a build fails or a variant disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _check,
    bind,
    flash_attention_plain,
    launch,
)

# (warps per block, m16 tiles per warp, keys per tile).
VARIANTS = [(4, 1, 64), (4, 1, 32), (8, 1, 64), (8, 1, 32), (4, 2, 64), (2, 1, 32),
            (2, 1, 64), (2, 2, 32)]
# (label, B, S, Hq, Hkv, d): causal prefill at batch 4, prompt 512, and one
# longer prompt.
SHAPES = [("llama2-7b prefill", 4, 512, 32, 32, 128),
          ("llama2-7b S=2048", 4, 2048, 32, 32, 128),
          ("zamba2-7b shared block", 4, 512, 32, 32, 112),
          ("gpt2-1.5b", 4, 512, 25, 25, 64),
          ("phi-3-vision-4.2b prefill d=96", 4, 1088, 32, 32, 96),
          ("gemma-2b MQA", 4, 512, 8, 1, 256)]
TILE_LINE = re.compile(r"^template <int D> struct Tile \{.*\};$", re.M)


def build_variants(source: Path, variants, out: Path) -> dict:
    src = source.read_text()
    if len(TILE_LINE.findall(src)) != 1:
        raise RuntimeError("the Tile line of flash_attention_fwd.cu was not found once")
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for w, mt, bn in variants:
        tag = f"w{w}_mt{mt}_bn{bn}"
        line = (f"template <int D> struct Tile {{ static constexpr int WARPS = {w}, "
                f"MT = {mt}, BN = {bn}; }};")
        cu = out / f"{tag}.cu"
        cu.write_text(TILE_LINE.sub(line, src))
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{tag}.so"), str(cu)]
        procs[(w, mt, bn)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        tag = "w{}_mt{}_bn{}".format(*key)
        lib = ctypes.CDLL(str(out / f"{tag}.so"))
        smem = lib.flash_attention_fwd_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
        ptxas, d = {}, None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                m = re.search(r"flash_fwd_bf16_kernelILi(\d+)ELi(\d+)EE", ln)
                d = f"{m.group(1)}/{m.group(2)}" if m else None
                if d:
                    ptxas[d] = {"smem_bytes": smem(int(m.group(1)), int(m.group(2)), 1)}
            elif d and "spill stores" in ln:
                ptxas[d]["spill_store_bytes"] = int(re.search(r"(\d+) bytes spill stores",
                                                              ln).group(1))
            elif d and "Used" in ln:
                ptxas[d]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        libs[key] = bind(lib)
        print(json.dumps({"variant": dict(zip(("warps", "mt", "bn"), key)), "ptxas": ptxas}),
              flush=True)
    return libs


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="+", metavar="WARPS,MT,BN",
                    type=lambda v: tuple(int(x) for x in v.split(",")), default=VARIANTS)
    ap.add_argument("--source", type=Path, default=build.CSRC / "flash_attention_fwd.cu",
                    help="another version of the kernel source, to compare two versions "
                         "in one call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(args.source, args.variants, build.BUILD_DIR / "tile_sweep")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for label, B, S, Hq, Hkv, d in SHAPES:
        q = torch.randn((B, S, Hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, S, Hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        _check(q, k, v)
        po, plse = flash_attention_plain(q, k, v, causal=True)
        runs = {}
        for key, fn in libs.items():
            try:        # a tile shape may not fit this head dim (shared memory)
                runs[key] = launch(fn, q, k, v, causal=True, window=0, scale=None)
            except RuntimeError as e:
                print(json.dumps({"shape": label, "d": d,
                                  "variant": dict(zip(("warps", "mt", "bn"), key)),
                                  "launch_error": str(e)}), flush=True)
        torch.cuda.synchronize()
        times = {key: [] for key in runs}
        for order in (list(runs), list(runs)[::-1]):
            for key in order:
                fn = libs[key]
                times[key].append(cuda_ms(
                    lambda: launch(fn, q, k, v, causal=True, window=0, scale=None), args.reps))
        for key, (o, lse) in runs.items():
            d_o = (o.float() - po.float()).abs()
            row_rel = (d_o.amax(-1) / po.float().abs().amax(-1).clamp_min(1e-30)).max().item()
            err_lse = (lse - plse).abs().max().item()
            ok = row_rel <= 3e-2 and err_lse <= 2e-4
            if not ok:
                failed.append((label, key))
            print(json.dumps({"shape": label, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "d": d,
                              "variant": dict(zip(("warps", "mt", "bn"), key)),
                              "ms": times[key], "row_rel_err_o": row_rel,
                              "max_abs_err_lse": err_lse, "ok": ok}), flush=True)
        del q, k, v, po, plse
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if failed:
        print(f"variants disagree with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
