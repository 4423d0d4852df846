#!/usr/bin/env python3
"""Time the bf16 WKV6 kernel at other launch shapes on one NVIDIA card.

    python3 tools/wkv_tile_sweep.py [--reps 20] [--variants 1x1 2x2]
                                    [--baseline other_version.cu ...]

The launch shape of the bf16 kernel in
``src/repro_torch/kernels/csrc/wkv6_fwd.cu`` is one line, ``struct Tile
{...}``: NSPLIT, the blocks that split a (batch, head)'s state columns,
and the blocks per SM its launch bounds ask for, which caps the registers a
thread may use.  A variant ``NxM`` is NSPLIT = N, MIN_BLOCKS = M.  For each
variant this script writes a copy of the source with that line replaced,
builds all copies with nvcc at once, checks each against ``wkv6_plain`` (y
and S_last at 2e-5 of max|plain|, the limit of chip_smoke.py), and times
each as CUDA-graph replays at the shapes below, in two passes (variants in
order, then reversed).  ``--baseline`` adds other versions of the source,
each built as it is (e.g. an earlier kernel) and named by its directory, to
the same passes.  S = 1 runs the decode kernel, which no variant changes.

Prints one JSON line per variant (ptxas registers and spills of each
kernel, shared memory per block, blocks per SM), one per (shape, variant),
then the card's name and power limit.  Exits nonzero if a build fails or a
variant disagrees.
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
sys.path.insert(0, str(ROOT))

from chip_smoke import TOL_STATE, graph_ms, rel_err, wkv_bound  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wkv6 import _check, bind, launch, wkv6_plain  # noqa: E402

VARIANTS = ["1x1", "2x2"]
# (label, B, S, H, s0): rwkv6-1.6b prefill at batch 4, prompt 512, a longer
# prompt, batch 1, and a decode step from a state.
SHAPES = [("rwkv6-1.6b prefill", 4, 512, 32, False),
          ("S=4096", 4, 4096, 32, False),
          ("batch 1", 1, 512, 32, False),
          ("decode step S=1", 4, 1, 32, True)]
TILE_LINE = re.compile(r"^struct Tile \{.*\};$", re.M)
HD = 64


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = re.findall(r"wkv6_(?:fwd_bf16|fwd_f32|decode|fwd)_kernel", ln)[-1]
            if "decode" in name:
                name += "<bf16>" if "bfloat" in ln or "__nv_bf" in ln else "<f32>"
        elif name and "spill stores" in ln:
            out.setdefault(name, {})["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif name and "Used" in ln:
            out.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


def build_variants(source: Path, variants, baselines: list[Path], out: Path) -> dict:
    src = source.read_text()
    if len(TILE_LINE.findall(src)) != 1:
        raise RuntimeError("the Tile line of wkv6_fwd.cu was not found once")
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for tag in variants:
        nsplit, blocks = (int(x) for x in tag.split("x"))
        line = f"struct Tile {{ static constexpr int NSPLIT = {nsplit}, MIN_BLOCKS = {blocks}; }};"
        cu = out / f"split{tag}.cu"
        cu.write_text(TILE_LINE.sub(line, src))
        sources[f"split{tag}"] = cu
    for path in baselines:
        sources[path.resolve().parent.name] = path.resolve()
    procs = {}
    for tag, cu in sources.items():
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{tag}.so"), str(cu)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{tag}.so"))
        info = {"variant": tag, "ptxas": _ptxas(log)}
        if hasattr(lib, "wkv6_fwd_bf16_blocks_per_sm"):
            smem, occ = lib.wkv6_fwd_smem_bytes, lib.wkv6_fwd_bf16_blocks_per_sm
            smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
            occ.argtypes, occ.restype = [], ctypes.c_int
            info.update(smem_bytes=smem(HD, 1), blocks_per_sm=occ())
        libs[tag] = bind(lib)
        print(json.dumps(info), flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="+", metavar="NxM", default=VARIANTS,
                    help="NSPLIT x blocks per SM")
    ap.add_argument("--baseline", type=Path, nargs="*", default=[],
                    help="other versions of the kernel source, each timed as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 1
    libs = build_variants(build.CSRC / "wkv6_fwd.cu", args.variants, args.baseline,
                          build.BUILD_DIR / "wkv_sweep")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for label, B, S, H, with_s0 in SHAPES:
        r, k, v = (torch.randn((B, S, H, HD), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        logw = -(0.02 + 2.98 * torch.rand((B, S, H, HD), generator=gen, device="cuda"))
        u = 0.5 * torch.randn((H, HD), generator=gen, device="cuda")
        s0 = torch.randn((B, H, HD, HD), generator=gen, device="cuda") if with_s0 else None
        args_ = (r, k, v, logw, u, s0)
        _check(*args_)
        py, ps = wkv6_plain(*args_)
        runs = {tag: launch(fn, *args_) for tag, fn in libs.items()}
        torch.cuda.synchronize()
        times = {tag: [] for tag in runs}
        for order in (list(runs), list(runs)[::-1]):
            for tag in order:
                fn = libs[tag]
                times[tag].append(graph_ms(lambda: launch(fn, *args_), args.reps))
        bms = wkv_bound(B, S, H, HD, with_s0, torch.bfloat16)[0]
        for tag, (y, s) in runs.items():
            err_y, err_s = rel_err(y, py), rel_err(s, ps)
            ok = err_y <= TOL_STATE and err_s <= TOL_STATE
            if not ok:
                failed.append((label, tag))
            print(json.dumps({"shape": label, "B": B, "S": S, "H": H, "s0": with_s0,
                              "variant": tag, "ms": times[tag], "bound_ms": bms,
                              "x_bound": min(times[tag]) / bms, "rel_err_y": err_y,
                              "rel_err_s_last": err_s, "ok": ok}), flush=True)
        del r, k, v, logw, u, s0, py, ps, runs
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if failed:
        print(f"variants disagree with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
