#!/usr/bin/env python3
"""Time the bf16 SSD-scan kernel at other launch shapes on one NVIDIA card.

    python3 tools/ssd_tile_sweep.py [--reps 20] [--variants 4 3 2]
                                    [--baseline other_version.cu ...]

The launch shape of the bf16 kernel in
``src/repro_torch/kernels/csrc/ssd_scan_fwd.cu`` is one line, ``struct
Tile {...}``: the blocks per SM its launch bounds ask for, which caps the
registers a thread may use (shared memory alone allows four).  For each
variant below this script writes a copy of the source with that line
replaced, builds all copies with nvcc at once, checks each against
``ssd_scan_plain`` (y at 3e-2 of max|plain|, h_last at 2e-5, the limits of
chip_smoke.py), and times each as CUDA-graph replays at the shapes below,
in two passes (variants in order, then reversed).  ``--baseline`` adds
other versions of the source, each built as it is (e.g. an earlier kernel)
and named by its directory, to the same passes.

Prints one JSON line per variant (ptxas registers and spills, shared memory
per block, blocks per SM), one per (shape, variant), then the card's name
and power limit.  Exits nonzero if a build fails or a variant disagrees.
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

from chip_smoke import graph_ms, rel_err, ssd_bound  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import _check, bind, launch, ssd_scan_plain  # noqa: E402

# Blocks per SM in the launch bounds.
VARIANTS = [4, 3, 2]
# (label, B, S, H, h0): zamba2-7b prefill at batch 4, prompt 512, a longer
# prompt, batch 1, and a ragged prompt from a state.
SHAPES = [("zamba2-7b prefill", 4, 512, 112, False),
          ("S=4096", 4, 4096, 112, False),
          ("batch 1", 1, 512, 112, False),
          ("ragged S=1000, h0", 2, 1000, 112, True)]
TILE_LINE = re.compile(r"^struct Tile \{.*\};$", re.M)
P = N = 64


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = "bf16" if "bf16" in ln else "f32"
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
        raise RuntimeError("the Tile line of ssd_scan_fwd.cu was not found once")
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for blocks in variants:
        line = f"struct Tile {{ static constexpr int MIN_BLOCKS = {blocks}; }};"
        cu = out / f"blocks{blocks}.cu"
        cu.write_text(TILE_LINE.sub(line, src))
        sources[f"blocks{blocks}"] = cu
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
        if hasattr(lib, "ssd_scan_fwd_bf16_blocks_per_sm"):
            smem, occ = lib.ssd_scan_fwd_smem_bytes, lib.ssd_scan_fwd_bf16_blocks_per_sm
            smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
            occ.argtypes, occ.restype = [], ctypes.c_int
            info.update(smem_bytes=smem(P, N, 1), blocks_per_sm=occ())
        libs[tag] = bind(lib)
        print(json.dumps(info), flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="+", metavar="BLOCKS", type=int, default=VARIANTS)
    ap.add_argument("--baseline", type=Path, nargs="*", default=[],
                    help="other versions of the kernel source, each timed as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 1
    libs = build_variants(build.CSRC / "ssd_scan_fwd.cu", args.variants, args.baseline,
                          build.BUILD_DIR / "ssd_sweep")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for label, B, S, H, with_h0 in SHAPES:
        conv = torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda").to(torch.bfloat16)
        x = conv[..., :H * P].view(B, S, H, P)
        Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
        dt = 0.05 + 0.95 * torch.rand((B, S, H), generator=gen, device="cuda")
        A = -(0.3 + 1.7 * torch.rand((H,), generator=gen, device="cuda"))
        h0 = torch.randn((B, H, P, N), generator=gen, device="cuda") if with_h0 else None
        args_ = (x, dt, A, Bm, Cm, h0)
        _check(*args_)
        py, ph = ssd_scan_plain(*args_)
        runs = {tag: launch(fn, *args_) for tag, fn in libs.items()}
        torch.cuda.synchronize()
        times = {tag: [] for tag in runs}
        for order in (list(runs), list(runs)[::-1]):
            for tag in order:
                fn = libs[tag]
                times[tag].append(graph_ms(lambda: launch(fn, *args_), args.reps))
        bms = ssd_bound(B, S, H, P, N, with_h0, torch.bfloat16)[0]
        for tag, (y, h) in runs.items():
            err_y, err_h = rel_err(y, py), rel_err(h, ph)
            ok = err_y <= 3e-2 and err_h <= 2e-5
            if not ok:
                failed.append((label, tag))
            print(json.dumps({"shape": label, "B": B, "S": S, "H": H, "h0": with_h0,
                              "variant": tag, "ms": times[tag], "bound_ms": bms,
                              "x_bound": min(times[tag]) / bms, "rel_err_y": err_y,
                              "rel_err_h_last": err_h, "ok": ok}), flush=True)
        del conv, x, Bm, Cm, dt, A, h0, py, ph, runs
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if failed:
        print(f"variants disagree with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
