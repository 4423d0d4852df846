"""Ground rules of the PyTorch port: it imports neither jax nor anything of
``repro``; its entry points run on cuda unless asked for the CPU and raise
with no card; its configs are exact copies of the reference's."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks import side by side in the tests)
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.models import build

SRC = Path(__file__).resolve().parents[1] / "src"
PORTED = ["llama2-7b", "gemma-2b", "gpt2-1.5b", "starcoder2-3b", "zamba2-7b", "rwkv6-1.6b",
          "moonshot-v1-16b-a3b", "deepseek-v3-671b", "seamless-m4t-large-v2",
          "phi-3-vision-4.2b"]


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in\n"
        "        pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert len(mods) >= 15, mods\n"
        "for sub in ('train', 'data', 'parallel', 'core', 'calibration', 'health', 'obs',\n"
        "            'analysis'):\n"
        "    assert any(m.startswith(f'repro_torch.{sub}.') for m in mods), (sub, mods)\n"
        "for m in ('analysis', 'core.cluster', 'core.sensitivity', 'core.scheduler',\n"
        "          'core.trace', 'health', 'health.monitor', 'health.flaky', 'obs',\n"
        "          'obs.recorder', 'obs.export', 'obs.report', 'analysis.sanitizer',\n"
        "          'analysis.tables', 'core.baselines', 'core.simulator', 'models.moe',\n"
        "          'models.mla', 'configs.moonshot_v1_16b_a3b', 'configs.deepseek_v3_671b',\n"
        "          'models.encdec', 'configs.seamless_m4t_large_v2',\n"
        "          'configs.phi_3_vision_4_2b', 'analysis.lint', 'analysis.rules',\n"
        "          'analysis.rules.rollback', 'core.op_cost', 'core.roofline',\n"
        "          'launch.dryrun', 'kernels.registry'):\n"
        "    assert f'repro_torch.{m}' in mods, (m, mods)\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing the port started a process group'\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_imports_no_jax_and_no_repro():
    """chip_smoke.py, which drives the port on the card, imports neither jax
    nor anything of the JAX package (at any level of the file)."""
    import ast

    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert "repro_torch.models" in names
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad


def test_build_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("llama2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg)
    with pytest.raises(RuntimeError):
        build(cfg, device="cuda")
    assert build(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_build_without_card_raises_for_ssm_families(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg)
    assert build(configs.get_reduced(arch), device="cpu").device.type == "cpu"


LAUNCHERS = {"serve": ["--arch", "llama2-7b", "--gen", "1", "--prompt-len", "4"],
             "train": ["--arch", "llama2-7b", "--steps", "1", "--batch", "2", "--seq", "8"]}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_launcher_defaults_to_cuda(launcher, monkeypatch):
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{launcher}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(LAUNCHERS[launcher])


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_launcher_refuses_reduced_config_on_the_card(launcher, monkeypatch):
    """On its defaults (a reduced config, head dim 16) on the card, a
    launcher stops up front and names the two ways out, before it builds
    anything or reaches a kernel's check."""
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{launcher}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--full .*--device cpu"):
        main(LAUNCHERS[launcher])


@pytest.mark.parametrize("arch", PORTED)
def test_configs_are_exact_copies(arch):
    for get in ("get", "get_reduced"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert dataclasses.asdict(getattr(configs, get)(arch)) == want


@pytest.mark.parametrize("arch", sorted(set(jconfigs.ARCHS) - set(PORTED)))
def test_unported_archs_name_their_roadmap_item(arch):
    with pytest.raises(KeyError, match="ROADMAP A"):
        configs.get(arch)
    jcfg = jconfigs.get_reduced(arch)
    fields = {f.name for f in dataclasses.fields(configs.ModelConfig)}
    cfg = configs.ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                                 if k in fields})
    if cfg.family == "dense":      # only its config is missing: the branch builds it
        assert build(cfg, device="cpu").cfg == cfg
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        build(cfg, device="cpu")
