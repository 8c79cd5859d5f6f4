"""Import hygiene of the PyTorch port: ``repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of the JAX package ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_module_names()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_core_all_is_a_subset_of_the_reference():
    import repro.core
    import repro_torch.core

    assert set(repro_torch.core.__all__) <= set(repro.core.__all__)
    for name in repro_torch.core.__all__:
        assert hasattr(repro_torch.core, name), name


@pytest.mark.parametrize("name", ["apply_subspace", "materialize_winner"])
def test_core_exports_subspace_dgo(name):
    """The reference's ``repro.core`` exports both
    (``src/repro/core/__init__.py:40``); so does the port's."""
    import repro_torch.core
    from repro_torch.core import subspace

    assert name in repro_torch.core.__all__
    assert getattr(repro_torch.core, name) is getattr(subspace, name)


KERNELS = ("popstep", "graycode", "fixedpoint", "popmin", "flash_attention")


@pytest.mark.parametrize("name", KERNELS)
def test_every_kernel_package_is_covered(name):
    """Each kernel package's build, wrapper and oracle modules are among
    the modules imported above, and its library names sources that
    exist (a ``.cu`` first)."""
    import importlib

    mods = _module_names()
    assert "repro_torch.kernels._build" in mods
    for part in ("kernel", "ops", "ref"):
        assert f"repro_torch.kernels.{name}.{part}" in mods
    lib = importlib.import_module(f"repro_torch.kernels.{name}.kernel").LIBRARY
    assert lib.name == name and lib.sources[0].endswith(".cu")
    assert all((lib.csrc / s).is_file() for s in lib.sources)


@pytest.mark.parametrize("name", KERNELS)
def test_every_kernel_wrapper_imports_first(name):
    """A kernel's wrapper module imports in a fresh interpreter before any
    other module of the port (``core`` imports the popstep wrapper while
    that wrapper's own imports are still running)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c",
                    f"import repro_torch.kernels.{name}.ops"], env=env,
                   cwd=ROOT, capture_output=True, text=True, timeout=120,
                   check=True)


ZOO = ("repro_torch.configs", "repro_torch.configs.qwen2_1_5b",
       "repro_torch.configs.codeqwen1_5_7b", "repro_torch.configs.gemma3_27b",
       "repro_torch.configs.granite_34b", "repro_torch.configs.whisper_medium",
       "repro_torch.configs.phi3_vision_4_2b", "repro_torch.configs.shapes",
       "repro_torch.models", "repro_torch.models.layers",
       "repro_torch.models.attention", "repro_torch.models.blocks",
       "repro_torch.models.lm", "repro_torch.launch",
       "repro_torch.launch.serve")


@pytest.mark.parametrize("name", ZOO)
def test_every_zoo_module_is_covered(name):
    """The serving slice's modules are among the modules imported above."""
    assert name in _module_names()


TRAIN = ("repro_torch.core.prng", "repro_torch.core.tree",
         "repro_torch.core.subspace", "repro_torch.core.meta",
         "repro_torch.data", "repro_torch.data.pipeline",
         "repro_torch.optim", "repro_torch.optim.gradient",
         "repro_torch.checkpoint", "repro_torch.checkpoint.store",
         "repro_torch.launch.train")


@pytest.mark.parametrize("name", TRAIN)
def test_every_train_module_is_covered(name):
    """The train path's and subspace DGO's modules are among the modules
    imported above."""
    assert name in _module_names()
