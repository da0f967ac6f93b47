"""The PyTorch port stands alone and runs on a card unless asked not to.

- No file of ``sepreformer_torch/`` and not ``chip_smoke.py`` imports
  ``jax``, ``flax`` or ``sepreformer_tpu``; importing the port, and
  running its CLI, loads none of them.
- The entry points default to CUDA and raise without a card instead of
  running on the CPU; ``chip_smoke.py`` fails and prints no result.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "sepreformer_tpu")


def port_files():
    return sorted((ROOT / "sepreformer_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, sepreformer_torch\n"
        "for m in pkgutil.walk_packages(sepreformer_torch.__path__,"
        " 'sepreformer_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cli_runs_without_jax():
    """``python -m sepreformer_torch.cli --list-models`` in a process of
    its own lists the presets; the CLI module, the data pipeline and the
    engine load no JAX module."""
    proc = subprocess.run(
        [sys.executable, "-m", "sepreformer_torch.cli", "--list-models"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [
        "SepReformer_Base_Libri2Mix", "SepReformer_Base_WSJ0",
        "SepReformer_L", "SepReformer_Large_DM_WHAM",
        "SepReformer_Large_DM_WHAMR", "SepReformer_Large_DM_WSJ0",
        "SepReformer_M", "SepReformer_S", "SepReformer_T", "tiny"]
    code = (
        "import sys\n"
        "from sepreformer_torch import cli\n"
        "import sepreformer_torch.data, sepreformer_torch.engine.engine\n"
        "assert cli.main(['--list-models']) == 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_raise_without_card(no_card):
    from sepreformer_torch import build_model, get_variant, load_separator
    from sepreformer_torch.models import from_jax_params

    cfg = get_variant("tiny").model
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_separator("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({}, {}, cfg)


def test_chip_smoke_fails_without_card(no_card, tmp_path):
    """Without a card, and alone in a directory, the script exits non-zero
    and prints no result."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
