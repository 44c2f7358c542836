"""The PyTorch port imports neither jax nor anything of the JAX package:
not when imported, not in its code, not in its scripts."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ternary_image_codec_tpu_torch"
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "profile_port.py"]
REF = "ternary_image_codec_tpu"


def _submodules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_import_leaves_jax_out():
    mods = _submodules()
    assert "ternary_image_codec_tpu_torch.ops.dec_cuda" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"ref = {REF!r}\n"
            "print(sorted(m for m in sys.modules if m in ('jax', ref) "
            "or m.startswith(('jax.', ref + '.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + SCRIPTS,
                         ids=lambda p: str(p.relative_to(PKG))
                         if PKG in p.parents else p.name)
def test_no_jax_import_in_source(path):
    for name in _imports(path):
        assert name != "jax" and not name.startswith("jax."), name
        assert name != REF and not name.startswith(REF + "."), name
