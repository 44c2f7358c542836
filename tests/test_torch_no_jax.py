"""The PyTorch port imports neither jax nor anything of the JAX package,
nor the JAX package's entry points in ``__graft_entry__.py``: not when
imported, not in its code, not in its scripts."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ternary_image_codec_tpu_torch"
# scripts, and the module that test ranks import afresh
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "profile_port.py",
           ROOT / "tests" / "torch_mesh_ranks.py"]
REF = "ternary_image_codec_tpu"
GRAFT = "__graft_entry__"     # the JAX package's entry points


def _submodules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_import_leaves_jax_out():
    mods = _submodules()
    for name in ("ops.dec_cuda", "ops.interleave", "ops.trits",
                 "ops.subword", "ops.quant", "ops.wordcodec", "io.image",
                 "io.serve", "io.containers", "io.legacy_containers",
                 "ops.wirepack", "security.policy", "security.route",
                 "runtime.executor", "runtime.native", "runtime.tracing",
                 "ops.proto", "profiles", "io.formats", "io.video", "cli",
                 "cli.sigs", "cli.main", "cli.main_bare", "cli.t3proto_tool",
                 "cli.minitest_aniso_rc", "cli.minitest_trits",
                 "cli.minitest_codec", "cli.minitest_images", "cli.t3dump",
                 "cli.minitest_t3containers", "cli.main_video_t3v",
                 "cli.demo_write_video", "cli.channel_qa", "parallel",
                 "parallel.launch", "parallel.mesh", "parallel.dryrun",
                 "parallel.probe", "bench", "bench.damage", "bench.headline",
                 "bench.rs_bench", "bench.full_mode_bench",
                 "bench.serve_bench", "entry"):
        assert f"ternary_image_codec_tpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"ref = {REF!r}\n"
            "print(sorted(m for m in sys.modules if m in ('jax', ref, "
            f"{GRAFT!r}) or m.startswith(('jax.', ref + '.'))))")
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
        assert name != GRAFT, name


def test_native_library_is_the_ports_own():
    """The port builds its own copy of t3native.cpp into the repository's
    build directory and never opens the JAX package's library."""
    from ternary_image_codec_tpu_torch.runtime import native
    ref = (ROOT / REF).resolve()
    paths = {"source": native.SRC, "build dir": native.BUILD_DIR,
             "library": native.so_path()}
    for what, path in paths.items():
        assert ref not in path.resolve().parents, (what, path)
    assert PKG.resolve() in native.SRC.resolve().parents
    assert native.SRC.is_file()
    assert native.BUILD_DIR.resolve() == (ROOT / "build" / "t3native").resolve()
