"""Nothing under t3bench/ imports JAX or the JAX package, whose top-level
names are compared whole (the port's name begins with the JAX package's);
the reference imports nothing of the port either."""
import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ternary_image_codec_tpu"}
PORT = "ternary_image_codec_tpu_torch"


def tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ":" in node.value and "." in node.value:
            yield node.value.split(".")[0]      # "module:attr" targets


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for p in files:
        assert not set(tops(p)) & FORBIDDEN, p


def test_reference_stands_alone():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for p in files:
        names = set(tops(p))
        assert PORT not in names and "t3bench" not in names, p


def test_the_check_is_whole_names():
    assert PORT.split(".")[0] not in FORBIDDEN
