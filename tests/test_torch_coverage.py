"""Every public name of the JAX package has its counterpart in the port.

The JAX package's modules and ``__graft_entry__.py`` are read with
``ast`` (nothing of them is imported).  Each public top-level name (a
``def``, a ``class`` or a module constant; every top-level function of
``__graft_entry__.py``) must stand at the same module path in the port,
or have an entry in ``COUNTERPARTS`` naming the port's ``module:attr``
that does its work, or an entry in ``NOT_TO_PORT`` under a reason from
``ROADMAP.md``'s "Not to port" list.  A name with none of these is a
module still missing from the port.  Entries that name no JAX name, or a
name that now stands at the same path, are stale.
"""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = "ternary_image_codec_tpu"
PORT = "ternary_image_codec_tpu_torch"
GRAFT = "__graft_entry__"

# JAX name -> the port's module:attr that does its work
COUNTERPARTS = {
    "ops.dec_pallas:check_decode_fn": "ops.dec_cuda:check_decode",
    "ops.dec_pallas:supported": "ops.dec_cuda:supported",
    "ops.rs_pallas:decode_dig_fused": "ops.rs_cuda:rs_correct",
    "ops.rs_pallas:N": "ops.rs:N",
    # the v3 path is one program per config: the port's encode and check
    "ops.pipeline_v3:encode_fn_v3": "ops.encode:encode_superframes",
    "ops.pipeline_v3:check_decode_fn_v3": "ops.pipeline:check_body",
    "ops.pipeline:roundtrip_stream_fn": "ops.pipeline:roundtrip_stream",
    "ops.rs:encode_jit": "ops.rs:encode",
    "ops.rs:decode_jit": "ops.rs:decode",
    "ops.rs:decode_pm": "ops.rs:correct_pm",
    # the port's tracing: spans and counters read by the benchmark
    "runtime.tracing:stage_timer": "runtime.tracing:span",
    "runtime.tracing:stage_report": "runtime.tracing:report",
    "ops.gf27:inv_pm": "ops.rs:inv_pm",
    f"{GRAFT}:entry": "entry:entry",
    f"{GRAFT}:_make_raw_words": "entry:make_raw_words",
    f"{GRAFT}:dryrun_multichip": "parallel.dryrun:dryrun_multichip",
}

# reason (a phrase of ROADMAP.md's "Not to port" list) -> JAX names
NOT_TO_PORT = {
    "The A/B knobs and their dead branches": (
        "ops.pipeline:env_repair_sfb", "ops.pipeline_v3:encode_supported",
        "ops.pipeline_v3:decode_supported"),
    "The f32 reciprocal divmods": ("ops.gf27:ffloordiv", "ops.gf27:fmod3"),
    "The GF(27) digit primitives": tuple(
        f"ops.gf27:{n}" for n in ("add_dig", "sub_dig", "neg_dig", "mul_dig",
                                  "scale_dig", "inv_dig", "inv_dig_onehot",
                                  "is_zero_dig", "mul_pm", "mod3_matmul")),
    "The RS codec's other layouts": tuple(
        f"ops.rs:{n}" for n in ("encode_dig", "syndromes", "syndromes_dig",
                                "decode_dig_paged", "encode_pm_blocks",
                                "decode_pm_bk", "decode_delta_pm_bk",
                                "decode_paged_pm")),
    "The scramble primitives": tuple(
        f"ops.scramble:{n}" for n in ("scramble", "descramble",
                                      "scramble_dig", "scramble_masked")),
    "`pipeline.PerformanceWarning`": ("ops.pipeline:PerformanceWarning",),
}
REASONS = {name: why for why, names in NOT_TO_PORT.items() for name in names}


def _top_names(path, private=False):
    """Top-level defs, classes and assigned names of one source file."""
    out = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.append(node.name)
        elif private:
            continue
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                out += [e.id for e in elts if isinstance(e, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.append(node.target.id)
    return [n for n in out if private or not n.startswith("_")]


def jax_names():
    """'module:name' of every public top-level name of the JAX package
    (module relative to the package, '' for the package itself) and of
    every top-level function of ``__graft_entry__.py``."""
    out = []
    for path in sorted((ROOT / REF).rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT / REF).with_suffix("").parts)
        mod = mod.removesuffix("__init__").removesuffix(".")
        out += [f"{mod}:{n}" for n in _top_names(path)]
    out += [f"{GRAFT}:{n}" for n in _top_names(ROOT / f"{GRAFT}.py",
                                               private=True)]
    return out


NAMES = jax_names()


def _port_has(spec):
    mod, attr = spec.split(":")
    try:
        m = importlib.import_module(f"{PORT}.{mod}" if mod else PORT)
    except ModuleNotFoundError:
        return False
    return hasattr(m, attr)


def _same_path(name):
    return not name.startswith(f"{GRAFT}:") and _port_has(name)


def _not_to_port_list():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not to port.**")
    return text[start:text.index("\n### ", start)]


def test_names_are_read():
    assert len(NAMES) == len(set(NAMES)) > 300
    assert {f"{GRAFT}:entry", f"{GRAFT}:_make_raw_words",
            "ops.pipeline:decode_profile_to_raw", "config:EncoderConfig",
            "ops.rs:N"} <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_name_has_counterpart(name):
    if name in COUNTERPARTS:
        assert _port_has(COUNTERPARTS[name]), \
            f"{name}: counterpart {COUNTERPARTS[name]} is not in the port"
    elif name in REASONS:
        assert REASONS[name] in _not_to_port_list(), \
            f"{name}: reason {REASONS[name]!r} is not in ROADMAP.md"
    else:
        assert _same_path(name), \
            f"{name} has no counterpart in the port: a module still missing"


def test_table_entries_are_live():
    names = set(NAMES)
    assert not set(COUNTERPARTS) & set(REASONS)
    for name in [*COUNTERPARTS, *REASONS]:
        assert name in names, f"{name} names no JAX name"
        assert not _same_path(name), f"{name} now stands at the same path"
