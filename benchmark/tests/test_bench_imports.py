"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: every import of every
``.py`` under ``benchmark/``, compared by whole top-level names (the
port's package name begins with the JAX package's)."""

import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "cnn_graph_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    bad = {(str(f.relative_to(BENCH)), name) for f in files
           for name in _imports(f) if name in FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    bad = {(f.name, name) for f in files for name in _imports(f)
           if name == "cnn_graph_tpu_torch"}
    assert not bad


def test_the_check_itself_sees_an_import():
    src = BENCH / "reference" / "_probe_tmp.py"
    src.write_text("import jax.numpy as jnp\nfrom cnn_graph_tpu_torch "
                   "import ops\n")
    try:
        names = set(_imports(src))
    finally:
        src.unlink()
    assert names == {"jax", "cnn_graph_tpu_torch"}


def test_run_py_refuses_jax_by_whole_names():
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location("bench_run",
                                                  BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_loaded() == []
    sys.modules["jax_like_but_not"] = object()
    sys.modules["cnn_graph_tpu"] = object()
    try:
        assert run.forbidden_loaded() == ["cnn_graph_tpu"]
    finally:
        del sys.modules["jax_like_but_not"], sys.modules["cnn_graph_tpu"]
