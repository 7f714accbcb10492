"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program. Module names are compared by
their top-level name, whole: ``zs_aac_tpu_torch`` is not ``zs_aac_tpu``."""

import ast
import subprocess
import sys
import types

from benchmark import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in FILES:
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_references_import_nothing_of_the_program():
    refs = [p for p in FILES if p.parent.name == "reference"]
    assert refs
    for path in refs:
        assert "zs_aac_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("zs_aac_tpu_torch", "zs_aac_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "zs_aac_tpu.models", types.ModuleType("zs_aac_tpu.models"))
    assert set(harness.forbidden_modules()) - set(before) == {"jax", "zs_aac_tpu"}


def test_a_run_loads_no_jax():
    """A tiny caption run of each configuration, in a fresh process, through
    the drivers, programs and references, leaves no forbidden module loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "from benchmark.tests.tiny import tiny_ctx\n"
        "for cell in ('gpt2.caption.q8.b8192', 'mistral7b.caption.q8.b2048'):\n"
        "    ctx = tiny_ctx(cell)\n"
        "    drv = harness.load_module('drivers', ctx.mix['driver'])\n"
        "    st = drv.setup(ctx)\n"
        "    harness.run_window(drv, st, 0.0)\n"
        "    drv.check(st, ctx)\n"
        "print(harness.forbidden_modules())\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                          "gpt2.caption.q8.b8192", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
