"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the program's own name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from pb_core import program, spec

REF = spec.BENCH_DIR / "pb_reference"


def _modules(pkg):
    return sorted(f"{pkg}.{p.stem}" for p in (spec.BENCH_DIR / pkg).glob("*.py")
                  if p.stem != "__init__")


def _load(mods, extra=""):
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(spec.BENCH_DIR)!r}, {str(spec.ROOT)!r}]\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        + extra
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)


def test_harness_program_and_readers_load_no_jax():
    mods = _modules("pb_core") + _modules("pb_drivers") + _modules("pb_reference")
    extra = (
        "from pb_core import program, spec\n"
        "program.load()\n"
        "for p in (spec.BENCH_DIR / 'metrics').glob('*.py'):\n"
        "    spec.metric_reader(p.stem)\n"
        "import runpy\n"
        "bad = program.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'simplepathtracer_tpu_torch' in sys.modules\n"
        "print('ok')\n"
    )
    out = _load(mods, extra)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_reference_loads_nothing_of_the_program():
    out = _load(_modules("pb_reference"),
                "assert not [m for m in sys.modules if m.split('.')[0] in "
                "('simplepathtracer_tpu_torch', 'simplepathtracer_tpu', 'jax', 'jaxlib')]\n"
                "print('ok')\n")
    assert out.returncode == 0, out.stderr
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math", "typing", "__future__"), \
                    (path.name, n)


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = {"simplepathtracer_tpu_torch.render": object(), "jaxtyping": object(),
            "jax_like": object()}
    for k, v in fake.items():
        monkeypatch.setitem(sys.modules, k, v)
    assert program.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "simplepathtracer_tpu.render", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert program.forbidden_modules() == ["jaxlib", "simplepathtracer_tpu.render"]


def test_run_exits_when_jax_is_loaded(monkeypatch):
    import pytest

    from pb_core import harness

    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit) as e:
        harness.forbidden_or_exit()
    assert e.value.code != 0
    assert Path(harness.__file__).is_file()
