"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package or ``msgpack`` (the card's
machine has none of them), and the smoke script refuses to run without a
card or outside a checkout of the repository.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("PYTHONSTARTUP", None)
    return env


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    prog = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", prog], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _ok_line(stdout):
    return any('"ok": true' in line for line in stdout.splitlines())


def test_chip_smoke_fails_without_a_card():
    """No CUDA here: the script must exit non-zero and print no result."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=_env(), cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and not _ok_line(out.stdout)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and not _ok_line(out.stdout)


SERVING_MODULES = ("repro_torch.core.overlap", "repro_torch.launch.serve",
                   "repro_torch.launch.mesh", "repro_torch.common.sharding",
                   "repro_torch.obs.metrics", "repro_torch.obs.trace",
                   "repro_torch.obs.telemetry",
                   "repro_torch.resilience.recovery",
                   "repro_torch.resilience.faults",
                   "repro_torch.resilience.degrade",
                   "repro_torch.checkpoint.io",
                   "repro_torch.checkpoint.msgpack_lite",
                   "repro_torch.core.patch_parallel",
                   "repro_torch.core.placement")
# pure-Python modules of the JAX package the port keeps a copy of
COPIES = ("obs/metrics.py", "obs/trace.py", "resilience/recovery.py",
          "core/placement.py")


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_are_among_those_checked(module):
    path = REPO / "src" / (module.replace(".", "/") + ".py")
    assert path in _sources()
    assert not _imported_roots(path) & set(FORBIDDEN)


def _code_without_docstrings(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)
                and isinstance(node.body[0].value.value, str)):
            node.body = node.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_keep_the_reference_code(rel):
    """The copies differ from the JAX package's modules in their
    docstrings only."""
    assert _code_without_docstrings(PORT / rel) == \
        _code_without_docstrings(REPO / "src" / "repro" / rel)
