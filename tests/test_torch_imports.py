"""Import guard: the port and its chip smoke import neither JAX nor `repro`.

The PyTorch port (`src/repro_torch/`, `tools/`) and `chip_smoke.py` must
run on a machine with no JAX, and must not lean on the reference
package, not even on its JAX-free modules. The AST of every file is
walked, so an import inside a function is caught as well.
"""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
         + [ROOT / "chip_smoke.py"])


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.name}:{line}: {mod}" for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, "forbidden imports:\n" + "\n".join(bad)


def test_guard_catches_forbidden_forms():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("repro") and _forbidden("repro.core.solver")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.core")
    assert not _forbidden("torch") and not _forbidden("numpy")
    source = "import jax.numpy as jnp\nfrom repro.core import solver\nfrom repro_torch import x\n"
    tmp = ast.parse(source)
    mods = [n.names[0].name if isinstance(n, ast.Import) else n.module for n in tmp.body]
    assert [_forbidden(m) for m in mods] == [True, True, False]


def test_guard_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for required in ("src/repro_torch/core/solver.py", "src/repro_torch/kernels/_build.py",
                     "src/repro_torch/kernels/gs_fused/ops.py", "chip_smoke.py",
                     "src/repro_torch/models/model.py", "src/repro_torch/serving/engine.py",
                     "src/repro_torch/kernels/imac_mvm/ops.py",
                     "src/repro_torch/kernels/decode_attention/ops.py",
                     "tools/time_imac_mvm_tiles.py"):
        assert required in names
