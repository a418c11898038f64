"""The port stands alone, defaults to the card, and its smoke script
refuses to run without one.

* No file of `src/repro_torch/`, not `chip_smoke.py` and not the card
  tests (`tests/test_torch_gpu.py`, run where no JAX is installed)
  import `jax` or anything of the reference package `repro` (checked
  on the AST, so lazy imports inside functions count too).
* Every public entry point that places data takes `device` and
  defaults it to "cuda".
* `chip_smoke.py` exits non-zero, printing no result, without a CUDA
  device and in a directory that holds it alone.
"""
import ast
import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
        ROOT / "tools" / "gemm_ab.py", ROOT / "tools" / "attn_ab.py",
        ROOT / "tools" / "requant_ab.py"]
    assert len(files) > 25
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str):
                    yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "flax"}, (path, roots)


def test_public_entry_points_default_to_cuda():
    from repro_torch.core import bn
    from repro_torch.launch import serve, train
    from repro_torch.layers import conv, mlp, rope
    from repro_torch.models import cnn, lm
    from repro_torch.serving import PagedArena, ServingConfig, SlotArena

    assert ServingConfig().device == "cuda"
    for fn in (serve.deploy_model, lm.tables_from_numpy,
               lm.DecoderLM.init_pools, lm.DecoderLM.init_caches,
               rope.rope_tables_int, PagedArena.__init__,
               SlotArena.__init__, cnn.tables_from_numpy,
               cnn.NemoCNN.calibrate, cnn.image_inputs, conv.QConv2d.load,
               bn.integer_bn_to_torch, bn.thresholds_to_torch, train.build,
               lm.DecoderLM.init_qstate, mlp.QMLP.init_qstate):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    src = inspect.getsource(serve.main)
    assert 'add_argument("--device", default="cuda")' in src
    assert 'add_argument("--device", default="cuda",' in inspect.getsource(
        train.main)


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    r = _run_smoke(ROOT)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
