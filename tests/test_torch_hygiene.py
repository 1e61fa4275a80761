"""Import hygiene and device rules of the PyTorch port, each checked in a
fresh interpreter: importing every module of ``tossctr_tpu_torch`` (the
CLIs' ``__main__`` modules, the fold loop and the FM-cross ops among
them) pulls in neither JAX, flax, msgpack, PyYAML, sklearn, pyarrow,
polars nor the JAX package (the card's machine has none of them); no source of
the port (or ``chip_smoke.py``) imports them; and an entry point called
without ``device`` on a machine without CUDA raises instead of running
on the CPU.  One test item (see ``_torch_helpers``)."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

from _torch_helpers import Checks

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tossctr_tpu_torch"
FORBIDDEN = ("jax", "flax", "msgpack", "yaml", "sklearn", "pyarrow", "polars", "tossctr_tpu")


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=120)


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_import_and_device_hygiene(tmp_path):
    import torch

    def importing_every_module_loads_none_of_them():
        mods = _modules()
        for m in ("ops.fused_attention", "ops.fm_cross", "train.trainer", "train.cv_split",
                  "train.__main__", "infer.__main__"):
            assert f"tossctr_tpu_torch.{m}" in mods, m
        r = _run(f"""
            import importlib, sys
            for m in {mods!r}:
                importlib.import_module(m)
            bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
            print("BAD", bad)
        """)
        assert r.returncode == 0, r.stderr
        assert "BAD []" in r.stdout, r.stdout

    def no_source_imports_the_jax_package():
        for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
            for name in _imported_names(path):
                assert name.split(".")[0] not in ("jax", "flax", "tossctr_tpu"), (path, name)

    def entry_points_without_device_raise():
        r = _run(f"""
            from tossctr_tpu_torch.config import Config
            from tossctr_tpu_torch.infer import infer_main
            from tossctr_tpu_torch.models import build_model
            from tossctr_tpu_torch.train.trainer import train_main
            cfg = Config.from_dict({{"logging": {{"log_dir": {str(tmp_path)!r}}}}})
            dims = {{"X_num": 2, "X_mask": 2, "X_cat": 0, "seq_len": 8}}
            for call in (lambda: infer_main(cfg), lambda: build_model(cfg, dims),
                         lambda: train_main(cfg)):
                try:
                    call()
                except RuntimeError as e:
                    print("RAISED", "CUDA" in str(e))
                else:
                    print("RAN")
        """)
        assert r.returncode == 0, r.stderr
        assert r.stdout.split("\n")[:3] == ["RAISED True"] * 3, r.stdout

    checks = Checks()
    checks.run("importing every module", importing_every_module_loads_none_of_them)
    checks.run("no source imports jax, flax or tossctr_tpu", no_source_imports_the_jax_package)
    if not torch.cuda.is_available():  # the rule is about machines without CUDA
        checks.run("entry points without device raise", entry_points_without_device_raise)
    checks.done()
