"""Import hygiene and device rules of the PyTorch port, each checked in a
fresh interpreter: importing every module of ``tossctr_tpu_torch`` (the
CLIs' ``__main__`` modules, the fold loop and the FM-cross ops among
them) pulls in neither JAX, flax, msgpack, PyYAML, sklearn, pyarrow,
pandas, polars nor the JAX package (the card's machine has none of them);
no source of
the port (or ``chip_smoke.py``) imports them, and none of its sources (the
native gather's C++ among them) names a path into the JAX package's
``native/``, whose library the port never loads; no shared library lies
in the package's tree (the native gather builds into ``build/native/``);
and an entry point called without ``device`` on a machine without CUDA
raises instead of running on the CPU (the training CLI's
``--build-cache`` before its ETL starts).  One test item (see
``_torch_helpers``)."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

from _torch_helpers import Checks

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tossctr_tpu_torch"
FORBIDDEN = ("jax", "flax", "msgpack", "yaml", "sklearn", "pyarrow", "pandas", "polars",
             "tossctr_tpu")


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

    mods = _modules()
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(json.dumps({"logging": {"log_dir": str(tmp_path)},
                                    "data": {"cache_dir": str(tmp_path / "cache"),
                                             "train_path": str(tmp_path / "no.parquet")}}))
    # one fresh interpreter: every module imported first, then (on a machine
    # without CUDA) each entry point called without a device; the training
    # CLI's ETL is replaced by a recorder, which must not be called
    r = _run(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        print("BAD", bad)
        import torch
        if not torch.cuda.is_available():
            from tossctr_tpu_torch.config import Config
            from tossctr_tpu_torch.data import etl
            from tossctr_tpu_torch.infer import infer_main
            from tossctr_tpu_torch.models import build_model
            from tossctr_tpu_torch.tools.run_calibration import main as run_calibration
            from tossctr_tpu_torch.train.__main__ import main as train_cli
            from tossctr_tpu_torch.train.trainer import train_main
            etl_calls = []
            etl.build_train_and_test = lambda cfg: etl_calls.append(cfg)
            cfg = Config.from_dict({{"logging": {{"log_dir": {str(tmp_path)!r}}}}})
            path = {str(cfg_json)!r}
            dims = {{"X_num": 2, "X_mask": 2, "X_cat": 0, "seq_len": 8}}
            for call in (lambda: infer_main(cfg), lambda: build_model(cfg, dims),
                         lambda: train_main(cfg), lambda: run_calibration(["--cfg", path]),
                         lambda: train_cli(["--cfg", path, "--build-cache"])):
                try:
                    call()
                except RuntimeError as e:
                    print("RAISED", "CUDA" in str(e))
                else:
                    print("RAN")
            # the CLI raised before its ETL started
            print("ETL CALLS", len(etl_calls))
    """)
    out = r.stdout.split("\n")

    def importing_every_module_loads_none_of_them():
        for m in ("ops.fused_attention", "ops.fused_ffn", "ops.fm_cross", "train.trainer",
                  "train.cv_split", "train.sharded_ckpt", "eval.isotonic", "native.build",
                  "tools.run_calibration", "train.__main__", "infer.__main__", "data.etl",
                  "data.synth", "features.covis", "utils.hashing", "utils.trace",
                  "tools.build_covis_features", "tools.blend_submissions",
                  "tools.check_hash_collisions", "tools.guess_numeric_types",
                  "tools.make_synth_data"):
            assert f"tossctr_tpu_torch.{m}" in mods, m
        assert r.returncode == 0, r.stderr
        assert out[0] == "BAD []", r.stdout

    def no_source_imports_the_jax_package():
        for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
            for name in _imported_names(path):
                assert name.split(".")[0] not in ("jax", "flax", "tossctr_tpu"), (path, name)

    def no_path_into_the_jax_native_library():
        # string constants of the code (docstrings may cite the JAX files)
        for path in PKG.rglob("*.py"):
            tree = ast.parse(path.read_text(), filename=str(path))
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                    and n.body and isinstance(n.body[0], ast.Expr)}
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                        and id(node) not in docs):
                    v = node.value
                    assert v != "tossctr_tpu" and "tossctr_tpu/" not in v \
                        and "tossctr_tpu.native" not in v, (path, v)
        cpp = PKG / "native" / "fastgather.cpp"
        includes = [ln for ln in cpp.read_text().splitlines() if ln.startswith("#include")]
        assert includes and all("<" in ln and ".." not in ln for ln in includes), includes
        assert not list(PKG.rglob("*.so")), list(PKG.rglob("*.so"))

    def entry_points_without_device_raise():
        assert r.returncode == 0, r.stderr
        assert out[1:7] == ["RAISED True"] * 5 + ["ETL CALLS 0"], r.stdout
        assert not (tmp_path / "cache").exists()

    checks = Checks()
    checks.run("importing every module", importing_every_module_loads_none_of_them)
    checks.run("no source imports jax, flax or tossctr_tpu", no_source_imports_the_jax_package)
    checks.run("no path into the JAX package's native library",
               no_path_into_the_jax_native_library)
    if not torch.cuda.is_available():  # the rule is about machines without CUDA
        checks.run("entry points without device raise", entry_points_without_device_raise)
    checks.done()
