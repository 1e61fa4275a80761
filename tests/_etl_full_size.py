"""Full-size host run of the Parquet ETL: the JAX package's and the port's
caches from one synthetic Parquet pair, compared byte for byte, with
each step's wall time and peak RSS.  Not a test (pytest does not collect
it); it needs pyarrow, pandas and PyYAML, and about 13 GB of disk and
10 GB of memory at the default size.

    python tests/_etl_full_size.py --out DIR [--rows 2500000] [--test-rows 500000]

1. ``python -m tossctr_tpu_torch.tools.make_synth_data`` writes
   ``DIR/data/{train,test}.parquet``.
2. Without covis, then with ``features.covis.out_dir`` set: each package
   builds its covis features (``tools.build_covis_features``' call) and
   its train and test caches (``build_train_and_test``) at the data
   settings of ``cfgs/dare_qnn_next_tpu.yaml`` (its ``cat_cols``,
   ``hash_buckets``, ``default_hash_bucket``, ``num_patterns``, ``cv``
   groups, ``shard_rows`` 2,000,000, ``max_len`` 400) with
   ``stream_batch_rows`` 200,000.  Every step runs in an interpreter of
   its own, started by this small parent process (which imports nothing but the
   standard library and PyYAML): a child's ``ru_maxrss`` starts at the
   RSS its parent had when it forked, so it is the step's own within the
   parent's few tens of MB; ``VmHWM``, the child's own high-water mark
   since its exec, and its RSS after its imports are printed beside it.
3. The two caches must be byte-equal: every ``.npy`` of every shard, and
   ``manifest.json`` but its paths.  Each pair of caches is deleted once
   compared.

Prints one JSON line per step, then a summary line with the CPU model
(``/proc/cpuinfo``); exits 1 if any cache differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("tossctr_tpu", "tossctr_tpu_torch")
FLAGSHIP = os.path.join(ROOT, "cfgs", "dare_qnn_next_tpu.yaml")

CHILD = r"""
import importlib, json, resource, sys, time

def status(key):
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 1024.0

pkg, step, cfg_path = sys.argv[1:4]
import pandas, pyarrow.dataset  # loaded before the clock starts, in both packages
load_config = importlib.import_module(pkg + ".config").load_config
if step == "etl":
    run = importlib.import_module(pkg + ".data.etl").build_train_and_test
else:
    covis = importlib.import_module(pkg + ".features.covis")
rss_imports = status("VmRSS")
cfg = load_config(cfg_path)
t0 = time.perf_counter()
if step == "etl":
    out = run(cfg)
else:
    out = covis.build_covis_features(cfg.data.train_path, cfg.data.test_path,
                                     covis.CovisConfig.from_cfg(cfg))
wall = time.perf_counter() - t0
print(json.dumps({"package": pkg, "step": step, "wall_s": wall,
                  "ru_maxrss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
                  "vmhwm_mb": status("VmHWM"), "rss_after_imports_mb": rss_imports,
                  "out": out}))
"""


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def run_child(pkg, step, cfg_path, mode):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", CHILD, pkg, step, cfg_path], cwd=ROOT, env=env,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{pkg} {step} failed:\n{r.stderr[-4000:]}")
    rec = dict(json.loads(r.stdout.strip().splitlines()[-1]), mode=mode)
    print(json.dumps(rec), flush=True)
    return rec


def digest(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def cache_digest(man_path):
    """({shard file: sha256}, the manifest without its paths)."""
    with open(man_path) as f:
        man = json.load(f)
    files = {}
    for sh in man["shards"]:
        for k, v in sh.items():
            if isinstance(v, dict) and "path" in v:
                files[f"shard_{sh['index']:03d}/{k}.npy"] = digest(v.pop("path"))
    man.pop("parquet")
    return files, man


def main(argv=None) -> int:
    import yaml

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--rows", type=int, default=2_500_000)
    ap.add_argument("--test-rows", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    data = os.path.join(out, "data")

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "tossctr_tpu_torch.tools.make_synth_data", "--out", data,
                    "--rows", str(args.rows), "--test-rows", str(args.test_rows), "--seed",
                    str(args.seed)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), check=True)
    print(json.dumps({"step": "make_synth_data", "wall_s": time.perf_counter() - t0,
                      "rows": args.rows, "test_rows": args.test_rows}), flush=True)

    with open(FLAGSHIP) as f:
        base = yaml.safe_load(f)
    ok = True
    for covis in (False, True):
        mode = "covis" if covis else "plain"
        mans = {}
        for pkg in PACKAGES:
            d = json.loads(json.dumps(base))
            d["data"].update(train_path=os.path.join(data, "train.parquet"),
                             test_path=os.path.join(data, "test.parquet"),
                             cache_dir=os.path.join(out, f"cache_{pkg}_{mode}"),
                             stream_batch_rows=200_000)
            d["logging"] = {"log_dir": os.path.join(out, "runs")}
            if covis:
                d["features"] = {"covis": {"out_dir": os.path.join(out, f"covis_{pkg}")}}
            cfg_path = os.path.join(out, f"cfg_{pkg}_{mode}.yaml")
            with open(cfg_path, "w") as f:
                json.dump(d, f)
            if covis:
                run_child(pkg, "covis", cfg_path, mode)
            mans[pkg] = run_child(pkg, "etl", cfg_path, mode)["out"]
        for i, split in enumerate(("train", "test")):
            a, b = (cache_digest(mans[pkg][i]) for pkg in PACKAGES)
            same = a == b
            ok &= same
            print(json.dumps({"mode": mode, "split": split, "byte_equal": same,
                              "files": len(a[0]), "rows": a[1]["rows"],
                              "shards": [s["rows"] for s in a[1]["shards"]]}), flush=True)
        for pkg in PACKAGES:
            shutil.rmtree(os.path.join(out, f"cache_{pkg}_{mode}"))
    print(json.dumps({"cpu": cpu_model(), "nproc": os.cpu_count(), "byte_equal": ok,
                      "rows": args.rows, "test_rows": args.test_rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
