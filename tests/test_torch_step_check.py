"""The machinery of ``chip_smoke.py``'s bf16 one-step check against the
kernels' plain versions (``vs_plain``), on the CPU at a tiny size: the
flagship's RMSNorm encoder (the fused block tail) and QNN head, two
layers, bf16, the kernel dropouts on (p = 0.1) and every other dropout
off, as the check runs it.  The card's side is the plain versions here
too (a CPU tensor takes them), so what is held is the check itself:

* every ReLU pinned to the signs its own forward takes gives the same
  step, bit for bit, as ReLU (``pinned_relus``);
* the pinned step against itself is 0 on every held metric;
* the perturbation witness (one RMS encoder kernel's bf16 outputs moved
  by one ulp on a seeded share of their elements) moves the step, and the
  tail forward's witness lies inside the bands it derives; with all four
  kernels nudged at once too (the K = 148 phase's bands) that step joins
  the four it derives the bands from;
* each of the three wrong plain versions of the negative controls lands
  out of at least one of those bands.

At this size a kernel's outputs hold a few thousand elements, so the
witness moves 1% of them (the card's check: 0.05% of millions).  One
test item (see ``_torch_helpers``).
"""

import importlib.util
import pathlib

import numpy as np

from _torch_helpers import Checks, dims_for, make_batch, tiny_cfg_dict, torch_threads

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARE = 1e-2


def check_cfg_dict():
    return tiny_cfg_dict(amp="bf16", **{
        "sequence": {"tfm": {"n_layers": 2, "mha_dropout": 0.1, "ffn_dropout": 0.1}},
        "model": {"dare_dropout": 0.0, "embedding_dropout": 0.0, "dropout_impl": "hash",
                  "table_dtype": "float32", "qnn_alpha": {"dropout": 0.0}},
        "train": {"batch_size": 48, "epochs": 2, "warmup_epochs": 1, "lr": 1e-2,
                  "embedding_optimizer": "rowwise_adagrad", "exact_dedup": True},
    })


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_step_check_machinery():
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train.trainer import build_model

    cs = load_chip_smoke()
    d = check_cfg_dict()
    cfg = Config.from_dict(d)
    cpu = torch.device("cpu")
    batch = make_batch(d, B=48, seed=3)
    batch["y"] = (np.arange(48) % 4 == 0).astype(np.float32)
    checks = Checks()
    with torch_threads(1):
        model = init_params(build_model(cfg, dims_for(d), cpu), seed=77)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        sel = cs.selected_ids(model, cs.to_device(batch, cpu))
        rows = (sel != cfg.sequence.pad_id).any(dim=1).numpy()
        batch = {k: v[rows] for k, v in batch.items()}
        ids = torch.unique(sel[torch.from_numpy(rows)])
        ids = ids[ids != cfg.sequence.pad_id]
        pin = cs.PinnedPlain(cfg, model, init, batch, cpu, ids)
        bands = cs.CHECK_BANDS["bf16"]["vs_plain"]
        derived, wit = pin.witness(bands, share=SHARE)
        together, wit4 = pin.witness(bands, share=SHARE, together=True)

        def pinned_is_relu():
            assert sum(int(m.numel()) for m in pin.signs) > 0, "no ReLU recorded"
            free = cs._step_record(cfg, model, init, batch, cpu, ids, "plain versions")
            assert free["loss"] == pin.plain["loss"]
            for name, g in free["grads"].items():
                assert torch.equal(g, pin.plain["grads"][name]), name
            for key in ("accum", "rows"):
                assert torch.equal(free[key], pin.plain[key]), key

        def against_itself():
            g = pin.compare(cs.plain_versions_on_card)
            for m in bands:
                assert g[m] == 0.0, (m, g[m])
            assert pin.flips(cs.plain_versions_on_card) == 0

        def witness_moves_and_passes():
            for k, g in wit.items():
                assert g["grads"] > 0.0, f"{k}'s witness does not move the step"
            assert 0.0 < derived["accum"] <= cs.WITNESS_CAP
            assert all(derived[m] == b for m, b in bands.items() if b is not None)
            tail = wit["fused_block_tail"]
            off = [m for m, b in derived.items() if not tail[m] <= b]
            assert not off, f"the tail forward's witness is out of band: {off} {tail}"
            assert cs.K148_BANDS["witness"] == "all" and cs.CHECK_BANDS["bf16"]["witness"] == "each"
            assert wit4["all four"]["grads"] > 0.0, "the four nudged at once do not move the step"
            assert wit4.keys() == {*wit, "all four"}
            for m, b in bands.items():
                want = min(cs.WITNESS_CAP, max(g[m] for g in wit4.values())) if b is None else b
                assert together[m] == want, m

        def wrong_versions_fail():
            controls = pin.negative_controls(derived)
            assert len(controls) == 3
            for label, g, off in controls:
                assert off, f"{label} passes: {g}"

        checks.run("pinned ReLUs give ReLU's step", pinned_is_relu)
        checks.run("the pinned step against itself", against_itself)
        checks.run("the witness moves the step and derives the bands", witness_moves_and_passes)
        checks.run("the wrong plain versions fail", wrong_versions_fail)
    checks.done()
