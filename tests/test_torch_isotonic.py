"""The port's isotonic calibration and device metrics against scikit-learn
1.9.0 and the JAX package.

* ``eval/isotonic.py``'s ``IsotonicRegression(y_min=0, y_max=1,
  out_of_bounds="clip")`` against sklearn's: the thresholds
  (``X_thresholds_``, ``y_thresholds_``, the same count) and the
  predictions within 1e-12, on weighted samples (the calibrator's 50:50
  class weights), unweighted ones, tied x, x within sklearn's merge
  resolution (1e-15) of each other, an all-one-class slice, a single
  distinct x, and inputs outside the fitted range; a pickled sklearn
  object loads onto the port's class and predicts the same, and one of
  another form (``out_of_bounds="nan"``, no bounds, decreasing) is
  refused.
* ``Calibrator`` with ``isotonic`` and ``temperature+isotonic`` against
  the JAX package's: the probabilities within 1e-12, ``meta()`` (T and
  the thresholds) within 1e-12, the ``min_iso_nodes`` guard; the port's
  ``calibrator.json`` round-trips bit for bit; a ``calibrator.pkl`` the
  JAX package pickled (sklearn's object inside) loads and predicts the
  same.
* The device AP / WLL (``average_precision_torch``,
  ``weighted_logloss_50_50_torch``, ``final_score_device``) against the
  JAX package's ``final_score_device`` and sklearn's
  ``average_precision_score`` within 1e-6, with tied scores, NaN and
  +-inf among the predictions, and with one class absent; and against the
  port's host metrics within 1e-6 where no prediction is within 1e-7 of
  0 or 1 (the host's WLL floor is 1e-12, which fp32 cannot hold next to
  1).

One test item (see ``_torch_helpers``).
"""

import io
import json
import pickle

import numpy as np

import _torch_helpers as H


def _scores(seed, n, ties=False):
    rng = np.random.default_rng(seed)
    z = rng.normal(-1.0, 2.0, n)
    if ties:
        z = np.round(z, 1)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.int32)
    return z, y


def test_isotonic_and_device_metrics_match(tmp_path):
    from sklearn.isotonic import IsotonicRegression as SkIsotonic
    from sklearn.metrics import average_precision_score

    from tossctr_tpu.eval.calibration import Calibrator as JaxCalibrator
    from tossctr_tpu.eval.metrics import final_score_device as jax_final_score_device
    from tossctr_tpu_torch.eval.calibration import Calibrator
    from tossctr_tpu_torch.eval.isotonic import IsotonicRegression
    from tossctr_tpu_torch.eval.metrics import (
        average_precision_torch,
        final_score,
        final_score_device,
    )
    from tossctr_tpu_torch.train.checkpoint import _CalibratorUnpickler, load_legacy_calibrator

    def close(name, got, want, tol):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        assert err <= tol, f"{name}: {err} > {tol}"

    def pav_matches(x, y, w):
        want = SkIsotonic(y_min=0.0, y_max=1.0, out_of_bounds="clip").fit(x, y, sample_weight=w)
        got = IsotonicRegression(y_min=0.0, y_max=1.0).fit(x, y, sample_weight=w)
        close("X_thresholds_", got.X_thresholds_, want.X_thresholds_, 1e-12)
        close("y_thresholds_", got.y_thresholds_, want.y_thresholds_, 1e-12)
        t = np.r_[x, np.linspace(x.min() - 1, x.max() + 1, 101), -5.0, 7.0]
        close("predict", got.predict(t), want.predict(t), 1e-12)
        # sklearn's pickled state onto the port's class
        loaded = _CalibratorUnpickler(io.BytesIO(pickle.dumps(want))).load()
        assert isinstance(loaded, IsotonicRegression)
        close("predict after unpickling", loaded.predict(t), want.predict(t), 1e-12)

    def pav_cases():
        rng = np.random.default_rng(0)
        for n, ties in ((10, False), (500, False), (2000, True)):
            z, y = _scores(n, n, ties)
            p = 1 / (1 + np.exp(-z))
            sw = np.where(y == 1, 0.5 / max(1, y.sum()), 0.5 / max(1, (y == 0).sum()))
            yield f"weighted n={n} ties={ties}", (p, y, sw)
            yield f"unweighted n={n} ties={ties}", (p, y, None)
            yield f"one class n={n}", (p, np.ones(n, np.int32), None)
        x = np.repeat(np.sort(rng.random(60)), 3) + np.tile([0.0, 4e-16, 9e-16], 60)
        yield "x within the merge resolution", (x, rng.integers(0, 2, 180), rng.random(180))
        yield "one distinct x", (np.full(7, 0.3), rng.integers(0, 2, 7), None)
        yield "zero weights", (rng.random(50), rng.integers(0, 2, 50),
                               np.where(np.arange(50) % 4 == 0, 0.0, 1.0))

    def calibrator_matches(method, n, ties):
        z, y = _scores(n + 7, n, ties)
        got = Calibrator(method).fit(z, y)
        want = JaxCalibrator(method).fit(z, y)
        zz = np.r_[z, -60.0, 60.0, 0.0]
        close("predict_proba", got.predict_proba(zz), want.predict_proba(zz), 1e-12)
        gm, wm = got.meta(), want.meta()
        assert gm.keys() == wm.keys() and gm["method"] == wm["method"]
        for k in set(gm) - {"method"}:
            close(k, gm[k], wm[k], 1e-12)
        assert (got.iso is None) == (want.iso is None)
        back = Calibrator.from_json(json.loads(json.dumps(got.to_json())))
        np.testing.assert_array_equal(back.predict_proba(zz), got.predict_proba(zz))
        assert back.meta() == gm
        path = tmp / f"calibrator_{method.replace('+', '_')}_{n}.pkl"
        path.write_bytes(pickle.dumps(want))
        legacy = load_legacy_calibrator(str(path))
        close("JAX calibrator.pkl", legacy.predict_proba(zz), want.predict_proba(zz), 1e-12)

    def other_forms_refused():
        x, y = np.linspace(0, 1, 20), np.tile([0, 1], 10)
        for kw in (dict(y_min=0.0, y_max=1.0, out_of_bounds="nan"),
                   dict(out_of_bounds="clip"), dict(y_min=0.0, y_max=1.0, increasing=False)):
            blob = pickle.dumps(SkIsotonic(**kw).fit(x, y))
            try:
                _CalibratorUnpickler(io.BytesIO(blob)).load()
            except NotImplementedError:
                continue
            raise AssertionError(f"an isotonic map with {kw} loaded")

    def min_iso_nodes_guard():
        z = np.repeat([-1.0, 0.0, 1.0], 10)
        y = np.tile([0, 1], 15)
        for method in ("isotonic", "temperature+isotonic"):
            assert Calibrator(method).fit(z, y).iso is None
            assert JaxCalibrator(method).fit(z, y).iso is None

    def metrics_case(seed, n, special):
        z, y = _scores(seed, n, ties=True)
        p = 1 / (1 + np.exp(-z))
        if special:
            p[:6] = [np.nan, np.inf, -np.inf, 0.0, 1.0, np.nan]
        if special == "no positives":
            y[:] = 0
        return y, p

    def device_metrics_match(seed, n, special, formula):
        y, p = metrics_case(seed, n, special)
        got = final_score_device(y, p, formula=formula, device="cpu")
        want = jax_final_score_device(y, p, formula=formula)
        close("ap, wll, score", got, want, 1e-6)
        if y.any() and not y.all():
            ps = np.clip(np.nan_to_num(p, nan=0.5, posinf=1.0, neginf=0.0), 0.0, 1.0)
            close("ap against sklearn", float(average_precision_torch(y, p, device="cpu")),
                  average_precision_score(y, ps), 1e-6)
        if special is None:  # the host's WLL floor is 1e-12, the device's 1e-7
            close("against the host", got, final_score(y, p, formula=formula), 1e-6)

    tmp = tmp_path
    checks = H.Checks()
    with H.torch_threads():
        for name, args in pav_cases():
            checks.run(f"PAV: {name}", pav_matches, *args)
        for method in ("isotonic", "temperature+isotonic"):
            for n, ties in ((40, False), (3000, True)):
                checks.run(f"Calibrator {method} n={n}", calibrator_matches, method, n, ties)
        checks.run("isotonic maps of another form refused", other_forms_refused)
        checks.run("min_iso_nodes", min_iso_nodes_guard)
        for seed, n, special, formula in ((1, 1000, None, "competition"),
                                          (2, 4096, "non-finite", "reference"),
                                          (3, 300, "no positives", "reference")):
            checks.run(f"device AP/WLL n={n} {special} {formula}", device_metrics_match, seed,
                       n, special, formula)
    checks.done()
