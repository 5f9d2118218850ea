"""The port's estimator modes "faithful" and "ls6" against the JAX package.

The reference's own gates (tests/test_estimator.py) run on the port, and
the same inputs go through both packages step by step.  Float64 on both
sides: the band filters are one banded matrix product each (the sums may
run in another order), the FFT is pocketfft against XLA's, so values agree
to ~1e-12 and the tolerances below are 1e-9.  The FFT-peak frequency is an
argmax over |rfft|: the two libraries round the bins differently, so where
the two largest non-DC bins lie within PEAK_MARGIN of each other (a
near-tie) the packages may pick different bins; everywhere else the
frequency must be bit-equal, and the tests check that the margin holds on
their inputs.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.config import EstimatorConfig as JEstimatorConfig
from quad_periodic_mpc_tpu.ops import estimator as j_est
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.config import EstimatorConfig
from quad_periodic_mpc_tpu_torch.ops import estimator as t_est

DT = 0.026
TOL = 1e-9
PEAK_MARGIN = 1e-6
F64 = torch.float64

j_update = jax.jit(j_est.update, static_argnums=(3,))


def _jcfg(cfg: EstimatorConfig) -> JEstimatorConfig:
    return JEstimatorConfig(**cfg.__dict__)


def _peak_margin(y: np.ndarray) -> float:
    """Relative gap between the two largest non-DC |rfft| bins."""
    mag = np.sort(np.abs(np.fft.rfft(y))[1:])
    return float((mag[-1] - mag[-2]) / mag[-1])


def _state_close(ts, js, tol=TOL):
    for f in ts._fields:
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=tol, rtol=0,
            err_msg=f)


def _literal_gaussian_filter(data, sigma):
    """gaussian_filter (SolverMPC.cpp:404-437) transliterated, float64."""
    radius = int(np.ceil(3 * sigma))
    i = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * i * i / (sigma * sigma))
    k /= k.sum()
    idx = np.clip(np.arange(data.shape[-1])[:, None] + i[None, :], 0, data.shape[-1] - 1)
    return (data[..., idx] * k).sum(-1)


@pytest.mark.parametrize("sigma", [7.0, 27.0])
def test_band_filter_float32_matches_reference(sigma):
    """The faithful arm's two blurs (sigma_fast 7, sigma_slow 27: radius 81)
    in float32 over a window of 400, batched: within 1e-5 of the largest
    |x| of the literal float64 filter (sums of up to 163 positive weights
    in float32; TF32's 10-bit mantissa would miss by ~1e-3), and of JAX's
    float32 filter."""
    rng = np.random.default_rng(int(sigma))
    x = (rng.normal(size=(8, 400)) + 5 * np.sin(np.arange(400) * 0.05)).astype(np.float32)
    got = t_est.gaussian_filter(torch.from_numpy(x), sigma).numpy()
    tol = 1e-5 * np.abs(x).max()
    np.testing.assert_allclose(got, _literal_gaussian_filter(x.astype(np.float64), sigma),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(got, np.asarray(j_est.gaussian_filter(jnp.asarray(x), sigma)),
                               atol=tol, rtol=0)


def test_fit_sin_recovers_bin_aligned_sinusoid():
    n = 400
    t = np.arange(n) * DT
    f_true = 4 / (n * DT)
    y = 0.7 + 1.3 * np.sin(2 * np.pi * f_true * t)
    fit = t_est.fit_sin(torch.from_numpy(t), torch.from_numpy(y))
    assert abs(float(fit.freq) - f_true) < 1e-9
    assert abs(float(fit.amp) - 1.3) < 0.01
    assert abs(float(fit.offset) - 0.7) < 1e-6
    assert float(fit.phase) == 0.0
    ref = j_est.fit_sin(jnp.asarray(t), jnp.asarray(y))
    assert float(fit.freq) == float(ref.freq)
    for f in ("amp", "offset", "phase"):
        assert abs(float(getattr(fit, f)) - float(getattr(ref, f))) < TOL


def test_fit_sin_batched_matches_jax():
    """A batch of off-bin sinusoids with noise: the same bins and fits as
    JAX's, every input clear of a near-tie."""
    rng = np.random.default_rng(3)
    t = np.arange(400) * DT
    f = rng.uniform(0.1, 2.0, (16, 1))
    y = rng.normal(0, 0.3, (16, 1)) + rng.uniform(0.5, 2, (16, 1)) * np.sin(
        2 * np.pi * f * t) + 0.05 * rng.normal(size=(16, 400))
    assert min(_peak_margin(r) for r in y) > PEAK_MARGIN
    fit = t_est.fit_sin(torch.from_numpy(np.broadcast_to(t, y.shape).copy()),
                        torch.from_numpy(y))
    ref = j_est.fit_sin(jnp.asarray(np.broadcast_to(t, y.shape)), jnp.asarray(y))
    np.testing.assert_array_equal(fit.freq.numpy(), np.asarray(ref.freq))
    np.testing.assert_allclose(fit.amp.numpy(), np.asarray(ref.amp), atol=TOL, rtol=0)
    np.testing.assert_allclose(fit.offset.numpy(), np.asarray(ref.offset), atol=TOL, rtol=0)


def test_update_lifecycle():
    """faithful/reference, 520 + 40 steps in float64, step by step against
    JAX: no adaptation before the window fills, the fit freezes after
    freeze_after, the QP wrench only released after the freeze
    (SolverMPC.cpp:704-814)."""
    cfg = EstimatorConfig(mode="faithful", residual="reference")
    ts = t_est.init((), window=cfg.window, dtype=F64, device="cpu")
    js = j_est.init((), window=cfg.window, dtype=jnp.float64)
    f_true, amp_true, stat_true = 0.33, 1.25, -0.83
    fq = []
    margins = []
    for k in range(560):
        if k < 520:
            resid = stat_true + amp_true * np.sin(2 * np.pi * f_true * k * DT)
        else:
            resid = np.sin(20.0 * k)
        f_ext = np.zeros(6)
        f_ext[3] = resid
        ts, t_qp = t_est.update(ts, torch.tensor(k * DT, dtype=F64),
                                torch.from_numpy(f_ext), cfg)
        js, j_qp = j_update(js, jnp.asarray(k * DT, jnp.float64), jnp.asarray(f_ext),
                            _jcfg(cfg))
        if cfg.window <= k + 1 <= cfg.freeze_after:
            band = (np.asarray(j_est.gaussian_filter(js.diffs, cfg.sigma_fast))
                    - np.asarray(j_est.gaussian_filter(js.diffs, cfg.sigma_slow)))
            margins.append(_peak_margin(band))
        np.testing.assert_allclose(t_qp.numpy(), np.asarray(j_qp), atol=TOL, rtol=0,
                                   err_msg=f"step {k}")
        _state_close(ts, js)
        fq.append(t_qp.numpy())
        if k == 519:
            frozen = (float(ts.est_amp), float(ts.est_freq))
    assert min(margins) > PEAK_MARGIN
    fq = np.stack(fq)
    assert np.all(fq[:500] == 0.0)
    assert np.any(fq[500:, 3] != 0.0)
    assert abs(float(ts.est_freq) - f_true) < 1.2 / (cfg.window * DT)
    assert 0.4 * amp_true < float(ts.est_amp) < 1.6 * amp_true
    assert (float(ts.est_amp), float(ts.est_freq)) == frozen


def test_faithful_compensation_formula():
    """comp = amp + sin(.) (SolverMPC.cpp:766, sic)."""
    cfg = EstimatorConfig(mode="faithful")
    s = t_est.init((), window=cfg.window, dtype=F64, device="cpu")
    s = s._replace(count=torch.tensor(510, dtype=torch.int32),
                   est_amp=torch.tensor(1.5, dtype=F64), est_freq=torch.tensor(0.33, dtype=F64),
                   est_phase=torch.tensor(0.0, dtype=F64), est_stat=torch.tensor(-0.8, dtype=F64))
    _, f_qp = t_est.update(s, torch.tensor(100.0, dtype=F64), torch.zeros(6, dtype=F64), cfg)
    assert abs(float(f_qp[3]) - (1.5 + np.sin(2 * np.pi * 100.0 * 0.33))) < 1e-9
    js = j_est.init((), window=cfg.window, dtype=jnp.float64)._replace(
        count=jnp.asarray(510, jnp.int32), est_amp=jnp.asarray(1.5, jnp.float64),
        est_freq=jnp.asarray(0.33, jnp.float64), est_stat=jnp.asarray(-0.8, jnp.float64))
    _, j_qp = j_update(js, jnp.asarray(100.0, jnp.float64), jnp.zeros(6, jnp.float64),
                       _jcfg(cfg))
    np.testing.assert_allclose(f_qp.numpy(), np.asarray(j_qp), atol=TOL, rtol=0)


def test_freeze_after_1e9_releases_without_overflow():
    """The baseline arm's freeze_after = 10**9 against the int32 count: the
    fit stays active and nothing is released below it, the release comes
    just past it."""
    cfg = EstimatorConfig(mode="faithful", residual="reference", freeze_after=10 ** 9)
    rng = np.random.default_rng(5)
    base = t_est.init((2,), window=cfg.window, dtype=F64, device="cpu")
    base = base._replace(times=torch.from_numpy(np.arange(400) * DT + np.zeros((2, 1))),
                         diffs=torch.from_numpy(rng.normal(size=(2, 400))),
                         est_freq=torch.full((2,), 0.33, dtype=F64))
    for count, released in ((10 ** 9 - 1, False), (10 ** 9, True)):
        s = base._replace(count=torch.full((2,), count, dtype=torch.int32))
        s2, f_qp = t_est.update(s, torch.full((2,), 11.0, dtype=F64),
                                torch.ones(2, 6, dtype=F64), cfg)
        assert bool((f_qp[:, 3] != 0).all()) == released
        assert bool((s2.est_amp != 0).all()) != released   # active through 10**9


def _ls6_signal(k):
    true = {1: (0.4, 0.8, 0.5), 3: (-0.83, 1.25, 0.33), 4: (0.2, 0.6, 0.6)}
    f_ext = np.zeros(6)
    for c, (s, a, f) in true.items():
        f_ext[c] = s + a * np.sin(2 * np.pi * f * k * DT)
    return true, f_ext


def test_ls6_full_wrench_fit():
    """ls6: independent per-component fits on the 6-wrench, 520 steps in
    float64, the reference's gates on the port and every step against JAX;
    the converted JAX state carries every est6_* field."""
    cfg = EstimatorConfig(mode="ls6")
    ts = t_est.init((), window=cfg.window, dtype=F64, device="cpu")
    js = j_est.init((), window=cfg.window, dtype=jnp.float64)
    for k in range(520):
        true, f_ext = _ls6_signal(k)
        ts, t_qp = t_est.update(ts, torch.tensor(k * DT, dtype=F64),
                                torch.from_numpy(f_ext), cfg)
        js, j_qp = j_update(js, jnp.asarray(k * DT, jnp.float64), jnp.asarray(f_ext),
                            _jcfg(cfg))
        np.testing.assert_allclose(t_qp.numpy(), np.asarray(j_qp), atol=TOL, rtol=0,
                                   err_msg=f"step {k}")
    _state_close(ts, js)
    for c, (s, a, f) in true.items():
        assert abs(float(ts.est6_freq[c]) - f) < 0.02, c
        assert abs(float(ts.est6_stat[c]) - s) < 0.1, c
        amp_hat = float(torch.sqrt(ts.est6_sin[c] ** 2 + ts.est6_cos[c] ** 2))
        assert abs(amp_hat - a) < 0.2 * a + 0.05, c
        assert abs(float(t_qp[c]) - (s + a * np.sin(2 * np.pi * f * 519 * DT))) < 0.25, c
    assert abs(float(ts.est6_stat[0])) < 0.05
    # component 3 mirrored into the scalar fields
    assert float(ts.est_freq) == float(ts.est6_freq[3])
    assert float(ts.est_stat) == float(ts.est6_stat[3])
    conv = convert.estimator_state(js, device="cpu")
    for f in ("est6_freq", "est6_stat", "est6_sin", "est6_cos", "wrench_hist", "f_est_static"):
        np.testing.assert_array_equal(getattr(conv, f).numpy(), np.asarray(getattr(js, f)))
        assert bool(getattr(conv, f).abs().max() > 0), f


@pytest.mark.parametrize("mode", ["faithful", "ls6", "ls"])
def test_predict_horizon_matches_jax(mode):
    """Per-step wrench over the horizon from a fitted batched state, before
    and after each mode's release."""
    rng = np.random.default_rng({"faithful": 1, "ls6": 2, "ls": 3}[mode])
    cfg = EstimatorConfig(mode=mode, window=32, ls_release=32, freeze_after=40)
    js = j_est.init((3,), window=32, dtype=jnp.float64)
    fields = {f: rng.normal(size=np.shape(getattr(js, f))) for f in (
        "est_amp", "est_phase", "est_stat", "est_sin", "est_cos",
        "est6_stat", "est6_sin", "est6_cos")}
    fields["est_freq"] = rng.uniform(0.1, 1.0, 3)
    fields["est6_freq"] = rng.uniform(0.1, 1.0, (3, 6))
    js = js._replace(**{f: jnp.asarray(v) for f, v in fields.items()})
    t = rng.uniform(5.0, 20.0, 3)
    for count in (31, 41):
        js = js._replace(count=jnp.asarray([count, 20, 45], jnp.int32))
        ref = j_est.predict_horizon(js, jnp.asarray(t), DT, 10, _jcfg(cfg))
        out = t_est.predict_horizon(convert.estimator_state(js, "cpu"),
                                    torch.from_numpy(t), DT, 10, cfg)
        assert out.shape == (3, 10, 6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    assert bool(out.abs().sum() > 0)


@pytest.mark.parametrize("mode", ["faithful", "ls6", "ls", "static"])
def test_ema_overrides_match_jax(mode):
    """The tunable EMAs (tensors) in place of the config's, one update from
    a filled window at the fit's first step, against JAX given the same."""
    rng = np.random.default_rng(7)
    cfg = EstimatorConfig(mode=mode, window=64, ls_release=64, freeze_after=64)
    js = j_est.init((4,), window=64, dtype=jnp.float64)
    times = 3.0 + DT * np.arange(64) + np.zeros((4, 1))
    js = js._replace(
        times=jnp.asarray(times), count=jnp.full((4,), 63, jnp.int32),
        diffs=jnp.asarray(np.sin(2 * np.pi * 0.4 * times) + 0.1 * rng.normal(size=(4, 64))),
        wrench_hist=jnp.asarray(rng.normal(size=(4, 64, 6))),
        f_est_smoothed=jnp.asarray(rng.normal(size=(4, 6))),
        f_est_static=jnp.asarray(rng.normal(size=(4, 6))))
    f_ext = rng.normal(size=(4, 6))
    t = times[:, -1] + DT
    ema_smooth, ema_static = 0.8, 0.6
    ts2, t_qp = t_est.update(convert.estimator_state(js, "cpu"), torch.from_numpy(t),
                             torch.from_numpy(f_ext), cfg,
                             ema_smooth=torch.tensor(ema_smooth, dtype=F64),
                             ema_static=torch.tensor(ema_static, dtype=F64))
    js2, j_qp = j_est.update(js, jnp.asarray(t), jnp.asarray(f_ext), _jcfg(cfg),
                             ema_smooth=jnp.asarray(ema_smooth), ema_static=jnp.asarray(ema_static))
    _state_close(ts2, js2)
    np.testing.assert_allclose(t_qp.numpy(), np.asarray(j_qp), atol=TOL, rtol=0)
    # the overrides took effect: the config's EMAs give another state
    ts3, _ = t_est.update(convert.estimator_state(js, "cpu"), torch.from_numpy(t),
                          torch.from_numpy(f_ext), cfg)
    assert not torch.allclose(ts3.f_est_static, ts2.f_est_static)


def test_unknown_mode_raises():
    s = t_est.init((), window=8, dtype=F64, device="cpu")
    with pytest.raises(ValueError):
        t_est.update(s, torch.tensor(0.0, dtype=F64), torch.zeros(6, dtype=F64),
                     EstimatorConfig(mode="nope"))
