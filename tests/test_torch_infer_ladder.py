"""Statistical counterparts of tests/test_infer.py's ladder tests on the
port's ``infer``, on the CPU in float64: the spline coupling template, the
escalation on the asymmetric bimodal target and the ladder's mechanism on
the hard-collapse target, with the reference's targets, sizes and
tolerances. Each gate was run on generator seeds 0-4 (``seed``) and kept
only where all five passed (CHANGES.md lists them); the tests run the
first of them, STAT_SEED. The deterministic parts of the ladder are held
to JAX in tests/test_torch_infer.py.

The mechanism test keeps the gates that held on all five seeds. Two of the
reference's do not hold on every seed in either package (ROADMAP C-10):
that the ladder ends on the SMC rescue, and the unweighted share of the
final SMC particles right of 0; nor does the same bound on the rescue's
weighted particles.
"""
import importlib
import math

import numpy as np
import torch

import enflows_tpu_torch as et

TI = importlib.import_module("enflows_tpu_torch.infer")

torch.set_num_threads(1)

T64 = torch.float64
_LOG_2PI = 1.8378770664093453
STAT_SEED = 0


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _logaddexp_mix(x0, w1, m1, s1, w2, m2, s2):
    return torch.logaddexp(
        math.log(w1) - 0.5 * ((x0 - m1) / s1) ** 2 - math.log(s1),
        math.log(w2) - 0.5 * ((x0 - m2) / s2) ** 2 - math.log(s2)) \
        - 0.5 * _LOG_2PI


def _bimodal(z):
    """tests/test_infer.py::_bimodal_logp, batched."""
    x0, x1 = z[..., 0], z[..., 1]
    return _logaddexp_mix(x0, 0.75, -2.0, 0.4, 0.25, 1.5, 0.7) \
        - 0.5 * ((x1 - 0.5 * x0) / 0.8) ** 2 - 0.5 * _LOG_2PI \
        - math.log(0.8)


def _hard_bimodal(z):
    """tests/test_infer.py::_hard_bimodal_logp, batched."""
    x0, x1 = z[..., 0], z[..., 1]
    return _logaddexp_mix(x0, 0.70, -3.0, 0.3, 0.30, 2.5, 0.5) \
        - 0.5 * ((x1 - 0.5 * x0) / 0.8) ** 2 - 0.5 * _LOG_2PI \
        - math.log(0.8)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def spline_coupling_template(seed):
    """test_infer.py:155: a symmetric bimodal marginal through the spline
    coupling template."""
    def logp(q):
        m = torch.logaddexp(-0.5 * ((q[:, 0] - 2.0) / 0.6) ** 2,
                            -0.5 * ((q[:, 0] + 2.0) / 0.6) ** 2)
        return m - 0.5 * ((q[:, 1] - 0.3 * q[:, 0]) / 0.7) ** 2

    res = et.infer(logp, dim=2, key=_gen(seed), precondition="auto",
                   flow_template=et.coupling_flow_template(
                       3, (24, 24), kind="spline", n_bins=6),
                   vi_steps=500, vi_batch=512, num_chains=8,
                   num_warmup=300, num_samples=400, dtype=T64)
    assert res.flow is not None
    d = res.diagnostics
    assert np.all(d["rhat"] < 1.05)
    np.testing.assert_allclose(d["mean"][0], 0.0, atol=0.3)
    np.testing.assert_allclose(d["sd"][0], 2.09, rtol=0.2)
    return {"mean0": d["mean"][0], "sd0": d["sd"][0],
            "max_rhat": d["rhat"].max()}


def multimodal_escalation(seed):
    """test_infer.py:303: plain infer on the asymmetric bimodal target must
    cover both modes."""
    res = et.infer(_bimodal, dim=2, key=_gen(seed), vi_steps=200,
                   vi_batch=256, whiten_batches=16, whiten_epochs=8,
                   num_chains=8, num_warmup=200, num_samples=400, dtype=T64)
    d = res.diagnostics
    assert "precondition_khat" in d and "precondition_family" in d
    x = _np(res.draws).reshape(-1, 2)
    frac_right = float((x[:, 0] > 0).mean())
    assert 0.12 < frac_right < 0.40, (frac_right, d["precondition_family"])
    assert abs(x[:, 0].mean() + 1.125) < 0.35
    return {"frac_right": frac_right, "mean0": x[:, 0].mean(),
            "family": d["precondition_family"]}


def escalation_ladder_mechanism(seed, monkeypatch):
    """test_infer.py:353: on the hard-collapse target with a starved VI
    budget both reverse-KL rungs fail their diagnostics, so the ladder
    walks past them to the SMC rescue. The final sampler is stubbed: where
    the rescue loses (seed 0), NUTS through the failed transport takes over
    20 minutes on one core. The rescue's weighted mass right of 0 is
    returned, not gated: the 4096-particle ladder put 0.574 there on seed
    2 (ROADMAP C-10)."""
    severities, rescue_smc = {}, []

    def fit_quality(*a):
        out = real_quality(*a)
        severities[a[4]] = out
        return out

    def smc_sample(target, gen, **kw):
        out = real_smc(target, gen, **kw)
        if kw["num_particles"] == 4096 and not rescue_smc:
            rescue_smc.append(out)
        return out

    def sample(target, gen, *, num_chains, num_samples, dim, **kw):
        return torch.zeros(num_chains, num_samples, dim, dtype=T64), None, \
            None

    real_quality, real_smc = TI._fit_quality, TI.smc_sample
    monkeypatch.setattr(TI, "_fit_quality", fit_quality)
    monkeypatch.setattr(TI, "smc_sample", smc_sample)
    monkeypatch.setattr(TI, "sample", sample)
    res = et.infer(_hard_bimodal, dim=2, key=_gen(seed), vi_steps=5,
                   vi_batch=128, whiten_batches=16, whiten_epochs=8,
                   num_chains=8, num_warmup=150, num_samples=300, dtype=T64)
    d = res.diagnostics
    assert "precondition_coverage_gap" in d and "precondition_khat" in d
    assert severities[0][0] > 1.0 and severities[1][0] > 1.0, severities
    assert 9 in severities and len(rescue_smc) == 1
    parts, log_w = rescue_smc[0][:2]
    w = torch.softmax(log_w, 0)
    frac_right = float((w * (parts[:, 0] > 0)).sum())
    return {"rungs": [round(severities[i][0], 3) for i in (0, 1)],
            "rescue": round(severities[9][0], 3),
            "family": d["precondition_family"],
            "rescue_frac_right": frac_right}




def test_infer_spline_coupling_template():
    spline_coupling_template(STAT_SEED)


def test_infer_multimodal_escalation():
    multimodal_escalation(STAT_SEED)


def test_infer_escalation_ladder_mechanism(monkeypatch):
    escalation_ladder_mechanism(STAT_SEED, monkeypatch)
