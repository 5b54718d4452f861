"""full_pipeline's preconditioned NUTS in both packages on one fitted flow,
on the CPU.

    python tools/compare_pipeline_nuts.py [--chains 16] [--warmup 100]
        [--samples 50] [--jax-only]

Fits full_pipeline's whitening model with the JAX package (the script's
data, keys and 200 x 10 Adagrad steps), carries the fit over with
``enflows_tpu_torch.interop.from_jax``, and prints: the port's fit of the
same data from the same start against JAX's (negll histories, parameters),
the preconditioned log density and gradient of both packages at a few
points, then NUTS with target_accept 0.9 in each package, on JAX's fit and
(the port) on its own fit: the adapted step size, the leaves a transition
(mean and most), divergences, the pushed-forward draws' min ESS and the
seconds; ``--jax-only`` leaves out the port's NUTS (hours on the CPU at
the script's depths). Like the tests, it imports both packages.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--jax-only", action="store_true")
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    import enflows_tpu as ef
    import enflows_tpu_torch as et
    from enflows_tpu.mcmc import ess_per_dim, flow_preconditioned, sample
    from enflows_tpu.train import optimize_whitening
    from enflows_tpu_torch import mcmc as tm
    from enflows_tpu_torch.examples import full_pipeline as FP
    from enflows_tpu_torch.examples.nf_example_2d import ground_truth
    from enflows_tpu_torch.interop import from_jax

    dt = jnp.float32
    v = lambda *a: jnp.asarray(a, dt)
    target = ef.FlowDistribution(bijector=ef.compose(
        ef.ScaleShift(a=v(1.3, 0.4), b=v(2.5, -1.2)),
        ef.Householder(V=v(1.0, 0.3)),
        ef.CenterStretch(a=v(4.0, 4.1), b=v(2.0, 2.1), c=v(3.0, 3.1))))
    X = target.sample(jax.random.PRNGKey(0), (50_000,), dim=2)
    V0 = jax.random.normal(jax.random.PRNGKey(1), (2,), dt)
    model = ef.compose(
        ef.Johnson(gamma=v(0.0, 0.0), delta=v(5.0, 5.0), xi=v(0.0, 0.0),
                   lam=v(5.0, 5.0)),
        ef.invert(ef.CenterStretch(a=v(0.0, 0.0), b=v(1.0, 1.0),
                                   c=v(0.0, 0.0))),
        ef.invert(ef.Householder(V=V0)),
        ef.ScaleShift(a=v(1.0, 1.0), b=v(0.0, 0.0)))
    fit = optimize_whitening(X, model, optax.adagrad(0.1), nbatches=200,
                             nepochs=10)

    cpu = torch.device("cpu")
    own = FP.fit(torch.tensor(np.asarray(X)),
                 FP.model(torch.tensor(np.asarray(V0))), 200, 10)
    hist = np.abs(np.asarray(fit.negll_history)
                  - own.negll_history.numpy()).max()
    params = max(float(np.abs(np.asarray(a) - b.detach().numpy()).max())
                 for a, b in zip(jax.tree_util.tree_leaves(fit.result),
                                 own.result.parameters()))
    print(f"[fit] 2,000 steps: negll histories max |torch - jax| "
          f"{hist:.3e}, parameters {params:.3e}", flush=True)

    pre_j = flow_preconditioned(target.logpdf, ef.invert(fit.result))
    t_target = et.FlowDistribution(ground_truth(cpu)).requires_grad_(False)
    flows = {"torch on the JAX fit": from_jax(fit.result, device="cpu"),
             "torch on its own fit": own.result}
    pre_t = tm.flow_preconditioned(t_target.logpdf,
                                   et.invert(flows["torch on the JAX fit"]))
    z = np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32)
    lj, gj = jax.vmap(jax.value_and_grad(pre_j.logdensity_fn))(
        jnp.asarray(z))
    lt, gt = tm.value_and_grad(pre_t.logdensity_fn, torch.tensor(z))
    print(f"[density] on the JAX fit, 16 points: log density max |torch - "
          f"jax| {np.abs(np.asarray(lj) - lt.numpy()).max():.3e}, gradient "
          f"{np.abs(np.asarray(gj) - gt.numpy()).max():.3e}", flush=True)

    kw = dict(dim=2, num_chains=args.chains, num_warmup=args.warmup,
              num_samples=args.samples, target_accept=0.9)
    depth = f"{args.chains} chains x {args.warmup} + {args.samples}"
    t0 = time.perf_counter()
    s, _, st = sample(pre_j.logdensity_fn, jax.random.PRNGKey(3), **kw)
    s.block_until_ready()
    steps = np.asarray(st.num_steps)
    print(f"[nuts] jax on the JAX fit, {depth}: step size "
          f"{float(st.step_size):.4f}, leaves a transition mean "
          f"{steps.mean():.1f} most {steps.max()}, divergences "
          f"{int(np.asarray(st.divergent).sum())}, min ESS "
          f"{ess_per_dim(np.asarray(pre_j.push_forward(s))).min():.1f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for label, flow in ({} if args.jax_only else flows).items():
        pre = tm.flow_preconditioned(t_target.logpdf, et.invert(flow))
        t0 = time.perf_counter()
        s, _, st = tm.sample(pre.logdensity_fn,
                             torch.Generator().manual_seed(3), device=cpu,
                             **kw)
        with torch.no_grad():
            ess = float(tm.ess_per_dim(pre.push_forward(s)).min())
        print(f"[nuts] {label}, {depth}: step size "
              f"{float(st.step_size):.4f}, leaves a transition mean "
              f"{float(st.num_steps.float().mean()):.1f} most "
              f"{int(st.num_steps.max())}, divergences "
              f"{int(st.divergent.sum())}, min ESS {ess:.1f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
