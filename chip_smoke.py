"""Drive the PyTorch port's whitening main path once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one printed line each (more for the slice); any mismatch or
exception exits non-zero and prints no result:

1. the card's ``nvidia-smi`` name and power limit, and the kernels' build
   from ``enflows_tpu_torch/ops/csrc/elementwise.cu`` (timed);
2. B1 (fused forward+ladj) against the plain version: the flagship flow at
   d=2, n=2^24 and at d=50, n=2^17;
3. B2 (its backward) against plain autograd: loss sum(sin y) + sum(ladj^2)
   at d=2, n=2^22, every gradient;
4. B3 (single-pass negll + gradient) against the plain version at d=2,
   n=2^22 and at d=50, n=2^17, then all three on a sweep of other chains
   and shapes (``SWEEP``) against the plain version in float32 and
   float64;
5. the slice, with the launch counters set to 0 just before it: whitening
   data X = f_true(z) (n=2^22, f_true as in examples/nf_example_2d.py) with
   the 2D example's model and with the flagship flow; optimize_whitening for
   3 epochs of 4 batches (12 steps of 2^20 samples, each one B3 launch),
   then the fitted flow's full-data negll and its gradient through B1 and
   B2, and cov(f(X)). Each history is finite, falls, and matches a
   plain-path run of the same trainer on the card to 1e-4 relative (f32
   sums taken in another order).

Tolerances: y 2e-5 and ladj 2e-4 (rtol = atol), input cotangents rtol 2e-4
/ atol 2e-5 elementwise, negll 1e-5 relative. Every parameter gradient is
a sum over millions of samples, accumulated in another order; it is held
against the plain version run in float64 on the same rows, within
2e-4 * max|g64| + 2e-5 or no further from it than twice the float32 plain
version is (``grads_ok``). The gradient
phases drop the few rows whose plain path meets an exact zero at a sign or
clamp point, where autograd of the plain stage bodies and the kernels'
analytic adjoints differ (``drop_exact_zero_rows``).

Weights are random, made from seeded ``torch.Generator`` s. The script needs
one card and no network; it imports nothing of JAX.
"""
import copy
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
Y_TOL, LADJ_TOL, G_RTOL, G_ATOL, NEGLL_RTOL = 2e-5, 2e-4, 2e-4, 2e-5, 1e-5
SLICE_RTOL = 1e-4


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds per call of ``fn`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(plain, kernel, iters=10):
    """(plain ms, kernel ms), timed plain, kernel, kernel, plain; the smaller
    of each pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return min(p1, p2), min(k1, k2)


def flagship_flow(et, dim, gen, device):
    """The flagship flow of __graft_entry__._flagship_flow: Johnson ->
    inverted CenterStretch -> 4-reflection Householder -> Johnson ->
    inverted CenterStretch, with its reflections drawn from ``gen``."""
    vec = lambda v: torch.full((dim,), v, device=device)
    V = torch.randn(4, dim, generator=gen, device=device)

    def johnson():
        return et.Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0))

    def stretch_inv():
        return et.invert(et.CenterStretch(vec(0.0), vec(1.0), vec(0.0)))

    return et.compose(johnson(), stretch_inv(),
                      et.Householder(V).canonicalize(), johnson(),
                      stretch_inv())


def example_2d(et, gen, device):
    """(f_true, model) of examples/nf_example_2d.py."""
    vec = lambda *a: torch.tensor(a, device=device)
    f_true = et.compose(
        et.ScaleShift(vec(1.3, 0.4), vec(2.5, -1.2)),
        et.Householder(vec(1.0, 0.3)),
        et.CenterStretch(vec(4.0, 4.1), vec(2.0, 2.1), vec(3.0, 3.1)))
    model = et.compose(
        et.invert(et.CenterStretch(vec(0.0, 0.0), vec(1.0, 1.0),
                                   vec(0.0, 0.0))),
        et.invert(et.Householder(torch.randn(2, generator=gen,
                                             device=device))),
        et.ScaleShift(vec(1.0, 1.0), vec(0.0, 0.0)))
    return f_true, model


def max_abs(a, b):
    return float((a - b).abs().max())


def grads_ok(got, plain, plain64):
    """Every parameter gradient of the kernel against the plain version run
    in float64 on the same inputs: within G_RTOL * max|g64| + G_ATOL, or no
    further from it than twice the float32 plain version is. (A gradient
    that is 0 in exact arithmetic, such as CenterContract's b at a = 0, is
    a sum of millions of rounding errors in f32.) Returns the worst
    max|kernel - plain f32|."""
    worst = 0.0
    for k, r64 in plain64.items():
        err_k = max_abs(got[k].double(), r64)
        err_p = max_abs(plain[k].double(), r64)
        scale = float(r64.abs().max())
        check(err_k <= max(G_RTOL * scale + G_ATOL, 2.0 * err_p),
              f"gradient {k}: |kernel - f64| {err_k:.3e}, |plain f32 - f64| "
              f"{err_p:.3e}, max|f64| {scale:.3e}")
        worst = max(worst, max_abs(got[k], plain[k]))
    return worst


def phase_b1(et, EW, dim, n, gen, device, card):
    chain = flagship_flow(et, dim, gen, device)
    x = torch.randn(n, dim, generator=gen, device=device)
    with torch.no_grad():
        y, ladj = EW.fused_forward_and_ladj(chain, x)
        y0, l0 = EW.forward_and_ladj_plain(chain, x)
        torch.cuda.synchronize()
        check(torch.allclose(y, y0, rtol=Y_TOL, atol=Y_TOL),
              f"B1 y at d={dim}: max|dy| {max_abs(y, y0):.3e}")
        check(torch.allclose(ladj, l0, rtol=LADJ_TOL, atol=LADJ_TOL),
              f"B1 ladj at d={dim}: max|dladj| {max_abs(ladj, l0):.3e}")
        plan, pbuf, qbuf = EW._chain_plan(chain, dim, device)
        plain_ms, ms = interleaved_ms(
            lambda: EW.forward_and_ladj_plain(chain, x),
            lambda: EW._launch_fwd(plan, x, pbuf, qbuf))
        wrapper_ms = cuda_ms(lambda: EW.fused_forward_and_ladj(chain, x))
    err = max(max_abs(y, y0), max_abs(ladj, l0))
    print(f"[B1] flagship d={dim} n={n}: max|dy| {max_abs(y, y0):.3e} "
          f"max|dladj| {max_abs(ladj, l0):.3e}; kernel {ms:.4f} ms "
          f"(wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms [{card}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def drop_exact_zero_rows(et, EW, chain, x):
    """``x`` without the rows whose plain path meets a point where autograd
    of the stage bodies differs from the analytic derivative: an input of
    exactly 0 to Johnson's sign(u) * log(|u| + s) or JohnsonInv's sign(v),
    of exactly 0 to a CenterContract softplus argument (AD of exp(-|u|)),
    or |b t| <= 1e-6 in CenterStretch's clamp. torch.randn does return
    exact zeros in f32; the kernels' analytic adjoints are right there."""
    bad = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    t = x
    with torch.no_grad():
        for s in chain.stages:
            f = s.fields()
            if isinstance(s, et.Johnson):
                bad |= (t == f["xi"]).any(1)
            elif isinstance(s, et.JohnsonInv):
                bad |= (t == f["gamma"]).any(1)
            elif isinstance(s, et.CenterContract):
                u = t - f["c"]
                bad |= ((u == f["a"]) | (u == -f["a"])).any(1)
            elif isinstance(s, et.CenterStretch):
                bad |= ((f["b"] * t).abs() <= 1e-6).any(1)
            t, _ = EW.forward_and_ladj_plain(et.Chain.of(s), t)
    return x[~bad].contiguous(), int(bad.sum())


def phase_b2(et, EW, dim, n, gen, device, card):
    chain = flagship_flow(et, dim, gen, device)
    x, dropped = drop_exact_zero_rows(
        et, EW, chain, torch.randn(n, dim, generator=gen, device=device))
    params = dict(chain.named_parameters())

    def grads(forward):
        xr = x.clone().requires_grad_(True)
        y, ladj = forward(chain, xr)
        loss = torch.sin(y).sum() + (ladj * ladj).sum()
        gs = torch.autograd.grad(loss, [xr, *params.values()])
        return gs[0], dict(zip(params, gs[1:]))

    gx, g = grads(EW.fused_forward_and_ladj)
    gx0, g0 = grads(EW.forward_and_ladj_plain)
    chain64, x64 = copy.deepcopy(chain).double(), x.double()
    xr = x64.clone().requires_grad_(True)
    y, ladj = EW.forward_and_ladj_plain(chain64, xr)
    p64 = dict(chain64.named_parameters())
    g64 = dict(zip(p64, torch.autograd.grad(
        torch.sin(y).sum() + (ladj * ladj).sum(), list(p64.values()))))
    torch.cuda.synchronize()
    check(torch.allclose(gx, gx0, rtol=G_RTOL, atol=G_ATOL),
          f"B2 gx: max|diff| {max_abs(gx, gx0):.3e}")
    worst = grads_ok(g, g0, g64)

    # Time the backward alone: the kernel on saved forward outputs, the
    # plain version by autograd over a retained graph.
    with torch.no_grad():
        plan, pbuf, qbuf = EW._chain_plan(chain, dim, device)
        y, ladj = EW._launch_fwd(plan, x, pbuf, qbuf)
    gy, gl = torch.cos(y), 2.0 * ladj
    xr = x.clone().requires_grad_(True)
    y0, l0 = EW.forward_and_ladj_plain(chain, xr)
    plain_ms, ms = interleaved_ms(
        lambda: torch.autograd.grad([y0, l0], [xr, *params.values()],
                                    [gy, gl], retain_graph=True),
        lambda: EW._launch_grad(plan, x, pbuf, qbuf, gy, gl))
    err = max(max_abs(gx, gx0), worst)
    print(f"[B2] flagship d={dim} n={n} ({dropped} exact-zero rows "
          f"dropped): max|dgx| {max_abs(gx, gx0):.3e} "
          f"max|dgrad| {worst:.3e}; kernel {ms:.4f} ms, plain autograd "
          f"backward {plain_ms:.4f} ms [{card}]", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_b3(et, EW, dim, n, gen, device, card):
    chain = flagship_flow(et, dim, gen, device)
    x, dropped = drop_exact_zero_rows(
        et, EW, chain, torch.randn(n, dim, generator=gen, device=device))
    v, g = EW.fused_negll_value_and_grad(chain, x)
    v0, g0 = EW.negll_value_and_grad_plain(chain, x)
    _, g64 = EW.negll_value_and_grad_plain(copy.deepcopy(chain).double(),
                                           x.double())
    torch.cuda.synchronize()
    check(abs(float(v) - float(v0)) <= NEGLL_RTOL * abs(float(v0)),
          f"B3 negll at d={dim}: {float(v)} vs {float(v0)}")
    worst = grads_ok(g, g0, g64)
    plan, pbuf, qbuf = EW._chain_plan(chain, dim, device)
    pbuf, qbuf = pbuf.detach(), qbuf.detach()
    plain_ms, ms = interleaved_ms(
        lambda: EW.negll_value_and_grad_plain(chain, x),
        lambda: EW._launch_grad(plan, x, pbuf, qbuf))
    wrapper_ms = cuda_ms(lambda: EW.fused_negll_value_and_grad(chain, x))
    err = max(abs(float(v) - float(v0)), worst)
    print(f"[B3] flagship d={dim} n={n} ({dropped} exact-zero rows "
          f"dropped): negll {float(v):.7f} vs plain "
          f"{float(v0):.7f}, max|dgrad| {worst:.3e}; kernel {ms:.4f} ms "
          f"(wrapper {wrapper_ms:.4f} ms), plain value+grad "
          f"{plain_ms:.4f} ms [{card}]", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


SWEEP = [  # (d, n, stages); "~" marks an inverted stage
    (1, 1, ["j", "cs", "~ss"]),
    (2, 37, ["ss", "hh", "cc", "ji", "cs", "j"]),
    (3, 1001, ["~hh", "j", "cs", "hh", "ss"]),
    (4, 500, ["ss0", "cs0", "j"]),         # "0": scalar (0-d) parameters
    (50, 777, ["j", "cc", "hh", "ji", "~ss", "cs"]),
    (128, 300, ["cs", "hh", "hh", "j"]),
    (128, 5, ["hh"]),
    (5, 10, []),
    (300, 64, ["ss", "ji", "cc"]),
    (2048, 9, ["ss", "j", "cs"]),          # one block per SM
]


def sweep_chain(et, d, kinds, gen, device):
    def u(lo, hi, scalar=False):
        shape = () if scalar else (d,)
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    stages = []
    for kind in kinds:
        inv, scalar = kind.startswith("~"), kind.endswith("0")
        k = kind.strip("~0")
        if k == "ss":
            s = et.ScaleShift(u(0.5, 2.0, scalar), u(-1.0, 1.0, scalar))
        elif k in ("cs", "cc"):
            cls = et.CenterStretch if k == "cs" else et.CenterContract
            s = cls(u(0.1, 1.0, scalar), u(0.5, 2.5, scalar),
                    u(-0.5, 0.5, scalar))
        elif k in ("j", "ji"):
            cls = et.Johnson if k == "j" else et.JohnsonInv
            s = cls(u(-0.5, 0.5, scalar), u(2.0, 6.0, scalar),
                    u(-0.5, 0.5, scalar), u(2.0, 6.0, scalar))
        else:
            s = et.Householder(torch.randn(3, d, generator=gen,
                                           device=device)).canonicalize()
        stages.append(s.inverse() if inv else s)
    return et.Chain.of(*stages)


def close_to_f64(got, plain, plain64, tol, what):
    """``got`` within tol * max|f64| + tol of the float64 plain result, or
    no further from it than twice the float32 plain result is."""
    err_k = max_abs(got.double(), plain64)
    err_p = max_abs(plain.double(), plain64)
    scale = float(plain64.abs().max()) if plain64.numel() else 0.0
    check(err_k <= max(tol * scale + tol, 2.0 * err_p),
          f"{what}: |kernel - f64| {err_k:.3e}, |plain f32 - f64| "
          f"{err_p:.3e}, max|f64| {scale:.3e}")
    return err_k


def phase_sweep(et, EW, gen, device):
    """B1, B2 and B3 against the plain version (float32 and float64) on
    chains and shapes beyond the flagship: ragged tiles, every stage kind,
    inverted stages, scalar parameters, Householder-only and empty chains,
    d up to 2048; and the refusal of a chain the kernels do not take."""
    worst = 0.0
    for d, n, kinds in SWEEP:
        chain = sweep_chain(et, d, kinds, gen, device)
        check(EW.is_fusible_chain(chain, d), f"sweep d={d} {kinds} fusible")
        chain64 = copy.deepcopy(chain).double()
        x, _ = drop_exact_zero_rows(
            et, EW, chain, torch.randn(n, d, generator=gen, device=device))
        gy = torch.randn(x.shape, generator=gen, device=device)
        gl = torch.randn(x.shape[0], generator=gen, device=device)

        def b1_b2(c, forward, xx):
            xr = xx.clone().requires_grad_(True)
            y, ladj = forward(c, xr)
            ps = dict(c.named_parameters())
            outs = [(o, g) for o, g in ((y, gy), (ladj, gl))
                    if o.requires_grad]
            gs = torch.autograd.grad(
                [o for o, _ in outs], [xr, *ps.values()],
                [g.to(o.dtype) for o, g in outs], allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(ps.items(), gs[1:])}
            return y.detach(), ladj.detach(), gs[0], grads

        got = b1_b2(chain, EW.fused_forward_and_ladj, x)
        ref = b1_b2(chain, EW.forward_and_ladj_plain, x)
        ref64 = b1_b2(chain64, EW.forward_and_ladj_plain, x.double())
        what = f"sweep d={d} n={n} {kinds}"
        errs = [close_to_f64(got[0], ref[0], ref64[0], Y_TOL, what + " y"),
                close_to_f64(got[1], ref[1], ref64[1], LADJ_TOL,
                             what + " ladj"),
                close_to_f64(got[2], ref[2], ref64[2], G_RTOL,
                             what + " gx")]
        for k in ref64[3]:
            errs.append(close_to_f64(got[3][k], ref[3][k], ref64[3][k],
                                     G_RTOL, f"{what} B2 grad {k}"))
        v, g = EW.fused_negll_value_and_grad(chain, x)
        v0, g0 = EW.negll_value_and_grad_plain(chain, x)
        v64, g64 = EW.negll_value_and_grad_plain(chain64, x.double())
        errs.append(close_to_f64(v, v0, v64, NEGLL_RTOL, what + " negll"))
        for k in g64:
            errs.append(close_to_f64(g[k], g0[k], g64[k], G_RTOL,
                                     f"{what} B3 grad {k}"))
        worst = max(worst, *errs)
    wide = sweep_chain(et, 129, ["ss", "hh"], gen, device)
    try:
        EW.fused_forward_and_ladj(wide, torch.zeros(4, 129, device=device))
    except ValueError:
        refused = True
    else:
        refused = False
    check(refused, "a Householder chain at d=129 was not refused")
    print(f"[sweep] {len(SWEEP)} chains, d in "
          f"{sorted({d for d, _, _ in SWEEP})}: B1, B2, B3 within tolerance "
          f"of the float64 plain version (worst |kernel - f64| "
          f"{worst:.3e}); d=129 with a Householder refused", flush=True)


def train_and_evaluate(et, EW, name, model, X):
    """The user's path: fit, then evaluate the fitted flow's full-data negll
    and its gradient (B1 + B2) and cov(f(X))."""
    from enflows_tpu_torch.train import (mvnormal_negll_fused,
                                         optimize_whitening)

    before = EW.LAUNCHES["negll"]
    res = optimize_whitening(X, model, nbatches=4, nepochs=3)
    hist = res.negll_history.cpu()
    check(EW.LAUNCHES["negll"] - before == 12,
          f"{name}: {EW.LAUNCHES['negll'] - before} B3 launches, not 12")
    check(bool(torch.isfinite(hist).all()) and hist.shape == (12,),
          f"{name}: history {hist.tolist()}")
    check(float(hist[-1]) < float(hist[0]),
          f"{name}: negll did not fall: {hist.tolist()}")
    flow = res.result
    for p in flow.parameters():
        p.grad = None
    negll = mvnormal_negll_fused(flow, X)
    negll.backward()
    gnorm = torch.sqrt(sum((p.grad * p.grad).sum()
                           for p in flow.parameters()))
    with torch.no_grad():
        y, ladj = EW.fused_forward_and_ladj(flow, X)
    check(y.shape == X.shape and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(ladj).all()),
          f"{name}: fitted flow gives non-finite values")
    cov = torch.cov(y.T).cpu()
    print(f"[slice] {name}: negll history {[round(float(h), 5) for h in hist]}"
          f"; fitted full-data negll {float(negll.detach()):.5f}, |grad| "
          f"{float(gnorm):.4e}; cov(f(X)) = "
          f"{[[round(float(c), 4) for c in row] for row in cov]}",
          flush=True)
    return hist


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available()"
                         " is False)")
    sys.path.insert(0, HERE)
    import enflows_tpu_torch as et
    from enflows_tpu_torch.ops import elementwise as EW
    from enflows_tpu_torch.ops._build import build, load_library
    from enflows_tpu_torch.train import optimize_whitening

    pkg = os.path.dirname(os.path.abspath(et.__file__))
    check(pkg.startswith(HERE + os.sep),
          f"enflows_tpu_torch imported from {pkg}, not from this checkout")
    # The plain references run in full f32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = nvidia_smi_line()
    print(f"[gpu] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    so, seconds, report = build()
    load_library()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {seconds:.1f} s -> {os.path.relpath(so, HERE)}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    b1 = phase_b1(et, EW, 2, 1 << 24, gen, device, smi)
    phase_b1(et, EW, 50, 1 << 17, gen, device, smi)
    b2 = phase_b2(et, EW, 2, 1 << 22, gen, device, smi)
    b3 = phase_b3(et, EW, 2, 1 << 22, gen, device, smi)
    phase_sweep(et, EW, gen, device)
    phase_b3(et, EW, 50, 1 << 17, gen, device, smi)

    # The slice. Data and models are made before the counters are reset.
    f_true, model_2d = example_2d(et, gen, device)
    with torch.no_grad():
        X = f_true(torch.randn(1 << 22, 2, generator=gen, device=device))
    models = {"example_2d": model_2d,
              "flagship": flagship_flow(et, 2, gen, device)}
    initial = {k: copy.deepcopy(m) for k, m in models.items()}
    torch.cuda.synchronize()
    for k in EW.LAUNCHES:
        EW.LAUNCHES[k] = 0
    hists = {k: train_and_evaluate(et, EW, k, m, X)
             for k, m in models.items()}
    torch.cuda.synchronize()
    launches = dict(EW.LAUNCHES)
    print(f"[launches] main path: {launches}", flush=True)
    check(all(launches[k] > 0 for k in ("fwd", "bwd", "negll")),
          f"a kernel of the path was not launched: {launches}")

    for k, m in initial.items():
        # Warm trainer runs from the same start, timed plain, fused, fused,
        # plain on the host clock (each run ends in a synchronize).
        runs = {"plain": [], "fused": []}
        for path in ("plain", "fused", "fused", "plain"):
            flow = copy.deepcopy(m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = optimize_whitening(X, flow, nbatches=4, nepochs=3,
                                   use_fused=path == "fused")
            hist = r.negll_history.cpu()
            runs[path].append(((time.perf_counter() - t0) * 1e3 / 12, hist))
        plain = runs["plain"][0][1]
        rel = float(((hists[k] - plain).abs() / plain.abs()).max())
        print(f"[slice] {k}: plain-path history "
              f"{[round(float(h), 5) for h in plain]}; max rel diff "
              f"{rel:.3e}; warm ms/step (host clock, 2^20 samples): fused "
              f"{min(t for t, _ in runs['fused']):.3f}, plain "
              f"{min(t for t, _ in runs['plain']):.3f} [{smi}]", flush=True)
        check(rel <= SLICE_RTOL, f"{k}: fused vs plain history {rel:.3e}")

    src = "enflows_tpu_torch/ops/csrc/elementwise.cu"
    pallas = "enflows_tpu/ops/pallas/elementwise.py"
    rows = [("B1 fused_forward_and_ladj", "fwd", f"{pallas}:441", b1),
            ("B2 fused forward backward", "bwd", f"{pallas}:641", b2),
            ("B3 fused_negll_value_and_grad", "negll", f"{pallas}:852", b3)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], **vals}
        for name, key, rep, vals in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
