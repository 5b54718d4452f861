"""Plain PyTorch reference of a coupling stack: its forward and per-row log
|det J| (ladj), its inverse, the whitening loss, Adam, and one HMC
transition over a flow-defined target.

It follows the published descriptions (RealNVP affine couplings, Dinh et
al. 2017; rational-quadratic spline couplings, Durkan et al. 2019) with
the conventions of the configuration files: each conditioner layer is
``h @ W + b`` with ``W: (fan_in, fan_out)``, gelu in its tanh form after
every layer but the last, the untouched half is the first d/2 lanes and
the state is reversed between couplings. It imports nothing of the
program and computes in the dtype of the weights it is given (float64 in
the benchmark's checks), with TF32 turned off.
"""
from __future__ import annotations

import contextlib
import math

import torch

_GELU_C = math.sqrt(2.0 / math.pi)
_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
_DERIV_SHIFT = math.log(math.expm1(1.0 - _MIN_DERIV))


@contextlib.contextmanager
def tf32_off():
    """TF32 off for the reference's products, the process's flags as they
    were afterwards."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def gelu_tanh(h):
    return 0.5 * h * (1.0 + torch.tanh(_GELU_C * (h + 0.044715 * h ** 3)))


def mlp(layers, x):
    """The conditioner."""
    h = x
    for i, (W, b) in enumerate(layers):
        h = h @ W + b
        if i + 1 < len(layers):
            h = gelu_tanh(h)
    return h


def _knots(raw, bound):
    K = raw.shape[-1]
    p = _MIN_BIN + (1.0 - _MIN_BIN * K) * torch.softmax(raw, dim=-1)
    sizes = 2.0 * bound * p
    inner = -bound + torch.cumsum(sizes, dim=-1)[..., :-1]
    edge = torch.full_like(sizes[..., :1], bound)
    return sizes, torch.cat([-edge, inner, edge], dim=-1)


def rq_spline_forward(x, w_raw, h_raw, d_raw, bound):
    """Monotone rational-quadratic spline on [-bound, bound], identity with
    zero ladj outside: (y, elementwise ladj)."""
    K = w_raw.shape[-1]
    widths, xk = _knots(w_raw, bound)
    heights, yk = _knots(h_raw, bound)
    inner = _MIN_DERIV + torch.nn.functional.softplus(d_raw + _DERIV_SHIFT)
    one = torch.ones_like(inner[..., :1])
    derivs = torch.cat([one, inner, one], dim=-1)
    in_range = (x > -bound) & (x < bound)
    k = (x[..., None] >= xk[..., 1:-1]).sum(-1).clamp(0, K - 1)[..., None]
    take = lambda a, shift=0: torch.gather(a, -1, k + shift)[..., 0]
    wk, hk, x0, y0 = take(widths), take(heights), take(xk), take(yk)
    d0, d1 = take(derivs), take(derivs, 1)
    s = hk / wk
    xi = torch.where(in_range, (x - x0) / wk, torch.full_like(x, 0.5))
    xi = xi.clamp(0.0, 1.0)
    om = 1.0 - xi
    denom = s + (d1 + d0 - 2.0 * s) * xi * om
    y = y0 + hk * (s * xi * xi + d0 * xi * om) / denom
    ladj = torch.log(s * s * (d1 * xi * xi + 2.0 * s * xi * om
                              + d0 * om * om)) - 2.0 * torch.log(denom)
    return (torch.where(in_range, y, x),
            torch.where(in_range, ladj, torch.zeros_like(ladj)))


def coupling(cfg, layers, x, inverse=False):
    """One coupling: (new state, per-row ladj)."""
    da = cfg["dim"] // 2
    xa, xb = x[:, :da], x[:, da:]
    h = mlp(layers, xa)
    db = xb.shape[1]
    if cfg["coupling"] == "affine":
        m = cfg["max_log_scale"]
        s = m * torch.tanh(h[:, :db] / m)
        t = h[:, db:]
        if inverse:
            yb, ladj = (xb - t) * torch.exp(-s), -s.sum(-1)
        else:
            yb, ladj = xb * torch.exp(s) + t, s.sum(-1)
    else:
        if inverse:
            raise NotImplementedError("the spline's inverse is not needed "
                                      "by any cell")
        K = cfg["n_bins"]
        p = h.reshape(h.shape[0], db, 3 * K - 1)
        yb, el = rq_spline_forward(xb, p[..., :K], p[..., K:2 * K],
                                   p[..., 2 * K:], cfg["bound"])
        ladj = el.sum(-1)
    return torch.cat([xa, yb], dim=1), ladj


def forward_and_ladj(cfg, weights, x):
    """The stack: couplings with the state reversed between them."""
    ladj = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, layers in enumerate(weights):
        if i:
            x = x.flip(-1)
        x, l = coupling(cfg, layers, x)
        ladj = ladj + l
    return x, ladj


def inverse_and_ladj(cfg, weights, y):
    """The stack's inverse and its ladj."""
    ladj = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    for i, layers in reversed(list(enumerate(weights))):
        y, l = coupling(cfg, layers, y, inverse=True)
        ladj = ladj + l
        if i:
            y = y.flip(-1)
    return y, ladj


def std_normal_logpdf_rows(z):
    return -0.5 * (z * z).sum(-1) - 0.5 * z.shape[-1] * math.log(2 * math.pi)


def negll(cfg, weights, x):
    """Mean negative log-likelihood of the rows under N(0, I) after the
    stack."""
    y, ladj = forward_and_ladj(cfg, weights, x)
    return -(std_normal_logpdf_rows(y).sum() + ladj.sum()) / x.shape[0]


def negll_and_scale(cfg, weights, x, block_rows=16384):
    """The mean negative log-likelihood without autograd, block by block,
    and the size of the terms it sums: the rows' mean of 0.5 |y|^2 +
    |ladj|, against which a float32 loss's round-off is measured."""
    n = x.shape[0]
    loss = scale = 0.0
    with torch.no_grad():
        for r0 in range(0, n, block_rows):
            y, ladj = forward_and_ladj(cfg, weights, x[r0:r0 + block_rows])
            loss = loss - (std_normal_logpdf_rows(y).sum() + ladj.sum()) / n
            scale = scale + (0.5 * (y * y).sum() + ladj.abs().sum()) / n
    return loss, scale


def negll_and_grads(cfg, weights, x, block_rows=16384, spread=False):
    """(negll, [gradient of every leaf]) over the rows of x, summed block by
    block so that the autograd graph of one block at a time is held.

    ``spread`` adds, per leaf, the norm of the difference between the
    gradient over the first half of the rows and the whole batch's (half
    that of the two halves' gradients): the size of the batch's sampling
    noise in that leaf, against which a gradient's gap is measured."""
    leaves = [t for layers in weights for W_b in layers for t in W_b]
    halves = [[torch.zeros_like(t) for t in leaves] for _ in range(2)]
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    n = x.shape[0]
    if spread:      # blocks that end where the first half does
        block_rows = min(block_rows, n // 2)
        assert n % (2 * block_rows) == 0, "halves of whole blocks"
    for r0 in range(0, n, block_rows):
        ws = [[(W.detach().requires_grad_(True),
                b.detach().requires_grad_(True)) for W, b in layers]
              for layers in weights]
        xb = x[r0:r0 + block_rows]
        part = negll(cfg, ws, xb) * (xb.shape[0] / n)
        flat = [t for layers in ws for W_b in layers for t in W_b]
        gs = torch.autograd.grad(part, flat)
        for g, gb in zip(halves[2 * r0 >= n], gs):
            g += gb
        total += part.detach()
    grads = [a + b for a, b in zip(*halves)]
    if not spread:
        return total, grads
    return total, grads, [(a - b).norm() for a, b in zip(*halves)]


class Adam:
    """Adam (Kingma and Ba 2015) with bias correction, as ``x -= lr m_hat /
    (sqrt(v_hat) + eps)``; ``state`` (step count, first moments, second
    moments) resumes it, by default from zero."""

    def __init__(self, leaves, lr, betas, eps, state=None):
        self.leaves = leaves
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t, self.m, self.v = state or (
            0, [torch.zeros_like(t) for t in leaves],
            [torch.zeros_like(t) for t in leaves])

    def step(self, grads):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for x, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            x.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def pushforward_logp_and_grad(cfg, weights, x):
    """log density of X = T(Z), Z ~ N(0, I), at x, and its gradient in x:
    logp(x) = N(T^-1(x)) + ladj of T^-1."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        z, ladj = inverse_and_ladj(cfg, weights, x)
        lp = std_normal_logpdf_rows(z) + ladj
        g, = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def hmc_transition(cfg, weights, q, p, u, step_size, num_steps):
    """One Metropolis-adjusted HMC transition of every chain from q with
    momenta p and uniforms u, identity mass: velocity Verlet with one
    gradient a step, a NaN energy change rejects. Returns the starting
    log density and gradient, the proposal's acceptance probability, the
    decisions and the new positions."""
    vg = lambda x: pushforward_logp_and_grad(cfg, weights, x)
    lp0, g0 = vg(q)
    energy0 = -lp0 + 0.5 * (p * p).sum(-1)
    x, m, g, lp = q, p, g0, lp0
    for _ in range(num_steps):
        m = m + 0.5 * step_size * g
        x = x + step_size * m
        lp, g = vg(x)
        m = m + 0.5 * step_size * g
    delta = energy0 - (-lp + 0.5 * (m * m).sum(-1))
    delta = torch.where(torch.isnan(delta),
                        torch.full_like(delta, -math.inf), delta)
    accept_prob = torch.exp(delta).clamp(max=1.0)
    accepted = u < accept_prob
    q_new = torch.where(accepted[:, None], x, q)
    return dict(logp=lp0, grad=g0, accept_prob=accept_prob,
                accepted=accepted, q=q_new)
