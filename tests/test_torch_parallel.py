"""The port's multi-device layer (``enflows_tpu_torch/parallel/``) on the
CPU: meshes, collectives, the distributed resampler, sharded SMC and
sharded MCMC.

The port runs one process a rank; here 2 and 4 gloo ranks
(``_torch_ranks.run_ranks``, one thread each, a timeout each), one spawn a
world size carrying every check, held two ways in float64:

* against the JAX package on its 8-device CPU mesh, a mesh of the same
  size, on the same numpy inputs: the collectives to 1e-12, the
  resampler's rows identical for both exchanges, one sharded SMC step
  (with and without the transport, resampling and not) given JAX's draws
  (rebuilt from its keys, as tests/test_torch_smc.py rebuilds them) to
  1e-10, and a short ladder to 1e-8;
* against the single-process port on the same generator: the trajectory
  of a ladder (betas rtol 1e-9, log Z 1e-8, particles 1e-6), with the
  transport too, NUTS and HMC draw for draw, and ChEES's moments
  (tests/test_parallel.py:131-155, :157, :240, :282).

Every replicated output is checked bit for bit across the ranks with
``assert_replicated_consistent`` inside the ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from enflows_tpu import parallel as JP
from enflows_tpu.distributions.base import std_normal_logpdf_sum as j_std
from enflows_tpu.smc import SMCState as JState
from enflows_tpu.smc.flow_transport import default_template as j_template

import enflows_tpu_torch as et
from enflows_tpu_torch import parallel as TP
from _torch_ranks import run_ranks

DT = jnp.float64
WORLDS = [2, 4]


def _jgauss2(q):
    d = q - jnp.asarray([1.5, -1.0], DT)
    return -0.5 * jnp.sum(d * d) / 0.25


def _jmix2(q):
    a = -0.5 * jnp.sum((q - 1.5) ** 2) + jnp.log(0.3)
    b = -0.5 * jnp.sum((q + 1.0) ** 2 / 0.5) + jnp.log(0.7)
    return jnp.logaddexp(a, b)


J_TARGETS = {"gauss2": _jgauss2, "mix2": _jmix2}


def _jmesh(world):
    return JP.make_mesh({"chains": world}, devices=jax.devices()[:world])


def _step_draws(k_t, n, d, mutation_steps):
    """The draws of one JAX sharded ``step(k_t, ...)``: the resampling
    uniform, then per mutation transition each particle's momentum normals
    and acceptance uniform, from the global split sliced
    (``enflows_tpu/parallel/smc_sharded.py:23-27``)."""
    k_res, k_mut = jax.random.split(k_t)
    u0 = float(jax.random.uniform(k_res, (), DT))

    def one(key):
        key_mom, key_acc = jax.random.split(key)
        return (jax.random.normal(key_mom, (d,), DT),
                jax.random.uniform(key_acc, (), DT))

    noise, u = [], []
    for t in range(mutation_steps):
        a, b = jax.vmap(one)(jax.random.split(jax.random.fold_in(k_mut, t),
                                              n))
        noise.append(np.asarray(a))
        u.append(np.asarray(b))
    return u0, noise, u


STEP_CASES = [
    # target, resample threshold (0: never, 1.1: always), transport steps
    ("mix2", 0.0, 0),
    ("mix2", 1.1, 0),
    ("gauss2", 0.0, 10),
    ("gauss2", 1.1, 10),
]
LADDER_CASES = [("gauss2", 0), ("gauss2", 20)]


def _build_spec(world):
    rng = np.random.default_rng(world)
    spec = {"x": rng.normal(size=(world, 5)),
            "y": rng.normal(size=(world, 3 * world)),
            "lw": rng.normal(size=256) * 2.0,
            "parts": rng.normal(size=(256, 3)),
            "u0": float(jax.random.uniform(jax.random.PRNGKey(3), (), DT)),
            "steps": [], "ladders": []}
    for i, (target, thr, ts) in enumerate(STEP_CASES):
        x = rng.normal(size=(128, 2)) * 1.3
        lw = rng.normal(size=128) * 0.3
        u0, noise, u = _step_draws(jax.random.PRNGKey(10 + i), 128, 2, 2)
        spec["steps"].append(dict(target=target, threshold=thr,
                                  transport_steps=ts, x=x, lw=lw, beta=0.2,
                                  L=3, u0=u0, noise=noise, u=u))
    for i, (target, ts) in enumerate(LADDER_CASES):
        key, k0 = jax.random.split(jax.random.PRNGKey(20 + i))
        x0 = np.asarray(jax.random.normal(k0, (256, 2), DT))
        u0s, noise, u = [], [], []
        for _ in range(40):
            key, k_t, _k_f = jax.random.split(key, 3)
            a, b, c = _step_draws(k_t, 256, 2, 2)
            u0s.append(a)
            noise += b
            u += c
        spec["ladders"].append(dict(target=target, transport_steps=ts,
                                    x0=x0, key=np.asarray(
                                        jax.random.PRNGKey(20 + i)),
                                    u0s=u0s, noise=noise, u=u,
                                    mutation_steps=2))
    return spec


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"w{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    spec = _build_spec(world)
    outs = run_ranks("basics", world, tmp_path_factory.mktemp(f"w{world}"),
                     spec, timeout=120)
    return world, spec, outs


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=msg)


def _shard_map(fn, world, in_spec=P("chains"), out_spec=P("chains")):
    return jax.jit(shard_map(fn, mesh=_jmesh(world), in_specs=in_spec,
                             out_specs=out_spec, check_vma=False))


# ------------------------------------------------------------------
# Meshes and collectives.

def test_exports_every_name_of_the_jax_package():
    """But the two that name JAX sharding objects."""
    for name in JP.__all__:
        if name not in ("chains_sharding", "replicated"):
            assert hasattr(TP, name), name


def test_mesh_without_a_group_is_one_rank():
    mesh = TP.make_mesh(device="cpu")
    assert mesh.shape == {"chains": 1} and mesh.axis_names == ("chains",)
    ax = mesh.axis("chains")
    x = torch.arange(3.0)
    assert TP.psum(x, ax) is x and TP.all_gather(x, ax) is x
    with pytest.raises(ValueError, match="do not cover"):
        TP.make_mesh({"chains": 2}, device="cpu")
    with pytest.raises(KeyError, match="no axis"):
        mesh.axis("batch")
    assert torch.equal(TP.shard_chains(x, mesh), x)


def test_collectives_match_jax(ranks):
    world, spec, outs = ranks
    x = jnp.asarray(spec["x"].reshape(-1))      # rank r's 5 values
    per = lambda f: _shard_map(f, world)(x).reshape(world, 5)
    want = {"psum": per(lambda v: JP.psum(v) * jnp.ones_like(v)),
            "pmean": per(lambda v: JP.pmean(v) * jnp.ones_like(v)),
            "pmax": per(lambda v: jax.lax.pmax(v, "chains")),
            "broadcast": per(lambda v: JP.broadcast_from_zero(v))}
    gathered = _shard_map(lambda v: JP.all_gather(v), world)(x)
    scattered = _shard_map(lambda v: JP.psum_scatter(v), world)(
        jnp.asarray(spec["y"].reshape(-1)))
    ring = _shard_map(lambda v: jax.lax.ppermute(
        v, "chains", [(i, (i - 1) % world) for i in range(world)]),
        world)(x).reshape(world, 5)
    for r, out in enumerate(outs):
        for k, v in want.items():
            _close(out[k], v[r], 1e-12, k)
        _close(out["all_gather"], np.asarray(gathered)[:5 * world], 1e-12)
        _close(out["all_gather_untiled"][:, 0], spec["x"], 1e-12)
        _close(out["psum_scatter"],
               np.asarray(scattered).reshape(world, 3)[r], 1e-12)
        _close(out["ring"], np.asarray(ring)[r], 1e-12)
        assert out["axis_index"] == r


def test_two_axis_mesh_and_refusals(ranks):
    world, spec, outs = ranks
    for r, out in enumerate(outs):
        assert out["two_shape"] == {"hosts": 2, "chains": world // 2}
        # Row-major: the "chains" line of rank r is its host's ranks.
        host = r // (world // 2)
        line = spec["x"][host * (world // 2):(host + 1) * (world // 2)]
        _close(out["two_psum"], line.sum(0), 1e-12)
        assert out["bad_mesh_raises"]
        assert out["diverging_caught"]


def test_resampler_matches_jax_both_exchanges(ranks):
    world, spec, outs = ranks
    mesh = _jmesh(world)
    sh = NamedSharding(mesh, P("chains"))
    rows = {}
    for method in ("gather", "ring"):
        f = jax.jit(shard_map(
            lambda k, w, p, m=method: JP.sharded_systematic_resample(
                k, w, p, method=m), mesh=mesh,
            in_specs=(P(), P("chains"), P("chains")), out_specs=P("chains"),
            check_vma=False))
        rows[method] = np.asarray(f(
            jax.random.PRNGKey(3), jax.device_put(jnp.asarray(spec["lw"]),
                                                  sh),
            jax.device_put(jnp.asarray(spec["parts"]), sh)))
    np.testing.assert_array_equal(rows["gather"], rows["ring"])
    n_local = 256 // world
    for r, out in enumerate(outs):
        for method in ("gather", "ring"):
            np.testing.assert_array_equal(
                out["resample"][method].numpy(),
                rows["gather"][r * n_local:(r + 1) * n_local], method)


# ------------------------------------------------------------------
# Sharded SMC against JAX's sharded SMC, given its draws.

@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[f"{t}-thr{h}-fit{s}" for t, h, s in STEP_CASES])
def test_sharded_smc_step_matches_jax(ranks, case):
    world, spec, outs = ranks
    c = spec["steps"][case]
    mesh = _jmesh(world)
    step = JP.build_sharded_smc_step(
        j_std, J_TARGETS[c["target"]], mesh, mutation_steps=2,
        leapfrog_steps=c["L"], resample_threshold=c["threshold"],
        transport_steps=c["transport_steps"])
    sh = NamedSharding(mesh, P("chains"))
    state = JState(jax.device_put(jnp.asarray(c["x"]), sh),
                   jax.device_put(jnp.asarray(c["lw"]), sh),
                   jnp.asarray(c["beta"], DT), jnp.asarray(0.1, DT),
                   jnp.asarray(0.3, DT))
    args = (j_template(state.particles),) if c["transport_steps"] else ()
    new, info = step(jax.random.PRNGKey(10 + case), state, *args)
    tol = 1e-10
    n_local = 128 // world
    assert bool(info.resampled) == (c["threshold"] > 1)
    for r, out in enumerate(outs):
        t_new, t_info = out["steps"][case]
        blk = slice(r * n_local, (r + 1) * n_local)
        _close(t_new.particles, np.asarray(new.particles)[blk], tol)
        _close(t_new.log_weights, np.asarray(new.log_weights)[blk], tol)
        for k in ("beta", "log_z", "step_size"):
            _close(getattr(t_new, k), getattr(new, k), tol, k)
        for k in ("ess", "accept_prob"):
            _close(getattr(t_info, k), getattr(info, k), tol, k)
        assert bool(t_info.resampled) == bool(info.resampled)


@pytest.mark.parametrize("case", range(len(LADDER_CASES)),
                         ids=[f"{t}-fit{s}" for t, s in LADDER_CASES])
def test_sharded_smc_ladder_matches_jax(ranks, case):
    world, spec, outs = ranks
    c = spec["ladders"][case]
    kw = dict(transport_template_fn=j_template,
              transport_steps=c["transport_steps"]) \
        if c["transport_steps"] else {}
    parts, lw, lz, infos = JP.smc_sample_sharded(
        J_TARGETS[c["target"]], jnp.asarray(c["key"]), _jmesh(world), dim=2,
        num_particles=256, mutation_steps=2, dtype=DT, **kw)
    n_local = 256 // world
    for r, out in enumerate(outs):
        t_parts, t_lw, t_lz, t_betas = out["ladders"][case]
        assert len(t_betas) == len(infos)
        _close(torch.stack(t_betas), [float(i.beta) for i in infos], 1e-8)
        _close(t_lz, lz, 1e-8)
        blk = slice(r * n_local, (r + 1) * n_local)
        _close(t_parts, np.asarray(parts)[blk], 1e-8)
        _close(t_lw, np.asarray(lw)[blk], 1e-8)


# ------------------------------------------------------------------
# Against the single-process port on the same generator.

@pytest.mark.parametrize("transport", [False, True])
def test_sharded_smc_follows_the_single_process_port(ranks, transport):
    world, spec, outs = ranks
    for out in outs:
        c = out["smc_vs_port"][transport]
        assert len(c["betas"][0]) == len(c["betas"][1])
        np.testing.assert_allclose(c["betas"][1], c["betas"][0], rtol=1e-9)
        np.testing.assert_allclose(c["log_z"][1], c["log_z"][0], atol=1e-8)
        np.testing.assert_allclose(c["parts"][1], c["parts"][0], atol=1e-6)
        np.testing.assert_allclose(c["lw"][1], c["lw"][0], atol=1e-6)
        assert abs(c["log_z"][1] - np.log(2 * np.pi * 0.25)) < 0.15


@pytest.mark.parametrize("alg", ["nuts", "hmc"])
def test_sharded_mcmc_follows_the_single_process_port(ranks, alg):
    world, spec, outs = ranks
    for out in outs:
        c = out["mcmc"][alg]
        np.testing.assert_allclose(c["draws"][1], c["draws"][0], rtol=0,
                                   atol=1e-10)
        assert c["step"][1] == pytest.approx(c["step"][0], rel=1e-12)
        np.testing.assert_allclose(c["inv_mass"][1], c["inv_mass"][0],
                                   rtol=1e-12)


def test_sharded_chees_moments(ranks):
    """tests/test_parallel.py:282's gates on the gathered draws."""
    world, spec, outs = ranks
    c = outs[0]["mcmc"]["chees"]
    s = c["draws"].reshape(-1, 2)
    np.testing.assert_allclose(np.cov(s.T), [[2.0, 1.2], [1.2, 1.0]],
                               atol=0.25)
    assert np.isfinite(c["step"]) and c["traj"] > 0.0
    for out in outs[1:]:
        assert out["mcmc"]["chees"]["step"] == c["step"]


def test_sharded_samplers_check_their_arguments():
    mesh = TP.make_mesh(device="cpu")
    logp = lambda q: -0.5 * (q * q).sum(-1)
    g = torch.Generator()
    with pytest.raises(ValueError, match="implementation"):
        TP.sample_sharded(logp, g, mesh, dim=2, implementation="pmap")
    with pytest.raises(ValueError, match="algorithm"):
        TP.sample_sharded(logp, g, mesh, dim=2, algorithm="mala")
    with pytest.raises(ValueError, match="metrics"):
        TP.smc_sample_sharded(logp, g, mesh, dim=2, num_particles=8,
                              in_graph=True,
                              metrics=et.utils.MetricsLogger(None))
    with pytest.raises(ValueError, match="base_sampler"):
        TP.smc_sample_sharded(logp, g, mesh, dim=2, log_base=logp)
