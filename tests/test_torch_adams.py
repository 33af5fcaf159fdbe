"""Port parity: the Adams family (``explicit_adams``, ``implicit_adams``,
``fixed_adams``, the variable-order ``adams`` and ``adams_scan``) and
``scipy_solver`` against the JAX package, in float64.

The cases of ``tests/test_ode.py``'s Adams, VCABM and scipy tests, each run
through both packages on the same inputs.  The fixed-grid methods agree to
1e-14 with equal NFE counts.  VCABM agrees in every stat (``nfe``,
``n_accept``, ``n_reject``, ``success``, ``final_order``) and in values to
1e-10; ``t_reached`` of a solve that ran out of attempts short of its
target carries the rounding of the step sizes (1e-7 relative).  Gradients
agree with ``jax.grad`` to 1e-10, and through the continuous adjoint with
JAX's ``odeint_adjoint`` to 1e-9.  ``scipy_solver`` is forward only in both
packages.  With ``batch_dims=1`` every method here equals one solve per
sample (``tests/test_torch_batched_adams.py`` holds the batched VCABM and
``scipy_solver`` to ``jax.vmap``), and ``batch_dims=2`` raises.  The
models: GCN-ODE on ``implicit_adams`` and GAT-ODE on ``adams_scan`` against
flax through the kernels' plain wrappers, in float32 (1e-5 and 1e-4, as the
direct paths' tests hold them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.ode import odeint as jodeint
from graph_odenet_tpu.ode import odeint_adjoint as jadjoint
from graph_odenet_tpu.ode.api import SOLVERS as JSOLVERS
from graph_odenet_tpu.ode.vcabm import gamma_star as jgamma_star
from graph_odenet_tpu_torch.ode import SOLVERS, gamma_star, odeint_adjoint
from graph_odenet_tpu_torch.ode import odeint as todeint

F64 = torch.float64
SAME = dict(rtol=1e-14, atol=1e-14)   # the same steps, fixed grid
TRAJ = dict(rtol=1e-10, atol=1e-10)   # VCABM: the same steps, rounded differently
GRAD = dict(rtol=1e-10, atol=1e-12)
ADJOINT = dict(rtol=1e-9, atol=1e-9)
FIXED_ADAMS = ("explicit_adams", "implicit_adams", "fixed_adams")
TS = np.linspace(0.0, 2.0, 9)

PROBLEMS = {
    # name: (jax dynamics, torch dynamics, y0)
    "exp_decay": (lambda t, y: -0.5 * y, lambda t, y: -0.5 * y, [1.0, 2.0]),
    "oscillator": (
        lambda t, y: jnp.stack([y[1], -y[0]]),
        lambda t, y: torch.stack([y[1], -y[0]]),
        [1.0, 0.0],
    ),
    "forced": (
        lambda t, y: jnp.sin(t) * jnp.ones_like(y),
        lambda t, y: torch.sin(t) * torch.ones_like(y),
        [0.0, 0.5],
    ),
}


def _both(problem, method, ts, **kw):
    jf, tf, y0 = PROBLEMS[problem]
    y0 = np.asarray(y0, np.float64)
    jys, js = jodeint(jf, jnp.asarray(y0), jnp.asarray(ts), method=method, return_stats=True,
                      **kw)
    tys, tst = todeint(tf, torch.from_numpy(y0), torch.from_numpy(np.asarray(ts, np.float64)),
                       method=method, return_stats=True, **kw)
    assert tys.dtype == F64 and tys.shape == jys.shape
    return np.asarray(jys), js, tys.numpy(), tst


def test_solvers_are_jax_names():
    assert SOLVERS == JSOLVERS


# --- fixed-grid Adams (tests/test_ode.py:87-129, 264) ---------------------


@pytest.mark.parametrize("steps", [2, 8])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("method", FIXED_ADAMS)
def test_fixed_adams_matches_jax(method, problem, steps):
    """Values and NFE; two substeps an interval are all RK4 warm-up."""
    jys, js, tys, tst = _both(problem, method, TS, steps_per_interval=steps)
    np.testing.assert_allclose(tys, jys, **SAME)
    assert tst == {"nfe": int(js["nfe"])}


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_fixed_adams_reverse_time_matches_jax(method):
    jys, js, tys, tst = _both("forced", method, TS[::-1].copy(), steps_per_interval=8)
    np.testing.assert_allclose(tys, jys, **SAME)
    assert tst["nfe"] == int(js["nfe"])


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_adams_convergence_order_4(method):
    errs = []
    for n in (8, 16, 32):
        ys = todeint(lambda t, y: -0.5 * y, torch.tensor([1.0], dtype=F64), [0.0, 1.0],
                     method=method, steps_per_interval=n)
        errs.append(abs(float(ys[-1, 0]) - np.exp(-0.5)))
    assert np.log2(errs[0] / errs[1]) > 3.6 and np.log2(errs[1] / errs[2]) > 3.6, errs


def test_adams_fewer_nfe_than_rk4():
    _, tf, y0 = PROBLEMS["oscillator"]
    y0 = torch.tensor(y0, dtype=F64)
    _, s_ab = todeint(tf, y0, TS, method="explicit_adams", steps_per_interval=16,
                      return_stats=True)
    _, s_rk = todeint(tf, y0, TS, method="rk4", steps_per_interval=16, return_stats=True)
    assert s_ab["nfe"] < 0.5 * s_rk["nfe"]


def test_fixed_adams_is_implicit_adams_alias():
    _, tf, y0 = PROBLEMS["exp_decay"]
    y0 = torch.tensor(y0, dtype=F64)
    a = todeint(tf, y0, TS, method="fixed_adams", steps_per_interval=8)
    b = todeint(tf, y0, TS, method="implicit_adams", steps_per_interval=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- VCABM (tests/test_ode.py:690-765) ------------------------------------


def _assert_stats(tst, js, t_rel=0.0):
    for k in ("nfe", "n_accept", "n_reject", "final_order"):
        assert tst[k] == int(js[k]), k
    assert tst["success"] == bool(js["success"])
    np.testing.assert_allclose(tst["t_reached"], float(js["t_reached"]), rtol=t_rel, atol=0)


VCABM_CASES = {
    # name: (problem, ts, options)
    "oscillator": ("oscillator", np.linspace(0.0, 2 * np.pi, 20),
                   dict(rtol=1e-6, atol=1e-8, max_steps_per_interval=128)),
    "tight_decay": ("exp_decay", TS, dict(rtol=1e-9, atol=1e-11, max_steps_per_interval=128)),
    "time_dependent": ("forced", np.linspace(0.0, 3.0, 7), dict(rtol=1e-7, atol=1e-9)),
}


@pytest.mark.parametrize("case", sorted(VCABM_CASES))
@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_vcabm_matches_jax(method, case):
    problem, ts, kw = VCABM_CASES[case]
    jys, js, tys, tst = _both(problem, method, ts, **kw)
    np.testing.assert_allclose(tys, jys, **TRAJ)
    _assert_stats(tst, js)
    assert tst["success"]


def test_vcabm_order_adapts_up_as_in_jax():
    """A long smooth solve climbs past order 4, to JAX's final order."""
    jys, js, tys, tst = _both("oscillator", "adams", np.array([0.0, 4 * np.pi]),
                              rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tys, jys, **TRAJ)
    _assert_stats(tst, js)
    assert tst["final_order"] >= 4


def test_vcabm_fewer_nfe_than_dopri5():
    _, tf, y0 = PROBLEMS["oscillator"]
    y0 = torch.tensor(y0, dtype=F64)
    kw = dict(rtol=1e-8, atol=1e-10, return_stats=True)
    _, s_ad = todeint(tf, y0, [0.0, 2 * np.pi], method="adams", **kw)
    _, s_dp = todeint(tf, y0, [0.0, 2 * np.pi], method="dopri5", **kw)
    assert s_ad["nfe"] < s_dp["nfe"]


@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_vcabm_reverse_time_matches_jax(method):
    jf = tf = lambda t, y: -y  # noqa: E731
    PROBLEMS["neg"] = (jf, tf, [1.0])
    try:
        jys, js, tys, tst = _both("neg", method, np.array([1.0, 0.0]), rtol=1e-8, atol=1e-10)
    finally:
        del PROBLEMS["neg"]
    np.testing.assert_allclose(tys, jys, **TRAJ)
    _assert_stats(tst, js)
    np.testing.assert_allclose(tys[-1, 0], np.e, rtol=1e-5)


@pytest.mark.parametrize("method,budget", [("adams", "max_steps"),
                                           ("adams_scan", "max_steps_per_interval")])
def test_vcabm_exhaustion_reported_as_in_jax(method, budget):
    jys, js, tys, tst = _both("oscillator", method, np.array([0.0, 2 * np.pi]), rtol=1e-9,
                              atol=1e-12, **{budget: 3})
    np.testing.assert_allclose(tys, jys, **TRAJ)
    _assert_stats(tst, js, t_rel=1e-7)
    assert not tst["success"] and tst["t_reached"] < 2 * np.pi


def test_vcabm_scan_runs_out_of_attempts_as_in_jax():
    """64 attempts are too few for 4π at rtol 1e-9: both stop at the same
    step with the same counts and order."""
    jys, js, tys, tst = _both("oscillator", "adams_scan", np.array([0.0, 4 * np.pi]),
                              rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tys, jys, rtol=1e-7, atol=1e-7)
    _assert_stats(tst, js, t_rel=1e-7)
    assert not tst["success"]


def test_vcabm_max_order_bounds_the_order_as_in_jax():
    jys, js, tys, tst = _both("oscillator", "adams", np.array([0.0, 4 * np.pi]),
                              rtol=1e-9, atol=1e-11, max_order=5)
    np.testing.assert_allclose(tys, jys, **TRAJ)
    _assert_stats(tst, js)
    assert tst["final_order"] <= 5


@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_vcabm_first_step_matches_jax(method):
    """A first step 300 times too long: four rejections shrink it to 3e-5,
    and then the steps grow by up to 60 at a time, so the β rescaling of the
    high-order differences amplifies rounding.  The stats agree; the values
    to 1e-7, because the compiled JAX solve ends 1.6e-8 from JAX's own
    op-by-op run (XLA fuses and reorders the sums; the next test)."""
    jys, js, tys, tst = _both("forced", method, np.linspace(0.0, 3.0, 4), rtol=1e-7,
                              atol=1e-9, first_step=0.01)
    np.testing.assert_allclose(tys, jys, rtol=1e-7, atol=1e-7)
    _assert_stats(tst, js)
    assert tst["n_reject"] >= 4


def test_vcabm_matches_jax_op_by_op_to_the_bit():
    """The same solve against JAX run op by op (``jax.disable_jit``): the
    port's sums are in that order, and the values agree to the last bit."""
    with jax.disable_jit():
        jys, js, tys, tst = _both("forced", "adams", np.linspace(0.0, 1.0, 2), rtol=1e-7,
                                  atol=1e-9, first_step=0.01)
    np.testing.assert_array_equal(tys, jys)
    _assert_stats(tst, js)
    assert tst["n_reject"] >= 4


def test_gamma_star_is_exact():
    np.testing.assert_array_equal(gamma_star(14), jgamma_star(14))
    np.testing.assert_allclose(
        gamma_star(6), [1.0, -1 / 2, -1 / 12, -1 / 24, -19 / 720, -3 / 160], atol=1e-15)


# --- gradients -------------------------------------------------------------


@pytest.mark.parametrize("method", ["implicit_adams", "explicit_adams", "adams_scan", "adams"])
def test_gradient_matches_jax_grad(method):
    """A nonlinear two-parameter field; ``adams`` (JAX's while form) is held to
    ``jax.grad`` of the scan form, which takes the same steps."""
    ts = np.linspace(0.0, 1.5, 4)
    y0 = np.array([0.3, -0.2, 0.8])
    w = np.random.default_rng(0).standard_normal((4, 3))
    kw = dict(steps_per_interval=6, rtol=1e-7, atol=1e-9, max_steps_per_interval=128)
    jmethod = "adams_scan" if method == "adams" else method

    def jloss(k, b, y0):
        ys = jodeint(lambda t, y, k, b: jnp.tanh(k * jnp.roll(y, 1)) - b * y, y0,
                     jnp.asarray(ts), k, b, method=jmethod, **kw)
        return jnp.sum(ys * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(0.9), jnp.asarray(0.4), jnp.asarray(y0))
    k, b, y = (torch.tensor(v, dtype=F64, requires_grad=True) for v in (0.9, 0.4, y0))
    ys = todeint(lambda t, y, k, b: torch.tanh(k * torch.roll(y, 1)) - b * y, y,
                 torch.from_numpy(ts), k, b, method=method, **kw)
    (ys * torch.from_numpy(w)).sum().backward()
    for got, want in zip((k, b, y), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GRAD)


def test_grad_through_vcabm_scan_is_analytic():
    k = torch.tensor(0.7, dtype=F64, requires_grad=True)
    ys = todeint(lambda t, y, k: -k * y, torch.tensor([1.0], dtype=F64), [0.0, 1.0], k,
                 method="adams_scan", rtol=1e-7, atol=1e-9, max_steps_per_interval=128)
    ys[-1, 0].backward()
    np.testing.assert_allclose(float(k.grad), -np.exp(-0.7), rtol=1e-4)


@pytest.mark.parametrize("method", ["implicit_adams", "explicit_adams", "adams"])
def test_continuous_adjoint_matches_jax(method):
    """The continuous adjoint reruns the forward's method backwards."""
    ts = np.linspace(0.0, 1.0, 3)
    y0 = np.array([0.5, -1.0])
    w = np.array([[0.0, 0.0], [1.0, -0.5], [0.3, 2.0]])
    kw = dict(method=method, steps_per_interval=8, rtol=1e-8, atol=1e-10)

    def jloss(k, y0):
        ys = jadjoint(lambda t, y, k: -k * y + jnp.sin(t) * y[::-1], y0, jnp.asarray(ts), k,
                      **kw)
        return jnp.sum(ys * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(0.7), jnp.asarray(y0))
    k, y = (torch.tensor(v, dtype=F64, requires_grad=True) for v in (0.7, y0))
    ys, stats = odeint_adjoint(lambda t, y, k: -k * y + torch.sin(t) * y.flip(0), y,
                               torch.from_numpy(ts), k, return_stats=True, **kw)
    (ys * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(float(k.grad), float(jg[0]), **ADJOINT)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jg[1]), **ADJOINT)
    assert stats["nfe"] > 0


@pytest.mark.parametrize("method", ["adams", "implicit_adams", "scipy_solver"])
def test_checkpointed_adjoint_refuses_with_jax_message(method):
    with pytest.raises(ValueError, match="checkpoint adjoint") as got:
        odeint_adjoint(lambda t, y: -y, torch.tensor([1.0]), [0.0, 1.0], method=method,
                       checkpoint=True)
    with pytest.raises(ValueError) as want:
        jadjoint(lambda t, y: -y, jnp.array([1.0]), jnp.array([0.0, 1.0]), method=method,
                 checkpoint=True)
    assert str(got.value) == str(want.value)


# --- scipy_solver (tests/test_ode.py:273-310) -----------------------------


def test_scipy_solver_matches_jax():
    jys, js, tys, tst = _both("oscillator", "scipy_solver", np.linspace(0.0, 2 * np.pi, 20),
                              rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tys, jys, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tys, np.stack([np.cos(np.linspace(0, 2 * np.pi, 20)),
                                              -np.sin(np.linspace(0, 2 * np.pi, 20))]).T,
                               atol=1e-5)
    assert tst == {"nfe": int(js["nfe"])} == {"nfe": -1}


@pytest.mark.parametrize("scipy_method", ["RK45", "DOP853", "LSODA"])
def test_scipy_solver_args_and_methods_match_jax(scipy_method):
    """Values the dynamics reads pass through ``*args``; reverse time is
    solve_ivp's own; the result comes back in ``y0``'s dtype."""
    ts = np.linspace(2.0, 0.0, 5)
    y0 = np.array([1.0, 2.0])
    kw = dict(method="scipy_solver", rtol=1e-8, atol=1e-10, scipy_method=scipy_method)
    jys = jodeint(lambda t, y, rate: -rate * y, jnp.asarray(y0), jnp.asarray(ts),
                  jnp.asarray(0.5), **kw)
    tys = todeint(lambda t, y, rate: -rate * y, torch.from_numpy(y0), torch.from_numpy(ts),
                  torch.tensor(0.5, dtype=F64), **kw)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-12, atol=1e-12)
    y32 = todeint(lambda t, y, rate: -rate * y, torch.from_numpy(y0).float(),
                  torch.from_numpy(ts), torch.tensor(0.5), **kw)
    assert y32.dtype == torch.float32


def test_scipy_solver_is_forward_only_as_in_jax():
    """JAX's pure_callback has no JVP, so ``jax.grad`` raises; the port's
    backward raises too."""
    with pytest.raises(Exception, match="(?i)jvp"):
        jax.grad(lambda r: jodeint(lambda t, y, r: -r * y, jnp.array([1.0]),
                                   jnp.array([0.0, 1.0]), r, method="scipy_solver")[-1, 0])(
            jnp.asarray(0.5))
    r = torch.tensor(0.5, dtype=F64, requires_grad=True)
    ys = todeint(lambda t, y, r: -r * y, torch.tensor([1.0], dtype=F64), [0.0, 1.0], r,
                 method="scipy_solver")
    with pytest.raises(RuntimeError, match="forward only"):
        ys[-1, 0].backward()


# --- batch_dims=1 -----------------------------------------------------------


@pytest.mark.parametrize("method", FIXED_ADAMS)
def test_fixed_adams_batched_equals_per_sample_solves(method):
    rng = np.random.default_rng(1)
    y0 = torch.from_numpy(rng.standard_normal((3, 4)))
    a = torch.from_numpy(rng.standard_normal((3, 4)))

    def f(t, y):
        return torch.tanh(a[: y.shape[0]] * y) * torch.cos(t)

    ys, stats = todeint(f, y0, TS, method=method, steps_per_interval=6, batch_dims=1,
                        return_stats=True)
    for b in range(3):
        one, one_stats = todeint(lambda t, y, b=b: torch.tanh(a[b] * y) * torch.cos(t), y0[b],
                                 TS, method=method, steps_per_interval=6, return_stats=True)
        torch.testing.assert_close(ys[:, b], one, rtol=0, atol=0)
        assert stats == one_stats


@pytest.mark.parametrize("method", ["adams", "adams_scan", "scipy_solver"])
def test_vcabm_and_scipy_batched_equal_per_sample_solves(method):
    rng = np.random.default_rng(1)
    y0 = torch.from_numpy(rng.standard_normal((3, 4)))
    a = torch.from_numpy(rng.standard_normal((3, 4)))

    def f(t, y):
        return torch.tanh(a * y) * torch.cos(t)[:, None]

    kw = dict(method=method, rtol=1e-7, atol=1e-9, return_stats=True)
    ys, stats = todeint(f, y0, TS, batch_dims=1, **kw)
    for b in range(3):
        one, one_stats = todeint(lambda t, y, b=b: torch.tanh(a[b] * y) * torch.cos(t), y0[b],
                                 TS, **kw)
        torch.testing.assert_close(ys[:, b], one, **TRAJ)
        for k, v in one_stats.items():
            assert stats[k][b].item() == pytest.approx(v, rel=1e-12), k


@pytest.mark.parametrize("method", ["adams", "adams_scan", "scipy_solver"])
def test_unbatched_methods_refuse_batch_dims(method):
    """These methods batch (the test above); ``batch_dims`` other than 0 and 1
    still raises, as for every method."""
    with pytest.raises(ValueError, match="batch_dims"):
        todeint(lambda t, y: -y, torch.ones(2, 2, 3), [0.0, 1.0], method=method, batch_dims=2)


# --- the models ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cora():
    from graph_odenet_tpu.data import synthetic_planetoid as jsynthetic
    from graph_odenet_tpu_torch.data import synthetic_planetoid as tsynthetic

    return tsynthetic("cora", scale=0.08), jsynthetic("cora", scale=0.08)


def _model_pair(name, n_in, n_class):
    from graph_odenet_tpu.models import GATODE as JGATODE
    from graph_odenet_tpu.models import GCNODE as JGCNODE
    from graph_odenet_tpu_torch.models import GATODE, GCNODE

    if name == "gcnode":
        return (GCNODE(n_in, hidden=8, n_class=n_class, method="implicit_adams", steps=5),
                JGCNODE(hidden=8, n_class=n_class, method="implicit_adams", steps=5))
    return (GATODE(n_in, hidden=4, heads=2, n_class=n_class, method="adams_scan", steps=8),
            JGATODE(hidden=4, heads=2, n_class=n_class, method="adams_scan", steps=8))


@pytest.mark.parametrize("name,tol", [("gcnode", 1e-5), ("gatode", 1e-4)])
def test_models_on_adams_match_flax(cora, name, tol):
    """GCN-ODE on ``implicit_adams`` (B1's wrapper), GAT-ODE on ``adams_scan``
    (B3-B5's wrappers): log-probs, loss, every parameter gradient and the
    solver's stats against flax."""
    from graph_odenet_tpu.utils.metrics import masked_nll as jnll
    from graph_odenet_tpu_torch.convert import params_from_flax
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.utils.metrics import masked_nll

    td, jd = cora
    model, jmodel = _model_pair(name, td.features.shape[1], td.n_class)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jd.graph, jd.features)["params"]

    @jax.jit
    def jloss(p):
        out, state = jmodel.apply({"params": p}, jd.graph, jd.features, mutable=["intermediates"])
        return jnll(out, jd.labels, jd.idx_train), (out, state)

    (jl, (jout, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    out = model(prepare(td.graph), td.features)
    loss = masked_nll(out, td.labels, td.idx_train)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=tol, atol=tol)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=tol, atol=tol, msg=lambda m, k=k: f"{k}: {m}")
    (jstats,) = jstate["intermediates"]["ODEBlock_0"]["ode_stats"]
    assert set(model.odeblock.stats) == set(jstats)
    for k, v in model.odeblock.stats.items():
        if k != "t_reached":
            assert v == int(jstats[k]), k
