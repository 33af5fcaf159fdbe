"""Port parity: the models built with ``dtype=bfloat16`` against flax.

Each model of the GCN family and the interaction networks is built in both
packages with ``dtype=bfloat16`` and ``param_dtype`` float32 or bfloat16;
the flax parameters are carried over by ``convert`` (bf16 leaves stay
bf16).  Deterministic forwards on ``synthetic_planetoid("cora",
scale=0.08)``; GCN, ResGCN and GCN-ODE aggregate through the CSR kernel's
wrapper (its plain version on the CPU) against JAX's ``PallasCSR`` (its
kernel in interpret mode), and GCN-ODE also on the dense Â and the segment
path, each against JAX's same representation.  Held, leaf by leaf:

  * the dtype of every parameter, output and gradient equals JAX's;
  * log-probs and the loss agree to ``rtol = atol = 2e-2``, and every
    gradient to ``rtol = 2e-2`` and ``atol`` 2e-2 of the larger of 1 and
    its leaf's largest entry (bf16 features and states; JAX rounds each
    message and each rk4 coefficient to bf16 where the port keeps them in
    f32 until the sum, and a bf16 weight gradient sums products of bf16
    activations, so its entries carry roundings of the size of its
    largest);
  * the ODE state is bf16, as JAX's ``ODEBlock`` gets it, and the rk4
    stats are equal.

GCN-ODE also runs each adjoint.  JAX's checkpointed adjoint refuses a bf16
state with float32 parameters (``ValueError``: its flat reverse-sweep
array promotes the cotangent to float32, which ``jax.vjp`` rejects for a
bf16 output); the port raises ``ValueError`` there too.  The attention
models are in ``tests/test_torch_bf16_gat.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data import synthetic_planetoid as jsynthetic
from graph_odenet_tpu.data.nbody import SpringSystem as JSpringSystem
from graph_odenet_tpu.graph import to_dense as jto_dense
from graph_odenet_tpu.models import GCN as JGCN
from graph_odenet_tpu.models import GCNODE as JGCNODE
from graph_odenet_tpu.models import INODE as JINODE
from graph_odenet_tpu.models import InteractionNetwork as JInteractionNetwork
from graph_odenet_tpu.models import ResGCN as JResGCN
from graph_odenet_tpu.ops.pallas_spmm import prepare as jprepare
from graph_odenet_tpu.utils.metrics import masked_nll as jnll
from graph_odenet_tpu_torch.convert import params_from_flax, params_from_interaction
from graph_odenet_tpu_torch.data import SpringSystem
from graph_odenet_tpu_torch.data import synthetic_planetoid as tsynthetic
from graph_odenet_tpu_torch.graph import to_dense
from graph_odenet_tpu_torch.models import GCN, GCNODE, INODE, InteractionNetwork, ResGCN
from graph_odenet_tpu_torch.ops import prepare
from graph_odenet_tpu_torch.utils.metrics import masked_nll

BF = torch.bfloat16
TOL = dict(rtol=2e-2, atol=2e-2)
PARAM_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (BF, jnp.bfloat16)}
_TORCH = {"float32": torch.float32, "bfloat16": BF}


@pytest.fixture(scope="module")
def data():
    return tsynthetic("cora", scale=0.08), jsynthetic("cora", scale=0.08)


def adjacencies(td, jd, rep):
    """The port's and JAX's adjacency in one representation."""
    if rep == "dense":
        return to_dense(td.graph), jto_dense(jd.graph)
    if rep == "segment":
        return td.graph, jd.graph
    return prepare(td.graph), jprepare(jd.graph)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_params_and_grads(model, jparams, jgrads, convert):
    """Every parameter of ``model`` has its flax leaf's dtype, and every
    gradient its flax gradient's dtype and values (``TOL``, the absolute
    part scaled by the larger of 1 and the leaf's largest entry)."""
    want_p = convert(numpy_tree(jparams))
    want_g = convert(numpy_tree(jgrads))
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(want_g) == sorted(want_p)
    for k, p in params.items():
        assert p.dtype == want_p[k].dtype, k
        assert p.grad.dtype == want_g[k].dtype, k
        want = want_g[k].float().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.float().numpy(), want, err_msg=k,
                                   rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def state_dtypes(block):
    """Record the dtype of every state the ODE block's dynamics sees."""
    seen = []
    block.dynamics.register_forward_pre_hook(lambda m, args: seen.append(args[2].dtype))
    return seen


def assert_stats_match(stats, jstats):
    """Each JAX stat leaf: an int32 count is an equal Python int, a bool an
    equal bool, a float time a Python float that the leaf's dtype holds
    exactly (the port's stats are host scalars)."""
    assert sorted(stats) == sorted(jstats)
    for k, leaf in jstats.items():
        leaf = np.asarray(leaf)
        if leaf.dtype == np.bool_:
            assert isinstance(stats[k], bool) and stats[k] == bool(leaf), k
        elif leaf.dtype.kind == "i":
            assert type(stats[k]) is int, k
        else:
            as_leaf = torch.tensor(stats[k], dtype=_TORCH[leaf.dtype.name]).item()
            assert as_leaf == stats[k], (k, leaf.dtype)


GCN_MODELS = {
    "gcn": (lambda n_in, c, **kw: GCN(n_in, hidden=16, n_class=c, **kw),
            lambda c, **kw: JGCN(hidden=16, n_class=c, **kw)),
    "resgcn": (lambda n_in, c, **kw: ResGCN(n_in, hidden=16, n_class=c, n_blocks=2, **kw),
               lambda c, **kw: JResGCN(hidden=16, n_class=c, n_blocks=2, **kw)),
    "gcnode": (lambda n_in, c, **kw: GCNODE(n_in, hidden=16, n_class=c, method="rk4", steps=4,
                                             **kw),
               lambda c, **kw: JGCNODE(hidden=16, n_class=c, method="rk4", steps=4, **kw)),
}
GCN_CASES = (
    [(m, "kernel", False) for m in ("gcn", "resgcn")]
    + [("gcnode", rep, False) for rep in ("dense", "segment", "kernel")]
    + [("gcnode", "kernel", adjoint) for adjoint in (True, "checkpoint")]
)


@pytest.mark.parametrize("pdt", sorted(PARAM_DTYPES))
@pytest.mark.parametrize("name,rep,adjoint", GCN_CASES)
def test_gcn_family_bf16_matches_flax(data, name, rep, adjoint, pdt):
    td, jd = data
    tdt, jdt = PARAM_DTYPES[pdt]
    make_t, make_j = GCN_MODELS[name]
    ode = {"adjoint": adjoint} if name == "gcnode" else {}
    adj, jadj = adjacencies(td, jd, rep)
    jmodel = make_j(jd.n_class, dtype=jnp.bfloat16, param_dtype=jdt, **ode)
    jparams = jmodel.init(jax.random.PRNGKey(0), jadj, jd.features)["params"]

    def jloss(p):
        out, state = jmodel.apply({"params": p}, jadj, jd.features, mutable=["intermediates"])
        return jnll(out, jd.labels, jd.idx_train), (out, state)

    model = make_t(td.features.shape[1], td.n_class, dtype=BF, param_dtype=tdt, **ode)
    model.load_state_dict(params_from_flax(numpy_tree(jparams)))
    seen = state_dtypes(model.odeblock) if name == "gcnode" else []
    out = model(adj, td.features)
    loss = masked_nll(out, td.labels, td.idx_train)
    if adjoint == "checkpoint" and pdt == "f32":
        with pytest.raises(ValueError):
            jax.value_and_grad(jloss, has_aux=True)(jparams)
        with pytest.raises(ValueError, match="checkpointed adjoint"):
            loss.backward()
        return
    (jl, (jout, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    loss.backward()

    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert_params_and_grads(model, jparams, jgrads, params_from_flax)
    if name == "gcnode":
        (jstats,) = jstate["intermediates"]["ODEBlock_0"]["ode_stats"]
        assert_stats_match(model.odeblock.stats, jstats)
        assert model.odeblock.stats["nfe"] == int(jstats["nfe"]) == 16
        assert set(seen) == {BF}


N_BODIES = 5
IN_KW = dict(effect_dim=16, relation_hidden=(32, 32), object_hidden=(24,))


@pytest.fixture(scope="module")
def spring():
    """A batch-free window of the spring system: y0 [N, 4], masses, 5 times."""
    system = SpringSystem(n_bodies=N_BODIES)
    rng = np.random.default_rng(3)
    y0 = rng.standard_normal((N_BODIES, 4)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, (N_BODIES, 1)).astype(np.float32)
    ts = (np.arange(5) * 0.1).astype(np.float32)
    return y0, mass, ts, system.edges(), JSpringSystem(n_bodies=N_BODIES).edges()


@pytest.mark.parametrize("pdt", sorted(PARAM_DTYPES))
@pytest.mark.parametrize("name", ["interaction_network", "inode"])
def test_interaction_networks_bf16_match_flax(spring, name, pdt):
    """The discrete IN on the objects ``[mass ‖ y0]`` and the IN-ODE (rk4,
    4 steps an interval) over 5 times: f32 state and output in both (the
    bf16 accelerations are promoted by the concatenations), bf16 dense
    layers, gradients of ``sum(sin(out))``."""
    y0, mass, ts, (s, r), (js, jr) = spring
    tdt, jdt = PARAM_DTYPES[pdt]
    kw = dict(dtype=jnp.bfloat16, param_dtype=jdt)
    objs = np.concatenate([mass, y0], axis=-1)
    if name == "interaction_network":
        jmodel = JInteractionNetwork(out_dim=2, **IN_KW, **kw)
        jargs = (jnp.asarray(objs), js, jr)
        model = InteractionNetwork(5, 2, **IN_KW, dtype=BF, param_dtype=tdt)
        args = (torch.from_numpy(objs), s, r)
    else:
        jmodel = JINODE(dim=2, method="rk4", steps=4, **IN_KW, **kw)
        jargs = (jnp.asarray(y0), jnp.asarray(ts), jnp.asarray(mass), js, jr)
        model = INODE(dim=2, method="rk4", steps=4, **IN_KW, dtype=BF, param_dtype=tdt)
        args = (torch.from_numpy(y0), torch.from_numpy(ts), torch.from_numpy(mass), s, r)
    jparams = jmodel.init(jax.random.PRNGKey(0), *jargs)["params"]

    def jloss(p):
        out = jmodel.apply({"params": p}, *jargs)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    model.load_state_dict(params_from_interaction(numpy_tree(jparams)))
    out = model(*args)
    torch.sin(out.float()).sum().backward()
    assert out.dtype == _TORCH[jout.dtype.name]
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(jout, np.float32), **TOL)
    assert_params_and_grads(model, jparams, jgrads, params_from_interaction)
    if name == "inode":
        assert model.stats == {"nfe": 64}  # 4 intervals of 4 rk4 steps
