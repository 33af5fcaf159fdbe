"""Port parity: the attention slice (GAT, ResGAT, GAT-ODE and the trainer) against flax + optax.

On ``synthetic_planetoid("cora", scale=0.08)``, with the flax parameters
carried over by ``convert.params_from_flax``, deterministic: log-probs and
every parameter gradient agree to 1e-4 and GAT-ODE's dopri5_scan stats are
equal; three Adam steps with dropout 0 land on the JAX trainer's
parameters to 1e-4.  JAX aggregates through the segment path, the port
through the GAT kernels' wrappers (their plain versions on the CPU).  The
tolerance is looser than the GCN slice's 1e-5: each forward runs 17
attention aggregations through an adaptive solver whose step sizes carry
the float32 rounding of the error estimate.
"""

import jax
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data import synthetic_planetoid as jsynthetic
from graph_odenet_tpu.models import GAT as JGAT
from graph_odenet_tpu.models import GATODE as JGATODE
from graph_odenet_tpu.models import ResGAT as JResGAT
from graph_odenet_tpu.train import NodeClassConfig as JConfig
from graph_odenet_tpu.train import fit_node_classifier as jfit
from graph_odenet_tpu.utils.metrics import masked_nll as jnll
from graph_odenet_tpu_torch.configs import get_config
from graph_odenet_tpu_torch.convert import params_from_flax
from graph_odenet_tpu_torch.data import synthetic_planetoid as tsynthetic
from graph_odenet_tpu_torch.models import GAT, GATODE, ResGAT
from graph_odenet_tpu_torch.ops import gat_attn, prepare
from graph_odenet_tpu_torch.train import NodeClassConfig, fit_node_classifier
from graph_odenet_tpu_torch.utils.metrics import masked_nll

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    return tsynthetic("cora", scale=0.08), jsynthetic("cora", scale=0.08)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


MODELS = {
    "gat": (lambda n_in, c: GAT(n_in, n_class=c), lambda c: JGAT(n_class=c)),
    "resgat": (lambda n_in, c: ResGAT(n_in, n_class=c), lambda c: JResGAT(n_class=c)),
    "gatode": (lambda n_in, c: GATODE(n_in, n_class=c), lambda c: JGATODE(n_class=c)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logprobs_and_gradients_match_flax(data, name):
    td, jd = data
    make_t, make_j = MODELS[name]
    jmodel = make_j(jd.n_class)
    jparams = jmodel.init(jax.random.PRNGKey(0), jd.graph, jd.features)["params"]

    def jloss(p):
        out, state = jmodel.apply(
            {"params": p}, jd.graph, jd.features, mutable=["intermediates"]
        )
        return jnll(out, jd.labels, jd.idx_train), (out, state)

    (jl, (jout, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    model = make_t(td.features.shape[1], td.n_class)
    model.load_state_dict(params_from_flax(_numpy_tree(jparams)))
    before = dict(gat_attn.launches)
    out = model(prepare(td.graph), td.features)
    loss = masked_nll(out, td.labels, td.idx_train)
    loss.backward()
    assert gat_attn.launches == before

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    expected = params_from_flax(_numpy_tree(jgrads))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(expected)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), expected[k].numpy(), err_msg=k, **TOL)
    if name == "gatode":
        (jstats,) = jstate["intermediates"]["ODEBlock_0"]["ode_stats"]
        stats = model.odeblock.stats
        for k in ("nfe", "n_accept", "n_reject", "success"):
            assert stats[k] == int(jstats[k]), k
        np.testing.assert_allclose(stats["t_reached"], float(jstats["t_reached"]), rtol=1e-4)
        assert stats["success"]


def test_three_adam_steps_match_jax_trainer(data):
    td, jd = data
    _, recipe = get_config(2)
    common = dict(
        model="gatode", hidden=recipe.hidden, heads=recipe.heads, method=recipe.method,
        steps=recipe.steps, rtol=recipe.rtol, atol=recipe.atol, lr=recipe.lr,
        epochs=3, dropout=0.0, patience=100, seed=7,
    )
    jcfg = JConfig(**common, representation="segment")
    jres = jfit(jcfg, jd)

    rng = jax.random.PRNGKey(jcfg.seed)
    _, init_rng = jax.random.split(rng)
    jparams0 = JGATODE(n_class=jd.n_class).init(
        {"params": init_rng}, jd.graph, jd.features, deterministic=True
    )["params"]
    tres = fit_node_classifier(
        NodeClassConfig(**common, representation="kernel"), td,
        init_state=params_from_flax(_numpy_tree(jparams0)), device="cpu",
    )

    assert tres["representation"] == "kernel" and tres["epochs_run"] == 3
    assert tres["best"]["epoch"] == jres["best"]["epoch"]
    assert tres["ode_stats"]["success"]
    for k in ("val_loss", "val_acc", "test_acc"):
        np.testing.assert_allclose(tres["best"][k], jres["best"][k], err_msg=k, **TOL)
    expected = params_from_flax(_numpy_tree(jres["params"]))
    assert sorted(tres["params"]) == sorted(expected)
    for k, v in tres["params"].items():
        np.testing.assert_allclose(v.numpy(), expected[k].numpy(), err_msg=k, **TOL)


def test_attention_dropout_draws_from_the_seed_generator(data):
    td, _ = data
    model = GATODE(td.features.shape[1], n_class=td.n_class,
                   generator=torch.Generator().manual_seed(0))
    csr = prepare(td.graph)

    def run(adj, seed):
        return model(adj, td.features, deterministic=False,
                     generator=torch.Generator().manual_seed(1),
                     seed_generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(csr, 1), run(csr, 1))
    torch.testing.assert_close(run(csr, 1), run(td.graph, 1), rtol=1e-4, atol=1e-4)
    assert not torch.allclose(run(csr, 1), run(csr, 2))
    with pytest.raises(ValueError, match="seed_generator"):
        model(csr, td.features, deterministic=False, generator=torch.Generator())
