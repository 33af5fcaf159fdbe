"""Port parity: the slice (GCN family and the trainer) against flax + optax.

On ``synthetic_planetoid("cora", scale=0.08)``, with the flax parameters
carried over by ``convert.params_from_flax``: log-probs and every parameter
gradient agree to 1e-5, and three Adam steps with dropout 0 land on the JAX
trainer's parameters to 1e-5.  JAX aggregates through the segment path;
the port through the CSR kernel's wrapper (its plain version on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data import synthetic_planetoid as jsynthetic
from graph_odenet_tpu.models import GCN as JGCN
from graph_odenet_tpu.models import GCNODE as JGCNODE
from graph_odenet_tpu.models import ResGCN as JResGCN
from graph_odenet_tpu.train import NodeClassConfig as JConfig
from graph_odenet_tpu.train import fit_node_classifier as jfit
from graph_odenet_tpu.utils.metrics import masked_nll as jnll
from graph_odenet_tpu_torch.convert import params_from_flax
from graph_odenet_tpu_torch.data import synthetic_planetoid as tsynthetic
from graph_odenet_tpu_torch.models import GCN, GCNODE, ResGCN
from graph_odenet_tpu_torch.ops import prepare
from graph_odenet_tpu_torch.train import NodeClassConfig, fit_node_classifier
from graph_odenet_tpu_torch.utils.metrics import masked_nll

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    return tsynthetic("cora", scale=0.08), jsynthetic("cora", scale=0.08)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


MODELS = {
    "gcn": (lambda n_in, c: GCN(n_in, hidden=16, n_class=c), lambda c: JGCN(hidden=16, n_class=c)),
    "resgcn": (
        lambda n_in, c: ResGCN(n_in, hidden=16, n_class=c, n_blocks=2),
        lambda c: JResGCN(hidden=16, n_class=c, n_blocks=2),
    ),
    "gcnode": (
        lambda n_in, c: GCNODE(n_in, hidden=16, n_class=c, method="rk4", steps=4),
        lambda c: JGCNODE(hidden=16, n_class=c, method="rk4", steps=4),
    ),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logprobs_and_gradients_match_flax(data, name):
    td, jd = data
    make_t, make_j = MODELS[name]
    jmodel = make_j(jd.n_class)
    jparams = jmodel.init(jax.random.PRNGKey(0), jd.graph, jd.features)["params"]

    def jloss(p):
        out = jmodel.apply({"params": p}, jd.graph, jd.features)
        return jnll(out, jd.labels, jd.idx_train), out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    model = make_t(td.features.shape[1], td.n_class)
    model.load_state_dict(params_from_flax(_numpy_tree(jparams)))
    out = model(prepare(td.graph), td.features)
    loss = masked_nll(out, td.labels, td.idx_train)
    loss.backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    expected = params_from_flax(_numpy_tree(jgrads))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(expected)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), expected[k].numpy(), err_msg=k, **TOL)
    if name == "gcnode":
        assert model.odeblock.stats == {"nfe": 16}


def test_three_adam_steps_match_jax_trainer(data):
    td, jd = data
    common = dict(model="gcnode", epochs=3, dropout=0.0, patience=100, seed=7)
    jcfg = JConfig(**common, representation="segment")
    jres = jfit(jcfg, jd)

    # The JAX trainer's own initialisation, reproduced and carried over.
    rng = jax.random.PRNGKey(jcfg.seed)
    _, init_rng = jax.random.split(rng)
    jparams0 = JGCNODE(hidden=16, n_class=jd.n_class).init(
        {"params": init_rng}, jd.graph, jd.features, deterministic=True
    )["params"]
    tres = fit_node_classifier(
        NodeClassConfig(**common, representation="kernel"), td,
        init_state=params_from_flax(_numpy_tree(jparams0)), device="cpu",
    )

    assert tres["representation"] == "kernel" and tres["epochs_run"] == 3
    assert tres["best"]["epoch"] == jres["best"]["epoch"]
    for k in ("val_loss", "val_acc", "test_acc"):
        np.testing.assert_allclose(tres["best"][k], jres["best"][k], err_msg=k, **TOL)
    expected = params_from_flax(_numpy_tree(jres["params"]))
    assert sorted(tres["params"]) == sorted(expected)
    for k, v in tres["params"].items():
        np.testing.assert_allclose(v.numpy(), expected[k].numpy(), err_msg=k, **TOL)


def test_dropout_draws_from_the_given_generator(data):
    td, _ = data
    model = GCNODE(td.features.shape[1], n_class=td.n_class, generator=torch.Generator().manual_seed(0))
    adj = td.graph

    def run(seed):
        return model(adj, td.features, deterministic=False, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        model(adj, td.features, deterministic=False)


def test_remat_gives_the_same_gradients(data):
    td, _ = data
    grads = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(0)
        model = GCNODE(td.features.shape[1], n_class=td.n_class, remat=remat, generator=gen)
        masked_nll(model(td.graph, td.features), td.labels, td.idx_train).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("adjoint", [True, "checkpoint"])
def test_adjoint_is_not_ported_yet(adjoint):
    with pytest.raises(NotImplementedError, match="A13"):
        GCNODE(8, adjoint=adjoint)
