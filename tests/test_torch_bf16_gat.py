"""Port parity: the attention models built with ``dtype=bfloat16`` against flax.

GAT, ResGAT and GAT-ODE, each with ``dtype=bfloat16`` and ``param_dtype``
float32 or bfloat16, deterministic, on ``synthetic_planetoid("cora",
scale=0.08)``: on the segment path (a ``Graph`` in both packages) and on
the kernel path (the port's ``CSRGraph``, whose GAT kernels run their plain
versions on the CPU, against JAX's ``PallasCSR`` in interpret mode).  The
checks and tolerances are those of ``tests/test_torch_bf16_models.py``:
dtypes leaf by leaf, log-probs and loss to ``rtol = atol = 2e-2``,
gradients to ``rtol = 2e-2`` and ``atol`` 2e-2 of the larger of 1 and the
leaf's largest entry.

The output dtype of an attention layer is its path's, in both packages:
float32 from the GAT kernels, bf16 from the segment path.  So GAT-ODE
integrates a float32 state on the kernel path and a bf16 one on the segment
path, which its dopri5_scan stats show (``t_reached`` float32 or bf16, and
the dynamics' state dtype).  In bf16 the error control (rtol 1e-3) sits
below bf16's epsilon (7.8e-3); the accepted and rejected step counts are
held equal to JAX's where both packages take the same steps (every case
here), and ``success`` is asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.models import GAT as JGAT
from graph_odenet_tpu.models import GATODE as JGATODE
from graph_odenet_tpu.models import ResGAT as JResGAT
from graph_odenet_tpu.utils.metrics import masked_nll as jnll
from graph_odenet_tpu_torch.convert import params_from_flax
from graph_odenet_tpu_torch.models import GAT, GATODE, ResGAT
from graph_odenet_tpu_torch.ops import gat_attn
from graph_odenet_tpu_torch.utils.metrics import masked_nll
from test_torch_bf16_models import (  # noqa: F401  (fixtures)
    BF, PARAM_DTYPES, TOL, adjacencies, assert_params_and_grads,
    assert_stats_match, data, numpy_tree, state_dtypes,
)

MODELS = {
    "gat": (lambda n_in, c, **kw: GAT(n_in, n_class=c, **kw),
            lambda c, **kw: JGAT(n_class=c, **kw)),
    "resgat": (lambda n_in, c, **kw: ResGAT(n_in, n_class=c, **kw),
               lambda c, **kw: JResGAT(n_class=c, **kw)),
    "gatode": (lambda n_in, c, **kw: GATODE(n_in, n_class=c, **kw),
               lambda c, **kw: JGATODE(n_class=c, **kw)),
}


@pytest.mark.parametrize("pdt", sorted(PARAM_DTYPES))
@pytest.mark.parametrize("rep", ["segment", "kernel"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_attention_models_bf16_match_flax(data, name, rep, pdt):
    td, jd = data
    tdt, jdt = PARAM_DTYPES[pdt]
    make_t, make_j = MODELS[name]
    adj, jadj = adjacencies(td, jd, rep)
    jmodel = make_j(jd.n_class, dtype=jnp.bfloat16, param_dtype=jdt)
    jparams = jmodel.init(jax.random.PRNGKey(0), jadj, jd.features)["params"]

    def jloss(p):
        out, state = jmodel.apply({"params": p}, jadj, jd.features, mutable=["intermediates"])
        return jnll(out, jd.labels, jd.idx_train), (out, state)

    (jl, (jout, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    model = make_t(td.features.shape[1], td.n_class, dtype=BF, param_dtype=tdt)
    model.load_state_dict(params_from_flax(numpy_tree(jparams)))
    seen = state_dtypes(model.odeblock) if name == "gatode" else []
    before = dict(gat_attn.launches)
    out = model(adj, td.features)
    loss = masked_nll(out, td.labels, td.idx_train)
    loss.backward()
    assert gat_attn.launches == before  # CPU tensors: the plain versions

    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert_params_and_grads(model, jparams, jgrads, params_from_flax)
    if name == "gatode":
        (jstats,) = jstate["intermediates"]["ODEBlock_0"]["ode_stats"]
        stats = model.odeblock.stats
        assert_stats_match(stats, jstats)
        state = torch.float32 if rep == "kernel" else BF
        assert set(seen) == {state}
        assert np.asarray(jstats["t_reached"]).dtype == (np.float32 if rep == "kernel" else
                                                         jnp.bfloat16)
        assert stats["success"] and bool(jstats["success"])
        for k in ("nfe", "n_accept", "n_reject"):
            assert stats[k] == int(jstats[k]), (k, stats[k], int(jstats[k]))
