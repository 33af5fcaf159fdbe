"""Command line of the port.

Counterpart of ``graph_odenet_tpu/cli.py``, with the same subcommands,
flags and defaults, plus ``--device`` on each (default ``cuda``; without a
card it raises, ``--device cpu`` runs on the CPU):

  node      citation-network node classification (configs 0–2)
              python -m graph_odenet_tpu_torch.cli node --model gcnode --dataset cora
  predict   restore the parameters ``node --ckpt-dir`` saved and evaluate
  physics   interaction-network n-body training + rollout eval (config 3)
              python -m graph_odenet_tpu_torch.cli physics --rollout 50
  config    run a canonical config by index or name
              python -m graph_odenet_tpu_torch.cli config 1
  bench     throughput benchmarks (spmm | gat | ode | ode_model | scaling)

``--representation`` takes ``dense|segment|kernel`` (``kernel``: the
hand-written CUDA kernels; their plain versions on the CPU).  Datasets
resolve to the real pygcn files when ``--data-path`` is given, else the
synthetic twins.  Each subcommand prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def _json_default(v):
    if torch.is_tensor(v):
        return v.item() if v.numel() == 1 else v.tolist()
    return float(v)


def _data(args, device):
    from graph_odenet_tpu_torch.data.planetoid import load_planetoid, synthetic_planetoid

    if args.data_path:
        data = load_planetoid(args.dataset, args.data_path)
    else:
        data = synthetic_planetoid(
            args.dataset, seed=args.seed, scale=args.scale, calibrated=args.calibrated,
        )
    return data.to(device)


def node_config(args):
    """The ``NodeClassConfig`` of ``node``'s parsed flags."""
    from graph_odenet_tpu_torch.train import NodeClassConfig

    return NodeClassConfig(
        model=args.model, hidden=args.hidden, heads=args.heads,
        dropout=args.dropout, t1=args.t1, method=args.method,
        steps=args.steps, rtol=args.rtol, atol=args.atol,
        adjoint=args.adjoint, lr=args.lr, weight_decay=args.weight_decay,
        epochs=args.epochs, patience=args.patience, seed=args.seed,
        representation=args.representation, log_path=args.log_path,
        echo=not args.quiet,
    )


def _node(args):
    from graph_odenet_tpu_torch.train import fit_node_classifier
    from graph_odenet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    res = fit_node_classifier(node_config(args), _data(args, device), device=device)
    if args.ckpt_dir:
        from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer

        ck = Checkpointer(args.ckpt_dir)
        ck.save(max(res["best"]["epoch"], 0), dict(params=res["params"]), wait=True)
        ck.close()
    print(json.dumps(dict(best=res["best"], epochs_run=res["epochs_run"],
                          seconds=round(res["seconds"], 2)), default=_json_default))


def _predict(args):
    """Restore trained parameters and evaluate: the inference path (the
    trainer's model-building code, parameters from the checkpoint)."""
    from graph_odenet_tpu_torch.train import (
        NodeClassConfig, adjacency, build_model, choose_representation,
    )
    from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer
    from graph_odenet_tpu_torch.utils.device import resolve_device
    from graph_odenet_tpu_torch.utils.metrics import masked_accuracy

    device = resolve_device(args.device)
    data = _data(args, device)
    cfg = NodeClassConfig(
        model=args.model, hidden=args.hidden, heads=args.heads,
        method=args.method, steps=args.steps,
    )
    model = build_model(cfg, data.n_class, data.features.shape[1]).to(device)
    adj = adjacency(data.graph, choose_representation(data.graph, cfg.model))
    ck = Checkpointer(args.ckpt_dir)
    model.load_state_dict(ck.restore(dict(params=model.state_dict()))["params"])
    ck.close()
    model.eval()
    with torch.no_grad():
        lp = model(adj, data.features, deterministic=True)
    print(json.dumps(dict(
        test_acc=float(masked_accuracy(lp, data.labels, data.idx_test)),
        val_acc=float(masked_accuracy(lp, data.labels, data.idx_val)),
        n_node=int(data.graph.n_node),
    )))


def _physics(args):
    from graph_odenet_tpu_torch.train.physics import (
        PhysicsConfig, fit_inode, fit_interaction_network, rollout_discrete, rollout_mse,
    )

    cfg = PhysicsConfig(
        n_bodies=args.n_bodies, n_sims=args.n_sims, n_steps=args.n_steps,
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed,
    )
    fit = fit_inode if args.ode else fit_interaction_network
    res = fit(cfg, device=args.device)
    out = {k: v for k, v in res.items() if isinstance(v, (int, float))}
    if args.rollout:
        trajs = res["trajs"][:8]
        with torch.no_grad():
            pred = rollout_discrete(res["forward"], res["system"], trajs[:, 0], args.rollout)
        out["rollout_mse"] = float(rollout_mse(pred, trajs[:, : args.rollout + 1]).mean())
    print(json.dumps(out))


def _config(args):
    from graph_odenet_tpu_torch.configs import run_config

    idx = int(args.index) if args.index.isdigit() else args.index
    res = run_config(idx, scale=args.scale, calibrated=args.calibrated, seed=args.seed,
                     rollout=args.rollout, device=args.device)
    res.pop("params", None)  # a state_dict: the JAX command prints no parameters
    print(json.dumps(res, default=_json_default))


def _bench(args):
    from graph_odenet_tpu_torch import bench

    fn = dict(spmm=bench.spmm_bench, gat=bench.gat_bench,
              ode=bench.ode_bench, ode_model=bench.ode_model_bench,
              scaling=bench.scaling_bench)[args.which]
    print(json.dumps(fn(device=args.device), default=float))


def _adjoint(v):
    return {"true": True, "false": False}.get(v.lower(), v)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="graph_odenet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def with_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
        return sp

    n = with_device(sub.add_parser("node", help="citation-network node classification"))
    n.add_argument("--dataset", default="cora", choices=["cora", "citeseer", "pubmed"])
    n.add_argument("--data-path", default=None,
                   help="dir with <name>.content/<name>.cites (else synthetic)")
    n.add_argument("--scale", type=float, default=1.0)
    n.add_argument("--model", default="gcn",
                   choices=["gcn", "resgcn", "gcnode", "gat", "resgat", "gatode"])
    n.add_argument("--hidden", type=int, default=16)
    n.add_argument("--heads", type=int, default=8)
    n.add_argument("--dropout", type=float, default=0.5)
    n.add_argument("--t1", type=float, default=1.0)
    n.add_argument("--method", default="rk4")
    n.add_argument("--steps", type=int, default=4)
    n.add_argument("--rtol", type=float, default=1e-3)
    n.add_argument("--atol", type=float, default=1e-4)
    n.add_argument("--adjoint", nargs="?", const=True, default=False, type=_adjoint,
                   help="true | checkpoint (checkpointed-forward adjoint) | false")
    n.add_argument("--lr", type=float, default=0.01)
    n.add_argument("--weight-decay", type=float, default=5e-4)
    n.add_argument("--epochs", type=int, default=200)
    n.add_argument("--patience", type=int, default=100)
    n.add_argument("--seed", type=int, default=42)
    n.add_argument("--representation", default=None,
                   choices=[None, "dense", "segment", "kernel"])
    n.add_argument("--log-path", default=None)
    n.add_argument("--calibrated", action="store_true",
                   help="difficulty-calibrated twin (GCN ~ published acc)")
    n.add_argument("--ckpt-dir", default=None, help="save best params for `predict`")
    n.add_argument("--quiet", action="store_true")
    n.set_defaults(fn=_node)

    pr = with_device(sub.add_parser(
        "predict", help="restore trained params and evaluate (inference)"))
    pr.add_argument("--ckpt-dir", required=True)
    pr.add_argument("--dataset", default="cora", choices=["cora", "citeseer", "pubmed"])
    pr.add_argument("--data-path", default=None)
    pr.add_argument("--scale", type=float, default=1.0)
    pr.add_argument("--calibrated", action="store_true")
    pr.add_argument("--model", default="gcn",
                    choices=["gcn", "resgcn", "gcnode", "gat", "resgat", "gatode"])
    pr.add_argument("--hidden", type=int, default=16)
    pr.add_argument("--heads", type=int, default=8)
    pr.add_argument("--method", default="rk4")
    pr.add_argument("--steps", type=int, default=4)
    pr.add_argument("--seed", type=int, default=42)
    pr.set_defaults(fn=_predict)

    ph = with_device(sub.add_parser("physics", help="n-body interaction network"))
    ph.add_argument("--ode", action="store_true", help="IN-ODE instead of discrete")
    ph.add_argument("--n-bodies", type=int, default=6)
    ph.add_argument("--n-sims", type=int, default=256)
    ph.add_argument("--n-steps", type=int, default=200)
    ph.add_argument("--lr", type=float, default=1e-3)
    ph.add_argument("--epochs", type=int, default=20)
    ph.add_argument("--batch-size", type=int, default=128)
    ph.add_argument("--seed", type=int, default=0)
    ph.add_argument("--rollout", type=int, default=0,
                    help="rollout horizon of the discrete IN for eval (0 = skip; the "
                         "IN-ODE's rollout: `config 3 --rollout N`)")
    ph.set_defaults(fn=_physics)

    c = with_device(sub.add_parser(
        "config", help="run canonical config (index 0-4 or a name like "
        "cora-gat; see configs.EXTRA_CONFIGS)"))
    c.add_argument("index")
    c.add_argument("--scale", type=float, default=1.0)
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--calibrated", action="store_true")
    c.add_argument("--rollout", type=int, default=0,
                   help="config 3: rollout-MSE horizon for the full "
                   "discrete-IN + IN-ODE deliverable (0 = train only)")
    c.set_defaults(fn=_config)

    b = with_device(sub.add_parser("bench", help="throughput benchmarks"))
    b.add_argument("which", choices=["spmm", "gat", "ode", "ode_model", "scaling"])
    b.set_defaults(fn=_bench)
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.cmd == "physics" and args.ode and args.rollout:
        p.error("--rollout rolls out the discrete IN; the IN-ODE's rollout is "
                "`config 3 --rollout N`")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
