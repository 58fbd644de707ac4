"""gnn_tpu_torch must run without JAX and without scikit-learn, pandas or
matplotlib (the card's machine has none of the last three): importing every
one of its modules loads none of them nor any gnn_tpu module. And its
set_weights keeps the optimizer's state, as gnn_tpu's does."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import gnn_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_gnn_tpu():
    names = ["gnn_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        gnn_tpu_torch.__path__, prefix="gnn_tpu_torch.")]
    for name in ("ops.fused", "ops.fused2", "ops.bn", "ops.typed", "ops.segment", "ops._build",
                 "models.core", "models.gnn", "models.composite", "graphs.typed",
                 "graphs.generator", "serving", "training.losses", "training.optimizers",
                 "metrics", "graphs.utils", "models.engine", "training.checkpoint",
                 "training.tb_events"):
        assert f"gnn_tpu_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'gnn_tpu', 'sklearn', 'pandas', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_set_weights_keeps_the_optimizer_state(tmp_path):
    """After an early stop both packages restore the best weights with
    set_weights, which leaves the optimizer alone: the Adam state gnn_tpu
    keeps is the port's too, and a second train() continues from it."""
    import jax
    import numpy as np

    from gnn_tpu.graphs.graph import Graph as JGraph
    from gnn_tpu_torch.convert import opt_state_to_jax
    from gnn_tpu_torch.graphs.graph import Graph as TGraph
    from test_torch_engine import (_data, _models, _split, same_history, same_opt_state,
                                   same_weights)

    js, ts = _data("g", seed=13)
    jm, tm = _models(tmp_path, bn=True)
    (jtr, jva, _), (ttr, tva, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    kw = dict(update_freq=1, max_fails=1, verbose=0)
    for m, tr, va in ((jm, jtr, jva), (tm, ttr, tva)):
        m.train(tr, 4, va, **kw)
    assert tm.history["Epoch"] == jm.history["Epoch"] == [0, 1]      # a validation stop
    leaves = {id(p) for p in jax.tree_util.tree_leaves(tm.params)}
    opt = tm._opt
    assert {id(p) for p in opt.param_groups[0]["params"]} == leaves
    got = opt_state_to_jax(opt, tm.params)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jm.opt_state)}
    assert int(got["[0].count"]) == 4
    same_opt_state(got, want)
    tm.set_weights(*tm.get_weights())
    assert opt_state_to_jax(tm._opt, tm.params)["[0].count"] == 4
    for m, tr, va in ((jm, jtr, jva), (tm, ttr, tva)):
        m.train(tr, 2, va, **kw)
    same_history(tm.history, jm.history)
    same_weights(tm, jm)
