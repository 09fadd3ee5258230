"""Tensor parallelism over a mesh's ``tp`` axis (the LSTM gate axis split
over devices, ``paule_tpu_torch.parallel.mesh``) against
``paule_tpu.parallel.mesh`` on the eight virtual CPU devices, in float64:
the mesh's grid and the column blocks of ``shard_lstm_params``; the
tp-split forward model and the two-layer embedder (the fused pair) with
their gradients; the three parts of the multi-chip dry run
(``__graft_entry__.dryrun_multichip``): the batched planning update, the
sharded training step and the corpus path; and the somatosensory variant
over tp against JAX and against tp=1."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from paule_tpu.models import EmbeddingModel as JEmbeddingModel
from paule_tpu.models import ForwardModel as JForwardModel
from paule_tpu.ops import losses as JL
from paule_tpu.parallel import batched as JB
from paule_tpu.parallel import mesh as JM
from paule_tpu.planning import engine as JEng
from paule_tpu_torch import experiments as TX
from paule_tpu_torch.api import Paule
from paule_tpu_torch.models.blocks import (LSTMLayer, TPLSTMLayer,
                                           init_random)
from paule_tpu_torch.models.embedder import EmbeddingModel
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.ops import lstm as LS
from paule_tpu_torch.ops import lstm_kernels as LK
from paule_tpu_torch.parallel import batched as TB
from paule_tpu_torch.parallel import mesh as TM
from paule_tpu_torch.planning.trainer import ModelTrainer
from paule_tpu_torch.release import load_into, params_from_jax
from test_torch_batched import _both, _compare_sub_losses
from test_torch_mesh import _close, _run, target_mels  # noqa: F401
from torch_parity import CP_ATOL, LOSS_RTOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the port against JAX, and tp=2 against tp=1, both float64
TOL = 1e-10
#: the planned trajectories of the dry run's first part against JAX
CP_TOL = 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
HIDDEN = 64


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(cls, seed, **kw):
    model = cls(hidden_size=HIDDEN, **kw)
    return model, model.init(jax.random.PRNGKey(seed), jnp.float64)


def _jax_sharded(mesh, params):
    """``params`` laid out as ``dryrun_multichip`` lays them out: the LSTM
    gate axes over ``tp``, the rest replicated."""
    out = {k: JM.replicate(mesh, v) for k, v in params.items()
           if k != "lstm"}
    out["lstm"] = JM.shard_lstm_params(mesh, params["lstm"])
    return out


def test_mesh_grid_is_jax_grid():
    """Row ``d`` of ``make_mesh(8, dp=4, tp=2)`` holds the devices JAX's
    mesh puts in row ``d``, in order; its first is the row's lead."""
    jmesh = JM.make_mesh(8, dp=4, tp=2)
    mesh = TM.make_mesh(8, dp=4, tp=2,
                        devices=[torch.device("cpu", i) for i in range(8)])
    want = [[f"cpu:{d.id}" for d in row] for row in jmesh.devices]
    assert want == [["cpu:0", "cpu:1"], ["cpu:2", "cpu:3"],
                    ["cpu:4", "cpu:5"], ["cpu:6", "cpu:7"]]
    assert [[str(d) for d in mesh.row(r)] for r in range(4)] == want
    assert [str(d) for d in mesh.leads] == [row[0] for row in want]
    assert TM.lstm_param_spec() == {
        k: tuple(v) for k, v in JM.lstm_param_spec().items()}


def test_shard_layout_is_jax_layout():
    """Every column block of ``shard_lstm_params`` on dp=4 tp=2 (two
    layers) equals the shard JAX places on the same grid position, and
    covers the same columns: tp=2 gives the first device gates i, f and
    the second g, o."""
    jmesh = JM.make_mesh(8, dp=4, tp=2)
    _model, params = _jax_model(JForwardModel, 0, num_lstm_layers=2)
    layers = [{k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
              for layer in params["lstm"]]
    out = TM.shard_lstm_params(TM.make_mesh(devices=["cpu"] * 8, dp=4,
                                            tp=2), layers)
    grid = {d.id: tuple(np.argwhere(jmesh.devices == d)[0])
            for d in jmesh.devices.flat}
    n_checked = 0
    for li, layer in enumerate(JM.shard_lstm_params(jmesh, params["lstm"])):
        for key, arr in layer.items():
            for shard in arr.addressable_shards:
                d, t = grid[shard.device.id]
                block = out[d][li][t][key]
                cols = shard.index[-1]
                assert (cols.start, cols.stop) == (
                    t * 2 * HIDDEN, (t + 1) * 2 * HIDDEN)
                np.testing.assert_array_equal(block.numpy(),
                                              np.asarray(shard.data))
                np.testing.assert_array_equal(
                    block.numpy(), layers[li][key][..., cols].numpy())
                n_checked += 1
    assert n_checked == 2 * 3 * 8


def test_tp_that_does_not_divide_the_gate_axis_raises():
    """tp=3 against a gate axis of 4H=256, on both sides."""
    _model, params = _jax_model(JForwardModel, 0, num_lstm_layers=1)
    with pytest.raises(ValueError):
        JM.shard_lstm_params(JM.make_mesh(6, dp=2, tp=3), params["lstm"])
    layers = [{k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
              for layer in params["lstm"]]
    mesh = TM.make_mesh(devices=["cpu"] * 6, dp=2, tp=3)
    with pytest.raises(ValueError, match="tp=3"):
        TM.shard_lstm_params(mesh, layers)
    model = load_into(ForwardModel(num_lstm_layers=1, hidden_size=HIDDEN),
                      _np_tree(params), **F64)
    with pytest.raises(ValueError, match="tp=3"):
        TM.replicate(mesh, model)


def _port_apply(mesh, model, x, cot, lens=None):
    """``model`` replicated over ``mesh``, ``x`` split over dp: -> the
    joined output, the gradient of ``sum(out * cot)`` to ``x`` and the
    replicas' weight gradients reduced into ``model``'s layout
    (``reduce_grads``)."""
    replicas = TM.replicate(mesh, model)
    assert all(isinstance(layer, TPLSTMLayer)
               for rep in replicas for layer in rep.lstm)
    assert model.lstm[0].__class__ is LSTMLayer
    xt = torch.tensor(x, requires_grad=True)
    args = [(xs,) if lens is None else (xs, ls) for xs, ls in zip(
        TM.shard_batch(mesh, xt),
        [None] * len(replicas) if lens is None
        else TM.shard_batch(mesh, torch.as_tensor(lens)))]
    out = torch.cat([rep(*a) for rep, a in zip(replicas, args)])
    (out * torch.tensor(cot)).sum().backward()
    TM.reduce_grads(model, replicas)
    return out.detach().numpy(), xt.grad.numpy(), {
        n: p.grad for n, p in model.named_parameters()}


def _compare_grads(port, ref):
    ref = params_from_jax(_np_tree(ref))
    assert sorted(port) == sorted(ref)
    for name, g in port.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=0,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["forward", "embedder"])
def test_tp_split_model_matches_jax(kind):
    """``tests/test_parallel.py:91-103`` with gradients: the model with its
    LSTM layers split over dp=4 x tp=2 of eight listed CPUs against JAX's
    ``jax.jit`` of the model on the same layout of the virtual devices:
    output and the gradients to the input and every weight.  ``forward``:
    one layer (B1/B2 per layer); ``embedder``: two layers, the fused pair
    (B3/B4) on the gathered weights."""
    jmesh = JM.make_mesh(8, dp=4, tp=2)
    rng = np.random.default_rng(1)
    if kind == "forward":
        jmodel, params = _jax_model(JForwardModel, 0, num_lstm_layers=1)
        port = ForwardModel(num_lstm_layers=1, hidden_size=HIDDEN)
        x = rng.normal(0, 0.3, (4, 10, 30))
        cot = rng.normal(size=(4, 5, 60))
        lens = None
    else:
        jmodel, params = _jax_model(JEmbeddingModel, 2, num_lstm_layers=2)
        port = EmbeddingModel(num_lstm_layers=2, hidden_size=HIDDEN)
        x = rng.normal(0, 0.3, (4, 9, 60))
        cot = rng.normal(size=(4, 300))
        lens = np.array([9, 7, 9, 5])
    load_into(port, _np_tree(params), **F64)

    def loss(p, xs):
        return jnp.sum(jmodel.apply(p, xs, lens) * cot)

    sharded = _jax_sharded(jmesh, params)
    xs = JM.shard_batch(jmesh, jnp.asarray(x))
    want = jax.jit(lambda p, xs: jmodel.apply(p, xs, lens))(sharded, xs)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(sharded, xs)

    mesh = TM.make_mesh(devices=["cpu"] * 8, dp=4, tp=2)
    out, dx, grads = _port_apply(mesh, port, x, cot, lens)
    np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(dx, np.asarray(gx), rtol=0, atol=TOL)
    _compare_grads(grads, gp)


def _edges_to(leaf, root):
    """How many edges of the autograd graph under ``root`` lead into the
    leaf tensor ``leaf``: the number of gradient parts summed into it."""
    seen, stack, n = set(), [root], 0
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            n += getattr(nxt, "variable", None) is leaf
            stack.append(nxt)
    return n


def test_split_layer_runs_one_recurrence_per_call(monkeypatch):
    """A split layer's forward runs the forward recurrence once and its
    backward the reverse recurrence once, on the joined blocks (never once
    per block), as one autograd node, so the input's gradient comes in
    one part (summed over the blocks in block order, whichever device
    each block is on); the gate blocks and ``w_hh`` are gathered, B2's
    gradient of the gates handed back, ``x`` and the hidden states copied
    to each of the 4 blocks and each block's part of ``x``'s gradient
    brought back: 2 * (T*B*4H) + H*4H + 4 * (2 * B*T*in + T*B*H)
    floats."""
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = LS.lstm_fwd, LK.lstm_bwd

    def fwd(gates_x, w_hh, h0, c0):
        calls["fwd"].append(tuple(w_hh.shape))
        return real_fwd(gates_x, w_hh, h0, c0)

    def bwd(acts, cs_prev, ghs, w_hh, model=None):
        calls["bwd"].append(tuple(w_hh.shape))
        return real_bwd(acts, cs_prev, ghs, w_hh, model)

    monkeypatch.setattr(LS, "lstm_fwd", fwd)
    monkeypatch.setattr(LK, "lstm_bwd", bwd)
    model = init_random(ForwardModel(num_lstm_layers=1, hidden_size=16),
                        torch.Generator().manual_seed(0)).double()
    mesh = TM.make_mesh(devices=["cpu"] * 4, dp=1, tp=4)
    (rep,) = TM.replicate(mesh, model)
    layer = rep.lstm[0]
    assert [c.stop - c.start for c in layer.columns()] == [16] * 4
    torch.testing.assert_close(torch.cat(list(layer.w_hh), -1),
                               model.lstm[0].w_hh, rtol=0, atol=0)
    x = torch.randn((3, 6, 30), dtype=torch.float64, requires_grad=True)
    LS.gather.bytes = 0
    out = rep(x)
    assert _edges_to(x, out.grad_fn) == 1
    out.sum().backward()
    assert calls == {"fwd": [(16, 64)], "bwd": [(16, 64)]}
    assert LS.gather.bytes == 8 * (2 * 6 * 3 * 64 + 16 * 64
                                   + 4 * 2 * 3 * 6 * 30 + 4 * 6 * 3 * 16)
    assert all(w.grad.shape == (16, 16) for w in layer.w_hh)


def test_dryrun_planning_update_matches_jax(target_mels):  # noqa: F811
    """Dry run part 1 (``__graft_entry__.py:106-145``): ``plan_batch`` on
    dp=2 x tp=2 with the dry run's models (a one-layer forward model and
    embedder at H=64, loaded from JAX's initialisation) against JAX's
    ``plan_segment_batched`` on ``make_mesh(4, dp=2, tp=2)`` with the
    forward model's LSTM split over tp, from the same trajectories: the
    planned cp and every step's sub-losses."""
    jmesh = JM.make_mesh(4, dp=2, tp=2)
    jpred, pred_params = _jax_model(JForwardModel, 0, num_lstm_layers=1)
    jemb, emb_params = _jax_model(JEmbeddingModel, 1, num_lstm_layers=1)
    tsem = np.random.default_rng(3).normal(size=(4, 300)) * 0.3
    port = Paule(seed=7, **F64)
    try:
        port.pred_model = load_into(
            ForwardModel(num_lstm_layers=1, hidden_size=HIDDEN),
            _np_tree(pred_params), **F64).requires_grad_(False)
        port.embedder = load_into(
            EmbeddingModel(num_lstm_layers=1, hidden_size=HIDDEN),
            _np_tree(emb_params), **F64).requires_grad_(False)
        with torch.no_grad():
            xx0 = port.inv_model(torch.tensor(target_mels)).clamp(-1, 1)
        out = TB.plan_batch(port, target_mels, tsem, n_steps=3,
                            objective="acoustic_semvec", synthesize=False,
                            mesh=TM.make_mesh(devices=["cpu"] * 4, dp=2,
                                              tp=2))
    finally:
        port.close()

    bundle = JEng.ModelBundle(
        pred_model=jpred, pred_params=_jax_sharded(jmesh, pred_params),
        embedder=jemb, embedder_params=JM.replicate(jmesh, emb_params))
    dyn, static = JEng.split_bundle(bundle)
    xx = JM.shard_batch(jmesh, jnp.asarray(xx0.numpy()))
    xx_out, _opt, logs = JB.plan_segment_batched(
        dyn, static, xx, JB.init_batched_opt_state(xx, 0.01),
        JM.shard_batch(jmesh, jnp.asarray(target_mels)),
        JM.shard_batch(jmesh, jnp.asarray(tsem)), jax.random.PRNGKey(1),
        n_steps=3, objective="acoustic_semvec", use_speech_classifier=False,
        use_somatosensory=False, log_semantics=False,
        constraints=JEng.Constraints(), lr=0.01)
    np.testing.assert_allclose(out["planned_cp"], np.asarray(xx_out),
                               rtol=0, atol=CP_TOL)
    for field in out["sub_losses"]._fields:
        np.testing.assert_allclose(
            getattr(out["sub_losses"], field),
            np.asarray(getattr(logs["sub_losses"], field)),
            rtol=LOSS_RTOL, atol=1e-12, err_msg=field)


def test_dryrun_train_step_matches_jax():
    """Dry run part 2 (``__graft_entry__.py:150-169``): two Adam steps of
    ``train_batch(replicas=)`` over dp=2 x tp=2, the replicas synced after
    each, against JAX's jitted train step on the forward model's LSTM
    split over tp: losses and the new weights; the replicas' blocks then
    hold the new weights' columns."""
    jmesh = JM.make_mesh(4, dp=2, tp=2)
    jmodel, params = _jax_model(JForwardModel, 0, num_lstm_layers=1)
    optimizer = optax.adam(1e-3)

    @jax.jit
    def train_step(p, opt_state, batch_in, batch_out):
        def loss_fn(p):
            return JL.rmse(jmodel.apply(p, batch_in), batch_out)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = optimizer.update(grads, opt_state)
        return optax.apply_updates(p, updates), opt_state, loss

    trainer = ModelTrainer(load_into(
        ForwardModel(num_lstm_layers=1, hidden_size=HIDDEN),
        _np_tree(params), **F64), loss="rmse", learning_rate=1e-3)
    mesh = TM.make_mesh(devices=["cpu"] * 4, dp=2, tp=2)
    replicas = TM.replicate(mesh, trainer.model)
    jparams = _jax_sharded(jmesh, params)
    opt_state = optimizer.init(jparams)
    bspec = NamedSharding(jmesh, P("dp", None, None))
    rng = np.random.default_rng(4)
    for _ in range(2):
        b_in = rng.uniform(-1, 1, (4, 16, 30))
        b_out = rng.normal(size=(4, 8, 60))
        jparams, opt_state, jloss = train_step(
            jparams, opt_state, jax.device_put(jnp.asarray(b_in), bspec),
            jax.device_put(jnp.asarray(b_out), bspec))
        loss = trainer.train_batch(
            TM.shard_batch(mesh, torch.tensor(b_in)),
            TM.shard_batch(mesh, torch.tensor(b_out)), replicas=replicas)
        TM.sync_replicas(trainer.model, replicas)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=0,
                                   atol=TOL)
    ref = params_from_jax(_np_tree(jparams))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=TOL, err_msg=name)
    for rep in replicas:
        for p, q, cols in TM.param_pairs(trainer.model, rep):
            assert torch.equal(q, p if cols is None else p[..., cols])


def test_dryrun_corpus_path_tp2_equals_tp1(target_mels):  # noqa: F811
    """Dry run part 3: ``plan_corpus_batched`` of four utterances with
    continue-learning (training batches of 2, split over dp) on dp=2 x
    tp=2 against dp=2 x tp=1: every result and the trained forward
    model's weights."""
    kw = dict(max_batch=4, verbose=False, plan_kwargs=dict(
        n_outer=2, n_inner=2, continue_learning=True, n_epochs=1,
        batch_size=2))
    out, models = {}, {}
    for tp in (1, 2):
        mesh = TM.make_mesh(devices=["cpu"] * 2 * tp, dp=2, tp=tp)
        out[tp], port = _run(
            lambda p, mels, mesh: TX.plan_corpus_batched(
                p, list(mels), mesh=mesh, **kw), target_mels, mesh)
        models[tp] = port.pred_model
        assert port.pred_trainer.steps == 4
    for a, b in zip(out[2], out[1]):
        _close(a, b, TOL)
    for a, b in zip(models[2].parameters(), models[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=TOL)


def test_somatosensory_tp2_equals_tp1(target_mels):  # noqa: F811
    """The somatosensory variant with continue-learning of the tube models
    on dp=2 x tp=2 against dp=2 x tp=1: the tube embedder's two layers
    split over tp run one at a time under its dropout (0.7), the masks of
    the whole batch drawn as one device draws them and split; the cp->tube
    and tube->mel models train split."""
    init = {"use_somatosensory_feedback": True}
    kw = dict(n_outer=2, n_inner=2, objective="acoustic_semvec",
              continue_learning=True, continue_learning_tube=True,
              n_epochs=1, batch_size=2)
    out = {tp: _run(TB.plan_batch_resynth, target_mels,
                    TM.make_mesh(devices=["cpu"] * 2 * tp, dp=2, tp=tp),
                    init, **kw)[0] for tp in (1, 2)}
    assert len(out[2]["tube_model_loss"]) == 4
    _close(out[2], out[1], TOL)


def test_somatosensory_tp2_matches_jax(target_mels):  # noqa: F811
    """The somatosensory variant with continue-learning of the tube models
    on dp=2 x tp=2 against JAX's ``plan_batch_resynth`` on ``make_mesh(4,
    dp=2, tp=2)`` with every model's LSTM split over tp
    (``shard_lstm_params``), at ``tests/test_torch_batched.py``'s
    tolerances.  The tube embedders' dropout is 0 on both sides, as
    there (the two draw their masks from different generators); the
    split layers under dropout are held by
    :func:`test_somatosensory_tp2_equals_tp1`."""
    jmesh = JM.make_mesh(4, dp=2, tp=2)
    jpaule, port = _both({"use_somatosensory_feedback": True})
    for trainer in (jpaule.pred_trainer, jpaule.inv_trainer,
                    jpaule.tube_trainer, jpaule.tube_mel_trainer):
        trainer.params = _jax_sharded(jmesh, trainer.params)
    jpaule.embedder_params = _jax_sharded(jmesh, jpaule.embedder_params)
    jpaule.tube_embedder_params = _jax_sharded(
        jmesh, jpaule.tube_embedder_params)
    w_hh = jpaule.tube_trainer.params["lstm"][0]["w_hh"]
    assert w_hh.sharding.spec == P(None, "tp")
    kw = dict(n_outer=2, n_inner=2, objective="acoustic_semvec",
              continue_learning=True, continue_learning_tube=True,
              n_epochs=1, batch_size=2)
    ref = JB.plan_batch_resynth(jpaule, target_mels, mesh=jmesh, **kw)
    try:
        out = TB.plan_batch_resynth(
            port, target_mels,
            mesh=TM.make_mesh(devices=["cpu"] * 4, dp=2, tp=2), **kw)
    finally:
        port.close()
    assert sorted(out) == sorted(ref)
    for key in ("planned_cp", "prod_tubes", "prod_mels"):
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=CP_ATOL,
                                   err_msg=key)
    for key in out:
        if key.endswith("_curve") or key.endswith("model_loss"):
            np.testing.assert_allclose(out[key], np.asarray(ref[key]),
                                       rtol=LOSS_RTOL, atol=0, err_msg=key)
    _compare_sub_losses(out["sub_losses"], ref["sub_losses"])
    assert len(out["tube_model_loss"]) == 4

