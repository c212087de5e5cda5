"""The port's SSL training against the JAX package's: the schedules and the
optimizer chain optax supplies (state, layout, clipping), the models' train
mode (BatchNorm's biased running variance, flax's dropout masks), three
steps of ``create_ssl_train_step``, the checkpoints both ways, the loops
and ``classifier.pipeline.main(train=True)`` on both branches.

Sizes: ``effnetv2_tiny`` (embedding 32, head 32 -> 16), 48x48 views, batch
4. Weights cross through ``models/convert.py``: the port's seeded weights
go to the JAX tree (the JAX side never runs flax's ``init``).

Tolerances, and why:
- schedules equal to optax's evaluated op by op in the linear warmup;
  within 1 ulp where a cosine is taken (XLA's float32 cosine is not
  correctly rounded: 39 of 3,090 arguments on [0, pi] differ from the
  rounded float64 cosine the port takes); under ``jax.jit`` XLA fuses the
  schedule's arithmetic (held within 1e-5 relative);
- optimizer parameters, ``mu`` and ``nu`` within 1e-6 relative after 5
  steps (measured about 1.2e-7: optax sums the squared norm and fuses
  under jit in its own order); ``count`` exact;
- train-mode backbone embedding within 1e-5; the predictor's output within
  5e-5 at batch 4: its BatchNorm normalises over 4 rows, which amplifies
  float32 order differences (measured 3.1e-5 on outputs of magnitude 2.2);
  running statistics after both views within 1e-6;
- dropout masks equal to flax's;
- three train steps (lr 0 at step 0), at the shipped config's lr (1e-5)
  and at 1e-3: loss within 1e-5 relative (measured 6.8e-6: the
  predictor's batch-4 BatchNorm again), running statistics within 1e-5
  (1e-4 at lr 1e-3, below);
  Adam's ``mu`` and ``nu`` after every step (the gradients of the
  two-view backward through flax's dropout masks) within 2e-3 of each
  leaf's largest value (measured 8.1e-4 after step 0), or of 1e-2 of the
  tree's largest where that is more: a bias that a BatchNorm follows has
  a gradient of 0 up to rounding (1e-10 to 1e-8 against 1e-3 elsewhere),
  so only its size is held; the parameters' moves from the start,
  ``||d_port - d_jax|| / ||d_jax||``, within 1e-2 (measured 4.7e-3 at
  both lrs, so rounding is not what it sees), and every element within
  ``2 lr + 1e-6``. Adam's first moves are about +-lr whatever the
  gradient's size, so an element whose gradient is near 0 can move the
  other way when the two packages sum its gradient in another order: 4
  or 5 of 294,048 elements move more than lr / 2 apart, and they make
  most of the relative norm.
"""

import functools

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as fnn

from multimodal_biometric_fingerprints_palms_tpu.models import SSLModel as JSSL
from multimodal_biometric_fingerprints_palms_tpu.models.projection_head import (
    ProjectionHead as JHead)
from multimodal_biometric_fingerprints_palms_tpu.train import ssl_train as JT
from multimodal_biometric_fingerprints_palms_tpu.train.schedule import (
    cosine_warmup_schedule as j_schedule)
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    SSLModel, load_jax_variables, seed_weights, ssl_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.models.convert import (
    params_list_of, params_tree_of)
from multimodal_biometric_fingerprints_palms_tpu_torch.models.projection_head import (
    ProjectionHead, flax_dropout)
from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
    schedule as TS, ssl_train as TT)
from multimodal_biometric_fingerprints_palms_tpu_torch.train.optim import (
    ClipAdamW)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
    load_msgpack)

torch.set_num_threads(1)

TINY = dict(backbone_name="effnetv2_tiny", embedding_dim=32,
            proj_hidden_dim=32, proj_output_dim=16)
B, S = 4, 48
LR = 1e-5                     # configs/config_classifier.yml ssl.training.lr


def tree_max_rel(a, b) -> float:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()
                     / max(np.abs(np.asarray(x)).max(), 1e-30))
               for x, y in zip(la, lb))


def tree_max_abs(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def port_model(seed=3):
    """The tiny model with seeded weights and BatchNorm statistics that
    are not the identity."""
    m = seed_weights(SSLModel(**TINY), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape,
                                                         generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape,
                                                       generator=g))
    return m


def views(seed, n=B):
    g = np.random.default_rng(seed)
    return tuple(g.random((n, S, S), np.float32) for _ in range(2))


# --- schedules ------------------------------------------------------------

SCHEDULES = [(1e-5, 5, 3), (1e-3, 2, 30), (1e-3, 10, 100), (3e-4, 1, 7),
             (1e-5, 15, 15)]


@pytest.mark.parametrize("lr,warmup,total", SCHEDULES)
def test_warmup_cosine_schedule_matches_optax(lr, warmup, total):
    """Every step 0 .. total + 20 (warmup >= total included: the shipped
    config's 3 epochs under 5 warmup epochs); step 0 is 0."""
    j, t = j_schedule(lr, warmup, total), TS.cosine_warmup_schedule(
        lr, warmup, total)
    jj = jax.jit(j)
    assert t(0) == 0.0
    for c in range(total + 21):
        want = np.float32(j(jnp.int32(c)))
        if c < max(1, warmup):
            assert want == t(c), c
        np.testing.assert_array_max_ulp(t(c), want, maxulp=1)
        np.testing.assert_allclose(t(c), np.float32(jj(jnp.int32(c))),
                                   rtol=0, atol=1e-5 * lr)


@pytest.mark.parametrize("n,lr", [(10, 1.5e-4), (57, 1e-3), (4, 2e-4),
                                  (300, 1.5e-4)])
def test_onecycle_schedule_matches_optax(n, lr):
    j = optax.cosine_onecycle_schedule(n, lr, 0.3, 25.0, 1e4)
    t = TS.cosine_onecycle_schedule(n, lr, 0.3, 25.0, 1e4)
    jj = jax.jit(j)
    for c in range(n + 6):
        np.testing.assert_array_max_ulp(t(c), np.float32(j(jnp.int32(c))),
                                        maxulp=1)
        np.testing.assert_allclose(t(c), np.float32(jj(jnp.int32(c))),
                                   rtol=0, atol=1e-5 * lr)


# --- the optimizer ----------------------------------------------------------

SHAPES = [(3, 4), (5,), (2, 2, 3)]


def _optax_pair(kind):
    if kind == "ssl":
        return (optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
                    j_schedule(1e-3, 2, 5), weight_decay=1e-4)),
                ClipAdamW(1.0, TS.cosine_warmup_schedule(1e-3, 2, 5), 1e-4))
    if kind == "plateau":
        return (optax.chain(optax.clip_by_global_norm(1.0),
                            optax.inject_hyperparams(optax.adamw)(
                                learning_rate=1.5e-4, weight_decay=5e-4)),
                ClipAdamW(1.0, 1.5e-4, 5e-4, inject=True))
    sched = dict(transition_steps=10, peak_value=1.5e-4, pct_start=0.3,
                 div_factor=25.0, final_div_factor=1e4)
    return (optax.chain(optax.clip_by_global_norm(1.0),
                        optax.inject_hyperparams(optax.adamw)(
                            learning_rate=optax.cosine_onecycle_schedule(**sched),
                            weight_decay=5e-4)),
            ClipAdamW(1.0, TS.cosine_onecycle_schedule(**sched), 5e-4,
                      inject=True))


def _adam(kind, js):
    return js[1][0] if kind == "ssl" else js[1].inner_state[0]


@pytest.mark.parametrize("kind", ["ssl", "plateau", "onecycle"])
@pytest.mark.parametrize("scales", [(0.1, 0.2, 5.0, 0.01, 1.0),
                                    (0.001, 0.002, 0.003, 0.004, 0.005)])
def test_optimizer_matches_optax_chain(kind, scales):
    """5 steps; gradients both under and over the clip."""
    g = np.random.default_rng(0)
    p0 = [g.standard_normal(s).astype(np.float32) for s in SHAPES]
    jtx, ttx = _optax_pair(kind)
    jp = [jnp.asarray(p) for p in p0]
    js = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ts = ttx.init(tp)
    upd = jax.jit(jtx.update)
    for sc in scales:
        gr = [g.standard_normal(s).astype(np.float32) * sc for s in SHAPES]
        u, js = upd([jnp.asarray(x) for x in gr], js, jp)
        jp = optax.apply_updates(jp, u)
        ttx.step(tp, [torch.from_numpy(x) for x in gr], ts)
    adam = _adam(kind, js)
    assert int(adam.count) == ts.count == 5
    assert tree_max_rel(jp, [t.numpy() for t in tp]) <= 1e-6
    assert tree_max_rel(adam.mu, [t.numpy() for t in ts.mu]) <= 1e-6
    assert tree_max_rel(adam.nu, [t.numpy() for t in ts.nu]) <= 1e-6
    if kind != "ssl":
        assert int(js[1].count) == ts.inject_count
        assert np.float32(js[1].hyperparams["learning_rate"]) == \
            ts.hyperparams["learning_rate"]


@pytest.mark.parametrize("over", [False, True])
def test_clip_at_the_max_norm(over):
    """A gradient of norm just under 1 passes untouched; just over, it is
    scaled to norm 1 as optax scales it (``(g / norm) * 1``)."""
    g = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    g = g / np.linalg.norm(g) * np.float32(1.0001 if over else 0.9999)
    jtx = optax.clip_by_global_norm(1.0)
    want, _ = jtx.update([jnp.asarray(g)], jtx.init([jnp.asarray(g)]))
    # the port's clip, seen through an SGD-like chain: b1 = 0 keeps mu = g
    ttx = ClipAdamW(1.0, 1.0, 0.0, b1=0.0)
    st = ttx.init([torch.zeros(16)])
    ttx.step([torch.zeros(16)], [torch.from_numpy(g)], st)
    np.testing.assert_allclose(st.mu[0].numpy(), np.asarray(want[0]),
                               rtol=1e-7, atol=0)
    assert (np.linalg.norm(st.mu[0].numpy()) <= 1.0 + 1e-6) and (
        over or np.array_equal(st.mu[0].numpy(), g))


@pytest.mark.parametrize("kind", ["plateau", "onecycle"])
def test_optimizer_state_crosses_flax_layout(kind):
    """The injected chain's state, written as flax writes it, restores
    into optax's own template, and optax's restores into the port's."""
    jtx, ttx = _optax_pair(kind)
    model = port_model()
    params = list(model.parameters())
    ts = ttx.init(params)
    grads = [torch.randn_like(p) * 0.01 for p in params]
    for _ in range(2):
        ttx.step(params, grads, ts)
    ts.hyperparams["learning_rate"] = np.float32(
        ts.hyperparams["learning_rate"] * np.float32(0.5))
    tree = ttx.to_flax(ts, lambda x: params_tree_of(model, x))
    v = ssl_variables_from_state(model.state_dict())
    template = jtx.init(jax.tree.map(jnp.asarray, v["params"]))
    restored = fs.from_bytes(template, fs.to_bytes(tree))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [(k, np.asarray(v).tolist()) for k, v in flat(
        fs.to_state_dict(restored))] == [(k, np.asarray(v).tolist())
                                         for k, v in flat(tree)]
    back = ttx.from_flax(fs.to_state_dict(restored),
                         lambda t: params_list_of(model, t))
    assert back.count == ts.count == 2 and back.inject_count == 2
    assert back.hyperparams == ts.hyperparams
    for a, b in zip(back.mu + back.nu, ts.mu + ts.nu):
        assert torch.equal(a, b)


# --- train mode of the models -----------------------------------------------

def test_batchnorm_moves_running_stats_with_the_biased_variance():
    """flax: ``ra = 0.99 ra + 0.01 var`` with the biased batch variance;
    ``nn.BatchNorm1d`` would take n / (n - 1) of it (6.7% off at 16)."""
    head = ProjectionHead(8, 32, 16).train()
    bn = head.BatchNorm_0
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(0))
    before = bn.running_var.clone()
    bn(x)
    var = x.var(dim=0, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.99 * before + 0.01 * var).numpy(), rtol=1e-6)
    unbiased = 0.99 * before + 0.01 * x.var(dim=0, unbiased=True)
    assert not torch.allclose(bn.running_var, unbiased, rtol=1e-4, atol=0)


class _Wrap(fnn.Module):
    """A root module whose child is named like the SSL model's head."""

    @fnn.compact
    def __call__(self, x):
        return JHead(hidden_dim=32, output_dim=16, num_layers=3,
                     name="projection_head")(x, train=True)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_dropout_masks_equal_flax(seed):
    """flax's ``nn.Dropout`` at ``projection_head/Dropout_0`` under the
    key ``PRNGKey(seed)`` keeps exactly the port's elements, scaled by
    1/0.9; ``Dropout_1`` draws another mask."""
    x = jnp.ones((16, 32), jnp.float32)

    class Named(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return Inner(name="projection_head")(x)

    class Inner(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dropout(0.1, deterministic=False)(x), \
                fnn.Dropout(0.1, deterministic=False)(x)

    want0, want1 = Named().apply({}, x, rngs={"dropout": jax.random.PRNGKey(seed)})
    key = threefry.key(seed)
    ones = torch.ones(16, 32)
    got0 = flax_dropout(ones, key, ("projection_head", "Dropout_0"), 0.1)
    got1 = flax_dropout(ones, key, ("projection_head", "Dropout_1"), 0.1)
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    assert not np.array_equal(np.asarray(want0), np.asarray(want1))


def test_projection_head_train_mode_matches_flax():
    """Three layers (two dropouts) in train mode: output and running
    statistics equal to the JAX head's under the same key."""
    x = np.random.default_rng(5).standard_normal((16, 24)).astype(np.float32)
    head = ProjectionHead(24, 32, 16, num_layers=3)
    seed_weights(head, 4)
    v = ssl_variables_from_state({f"projection_head.{k}": t for k, t in
                                  head.state_dict().items()})
    want, upd = _Wrap().apply(v, x, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(9)})
    got = head.train()(torch.from_numpy(x), threefry.key(9))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    after = ssl_variables_from_state({f"projection_head.{k}": t for k, t in
                                      head.state_dict().items()})
    assert tree_max_abs(upd["batch_stats"], after["batch_stats"]) <= 1e-6


def test_train_mode_forward_matches_jax():
    """Both views through ``apply(train=True, mutable=["batch_stats"])``,
    the second from the first's statistics, as the JAX step runs them."""
    xi, xj = views(1)
    tm = port_model()
    v = ssl_variables_from_state(tm.state_dict())
    jm = JSSL(**TINY)
    rng = jax.random.PRNGKey(3)
    (jo, je), upd = jm.apply(v, xi, train=True, mutable=["batch_stats"],
                             rngs={"dropout": rng}, return_embedding=True)
    jo2, upd2 = jm.apply({"params": v["params"],
                          "batch_stats": upd["batch_stats"]}, xj, train=True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.fold_in(rng, 1)})
    tm.train()
    with torch.no_grad():
        to, te = tm(torch.from_numpy(xi), return_embedding=True,
                    dropout_rng=threefry.key(3))
        mid = ssl_variables_from_state(tm.state_dict())["batch_stats"]
        to2 = tm(torch.from_numpy(xj),
                 dropout_rng=threefry.fold_in(threefry.key(3), 1))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-5)
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), atol=5e-5)
    assert tree_max_abs(upd["batch_stats"], mid) <= 1e-6
    final = ssl_variables_from_state(tm.state_dict())["batch_stats"]
    assert tree_max_abs(upd2["batch_stats"], final) <= 1e-6


# --- the train step, checkpoints, loops --------------------------------------

def _jax_three_steps(lr):
    """The JAX package's jitted step on the tiny model, 3 steps from the
    port's seeded weights: the loss and the state after each."""
    tm = port_model()
    v = ssl_variables_from_state(tm.state_dict())
    sched = j_schedule(lr, 1, 3)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=1e-4))
    params = jax.tree.map(jnp.asarray, v["params"])
    state = JT.SSLTrainState(params, jax.tree.map(jnp.asarray,
                                                  v["batch_stats"]),
                             tx.init(params), jnp.int32(0))
    step = jax.jit(JT.create_ssl_train_step(JSSL(**TINY), tx, 0.5))
    rng = jax.random.PRNGKey(11)
    out = []
    for k in range(3):
        xi, xj = views(20 + k)
        rng, sub = jax.random.split(rng)
        state, loss = step(state, xi, xj, sub)
        out.append((float(loss), jax.device_get(state)))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """``_jax_three_steps`` run once per lr."""
    return functools.cache(_jax_three_steps)


MOMENT_RTOL, MOMENT_FLOOR, DELTA_RTOL = 2e-3, 1e-2, 1e-2


def moments_max_rel(want, got) -> float:
    """The largest difference of a leaf, over its largest value or over
    ``MOMENT_FLOOR`` of the tree's largest where that is more."""
    la = [np.asarray(a) for a in jax.tree.leaves(want)]
    lb = jax.tree.leaves(got)
    assert len(la) == len(lb)
    top = max(float(np.abs(a).max()) for a in la)
    return max(float(np.abs(a - np.asarray(b)).max())
               / max(float(np.abs(a).max()), MOMENT_FLOOR * top)
               for a, b in zip(la, lb))


def moves_rel_norm(start, want, got) -> float:
    """``||d_got - d_want|| / ||d_want||`` of the moves from ``start``."""
    move = lambda tree: np.concatenate([
        (np.asarray(a, np.float64) - np.asarray(s, np.float64)).ravel()
        for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(start))])
    dw, dg = move(want), move(got)
    return float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))


def _three_steps_match_jax(jax_run, lr, stats_atol):
    tm = port_model()
    start = ssl_variables_from_state(tm.state_dict())["params"]
    tx = ClipAdamW(1.0, TS.cosine_warmup_schedule(lr, 1, 3), 1e-4)
    state = TT.SSLTrainState(dict(tm.named_parameters()),
                             dict(tm.named_buffers()),
                             tx.init(list(tm.parameters())), 0)
    step = TT.create_ssl_train_step(tm, tx, 0.5)
    rng = threefry.key(11)
    for k in range(3):
        xi, xj = views(20 + k)
        rng, sub = threefry.split(rng)
        state, loss = step(state, torch.from_numpy(xi), torch.from_numpy(xj),
                           sub)
        want_loss, jstate = jax_run[k]
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        v = ssl_variables_from_state(tm.state_dict())
        assert tree_max_abs(jstate.batch_stats, v["batch_stats"]) <= stats_atol
        adam = tx.to_flax(state.opt_state,
                          lambda ts: params_tree_of(tm, ts))["1"]["0"]
        j_adam = fs.to_state_dict(jstate.opt_state)["1"]["0"]
        assert int(j_adam["count"]) == adam["count"] == k + 1
        for name in ("mu", "nu"):
            assert moments_max_rel(j_adam[name], adam[name]) <= MOMENT_RTOL, (
                k, name)
        assert tree_max_abs(jstate.params, v["params"]) <= 2 * lr + 1e-6
        if k == 0:
            assert tree_max_abs(start, v["params"]) == 0.0
        else:
            assert moves_rel_norm(start, jstate.params, v["params"]) <= (
                DELTA_RTOL)
    assert state.step == 3 and state.opt_state.count == 3


def test_three_train_steps_match_jax(jax_steps):
    """``create_ssl_train_step`` for 3 steps of the cosine-warmup schedule
    at the shipped lr (lr 0 at step 0, which moves no parameter): loss,
    running statistics, Adam's moments and the parameters' moves against
    the JAX step (see the module note for the bounds)."""
    _three_steps_match_jax(jax_steps(LR), LR, 1e-5)


def test_three_train_steps_match_jax_at_lr_1e3(jax_steps):
    """The same at lr 1e-3, where a step moves each element about 1e-3;
    running statistics within 1e-4 (measured 1.6e-5 after step 2: the
    elements that step 1 moved the other way feed step 2's forward)."""
    _three_steps_match_jax(jax_steps(1e-3), 1e-3, 1e-4)


def _jax_template(model_kwargs, shape=(2, S, S)):
    shapes = jax.eval_shape(lambda: JSSL(**model_kwargs).init(
        jax.random.PRNGKey(0), jnp.zeros(shape), train=False))
    z = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return {"params": z["params"], "batch_stats": z["batch_stats"], "step": 0}


def test_ssl_checkpoints_cross_both_ways(tmp_path):
    """The port's ``save_checkpoint`` reads in the JAX package's
    ``load_checkpoint`` with the JAX template; a JAX-written one loads
    into the port's model tensor for tensor."""
    tm = port_model()
    tx = ClipAdamW(1.0, 1e-3, 1e-4)
    state = TT.SSLTrainState(dict(tm.named_parameters()),
                             dict(tm.named_buffers()),
                             tx.init(list(tm.parameters())), 7)
    TT.save_checkpoint(tmp_path / "port.msgpack", state)
    got = JT.load_checkpoint(tmp_path / "port.msgpack", _jax_template(TINY))
    v = ssl_variables_from_state(tm.state_dict())
    assert got["step"] == 7
    assert tree_max_abs(got["params"], v["params"]) == 0.0
    assert tree_max_abs(got["batch_stats"], v["batch_stats"]) == 0.0
    jstate = JT.SSLTrainState(got["params"], got["batch_stats"], None, 7)
    JT.save_checkpoint(tmp_path / "jax.msgpack", jstate)
    back = TT.load_checkpoint(tmp_path / "jax.msgpack",
                              {"params": 0, "batch_stats": 0, "step": 0})
    fresh = load_jax_variables(SSLModel(**TINY), {
        "params": back["params"], "batch_stats": back["batch_stats"]})
    ref = tm.state_dict()
    assert all(torch.equal(t, ref[k]) for k, t in fresh.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    with pytest.raises(KeyError):
        TT.load_checkpoint(tmp_path / "jax.msgpack", {"params": 0})


def test_train_ssl_loop_writes_the_jax_checkpoints(tmp_path):
    """Two epochs of two steps on host views: best, periodic and final
    checkpoints; the final holds the model's weights and step 4."""
    model = SSLModel(**TINY)

    def batches():
        return iter([views(30 + k) for k in range(2)])

    state, hist = TT.train_ssl(model, batches, 2, epochs=2, lr=1e-3,
                               warmup_epochs=1, input_shape=(S, S),
                               save_dir=tmp_path, save_every=1, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(hist))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ssl_best.msgpack", "ssl_epoch1.msgpack",
                     "ssl_epoch2.msgpack", "ssl_model_final.msgpack"]
    final = load_msgpack(tmp_path / "ssl_model_final.msgpack")
    assert final["step"] == state.step == 4
    v = ssl_variables_from_state(model.state_dict())
    assert tree_max_abs(final["params"], v["params"]) == 0.0


def test_train_ssl_device_loop_and_its_first_step(tmp_path):
    """The device-resident loop on a (10, 60, 50) uint8 set, batch 4: two
    steps an epoch, lr 0 on step 0; its views are ``augment_batch`` of the
    permuted batch under ``fold_in(sub, 0/1)``."""
    data = np.random.default_rng(2).integers(0, 256, (10, 60, 50), np.uint8)
    model = SSLModel(**TINY)
    state, hist = TT.train_ssl_device(model, data, 4, epochs=1, lr=1e-3,
                                      image_size=S, save_dir=tmp_path,
                                      device="cpu")
    assert state.step == 2 and len(hist) == 1 and np.isfinite(hist[0])
    assert (tmp_path / "ssl_model_final.msgpack").is_file()
    # the first step's views, rebuilt by hand
    order = np.random.default_rng(42).permutation(10)[:4]
    sub = threefry.split(threefry.key(42))[1]
    xi, xj = TT.device_views(torch.from_numpy(data), torch.from_numpy(order),
                             sub, S)
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier.augment_device import (
        augment_batch)
    x = torch.from_numpy(data[order].astype(np.float32) / np.float32(255.0))
    assert torch.equal(xi, augment_batch(x, threefry.fold_in(sub, 0), S))
    assert torch.equal(xj, augment_batch(x, threefry.fold_in(sub, 1), S))


def test_train_refuses_a_mesh_of_more_than_one_device():
    """A mesh of two devices and no process group is refused: training on
    W ranks takes a mesh built inside them
    (``tests/test_torch_distributed.py``)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        Mesh)
    mesh = Mesh((torch.device("cpu"), torch.device("cpu")), "data")
    with pytest.raises(ValueError, match="without a process group"):
        TT.train_ssl(SSLModel(**TINY), lambda: iter([]), 1, mesh=mesh)


def _config(root, aug: bool):
    cfg = {"paths": {"root_dir": str(root), "dataset_dir": str(root / "dataset"),
                     "save_dir": str(root / "save")},
           "ssl": {"dataset": {"batch_size": 4, "seed": 3, "image_size": S},
                   "model": {"backbone": "effnetv2_tiny", "embedding_dim": 32,
                             "projection_hidden_dim": 32, "projection_dim": 16,
                             "projection_layers": 2, "use_predictor": True},
                   "training": {"epochs": 1, "lr": 1e-3, "warmup_epochs": 1,
                                "device_augment": aug},
                   "clustering": {"n_clusters": 2, "pca_dim": 0}}}
    path = root / "classifier.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("branch", ["device", "host", "shapes differ"])
def test_main_trains_on_both_branches(tmp_path, monkeypatch, branch, capsys):
    """``main(train=True)`` without a checkpoint trains, writes
    ``ssl_model_final.msgpack`` and clusters with the trained weights:
    ``device_augment`` with one image shape renders the views on the
    device; without it, or with shapes that differ (logged), on the host."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier.pipeline import (
        main)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_png)
    d = tmp_path / "dataset" / "DBII"
    d.mkdir(parents=True)
    g = np.random.default_rng(0)
    for k in range(8):
        h = 70 if (branch == "shapes differ" and k == 3) else 64
        (d / f"{k // 4 + 1}_{k % 4 + 1}_1.png").write_bytes(
            encode_png(g.integers(0, 256, (h, 56), np.uint8)))
    cfg = _config(tmp_path, aug=branch != "host")
    monkeypatch.chdir(tmp_path)
    res = main(str(cfg), train=True, device="cpu")
    want = "device" if branch == "device" else "host"
    assert res["training"]["branch"] == want
    assert len(res["training"]["history"]) == 1
    assert (branch == "shapes differ") == (
        "image shapes differ" in capsys.readouterr().out)
    ckpt = tmp_path / "save" / "ssl_model_final.msgpack"
    payload = load_msgpack(ckpt)
    assert payload["step"] == 2
    assert res["embeddings"].shape == (8, 16) and "train" in res["seconds"]
    again = main(str(cfg), train=True, device="cpu")         # loads it now
    assert "training" not in again and "model" in again["seconds"]


def test_variables_from_state_copies_the_tensors():
    """The JAX tree of a CPU model holds copies: training the model after
    writing a checkpoint tree does not change the tree (numpy views of the
    tensors would)."""
    m = port_model()
    v = ssl_variables_from_state(m.state_dict())
    before = jax.tree.map(np.copy, v)
    with torch.no_grad():
        for t in m.state_dict().values():
            if t.is_floating_point():
                t.add_(1.0)
    assert tree_max_abs(v, before) == 0.0
