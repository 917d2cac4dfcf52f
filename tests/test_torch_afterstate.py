"""Port parity: the afterstate evaluation pass (``ops/afterstate.py``).

``afterstate_eval_plain`` against the JAX package's compositions on the
same inputs, made with numpy from seeds: ``ppo/learner.py::
_afterstate_logits`` (logits), the negated value of the opponent's view
and the score head masked to the legal prefix
(``agents/basic.py::afterstate_values`` / ``::afterstate_policy_logits``),
and ``agents/twoply.py::_masked_min_values`` (min).  Boards of every stage
(bar and borne-off checkers, zero padding rows), both movers, n = 0,
n = M and n in between, M a multiple of no tile, hidden 1, 32, 100, 128,
200 and 512 in float32 and in bfloat16 (``compute_dtype``).  float32:
forward within 1e-5 (float32 sums in another order); the gradients of a
scalar loss through the logits against ``jax.grad`` of the same loss
within 1e-5 of the gradient's norm.  bfloat16: forward within
``BF16_TOL`` (torch's bf16 ``linear`` rounds once after the bias, JAX
rounds the product and then the sum); the gradients within 4 times the
distance that a one-ulp bf16 nudge of the parameters moves JAX's.

Then the wrapper's contract on the CPU, the autograd function of the card
path with the plain versions standing in for the two kernels, and every
path that scores candidate boards: with the wrapper standing in for the
card, none calls ``afterstate_eval_plain``, ``features.encode_canonical``
or ``MLP.score``/``value`` on candidate boards itself, and each makes the
launches counted from its code (a 2-ply decision
``launches_per_decision``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.agents import twoply as JT
from mlp_ppo_2ply_p3_tpu.core import features as JF
from mlp_ppo_2ply_p3_tpu.core.board import opponent_view as j_opponent_view
from mlp_ppo_2ply_p3_tpu.models import mlp as JMLP
from mlp_ppo_2ply_p3_tpu.ppo import learner as JL
from mlp_ppo_2ply_p3_tpu_torch import ops
from mlp_ppo_2ply_p3_tpu_torch.agents import basic as TB
from mlp_ppo_2ply_p3_tpu_torch.agents import twoply as TT
from mlp_ppo_2ply_p3_tpu_torch.core import board as TBd
from mlp_ppo_2ply_p3_tpu_torch.core import features as TF
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as TAS
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner as TL
from mlp_ppo_2ply_p3_tpu_torch.scripts import run_distill as TD
from mlp_ppo_2ply_p3_tpu_torch.utils import convert
from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig

from .test_torch_utils import canonical, nn_, random_positions, tt

R, M = 37, 29   # no tile's multiple
# the bf16 forms against JAX's compute_dtype="bfloat16" and the kernels'
# plain version: at most 4.9e-3 read here (hidden 1; 1.0e-3 to 2.0e-3 at
# 32 to 512), under tests/test_torch_models.py's bf16 2e-2
BF16_TOL = 1e-2
# the gradients' distance from JAX's within this many times the distance
# that a one-ulp bf16 nudge of every parameter moves JAX's (0.14 to 0.86
# of a nudge read here)
BF16_NUDGE_FACTOR = 4.0
# (hidden, compute dtype): the ids of the float32 forms are the widths
# alone
WIDTHS = [(h, "float32") for h in (32, 128, 1, 100, 200, 512)] + [
    (h, "bfloat16") for h in (1, 32, 100, 128, 200, 512)]


def width_id(case):
    h, dtype = case
    return str(h) if dtype == "float32" else f"{h}-bf16"


def candidate_boards(seed, r=R, m=M):
    """(r, m, 52) int8 canonical boards of random positions of every
    stage (bar entries, bear-offs), each for a random player, and a tenth
    of the rows all-zero padding; (r,) int32 movers of both colours; n
    with 0, m and values in between."""
    rng = np.random.default_rng(seed)
    boards, players = [], []
    for stage in ("any", "bearoff", "bar"):
        b, p = random_positions(rng, r * m // 3 + 1, stage)
        boards.append(b)
        players.append(p)
    pick = rng.permutation(sum(len(b) for b in boards))[:r * m]
    boards = canonical(np.concatenate(boards)[pick],
                       np.concatenate(players)[pick])
    boards = boards.reshape(r, m, 52).astype(np.int8)
    boards[rng.random((r, m)) < 0.1] = 0
    mover = rng.integers(0, 2, r).astype(np.int32)
    n = rng.integers(1, m, r).astype(np.int32)
    n[::5] = 0
    n[1::7] = m
    return boards, mover, n


def jax_params(seed, hidden, dtype="float32"):
    cfg = JMLP.ModelConfig(hidden_size=hidden, action_size=M,
                           compute_dtype=dtype)
    params = JMLP.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, params), cfg


def port_model(params, cfg):
    """The port's ``MLP`` of JAX ``params`` with ``cfg``'s widths and
    compute dtype, on the CPU."""
    return convert.params_from_jax(params, TMLP.ModelConfig(
        hidden_size=cfg.hidden_size, action_size=cfg.action_size,
        compute_dtype=cfg.compute_dtype), device="cpu")


def port_weights(model, head):
    return (model.layers["fc1"].weight, model.layers["fc1"].bias,
            model.layers[head].weight, model.layers[head].bias)


def _jax_masked(vals, n, sign):
    valid = jnp.arange(vals.shape[1])[None, :] < n[:, None]
    return jnp.where(valid, sign * vals, -1e9)


def jax_eval(params, cfg, boards, mover, n, head, opponent, epilogue, sign):
    """The JAX package's composition of each epilogue."""
    if epilogue == "logits":
        return JL._afterstate_logits(params, boards, mover, n,
                                     boards.shape[1], cfg)
    if epilogue == "min":
        return JT._masked_min_values(params, boards, n, mover, cfg, 8)
    view = j_opponent_view(boards) if opponent else boards
    feats = jax.vmap(JF.encode_canonical)(view, mover)
    vals = getattr(JMLP, head)(params, feats, cfg)
    return _jax_masked(vals, n, sign)


# (head, opponent view, epilogue, sign): the learner's logits, the 1-ply
# values (negated, the opponent's view), the score-head policy logits, the
# dances' raw values (n = M), the replies' min
FORMS = [("score", False, "logits", 1.0), ("value", True, "masked", -1.0),
         ("score", False, "masked", 1.0), ("value", False, "raw", 1.0),
         ("value", True, "min", 1.0)]


@pytest.mark.parametrize("hidden,dtype", WIDTHS, ids=map(width_id, WIDTHS))
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"{f[0]}-{f[2]}")
def test_plain_matches_jax(form, hidden, dtype):
    head, opponent, epilogue, sign = form
    boards, mover, n = candidate_boards(hidden + len(epilogue))
    if epilogue == "raw":
        epilogue, n = "masked", np.full_like(n, M)
    params, cfg = jax_params(1, hidden, dtype)
    model = port_model(params, cfg)
    args = (jnp.asarray(boards), jnp.asarray(mover), jnp.asarray(n))
    want = np.asarray(jax.jit(jax_eval, static_argnums=(1, 5, 6, 7, 8))(
        jax.tree_util.tree_map(jnp.asarray, params), cfg, *args, head,
        opponent, epilogue, sign))
    weights = [w.to(model.dtype) for w in port_weights(model, head)]
    got = TAS.afterstate_eval_plain(tt(boards), tt(mover), tt(n), *weights,
                                    opponent, epilogue, sign, 8)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(nn_(got), want, atol=1e-5 if dtype ==
                               "float32" else BF16_TOL)
    if epilogue == "min":
        assert (nn_(got)[n == 0] == TAS.POS_INF).all()
    else:
        assert (nn_(got)[np.arange(M)[None, :] >= np.maximum(
            n, M * (n == 0) * (epilogue == "logits"))[:, None]]
            == TAS.FLOOR).all()


def bf16_nudged(x):
    """``x`` rounded to bf16 and moved up by one bf16 ulp, as float32."""
    b = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    return torch.nextafter(b, torch.full_like(b, np.inf)).float().numpy()


@pytest.mark.parametrize("hidden,dtype", WIDTHS, ids=map(width_id, WIDTHS))
def test_gradients_match_jax(hidden, dtype):
    """d/dparams of sum(c * log_softmax(logits)) (a policy-loss shape over
    the logits epilogue), against jax.grad; masked entries carry none.
    float32: within 1e-5 of each gradient's norm.  bfloat16: the four
    gradients' distance from JAX's (the norm over all four) within
    BF16_NUDGE_FACTOR times the distance that a one-ulp bf16 nudge of
    every parameter moves JAX's: a gradient entry is a sum of hundreds of
    bf16-rounded terms, which the two frameworks round at other points, and
    the nudge measures what one rounding of the parameters does to them."""
    boards, mover, n = candidate_boards(7 + hidden)
    coef = np.random.default_rng(3).standard_normal((R, M)).astype(
        np.float32)
    params, cfg = jax_params(2, hidden, dtype)

    def jloss(p):
        logits = JL._afterstate_logits(p, jnp.asarray(boards),
                                       jnp.asarray(mover), jnp.asarray(n),
                                       M, cfg)
        return jnp.sum(jnp.asarray(coef) * jax.nn.log_softmax(logits, -1))

    jgrad = jax.jit(jax.grad(jloss))
    want = jgrad(jax.tree_util.tree_map(jnp.asarray, params))
    model = port_model(params, cfg)
    logits = TAS.evaluate(model, tt(boards), tt(mover), tt(n), "score")
    loss = torch.sum(tt(coef) * torch.log_softmax(logits, -1))
    loss.backward()
    assert model.layers["value"].weight.grad is None
    pairs = [(nn_(lin.weight.grad.T), np.asarray(want[layer]["w"]))
             for layer, lin in ((k, model.layers[k]) for k in ("fc1",
                                                               "score"))]
    pairs += [(nn_(model.layers[k].bias.grad), np.asarray(want[k]["b"]))
              for k in ("fc1", "score")]
    if dtype == "float32":
        for got, w in pairs:
            assert np.abs(got - w).max() <= 1e-5 * np.linalg.norm(w)
        return
    nudged = jgrad(jax.tree_util.tree_map(
        lambda x: jnp.asarray(bf16_nudged(x)), params))
    moved = [np.asarray(nudged[k][p]) for k, p in (("fc1", "w"),
                                                   ("score", "w"),
                                                   ("fc1", "b"),
                                                   ("score", "b"))]

    def dist(xs, ys):
        return np.sqrt(sum(((x.astype(np.float64) - y) ** 2).sum()
                           for x, y in zip(xs, ys)))

    wants = [w for _, w in pairs]
    err, floor = dist([g for g, _ in pairs], wants), dist(moved, wants)
    assert 0 < floor and err <= BF16_NUDGE_FACTOR * floor, (err, floor)


def test_wrapper_on_cpu_and_its_checks(monkeypatch):
    """CPU tensors take the plain version (no library is loaded) and
    count no launch; the launch keys are registered; bad inputs raise."""
    boards, mover, n = candidate_boards(5, 6, 9)
    model = TMLP.MLP(TMLP.ModelConfig(hidden_size=64), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    w = port_weights(model, "value")

    def no_library(name):
        raise AssertionError(f"the CPU path loaded {name}")

    monkeypatch.setattr(TAS, "_fn", no_library)
    before = ops.launches()
    args = (tt(boards), tt(mover), tt(n), *w)
    for epilogue, sign in (("logits", 1.0), ("masked", -1.0), ("min", 1.0)):
        got = TAS.afterstate_eval(*args, True, epilogue, sign)
        assert torch.equal(got, TAS.afterstate_eval_plain(
            *args, True, epilogue, sign))
    grad = torch.ones((6, 9))
    got = TAS.afterstate_eval_backward(*args, False, "logits", 1.0, grad)
    want = TAS.afterstate_eval_backward_plain(*args, False, "logits", 1.0,
                                              grad)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert [tuple(g.shape) for g in got] == [(64, 198), (64,), (1, 64), (1,)]
    assert ops.launches() == before
    assert ops.KERNELS[-2:] == ("afterstate_eval", "afterstate_eval_backward")
    assert ops.counters()["afterstate_eval"] is TAS._COUNTERS[
        "afterstate_eval"]
    bad = [
        ((tt(boards).int(), *args[1:], False, "logits", 1.0), TypeError),
        ((tt(boards)[:, :, :51], *args[1:], False, "logits", 1.0),
         TypeError),
        ((args[0], tt(mover).long(), *args[2:], False, "logits", 1.0),
         TypeError),
        ((*args[:3], w[0].T, *w[1:], False, "logits", 1.0), ValueError),
        ((*args, False, "max", 1.0), ValueError),
        ((*args, False, "masked", 0.5), ValueError),
        ((*args, False, "min", -1.0), ValueError),
        ((*args, 1, "logits", 1.0), TypeError),
    ]
    for call, err in bad:
        with pytest.raises(err):
            TAS.afterstate_eval(*call)
    with pytest.raises(NotImplementedError):
        TAS.afterstate_eval_backward(*args, True, "min", 1.0, torch.ones(6))
    with pytest.raises(ValueError):
        TAS.afterstate_eval_backward(*args, True, "logits", 1.0,
                                     torch.ones(6))


def _standing_in(monkeypatch, calls):
    """Swaps the two kernels for their plain versions behind the card
    path's own glue (the autograd function, the backward wrapper), counts
    the wrappers' calls into ``calls``, and counts in ``calls["outside"]``
    every call of the plain pass's pieces on candidate boards that does
    not come from inside a stand-in."""
    inside = [0]
    fwd, bwd = TAS.afterstate_eval_plain, TAS.afterstate_eval_backward

    def kernel(*args):
        inside[0] += 1
        try:
            return fwd(*args)
        finally:
            inside[0] -= 1

    def wrapper(*args):
        calls["afterstate_eval"] += 1
        return TAS._Eval.apply(*args[:10])

    def backward(*args):
        calls["afterstate_eval_backward"] += 1
        inside[0] += 1
        try:
            return bwd(*args)
        finally:
            inside[0] -= 1

    def outside(fn, candidate=lambda *a: True):
        def counted(*args, **kw):
            if not inside[0] and candidate(*args):
                calls["outside"] += 1
            return fn(*args, **kw)
        return counted

    monkeypatch.setattr(TAS, "_forward_kernel",
                        lambda *a: kernel(*a[:10]))
    monkeypatch.setattr(TAS, "afterstate_eval", wrapper)
    monkeypatch.setattr(TAS, "afterstate_eval_backward", backward)
    monkeypatch.setattr(TAS, "afterstate_eval_plain", outside(fwd))
    monkeypatch.setattr(TF, "encode_canonical", outside(TF.encode_canonical))
    monkeypatch.setattr(TMLP.MLP, "score", outside(TMLP.MLP.score))
    monkeypatch.setattr(TMLP.MLP, "value", outside(
        TMLP.MLP.value, lambda self, x: x.dim() > 2))


def test_autograd_function_with_plain_kernels(monkeypatch):
    """The card path's ``torch.autograd.Function`` with the plain versions
    in the kernels' place gives the plain gradients exactly: its backward
    passes the weights' gradients in order and the boards none."""
    calls = {"afterstate_eval": 0, "afterstate_eval_backward": 0,
             "outside": 0}
    boards, mover, n = candidate_boards(11, 8, 13)
    model = TMLP.MLP(TMLP.ModelConfig(hidden_size=32), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    coef = torch.randn((8, 13), generator=torch.Generator().manual_seed(2))
    want = []
    for stand_in in (False, True):
        if stand_in:
            _standing_in(monkeypatch, calls)
        model.zero_grad()
        out = TAS.evaluate(model, tt(boards), tt(mover), tt(n), "value",
                           opponent=True, epilogue="masked", sign=-1.0)
        torch.sum(coef * out).backward()
        grads = [p.grad.clone() for p in port_weights(model, "value")]
        if stand_in:
            assert all(torch.equal(g, w) for g, w in zip(grads, want))
        want = grads
    assert calls == {"afterstate_eval": 1, "afterstate_eval_backward": 1,
                     "outside": 0}


def test_launch_sizes():
    """The wrapper's sizes for the kernels' grids: unit groups of 128 (the
    last one padded), the forward's scratch past 256 units ((groups, R M)
    head partials, none below), the backward's blocks (a tile of 64
    boards each, at most 132 // groups, at least one; 132 and 66 at
    hidden 128 and 256 as before) and their slabs."""
    assert [TAS.unit_groups(h) for h in (1, 127, 128, 129, 256, 257, 512,
                                         1024)] == [1, 1, 1, 2, 2, 3, 4, 8]
    assert [TAS.forward_scratch_floats(10, 7, h) for h in (1, 128, 200,
                                                           256)] == [0] * 4
    assert TAS.forward_scratch_floats(10, 7, 257) == 3 * 70
    assert TAS.forward_scratch_floats(4096, 256, 512) == 4 * 4096 * 256
    assert TAS.backward_blocks(0, 9, 128) == TAS.backward_blocks(9, 0, 128) \
        == 0
    assert TAS.backward_blocks(1, 1, 1) == 1
    assert TAS.backward_blocks(3, 64, 100) == 3
    assert [TAS.backward_blocks(8192, 256, h) for h in (1, 64, 128, 256,
                                                        384, 512, 1024,
                                                        17000)] == [
        132, 132, 132, 66, 44, 33, 16, 1]
    for h in (1, 100, 128, 256, 512, 1024):
        floats = TAS.backward_scratch_floats(8192, 256, h)
        assert floats == TAS.backward_blocks(8192, 256, h) * (200 * h + 1)
        assert floats <= 132 * (200 * 128 + 1)   # hidden 128's 13.5 MB
    assert TAS.kernel_dtype(*[torch.zeros(2)] * 4) == 0
    assert TAS.kernel_dtype(*[torch.zeros(2, dtype=torch.bfloat16)] * 4) == 1


def test_kernel_dispatch_any_width_and_bf16(monkeypatch):
    """The card path with the tensors taken for CUDA ones and a recorder in
    the C entry points' place: every width and both dtypes reach the
    launchers (no plain version), with the dtype argument of the weights,
    the scratch sizes and blocks of ``test_launch_sizes``; a bf16 model's
    loss reaches the backward with dtype 1 and its float32 gradients reach
    the model's float32 parameters; under the ``logits`` epilogue alone the
    rows' entries (``afterstate_collapse``) are found first, once a forward
    call, and handed to the forward and its backward; float16, float64,
    mixed weights and non-contiguous inputs raise (the dtypes naming the
    ROADMAP item)."""
    calls = []

    def record(name, dev, *args):
        calls.append((name, args))
        return 0

    def no_plain(*args, **kw):
        raise AssertionError("the card path took the plain version")

    monkeypatch.setattr(TAS, "_on_card", lambda x: True)
    monkeypatch.setattr(TAS, "_launch", record)
    monkeypatch.setattr(TAS, "afterstate_eval_plain", no_plain)
    monkeypatch.setattr(TAS, "afterstate_eval_backward_plain", no_plain)
    r, m = 6, 9
    boards, mover, n = (tt(x) for x in candidate_boards(5, r, m))
    before = ops.launches()
    for h in (1, 32, 100, 200, 384, 512, 1024):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            model = TMLP.MLP(TMLP.ModelConfig(hidden_size=h), device="cpu",
                             generator=torch.Generator().manual_seed(h))
            w = [x.to(dtype) for x in port_weights(model, "value")]
            for epilogue in ("logits", "min"):
                out = TAS.afterstate_eval(boards, mover, n, *w, True,
                                          epilogue, 1.0)
                assert out.shape == ((r,) if epilogue == "min" else (r, m))
                name, args = calls.pop()
                floats = TAS.forward_scratch_floats(r, m, h)
                assert name == "afterstate_eval_launch"
                assert args[9:] == (
                    args[9], floats, r, m, h, 1, TAS.EPILOGUES[epilogue],
                    1.0, code)
                assert (args[9] is None) == (floats == 0)
                # the rows' entries: found first under the logits epilogue
                # alone, and handed to the forward
                assert (args[3] is None) == (epilogue == "min")
                if epilogue == "logits":
                    name, lim_args = calls.pop()
                    assert name == "afterstate_collapse_launch"
                    assert lim_args[2] == args[3] and lim_args[4:] == (r, m)
            grads = TAS.afterstate_eval_backward(
                boards, mover, n, *w, False, "masked", -1.0,
                torch.ones((r, m)))
            name, args = calls.pop()
            assert name == "afterstate_backward_launch"
            blocks = TAS.backward_blocks(r, m, h)
            assert args[3] is None and args[4] is None
            assert args[11] == TAS.backward_scratch_floats(r, m, h)
            assert args[13:] == (blocks, r, m, h, 0, 1, -1.0, code)
            assert [g.dtype for g in grads] == [torch.float32] * 4
            assert [tuple(g.shape) for g in grads] == [(h, 198), (h,),
                                                      (1, h), (1,)]
    assert ops.launches()["afterstate_eval"] - before["afterstate_eval"] \
        == 28
    model = TMLP.MLP(TMLP.ModelConfig(hidden_size=200,
                                      compute_dtype="bfloat16"),
                     device="cpu", generator=torch.Generator().manual_seed(0))
    TAS.evaluate(model, boards, mover, n, "score").sum().backward()
    assert [(c[0], c[1][-1]) for c in calls] == [
        ("afterstate_collapse_launch", m), ("afterstate_eval_launch", 1),
        ("afterstate_backward_launch", 1)]
    # the backward takes the forward's entries (no second collapse launch)
    # and scratch for the whole rows' summed cotangents
    assert calls[1][1][3] == calls[2][1][3] == calls[0][1][2] is not None
    assert calls[2][1][4] is not None
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in port_weights(model, "score"))
    w = port_weights(model, "score")
    bad = [[x.half() for x in w], [x.double() for x in w],
           [w[0].bfloat16(), *w[1:]]]
    for weights in bad:
        with pytest.raises(ValueError, match="item 20"):
            TAS.afterstate_eval(boards, mover, n, *weights, False, "logits",
                                1.0)
    with pytest.raises(ValueError, match="contiguous"):
        TAS.afterstate_eval(boards[:, ::2], mover, n, *w, False, "logits",
                            1.0)


def test_paths_score_through_the_wrapper(monkeypatch):
    """With the wrapper standing in for the card (``_standing_in``), the
    afterstate rollout and update, greedy 1-ply, the score-head policy, a
    2-ply decision and a distillation step score every candidate board
    through it: no call of the plain pass's pieces from outside, and the
    wrapper's calls as counted from the code."""
    calls = {"afterstate_eval": 0, "afterstate_eval_backward": 0,
             "outside": 0}
    _standing_in(monkeypatch, calls)
    widths = dict(max_moves=M, k2=64, k3=64)
    env = TE.EnvConfig(movegen=MovegenConfig(**widths))
    mcfg = TMLP.ModelConfig(hidden_size=32, action_size=M)
    ppo = TL.PPOConfig(num_envs=8, t_horizon=3, num_epochs=2,
                       num_minibatches=2, policy_mode="afterstate")
    ts = TL.init_train_state(0, mcfg, ppo, device="cpu")
    gen = torch.Generator().manual_seed(3)
    es = TE.reset(gen, env, 8, device="cpu")

    def expect(fwd, bwd):
        assert calls == {"afterstate_eval": fwd,
                         "afterstate_eval_backward": bwd, "outside": 0}
        calls.update(afterstate_eval=0, afterstate_eval_backward=0)

    ts, es, metrics = TL.train_step(ts, es, env, mcfg, ppo)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    steps = ppo.num_epochs * ppo.num_minibatches
    expect(ppo.t_horizon + steps, steps)
    TB.greedy_1ply(ts.model, es)
    expect(1, 0)
    TB.afterstate_policy(ts.model, es, TL.uniforms(gen))
    expect(1, 0)
    scfg = SearchConfig(top_k=2, reply_max_moves=M, game_chunk=5,
                        dbl_game_chunk=3)
    TT.twoply_actions_values(ts.model, es, scfg)
    expect(TT.launches_per_decision(8, scfg)[4], 0)
    opt = TL.init_optimizer(ts.model)
    update = TD.make_update(ts.model, M, 1e-3, 1.0, 1.0)
    mb = (TE.observe(es), es.after, es.n_moves, es.turn,
          torch.zeros(8, dtype=torch.int32), torch.zeros(8))
    update(opt, mb)
    expect(1, 1)


def test_masked_min_chunking_changes_nothing():
    """The min's plain version walks the reply axis in blocks; every block
    width gives the same bits as one block."""
    boards, mover, n = candidate_boards(13, 16, 40)
    model = TMLP.MLP(TMLP.ModelConfig(hidden_size=32), device="cpu",
                     generator=torch.Generator().manual_seed(4))
    args = (tt(boards), tt(mover), tt(n), *port_weights(model, "value"),
            True, "min", 1.0)
    whole = TAS.afterstate_eval_plain(*args, 0)
    for chunk in (1, 7, 16, 40, 64):
        assert torch.equal(TAS.afterstate_eval_plain(*args, chunk), whole)
    empty = TAS.afterstate_eval_plain(tt(boards[:, :0].copy()), *args[1:], 8)
    assert (empty == TAS.POS_INF).all()


def test_afterstate_train_step_matches_plain_composition():
    """The afterstate ``train_step`` through the wrapper equals, bit for
    bit on the CPU, the same step with the learner's former composition
    (``features.encode_canonical`` + ``MLP.score`` + the prefix mask)."""
    widths = dict(max_moves=M, k2=64, k3=64)
    env = TE.EnvConfig(movegen=MovegenConfig(**widths))
    mcfg = TMLP.ModelConfig(hidden_size=32, action_size=M)
    ppo = TL.PPOConfig(num_envs=8, t_horizon=3, num_epochs=1,
                       num_minibatches=2, policy_mode="afterstate")

    def former(model, after, turn, n_moves):
        feats = TF.encode_canonical(after, turn[:, None])
        return torch.where(TL._prefix_mask(n_moves, after.shape[1]),
                           model.score(feats), TL.MASK_FLOOR)

    out = []
    for logits in (TL._afterstate_logits, former):
        ts = TL.init_train_state(0, mcfg, ppo, device="cpu")
        es = TE.reset(torch.Generator().manual_seed(5), env, 8, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TL, "_afterstate_logits", logits)
            ts, es, metrics = TL.train_step(ts, es, env, mcfg, ppo)
        out.append(([p.detach() for p in ts.model.parameters()], list(es),
                    metrics))
    (pa, ea, ma), (pb, eb, mb) = out
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all(torch.equal(a, b) for a, b in zip(ea, eb))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_masked_forms_equal_the_agents_former_masks():
    """``afterstate_values`` (``greedy_1ply``'s and 2-ply's values) equals
    the former composition, ``where(action_mask, -V(opponent_view(after),
    1 - turn), NEG_INF)``, bit for bit."""
    boards, mover, n = candidate_boards(17, 8, M)
    model = TMLP.MLP(TMLP.ModelConfig(hidden_size=32, action_size=M),
                     device="cpu", generator=torch.Generator().manual_seed(6))
    es = TE.reset(torch.Generator().manual_seed(7),
                  TE.EnvConfig(movegen=MovegenConfig(max_moves=M, k2=64,
                                                     k3=64)), 8,
                  device="cpu")
    es = es._replace(after=tt(boards), n_moves=tt(n),
                     turn=tt(mover.astype(np.int8)))
    feats = TF.encode_canonical(TBd.opponent_view(es.after),
                                (1 - es.turn.to(torch.int32))[:, None])
    former = torch.where(TE.action_mask(es), -model.value(feats), TB.NEG_INF)
    assert torch.equal(TB.afterstate_values(model, es), former)


# --- the numerics the kernels rely on (csrc/afterstate.cu) -------------------


def _byte_boards(kind):
    """(256, 52) int8 boards, board i with the bytes of ``kind`` set to the
    int8 value i - 128: every point byte, both bar bytes or both borne-off
    bytes."""
    boards = np.zeros((256, 52), np.int8)
    cols = {"point": slice(0, 48), "bar": slice(48, 50),
            "off": slice(50, 52)}[kind]
    boards[:, cols] = np.arange(-128, 128).astype(np.int8)[:, None]
    return boards


@pytest.mark.parametrize("mover", [0, 1])
@pytest.mark.parametrize("kind", ["point", "bar", "off"])
def test_features_exact_in_bf16_but_off(kind, mover):
    """Every int8 byte's features, as the port and JAX's compiled encoder
    build them (equal bit for bit): the point and bar features and the
    one-hot are bf16 numbers, so the kernels' bf16 feature tile holds them
    exactly; the off features are not, and they are the only ones that are
    not (``FLOAT32_COLUMNS``, which the kernels keep in float32)."""
    boards = _byte_boards(kind)
    movers = np.full(256, mover, np.int32)
    feats = TF.encode_canonical(torch.from_numpy(boards),
                                torch.from_numpy(movers))
    want = np.asarray(jax.jit(jax.vmap(JF.encode_canonical))(boards, movers))
    assert np.array_equal(feats.numpy(), want)
    inexact = (feats.bfloat16().float() != feats).any(dim=0)
    assert inexact.nonzero().flatten().tolist() == (
        list(TAS.FLOAT32_COLUMNS) if kind == "off" else [])


@pytest.mark.parametrize("lo,hi", [(-110, -60), (-60, 0), (0, 60),
                                   (60, 127)])
def test_split_bf16_reconstructs_float32(lo, hi):
    """Three bf16 parts (``split_bf16``, the kernels' split of W1 and of
    dpre) sum back to float32 numbers in [2^lo, 2^hi) exactly, either
    sign; two parts leave up to 2^-16 of them out."""
    rng = np.random.default_rng(lo + 1000)
    x = (rng.choice([-1.0, 1.0], 20000) * rng.uniform(1, 2, 20000)
         * 2.0 ** rng.integers(lo, hi, 20000)).astype(np.float32)
    x = torch.from_numpy(x)
    parts = TAS.split_bf16(x)
    assert [p.dtype for p in parts] == [torch.bfloat16] * 3
    assert torch.equal(sum(p.double() for p in parts), x.double())
    two = sum(p.double() for p in TAS.split_bf16(x, 2))
    rel = float(((two - x.double()) / x.double()).abs().max())
    assert 0 < rel <= 2.0 ** -16


def test_split_bf16_at_the_edges():
    """Zero splits into zeros; below 2^-110 (float32's subnormals too) the
    last part falls under bf16's smallest subnormal, off by at most
    2^-134; the largest float32 under 2^127 splits exactly."""
    tiny = torch.tensor([2.0 ** -111, -3 * 2.0 ** -130, 2.0 ** -149,
                         1.2345e-38, 0.0], dtype=torch.float32)
    err = (sum(p.double() for p in TAS.split_bf16(tiny)) - tiny.double())
    assert float(err.abs().max()) <= 2.0 ** -134
    assert all(float(p[-1]) == 0.0 for p in TAS.split_bf16(tiny))
    big = torch.tensor([np.nextafter(np.float32(2.0 ** 127), np.float32(0)),
                        -1.5 * 2.0 ** 126], dtype=torch.float32)
    assert torch.equal(sum(p.double() for p in TAS.split_bf16(big)),
                       big.double())


@pytest.mark.parametrize("hidden", [32, 128])
def test_split_fc1_is_exact(hidden):
    """The kernels' fc1 on candidate boards, summed in float64: the bf16
    feature tile (``FLOAT32_COLUMNS`` zeroed) times each of W1's three
    bf16 parts, plus the float32 off features times W1's off columns,
    equals the float32 features times W1: the split changes no
    product, only the order of the sums."""
    boards, mover, _ = candidate_boards(5)
    feats = TF.encode_canonical(torch.from_numpy(boards),
                                torch.from_numpy(mover)[:, None])
    feats = feats.reshape(-1, 198)
    rng = np.random.default_rng(hidden)
    w1 = torch.from_numpy(
        (rng.standard_normal((hidden, 198)) * 0.2).astype(np.float32))
    cols = list(TAS.FLOAT32_COLUMNS)
    kept = feats.clone()
    kept[:, cols] = 0.0
    tile = kept.bfloat16()
    assert torch.equal(tile.float(), kept)
    split = sum(tile.double() @ p.double().T for p in TAS.split_bf16(w1))
    split = split + feats[:, cols].double() @ w1[:, cols].double().T
    want = feats.double() @ w1.double().T
    assert torch.allclose(split, want, rtol=1e-13, atol=1e-13)


def _chip_smoke():
    """``chip_smoke.py`` as a module: its helpers import torch lazily and
    its top level runs nothing."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_afterstate_inputs():
    """The inputs the card tests hold both afterstate kernels to
    (``tests/test_torch_cuda.py::afterstate_inputs``): the pass's argument
    types and shapes, n with 0 and M among its values, the same tensors
    from the same seed, here on the CPU."""
    from .test_torch_cuda import afterstate_inputs

    cpu = torch.device("cpu")
    got = afterstate_inputs(cpu, 7, 9, 13, 128)
    boards, mover, n, *w = got
    assert boards.shape == (9, 13, 52) and boards.dtype == torch.int8
    assert mover.dtype == n.dtype == torch.int32
    assert {0, 13} <= set(n.tolist())
    assert [tuple(x.shape) for x in w] == [(128, 198), (128,), (1, 128),
                                          (1,)]
    assert all(torch.equal(a, b) for a, b in zip(
        got, afterstate_inputs(cpu, 7, 9, 13, 128)))
    args = (*got, False, "logits", 1.0)
    assert TAS.afterstate_eval(*args).shape == (9, 13)


def test_chip_smoke_counts_what_ops_counts():
    """``chip_smoke.py``'s expected counts of a path (``with_optimizer``)
    carry the keys of ``ops.launches()``, so that they compare with what
    it reads."""
    cs = _chip_smoke()
    assert list(ops.launches()) == list(cs.with_optimizer(
        dict.fromkeys(ops.KERNELS, 0), 3))
    assert cs.with_optimizer({"nondoubles": 2}, 3) == {
        "nondoubles": 2, ops.OPTIMIZER: 3, **dict.fromkeys(ops.DEEP, 0)}
    assert cs.with_optimizer({}, deep={"dense_layers": 4})[
        "dense_layers"] == 4
    assert cs.with_optimizer({})[ops.OPTIMIZER] == 0


def test_chip_smoke_needs_a_card(monkeypatch, capsys):
    """Without a card ``chip_smoke.py`` exits non-zero before its first
    phase and prints nothing on stdout: the kernels have no CPU mode."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        cs.main([])
    assert exit_.value.code != 0
    assert capsys.readouterr().out == ""
