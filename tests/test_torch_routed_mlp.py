"""The routed model (an ``MLP`` with ``race``: wildbg's contact and race
networks, each position through the network its class selects) on the
CPU, against the plain reference of ``models/routed_reference.py``, at
small widths; the class rule on the boards where it turns; the routed
pass's staged pieces (the route, each group's first layer and dense
layers, their backwards) against the plain pass; the optimizer at the
model's 24 leaves.  The kernels against the plain versions on the card:
``tests/test_torch_cuda.py -k routed``.

Tolerances are ``test_torch_deep_mlp.py``'s (1e-6 of each value's scale,
1e-5 for gradients), which one TF32 product of the race network fails
(``test_a_tf32_product_fails_the_tolerances``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd
from mlp_ppo_2ply_p3_tpu_torch.core import features as F
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models import deep_reference as D
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.models import routed_reference as R
from mlp_ppo_2ply_p3_tpu_torch.ops import adam as AD
from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE
from mlp_ppo_2ply_p3_tpu_torch.ops import dense as DN
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.utils import config as TCONF

TOL = 1e-6
GRAD_TOL = 1e-5
ROUTED = TCONF.get_preset("wildbg2net4096")
WILDBG = TCONF.get_preset("wildbg4096")
# small widths, both networks
SMALL = dataclasses.replace(ROUTED.model, hidden_size=17, trunk=(13, 11),
                            action_size=9)


def _model(seed=0, cfg=SMALL):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return TMLP.MLP(cfg, device="cpu", generator=gen)


def _gap(got, want):
    """Largest difference over the scale of ``want`` (at least 1)."""
    if not want.numel():
        return 0.0
    scale = max(1.0, float(want.abs().max()))
    return float((got.detach() - want.detach()).abs().max()) / scale


def _board(mine=(), theirs=(), my_bar=0, opp_bar=0, my_off=0, opp_off=0):
    """A canonical board: ``mine`` and ``theirs`` (point, count) pairs."""
    b = torch.zeros(52, dtype=torch.int8)
    for p, c in mine:
        b[p] = c
    for p, c in theirs:
        b[24 + p] = c
    b[48:52] = torch.tensor([my_bar, opp_bar, my_off, opp_off])
    return b


# (name, board, race): the mover moves up (0 -> 23), the opponent down
EDGES = [
    ("my checker on the bar", _board([(22, 14)], [(3, 15)], my_bar=1),
     False),
    ("their checker on the bar", _board([(22, 15)], [(3, 14)], opp_bar=1),
     False),
    ("before the last contact breaks", _board([(5, 1), (20, 14)],
                                              [(6, 1), (2, 14)]), False),
    ("the move that breaks it", _board([(7, 1), (20, 14)],
                                       [(6, 1), (2, 14)]), True),
    ("rearmost just passed", _board([(9, 15)], [(8, 15)]), True),
    ("rearmost side by side, not passed", _board([(8, 15)], [(9, 15)]),
     False),
    ("all my checkers off", _board([], [(3, 15)], my_off=15), True),
    ("all off but theirs on the bar", _board([], [(3, 14)], opp_bar=1,
                                             my_off=15), True),
    ("theirs all off but mine on the bar", _board([(3, 14)], [], my_bar=1,
                                                  opp_off=15), True),
    ("the opening", _board([(0, 2), (11, 5), (16, 3), (18, 5)],
                           [(23, 2), (12, 5), (7, 3), (5, 5)]), False),
]


@pytest.mark.parametrize("name,board,race", EDGES,
                         ids=[e[0].replace(" ", "-") for e in EDGES])
def test_the_class_rule_where_it_turns(name, board, race):
    """The port's rule on canonical boards and on their features, for
    either mover and the opponent's view, against the reference's, at
    the boards where the class turns."""
    for b in (board, Bd.opponent_view(board)):
        assert bool(Bd.is_race(b)) == race
        assert bool(R.race_of_boards(b)) == race
        for mover in (0, 1):
            x = F.encode_canonical(b, torch.tensor(mover))
            assert bool(F.is_race(x)) == race
            assert bool(R.race_of_features(x)) == race


@functools.lru_cache(maxsize=1)
def _played_boards(batch=16, plies=120, seed=6):
    """The legal afterstates of random self-play, every ply's kept ones:
    (boards (K, 52), their movers (K,))."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    es = bg_env.reset(gen, WILDBG.env, batch, device="cpu")
    boards, movers = [], []
    for _ in range(plies):
        m = es.after.shape[1]
        keep = torch.arange(m)[None, :] < es.n_moves[:, None]
        boards.append(es.after[keep])
        movers.append(es.turn.to(torch.int32)[:, None].expand(-1, m)[keep])
        act = (torch.rand(batch, generator=gen)
               * es.n_moves.clamp(min=1)).to(torch.int32)
        es, _ = bg_env.step_with_draws(es, act, bg_env.draw_step(gen, batch),
                                       WILDBG.env)
    return torch.cat(boards), torch.cat(movers)


def test_the_class_rule_on_played_positions():
    """Port and reference agree on every kept afterstate of random play,
    which holds both classes."""
    boards, movers = _played_boards()
    race = Bd.is_race(boards)
    assert torch.equal(race, R.race_of_boards(boards))
    x = F.encode_canonical(boards, movers)
    assert torch.equal(F.is_race(x), race)
    assert torch.equal(R.race_of_features(x), race)
    assert 0 < int(race.sum()) < race.numel()


def test_the_published_widths_leaves_and_draws():
    """``wildbg2net4096``: 24 leaves, the contact network's first as
    ``wildbg4096`` draws them (the same bits from the same seed), then the
    race network's in the same order; 476,026 parameters."""
    gen = torch.Generator()
    gen.manual_seed(3)
    model = TMLP.MLP(ROUTED.model, device="cpu", generator=gen)
    gen.manual_seed(3)
    single = TMLP.MLP(WILDBG.model, device="cpu", generator=gen)
    names = [n for n, _ in model.named_parameters()]
    layers = ("fc1", "fc2", "fc3", "action", "outcome", "score")
    assert names == [f"layers.{pre}{k}.{p}" for pre in ("", "race_")
                     for k in layers for p in ("weight", "bias")]
    assert sum(p.numel() for p in model.parameters()) == 476_026
    for (n, a), (m, b) in zip(model.named_parameters(),
                              single.named_parameters()):
        assert n == m and torch.equal(a, b)
    race = [p for n, p in model.named_parameters() if "race_" in n]
    assert not any(torch.equal(a, b) for a, b in
                   zip(race, single.parameters()))
    assert ROUTED == dataclasses.replace(
        WILDBG, name="wildbg2net4096",
        model=dataclasses.replace(WILDBG.model, race=True))


def _features():
    boards, movers = _played_boards()
    edges = torch.stack([b for _, b, _ in EDGES])
    boards = torch.cat([boards[::7], edges])
    movers = torch.cat([movers[::7], torch.arange(len(EDGES)) % 2])
    return F.encode_canonical(boards, movers)


def test_plain_routed_model_matches_the_reference():
    model = _model(1)
    params = D.weights_of(model)
    x = _features()
    logits, value = model(x)
    assert _gap(value, R.value(params, x)) <= TOL
    assert _gap(logits, R.logits(params, x)) <= TOL
    assert _gap(model.value(x), R.value(params, x)) <= TOL
    assert _gap(model.score(x), R.score(params, x)) <= TOL
    assert _gap(model.outcome_probs(x), R.outcome_probs(params, x)) <= TOL


def test_gradients_of_all_24_leaves_match_the_reference():
    model = _model(2)
    x = _features()
    logits, value = model(x)
    loss = (value ** 2).sum() + model.score(x).sum() + logits.sum()
    got = torch.autograd.grad(loss, list(model.parameters()))
    params = {k: v.clone().requires_grad_() for k, v in
              D.weights_of(model).items()}
    ref = ((R.value(params, x) ** 2).sum() + R.score(params, x).sum()
           + R.logits(params, x).sum())
    want = torch.autograd.grad(ref, list(params.values()))
    assert len(got) == 24
    for g, w in zip(got, want):
        assert _gap(g, w) <= GRAD_TOL
    assert all(bool(g.any()) for g in got)   # both classes in the batch


def _state(batch=6, seed=3, plies=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    es = bg_env.reset(gen, ROUTED.env, batch, device="cpu")
    for _ in range(plies):
        act = (torch.rand(batch, generator=gen)
               * es.n_moves.clamp(min=1)).to(torch.int32)
        es, _ = bg_env.step_with_draws(es, act, bg_env.draw_step(gen, batch),
                                       ROUTED.env)
    n = es.n_moves.to(torch.int32).clone()
    n[0] = 0
    n[1] = es.after.shape[1]
    return es.after, es.turn.to(torch.int32), n


def _raced(boards, share=0.4, seed=9):
    """A share of the slots made races: the mover's checkers on points
    12-23, the opponent's on 0-11, no bar."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    pick = torch.rand(boards.shape[:2], generator=gen) < share
    raced = boards.clone()
    raced[..., 0:12] = 0
    raced[..., 36:50] = 0
    return torch.where(pick[..., None], raced, boards)


@pytest.mark.parametrize("head", ["score", "value"])
@pytest.mark.parametrize("epilogue,opponent,sign", [
    ("logits", False, 1.0), ("masked", True, -1.0)])
def test_plain_routed_pass_matches_the_reference(head, epilogue, opponent,
                                                 sign):
    model = _model(5)
    boards, mover, n = _state()
    boards = _raced(boards)
    got = AE.evaluate(model, boards, mover, n, head, opponent=opponent,
                      epilogue=epilogue, sign=sign)
    want = R.afterstate(D.weights_of(model), boards, mover, n, head,
                        opponent, epilogue, sign)
    kept = want != AE.FLOOR
    assert torch.equal(got == AE.FLOOR, ~kept)
    assert _gap(got[kept], want[kept]) <= TOL


def test_contact_boards_alone_give_the_race_network_no_gradient():
    """Where no kept board and no position is a race, the race network's
    12 leaves get exactly zero gradients, through the afterstate pass and
    the state value."""
    model = _model(6)
    boards, mover, n = _state()
    n[1] = 1                  # every slot of row 1 would keep a zero board
    kept = AE._valid(n, boards.shape[1], "masked")
    assert not bool((Bd.is_race(boards) & kept).any())
    x = F.encode_canonical(boards[:, 0], mover)
    assert not bool(F.is_race(x).any())
    y = AE.evaluate(model, boards, mover, n, "score",
                    epilogue="masked").sum() + model.value(x).sum()
    grads = torch.autograd.grad(y, list(model.parameters()),
                                allow_unused=True)
    for (name, _), g in zip(model.named_parameters(), grads):
        if "race_" in name:
            assert g is None or not bool(g.any()), name


def test_equal_networks_are_wildbg4096_exactly():
    """With the race network's weights set to the contact network's, the
    routed model is the one-network model, bit for bit: values, scores,
    the pass."""
    model = _model(7)
    single = TMLP.MLP(dataclasses.replace(SMALL, race=False), device="cpu")
    with torch.no_grad():
        for name, lin in single.layers.items():
            lin.weight.copy_(model.layers[name].weight)
            lin.bias.copy_(model.layers[name].bias)
            model.layers["race_" + name].weight.copy_(lin.weight)
            model.layers["race_" + name].bias.copy_(lin.bias)
    x = _features()
    assert torch.equal(model(x)[0], single(x)[0])
    assert torch.equal(model.value(x), single.value(x))
    assert torch.equal(model.score(x), single.score(x))
    boards, mover, n = _state()
    boards = _raced(boards)
    assert torch.equal(AE.evaluate(model, boards, mover, n, "value"),
                       AE.evaluate(single, boards, mover, n, "value"))


def test_staged_routed_pieces_give_the_plain_pass_and_its_gradients():
    """The route, each group's ``afterstate_hidden_routed`` and
    ``dense_layers``, and their backwards (the kernels' contract, in their
    plain versions) compose to the plain routed pass and its autograd
    gradients; each group's count is its class's kept boards, tallied."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    model = _model(8)
    boards, mover, n = _state()
    boards = _raced(boards)
    (contact, rewards), (race, _) = [model.deep_weights("value", net)
                                     for net in AE.GROUPS]
    w = [p.detach().clone().requires_grad_() for p in contact + race]
    y = AE.afterstate_routed(boards, mover, n, w[:8], w[8:], rewards, True,
                             "masked", -1.0)
    grad = torch.randn(y.shape, generator=torch.Generator().manual_seed(8))
    want = torch.autograd.grad(y, w, grad)
    ops.zero_launches()
    route = AE.afterstate_route(boards, n, "masked")
    out, lim, slots = route
    kept = AE._valid(n, boards.shape[1], "masked")
    race_kept = kept & Bd.is_race(boards)
    assert torch.equal(lim[1], race_kept.sum(1, dtype=torch.int32))
    assert torch.equal(lim[0] + lim[1], kept.sum(1, dtype=torch.int32))
    got = []
    for group, ws in enumerate((contact, race)):
        (w1, b1), layers, head = AE._split([p.detach() for p in ws])
        h1, elem, count = AE.afterstate_hidden_routed(
            boards, mover, route, group, w1, b1, True)
        assert int(count) == int(lim[group].sum())
        acts = DN.dense_layers(h1, elem, count, out, layers, head, rewards,
                               -1.0, save=True)
        dpre, grads = DN.dense_layers_backward(h1, acts, elem, count, grad,
                                               layers, head, rewards, -1.0)
        got += [*AE.afterstate_hidden_backward_routed(
            boards, mover, route, group, dpre, w1.shape[0], True), *grads]
    assert AE.routed_rows() == {"contact": int(lim[0].sum()),
                                "race": int(lim[1].sum())}
    ops.zero_launches()
    assert AE.routed_rows() == {"contact": 0, "race": 0}
    assert _gap(out, y.detach()) <= TOL
    for g, ww in zip(got, want):
        assert g.shape == ww.shape and _gap(g, ww) <= GRAD_TOL


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)


def test_a_tf32_product_fails_the_tolerances():
    """One product of the race network in TF32 (fc2's, both operands
    rounded to 10 bits) moves the values of race positions past 5 times
    the tolerance above, and its weight rounded to TF32 moves the
    gradients past 10 times theirs."""
    model = _model(9, dataclasses.replace(ROUTED.model, action_size=9))
    params = D.weights_of(model)
    # random features of race positions: player 0 on points 12-23 and
    # player 1 on 0-11 alone, no bar
    x = torch.rand((256, 198), generator=torch.Generator().manual_seed(10))
    x[:, 0:48] = 0
    x[:, 98 + 48:194] = 0
    x[:, [96, 194]] = 0
    assert bool(F.is_race(x).all())
    _, race = R.split(params)
    want = R.value(params, x)
    h1 = torch.relu(D._linear(race["fc1.weight"], race["fc1.bias"], x))
    h2 = torch.relu(torch.matmul(_tf32(h1), _tf32(race["fc2.weight"]).t())
                    + race["fc2.bias"])
    h3 = torch.relu(D._linear(race["fc3.weight"], race["fc3.bias"], h2))
    z = D._linear(race["outcome.weight"], race["outcome.bias"], h3)
    tf32_value = (torch.softmax(z, -1)
                  * torch.tensor(TMLP.OUTCOME_REWARDS)).sum(-1)
    assert _gap(tf32_value, want) > 5 * TOL    # about 9 TOL
    rounded = dict(params, **{"race_fc2.weight": _tf32(
        params["race_fc2.weight"])})
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    g32 = torch.autograd.grad(R.value(p, x).sum(), list(p.values()),
                              allow_unused=True)
    q = {k: v.clone().requires_grad_() for k, v in rounded.items()}
    g_tf = torch.autograd.grad(R.value(q, x).sum(), list(q.values()),
                               allow_unused=True)
    assert max(_gap(a, b) for a, b in zip(g_tf, g32)
               if a is not None) > 10 * GRAD_TOL


def test_train_step_of_the_routed_model():
    """``learner.train_step`` of ``wildbg2net4096``'s model at a tiny
    batch, its games played on into races first: every leaf the policy
    and the value reach moves (the action heads are unused), the optimizer
    takes the 24 leaves."""
    ppo = dataclasses.replace(ROUTED.ppo, num_envs=8, t_horizon=4,
                              num_minibatches=2, num_epochs=1)
    ts = learner.init_train_state(0, SMALL, ppo, device="cpu")
    es = bg_env.reset(ts.gen, ROUTED.env, 8, device="cpu")
    pts = es.points.clone()
    pts[:4] = 0
    pts[:4, 0, 20:24] = torch.tensor([4, 4, 4, 3], dtype=pts.dtype)
    pts[:4, 1, 0:4] = torch.tensor([3, 4, 4, 4], dtype=pts.dtype)
    es = bg_env.make_state(pts, es.bar, es.off, es.turn, es.dice,
                           ROUTED.env)
    before = [p.detach().clone() for p in ts.model.parameters()]
    ts, es, metrics = learner.train_step(ts, es, ROUTED.env, SMALL, ppo)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    moved = {n: not torch.equal(a, b) for a, (n, b) in
             zip(before, ts.model.named_parameters())}
    assert moved == {n: "action" not in n for n in moved}
    assert len(ts.opt_state.mu) == 24 and int(ts.opt_state.count) == 2


def test_the_optimizer_takes_the_24_leaves(monkeypatch):
    """The optimizer's table holds the routed model's 24 leaves (25 raise):
    on the CPU ``adam_update`` is ``adam_update_plain``'s arithmetic, and
    its card path passes all 24 leaves' pointers and blocks in one call."""
    model = TMLP.MLP(ROUTED.model, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    params = list(model.parameters())
    assert len(params) == 24 <= AD.MAX_LEAVES
    gen = torch.Generator().manual_seed(2)
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    mu = [1e-2 * torch.randn(p.shape, generator=gen) for p in params]
    nu = [1e-4 * torch.rand(p.shape, generator=gen) for p in params]
    count = torch.tensor(3, dtype=torch.int32)
    want_p = [p.detach().clone() for p in params]
    want = AD.adam_update_plain(want_p, grads, count, mu, nu, 1e-3, 0.5)
    got_p = [p.detach().clone() for p in params]
    got = AD.adam_update(got_p, grads, count, mu, nu, 1e-3, 0.5)
    assert torch.equal(got[0], want[0])
    for a, b in zip([*got_p, *got[1], *got[2]],
                    [*want_p, *want[1], *want[2]]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="1 to 24 leaves"):
        AD.adam_update(got_p + got_p[:1], grads + grads[:1], count,
                       mu + mu[:1], nu + nu[:1], 1e-3, 0.5)
    calls = []
    monkeypatch.setattr(AD, "_on_card", lambda x: True)
    monkeypatch.setattr(AD, "_launch",
                        lambda dev, *args: calls.append(args) or 0)
    AD.adam_update(got_p, grads, count, mu, nu, 1e-3, 0.5)
    (args,) = calls
    sizes = [p.numel() for p in params]
    assert [list(t) for t in args[:4]] == [
        [t.data_ptr() for t in ts] for ts in (got_p, grads, mu, nu)]
    assert list(args[6]) == sizes and args[8] == 24
    assert list(args[7]) == AD.block_layout(sizes)
    assert np.sum(sizes) == 476_026
