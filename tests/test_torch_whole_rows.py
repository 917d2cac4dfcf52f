"""Whole rows on the CPU: under the ``logits`` epilogue a row with n <= 0
whose M boards all equal slot 0, byte for byte, is one kept board whose
value stands for all M slots (``ops/afterstate.py``'s docstring).  Here:
the rule's plain version (``collapsed_plain``, ``row_lims_plain``) on
made-up rows; the route's plain layout of such rows; the plain versions of
the kernels' staged pieces (the first layer and the dense layers over the
kept boards, the route, their backwards) against the full plain passes,
which evaluate every slot: the values bit for bit, the gradients (the M
cotangents summed once instead of M gradients summed) within 1e-6 of their
scale (the largest entry, at least 1, as ``test_torch_deep_mlp.py``'s, whose
staged pieces are held to 1e-5); and the contract of movegen that the
traffic relies on: a row with no legal move holds M zero boards.  The
kernels on the card: ``tests/test_torch_cuda.py -k whole``."""

import dataclasses

import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch import ops
from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE
from mlp_ppo_2ply_p3_tpu_torch.ops import dense as DN
from mlp_ppo_2ply_p3_tpu_torch.utils import config as TCONF

GRAD_TOL = 1e-6
ROUTED = TCONF.get_preset("wildbg2net4096")
# the routed model at small widths (both networks)
SMALL = dataclasses.replace(ROUTED.model, hidden_size=17, trunk=(13, 11),
                            action_size=9)
M = 12


def _contact_board():
    """A contact position: the mover on points 5 and 12, the opponent on
    points 8 (index 32) and 20 (index 44)."""
    b = torch.zeros(52, dtype=torch.int8)
    b[5], b[12], b[32], b[44], b[50] = 3, 2, 4, 1, 5
    return b


def made_up_rows(seed=0):
    """(boards (10, M, 52) int8, mover, n, the rows that are whole under
    ``logits``): rows with n = 0 holding M zero boards, M copies of one
    contact board, M copies of a race board; n = -1 with M copies; n = 0
    with boards that differ (one of them in its last byte only); n = M
    and n = 1 with M copies (kept as they are: n > 0); random rows."""
    gen = torch.Generator().manual_seed(seed)
    rand = torch.randint(0, 5, (10, M, 52), generator=gen).to(torch.int8)
    contact = _contact_board()
    race = torch.zeros(52, dtype=torch.int8)
    race[20], race[30], race[51] = 5, 4, 6
    boards = rand.clone()
    boards[0] = 0
    boards[1] = contact
    boards[2] = race
    boards[3] = contact
    boards[4] = rand[4]
    boards[5] = contact
    boards[5, 7, 51] = 1
    boards[6] = contact
    boards[7] = contact
    n = torch.tensor([0, 0, 0, -1, 0, 0, M, 1, 5, 3], dtype=torch.int32)
    mover = torch.randint(0, 2, (10,), generator=gen).to(torch.int32)
    whole = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0, 0, 0], dtype=torch.bool)
    return boards, mover, n, whole


@pytest.mark.parametrize("epilogue", ["logits", "masked", "min"])
def test_the_rule_of_a_whole_row(epilogue):
    """Whole: under ``logits``, n <= 0 and every board slot 0's, byte for
    byte; never under ``masked`` or ``min``.  Each row's entry: ``WHOLE``,
    else the epilogue's kept slots; the kept set keeps slot 0 alone of a
    whole row; an empty slot axis has no whole row."""
    boards, _, n, whole = made_up_rows()
    got = AE.collapsed_plain(boards, n, epilogue)
    want = whole if epilogue == "logits" else torch.zeros_like(whole)
    assert torch.equal(got, want)
    lim = AE.row_lims_plain(boards, n, epilogue)
    valid = AE._valid(n, M, epilogue).sum(1, dtype=torch.int32)
    assert torch.equal(lim, torch.where(want, AE.WHOLE, valid))
    kept = AE._kept(boards, n, epilogue)
    assert torch.equal(kept.sum(1, dtype=torch.int32),
                       torch.where(want, 1, valid))
    assert bool(kept[want, 0].all())
    assert not AE.collapsed_plain(boards[:, :0], n, epilogue).any()
    one = AE.collapsed_plain(boards[:, :1], n, epilogue)
    assert torch.equal(one, (n <= 0) if epilogue == "logits"
                       else torch.zeros_like(whole))


def test_the_route_lays_out_one_board_of_a_whole_row():
    """``afterstate_route``'s plain layout: a whole row's entry is
    ``WHOLE`` in slot 0's class (zero boards are a race, a contact board
    contact) with slot 0 its one slot, and 0 in the other; every other row
    is laid out as the epilogue's kept slots by class; the group orders
    mark a whole row's board ``~(r m)``; the CPU route adds the whole rows
    to ``collapsed_rows``."""
    boards, mover, n, whole = made_up_rows(1)
    race = Bd.is_race(boards)
    ops.zero_launches()
    out, lim, slots = AE.afterstate_route(boards, n, "logits")
    assert AE.collapsed_rows() == int(whole.sum())
    ops.zero_launches()
    assert AE.collapsed_rows() == 0
    assert bool((out == AE.FLOOR).all())
    valid = AE._valid(n, M, "logits")
    for c, mask in enumerate((valid & ~race, valid & race)):
        cls = race[:, 0] if c else ~race[:, 0]
        assert torch.equal(lim[c, whole],
                           torch.where(cls[whole], AE.WHOLE, 0).int())
        assert torch.equal(lim[c, ~whole],
                           mask[~whole].sum(1, dtype=torch.int32))
        for r in range(boards.shape[0]):
            k = 1 if int(lim[c, r]) == AE.WHOLE else int(lim[c, r])
            want = (torch.zeros(k, dtype=torch.long) if whole[r]
                    else mask[r].nonzero()[:, 0])
            assert torch.equal(slots[c, r * M:r * M + k].long(), want)
        order = AE._group_order(lim[c], slots[c], M)
        marked = order[order < 0]
        assert torch.equal(torch.sort(~marked).values,
                           (torch.nonzero(whole & cls)[:, 0] * M).int())
    assert torch.equal(lim.clamp(min=0).sum(0) + (lim == AE.WHOLE).sum(0),
                       AE._kept(boards, n, "logits").sum(1))


def test_the_collapse_tally_on_the_cpu():
    """``afterstate_collapse`` on the CPU: the plain entries, the whole rows
    added to the tally (zeroed by ``ops.zero_launches``); None under the
    ``masked`` and ``min`` epilogues."""
    boards, _, n, whole = made_up_rows(2)
    ops.zero_launches()
    lim = AE.afterstate_collapse(boards, n, "logits")
    assert torch.equal(lim, AE.row_lims_plain(boards, n, "logits"))
    AE.afterstate_collapse(boards, n, "logits")
    assert AE.collapsed_rows() == 2 * int(whole.sum())
    assert AE.afterstate_collapse(boards, n, "masked") is None
    assert AE.afterstate_collapse(boards, n, "min") is None
    ops.zero_launches()
    assert AE.collapsed_rows() == 0


def _model(seed):
    return TMLP.MLP(SMALL, device="cpu",
                    generator=torch.Generator().manual_seed(seed))


def _gap(got, want):
    """Largest difference over the scale of ``want`` (its largest entry,
    at least 1)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1.0)


def _shallow_kept_pass(boards, mover, n, w, opponent, sign):
    """The shallow pass over the kept boards alone, a whole row's slot 0
    written into its M slots, differentiable in ``w``: what the kernels
    compute, in plain torch."""
    r, m, _ = boards.shape
    kept = AE._kept(boards, n, "logits")
    elem = kept.reshape(-1).nonzero()[:, 0]
    y = AE._head(AE._features_of(boards, mover, elem, opponent), *w)
    flat = torch.full((r * m,), AE.FLOOR, dtype=torch.float32)
    flat = flat.index_put((elem,), sign * y)
    out = flat.view(r, m)
    whole = AE.collapsed_plain(boards, n, "logits")
    return torch.where(whole[:, None], out[:, :1], out)


def _staged_deep(boards, mover, n, weights, rewards, opponent, sign, grad):
    """(values, gradients) of the deep pass's staged plain pieces."""
    (w1, b1), layers, head = AE._split(weights)
    out, h1, elem, count = AE.afterstate_hidden(boards, mover, n, w1, b1,
                                                opponent, "logits")
    acts = DN.dense_layers(h1, elem, count, out, layers, head, rewards, sign,
                           save=True)
    dpre, grads = DN.dense_layers_backward(h1, acts, elem, count, grad,
                                           layers, head, rewards, sign)
    dw1, db1 = AE.afterstate_hidden_backward(boards, mover, n, dpre,
                                             w1.shape[0], opponent, "logits")
    return out, [dw1, db1, *grads]


def _staged_routed(boards, mover, n, weights, rewards, opponent, sign, grad):
    """(values, gradients) of the routed pass's staged plain pieces."""
    k = len(weights) // 2
    route = AE.afterstate_route(boards, n, "logits")
    out, got = route[0], []
    for group in range(len(AE.GROUPS)):
        (w1, b1), layers, head = AE._split(weights[group * k:(group + 1) * k])
        h1, elem, count = AE.afterstate_hidden_routed(
            boards, mover, route, group, w1, b1, opponent)
        acts = DN.dense_layers(h1, elem, count, out, layers, head, rewards,
                               sign, save=True)
        dpre, grads = DN.dense_layers_backward(h1, acts, elem, count, grad,
                                               layers, head, rewards, sign)
        got += [*AE.afterstate_hidden_backward_routed(
            boards, mover, route, group, dpre, w1.shape[0], opponent),
            *grads]
    return out, got


@pytest.mark.parametrize("form", ["shallow", "deep", "routed"])
@pytest.mark.parametrize("opponent,sign", [(False, 1.0), (True, -1.0)])
def test_kept_boards_give_the_full_pass(form, opponent, sign):
    """Over the kept boards alone (a whole row's slot 0 for its M slots)
    the plain pieces give the full plain pass, which evaluates every
    slot: the values bit for bit, the gradients (the row's M cotangents
    summed once) within 1e-6 of their scale; the made-up rows, four of
    ten whole, with every kind of whole row."""
    boards, mover, n, whole = made_up_rows(3)
    model = _model(4)
    grad = torch.randn(boards.shape[:2],
                       generator=torch.Generator().manual_seed(5))
    if form == "shallow":
        model = TMLP.MLP(TMLP.ModelConfig(hidden_size=17), device="cpu",
                         generator=torch.Generator().manual_seed(4))
        fc1, score = model.layers["fc1"], model.layers["score"]
        w = [p.detach().clone().requires_grad_() for p in (
            fc1.weight, fc1.bias, score.weight, score.bias)]
        full = AE.afterstate_eval_plain(boards, mover, n, *w, opponent,
                                        "logits", sign)
        got = _shallow_kept_pass(boards, mover, n, w, opponent, sign)
        got_g = torch.autograd.grad(got, w, grad)
    else:
        nets = AE.GROUPS if form == "routed" else AE.GROUPS[:1]
        weights, rewards = [], None
        for net in nets:
            ws, rewards = model.deep_weights("value", net)
            weights += [p.detach() for p in ws]
        w = [p.clone().requires_grad_() for p in weights]
        plain = (AE.afterstate_routed_plain if form == "routed"
                 else AE.afterstate_deep_plain)
        full = plain(boards, mover, n, w, rewards, opponent, "logits", sign)
        staged = _staged_routed if form == "routed" else _staged_deep
        got, got_g = staged(boards, mover, n, weights, rewards, opponent,
                            sign, grad)
    want_g = torch.autograd.grad(full, w, grad)
    assert torch.equal(got.detach(), full.detach())
    assert bool((got[whole] == got[whole, :1]).all())
    for g, want in zip(got_g, want_g):
        assert g.shape == want.shape and _gap(g, want) <= GRAD_TOL


def test_a_row_with_no_move_holds_zero_boards():
    """After random play on the CPU (``bg_env.step_with_draws`` at
    ``wildbg4096``'s movegen), every row with no legal move holds M zero
    boards in its slots, so that each is a whole row under the ``logits``
    epilogue, and no row with a move is whole."""
    cfg = TCONF.get_preset("wildbg4096").env
    gen = torch.Generator().manual_seed(5)
    batch, seen = 96, 0
    es = bg_env.reset(gen, cfg, batch, device="cpu")
    for _ in range(32):
        act = (torch.rand(batch, generator=gen)
               * es.n_moves.clamp(min=1)).to(torch.int32)
        es, _ = bg_env.step_with_draws(es, act, bg_env.draw_step(gen, batch),
                                       cfg)
        none = es.n_moves == 0
        seen += int(none.sum())
        assert bool((es.after[none] == 0).all())
        assert torch.equal(AE.collapsed_plain(
            es.after, es.n_moves.to(torch.int32), "logits"), none)
    assert seen > 0


def test_the_card_tests_whole_row_inputs():
    """The inputs the card tests hold whole rows to
    (``tests/test_torch_cuda.py::whole_row_inputs``), here on the CPU: the
    five kinds of row in turn, the first two whole by the plain rule, the
    third (n = 0, boards that differ) and the fourth (n = M, one board) not;
    the same tensors from the same seed; and the plain pass over them gives
    each whole row one value in all its slots."""
    from .test_torch_cuda import alone, whole_row_inputs

    cpu = torch.device("cpu")
    (boards, mover, n, *w), whole = whole_row_inputs(cpu, 3, 15, 13, 16)
    assert torch.equal(whole, torch.arange(15) % 5 <= 1)
    assert torch.equal(n[torch.arange(15) % 5 == 3], torch.full((3,), 13,
                                                               dtype=n.dtype))
    assert not bool((boards[2::5] == boards[2::5, :1]).all())
    assert not bool(boards[::5].any())
    again, _ = whole_row_inputs(cpu, 3, 15, 13, 16)
    assert all(torch.equal(a, b) for a, b in zip([boards, mover, n, *w],
                                                 again))
    assert torch.equal(alone(n, whole), torch.where(whole, 1, n))
    out = AE.afterstate_eval_plain(boards, mover, n, *w, False, "logits",
                                   1.0)
    assert bool((out[whole] == out[whole, :1]).all())
