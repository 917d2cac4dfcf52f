"""The deep network (an ``MLP`` with a ``trunk`` and the outcome head) on
the CPU: wildbg's evaluation network at its published widths against the
plain reference of ``models/deep_reference.py``.

Tolerances: the port and the reference compute the same float32 products
in a different order of sums (``Fn.linear`` against ``matmul`` plus the
bias), so each result is held to 1e-6 of its scale (its largest entry, at
least 1; 1e-5 for gradients, summed over many more rows).  A single TF32
product (operands rounded to 10 bits) moves them by 1e-4 to 1e-3 of their
scale, which ``test_a_tf32_product_fails_the_tolerances`` shows."""

import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models import deep_reference as R
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE
from mlp_ppo_2ply_p3_tpu_torch.ops import dense as DN
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.utils import checkpoint as ckpt
from mlp_ppo_2ply_p3_tpu_torch.utils import config as TCONF

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-6
GRAD_TOL = 1e-5
WILDBG = TCONF.get_preset("wildbg4096")


def _model(seed=0, cfg=WILDBG.model):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return TMLP.MLP(cfg, device="cpu", generator=gen)


def _gap(got, want):
    """Largest difference over the scale of ``want`` (at least 1)."""
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    diff = (got.detach() - want.detach()).abs()
    return float(diff.max()) / scale if want.numel() else 0.0


def _state(batch=6, seed=3):
    gen = torch.Generator()
    gen.manual_seed(seed)
    es = bg_env.reset(gen, WILDBG.env, batch, device="cpu")
    n = es.n_moves.to(torch.int32).clone()
    n[0] = 0                          # a row that keeps nothing (or all)
    n[1] = es.after.shape[1]          # a row that keeps every slot
    return es.after, es.turn.to(torch.int32), n


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)


def test_the_published_widths_and_leaves():
    model = _model()
    names = [n for n, _ in model.named_parameters()]
    assert names == [f"layers.{k}.{p}" for k in
                     ("fc1", "fc2", "fc3", "action", "outcome", "score")
                     for p in ("weight", "bias")]
    assert sum(p.numel() for p in model.parameters()) == 238_013
    assert len(names) == 12 and model.cfg.widths == (300, 250, 200)
    assert TMLP.OUTCOME_REWARDS == (1.0, 1.5, 2.0, -1.0, -1.5, -2.0)


def test_forward_matches_the_reference():
    model = _model()
    params = R.weights_of(model)
    x = torch.rand((64, 198), generator=torch.Generator().manual_seed(1))
    logits, value = model(x)
    assert _gap(value, R.value(params, x)) <= TOL
    assert _gap(logits, R.logits(params, x)) <= TOL
    assert _gap(model.score(x), R.score(params, x)) <= TOL
    assert _gap(model.value(x), R.value(params, x)) <= TOL
    probs = model.outcome_probs(x)
    assert _gap(probs, R.outcome_probs(params, x)) <= TOL
    assert torch.allclose(probs.sum(-1), torch.ones(64))


def test_gradients_match_the_reference():
    model = _model(2)
    x = torch.rand((32, 198), generator=torch.Generator().manual_seed(4))
    logits, value = model(x)
    loss = (value ** 2).sum() + model.score(x).sum() + logits.sum()
    got = torch.autograd.grad(loss, list(model.parameters()))
    params = {k: v.clone().requires_grad_() for k, v in
              R.weights_of(model).items()}
    ref = ((R.value(params, x) ** 2).sum() + R.score(params, x).sum()
           + R.logits(params, x).sum())
    want = torch.autograd.grad(ref, list(params.values()))
    for g, w in zip(got, want):
        assert _gap(g, w) <= GRAD_TOL


@pytest.mark.parametrize("head", ["score", "value"])
@pytest.mark.parametrize("epilogue,opponent,sign", [
    ("logits", False, 1.0), ("masked", True, -1.0), ("masked", False, 1.0)])
def test_plain_deep_pass_matches_the_reference(head, epilogue, opponent,
                                               sign):
    model = _model(5)
    boards, mover, n = _state()
    got = AE.evaluate(model, boards, mover, n, head, opponent=opponent,
                      epilogue=epilogue, sign=sign)
    want = R.afterstate(R.weights_of(model), boards, mover, n, head,
                        opponent, epilogue, sign)
    kept = want != AE.FLOOR
    assert torch.equal(got == AE.FLOOR, ~kept)
    assert _gap(got[kept], want[kept]) <= TOL
    if epilogue == "logits":
        assert bool(kept[0].all())      # n = 0 keeps every raw value
    else:
        assert not bool(kept[0].any())  # masked: nothing where n = 0
    assert bool(kept[1].all())          # n = M


def test_plain_deep_pass_at_no_and_every_slot():
    model = _model(6)
    boards, mover, n = _state(4)
    m = boards.shape[1]
    for rows in (torch.zeros_like(n), torch.full_like(n, m)):
        got = AE.evaluate(model, boards, mover, rows, "value",
                          epilogue="masked")
        want = R.afterstate(R.weights_of(model), boards, mover, rows,
                            "value", epilogue="masked")
        assert torch.equal(got == AE.FLOOR, want == AE.FLOOR)
        kept = want != AE.FLOOR
        assert _gap(got[kept], want[kept]) <= TOL


def test_staged_pieces_give_the_plain_pass_and_its_gradients():
    """``afterstate_hidden``, ``dense_layers`` and their backwards (the
    kernels' contract, in their plain versions) compose to the plain pass
    and to its autograd gradients."""
    model = _model(7)
    boards, mover, n = _state()
    weights, rewards = model.deep_weights("value")
    w = [p.detach().clone().requires_grad_() for p in weights]
    y = AE.afterstate_deep(boards, mover, n, w, rewards, True, "masked",
                           -1.0)
    grad = torch.randn(y.shape, generator=torch.Generator().manual_seed(8))
    want = torch.autograd.grad(y, w, grad)
    (w1, b1), layers, head = AE._split([p.detach() for p in weights])
    out, h1, elem, count = AE.afterstate_hidden(boards, mover, n, w1, b1,
                                                True, "masked")
    assert int(count) == int(n.clamp(0, boards.shape[1]).sum())
    acts = DN.dense_layers(h1, elem, count, out, layers, head, rewards,
                           -1.0, save=True)
    assert _gap(out, y.detach()) <= TOL
    assert [a.shape for a in acts] == [(h1.shape[0], 252), (h1.shape[0],
                                                            200)]
    dpre, grads = DN.dense_layers_backward(h1, acts, elem, count, grad,
                                           layers, head, rewards, -1.0)
    dw1, db1 = AE.afterstate_hidden_backward(boards, mover, n, dpre, 300,
                                             True, "masked")
    for g, ww in zip([dw1, db1, *grads], want):
        assert g.shape == ww.shape and _gap(g, ww) <= GRAD_TOL


def test_a_tf32_product_fails_the_tolerances():
    """One product of the trunk in TF32 (both operands rounded to 10 bits)
    moves the values and gradients past the tolerances above."""
    model = _model(9)
    params = R.weights_of(model)
    x = torch.rand((256, 198), generator=torch.Generator().manual_seed(10))
    want = R.value(params, x)
    rounded = dict(params, **{"fc2.weight": _tf32(params["fc2.weight"])})
    h1 = torch.relu(R._linear(params["fc1.weight"], params["fc1.bias"], x))
    h2 = torch.relu(torch.matmul(_tf32(h1), rounded["fc2.weight"].t())
                    + params["fc2.bias"])
    h3 = torch.relu(R._linear(params["fc3.weight"], params["fc3.bias"], h2))
    z = R._linear(params["outcome.weight"], params["outcome.bias"], h3)
    r = torch.tensor(TMLP.OUTCOME_REWARDS)
    tf32_value = (torch.softmax(z, -1) * r).sum(-1)
    assert _gap(tf32_value, want) > 10 * TOL
    w = [p.detach().clone().requires_grad_() for p in
         model.deep_weights("score")[0]]
    boards, mover, n = _state()
    g32 = torch.autograd.grad(AE.afterstate_deep(boards, mover, n, w).sum(),
                              w)
    w_tf = [_tf32(p.detach()).requires_grad_() if i == 2 else
            p.detach().clone().requires_grad_() for i, p in enumerate(w)]
    g_tf = torch.autograd.grad(AE.afterstate_deep(boards, mover, n,
                                                  w_tf).sum(), w_tf)
    assert max(_gap(a, b) for a, b in zip(g_tf, g32)) > 10 * GRAD_TOL


def _split_product(x, w):
    """x w^T as ``csrc/dense.cu`` computes it: both operands as three bf16
    limbs (``split_bf16``), the six limb products x_i w_j with i + j <= 2
    (each exact in float32) summed in float32, smallest first; the three
    with i + j > 2 left out."""
    xs = [p.float() for p in AE.split_bf16(x)]
    ws = [p.float() for p in AE.split_bf16(w)]
    kept = sorted(((i, j) for i in range(3) for j in range(3) if i + j <= 2),
                  key=lambda ij: -sum(ij))
    out = torch.zeros((x.shape[0], w.shape[0]))
    for i, j in kept:
        out = out + torch.matmul(xs[i], ws[j].t())
    return out


def _tf32_product(x, w):
    return torch.matmul(_tf32(x), _tf32(w).t())


class _LinearWithInputGrad(torch.autograd.Function):
    """``x w^T + b`` whose input gradient, dpre = g w (the backward's W^T
    dpre), is ``product(g, w^T)``; the weight's gradient in float32."""

    @staticmethod
    def forward(ctx, x, w, b, product):
        ctx.save_for_backward(x, w)
        ctx.product = product
        return torch.matmul(x, w.t()) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (ctx.product(g, w.t().contiguous()), torch.matmul(g.t(), x),
                g.sum(0), None)


def _value_with(params, x, layer, product):
    """wildbg's value with ``layer``'s W^T dpre taken by ``product``."""
    h = x
    for i in (1, 2, 3):
        w, b = params[f"fc{i}.weight"], params[f"fc{i}.bias"]
        pre = (_LinearWithInputGrad.apply(h, w, b, product)
               if f"fc{i}" == layer else R._linear(w, b, h))
        h = torch.relu(pre)
    z = R._linear(params["outcome.weight"], params["outcome.bias"], h)
    return (torch.softmax(z, -1) * torch.tensor(TMLP.OUTCOME_REWARDS)).sum(-1)


@pytest.mark.parametrize("product", ["forward fc2", "backward fc3 W^T dpre"])
def test_a_split_bf16_product_meets_the_tolerances(product):
    """One product of the trunk in the dense kernels' split form (three bf16
    limbs an operand, the six limb products with i + j <= 2) keeps the
    values within TOL and the gradients within GRAD_TOL, where the same
    product in TF32 moves them past the tolerance: the forward's fc2 (h2 =
    relu(W2 h1 + b2)) and the backward's W3^T dpre3.  (The split reads
    about 2e-7 of the gradients' scale, TF32 about 1e-4.)"""
    model = _model(9)
    params = R.weights_of(model)
    x = torch.rand((256, 198), generator=torch.Generator().manual_seed(10))
    if product.startswith("forward"):
        want = R.value(params, x)
        h1 = torch.relu(R._linear(params["fc1.weight"], params["fc1.bias"],
                                  x))

        def value(prod):
            h2 = torch.relu(prod(h1, params["fc2.weight"])
                            + params["fc2.bias"])
            h3 = torch.relu(R._linear(params["fc3.weight"],
                                      params["fc3.bias"], h2))
            z = R._linear(params["outcome.weight"], params["outcome.bias"],
                          h3)
            r = torch.tensor(TMLP.OUTCOME_REWARDS)
            return (torch.softmax(z, -1) * r).sum(-1)

        assert _gap(value(_split_product), want) <= TOL
        assert _gap(value(_tf32_product), want) > TOL
        return
    cot = torch.randn((256,), generator=torch.Generator().manual_seed(11))

    def grads(prod):
        w = {k: v.clone().requires_grad_() for k, v in params.items()}
        used = [w[f"fc{i}.{p}"] for i in (1, 2, 3) for p in ("weight", "bias")]
        y = (_value_with(w, x, "fc3", prod) * cot).sum()
        return torch.autograd.grad(y, used)

    want = grads(lambda g, wt: torch.matmul(g, wt.t()))
    split = grads(_split_product)
    tf32 = grads(_tf32_product)
    assert max(_gap(a, b) for a, b in zip(split, want)) <= GRAD_TOL
    assert max(_gap(a, b) for a, b in zip(tf32, want)) > GRAD_TOL


def test_limb_scratch_pads_rows_to_8_and_columns_to_16():
    """The weights' limbs that a dense call splits into scratch: three of
    each W_l (rows padded to 8, columns to 16), W_l^T's for the backward;
    wildbg's 300 -> 250 -> 200 costs 304 and 256 columns, not 512."""
    widths = (300, 250, 200)
    assert DN.limb_entries(widths) == 3 * (256 * 304 + 200 * 256)
    assert DN.limb_entries(widths, backward=True) == \
        3 * (304 * 256 + 256 * 208)
    assert DN.limb_entries((1, 1)) == 3 * 8 * 16
    assert DN.TILE == 128


def test_wgrad_partials_are_a_slab_of_every_layer_a_slice():
    """The weight gradient's partial sums in scratch: a slab of every
    dense layer's weights and biases for each of the 132 row slices (a
    whole number of waves on 132 SMs for any layer); wildbg's 300 -> 250
    -> 200 keeps 132 x (250 x 301 + 200 x 251) floats, 66 MB."""
    widths = (300, 250, 200)
    assert DN.SLICES == 132
    assert DN.layer_entries(widths) == 250 * 301 + 200 * 251
    assert DN.wgrad_partials(widths) == 132 * 125450 == 16559400
    assert DN.wgrad_partials((1, 1)) == 132 * 2


def test_min_and_bf16_raise_with_a_trunk():
    model = _model()
    boards, mover, n = _state()
    with pytest.raises(NotImplementedError, match="queue 6, item C9"):
        AE.evaluate(model, boards, mover, n, "value", epilogue="min")
    bf16 = dataclasses.replace(WILDBG.model, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="queue 6, item C10"):
        TMLP.MLP(bf16, device="cpu")
    w = [p.detach().bfloat16() for p in model.deep_weights("score")[0]]
    with pytest.raises(NotImplementedError, match="queue 6, item C10"):
        AE.afterstate_deep(boards, mover, n, w)


@pytest.mark.parametrize("cfg", [
    TMLP.ModelConfig(hidden_size=300, trunk=(250, 0)),
    TMLP.ModelConfig(hidden_size=300, trunk=(-1,)),
    TMLP.ModelConfig(outcome=True)])
def test_refuses_a_trunk_no_pass_computes(cfg):
    with pytest.raises(ValueError):
        TMLP.MLP(cfg, device="cpu")


def test_train_step_of_wildbg4096():
    ppo = dataclasses.replace(WILDBG.ppo, num_envs=8, t_horizon=4,
                              num_minibatches=2, num_epochs=2)
    ts = learner.init_train_state(0, WILDBG.model, ppo, device="cpu")
    es = bg_env.reset(ts.gen, WILDBG.env, 8, device="cpu")
    before = [p.detach().clone() for p in ts.model.parameters()]
    ts, es, metrics = learner.train_step(ts, es, WILDBG.env, WILDBG.model,
                                         ppo)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    moved = {n: not torch.equal(a, b) for a, (n, b) in
             zip(before, ts.model.named_parameters())}
    # the action head is unused by the afterstate policy: zero gradients
    assert moved == {n: "action" not in n for n in moved}
    assert int(ts.opt_state.count) == 4


def test_deep_checkpoint_saves_and_resumes(tmp_path):
    ppo = dataclasses.replace(WILDBG.ppo, num_envs=8, t_horizon=4,
                              num_minibatches=2, num_epochs=1)
    ts = learner.init_train_state(1, WILDBG.model, ppo, device="cpu")
    es = bg_env.reset(ts.gen, WILDBG.env, 8, device="cpu")
    ts, es, _ = learner.train_step(ts, es, WILDBG.env, WILDBG.model, ppo)
    path = ckpt.save(str(tmp_path / "ckpt_1.npz"), (ts, es))
    fresh = learner.init_train_state(2, WILDBG.model, ppo, device="cpu")
    got, got_es = ckpt.restore(path, (fresh, bg_env.reset(
        fresh.gen, WILDBG.env, 8, device="cpu")))
    for a, b in zip(got.model.parameters(), ts.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(got.opt_state.mu + got.opt_state.nu,
                    ts.opt_state.mu + ts.opt_state.nu):
        assert torch.equal(a, b)
    a_ts, _, a_m = learner.train_step(got, got_es, WILDBG.env, WILDBG.model,
                                      ppo)
    b_ts, _, b_m = learner.train_step(ts, es, WILDBG.env, WILDBG.model, ppo)
    assert all(torch.equal(a_m[k], b_m[k]) for k in a_m)


def test_one_layer_models_are_unchanged():
    """The defaults keep the one-layer MLP: its leaves, their draws in
    order (fc1, action, value, score; weight before bias) and its outputs,
    bit for bit as the composition written out here."""
    cfg = TMLP.ModelConfig(hidden_size=32, action_size=64)
    model = _model(11, cfg)
    assert [n for n, _ in model.named_parameters()] == [
        f"layers.{k}.{p}" for k in TMLP.HEADS for p in ("weight", "bias")]
    gen = torch.Generator()
    gen.manual_seed(11)
    for name, (fan_in, fan_out) in {"fc1": (198, 32), "action": (32, 64),
                                    "value": (32, 1),
                                    "score": (32, 1)}.items():
        bound = 1 / np.sqrt(fan_in)
        for part, shape in (("weight", (fan_out, fan_in)),
                            ("bias", (fan_out,))):
            want = torch.empty(shape).uniform_(-bound, bound, generator=gen)
            assert torch.equal(getattr(model.layers[name], part), want)
    x = torch.rand((5, 198), generator=torch.Generator().manual_seed(12))
    lin = model.layers
    h = torch.relu(torch.nn.functional.linear(x, lin["fc1"].weight,
                                              lin["fc1"].bias))
    logits, value = model(x)
    assert torch.equal(logits, torch.nn.functional.linear(
        h, lin["action"].weight, lin["action"].bias))
    assert torch.equal(value, torch.nn.functional.linear(
        h, lin["value"].weight, lin["value"].bias)[..., 0])
    assert torch.equal(model.score(x), torch.nn.functional.linear(
        h, lin["score"].weight, lin["score"].bias)[..., 0])
    assert cfg.trunk == () and not cfg.outcome
    assert TCONF.get_preset("afterstate4096").model == TMLP.ModelConfig(
        action_size=256)


def test_wildbg4096_preset_is_afterstate4096_with_the_deep_model():
    a = TCONF.get_preset("afterstate4096")
    assert WILDBG.ppo == a.ppo and WILDBG.env == a.env
    assert WILDBG.model == TMLP.ModelConfig(
        hidden_size=300, trunk=(250, 200), outcome=True,
        action_size=256)


def test_run_learning_trains_wildbg4096_with_its_league_eval(
        tmp_path, monkeypatch, capsys):
    """``scripts/run_learning.py --preset wildbg4096`` through
    ``ppo/train.py`` at a tiny size: the deep model's updates, a league
    evaluation (its 1-ply agent on the deep pass's value head) and a
    checkpoint; ``--hidden`` is refused for a trunk."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
    from mlp_ppo_2ply_p3_tpu_torch.scripts import run_learning

    from .test_torch_train import tiny_cfg

    base = tiny_cfg(tmp_path)
    tiny = tiny_cfg(tmp_path, name="wildbg4096", model=dataclasses.replace(
        WILDBG.model, action_size=64), ppo=dataclasses.replace(
        base.ppo, policy_mode="afterstate"))
    monkeypatch.setattr(run_learning, "get_preset", lambda name: tiny)

    def train_small(cfg, **kw):
        return train_mod.train(dataclasses.replace(
            cfg, checkpoint_every=1, eval_every=1, eval_games=2), **kw)

    monkeypatch.setattr(run_learning, "train", train_small)
    monkeypatch.chdir(tmp_path)
    run_learning.main(["1", "--preset", "wildbg4096", "--tag", "t",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "learning run wildbg4096_t done: 1 updates" in out
    assert "league: vs_heuristic=" in out
    assert os.listdir("checkpoints/wildbg4096_t") == ["ckpt_1.npz"]
    with pytest.raises(ValueError, match="trunk"):
        run_learning.main(["1", "--preset", "wildbg4096", "--hidden", "64",
                           "--device", "cpu"])
