"""The optimizer step (``ops/adam.py``) on the CPU: the kernels' block
layout at the model's leaves, the plain version through
``learner.adam_step`` (fresh state, the old one left as it was), the
wrapper's checks, and its card path with the tensors taken for CUDA ones
and a recorder in the C entry point's place.  The kernels against the
plain version on the card: ``tests/test_torch_cuda.py -k adam``; the plain
version against optax: ``tests/test_torch_learner.py``."""

import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.models.mlp import MLP, ModelConfig
from mlp_ppo_2ply_p3_tpu_torch.ops import adam as AD
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

# (hidden, the model's leaf sizes, the blocks of each)
LAYOUTS = [
    (128, [25344, 128, 64000, 500, 128, 1, 128, 1],
     [25, 1, 63, 1, 1, 1, 1, 1]),
    (512, [101376, 512, 256000, 500, 512, 1, 512, 1],
     [99, 1, 250, 1, 1, 1, 1, 1]),
]


def model(hidden, seed=0):
    return MLP(ModelConfig(hidden_size=hidden), device="cpu",
               generator=torch.Generator().manual_seed(seed))


def step_inputs(hidden, scale, count=5, seed=1):
    """A model's parameters, gradients of global norm ``scale`` (the score
    head's zero, as the unused head's are), moments and a count."""
    params = list(model(hidden, seed).parameters())
    gen = torch.Generator().manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    grads[-2:] = [torch.zeros_like(g) for g in grads[-2:]]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    grads = [g * (scale / norm) for g in grads]
    mu = [0.01 * torch.randn(p.shape, generator=gen) for p in params]
    nu = [1e-4 * torch.rand(p.shape, generator=gen) for p in params]
    return params, grads, torch.tensor(count, dtype=torch.int32), mu, nu


def cfg(max_grad_norm):
    return learner.PPOConfig(learning_rate=1e-3, max_grad_norm=max_grad_norm)


@pytest.mark.parametrize("hidden,sizes,blocks", LAYOUTS)
def test_block_layout_at_the_model_leaves(hidden, sizes, blocks):
    """Each leaf of the MLP takes whole blocks of ``BLOCK_ELEMS`` that cover
    it and no more: 94 blocks at hidden 128, 355 at 512."""
    assert [p.numel() for p in model(hidden).parameters()] == sizes
    first = AD.block_layout(sizes)
    assert first[0] == 0 and first[-1] == sum(blocks)
    assert [b - a for a, b in zip(first, first[1:])] == blocks
    for n, k in zip(sizes, blocks):
        assert (k - 1) * AD.BLOCK_ELEMS < n <= k * AD.BLOCK_ELEMS
    assert len(sizes) <= AD.MAX_LEAVES


def test_block_layout_passes_over_empty_leaves():
    assert AD.block_layout([0, 1024, 0, 1025, 1]) == [0, 0, 1, 1, 3, 4]
    assert AD.block_layout([]) == [0]


@pytest.mark.parametrize("max_grad_norm,scale", [
    (0.5, 3.0), (0.5, 0.1), (0.0, 3.0)],
    ids=["clipped", "unclipped", "no-clip"])
def test_adam_step_on_cpu_leaves_the_old_state(max_grad_norm, scale):
    """``learner.adam_step`` on CPU tensors is the plain version: the
    parameters updated in place, a new count and new moments returned,
    the old state and the gradients left as they were."""
    params, grads, count, mu, nu = step_inputs(32, scale)
    state = learner.AdamState(count, mu, nu)
    kept = [t.clone() for t in (count, *mu, *nu, *grads)]
    want_p = [p.clone() for p in params]
    want = AD.adam_update_plain(want_p, grads, count, mu, nu, 1e-3,
                                max_grad_norm)
    before = AD.adam_update.launches
    new = learner.adam_step(params, grads, state, cfg(max_grad_norm))
    assert AD.adam_update.launches == before
    for a, b in zip((count, *mu, *nu, *grads), kept):
        assert torch.equal(a, b)
    assert int(new.count) == 6 and int(count) == 5
    for got, old in zip([*new.mu, *new.nu], [*mu, *nu]):
        assert got is not old and got.data_ptr() != old.data_ptr()
    for got, w in zip([*params, *new.mu, *new.nu],
                      [*want_p, *want[1], *want[2]]):
        assert torch.equal(got, w)
    # every leaf the loss reached moved
    assert all(not torch.equal(p, k) for p, k in
               zip(params[:-2], model(32, 1).parameters()))


def _bad_inputs(case):
    params, grads, count, mu, nu = step_inputs(8, 0.1)
    if case == "float64":
        grads[0] = grads[0].double()
    elif case == "non-contiguous":
        mu[0] = mu[0].t().contiguous().t()
    elif case == "shape":
        nu[2] = nu[2][:-1]
    elif case == "count-int64":
        count = count.long()
    elif case == "count-shape":
        count = count.reshape(1)
    elif case == "lengths":
        mu = mu[:-1]
    elif case == "no-leaves":
        params, grads, mu, nu = [], [], [], []
    elif case == "too-many":
        params, grads, mu, nu = ([x[0]] * (AD.MAX_LEAVES + 1)
                                 for x in (params, grads, mu, nu))
    elif case == "mixed-device":
        grads[3] = grads[3].to("meta")
    elif case == "meta":
        params, grads, mu, nu = ([t.to("meta") for t in x]
                                 for x in (params, grads, mu, nu))
        count = count.to("meta")
    return params, grads, count, mu, nu


@pytest.mark.parametrize("case", [
    "float64", "non-contiguous", "shape", "count-int64", "count-shape",
    "lengths", "no-leaves", "too-many", "mixed-device", "meta"])
def test_adam_update_rejects(case):
    """What the kernels do not take raises on every device, before any
    arithmetic: no parameter moves."""
    params, grads, count, mu, nu = _bad_inputs(case)
    kept = [p.clone() for p in params if p.device.type == "cpu"]
    with pytest.raises((TypeError, ValueError)):
        AD.adam_update(params, grads, count, mu, nu, 1e-3, 0.5)
    for p, k in zip([p for p in params if p.device.type == "cpu"], kept):
        assert torch.equal(p, k)


@pytest.mark.parametrize("hidden,sizes,blocks", LAYOUTS)
@pytest.mark.parametrize("max_grad_norm", [0.5, 0.0])
def test_card_path_launches_with_the_leaf_table(monkeypatch, hidden, sizes,
                                                blocks, max_grad_norm):
    """The card path with the tensors taken for CUDA ones: one call of the
    C entry point with every leaf's pointers, fresh moment buffers, the
    sizes and ``block_layout``'s blocks, the partials' scratch only where
    clipping is on, the plain version's scalars; one launch counted, no
    plain arithmetic, no parameter touched on the host; a CUDA error
    raises."""
    calls = []

    def record(dev, *args):
        calls.append(args)
        return 0

    def no_plain(*args, **kw):
        raise AssertionError("the card path took the plain version")

    monkeypatch.setattr(AD, "_on_card", lambda x: True)
    monkeypatch.setattr(AD, "_launch", record)
    monkeypatch.setattr(AD, "adam_update_plain", no_plain)
    params, grads, count, mu, nu = step_inputs(hidden, 3.0)
    kept = [p.clone() for p in params]
    before = AD.adam_update.launches
    new_count, new_mu, new_nu = AD.adam_update(params, grads, count, mu, nu,
                                               1e-3, max_grad_norm)
    assert AD.adam_update.launches == before + 1
    (args,) = calls
    tables = [list(t) for t in args[:6]]
    for table, tensors in zip(tables, (params, grads, mu, nu, new_mu,
                                       new_nu)):
        assert table == [t.data_ptr() for t in tensors]
    old = {t.data_ptr() for t in (*params, *grads, *mu, *nu, count)}
    assert not old & {t.data_ptr() for t in (*new_mu, *new_nu, new_count)}
    assert [t.shape for t in new_mu] == [t.shape for t in mu]
    assert list(args[6]) == sizes and list(args[7]) == AD.block_layout(sizes)
    assert args[8] == len(sizes) == 8
    assert args[9:11] == (count.data_ptr(), new_count.data_ptr())
    assert (args[11] is None) == (max_grad_norm == 0)
    assert args[12] == int(max_grad_norm > 0)
    assert args[13:] == (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8, -1e-3,
                         max_grad_norm)
    for p, k in zip(params, kept):
        assert torch.equal(p, k)

    monkeypatch.setattr(AD, "_launch", lambda dev, *args: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        AD.adam_update(params, grads, count, mu, nu, 1e-3, max_grad_norm)
    assert AD.adam_update.launches == before + 1



def test_ops_counts_the_optimizer_beside_the_kernels(monkeypatch):
    """``ops.launches()`` reads the wrapper's calls under ``ops.OPTIMIZER``,
    after ``ops.KERNELS`` and outside them, and ``ops.zero_launches()``
    zeroes them with the kernels' counts."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    monkeypatch.setattr(AD.adam_update, "launches", 7)
    got = ops.launches()
    assert list(got) == [*ops.KERNELS, ops.OPTIMIZER, *ops.DEEP]
    assert ops.OPTIMIZER not in ops.KERNELS and got[ops.OPTIMIZER] == 7
    assert ops.counters()[ops.OPTIMIZER] is AD.adam_update
    ops.zero_launches()
    assert AD.adam_update.launches == 0
    assert set(ops.launches().values()) == {0}
