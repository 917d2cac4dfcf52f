"""What a deep network's pass needs (``ops/afterstate.py::afterstate_deep``
of the port: the first layer in the afterstate kernels' deep forms, the
dense layers in ``csrc/dense.cu``), on its actual inputs, held to
``work.py``'s yardstick: operations those inputs need (the first layer 2 H
a non-zero feature of a kept board; dense layers and heads 2 a weight a
kept row), bytes each input read once and each output written once, a
least time at the peaks of ``peaks.py``.  The same work is counted
whatever implements it; the backward of a dense layer is twice its
forward (the input's gradient and the weight's).

Also the deep model's operations in one update, by ``ppo.model_ops``'s
rule, and the device time launched inside named spans of the program.
"""

from __future__ import annotations

import torch

from . import profiling, work

# the spans the program opens (``spans.SPANS`` and those a deep network
# and a data-parallel world add)
PROGRAM_SPANS = ("train_step", "rollout", "policy", "env_step", "movegen",
                 "ppo_update", "minibatch_step", "adam_step", "decision",
                 "one_ply", "reply_movegen", "reply_eval", "dense_layers",
                 "dense_layers_backward", "gather_batch", "all_reduce_sum")
# the dense layers' kernels, by the stem of their names
DENSE_KERNELS = ("dense_forward_kernel", "dense_backward_kernel",
                 "dense_wgrad_kernel", "dense_reduce_kernel")


def hidden(boards, n, h, epilogue, backward=False):
    """(bytes, operations, kept boards, their non-zero features) of the
    first layer over (R, M, 52) ``boards``: forward, each kept board
    decoded, ``fc1`` and ReLU, its H activations and element written and
    the floors of the slots not kept; backward, dW1 (2 H a feature) and
    db1 from the kept boards and the H floats of dpre each."""
    r, m, _ = boards.shape
    kept = work._kept(n, m, epilogue)
    n_kept = int(kept.sum())
    n_feat = int((work._nnz(boards) * kept).sum())
    params = 198 * h + h
    if backward:
        nbytes = n_kept * (52 + 4 * h) + 8 * r + 4 * params
        ops = 2 * n_feat * h + 2 * n_kept * h
    else:
        nbytes = (n_kept * (52 + 4 * h + 4) + 8 * r + 4 * params
                  + 4 * (r * m - n_kept))
        ops = 2 * n_feat * h + 2 * n_kept * h
    return nbytes, ops, n_kept, n_feat


def dense(n_kept, widths, heads, backward=False):
    """(bytes, operations) of the dense layers and the head over
    ``n_kept`` rows: ``widths`` the trunk (fc1's first), ``heads`` the
    head's outputs.  Forward: each row's fc1 activations and element in,
    its output out; backward: the gradient and every layer's activations
    in, every layer's dpre out, the weights' gradients."""
    weights = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    weights += widths[-1] * heads
    params = weights + sum(widths[1:]) + heads
    ops = 2 * n_kept * weights
    if backward:
        acts = sum(widths)
        return (n_kept * 4 * (1 + 1 + 2 * acts) + 8 * params,
                2 * ops)
    return n_kept * 4 * (widths[0] + 2) + 4 * params, ops


def _nnz_rows(obs):
    return int((obs != 0).sum())


def model_ops(observations, passes, widths, epochs):
    """The deep model's operations in one update (``ppo.model_ops``'s
    rule): the rollout's value forwards on the observations (the outcome
    head) and on the kept candidate boards (the score head), the
    bootstrap, and the epochs' forward and backward passes, each a row of
    the rollout once an epoch and the backward twice the forward.
    ``passes``: (boards, n, epilogue, grad) of each deep pass."""
    h = widths[0]
    dense = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    rows = sum(o.shape[0] for o in observations)
    feats = sum(_nnz_rows(o) for o in observations)
    per_row = 2 * dense + 2 * widths[-1] * 6
    rollout = 2 * h * feats + rows * per_row
    last = observations[-1]
    boot = 2 * h * _nnz_rows(last) + last.shape[0] * per_row
    update = 3 * epochs * (rollout - boot)
    for boards, n, epilogue, grad in passes:
        _, _, n_kept, n_feat = hidden(boards, n, h, epilogue)
        ops = 2 * h * n_feat + n_kept * (2 * dense + 2 * widths[-1])
        update += 2 * ops if grad else 0
        rollout += ops
    return rollout + update


def span_seconds(fn, device, program, names):
    """The union of the device intervals launched inside any span of
    ``names`` in one ``fn()`` call, traced with host and device activity
    and the program's spans recording; None where the program has no
    spans or opened none of them."""
    from torch.profiler import ProfilerActivity, profile

    from . import spans

    if device.type != "cuda" or not hasattr(program, "recording"):
        return None
    torch.cuda.synchronize(device)
    with program.recording(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    cuda = torch.autograd.DeviceType.CUDA
    opened, calls, dev = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # the device's copy of a record_function range is no work
            if name not in names and name not in PROGRAM_SPANS:
                dev.append((e.correlation_id(), e.start_ns(), e.end_ns(),
                            name))
        elif name in names:
            opened.append((name, e.start_ns(), e.end_ns()))
        elif spans._is_call(name):
            calls.append((e.correlation_id(), e.start_ns(), name))
    if not opened:
        return None
    att = spans.Attribution(opened, calls, dev)
    return profiling.busy_seconds(
        (a, b) for a, b, _, s in att.device if s) / 1e9

