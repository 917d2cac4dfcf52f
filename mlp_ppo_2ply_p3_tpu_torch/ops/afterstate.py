"""The afterstate evaluation pass: int8 candidate boards through the
198 TD-Gammon features, ``fc1``, ReLU and one head, then an epilogue.

    feats = encode_canonical(view(boards), mover)
    h     = relu(feats @ W1^T + b1)
    y     = h @ w_head^T + b_head

The JAX package writes this pass in jnp and XLA fuses it:
``mlp_ppo_2ply_p3_tpu/ppo/learner.py:143-152`` (``_afterstate_logits``),
``agents/basic.py::afterstate_values`` and ``::afterstate_policy_logits``,
``agents/twoply.py:108-131`` (``_masked_min_values``).  Its kernels
(``csrc/afterstate.cu``) read the 52 bytes of each kept board and nothing
of the (R, M, 198) features or the (R, M, H) hidden layer reaches device
memory.

- ``view``: the identity, or ``core.board.opponent_view`` (``opponent``).
- ``mover``: (R,) int32, the one-hot and the frame of the encoding.
- ``n``: (R,) int32 valid-prefix lengths of the M slots.
- ``epilogue``: ``"logits"`` (``y`` where slot < n, else -1e9; a row with
  n == 0 keeps its raw ``y``, as ``ppo.learner._prefix_mask``),
  ``"masked"`` (``sign * y`` where slot < n, else -1e9; ``n = M`` gives
  the raw values) or ``"min"`` (the (R,) minimum of ``y`` over the valid
  prefix, +1e9 where n == 0).

``afterstate_eval`` dispatches on the boards' device: CPU tensors take
``afterstate_eval_plain`` (the former composition of
``features.encode_canonical`` and ``MLP.score``/``value``, moved here
unchanged), CUDA tensors launch the kernel or raise.  The kernels take
every hidden width H >= 1 and four float32 or four bfloat16 weights (the
``MLP``'s ``compute_dtype``); float16, float64 and mixed weights raise.
On the card its gradient is ``torch.autograd.Function`` whose backward
is the second kernel, ``afterstate_eval_backward`` (the parameters'
gradients; the boards carry none).  The two wrappers' ``launches``
attributes count their calls on the card, one a call however many CUDA
kernels it runs (the min's forward, the backward and the forward past
256 units run two).  ``evaluate`` takes the weights from an ``MLP``.

What bounds the kernels on an H100, and the design (the note at the top
of the source says more): only the kept boards (slot < n) are worked on,
in tiles of 64 taken from their global order, so rows cost nothing; each
block decodes a tile once into a bf16 feature tile in shared memory, and
``fc1`` is a tensor-core product (``wgmma``) against W1 held in shared
memory as three bf16 parts (``split_bf16``), whose sum is W1 exactly; the
backward's dW1 is a second tensor-core product (``mma.sync``) of dpre,
split the same way, with the same tile.  Every feature but the two off
columns (``FLOAT32_COLUMNS``) is exact in bf16, so every product is exact
and only the order of the float32 sums differs from torch's: the results
are held to a tolerance.  The off columns, the bias, ReLU, the head and
the epilogue run in float32 on the CUDA cores.  A block holds 128 units
(``UNITS``; the units past H staged as zeros, which add nothing): up to
128 the forward is one block a range of tiles, up to 256 a two-block
cluster, past 256 a grid of unit groups whose head partials a second
kernel sums (``forward_scratch_floats``); the backward is a grid of unit
groups at every width (``backward_blocks``).  bfloat16 weights run the
JAX package's bf16 composition (``models/mlp.py::_dense``): the features
and W1 in bf16 (one part), fc1 rounded to bf16 before and after the bias,
the head rounded before and after its bias; the gradients come back as
float32 tensors of bf16 numbers, each rounded once (the cotangent of
``astype(bfloat16)``).  torch's bf16 ``linear``, the plain version's,
rounds once after the bias, so the two are held to a bf16 tolerance.

A deep network (an ``MLP`` with a ``trunk``; ``afterstate_deep``) keeps
``fc1`` in these kernels and hands the rest to ``ops/dense.py``:
``afterstate_hidden`` decodes each kept board once and runs ``fc1`` as
above, then writes its post-ReLU activations, in the kernels' global order
of kept boards, with each board's element and their count (on the card),
and the floors of the slots not kept; ``dense.dense_layers`` runs the
layers after it, the head and the epilogue on those rows.  The backward
runs ``dense.dense_layers_backward``, which hands fc1's dpre to
``afterstate_hidden_backward``: the second kernel with dpre read in place of
its fc1 product, giving dW1 and db1 from the same tile.  Float32 only; the
``min`` epilogue and bf16 raise (``DEEP_MIN_ITEM``, ``DEEP_BF16_ITEM``).

A routed model (an ``MLP`` with ``race``: wildbg's contact and race
networks; ``afterstate_routed``) sends each kept board through the network
its position's class selects (``core.board.is_race``, the same for a board
and its opponent view).  ``afterstate_route`` reads each kept board's
bytes once, writes the floors of the slots not kept and lays the kept
boards out as two groups (``GROUPS``): each row's count of each class and
its kept slots of that class in slot order, so that each group's kept
boards have a global order of their own (rows in order, slots in order),
which the emit and the deep backward then walk in their ``route`` form,
one launch a group, each with its own network's W1 and its own count on
the card.  ``dense_layers`` runs each group with its own network's layers
and head, inside a span of the group's name (``dense_layers.contact``,
``dense_layers.race``).  The emit also adds each group's count to a tally
on the card (``routed_rows``, zeroed by ``ops.zero_launches``), which the
hot path never reads.

A whole row is one kept board.  Under the ``logits`` epilogue a row with
n <= 0 keeps every slot, and movegen fills a row with no legal move with
one board (its zero tail) in every slot; such a row, every board equal to
slot 0 byte for byte (``collapsed_plain``), keeps slot 0 alone in every
form: the forward writes that board's value into each of the row's M
slots (the same bits as each of M evaluations), the backward gives it the
row's M cotangents summed (float32, a fixed order), the gradient of M
equal values.  A row whose boards differ keeps every slot, as before.  On
the card ``afterstate_collapse`` (a warp a row, reading only rows with n
<= 0) writes each row's entry, its kept boards or ``WHOLE``, once a
forward call; the autograd functions keep it for the backward, and the
routed pass's route decides the same from the bytes it reads anyway.  The
deep forms mark a whole row's board in ``elem`` as ``~(r m)``.  Both add
the whole rows they find to a tally on the card (``collapsed_rows``,
zeroed by ``ops.zero_launches``).  The ``masked`` and ``min`` epilogues
keep nothing of a row with n <= 0 and take no such entry.  The plain
versions of the full passes (``afterstate_eval_plain``,
``afterstate_deep_plain``, ``afterstate_routed_plain``) still evaluate
every slot: they are what the kernels are held to.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as Fn

from ..core import board as Bd
from ..core import features as F
from ..models.mlp import DEEP_BF16_ITEM, NETS
from ..utils.profiling import span
from . import dense as DN

FLOOR = -1e9     # the masked entries (ppo.learner.MASK_FLOOR, basic.NEG_INF)
POS_INF = 1e9    # a min over no reply (agents.twoply.POS_INF)
EPILOGUES = {"logits": 0, "masked": 1, "min": 2}
# the weight dtypes the kernels take, as the launches' dtype argument
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROADMAP_ITEM = "ROADMAP.md, queue 1, item 20"
# what lifts the deep pass's refusals
DEEP_MIN_ITEM = "ROADMAP.md, queue 6, item C9"
# a routed pass's groups of kept boards, by position class (contact, race)
GROUPS = NETS
# a row's entry in a kept-count array where the row is whole: one board,
# slot 0, stands for its M slots (csrc/afterstate.cu kWhole)
WHOLE = -1
UNITS = 128          # hidden units a block stages (a unit group)
TILE = 64            # kept boards a tile
# backward blocks of one unit group: a number of the shapes, never of the
# card, so that the gradients' sums run in one order on every card
BACKWARD_BLOCKS = 132
# the feature columns the kernels keep in float32 beside the bf16 feature
# tile: the two off features, c * float32(1/15), are not bf16 numbers
FLOAT32_COLUMNS = (97, 195)


def split_bf16(x, parts=3):
    """``x`` as ``parts`` bf16 tensors, each rounded to nearest from what
    the ones before leave, as the kernels split W1 and dpre.  Each part
    takes the next 8 of float32's 24 significant bits, so three sum back
    to a float32 ``x`` exactly where 2^-110 <= |x| < 2^127 (below, the
    last part falls under bf16's smallest subnormal: off by at most
    2^-134)."""
    rest, out = x.float(), []
    for _ in range(parts):
        part = rest.bfloat16()
        out.append(part)
        rest = rest - part.float()
    return out


def unit_groups(h):
    """The 128-unit groups of hidden width ``h`` (the last one padded
    with zero units)."""
    return -(-h // UNITS)


def forward_scratch_floats(r, m, h):
    """Floats of scratch the forward takes: past 256 units each unit
    group's head partial of every board, (groups, R M); none below."""
    return unit_groups(h) * r * m if h > 2 * UNITS else 0


def backward_blocks(r, m, h):
    """Blocks of each unit group in the backward: one a 64-board tile of
    the R M boards, at most ``BACKWARD_BLOCKS`` // groups (at least 1), so
    that the partials stay near 132 x 128 units' worth at every width."""
    boards = r * m
    if boards <= 0:
        return 0
    return min(-(-boards // TILE), max(BACKWARD_BLOCKS // unit_groups(h), 1))


def backward_scratch_floats(r, m, h):
    """Floats of the backward's block partials: a slab of the flat
    gradient, 198 H + 2 H + 1 floats, a block."""
    return backward_blocks(r, m, h) * (198 * h + 2 * h + 1)


def _valid(n, m, epilogue):
    """(R, M) bool: the slots whose value the epilogue keeps."""
    slots = torch.arange(m, device=n.device)[None, :]
    valid = slots < n[:, None]
    if epilogue == "logits":
        valid = valid | (n <= 0)[:, None]
    return valid


def collapsed_plain(boards, n, epilogue):
    """(R,) bool: the whole rows of (R, M, 52) ``boards``: under the
    ``logits`` epilogue, n <= 0 and every board equal to slot 0, byte for
    byte (none under the others)."""
    r, m, _ = boards.shape
    if epilogue != "logits" or m == 0:
        return torch.zeros((r,), dtype=torch.bool, device=boards.device)
    return (n <= 0) & (boards == boards[:, :1]).flatten(1).all(1)


def row_lims_plain(boards, n, epilogue):
    """Plain PyTorch version of ``afterstate_collapse``: (R,) int32 each
    row's kept boards, ``WHOLE`` for a whole row."""
    kept = _valid(n, boards.shape[1], epilogue).sum(1, dtype=torch.int32)
    return torch.where(collapsed_plain(boards, n, epilogue),
                       torch.full_like(kept, WHOLE), kept)


def _kept(boards, n, epilogue):
    """(R, M) bool: the slots the kernels work on, the epilogue's kept
    ones but those past slot 0 of a whole row."""
    m = boards.shape[1]
    later = torch.arange(m, device=boards.device)[None, :] > 0
    return _valid(n, m, epilogue) & ~(
        collapsed_plain(boards, n, epilogue)[:, None] & later)


def _mark(elem, m, whole):
    """Elements ``elem`` (r m + s), those of whole rows (``whole`` (R,)
    bool) marked ``~e``."""
    on = whole[elem // max(m, 1)] if elem.numel() else elem.bool()
    return torch.where(on, ~elem, elem)


def _unmark(elem):
    """Elements r m + s of ``elem``, marks taken off."""
    return torch.where(elem < 0, ~elem, elem)


def _head(feats, w1, b1, w_head, b_head):
    dt = w1.dtype
    h = torch.relu(Fn.linear(feats.to(dt), w1, b1))
    return Fn.linear(h, w_head, b_head).float()[..., 0]


def afterstate_eval_plain(boards, mover, n, w1, b1, w_head, b_head,
                          opponent, epilogue, sign, chunk=0):
    """Plain PyTorch version (any device; differentiable in the weights).
    ``chunk`` > 0 walks the slot axis of the ``min`` epilogue in blocks of
    that width, so that the features are never built at (R, M, 198) at
    once; it changes no result."""
    r, m, _ = boards.shape
    if epilogue == "min":
        worst = torch.full((r,), POS_INF, dtype=torch.float32,
                           device=boards.device)
        sc = min(chunk, m) if chunk > 0 else m
        pad = (-m) % sc if m else 0
        if pad:
            boards = Fn.pad(boards, (0, 0, 0, pad))
        view = Bd.opponent_view(boards) if opponent else boards
        slots = torch.arange(sc, device=boards.device)
        for s0 in range(0, m + pad, max(sc, 1)):
            feats = F.encode_canonical(view[:, s0:s0 + sc], mover[:, None])
            vals = _head(feats, w1, b1, w_head, b_head)
            valid = (s0 + slots)[None, :] < n[:, None]
            blk = torch.where(valid, vals, POS_INF).amin(dim=1)
            worst = torch.minimum(worst, blk)
        return worst
    view = Bd.opponent_view(boards) if opponent else boards
    y = _head(F.encode_canonical(view, mover[:, None]), w1, b1, w_head,
              b_head)
    if sign < 0:
        y = -y
    return torch.where(_valid(n, m, epilogue), y, FLOOR)


def afterstate_eval_backward_plain(boards, mover, n, w1, b1, w_head, b_head,
                                   opponent, epilogue, sign, grad):
    """(dW1, db1, dw_head, db_head) of ``sum(grad * afterstate_eval_plain(
    ...))``: the plain version's gradients by torch's autograd."""
    with torch.enable_grad():
        params = [p.detach().requires_grad_() for p in (w1, b1, w_head,
                                                        b_head)]
        y = afterstate_eval_plain(boards, mover, n, *params, opponent,
                                  epilogue, sign)
        return torch.autograd.grad(y, params, grad)


def _check(boards, mover, n, w1, b1, w_head, b_head, opponent, epilogue,
           sign):
    if boards.dtype != torch.int8 or boards.dim() != 3 or \
            boards.shape[2] != 52:
        raise TypeError(f"boards must be (R, M, 52) int8, got "
                        f"{tuple(boards.shape)} {boards.dtype}")
    r, m, _ = boards.shape
    for name, x in (("mover", mover), ("n", n)):
        if x.dtype != torch.int32 or tuple(x.shape) != (r,):
            raise TypeError(f"{name} must be ({r},) int32, got "
                            f"{tuple(x.shape)} {x.dtype}")
    h = w1.shape[0]
    shapes = ((w1, (h, 198)), (b1, (h,)), (w_head, (1, h)), (b_head, (1,)))
    for x, want in shapes:
        if tuple(x.shape) != want:
            raise ValueError(f"weights must be (H, 198), (H,), (1, H), (1,);"
                             f" got {[tuple(p.shape) for p, _ in shapes]}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {tuple(EPILOGUES)}, got "
                         f"{epilogue!r}")
    if sign not in (1.0, -1.0) or (epilogue == "min" and sign != 1.0):
        raise ValueError(f"sign must be 1 or -1 (1 for the min), got "
                         f"{sign}")
    if not isinstance(opponent, bool):
        raise TypeError(f"opponent must be a bool, got {opponent!r}")
    tensors = (boards, mover, n, w1, b1, w_head, b_head)
    if any(x.device != boards.device for x in tensors):
        raise ValueError("boards, mover, n and the weights are on different "
                         "devices")
    if boards.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boards.device}")
    if _on_card(boards):
        kernel_dtype(w1, b1, w_head, b_head)
        if h < 1:
            raise ValueError(f"the afterstate kernels need hidden >= 1, got "
                             f"{h}")
        if not all(x.is_contiguous() for x in tensors):
            raise ValueError("the afterstate kernels need contiguous inputs")
        if r * m >= 2**31:
            raise ValueError(f"{r} x {m} boards is too many for one launch")


def kernel_dtype(*weights):
    """The kernels' dtype argument for these weights: 0 for four float32,
    1 for four bfloat16; anything else raises."""
    dtypes = {w.dtype for w in weights}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPES:
        raise ValueError(
            f"the afterstate kernels take four float32 or four bfloat16 "
            f"weights, got {[str(w.dtype) for w in weights]}: see "
            f"{ROADMAP_ITEM}")
    return DTYPES[weights[0].dtype]


def _on_card(x):
    """Whether the pass on ``x`` runs the kernels (a CUDA tensor)."""
    return x.device.type == "cuda"


_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_SIGNATURES = {
    "afterstate_collapse_launch": ([_P] * 4 + [_I] * 2 + [_P], _I),
    "afterstate_eval_launch": ([_P] * 10 + [_L] + [_I] * 5 + [_F, _I, _P],
                               _I),
    "afterstate_backward_launch": ([_P] * 11 + [_L, _P] + [_I] * 6
                                   + [_F, _I, _P], _I),
    "afterstate_emit_launch": ([_P] * 8 + [_I, _P, _P] + [_I] * 5 + [_P],
                               _I),
    "afterstate_backward_deep_launch": ([_P] * 5 + [_I, _P, _L, _P]
                                        + [_I] * 6 + [_P], _I),
    "afterstate_route_launch": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "afterstate_emit_routed_launch": ([_P] * 7 + [_I] + [_P] * 3
                                      + [_I] * 4 + [_P], _I),
    "afterstate_backward_deep_routed_launch": ([_P] * 5 + [_I, _P, _L, _P]
                                               + [_I] * 5 + [_P], _I),
}


def _fn(name):
    from .build import load

    fn = getattr(load("afterstate"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _launch(name, dev, *args):
    """The C entry point ``name`` called on ``dev``'s current stream; its
    CUDA error code."""
    with torch.cuda.device(dev):
        return _fn(name)(*args, torch.cuda.current_stream(dev).cuda_stream)


def _scratch(floats, dev):
    """A float32 scratch buffer of ``floats``, or None for none."""
    if not floats:
        return None
    return torch.empty((floats,), dtype=torch.float32, device=dev)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _tally_of(tallies, dev, size):
    """The card's (or the CPU's) int64 tally of ``size`` entries in
    ``tallies``, made at zero on first use."""
    key = str(dev)
    if key not in tallies:
        tallies[key] = torch.zeros((size,), dtype=torch.int64, device=dev)
    return tallies[key]


def collapsed_rows() -> int:
    """Whole rows found (``afterstate_collapse`` and the route) since the
    last ``zero_collapsed_rows``, summed over devices: a host sync, for
    readings after a traced update, never for the hot path."""
    return sum(int(t.sum()) for t in _COLLAPSED.values())


def zero_collapsed_rows() -> None:
    for t in _COLLAPSED.values():
        t.zero_()


def afterstate_collapse(boards, n, epilogue):
    """Each row's entry under the ``logits`` epilogue: (R,) int32, its kept
    boards, or ``WHOLE`` where n <= 0 and its M boards all equal slot 0;
    None under the others (nothing is whole).  On the card
    ``afterstate_collapse_kernel``, which adds the whole rows to the tally
    (on the CPU, ``row_lims_plain``, added here)."""
    if epilogue != "logits":
        return None
    dev = boards.device
    tally = _tally_of(_COLLAPSED, dev, 1)
    if not _on_card(boards):
        lim = row_lims_plain(boards, n, epilogue)
        tally += (lim == WHOLE).sum()
        return lim
    r, m, _ = boards.shape
    lim = torch.empty((r,), dtype=torch.int32, device=dev)
    err = _launch("afterstate_collapse_launch", dev, boards.data_ptr(),
                  n.data_ptr(), lim.data_ptr(), tally.data_ptr(), r, m)
    if err != 0:
        raise RuntimeError(f"afterstate_collapse kernel launch failed: CUDA "
                           f"error {err} at {r} x {m} boards")
    return lim


def _forward_kernel(boards, mover, n, w1, b1, w_head, b_head, opponent,
                    epilogue, sign, lim=None):
    r, m, _ = boards.shape
    h, dev = w1.shape[0], boards.device
    shape = (r,) if epilogue == "min" else (r, m)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    floats = forward_scratch_floats(r, m, h)
    scratch = _scratch(floats, dev)
    err = _launch(
        "afterstate_eval_launch", dev, boards.data_ptr(), mover.data_ptr(),
        n.data_ptr(), _ptr(lim), w1.data_ptr(), b1.data_ptr(),
        w_head.data_ptr(), b_head.data_ptr(), out.data_ptr(), _ptr(scratch),
        floats, r, m, h, int(opponent), EPILOGUES[epilogue], sign,
        DTYPES[w1.dtype])
    if err != 0:
        raise RuntimeError(f"afterstate_eval kernel launch failed: CUDA "
                           f"error {err} at {r} x {m} boards, hidden {h} "
                           f"{w1.dtype}")
    _COUNTERS["afterstate_eval"].launches += 1
    return out


class _Eval(torch.autograd.Function):
    """The kernel as a differentiable function of the four weights; the
    rows' entries (``afterstate_collapse``) are found once, in the
    forward, and kept for the backward."""

    @staticmethod
    def forward(ctx, boards, mover, n, w1, b1, w_head, b_head, opponent,
                epilogue, sign):
        lim = afterstate_collapse(boards, n, epilogue)
        ctx.save_for_backward(boards, mover, n, w1, b1, w_head, b_head, lim)
        ctx.cfg = (opponent, epilogue, sign)
        return _forward_kernel(boards, mover, n, w1, b1, w_head, b_head,
                               opponent, epilogue, sign, lim)

    @staticmethod
    def backward(ctx, grad):
        *saved, lim = ctx.saved_tensors
        grads = afterstate_eval_backward(*saved, *ctx.cfg, grad, lim)
        return (None, None, None, *grads, None, None, None)


def afterstate_eval(boards, mover, n, w1, b1, w_head, b_head, opponent,
                    epilogue, sign, chunk=0):
    """The pass over (R, M, 52) int8 ``boards``; returns (R, M) float32,
    or (R,) for ``epilogue="min"``.  ``w1`` (H, 198), ``b1`` (H,),
    ``w_head`` (1, H), ``b_head`` (1,) are ``nn.Linear``'s layouts, all
    float32 or all bfloat16 (the compute dtype); ``opponent`` a bool,
    ``sign`` +-1.0 (``masked`` only).  ``chunk`` reaches only the plain
    version (the kernel takes the whole width in one launch)."""
    _check(boards, mover, n, w1, b1, w_head, b_head, opponent, epilogue,
           sign)
    if not _on_card(boards):
        return afterstate_eval_plain(boards, mover, n, w1, b1, w_head,
                                     b_head, opponent, epilogue, sign, chunk)
    return _Eval.apply(boards, mover, n, w1, b1, w_head, b_head, opponent,
                       epilogue, sign)


def afterstate_eval_backward(boards, mover, n, w1, b1, w_head, b_head,
                             opponent, epilogue, sign, grad, lim=None):
    """(dW1 (H, 198), db1 (H,), dw_head (1, H), db_head (1,)) of
    ``sum(grad * afterstate_eval(...))`` for ``grad`` shaped as the
    forward's output.  Entries that the epilogue masks carry no gradient.
    ``lim``: the forward's ``afterstate_collapse`` (None: found again).
    The ``min`` epilogue has none (its callers run without gradients).  On
    the card the gradients are float32; of bfloat16 weights, bf16 numbers
    (each rounded once, where JAX's cotangent of ``astype(bfloat16)``
    rounds it)."""
    _check(boards, mover, n, w1, b1, w_head, b_head, opponent, epilogue,
           sign)
    r, m, _ = boards.shape
    if epilogue == "min":
        raise NotImplementedError("the min epilogue has no gradient")
    if tuple(grad.shape) != (r, m) or grad.device != boards.device:
        raise ValueError(f"grad must be ({r}, {m}) on {boards.device}, got "
                         f"{tuple(grad.shape)} on {grad.device}")
    if not _on_card(boards):
        return afterstate_eval_backward_plain(
            boards, mover, n, w1, b1, w_head, b_head, opponent, epilogue,
            sign, grad)
    h, dev = w1.shape[0], boards.device
    if lim is None:
        lim = afterstate_collapse(boards, n, epilogue)
    grad = grad.to(torch.float32).contiguous()
    floats = backward_scratch_floats(r, m, h)
    scratch = _scratch(floats, dev)
    # the whole rows' summed cotangents
    wgrad = None if lim is None else _scratch(r, dev)
    flat = torch.empty((h * 198 + 2 * h + 1,), dtype=torch.float32,
                       device=dev)
    err = _launch(
        "afterstate_backward_launch", dev, boards.data_ptr(),
        mover.data_ptr(), n.data_ptr(), _ptr(lim), _ptr(wgrad),
        w1.data_ptr(), b1.data_ptr(),
        w_head.data_ptr(), b_head.data_ptr(), grad.data_ptr(),
        _ptr(scratch), floats, flat.data_ptr(), backward_blocks(r, m, h), r,
        m, h, int(opponent), EPILOGUES[epilogue], sign, DTYPES[w1.dtype])
    if err != 0:
        raise RuntimeError(f"afterstate_eval_backward kernel launch failed: "
                           f"CUDA error {err} at {r} x {m} boards, hidden {h} "
                           f"{w1.dtype}")
    _COUNTERS["afterstate_eval_backward"].launches += 1
    hw = h * 198
    return (flat[:hw].view(h, 198), flat[hw:hw + h],
            flat[hw + h:hw + 2 * h].view(1, h), flat[hw + 2 * h:])


def _kept_order(boards, n, epilogue):
    """The kept boards' elements r m + s in the kernels' order (rows in
    order, slots in order; a whole row's one board marked ``~(r m)``),
    counted on the host."""
    m = boards.shape[1]
    elem = _kept(boards, n, epilogue).reshape(-1).nonzero()[:, 0]
    return _mark(elem, m, collapsed_plain(boards, n, epilogue)).to(
        torch.int32)


def _features_of(boards, mover, elem, opponent):
    """The features of the boards at elements ``elem`` (r m + s, marked
    or not)."""
    r, m, _ = boards.shape
    view = Bd.opponent_view(boards) if opponent else boards
    feats = F.encode_canonical(view, mover[:, None]).reshape(r * m, -1)
    return feats[_unmark(elem.long())]


def _first_layer_plain(boards, mover, elem, w1, b1, opponent):
    """(h1, elem, count) of ``afterstate_hidden`` over the kept boards at
    elements ``elem``, in that order."""
    r, m, _ = boards.shape
    h, k, dev = w1.shape[0], elem.shape[0], boards.device
    h1 = torch.zeros((r * m, DN.ld(h)), dtype=torch.float32, device=dev)
    h1[:k, :h] = torch.relu(Fn.linear(_features_of(boards, mover, elem,
                                                   opponent), w1, b1))
    elem_all = torch.zeros((r * m,), dtype=torch.int32, device=dev)
    elem_all[:k] = elem
    return h1, elem_all, torch.tensor([k], dtype=torch.int32, device=dev)


def _first_layer_backward_plain(boards, mover, elem, dpre, hidden, opponent):
    """(dW1, db1) from dpre by kept board at elements ``elem``."""
    d = dpre[:elem.shape[0], :hidden]
    return d.t() @ _features_of(boards, mover, elem, opponent), d.sum(0)


def afterstate_hidden_plain(boards, mover, n, w1, b1, opponent, epilogue):
    """Plain PyTorch version of ``afterstate_hidden``."""
    r, m, _ = boards.shape
    out = torch.full((r, m), FLOOR, dtype=torch.float32,
                     device=boards.device)
    return (out, *_first_layer_plain(boards, mover,
                                     _kept_order(boards, n, epilogue), w1,
                                     b1, opponent))


def afterstate_hidden_backward_plain(boards, mover, n, dpre, hidden,
                                     opponent, epilogue):
    """Plain PyTorch version of ``afterstate_hidden_backward``."""
    return _first_layer_backward_plain(
        boards, mover, _kept_order(boards, n, epilogue), dpre, hidden,
        opponent)


def _check_hidden(boards, mover, n, w1, b1, opponent, epilogue):
    h = w1.shape[0]
    wh = torch.zeros((1, h), dtype=w1.dtype, device=w1.device)
    bh = torch.zeros((1,), dtype=w1.dtype, device=w1.device)
    if epilogue == "min":
        raise NotImplementedError(
            f"the min epilogue (2-ply) does not take a deep network yet: "
            f"see {DEEP_MIN_ITEM}")
    if w1.dtype != torch.float32 or b1.dtype != torch.float32:
        raise NotImplementedError(
            f"a deep network runs in float32; bfloat16 is {DEEP_BF16_ITEM}")
    _check(boards, mover, n, w1, b1, wh, bh, opponent, epilogue, 1.0)


def afterstate_hidden(boards, mover, n, w1, b1, opponent, epilogue,
                      lim=None):
    """A deep network's ``fc1`` over the kept boards of (R, M, 52) int8
    ``boards`` (``logits`` or ``masked`` epilogue): (``out`` (R, M)
    float32 holding the floor at every slot the epilogue does not keep
    and nothing yet at the kept ones, ``h1`` (R M, ``dense.ld(H)``)
    float32 whose first ``count`` rows are relu(W1 feats + b1) of the kept
    boards in the kernels' global order (rows in order, slots in order),
    ``elem`` (R M,) int32 each one's element r m + s (a whole row's
    ``~(r m)``), ``count`` (1,) int32).  Rows of ``h1`` and ``elem`` past
    the count are unspecified on the card.  ``lim``: the rows' entries,
    ``afterstate_collapse``'s (None: found here)."""
    _check_hidden(boards, mover, n, w1, b1, opponent, epilogue)
    if not _on_card(boards):
        return afterstate_hidden_plain(boards, mover, n, w1, b1, opponent,
                                       epilogue)
    r, m, _ = boards.shape
    h, dev = w1.shape[0], boards.device
    if lim is None:
        lim = afterstate_collapse(boards, n, epilogue)
    out = torch.empty((r, m), dtype=torch.float32, device=dev)
    h1 = torch.empty((r * m, DN.ld(h)), dtype=torch.float32, device=dev)
    elem = torch.empty((r * m,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    err = _launch("afterstate_emit_launch", dev, boards.data_ptr(),
                  mover.data_ptr(), n.data_ptr(), _ptr(lim), w1.data_ptr(),
                  b1.data_ptr(), out.data_ptr(), h1.data_ptr(), DN.ld(h),
                  elem.data_ptr(), count.data_ptr(), r, m, h, int(opponent),
                  EPILOGUES[epilogue])
    if err != 0:
        raise RuntimeError(f"afterstate_hidden kernel launch failed: CUDA "
                           f"error {err} at {r} x {m} boards, hidden {h}")
    _COUNTERS["afterstate_hidden"].launches += 1
    return out, h1, elem, count


def afterstate_hidden_backward(boards, mover, n, dpre, hidden, opponent,
                               epilogue, lim=None):
    """(dW1 (H, 198), db1 (H,)) of a deep network's ``fc1``, given its
    pre-activation gradient ``dpre`` by kept board in
    ``afterstate_hidden``'s order ((R M, ``dense.ld(H)``) float32, the
    first count rows read); ``lim`` as its (None: found again)."""
    w1 = torch.zeros((hidden, 198), dtype=torch.float32,
                     device=boards.device)
    _check_hidden(boards, mover, n, w1, w1[:, 0].contiguous(), opponent,
                  epilogue)
    if not _on_card(boards):
        return afterstate_hidden_backward_plain(boards, mover, n, dpre,
                                                hidden, opponent, epilogue)
    r, m, _ = boards.shape
    dev = boards.device
    if lim is None:
        lim = afterstate_collapse(boards, n, epilogue)
    floats = backward_scratch_floats(r, m, hidden)
    scratch = _scratch(floats, dev)
    flat = torch.empty((hidden * 198 + 2 * hidden + 1,), dtype=torch.float32,
                       device=dev)
    err = _launch("afterstate_backward_deep_launch", dev, boards.data_ptr(),
                  mover.data_ptr(), n.data_ptr(), _ptr(lim), dpre.data_ptr(),
                  dpre.shape[1], _ptr(scratch), floats, flat.data_ptr(),
                  backward_blocks(r, m, hidden), r, m, hidden, int(opponent),
                  EPILOGUES[epilogue])
    if err != 0:
        raise RuntimeError(f"afterstate_hidden_backward kernel launch "
                           f"failed: CUDA error {err} at {r} x {m} boards, "
                           f"hidden {hidden}")
    _COUNTERS["afterstate_hidden_backward"].launches += 1
    hw = hidden * 198
    return flat[:hw].view(hidden, 198), flat[hw:hw + hidden]


def _split(weights):
    """(w1, b1), the dense layers [(W, b)], the head (W, b) of the flat
    ``weights`` of ``afterstate_deep``."""
    pairs = list(zip(weights[0::2], weights[1::2]))
    return pairs[0], pairs[1:-1], pairs[-1]


def afterstate_deep_plain(boards, mover, n, weights, rewards, opponent,
                          epilogue, sign):
    """Plain PyTorch version of ``afterstate_deep`` (any device;
    differentiable in the weights): every slot through the network, then
    the epilogue's mask."""
    (w1, b1), layers, head = _split(weights)
    r, m, _ = boards.shape
    view = Bd.opponent_view(boards) if opponent else boards
    h = torch.relu(Fn.linear(F.encode_canonical(view, mover[:, None]), w1,
                             b1))
    for w, b in layers:
        h = torch.relu(Fn.linear(h, w, b))
    y = DN._y(Fn.linear(h, *head), rewards)
    if sign < 0:
        y = -y
    return torch.where(_valid(n, m, epilogue), y, FLOOR)


class _Deep(torch.autograd.Function):
    """The deep pass on the card as a differentiable function of its
    weights: the activations the backward needs are kept only when a
    gradient is wanted."""

    @staticmethod
    def forward(ctx, boards, mover, n, cfg, *weights):
        rewards, opponent, epilogue, sign, save = cfg
        (w1, b1), layers, head = _split(weights)
        lim = afterstate_collapse(boards, n, epilogue)
        out, h1, elem, count = afterstate_hidden(boards, mover, n, w1, b1,
                                                 opponent, epilogue, lim)
        acts = DN.dense_layers(h1, elem, count, out, layers, head, rewards,
                               sign, save)
        if save:
            ctx.save_for_backward(boards, mover, n, lim, h1, elem, count,
                                  *acts, *weights)
            ctx.cfg, ctx.depth = cfg, len(acts)
        return out

    @staticmethod
    def backward(ctx, grad):
        rewards, opponent, epilogue, sign, _ = ctx.cfg
        boards, mover, n, lim, h1, elem, count, *rest = ctx.saved_tensors
        acts, weights = rest[:ctx.depth], rest[ctx.depth:]
        (w1, _), layers, head = _split(weights)
        dpre, grads = DN.dense_layers_backward(h1, acts, elem, count, grad,
                                               layers, head, rewards, sign)
        dw1, db1 = afterstate_hidden_backward(boards, mover, n, dpre,
                                              w1.shape[0], opponent,
                                              epilogue, lim)
        return (None, None, None, None, dw1, db1, *grads)


def _check_deep(boards, mover, n, weights, opponent, epilogue, sign):
    if len(weights) < 6 or len(weights) % 2:
        raise ValueError(f"a deep network's weights are fc1, at least one "
                         f"dense layer and a head, in pairs; got "
                         f"{len(weights)} tensors")
    (w1, b1), _, _ = _split(weights)
    if any(w.dtype != torch.float32 for w in weights):
        raise NotImplementedError(
            f"a deep network runs in float32; bfloat16 is {DEEP_BF16_ITEM}")
    _check_hidden(boards, mover, n, w1, b1, opponent, epilogue)
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be 1 or -1, got {sign}")


def afterstate_deep(boards, mover, n, weights, rewards=None, opponent=False,
                    epilogue="logits", sign=1.0):
    """The pass of a deep network over (R, M, 52) int8 ``boards``:
    ``weights`` are [W1, b1, W_2, b_2, ..., W_head, b_head] float32 in
    ``nn.Linear``'s layout; ``rewards`` the outcome head's softmax weights
    (None: a scalar head).  The ``logits`` and ``masked`` epilogues, with
    ``opponent`` and ``sign``, as ``afterstate_eval``'s; returns (R, M)
    float32, differentiable in the weights."""
    weights = list(weights)
    _check_deep(boards, mover, n, weights, opponent, epilogue, sign)
    if not _on_card(boards):
        return afterstate_deep_plain(boards, mover, n, weights, rewards,
                                     opponent, epilogue, sign)
    save = torch.is_grad_enabled() and any(w.requires_grad for w in weights)
    cfg = (None if rewards is None else tuple(rewards), opponent, epilogue,
           sign, save)
    return _Deep.apply(boards, mover, n, cfg, *weights)


def afterstate_route_plain(boards, n, epilogue):
    """Plain PyTorch version of ``afterstate_route``."""
    r, m, _ = boards.shape
    kept = _kept(boards, n, epilogue)
    race = Bd.is_race(boards)
    lim = torch.zeros((len(GROUPS), r), dtype=torch.int32,
                      device=boards.device)
    slots = torch.zeros((len(GROUPS), r * m), dtype=torch.int32,
                        device=boards.device)
    for c, mask in enumerate((kept & ~race, kept & race)):
        lim[c] = mask.sum(1, dtype=torch.int32)
        row, slot = mask.nonzero(as_tuple=True)
        rank = mask.cumsum(1)[row, slot] - 1
        slots[c, row * m + rank] = slot.to(torch.int32)
    whole = collapsed_plain(boards, n, epilogue)[None, :] & (lim > 0)
    lim = torch.where(whole, torch.full_like(lim, WHOLE), lim)
    out = torch.full((r, m), FLOOR, dtype=torch.float32,
                     device=boards.device)
    return out, lim, slots


def afterstate_route(boards, n, epilogue):
    """The two groups of a routed pass over (R, M, 52) int8 ``boards``
    (``logits`` or ``masked`` epilogue): (``out`` (R, M) float32 holding
    the floor at every slot the epilogue does not keep and nothing yet at
    the kept ones, ``lim`` (2, R) int32 each row's kept boards of each
    class, ``WHOLE`` for a whole row's class (its one board, slot 0, and 0
    for the other class), ``slots`` (2, R M) int32 row r's kept slots of
    class c in slot order at c, r M .. r M + kept - 1).  Class 0 is
    contact, 1 race (``core.board.is_race``); entries of ``slots`` past a
    row's count are unspecified on the card.  Adds the whole rows to the
    tally of ``collapsed_rows``."""
    if epilogue not in ("logits", "masked"):
        raise ValueError(f"a routed pass takes the logits or masked "
                         f"epilogue, got {epilogue!r}")
    if boards.dtype != torch.int8 or boards.dim() != 3 or \
            boards.shape[2] != 52:
        raise TypeError(f"boards must be (R, M, 52) int8, got "
                        f"{tuple(boards.shape)} {boards.dtype}")
    if n.dtype != torch.int32 or tuple(n.shape) != boards.shape[:1] or \
            n.device != boards.device:
        raise TypeError(f"n must be ({boards.shape[0]},) int32 on "
                        f"{boards.device}")
    if _on_card(boards) and (not boards.is_contiguous() or
                             not n.is_contiguous() or
                             boards.shape[0] * boards.shape[1] >= 2**31):
        raise ValueError("the route kernel needs contiguous inputs of "
                         "fewer than 2^31 boards")
    dev = boards.device
    collapsed = _tally_of(_COLLAPSED, dev, 1)
    if not _on_card(boards):
        route = afterstate_route_plain(boards, n, epilogue)
        collapsed += (route[1] == WHOLE).sum()
        return route
    r, m, _ = boards.shape
    out = torch.empty((r, m), dtype=torch.float32, device=dev)
    lim = torch.empty((len(GROUPS), r), dtype=torch.int32, device=dev)
    slots = torch.empty((len(GROUPS), r * m), dtype=torch.int32, device=dev)
    err = _launch("afterstate_route_launch", dev, boards.data_ptr(),
                  n.data_ptr(), out.data_ptr(), lim.data_ptr(),
                  slots.data_ptr(), collapsed.data_ptr(), r, m,
                  EPILOGUES[epilogue])
    if err != 0:
        raise RuntimeError(f"afterstate_route kernel launch failed: CUDA "
                           f"error {err} at {r} x {m} boards")
    _COUNTERS["afterstate_route"].launches += 1
    return out, lim, slots


def _group_order(lim, slots, m):
    """A group's kept boards' elements r m + s in its order (rows in
    order, each row's slots of the group in order; a whole row's board
    marked ``~(r m)``), on the host."""
    r = lim.shape[0]
    whole = lim == WHOLE
    kept = torch.where(whole, 1, lim).long()
    rows = torch.repeat_interleave(torch.arange(r, device=lim.device), kept)
    first = torch.cumsum(kept, 0) - kept
    j = torch.arange(rows.shape[0], device=lim.device) - first[rows]
    return _mark(rows * m + slots.long()[rows * m + j], m, whole).to(
        torch.int32)


def _tally(dev):
    """The card's (or the CPU's) count of kept boards a group has sent
    through its network since the last ``zero_routed_rows``."""
    return _tally_of(_TALLY, dev, len(GROUPS))


def routed_rows() -> dict:
    """{group: kept boards sent through its network} since the last
    ``zero_routed_rows``, summed over devices: a host sync, for readings
    after a traced update, never for the hot path."""
    total = [0] * len(GROUPS)
    for t in _TALLY.values():
        total = [a + int(b) for a, b in zip(total, t.tolist())]
    return dict(zip(GROUPS, total))


def zero_routed_rows() -> None:
    for t in _TALLY.values():
        t.zero_()


def afterstate_hidden_routed(boards, mover, route, group, w1, b1,
                             opponent):
    """``afterstate_hidden`` of one group of a routed pass: ``route`` is
    ``afterstate_route``'s (out, lim, slots) and ``group`` 0 or 1; fc1 of
    that group's kept boards in its order (``h1``, ``elem``, ``count``
    as ``afterstate_hidden``'s; the floors are the route's).  Adds the
    count to the group's tally."""
    _, lim, slots = route
    r, m, _ = boards.shape
    h, dev = w1.shape[0], boards.device
    if not _on_card(boards):
        elem = _group_order(lim[group], slots[group], m)
        _tally(dev)[group] += elem.shape[0]
        return _first_layer_plain(boards, mover, elem, w1, b1, opponent)
    h1 = torch.empty((r * m, DN.ld(h)), dtype=torch.float32, device=dev)
    elem = torch.empty((r * m,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    tally = _tally(dev)
    err = _launch("afterstate_emit_routed_launch", dev, boards.data_ptr(),
                  mover.data_ptr(), lim[group].data_ptr(),
                  slots[group].data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  h1.data_ptr(), DN.ld(h), elem.data_ptr(), count.data_ptr(),
                  tally[group:].data_ptr(), r, m, h, int(opponent))
    if err != 0:
        raise RuntimeError(f"afterstate_hidden kernel launch failed: CUDA "
                           f"error {err} at {r} x {m} boards, hidden {h}, "
                           f"group {group}")
    _COUNTERS["afterstate_hidden"].launches += 1
    return h1, elem, count


def afterstate_hidden_backward_routed(boards, mover, route, group, dpre,
                                      hidden, opponent):
    """``afterstate_hidden_backward`` of one group of a routed pass:
    (dW1, db1) of that group's network from its dpre in its order."""
    _, lim, slots = route
    r, m, _ = boards.shape
    dev = boards.device
    if not _on_card(boards):
        return _first_layer_backward_plain(
            boards, mover, _group_order(lim[group], slots[group], m), dpre,
            hidden, opponent)
    floats = backward_scratch_floats(r, m, hidden)
    scratch = _scratch(floats, dev)
    flat = torch.empty((hidden * 198 + 2 * hidden + 1,), dtype=torch.float32,
                       device=dev)
    err = _launch("afterstate_backward_deep_routed_launch", dev,
                  boards.data_ptr(), mover.data_ptr(), lim[group].data_ptr(),
                  slots[group].data_ptr(), dpre.data_ptr(), dpre.shape[1],
                  _ptr(scratch), floats, flat.data_ptr(),
                  backward_blocks(r, m, hidden), r, m, hidden,
                  int(opponent))
    if err != 0:
        raise RuntimeError(f"afterstate_hidden_backward kernel launch "
                           f"failed: CUDA error {err} at {r} x {m} boards, "
                           f"hidden {hidden}, group {group}")
    _COUNTERS["afterstate_hidden_backward"].launches += 1
    hw = hidden * 198
    return flat[:hw].view(hidden, 198), flat[hw:hw + hidden]


def afterstate_routed_plain(boards, mover, n, weights, rewards, opponent,
                            epilogue, sign):
    """Plain PyTorch version of ``afterstate_routed`` (any device;
    differentiable in the weights): every slot through both networks, each
    slot's value from the network its class selects."""
    k = len(weights) // 2
    ys = [afterstate_deep_plain(boards, mover, n, weights[i * k:(i + 1) * k],
                                rewards, opponent, epilogue, sign)
          for i in range(len(GROUPS))]
    return torch.where(Bd.is_race(boards), ys[1], ys[0])


class _Routed(torch.autograd.Function):
    """The routed pass on the card as a differentiable function of both
    networks' weights (contact first): ``_Deep``'s, a group at a time."""

    @staticmethod
    def forward(ctx, boards, mover, n, cfg, *weights):
        rewards, opponent, epilogue, sign, save = cfg
        k = len(weights) // 2
        route = afterstate_route(boards, n, epilogue)
        out = route[0]
        saved, depths = [], []
        for group, name in enumerate(GROUPS):
            (w1, b1), layers, head = _split(weights[group * k:(group + 1)
                                                    * k])
            h1, elem, count = afterstate_hidden_routed(
                boards, mover, route, group, w1, b1, opponent)
            with span(f"dense_layers.{name}"):
                acts = DN.dense_layers(h1, elem, count, out, layers, head,
                                       rewards, sign, save)
            if save:
                saved += [h1, elem, count, *acts]
                depths.append(len(acts))
        if save:
            ctx.save_for_backward(boards, mover, *route[1:], *saved,
                                  *weights)
            ctx.cfg, ctx.depths = cfg, depths
        return out

    @staticmethod
    def backward(ctx, grad):
        rewards, opponent, _, sign, _ = ctx.cfg
        boards, mover, lim, slots, *rest = ctx.saved_tensors
        route = (None, lim, slots)
        k = sum(3 + d for d in ctx.depths)
        saved, weights = rest[:k], rest[k:]
        per = len(weights) // 2
        grads, at = [], 0
        for group, name in enumerate(GROUPS):
            h1, elem, count = saved[at:at + 3]
            acts = saved[at + 3:at + 3 + ctx.depths[group]]
            at += 3 + ctx.depths[group]
            (w1, _), layers, head = _split(weights[group * per:(group + 1)
                                                   * per])
            with span(f"dense_layers.{name}"):
                dpre, dense = DN.dense_layers_backward(
                    h1, acts, elem, count, grad, layers, head, rewards, sign)
            dw1, db1 = afterstate_hidden_backward_routed(
                boards, mover, route, group, dpre, w1.shape[0], opponent)
            grads += [dw1, db1, *dense]
        return (None, None, None, None, *grads)


def afterstate_routed(boards, mover, n, contact, race, rewards=None,
                      opponent=False, epilogue="logits", sign=1.0):
    """The pass of a routed model over (R, M, 52) int8 ``boards``: each
    kept board through the network its position's class selects, the
    ``contact`` weights or the ``race`` weights (each as
    ``afterstate_deep``'s ``weights``, the same shapes); the rest as
    ``afterstate_deep``.  Returns (R, M) float32, differentiable in both
    networks' weights (a network that no kept board reaches gets zero
    gradients)."""
    contact, race = list(contact), list(race)
    if [tuple(w.shape) for w in contact] != [tuple(w.shape) for w in race]:
        raise ValueError("the contact and race networks' weights differ in "
                         "shape")
    weights = contact + race
    for ws in (contact, race):
        _check_deep(boards, mover, n, ws, opponent, epilogue, sign)
    if not _on_card(boards):
        return afterstate_routed_plain(boards, mover, n, weights, rewards,
                                       opponent, epilogue, sign)
    save = torch.is_grad_enabled() and any(w.requires_grad for w in weights)
    cfg = (None if rewards is None else tuple(rewards), opponent, epilogue,
           sign, save)
    return _Routed.apply(boards, mover, n, cfg, *weights)


def evaluate(model, boards, mover, n, head, opponent=False,
             epilogue="logits", sign=1.0, chunk=0):
    """``afterstate_eval`` with the weights of ``model`` (an ``MLP``):
    ``fc1`` and the head ``head`` ("score" or "value"), cast to its
    compute dtype, which the kernels take as it is (float32 or
    bfloat16).  A model with a ``trunk`` runs ``afterstate_deep`` (with
    ``race``, ``afterstate_routed``): its value head is the outcome head
    where the model has one."""
    if model.cfg.race:
        (contact, rewards), (race, _) = [model.deep_weights(head, net)
                                         for net in GROUPS]
        return afterstate_routed(boards, mover.to(torch.int32),
                                 n.to(torch.int32), contact, race, rewards,
                                 opponent, epilogue, sign)
    if model.cfg.trunk:
        weights, rewards = model.deep_weights(head)
        return afterstate_deep(boards, mover.to(torch.int32),
                               n.to(torch.int32), weights, rewards, opponent,
                               epilogue, sign)
    dt = model.dtype
    fc1, out = model.layers["fc1"], model.layers[head]
    weights = [p.to(dt) for p in (fc1.weight, fc1.bias, out.weight,
                                  out.bias)]
    return afterstate_eval(boards, mover.to(torch.int32), n.to(torch.int32),
                           *weights, opponent, epilogue, sign, chunk)


afterstate_eval.launches = 0
afterstate_eval_backward.launches = 0
afterstate_hidden.launches = 0
afterstate_hidden_backward.launches = 0
afterstate_route.launches = 0
# the routed pass's tally of kept boards by group, a tensor a device
_TALLY: dict = {}
# the whole rows found, a tensor a device
_COLLAPSED: dict = {}
# the function objects that own the counts, so that a caller who wraps a
# wrapper (to capture its inputs) still counts on the original
_COUNTERS = {"afterstate_eval": afterstate_eval,
             "afterstate_eval_backward": afterstate_eval_backward,
             "afterstate_hidden": afterstate_hidden,
             "afterstate_hidden_backward": afterstate_hidden_backward,
             "afterstate_route": afterstate_route}
