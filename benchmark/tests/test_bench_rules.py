"""The reference's frozen rules equal the program's on the CPU, where the
program runs its plain versions: a reset and env steps at B=600, where
the non-doubles sub-batch's capacity binds at the reset, at
``afterstate4096``'s widths; and the 2-ply reply lists of every roll.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.reference import rules  # noqa: E402
from benchmark.reference import twoply as ref_twoply  # noqa: E402

CFG = run.load_json(ROOT, "benchmark", "configs", "afterstate4096.json")
FIELDS = rules.BOARD_FIELDS + ("after", "n_moves", "overflow")


def _same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_env_matches_the_program():
    from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
    from mlp_ppo_2ply_p3_tpu_torch.env import bg_env

    mg = rules.Movegen(**CFG["movegen"])
    env_cfg = bg_env.EnvConfig(movegen=MovegenConfig(**CFG["movegen"]))
    b = 600
    g_ref, g_prog = torch.Generator(), torch.Generator()
    g_ref.manual_seed(31)
    g_prog.manual_seed(31)
    ref = rules.reset(g_ref, b, mg)
    prog = bg_env.reset(g_prog, env_cfg, b, device="cpu")
    assert bool(ref.overflow.any())    # the capacity binds
    _same(ref, prog)
    pick = torch.Generator()
    pick.manual_seed(5)
    for _ in range(6):
        u = torch.rand((b,), generator=pick)
        action = (u * ref.n_moves.clamp(min=1)).to(torch.int32)
        ref, _, _ = rules.step(ref, action, rules.draw_step(g_ref, b), mg)
        prog, _ = bg_env.step_with_draws(prog, action,
                                         bg_env.draw_step(g_prog, b), env_cfg)
        _same(ref, prog)


def test_reply_lists_match_the_program():
    from mlp_ppo_2ply_p3_tpu_torch.agents import twoply
    from mlp_ppo_2ply_p3_tpu_torch.core import movegen as MG
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig

    gen = torch.Generator()
    gen.manual_seed(3)
    mg = rules.Movegen(**CFG["movegen"])
    s = rules.reset(gen, 64, mg)
    for _ in range(8):
        action = (torch.rand((64,), generator=gen)
                  * s.n_moves.clamp(min=1)).to(torch.int32)
        s, _, _ = rules.step(s, action, rules.draw_step(gen, 64), mg)
    vecs = rules.opponent_view(s.after[:, 0])
    rcfg = ref_twoply.reply_movegen(512)
    pcfg = twoply._reply_cfg(SearchConfig())
    for lo, hi in rules.ROLLS_21:
        lo, hi = int(lo), int(hi)
        want = rules.reply_lists(vecs, (lo, hi), rcfg)
        full = lambda d: torch.full((64,), d, dtype=torch.int32)  # noqa
        if lo == hi:
            got = MG.doubles_afterstates_batch(vecs, full(lo), pcfg)
        else:
            got = MG.nondoubles_afterstates_batch(vecs, full(hi), full(lo),
                                                  pcfg)
        for w, g in zip(want, got):
            assert torch.equal(w, g), (lo, hi)
