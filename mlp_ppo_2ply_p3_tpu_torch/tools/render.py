"""ASCII board renderer (host side, for debugging and analysis).

Port of ``mlp_ppo_2ply_p3_tpu/tools/render.py``, numpy only, with the
same strings: the top half shows points 12..23, the bottom half 11..0,
with BAR and OFF columns.  It takes the port's tensors (on any device)
as well as numpy arrays.
"""

from __future__ import annotations

import numpy as np

P0_TOKEN, P1_TOKEN = "x", "o"


def _np(x):
    """A tensor (on any device) or an array -> numpy."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def board_to_ascii(points, bar, off, turn=None, dice=None) -> str:
    """points: (2, 24) ints; bar/off: (2,) ints.  Returns a multi-line
    ASCII diagram."""
    points = _np(points)
    bar = _np(bar)
    off = _np(off)

    def cell(idx):
        n0, n1 = int(points[0, idx]), int(points[1, idx])
        if n0 and n1:
            return "!?"
        if n0:
            return f"{P0_TOKEN}{n0}"
        if n1:
            return f"{P1_TOKEN}{n1}"
        return " ."

    top = [cell(i) for i in range(12, 24)]
    bottom = [cell(i) for i in range(11, -1, -1)]
    lines = [
        "+----12--13--14--15--16--17-BAR--18--19--20--21--22--23--OFF--+",
        "|    "
        + "  ".join(top[:6])
        + f"  {P1_TOKEN}{int(bar[1])}  "
        + "  ".join(top[6:])
        + f"   {P1_TOKEN}{int(off[1]):2d}  |",
        "|" + " " * 61 + "|",
        "|    "
        + "  ".join(bottom[:6])
        + f"  {P0_TOKEN}{int(bar[0])}  "
        + "  ".join(bottom[6:])
        + f"   {P0_TOKEN}{int(off[0]):2d}  |",
        "+----11--10---9---8---7---6-BAR---5---4---3---2---1---0--OFF--+",
    ]
    if turn is not None:
        tok = P0_TOKEN if int(turn) == 0 else P1_TOKEN
        extra = f"to move: {tok}"
        if dice is not None:
            d = _np(dice)
            extra += f"   dice: {int(d[0])}-{int(d[1])}"
        lines.append(extra)
    return "\n".join(lines)


def render_state(state, i: int = 0) -> str:
    """Render game ``i`` of a batched ``EnvState``."""
    return board_to_ascii(
        state.points[i], state.bar[i], state.off[i], int(state.turn[i]),
        state.dice[i],
    )
