"""Board geometry and game constants (a copy of the JAX package's
``core/constants.py``; the port imports nothing from that package).

- 24 points, indexed 0..23.
- Player 0 ("P1") moves in the +1 direction (0 -> 23), home board 18..23,
  enters from the bar at point ``die - 1``.
- Player 1 ("P2") moves in the -1 direction (23 -> 0), home board 0..5,
  enters from the bar at point ``24 - die``.
- 15 checkers per player.

Canonical frame: the move engine works in a *current-player frame* where
the mover always travels in the +1 direction (point index ``i`` of
player 1 maps to ``23 - i``).
"""

NUM_POINTS = 24
NUM_CHECKERS = 15

PLAYER1 = 0  # moves 0 -> 23
PLAYER2 = 1  # moves 23 -> 0

# Origin / destination sentinels in the *canonical* (current-player) frame.
BAR = 24       # as an origin: enter from the bar
OFF = 24       # as a destination: bear off (encoded separately from points)

# Initial position (absolute frame).
INITIAL_POINTS_P1 = {0: 2, 11: 5, 16: 3, 18: 5}
INITIAL_POINTS_P2 = {23: 2, 12: 5, 7: 3, 5: 5}

# Match / reward constants.
REWARD_INVALID_ACTION = -1.0
REWARD_PASS = 0.0
REWARD_WIN_NORMAL = 1.0
REWARD_WIN_GAMMON = 1.5
REWARD_WIN_BACKGAMMON = 2.0
MATCH_LENGTH = 15
MAX_LEGAL_MOVES = 500  # reference env cap; MovegenConfig.max_moves is configurable

FEATURE_DIM = 198
