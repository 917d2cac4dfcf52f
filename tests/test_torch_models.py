"""Port parity: the MLP, weight carry-over, GAE, presets, device rules
and the import guard.

Tolerances: float32 forward passes agree to 1e-5 (one 198x32 and one
32xA product each; only the summation order differs); bfloat16 compute
to 2e-2 (bf16 keeps 8 bits of mantissa, and the two frameworks may
round intermediate sums at different points); GAE recursions to 1e-6
(the same float32 operations in the same order)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.models import mlp as JMLP
from mlp_ppo_2ply_p3_tpu.ppo import gae as JG
from mlp_ppo_2ply_p3_tpu.utils import config as JCONF
from mlp_ppo_2ply_p3_tpu_torch import resolve_device
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC
from mlp_ppo_2ply_p3_tpu_torch.ppo import gae as TG
from mlp_ppo_2ply_p3_tpu_torch.utils import config as TCONF
from mlp_ppo_2ply_p3_tpu_torch.utils import convert

from .test_gae import np_gae, np_mc_ref, rand_case
from .test_torch_utils import nn_, tt

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mlp_ppo_2ply_p3_tpu_torch"


def _jax_params(hidden=32, actions=64, seed=0):
    cfg = JMLP.ModelConfig(hidden_size=hidden, action_size=actions)
    params = JMLP.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, params), cfg


# --- mlp + convert -----------------------------------------------------------


@pytest.mark.parametrize("hidden,actions", [(32, 64), (128, 256)])
def test_mlp_float32_matches_jax(hidden, actions):
    params, jcfg = _jax_params(hidden, actions)
    model = convert.params_from_jax(params, device="cpu")
    assert model.cfg == TMLP.ModelConfig(hidden_size=hidden,
                                         action_size=actions)
    x = np.random.default_rng(1).random((3, 5, 198)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    logits, value = model(tt(x))
    jl, jv = JMLP.forward(jp, jnp.asarray(x), jcfg)
    assert logits.shape == (3, 5, actions) and value.shape == (3, 5)
    np.testing.assert_allclose(nn_(logits), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(nn_(value), np.asarray(jv), atol=1e-5)
    for head in ("value", "score"):
        np.testing.assert_allclose(
            nn_(getattr(model, head)(tt(x))),
            np.asarray(getattr(JMLP, head)(jp, jnp.asarray(x), jcfg)),
            atol=1e-5, err_msg=head)
    np.testing.assert_allclose(
        nn_(model.trunk(tt(x))),
        np.asarray(JMLP.trunk(jp, jnp.asarray(x), jcfg)), atol=1e-5)


def test_mlp_bfloat16_compute_dtype():
    params, jcfg = _jax_params()
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg = TMLP.ModelConfig(hidden_size=32, action_size=64,
                            compute_dtype="bfloat16")
    model = convert.params_from_jax(params, tcfg, device="cpu")
    x = np.random.default_rng(2).random((16, 198)).astype(np.float32)
    logits, value = model(tt(x))
    assert logits.dtype == torch.float32 and value.dtype == torch.float32
    jl, jv = JMLP.forward(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(x), jcfg)
    np.testing.assert_allclose(nn_(logits), np.asarray(jl), atol=2e-2)
    np.testing.assert_allclose(nn_(value), np.asarray(jv), atol=2e-2)


def test_params_round_trip_and_shape_check():
    params, _ = _jax_params()
    model = convert.params_from_jax(params, device="cpu")
    back = convert.params_to_numpy(model)
    for name in TMLP.HEADS:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k], params[name][k])
    assert back["fc1"]["w"].shape == (198, 32)
    bad = TMLP.MLP(TMLP.ModelConfig(hidden_size=16, action_size=64),
                   device="cpu")
    with pytest.raises(ValueError):
        convert.load_jax_params(bad, params)


def test_mlp_init_distribution():
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from the given generator:
    bounded, seeded, and reproducible."""
    cfg = TMLP.ModelConfig(hidden_size=64, action_size=32)
    a = TMLP.MLP(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = TMLP.MLP(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (name, lin), lin_b in zip(a.layers.items(), b.layers.values()):
        bound = 1.0 / np.sqrt(lin.in_features)
        top = float(lin.weight.detach().abs().max())
        assert 0.9 * bound < top <= bound, name
        assert torch.equal(lin.weight, lin_b.weight)
        assert torch.equal(lin.bias, lin_b.bias)


# --- gae ---------------------------------------------------------------------


def test_gae_and_mc_against_jax_and_numpy():
    rng = np.random.default_rng(0)
    for t, b in ((13, 5), (1, 3), (40, 16)):
        r, v, d, lv = rand_case(rng, t, b)
        flips = rng.random((t, b)) < 0.7
        for got, want in (
            (TG.gae(tt(r), tt(v), tt(d), tt(lv), 0.97, 0.9),
             JG.gae(*(jnp.asarray(x) for x in (r, v, d, lv)), 0.97, 0.9)),
            (TG.negamax_gae(tt(r), tt(v), tt(d > 0), tt(flips), tt(lv),
                            0.99, 0.95),
             JG.negamax_gae(*(jnp.asarray(x) for x in (r, v, d > 0, flips,
                                                        lv)), 0.99, 0.95)),
        ):
            for g, w in zip(got, want):
                np.testing.assert_allclose(nn_(g), np.asarray(w), atol=1e-6)
        np.testing.assert_allclose(
            nn_(TG.gae(tt(r), tt(v), tt(d), tt(lv), 0.97, 0.9)[0]),
            np_gae(r, v, d, lv, 0.97, 0.9)[0], atol=1e-5)
        mc = TG.mc_returns_ref(tt(r), tt(d), 0.99)
        np.testing.assert_allclose(
            nn_(mc), np.asarray(JG.mc_returns_ref(jnp.asarray(r),
                                                  jnp.asarray(d), 0.99)),
            atol=1e-6)
        np.testing.assert_allclose(nn_(mc), np_mc_ref(r, d, 0.99), atol=1e-5)


def test_negamax_gae_hand_case():
    """The alternating 3-step game of the JAX package's hand case: A, B,
    A to move; A wins at t=2.  B's enabling move gets negative credit."""
    gamma, lam = 0.9, 0.8
    r = torch.tensor([[0.0], [0.0], [1.0]])
    v = torch.tensor([[0.1], [-0.2], [0.3]])
    done = torch.tensor([[False], [False], [True]])
    flips = torch.ones((3, 1), dtype=torch.bool)
    adv, ret = TG.negamax_gae(r, v, done, flips, torch.tensor([0.7]),
                              gamma, lam)
    a2 = 1.0 - 0.3
    a1 = (gamma * (-0.3) + 0.2) + gamma * lam * (-1.0) * a2
    a0 = (gamma * 0.2 - 0.1) + gamma * lam * (-1.0) * a1
    np.testing.assert_allclose(nn_(adv)[:, 0], [a0, a1, a2], rtol=1e-6)
    np.testing.assert_allclose(nn_(ret), nn_(adv + v), rtol=1e-6)
    assert a2 > 0 and a1 < 0
    # no flips (invalid-action retries): negamax GAE is plain GAE
    rng = np.random.default_rng(0)
    rr, vv, _, lv = rand_case(rng, 6, 4)
    zero = np.zeros((6, 4), bool)
    a_neg, _ = TG.negamax_gae(tt(rr), tt(vv), tt(zero), tt(zero), tt(lv),
                              0.99, 0.95)
    a_std, _ = TG.gae(tt(rr), tt(vv), tt(zero), tt(lv), 0.99, 0.95)
    np.testing.assert_allclose(nn_(a_neg), nn_(a_std), rtol=1e-5)


# --- presets -----------------------------------------------------------------


def test_presets_match_jax():
    """Every preset equals the JAX package's, except the 2-ply search's
    chunk sizes, which were sized again for the card (they cannot change
    a result)."""
    chunks = ("game_chunk", "dbl_game_chunk", "eval_slot_chunk")
    assert set(TCONF.PRESETS) == set(JCONF.PRESETS)
    for name, jcfg in JCONF.PRESETS.items():
        got = dataclasses.asdict(TCONF.get_preset(name))
        want = dataclasses.asdict(jcfg)
        for d in (got, want):
            for k in chunks:
                d["search"].pop(k)
        assert got == want, name
    assert tuple(getattr(TCONF.SearchConfig(), k) for k in chunks) == (
        8192, 2048, 128)
    cfg = TCONF.get_preset("train4096")
    assert cfg.ppo.num_envs == 4096 and cfg.ppo.num_minibatches == 32
    assert cfg.env.movegen.max_moves == 256 and cfg.model.hidden_size == 128
    with pytest.raises(KeyError):
        TCONF.get_preset("nope")


# --- device rules ------------------------------------------------------------


def test_cuda_requested_without_card_raises(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        TMLP.MLP(TMLP.ModelConfig(hidden_size=8, action_size=8))
    assert resolve_device("cpu") == torch.device("cpu")


def test_compact_rows_refuses_other_devices():
    payload = torch.zeros((2, 8, 3), dtype=torch.int8, device="meta")
    valid = torch.zeros((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        TC.compact_rows(payload, valid, 4)


# --- import guard ------------------------------------------------------------

FORBIDDEN_TOP = {"jax", "jaxlib", "optax", "flax", "chex"}
JAX_PKG = "mlp_ppo_2ply_p3_tpu"


def _forbidden(name: str) -> bool:
    """``name`` is a JAX module or the JAX package.  The port's own name
    starts with the JAX package's, so compare whole dotted components."""
    parts = name.split(".")
    return parts[0] in FORBIDDEN_TOP or parts[0] == JAX_PKG


def _port_sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("optax", True),
    ("mlp_ppo_2ply_p3_tpu", True), ("mlp_ppo_2ply_p3_tpu.core.oracle", True),
    ("mlp_ppo_2ply_p3_tpu_torch", False),
    ("mlp_ppo_2ply_p3_tpu_torch.core", False), ("jaxtyping", False),
    ("torch", False),
])
def test_import_guard_rule(name, bad):
    assert _forbidden(name) is bad


def test_port_imports_no_jax():
    """AST scan of every module of the port and of chip_smoke.py: no
    import of JAX, optax or the JAX package, and no relative import that
    climbs out of the port."""
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        depth = len(path.relative_to(ROOT).parts) - 1  # package nesting
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    if node.level > depth:
                        offenders.append((path.name, node.lineno, "..."))
                    continue
                names = [node.module or ""]
            else:
                continue
            offenders += [(path.name, node.lineno, n) for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    importing JAX, optax or the JAX package fails."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN_TOP | {JAX_PKG})!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
