"""The critic-batch A/B of the port (`dpig_tpu_torch.apps.critic_batch_ab`)
against the JAX package's (`scripts/critic_batch_ab.py`), on the CPU:
`run(mode, 3, 4)` in each mode from JAX's own init (bridged), on the same
synthetic batches (SyntheticLoader(seed=7+seed) on both sides), with JAX's
threefry noise handed to the port as tensors: every step's mapper noise
(`fold_in(PRNGKey(100 seed + 1), i)` split as JAX's `_step_impl` splits
it) and the moment match's draws (`fold_in(.., 10000 + i)`).

JAX's `real_embs` and `sample_embs` are jitted here (its script runs them
eagerly, ~130 frozen-encoder forwards per mode, over a minute): the same
functions. The `fresh` mode is `tests/test_torch_critic_ab_fresh.py`, so
that each file keeps to its minute on one worker.

Tolerance. Both sides are float32 and sum in other orders; RMSProp's
first update moves a parameter +-sqrt(10) lr by its gradient's sign, so a
near-zero gradient rounded to the other sign would move it 5.1e-4 apart
(`tests/test_torch_stage2.py`). None flipped here: over 3 steps of batch
4 the W tails (~1e-3) read 8.7e-11 apart at most and the moment gaps
(0.07-0.23) 3.0e-8 (1.3e-7 relative). The limits, 1e-7 absolute on a W
tail and 1e-5 relative on a gap, sit 100x and more above those readings
and below what telling the modes apart needs: `reused` and `fresh` differ
by 1.2e-5 to 6.0e-5 in the tails and 2.7e-6 relative and more in the gaps.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dpig_tpu.apps.stage2_app import Stage2AppApp as JaxAppApp
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.losses import gan as jgan
from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
from dpig_tpu_torch.apps import critic_batch_ab as ab
from dpig_tpu_torch.bridge import params_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import critic_batch_ab as jab  # noqa: E402

torch.set_num_threads(1)

STEPS, B, SEED = 3, 4, 0
FG, BG = 7 * 32, 4 * 32
NETS = ("Encoder", "ID_AE", "Gaussian_FC_Fg", "Gaussian_FC_Bg", "Fg_FCDis",
        "Bg_FCDis")
W_TOL, GAP_TOL = 1e-7, 1e-5


def _jax_noise(rng):
    rf, rb = jax.random.split(rng)
    return np.concatenate([np.asarray(jax_noise(rf, B, FG)),
                           np.asarray(jax_noise(rb, B, BG))], -1)


def _noise(kind, i):
    """JAX's draws in the port's layout."""
    rng = jax.random.PRNGKey(100 * SEED + 1)
    if kind == "sample":
        return torch.from_numpy(_jax_noise(jax.random.fold_in(rng,
                                                              10_000 + i)))
    rngs = jax.random.split(jax.random.fold_in(rng, i),
                            2 + 2 * jgan.CRITIC_ITERS)
    return torch.from_numpy(np.stack(
        [_jax_noise(r) for r in [rngs[0]] + [rngs[2 + j] for j in
                                             range(jgan.CRITIC_ITERS)]]))


@pytest.fixture(scope="module")
def jax_app():
    """JAX's Stage2AppApp for its run: the eager helpers jitted, and
    `init_state` recorded (the state each run starts from, bridged to the
    port's sub-trees) and drawn once for both modes (the same key)."""
    real, sample = JaxAppApp.real_embs, JaxAppApp.sample_embs
    init_state = JaxAppApp.init_state
    drawn = {}

    def recorded_init(self, rng, frozen_params=None):
        key = tuple(np.asarray(jax.random.key_data(rng)).ravel())
        if key not in drawn:
            drawn[key] = init_state(self, rng, frozen_params)
        st = drawn[key]
        tree = {**st.g_params, **st.d_params, **st.frozen_params}
        inits.append(params_from_flax(
            jax.tree_util.tree_map(np.asarray, tree), NETS))
        return jax.tree_util.tree_map(jax.numpy.array, st)  # runs donate

    inits = []
    JaxAppApp.real_embs = jax.jit(real, static_argnums=0)
    JaxAppApp.sample_embs = jax.jit(sample, static_argnums=(0, 3))
    JaxAppApp.init_state = recorded_init
    yield inits
    JaxAppApp.real_embs, JaxAppApp.sample_embs = real, sample
    JaxAppApp.init_state = init_state


def check_run_against_jax(mode, inits):
    """JAX's run, then the port's from the state it started from."""
    want = jab.run(mode, STEPS, B, SEED)
    got = ab.run(mode, STEPS, B, SEED, platform="cpu", params=inits[-1],
                 noise=_noise)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("W_"):
            assert abs(got[k] - v) <= W_TOL, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= GAP_TOL * abs(v), (k, got[k], v)


def test_reused_run_matches_jax(jax_app):
    check_run_against_jax("reused", jax_app)


def test_modes_differ_and_the_cli_runs_both(capsys, monkeypatch):
    """The port's own draws: the two modes train apart; the CLI prints
    both columns and their JSON (the moment match over 32 embeddings,
    to keep this quick)."""
    monkeypatch.setattr(ab, "MOMENT_SAMPLES", 32)
    res = ab.main(["2", "4", "1", "--platform=cpu"])
    assert set(res) == {"reused", "fresh"}
    assert res["reused"] != res["fresh"]
    out = capsys.readouterr().out
    assert "W_fg_tail" in out and '"fresh"' in out.splitlines()[-1]
    with pytest.raises(ValueError, match="mode"):
        ab.run("stale", 1, 4, platform="cpu")
