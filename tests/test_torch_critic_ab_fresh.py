"""The critic-batch A/B's `fresh` mode against the JAX package's, as
`tests/test_torch_critic_ab.py` holds the `reused` one (its fixture, noise
and limits; a file of its own so that each keeps to its minute on one
worker)."""
import torch

from test_torch_critic_ab import check_run_against_jax, jax_app  # noqa: F401

torch.set_num_threads(1)


def test_fresh_run_matches_jax(jax_app):  # noqa: F811
    check_run_against_jax("fresh", jax_app)
