"""Driver-hook smoke tests: entry() compiles; dryrun mesh factorization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_entry_eval_shape():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.eval_shape(fn, *args)
    assert out.shape == args[0].shape and out.dtype == args[0].dtype


# Over 25 minutes on the CPU, longer than the 1470 s the whole suite is given:
# it chains about a dozen distributed gates, several in Pallas interpret mode.
# test_parallel, test_dist_*, test_filters, test_second_derivative, test_models
# and test_vec run those gates at their own sizes, all but the one step of
# NavierStokes.distributed against the single-device model.
@pytest.mark.slow
def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)
