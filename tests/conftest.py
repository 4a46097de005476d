import jax
import pytest

# NOTE: no xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device (DESIGN.md / assignment). Distributed tests
# spawn subprocesses with their own XLA_FLAGS.

jax.config.update("jax_enable_x64", False)

# Derandomized hypothesis profile for CI (selected with
# --hypothesis-profile=ci): the PR 4 property tests (quant
# mass-exactness, merge linearity, pack/unpack) draw the same examples
# on every run, and print_blob emits the @reproduce_failure blob on
# error so a red CI log alone reproduces the failing case locally.
# Guarded import: hypothesis is a dev-only dependency and the tests
# using it importorskip it themselves.
try:
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile("ci", derandomize=True,
                                   print_blob=True)
except ImportError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running distributed/e2e tests (deselect with "
        '-m "not slow")')
    config.addinivalue_line(
        "markers",
        "dp_differential: reduced W=4 subprocess differential tier "
        "(overlap vs per_node DP layouts) — runs per PR in its own CI "
        "job; the full differential suite stays in the nightly slow "
        "tier")
    config.addinivalue_line(
        "markers",
        "ring_differential: Pallas ring-allreduce vs jnp-oracle "
        "differential tier (tests/test_ring.py) — reduced W∈{2,4} "
        "subset per PR in the `ring-differential` CI job, full W=8 "
        "nightly; excluded from tier1-fast")
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs a CUDA device (the PyTorch port's kernels); "
        "decided inside the test, which skips without one")


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)
