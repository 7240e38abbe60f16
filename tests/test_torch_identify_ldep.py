"""Low-depth and extra-region modes of the PyTorch port's ``run_identify``
(device="cpu") against the JAX package's, on the DB layout of
test_identify_e2e.

Tolerance: none; every text output is byte-identical.
"""

import pytest

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify as run_identify_jax
from strainscan_tpu_torch.identify.pipeline import run_identify

from _torch_sim import (assert_reports_identical, e2e_fixture,  # noqa: F401
                        one_torch_thread)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ldep")
    return (d, *e2e_fixture(d))


CASES = {
    "low_dep_1": ("intra", IdentifyConfig(low_dep=1), {"A1", "A2"}),
    "low_dep_2": ("single", IdentifyConfig(low_dep=2, strain_prob=True),
                  {"B1"}),
    # extra-region mode relaxes the Pre-Scan gates; parity only
    "extra_region": ("intra", IdentifyConfig(extra_region=True), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mode_reports_byte_identical_to_jax(fixture, case):
    d, db_dir, paths = fixture
    sample, cfg, truth = CASES[case]
    out_jax, out_torch = str(d / f"jax_{case}"), str(d / f"torch_{case}")
    res_jax = run_identify_jax(paths[sample], "", db_dir, out_jax, cfg)
    res = run_identify(paths[sample], "", db_dir, out_torch, "cpu", cfg)
    assert res is not None and res_jax is not None
    assert sorted(res) == sorted(res_jax)
    assert_reports_identical(out_torch, out_jax, truth)
