"""End to end: the PyTorch port's ``run_identify`` (device="cpu") against the
JAX package's on one small simulated DB (the layout of test_identify_e2e).

Tolerance: none.  Every output file (final_report.txt, strain_prob.txt and
each C*/StrainVote.report, Enet fields included) must be byte-identical:
counts are exact integers, the Pre-Scan column sums and fold Grams are
exact, and the host code after them is the same.  The ``_streamed`` cases
set the cap on kept payloads to 0 bytes, so the L2 union count streams the
sample again instead of reading the main count's payloads.
"""

import pytest

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify as run_identify_jax
from strainscan_tpu_torch import timing
from strainscan_tpu_torch.identify import count as icount
from strainscan_tpu_torch.identify.pipeline import run_identify

from _torch_sim import (assert_reports_identical, e2e_fixture,  # noqa: F401
                        one_torch_thread)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    return (d, *e2e_fixture(d))


# case: (sample, cfg, truth, whether the L2 vote counts a union, the cap
# on kept payload bytes: None, the default)
CASES = {
    "single": ("single", IdentifyConfig(), {"B1"}, False, None),
    "cross": ("cross", IdentifyConfig(), {"B1", "D1"}, True, None),
    "cross_streamed": ("cross", IdentifyConfig(), {"B1", "D1"}, True, 0),
    "intra_enet": ("intra", IdentifyConfig(), {"A1", "A2"}, True, None),
    "intra_enet_streamed": ("intra", IdentifyConfig(), {"A1", "A2"}, True,
                            0),
    "strain_prob": ("cross", IdentifyConfig(strain_prob=True), {"B1", "D1"},
                    True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reports_byte_identical_to_jax(fixture, case, monkeypatch):
    d, db_dir, paths = fixture
    sample, cfg, truth, union, cap = CASES[case]
    if cap is not None:
        monkeypatch.setattr(icount, "KEEP_CAP_BYTES", cap)
    out_jax, out_torch = str(d / f"jax_{case}"), str(d / f"torch_{case}")
    res_jax = run_identify_jax(paths[sample], "", db_dir, out_jax, cfg)
    with timing.span("test/sample") as root:
        res = run_identify(paths[sample], "", db_dir, out_torch, "cpu", cfg)
    assert res is not None and res_jax is not None
    assert sorted(res) == sorted(res_jax)
    # the main count's span, then the union count's where the vote counts
    # one: its source, and whether the main count's keeping hit the cap
    counts = sorted((s for s in timing.SPANS if s.sample == root.sample
                     and s.name == "count/sample"), key=lambda s: s.t0)
    kept = union and cap is None
    assert [s.attrs["source"] for s in counts] == ["stream"] + (
        ["kept" if kept else "stream"] if union else [])
    assert [s.attrs.get("over_cap", False) for s in counts] == [
        cap == 0] + [False] * union
    assert (counts[-1].attrs.get("kept_bytes", 0) > 0) == kept
    got = assert_reports_identical(out_torch, out_jax, truth)
    if case == "intra_enet":
        assert any(n.endswith("StrainVote.report") for n in got)
    if case == "strain_prob":
        assert "strain_prob.txt" in got
