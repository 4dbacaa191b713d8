"""Sanitizers and the Chrome-trace exporter of the torch port
(``utils/validate.py``, ``utils/timing.trace``)."""

import pytest
import torch

from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.utils import timing, validate


def _drum():
    """The small drum (n = 64, Lmax 2, prefiltered pair list, cadence
    10) on the CPU."""
    return scenarios.rotating_drum(n=64, lmax=2, k_max=16, pair_capacity=320,
                                   stage2_capacity=192, rebuild_every=10,
                                   device="cpu")


def test_check_finite_raises_on_injected_nan():
    _, st, _ = _drum()
    validate.check_finite(st, "clean")
    x = st.x.clone()
    x[5, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"after step.*'x': 1"):
        validate.check_finite(st.replace(x=x), "after step")
    # Inactive slots are not audited.
    with pytest.raises(FloatingPointError):
        validate.check_finite(st.replace(tau=st.tau + float("inf")))
    validate.check_finite(st.replace(
        x=x, active=st.active & (torch.arange(st.cap) != 5)))


def test_overflow_audit_and_assert():
    sim, _, ng = _drum()
    rep = validate.audit_capacities(sim, ng)
    assert rep == {"overflow_channel": (0, 0), "k_max": 16,
                   "pair_capacity": 320}
    validate.assert_no_overflow(sim, ng)
    bad = ng.replace(overflow=torch.tensor(37))
    assert validate.audit_capacities(sim, bad)["overflow_channel"] == (37, 0)
    with pytest.raises(RuntimeError, match="gated channel = 37"):
        validate.assert_no_overflow(sim, bad)


def test_determinism_check_small_drum():
    """Two CPU runs of the small drum (20 steps, two cadence blocks) give
    bitwise-identical state and neighbour containers; a run with fresh
    noise does not."""
    sim, st, ng = _drum()
    assert validate.determinism_check(lambda s, n: sim.run(s, n, 20),
                                      lambda: (st, ng))
    assert not validate.determinism_check(
        lambda s, n: s.x + torch.rand_like(s.x), lambda: (st, ng))


def test_trace_writes_a_chrome_trace(tmp_path):
    sim, st, ng = _drum()
    with timing.trace(tmp_path / "tr") as prof:
        sim.run(st, ng, 2)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
