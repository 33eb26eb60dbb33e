"""chip_smoke.py: every phase at tiny sizes on the CPU against the same
references it uses on the card, and its refusal to run without a GPU.

The full-size run needs a GPU (`python chip_smoke.py`); the `chip`
test below runs the phases there at a reduced size and skips elsewhere
(`JAX_PLATFORMS=cuda python -m pytest tests -m chip` on a GPU machine).
"""

import jax
import pytest

import chip_smoke as cs

TINY = {
    "static": lambda rep, devs: cs.phase_static(rep, depth=5, width=32,
                                                n_check=128),
    "train": lambda rep, devs: cs.phase_train(rep, depth=5, width=32,
                                              n_check=128, mb_rays=256,
                                              mb_steps=3),
    "tape": lambda rep, devs: cs.phase_tape(rep, depth=5, width=32,
                                            n_frames=2),
    "animation": lambda rep, devs: cs.phase_animation(
        rep, n_points=2000, depth=4, width=32, n_frames=2),
    "multi": lambda rep, devs: cs.phase_multi(rep, devs[:4], depth_dp=5,
                                              depth_pool=6, width=32),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_tiny(phase):
    rep = cs.Report("cpu")
    TINY[phase](rep, jax.devices())
    assert rep.failures == []


def test_check_records_excess():
    rep = cs.Report("cpu")
    rep.check("T", "within", 1e-6, "tape_vs_march")
    rep.check("T", "nan", float("nan"), "tape_vs_march")
    rep.check("T", "relative", 2e-4, "grad_oracle", scale=1.0)
    assert len(rep.failures) == 2


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return jax.devices()


@pytest.mark.chip
def test_phases_on_gpu(gpu):
    rep = cs.Report(gpu[0].device_kind)
    cs.phase_static(rep, depth=7, width=256)
    cs.phase_tape(rep, depth=7, width=256)
    cs.phase_trace(rep, depth=7, width=256)
    assert rep.failures == []
