"""chip_smoke.py's own checks, run on the CPU at small sizes.

On the CPU the script must refuse to run (no GPU, no result line); its
phases, called directly at small n, must pass on correct results and its
checks must reject a perturbed factor. The full-size run is on the GPU.
"""

import json

import jax
import jax.numpy as jnp
import pytest

import chip_smoke as cs
import cholesky_tpu as ct


@pytest.fixture(autouse=True)
def _fresh_failures(monkeypatch):
    monkeypatch.setattr(cs, "FAILURES", [])


def test_device_phase_fails_on_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_residual_check_rejects_perturbed_factor():
    A = cs.spd(96, jnp.float64)
    F, info = ct.potrf("L", A)
    assert int(info) == 0
    r = cs.backward_residual(A, F)
    cs.check("resid", r, cs.RESID_TOL["float64"])
    assert cs.FAILURES == []
    cs.check("resid", cs.backward_residual(A, F.at[40, 7].add(1e-6)),
             cs.RESID_TOL["float64"])
    assert len(cs.FAILURES) == 1 and cs.FAILURES[0].startswith("resid")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_oracle_check_rejects_perturbed_factor(dtype):
    from cholesky_tpu.ops import lapack_ref
    A = cs.spd(128, dtype)
    F = jnp.tril(ct.potrf("L", A)[0])
    Lo = jnp.tril(lapack_ref.potrf("L", A)[0])
    cs.check("vs_oracle", *cs._tol_pair(F, Lo, dtype, 128))
    assert cs.FAILURES == []
    cs.check("vs_oracle", *cs._tol_pair(F.at[100, 3].mul(1.01), Lo,
                                        dtype, 128))
    assert len(cs.FAILURES) == 1


def test_check_rejects_nan():
    cs.check("x", float("nan"), 1.0)
    assert len(cs.FAILURES) == 1


def test_last_line_is_exactly_the_contract(monkeypatch, capsys):
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(cs, "phase_device", lambda: Dev())
    for name in ("phase_factor", "phase_solve", "phase_complex",
                 "phase_gp"):
        monkeypatch.setattr(cs, name, lambda: None)
    assert cs.main([]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"ok", "device"} and last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == len(jax.devices())


def test_failed_check_exits_nonzero_without_result(monkeypatch, capsys):
    class Dev:
        platform, device_kind = "gpu", "x"

    monkeypatch.setattr(cs, "phase_device", lambda: Dev())
    for name in ("phase_solve", "phase_complex", "phase_gp"):
        monkeypatch.setattr(cs, name, lambda: None)
    monkeypatch.setattr(cs, "phase_factor",
                        lambda: cs.check("resid", 1.0, 1e-5))
    assert cs.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_factor", {"n": 200, "n_oracle": 96}),
    ("phase_solve", {"n": 200, "nrhs": 8}),
    ("phase_complex", {"n": 96}),
    ("phase_gp", {"n": 192, "d": 4}),
])
def test_phase_passes_at_small_size(phase, kwargs, capsys):
    getattr(cs, phase)(**kwargs)
    assert cs.FAILURES == [], cs.FAILURES
    assert capsys.readouterr().out.strip()


def test_four_cards_phase_on_cpu_mesh(capsys):
    cs.phase_four_cards(n=256, n_gp=128, nb_gp=32)
    assert cs.FAILURES == [], cs.FAILURES
    out = capsys.readouterr().out
    assert "potrf_sharded" in out and "gp_dist" in out
