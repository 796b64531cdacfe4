"""Coverage for transforms/utilities not exercised elsewhere."""

import numpy as np
import jax
import jax.numpy as jnp

from gibbssampler.harmonics import nstate, ell_mask_state
from gibbssampler.inference import example_dl, simulate_dataset
from gibbssampler.samplers import whiten, recenter


def test_whiten_recenter_roundtrip():
    lmax = 10
    dl = (jnp.asarray(example_dl(lmax, amp=5.0))[2:],)
    bins = [np.arange(2, lmax + 2)]
    key = jax.random.PRNGKey(0)
    s = jax.random.normal(key, (1, nstate(lmax)))
    s_nc = whiten(s, dl, bins, lmax)
    back = recenter(s_nc, dl, bins, lmax)
    # slots with positive variance roundtrip; l<2 / invalid slots are zeroed
    act = ell_mask_state(lmax, lmin=2) > 0
    np.testing.assert_allclose(np.asarray(back[0, act]),
                               np.asarray(s[0, act]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(back[0, ~act]), 0.0)


def test_simulate_spin3():
    lmax = 8
    fields = np.stack([example_dl(lmax, "tt"), example_dl(lmax, "ee"),
                       example_dl(lmax, "bb")])
    model, truth = simulate_dataset(jax.random.PRNGKey(1), lmax, spin=3,
                                    dl_fields=fields, noise_sigma2=1.0,
                                    dtype=jnp.float64)
    assert model.d.shape[0] == 3
    assert model.nfields == 3
    # adjoint consistency on the TQU operator
    s = truth["alm_true"]
    f = model.synthesis(s)
    st = model.adjoint_synthesis(f)
    lhs = float(jnp.vdot(f, f))
    rhs = float(jnp.vdot(s, st))
    assert abs(lhs - rhs) < 1e-9 * abs(lhs)


def test_esjd_and_summary():
    from gibbssampler.diagnostics import esjd, summarize_chains
    rng = np.random.default_rng(0)
    chains = rng.normal(size=(4, 300, 3))
    s = summarize_chains(chains)
    assert s["ess"].shape == (3,)
    assert np.all(s["rhat"] < 1.1)
    assert esjd(chains[:, :, 0]) > 0
