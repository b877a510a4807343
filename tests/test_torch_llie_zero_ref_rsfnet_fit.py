"""Port parity on the CPU: RSFNet's init and fit against the JAX package
at its published width on 32x32.

At the registry's init (thresholds 0, steps 1) every input reaches a
channel norm of a zero vector (``thres_a`` of x - e where e = x), whose
gradient is NaN in the JAX package (``jnp.linalg.norm``) and 0 in the port
(torch's ``vector_norm``): the JAX package's own fit is NaN from its first
step, the port's answers (held here). The gradients at init and a 3-step
fit (``check_fit``: ``make_instance_infer`` and ``Predictor``, 1e-4) are
held to the JAX package with its norm's gradient at zero taken as 0
(``zero_grad_norm_at_zero``), the one deliberate difference
(``ROADMAP.md`` section 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer.engine import make_instance_infer as jax_instance_infer
from enhax.models.llie import rsfnet as jrsf
from enhax_torch.infer.engine import make_instance_infer
from torch_family_parity import check_forward_loss_grads
from torch_instance_parity import check_fit, one_torch_thread, pair, to_torch  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401


def _dp(n=1, hw=32, seed=21):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0.02, 0.5, (n, hw, hw, 3)).astype(np.float32)}


class _NormZeroGradAtZero:
    """``jax.numpy`` whose ``linalg.norm`` (the 2-norm) has gradient 0 at a
    zero vector, as torch's ``vector_norm`` does."""

    class linalg:
        @staticmethod
        def norm(x, axis=None, keepdims=False):
            sq = jnp.sum(x * x, axis=axis, keepdims=keepdims)
            pos = sq > 0
            return jnp.where(pos, jnp.sqrt(jnp.where(pos, sq, 1.0)), 0.0)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def zero_grad_norm_at_zero(monkeypatch):
    monkeypatch.setattr(jrsf, "jnp", _NormZeroGradAtZero())


@pytest.fixture(scope="module")
def rsf_pair():
    """RSFNet in both packages at the JAX package's init."""
    return pair("rsfnet", _dp())


def test_jax_fit_is_nan_at_its_init_and_the_ports_is_not(rsf_pair):
    """The deliberate difference: at the registry's init the JAX package's
    first gradients hold NaN (the norm of a zero vector), so its fit's
    output is NaN; the port's gradients are finite (0 where the loss does
    not reach a parameter) and its fit answers."""
    jm, v, tm = rsf_pair
    dp = _dp()
    ref = jax_instance_infer(jm, 3, jm.instance_lr, jm.instance_weight_decay)(
        v, dp, jax.random.PRNGKey(0))
    assert np.isnan(np.asarray(ref["enhanced"])).all()
    loss, _ = tm.forward_loss(to_torch(dp))
    loss.backward()
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in tm.module.parameters())
    tm.module.zero_grad(set_to_none=True)
    out = make_instance_infer(tm, 3, tm.instance_lr)(to_torch(dp))
    assert torch.isfinite(out["enhanced"]).all()


def test_gradients_at_init_match_jax_with_zero_norm_gradient(rsf_pair, zero_grad_norm_at_zero):
    jm, v, tm = rsf_pair
    check_forward_loss_grads(jm, v, tm, _dp())


@pytest.mark.parametrize("predictor", [False, True])
def test_fit_matches_jax_with_zero_norm_gradient(rsf_pair, zero_grad_norm_at_zero, predictor):
    jm, v, tm = rsf_pair
    check_fit(jm, v, tm, _dp(), predictor=predictor)
