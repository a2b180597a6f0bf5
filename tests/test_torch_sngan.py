"""The ``sngan`` preset's pair in lockstep with the JAX package (CPU, f32).

The narrow FFC generator against ``FFCDiscriminator`` (Adam, separate real
and fake D passes, as the JAX CLI runs a discriminator with BatchNorm) for
two steps, with the bars and the setup of
``tests/test_torch_train_options.py``.
"""

from __future__ import annotations

from test_torch_train_options import check_lockstep


def test_sngan_pair_in_lockstep_with_jax(monkeypatch):
    check_lockstep(dict(optimizer="adam", fused_dis_batch=False), monkeypatch, d_kind="ffc")
