"""The port's ``GANTrainer`` losses in lockstep with the JAX package's (CPU, f32).

wgan, wgan-gp (the penalty's interpolation weights patched to the same
values on both sides) and the aw-method (hinge, separate real and fake D
passes), each for two steps of the narrow tuple pair, with the bars and the
setup of ``tests/test_torch_train_options.py``.
"""

from __future__ import annotations

import pytest

from test_torch_train_options import check_lockstep


@pytest.mark.parametrize("options", [
    dict(loss="wgan"),
    dict(loss="wgan-gp"),
    dict(loss="hinge", aw_method=True),
], ids=["wgan", "wgan-gp", "aw-method"])
def test_loss_in_lockstep_with_jax(options, monkeypatch):
    check_lockstep(options, monkeypatch)
