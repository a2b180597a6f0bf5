"""The port's ``GANTrainer`` update order and optimizer options in lockstep
with the JAX package's (CPU, f32).

``update_order="d_first"``, and Adam with b1 0, b2 0.9 and a D learning
rate of its own, each for two steps of the narrow tuple pair, with the
bars and the setup of ``tests/test_torch_train_options.py``.
"""

from __future__ import annotations

import pytest

from test_torch_train_options import check_lockstep


@pytest.mark.parametrize("options", [
    dict(update_order="d_first"),
    dict(optimizer="adam", b1=0.0, b2=0.9, d_lr=4e-4),
], ids=["d-first", "adam-d-lr"])
def test_option_in_lockstep_with_jax(options, monkeypatch):
    check_lockstep(options, monkeypatch)
