"""The port's ``make_train_step`` against the reference's ``step_fn`` in
float32: five text archs at reduced width x no compression, ``int8`` and
``topk``, 5 steps each, held by ``test_torch_train.py``'s
``hold_train_steps`` at its float32 tolerances (stated and measured in
that file's docstring).  A file of its own so that its cases run beside
the rest of the training tests.
"""
import pytest

from test_torch_train import ARCHS, MODES, TOL, hold_train_steps


@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_the_reference(monkeypatch, name, mode):
    hold_train_steps(monkeypatch, name, mode, "float32", TOL[mode])
