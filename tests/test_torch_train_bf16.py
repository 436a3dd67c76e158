"""The port's train step against the reference's ``step_fn`` under bf16
configs (the five text archs at reduced width with ``dtype="bfloat16"`` and
``remat=True``, as the full-size configs have them), with no compression,
``int8`` and ``topk``: the run of ``test_torch_train.py``'s
``hold_train_steps``.

The types are the point: the reference's bf16 parameters come out of the
first step float32 (its bias corrections are float32 arrays), its moments
one step later, or at once where a float32 leaf (``a_log``, ``lam``) makes
the clipping scale float32 or ``int8`` hands float32 gradients over; the
port must give every parameter, moment and residual the reference's type
after every step.

The values are held at bf16's precision.  The first step's forward and
backward run in bf16, and rounding there decides which tiny gradients flip
sign, each flip an Adam step of about lr.  The reference's own jitted and
eager runs of the same step differ that way: losses up to 5.2e-3 apart
(relative) and updates 0.29 apart (llama3-8b and smollm-135m, 5 steps).
Limits: loss within 2e-2 relative (measured at most 1.0e-2), the update
within 0.6 of its norm (measured at most 0.42, topk), twice the
reference's own spread or more; parameters within 2 x the sum of the
steps' lr.  An update computed wrongly is off by order 1.
"""
import pytest

from test_torch_train import ARCHS, MODES, hold_train_steps

TOL = (2e-2, 0.6)


@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_bf16_train_step_types_follow_the_reference(monkeypatch, name, mode):
    hold_train_steps(monkeypatch, name, mode, "bfloat16", TOL)
